"""Robot -> cloud federation uploader.

Port of cartographer_tpu/cloud/local_trajectory_uploader.py.

Reference: cloud/internal/local_trajectory_uploader.cc:40-345 — a background
thread drains a BlockingQueue of sensor data, uploads in batches
(upload_batch_size) with retries; on channel loss it reconnects with a
deadline and, for graph consistency, DROPS queued data until the next fresh
submap boundary before resuming (TryRecovery, :145-200).

The "fresh submap" signal here is the start of a new accumulation window:
range data following a successful reconnect is dropped until the batch
boundary marker that the server-side trajectory would treat as a clean
restart (we drop until the next range-data item, matching the observable
behavior of the reference's recovery for the single-sensor case).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import grpc
import numpy as np

from cartographer_tpu_torch.cloud import wire
from cartographer_tpu_torch.common.blocking_queue import BlockingQueue

UNRECOVERABLE_CODES = {
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.NOT_FOUND,
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.UNKNOWN,
}


class LocalTrajectoryUploader:
    def __init__(self, uplink_address: str, batch_size: int = 10, retry_interval: float = 0.2):
        self._address = uplink_address
        self._batch_size = batch_size
        self._retry_interval = retry_interval
        self._queue = BlockingQueue()
        self._thread: Optional[threading.Thread] = None
        self._shutting_down = False
        self._channel: Optional[grpc.Channel] = None
        self._local_to_uplink_trajectory: Dict[int, int] = {}
        self._pending_trajectories: List[tuple] = []
        self._needs_recovery = False

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._shutting_down = True
        self._queue.push(None)
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def add_trajectory(self, local_trajectory_id: int, expected_sensor_ids, trajectory_options: dict) -> None:
        self._pending_trajectories.append(
            (local_trajectory_id, list(expected_sensor_ids), trajectory_options)
        )

    def enqueue_sensor_data(self, trajectory_id: int, sensor_id: str, data) -> None:
        self._queue.push((trajectory_id, sensor_id, data))

    def wait_until_drained(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.empty():
                time.sleep(0.2)
                if self._queue.empty():
                    return True
            time.sleep(0.05)
        return False

    # -- internals ----------------------------------------------------------

    def _call(self, method: str, request: bytes, timeout: float = 5.0) -> bytes:
        callable_ = self._channel.unary_unary(
            wire.method_path(method), request_serializer=None, response_deserializer=None
        )
        return callable_(request, timeout=timeout)

    def _connect(self) -> bool:
        try:
            self._channel = grpc.insecure_channel(self._address)
            grpc.channel_ready_future(self._channel).result(timeout=2.0)
            # All trajectories must be (re-)registered on the new channel.
            self._local_to_uplink_trajectory.clear()
            return True
        except (grpc.RpcError, grpc.FutureTimeoutError):
            return False

    def _ensure_registered(self) -> None:
        """Register any trajectories not yet known upstream (done lazily so
        trajectories created after connect — the normal case — upload too)."""
        for local_id, sensor_ids, options in self._pending_trajectories:
            if local_id in self._local_to_uplink_trajectory:
                continue
            response = self._call(
                "AddTrajectory",
                wire.encode(
                    "add_trajectory",
                    {
                        "client_id": "uploader",
                        "expected_sensor_ids": sensor_ids,
                        "trajectory_options": options,
                    },
                    {},
                ),
            )
            _, meta, _ = wire.decode(response)
            self._local_to_uplink_trajectory[local_id] = meta["trajectory_id"]

    def _try_recovery(self) -> None:
        """Drop queued data until a fresh boundary (reference TryRecovery)."""
        while True:
            item = self._queue.peek()
            if item is None:
                break
            _, sensor_id, _ = item
            if sensor_id.startswith("range"):
                break
            self._queue.pop()
        self._needs_recovery = False

    def _run(self) -> None:
        while not self._shutting_down:
            if self._channel is None:
                if not self._connect():
                    time.sleep(self._retry_interval)
                    continue
                if self._needs_recovery:
                    self._try_recovery()
            batch = []
            item = self._queue.pop()
            if item is None:
                continue
            batch.append(item)
            while len(batch) < self._batch_size:
                nxt = self._queue.pop_with_timeout(0.05)
                if nxt is None:
                    break
                batch.append(nxt)
            try:
                self._ensure_registered()
                self._upload_batch(batch)
            except grpc.RpcError as e:
                if e.code() in UNRECOVERABLE_CODES:
                    # Reconnect and drop until a fresh submap boundary.
                    self._channel = None
                    self._needs_recovery = True
                # Items of this batch are lost (per-item unrecoverable
                # semantics of the reference).

    def _upload_batch(self, batch) -> None:
        items_meta = []
        arrays = {}
        count = 0
        for trajectory_id, sensor_id, data in batch:
            uplink_id = self._local_to_uplink_trajectory.get(trajectory_id)
            if uplink_id is None:
                continue
            payload = wire.encode_sensor_data(sensor_id, data)
            arrays[f"item_{count}"] = np.frombuffer(payload, np.uint8)
            items_meta.append({"trajectory_id": uplink_id})
            count += 1
        if count == 0:
            return
        self._call(
            "AddSensorDataBatch",
            wire.encode(
                "batch", {"count": count, "items": items_meta}, arrays
            ),
            timeout=10.0,
        )
