"""Multi-process deployment glue.

Port of cartographer_tpu/parallel/multihost.py onto torch.distributed.
The reference's distribution story is one gRPC server holding the pose
graph with robot clients. The JAX package runs one SPMD program per host
joined by jax.distributed; here every rank (one process per device) runs
the same program, a torch.distributed process group joins them, and the
two scalable workloads — batched loop-closure scoring and the SPA solve —
are split over the ranks (parallel/sharded.py). Host-side sensor
ingestion stays on each rank's CPU.

Process groups are made explicitly: the coordinator's address
(tcp://host:port), the number of processes and this process's rank come
from the caller; nothing reads a cluster's environment. Run
`tools/multihost_worker.py` on every rank, or `run_ranks` to spawn the
ranks of one host.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch

from cartographer_tpu_torch.parallel import partition

# Seconds a collective (and the rendezvous) may wait for the other ranks:
# a rank that takes another branch fails with a timeout error, not a hang.
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass
class MultihostContext:
    process_id: int
    num_processes: int
    mesh: partition.Mesh
    backend: Optional[str] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_nccl_devices(store, rank: int, world: int, device: torch.device) -> None:
    """NCCL needs one device per rank: every rank publishes its host and
    card in the store, and every rank raises if two share one."""
    store.set(f"device/{rank}", f"{socket.gethostname()}/{device.index}")
    names = [f"device/{r}" for r in range(world)]
    store.wait(names)
    seen = [store.get(n).decode() for n in names]
    # Rank 0 hosts the store: it leaves only after every rank has read.
    store.set(f"read/{rank}", "1")
    if rank == 0:
        store.wait([f"read/{r}" for r in range(world)])
    shared = sorted({s for s in seen if seen.count(s) > 1})
    if shared:
        raise RuntimeError(
            f"NCCL needs one device per rank, but ranks share {shared}; "
            'pass backend="gloo" to run several ranks on one device'
        )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> MultihostContext:
    """Join this process into a multi-rank run and build its mesh.

    `device=None` means cuda:{process_id % device count} and raises
    without CUDA; `backend=None` means "nccl" on cuda and "gloo" on the
    CPU. A process group is made when a coordinator address or a backend
    is given (a one-rank group too) and always for more than one process;
    otherwise the mesh is one rank without a group. Several ranks asking
    for NCCL on one device raise (gloo runs them, on CUDA tensors too).
    Collectives wait at most `timeout` seconds, the rendezvous at least
    DEFAULT_TIMEOUT_S."""
    import torch.distributed as dist

    world = num_processes or 1
    rank = process_id or 0
    dev = partition.rank_device(rank, device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if backend is None and (coordinator_address is not None or world > 1):
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend is None:
        return MultihostContext(0, 1, partition.Mesh(None, 0, 1, dev))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs on cuda devices, not {dev}")
    if coordinator_address is None:
        if world > 1:
            raise ValueError("more than one process needs a coordinator_address")
        coordinator_address = f"127.0.0.1:{free_port()}"
    host, port = coordinator_address.rsplit(":", 1)
    # The rendezvous waits for the slowest rank to start; the collectives
    # for the slowest rank to arrive.
    rendezvous = datetime.timedelta(seconds=max(timeout, DEFAULT_TIMEOUT_S))
    store = dist.TCPStore(host, int(port), world, rank == 0, timeout=rendezvous)
    if backend == "nccl":
        _check_nccl_devices(store, rank, world, dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
    )
    mesh = partition.Mesh(dist.group.WORLD, rank, world, dev)
    return MultihostContext(rank, world, mesh, backend)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def make_global_batch(ctx: MultihostContext, per_host_rows) -> torch.Tensor:
    """The global batch on every rank: each rank's rows, in rank order
    (each rank may contribute a different number of rows)."""
    mesh = ctx.mesh
    local = torch.as_tensor(np.asarray(per_host_rows)).to(mesh.device)
    counts = torch.zeros(mesh.world_size, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = local.shape[0]
    partition.all_reduce(counts, mesh)
    counts = counts.tolist()
    lo = sum(counts[: mesh.rank])
    out = torch.zeros((sum(counts),) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=mesh.device)
    out[lo:lo + local.shape[0]] = local
    return partition.all_reduce(out, mesh)


def make_global_sharded(ctx: MultihostContext, value) -> torch.Tensor:
    """This rank's rows of a global value every rank holds identically."""
    return partition.put(np.asarray(value), partition.batch_sharding(ctx.mesh))


def scaling_report(ctx: MultihostContext, work_items: int, seconds: float) -> dict:
    """Per-run scaling record (items/s per device)."""
    n_dev = ctx.mesh.world_size
    return {
        "process_id": ctx.process_id,
        "num_processes": ctx.num_processes,
        "num_devices": n_dev,
        "backend": ctx.backend,
        "device": str(ctx.mesh.device),
        "items_per_sec": work_items / max(seconds, 1e-9),
        "items_per_sec_per_device": work_items / max(seconds, 1e-9) / n_dev,
    }


def _rank_main(fn, args, rank, world, address, backend, device, timeout, threads, results):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        ctx = initialize(address, world, rank, backend, device, timeout)
        try:
            results.put((rank, True, fn(ctx, *args)))
        finally:
            shutdown()
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n_ranks: int, args=(), backend=None, device=None,
              timeout: float = 600.0, collective_timeout: float = DEFAULT_TIMEOUT_S,
              num_threads: Optional[int] = None):
    """Spawn `n_ranks` processes on this host, joined into one process
    group over localhost, and run `fn(ctx, *args)` on each
    (`fn` picklable by name; its result picklable). Returns the results in
    rank order. Raises if a rank raises or dies, or after `timeout`
    seconds (the other ranks are then stopped: they may wait in a
    collective); every process is stopped before this returns."""
    spawn = multiprocessing.get_context("spawn")
    results = spawn.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [
        spawn.Process(
            target=_rank_main,
            args=(fn, args, r, n_ranks, address, backend, device,
                  collective_timeout, num_threads, results),
            daemon=True,
        )
        for r in range(n_ranks)
    ]
    for p in procs:
        p.start()
    out, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n_ranks and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and r not in errors and not p.is_alive()]
                if dead:
                    # Give a rank that just exited a moment to deliver.
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"ranks {dead} exited without a result "
                            f"(exit codes {[procs[r].exitcode for r in dead]})"
                        ) from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish in {timeout} s")
                else:
                    continue
            (out if ok else errors)[rank] = value
    finally:
        for p in procs:
            # Ranks left after a failure may wait in a collective.
            p.join(timeout=10.0 if len(out) == n_ranks else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError(
            "".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(errors.items()))
        )
    return [out[r] for r in range(n_ranks)]
