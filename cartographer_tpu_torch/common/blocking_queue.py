"""Bounded MPMC blocking queue (reference: common/internal/blocking_queue.h).

Port of cartographer_tpu/common/blocking_queue.py.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional

QUEUE_INFINITE_SIZE = 0


class BlockingQueue:
    def __init__(self, queue_size: int = QUEUE_INFINITE_SIZE):
        self._queue_size = queue_size
        self._deque: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def push(self, item: Any) -> None:
        with self._not_full:
            while self._queue_size != QUEUE_INFINITE_SIZE and len(self._deque) >= self._queue_size:
                self._not_full.wait()
            self._deque.append(item)
            self._not_empty.notify()

    def push_with_timeout(self, item: Any, timeout: float) -> bool:
        with self._not_full:
            if self._queue_size != QUEUE_INFINITE_SIZE and len(self._deque) >= self._queue_size:
                if not self._not_full.wait_for(
                    lambda: self._queue_size == QUEUE_INFINITE_SIZE
                    or len(self._deque) < self._queue_size,
                    timeout,
                ):
                    return False
            self._deque.append(item)
            self._not_empty.notify()
            return True

    def pop(self) -> Any:
        with self._not_empty:
            while not self._deque:
                self._not_empty.wait()
            item = self._deque.popleft()
            self._not_full.notify()
            return item

    def pop_with_timeout(self, timeout: float) -> Optional[Any]:
        with self._not_empty:
            if not self._deque:
                if not self._not_empty.wait_for(lambda: bool(self._deque), timeout):
                    return None
            item = self._deque.popleft()
            self._not_full.notify()
            return item

    def peek(self) -> Optional[Any]:
        with self._lock:
            return self._deque[0] if self._deque else None

    def peek_with_timeout(self, timeout: float) -> Optional[Any]:
        with self._not_empty:
            if not self._deque:
                if not self._not_empty.wait_for(lambda: bool(self._deque), timeout):
                    return None
            return self._deque[0]

    def size(self) -> int:
        with self._lock:
            return len(self._deque)

    def empty(self) -> bool:
        return self.size() == 0
