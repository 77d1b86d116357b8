"""Dependency-aware task scheduling on a thread pool.

Reference: cartographer/common/task.h:31-71 and common/thread_pool.h:57-81.
A Task is a DAG node with states NEW -> DISPATCHED -> DEPENDENCIES_COMPLETED
-> RUNNING -> COMPLETED; the pool runs a task only after all of its
dependencies completed. The TPU engine uses this for host-side orchestration
of the asynchronous global-SLAM work queue; heavy math runs on device inside
the work items.

A deterministic single-threaded mode (num_threads=0) executes tasks inline
in dependency order, which keeps tests reproducible (SURVEY.md section 4).
"""

from __future__ import annotations

import collections
import enum
import threading
from typing import Callable, Optional


class TaskState(enum.Enum):
    NEW = 0
    DISPATCHED = 1
    DEPENDENCIES_COMPLETED = 2
    RUNNING = 3
    COMPLETED = 4


class Task:
    def __init__(self, work_item: Optional[Callable[[], None]] = None):
        self._work_item = work_item
        self._state = TaskState.NEW
        self._uncompleted_dependencies = 0
        self._dependent_tasks: list[Task] = []
        self._lock = threading.Lock()
        self._pool: Optional["ThreadPool"] = None
        self._completed = threading.Event()

    @property
    def state(self) -> TaskState:
        return self._state

    def set_work_item(self, work_item: Callable[[], None]) -> None:
        with self._lock:
            assert self._state == TaskState.NEW
            self._work_item = work_item

    def add_dependency(self, dependency: Optional["Task"]) -> None:
        """Register that this task must run after `dependency` completes."""
        if dependency is None:
            return
        notify = False
        with dependency._lock:
            if dependency._state != TaskState.COMPLETED:
                with self._lock:
                    assert self._state in (TaskState.NEW, TaskState.DISPATCHED)
                    self._uncompleted_dependencies += 1
                dependency._dependent_tasks.append(self)
            else:
                notify = True
        if notify:
            pass  # Dependency already done; nothing to wait for.

    # -- internal, called by ThreadPool ------------------------------------
    def _dispatch(self, pool: "ThreadPool") -> None:
        with self._lock:
            assert self._state == TaskState.NEW
            self._state = TaskState.DISPATCHED
            self._pool = pool
            if self._uncompleted_dependencies == 0:
                self._state = TaskState.DEPENDENCIES_COMPLETED
                pool._notify_ready(self)

    def _on_dependency_completed(self) -> None:
        ready = False
        with self._lock:
            self._uncompleted_dependencies -= 1
            if (
                self._uncompleted_dependencies == 0
                and self._state == TaskState.DISPATCHED
            ):
                self._state = TaskState.DEPENDENCIES_COMPLETED
                ready = True
        if ready:
            assert self._pool is not None
            self._pool._notify_ready(self)

    def _execute(self) -> None:
        with self._lock:
            assert self._state == TaskState.DEPENDENCIES_COMPLETED
            self._state = TaskState.RUNNING
        try:
            if self._work_item is not None:
                self._work_item()
        finally:
            # The task COMPLETES even when the work item raises: a task
            # stuck in RUNNING forever would wedge every Task.wait (the
            # pose graph's WaitForAllComputations burns its full timeout
            # per call — measured as a multi-minute suite hang, round 5).
            # The exception still propagates to the executor: inline
            # (sync) callers see it directly; pool workers log it and
            # keep the thread alive (_work_loop).
            dependents = []
            with self._lock:
                self._state = TaskState.COMPLETED
                dependents = list(self._dependent_tasks)
                self._dependent_tasks.clear()
            self._completed.set()
            for task in dependents:
                task._on_dependency_completed()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until this task completes; True if it did within the
        timeout. (Blocking wait instead of state polling — the reference
        waits on a condition, pose_graph_2d.cc WaitForAllComputations.)"""
        return self._completed.wait(timeout)


class ThreadPool:
    """Fixed-size pool executing Tasks in dependency order.

    num_threads=0 gives a deterministic inline executor: Schedule() runs
    ready tasks immediately on the calling thread (in FIFO order), which is
    the analog of the reference's ThreadPoolForTesting.
    """

    def __init__(self, num_threads: int):
        self._num_threads = num_threads
        self._lock = threading.Lock()
        self._ready: collections.deque[Task] = collections.deque()
        self._cv = threading.Condition(self._lock)
        self._running = True
        self._threads: list[threading.Thread] = []
        self._inline_draining = False
        if num_threads > 0:
            for i in range(num_threads):
                t = threading.Thread(target=self._work_loop, daemon=True, name=f"ctpu-pool-{i}")
                t.start()
                self._threads.append(t)

    def schedule(self, task: Task) -> Task:
        task._dispatch(self)
        if self._num_threads == 0:
            self._drain_inline()
        return task

    def _notify_ready(self, task: Task) -> None:
        with self._cv:
            self._ready.append(task)
            self._cv.notify()

    def _drain_inline(self) -> None:
        # Reentrancy guard: a work item may schedule more tasks.
        if self._inline_draining:
            return
        self._inline_draining = True
        try:
            while True:
                with self._cv:
                    if not self._ready:
                        return
                    task = self._ready.popleft()
                task._execute()
        finally:
            self._inline_draining = False

    def _work_loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._ready:
                    self._cv.wait()
                if not self._running and not self._ready:
                    return
                task = self._ready.popleft()
            try:
                task._execute()
            except Exception:  # noqa: BLE001 - worker must survive
                import logging

                logging.getLogger(__name__).exception(
                    "Task work item raised on a pool worker; the task is "
                    "marked completed and the worker continues."
                )

    def shutdown(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
