"""Dependency-aware task scheduling on a thread pool.

Reference: cartographer/common/task.h:31-71 and common/thread_pool.h:57-81.
A Task is a DAG node with states NEW -> DISPATCHED -> DEPENDENCIES_COMPLETED
-> RUNNING -> COMPLETED (or FAILED, when its work item raised); the pool
runs a task only after all of its dependencies completed. The TPU engine uses this for host-side orchestration
of the asynchronous global-SLAM work queue; heavy math runs on device inside
the work items.

A deterministic single-threaded mode (num_threads=0) executes tasks inline
in dependency order, which keeps tests reproducible (SURVEY.md section 4).

Unlike the JAX package's copy, a work item that raises leaves its task
FAILED with the exception kept: `Task.wait` re-raises it, so a failure on
a pool worker (a CUDA error or an out-of-memory inside an asynchronous
pose-graph drain) reaches the caller that waits for the task instead of
being logged and reported as done. Dependents still run, as before.
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
    FAILED = 5


class TaskFailed(RuntimeError):
    """Raised by Task.wait for a task whose work item raised; the work
    item's exception is the cause."""


class Task:
    def __init__(self, work_item: Optional[Callable[[], None]] = None):
        self._work_item = work_item
        self._state = TaskState.NEW
        self._uncompleted_dependencies = 0
        self._dependent_tasks: list[Task] = []
        self._lock = threading.Lock()
        self._pool: Optional["ThreadPool"] = None
        self._completed = threading.Event()
        self._error: Optional[BaseException] = None

    @property
    def state(self) -> TaskState:
        return self._state

    @property
    def done(self) -> bool:
        """True once the work item has run, whether or not it raised."""
        return self._state in (TaskState.COMPLETED, TaskState.FAILED)

    @property
    def error(self) -> Optional[BaseException]:
        """The exception the work item raised, if it did."""
        return self._error

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
            if not dependency.done:
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
        error = None
        try:
            if self._work_item is not None:
                self._work_item()
        except BaseException as e:
            error = e
            raise
        finally:
            # The task ends even when the work item raises (a task stuck
            # in RUNNING would wedge every Task.wait), as FAILED with the
            # exception kept for wait() to re-raise. The exception also
            # propagates to the executor: inline (sync) callers see it
            # directly; pool workers log it and keep the thread alive
            # (_work_loop).
            dependents = []
            with self._lock:
                self._error = error
                self._state = (
                    TaskState.COMPLETED if error is None else TaskState.FAILED
                )
                dependents = list(self._dependent_tasks)
                self._dependent_tasks.clear()
            self._completed.set()
            for task in dependents:
                task._on_dependency_completed()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until this task ends; True if it did within the timeout.
        Raises TaskFailed (with the work item's exception as the cause)
        if the work item raised. (Blocking wait instead of state polling —
        the reference waits on a condition, pose_graph_2d.cc
        WaitForAllComputations.)"""
        ended = self._completed.wait(timeout)
        if ended and self._error is not None:
            raise TaskFailed("task work item raised") from self._error
        return ended


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
                    "marked FAILED (Task.wait re-raises) and the worker "
                    "continues."
                )

    def shutdown(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
