"""TaskManager + cancellable tasks.

Reference analogs: TaskManager.register (monotonic ids, per-node),
CancellableTask (cooperative cancellation checked inside long loops),
TaskCancelledException, ListTasks/CancelTasks response shapes.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional


class TaskCancelledException(Exception):
    def __init__(self, reason: str = "task cancelled"):
        super().__init__(reason)
        self.reason = reason
        self.err_type = "task_cancelled_exception"


class Task:
    def __init__(
        self,
        task_id: str,
        node: str,
        action: str,
        description: str = "",
        cancellable: bool = True,
        parent_task_id: Optional[str] = None,
    ):
        self.id = task_id
        self.node = node
        self.action = action
        self.description = description
        self.cancellable = cancellable
        self.parent_task_id = parent_task_id
        self.start_time_in_millis = int(time.time() * 1000)
        self._start_ns = time.perf_counter_ns()
        self._cancelled = threading.Event()
        self.cancel_reason: Optional[str] = None
        # long-running actions publish progress here (BulkByScrollTask
        # .Status analog); completed background tasks store their result
        self.status: Dict[str, Any] = {}
        self.completed = False
        self.response: Optional[dict] = None
        self.error: Optional[dict] = None

    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self, reason: str = "by user request") -> None:
        if self.cancellable:
            self.cancel_reason = reason
            self._cancelled.set()

    def check_cancelled(self) -> None:
        """Cooperative cancellation point (CancellableTask
        .ensureNotCancelled)."""
        if self.is_cancelled():
            raise TaskCancelledException(
                f"task cancelled [{self.cancel_reason}]"
            )

    def info(self) -> dict:
        out = {
            "node": self.node,
            "id": self.id,
            "action": self.action,
            "description": self.description,
            "start_time_in_millis": self.start_time_in_millis,
            "running_time_in_nanos": time.perf_counter_ns() - self._start_ns,
            "cancellable": self.cancellable,
            "cancelled": self.is_cancelled(),
        }
        if self.status:
            out["status"] = dict(self.status)
        if self.parent_task_id:
            out["parent_task_id"] = self.parent_task_id
        return out


class TaskManager:
    def __init__(self, node_name: str = "node-0"):
        self.node_name = node_name
        self._seq = itertools.count(1)
        self._tasks: Dict[str, Task] = {}
        # finished background (wait_for_completion=false) tasks kept for
        # GET _tasks/<id> result pickup (the .tasks-index analog)
        self._completed: Dict[str, Task] = {}
        # explicitly removed ids: a late unregister(keep=True) from the
        # worker thread must NOT resurrect a deleted task
        self._deleted: set = set()
        self._lock = threading.Lock()

    def register(
        self,
        action: str,
        description: str = "",
        cancellable: bool = True,
        parent_task_id: Optional[str] = None,
    ) -> Task:
        tid = f"{self.node_name}:{next(self._seq)}"
        task = Task(
            tid, self.node_name, action, description, cancellable,
            parent_task_id,
        )
        with self._lock:
            self._tasks[tid] = task
        return task

    def unregister(self, task: Task, keep: bool = False) -> None:
        with self._lock:
            self._tasks.pop(task.id, None)
            if keep and task.id not in self._deleted:
                task.completed = True
                self._completed[task.id] = task
                # bound the completed-task retention
                while len(self._completed) > 256:
                    self._completed.pop(next(iter(self._completed)))

    def remove(self, task_id: str) -> Optional[Task]:
        """Cancels + forgets a task (DELETE semantics): it will never be
        listed or resurrected by a late worker unregister."""
        with self._lock:
            task = self._tasks.pop(task_id, None) or self._completed.pop(
                task_id, None
            )
            self._deleted.add(task_id)
            while len(self._deleted) > 4096:
                self._deleted.pop()
        if task is not None and task.cancellable:
            task.cancel("deleted")
        return task

    def get(self, task_id: str) -> Optional[Task]:
        with self._lock:
            return self._tasks.get(task_id) or self._completed.get(task_id)

    def list(self, actions: Optional[str] = None) -> List[Task]:
        with self._lock:
            tasks = list(self._tasks.values())
        if actions:
            import fnmatch

            pats = [p.strip() for p in actions.split(",")]
            tasks = [
                t for t in tasks
                if any(fnmatch.fnmatch(t.action, p) for p in pats)
            ]
        return tasks

    def cancel(self, task_id: str, reason: str = "by user request") -> List[Task]:
        """Cancels a task and its registered descendants
        (cancelTaskAndDescendants)."""
        out = []
        with self._lock:
            task = self._tasks.get(task_id)
            if task is not None:
                children = [
                    t for t in self._tasks.values()
                    if t.parent_task_id == task_id
                ]
            else:
                children = []
        if task is not None:
            task.cancel(reason)
            out.append(task)
            for c in children:
                c.cancel(reason)
                out.append(c)
        return out
