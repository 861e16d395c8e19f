"""Tasks framework: registration, listing, cancellation.

Reference analogs: org.elasticsearch.tasks.TaskManager.register /
cancelTaskAndDescendants, CancellableTask.isCancelled,
TransportListTasksAction (SURVEY.md §2.1 Tasks framework row, §5
tracing: "every transport action runs as a cancellable Task").
"""

from .manager import Task, TaskCancelledException, TaskManager

__all__ = ["Task", "TaskCancelledException", "TaskManager"]
