"""Task store with observer hooks
(``protocol_tpu/store/domains/task_store.py``, copied).

Reference: crates/orchestrator/src/store/domains/task_store.rs — task blob
per id + id list + name-uniqueness set + observer hooks that the node-groups
plugin uses to enable/disable topologies on task create/delete (:11-55).
"""

from __future__ import annotations

from typing import Callable, Optional

from protocol_tpu_torch.models.task import Task
from protocol_tpu_torch.store.kv import KVStore

TASK_KEY = "orchestrator:task:{}"
TASK_LIST = "orchestrator:tasks"
TASK_NAMES = "orchestrator:task_names"

TaskObserver = Callable[[Task], None]


class TaskStore:
    def __init__(self, kv: KVStore):
        self.kv = kv
        self._on_created: list[TaskObserver] = []
        self._on_deleted: list[TaskObserver] = []

    # ----- observers (reference task_store.rs observer hooks)

    def subscribe_created(self, fn: TaskObserver) -> None:
        self._on_created.append(fn)

    def subscribe_deleted(self, fn: TaskObserver) -> None:
        self._on_deleted.append(fn)

    # ----- CRUD

    def add_task(self, task: Task) -> None:
        """Stores the task; name uniqueness is enforced at the API layer
        (orchestrator/src/api/routes/task.rs:46-58) via ``name_exists``."""
        with self.kv.atomic():
            self.kv.set(TASK_KEY.format(task.id), task.to_json())
            self.kv.rpush(TASK_LIST, task.id)
            self.kv.sadd(TASK_NAMES, task.name)
        for fn in self._on_created:
            fn(task)

    def name_exists(self, name: str) -> bool:
        return self.kv.sismember(TASK_NAMES, name)

    def get_task(self, task_id: str) -> Optional[Task]:
        raw = self.kv.get(TASK_KEY.format(task_id))
        return Task.from_json(raw) if raw else None

    def get_all_tasks(self) -> list[Task]:
        ids = self.kv.lrange(TASK_LIST)
        raws = self.kv.mget(TASK_KEY.format(i) for i in ids)
        return [Task.from_json(r) for r in raws if r]

    def update_task(self, task: Task) -> None:
        self.kv.set(TASK_KEY.format(task.id), task.to_json())

    def delete_task(self, task_id: str) -> Optional[Task]:
        with self.kv.atomic():
            task = self.get_task(task_id)
            if task is None:
                return None
            self.kv.delete(TASK_KEY.format(task_id))
            self.kv.lrem(TASK_LIST, 0, task_id)
            self.kv.srem(TASK_NAMES, task.name)
        for fn in self._on_deleted:
            fn(task)
        return task

    def delete_all(self) -> None:
        for t in self.get_all_tasks():
            self.delete_task(t.id)
