"""The scheduler: the per-heartbeat task-for-node resolution
(``protocol_tpu/sched/scheduler.py``, copied).

Reference: crates/orchestrator/src/scheduler/mod.rs: ``get_task_for_node``
(:26-74) fetches every task, runs the plugin filter chain, picks the first
task left and expands ``${TASK_ID}`` / ``${NODE_ADDRESS}`` into its env
vars, cmd and volume mounts. The default chain is the newest-task plugin
(:16-18).

With a batch matcher attached (:class:`~protocol_tpu_torch.sched.
torch_backend.TorchBatchMatcher`, or its remote twin :class:`~protocol_tpu_
torch.services.scheduler_grpc.RemoteBatchMatcher`), a node is served from
the last batch solve; a node the solve did not cover asks for a new one
and looks again, never the greedy chain (it would bypass replica bounds
and requirement gates). A groups plugin beside the matcher resolves
grouped nodes through its own machinery, as the reference does.

Stores and tasks are read duck-typed (``store.node_store.get_node``,
``store.task_store.get_all_tasks`` / ``get_task``; a task's ``id``,
``created_at``, ``env_vars``, ``cmd``, ``entrypoint``, ``volume_mounts``),
so the reference's store and models pass as the port's own
(:mod:`protocol_tpu_torch.store.node_store`,
:mod:`protocol_tpu_torch.models.task`).
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING, Optional, Protocol

from protocol_tpu_torch.models.task import Task
from protocol_tpu_torch.store.node_store import OrchestratorNode

if TYPE_CHECKING:
    from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher


class SchedulerPlugin(Protocol):
    """A filter-chain plugin (reference plugins/mod.rs:61-78)."""

    def filter_tasks(self, tasks: list[Task], node: OrchestratorNode) -> list[Task]: ...


class NewestTaskPlugin:
    """Newest first, everything passes (reference plugins/newest_task/mod.rs)."""

    def filter_tasks(self, tasks: list[Task], node: OrchestratorNode) -> list[Task]:
        return sorted(tasks, key=lambda t: t.created_at, reverse=True)


def expand_task_for_node(task: Task, node_address: str) -> Task:
    """A copy of ``task`` with ``${TASK_ID}`` / ``${NODE_ADDRESS}`` expanded
    in its env vars, cmd, entrypoint and volume mounts (scheduler/mod.rs:
    40-70, task.rs replace_labels)."""
    t = copy.deepcopy(task)

    def sub(s: str) -> str:
        return s.replace("${TASK_ID}", t.id).replace("${NODE_ADDRESS}", node_address)

    if t.env_vars:
        t.env_vars = {k: sub(v) for k, v in t.env_vars.items()}
    if t.cmd:
        t.cmd = [sub(c) for c in t.cmd]
    if t.entrypoint:
        t.entrypoint = [sub(c) for c in t.entrypoint]
    if t.volume_mounts:
        t.volume_mounts = [vm.replace_labels(t.id, node_address) for vm in t.volume_mounts]
    return t


class Scheduler:
    def __init__(self, store, plugins: Optional[list[SchedulerPlugin]] = None,
                 batch_matcher: Optional["TorchBatchMatcher"] = None):
        self.store = store
        self.plugins: list[SchedulerPlugin] = (
            plugins if plugins is not None else [NewestTaskPlugin()]
        )
        self.batch_matcher = batch_matcher

    def get_task_for_node(self, node_address: str) -> Optional[Task]:
        node = self.store.node_store.get_node(node_address)
        if node is None:
            return None

        if self.batch_matcher is not None:
            # a groups plugin beside the matcher resolves grouped nodes
            # itself; the others take the batch solve's answer
            gp = next((p for p in self.plugins
                       if hasattr(p, "group_for_node") and hasattr(p, "task_ranker")), None)
            if gp is not None:
                group = gp.group_for_node(node_address)
                if group is not None:
                    tasks = self.store.task_store.get_all_tasks()
                    filtered = gp.filter_tasks(tasks, node)
                    if not filtered:
                        return None
                    return expand_task_for_node(filtered[0], node_address)

            task, covered = self.batch_matcher.lookup(node)
            if not covered:
                # a node the last solve did not consider: ask for a new
                # solve (the matcher throttles) and look again
                self.batch_matcher.mark_dirty()
                task, covered = self.batch_matcher.lookup(node)
            if task is None:
                return None
            return expand_task_for_node(task, node_address)

        tasks = self.store.task_store.get_all_tasks()
        for plugin in self.plugins:
            tasks = plugin.filter_tasks(tasks, node)
            if not tasks:
                return None
        return expand_task_for_node(tasks[0], node_address)

    def get_tasks_for_node(self, node_address: str) -> list[Task]:
        """Every task of a node: several for a colocated node (phase 0.5),
        one otherwise; the first is ``get_task_for_node``'s answer."""
        first = self.get_task_for_node(node_address)
        if first is None:
            return []
        if self.batch_matcher is None:
            return [first]
        tids = self.batch_matcher.assigned_task_ids(node_address)
        if len(tids) <= 1:
            return [first]
        found = (self.store.task_store.get_task(t) for t in tids)
        return [expand_task_for_node(t, node_address) for t in found if t is not None]
