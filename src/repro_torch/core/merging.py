"""Task similarity detection and merging (dissertation Sections 4.2-4.3).

Three mergeability levels, each with its own hash table (Section 4.3):

  * **Task level**        - identical (data, op, params): the compound task
                            serves every request at the cost of one.
  * **Data-and-operation** - same data + op, different params: shared
                            load/decode, per-param encode.
  * **Data-only**          - same data: shared fetch only.

Hash-table maintenance follows Fig. 4.3 exactly, including the subtle rule
(3): when a match is found but the system declines to merge, the table entry
is redirected to the *newer* task (it has more residual queue time, hence a
higher chance of future merges).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .tasks import Task

__all__ = ["MergeLevel", "SimilarityDetector", "merge_tasks",
           "common_prefix_len"]


class MergeLevel(enum.IntEnum):
    TASK = 3          # identical request — maximum reuse
    DATA_OP = 2       # same data + operation, different parameters
    DATA_ONLY = 1     # same data only
    PREFIX = 0        # partial prompt overlap — cross-time paged-KV reuse

    @property
    def label(self) -> str:
        return {3: "task", 2: "data_op", 1: "data_only", 0: "prefix"}[int(self)]


def common_prefix_len(a, b) -> int:
    """Token-level longest-common-prefix length — the PREFIX similarity
    score between two prompts (the hash tables can only see full-prompt
    identity; partial overlap needs an elementwise walk or a trie)."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


@dataclass
class SimilarityDetector:
    """O(1) mergeable-task lookup via three level-keyed hash tables."""

    _task_level: dict = field(default_factory=dict)
    _data_op: dict = field(default_factory=dict)
    _data_only: dict = field(default_factory=dict)
    # reverse index: tid -> [(table, key), ...] so completion cleanup is O(1)
    _owned_keys: dict = field(default_factory=dict)
    # PREFIX level: a trie over token ids (duck-typed: needs ``match_len``;
    # the serving engine attaches its paged-KV cache index here) scores
    # *partial* overlap that the identity hash tables cannot see
    prefix_index: object = None

    # -- lookup ---------------------------------------------------------------
    def find(self, task: Task) -> tuple[MergeLevel, Task] | None:
        """Highest-level live match for ``task`` (Section 4.3 ordering)."""
        for level, table, key in (
            (MergeLevel.TASK, self._task_level, task.key_task_level()),
            (MergeLevel.DATA_OP, self._data_op, task.key_data_op()),
            (MergeLevel.DATA_ONLY, self._data_only, task.key_data_only()),
        ):
            hit = table.get(key)
            if hit is not None and hit.status == "queued" and hit.tid != task.tid:
                return level, hit
        return None

    def find_prefix_overlap(self, tokens) -> int:
        """PREFIX-level similarity score: tokens of ``tokens`` covered by the
        attached prefix index (0 without an index or below one block).

        Unlike the three identity levels this does not name a live task to
        merge *into* — the reuse target is cached KV from already-completed
        work, so the admission gate uses the score to account/route reuse
        rather than to build a compound task."""
        if self.prefix_index is None or tokens is None or len(tokens) < 2:
            return 0
        return self.prefix_index.match_len(tokens, len(tokens) - 1)

    # -- Fig. 4.3 update procedure ---------------------------------------------
    def _tables_and_keys(self, task: Task):
        return (
            ("task", self._task_level, task.key_task_level()),
            ("data_op", self._data_op, task.key_data_op()),
            ("data_only", self._data_only, task.key_data_only()),
        )

    def _point(self, task: Task, target: Task) -> None:
        for name, table, key in self._tables_and_keys(task):
            table[key] = target
            self._owned_keys.setdefault(target.tid, set()).add((name, key))

    def on_arrival(self, task: Task, merged_with: Task | None,
                   merged: Task | None, level: MergeLevel | None) -> None:
        """Update tables after the admission decision for ``task``.

        * merged at TASK level           -> rule (1): no update needed.
        * merged at DATA_OP/DATA_ONLY    -> rule (2): task's keys point to the
                                            compound task.
        * match found but not merged     -> rule (3): keys point to ``task``.
        * no match                       -> rule (4): add task's keys.
        """
        if merged is not None and level is MergeLevel.TASK:
            return
        if merged is not None:
            self._point(task, merged)
            return
        self._point(task, task)  # rules (3) and (4) coincide: newest wins

    def on_departure(self, task: Task) -> None:
        """Drop every entry pointing at ``task`` (completion/drop, Fig. 4.3).

        O(keys-owned-by-task) via the reverse index, honouring the paper's
        constant-time similarity-maintenance claim.
        """
        tables = {"task": self._task_level, "data_op": self._data_op,
                  "data_only": self._data_only}
        for name, key in self._owned_keys.pop(task.tid, ()):  # noqa: B020
            table = tables[name]
            hit = table.get(key)
            if hit is not None and hit.tid == task.tid:
                del table[key]

    def __len__(self) -> int:
        return len(self._task_level) + len(self._data_op) + len(self._data_only)


def merge_tasks(existing: Task, arriving: Task, level: MergeLevel) -> Task:
    """Build the compound task i+j (Section 4.3).

    The compound task *is* the existing task object augmented with the
    arriving request: the queue position, arrival time and identity of
    ``existing`` are preserved (the dissertation's "augment task i with task
    j's information"), and each request keeps its individual deadline —
    ``Task.effective_deadline`` exposes the earliest one to queue policies.
    """
    if existing.tid == arriving.tid:
        raise ValueError("cannot merge a task with itself")
    arriving.merged_into = existing.tid
    arriving.status = "merged"
    existing.children.append(arriving)
    return existing
