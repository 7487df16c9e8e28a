"""Job dispatching (paper Algorithm 1): multi-list scheduling.

Tasks are bucketed into lists by expected answer length l_i; an idle edge
device pulls a batch from the list with the most jobs. Batching
uniform-length tasks avoids short sequences waiting on long ones (the
quadratic-cost padding waste the paper calls out).

The queue is generic over any task carrying an `expected_length` attribute:
the PICE pipeline queues `SketchTask`s, and the serving front-end
(serving/frontend.py) reuses the same structure — and the same shedding
policy — as its admission waiting room, with `on_shed_task` notifying it
which queued request a shed displaced and `peek_best`/`remove` providing
priority-ordered (rather than batch-pulled) admission.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass
class MultiListQueue:
    """Lists q_1..q_n bucketed by expected length.

    `max_size` is enforced at push: a full queue sheds its least latency-
    critical work (the longest queued expected length) to admit a shorter
    incoming task, or rejects the incoming task outright when it is itself
    the longest. Shed/reject counts land in `shed_count` and, when a
    `monitor` (RuntimeMonitor) is attached, in `monitor.queue_shed`; a
    shed of an already-QUEUED victim additionally fires `on_shed_task`
    (push returning False signals an incoming-task refusal)."""
    boundaries: Sequence[int] = (64, 128, 256, 512, 1024)
    max_size: int = 64
    monitor: Optional[object] = None
    on_shed_task: Optional[Callable[[object], None]] = None

    def __post_init__(self):
        self.lists: List[List[object]] = [[] for _ in
                                          range(len(self.boundaries) + 1)]
        self.shed_count = 0

    def _index(self, l: int) -> int:
        for j, b in enumerate(self.boundaries):
            if l <= b:
                return j
        return len(self.boundaries)

    def __len__(self) -> int:
        return sum(len(q) for q in self.lists)

    @property
    def full(self) -> bool:
        return len(self) >= self.max_size

    def push(self, task) -> bool:
        """Enqueue `task`; returns False when it was refused (queue full and
        the task is the least-critical candidate). Lines 3-6 of Algorithm 1
        (bucket by l_i) are unchanged when the queue has room."""
        if len(self) >= self.max_size:
            victim = self._shed_candidate()
            if victim is None or victim.expected_length <= \
                    task.expected_length:
                # incoming task is itself the longest: refuse it
                self._record_shed(task)
                return False
            self.lists[self._index(victim.expected_length)].remove(victim)
            self._record_shed(victim)
            if self.on_shed_task is not None:
                self.on_shed_task(victim)
        self.lists[self._index(task.expected_length)].append(task)
        return True

    def _shed_candidate(self):
        """The queued task shedding frees the most time for: the largest
        expected length (the least latency-critical by the multi-list
        ordering), youngest within a list so older work keeps its place."""
        longest = None
        for q in self.lists:
            for t in q:
                if longest is None or t.expected_length >= \
                        longest.expected_length:
                    longest = t
        return longest

    def _record_shed(self, task) -> None:
        self.shed_count += 1
        if self.monitor is not None:
            self.monitor.on_shed(task.expected_length)

    def pull_batch(self, batch_size: int) -> List[object]:
        """Lines 7-11: pull a batch from the longest list (FIFO within it)."""
        if not len(self):
            return []
        jmax = max(range(len(self.lists)), key=lambda j: len(self.lists[j]))
        q = self.lists[jmax]
        batch, self.lists[jmax] = q[:batch_size], q[batch_size:]
        return batch

    def peek_best(self, key: Callable[[object], object]):
        """The queued task minimizing `key` across every list, without
        removing it — the front-end peeks its admission candidate, attempts
        engine admission, and only `remove`s on success (so a task that
        must wait for pages keeps its queue position)."""
        best = None
        for q in self.lists:
            for t in q:
                if best is None or key(t) < key(best):
                    best = t
        return best

    def remove(self, task) -> bool:
        """Remove a specific queued task (admitted or cancelled)."""
        for q in self.lists:
            if task in q:
                q.remove(task)
                return True
        return False

    def peek_expected_tokens(self) -> float:
        return float(sum(t.expected_length for q in self.lists for t in q))
