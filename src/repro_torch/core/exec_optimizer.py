"""Execution optimizer (paper §IV-B): semantic-level parallelism with
binary-tree sentence merging.

Each sketch sentence is semantically complete, so expansions are independent
and can run as a parallel batch. But (1) sentence lengths vary — naive
batching pads short ones while long ones finish — and (2) every parallel
prompt repeats the sketch context in its KV cache. The fix: sort the k
sentences by word count and merge pairwise (longest with shortest):
(s_1, s_k), (s_2, s_{k-1}), ... giving ceil(k/2) groups with near-uniform
total length; recurse while the latency hard-constraint still holds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass
class MergePlan:
    groups: List[List[str]]        # sentences per expansion prompt
    parallelism: int               # len(groups)
    est_latency_s: float
    merge_depth: int


def _word_count(s: str) -> int:
    return max(len(s.split()), 1)


def merge_once(groups: List[List[str]]) -> List[List[str]]:
    """One binary-tree merge level: sort by total word count, pair ends."""
    order = sorted(groups, key=lambda g: sum(_word_count(s) for s in g))
    merged: List[List[str]] = []
    i, j = 0, len(order) - 1
    while i < j:
        merged.append(order[i] + order[j])     # shortest with longest
        i, j = i + 1, j - 1
    if i == j:
        merged.append(order[i])
    return merged


def plan_expansion(sentences: Sequence[str],
                   latency_of_parallelism: Callable[[int, float], float],
                   latency_budget_s: float,
                   expansion_factor: float = 2.5,
                   max_parallelism: Optional[int] = None) -> MergePlan:
    """Choose the merge depth.

    latency_of_parallelism(p, longest_group_tokens) -> estimated edge latency
    for p parallel prompts whose longest group expands to ~longest_group_tokens.
    Starts fully parallel (p=k); while the NEXT merge level still satisfies
    the budget, merge (lower p => less prompt/KV overhead — the paper's
    "higher parallelism is not always preferable").
    """
    groups = [[s] for s in sentences if s.strip()]
    if not groups:
        return MergePlan(groups=[[""]], parallelism=1, est_latency_s=0.0,
                         merge_depth=0)
    if max_parallelism:
        while len(groups) > max_parallelism:
            groups = merge_once(groups)

    def est(gs: List[List[str]]) -> float:
        longest = max(sum(_word_count(s) for s in g) for g in gs)
        return latency_of_parallelism(len(gs), longest * expansion_factor)

    depth = 0
    cur = est(groups)
    while len(groups) > 1:
        cand = merge_once(groups)
        lat = est(cand)
        if lat <= latency_budget_s:
            groups, cur, depth = cand, lat, depth + 1
        else:
            break
    return MergePlan(groups=groups, parallelism=len(groups),
                     est_latency_s=cur, merge_depth=depth)
