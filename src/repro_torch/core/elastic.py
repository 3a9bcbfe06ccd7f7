"""Elastic re-planning: node join/leave without losing triples-job work
(a copy of ``repro.core.elastic``, which is plain Python).

On node loss mid-sweep: completed tasks keep their results, in-flight and
queued tasks of the dead node are re-planned round-robin over the surviving
nodes (optionally restoring per-task state from checkpoints). On node join
the next wave simply plans over the larger alive set. The scheduler calls
these helpers; they are pure functions over plans for testability.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core import triples as T


@dataclasses.dataclass(frozen=True)
class ElasticState:
    plan: T.TriplesPlan
    completed: frozenset
    alive_nodes: Tuple[int, ...]


def surviving_results(plan: T.TriplesPlan, completed: Set[int],
                      dead_nodes: Set[int]) -> Tuple[Set[int], List[int]]:
    """Split task ids into (kept-completed, must-replan).

    Only unfinished tasks placed on a DEAD node must be re-planned;
    in-flight and queued tasks on healthy nodes keep their slots (and
    their work). Completed results survive regardless of where they ran.
    """
    must = []
    for s in plan.slots:
        if s.node not in dead_nodes:
            continue
        for tid in s.task_ids:
            if tid not in completed:
                must.append(tid)
    return set(completed), sorted(must)


def replan(state: ElasticState, dead_nodes: Set[int]) -> ElasticState:
    """Redistribute the dead nodes' unfinished tasks over the survivors.

    Healthy slots keep their own remaining tasks (minus completed ones);
    orphans from dead nodes append round-robin. Only if EVERY planned
    node died does the whole remainder get a fresh plan.
    """
    alive = tuple(n for n in state.alive_nodes if n not in dead_nodes)
    if not alive:
        raise RuntimeError("elastic replan: no nodes left")
    _, orphans = surviving_results(state.plan, set(state.completed),
                                   dead_nodes)
    kept = [dataclasses.replace(s, task_ids=tuple(
                t for t in s.task_ids if t not in state.completed))
            for s in state.plan.slots if s.node not in dead_nodes]
    if kept:
        lists = [list(s.task_ids) for s in kept]
        for i, tid in enumerate(orphans):
            lists[i % len(lists)].append(tid)
        slots = tuple(dataclasses.replace(s, task_ids=tuple(l))
                      for s, l in zip(kept, lists))
        new_plan = dataclasses.replace(state.plan, slots=slots)
        return ElasticState(plan=new_plan, completed=state.completed,
                            alive_nodes=alive)
    # every planned node is gone: fresh plan over the survivors
    trip = state.plan.triples
    new_trip = T.Triples(nnode=len(alive), nppn=trip.nppn, ntpp=trip.ntpp)
    new_plan = T.plan(len(orphans), new_trip, state.plan.node_spec,
                      alive_nodes=alive)
    remap = {i: tid for i, tid in enumerate(orphans)}
    slots = tuple(
        dataclasses.replace(s, task_ids=tuple(remap[i] for i in s.task_ids))
        for s in new_plan.slots)
    new_plan = dataclasses.replace(new_plan, slots=slots,
                                   n_tasks=state.plan.n_tasks)
    return ElasticState(plan=new_plan, completed=state.completed,
                        alive_nodes=alive)


def join(state: ElasticState, new_nodes: Sequence[int]) -> ElasticState:
    alive = tuple(sorted(set(state.alive_nodes) | set(new_nodes)))
    return dataclasses.replace(state, alive_nodes=alive)
