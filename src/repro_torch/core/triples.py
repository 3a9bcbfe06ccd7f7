"""Triples mode: (NNODE, NPPN, NTPP) task placement — the paper's §II.

The triples map a set of tasks onto nodes / process-slots / accelerators:

  * NNODE — nodes used by the job (gang-allocated, whole-node policy);
  * NPPN  — concurrent process slots per node. Tasks are assigned to slots
    round-robin (the paper's auto-generated execution script);
  * NTPP  — per-process parallelism. On the paper's CPU/GPU clusters this
    is OMP_NUM_THREADS; on a TPU mesh it is chips-per-task.

Accelerator sharing is the over-allocation case: slot j on a node is
pinned to chip group (j*NTPP .. j*NTPP+NTPP-1) mod chips_per_node — the
round-robin CUDA_VISIBLE_DEVICES assignment of the paper. When
NPPN*NTPP > chips_per_node, pack_factor > 1 slots co-reside on each chip;
on TPU they execute as vmapped lanes of one program (core/packing.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One node of the target cluster (defaults: TPU v5e host)."""
    chips_per_node: int = 4
    hbm_per_chip: float = 16e9          # bytes
    cores_per_node: int = 40            # paper's Volta nodes (CPU tasks)

    @property
    def hbm_per_node(self) -> float:
        return self.chips_per_node * self.hbm_per_chip


@dataclasses.dataclass(frozen=True)
class Triples:
    """The paper's triplet. ``NNODE * NPPN`` = total concurrent processes."""
    nnode: int
    nppn: int
    ntpp: int = 1

    def __post_init__(self):
        if min(self.nnode, self.nppn, self.ntpp) < 1:
            raise ValueError(f"triples must be positive: {self}")

    @property
    def total_slots(self) -> int:
        return self.nnode * self.nppn

    def pack_factor(self, node: NodeSpec) -> int:
        """Tasks co-resident per chip (1 = exclusive, >1 = sharing)."""
        return max(1, math.ceil(self.nppn * self.ntpp / node.chips_per_node))

    def is_sharing(self, node: NodeSpec) -> bool:
        return self.nppn * self.ntpp > node.chips_per_node


@dataclasses.dataclass(frozen=True)
class SlotAssignment:
    """One process slot of the triples job."""
    node: int
    slot: int                            # process index within node
    chips: Tuple[int, ...]               # chip ids on the node (round-robin)
    pack_lane: int                       # lane id, UNIQUE among the slots
                                         # sharing any of this slot's chips.
                                         # Ids are dense per chip when chip
                                         # groups don't wrap; wrapped groups
                                         # (ntpp not dividing chips_per_node)
                                         # can form odd cycles in the chip-
                                         # sharing graph, where a proper
                                         # assignment NEEDS more ids than
                                         # one chip's co-residency count —
                                         # treat it as a label, not an index
                                         # into a pack_factor-sized pool
    task_ids: Tuple[int, ...]            # tasks this slot executes, in order
    slice: Optional[int] = None          # spatial slice hosting this slot
                                         # (core/spatial.py; None = the
                                         # whole-node temporal modes)


@dataclasses.dataclass(frozen=True)
class TriplesPlan:
    triples: Triples
    node_spec: NodeSpec
    n_tasks: int
    slots: Tuple[SlotAssignment, ...]

    @property
    def pack_factor(self) -> int:
        return self.triples.pack_factor(self.node_spec)

    def tasks_of_node(self, node: int) -> List[int]:
        out: List[int] = []
        for s in self.slots:
            if s.node == node:
                out.extend(s.task_ids)
        return out

    def chip_load(self) -> dict:
        """(node, chip) -> number of concurrent slots pinned (paper Fig 2)."""
        load: dict = {}
        for s in self.slots:
            for c in s.chips:
                load[(s.node, c)] = load.get((s.node, c), 0) + 1
        return load

    def slot_of_task(self, task_id: int) -> SlotAssignment:
        for s in self.slots:
            if task_id in s.task_ids:
                return s
        raise KeyError(task_id)


def plan(n_tasks: int, triples: Triples,
         node_spec: Optional[NodeSpec] = None,
         alive_nodes: Optional[Sequence[int]] = None,
         slices: Optional[Tuple[object, Sequence[int]]] = None) -> TriplesPlan:
    """Build the placement plan: tasks -> slots round-robin; slots -> chips
    round-robin. ``alive_nodes`` restricts placement (elastic re-planning).

    ``slices`` confines the plan to SPATIAL slices of each node
    (DESIGN.md §10): a ``(SliceConfig, slice_indices)`` pair naming the
    slices this job owns. ``slice_indices`` may REPEAT an index to
    weight it — the scheduler expands the planner's per-slice lane
    counts into one entry per lane (e.g. ``(0, 0, 2)`` = two lanes on
    slice 0, one on slice 2), so an admission-capped small slice never
    receives more slots than ``admit_slice`` approved. Slots cycle over
    the entries; each slot's chips come from its slice's chip window
    (``SliceConfig.chips_of``) instead of the whole-node round-robin,
    and ``SlotAssignment.slice`` records the hosting slice. pack_lane
    stays unique per (node, chip) across all slices of ONE plan;
    across co-resident gangs in different slices of the same chip the
    slice id (part of the slot's address, like a MIG instance handle)
    is what disambiguates the lanes — their HBM shares are disjoint by
    construction."""
    node_spec = node_spec or NodeSpec()
    nodes = list(alive_nodes) if alive_nodes is not None else list(
        range(triples.nnode))
    if not nodes:
        raise ValueError("no alive nodes")
    cpn = node_spec.chips_per_node

    slot_keys = [(n, j) for n in nodes for j in range(triples.nppn)]
    task_lists: List[List[int]] = [[] for _ in slot_keys]
    for t in range(n_tasks):
        task_lists[t % len(slot_keys)].append(t)

    slots = []
    # pack_lane is derived from ACTUAL chip co-residency, not the arithmetic
    # (j*ntpp)//cpn: when ntpp does not divide cpn the round-robin chip
    # groups WRAP (e.g. cpn=4, ntpp=3: slot 1 takes chips (3,0,1)), so two
    # slots sharing a chip could land on the same arithmetic lane. Each slot
    # takes the smallest lane index unused on every chip it touches — lanes
    # are unique per (node, chip) by construction, and the assignment
    # reduces to (j*ntpp)//cpn in the non-wrapping case.
    lanes_taken: dict = {}              # (node, chip) -> set of lane ids
    for (node, j), tl in zip(slot_keys, task_lists):
        if slices is not None:
            config, indices = slices
            sl = indices[j % len(indices)]
            chips = config.chips_of(sl, node_spec)
        else:
            sl = None
            first = (j * triples.ntpp) % cpn
            chips = tuple((first + i) % cpn
                          for i in range(min(triples.ntpp, cpn)))
        taken = set()
        for c in chips:
            taken |= lanes_taken.setdefault((node, c), set())
        pack_lane = 0
        while pack_lane in taken:
            pack_lane += 1
        for c in chips:
            lanes_taken[(node, c)].add(pack_lane)
        slots.append(SlotAssignment(node=node, slot=j, chips=chips,
                                    pack_lane=pack_lane, task_ids=tuple(tl),
                                    slice=sl))
    return TriplesPlan(triples=triples, node_spec=node_spec,
                       n_tasks=n_tasks, slots=tuple(slots))


def recommend_for_gpus(n_tasks: int, nnode: int, node_spec: NodeSpec,
                       concurrent_per_chip: int = 1) -> Triples:
    """Paper §II guidance: NPPN = chips per node (exclusive) scaled by the
    desired sharing factor; NTPP shrinks to keep NPPN*NTPP bounded by the
    core budget (Table I)."""
    nppn = node_spec.chips_per_node * concurrent_per_chip
    ntpp = max(1, node_spec.cores_per_node // nppn)
    return Triples(nnode=nnode, nppn=nppn, ntpp=ntpp)
