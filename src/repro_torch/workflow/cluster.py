"""Event-driven heterogeneous cluster simulator (paper's shared-cluster
setting): a copy of the reference's numpy-only ``repro.workflow.cluster``,
bitwise, with its imports pointed at the port.

The serial replay in :mod:`repro_torch.workflow.simulator` runs tasks one at a
time on a single implicit machine, so throughput and utilization effects of
over-/under-provisioning — the paper's core trade-off — are invisible. This
engine executes a trace *concurrently* on a set of nodes with finite (and
possibly different) memory capacity:

  * an event queue advances virtual time between task arrivals,
    completions (successes and ttf-scaled OOM kills), and node
    crash/recover events;
  * nodes are described by :class:`NodeSpec` — per-node capacity and an
    optional *machine class* label. A task whose ``machine`` matches a
    node class only runs on nodes of that class (per-machine predictor
    pools then really see different capacities); a task whose label names
    no node class is unconstrained (homogeneous traces run anywhere);
  * tasks occupy their ``allocation_gb`` on one node for the duration of
    each attempt; an OOM kill frees the node and re-enqueues the task at
    its original FIFO position with the method's retry allocation. The
    per-task abort capacity is the *largest node the task could ever be
    placed on* (``AttemptLedger.cap_gb`` is per-attempt state, not a
    global constant); a request no node can ever fit is rejected at
    admission;
  * completions unlock downstream *ready sets* via the instance-level
    dependency edges on :class:`TaskInstance`; each scheduling round sizes
    the newly-ready tasks as ONE burst through the method's
    ``allocate_batch`` (one device dispatch per pool), then places
    them with a pluggable policy from :data:`PLACEMENT_POLICIES` (fifo /
    backfill / best_fit / spread / preemptive);
  * node failures are a deterministic seeded schedule of crash/recover
    events (``fail_rate_per_node_h``): attempts running on a crashed node
    are killed *without* OOM accounting (the partial reservation is burned
    as wastage, but no failure count / retry-ladder step) and requeued at
    their original FIFO seq. Preemption (the ``preemptive`` policy) uses
    the same interruption semantics;
  * *correlated* rack failures (``rack_fail_rate_per_h``) crash every up
    node of a rack (:attr:`NodeSpec.rack`) in ONE event, with per-rack
    repair times; a *straggler* model (``straggler_rate``) stretches a
    seeded subset of attempts in wall time, flowing through every
    reservation time-integral and RESIZE boundary. What an interruption
    costs — full re-run, re-sized re-run, or checkpoint-resumed suffix —
    is the method's ``failure_strategy``
    (:data:`~repro_torch.workflow.accounting.FAILURE_STRATEGIES`);
  * node reservations are tracked *exactly*: ``Node.free_gb`` is the
    capacity minus an exactly-rounded sum (``math.fsum``) of the
    outstanding allocations, never an incrementally drifting ``+=``/``-=``
    accumulator — so an exact-fit request (``alloc == cap``, which shipped
    methods produce via capacity clamping) always places on an idle node.
    Resizes mutate the per-token held amount, so the invariant survives
    any shrink/grow sequence;
  * *temporal* methods (exposing ``plan_for``) attach a multi-segment
    :class:`~repro_torch.core.temporal.segments.ReservationPlan` to an attempt:
    dispatch reserves the FIRST segment only, and a ``RESIZE`` event at
    each predicted segment boundary shrinks or grows the reservation in
    place. A grow that finds its node too full is a *grow failure*: the
    attempt burns its partial plan integral as an interruption (no OOM
    accounting) and requeues at its original FIFO seq; after
    ``MAX_GROW_FAILURES`` denied grows the plan flattens to a constant
    peak reservation, so placement serializes it and progress is
    guaranteed. A plan that under-covers the ground-truth usage curve is
    OOM-killed exactly at the first crossing (the violation time is the
    time-to-failure; ``ttf`` scales only flat-attempt kills). Single-
    segment plans take the legacy flat path bit-for-bit — the resize
    machinery is provably inert at k=1 (asserted in
    ``tests/test_temporal.py``);
  * simultaneous completions (finish events draining at one clock value)
    are observed as ONE batch: methods exposing ``complete_batch`` get the
    whole wave and fuse the model updates into one observe dispatch per
    pool (``DISPATCH_COUNTS['observe_pool']`` asserts the bound);
    same-clock ``RESIZE`` runs drain the same way — one wave applied in
    pop order (``n_resize_waves`` counts them), with the node's zero-dt
    ``_advance`` fast path skipping the per-member reservation fsum;
  * per-attempt waste/retry arithmetic is the shared
    :class:`~repro_torch.workflow.accounting.AttemptLedger`, so the serial
    simulator is exactly the 1-node / sequential-arrival / failure-free
    special case of this engine (asserted in ``tests/test_cluster.py``).

Two deliberate semantics notes. A request larger than every *eligible*
node's capacity is rejected at admission (aborted without running — a real
resource manager refuses it); the serial path has no admission check and
would burn the attempt. Shipped methods clamp to the per-task
``machine_cap_gb`` (heterogeneous traces) or the trace-wide machine cap,
so on a matched trace/node-set this only triggers on hand-built traces —
but running a *legacy homogeneous* trace on node_specs whose largest node
is smaller than the trace's machine cap WILL mass-reject (the methods size
for hardware that does not exist); the engine emits a ``RuntimeWarning``
the first time that happens. And an aborted task *unlocks*
its dependents rather than failing the subtree: the simulator's job is
wastage/throughput comparison over the full task population, so every
instance of the trace gets an outcome — exactly the serial replay's
behaviour (it ignores dependency edges entirely).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import itertools
import math
import warnings
from typing import Callable, Sequence

import numpy as np

from repro_torch.obs.trace import span as _span
from repro_torch.utils.misc import stable_hash
from repro_torch.workflow.accounting import (DEFAULT_CHECKPOINT_FRAC,
                                             FAILURE_STRATEGIES,
                                             AttemptLedger, TaskOutcome)
from repro_torch.workflow.simulator import (ClusterMetrics, SimResult,
                                            SizingMethod)
from repro_torch.workflow.trace import TaskInstance, WorkflowTrace

__all__ = ["NodeSpec", "Node", "machine_label", "node_specs_from_caps",
           "node_specs_from_racks", "simulate_cluster", "ClusterEngine",
           "PLACEMENT_POLICIES", "FAILURE_STRATEGIES"]

(_ARRIVE, _FINISH, _CRASH, _RECOVER, _RESIZE,
 _RACK_CRASH, _RACK_RECOVER) = range(7)

_DEFAULT_CLASS = "default"


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Static description of one cluster node.

    ``machine`` is the node's class label; tasks whose
    ``TaskInstance.machine`` equals a label are constrained to that class.
    ``None`` means the node accepts any task. ``rack`` is the node's
    failure domain: a correlated rack-failure event
    (``rack_fail_rate_per_h``) crashes every node sharing the label at
    once. ``None`` means the node belongs to no rack (it only fails
    through the independent per-node schedule).
    """
    name: str
    cap_gb: float
    machine: str | None = None
    rack: str | None = None


def machine_label(cap_gb: float) -> str:
    """Canonical machine-class label for a node capacity (``m16``, ``m32``,
    ...). The ONE formatting used by :func:`node_specs_from_caps` and every
    trace/bench caller — a label mismatch would silently disable placement
    constraints (unknown task labels are unconstrained by design)."""
    return f"m{float(cap_gb):g}"


def node_specs_from_caps(caps: Sequence[float],
                         n_nodes: int | None = None,
                         n_racks: int | None = None) -> list[NodeSpec]:
    """Build a heterogeneous node set by cycling ``caps`` over ``n_nodes``
    nodes (default: one node per cap). Class labels come from
    :func:`machine_label` — the same labels
    :func:`repro_torch.workflow.generators.generate_workflow` should be given
    via ``machine_caps_gb={machine_label(c): c for c in caps}``.

    ``n_racks`` additionally splits the nodes into that many *contiguous*
    rack failure domains (``rack00``, ``rack01``, ...). Contiguous blocks
    (not ``i % n_racks``, which would alias with the cap cycle and give
    each rack a single class): any block of at least ``len(caps)`` nodes
    carries every node class, so a rack outage degrades the cluster
    evenly instead of deleting one class wholesale."""
    caps = [float(c) for c in caps]
    if not caps:
        raise ValueError("need at least one node capacity")
    n = len(caps) if n_nodes is None else n_nodes
    if n < len(caps):
        # a dropped class would leave the matching trace tasks sized for
        # hardware that does not exist -> mass admission rejections; make
        # the misconfiguration loud instead
        raise ValueError(f"n_nodes={n} drops node classes: need at least "
                         f"one node per capacity in {caps}")
    if n_racks is not None and not 1 <= n_racks <= n:
        # more racks than nodes would silently yield fewer (gap-labeled)
        # failure domains than asked for — be loud, like the node-class
        # guard above
        raise ValueError(f"n_racks must be in [1, {n}], got {n_racks}")
    return [NodeSpec(f"node{i:02d}", caps[i % len(caps)],
                     machine_label(caps[i % len(caps)]),
                     rack=(f"rack{(i * n_racks) // n:02d}" if n_racks
                           else None))
            for i in range(n)]


def node_specs_from_racks(
        rack_caps: Sequence[Sequence[float]]) -> list[NodeSpec]:
    """Build a node set from an explicit rack topology: one inner sequence
    of node capacities per rack (the ``--rack-caps 16,32;16,32`` CLI
    shape). Machine-class labels come from :func:`machine_label`, rack
    labels are ``rack00``, ``rack01``, ... in the order given."""
    specs: list[NodeSpec] = []
    for ri, caps in enumerate(rack_caps):
        caps = [float(c) for c in caps]
        if not caps:
            raise ValueError(f"rack {ri} names no node capacities")
        for c in caps:
            specs.append(NodeSpec(f"node{len(specs):02d}", c,
                                  machine_label(c), rack=f"rack{ri:02d}"))
    if not specs:
        raise ValueError("need at least one rack with at least one node")
    return specs


class Node:
    """Runtime node state: exact reservation tracking + time integrals.

    Outstanding allocations are held per attempt token and summed with
    :func:`math.fsum` (exactly-rounded, order-independent), so repeated
    reserve/release cycles cannot drift ``free_gb`` away from ``cap_gb``
    — the float-drift stall bug of the incremental accumulator.
    """

    def __init__(self, spec: NodeSpec):
        self.spec = spec
        self.name = spec.name
        self.cap_gb = spec.cap_gb
        self.machine = spec.machine
        self._held: dict[int, float] = {}   # attempt token -> reserved GB
        self._reserved = 0.0                # fsum cache, refreshed on mutation
        self.reserved_gbh = 0.0             # integral of reserved GB over time
        self.down_h = 0.0                   # total crashed time
        self.last_t = 0.0
        self.up = True
        self.n_crashes = 0

    def _refresh_reserved(self) -> None:
        """Recompute the exact reservation sum. Called after every ``_held``
        mutation, so ``reserved_gb``/``free_gb`` are O(1) reads of the SAME
        exactly-rounded :func:`math.fsum` value the uncached property
        returned — the engine's placement scans read ``free_gb`` millions
        of times per run, the held set mutates only per attempt event."""
        self._reserved = math.fsum(self._held.values())

    @property
    def reserved_gb(self) -> float:
        return self._reserved

    @property
    def free_gb(self) -> float:
        return self.cap_gb - self.reserved_gb

    def _advance(self, t: float) -> None:
        dt = t - self.last_t
        if dt == 0.0:
            # same-clock call: every accumulation below would add an
            # exact 0.0 — resize waves hit this once per member instead
            # of paying the O(held) hold-integral update each
            return
        self.reserved_gbh += self.reserved_gb * dt
        if not self.up:
            self.down_h += dt
        self.last_t = t

    def reserve(self, t: float, token: int, gb: float) -> None:
        self._advance(t)
        self._held[token] = gb
        self._refresh_reserved()

    def release(self, t: float, token: int) -> float:
        self._advance(t)
        gb = self._held.pop(token)
        self._refresh_reserved()
        return gb

    def held_gb(self, token: int) -> float:
        """Current reservation of one attempt (post any resizes)."""
        return self._held[token]

    def resize(self, t: float, token: int, gb: float) -> float:
        """Set an outstanding reservation to ``gb`` (segment boundary of a
        temporal plan); returns the delta. The caller checks grow room —
        this just swaps the held amount, so ``free_gb`` stays an exact
        fsum over outstanding allocations."""
        self._advance(t)
        delta = gb - self._held[token]
        self._held[token] = gb
        self._refresh_reserved()
        return delta

    def crash(self, t: float) -> None:
        self._advance(t)
        self.up = False
        self.n_crashes += 1

    def recover(self, t: float) -> None:
        self._advance(t)
        self.up = True


@dataclasses.dataclass
class _Queued:
    """A ready task waiting for (or returning to) the dispatch queue."""
    seq: int                    # FIFO priority: ready order, kept on retry
    ready_h: float
    task: TaskInstance
    ledger: AttemptLedger | None = None   # None until sized
    start_h: float | None = None          # first dispatch time
    n_dispatches: int = 0       # straggler draws are keyed per dispatch
    task_hash: int | None = None  # cached stable_hash of the task key


class _SeqQueue:
    """The ready queue as a seq-ordered sequence with O(log Q) requeue and
    O(1) amortized removal (trace-scale refactor).

    The legacy engine kept a plain list: re-sorted every step, rebuilt with
    an O(Q) comprehension after every placement round — quadratic once the
    backlog reaches trace scale. Entries here are kept sorted by ``seq``
    permanently: new arrivals carry a monotonically increasing seq (append),
    interrupted/killed attempts re-enter at their ORIGINAL seq (bisect
    insort), and placed/rejected entries are tombstoned and physically
    dropped by periodic compaction. Iteration order — the one thing every
    placement policy and the journal snapshot observe — is exactly the
    ``sort(key=e.seq)`` order of the legacy list.

    A requeued entry whose tombstone has not been compacted away yet is
    *revived* in place (same object, same seq, position still correct), so
    an entry is never physically present twice.
    """

    __slots__ = ("_items", "_dead")

    def __init__(self, items: Sequence[_Queued] = ()):
        self._items = sorted(items, key=lambda e: e.seq)
        self._dead: set[int] = set()

    def push(self, entry: _Queued) -> None:
        """Append a NEW entry (its seq must be the largest ever issued)."""
        self._items.append(entry)

    def requeue(self, entry: _Queued) -> None:
        """Re-admit an interrupted/killed entry at its original seq."""
        if id(entry) in self._dead:
            self._dead.discard(id(entry))   # still in place — revive
        else:
            bisect.insort(self._items, entry, key=lambda e: e.seq)

    def discard(self, entry: _Queued) -> None:
        self._dead.add(id(entry))
        if len(self._dead) * 2 > len(self._items) and len(self._dead) > 32:
            self.compact()

    def compact(self) -> None:
        self._items = [e for e in self._items if id(e) not in self._dead]
        self._dead.clear()

    def __iter__(self):
        dead = self._dead
        if not dead:
            return iter(self._items)
        # Placements tombstone the FRONT of the queue, so under a large
        # backlog the dead prefix grows far faster than the compaction
        # threshold triggers — drop it eagerly (a partial compaction:
        # iteration order is unchanged, and a later requeue of a dropped
        # entry re-inserts at its seq via insort exactly as after a full
        # compact). Amortized O(1) per discard; turns the per-round
        # tombstone skip from O(dead) into O(1).
        items = self._items
        k, n = 0, len(items)
        while k < n and id(items[k]) in dead:
            dead.discard(id(items[k]))
            k += 1
        if k:
            del items[:k]
        if not dead:
            return iter(items)
        return (e for e in items if id(e) not in dead)

    def __len__(self) -> int:
        return len(self._items) - len(self._dead)

    def __bool__(self) -> bool:
        return len(self._items) > len(self._dead)

    def __getitem__(self, i):
        if self._dead:
            self.compact()
        return self._items[i]


class _SegTree:
    """Max segment tree over one node category's members (engine node
    order): O(log n) point update, O(log n) leftmost-member-with-
    ``free >= alloc`` query — the first-fit primitive. Down members hold
    ``-inf`` so they never match."""

    __slots__ = ("size", "tree", "members")

    def __init__(self, members: list[int]):
        self.members = members
        size = 1
        while size < max(1, len(members)):
            size *= 2
        self.size = size
        self.tree = [float("-inf")] * (2 * size)

    def set(self, pos: int, val: float) -> None:
        i = pos + self.size
        self.tree[i] = val
        i >>= 1
        while i:
            self.tree[i] = max(self.tree[2 * i], self.tree[2 * i + 1])
            i >>= 1

    def first_at_least(self, alloc: float) -> int | None:
        """Smallest member position with value >= alloc -> node index."""
        tree = self.tree
        if tree[1] < alloc:
            return None
        i = 1
        while i < self.size:
            i *= 2
            if tree[i] < alloc:
                i += 1
        return self.members[i - self.size]


class _FreeIndex:
    """Per-node-class free-capacity index for the placement scan.

    One structure per *category* — a category is a node's machine label
    (``None`` = unlabeled). Eligibility and the per-node blocked counters
    of :func:`_scan` depend only on a node's category, so the indexed scan
    in :meth:`ClusterEngine._place_indexed` replaces the legacy per-round
    O(nodes) ``free``/``blocked`` dict builds and per-entry candidate
    list comprehensions with O(log n) category queries, while choosing
    bitwise the node the legacy ``choose`` functions pick.

    ``free`` mirrors each node's exact ``free_gb``: the engine syncs it
    after every authoritative reservation mutation (reserve / release /
    resize / crash / recover), and the scan applies its provisional
    in-round decrements with the same ``free -= alloc`` float arithmetic
    the legacy scan-local dict used — so every comparison any query makes
    sees exactly the floats the legacy scan compared.

    Only the structure the engine's (fixed) policy needs is maintained:

      * ``mode='first'`` (fifo / backfill / preemptive): per-category max
        segment tree -> leftmost node with room;
      * ``mode='best'`` (best_fit): per-category sorted ``(free, idx)``
        lists -> tightest node with room, ulp-exact tie handling;
      * ``mode='spread'``: sorted lists per (category, capacity) — the
        spread key is monotone in ``free`` only at fixed capacity.
    """

    __slots__ = ("nodes", "cat_of", "cats", "members", "pos_in_cat",
                 "free", "isup", "up_count", "mode", "trees", "lists",
                 "cap_of", "caps_in_cat", "n_ops")

    def __init__(self, nodes: list[Node], mode: str):
        self.nodes = nodes
        self.mode = mode
        self.cat_of = [n.machine for n in nodes]
        self.cats: list[str | None] = []
        self.members: dict[str | None, list[int]] = {}
        for i, c in enumerate(self.cat_of):
            if c not in self.members:
                self.cats.append(c)
                self.members[c] = []
            self.members[c].append(i)
        self.pos_in_cat = [0] * len(nodes)
        for c, mem in self.members.items():
            for p, i in enumerate(mem):
                self.pos_in_cat[i] = p
        self.cap_of = [n.cap_gb for n in nodes]
        self.caps_in_cat = {c: sorted({self.cap_of[i] for i in mem})
                            for c, mem in self.members.items()}
        self.free = [0.0] * len(nodes)
        self.isup = [True] * len(nodes)
        self.up_count = dict.fromkeys(self.cats, 0)
        self.trees: dict[str | None, _SegTree] = {}
        self.lists: dict = {}
        self.n_ops = 0   # structure updates+queries (regression counter)
        self.rebuild()

    # ------------------------------------------------------------- updates
    def rebuild(self) -> None:
        """Derive everything from the authoritative Node states (engine
        init and journal restore: snapshots serialize nodes, never this
        index — it is deterministically reconstructible)."""
        if self.mode == "first":
            self.trees = {c: _SegTree(mem)
                          for c, mem in self.members.items()}
        elif self.mode == "best":
            self.lists = {c: [] for c in self.cats}
        elif self.mode == "spread":
            self.lists = {(c, cap): []
                          for c in self.cats for cap in self.caps_in_cat[c]}
        self.up_count = dict.fromkeys(self.cats, 0)
        for i, n in enumerate(self.nodes):
            self.free[i] = n.free_gb
            self.isup[i] = n.up
            if n.up:
                self.up_count[self.cat_of[i]] += 1
                self._insert(i, self.free[i])

    def _insert(self, i: int, val: float) -> None:
        if self.mode == "first":
            self.trees[self.cat_of[i]].set(self.pos_in_cat[i], val)
        elif self.mode == "best":
            bisect.insort(self.lists[self.cat_of[i]], (val, i))
        elif self.mode == "spread":
            bisect.insort(self.lists[(self.cat_of[i], self.cap_of[i])],
                          (val, i))

    def _remove(self, i: int, val: float) -> None:
        if self.mode == "first":
            self.trees[self.cat_of[i]].set(self.pos_in_cat[i],
                                           float("-inf"))
        elif self.mode == "best":
            lst = self.lists[self.cat_of[i]]
            lst.pop(bisect.bisect_left(lst, (val, i)))
        elif self.mode == "spread":
            lst = self.lists[(self.cat_of[i], self.cap_of[i])]
            lst.pop(bisect.bisect_left(lst, (val, i)))

    def set_free(self, i: int, val: float) -> None:
        """Move node ``i``'s mirrored free capacity to ``val``."""
        self.n_ops += 1
        if self.isup[i]:
            self._remove(i, self.free[i])
            self.free[i] = val
            self._insert(i, val)
        else:
            self.free[i] = val

    def sync(self, node: Node) -> None:
        """Re-mirror one node after an authoritative mutation."""
        self.set_free(node.idx, node.free_gb)

    def set_down(self, i: int) -> None:
        if self.isup[i]:
            self.n_ops += 1
            self._remove(i, self.free[i])
            self.isup[i] = False
            self.up_count[self.cat_of[i]] -= 1

    def set_up(self, i: int) -> None:
        if not self.isup[i]:
            self.n_ops += 1
            self.isup[i] = True
            self.free[i] = self.nodes[i].free_gb
            self.up_count[self.cat_of[i]] += 1
            self._insert(i, self.free[i])

    # ------------------------------------------------------------- queries
    def query(self, cat, alloc: float):
        """Best candidate of one category with ``free >= alloc``, as a
        policy-comparable ``(rank..., idx)`` tuple (None when the category
        has no such up node). Tuples compare across categories exactly as
        the legacy ``choose`` over the concatenated candidate list: the
        final element is the node index, the legacy tie-break (``min`` /
        ``cands[0]`` take the first minimum in node order)."""
        self.n_ops += 1
        if self.mode == "first":
            idx = self.trees[cat].first_at_least(alloc)
            return None if idx is None else (idx,)
        if self.mode == "best":
            return self._query_best(self.lists[cat], alloc)
        return self._query_spread(cat, alloc)

    @staticmethod
    def _query_best(lst: list, alloc: float):
        """Legacy ``min(cands, key=free - alloc)``: minimal ``free - alloc``
        as a float, then minimal node index. IEEE subtraction by a constant
        is monotone but not injective, so distinct frees can collide on one
        key value: walk the (few) distinct free values whose subtracted key
        still equals the minimum before trusting the index tie-break."""
        p = bisect.bisect_left(lst, (alloc, -1))
        if p == len(lst):
            return None
        f0, i0 = lst[p]
        key = f0 - alloc
        best_idx = i0
        q = bisect.bisect_right(lst, (f0, 1 << 60))
        while q < len(lst):
            f1, i1 = lst[q]
            if f1 - alloc != key:
                break   # monotone: every later free keys strictly higher
            if i1 < best_idx:
                best_idx = i1
            q = bisect.bisect_right(lst, (f1, 1 << 60))
        return (key, best_idx)

    def _query_spread(self, cat, alloc: float):
        """Legacy ``min(cands, key=(cap - (free - alloc)) / cap)``. The key
        is monotone decreasing in free only at fixed capacity, so each
        (category, cap) group contributes its max-free member; across
        groups (and ulp key collisions within one, walked like
        ``_query_best``) the exact float key + node index decide."""
        best = None
        for cap in self.caps_in_cat[cat]:
            lst = self.lists[(cat, cap)]
            if not lst or lst[-1][0] < alloc:
                continue
            p = bisect.bisect_left(lst, (lst[-1][0], -1))
            f0, i0 = lst[p]
            key = (cap - (f0 - alloc)) / cap
            cand_idx = i0
            s = p
            while s > 0:
                f1 = lst[s - 1][0]
                if f1 < alloc:
                    break
                s = bisect.bisect_left(lst, (f1, -1))
                if (cap - (f1 - alloc)) / cap != key:
                    break   # monotone: even-lower frees key strictly higher
                if lst[s][1] < cand_idx:
                    cand_idx = lst[s][1]
            cand = (key, cand_idx)
            if best is None or cand < best:
                best = cand
        return best

    def scan_place(self, i: int, alloc: float) -> None:
        """Provisional in-round placement: the same ``free -= alloc`` the
        legacy scan applied to its local dict. The engine re-syncs the
        node to its exact post-reserve fsum at dispatch."""
        self.set_free(i, self.free[i] - alloc)


@dataclasses.dataclass
class PlacementContext:
    """Everything a placement policy may look at during one round."""
    nodes: list[Node]           # all nodes, up and down
    depth: int                  # backfill skip budget
    eligible: Callable[[TaskInstance, Node], bool]
    priority: Callable[[TaskInstance], int]   # DAG criticality (dependents)
    # attempt token -> (entry, node, attempt start time) of running attempts
    running: dict[int, tuple[_Queued, Node, float]]

    @property
    def up_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.up]


def _scan(queue: list[_Queued], ctx: PlacementContext,
          choose: Callable[[list[Node], dict[str, float], float], Node],
          skip_limit: int) -> list[tuple[_Queued, Node]]:
    """FIFO scan: place each queued task on a node picked by ``choose``
    from the eligible nodes with room.

    The blocking/backfill budget is tracked *per node*: a blocked entry
    counts only against the nodes it is eligible for, and a node "closes"
    once more than ``skip_limit`` earlier entries that wanted it were
    skipped (0 = strict head-of-line blocking per node). On a homogeneous
    cluster every entry is eligible everywhere, so this is exactly the
    classic global skip counter; on a heterogeneous cluster it prevents a
    run of tasks blocked on one saturated node class from starving
    later-queued tasks of an idle class they could never have used anyway.
    """
    up = ctx.up_nodes
    free = {n.name: n.free_gb for n in up}
    blocked = {n.name: 0 for n in up}   # earlier blocked entries per node
    placements: list[tuple[_Queued, Node]] = []
    for entry in queue:
        if all(b > skip_limit for b in blocked.values()):
            break
        # temporal attempts dispatch at their plan's FIRST segment (later
        # segments arrive via RESIZE events); flat attempts at alloc_gb
        alloc = entry.ledger.start_alloc_gb
        elig = [n for n in up if ctx.eligible(entry.task, n)]
        cands = [n for n in elig
                 if free[n.name] >= alloc and blocked[n.name] <= skip_limit]
        if not cands:
            for n in elig:
                blocked[n.name] += 1
            continue
        node = choose(cands, free, alloc)
        free[node.name] -= alloc
        placements.append((entry, node))
    return placements


def _choose_first(cands, free, alloc):
    return cands[0]


def _choose_best_fit(cands, free, alloc):
    """Bin-packing best-fit: tightest remaining free after placement."""
    return min(cands, key=lambda n: free[n.name] - alloc)


def _choose_spread(cands, free, alloc):
    """Memory-aware spread: minimize the node's utilization fraction after
    placement (keeps headroom for retry-ladder doublings everywhere)."""
    return min(cands, key=lambda n: (n.cap_gb - (free[n.name] - alloc))
               / n.cap_gb)


def _place_fifo(queue, ctx):
    """Strict FIFO first-fit: stop at the first task that fits nowhere
    (head-of-line blocking — the behaviour of a plain batch queue)."""
    return _scan(queue, ctx, _choose_first, 0), []


def _place_backfill(queue, ctx):
    """FIFO with backfill: a blocked head does not stall smaller tasks
    behind it; up to ``ctx.depth`` blocked entries are skipped."""
    return _scan(queue, ctx, _choose_first, ctx.depth), []


def _place_best_fit(queue, ctx):
    """Backfill scan placing each task on the node where it leaves the
    least free memory (classic best-fit bin-packing: consolidates load,
    keeps large holes open for large requests)."""
    return _scan(queue, ctx, _choose_best_fit, ctx.depth), []


def _place_spread(queue, ctx):
    """Backfill scan placing each task on the node with the lowest
    utilization after placement (memory-aware spread: balances load, so a
    retry-ladder doubling is least likely to find its node full)."""
    return _scan(queue, ctx, _choose_spread, ctx.depth), []


def _place_preemptive(queue, ctx):
    """Backfill placement plus priority preemption: when the queue head is
    DAG-critical (has downstream dependents) and fits nowhere, evict the
    lowest-priority running attempt whose node (a) is eligible for the
    head and (b) would then fit it. The victim re-enters the queue at its
    original FIFO seq as a non-OOM requeue (interruption accounting). At
    most one eviction per round, and only for a strictly lower-priority
    victim — re-placed victims can therefore never evict the head back
    (no ping-pong livelock)."""
    placements = _scan(queue, ctx, _choose_first, ctx.depth)
    placed = {id(e) for e, _ in placements}
    head = next((e for e in queue if id(e) not in placed), None)
    if head is None:
        return placements, []
    prio = ctx.priority(head.task)
    if prio <= 0:
        return placements, []
    free = {n.name: n.free_gb for n in ctx.up_nodes}
    for e, n in placements:
        free[n.name] -= e.ledger.start_alloc_gb
    alloc = head.ledger.start_alloc_gb
    best = None   # (victim priority, -attempt start) -> token, node
    for token, (entry, node, started) in ctx.running.items():
        if not node.up or not ctx.eligible(head.task, node):
            continue
        vprio = ctx.priority(entry.task)
        if vprio >= prio:
            continue
        # the victim frees what it CURRENTLY holds (post any plan resizes)
        if free[node.name] + node.held_gb(token) < alloc:
            continue
        # prefer the lowest-priority victim; among equals the most recently
        # started one (least partial work burned)
        key = (vprio, -started)
        if best is None or key < best[0]:
            best = (key, token, node)
    if best is None:
        return placements, []
    _, token, node = best
    return placements + [(head, node)], [token]


PLACEMENT_POLICIES = {
    "fifo": _place_fifo,
    "backfill": _place_backfill,
    "best_fit": _place_best_fit,
    "spread": _place_spread,
    "preemptive": _place_preemptive,
}


class ClusterEngine:
    """Stepwise, journal-able form of the event-driven cluster simulator.

    One :meth:`step` is one iteration of the classic simulate-cluster
    loop: drain every event at the next clock value (completions batched
    into one ``complete_batch``), then run one scheduling round (size the
    newly-ready wave, re-size ``retry_scaled`` refreshes, place, dispatch).
    :func:`simulate_cluster` is exactly ``ClusterEngine(...).run()`` — the
    refactor is bitwise-neutral (asserted across the existing suite).

    Durability: pass a :class:`~repro_torch.workflow.journal.Journal` and
    every step appends a WAL record of the method interactions that are
    *not* re-derivable from seeds — the sized/refreshed allocations with
    their in-flight decision blobs, OOM retry allocations (the retry
    ladder reads the pool's mutable ``max_seen_gb``), completion keys and
    the method's counter state — plus a compacted full-state snapshot
    every ``Journal.snapshot_every`` steps. :meth:`recover` rebuilds a
    mid-workflow engine from the journal: restore the last snapshot,
    re-execute the WAL tail in *replay mode* (journaled allocations are
    applied verbatim; completions are NOT re-observed — their provenance
    rows are already in the warm-start prefix), then continue live.

    Resume modes:

      * ``"warm"`` — the journaled finish/resize events of in-flight
        attempts are still in the restored event heap, so execution
        continues exactly where the scheduler died: at a fixed seed the
        final :class:`SimResult` is *bitwise* the uninterrupted run's
        (asserted across kill points in ``tests/test_durability.py``);
      * ``"cold"`` — the crash took the workers with the scheduler: every
        in-flight attempt is interrupted at the recovery clock and
        re-enters the queue through the ``failure_strategy`` machinery
        (checkpoint retention / retry_scaled re-sizing apply to scheduler
        crashes exactly as to node crashes). The re-burned GB·h is what
        ``benchmarks/durability_bench.py`` measures.
    """

    def __init__(self, trace: WorkflowTrace, method: SizingMethod,
                 ttf: float = 1.0, *, n_nodes: int = 8,
                 node_cap_gb: float | None = None,
                 node_specs: Sequence[NodeSpec] | None = None,
                 policy: str = "backfill",
                 backfill_depth: int = 32,
                 fail_rate_per_node_h: float = 0.0,
                 repair_h: float = 1.0,
                 fail_seed: int = 0,
                 rack_fail_rate_per_h: float = 0.0,
                 rack_repair_h: float | dict[str, float] = 2.0,
                 straggler_rate: float = 0.0,
                 straggler_factor: float = 4.0,
                 straggler_seed: int | None = None,
                 journal=None):
        if policy not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement policy {policy!r} "
                             f"(have {sorted(PLACEMENT_POLICIES)})")
        self.place = PLACEMENT_POLICIES[policy]
        self.policy = policy
        self.backfill_depth = backfill_depth
        self.failure_strategy = getattr(method, "failure_strategy",
                                        "retry_same")
        # "auto": the method picks each task's strategy + checkpoint
        # cadence per pool at sizing time (risk-priced methods); choices
        # are journaled per sized task so replay never re-asks the method
        # (its counters sit at kill-time values during replay)
        self.strategy_auto = self.failure_strategy == "auto"
        if self.strategy_auto:
            if not (hasattr(method, "strategy_for")
                    and hasattr(method, "checkpoint_frac_for")):
                raise ValueError(
                    "failure_strategy='auto' needs a method exposing "
                    "strategy_for and checkpoint_frac_for")
        elif self.failure_strategy not in FAILURE_STRATEGIES:
            raise ValueError(f"unknown failure strategy "
                             f"{self.failure_strategy!r} "
                             f"(have {FAILURE_STRATEGIES} + 'auto')")
        self.checkpoint_frac = float(getattr(method, "checkpoint_frac",
                                             DEFAULT_CHECKPOINT_FRAC))
        if straggler_factor < 1.0:
            raise ValueError(f"straggler_factor must be >= 1, "
                             f"got {straggler_factor}")
        if straggler_seed is None:
            straggler_seed = fail_seed
        self.trace = trace
        self.method = method
        self.ttf = ttf
        self.fail_rate_per_node_h = fail_rate_per_node_h
        self.repair_h = repair_h
        self.fail_seed = fail_seed
        self.rack_fail_rate_per_h = rack_fail_rate_per_h
        self.rack_repair_h = rack_repair_h
        self.straggler_rate = straggler_rate
        self.straggler_factor = straggler_factor
        self.straggler_seed = straggler_seed
        if node_specs is None:
            cap = trace.machine_cap_gb if node_cap_gb is None else node_cap_gb
            specs = [NodeSpec(f"node{i:02d}", cap) for i in range(n_nodes)]
        else:
            specs = list(node_specs)
            if not specs:
                raise ValueError("node_specs must name at least one node")
        self.specs = specs
        self.nodes = [Node(s) for s in specs]
        if len({s.name for s in specs}) != len(specs):
            # journal restore and the free-capacity index both key nodes
            # by name/position; duplicates would silently alias
            raise ValueError("node_specs names must be unique")
        for i, n in enumerate(self.nodes):
            n.idx = i
        self.max_cap = max(n.cap_gb for n in self.nodes)
        self.total_cap = sum(n.cap_gb for n in self.nodes)
        self.classes = {n.machine for n in self.nodes
                        if n.machine is not None}
        # indexed placement core (trace-scale refactor): one free-capacity
        # index in the shape the engine's fixed policy queries. Policies
        # added to PLACEMENT_POLICIES from outside fall back to the
        # reference scan over a materialized queue.
        _modes = {"fifo": "first", "backfill": "first",
                  "preemptive": "first", "best_fit": "best",
                  "spread": "spread"}
        self._use_index = policy in _modes
        self._findex = (_FreeIndex(self.nodes, _modes[policy])
                        if self._use_index else None)
        self._cap_cache: dict[str, float] = {}
        self._cats_cache: dict[str, tuple] = {}
        self._node_tokens: list[dict[int, None]] = \
            [{} for _ in self.nodes]
        self.has_batch = hasattr(method, "allocate_batch")
        self.has_plan = hasattr(method, "plan_for")
        self.has_complete_batch = hasattr(method, "complete_batch")
        self.has_note = hasattr(method, "note_interruption")
        self.has_abandon = hasattr(method, "abandon")
        # quality telemetry (repro_torch.obs.quality): stamp the method
        # with the virtual clock before each live completion wave so its
        # quality rows carry engine time. Replay never calls it — replayed
        # completions were observed before the crash and their rows sit in
        # the warm-start prefix.
        self.has_note_clock = hasattr(method, "note_clock")
        # risk pricing (repro_torch.core.risk): feed the method the live
        # sizing pressure at each scheduling round. Pressure is a pure function
        # of engine state, so a repair-re-executed round samples the
        # identical value; replay skips the call (journaled allocations
        # are applied verbatim).
        self.has_note_pressure = hasattr(method, "note_pressure")
        # durability protocol (optional; see SizeyMethod): without the
        # hooks, journal replay still re-applies the recorded allocations
        # but cannot restore in-flight decision state — best-effort only
        self.has_export_state = hasattr(method, "export_state")
        self.has_restore_state = hasattr(method, "restore_state")
        self.has_export_pending = hasattr(method, "export_pending")
        self.has_restore_pending = hasattr(method, "restore_pending")
        self.rack_names = sorted({s.rack for s in specs
                                  if s.rack is not None})
        self.rack_members = {r: [i for i, s in enumerate(specs)
                                 if s.rack == r] for r in self.rack_names}
        if rack_fail_rate_per_h > 0.0 and not self.rack_names:
            raise ValueError("rack_fail_rate_per_h > 0 needs rack-labeled "
                             "node_specs (node_specs_from_caps(n_racks=...) "
                             "or node_specs_from_racks)")

        self.by_key = {t.key: t for t in trace.tasks}
        if len(self.by_key) != len(trace.tasks):
            raise ValueError("duplicate (task_type, index) keys in trace")
        self.indeg: dict[tuple[str, int], int] = {}
        self.children: dict[tuple[str, int], list[TaskInstance]] = \
            collections.defaultdict(list)
        for t in trace.tasks:
            live = [d for d in t.deps if d in self.by_key]
            self.indeg[t.key] = len(live)
            for d in live:
                self.children[d].append(t)

        self.events: list[tuple[float, int, int, object]] = []
        self._eseq = 0
        self.pending_arrivals = 0
        # deterministic work counters (trace-scale refactor): how much the
        # event loop actually did, independent of wall clock — the
        # regression gate pins these at zero growth so an accidental
        # re-introduction of a full rescan fails CI even on fast hardware
        self.n_events = 0          # events drained off the heap
        self.n_scan_entries = 0    # queue entries examined by placement
        self.n_heap_pushes = 0     # event-heap insertions
        for t in trace.tasks:
            if self.indeg[t.key] == 0:
                self._push((t.arrival_h, self._next_eseq(), _ARRIVE, t))
                self.pending_arrivals += 1

        # deterministic seeded failure schedule: one generator per node,
        # drawn lazily (crash -> recover -> next crash), independent of
        # event interleaving so runs are bit-reproducible. Generator
        # STATES serialize into snapshots (bit_generator.state), so a
        # recovered engine re-draws the identical schedule suffix.
        self.fail_rngs = [np.random.default_rng([fail_seed, i])
                          for i in range(len(self.nodes))]
        if fail_rate_per_node_h > 0.0:
            for i in range(len(self.nodes)):
                t_crash = float(self.fail_rngs[i].exponential(
                    1.0 / fail_rate_per_node_h))
                self._push((t_crash, self._next_eseq(), _CRASH, i))
        # rack outages draw from their own per-rack streams (3-element
        # seed sequences: disjoint from the 2-element per-node streams
        # above, so adding rack injection never perturbs node schedules)
        self.rack_rngs = {r: np.random.default_rng([fail_seed, 7919, ri])
                          for ri, r in enumerate(self.rack_names)}
        if rack_fail_rate_per_h > 0.0:
            for r in self.rack_names:
                t_crash = float(self.rack_rngs[r].exponential(
                    1.0 / rack_fail_rate_per_h))
                self._push((t_crash, self._next_eseq(), _RACK_CRASH, r))

        self.queue = _SeqQueue()
        self._pending_unsized: list[_Queued] = []
        self._refresh_dirty = False
        # per-task (strategy, checkpoint_frac) choices of the LAST sized
        # wave (failure_strategy="auto" only; None otherwise)
        self._wave_strategies: list[tuple[str, float]] | None = None
        self._qseq = 0
        self._atok = 0   # attempt tokens (reservation + finish ids)
        self._dtok = 0   # crash-ownership tokens: a recover event only
        # brings a node back if it still owns the downing (rack outages
        # and independent faults can overlap on one node)
        self.down_token: dict[int, int] = {}
        self.down_due: dict[int, float] = {}
        self.running: dict[int, tuple[_Queued, Node, float]] = {}
        self.outcomes: list[TaskOutcome] = []
        self.delays: list[float] = []   # delays of *dispatched* tasks only
        self.clock = self.total_reserved = self.peak_reserved = 0.0
        self.n_waves = self.n_size_calls = self.n_aborted = 0
        self.n_preemptions = self.n_node_failures = 0
        self.n_resizes = self.n_grow_failures = self.n_complete_waves = 0
        self.n_resize_waves = 0
        self.n_failure_events = self.n_rack_failures = 0
        self.n_straggler_attempts = 0
        self.straggler_extra_h = 0.0
        self.rack_outage_node_h = {r: 0.0 for r in self.rack_names}
        self.warned_admission = False
        self.n_recoveries = 0
        self.n_replayed_steps = 0

        # durability plumbing
        self._config = {
            "ttf": ttf, "n_nodes": n_nodes, "node_cap_gb": node_cap_gb,
            "node_specs": ([dataclasses.asdict(s) for s in node_specs]
                           if node_specs is not None else None),
            "policy": policy, "backfill_depth": backfill_depth,
            "fail_rate_per_node_h": fail_rate_per_node_h,
            "repair_h": repair_h, "fail_seed": fail_seed,
            "rack_fail_rate_per_h": rack_fail_rate_per_h,
            "rack_repair_h": rack_repair_h,
            "straggler_rate": straggler_rate,
            "straggler_factor": straggler_factor,
            "straggler_seed": straggler_seed,
        }
        self._journal = None
        self._jrec: dict | None = None     # WAL record of the LIVE step
        self._replay: collections.deque | None = None
        self._step_idx = 0
        self._ended = False
        if journal is not None:
            self._attach_journal(journal)

    # ------------------------------------------------------------ counters
    def _next_eseq(self) -> int:
        v = self._eseq
        self._eseq += 1
        return v

    def _next_qseq(self) -> int:
        v = self._qseq
        self._qseq += 1
        return v

    def _next_atok(self) -> int:
        v = self._atok
        self._atok += 1
        return v

    def _next_dtok(self) -> int:
        v = self._dtok
        self._dtok += 1
        return v

    def _push(self, ev: tuple[float, int, int, object]) -> None:
        self.n_heap_pushes += 1
        heapq.heappush(self.events, ev)

    def _sync_node(self, node: Node) -> None:
        """Re-mirror one node in the free-capacity index after an
        authoritative reservation change."""
        if self._findex is not None:
            self._findex.sync(node)

    # ------------------------------------------------------------- helpers
    def _rack_repair_of(self, rack: str) -> float:
        if isinstance(self.rack_repair_h, dict):
            try:
                return float(self.rack_repair_h[rack])
            except KeyError:
                raise ValueError(f"rack_repair_h names no repair time for "
                                 f"rack {rack!r}") from None
        return float(self.rack_repair_h)

    def _eligible(self, task: TaskInstance, node: Node) -> bool:
        # unlabeled nodes take anything; a task whose machine label names
        # no node class carries no affinity information (homogeneous
        # traces keep running anywhere on a labeled cluster)
        return (node.machine is None or task.machine == node.machine
                or task.machine not in self.classes)

    def _cap_for(self, task: TaskInstance) -> float:
        """Largest node this task could ever be placed on: the clamp/abort
        capacity of its ledger. 0.0 when no node is eligible (the request
        is then admission-rejected whatever its size). Eligibility depends
        only on the task's machine label and the STATIC node specs (down
        nodes stay eligible), so the answer is cached per label."""
        cap = self._cap_cache.get(task.machine)
        if cap is None:
            cap = max((n.cap_gb for n in self.nodes
                       if self._eligible(task, n)), default=0.0)
            self._cap_cache[task.machine] = cap
        return cap

    def _cats_for(self, label: str) -> tuple:
        """Node categories (machine labels, None = unlabeled) a task with
        this machine label may place on — the category form of
        :meth:`_eligible`, cached per label."""
        cats = self._cats_cache.get(label)
        if cats is None:
            fx = self._findex
            if label in self.classes:
                cats = tuple(c for c in fx.cats
                             if c is None or c == label)
            else:
                cats = tuple(fx.cats)
            self._cats_cache[label] = cats
        return cats

    def _priority(self, task: TaskInstance) -> int:
        """DAG criticality: how many instances this one gates."""
        return len(self.children.get(task.key, ()))

    def _jev(self, *row) -> None:
        """Append one transition to the live step's WAL record (pure
        observability: replay derives transitions from the event stream)."""
        if self._jrec is not None:
            self._jrec["ev"].append(list(row))

    def _unlock_children(self, key: tuple[str, int], t: float) -> None:
        for child in self.children[key]:
            self.indeg[child.key] -= 1
            if self.indeg[child.key] == 0:
                self._push((max(t, child.arrival_h), self._next_eseq(),
                            _ARRIVE, child))
                self.pending_arrivals += 1

    def _finish_aborted(self, entry: _Queued, t: float) -> None:
        if self.has_abandon:
            self.method.abandon(entry.task)
        self.outcomes.append(entry.ledger.outcome(
            submit_h=entry.ready_h,
            start_h=entry.start_h if entry.start_h is not None else t,
            finish_h=t))
        self.n_aborted += 1
        self._jev("abort", list(entry.task.key))
        if entry.start_h is not None:
            self.delays.append(entry.start_h - entry.ready_h)
        # an abort does not fail the subtree: dependents still execute, so
        # every instance of the trace gets an outcome (serial semantics)
        self._unlock_children(entry.task.key, t)

    def pressure(self) -> float:
        """Live sizing pressure in [0, 1]: the larger of memory pressure
        (reserved over total capacity) and queue backlog (queued entries
        per node, saturating at 1). A pure function of engine state —
        identical live, on a repair-re-executed round, and after a warm
        resume — so risk-priced methods can consume it without breaking
        the bitwise-recovery contract."""
        mem = (self.total_reserved / self.total_cap
               if self.total_cap > 0 else 0.0)
        backlog = min(1.0, len(self.queue) / max(len(self.nodes), 1))
        return max(mem, backlog)

    def _note_straggle(self, led: AttemptLedger, elapsed_h: float) -> None:
        """Straggler overhead actually incurred: the extra wall time of
        the ``elapsed_h`` the attempt really ran (a killed straggler is
        charged only its elapsed stretch, not the planned one)."""
        if led.slowdown > 1.0:
            self.straggler_extra_h += elapsed_h * (1.0 - 1.0 / led.slowdown)

    def _interrupt(self, token: int, t: float) -> None:
        """Kill a running attempt (crash or preemption): burn the partial
        reservation per the failure strategy, requeue at the original FIFO
        seq — no OOM failure. ``retry_scaled`` marks the entry for a fresh
        sizing pass before re-dispatch; crash-aware methods observe the
        interruption through ``note_interruption`` (live mode only —
        replayed interruptions were already observed, and the method's
        counters restore from the journaled state)."""
        entry, node, started = self.running.pop(token)
        self._node_tokens[node.idx].pop(token, None)
        gb = node.release(t, token)
        self._sync_node(node)
        self.total_reserved -= gb
        self._note_straggle(entry.ledger, t - started)
        entry.ledger.record_interruption(t - started)
        # per-LEDGER strategy: under failure_strategy="auto" each task
        # carries its own (journaled) choice, so the refresh decision
        # reads the ledger, not the engine-level default
        if entry.ledger.failure_strategy == "retry_scaled":
            entry.ledger.refresh_pending = True
            self._refresh_dirty = True
        if self.has_note and self._replay is None:
            self.method.note_interruption(entry.task, t - started)
        self._jev("interrupt", list(entry.task.key))
        self.queue.requeue(entry)   # keeps its original FIFO seq

    def _crash_node(self, idx: int, t: float, due: float) -> int:
        """Down one node (if up) until ``due``: interrupt its attempts,
        take a crash-ownership token. Returns the token, or -1 if the
        node was already down (an overlapping outage absorbed the
        fault — the caller decides whether it extends the downtime)."""
        node = self.nodes[idx]
        if not node.up:
            return -1
        token = self._next_dtok()
        self.down_token[idx] = token
        self.down_due[idx] = due
        node.crash(t)
        if self._findex is not None:
            self._findex.set_down(idx)
        self.n_node_failures += 1
        self._jev("crash", node.name)
        # the per-node token index replaces the legacy full rescan of
        # self.running; insertion order (= dispatch order) is preserved
        for atok_ in list(self._node_tokens[idx]):
            self._interrupt(atok_, t)
        return token

    def _recover_node(self, idx: int, token: int, t: float) -> bool:
        """Bring a node back iff ``token`` still owns its downing."""
        if self.down_token.get(idx) != token:
            return False
        del self.down_token[idx]
        self.down_due.pop(idx, None)
        self.nodes[idx].recover(t)
        if self._findex is not None:
            self._findex.set_up(idx)
        self._jev("recover", self.nodes[idx].name)
        return True

    # -------------------------------------------------------- resize wave
    def _apply_resize_wave(self, clock: float,
                           wave: list[tuple[int, int]]) -> None:
        """Apply a coalesced run of same-clock ``_RESIZE`` events, in pop
        order. Per-event semantics are unchanged (grow checks see every
        earlier member's effect on ``free_gb``, grow failures requeue at
        the original seq), so journals replay bitwise; the wave only
        amortizes the event-loop dispatch and, via the node's zero-``dt``
        ``_advance`` fast path, the per-resize reservation fsum."""
        self.n_resize_waves += 1
        with _span("engine/resize_wave", n=len(wave)):
            self._apply_resize_wave_inner(clock, wave)

    def _apply_resize_wave_inner(self, clock: float,
                                 wave: list[tuple[int, int]]) -> None:
        for token, seg_idx in wave:
            if token not in self.running:
                continue   # attempt already killed/grow-flattened
            entry, node, started = self.running[token]
            led = entry.ledger
            if not led.temporal_active \
                    or seg_idx >= len(led.plan.segments):
                continue   # plan flattened since scheduling
            new_gb = led.plan.segments[seg_idx][1]
            delta = new_gb - node.held_gb(token)
            if delta <= 0 or node.free_gb >= delta - 1e-9:
                self.total_reserved += node.resize(clock, token, new_gb)
                self._sync_node(node)
                self.peak_reserved = max(self.peak_reserved,
                                         self.total_reserved)
                self.n_resizes += 1
                self._jev("resize", list(entry.task.key), new_gb)
            else:
                # grow failure: node too full at the boundary — burn the
                # partial plan integral (interruption, no OOM accounting)
                # and requeue at the original seq; repeated denials
                # flatten the plan to a constant peak reservation
                # (guaranteed progress)
                self.n_grow_failures += 1
                self.running.pop(token)
                self._node_tokens[node.idx].pop(token, None)
                gb = node.release(clock, token)
                self._sync_node(node)
                self.total_reserved -= gb
                self._note_straggle(led, clock - started)
                led.record_grow_failure(clock - started)
                self._jev("grow_denied", list(entry.task.key))
                self.queue.requeue(entry)

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """Advance the engine by one event-drain + scheduling round.
        Returns False (and journals the run's ``end`` marker) once every
        task has an outcome."""
        if not self.queue and not self.running \
                and self.pending_arrivals == 0:
            self._finish_journal()
            return False   # all outcomes recorded (or DAG unsatisfiable)
        rec = None
        if self._replay is not None:
            rec = self._replay.popleft()
            if rec["step"] != self._step_idx:
                raise RuntimeError(
                    f"journal divergence: engine at step {self._step_idx}, "
                    f"journal record is step {rec['step']}")
        jrec = None
        if self._journal is not None and rec is None:
            jrec = {"rec": "step", "step": self._step_idx, "ev": [],
                    "sized": [], "refresh": [], "retries": [], "done": []}
        self._jrec = jrec
        replay_retries = (collections.deque(rec["retries"])
                          if rec is not None else None)
        method = self.method
        events = self.events
        arrived: list[_Queued] = []
        if events:
            self.clock = events[0][0]
            clock = self.clock
            completed: list[tuple[_Queued, float]] = []
            while events and events[0][0] <= clock:
                _, _, kind, payload = heapq.heappop(events)
                self.n_events += 1
                if kind == _ARRIVE:
                    self.pending_arrivals -= 1
                    entry = _Queued(self._next_qseq(), clock, payload)
                    self.queue.push(entry)
                    arrived.append(entry)
                    self._jev("arrive", list(payload.key))
                    continue
                if kind == _RESIZE:
                    # drain the whole same-clock run of RESIZE events into
                    # one wave (the complete_batch pattern): a scheduling
                    # wave's segment boundaries land at identical clocks
                    # with consecutive event seqs, so the run is applied
                    # in exactly pop order — bitwise the per-event path,
                    # paying the drain dispatch once per wave
                    wave = [payload]
                    while events and events[0][0] <= clock \
                            and events[0][2] == _RESIZE:
                        wave.append(heapq.heappop(events)[3])
                        self.n_events += 1
                    self._apply_resize_wave(clock, wave)
                    continue
                if kind == _CRASH:
                    self.n_failure_events += 1
                    node_due = clock + self.repair_h
                    token = self._crash_node(payload, clock, node_due)
                    if token < 0 \
                            and node_due > self.down_due[payload] + 1e-12:
                        # already down (rack outage) but THIS fault
                        # repairs later: take ownership so the node stays
                        # down past the rack recover — symmetric with the
                        # rack-takeover branch below ("latest due wins")
                        token = self._next_dtok()
                        self.down_token[payload] = token
                        self.down_due[payload] = node_due
                    if token >= 0:
                        self._push((node_due, self._next_eseq(),
                                    _RECOVER, (payload, token)))
                    elif self.pending_arrivals or self.queue \
                            or self.running:
                        # absorbed outright (the rack outage outlasts the
                        # fault): keep the node's crash stream alive
                        nxt = clock + float(
                            self.fail_rngs[payload].exponential(
                                1.0 / self.fail_rate_per_node_h))
                        self._push((nxt, self._next_eseq(),
                                    _CRASH, payload))
                    continue
                if kind == _RECOVER:
                    idx, token = payload
                    # the recovery is a no-op when a later rack outage
                    # took ownership of the downing (the node then stays
                    # down until the RACK recovers), but the node's crash
                    # stream continues either way
                    self._recover_node(idx, token, clock)
                    if self.pending_arrivals or self.queue or self.running:
                        nxt = clock + float(
                            self.fail_rngs[idx].exponential(
                                1.0 / self.fail_rate_per_node_h))
                        self._push((nxt, self._next_eseq(), _CRASH, idx))
                    continue
                if kind == _RACK_CRASH:
                    # correlated outage: every node of the rack is down
                    # until the rack repairs — ONE failure event, N node
                    # failures. A member already down from an independent
                    # fault is taken over only when the rack repairs
                    # LATER (its own recover goes stale and it comes back
                    # with the rack); a fault outlasting the outage keeps
                    # the node down past the rack repair — a node always
                    # returns at the latest due among its outages
                    self.n_failure_events += 1
                    self.n_rack_failures += 1
                    rack_due = clock + self._rack_repair_of(payload)
                    self._jev("rack_crash", payload)
                    # downed: (node idx, ownership token, time from which
                    # the downtime is ATTRIBUTABLE to this rack outage)
                    downed = []
                    for idx in self.rack_members[payload]:
                        token = self._crash_node(idx, clock, rack_due)
                        if token >= 0:
                            downed.append((idx, token, clock))
                        elif rack_due > self.down_due[idx] + 1e-12:
                            token = self._next_dtok()
                            attrib_from = self.down_due[idx]
                            self.down_token[idx] = token
                            self.down_due[idx] = rack_due
                            downed.append((idx, token, attrib_from))
                    self._push((rack_due, self._next_eseq(),
                                _RACK_RECOVER, (payload, downed)))
                    continue
                if kind == _RACK_RECOVER:
                    rack, downed = payload
                    for idx, token, attrib_from in downed:
                        self._recover_node(idx, token, clock)
                        # rack-ATTRIBUTED downtime: the MARGINAL node-
                        # hours this outage added (a taken-over member
                        # counts only the extension past its own repair)
                        self.rack_outage_node_h[rack] += clock - attrib_from
                    if self.pending_arrivals or self.queue or self.running:
                        nxt = clock + float(
                            self.rack_rngs[rack].exponential(
                                1.0 / self.rack_fail_rate_per_h))
                        self._push((nxt, self._next_eseq(),
                                    _RACK_CRASH, rack))
                    continue
                if payload not in self.running:
                    continue   # attempt was preempted / crash-killed
                entry, node, started = self.running.pop(payload)
                self._node_tokens[node.idx].pop(payload, None)
                gb = node.release(clock, payload)
                self._sync_node(node)
                self.total_reserved -= gb
                self._note_straggle(entry.ledger, clock - started)
                if entry.ledger.will_succeed:
                    entry.ledger.record_success()
                    self.outcomes.append(entry.ledger.outcome(
                        submit_h=entry.ready_h, start_h=entry.start_h,
                        finish_h=clock))
                    self.delays.append(entry.start_h - entry.ready_h)
                    self._unlock_children(entry.task.key, clock)
                    # model updates are flushed per drain: simultaneous
                    # completions become ONE complete_batch call (one
                    # fused observe dispatch per pool) below
                    completed.append((entry, clock))
                elif entry.ledger.record_failure():
                    self._finish_aborted(entry, clock)
                else:
                    # the retry ladder reads mutable predictor state
                    # (pool max_seen_gb), so replay applies the JOURNALED
                    # allocation instead of re-asking the method
                    if rec is not None:
                        if not replay_retries:
                            raise RuntimeError("journal divergence: "
                                               "unjournaled OOM retry")
                        rkey, ralloc = replay_retries.popleft()
                        if tuple(rkey) != entry.task.key:
                            raise RuntimeError(
                                f"journal divergence: retry of "
                                f"{entry.task.key}, journal has {rkey}")
                        entry.ledger.apply_retry_alloc(ralloc)
                    else:
                        entry.ledger.apply_retry(method)
                        if jrec is not None:
                            jrec["retries"].append(
                                [list(entry.task.key),
                                 entry.ledger.alloc_gb])
                    self.queue.requeue(entry)   # original FIFO seq
            if completed:
                self.n_complete_waves += 1
                items = [(e.task, e.ledger.first_alloc_gb,
                          e.ledger.attempts) for e, _ in completed]
                if jrec is not None:
                    jrec["done"] = [list(e.task.key) for e, _ in completed]
                    for e, _ in completed:
                        self._jev("complete", list(e.task.key))
                if rec is not None:
                    # replayed completions were observed before the crash
                    # (their task/log/curve rows are in the warm-start
                    # prefix): just drop the restored in-flight decisions
                    if self.has_abandon:
                        for e, _ in completed:
                            method.abandon(e.task)
                elif self.has_complete_batch:
                    if self.has_note_clock:
                        method.note_clock(clock)
                    with _span("engine/complete_wave", n=len(items)):
                        method.complete_batch(items)
                else:
                    if self.has_note_clock:
                        method.note_clock(clock)
                    with _span("engine/complete_wave", n=len(items)):
                        for task, first_alloc, attempts in items:
                            method.complete(task, first_alloc, attempts)
        elif self.queue:
            # every queued task is sized, admitted (alloc <= its cap), all
            # nodes are up (no recover event pending) and idle — the
            # scheduling round below must place work, so reaching here
            # again without events is an engine bug
            raise RuntimeError("cluster scheduler stalled with "
                               "placeable tasks queued")

        # ----------------------------------------------- scheduling round
        clock = self.clock
        if rec is None and self.has_note_pressure:
            # live steps only: replayed waves re-apply journaled
            # allocations, and a repair-re-executed round recomputes the
            # identical sample from the restored engine state
            method.note_pressure(self.pressure())
        # the queue is permanently seq-sorted (_SeqQueue), so the unsized
        # wave is exactly this drain's arrivals (plus, defensively, any
        # unsized entries a restored snapshot carried) in seq order —
        # the legacy sort + full-queue filter, without the O(Q) pass
        if self._pending_unsized:
            unsized = self._pending_unsized + arrived
            self._pending_unsized = []
        else:
            unsized = arrived
        if unsized:
            # dynamic ready-set burst: one sizing call for the whole wave
            # (one fused device dispatch per pool for batched methods)
            self.n_waves += 1
            allocs = self._wave_allocs(rec, jrec, "sized", unsized)
            strategies = self._wave_strategies
            self._wave_strategies = None
            for i, (entry, alloc) in enumerate(zip(unsized, allocs)):
                if strategies is not None:
                    strat, cfrac = strategies[i]
                else:
                    strat, cfrac = self.failure_strategy, \
                        self.checkpoint_frac
                entry.ledger = AttemptLedger(
                    entry.task, float(alloc), self._cap_for(entry.task),
                    self.ttf, failure_strategy=strat,
                    checkpoint_frac=cfrac)
                if self.has_plan:
                    # temporal reservation schedule for the first attempt
                    # (set_plan drops 1-segment plans onto the flat path)
                    plan = method.plan_for(entry.task)
                    if plan is not None:
                        entry.ledger.set_plan(
                            plan.clamped(entry.ledger.cap_gb))
                if entry.ledger.alloc_gb > entry.ledger.cap_gb:
                    # no node can ever satisfy the request: reject at
                    # admission (it would otherwise head-of-line block)
                    if (not self.warned_admission
                            and entry.ledger.alloc_gb
                            <= self.trace.machine_cap_gb):
                        # the method sized for the trace's machine cap but
                        # every eligible node is smaller: almost always a
                        # trace/node-set mismatch, so be loud about it
                        warnings.warn(
                            f"admission-rejecting a "
                            f"{entry.ledger.alloc_gb:.1f} GB request that "
                            f"fits the trace's machine cap "
                            f"({self.trace.machine_cap_gb:g} GB) but not "
                            f"the largest eligible node "
                            f"({entry.ledger.cap_gb:g} GB); generate the "
                            f"trace with machine_caps_gb matching the node "
                            f"classes, or raise node capacities",
                            RuntimeWarning, stacklevel=2)
                        self.warned_admission = True
                    entry.ledger.aborted = True
                    self._finish_aborted(entry, clock)
                    self.queue.discard(entry)
        if self._refresh_dirty:
            # crash-interrupted tasks are re-sized through the method (one
            # batched dispatch when available) before re-entering
            # placement: a tightened prediction shrinks what the next
            # crash can burn. The dirty flag (set by _interrupt) skips the
            # full-queue filter on the steps — the vast majority — where
            # no interruption is pending
            refresh = [e for e in self.queue
                       if e.ledger is not None
                       and e.ledger.refresh_pending]
            if refresh:
                rallocs = self._wave_allocs(rec, jrec, "refresh", refresh)
                for entry, alloc in zip(refresh, rallocs):
                    entry.ledger.refresh_alloc(float(alloc))
            self._refresh_dirty = False
        if self._use_index:
            placements, evictions = self._place_indexed()
        else:
            ctx = PlacementContext(self.nodes, self.backfill_depth,
                                   self._eligible, self._priority,
                                   self.running)
            placements, evictions = self.place(list(self.queue), ctx)
        for token in evictions:
            self.n_preemptions += 1
            self._interrupt(token, clock)
        if placements:
            for entry, _node in placements:
                self.queue.discard(entry)
            for entry, node in placements:
                led = entry.ledger
                alloc = led.start_alloc_gb
                token = self._next_atok()
                node.reserve(clock, token, alloc)
                self._sync_node(node)
                self.running[token] = (entry, node, clock)
                self._node_tokens[node.idx][token] = None
                self.total_reserved += alloc
                self.peak_reserved = max(self.peak_reserved,
                                         self.total_reserved)
                if entry.start_h is None:
                    entry.start_h = clock
                self._jev("dispatch", list(entry.task.key), node.name,
                          alloc)
                if self.straggler_rate > 0.0:
                    # per-attempt straggler draw keyed by (task, dispatch#)
                    # so the schedule replays bit-identically whatever the
                    # event interleaving; re-dispatches re-draw
                    entry.n_dispatches += 1
                    if entry.task_hash is None:
                        entry.task_hash = stable_hash(
                            f"{entry.task.task_type}"
                            f":{entry.task.index}") % (2 ** 31)
                    srng = np.random.default_rng(
                        [self.straggler_seed, entry.task_hash,
                         entry.n_dispatches])
                    if float(srng.random()) < self.straggler_rate:
                        led.set_slowdown(1.0 + float(srng.exponential(
                            max(self.straggler_factor - 1.0, 1e-9))))
                        self.n_straggler_attempts += 1
                    else:
                        led.set_slowdown(1.0)
                duration = led.attempt_duration_h
                self._push((clock + duration, self._next_eseq(),
                            _FINISH, token))
                if led.temporal_active:
                    # resize at every predicted segment boundary the
                    # attempt survives to (a doomed plan dies at its
                    # violation time; later boundaries never happen).
                    # Boundaries live in nominal-runtime fractions, so a
                    # straggler's stretch moves them in wall time too; a
                    # checkpoint-retained plan resumes mid-schedule, so
                    # only boundaries PAST the resume point are scheduled,
                    # offset by the completed prefix
                    vf = led.violation_frac
                    horizon = 1.0 if vf is None else vf
                    base = led.completed_frac
                    for si, (end, _gb) in \
                            enumerate(led.plan.segments[:-1]):
                        if end <= base + 1e-12:
                            continue   # boundary precedes the resume point
                        if end < horizon - 1e-12:
                            self._push(
                                (clock + (end - base) * led.task.runtime_h
                                 * led.slowdown,
                                 self._next_eseq(), _RESIZE,
                                 (token, si + 1)))

        self._step_idx += 1
        self._jrec = None
        if jrec is not None:
            jrec["clock"] = self.clock
            if self.has_export_state:
                jrec["mstate"] = method.export_state()
            self._journal.append_step(jrec)
            self._journal.maybe_snapshot(self._step_idx, self.export_state)
        if rec is not None:
            if replay_retries:
                raise RuntimeError("journal divergence: journaled retries "
                                   "the replayed drain never consumed")
            if not self._replay:
                self._replay = None   # tail consumed -> back to live mode
        return True

    def _place_indexed(self) -> tuple[list[tuple[_Queued, Node]],
                                      list[int]]:
        """Indexed form of the built-in placement policies: semantically
        (and bitwise) the reference ``_scan``/``_place_*`` path, with the
        per-round O(nodes) free/blocked dict builds and per-entry O(nodes)
        candidate comprehensions replaced by per-category index queries.

        The reference scan's per-node blocked counters and eligibility both
        depend only on a node's category (machine label), so one counter
        per category reproduces every skip/close decision, and a category
        query returns exactly the node the reference ``choose`` picks
        (``_FreeIndex.query`` tuples encode each policy's key + the
        node-order tie-break). Entries are examined in the same seq order,
        the scan breaks on the same all-categories-closed condition, and
        in-round free decrements use the same float arithmetic — asserted
        bitwise against the reference path in ``tests/test_engine_index``.
        """
        fx = self._findex
        limit = 0 if self.policy == "fifo" else self.backfill_depth
        bc = dict.fromkeys(fx.cats, 0)
        n_open = sum(1 for c in fx.cats if fx.up_count[c] > 0)
        placements: list[tuple[_Queued, Node]] = []
        placed_ids = set()
        for entry in self.queue:
            if n_open == 0:
                break
            self.n_scan_entries += 1
            alloc = entry.ledger.start_alloc_gb
            cats = self._cats_for(entry.task.machine)
            best = None
            for c in cats:
                if bc[c] > limit:
                    continue
                r = fx.query(c, alloc)
                if r is not None and (best is None or r < best):
                    best = r
            if best is None:
                # blocked: counts against every category the entry was
                # eligible for (the reference bumps each eligible node)
                for c in cats:
                    bc[c] += 1
                    if bc[c] == limit + 1 and fx.up_count[c] > 0:
                        n_open -= 1
                continue
            i = best[-1]
            fx.scan_place(i, alloc)
            placements.append((entry, self.nodes[i]))
            placed_ids.add(id(entry))
        if self.policy != "preemptive":
            return placements, []
        head = next((e for e in self.queue if id(e) not in placed_ids),
                    None)
        if head is None:
            return placements, []
        prio = self._priority(head.task)
        if prio <= 0:
            return placements, []
        alloc = head.ledger.start_alloc_gb
        best = None   # (victim priority, -attempt start) -> token, node
        for token, (entry, node, started) in self.running.items():
            if not node.up or not self._eligible(head.task, node):
                continue
            vprio = self._priority(entry.task)
            if vprio >= prio:
                continue
            # fx.free carries this round's provisional placements — the
            # reference's placement-adjusted free dict
            if fx.free[node.idx] + node.held_gb(token) < alloc:
                continue
            key = (vprio, -started)
            if best is None or key < best[0]:
                best = (key, token, node)
        if best is None:
            return placements, []
        _, token, node = best
        return placements + [(head, node)], [token]

    def _wave_allocs(self, rec, jrec, field: str,
                     wave: list[_Queued]) -> list[float]:
        """Size one wave (ready burst or retry_scaled refresh): live mode
        asks the method (journaling the allocations + in-flight decision
        blobs), replay mode re-applies the journaled wave verbatim —
        including restoring each task's decision blob, so later retries /
        completions of the attempt see the decision it was sized with.

        Under ``failure_strategy="auto"`` a "sized" wave also records
        each task's (strategy, checkpoint_frac) choice — asked of the
        method live (elements 3-4 of the journal entry), read back at
        replay: the method's crash counters sit at kill-time values
        during replay, so re-asking would diverge. The aligned choices
        are handed to the caller through ``self._wave_strategies``."""
        method = self.method
        auto = self.strategy_auto and field == "sized"
        self._wave_strategies = None
        if rec is not None:
            js = rec[field]
            if [list(e.task.key) for e in wave] != [s[0] for s in js]:
                raise RuntimeError(f"journal divergence: {field} wave "
                                   f"keys do not match the journal")
            self.n_size_calls += 1 if self.has_batch else len(wave)
            if self.has_restore_pending:
                for e, s in zip(wave, js):
                    if s[2] is not None:
                        method.restore_pending(e.task, s[2])
            if auto:
                if any(len(s) < 5 for s in js):
                    raise RuntimeError(
                        "journal divergence: failure_strategy='auto' "
                        "engine replaying a journal without per-task "
                        "strategy choices")
                self._wave_strategies = [(s[3], float(s[4])) for s in js]
            return [s[1] for s in js]
        with _span("engine/sizing_wave", kind=field, n=len(wave)):
            if self.has_batch:
                self.n_size_calls += 1
                allocs = method.allocate_batch([e.task for e in wave])
            else:
                self.n_size_calls += len(wave)
                allocs = [method.allocate(e.task) for e in wave]
        if auto:
            # asked AFTER sizing so the method can read each task's
            # fresh in-flight decision (per-pool RAQ trust)
            self._wave_strategies = [
                (method.strategy_for(e.task),
                 float(method.checkpoint_frac_for(e.task)))
                for e in wave]
        if jrec is not None:
            jrec[field] = [
                [list(e.task.key), float(a),
                 (method.export_pending(e.task)
                  if self.has_export_pending else None)]
                for e, a in zip(wave, allocs)]
            if auto:
                for s, (strat, cfrac) in zip(jrec[field],
                                             self._wave_strategies):
                    s.extend([strat, cfrac])
        return allocs

    # ----------------------------------------------------------- lifecycle
    def run(self) -> SimResult:
        """Drive :meth:`step` to quiescence and return :meth:`result`.

        Fully deterministic: every arrival, crash, straggler stretch and
        rng draw derives from named seeds, so two runs of the same
        (trace, method, config) — or a journaled run resumed after a
        kill at any byte — produce bitwise-identical results."""
        while self.step():
            pass
        return self.result()

    def result(self) -> SimResult:
        """Materialize the final :class:`SimResult`: outcomes in
        completion order plus cluster metrics (makespan, queueing delay,
        per-node/class utilization, failure and recovery counters)."""
        makespan = self.clock
        by_class: dict[str, list[Node]] = collections.defaultdict(list)
        for node in self.nodes:
            node._advance(makespan)
            by_class[node.machine or _DEFAULT_CLASS].append(node)
        class_util = {
            cls: (sum(n.reserved_gbh for n in grp)
                  / (sum(n.cap_gb for n in grp) * makespan)
                  if makespan > 0 else 0.0)
            for cls, grp in sorted(by_class.items())
        }
        metrics = ClusterMetrics(
            n_nodes=len(self.nodes), node_cap_gb=self.max_cap,
            makespan_h=makespan,
            mean_queue_delay_h=(sum(self.delays) / len(self.delays)
                                if self.delays else 0.0),
            max_queue_delay_h=max(self.delays, default=0.0),
            node_util={n.name: (n.reserved_gbh / (n.cap_gb * makespan)
                                if makespan > 0 else 0.0)
                       for n in self.nodes},
            peak_reserved_gb=self.peak_reserved, n_waves=self.n_waves,
            n_size_calls=self.n_size_calls, policy=self.policy,
            node_caps_gb={n.name: n.cap_gb for n in self.nodes},
            class_util=class_util, n_aborted=self.n_aborted,
            n_preemptions=self.n_preemptions,
            n_node_failures=self.n_node_failures,
            node_downtime_h={n.name: n.down_h for n in self.nodes},
            n_resizes=self.n_resizes,
            n_resize_waves=self.n_resize_waves,
            n_grow_failures=self.n_grow_failures,
            n_complete_waves=self.n_complete_waves,
            failure_strategy=self.failure_strategy,
            n_failure_events=self.n_failure_events,
            n_rack_failures=self.n_rack_failures,
            n_straggler_attempts=self.n_straggler_attempts,
            straggler_extra_h=self.straggler_extra_h,
            rack_downtime_h=dict(self.rack_outage_node_h),
            n_recoveries=self.n_recoveries,
            n_replayed_steps=self.n_replayed_steps,
            n_events=self.n_events,
            n_scan_entries=self.n_scan_entries,
            n_heap_pushes=self.n_heap_pushes)
        return SimResult(self.trace.name, self.method.name, self.ttf,
                         self.outcomes, cluster=metrics)

    def _finish_journal(self) -> None:
        if self._journal is not None and not self._ended:
            self._ended = True
            self._journal.end(step=self._step_idx,
                              n_outcomes=len(self.outcomes))

    def _attach_journal(self, journal, *, resumed_from=None) -> None:
        self._journal = journal
        journal.begin(config=self._config, trace_fp=self._trace_fp(),
                      method_name=getattr(self.method, "name", "?"),
                      resumed_from=resumed_from)

    def _trace_fp(self) -> int:
        keys = ",".join(f"{t}:{i}" for t, i in sorted(self.by_key))
        return stable_hash(f"{self.trace.name}|{len(self.by_key)}|{keys}")

    # ---------------------------------------------------------- durability
    _OUTCOME_FIELDS = ("first_alloc_gb", "final_alloc_gb", "attempts",
                       "failures", "wastage_gbh", "runtime_h", "aborted",
                       "interruptions", "tw_gbh", "grow_failures",
                       "oom_gbh", "interruption_gbh", "submit_h",
                       "start_h", "finish_h")

    def _ev_to_json(self, ev) -> list:
        t, seq, kind, payload = ev
        if kind == _ARRIVE:
            p = list(payload.key)
        elif kind in (_FINISH, _CRASH):
            p = payload
        elif kind in (_RECOVER, _RESIZE):
            p = list(payload)
        elif kind == _RACK_CRASH:
            p = payload
        else:   # _RACK_RECOVER: (rack, [(idx, token, attrib_from), ...])
            p = [payload[0], [list(d) for d in payload[1]]]
        return [t, seq, kind, p]

    def _ev_from_json(self, e) -> tuple[float, int, int, object]:
        t, seq, kind, p = e
        if kind == _ARRIVE:
            payload = self.by_key[tuple(p)]
        elif kind in (_FINISH, _CRASH):
            payload = int(p)
        elif kind in (_RECOVER, _RESIZE):
            payload = (int(p[0]), int(p[1]))
        elif kind == _RACK_CRASH:
            payload = p
        else:
            payload = (p[0], [(int(i), int(tok), af) for i, tok, af in p[1]])
        return (t, int(seq), int(kind), payload)

    def _entry_to_json(self, e: _Queued) -> dict:
        return {"seq": e.seq, "ready_h": e.ready_h,
                "task": list(e.task.key),
                "ledger": (None if e.ledger is None
                           else e.ledger.to_state()),
                "start_h": e.start_h, "n_dispatches": e.n_dispatches,
                "task_hash": e.task_hash}

    def _entry_from_json(self, d: dict) -> _Queued:
        task = self.by_key[tuple(d["task"])]
        led = (None if d["ledger"] is None
               else AttemptLedger.from_state(task, d["ledger"]))
        return _Queued(int(d["seq"]), d["ready_h"], task, led,
                       d["start_h"], int(d["n_dispatches"]), d["task_hash"])

    def export_state(self) -> dict:
        """Full JSON-safe engine state at a step boundary: the compacted
        snapshot the journal persists. Covers the event horizon (heap
        order + payloads), ready/pending queue with complete ledgers,
        running attempts with node bindings, exact per-node reservations
        and time integrals, crash-ownership tokens of unrepaired outages,
        DAG in-degrees, recorded outcomes, all counters, and the failure
        rng states — everything :meth:`_restore_state` needs to rebuild a
        bitwise-identical engine mid-workflow."""
        state = {
            "step": self._step_idx, "clock": self.clock,
            "eseq": self._eseq, "qseq": self._qseq,
            "atok": self._atok, "dtok": self._dtok,
            "events": [self._ev_to_json(e) for e in self.events],
            "queue": [self._entry_to_json(e) for e in self.queue],
            "running": [[tok, self._entry_to_json(e), n.name, started]
                        for tok, (e, n, started) in self.running.items()],
            "nodes": [{"name": n.name, "up": n.up,
                       "held": [[t, g] for t, g in n._held.items()],
                       "reserved_gbh": n.reserved_gbh, "down_h": n.down_h,
                       "last_t": n.last_t, "n_crashes": n.n_crashes}
                      for n in self.nodes],
            "down_token": [[i, t] for i, t in self.down_token.items()],
            "down_due": [[i, d] for i, d in self.down_due.items()],
            "indeg": [[list(k), v] for k, v in self.indeg.items()],
            "pending_arrivals": self.pending_arrivals,
            "outcomes": [dict({f: getattr(o, f)
                               for f in self._OUTCOME_FIELDS},
                              task=list(o.task.key))
                         for o in self.outcomes],
            "delays": list(self.delays),
            "counters": {
                "total_reserved": self.total_reserved,
                "peak_reserved": self.peak_reserved,
                "n_waves": self.n_waves,
                "n_size_calls": self.n_size_calls,
                "n_aborted": self.n_aborted,
                "n_preemptions": self.n_preemptions,
                "n_node_failures": self.n_node_failures,
                "n_resizes": self.n_resizes,
                "n_resize_waves": self.n_resize_waves,
                "n_grow_failures": self.n_grow_failures,
                "n_complete_waves": self.n_complete_waves,
                "n_failure_events": self.n_failure_events,
                "n_rack_failures": self.n_rack_failures,
                "n_straggler_attempts": self.n_straggler_attempts,
                "straggler_extra_h": self.straggler_extra_h,
                "n_events": self.n_events,
                "n_scan_entries": self.n_scan_entries,
                "n_heap_pushes": self.n_heap_pushes,
            },
            "rack_outage_node_h": dict(self.rack_outage_node_h),
            "warned_admission": self.warned_admission,
            "fail_rng": [r.bit_generator.state for r in self.fail_rngs],
            "rack_rng": {k: r.bit_generator.state
                         for k, r in self.rack_rngs.items()},
            "n_recoveries": self.n_recoveries,
            "n_replayed_steps": self.n_replayed_steps,
        }
        if self.has_export_state:
            state["mstate"] = self.method.export_state()
        if self.has_export_pending:
            pend = []
            for e in self.queue:
                if e.ledger is not None and not e.ledger.aborted:
                    pend.append([list(e.task.key),
                                 self.method.export_pending(e.task)])
            for e, _n, _s in self.running.values():
                pend.append([list(e.task.key),
                             self.method.export_pending(e.task)])
            state["pending"] = pend
        return state

    def _restore_state(self, state: dict) -> None:
        self._step_idx = int(state["step"])
        self.clock = state["clock"]
        self._eseq = int(state["eseq"])
        self._qseq = int(state["qseq"])
        self._atok = int(state["atok"])
        self._dtok = int(state["dtok"])
        self.events = [self._ev_from_json(e) for e in state["events"]]
        self.queue = _SeqQueue([self._entry_from_json(e)
                                for e in state["queue"]])
        # defensive: snapshots taken at step boundaries hold only sized
        # entries, but an unsized one must re-enter the next sizing wave
        self._pending_unsized = [e for e in self.queue if e.ledger is None]
        self._refresh_dirty = any(e.ledger is not None
                                  and e.ledger.refresh_pending
                                  for e in self.queue)
        byname = {n.name: n for n in self.nodes}
        # running is an insertion-ordered dict: crash_node's per-node token
        # index and the preemptive policy follow it, so restore in
        # recorded order
        self.running = {}
        self._node_tokens = [{} for _ in self.nodes]
        for tok, ej, nname, started in state["running"]:
            node = byname[nname]
            self.running[int(tok)] = (self._entry_from_json(ej),
                                      node, started)
            self._node_tokens[node.idx][int(tok)] = None
        for nd in state["nodes"]:
            n = byname[nd["name"]]
            n.up = nd["up"]
            n._held = {int(t): g for t, g in nd["held"]}
            n._refresh_reserved()
            n.reserved_gbh = nd["reserved_gbh"]
            n.down_h = nd["down_h"]
            n.last_t = nd["last_t"]
            n.n_crashes = int(nd["n_crashes"])
        self.down_token = {int(i): int(t) for i, t in state["down_token"]}
        self.down_due = {int(i): d for i, d in state["down_due"]}
        self.indeg = {tuple(k): int(v) for k, v in state["indeg"]}
        self.pending_arrivals = int(state["pending_arrivals"])
        self.outcomes = [
            TaskOutcome(self.by_key[tuple(d["task"])],
                        **{f: d[f] for f in self._OUTCOME_FIELDS})
            for d in state["outcomes"]]
        self.delays = list(state["delays"])
        for k, v in state["counters"].items():
            setattr(self, k, v)
        self.rack_outage_node_h = dict(state["rack_outage_node_h"])
        self.warned_admission = bool(state["warned_admission"])
        for r, s in zip(self.fail_rngs, state["fail_rng"]):
            r.bit_generator.state = s
        for k, s in state["rack_rng"].items():
            self.rack_rngs[k].bit_generator.state = s
        self.n_recoveries = int(state.get("n_recoveries", 0))
        self.n_replayed_steps = int(state.get("n_replayed_steps", 0))
        if self._findex is not None:
            # snapshots never serialize the free-capacity index: it is a
            # pure function of the node states restored above
            self._findex.rebuild()
        if state.get("mstate") is not None and self.has_restore_state:
            self.method.restore_state(state["mstate"])
        if self.has_restore_pending:
            for key, blob in state.get("pending", []):
                if blob is not None:
                    self.method.restore_pending(self.by_key[tuple(key)],
                                                blob)

    def _cold_restart(self) -> None:
        """The crash took the workers with the scheduler: interrupt every
        in-flight attempt at the recovery clock. Each re-enters the queue
        through the failure-strategy machinery — checkpoint retention
        (including mid-plan resumption) and retry_scaled re-sizing apply
        to scheduler crashes exactly as to node crashes. Stale FINISH /
        RESIZE events of the killed attempts are skipped by the usual
        ``token not in running`` guards."""
        for token in list(self.running):
            self._interrupt(token, self.clock)

    @classmethod
    def recover(cls, trace: WorkflowTrace, method: SizingMethod, journal,
                *, resume: str = "warm") -> "ClusterEngine":
        """Rebuild a mid-workflow engine from ``journal`` (whose backing
        file the caller repaired via ``Journal.repair`` BEFORE
        constructing ``method``, so the predictor warm-started from a
        journal-consistent prefix). Restores the last snapshot, replays
        the WAL tail, restores the method's crash-aware counters to their
        journaled kill-time values, then re-attaches the journal (new
        generation + immediate snapshot — a second crash recovers from
        here, never re-replaying history). ``resume='cold'`` additionally
        interrupts all in-flight attempts (see :meth:`_cold_restart`)."""
        if resume not in ("warm", "cold"):
            raise ValueError(f"resume must be 'warm' or 'cold', "
                             f"got {resume!r}")
        run = journal.load()
        if run is None:
            raise ValueError("journal holds no run to recover")
        if run.complete:
            raise ValueError("journaled run already completed; "
                             "nothing to recover")
        cfg = run.config
        specs = ([NodeSpec(**s) for s in cfg["node_specs"]]
                 if cfg["node_specs"] is not None else None)
        eng = cls(trace, method, cfg["ttf"], n_nodes=cfg["n_nodes"],
                  node_cap_gb=cfg["node_cap_gb"], node_specs=specs,
                  policy=cfg["policy"],
                  backfill_depth=cfg["backfill_depth"],
                  fail_rate_per_node_h=cfg["fail_rate_per_node_h"],
                  repair_h=cfg["repair_h"], fail_seed=cfg["fail_seed"],
                  rack_fail_rate_per_h=cfg["rack_fail_rate_per_h"],
                  rack_repair_h=cfg["rack_repair_h"],
                  straggler_rate=cfg["straggler_rate"],
                  straggler_factor=cfg["straggler_factor"],
                  straggler_seed=cfg["straggler_seed"])
        if run.trace_fp != eng._trace_fp():
            raise ValueError("journal was written for a different trace")
        if run.method_name != getattr(method, "name", "?"):
            raise ValueError(
                f"journal was written by method {run.method_name!r}, "
                f"recovering with {getattr(method, 'name', '?')!r}")
        if run.snapshot is not None:
            eng._restore_state(run.snapshot)
        if run.mstate is not None and eng.has_restore_state:
            # kill-time method counters: the tail's last journaled state
            # (replay skips note_interruption/complete, so counters do
            # not double-advance)
            method.restore_state(run.mstate)
        n_tail = len(run.tail)
        if n_tail:
            eng._replay = collections.deque(run.tail)
            with _span("journal/replay", n_steps=n_tail):
                while eng._replay is not None:
                    if not eng.step():
                        raise RuntimeError("journal divergence: engine "
                                           "finished mid-replay")
        eng.n_recoveries += 1
        eng.n_replayed_steps += n_tail
        if resume == "cold":
            eng._cold_restart()
        eng._attach_journal(journal, resumed_from=eng._step_idx)
        journal.snapshot(eng.export_state())
        return eng


def simulate_cluster(trace: WorkflowTrace, method: SizingMethod,
                     ttf: float = 1.0, *, n_nodes: int = 8,
                     node_cap_gb: float | None = None,
                     node_specs: Sequence[NodeSpec] | None = None,
                     policy: str = "backfill",
                     backfill_depth: int = 32,
                     fail_rate_per_node_h: float = 0.0,
                     repair_h: float = 1.0,
                     fail_seed: int = 0,
                     rack_fail_rate_per_h: float = 0.0,
                     rack_repair_h: float | dict[str, float] = 2.0,
                     straggler_rate: float = 0.0,
                     straggler_factor: float = 4.0,
                     straggler_seed: int | None = None,
                     journal=None) -> SimResult:
    """Execute ``trace`` concurrently on a cluster.

    The node set is either ``node_specs`` (heterogeneous: per-node
    capacities, machine-class labels, and optional rack failure domains)
    or ``n_nodes`` homogeneous nodes of ``node_cap_gb`` memory each
    (default: the trace's machine capacity).

    Failure injection (all schedules deterministic and seeded by
    ``fail_seed``, independent of event interleaving):

      * ``fail_rate_per_node_h > 0`` — independent node crash/recover
        events (exponential inter-crash times, ``repair_h`` downtime);
      * ``rack_fail_rate_per_h > 0`` — *correlated* rack outages: each
        rack draws its own exponential schedule and an outage crashes
        every up node in the rack at once, recovering them together after
        ``rack_repair_h`` (a scalar, or a per-rack-label mapping).
        Requires rack-labeled ``node_specs`` (see
        :func:`node_specs_from_caps` / :func:`node_specs_from_racks`);
      * ``straggler_rate > 0`` — each dispatched attempt straggles with
        this probability: its wall time (and therefore every reservation
        time-integral and RESIZE boundary) stretches by a factor drawn as
        ``1 + Exp(straggler_factor - 1)`` (mean ``straggler_factor``),
        keyed by ``(task, dispatch#)`` from ``straggler_seed`` (default:
        ``fail_seed``), so schedules replay bit-identically.

    Killed attempts are requeued at their original FIFO seq with
    interruption (non-OOM) accounting. What an interruption costs — and
    how the attempt re-runs — follows the method's ``failure_strategy``
    (``retry_same`` / ``retry_scaled`` / ``checkpoint``; see
    :mod:`repro_torch.workflow.accounting`). ``retry_scaled`` re-sizes
    interrupted tasks through the method before re-dispatch; methods
    exposing ``note_interruption`` observe every crash (crash-aware
    sizing feeds on this).

    Any :class:`SizingMethod` runs unmodified; methods exposing
    ``allocate_batch`` (Sizey) get each ready wave as one burst. Passing
    a :class:`~repro_torch.workflow.journal.Journal` makes the run *durable*:
    every engine transition is WAL-logged and periodically snapshotted,
    and a killed run resumes mid-workflow via
    :meth:`ClusterEngine.recover`. Returns a :class:`SimResult` whose
    ``cluster`` field carries makespan, queueing delay (dispatched tasks
    only — admission rejections are counted in ``n_aborted`` instead),
    per-node and per-node-class utilization, peak concurrent reservation,
    preemption/crash/rack/straggler counters, and wave / sizing-call
    counts; ``wastage_over_time()`` is event-timestamped and directly
    comparable to the serial curve.

    This is exactly ``ClusterEngine(...).run()``; use the engine class
    directly for stepwise execution (the scheduler service does).
    """
    return ClusterEngine(
        trace, method, ttf, n_nodes=n_nodes, node_cap_gb=node_cap_gb,
        node_specs=node_specs, policy=policy,
        backfill_depth=backfill_depth,
        fail_rate_per_node_h=fail_rate_per_node_h, repair_h=repair_h,
        fail_seed=fail_seed, rack_fail_rate_per_h=rack_fail_rate_per_h,
        rack_repair_h=rack_repair_h, straggler_rate=straggler_rate,
        straggler_factor=straggler_factor, straggler_seed=straggler_seed,
        journal=journal).run()
