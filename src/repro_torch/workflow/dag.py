"""Minimal workflow DAG (paper §I: B task types, E edges).

The serial simulator only needs a submission order consistent with the
dependency structure; the DAG provides staged topological ordering plus
validation. The event-driven cluster engine additionally needs
*instance-level* edges — which physical instance of an upstream type each
downstream instance waits on — produced by :meth:`WorkflowDAG.instance_edges`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.utils.misc import stable_hash


@dataclasses.dataclass
class WorkflowDAG:
    """DAG over task *types*; each type expands to many physical instances."""
    name: str
    task_types: list[str]
    edges: list[tuple[str, str]]  # (upstream, downstream)

    def __post_init__(self):
        types = set(self.task_types)
        for a, b in self.edges:
            if a not in types or b not in types:
                raise ValueError(f"edge ({a},{b}) references unknown task type")
        if self.stages() is None:
            raise ValueError(f"workflow {self.name} has a dependency cycle")

    def stages(self) -> dict[str, int] | None:
        """Longest-path stage per task type (None if cyclic)."""
        indeg = {t: 0 for t in self.task_types}
        adj: dict[str, list[str]] = {t: [] for t in self.task_types}
        for a, b in self.edges:
            adj[a].append(b)
            indeg[b] += 1
        stage = {t: 0 for t in self.task_types}
        queue = [t for t in self.task_types if indeg[t] == 0]
        done = 0
        while queue:
            t = queue.pop()
            done += 1
            for d in adj[t]:
                stage[d] = max(stage[d], stage[t] + 1)
                indeg[d] -= 1
                if indeg[d] == 0:
                    queue.append(d)
        return stage if done == len(self.task_types) else None

    def instance_edges(self, counts: dict[str, int], seed: int = 0,
                       fan_in: int = 2) -> dict[tuple[str, int],
                                                tuple[tuple[str, int], ...]]:
        """Expand the type-level edges to per-instance dependency edges.

        ``counts`` gives the number of physical instances per task type.
        For each type edge (a, b), downstream instance k of b depends on
        the *aligned* upstream instance ``floor(k * n_a / n_b)`` — a
        scatter when b has more instances than a, a stride-gather when it
        has fewer — plus up to ``fan_in - 1`` extra seeded gather edges
        (nf-core joins typically merge a handful of upstream shards).
        Deterministic per (dag name, edge, seed).
        """
        deps: dict[tuple[str, int], list[tuple[str, int]]] = {
            (t, i): [] for t, n in counts.items() for i in range(n)}
        for a, b in self.edges:
            na, nb = counts.get(a, 0), counts.get(b, 0)
            if not na or not nb:
                continue
            rng = np.random.default_rng(
                (stable_hash(f"{self.name}:{a}->{b}") + seed) % (2 ** 31))
            for k in range(nb):
                ups = {k * na // nb}
                for _ in range(fan_in - 1):
                    ups.add(int(rng.integers(na)))
                deps[(b, k)].extend((a, u) for u in sorted(ups))
        return {key: tuple(v) for key, v in deps.items()}

    @staticmethod
    def chain_of(task_types: list[str], width: int = 3) -> "WorkflowDAG":
        """Typical nf-core shape: stages of ~``width`` parallel types."""
        edges = []
        for i in range(width, len(task_types)):
            edges.append((task_types[i - width], task_types[i]))
        return WorkflowDAG("chain", list(task_types), edges)
