"""Greedy modularity community detection (first-party CNM).

The port's copy of ``ahrag_tpu/aggregate/community.py`` (pure Python).

Replaces the reference's delegation to
``networkx.algorithms.community.greedy_modularity_communities``
(semantic_aggregator.py:490). L1 topic graphs are small (tens of nodes), so a
straightforward O(V^3) agglomerative merge maximizing weighted modularity is ample.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Tuple


def greedy_modularity_communities(nodes: List[Hashable],
                                  edges: List[Tuple[Hashable, Hashable, float]]
                                  ) -> List[List[Hashable]]:
    """Agglomerative modularity maximization over an undirected weighted graph."""
    if not nodes:
        return []
    if not edges:
        return [[n] for n in nodes]

    m2 = 2.0 * sum(w for _, _, w in edges)          # 2m
    degree: Dict[Hashable, float] = {n: 0.0 for n in nodes}
    weight: Dict[Tuple[Hashable, Hashable], float] = {}
    for u, v, w in edges:
        if u == v:
            continue
        degree[u] = degree.get(u, 0.0) + w
        degree[v] = degree.get(v, 0.0) + w
        key = (u, v) if repr(u) <= repr(v) else (v, u)
        weight[key] = weight.get(key, 0.0) + w

    comms: List[set] = [{n} for n in nodes]

    def comm_degree(c: set) -> float:
        return sum(degree.get(n, 0.0) for n in c)

    def between_weight(a: set, b: set) -> float:
        total = 0.0
        for u in a:
            for v in b:
                key = (u, v) if repr(u) <= repr(v) else (v, u)
                total += weight.get(key, 0.0)
        return total

    while len(comms) > 1:
        best_dq, best_pair = 0.0, None
        for i in range(len(comms)):
            for j in range(i + 1, len(comms)):
                e_ij = between_weight(comms[i], comms[j])
                if e_ij <= 0:
                    continue
                dq = 2.0 * (e_ij / m2
                            - (comm_degree(comms[i]) * comm_degree(comms[j])) / (m2 * m2))
                if dq > best_dq + 1e-12:
                    best_dq, best_pair = dq, (i, j)
        if best_pair is None:
            break
        i, j = best_pair
        comms[i] = comms[i] | comms[j]
        comms.pop(j)

    comms.sort(key=lambda c: (-len(c), sorted(repr(x) for x in c)))
    return [sorted(c, key=repr) for c in comms]
