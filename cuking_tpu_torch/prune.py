"""Port of ``cuking_tpu/prune.py`` (a copy): downstream relatedness pruning,
the maximal independent set over the pair graph.

The reference's README points users at Hail's ``maximal_independent_set`` to
prune related samples from the thresholded pair table (README.md:104-106).
This is the Hail-free equivalent operating directly on a :class:`ResultSet`
(or the output Parquet), using the same greedy heuristic Hail documents:
repeatedly remove the currently highest-degree vertex until no edges remain
(approximately maximizes the kept set).  Ties break on the smaller sample
index so results are deterministic.

Typical flow::

    results = KingEngine.from_genotypes(g).run()
    drop = related_samples_to_drop(results)      # set of sample indices
    keep = [s for s in range(n) if s not in drop]
"""

from __future__ import annotations

import heapq
from collections import defaultdict

import numpy as np

from cuking_tpu_torch.models.king import ResultSet


def maximal_independent_set(
    i_idx: np.ndarray, j_idx: np.ndarray, tie_breaker=None
) -> set:
    """Greedy approximate maximum independent set of the undirected graph
    given by edge lists; returns the KEPT vertex set.

    Mirrors Hail's algorithm (hail.methods.maximal_independent_set: "greedily
    removing a vertex of highest degree until the graph contains no edges").

    ``tie_breaker`` mirrors Hail's parameter: a function of two nodes whose
    negative return means the FIRST node is ordered before the second for
    removal — e.g. ``lambda l, r: rank[r] - rank[l]`` prefers dropping the
    lower-quality sample of an equal-degree tie (the gnomAD pipeline's
    pattern).  Remaining ties break on the smaller node id, so results stay
    deterministic.  Without a tie breaker the fast heap path is used.
    """
    adj: dict = defaultdict(set)
    for a, b in zip(np.asarray(i_idx).tolist(), np.asarray(j_idx).tolist()):
        if a == b:
            continue
        adj[a].add(b)
        adj[b].add(a)

    if tie_breaker is not None:
        return _mis_with_tie_breaker(adj, tie_breaker)

    removed: set = set()
    # Max-heap on degree (negated), tie-break on vertex id for determinism.
    heap = [(-len(nbrs), v) for v, nbrs in adj.items()]
    heapq.heapify(heap)
    while heap:
        neg_deg, v = heapq.heappop(heap)
        if v in removed:
            continue
        cur = len(adj[v])
        if cur == 0:
            continue
        if -neg_deg != cur:  # stale entry: reinsert with current degree
            heapq.heappush(heap, (-cur, v))
            continue
        removed.add(v)
        for u in adj[v]:
            adj[u].discard(v)
            heapq.heappush(heap, (-len(adj[u]), u))
        adj[v] = set()
    return set(adj.keys()) - removed


def _mis_with_tie_breaker(adj: dict, tie_breaker) -> set:
    """Slow-path greedy MIS honoring a removal-order tie breaker among
    equal-degree vertices (quadratic scan; relatedness graphs are small —
    only samples that appear in thresholded pairs are vertices)."""
    import functools

    def cmp(a, b):
        t = tie_breaker(a, b)
        if t < 0:
            return -1
        if t > 0:
            return 1
        return (a > b) - (a < b)

    key = functools.cmp_to_key(cmp)
    removed: set = set()
    while True:
        max_deg = max((len(n) for n in adj.values()), default=0)
        if max_deg == 0:
            break
        v = min((u for u, n in adj.items() if len(n) == max_deg), key=key)
        removed.add(v)
        for u in adj[v]:
            adj[u].discard(v)
        adj[v] = set()
    return set(adj.keys()) - removed


def related_samples_to_drop(results: ResultSet, tie_breaker=None) -> set:
    """Sample indices to DROP so that no kept pair remains related —
    the complement of the maximal independent set over the result pairs.

    ``tie_breaker`` orders equal-degree removals like Hail's
    ``maximal_independent_set`` (negative = first argument removed first)."""
    vertices = set(results.i_idx.tolist()) | set(results.j_idx.tolist())
    keep = maximal_independent_set(results.i_idx, results.j_idx, tie_breaker)
    return vertices - keep
