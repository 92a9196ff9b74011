"""BFS graph-growing partitioner (numpy) — METIS stand-in.

Produces ``psize`` roughly equal, locality-preserving node clusters by
growing BFS frontiers from random seeds — the same objective METIS
optimizes (minimize cut edges, balance sizes) approximated greedily.
Cluster-GCN only needs clusters whose induced subgraphs keep most edges
internal; BFS growing achieves that on the power-law graphs involved.
"""

from __future__ import annotations

import numpy as np


def build_csr(senders, receivers, n_nodes):
    """Host CSR over receivers (in-neighbors), numpy only."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    order = np.argsort(receivers, kind="stable")
    s = senders[order]
    counts = np.bincount(receivers, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, s


def greedy_partition(senders, receivers, n_nodes, psize, seed=0):
    """Return a list of ``psize`` disjoint node-id arrays covering all
    nodes, each of size ~n_nodes/psize, grown by BFS."""
    if psize <= 1:
        return [np.arange(n_nodes, dtype=np.int64)]
    indptr, nbrs = build_csr(senders, receivers, n_nodes)
    rng = np.random.default_rng(seed)
    target = max(1, n_nodes // psize)

    assigned = np.full(n_nodes, -1, dtype=np.int64)
    visit_order = rng.permutation(n_nodes)
    visit_ptr = 0
    parts = []
    frontier = []

    for pid in range(psize):
        members = []
        frontier.clear()
        while len(members) < target:
            if not frontier:
                # find an unassigned seed
                while visit_ptr < n_nodes and assigned[visit_order[visit_ptr]] >= 0:
                    visit_ptr += 1
                if visit_ptr >= n_nodes:
                    break
                seed_node = visit_order[visit_ptr]
                assigned[seed_node] = pid
                members.append(seed_node)
                frontier.append(seed_node)
                continue
            u = frontier.pop()
            neigh = nbrs[indptr[u]:indptr[u + 1]]
            for v in neigh:
                if assigned[v] < 0:
                    assigned[v] = pid
                    members.append(v)
                    frontier.append(v)
                    if len(members) >= target:
                        break
        parts.append(np.asarray(members, dtype=np.int64))

    # sweep up any stragglers into the last partitions round-robin
    leftover = np.nonzero(assigned < 0)[0]
    if leftover.size:
        chunks = np.array_split(leftover, psize)
        parts = [np.concatenate([p, c]) for p, c in zip(parts, chunks)]
    return parts


def refine_partition(senders, receivers, n_nodes, parts, passes=6,
                     imbalance=1.05):
    """Vectorized k-way boundary refinement (numpy fallback for the C++
    multilevel partitioner): repeatedly move nodes to the adjacent
    cluster with maximal connectivity gain, balance-capped.  Conflict-free
    because each round applies moves simultaneously but recomputes
    connectivity from the committed assignment."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    psize = len(parts)
    if psize <= 1:
        return parts
    assign = np.empty(n_nodes, dtype=np.int64)
    for pid, p in enumerate(parts):
        assign[p] = pid
    sizes = np.bincount(assign, minlength=psize)
    maxw = int(n_nodes / psize * imbalance) + 1

    import scipy.sparse as sp
    A = sp.csr_matrix((np.ones(len(senders), np.float64),
                       (senders, receivers)), shape=(n_nodes, n_nodes))
    A = A + A.T
    for _ in range(passes):
        P = sp.csr_matrix((np.ones(n_nodes), (np.arange(n_nodes), assign)),
                          shape=(n_nodes, psize))
        C = (A @ P).tocsr()                      # connectivity node x part
        best = np.asarray(C.argmax(axis=1)).ravel()
        best_w = C.max(axis=1).toarray().ravel()
        cur_w = np.asarray(C[np.arange(n_nodes), assign]).ravel()
        gain = best_w - cur_w
        movers = np.nonzero((gain > 0) & (best != assign)
                            & (sizes[best] < maxw))[0]
        if movers.size == 0:
            break
        # apply highest-gain moves first, respecting the balance cap
        movers = movers[np.argsort(-gain[movers], kind="stable")]
        moved = 0
        for u in movers:
            b = best[u]
            if sizes[b] + 1 <= maxw and sizes[assign[u]] > 1:
                sizes[assign[u]] -= 1
                sizes[b] += 1
                assign[u] = b
                moved += 1
        if moved == 0:
            break
    # explicit balance sweep: the gain loop above only accepts
    # cut-improving moves, so parts that start over the ceiling stay
    # there — push their boundary nodes DOWNHILL into strictly-lighter
    # adjacent parts, least cut damage first (diffusion; mirrors
    # partition.cpp:balance)
    for _ in range(2 * passes):
        over = np.nonzero(sizes > maxw)[0]
        if over.size == 0:
            break
        P = sp.csr_matrix((np.ones(n_nodes), (np.arange(n_nodes), assign)),
                          shape=(n_nodes, psize))
        C = (A @ P).toarray()                    # node x part connectivity
        moved = 0
        for p in over:
            nodes = np.nonzero(assign == p)[0]
            cur = C[nodes, p]
            cand = C[nodes].copy()
            cand[:, p] = -np.inf
            cand[:, C[nodes].max(axis=0) <= 0] = -np.inf  # non-adjacent
            tgt_order = np.argsort(-(cand - cur[:, None]).max(axis=1),
                                   kind="stable")
            for i in tgt_order:
                if sizes[p] <= maxw:
                    break
                row = cand[i]
                elig = np.nonzero(np.isfinite(row)
                                  & (sizes + 1 <= sizes[p] - 1))[0]
                if elig.size == 0:
                    continue
                b = elig[np.argmax(row[elig])]
                sizes[p] -= 1
                sizes[b] += 1
                assign[nodes[i]] = b
                moved += 1
        if moved == 0:
            break
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    starts = np.searchsorted(sa, np.arange(psize))
    ends = np.searchsorted(sa, np.arange(psize), side="right")
    return [order[a:b].copy() for a, b in zip(starts, ends)]
