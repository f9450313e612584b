"""Bandwidth-reducing reordering: reverse Cuthill-McKee (RCM).

New scope beyond the Rust reference (which has no reordering pass): the
SpMV fast paths depend on *index locality* — the DIA structure detector
(`ops/spmv_dia.py`) needs populated diagonals, and the aligned window packer
(`formats/aligned.py`) needs each row's columns clustered into few 128-wide
windows. Real corpora (SuiteSparse-style) often arrive with arbitrary node
numbering; RCM restores the locality those paths exploit, turning the
documented no-locality corner (uniform-random structure) into the fast
path. This is the device analog of the reference's philosophy of
shaping data for the execution substrate (FLOP-balanced chunks for rayon,
``spam_csr/src/mul_hash.rs:38-64``): here we shape the *index space* for the
vector lanes.

Algorithm: classic RCM — BFS from a George–Liu pseudo-peripheral vertex,
children visited in (parent rank, degree) order, final order reversed.
Implemented as vectorized per-level numpy (frontier expansion is one
lexsort + stable dedupe per level), so 4M-edge graphs order in seconds on
the 1-core host. Differentially tested against scipy.sparse.csgraph's RCM
(tests/test_reorder.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .csr import CsrMatrix

__all__ = [
    "nd_permutation",
    "rcm_permutation",
    "permute_symmetric",
    "bandwidth",
    "rcm_reordered",
]


def _symmetric_pattern(m: CsrMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Adjacency of the symmetrized pattern A|A^T, self-loops dropped.

    Returns (indptr, indices, degree) with int64 dtypes.
    """
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    keep = rr != cc  # graph edges only; self-loops don't affect BFS
    rr, cc = rr[keep], cc[keep]
    order = np.lexsort((cc, rr))
    rr, cc = rr[order], cc[order]
    if len(rr):
        keys = rr * m.cols + cc
        head = np.empty(len(keys), dtype=bool)
        head[0] = True
        np.not_equal(keys[1:], keys[:-1], out=head[1:])
        rr, cc = rr[head], cc[head]
    n = m.rows
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rr + 1, 1)
    np.cumsum(indptr, out=indptr)
    degree = np.diff(indptr)
    return indptr, cc, degree


def _concat_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """[s0, s0+1, .., s0+c0-1, s1, ...] without a Python loop."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out += np.repeat(starts - np.concatenate([[0], ends[:-1]]), counts)
    return out


def _bfs_levels(indptr, indices, root, visited_mask):
    """Unordered BFS level structure from root over the unvisited subgraph.

    Returns (levels: list of arrays, touched: flat array). Does not mutate
    visited_mask.
    """
    seen = visited_mask.copy()
    seen[root] = True
    frontier = np.array([root], dtype=np.int64)
    levels = [frontier]
    while True:
        counts = indptr[frontier + 1] - indptr[frontier]
        nbrs = indices[_concat_ranges(indptr[frontier], counts)]
        nbrs = np.unique(nbrs[~seen[nbrs]])
        if nbrs.size == 0:
            break
        seen[nbrs] = True
        levels.append(nbrs)
        frontier = nbrs
    return levels


def _pseudo_peripheral(indptr, indices, degree, visited_mask):
    """George–Liu: start at a min-degree unvisited vertex, walk to the far
    end of the level structure until eccentricity stops growing."""
    unvisited = np.flatnonzero(~visited_mask)
    x = int(unvisited[np.argmin(degree[unvisited])])
    ecc = -1
    for _ in range(16):  # converges in a handful of sweeps
        levels = _bfs_levels(indptr, indices, x, visited_mask)
        if len(levels) - 1 <= ecc:
            return x
        ecc = len(levels) - 1
        last = levels[-1]
        x = int(last[np.argmin(degree[last])])
    return x


def rcm_permutation(m: CsrMatrix) -> np.ndarray:
    """Reverse Cuthill–McKee permutation of the symmetrized pattern.

    Returns ``perm`` (int64, len rows) such that new index ``i`` maps to old
    index ``perm[i]``; apply with :func:`permute_symmetric`. Square matrices
    only (reordering is a graph operation on the symmetric pattern).
    """
    if m.rows != m.cols:
        raise ValueError("RCM requires a square matrix")
    n = m.rows
    indptr, indices, degree = _symmetric_pattern(m)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    while pos < n:
        root = _pseudo_peripheral(indptr, indices, degree, visited)
        visited[root] = True
        order[pos] = root
        pos += 1
        frontier = np.array([root], dtype=np.int64)
        while frontier.size:
            counts = indptr[frontier + 1] - indptr[frontier]
            parent_rank = np.repeat(np.arange(len(frontier)), counts)
            nbrs = indices[_concat_ranges(indptr[frontier], counts)]
            live = ~visited[nbrs]
            nbrs, parent_rank = nbrs[live], parent_rank[live]
            if nbrs.size == 0:
                break
            # queue semantics: group by first-discovering parent, degree
            # ascending within each group (Cuthill-McKee's tie-break)
            sort = np.lexsort((degree[nbrs], parent_rank))
            nbrs = nbrs[sort]
            _, first_idx = np.unique(nbrs, return_index=True)
            first_idx.sort()
            nxt = nbrs[first_idx]
            visited[nxt] = True
            order[pos : pos + len(nxt)] = nxt
            pos += len(nxt)
            frontier = nxt
    return order[::-1].copy()


def permute_symmetric(m: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """B = P A P^T for the permutation ``B[i, j] = A[perm[i], perm[j]]``.

    Identity: ``B @ x[perm] == (A @ x)[perm]`` — solvers run entirely in the
    permuted space and un-permute the solution once.
    """
    perm = np.asarray(perm, dtype=np.int64)
    if m.rows != m.cols or len(perm) != m.rows:
        raise ValueError("permutation length must equal matrix dimension")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    new_r = inv[m.row_ids()]
    new_c = inv[m.indices.astype(np.int64)]
    return CsrMatrix.from_coo(
        m.rows, m.cols, new_r, new_c, m.vals, sum_duplicates=False
    )


def bandwidth(m: CsrMatrix) -> int:
    """max |i - j| over stored entries (0 for an empty matrix)."""
    if m.nnz() == 0:
        return 0
    return int(np.abs(m.row_ids() - m.indices.astype(np.int64)).max())


def rcm_reordered(m: CsrMatrix) -> Tuple[CsrMatrix, np.ndarray]:
    """Convenience: ``(permute_symmetric(m, p), p)`` with ``p = RCM(m)``."""
    p = rcm_permutation(m)
    return permute_symmetric(m, p), p


def nd_permutation(m: CsrMatrix, *, leaf_size: int = 128) -> np.ndarray:
    """Nested-dissection ordering (George): recursive BFS level-set
    bisection, separator ordered LAST at every level.

    Why next to RCM: RCM minimizes *bandwidth*, which bounds Cholesky
    fill by n*band = O(n^1.5) on a 2-D mesh; nested dissection bounds it
    by O(n log n) — at 512^2 that is an order of magnitude fewer factor
    entries (measured in tests/test_reorder.py). Use for the exact direct
    factorizations (``solvers/cholesky.py reorder="nd"``); keep RCM for
    the SpMV fast paths, which want a band, not separators.

    Separators are middle BFS level sets from a pseudo-peripheral root —
    the classic grid heuristic; leaves (<= ``leaf_size``) keep their
    natural order. BFS runs on int visit stamps scoped to the current
    block (a per-call O(n) mask copy would make the recursion
    O(n^2/leaf) — measured 2.6 s at 256^2 before this)."""
    if m.rows != m.cols:
        raise ValueError("nested dissection requires a square matrix")
    n = m.rows
    indptr, indices, degree = _symmetric_pattern(m)
    block_of = np.zeros(n, dtype=np.int64)
    seen = np.full(n, -1, dtype=np.int64)
    counter = [0]

    def bfs(root: int, bid: int):
        counter[0] += 1
        v = counter[0]
        seen[root] = v
        frontier = np.array([root], dtype=np.int64)
        levels = [frontier]
        while True:
            counts = indptr[frontier + 1] - indptr[frontier]
            nbrs = indices[_concat_ranges(indptr[frontier], counts)]
            nbrs = nbrs[(block_of[nbrs] == bid) & (seen[nbrs] != v)]
            if nbrs.size == 0:
                break
            nbrs = np.unique(nbrs)
            seen[nbrs] = v
            levels.append(nbrs)
            frontier = nbrs
        return levels

    next_bid = [1]

    def order_block(nodes: np.ndarray, bid: int) -> np.ndarray:
        if len(nodes) <= leaf_size:
            return nodes
        # pseudo-peripheral within the block (few sweeps suffice here)
        x = int(nodes[np.argmin(degree[nodes])])
        ecc, levels = -1, None
        for _ in range(4):
            lv = bfs(x, bid)
            if len(lv) - 1 <= ecc:
                break
            ecc, levels = len(lv) - 1, lv
            tail = levels[-1]
            x = int(tail[np.argmin(degree[tail])])
        if levels is None or len(levels) < 3:
            return nodes  # clique-like or star: nothing to bisect
        touched = np.concatenate(levels)
        # other components of this block (BFS never reaches them): they
        # are disconnected from everything touched, so they join part A
        # without affecting the separator
        rest = nodes[np.isin(nodes, touched, invert=True)] if len(
            touched
        ) < len(nodes) else np.zeros(0, dtype=np.int64)
        sizes = np.fromiter((len(lv) for lv in levels), dtype=np.int64)
        cum = np.cumsum(sizes)
        half = (cum[-1] + len(rest)) // 2
        mid = int(np.clip(np.argmin(np.abs(cum - half)), 1, len(levels) - 2))
        sep = levels[mid]
        a = np.concatenate([rest] + levels[:mid])
        b = np.concatenate(levels[mid + 1 :])
        bid_a, bid_b = next_bid[0], next_bid[0] + 1
        next_bid[0] += 2
        block_of[a] = bid_a
        block_of[b] = bid_b
        return np.concatenate([order_block(a, bid_a), order_block(b, bid_b), sep])

    perm = order_block(np.arange(n, dtype=np.int64), 0)
    assert len(perm) == n
    return perm
