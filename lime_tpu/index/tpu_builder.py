"""Device eBWT/LCP/DA construction (prefix doubling on the accelerator).

The reference delegates index construction to three external CPU tools
(BCR + egsa + eGap, Preprocessing.sh:81-196).  This builder runs the same
prefix-doubling algorithm as :mod:`.builder` but with every O(n log n) sort
and scan on the accelerator:

- each doubling round is one `jnp.lexsort` over (rank, rank[i+k]) plus a
  vectorized dense re-ranking;
- the LCP array comes from the doubling rank history via the greedy
  power-of-two descent — O(n log n) fully parallel, no Kasai-style
  sequential scan;
- eBWT/DA extraction are gathers.

The doubling loop runs on host (log2(max_len) iterations, one scalar sync
per round to test convergence); everything inside is jit-compiled.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import DT_DOC, DT_LCP, DT_SYMBOL
from .builder import TERMINATOR_BYTE, _initial_ranks


@jax.jit
def _dense_rank(keys: jnp.ndarray) -> jnp.ndarray:
    order = jnp.argsort(keys)
    sorted_keys = keys[order]
    changed = jnp.concatenate(
        [jnp.ones(1, bool), sorted_keys[1:] != sorted_keys[:-1]])
    dense = jnp.cumsum(changed) - 1
    return jnp.zeros_like(dense).at[order].set(dense)


@jax.jit
def _double_round(rank: jnp.ndarray, k: jnp.ndarray):
    n = rank.shape[0]
    idx = jnp.arange(n)
    key2 = jnp.where(idx + k < n, rank[jnp.minimum(idx + k, n - 1)], -1)
    order = jnp.lexsort((key2, rank))
    r1 = rank[order]
    r2 = key2[order]
    changed = jnp.concatenate(
        [jnp.ones(1, bool), (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])])
    new_rank = jnp.zeros(n, rank.dtype).at[order].set(
        (jnp.cumsum(changed) - 1).astype(rank.dtype))
    max_rank = new_rank[order[-1]]
    return new_rank, order, max_rank


@jax.jit
def _lcp_level(a, b, acc, rank_l, span, n):
    ok = (a + span <= n) & (b + span <= n)
    ia = jnp.where(ok, a, 0)
    ib = jnp.where(ok, b, 0)
    match = ok & (rank_l[ia] == rank_l[ib])
    step = jnp.where(match, span, 0)
    return a + step, b + step, acc + step


def build_index_tpu(seqs: Sequence[bytes]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ebwt, lcp, da) for the merged collection, built on the accelerator."""
    if not seqs:
        return (np.empty(0, DT_SYMBOL), np.empty(0, DT_LCP),
                np.empty(0, DT_DOC))
    ranks0, docs, seq_start = _initial_ranks(seqs)
    n = len(ranks0)

    rank = _dense_rank(jnp.asarray(ranks0, jnp.int32))
    history: List[jnp.ndarray] = [rank]
    order = jnp.argsort(rank)
    k = 1
    while True:
        rank, order, max_rank = _double_round(rank, jnp.int32(k))
        history.append(rank)
        if int(max_rank) == n - 1:
            break
        k *= 2
        if k > 2 * n:  # safety net; cannot trigger for valid inputs
            raise RuntimeError("prefix doubling failed to converge")
    sa = order

    # LCP via greedy binary descent over the rank history.
    if n >= 2:
        a = sa[:-1]
        b = sa[1:]
        acc = jnp.zeros(n - 1, jnp.int32)
        for level in range(len(history) - 1, -1, -1):
            a, b, acc = _lcp_level(a, b, acc, history[level],
                                   jnp.int32(1 << level), n)
        lcp = np.concatenate([[0], np.asarray(acc)])
    else:
        lcp = np.zeros(n, np.int64)

    sa_h = np.asarray(sa, dtype=np.int64)
    num_seqs = len(seqs)
    concat = np.empty(n, dtype=np.uint8)
    is_term = ranks0 < num_seqs
    concat[~is_term] = (ranks0[~is_term] - num_seqs).astype(np.uint8)
    concat[is_term] = TERMINATOR_BYTE
    prev = np.where(seq_start[sa_h], TERMINATOR_BYTE,
                    concat[np.maximum(sa_h - 1, 0)])
    return (prev.astype(DT_SYMBOL), lcp.astype(DT_LCP),
            docs[sa_h].astype(DT_DOC))
