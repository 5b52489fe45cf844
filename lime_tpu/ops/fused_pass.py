"""Device executor for cluster detection and scoring (jax/XLA).

Design notes (an accelerator-first re-derivation, not a translation):

**Scoring** avoids the reference's per-cluster fseek + std::sort + histogram
loops (src/ClusterBWT_DA.cpp:299-347) entirely, via an occurrence-matching
identity: with per-position occurrence index

    occ[i] = #{ j < i in the same cluster : doc[j]=doc[i], sym[j]=sym[i] }

the symbol-aware score of a (read r, genome g) pair in a cluster is exactly

    t(r,g) = #{ (i,j) : doc[i]=r, doc[j]=g, sym[i]=sym[j], occ[i]=occ[j] }

because matching the k-th occurrence of (r,s) with the k-th occurrence of
(g,s) enumerates min(count_r(s), count_g(s)) pairs per symbol — the same
sum the reference computes from histograms.  Since clusters are bounded by
``window`` positions, "same cluster" for a pair at distance o is just
AND(lcp[k] >= alpha, k in (i-o, i]), and the whole scoring pass becomes
O(N * window) *banded* vector ops over the position stream feeding
scatter-adds — one device dispatch per collection, no cluster gathers, no
sorts (see lime_tpu/parallel/sharded.py for the kernel and its SPMD
sharding).

Cluster classes the identity cannot express take the exact host path, masked
out of the kernel via a per-position emit gate and rescored on host (both
rare):

- clusters containing IUPAC-degenerate symbols (ranks 4..14), where the
  reference's stateful leftover waterfall applies (ClusterBWT_DA.cpp:146-177);
- clusters longer than min(255, max observed length) — beyond 255 the
  reference's genome counters saturate (ClusterBWT_DA.cpp:96), which the
  occurrence identity does not model.

Known (documented) divergence: the reference's *read* counters are
unsaturated uchar and would wrap at a count of exactly 256 occurrences of
one (read, symbol) in one cluster; that requires alpha <= 1 and a 255bp
single-letter read, impossible in valid configurations.  The host executor
reproduces the wrap; this path treats counts as exact.

**Cluster detection** is a segmented scan.  The standalone step-1 artifact
(.clrs) is pure streaming at memory bandwidth with a one-bit carry — the
host implementation is already optimal for it and avoids a device round
trip; :func:`find_clusters_tpu` exists for the fused/sharded path where the
stream is already device-resident.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import LimeConfig
from ..constants import SYMBOL_RANK_LUT

_BLOCK = 1 << 20  # pad streams to block multiples for stable jit shapes

# bytes whose symbol rank is IUPAC-degenerate (4..14)
_DEGENERATE_BYTE = np.zeros(256, dtype=bool)
_DEGENERATE_BYTE[(SYMBOL_RANK_LUT >= 4) & (SYMBOL_RANK_LUT <= 14)] = True


# ---------------------------------------------------------------------------
# Step 1 — cluster detection (device-assisted; used by tests and the fused
# path — the standalone stage uses the host scan, see module docstring)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("alpha",))
def _boundary_block(lcp_blk: jnp.ndarray, da_blk: jnp.ndarray, prev_m,
                    alpha: int, num_reads: int):
    m = lcp_blk >= alpha
    prev = jnp.concatenate([prev_m[None], m[:-1]])
    starts = m & jnp.logical_not(prev)
    ends = jnp.logical_not(m) & prev
    is_read = da_blk < num_reads
    return starts, ends, is_read, m[-1]


def find_clusters_tpu(lcp: np.ndarray, da: np.ndarray, num_reads: int,
                      alpha: int, block: int = 1 << 24
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Device-assisted alpha-cluster detection over the (lcp, da) stream."""
    n = len(lcp)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts_l: List[np.ndarray] = []
    ends_l: List[np.ndarray] = []
    csum_parts: List[np.ndarray] = []
    # prev_m=True for the first block reproduces the reference's
    # skip-leading rule (a run touching position 0 emits no start).
    prev = jnp.asarray(True)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s, e, r, prev = _boundary_block(
            jnp.asarray(np.ascontiguousarray(lcp[lo:hi])),
            jnp.asarray(np.ascontiguousarray(da[lo:hi])),
            prev, alpha, num_reads)
        s, e, r = np.asarray(s), np.asarray(e), np.asarray(r)
        starts_l.append(np.flatnonzero(s) + lo)
        ends_l.append(np.flatnonzero(e) + lo)
        csum_parts.append(np.cumsum(r, dtype=np.int64))
    base = 0
    for part in csum_parts:
        part += base
        base = part[-1]
    csum = np.concatenate([[0], np.concatenate(csum_parts)])

    run_starts = np.concatenate(starts_l) if starts_l else np.empty(0, np.int64)
    run_ends = np.concatenate(ends_l) if ends_l else np.empty(0, np.int64)
    if len(run_ends) and (len(run_starts) == 0 or run_ends[0] <= run_starts[0]):
        run_ends = run_ends[1:]
    if len(run_starts) > len(run_ends):
        run_ends = np.append(run_ends, n)

    p_start = run_starts - 1
    lens = run_ends - p_start
    n_reads_in = csum[run_ends] - csum[p_start]
    keep = (n_reads_in > 0) & (n_reads_in < lens)
    return p_start[keep], lens[keep]


# ---------------------------------------------------------------------------
# Step 2 — banded occurrence-matching scoring (single dispatch/collection)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("num_reads", "num_refs"))
def _banded_score(m, doc, sym, emit_ok, window, num_reads: int,
                  num_refs: int):
    from ..parallel.sharded import banded_partial_sim

    return banded_partial_sim(m, doc, sym, num_reads, num_refs, window,
                              emit_ok=emit_ok)


def _bad_cluster_mask(p_start: np.ndarray, lens: np.ndarray,
                      ebwt: np.ndarray | None, window: int,
                      use_ebwt: bool, n: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(per-position emit gate, indices of host-rescored clusters)."""
    bad = lens > window
    if use_ebwt and ebwt is not None:
        deg_pos = np.flatnonzero(_DEGENERATE_BYTE[np.asarray(ebwt)])
        if len(deg_pos):
            cid = np.searchsorted(p_start, deg_pos, side="right") - 1
            inside = (cid >= 0) & (deg_pos < p_start[cid] + lens[cid])
            bad[np.unique(cid[inside])] = True
    bad_idx = np.flatnonzero(bad)
    ok = np.ones(n, dtype=bool)
    for c in bad_idx:  # rare
        ok[p_start[c]:p_start[c] + lens[c]] = False
    return ok, bad_idx


def score_clusters_tpu(p_start: np.ndarray, lens: np.ndarray, da: np.ndarray,
                       ebwt: np.ndarray | None, num_reads: int, num_refs: int,
                       config: LimeConfig, alpha: int | None = None,
                       lcp: np.ndarray | None = None) -> np.ndarray:
    """Dense similarity matrix via the banded device kernel.

    Needs the lcp stream (+ alpha) to form the in-cluster mask; falls back
    to reconstructing the mask from the cluster list when lcp is absent.
    Returns the matrix in ``config.sim_dtype`` with the reference's counter
    semantics (u8 wraps mod 256).
    """
    from .scoring import score_clusters  # host exact path for rare clusters

    p_start = np.asarray(p_start, np.int64)
    lens = np.asarray(lens, np.int64)
    if config.use_ebwt and ebwt is None:
        raise ValueError("use_ebwt=True requires the .ebwt array")
    if len(p_start) == 0:
        return np.zeros((num_reads, num_refs), dtype=config.sim_dtype)

    n = len(da)
    if lcp is not None and alpha is not None:
        m = np.asarray(lcp) >= alpha
        m[0] = False
    else:
        # reconstruct the run mask from the cluster list: rows
        # [p_start+1, p_start+len) carry m=True
        m = np.zeros(n, dtype=bool)
        total = int((lens - 1).sum())
        offs = np.concatenate([[0], np.cumsum(lens[:-1] - 1)])
        within = np.arange(total) - np.repeat(offs, lens - 1)
        m[np.repeat(p_start + 1, lens - 1) + within] = True

    window = int(min(max(int(lens.max()), 1), 255))
    ok, bad_idx = _bad_cluster_mask(p_start, lens, ebwt, window,
                                    config.use_ebwt, n)

    n_pad = -(-n // _BLOCK) * _BLOCK
    pad = n_pad - n

    def padded(x, fill=0):
        return np.pad(x, (0, pad), constant_values=fill)

    sym = (SYMBOL_RANK_LUT[np.asarray(ebwt)].astype(np.int8)
           if config.use_ebwt else np.zeros(n, np.int8))
    sim_dev = _banded_score(
        jnp.asarray(padded(m, False)),
        jnp.asarray(padded(np.asarray(da, np.int32))),
        jnp.asarray(padded(sym)),
        jnp.asarray(padded(ok, False)),
        jnp.int32(window), num_reads, num_refs)

    sim = np.asarray(jax.device_get(sim_dev)).astype(np.int64)

    if len(bad_idx):
        sim += score_clusters(
            p_start[bad_idx], lens[bad_idx], np.asarray(da),
            None if ebwt is None else np.asarray(ebwt),
            num_reads, num_refs,
            config.replace(wide_sim=True)).astype(np.int64)

    if config.sim_modulus:
        return (sim % config.sim_modulus).astype(config.sim_dtype)
    return sim.astype(config.sim_dtype)
