"""Tensor-core histogram-matmul scoring for genome-dense clusters.

The large-G scoring regime: the banded one-hot kernel pays
``window * G_pad`` vector lanes per position (fine at G_pad <= 256, ~100x
too slow at 930 genomes), and the host SIMD scorer is bound by the host's
few cores.  This path puts the FLOPs on the matrix units (tensor cores).

Identity (same histogram sum as the reference, src/ClusterBWT_DA.cpp:81-191):
with per-cluster indicator features

    phi_r[s, k] = [count_r(s) >= k+1]      psi_g[s, k] = [count_g(s) >= k+1]

the symbol-aware score is  sum_s min(count_r(s), count_g(s)) = phi_r . psi_g
whenever every read-side count is <= K.  The native planner
(lime_plan_dense) packs clusters into *entries* of ``PR`` read lanes and
emits flat feature triples; here each fixed-shape chunk of clusters becomes

    phi  (B, PR, F)   one scatter of read triples        F = nsym * K
    psi  (C, G_pad, F) one scatter of genome triples
    out  = einsum('bpf,bgf->bpg', phi, psi[cmap])        batched matmul
    sim[rid] += out                                      one row scatter-add

K <= 255 subsumes the reference's genome-counter saturation
(ClusterBWT_DA.cpp:96); clusters with a read-side count > K or more than
``MAX_ENT * PR`` distinct reads are returned to the caller for the exact
host scorer.  int8 accumulation wraps mod 256 = the reference's unsaturated
uchar SimArray (ClusterBWT_DA.cpp:183).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import native
from ..constants import SCATTER_DROP, SYMBOL_RANK_LUT

K = 8        # occurrence-depth cap per (document, symbol)
PR = 8       # read lanes per matmul entry
MAX_ENT = 2048  # entries per cluster (=> up to 16384 distinct reads)

B_BLK = 2048      # entries per device dispatch
C_BLK = 1024      # clusters per device dispatch
RT_CAP = 1 << 19  # read triples per dispatch
GT_CAP = 1 << 19  # genome triples per dispatch


def _pad_p2(n: int, lo: int = 1 << 15) -> int:
    """Next power of two >= n (>= lo): bounds jit shape variants while
    keeping triple uploads near their real size (padding every chunk to
    the full caps would ship ~8 MB per chunk regardless of content)."""
    k = lo
    while k < n:
        k <<= 1
    return k


@functools.partial(
    jax.jit, static_argnames=("b_blk", "c_blk", "pr", "f", "g_pad"),
    donate_argnums=(0,))
def _dense_chunk(sim, ridx, gidx, cmap, rid, b_blk: int, c_blk: int,
                 pr: int, f: int, g_pad: int):
    """One fixed-shape chunk: scatter features, batched matmul, row scatter.

    Triple pads carry out-of-range flat indices (mode='drop'); pad entries
    and unused read lanes have all-zero phi rows and a past-the-end
    ``rid``, so their row updates are dropped.  bf16 features with an f32 accumulator are exact here:
    inputs are 0/1 and per-pair scores are <= F.
    """
    one = jnp.ones((), jnp.bfloat16)
    phi = (jnp.zeros((b_blk * pr * f,), jnp.bfloat16)
           .at[ridx].add(one, mode="drop").reshape(b_blk, pr, f))
    psi = (jnp.zeros((c_blk * g_pad * f,), jnp.bfloat16)
           .at[gidx].add(one, mode="drop").reshape(c_blk, g_pad, f))
    out = jnp.einsum("bpf,bgf->bpg", phi, psi[cmap],
                     preferred_element_type=jnp.float32)
    add = out.reshape(b_blk * pr, g_pad).astype(jnp.int32)
    return sim.at[rid].add(add.astype(sim.dtype), mode="drop")


@functools.partial(
    jax.jit, static_argnames=("b_blk", "c_blk", "pr", "f", "g_pad",
                              "fidx"),
    donate_argnums=(0,))
def _dense_chunk_offset(stack, ridx, gidx, cmap, rid, row_base,
                        b_blk: int, c_blk: int, pr: int, f: int,
                        g_pad: int, fidx: int):
    """Row-blocked :func:`_dense_chunk` into the (F, B, g_pad) stack.

    Pad entries carry a past-the-end ``rid``; real rows outside
    [row_base, row_base + B) also route past the end (jax wraps negative
    indices before the out-of-bounds check).  Scattering straight into
    file plane ``fidx`` avoids per-file block buffers.
    """
    one = jnp.ones((), jnp.bfloat16)
    phi = (jnp.zeros((b_blk * pr * f,), jnp.bfloat16)
           .at[ridx].add(one, mode="drop").reshape(b_blk, pr, f))
    psi = (jnp.zeros((c_blk * g_pad * f,), jnp.bfloat16)
           .at[gidx].add(one, mode="drop").reshape(c_blk, g_pad, f))
    out = jnp.einsum("bpf,bgf->bpg", phi, psi[cmap],
                     preferred_element_type=jnp.float32)
    add = out.reshape(b_blk * pr, g_pad).astype(jnp.int32)
    local = rid - row_base
    ok = (local >= 0) & (local < stack.shape[1])
    plane = stack[fidx].at[jnp.where(ok, local, stack.shape[1])].add(
        add.astype(stack.dtype), mode="drop")
    return stack.at[fidx].set(plane)


@functools.partial(
    jax.jit, static_argnames=("b_blk", "c_blk", "pr", "f", "g_pad",
                              "fidx"),
    donate_argnums=(0,))
def _dense_scan_class(stack, ridxs, gidxs, cmaps, rids, row_base,
                      b_blk: int, c_blk: int, pr: int, f: int,
                      g_pad: int, fidx: int):
    """Row-blocked dense scoring of a whole same-shape chunk class in ONE
    dispatch (lax.scan) — one launch per class instead of one per chunk."""

    def body(st, inp):
        ridx, gidx, cmap, rid = inp
        one = jnp.ones((), jnp.bfloat16)
        phi = (jnp.zeros((b_blk * pr * f,), jnp.bfloat16)
               .at[ridx].add(one, mode="drop").reshape(b_blk, pr, f))
        psi = (jnp.zeros((c_blk * g_pad * f,), jnp.bfloat16)
               .at[gidx].add(one, mode="drop").reshape(c_blk, g_pad, f))
        out = jnp.einsum("bpf,bgf->bpg", phi, psi[cmap],
                         preferred_element_type=jnp.float32)
        add = out.reshape(b_blk * pr, g_pad).astype(jnp.int32)
        local = rid - row_base
        ok = (local >= 0) & (local < st.shape[1])
        plane = st[fidx].at[jnp.where(ok, local, st.shape[1])].add(
            add.astype(st.dtype), mode="drop")
        return st.at[fidx].set(plane), 0

    stack, _ = lax.scan(body, stack, (ridxs, gidxs, cmaps, rids))
    return stack


def dense_upload_classes(chunks, fi: int):
    """Group one collection's dense chunks by triple shapes and ship each
    class as stacked device arrays (uploaded once, replayed per block)."""
    classes = {}
    for ridx, gidx, cmap_c, rid_c in chunks:
        classes.setdefault((len(ridx), len(gidx)), []).append(
            (ridx, gidx, cmap_c, rid_c))
    out = []
    for (rcap, gcap), items in classes.items():
        out.append((fi,
                    jax.device_put(np.stack([i[0] for i in items])),
                    jax.device_put(np.stack([i[1] for i in items])),
                    jax.device_put(np.stack([i[2] for i in items])),
                    jax.device_put(np.stack([i[3] for i in items]))))
    return out


def pack_chunks(starts: np.ndarray, lens: np.ndarray, da: np.ndarray,
                ebwt, num_reads: int, num_genomes: int, g_pad: int):
    """Plan dense clusters and pack them into fixed-shape chunks.

    Returns ``(chunks, left_starts, left_lens)``: a list of
    ``(ridx, gidx, cmap, rid)`` numpy tuples — each a complete, statically
    shaped dispatch — plus the clusters the identity could not express.
    """
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    if len(starts) == 0:
        return [], starts, lens
    (rid, cmap, rb, rpf, gcl, ggf, ent_off, rt_off, gt_off,
     valid) = native.plan_dense(
        starts, lens, da, ebwt, num_reads, num_reads + num_genomes,
        SYMBOL_RANK_LUT, K=K, PR=PR, max_ent=MAX_ENT)
    nsym = 4 if ebwt is not None else 1
    f = nsym * K
    n = len(starts)
    rid_flat = rid.reshape(-1)
    chunks = []
    c0 = 0
    while c0 < n:
        c1 = int(min(
            np.searchsorted(ent_off, ent_off[c0] + B_BLK, side="right") - 1,
            np.searchsorted(rt_off, rt_off[c0] + RT_CAP, side="right") - 1,
            np.searchsorted(gt_off, gt_off[c0] + GT_CAP, side="right") - 1,
            c0 + C_BLK, n))
        if c1 <= c0:  # single cluster exceeds a cap — planner bounds forbid
            raise AssertionError("dense cluster exceeds chunk caps")
        e0, e1 = int(ent_off[c0]), int(ent_off[c1])
        r0, r1 = int(rt_off[c0]), int(rt_off[c1])
        g0, g1 = int(gt_off[c0]), int(gt_off[c1])
        if e1 == e0:
            c0 = c1
            continue
        ridx = np.full(_pad_p2(r1 - r0), B_BLK * PR * f, np.int32)
        ridx[:r1 - r0] = (rb[r0:r1] - e0) * (PR * f) + rpf[r0:r1]
        gidx = np.full(_pad_p2(g1 - g0), C_BLK * g_pad * f, np.int32)
        gidx[:g1 - g0] = (gcl[g0:g1] - c0) * (g_pad * f) + ggf[g0:g1]
        cmap_c = np.zeros(B_BLK, np.int32)
        cmap_c[:e1 - e0] = cmap[e0:e1] - c0
        # pad entries and unused read lanes (the planner marks them with
        # the num_reads drop row) carry all-zero rows: skip them
        rid_c = np.full(B_BLK * PR, SCATTER_DROP, np.int32)
        lanes = rid_flat[e0 * PR:e1 * PR]
        rid_c[:len(lanes)] = np.where(lanes == num_reads, SCATTER_DROP,
                                      lanes)
        chunks.append((ridx, gidx, cmap_c, rid_c))
        c0 = c1
    bad = ~valid
    return chunks, starts[bad], lens[bad]


def dense_score_into(sim, starts: np.ndarray, lens: np.ndarray,
                     da: np.ndarray, ebwt, num_reads: int,
                     num_genomes: int, g_pad: int
                     ) -> Tuple[jax.Array, np.ndarray, np.ndarray]:
    """Accumulate dense-cluster scores into the device matrix ``sim``.

    ``sim`` is the (out_rows >= num_reads+1, g_pad) accumulator with the
    scatter drop row at index ``num_reads``.  Returns ``(sim, left_starts,
    left_lens)`` — the clusters the identity could not express, for the
    exact host scorer.  Dispatches are asynchronous; the returned array is
    a device future.
    """
    chunks, left_s, left_l = pack_chunks(starts, lens, da, ebwt, num_reads,
                                         num_genomes, g_pad)
    f = (4 if ebwt is not None else 1) * K
    for ridx, gidx, cmap_c, rid_c in chunks:
        sim = _dense_chunk(sim, jnp.asarray(ridx), jnp.asarray(gidx),
                           jnp.asarray(cmap_c), jnp.asarray(rid_c),
                           B_BLK, C_BLK, PR, f, g_pad)
    return sim, left_s, left_l
