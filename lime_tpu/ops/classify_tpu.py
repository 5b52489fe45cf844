"""Device executor for the classification cascade.

jit-compiled port of :mod:`.classify_ops` — the same 4-stage masked-reduction
cascade over a dense (block, files, genomes) tensor, with genomes padded to
a 128-lane width.  float32 op-for-op with the host path (and therefore
with the reference), since every comparison/sum keeps the same association
order.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import NUM_RANKS
from .classify_ops import TYPE_A, TYPE_C, TYPE_H, TYPE_U, ClassifyResult


def _unanimous(tax: jnp.ndarray, mask: jnp.ndarray):
    """(all masked entries share one value & any, that value). tax: (T,) u32."""
    t = tax[None, :]
    tmin = jnp.min(jnp.where(mask, t, jnp.uint32(0xFFFFFFFF)), axis=1)
    tmax = jnp.max(jnp.where(mask, t, jnp.uint32(0)), axis=1)
    any_ = jnp.any(mask, axis=1)
    return any_ & (tmin == tmax), tmax


def cascade_core(dense, max_sim, tax, rank_matrix, valid_t, error,
                 num_file: int, tax_rank: int, assign_higher: bool):
    """Pure-jnp cascade body — reused by the sharded pipeline."""
    B = dense.shape[0]
    neg = jnp.float32(-1.0)
    types = jnp.zeros(B, dtype=jnp.int8)
    out_tax = jnp.zeros(B, dtype=jnp.uint32)
    out_sim = jnp.zeros(B, dtype=jnp.float32)

    highest = jnp.max(max_sim, axis=1)
    present = highest > 0

    # Stage 1
    top_file = (max_sim > 0) & ((highest[:, None] - max_sim) < error)
    cand = (((max_sim[:, :, None] - dense) < error) & (dense > 0)
            & top_file[:, :, None])
    cand1 = jnp.any(cand, axis=1)
    uni1, tax1 = _unanimous(tax, cand1)
    s1 = present & uni1
    types = jnp.where(s1, TYPE_C, types)
    out_tax = jnp.where(s1, tax1, out_tax)
    out_sim = jnp.where(s1, highest, out_sim)
    undecided = present & jnp.logical_not(uni1)

    # Mate-pairing sums
    if num_file == 4:
        pair0 = dense[:, 0] + dense[:, 3]
        pair1 = dense[:, 1] + dense[:, 2]
    else:
        pair0 = dense[:, 0]
        pair1 = dense[:, 1]

    # Stage 2
    has_c = jnp.any(cand1, axis=1)
    maxsum0 = jnp.where(has_c, jnp.max(jnp.where(cand1, pair0, neg), axis=1),
                        jnp.float32(0))
    maxsum1 = jnp.where(has_c, jnp.max(jnp.where(cand1, pair1, neg), axis=1),
                        jnp.float32(0))
    win0 = maxsum0 > maxsum1 + error
    win1 = maxsum1 > maxsum0 + error
    uni2_0, tax2_0 = _unanimous(tax, cand1 & (pair0 == maxsum0[:, None]))
    uni2_1, tax2_1 = _unanimous(tax, cand1 & (pair1 == maxsum1[:, None]))
    s2_0 = undecided & win0 & uni2_0
    s2_1 = undecided & win1 & uni2_1
    types = jnp.where(s2_0, TYPE_C, jnp.where(s2_1, TYPE_C, types))
    out_tax = jnp.where(s2_0, tax2_0, jnp.where(s2_1, tax2_1, out_tax))
    out_sim = jnp.where(s2_0, maxsum0, jnp.where(s2_1, maxsum1, out_sim))
    undecided = undecided & jnp.logical_not(s2_0 | s2_1)

    # Stage 3 (Exam_2 over all genomes)
    h0 = jnp.max(pair0, axis=1)
    h1 = jnp.max(pair1, axis=1)
    h = jnp.maximum(h0, h1)
    # valid_t masks out lane padding — the reference's Exam_2 candidate set
    # ranges over real genomes only, and with beta < ERROR a zero-score
    # padded column could otherwise slip into the set.
    gen0 = ((h0[:, None] - pair0) < error) & valid_t[None, :]
    gen1 = ((h1[:, None] - pair1) < error) & valid_t[None, :]
    gen = jnp.where((h0 > h1)[:, None], gen0,
                    jnp.where((h0 < h1)[:, None], gen1, gen0 | gen1))
    uni3, tax3 = _unanimous(tax, gen)
    s3 = undecided & uni3
    types = jnp.where(s3, TYPE_C, types)
    out_tax = jnp.where(s3, tax3, out_tax)
    out_sim = jnp.where(s3, h, out_sim)
    ambiguous = undecided & jnp.logical_not(uni3)

    # Stage 4
    if assign_higher:
        remaining = ambiguous
        for level in range(max(tax_rank - 1, 0), NUM_RANKS):
            uniH, taxH = _unanimous(rank_matrix[level], gen)
            okay = remaining & uniH & (taxH != 0)
            types = jnp.where(okay, TYPE_H, types)
            out_tax = jnp.where(okay, taxH, out_tax)
            out_sim = jnp.where(okay, h, out_sim)
            remaining = remaining & jnp.logical_not(okay)
        types = jnp.where(remaining, TYPE_A, types)
    else:
        types = jnp.where(ambiguous, TYPE_A, types)

    return types, out_tax, out_sim


def blockwise_cascade(sims, tax, rank_matrix, valid_t, error, norm, beta,
                      num_files: int, tax_rank: int, assign_higher: bool,
                      is_mod: bool, block: int):
    """Counter wrap + normalize + beta gate + cascade over (F, R_pad, G_pad).

    Walks read blocks so only one (block, F, G_pad) float32 tile is live at
    a time — the paper-scale memory plan (the reference keeps the whole
    numReads x numRefs uchar matrix + per-read rescans, src/Classify.cpp).
    ``is_mod``: sims is an int8 accumulator whose bits are the mod-256
    counters (cast through uint8); otherwise plain integer counts.
    R_pad must be a multiple of ``block``.
    """
    from jax import lax

    F, r_pad, g_pad = sims.shape
    n_blocks = r_pad // block
    types0 = jnp.zeros(r_pad, jnp.int8)
    tax0 = jnp.zeros(r_pad, jnp.uint32)
    sim0 = jnp.zeros(r_pad, jnp.float32)

    def body(b, carry):
        ty, tx, sv = carry
        blk = lax.dynamic_slice(sims, (0, b * block, 0), (F, block, g_pad))
        x = (blk.astype(jnp.uint8) if is_mod else blk).astype(jnp.float32)
        norm_rows = x / norm
        rowmax = jnp.max(norm_rows, axis=2)  # (F, block)
        qualify = rowmax > beta
        dense = jnp.transpose(
            jnp.where(qualify[:, :, None], norm_rows, 0.0), (1, 0, 2))
        maxs = jnp.where(qualify, rowmax, 0.0).T
        t, x_, s = cascade_core(dense, maxs, tax, rank_matrix, valid_t,
                                error, num_files, tax_rank, assign_higher)
        return (lax.dynamic_update_slice(ty, t, (b * block,)),
                lax.dynamic_update_slice(tx, x_, (b * block,)),
                lax.dynamic_update_slice(sv, s, (b * block,)))

    return lax.fori_loop(0, n_blocks, body, (types0, tax0, sim0))


def classify_block_size(rows: int) -> int:
    """Static read-block size for :func:`blockwise_cascade`."""
    want = 1 << 14
    if rows >= want:
        return want
    b = 256
    while b < rows:
        b <<= 1
    return b


def pad_rows_for(rows: int) -> int:
    block = classify_block_size(rows)
    return -(-rows // block) * block


_cascade = jax.jit(cascade_core,
                   static_argnames=("num_file", "tax_rank", "assign_higher"))


def classify_reads_tpu(dense: np.ndarray, max_sim: np.ndarray,
                       tax: np.ndarray, rank_matrix: np.ndarray | None,
                       tax_rank: int, error: np.float32,
                       assign_higher: bool) -> ClassifyResult:
    """Drop-in device equivalent of :func:`classify_ops.classify_reads`."""
    B, F, T = dense.shape
    # No host-side lane padding — XLA pads internally, and shipping padded
    # tensors through the host->device link costs real bandwidth.
    rm = (jnp.asarray(rank_matrix) if rank_matrix is not None
          else jnp.zeros((NUM_RANKS, T), jnp.uint32))
    valid_t = np.ones(T, dtype=bool)
    types, out_tax, out_sim = _cascade(
        jnp.asarray(dense), jnp.asarray(max_sim), jnp.asarray(tax), rm,
        jnp.asarray(valid_t), jnp.float32(error), F, tax_rank, assign_higher)
    return ClassifyResult(np.asarray(types), np.asarray(out_tax),
                          np.asarray(out_sim))
