"""Read classification (pipeline step 3) — vectorized cascade.

Per read, merges the score lists of 2 (single-end: 1F, 1RC) or 4 (paired-end:
1F, 1RC, 2F, 2RC) result files into one assignment via the reference's
4-stage cascade (src/Classify.cpp:474-689), fully vectorized over reads:

- U: every file's max similarity is 0 (read absent everywhere).
- Stage 1: files whose max is within ERROR of the global max contribute
  candidate genomes (those within ERROR of that file's own max); if all
  candidates map to one taxid -> C at the global max.
- Stage 2: over the stage-1 candidates, build the two mate-pairing sums
  (file0+file3 and file1+file2 when paired); if one pairing beats the other
  by more than ERROR and its exact argmax maps to a single taxid -> C.
- Stage 3: same pairing sums over ALL genomes (src/Classify.cpp:171-260,
  Exam_2); genomes within ERROR of the winning pairing's max form the final
  candidate set; single taxid -> C.
- Stage 4: with assign_higher, ascend the lineage and emit H at the first
  rank where all candidates agree on a nonzero taxid, else A
  (src/Classify.cpp:262-302).

All arithmetic is float32 in the same association order as the reference, so
assignments and reported similarities are bit-identical.

The reference's per-read heap allocations, linear find()s and fseeks
disappear: a block of reads becomes a dense (block, files, genomes) float32
tensor and every stage is a masked reduction over it — the layout the device
executor jits directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import NUM_RANKS

TYPE_U, TYPE_C, TYPE_A, TYPE_H = 0, 1, 2, 3
_TYPE_CHARS = np.array(["U", "C", "A", "H"])

_NEG = np.float32(-1.0)  # masked-out sentinel below any valid similarity


@dataclasses.dataclass
class ClassifyResult:
    """Per-read assignment arrays."""

    types: np.ndarray  # int8: TYPE_U/C/A/H
    taxid: np.ndarray  # uint32 (valid for C/H)
    sim: np.ndarray  # float32 (valid for C/H)

    def counts(self):
        return {c: int((self.types == t).sum())
                for t, c in enumerate(_TYPE_CHARS)}


def _masked_unanimous(tax: np.ndarray, mask: np.ndarray):
    """Per-row: do all masked entries of ``tax`` share one value?

    Returns (unanimous & any, value).  ``tax`` is (T,) uint32 broadcast
    against mask (B, T).
    """
    t = tax[None, :].astype(np.int64)
    big = np.int64(1) << 40
    tmin = np.where(mask, t, big).min(axis=1)
    tmax = np.where(mask, t, -1).max(axis=1)
    any_ = mask.any(axis=1)
    return any_ & (tmin == tmax), tmax.astype(np.uint32)


def classify_reads(dense: np.ndarray, max_sim: np.ndarray, tax: np.ndarray,
                   rank_matrix: np.ndarray | None, tax_rank: int,
                   error: np.float32, assign_higher: bool) -> ClassifyResult:
    """Classify a block of reads.

    - ``dense``: (B, F, T) float32 per-read/file/genome normalized scores.
    - ``max_sim``: (B, F) float32 per-file header max (0 if absent).
    - ``tax``: (T,) uint32 taxid per genome at ``tax_rank``.
    - ``rank_matrix``: (NUM_RANKS, T) taxids per rank (for assign_higher).
    """
    B, F, T = dense.shape
    error = np.float32(error)
    types = np.zeros(B, dtype=np.int8)
    out_tax = np.zeros(B, dtype=np.uint32)
    out_sim = np.zeros(B, dtype=np.float32)

    highest = max_sim.max(axis=1)
    present = highest > 0  # else U

    # ---- Stage 1: candidates from the top files --------------------------
    top_file = (max_sim > 0) & ((highest[:, None] - max_sim) < error)
    cand = ((max_sim[:, :, None] - dense) < error) & (dense > 0) \
        & top_file[:, :, None]
    cand1 = cand.any(axis=1)  # (B, T) union over top files
    uni1, tax1 = _masked_unanimous(tax, cand1)
    s1 = present & uni1
    types[s1] = TYPE_C
    out_tax[s1] = tax1[s1]
    out_sim[s1] = highest[s1]

    undecided = present & ~uni1
    if not undecided.any():
        return ClassifyResult(types, out_tax, out_sim)

    # ---- Mate-pairing sums (shared by stages 2 and 3) --------------------
    if F == 4:
        pair0 = dense[:, 0] + dense[:, 3]
        pair1 = dense[:, 1] + dense[:, 2]
    else:
        pair0 = dense[:, 0]
        pair1 = dense[:, 1]

    # ---- Stage 2: pairing max over stage-1 candidates --------------------
    p0c = np.where(cand1, pair0, _NEG)
    p1c = np.where(cand1, pair1, _NEG)
    maxsum0 = np.where(cand1.any(axis=1), p0c.max(axis=1), np.float32(0))
    maxsum1 = np.where(cand1.any(axis=1), p1c.max(axis=1), np.float32(0))

    win0 = maxsum0 > maxsum1 + error
    win1 = maxsum1 > maxsum0 + error
    winners0 = cand1 & (pair0 == maxsum0[:, None])
    winners1 = cand1 & (pair1 == maxsum1[:, None])
    uni2_0, tax2_0 = _masked_unanimous(tax, winners0)
    uni2_1, tax2_1 = _masked_unanimous(tax, winners1)

    s2_0 = undecided & win0 & uni2_0
    s2_1 = undecided & win1 & uni2_1
    types[s2_0] = TYPE_C
    out_tax[s2_0] = tax2_0[s2_0]
    out_sim[s2_0] = maxsum0[s2_0]
    types[s2_1] = TYPE_C
    out_tax[s2_1] = tax2_1[s2_1]
    out_sim[s2_1] = maxsum1[s2_1]

    undecided &= ~(s2_0 | s2_1)
    if not undecided.any():
        return ClassifyResult(types, out_tax, out_sim)

    # ---- Stage 3: Exam_2 over all genomes --------------------------------
    h0 = pair0.max(axis=1)
    h1 = pair1.max(axis=1)
    h = np.maximum(h0, h1)
    gen0 = (h0[:, None] - pair0) < error
    gen1 = (h1[:, None] - pair1) < error
    gen = np.where((h0 > h1)[:, None], gen0,
                   np.where((h0 < h1)[:, None], gen1, gen0 | gen1))
    uni3, tax3 = _masked_unanimous(tax, gen)
    s3 = undecided & uni3
    types[s3] = TYPE_C
    out_tax[s3] = tax3[s3]
    out_sim[s3] = h[s3]

    ambiguous = undecided & ~uni3

    # ---- Stage 4: lineage ascent or A ------------------------------------
    if assign_higher and ambiguous.any():
        if rank_matrix is None:
            raise ValueError("assign_higher requires the lineage rank matrix")
        remaining = ambiguous.copy()
        # The reference starts the ascent at column tax_rank (always
        # non-unanimous after stage 3 when the lineage is complete) and walks
        # up to Phylum (src/Classify.cpp:270-293).  Rank 0 would index
        # m_corRef[-1] — an out-of-bounds read we clamp instead.
        for level in range(max(tax_rank - 1, 0), NUM_RANKS):
            if not remaining.any():
                break
            uniH, taxH = _masked_unanimous(rank_matrix[level], gen)
            okay = remaining & uniH & (taxH != 0)
            types[okay] = TYPE_H
            out_tax[okay] = taxH[okay]
            out_sim[okay] = h[okay]
            remaining &= ~okay
        types[remaining] = TYPE_A
    else:
        types[ambiguous] = TYPE_A

    return ClassifyResult(types, out_tax, out_sim)
