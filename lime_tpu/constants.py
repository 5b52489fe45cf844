"""Shared constants and dtypes for lime-tpu.

Accelerator-native re-design of the reference's shared header (reference:
src/Tools.h:31-110).  The compile-time typedef knobs of the reference
(``dataTypeSim``/``dataTypeNSeq``/... , Tools.h:43-75) become runtime numpy
dtypes here; the compile-time ``-D`` defines of the reference Makefile become
fields of :class:`lime_tpu.config.LimeConfig`.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Scalar dtypes of the on-disk index arrays (reference src/Tools.h:43-75).
# ---------------------------------------------------------------------------
DT_SYMBOL = np.dtype("u1")  # dataTypedimAlpha — eBWT symbol byte
DT_LCP = np.dtype("<u4")  # dataTypelenSeq   — LCP value
DT_DOC = np.dtype("<u4")  # dataTypeNSeq     — document id
DT_POS = np.dtype("<u8")  # dataTypeNChar    — position in the eBWT
DT_SIM_U8 = np.dtype("u1")  # dataTypeSim (default, reads <= 255bp)
DT_SIM_U32 = np.dtype("<u4")  # dataTypeSim with dataTypeNumSim=1

# Record dtypes of the intermediate binary artifacts.
# .clrs — one record per alpha-cluster (reference src/Tools.h:85-88)
DT_CLUSTER = np.dtype([("p_start", "<u8"), ("len", "<u8")])
# .res.bin — one record per (score-list header | list entry)
# (reference src/Tools.h:95-98)
DT_PAIR_SIM = np.dtype([("sim", "<f4"), ("id_ref", "<u4")])
# .res.pos — one u64 record-offset per read
DT_RES_POS = np.dtype("<u8")

# ---------------------------------------------------------------------------
# Algorithm constants (reference src/Tools.h:31-39).
# ---------------------------------------------------------------------------
ERROR_TOLERANCE = np.float32(0.02)  # tie tolerance in the classify cascade
ALPHABET_SIZE = 16  # ALF — IUPAC alphabet width
MAX_CLUSTER_LEN = 65536  # sizeMaxBuf — hard cap on cluster length
SIM_SATURATE_U8 = 255  # USim_MAX for the default u8 counters

# Taxonomic ranks: columns of the lineage CSV
# (reference src/Classify.cpp:10-13).  Rank 0 = genome identity.
NUM_RANKS = 6
RANK_NAMES = ("Genome", "Species", "Genus", "Family", "Order", "Class", "Phylum")

# ---------------------------------------------------------------------------
# IUPAC symbol mapping (reference src/ClusterBWT_DA.cpp:455-487).
#
# The reference maps eBWT bytes through an unordered_map whose operator[]
# default-inserts rank 0 for any byte not in the table — so '$', '#',
# lowercase letters, etc. all behave as rank 0 ('A').  We reproduce that with
# a dense 256-entry LUT initialised to 0.
# ---------------------------------------------------------------------------
IUPAC_ORDER = "ACGTRYSWKMBDHVN"  # ranks 0..14; rank 15 is '\0'

SYMBOL_RANK_LUT = np.zeros(256, dtype=np.uint8)
for _r, _c in enumerate(IUPAC_ORDER):
    SYMBOL_RANK_LUT[ord(_c)] = _r
SYMBOL_RANK_LUT[0] = 15  # '\0' -> 15

# umapIUPACcorr: which of A/C/G/T (columns) each rank (row) can represent
# (reference src/ClusterBWT_DA.cpp:472-487).
IUPAC_COMPAT = np.zeros((ALPHABET_SIZE, 4), dtype=bool)
_COMPAT_SETS = {
    0: "A", 1: "C", 2: "G", 3: "T",
    4: "AG", 5: "CT", 6: "CG", 7: "AT", 8: "GT", 9: "AC",
    10: "CGT", 11: "AGT", 12: "ACT", 13: "ACG", 14: "ACGT",
}
for _r, _s in _COMPAT_SETS.items():
    for _c in _s:
        IUPAC_COMPAT[_r, "ACGT".index(_c)] = True

# Ordered list of (acgt_rank, degenerate_rank) pairs visited by the
# reference's leftover-matching waterfall (src/ClusterBWT_DA.cpp:146-177):
# outer loop i in 0..3 over A/C/G/T, inner loop a in 4..14 over degenerate
# codes, visiting only compatible pairs.
IUPAC_WATERFALL_PAIRS = tuple(
    (i, a) for i in range(4) for a in range(4, ALPHABET_SIZE - 1) if IUPAC_COMPAT[a, i]
)

# Default streaming block size (positions per device block) for the fused
# scan+score pass.  The reference streams 1 MiB LCP buffers (Tools.h:31); on
# the device we stream much larger blocks straight from device memory.
DEFAULT_BLOCK_POSITIONS = 1 << 22

# Scatter index past every device buffer.  Updates that must not land
# (genome-side and pad rows, zero-valued entries) go here under
# mode="drop" and are skipped, instead of piling onto one shared dummy
# cell: on a GPU the updates to one cell serialize on its atomic, and
# millions of them on one cell stall the whole scatter.
SCATTER_DROP = 2**31 - 1
