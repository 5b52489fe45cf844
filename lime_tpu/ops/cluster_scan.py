"""Alpha-cluster detection (pipeline step 1).

Semantics (reference src/ClusterLCP.cpp:14-43, 191-264): scanning positions
i = 1..n-1, a cluster opens at the first i with lcp[i] >= alpha and covers
rows [i-1, j-1] where j is the first subsequent position with lcp[j] < alpha;
the emitted record is (p_start = i-1, len = j-i+1).  A cluster is kept only
if its rows contain at least one read (da < num_reads) and one genome.

Equivalent formulation used here (and by the device kernel): let
m[i] = lcp[i] >= alpha with m[0] forced False (lcp[0] is 0 by construction —
the reference's leading-skip at ClusterLCP.cpp:196-202 makes any lcp[0] >=
alpha prefix unreachable anyway).  Clusters are the maximal runs [s, e] of m
extended one row left: rows [s-1, e].  Membership tests become range-sums of
the read indicator — a pure segmented-scan, which is why this maps onto a
single streaming pass at HBM bandwidth instead of the reference's chunked
byte-range threading with straddle handling (ClusterLCP.cpp:243-264).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats.arrays import AuxMetadata


def find_clusters(lcp: np.ndarray, da: np.ndarray, num_reads: int,
                  alpha: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (p_start, lens) int64 arrays of kept alpha-clusters, in order."""
    n = len(lcp)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    m = lcp >= alpha
    m[0] = False

    mi = m.astype(np.int8)
    d = np.diff(mi)
    run_starts = np.flatnonzero(d == 1) + 1  # first i of each run
    run_ends = np.flatnonzero(d == -1) + 1  # one past last i of each run
    if m[-1]:
        run_ends = np.append(run_ends, n)

    p_start = run_starts - 1
    lens = run_ends - p_start  # rows [p_start, run_end-1]

    # Membership: count reads among rows [p_start, run_end).
    is_read = (da < num_reads).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(is_read)])
    n_reads_in = csum[run_ends] - csum[p_start]
    keep = (n_reads_in > 0) & (n_reads_in < lens)
    return p_start[keep], lens[keep]


def cluster_metadata(p_start: np.ndarray, lens: np.ndarray, num_reads: int,
                     num_genomes: int, alpha: int) -> AuxMetadata:
    return AuxMetadata(
        num_reads=num_reads,
        num_genomes=num_genomes,
        alpha=alpha,
        max_len=int(lens.max()) if len(lens) else 0,
        n_clusters=int(len(lens)),
    )
