"""Multi-host scaffolding: distributed init + per-host index-range loading.

The reference scales across cores by giving every OpenMP thread a private
FILE* and a byte range of the ``.lcp``/``.da`` files, with a straddle
protocol at range boundaries (reference src/ClusterLCP.cpp:100-167,
196-264).  Across hosts the same decomposition applies: every host memmaps
only its position range of the index (plus the straddle extension), plans
it locally, and the per-host compact streams concatenate — in host order —
into exactly the stream a single host would have planned.

``extend_range_to_cluster_boundaries`` is the straddle protocol:

- skip-leading: a range that starts inside an alpha-run advances to the
  first position with ``lcp < alpha`` — those positions belong to the
  previous host's open cluster (ClusterLCP.cpp:196-202).  The boundary row
  itself starts the range: it closes the previous cluster and is the
  ``p_start`` row of any cluster opening right after it.
- read-past-end: a range whose end falls inside an alpha-run extends until
  the run closes (ClusterLCP.cpp:243-264), so the straddling cluster is
  planned exactly once, by the host that opened it.

Real multi-pod runs initialize JAX's distributed runtime via
:func:`init_distributed` (env-driven; a no-op for one process) and pass
each host's planned slice to `jax.make_array_from_process_local_data`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize jax.distributed from args or environment; idempotent.

    Reads ``LIME_COORDINATOR`` / ``LIME_NUM_PROCESSES`` / ``LIME_PROCESS_ID``
    (or the standard JAX env vars) when args are None.  Returns
    ``(process_id, num_processes)``; ``(0, 1)`` for a single-process run.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "LIME_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LIME_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("LIME_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if coordinator_address and num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index(), jax.process_count()


def host_position_range(n_positions: int, num_hosts: int, host_idx: int
                        ) -> Tuple[int, int]:
    """Even [lo, hi) split of the position stream (pre-straddle)."""
    if not 0 <= host_idx < num_hosts:
        raise ValueError(f"host {host_idx} not in [0, {num_hosts})")
    per = -(-n_positions // num_hosts)
    lo = min(host_idx * per, n_positions)
    return lo, min(lo + per, n_positions)


def extend_range_to_cluster_boundaries(lcp: np.ndarray, lo: int, hi: int,
                                       alpha: int) -> Tuple[int, int]:
    """Apply the straddle protocol to [lo, hi) (see module docstring).

    ``lcp`` may be a memmap — only positions near the boundaries are
    touched.  The returned range starts at a position with
    ``lcp < alpha`` (or 0) and ends right after the last run closes (or at
    n), so planning it standalone reproduces the whole-file cluster set for
    the covered region.
    """
    n = len(lcp)
    lo, hi = max(0, lo), min(n, hi)
    while lo > 0 and lo < n and lcp[lo] >= alpha:
        lo += 1  # skip-leading: in-run rows belong to the previous host
    while hi < n and lcp[hi] >= alpha:
        hi += 1  # read-past-end: close the straddling cluster locally
    return lo, hi


def plan_host_range_pairs(fasta_path: str, num_reads: int,
                          num_genomes: int, alpha: int, num_hosts: int,
                          host_idx: int, use_ebwt: bool = True,
                          dense_min: int = 16, dp: int = 1,
                          rows_local: int = 0):
    """Packed pair-stream plan of this host's range of a collection.

    The pair-engine counterpart of :func:`plan_host_range`: only this
    host's byte range (straddle-extended) is faulted in and planned with
    lime_plan_pairs_packed.  Chunks are copy-aligned and carry global
    read-row ids, so per-host chunk sets simply union; the straddle
    protocol guarantees each cluster is planned by exactly one host.
    Returns ``(arrays, chunks, windows, row_bits, dense_start, dense_len,
    bad_start, bad_len)`` with GLOBAL cluster positions in the routing
    lists.
    """
    from ..constants import SYMBOL_RANK_LUT
    from ..formats.arrays import open_da, open_ebwt, open_lcp
    from ..ops.fused_pass import _DEGENERATE_BYTE
    from .. import native

    lcp = open_lcp(fasta_path, mmap=True)
    lo, hi = host_position_range(len(lcp), num_hosts, host_idx)
    lo, hi = extend_range_to_cluster_boundaries(lcp, lo, hi, alpha)
    if hi <= lo:
        empty = np.empty(0, np.int64)
        return ((np.empty(0, np.uint32), np.empty(0, np.uint8),
                 np.empty(0, np.uint16)), [], (1, 1, 1),
                native.row_bits_for(num_reads), empty, empty, empty,
                empty)
    lcp_s = np.ascontiguousarray(lcp[lo:hi])
    da_s = np.ascontiguousarray(open_da(fasta_path, mmap=True)[lo:hi])
    eb_s = (np.ascontiguousarray(open_ebwt(fasta_path, mmap=True)[lo:hi])
            if use_ebwt else None)
    (arrays, chunks, windows, W, den_s, den_l, bad_s,
     bad_l) = native.plan_pairs_packed(
        lcp_s, da_s, eb_s, num_reads, alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE.astype(np.uint8), dense_min=dense_min,
        num_refs=num_genomes, dp=dp, rows_local=rows_local)
    return (arrays, chunks, windows, W, den_s + lo, den_l, bad_s + lo,
            bad_l)


def plan_host_range(fasta_path: str, num_reads: int, num_genomes: int,
                    alpha: int, num_hosts: int, host_idx: int,
                    use_ebwt: bool = True, g_dense: int = 0,
                    use_u16: bool = False):
    """Plan this host's range of a collection from memmapped index files.

    Only this host's byte range (plus the straddle extension) is ever
    faulted in — the multi-host analogue of the reference's per-thread fseek
    ranges (src/ClusterLCP.cpp:100-167).  Returns
    ``(packed, doc, window, bad_start, bad_len, (lo, hi))`` where
    bad_start holds GLOBAL positions and concatenating the per-host
    ``packed``/``doc`` in host order equals the whole-file plan.
    """
    from ..constants import SYMBOL_RANK_LUT
    from ..formats.arrays import open_da, open_ebwt, open_lcp
    from ..ops.fused_pass import _DEGENERATE_BYTE
    from .. import native

    lcp = open_lcp(fasta_path, mmap=True)
    lo, hi = host_position_range(len(lcp), num_hosts, host_idx)
    lo, hi = extend_range_to_cluster_boundaries(lcp, lo, hi, alpha)
    if hi <= lo:
        z16 = np.uint16 if use_u16 else np.uint32
        return (np.empty(0, np.uint8), np.empty(0, z16), 1,
                np.empty(0, np.int64), np.empty(0, np.int64), (lo, hi))

    lcp_s = np.ascontiguousarray(lcp[lo:hi])
    if lo > 0:
        # a range headed by a sub-alpha row never re-opens at index 0; the
        # planner's skip-of-position-0 rule must not also suppress a
        # cluster that OPENS at global position lo+1 — it doesn't, because
        # opening happens at i>=1 and p_start = i-1 = 0 maps to global lo.
        lcp_s = lcp_s.copy()
    da_s = np.ascontiguousarray(open_da(fasta_path, mmap=True)[lo:hi])
    eb_s = (np.ascontiguousarray(open_ebwt(fasta_path, mmap=True)[lo:hi])
            if use_ebwt else None)

    if not native.available():
        raise RuntimeError("per-host planning requires the native library")
    packed, doc, nc, window, bad_s, bad_l, _, _ = native.plan_native(
        lcp_s, da_s, eb_s, num_reads, alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE, use_u16=use_u16, pad_block=1,
        pad_doc=num_reads + num_genomes, g_dense=g_dense)
    return packed, doc, window, bad_s + lo, bad_l, (lo, hi)
