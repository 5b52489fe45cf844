"""Vectorized numpy eBWT/LCP/DA builder (prefix doubling).

Builds the merged-collection index the reference obtains from
BCR + egsa + eGap (Preprocessing.sh:81-196) in one pass:

1. Concatenate all sequences, giving the terminator of sequence i the
   integer rank i and nucleotide byte b the rank num_seqs + b, so
   terminators sort first and in document order (the BCR/eGap convention).
2. Suffix array by prefix doubling: log2(max_len) rounds of lexsort.
   Terminators are globally unique so ranks separate quickly.
3. LCP from the doubling rank history: for every adjacent suffix pair walk
   the rank tables from the largest power of two down, extending the match
   greedily — an O(n log n) fully vectorized alternative to Kasai's
   inherently sequential scan.
4. eBWT byte = previous character in the same sequence, cyclically: '$'
   (0x24) when the suffix starts a sequence.  DA = owning document.

This builder is the portable reference path; `lime_tpu.index.native`
provides the C++ SA-IS path for large collections, and the same doubling
algorithm runs on the device in `lime_tpu.index.tpu_builder`.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..constants import DT_DOC, DT_LCP, DT_SYMBOL
from ..formats.arrays import write_index_arrays
from ..formats.fasta import read_fasta

TERMINATOR_BYTE = ord("$")


def _initial_ranks(seqs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenated rank array + per-position doc ids + seq-start mask."""
    num_seqs = len(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    total = int((lens + 1).sum())
    ranks = np.empty(total, dtype=np.int64)
    docs = np.empty(total, dtype=np.int64)
    starts = np.zeros(total, dtype=bool)
    offset = 0
    for i, s in enumerate(seqs):
        arr = np.frombuffer(s, dtype=np.uint8).astype(np.int64)
        ranks[offset:offset + len(s)] = num_seqs + arr
        ranks[offset + len(s)] = i  # unique terminator rank, doc order
        docs[offset:offset + len(s) + 1] = i
        starts[offset] = True
        offset += len(s) + 1
    return ranks, docs, starts


def _suffix_array_doubling(ranks: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Prefix-doubling suffix array; returns (sa, rank history by level)."""
    n = len(ranks)
    # Dense initial ranks (prefix length 1 = 2^0).
    rank = np.unique(ranks, return_inverse=True)[1].astype(np.int64)
    history = [rank]
    if n == 1:
        return np.zeros(1, dtype=np.int64), history
    k = 1
    order = np.argsort(rank, kind="stable")
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[:n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1, r2 = rank[order], key2[order]
        changed = np.empty(n, dtype=bool)
        changed[0] = True
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(changed) - 1
        rank = new_rank
        history.append(rank)
        if rank[order[-1]] == n - 1:  # all ranks distinct
            break
        k *= 2
    return order, history


def _lcp_from_history(sa: np.ndarray, history: List[np.ndarray]) -> np.ndarray:
    """LCP of adjacent suffix pairs via greedy binary decomposition."""
    n = len(sa)
    lcp = np.zeros(n, dtype=np.int64)
    if n < 2:
        return lcp
    a = sa[:-1].copy()
    b = sa[1:].copy()
    acc = np.zeros(n - 1, dtype=np.int64)
    for level in range(len(history) - 1, -1, -1):
        span = 1 << level
        rank_l = history[level]
        ok = (a + span <= n) & (b + span <= n)
        # Positions past the end can never match a full block.
        ia = np.where(ok, a, 0)
        ib = np.where(ok, b, 0)
        match = ok & (rank_l[ia] == rank_l[ib])
        acc += np.where(match, span, 0)
        a += np.where(match, span, 0)
        b += np.where(match, span, 0)
    lcp[1:] = acc
    return lcp


def _check_build_memory(total_positions: int, engine: str) -> None:
    """Fail early with a clear message instead of OOMing mid-build.

    The in-process builders are RAM-bound: the native SA-IS holds ~40
    bytes/position of i64 temporaries (recursion included), the numpy
    doubling builder ~8 bytes/position per doubling level (log2(maxlen)
    levels).  The reference sidesteps this with external-memory tools
    (eGap --em -m 4096, reference Preprocessing.sh:159-196); collections
    beyond available RAM should be indexed by those tools and ingested via
    ``lime-tpu gesa-convert`` (tested interop, tests/test_gesa.py).
    """
    per_pos = 40 if engine in ("native", "auto") else 260
    need = total_positions * per_pos
    try:
        avail = (os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError):  # pragma: no cover - platform dependent
        return
    if need > avail * 0.9:
        raise MemoryError(
            f"in-process index build needs ~{need / 1e9:.1f} GB "
            f"({total_positions / 1e6:.0f}M positions x ~{per_pos} B) but "
            f"only {avail / 1e9:.1f} GB RAM is available.  Use the "
            "blockwise external builder "
            "(lime_tpu.index.external.build_index_files_external — the "
            "preprocess driver falls back to it automatically), or "
            "ingest an eGap-built index via `lime-tpu gesa-convert`.")


def build_index(seqs: Sequence[bytes], engine: str = "numpy"
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build (ebwt, lcp, da) for the merged collection of ``seqs``.

    Documents are numbered by position in ``seqs`` — callers put reads first
    and genomes after, matching the document-id convention everything
    downstream relies on (reference src/ClusterLCP.cpp:20-23).

    ``engine``: 'numpy' (portable prefix doubling), 'native' (C++ SA-IS),
    'tpu' (prefix doubling with on-device sorts), or 'auto' (native when a
    toolchain is available).  Collections that exceed available RAM raise
    MemoryError up front (see :func:`_check_build_memory`).
    """
    _check_build_memory(sum(len(s) + 1 for s in seqs), engine)
    if engine == "tpu":
        from .tpu_builder import build_index_tpu
        return build_index_tpu(seqs)
    if engine != "numpy":
        from .. import native
        if native.available():
            return native.build_index_native(list(seqs))
        if engine == "native":
            raise RuntimeError("native index builder unavailable "
                               "(no C++ toolchain)")
    if not seqs:
        return (np.empty(0, DT_SYMBOL), np.empty(0, DT_LCP), np.empty(0, DT_DOC))
    ranks, docs, seq_start = _initial_ranks(seqs)
    sa, history = _suffix_array_doubling(ranks)
    lcp = _lcp_from_history(sa, history)

    concat = np.empty(len(ranks), dtype=np.uint8)
    num_seqs = len(seqs)
    is_term = ranks < num_seqs
    concat[~is_term] = (ranks[~is_term] - num_seqs).astype(np.uint8)
    concat[is_term] = TERMINATOR_BYTE

    prev = np.where(seq_start[sa], TERMINATOR_BYTE, concat[np.maximum(sa - 1, 0)])
    # A suffix that starts a sequence takes the sequence's own terminator as
    # its (cyclic) preceding character; seq_start[sa] guards sa-1 underflow.
    ebwt = prev.astype(DT_SYMBOL)
    da = docs[sa].astype(DT_DOC)
    return ebwt, lcp.astype(DT_LCP), da


def build_index_files(fasta_path: str, seqs: Sequence[bytes],
                      max_lcp: int | None = None,
                      engine: str = "auto") -> int:
    """Build and write ``.ebwt``/``.lcp``/``.da`` next to ``fasta_path``.

    ``max_lcp`` caps stored LCP values like eGap's ``--trlcp k``
    (Preprocessing.sh:24-28) — safe whenever ``max_lcp >= alpha``.
    Returns the number of index rows.
    """
    ebwt, lcp, da = build_index(seqs, engine=engine)
    if max_lcp is not None:
        lcp = np.minimum(lcp, max_lcp).astype(DT_LCP)
    write_index_arrays(fasta_path, ebwt, lcp, da)
    return len(ebwt)


def merge_collections(read_fastas: Sequence[str], genome_fasta: str,
                      out_fasta_path: str, max_lcp: int | None = None,
                      ) -> Tuple[int, int]:
    """Build the merged reads∪genomes index for one collection file.

    Equivalent to the eGap merge step (Preprocessing.sh:159-196) but built
    directly from FASTA.  Returns (num_reads, num_genomes).
    """
    seqs: List[bytes] = []
    for rf in read_fastas:
        seqs.extend(read_fasta(rf)[1])
    num_reads = len(seqs)
    genomes = read_fasta(genome_fasta)[1]
    seqs.extend(genomes)
    build_index_files(out_fasta_path, seqs, max_lcp=max_lcp)
    return num_reads, len(genomes)
