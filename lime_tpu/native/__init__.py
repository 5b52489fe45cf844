"""Native C++ runtime: fast index construction via ctypes.

Builds ``liblime_native.so`` from csrc/ on first use (g++ -O3) and exposes
:func:`build_index_native`.  Falls back gracefully when no compiler is
available — callers check :func:`available`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "lime_native.cpp")
_LIB_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                        "native")
_LIB = os.path.join(_LIB_DIR, "liblime_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed, _error
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                os.makedirs(_LIB_DIR, exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                     "-fPIC", "-std=c++17", _SRC, "-o", _LIB],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_LIB)
            lib.lime_build_index.restype = ctypes.c_int64
            lib.lime_build_index.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.lime_plan.restype = ctypes.c_int64
            lib.lime_plan.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.lime_plan_pairs.restype = ctypes.c_int64
            lib.lime_plan_pairs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.lime_plan_pairs_packed.restype = ctypes.c_int64
            lib.lime_plan_pairs_packed.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.lime_plan_dense.restype = ctypes.c_int64
            lib.lime_plan_dense.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.lime_score_clusters.restype = ctypes.c_int64
            lib.lime_score_clusters.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib.lime_format_csv.restype = ctypes.c_int64
            lib.lime_format_csv.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.lime_build_index_block.restype = ctypes.c_int64
            lib.lime_build_index_block.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.lime_merge_blocks.restype = ctypes.c_int64
            lib.lime_merge_blocks.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.lime_kasai_files.restype = ctypes.c_int64
            lib.lime_kasai_files.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int64,
            ]
            lib.lime_plan_score_coo.restype = ctypes.c_int64
            lib.lime_plan_score_coo.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.lime_coo_compact.restype = ctypes.c_int64
            lib.lime_coo_compact.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.lime_plan_clusters.restype = ctypes.c_int64
            lib.lime_plan_clusters.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError,
                AttributeError) as e:
            _failed = True
            stderr = getattr(e, "stderr", None)
            _error = f"{e}" + (f": {stderr.decode(errors='replace')}"
                               if stderr else "")
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the native library did not build or load (None if it did)."""
    _load()
    return _error


def build_index_native(seqs: Sequence[bytes]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ebwt, lcp, da) for the merged collection — C++ SA-IS path."""
    concat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    return build_index_native_concat(concat, lens)


def build_index_native_concat(concat: np.ndarray, lens: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Array-input variant: all sequences back to back, no terminators."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    concat = np.ascontiguousarray(concat, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    total = int((lens + 1).sum())
    ebwt = np.empty(total, dtype=np.uint8)
    lcp = np.empty(total, dtype=np.uint32)
    da = np.empty(total, dtype=np.uint32)
    rc = lib.lime_build_index(
        concat.ctypes.data, lens.ctypes.data, len(lens),
        ebwt.ctypes.data, lcp.ctypes.data, da.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lime_build_index failed: {rc}")
    return ebwt, lcp, da


def plan_native(lcp: np.ndarray, da: np.ndarray, ebwt: np.ndarray | None,
                num_reads: int, alpha: int, sym_lut: np.ndarray,
                deg_lut: np.ndarray, use_u16: bool,
                pad_block: int = 1, pad_doc: int = 0, g_dense: int = 0,
                dense_min: int = 0,
                ) -> Tuple[np.ndarray, np.ndarray, int, int,
                           np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One C++ pass: alpha-cluster scan + membership filter + routing.

    Returns ``(packed, doc, n_compact, window, bad_start, bad_len,
    dense_start, dense_len)`` where packed/doc are the compacted
    banded-kernel stream padded to the next ``pad_block`` multiple (doc
    padding = ``pad_doc``, written at allocation so no post-pass pad copy
    is needed) and bad_start/bad_len list the clusters routed to the host
    scorer: IUPAC-degenerate, longer than 255, or with fewer than
    ``g_dense`` genome positions (density routing — the device one-hot kernel
    pays window*G_pad lanes per position regardless of hits, so
    genome-sparse clusters run faster through
    :func:`score_clusters_native`).  When ``dense_min > 0``, pure-ACGT
    clusters with at least that many genome positions are listed in
    dense_start/dense_len instead — the dense histogram-matmul class (see
    :func:`plan_dense`).  Releases the GIL for the whole pass, so
    collections plan in parallel from Python threads.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lcp = np.ascontiguousarray(lcp, dtype=np.uint32)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    eb_ptr = 0
    if ebwt is not None:
        ebwt = np.ascontiguousarray(ebwt, dtype=np.uint8)
        eb_ptr = ebwt.ctypes.data
    n = len(lcp)
    cap = max(pad_block, -(-n // pad_block) * pad_block)
    packed = np.zeros(cap, dtype=np.uint8)
    # pad ids are only needed past the compact length; filling the whole
    # capacity up front costs seconds of first-touch page faults at the
    # 10^8-position scale, so the pad slice is written after the pass
    doc = np.empty(cap, dtype=np.uint16 if use_u16 else np.uint32)
    n_clusters_cap = n // 2 + 1
    bad_start = np.empty(n_clusters_cap, dtype=np.int64)
    bad_len = np.empty(n_clusters_cap, dtype=np.int64)
    if dense_min > 0:
        dense_start = np.empty(n_clusters_cap, dtype=np.int64)
        dense_len = np.empty(n_clusters_cap, dtype=np.int64)
        ds_ptr, dl_ptr = dense_start.ctypes.data, dense_len.ctypes.data
    else:
        dense_start = dense_len = np.empty(0, dtype=np.int64)
        ds_ptr = dl_ptr = 0
    meta = np.zeros(4, dtype=np.int64)
    sym_lut = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    deg_lut = np.ascontiguousarray(deg_lut, dtype=np.uint8)
    rc = lib.lime_plan(
        lcp.ctypes.data, da.ctypes.data, eb_ptr, n, num_reads, alpha,
        g_dense, dense_min,
        sym_lut.ctypes.data, deg_lut.ctypes.data,
        packed.ctypes.data,
        doc.ctypes.data if use_u16 else 0,
        0 if use_u16 else doc.ctypes.data,
        bad_start.ctypes.data, bad_len.ctypes.data,
        ds_ptr, dl_ptr, meta.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lime_plan failed: {rc}")
    nc, window, nbad, ndense = (int(meta[0]), int(meta[1]), int(meta[2]),
                                int(meta[3]))
    n_pad = max(pad_block, -(-nc // pad_block) * pad_block)
    # the packed pad is already zero (calloc); write the doc pad ids now
    doc[nc:n_pad] = pad_doc
    return (packed[:n_pad], doc[:n_pad], nc, window,
            bad_start[:nbad].copy(), bad_len[:nbad].copy(),
            dense_start[:ndense].copy(), dense_len[:ndense].copy())


def plan_pairs(lcp: np.ndarray, da: np.ndarray, ebwt: np.ndarray | None,
               num_reads: int, alpha: int, g_pad: int,
               sym_lut: np.ndarray, deg_lut: np.ndarray,
               dense_min: int = 16):
    """One C++ pass: cluster scan + routing + pair-stream emission.

    The G-independent scoring plan (see lime_plan_pairs in csrc): sparse
    clusters become per-genome-document "copies" — packed chain/side/sym
    bytes plus a flat int32 scatter index — binned into 3 window buckets;
    genome-dense clusters and host-rescue clusters are listed separately.

    Returns ``(buckets, dense_start, dense_len, bad_start, bad_len)``
    where buckets is a list of up to 3 ``(packed, flatidx, window)``
    tuples (empty buckets omitted).  Releases the GIL for the whole pass.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if (num_reads + 1) * g_pad > 2**31 - 1:
        raise ValueError("num_reads * g_pad exceeds int32 scatter range; "
                         "use the row-blocked path")
    lcp = np.ascontiguousarray(lcp, dtype=np.uint32)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    eb_ptr = 0
    if ebwt is not None:
        ebwt = np.ascontiguousarray(ebwt, dtype=np.uint8)
        eb_ptr = ebwt.ctypes.data
    sym_lut = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    deg_lut = np.ascontiguousarray(deg_lut, dtype=np.uint8)
    n = len(lcp)
    n_clusters_cap = n // 2 + 1
    dense_start = np.empty(n_clusters_cap, dtype=np.int64)
    dense_len = np.empty(n_clusters_cap, dtype=np.int64)
    bad_start = np.empty(n_clusters_cap, dtype=np.int64)
    bad_len = np.empty(n_clusters_cap, dtype=np.int64)
    meta = np.zeros(8, dtype=np.int64)
    cap = n + n // 8 + 1024  # replication makes the size data-dependent
    for _ in range(2):
        packed = np.empty(cap, dtype=np.uint8)
        flatidx = np.empty(cap, dtype=np.int32)
        rc = lib.lime_plan_pairs(
            lcp.ctypes.data, da.ctypes.data, eb_ptr, n, num_reads, alpha,
            dense_min, g_pad, sym_lut.ctypes.data, deg_lut.ctypes.data,
            cap, packed.ctypes.data, flatidx.ctypes.data,
            dense_start.ctypes.data, dense_len.ctypes.data,
            bad_start.ctypes.data, bad_len.ctypes.data, meta.ctypes.data)
        if rc == 0:
            break
        if rc == 1:
            cap = int(meta[0])
            continue
        raise RuntimeError(f"lime_plan_pairs failed: {rc}")
    else:
        raise RuntimeError("lime_plan_pairs capacity retry failed")
    needed, ndense, nbad = int(meta[0]), int(meta[1]), int(meta[2])
    offs = [0, int(meta[6]), int(meta[7]), needed]
    buckets = []
    for b in range(3):
        lo, hi = offs[b], offs[b + 1]
        if hi > lo:
            buckets.append((packed[lo:hi], flatidx[lo:hi],
                            int(meta[3 + b])))
    return (buckets, dense_start[:ndense].copy(), dense_len[:ndense].copy(),
            bad_start[:nbad].copy(), bad_len[:nbad].copy())


def row_bits_for(num_reads: int) -> int:
    """Smallest supported packed row width holding ``num_reads``."""
    for w in (20, 24, 28):
        if num_reads <= (1 << w):
            return w
    raise ValueError("num_reads exceeds the 28-bit packed row range")


def plan_pairs_packed(lcp: np.ndarray, da: np.ndarray,
                      ebwt: np.ndarray | None, num_reads: int, alpha: int,
                      sym_lut: np.ndarray, deg_lut: np.ndarray,
                      dense_min: int = 16, chunk_pos: int = 1 << 22,
                      num_refs: int | None = None, host_num: int = 0,
                      dp: int = 1, rows_local: int = 0):
    """One C++ pass: cluster scan + routing + packed pair-chunk emission.

    The transfer-optimal pair plan (lime_plan_pairs_packed in csrc):
    3.125 bytes/row — 5 metadata bits + a W-bit row id per row, 8 rows per
    group — plus one u16 genome column per copy, pre-chunked on copy
    boundaries so the device program has a handful of static shapes.

    ``host_num`` (0..256) routes that /256 share of clusters — picked by
    a deterministic hash of the run index — to the host-scored list
    (``bad_start/bad_len``) instead of the stream: the hybrid engine's
    link-adaptive split (256 = everything host-scored, stream empty).

    Returns ``(chunks, windows, row_bits, dense_start, dense_len,
    bad_start, bad_len)`` where each chunk is
    ``(bucket, n_rows, rows_u32, bits_u8, gcol_u16)`` (array views into
    the planner's buffers) and ``windows[bucket]`` bounds that bucket's
    copy length.  Releases the GIL for the whole pass.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if num_refs is not None and num_refs > (1 << 16):
        # the per-copy genome column is u16; callers route wider genome
        # sets to the banded path (the reference's largest DB is 3,423)
        raise ValueError("packed pair streams support <= 65536 genomes")
    W = row_bits_for(num_reads)
    lcp = np.ascontiguousarray(lcp, dtype=np.uint32)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    eb_ptr = 0
    if ebwt is not None:
        ebwt = np.ascontiguousarray(ebwt, dtype=np.uint8)
        eb_ptr = ebwt.ctypes.data
    sym_lut = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    deg_lut = np.ascontiguousarray(deg_lut, dtype=np.uint8)
    n = len(lcp)
    n_clusters_cap = n // 2 + 1
    dense_start = np.empty(n_clusters_cap, dtype=np.int64)
    dense_len = np.empty(n_clusters_cap, dtype=np.int64)
    bad_start = np.empty(n_clusters_cap, dtype=np.int64)
    bad_len = np.empty(n_clusters_cap, dtype=np.int64)
    meta = np.zeros(9, dtype=np.int64)
    # replication + group/chunk padding make sizes data-dependent
    cap_w = (n + n // 8) // 8 * (W // 4) + (1 << 20)
    cap_b = (n + n // 8) // 8 * 5 + (1 << 20)
    cap_g = n // 2 + (1 << 16)
    cap_c = max(64, 2 * n // chunk_pos + 16 + 6 * dp)
    for _ in range(2):
        rows = np.empty(cap_w, dtype=np.uint32)
        bits = np.empty(cap_b, dtype=np.uint8)
        gcol = np.empty(cap_g, dtype=np.uint16)
        cmeta = np.empty(cap_c * 7, dtype=np.int64)
        rc = lib.lime_plan_pairs_packed(
            lcp.ctypes.data, da.ctypes.data, eb_ptr, n, num_reads, alpha,
            dense_min, W, chunk_pos, host_num, dp, rows_local,
            sym_lut.ctypes.data, deg_lut.ctypes.data,
            cap_w, cap_b, cap_g, cap_c,
            rows.ctypes.data, bits.ctypes.data, gcol.ctypes.data,
            cmeta.ctypes.data,
            dense_start.ctypes.data, dense_len.ctypes.data,
            bad_start.ctypes.data, bad_len.ctypes.data, meta.ctypes.data)
        if rc == 0:
            break
        if rc == 1:
            cap_w = int(meta[0]) + 8
            cap_b = int(meta[1]) + 8
            cap_g = int(meta[2]) + 8
            cap_c = int(meta[3]) + 8
            continue
        raise RuntimeError(f"lime_plan_pairs_packed failed: {rc}")
    else:
        raise RuntimeError("lime_plan_pairs_packed capacity retry failed")
    n_chunks, ndense, nbad = int(meta[3]), int(meta[4]), int(meta[5])
    windows = (int(meta[6]), int(meta[7]), int(meta[8]))
    chunks = []
    for c in range(n_chunks):
        b, owner, n_rows, wo, bo, go, gc = (int(v) for v in
                                            cmeta[c * 7:c * 7 + 7])
        chunks.append((b, owner, n_rows, wo, bo, go, gc))
    arrays = (rows[:int(meta[0])], bits[:int(meta[1])],
              gcol[:int(meta[2])])
    return (arrays, chunks, windows, W,
            dense_start[:ndense].copy(), dense_len[:ndense].copy(),
            bad_start[:nbad].copy(), bad_len[:nbad].copy())


def plan_dense(starts: np.ndarray, lens: np.ndarray, da: np.ndarray,
               ebwt: np.ndarray | None, num_reads: int, num_docs: int,
               sym_lut: np.ndarray, K: int = 8, PR: int = 8,
               max_ent: int = 256):
    """Emit the dense histogram-matmul streams for genome-dense clusters.

    Returns ``(rid, cmap, rb, rpf, gcl, ggf, ent_off, rt_off, gt_off,
    valid)``: per-entry read-lane tables + cluster map, read/genome feature
    triples, per-cluster CSR offsets into each stream, and a per-cluster
    validity mask (invalid clusters emitted nothing and must route to the
    exact host scorer).  See lime_plan_dense in csrc for the identity and
    the emission format.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n_clusters = len(starts)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    eb_ptr = 0
    if ebwt is not None:
        ebwt = np.ascontiguousarray(ebwt, dtype=np.uint8)
        eb_ptr = ebwt.ctypes.data
    sym_lut = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    ent_cap = int(np.minimum(max_ent, -(-lens // PR)).sum()) + 1
    trip_cap = int(lens.sum()) + 1
    rid = np.empty(ent_cap * PR, dtype=np.int32)
    cmap = np.empty(ent_cap, dtype=np.int32)
    rb = np.empty(trip_cap, dtype=np.int32)
    rpf = np.empty(trip_cap, dtype=np.int16)
    gcl = np.empty(trip_cap, dtype=np.int32)
    ggf = np.empty(trip_cap, dtype=np.int32)
    ent_off = np.empty(n_clusters + 1, dtype=np.int64)
    rt_off = np.empty(n_clusters + 1, dtype=np.int64)
    gt_off = np.empty(n_clusters + 1, dtype=np.int64)
    valid = np.zeros(n_clusters, dtype=np.uint8)
    meta = np.zeros(3, dtype=np.int64)
    rc = lib.lime_plan_dense(
        starts.ctypes.data, lens.ctypes.data, n_clusters,
        da.ctypes.data, eb_ptr, num_reads, num_docs, sym_lut.ctypes.data,
        K, PR, max_ent,
        rid.ctypes.data, cmap.ctypes.data,
        rb.ctypes.data, rpf.ctypes.data,
        gcl.ctypes.data, ggf.ctypes.data,
        ent_off.ctypes.data, rt_off.ctypes.data, gt_off.ctypes.data,
        valid.ctypes.data, meta.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lime_plan_dense failed: {rc}")
    ne, nrt, ngt = int(meta[0]), int(meta[1]), int(meta[2])
    return (rid[:ne * PR].reshape(ne, PR), cmap[:ne], rb[:nrt], rpf[:nrt],
            gcl[:ngt], ggf[:ngt], ent_off, rt_off, gt_off,
            valid.astype(bool))


def score_clusters_native(starts: np.ndarray, lens: np.ndarray,
                          da: np.ndarray, ebwt: np.ndarray | None,
                          num_reads: int, num_refs: int,
                          sym_lut: np.ndarray, deg_lut: np.ndarray,
                          wf_pairs: Sequence[Tuple[int, int]],
                          wide: bool = False, threads: int = 0,
                          out: Optional[np.ndarray] = None,
                          mem_cap: int = 8 << 30) -> np.ndarray:
    """Score a cluster list into a dense (R, G) matrix — native SIMD path.

    Reference-exact counter semantics (u8 wrap / 255 saturation / IUPAC
    waterfall, src/ClusterBWT_DA.cpp:81-252); ``wide`` selects u32 counters
    (dataTypeNumSim=1).  ``out`` accumulates in place when given.  Releases
    the GIL; clusters score on ``threads`` OpenMP threads (0 = all cores)
    into per-thread partials capped at ``mem_cap`` bytes.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    eb_ptr = 0
    if ebwt is not None:
        ebwt = np.ascontiguousarray(ebwt, dtype=np.uint8)
        eb_ptr = ebwt.ctypes.data
    dtype = np.uint32 if wide else np.uint8
    if out is None:
        out = np.zeros((num_reads, num_refs), dtype=dtype)
    elif (out.dtype != dtype or out.ndim != 2
          or out.shape[0] < num_reads or out.shape[1] < num_refs
          or out.strides[1] != out.itemsize):
        raise ValueError("out must be a row-contiguous 2D array of the "
                         f"{dtype} dtype covering (num_reads, num_refs)")
    row_stride = out.strides[0] // out.itemsize
    if threads <= 0:
        threads = os.cpu_count() or 1
    wf = np.ascontiguousarray(
        np.asarray(wf_pairs, dtype=np.int32).reshape(-1))
    sym_lut = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    deg_lut = np.ascontiguousarray(deg_lut, dtype=np.uint8)
    rc = lib.lime_score_clusters(
        starts.ctypes.data, lens.ctypes.data, len(starts),
        da.ctypes.data, eb_ptr, num_reads, num_refs,
        sym_lut.ctypes.data, deg_lut.ctypes.data,
        wf.ctypes.data, len(wf) // 2, int(wide),
        out.ctypes.data, threads, mem_cap, row_stride)
    if rc != 0:
        raise RuntimeError(f"lime_score_clusters failed: {rc}")
    return out


def plan_score_coo(lcp: np.ndarray, da: np.ndarray,
                   ebwt: np.ndarray | None, num_reads: int, num_refs: int,
                   alpha: int, sym_lut: np.ndarray, deg_lut: np.ndarray,
                   wf_pairs: Sequence[Tuple[int, int]],
                   threads: int = 1, max_drow: int = 15):
    """Fused one-pass plan+score for the all-host hybrid mode.

    One C++ pass over the index detects alpha-clusters, applies the
    membership filter, scores every cluster (reference-exact u8 counter
    semantics, src/ClusterBWT_DA.cpp:81-252) and returns the similarity
    nonzeros as one delta-COO chain ``(base_row, drow, col, val)`` — the
    dense (R, G) plane is never materialized, so the planner pass, the
    scorer's random plane scatter and the two full-plane compaction scans
    of the split pipeline all collapse into cache-resident work.

    Returns ``(chain_or_None, n_clusters, n_positions)``.  Releases the
    GIL for the whole pass.  u8 counters only (wide runs keep the dense
    plane path).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lcp = np.ascontiguousarray(lcp, dtype=np.uint32)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    eb_ptr = 0
    if ebwt is not None:
        ebwt = np.ascontiguousarray(ebwt, dtype=np.uint8)
        eb_ptr = ebwt.ctypes.data
    sym_lut = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    deg_lut = np.ascontiguousarray(deg_lut, dtype=np.uint8)
    wf = np.ascontiguousarray(
        np.asarray(wf_pairs, dtype=np.int32).reshape(-1))
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    n = len(lcp)
    meta = np.zeros(4, dtype=np.int64)
    cap = max(1 << 22, n // 8)
    for _ in range(2):
        drow = np.empty(cap, np.uint8)
        col = np.empty(cap, np.uint16)
        val = np.empty(cap, np.uint8)
        rc = lib.lime_plan_score_coo(
            lcp.ctypes.data, da.ctypes.data, eb_ptr, n, num_reads,
            num_refs, alpha, sym_lut.ctypes.data, deg_lut.ctypes.data,
            wf.ctypes.data, len(wf) // 2, threads, max_drow, cap,
            drow.ctypes.data, col.ctypes.data, val.ctypes.data,
            meta.ctypes.data)
        if rc == 0:
            break
        if rc == 1:
            cap = int(meta[0]) + 8
            continue
        raise RuntimeError(f"lime_plan_score_coo failed: {rc}")
    else:
        raise RuntimeError("lime_plan_score_coo capacity retry failed")
    cnt = int(meta[0])
    n_clusters, n_pos = int(meta[2]), int(meta[3])
    if cnt == 0:
        return None, n_clusters, n_pos
    chain = (int(meta[1]), drow[:cnt], col[:cnt], val[:cnt])
    return chain, n_clusters, n_pos


def plan_clusters(lcp: np.ndarray, da: np.ndarray, num_reads: int,
                  alpha: int, threads: int = 1, return_nr: bool = False):
    """Minimal cluster planner: (starts, lens[, n_read_positions]) of
    every membership-passing alpha-cluster, nothing else — the planning
    half of the all-host job shop (~3x cheaper than the packed planner,
    which materializes stream buffers an all-host run never uses).
    ``return_nr`` adds the per-cluster read-position counts the scan
    computes anyway (pair-heavy-cluster routing).  Releases the GIL."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lcp = np.ascontiguousarray(lcp, dtype=np.uint32)
    da = np.ascontiguousarray(da, dtype=np.uint32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    n = len(lcp)
    meta = np.zeros(3, dtype=np.int64)
    cap = n // 2 + 1
    starts = np.empty(cap, dtype=np.int64)
    lens = np.empty(cap, dtype=np.int64)
    nr = np.empty(cap, dtype=np.int64) if return_nr else None
    rc = lib.lime_plan_clusters(
        lcp.ctypes.data, da.ctypes.data, n, num_reads, alpha, threads,
        cap, starts.ctypes.data, lens.ctypes.data,
        nr.ctypes.data if return_nr else 0, meta.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lime_plan_clusters failed: {rc}")
    nc = int(meta[0])
    if return_nr:
        return starts[:nc], lens[:nc], nr[:nc]
    return starts[:nc], lens[:nc]


def coo_compact(mat: np.ndarray, num_reads: int, num_refs: int,
                wide: bool = False, threads: int = 0,
                max_drow: int = 255, zero_after: bool = False):
    """Compact a dense similarity plane to the delta-COO uplink format.

    Returns a list of per-thread segments ``(base_row, drow_u8, col_u16,
    val)`` (val u8, or u32 when ``wide``): rows delta-encoded in scan
    order from ``base_row``, gaps > 255 bridged by zero-value entries
    (no-ops under scatter-add).  ~4 B per nonzero — the hybrid engine's
    whole uplink for host-scored clusters.  ``zero_after`` re-zeroes the
    emitted cells while they are cache-hot, returning the plane ready
    for reuse (replaces a separate full-plane fill).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if mat.ndim != 2 or mat.strides[1] != mat.itemsize:
        raise ValueError("mat must be a row-contiguous 2D array")
    if mat.dtype != (np.uint32 if wide else np.uint8):
        raise ValueError("mat dtype does not match wide")
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    row_stride = mat.strides[0] // mat.itemsize
    cap = 1 << 20
    for _ in range(3):
        drow = np.empty(cap, np.uint8)
        col = np.empty(cap, np.uint16)
        val = np.empty(cap, np.uint32 if wide else np.uint8)
        seg = np.zeros(3 * threads, np.int64)
        rc = lib.lime_coo_compact(
            mat.ctypes.data, num_reads, num_refs, row_stride,
            int(wide), threads, cap, max_drow, int(zero_after),
            drow.ctypes.data, col.ctypes.data, val.ctypes.data,
            seg.ctypes.data)
        if rc >= 0:
            out = []
            for t in range(threads):
                off, cnt, base = (int(seg[3 * t]), int(seg[3 * t + 1]),
                                  int(seg[3 * t + 2]))
                if cnt:
                    out.append((base, drow[off:off + cnt],
                                col[off:off + cnt], val[off:off + cnt]))
            return out
        if rc <= -3:
            cap = -rc + 8
            continue
        raise RuntimeError(f"lime_coo_compact failed: {rc}")
    raise RuntimeError("lime_coo_compact capacity retry failed")


def format_csv(types: np.ndarray, taxid: np.ndarray, sim: np.ndarray,
               base: int) -> bytes:
    """Assignment CSV rows via the C formatter (src/Classify.cpp:722-731)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    types = np.ascontiguousarray(types, dtype=np.uint8)
    taxid = np.ascontiguousarray(taxid, dtype=np.uint32)
    sim = np.ascontiguousarray(sim, dtype=np.float32)
    n = len(types)
    buf = ctypes.create_string_buffer(64 * n + 64)
    ln = lib.lime_format_csv(types.ctypes.data, taxid.ctypes.data,
                             sim.ctypes.data, n, base, buf)
    return buf.raw[:ln]
