"""Fused serving pipeline: collections -> per-read assignments.

The staged path (pipeline.py) mirrors the reference's file-per-stage
architecture.  This module is the serving path.  Per collection the
native planner (OpenMP, released GIL) scans the index once and routes
every alpha-cluster:

- sparse clusters (the overwhelming majority at every genome count —
  measured p99 = ONE genome document at 930 genomes) -> the packed
  pair-stream device path (ops/pair_score.py), 3.125 bytes/row of
  upload, G-independent compute;
- genome-dense clusters and deep-coverage clusters longer than 255
  rows -> the tensor-core histogram-matmul path (ops/dense_score.py);
- IUPAC-degenerate (stateful waterfall) and >65536-row clusters -> the
  exact host scorer, as sparse COO corrections.

Dispatches are asynchronous: collection i+1 plans (its memmapped index
faulting in as the C++ scan walks it) while collection i's uploads
drain.  A final device program fuses counter wrap, normalization, beta
gating and the 4-stage classify cascade; per-read (type, taxid, sim)
triplets are the only downlink.

Memory plan (paper-scale: 10^6-10^7 reads x 10^3 genomes):

- each collection's score matrix accumulates on device as ``(R_pad,
  G_pad)`` int8 — R x G *bytes*, the reference's dense uchar SimArray
  footprint (src/ClusterBWT_DA.cpp:606-611); int8 wraparound IS the
  reference's unsaturated uchar counter semantics
  (ClusterBWT_DA.cpp:183).  ``wide_sim`` (reads > 255bp) -> int32.
- when the (F, R_pad, G_pad) stack exceeds the HBM budget (setB2 scale)
  the run switches to _run_fused_blocked: streams upload once, stay
  device-resident, and every read-row block is scored by replaying them
  from HBM — host memory never holds an (R, G) matrix.
- the legacy banded path (run with ``pair_stream=False``) compacts one
  packed byte + one doc id per position and scores through the one-hot
  banded kernel — the right engine only when most genome lanes hit.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..config import LimeConfig
from ..constants import SYMBOL_RANK_LUT
from ..formats.arrays import open_da, open_ebwt, open_lcp
from ..formats.lineage import Lineage
from ..ops.classify_ops import ClassifyResult
from ..ops.classify_tpu import blockwise_cascade
from ..ops.fused_pass import _DEGENERATE_BYTE
from ..ops.pair_score import coo_scatter_into, merge_coo_segments
from .. import native
from ..ops.scoring import _expand_positions, score_clusters
from ..utils.timing import PhaseTimer

_BLOCK = 1 << 20
_M_BIT = 6


def _g_pad_for(num_refs: int) -> int:
    return max(128, -(-num_refs // 128) * 128)


def _classify_block_for(num_reads: int) -> int:
    """Read-block size for the blockwise cascade (static per num_reads)."""
    from .classify_tpu import classify_block_size

    return classify_block_size(num_reads + 1)


def _r_pad_for(num_reads: int) -> int:
    from .classify_tpu import pad_rows_for

    return pad_rows_for(num_reads + 1)


@functools.partial(
    jax.jit, static_argnames=("num_reads", "num_refs", "out_rows", "wide"))
def _score_program(packed, doc, window, num_reads: int, num_refs: int,
                   out_rows: int, wide: bool):
    from ..parallel.sharded import banded_partial_sim

    m = ((packed >> _M_BIT) & 1).astype(bool)
    sym = (packed & 15).astype(jnp.int8)
    return banded_partial_sim(m, doc.astype(jnp.int32), sym,
                              num_reads, num_refs, window,
                              out_rows=out_rows,
                              acc_dtype=jnp.int32 if wide else jnp.int8)


def _pack_triplet(types, taxid, sim):
    """(types u8, taxid u32, sim f32) -> one (3, R_pad) u32 buffer.

    One packed buffer replaces three result fetches, so the downlink
    pays one transfer's fixed cost."""
    return jnp.stack([types.astype(jnp.uint32),
                      taxid.astype(jnp.uint32),
                      lax.bitcast_convert_type(sim, jnp.uint32)])


def _unpack_triplet(packed_h):
    """Host-side decode of _pack_triplet's buffer."""
    return (packed_h[0].astype(np.uint8), packed_h[1].astype(np.uint32),
            packed_h[2].view(np.float32))


@functools.partial(
    jax.jit,
    static_argnames=("num_files", "tax_rank", "assign_higher", "is_mod",
                     "block"),
    donate_argnums=(0,))
def _classify_program(sims, crows, ccols, cvals, cfile, tax, rank_matrix,
                      valid_t, error, norm, beta, num_files: int,
                      tax_rank: int, assign_higher: bool, is_mod: bool,
                      block: int):
    """Blockwise wrap + normalize + beta-gate + cascade over (F, R_pad, G_pad).

    ``sims`` is donated: the sparse correction scatter happens in place.
    Rows past the real read count are junk (the scatter drop row and pad)
    and are discarded by the caller; genome lanes past the real count are
    masked by ``valid_t``.  Returns one packed (3, R_pad) u32 buffer
    (types | taxid | sim-bits) — a single downlink transfer.
    """
    if crows.shape[0]:
        # int8 add wraps mod 256 = the reference's uchar accumulate, so the
        # correction values enter pre-wrapped
        sims = sims.at[cfile, crows, ccols].add(
            cvals.astype(sims.dtype), mode="drop")
    return _pack_triplet(*blockwise_cascade(
        sims, tax, rank_matrix, valid_t, error, norm, beta, num_files,
        tax_rank, assign_higher, is_mod, block))


@functools.partial(
    jax.jit,
    static_argnames=("num_files", "tax_rank", "assign_higher", "is_mod",
                     "block"),
    donate_argnums=(0,))
def _classify_program_planes(sims_list, crows, ccols, cvals, cfile, tax,
                             rank_matrix, valid_t, error, norm, beta,
                             num_files: int, tax_rank: int,
                             assign_higher: bool, is_mod: bool, block: int):
    """_classify_program over per-file planes: the stack happens inside
    the one classify launch (one launch instead of two, and the donated
    planes die here instead of surviving a separate stack program)."""
    sims = jnp.stack(sims_list)
    if crows.shape[0]:
        sims = sims.at[cfile, crows, ccols].add(
            cvals.astype(sims.dtype), mode="drop")
    return _pack_triplet(*blockwise_cascade(
        sims, tax, rank_matrix, valid_t, error, norm, beta, num_files,
        tax_rank, assign_higher, is_mod, block))


def _dense_threshold_for(num_genomes: int, config: LimeConfig) -> int:
    """Genome-position threshold for banded-kernel routing (LimeConfig).

    The banded kernel's per-position cost is window * G_pad one-hot lanes,
    so its economics collapse past ~256 genomes.  In the large-G regime
    genome-dense clusters go to the dense histogram-matmul path instead
    (see _dense_min_for) and only genome-sparse ones to the native scorer.
    """
    if config.dense_threshold is not None:
        return config.dense_threshold
    return 0 if _g_pad_for(num_genomes) <= 256 else (1 << 62)


def _dense_min_for(num_genomes: int, config: LimeConfig) -> int:
    """Genome-position threshold for dense histogram-matmul routing.

    Active only in the large-G regime (where the banded kernel is routed
    off): clusters with >= this many genome positions amortize the batched
    matmul; sparser ones stay on the native scorer, whose cost tracks the
    touched cells.  0 disables the path.
    """
    if not native.available():
        return 0
    if config.mxu_dense_min is not None:
        return config.mxu_dense_min
    return 0 if _g_pad_for(num_genomes) <= 256 else 16


def _score_small_dense(starts, lens, da, ebwt, n_r, n_g,
                       config: LimeConfig) -> np.ndarray:
    """Exact scores for a (small, remapped) cluster set — native or numpy."""
    if native.available():
        from ..constants import IUPAC_WATERFALL_PAIRS

        return native.score_clusters_native(
            starts, lens, da, ebwt, n_r, n_g, SYMBOL_RANK_LUT,
            _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
            wide=config.wide_sim,
            threads=0 if ebwt is None or len(starts) > 64 else 1)
    return score_clusters(starts, lens, da, ebwt, n_r, n_g,
                          config.replace(wide_sim=True))


def _rescue_sparse(bad_start, bad_len, da, ebwt, num_reads: int,
                   num_genomes: int, config: LimeConfig):
    """Exact host scores for rescued clusters, as COO (rows, cols, vals).

    Rescued clusters touch few documents, so the exact scorer runs on a
    remapped compact collection (unique documents only) and the nonzeros
    map back to global (read, genome) coordinates — no (R, G) buffer.
    """
    cid, gpos = _expand_positions(np.asarray(bad_start, np.int64),
                                  np.asarray(bad_len, np.int64))
    docs = np.asarray(da[gpos]).astype(np.int64)
    uniq, inv = np.unique(docs, return_inverse=True)
    n_r = int((uniq < num_reads).sum())
    # documents keep their relative order, so remapped ids preserve the
    # read-block-then-genome-block convention the scorer relies on
    da_small = inv.astype(np.uint32)
    eb_small = None if ebwt is None else np.asarray(ebwt[gpos])
    offs = np.concatenate([[0], np.cumsum(np.asarray(bad_len, np.int64))])
    dense = _score_small_dense(offs[:-1], np.asarray(bad_len, np.int64),
                               da_small, eb_small, n_r, len(uniq) - n_r,
                               config)
    r_i, g_i = np.nonzero(dense)
    rows = uniq[r_i].astype(np.int32)
    cols = (uniq[n_r + g_i] - num_reads).astype(np.int32)
    vals = dense[r_i, g_i].astype(np.int64)
    if config.sim_modulus:
        vals = vals % config.sim_modulus
    return rows, cols, vals.astype(np.int32)


# COO stays cheaper than a dense (R, G) upload while the rescued clusters
# cover few positions; past this, the native scorer fills a full matrix.
_COO_POSITION_CAP = 1 << 20


def _rescue(bad_start, bad_len, da, ebwt, num_reads: int, num_genomes: int,
            config: LimeConfig):
    """Host-side exact scoring of routed clusters.

    Returns ``("coo", rows, cols, vals)`` for small rescue sets or
    ``("dense", matrix)`` (u8 with wrap / u32 wide — the reference's own
    SimArray footprint, src/ClusterBWT_DA.cpp:606-611) when density routing
    sends a large share of clusters to the host scorer.
    """
    total = int(np.asarray(bad_len, np.int64).sum())
    if (total <= _COO_POSITION_CAP and total < num_reads * num_genomes // 16
            ) or not native.available():
        return ("coo", *_rescue_sparse(bad_start, bad_len, da, ebwt,
                                       num_reads, num_genomes, config))
    from ..constants import IUPAC_WATERFALL_PAIRS

    mat = native.score_clusters_native(
        np.asarray(bad_start, np.int64), np.asarray(bad_len, np.int64),
        np.asarray(da), None if ebwt is None else np.asarray(ebwt),
        num_reads, num_genomes, SYMBOL_RANK_LUT, _DEGENERATE_BYTE,
        IUPAC_WATERFALL_PAIRS, wide=config.wide_sim, threads=0)
    return ("dense", mat)


def run_fused(collections: Sequence[str], num_reads: int, num_genomes: int,
              lineage: Lineage, read_len: int, config: LimeConfig,
              ) -> ClassifyResult:
    """Async-pipelined classification over 2 or 4 collection indexes.

    Set ``LIME_PROFILE_DIR`` to capture a jax profiler trace of the run
    (the device-side counterpart of the reference's per-thread wtime
    prints, src/ClusterBWT_DA.cpp:664-669).
    """
    import contextlib

    prof_dir = os.environ.get("LIME_PROFILE_DIR")
    ctx = (jax.profiler.trace(prof_dir) if prof_dir
           else contextlib.nullcontext())
    with ctx:
        return _run_fused_inner(collections, num_reads, num_genomes,
                                lineage, read_len, config)


_warmed_paths: set = set()


# Delivered host->device bandwidth samples (GB/s), measured by the
# uplink worker from real transfers: elapsed time from device_put to the
# scatter result being READY on device (only a dependent device
# computation observes delivery on a link that acknowledges device_put
# once the bytes are buffered).  Recency-weighted, newer samples count
# double, so a link that degrades mid-run is tracked quickly.
import collections as _collections

_bw_samples: "_collections.deque" = _collections.deque(maxlen=4)

# Host SIMD scorer positions/s, measured from real scoring batches of
# this process (replaces round 4's hardcoded folklore constant).
_host_rate_samples: "_collections.deque" = _collections.deque(maxlen=4)


def _record_link_bw(sample_gbps: float) -> None:
    _bw_samples.append(sample_gbps)


def _record_host_rate(pos_per_sec: float) -> None:
    _host_rate_samples.append(pos_per_sec)


def _recency_weighted(samples) -> float | None:
    """Weighted mean with weights doubling per newer sample."""
    if not samples:
        return None
    ws = [2.0 ** i for i in range(len(samples))]
    return sum(w * s for w, s in zip(ws, samples)) / sum(ws)


def _link_bw_estimate() -> float | None:
    return _recency_weighted(_bw_samples)


def _host_rate_estimate() -> float:
    """Measured scorer rate (positions/s, all cores), else the prior."""
    per_core = _recency_weighted(_host_rate_samples)
    import os

    cores = min(os.cpu_count() or 1, 16)
    if per_core is None:
        return _HOST_POS_PER_SEC_CORE * cores
    return per_core * cores


def _split_fraction(bw_gbps: float, host_pos_per_sec: float) -> float:
    """Pure split model: fraction of clusters to host-score.

    Equalizes two concurrent pipelines — the device path ships
    ~_STREAM_BYTES_PER_ROW per surviving position over the link, the
    host path scores positions at ``host_pos_per_sec`` and ships only
    pre-aggregated delta-COO nonzeros.  f = A / (1 + A) with
    A = bytes_per_row * host_rate / link_bw.
    """
    a = _STREAM_BYTES_PER_ROW * host_pos_per_sec / max(bw_gbps * 1e9, 1.0)
    return a / (1.0 + a)


# Stream bytes per emitted pair-stream row (W=20: 20/8 rows + 5/8 bits +
# amortized per-copy gcol) and the host SIMD scorer's per-core position
# throughput — the two constants of the hybrid split model.
_STREAM_BYTES_PER_ROW = 3.45
_HOST_POS_PER_SEC_CORE = 5.6e6


def _host_split_for(config: LimeConfig, num_reads: int, num_genomes: int,
                    wide: bool) -> int:
    """Pick the hybrid host/device split (0..256 = none..all host).

    Balances two pipelines that run concurrently per collection: the
    device path ships ~3.45 B per surviving position over the link; the
    host path scores positions at the SIMD scorer's measured rate and
    ships only pre-aggregated nonzeros (delta-COO, ~9x fewer entries
    than positions).  Equalizing the two gives f = A / (1 + A) with
    A = bytes_per_row * host_rate / link_bw.  On a PCIe-class link
    A ~ 0.004 -> f ~ 0, pure device; over a slow host link A >> 1 ->
    most-to-all host.
    """
    frac = config.host_frac
    env = os.environ.get("LIME_HOST_FRAC")
    if env is not None:
        frac = float(env)
    if frac is None:
        if not native.available():
            return 0
        # dense host plane per collection; cap so setB2-scale runs keep
        # their bounded-memory path unless explicitly overridden
        cell = 4 if wide else 1
        cap = int(os.environ.get("LIME_HOST_MATRIX_CAP", 32 << 30))
        if num_reads * num_genomes * cell > cap:
            return 0
        bw = _link_bw_estimate()
        if bw is None:
            return 0  # direct-attached devices start pure-device
        rate = _host_rate_estimate()
        f = _split_fraction(bw, rate)
        import logging

        logging.getLogger("lime_tpu").info(
            "hybrid split: bw=%.3f GB/s rate=%.1f Mpos/s -> host f=%.2f",
            bw, rate / 1e6, f)
    else:
        f = float(frac)
    host_num = int(round(f * 256))
    if host_num < 18:
        return 0
    if host_num > 238:
        return 256
    return host_num


def _probe_link_bw() -> float:
    """Measure DELIVERED h2d bandwidth with a fresh 4 MB transfer.

    Runs the pattern twice and returns the second sample: the first
    absorbs the one-time program compile and load, which would otherwise
    bias a healthy link below the offload floor.  The
    second sample is recorded into the split estimator.
    """
    import time as _time

    buf = np.random.default_rng(0).integers(0, 255, 4 << 20,
                                            dtype=np.uint8)
    bw = 0.0
    for _ in range(2):
        t0 = _time.perf_counter()
        dev = jax.device_put(buf)
        np.asarray(jnp.sum(dev.astype(jnp.uint32)))
        bw = buf.nbytes / 1e9 / (_time.perf_counter() - t0)
    _record_link_bw(bw)
    return bw


# Device-memory shares of the row-blocked planner's two budgets and of
# the classify pre-warm's headroom gate.  The CPU backend reports no
# memory limit; there the shares apply to a nominal 16 GB.
_CPU_NOMINAL_MEMORY = 16 << 30


def _device_memory() -> int:
    """Bytes this process may allocate on the first device."""
    dev = jax.devices()[0]
    stats = dev.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return _CPU_NOMINAL_MEMORY
    raise RuntimeError(
        f"{dev.platform} device {dev.device_kind!r} reports no memory "
        "limit; set LIME_HBM_BUDGET and LIME_STREAM_BUDGET")


def _hbm_budget() -> int:
    """Device-memory budget (bytes) for the similarity stack (F, rows,
    g_pad): 3/8 of the device's memory, leaving room for device-resident
    packed streams, cascade intermediates and XLA slack.  Runs whose
    stack exceeds it switch to the row-blocked mode.  LIME_HBM_BUDGET
    overrides."""
    env = os.environ.get("LIME_HBM_BUDGET")
    if env is not None:
        return int(env)
    return _device_memory() * 3 // 8


def _stream_budget() -> int:
    """Device-resident packed-stream budget of the row-blocked runner:
    7/16 of the device's memory.  LIME_STREAM_BUDGET overrides."""
    env = os.environ.get("LIME_STREAM_BUDGET")
    if env is not None:
        return int(env)
    return _device_memory() * 7 // 16


def _run_fused_inner(collections, num_reads, num_genomes, lineage,
                     read_len, config) -> ClassifyResult:
    timer = PhaseTimer("fused_pipeline")
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("fused pipeline takes 2 or 4 collections")

    use_u16 = (num_reads + num_genomes) < 0xFFFF
    r_pad = _r_pad_for(num_reads)
    g_pad = _g_pad_for(num_genomes)
    block = _classify_block_for(num_reads)
    wide = bool(config.wide_sim)
    pair_possible = (config.pair_stream is not False
                     and native.available() and num_reads <= (1 << 28)
                     and num_genomes <= (1 << 16))
    if config.pair_stream and not pair_possible:
        raise RuntimeError(
            "pair_stream=True needs the native planner (available: "
            f"{native.available()}), <= 2**28 reads and <= 65536 genomes")
    stack_bytes = F * r_pad * g_pad * (4 if wide else 1)
    one_block = ((num_reads + 1) * g_pad < 2**31 - 1
                 and stack_bytes <= _hbm_budget())
    if pair_possible and not one_block:
        # setB2-scale: the (F, R, G) stack exceeds HBM (or the flat
        # scatter range exceeds int32) — stream-resident row-blocked mode
        # (the reference's answer is 18.8 GB of host RAM for ONE matrix,
        # src/ClusterBWT_DA.cpp:606-611; ours is bounded device blocks
        # with the packed streams replayed from HBM per block)
        return _run_fused_blocked(collections, num_reads, num_genomes,
                                  lineage, read_len, config, timer)
    pair = pair_possible if config.pair_stream is None \
        else bool(config.pair_stream)
    g_dense = _dense_threshold_for(num_genomes, config)
    dense_min = (_dense_min_for(num_genomes, config) if not pair
                 else (16 if config.mxu_dense_min is None
                       else config.mxu_dense_min))
    host_dtype = np.uint32 if wide else np.uint8
    dev_dtype = jnp.int32 if wide else jnp.int8
    sims_dev = [None] * F
    corr = []  # (file, rows, cols, vals) per rescued collection
    # Hybrid host/device split (0..256): this /256 share of clusters is
    # hash-routed to the host SIMD scorer at plan time and uplinked as
    # delta-COO nonzeros — the adaptive answer to a slow host link.
    host_auto = (pair and config.host_frac is None
                 and os.environ.get("LIME_HOST_FRAC") is None)
    host_num = _host_split_for(config, num_reads, num_genomes,
                               wide) if pair else 0
    # Small all-host runs route their delta-COO chains through the
    # classify program's correction scatter instead of separate uplink
    # jobs: at example scale four launches' fixed cost outweighs the
    # bytes, and corrections ride the one classify launch that runs
    # anyway.
    _small_coo = num_reads * num_genomes <= (1 << 25)
    scratch = None  # reusable dense host plane for the hybrid path

    def load(fasta):
        # memmaps: the C++ planner's sequential scan faults pages in as
        # it goes, so IO overlaps planning; every later consumer (dense
        # packer, rescue) only gathers slices
        use_mmap = pair
        lcp = open_lcp(fasta, mmap=use_mmap)
        da = open_da(fasta, mmap=use_mmap)
        ebwt = (open_ebwt(fasta, mmap=use_mmap) if config.use_ebwt
                else None)
        return lcp, da, ebwt

    def plan_pair(arrays):
        """Plan one collection for the pair-stream path (ops/pair_score):
        sparse clusters -> packed per-genome-copy chunks (3.125 B/row),
        genome-dense -> dense matmul lists, degenerate/long -> host
        rescue."""
        lcp, da, ebwt = arrays
        timer.add_bytes("score", len(lcp) * (9 if config.use_ebwt else 8))
        return native.plan_pairs_packed(
            lcp, da, ebwt, num_reads, config.alpha,
            SYMBOL_RANK_LUT, _DEGENERATE_BYTE.astype(np.uint8),
            dense_min=dense_min, num_refs=num_genomes,
            host_num=host_num)

    def plan(arrays):
        """Plan one collection (legacy banded/density routing).

        The device stream is *compacted*: only positions of clusters that
        contain both a read and a genome symbol (the reference's membership
        filter, src/ClusterLCP.cpp:220) and that the banded kernel can score
        efficiently survive (density routing — see _dense_threshold_for).
        Cluster boundaries in the compact stream are encoded in the
        run-mask bit itself (a cluster's first row carries m=0), so
        adjacent clusters never band-match each other.
        """
        lcp, da, ebwt = arrays
        timer.add_bytes("score", len(lcp) * (9 if config.use_ebwt else 8))
        if native.available():
            (packed, doc, nc, window, bad_start, bad_len, dense_start,
             dense_len) = native.plan_native(
                lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
                _DEGENERATE_BYTE, use_u16, pad_block=_BLOCK,
                pad_doc=num_reads + num_genomes, g_dense=g_dense,
                dense_min=dense_min)
        else:
            # the numpy fallback has no fast host scorer, so only clusters
            # the banded kernel cannot express route to the host
            packed, doc, window, bad_start, bad_len = _plan_python(
                lcp, da, ebwt, num_reads, num_genomes, config, use_u16)
            nc = 1
            dense_start = dense_len = np.empty(0, np.int64)
        return packed, doc, nc, window, bad_start, bad_len, \
            dense_start, dense_len

    with timer.phase("score"):
        import threading

        # classify-side constants ship NOW, while the link is idle —
        # lazy device_puts inside the classify phase would each pay a
        # transfer's fixed cost on the critical path
        tax_h = np.zeros(g_pad, np.uint32)
        tax_h[:num_genomes] = lineage.at_rank(config.tax_rank)
        rank_h = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
        rank_h[:, :num_genomes] = lineage.taxids
        taxd = jax.device_put(tax_h)
        rankd = jax.device_put(rank_h)
        validd = jax.device_put(np.arange(g_pad) < num_genomes)
        normd = jax.device_put(
            np.float32(np.uint32(read_len + 1 - config.alpha)))
        errord = jax.device_put(np.float32(config.error_tolerance))
        betad = jax.device_put(np.float32(config.beta))

        # One-ahead IO prefetch: the next collection's index loads from
        # disk while this one plans (C++, GIL released) and host-scores
        # (OpenMP) — the reference pays the same IO strictly serially.
        nxt = {}

        def prefetch(fi):
            nxt[fi] = load(collections[fi])
            # warm the page cache with sequential reads so the next
            # collection's planner scan (memmap-fed) doesn't stall on
            # disk — the reads happen here, overlapped with the current
            # collection's host scoring / uploads.  Once per path per
            # process: re-warming an already-cached file is pure memcpy
            # burned on the 2 cores the planner needs.
            try:
                buf = bytearray(8 << 20)
                exts = [".lcp", ".da"] + ([".ebwt"] if config.use_ebwt
                                          else [])
                for ext in exts:
                    path = collections[fi] + ext
                    if path in _warmed_paths:
                        continue
                    _warmed_paths.add(path)
                    with open(path, "rb", buffering=0) as fh:
                        while fh.readinto(buf):
                            pass
            except OSError:  # pragma: no cover - warming is best-effort
                pass

        th = None
        th_up = None  # tail of the chained device-dispatch worker queue
        up_errors = []
        submit_lock = threading.Lock()  # job-shop workers submit too

        def submit(fn, nbytes=0):
            """Chain a device-dispatch job onto the uplink worker queue.

            device_put can block for the transfer time, so ALL uploads
            (pair-stream chunks, dense matmul chunks, delta-COO chains)
            run on worker threads while the main thread plans and
            host-scores the next collection (C++, GIL released).  Jobs
            chain so transfers serialize in order; each job blocks on its
            device result and reports the delivered bandwidth into the
            bandwidth estimator — the feedback that retunes the hybrid
            split for the following collections.
            """
            import time as _time

            nonlocal th_up

            def run(prev):
                if prev is not None:
                    prev.join()
                if up_errors:
                    return
                t0 = _time.perf_counter()
                try:
                    out = fn()
                    if out is not None:
                        jax.block_until_ready(out)
                except Exception as e:  # noqa: BLE001 - reraised at join
                    up_errors.append(e)
                    return
                dt = _time.perf_counter() - t0
                if nbytes and dt > 0.05:
                    # recency-weighted samples (early ones are biased LOW
                    # by one-time compiles/program loads inside the job —
                    # the doubling weights age them out quickly)
                    _record_link_bw(nbytes / 1e9 / dt)

            with submit_lock:  # chain atomically (workers submit too)
                t = threading.Thread(target=run, args=(th_up,))
                th_up = t
                t.start()

        if stack_bytes * 3 + (1 << 30) < _device_memory() * 15 // 16:
            # pre-warm the classify executable on zeroed planes through
            # the worker chain: its compile and first-execution load
            # then overlap planning/host-scoring (gated on device-memory
            # headroom for the throwaway planes + stack)
            # the executable is shape-specific in the correction count:
            # all-host (non-small) runs always classify with ZERO
            # corrections; small all-host runs always ride the k >= 256
            # correction bucket; mixed/pure-device runs depend on the
            # input (rescued clusters pad to k >= 256, clean inputs have
            # none) — warm BOTH there, or a compile lands on the
            # classify critical path
            if host_num == 256 and not _small_coo:
                warm_ks = (0,)
            elif host_num == 256:
                warm_ks = (256,)
            else:
                warm_ks = (0, 256)

            def job_warm_classify(k):
                planes = tuple(jnp.zeros((r_pad, g_pad), dev_dtype)
                               for _ in range(F))
                e0 = (jnp.zeros(0, jnp.int32) if k == 0
                      else jnp.full(k, F, jnp.int32))  # F = drop rows
                return _classify_program_planes(
                    planes, e0, e0, e0, e0, taxd, rankd, validd, errord,
                    normd, betad, F, config.tax_rank,
                    config.assign_higher, not wide, block)

            for _k in warm_ks:
                submit(functools.partial(job_warm_classify, _k))

        # All-host fused mode (host_frac=1.0): per
        # collection ONE light planning pass + single-thread SIMD scoring
        # + cache-hot compaction, scheduled as a 2-worker job shop so both
        # cores stay busy end to end.  A serial variant left one
        # core idle through every planning phase and paid 2-thread
        # partial-plane zero+merge overhead inside the scorer; the job
        # shop runs two collections' single-thread pipelines side by side
        # instead (phase times below are summed across workers, so
        # plan/host_score report aggregate CPU seconds, not wall).
        all_host = (pair and host_num == 256 and not wide
                    and num_genomes <= 65536)
        if all_host:
            import queue
            from concurrent.futures import ThreadPoolExecutor

            from ..constants import IUPAC_WATERFALL_PAIRS

            plane_pool: queue.Queue = queue.Queue()
            p24 = num_genomes < 4096
            max_drow = 15 if p24 else 255

            # Pair-heavy-cluster dense offload: a fraction of a percent
            # of clusters carries most of the (read, genome) pair work at
            # the paper scale (0.18% of clusters, 3.9M of 108M positions,
            # 177M of 211M pairs).  Shipping THOSE clusters to the dense
            # histogram-matmul path costs ~20 MB/collection of uplink and
            # removes most host scoring — worth it exactly when the link
            # can carry it, so the decision comes from a fresh probe
            # (mixed splits planned on stale bandwidth samples strand
            # megabytes on a collapsed link).  LIME_DENSE_OFFLOAD=1/0
            # forces.
            probe_done = threading.Event()
            probe_bw = {}
            env_off = os.environ.get("LIME_DENSE_OFFLOAD")

            def _probe_link():
                try:
                    probe_bw["bw"] = _probe_link_bw()
                except Exception:  # pragma: no cover - probe best-effort
                    pass
                finally:
                    probe_done.set()

            if env_off in ("0", "1") or _small_coo:
                # small runs: host scoring is already sub-second, and
                # waiting on the probe would ADD latency
                probe_done.set()
            else:
                threading.Thread(target=_probe_link, daemon=True).start()

            def _offload_ok():
                if env_off == "1":
                    return True
                if env_off == "0" or _small_coo:
                    return False
                probe_done.wait(timeout=8.0)
                return probe_bw.get("bw", 0.0) >= 0.005  # >= 5 MB/s

            def host_job(fi):
                with timer.phase("load"):
                    lcp, da, ebwt = load(collections[fi])
                timer.add_bytes("score",
                                len(lcp) * (9 if config.use_ebwt else 8))
                with timer.phase("plan"):
                    starts, lens, nrr = native.plan_clusters(
                        lcp, da, num_reads, config.alpha, threads=1,
                        return_nr=True)
                if _offload_ok():
                    pairs = nrr * (lens - nrr)
                    off_min = int(os.environ.get(
                        "LIME_DENSE_OFFLOAD_MIN", 256))
                    big = (pairs >= off_min) & (lens <= 65536)
                    if big.any():
                        from .dense_score import (B_BLK, C_BLK, K, PR,
                                                  _dense_chunk,
                                                  pack_chunks)

                        with timer.phase("dense",
                                         nbytes=int(lens[big].sum()) * 5):
                            d_chunks, left_s, left_l = pack_chunks(
                                starts[big], lens[big], da,
                                ebwt if config.use_ebwt else None,
                                num_reads, num_genomes, g_pad)
                        if d_chunks:
                            f_feat = (4 if config.use_ebwt else 1) * K

                            def job_dense(fi=fi, d_chunks=d_chunks,
                                          f_feat=f_feat):
                                if sims_dev[fi] is None:
                                    sims_dev[fi] = jnp.zeros(
                                        (r_pad, g_pad), dev_dtype)
                                s = sims_dev[fi]
                                for ridx, gidx, cmap_c, rid_c in d_chunks:
                                    s = _dense_chunk(
                                        s, jnp.asarray(ridx),
                                        jnp.asarray(gidx),
                                        jnp.asarray(cmap_c),
                                        jnp.asarray(rid_c),
                                        B_BLK, C_BLK, PR, f_feat, g_pad)
                                sims_dev[fi] = s
                                return s

                            submit(job_dense,
                                   nbytes=sum(r.nbytes + g.nbytes
                                              + c.nbytes + i.nbytes
                                              for r, g, c, i in d_chunks))
                        starts = np.concatenate([starts[~big], left_s])
                        lens = np.concatenate([lens[~big], left_l])
                try:
                    plane = plane_pool.get_nowait()
                except queue.Empty:
                    plane = np.zeros((num_reads, num_genomes), np.uint8)
                total = int(lens.sum())
                with timer.phase("host_score", nbytes=total * 5):
                    import time as _time

                    t0 = _time.perf_counter()
                    native.score_clusters_native(
                        starts, lens, np.asarray(da),
                        None if ebwt is None else np.asarray(ebwt),
                        num_reads, num_genomes, SYMBOL_RANK_LUT,
                        _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
                        wide=False, threads=1, out=plane)
                    dt = _time.perf_counter() - t0
                    if total > 1 << 20 and dt > 0.05:
                        _record_host_rate(total / dt)  # 1-thread sample
                    segs = native.coo_compact(
                        plane, num_reads, num_genomes, wide=False,
                        threads=1, max_drow=max_drow, zero_after=True)
                    # zero_after returned the plane all-zero: reusable
                    plane_pool.put(plane)
                    chain = merge_coo_segments(segs, max_drow=max_drow)
                if chain is None:
                    return
                if _small_coo:
                    base0, drow, col, val = chain
                    rows = (base0 + np.cumsum(drow.astype(np.int64))
                            ).astype(np.int32)
                    corr.append((fi, rows, col.astype(np.int32),
                                 val.astype(np.int32)))
                    return
                nb = len(chain[1]) * (3 if p24 else 4)
                timer.add_bytes("uplink_sync", nb)

                def job_coo(fi=fi, chain=chain):
                    if sims_dev[fi] is None:
                        sims_dev[fi] = jnp.zeros((r_pad, g_pad),
                                                 dev_dtype)
                    sims_dev[fi] = coo_scatter_into(sims_dev[fi], chain,
                                                    packed24=p24)
                    return sims_dev[fi]

                submit(job_coo, nbytes=nb)

            with ThreadPoolExecutor(max_workers=2) as host_pool:
                for fut in [host_pool.submit(host_job, fi)
                            for fi in range(F)]:
                    fut.result()
        else:
            with timer.phase("load"):
                arrays = load(collections[0])
        for fi in range(0 if all_host else F):
            if fi > 0:
                with timer.phase("load"):
                    th.join()
                arrays = nxt.pop(fi)
            if fi + 1 < F:
                th = threading.Thread(target=prefetch, args=(fi + 1,))
                th.start()
            if pair:
                if host_auto:
                    # feedback retune: real measured delivery rate from
                    # earlier collections' uploads adjusts the split
                    host_num = _host_split_for(config, num_reads,
                                               num_genomes, wide)
                with timer.phase("plan"):
                    (pk_arrays, chunks, windows, row_bits, dense_start,
                     dense_len, bad_start, bad_len) = plan_pair(arrays)
                if chunks:
                    # chained-worker dispatch; the uploads drain while
                    # later collections plan and host-score
                    from .pair_score import pair_score_packed_into

                    nb = sum(a.nbytes for a in pk_arrays)
                    timer.add_bytes("uplink_sync", nb)

                    def job_stream(fi=fi, pk_arrays=pk_arrays,
                                   chunks=chunks, windows=windows,
                                   row_bits=row_bits):
                        if sims_dev[fi] is None:
                            sims_dev[fi] = jnp.zeros((r_pad, g_pad),
                                                     dev_dtype)
                        sims_dev[fi] = pair_score_packed_into(
                            sims_dev[fi], pk_arrays, chunks, windows,
                            row_bits, num_reads, g_pad)
                        return sims_dev[fi]

                    submit(job_stream, nbytes=nb)
            else:
                with timer.phase("plan"):
                    (packed, doc, nc, window, bad_start, bad_len,
                     dense_start, dense_len) = plan(arrays)
                if nc:
                    # async device dispatch; compute overlaps the next
                    # iterations' planning and host scoring
                    with timer.phase("dispatch"):
                        sims_dev[fi] = _score_program(
                            jax.device_put(packed), jax.device_put(doc),
                            jnp.int32(window), num_reads, num_genomes,
                            r_pad, wide)
            if len(dense_start):
                # genome-dense clusters: batched indicator-feature
                # matmuls on the tensor cores (ops/dense_score.py).  Packing
                # (host CPU, also yields the leftover list the rescue
                # path needs NOW) runs here; the device dispatch joins
                # the worker chain — sims_dev[fi] is only ever touched
                # by chained jobs, never concurrently by this thread
                # (a main-thread dispatch raced job_stream's slot write
                # — caught as a paper-scale mismatch in the bench).
                from .dense_score import (B_BLK, C_BLK, K, PR,
                                          _dense_chunk, pack_chunks)

                _, da_arr, ebwt_arr = arrays
                with timer.phase("dense",
                                 nbytes=int(dense_len.sum()) * 5):
                    d_chunks, left_s, left_l = pack_chunks(
                        dense_start, dense_len, da_arr,
                        ebwt_arr if config.use_ebwt else None,
                        num_reads, num_genomes, g_pad)
                if d_chunks:
                    f_feat = (4 if config.use_ebwt else 1) * K

                    def job_dense(fi=fi, d_chunks=d_chunks,
                                  f_feat=f_feat):
                        if sims_dev[fi] is None:
                            sims_dev[fi] = jnp.zeros((r_pad, g_pad),
                                                     dev_dtype)
                        s = sims_dev[fi]
                        for ridx, gidx, cmap_c, rid_c in d_chunks:
                            s = _dense_chunk(
                                s, jnp.asarray(ridx), jnp.asarray(gidx),
                                jnp.asarray(cmap_c), jnp.asarray(rid_c),
                                B_BLK, C_BLK, PR, f_feat, g_pad)
                        sims_dev[fi] = s
                        return s

                    submit(job_dense,
                           nbytes=sum(r.nbytes + g.nbytes + c.nbytes +
                                      i.nbytes
                                      for r, g, c, i in d_chunks))
                if len(left_s):
                    bad_start = np.concatenate([bad_start, left_s])
                    bad_len = np.concatenate([bad_len, left_l])
            if len(bad_start):
                _, da, ebwt = arrays
                total = int(np.asarray(bad_len, np.int64).sum())
                with timer.phase("host_score", nbytes=total * 5):
                    if ((total <= _COO_POSITION_CAP
                         and total < num_reads * num_genomes // 16)
                            or not native.available()):
                        rows, cols, vals = _rescue_sparse(
                            bad_start, bad_len, da, ebwt, num_reads,
                            num_genomes, config)
                        if len(rows):
                            corr.append((fi, rows, cols, vals))
                    else:
                        # hybrid path: exact SIMD scoring into a dense
                        # host plane (the reference's own SimArray
                        # footprint, src/ClusterBWT_DA.cpp:606-611),
                        # compacted to delta-COO — the whole uplink is
                        # the matrix's nonzeros, ~4 B each
                        if scratch is None:
                            scratch = np.zeros((num_reads, num_genomes),
                                               host_dtype)
                        else:
                            scratch.fill(0)
                        from ..constants import IUPAC_WATERFALL_PAIRS
                        import time as _time

                        t0 = _time.perf_counter()
                        native.score_clusters_native(
                            np.asarray(bad_start, np.int64),
                            np.asarray(bad_len, np.int64), np.asarray(da),
                            None if ebwt is None else np.asarray(ebwt),
                            num_reads, num_genomes, SYMBOL_RANK_LUT,
                            _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
                            wide=wide, threads=0, out=scratch)
                        dt = _time.perf_counter() - t0
                        if total > 1 << 20 and dt > 0.05:

                            # replicate the scorer's mem_cap thread clamp
                            # (its per-thread partial planes cap the team
                            # size on big matrices)
                            eff = min(os.cpu_count() or 1, 16)
                            cells = num_reads * num_genomes * (
                                4 if wide else 1)
                            while eff > 1 and (eff - 1) * cells > 8 << 30:
                                eff -= 1
                            _record_host_rate(total / dt / eff)
                        # coo24 (3 B/entry, one buffer) whenever the
                        # genome column fits 12 bits; legacy 3-array
                        # format for wide counters / ultra-wide DBs
                        p24 = (not wide) and num_genomes < 4096
                        if num_genomes > 65536:
                            # coo_compact's u16 column cannot express
                            # this width; fall back to plain COO
                            # corrections (rare: the reference's widest
                            # DB is 3,423 accessions)
                            r_i, c_i = np.nonzero(scratch)
                            corr.append((fi, r_i.astype(np.int32),
                                         c_i.astype(np.int32),
                                         scratch[r_i, c_i].astype(
                                             np.int32)))
                            chain = None
                        else:
                            chain = merge_coo_segments(
                                native.coo_compact(
                                    scratch, num_reads, num_genomes,
                                    wide=wide,
                                    max_drow=15 if p24 else 255),
                                max_drow=15 if p24 else 255)
                        if chain is not None:
                            nb = (len(chain[1]) * (3 if p24 else
                                                   7 if wide else 4))
                            timer.add_bytes("uplink_sync", nb)

                            def job_coo(fi=fi, chain=chain, p24=p24):
                                if sims_dev[fi] is None:
                                    sims_dev[fi] = jnp.zeros(
                                        (r_pad, g_pad), dev_dtype)
                                sims_dev[fi] = coo_scatter_into(
                                    sims_dev[fi], chain, packed24=p24)
                                return sims_dev[fi]

                            submit(job_coo, nbytes=nb)
            arrays = None

    # All score dispatches are async: the uploads and device compute they
    # queued complete *here*.  Without this barrier the wait would be
    # silently attributed to the classify phase (round-2's misleading
    # phase report).
    with timer.phase("uplink_sync"):
        if th_up is not None:
            th_up.join()
        if up_errors:
            raise up_errors[0]
    with timer.phase("score_sync"):
        live = [s for s in sims_dev if s is not None]
        if live:
            jax.block_until_ready(live)
    with timer.phase("classify"):
        for fi in range(F):
            if sims_dev[fi] is None:
                sims_dev[fi] = jnp.zeros((r_pad, g_pad), dev_dtype)

        if corr:
            cfile = np.concatenate(
                [np.full(len(r), fi, np.int32) for fi, r, _, _ in corr])
            crows = np.concatenate([r for _, r, _, _ in corr])
            ccols = np.concatenate([c for _, _, c, _ in corr])
            cvals = np.concatenate([v for _, _, _, v in corr])
            # bucket-pad to limit recompiles; padded entries carry an
            # out-of-range file index and scatter in 'drop' mode
            k = max(256, 1 << int(np.ceil(np.log2(len(cfile)))))
            pad = k - len(cfile)
            cfile = np.pad(cfile, (0, pad), constant_values=F)
            crows = np.pad(crows, (0, pad))
            ccols = np.pad(ccols, (0, pad))
            cvals = np.pad(cvals, (0, pad))
        else:
            cfile = np.empty(0, np.int32)
            crows = ccols = np.empty(0, np.int32)
            cvals = np.empty(0, np.int32)

        with timer.phase("classify_run"):
            packed_res = jax.block_until_ready(
                _classify_program_planes(
                    tuple(sims_dev), jnp.asarray(crows),
                    jnp.asarray(ccols), jnp.asarray(cvals),
                    jnp.asarray(cfile), taxd, rankd, validd, errord,
                    normd, betad, F, config.tax_rank,
                    config.assign_higher, not wide, block))
            sims_dev = [None] * F
        with timer.phase("classify_fetch",
                         nbytes=int(packed_res.size) * 4):
            t_h, x_h, s_h = _unpack_triplet(np.asarray(packed_res))
            result = ClassifyResult(t_h[:num_reads], x_h[:num_reads],
                                    s_h[:num_reads])
    timer.report()
    return result


def _run_fused_blocked(collections, num_reads, num_genomes, lineage,
                       read_len, config, timer) -> ClassifyResult:
    """Row-blocked fused pipeline for matrices beyond HBM (setB2 scale).

    Memory plan: the packed pair streams (~3.2 B/surviving position) and
    dense-cluster chunks upload ONCE and stay device-resident; the
    (F, B, g_pad) similarity stack is bounded by the HBM budget and the
    streams are replayed per row block (device compute is cheap — the
    link is the bottleneck, so re-reading HBM beats re-uploading).  Host
    memory holds only the planner buffers — never an (R, G) matrix (the
    reference needs numReads x numRefs bytes of RAM,
    src/ClusterBWT_DA.cpp:606-611).

    Per block: score all collections' streams + dense chunks + COO
    corrections into the stack, run the cascade, download one (B,)
    triplet set.  Outputs concatenate in read order.
    """
    import threading

    from .dense_score import _dense_scan_class, dense_upload_classes
    from .dense_score import pack_chunks
    from .dense_score import B_BLK, C_BLK, PR, K
    from .pair_score import pair_score_packed_from_device, pair_upload

    F = len(collections)
    g_pad = _g_pad_for(num_genomes)
    wide = bool(config.wide_sim)
    dev_dtype = jnp.int32 if wide else jnp.int8
    dense_min = (16 if config.mxu_dense_min is None
                 else config.mxu_dense_min)
    block = _classify_block_for(num_reads)
    bytes_per_row = F * g_pad * (4 if wide else 1) * 2  # stack + slack
    B = max(block, _hbm_budget() // bytes_per_row // block * block)
    f_dim = (4 if config.use_ebwt else 1) * K

    # Device-resident stream budget: at the full setB2 shape the four
    # collections' packed streams (~4.4 B/surviving row at W=28) can
    # exceed the device's memory.  The planner's dp-slicing re-emits every copy per
    # read-row OWNER, so the sweep runs in n_pass owner passes: upload
    # only owner j's chunks, sweep only owner j's row range, free, next
    # — stream residency is bounded at ~total/n_pass while the link
    # still moves each byte once.

    W_est = native.row_bits_for(num_reads)
    stream_budget = _stream_budget()
    est_bytes = int(sum(
        os.path.getsize(c + ".lcp") // 4 * 0.6 * (W_est / 8 + 0.925)
        for c in collections))
    # dp-slicing re-emits copies per owner (~1.4x rows at moderate dp),
    # and XLA fragmentation eats headroom — size passes with that margin
    # (the first full-setB2 attempt OOMed exactly here)
    n_pass = max(1, -(-int(est_bytes * 1.4) // stream_budget))
    if n_pass > 1:
        from ..parallel.sharded import pair_rows_local

        rows_local = pair_rows_local(num_reads, n_pass)
    else:
        rows_local = num_reads + 1

    def load(fasta):
        # memmaps: planner IO overlaps the scan (see the single-block
        # loader)
        return (open_lcp(fasta, mmap=True), open_da(fasta, mmap=True),
                open_ebwt(fasta, mmap=True) if config.use_ebwt else None)

    # Hybrid split in the row-blocked regime: host planes are
    # num_reads x num_genomes bytes EACH (the reference's SimArray,
    # 18.8 GB at the full setB2) — allowed only when all F of them fit
    # the host-matrix cap; otherwise the streams carry everything and
    # host memory stays bounded (the mode's original promise).

    host_num = _host_split_for(config, num_reads, num_genomes, wide)
    cell = 4 if wide else 1
    cap = int(os.environ.get("LIME_HOST_MATRIX_CAP", 32 << 30))
    if F * num_reads * num_genomes * cell > cap:
        host_num = 0
    host_dtype = np.uint32 if wide else np.uint8
    planes = {}  # fi -> host-scored dense plane

    plans = []   # per file: (dev_arrays, chunks, windows, row_bits)
    dense_dev = []  # (file, d_ridx, d_gidx, d_cmap, d_rid)
    corr = []
    nxt = {}
    blocked_offload = None  # pair-heavy dense offload, decided on first use

    def prefetch(fi):
        nxt[fi] = load(collections[fi])

    th = None
    with timer.phase("load"):
        arrays = load(collections[0])
    for fi in range(F):
        if fi > 0:
            with timer.phase("load"):
                th.join()
            arrays = nxt.pop(fi)
        if fi + 1 < F:
            th = threading.Thread(target=prefetch, args=(fi + 1,))
            th.start()
        lcp, da, ebwt = arrays
        timer.add_bytes("score", len(lcp) * (9 if config.use_ebwt else 8))
        if host_num == 256:
            # all-host blocked mode: everything scores into this file's
            # plane, so the packed-stream planner's buffers are pure
            # waste — the light cluster scan suffices, and its free
            # per-cluster read counts drive the pair-heavy dense offload
            # (same routing as the single-block job shop)
            with timer.phase("plan"):
                bad_s, bad_l, nrr = native.plan_clusters(
                    lcp, da, num_reads, config.alpha, threads=2,
                    return_nr=True)
            den_s = den_l = np.empty(0, np.int64)
            plans.append((None, [], (1, 1, 1),
                          native.row_bits_for(num_reads)))
            env_off = os.environ.get("LIME_DENSE_OFFLOAD")
            if blocked_offload is None:
                if env_off == "1":
                    blocked_offload = True
                elif env_off == "0" or wide:
                    blocked_offload = False
                else:
                    # same >=5 MB/s fresh-probe gate as the job shop:
                    # a collapsed link keeps the pure-host policy
                    try:
                        blocked_offload = _probe_link_bw() >= 0.005
                    except Exception:  # pragma: no cover
                        blocked_offload = False
            if blocked_offload:
                pairs = nrr * (bad_l - nrr)
                off_min = int(os.environ.get("LIME_DENSE_OFFLOAD_MIN",
                                              256))
                big = (pairs >= off_min) & (bad_l <= 65536)
                if big.any():
                    den_s = np.concatenate([den_s, bad_s[big]]) \
                        if len(den_s) else bad_s[big]
                    den_l = np.concatenate([den_l, bad_l[big]]) \
                        if len(den_l) else bad_l[big]
                    bad_s, bad_l = bad_s[~big], bad_l[~big]
        else:
            with timer.phase("plan"):
                (pk_arrays, chunks, windows, row_bits, den_s, den_l,
                 bad_s, bad_l) = native.plan_pairs_packed(
                    lcp, da, ebwt, num_reads, config.alpha,
                    SYMBOL_RANK_LUT, _DEGENERATE_BYTE.astype(np.uint8),
                    dense_min=dense_min, num_refs=num_genomes,
                    host_num=host_num, dp=n_pass,
                    rows_local=rows_local if n_pass > 1 else 0)
            nb = sum(a.nbytes for a in pk_arrays)
            if n_pass == 1:
                with timer.phase("dispatch", nbytes=nb):
                    plans.append((pair_upload(pk_arrays, chunks), chunks,
                                  windows, row_bits))
            else:
                # host-resident plan; owner subsets upload per pass
                plans.append((pk_arrays, chunks, windows, row_bits))
        if len(den_s):
            d_chunks, left_s, left_l = pack_chunks(
                den_s, den_l, da, ebwt, num_reads, num_genomes, g_pad)
            with timer.phase("dense",
                             nbytes=sum(r.nbytes + g.nbytes
                                        for r, g, _, _ in d_chunks)):
                dense_dev.extend(dense_upload_classes(d_chunks, fi))
            if len(left_s):
                bad_s = np.concatenate([bad_s, left_s])
                bad_l = np.concatenate([bad_l, left_l])
        if len(bad_s):
            total = int(np.asarray(bad_l, np.int64).sum())
            if host_num and native.available():
                # hybrid share: exact SIMD scoring into this file's
                # dense plane (within the host-matrix cap, checked
                # above); per block its row slice compacts to delta-COO
                with timer.phase("host_score", nbytes=total * 5):
                    planes[fi] = np.zeros((num_reads, num_genomes),
                                          host_dtype)
                    from ..constants import IUPAC_WATERFALL_PAIRS

                    native.score_clusters_native(
                        np.asarray(bad_s, np.int64),
                        np.asarray(bad_l, np.int64), np.asarray(da),
                        None if ebwt is None else np.asarray(ebwt),
                        num_reads, num_genomes, SYMBOL_RANK_LUT,
                        _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
                        wide=wide, threads=0, out=planes[fi])
            elif total > (_COO_POSITION_CAP << 6):
                # the stream-only mode's memory promise is "no (R, G)
                # host matrix"; a pathologically degenerate index whose
                # rescue COO would approach that is refused with a
                # clear error rather than OOMing mid-run
                raise ValueError(
                    f"{total} positions route to the exact host scorer "
                    "(IUPAC-degenerate or >255-row clusters) — beyond "
                    "the row-blocked mode's sparse-correction budget. "
                    "Classify this input with the staged host pipeline.")
            else:
                with timer.phase("host_score", nbytes=total * 5):
                    rows, cols, vals = _rescue_sparse(
                        bad_s, bad_l, da, ebwt, num_reads, num_genomes,
                        config)
                    if len(rows):
                        corr.append((fi, rows, cols, vals))
        arrays = None

    # classify constants
    tax = np.zeros(g_pad, np.uint32)
    tax[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_matrix = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
    rank_matrix[:, :num_genomes] = lineage.taxids
    valid_t = np.arange(g_pad) < num_genomes
    norm = jnp.float32(np.uint32(read_len + 1 - config.alpha))
    error = jnp.float32(config.error_tolerance)
    beta = jnp.float32(config.beta)
    taxd = jnp.asarray(tax)
    rankd = jnp.asarray(rank_matrix)
    validd = jnp.asarray(valid_t)

    # one static COO capacity for every block: the total across ALL
    # collections bounds any single block's concatenated count
    corr_k = 256
    corr_total = sum(len(rows) for _, rows, _, _ in corr)
    while corr_k < corr_total:
        corr_k <<= 1

    def _owner_subset(pk_arrays, chunks, owner, row_bits):
        """Concatenated planner buffers + remapped metas for one owner."""
        rows_all, bits_all, gcol_all = pk_arrays
        wpg = row_bits // 4
        rs, bs, gs_, meta2 = [], [], [], []
        wo2 = bo2 = go2 = 0
        for b, own, n_rows, wo, bo, go, gc in chunks:
            if own != owner:
                continue
            lw, lb = n_rows // 8 * wpg, n_rows // 8 * 5
            rs.append(rows_all[wo:wo + lw])
            bs.append(bits_all[bo:bo + lb])
            gs_.append(gcol_all[go:go + gc])
            meta2.append((b, own, n_rows, wo2, bo2, go2, gc))
            wo2 += lw
            bo2 += lb
            go2 += gc
        arrays2 = (
            np.concatenate(rs) if rs else np.empty(0, np.uint32),
            np.concatenate(bs) if bs else np.empty(0, np.uint8),
            np.concatenate(gs_) if gs_ else np.empty(0, np.uint16))
        return arrays2, meta2

    out_t, out_x, out_s = [], [], []

    def do_block(base, plans_pass, hi_rows):
        with timer.phase("block_score"):
            # one (F, B, g_pad) accumulator, scored in place per file —
            # per-file buffers + jnp.stack would transiently double the
            # stack's HBM (OOM at setB2 scale)
            stackd = jnp.zeros((F, B, g_pad), dev_dtype)
            for fi in range(F):
                dev_arrays, chunks, windows, row_bits = plans_pass[fi]
                if chunks:
                    stackd = pair_score_packed_from_device(
                        stackd, dev_arrays, chunks, windows, row_bits,
                        base, fi)
                for dfi, d_ridxs, d_gidxs, d_cmaps, d_rids in dense_dev:
                    if dfi == fi:
                        stackd = _dense_scan_class(
                            stackd, d_ridxs, d_gidxs, d_cmaps, d_rids,
                            jnp.int32(base), B_BLK, C_BLK, PR, f_dim,
                            g_pad, fi)
                if fi in planes:
                    # hybrid share: this block's slice of the host
                    # plane, compacted to delta-COO and scattered into
                    # the stack plane
                    from .pair_score import coo_scatter_into_stack

                    hi_r = min(base + B, num_reads)
                    if hi_r > base:
                        p24 = (not wide) and num_genomes < 4096
                        chain = merge_coo_segments(
                            native.coo_compact(
                                planes[fi][base:hi_r], hi_r - base,
                                num_genomes, wide=wide,
                                max_drow=15 if p24 else 255),
                            max_drow=15 if p24 else 255)
                        if chain is not None:
                            timer.add_bytes(
                                "block_score",
                                len(chain[1]) * (3 if p24 else 7))
                            stackd = coo_scatter_into_stack(
                                stackd, chain, fi, packed24=p24)
        # COO corrections for this block
        cfile = np.empty(0, np.int32)
        crows = ccols = np.empty(0, np.int32)
        cvals = np.empty(0, np.int32)
        if corr:
            fs, rs, cs, vs = [], [], [], []
            for fi, rows, cols, vals in corr:
                sel = (rows >= base) & (rows < base + B)
                fs.append(np.full(int(sel.sum()), fi, np.int32))
                rs.append((rows[sel] - base).astype(np.int32))
                cs.append(cols[sel])
                vs.append(vals[sel])
            cfile = np.concatenate(fs)
            crows = np.concatenate(rs)
            ccols = np.concatenate(cs)
            cvals = np.concatenate(vs)
            pad = corr_k - len(cfile)
            cfile = np.pad(cfile, (0, pad), constant_values=F)
            crows = np.pad(crows, (0, pad))
            ccols = np.pad(ccols, (0, pad))
            cvals = np.pad(cvals, (0, pad))
        with timer.phase("block_classify"):
            packed_res = jax.block_until_ready(_classify_program(
                stackd, jnp.asarray(crows), jnp.asarray(ccols),
                jnp.asarray(cvals), jnp.asarray(cfile), taxd, rankd,
                validd, error, norm, beta, F, config.tax_rank,
                config.assign_higher, not wide, block))
        with timer.phase("block_fetch"):
            # clamp to the owner pass's row range: a block may overrun
            # it (B need not divide rows_local) and the overrun rows are
            # re-scored completely in the next pass
            hi = min(B, num_reads - base, hi_rows - base)
            if hi > 0:
                t_h, x_h, s_h = _unpack_triplet(np.asarray(packed_res))
                out_t.append(t_h[:hi])
                out_x.append(x_h[:hi])
                out_s.append(s_h[:hi])

    for owner in range(n_pass):
        lo = owner * rows_local
        hi_rows = min((owner + 1) * rows_local, num_reads + 1)
        if lo >= hi_rows:
            continue
        if n_pass == 1:
            plans_pass = plans
        else:
            # upload only this owner's chunks; the previous pass's
            # device arrays die here, so stream residency stays at
            # ~total/n_pass
            plans_pass = []
            for pk_arrays, chunks, windows, row_bits in plans:
                if not chunks:  # all-host file: no stream to upload
                    plans_pass.append((None, [], windows, row_bits))
                    continue
                arrays2, meta2 = _owner_subset(pk_arrays, chunks, owner,
                                               row_bits)
                up_nb = sum(a.nbytes for a in arrays2)
                with timer.phase("dispatch", nbytes=up_nb):
                    plans_pass.append((pair_upload(arrays2, meta2),
                                       meta2, windows, row_bits))
            import logging as _logging

            _logging.getLogger("lime_tpu").info(
                "blocked sweep: owner pass %d/%d rows [%d, %d)",
                owner + 1, n_pass, lo, hi_rows)
        for base in range(lo, hi_rows, B):
            do_block(base, plans_pass, hi_rows)
        plans_pass = None

    result = ClassifyResult(np.concatenate(out_t), np.concatenate(out_x),
                            np.concatenate(out_s))
    timer.report()
    return result


def _plan_python(lcp, da, ebwt, num_reads: int, num_genomes: int,
                 config: LimeConfig, use_u16: bool):
    """Vectorized numpy fallback planner (native C++ pass unavailable)."""
    n = len(lcp)
    m = np.asarray(lcp) >= config.alpha
    m[0] = False
    window = 1
    bad_start = np.empty(0, np.int64)
    bad_len = np.empty(0, np.int64)
    d = np.diff(m.view(np.int8))
    run_starts = np.flatnonzero(d == 1) + 1
    run_ends = np.flatnonzero(d == -1) + 1
    if m[-1]:
        run_ends = np.append(run_ends, n)

    gpos = np.empty(0, np.int64)
    within0 = np.empty(0, bool)
    if len(run_starts):
        p_start = run_starts - 1  # cluster rows = run extended one left
        lens = run_ends - p_start
        # membership filter via a prefix-sum of the read-side indicator
        da_arr = np.asarray(da)
        cr = np.concatenate(
            [[0], np.cumsum(da_arr < num_reads, dtype=np.int64)])
        n_read_in = cr[p_start + lens] - cr[p_start]
        mixed = (n_read_in > 0) & (n_read_in < lens)
        p_start, lens = p_start[mixed], lens[mixed]
        if len(p_start):
            # clusters the banded kernel cannot express: longer than the
            # 255 saturation bound, or containing IUPAC-degenerate
            # symbols (the stateful leftover waterfall) — routed to the
            # exact host rescue path
            bad_c = lens > 255
            if config.use_ebwt:
                deg_pos = np.flatnonzero(
                    _DEGENERATE_BYTE[np.asarray(ebwt)])
                if len(deg_pos):
                    cidx = np.searchsorted(p_start, deg_pos,
                                           side="right") - 1
                    inside = ((cidx >= 0)
                              & (deg_pos < p_start[cidx] + lens[cidx]))
                    bad_c[np.unique(cidx[inside])] = True
            bad_idx = np.flatnonzero(bad_c)
            if len(bad_idx):
                bad_start = p_start[bad_idx]
                bad_len = lens[bad_idx]
            keep = ~bad_c
            p_start, lens = p_start[keep], lens[keep]
        if len(p_start):
            window = int(lens.max())
            total = int(lens.sum())
            offs = np.concatenate([[0], np.cumsum(lens[:-1])])
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(offs, lens))
            gpos = np.repeat(p_start, lens) + within
            within0 = within == 0

    nc = len(gpos)
    n_pad = max(_BLOCK, -(-nc // _BLOCK) * _BLOCK)
    sym_c = (SYMBOL_RANK_LUT[np.asarray(ebwt[gpos])] if config.use_ebwt
             else np.zeros(nc, np.uint8))
    mbit = np.logical_not(within0).astype(np.uint8) << _M_BIT
    packed = np.pad(sym_c | mbit, (0, n_pad - nc))
    # pad doc with an out-of-range id: never a read, never a genome
    doc = np.pad(np.asarray(da[gpos]).astype(
        np.uint16 if use_u16 else np.int32), (0, n_pad - nc),
        constant_values=num_reads + num_genomes)
    return packed, doc, window, bad_start, bad_len
