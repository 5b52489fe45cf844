"""Sharded fused pipeline: scan + score + classify in one SPMD program.

**Banded formulation.**  With every cluster bounded by ``window`` positions
(the aux metadata's max_len, reference src/ClusterLCP.cpp:307, gives the
bound), any scoring pair (i-o, i) lies within ``o <= window``, and "same
cluster" for the pair is AND(m[k], k in (i-o, i]) where m = lcp >= alpha.
The whole step-1 + step-2 pipeline then becomes banded vector ops over the
position stream — no cluster list is ever materialized:

- occurrence index: occ[i] = sum_{o=1..window} [same-cluster & same doc &
  same symbol at distance o]
- pair scores: for each offset o, match (symbol, occ) between i and i-o and
  scatter-add 1 into the similarity matrix for (read, genome) pairs —
  the occurrence-matching identity from ops/fused_pass.py.

**SPMD layout** over a 2D (sp, dp) mesh:

- the (F, N) position arrays are range-sharded over the flattened
  (sp, dp) axes; each shard fetches a 2*window left halo from its
  predecessor with ppermute — the reference's boundary-straddle protocol
  (src/ClusterLCP.cpp:196-264) as one collective;
- each shard accumulates a partial (F, R, G) matrix for its positions;
  psum_scatter over dp hands every dp group its read-row block,
  then a psum over sp merges the position shards;
- normalization + beta gating + the 4-stage classify cascade run on the
  local row block with no further communication.

Every pair is emitted exactly once, by the shard owning its *later*
position.  Window must be <= 255 so occurrence indices stay below the
genome-counter saturation bound (reference src/ClusterBWT_DA.cpp:96).
The banded path asserts no IUPAC-degenerate symbols in the stream
(production routing sends degenerate clusters to the exact path; see
ops/fused_pass.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..constants import SCATTER_DROP

_PAD_W = 256  # static pad width; window is a traced value <= 255


def _bwd(padded: jnp.ndarray, o) -> jnp.ndarray:
    """Element i-o of the unpadded array, given pads of ``_PAD_W``."""
    length = padded.shape[-1] - 2 * _PAD_W
    return lax.dynamic_slice_in_dim(padded, _PAD_W - o, length, axis=-1)


def _fwd(padded: jnp.ndarray, o) -> jnp.ndarray:
    """Element i+o of the unpadded array, given pads of ``_PAD_W``."""
    length = padded.shape[-1] - 2 * _PAD_W
    return lax.dynamic_slice_in_dim(padded, _PAD_W + o, length, axis=-1)


def _pad2(x, fill=0):
    return jnp.pad(x, (_PAD_W, _PAD_W), constant_values=fill)


def banded_partial_sim(m, doc, sym, num_reads: int, num_refs: int,
                       window, emit_ok: Optional[jnp.ndarray] = None,
                       out_rows: Optional[int] = None,
                       acc_dtype=jnp.int32) -> jnp.ndarray:
    """Partial similarity matrix from one position stream.

    - ``m``: the in-run indicator lcp >= alpha, with position 0 forced False
      (the reference's skip-leading rule, src/ClusterLCP.cpp:196-202).
    - ``window``: max cluster length, traced (<= 255 so genome occurrence
      indices stay below the saturation bound, src/ClusterBWT_DA.cpp:96);
      one compiled program serves every window.
    - ``emit_ok``: positions allowed to *emit* pairs.  Every scored pair has
      exactly one read-side element, and that element emits it — so shard
      ownership and cluster routing gate read positions only.
    - ``out_rows``: when None (legacy), returns ``(num_reads, num_refs)``
      sliced exact; otherwise returns the raw padded accumulator
      ``(out_rows, g_pad)`` with the scatter drop row at index
      ``num_reads`` (rows past it stay zero) — the memory-plan shape for
      paper-scale runs, where the caller classifies blockwise and never
      materializes a sliced copy.
    - ``acc_dtype``: accumulator dtype.  ``int8`` wraps mod 256 on overflow,
      which IS the reference's unsaturated uchar SimArray semantics
      (src/ClusterBWT_DA.cpp:183) — at 1/4 the HBM of int32.

    The kernel performs exactly one scatter-add: each read position
    accumulates a per-genome count vector V[i, :] across all banded
    offsets (the genome partner enters as
    a one-hot compare, an elementwise (L, G) op), and V is segment-summed
    by read id at the end.  The o-loops themselves are pure elementwise
    passes over the stream.
    """
    L = m.shape[-1]
    doc = doc.astype(jnp.int32)
    sym = sym.astype(jnp.int32)
    if emit_ok is None:
        emit_ok = jnp.ones(L, dtype=bool)
    g_pad = (max(128, -(-num_refs // 128) * 128) if out_rows is not None
             else num_refs)
    n_rows = out_rows if out_rows is not None else num_reads + 1

    pad_m = _pad2(m)
    pad_doc = _pad2(doc, -1)
    pad_sym = _pad2(sym, -1)

    def occ_step(o, carry):
        and_c, occ = carry
        same = and_c & (doc == _bwd(pad_doc, o)) & (sym == _bwd(pad_sym, o))
        occ = occ + same.astype(jnp.int32)
        and_c = and_c & _bwd(pad_m, o)
        return and_c, occ

    _, occ = lax.fori_loop(1, window + 1, occ_step,
                           (m, jnp.zeros(L, jnp.int32)))
    pad_occ = _pad2(occ, -1)

    is_read = doc < num_reads
    g_ids = jnp.arange(g_pad, dtype=jnp.int32)[None, :]

    def pair_step(o, carry):
        and_c, V = carry
        # backward genome partner q = i - o
        db = _bwd(pad_doc, o)
        hit_b = (and_c & (sym == _bwd(pad_sym, o))
                 & (occ == _bwd(pad_occ, o)) & (db >= num_reads))
        # forward genome partner q = i + o; same-cluster over (i, i+o] is
        # the backward AND-accumulator evaluated at i+o
        and_f = _fwd(_pad2(and_c), o)
        df = _fwd(pad_doc, o)
        hit_f = (and_f & (sym == _fwd(pad_sym, o))
                 & (occ == _fwd(pad_occ, o)) & (df >= num_reads))
        V = V + (hit_b[:, None] & (db[:, None] - num_reads == g_ids)
                 ).astype(jnp.int16)
        V = V + (hit_f[:, None] & (df[:, None] - num_reads == g_ids)
                 ).astype(jnp.int16)
        and_c = and_c & _bwd(pad_m, o)
        return and_c, V

    _, V = lax.fori_loop(1, window + 1, pair_step,
                         (m, jnp.zeros((L, g_pad), jnp.int16)))

    emit = is_read & emit_ok
    rows = jnp.where(emit, doc, SCATTER_DROP)
    Vm = jnp.where(emit[:, None], V, 0)
    sim = _scatter_sim(Vm, rows, num_reads, n_rows=n_rows,
                       acc_dtype=acc_dtype)
    if out_rows is not None:
        return sim
    return sim[:num_reads, :num_refs]


def _scatter_sim(v, rows, num_reads: int, n_rows: Optional[int] = None,
                 acc_dtype=jnp.int32) -> jnp.ndarray:
    """Segment-sum V rows by read id into a (n_rows, G) accumulator.

    Split into independent partial scatters when the accumulator is small
    (they can pipeline), but fall back to one scatter when k copies of the
    matrix would cost real HBM (the paper-scale regime, where the
    accumulator is the dominant allocation).
    """
    L, g_pad = v.shape
    if n_rows is None:
        n_rows = num_reads + 1
    k = 8 if n_rows * g_pad <= (1 << 24) else 1
    chunk = -(-L // k)
    sim = jnp.zeros((n_rows, g_pad), acc_dtype)
    parts = [
        jnp.zeros((n_rows, g_pad), acc_dtype)
        .at[rows[i * chunk:(i + 1) * chunk], :]
        .add(v[i * chunk:(i + 1) * chunk].astype(acc_dtype), mode="drop")
        for i in range(k)
    ]
    for p in parts:
        sim = sim + p
    return sim


def banded_fused_step(lcp, da, sym, num_reads: int, num_refs: int,
                      alpha: int, window: int) -> jnp.ndarray:
    """Single-device fused scan+score forward step (the flagship jit)."""
    L = lcp.shape[-1]
    m = (lcp >= alpha) & (jnp.arange(L) != 0)
    return banded_partial_sim(m, da, sym, num_reads, num_refs,
                              jnp.int32(window))


_HALO_L_SPMD = 512  # static halo capacity: 2*W_MAX occ lookback
_HALO_R_SPMD = 256  # forward partners; window itself is traced <= 255


def make_sharded_pipeline(mesh, num_files: int, num_reads: int,
                          num_refs: int, read_len: int, alpha: int,
                          beta: float, tax_rank: int, assign_higher: bool,
                          wide_sim: bool = False, max_corr: int = 0,
                          dense_corr: bool = False, dense_chunks: int = 0,
                          dense_f: int = 32):
    """Build the jitted SPMD pipeline step over ``mesh`` (axes sp, dp).

    The step consumes *planned* compacted streams (see native lime_plan /
    ops.fused_pipeline): per file, one packed byte (bit 6 = in-run mask with
    a cluster's first row cleared, bits 0..3 = symbol rank) and one doc id
    per surviving position.  Clusters the banded kernel cannot express
    (IUPAC-degenerate, longer than 255 — the reference's full input domain,
    src/ClusterBWT_DA.cpp:146-177 + Tools.h:35) arrive as a sparse COO
    correction computed by the exact host scorer.

    Returns ``step(packed, doc, window, corr..., tax, rank_matrix, valid_t,
    error)``:

    - ``packed (F, Np) u8`` / ``doc (F, Np) i32``: sharded P(None, (sp, dp));
      Np must be divisible by sp*dp (driver pads; pad doc ids must be
      >= num_reads + num_refs).
    - ``window``: traced i32 <= 255 — one compiled program serves any
      cluster-length bound.
    - ``corr_*``: fixed-size COO (file, row, col, val) with out-of-range
      file index on padding (scatter mode='drop').
    - outputs (types, taxid, sim) are (r_pad,) sharded P("dp"); rows past
      ``num_reads`` are junk (scatter drop row + pad) for the caller to
      slice off.

    SPMD layout: each shard fetches a left/right halo of raw stream from its
    neighbors with ppermute — the reference's boundary-straddle protocol
    (src/ClusterLCP.cpp:196-264) as one collective — accumulates a partial
    (r_pad, G_pad) int8 matrix for its positions (int8 wrap = the
    reference's uchar counters), psum_scatter over dp hands every dp group
    its read-row block, a psum over sp merges position shards, and the
    blockwise cascade runs on local rows with no further communication.
    """
    from ..ops.classify_tpu import blockwise_cascade, classify_block_size

    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    g_pad = max(128, -(-num_refs // 128) * 128)
    block = classify_block_size(-(-(num_reads + 1) // dp))
    rows_local = -(-(num_reads + 1) // (dp * block)) * block
    r_pad = rows_local * dp
    acc_dtype = jnp.int32 if wide_sim else jnp.int8
    beta_f = jnp.float32(beta)
    halo_l, halo_r = _HALO_L_SPMD, _HALO_R_SPMD

    def shard_fn(packed, doc, window, cfile, crows, ccols, cvals, hostm,
                 d_ridx, d_gidx, d_cmap, d_rid, d_file,
                 tax, rank_matrix, valid_t, error, norm):
        # ``norm`` is a traced argument on purpose: as a constant XLA would
        # strength-reduce x/norm to x*(1/norm), losing bit-parity with the
        # reference's float division (src/ClusterBWT_DA.cpp:404).
        sp_i = lax.axis_index("sp")
        dp_i = lax.axis_index("dp")

        def from_prev(x, size, fill=0):
            """Last ``size`` elements of the previous position shard."""
            tail = x[:, -size:]
            same_row = (lax.ppermute(
                tail, "dp", [(i, i + 1) for i in range(dp - 1)])
                if dp > 1 else jnp.zeros_like(tail))
            wrapped = (lax.ppermute(tail, "dp", [(dp - 1, 0)])
                       if dp > 1 else tail)
            prev_row = (lax.ppermute(
                wrapped, "sp", [(i, i + 1) for i in range(sp - 1)])
                if sp > 1 else jnp.zeros_like(tail))
            fill_blk = jnp.full_like(tail, fill)
            return jnp.where(dp_i > 0, same_row,
                             jnp.where(sp_i > 0, prev_row, fill_blk))

        def from_next(x, size, fill=0):
            """First ``size`` elements of the next position shard."""
            head = x[:, :size]
            same_row = (lax.ppermute(
                head, "dp", [(i + 1, i) for i in range(dp - 1)])
                if dp > 1 else jnp.zeros_like(head))
            wrapped = (lax.ppermute(head, "dp", [(0, dp - 1)])
                       if dp > 1 else head)
            next_row = (lax.ppermute(
                wrapped, "sp", [(i + 1, i) for i in range(sp - 1)])
                if sp > 1 else jnp.zeros_like(head))
            fill_blk = jnp.full_like(head, fill)
            return jnp.where(dp_i < dp - 1, same_row,
                             jnp.where(sp_i < sp - 1, next_row, fill_blk))

        def extend(x, fill=0):
            # left halo 2*W_MAX (occ lookback of backward partners), right
            # halo W_MAX (forward partners + their occ lookback)
            return jnp.concatenate(
                [from_prev(x, halo_l, fill), x,
                 from_next(x, halo_r, fill)], axis=1)

        if packed.shape[1] < halo_l:
            # the halo collects from ONE neighbor; a shard narrower than a
            # halo cannot supply it (driver pads to n_shards * halo_l)
            raise ValueError(
                f"per-shard stream ({packed.shape[1]}) must be >= the halo "
                f"capacity ({halo_l}); pad the position stream")

        pk_e = extend(packed)
        # pad doc ids are already out of range; halo fill matches
        da_e = extend(doc, fill=num_reads + num_refs)

        L = pk_e.shape[1]
        idx = jnp.arange(L)
        n_local = packed.shape[1]
        emit_ok = (idx >= halo_l) & (idx < halo_l + n_local)

        m_e = ((pk_e >> 6) & 1).astype(bool)
        sym_e = (pk_e & 15).astype(jnp.int8)

        partial = jax.vmap(
            lambda m1, d, s: banded_partial_sim(
                m1, d, s, num_reads, num_refs, window, emit_ok=emit_ok,
                out_rows=r_pad, acc_dtype=acc_dtype)
        )(m_e, da_e, sym_e)  # (F, r_pad, G_pad) partial for this shard

        if dense_chunks:
            # tensor-core histogram-matmul chunks for genome-dense clusters
            # (ops/dense_score.py), round-robined over the flattened
            # (sp, dp) shards; every pair is emitted by exactly one shard,
            # so the psum below merges them like the banded partials.
            from ..ops.dense_score import B_BLK as _DB
            from ..ops.dense_score import C_BLK as _DC
            from ..ops.dense_score import PR as _DP

            def chunk_body(part, inp):
                ridx, gidx, cmapc, ridc, fidx = inp
                one = jnp.ones((), jnp.bfloat16)
                phi = (jnp.zeros((_DB * _DP * dense_f,), jnp.bfloat16)
                       .at[ridx].add(one, mode="drop")
                       .reshape(_DB, _DP, dense_f))
                psi = (jnp.zeros((_DC * g_pad * dense_f,), jnp.bfloat16)
                       .at[gidx].add(one, mode="drop")
                       .reshape(_DC, g_pad, dense_f))
                out = jnp.einsum("bpf,bgf->bpg", phi, psi[cmapc],
                                 preferred_element_type=jnp.float32)
                add = out.reshape(_DB * _DP, g_pad).astype(jnp.int32)
                part = part.at[fidx, ridc].add(add.astype(part.dtype),
                                               mode="drop")
                return part, 0

            partial, _ = lax.scan(
                chunk_body, partial,
                (d_ridx, d_gidx, d_cmap, d_rid, d_file))

        # Row-shard over dp, then merge position shards over sp.  int8
        # partial sums wrap mod 256 = the reference's uchar SimArray
        # accumulation (src/ClusterBWT_DA.cpp:183).
        sims = lax.psum_scatter(partial, "dp", scatter_dimension=1,
                                tiled=True)  # (F, rows_local, G_pad)
        sims = lax.psum(sims, "sp")

        # host-scored cluster corrections for this shard's row block
        if max_corr:
            local_r = crows - dp_i * rows_local
            ok = (local_r >= 0) & (local_r < rows_local)
            sims = sims.at[
                jnp.where(ok, cfile, num_files), local_r, ccols].add(
                cvals.astype(sims.dtype), mode="drop")
        if dense_corr:
            # density-routed host matrix, row-sharded over dp like sims
            sims = sims + hostm.astype(sims.dtype)

        return blockwise_cascade(sims, tax, rank_matrix, valid_t, error,
                                 norm, beta_f, num_files, tax_rank,
                                 assign_higher, not wide_sim, block)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, ("sp", "dp")), P(None, ("sp", "dp")), P(),
                  P(), P(), P(), P(), P(None, "dp", None),
                  P(("sp", "dp")), P(("sp", "dp")), P(("sp", "dp")),
                  P(("sp", "dp")), P(("sp", "dp")),
                  P(), P(), P(), P(), P()),
        out_specs=(P("dp"), P("dp"), P("dp")),
        check_vma=False,
    )
    jitted = jax.jit(mapped)
    norm = jnp.float32(np.uint32(read_len + 1 - alpha))
    host_dtype = np.uint32 if wide_sim else np.uint8
    hostm_dummy = np.zeros((num_files, dp, g_pad), host_dtype)
    n_shards = sp * dp
    from ..ops.dense_score import B_BLK as _DB
    from ..ops.dense_score import GT_CAP as _DG
    from ..ops.dense_score import PR as _DP
    from ..ops.dense_score import RT_CAP as _DR
    n_ch = n_shards * dense_chunks
    dense_dummy = (np.zeros((n_ch, _DR), np.int32),
                   np.zeros((n_ch, _DG), np.int32),
                   np.zeros((n_ch, _DB), np.int32),
                   np.zeros((n_ch, _DB * _DP), np.int32),
                   np.full(n_ch, num_files, np.int32))

    def step(packed, doc, window, cfile, crows, ccols, cvals, tax,
             rank_matrix, valid_t, error, hostm=None, dense=None):
        if hostm is None:
            hostm = hostm_dummy  # (F, dp, g_pad): one zero row per shard
        if dense_corr and hostm.shape[1] != r_pad:
            padded = np.zeros((num_files, r_pad, g_pad), host_dtype)
            padded[:, :hostm.shape[1], :hostm.shape[2]] = hostm
            hostm = padded
        if dense is None:
            dense = dense_dummy
        return jitted(packed, doc, jnp.asarray(window, jnp.int32), cfile,
                      crows, ccols, cvals, hostm, *dense, tax, rank_matrix,
                      valid_t, error, norm)

    return step


def run_sharded(collections, output_path: str, num_reads: int,
                num_genomes: int, lineage_path: str, read_len: int,
                config=None, mesh=None):
    """End-to-end SPMD run: plan on host, classify on the device mesh.

    The multi-chip counterpart of ops.fused_pipeline.run_fused — handles the
    reference's full input domain (IUPAC-degenerate symbols and clusters up
    to 65,536 via the host-rescue COO path).

    Under ``jax.distributed`` (process_count() > 1) this dispatches to the
    multi-process path: every process plans only ITS index range
    (parallel.multihost.plan_host_range — the reference's per-thread
    byte-range decomposition, src/ClusterLCP.cpp:100-167, lifted to
    hosts), assembles its local shards with
    jax.make_array_from_process_local_data, and the same SPMD program
    runs over the global mesh.
    """
    import jax as _jax

    if _jax.process_count() > 1:
        return _run_sharded_multiprocess(collections, output_path,
                                         num_reads, num_genomes,
                                         lineage_path, read_len, config,
                                         mesh)
    from ..config import DEFAULT_CONFIG
    from ..constants import SYMBOL_RANK_LUT
    from ..formats.arrays import open_da, open_ebwt, open_lcp
    from ..formats.lineage import read_lineage
    from ..ops.classify_ops import ClassifyResult
    from ..ops.fused_pass import _DEGENERATE_BYTE
    from ..ops.dense_score import K as _DK
    from ..ops.dense_score import pack_chunks
    from ..ops.fused_pipeline import (
        _dense_min_for,
        _dense_threshold_for,
        _plan_python,
        _rescue,
    )
    from .. import native
    from .mesh import make_mesh

    config = config or DEFAULT_CONFIG
    if mesh is None:
        mesh = make_mesh(len(jax.devices()))
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("sharded run takes 2 or 4 collections")
    lineage = read_lineage(lineage_path)
    n_shards = mesh.shape["sp"] * mesh.shape["dp"]
    g_dense = _dense_threshold_for(num_genomes, config)
    dense_min = _dense_min_for(num_genomes, config)
    g_pad = max(128, -(-num_genomes // 128) * 128)

    packs, docs, windows = [], [], []
    corr = []
    host_mats = {}
    dense_chunk_list = []  # (file, ridx, gidx, cmap, rid)
    for fi, fasta in enumerate(collections):
        lcp = open_lcp(fasta)
        da = open_da(fasta)
        ebwt = open_ebwt(fasta) if config.use_ebwt else None
        if native.available():
            (packed, doc, nc, window, bad_s, bad_l, den_s,
             den_l) = native.plan_native(
                lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
                _DEGENERATE_BYTE, use_u16=False, pad_block=1,
                pad_doc=num_reads + num_genomes, g_dense=g_dense,
                dense_min=dense_min)
        else:
            packed, doc, window, bad_s, bad_l = _plan_python(
                lcp, da, ebwt, num_reads, num_genomes, config,
                use_u16=False)
            den_s = den_l = np.empty(0, np.int64)
        packs.append(packed)
        docs.append(doc.astype(np.int32))
        windows.append(window)
        if len(den_s):
            chunks_f, left_s, left_l = pack_chunks(
                den_s, den_l, da, ebwt, num_reads, num_genomes, g_pad)
            dense_chunk_list.extend((fi, *c) for c in chunks_f)
            if len(left_s):
                bad_s = np.concatenate([bad_s, left_s])
                bad_l = np.concatenate([bad_l, left_l])
        if len(bad_s):
            res = _rescue(bad_s, bad_l, da, ebwt, num_reads, num_genomes,
                          config)
            if res[0] == "dense":
                host_mats[fi] = res[1]
            elif len(res[1]):
                corr.append((fi, *res[1:]))

    # every shard must be at least one halo wide (see shard_fn's guard)
    n_p = max(max(len(p) for p in packs), n_shards * _HALO_L_SPMD)
    n_p = -(-n_p // n_shards) * n_shards
    packed = np.zeros((F, n_p), np.uint8)
    doc = np.full((F, n_p), num_reads + num_genomes, np.int32)
    for fi in range(F):
        packed[fi, :len(packs[fi])] = packs[fi]
        doc[fi, :len(docs[fi])] = docs[fi]

    if corr:
        cfile = np.concatenate(
            [np.full(len(r), fi, np.int32) for fi, r, _, _ in corr])
        crows = np.concatenate([r for _, r, _, _ in corr]).astype(np.int32)
        ccols = np.concatenate([c for _, _, c, _ in corr]).astype(np.int32)
        cvals = np.concatenate([v for _, _, _, v in corr]).astype(np.int32)
        k = max(256, 1 << int(np.ceil(np.log2(len(cfile)))))
        pad = k - len(cfile)
        cfile = np.pad(cfile, (0, pad), constant_values=F)
        crows = np.pad(crows, (0, pad))
        ccols = np.pad(ccols, (0, pad))
        cvals = np.pad(cvals, (0, pad))
        max_corr = k
    else:
        cfile = crows = ccols = np.empty(0, np.int32)
        cvals = np.empty(0, np.int32)
        max_corr = 0

    tax = np.zeros(g_pad, np.uint32)
    tax[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_matrix = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
    rank_matrix[:, :num_genomes] = lineage.taxids
    valid_t = np.arange(g_pad) < num_genomes

    hostm = None
    if host_mats:
        host_dtype = np.uint32 if config.wide_sim else np.uint8
        hostm = np.zeros((F, num_reads, num_genomes), host_dtype)
        for fi, mat in host_mats.items():
            hostm[fi] = mat

    dense = None
    dense_chunks = 0
    if dense_chunk_list:
        from ..ops.dense_score import B_BLK as _DB
        from ..ops.dense_score import C_BLK as _DC
        from ..ops.dense_score import GT_CAP as _DG
        from ..ops.dense_score import PR as _DP
        from ..ops.dense_score import RT_CAP as _DR

        f_dim = (4 if config.use_ebwt else 1) * _DK
        n_ch = -(-len(dense_chunk_list) // n_shards) * n_shards
        d_ridx = np.full((n_ch, _DR), _DB * _DP * f_dim, np.int32)
        d_gidx = np.full((n_ch, _DG), _DC * g_pad * f_dim, np.int32)
        d_cmap = np.zeros((n_ch, _DB), np.int32)
        d_rid = np.full((n_ch, _DB * _DP), SCATTER_DROP, np.int32)
        d_file = np.full(n_ch, F, np.int32)
        for i, (fi, ridx, gidx, cmap_c, rid_c) in \
                enumerate(dense_chunk_list):
            # pack_chunks pads triples to powers of two, not the full
            # caps; the scan body here needs uniform cap-sized rows (the
            # fill values are already drop indices)
            d_ridx[i, :len(ridx)] = ridx
            d_gidx[i, :len(gidx)] = gidx
            d_cmap[i], d_rid[i], d_file[i] = cmap_c, rid_c, fi
            dense_chunk_list[i] = None  # free as copied (host RAM)
        dense = (d_ridx, d_gidx, d_cmap, d_rid, d_file)
        dense_chunks = n_ch // n_shards
    step = make_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        wide_sim=config.wide_sim, max_corr=max_corr,
        dense_corr=hostm is not None, dense_chunks=dense_chunks,
        dense_f=(4 if config.use_ebwt else 1) * _DK)
    types, taxid, sim = step(packed, doc, max(windows), cfile, crows,
                             ccols, cvals, tax, rank_matrix, valid_t,
                             jnp.float32(config.error_tolerance),
                             hostm=hostm, dense=dense)
    res = ClassifyResult(np.asarray(types)[:num_reads],
                         np.asarray(taxid)[:num_reads],
                         np.asarray(sim)[:num_reads])
    if output_path:
        from ..pipeline import _write_csv_block

        with open(output_path, "w") as out:
            out.write("C/U/A/H,IdSeqRead,TaxID,maxSim\n")
            _write_csv_block(out, 0, res)
    return res


def _allgather_np(x: np.ndarray, pad_to: int, fill) -> np.ndarray:
    """Gather variable-length per-process 1D arrays (padded, then stacked)."""
    from jax.experimental import multihost_utils

    padded = np.full(pad_to, fill, dtype=x.dtype)
    padded[:len(x)] = x
    return np.asarray(multihost_utils.process_allgather(padded))


def _run_sharded_multiprocess(collections, output_path: str,
                              num_reads: int, num_genomes: int,
                              lineage_path: str, read_len: int,
                              config=None, mesh=None):
    """Multi-process run_sharded: per-host range planning + local shards.

    Every process memmaps and plans only its position range of each
    collection (straddle-extended at the boundaries), host-rescues its
    own inexpressible clusters, and contributes its padded local block of
    the global (F, N) stream via make_array_from_process_local_data.  The
    small COO corrections and windows are allgathered so replicated
    inputs are identical everywhere.  Outputs (row-sharded over dp) are
    allgathered back; only process 0 writes the CSV.  Assignments are
    bit-identical to the single-process run: the per-host concatenated
    cluster set equals the whole-file plan (tests/test_multihost.py) and
    score accumulation commutes.
    """
    from ..config import DEFAULT_CONFIG
    from ..formats.lineage import read_lineage
    from ..ops.classify_ops import ClassifyResult
    from ..ops.fused_pipeline import _rescue_sparse
    from .mesh import make_mesh
    from .multihost import plan_host_range
    from jax.experimental import multihost_utils

    config = config or DEFAULT_CONFIG
    pid, nproc = jax.process_index(), jax.process_count()
    if mesh is None:
        mesh = make_mesh(len(jax.devices()))
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("sharded run takes 2 or 4 collections")
    lineage = read_lineage(lineage_path)
    n_shards = mesh.shape["sp"] * mesh.shape["dp"]
    # any process/device split works: every process contributes
    # local_shards shards of a globally agreed uniform shard length (the
    # reference accepts any thread count, src/ClusterLCP.cpp:139-141)
    local_shards = int(mesh.local_mesh.devices.size)
    g_pad = max(128, -(-num_genomes // 128) * 128)

    packs, docs = [], []
    windows = 1
    corr_local = []
    for fi, fasta in enumerate(collections):
        packed, doc, window, bad_s, bad_l, _ = plan_host_range(
            fasta, num_reads, num_genomes, config.alpha, nproc, pid,
            use_ebwt=config.use_ebwt, g_dense=0, use_u16=False)
        packs.append(packed)
        docs.append(doc.astype(np.int32))
        windows = max(windows, window)
        if len(bad_s):
            from ..formats.arrays import open_da, open_ebwt

            da = open_da(fasta, mmap=True)
            ebwt = (open_ebwt(fasta, mmap=True) if config.use_ebwt
                    else None)
            rows, cols, vals = _rescue_sparse(
                bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
            if len(rows):
                corr_local.append((np.full(len(rows), fi, np.int32),
                                   rows, cols, vals))

    # agree on the global layout: window max + a uniform SHARD length
    # (local block lengths then scale with each process's device count,
    # so uneven processes-per-device splits work)
    local_len = max(len(p) for p in packs)
    sizes = np.asarray(multihost_utils.process_allgather(
        np.array([local_len, windows, local_shards], np.int64)))
    windows = int(sizes[:, 1].max())
    shard_len = max(_HALO_L_SPMD,
                    int(np.max(-(-sizes[:, 0] // sizes[:, 2]))))
    assert int(sizes[:, 2].sum()) == n_shards
    L_loc = shard_len * local_shards
    packed = np.zeros((F, L_loc), np.uint8)
    doc = np.full((F, L_loc), num_reads + num_genomes, np.int32)
    for fi in range(F):
        packed[fi, :len(packs[fi])] = packs[fi]
        doc[fi, :len(docs[fi])] = docs[fi]

    # gather the (small) COO corrections so replicated inputs match
    if corr_local:
        lf = np.concatenate([c[0] for c in corr_local])
        lr = np.concatenate([c[1] for c in corr_local]).astype(np.int32)
        lc = np.concatenate([c[2] for c in corr_local]).astype(np.int32)
        lv = np.concatenate([c[3] for c in corr_local]).astype(np.int32)
    else:
        lf = lr = lc = lv = np.empty(0, np.int32)
    n_corr = int(np.asarray(multihost_utils.process_allgather(
        np.array([len(lf)], np.int64))).max())
    if n_corr:
        k = max(256, 1 << int(np.ceil(np.log2(max(n_corr, 2)))))
        cfile = _allgather_np(lf, k, F).reshape(-1)
        crows = _allgather_np(lr, k, 0).reshape(-1)
        ccols = _allgather_np(lc, k, 0).reshape(-1)
        cvals = _allgather_np(lv, k, 0).reshape(-1)
        max_corr = len(cfile)
    else:
        cfile = crows = ccols = np.empty(0, np.int32)
        cvals = np.empty(0, np.int32)
        max_corr = 0

    tax = np.zeros(g_pad, np.uint32)
    tax[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_matrix = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
    rank_matrix[:, :num_genomes] = lineage.taxids
    valid_t = np.arange(g_pad) < num_genomes

    from jax.sharding import NamedSharding

    stream_sharding = NamedSharding(mesh, P(None, ("sp", "dp")))
    packed_g = jax.make_array_from_process_local_data(
        stream_sharding, packed, (F, shard_len * n_shards))
    doc_g = jax.make_array_from_process_local_data(
        stream_sharding, doc, (F, shard_len * n_shards))

    step = make_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        wide_sim=config.wide_sim, max_corr=max_corr)
    types, taxid, sim = step(packed_g, doc_g, windows, cfile, crows,
                             ccols, cvals, tax, rank_matrix, valid_t,
                             jnp.float32(config.error_tolerance))
    types = np.asarray(multihost_utils.process_allgather(types,
                                                         tiled=True))
    taxid = np.asarray(multihost_utils.process_allgather(taxid,
                                                         tiled=True))
    sim = np.asarray(multihost_utils.process_allgather(sim, tiled=True))
    res = ClassifyResult(types[:num_reads], taxid[:num_reads],
                         sim[:num_reads])
    if output_path and pid == 0:
        from ..pipeline import _write_csv_block

        with open(output_path, "w") as out:
            out.write("C/U/A/H,IdSeqRead,TaxID,maxSim\n")
            _write_csv_block(out, 0, res)
    return res


def pair_rows_local(num_reads: int, dp: int) -> int:
    """Read rows owned per dp shard (cascade-block aligned).

    Shared by the planner call sites and the SPMD step so the plan-time
    ownership split and the device row slicing can never diverge.
    """
    from ..ops.classify_tpu import classify_block_size

    block = classify_block_size(-(-(num_reads + 1) // dp))
    return -(-(num_reads + 1) // (dp * block)) * block


def pair_comm_model(mesh, num_files: int, num_reads: int, num_refs: int,
                    wide_sim: bool = False) -> dict:
    """Per-device collective volume of one dp-sliced pair SPMD step.

    The only collective is the sp-psum of the LOCAL (F, rows_local,
    g_pad) block — the term scales with rows_local = ceil(R / dp), not
    with the full read count (round 3's engine psum'd full (F, r_pad,
    g_pad) partials per device, the term that killed the scaling model).
    Bytes follow the bidirectional-ring estimate 2 * (sp-1)/sp * bytes.
    """
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    g_pad = max(128, -(-num_refs // 128) * 128)
    rows_local = pair_rows_local(num_reads, dp)
    cell = 4 if wide_sim else 1
    block_bytes = num_files * rows_local * g_pad * cell
    return {
        "mesh": (sp, dp),
        "rows_local": rows_local,
        "per_device_hbm_bytes": block_bytes,
        "psum_axis": "sp",
        "psum_bytes_per_device": int(2 * (sp - 1) / sp * block_bytes)
        if sp > 1 else 0,
        "dp_collective_bytes": 0,  # ownership split at plan time
    }


def make_pair_sharded_pipeline(mesh, num_files: int, num_reads: int,
                               num_refs: int, read_len: int, alpha: int,
                               beta: float, tax_rank: int,
                               assign_higher: bool, row_bits: int,
                               n_chunks: int, wide_sim: bool = False,
                               max_corr: int = 0):
    """dp-sliced SPMD pair-stream pipeline: chunk-parallel, no halos.

    The packed pair planner emits copy-aligned chunks (a cluster copy
    never straddles a chunk) ALREADY SPLIT by read-row ownership
    (plan_pairs_packed dp/rows_local): a copy is re-emitted per dp
    shard owning at least one of its read docs, with only that shard's
    read rows plus the genome rows — occurrence matching is
    per-document, so sub-copy scores are exact.  Shard (sp_i, dp_j)
    receives only owner-j chunks and accumulates a LOCAL
    (F, rows_local, g_pad) block (int8 wrap = the reference's uchar
    counters); the ONLY collective is a psum over sp of that block, so
    both per-device HBM and comm volume scale with rows_local =
    ceil(R / dp) — this is how matrices beyond one chip's HBM (the
    reference's 18.8 GB SimArray at setB2 scale,
    src/ClusterBWT_DA.cpp:606-611) run on a mesh.

    Inputs to the returned ``step``: uniform (n_chunks, ...) arrays —
    ``rows_w`` u32, ``bits`` u8, ``gcol`` u16 (each chunk's gcol padded
    to ``gcap``), ``cfile`` i32 (collection of each chunk; >= num_files
    marks a pad chunk), ``cwin`` i32 per-chunk window — sharded
    P(("sp", "dp")) on the chunk axis with owner-j chunks in dp-slot j
    — plus the COO corrections and classify constants.
    """
    from ..ops.classify_tpu import blockwise_cascade, classify_block_size
    from ..ops.pair_score import _hits_dispatch, _unpack_bits5, \
        _unpack_rows

    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    n_shards = sp * dp
    if n_chunks % n_shards:
        raise ValueError("n_chunks must be padded to the shard count")
    g_pad = max(128, -(-num_refs // 128) * 128)
    block = classify_block_size(-(-(num_reads + 1) // dp))
    rows_local = pair_rows_local(num_reads, dp)
    acc_dtype = jnp.int32 if wide_sim else jnp.int8
    beta_f = jnp.float32(beta)
    drop = jnp.int32(rows_local * g_pad)  # out of range -> mode="drop"

    def shard_fn(rows_w, bits_b, gcol, cfile, cwin, crows, ccols, cvals,
                 corr_file, tax, rank_matrix, valid_t, error, norm):
        dp_i = lax.axis_index("dp")
        row_base = dp_i * rows_local

        def chunk_body(partial, inp):
            rw, bb, gc, fidx, win = inp
            bits = _unpack_bits5(bb)
            row = _unpack_rows(rw, row_bits).astype(jnp.int32)
            sym = (bits & 3).astype(jnp.int8)
            m = ((bits >> 2) & 1).astype(bool)
            dr = ((bits >> 3) & 1).astype(bool)
            gs = ((bits >> 4) & 1).astype(bool)
            hits = _hits_dispatch(bits, m, dr, gs, sym, win)
            copy_start = ((~m) & (~gs)).astype(jnp.int32)
            cidx = jnp.cumsum(copy_start) - 1
            gcol_v = gc[jnp.clip(cidx, 0, gc.shape[0] - 1)].astype(
                jnp.int32)
            local = row - row_base
            ok = (~gs) & (hits != 0) & (local >= 0) & (local < rows_local)
            flat = jnp.where(ok, local * g_pad + gcol_v, drop)
            f_safe = jnp.minimum(fidx, num_files)  # pad chunks -> drop
            partial = partial.reshape(num_files + 1, -1).at[
                jnp.full_like(flat, f_safe), flat].add(
                hits.astype(acc_dtype), mode="drop")
            return partial.reshape(num_files + 1, rows_local, g_pad), 0

        partial = jnp.zeros((num_files + 1, rows_local, g_pad),
                            acc_dtype)
        partial, _ = lax.scan(chunk_body, partial,
                              (rows_w, bits_b, gcol, cfile, cwin))
        partial = partial[:num_files]

        # The ONLY collective: merge sp chunk-shards of the local row
        # block.  int8 partial sums wrap mod 256 = the reference's
        # uchar SimArray.
        sims = lax.psum(partial, "sp")

        if max_corr:
            local_r = crows - dp_i * rows_local
            ok = (local_r >= 0) & (local_r < rows_local)
            sims = sims.at[
                jnp.where(ok, corr_file, num_files), local_r, ccols].add(
                cvals.astype(sims.dtype), mode="drop")

        return blockwise_cascade(sims, tax, rank_matrix, valid_t, error,
                                 norm, beta_f, num_files, tax_rank,
                                 assign_higher, not wide_sim, block)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(("sp", "dp")), P(("sp", "dp")), P(("sp", "dp")),
                  P(("sp", "dp")), P(("sp", "dp")),
                  P(), P(), P(), P(),
                  P(), P(), P(), P(), P()),
        out_specs=(P("dp"), P("dp"), P("dp")),
        check_vma=False,
    )
    jitted = jax.jit(mapped)
    norm = jnp.float32(np.uint32(read_len + 1 - alpha))

    def step(rows_w, bits_b, gcol, cfile, cwin, crows, ccols, cvals,
             corr_file, tax, rank_matrix, valid_t, error):
        return jitted(rows_w, bits_b, gcol, cfile, cwin, crows, ccols,
                      cvals, corr_file, tax, rank_matrix, valid_t,
                      error, norm)

    return step


# 5-byte group pattern of 8 packed pad rows (bits5 = 0x10: side=1, m=0 —
# inert: chains broken, scatter routed to the drop plane)
_PAD_GROUP_BITS = np.zeros(5, np.uint8)
for _j in range(8):
    _off = 5 * _j
    _PAD_GROUP_BITS[_off >> 3] |= (16 << (_off & 7)) & 0xFF
    if (_off & 7) + 5 > 8:
        _PAD_GROUP_BITS[(_off >> 3) + 1] |= 16 >> (8 - (_off & 7))


def run_sharded_pairs(collections, output_path: str, num_reads: int,
                      num_genomes: int, lineage_path: str, read_len: int,
                      config=None, mesh=None):
    """End-to-end SPMD run on the pair-stream engine (chunk-parallel).

    The packed planner's chunks are copy-aligned, so they round-robin
    over the mesh with no halo exchange; genome-dense and rescue
    clusters fold in as exact-host COO corrections (the dense share of
    positions is small — the dense matmul path stays a single-chip
    feature for now).  Outputs are bit-identical to the banded engine and
    the host pipeline.
    """
    from ..config import DEFAULT_CONFIG
    from ..constants import SYMBOL_RANK_LUT
    from ..formats.arrays import open_da, open_ebwt, open_lcp
    from ..formats.lineage import read_lineage
    from ..ops.classify_ops import ClassifyResult
    from ..ops.fused_pass import _DEGENERATE_BYTE
    from ..ops.fused_pipeline import _rescue_sparse
    from .. import native
    from .mesh import make_mesh

    config = config or DEFAULT_CONFIG
    if not native.available():
        raise RuntimeError("pair engine requires the native planner")
    if jax.process_count() > 1:
        return _run_sharded_pairs_multiprocess(
            collections, output_path, num_reads, num_genomes,
            lineage_path, read_len, config, mesh)
    if mesh is None:
        mesh = make_mesh(len(jax.devices()))
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("sharded run takes 2 or 4 collections")
    lineage = read_lineage(lineage_path)
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    n_shards = sp * dp
    g_pad = max(128, -(-num_genomes // 128) * 128)
    rows_local = pair_rows_local(num_reads, dp)
    if (rows_local + 1) * g_pad > 2**31 - 1:
        raise ValueError("rows_local * g_pad exceeds the int32 scatter "
                         "range; raise dp")
    W = native.row_bits_for(num_reads)
    dense_min = (16 if config.mxu_dense_min is None
                 else config.mxu_dense_min)

    # per-owner chunk lists: (file, window, rows_view, bits_view, gcol)
    own_chunks = [[] for _ in range(dp)]
    corr = []
    for fi, fasta in enumerate(collections):
        lcp = open_lcp(fasta, mmap=True)
        da = open_da(fasta, mmap=True)
        ebwt = open_ebwt(fasta, mmap=True) if config.use_ebwt else None
        (arrays, chunks, windows, w_f, den_s, den_l, bad_s,
         bad_l) = native.plan_pairs_packed(
            lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
            _DEGENERATE_BYTE.astype(np.uint8), dense_min=dense_min,
            num_refs=num_genomes, dp=dp, rows_local=rows_local)
        assert w_f == W
        if len(den_s):  # genome-dense clusters: exact host COO here
            bad_s = np.concatenate([bad_s, den_s])
            bad_l = np.concatenate([bad_l, den_l])
        rows_all, bits_all, gcol_all = arrays
        wpg = W // 4
        for b, owner, n_rows, wo, bo, go, gc in chunks:
            own_chunks[owner].append(
                (fi, windows[b],
                 rows_all[wo:wo + n_rows // 8 * wpg],
                 bits_all[bo:bo + n_rows // 8 * 5],
                 gcol_all[go:go + gc]))
        if len(bad_s):
            rows, cols, vals = _rescue_sparse(
                bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
            if len(rows):
                corr.append((fi, rows, cols, vals))

    # uniform chunk arrays; shard (sp_i, dp_j) gets cell b = sp_i*dp+dp_j
    # of the chunk axis, so owner-j chunks round-robin over the sp cells
    # of dp column j (padded to a common per-cell count)
    flat_iter = [c for oc in own_chunks for c in oc]
    cw = max((len(r) for _, _, r, _, _ in flat_iter), default=8)
    cb = cw // (W // 4) * 5
    gcap = 4096
    for _, _, _, _, g in flat_iter:
        while gcap < len(g):
            gcap <<= 1
    n_cell = max(1, max(-(-len(oc) // sp) for oc in own_chunks))
    n_ch = n_cell * n_shards
    rows_w = np.zeros((n_ch, cw), np.uint32)
    bits_b = np.tile(_PAD_GROUP_BITS, (n_ch, cb // 5))
    gcol = np.zeros((n_ch, gcap), np.uint16)
    cfile = np.full(n_ch, F, np.int32)
    cwin = np.ones(n_ch, np.int32)
    for owner, oc in enumerate(own_chunks):
        for k, (fi, win, r, b, g) in enumerate(oc):
            sp_i, slot = k % sp, k // sp
            i = (sp_i * dp + owner) * n_cell + slot
            rows_w[i, :len(r)] = r
            bits_b[i, :len(b)] = b
            gcol[i, :len(g)] = g
            cfile[i] = fi
            cwin[i] = win

    if corr:
        cfile_c = np.concatenate(
            [np.full(len(r), fi, np.int32) for fi, r, _, _ in corr])
        crows = np.concatenate([r for _, r, _, _ in corr]).astype(np.int32)
        ccols = np.concatenate([c for _, _, c, _ in corr]).astype(np.int32)
        cvals = np.concatenate([v for _, _, _, v in corr]).astype(np.int32)
        k = max(256, 1 << int(np.ceil(np.log2(len(cfile_c)))))
        pad = k - len(cfile_c)
        cfile_c = np.pad(cfile_c, (0, pad), constant_values=F)
        crows = np.pad(crows, (0, pad))
        ccols = np.pad(ccols, (0, pad))
        cvals = np.pad(cvals, (0, pad))
        max_corr = k
    else:
        cfile_c = crows = ccols = np.empty(0, np.int32)
        cvals = np.empty(0, np.int32)
        max_corr = 0

    tax = np.zeros(g_pad, np.uint32)
    tax[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_matrix = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
    rank_matrix[:, :num_genomes] = lineage.taxids
    valid_t = np.arange(g_pad) < num_genomes

    step = make_pair_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        row_bits=W, n_chunks=n_ch,
        wide_sim=config.wide_sim, max_corr=max_corr)
    types, taxid, sim = step(rows_w, bits_b, gcol, cfile, cwin,
                             crows, ccols, cvals, cfile_c, tax,
                             rank_matrix, valid_t,
                             jnp.float32(config.error_tolerance))
    res = ClassifyResult(np.asarray(types)[:num_reads],
                         np.asarray(taxid)[:num_reads],
                         np.asarray(sim)[:num_reads])
    if output_path:
        from ..pipeline import _write_csv_block

        with open(output_path, "w") as out:
            out.write("C/U/A/H,IdSeqRead,TaxID,maxSim\n")
            _write_csv_block(out, 0, res)
    return res


def _run_sharded_pairs_multiprocess(collections, output_path, num_reads,
                                    num_genomes, lineage_path, read_len,
                                    config=None, mesh=None):
    """Multi-process pair engine: per-host chunk contribution.

    Every process plans only its index range (plan_host_range_pairs);
    copy-aligned chunks union across hosts with no stitching, so the
    multi-process decomposition is "pad each host's chunk set to a
    common count and shard the global chunk axis".  COO corrections and
    the chunk-shape maxima allgather so replicated inputs agree.
    """
    from ..config import DEFAULT_CONFIG
    from ..formats.arrays import open_da, open_ebwt
    from ..formats.lineage import read_lineage
    from ..ops.classify_ops import ClassifyResult
    from ..ops.fused_pipeline import _rescue_sparse
    from .. import native
    from .mesh import make_mesh
    from .multihost import plan_host_range_pairs
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding

    config = config or DEFAULT_CONFIG
    pid, nproc = jax.process_index(), jax.process_count()
    if mesh is None:
        mesh = make_mesh(len(jax.devices()))
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("sharded run takes 2 or 4 collections")
    lineage = read_lineage(lineage_path)
    n_shards = mesh.shape["sp"] * mesh.shape["dp"]
    # any process/mesh combination works (the reference accepts any
    # thread count, src/ClusterLCP.cpp:139-141): when a process's cells
    # cover every dp owner its chunks stay process-local; otherwise the
    # (small) chunk buffers are exchanged so every process can fill its
    # cells of the global round-robin assignment.  Cells are addressed by
    # mesh flat position (NOT assumed process-contiguous — a mesh whose
    # process blocks are not contiguous subcubes is still usable because
    # the global arrays are assembled per device below).
    flat_devs = list(mesh.devices.flat)
    owned = [c for c, d in enumerate(flat_devs)
             if d.process_index == pid]
    local_shards = len(owned)
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    g_pad = max(128, -(-num_genomes // 128) * 128)
    rows_local = pair_rows_local(num_reads, dp)
    if (rows_local + 1) * g_pad > 2**31 - 1:
        raise ValueError("rows_local * g_pad exceeds the int32 scatter "
                         "range; raise dp")
    W = native.row_bits_for(num_reads)
    dense_min = (16 if config.mxu_dense_min is None
                 else config.mxu_dense_min)

    own_chunks = [[] for _ in range(dp)]  # (fi, win, rows, bits, gcol)
    corr_local = []
    for fi, fasta in enumerate(collections):
        (arrays, chunks, windows, w_f, den_s, den_l, bad_s,
         bad_l) = plan_host_range_pairs(
            fasta, num_reads, num_genomes, config.alpha, nproc, pid,
            use_ebwt=config.use_ebwt, dense_min=dense_min,
            dp=dp, rows_local=rows_local)
        assert w_f == W
        rows_all, bits_all, gcol_all = arrays
        wpg = W // 4
        for b, owner, n_rows, wo, bo, go, gc in chunks:
            own_chunks[owner].append(
                (fi, windows[b],
                 rows_all[wo:wo + n_rows // 8 * wpg],
                 bits_all[bo:bo + n_rows // 8 * 5],
                 gcol_all[go:go + gc]))
        if len(den_s):  # dense clusters: exact host COO in this engine
            bad_s = np.concatenate([bad_s, den_s])
            bad_l = np.concatenate([bad_l, den_l])
        if len(bad_s):
            da = open_da(fasta, mmap=True)
            ebwt = (open_ebwt(fasta, mmap=True) if config.use_ebwt
                    else None)
            rows, cols, vals = _rescue_sparse(
                bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
            if len(rows):
                corr_local.append((np.full(len(rows), fi, np.int32),
                                   rows, cols, vals))

    # agree on uniform chunk shapes + the per-cell chunk count; each
    # process's global cell offset comes from the allgathered local
    # shard counts (uneven processes are allowed)
    flat_iter = [c for oc in own_chunks for c in oc]
    cw_loc = max((len(r) for _, _, r, _, _ in flat_iter), default=8)
    gcap_loc = 4096
    for _, _, _, _, g in flat_iter:
        while gcap_loc < len(g):
            gcap_loc <<= 1
    cell_slot = {c: b for b, c in enumerate(owned)}
    owned_by_owner = {j: [c for c in owned if c % dp == j]
                      for j in range(dp)}
    import os as _os

    need_exchange = (any(not v for v in owned_by_owner.values())
                     or _os.environ.get("LIME_FORCE_EXCHANGE") == "1")
    # the exchange decision must be GLOBAL: processes with uneven device
    # counts can disagree locally, and divergent branches would issue
    # mismatched collective sequences (a deadlock) — gather both the
    # shard counts and the exchange flags in one allgather
    ls_flags = np.asarray(multihost_utils.process_allgather(np.array(
        [local_shards, int(need_exchange)], np.int64)))
    ls_all = ls_flags[:, 0].reshape(-1)
    assert int(ls_all.sum()) == n_shards
    use_exchange = bool(ls_flags[:, 1].any())
    if use_exchange:
        cell_loc = 0  # the exchange path agrees on n_cell globally below
    else:
        cell_loc = max(-(-len(own_chunks[j]) // len(owned_by_owner[j]))
                       for j in range(dp))
    dims = np.asarray(multihost_utils.process_allgather(np.array(
        [cw_loc, gcap_loc, cell_loc], np.int64)))
    cw = int(dims[:, 0].max())
    gcap = int(dims[:, 1].max())
    cb = cw // (W // 4) * 5

    if use_exchange:
        # Some dp owner has no cell on this process (local_shards % dp
        # != 0): allgather every process's chunk buffers and rebuild the
        # global per-owner lists in (process, emission) order, so every
        # process can fill its own slice of the deterministic global
        # round-robin assignment.  Memory: the whole stream on every
        # host — the aligned configuration keeps chunks process-local.
        wpg = W // 4
        metas, rp, bp, gp = [], [], [], []
        for owner, oc in enumerate(own_chunks):
            for fi, win, r, b, g in oc:
                metas.append((owner, fi, win, len(r) // wpg * 8, len(g)))
                rp.append(r)
                bp.append(b)
                gp.append(g)
        meta_l = np.asarray(metas, np.int64).reshape(-1)
        r_l = (np.concatenate(rp) if rp else np.empty(0, np.uint32))
        b_l = (np.concatenate(bp) if bp else np.empty(0, np.uint8))
        g_l = (np.concatenate(gp) if gp else np.empty(0, np.uint16))
        caps = np.asarray(multihost_utils.process_allgather(np.array(
            [len(meta_l), len(r_l), len(b_l), len(g_l)], np.int64)))
        meta_g = _allgather_np(meta_l, int(caps[:, 0].max()) + 1, -1)
        r_g = _allgather_np(r_l, int(caps[:, 1].max()) + 1, 0)
        b_g = _allgather_np(b_l, int(caps[:, 2].max()) + 1, 0)
        g_g = _allgather_np(g_l, int(caps[:, 3].max()) + 1, 0)
        glob_chunks = [[] for _ in range(dp)]
        for p in range(nproc):
            ro = bo = go = 0
            pm = meta_g[p]
            for x in range(0, len(pm), 5):
                if pm[x] < 0:
                    break
                owner, fi, win, n_rows, lg = (int(v)
                                              for v in pm[x:x + 5])
                lr, lb = n_rows // 8 * wpg, n_rows // 8 * 5
                glob_chunks[owner].append(
                    (fi, win, r_g[p][ro:ro + lr], b_g[p][bo:bo + lb],
                     g_g[p][go:go + lg]))
                ro += lr
                bo += lb
                go += lg
        n_cell = max(1, max(-(-len(oc) // sp) for oc in glob_chunks))
        n_loc = n_cell * local_shards
        rows_w = np.zeros((n_loc, cw), np.uint32)
        bits_b = np.tile(_PAD_GROUP_BITS, (n_loc, cb // 5))
        gcol = np.zeros((n_loc, gcap), np.uint16)
        cfile = np.full(n_loc, F, np.int32)
        cwin = np.ones(n_loc, np.int32)
        for owner, oc in enumerate(glob_chunks):
            cells = [c for c in range(n_shards) if c % dp == owner]
            for k, (fi, win, r, b, g) in enumerate(oc):
                c = cells[k % len(cells)]
                if c not in cell_slot:
                    continue
                i = cell_slot[c] * n_cell + k // len(cells)
                rows_w[i, :len(r)] = r
                bits_b[i, :len(b)] = b
                gcol[i, :len(g)] = g
                cfile[i] = fi
                cwin[i] = win
    else:
        n_cell = max(1, int(dims[:, 2].max()))
        n_loc = n_cell * local_shards
        # cell c has dp coordinate c % dp, so owner-j chunks go to this
        # process's cells with dp coordinate j (round-robin); local row
        # block b of the per-device assembly below is owned[b]'s shard
        rows_w = np.zeros((n_loc, cw), np.uint32)
        bits_b = np.tile(_PAD_GROUP_BITS, (n_loc, cb // 5))
        gcol = np.zeros((n_loc, gcap), np.uint16)
        cfile = np.full(n_loc, F, np.int32)
        cwin = np.ones(n_loc, np.int32)
        for owner, oc in enumerate(own_chunks):
            cells = owned_by_owner[owner]
            for k, (fi, win, r, b, g) in enumerate(oc):
                i = (cell_slot[cells[k % len(cells)]] * n_cell
                     + k // len(cells))
                rows_w[i, :len(r)] = r
                bits_b[i, :len(b)] = b
                gcol[i, :len(g)] = g
                cfile[i] = fi
                cwin[i] = win

    if corr_local:
        lf = np.concatenate([c[0] for c in corr_local])
        lr = np.concatenate([c[1] for c in corr_local]).astype(np.int32)
        lc = np.concatenate([c[2] for c in corr_local]).astype(np.int32)
        lv = np.concatenate([c[3] for c in corr_local]).astype(np.int32)
    else:
        lf = lr = lc = lv = np.empty(0, np.int32)
    n_corr = int(np.asarray(multihost_utils.process_allgather(
        np.array([len(lf)], np.int64))).max())
    if n_corr:
        k = max(256, 1 << int(np.ceil(np.log2(max(n_corr, 2)))))
        cfile_c = _allgather_np(lf, k, F).reshape(-1)
        crows = _allgather_np(lr, k, 0).reshape(-1)
        ccols = _allgather_np(lc, k, 0).reshape(-1)
        cvals = _allgather_np(lv, k, 0).reshape(-1)
        max_corr = len(cfile_c)
    else:
        cfile_c = crows = ccols = np.empty(0, np.int32)
        cvals = np.empty(0, np.int32)
        max_corr = 0

    tax = np.zeros(g_pad, np.uint32)
    tax[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_matrix = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
    rank_matrix[:, :num_genomes] = lineage.taxids
    valid_t = np.arange(g_pad) < num_genomes

    chunk_sharding = NamedSharding(mesh, P(("sp", "dp")))
    n_ch = n_cell * n_shards

    def glob(x):
        # per-device shard assembly: no contiguous-subcube requirement
        # on the process->mesh placement (make_array_from_process_local
        # _data and mesh.local_mesh both impose one)
        shards = [jax.device_put(x[b * n_cell:(b + 1) * n_cell],
                                 flat_devs[c])
                  for b, c in enumerate(owned)]
        return jax.make_array_from_single_device_arrays(
            (n_ch,) + x.shape[1:], chunk_sharding, shards)

    step = make_pair_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        row_bits=W, n_chunks=n_ch, wide_sim=config.wide_sim,
        max_corr=max_corr)
    types, taxid, sim = step(glob(rows_w), glob(bits_b), glob(gcol),
                             glob(cfile), glob(cwin), crows, ccols,
                             cvals, cfile_c, tax, rank_matrix, valid_t,
                             jnp.float32(config.error_tolerance))
    types = np.asarray(multihost_utils.process_allgather(types,
                                                         tiled=True))
    taxid = np.asarray(multihost_utils.process_allgather(taxid,
                                                         tiled=True))
    sim = np.asarray(multihost_utils.process_allgather(sim, tiled=True))
    res = ClassifyResult(types[:num_reads], taxid[:num_reads],
                         sim[:num_reads])
    if output_path and pid == 0:
        from ..pipeline import _write_csv_block

        with open(output_path, "w") as out:
            out.write("C/U/A/H,IdSeqRead,TaxID,maxSim\n")
            _write_csv_block(out, 0, res)
    return res
