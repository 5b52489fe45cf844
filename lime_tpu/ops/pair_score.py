"""G-independent device scoring over planner-emitted pair streams.

The banded one-hot kernel (parallel/sharded.banded_partial_sim) pays
``window * G_pad`` vector lanes per position — the right trade only when
many genome lanes hit per position.  Measured cluster statistics say the
opposite is typical: at the reference's flagship scale (930 genomes) the
p99 cluster holds ONE genome document, so the one-hot idles >99% of its
lanes.  This path removes the genome axis from the hot loop entirely.

The native planner (lime_plan_pairs) re-emits each sparse cluster once per
distinct genome document it contains — all read rows plus that genome's
rows, grouped by document — with a packed byte per row:

  bit6  m       in-run chain bit (0 on a copy's first row)
  bit5  docrun  0 on the first row of each document group
  bit4  side    1 = genome-side row
  0..3          symbol rank

plus a precomputed int32 scatter index ``row * g_pad + gcol``.  On device:

1. occurrence pass — ``occ[i]`` = this row's occurrence index within its
   (cluster, document, symbol), via the docrun AND-chain across band
   offsets (all elementwise);
2. match pass — ``hits[i]`` = number of genome-side rows in the same copy
   with equal (symbol, occ), via the m AND-chain in both band directions
   (the occurrence-matching identity: summed per (read, genome) pair this
   is exactly t = sum_s min(cnt_r(s), cnt_g(s)), reference
   src/ClusterBWT_DA.cpp:107-190);
3. one scalar scatter-add of ``hits`` at ``flatidx`` into the similarity
   matrix.  int8 accumulation wraps mod 256 = the reference's unsaturated
   uchar SimArray (src/ClusterBWT_DA.cpp:183).

Per-position cost: ~a dozen vector ops per band offset and 5 bytes of
upload — independent of the genome count.  Genome-dense clusters (which
do amortize wide lanes) route to the tensor-core histogram-matmul path
(ops/dense_score.py) instead; IUPAC-degenerate and >255-row clusters to
the exact host scorer (the reference's u8 wrap/saturation quirks,
src/ClusterBWT_DA.cpp:96,123).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import SCATTER_DROP

# Upload chunk sizes (positions).  Streams ship to the device in fixed-size
# chunks cut at copy boundaries: one compiled program per chunk class (no
# per-length recompiles), uploads pipeline with device compute, and no
# single transfer monopolizes the host<->device link.
PAIR_CHUNK = 8 << 20
PAIR_CHUNK_SMALL = 256 << 10

_PAD_W = 256  # static halo; window is traced <= 255


def _pad2(x, fill=0):
    return jnp.pad(x, (_PAD_W, _PAD_W), constant_values=fill)


def _bwd(padded, o):
    length = padded.shape[-1] - 2 * _PAD_W
    return lax.dynamic_slice_in_dim(padded, _PAD_W - o, length, axis=-1)


def _fwd(padded, o):
    length = padded.shape[-1] - 2 * _PAD_W
    return lax.dynamic_slice_in_dim(padded, _PAD_W + o, length, axis=-1)


def pair_hits(packed: jnp.ndarray, window) -> jnp.ndarray:
    """Per-row genome-match counts for one pair stream (the scoring math).

    ``packed`` is the planner's byte stream; ``window`` a traced int32
    <= 255 (one compiled program serves every window).  Returns int32
    ``hits`` with zeros on genome-side and pad rows' matches routed by the
    caller's scatter indices.
    """
    m = ((packed >> 6) & 1).astype(bool)
    dr = ((packed >> 5) & 1).astype(bool)
    gs = ((packed >> 4) & 1).astype(bool)
    sym = (packed & 15).astype(jnp.int8)
    return _pair_hits_core(m, dr, gs, sym, window)


def _pair_hits_core(m, dr, gs, sym, window) -> jnp.ndarray:
    """Occurrence pass + match pass over decoded chain/side/symbol rows."""
    L = m.shape[-1]

    pad_sym = _pad2(sym, -1)  # pads never match a real symbol
    pad_dr = _pad2(dr)
    pad_m = _pad2(m)
    pad_gs = _pad2(gs)

    def occ_step(o, carry):
        chain, occ = carry
        same = chain & (sym == _bwd(pad_sym, o))
        occ = occ + same.astype(jnp.int32)
        chain = chain & _bwd(pad_dr, o)
        return chain, occ

    _, occ = lax.fori_loop(1, window + 1, occ_step,
                           (dr, jnp.zeros(L, jnp.int32)))
    pad_occ = _pad2(occ, -1)

    def hit_step(o, carry):
        chain, hits = carry
        hit_b = (chain & _bwd(pad_gs, o) & (sym == _bwd(pad_sym, o))
                 & (occ == _bwd(pad_occ, o)))
        # same-cluster over (i, i+o] = the backward chain evaluated at i+o
        chain_f = _fwd(_pad2(chain), o)
        hit_f = (chain_f & _fwd(pad_gs, o) & (sym == _fwd(pad_sym, o))
                 & (occ == _fwd(pad_occ, o)))
        hits = hits + hit_b.astype(jnp.int32) + hit_f.astype(jnp.int32)
        chain = chain & _bwd(pad_m, o)
        return chain, hits

    _, hits = lax.fori_loop(1, window + 1, hit_step,
                            (m, jnp.zeros(L, jnp.int32)))
    return hits


def _shift_bwd(x, d: int):
    """Element i-d (0 before the stream start); ``d`` is static."""
    return jnp.concatenate([jnp.zeros(d, x.dtype), x[:-d]])


def _shift_fwd(x, d: int):
    """Element i+d (0 past the stream end); ``d`` is static."""
    return jnp.concatenate([x[d:], jnp.zeros(d, x.dtype)])


def _pair_hits_scan(bits, cap: int):
    """Log-step form of :func:`_pair_hits_core` for buckets with cap <= 64.

    ``bits`` holds the unpacked 5-bit row codes (bits 0-1 sym, 2 m,
    3 docrun, 4 side).  Two structural facts of planner streams replace
    the ``window`` band passes with ceil(log2 cap) segmented scans:

    1. a docrun never exceeds the bucket cap, so the occurrence index is
       a segmented prefix count (Hillis-Steele, 4 symbols x 8-bit
       counters in one u32; docruns <= 64 never carry across bytes);
    2. genome rows sit at the tail of each copy with (sym, occ) unique
       in their one docrun, so a read row matches AT MOST one genome row:
       a backward segmented OR-scan of per-(sym, occ) bitmasks over the
       copy answers it.

    Read-side rows equal :func:`_pair_hits_core`; genome-side rows carry
    garbage that every caller's scatter drops.
    """
    log = max(1, (cap - 1).bit_length())
    u = jnp.uint32
    sym = (bits & 3).astype(u)
    m = ((bits >> 2) & 1).astype(bool)
    dr = ((bits >> 3) & 1).astype(bool)
    gs = ((bits >> 4) & 1).astype(bool)

    # occurrence index: segmented inclusive prefix count of own symbol
    x = jnp.left_shift(u(1), sym * 8)
    f = dr
    for k in range(log):
        d = 1 << k
        x = x + jnp.where(f, _shift_bwd(x, d), u(0))
        f = f & _shift_bwd(f, d)
    occ = ((x >> (sym * 8)) & 255) - 1

    # genome-key bitmasks: bit (sym, occ) set on genome rows; cap 16 packs
    # two symbols x 16 occurrences per u32, cap 64 one symbol x 32
    if log <= 4:
        n_regs = 2
        base = jnp.left_shift(u(1), occ + ((sym & 1) << 4))
        reg_of = sym >> 1
    else:
        n_regs = 8
        base = jnp.left_shift(u(1), occ & 31)
        reg_of = (sym << 1) | (occ >> 5)
    gm = [jnp.where(gs & (reg_of == r), base, u(0)) for r in range(n_regs)]

    # backward segmented OR-scan over the copy: row i+1 continues the
    # copy iff its m bit is set
    cont = _shift_fwd(m, 1)
    for k in range(log):
        d = 1 << k
        gm = [a | jnp.where(cont, _shift_fwd(a, d), u(0)) for a in gm]
        cont = cont & _shift_fwd(cont, d)

    sel = gm[0]
    for r in range(1, n_regs):
        sel = jnp.where(reg_of == r, gm[r], sel)
    return ((sel & base) != 0).astype(jnp.int32)


#: Copy-length caps per planner bucket (BUCKET_CAP in csrc) — the static
#: bound that picks the pair-hits form (log-step scan vs band passes).
BUCKET_CAPS = (16, 64, 255)

#: Largest bucket cap served by :func:`_pair_hits_scan`.
SCAN_MAX_CAP = 64


def _hits_dispatch(bits, m, dr, gs, sym, window, cap: int = 255):
    """Pick the pair-hits form for one decoded chunk.

    ``cap`` (the chunk bucket's static copy-length bound) selects the
    log-step scan (cap <= SCAN_MAX_CAP) or the band-pass core.
    Genome-side rows may carry garbage counts; every caller drops them at
    scatter time.
    """
    with jax.named_scope("pair_hits"):
        if cap <= SCAN_MAX_CAP:
            return _pair_hits_scan(bits, cap)
        return _pair_hits_core(m, dr, gs, sym, window)


def planner_shaped_stream(rng, n, cap):
    """Synthesize 5-bit row codes with the packed planner's invariants:
    each copy = read rows (1+ docruns) then ONE genome docrun (side=1);
    copy length <= cap; a copy's first row is read-side with m=0.

    The scan form's contract is exactly this shape; tests and the chip
    smoke run use it to cross-check and time the pair-hits forms.
    """
    codes = np.zeros(n, np.uint8)
    i = 0
    while i < n:
        n_read = int(rng.integers(1, max(2, cap // 2)))
        n_gen = int(rng.integers(1, cap - n_read + 1)) if cap > n_read \
            else 1
        sym = rng.integers(0, 4, n_read + n_gen).astype(np.uint8)
        dr = np.ones(n_read + n_gen, np.uint8)
        dr[:n_read] = rng.random(n_read) >= 0.3
        dr[0] = 0
        dr[n_read] = 0
        side = np.zeros(n_read + n_gen, np.uint8)
        side[n_read:] = 1
        mbit = np.ones(n_read + n_gen, np.uint8)
        mbit[0] = 0
        copy = sym | (mbit << 2) | (dr << 3) | (side << 4)
        take = min(len(copy), n - i)
        codes[i:i + take] = copy[:take]
        i += take
    return codes


def codes_to_packed(codes: np.ndarray) -> np.ndarray:
    """5-bit row codes -> the one-byte layout of :func:`pair_hits_host`."""
    return ((codes & 3) | (((codes >> 3) & 1) << 5)
            | (((codes >> 4) & 1) << 4)
            | (((codes >> 2) & 1) << 6)).astype(np.uint8)


@functools.partial(jax.jit, donate_argnums=(0,))
def _pair_score_block(sim, packed, flat, window):
    """One stream bucket: hits + one scalar scatter into the flat matrix.

    ``sim`` is donated and accumulated in place; int8 adds wrap mod 256
    (the reference's uchar counters).  ``flat`` indices are in
    [0, rows*g_pad) by planner construction (drop row = num_reads).
    """
    hits = pair_hits(packed, window)
    shape = sim.shape
    flat = jnp.where(hits != 0, flat, SCATTER_DROP)
    flat_sim = sim.reshape(-1).at[flat].add(hits.astype(sim.dtype),
                                            mode="drop")
    return flat_sim.reshape(shape)


def _unpack_bits5(bits_b: jnp.ndarray) -> jnp.ndarray:
    """(N/8*5,) u8 groups -> (N,) u32 of 5-bit lane values."""
    g = bits_b.reshape(-1, 5).astype(jnp.uint32)
    lanes = []
    for j in range(8):
        off = 5 * j
        a, sh = off >> 3, off & 7
        v = g[:, a] >> sh
        if sh + 5 > 8:
            v = v | (g[:, a + 1] << (8 - sh))
        lanes.append(v & 31)
    return jnp.stack(lanes, axis=1).reshape(-1)


def _unpack_rows(rows_w: jnp.ndarray, row_bits: int) -> jnp.ndarray:
    """(N/8*W/4,) u32 groups -> (N,) u32 of W-bit lane values."""
    nw = row_bits // 4
    g = rows_w.reshape(-1, nw)
    mask = (1 << row_bits) - 1
    lanes = []
    for j in range(8):
        off = row_bits * j
        a, sh = off >> 5, off & 31
        v = g[:, a] >> sh
        if sh + row_bits > 32:
            v = v | (g[:, a + 1] << (32 - sh))
        lanes.append(v & mask)
    return jnp.stack(lanes, axis=1).reshape(-1)


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("row_bits", "cap"))
def _pair_packed_block(sim, rows_w, bits_b, gcol, window,
                       row_bits: int, cap: int = 255):
    """One packed chunk: unpack (pure vector shifts), score, one scatter.

    The genome column is constant per copy, so it ships once per copy and
    broadcasts to rows via a cumsum of copy-start bits + one gather (a
    copy's first row is always read-side by construction, so pads — which
    carry side=1 and m=0 — never increment the cumsum).
    """
    bits = _unpack_bits5(bits_b)
    row = _unpack_rows(rows_w, row_bits).astype(jnp.int32)
    sym = (bits & 3).astype(jnp.int8)
    m = ((bits >> 2) & 1).astype(bool)
    dr = ((bits >> 3) & 1).astype(bool)
    gs = ((bits >> 4) & 1).astype(bool)
    hits = _hits_dispatch(bits, m, dr, gs, sym, window, cap=cap)
    copy_start = ((~m) & (~gs)).astype(jnp.int32)
    cidx = jnp.cumsum(copy_start) - 1
    gc = gcol[cidx].astype(jnp.int32)
    g_pad = sim.shape[1]
    flat = jnp.where(gs | (hits == 0), SCATTER_DROP, row * g_pad + gc)
    shape = sim.shape
    out = sim.reshape(-1).at[flat].add(hits.astype(sim.dtype), mode="drop")
    return out.reshape(shape)


def _gcol_padded(gcol_all: np.ndarray, chunks) -> np.ndarray:
    """Pad the gcol buffer so every chunk's pow2-rounded device slice
    stays in bounds (entries past a chunk's own copies are never
    gathered — the copy-start cumsum cannot reach them)."""
    need = len(gcol_all)
    for _, _, _, _, _, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        need = max(need, go + gcap)
    if need > len(gcol_all):
        gcol_all = np.pad(gcol_all, (0, need - len(gcol_all)))
    return gcol_all


def pair_upload(arrays, chunks):
    """Ship one collection's three planner buffers to the device.

    Three transfers, not one blob: a device-side slice+bitcast of a
    concatenated u8 buffer saves two transfers, but a ``(n, 4)`` u8
    reshape can be laid out padded to a wide minor dimension — a large
    device-memory inflation at setB2 scale.
    """
    rows_all, bits_all, gcol_all = arrays
    return (jax.device_put(rows_all), jax.device_put(bits_all),
            jax.device_put(_gcol_padded(gcol_all, chunks)))


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("row_bits", "fidx", "cap"))
def _pair_packed_block_offset_stack(stack, rows_w, bits_b, gcol, window,
                                    row_base, fidx: int, row_bits: int,
                                    cap: int = 255):
    """Row-blocked scatter straight into the (F, B, g_pad) stack.

    Avoids per-file block buffers + a jnp.stack copy (which doubles the
    stack's HBM transiently — an OOM at setB2 scale).  The flat index
    stays within one file's B * g_pad range (int32-safe); the file
    coordinate is a static scatter dimension.
    """
    bits = _unpack_bits5(bits_b)
    row = _unpack_rows(rows_w, row_bits).astype(jnp.int32)
    sym = (bits & 3).astype(jnp.int8)
    m = ((bits >> 2) & 1).astype(bool)
    dr = ((bits >> 3) & 1).astype(bool)
    gs = ((bits >> 4) & 1).astype(bool)
    hits = _hits_dispatch(bits, m, dr, gs, sym, window, cap=cap)
    copy_start = ((~m) & (~gs)).astype(jnp.int32)
    cidx = jnp.cumsum(copy_start) - 1
    gc = gcol[cidx].astype(jnp.int32)
    F, B, g_pad = stack.shape
    local = row - row_base
    ok = (~gs) & (hits != 0) & (local >= 0) & (local < B)
    flat = jnp.where(ok, local * g_pad + gc, SCATTER_DROP)
    # static fidx: 1-D scatter on the plane, then a static write-back
    plane = stack[fidx].reshape(-1).at[flat].add(
        hits.astype(stack.dtype), mode="drop")
    return stack.at[fidx].set(plane.reshape(B, g_pad))


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("row_bits", "fidx", "n_rows", "gcap",
                                    "cap"))
def _pair_packed_scan_class(stack, d_rows, d_bits, d_gcol, wos, bos, gos,
                            wins, row_base, fidx: int, row_bits: int,
                            n_rows: int, gcap: int, cap: int = 255):
    """Replay every same-shape chunk of one (file, row block) in ONE
    dispatch: a lax.scan whose body slices the device-resident stream at
    traced offsets, so multi-block runs pay one launch per class instead
    of one per chunk."""
    wpg = row_bits // 4

    def body(st, inp):
        wo, bo, go, win = inp
        rows_w = lax.dynamic_slice_in_dim(d_rows, wo, n_rows // 8 * wpg)
        bits_b = lax.dynamic_slice_in_dim(d_bits, bo, n_rows // 8 * 5)
        gcol = lax.dynamic_slice_in_dim(d_gcol, go, gcap)
        bits = _unpack_bits5(bits_b)
        row = _unpack_rows(rows_w, row_bits).astype(jnp.int32)
        sym = (bits & 3).astype(jnp.int8)
        m = ((bits >> 2) & 1).astype(bool)
        dr = ((bits >> 3) & 1).astype(bool)
        gs = ((bits >> 4) & 1).astype(bool)
        hits = _hits_dispatch(bits, m, dr, gs, sym, win, cap=cap)
        copy_start = ((~m) & (~gs)).astype(jnp.int32)
        cidx = jnp.cumsum(copy_start) - 1
        gc = gcol[cidx].astype(jnp.int32)
        F, B, g_pad = st.shape
        local = row - row_base
        ok = (~gs) & (hits != 0) & (local >= 0) & (local < B)
        flat = jnp.where(ok, local * g_pad + gc, SCATTER_DROP)
        # fidx is static: scatter the extracted plane with a 1-D index
        # and write it back
        plane = st[fidx].reshape(-1).at[flat].add(
            hits.astype(st.dtype), mode="drop")
        return st.at[fidx].set(plane.reshape(B, g_pad)), 0

    stack, _ = lax.scan(body, stack, (wos, bos, gos, wins))
    return stack


def pair_score_packed_from_device(stack: jax.Array, dev_arrays, chunks,
                                  windows, row_bits: int, row_base: int,
                                  fidx: int) -> jax.Array:
    """Accumulate one (file, row block) from a device-resident stream.

    Chunks group into shape classes (n_rows, gcap); each class replays as
    one scanned dispatch.
    """
    d_rows, d_bits, d_gcol = dev_arrays
    classes = {}
    for bucket, _, n_rows, wo, bo, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        classes.setdefault((n_rows, gcap, BUCKET_CAPS[bucket]), []).append(
            (wo, bo, go, windows[bucket]))
    for (n_rows, gcap, cap), items in classes.items():
        wos = np.array([i[0] for i in items], np.int32)
        bos = np.array([i[1] for i in items], np.int32)
        gos = np.array([i[2] for i in items], np.int32)
        wins = np.array([i[3] for i in items], np.int32)
        stack = _pair_packed_scan_class(
            stack, d_rows, d_bits, d_gcol, jnp.asarray(wos),
            jnp.asarray(bos), jnp.asarray(gos), jnp.asarray(wins),
            jnp.int32(row_base), fidx, row_bits, n_rows, gcap, cap)
    return stack


def pair_score_packed_into(sim: jax.Array, arrays, chunks, windows,
                           row_bits: int, num_reads: int,
                           g_pad: int) -> jax.Array:
    """Accumulate all packed pair chunks into the device matrix ``sim``.

    ``arrays``/``chunks``/``windows``/``row_bits`` are the output of
    native.plan_pairs_packed.  The three planner buffers upload as THREE
    contiguous transfers per collection (each transfer has a fixed cost
    on a slow host link, so per-chunk uploads would multiply it) and
    every chunk's statically-shaped slices are taken on device.
    Dispatches are asynchronous; the returned array is a device future.
    """
    d_rows, d_bits, d_gcol = pair_upload(arrays, chunks)
    wpg = row_bits // 4  # words per 8-row group
    for bucket, _, n_rows, wo, bo, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        sim = _pair_packed_block(
            sim, lax.dynamic_slice_in_dim(d_rows, wo, n_rows // 8 * wpg),
            lax.dynamic_slice_in_dim(d_bits, bo, n_rows // 8 * 5),
            lax.dynamic_slice_in_dim(d_gcol, go, gcap),
            jnp.int32(windows[bucket]), row_bits, BUCKET_CAPS[bucket])
    return sim


@functools.partial(jax.jit, donate_argnums=(0,))
def _coo_scatter_block(sim, drow, col, val, base_row):
    """Fold one delta-COO chain into the similarity plane.

    The hybrid engine's uplink for host-scored clusters
    (native.coo_compact): rows are a cumsum of u8 deltas from
    ``base_row``, values are pre-wrapped u8 (bitcast to int8 so the adds
    wrap mod 256 — the reference's uchar counters,
    src/ClusterBWT_DA.cpp:183) or u32 in wide mode.  Bridge/pad entries
    carry val=0 and scatter as no-ops.  One 1-D scatter.
    """
    rows = base_row + jnp.cumsum(drow.astype(jnp.int32))
    g_pad = sim.shape[1]
    v = lax.bitcast_convert_type(
        val, jnp.int8 if sim.dtype == jnp.int8 else jnp.int32)
    flat = jnp.where(v != 0, rows * g_pad + col.astype(jnp.int32),
                     SCATTER_DROP)
    shape = sim.shape
    out = sim.reshape(-1).at[flat].add(v, mode="drop")
    return out.reshape(shape)


def merge_coo_segments(segs, max_drow: int = 255):
    """Concatenate native.coo_compact's per-thread segments into ONE
    delta chain (single upload per collection — a slow host link
    charges a fixed cost per transfer).  Cross-segment gaps splice in bridge
    entries (row deltas capped at ``max_drow``, matching the compactor);
    returns ``(base_row, drow, col, val)`` or None if empty.
    """
    if not segs:
        return None
    parts_d, parts_c, parts_v = [], [], []
    base0 = segs[0][0]
    last = base0
    for base, drow, col, val in segs:
        seg_last = base + int(np.sum(drow.astype(np.int64)))
        first_abs = base + int(drow[0])
        gap = first_abs - last
        assert gap >= 0, "segments out of row order"
        n_bridge = 0
        while gap > max_drow:
            n_bridge += 1
            gap -= max_drow
        if n_bridge:
            parts_d.append(np.full(n_bridge, max_drow, np.uint8))
            parts_c.append(np.zeros(n_bridge, col.dtype))
            parts_v.append(np.zeros(n_bridge, val.dtype))
        drow = drow.copy()
        drow[0] = gap
        parts_d.append(drow)
        parts_c.append(col)
        parts_v.append(val)
        last = seg_last
    return (base0, np.concatenate(parts_d), np.concatenate(parts_c),
            np.concatenate(parts_v))


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("n",))
def _coo_scatter_block24(sim, buf, base_row, n: int):
    """Packed coo24 chain: one u8 buffer of three n-length planes
    ``[drow4|colhi4][col_lo][val]`` (3 B/entry, one transfer; genome
    columns up to 4095, row deltas up to 15 with bridge entries).
    Decode is slices + shifts on 1-D u8 — no small-minor-dim reshapes
    (XLA tiles those to 128 lanes)."""
    d = lax.dynamic_slice_in_dim(buf, 0, n)
    col = ((d & 15).astype(jnp.int32) << 8) | \
        lax.dynamic_slice_in_dim(buf, n, n).astype(jnp.int32)
    val = lax.bitcast_convert_type(
        lax.dynamic_slice_in_dim(buf, 2 * n, n), jnp.int8)
    rows = base_row + jnp.cumsum((d >> 4).astype(jnp.int32))
    g_pad = sim.shape[1]
    flat = jnp.where(val != 0, rows * g_pad + col, SCATTER_DROP)
    shape = sim.shape
    out = sim.reshape(-1).at[flat].add(val, mode="drop")
    return out.reshape(shape)


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("n", "fidx"))
def _coo_scatter_block24_stack(stack, buf, base_row, fidx: int, n: int):
    """coo24 chain into plane ``fidx`` of the (F, B, g_pad) stack
    (row-blocked mode).  Static file plane: 1-D scatter on the
    extracted plane + write-back (a 1-D scatter instead of a
    2-coordinate one)."""
    d = lax.dynamic_slice_in_dim(buf, 0, n)
    col = ((d & 15).astype(jnp.int32) << 8) | \
        lax.dynamic_slice_in_dim(buf, n, n).astype(jnp.int32)
    val = lax.bitcast_convert_type(
        lax.dynamic_slice_in_dim(buf, 2 * n, n), jnp.int8)
    rows = base_row + jnp.cumsum((d >> 4).astype(jnp.int32))
    F, B, g_pad = stack.shape
    flat = jnp.where(val != 0, rows * g_pad + col, SCATTER_DROP)
    plane = stack[fidx].reshape(-1).at[flat].add(val, mode="drop")
    return stack.at[fidx].set(plane.reshape(B, g_pad))


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("fidx",))
def _coo_scatter_block_stack(stack, drow, col, val, base_row, fidx: int):
    """Legacy 3-array chain into plane ``fidx`` (wide counters)."""
    rows = base_row + jnp.cumsum(drow.astype(jnp.int32))
    F, B, g_pad = stack.shape
    v = lax.bitcast_convert_type(
        val, jnp.int8 if stack.dtype == jnp.int8 else jnp.int32)
    flat = jnp.where(v != 0, rows * g_pad + col.astype(jnp.int32),
                     SCATTER_DROP)
    plane = stack[fidx].reshape(-1).at[flat].add(v, mode="drop")
    return stack.at[fidx].set(plane.reshape(B, g_pad))


def _pack24(chain):
    """coo24 packing: one u8 buffer of three pow2-padded planes
    [drow4|colhi4][col_lo][val]; returns (base_row, buf, size)."""
    base0, drow, col, val = chain
    n = len(drow)
    size = 1 << 16
    while size < n:
        size <<= 1
    col = col.astype(np.uint16)
    buf = np.zeros(3 * size, np.uint8)
    buf[:n] = (drow << 4) | (col >> 8).astype(np.uint8)
    buf[size:size + n] = (col & 255).astype(np.uint8)
    buf[2 * size:2 * size + n] = val
    return base0, buf, size


def coo_scatter_into_stack(stack: jax.Array, chain, fidx: int,
                           packed24: bool = False) -> jax.Array:
    """Upload one delta-COO chain into plane ``fidx`` of a row-block
    stack (rows in the chain are RELATIVE to the block base; the caller
    slices its host plane per block).  Pow2-padded; async dispatch."""
    base0, drow, col, val = chain
    n = len(drow)
    size = 1 << 16
    while size < n:
        size <<= 1
    if packed24:
        base0, buf, size = _pack24(chain)
        return _coo_scatter_block24_stack(stack, jax.device_put(buf),
                                          jnp.int32(base0), fidx, size)
    pad = size - n
    if pad:
        drow = np.pad(drow, (0, pad))
        col = np.pad(col, (0, pad))
        val = np.pad(val, (0, pad))
    return _coo_scatter_block_stack(stack, jax.device_put(drow),
                                    jax.device_put(col),
                                    jax.device_put(val),
                                    jnp.int32(base0), fidx)


def coo_scatter_into(sim: jax.Array, chain,
                     packed24: bool = False) -> jax.Array:
    """Upload one merged delta-COO chain and scatter it into ``sim``.

    Pads to a pow2 ladder (>= 64K entries) so the device program has a
    handful of static shapes; pad entries are zero-value no-ops.
    ``packed24`` selects the 3-byte single-buffer format (requires the
    chain compacted with max_drow=15 and < 4096 genome columns).
    Dispatch is asynchronous.
    """
    base0, drow, col, val = chain
    n = len(drow)
    size = 1 << 16
    while size < n:
        size <<= 1
    pad = size - n
    if packed24:
        base0, buf, size = _pack24(chain)
        return _coo_scatter_block24(sim, jax.device_put(buf),
                                    jnp.int32(base0), size)
    if pad:
        drow = np.pad(drow, (0, pad))
        col = np.pad(col, (0, pad))
        val = np.pad(val, (0, pad))
    return _coo_scatter_block(sim, jax.device_put(drow),
                              jax.device_put(col), jax.device_put(val),
                              jnp.int32(base0))


def _cut_at_copy(packed: np.ndarray, lo: int, hi: int) -> int:
    """Largest copy-start index in (lo, hi] — every copy is <= 255 rows,
    so one exists within the last 256 positions of any window."""
    tail = packed[max(lo + 1, hi - 256):hi]
    starts = np.flatnonzero((tail & 0x40) == 0)
    if len(starts) == 0:  # single giant copy cannot happen by construction
        raise AssertionError("no copy boundary within 256 rows")
    return hi - len(tail) + int(starts[-1])


def pair_score_into(sim: jax.Array, buckets, num_reads: int,
                    g_pad: int, timer=None) -> jax.Array:
    """Accumulate all pair-stream buckets into the device matrix ``sim``.

    ``buckets`` is the planner's list of ``(packed, flatidx, window)``
    numpy tuples.  Each stream ships in fixed-size chunks cut at copy
    boundaries (pad rows: zero byte = chain-breaking non-genome row; pad
    index = the num_reads drop row).  Dispatches are asynchronous; the
    returned array is a device future.
    """
    drop_flat = num_reads * g_pad
    for packed, flat, window in buckets:
        n = len(packed)
        # pow2 ladder between the two sizes bounds pad waste for
        # mid-sized streams (a 300K stream must not pad to 8M rows)
        size = PAIR_CHUNK_SMALL
        while size < n and size < PAIR_CHUNK:
            size <<= 1
        lo = 0
        while lo < n:
            hi = min(lo + size, n)
            if hi < n:
                hi = _cut_at_copy(packed, lo, hi)
            pad = size - (hi - lo)
            chunk_p = packed[lo:hi]
            chunk_f = flat[lo:hi]
            if pad:
                chunk_p = np.pad(chunk_p, (0, pad))
                chunk_f = np.pad(chunk_f, (0, pad),
                                 constant_values=drop_flat)
            sim = _pair_score_block(sim, jax.device_put(chunk_p),
                                    jax.device_put(chunk_f),
                                    jnp.int32(window))
            lo = hi
    return sim


def pair_hits_host(packed: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle for :func:`pair_hits` (tests, no device).

    Scans whole runs instead of a band — identical to the device kernel
    whenever every copy is no longer than its bucket window, which the
    planner guarantees by construction.  Fully vectorized, so tests and
    the chip smoke run can check production-size streams: occurrence
    indexes are ranks within
    (doc-run, symbol) groups, and hits are per-(copy, symbol, occ)
    genome-row counts via one np.unique + bincount.
    """
    m = ((packed >> 6) & 1).astype(bool)
    dr = ((packed >> 5) & 1).astype(bool)
    gs = ((packed >> 4) & 1).astype(bool)
    sym = (packed & 15).astype(np.int64)
    n = len(packed)
    if n == 0:
        return np.zeros(0, np.int32)
    seg_doc = np.cumsum(~dr)         # doc-run id per row
    seg_copy = np.cumsum(~m)         # copy (cluster-run) id per row
    # occ = rank in position order within each (doc-run, symbol) group
    # (lexsort is stable, so equal keys keep position order)
    order = np.lexsort((sym, seg_doc))
    key = seg_doc[order] * 16 + sym[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(new)
    lens = np.diff(np.append(starts, n))
    rank_sorted = np.arange(n, dtype=np.int64) - np.repeat(starts, lens)
    occ = np.empty(n, np.int64)
    occ[order] = rank_sorted
    # hits[i] (read rows) = genome rows in the same copy with the same
    # (symbol, occ) key
    combined = (seg_copy * 16 + sym) * np.int64(n + 1) + occ
    _, inv = np.unique(combined, return_inverse=True)
    g_count = np.bincount(inv[gs], minlength=int(inv.max()) + 1)
    return np.where(gs, 0, g_count[inv]).astype(np.int32)
