"""Parity: the XLA banded engine vs the host exact scorer.

``parallel.sharded.banded_partial_sim`` scores a raw position stream
(in-run mask, document ids, symbol ranks) with banded occurrence matching.
``ops.scoring.score_clusters`` scores the same alpha-clusters from an
explicit cluster list with per-(cluster, document) symbol histograms — an
independent formulation of the reference's per-cluster scoring
(src/ClusterBWT_DA.cpp:256-358).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lime_tpu.config import LimeConfig
from lime_tpu.constants import IUPAC_ORDER
from lime_tpu.ops.scoring import score_clusters
from lime_tpu.parallel.sharded import banded_partial_sim

_ACGT = np.frombuffer(IUPAC_ORDER[:4].encode(), np.uint8)


def _rand_stream(rng, n, num_reads, num_refs, alpha, max_run):
    lcp = rng.integers(0, alpha + 6, size=n).astype(np.int32)
    lcp[0] = 0
    run = 0
    m = lcp >= alpha
    for i in range(n):
        run = run + 1 if m[i] else 0
        if run >= max_run:
            lcp[i] = 0
            run = 0
    m = lcp >= alpha
    m[0] = False
    doc = rng.integers(0, num_reads + num_refs, size=n).astype(np.int32)
    sym = rng.integers(0, 4, size=n).astype(np.int32)
    return m, doc, sym


def _clusters(m):
    """Alpha-clusters of a mask: each maximal run of m, extended one row
    to the left (the reference's cluster rows, src/ClusterLCP.cpp)."""
    d = np.diff(np.concatenate([[0], m.astype(np.int8), [0]]))
    s = np.flatnonzero(d == 1)
    e = np.flatnonzero(d == -1)
    return s - 1, e - s + 1


def _exact(m, doc, sym, num_reads, num_refs):
    starts, lens = _clusters(m)
    return score_clusters(starts, lens, doc.astype(np.uint32), _ACGT[sym],
                          num_reads, num_refs,
                          LimeConfig(executor="host", wide_sim=True))


def _banded(m, doc, sym, num_reads, num_refs, window, emit=None, **kw):
    return np.asarray(banded_partial_sim(
        jnp.asarray(m), jnp.asarray(doc), jnp.asarray(sym), num_reads,
        num_refs, jnp.int32(window),
        emit_ok=None if emit is None else jnp.asarray(emit), **kw))


def _position_reference(m, doc, sym, num_reads, num_refs, emit):
    """Occurrence matching position by position, counting only pairs
    whose read-side position may emit."""
    sim = np.zeros((num_reads, num_refs), np.int64)
    for s, ln in zip(*_clusters(m)):
        seen = {}
        key = []
        for i in range(s, s + ln):
            k = (doc[i], sym[i])
            key.append((sym[i], seen.get(k, 0)))
            seen[k] = seen.get(k, 0) + 1
        for a in range(ln):
            i = s + a
            if doc[i] >= num_reads or not emit[i]:
                continue
            for b in range(ln):
                j = s + b
                if doc[j] >= num_reads and key[a] == key[b]:
                    sim[doc[i], doc[j] - num_reads] += 1
    return sim


@pytest.mark.parametrize("num_refs", [6, 128, 200])
@pytest.mark.parametrize("window", [1, 7, 32])
def test_banded_matches_exact(num_refs, window):
    rng = np.random.default_rng(window * 1000 + num_refs)
    num_reads, n = 300, 5000
    m, doc, sym = _rand_stream(rng, n, num_reads, num_refs, 4, window)
    got = _banded(m, doc, sym, num_reads, num_refs, window)
    np.testing.assert_array_equal(
        got, _exact(m, doc, sym, num_reads, num_refs))


def test_banded_emit_mask():
    """Emission gating partitions the pairs by their read-side position:
    the two complementary masks sum to the exact scores, and each equals
    the position-by-position reference."""
    rng = np.random.default_rng(99)
    num_reads, num_refs, window, n = 200, 12, 9, 4096
    m, doc, sym = _rand_stream(rng, n, num_reads, num_refs, 4, window)
    emit = rng.random(n) < 0.5
    on = _banded(m, doc, sym, num_reads, num_refs, window, emit)
    off = _banded(m, doc, sym, num_reads, num_refs, window, ~emit)
    np.testing.assert_array_equal(
        on + off, _exact(m, doc, sym, num_reads, num_refs))
    np.testing.assert_array_equal(
        on, _position_reference(m, doc, sym, num_reads, num_refs, emit))


def test_banded_padded_int8_accumulator():
    """The paper-scale memory-plan form: a padded (out_rows, g_pad) int8
    accumulator with the scatter drop row at ``num_reads``."""
    rng = np.random.default_rng(17)
    num_reads, num_refs, window, n = 400, 10, 21, 9000
    m, doc, sym = _rand_stream(rng, n, num_reads, num_refs, 4, window)
    out_rows = 512
    got = _banded(m, doc, sym, num_reads, num_refs, window,
                  out_rows=out_rows, acc_dtype=jnp.int8)
    assert got.shape == (out_rows, 128) and got.dtype == np.int8
    want = _exact(m, doc, sym, num_reads, num_refs)
    np.testing.assert_array_equal(got[:num_reads, :num_refs],
                                  (want % 256).astype(np.uint8).view(np.int8))
    assert not got[num_reads + 1:].any()
    assert not got[:, num_refs:].any()


def test_banded_long_clusters_at_block_edges():
    """Clusters near the window cap, straddling multiples of 2048."""
    num_reads, num_refs, window = 50, 4, 40
    n = 2048 * 2 + 100
    m = np.zeros(n, bool)
    doc = np.full(n, num_reads + 1, np.int32)
    sym = np.zeros(n, np.int32)
    rng = np.random.default_rng(5)
    for start in (2048 - 20, 4096 - 3, 100, 3000):
        ln = 39
        m[start + 1:start + ln] = True
        doc[start:start + ln] = rng.integers(0, num_reads + num_refs, ln)
        sym[start:start + ln] = rng.integers(0, 4, ln)
    m[0] = False
    got = _banded(m, doc, sym, num_reads, num_refs, window)
    np.testing.assert_array_equal(
        got, _exact(m, doc, sym, num_reads, num_refs))
