"""chip_smoke.py's phases at a tiny size on the CPU.

The script itself refuses to run without a GPU; its phase functions are
plain code and run here on small generated data, so a broken phase shows
up before a run on the card.
"""

import os

import jax
import numpy as np
import pytest

import chip_smoke as cs
from lime_tpu import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

NAME = "cpu (test)"


@pytest.fixture(scope="module")
def paper(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chip_smoke"))
    ds = cs.paper_dataset(5, num_pairs=40_000, num_genomes=12,
                          genome_len=3000, root=root)
    return ds, cs.host_reference(ds, "paper")


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_dataset_is_reused(paper):
    ds, _ = paper
    stamp = os.path.join(ds.root, "complete")
    before = os.path.getmtime(stamp)
    again = cs.paper_dataset(5, num_pairs=40_000, num_genomes=12,
                             genome_len=3000,
                             root=os.path.dirname(ds.root))
    assert again.collections == ds.collections
    assert os.path.getmtime(stamp) == before


def test_phase_main_path(paper):
    ds, host_csv = paper
    times = cs.phase_main_path(ds, host_csv, NAME)
    assert set(times) == {"cold", "warm"}


def test_phase_row_blocked(paper):
    ds, host_csv = paper
    cs.phase_row_blocked(ds, host_csv, n_blocks=3)
    assert "LIME_HBM_BUDGET" not in os.environ


def test_row_block_budget_splits_rows():
    budget, blocks = cs.row_block_budget(1_000_000, 930, 4)
    assert blocks == 4
    assert budget % (4 * 1024 * 2) == 0


def test_phase_staged(tmp_path):
    ds = cs.example_dataset(3, num_pairs=150, genome_lens=(4000, 3000),
                            root=str(tmp_path))
    cs.phase_staged(ds)


def test_phase_kernels():
    rows = cs.phase_kernels(NAME, n=4 * 4096, reps=1, unit=4096)
    assert [(r["cap"], r["form"]) for r in rows] == [
        (16, "scan"), (16, "core"), (64, "scan"), (64, "core"),
        (255, "core")]


def test_phase_four_on_virtual_devices(paper):
    assert len(jax.devices()) >= 4
    ds, host_csv = paper
    cs.phase_four(ds, host_csv, NAME)


def test_same_csv_reports_a_mismatch(paper, tmp_path):
    ds, host_csv = paper
    bad = tmp_path / "bad.csv"
    bad.write_bytes(open(host_csv, "rb").read().replace(b"C,", b"U,", 1))
    with pytest.raises(AssertionError, match="differs"):
        cs._same_csv(str(bad), host_csv, "tampered")


def test_trace_shares_reads_a_trace(tmp_path):
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(jax.jit(lambda x: x * 2)(np.ones(8)))
    shares = cs.trace_shares(str(tmp_path))
    # the CPU backend has no GPU plane: nothing counts as device time
    assert shares["device_busy_s"] == 0
    assert shares["pair_hits_s"] == 0
