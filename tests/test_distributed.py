"""True multi-process execution: 2 jax.distributed CPU processes.

Each process plans only its own index range (plan_host_range), assembles
its local shards with make_array_from_process_local_data, and the SPMD
program runs over the 8-device global mesh (4 per process).  The CSV
written by process 0 must be byte-identical to the exact host pipeline —
the reference's thread-count-independence invariant (SURVEY.md §4)
lifted to processes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.pipeline import run_paired

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("engine,port", [("banded", "29741"),
                                         ("pair", "29742")])
def test_two_process_sharded_matches_host(tmp_path, engine, port):
    from .synth import make_dataset

    ds = make_dataset(str(tmp_path), num_pairs=300, read_len=100,
                      genome_lens=(8000, 6000, 5000), seed=23)
    with open(tmp_path / "meta.txt", "w") as f:
        f.write(f"{ds.num_reads} {ds.num_genomes} {ds.read_len}")

    host_out = tmp_path / "host.csv"
    run_paired(ds.collections, str(host_out), ds.num_reads,
               ds.num_genomes, ds.lineage_path, ds.read_len,
               LimeConfig(executor="host"))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = ROOT
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests._dist_worker", str(pid), "2",
             port, str(tmp_path), engine],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    with open(host_out) as f:
        want = f.read()
    with open(tmp_path / f"dist_{engine}.csv") as f:
        got = f.read()
    assert got == want


@pytest.mark.parametrize("engine,mesh,port", [
    ("banded", "3x2", "29743"),
    ("pair", "2x3", "29744"),  # dp=3 over 2-device processes: no process
    # covers every dp owner -> the chunk-exchange path
])
def test_three_process_sharded_matches_host(tmp_path, engine, mesh, port):
    """3 jax.distributed processes x 2 devices over an explicit 6-device
    mesh — the reference runs at ANY thread count
    (src/ClusterLCP.cpp:139-141); round 4 raised on mesh/process
    combinations that did not divide evenly."""
    from .synth import make_dataset

    ds = make_dataset(str(tmp_path), num_pairs=200, read_len=100,
                      genome_lens=(8000, 6000, 5000), seed=31)
    with open(tmp_path / "meta.txt", "w") as f:
        f.write(f"{ds.num_reads} {ds.num_genomes} {ds.read_len}")

    host_out = tmp_path / "host.csv"
    run_paired(ds.collections, str(host_out), ds.num_reads,
               ds.num_genomes, ds.lineage_path, ds.read_len,
               LimeConfig(executor="host"))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = ROOT
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests._dist_worker", str(pid), "3",
             port, str(tmp_path), engine, mesh],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in range(3)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    with open(host_out) as f:
        want = f.read()
    with open(tmp_path / f"dist_{engine}.csv") as f:
        got = f.read()
    assert got == want
