"""Worker process for the 2-process distributed run_sharded test.

Usage: python -m tests._dist_worker <pid> <nproc> <port> <root> [engine]
       [mesh]
The dataset (4 collections + lineage) must already exist under <root>.
Process 0 writes <root>/dist_<engine>.csv (engine: banded | pair).
``mesh`` is an optional explicit "SPxDP" shape — e.g. 2x3 over 3
2-device processes forces the pair engine's chunk-exchange path (no
process covers every dp owner locally).
"""

import os
import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    root = sys.argv[4]

    # several worker processes share one host: none may claim an
    # accelerator, whatever the parent's environment says
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                               process_id=pid)

    from lime_tpu.config import LimeConfig
    from lime_tpu.parallel.sharded import run_sharded, run_sharded_pairs

    engine = sys.argv[5] if len(sys.argv) > 5 else "banded"
    mesh = None
    if len(sys.argv) > 6:
        from lime_tpu.parallel.mesh import make_mesh

        sp, dp = (int(v) for v in sys.argv[6].split("x"))
        mesh = make_mesh(sp * dp, shape=(sp, dp))
    runner = run_sharded_pairs if engine == "pair" else run_sharded
    meta = open(f"{root}/meta.txt").read().split()
    num_reads, num_genomes, read_len = (int(v) for v in meta)
    cols = [f"{root}/col_{t}.fasta" for t in ("1F", "1RC", "2F", "2RC")]
    runner(cols, f"{root}/dist_{engine}.csv", num_reads, num_genomes,
           f"{root}/LineageFile.csv", read_len,
           LimeConfig(executor="tpu"), mesh=mesh)
    print(f"[worker {pid}] done", flush=True)


if __name__ == "__main__":
    main()
