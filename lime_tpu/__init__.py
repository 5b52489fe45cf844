"""lime-tpu: accelerator-native alignment-free metagenomic read classification.

A from-scratch re-design of the LiME method (eBWT/LCP/DA alpha-cluster
classification) for accelerators through JAX: the reference's OpenMP byte-range
streaming becomes segmented scans over device meshes (jax/XLA), its per-cluster
fseek+sort scoring becomes one grouped pass at HBM bandwidth, and its
per-read cascade becomes a dense masked-reduction jit.

Quick start::

    from lime_tpu import LimeConfig, run_paired
    summary = run_paired([f1f, f1rc, f2f, f2rc], "out.csv",
                         num_reads, num_genomes, "LineageFile.csv",
                         read_len=100, config=LimeConfig(alpha=16, beta=0.25))
"""

from .config import DEFAULT_CONFIG, LimeConfig  # noqa: F401
from .pipeline import (  # noqa: F401
    classify,
    cluster_bwt,
    cluster_lcp,
    run_paired,
    run_single,
)

__version__ = "0.1.0"
