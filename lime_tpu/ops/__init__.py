"""Compute kernels: cluster detection, scoring, classification.

Each op has a vectorized numpy host implementation (the exact/portable path)
and a jax device implementation sharing the same semantics.  The numpy
paths are bit-compatible with the reference binaries, including their
counter-width quirks; see the individual modules for the parity notes.
"""

from .cluster_scan import find_clusters  # noqa: F401
from .scoring import normalize_scores, score_clusters  # noqa: F401
from .classify_ops import classify_reads  # noqa: F401
