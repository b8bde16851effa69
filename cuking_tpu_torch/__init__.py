"""cuking_tpu_torch — the PyTorch and CUDA port of ``cuking_tpu``.

KING relatedness on NVIDIA GPUs with the JAX package's inputs, outputs, CLI
flags and error semantics: sparse ``(row_idx, col_idx, n_alt_alleles)``
Parquet plus ``metadata.json`` in, sorted Snappy ``part-%05d`` partitions of
``i, j, kin, ibs0, ibs1, ibs2`` out.  The count kernel is hand-written CUDA
(``csrc/king_counts.cu``); everything around it is plain PyTorch and numpy.
A cohort spreads over several GPUs, or several processes, through the ring
(``parallel/ring.py``, ``--use_mesh`` / ``--distributed``).

The package imports neither ``jax`` nor ``cuking_tpu``, and nothing here
imports pyarrow or builds a kernel at import time.  Entry point:
``python -m cuking_tpu_torch.cli``.
"""

__version__ = "0.1.0"

from cuking_tpu_torch.api import king  # noqa: F401
from cuking_tpu_torch.prune import related_samples_to_drop  # noqa: F401
from cuking_tpu_torch.models.king import KingConfig, KingEngine, ResultSet  # noqa: F401
from cuking_tpu_torch.ops.king_math import KingCounts, KingResult  # noqa: F401
from cuking_tpu_torch.parallel.submatrix import Submatrix  # noqa: F401
