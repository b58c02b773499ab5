"""tensornetworks_tpu_torch — the PyTorch/CUDA port of ``tensornetworks_tpu``.

Variational inference with quantum Born machines on discrete Bayesian
networks, trained by exact or sampled kernelized Stein discrepancy, or
adversarially, for an NVIDIA H100.
The JAX package is the reference; this package imports neither it nor JAX.
The kernels it ran as Pallas kernels on the TPU are hand-written CUDA here
(``csrc/``, built with ``nvcc`` at first use; see ``ops/kernels``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper runs its plain torch version.

Precision follows the JAX package's policy, FP32 by default: TF32 is
switched off for matmuls and cuDNN below, because the JAX package measured
that one bf16 pass degrades the final TVD 16-24x. Two knobs lower it: the
kernel precision (``ops/kernels/precision.py``, ``TNTPU_KERNEL_PRECISION``,
default ``highest``: circuit kernels 1, 2, 5 and 6 as three (``high``) or
one (``default``) bf16 tensor-core passes), and the matmul precision of the
engines' ``train`` (``engines.common.highest_matmul_precision``,
``TNTPU_MATMUL_PRECISION``, default ``high``, which runs FP32; ``default``
allows TF32).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .core import BayesianNetwork, calculate_tvd, get_random_chain_network, get_sprinkler_network  # noqa: E402
from .engines import QuantumKSDVariationalInference, SampledKSDVariationalInference  # noqa: E402
from .models import QuantumBornMachine  # noqa: E402

__all__ = [
    "BayesianNetwork",
    "QuantumBornMachine",
    "QuantumKSDVariationalInference",
    "SampledKSDVariationalInference",
    "calculate_tvd",
    "get_random_chain_network",
    "get_sprinkler_network",
]
