"""planetmodel_sph_tpu_torch — PyTorch/CUDA port of the SPH engine.

A second package beside ``planetmodel_sph_tpu`` (the JAX reference, which
it never imports): the same model on PyTorch, with every TPU kernel of the
ported path rewritten as a hand-written CUDA kernel for Hopper
(``csrc/``, bound through ``ops/cuda/``). Entry points run on CUDA unless
the caller passes ``device="cpu"``, where the kernels' plain PyTorch
versions run instead.
"""

from . import config, state  # noqa: F401
from .config import (  # noqa: F401
    SimConfig, auto, basalt_impact, default, jupiter_3k, jupiter_100k, parity,
)
from .state import ParticleState  # noqa: F401

__version__ = "0.2.0"
