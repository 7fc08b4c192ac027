"""repro_torch — the PyTorch/CUDA port of the CrowdHMTware reproduction.

A second package beside the JAX one, held against it module by module.
It imports ``torch`` and never ``jax``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  See README.md ("PyTorch
port") for what is ported so far.
"""

__version__ = "0.1.0"

from repro_torch.models.configs import INPUT_SHAPES, InputShape, ModelConfig

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "__version__"]
