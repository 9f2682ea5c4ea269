"""ufm_torch: UFM (UniFlowMatch) dense correspondence in PyTorch and CUDA.

The port of the JAX package ``ufm_tpu`` to an NVIDIA H100. Plain tensor code
is PyTorch; each Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper (``ufm_torch/csrc``), built with ``nvcc`` on first use. Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]

_LAZY_MODELS = ("UniFlowMatch", "UniFlowMatchConfidence", "UniFlowMatchClassificationRefinement")


def __getattr__(name):
    # the model classes load on first use, so ``import ufm_torch`` stays light
    if name in _LAZY_MODELS:
        from ufm_torch import models

        return getattr(models, name)
    raise AttributeError(f"module 'ufm_torch' has no attribute {name!r}")
