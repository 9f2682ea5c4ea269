"""ufm_torch: UFM (UniFlowMatch) dense correspondence in PyTorch and CUDA.

The port of the JAX package ``ufm_tpu`` to an NVIDIA H100. Plain tensor code
is PyTorch; each Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper (``ufm_torch/csrc``), built with ``nvcc`` on first use. Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
