"""Model utils (counterpart of ``ufm_tpu/models/utils.py``)."""

from ufm_torch.utils.geometry import get_meshgrid_torch as get_meshgrid

__all__ = ["get_meshgrid"]
