"""Models: the UFM family, its network and its output interfaces."""

from ufm_torch.models.base import (
    UFMClassificationRefinementOutput,
    UFMFlowFieldOutput,
    UFMMaskFieldOutput,
    UFMOutputInterface,
    UniFlowMatchModelsBase,
)
from ufm_torch.models.config import (
    UFMArchConfig,
    ufm_base_config,
    ufm_base_vitg_reg_config,
    ufm_refine_config,
    ufm_tiny_config,
)
from ufm_torch.models.network import UFMNet
from ufm_torch.models.tiled import predict_correspondences_tiled
from ufm_torch.models.ufm import UniFlowMatch, UniFlowMatchClassificationRefinement, UniFlowMatchConfidence

__all__ = [
    "UFMArchConfig",
    "UFMClassificationRefinementOutput",
    "UFMFlowFieldOutput",
    "UFMMaskFieldOutput",
    "UFMNet",
    "UFMOutputInterface",
    "UniFlowMatch",
    "UniFlowMatchClassificationRefinement",
    "UniFlowMatchConfidence",
    "UniFlowMatchModelsBase",
    "predict_correspondences_tiled",
    "ufm_base_config",
    "ufm_base_vitg_reg_config",
    "ufm_refine_config",
    "ufm_tiny_config",
]
