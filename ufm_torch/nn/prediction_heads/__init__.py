from ufm_torch.nn.prediction_heads.adaptors import (
    ConfidenceAdaptor,
    Covariance2DAdaptor,
    FlowAdaptor,
    FlowWithConfidenceAdaptor,
    MaskAdaptor,
)
from ufm_torch.nn.prediction_heads.base import (
    AdaptorMap,
    PredictionHeadInput,
    PredictionHeadLayeredInput,
    PredictionHeadOutput,
    RegressionOutput,
)
from ufm_torch.nn.prediction_heads.dpt import DPTFeature, DPTRegressionProcessor
from ufm_torch.nn.prediction_heads.mlp_feature import MLPFeature
from ufm_torch.nn.prediction_heads.moge_conv import MoGeConvFeature

__all__ = [
    "AdaptorMap",
    "ConfidenceAdaptor",
    "Covariance2DAdaptor",
    "DPTFeature",
    "DPTRegressionProcessor",
    "FlowAdaptor",
    "FlowWithConfidenceAdaptor",
    "MaskAdaptor",
    "MLPFeature",
    "MoGeConvFeature",
    "PredictionHeadInput",
    "PredictionHeadLayeredInput",
    "PredictionHeadOutput",
    "RegressionOutput",
]
