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
    "PredictionHeadInput",
    "PredictionHeadLayeredInput",
    "PredictionHeadOutput",
    "RegressionOutput",
]
