from ufm_torch.nn.info_sharing.global_attention import (
    INFO_SHARING_CLASSES,
    MultiViewGlobalAttentionTransformer,
    MultiViewTransformerInput,
    MultiViewTransformerOutput,
)

__all__ = [
    "INFO_SHARING_CLASSES",
    "MultiViewGlobalAttentionTransformer",
    "MultiViewTransformerInput",
    "MultiViewTransformerOutput",
]
