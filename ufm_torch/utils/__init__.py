"""Utilities: resize / unmap with region bookkeeping, visualization."""

from ufm_torch.utils.flow_resizing import (
    AutomaticShapeSelection,
    CenterCropManipulation,
    ImagePairsManipulationComposite,
    ResizeHorizontalAxisManipulation,
    ResizeToFixedManipulation,
    ResizeVerticalAxisManipulation,
    scale_axis,
    unmap_predicted_channels,
    unmap_predicted_flow,
)

__all__ = [
    "AutomaticShapeSelection",
    "CenterCropManipulation",
    "ImagePairsManipulationComposite",
    "ResizeHorizontalAxisManipulation",
    "ResizeToFixedManipulation",
    "ResizeVerticalAxisManipulation",
    "scale_axis",
    "unmap_predicted_channels",
    "unmap_predicted_flow",
]
