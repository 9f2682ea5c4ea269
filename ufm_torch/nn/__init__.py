"""Component library: transformer blocks, encoder, info sharing, heads."""

from ufm_torch.nn.layers import Attention, LayerScale, Mlp, TransformerBlock, run_blocks

__all__ = ["Attention", "LayerScale", "Mlp", "TransformerBlock", "run_blocks"]
