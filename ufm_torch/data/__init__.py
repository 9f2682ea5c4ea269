"""Training data: image-pair datasets and fixed-shape batches."""

from ufm_torch.data.pairs import FlowPairDataset, train_batches

__all__ = ["FlowPairDataset", "train_batches"]
