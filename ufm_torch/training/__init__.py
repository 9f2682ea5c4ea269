"""Training: losses, the optimizer with fp32 master weights, the train step
(single-device and mesh-sharded) and the loop (the JAX package's
``ufm_tpu.training``)."""

from ufm_torch.training.losses import (
    covariance_nll_loss,
    covisibility_bce_loss,
    epe,
    flow_regression_loss,
    refinement_classification_loss,
    ufm_total_loss,
)
from ufm_torch.training.trainer import make_optimizer, make_sharded_train_step, make_train_step, synthetic_batch
from ufm_torch.training.loop import fit

__all__ = [
    "covariance_nll_loss",
    "covisibility_bce_loss",
    "epe",
    "fit",
    "flow_regression_loss",
    "make_optimizer",
    "make_sharded_train_step",
    "make_train_step",
    "refinement_classification_loss",
    "synthetic_batch",
    "ufm_total_loss",
]
