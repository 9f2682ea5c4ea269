"""Tiled UFM-Refine on the CPU against the JAX package on the same inputs.

``predict_correspondences_tiled`` on the tiny UFM-Refine (the patch-MLP
classification head and the window refinement, with and without the UNet
features), the JAX package's weights carried into the port, at 120x160 in
forwards of 5 and of 16 tiles: the same tile statistics as
``ufm_tpu.models.tiled`` and every output within the bar
``tests/test_torch_port_tiled_eval.py`` holds the tiled tiny UFM-Base to.
"""

import numpy as np
import pytest

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UniFlowMatchClassificationRefinement as JRefine
from ufm_tpu.models import tiled as jtiled
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UniFlowMatchClassificationRefinement, ufm_tiny_config
from ufm_torch.models import tiled as ptiled
from ufm_torch.utils import example_pairs as ppairs

MODEL_ATOL = 1e-4  # the tiled tiny UFM-Base's bar (tests/test_torch_port_tiled_eval.py)
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}


@pytest.fixture(scope="module", params=["no_unet", "unet"])
def refine_models(request):
    """The JAX tiny UFM-Refine and the port's with the same weights (the
    port on the CPU takes the plain window refinement)."""
    cfg = UNET if request.param == "unet" else {}
    jmodel = JRefine.from_config(jax_tiny_config(has_classification_head=True, **cfg), seed=4)
    model = UniFlowMatchClassificationRefinement.from_config(ufm_tiny_config(**cfg), device="cpu")
    load_jax_params(model, flatten_params(jmodel.params))
    return jmodel, model


@pytest.mark.parametrize("max_batch", [5, 16])
def test_tiled_refine_matches_jax(refine_models, max_batch):
    jmodel, model = refine_models
    src, tgt, _, _ = ppairs.synthetic_pair(h=120, w=160, seed=3, max_disp=6.0)
    want = jtiled.predict_correspondences_tiled(jmodel, src, tgt, max_batch=max_batch)
    want_stats = dict(jtiled.last_tile_stats)
    got = ptiled.predict_correspondences_tiled(model, src, tgt, max_batch=max_batch)
    assert ptiled.last_tile_stats == want_stats and want_stats["tiles"] == 16
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape
        np.testing.assert_allclose(g, wnt, atol=MODEL_ATOL, rtol=0)
