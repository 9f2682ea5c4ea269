"""ufm_torch modules against their flax counterparts, on the CPU in fp32.

Each flax module is initialized, its parameters are perturbed with seeded
noise (so zero-initialized biases, tokens and embeddings take part), carried
into the port with ``jax_params_to_state_dict`` and both run on the same numpy
inputs. Tolerance: atol 1e-5 (fp32 on both sides; only summation order
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
from ufm_tpu.nn.encoders import ViTEncoder as JViT
from ufm_tpu.nn.encoders import ViTEncoderInput as JViTInput
from ufm_tpu.nn.encoders.vit import _interpolate_pos_embed as jax_interpolate_pos_embed
from ufm_tpu.nn.info_sharing import MultiViewGlobalAttentionTransformer as JInfo
from ufm_tpu.nn.info_sharing import MultiViewTransformerInput as JInfoInput
from ufm_tpu.nn.layers import TransformerBlock as JBlock
from ufm_tpu.nn.prediction_heads import AdaptorMap as JAdaptorMap
from ufm_tpu.nn.prediction_heads import DPTFeature as JDPTFeature
from ufm_tpu.nn.prediction_heads import DPTRegressionProcessor as JDPTProcessor
from ufm_tpu.nn.prediction_heads import MLPFeature as JMLPFeature
from ufm_tpu.nn.prediction_heads import PredictionHeadInput as JHeadInput
from ufm_tpu.nn.prediction_heads import PredictionHeadLayeredInput as JLayered
from ufm_tpu.nn.prediction_heads import RegressionOutput as JRegression
from ufm_tpu.nn.unet import UNet as JUNet
from ufm_tpu.models.network import CLASSNAME_TO_ADAPTOR_CLASS as J_ADAPTORS
from ufm_tpu.ops import resize as jresize
from ufm_tpu.utils import flow_resizing as jfr
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.models.network import CLASSNAME_TO_ADAPTOR_CLASS as T_ADAPTORS
from ufm_torch.nn.encoders import ViTEncoder, ViTEncoderInput
from ufm_torch.nn.encoders.vit import interpolate_pos_embed
from ufm_torch.nn.info_sharing import MultiViewGlobalAttentionTransformer, MultiViewTransformerInput
from ufm_torch.nn.layers import TransformerBlock
from ufm_torch.nn.prediction_heads import (
    AdaptorMap,
    DPTFeature,
    DPTRegressionProcessor,
    MLPFeature,
    PredictionHeadInput,
    PredictionHeadLayeredInput,
    RegressionOutput,
)
from ufm_torch.nn.unet import UNet
from ufm_torch.ops import resize as tresize
from ufm_torch.utils import flow_resizing as tfr

ATOL = 1e-5
ENC, INFO = 32, 24


def _carry(jax_module, torch_module, *init_args, seed=0):
    """Init the flax module, perturb its params, load them into the torch
    module; return the perturbed flax params."""
    params = jax_module.init(jax.random.PRNGKey(seed), *init_args)["params"]
    rng = np.random.default_rng(seed)
    flat = {k: v + rng.normal(0.0, 0.05, v.shape).astype(v.dtype) for k, v in flatten_params(params).items()}
    load_jax_params(torch_module, flat)
    return unflatten_params(flat)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("layerscale", [None, 0.1])
def test_transformer_block(layerscale):
    x = np.random.default_rng(1).standard_normal((2, 9, ENC)).astype(np.float32)
    jblock = JBlock(num_heads=2, layerscale_init=layerscale)
    block = TransformerBlock(ENC, 2, layerscale_init=layerscale)
    params = _carry(jblock, block, jnp.asarray(x))
    with torch.no_grad():
        _close(block(_t(x)), jblock.apply({"params": params}, jnp.asarray(x)))


def test_converter_layouts():
    """Dense kernels transpose, conv kernels HWIO -> OIHW, LayerNorm scale ->
    weight, stacked blocks unstack."""
    rng = np.random.default_rng(0)
    flat = {
        "a/fc/kernel": rng.standard_normal((3, 5)),
        "a/conv/kernel": rng.standard_normal((3, 3, 4, 6)),
        "a/resize_1/kernel": rng.standard_normal((2, 2, 4, 4)),
        "a/norm/scale": rng.standard_normal((5,)),
        "a/blocks/attn/qkv/bias": rng.standard_normal((2, 7)),
    }
    sd = jax_params_to_state_dict(flat)
    assert sd["a.fc.weight"].shape == (5, 3)
    assert torch.equal(sd["a.conv.weight"], _t(flat["a/conv/kernel"].transpose(3, 2, 0, 1)))
    assert torch.equal(sd["a.resize_1.weight"], _t(flat["a/resize_1/kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy()))
    assert torch.equal(sd["a.norm.weight"], _t(flat["a/norm/scale"]))
    assert torch.equal(sd["a.blocks.1.attn.qkv.bias"], _t(flat["a/blocks/attn/qkv/bias"][1]))


@pytest.fixture(scope="module")
def vit_pair():
    kw = dict(patch_size=14, embed_dim=ENC, depth=2, num_heads=2, pretrain_grid_size=4, intermediate_layer_idx=(0, 1, -1))
    jvit = JViT(**kw)
    vit = ViTEncoder(**kw)
    img = np.zeros((1, 56, 56, 3), np.float32)
    params = _carry(jvit, vit, JViTInput(image=jnp.asarray(img)), seed=3)
    return jvit, params, vit


@pytest.mark.parametrize("hw", [(42, 56), (56, 56), (70, 84)], ids=["grid3x4", "grid4x4", "grid5x6"])
def test_vit_encoder(vit_pair, hw):
    """Pos-embed grid 4x4 resized to a smaller, the same and a larger grid;
    taps (0, 1, -1) include a repeated layer."""
    jvit, params, vit = vit_pair
    img = np.random.default_rng(hw[0]).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jvit.apply({"params": params}, JViTInput(image=jnp.asarray(img)))
    with torch.no_grad():
        got = vit(ViTEncoderInput(image=_t(img)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g.features, w.features)


@pytest.mark.parametrize("grid", [(30, 40), (3, 4), (5, 6)])
def test_pos_embed_interpolation(grid):
    """jax.image.resize(method="cubic") weights (Keys a=-0.5, antialiased when
    downsampling). (30, 40) from 37 is the flagship's 560x420 case: rows down,
    columns up."""
    g = 37 if grid == (30, 40) else 4
    pe = np.random.default_rng(0).standard_normal((1, g * g, 16)).astype(np.float32)
    _close(interpolate_pos_embed(_t(pe), grid), jax_interpolate_pos_embed(jnp.asarray(pe), grid))


def test_info_sharing():
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, 3, 4, ENC)).astype(np.float32) for _ in range(2)]
    kw = dict(input_embed_dim=ENC, dim=INFO, depth=2, num_heads=2, intermediate_layer_idx=(0, 1))
    jmod = JInfo(**kw)
    mod = MultiViewGlobalAttentionTransformer(**kw)
    params = _carry(jmod, mod, JInfoInput(features=[jnp.asarray(f) for f in feats]), seed=4)
    jfinal, jinter = jmod.apply({"params": params}, JInfoInput(features=[jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        final, inter = mod(MultiViewTransformerInput(features=[_t(f) for f in feats]))
    for v in range(2):
        _close(final.features[v], jfinal.features[v])
        for j in range(2):
            _close(inter[j].features[v], jinter[j].features[v])


def test_dpt_head():
    """DPTFeature (odd 3x4 grid: the skip-aligning resize runs) +
    DPTRegressionProcessor."""
    rng = np.random.default_rng(5)
    dims = (ENC, INFO, INFO, INFO)
    levels = [rng.standard_normal((2, 3, 4, c)).astype(np.float32) for c in dims]
    feat_kw = dict(input_dims=dims, proj_dims=(8, 16, 24, 32), feature_dim=16)
    proc_kw = dict(input_dim=16, hidden_dims=(8, 8), output_dim=10)
    target = (42, 56)

    jfeat, feat = JDPTFeature(**feat_kw), DPTFeature(**feat_kw)
    jinp = JLayered(list_features=[jnp.asarray(x) for x in levels], target_output_shape=target)
    fparams = _carry(jfeat, feat, jinp, seed=5)
    jfused = jfeat.apply({"params": fparams}, jinp)

    jproc, proc = JDPTProcessor(**proc_kw), DPTRegressionProcessor(**proc_kw)
    pparams = _carry(jproc, proc, jfused, target, seed=6)
    jreg = jproc.apply({"params": pparams}, jfused, target)

    with torch.no_grad():
        fused = feat(PredictionHeadLayeredInput(list_features=[_t(x) for x in levels], target_output_shape=target))
        reg = proc(fused, target)
    _close(fused, jfused)
    _close(reg.value, jreg.value)


@pytest.mark.parametrize("hidden", [(32,), (32, 16)])
def test_mlp_feature(hidden):
    """fc<i> -> exact GELU -> fc_out, then depth-to-space to (2, 42, 56, 8)."""
    x = np.random.default_rng(10).standard_normal((2, 3, 4, ENC + INFO)).astype(np.float32)
    kw = dict(input_feature_dim=ENC + INFO, hidden_dims=hidden, output_dim=8, patch_size=14)
    jmod, mod = JMLPFeature(**kw), MLPFeature(**kw)
    params = _carry(jmod, mod, JHeadInput(last_feature=jnp.asarray(x)), seed=10)
    want = jmod.apply({"params": params}, JHeadInput(last_feature=jnp.asarray(x))).decoded_channels
    with torch.no_grad():
        got = mod(PredictionHeadInput(last_feature=_t(x))).decoded_channels
    assert got.shape == (2, 42, 56, 8)
    _close(got, want)


@pytest.mark.parametrize("hw", [(42, 56), (28, 36)])
def test_unet(hw):
    """Features (8, 16). At 42 rows the pyramid goes 42 -> 21 -> 10, so the
    up path meets a 21-row skip with 20 rows and takes the nearest resize (as
    the flagship's 420 rows do at 105); 28 x 36 takes none."""
    x = np.random.default_rng(11).standard_normal((2, *hw, 3)).astype(np.float32)
    jmod, mod = JUNet(out_channels=8, features=(8, 16)), UNet(out_channels=8, features=(8, 16))
    params = _carry(jmod, mod, jnp.asarray(x), seed=11)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mod(_t(x))
    assert got.shape == (2, *hw, 8)
    _close(got, want)


def test_converter_unet_transposed_convs():
    """The UNet's ``up_<i>`` kernels are flax ConvTransposes (spatial flip,
    (in, out, H, W)); ``up_conv_<i>`` is a regular DoubleConv, whatever its
    prefix."""
    rng = np.random.default_rng(1)
    flat = {
        "unet_feature/up_0/kernel": rng.standard_normal((2, 2, 6, 4)),
        "unet_feature/up_12/kernel": rng.standard_normal((2, 2, 6, 4)),
        "unet_feature/up_conv_0/conv1/kernel": rng.standard_normal((3, 3, 6, 4)),
        "unet_feature/up_conv_0/kernel": rng.standard_normal((3, 3, 6, 4)),
    }
    sd = jax_params_to_state_dict(flat)
    for name in ("up_0", "up_12"):
        want = flat[f"unet_feature/{name}/kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy()
        assert torch.equal(sd[f"unet_feature.{name}.weight"], _t(want))
    for name in ("up_conv_0.conv1", "up_conv_0"):
        want = flat[f"unet_feature/{name.replace('.', '/')}/kernel"].transpose(3, 2, 0, 1)
        assert torch.equal(sd[f"unet_feature.{name}.weight"], _t(want))


@pytest.mark.parametrize("order", ["listed", "reversed"])
def test_adaptor_map(order):
    """All five adaptors in one AdaptorMap, consuming channels in list order,
    on standard-normal regression channels (the covariance's 1 - rho^2 and
    exp() keep their fp32 error relative, so it is held with rtol 1e-5)."""
    names = ["FlowAdaptor", "FlowWithConfidenceAdaptor", "MaskAdaptor", "ConfidenceAdaptor", "Covariance2DAdaptor"]
    if order == "reversed":
        names = names[::-1]
    value = np.random.default_rng(9).standard_normal((2, 7, 9, 10)).astype(np.float32)
    jout = JAdaptorMap(*[J_ADAPTORS[n](name=n) for n in names])(JRegression(value=jnp.asarray(value)))
    out = AdaptorMap(*[T_ADAPTORS[n](name=n) for n in names])(RegressionOutput(value=_t(value)))
    for n in names:
        for field, want in vars(jout[n]).items():
            _close(getattr(out[n], field), want, rtol=1e-5)


@pytest.mark.parametrize(
    "in_hw,out_hw,antialias,align_corners",
    [
        ((17, 23), (9, 30), True, False),
        ((17, 23), (40, 11), False, False),
        ((5, 7), (10, 14), False, True),
        ((1080, 64), (420, 32), True, False),
    ],
)
def test_resize_hwc(in_hw, out_hw, antialias, align_corners):
    x = np.random.default_rng(6).standard_normal((2, *in_hw, 3)).astype(np.float32)
    _close(
        tresize.resize_hwc(_t(x), out_hw, antialias=antialias, align_corners=align_corners),
        jresize.resize_hwc(jnp.asarray(x), out_hw, antialias=antialias, align_corners=align_corners),
    )


@pytest.mark.parametrize("in_hw,out_hw", [((17, 23), (9, 30)), ((6, 5), (19, 13))])
def test_resize_nearest_hwc(in_hw, out_hw):
    x = np.random.default_rng(7).standard_normal((2, *in_hw, 3)).astype(np.float32)
    _close(tresize.resize_nearest_hwc(_t(x), out_hw), jresize.resize_nearest_hwc(jnp.asarray(x), out_hw), atol=0)


def _manipulations(pkg):
    return {
        "resize_to_fixed": pkg.ResizeToFixedManipulation((42, 56)),
        "resize_then_crop": pkg.ImagePairsManipulationComposite(
            pkg.ResizeVerticalAxisManipulation(70), pkg.CenterCropManipulation((56, 56))
        ),
    }


@pytest.mark.parametrize("name", ["resize_to_fixed", "resize_then_crop"])
def test_manipulation_and_unmap(name):
    """The same manipulation in both packages gives the same images and
    regions; unmapping one predicted flow / channel map through them agrees."""
    rng = np.random.default_rng(8)
    h0, w0, h1, w1 = 80, 100, 90, 120
    img0 = rng.standard_normal((1, h0, w0, 3)).astype(np.float32)
    img1 = rng.standard_normal((1, h1, w1, 3)).astype(np.float32)

    def run(pkg, to):
        m = pkg.AutomaticShapeSelection(_manipulations(pkg)[name])
        return m(to(img0), to(img1))

    jout = run(jfr, jnp.asarray)
    tout = run(tfr, _t)
    for j in range(2):
        _close(tout[j], jout[j])
    for j in range(2, 6):
        np.testing.assert_array_equal(tout[j], jout[j])

    oh, ow = tout[0].shape[1:3]
    flow = rng.standard_normal((1, oh, ow, 2)).astype(np.float32) * 5
    chans = rng.standard_normal((1, oh, ow, 3)).astype(np.float32)
    s0, s1, r0, r1 = tout[2], tout[3], tout[4], tout[5]
    jflow, jvalid = jfr.unmap_predicted_flow(jnp.asarray(flow), r0, r1, s0, s1, (h0, w0), (h1, w1))
    tflow, tvalid = tfr.unmap_predicted_flow(_t(flow), r0, r1, s0, s1, (h0, w0), (h1, w1))
    _close(tflow, jflow, atol=1e-4)  # flow in pixels, up to ~1e2: a few fp32 ulps
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jch, jcv = jfr.unmap_predicted_channels(jnp.asarray(chans), r0, s0, (h0, w0))
    tch, tcv = tfr.unmap_predicted_channels(_t(chans), r0, s0, (h0, w0))
    _close(tch, jch, atol=0)
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("dinov2_large", {"intermediate_layer_idx": (0, 23)}),
        ("dinov2_custom", {"size": "small", "img_size": 56, "init_values": 0.1, "name": "x", "num_register_tokens": 0}),
        ("dinov2_custom", {"enc_embed_dim": 64, "enc_depth": 3, "enc_num_heads": 4, "patch_size": 7, "img_size": 70}),
    ],
)
def test_encoder_factory_matches_jax(name, kwargs):
    """Presets, aliases and bookkeeping keys resolve to the same architecture
    in both factories (the port's module on the meta device: no memory)."""
    from ufm_tpu.nn.encoders import feature_returner_encoder_factory as jax_factory
    from ufm_torch.nn.encoders import feature_returner_encoder_factory

    jenc = jax_factory(name, **kwargs)
    with torch.device("meta"):
        enc = feature_returner_encoder_factory(name, **kwargs)
    assert (len(enc.blocks), enc.embed_dim, enc.patch_size) == (jenc.depth, jenc.embed_dim, jenc.patch_size)
    assert enc.blocks[0].attn.num_heads == jenc.num_heads
    assert enc.pos_embed.shape[1] == jenc.pretrain_grid_size**2
    ls = enc.blocks[0].ls1
    assert (ls.init_value if hasattr(ls, "init_value") else None) == jenc.layerscale_init
