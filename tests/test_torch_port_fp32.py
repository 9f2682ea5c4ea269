"""The port's fp32 path and its attention domain, held to the JAX package.

- **The fp32 anchor golden** ``tests/golden/torch_port_fp32_anchor.npz`` lets
  the card, which has no JAX, run the repository's two anchored tiny fp32
  forwards (``ufm_tpu/utils/anchor.py::anchor_configs()``: UFM-Base and
  UFM-Refine on the window kernel, head dims 32 in the encoder and 24 in info
  sharing) and hold them to the committed CPU goldens
  ``tests/golden/ufm_base_tiny.npz`` / ``ufm_refine_tiny_pallas.npz``. It
  holds ``config/<name>`` (each anchor's JAX config as JSON) and
  ``params/<a/b/c>``: the flattened fp32 parameters of
  ``UFMNet.init(PRNGKey(7))`` on ``seeded_inputs()``. The refine model's
  parameters are the base model's plus its classification head (flax draws
  each module's parameters from its own path), so one set serves both. The
  inputs are not stored: ``anchor_inputs()`` rebuilds them with
  ``seeded_inputs()``'s numpy generator. Here: the golden against a fresh
  JAX init, bitwise; the port's plain path from the golden alone against
  both CPU goldens at the port's bar of 1e-4.
- **Attention over the TPU kernel's domain**: the port's plain attention
  (the CPU implementation of ``ufm_torch::flash_attention_fwd`` and the
  reference the card's kernels are held to) against the JAX package's
  ``flash_attention`` in interpret mode, fp32, bf16 and fp16, at head dims
  24, 32, 64, 80 and 128 and ragged lengths.
- **The routing** of a CUDA call between the two forward kernels (by dtype
  and head dim alone) and the ops' fake domain, on fake CUDA tensors.

Regenerate the golden (after an intended change of the anchors) with
``python tests/test_torch_port_fp32.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ufm_tpu.utils.anchor import anchor_configs, seeded_inputs
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UFMArchConfig, UFMNet
from ufm_torch.ops import flash_attention as fa
from ufm_torch.ops import library

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_fp32_anchor.npz")
ANCHORS = ("ufm_base_tiny", "ufm_refine_tiny_pallas")
ATOL = 1e-4  # the port's CPU bar against the anchors (tests/test_torch_port_model.py)
ANCHOR_SEED, ANCHOR_SHAPE = 20260817, (2, 42, 56, 3)  # seeded_inputs()'s generator

# plain attention against the JAX kernel in interpret mode: fp32 sums in
# another order; in bf16 and fp16 the plain version rounds its logits to the
# input dtype (the JAX package's _xla_attention math) where the kernel keeps
# them fp32, two ulps of the type at |x| in [1, 2)
ATTN_ATOL = {"float32": 1e-5, "bfloat16": 2.0**-6, "float16": 2.0**-9}
ATTN_HEAD_DIMS = (24, 32, 64, 80, 128)
ATTN_LENGTHS = ((77, 77), (130, 130), (65, 200))


def anchor_inputs():
    """``seeded_inputs()`` in numpy alone (what the card rebuilds)."""
    rng = np.random.default_rng(ANCHOR_SEED)
    return tuple(rng.standard_normal(ANCHOR_SHAPE).astype(np.float32) for _ in range(2))


def fresh_golden():
    """(configs by anchor, flat fp32 params) computed now by the JAX package."""
    i1, i2 = seeded_inputs()
    configs, params = {}, {}
    for name, cfg in anchor_configs().items():
        configs[name] = json.loads(json.dumps(cfg.to_dict()))
        flat = flatten_params(jax.jit(JNet(cfg).init)(jax.random.PRNGKey(7), i1, i2)["params"])
        for k, v in flat.items():
            v = np.asarray(v, np.float32)
            assert k not in params or np.array_equal(params[k], v), k  # shared modules, shared values
            params[k] = v
    return configs, params


def write_golden() -> str:
    configs, params = fresh_golden()
    np.savez_compressed(
        GOLDEN,
        **{f"config/{n}": np.array(json.dumps(c)) for n, c in configs.items()},
        **{f"params/{k}": v for k, v in params.items()},
    )
    return GOLDEN


def load_golden():
    with np.load(GOLDEN) as z:
        files = {k: z[k] for k in z.files}
    configs = {k[len("config/"):]: json.loads(str(v)) for k, v in files.items() if k.startswith("config/")}
    params = {k[len("params/"):]: v for k, v in files.items() if k.startswith("params/")}
    return configs, params


def test_golden_equals_a_fresh_jax_init():
    configs, params = fresh_golden()
    g_configs, g_params = load_golden()
    assert g_configs == configs and set(g_configs) == set(ANCHORS)
    assert set(g_params) == set(params)
    for k in params:
        assert g_params[k].dtype == np.float32
        np.testing.assert_array_equal(g_params[k], params[k], err_msg=k)
    for name, cfg in g_configs.items():
        assert cfg["compute_dtype"] == "float32", name
        assert cfg["encoder_kwargs"]["embed_dim"] // cfg["encoder_kwargs"]["num_heads"] == 32
        assert cfg["info_sharing_kwargs"]["dim"] // cfg["info_sharing_kwargs"]["num_heads"] == 24
    assert os.path.getsize(GOLDEN) < 2 * 2**20


def test_numpy_inputs_are_the_anchor_inputs():
    for got, want in zip(anchor_inputs(), seeded_inputs()):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", ANCHORS)
def test_port_from_the_golden_holds_the_cpu_anchor(name):
    """The port's plain path, built from the golden alone as the card builds
    it, against the committed CPU golden of the anchor, every key at 1e-4."""
    configs, params = load_golden()
    net = UFMNet(UFMArchConfig.from_dict(configs[name]))
    load_jax_params(net, {k: v for k, v in params.items() if net.cfg.has_classification_head
                          or not k.startswith("classification")})
    net.refinement_impl = None  # the device picks: the plain window on the CPU, the kernel on the card
    i1, i2 = anchor_inputs()
    with torch.no_grad():
        out = net(torch.from_numpy(i1), torch.from_numpy(i2))
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    assert set(golden.files) <= set(out)
    for k in golden.files:
        np.testing.assert_allclose(out[k].numpy(), golden[k], atol=ATOL, rtol=0, err_msg=f"{name}:{k}")


@pytest.mark.parametrize("sq, sk", ATTN_LENGTHS)
@pytest.mark.parametrize("d", ATTN_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_plain_attention_matches_the_jax_kernel(dtype, d, sq, sk):
    rng = np.random.default_rng(d * 1000 + sq)
    q = rng.standard_normal((1, sq, 2, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, 2, d)).astype(np.float32) for _ in range(2))
    want = jax_flash_attention(*(jnp.asarray(x, dtype=dtype) for x in (q, k, v)), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tt = getattr(torch, dtype)
    got = fa.attention_reference(*(torch.from_numpy(x).to(tt) for x in (q, k, v)), d**-0.5)
    assert got.dtype == tt and got.shape == (1, sq, 2, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATTN_ATOL[dtype], rtol=0)


# ---- routing and the fake domain -----------------------------------------------


@pytest.mark.parametrize("dtype, d, kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.float32, 64, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.float32, 24, "mma"), (torch.float32, 1, "mma"), (torch.bfloat16, 256, "mma"), (torch.float32, 80, "mma"),
    (torch.float16, 64, "mma"), (torch.float16, 24, "mma"),
])
def test_forward_kernel_by_dtype_and_head_dim(dtype, d, kernel):
    assert fa.forward_kernel(dtype, d) == kernel


@pytest.mark.parametrize("dtype, d", [(torch.float64, 64), (torch.float16, 257), (torch.float32, 257),
                                      (torch.bfloat16, 0), (torch.float64, 32)])
def test_forward_kernel_refuses_outside_the_domain(dtype, d):
    with pytest.raises(ValueError, match=f"got {dtype} with D = {d}"):
        fa.forward_kernel(dtype, d)


@pytest.mark.parametrize("dtype, d", [(torch.float32, 24), (torch.float32, 32), (torch.float32, 64),
                                      (torch.bfloat16, 32), (torch.bfloat16, 64), (torch.bfloat16, 256),
                                      (torch.float16, 64), (torch.float16, 40)])
def test_fake_forward_on_the_card_takes_the_domain(dtype, d):
    with FakeTensorMode():
        q = torch.empty(2, 13, 3, d, device="cuda", dtype=dtype)
        k = torch.empty(2, 40, 3, d, device="cuda", dtype=dtype)
        out, lse = library.flash_attention_fwd(q, k, k, 0.125, True)
        assert (out.shape, out.dtype, out.device.type) == (q.shape, dtype, "cuda")
        assert (lse.shape, lse.dtype) == ((2, 3, 13), torch.float32)


def test_fake_ops_refuse_outside_the_domain():
    with FakeTensorMode():
        wide_type = torch.empty(1, 8, 2, 64, device="cuda", dtype=torch.float64)
        with pytest.raises(ValueError, match="float64 with D = 64"):
            library.flash_attention_fwd(wide_type, wide_type, wide_type, 0.125, False)
        wide = torch.empty(1, 8, 2, 320, device="cuda")
        with pytest.raises(ValueError, match="D = 320"):
            library.flash_attention_fwd(wide, wide, wide, 0.125, False)
        x = torch.empty(1, 8, 2, 32, device="cuda")
        with pytest.raises(ValueError, match="share a dtype"):
            library.flash_attention_fwd(x, x.to(torch.bfloat16), x, 0.125, False)
        lse = torch.empty(1, 2, 8, device="cuda")
        with pytest.raises(ValueError, match="float64 with D = 64"):  # the backward's domain: the forward's
            library.flash_attention_bwd(wide_type, wide_type, wide_type, wide_type, lse, wide_type, 0.125)
        with pytest.raises(ValueError, match="D = 320"):
            library.flash_attention_bwd(wide, wide, wide, wide, lse, wide, 0.125)
        cpu = torch.empty(1, 8, 2, 20, dtype=torch.float16)  # the CPU takes any dtype and D
        assert library.flash_attention_fwd(cpu, cpu, cpu, 0.125, False)[0].shape == cpu.shape


def test_backward_refuses_fp32_naming_dtype_and_head_dim():
    """The backward's CUDA implementation refuses what lies outside the TPU
    kernel's domain (fp32 is inside it now: float64, and fp32 at D = 257),
    naming the dtype and D, before it touches the card."""
    x = torch.zeros(1, 8, 2, 24, dtype=torch.float64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="float64 with D = 24"):
        fa.launch_backward(x, x, x, x, lse, x, 0.2)
    y = torch.zeros(1, 8, 2, 257)
    with pytest.raises(ValueError, match="float32 with D = 257"):
        fa.launch_backward(y, y, y, y, lse, y, 0.2)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    path = write_golden()
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
