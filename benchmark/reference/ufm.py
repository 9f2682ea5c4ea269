"""UFM in plain PyTorch: the benchmark's frozen reference.

The forward of UFM-Base (``UniFlowMatchConfidence``) and UFM-Refine
(``UniFlowMatchClassificationRefinement``) as the published architecture
defines it, written from the equations and computed in float32 with TF32
off: a DINOv2 ViT encoder over both views, the two-view global-attention
transformer, two DPT heads with their output adaptors, and for UFM-Refine
the patch-MLP classification head, the UNet fine features and the P x P
window refinement. Around it, the predict pipeline: ImageNet normalisation,
an antialiased bilinear resize to the model resolution, and the unmap of
each output to the input resolution.

It works on a flat dict of parameters named as the system under test names
them (``encoder.blocks.0.attn.qkv.weight``, ...), so one set of weights,
made by the benchmark from its seed, loads into both. It imports nothing of
the system under test: no module, no kernel, no table, no helper.

``Numerics`` says how products are computed: float32 everywhere (the
reference), or one precision step below what the configuration states (the
control that the comparison must fail: fp8 e4m3 with per-tensor scales for
the bf16 backbone, bf16 for the fp32 heads).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Numerics", "FP32", "CONTROL", "Arch", "param_specs", "forward", "predict", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6

# public DINOv2 encoder sizes by name, each with the GELU MLP this module writes
_DINOV2 = {
    "dinov2_small": dict(embed_dim=384, depth=12, num_heads=6),
    "dinov2_base": dict(embed_dim=768, depth=12, num_heads=12),
    "dinov2_large": dict(embed_dim=1024, depth=24, num_heads=16),
}
# published names whose model this module does not write
_NOT_WRITTEN = {
    "dinov2_giant": "the published DINOv2 ViT-g/14 has a SwiGLU FFN (w12 1536 -> 2 x 4096, silu(x1) * x2, "
                    "w3 4096 -> 1536), which this module does not write: it writes the GELU MLP",
}
# bookkeeping keys of a UniCeption-style config that build nothing (the system's encoder factory ignores the
# same); a copy, since the reference imports nothing of the system
_BOOKKEEPING = {"name", "size", "uses_torch_hub", "torch_hub_force_reload", "pretrained_checkpoint_path",
                "gradient_checkpointing", "device"}
# options this module writes at one value only, by group: key -> that value
_FIXED = {
    "encoder_kwargs": dict(num_register_tokens=0, use_cls_token=True, qkv_bias=True, norm_intermediate=True,
                           data_norm_type="dinov2", mlp_act="gelu_exact", ffn_layer="mlp"),
    "info_sharing_kwargs": dict(num_register_tokens=0, qkv_bias=True, norm_intermediate=True, use_pos_embed=True,
                                num_views=2, layerscale_init=None, mlp_act="gelu_exact", ffn_layer="mlp"),
}
_READ = {
    "encoder_kwargs": {"embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio", "pretrain_grid_size",
                       "layerscale_init", "intermediate_layer_idx"},
    "info_sharing_kwargs": {"input_embed_dim", "dim", "depth", "num_heads", "mlp_ratio", "intermediate_layer_idx"},
}


# ---------------------------------------------------------------- numerics
def _rounded(t: torch.Tensor, mode: str, fp8: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    if mode == "bf16":
        return t.to(torch.bfloat16).float()
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(fp8).max  # one scale a tensor
    return (t / scale).to(fp8).float() * scale


class _Round(torch.autograd.Function):
    """An operand rounded to a lower precision; its gradient rounded the
    same way on the way back (fp8: e5m2, as fp8 training keeps gradients)."""

    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return _rounded(t, mode)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, ctx.mode, torch.float8_e5m2), None


class Numerics:
    """How the products of each part are computed. ``backbone`` and ``heads``
    are each "fp32", "bf16" or "fp8" (e4m3 operands, one scale a tensor,
    products accumulated in fp32; in a backward the gradients reaching the
    products in e5m2)."""

    def __init__(self, backbone: str = "fp32", heads: str = "fp32"):
        self.backbone, self.heads = backbone, heads

    def _round(self, t: torch.Tensor, part: str) -> torch.Tensor:
        mode = self.backbone if part == "backbone" else self.heads
        if mode == "fp32":
            return t
        if mode not in ("bf16", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        return _Round.apply(t, mode)

    def linear(self, x, w, b, part):
        y = F.linear(self._round(x, part), self._round(w, part))
        return y if b is None else y + b

    def matmul(self, a, b, part):
        return torch.matmul(self._round(a, part), self._round(b, part))

    def conv(self, x, w, b, part, stride=1, padding=0):
        return F.conv2d(self._round(x, part), self._round(w, part), b, stride=stride, padding=padding)

    def conv_t(self, x, w, b, part, stride):
        return F.conv_transpose2d(self._round(x, part), self._round(w, part), b, stride=stride)


FP32 = Numerics()
CONTROL = Numerics(backbone="fp8", heads="bf16")


# ------------------------------------------------------------ architecture
class Arch:
    """The sizes of one configuration, read from its config dict (the
    constructor keywords of the published model classes)."""

    def __init__(self, cfg: dict):
        enc_kw = _modelled(cfg, "encoder_kwargs")
        if cfg["encoder_str"] in _NOT_WRITTEN:
            raise ValueError(f"encoder_str {cfg['encoder_str']!r}: {_NOT_WRITTEN[cfg['encoder_str']]}")
        enc = dict(patch_size=14, mlp_ratio=4.0, layerscale=1e-5, pretrain_grid=37, cls=True)
        enc.update(_DINOV2.get(cfg["encoder_str"], {}))
        for k in ("embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio"):
            if k in enc_kw:
                enc[k] = enc_kw[k]
        if "pretrain_grid_size" in enc_kw:
            enc["pretrain_grid"] = enc_kw["pretrain_grid_size"]
        if "layerscale_init" in enc_kw:
            enc["layerscale"] = enc_kw["layerscale_init"]
        missing = [k for k in ("embed_dim", "depth", "num_heads") if k not in enc]
        if missing:
            raise ValueError(f"encoder_str {cfg['encoder_str']!r} is no preset here and encoder_kwargs lacks {missing}")
        enc["taps"] = tuple(int(t) % enc["depth"] for t in enc_kw.get("intermediate_layer_idx", (enc["depth"] - 1,)))
        self.enc = enc
        info_kw = _modelled(cfg, "info_sharing_kwargs")
        self.info = dict(
            in_dim=info_kw.get("input_embed_dim", 1024), dim=info_kw.get("dim", 768), depth=info_kw.get("depth", 12),
            num_heads=info_kw.get("num_heads", 12), mlp_ratio=info_kw.get("mlp_ratio", 4.0),
        )
        self.info["taps"] = tuple(int(t) % self.info["depth"] for t in info_kw.get("intermediate_layer_idx", (5, 8)))
        self.head1 = cfg["feature_head_kwargs"]
        self.adaptors1 = list(cfg["adaptors_kwargs"].items())
        self.uncertainty = cfg.get("uncertainty_head_kwargs") if cfg.get("has_uncertainty_head") else None
        self.adaptors_unc = list(cfg.get("uncertainty_adaptors_kwargs", {}).items())
        self.refine = bool(cfg.get("has_classification_head"))
        self.cls_head = cfg.get("classification_head_kwargs", {})
        self.unet = cfg.get("use_unet_feature", False)
        unet_kw = cfg.get("unet_kwargs") or {}
        self.unet_features = tuple(unet_kw.get("features", (64, 128, 256, 512)))
        self.unet_out = unet_kw.get("out_channels", 16)
        self.patch = int(cfg.get("refinement_range", 5))
        self.temperature = float(cfg.get("temperature", 4.0))
        res = cfg["inference_resolution"]
        w, h = res[0] if isinstance(res[0], (list, tuple)) else res
        self.model_hw = (int(h), int(w))
        self.compute_dtype = cfg.get("compute_dtype", "bfloat16")
        if cfg.get("info_sharing_and_head_structure", "dual+single") != "dual+single":
            raise ValueError("only the dual+single structure exists")
        if self.refine and cfg.get("feature_combine_method", "conv") != "conv":
            raise ValueError("only the conv feature combination is written here")

    def encoder_tokens(self, hp: int, wp: int) -> int:
        """The encoder's tokens for an image of ``hp x wp`` patches."""
        return hp * wp + int(self.enc["cls"])


def _modelled(cfg: dict, group: str) -> dict:
    """``cfg[group]``, refusing a key that this module does not model: one it
    does not read, or an option at another value than the one it writes."""
    kw = dict(cfg.get(group) or {})
    for k, v in kw.items():
        if k in _FIXED[group]:
            if v != _FIXED[group][k]:
                raise ValueError(f"{group} {k}={v!r}: this module writes only {k}={_FIXED[group][k]!r}")
        elif k not in _READ[group] and k not in _BOOKKEEPING:
            raise ValueError(f"{group} key {k!r} is not modelled here")
    return kw


def _block_specs(prefix: str, dim: int, mlp_ratio: float, layerscale: bool) -> Dict[str, tuple]:
    hidden = int(dim * mlp_ratio)
    s = {
        f"{prefix}.norm1.weight": (dim,), f"{prefix}.norm1.bias": (dim,),
        f"{prefix}.attn.qkv.weight": (3 * dim, dim), f"{prefix}.attn.qkv.bias": (3 * dim,),
        f"{prefix}.attn.proj.weight": (dim, dim), f"{prefix}.attn.proj.bias": (dim,),
        f"{prefix}.norm2.weight": (dim,), f"{prefix}.norm2.bias": (dim,),
        f"{prefix}.mlp.fc1.weight": (hidden, dim), f"{prefix}.mlp.fc1.bias": (hidden,),
        f"{prefix}.mlp.fc2.weight": (dim, hidden), f"{prefix}.mlp.fc2.bias": (dim,),
    }
    if layerscale:
        s[f"{prefix}.ls1.gamma"] = (dim,)
        s[f"{prefix}.ls2.gamma"] = (dim,)
    return s


def _conv(s, name, cin, cout, k, bias=True):
    s[f"{name}.weight"] = (cout, cin, k, k)
    if bias:
        s[f"{name}.bias"] = (cout,)


def _dpt_specs(prefix: str, kw: dict) -> Dict[str, tuple]:
    feat, proc = kw["dpt_feature"], kw["dpt_processor"]
    ins, projs, fd = feat["input_dims"], feat["proj_dims"], feat["feature_dim"]
    s: Dict[str, tuple] = {}
    for i, (d, p) in enumerate(zip(ins, projs)):
        _conv(s, f"{prefix}.feature.proj_{i}", d, p, 1)
        _conv(s, f"{prefix}.feature.scratch_{i}", p, fd, 3, bias=False)
    s[f"{prefix}.feature.resize_0.weight"] = (projs[0], projs[0], 4, 4)  # transposed: (in, out, k, k)
    s[f"{prefix}.feature.resize_0.bias"] = (projs[0],)
    s[f"{prefix}.feature.resize_1.weight"] = (projs[1], projs[1], 2, 2)
    s[f"{prefix}.feature.resize_1.bias"] = (projs[1],)
    _conv(s, f"{prefix}.feature.resize_3", projs[3], projs[3], 3)
    for i in range(4):
        units = ("rcu_skip", "rcu") if i != 3 else ("rcu",)
        for u in units:
            _conv(s, f"{prefix}.feature.fusion_{i}.{u}.conv1", fd, fd, 3)
            _conv(s, f"{prefix}.feature.fusion_{i}.{u}.conv2", fd, fd, 3)
        _conv(s, f"{prefix}.feature.fusion_{i}.project", fd, fd, 1)
    h0, h1 = proc["hidden_dims"]
    _conv(s, f"{prefix}.processor.conv1", proc["input_dim"], h0, 3)
    _conv(s, f"{prefix}.processor.conv2", h0, h1, 3)
    _conv(s, f"{prefix}.processor.conv3", h1, proc["output_dim"], 1)
    return s


def param_specs(arch: Arch) -> Dict[str, Tuple[tuple, str]]:
    """Every parameter: name -> (shape, part), where part is "backbone" (held
    in the configuration's compute dtype) or "heads" (held in fp32)."""
    e, i = arch.enc, arch.info
    d = e["embed_dim"]
    bb: Dict[str, tuple] = {
        "encoder.patch_embed.weight": (d, 3, e["patch_size"], e["patch_size"]), "encoder.patch_embed.bias": (d,),
        "encoder.pos_embed": (1, e["pretrain_grid"] ** 2, d),
    }
    if e["cls"]:
        bb["encoder.cls_token"] = (1, 1, d)
        bb["encoder.cls_pos_embed"] = (1, 1, d)
    for n in range(e["depth"]):
        bb.update(_block_specs(f"encoder.blocks.{n}", d, e["mlp_ratio"], e["layerscale"] is not None))
    bb["encoder.norm.weight"] = (d,)
    bb["encoder.norm.bias"] = (d,)
    if i["in_dim"] != i["dim"]:
        bb["info_sharing.input_proj.weight"] = (i["dim"], i["in_dim"])
        bb["info_sharing.input_proj.bias"] = (i["dim"],)
    bb["info_sharing.view_embed"] = (2, i["dim"])
    for n in range(i["depth"]):
        bb.update(_block_specs(f"info_sharing.blocks.{n}", i["dim"], i["mlp_ratio"], False))
    bb["info_sharing.norm.weight"] = (i["dim"],)
    bb["info_sharing.norm.bias"] = (i["dim"],)
    heads = _dpt_specs("head1", arch.head1)
    if arch.uncertainty is not None:
        heads.update(_dpt_specs("uncertainty_head", arch.uncertainty))
    if arch.refine:
        ch = arch.cls_head
        dims = [ch["input_feature_dim"], *ch["hidden_dims"]]
        for n in range(len(ch["hidden_dims"])):
            heads[f"classification_head.fc{n}.weight"] = (dims[n + 1], dims[n])
            heads[f"classification_head.fc{n}.bias"] = (dims[n + 1],)
        out = ch["patch_size"] ** 2 * ch["output_dim"]
        heads["classification_head.fc_out.weight"] = (out, dims[-1])
        heads["classification_head.fc_out.bias"] = (out,)
        heads["classification_bias"] = (arch.patch ** 2,)
        if arch.unet:
            c = 3
            for n, f in enumerate(arch.unet_features):
                _conv(bb, f"unet_feature.down_{n}.conv1", c, f, 3)
                _conv(bb, f"unet_feature.down_{n}.conv2", f, f, 3)
                c = f
            _conv(bb, "unet_feature.bottleneck.conv1", c, 2 * c, 3)
            _conv(bb, "unet_feature.bottleneck.conv2", 2 * c, 2 * c, 3)
            c *= 2
            for n, f in enumerate(reversed(arch.unet_features)):
                bb[f"unet_feature.up_{n}.weight"] = (c, f, 2, 2)
                bb[f"unet_feature.up_{n}.bias"] = (f,)
                _conv(bb, f"unet_feature.up_conv_{n}.conv1", 2 * f, f, 3)
                _conv(bb, f"unet_feature.up_conv_{n}.conv2", f, f, 3)
                c = f
            _conv(bb, "unet_feature.final", c, arch.unet_out, 1)
            o = ch["output_dim"]
            _conv(heads, "conv1", o + arch.unet_out, 2 * o, 1)
            _conv(heads, "conv2", 2 * o, o, 1)
    specs = {k: (v, "backbone") for k, v in bb.items()}
    specs.update({k: (v, "heads") for k, v in heads.items()})
    return specs


# ------------------------------------------------------------ small pieces
def _layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps=LN_EPS)


def _attention(x, P, name, heads, nm: Numerics):
    b, s, c = x.shape
    qkv = nm.linear(x, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"], "backbone")
    q, k, v = qkv.reshape(b, s, 3, heads, c // heads).permute(2, 0, 3, 1, 4)  # (B, H, S, D) each
    logits = nm.matmul(q, k.transpose(-1, -2), "backbone") * (c // heads) ** -0.5
    out = nm.matmul(torch.softmax(logits, dim=-1), v, "backbone")
    return nm.linear(out.transpose(1, 2).reshape(b, s, c), P[f"{name}.proj.weight"], P[f"{name}.proj.bias"], "backbone")


def _block(x, P, name, heads, nm: Numerics, layerscale: bool):
    a = _attention(_layer_norm(x, P, f"{name}.norm1"), P, f"{name}.attn", heads, nm)
    x = x + (a * P[f"{name}.ls1.gamma"] if layerscale else a)
    h = _layer_norm(x, P, f"{name}.norm2")
    h = F.gelu(nm.linear(h, P[f"{name}.mlp.fc1.weight"], P[f"{name}.mlp.fc1.bias"], "backbone"), approximate="none")
    m = nm.linear(h, P[f"{name}.mlp.fc2.weight"], P[f"{name}.mlp.fc2.bias"], "backbone")
    return x + (m * P[f"{name}.ls2.gamma"] if layerscale else m)


def _keys_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of an antialiased cubic resize with the Keys
    kernel (a = -0.5), half-pixel centres, the kernel widened by the
    downscale factor, each output's weights summing to one, and outputs whose
    centre lies outside the input given no weight: the pos-embed resize of
    the published model."""
    if n_in == n_out:
        return np.eye(n_in)
    scale = n_in / n_out
    widen = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale - 0.5
    t = np.abs(centre[:, None] - np.arange(n_in)[None, :]) / widen
    w = np.where(t < 1, (1.5 * t - 2.5) * t * t + 1, np.where(t < 2, ((-0.5 * t + 2.5) * t - 4) * t + 2, 0.0))
    w = w / w.sum(axis=1, keepdims=True)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def _pos_embed(P, grid: int, hp: int, wp: int) -> torch.Tensor:
    pe = P["encoder.pos_embed"].reshape(grid, grid, -1)
    if (hp, wp) != (grid, grid):
        mh = torch.from_numpy(_keys_cubic_matrix(grid, hp)).to(pe)
        mw = torch.from_numpy(_keys_cubic_matrix(grid, wp)).to(pe)
        pe = torch.einsum("oh,hwc->owc", mh, pe)
        pe = torch.einsum("ow,hwc->hoc", mw, pe)
    return pe.reshape(1, hp * wp, -1)


def _sincos_2d(h: int, w: int, dim: int, device) -> torch.Tensor:
    """(h*w, dim): [sin(y w_k), cos(y w_k), sin(x w_k), cos(x w_k)] with
    w_k = 10000^(-k / (dim/4)), k < dim/4, row-major over (y, x)."""
    quarter = dim // 4
    omega = 10000.0 ** (-torch.arange(quarter, dtype=torch.float64) / quarter)
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float64), torch.arange(w, dtype=torch.float64), indexing="ij")
    parts = []
    for g in (y.reshape(-1), x.reshape(-1)):
        ang = g[:, None] * omega[None, :]
        parts += [torch.sin(ang), torch.cos(ang)]
    return torch.cat(parts, dim=1).float().to(device)


def _up_aligned(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear", align_corners=True)


# ----------------------------------------------------------------- stages
def encode(P, arch: Arch, images: torch.Tensor, nm: Numerics) -> List[torch.Tensor]:
    """(N, H, W, 3) normalised -> the tapped levels, each (N, Hp, Wp, C)."""
    e = arch.enc
    n, h, w, _ = images.shape
    ps = e["patch_size"]
    hp, wp = h // ps, w // ps
    x = nm.conv(images.permute(0, 3, 1, 2), P["encoder.patch_embed.weight"], P["encoder.patch_embed.bias"],
                "backbone", stride=ps)
    x = x.flatten(2).transpose(1, 2) + _pos_embed(P, e["pretrain_grid"], hp, wp)
    if e["cls"]:
        cls = (P["encoder.cls_token"] + P["encoder.cls_pos_embed"]).expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1)
    taps = {}
    for i in range(e["depth"]):
        x = _block(x, P, f"encoder.blocks.{i}", e["num_heads"], nm, e["layerscale"] is not None)
        if i in e["taps"]:
            taps[i] = x
    out = []
    for t in e["taps"]:
        f = _layer_norm(taps[t], P, "encoder.norm")
        out.append((f[:, 1:] if e["cls"] else f).reshape(n, hp, wp, -1))
    return out


def share(P, arch: Arch, f0: torch.Tensor, f1: torch.Tensor, nm: Numerics):
    """Two views' last encoder maps -> (final, [tap_a, tap_b]), each a pair of
    (B, Hp, Wp, dim) maps, all normed."""
    i = arch.info
    b, hp, wp, c = f0.shape
    s = hp * wp
    tokens = torch.stack([f0.reshape(b, s, c), f1.reshape(b, s, c)], dim=1)
    if "info_sharing.input_proj.weight" in P:
        tokens = nm.linear(tokens, P["info_sharing.input_proj.weight"], P["info_sharing.input_proj.bias"], "backbone")
    tokens = tokens + P["info_sharing.view_embed"][None, :, None, :]
    tokens = tokens + _sincos_2d(hp, wp, i["dim"], tokens.device)[None, None]
    x = tokens.reshape(b, 2 * s, i["dim"])
    taps = {}
    for n in range(i["depth"]):
        x = _block(x, P, f"info_sharing.blocks.{n}", i["num_heads"], nm, False)
        if n in i["taps"]:
            taps[n] = x

    def views(y):
        y = _layer_norm(y, P, "info_sharing.norm").reshape(b, 2, hp, wp, i["dim"])
        return y[:, 0], y[:, 1]

    return views(x), [views(taps[t]) for t in i["taps"]]


def _rcu(x, P, name, nm):
    y = nm.conv(F.relu(x), P[f"{name}.conv1.weight"], P[f"{name}.conv1.bias"], "heads", padding=1)
    return x + nm.conv(F.relu(y), P[f"{name}.conv2.weight"], P[f"{name}.conv2.bias"], "heads", padding=1)


def dpt(P, prefix: str, levels: Sequence[torch.Tensor], out_hw, nm: Numerics) -> torch.Tensor:
    """Four (B, Hp, Wp, C) levels -> (B, H, W, output_dim)."""
    ft = f"{prefix}.feature"
    lv = []
    for i, f in enumerate(levels):
        x = nm.conv(f.permute(0, 3, 1, 2), P[f"{ft}.proj_{i}.weight"], P[f"{ft}.proj_{i}.bias"], "heads")
        if i == 0:
            x = nm.conv_t(x, P[f"{ft}.resize_0.weight"], P[f"{ft}.resize_0.bias"], "heads", stride=4)
        elif i == 1:
            x = nm.conv_t(x, P[f"{ft}.resize_1.weight"], P[f"{ft}.resize_1.bias"], "heads", stride=2)
        elif i == 3:
            x = nm.conv(x, P[f"{ft}.resize_3.weight"], P[f"{ft}.resize_3.bias"], "heads", stride=2, padding=1)
        lv.append(nm.conv(x, P[f"{ft}.scratch_{i}.weight"], None, "heads", padding=1))
    x = None
    for i in (3, 2, 1, 0):
        name = f"{ft}.fusion_{i}"
        if x is None:
            x = lv[i]
        else:
            if x.shape[-2:] != lv[i].shape[-2:]:
                x = _up_aligned(x, lv[i].shape[-2:])
            x = x + _rcu(lv[i], P, f"{name}.rcu_skip", nm)
        x = _rcu(x, P, f"{name}.rcu", nm)
        x = _up_aligned(x, (2 * x.shape[-2], 2 * x.shape[-1]))
        x = nm.conv(x, P[f"{name}.project.weight"], P[f"{name}.project.bias"], "heads")
    pr = f"{prefix}.processor"
    x = nm.conv(x, P[f"{pr}.conv1.weight"], P[f"{pr}.conv1.bias"], "heads", padding=1)
    x = _up_aligned(x, out_hw)
    x = F.relu(nm.conv(x, P[f"{pr}.conv2.weight"], P[f"{pr}.conv2.bias"], "heads", padding=1))
    return nm.conv(x, P[f"{pr}.conv3.weight"], P[f"{pr}.conv3.bias"], "heads").permute(0, 2, 3, 1)


_CHANNELS = {"FlowAdaptor": 2, "FlowWithConfidenceAdaptor": 3, "MaskAdaptor": 1, "ConfidenceAdaptor": 1,
             "Covariance2DAdaptor": 3}


def adapt(value: torch.Tensor, adaptors) -> Dict[str, torch.Tensor]:
    """Split a head's channels among its adaptors, in order."""
    out, o = {}, 0
    for name, spec in adaptors:
        kind = spec["class"]
        x = value[..., o:o + _CHANNELS[kind]]
        o += _CHANNELS[kind]
        if kind == "FlowAdaptor":
            out["flow"] = x
        elif kind == "MaskAdaptor":
            out["covis_logits"] = x[..., 0]
            out["covis_mask"] = torch.sigmoid(x[..., 0])
        elif kind == "ConfidenceAdaptor":
            out["keypoint_confidence"] = torch.sigmoid(x[..., 0])
        elif kind == "Covariance2DAdaptor":
            a, b = x[..., 0].clamp(-10, 10), x[..., 1].clamp(-10, 10)
            rho = torch.tanh(x[..., 2]) * 0.999
            vx, vy, cxy = torch.exp(a), torch.exp(b), rho * torch.exp(0.5 * (a + b))
            det = vx * vy * (1 - rho * rho)
            out["flow_cov"] = torch.stack([vx, vy, cxy], dim=-1)
            out["flow_cov_inv"] = torch.stack([vy / det, vx / det, -cxy / det], dim=-1)
            out["flow_cov_log_det"] = a + b + torch.log(1 - rho * rho)
        else:
            raise ValueError(f"adaptor {kind} is not written here")
    return out


def unet(P, arch: Arch, images: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H, W, out) fine features."""
    def double(x, name):
        x = F.relu(nm.conv(x, P[f"{name}.conv1.weight"], P[f"{name}.conv1.bias"], "backbone", padding=1))
        return F.relu(nm.conv(x, P[f"{name}.conv2.weight"], P[f"{name}.conv2.bias"], "backbone", padding=1))

    x = images.permute(0, 3, 1, 2)
    skips = []
    for n in range(len(arch.unet_features)):
        x = double(x, f"unet_feature.down_{n}")
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)
    x = double(x, "unet_feature.bottleneck")
    for n in range(len(arch.unet_features)):
        x = nm.conv_t(x, P[f"unet_feature.up_{n}.weight"], P[f"unet_feature.up_{n}.bias"], "backbone", stride=2)
        skip = skips[-(n + 1)]
        if x.shape[-2:] != skip.shape[-2:]:
            x = F.interpolate(x, size=skip.shape[-2:], mode="nearest")
        x = double(torch.cat([skip, x], dim=1), f"unet_feature.up_conv_{n}")
    x = nm.conv(x, P["unet_feature.final.weight"], P["unet_feature.final.bias"], "backbone")
    return x.permute(0, 2, 3, 1)


def window_refine(q, f, flow, bias, temperature: float, p: int):
    """Each pixel's P x P window of target features, sampled bicubically
    (zeros outside, align_corners=False) around flow + its own position at
    integer offsets, scored against its source feature: scores / T + bias,
    softmax over the window; the residual is the softmax-weighted offset.
    q, f (B, H, W, C); flow (B, H, W, 2) xy -> (residual (B, H, W, 2),
    log_softmax (B, H, W, P, P))."""
    b, h, w, c = f.shape
    r = (p - 1) // 2
    ys, xs = torch.meshgrid(torch.arange(h, device=f.device, dtype=torch.float32),
                            torch.arange(w, device=f.device, dtype=torch.float32), indexing="ij")
    pos = flow + torch.stack([xs, ys], dim=-1)[None]
    off = torch.arange(p, device=f.device, dtype=torch.float32) - r
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    offs = torch.stack([ox, oy], dim=-1).reshape(p * p, 2)  # window entry [i, j] = (j - r, i - r)
    pts = pos[:, :, :, None, :] + offs  # (B, H, W, P*P, 2)
    grid = (pts + 0.5) / torch.tensor([w, h], device=f.device, dtype=torch.float32) * 2 - 1
    win = F.grid_sample(f.permute(0, 3, 1, 2), grid.reshape(b, h, w * p * p, 2), mode="bicubic",
                        padding_mode="zeros", align_corners=False)  # (B, C, H, W*P*P)
    win = win.reshape(b, c, h, w, p * p)
    scores = torch.einsum("bhwc,bchwk->bhwk", q, win) / temperature + bias
    attn = torch.softmax(scores, dim=-1)
    return attn @ offs, torch.log_softmax(scores, dim=-1).reshape(b, h, w, p, p)


def forward(P: Dict[str, torch.Tensor], arch: Arch, img1: torch.Tensor, img2: torch.Tensor,
            nm: Numerics = FP32) -> Dict[str, torch.Tensor]:
    """The network on normalised (B, H, W, 3) views: a flat dict of (B, H, W,
    ...) outputs, named as the system's network names them."""
    b = img1.shape[0]
    levels = encode(P, arch, torch.cat([img1, img2], dim=0), nm)
    first, last = levels[0], levels[-1]
    (fin0, fin1), taps = share(P, arch, last[:b], last[b:], nm)
    pyr = [last[:b], taps[0][0], taps[1][0], fin0]
    hw = img1.shape[1:3]
    out = adapt(dpt(P, "head1", pyr, hw, nm), arch.adaptors1)
    if arch.uncertainty is not None:
        out.update(adapt(dpt(P, "uncertainty_head", [t.detach() for t in pyr], hw, nm), arch.adaptors_unc))
    if arch.refine:
        ch = arch.cls_head
        x = torch.cat([torch.cat([first[:b], fin0], dim=-1), torch.cat([first[b:], fin1], dim=-1)], dim=0)
        for n in range(len(ch["hidden_dims"])):
            x = F.gelu(nm.linear(x, P[f"classification_head.fc{n}.weight"], P[f"classification_head.fc{n}.bias"],
                                 "heads"), approximate="none")
        x = nm.linear(x, P["classification_head.fc_out.weight"], P["classification_head.fc_out.bias"], "heads")
        n2, hp, wp, _ = x.shape
        ps, oc = ch["patch_size"], ch["output_dim"]
        feat = x.reshape(n2, hp, wp, ps, ps, oc).permute(0, 1, 3, 2, 4, 5).reshape(n2, hp * ps, wp * ps, oc)
        if arch.unet:
            fine = unet(P, arch, torch.cat([img1, img2], dim=0), nm)
            y = torch.cat([feat, fine], dim=-1).permute(0, 3, 1, 2)
            y = F.relu(nm.conv(y, P["conv1.weight"], P["conv1.bias"], "heads"))
            feat = nm.conv(y, P["conv2.weight"], P["conv2.bias"], "heads").permute(0, 2, 3, 1)
        flow = out["flow"]
        residual, log_softmax = window_refine(feat[:b], feat[b:], flow, P["classification_bias"],
                                              arch.temperature, arch.patch)
        out.update(regression_flow=flow, flow=flow + residual, refinement_residual=residual,
                   refinement_log_softmax=log_softmax, refinement_feature_map_0=feat[:b],
                   refinement_feature_map_1=feat[b:])
    return out


# ------------------------------------------------------ predict pipeline
def normalise_resize(images_u8: torch.Tensor, hw) -> torch.Tensor:
    """(B, H0, W0, 3) uint8 -> (B, h, w, 3) ImageNet-normalised, resized
    bilinearly with antialiasing (half-pixel centres)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    x = (images_u8.float() / 255.0 - mean) / std
    x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1)


def _nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C), each output taking the input at
    floor(index * in / out)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="nearest").permute(0, 2, 3, 1)


def predict(P: Dict[str, torch.Tensor], arch: Arch, src_u8: torch.Tensor, tgt_u8: torch.Tensor,
            nm: Numerics = FP32, raw: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The predict pipeline for two (B, H0, W0, 3) uint8 batches of one size:
    the network at the model resolution, each output brought back to the
    input resolution (flow and its covariance rescaled per axis). Returns
    flow (B, 2, H0, W0), flow_covariance (B, 3, H0, W0), covisibility and
    keypoint_confidence (B, H0, W0), as present. ``raw``, when given, receives
    the network's own outputs."""
    h0, w0 = src_u8.shape[1:3]
    if tuple(tgt_u8.shape[1:3]) != (h0, w0):
        raise ValueError("both views of a pair have one size here")
    out = forward(P, arch, normalise_resize(src_u8, arch.model_hw), normalise_resize(tgt_u8, arch.model_hw), nm)
    if raw is not None:
        raw.update(out)
    h, w = arch.model_hw
    sx, sy = w0 / w, h0 / h
    res = {"flow": (_nearest(out["flow"], (h0, w0)) * torch.tensor([sx, sy], device=src_u8.device))
           .permute(0, 3, 1, 2)}
    if "flow_cov" in out:
        scale = torch.tensor([sx * sx, sy * sy, sx * sy], device=src_u8.device)
        res["flow_covariance"] = (_nearest(out["flow_cov"], (h0, w0)) * scale).permute(0, 3, 1, 2)
    if "covis_mask" in out:
        res["covisibility"] = _nearest(out["covis_mask"][..., None], (h0, w0))[..., 0]
    if "keypoint_confidence" in out:
        res["keypoint_confidence"] = _nearest(out["keypoint_confidence"][..., None], (h0, w0))[..., 0]
    return res
