"""UFM on DINOv2 ViT-g/14 with registers, in plain PyTorch: the frozen
reference of the configurations that name ``"reference": "ufm_vitg_reg"``.

UFM-Base's two-view global-attention transformer and its two DPT heads (the
pieces of :mod:`benchmark.reference.ufm`, imported, never edited) on the
encoder of ``dinov2_vitg14_reg`` (facebookresearch/dinov2 ``hubconf.py``:
``vit_giant2``, ``ffn_layer="swiglufused"``, ``num_register_tokens=4``;
arXiv:2304.07193, 2309.16588), written from the equations and computed in
float32 with TF32 off:

- patch embedding (stride-14 convolution), the learned position embedding
  resized to the patch grid, the class token with its own position
  embedding, then R register tokens with none;
- pre-norm blocks with LayerScale: qkv-biased attention, then DINOv2's
  ``SwiGLUFFNFused``: ``w12`` (C -> 2H, biased), ``x1, x2 = chunk(2)``,
  ``silu(x1) * x2``, ``w3`` (H -> C, biased), with H the MLP width's two
  thirds rounded up to a multiple of 8 (C = 1536: 4096);
- each tapped block's output normed by the final LayerNorm, the class token
  and the registers dropped.

Departures from ``dinov2_vitg14_reg``, each also in the configuration's
``assumed``:

- the position embedding is resized by the antialiased Keys cubic (a =
  -0.5, half-pixel centres) that the system and ``ufm`` share, where DINOv2's
  register models call ``F.interpolate(mode="bicubic", antialias=True)``
  (a = -0.75) with offset 0;
- the class token's position embedding is a parameter of its own
  (``encoder.cls_pos_embed``), where DINOv2 keeps it as the first row of
  ``pos_embed``: a layout, not a change of the mathematics;
- the pairing with UFM's heads and the taps (the first and the last block,
  as UFM-Base taps ViT-L/14's first and last): no published UFM checkpoint
  uses this encoder.

It imports nothing of the system under test. The contract is
``benchmark/reference/__init__.py``'s; ``Numerics``, ``FP32`` and
``CONTROL`` are ``ufm``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import ufm
from benchmark.reference.ufm import CONTROL, FP32, Numerics

__all__ = ["Numerics", "FP32", "CONTROL", "Arch", "param_specs", "forward", "predict", "swiglu_hidden"]

# public DINOv2 encoder sizes by name: the published ViT-g/14 (vit_giant2)
_DINOV2 = {"dinov2_giant": dict(embed_dim=1536, depth=40, num_heads=24)}
# options this module writes at one value only, by group: key -> the values it writes
_FIXED = {
    "encoder_kwargs": dict(use_cls_token=(True,), qkv_bias=(True,), norm_intermediate=(True,),
                           data_norm_type=("dinov2",), ffn_layer=("swiglufused", "swiglu")),
    "info_sharing_kwargs": dict(num_register_tokens=(0,), qkv_bias=(True,), norm_intermediate=(True,),
                                use_pos_embed=(True,), num_views=(2,), layerscale_init=(None,),
                                mlp_act=("gelu_exact",), ffn_layer=("mlp",)),
}
_READ = {
    "encoder_kwargs": {"embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio", "pretrain_grid_size",
                       "layerscale_init", "intermediate_layer_idx", "num_register_tokens"},
    "info_sharing_kwargs": {"input_embed_dim", "dim", "depth", "num_heads", "mlp_ratio", "intermediate_layer_idx"},
}
# top-level keys whose value this module writes at one value only
_FIXED_TOP = {"has_classification_head": (False,), "use_unet_feature": (False,),
              "info_sharing_and_head_structure": ("dual+single",), "info_sharing_str": ("global_attention",),
              "head_type": ("dpt",), "uncertainty_head_type": ("dpt",)}


def swiglu_hidden(dim: int, mlp_ratio: float) -> int:
    """DINOv2's ``SwiGLUFFNFused`` width: two thirds of the MLP width
    ``int(dim * mlp_ratio)``, rounded up to a multiple of 8."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def _modelled(cfg: dict, group: str) -> dict:
    kw = dict(cfg.get(group) or {})
    for k, v in kw.items():
        if k in _FIXED[group]:
            if v not in _FIXED[group][k]:
                raise ValueError(f"{group} {k}={v!r}: this module writes only {k} in {_FIXED[group][k]!r}")
        elif k not in _READ[group] and k not in ufm._BOOKKEEPING:
            raise ValueError(f"{group} key {k!r} is not modelled here")
    return kw


class Arch:
    """The sizes of one configuration, read from its config dict (the
    constructor keywords of the published model classes). Refuses what this
    module does not write: another FFN than SwiGLU in the encoder, the
    refinement, another info sharing or head."""

    def __init__(self, cfg: dict):
        for k, allowed in _FIXED_TOP.items():
            if cfg.get(k, allowed[0]) not in allowed:
                raise ValueError(f"{k}={cfg[k]!r}: this module writes only {k} in {allowed!r}")
        enc_kw = _modelled(cfg, "encoder_kwargs")
        if "ffn_layer" not in enc_kw:
            raise ValueError("encoder_kwargs must name the SwiGLU FFN (ffn_layer): this module writes no other")
        enc = dict(patch_size=14, mlp_ratio=4.0, layerscale=1e-5, pretrain_grid=37, cls=True, registers=0)
        enc.update(_DINOV2.get(cfg["encoder_str"], {}))
        for k in ("embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio"):
            if k in enc_kw:
                enc[k] = enc_kw[k]
        for src, dst in (("pretrain_grid_size", "pretrain_grid"), ("layerscale_init", "layerscale"),
                         ("num_register_tokens", "registers")):
            if src in enc_kw:
                enc[dst] = enc_kw[src]
        missing = [k for k in ("embed_dim", "depth", "num_heads") if k not in enc]
        if missing:
            raise ValueError(f"encoder_str {cfg['encoder_str']!r} is no preset here and encoder_kwargs lacks {missing}")
        if enc["registers"] < 0:
            raise ValueError(f"num_register_tokens {enc['registers']} < 0")
        enc["ffn_hidden"] = swiglu_hidden(enc["embed_dim"], enc["mlp_ratio"])
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
        self.refine = False
        res = cfg["inference_resolution"]
        w, h = res[0] if isinstance(res[0], (list, tuple)) else res
        self.model_hw = (int(h), int(w))
        self.compute_dtype = cfg.get("compute_dtype", "bfloat16")

    def encoder_tokens(self, hp: int, wp: int) -> int:
        """The encoder's tokens for an image of ``hp x wp`` patches: the
        patches, the class token and the registers."""
        return hp * wp + int(self.enc["cls"]) + self.enc["registers"]


def _block_specs(prefix: str, dim: int, hidden: int, layerscale: bool) -> Dict[str, tuple]:
    s = {
        f"{prefix}.norm1.weight": (dim,), f"{prefix}.norm1.bias": (dim,),
        f"{prefix}.attn.qkv.weight": (3 * dim, dim), f"{prefix}.attn.qkv.bias": (3 * dim,),
        f"{prefix}.attn.proj.weight": (dim, dim), f"{prefix}.attn.proj.bias": (dim,),
        f"{prefix}.norm2.weight": (dim,), f"{prefix}.norm2.bias": (dim,),
        f"{prefix}.mlp.w12.weight": (2 * hidden, dim), f"{prefix}.mlp.w12.bias": (2 * hidden,),
        f"{prefix}.mlp.w3.weight": (dim, hidden), f"{prefix}.mlp.w3.bias": (dim,),
    }
    if layerscale:
        s[f"{prefix}.ls1.gamma"] = (dim,)
        s[f"{prefix}.ls2.gamma"] = (dim,)
    return s


def param_specs(arch: Arch) -> Dict[str, Tuple[tuple, str]]:
    """Every parameter: name -> (shape, part), named as the system names them
    and in the order of the one draw. The encoder's part is this module's;
    the info sharing and the heads are ``ufm``'s, of the same names."""
    e = arch.enc
    d = e["embed_dim"]
    bb: Dict[str, tuple] = {
        "encoder.patch_embed.weight": (d, 3, e["patch_size"], e["patch_size"]), "encoder.patch_embed.bias": (d,),
        "encoder.pos_embed": (1, e["pretrain_grid"] ** 2, d),
    }
    if e["cls"]:
        bb["encoder.cls_token"] = (1, 1, d)
        bb["encoder.cls_pos_embed"] = (1, 1, d)
    if e["registers"]:
        bb["encoder.register_tokens"] = (1, e["registers"], d)
    for n in range(e["depth"]):
        bb.update(_block_specs(f"encoder.blocks.{n}", d, e["ffn_hidden"], e["layerscale"] is not None))
    bb["encoder.norm.weight"] = (d,)
    bb["encoder.norm.bias"] = (d,)
    specs = {k: (v, "backbone") for k, v in bb.items()}
    # ufm's specs of the rest, on a stand-in encoder of no blocks
    rest = ufm.param_specs(_UfmView(arch))
    specs.update({k: v for k, v in rest.items() if not k.startswith("encoder.")})
    return specs


class _UfmView:
    """What ``ufm.param_specs`` reads of an arch, for the parts this module
    takes from ``ufm`` (info sharing, heads)."""

    def __init__(self, arch: Arch):
        self.enc = dict(arch.enc, depth=0)
        self.info, self.head1, self.uncertainty = arch.info, arch.head1, arch.uncertainty
        self.refine = False


def _block(x, P, name, heads, nm: Numerics, layerscale: bool):
    a = ufm._attention(ufm._layer_norm(x, P, f"{name}.norm1"), P, f"{name}.attn", heads, nm)
    x = x + (a * P[f"{name}.ls1.gamma"] if layerscale else a)
    h = nm.linear(ufm._layer_norm(x, P, f"{name}.norm2"), P[f"{name}.mlp.w12.weight"], P[f"{name}.mlp.w12.bias"],
                  "backbone")
    x1, x2 = h.chunk(2, dim=-1)
    m = nm.linear(F.silu(x1) * x2, P[f"{name}.mlp.w3.weight"], P[f"{name}.mlp.w3.bias"], "backbone")
    return x + (m * P[f"{name}.ls2.gamma"] if layerscale else m)


def encode(P, arch: Arch, images: torch.Tensor, nm: Numerics) -> List[torch.Tensor]:
    """(N, H, W, 3) normalised -> the tapped levels, each (N, Hp, Wp, C)."""
    e = arch.enc
    n, h, w, _ = images.shape
    ps = e["patch_size"]
    hp, wp = h // ps, w // ps
    x = nm.conv(images.permute(0, 3, 1, 2), P["encoder.patch_embed.weight"], P["encoder.patch_embed.bias"],
                "backbone", stride=ps)
    x = x.flatten(2).transpose(1, 2) + ufm._pos_embed(P, e["pretrain_grid"], hp, wp)
    lead = []
    if e["cls"]:
        lead.append((P["encoder.cls_token"] + P["encoder.cls_pos_embed"]).expand(n, 1, -1))
    if e["registers"]:
        lead.append(P["encoder.register_tokens"].expand(n, -1, -1))
    x = torch.cat([*lead, x], dim=1)
    skip = x.shape[1] - hp * wp
    taps = {}
    for i in range(e["depth"]):
        x = _block(x, P, f"encoder.blocks.{i}", e["num_heads"], nm, e["layerscale"] is not None)
        if i in e["taps"]:
            taps[i] = x
    return [ufm._layer_norm(taps[t], P, "encoder.norm")[:, skip:].reshape(n, hp, wp, -1) for t in e["taps"]]


def forward(P: Dict[str, torch.Tensor], arch: Arch, img1: torch.Tensor, img2: torch.Tensor,
            nm: Numerics = FP32) -> Dict[str, torch.Tensor]:
    """The network on normalised (B, H, W, 3) views: a flat dict of (B, H, W,
    ...) outputs, named as the system's network names them."""
    b = img1.shape[0]
    last = encode(P, arch, torch.cat([img1, img2], dim=0), nm)[-1]
    (fin0, _), taps = ufm.share(P, arch, last[:b], last[b:], nm)
    pyr = [last[:b], taps[0][0], taps[1][0], fin0]
    hw = img1.shape[1:3]
    out = ufm.adapt(ufm.dpt(P, "head1", pyr, hw, nm), arch.adaptors1)
    if arch.uncertainty is not None:
        out.update(ufm.adapt(ufm.dpt(P, "uncertainty_head", [t.detach() for t in pyr], hw, nm), arch.adaptors_unc))
    return out


def predict(P: Dict[str, torch.Tensor], arch: Arch, src_u8: torch.Tensor, tgt_u8: torch.Tensor,
            nm: Numerics = FP32, raw: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The predict pipeline for two (B, H0, W0, 3) uint8 batches of one size,
    as ``ufm.predict`` runs it on this module's network: flow (B, 2, H0, W0),
    flow_covariance (B, 3, H0, W0), covisibility and keypoint_confidence
    (B, H0, W0), as present. ``raw``, when given, receives the network's own
    outputs."""
    h0, w0 = src_u8.shape[1:3]
    if tuple(tgt_u8.shape[1:3]) != (h0, w0):
        raise ValueError("both views of a pair have one size here")
    out = forward(P, arch, ufm.normalise_resize(src_u8, arch.model_hw), ufm.normalise_resize(tgt_u8, arch.model_hw),
                  nm)
    if raw is not None:
        raw.update(out)
    h, w = arch.model_hw
    sx, sy = w0 / w, h0 / h
    res = {"flow": (ufm._nearest(out["flow"], (h0, w0)) * torch.tensor([sx, sy], device=src_u8.device))
           .permute(0, 3, 1, 2)}
    if "flow_cov" in out:
        scale = torch.tensor([sx * sx, sy * sy, sx * sy], device=src_u8.device)
        res["flow_covariance"] = (ufm._nearest(out["flow_cov"], (h0, w0)) * scale).permute(0, 3, 1, 2)
    if "covis_mask" in out:
        res["covisibility"] = ufm._nearest(out["covis_mask"][..., None], (h0, w0))[..., 0]
    if "keypoint_confidence" in out:
        res["keypoint_confidence"] = ufm._nearest(out["keypoint_confidence"][..., None], (h0, w0))[..., 0]
    return res
