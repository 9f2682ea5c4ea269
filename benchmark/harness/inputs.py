"""What the benchmark makes from ``--seed``: the weights and the traffic.

Both are made on the run's device by ``torch.Generator``s seeded from the
run's seed and a tag, in a few large calls. The same seed gives the same
weights and inputs; the system under test and the reference each get them
from here, and neither gets anything the other made.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import module_of

__all__ = ["generator", "make_params", "predict_pool", "train_pool", "fan_in"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``tag``) of one run's seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % 2**63)


def fan_in(name: str, shape: tuple) -> int:
    """Inputs that reach one output of a weight: a transposed convolution
    (stride = kernel here) takes its input channels, a convolution its
    input channels times its window, a linear layer its input width."""
    if name.endswith(("resize_0.weight", "resize_1.weight")) or ".up_" in name:
        return shape[0]
    return int(np.prod(shape[1:]))


def make_params(arch, seed: int, device, weights: dict) -> Dict[str, torch.Tensor]:
    """Every parameter of ``arch`` (its reference module's ``param_specs``,
    in their order) from one normal draw on ``device``, held in
    the type it is served in (the compute dtype for the backbone and the
    UNet, fp32 for the heads). ``weights`` (the configuration file's) sets
    the scales: dense and conv kernels normal / sqrt(fan-in) times ``gain``
    (a per-name ``gains`` entry overrides it), biases and embeddings normal
    times ``bias_std`` / ``embed_std``, LayerNorm scales 1 + normal times
    ``norm_std``, LayerScale ``layerscale`` + normal times ``norm_std``."""
    specs = module_of(arch).param_specs(arch)
    total = sum(math.prod(shape) for shape, _ in specs.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    backbone = _DTYPES[arch.compute_dtype]
    gains = weights.get("gains", {})
    out, o = {}, 0
    for name, (shape, part) in specs.items():
        n = math.prod(shape)
        x = flat[o:o + n].view(shape)
        o += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2 and leaf == "weight":
            x = x * (gains.get(name, weights["gain"]) / math.sqrt(fan_in(name, shape)))
        elif leaf == "gamma":
            x = x * weights["norm_std"] + weights["layerscale"]
        elif leaf == "weight":  # a LayerNorm's scale
            x = x * weights["norm_std"] + 1.0
        elif leaf == "bias":
            x = x * weights["bias_std"]
        else:  # position, class-token and view embeddings, the classification bias
            x = x * weights["embed_std"]
        out[name] = x.to(backbone if part == "backbone" else torch.float32)
    del flat
    return out


def _smooth(gen, shape, coarse, device) -> torch.Tensor:
    """(N, H, W, C) noise, smooth at the scale of a ``coarse`` grid, unit variance."""
    n, h, w, c = shape
    low = torch.randn((n, c, *(max(1, k) for k in coarse)), generator=gen, device=device)
    up = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    return (up / up.std()).permute(0, 2, 3, 1)


def _images(gen, n, h, w, device) -> torch.Tensor:
    """(N, H, W, 3) images in [0, 1]: smooth shapes plus texture."""
    x = 0.5 + 0.18 * _smooth(gen, (n, h, w, 3), (h // 16, w // 16), device)
    x = x + 0.06 * _smooth(gen, (n, h, w, 3), (h // 4, w // 4), device)
    return x.clamp(0, 1)


def predict_pool(seed: int, traffic: dict, device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``pool_pairs`` distinct uint8 image pairs (H, W, 3), grouped into
    batches of ``batch``: host numpy arrays, as a caller hands them over.
    Each target is its source moved by a few pixels, with noise."""
    gen = generator(seed, "predict_pool", device)
    n, b = traffic["pool_pairs"], traffic["batch"]
    h, w = traffic["height"], traffic["width"]
    src = _images(gen, n, h, w, device)
    shifts = torch.randint(-12, 13, (n, 2), generator=gen, device=device).tolist()
    tgt = torch.stack([torch.roll(s, (dy, dx), dims=(0, 1)) for s, (dy, dx) in zip(src, shifts)])
    tgt = (tgt + 0.02 * torch.randn(tgt.shape, generator=gen, device=device)).clamp(0, 1)
    src, tgt = ((t * 255).round().to(torch.uint8).cpu().numpy() for t in (src, tgt))
    batches = []
    for i in range(0, n, b):
        s, t = src[i:i + b], tgt[i:i + b]
        batches.append((s[0], t[0]) if b == 1 else (s, t))
    return batches


def train_pool(seed: int, traffic: dict, device) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` distinct training batches on ``device``: normalised
    images (B, H, W, 3), a smooth ground-truth flow (B, H, W, 2) of a few
    pixels and a covisibility mask (B, H, W)."""
    gen = generator(seed, "train_pool", device)
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    mean = torch.tensor((0.485, 0.456, 0.406), device=device)
    std = torch.tensor((0.229, 0.224, 0.225), device=device)
    pool = []
    for _ in range(traffic["pool_batches"]):
        img1 = (_images(gen, b, h, w, device) - mean) / std
        img2 = (_images(gen, b, h, w, device) - mean) / std
        flow = 4.0 * _smooth(gen, (b, h, w, 2), (h // 32, w // 32), device)
        covis = (_smooth(gen, (b, h, w, 1), (h // 32, w // 32), device)[..., 0] > -0.5).float()
        pool.append({"img1": img1, "img2": img2, "gt_flow": flow, "gt_covisibility": covis})
    return pool
