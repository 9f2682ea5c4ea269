"""Synthetic image pairs with analytic ground-truth flow (counterpart of
``ufm_tpu/utils/example_pairs.py``).

A textured scene warped by a known smooth displacement field, so the end to
end pipeline can be scored by EPE against exact flow. ``synthetic_pair`` and
``warped_pair_from_image`` are numpy only; writing and reading PNG files
(``generate_pairs``, ``ensure_bundled_pairs``, ``load_pair``) goes through
the port's codec (``ufm_torch.utils.image_io``). ``ensure_bundled_pairs()`` generates the three named
pairs on first use, deterministically from fixed seeds.
"""

from __future__ import annotations

import os

import numpy as np


def _texture(h: int, w: int, seed: int) -> np.ndarray:
    """Multi-octave value-noise texture (RGB uint8)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), dtype=np.float64)
    for octave in range(4):
        gh, gw = 4 * 2**octave, 5 * 2**octave
        grid = rng.random((gh + 1, gw + 1, 3))
        ys = np.linspace(0, gh, h, endpoint=False)
        xs = np.linspace(0, gw, w, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        ty = (ys - y0)[:, None, None]
        tx = (xs - x0)[None, :, None]
        a = grid[y0][:, x0]
        b = grid[y0][:, x0 + 1]
        c = grid[y0 + 1][:, x0]
        d = grid[y0 + 1][:, x0 + 1]
        img += ((a * (1 - tx) + b * tx) * (1 - ty) + (c * (1 - tx) + d * tx) * ty) / 2**octave
    img -= img.min()
    img /= img.max()
    return (img * 255).astype(np.uint8)


def _warped_pair_from_big(big: np.ndarray, h: int, w: int, seed: int, max_disp: float):
    """Shared warp core: crop img0 from ``big`` and resample img1 at
    analytically-shifted coordinates. Returns (img0, img1, flow, valid) where
    flow maps img0 pixels to img1 pixels."""
    rng = np.random.default_rng(seed)
    pad = int(max_disp) + 2
    assert big.shape[0] >= h + 2 * pad and big.shape[1] >= w + 2 * pad

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    # smooth flow: affine + sinusoidal parallax
    a = rng.uniform(-0.02, 0.02, 4)
    fx = a[0] * (xs - w / 2) + a[1] * (ys - h / 2) + max_disp * 0.5 * np.sin(2 * np.pi * ys / h)
    fy = a[2] * (xs - w / 2) + a[3] * (ys - h / 2) + max_disp * 0.5 * np.cos(2 * np.pi * xs / w)
    fx = np.clip(fx, -max_disp, max_disp)
    fy = np.clip(fy, -max_disp, max_disp)

    img0 = big[pad : pad + h, pad : pad + w]

    # img1[y, x] = img0_big[y - fy_inv, x - fx_inv]; build img1 by forward
    # resampling of the big texture at (x + fx, y + fy) so that
    # img1[round(x + fx)] content comes from img0[x] — approximate with
    # bilinear sampling of the big image at shifted coords.
    sy = np.clip(ys + fy + pad, 0, big.shape[0] - 2)
    sx = np.clip(xs + fx + pad, 0, big.shape[1] - 2)
    y0 = sy.astype(int)
    x0 = sx.astype(int)
    ty = (sy - y0)[..., None]
    tx = (sx - x0)[..., None]
    b = big.astype(np.float64)
    img1 = (
        b[y0, x0] * (1 - tx) * (1 - ty)
        + b[y0, x0 + 1] * tx * (1 - ty)
        + b[y0 + 1, x0] * (1 - tx) * ty
        + b[y0 + 1, x0 + 1] * tx * ty
    ).astype(np.uint8)

    # img1 sampled at p+flow(p) means: matching img0 pixel p appears at p in
    # img1's sampling grid — the flow from img1 to img0's content is -f; we
    # return the flow field mapping img0 -> img1: for content at img0[p]
    # (= big[p+pad]), it appears in img1 where p' + f(p') + pad = p + pad.
    # For smooth small flows, f(p') ≈ f(p), giving flow ≈ -f.
    flow = np.stack([-fx, -fy], axis=-1).astype(np.float32)
    valid = np.ones((h, w), dtype=bool)
    return np.ascontiguousarray(img0), img1, flow, valid


def synthetic_pair(h: int = 540, w: int = 720, seed: int = 0, max_disp: float = 24.0):
    """Returns (img0, img1, flow, valid): img1 is img0 backward-warped by a
    smooth analytic flow field (so flow maps img0 pixels to img1 pixels)."""
    big = _texture(h + 2 * int(max_disp) + 4, w + 2 * int(max_disp) + 4, seed)
    return _warped_pair_from_big(big, h, w, seed, max_disp)


def warped_pair_from_image(image: np.ndarray, seed: int = 0, max_disp: float = 24.0):
    """Analytic-ground-truth pair from a REAL photo: the same warp core as
    ``synthetic_pair`` applied to natural image statistics — the only way to
    get exact GT flow on real photographs in a zero-egress environment
    (the reference's bundled pairs have no GT). Output is the photo minus a
    ``max_disp``-sized border. Returns (img0, img1, flow, valid)."""
    img = np.asarray(image)
    pad = int(max_disp) + 2
    h, w = img.shape[0] - 2 * pad, img.shape[1] - 2 * pad
    assert h > 0 and w > 0, f"image {img.shape} too small for max_disp {max_disp}"
    return _warped_pair_from_big(img, h, w, seed, max_disp)


PAIR_NAMES = ("noise_scene", "parallax", "wide_baseline")

# The reference release bundles five real 1080px photo pairs. They are data,
# not code; where they are present they drive the eval and golden-image paths
# with natural-image statistics (they have no ground-truth flow: consumers
# fall back to cycle consistency).
REFERENCE_PAIR_NAMES = ("bike", "building", "cook", "fire_academy", "scene")


def reference_pair_dir() -> str | None:
    """Directory of the reference's real photo pairs named by the
    ``UFM_REFERENCE_PAIRS`` environment variable, or None when it is unset or
    does not hold all five pairs."""
    d = os.environ.get("UFM_REFERENCE_PAIRS")
    if not d:
        return None
    for n in REFERENCE_PAIR_NAMES:
        if not (os.path.exists(os.path.join(d, f"{n}_0.png")) and os.path.exists(os.path.join(d, f"{n}_1.png"))):
            return None
    return d


def load_pair(pair_dir: str, name: str):
    """Load ``{name}_0/1.png`` as RGB uint8 + the GT flow if present."""
    from ufm_torch.utils.image_io import read_png

    img0 = read_png(os.path.join(pair_dir, f"{name}_0.png"))
    img1 = read_png(os.path.join(pair_dir, f"{name}_1.png"))
    flow_path = os.path.join(pair_dir, f"{name}_flow.npy")
    flow = np.load(flow_path) if os.path.exists(flow_path) else None
    return img0, img1, flow


def generate_pairs(out_dir: str) -> None:
    """Write the three named synthetic pairs (+ analytic flow) to out_dir."""
    from ufm_torch.utils.image_io import write_png

    os.makedirs(out_dir, exist_ok=True)
    for i, name in enumerate(PAIR_NAMES):
        img0, img1, flow, _ = synthetic_pair(seed=i)
        write_png(os.path.join(out_dir, f"{name}_0.png"), img0)
        write_png(os.path.join(out_dir, f"{name}_1.png"), img1)
        np.save(os.path.join(out_dir, f"{name}_flow.npy"), flow)


def default_pair_dir() -> str:
    """Repo-checkout examples/image_pairs when present, else a user cache dir
    (the installed package has no examples/ tree next to it)."""
    repo_examples = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "examples"
    )
    if os.path.isdir(repo_examples):
        return os.path.join(repo_examples, "image_pairs")
    cache = os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "ufm_torch", "image_pairs")


def ensure_bundled_pairs(out_dir: str | None = None) -> str:
    """Return a directory containing the bundled pairs, generating any that
    are missing (deterministic: fixed seeds)."""
    out_dir = out_dir or default_pair_dir()
    # the flow .npy is load-bearing for the golden-image check and
    # ``ufm eval`` on this dir, so its absence must also trigger regeneration
    missing = [
        n for n in PAIR_NAMES
        if not (os.path.exists(os.path.join(out_dir, f"{n}_0.png"))
                and os.path.exists(os.path.join(out_dir, f"{n}_1.png"))
                and os.path.exists(os.path.join(out_dir, f"{n}_flow.npy")))
    ]
    if missing:
        generate_pairs(out_dir)
    return out_dir
