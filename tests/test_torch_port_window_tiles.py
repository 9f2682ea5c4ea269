"""The window kernel's tile plan on the CPU: ``staged_tiles`` (how many tiles
stage their taps in shared memory) against a brute-force loop over the
tiles, pixel by pixel in fp32, as the kernel plans them. On the card the
kernel's own count is held to ``staged_tiles`` (tests/test_torch_port_gpu.py,
chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

from ufm_torch.ops import window_refinement as wr


def _brute_staged(flow: np.ndarray, p: int) -> int:
    """Loop over every tile and its in-image pixels: clamp flow + grid in
    fp32, floor, and test the spans of the tap origins against the box."""
    b, h, w, _ = flow.shape
    r, k = (p - 1) // 2, p + 3
    m = np.float32(r + 4)
    (tw, th), (bw, bh) = wr.TILE, wr.BOX
    staged = 0
    for img in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                xs, ys = [], []
                for y in range(y0, min(y0 + th, h)):
                    for x in range(x0, min(x0 + tw, w)):
                        px = min(max(flow[img, y, x, 0] + np.float32(x), -m), np.float32(w) + m)
                        py = min(max(flow[img, y, x, 1] + np.float32(y), -m), np.float32(h) + m)
                        xs.append(math.floor(px) - r - 1)
                        ys.append(math.floor(py) - r - 1)
                staged += max(xs) - min(xs) + k <= bw and max(ys) - min(ys) + k <= bh
    return staged


def _motion(b, h, w, rng, noise=0.5, split=False):
    """chip_smoke.py's smooth motion (scale 1.05, rotation 3 degrees,
    translation (25, -12) px) plus iid noise; with ``split``, the pixels
    below the diagonal move 40 px further along y."""
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    a = math.radians(3.0)
    dx, dy = xs - (w - 1) / 2, ys - (h - 1) / 2
    fx = 1.05 * (math.cos(a) * dx - math.sin(a) * dy) - dx + 25.0
    fy = 1.05 * (math.sin(a) * dx + math.cos(a) * dy) - dy - 12.0
    if split:
        fy = fy + 40.0 * (ys / h > xs / w)
    flow = np.stack([fx, fy], axis=-1)[None] + noise * rng.standard_normal((b, h, w, 2))
    return flow.astype(np.float32)


def _flow(kind: str, b: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "smooth":
        return _motion(b, h, w, rng)
    if kind == "split":
        return _motion(b, h, w, rng, split=True)
    if kind == "iid":
        return (rng.standard_normal((b, h, w, 2)) * 6.0).astype(np.float32)
    # "borders": a smooth flow with windows pushed across and far past every
    # border, where the clamp decides the taps
    flow = _motion(b, h, w, rng)
    flow[:, 0, :5] = -500.0
    flow[:, -1, -3:] = 1e6
    flow[:, 3:9, -2, 0] = 30.0
    flow[1, :, 0, 1] = -40.0
    return flow


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("kind", ["smooth", "split", "iid", "borders"])
def test_staged_tiles_matches_brute_force(kind, p):
    """B = 2, H and W not multiples of the tile (37 x 70: ragged last tile
    row and column)."""
    flow = _flow(kind, 2, 37, 70)
    got = wr.staged_tiles(torch.from_numpy(flow), p)
    assert got == _brute_staged(flow, p)
    assert 0 <= got <= wr.tile_count(2, 37, 70) == 2 * 5 * 3


def test_staged_tiles_both_paths():
    """A smooth flow stages every tile, iid flow of sigma 6 px none, and the
    split flow some but not all."""
    tiles = wr.tile_count(1, 64, 160)
    assert wr.staged_tiles(torch.from_numpy(_flow("smooth", 1, 64, 160)), 5) == tiles
    assert wr.staged_tiles(torch.from_numpy(_flow("iid", 1, 64, 160)), 5) == 0
    assert 0 < wr.staged_tiles(torch.from_numpy(_flow("split", 1, 64, 160)), 5) < tiles


@pytest.mark.parametrize("axis", [0, 1])
def test_staged_tiles_at_the_box_edge(axis):
    """A zero flow, the last pixel of the first tile pushed on along one axis:
    the tile fits while its taps span exactly the box, and not one pixel
    further."""
    p, k = 5, 8
    span0 = wr.TILE[axis] - 1 + k  # the taps of the unmoved tile
    for extra, fits in ((wr.BOX[axis] - span0, True), (wr.BOX[axis] - span0 + 1, False)):
        flow = np.zeros((1, 16, 64, 2), np.float32)
        flow[0, wr.TILE[1] - 1, wr.TILE[0] - 1, axis] = extra
        # the other tiles are unmoved and fit
        want = wr.tile_count(1, 16, 64) - (not fits)
        assert wr.staged_tiles(torch.from_numpy(flow), p) == want == _brute_staged(flow, p)


def test_tile_count():
    assert wr.tile_count(1, 420, 560) == 53 * 18
    assert wr.tile_count(2, 8, 32) == 2
    assert wr.tile_count(3, 9, 33) == 3 * 2 * 2
