"""The port's own file codecs against the libraries they stand in for.

- ``ufm_torch.checkpoint.io.msgpack_decode`` / ``read_flax_msgpack`` with the
  ``msgpack`` package blocked: bitwise ``flax.serialization.msgpack_restore``
  on ``examples/checkpoints/tiny_real224`` and on a tree with bf16, scalar and
  chunked arrays; every msgpack type family flax writes, as the ``msgpack``
  package encodes it.
- ``ufm_torch.utils.image_io``: the PNG reader bitwise ``cv2.imread`` (RGB
  order) on the bundled pairs as cv2 writes them (several IDAT chunks,
  adaptive filters), on cv2-written gray, RGBA and 16-bit files, and on files
  written here with each row filter, several IDAT chunks, palettes and gray
  at every bit depth; Adam7 refused by name; the writer's 8- and 16-bit files
  read back bitwise by ``cv2``; KITTI flow read and written against the
  ``cv2`` path.
"""

import os
import struct
import sys
import zlib

import cv2
import flax.serialization
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

from ufm_torch.checkpoint.io import msgpack_decode, read_flax_msgpack
from ufm_torch.utils import flow_io
from ufm_torch.utils.example_pairs import PAIR_NAMES, synthetic_pair
from ufm_torch.utils.image_io import decode_png, read_png, read_rgb, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_REAL = os.path.join(ROOT, "examples", "checkpoints", "tiny_real224", "params.msgpack")


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:  # the port widens bf16 exactly to fp32
        want = want.astype(np.float32)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


# ---- msgpack ------------------------------------------------------------------


def test_tiny_real224_params_without_the_msgpack_package(monkeypatch):
    with open(TINY_REAL, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    monkeypatch.setitem(sys.modules, "msgpack", None)
    _assert_trees_equal(read_flax_msgpack(TINY_REAL), want)


def test_flax_tree_with_bf16_scalars_and_chunks(tmp_path, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "a": {"big": rng.standard_normal((7, 11)).astype(np.float32),  # 308 bytes: 5 chunks
              "bf": np.asarray(jnp.asarray(rng.standard_normal((4, 3)), dtype=jnp.bfloat16)),
              "n": np.int32(5), "x": np.float64(2.5), "flag": np.bool_(True)},
        "c": np.arange(3, dtype=np.int64),
        "u8": rng.integers(0, 256, (2, 3, 4), dtype=np.uint8),
        "empty": np.zeros((0, 4), np.float32),
    }
    path = tmp_path / "t.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    want = flax.serialization.msgpack_restore(path.read_bytes())
    monkeypatch.setitem(sys.modules, "msgpack", None)
    got = read_flax_msgpack(str(path))
    _assert_trees_equal(got, want)
    assert isinstance(got["a"]["n"], np.int32) and got["a"]["n"] == 5
    assert isinstance(got["a"]["x"], np.float64)


MSGPACK_VALUES = {
    "nil_bools": [None, True, False],
    "fixints": [0, 1, 127, -1, -32],
    "uints": [128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
    "ints": [-33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)],
    "float64": [1.5, -0.0, 1e300, float("inf")],
    "strings": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 65536, "ünï"],
    "binaries": [b"", b"a" * 255, b"b" * 256, b"c" * 65536],
    "arrays": [[], list(range(15)), list(range(16)), list(range(65536))],
    "maps": [{}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
             {str(i): None for i in range(65536)}],
}


@pytest.mark.parametrize("family", list(MSGPACK_VALUES))
def test_msgpack_type_families(family):
    for value in MSGPACK_VALUES[family]:
        assert msgpack_decode(msgpack.packb(value, use_bin_type=True)) == value


def test_msgpack_float32_and_ext():
    assert msgpack_decode(msgpack.packb(0.1, use_single_float=True)) == np.float32(0.1)
    for n in (1, 2, 4, 8, 16, 3, 255, 256, 70000):  # fixext 1-16, ext 8 / 16 / 32
        data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
        got = msgpack_decode(msgpack.packb(msgpack.ExtType(7, data)), lambda code, payload: (code, payload))
        assert got == (7, data)
    with pytest.raises(ValueError, match="ext type 7"):
        msgpack_decode(msgpack.packb(msgpack.ExtType(7, b"x")))


def test_msgpack_refuses_malformed_input():
    with pytest.raises(ValueError, match="truncated"):
        msgpack_decode(msgpack.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_decode(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="0xc1"):
        msgpack_decode(b"\xc1")


# ---- PNG ----------------------------------------------------------------------


def _cv2_rgb(path, anydepth=False):
    flags = cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR if anydepth else cv2.IMREAD_COLOR
    return cv2.imread(str(path), flags)[..., ::-1]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, filters, bpp: int) -> bytes:
    """PNG-filter (H, stride) bytes, row r with filters[r]; the filter byte
    first on each row."""
    x = rows.astype(np.int32)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    up_left = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pred = {0: 0 * x, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, up_left)}
    out = np.stack([(x[r] - pred[f][r]) & 0xFF for r, f in enumerate(filters)]).astype(np.uint8)
    return np.concatenate([np.asarray(filters, np.uint8)[:, None], out], axis=1).tobytes()


def _png_file(path, w, h, depth, ctype, rows, filters, palette=None, trns=None, idat_parts=1, interlace=0):
    bits = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth
    data = zlib.compress(_filter_rows(rows, filters, max(1, bits // 8)))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    step = -(-len(data) // idat_parts)
    for i in range(0, len(data), step):
        out += chunk(b"IDAT", data[i:i + step])
    path.write_bytes(out + chunk(b"IEND", b""))
    return path


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, N) samples of ``depth`` bits -> (H, stride) bytes, MSB first."""
    h, n = samples.shape
    per = 8 // depth
    pad = (-n) % per
    s = np.pad(samples, ((0, 0), (0, pad))).reshape(h, -1, per).astype(np.uint16)
    shifts = np.arange(8 - depth, -1, -depth)
    return (s << shifts).sum(axis=2).astype(np.uint8)


@pytest.fixture(scope="module")
def cv2_pairs(tmp_path_factory):
    """The bundled pairs as cv2 writes them (several IDAT chunks, libpng's
    adaptive row filters)."""
    d = tmp_path_factory.mktemp("cv2_pairs")
    for i, name in enumerate(PAIR_NAMES):
        img0, img1, _, _ = synthetic_pair(seed=i)
        for j, img in enumerate((img0, img1)):
            cv2.imwrite(str(d / f"{name}_{j}.png"), img[..., ::-1])
    return d


def _chunk_kinds(path):
    data, pos, kinds = path.read_bytes(), 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        kinds.append(kind)
        pos += 12 + length
    return kinds


@pytest.mark.parametrize("name", PAIR_NAMES)
def test_reader_matches_cv2_on_the_bundled_pairs(cv2_pairs, name):
    for j in (0, 1):
        path = cv2_pairs / f"{name}_{j}.png"
        assert _chunk_kinds(path).count(b"IDAT") > 1
        got = read_png(path)
        assert got.dtype == np.uint8 and got.shape == (540, 720, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(path))
        np.testing.assert_array_equal(read_rgb(str(path)), got)


@pytest.mark.parametrize("kind", ["gray", "rgba", "rgb16", "gray16", "rgba16"])
def test_reader_matches_cv2_on_cv2_files(tmp_path, kind):
    rng = np.random.default_rng(1)
    img8 = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    img16 = rng.integers(0, 65536, (37, 53, 4), dtype=np.uint16)
    arr = {"gray": img8[..., 0], "rgba": img8, "rgb16": img16[..., :3], "gray16": img16[..., 0], "rgba16": img16}[kind]
    path = tmp_path / f"{kind}.png"
    cv2.imwrite(str(path), arr)
    for anydepth in (False, True):
        got, want = read_png(path, anydepth=anydepth), _cv2_rgb(path, anydepth)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype, depth", [(2, 8), (2, 16), (6, 8), (6, 16), (0, 8), (0, 16), (4, 8), (4, 16)])
@pytest.mark.parametrize("filters", ["each", "runs", "none", "sub", "up", "average", "paeth"])
def test_reader_matches_cv2_on_every_row_filter(tmp_path, ctype, depth, filters):
    """Files written here: rows filtered with one type, each type in turn, or
    seeded runs of Average / Paeth rows (decoded together) between the other
    types, the data split over three IDAT chunks."""
    h, w = 23, 31
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(2)
    samples = rng.integers(0, 2**depth, (h, w * channels), dtype=np.uint16 if depth == 16 else np.uint8)
    rows = samples.astype(">u2").view(np.uint8) if depth == 16 else samples
    kinds = ["none", "sub", "up", "average", "paeth"]
    if filters == "each":
        per_row = [r % 5 for r in range(h)]
    elif filters == "runs":
        per_row = [int(f) for f in np.random.default_rng(3).choice([0, 1, 2, 3, 4, 3, 4, 4], h)]
    else:
        per_row = [kinds.index(filters)] * h
    path = _png_file(tmp_path / "f.png", w, h, depth, ctype, rows.reshape(h, -1), per_row, idat_parts=3)
    for anydepth in (False, True):
        np.testing.assert_array_equal(read_png(path, anydepth=anydepth), _cv2_rgb(path, anydepth))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("ctype", [3, 0], ids=["palette", "gray"])
def test_reader_matches_cv2_on_palettes_and_low_bit_gray(tmp_path, ctype, depth):
    h, w = 19, 29  # rows that end inside a byte
    rng = np.random.default_rng(3)
    n = 2**depth
    idx = rng.integers(0, n, (h, w)).astype(np.uint8)
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8) if ctype == 3 else None
    trns = bytes(rng.integers(0, 256, n, dtype=np.uint8)) if ctype == 3 else None  # dropped like alpha
    rows = idx if depth == 8 else _packed(idx, depth)
    path = _png_file(tmp_path / "p.png", w, h, depth, ctype, rows, [r % 5 for r in range(h)], palette, trns)
    np.testing.assert_array_equal(read_png(path), _cv2_rgb(path))


def test_reader_refuses_interlaced_and_corrupt_files(tmp_path):
    rows = np.zeros((4, 12), np.uint8)
    path = _png_file(tmp_path / "adam7.png", 4, 4, 8, 2, rows, [0] * 4, interlace=1)
    with pytest.raises(ValueError, match="adam7.png.*Adam7"):
        read_png(path)
    good = _png_file(tmp_path / "ok.png", 4, 4, 8, 2, rows, [0] * 4).read_bytes()
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(FileNotFoundError):
        read_rgb(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_writer_files_read_back_bitwise_by_cv2(tmp_path, dtype):
    rng = np.random.default_rng(4)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (41, 67, 3), dtype=dtype)
    path = tmp_path / "w.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path, anydepth=True), img)
    np.testing.assert_array_equal(read_png(path, anydepth=True), img)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        write_png(str(path), img.astype(np.float32))


def test_kitti_flow_against_the_cv2_path(tmp_path):
    rng = np.random.default_rng(5)
    flow = (rng.standard_normal((33, 47, 2)) * 40).astype(np.float32)
    valid = rng.random((33, 47)) > 0.3
    ours = tmp_path / "ours.png"
    flow_io.write_kitti_flow(str(ours), flow, valid)
    # what the cv2 path wrote: the same uint16 RGB planes, BGR to cv2
    raw = cv2.imread(str(ours), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)[..., ::-1]
    want = np.clip(flow.astype(np.float64) * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    np.testing.assert_array_equal(raw[..., :2], want)
    np.testing.assert_array_equal(raw[..., 2], valid.astype(np.uint16))
    theirs = tmp_path / "theirs.png"
    cv2.imwrite(str(theirs), raw[..., ::-1])
    for path in (ours, theirs):
        got_flow, got_valid = flow_io.read_kitti_flow(str(path))
        np.testing.assert_array_equal(got_flow, ((raw[..., :2].astype(np.float64) - 2**15) / 64.0).astype(np.float32))
        np.testing.assert_array_equal(got_valid, valid)
