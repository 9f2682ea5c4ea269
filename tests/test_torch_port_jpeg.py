"""The port's own image decoders (``ufm_torch/csrc/host/image_decode.h``, no
libjpeg, libpng or zlib) against the JAX package's loader (libjpeg-turbo and
libpng) and cv2, on the CPU.

- The native loader (``ufm_torch.runtime.loader``): frames bit for bit the
  JAX loader's (``ufm_tpu.runtime.loader``) over the committed JPEG cases
  (``tests/golden/jpeg_cases``: every sampling factor cv2 writes, baseline
  and progressive, restart intervals, optimised Huffman tables, grayscale,
  Adobe RGB, files PIL wrote) and over PNG files made here (bit depths
  1/2/4/8/16, palette, gray, gray + alpha, RGBA, tRNS, Adam7, several IDAT
  chunks, zlib levels 0/1/9); corrupt and truncated files give what the
  JAX loader gives (-2, or the same frame where libjpeg decodes on).
- ``read_rgb`` / ``decode_rgb``: bit for bit ``cv2.imread`` on every JPEG
  case, the eight EXIF orientations and CMYK included; a refused feature
  raises ``ValueError`` naming it.
- The committed decodes (``decodes.npz``) and the SHA-256 of the 1080x1920
  pair's decodes (``tests/golden/jpeg_pair``): what chip_smoke checks on the
  card.
- ``hsv_to_bgr`` (``visualize_flow``'s colours) bit for bit
  ``cv2.cvtColor(..., COLOR_HSV2BGR)`` over every hue and saturation.
- The slice: tiny UFM-Base fed the port's decode of a JPEG pair against the
  JAX package's model fed ``cv2.imread`` of the same files (atol 1e-4, the
  fp32 tolerance of ``test_torch_port_model.py``).

``PYTHONPATH=. python tests/test_torch_port_jpeg.py`` writes the committed files (seeded:
nothing is downloaded).
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CASES = os.path.join(GOLDEN, "jpeg_cases")
PAIR = os.path.join(GOLDEN, "jpeg_pair")
DECODES = os.path.join(CASES, "decodes.npz")
PAIR_HASHES = os.path.join(PAIR, "sha256.json")
PAIR_FILES = ("frame0.jpg", "frame1.jpg")
ATOL = 1e-4  # tests/test_torch_port_model.py's fp32 bar

# (file, writer, size (h, w), options): cv2's sampling factors by name
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "411": 0x411111, "440": 0x121111}
CASE_SPECS = (
    ("s444_base_rst.jpg", "cv2", (117, 157), dict(sampling="444", rst=2)),
    ("s444_prog.jpg", "cv2", (117, 157), dict(sampling="444", progressive=True)),
    ("s422_base_opt.jpg", "cv2", (117, 157), dict(sampling="422", optimize=True)),
    ("s422_prog_rst.jpg", "cv2", (117, 157), dict(sampling="422", progressive=True, rst=3)),
    ("s420_base_rst_opt.jpg", "cv2", (117, 157), dict(sampling="420", rst=1, optimize=True)),
    ("s420_prog.jpg", "cv2", (117, 157), dict(sampling="420", progressive=True)),
    ("s411_base.jpg", "cv2", (117, 157), dict(sampling="411")),
    ("s411_prog_rst.jpg", "cv2", (117, 157), dict(sampling="411", progressive=True, rst=2)),
    ("s440_base_opt.jpg", "cv2", (117, 157), dict(sampling="440", optimize=True)),
    ("s440_prog.jpg", "cv2", (117, 157), dict(sampling="440", progressive=True)),
    ("gray_rst.jpg", "cv2", (99, 125), dict(gray=True, rst=4)),
    ("adobe_rgb.jpg", "pil", (75, 111), dict(keep_rgb=True)),
    ("exif3.jpg", "pil", (61, 93), dict(orientation=3, subsampling=2)),
    ("exif6.jpg", "pil", (61, 93), dict(orientation=6, progressive=True)),
    ("exif8.jpg", "pil", (61, 93), dict(orientation=8, subsampling=0)),
    ("cmyk.jpg", "pil", (53, 71), dict(cmyk=True)),
)
CASE_NAMES = [c[0] for c in CASE_SPECS]
LOADER_REFUSES = ("cmyk.jpg",)  # libjpeg gives no RGB for CMYK: both loaders report -2


def scene(h, w, seed, noise=8.0, shift=(0.0, 0.0)):
    """A smooth synthetic RGB scene with seeded noise (uint8 (h, w, 3))."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = x + shift[0], y + shift[1]
    s = max(h, w) / 160.0
    img = np.stack([128 + 90 * np.sin(x / (17 * s) + seed) * np.cos(y / (29 * s)),
                    128 + 80 * np.cos(y / (23 * s) - x / (41 * s)),
                    128 + 70 * np.sin((x + 2 * y) / (37 * s))], axis=-1)
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_case(name, writer, hw, opts, seed):
    import cv2
    from PIL import Image

    img = scene(*hw, seed)
    if writer == "cv2":
        params = [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, int(opts.get("progressive", False)),
                  cv2.IMWRITE_JPEG_RST_INTERVAL, opts.get("rst", 0), cv2.IMWRITE_JPEG_OPTIMIZE,
                  int(opts.get("optimize", False))]
        if opts.get("gray"):
            return cv2.imencode(".jpg", img[..., 1], params)[1].tobytes()
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[opts["sampling"]]]
        return cv2.imencode(".jpg", img[..., ::-1], params)[1].tobytes()
    im = Image.fromarray(img)
    kw = {"quality": 85}
    if opts.get("cmyk"):
        im = im.convert("CMYK")
    if opts.get("keep_rgb"):
        kw["keep_rgb"] = True
    if "orientation" in opts:
        exif = Image.Exif()
        exif[0x0112] = opts["orientation"]
        kw["exif"] = exif.tobytes()
    for k in ("progressive", "subsampling"):
        if k in opts:
            kw[k] = opts[k]
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def pair_frames():
    """The 1080x1920 pair: one scene, the second frame shifted by (12, -5) px."""
    return scene(1080, 1920, 100, noise=7.0), scene(1080, 1920, 100, noise=7.0, shift=(12.0, -5.0))


# ---------------------------------------------------------------- PNG cases

def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _png(w, h, depth, ctype, rows, interlace=0, split=None, level=6, extra=b""):
    z = zlib.compress(rows, level)
    parts = [z[i:i + split] for i in range(0, len(z), split)] if split else [z]
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + extra + b"".join(_chunk(b"IDAT", p) for p in parts) + _chunk(b"IEND", b""))


def _filtered(rows, bpp, seed):
    """PNG rows (h, n) uint8 with a seeded filter type (0-4) on each row."""
    rng = np.random.default_rng(seed)
    out, b = bytearray(), np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        f = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])  # left, up-left: unfiltered bytes
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (np.zeros_like(row), a, b, (a + b) // 2, paeth)[f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        b = row
    return bytes(out)


def _adam7(img, bpp):
    out = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            out += _filtered(sub.reshape(sub.shape[0], -1), bpp, x0 + 10 * y0)
    return out


def png_cases():
    """name -> PNG bytes: what the loader must decode as libpng does."""
    from PIL import Image

    s = scene(37, 45, 7)

    def pil(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        return buf.getvalue()

    rgb = Image.fromarray(s)
    cases = {
        "rgb8": pil(rgb), "rgba8": pil(rgb.convert("RGBA")), "gray8": pil(Image.fromarray(s[..., 0])),
        "gray_alpha8": pil(rgb.convert("LA")),
        "palette8": pil(rgb.convert("P", palette=Image.ADAPTIVE, colors=200)),
        "palette_trns": pil(rgb.convert("P", palette=Image.ADAPTIVE, colors=16), transparency=3),
        "gray_trns": pil(Image.fromarray(s[..., 2]), transparency=7),
        "rgb_trns": pil(rgb, transparency=(1, 2, 3)),
        "gray16": pil(Image.fromarray(s[..., 0].astype(np.uint16) * 257 + 3)),
        "bilevel": pil(rgb.convert("1")),
    }
    for bits in (1, 2, 4):
        cases[f"palette{bits}"] = pil(rgb.convert("P", palette=Image.ADAPTIVE, colors=2 ** bits), bits=bits)
        cases[f"gray{bits}"] = pil(Image.fromarray(s[..., 1]), bits=bits)
    h, w, _ = s.shape
    plain_rows = b"".join(b"\x00" + s[y].tobytes() for y in range(h))
    for level in (0, 1, 9):
        cases[f"zlib_level{level}"] = _png(w, h, 8, 2, plain_rows, level=level)
    wide = (s.astype(np.uint16) * 251).astype(">u2")
    cases["rgb16_filtered"] = _png(w, h, 16, 2, _filtered(wide.view(np.uint8).reshape(h, -1), 6, 1))
    t = scene(23, 29, 8)
    cases["filtered_multi_idat"] = _png(29, 23, 8, 2, _filtered(t.reshape(23, -1), 3, 0), split=97)
    cases["adam7_rgb8"] = _png(29, 23, 8, 2, _adam7(t, 3), interlace=1)
    cases["adam7_gray8_tiny"] = _png(3, 5, 8, 0, _adam7(scene(5, 3, 9)[..., :1], 1), interlace=1)
    return cases


def _flip(data, at):
    b = bytearray(data)
    b[at] ^= 0x5A
    return bytes(b)


def _fix_idat_crc(data):
    """``data`` with the first IDAT chunk's CRC recomputed."""
    pos = data.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", data[pos:pos + 4])
    crc = struct.pack(">I", zlib.crc32(data[pos + 4:pos + 8 + n]) & 0xFFFFFFFF)
    return data[:pos + 8 + n] + crc + data[pos + 12 + n:]


DAMAGED_JPEGS = ("s420_base_rst_opt.jpg", "s411_base.jpg", "gray_rst.jpg")
DAMAGED = sorted(
    [f"png_{k}" for k in ("truncated_half", "truncated_in_iend", "no_iend", "bad_ihdr_crc", "bad_idat_crc",
                          "bad_iend_crc", "bad_zlib_header", "bad_deflate_data", "bad_adler32", "bad_text_crc",
                          "unknown_critical_chunk", "bad_filter_type", "short_image_data", "extra_image_data")]
    + [f"{n[:-4]}_{k}" for n in DAMAGED_JPEGS for k in ("truncated_in_header", "truncated_half", "no_eoi",
                                                          "flipped_data")] + ["jpeg_no_soi"])


def corrupt_cases():
    """name -> bytes of damaged PNG and JPEG files."""
    png = png_cases()["rgb8"]
    idat = png.index(b"IDAT")
    (idat_len,) = struct.unpack(">I", png[idat - 4:idat])
    rows = b"".join(b"\x07" + bytes(135) if y == 3 else b"\x00" + bytes(135) for y in range(37))
    text = _chunk(b"tEXt", b"key\x00value")
    cases = {
        "png_truncated_half": png[:len(png) // 2],
        "png_truncated_in_iend": png[:-6],
        "png_no_iend": png[:-12],
        "png_bad_ihdr_crc": _flip(png, 29),
        "png_bad_idat_crc": _flip(png, idat + 4 + idat_len),
        "png_bad_iend_crc": _flip(png, len(png) - 1),
        "png_bad_zlib_header": _flip(png, idat + 4),
        "png_bad_deflate_data": _fix_idat_crc(_flip(png, idat + 4 + idat_len // 2)),
        "png_bad_adler32": _fix_idat_crc(_flip(png, idat + 3 + idat_len)),
        "png_bad_text_crc": png[:idat - 4] + text[:-1] + bytes([text[-1] ^ 1]) + png[idat - 4:],
        "png_unknown_critical_chunk": png[:idat - 4] + _chunk(b"ABCD", b"xx") + png[idat - 4:],
        "png_bad_filter_type": _png(45, 37, 8, 2, rows),
        "png_short_image_data": _png(45, 37, 8, 2, rows[:-200].replace(b"\x07", b"\x00")),
        "png_extra_image_data": _png(45, 37, 8, 2, rows.replace(b"\x07", b"\x00") + bytes(50)),
    }
    for name in DAMAGED_JPEGS:
        jpg = _read(name)
        stem = name[:-4]
        cases[f"{stem}_truncated_in_header"] = jpg[:len(jpg) // 40]
        cases[f"{stem}_truncated_half"] = jpg[:len(jpg) // 2]
        cases[f"{stem}_no_eoi"] = jpg[:-2]
        cases[f"{stem}_flipped_data"] = _flip(jpg, int(len(jpg) * 0.6))
    cases["jpeg_no_soi"] = b"\x00" + jpg[1:]
    assert sorted(cases) == DAMAGED
    return cases


# ---------------------------------------------------------------- helpers

def _port_frame(path, hw):
    from ufm_torch.runtime.loader import NativeImageLoader

    with NativeImageLoader(hw, num_threads=1) as loader:
        loader.submit(1, str(path))
        _, frame = loader.poll()
    return frame


def _jax_frame(path, hw):
    from ufm_tpu.runtime import loader as jax_loader

    loader = jax_loader.NativeImageLoader(hw, num_threads=1)
    try:
        loader.submit(1, str(path))
        _, frame = loader.poll()
    finally:
        loader.close()
    return frame


def _cv2_rgb(data):
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _stored_hw(data):
    """The frame's size as stored (before any EXIF orientation)."""
    import cv2

    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION).shape[:2]


def _read(name):
    with open(os.path.join(CASES, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def built():
    """The host library, built once for the module."""
    from ufm_torch.ops import _build

    return _build.load_host_library("ufm_loader")


# ---------------------------------------------------------------- the loader

@pytest.mark.parametrize("name", CASE_NAMES)
def test_loader_jpeg_matches_the_jax_loader(built, name):
    path = os.path.join(CASES, name)
    hw = _stored_hw(_read(name))
    got, want = _port_frame(path, hw), _jax_frame(path, hw)
    if name in LOADER_REFUSES:
        assert got is None and want is None
        return
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)


def test_loader_jpeg_resized_matches_the_jax_loader(built):
    for name in ("s420_prog.jpg", "s422_base_opt.jpg"):
        path = os.path.join(CASES, name)
        np.testing.assert_array_equal(_port_frame(path, (45, 70)), _jax_frame(path, (45, 70)))


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("png_cases")
    paths = {}
    for name, data in png_cases().items():
        paths[name] = tmp / f"{name}.png"
        paths[name].write_bytes(data)
    return paths


@pytest.mark.parametrize("name", sorted(png_cases()))
def test_loader_png_matches_the_jax_loader(built, png_files, name):
    import cv2

    path = png_files[name]
    hw = cv2.imread(str(path)).shape[:2]
    got, want = _port_frame(path, hw), _jax_frame(path, hw)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    if name in ("adam7_rgb8", "filtered_multi_idat"):  # lossless: the scene itself
        np.testing.assert_array_equal(got, scene(23, 29, 8))


@pytest.mark.parametrize("name", DAMAGED)
def test_loader_damaged_files_as_the_jax_loader(built, tmp_path, name):
    """A damaged file gives what the JAX loader gives: (id, None), or the same
    frame where libjpeg decodes on (entropy data cut short decodes as zeros,
    a bad code as a zero) and libpng only warns (a bad ancillary CRC, an
    unread IEND)."""
    path = tmp_path / name
    path.write_bytes(corrupt_cases()[name])
    got, want = _port_frame(path, (37, 45)), _jax_frame(path, (37, 45))
    assert (got is None) == (want is None), (got is None, want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)


def test_loader_builds_with_no_image_library(built):
    """The loader links no image library: no ``-l`` flag in the host build,
    and no libjpeg / libpng / zlib in the built library's dynamic section."""
    from ufm_torch.ops import _build

    assert not [f for f in _build.CXX_FLAGS if f.startswith("-l")]
    with open(built._name, "rb") as f:
        binary = f.read()
    for lib in (b"libjpeg.so", b"libpng", b"libz.so"):  # the NEEDED names of the dynamic section
        assert lib not in binary, lib


# ---------------------------------------------------------------- read_rgb

@pytest.mark.parametrize("name", CASE_NAMES)
def test_read_rgb_matches_cv2(built, name):
    import cv2

    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    path = os.path.join(CASES, name)
    got = read_rgb(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(decode_rgb(_read(name)), got)


@pytest.mark.parametrize("order", ["MM", "II"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_read_rgb_applies_every_exif_orientation(built, orientation, order):
    """exif6.jpg with its Orientation value replaced, its TIFF block big-
    (as PIL wrote it) or little-endian: 1-8 applied as cv2 applies them, 0
    and 9 ignored."""
    from ufm_torch.utils.image_io import decode_rgb

    data = _read("exif6.jpg")
    mm = b"MM\x00*\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06\x00\x00"
    assert data.count(mm) == 1
    if order == "MM":
        tiff = mm[:-4] + struct.pack(">H", orientation) + b"\x00\x00"
    else:
        tiff = b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00\x00\x00" + struct.pack("<H", orientation) + b"\x00\x00"
    data = data.replace(mm, tiff)
    want = _cv2_rgb(data)
    got = decode_rgb(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


REFUSED = ("12-bit", "hierarchical", "hierarchical arithmetic", "lossless", "lossless arithmetic", "not a JPEG body")


def _with_byte(data, marker, offset, value):
    b = bytearray(data)
    b[data.index(marker) + offset] = value
    return bytes(b)


def _refused():
    base = _read("s420_base_rst_opt.jpg")
    return {
        "lossless": (_with_byte(base, b"\xff\xc0", 1, 0xC3), "lossless"),
        "lossless arithmetic": (_with_byte(base, b"\xff\xc0", 1, 0xCB), "lossless"),
        "hierarchical": (_with_byte(base, b"\xff\xc0", 1, 0xC5), "hierarchical"),
        "hierarchical arithmetic": (_with_byte(base, b"\xff\xc0", 1, 0xCD), "hierarchical"),
        "12-bit": (_with_byte(base, b"\xff\xc0", 4, 12), "12-bit"),
        "not a JPEG body": (b"\xff\xd8\x00\x00", "JPEG"),
    }


@pytest.mark.parametrize("feature", REFUSED)
def test_refused_features_raise_naming_them(built, feature):
    """A refused feature raises naming the file and the feature. The two
    lossless entries are baseline streams relabelled SOF3 / SOF11: lossless
    files now decode where cv2 decodes them (test_torch_port_jpeg_lossless.py),
    so these get cv2.imdecode's answer on the same bytes, which is None (a
    JFIF YCbCr lossless file; arithmetic lossless)."""
    from ufm_torch.utils.image_io import decode_rgb

    data, words = _refused()[feature]
    if feature.startswith("lossless"):
        assert _cv2_rgb(data) is None
    with pytest.raises(ValueError, match=f"request.jpg: .*{words}"):
        decode_rgb(data, name="request.jpg")


def test_read_rgb_reaches_no_cv2_for_a_jpeg(built, monkeypatch):
    import sys

    from ufm_torch.utils.image_io import read_rgb

    want = read_rgb(os.path.join(CASES, "s420_prog.jpg"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(read_rgb(os.path.join(CASES, "s420_prog.jpg")), want)
    with pytest.raises(ImportError, match="cv2"):
        read_rgb(os.path.join(CASES, "decodes.npz"))


# ---------------------------------------------------------------- committed decodes

def test_committed_decodes(built):
    """The loader and ``read_rgb`` give the committed decodes (libjpeg's and
    cv2's) of every case: the files chip_smoke holds the card's host to."""
    from ufm_torch.utils.image_io import read_rgb

    with np.load(DECODES) as z:
        stored = {k: z[k] for k in z.files}
    assert {k for k in stored if k.startswith("cv2/")} == {f"cv2/{n}" for n in CASE_NAMES}
    assert {k for k in stored if k.startswith("libjpeg/")} == {f"libjpeg/{n}" for n in CASE_NAMES
                                                               if n not in LOADER_REFUSES}
    for name in CASE_NAMES:
        path = os.path.join(CASES, name)
        assert os.path.getsize(path) <= 16 * 1024, name
        np.testing.assert_array_equal(read_rgb(path), stored[f"cv2/{name}"])
        if name not in LOADER_REFUSES:
            frame = stored[f"libjpeg/{name}"]
            np.testing.assert_array_equal(_port_frame(path, frame.shape[:2]), frame)


def test_committed_pair_hashes(built):
    with open(PAIR_HASHES) as f:
        hashes = json.load(f)
    assert sorted(hashes) == sorted(PAIR_FILES)
    for name in PAIR_FILES:
        path = os.path.join(PAIR, name)
        assert os.path.getsize(path) <= 600 * 1024
        frame = _port_frame(path, tuple(hashes[name]["shape"][:2]))
        assert list(frame.shape) == hashes[name]["shape"] == [1080, 1920, 3]
        assert hashlib.sha256(frame.tobytes()).hexdigest() == hashes[name]["sha256"]


# ---------------------------------------------------------------- viz

def test_hsv_to_bgr_matches_cv2_on_every_hue_and_saturation():
    import cv2

    from ufm_torch.utils.viz import hsv_to_bgr

    h, s = np.meshgrid(np.arange(180), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, np.full_like(h, 255)], axis=-1).astype(np.uint8)
    for img in (hsv, hsv.reshape(256, 180, 3), hsv.reshape(-1, 45, 3)):  # row ends off and on 32-pixel blocks
        np.testing.assert_array_equal(hsv_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_visualize_flow_matches_cv2():
    import cv2

    from ufm_torch.utils.viz import visualize_flow

    flow = np.random.default_rng(3).normal(0, 5, (37, 61, 2)).astype(np.float32)
    got = visualize_flow(flow, 8.0)
    magnitude = np.clip(np.sqrt(np.square(flow[..., 0]) + np.square(flow[..., 1])) / 8.0, 0, 1)
    hsv = np.zeros((37, 61, 3), np.uint8)
    hsv[..., 0] = (np.degrees(np.arctan2(flow[..., 1], flow[..., 0])) % 360 / 2).astype(np.uint8)
    hsv[..., 1] = (magnitude * 255).astype(np.uint8)
    hsv[..., 2] = 255
    np.testing.assert_array_equal(got, cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


# ---------------------------------------------------------------- the slice

def test_tiny_ufm_base_on_the_ports_decode_matches_jax_on_cv2(built):
    """A JPEG pair (4:2:0 baseline and 4:2:2 progressive, 117x157) through
    ``read_rgb`` into the port's tiny UFM-Base, against the JAX package's
    model with the same weights fed ``cv2.imread`` of the same files."""
    import cv2

    from ufm_torch.checkpoint import load_jax_params
    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.utils.image_io import read_rgb
    from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
    from ufm_tpu.models import UniFlowMatchConfidence as JModel
    from ufm_tpu.models import ufm_tiny_config as jax_tiny_config

    res = [(56, 42)]
    jmodel = JModel.from_config(jax_tiny_config(inference_resolution=res), seed=0)
    rng = np.random.default_rng(11)
    flat = {k: v + rng.normal(0.0, 0.02, v.shape).astype(v.dtype) for k, v in flatten_params(jmodel.params).items()}
    jmodel.params = unflatten_params(flat)
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(inference_resolution=res), device="cpu")
    load_jax_params(model, flat)
    paths = [os.path.join(CASES, n) for n in ("s420_base_rst_opt.jpg", "s422_prog_rst.jpg")]
    got = model.predict_correspondences_batched(source_image=read_rgb(paths[0]), target_image=read_rgb(paths[1]))
    want = jmodel.predict_correspondences_batched(source_image=cv2.imread(paths[0])[..., ::-1].copy(),
                                                  target_image=cv2.imread(paths[1])[..., ::-1].copy())
    for name, a, b in (("flow", got.flow.flow_output, want.flow.flow_output),
                       ("covisibility", got.covisibility.mask, want.covisibility.mask),
                       ("flow_covariance", got.flow.flow_covariance, want.flow.flow_covariance)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape and a.shape[-2:] == (117, 157), name
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-5 if "cov" in name else 0.0, err_msg=name)


# ---------------------------------------------------------------- the committed files

def write_committed_files():
    """Write tests/golden/jpeg_cases (16 small files and decodes.npz: the JAX
    package's loader's libjpeg decodes and cv2's) and tests/golden/jpeg_pair
    (the 1080x1920 pair and the SHA-256 of libjpeg's decodes)."""
    import cv2

    os.makedirs(CASES, exist_ok=True)
    os.makedirs(PAIR, exist_ok=True)
    decodes = {}
    for seed, (name, writer, hw, opts) in enumerate(CASE_SPECS):
        data = _write_case(name, writer, hw, opts, seed)
        path = os.path.join(CASES, name)
        with open(path, "wb") as f:
            f.write(data)
        decodes[f"cv2/{name}"] = np.ascontiguousarray(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
        frame = _jax_frame(path, _stored_hw(data))
        assert (frame is None) == (name in LOADER_REFUSES), name
        if frame is not None:
            decodes[f"libjpeg/{name}"] = frame
        print(f"wrote {path} ({len(data)} bytes)")
    np.savez_compressed(DECODES, **decodes)
    hashes = {}
    for name, img, prog in zip(PAIR_FILES, pair_frames(), (0, 1)):
        path = os.path.join(PAIR, name)
        ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
        with open(path, "wb") as f:
            f.write(buf.tobytes())
        frame = _jax_frame(path, img.shape[:2])
        hashes[name] = {"shape": list(frame.shape), "sha256": hashlib.sha256(frame.tobytes()).hexdigest()}
        print(f"wrote {path} ({len(buf)} bytes)")
    with open(PAIR_HASHES, "w") as f:
        json.dump(hashes, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    write_committed_files()
