"""Image files without an image library: PNG read and written with ``zlib``
and numpy, JPEG read by the port's own decoder.

The reader gives what ``cv2.imread`` gives for the same file, bit for bit,
in RGB order: colour type 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha)
and 6 (RGBA) at every bit depth PNG allows, every row filter, any number of
IDAT chunks. Gray is replicated into three channels, alpha (and a palette's
transparency) is dropped, a 16-bit file keeps its 16 bits with ``anydepth``
(``cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR``, KITTI flow) and is cut to its
high byte without it (``cv2.IMREAD_COLOR``), and gray below 8 bits is scaled
to 0..255. Adam7-interlaced files raise, naming the file. The writer writes
8-bit RGB and 16-bit three-channel files.

JPEG goes to the decoder of the port's host library
(``ufm_torch/csrc/host/image_decode.h`` through ``ufm_image_decode`` of
``ufm_loader.cc``, built at first use): bit for bit what ``cv2.imdecode``
with ``IMREAD_COLOR`` gives for bytes (:func:`decode_rgb`), and what
``cv2.imread`` gives for a file (:func:`read_rgb`), in RGB order, the EXIF
orientation applied and CMYK converted as OpenCV converts it; Huffman and
arithmetic coding, baseline and progressive, an incomplete progressive image
block-smoothed as libjpeg smooths it. The two differ where the data ends
before its EOI marker: ``cv2.imread`` decodes such a file (the rest of the
image gray, or smoothed), ``cv2.imdecode`` returns None, and
:func:`decode_rgb` refuses it. A JPEG it refuses (lossless, hierarchical,
12-bit, cut short in bytes, ...) raises ``ValueError`` naming the file and
why; a JPEG never reaches ``cv2``.

Other formats (BMP, TIFF, WebP, ...) go through ``cv2`` in :func:`read_rgb`
and :func:`decode_rgb`, which raise ``ImportError`` naming it where it is not
installed: the split is by file format.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["PNG_SIGNATURE", "is_png", "is_jpeg", "decode_png", "decode_jpeg", "read_png", "write_png", "read_rgb",
           "decode_rgb"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel, by colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def is_png(data: bytes) -> bool:
    """Whether ``data`` starts with the PNG signature."""
    return bytes(data[:8]) == PNG_SIGNATURE


def is_jpeg(data: bytes) -> bool:
    """Whether ``data`` starts with JPEG's SOI marker."""
    return bytes(data[:2]) == b"\xff\xd8"


def _chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's row filters. ``raw`` (H, N, bpp) filtered bytes, N
    filtering units (pixels, or bytes below 8 bits a pixel) a row;
    ``filters`` (H,) the rows' filter types. A None, Sub or Up row is one
    numpy step (Sub: a running sum along the row, in uint8 so it wraps
    mod 256); a run of Average / Paeth rows goes to :func:`_unfilter_run`."""
    h = raw.shape[0]
    out = np.empty_like(raw)
    above = np.zeros_like(raw[0])
    r = 0
    while r < h:
        f = filters[r]
        if f == 0:
            out[r] = raw[r]
        elif f == 1:
            np.cumsum(raw[r], axis=0, dtype=np.uint8, out=out[r])
        elif f == 2:
            np.add(raw[r], above, out=out[r])
        else:
            end = r + 1
            while end < h and filters[end] >= 3:
                end += 1
            out[r:end] = _unfilter_run(raw[r:end], filters[r:end], above)
            r = end
            above = out[r - 1]
            continue
        above = out[r]
        r += 1
    return out


def _unfilter_run(raw: np.ndarray, filters: np.ndarray, above: np.ndarray) -> np.ndarray:
    """Undo Average (3) and Paeth (4) filters on K consecutive rows ``raw``
    (K, N, bpp) below the decoded row ``above`` (N, bpp). A unit depends on
    its left neighbour, the one above and the one above-left, so the units
    of one anti-diagonal are decoded together: K + N - 1 numpy steps. The
    rows are held skewed, ``d[i + j, i]`` for unit (i, j) of the run padded
    with ``above`` as row 0 and a zero column 0, so that a diagonal's
    neighbours are slices of the two diagonals before it."""
    k, n, bpp = raw.shape
    i, j = np.meshgrid(np.arange(1, k + 1), np.arange(1, n + 1), indexing="ij")
    x = np.zeros((k + n + 1, k + 1, bpp), np.int16)
    x[i + j, i] = raw
    d = np.zeros_like(x)
    d[np.arange(1, n + 1), 0] = above
    average = np.zeros(k + 1, bool)
    average[1:] = filters == 3
    average = average[:, None]
    for t in range(2, k + n + 1):
        lo, hi = max(1, t - n), min(k, t - 1) + 1
        left, up, up_left = d[t - 1, lo:hi], d[t - 1, lo - 1:hi - 1], d[t - 2, lo - 1:hi - 1]
        pa, pb, pc = np.abs(up - up_left), np.abs(left - up_left), np.abs(left + up - 2 * up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        pred = np.where(average[lo:hi], (left + up) >> 1, paeth)
        d[t, lo:hi] = (x[t, lo:hi] + pred) & 0xFF
    return d[i + j, i].astype(np.uint8)


def decode_png(data: bytes, anydepth: bool = False, name: str = "<png data>") -> np.ndarray:
    """A PNG file's bytes -> (H, W, 3) RGB: uint8, or uint16 for a 16-bit
    file when ``anydepth``; bit for bit ``cv2.imdecode`` (``IMREAD_COLOR``,
    with ``anydepth`` ``IMREAD_ANYDEPTH | IMREAD_COLOR``) in RGB order."""
    data = bytes(data)
    if not is_png(data):
        raise ValueError(f"{name}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression or filter_method:
        raise ValueError(f"{name}: unsupported PNG header (colour type {ctype}, bit depth {depth})")
    if interlace:
        raise ValueError(f"{name}: Adam7-interlaced PNG files are not supported")
    if w == 0 or h == 0:
        raise ValueError(f"{name}: empty image ({w} x {h})")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    try:
        rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    if rows.size < h * (stride + 1):
        raise ValueError(f"{name}: image data too short")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    if rows[:, 0].max() > 4:
        raise ValueError(f"{name}: unknown row filter type {int(rows[:, 0].max())}")
    flat = _unfilter(rows[:, 1:].reshape(h, stride // bpp, bpp), rows[:, 0], bpp).reshape(h, stride)

    if depth == 16:
        samples = flat.view(">u2").astype(np.uint16).reshape(h, w, channels)
    elif depth == 8:
        samples = flat.reshape(h, w, channels)
    else:  # 1, 2 or 4 bits: the samples of a byte, most significant first
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        unpacked = (flat[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = unpacked.reshape(h, stride * per_byte)[:, :w, None]
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette image without a PLTE chunk")
        index = samples[..., 0]
        if index.max() >= len(palette):
            raise ValueError(f"{name}: palette index {int(index.max())} past the {len(palette)}-entry palette")
        return palette[index]
    if ctype in (0, 4):
        gray = samples[..., :1]
        if depth < 8:
            gray = (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)
        rgb = np.repeat(gray, 3, axis=2)
    else:
        rgb = samples[..., :3]
    if depth == 16 and not anydepth:
        rgb = (rgb >> 8).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def read_png(path: str, anydepth: bool = False) -> np.ndarray:
    """:func:`decode_png` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), anydepth=anydepth, name=str(path))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 or uint16 RGB array to ``path`` as an 8-bit
    RGB or 16-bit three-channel PNG (filter 0 on every row, one IDAT chunk)."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype not in (np.uint8, np.uint16) or 0 in rgb.shape:
        raise ValueError(f"write_png takes a non-empty (H, W, 3) uint8 or uint16 array, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    depth = 8 * rgb.dtype.itemsize
    body = np.ascontiguousarray(rgb.astype(">u2") if depth == 16 else rgb).view(np.uint8).reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    data = (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _decoder():
    import ctypes

    from ufm_torch.ops import _build

    lib = _build.load_host_library("ufm_loader")
    lib.ufm_image_decode.restype = ctypes.c_int
    lib.ufm_image_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
    return lib.ufm_image_decode


def decode_jpeg(data: bytes, name: str = "<jpeg data>", from_file: bool = False) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) RGB uint8, bit for bit
    ``cv2.imdecode(..., IMREAD_COLOR)`` in RGB order (with ``from_file``:
    ``cv2.imread`` of a file holding ``data``), by the port's own decoder:
    the size from the headers (EXIF orientation applied), then the pixels.
    Raises ``ValueError`` naming ``name`` and why for a file it refuses."""
    import ctypes

    decode = _decoder()
    data = bytes(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if decode(data, len(data), ctypes.byref(h), ctypes.byref(w), None, err, len(err), from_file) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if decode(data, len(data), ctypes.byref(h), ctypes.byref(w), out.ctypes.data, err, len(err), from_file) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _cv2(what: str):
    try:
        import cv2
    except ImportError:
        raise ImportError(f"{what} is neither PNG nor JPEG: reading it needs cv2 (opencv-python), which is not "
                          "installed") from None
    return cv2


def decode_rgb(data: bytes, name: str = "<image data>", from_file: bool = False) -> np.ndarray:
    """An image file's bytes -> (H, W, 3) RGB uint8: PNG by :func:`decode_png`,
    JPEG by :func:`decode_jpeg` (``from_file``: as ``cv2.imread`` reads the
    file), any other format by ``cv2.imdecode``."""
    if is_png(data):
        return decode_png(data, name=name)
    if is_jpeg(data):
        return decode_jpeg(data, name=name, from_file=from_file)
    cv2 = _cv2(name)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"{name}: not a decodable image")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def read_rgb(path: str) -> np.ndarray:
    """The image at ``path`` as (H, W, 3) RGB uint8 (:func:`decode_rgb`, a JPEG
    as ``cv2.imread`` reads it). Raises FileNotFoundError for a missing file."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such image file: {path}")
    with open(path, "rb") as f:
        return decode_rgb(f.read(), name=str(path), from_file=True)
