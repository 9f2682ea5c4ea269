"""Lossless JPEG (SOF3) in the port's decoder (``ufm_torch/csrc/host/image_decode.h``)
against cv2, on the CPU.

The system libjpeg has no lossless encoder and nothing is downloaded, so the
files are written here by a small SOF3 encoder (:func:`encode_lossless`,
ITU T.81 Annex H: predictors 1-7, the point transform Pt, restart intervals,
interleaved and non-interleaved scans, sampling factors, Huffman tables of
the sample differences' categories). For each file:

- ``read_rgb`` equals ``cv2.imread(IMREAD_COLOR)`` (RGB order) and
  ``decode_rgb`` equals ``cv2.imdecode`` byte for byte, or both refuse where
  cv2 returns None;
- where the file's samples come out unchanged (three components, no colour
  transform), the decode is the encoded samples shifted by Pt: lossless
  needs no cv2 to check;
- the native loader's target (libjpeg-turbo 2.1, which has no lossless
  mode) keeps refusing SOF3.

Covered beyond the plain cases: one component (cv2's answer under
IMREAD_COLOR), a JFIF or Adobe marker (a colour transform or none),
subsampled components, restart intervals that do and do not line up with a
component's rows, arithmetic-coded lossless (SOF11), files cut short and
corrupt entropy data under ``imread``'s and ``imdecode``'s two answers.

``tests/golden/jpeg_lossless`` holds one file of this encoder (a 240x320
scene, predictor 5, a restart every two MCU rows) and its samples, which
chip_smoke.py decodes on the card's machine (no cv2 there);
``PYTHONPATH=. python tests/test_torch_port_jpeg_lossless.py`` rewrites them.
"""

import functools
import os
import struct

import cv2
import numpy as np
import pytest

# category -> (code, length): one length-5 code per category 0-16 (never all ones)
HUFF_BITS = [0] * 17
HUFF_BITS[5] = 17
HUFF_VALS = list(range(17))


def _dht(table_class_id: int) -> bytes:
    body = bytes([table_class_id]) + bytes(HUFF_BITS[1:]) + bytes(HUFF_VALS)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


class _Bits:
    """MSB-first bits with 0xFF stuffed by 0x00; a segment ends padded with ones."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _put_diff(bits: _Bits, diff: int) -> None:
    diff = ((diff + 32768) & 0xFFFF) - 32768  # modulo 2^16, as the decoder adds
    if diff == -32768:
        bits.put(16, 5)
        return
    s = abs(diff).bit_length()
    bits.put(s, 5)
    if s:
        bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)


def _predict(plane: np.ndarray, predictor: int, pt: int, reset_rows) -> np.ndarray:
    """The differences of a component's samples (already shifted by Pt) under
    a predictor: rows in ``reset_rows`` (the first, and each row a restart
    resets) take 2^(7-Pt) at their first sample and the sample to the left
    after it; the first column of the other rows the sample above."""
    x = plane.astype(np.int64)
    h, w = x.shape
    d = np.zeros_like(x)
    for r in range(h):
        for c in range(w):
            if r in reset_rows:
                p = (1 << (7 - pt)) if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, 0]
            else:
                ra, rb, rc = x[r, c - 1], x[r - 1, c], x[r - 1, c - 1]
                p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                     7: (ra + rb) >> 1}[predictor]
            d[r, c] = x[r, c] - p
    return d


def encode_lossless(planes, sampling=None, predictor=1, pt=0, restart=0, interleaved=True, ids=None,
                    app=b"", sof=0xC3, width=None, height=None):
    """A lossless JPEG file of uint8 component planes (each (rows, cols) of
    its own sampled size) with the frame's ``sampling`` factors ((h, v) per
    component), ``predictor`` 1-7, point transform ``pt``, a restart every
    ``restart`` MCUs (a multiple of an MCU row: 0 for none), one interleaved
    scan or one scan per component. ``app`` is put after SOI (a JFIF or
    Adobe marker). Restart resets are placed where libjpeg places them: at the
    first row of the iMCU row (max v rows of the image) in which a restart
    falls."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    if width is None:
        width = max(p.shape[1] * hmax // s[0] for p, s in zip(planes, sampling))
        height = max(p.shape[0] * vmax // s[1] for p, s in zip(planes, sampling))
    out = bytearray(b"\xff\xd8") + app
    out += _dht(0x00)
    sof_body = struct.pack(">BHHB", 8, height, width, n)
    for cid, (h, v) in zip(ids, sampling):
        sof_body += bytes([cid, h << 4 | v, 0])
    out += bytes([0xFF, sof]) + struct.pack(">H", 2 + len(sof_body)) + sof_body
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    shifted = [(p.astype(np.int64) >> pt) for p in planes]
    scans = [list(range(n))] if interleaved else [[i] for i in range(n)]
    for scan in scans:
        sos = bytes([len(scan)])
        for i in scan:
            sos += bytes([ids[i], 0x00])
        sos += bytes([predictor, 0, pt])
        out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
        if len(scan) > 1:
            mcux = -(-width // hmax)
            mcuy = -(-height // vmax)
            per_row = mcux
            imcu_rows = list(range(mcuy))
        else:
            h, v = sampling[scan[0]]
            per_row = planes[scan[0]].shape[1]
            imcu_rows = None
        # differences per component, with the resets of this scan's restarts
        diffs = {}
        for i in scan:
            h, v = sampling[i]
            rows = planes[i].shape[0]
            if len(scan) > 1:
                resets = {0} | {my * v for my in range(len(imcu_rows)) if restart and my and (my * per_row) % restart == 0}
            else:
                resets = {0} | {(r // v) * v for r in range(rows) if restart and r and (r * per_row) % restart == 0}
            diffs[i] = _predict(shifted[i], predictor, pt, resets)
        bits = _Bits()
        mcu = 0
        seq = 0

        def boundary():
            nonlocal seq, bits
            bits.flush()
            out.extend(bits.out)
            out.extend(bytes([0xFF, 0xD0 + seq % 8]))
            seq += 1
            bits = _Bits()

        if len(scan) > 1:
            for my in imcu_rows:
                for mx in range(per_row):
                    if restart and mcu and mcu % restart == 0:
                        boundary()
                    for i in scan:
                        h, v = sampling[i]
                        d = diffs[i]
                        for yy in range(v):
                            for xx in range(h):
                                r, c = my * v + yy, mx * h + xx
                                _put_diff(bits, int(d[r, c]) if r < d.shape[0] and c < d.shape[1] else 0)
                    mcu += 1
        else:
            d = diffs[scan[0]]
            for r in range(d.shape[0]):
                for c in range(d.shape[1]):
                    if restart and mcu and mcu % restart == 0:
                        boundary()
                    _put_diff(bits, int(d[r, c]))
                    mcu += 1
        bits.flush()
        out.extend(bits.out)
    out += b"\xff\xd9"
    return bytes(out)


# ---------------------------------------------------------------- the cases

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
H, W = 21, 30


def adobe(transform: int) -> bytes:
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


def exif(orientation: int) -> bytes:
    """An APP1 Exif marker whose IFD0 holds the Orientation tag alone."""
    tiff = b"MM\x00*\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00\x00\x01" + struct.pack(">H", orientation)
    body = b"Exif\x00\x00" + tiff + b"\x00\x00\x00\x00\x00\x00"
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _rgb(seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _planes(img):
    return [img[..., i] for i in range(img.shape[-1])]


def _sub420(seed, h=22, w=30):
    """A 2x2 / 1x1 / 1x1 sampled image's planes and the frame size."""
    rng = np.random.default_rng(seed)
    ch, cw = -(-h // 2), -(-w // 2)
    return ([rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, (ch, cw), dtype=np.uint8),
             rng.integers(0, 256, (ch, cw), dtype=np.uint8)], h, w)


# (predictor, Pt, restart interval in MCUs, interleaved): every predictor,
# with and without Pt, restarts and interleaving
PLAIN = [(p, pt, rst, inter) for p in range(1, 8)
         for pt, rst, inter in ((0, 0, True), (3, 30, True), (0, 30, False), (2, 60, False))]


def _plain(p, pt, rst, inter):
    img = _rgb(p)
    return encode_lossless(_planes(img), predictor=p, pt=pt, restart=rst, interleaved=inter), (img >> pt) << pt


@functools.lru_cache(maxsize=None)
def _other_cases():
    """name -> file bytes: colour markers, component counts, sampling,
    parameters cv2 refuses, cut and corrupt data."""
    img = _rgb(11)
    k = np.random.default_rng(12).integers(0, 256, (H, W), dtype=np.uint8)
    cases = {
        "jfif_ycbcr": encode_lossless(_planes(img), app=JFIF),
        "adobe_0_rgb": encode_lossless(_planes(img), predictor=3, app=adobe(0)),
        "adobe_1_ycbcr": encode_lossless(_planes(img), app=adobe(1)),
        "adobe_2_unknown": encode_lossless(_planes(img), app=adobe(2)),
        "ids_rgb": encode_lossless(_planes(img), predictor=4, ids=[82, 71, 66]),
        "ids_other": encode_lossless(_planes(img), predictor=5, ids=[5, 6, 7]),
        "exif_orientation_6": encode_lossless(_planes(img), predictor=2, restart=30, app=exif(6)),
        "gray": encode_lossless([img[..., 0]], predictor=2),
        "two_components": encode_lossless(_planes(img)[:2]),
        "cmyk": encode_lossless(_planes(img) + [k], predictor=6),
        "cmyk_adobe_0": encode_lossless(_planes(img) + [k], predictor=7, app=adobe(0)),
        "ycck_adobe_2": encode_lossless(_planes(img) + [k], app=adobe(2)),
        "sof11": encode_lossless(_planes(img), sof=0xCB),
        "restart_off_the_row": encode_lossless(_planes(img), restart=45),
    }
    for label, inter, rst in (("420", True, 15), ("420_rst", True, 30), ("420_separate", False, 30),
                              ("420_separate_restart_off_the_y_row", False, 15)):
        planes, h, w = _sub420(len(cases))
        cases[label] = encode_lossless(planes, sampling=[(2, 2), (1, 1), (1, 1)], predictor=6, restart=rst,
                                       interleaved=inter, width=w, height=h)
    planes, h, w = _sub420(30, 21, 31)
    cases["420_odd_size"] = encode_lossless(planes, sampling=[(2, 2), (1, 1), (1, 1)], predictor=4, restart=16,
                                            width=w, height=h)
    # a restart inside a 2-row iMCU row of a separate scan: libjpeg resets at the iMCU row's first row
    rng = np.random.default_rng(31)
    cases["separate_v2_restart_inside_imcu"] = encode_lossless(
        [rng.integers(0, 256, (22, 30), dtype=np.uint8), rng.integers(0, 256, (11, 30), dtype=np.uint8),
         rng.integers(0, 256, (11, 30), dtype=np.uint8)],
        sampling=[(1, 2), (1, 1), (1, 1)], predictor=5, restart=30, interleaved=False, width=30, height=22)
    for p in (0, 8):
        data = bytearray(encode_lossless(_planes(img)))
        data[data.index(b"\xff\xda") + 2 + 2 + 1 + 6] = p  # Ss
        cases[f"predictor_{p}"] = bytes(data)
    full = encode_lossless(_planes(img), predictor=2, restart=30)
    for cut in (len(full) // 3, len(full) // 2, len(full) - 2):
        cases[f"cut_{cut}"] = full[:cut]
    full = encode_lossless(_planes(img), predictor=7)
    cases["cut_no_restart"] = full[:len(full) // 2]
    for seed in range(4):
        rng = np.random.default_rng(seed)
        data = bytearray(encode_lossless(_planes(img), predictor=int(rng.integers(1, 8)),
                                         restart=int(rng.choice([0, 30])), pt=int(rng.integers(0, 3))))
        start = data.index(b"\xff\xda") + 14
        for j in rng.integers(start, len(data) - 2, 6):
            data[j] ^= int(rng.integers(1, 256))
        cases[f"corrupt_{seed}"] = bytes(data)
    return cases


OTHER = sorted(_other_cases())


@pytest.fixture(scope="module")
def built():
    """The host library, built once for the module."""
    from ufm_torch.ops import _build

    return _build.load_host_library("ufm_loader")


def _cv2_imdecode(data):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _cv2_imread(path):
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _check_as_cv2(data, tmp_path):
    """read_rgb as cv2.imread and decode_rgb as cv2.imdecode: equal bytes, or
    a ValueError where cv2 returns None. Returns cv2.imread's answer."""
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    path = tmp_path / "lossless.jpg"
    path.write_bytes(data)
    for port, want in ((lambda: read_rgb(str(path)), _cv2_imread(path)), (lambda: decode_rgb(data), _cv2_imdecode(data))):
        if want is None:
            with pytest.raises(ValueError):
                port()
        else:
            got = port()
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    return _cv2_imread(path)


@pytest.mark.parametrize("p,pt,rst,inter", PLAIN, ids=[f"p{p}_pt{pt}_rst{r}_{'int' if i else 'sep'}" for p, pt, r, i in PLAIN])
def test_lossless_decodes_as_cv2_and_gives_the_samples(built, tmp_path, p, pt, rst, inter):
    data, samples = _plain(p, pt, rst, inter)
    got = _check_as_cv2(data, tmp_path)
    np.testing.assert_array_equal(got, samples)


@pytest.mark.parametrize("name", OTHER)
def test_lossless_special_cases_as_cv2(built, tmp_path, name):
    got = _check_as_cv2(_other_cases()[name], tmp_path)
    if name == "exif_orientation_6":  # cv2.imread turns the frame: (W, H)
        assert got.shape == (W, H, 3)


def test_cv2_answers_of_the_special_cases(built):
    """What cv2 gives here, which the cases above hold the port to: None for
    a colour transform, gray under IMREAD_COLOR, SOF11, a bad predictor, a
    restart interval off the MCU row and a buffer cut before its EOI; an
    image for RGB, CMYK, subsampled files and a cut file read from disk."""
    cases = _other_cases()
    refused = {n for n, d in cases.items() if _cv2_imdecode(d) is None}
    assert refused == {"jfif_ycbcr", "adobe_1_ycbcr", "adobe_2_unknown", "gray", "two_components", "ycck_adobe_2",
                       "sof11", "restart_off_the_row", "420_separate_restart_off_the_y_row", "predictor_0",
                       "predictor_8",
                       *(n for n in cases if n.startswith("cut_"))}


def test_the_native_loader_keeps_refusing_lossless(built, tmp_path):
    """kRgb is libjpeg-turbo 2.1's decode, which has no lossless mode: the
    native loader reports the file as undecodable, as the JAX package's
    loader does."""
    from ufm_torch.runtime.loader import NativeImageLoader

    path = tmp_path / "lossless.jpg"
    path.write_bytes(_plain(1, 0, 0, True)[0])
    with NativeImageLoader((H, W), num_threads=1) as loader:
        loader.submit(1, str(path))
        _, frame = loader.poll()
    assert frame is None


# ---------------------------------------------------------------- the committed file

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "jpeg_lossless")
COMMITTED = ("lossless_p5_rst.jpg", "samples.npz")


def committed_case():
    """The committed file's samples (a smooth seeded scene with noise) and bytes."""
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:240, 0:320].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / 37) * np.cos(y / 53), 128 + 80 * np.cos(y / 41 - x / 67),
                    128 + 70 * np.sin((x + 2 * y) / 59)], axis=-1) + rng.normal(0.0, 6.0, (240, 320, 3))
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img, encode_lossless(_planes(img), predictor=5, restart=640)


def test_committed_file_is_the_encoders_and_decodes_to_its_samples(built):
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    img, data = committed_case()
    path = os.path.join(GOLDEN, COMMITTED[0])
    with open(path, "rb") as f:
        assert f.read() == data
    with np.load(os.path.join(GOLDEN, COMMITTED[1])) as z:
        np.testing.assert_array_equal(z["rgb"], img)
    np.testing.assert_array_equal(read_rgb(path), img)
    np.testing.assert_array_equal(decode_rgb(data), img)
    np.testing.assert_array_equal(_cv2_imread(path), img)


def write_committed_files():
    img, data = committed_case()
    os.makedirs(GOLDEN, exist_ok=True)
    with open(os.path.join(GOLDEN, COMMITTED[0]), "wb") as f:
        f.write(data)
    np.savez_compressed(os.path.join(GOLDEN, COMMITTED[1]), rgb=img)
    print(f"wrote {COMMITTED[0]} ({len(data)} bytes) and its samples to {GOLDEN}")


if __name__ == "__main__":
    write_committed_files()
