"""The port's JPEG decoder (``ufm_torch/csrc/host/image_decode.h``,
``jpeg_arith.h``) on what ``test_torch_port_jpeg.py``'s cases leave out,
against the JAX package's loader (libjpeg-turbo 2.1) and cv2 (libjpeg-turbo
3.1), on the CPU.

- Arithmetic coding: the committed cases (``tests/golden/jpeg_arith_cases``:
  sequential and progressive, 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 / 4:1:1 and gray,
  restart intervals, DAC conditioning other than the default) through the
  loader bitwise the JAX loader (live, and its committed decode), through
  ``read_rgb`` / ``decode_rgb`` bitwise ``cv2.imread`` (live and committed).
- Block smoothing: complete progressive files whose scan scripts stop early
  (Huffman and arithmetic, DC only and before the last refinement), and every
  committed progressive case cut inside each of its scans: the loader bitwise
  the JAX loader, ``read_rgb`` bitwise ``cv2.imread`` (the two libraries
  take different neighbour rows at v = 2: both are held).
- Data that ends before its EOI marker: ``cv2.imread`` decodes it (libjpeg's
  stdio source fakes an EOI) and ``cv2.imdecode`` returns None (its buffer
  source cannot refill). ``read_rgb`` does the first and ``decode_rgb`` the
  second, over every damaged JPEG of ``test_torch_port_jpeg.py`` and the cut
  files; a JSON request carrying such a file is a 400 naming its key, as the
  JAX package's server refuses it.
- Lossless (SOF11) and hierarchical (SOF13) arithmetic files are refused,
  naming them, where libjpeg and cv2 refuse them.
- The 1080x1920 pair transcoded to arithmetic coding
  (``tests/golden/jpeg_pair_arith``, the DCT coefficients unchanged) decodes
  to the Huffman pair's SHA-256s; frame 1 cut inside its AC scans decodes to
  libjpeg's smoothed SHA-256 (what chip_smoke checks on the card's host).
- Tiny UFM-Base on the port's decode of an arithmetic pair against the JAX
  package's model on ``cv2.imread`` of the same files (atol 1e-4).

``PYTHONPATH=. python tests/test_torch_port_jpeg_arith.py`` writes the committed
files; it compiles ``WRITER_C`` against the system libjpeg (with arithmetic
coding) to write them. Nothing here needs that compiler otherwise.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jpeg import (  # noqa: E402
    CASES, DAMAGED, PAIR, PAIR_FILES, PAIR_HASHES, SAMPLING, _jax_frame, _port_frame, _read, _stored_hw,
    corrupt_cases, scene)
from test_torch_port_jpeg import _cv2_rgb as _cv2_imdecode  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ARITH = os.path.join(GOLDEN, "jpeg_arith_cases")
ARITH_DECODES = os.path.join(ARITH, "decodes.npz")
ARITH_PAIR = os.path.join(GOLDEN, "jpeg_pair_arith")
ARITH_PAIR_CUT = os.path.join(ARITH_PAIR, "cut.json")
ATOL = 1e-4  # tests/test_torch_port_model.py's fp32 bar

# (file, size (h, w), options): arith (else Huffman), sampling (cv2's names)
# or gray, rst (MCUs), prog, dac (DC L, DC U, AC K of every table), stop (keep
# the first ``stop`` scans of libjpeg's standard progressive script)
ARITH_SPECS = (
    ("a444_seq_rst.jpg", (61, 83), dict(arith=True, sampling="444", rst=2)),
    ("a444_prog.jpg", (61, 83), dict(arith=True, sampling="444", prog=True)),
    ("a422_seq.jpg", (61, 83), dict(arith=True, sampling="422")),
    ("a422_prog_rst.jpg", (61, 83), dict(arith=True, sampling="422", prog=True, rst=3)),
    ("a420_seq_dac.jpg", (61, 83), dict(arith=True, sampling="420", dac=(1, 4, 2))),
    ("a420_prog_rst_dac.jpg", (61, 83), dict(arith=True, sampling="420", prog=True, rst=2, dac=(3, 9, 20))),
    ("a440_seq_rst.jpg", (61, 83), dict(arith=True, sampling="440", rst=1)),
    ("a440_prog.jpg", (61, 83), dict(arith=True, sampling="440", prog=True)),
    ("a411_seq.jpg", (61, 83), dict(arith=True, sampling="411")),
    ("a411_prog_dac.jpg", (61, 83), dict(arith=True, sampling="411", prog=True, dac=(0, 0, 63))),
    ("agray_seq_rst.jpg", (45, 67), dict(arith=True, gray=True, rst=4)),
    ("agray_prog.jpg", (45, 67), dict(arith=True, gray=True, prog=True)),
    ("a420_prog_stop9.jpg", (61, 83), dict(arith=True, sampling="420", prog=True, stop=9)),
    ("a422_prog_dc_only.jpg", (61, 83), dict(arith=True, sampling="422", prog=True, stop=1)),
    ("h420_prog_stop9.jpg", (61, 83), dict(sampling="420", prog=True, stop=9)),
    ("h440_prog_stop5.jpg", (61, 83), dict(sampling="440", prog=True, stop=5)),
    ("h444_prog_dc_only.jpg", (61, 83), dict(sampling="444", prog=True, stop=1)),
    ("hgray_prog_stop2.jpg", (45, 67), dict(gray=True, prog=True, stop=2)),
)
ARITH_NAMES = [c[0] for c in ARITH_SPECS]
PROGRESSIVE = (["s444_prog.jpg", "s420_prog.jpg", "s422_prog_rst.jpg", "s411_prog_rst.jpg", "s440_prog.jpg",
                "exif6.jpg"] + [n for n, _, o in ARITH_SPECS if o.get("prog") and not o.get("stop")])
DAMAGED_JPEG = [n for n in DAMAGED if not n.startswith("png_")]

# A writer of JPEG files through libjpeg's compressor (needs jpeglib.h and a
# libjpeg built with arithmetic coding):
#   writer enc RAW OUT W H NCOMP HV QUALITY RST PROG ARITH DC_L DC_U AC_K STOP
#     RAW: H * W * NCOMP bytes; HV: the first component's sampling (h << 4 | v),
#     the others 1x1; STOP > 0 keeps the first STOP scans of the progressive script
#   writer arith IN OUT PROG
#     IN's DCT coefficients written with arithmetic coding, as jpegtran
#     -arithmetic [-progressive] writes them
WRITER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

static int enc(char **a) {
  int w = atoi(a[2]), h = atoi(a[3]), nc = atoi(a[4]), hv = (int)strtol(a[5], 0, 0);
  size_t n = (size_t)w * h * nc;
  unsigned char *px = malloc(n);
  FILE *fi = fopen(a[0], "rb"), *fo = fopen(a[1], "wb");
  if (!px || !fi || !fo || fread(px, 1, n, fi) != n) return 1;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, fo);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(a[6]), TRUE);
  c.comp_info[0].h_samp_factor = nc == 1 ? 1 : hv >> 4;
  c.comp_info[0].v_samp_factor = nc == 1 ? 1 : hv & 15;
  c.restart_interval = atoi(a[7]);
  c.arith_code = atoi(a[9]);
  for (int i = 0; i < 16; i++) {
    c.arith_dc_L[i] = atoi(a[10]);
    c.arith_dc_U[i] = atoi(a[11]);
    c.arith_ac_K[i] = atoi(a[12]);
  }
  if (atoi(a[8])) jpeg_simple_progression(&c);
  if (atoi(a[13]) > 0 && atoi(a[13]) < c.num_scans) c.num_scans = atoi(a[13]);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(fo);
  return 0;
}

static int arith(char **a) {
  FILE *fi = fopen(a[0], "rb"), *fo = fopen(a[1], "wb");
  if (!fi || !fo) return 1;
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr ed, ec;
  d.err = jpeg_std_error(&ed);
  jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, fi);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&ec);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, fo);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = TRUE;
  c.optimize_coding = FALSE;
  if (atoi(a[2])) jpeg_simple_progression(&c);
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  fclose(fo);
  return 0;
}

int main(int argc, char **argv) {
  if (argc == 16 && argv[1][0] == 'e') return enc(argv + 2);
  if (argc == 5 && argv[1][0] == 'a') return arith(argv + 2);
  fprintf(stderr, "usage: writer enc RAW OUT W H NCOMP HV QUALITY RST PROG ARITH DC_L DC_U AC_K STOP\n"
                  "       writer arith IN OUT PROG\n");
  return 2;
}
"""
_HV = {"444": 0x11, "422": 0x21, "420": 0x22, "411": 0x41, "440": 0x12}
assert {k: SAMPLING[k] >> 16 for k in _HV} == _HV  # cv2's names, the first component's factors


def _cv2_imread(path):
    import cv2

    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _port(fn, *args, **kw):
    """``fn(*args)``, or None where it raises ValueError (a refused file)."""
    try:
        return fn(*args, **kw)
    except ValueError:
        return None


def _same(got, want):
    return (got is None and want is None) or (got is not None and want is not None and np.array_equal(got, want))


def _scan_starts(data):
    """Offsets of the SOS markers, and the file's length."""
    return [i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA] + [len(data)]


def _cuts(data):
    """``data`` cut a third and two thirds into each scan's entropy data."""
    starts = _scan_starts(data)
    out = []
    for s in range(len(starts) - 1):
        body = starts[s] + 2 + (data[starts[s] + 2] << 8 | data[starts[s] + 3])
        for frac in (1 / 3, 2 / 3):
            out.append(data[:body + int((starts[s + 1] - body) * frac)])
    return out


def _case(name):
    with open(os.path.join(ARITH if name in ARITH_NAMES else CASES, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def built():
    from ufm_torch.ops import _build

    return _build.load_host_library("ufm_loader")


@pytest.fixture(scope="module")
def stored():
    with np.load(ARITH_DECODES) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------- arithmetic coding

@pytest.mark.parametrize("name", ARITH_NAMES)
def test_loader_matches_the_jax_loader(built, stored, name):
    path = os.path.join(ARITH, name)
    want = stored[f"libjpeg/{name}"]
    got = _port_frame(path, want.shape[:2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_frame(path, want.shape[:2]))


@pytest.mark.parametrize("name", ARITH_NAMES)
def test_read_rgb_matches_cv2(built, stored, name):
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    path = os.path.join(ARITH, name)
    got = read_rgb(path)
    np.testing.assert_array_equal(got, stored[f"cv2/{name}"])
    np.testing.assert_array_equal(got, _cv2_imread(path))
    np.testing.assert_array_equal(decode_rgb(_case(name)), got)


def test_committed_cases_are_what_they_say(stored):
    """Each file's SOF marker is SOF9 / SOF10 (arithmetic) or SOF2, its DAC
    markers carry the options, and the early-stopping scripts are short."""
    assert sorted(k for k in stored if k.startswith("cv2/")) == sorted(f"cv2/{n}" for n in ARITH_NAMES)
    for name, hw, opts in ARITH_SPECS:
        data = _case(name)
        assert len(data) <= 8 * 1024, name
        kind = bool(opts.get("arith")), bool(opts.get("prog"))
        sof = {(True, False): 0xC9, (True, True): 0xCA, (False, True): 0xC2}[kind]
        assert bytes([0xFF, sof]) in data, name
        assert (b"\xff\xcc" in data) == bool(opts.get("arith")), name
        if opts.get("arith"):  # every DAC marker's (table, value) pairs
            pairs = {}
            for at in (i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xcc"):
                n = data[at + 2] << 8 | data[at + 3]
                pairs.update(zip(data[at + 4:at + 2 + n:2], data[at + 5:at + 2 + n:2]))
            lo, up, k = opts.get("dac", (0, 1, 5))
            assert pairs[0] == up << 4 | lo and pairs.get(16, k) == k, (name, pairs)
            assert (16 in pairs) == (opts.get("stop") != 1), (name, pairs)  # a DC-only file codes no AC
        scans = len(_scan_starts(data)) - 1
        assert scans == (opts.get("stop") or (10 if opts.get("prog") and not opts.get("gray") else
                                               6 if opts.get("prog") else 1)), (name, scans)
        assert stored[f"cv2/{name}"].shape == (*hw, 3)


def test_huffman_data_under_an_arithmetic_sof_decodes_as_libjpeg_does(built, tmp_path):
    """A Huffman file whose SOF0 says SOF9: the data decodes as arithmetic
    (garbage, no error), the same in the loader and the JAX loader, and in
    read_rgb and cv2."""
    from ufm_torch.utils.image_io import decode_rgb

    data = bytearray(_read("s420_base_rst_opt.jpg"))
    data[data.index(b"\xff\xc0") + 1] = 0xC9
    path = tmp_path / "sof9.jpg"
    path.write_bytes(bytes(data))
    hw = (117, 157)
    got, want = _port_frame(path, hw), _jax_frame(path, hw)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_rgb(bytes(data)), _cv2_imdecode(bytes(data)))


def test_half_a_progressive_file_decodes_as_libjpeg_and_cv2_imread(built, tmp_path):
    """The first half of s420_prog.jpg (refused before arithmetic coding and
    smoothing were ported): the loader bitwise the JAX loader, ``read_rgb``
    bitwise ``cv2.imread``, ``decode_rgb`` refused where ``cv2.imdecode``
    returns None."""
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    data = _read("s420_prog.jpg")
    data = data[:len(data) // 2]
    path = tmp_path / "half.jpg"
    path.write_bytes(data)
    got, want = _port_frame(path, (117, 157)), _jax_frame(path, (117, 157))
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_rgb(str(path)), _cv2_imread(path))
    assert _cv2_imdecode(data) is None
    with pytest.raises(ValueError, match="half.jpg: premature end"):
        decode_rgb(data, name="half.jpg")


@pytest.mark.parametrize("marker,words", [(0xCB, "lossless"), (0xCD, "hierarchical"), (0xCE, "hierarchical"),
                                          (0xCF, "hierarchical")], ids=["SOF11", "SOF13", "SOF14", "SOF15"])
def test_lossless_and_hierarchical_arithmetic_are_refused(built, tmp_path, marker, words):
    """SOF11 (arithmetic lossless) as cv2 answers it, None, and the loader as
    the JAX package's; the hierarchical markers refused as before."""
    from ufm_torch.utils.image_io import decode_rgb

    data = bytearray(_case("a420_seq_dac.jpg"))
    data[data.index(b"\xff\xc9") + 1] = marker
    data = bytes(data)
    path = tmp_path / "refused.jpg"
    path.write_bytes(data)
    assert _jax_frame(path, (61, 83)) is None and _port_frame(path, (61, 83)) is None
    assert _cv2_imdecode(data) is None
    with pytest.raises(ValueError, match=f"request.jpg: .*{words}"):
        decode_rgb(data, name="request.jpg")


# ---------------------------------------------------------------- block smoothing

@pytest.mark.parametrize("name", PROGRESSIVE)
def test_cut_progressive_files_smooth_as_libjpeg(built, tmp_path, name):
    """Cut inside each scan: the loader bitwise the JAX loader (2.1's
    smoothing), ``read_rgb`` bitwise ``cv2.imread`` (3.1's), ``decode_rgb``
    refusing where ``cv2.imdecode`` does (everywhere)."""
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    data = _case(name)
    hw = _stored_hw(data)
    failed = []
    for i, cut in enumerate(_cuts(data)):
        path = tmp_path / f"cut{i}.jpg"
        path.write_bytes(cut)
        if not _same(_port_frame(path, hw), _jax_frame(path, hw)):
            failed.append(f"loader at {len(cut)}")
        if not _same(_port(read_rgb, str(path)), _cv2_imread(path)):
            failed.append(f"read_rgb at {len(cut)}")
        assert _cv2_imdecode(cut) is None
        if _port(decode_rgb, cut) is not None:
            failed.append(f"decode_rgb at {len(cut)}")
    assert not failed, failed


def test_smoothed_cases_differ_from_the_unsmoothed(built, stored):
    """The early-stopping files are smoothed: 2.1's and 3.1's decodes differ
    at v = 2 (h420: neighbour rows) and agree at v = 1."""
    assert not np.array_equal(stored["libjpeg/h420_prog_stop9.jpg"], stored["cv2/h420_prog_stop9.jpg"])
    np.testing.assert_array_equal(stored["libjpeg/h444_prog_dc_only.jpg"], stored["cv2/h444_prog_dc_only.jpg"])


# ---------------------------------------------------------------- data that ends early

@pytest.mark.parametrize("name", DAMAGED_JPEG)
def test_damaged_jpegs_as_cv2_reads_them(built, tmp_path, name):
    """``read_rgb`` as ``cv2.imread`` (a cut file decodes, the rest gray),
    ``decode_rgb`` as ``cv2.imdecode`` (a cut file is None: refused)."""
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    data = corrupt_cases()[name]
    path = tmp_path / name
    path.write_bytes(data)
    assert _same(_port(read_rgb, str(path)), _cv2_imread(path))
    assert _same(_port(decode_rgb, data), _cv2_imdecode(data))


@pytest.mark.parametrize("name", ["a420_prog_rst_dac.jpg", "a411_seq.jpg", "agray_seq_rst.jpg", "a440_seq_rst.jpg"])
def test_cut_arithmetic_files(built, tmp_path, name):
    """Arithmetic files cut at tenths of their length and one byte short:
    the loader bitwise the JAX loader, ``read_rgb`` bitwise ``cv2.imread``,
    ``decode_rgb`` refused as ``cv2.imdecode`` refuses."""
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    data = _case(name)
    hw = _stored_hw(data)
    failed = []
    for n in sorted({len(data) * k // 10 for k in range(1, 10)} | {len(data) - 1}):
        cut = data[:n]
        path = tmp_path / f"cut{n}.jpg"
        path.write_bytes(cut)
        if not _same(_port_frame(path, hw), _jax_frame(path, hw)):
            failed.append(f"loader at {n}")
        if not _same(_port(read_rgb, str(path)), _cv2_imread(path)):
            failed.append(f"read_rgb at {n}")
        if not _same(_port(decode_rgb, cut), _cv2_imdecode(cut)):
            failed.append(f"decode_rgb at {n}")
    assert not failed, failed


def _edited(name, edits):
    data = bytearray(_case(name))
    for at, value in edits:
        data[at] = value
    return bytes(data)


def _hold_three_ways(tmp_path, data, hw):
    """The loader against the JAX loader, ``read_rgb`` against
    ``cv2.imread``, ``decode_rgb`` against ``cv2.imdecode``: the readers that
    differ (None: refused) from their reference."""
    from ufm_torch.utils.image_io import decode_rgb, read_rgb

    path = tmp_path / "case.jpg"
    path.write_bytes(data)
    differ = []
    if not _same(_port_frame(path, hw), _jax_frame(path, hw)):
        differ.append("loader")
    if not _same(_port(read_rgb, str(path)), _cv2_imread(path)):
        differ.append("read_rgb")
    if not _same(_port(decode_rgb, data), _cv2_imdecode(data)):
        differ.append("decode_rgb")
    return differ


# damaged files where the libraries part ways: (file, (offset, new byte)...,
# what the loader / cv2 give)
EDITED = {
    # a progressive scan's Huffman table lost with its marker: libjpeg's
    # progressive decoder installs no standard tables, both refuse
    "progressive_table_lost": ("h420_prog_stop9.jpg", ((177, 0x78),), (None, None)),
    # the byte after SOI not FF: libjpeg skips to the next marker, OpenCV
    # takes the file for no JPEG at all
    "no_marker_after_soi": ("a422_prog_dc_only.jpg", ((2, 0x38),), ("frame", None)),
    # a sequential file's RST7 made FF F8: libjpeg's jpeg_finish_decompress
    # fails on the marker after the scan, which cv2 (image in hand) ignores
    "bad_marker_after_single_scan": ("a444_seq_rst.jpg", ((1991, 0xF8),), (None, "frame")),
    # an AC scan naming DC table 14: only the tables a scan uses are checked
    "unused_dc_table_index": ("h420_prog_stop9.jpg", ((834, 0xE0),), ("frame", "frame")),
}


@pytest.mark.parametrize("case", sorted(EDITED))
def test_damaged_headers_as_libjpeg_and_cv2(built, tmp_path, case):
    name, edits, (loader, cv2_gives) = EDITED[case]
    data = _edited(name, edits)
    hw = _stored_hw(_case(name))
    path = tmp_path / "edited.jpg"
    path.write_bytes(data)
    assert (_jax_frame(path, hw) is None) == (loader is None)
    assert (_cv2_imread(path) is None) == (cv2_gives is None)
    assert not _hold_three_ways(tmp_path, data, hw)


@pytest.mark.parametrize("name", ["a420_prog_rst_dac.jpg", "a440_seq_rst.jpg", "h440_prog_stop5.jpg",
                                  "s422_prog_rst.jpg"])
def test_random_byte_edits_as_libjpeg_and_cv2(built, tmp_path, name):
    """Twelve seeded edits of 1-3 bytes each, anywhere past SOI (headers,
    tables, entropy data, markers): all three readers as their references."""
    data = _case(name)
    hw = _stored_hw(data)
    rng = np.random.default_rng(sum(data[:64]))
    failed = []
    for i in range(12):
        count = int(rng.integers(1, 4))
        edits = [(int(rng.integers(2, len(data) - 2)), int(rng.integers(0, 256))) for _ in range(count)]
        differ = _hold_three_ways(tmp_path, _edited(name, edits), hw)
        if differ:
            failed.append((edits, differ))
    assert not failed, failed


def test_cut_files_with_an_eoi_decode_in_both(built):
    """What ``cv2.imdecode`` refuses is data that ends before its EOI
    marker: the same cuts with FF D9 appended decode, bitwise cv2."""
    from ufm_torch.utils.image_io import decode_rgb

    for name in ("s420_base_rst_opt.jpg", "s440_prog.jpg", "a420_prog_rst_dac.jpg", "a411_seq.jpg"):
        data = _case(name)
        for cut in (data[:len(data) // 2], data[:len(data) * 4 // 5]):
            want = _cv2_imdecode(cut + b"\xff\xd9")
            assert want is not None, name
            np.testing.assert_array_equal(decode_rgb(cut + b"\xff\xd9"), want, err_msg=name)


def test_served_json_with_a_cut_jpeg_is_a_400(built):
    """A JSON request whose source is a cut JPEG: the port's server answers
    400 naming the key, where the JAX package's request decoder refuses the
    same body (cv2.imdecode gives None); the whole file is answered."""
    import base64
    import urllib.error
    import urllib.request

    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.runtime import UFMServer
    from ufm_tpu.runtime.server import _decode_request as jax_decode_request

    whole = _case("s420_prog.jpg")
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    srv = UFMServer(model, port=0, max_batch=1, max_delay_ms=1.0)
    srv.start()
    try:
        for source, code in ((whole[:len(whole) * 9 // 10], 400), (whole, 200)):
            body = json.dumps({"source_png_b64": base64.b64encode(source).decode(),
                               "target_png_b64": base64.b64encode(whole).decode()}).encode()
            req = urllib.request.Request(f"http://{srv.host}:{srv.port}/v1/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            if code == 400:
                with pytest.raises(ValueError, match="source_png_b64"):
                    jax_decode_request(body, "application/json")
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req, timeout=60)
                assert e.value.code == 400
                error = json.loads(e.value.read())["error"]
                assert "source_png_b64" in error and "EOI" in error, error
            else:
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert r.status == 200
    finally:
        srv.close()


# ---------------------------------------------------------------- the 1080x1920 pair

def test_arith_pair_decodes_to_the_huffman_hashes(built):
    with open(PAIR_HASHES) as f:
        hashes = json.load(f)
    for name, sof in zip(PAIR_FILES, (b"\xff\xc9", b"\xff\xca")):
        path = os.path.join(ARITH_PAIR, name)
        with open(path, "rb") as f:
            assert sof in f.read(), name
        frame = _port_frame(path, (1080, 1920))
        assert hashlib.sha256(frame.tobytes()).hexdigest() == hashes[name]["sha256"], name
    size = sum(os.path.getsize(os.path.join(ARITH_PAIR, n)) for n in PAIR_FILES)
    assert size <= 1024 * 1024 and size < sum(os.path.getsize(os.path.join(PAIR, n)) for n in PAIR_FILES)


def test_cut_pair_frames_decode_to_libjpegs_smoothed_hashes(built, tmp_path):
    """Frame 1 (Huffman and arithmetic) cut at the committed offset inside
    its AC scans: the loader's decode has libjpeg's committed SHA-256, and
    differs from the whole file's."""
    with open(ARITH_PAIR_CUT) as f:
        cuts = json.load(f)
    with open(PAIR_HASHES) as f:
        whole = json.load(f)["frame1.jpg"]["sha256"]
    assert sorted(cuts) == ["frame1.jpg", "frame1_arith.jpg"]
    for key, entry in cuts.items():
        src = os.path.join(PAIR if key == "frame1.jpg" else ARITH_PAIR, "frame1.jpg")
        with open(src, "rb") as f:
            data = f.read()
        starts = _scan_starts(data)
        assert starts[1] < entry["bytes"] < starts[-2], key  # inside the AC scans
        path = tmp_path / key
        path.write_bytes(data[:entry["bytes"]])
        digest = hashlib.sha256(_port_frame(path, (1080, 1920)).tobytes()).hexdigest()
        assert digest == entry["sha256"] != whole, key


# ---------------------------------------------------------------- the slice

def test_tiny_ufm_base_on_an_arith_pair_matches_jax_on_cv2(built):
    """An arithmetic pair (4:2:0 progressive with restarts and DAC, 4:1:1
    sequential) through ``read_rgb`` into the port's tiny UFM-Base, against
    the JAX package's model with the same weights fed ``cv2.imread``."""
    from ufm_torch.checkpoint import load_jax_params
    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.utils.image_io import read_rgb
    from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
    from ufm_tpu.models import UniFlowMatchConfidence as JModel
    from ufm_tpu.models import ufm_tiny_config as jax_tiny_config

    res = [(56, 42)]
    jmodel = JModel.from_config(jax_tiny_config(inference_resolution=res), seed=0)
    rng = np.random.default_rng(12)
    flat = {k: v + rng.normal(0.0, 0.02, v.shape).astype(v.dtype) for k, v in flatten_params(jmodel.params).items()}
    jmodel.params = unflatten_params(flat)
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(inference_resolution=res), device="cpu")
    load_jax_params(model, flat)
    paths = [os.path.join(ARITH, n) for n in ("a420_prog_rst_dac.jpg", "a411_seq.jpg")]
    got = model.predict_correspondences_batched(source_image=read_rgb(paths[0]), target_image=read_rgb(paths[1]))
    want = jmodel.predict_correspondences_batched(source_image=_cv2_imread(paths[0]).copy(),
                                                  target_image=_cv2_imread(paths[1]).copy())
    for name, a, b in (("flow", got.flow.flow_output, want.flow.flow_output),
                       ("covisibility", got.covisibility.mask, want.covisibility.mask),
                       ("flow_covariance", got.flow.flow_covariance, want.flow.flow_covariance)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape and a.shape[-2:] == (61, 83), name
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-5 if "cov" in name else 0.0, err_msg=name)


# ---------------------------------------------------------------- the committed files

def _writer(tmp):
    """WRITER_C compiled against the system libjpeg."""
    src, exe = os.path.join(tmp, "writer.c"), os.path.join(tmp, "writer")
    with open(src, "w") as f:
        f.write(WRITER_C)
    subprocess.run(["cc", "-O2", src, "-o", exe, "-ljpeg"], check=True)
    return exe


def write_committed_files():
    """Write tests/golden/jpeg_arith_cases (ARITH_SPECS and decodes.npz: the
    JAX package's loader's libjpeg decodes and cv2.imread's) and
    tests/golden/jpeg_pair_arith (the 1080x1920 pair transcoded to arithmetic
    coding, and cut.json: frame 1's cut and libjpeg's SHA-256 of it)."""
    os.makedirs(ARITH, exist_ok=True)
    os.makedirs(ARITH_PAIR, exist_ok=True)
    decodes = {}
    with tempfile.TemporaryDirectory() as tmp:
        writer = _writer(tmp)
        for seed, (name, hw, opts) in enumerate(ARITH_SPECS):
            img = scene(*hw, 40 + seed)
            nc = 1 if opts.get("gray") else 3
            raw = os.path.join(tmp, "in.raw")
            with open(raw, "wb") as f:
                f.write((img[..., 1] if nc == 1 else img).tobytes())
            path = os.path.join(ARITH, name)
            dc_l, dc_u, ac_k = opts.get("dac", (0, 1, 5))
            subprocess.run([writer, "enc", raw, path, str(hw[1]), str(hw[0]), str(nc),
                            str(_HV[opts.get("sampling", "444")]), "85", str(opts.get("rst", 0)),
                            str(int(opts.get("prog", False))), str(int(opts.get("arith", False))), str(dc_l),
                            str(dc_u), str(ac_k), str(opts.get("stop", 0))], check=True)
            decodes[f"libjpeg/{name}"] = _jax_frame(path, hw)
            decodes[f"cv2/{name}"] = np.ascontiguousarray(_cv2_imread(path))
            print(f"wrote {path} ({os.path.getsize(path)} bytes)")
        np.savez_compressed(ARITH_DECODES, **decodes)
        for name, prog in zip(PAIR_FILES, (0, 1)):
            path = os.path.join(ARITH_PAIR, name)
            subprocess.run([writer, "arith", os.path.join(PAIR, name), path, str(prog)], check=True)
            print(f"wrote {path} ({os.path.getsize(path)} bytes)")
        cuts = {}
        for key, src in (("frame1.jpg", os.path.join(PAIR, "frame1.jpg")),
                         ("frame1_arith.jpg", os.path.join(ARITH_PAIR, "frame1.jpg"))):
            with open(src, "rb") as f:
                data = f.read()
            starts = _scan_starts(data)
            n = (starts[4] + starts[5]) // 2  # inside the fifth scan (luma AC 6-63)
            cut = os.path.join(tmp, key)
            with open(cut, "wb") as f:
                f.write(data[:n])
            frame = _jax_frame(cut, (1080, 1920))
            cuts[key] = {"bytes": n, "sha256": hashlib.sha256(frame.tobytes()).hexdigest()}
        with open(ARITH_PAIR_CUT, "w") as f:
            json.dump(cuts, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    write_committed_files()
