// ufm_torch image decoders: inflate, PNG and JPEG with no image library.
//
// Header-only, included by ufm_loader.cc. No system image header (jpeglib.h,
// png.h, zlib.h): the decoders are written here so that the host library
// builds from the repository alone.
//
//   decode_png   what libpng gives under the native loader's transforms
//                (png_set_strip_16, palette and gray 1/2/4 expanded, gray
//                replicated to RGB, alpha and tRNS dropped, Adam7 merged),
//                the same files refused (CRC errors in critical chunks,
//                short or corrupt image data, bad filter types).
//   decode_jpeg  what libjpeg-turbo's default decompression gives:
//                baseline / extended Huffman (SOF0, SOF1), progressive
//                Huffman (SOF2), sequential and progressive arithmetic
//                (SOF9, SOF10; jpeg_arith.h) 8-bit files, restart
//                intervals, every integral sampling factor; the ISLOW IDCT
//                of jidctint.c, fancy upsampling of jdsample.c (h2v1, h2v2,
//                h1v2; other ratios replicated), YCbCr -> RGB of jdcolor.c;
//                Adobe transform 0 stored RGB; entropy data that ends early
//                decodes the rest of its segment as zeros (libjpeg's
//                warning, not an error); a progressive image whose scans
//                leave any of coefficients 1-9 incomplete block-smoothed as
//                jdcoefct.c's decompress_smooth_data smooths it; for the
//                OpenCV targets, Huffman lossless files (SOF3) as
//                libjpeg-turbo 3.1's jdlossls.c / jddiffct.c / jdlhuff.c
//                decode them (predictors 1-7, the point transform, restart
//                intervals that reset the predictor, any scan layout,
//                replicated upsampling, no colour transform: YCbCr, YCCK and
//                gray refused as OpenCV's libjpeg refuses them).
//                Three targets: kRgb (libjpeg-turbo 2.1 read from a file,
//                out_color_space = JCS_RGB: CMYK / YCCK refused), kOpenCvFile
//                (cv2.imread with IMREAD_COLOR, in RGB order: CMYK / YCCK
//                converted as OpenCV converts them, the EXIF Orientation tag
//                applied, libjpeg-turbo 3.1's smoothing rows, nothing read
//                after a single-scan image's scan) and kOpenCv (cv2.imdecode
//                of a buffer: the same, and data that ends before libjpeg is
//                done with it, which a buffer cannot refill, is refused).
//                Refused with an error that names the feature: lossless
//                files for kRgb (libjpeg-turbo 2.1 has no lossless mode),
//                arithmetic lossless (SOF11), hierarchical and 12-bit files.
//
// Every function is reentrant: no mutable static state (the tables below are
// constant), so the loader runs them on a thread pool.

#ifndef UFM_TORCH_IMAGE_DECODE_H_
#define UFM_TORCH_IMAGE_DECODE_H_

#include <algorithm>
#include <array>
#include <chrono>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "jpeg_arith.h"

namespace ufm_image {

struct Image {
  int width = 0, height = 0;
  std::vector<uint8_t> rgb;  // height * width * 3
};

// ------------------------------------------------------------------ checksums

constexpr std::array<uint32_t, 256> make_crc_table() {
  std::array<uint32_t, 256> t{};
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    t[n] = c;
  }
  return t;
}
inline constexpr std::array<uint32_t, 256> kCrcTable = make_crc_table();

inline uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = kCrcTable[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n > 0) {
    size_t k = n < 5552 ? n : 5552;
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

// ------------------------------------------------------------------ inflate

namespace inflate_detail {

// LSB-first bit reader over a byte range; consumed() counts the bits used
struct BitIn {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  BitIn(const uint8_t* data, size_t size) : p(data), n(size) {}
  bool need(int k) {
    while (cnt < k) {
      if (pos >= n) return false;
      buf |= (uint64_t)p[pos++] << cnt;
      cnt += 8;
    }
    return true;
  }
  void fill() {
    while (cnt <= 56 && pos < n) {
      buf |= (uint64_t)p[pos++] << cnt;
      cnt += 8;
    }
  }
  uint32_t take(int k) {  // after need(k)
    uint32_t v = (uint32_t)(buf & ((1ull << k) - 1));
    buf >>= k;
    cnt -= k;
    return v;
  }
  void align() { take(cnt & 7); }
  size_t consumed() const { return pos * 8 - cnt; }
};

constexpr int kFastBits = 9;

struct Huffman {
  uint16_t count[16];
  uint16_t symbol[320];
  uint16_t fast[1 << kFastBits];  // (symbol << 4) | length for codes of <= kFastBits bits, else 0
};

// 0: a usable code; -1: over-subscribed or incomplete (as zlib's
// inflate_table: an incomplete code is allowed only where ``single_ok`` and
// its longest length is 1, and an empty one always)
inline int build(Huffman* h, const uint8_t* lengths, int n, bool single_ok) {
  std::memset(h->count, 0, sizeof h->count);
  std::memset(h->fast, 0, sizeof h->fast);
  for (int s = 0; s < n; s++) h->count[lengths[s]]++;
  int max = 15;
  while (max >= 1 && h->count[max] == 0) max--;
  h->count[0] = 0;
  if (max == 0) return 0;
  int left = 1;
  for (int len = 1; len <= 15; len++) {
    left <<= 1;
    left -= h->count[len];
    if (left < 0) return -1;
  }
  if (left > 0 && (!single_ok || max != 1)) return -1;
  uint16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; len++) offs[len + 1] = offs[len] + h->count[len];
  for (int s = 0; s < n; s++)
    if (lengths[s]) h->symbol[offs[lengths[s]]++] = (uint16_t)s;
  // fast table: canonical codes, bit-reversed for LSB-first lookup
  int code = 0, index = 0;
  for (int len = 1; len <= kFastBits; len++) {
    for (int i = 0; i < h->count[len]; i++, code++, index++) {
      int rev = 0;
      for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int e = rev; e < (1 << kFastBits); e += 1 << len) h->fast[e] = (uint16_t)(h->symbol[index] << 4 | len);
    }
    code <<= 1;
  }
  return 0;
}

// a symbol; -1 for a code the table does not hold; -2 when the input ends
inline int decode(BitIn& br, const Huffman& h) {
  br.fill();
  const uint32_t bits = (uint32_t)br.buf;
  const uint16_t e = h.fast[bits & ((1 << kFastBits) - 1)];
  if (e) {
    const int len = e & 15;
    if (len > br.cnt) return -2;
    br.take(len);
    return e >> 4;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= 15; len++) {
    if (len > br.cnt) return -2;
    code |= (bits >> (len - 1)) & 1;
    const int count = h.count[len];
    if (code - count < first) {
      br.take(len);
      return h.symbol[index + (code - first)];
    }
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

inline constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                          31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
inline constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                          2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
inline constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                           33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                           1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
inline constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                           6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
inline constexpr uint8_t kClenOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

}  // namespace inflate_detail

// What inflating a zlib stream met, in input bits consumed, for a reader that
// wants its first ``need`` output bytes (PNG: the image's rows).
struct InflateTrace {
  std::string error;            // the first error in the stream ("" if none)
  size_t error_bit = 0;         // where it was found
  size_t need_bit = 0;          // where the output reached ``need`` bytes (0: never)
  size_t extra_bit = SIZE_MAX;  // where the first byte past ``need`` was decoded
  bool ended = false;           // the stream ended and its Adler-32 matched
  size_t end_bit = 0;           // where it ended
};

// Inflate the zlib stream (RFC 1950 / 1951: stored, fixed and dynamic
// blocks, the Adler-32 check) in in[0, n) into *out, with zlib's error
// messages. Stops at the first error, at the stream's end, or where the input
// ends (then neither error nor ended is set).
inline InflateTrace inflate_zlib(const uint8_t* in, size_t n, size_t need, std::vector<uint8_t>* out) {
  using namespace inflate_detail;
  InflateTrace t;
  BitIn br(in, n);
  out->clear();
  out->reserve(need);
  bool tracking = true;
  auto produced = [&]() {
    if (out->size() >= need) {
      if (t.need_bit == 0) t.need_bit = br.consumed();
      if (out->size() > need) {
        t.extra_bit = br.consumed();
        tracking = false;
      }
    }
  };
  auto fail = [&](const char* msg) {
    t.error = msg;
    t.error_bit = br.consumed();
    return t;
  };
  if (!br.need(16)) return t;
  const uint32_t cmf = br.take(8), flg = br.take(8);
  if ((cmf * 256 + flg) % 31) return fail("incorrect header check");
  if ((cmf & 15) != 8) return fail("unknown compression method");
  if ((cmf >> 4) > 7) return fail("invalid window size");
  if (flg & 0x20) return fail("need dictionary");

  Huffman lit, dist, clen;
  uint8_t lengths[320];
  for (;;) {
    if (!br.need(3)) return t;
    const bool final = br.take(1);
    const uint32_t type = br.take(2);
    if (type == 0) {
      br.align();
      if (!br.need(32)) return t;
      const uint32_t len = br.take(16), nlen = br.take(16);
      if (len != (~nlen & 0xFFFF)) return fail("invalid stored block lengths");
      for (uint32_t i = 0; i < len; i++) {
        if (!br.need(8)) return t;
        out->push_back((uint8_t)br.take(8));
        if (tracking) produced();
      }
    } else if (type == 3) {
      return fail("invalid block type");
    } else {
      if (type == 1) {
        for (int s = 0; s < 288; s++) lengths[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
        build(&lit, lengths, 288, true);
        for (int s = 0; s < 32; s++) lengths[s] = 5;
        build(&dist, lengths, 32, true);
      } else {
        if (!br.need(14)) return t;
        const int nlit = (int)br.take(5) + 257, ndist = (int)br.take(5) + 1, nclen = (int)br.take(4) + 4;
        if (nlit > 286 || ndist > 30) return fail("too many length or distance symbols");
        uint8_t cl[19] = {0};
        for (int i = 0; i < nclen; i++) {
          if (!br.need(3)) return t;
          cl[kClenOrder[i]] = (uint8_t)br.take(3);
        }
        if (build(&clen, cl, 19, false) != 0) return fail("invalid code lengths set");
        int have = 0;
        while (have < nlit + ndist) {
          const int sym = decode(br, clen);
          if (sym == -2) return t;
          if (sym < 0) return fail("invalid code lengths set");
          if (sym < 16) {
            lengths[have++] = (uint8_t)sym;
            continue;
          }
          int rep = 0, value = 0;
          if (sym == 16) {
            if (have == 0) return fail("invalid bit length repeat");
            if (!br.need(2)) return t;
            value = lengths[have - 1];
            rep = 3 + (int)br.take(2);
          } else if (sym == 17) {
            if (!br.need(3)) return t;
            rep = 3 + (int)br.take(3);
          } else {
            if (!br.need(7)) return t;
            rep = 11 + (int)br.take(7);
          }
          if (have + rep > nlit + ndist) return fail("invalid bit length repeat");
          while (rep--) lengths[have++] = (uint8_t)value;
        }
        if (lengths[256] == 0) return fail("invalid code -- missing end-of-block");
        if (build(&lit, lengths, nlit, true) != 0) return fail("invalid literal/lengths set");
        if (build(&dist, lengths + nlit, ndist, true) != 0) return fail("invalid distances set");
      }
      for (;;) {
        int sym = decode(br, lit);
        if (sym == -2) return t;
        if (sym == -1) return fail("invalid literal/length code");
        if (sym < 256) {
          out->push_back((uint8_t)sym);
          if (tracking) produced();
          continue;
        }
        if (sym == 256) break;
        sym -= 257;
        if (sym >= 29) return fail("invalid literal/length code");
        if (!br.need(kLenExtra[sym])) return t;
        const size_t len = kLenBase[sym] + br.take(kLenExtra[sym]);
        int dsym = decode(br, dist);
        if (dsym == -2) return t;
        if (dsym < 0 || dsym >= 30) return fail("invalid distance code");
        if (!br.need(kDistExtra[dsym])) return t;
        const size_t d = kDistBase[dsym] + br.take(kDistExtra[dsym]);
        if (d > out->size()) return fail("invalid distance too far back");
        size_t from = out->size() - d;
        for (size_t i = 0; i < len; i++) out->push_back((*out)[from + i]);
        if (tracking) produced();
      }
    }
    if (final) break;
  }
  br.align();
  if (!br.need(32)) return t;
  const uint32_t want = br.take(8) << 24 | br.take(8) << 16 | br.take(8) << 8 | br.take(8);
  if (want != adler32(out->data(), out->size())) return fail("incorrect data check");
  t.ended = true;
  t.end_bit = br.consumed();
  return t;
}

// ------------------------------------------------------------------ PNG

// The PNG file in d[0, n) -> 8-bit RGB as libpng gives it under the native
// loader's transforms. Returns "" or the reason the file is refused.
inline std::string decode_png(const uint8_t* d, size_t n, Image* img) {
  static constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || std::memcmp(d, kSig, 8) != 0) return "not a PNG file";
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  bool have_ihdr = false, have_plte = false;
  uint8_t palette[256 * 3] = {0};  // libpng keeps 256 entries, zero past the file's
  struct Chunk {
    size_t off, len;
    bool bad;  // CRC mismatch, or cut short by the end of the file
  };
  std::vector<Chunk> idats;
  size_t pos = 8;
  for (;;) {
    if (n - pos < 8) {
      if (!idats.empty()) break;
      return "truncated PNG file";
    }
    const uint32_t len = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    if (len > 0x7FFFFFFFu) return "PNG chunk length out of range";
    for (int i = 0; i < 4; i++)
      if (!((type[i] >= 'A' && type[i] <= 'Z') || (type[i] >= 'a' && type[i] <= 'z'))) return "invalid PNG chunk type";
    const size_t off = pos + 8;
    const bool truncated = n - off < (size_t)len + 4;
    const bool bad = truncated || crc32(type, (size_t)len + 4) != be32(d + off + len);
    const std::string name(reinterpret_cast<const char*>(type), 4);
    if (name == "IDAT") {
      if (!have_ihdr) return "missing IHDR";
      if (ctype == 3 && !have_plte) return "palette PNG without a PLTE chunk";
      idats.push_back({off, truncated ? n - off : (size_t)len, bad});
      if (truncated) break;
      pos = off + len + 4;
      continue;
    }
    if (!idats.empty()) break;  // the image data ended with the IDAT run
    if (truncated) return "truncated PNG file";
    const bool critical = !(type[0] & 0x20);
    if (!have_ihdr && name != "IHDR") return "missing IHDR";
    if (bad) {
      if (critical) return "CRC error in the " + name + " chunk";
      pos = off + len + 4;  // an ancillary chunk with a bad CRC is dropped
      continue;
    }
    const uint8_t* body = d + off;
    if (name == "IHDR") {
      if (have_ihdr) return "duplicate IHDR";
      if (len != 13) return "invalid IHDR length";
      have_ihdr = true;
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
      if (w == 0 || h == 0) return "PNG image with a zero dimension";
      if (w > 1000000 || h > 1000000) return "PNG image larger than 1000000 pixels a side";
      bool ok = false;
      switch (ctype) {
        case 0: ok = depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16; break;
        case 3: ok = depth == 1 || depth == 2 || depth == 4 || depth == 8; break;
        case 2: case 4: case 6: ok = depth == 8 || depth == 16; break;
        default: break;
      }
      if (!ok) return "invalid PNG colour type / bit depth";
      if (body[10] != 0) return "unknown PNG compression method";
      if (body[11] != 0) return "unknown PNG filter method";
      if (interlace > 1) return "unknown PNG interlace method";
    } else if (name == "PLTE") {
      if (have_plte) return "duplicate PLTE";
      if (ctype == 3) {
        if (len == 0 || len > 768 || len % 3) return "invalid PLTE";
        std::memcpy(palette, body, std::min<size_t>(len, (size_t)3 << depth));
      }
      have_plte = true;
    } else if (name == "IEND") {
      return "PNG file without image data";
    } else if (critical) {
      return "unknown critical PNG chunk " + name;
    }
    pos = off + len + 4;
  }
  if ((uint64_t)w * h > (1ull << 31)) return "PNG image too large";

  // (x0, y0, dx, dy) of each pass: Adam7's seven, or the whole image
  static constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                       {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static constexpr int kWhole[1][4] = {{0, 0, 1, 1}};
  static constexpr int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  const int channels = kChannels[ctype];
  const int pixel_bits = channels * depth;
  const int bpp = std::max(1, pixel_bits / 8);
  struct Pass {
    int x0, y0, dx, dy;
    size_t pw, ph;
  };
  std::vector<Pass> passes;
  const int(*grid)[4] = interlace ? kAdam7 : kWhole;
  for (int p = 0; p < (interlace ? 7 : 1); p++) {
    const int x0 = grid[p][0], y0 = grid[p][1], dx = grid[p][2], dy = grid[p][3];
    const size_t pw = w > (uint32_t)x0 ? (w - x0 + dx - 1) / dx : 0, ph = h > (uint32_t)y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw && ph) passes.push_back({x0, y0, dx, dy, pw, ph});
  }
  size_t need = 0;
  for (const Pass& p : passes) need += p.ph * ((p.pw * pixel_bits + 7) / 8 + 1);

  // libpng hands zlib the IDAT data in pieces of at most 8192 bytes, one
  // chunk at a time, and asks for the rows' bytes: what the stream holds
  // after them is checked only as far as that input reaches
  std::vector<uint8_t> z;
  std::vector<size_t> piece_end, piece_chunk;  // end offset in z and chunk index of each piece
  for (size_t c = 0; c < idats.size(); c++) {
    const size_t start = z.size();
    z.insert(z.end(), d + idats[c].off, d + idats[c].off + idats[c].len);
    for (size_t s = start; s < z.size(); s += 8192) {
      piece_end.push_back(std::min(z.size(), s + 8192));
      piece_chunk.push_back(c);
    }
  }
  std::vector<uint8_t> raw;
  const InflateTrace t = inflate_zlib(z.data(), z.size(), need, &raw);
  if (!t.error.empty() && (t.need_bit == 0 || t.error_bit <= t.need_bit)) return "corrupt PNG image data (" + t.error + ")";
  if (t.need_bit == 0) return "not enough PNG image data";
  auto piece_of = [&](size_t bit) {  // the piece holding the last bit consumed
    const size_t byte = bit ? (bit - 1) / 8 : 0;
    return (size_t)(std::upper_bound(piece_end.begin(), piece_end.end(), byte) - piece_end.begin());
  };
  const size_t e_err = t.error.empty() ? SIZE_MAX : t.error_bit, e_end = t.ended ? t.end_bit : SIZE_MAX;
  const size_t first = std::min({e_err, t.extra_bit, e_end});
  size_t piece = piece_of(t.need_bit);
  bool extra = false;
  if (first != SIZE_MAX && piece_of(first) == piece) {
    // the call that read the last row met it: an error there is libpng's
    if (first == e_err) return "corrupt PNG image data (" + t.error + ")";
    extra = first == t.extra_bit && first != e_end;
  } else {
    // the rows used up their piece: the end check reads one more
    if (++piece >= piece_end.size()) return "not enough PNG image data";
    extra = first == t.extra_bit && first != e_end && piece_of(first) == piece;
  }
  if (extra) {  // more data than rows: read on to the end (an error there is only a warning)
    if (!t.ended && t.error.empty()) return "not enough PNG image data";
    piece = piece_of(std::min(e_err, e_end));
  }
  for (size_t c = 0; c <= piece_chunk[std::min(piece, piece_chunk.size() - 1)]; c++)
    if (idats[c].bad) return "CRC error in an IDAT chunk";

  img->width = (int)w;
  img->height = (int)h;
  img->rgb.assign((size_t)w * h * 3, 0);
  std::vector<uint8_t> prev, cur;
  const uint8_t* src = raw.data();
  const int gray_scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  for (const Pass& p : passes) {
    const size_t stride = (p.pw * pixel_bits + 7) / 8;
    prev.assign(stride, 0);
    cur.resize(stride);
    for (size_t r = 0; r < p.ph; r++, src += stride + 1) {
      const int filter = src[0];
      const uint8_t* f = src + 1;
      switch (filter) {
        case 0: std::memcpy(cur.data(), f, stride); break;
        case 1:
          for (size_t i = 0; i < stride; i++) cur[i] = (uint8_t)(f[i] + (i >= (size_t)bpp ? cur[i - bpp] : 0));
          break;
        case 2:
          for (size_t i = 0; i < stride; i++) cur[i] = (uint8_t)(f[i] + prev[i]);
          break;
        case 3:
          for (size_t i = 0; i < stride; i++)
            cur[i] = (uint8_t)(f[i] + (((i >= (size_t)bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
          break;
        case 4:
          for (size_t i = 0; i < stride; i++) {
            const int a = i >= (size_t)bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= (size_t)bpp ? prev[i - bpp] : 0;
            const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
            cur[i] = (uint8_t)(f[i] + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c));
          }
          break;
        default: return "bad PNG row filter type";
      }
      uint8_t* row = img->rgb.data() + ((size_t)(p.y0 + r * p.dy) * w + p.x0) * 3;
      const size_t step = (size_t)p.dx * 3;
      const int bytes = depth / 8;  // 1 or 2 for depths 8 / 16 (0 below)
      for (size_t x = 0; x < p.pw; x++, row += step) {
        if (depth < 8) {
          const size_t bit = x * depth;
          const int v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
          if (ctype == 3) {
            std::memcpy(row, palette + 3 * v, 3);
          } else {
            row[0] = row[1] = row[2] = (uint8_t)(v * gray_scale);
          }
          continue;
        }
        const uint8_t* s = cur.data() + x * channels * bytes;  // a 16-bit sample keeps its high byte
        if (ctype == 3) {
          std::memcpy(row, palette + 3 * s[0], 3);
        } else if (ctype == 0 || ctype == 4) {
          row[0] = row[1] = row[2] = s[0];
        } else {
          row[0] = s[0];
          row[1] = s[bytes];
          row[2] = s[2 * bytes];
        }
      }
      std::swap(prev, cur);
    }
  }
  return "";
}

// ------------------------------------------------------------------ JPEG

enum class JpegTarget {
  kRgb,         // libjpeg-turbo 2.1's stdio source with out_color_space = JCS_RGB
  kOpenCvFile,  // cv2.imread(IMREAD_COLOR) in RGB order: CMYK converted, EXIF orientation applied
  kOpenCv,      // cv2.imdecode(IMREAD_COLOR): kOpenCvFile, and data that ends early is refused
};

namespace jpeg_detail {

// zigzag index -> natural index, with libjpeg's 16 extra entries for runs
// that overshoot in corrupt data
inline constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// libjpeg-turbo's default tables (jstdhuff.c), used for a slot 0 / 1 that
// the file does not define (Motion-JPEG frames omit them)
inline constexpr uint8_t kStdDcBits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                              {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
inline constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
inline constexpr uint8_t kStdAcBits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                              {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
inline constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
     0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
     0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
     0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

// jdhuff.c's derived table: maxcode / valoffset by length, and an 8-bit
// lookahead ((length << 8) | symbol; length 9: the code is longer)
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[256];
  const uint8_t* vals;
};

inline std::string derive(const HuffTable& t, bool dc, Derived* d, int dc_max = 15) {
  if (!t.defined) return "JPEG scan uses an undefined Huffman table";
  char size[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    if (p + t.bits[l] > 256) return "bad JPEG Huffman table";
    for (int i = 0; i < t.bits[l]; i++) size[p++] = (char)l;
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t codes[257];
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) codes[p++] = code++;
    if (code >= (1u << si)) return "bad JPEG Huffman table";
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      d->valoffset[l] = p - (int32_t)codes[p];
      p += t.bits[l];
      d->maxcode[l] = (int32_t)codes[p - 1];
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; i++) d->lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 0; i < t.bits[l]; i++, p++) {
      const int look = (int)codes[p] << (8 - l);
      for (int c = 0; c < (1 << (8 - l)); c++) d->lookup[look + c] = (uint16_t)(l << 8 | t.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (t.vals[i] > dc_max) return "bad JPEG Huffman table (DC symbol above " + std::to_string(dc_max) + ")";
  d->vals = t.vals;
  return "";
}

// The input as libjpeg's stdio source hands it over: the file's bytes, then
// a fake EOI marker (FF D9) repeated for every read past the end.
struct Source {
  const uint8_t* data;
  size_t size, pos = 0;
  int byte() {
    const size_t i = pos++;
    return i < size ? data[i] : ((i - size) & 1) ? 0xD9 : 0xFF;
  }
  int u16() {
    const int hi = byte();
    return hi << 8 | byte();
  }
  // a byte past the end was asked for (a buffer source that cannot refill
  // fails there)
  bool past_end() const { return pos > size; }
  // jdmarker.c's next_marker: skip to the next FF xx with xx neither 00 nor FF
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

// MSB-first entropy-coded data with FF 00 unstuffed; stops at a marker,
// which it leaves in *marker, then reads zeros. ``real`` counts the bits of
// the data still in the buffer: below zero, a bit past the data was
// consumed (libjpeg's insufficient_data, which the caller reads after each
// MCU).
struct BitReader {
  Source* src;
  int* marker;
  uint64_t buf = 0;
  int cnt = 0, real = 0;
  void fill() {
    while (cnt <= 56) {
      if (*marker) {
        buf <<= 8;
        cnt += 8;
        continue;
      }
      int c = src->byte();
      if (c == 0xFF) {
        do c = src->byte();
        while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          *marker = c;
          continue;
        }
      }
      buf = buf << 8 | (uint64_t)c;
      cnt += 8;
      real += 8;
    }
  }
  // k <= cnt bits
  int bits(int k) {
    cnt -= k;
    real -= k;
    return (int)((buf >> cnt) & ((1ull << k) - 1));
  }
  int get(int k) {
    if (cnt < k) fill();
    return bits(k);
  }
  // a Huffman symbol; with the value bits that follow it (at most 15) the
  // buffer holds enough for both after one fill
  int decode(const Derived& d) {
    if (cnt < 32) fill();
    const int e = d.lookup[(buf >> (cnt - 8)) & 0xFF];
    if ((e >> 8) <= 8) {
      cnt -= e >> 8;
      real -= e >> 8;
      return e & 0xFF;
    }
    // jpeg_huff_decode: one bit at a time from 9 bits; garbage reaches 17
    int l = 9;
    int32_t code = (int32_t)((buf >> (cnt - 9)) & 0x1FF);
    while (l <= 16 && code > d.maxcode[l]) {
      l++;
      code = (int32_t)((buf >> (cnt - l)) & ((1u << l) - 1));
    }
    cnt -= l;
    real -= l;
    if (l > 16) return 0;
    return d.vals[(code + d.valoffset[l]) & 0xFF];
  }
  bool exhausted() const { return real < 0; }
  void reset() {
    buf = 0;
    cnt = real = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int)(~0u << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;              // samples (jdinput.c's downsampled_width / height)
  int bw = 0, bh = 0;              // blocks covering them
  int bw_alloc = 0, bh_alloc = 0;  // padded to whole MCUs
  std::vector<int16_t> coef;       // bh_alloc * bw_alloc blocks of 64, natural order
  std::vector<uint8_t> samples;    // a lossless file's dh rows of dw samples
  uint16_t q[64] = {0};            // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];               // progressive: Al of the last scan per coefficient, -1 before any
  int prev_bits[10] = {0};         // coef_bits[0..9] before the component's last scan (0 before scan 2)
  int dc_tbl = 0, ac_tbl = 0;
};

// jidctint.c's jpeg_idct_islow (dequantize, an 8-point pass down each column
// scaled by 2^2, one along each row, range limit), in the integer lanes of
// libjpeg-turbo's x86 SIMD version of it (jidctint-avx2.asm), which the
// libjpeg-turbo of the JAX package's loader runs: dequantized values and the
// sums the SIMD code adds as words wrap to 16 bits, products and the other
// sums are 32-bit, each pass's results saturate to 16 bits, the output to
// 0..255, and a block whose AC coefficients are all zero takes the DC-only
// first pass. On every valid file this is jidctint.c's result; the lanes
// differ from its 64-bit C arithmetic only where a corrupt file's
// coefficients overflow them.
namespace islow {
// 32-bit lanes: unsigned arithmetic wraps as the SIMD lanes do; >> on the
// signed value is the arithmetic shift (vpsrad)
constexpr uint32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                   F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
inline uint32_t word(uint32_t v) { return (uint32_t)(int32_t)(int16_t)(uint16_t)v; }  // wrap to 16 bits, sign-extend
inline int32_t sat16(int32_t v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }

// one 8-point pass on eight lanes at once (x[k][lane]: the k-th input of a
// lane, 16-bit values): y[k][lane] before saturation; written lane-wise so
// that the compiler vectorizes it
template <int descale>
inline void pass(const int32_t (*__restrict__ x)[8], int32_t (*__restrict__ y)[8]) {
  constexpr uint32_t half = 1u << (descale - 1);
  for (int l = 0; l < 8; l++) {
    const uint32_t z2 = (uint32_t)x[2][l], z3 = (uint32_t)x[6][l];
    const uint32_t tmp3 = z2 * (F0541 + F0765) + z3 * F0541;
    const uint32_t tmp2 = z2 * F0541 + z3 * (F0541 - F1847);
    const uint32_t tmp0 = word((uint32_t)x[0][l] + (uint32_t)x[4][l]) << 13;
    const uint32_t tmp1 = word((uint32_t)x[0][l] - (uint32_t)x[4][l]) << 13;
    const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const uint32_t t0 = (uint32_t)x[7][l], t1 = (uint32_t)x[5][l], t2 = (uint32_t)x[3][l], t3 = (uint32_t)x[1][l];
    const uint32_t z3o = word(t0 + t2), z4o = word(t1 + t3);
    const uint32_t z3p = z3o * (F1175 - F1961) + z4o * F1175;
    const uint32_t z4p = z3o * F1175 + z4o * (F1175 - F0390);
    const uint32_t o0 = t0 * (F0298 - F0899) - t3 * F0899 + z3p;
    const uint32_t o3 = t3 * (F1501 - F0899) - t0 * F0899 + z4p;
    const uint32_t o1 = t1 * (F2053 - F2562) - t2 * F2562 + z4p;
    const uint32_t o2 = t2 * (F3072 - F2562) - t1 * F2562 + z3p;
    y[0][l] = (int32_t)(tmp10 + o3 + half) >> descale;
    y[7][l] = (int32_t)(tmp10 - o3 + half) >> descale;
    y[1][l] = (int32_t)(tmp11 + o2 + half) >> descale;
    y[6][l] = (int32_t)(tmp11 - o2 + half) >> descale;
    y[2][l] = (int32_t)(tmp12 + o1 + half) >> descale;
    y[5][l] = (int32_t)(tmp12 - o1 + half) >> descale;
    y[3][l] = (int32_t)(tmp13 + o0 + half) >> descale;
    y[4][l] = (int32_t)(tmp13 - o0 + half) >> descale;
  }
}
}  // namespace islow

// A column whose AC coefficients are zero comes out of the full first pass
// as 4 * DC, saturated: no shortcut is needed but the SIMD code's own for a
// block with no AC coefficient at all, which shifts DC in 16 bits. The second
// pass runs on the transposed first-pass rows, eight rows as the lanes.
inline void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  alignas(32) int32_t dq[8][8], ws[8][8], wt[8][8], y[8][8];
  int any_ac = 0;
  for (int i = 8; i < 64; i++) any_ac |= in[i];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) dq[r][c] = (int32_t)islow::word((uint32_t)in[r * 8 + c] * (uint32_t)(int16_t)q[r * 8 + c]);
  if (!any_ac) {
    for (int c = 0; c < 8; c++) {
      const int32_t dc = (int32_t)islow::word((uint32_t)dq[0][c] << 2);
      for (int r = 0; r < 8; r++) wt[c][r] = dc;
    }
  } else {
    islow::pass<11>(dq, ws);
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) wt[c][r] = islow::sat16(ws[r][c]);
  }
  islow::pass<18>(wt, y);  // y[c][r]: row r, column c
  for (int r = 0; r < 8; r++) {
    uint8_t* o = out + r * stride;
    for (int c = 0; c < 8; c++) o[c] = (uint8_t)(std::min(127, std::max(-128, y[c][r])) + 128);
  }
}

// jdcolor.c's build_ycc_rgb_table, in 16-bit fixed point
struct YccTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
};
constexpr YccTables make_ycc_tables() {
  YccTables t{};
  constexpr int64_t one_half = (int64_t)1 << 15;
  constexpr int64_t f1402 = 91881, f1772 = 116130, f0714 = 46802, f0344 = 22554;  // FIX(x) = x * 65536 + 0.5
  for (int i = 0; i < 256; i++) {
    const int64_t x = i - 128;
    t.cr_r[i] = (int32_t)((f1402 * x + one_half) >> 16);
    t.cb_b[i] = (int32_t)((f1772 * x + one_half) >> 16);
    t.cr_g[i] = (int32_t)(-f0714 * x);
    t.cb_g[i] = (int32_t)(-f0344 * x + one_half);
  }
  return t;
}
inline constexpr YccTables kYccTab = make_ycc_tables();

// jdmaster.c's sample_range_limit: v clamped to 0..255, for v in -384..639
constexpr std::array<uint8_t, 1024> make_clamp() {
  std::array<uint8_t, 1024> t{};
  for (int i = 0; i < 1024; i++) t[i] = (uint8_t)(i < 384 ? 0 : i > 639 ? 255 : i - 384);
  return t;
}
inline constexpr std::array<uint8_t, 1024> kClamp = make_clamp();
inline uint8_t clamp255(int v) { return kClamp[v + 384]; }

// One decode's state.
class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size, JpegTarget target) : target_(target) {
    src_.data = data;
    src_.size = size;
  }

  // Parse to the first SOS (libjpeg's jpeg_read_header): frame size, the
  // colour space and, for the OpenCV targets, the EXIF orientation.
  std::string read_header() {
    if (src_.byte() != 0xFF || src_.byte() != 0xD8) return "not a JPEG file (no SOI marker)";
    // OpenCV takes a file for JPEG by its first three bytes
    if (target_ != JpegTarget::kRgb && (src_.size < 3 || src_.data[2] != 0xFF))
      return "not a JPEG file for OpenCV (no marker after the SOI marker)";
    std::string err = read_markers();
    if (!err.empty()) return err;
    if (marker_ == 0xD9) return "JPEG file without an image";
    return color_space();
  }

  // The frame's size as decoded (before any EXIF orientation).
  int width() const { return width_; }
  int height() const { return height_; }
  int orientation() const { return orientation_; }

  // Seconds the last decode spent in its stages: headers and entropy
  // decoding; the IDCT (with any block smoothing); upsampling and colour
  // conversion (with the EXIF orientation).
  const std::array<double, 3>& stage_seconds() const { return stage_s_; }

  std::string decode(Image* img) {
    lap_ = Clock::now();
    std::string err = read_header();
    if (!err.empty()) return err;
    const bool multi = progressive_ || comps_in_scan_ < (int)comp_.size();
    for (;;) {  // marker_ is an SOS
      err = decode_scan();
      if (!err.empty()) return err;
      if (!multi) {
        // single-scan: libjpeg reads the rest in jpeg_finish_decompress,
        // whose errors (and a buffer's end) OpenCV ignores: it has the
        // image by then
        if (target_ != JpegTarget::kRgb) break;
        err = read_markers();
        if (!err.empty()) return err;
        if (marker_ != 0xD9) return "JPEG file with a second scan in a single-scan image";
        break;
      }
      err = read_markers();
      if (!err.empty()) return err;
      if (marker_ == 0xD9) break;
    }
    // OpenCV's buffer source cannot refill: libjpeg suspends (Huffman) or
    // fails (arithmetic), and cv2.imdecode returns None
    if (target_ == JpegTarget::kOpenCv && src_.past_end())
      return "premature end of JPEG data (the buffer ends before its EOI marker)";
    smooth_ = progressive_ && smoothing_applies();
    lap(0);
    return output(img);
  }

 private:
  std::string read_markers() {
    for (;;) {
      if (marker_ == 0) marker_ = src_.next_marker();
      const int m = marker_;
      std::string err;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
        err = read_sof(m == 0xC2 || m == 0xCA, m >= 0xC9);
      } else if (m == 0xC3) {
        if (target_ == JpegTarget::kRgb) return "lossless JPEG (SOF3) is not supported by libjpeg-turbo 2.1";
        err = read_sof(false, false, true);
      } else if (m == 0xCB) {
        return "arithmetic-coded lossless JPEG (SOF11) is not supported (libjpeg-turbo has no such decoder)";
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF || m == 0xDE ||
                 m == 0xDF) {
        return "hierarchical JPEG (SOF5-7, SOF13-15, DHP, EXP markers) is not supported";
      } else if (m == 0xCC) {
        err = read_dac();
      } else if (m == 0xC8) {
        return "JPEG file with a reserved JPG marker";
      } else if (m == 0xDA) {
        return read_sos();
      } else if (m == 0xD9) {
        return "";
      } else if (m == 0xC4) {
        err = read_dht();
      } else if (m == 0xDB) {
        err = read_dqt();
      } else if (m == 0xDD) {
        if (src_.u16() != 4) return "bad JPEG DRI length";
        restart_interval_ = src_.u16();
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE || m == 0xDC) {  // COM, DNL: skipped
        const int len = src_.u16();
        if (len > 2) src_.pos += len - 2;
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn / TEM outside a scan: no parameters
      } else if (m == 0xD8) {
        return "JPEG file with a second SOI marker";
      } else {
        return "JPEG file with an unknown marker";
      }
      if (!err.empty()) return err;
      marker_ = 0;
    }
  }

  std::string read_sof(bool progressive, bool arith, bool lossless = false) {
    if (saw_sof_) return "JPEG file with two SOF markers";
    saw_sof_ = true;
    progressive_ = progressive;
    arith_ = arith;
    lossless_ = lossless;
    const int len = src_.u16();
    const int precision = src_.byte();
    height_ = src_.u16();
    width_ = src_.u16();
    const int n = src_.byte();
    if (precision != 8) return "12-bit JPEG (precision " + std::to_string(precision) + ") is not supported";
    if (height_ <= 0 || width_ <= 0 || n <= 0) return "empty JPEG image (DNL-defined height is not supported)";
    if (height_ > 65500 || width_ > 65500) return "JPEG image too big";
    if (len != 8 + 3 * n) return "bad JPEG SOF length";
    if (n > 10) return "JPEG file with too many components";
    comp_.resize(n);
    for (Component& c : comp_) {
      c.id = src_.byte();
      const int hv = src_.byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = src_.byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return "bad JPEG sampling factors";
      if (c.tq > 3) return "bad JPEG quantization table index";
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    hmax_ = vmax_ = 1;
    for (const Component& c : comp_) {
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    const int bs = lossless ? 1 : 8;  // a block's side: 8 samples, one in a lossless file
    mcux_ = (width_ + bs * hmax_ - 1) / (bs * hmax_);
    mcuy_ = (height_ + bs * vmax_ - 1) / (bs * vmax_);
    for (Component& c : comp_) {
      c.dw = (int)(((int64_t)width_ * c.h + hmax_ - 1) / hmax_);
      c.dh = (int)(((int64_t)height_ * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + bs - 1) / bs;
      c.bh = (c.dh + bs - 1) / bs;
      c.bw_alloc = std::max(c.bw, mcux_ * c.h);
      c.bh_alloc = std::max(c.bh, mcuy_ * c.v);
    }
    return "";
  }

  std::string read_dht() {
    int len = src_.u16() - 2;
    while (len > 16) {
      const int index = src_.byte();
      HuffTable t;
      t.defined = true;
      int count = 0;
      for (int i = 1; i <= 16; i++) count += t.bits[i] = (uint8_t)src_.byte();
      len -= 17;
      if (count > 256 || count > len) return "bad JPEG Huffman table";
      for (int i = 0; i < count; i++) t.vals[i] = (uint8_t)src_.byte();
      len -= count;
      if ((index & 0x0F) > 3 || (index & ~0x1F)) return "bad JPEG Huffman table index";
      (index & 0x10 ? ac_ : dc_)[index & 3] = t;
    }
    if (len != 0) return "bad JPEG DHT length";
    return "";
  }

  // jdmarker.c's get_dac: arithmetic conditioning, DC L / U or AC K per table
  std::string read_dac() {
    int len = src_.u16() - 2;
    while (len > 0) {
      const int index = src_.byte(), val = src_.byte();
      len -= 2;
      if (index >= 2 * jpeg_arith::kTables) return "bad JPEG DAC table index";
      if (index >= jpeg_arith::kTables) {
        cond_.ac_k[index - jpeg_arith::kTables] = (uint8_t)val;
      } else {
        cond_.dc_l[index] = (uint8_t)(val & 0x0F);
        cond_.dc_u[index] = (uint8_t)(val >> 4);
        if (cond_.dc_l[index] > cond_.dc_u[index]) return "bad JPEG DAC value";
      }
    }
    if (len != 0) return "bad JPEG DAC length";
    return "";
  }

  std::string read_dqt() {
    int len = src_.u16() - 2;
    while (len > 0) {
      const int n = src_.byte();
      const int prec = n >> 4, index = n & 15;
      if (index > 3) return "bad JPEG quantization table index";
      for (int i = 0; i < 64; i++) qt_[index][kNatural[i]] = (uint16_t)(prec ? src_.u16() : src_.byte());
      qt_defined_[index] = true;
      len -= prec ? 129 : 65;
    }
    if (len != 0) return "bad JPEG DQT length";
    return "";
  }

  // jdmarker.c's get_interesting_appn: JFIF (APP0) and Adobe (APP14) from
  // the first 14 bytes; the first APP1 kept whole for OpenCV's EXIF reader
  void read_app(int m) {
    const int len = src_.u16() - 2;
    if (len < 0) return;
    const size_t start = src_.pos;
    uint8_t b[14] = {0};
    const int nb = std::min(len, 14);
    for (int i = 0; i < nb; i++) b[i] = (uint8_t)src_.byte();
    if (m == 0xE0 && nb >= 14 && !std::memcmp(b, "JFIF\0", 5)) saw_jfif_ = true;
    if (m == 0xEE && nb >= 12 && !std::memcmp(b, "Adobe", 5)) {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    if (m == 0xE1 && !saw_app1_) {
      saw_app1_ = true;
      src_.pos = start;
      std::vector<uint8_t> body(len);
      for (int i = 0; i < len; i++) body[i] = (uint8_t)src_.byte();
      if (len > 6) orientation_ = exif_orientation(body.data() + 6, (size_t)len - 6);
    }
    src_.pos = start + len;
  }

  // OpenCV's ExifReader on IFD0: the Orientation tag's SHORT value, 1 (none)
  // when the block is not a TIFF header or ends short of the tag
  static int exif_orientation(const uint8_t* d, size_t n) {
    if (n < 2) return 1;
    const bool intel = d[0] == 'I' && d[1] == 'I';
    if (d[0] != d[1] || (d[0] != 'I' && d[0] != 'M')) return 1;  // OpenCV reads no tag then
    auto u16 = [&](size_t off, bool* ok) -> uint32_t {
      if (off + 1 >= n) {
        *ok = false;
        return 0;
      }
      return intel ? d[off] | d[off + 1] << 8 : d[off] << 8 | d[off + 1];
    };
    bool ok = true;
    if (u16(2, &ok) != 0x2A || !ok) return 1;
    if (n < 8) return 1;
    const uint32_t ifd = intel ? d[4] | d[5] << 8 | d[6] << 16 | (uint32_t)d[7] << 24 : be32(d + 4);
    const uint32_t entries = u16(ifd, &ok);
    if (!ok) return 1;
    for (uint32_t e = 0; e < entries; e++) {
      const size_t off = (size_t)ifd + 2 + 12 * (size_t)e;
      const uint32_t tag = u16(off, &ok);
      if (!ok) return 1;
      if (tag == 0x0112) {
        const uint32_t v = u16(off + 8, &ok);
        if (!ok) return 1;
        return v;
      }
    }
    return 1;
  }

  // jdapimin.c's default_decompress_parms
  std::string color_space() {
    const int n = (int)comp_.size();
    if (n == 1) {
      space_ = kGray;
    } else if (n == 3) {
      if (lossless_ && !saw_jfif_ && !saw_adobe_) {
        space_ = kRgbSpace;  // libjpeg-turbo 3's guess for lossless files, whatever the ids
      } else if (saw_jfif_) {
        space_ = kYcc;
      } else if (saw_adobe_) {
        space_ = adobe_transform_ == 0 ? kRgbSpace : kYcc;
      } else if (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66) {
        space_ = kRgbSpace;
      } else {
        space_ = kYcc;
      }
    } else if (n == 4) {
      space_ = saw_adobe_ && adobe_transform_ == 0 ? kCmyk : saw_adobe_ ? kYcck : kCmyk;
      if (target_ == JpegTarget::kRgb)
        return space_ == kCmyk ? "CMYK JPEG: libjpeg does not convert it to RGB"
                               : "YCCK JPEG: libjpeg does not convert it to RGB";
    } else {
      return "JPEG file with " + std::to_string(n) + " components";
    }
    // libjpeg-turbo 3 converts no colour in a lossless file: OpenCV's
    // request (BGR from 1 or 3 components, CMYK from 4) then fails
    if (lossless_ && space_ != kRgbSpace && space_ != kCmyk)
      return space_ == kGray ? "grayscale lossless JPEG: libjpeg-turbo does not convert it to colour"
                             : "lossless JPEG with a colour transform (YCbCr / YCCK): libjpeg-turbo does not convert it";
    return "";
  }

  std::string read_sos() {
    if (!saw_sof_) return "JPEG SOS before SOF";
    const int len = src_.u16();
    const int n = src_.byte();
    if (len != n * 2 + 6 || n < 1 || n > 4) return "bad JPEG SOS length";
    comps_in_scan_ = n;
    for (int i = 0; i < n; i++) {
      const int id = src_.byte(), tables = src_.byte();
      int ci = -1;
      for (int k = 0; k < (int)comp_.size(); k++)
        if (comp_[k].id == id) ci = k;
      if (ci < 0) return "bad JPEG component id in SOS";
      for (int k = 0; k < i; k++)
        if (scan_[k] == ci) return "bad JPEG component id in SOS";
      scan_[i] = ci;
      comp_[ci].dc_tbl = tables >> 4;
      comp_[ci].ac_tbl = tables & 15;
    }
    scan_number_++;
    ss_ = src_.byte();
    se_ = src_.byte();
    const int a = src_.byte();
    ah_ = a >> 4;
    al_ = a & 15;
    next_restart_ = 0;
    marker_ = 0;
    return "";
  }

  // jdphuff.c's progression checks (errors) and coef_bits bookkeeping
  std::string start_progressive_scan() {
    const bool dc = ss_ == 0;
    bool bad = false;
    if (dc) {
      if (se_ != 0) bad = true;
    } else {
      if (ss_ > se_ || se_ > 63) bad = true;
      if (comps_in_scan_ != 1) bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) return "bad JPEG progression parameters";
    for (int i = 0; i < comps_in_scan_; i++) {
      Component& c = comp_[scan_[i]];
      for (int k = std::min(ss_, 1); k <= 9; k++) c.prev_bits[k] = scan_number_ > 1 ? c.coef_bits[k] : 0;
      for (int k = ss_; k <= se_; k++) c.coef_bits[k] = al_;
    }
    return "";
  }

  std::string decode_scan() {
    if (!progressive_ && comps_in_scan_ > 1) {
      int blocks = 0;
      for (int i = 0; i < comps_in_scan_; i++) blocks += comp_[scan_[i]].h * comp_[scan_[i]].v;
      if (blocks > 10) return "bad JPEG MCU size";
    }
    if (lossless_) return decode_lossless_scan();
    if (progressive_) {
      std::string err = start_progressive_scan();
      if (!err.empty()) return err;
    }
    // libjpeg-turbo's sequential Huffman decoder (jinit_huff_decoder, not
    // the progressive one) installs its standard tables in undefined slots
    // 0 and 1
    if (!arith_ && !progressive_ && !std_tables_) {
      std_tables_ = true;
      for (int k = 0; k < 2; k++) {
        if (!dc_[k].defined) {
          dc_[k].defined = true;
          std::memcpy(dc_[k].bits, kStdDcBits[k], 17);
          std::memcpy(dc_[k].vals, kStdDcVals, 12);
        }
        if (!ac_[k].defined) {
          ac_[k].defined = true;
          std::memcpy(ac_[k].bits, kStdAcBits[k], 17);
          std::memcpy(ac_[k].vals, kStdAcVals[k], 162);
        }
      }
    }
    const bool dc_pass = !progressive_ || (ss_ == 0 && ah_ == 0), ac_pass = !progressive_ || ss_ != 0;
    Derived dcd[4], acd[4];
    int dc_tbl[4], ac_tbl[4];  // by index in the scan
    for (int i = 0; i < comps_in_scan_; i++) {
      Component& c = comp_[scan_[i]];
      if (!c.latched) {
        if (!qt_defined_[c.tq]) return "JPEG component without a quantization table";
        std::memcpy(c.q, qt_[c.tq], sizeof c.q);
        c.latched = true;
        c.coef.assign((size_t)c.bw_alloc * c.bh_alloc * 64, 0);
      }
      dc_tbl[i] = c.dc_tbl;
      ac_tbl[i] = c.ac_tbl;
      if (arith_) continue;
      // only the tables the scan uses (jdphuff.c: no DC table in an AC scan)
      if ((dc_pass && c.dc_tbl > 3) || (ac_pass && c.ac_tbl > 3)) return "bad JPEG Huffman table index";
      std::string err;
      if (dc_pass) err = derive(dc_[c.dc_tbl], true, &dcd[c.dc_tbl]);
      if (err.empty() && ac_pass) err = derive(ac_[c.ac_tbl], false, &acd[c.ac_tbl]);
      if (!err.empty()) return err;
    }
    bool insufficient = false;  // Huffman data ran out in this restart interval
    BitReader br{&src_, &marker_};
    jpeg_arith::Scan<Source> ar(&src_, &marker_, cond_, kNatural);
    if (arith_) ar.reset(comps_in_scan_, dc_tbl, ac_tbl, dc_pass, ac_pass);
    int dc_pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restarts_to_go = restart_interval_;
    const bool single = comps_in_scan_ == 1;
    const Component& c0 = comp_[scan_[0]];
    const int mcus_x = single ? c0.bw : mcux_, mcus_y = single ? c0.bh : mcuy_;
    int16_t* blocks[10];
    int block_comp[10];
    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        // jdcoefct.c's consume_data, before each MCU (the smoothing reads it)
        if (!insufficient) last_good_imcu_ = single ? my / c0.v : my;
        if (restart_interval_ && restarts_to_go == 0) {
          read_restart_marker();
          restarts_to_go = restart_interval_;
          if (arith_) {
            ar.reset(comps_in_scan_, dc_tbl, ac_tbl, dc_pass, ac_pass);
          } else {
            // process_restart: drop the bits left, reset
            br.reset();
            std::fill(dc_pred, dc_pred + 4, 0);
            eobrun = 0;
            if (marker_ == 0) insufficient = false;
          }
        }
        int nblocks = 0;
        if (single) {
          Component& c = comp_[scan_[0]];
          blocks[0] = c.coef.data() + ((size_t)my * c.bw_alloc + mx) * 64;
          block_comp[0] = 0;
          nblocks = 1;
        } else {
          for (int i = 0; i < comps_in_scan_; i++) {
            Component& c = comp_[scan_[i]];
            for (int by = 0; by < c.v; by++)
              for (int bx = 0; bx < c.h; bx++) {
                blocks[nblocks] =
                    c.coef.data() + ((size_t)(my * c.v + by) * c.bw_alloc + (size_t)mx * c.h + bx) * 64;
                block_comp[nblocks++] = i;
              }
          }
        }
        if (arith_) {
          if (!progressive_)
            ar.mcu_sequential(blocks, block_comp, nblocks, dc_tbl, ac_tbl);
          else if (ss_ == 0 && ah_ == 0)
            ar.mcu_dc_first(blocks, block_comp, nblocks, dc_tbl, al_);
          else if (ss_ == 0)
            ar.mcu_dc_refine(blocks, nblocks, al_);
          else if (ah_ == 0)
            ar.mcu_ac_first(blocks[0], ac_tbl[0], ss_, se_, al_);
          else
            ar.mcu_ac_refine(blocks[0], ac_tbl[0], ss_, se_, al_);
        } else if (!insufficient) {
          std::string err;
          if (!progressive_)
            err = mcu_sequential(br, blocks, block_comp, nblocks, dcd, acd, dc_pred);
          else if (ss_ == 0 && ah_ == 0)
            err = mcu_dc_first(br, blocks, block_comp, nblocks, dcd, dc_pred);
          else if (ss_ == 0)
            mcu_dc_refine(br, blocks, nblocks);
          else if (ah_ == 0)
            mcu_ac_first(br, blocks[0], acd[comp_[scan_[0]].ac_tbl], &eobrun);
          else
            mcu_ac_refine(br, blocks[0], acd[comp_[scan_[0]].ac_tbl], &eobrun);
          if (!err.empty()) return err;
          insufficient = br.exhausted();
        }
        if (restart_interval_) restarts_to_go--;
      }
    }
    return "";
  }

  // One lossless scan as libjpeg-turbo 3.1 decodes it (jddiffct.c's
  // decompress_data, jdlhuff.c's decode_mcus, jdlossls.c's undifferencers
  // and scaler): the MCU rows of each iMCU row are decoded into sample
  // differences, then each component's rows of that iMCU row are
  // undifferenced and shifted left by Pt. A restart, or a row entered after
  // the data ran out (whose differences are zeros), puts every component
  // back on its first-row rule (the first sample 2^(7 - Pt), then the one to
  // its left); libjpeg applies that at the first row of the iMCU row it
  // happens in. Sums wrap to 16 bits, a sample is their low 8 bits.
  std::string decode_lossless_scan() {
    if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= 8)
      return "bad JPEG lossless scan parameters (predictor, Se, Ah or Pt)";
    const bool single = comps_in_scan_ == 1;
    const Component& c0 = comp_[scan_[0]];
    const int per_row = single ? c0.dw : mcux_;  // MCUs in an MCU row
    if (restart_interval_ % per_row != 0) return "JPEG restart interval is not a whole number of MCU rows";
    Derived tbl[4];
    std::vector<std::vector<int>> diff(comps_in_scan_), prev(comps_in_scan_);
    for (int i = 0; i < comps_in_scan_; i++) {
      Component& c = comp_[scan_[i]];
      if (c.dc_tbl > 3) return "bad JPEG Huffman table index";
      const std::string err = derive(dc_[c.dc_tbl], true, &tbl[c.dc_tbl], 16);
      if (!err.empty()) return err;
      if (c.samples.empty()) c.samples.assign((size_t)c.dw * c.dh, 0);
      diff[i].assign((size_t)c.v * (single ? c.dw : mcux_ * c.h), 0);  // the iMCU row's, MCU padding included
      prev[i].assign(c.dw, 0);
    }
    bool first_row[10];  // jdlossls.c's start_pass: every component's predictor reset
    std::fill(first_row, first_row + 10, true);
    BitReader br{&src_, &marker_};
    bool insufficient = false;  // the data ran out before this row (jdlhuff.c's insufficient_data)
    int restart_rows_to_go = restart_interval_ / per_row;
    auto sample_diff = [&](const Derived& t) {
      const int s = br.decode(t);
      return s == 16 ? 32768 : s ? extend(br.bits(s), s) : 0;
    };
    for (int iy = 0; iy < mcuy_; iy++) {
      const bool last = iy == mcuy_ - 1;
      auto rows_of = [&](const Component& c) { return last && c.dh % c.v ? c.dh % c.v : c.v; };
      const int mcu_rows = single ? rows_of(c0) : 1;
      for (int yo = 0; yo < mcu_rows; yo++) {
        if (restart_interval_ && restart_rows_to_go == 0) {
          read_restart_marker();
          br.reset();
          if (marker_ == 0) insufficient = false;
          std::fill(first_row, first_row + 10, true);
          restart_rows_to_go = restart_interval_ / per_row;
        }
        if (insufficient) {
          for (int i = 0; i < comps_in_scan_; i++) {
            const size_t width = diff[i].size() / comp_[scan_[i]].v;
            std::fill(diff[i].begin() + (single ? yo * width : 0), diff[i].begin() + (single ? (yo + 1) * width : diff[i].size()), 0);
          }
          std::fill(first_row, first_row + 10, true);
        } else if (single) {
          int* d = diff[0].data() + (size_t)yo * c0.dw;
          for (int x = 0; x < per_row; x++) d[x] = sample_diff(tbl[c0.dc_tbl]);
          insufficient = br.exhausted();
        } else {
          for (int mx = 0; mx < per_row; mx++)
            for (int i = 0; i < comps_in_scan_; i++) {
              const Component& c = comp_[scan_[i]];
              const size_t width = (size_t)mcux_ * c.h;
              for (int yy = 0; yy < c.v; yy++)
                for (int xx = 0; xx < c.h; xx++) diff[i][yy * width + (size_t)mx * c.h + xx] = sample_diff(tbl[c.dc_tbl]);
            }
          insufficient = br.exhausted();
        }
        if (restart_interval_) restart_rows_to_go--;
      }
      for (int i = 0; i < comps_in_scan_; i++) {
        Component& c = comp_[scan_[i]];
        const size_t width = diff[i].size() / c.v;
        for (int r = 0; r < rows_of(c); r++) {
          const int* d = diff[i].data() + r * width;
          int* p = prev[i].data();  // the row above, overwritten by this row
          int ra;
          if (first_row[scan_[i]]) {
            first_row[scan_[i]] = false;
            ra = (d[0] + (1 << (7 - al_))) & 0xFFFF;
            p[0] = ra;
            for (int x = 1; x < c.dw; x++) p[x] = ra = (d[x] + ra) & 0xFFFF;
          } else {
            int rb = p[0], rc;
            p[0] = ra = (d[0] + rb) & 0xFFFF;
            for (int x = 1; x < c.dw; x++) {
              rc = rb;
              rb = p[x];
              int pred;
              switch (ss_) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              p[x] = ra = (d[x] + pred) & 0xFFFF;
            }
          }
          uint8_t* out = c.samples.data() + ((size_t)iy * c.v + r) * c.dw;
          for (int x = 0; x < c.dw; x++) out[x] = (uint8_t)(p[x] << al_);
        }
      }
    }
    return "";
  }

  // jdmarker.c's read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker() {
    if (marker_ == 0) marker_ = src_.next_marker();
    const int desired = next_restart_;
    if (marker_ == 0xD0 + desired) {
      marker_ = 0;
    } else {
      for (;;) {
        const int m = marker_;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker_ = 0;
          break;
        }
        if (action == 3) break;
        marker_ = src_.next_marker();
      }
    }
    next_restart_ = (next_restart_ + 1) & 7;
  }

  std::string mcu_sequential(BitReader& br, int16_t** blocks, const int* comp, int n, const Derived* dcd,
                             const Derived* acd, int* pred) {
    for (int b = 0; b < n; b++) {
      const Component& c = comp_[scan_[comp[b]]];
      int16_t* blk = blocks[b];
      int s = br.decode(dcd[c.dc_tbl]);
      if (s) s = extend(br.bits(s), s);
      pred[comp[b]] = (int)((unsigned)pred[comp[b]] + (unsigned)s);
      blk[0] = (int16_t)pred[comp[b]];
      const Derived& ac = acd[c.ac_tbl];
      for (int k = 1; k < 64; k++) {
        s = br.decode(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    return "";
  }

  std::string mcu_dc_first(BitReader& br, int16_t** blocks, const int* comp, int n, const Derived* dcd,
                           int* pred) {
    for (int b = 0; b < n; b++) {
      const Component& c = comp_[scan_[comp[b]]];
      int s = br.decode(dcd[c.dc_tbl]);
      if (s) s = extend(br.get(s), s);
      int& last = pred[comp[b]];
      if ((last >= 0 && s > INT_MAX - last) || (last < 0 && s < INT_MIN - last)) return "bad JPEG DC coefficient";
      last += s;
      blocks[b][0] = (int16_t)(int)((unsigned)last << al_);
    }
    return "";
  }

  void mcu_dc_refine(BitReader& br, int16_t** blocks, int n) {
    for (int b = 0; b < n; b++)
      if (br.get(1)) blocks[b][0] = (int16_t)(blocks[b][0] | (1 << al_));
  }

  void mcu_ac_first(BitReader& br, int16_t* blk, const Derived& tbl, int* eobrun) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int k = ss_; k <= se_; k++) {
      int s = br.decode(tbl);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(br.get(s), s) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get(r);
        (*eobrun)--;
        break;
      }
    }
  }

  void mcu_ac_refine(BitReader& br, int16_t* blk, const Derived& tbl, int* eobrun) {
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int k = ss_;
    if (*eobrun == 0) {
      for (; k <= se_; k++) {
        int s = br.decode(tbl);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (*eobrun > 0) {
      for (; k <= se_; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      (*eobrun)--;
    }
  }

  // jdcoefct.c's smoothing_ok: would libjpeg block-smooth this image? (Some
  // of coefficients 1-9 of a component not known exactly, every component's
  // DC partly known, no zero among the ten quantizers the estimates divide by.)
  bool smoothing_applies() const {
    static constexpr int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q00 Q01 Q10 Q20 Q11 Q02 Q03 Q12 Q21 Q30
    bool useful = false;
    for (const Component& c : comp_) {
      for (int i = 0; i < 10; i++)
        if (c.latched && c.q[kQ[i]] == 0) return false;
      if (!c.latched) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; i++)
        if (c.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data: the IDCT of each block after the
  // coefficients 1-9 that are zero and not known exactly (their coef_bits
  // not 0) are estimated from the DC values of the 5 x 5 blocks around it
  // (and the DC itself where no AC coefficient was coded). The estimates are
  // libjpeg's, integer for integer. iMCU rows the last scan did not reach
  // before its data ran out (last_good_imcu_) use the coef_bits from before
  // that scan. The neighbouring block rows: libjpeg-turbo 2.1 (kRgb) takes
  // those of the next / previous two iMCU rows only where such rows exist,
  // which at v >= 2 drops some that do; 3.1 (the OpenCV targets) takes every
  // row before, and every row after in the iMCU rows it holds: at the
  // bottom, those of dummy blocks (their DC is the encoder's copy of the
  // last real block's in the MCU). The DC values slide along a row in five
  // registers as libjpeg's do (in an image two blocks wide the right-hand
  // registers do not repeat the edge block).
  void smooth_idct(const Component& c, uint8_t* plane, size_t stride) const {
    int cur[10], prev[10];
    for (int k = 0; k < 10; k++) {
      cur[k] = c.coef_bits[k];
      prev[k] = scan_number_ > 1 ? c.prev_bits[k] : -1;
    }
    const int64_t q00 = c.q[0], q01 = c.q[1], q10 = c.q[8], q20 = c.q[16], q11 = c.q[9], q02 = c.q[2], q03 = c.q[3],
                  q12 = c.q[10], q21 = c.q[17], q30 = c.q[24];
    const int last_imcu = mcuy_ - 1, last_col = c.bw - 1;
    const bool whole_rows = target_ != JpegTarget::kRgb;
    alignas(32) int16_t ws[64];
    for (int by = 0; by < c.bh; by++) {
      const int imcu = by / c.v, block_row = by % c.v;
      const int block_rows = imcu < last_imcu || c.bh % c.v == 0 ? c.v : c.bh % c.v;
      int rp, rpp, rn, rnn;
      if (whole_rows) {
        // rows before: any; after: any in the iMCU rows libjpeg holds, which
        // past the last iMCU row's are the padding rows of dummy blocks
        const int reach = imcu + 1 < last_imcu ? INT_MAX
                          : imcu < last_imcu   ? (imcu + 2) * c.v
                                               : by - block_row + block_rows;
        rp = by > 0 ? by - 1 : by;
        rpp = by > 1 ? by - 2 : rp;
        rn = by + 1 < reach ? by + 1 : by;
        rnn = by + 2 < reach ? by + 2 : rn;
      } else {
        rp = block_row > 0 || imcu > 0 ? by - 1 : by;
        rpp = block_row > 1 || imcu > 1 ? by - 2 : rp;
        rn = block_row < block_rows - 1 || imcu < last_imcu ? by + 1 : by;
        rnn = block_row < block_rows - 2 || imcu + 1 < last_imcu ? by + 2 : rn;
      }
      const int* bits = imcu > last_good_imcu_ ? prev : cur;
      bool change_dc = true;  // no AC coefficient coded: the DC is estimated too
      for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
      const int16_t* row[5];
      const int rows[5] = {rpp, rp, by, rn, rnn};
      for (int r = 0; r < 5; r++) row[r] = c.coef.data() + (size_t)rows[r] * c.bw_alloc * 64;
      int dc[5][5];  // dc[r][j]: libjpeg's DC(5 r + j + 1), column j - 2 around the block
      for (int r = 0; r < 5; r++)
        for (int j = 0; j < 5; j++) dc[r][j] = row[r][0];
      for (int bx = 0; bx <= last_col; bx++) {
        if (bx == 0 && bx < last_col)
          for (int r = 0; r < 5; r++) dc[r][3] = row[r][(size_t)(bx + 1) * 64];
        if (bx + 1 < last_col)
          for (int r = 0; r < 5; r++) dc[r][4] = row[r][(size_t)(bx + 2) * 64];
        std::memcpy(ws, row[2] + (size_t)bx * 64, sizeof ws);
        const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3], DC05 = dc[0][4];
        const int DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3], DC10 = dc[1][4];
        const int DC11 = dc[2][0], DC12 = dc[2][1], DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4];
        const int DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4];
        const int DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3], DC25 = dc[4][4];
        // coefficient ``pos`` estimated as q00 * sum / (q << 8), rounded, and
        // held below 2^Al where Al > 0
        auto estimate = [&](int al, int pos, int64_t q, int64_t sum) {
          if (al == 0 || ws[pos] != 0) return;
          const int64_t num = q00 * sum;
          int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
          if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          ws[pos] = (int16_t)(num >= 0 ? pred : -pred);
        };
        estimate(bits[1], 1, q01,
                 change_dc ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                                 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                                 DC21 - DC22 + DC24 + DC25
                           : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
        estimate(bits[2], 8, q10,
                 change_dc ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                                 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25
                           : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
        estimate(bits[3], 16, q20,
                 change_dc ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                                 7 * DC18 + 2 * DC19 + DC23
                           : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
        estimate(bits[4], 9, q11,
                 change_dc ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25
                           : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
                                 10 * DC07 - 10 * DC09);
        estimate(bits[5], 2, q02,
                 change_dc ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                                 2 * DC17 - 5 * DC18 + 2 * DC19
                           : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
        if (change_dc) {
          estimate(bits[6], 3, q03, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
          estimate(bits[7], 10, q12, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
          estimate(bits[8], 17, q21, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
          estimate(bits[9], 24, q30, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
          const int64_t num =
              q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                     6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                     6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25);
          const int pred = (int)(((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
          ws[0] = (int16_t)(num >= 0 ? pred : -pred);
        }
        idct_islow(ws, c.q, plane + (size_t)by * 8 * stride + (size_t)bx * 8, stride);
        for (int r = 0; r < 5; r++)
          for (int j = 0; j < 4; j++) dc[r][j] = dc[r][j + 1];
      }
    }
  }

  // IDCT every block into a plane per component, then upsample and convert
  // row by row.
  std::string output(Image* img) {
    const int nc = (int)comp_.size();
    std::vector<std::unique_ptr<uint8_t[]>> planes(nc);  // every sample written by the IDCT
    std::vector<const uint8_t*> plane_of(nc);
    std::vector<size_t> stride_of(nc);
    for (int ci = 0; ci < nc; ci++) {
      Component& c = comp_[ci];
      if (lossless_) {  // the decoded samples (zeros for a component no scan reached)
        if (c.samples.empty()) c.samples.assign((size_t)c.dw * c.dh, 0);
        plane_of[ci] = c.samples.data();
        stride_of[ci] = (size_t)c.dw;
        continue;
      }
      const size_t stride = (size_t)c.bw * 8;
      planes[ci].reset(new uint8_t[stride * c.bh * 8]);
      plane_of[ci] = planes[ci].get();
      stride_of[ci] = stride;
      if (c.coef.empty()) c.coef.assign((size_t)c.bw_alloc * c.bh_alloc * 64, 0);  // never scanned: zeros
      if (smooth_) {
        smooth_idct(c, planes[ci].get(), stride);
        continue;
      }
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(c.coef.data() + ((size_t)by * c.bw_alloc + bx) * 64, c.q,
                     planes[ci].get() + (size_t)by * 8 * stride + (size_t)bx * 8, stride);
    }
    lap(1);
    // jdsample.c's method per component (a lossless file's min_DCT_scaled_size
    // of 1 turns fancy upsampling off: every ratio replicates)
    enum Method { kFull, kH2V1, kH1V2, kH2V2, kBox };
    std::vector<Method> method(nc);
    std::vector<int> hr(nc), vr(nc);
    for (int ci = 0; ci < nc; ci++) {
      const Component& c = comp_[ci];
      if (hmax_ % c.h || vmax_ % c.v) return "JPEG with fractional sampling ratios is not supported";
      hr[ci] = hmax_ / c.h;
      vr[ci] = vmax_ / c.v;
      if (hr[ci] == 1 && vr[ci] == 1)
        method[ci] = kFull;
      else if (hr[ci] == 2 && vr[ci] == 1)
        method[ci] = c.dw > 2 ? kH2V1 : kBox;
      else if (hr[ci] == 1 && vr[ci] == 2)
        method[ci] = kH1V2;
      else if (hr[ci] == 2 && vr[ci] == 2)
        method[ci] = c.dw > 2 ? kH2V2 : kBox;
      else
        method[ci] = kBox;
      if (lossless_ && method[ci] != kFull) method[ci] = kBox;
    }
    const int w = width_, h = height_;
    std::vector<std::vector<uint8_t>> rows(nc, std::vector<uint8_t>((size_t)w + 32));
    std::vector<int> colsum;
    std::vector<uint8_t> pixels((size_t)w * h * 3);
    const uint8_t* up[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int y = 0; y < h; y++) {
      for (int ci = 0; ci < nc; ci++) {
        const Component& c = comp_[ci];
        const size_t stride = stride_of[ci];
        const uint8_t* plane = plane_of[ci];
        uint8_t* out = rows[ci].data();
        const int dw = c.dw;
        switch (method[ci]) {
          case kFull:
            up[ci] = plane + (size_t)y * stride;
            continue;
          case kH2V1: {
            const uint8_t* in = plane + (size_t)y * stride;
            out[0] = in[0];
            out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; x++) {
              const int v = in[x] * 3;
              out[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
              out[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
            }
            out[2 * (dw - 1)] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
            out[2 * dw - 1] = in[dw - 1];
            break;
          }
          case kH1V2: {
            const int r = y >> 1, below = y & 1;
            const uint8_t* near = plane + (size_t)r * stride;
            const uint8_t* far = plane + (size_t)(below ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0)) * stride;
            const int bias = below ? 2 : 1;
            for (int x = 0; x < dw; x++) out[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
            break;
          }
          case kH2V2: {
            const int r = y >> 1, below = y & 1;
            const uint8_t* near = plane + (size_t)r * stride;
            const uint8_t* far = plane + (size_t)(below ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0)) * stride;
            colsum.resize(dw);
            for (int x = 0; x < dw; x++) colsum[x] = near[x] * 3 + far[x];
            out[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
            out[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
            for (int x = 1; x < dw - 1; x++) {
              out[2 * x] = (uint8_t)((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
              out[2 * x + 1] = (uint8_t)((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
            }
            out[2 * (dw - 1)] = (uint8_t)((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
            out[2 * dw - 1] = (uint8_t)((colsum[dw - 1] * 4 + 7) >> 4);
            break;
          }
          case kBox: {
            const uint8_t* in = plane + (size_t)(y / vr[ci]) * stride;
            for (int x = 0; x < w; x++) out[x] = in[x / hr[ci]];
            break;
          }
        }
        up[ci] = out;
      }
      uint8_t* o = pixels.data() + (size_t)y * w * 3;
      convert_row(up, o, w);
    }
    std::string err = orient(std::move(pixels), img);
    lap(2);
    return err;
  }

  using Clock = std::chrono::steady_clock;
  void lap(int stage) {
    const Clock::time_point now = Clock::now();
    stage_s_[stage] = std::chrono::duration<double>(now - lap_).count();
    lap_ = now;
  }

  void convert_row(const uint8_t* const* in, uint8_t* o, int w) const {
    switch (space_) {
      case kGray:
        for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[0][x];
        break;
      case kRgbSpace:
        for (int x = 0; x < w; x++) {
          o[3 * x] = in[0][x];
          o[3 * x + 1] = in[1][x];
          o[3 * x + 2] = in[2][x];
        }
        break;
      case kYcc:
        for (int x = 0; x < w; x++) {
          const int y = in[0][x], cb = in[1][x], cr = in[2][x];
          o[3 * x] = clamp255(y + kYccTab.cr_r[cr]);
          o[3 * x + 1] = clamp255(y + (int)((kYccTab.cb_g[cb] + kYccTab.cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp255(y + kYccTab.cb_b[cb]);
        }
        break;
      case kCmyk:
      case kYcck:
        for (int x = 0; x < w; x++) {
          int cmy[3];
          if (space_ == kCmyk) {
            cmy[0] = in[0][x];
            cmy[1] = in[1][x];
            cmy[2] = in[2][x];
          } else {  // jdcolor.c's ycck_cmyk_convert
            const int y = in[0][x], cb = in[1][x], cr = in[2][x];
            cmy[0] = clamp255(255 - (y + kYccTab.cr_r[cr]));
            cmy[1] = clamp255(255 - (y + (int)((kYccTab.cb_g[cb] + kYccTab.cr_g[cr]) >> 16)));
            cmy[2] = clamp255(255 - (y + kYccTab.cb_b[cb]));
          }
          const int k = in[3][x];
          // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
          for (int i = 0; i < 3; i++) o[3 * x + i] = (uint8_t)(k - ((255 - cmy[i]) * k >> 8));
        }
        break;
    }
  }

  // OpenCV's ExifTransform for orientations 2-8 (the OpenCV targets only)
  std::string orient(std::vector<uint8_t> pixels, Image* img) const {
    const int w = width_, h = height_;
    const int o = target_ != JpegTarget::kRgb ? orientation_ : 1;
    if (o < 2 || o > 8) {
      img->width = w;
      img->height = h;
      img->rgb = std::move(pixels);
      return "";
    }
    const bool transposed = o >= 5;
    const int ow = transposed ? h : w, oh = transposed ? w : h;
    img->width = ow;
    img->height = oh;
    img->rgb.resize((size_t)ow * oh * 3);
    for (int i = 0; i < oh; i++) {
      for (int j = 0; j < ow; j++) {
        int sy = i, sx = j;
        switch (o) {
          case 2: sx = w - 1 - j; break;
          case 3: sy = h - 1 - i; sx = w - 1 - j; break;
          case 4: sy = h - 1 - i; break;
          case 5: sy = j; sx = i; break;
          case 6: sy = h - 1 - j; sx = i; break;
          case 7: sy = h - 1 - j; sx = w - 1 - i; break;
          case 8: sy = j; sx = w - 1 - i; break;
        }
        std::memcpy(&img->rgb[((size_t)i * ow + j) * 3], &pixels[((size_t)sy * w + sx) * 3], 3);
      }
    }
    return "";
  }

  enum Space { kGray, kRgbSpace, kYcc, kCmyk, kYcck };
  JpegTarget target_;
  Source src_{};
  int marker_ = 0;  // libjpeg's unread_marker
  bool saw_sof_ = false, progressive_ = false, arith_ = false, lossless_ = false, saw_jfif_ = false,
       saw_adobe_ = false, saw_app1_ = false;
  bool smooth_ = false;  // output through smooth_idct
  jpeg_arith::Conditioning cond_;
  int scan_number_ = 0;     // libjpeg's input_scan_number
  int last_good_imcu_ = 0;  // master->last_good_iMCU_row: the last iMCU row entered with data left
  Clock::time_point lap_;
  std::array<double, 3> stage_s_{};
  bool std_tables_ = false;
  int adobe_transform_ = 0, orientation_ = 1;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  Space space_ = kYcc;
  std::vector<Component> comp_;
  HuffTable dc_[4], ac_[4];
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {false, false, false, false};
  int restart_interval_ = 0, next_restart_ = 0;
  int comps_in_scan_ = 0, scan_[4] = {0, 0, 0, 0}, ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
};

}  // namespace jpeg_detail

// The JPEG file in d[0, n) -> 8-bit RGB as ``target`` decodes it. Returns ""
// or the reason the file is refused.
inline std::string decode_jpeg(const uint8_t* d, size_t n, JpegTarget target, Image* img) {
  jpeg_detail::Decoder dec(d, n, target);
  return dec.decode(img);
}

// The size decode_jpeg gives (EXIF orientation included for the OpenCV targets) from
// the headers alone.
inline std::string jpeg_size(const uint8_t* d, size_t n, JpegTarget target, int* width, int* height) {
  jpeg_detail::Decoder dec(d, n, target);
  std::string err = dec.read_header();
  if (!err.empty()) return err;
  const bool transposed = target != JpegTarget::kRgb && dec.orientation() >= 5 && dec.orientation() <= 8;
  *width = transposed ? dec.height() : dec.width();
  *height = transposed ? dec.width() : dec.height();
  return "";
}

}  // namespace ufm_image

#endif  // UFM_TORCH_IMAGE_DECODE_H_
