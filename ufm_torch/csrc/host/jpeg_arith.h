// Arithmetic-coded JPEG entropy decoding (ITU T.81 Annex D, F.2.4 and
// G.2), as libjpeg-turbo's jdarith.c decodes it: the QM coder with Table
// D.2's probability estimates, DC (conditioned by the DAC marker's L and U)
// and AC (conditioned by K) statistics, sequential scans, and progressive
// DC first / refine and AC first / refine scans. Included by image_decode.h.
//
// As in libjpeg, a marker met inside the entropy data is legal: it is kept
// for the marker reader and zeros are decoded from there on; a magnitude or
// spectral overflow (corrupt data) leaves the rest of the scan's blocks as
// they are until the next restart. No mutable static state.

#ifndef UFM_TORCH_JPEG_ARITH_H_
#define UFM_TORCH_JPEG_ARITH_H_

#include <cstdint>
#include <cstring>

namespace ufm_image {
namespace jpeg_arith {

// Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the fixed 0.5 estimate of
// the sign and refinement bits.
constexpr uint32_t V(uint32_t qe, uint32_t lps, uint32_t mps, uint32_t sw) {
  return qe << 16 | mps << 8 | sw << 7 | lps;
}
inline constexpr uint32_t kQe[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};

constexpr int kTables = 16, kDcBins = 64, kAcBins = 256;

// The DAC marker's conditioning: DC L / U and AC K per table (defaults 0, 1, 5)
struct Conditioning {
  uint8_t dc_l[kTables], dc_u[kTables], ac_k[kTables];
  Conditioning() {
    std::memset(dc_l, 0, sizeof dc_l);
    std::memset(dc_u, 1, sizeof dc_u);
    std::memset(ac_k, 5, sizeof ac_k);
  }
};

// One scan's decoder. ``Source`` has ``int byte()``: the next byte of the
// file (libjpeg's source manager, a fake EOI past the end); ``*marker`` is
// libjpeg's unread_marker, shared with the marker reader.
template <class Source>
class Scan {
 public:
  Scan(Source* src, int* marker, const Conditioning& cond, const int* natural)
      : src_(src), marker_(marker), cond_(cond), natural_(natural) {
    std::memset(dc_stats_, 0, sizeof dc_stats_);
    std::memset(ac_stats_, 0, sizeof ac_stats_);
    fixed_bin_ = 113;
  }

  // jdarith.c's start_pass / process_restart: zero the statistics of the
  // scan's tables, the DC predictions and the coder. ``dc`` / ``ac``: the
  // scan codes DC / AC coefficients (a sequential scan both).
  void reset(int ncomp, const int* dc_tbl, const int* ac_tbl, bool dc, bool ac) {
    for (int i = 0; i < ncomp; i++) {
      if (dc) {
        std::memset(dc_stats_[dc_tbl[i]], 0, kDcBins);
        last_dc_[i] = 0;
        dc_context_[i] = 0;
      }
      if (ac) std::memset(ac_stats_[ac_tbl[i]], 0, kAcBins);
    }
    c_ = 0;
    a_ = 0;
    ct_ = -16;  // read two bytes into C first
  }

  // decode_mcu: a sequential MCU; blocks[b] of component comp[b] (index in
  // the scan) with DC / AC tables dc_tbl / ac_tbl of that index
  void mcu_sequential(int16_t** blocks, const int* comp, int n, const int* dc_tbl, const int* ac_tbl) {
    if (ct_ == -1) return;
    for (int b = 0; b < n; b++) {
      const int ci = comp[b];
      if (!decode_dc(dc_tbl[ci], ci)) return;
      blocks[b][0] = (int16_t)last_dc_[ci];
      if (!decode_ac(blocks[b], ac_tbl[ci], 1, 63, 0)) return;
    }
  }

  void mcu_dc_first(int16_t** blocks, const int* comp, int n, const int* dc_tbl, int al) {
    if (ct_ == -1) return;
    for (int b = 0; b < n; b++) {
      const int ci = comp[b];
      if (!decode_dc(dc_tbl[ci], ci)) return;
      blocks[b][0] = (int16_t)(int)((unsigned)last_dc_[ci] << al);
    }
  }

  // no overflow check: jdarith.c's decode_mcu_DC_refine decodes on after one
  void mcu_dc_refine(int16_t** blocks, int n, int al) {
    for (int b = 0; b < n; b++)
      if (decode(&fixed_bin_)) blocks[b][0] = (int16_t)(blocks[b][0] | (1 << al));
  }

  void mcu_ac_first(int16_t* blk, int tbl, int ss, int se, int al) {
    if (ct_ == -1) return;
    decode_ac(blk, tbl, ss, se, al);
  }

  void mcu_ac_refine(int16_t* blk, int tbl, int ss, int se, int al) {
    if (ct_ == -1) return;
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[natural_[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + natural_[k];
        if (*coef) {  // nonzero before: a correction bit
          if (decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (decode(st + 1)) {  // newly nonzero
          *coef = (int16_t)(decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ct_ = -1;  // spectral overflow
          return;
        }
      }
    }
  }

 private:
  // the next byte of entropy data: zeros once a marker was met
  int next_byte() {
    if (*marker_) return 0;
    int data = src_->byte();
    if (data == 0xFF) {
      do data = src_->byte();
      while (data == 0xFF);
      if (data == 0) return 0xFF;
      *marker_ = data;
      return 0;
    }
    return data;
  }

  // arith_decode: one binary decision with the estimate in *st
  int decode(uint8_t* st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        c_ = (c_ << 8) | next_byte();
        if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;  // two initial bytes read
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kQe[sv & 0x7F];
    const uint8_t nl = (uint8_t)(qe & 0xFF), nm = (uint8_t)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {  // conditional LPS exchange
        a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {  // conditional MPS exchange
      if (a_ < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // F.2.4.1: a DC difference into last_dc_[ci]; false on a magnitude overflow
  bool decode_dc(int tbl, int ci) {
    uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
    if (decode(st) == 0) {
      dc_context_[ci] = 0;
      return true;
    }
    const int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats_[tbl] + 20;
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct_ = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << cond_.dc_l[tbl]) >> 1))
      dc_context_[ci] = 0;
    else if (m > (int)((1L << cond_.dc_u[tbl]) >> 1))
      dc_context_[ci] = 12 + sign * 4;
    else
      dc_context_[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc_[ci] = (last_dc_[ci] + v) & 0xFFFF;
    return true;
  }

  // F.2.4.2: coefficients ss..se, each scaled by 2^al; false on an overflow
  bool decode_ac(int16_t* blk, int tbl, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (decode(st)) break;  // EOB
      while (decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ct_ = -1;  // spectral overflow
          return false;
        }
      }
      const int sign = decode(&fixed_bin_);
      st += 2;
      int m = decode(st);
      if (m != 0 && decode(st)) {
        m <<= 1;
        st = ac_stats_[tbl] + (k <= cond_.ac_k[tbl] ? 189 : 217);
        while (decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ct_ = -1;  // magnitude overflow
            return false;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[natural_[k]] = (int16_t)(int)((unsigned)v << al);
    }
    return true;
  }

  Source* src_;
  int* marker_;
  const Conditioning& cond_;
  const int* natural_;
  int64_t c_ = 0, a_ = 0;  // C register (base and bit buffer), A register
  int ct_ = -16;           // bits left in C's buffer part; -1 after a decoding error
  int last_dc_[4] = {0, 0, 0, 0}, dc_context_[4] = {0, 0, 0, 0};
  uint8_t dc_stats_[kTables][kDcBins], ac_stats_[kTables][kAcBins];
  uint8_t fixed_bin_;
};

}  // namespace jpeg_arith
}  // namespace ufm_image

#endif  // UFM_TORCH_JPEG_ARITH_H_
