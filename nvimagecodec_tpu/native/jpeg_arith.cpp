// Arithmetic-coded JPEG entropy decoder (ITU-T T.81 Annex K + §F.1.4.4) —
// sequential (SOF9) and progressive (SOF10) DC/AC conditioning over the
// 113-state QM coder. Completes the spec envelope the reference reaches
// through libjpeg's arithmetic option (extensions/libjpeg_turbo/); written
// from the T.81 decoder flowcharts (Figures F.18-F.26).
//
// Output contract matches tic_jpeg_decode_coefficients (jpeg_entropy.cpp):
// per-component MCU-padded [bh, bw, 64] int16 natural-order coefficient
// planes, consumed by the same device/numpy pixel stage.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "jpeg_arith_tables.inc"

namespace {

inline uint16_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// zigzag index -> natural position (T.81 Figure A.6)
static const uint8_t kNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

constexpr int kDcStatBins = 64;
constexpr int kAcStatBins = 256;

// QM arithmetic decoder over one entropy-coded segment. Statistics bins
// are single bytes: state index in bits 0-6, MPS sense in bit 7; the
// non-adaptive equiprobable bin is index 113 (self-pointing).
struct QmDecoder {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t c = 0, a = 0;
  int ct = 0;
  bool marker_hit = false;

  int next_byte() {
    // Stuffed-byte convention (T.81 F.1.4.1.1): an 0xFF run followed by
    // 0x00 carries a literal 0xFF data byte; 0xFF + a marker ends the
    // segment — feed zero bytes from there on (the decoder drains its
    // register past the end, exactly the libjpeg-compatible behavior).
    if (marker_hit || p >= end) return 0;
    int b = *p;
    if (b != 0xFF) {
      p++;
      return b;
    }
    const uint8_t* q = p + 1;
    while (q < end && *q == 0xFF) q++;
    if (q < end && *q == 0x00) {
      p = q + 1;
      return 0xFF;
    }
    marker_hit = true;
    return 0;
  }

  void init(const uint8_t* start, const uint8_t* stop) {
    p = start;
    end = stop;
    marker_hit = false;
    // INITDEC: A spans (0x8000, 0x10000]; the first two data bytes fill
    // the compare window (T.81 F.2.2.5 at the 17-bit A convention)
    uint32_t b0 = (uint32_t)next_byte();
    uint32_t b1 = (uint32_t)next_byte();
    c = (b0 << 24) | (b1 << 16);
    ct = 0;
    a = 0x10000;
  }

  void bytein() {
    c |= (uint32_t)next_byte() << 8;
    ct = 8;
  }

  // DECODE(S) — T.81 Figure F.18 with MPS/LPS exchange (F.20/F.21)
  int decode(uint8_t* st) {
    uint8_t s = *st;
    int idx = s & 0x7F;
    int mps = s >> 7;
    uint32_t qe = kAritab[idx].qe;
    a -= qe;
    int d;
    if ((c >> 16) < a) {
      if (a & 0x8000) return mps;  // no renorm, no state change
      // MPS_EXCHANGE
      if (a < qe) {
        d = 1 - mps;
        if (kAritab[idx].sw) mps ^= 1;
        idx = kAritab[idx].nlps;
      } else {
        d = mps;
        idx = kAritab[idx].nmps;
      }
    } else {
      // LPS_EXCHANGE
      c -= (uint32_t)a << 16;
      if (a < qe) {
        d = mps;
        idx = kAritab[idx].nmps;
      } else {
        d = 1 - mps;
        if (kAritab[idx].sw) mps ^= 1;
        idx = kAritab[idx].nlps;
      }
      a = qe;
    }
    // RENORMD (target: a back in (0x8000, 0x10000])
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (!(a & 0x8000));
    *st = (uint8_t)((mps << 7) | idx);
    return d;
  }
};

struct Component {
  int id = 0, h = 1, v = 1;
  int bw = 0, bh = 0;          // MCU-padded block grid
  int true_bw = 0, true_bh = 0;  // ceil(samples/8) grid (non-interleaved)
  int16_t* coef = nullptr;
  int last_dc = 0;
  int dc_context = 0;
};

struct Scan {
  int ncomp = 0;
  int comp_idx[4] = {0};
  int dc_tbl[4] = {0};
  int ac_tbl[4] = {0};
  int ss = 0, se = 63, ah = 0, al = 0;
  int restart_interval = 0;
  const uint8_t* data_start = nullptr;
  const uint8_t* data_end = nullptr;
};

struct ArithJpeg {
  const uint8_t* base;
  size_t len;
  int width = 0, height = 0, precision = 0, ncomp = 0;
  bool progressive = false;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  Component comps[4];
  int restart_interval = 0;
  uint8_t dc_L[4] = {0, 0, 0, 0};
  uint8_t dc_U[4] = {1, 1, 1, 1};
  uint8_t ac_K[4] = {5, 5, 5, 5};
  uint8_t dc_stats[4][kDcStatBins];
  uint8_t ac_stats[4][kAcStatBins];
  uint8_t fixed_bin = 113;  // equiprobable, non-adapting state
  QmDecoder qm;
  int error = 0;

  bool parse_and_decode();
  void decode_scan(Scan& s);
  bool decode_mcu_seq(Scan& s, int mx, int my);
  bool decode_block_dc(Scan& s, int j, int16_t* blk, int al, bool emit);
  bool decode_block_ac(Scan& s, int j, int16_t* blk, int ss, int se, int al);
  bool refine_block_ac(Scan& s, int j, int16_t* blk, int ss, int se, int al);
  void reset_scan_state(Scan& s);
};

void ArithJpeg::reset_scan_state(Scan& s) {
  // Statistics areas and DC predictors reset at scan start and at every
  // restart marker (T.81 F.1.4.4 / K.2)
  for (int j = 0; j < s.ncomp; j++) {
    memset(dc_stats[s.dc_tbl[j]], 0, kDcStatBins);
    memset(ac_stats[s.ac_tbl[j]], 0, kAcStatBins);
    comps[s.comp_idx[j]].last_dc = 0;
    comps[s.comp_idx[j]].dc_context = 0;
  }
}

// DC difference decode (T.81 Figure F.22 + context classification F.12).
// emit=false only tracks state (refinement scans never call this).
bool ArithJpeg::decode_block_dc(Scan& s, int j, int16_t* blk, int al,
                                bool emit) {
  Component& cc = comps[s.comp_idx[j]];
  int tbl = s.dc_tbl[j];
  uint8_t* stats = dc_stats[tbl];
  uint8_t* st = stats + cc.dc_context;
  if (qm.decode(st) == 0) {
    cc.dc_context = 0;
  } else {
    int sign = qm.decode(st + 1);
    st += 2 + sign;
    int m = qm.decode(st);
    if (m != 0) {
      // magnitude category: X1 bin fixed at offset 20 (T.81 Table F.4)
      st = stats + 20;
      while (qm.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          error = 1;
          return false;
        }
        st++;
      }
    }
    // conditioning category for the NEXT block (F.1.4.4.1.3)
    if (m < (int)((1 << dc_L[tbl]) >> 1))
      cc.dc_context = 0;
    else if (m > (int)((1 << dc_U[tbl]) >> 1))
      cc.dc_context = 12 + (sign << 2);
    else
      cc.dc_context = 4 + (sign << 2);
    int v = m;
    st += 14;  // magnitude-bits bins follow the X bins
    while (m >>= 1)
      if (qm.decode(st)) v |= m;
    v += 1;
    cc.last_dc += sign ? -v : v;
  }
  if (emit) blk[0] = (int16_t)(cc.last_dc << al);
  return true;
}

// AC band decode, sequential and progressive-first (T.81 Figure F.23-F.25)
bool ArithJpeg::decode_block_ac(Scan& s, int j, int16_t* blk, int ss,
                                int se, int al) {
  int tbl = s.ac_tbl[j];
  uint8_t* stats = ac_stats[tbl];
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (qm.decode(st)) break;  // EOB
    while (qm.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) {
        error = 2;
        return false;
      }
    }
    int sign = qm.decode(&fixed_bin);
    st += 2;
    int m = qm.decode(st);
    if (m != 0) {
      if (qm.decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_K[tbl] ? 189 : 217);
        while (qm.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            error = 3;
            return false;
          }
          st++;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (qm.decode(st)) v |= m;
    v += 1;
    blk[kNat[k]] = (int16_t)((sign ? -v : v) << al);
  }
  return true;
}

// AC refinement scan (T.81 Figure G.10 analog for arithmetic coding)
bool ArithJpeg::refine_block_ac(Scan& s, int j, int16_t* blk, int ss,
                                int se, int al) {
  int tbl = s.ac_tbl[j];
  uint8_t* stats = ac_stats[tbl];
  int p1 = 1 << al;
  int m1 = -p1;
  int kex = se;
  while (kex > 0 && blk[kNat[kex]] == 0) kex--;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && qm.decode(st)) break;  // EOB
    for (;;) {
      int16_t* coef = blk + kNat[k];
      if (*coef) {
        if (qm.decode(st + 2)) *coef += (*coef < 0) ? m1 : p1;
        break;
      }
      if (qm.decode(st + 1)) {
        *coef = (int16_t)(qm.decode(&fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        error = 4;
        return false;
      }
    }
  }
  return true;
}

bool ArithJpeg::decode_mcu_seq(Scan& s, int mx, int my) {
  bool single = (s.ncomp == 1);
  for (int j = 0; j < s.ncomp; j++) {
    Component& cc = comps[s.comp_idx[j]];
    int ch = single ? 1 : cc.h;
    int cv = single ? 1 : cc.v;
    for (int by = 0; by < cv; by++)
      for (int bx = 0; bx < ch; bx++) {
        int row = single ? my : my * cc.v + by;
        int col = single ? mx : mx * cc.h + bx;
        int16_t* blk = cc.coef + ((size_t)row * cc.bw + col) * 64;
        if (!decode_block_dc(s, j, blk, 0, true)) return false;
        if (!decode_block_ac(s, j, blk, 1, 63, 0)) return false;
      }
  }
  return true;
}

void ArithJpeg::decode_scan(Scan& s) {
  bool single = (s.ncomp == 1);
  Component& c0 = comps[s.comp_idx[0]];
  long units_x = single ? c0.true_bw : mcus_x;
  long units_y = single ? c0.true_bh : mcus_y;
  long total = units_x * units_y;
  long per_restart =
      s.restart_interval > 0 ? s.restart_interval : total;

  const uint8_t* seg = s.data_start;
  long done = 0;
  while (done < total) {
    reset_scan_state(s);
    qm.init(seg, s.data_end);
    long n = per_restart;
    if (n > total - done) n = total - done;
    for (long u = done; u < done + n; u++) {
      long my = u / units_x;
      long mx = u % units_x;
      bool ok;
      if (!progressive) {
        ok = decode_mcu_seq(s, (int)mx, (int)my);
      } else if (s.ss == 0) {
        // DC scan (always interleaved component loop over the MCU)
        ok = true;
        for (int j = 0; j < s.ncomp && ok; j++) {
          Component& cc = comps[s.comp_idx[j]];
          int ch = single ? 1 : cc.h;
          int cv = single ? 1 : cc.v;
          for (int by = 0; by < cv && ok; by++)
            for (int bx = 0; bx < ch && ok; bx++) {
              long row = single ? my : my * cc.v + by;
              long col = single ? mx : mx * cc.h + bx;
              int16_t* blk = cc.coef + ((size_t)row * cc.bw + col) * 64;
              if (s.ah == 0) {
                ok = decode_block_dc(s, j, blk, s.al, true);
              } else {
                // DC refinement: one equiprobable decision per block
                if (qm.decode(&fixed_bin)) blk[0] |= (int16_t)(1 << s.al);
              }
            }
        }
      } else {
        // AC scans are single-component (T.81 G.1)
        int16_t* blk =
            c0.coef + ((size_t)my * c0.bw + mx) * 64;
        ok = (s.ah == 0)
                 ? decode_block_ac(s, 0, blk, s.ss, s.se, s.al)
                 : refine_block_ac(s, 0, blk, s.ss, s.se, s.al);
      }
      if (!ok) return;
    }
    done += n;
    if (done < total) {
      // realign past the RSTn marker the segment ended at
      const uint8_t* q = qm.p;
      while (q + 1 < s.data_end &&
             !(q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7))
        q++;
      if (q + 1 >= s.data_end) {
        error = 5;
        return;
      }
      seg = q + 2;
    }
  }
}

bool ArithJpeg::parse_and_decode() {
  const uint8_t* p = base;
  const uint8_t* end = base + len;
  if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return false;
  p += 2;
  bool have_sof = false;

  while (p + 2 <= end) {
    if (p[0] != 0xFF) {
      p++;
      continue;
    }
    uint8_t m = p[1];
    if (m == 0xFF) {
      p++;
      continue;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) {
      p += 2;
      continue;
    }
    if (m == 0xD9) break;  // EOI
    if (p + 4 > end) break;
    int seglen = be16(p + 2);
    const uint8_t* seg = p + 4;
    const uint8_t* segend = p + 2 + seglen;
    if (segend > end) return false;

    switch (m) {
      case 0xC9: case 0xCA: {  // SOF9 sequential / SOF10 progressive arith
        progressive = (m == 0xCA);
        precision = seg[0];
        height = be16(seg + 1);
        width = be16(seg + 3);
        ncomp = seg[5];
        if (ncomp < 1 || ncomp > 4 || (precision != 8 && precision != 12))
          return false;
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; c++) {
          comps[c].id = seg[6 + 3 * c];
          comps[c].h = seg[7 + 3 * c] >> 4;
          comps[c].v = seg[7 + 3 * c] & 15;
          if (comps[c].h < 1 || comps[c].v < 1 || comps[c].h > 4 ||
              comps[c].v > 4)
            return false;
          if (comps[c].h > hmax) hmax = comps[c].h;
          if (comps[c].v > vmax) vmax = comps[c].v;
        }
        mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
        mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; c++) {
          Component& cc = comps[c];
          cc.bw = mcus_x * cc.h;
          cc.bh = mcus_y * cc.v;
          int tw = (width * cc.h + hmax - 1) / hmax;
          int th = (height * cc.v + vmax - 1) / vmax;
          cc.true_bw = (tw + 7) / 8;
          cc.true_bh = (th + 7) / 8;
          cc.coef =
              (int16_t*)calloc((size_t)cc.bw * cc.bh * 64, sizeof(int16_t));
          if (!cc.coef) return false;
        }
        have_sof = true;
        break;
      }
      case 0xC0: case 0xC1: case 0xC2: case 0xC3:
      case 0xC5: case 0xC6: case 0xC7:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return false;  // Huffman / lossless / differential: not this path
      case 0xCC: {  // DAC — arithmetic conditioning (T.81 B.2.4.3)
        const uint8_t* q = seg;
        while (q + 2 <= segend) {
          int tc = q[0] >> 4, tb = q[0] & 15;
          if (tb > 3) return false;
          if (tc == 0) {
            dc_L[tb] = q[1] & 15;
            dc_U[tb] = q[1] >> 4;
            if (dc_L[tb] > dc_U[tb]) return false;
          } else if (tc == 1) {
            if (q[1] < 1 || q[1] > 63) return false;
            ac_K[tb] = q[1];
          } else {
            return false;
          }
          q += 2;
        }
        break;
      }
      case 0xDD:
        restart_interval = be16(seg);
        break;
      case 0xDA: {  // SOS
        if (!have_sof) return false;
        Scan s;
        s.ncomp = seg[0];
        if (s.ncomp < 1 || s.ncomp > 4) return false;
        if (seg + 4 + 2 * s.ncomp > segend) return false;
        for (int j = 0; j < s.ncomp; j++) {
          int cid = seg[1 + 2 * j];
          int tt = seg[2 + 2 * j];
          if ((tt >> 4) > 3 || (tt & 15) > 3) return false;
          int idx = -1;
          for (int c = 0; c < ncomp; c++)
            if (comps[c].id == cid) idx = c;
          if (idx < 0) return false;
          s.comp_idx[j] = idx;
          s.dc_tbl[j] = tt >> 4;
          s.ac_tbl[j] = tt & 15;
        }
        s.ss = seg[1 + 2 * s.ncomp];
        s.se = seg[2 + 2 * s.ncomp];
        int ahal = seg[3 + 2 * s.ncomp];
        s.ah = ahal >> 4;
        s.al = ahal & 15;
        if (s.ss > 63 || s.se > 63 || s.ss > s.se) return false;
        if (progressive) {
          if (s.ss == 0 && s.se != 0) return false;
          if (s.ss > 0 && s.ncomp != 1) return false;
          if (s.al > 13 || s.ah > 13) return false;
        } else {
          if (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0)
            return false;
        }
        s.restart_interval = restart_interval;
        s.data_start = segend;
        const uint8_t* q = segend;
        while (q + 1 < end) {
          if (q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7))
            break;
          q++;
        }
        s.data_end = q;
        decode_scan(s);
        if (error) return false;
        p = q;
        continue;
      }
      default:
        break;  // APPn / COM / DQT etc: pixel stage reads tables in Python
    }
    p = segend;
  }
  return have_sof;
}

}  // namespace

extern "C" {

void tic_free(void* p);

// Same contract as tic_jpeg_decode_coefficients: mallocs per-component
// MCU-padded [bh, bw, 64] int16 planes. Returns 0 ok, nonzero error.
int tic_jpeg_arith_decode_coefficients(const uint8_t* data, size_t len,
                                       int16_t** coefs, int32_t* bw,
                                       int32_t* bh, int32_t* ncomp_out) {
  ArithJpeg d;
  d.base = data;
  d.len = len;
  bool ok = d.parse_and_decode();
  if (!ok) {
    for (int c = 0; c < 4; c++)
      if (d.comps[c].coef) free(d.comps[c].coef);
    return d.error ? d.error : -1;
  }
  for (int c = 0; c < d.ncomp; c++) {
    coefs[c] = d.comps[c].coef;
    bw[c] = d.comps[c].bw;
    bh[c] = d.comps[c].bh;
  }
  *ncomp_out = d.ncomp;
  return 0;
}

}  // extern "C"
