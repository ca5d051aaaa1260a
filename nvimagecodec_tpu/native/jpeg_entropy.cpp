// JPEG Huffman entropy decode — native host stage.
//
// Counterpart of the CPU Huffman host stage in the reference's
// hybrid decoder (extensions/nvjpeg/cuda_decoder.cpp:412-563:
// nvjpegDecodeJpegHost runs CPU Huffman before the GPU pixel stage). Entropy
// coding is bit-serial and branchy — the one part of JPEG that does not map
// onto matrix units (SURVEY.md §7 "hard parts") — so it runs here at native
// speed and ships quantized coefficient blocks to the device.
//
// Semantics are validated bit-exact against both the pure-Python reference
// decoder (entropy_py.py) and libjpeg's jpeg_read_coefficients.
//
// From-scratch implementation of ITU-T T.81 §F (sequential) and §G
// (progressive) entropy decoding. No reference code used.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// zigzag index -> natural position
static const uint8_t kNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  // two-level decode: 9-bit lookahead LUT, then canonical slow path
  int16_t lut_sym[512];
  int8_t lut_len[512];
  int32_t maxcode[18];   // largest code of length l (as left-justified compare)
  int32_t valptr[18];    // index into values[] of first code of length l
  int32_t mincode[18];
  uint8_t values[256];
  bool valid = false;

  bool build(const uint8_t bits[16], const uint8_t* vals, int nvals) {
    valid = false;
    if (nvals > 256) return false;
    memcpy(values, vals, nvals);
    int code = 0, k = 0;
    int codes[256], lens[256];
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l - 1]; i++) {
        codes[k] = code;
        lens[k] = l;
        code++;
        k++;
      }
      // canonical codes of length l must fit in l bits; a malformed DHT
      // (e.g. bits[1]=255) would otherwise push LUT bases past 512
      if (code > (1 << l)) return false;
      maxcode[l] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < 512; i++) {
      lut_sym[i] = -1;
      lut_len[i] = 0;
    }
    for (int i = 0; i < k; i++) {
      if (lens[i] <= 9) {
        int base = codes[i] << (9 - lens[i]);
        int span = 1 << (9 - lens[i]);
        for (int j = 0; j < span; j++) {
          lut_sym[base + j] = values[i];
          lut_len[base + j] = (int8_t)lens[i];
        }
      }
    }
    valid = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  const uint8_t* marker = nullptr;  // position of 0xFF of a seen marker

  void init(const uint8_t* start, const uint8_t* stop) {
    p = start;
    end = stop;
    acc = 0;
    nbits = 0;
    marker = nullptr;
  }

  inline void refill() {
    // fast path: next 8 bytes contain no 0xFF (no stuffing, no marker) —
    // load them in one shot (libjpeg-turbo-style amortized refill)
    if (!marker && p + 8 <= end) {
      uint64_t v;
      memcpy(&v, p, 8);
      uint64_t nx = ~v;  // has a 0x00 byte iff v has a 0xFF byte
      if (!((nx - 0x0101010101010101ULL) & ~nx & 0x8080808080808080ULL)) {
        int k = (64 - nbits) >> 3;  // bytes that fit
        uint64_t be = __builtin_bswap64(v);
        if (k == 8)
          acc = be;
        else
          acc = (acc << (8 * k)) | (be >> (64 - 8 * k));
        p += k;
        nbits += 8 * k;
        return;
      }
    }
    while (nbits <= 56) {
      uint8_t b = 0;
      if (p < end && !marker) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;  // stuffed
          } else {
            marker = p;  // stop consuming; pad zeros
            b = 0;
          }
        } else {
          p++;
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  inline int peek9() {
    if (nbits < 16) refill();
    return (int)((acc >> (nbits - 9)) & 0x1FF);
  }

  inline void skip(int k) { nbits -= k; }

  inline int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) refill();
    int v = (int)((acc >> (nbits - k)) & ((1u << k) - 1));
    nbits -= k;
    return v;
  }

  inline int get_bit() { return get_bits(1); }

  inline int peek16() {
    if (nbits < 16) refill();
    return (int)((acc >> (nbits - 16)) & 0xFFFF);
  }
};

template <class BR>
inline int decode_huff(BR& br, const HuffTable& t) {
  int idx = br.peek9();
  int len = t.lut_len[idx];
  if (len) {
    br.skip(len);
    return t.lut_sym[idx];
  }
  // slow path: canonical decode beyond 9 bits
  int code = br.peek16();
  for (int l = 10; l <= 16; l++) {
    int c = code >> (16 - l);
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.values[t.valptr[l] + (c - t.mincode[l])];
    }
  }
  return -1;  // invalid
}

inline int extend(int v, int t) {
  if (t == 0) return 0;
  return (v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int16_t* coef = nullptr;  // [bh][bw][64] (wide mode, natural order)
  uint8_t* lo = nullptr;    // [bh][bw][lo_len] packed mode, zigzag low bytes
  int8_t* hi = nullptr;     // [bh][bw][8] packed mode, zigzag 0..7 high bytes
  int lo_len = 64;          // zigzag positions carried on the packed wire
  int bw = 0, bh = 0;       // MCU-padded block dims
  int true_bw = 0, true_bh = 0;
};

struct Scan {
  int ncomp;
  int comp_idx[4];
  int dc_tbl[4], ac_tbl[4];
  int ss, se, ah, al;
  const uint8_t* data_start;
  const uint8_t* data_end;
  HuffTable dc[4], ac[4];
  int restart_interval;
};

struct Decoder {
  const uint8_t* base;
  size_t len;
  // optional caller-provided coefficient buffers (batch preallocation path);
  // must match the parsed MCU-padded geometry
  int16_t* ext_coef[4] = {nullptr, nullptr, nullptr, nullptr};
  // packed-wire mode: write zigzag lo/hi bytes directly at decode time (the
  // scan loop's k IS the zigzag index — this is cheaper than the natural-
  // order write, and the int16 batch array is never materialized)
  uint8_t* ext_lo[4] = {nullptr, nullptr, nullptr, nullptr};
  int8_t* ext_hi[4] = {nullptr, nullptr, nullptr, nullptr};
  int32_t ext_lo_len[4] = {64, 64, 64, 64};
  bool packed_mode = false;
  int packed_overflow = 0;  // a coefficient did not fit the packed wire
  const int32_t* ext_bw = nullptr;
  const int32_t* ext_bh = nullptr;
  int ext_ncomp = 0;
  int width = 0, height = 0, precision = 0, ncomp = 0;
  int sof_marker = 0;
  Component comps[4];
  HuffTable dc_tbl[4], ac_tbl[4];
  int restart_interval = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  bool progressive = false;
  int error = 0;

  // ROI decode: only MCU rows [roi_y0, roi_y1) are materialized. Rows below
  // roi_y1 end the scan early (the parser re-syncs at the next marker found
  // by byte scan); rows above roi_y0 are entropy-decoded for DC-predictor /
  // bit-position tracking only (no coefficient writes), and on
  // restart-interval streams whole pre-ROI segments are skipped by marker
  // scan with no entropy work at all (reference analog: nvjpeg ROI decode,
  // extensions/nvjpeg/cuda_decoder.cpp:460-520).
  long roi_y0 = 0;
  long roi_y1 = 0x7FFFFFFFL;

  bool parse_and_decode();
  void decode_scan(Scan& s);
  void sequential_scan(Scan& s);
  void progressive_scan(Scan& s);
};

static inline uint16_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

bool Decoder::parse_and_decode() {
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
      case 0xC0: case 0xC1: case 0xC2: {
        sof_marker = m;
        progressive = (m == 0xC2);
        if (progressive && packed_mode) {
          // progressive refinement needs int16 read-modify-write; the caller
          // must route these streams to the wide wire
          error = -3;
          return false;
        }
        precision = seg[0];
        height = be16(seg + 1);
        width = be16(seg + 3);
        ncomp = seg[5];
        if (ncomp > 4 || (precision != 8 && precision != 12)) return false;
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; c++) {
          comps[c].id = seg[6 + 3 * c];
          comps[c].h = seg[7 + 3 * c] >> 4;
          comps[c].v = seg[7 + 3 * c] & 15;
          comps[c].tq = seg[8 + 3 * c];
          if (comps[c].h < 1 || comps[c].v < 1) return false;
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
          if (packed_mode) {
            if (c >= ext_ncomp || cc.bw != ext_bw[c] || cc.bh != ext_bh[c])
              return false;  // geometry mismatch with preallocated batch slot
            cc.lo = ext_lo[c];
            cc.hi = ext_hi[c];
            cc.lo_len = ext_lo_len[c];
            if (cc.lo_len < 8 || cc.lo_len > 64) return false;
            memset(cc.lo, 0, (size_t)cc.bw * cc.bh * cc.lo_len);
            memset(cc.hi, 0, (size_t)cc.bw * cc.bh * 8);
          } else if (ext_coef[0]) {
            if (c >= ext_ncomp || cc.bw != ext_bw[c] || cc.bh != ext_bh[c])
              return false;  // geometry mismatch with preallocated batch slot
            cc.coef = ext_coef[c];
            memset(cc.coef, 0, (size_t)cc.bw * cc.bh * 64 * sizeof(int16_t));
          } else {
            cc.coef = (int16_t*)calloc((size_t)cc.bw * cc.bh * 64, sizeof(int16_t));
            if (!cc.coef) return false;
          }
        }
        have_sof = true;
        break;
      }
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return false;  // unsupported SOF type here (lossless/arith/diff)
      case 0xC4: {  // DHT
        const uint8_t* q = seg;
        while (q + 17 <= segend) {
          int tc = q[0] >> 4, th = q[0] & 15;
          if (th > 3) return false;
          uint8_t bits[16];
          int nv = 0;
          for (int i = 0; i < 16; i++) {
            bits[i] = q[1 + i];
            nv += bits[i];
          }
          if (q + 17 + nv > segend || nv > 256) return false;
          if (tc == 0) {
            if (!dc_tbl[th].build(bits, q + 17, nv)) return false;
          } else {
            if (!ac_tbl[th].build(bits, q + 17, nv)) return false;
          }
          q += 17 + nv;
        }
        break;
      }
      case 0xDD:  // DRI
        restart_interval = be16(seg);
        break;
      case 0xDA: {  // SOS
        if (!have_sof) return false;
        Scan s;
        s.ncomp = seg[0];
        // bounds: a corrupted SOS must fail cleanly, not index out of
        // range (ss/se drive kNat[] indexing; table ids index [4] arrays)
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
          s.dc[j] = dc_tbl[tt >> 4];
          s.ac[j] = ac_tbl[tt & 15];
        }
        // every table a scan will actually consult must have been defined
        // (an undefined HuffTable holds uninitialized LUT memory)
        for (int j = 0; j < s.ncomp; j++) {
          bool need_dc = (seg[1 + 2 * s.ncomp] == 0) &&
                         ((seg[3 + 2 * s.ncomp] >> 4) == 0);
          bool need_ac = seg[2 + 2 * s.ncomp] > 0;
          if (need_dc && !s.dc[j].valid) return false;
          if (need_ac && !s.ac[j].valid) return false;
        }
        s.ss = seg[1 + 2 * s.ncomp];
        s.se = seg[2 + 2 * s.ncomp];
        int ahal = seg[3 + 2 * s.ncomp];
        s.ah = ahal >> 4;
        s.al = ahal & 15;
        if (s.ss > 63 || s.se > 63 || s.ss > s.se) return false;
        if (progressive) {
          // T.81 G.1: DC scans are (0,0); AC scans exclude coefficient 0
          if (s.ss == 0 && s.se != 0) return false;
          if (s.ss > 0 && s.ncomp != 1) return false;
          if (s.al > 13 || s.ah > 13) return false;
        } else {
          if (s.ss != 0 || s.se != 63) return false;
        }
        s.restart_interval = restart_interval;
        s.data_start = segend;
        // find end: next marker that is not RST/stuffing
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
        break;
    }
    p += 2 + seglen;
  }
  return have_sof && error == 0;
}

void Decoder::decode_scan(Scan& s) {
  if (progressive)
    progressive_scan(s);
  else
    sequential_scan(s);
}

// Advance past an RST marker between restart segments.
static const uint8_t* skip_restart(const uint8_t* from, const uint8_t* end) {
  const uint8_t* q = from;
  while (q + 1 < end) {
    if (q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7) return q + 2;
    q++;
  }
  return end;
}

void Decoder::sequential_scan(Scan& s) {
  int smx, smy;
  bool interleaved = s.ncomp > 1;
  if (interleaved) {
    smx = mcus_x;
    smy = mcus_y;
  } else {
    Component& c = comps[s.comp_idx[0]];
    smx = c.true_bw;
    smy = c.true_bh;
  }
  long total = (long)smx * smy;
  long ri = s.restart_interval ? s.restart_interval : total;

  // ROI bounds in this scan's row unit (MCU rows when interleaved, component
  // block rows otherwise)
  long rv = interleaved ? 1 : comps[s.comp_idx[0]].v;
  long ry0 = roi_y0 * rv;
  long ry1 = (roi_y1 >= (long)mcus_y) ? (long)smy : roi_y1 * rv;

  BitReader br;
  br.init(s.data_start, s.data_end);
  int pred[4] = {0, 0, 0, 0};
  long mcu = 0;
  if (s.restart_interval && ry0 > 0) {
    // Skip whole restart segments strictly before the ROI: no entropy work,
    // just RST-marker scans; predictors reset at each restart anyway.
    long nskip = (ry0 * smx) / ri;
    if (nskip > 0) {
      const uint8_t* q = s.data_start;
      for (long i = 0; i < nskip && q < s.data_end; i++)
        q = skip_restart(q, s.data_end);
      br.init(q, s.data_end);
      mcu = nskip * ri;
    }
  }
  while (mcu < total) {
    long seg_end = mcu + ri < total ? mcu + ri : total;
    long my = mcu / smx, mx = mcu % smx;
    if (my >= ry1) return;  // everything below the ROI: skip the rest
    for (; mcu < seg_end; mcu++, (++mx == smx ? (mx = 0, ++my) : 0L)) {
      if (my >= ry1) return;
      const bool wr = my >= ry0;  // pre-ROI rows: track, don't materialize
      for (int j = 0; j < s.ncomp; j++) {
        Component& c = comps[s.comp_idx[j]];
        const HuffTable& dct = s.dc[j];
        const HuffTable& act = s.ac[j];
        int nby = interleaved ? c.v : 1;
        int nbx = interleaved ? c.h : 1;
        for (int by = 0; by < nby; by++) {
          for (int bx = 0; bx < nbx; bx++) {
            long row = interleaved ? my * c.v + by : my;
            long col = interleaved ? mx * c.h + bx : mx;
            long bidx = row * c.bw + col;
            int t = decode_huff(br, dct);
            // DC magnitude category is at most 15 (12-bit mode); a larger
            // table byte would drive get_bits into UB shifts
            if (t < 0 || t > 15) { error = 1; return; }
            pred[j] += extend(br.get_bits(t), t);
            if (packed_mode) {
              // zigzag wire: k is already the zigzag index
              const int lim = c.lo_len;
              uint8_t* plo = c.lo + bidx * lim;
              int8_t* phi = c.hi + bidx * 8;
              if (wr) {
                plo[0] = (uint8_t)(pred[j] & 0xFF);
                phi[0] = (int8_t)(pred[j] >> 8);
              }
              int k = 1;
              while (k < 64) {
                int sym = decode_huff(br, act);
                if (sym < 0) { error = 1; return; }
                int r = sym >> 4, sz = sym & 15;
                if (sz == 0) {
                  if (r == 15) { k += 16; continue; }
                  break;
                }
                k += r;
                if (k > 63) { error = 1; return; }
                int v = extend(br.get_bits(sz), sz);
                if (!wr) { k++; continue; }
                if (k < lim) {
                  plo[k] = (uint8_t)(v & 0xFF);
                  if (k < 8)
                    phi[k] = (int8_t)(v >> 8);
                  else
                    packed_overflow |= (v + 128) & ~255;
                } else {
                  packed_overflow |= 1;  // beyond the truncated wire
                }
                k++;
              }
            } else {
              int16_t* block = c.coef + bidx * 64;
              if (wr) block[0] = (int16_t)pred[j];
              int k = 1;
              while (k < 64) {
                int sym = decode_huff(br, act);
                if (sym < 0) { error = 1; return; }
                int r = sym >> 4, sz = sym & 15;
                if (sz == 0) {
                  if (r == 15) { k += 16; continue; }
                  break;
                }
                k += r;
                if (k > 63) { error = 1; return; }
                int v = extend(br.get_bits(sz), sz);
                if (wr) block[kNat[k]] = (int16_t)v;
                k++;
              }
            }
          }
        }
      }
    }
    if (mcu < total) {
      // restart: realign to next RST marker
      const uint8_t* next = br.marker ? br.marker : br.p;
      br.init(skip_restart(next, s.data_end), s.data_end);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
  }
}

void Decoder::progressive_scan(Scan& s) {
  bool is_dc = (s.ss == 0);
  int smx, smy;
  bool interleaved = s.ncomp > 1;
  if (interleaved) {
    smx = mcus_x;
    smy = mcus_y;
  } else {
    Component& c = comps[s.comp_idx[0]];
    smx = c.true_bw;
    smy = c.true_bh;
  }
  long total = (long)smx * smy;
  long ri = s.restart_interval ? s.restart_interval : total;

  // ROI: early-exit below the ROI in EVERY scan (the parser re-syncs at the
  // next marker); rows above it must still be fully decoded *and written*
  // because AC-refinement passes read the coefficient state — except on
  // restart-interval streams, where whole pre-ROI segments can be skipped
  // consistently in every scan (they are then never read).
  long rv = interleaved ? 1 : comps[s.comp_idx[0]].v;
  long ry0 = roi_y0 * rv;
  long ry1 = (roi_y1 >= (long)mcus_y) ? (long)smy : roi_y1 * rv;

  BitReader br;
  br.init(s.data_start, s.data_end);
  int pred[4] = {0, 0, 0, 0};
  long eobrun = 0;
  int p1 = 1 << s.al;
  int m1 = -1 << s.al;

  long mcu = 0;
  if (s.restart_interval && ry0 > 0) {
    long nskip = (ry0 * smx) / ri;
    if (nskip > 0) {
      const uint8_t* q = s.data_start;
      for (long i = 0; i < nskip && q < s.data_end; i++)
        q = skip_restart(q, s.data_end);
      br.init(q, s.data_end);
      mcu = nskip * ri;
    }
  }
  while (mcu < total) {
    long seg_end = mcu + ri < total ? mcu + ri : total;
    long my = mcu / smx, mx = mcu % smx;
    if (my >= ry1) return;
    for (; mcu < seg_end; mcu++, (++mx == smx ? (mx = 0, ++my) : 0L)) {
      if (my >= ry1) return;
      for (int j = 0; j < s.ncomp; j++) {
        Component& c = comps[s.comp_idx[j]];
        int nby = interleaved ? c.v : 1;
        int nbx = interleaved ? c.h : 1;
        for (int by = 0; by < nby; by++) {
          for (int bx = 0; bx < nbx; bx++) {
            long row = interleaved ? my * c.v + by : my;
            long col = interleaved ? mx * c.h + bx : mx;
            int16_t* block = c.coef + (row * c.bw + col) * 64;
            if (is_dc) {
              if (s.ah == 0) {
                int t = decode_huff(br, s.dc[j]);
                if (t < 0 || t > 15) { error = 1; return; }
                pred[j] += extend(br.get_bits(t), t);
                block[0] = (int16_t)(pred[j] << s.al);
              } else {
                if (br.get_bit()) block[0] = (int16_t)(block[0] | p1);
              }
            } else {
              const HuffTable& act = s.ac[j];
              if (s.ah == 0) {
                // AC first
                if (eobrun > 0) {
                  eobrun--;
                } else {
                  int k = s.ss;
                  while (k <= s.se) {
                    int sym = decode_huff(br, act);
                    if (sym < 0) { error = 1; return; }
                    int r = sym >> 4, sz = sym & 15;
                    if (sz == 0) {
                      if (r == 15) { k += 16; continue; }
                      eobrun = (1L << r) - 1;
                      if (r) eobrun += br.get_bits(r);
                      break;
                    }
                    k += r;
                    if (k > s.se) { error = 1; return; }
                    block[kNat[k]] = (int16_t)(extend(br.get_bits(sz), sz) << s.al);
                    k++;
                  }
                }
              } else {
                // AC refine
                int k = s.ss;
                if (eobrun == 0) {
                  while (k <= s.se) {
                    int sym = decode_huff(br, act);
                    if (sym < 0) { error = 1; return; }
                    int r = sym >> 4, sz = sym & 15;
                    int sval = 0;
                    if (sz == 0) {
                      if (r != 15) {
                        eobrun = 1L << r;
                        if (r) eobrun += br.get_bits(r);
                        break;
                      }
                    } else {
                      sval = br.get_bit() ? p1 : m1;
                    }
                    while (k <= s.se) {
                      int16_t* coefp = block + kNat[k];
                      if (*coefp != 0) {
                        if (br.get_bit() && (*coefp & p1) == 0)
                          *coefp += (int16_t)(*coefp >= 0 ? p1 : m1);
                      } else {
                        if (r == 0) break;
                        r--;
                      }
                      k++;
                    }
                    if (sz) {
                      if (k > s.se) { error = 1; return; }
                      block[kNat[k]] = (int16_t)sval;
                    }
                    k++;
                  }
                }
                if (eobrun > 0) {
                  while (k <= s.se) {
                    int16_t* coefp = block + kNat[k];
                    if (*coefp != 0) {
                      if (br.get_bit() && (*coefp & p1) == 0)
                        *coefp += (int16_t)(*coefp >= 0 ? p1 : m1);
                    }
                    k++;
                  }
                  eobrun--;
                }
              }
            }
          }
        }
      }
    }
    if (mcu < total) {
      const uint8_t* next = br.marker ? br.marker : br.p;
      br.init(skip_restart(next, s.data_end), s.data_end);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
  }
}

}  // namespace

extern "C" {

// Decode all scans; returns 0 on success. Caller frees coefs[i] with
// tic_free. blocks are MCU-grid padded, natural order within each 64.
int tic_jpeg_decode_coefficients(const uint8_t* data, size_t len,
                                 int16_t** coefs, int32_t* blocks_w,
                                 int32_t* blocks_h, int32_t* out_ncomp) {
  Decoder d;
  d.base = data;
  d.len = len;
  if (!d.parse_and_decode()) {
    for (int c = 0; c < 4; c++)
      if (d.comps[c].coef) free(d.comps[c].coef);
    return -1;
  }
  *out_ncomp = d.ncomp;
  for (int c = 0; c < d.ncomp; c++) {
    coefs[c] = d.comps[c].coef;
    blocks_w[c] = d.comps[c].bw;
    blocks_h[c] = d.comps[c].bh;
  }
  return 0;
}

// Batch-preallocation variant: decode directly into caller buffers whose
// geometry (MCU-padded blocks_w/h per component) was computed from a prior
// header parse. Zero-copy into the stacked [B, bh, bw, 64] batch array.
int tic_jpeg_decode_coefficients_into(const uint8_t* data, size_t len,
                                      int16_t** bufs, const int32_t* exp_bw,
                                      const int32_t* exp_bh,
                                      int32_t exp_ncomp) {
  Decoder d;
  d.base = data;
  d.len = len;
  for (int c = 0; c < exp_ncomp && c < 4; c++) d.ext_coef[c] = bufs[c];
  d.ext_bw = exp_bw;
  d.ext_bh = exp_bh;
  d.ext_ncomp = exp_ncomp;
  if (!d.parse_and_decode()) return -1;  // ext buffers are caller-owned
  if (d.ncomp != exp_ncomp) return -2;
  return 0;
}

// ROI decode: like tic_jpeg_decode_coefficients_into but only MCU rows
// [mcu_y0, mcu_y1) are materialized; entropy work below the ROI is skipped
// entirely and pre-ROI restart segments are skipped by marker scan
// (reference analog: nvjpeg ROI, extensions/nvjpeg/cuda_decoder.cpp:460-520).
int tic_jpeg_decode_coefficients_roi_into(const uint8_t* data, size_t len,
                                          int16_t** bufs,
                                          const int32_t* exp_bw,
                                          const int32_t* exp_bh,
                                          int32_t exp_ncomp, int32_t mcu_y0,
                                          int32_t mcu_y1) {
  Decoder d;
  d.base = data;
  d.len = len;
  for (int c = 0; c < exp_ncomp && c < 4; c++) d.ext_coef[c] = bufs[c];
  d.ext_bw = exp_bw;
  d.ext_bh = exp_bh;
  d.ext_ncomp = exp_ncomp;
  d.roi_y0 = mcu_y0 > 0 ? mcu_y0 : 0;
  d.roi_y1 = mcu_y1 >= 0 ? mcu_y1 : 0x7FFFFFFFL;
  if (!d.parse_and_decode()) return -1;
  if (d.ncomp != exp_ncomp) return -2;
  return 0;
}

void tic_free(void* p) { free(p); }

// Split one image's entropy-coded scan into restart segments, destuff
// (0xFF00 -> 0xFF) and pack each segment into big-endian uint32 words laid
// out COLUMN-major for the device entropy kernel: words[w * stride + col0 +
// seg] = word w of segment seg. Feeds the restart-interval-parallel Pallas
// Huffman decoder (SURVEY.md §7: "host-side scan for restart markers, then
// data-parallel per-segment decode").
// Returns the number of segments written, or -1 if a segment exceeds
// max_words capacity / -2 if there are more segments than max_segs.
int tic_jpeg_split_segments(const uint8_t* scan, int64_t scan_len,
                            uint32_t* words, int64_t stride, int64_t col0,
                            int32_t max_segs, int32_t max_words) {
  int seg = 0;
  const uint8_t* p = scan;
  const uint8_t* end = scan + scan_len;
  while (p < end) {
    if (seg >= max_segs) return -2;
    uint32_t acc = 0;
    int nb = 0;
    int64_t w = 0;
    uint32_t* col = words + col0 + seg;
    while (p < end) {
      uint8_t b = *p;
      if (b == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          p += 2;  // stuffed data byte
        } else {
          break;  // marker terminates the segment
        }
      } else {
        p++;
      }
      acc = (acc << 8) | b;
      if (++nb == 4) {
        if (w >= max_words) return -1;
        col[w * stride] = acc;
        w++;
        acc = 0;
        nb = 0;
      }
    }
    if (nb) {  // flush the partial word, left-aligned, zero-padded
      acc <<= 8 * (4 - nb);
      if (w >= max_words) return -1;
      col[w * stride] = acc;
      w++;
    }
    // zero-fill the remainder so the bit reader sees padding zeros
    for (; w < max_words; w++) col[w * stride] = 0;
    seg++;
    // skip the restart marker (or EOI and trailing bytes)
    if (p < end && p[0] == 0xFF) {
      if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        continue;
      }
      break;  // EOI or other marker: done
    }
  }
  return seg;
}

// Packed-wire batch variant: entropy-decode directly into the caller's
// zigzag lo/hi wire buffers (72 B/block vs 128 — see
// tic_jpeg_pack_coefficients) with no int16 intermediate. Returns 0 on
// success, 1 if a tail coefficient overflowed int8 (caller must re-decode
// with the wide wire), -3 for progressive streams (wide wire required),
// -1 on parse error.
int tic_jpeg_decode_coefficients_packed(const uint8_t* data, size_t len,
                                        uint8_t** lo_bufs, int8_t** hi_bufs,
                                        const int32_t* lo_lens,
                                        const int32_t* exp_bw,
                                        const int32_t* exp_bh,
                                        int32_t exp_ncomp) {
  Decoder d;
  d.base = data;
  d.len = len;
  d.packed_mode = true;
  for (int c = 0; c < exp_ncomp && c < 4; c++) {
    d.ext_lo[c] = lo_bufs[c];
    d.ext_hi[c] = hi_bufs[c];
    d.ext_lo_len[c] = lo_lens[c];
  }
  d.ext_bw = exp_bw;
  d.ext_bh = exp_bh;
  d.ext_ncomp = exp_ncomp;
  if (!d.parse_and_decode()) return d.error == -3 ? -3 : -1;
  if (d.ncomp != exp_ncomp) return -2;
  return d.packed_overflow ? 1 : 0;
}

// Pack natural-order int16 coefficient blocks into the compact device wire
// format: per block, lo_len low bytes in ZIGZAG order plus the high bytes
// of the first 8 zigzag coefficients (where large values live). 72
// bytes/block (lo_len=64) vs 128 — the H2D transfer is the hybrid decode's
// bottleneck, so the host trades one linear pass for ~44% fewer wire bytes
// (the reference's analog is keeping the host→device handoff inside
// nvjpeg's pinned buffers, extensions/nvjpeg/cuda_decoder.cpp:539-556).
// This is the progressive-stream route onto the packed wire: refinement
// scans need int16 read-modify-write, so they decode wide first and pack
// after. Returns 1 if any coefficient beyond zigzag position 7 falls
// outside int8, or a coefficient beyond the truncated lo_len is nonzero
// (caller must fall back to a wider wire), else 0.
int tic_jpeg_pack_coefficients(const int16_t* coef, int64_t nblocks,
                               uint8_t* lo, int32_t lo_len, int8_t* hi) {
  int overflow = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    const int16_t* blk = coef + b * 64;
    uint8_t* plo = lo + b * lo_len;
    int8_t* phi = hi + b * 8;
    for (int k = 0; k < 8; k++) {
      int v = blk[kNat[k]];
      plo[k] = (uint8_t)(v & 0xFF);
      phi[k] = (int8_t)(v >> 8);
    }
    for (int k = 8; k < lo_len; k++) {
      int v = blk[kNat[k]];
      plo[k] = (uint8_t)(v & 0xFF);
      overflow |= (v + 128) & ~255;  // nonzero iff v < -128 or v > 127
    }
    for (int k = lo_len; k < 64; k++)
      overflow |= blk[kNat[k]];  // truncated positions must be zero
  }
  return overflow ? 1 : 0;
}

}  // extern "C"
