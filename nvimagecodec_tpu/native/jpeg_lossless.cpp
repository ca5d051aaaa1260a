// Lossless JPEG (SOF3) decoder — ITU-T T.81 Annex H.
//
// Counterpart of the reference's nvjpeg lossless decoder
// (extensions/nvjpeg/lossless_decoder.cpp, NVJPEG_BACKEND_LOSSLESS_JPEG):
// Huffman-coded prediction residuals with the seven spatial predictors and
// point transform. Prediction is sample-serial, so this stays a host stage;
// output feeds the framework as a ready pixel plane. From the spec; no
// reference code used.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct HuffTable {
  int16_t lut_sym[512];
  int8_t lut_len[512];
  int32_t maxcode[18], valptr[18], mincode[18];
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
      // canonical codes of length l must fit in l bits (malformed DHT guard)
      if (code > (1 << l)) return false;
      maxcode[l] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < 512; i++) {
      lut_sym[i] = -1;
      lut_len[i] = 0;
    }
    for (int i = 0; i < k; i++)
      if (lens[i] <= 9) {
        int base = codes[i] << (9 - lens[i]);
        for (int j = 0; j < (1 << (9 - lens[i])); j++) {
          lut_sym[base + j] = values[i];
          lut_len[base + j] = (int8_t)lens[i];
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
  const uint8_t* marker = nullptr;

  void init(const uint8_t* s, const uint8_t* e) {
    p = s;
    end = e;
    acc = 0;
    nbits = 0;
    marker = nullptr;
  }
  inline void refill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (p < end && !marker) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00)
            p += 2;
          else {
            marker = p;
            b = 0;
          }
        } else
          p++;
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
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  int idx = br.peek9();
  int len = t.lut_len[idx];
  if (len) {
    br.skip(len);
    return t.lut_sym[idx];
  }
  if (br.nbits < 16) br.refill();
  int code = (int)((br.acc >> (br.nbits - 16)) & 0xFFFF);
  for (int l = 10; l <= 16; l++) {
    int c = code >> (16 - l);
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.values[t.valptr[l] + (c - t.mincode[l])];
    }
  }
  return -1;
}

inline int extend(int v, int t) {
  if (t == 0) return 0;
  return (v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

inline uint16_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

}  // namespace

extern "C" {

// Decode an SOF3 stream into interleaved uint16 samples [h, w, ncomp].
// Returns 0 ok; fills out dims/ncomp/precision. Buffer out must hold
// w*h*ncomp uint16 (caller gets dims from a prior parse).
int tic_jpeg_lossless_decode(const uint8_t* data, size_t len, uint16_t* out,
                             int32_t out_capacity_samples, int32_t* ow,
                             int32_t* oh, int32_t* oncomp,
                             int32_t* oprecision) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return 1;
  p += 2;

  int width = 0, height = 0, precision = 0, ncomp = 0;
  struct Comp {
    int id, tbl;
  } comps[4];
  HuffTable tables[4];
  int restart_interval = 0;
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
    if (m == 0xD9) break;
    if (p + 4 > end) break;
    int seglen = be16(p + 2);
    const uint8_t* seg = p + 4;
    const uint8_t* segend = p + 2 + seglen;
    if (segend > end) return 2;

    if (m == 0xC3) {
      precision = seg[0];
      height = be16(seg + 1);
      width = be16(seg + 3);
      ncomp = seg[5];
      if (ncomp < 1 || ncomp > 4 || precision < 2 || precision > 16) return 3;
      for (int c = 0; c < ncomp; c++) {
        comps[c].id = seg[6 + 3 * c];
        int hv = seg[7 + 3 * c];
        if (hv != 0x11) return 4;  // subsampled lossless unsupported
      }
      have_sof = true;
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      return 5;  // some other SOF type — not lossless
    } else if (m == 0xC4) {
      const uint8_t* q = seg;
      while (q + 17 <= segend) {
        int tc = q[0] >> 4, th = q[0] & 15;
        int nv = 0;
        for (int i = 1; i <= 16; i++) nv += q[i];
        if (nv > 256 || q + 17 + nv > segend) return 13;
        if (tc == 0 && th < 4 && !tables[th].build(q + 1, q + 17, nv))
          return 13;
        q += 17 + nv;
      }
    } else if (m == 0xDD) {
      restart_interval = be16(seg);
    } else if (m == 0xDA) {
      if (!have_sof) return 6;
      int ns = seg[0];
      int scomp[4], stbl[4];
      if (ns < 1 || ns > 4 || seg + 4 + 2 * ns > segend) return 7;
      for (int j = 0; j < ns; j++) {
        int cs = seg[1 + 2 * j];
        int td = seg[2 + 2 * j] >> 4;
        if (td > 3) return 7;  // tables[] has 4 slots
        int idx = -1;
        for (int c = 0; c < ncomp; c++)
          if (comps[c].id == cs) idx = c;
        if (idx < 0) return 7;
        scomp[j] = idx;
        stbl[j] = td;
      }
      int predictor = seg[1 + 2 * ns];  // Ss = predictor selector
      int pt = seg[3 + 2 * ns] & 15;    // Al = point transform
      if (predictor < 1 || predictor > 7) return 8;
      if ((int64_t)width * height * ns > out_capacity_samples) return 9;

      const uint8_t* sod = p + 2 + seglen;
      BitReader br;
      br.init(sod, end);

      int defaultv = 1 << (precision - pt - 1);
      int64_t total = (int64_t)width * height;
      int64_t ri = restart_interval ? restart_interval : total;
      int64_t s = 0;
      while (s < total) {
        int64_t seg_start = s;
        int64_t seg_end = s + ri < total ? s + ri : total;
        for (; s < seg_end; s++) {
          int64_t y = s / width, x = s % width;
          bool restarted = restart_interval && s == seg_start;
          for (int j = 0; j < ns; j++) {
            const HuffTable& t = tables[stbl[j]];
            if (!t.valid) return 10;
            int ssss = decode_huff(br, t);
            // ssss beyond 16 is not a legal magnitude category (ssss==16
            // means +32768 with no extra bits); guard get_bits shifts
            if (ssss < 0 || ssss > 16) return 11;
            int diff;
            if (ssss == 16)
              diff = 32768;
            else
              diff = extend(br.get_bits(ssss), ssss);
            uint16_t* row = out + (y * width + x) * ns + j;
            int a = x > 0 ? row[-ns] : 0;
            int b = y > 0 ? *(row - (int64_t)width * ns) : 0;
            int c = (x > 0 && y > 0) ? *(row - (int64_t)width * ns - ns) : 0;
            int pred;
            if ((x == 0 && y == 0) || restarted)
              pred = defaultv;  // scan/restart start (T.81 H.2.2/H.2.4)
            else if (y == 0)
              pred = a;
            else if (x == 0)
              pred = b;
            else {
              switch (predictor) {
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = c; break;
                case 4: pred = a + b - c; break;
                case 5: pred = a + ((b - c) >> 1); break;
                case 6: pred = b + ((a - c) >> 1); break;
                default: pred = (a + b) >> 1; break;
              }
            }
            int v = (pred + diff) & 0xFFFF;
            *row = (uint16_t)v;
          }
        }
        if (s < total) {
          const uint8_t* next = br.marker ? br.marker : br.p;
          while (next + 1 < end &&
                 !(next[0] == 0xFF && next[1] >= 0xD0 && next[1] <= 0xD7))
            next++;
          if (next + 1 < end) next += 2;
          br.init(next, end);
          // restart resets prediction to defaults (treated as image start
          // for the next sample row segment)
        }
      }
      // point transform: scale back up
      if (pt) {
        int64_t n = total * ns;
        for (int64_t i = 0; i < n; i++) out[i] = (uint16_t)(out[i] << pt);
      }
      *ow = width;
      *oh = height;
      *oncomp = ns;
      *oprecision = precision;
      return 0;
    }
    p = segend;
  }
  return 12;
}

}  // extern "C"
