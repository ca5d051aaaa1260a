// Native JPEG baseline Huffman entropy encoder — the host half of the
// hybrid device encode pipeline (the role nvjpeg's entropy stage plays in the
// reference, extensions/nvjpeg/cuda_encoder.cpp:284-436). Implemented from
// ITU-T T.81 F.1.2 directly; no reference code used.
//
// Exposed C ABI (ctypes):
//   tic_jpeg_count_symbols : symbol frequencies for optimized-Huffman tables
//   tic_jpeg_encode_scan   : interleaved sequential scan -> entropy bytes
//
// Table blob layout (8 slots: 0-3 DC, 4-7 AC), 272 bytes per slot:
//   [0..15]   bits: count of codes of length 1..16
//   [16..271] symbol values (first sum(bits) used)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct EncTable {
  uint32_t code[256];
  int8_t size[256];
};

// T.81 C.2 canonical code assignment from (bits, values).
void derive(const uint8_t* blob, EncTable& t) {
  std::memset(t.size, 0, sizeof(t.size));
  uint32_t code = 0;
  int k = 16;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < blob[len - 1]; ++i) {
      uint8_t v = blob[k++];
      t.code[v] = code;
      t.size[v] = (int8_t)len;
      ++code;
    }
    code <<= 1;
  }
}

struct BitWriter {
  // raw preallocated buffer (worst case computed by caller) — the hot loop
  // must not pay vector growth/bounds checks per byte
  uint8_t* buf = nullptr;
  size_t len = 0;
  uint64_t acc = 0;
  int nbits = 0;

  inline void emit(uint8_t b) {
    buf[len++] = b;
    if (b == 0xFF) buf[len++] = 0x00;  // byte stuffing
  }
  inline void put(uint32_t code, int size) {
    // size <= 31; callers pass values already masked to `size` bits
    acc = (acc << size) | code;
    nbits += size;
    if (nbits >= 32) {
      nbits -= 32;
      uint32_t w32 = (uint32_t)(acc >> nbits);
      emit((uint8_t)(w32 >> 24));
      emit((uint8_t)(w32 >> 16));
      emit((uint8_t)(w32 >> 8));
      emit((uint8_t)w32);
    }
  }
  inline void flush() {
    while (nbits >= 8) {
      nbits -= 8;
      emit((uint8_t)((acc >> nbits) & 0xFF));
    }
    if (nbits) {  // pad with 1-bits to a byte boundary
      emit((uint8_t)(((acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1)) &
                     0xFF));
      nbits = 0;
    }
  }
};

inline int csize(int v) {
  unsigned a = (unsigned)(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

struct Geom {
  int ncomp, mcus_x, mcus_y, restart;
  const int32_t *h, *v, *bw, *bh, *dct, *act;
  const int16_t* const* coefs;
};

// Iterate MCU-interleaved blocks; Fn(comp, block_ptr_zigzag_source).
template <typename Fn>
void for_each_block(const Geom& g, Fn&& fn) {
  for (int my = 0; my < g.mcus_y; ++my)
    for (int mx = 0; mx < g.mcus_x; ++mx)
      for (int c = 0; c < g.ncomp; ++c)
        for (int by = 0; by < g.v[c]; ++by)
          for (int bx = 0; bx < g.h[c]; ++bx) {
            int row = my * g.v[c] + by;
            int col = mx * g.h[c] + bx;
            const int16_t* blk = g.coefs[c] + ((size_t)row * g.bw[c] + col) * 64;
            fn(c, blk);
          }
}

}  // namespace

extern "C" {

void tic_free(void* p);  // defined in jpeg_entropy.cpp

// Count DC/AC symbol frequencies per table id (for optimized Huffman).
// dc_counts/ac_counts: int64[4*256], zeroed by caller.
int tic_jpeg_count_symbols(int ncomp, const int32_t* comp_h,
                           const int32_t* comp_v, const int32_t* comp_bw,
                           const int32_t* comp_bh, const int32_t* comp_dc_tbl,
                           const int32_t* comp_ac_tbl, int mcus_x, int mcus_y,
                           const int16_t* const* coefs, int64_t* dc_counts,
                           int64_t* ac_counts) {
  if (ncomp < 1 || ncomp > 4) return 1;
  Geom g{ncomp, mcus_x, mcus_y, 0,       comp_h,      comp_v,
         comp_bw, comp_bh, comp_dc_tbl, comp_ac_tbl, coefs};
  int pred[4] = {0, 0, 0, 0};
  for_each_block(g, [&](int c, const int16_t* blk) {
    int64_t* dcc = dc_counts + (size_t)g.dct[c] * 256;
    int64_t* acc = ac_counts + (size_t)g.act[c] * 256;
    int dc = blk[0];
    int diff = dc - pred[c];
    pred[c] = dc;
    ++dcc[csize(diff)];
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        ++acc[0xF0];
        run -= 16;
      }
      ++acc[(run << 4) | csize(v)];
      run = 0;
    }
    if (run) ++acc[0x00];
  });
  return 0;
}

// Encode one interleaved sequential scan. tables: 8*272-byte blob (see top).
// *out is malloc'd; caller frees with tic_free.
int tic_jpeg_encode_scan(int ncomp, const int32_t* comp_h,
                         const int32_t* comp_v, const int32_t* comp_bw,
                         const int32_t* comp_bh, const int32_t* comp_dc_tbl,
                         const int32_t* comp_ac_tbl, int mcus_x, int mcus_y,
                         int restart_interval, const int16_t* const* coefs,
                         const uint8_t* tables, uint8_t** out,
                         size_t* out_len) {
  if (ncomp < 1 || ncomp > 4) return 1;
  EncTable dc_t[4], ac_t[4];
  for (int i = 0; i < 4; ++i) {
    derive(tables + (size_t)i * 272, dc_t[i]);
    derive(tables + (size_t)(4 + i) * 272, ac_t[i]);
  }
  Geom g{ncomp,   mcus_x,  mcus_y,      restart_interval, comp_h, comp_v,
         comp_bw, comp_bh, comp_dc_tbl, comp_ac_tbl,      coefs};

  // worst case: every coefficient emits <=31 bits, everything stuffed (x2),
  // plus restarts and the final flush
  size_t total_blocks = 0;
  for (int c = 0; c < ncomp; ++c)
    total_blocks += (size_t)comp_bw[c] * comp_bh[c];
  size_t cap = total_blocks * 64 * 8 + (size_t)mcus_x * mcus_y * 2 + 64;
  BitWriter w;
  w.buf = (uint8_t*)std::malloc(cap);
  if (!w.buf) return 2;
  int pred[4] = {0, 0, 0, 0};
  int blocks_per_mcu = 0;
  for (int c = 0; c < ncomp; ++c) blocks_per_mcu += comp_h[c] * comp_v[c];
  long block_i = 0;
  int rst = 0;
  for_each_block(g, [&](int c, const int16_t* blk) {
    if (restart_interval) {
      long mcu = block_i / blocks_per_mcu;
      if (mcu && block_i % blocks_per_mcu == 0 &&
          mcu % restart_interval == 0) {
        w.flush();
        w.buf[w.len++] = 0xFF;
        w.buf[w.len++] = (uint8_t)(0xD0 + (rst & 7));
        ++rst;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
    }
    ++block_i;
    const EncTable& dt = dc_t[g.dct[c]];
    const EncTable& at = ac_t[g.act[c]];
    int dc = blk[0];
    int diff = dc - pred[c];
    pred[c] = dc;
    int s = csize(diff);
    // fused symbol+magnitude put (one acc update per coefficient)
    uint32_t mag = (uint32_t)(diff >= 0 ? diff : diff + (1 << s) - 1) &
                   ((1u << s) - 1);
    w.put((dt.code[s] << s) | mag, dt.size[s] + s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        w.put(at.code[0xF0], at.size[0xF0]);
        run -= 16;
      }
      s = csize(v);
      mag = (uint32_t)(v >= 0 ? v : v + (1 << s) - 1) & ((1u << s) - 1);
      int sym = (run << 4) | s;
      w.put((at.code[sym] << s) | mag, at.size[sym] + s);
      run = 0;
    }
    if (run) w.put(at.code[0x00], at.size[0x00]);
  });
  w.flush();

  *out_len = w.len;
  *out = w.buf;  // caller frees with tic_free
  return 0;
}

}  // extern "C"
