// VP8 (lossy WebP) keyframe decoder — RFC 6386 from scratch.
// Counterpart of the lossy-WebP coverage the reference gets
// from its OpenCV extension (reference:
// extensions/opencv/opencv_decoder.cpp:31-150, opencv_webp_decoder).
//
// WebP stills are VP8 keyframes: intra-only (no motion), one frame.
// Pipeline: bool-decode headers → per-MB intra modes → token partitions
// (DCT coefficient trees) → dequant → inverse WHT/DCT → intra prediction +
// residual add → in-loop deblocking filter → YUV420 planes out.
// Normative probability/quantizer tables in webp_vp8_tables.inc
// (RFC 6386 §11.5/§13.4/§13.5/§14.1). Output is validated bit-exactly
// against libwebp's YUV output in tests/test_webp.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

#include "webp_vp8_tables.inc"

// ------------------------------------------------------------ bool decoder
struct BoolDec {
    const uint8_t* buf;
    size_t size, pos;
    uint32_t range, value;
    int bit_count;  // bits consumed of the current window
    bool eof = false;

    void init(const uint8_t* b, size_t n) {
        buf = b;
        size = n;
        pos = 0;
        range = 255;
        value = 0;
        bit_count = -8;  // triggers initial loads
        value = next() << 8;
        value |= next();
        bit_count = 0;
    }
    uint32_t next() {
        if (pos < size) return buf[pos++];
        eof = true;
        return 0;
    }
    int get(int prob) {
        uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
        uint32_t bigsplit = split << 8;
        int ret;
        if (value >= bigsplit) {
            ret = 1;
            range -= split;
            value -= bigsplit;
        } else {
            ret = 0;
            range = split;
        }
        while (range < 128) {
            value <<= 1;
            range <<= 1;
            if (++bit_count == 8) {
                bit_count = 0;
                value |= next();
            }
        }
        return ret;
    }
    int bit() { return get(128); }
    int literal(int n) {
        int v = 0;
        while (n-- > 0) v = (v << 1) | bit();
        return v;
    }
    int signed_literal(int n) {
        int v = literal(n);
        return bit() ? -v : v;
    }
};

// --------------------------------------------------------------- trees
// token tree (RFC 13.2). Leaves are ~(token).
const int8_t kCoeffTree[22] = {
    ~0 /*EOB*/, 2,  ~1 /*0*/, 4,  ~2 /*1*/, 6,  8,  12, ~3 /*2*/, 10, ~4,
    ~5,         14, 16,       ~6 /*cat1*/,  ~7, 18, 20, ~8,       ~9, ~10,
    ~11};
// token indices: 0 EOB, 1 zero, 2 one, 3 two, 4 three, 5 four,
// 6 cat1, 7 cat2, 8 cat3, 9 cat4, 10 cat5, 11 cat6
const uint8_t kCatProbs1[] = {159};
const uint8_t kCatProbs2[] = {165, 145};
const uint8_t kCatProbs3[] = {173, 148, 140};
const uint8_t kCatProbs4[] = {176, 155, 140, 135};
const uint8_t kCatProbs5[] = {180, 157, 141, 134, 130};
const uint8_t kCatProbs6[] = {254, 254, 243, 230, 196, 177,
                              153, 140, 133, 130, 129};
const uint8_t* kCatProbs[6] = {kCatProbs1, kCatProbs2, kCatProbs3,
                               kCatProbs4, kCatProbs5, kCatProbs6};
const int kCatBits[6] = {1, 2, 3, 4, 5, 11};
const int kCatBase[6] = {5, 7, 11, 19, 35, 67};

const uint8_t kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const uint8_t kZigzag[16] = {0, 1,  4,  8, 5, 2,  3,  6,
                             9, 12, 13, 10, 7, 11, 14, 15};

// intra mode trees (RFC 11.2/11.3)
// luma 16x16 (keyframe): 0 DC, 1 V, 2 H, 3 TM, 4 B_PRED
const int8_t kKfYModeTree[8] = {~4, 2, 4, 6, ~0, ~1, ~2, ~3};
const uint8_t kKfYModeProbs[4] = {145, 156, 163, 128};
const int8_t kUVModeTree[6] = {~0, 2, ~1, 4, ~2, ~3};
const uint8_t kKfUVModeProbs[3] = {142, 114, 183};
// 4x4 b modes: 0 B_DC 1 B_TM 2 B_VE 3 B_HE 4 B_LD 5 B_RD 6 B_VR 7 B_VL
// 8 B_HD 9 B_HU
const int8_t kBModeTree[18] = {~0, 2,  ~1, 4,  ~2, 6,  8,  12, ~3,
                               10, ~5, ~6, ~4, 14, ~7, 16, ~8, ~9};

int tree_read(BoolDec& bd, const int8_t* tree, const uint8_t* probs) {
    int i = 0;
    do {
        i = tree[i + bd.get(probs[i >> 1])];
    } while (i > 0);
    return ~i;
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clampq(int v) { return v < 0 ? 0 : v > 127 ? 127 : v; }

// ----------------------------------------------------------- transforms
void idct4x4(const int16_t* in, int16_t* out) {  // RFC 14.4
    const int c1 = 20091, c2 = 35468;  // (cos/sin pi/8 * sqrt2) Q16
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a1 = in[i] + in[8 + i];
        int b1 = in[i] - in[8 + i];
        int t1 = (in[4 + i] * c2) >> 16;
        int t2 = in[12 + i] + ((in[12 + i] * c1) >> 16);
        int cc = t1 - t2;
        t1 = in[4 + i] + ((in[4 + i] * c1) >> 16);
        t2 = (in[12 + i] * c2) >> 16;
        int dd = t1 + t2;
        tmp[i] = a1 + dd;
        tmp[12 + i] = a1 - dd;
        tmp[4 + i] = b1 + cc;
        tmp[8 + i] = b1 - cc;
    }
    for (int i = 0; i < 4; ++i) {
        const int* ip = tmp + 4 * i;
        int a1 = ip[0] + ip[2];
        int b1 = ip[0] - ip[2];
        int t1 = (ip[1] * c2) >> 16;
        int t2 = ip[3] + ((ip[3] * c1) >> 16);
        int cc = t1 - t2;
        t1 = ip[1] + ((ip[1] * c1) >> 16);
        t2 = (ip[3] * c2) >> 16;
        int dd = t1 + t2;
        out[4 * i + 0] = int16_t((a1 + dd + 4) >> 3);
        out[4 * i + 3] = int16_t((a1 - dd + 4) >> 3);
        out[4 * i + 1] = int16_t((b1 + cc + 4) >> 3);
        out[4 * i + 2] = int16_t((b1 - cc + 4) >> 3);
    }
}

void iwht4x4(const int16_t* in, int16_t* out) {  // RFC 14.3
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a1 = in[i] + in[12 + i];
        int b1 = in[4 + i] + in[8 + i];
        int c1 = in[4 + i] - in[8 + i];
        int d1 = in[i] - in[12 + i];
        tmp[i] = a1 + b1;
        tmp[4 + i] = c1 + d1;
        tmp[8 + i] = a1 - b1;
        tmp[12 + i] = d1 - c1;
    }
    for (int i = 0; i < 4; ++i) {
        const int* ip = tmp + 4 * i;
        int a1 = ip[0] + ip[3];
        int b1 = ip[1] + ip[2];
        int c1 = ip[1] - ip[2];
        int d1 = ip[0] - ip[3];
        out[4 * i + 0] = int16_t((a1 + b1 + 3) >> 3);
        out[4 * i + 1] = int16_t((c1 + d1 + 3) >> 3);
        out[4 * i + 2] = int16_t((a1 - b1 + 3) >> 3);
        out[4 * i + 3] = int16_t((d1 - c1 + 3) >> 3);
    }
}

// -------------------------------------------------------------- decoder
struct Segment {
    int quant = 0;   // resolved quantizer index
    int flevel = 0;  // resolved loop filter level
};

struct QuantMat {
    int y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac;
};

struct MBInfo {
    uint8_t segment = 0;
    uint8_t skip = 0;
    uint8_t ymode = 0;   // 0..3 or 4=B_PRED
    uint8_t uvmode = 0;
    uint8_t bmodes[16];  // 4x4 modes (implied when ymode != B_PRED)
    uint8_t has_nonzero = 0;  // any coeff decoded (for loop filter rule)
};

struct VP8Dec {
    int mb_w = 0, mb_h = 0, width = 0, height = 0;
    BoolDec hdr;                  // partition 0
    BoolDec parts[8];
    int num_parts = 1;

    // header state
    bool seg_enabled = false, seg_update_map = false, seg_abs = false;
    uint8_t seg_tree_probs[3] = {255, 255, 255};
    int seg_quant[4] = {0, 0, 0, 0}, seg_lf[4] = {0, 0, 0, 0};
    int filter_type = 0, filter_level = 0, sharpness = 0;
    bool lf_delta = false;
    int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
    int q_index = 0, dq_y1_dc = 0, dq_y2_dc = 0, dq_y2_ac = 0, dq_uv_dc = 0,
        dq_uv_ac = 0;
    bool use_skip = false;
    int skip_prob = 0;
    uint8_t probs[4][8][3][11];

    QuantMat qmat[4];

    // planes (MB-aligned + 1 border row/col handled separately)
    std::vector<uint8_t> Y, U, V;
    int ys = 0, uvs = 0;  // strides

    // prediction edge state
    std::vector<uint8_t> y_above, u_above, v_above;  // +8 for top-right
    std::vector<MBInfo> mbs;                         // full frame (for filter)

    // nonzero contexts
    std::vector<uint8_t> top_ctx;  // mb_w * 9
    uint8_t left_ctx[9];

    int16_t coeffs[25][16];  // y2 at [24]
    uint8_t nz_blocks[25];
};

// token decoding for one block. Returns number of coeffs (0 if all zero).
int get_coeffs(BoolDec& bd, const uint8_t probs[8][3][11], int ctx,
               const int* dq /*[2] dc,ac*/, int first, int16_t out[16]) {
    memset(out, 0, 16 * sizeof(int16_t));
    int n = first;
    const uint8_t* p = probs[kBands[n]][ctx];
    while (n < 16) {
        if (!bd.get(p[0])) return n;  // EOB
        int v;
        while (!bd.get(p[1])) {  // zero coeff: next token skips EOB branch
            ++n;
            if (n >= 16) return 16;
            p = probs[kBands[n]][0];
        }
        if (!bd.get(p[2])) {
            v = 1;
            p = probs[kBands[n + 1 < 16 ? n + 1 : 15]][1];
        } else {
            if (!bd.get(p[3])) {  // 2,3,4
                if (!bd.get(p[4])) {
                    v = 2;
                } else {
                    v = 3 + bd.get(p[5]);
                }
            } else {
                if (!bd.get(p[6])) {  // cat1/cat2
                    if (!bd.get(p[7])) {
                        v = 5 + bd.get(159);
                    } else {
                        v = 7 + 2 * bd.get(165) + bd.get(145);
                    }
                } else {  // cat3..6
                    int cat;
                    if (!bd.get(p[8])) {
                        cat = 2 + bd.get(p[9]);   // cat3/cat4
                    } else {
                        cat = 4 + bd.get(p[10]);  // cat5/cat6
                    }
                    v = kCatBase[cat];
                    const uint8_t* cp = kCatProbs[cat];
                    for (int i = 0; i < kCatBits[cat]; ++i)
                        v += bd.get(cp[i]) << (kCatBits[cat] - 1 - i);
                }
            }
            p = probs[kBands[n + 1 < 16 ? n + 1 : 15]][2];
        }
        if (bd.get(128)) v = -v;
        out[kZigzag[n]] = int16_t(v * dq[n > 0 ? 1 : 0]);
        ++n;
    }
    return 16;
}

// ----------------------------------------------------- intra prediction
// Buffers are accessed through row pointers with an explicit "edge" row
// above and column to the left, materialized per MB in a 36x36 scratch?
// Simpler: predict directly into the frame planes, reading the already
// reconstructed neighbors; frame planes carry one extra border row/col
// initialized to 127 (above) / 129 (left).

struct Plane {
    uint8_t* base;  // points at pixel (0,0); border at (-1) offsets valid
    int stride;
    uint8_t at(int x, int y) const { return base[y * stride + x]; }
    uint8_t* row(int y) { return base + y * stride; }
};

void pred_dc(Plane p, int x0, int y0, int n, bool have_top, bool have_left) {
    int sum = 0, total = 0;
    if (have_top) {
        for (int i = 0; i < n; ++i) sum += p.at(x0 + i, y0 - 1);
        total += n;
    }
    if (have_left) {
        for (int i = 0; i < n; ++i) sum += p.at(x0 - 1, y0 + i);
        total += n;
    }
    uint8_t dc = total ? uint8_t((sum + total / 2) / total) : 128;
    for (int y = 0; y < n; ++y) memset(p.row(y0 + y) + x0, dc, n);
}

void pred_v(Plane p, int x0, int y0, int n) {
    for (int y = 0; y < n; ++y)
        memcpy(p.row(y0 + y) + x0, p.row(y0 - 1) + x0, n);
}

void pred_h(Plane p, int x0, int y0, int n) {
    for (int y = 0; y < n; ++y)
        memset(p.row(y0 + y) + x0, p.at(x0 - 1, y0 + y), n);
}

void pred_tm(Plane p, int x0, int y0, int n) {
    int tl = p.at(x0 - 1, y0 - 1);
    for (int y = 0; y < n; ++y) {
        int l = p.at(x0 - 1, y0 + y);
        uint8_t* r = p.row(y0 + y) + x0;
        for (int x = 0; x < n; ++x) r[x] = clip8(l + p.at(x0 + x, y0 - 1) - tl);
    }
}

// 4x4 luma prediction (RFC 12.3). A[] = above 0..7 (incl. above-right),
// L[] = left 0..3, TL = above-left.
void pred_b(uint8_t mode, const uint8_t* A, const uint8_t* L, uint8_t TL,
            uint8_t out[4][4]) {
    auto avg3 = [](int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); };
    auto avg2 = [](int a, int b) { return uint8_t((a + b + 1) >> 1); };
    switch (mode) {
        case 0: {  // B_DC
            int s = 4;
            for (int i = 0; i < 4; ++i) s += A[i] + L[i];
            uint8_t dc = uint8_t(s >> 3);
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) out[y][x] = dc;
            break;
        }
        case 1:  // B_TM
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x)
                    out[y][x] = clip8(L[y] + A[x] - TL);
            break;
        case 2: {  // B_VE
            uint8_t r[4];
            r[0] = avg3(TL, A[0], A[1]);
            r[1] = avg3(A[0], A[1], A[2]);
            r[2] = avg3(A[1], A[2], A[3]);
            r[3] = avg3(A[2], A[3], A[4]);
            for (int y = 0; y < 4; ++y) memcpy(out[y], r, 4);
            break;
        }
        case 3: {  // B_HE
            out[0][0] = out[0][1] = out[0][2] = out[0][3] =
                avg3(TL, L[0], L[1]);
            out[1][0] = out[1][1] = out[1][2] = out[1][3] =
                avg3(L[0], L[1], L[2]);
            out[2][0] = out[2][1] = out[2][2] = out[2][3] =
                avg3(L[1], L[2], L[3]);
            out[3][0] = out[3][1] = out[3][2] = out[3][3] =
                avg3(L[2], L[3], L[3]);
            break;
        }
        case 4:  // B_LD
            out[0][0] = avg3(A[0], A[1], A[2]);
            out[0][1] = out[1][0] = avg3(A[1], A[2], A[3]);
            out[0][2] = out[1][1] = out[2][0] = avg3(A[2], A[3], A[4]);
            out[0][3] = out[1][2] = out[2][1] = out[3][0] =
                avg3(A[3], A[4], A[5]);
            out[1][3] = out[2][2] = out[3][1] = avg3(A[4], A[5], A[6]);
            out[2][3] = out[3][2] = avg3(A[5], A[6], A[7]);
            out[3][3] = avg3(A[6], A[7], A[7]);
            break;
        case 5:  // B_RD
            out[3][0] = avg3(L[3], L[2], L[1]);
            out[2][0] = out[3][1] = avg3(L[2], L[1], L[0]);
            out[1][0] = out[2][1] = out[3][2] = avg3(L[1], L[0], TL);
            out[0][0] = out[1][1] = out[2][2] = out[3][3] =
                avg3(L[0], TL, A[0]);
            out[0][1] = out[1][2] = out[2][3] = avg3(TL, A[0], A[1]);
            out[0][2] = out[1][3] = avg3(A[0], A[1], A[2]);
            out[0][3] = avg3(A[1], A[2], A[3]);
            break;
        case 6:  // B_VR
            out[3][0] = avg3(L[2], L[1], L[0]);
            out[2][0] = avg3(L[1], L[0], TL);
            out[1][0] = out[3][1] = avg3(L[0], TL, A[0]);
            out[0][0] = out[2][1] = avg2(TL, A[0]);
            out[1][1] = out[3][2] = avg3(TL, A[0], A[1]);
            out[0][1] = out[2][2] = avg2(A[0], A[1]);
            out[1][2] = out[3][3] = avg3(A[0], A[1], A[2]);
            out[0][2] = out[2][3] = avg2(A[1], A[2]);
            out[1][3] = avg3(A[1], A[2], A[3]);
            out[0][3] = avg2(A[2], A[3]);
            break;
        case 7:  // B_VL
            out[0][0] = avg2(A[0], A[1]);
            out[1][0] = avg3(A[0], A[1], A[2]);
            out[2][0] = out[0][1] = avg2(A[1], A[2]);
            out[1][1] = out[3][0] = avg3(A[1], A[2], A[3]);
            out[2][1] = out[0][2] = avg2(A[2], A[3]);
            out[3][1] = out[1][2] = avg3(A[2], A[3], A[4]);
            out[2][2] = out[0][3] = avg2(A[3], A[4]);
            out[3][2] = out[1][3] = avg3(A[3], A[4], A[5]);
            out[2][3] = avg3(A[4], A[5], A[6]);
            out[3][3] = avg3(A[5], A[6], A[7]);
            break;
        case 8:  // B_HD
            out[3][0] = avg2(L[3], L[2]);
            out[3][1] = avg3(L[3], L[2], L[1]);
            out[2][0] = out[3][2] = avg2(L[2], L[1]);
            out[2][1] = out[3][3] = avg3(L[2], L[1], L[0]);
            out[1][0] = out[2][2] = avg2(L[1], L[0]);
            out[1][1] = out[2][3] = avg3(L[1], L[0], TL);
            out[0][0] = out[1][2] = avg2(L[0], TL);
            out[0][1] = out[1][3] = avg3(L[0], TL, A[0]);
            out[0][2] = avg3(TL, A[0], A[1]);
            out[0][3] = avg3(A[0], A[1], A[2]);
            break;
        default:  // 9: B_HU
            out[0][0] = avg2(L[0], L[1]);
            out[0][1] = avg3(L[0], L[1], L[2]);
            out[0][2] = out[1][0] = avg2(L[1], L[2]);
            out[0][3] = out[1][1] = avg3(L[1], L[2], L[3]);
            out[1][2] = out[2][0] = avg2(L[2], L[3]);
            out[1][3] = out[2][1] = avg3(L[2], L[3], L[3]);
            out[2][2] = out[2][3] = out[3][0] = out[3][1] = out[3][2] =
                out[3][3] = L[3];
            break;
    }
}

// ------------------------------------------------------------ loop filter
inline int8_t s8(uint8_t v) { return int8_t(int(v) - 128); }
inline uint8_t u8c(int v) {
    return uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
}
inline int c128(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }

struct LFParams {
    int f_limit;       // edge limit (mb or subblock)
    int i_limit;       // interior limit
    int hev_t;         // high edge variance threshold
};

inline bool filter_mask(const uint8_t* p, int step, const LFParams& lf,
                        bool mb_edge) {
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step],
        p0 = p[-1 * step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
        q3 = p[3 * step];
    (void)mb_edge;
    return (abs(p0 - q0) * 2 + abs(p1 - q1) / 2) <= lf.f_limit &&
           abs(p3 - p2) <= lf.i_limit && abs(p2 - p1) <= lf.i_limit &&
           abs(p1 - p0) <= lf.i_limit && abs(q1 - q0) <= lf.i_limit &&
           abs(q2 - q1) <= lf.i_limit && abs(q3 - q2) <= lf.i_limit;
}

inline bool hev(const uint8_t* p, int step, int t) {
    return abs(p[-2 * step] - p[-1 * step]) > t || abs(p[step] - p[0]) > t;
}

// normal subblock filter (RFC 15.3 subblock_filter)
inline void filter_common(uint8_t* p, int step, bool use_outer) {
    int P1 = s8(p[-2 * step]), P0 = s8(p[-step]), Q0 = s8(p[0]),
        Q1 = s8(p[step]);
    int a = c128((use_outer ? c128(P1 - Q1) : 0) + 3 * (Q0 - P0));
    int F1 = c128(a + 4) >> 3;
    int F2 = c128(a + 3) >> 3;
    p[0] = u8c(Q0 - F1);
    p[-step] = u8c(P0 + F2);
    if (!use_outer) {
        int a2 = (F1 + 1) >> 1;
        p[step] = u8c(Q1 - a2);
        p[-2 * step] = u8c(P1 + a2);
    }
}

inline void subblock_filter(uint8_t* p, int step, const LFParams& lf) {
    if (!filter_mask(p, step, lf, false)) return;
    bool h = hev(p, step, lf.hev_t);
    filter_common(p, step, h);
}

// macroblock edge filter (RFC 15.3 mbfilter)
inline void mb_filter(uint8_t* p, int step, const LFParams& lf) {
    if (!filter_mask(p, step, lf, true)) return;
    if (hev(p, step, lf.hev_t)) {
        filter_common(p, step, true);
        return;
    }
    int P2 = s8(p[-3 * step]), P1 = s8(p[-2 * step]), P0 = s8(p[-step]),
        Q0 = s8(p[0]), Q1 = s8(p[step]), Q2 = s8(p[2 * step]);
    int w = c128(c128(P1 - Q1) + 3 * (Q0 - P0));
    int a = c128((27 * w + 63) >> 7);
    p[0] = u8c(Q0 - a);
    p[-step] = u8c(P0 + a);
    a = c128((18 * w + 63) >> 7);
    p[step] = u8c(Q1 - a);
    p[-2 * step] = u8c(P1 + a);
    a = c128((9 * w + 63) >> 7);
    p[2 * step] = u8c(Q2 - a);
    p[-3 * step] = u8c(P2 + a);
}

// simple filter (RFC 15.4): Y only, p0/q0 taps
inline void simple_filter(uint8_t* p, int step, int limit) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    if (abs(p0 - q0) * 2 + abs(p1 - q1) / 2 > limit) return;
    filter_common(p, step, true);
}

}  // namespace

extern "C" {

// Decode a VP8 keyframe (the payload of a WebP "VP8 " chunk).
// Outputs cropped YUV420 planes. Returns 0, negative on malformed data.
int tic_vp8_decode(const uint8_t* data, size_t len, uint8_t* ybuf,
                   uint8_t* ubuf, uint8_t* vbuf, int64_t cap, int32_t* out_w,
                   int32_t* out_h, int32_t flags) {
    const bool skip_filter = flags & 1;  // debug/stage-isolation aid
    if (len < 10) return -1;
    uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
    if (tag & 1) return -2;  // not a keyframe
    size_t part0 = tag >> 5;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -3;
    int w = (data[6] | (data[7] << 8)) & 0x3FFF;
    int h = (data[8] | (data[9] << 8)) & 0x3FFF;
    if (w <= 0 || h <= 0) return -4;
    if (10 + part0 > len) return -5;

    VP8Dec d;
    d.width = w;
    d.height = h;
    d.mb_w = (w + 15) >> 4;
    d.mb_h = (h + 15) >> 4;
    if (int64_t(w) * h > cap || int64_t((w + 1) / 2) * ((h + 1) / 2) > cap)
        return -6;

    d.hdr.init(data + 10, part0);
    BoolDec& bd = d.hdr;

    bd.bit();  // color space
    bd.bit();  // clamping
    d.seg_enabled = bd.bit();
    if (d.seg_enabled) {
        d.seg_update_map = bd.bit();
        bool update_data = bd.bit();
        if (update_data) {
            d.seg_abs = bd.bit();
            for (int i = 0; i < 4; ++i)
                d.seg_quant[i] = bd.bit() ? bd.signed_literal(7) : 0;
            for (int i = 0; i < 4; ++i)
                d.seg_lf[i] = bd.bit() ? bd.signed_literal(6) : 0;
        }
        if (d.seg_update_map)
            for (int i = 0; i < 3; ++i)
                d.seg_tree_probs[i] =
                    bd.bit() ? uint8_t(bd.literal(8)) : 255;
    }
    d.filter_type = bd.bit();
    d.filter_level = bd.literal(6);
    d.sharpness = bd.literal(3);
    d.lf_delta = bd.bit();
    if (d.lf_delta) {
        if (bd.bit()) {  // update
            for (int i = 0; i < 4; ++i)
                if (bd.bit()) d.ref_lf_delta[i] = bd.signed_literal(6);
            for (int i = 0; i < 4; ++i)
                if (bd.bit()) d.mode_lf_delta[i] = bd.signed_literal(6);
        }
    }
    int log2_parts = bd.literal(2);
    d.num_parts = 1 << log2_parts;
    // token partition sizes follow partition 0
    const uint8_t* pstart = data + 10 + part0;
    size_t prem = len - 10 - part0;
    if (d.num_parts > 1) {
        size_t need = size_t(3) * (d.num_parts - 1);
        if (prem < need) return -7;
        const uint8_t* sz = pstart;
        pstart += need;
        prem -= need;
        for (int i = 0; i < d.num_parts - 1; ++i) {
            size_t pl = sz[3 * i] | (sz[3 * i + 1] << 8) | (sz[3 * i + 2] << 16);
            if (pl > prem) return -8;
            d.parts[i].init(pstart, pl);
            pstart += pl;
            prem -= pl;
        }
    }
    d.parts[d.num_parts - 1].init(pstart, prem);

    d.q_index = bd.literal(7);
    d.dq_y1_dc = bd.bit() ? bd.signed_literal(4) : 0;
    d.dq_y2_dc = bd.bit() ? bd.signed_literal(4) : 0;
    d.dq_y2_ac = bd.bit() ? bd.signed_literal(4) : 0;
    d.dq_uv_dc = bd.bit() ? bd.signed_literal(4) : 0;
    d.dq_uv_ac = bd.bit() ? bd.signed_literal(4) : 0;
    bd.bit();  // refresh entropy (keyframe: ignored)

    memcpy(d.probs, kCoeffProba0, sizeof(d.probs));
    {
        const uint8_t* up = kCoeffUpdateProba;
        uint8_t* pp = &d.probs[0][0][0][0];
        for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
            if (bd.get(up[i])) pp[i] = uint8_t(bd.literal(8));
    }
    d.use_skip = bd.bit();
    if (d.use_skip) d.skip_prob = bd.literal(8);

    // quant matrices per segment
    for (int s = 0; s < 4; ++s) {
        int q;
        if (d.seg_enabled) {
            q = d.seg_abs ? d.seg_quant[s] : d.q_index + d.seg_quant[s];
        } else {
            q = d.q_index;
        }
        QuantMat& m = d.qmat[s];
        m.y1_dc = kDcQLookup[clampq(q + d.dq_y1_dc)];
        m.y1_ac = kAcQLookup[clampq(q)];
        m.y2_dc = kDcQLookup[clampq(q + d.dq_y2_dc)] * 2;
        m.y2_ac = kAcQLookup[clampq(q + d.dq_y2_ac)] * 155 / 100;
        if (m.y2_ac < 8) m.y2_ac = 8;
        m.uv_dc = kDcQLookup[clampq(q + d.dq_uv_dc)];
        if (m.uv_dc > 132) m.uv_dc = 132;
        m.uv_ac = kAcQLookup[clampq(q + d.dq_uv_ac)];
    }

    // frame buffers with a 1-px top/left border for prediction edges
    const int W16 = d.mb_w * 16, H16 = d.mb_h * 16;
    const int W8 = d.mb_w * 8, H8 = d.mb_h * 8;
    d.ys = W16 + 8;        // +4 slack for above-right reads
    d.uvs = W8 + 8;
    std::vector<uint8_t> ybig((H16 + 1) * d.ys + 8, 0);
    std::vector<uint8_t> ubig((H8 + 1) * d.uvs + 8, 0);
    std::vector<uint8_t> vbig((H8 + 1) * d.uvs + 8, 0);
    Plane PY{ybig.data() + d.ys + 1, d.ys};
    Plane PU{ubig.data() + d.uvs + 1, d.uvs};
    Plane PV{vbig.data() + d.uvs + 1, d.uvs};
    // top border 127 (incl. top-right slack), left border 129, corner 127
    memset(PY.row(-1) - 1, 127, d.ys);
    memset(PU.row(-1) - 1, 127, d.uvs);
    memset(PV.row(-1) - 1, 127, d.uvs);
    for (int y = 0; y < H16; ++y) PY.row(y)[-1] = 129;
    for (int y = 0; y < H8; ++y) {
        PU.row(y)[-1] = 129;
        PV.row(y)[-1] = 129;
    }

    d.mbs.resize(size_t(d.mb_w) * d.mb_h);
    d.top_ctx.assign(size_t(d.mb_w) * 9, 0);

    // per-MB decode
    for (int my = 0; my < d.mb_h; ++my) {
        memset(d.left_ctx, 0, sizeof(d.left_ctx));
        BoolDec& tok = d.parts[my % d.num_parts];
        // left b-mode context column (for B_PRED mode coding)
        uint8_t left_bmodes[4] = {0, 0, 0, 0};
        for (int mx = 0; mx < d.mb_w; ++mx) {
            MBInfo& mb = d.mbs[size_t(my) * d.mb_w + mx];
            MBInfo* above = my > 0 ? &d.mbs[size_t(my - 1) * d.mb_w + mx]
                                   : nullptr;
            // --- mode parsing (partition 0)
            if (d.seg_enabled && d.seg_update_map) {
                int id;
                if (!bd.get(d.seg_tree_probs[0]))
                    id = bd.get(d.seg_tree_probs[1]);
                else
                    id = 2 + bd.get(d.seg_tree_probs[2]);
                mb.segment = uint8_t(id);
            }
            mb.skip = d.use_skip ? uint8_t(bd.get(d.skip_prob)) : 0;
            mb.ymode = uint8_t(tree_read(bd, kKfYModeTree, kKfYModeProbs));
            if (mb.ymode == 4) {  // B_PRED: 16 sub modes with a/l context
                for (int sy = 0; sy < 4; ++sy)
                    for (int sx = 0; sx < 4; ++sx) {
                        int am = sy > 0 ? mb.bmodes[(sy - 1) * 4 + sx]
                                 : above ? above->bmodes[12 + sx]
                                         : 0;
                        int lm = sx > 0 ? mb.bmodes[sy * 4 + sx - 1]
                                 : mx > 0 ? left_bmodes[sy]
                                          : 0;
                        mb.bmodes[sy * 4 + sx] = uint8_t(tree_read(
                            bd, kBModeTree, &kKfBModesProba[(am * 10 + lm) * 9]));
                    }
            } else {
                // implied 4x4 modes for neighbor context (RFC 11.3)
                static const uint8_t imp[4] = {0, 2, 3, 1};  // DC,V,H,TM
                memset(mb.bmodes, imp[mb.ymode], 16);
            }
            for (int sy = 0; sy < 4; ++sy)
                left_bmodes[sy] = mb.bmodes[sy * 4 + 3];
            mb.uvmode = uint8_t(tree_read(bd, kUVModeTree, kKfUVModeProbs));

            // --- residuals (token partition)
            const QuantMat& qm = d.qmat[mb.segment];
            uint8_t* tctx = &d.top_ctx[size_t(mx) * 9];
            int16_t(*cf)[16] = d.coeffs;
            memset(cf, 0, sizeof(d.coeffs));
            memset(d.nz_blocks, 0, sizeof(d.nz_blocks));
            bool has_y2 = mb.ymode != 4;
            mb.has_nonzero = 0;
            if (mb.skip) {
                memset(d.left_ctx, 0, 4);
                memset(tctx, 0, 4);
                d.left_ctx[4] = d.left_ctx[5] = d.left_ctx[6] =
                    d.left_ctx[7] = 0;
                tctx[4] = tctx[5] = tctx[6] = tctx[7] = 0;
                if (has_y2) {
                    // Y2 context clears only when the skipped MB has a Y2
                    // block (libwebp: nz_dc = 0 iff !is_i4x4). A skipped
                    // B_PRED MB leaves it untouched.
                    d.left_ctx[8] = tctx[8] = 0;
                }
            } else {
                int first = 0;
                int ytype = 3;
                if (has_y2) {
                    int dq[2] = {qm.y2_dc, qm.y2_ac};
                    int ctx = d.left_ctx[8] + tctx[8];
                    int nz = get_coeffs(tok, d.probs[1], ctx, dq, 0, cf[24]);
                    d.left_ctx[8] = tctx[8] = nz > 0;
                    d.nz_blocks[24] = nz > 0;
                    if (nz > 0) mb.has_nonzero = 1;
                    first = 1;
                    ytype = 0;
                }
                int dqy[2] = {qm.y1_dc, qm.y1_ac};
                for (int b = 0; b < 16; ++b) {
                    int sx = b & 3, sy = b >> 2;
                    int ctx = d.left_ctx[sy] + tctx[sx];
                    int nz = get_coeffs(tok, d.probs[ytype], ctx, dqy, first,
                                        cf[b]);
                    d.left_ctx[sy] = tctx[sx] = nz > first;
                    d.nz_blocks[b] = nz > first;
                    if (nz > first) mb.has_nonzero = 1;
                }
                int dquv[2] = {qm.uv_dc, qm.uv_ac};
                for (int pl = 0; pl < 2; ++pl)
                    for (int b = 0; b < 4; ++b) {
                        int sx = b & 1, sy = b >> 1;
                        int li = 4 + 2 * pl + sy, ti = 4 + 2 * pl + sx;
                        int ctx = d.left_ctx[li] + tctx[ti];
                        int nz = get_coeffs(tok, d.probs[2], ctx, dquv, 0,
                                            cf[16 + 4 * pl + b]);
                        d.left_ctx[li] = tctx[ti] = nz > 0;
                        d.nz_blocks[16 + 4 * pl + b] = nz > 0;
                        if (nz) mb.has_nonzero = 1;
                    }
                if (has_y2) {
                    // distribute WHT-transformed DC into luma blocks
                    int16_t wht[16];
                    iwht4x4(cf[24], wht);
                    for (int b = 0; b < 16; ++b) cf[b][0] = wht[b];
                }
            }

            // --- reconstruct
            int x0 = mx * 16, y0 = my * 16;
            bool have_top = true, have_left = true;  // borders always valid
            // (borders are initialized; DC prediction edge handling follows
            //  VP8: top row uses 127s, left col 129s, but DC mode must use
            //  the "no-edge" averaging rules instead)
            have_top = my > 0;
            have_left = mx > 0;
            int16_t res[16];
            if (mb.ymode == 4) {
                for (int b = 0; b < 16; ++b) {
                    int sx = x0 + (b & 3) * 4, sy = y0 + (b >> 2) * 4;
                    uint8_t A[8], L[4], TL;
                    for (int i = 0; i < 4; ++i) {
                        L[i] = PY.at(sx - 1, sy + i);
                        A[i] = PY.at(sx + i, sy - 1);
                    }
                    TL = PY.at(sx - 1, sy - 1);
                    // above-right: interior rows use the MB-above row
                    bool right_col = (b & 3) == 3;
                    int ary = right_col ? y0 - 1 : sy - 1;
                    int arx = sx + 4;
                    bool last_mb = mx == d.mb_w - 1;
                    for (int i = 0; i < 4; ++i) {
                        if (right_col && last_mb) {
                            A[4 + i] = my > 0 ? PY.at(x0 + 15, y0 - 1) : 127;
                        } else {
                            A[4 + i] = PY.at(arx + i, ary);
                        }
                    }
                    uint8_t pred[4][4];
                    pred_b(mb.bmodes[b], A, L, TL, pred);
                    if (d.nz_blocks[b]) {
                        idct4x4(cf[b], res);
                        for (int yy = 0; yy < 4; ++yy) {
                            uint8_t* r = PY.row(sy + yy) + sx;
                            for (int xx = 0; xx < 4; ++xx)
                                r[xx] = clip8(pred[yy][xx] + res[4 * yy + xx]);
                        }
                    } else if (cf[b][0]) {
                        // DC-only shortcut (uniform add)
                        int v = (cf[b][0] + 4) >> 3;
                        for (int yy = 0; yy < 4; ++yy) {
                            uint8_t* r = PY.row(sy + yy) + sx;
                            for (int xx = 0; xx < 4; ++xx)
                                r[xx] = clip8(pred[yy][xx] + v);
                        }
                    } else {
                        for (int yy = 0; yy < 4; ++yy)
                            memcpy(PY.row(sy + yy) + sx, pred[yy], 4);
                    }
                }
            } else {
                switch (mb.ymode) {
                    case 0: pred_dc(PY, x0, y0, 16, have_top, have_left); break;
                    case 1: pred_v(PY, x0, y0, 16); break;
                    case 2: pred_h(PY, x0, y0, 16); break;
                    default: pred_tm(PY, x0, y0, 16); break;
                }
                for (int b = 0; b < 16; ++b) {
                    int sx = x0 + (b & 3) * 4, sy = y0 + (b >> 2) * 4;
                    if (d.nz_blocks[b] || cf[b][0]) {
                        idct4x4(cf[b], res);
                        for (int yy = 0; yy < 4; ++yy) {
                            uint8_t* r = PY.row(sy + yy) + sx;
                            for (int xx = 0; xx < 4; ++xx)
                                r[xx] = clip8(r[xx] + res[4 * yy + xx]);
                        }
                    }
                }
            }
            // chroma
            int cx0 = mx * 8, cy0 = my * 8;
            Plane CP[2] = {PU, PV};
            for (int pl = 0; pl < 2; ++pl) {
                Plane P = CP[pl];
                switch (mb.uvmode) {
                    case 0: pred_dc(P, cx0, cy0, 8, have_top, have_left); break;
                    case 1: pred_v(P, cx0, cy0, 8); break;
                    case 2: pred_h(P, cx0, cy0, 8); break;
                    default: pred_tm(P, cx0, cy0, 8); break;
                }
                for (int b = 0; b < 4; ++b) {
                    int sx = cx0 + (b & 1) * 4, sy = cy0 + (b >> 1) * 4;
                    const int16_t* c = cf[16 + 4 * pl + b];
                    if (d.nz_blocks[16 + 4 * pl + b] || c[0]) {
                        idct4x4(c, res);
                        for (int yy = 0; yy < 4; ++yy) {
                            uint8_t* r = P.row(sy + yy) + sx;
                            for (int xx = 0; xx < 4; ++xx)
                                r[xx] = clip8(r[xx] + res[4 * yy + xx]);
                        }
                    }
                }
            }
        }
    }

    // ---------------------------------------------------------- loop filter
    if (d.filter_level > 0 && !skip_filter) {
        for (int my = 0; my < d.mb_h; ++my) {
            for (int mx = 0; mx < d.mb_w; ++mx) {
                const MBInfo& mb = d.mbs[size_t(my) * d.mb_w + mx];
                int level = d.filter_level;
                if (d.seg_enabled)
                    level = d.seg_abs ? d.seg_lf[mb.segment]
                                      : d.filter_level + d.seg_lf[mb.segment];
                if (d.lf_delta) {
                    level += d.ref_lf_delta[0];  // intra frame
                    if (mb.ymode == 4) level += d.mode_lf_delta[0];
                }
                level = level < 0 ? 0 : level > 63 ? 63 : level;
                if (level == 0) continue;
                int ilim = level;
                if (d.sharpness > 0) {
                    ilim >>= d.sharpness > 4 ? 2 : 1;
                    if (ilim > 9 - d.sharpness) ilim = 9 - d.sharpness;
                }
                if (ilim < 1) ilim = 1;
                int hevt = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                bool inner = mb.ymode == 4 || mb.has_nonzero;
                int x0 = mx * 16, y0 = my * 16, cx0 = mx * 8, cy0 = my * 8;
                if (d.filter_type == 1) {  // simple (Y only)
                    int mblim = 2 * (level + 2) + ilim;
                    int blim = 2 * level + ilim;
                    if (mx > 0)
                        for (int y = 0; y < 16; ++y)
                            simple_filter(PY.row(y0 + y) + x0, 1, mblim);
                    if (inner)
                        for (int dx = 4; dx < 16; dx += 4)
                            for (int y = 0; y < 16; ++y)
                                simple_filter(PY.row(y0 + y) + x0 + dx, 1,
                                              blim);
                    if (my > 0)
                        for (int x = 0; x < 16; ++x)
                            simple_filter(PY.row(y0) + x0 + x, d.ys, mblim);
                    if (inner)
                        for (int dy = 4; dy < 16; dy += 4)
                            for (int x = 0; x < 16; ++x)
                                simple_filter(PY.row(y0 + dy) + x0 + x, d.ys,
                                              blim);
                } else {  // normal
                    LFParams mbp{2 * (level + 2) + ilim, ilim, hevt};
                    LFParams sbp{2 * level + ilim, ilim, hevt};
                    if (mx > 0) {
                        for (int y = 0; y < 16; ++y)
                            mb_filter(PY.row(y0 + y) + x0, 1, mbp);
                        for (int y = 0; y < 8; ++y) {
                            mb_filter(PU.row(cy0 + y) + cx0, 1, mbp);
                            mb_filter(PV.row(cy0 + y) + cx0, 1, mbp);
                        }
                    }
                    if (inner) {
                        for (int dx = 4; dx < 16; dx += 4)
                            for (int y = 0; y < 16; ++y)
                                subblock_filter(PY.row(y0 + y) + x0 + dx, 1,
                                                sbp);
                        for (int y = 0; y < 8; ++y) {
                            subblock_filter(PU.row(cy0 + y) + cx0 + 4, 1, sbp);
                            subblock_filter(PV.row(cy0 + y) + cx0 + 4, 1, sbp);
                        }
                    }
                    if (my > 0) {
                        for (int x = 0; x < 16; ++x)
                            mb_filter(PY.row(y0) + x0 + x, d.ys, mbp);
                        for (int x = 0; x < 8; ++x) {
                            mb_filter(PU.row(cy0) + cx0 + x, d.uvs, mbp);
                            mb_filter(PV.row(cy0) + cx0 + x, d.uvs, mbp);
                        }
                    }
                    if (inner) {
                        for (int dy = 4; dy < 16; dy += 4)
                            for (int x = 0; x < 16; ++x)
                                subblock_filter(PY.row(y0 + dy) + x0 + x,
                                                d.ys, sbp);
                        for (int x = 0; x < 8; ++x) {
                            subblock_filter(PU.row(cy0 + 4) + cx0 + x, d.uvs,
                                            sbp);
                            subblock_filter(PV.row(cy0 + 4) + cx0 + x, d.uvs,
                                            sbp);
                        }
                    }
                }
            }
        }
    }

    // ---- crop out
    int cw = (w + 1) / 2, ch = (h + 1) / 2;
    for (int y = 0; y < h; ++y) memcpy(ybuf + size_t(y) * w, PY.row(y), w);
    for (int y = 0; y < ch; ++y) {
        memcpy(ubuf + size_t(y) * cw, PU.row(y), cw);
        memcpy(vbuf + size_t(y) * cw, PV.row(y), cw);
    }
    *out_w = w;
    *out_h = h;
    return 0;
}

}  // extern "C"
