"""Restart-segment-parallel JPEG Huffman decode on the GPU (Pallas, Triton).

The reference's hybrid decoder keeps entropy decode on the host CPU
(extensions/nvjpeg/cuda_decoder.cpp:425-427 nvjpegDecodeJpegHost) and has
an optional GPU Huffman stage for large images. Here, for streams with
restart markers, the host only splits each scan at the markers, ships the
destuffed words column-packed as a [W, S] uint32 matrix, and this kernel
decodes one restart segment per lane:

- every lane owns a bit reader held in registers: a 64-bit window in two
  uint32 words (`cur`, `nxt`) and the row of the next word to fetch, which
  it gathers itself from `words[row, lane]` (the column-major layout keeps
  a warp's fetches close together);
- one loop iteration decodes one Huffman symbol and its extra bits on every
  live lane. A symbol is looked up in a 12-bit table (L1-resident), codes
  longer than 12 bits in a 16-bit table; symbol plus extra bits are at most
  31 bits, so one window read and at most one word fetch cover both;
- each lane walks its own blocks (block in MCU -> component and tables
  through a small per-bucket table), so lanes never wait for each other at
  block boundaries; the loop ends when every lane of the program is done;
- nonzero coefficients are scattered into a zeroed [S, NBLK, 64] int16
  output in zigzag order (the pixel stage folds zigzag into the IDCT
  matrix); per-lane error flags mark malformed segments.

The grid runs over tiles of `LANE_TILE` lanes. Requires baseline 8-bit,
one interleaved scan and a restart interval; everything else stays on the
host entropy stage.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

LANE_TILE = 32  # lanes per program (one warp)
_LUT_BITS = 12  # first-level lookup width; longer codes use the 16-bit table


_TABLES_CACHE: dict = {}


def _build_tables(frame):
    """Per table class, {table id: (bits[16], values)} as hashable tuples.
    Content-cached: corpora typically share Huffman tables across frames,
    and this runs per sample on the routing path."""
    fp = tuple(
        (tc, tid, bytes(t.bits), bytes(t.values))
        for tc, tabs in enumerate((frame.dc_huff, frame.ac_huff))
        for tid, t in sorted(tabs.items())
    )
    hit = _TABLES_CACHE.get(fp)
    if hit is not None:
        return hit
    classes = [
        {tid: (tuple(int(b) for b in t.bits), tuple(int(v) for v in t.values))
         for tid, t in tabs.items()}
        for tabs in (frame.dc_huff, frame.ac_huff)
    ]
    if len(_TABLES_CACHE) > 4096:
        _TABLES_CACHE.clear()
    _TABLES_CACHE[fp] = classes
    return classes  # [dc_tables, ac_tables]


def entropy_kernel_spec(frame) -> Tuple:
    """Static bucket description: (R, comp_map, tables, total MCUs), R =
    MCUs per segment (the restart interval) and tables[c] = (dc, ac)
    canonical (bits, values) of component c. Raises ValueError when the
    stream shape is outside kernel support."""
    if frame.is_progressive or frame.is_lossless or frame.precision != 8:
        raise ValueError("device entropy: baseline 8-bit only")
    R = frame.restart_interval
    if R <= 0:
        raise ValueError("device entropy: needs restart markers")
    if (len(frame.scans) != 1
            or len(frame.scans[0].comp_indices) != len(frame.components)):
        raise ValueError("device entropy: one interleaved scan only")
    if len(frame.components) == 1:
        c = frame.components[0]
        if c.h != 1 or c.v != 1:
            # T.81: single-component scans are non-interleaved (sampling
            # factors don't group blocks into MCUs)
            raise ValueError("device entropy: 1-comp scans need h=v=1")
    comp_map = []
    for ci, c in enumerate(frame.components):
        if c.h > 4 or c.v > 4:
            raise ValueError("device entropy: h/v factors <= 4 (T.81 B.2.2)")
        comp_map.extend([ci] * (c.h * c.v))
    scan = frame.scans[0]
    dc_tabs, ac_tabs = _build_tables(frame)
    tables = tuple(
        (dc_tabs[scan.dc_tables[ci]], ac_tabs[scan.ac_tables[ci]])
        for ci in range(len(frame.components))
    )
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    return (R, tuple(comp_map), tables, mcus_x * mcus_y)


def huffman_lut(spec, nbits: int) -> np.ndarray:
    """Direct lookup table over the next `nbits` stream bits for one
    canonical table (T.81 C.2): entry = length << 8 | symbol for codes of
    at most `nbits` bits, 0 where no such code starts."""
    bits, values = spec
    lut = np.zeros(1 << nbits, np.int16)
    code = k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if length <= nbits:
                lo = code << (nbits - length)
                lut[lo:lo + (1 << (nbits - length))] = (
                    (length << 8) | values[k])
            code += 1
            k += 1
        code <<= 1
    return lut


def kernel_tables(comp_map: tuple, tables: tuple):
    """(meta [bpm], lut12 [rows*4096], lut16 [rows*65536]) for one bucket.
    Each distinct table is one row of both LUTs; meta[b] packs, for block b
    of the MCU, comp | dc_row << 4 | ac_row << 8."""
    rows: list = []

    def row_of(spec):
        if spec not in rows:
            rows.append(spec)
        return rows.index(spec)

    meta = np.asarray(
        [c | row_of(tables[c][0]) << 4 | row_of(tables[c][1]) << 8
         for c in comp_map], np.int32)
    lut12 = np.concatenate([huffman_lut(s, _LUT_BITS) for s in rows])
    lut16 = np.concatenate([huffman_lut(s, 16) for s in rows])
    return meta, lut12, lut16


@functools.lru_cache(maxsize=32)
def _build_kernel(R: int, comp_map: tuple, tables: tuple, W: int, S: int,
                  interpret: bool):
    """Kernel for one bucket geometry: fn(words [W, S] uint32, seg_mcus [S]
    int32 MCUs per segment, 0 = padding lane) -> (coefficients [S, R*bpm,
    64] int16 in zigzag order, err [S] int32)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    bpm = len(comp_map)
    NBLK = R * bpm
    TL = LANE_TILE
    if S % TL:
        raise ValueError(f"lane count {S} is not a multiple of {TL}")
    meta_np, lut12_np, lut16_np = kernel_tables(comp_map, tables)
    u32 = jnp.uint32
    i32 = jnp.int32

    def kernel(words_ref, mcus_ref, meta_ref, lut12_ref, lut16_ref, _zeros,
               out_ref, err_ref):
        # every segment starts byte-aligned at words[0] with zero DC
        # predictors (T.81 F.2.1.3: predictors reset at a restart marker)
        lanes = (pl.program_id(0) * TL
                 + jax.lax.broadcasted_iota(i32, (TL,), 0))
        nblk = mcus_ref[lanes] * bpm
        zero = jnp.zeros((TL,), i32)

        def funnel(cur, nxt, p):
            pu = p.astype(u32)
            return (cur << pu) | ((nxt >> (u32(31) - pu)) >> u32(1))

        def body(carry):
            cur, nxt, p, wpos, blk, b, k, preds, err = carry
            active = (blk < nblk) & (err == 0)
            meta = meta_ref[b]
            comp = meta & 15
            is_dc = k == 0
            row = jnp.where(is_dc, (meta >> 4) & 15, meta >> 8)
            f = funnel(cur, nxt, p)
            e = lut12_ref[row * (1 << _LUT_BITS)
                          + (f >> u32(32 - _LUT_BITS)).astype(i32)]
            e = e.astype(i32)
            long = active & (e == 0)
            e2 = plt.load(
                lut16_ref.at[row * 65536 + (f >> u32(16)).astype(i32)],
                mask=long, other=0).astype(i32)
            e = jnp.where(long, e2, e)
            ln = e >> 8
            sym = e & 255
            t = jnp.where(is_dc, sym, sym & 15)  # magnitude category
            run = jnp.where(is_dc, 0, sym >> 4)
            bad = active & ((ln == 0) | (t > 15))
            # extra bits follow the code inside the same 32-bit window
            tu = jnp.clip(t, 1, 15).astype(u32)
            bits = ((f << ln.astype(u32)) >> (u32(32) - tu)).astype(i32)
            half = jnp.left_shift(1, tu.astype(i32) - 1)
            val = jnp.where(bits < half, bits - 2 * half + 1, bits)
            val = jnp.where(t == 0, 0, val)  # T.81 F.2.2.1 EXTEND
            is_eob = ~is_dc & (t == 0) & (run != 15)
            is_zrl = ~is_dc & (t == 0) & (run == 15)
            kk = k + run
            bad = bad | (active & ~is_dc & ~is_eob & ~is_zrl & (kk > 63))
            ok = active & ~bad
            pred = preds[0]
            for c in range(1, len(preds)):
                pred = jnp.where(comp == c, preds[c], pred)
            dc = pred + val
            preds = tuple(jnp.where(ok & is_dc & (comp == c), dc, preds[c])
                          for c in range(len(preds)))
            plt.store(
                out_ref.at[lanes, jnp.minimum(blk, NBLK - 1),
                           jnp.where(is_dc, 0, jnp.minimum(kk, 63))],
                jnp.where(is_dc, dc, val).astype(jnp.int16),
                mask=ok & (is_dc | (~is_eob & ~is_zrl)))
            k_next = jnp.where(is_dc, 1, jnp.where(
                is_eob, 64, jnp.where(is_zrl, k + 16, kk + 1)))
            done = ok & (k_next > 63)
            k = jnp.where(ok, jnp.where(done, 0, k_next), k)
            blk = jnp.where(done, blk + 1, blk)
            b = jnp.where(done, jnp.where(b + 1 == bpm, 0, b + 1), b)
            # consume code + extra bits; at most one word crosses
            p = p + jnp.where(ok, ln + t, 0)
            need = p >= 32
            fetched = plt.load(
                words_ref.at[jnp.minimum(wpos, W - 1), lanes],
                mask=need & (wpos < W), other=0)
            cur = jnp.where(need, nxt, cur)
            nxt = jnp.where(need, fetched, nxt)
            wpos = jnp.where(need, wpos + 1, wpos)
            p = jnp.where(need, p - 32, p)
            err = jnp.where(bad, 1, err)
            return cur, nxt, p, wpos, blk, b, k, preds, err

        def cond(carry):
            _, _, _, _, blk, _, _, _, err = carry
            return jnp.max(((blk < nblk) & (err == 0)).astype(i32)) > 0

        init = (words_ref[0, lanes], words_ref[1, lanes], zero, zero + 2,
                zero, zero, zero, (zero,) * len(tables), zero)
        carry = jax.lax.while_loop(cond, body, init)
        err_ref[lanes] = carry[-1]

    call = pl.pallas_call(
        kernel,
        grid=(S // TL,),
        out_shape=[
            jax.ShapeDtypeStruct((S, NBLK, 64), jnp.int16),
            jax.ShapeDtypeStruct((S,), jnp.int32),
        ],
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=TL // 32 or 1,
                                           num_stages=1),
        interpret=interpret,
        name="jpeg_huffman_segments",
    )

    def fn(words, seg_mcus):
        zeros = jnp.zeros((S, NBLK, 64), jnp.int16)
        return call(words, seg_mcus, meta_np, lut12_np, lut16_np, zeros)

    return fn


def decode_segments_device(frame, words: np.ndarray, seg_mcus: np.ndarray,
                           interpret: bool = False):
    """words: [W, S] uint32 column-packed destuffed segments; seg_mcus:
    [S] int32 MCUs per segment (0 = padding lane). Returns (coefs [S, NBLK,
    64] int16 zigzag, err [S] int32) as device arrays."""
    R, comp_map, tables, _total = entropy_kernel_spec(frame)
    W, S = words.shape
    fn = _build_kernel(R, comp_map, tables, W, S, interpret)
    return fn(words, seg_mcus)
