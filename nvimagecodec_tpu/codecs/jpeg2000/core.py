"""JPEG2000 encode/decode pipelines.

Hybrid split mirroring the JPEG codec: the bit-serial EBCOT Tier-1 runs on
the host (native C++, fanned over a thread pool per codeblock — the analog
of the reference's per-tile resource pool,
extensions/nvjpeg2k/cuda_decoder.cpp:601-640), while dequantization,
inverse DWT, inverse MCT and level shift are vectorized array ops that run
under numpy (host) or jax (device).

All part-1 code-block styles are handled natively (see native/j2k_t1.cpp).
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...ops import dwt as dwt_ops
from .codestream import (
    COD,
    EOC,
    QCD,
    SIZ,
    SOC,
    SOD,
    SOT,
    Band,
    CodingParams,
    HeaderBitReader,
    Resolution,
    SizInfo,
    build_resolutions,
    cblk_grid,
    cblk_grid_precinct,
    ceil_div,
    iter_tile_parts,
    parse_main_header,
    precinct_count,
    precinct_rect,
    progression_iter,
    unwrap_jp2,
    wrap_jp2,
    write_cod,
    write_qcd,
    write_siz,
)
from .codestream import write_cap
from .codestream import RGN
from .codestream import _seg as _marker_seg
from .t1_bridge import (BlockBatch, EncodeBatch, ht_decode, ht_encode,
                        idwt53, t1_decode, t1_encode)
from .t2 import (PacketDecoder, PacketEncoder, plan_layers, plan_layers_ht,
                 plan_layers_seg, seg_pass_groups)

_PROG_LRCP, _PROG_RLCP, _PROG_RPCL, _PROG_PCRL, _PROG_CPRL = range(5)
_PROG_NAMES = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def _band_order(cp: CodingParams) -> List[Tuple[int, int]]:
    """QCD band order: LL, then (HL, LH, HH) per resolution 1..levels —
    (resolution, band_index_within_resolution)."""
    order = [(0, 0)]
    for r in range(1, cp.levels + 1):
        for bi in range(3):
            order.append((r, bi))
    return order


# ------------------------------------------------------------- quantization
def _synth_gain(band: Band) -> float:
    """Approximate L2 synthesis gain of a 9/7 band (level & orientation)."""
    base = 2.0 ** (band.lev - 1)
    orient = {0: 2.0, 1: 1.0, 2: 1.0, 3: 0.5}[band.btype]
    return base * orient


_MSE_GAIN_CACHE: Dict[Tuple[int, int, int], float] = {}


def _band_mse_gain(levels: int, r: int, bi: int) -> float:
    """Squared L2 synthesis gain of one 9/7 coefficient of band (r, bi):
    pixel-domain energy of a unit coefficient impulse (numeric estimate,
    cached per levels config). Lets the rate allocator convert per-band
    quantization error into decoded-pixel MSE without re-encoding — the
    single-pass analog of nvjpeg2k's native rate allocator
    (reference: extensions/nvjpeg2k/cuda_encoder.cpp target_psnr)."""
    key = (levels, r, bi)
    g = _MSE_GAIN_CACHE.get(key)
    if g is not None:
        return g
    N = 1 << max(6, levels + 4)
    res = build_resolutions(0, 0, N, N, levels)
    LL = np.zeros((res[0].bands[0].h, res[0].bands[0].w))
    bands_f = []
    for lev in range(1, levels + 1):
        rr = levels - lev + 1
        bs = res[rr].bands
        bands_f.append(tuple(np.zeros((b.h, b.w)) for b in bs))
    if r == 0:
        LL[LL.shape[0] // 2, LL.shape[1] // 2] = 1.0
    else:
        tgt = bands_f[levels - r][bi]
        tgt[tgt.shape[0] // 2, tgt.shape[1] // 2] = 1.0
    px = dwt_ops.idwt2d(LL, bands_f, (N, N), False)
    g = float(np.sum(px * px))
    _MSE_GAIN_CACHE[key] = g
    return g


def _rate_control_base_delta(coeffs, border, resolutions0, levels: int,
                             depth: int, mct: bool, C: int,
                             target_psnr: float, npix: int) -> float:
    """Choose the base quantizer step so the ESTIMATED decoded PSNR hits
    target_psnr — one DWT-domain bisection instead of decode-measure-
    re-encode loops. coeffs: [(c, (r, bi), float array)] over all tiles.
    The estimate models the decoder's midpoint reconstruction
    ((q + 0.5)Δ) per nonzero coefficient and propagates band error to
    pixel MSE via the numeric synthesis gains (independent-error model;
    inverse-ICT row norms weight the channels)."""
    peak = float((1 << depth) - 1)
    target_mse = peak * peak / (10.0 ** (target_psnr / 10.0))
    if mct and C == 3:
        # inverse-ICT row norms: one unit of Y error reaches all three RGB
        # channels (3x), Cb reaches G+B, Cr reaches R+G; MSE is then taken
        # over all H*W*C output samples
        wc = (3.0,
              0.344136 ** 2 + 1.772 ** 2,
              1.402 ** 2 + 0.714136 ** 2)
    else:
        wc = (1.0,) * C
    gains = {(r, bi): _band_mse_gain(levels, r, bi) for (r, bi) in border}
    sg = {(r, bi): _synth_gain(resolutions0[r].bands[bi])
          for (r, bi) in border}

    def est_mse(s: float) -> float:
        tot = 0.0
        for c, (r, bi), arr in coeffs:
            d = max(1e-9, s / sg[(r, bi)])
            a = np.abs(arr).ravel()
            q = np.floor(a / d)
            err = np.where(q > 0.0, a - (q + 0.5) * d, a)
            tot += float(np.dot(err, err)) * gains[(r, bi)] * wc[c]
        return tot / max(1, npix)

    lo, hi = peak * 1e-5, peak * 4.0
    if est_mse(lo) >= target_mse:
        return lo
    if est_mse(hi) <= target_mse:
        return hi
    for _ in range(20):
        mid = math.sqrt(lo * hi)
        if est_mse(mid) > target_mse:
            hi = mid
        else:
            lo = mid
    return math.sqrt(lo * hi)


def _delta_to_eps_mu(delta: float, rb: int) -> Tuple[int, int]:
    """Δ = 2^(rb - eps) * (1 + mu / 2^11)  →  (eps, mu)."""
    e = math.floor(math.log2(delta))
    eps = rb - e
    mu = int(round((delta / (2.0 ** e) - 1.0) * 2048))
    if mu >= 2048:
        mu = 0
        eps -= 1
    eps = max(0, min(31, eps))
    return eps, max(0, min(2047, mu))


def _eps_mu_to_delta(eps: int, mu: int, rb: int) -> float:
    return (2.0 ** (rb - eps)) * (1.0 + mu / 2048.0)


def quality_to_base_delta(quality: float, depth: int) -> float:
    """Map quality 1-100 to a base quantizer step (pixel-value units) for
    the finest bands; 95 ≈ half an 8-bit code value (near-lossless), and Δ
    roughly doubles every -10 quality. Scaled for higher bit depths."""
    quality = min(100.0, max(1.0, quality))
    return 0.5 * (2.0 ** ((95.0 - quality) / 10.0)) * (1 << (depth - 8))


def _ht_encode_or_skip(sub: np.ndarray, npasses: int = 1):
    """All-zero HT blocks stay not-included (like the EBCOT path) instead
    of paying a 3-byte cleanup segment."""
    if not sub.any():
        return (b"", b"", 1, 0)
    return ht_encode(sub, npasses)


# ------------------------------------------------------------------ encode
def encode_j2k(
    img: np.ndarray,
    reversible: bool = True,
    levels: int = 5,
    quality: float = 100.0,
    tile_size: Optional[int] = None,
    cblk: Tuple[int, int] = (64, 64),
    stream_type: str = "jp2",
    num_threads: int = 0,
    num_layers: int = 1,
    prog_order: str = "LRCP",
    precincts=None,
    ht: bool = False,
    per_comp=None,
    target_psnr: float = None,
    sub=None,
    size=None,
    colorspace: str = None,
    grid_offset: Tuple[int, int] = (0, 0),
    roi: Optional[Tuple[int, int, int, int]] = None,
    mode_switches: int = 0,
) -> bytes:
    """Encode [H, W] or [H, W, C] u8/u16 → JP2/J2K bytes.

    num_layers: quality layers — each code-block's coding passes split across
    layers with the codeword segment bytes divided at the matching points
    (reference: nvjpeg2k num_layers, extensions/nvjpeg2k/cuda_encoder.cpp:272-474).
    prog_order: any of LRCP/RLCP/RPCL/PCRL/CPRL (honest precinct-position
    iteration per T.800 B.12, not a collapse).
    precincts: None, a single (PPx, PPy) exponent pair for all resolutions,
    or a per-resolution list (T.800 A-21; PPx/PPy >= 1 above resolution 0).
    ht: use the HT (T.814 / HTJ2K) block coder instead of EBCOT — the
    reference's "High Throughput JPEG2000" (README.md:38, decoded by
    nvjpeg2k in extensions/nvjpeg2k/cuda_decoder.cpp:178). Emits the CAP
    marker (Pcap bit 15), Rsiz 0x4000, SPcod style 0x40; lossless for
    reversible (single cleanup pass carries all magnitude planes).
    ht=3 emits all three HT passes (cleanup at p=1 + SigProp + MagRef) —
    near-lossless (samples whose magnitude lies entirely below plane 1 and
    that SigProp cannot reach are dropped, an inherent T.814 property);
    used to exercise decoder conformance on refinement passes.
    per_comp: {comp: {"cblk": (w, h), "eps_shift": int}} — emit COC (code
    block size) / QCC (quant exponent shift, reversible only) markers for
    those components (T.800 A.6.2/A.6.5; the reference parses these in
    src/parsers/jpeg2k.cpp:280-356 and nvjpeg2k decodes them natively).
    target_psnr: single-pass rate control (irreversible only) — the base
    quantizer step is chosen by a DWT-domain distortion estimate so the
    decoded PSNR hits the target with ONE T1 encode, like nvjpeg2k's
    native rate allocator; overrides `quality`.

    Signed input (i8/i16) encodes with the SIZ sign bit and no DC level
    shift (T.800 G.1). Subsampled components (T.800 A.5.1, e.g. planar
    YUV 420): pass `img` as a LIST of per-component planes plus
    sub=[(dx, dy)] per component (plane c sized ceil(H/dy) x ceil(W/dx))
    and, when the full grid is not dx*plane dims (odd sizes), size=(H, W).
    MCT is disabled for planar input (the planes are already in their
    target colorspace)."""
    planes_in = None
    if isinstance(img, (list, tuple)):
        planes_in = [np.asarray(p) for p in img]
        C = len(planes_in)
        sub = [(int(dx), int(dy)) for dx, dy in
               (sub or [(1, 1)] * C)]
        if size is not None:
            H, W = int(size[0]), int(size[1])
        else:
            H = planes_in[0].shape[0] * sub[0][1]
            W = planes_in[0].shape[1] * sub[0][0]
        for c, p in enumerate(planes_in):
            need = (ceil_div(H, sub[c][1]), ceil_div(W, sub[c][0]))
            if p.shape != need:
                raise ValueError(f"J2K: plane {c} is {p.shape}, want {need}")
        dtype0 = planes_in[0].dtype
    else:
        if img.ndim == 2:
            img = img[:, :, None]
        H, W, C = img.shape
        sub = [(1, 1)] * C
        dtype0 = img.dtype
    signed = dtype0 in (np.int8, np.int16)
    depth = 16 if dtype0 in (np.uint16, np.int16) else 8
    min_dim = min(min(ceil_div(H, dy), ceil_div(W, dx)) for dx, dy in sub)
    levels = max(0, min(levels, max(1, int(math.log2(max(1, min_dim)))) - 1))
    subsampled = any(s != (1, 1) for s in sub)
    if subsampled and target_psnr is not None:
        raise ValueError("J2K: target_psnr with subsampling not supported")
    if isinstance(precincts, tuple):
        precincts = [precincts] * (levels + 1)
    if precincts is not None:
        precincts = list(precincts)
        if len(precincts) < levels + 1:
            precincts = precincts + [precincts[-1]] * (levels + 1 - len(precincts))
        for r, (px, py) in enumerate(precincts):
            if not (0 <= px <= 15 and 0 <= py <= 15):
                raise ValueError("precinct exponents must be in [0, 15]")
            if r > 0 and (px < 1 or py < 1):
                raise ValueError("PPx/PPy must be >= 1 above resolution 0")

    # grid_offset = (XOsiz, YOsiz): pixels live on reference-grid
    # [ox, ox+W) x [oy, oy+H); the tile grid stays anchored at (0, 0)
    # (T.800 B.3 requires XTOsiz <= XOsiz), so offset images naturally get
    # odd-origin interior tiles — the DWT takes per-level parity from the
    # absolute tile-component origins (ops/dwt.py).
    ox, oy = grid_offset
    if (ox < 0 or oy < 0) or (ox or oy) and subsampled:
        raise ValueError("grid_offset must be >= 0 and is unsupported with "
                         "subsampled components")
    siz = SizInfo(
        width=ox + W, height=oy + H, x0=ox, y0=oy,
        tile_w=tile_size or ox + W, tile_h=tile_size or oy + H,
        tx0=0, ty0=0, ncomp=C,
        depth=[depth] * C, signed=[signed] * C,
        sub_x=[s[0] for s in sub], sub_y=[s[1] for s in sub],
    )
    if tile_size and subsampled and any(
            tile_size % (2 * s) for s in siz.sub_x + siz.sub_y):
        raise ValueError("J2K: tile_size must be a multiple of 2*subsampling")

    cp = CodingParams(
        levels=levels,
        reversible=reversible,
        mct=(C == 3 and planes_in is None),
        cblk_w=cblk[0],
        cblk_h=cblk[1],
        prog_order=_PROG_NAMES.get(str(prog_order).upper(), 0)
        if isinstance(prog_order, str) else int(prog_order),
        num_layers=max(1, int(num_layers)),
        cblk_style=(0x40 if ht else (mode_switches & 0x2F)),
        precincts=precincts,
        qcd_style=0 if reversible else 2,
        guard_bits=2,
    )

    import dataclasses as _dc

    for c, spec in (per_comp or {}).items():
        o = _dc.replace(cp, precincts=list(precincts) if precincts else None,
                        band_q=[], comp_overrides={})
        if "cblk" in spec:
            o.cblk_w, o.cblk_h = spec["cblk"]
        cp.comp_overrides[int(c)] = o

    border = _band_order(cp)
    base_delta = quality_to_base_delta(quality, depth)
    rate_ctl = target_psnr is not None and not reversible

    # ---- phase 1: DWT + quantize every tile, track per-band magnitude
    # maxima so Mb (eps + guard - 1) provably bounds every code-block's
    # bitplane count (a zero-bitplane clamp would corrupt the stream).
    # With target_psnr the quantization is deferred: the rate allocator
    # needs the unquantized coefficients of every tile first.
    deltas: Dict[Tuple[int, int], float] = {}
    eps_mu: Dict[Tuple[int, int], Tuple[int, int]] = {}
    ref_res = build_resolutions(0, 0, siz.tile_w, siz.tile_h, levels)

    def _set_deltas(bd: float) -> None:
        for (r, bi) in border:
            band = ref_res[r].bands[bi]
            rb = depth + band.gain
            delta = max(1e-9, bd / _synth_gain(band))
            eps, mu = _delta_to_eps_mu(delta, rb)
            eps_mu[(r, bi)] = (eps, mu)
            deltas[(r, bi)] = _eps_mu_to_delta(eps, mu, rb)

    if not reversible and not rate_ctl:
        _set_deltas(base_delta)

    ntiles = siz.tiles_x * siz.tiles_y
    tile_banddata = []  # per tile: ({c: [Resolution]}, {(c,r,bi): array})
    max_nbps: Dict[Tuple[int, int], int] = {k: 0 for k in border}
    shift0 = 0 if signed else 1 << (depth - 1)
    for t in range(ntiles):
        tx0, ty0, tx1, ty1 = siz.tile_rect(t)
        if planes_in is None:
            tile_img = img[ty0 - oy:ty1 - oy, tx0 - ox:tx1 - ox].astype(
                np.int32)
            planes = [tile_img[:, :, c] - shift0 for c in range(C)]
        else:
            planes = []
            for c in range(C):
                dx, dy = sub[c]
                planes.append(planes_in[c][
                    ceil_div(ty0, dy):ceil_div(ty1, dy),
                    ceil_div(tx0, dx):ceil_div(tx1, dx)].astype(np.int32)
                    - shift0)
        if cp.mct:
            r_, g_, b_ = planes
            if reversible:  # RCT (T.800 G.2)
                y = (r_ + 2 * g_ + b_) >> 2
                cb = b_ - g_
                cr = r_ - g_
                planes = [y, cb, cr]
            else:  # ICT
                rf, gf, bf = (p.astype(np.float64) for p in planes)
                y = 0.299 * rf + 0.587 * gf + 0.114 * bf
                cb = -0.168736 * rf - 0.331264 * gf + 0.5 * bf
                cr = 0.5 * rf - 0.418688 * gf - 0.081312 * bf
                planes = [y, cb, cr]
        if not reversible:
            planes = [p.astype(np.float64) for p in planes]

        res_by_c = {
            c: build_resolutions(ceil_div(tx0, sub[c][0]),
                                 ceil_div(ty0, sub[c][1]),
                                 ceil_div(tx1, sub[c][0]),
                                 ceil_div(ty1, sub[c][1]), levels)
            for c in range(C)
        }
        arrays: Dict[Tuple[int, int, int], np.ndarray] = {}
        for c in range(C):
            corigin = (ceil_div(ty0, sub[c][1]), ceil_div(tx0, sub[c][0]))
            if reversible:
                # native forward 5/3 (native/j2k_idwt.cpp tic_fdwt53),
                # bit-identical to dwt_ops.dwt2d
                from .t1_bridge import fdwt53

                LL, bands_f = fdwt53(
                    np.ascontiguousarray(planes[c], np.int32), levels,
                    corigin)
            else:
                LL, bands_f = dwt_ops.dwt2d(
                    planes[c], levels, reversible, origin=corigin)
            band_arrays: Dict[Tuple[int, int], np.ndarray] = {(0, 0): LL}
            for r in range(1, levels + 1):
                lev = levels - r + 1
                HL, LH, HH = bands_f[lev - 1]
                band_arrays[(r, 0)] = HL
                band_arrays[(r, 1)] = LH
                band_arrays[(r, 2)] = HH
            for (r, bi) in border:
                band = res_by_c[c][r].bands[bi]
                arr = band_arrays[(r, bi)]
                assert arr.shape == (band.h, band.w), (
                    arr.shape, band.h, band.w, r, bi)
                if rate_ctl:
                    arrays[(c, r, bi)] = arr  # float; quantized below
                    continue
                if not reversible:
                    d = deltas[(r, bi)]
                    arr = (np.sign(arr) * np.floor(np.abs(arr) / d)).astype(
                        np.int32
                    )
                else:
                    # fdwt53 already yields int32 — avoid a full-band copy
                    arr = np.asarray(arr, np.int32)
                arrays[(c, r, bi)] = arr
                # max |v| without materializing a |band| temp
                m = (max(int(arr.max()), -int(arr.min()))
                     if arr.size else 0)
                max_nbps[(r, bi)] = max(max_nbps[(r, bi)], m.bit_length())
        tile_banddata.append((res_by_c, arrays))

    if rate_ctl:
        coeffs = [(c, (r, bi), arr)
                  for (_res, arrays) in tile_banddata
                  for (c, r, bi), arr in arrays.items()]
        base_delta = _rate_control_base_delta(
            coeffs, border, ref_res, levels, depth, cp.mct and C == 3, C,
            float(target_psnr), H * W * C)
        _set_deltas(base_delta)
        for _res, arrays in tile_banddata:
            for (c, r, bi), arr in list(arrays.items()):
                d = deltas[(r, bi)]
                q = (np.sign(arr) * np.floor(np.abs(arr) / d)).astype(np.int32)
                arrays[(c, r, bi)] = q
                m = int(np.abs(q).max()) if q.size else 0
                max_nbps[(r, bi)] = max(max_nbps[(r, bi)], m.bit_length())

    # ---- ROI maxshift (T.800 H.1): scale ROI coefficients up by SPrgn so
    # their bitplanes sit strictly above every background plane; eps stays
    # at the background dynamic range and decoders add SPrgn back
    if roi is not None:
        if ntiles != 1 or rate_ctl or per_comp:
            raise ValueError("roi: single-tile, non-rate-controlled only")
        # s must exceed every background bitplane by ONE: decoders detect
        # ROI indices at magnitude >= 2^(s-1) (openjpeg's threshold; any
        # background coefficient reaches at most 2^max_nbps - 1)
        s_roi = max(max_nbps.values()) + 1 + (1 if ht else 0)
        ry0, rx0, ry1, rx1 = roi
        margin = 3 if reversible else 5  # 5/3 vs 9/7 synthesis support
        res_by_c0, arrays0 = tile_banddata[0]
        for (c, r, bi), arr in arrays0.items():
            band = res_by_c0[c][r].bands[bi]
            scale = levels - r + 1 if r > 0 else levels
            by0 = max(0, (ry0 >> scale) - margin - band.y0)
            bx0 = max(0, (rx0 >> scale) - margin - band.x0)
            by1 = min(band.h,
                      -(-ry1 // (1 << scale)) + margin - band.y0)
            bx1 = min(band.w,
                      -(-rx1 // (1 << scale)) + margin - band.x0)
            if by0 >= by1 or bx0 >= bx1:
                continue
            if max_nbps[(r, bi)] + s_roi > 30:
                raise ValueError("roi: shifted bitplanes exceed int32")
            arr[by0:by1, bx0:bx1] = arr[by0:by1, bx0:bx1] << s_roi
        cp.rgn = {c: s_roi for c in range(C)}

    # ---- choose QCD so Mb >= nbps everywhere (HT: Mb >= Umax = nbps + 1,
    # the magnitude-exponent bound of the T.814 cleanup pass)
    band_q: List[Tuple[int, int]] = []
    for (r, bi) in border:
        band = ref_res[r].bands[bi]
        rb = depth + band.gain
        need = max_nbps[(r, bi)] + (1 if ht else 0)
        if reversible:
            eps = max(rb, need - cp.guard_bits + 1)
            band_q.append((min(31, eps), 0))
        else:
            eps, mu = eps_mu[(r, bi)]
            if eps + cp.guard_bits - 1 < need:
                cp.guard_bits = min(7, need - eps + 1)
            band_q.append((eps, mu))
    cp.band_q = band_q
    for c, o in cp.comp_overrides.items():
        shift = int((per_comp or {}).get(c, {}).get("eps_shift", 0))
        if shift and not reversible:
            raise ValueError("eps_shift only supported for reversible")
        o.band_q = [(min(31, e + max(0, shift)), m) for (e, m) in band_q]
        o.qcd_style = cp.qcd_style
        o.guard_bits = cp.guard_bits

    # ---- phase 2: T1 encode + packet assembly (precinct- and layer-aware)
    tiles = []
    for t in range(ntiles):
        res_by_c, arrays = tile_banddata[t]
        penc = PacketEncoder(cp, res_by_c, C)
        tx0, ty0, _tx1, _ty1 = siz.tile_rect(t)
        ebatch = EncodeBatch(bool(ht), 3 if ht == 3 else 1)
        for c in range(C):
            for res in res_by_c[c]:
                r = res.r
                ppx, ppy = cp.pp(r)
                npx, npy = precinct_count(res, ppx, ppy)
                for p in range(npx * npy):
                    prect, _ = precinct_rect(res, ppx, ppy, p)
                    for bi, band in enumerate(res.bands):
                        arr = arrays[(c, r, bi)]
                        ccp = cp.for_comp(c)
                        _, _, blocks = cblk_grid_precinct(
                            band, r, ppx, ppy, prect, ccp.cblk_w, ccp.cblk_h
                        )
                        # RGN: decoders that bound zbps by the nominal Mb
                        # (openjpeg) need background blocks coded with at
                        # least SPrgn+1 planes so zbps stays below Mb
                        mbp = ((cp.rgn.get(c, 0) + 1)
                               if (cp.rgn and not ht) else 0)
                        sty = 0 if ht else (ccp.cblk_style & 0x2F)
                        for k, (bx0, by0, bx1, by1) in enumerate(blocks):
                            blk = arr[by0 - band.y0 : by1 - band.y0,
                                      bx0 - band.x0 : bx1 - band.x0]
                            ebatch.add((c, r, p, bi, k), blk, band.btype,
                                       min_bps=mbp, style=sty)
        results: Dict[Tuple[int, int, int, int], List] = {}
        for (c, r, p, bi, k), rv in ebatch.run(num_threads):
            results.setdefault((c, r, p, bi), []).append((k, rv))

        for (c, r, p, bi), rows in results.items():
            ccp = cp.for_comp(c)
            eps = ccp.band_q[border.index((r, bi))][0]
            mb = (eps + ccp.guard_bits - 1
                  + (cp.rgn.get(c, 0) if cp.rgn else 0))
            plan = []
            if ht:
                for k, (cup, ref, B, umax) in sorted(rows):
                    assert umax + B - 1 <= mb, (umax, B, mb, r, bi)
                    npasses = 1 if not ref else 3
                    plan.append(plan_layers_ht(cup, ref, npasses,
                                               mb - B if cup else 0,
                                               cp.num_layers))
            elif ccp.cblk_style & 0x05:
                # TERMALL/BYPASS: one terminated codeword segment per
                # native seg_end; pass counts per segment follow the
                # termination rule (must match the T2 reader's grouping)
                for k, (seg, nbps, npasses, ends) in sorted(rows):
                    assert nbps <= mb, (nbps, mb, r, bi)
                    if npasses <= 0:
                        plan.append(plan_layers(b"", 0, mb - nbps,
                                                cp.num_layers))
                        continue
                    groups = seg_pass_groups(ccp.cblk_style & 0x05,
                                             npasses)
                    assert len(ends) == len(groups), (ends, groups)
                    prev = 0
                    segl = []
                    for e_, g_ in zip(ends, groups):
                        segl.append((seg[prev:e_], g_))
                        prev = e_
                    plan.append(plan_layers_seg(segl, mb - nbps,
                                                cp.num_layers))
            else:
                for k, (seg, nbps, npasses) in sorted(rows):
                    assert nbps <= mb, (nbps, mb, r, bi)
                    plan.append(plan_layers(seg, npasses, mb - nbps,
                                            cp.num_layers))
            penc.set_plan(c, r, p, bi, plan)

        packets = [
            penc.write_packet(c, r, p, l)
            for (l, r, c, p) in progression_iter(cp, res_by_c, C, tx0, ty0,
                                                 sub=sub)
        ]
        tiles.append(b"".join(packets))

    # assemble codestream
    out = bytearray(struct.pack(">H", SOC))
    out += write_siz(siz, rsiz=0x4000 if ht else 0)
    if ht:
        out += write_cap(max(e + cp.guard_bits - 1 for e, _m in cp.band_q))
    out += write_cod(cp)
    out += write_qcd(cp)
    if cp.rgn:
        for c_, s_ in sorted(cp.rgn.items()):
            out += _marker_seg(RGN, bytes([c_, 0, s_]))
    from .codestream import write_coc, write_qcc

    for c, spec in (per_comp or {}).items():
        o = cp.comp_overrides[int(c)]
        if "cblk" in spec:
            out += write_coc(int(c), o, C)
        if spec.get("eps_shift"):
            out += write_qcc(int(c), o, C)
    for t, tdata in enumerate(tiles):
        lsot = 10
        psot = 2 + lsot + 2 + len(tdata)
        out += struct.pack(">HHHIBB", SOT, lsot, t, psot, 0, 1)
        out += struct.pack(">H", SOD)
        out += tdata
    out += struct.pack(">H", EOC)
    cs = bytes(out)
    if stream_type == "jp2":
        return wrap_jp2(cs, siz, colorspace)
    if stream_type == "jph":  # HTJ2K container brand (ISO 15444-15)
        return wrap_jp2(cs, siz, colorspace, brand=b"jph ")
    return cs


# ------------------------------------------------------------------ decode
def _seg_bytes(tdata: bytes, s):
    """Materialize one codeword segment: (off, len) ranges reference the
    tile data (the zero-copy representation read_packet produces)."""
    return tdata[s[0]:s[0] + s[1]] if type(s) is tuple else s


_H2D_RATE = [None]

_PLANE_POOL = [None]
_PLANE_POOL_LOCK = __import__("threading").Lock()


def _plane_pool() -> ThreadPoolExecutor:
    """Persistent executor for per-component IDWT fan-out (daemon threads;
    lives for the process — the tile loop runs at image rate, so per-call
    executor creation/joins were a measurable fixed cost)."""
    with _PLANE_POOL_LOCK:
        if _PLANE_POOL[0] is None:
            _PLANE_POOL[0] = ThreadPoolExecutor(
                max_workers=min(4, os.cpu_count() or 1),
                thread_name_prefix="j2k-plane")
        return _PLANE_POOL[0]


def _h2d_mb_per_s() -> float:
    """One-time probe of host→device bandwidth (device_put of a 4 MB host
    array). The J2K device pixel stage ships ~4 B/sample of subband
    coefficients up, which has to beat the host IDWT."""
    if _H2D_RATE[0] is None:
        import time as _t

        import jax

        a = np.arange(4_000_000, dtype=np.uint8)
        jax.block_until_ready(jax.device_put(a))  # settle the link
        t0 = _t.perf_counter()
        jax.block_until_ready(jax.device_put(a))
        dt = _t.perf_counter() - t0
        _H2D_RATE[0] = a.nbytes / 1e6 / max(dt, 1e-6)
    return _H2D_RATE[0]


def device_route_auto(npixels: int, reversible: bool) -> bool:
    """Crossover for the J2K device pixel stage (dequant/IDWT/MCT). On an
    NVIDIA H100 whose link probed 4.3 GB/s, a 1024x1024 5-level image took
    21 ms on the device route against 98 ms on the host for the
    irreversible 9/7 transform (numpy on the host), and 36 ms against
    33 ms for the reversible 5/3 one (native C++ IDWT on the host). So the
    device takes 9/7 tiles big enough to amortize dispatch, on a link that
    clears the ~1 GB/s break-even for 4 B/sample; 5/3 stays on the host.
    TIC_J2K_DEVICE=1/0 overrides."""
    env = os.environ.get("TIC_J2K_DEVICE")
    if env is not None:
        return env not in ("0", "false", "")
    import jax

    if jax.default_backend() == "cpu" or reversible:
        return False
    if npixels < 256 * 256:
        return False  # dispatch + transfer latency dominates small tiles
    return _h2d_mb_per_s() > 800.0


@functools.lru_cache(maxsize=64)
def _j2k_device_fn_flat(levels: int, reversible: bool, mct: bool, C: int,
                        th: int, tw: int, depth: int,
                        origin: Tuple[int, int], shapes: Tuple):
    """Single-transfer variant of _j2k_device_fn: every subband rides up in
    ONE flat host buffer (every transfer pays a fixed latency, and
    1 + 3*levels separate device_puts would add up). The jitted fn slices
    the flat buffer at static offsets and rebuilds the [C, h, w] stacks on
    device."""
    import jax
    import jax.numpy as jnp

    sizes = [int(np.prod(sh)) for sh in shapes]
    offs = np.cumsum([0] + sizes).tolist()
    inner = _j2k_device_fn(levels, reversible, mct, C, th, tw, depth,
                           origin)

    def fn(flat):
        leaves = [
            jnp.reshape(flat[offs[i]:offs[i + 1]], shapes[i])
            for i in range(len(shapes))
        ]
        LL = leaves[0]
        bands = tuple(
            tuple(leaves[1 + 3 * lev + bi] for bi in range(3))
            for lev in range(levels)
        )
        return inner._fun(LL, bands) if hasattr(inner, "_fun") else inner(
            LL, bands)

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _j2k_device_fn(levels: int, reversible: bool, mct: bool, C: int,
                   th: int, tw: int, depth: int,
                   origin: Tuple[int, int] = (0, 0)):
    """Jitted device pixel stage for one tile geometry: batched-over-
    components inverse DWT + inverse MCT + level shift + clip (the role of
    nvjpeg2k's GPU stages). Bands arrive stacked [C, h, w]."""
    import jax
    import jax.numpy as jnp

    def fn(LL, bands):
        plane = dwt_ops.idwt2d(LL, list(bands), (th, tw), reversible,
                               origin)
        planes = [plane[c] for c in range(C)]
        if mct and C == 3:
            y, cb_, cr = planes
            if reversible:
                g = y - ((cb_ + cr) >> 2)
                planes = [cr + g, g, cb_ + g]
            else:
                planes = [
                    y + 1.402 * cr,
                    y - 0.344136 * cb_ - 0.714136 * cr,
                    y + 1.772 * cb_,
                ]
        shift = 1 << (depth - 1)
        maxv = (1 << depth) - 1
        dtype = jnp.uint16 if depth > 8 else jnp.uint8
        outs = []
        for p in planes:
            if not reversible:
                p = jnp.round(p)
            outs.append(jnp.clip(p + shift, 0, maxv).astype(dtype))
        return jnp.stack(outs, axis=-1)

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _j2k_device_fn_tiles(levels: int, reversible: bool, mct: bool, C: int,
                         th: int, tw: int, depth: int, tiles_x: int,
                         tiles_y: int):
    """Jitted device stage for a UNIFORM tile grid: subbands stacked over a
    leading tile axis [T, C, h, w]; output assembled to the full image on
    device — the product-path realization of the tile-parallel design
    (the tile axis is what shards over the mesh "sp" axis)."""
    import jax
    import jax.numpy as jnp

    T = tiles_x * tiles_y

    def fn(LL, bands):
        lead = (T * C,)
        plane = dwt_ops.idwt2d(
            LL.reshape(lead + LL.shape[2:]),
            [tuple(b.reshape(lead + b.shape[2:]) for b in lvl) for lvl in bands],
            (th, tw), reversible,
        ).reshape(T, C, th, tw)
        if mct and C == 3:
            y, cb_, cr = plane[:, 0], plane[:, 1], plane[:, 2]
            if reversible:
                g = y - ((cb_ + cr) >> 2)
                plane = jnp.stack([cr + g, g, cb_ + g], axis=1)
            else:
                plane = jnp.stack(
                    [y + 1.402 * cr,
                     y - 0.344136 * cb_ - 0.714136 * cr,
                     y + 1.772 * cb_], axis=1)
        shift = 1 << (depth - 1)
        maxv = (1 << depth) - 1
        dtype = jnp.uint16 if depth > 8 else jnp.uint8
        if not reversible:
            plane = jnp.round(plane)
        tiles = jnp.clip(plane + shift, 0, maxv).astype(dtype)
        # [T, C, th, tw] → [ty, tx, C, th, tw] → [H, W, C]
        img = tiles.reshape(tiles_y, tiles_x, C, th, tw)
        img = jnp.transpose(img, (0, 3, 1, 4, 2))
        return img.reshape(tiles_y * th, tiles_x * tw, C)

    return jax.jit(fn)


def _decode_single_tile_sharded(LL, bands, shape, cp, C, depth, mesh):
    """Single-tile pixel stage with the finest inverse-DWT level's rows
    sharded over the mesh "sp" axis (ppermute halo exchange at the shard
    boundaries — ops/dwt.idwt2d_rows_sharded); MCT + level shift follow as
    sharded elementwise ops. Falls back to the replicated transform when
    the rows do not divide evenly."""
    import jax.numpy as jnp

    th, tw = shape
    plane = dwt_ops.idwt2d_rows_sharded(
        LL, [tuple(b for b in lvl) for lvl in bands], (th, tw),
        cp.reversible, mesh)
    if cp.mct and C == 3:
        y, cb_, cr = plane[0], plane[1], plane[2]
        if cp.reversible:
            g = y - ((cb_ + cr) >> 2)
            plane = jnp.stack([cr + g, g, cb_ + g])
        else:
            plane = jnp.stack(
                [y + 1.402 * cr,
                 y - 0.344136 * cb_ - 0.714136 * cr,
                 y + 1.772 * cb_])
    shift = 1 << (depth - 1)
    maxv = (1 << depth) - 1
    dtype = jnp.uint16 if depth > 8 else jnp.uint8
    if not cp.reversible:
        plane = jnp.round(plane)
    img = jnp.clip(plane + shift, 0, maxv).astype(dtype)
    return jnp.transpose(img, (1, 2, 0))


def _roi_needed_rect(r: int, levels: int, ay0: int, ax0: int, ay1: int,
                     ax1: int) -> Tuple[int, int, int, int]:
    """Band-coordinate rectangle of coefficients that can influence the
    absolute pixel rect [ay0,ay1)×[ax0,ax1): the rect mapped to the band's
    scale plus a synthesis-filter margin (M=8 covers the accumulated 5/3 and
    9/7 support at the band's own scale). Code-blocks outside it are never
    entropy-decoded (reference analog: nvjpeg2k ROI decode via
    nvjpeg2kDecodeTile region params)."""
    s = (1 << levels) if r == 0 else (1 << (levels - r + 1))
    M = 8
    return (ay0 // s - M, ax0 // s - M, -(-ay1 // s) + M, -(-ax1 // s) + M)


def decode_j2k(
    data: bytes,
    num_threads: int = 0,
    use_jax: Optional[bool] = False,
    discard_levels: int = 0,
    mesh=None,
    region=None,
    planar: bool = False,
) -> np.ndarray:
    """Decode JP2/J2K bytes → [H, W] or [H, W, C] u8/u16 (i8/i16 when the
    SIZ declares signed components — no DC level shift, T.800 G.1).

    Subsampled components (XRsiz/YRsiz > 1, T.800 A.5.1) decode natively:
    each component's tile-grid, resolutions and progression anchors live in
    its own component coordinates (the reference parses these in
    src/parsers/jpeg2k.cpp:280-356 and nvjpeg2k decodes them natively).
    With planar=True the per-component planes are returned exactly as coded
    (a list of [h_c, w_c] arrays); the default interleaved output replicates
    subsampled components onto the full reference grid.

    discard_levels > 0 reconstructs at a reduced resolution (the classic
    JPEG2000 multi-resolution decode): the top `discard_levels` resolutions'
    code-blocks are never entropy-decoded and the inverse DWT stops early,
    so a d-level discard costs roughly 4^-d of the full-pixel work.

    region (core.types.Region, full-resolution output coordinates, only with
    discard_levels=0): true ROI decode — tiles that do not intersect the
    region are skipped without parsing a packet, and within covering tiles
    only code-blocks whose DWT support can reach the region are
    entropy-decoded. Returns exactly the region. Bit-identical to cropping a
    full decode.

    mesh: optional jax.sharding.Mesh — a uniform tile grid shards its tile
    axis over "sp" (the distributed analog of the reference's tile pool,
    extensions/nvjpeg2k/cuda_decoder.cpp:601-640); a single-tile image
    shards its finest inverse-DWT rows over "sp" with ppermute halo
    exchange (ops/dwt.idwt2d_rows_sharded). Bit-exact for reversible."""
    cs = unwrap_jp2(bytes(data))
    siz, cp, pos = parse_main_header(cs, 0)
    if len(set(siz.depth)) > 1 or len(set(siz.signed)) > 1:
        raise ValueError("J2K: mixed component depth/signedness not supported")
    sub = list(zip(siz.sub_x, siz.sub_y))
    subsampled = any(s != (1, 1) for s in sub)
    signed = bool(siz.signed and siz.signed[0])
    # arbitrary (incl. odd) XOsiz/YOsiz/XTOsiz/YTOsiz and odd tile sizes
    # are handled: the DWT lifts take per-level parity from the absolute
    # tile-component origin (ops/dwt.py; T.800 F.3.4's 1D_SR on [i0, i1))
    def _expand_derived(q):
        # scalar derived: expand to per-band (eps decreases with level)
        if q.qcd_style == 1 and len(q.band_q) == 1:
            eps0, mu0 = q.band_q[0]
            q.band_q = []
            for (r, bi) in _band_order(q):
                lev = q.levels if r == 0 else q.levels - r + 1
                q.band_q.append((eps0 - q.levels + lev, mu0))

    _expand_derived(cp)
    for _o in cp.comp_overrides.values():
        _expand_derived(_o)

    C = siz.ncomp
    ccs = [cp.for_comp(c) for c in range(C)]
    uniform_cp = not cp.comp_overrides or all(
        (o.levels, o.reversible, o.cblk_w, o.cblk_h, o.cblk_style)
        == (cp.levels, cp.reversible, cp.cblk_w, cp.cblk_h, cp.cblk_style)
        for o in cp.comp_overrides.values())
    if discard_levels and not uniform_cp:
        raise ValueError(
            "J2K: discard_levels with per-component COC not supported")
    depth = siz.depth[0]
    if signed:
        dtype = np.int16 if depth > 8 else np.int8
    else:
        dtype = np.uint16 if depth > 8 else np.uint8
    discard_levels = max(0, min(discard_levels, cp.levels))
    keep_levels = cp.levels - discard_levels
    d = 1 << discard_levels
    out_h = ceil_div(siz.height, d) - ceil_div(siz.y0, d)
    out_w = ceil_div(siz.width, d) - ceil_div(siz.x0, d)
    # per-component reduced-grid divisors and output dims (component domain
    # ceil(v/dx) reduced by 2^discard: ceil-div composes to one divisor)
    fx = [sub[c][0] * d for c in range(C)]
    fy = [sub[c][1] * d for c in range(C)]
    co_h = [ceil_div(siz.height, fy[c]) - ceil_div(siz.y0, fy[c])
            for c in range(C)]
    co_w = [ceil_div(siz.width, fx[c]) - ceil_div(siz.x0, fx[c])
            for c in range(C)]

    # ROI: absolute codestream coordinates of the requested region
    roi = post_crop = None
    if region is not None and discard_levels == 0:
        ay0 = siz.y0 + int(region.start_y)
        ax0 = siz.x0 + int(region.start_x)
        ay1 = siz.y0 + int(region.end_y)
        ax1 = siz.x0 + int(region.end_x)
        if siz.y0 <= ay0 < ay1 <= siz.height and siz.x0 <= ax0 < ax1 <= siz.width:
            if subsampled:
                # component grids disagree with the region's full-grid
                # coordinates: decode full, crop the interleaved output
                post_crop = (ay0 - siz.y0, ax0 - siz.x0,
                             ay1 - siz.y0, ax1 - siz.x0)
            else:
                roi = (ay0, ax0, ay1, ax1)
    if subsampled:
        plane_out = [np.zeros((co_h[c], co_w[c]), dtype) for c in range(C)]
        out = None
    else:
        out = np.zeros(
            (roi[2] - roi[0], roi[3] - roi[1], C) if roi else (out_h, out_w, C),
            dtype,
        )

    border = _band_order(cp)

    if use_jax is None:
        # auto: measured crossover (H2D probe + tile size), see
        # device_route_auto
        use_jax = device_route_auto(siz.width * siz.height, cp.reversible)

    ntiles_total = siz.tiles_x * siz.tiles_y
    uniform_grid = (
        (use_jax or mesh is not None)
        and not cp.comp_overrides
        and not subsampled and not signed
        and discard_levels == 0
        and roi is None
        and ntiles_total > 1
        and siz.x0 == 0 and siz.y0 == 0 and siz.tx0 == 0 and siz.ty0 == 0
        and siz.width % siz.tile_w == 0
        and siz.height % siz.tile_h == 0
    )
    tile_stacks = {} if uniform_grid else None

    for tidx, tdata, ppt, tpoc in iter_tile_parts(cs, pos, ppm=cp.ppm):
        tcp = cp
        if tpoc is not None:
            # tile-part POC overrides the main-header POC for this tile
            # (T.800 A.6.6; openjpeg writes POC in the first tile-part)
            import dataclasses as _dc

            from .codestream import parse_poc_body

            tcp = _dc.replace(cp, poc=parse_poc_body(tpoc, siz.ncomp))
        tx0, ty0, tx1, ty1 = siz.tile_rect(tidx)
        if roi is not None and (
            tx1 <= roi[1] or tx0 >= roi[3] or ty1 <= roi[0] or ty0 >= roi[2]
        ):
            continue  # tile cannot touch the region: zero work
        # reduced-resolution tile rect (coordinates divide by 2^d)
        rx0, ry0 = ceil_div(tx0, d), ceil_div(ty0, d)
        rx1, ry1 = ceil_div(tx1, d), ceil_div(ty1, d)
        th, tw = ry1 - ry0, rx1 - rx0
        # per-component tile rects in component coordinates (T.800 B.3)
        tcr = [(ceil_div(tx0, sub[c][0]), ceil_div(ty0, sub[c][1]),
                ceil_div(tx1, sub[c][0]), ceil_div(ty1, sub[c][1]))
               for c in range(C)]
        tdims = [(ceil_div(tcr[c][3], d) - ceil_div(tcr[c][1], d),
                  ceil_div(tcr[c][2], d) - ceil_div(tcr[c][0], d))
                 for c in range(C)]
        resolutions = {c: build_resolutions(tcr[c][0], tcr[c][1],
                                            tcr[c][2], tcr[c][3],
                                            ccs[c].levels)
                       for c in range(C)}
        pdec = PacketDecoder(siz, cp, resolutions)
        if ppt is not None:
            import ctypes as _ct

            br = HeaderBitReader(ppt, 0)   # packed packet headers
            body_pos = _ct.c_int64(0)
            for l, r, c, p in progression_iter(tcp, resolutions, C, tx0,
                                               ty0, sub=sub):
                if br.pos > len(ppt):
                    raise ValueError("J2K: PPT headers exhausted")
                pdec.read_packet(br, c, r, l, p, body=tdata,
                                 body_pos=body_pos)
        else:
            br = HeaderBitReader(tdata, 0)
            for l, r, c, p in progression_iter(tcp, resolutions, C, tx0,
                                               ty0, sub=sub):
                if br.pos > len(tdata):
                    raise ValueError("J2K: tile data exhausted mid-packet")
                pdec.read_packet(br, c, r, l, p)

        # T1 decode all codeblocks in parallel, then dequant + IDWT
        planes = []
        batch = BlockBatch(base=tdata)
        borders = [_band_order(ccs[c]) for c in range(C)]
        kepts = [[(r, bi) for (r, bi) in borders[c]
                  if r <= ccs[c].levels - discard_levels]
                 for c in range(C)]
        # all-reversible tiles decode DIRECTLY into the int32 band arrays
        # (native strided writes, no per-block Python consume loop)
        all_rev = all(ccs[c].reversible for c in range(C))
        decoded: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {
            c: {} for c in range(C)
        }
        for c in range(C):
            for (r, bi) in kepts[c]:
                band = resolutions[c][r].bands[bi]
                fdtype = np.int32 if ccs[c].reversible else np.float64
                decoded[c][(r, bi)] = np.zeros((band.h, band.w), fdtype)
        dests = [] if all_rev else None
        for c in range(C):
            cc = ccs[c]
            border_c = borders[c]
            for (r, bi) in kepts[c]:
                band = resolutions[c][r].bands[bi]
                eps, mu = cc.band_q[border_c.index((r, bi))]
                mb = (eps + cc.guard_bits - 1
                      + (cp.rgn.get(c, 0) if cp.rgn else 0))
                need = (
                    _roi_needed_rect(r, cp.levels, *roi) if roi is not None
                    else None
                )
                for cb in pdec.band_cblks(c, r, bi):
                    if not cb.included or cb.num_passes == 0:
                        continue
                    if need is not None and (
                        cb.y1 <= need[0] or cb.x1 <= need[1]
                        or cb.y0 >= need[2] or cb.x0 >= need[3]
                    ):
                        continue  # outside the region's DWT support
                    if cc.cblk_style & 0x40:  # HT (T.814) block coder
                        # segments are (off, len) ranges into tdata
                        # (zero-copy) or bytes; pass ranges through
                        segs_ = cb.segments
                        cup = segs_[0] if segs_ else b""
                        if len(segs_) <= 1:
                            ref = b""
                        elif len(segs_) == 2:
                            ref = segs_[1]
                        else:
                            ref = b"".join(_seg_bytes(tdata, x)
                                           for x in segs_[1:])
                        batch.add_ht((c, r, bi, cb), cup, ref,
                                     cb.num_passes, cb.x1 - cb.x0,
                                     cb.y1 - cb.y0, mb - cb.zero_bps,
                                     cb.zero_bps + 1)
                    else:
                        sty = cc.cblk_style & 0x2F
                        if sty & 0x05:
                            # multi-segment blob the native decoder
                            # parses: [i32 nsegs][i32 lens...][data]
                            import struct as _st

                            segs = [_seg_bytes(tdata, x)
                                    for x in cb.segments] or [b""]
                            seg = (_st.pack(
                                f"<{1 + len(segs)}i", len(segs),
                                *[len(x) for x in segs])
                                + b"".join(segs))
                        elif len(cb.segments) == 1:
                            seg = cb.segments[0]
                        else:
                            seg = b"".join(_seg_bytes(tdata, x)
                                           for x in cb.segments)
                        nbps = max(0, mb - cb.zero_bps)
                        batch.add_t1((c, r, bi, cb), seg,
                                     cb.x1 - cb.x0, cb.y1 - cb.y0,
                                     band.btype, nbps, cb.num_passes,
                                     style=sty)
                    if dests is not None:
                        dests.append((decoded[c][(r, bi)],
                                      cb.y0 - band.y0, cb.x0 - band.x0))
        def _rgn_unshift(a, s_):
            # maxshift decode (T.800 H.2): coefficients whose magnitude
            # reaches the shifted planes are ROI; scale them back down
            mag = np.abs(a)
            hi = mag >= (1 << s_)
            return np.where(hi, np.sign(a) * (mag >> s_), a)

        if dests is not None:
            batch.run_into(dests, num_threads)
            if cp.rgn:
                for c in range(C):
                    s_ = cp.rgn.get(c, 0)
                    if not s_:
                        continue
                    for (r, bi) in kepts[c]:
                        a = decoded[c][(r, bi)]
                        a[...] = _rgn_unshift(a, s_)
        else:
            for (c, r, bi, cb), blk in batch.run(num_threads):
                band = resolutions[c][r].bands[bi]
                if cp.rgn and cp.rgn.get(c, 0):
                    blk = _rgn_unshift(blk, cp.rgn[c]).astype(np.int32)
                if not ccs[c].reversible:
                    eps, mu = ccs[c].band_q[borders[c].index((r, bi))]
                    rb = depth + band.gain
                    delta = _eps_mu_to_delta(eps, mu, rb)
                    mag = np.abs(blk).astype(np.float64)
                    rec = np.where(mag > 0, (mag + 0.5) * delta, 0.0)
                    blk = np.sign(blk) * rec
                decoded[c][(r, bi)][cb.y0 - band.y0 : cb.y1 - band.y0,
                                    cb.x0 - band.x0 : cb.x1 - band.x0] = blk

        if uniform_grid:
            cast = np.int32 if cp.reversible else np.float32
            LL = np.stack([decoded[c][(0, 0)] for c in range(C)]).astype(cast)
            bands_t = tuple(
                tuple(
                    np.stack(
                        [decoded[c][(cp.levels - lev + 1, bi)] for c in range(C)]
                    ).astype(cast)
                    for bi in range(3)
                )
                for lev in range(1, cp.levels + 1)
            )
            tile_stacks[tidx] = (LL, bands_t)
            continue

        ntiles = siz.tiles_x * siz.tiles_y
        if ((use_jax or mesh is not None) and ntiles == 1
                and not cp.comp_overrides
                and not subsampled and not signed
                and discard_levels == 0 and roi is None):
            # device pixel stage: all components' subbands stacked and run
            # through one jitted IDWT+MCT+shift call; output stays on device
            cast = np.int32 if cp.reversible else np.float32
            LL = np.stack([decoded[c][(0, 0)] for c in range(C)]).astype(cast)
            bands_t = tuple(
                tuple(
                    np.stack(
                        [decoded[c][(cp.levels - lev + 1, bi)] for c in range(C)]
                    ).astype(cast)
                    for bi in range(3)
                )
                for lev in range(1, cp.levels + 1)
            )
            torigin = (tcr[0][1], tcr[0][0])  # (tcy0, tcx0)
            if mesh is not None and cp.levels > 0 and torigin == (0, 0):
                # one tile's inverse DWT rows sharded over "sp" with
                # ppermute halo exchange (real spatial parallelism)
                img = _decode_single_tile_sharded(
                    LL, bands_t, (th, tw), cp, C, depth, mesh)
                return img[:, :, 0] if C == 1 else img
            # one flat H2D transfer for the whole subband pyramid
            leaves = [LL] + [b for lvl in bands_t for b in lvl]
            shapes = tuple(a.shape for a in leaves)
            flat = np.concatenate([a.ravel() for a in leaves])
            fn = _j2k_device_fn_flat(
                cp.levels, cp.reversible, cp.mct and C == 3, C, th, tw,
                depth, torigin, shapes
            )
            img = fn(flat)
            return img[:, :, 0] if C == 1 else img

        def _one_plane(c):
            cc = ccs[c]
            LL = decoded[c][(0, 0)]
            bands_f = []
            # with discard, the finest `discard_levels` decomposition levels
            # are dropped: lev runs over the COARSEST keep_levels ones
            for lev in range(discard_levels + 1, cc.levels + 1):
                r = cc.levels - lev + 1
                bands_f.append((decoded[c][(r, 0)], decoded[c][(r, 1)],
                                decoded[c][(r, 2)]))
            corigin = (ceil_div(tcr[c][1], d), ceil_div(tcr[c][0], d))
            if cc.reversible:
                # native multi-level 5/3 synthesis (bit-identical fast path)
                return idwt53(LL, bands_f, tdims[c], corigin)
            return dwt_ops.idwt2d(LL, bands_f, tdims[c], False,
                                  origin=corigin)

        if all_rev and C > 1 and num_threads != 1:
            # the native IDWT releases the GIL: run components in parallel
            # on a PERSISTENT pool (a fresh executor per tile cost ~1-2 ms
            # in thread start/join churn — measurable at 14 img/s)
            planes = list(_plane_pool().map(_one_plane, range(C)))
        else:
            planes = [_one_plane(c) for c in range(C)]

        # fused native epilogue (inverse RCT/shift + clamp + interleave in
        # one sweep) for the plain u8 reversible case
        if (all_rev and not subsampled and not signed and depth == 8
                and roi is None):
            from ...native import lib as _native_lib

            L = _native_lib()
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            oy0 = ry0 - ceil_div(siz.y0, d)
            ox0 = rx0 - ceil_div(siz.x0, d)
            if C == 3 and cp.mct and sub[0] == sub[1] == sub[2]:
                tile_u8 = np.empty((th, tw, 3), np.uint8)
                L.tic_j2k_rct_shift_u8(
                    planes[0].ctypes.data_as(i32p),
                    planes[1].ctypes.data_as(i32p),
                    planes[2].ctypes.data_as(i32p),
                    th * tw, tile_u8.ctypes.data_as(u8p))
                out[oy0:oy0 + th, ox0:ox0 + tw, :] = tile_u8
                continue
            if not cp.mct or C != 3:
                for c in range(C):
                    tile_u8 = np.empty((th, tw), np.uint8)
                    L.tic_j2k_shift_u8(
                        planes[c].ctypes.data_as(i32p), th * tw, 1,
                        tile_u8.ctypes.data_as(u8p))
                    out[oy0:oy0 + th, ox0:ox0 + tw, c] = tile_u8
                continue

        # inverse MCT + level shift (MCT needs equal component grids)
        if cp.mct and C == 3 and sub[0] == sub[1] == sub[2]:
            y, cb_, cr = planes
            if cp.reversible:  # inverse RCT
                g = y - ((cb_ + cr) >> 2)
                r_ = cr + g
                b_ = cb_ + g
            else:  # inverse ICT
                r_ = y + 1.402 * cr
                g = y - 0.344136 * cb_ - 0.714136 * cr
                b_ = y + 1.772 * cb_
            planes = [r_, g, b_]
        # signed components carry no DC level shift (T.800 G.1)
        shift = 0 if signed else 1 << (depth - 1)
        minv = -(1 << (depth - 1)) if signed else 0
        maxv = (1 << (depth - 1)) - 1 if signed else (1 << depth) - 1
        for c in range(C):
            p = planes[c]
            if not ccs[c].reversible:
                p = np.round(p)
            p = np.clip(p + shift, minv, maxv).astype(dtype)
            if subsampled:
                cy0 = ceil_div(ty0, fy[c]) - ceil_div(siz.y0, fy[c])
                cx0 = ceil_div(tx0, fx[c]) - ceil_div(siz.x0, fx[c])
                plane_out[c][cy0 : cy0 + tdims[c][0],
                             cx0 : cx0 + tdims[c][1]] = p
            elif roi is not None:
                iy0, ix0 = max(ty0, roi[0]), max(tx0, roi[1])
                iy1, ix1 = min(ty1, roi[2]), min(tx1, roi[3])
                out[iy0 - roi[0] : iy1 - roi[0],
                    ix0 - roi[1] : ix1 - roi[1], c] = (
                    p[iy0 - ty0 : iy1 - ty0, ix0 - tx0 : ix1 - tx0]
                )
            else:
                oy0 = ry0 - ceil_div(siz.y0, d)
                ox0 = rx0 - ceil_div(siz.x0, d)
                out[oy0 : oy0 + th, ox0 : ox0 + tw, c] = p

    if uniform_grid and len(tile_stacks) == ntiles_total:
        th_, tw_ = siz.tile_h, siz.tile_w
        LL_all = np.stack([tile_stacks[t][0] for t in range(ntiles_total)])
        bands_all = tuple(
            tuple(
                np.stack([tile_stacks[t][1][lvl][bi] for t in range(ntiles_total)])
                for bi in range(3)
            )
            for lvl in range(cp.levels)
        )
        if mesh is not None and ntiles_total % mesh.shape.get("sp", 1) == 0:
            # tile axis sharded over "sp": each chip reconstructs its own
            # tiles; XLA gathers the assembly from the output sharding
            # (reference analog: the per-tile resource pool,
            # extensions/nvjpeg2k/cuda_decoder.cpp:601-640)
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            shard = NamedSharding(mesh, P("sp"))
            LL_all = jax.device_put(LL_all, shard)
            bands_all = tuple(
                tuple(jax.device_put(b, shard) for b in lvl)
                for lvl in bands_all
            )
        fn = _j2k_device_fn_tiles(
            cp.levels, cp.reversible, cp.mct and C == 3, C, th_, tw_, depth,
            siz.tiles_x, siz.tiles_y,
        )
        img = fn(LL_all, bands_all)
        return img[:, :, 0] if C == 1 else img

    if subsampled:
        if planar:
            return plane_out
        # interleave on the full reference grid by sample replication
        # (comp sample at c-coord v covers grid columns [v*dx, (v+1)*dx))
        full = np.empty((out_h, out_w, C), dtype)
        for c in range(C):
            a = plane_out[c]
            if sub[c] != (1, 1):
                a = np.repeat(np.repeat(a, sub[c][1], 0), sub[c][0], 1)
                # component origin ceil(y0/fy)*sy may start below the
                # image origin row ceil(y0/d): edge-pad the gap
                py = ceil_div(siz.y0, fy[c]) * sub[c][1] - ceil_div(siz.y0, d)
                px = ceil_div(siz.x0, fx[c]) * sub[c][0] - ceil_div(siz.x0, d)
                if py or px:
                    a = np.pad(a, ((py, 0), (px, 0)), mode="edge")
                a = a[:out_h, :out_w]
                if a.shape != (out_h, out_w):
                    a = np.pad(a, ((0, out_h - a.shape[0]),
                                   (0, out_w - a.shape[1])), mode="edge")
            full[:, :, c] = a
        if post_crop is not None:
            full = full[post_crop[0] : post_crop[2],
                        post_crop[1] : post_crop[3]]
        return full[:, :, 0] if C == 1 else full

    if planar:
        return [out[:, :, c] for c in range(C)]
    return out[:, :, 0] if C == 1 else out
