"""Region-of-interest JPEG decode: entropy-skip + windowed pixel stage.

Counterpart of nvjpeg's ROI decode
(reference: extensions/nvjpeg/cuda_decoder.cpp:460-520 — region handling via
nvjpegDecodeParamsSetROI). The native entropy stage materializes only the MCU
rows covering the region (rows above are Huffman-tracked for DC predictors
only; rows below are never read; pre-ROI restart segments are skipped by
marker scan, see native/jpeg_entropy.cpp tic_jpeg_decode_coefficients_roi_into),
and the pixel stage (dequant/IDCT/upsample/color) runs on just the covering
MCU window — so wall-clock scales with region area, unlike decode-then-crop.

A one-MCU margin around the window keeps fancy chroma upsampling's neighbor
reads interior, making ROI output bit-identical to cropping a full decode.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import numpy as np

from .headers import JpegFrame
from .pixel import decode_pixels

# Work counters from the most recent ROI decode (testing/observability):
# how many MCU rows/cols were materialized vs the full frame. Timing-free
# proxy for "ROI skipped the work outside the region".
LAST_STATS: dict = {}


def _decode_coefficients_roi(frame: JpegFrame, data: bytes,
                             mcu_y0: int, mcu_y1: int) -> List[np.ndarray]:
    """Native entropy decode materializing only MCU rows [mcu_y0, mcu_y1)."""
    from ...native import c_i16p, lib

    L = lib()
    mcus_x, mcus_y, dims = frame.mcu_geometry()
    ncomp = len(frame.components)
    slots = [np.empty((bh, bw, 64), dtype=np.int16) for bw, bh in dims]
    bufs = (c_i16p * 4)()
    bw = (ctypes.c_int32 * 4)()
    bh = (ctypes.c_int32 * 4)()
    for c, s in enumerate(slots):
        bufs[c] = s.ctypes.data_as(c_i16p)
        bh[c], bw[c] = s.shape[0], s.shape[1]
    rc = L.tic_jpeg_decode_coefficients_roi_into(
        data, len(data), bufs,
        ctypes.cast(bw, ctypes.POINTER(ctypes.c_int32)),
        ctypes.cast(bh, ctypes.POINTER(ctypes.c_int32)),
        ncomp, mcu_y0, mcu_y1,
    )
    if rc != 0:
        raise ValueError(f"native ROI entropy decode failed (rc={rc})")
    return slots


def decode_pixels_roi(frame: JpegFrame, data: bytes, region,
                      use_jax: bool = False, fancy: bool = True,
                      bitexact: bool = False):
    """Decode exactly `region` (end-exclusive, already validated against the
    frame dims). Returns the region-sized image; raises on unsupported
    streams so the caller can fall back to full decode + crop."""
    if frame.is_lossless:
        raise ValueError("ROI decode: lossless JPEG unsupported")
    y0, x0 = int(region.start_y), int(region.start_x)
    y1, x1 = int(region.end_y), int(region.end_x)
    if not (0 <= y0 < y1 <= frame.height and 0 <= x0 < x1 <= frame.width):
        raise ValueError("ROI outside image bounds")

    mcu_w, mcu_h = 8 * frame.hmax, 8 * frame.vmax
    mcus_x, mcus_y, dims = frame.mcu_geometry()
    # Covering MCU window, +1 MCU margin so fancy upsampling's neighbor taps
    # stay interior (window-edge pixels then equal full-decode pixels).
    my0 = max(y0 // mcu_h - 1, 0)
    my1 = min(-(-y1 // mcu_h) + 1, mcus_y)
    mx0 = max(x0 // mcu_w - 1, 0)
    mx1 = min(-(-x1 // mcu_w) + 1, mcus_x)

    LAST_STATS.clear()
    LAST_STATS.update(
        mcu_rows_total=mcus_y, mcu_rows_materialized=my1 - my0,
        mcu_cols_total=mcus_x, mcu_cols_materialized=mx1 - mx0,
    )
    coefs = _decode_coefficients_roi(frame, bytes(data), my0, my1)
    subs = []
    for coef, comp in zip(coefs, frame.components):
        sub = coef[my0 * comp.v : my1 * comp.v, mx0 * comp.h : mx1 * comp.h]
        subs.append(np.ascontiguousarray(sub))

    win_w = min(mx1 * mcu_w, frame.width) - mx0 * mcu_w
    win_h = min(my1 * mcu_h, frame.height) - my0 * mcu_h
    subframe = dataclasses.replace(frame, width=win_w, height=win_h)
    img = decode_pixels(subframe, subs, use_jax=use_jax, fancy=fancy,
                        bitexact=bitexact)
    oy, ox = y0 - my0 * mcu_h, x0 - mx0 * mcu_w
    out = img[oy : oy + (y1 - y0), ox : ox + (x1 - x0)]
    if isinstance(out, np.ndarray):
        out = np.ascontiguousarray(out)
    return out
