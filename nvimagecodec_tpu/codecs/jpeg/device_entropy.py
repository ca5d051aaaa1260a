"""Host glue for the on-device (Pallas) JPEG entropy decoder.

The host's only jobs: split each scan at its restart markers into the
column-major [W, S] word matrix (one native pass per image,
tic_jpeg_split_segments), and reassemble the kernel's lane-major
[S, NBLK, 64] block output into per-component [B, bh, bw, 64] stacks with
static reshapes/transposes that XLA fuses into the IDCT. Wire bytes: the
destuffed bitstream (~the compressed size) instead of coefficient planes.

Requirements (checked per bucket; anything else routes back to the host
entropy stage): baseline 8-bit single interleaved scan, restart interval a
multiple of the MCU-row width, h/v <= 4.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ...ops.pallas_entropy import entropy_kernel_spec
from .headers import JpegFrame


def device_entropy_key(frame: JpegFrame):
    """Extended bucket key: geometry + DRI + scan/table content (the kernel
    bakes the Huffman tables into its lookup tables)."""
    from .pixel import geometry_key

    try:
        R, comp_map, tables, total = entropy_kernel_spec(frame)
    except ValueError:
        return None
    mcus_x = -(-frame.width // (8 * frame.hmax))
    if R % mcus_x != 0:
        return None  # need whole-MCU-row segments for the static reassembly
    return (geometry_key(frame), R, comp_map, tables)


def device_entropy_plan(frame: JpegFrame):
    """(key, nsegs) for the on-device entropy decoder, or None when the
    stream must take the host path: segments are the restart intervals,
    byte-aligned, with DC predictors reset (T.81 §F.2.1.3). Memoized on
    the frame object — the batch router calls this per sample."""
    p = getattr(frame, "_de_plan", False)
    if p is not False:
        return p
    key = device_entropy_key(frame)
    p = None if key is None else (key, frame_segments(frame)[0])
    frame._de_plan = p
    return p


def frame_segments(frame: JpegFrame) -> Tuple[int, int]:
    """(nsegs, total_mcus) for one frame."""
    R = frame.restart_interval
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    total = mcus_x * mcus_y
    return -(-total // R), total


def split_batch_segments(frames: List[JpegFrame], raws: List[bytes],
                         max_words: int, lanes: Optional[int] = None,
                         words: Optional[np.ndarray] = None, first: int = 0,
                         seg_mcus: Optional[np.ndarray] = None):
    """Pack every sample's restart segments into one [W, S] uint32 column
    matrix (S = `lanes`, or B*nsegs rounded up to 128); sample i takes
    columns (first + i) * nsegs onwards. Returns (words, seg_mcus, nsegs,
    bad) — bad is the list of sample positions whose scan did not split
    into the expected segment count (host-path fallback) — or None if a
    segment exceeds max_words (caller grows and retries). `words` may be a
    recycled buffer (stale pad columns are dead lanes) and `seg_mcus` a
    shared [S] array that several threads fill for disjoint samples."""
    from ...native import lib

    L = lib()
    f0 = frames[0]
    R = f0.restart_interval
    nsegs, total = frame_segments(f0)
    B = len(frames)
    S = lanes if lanes is not None else -((-B * nsegs) // 128) * 128
    if words is None:
        words = np.zeros((max_words, S), np.uint32)
    if seg_mcus is None:
        seg_mcus = np.zeros(S, np.int32)
    bad: List[int] = []
    for i, (fr, raw) in enumerate(zip(frames, raws)):
        scan = fr.scans[0]
        data = raw[scan.data_start:scan.data_end]
        col = (first + i) * nsegs
        n = L.tic_jpeg_split_segments(
            data, len(data),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            S, col, nsegs, max_words,
        )
        if n == -1:
            return None  # capacity: caller retries with a larger max_words
        if n != nsegs:
            bad.append(i)  # malformed restart structure: host path
            seg_mcus[col:col + nsegs] = 0
            continue
        seg_mcus[col:col + nsegs] = R
        seg_mcus[col + nsegs - 1] = total - (nsegs - 1) * R
    return words, seg_mcus, nsegs, bad


def reassemble_components(xp, out, frame: JpegFrame, B: int, nsegs: int):
    """[S, NBLK, 64] kernel output → per-component [B, bh, bw, 64] zigzag
    stacks via static reshapes (runs inside the pixel jit)."""
    R = frame.restart_interval
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    rows_per_seg = R // mcus_x
    bpm = sum(c.h * c.v for c in frame.components)
    x = out[:B * nsegs].reshape(B, nsegs, rows_per_seg, mcus_x, bpm, 64)
    coefs = []
    off = 0
    for c in frame.components:
        nb = c.h * c.v
        xc = x[:, :, :, :, off:off + nb]  # [B, nsegs, rps, mx, v*h, 64]
        off += nb
        xc = xc.reshape(B, nsegs, rows_per_seg, mcus_x, c.v, c.h, 64)
        # → [B, nsegs, rps, v, mx, h, 64]
        xc = xp.transpose(xc, (0, 1, 2, 4, 3, 5, 6))
        xc = xc.reshape(B, nsegs * rows_per_seg * c.v, mcus_x * c.h, 64)
        coefs.append(xc[:, :mcus_y * c.v])  # drop short-segment padding rows
    return coefs
