"""Output sample-format / dtype conversion matrix.

Counterpart of the reference's convert kernels
(reference: src/imgproc/convert_kernel_gpu.cu:30-290 — the
layout × channel-order × dtype launch matrix — and src/imgproc/convert.h —
ConvertSatNorm semantics: integer↔integer rescaled by the ratio of full-scale
ranges, integer↔float normalized to [0,1] (unsigned) / [-1,1] (signed), with
saturation). Here the whole matrix is a handful of jnp/numpy expressions that
XLA fuses into the tail of the decode pixel stage instead of a templated CUDA
kernel per (src,dst) pair.

Layout conventions: interleaved = HWC, planar = CHW
(reference: NVIMGCODEC_SAMPLEFORMAT_P_* vs I_*, include/nvimgcodec.h:382-395).
"""
from __future__ import annotations

import numpy as np

from ..core.types import SampleDataType, SampleFormat

_UNSIGNED = {
    SampleDataType.UINT8: 255.0,
    SampleDataType.UINT16: 65535.0,
    SampleDataType.UINT32: 4294967295.0,
}
_SIGNED = {
    SampleDataType.INT8: 127.0,
    SampleDataType.INT16: 32767.0,
    SampleDataType.INT32: 2147483647.0,
}
_FLOAT = (SampleDataType.FLOAT16, SampleDataType.FLOAT32, SampleDataType.FLOAT64)


def _xp(arr):
    if isinstance(arr, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def _max_of(t: SampleDataType) -> float:
    if t in _UNSIGNED:
        return _UNSIGNED[t]
    if t in _SIGNED:
        return _SIGNED[t]
    return 1.0  # floats are normalized


def convert_dtype(arr, dst: SampleDataType):
    """Saturating-normalized dtype conversion
    (reference: ConvertSatNorm, src/imgproc/convert.h — "number in the
    [0..1] (or [-1..1]) range is mapped onto the full dynamic range of the
    target type"). Works on numpy or jax arrays; integer→integer upscale is
    exact (e.g. u8→u16 multiplies by 257)."""
    src = SampleDataType.from_numpy(arr.dtype)
    if src == dst:
        return arr
    xp = _xp(arr)
    dst_np = dst.numpy_dtype
    src_max, dst_max = _max_of(src), _max_of(dst)

    if src in _FLOAT:
        # float → int: clamp the normalized range, scale to full dst scale
        if dst in _FLOAT:
            return arr.astype(dst_np)
        lo = -1.0 if dst in _SIGNED else 0.0
        v = xp.clip(arr.astype(xp.float32), lo, 1.0) * dst_max
        return xp.round(v).astype(dst_np)

    if dst in _FLOAT:
        # int → float: normalize by the source full-scale
        return (arr.astype(xp.float32) / np.float32(src_max)).astype(dst_np)

    # int → int: rescale by the ratio of full-scale ranges with rounding.
    # Negative signed inputs map to the negative dst range symmetrically.
    if src == SampleDataType.UINT8 and dst == SampleDataType.UINT16:
        return (arr.astype(xp.uint16) * np.uint16(257))  # exact: 255*257=65535
    scale = dst_max / src_max
    v = xp.round(arr.astype(xp.float32) * np.float32(scale))
    v = xp.clip(v, -dst_max - 1 if dst in _SIGNED else 0, dst_max)
    return v.astype(dst_np)


def convert_format(arr, fmt: SampleFormat):
    """Layout / channel-order conversion
    (reference: the P_*/I_* and RGB/BGR arms of
    src/imgproc/convert_kernel_gpu.cu:30-290). Input is the decoder's native
    interleaved HWC (or HW for gray); planar outputs are CHW."""
    xp = _xp(arr)
    if fmt in (SampleFormat.UNKNOWN, SampleFormat.I_UNCHANGED):
        return arr
    if fmt == SampleFormat.P_UNCHANGED:
        return xp.transpose(arr, (2, 0, 1)) if arr.ndim == 3 else arr

    if fmt == SampleFormat.P_Y:
        if arr.ndim == 2:
            return arr
        if arr.shape[-1] == 1:
            return arr[..., 0]
        # BT.601 fixed-point luma (same arithmetic as the GRAY color_spec arm)
        r, g, b = (arr[..., i].astype(xp.int32) for i in range(3))
        y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
        return y.astype(arr.dtype)

    if fmt == SampleFormat.P_YUV:
        from .color import rgb_to_ycbcr_i32

        a3 = _ensure_3ch(arr, xp)
        maxval = 65535 if a3.dtype == np.uint16 else 255
        y, cb, cr = rgb_to_ycbcr_i32(
            a3[..., 0], a3[..., 1], a3[..., 2], xp=xp, maxval=maxval
        )
        return xp.stack([y, cb, cr], axis=0).astype(arr.dtype)

    # RGB/BGR interleaved or planar
    a3 = _ensure_3ch(arr, xp)
    if fmt in (SampleFormat.I_BGR, SampleFormat.P_BGR):
        a3 = a3[..., ::-1]
    if fmt in (SampleFormat.P_RGB, SampleFormat.P_BGR):
        return xp.transpose(a3, (2, 0, 1))
    return a3


def _ensure_3ch(arr, xp):
    """Gray → 3-channel broadcast for RGB-family outputs (reference: the
    gray→RGB arm of the convert matrix)."""
    if arr.ndim == 2:
        return xp.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 1:
        return xp.concatenate([arr] * 3, axis=-1)
    if arr.shape[-1] > 3:
        return arr[..., :3]
    return arr


def convert(arr, fmt=None, dtype=None):
    """Apply the (format, dtype) pair the decode params requested
    (reference: the output nvimgcodecImageInfo_t drives both in
    decode, python/decoder.cpp:156-225). Contiguity is restored for numpy
    outputs so downstream DLPack/array-interface exports stay zero-copy."""
    if fmt is not None:
        arr = convert_format(arr, SampleFormat(fmt))
    if dtype is not None:
        arr = convert_dtype(arr, SampleDataType(dtype))
    if isinstance(arr, np.ndarray) and not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return arr
