"""Color space conversions, integer-exact to libjpeg's fixed-point math.

Counterpart of the reference conversion kernels
(reference: src/imgproc/color_space_conversion_impl.h:64-190 — BT.601
limited-range and JPEG full-range YCbCr⇄RGB). All ops are elementwise int32
arithmetic (VPU-friendly) so lossless paths stay bit-exact; XLA fuses them
into the surrounding pipeline.

Fixed-point constants are round(x * 65536) of the T.871 full-range matrix —
the same SCALEBITS=16 scheme libjpeg uses, so our output matches libjpeg's
per-pixel rounding exactly.
"""
from __future__ import annotations

import numpy as np

# round(coef * 2^16)
_FIX_1_40200 = 91881
_FIX_0_34414 = 22554
_FIX_0_71414 = 46802
_FIX_1_77200 = 116130

_FIX_0_29900 = 19595
_FIX_0_58700 = 38470
_FIX_0_11400 = 7471
_FIX_0_16874 = 11059
_FIX_0_33126 = 21709
_FIX_0_50000 = 32768
_FIX_0_41869 = 27439
_FIX_0_08131 = 5329

_ONE_HALF = 1 << 15
_CBCR_OFFSET = 128 << 16


def ycbcr_to_rgb_i32(y, cb, cr, xp=None, maxval: int = 255):
    """Full-range (JFIF) YCbCr → RGB, libjpeg jdcolor.c fixed-point exact.

    Inputs int32 arrays in [0, maxval]; returns (r, g, b) int32 clipped to
    [0, maxval] (maxval 4095 for 12-bit extended-sequential streams)."""
    if xp is None:
        import jax.numpy as xp
    center = (maxval + 1) >> 1
    y = y.astype(xp.int32)
    cbc = cb.astype(xp.int32) - center
    crc = cr.astype(xp.int32) - center
    r = y + ((_FIX_1_40200 * crc + _ONE_HALF) >> 16)
    g = y + ((-_FIX_0_34414 * cbc - _FIX_0_71414 * crc + _ONE_HALF) >> 16)
    b = y + ((_FIX_1_77200 * cbc + _ONE_HALF) >> 16)
    clip = lambda v: xp.clip(v, 0, maxval)
    return clip(r), clip(g), clip(b)


def rgb_to_ycbcr_i32(r, g, b, xp=None, maxval: int = 255):
    """Full-range RGB → YCbCr, libjpeg jccolor.c fixed-point exact.
    maxval 4095 selects the 12-bit chroma offset."""
    if xp is None:
        import jax.numpy as xp
    offset = ((maxval + 1) >> 1) << 16
    r = r.astype(xp.int32)
    g = g.astype(xp.int32)
    b = b.astype(xp.int32)
    y = (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b + _ONE_HALF) >> 16
    cb = (
        -_FIX_0_16874 * r - _FIX_0_33126 * g + _FIX_0_50000 * b
        + offset + _ONE_HALF - 1
    ) >> 16
    cr = (
        _FIX_0_50000 * r - _FIX_0_41869 * g - _FIX_0_08131 * b
        + offset + _ONE_HALF - 1
    ) >> 16
    return y, cb, cr


def ycck_to_cmyk_i32(y, cb, cr, k, xp=None):
    """YCCK → CMYK (libjpeg ycck_cmyk_convert): C/M/Y are 255 - RGB'."""
    if xp is None:
        import jax.numpy as xp
    r, g, b = ycbcr_to_rgb_i32(y, cb, cr, xp)
    return 255 - r, 255 - g, 255 - b, k.astype(xp.int32)


def cmyk_to_rgb_i32(c, m, y, k, xp=None):
    """Naive CMYK → RGB (Adobe-style inverted CMYK: stored C is 255-C).

    JPEG CMYK from Adobe files stores inverted ink values; the common
    convention (matching OpenCV's reader) is R = C*K/255.
    """
    if xp is None:
        import jax.numpy as xp
    c = c.astype(xp.int32)
    m = m.astype(xp.int32)
    y = y.astype(xp.int32)
    k = k.astype(xp.int32)
    r = (c * k + 127) // 255
    g = (m * k + 127) // 255
    b = (y * k + 127) // 255
    return r, g, b


# --- BT.601 limited-range (for video-range streams; reference:
# color_space_conversion_impl.h BT.601 path) -------------------------------

def ycbcr_bt601_to_rgb_f32(y, cb, cr, xp=None):
    if xp is None:
        import jax.numpy as xp
    y = (y.astype(xp.float32) - 16.0) * (255.0 / 219.0)
    cbc = cb.astype(xp.float32) - 128.0
    crc = cr.astype(xp.float32) - 128.0
    scale = 255.0 / 224.0
    r = y + 1.402 * scale * crc
    g = y - 0.344136 * scale * cbc - 0.714136 * scale * crc
    b = y + 1.772 * scale * cbc
    return tuple(xp.clip(v, 0.0, 255.0) for v in (r, g, b))


def gray_to_rgb(y, xp=None):
    if xp is None:
        import jax.numpy as xp
    return y, y, y
