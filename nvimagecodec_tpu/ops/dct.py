"""8x8 DCT/IDCT as matrix products.

Replacement for the DCT stages the reference delegates to nvjpeg
(the GPU IDCT inside nvjpegDecodeJpegDevice,
extensions/nvjpeg/cuda_decoder.cpp:539-556). Design: the 2-D 8x8 IDCT is
linear, so dequantization and the whole 2-D transform fold into ONE [64,64]
matrix per quant table; a batch of blocks becomes a single [N,64]x[64,64]
matmul (SURVEY.md §7: "8x8 DCT/IDCT as fused matmul kernels").
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _dct1d_basis() -> np.ndarray:
    """C[k, x] = c(k)/2 * cos((2x+1) k pi / 16); IDCT: s = C^T S."""
    k = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    return (0.5 * c * np.cos((2 * x + 1) * k * np.pi / 16.0))


@functools.lru_cache(maxsize=None)
def idct_matrix_64() -> np.ndarray:
    """M such that vec(pixels) = M @ vec(coefs), both row-major 64-vectors.

    pixels = C^T @ S @ C  →  M = kron(C^T, C^T).
    """
    C = _dct1d_basis()
    return np.kron(C.T, C.T)  # float64 [64, 64]


@functools.lru_cache(maxsize=None)
def dct_matrix_64() -> np.ndarray:
    """Forward: vec(S) = D @ vec(pixels); D = kron(C, C)."""
    C = _dct1d_basis()
    return np.kron(C, C)


def dequant_idct_matrix(quant_natural: np.ndarray) -> np.ndarray:
    """Fold per-coefficient dequantization into the IDCT matrix:
    pixels = M @ (q * coef) = (M * q[None, :]) @ coef."""
    M = idct_matrix_64()
    return (M * quant_natural.astype(np.float64)[None, :]).astype(np.float32)


def quant_dct_matrix(quant_natural: np.ndarray) -> np.ndarray:
    """Forward DCT with quantization folded: coef_q ≈ (D / q[:, None]) @ pixels
    (caller rounds)."""
    D = dct_matrix_64()
    return (D / quant_natural.astype(np.float64)[:, None]).astype(np.float32)


def idct_blocks(coefs, quant_natural: np.ndarray, precision: int = 8):
    """Dequantize + IDCT a batch of blocks on device.

    coefs: [..., 64] int/float array (natural order), jax or numpy.
    Returns float32 [..., 64] sample values (level-shifted to [0, 2^p-1],
    unclipped — caller clips/rounds after upsample/color conversion to keep
    everything fused).
    """
    import jax
    import jax.numpy as jnp

    M = dequant_idct_matrix(np.asarray(quant_natural))
    x = jnp.asarray(coefs, jnp.float32)
    center = float(1 << (precision - 1))
    return (
        jnp.einsum("...k,pk->...p", x, M, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
        + center
    )


# --------------------------------------------------------------------------
# Integer-exact inverse DCT (bit-exact decode mode)
#
# Fixed-point Loeffler-Ligtenberg-Moshovitz 8-point IDCT with the standard
# 13-bit constants (round(x * 8192)) and two-pass descaling — the same
# arithmetic contract as libjpeg's "islow" path, so decodes match
# libjpeg-turbo BYTE-EXACTLY (BASELINE configs[1]). Implemented as
# vectorized int32 butterflies over [..., 8, 8] blocks: pure VPU ops under
# jax, plain numpy on the CPU backend — identical results on both.
# --------------------------------------------------------------------------

_CONST_BITS = 13
_PASS1_BITS = 2
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172


def _islow_1d(xp, d, shift_out: int):
    """One 8-point fixed-point inverse transform over axis -1 of d
    ([..., 8] int32/int64 stacks given as a tuple of 8 arrays). Returns a
    tuple of 8 output arrays, descaled by `shift_out` with round-half-up."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d

    z1 = (d2 + d6) * _F_0_541196100
    tmp2 = z1 - d6 * _F_1_847759065
    tmp3 = z1 + d2 * _F_0_765366865
    tmp0 = (d0 + d4) << _CONST_BITS
    tmp1 = (d0 - d4) << _CONST_BITS
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    t0, t1, t2, t3 = d7, d5, d3, d1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _F_1_175875602
    t0 = t0 * _F_0_298631336
    t1 = t1 * _F_2_053119869
    t2 = t2 * _F_3_072711026
    t3 = t3 * _F_1_501321110
    z1 = -z1 * _F_0_899976223
    z2 = -z2 * _F_2_562915447
    z3 = -z3 * _F_1_961570560 + z5
    z4 = -z4 * _F_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (shift_out - 1)
    ds = lambda x: (x + half) >> shift_out
    return (
        ds(tmp10 + t3), ds(tmp11 + t2), ds(tmp12 + t1), ds(tmp13 + t0),
        ds(tmp13 - t0), ds(tmp12 - t1), ds(tmp11 - t2), ds(tmp10 - t3),
    )


def idct_islow_blocks(coefs, quant_natural, precision: int = 8, xp=np):
    """Dequantize + integer-exact IDCT: [..., 64] int coefficients
    (natural order) → [..., 64] clipped int32 samples, byte-identical to
    libjpeg-turbo's islow decode of the same coefficients."""
    q = xp.asarray(np.asarray(quant_natural).astype(np.int32))
    x = (xp.asarray(coefs).astype(xp.int32) * q).reshape(
        coefs.shape[:-1] + (8, 8))
    # pass 1: columns (vertical frequency axis), output scaled by PASS1_BITS
    cols = _islow_1d(xp, tuple(x[..., u, :] for u in range(8)),
                     _CONST_BITS - _PASS1_BITS)
    y = xp.stack(cols, axis=-2)  # [..., 8(y), 8(v)]
    # pass 2: rows, final descale folds PASS1_BITS and the /8 of the 2-D
    # transform (CONST_BITS + PASS1_BITS + 3)
    rows = _islow_1d(xp, tuple(y[..., v] for v in range(8)),
                     _CONST_BITS + _PASS1_BITS + 3)
    out = xp.stack(rows, axis=-1)  # [..., 8(y), 8(x)]
    center = 1 << (precision - 1)
    maxval = (1 << precision) - 1
    out = xp.clip(out + center, 0, maxval)
    return out.reshape(coefs.shape[:-1] + (64,))


def blocks_to_plane(blocks, blocks_h: int, blocks_w: int):
    """[bh*bw, 64] → [bh*8, bw*8] raster plane (jax or numpy)."""
    import jax.numpy as jnp

    x = jnp.reshape(blocks, (blocks_h, blocks_w, 8, 8))
    x = jnp.transpose(x, (0, 2, 1, 3))
    return jnp.reshape(x, (blocks_h * 8, blocks_w * 8))


def plane_to_blocks(plane, blocks_h: int, blocks_w: int):
    """[bh*8, bw*8] → [bh*bw, 64] (inverse of blocks_to_plane)."""
    import jax.numpy as jnp

    x = jnp.reshape(plane, (blocks_h, 8, blocks_w, 8))
    x = jnp.transpose(x, (0, 2, 1, 3))
    return jnp.reshape(x, (blocks_h * blocks_w, 64))
