"""JPEG pixel-domain pipeline: dequant+IDCT → upsample → color convert.

This is the device half of the hybrid decode (the role nvjpeg's GPU stage
plays in the reference, extensions/nvjpeg/cuda_decoder.cpp:539-556): one
[N,64]x[64,64] float32 product for dequant+IDCT (ops/dct.py) that XLA
fuses with its round/clip epilogue, integer-exact triangular upsampling
(ops/resample.py) and libjpeg-exact fixed-point color conversion
(ops/color.py). Runs identically under numpy and jax; every stage is
batch-agnostic ([..., H, W] planes) so the jitted batched path (batch.py)
reuses it with a leading batch dim.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ...ops import color as color_ops
from ...ops import resample as resample_ops
from ...ops.dct import dequant_idct_matrix
from .headers import JpegFrame

GeomKey = Tuple


def geometry_key(frame: JpegFrame) -> GeomKey:
    """Everything the jitted pixel function specializes on. Memoized on the
    frame object — batch bucketing and routing call this per sample."""
    k = getattr(frame, "_geom_key", None)
    if k is None:
        comps = tuple(
            (c.h, c.v, np.asarray(frame.quant[c.tq]).tobytes())
            for c in frame.components
        )
        k = (frame.width, frame.height, frame.precision, comps,
             frame.adobe_transform)
        frame._geom_key = k
    return k


def _planes_from_blocks(xp, blocks, bh: int, bw: int):
    """[..., bh*bw, 64] → [..., bh*8, bw*8]."""
    lead = blocks.shape[:-2]
    x = blocks.reshape(*lead, bh, bw, 8, 8)
    ndim = x.ndim
    perm = tuple(range(ndim - 4)) + (ndim - 4, ndim - 2, ndim - 3, ndim - 1)
    x = xp.transpose(x, perm)
    return x.reshape(*lead, bh * 8, bw * 8)


# zigzag index -> natural position (ITU-T T.81 figure A.6); used to fold the
# packed wire's zigzag coefficient order into the IDCT matrix columns so the
# device never pays a gather for the reordering
ZIGZAG_NAT = np.array([
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)


def idct_planes(
    frame: JpegFrame,
    coefs: List,
    use_jax: bool,
    zigzag: bool = False,
    bitexact: bool = False,
):
    """Per-component dequant+IDCT to cropped int32 sample planes.

    coefs[c]: [..., bh, bw, 64] → plane [..., ch, cw] (true sample area).
    With zigzag=True the 64-axis is in zigzag order and the reordering is
    folded into the dequant·IDCT matrix (zero device cost).
    With bitexact=True the float matmul is replaced by the integer-exact
    fixed-point IDCT (ops/dct.idct_islow_blocks) so the decode matches
    libjpeg-turbo byte-exactly (BASELINE configs[1]).
    """
    if use_jax:
        import jax.numpy as xp
    else:
        xp = np
    H, W = frame.height, frame.width
    hmax, vmax = frame.hmax, frame.vmax
    maxval = (1 << frame.precision) - 1
    center = float(1 << (frame.precision - 1))
    if bitexact:
        from ...ops.dct import idct_islow_blocks

        planes = []
        for c, blocks in zip(frame.components, coefs):
            bh, bw = blocks.shape[-3], blocks.shape[-2]
            K = blocks.shape[-1]
            lead = blocks.shape[:-3]
            blocks = xp.asarray(blocks).astype(xp.int32)
            if zigzag:
                # restore natural order (the integer butterfly is not a
                # matrix, so the permutation cannot fold into it): wire
                # index k holds natural position ZIGZAG_NAT[k], so the
                # natural array is wire[inv] with inv the inverse permutation
                pad = xp.concatenate(
                    [blocks,
                     xp.zeros(lead + (bh, bw, 64 - K), xp.int32)], axis=-1
                ) if K != 64 else blocks
                inv = np.argsort(ZIGZAG_NAT).astype(np.int32)
                blocks = xp.take(pad, xp.asarray(inv), axis=-1)
            samp = idct_islow_blocks(
                blocks.reshape(lead + (bh * bw, 64)),
                frame.quant[c.tq], frame.precision, xp)
            plane = _planes_from_blocks(xp, samp, bh, bw)
            cw = (W * c.h + hmax - 1) // hmax
            ch = (H * c.v + vmax - 1) // vmax
            planes.append(plane[..., :ch, :cw])
        return planes
    planes = []
    for c, blocks in zip(frame.components, coefs):
        bh, bw = blocks.shape[-3], blocks.shape[-2]
        K = blocks.shape[-1]  # zigzag wires may carry a truncated prefix
        M = dequant_idct_matrix(frame.quant[c.tq])  # [64(pix), 64(coef)]
        if zigzag:
            M = np.ascontiguousarray(M[:, ZIGZAG_NAT][:, :K])
        elif K != 64:
            raise ValueError("truncated coefficients require zigzag order")
        lead = blocks.shape[:-3]
        flat = blocks.reshape(*lead, bh * bw, K)
        if use_jax:
            import jax

            # HIGHEST: an f32 product may otherwise run in TF32 on a GPU
            # (~11 significant bits), which moves pixels by a level or more
            samp = (
                xp.einsum(
                    "...nk,pk->...np",
                    xp.asarray(flat, xp.float32),
                    xp.asarray(M),
                    preferred_element_type=xp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
                + center
            )
        else:
            samp = flat.astype(np.float32) @ M.T + center
        plane = _planes_from_blocks(xp, samp, bh, bw)
        plane = xp.clip(xp.round(plane), 0, maxval).astype(xp.int32)
        # crop to the component's true sample area before upsampling so the
        # replicated-edge math sees real edge samples
        cw = (W * c.h + hmax - 1) // hmax
        ch = (H * c.v + vmax - 1) // vmax
        planes.append(plane[..., :ch, :cw])
    return planes


def assemble_image(frame: JpegFrame, planes: List, use_jax: bool, fancy: bool = True):
    """Upsample chroma + color-convert cropped planes → uint8 image
    [..., H, W] or [..., H, W, C]."""
    if use_jax:
        import jax.numpy as xp
    else:
        xp = np
    H, W = frame.height, frame.width
    hmax, vmax = frame.hmax, frame.vmax
    maxval = (1 << frame.precision) - 1
    odtype = xp.uint8 if frame.precision <= 8 else xp.uint16
    full = []
    for c, plane in zip(frame.components, planes):
        vf, hf = vmax // c.v, hmax // c.h
        p = resample_ops.upsample_to(plane, vf, hf, fancy=fancy)
        full.append(p[..., :H, :W])

    n = len(full)
    if n == 1:
        return xp.clip(full[0], 0, maxval).astype(odtype)
    if n == 3:
        r, g, b = color_ops.ycbcr_to_rgb_i32(
            full[0], full[1], full[2], xp, maxval=maxval
        )
        return xp.stack([r, g, b], axis=-1).astype(odtype)
    if n == 4:
        # Adobe CMYK (transform=0) or YCCK (transform=2)
        if frame.adobe_transform == 2:
            c_, m_, y_, k_ = color_ops.ycck_to_cmyk_i32(
                full[0], full[1], full[2], full[3], xp
            )
        else:
            c_, m_, y_, k_ = full
        return xp.stack(
            [xp.clip(v, 0, maxval) for v in (c_, m_, y_, k_)], axis=-1
        ).astype(odtype)
    raise ValueError(f"unsupported component count {n}")


def decode_pixels(frame: JpegFrame, coefs: List, use_jax: bool = False,
                  fancy: bool = True, zigzag: bool = False,
                  bitexact: bool = False):
    """coefs[c]: [..., bh, bw, 64] int16 → uint8 image [..., H, W(, C)]."""
    planes = idct_planes(frame, coefs, use_jax, zigzag=zigzag,
                         bitexact=bitexact)
    return assemble_image(frame, planes, use_jax, fancy)


def cmyk_to_rgb(img, xp=np):
    r, g, b = color_ops.cmyk_to_rgb_i32(
        img[..., 0], img[..., 1], img[..., 2], img[..., 3], xp
    )
    return xp.stack([r, g, b], axis=-1).astype(xp.uint8)
