"""Chroma up/downsampling, integer-exact to libjpeg.

Counterpart of the reference's chroma resampling (done inside
nvjpeg on GPU; CPU fallback via libjpeg_turbo — the `fancy_upsampling` knob
is exposed at include/nvimgcodec.h:1593-1594). All ops are vectorized
shifted-neighbor arithmetic on int32 — pure VPU work that XLA fuses with the
surrounding color conversion. Every op is batch-agnostic: planes are
[..., H, W] with arbitrary leading dims so the jitted batched decode path
reuses them unchanged.

Fancy (triangular) upsampling reproduces libjpeg jdsample.c h2v1/h2v2 (and
libjpeg-turbo's h1v2) exactly via edge-padding: the first/last-column special
cases collapse into the general formula when the edge sample is replicated.
"""
from __future__ import annotations


def _xp(a):
    import numpy as np

    if isinstance(a, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def _interleave(xp, a, b, axis: int):
    """Interleave two equal arrays along `axis` (a0,b0,a1,b1,...)."""
    stacked = xp.stack([a, b], axis=axis + 1 if axis >= 0 else a.ndim + axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def upsample_h2_fancy(s):
    """Horizontal 2x triangular upsample of [..., W] → [..., 2W]
    (libjpeg h2v1_fancy_upsample)."""
    xp = _xp(s)
    s = s.astype(xp.int32)
    left = xp.concatenate([s[..., :1], s[..., :-1]], axis=-1)
    right = xp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    even = (3 * s + left + 1) >> 2
    odd = (3 * s + right + 2) >> 2
    return _interleave(xp, even, odd, axis=-1)


def upsample_h2v2_fancy(s):
    """2x2 triangular upsample of [..., H, W] → [..., 2H, 2W]
    (libjpeg h2v2_fancy_upsample: 9/3/3/1 weighting)."""
    xp = _xp(s)
    s = s.astype(xp.int32)
    up = xp.concatenate([s[..., :1, :], s[..., :-1, :]], axis=-2)
    dn = xp.concatenate([s[..., 1:, :], s[..., -1:, :]], axis=-2)
    cs_even = 3 * s + up  # nearer row is this row, farther the row above
    cs_odd = 3 * s + dn
    cs = _interleave(xp, cs_even, cs_odd, axis=-2)  # [..., 2H, W] column sums
    left = xp.concatenate([cs[..., :1], cs[..., :-1]], axis=-1)
    right = xp.concatenate([cs[..., 1:], cs[..., -1:]], axis=-1)
    even = (3 * cs + left + 8) >> 4
    odd = (3 * cs + right + 7) >> 4
    return _interleave(xp, even, odd, axis=-1)


def upsample_v2_fancy(s):
    """Vertical 2x triangular upsample of [..., H, W] → [..., 2H, W]
    (libjpeg-turbo h1v2_fancy_upsample, the 4:4:0 path)."""
    xp = _xp(s)
    s = s.astype(xp.int32)
    up = xp.concatenate([s[..., :1, :], s[..., :-1, :]], axis=-2)
    dn = xp.concatenate([s[..., 1:, :], s[..., -1:, :]], axis=-2)
    even = (3 * s + up + 1) >> 2
    odd = (3 * s + dn + 2) >> 2
    return _interleave(xp, even, odd, axis=-2)


def upsample_replicate(s, vfactor: int, hfactor: int):
    """Nearest-neighbor expansion (libjpeg int_upsample, used for 4:1:1,
    4:1:0 and any non-2x factor)."""
    xp = _xp(s)
    if hfactor > 1:
        s = xp.repeat(s, hfactor, axis=-1)
    if vfactor > 1:
        s = xp.repeat(s, vfactor, axis=-2)
    return s


def upsample_to(s, vfactor: int, hfactor: int, fancy: bool = True):
    """Dispatch matching libjpeg jdsample.c selection rules."""
    if vfactor == 1 and hfactor == 1:
        return s
    # libjpeg-turbo jdsample.c uses plain replication when the downsampled
    # width is ≤ 2 (fancy needs real horizontal context)
    narrow = s.shape[-1] <= 2
    if fancy and vfactor == 1 and hfactor == 2 and not narrow:
        return upsample_h2_fancy(s)
    if fancy and vfactor == 2 and hfactor == 2 and not narrow:
        return upsample_h2v2_fancy(s)
    if fancy and vfactor == 2 and hfactor == 1:
        return upsample_v2_fancy(s)
    return upsample_replicate(s, vfactor, hfactor)


def downsample_h2v1(s):
    """[..., H, 2W] → [..., H, W] pair average with alternating bias 0,1
    (libjpeg h2v1_downsample)."""
    xp = _xp(s)
    s = s.astype(xp.int32)
    a = s[..., 0::2]
    b = s[..., 1::2]
    bias = xp.arange(a.shape[-1], dtype=xp.int32) % 2  # 0,1,0,1...
    return (a + b + bias) >> 1


def downsample_h2v2(s):
    """[..., 2H, 2W] → [..., H, W] 2x2 average with alternating bias 1,2
    (libjpeg h2v2_downsample)."""
    xp = _xp(s)
    s = s.astype(xp.int32)
    q = (
        s[..., 0::2, 0::2]
        + s[..., 0::2, 1::2]
        + s[..., 1::2, 0::2]
        + s[..., 1::2, 1::2]
    )
    bias = 1 + (xp.arange(q.shape[-1], dtype=xp.int32) % 2)  # 1,2,1,2...
    return (q + bias) >> 2


def downsample_v2(s):
    """[..., 2H, W] → [..., H, W] vertical pair average (libjpeg h1v2)."""
    xp = _xp(s)
    s = s.astype(xp.int32)
    a = s[..., 0::2, :]
    b = s[..., 1::2, :]
    bias = xp.arange(a.shape[-1], dtype=xp.int32) % 2
    return (a + b + bias) >> 1
