"""Discrete wavelet transforms for JPEG2000 (ITU-T T.800 Annex F).

Counterpart of the DWT stages nvjpeg2k runs on GPU in the
reference (extensions/nvjpeg2k/cuda_decoder.cpp). Lifting is expressed as
vectorized strided adds over [..., H, W] planes — elementwise work that XLA
fuses across steps; numpy (host) and jax (device) run the same code. All ops are batch-agnostic (arbitrary leading dims).

- 5/3 reversible: integer lifting, bit-exact invertible (lossless path).
- 9/7 irreversible: float lifting with the standard α β γ δ K constants.

Boundary handling is whole-sample symmetric extension; odd lengths and
subband parity follow the spec's interleaved formulation. Low-pass samples
live at even ABSOLUTE reference-grid positions (T.800 F.3.4's 1D_SR on
[i0, i1)), so every lift takes a `parity` bit — the parity of the
segment's absolute start coordinate. parity=1 (odd XOsiz/YOsiz/XTOsiz/
YTOsiz origins) puts high-pass samples at local-even indices and mirrors
the boundary-extension clamps between the two lifting steps; the
multi-level drivers derive per-level parities from an `origin` in
tile-component coordinates.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _xp(a):
    if isinstance(a, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp



def _split_low_high(x, axis: int, parity: int = 0):
    """Deinterleave into (low, high): low samples sit at local indices
    ≡ parity (mod 2) — absolute even positions of a segment whose start
    has that parity."""
    xp = _xp(x)
    n = x.shape[axis]
    idx_l = np.arange(parity, n, 2)
    idx_h = np.arange(1 - parity, n, 2)
    return xp.take(x, idx_l, axis=axis), xp.take(x, idx_h, axis=axis)


def _interleave(xp, low, high, axis: int, n: int, parity: int = 0):
    """Merge low/high samples back into a length-n axis (low at local
    indices ≡ parity)."""
    shape = list(low.shape)
    shape[axis] = n
    sl_l = [slice(None)] * len(shape)
    sl_h = [slice(None)] * len(shape)
    sl_l[axis] = slice(parity, n, 2)
    sl_h[axis] = slice(1 - parity, n, 2)
    if xp is np:
        out = np.empty(shape, low.dtype)
        out[tuple(sl_l)] = low
        out[tuple(sl_h)] = high
        return out
    out = xp.zeros(shape, low.dtype)
    out = out.at[tuple(sl_l)].set(low)
    out = out.at[tuple(sl_h)].set(high)
    return out



def _ax_slice(x, axis: int, start, stop):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def _shift_left_clamp(x, axis: int, out_len: int):
    """y[k] = x[min(k + 1, n - 1)] for k in [0, out_len) — pure slices."""
    xp = _xp(x)
    n = x.shape[axis]
    if out_len + 1 <= n:
        return _ax_slice(x, axis, 1, out_len + 1)
    # out_len == n: shift with edge clamp
    return xp.concatenate(
        [_ax_slice(x, axis, 1, None), _ax_slice(x, axis, n - 1, None)], axis=axis
    )


def _shift_right_clamp(x, axis: int, out_len: int):
    """y[k] = x[max(k - 1, 0)] for k in [0, out_len); out_len <= n + 1."""
    xp = _xp(x)
    head = _ax_slice(x, axis, 0, 1)
    return xp.concatenate([head, _ax_slice(x, axis, 0, out_len - 1)], axis=axis)


def _clamp_len(x, axis: int, out_len: int):
    """y[k] = x[min(k, n - 1)] for k in [0, out_len); out_len <= n + 1."""
    xp = _xp(x)
    n = x.shape[axis]
    if out_len <= n:
        return _ax_slice(x, axis, 0, out_len)
    return xp.concatenate([x, _ax_slice(x, axis, n - 1, None)], axis=axis)


# -- 1D lifting on the interleaved signal ----------------------------------

def _fwd_lift_53(x, axis: int, parity: int = 0):
    """Analysis on one axis: returns (L, H) along that axis (integer).

    parity = absolute parity of the segment start (T.800 F.3.4): high
    coefficients sit at odd absolute positions, so parity=1 swaps which
    local comb is high and mirrors the boundary clamps between steps."""
    xp = _xp(x)
    n = x.shape[axis]
    if n == 1:
        empty = xp.take(x, np.array([], np.int64), axis=axis)
        if parity:
            return empty, x * 2  # single odd-positioned sample (F.3.7)
        return x, empty
    low, high = _split_low_high(x, axis, parity)
    nl = low.shape[axis]
    nh = high.shape[axis]
    if parity == 0:
        # H[k] at abs 2k+1 ← low[k], low[k+1]; L[k] at abs 2k ← H[k-1], H[k]
        low_c = _ax_slice(low, axis, 0, nh)
        low_r = _shift_left_clamp(low, axis, nh)
        H = high - ((low_c + low_r) >> 1)
        H_l = _shift_right_clamp(H, axis, nl)
        H_c = _clamp_len(H, axis, nl)
        L = low + ((H_l + H_c + 2) >> 2)
    else:
        # H[k] at abs i0+2k ← low[k-1], low[k]; L[k] at abs i0+2k+1 ← H[k], H[k+1]
        low_l = _shift_right_clamp(low, axis, nh)
        low_c = _clamp_len(low, axis, nh)
        H = high - ((low_l + low_c) >> 1)
        H_c = _ax_slice(H, axis, 0, nl)
        H_r = _shift_left_clamp(H, axis, nl)
        L = low + ((H_c + H_r + 2) >> 2)
    return L, H


def _inv_lift_53(L, H, axis: int, n: int, parity: int = 0):
    """Synthesis on one axis from subbands (integer, exact inverse)."""
    xp = _xp(L)
    nl = L.shape[axis]
    nh = H.shape[axis]
    if nh == 0:
        return L
    if nl == 0:
        return H >> 1  # single odd-positioned sample (F.3.7 inverse)
    if parity == 0:
        H_l = _shift_right_clamp(H, axis, nl)
        H_c = _clamp_len(H, axis, nl)
        low = L - ((H_l + H_c + 2) >> 2)
        low_c = _ax_slice(low, axis, 0, nh)
        low_r = _shift_left_clamp(low, axis, nh)
        high = H + ((low_c + low_r) >> 1)
    else:
        H_c = _ax_slice(H, axis, 0, nl)
        H_r = _shift_left_clamp(H, axis, nl)
        low = L - ((H_c + H_r + 2) >> 2)
        low_l = _shift_right_clamp(low, axis, nh)
        low_c = _clamp_len(low, axis, nh)
        high = H + ((low_l + low_c) >> 1)
    return _interleave(xp, low, high, axis, n, parity)


def _fwd_lift_97(x, axis: int, parity: int = 0):
    xp = _xp(x)
    n = x.shape[axis]
    if n == 1:
        empty = xp.take(x, np.array([], np.int64), axis=axis)
        if parity:
            return empty, x * 2.0  # single odd-positioned sample (F.4.8)
        return x, empty
    low, high = _split_low_high(x, axis, parity)
    nl, nh = low.shape[axis], high.shape[axis]

    if parity == 0:
        def h_nbrs(lo):  # neighbors of abs-odd positions: low[k], low[k+1]
            return _ax_slice(lo, axis, 0, nh) + _shift_left_clamp(lo, axis, nh)

        def l_nbrs(hi):  # neighbors of abs-even positions: H[k-1], H[k]
            return _shift_right_clamp(hi, axis, nl) + _clamp_len(hi, axis, nl)
    else:
        def h_nbrs(lo):  # abs i0+2k: low[k-1], low[k]
            return _shift_right_clamp(lo, axis, nh) + _clamp_len(lo, axis, nh)

        def l_nbrs(hi):  # abs i0+2k+1: H[k], H[k+1]
            return _ax_slice(hi, axis, 0, nl) + _shift_left_clamp(hi, axis, nl)

    high = high + ALPHA * h_nbrs(low)
    low = low + BETA * l_nbrs(high)
    high = high + GAMMA * h_nbrs(low)
    low = low + DELTA * l_nbrs(high)
    return low * (1.0 / K), high * K


def _inv_lift_97(L, H, axis: int, n: int, parity: int = 0):
    xp = _xp(L)
    nl = L.shape[axis]
    nh = H.shape[axis]
    if nh == 0:
        return L
    if nl == 0:
        return H * 0.5  # single odd-positioned sample (F.4.8 inverse)

    if parity == 0:
        def h_nbrs(lo):
            return _ax_slice(lo, axis, 0, nh) + _shift_left_clamp(lo, axis, nh)

        def l_nbrs(hi):
            return _shift_right_clamp(hi, axis, nl) + _clamp_len(hi, axis, nl)
    else:
        def h_nbrs(lo):
            return _shift_right_clamp(lo, axis, nh) + _clamp_len(lo, axis, nh)

        def l_nbrs(hi):
            return _ax_slice(hi, axis, 0, nl) + _shift_left_clamp(hi, axis, nl)

    low = L * K
    high = H * (1.0 / K)
    low = low - DELTA * l_nbrs(high)
    high = high - GAMMA * h_nbrs(low)
    low = low - BETA * l_nbrs(high)
    high = high - ALPHA * h_nbrs(low)
    return _interleave(xp, low, high, axis, n, parity)


# -- 2D separable, single level --------------------------------------------

def dwt2d_level(x, reversible: bool, parity: Tuple[int, int] = (0, 0)):
    """One analysis level on [..., H, W] → (LL, HL, LH, HH).

    T.800 order: COLUMNS are filtered first, then rows (integer lifting
    does not commute, so the order is normative — validated bit-exact
    against openjpeg). HL = horizontally-highpass (X high, Y low), LH =
    vertically-highpass, matching the spec's subband naming.
    parity = (y0 & 1, x0 & 1) of the segment's absolute start.
    """
    f = _fwd_lift_53 if reversible else _fwd_lift_97
    Ly, Hy = f(x, -2, parity[0])
    LL, HL = f(Ly, -1, parity[1])
    LH, HH = f(Hy, -1, parity[1])
    return LL, HL, LH, HH


def idwt2d_level(LL, HL, LH, HH, out_h: int, out_w: int, reversible: bool,
                 parity: Tuple[int, int] = (0, 0)):
    """Inverse of dwt2d_level for a [..., out_h, out_w] target."""
    g = _inv_lift_53 if reversible else _inv_lift_97
    Ly = g(LL, HL, -1, out_w, parity[1])
    Hy = g(LH, HH, -1, out_w, parity[1])
    return g(Ly, Hy, -2, out_h, parity[0])


def subband_dims(h: int, w: int, levels: int,
                 origin: Tuple[int, int] = (0, 0)) -> List[Tuple[int, int]]:
    """[(h, w)] of the LL at each level 0..levels (level 0 = original).

    origin = (y0, x0) of the segment in tile-component coordinates; the
    level-s signal occupies [ceil(c0/2^s), ceil(c1/2^s)) on each axis
    (T.800 B.5), which differs from plain halving when the origin is odd.
    """
    y0, x0 = origin
    y1, x1 = y0 + h, x0 + w
    dims = []
    for s in range(levels + 1):
        d = 1 << s
        dims.append((-(-y1 // d) - (-(-y0 // d)),
                     -(-x1 // d) - (-(-x0 // d))))
    return dims


def _level_parity(origin: Tuple[int, int], s: int) -> Tuple[int, int]:
    """Parity of the level-s signal's start coordinates."""
    y0, x0 = origin
    d = 1 << s
    return ((-(-y0 // d)) & 1, (-(-x0 // d)) & 1)


def dwt2d(x, levels: int, reversible: bool,
          origin: Tuple[int, int] = (0, 0)):
    """Multi-level analysis. Returns (LL, [(HL, LH, HH) per level,
    finest-first]). origin = (y0, x0) tile-component coordinates."""
    bands = []
    cur = x
    for s in range(levels):
        LL, HL, LH, HH = dwt2d_level(cur, reversible,
                                     _level_parity(origin, s))
        bands.append((HL, LH, HH))
        cur = LL
    return cur, bands


def idwt2d(LL, bands, out_shape: Tuple[int, int], reversible: bool,
           origin: Tuple[int, int] = (0, 0)):
    """Inverse of dwt2d. bands finest-first; out_shape = (H, W)."""
    levels = len(bands)
    dims = subband_dims(out_shape[0], out_shape[1], levels, origin)
    cur = LL
    for lev in range(levels - 1, -1, -1):
        HL, LH, HH = bands[lev]
        h, w = dims[lev]
        cur = idwt2d_level(cur, HL, LH, HH, h, w, reversible,
                           _level_parity(origin, lev))
    return cur


# -- row-sharded synthesis with halo exchange over the mesh -----------------
#
# The vertical lifting steps read one neighbor sample across the row-shard
# boundary, so a row-sharded inverse DWT needs a real halo exchange: each
# device sends its boundary row to its neighbor via lax.ppermute (on a
# multi-GPU host, an NVLink peer copy). This realizes the "spatial parallel"
# axis the reference
# approximates with its J2K tile pool (extensions/nvjpeg2k/
# cuda_decoder.cpp:601-640) — here one tile's own transform is sharded.

def _shift_right_halo(x, axis_name: str):
    """y[k] = x[k-1] globally across row shards (whole-sample symmetric at
    the global top edge): pulls the previous device's last row."""
    import jax.numpy as jnp
    from jax import lax

    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    prev_last = lax.ppermute(
        x[..., -1:, :], axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    # global first shard clamps to its own first row (symmetric extension)
    head = jnp.where(idx > 0, prev_last, x[..., :1, :])
    return jnp.concatenate([head, x[..., :-1, :]], axis=-2)


def _shift_left_halo(x, axis_name: str):
    """y[k] = x[k+1] globally across row shards (clamped at the global
    bottom edge): pulls the next device's first row."""
    import jax.numpy as jnp
    from jax import lax

    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    next_first = lax.ppermute(
        x[..., :1, :], axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    tail = jnp.where(idx < n - 1, next_first, x[..., -1:, :])
    return jnp.concatenate([x[..., 1:, :], tail], axis=-2)


def _inv_lift_53_rows_sharded(L, H, axis_name: str):
    """Vertical 5/3 synthesis on row shards: L/H hold this device's even/odd
    rows (equal counts — the global row count must be even and divisible by
    2x the shard count). Returns the interleaved local rows."""
    import jax.numpy as jnp

    H_l = _shift_right_halo(H, axis_name)
    even = L - ((H_l + H + 2) >> 2)
    even_r = _shift_left_halo(even, axis_name)
    odd = H + ((even + even_r) >> 1)
    ne = L.shape[-2]
    return _interleave(jnp, even, odd, -2, 2 * ne)


def _inv_lift_97_rows_sharded(L, H, axis_name: str):
    import jax.numpy as jnp

    even = L * K
    odd = H * (1.0 / K)
    even = even - DELTA * (_shift_right_halo(odd, axis_name) + odd)
    odd = odd - GAMMA * (even + _shift_left_halo(even, axis_name))
    even = even - BETA * (_shift_right_halo(odd, axis_name) + odd)
    odd = odd - ALPHA * (even + _shift_left_halo(even, axis_name))
    ne = L.shape[-2]
    return _interleave(jnp, even, odd, -2, 2 * ne)


def idwt2d_level_rows_sharded(LL, HL, LH, HH, reversible: bool,
                              axis_name: str):
    """One synthesis level inside shard_map with rows sharded over
    `axis_name`. Inputs are the LOCAL row shards of each subband; the
    horizontal pass is device-local, the vertical pass exchanges halo rows.
    Global subband heights must be equal (even image height) and divisible
    by the shard count."""
    g = _inv_lift_53 if reversible else _inv_lift_97
    out_w = HL.shape[-1] * 2
    Ly = g(LL, HL, -1, out_w)
    Hy = g(LH, HH, -1, out_w)
    if reversible:
        return _inv_lift_53_rows_sharded(Ly, Hy, axis_name)
    return _inv_lift_97_rows_sharded(Ly, Hy, axis_name)


def idwt2d_rows_sharded(LL, bands, out_shape: Tuple[int, int],
                        reversible: bool, mesh, axis_name: str = "sp"):
    """Multi-level synthesis with rows sharded over the mesh at EVERY level
    whose subband height divides the shard count — one shard_map covers the
    whole pyramid, so intermediate levels stay resident in their shards
    (no mid-pyramid reshard) and no level's work is computed redundantly.
    Levels too small to split run replicated inside the same shard_map and
    hand off to the sharded ones with a local row slice (zero collectives).
    Halo rows cross shards via lax.ppermute only. Requires out_shape and
    the finest subbands to divide evenly (2 x shard count); callers fall
    back to the replicated path otherwise.

    Bit-exact vs idwt2d for the reversible (5/3) path."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    levels = len(bands)
    H, W = out_shape
    dims = subband_dims(H, W, levels)
    sp = mesh.shape[axis_name]
    fh, fw = dims[1]  # finest-level subband dims
    if levels == 0 or fh % sp or (H % 2) or dims[0][0] != 2 * fh:
        # uneven split: replicated fallback
        return idwt2d(LL, bands, out_shape, reversible)

    # a level is row-shardable when its (equal-height) input subbands split
    # evenly over the shards and its output height is even
    def shardable(lev: int) -> bool:
        h_out = dims[lev][0]
        sub_h = dims[lev + 1][0]
        return (h_out % 2 == 0 and 2 * sub_h == h_out and sub_h % sp == 0)

    nd = LL.ndim
    row_spec = P(*([None] * (nd - 2)), axis_name, None)
    rep_spec = P(*([None] * nd))
    shard = NamedSharding(mesh, row_spec)
    rep = NamedSharding(mesh, rep_spec)

    # once a level runs sharded its output stays sharded for all finer
    # levels, so the sharded set must be a fine-side suffix: level lev is
    # sharded only if it and every finer level are splittable
    sharded_lev = []
    ok = True
    for lev in range(levels):  # finest first
        ok = ok and shardable(lev)
        sharded_lev.append(ok)

    in_specs = [row_spec if sharded_lev[levels - 1] else rep_spec]
    for lev in range(levels):
        in_specs.extend([row_spec if sharded_lev[lev] else rep_spec] * 3)

    def step(ll, *flat):
        cur = ll
        cur_sharded = sharded_lev[levels - 1]
        for lev in range(levels - 1, -1, -1):
            HL_, LH_, HH_ = flat[3 * lev: 3 * lev + 3]
            h, w = dims[lev]
            if sharded_lev[lev]:
                if not cur_sharded:
                    # replicated -> sharded handoff: local row slice
                    sub_h = dims[lev + 1][0]
                    rows = sub_h // sp
                    idx = lax.axis_index(axis_name)
                    cur = lax.dynamic_slice_in_dim(
                        cur, idx * rows, rows, axis=-2)
                    cur_sharded = True
                cur = idwt2d_level_rows_sharded(cur, HL_, LH_, HH_,
                                                reversible, axis_name)
            else:
                cur = idwt2d_level(cur, HL_, LH_, HH_, h, w, reversible)
        return cur

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=row_spec,
    )
    args = [jax.device_put(jnp.asarray(LL),
                           shard if sharded_lev[levels - 1] else rep)]
    for lev in range(levels):
        s = shard if sharded_lev[lev] else rep
        args.extend(jax.device_put(jnp.asarray(b), s) for b in bands[lev])
    return fn(*args)
