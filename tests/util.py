"""Shared test utilities: synthetic photo-like images.

The reference repo's resources/ corpus is stored in git-lfs and only pointer
stubs are present here, so tests synthesize an equivalent corpus and use the
system codec oracle (tests/oracle) for ground truth — the same role OpenCV
plays in the reference's tests (test/python/utils.py:61-72).
"""
from __future__ import annotations

import numpy as np


def make_photo(h: int = 426, w: int = 640, seed: int = 0, channels: int = 3) -> np.ndarray:
    """Smooth low-frequency content + edges + mild noise; JPEG-friendly but
    non-trivial (emulates the padlock/cat photos in the reference corpus)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((h, w, channels), np.float32)
    for c in range(channels):
        f1, f2 = rng.uniform(0.005, 0.03, 2)
        p1, p2 = rng.uniform(0, 6.28, 2)
        base = (
            110
            + 70 * np.sin(xx * f1 + p1) * np.cos(yy * f2 + p2)
            + 40 * np.sin((xx + yy) * rng.uniform(0.004, 0.02))
        )
        out[:, :, c] = base
    # a few hard-edged rectangles and circles for high-frequency content
    for _ in range(6):
        y0, x0 = rng.integers(0, max(1, h - 20)), rng.integers(0, max(1, w - 20))
        hh, ww = rng.integers(1, max(2, h // 3)), rng.integers(1, max(2, w // 3))
        col = rng.uniform(0, 255, channels)
        out[y0 : y0 + hh, x0 : x0 + ww] = 0.6 * out[y0 : y0 + hh, x0 : x0 + ww] + 0.4 * col
    cy, cx, r = h // 2, w // 2, min(h, w) // 4
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    out[mask] = 0.7 * out[mask] + 0.3 * 200
    out += rng.normal(0, 2.0, out.shape)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[:, :, 0] if channels == 1 else out


def add_exif_orientation(jpeg_bytes: bytes, orientation: int) -> bytes:
    """Splice a minimal APP1/EXIF segment carrying the orientation tag right
    after SOI (how the reference's resources/*/exif_orientation files carry
    orientation)."""
    import struct

    tiff = (
        b"II" + struct.pack("<H", 42) + struct.pack("<I", 8)
        + struct.pack("<H", 1)  # one IFD entry
        + struct.pack("<HHI", 0x0112, 3, 1) + struct.pack("<HH", orientation, 0)
        + struct.pack("<I", 0)  # next IFD
    )
    payload = b"Exif\x00\x00" + tiff
    seg = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    assert jpeg_bytes[:2] == b"\xff\xd8"
    return jpeg_bytes[:2] + seg + jpeg_bytes[2:]


def max_abs_diff(a, b) -> int:
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"
    return int(np.abs(a - b).max()) if a.size else 0


def psnr(a, b):
    """Peak signal-to-noise ratio in dB (uint8 range)."""
    import numpy as np

    a = np.asarray(a).astype(np.float64)
    b = np.asarray(b).astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(255.0**2 / mse)


def jpeg_corpus(n: int, h: int = 375, w: int = 500, quality: int = 85,
                restart_interval: int = 0, nbase: int = 8):
    """Seeded 4:2:0 JPEG corpus: (base photos, n streams cycling over them,
    whether the system libjpeg oracle encoded them). Falls back to this
    repo's own encoder where the oracle library does not build."""
    import subprocess

    base = [make_photo(h, w, seed=s) for s in range(nbase)]
    try:
        import oracle

        oracle.lib()
        uniq = [oracle.jpeg_encode(b, quality, "420",
                                   restart_interval=restart_interval)
                for b in base]
        used_oracle = True
    except (OSError, subprocess.CalledProcessError):
        from nvimagecodec_tpu.codecs.jpeg.encode import encode_jpeg
        from nvimagecodec_tpu.core.interfaces import EncodeParams

        params = EncodeParams(quality=quality, chroma_subsampling="420")
        uniq = [encode_jpeg(b, params, restart_interval=restart_interval)
                for b in base]
        used_oracle = False
    return base, [uniq[i % nbase] for i in range(n)], used_oracle
