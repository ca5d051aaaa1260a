"""PNG decoder: full RFC 2083 feature set on the CPU backend.

Counterpart of the reference's PNG decode path
(reference: extensions/opencv/opencv_decoder.cpp via cv::imdecode,
registered CPU_ONLY at LOW priority, opencv_ext.cpp:38-44 — PNG has no GPU
path in the reference either; inflate+defilter are inherently serial).
Inflate uses zlib; the per-scanline filter undo is native C++
(native/png_defilter.cpp) with a numpy fallback; palette/bit-depth/alpha
expansion is vectorized numpy.

Supports color types 0/2/3/4/6, bit depths 1/2/4/8/16, Adam7 interlace,
PLTE + tRNS (palette alpha and color-key transparency).
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeResult,
    EncoderPlugin,
)
from ..core.types import BackendKind, Priority, ProcessingStatus

PNG_SIG = b"\x89PNG\r\n\x1a\n"

# Adam7 pass geometry: (x_start, y_start, x_step, y_step)
_ADAM7 = [
    (0, 0, 8, 8),
    (4, 0, 8, 8),
    (0, 4, 4, 8),
    (2, 0, 4, 4),
    (0, 2, 2, 4),
    (1, 0, 2, 2),
    (0, 1, 1, 2),
]

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngStream:
    """Parsed chunk-level view of a PNG byte stream."""

    def __init__(self, data: bytes):
        if data[:8] != PNG_SIG:
            raise ValueError("not a PNG")
        self.width = self.height = 0
        self.bit_depth = 8
        self.color_type = 0
        self.interlace = 0
        self.palette: Optional[np.ndarray] = None
        self.trns: Optional[bytes] = None
        idat: List[bytes] = []
        pos = 8
        n = len(data)
        while pos + 8 <= n:
            (length,) = struct.unpack_from(">I", data, pos)
            ctype = data[pos + 4 : pos + 8]
            body = data[pos + 8 : pos + 8 + length]
            if ctype == b"IHDR":
                (self.width, self.height, self.bit_depth, self.color_type,
                 _comp, _filt, self.interlace) = struct.unpack(">IIBBBBB", body)
                if _comp != 0 or _filt != 0:
                    raise ValueError("PNG: unknown compression/filter method")
            elif ctype == b"PLTE":
                self.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif ctype == b"tRNS":
                self.trns = bytes(body)
            elif ctype == b"IDAT":
                idat.append(body)
            elif ctype == b"IEND":
                break
            pos += 12 + length
        if not idat:
            raise ValueError("PNG: no IDAT")
        self.raw = zlib.decompress(b"".join(idat))
        self.channels = _CHANNELS[self.color_type]


def _defilter_py(raw: memoryview, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Pure-Python/numpy defilter fallback (same semantics as the native)."""
    out = np.empty((h, rowbytes), np.uint8)
    stride = rowbytes + 1
    prev = None
    for y in range(h):
        f = raw[y * stride]
        row = np.frombuffer(raw, np.uint8, rowbytes, y * stride + 1).astype(np.int32)
        if f == 0:
            cur = row
        elif f == 1:  # Sub — per-lane prefix sum mod 256
            cur = row.copy()
            for i in range(bpp, rowbytes):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif f == 2:  # Up
            cur = row + (prev if prev is not None else 0)
        elif f == 3:  # Average
            cur = row.copy()
            up = prev if prev is not None else np.zeros(rowbytes, np.int32)
            for i in range(rowbytes):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            cur = row.copy()
            up = prev if prev is not None else np.zeros(rowbytes, np.int32)
            for i in range(rowbytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                c = up[i - bpp] if (prev is not None and i >= bpp) else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: bad filter {f}")
        cur = (cur & 0xFF).astype(np.uint8)
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def _defilter(raw: bytes, offset: int, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    if h == 0 or rowbytes == 0:
        return np.zeros((h, rowbytes), np.uint8)
    view = memoryview(raw)[offset : offset + h * (rowbytes + 1)]
    try:
        import ctypes

        from ..native import lib

        L = lib()
    except Exception:
        return _defilter_py(view, h, rowbytes, bpp)
    out = np.empty((h, rowbytes), np.uint8)
    rc = L.tic_png_defilter(
        bytes(view), len(view), h, rowbytes, bpp,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise ValueError(f"PNG defilter failed rc={rc}")
    return out


def _unpack_bits(rows: np.ndarray, width: int, bit_depth: int) -> np.ndarray:
    """[h, rowbytes] packed samples → [h, width] ints (1/2/4-bit)."""
    h = rows.shape[0]
    if bit_depth == 8:
        return rows[:, :width]
    if bit_depth == 16:
        return rows.reshape(h, -1)[:, : 2 * width]  # caller handles pairs
    per_byte = 8 // bit_depth
    shifts = np.arange(per_byte - 1, -1, -1, dtype=np.uint8) * bit_depth
    mask = (1 << bit_depth) - 1
    expanded = (rows[:, :, None] >> shifts[None, None, :]) & mask
    return expanded.reshape(h, -1)[:, :width]


def _rows_to_pixels(
    rows: np.ndarray, width: int, channels: int, bit_depth: int
) -> np.ndarray:
    """Defiltered rows [h, rowbytes] → [h, width, channels] (u8 or u16)."""
    h = rows.shape[0]
    if bit_depth == 16:
        arr = rows.reshape(h, -1).view(">u2")[:, : width * channels]
        return arr.astype(np.uint16).reshape(h, width, channels)
    if bit_depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels)
    # sub-byte depths only occur for gray / palette (channels == 1)
    samples = _unpack_bits(rows, width, bit_depth)
    return samples.reshape(h, width, 1)


def decode_png(data: bytes) -> Tuple[np.ndarray, PngStream]:
    """Decode to the natural channel layout: [H,W,{1,2,3,4}] u8/u16."""
    ps = PngStream(data)
    W, H, bd, ch = ps.width, ps.height, ps.bit_depth, ps.channels
    bpp = max(1, (bd * ch) // 8)

    if ps.interlace == 0:
        rowbytes = (W * ch * bd + 7) // 8
        rows = _defilter(ps.raw, 0, H, rowbytes, bpp)
        img = _rows_to_pixels(rows, W, ch, bd)
    else:  # Adam7
        dtype = np.uint16 if bd == 16 else np.uint8
        img = np.zeros((H, W, ch), dtype)
        offset = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (W - x0 + dx - 1) // dx
            ph = (H - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            rowbytes = (pw * ch * bd + 7) // 8
            rows = _defilter(ps.raw, offset, ph, rowbytes, bpp)
            offset += ph * (rowbytes + 1)
            sub = _rows_to_pixels(rows, pw, ch, bd)
            img[y0::dy, x0::dx] = sub

    # palette / transparency expansion
    if ps.color_type == 3:
        if ps.palette is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = img[..., 0].astype(np.int32)
        rgb = ps.palette[idx]
        if ps.trns is not None:
            alpha = np.full(len(ps.palette), 255, np.uint8)
            t = np.frombuffer(ps.trns, np.uint8)
            alpha[: len(t)] = t
            img = np.dstack([rgb, alpha[idx]])
        else:
            img = rgb
    elif ps.trns is not None and ps.color_type in (0, 2):
        # color-key transparency → alpha channel
        maxv = (1 << bd) - 1
        if ps.color_type == 0:
            (key,) = struct.unpack(">H", ps.trns[:2])
            mask = img[..., 0] == key
        else:
            kr, kg, kb = struct.unpack(">HHH", ps.trns[:6])
            mask = (img[..., 0] == kr) & (img[..., 1] == kg) & (img[..., 2] == kb)
        alpha = np.where(mask, 0, maxv).astype(img.dtype)
        img = np.dstack([img, alpha])
    elif ps.color_type in (0,) and bd < 8:
        # scale sub-byte gray to full 8-bit range
        img = (img * (255 // ((1 << bd) - 1))).astype(np.uint8)

    if img.shape[-1] == 1:
        img = img[..., 0]
    return img, ps


# ------------------------------------------------------------------ encode
def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode [H,W], [H,W,2], [H,W,3] or [H,W,4] u8/u16 → PNG bytes.

    (The reference has no PNG encoder — its encode matrix is bmp/pnm/jpeg/
    jpeg2k — but a drop-in replacement's users expect one.) Per-row adaptive
    filtering with the minimum-sum-of-absolute-differences heuristic over
    the five RFC 2083 filters, vectorized across each row; zlib for the
    DEFLATE stage.
    """
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    if img.dtype == np.uint16:
        bd = 16
        raw = np.ascontiguousarray(img).astype(">u2").view(np.uint8)
        raw = raw.reshape(h, w * ch * 2)
        bpp = ch * 2
    else:
        bd = 8
        raw = np.ascontiguousarray(img, np.uint8).reshape(h, w * ch)
        bpp = ch
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    rowbytes = raw.shape[1]
    prev = np.zeros(rowbytes, np.int32)
    out_rows = []
    for y in range(h):
        cur = raw[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upl = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        cand = [
            (0, cur),
            (1, (cur - left) & 0xFF),
            (2, (cur - prev) & 0xFF),
            (3, (cur - ((left + prev) >> 1)) & 0xFF),
        ]
        pp = left + prev - upl
        pa = np.abs(pp - left)
        pb = np.abs(pp - prev)
        pc = np.abs(pp - upl)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upl))
        cand.append((4, (cur - paeth) & 0xFF))
        # minimum sum of absolute differences (bytes as signed)
        best_f, best_row, best_cost = 0, cand[0][1], None
        for f, row in cand:
            signed = np.where(row > 127, 256 - row, row)
            cost = int(signed.sum())
            if best_cost is None or cost < best_cost:
                best_f, best_row, best_cost = f, row, cost
        out_rows.append(bytes([best_f]) + best_row.astype(np.uint8).tobytes())
        prev = cur
    payload = zlib.compress(b"".join(out_rows), compress_level)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)
        )

    out = bytearray(PNG_SIG)
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bd, color_type, 0, 0, 0))
    out += chunk(b"IDAT", payload)
    out += chunk(b"IEND", b"")
    return bytes(out)


class PngEncoder(EncoderPlugin):
    codec = "png"
    plugin_id = "cpu_png_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_encode(self, image_batch, info_batch, params):
        out = []
        for img in image_batch:
            a = np.asarray(img)
            ok = a.dtype in (np.uint8, np.uint16) and (
                a.ndim == 2 or (a.ndim == 3 and a.shape[-1] in (1, 2, 3, 4))
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    def encode_batch(self, image_batch, info_batch, params):
        out = []
        for img in image_batch:
            try:
                out.append(
                    EncodeResult(
                        ProcessingStatus.SUCCESS, encode_png(np.asarray(img))
                    )
                )
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


class PngCpuDecoder(DecoderPlugin):
    """CPU PNG decoder (the reference's PNG path is CPU-only too)."""

    codec = "png"
    plugin_id = "cpu_png_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            ok = bytes(data[:8]) == PNG_SIG
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                img, ps = decode_png(bytes(data))
                if not params.allow_any_depth and img.dtype == np.uint16:
                    img = (img >> 8).astype(np.uint8)
                out.append(DecodeResult(ProcessingStatus.SUCCESS, img))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


def register(registry) -> None:
    registry.codec("png").register_decoder(PngCpuDecoder())
    registry.codec("png").register_encoder(PngEncoder())
