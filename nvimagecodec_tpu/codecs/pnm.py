"""PNM (PBM/PGM/PPM) decode/encode (CPU backend).

Counterpart of the reference PNM writer
(reference: extensions/nvpnm/encoder.cpp — PPM/PGM/PBM writer) plus a decoder
(the reference decodes PNM via its OpenCV fallback,
extensions/opencv/opencv_decoder.cpp). Pixels are raw; numpy is the right
tool, no device kernel needed.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeParams,
    EncodeResult,
    EncoderPlugin,
)
from ..core.types import BackendKind, Priority, ProcessingStatus
from ..parsers.pnm import _tokens


def decode_pnm(data: memoryview) -> np.ndarray:
    raw = bytes(data)
    # Header scan: magic, dims, maxval (binary data follows single whitespace).
    it = _tokens(raw)
    magic = next(it)
    kind = int(magic[1:2])
    w = int(next(it))
    h = int(next(it))
    maxval = 1 if kind in (1, 4) else int(next(it))
    nch = 3 if kind in (3, 6) else 1

    if kind <= 3:  # ASCII variants
        vals = []
        # restart token iteration to consume remaining numeric tokens
        toks = list(_tokens(raw))
        skip = 3 if kind == 1 else 4
        vals = [int(t) for t in toks[skip:]]
        arr = np.array(vals, np.uint16 if maxval > 255 else np.uint8)
        if kind == 1:
            arr = (1 - arr).astype(np.uint8) * 255  # 1=black in PBM
            return arr.reshape(h, w)
        arr = arr.reshape(h, w, nch) if nch == 3 else arr.reshape(h, w)
        return arr
    # Binary variants: find data offset = position after maxval token + 1 ws
    # Walk the header manually to locate the pixel data start.
    pos = 2
    fields_needed = 2 if kind == 4 else 3
    found = 0
    while found < fields_needed:
        while pos < len(raw) and raw[pos : pos + 1].isspace():
            pos += 1
        if raw[pos : pos + 1] == b"#":
            while pos < len(raw) and raw[pos : pos + 1] != b"\n":
                pos += 1
            continue
        while pos < len(raw) and not raw[pos : pos + 1].isspace():
            pos += 1
        found += 1
    pos += 1  # single whitespace after header

    if kind == 4:  # packed bitmap
        row_bytes = (w + 7) // 8
        rows = np.frombuffer(raw, np.uint8, row_bytes * h, pos).reshape(h, row_bytes)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return ((1 - bits) * 255).astype(np.uint8)
    if maxval > 255:
        arr = np.frombuffer(raw, ">u2", h * w * nch, pos).astype(np.uint16)
    else:
        arr = np.frombuffer(raw, np.uint8, h * w * nch, pos)
    return arr.reshape(h, w, nch) if nch == 3 else arr.reshape(h, w)


def encode_pnm(img: np.ndarray, maxval: int | None = None) -> bytes:
    """Binary PPM (P6) / PGM (P5) writer (reference: extensions/nvpnm/encoder.cpp)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if img.dtype == np.uint8:
        mv = maxval or 255
        body = img.astype(np.uint8).tobytes()
    elif img.dtype == np.uint16:
        mv = maxval or 65535
        body = img.astype(">u2").tobytes()
    else:
        raise ValueError(f"PNM encoder: unsupported dtype {img.dtype}")
    if c == 1:
        header = f"P5\n{w} {h}\n{mv}\n".encode()
    elif c == 3:
        header = f"P6\n{w} {h}\n{mv}\n".encode()
    else:
        raise ValueError("PNM encoder supports 1 or 3 channels")
    return header + body


class PnmDecoder(DecoderPlugin):
    codec = "pnm"
    plugin_id = "tpu_pnm_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        return [ProcessingStatus.SUCCESS] * len(data_batch)

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(DecodeResult(ProcessingStatus.SUCCESS, decode_pnm(data)))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class PnmEncoder(EncoderPlugin):
    codec = "pnm"
    plugin_id = "tpu_pnm_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_encode(self, image_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for img in image_batch:
            dt = np.asarray(img).dtype
            ok = dt in (np.dtype(np.uint8), np.dtype(np.uint16))
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        out = []
        for img in image_batch:
            try:
                out.append(
                    EncodeResult(ProcessingStatus.SUCCESS, encode_pnm(np.asarray(img)))
                )
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out
