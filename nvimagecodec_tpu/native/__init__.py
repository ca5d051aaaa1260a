"""Native (C++) runtime components, built on demand with the system compiler.

The reference ships its runtime as C++ (src/ → libnvimgcodec.so); our native
layer covers the pieces where Python costs real time: JPEG entropy
encode/decode (the host stage of the hybrid device pipeline). Built lazily into
libimgcodec.so next to the sources; rebuilt when any source changes.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libimgcodec.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# the library's translation units (optional/ holds separately built shims)
_SOURCES = (
    "j2k_block_batch.cpp", "j2k_finish.cpp", "j2k_ht.cpp", "j2k_idwt.cpp",
    "j2k_t1.cpp", "j2k_t2.cpp", "jpeg_arith.cpp", "jpeg_encode_fast.cpp",
    "jpeg_encode_pixels.cpp", "jpeg_entropy.cpp", "jpeg_huffman_encode.cpp",
    "jpeg_lossless.cpp", "png_defilter.cpp", "tiff_fax.cpp", "tiff_lzw.cpp",
    "webp_vp8.cpp", "webp_vp8_encode.cpp",
)


def _sources():
    return [os.path.join(_DIR, f) for f in _SOURCES]


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_m = os.path.getmtime(_SO)
    return any(os.path.getmtime(s) > so_m for s in _sources())


def build() -> None:
    cmd = [
        "c++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", *_sources(), "-o", _SO,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native build failed:\n{r.stderr}")


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if _needs_build():
                build()
            L = ctypes.CDLL(_SO)
            _declare(L)
            _lib = L
        return _lib


c_i16p = ctypes.POINTER(ctypes.c_int16)


def _declare(L: ctypes.CDLL) -> None:
    L.tic_free.argtypes = [ctypes.c_void_p]
    L.tic_jpeg_decode_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_jpeg_decode_coefficients.restype = ctypes.c_int
    L.tic_jpeg_decode_coefficients_into.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    L.tic_jpeg_decode_coefficients_into.restype = ctypes.c_int
    L.tic_jpeg_decode_coefficients_roi_into.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    L.tic_jpeg_decode_coefficients_roi_into.restype = ctypes.c_int
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    L.tic_jpeg_decode_coefficients_packed.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8) * 4, ctypes.POINTER(ctypes.c_int8) * 4,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    L.tic_jpeg_decode_coefficients_packed.restype = ctypes.c_int
    L.tic_jpeg_pack_coefficients.argtypes = [
        c_i16p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int8),
    ]
    L.tic_jpeg_pack_coefficients.restype = ctypes.c_int
    L.tic_jpeg_split_segments.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    L.tic_jpeg_split_segments.restype = ctypes.c_int
    L.tic_jpeg_encode_pixels.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        c_i16p * 4, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_jpeg_encode_pixels.restype = ctypes.c_int
    L.tic_jpeg_count_symbols.argtypes = [
        ctypes.c_int, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(c_i16p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    L.tic_jpeg_count_symbols.restype = ctypes.c_int
    L.tic_jpeg_encode_scan.argtypes = [
        ctypes.c_int, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(c_i16p),
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    L.tic_jpeg_encode_scan.restype = ctypes.c_int
    L.tic_jpeg_encode_baseline.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, c_i32p, c_i32p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p, c_i32p, c_i32p, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    L.tic_jpeg_encode_baseline.restype = ctypes.c_int
    L.tic_png_defilter.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    L.tic_png_defilter.restype = ctypes.c_int
    L.tic_tiff_lzw_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    L.tic_tiff_lzw_decode.restype = ctypes.c_int64
    L.tic_tiff_fax_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
    ]
    L.tic_tiff_fax_decode.restype = ctypes.c_int32
    L.tic_fdwt53.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    L.tic_fdwt53.restype = ctypes.c_int
    L.tic_jpeg_arith_decode_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_jpeg_arith_decode_coefficients.restype = ctypes.c_int
    L.tic_j2k_t1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_j2k_t1_decode.restype = ctypes.c_int
    _i32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
    for _fn in (L.tic_t1_decode_batch_into, L.tic_ht_decode_batch_into):
        _fn.argtypes = [
            ctypes.c_int32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), _i32pp,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _fn.restype = ctypes.c_int
    L.tic_j2k_rct_shift_u8.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    L.tic_j2k_rct_shift_u8.restype = ctypes.c_int
    L.tic_j2k_shift_u8.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    L.tic_j2k_shift_u8.restype = ctypes.c_int
    L.tic_j2k_t1_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ]
    L.tic_j2k_t1_encode.restype = ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    L.tic_vp8_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, u8p, u8p, u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    L.tic_vp8_decode.restype = ctypes.c_int
    L.tic_vp8_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_vp8_encode.restype = ctypes.c_int
    L.tic_ht_decode_block.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_ht_decode_block.restype = ctypes.c_int
    L.tic_ht_encode_block.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_ht_encode_block.restype = ctypes.c_int
    L.tic_jpeg_lossless_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    L.tic_jpeg_lossless_decode.restype = ctypes.c_int
