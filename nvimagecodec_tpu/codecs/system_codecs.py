"""System-library fallback decoders (ctypes, loaded lazily at runtime).

The architectural analog of the reference's CPU fallback extensions, which
link the very same libraries (reference: extensions/libjpeg_turbo/,
extensions/libtiff/, extensions/opencv/ — all CPU_ONLY, LOW/NORMAL
priority, opencv_ext.cpp:38-44). Our own device/CPU implementations register
at higher priority; these only catch what they can't handle yet (e.g. WebP
lossy until the native VP8 path lands). Absent libraries degrade
gracefully — the plugin just doesn't register, like the reference's
plugin-load-failure path (src/plugin_framework.cpp:314-351).
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional

import numpy as np

from ..core.interfaces import DecodeParams, DecodeResult, DecoderPlugin
from ..core.types import (BackendKind, Priority, ProcessingStatus,
                          SampleDataType)


def _load(*names) -> Optional[ctypes.CDLL]:
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


_SHIM = [None]


def _sys_shim() -> ctypes.CDLL:
    """Lazily build + load the system-codec shim (libjpeg/libpng wrappers;
    native/optional/sys_codec_shim.cpp). Raises if the toolchain or the
    libraries are absent — callers degrade by not registering, like the
    reference's plugin-load-failure path (src/plugin_framework.cpp:314-351)."""
    if _SHIM[0] is not None:
        return _SHIM[0]
    import os
    import subprocess

    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "optional")
    src = os.path.join(d, "sys_codec_shim.cpp")
    so = os.path.join(d, "libtic_syscodec.so")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        r = subprocess.run(
            ["c++", "-O2", "-std=c++17", "-shared", "-fPIC", src, "-o", so,
             "-ljpeg", "-lpng"],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise ImportError(f"sys codec shim build failed:\n{r.stderr}")
    L = ctypes.CDLL(so)
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    i32p = ctypes.POINTER(ctypes.c_int)
    L.tic_sys_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, u8pp, i32p, i32p, i32p, i32p]
    L.tic_sys_jpeg_decode.restype = ctypes.c_int
    L.tic_sys_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, u8pp, i32p, i32p]
    L.tic_sys_png_decode.restype = ctypes.c_int
    L.tic_sys_free.argtypes = [ctypes.c_void_p]
    _SHIM[0] = L
    return L


class JpegSystemDecoder(DecoderPlugin):
    """JPEG last-resort fallback via system libjpeg — catches adversarial
    or out-of-spec streams the native entropy decoders reject but libjpeg
    tolerates, giving the JPEG ladder the same opencv-backstopped shape as
    the reference (extensions/opencv/opencv_ext.cpp:38-44, LOW priority)."""

    codec = "jpeg"
    plugin_id = "system_libjpeg_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.LOW

    # shim builds LAZILY on first decode attempt (a synchronous C++
    # compile during codec registration would tax every Decoder()
    # construction, fallback used or not); a failed build surfaces as
    # per-sample FAIL exactly like an absent rung would

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            ok = bytes(data[:2]) == b"\xff\xd8"
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def _decode_one(self, data: bytes) -> np.ndarray:
        L = _sys_shim()
        buf = ctypes.POINTER(ctypes.c_uint8)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ch = ctypes.c_int()
        adobe = ctypes.c_int()
        rc = L.tic_sys_jpeg_decode(data, len(data), ctypes.byref(buf),
                                   ctypes.byref(w), ctypes.byref(h),
                                   ctypes.byref(ch), ctypes.byref(adobe))
        if rc != 0:
            raise ValueError(f"libjpeg decode failed rc={rc}")
        try:
            arr = np.ctypeslib.as_array(
                buf, (h.value * w.value * ch.value,)).copy()
        finally:
            L.tic_sys_free(buf)
        img = arr.reshape(h.value, w.value, ch.value)
        if ch.value == 1:
            return img[..., 0]
        if ch.value == 4:
            cmyk = img.astype(np.uint16)
            if not adobe.value:
                # plain CMYK stores non-inverted ink values: invert first
                cmyk = 255 - cmyk
            # Adobe CMYK stores inverted values: R = C*K/255 directly
            return ((cmyk[..., :3] * cmyk[..., 3:4]) // 255).astype(np.uint8)
        return img

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(DecodeResult(
                    ProcessingStatus.SUCCESS, self._decode_one(bytes(data))))
            except Exception as e:
                out.append(DecodeResult(
                    ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                    error=str(e)))
        return out


class PngSystemDecoder(DecoderPlugin):
    """PNG last-resort fallback via system libpng's simplified read API.
    Output layout comes from the parsed IHDR (info_batch), never from
    pixel content."""

    codec = "png"
    plugin_id = "system_libpng_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.LOW

    # shim builds lazily on first decode attempt (see JpegSystemDecoder)

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data, info in zip(data_batch, info_batch):
            ok = bytes(data[:8]) == b"\x89PNG\r\n\x1a\n"
            # the simplified libpng API reads 8-bit only: reject 16-bit
            # streams rather than silently truncating what ImageInfo
            # advertises as 16-bit data
            if ok and info is not None and getattr(info, "planes", None):
                if int(getattr(info.planes[0], "sample_type", 0)) in (
                        int(SampleDataType.UINT16),
                        int(SampleDataType.INT16)):
                    ok = False
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def _decode_one(self, data: bytes, info) -> np.ndarray:
        L = _sys_shim()
        buf = ctypes.POINTER(ctypes.c_uint8)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = L.tic_sys_png_decode(data, len(data), ctypes.byref(buf),
                                  ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise ValueError(f"libpng decode failed rc={rc}")
        try:
            arr = np.ctypeslib.as_array(buf, (h.value * w.value * 4,)).copy()
        finally:
            L.tic_sys_free(buf)
        rgba = arr.reshape(h.value, w.value, 4)
        # channel layout from the parsed IHDR, not from pixel values
        nch = getattr(info, "num_planes", None) or 4
        if nch == 1:
            return np.ascontiguousarray(rgba[..., 0])
        if nch == 2:  # gray + alpha
            return np.ascontiguousarray(rgba[..., (0, 3)])
        if nch == 3:
            return np.ascontiguousarray(rgba[..., :3])
        return rgba

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                out.append(DecodeResult(
                    ProcessingStatus.SUCCESS,
                    self._decode_one(bytes(data), info)))
            except Exception as e:
                out.append(DecodeResult(
                    ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                    error=str(e)))
        return out


class WebpSystemDecoder(DecoderPlugin):
    """WebP decode via system libwebp (VP8 + VP8L + alpha/animation-less).

    Mirrors the reference's opencv webp decoder registration
    (extensions/opencv/opencv_ext.cpp:38-44, LOW priority).
    """

    codec = "webp"
    plugin_id = "system_webp_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.LOW

    def __init__(self):
        L = _load("libwebp.so.7", "libwebp.so")
        if L is None:
            raise ImportError("libwebp not available")
        L.WebPGetInfo.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        L.WebPGetInfo.restype = ctypes.c_int
        L.WebPDecodeRGBA.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        L.WebPDecodeRGBA.restype = ctypes.POINTER(ctypes.c_uint8)
        L.WebPFree.argtypes = [ctypes.c_void_p]
        self._L = L

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            head = bytes(data[:16])
            ok = head[:4] == b"RIFF" and head[8:12] == b"WEBP"
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def _decode_one(self, data: bytes, params: DecodeParams) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        buf = self._L.WebPDecodeRGBA(data, len(data), ctypes.byref(w), ctypes.byref(h))
        if not buf:
            raise ValueError("libwebp decode failed")
        try:
            arr = np.ctypeslib.as_array(buf, (h.value * w.value * 4,)).copy()
        finally:
            self._L.WebPFree(buf)
        img = arr.reshape(h.value, w.value, 4)
        # default output drops a fully-opaque alpha plane (the reference's
        # default I_RGB behavior, python/decoder.cpp:156-225)
        if (img[..., 3] == 255).all():
            img = np.ascontiguousarray(img[..., :3])
        return img

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(
                    DecodeResult(
                        ProcessingStatus.SUCCESS,
                        self._decode_one(bytes(data), params),
                    )
                )
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class OpjJpeg2kDecoder(DecoderPlugin):
    """JPEG2000 last-resort fallback via system libopenjp2 for stream
    features the native decoder rejects (subsampled or signed components,
    mixed HT/EBCOT code-block styles). Per-component COC/QCC overrides and
    plain HTJ2K are decoded natively (codestream.py, native/j2k_ht.cpp)
    and never reach this rung.
    The same lowest-rung pattern as the reference's opencv extension; the
    bridge self-validates its hand-declared ABI before registering
    (native/opj_bridge.py)."""

    codec = "jpeg2k"
    plugin_id = "system_openjpeg_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.LOW

    def __init__(self):
        from ..native import opj_bridge

        opj_bridge.lib()  # build + self-validate now; raises if unusable
        self._bridge = opj_bridge

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            head = bytes(data[:12])
            ok = head[:4] == b"\xff\x4f\xff\x51" or head[:8] == bytes.fromhex(
                "0000000c6a502020"
            )
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
                arr, prec, signed = self._bridge.decode(bytes(data))
                if signed:
                    arr = arr + (1 << (prec - 1))
                maxv = (1 << prec) - 1
                arr = np.clip(arr, 0, maxv)
                if prec <= 8:
                    img = arr.astype(np.uint8)
                else:
                    img = arr.astype(np.uint16)
                    if not params.allow_any_depth:
                        img = (img >> (prec - 8)).astype(np.uint8)
                if img.shape[-1] == 1:
                    img = img[..., 0]
                out.append(DecodeResult(ProcessingStatus.SUCCESS, img))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class TiffSystemDecoder(DecoderPlugin):
    """TIFF last-resort fallback via system libtiff's RGBA reader — covers
    any compression libtiff itself carries (e.g. old-style JPEG variants,
    SGI LogLuv, ThunderScan) that the native TIFF decoder rejects. The
    exact rung the reference's libtiff extension occupies
    (extensions/libtiff/libtiff_decoder.cpp), one step below our native
    strip/tile decoder."""

    codec = "tiff"
    plugin_id = "system_libtiff_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.LOW

    def __init__(self):
        L = _load("libtiff.so.6", "libtiff.so.5", "libtiff.so")
        if L is None:
            raise ImportError("libtiff not available")
        L.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        L.TIFFOpen.restype = ctypes.c_void_p
        L.TIFFClose.argtypes = [ctypes.c_void_p]
        L.TIFFGetField.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        L.TIFFReadRGBAImageOriented.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ]
        L.TIFFReadRGBAImageOriented.restype = ctypes.c_int
        L.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
        L.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
        L.TIFFSetErrorHandler(None)   # quiet: failures surface as rc=0
        L.TIFFSetWarningHandler(None)
        self._L = L

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            head = bytes(data[:4])
            ok = head in (b"II*\x00", b"MM\x00*")
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def _decode_one(self, data: bytes) -> np.ndarray:
        import os
        import tempfile

        L = self._L
        fd, path = tempfile.mkstemp(suffix=".tif")
        try:
            os.write(fd, data)
            os.close(fd)
            tif = L.TIFFOpen(path.encode(), b"r")
            if not tif:
                raise ValueError("libtiff cannot open stream")
            try:
                w = ctypes.c_uint32()
                h = ctypes.c_uint32()
                L.TIFFGetField(tif, 256, ctypes.byref(w))  # ImageWidth
                L.TIFFGetField(tif, 257, ctypes.byref(h))  # ImageLength
                if not (w.value and h.value):
                    raise ValueError("libtiff: bad dimensions")
                # output layout from the TAGS, not from decoded pixel
                # values — a color TIFF with coincidentally gray pixels
                # must still come back 3-channel
                spp = ctypes.c_uint16(0)
                photo = ctypes.c_uint16(0)
                xs_n = ctypes.c_uint16(0)
                xs_p = ctypes.POINTER(ctypes.c_uint16)()
                L.TIFFGetField(tif, 277, ctypes.byref(spp))    # SamplesPerPixel
                L.TIFFGetField(tif, 262, ctypes.byref(photo))  # Photometric
                L.TIFFGetField(tif, 338, ctypes.byref(xs_n),   # ExtraSamples
                               ctypes.byref(xs_p))
                raster = np.empty(h.value * w.value, np.uint32)
                rc = L.TIFFReadRGBAImageOriented(
                    tif, w.value, h.value,
                    raster.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    1, 0)  # ORIENTATION_TOPLEFT, stop on error
                if rc != 1:
                    raise ValueError("libtiff RGBA decode failed")
            finally:
                L.TIFFClose(tif)
        finally:
            os.unlink(path)
        rgba = raster.view(np.uint8).reshape(h.value, w.value, 4)
        gray = photo.value in (0, 1)  # min-is-white / min-is-black
        spp_v = spp.value or (1 if gray else 3)
        alpha = (xs_n.value > 0
                 or (gray and spp_v == 2)
                 or (photo.value == 2 and spp_v == 4))
        if gray and not alpha:
            return np.ascontiguousarray(rgba[..., 0])
        if gray and alpha:
            return np.ascontiguousarray(rgba[..., (0, 3)])
        if alpha:
            return np.ascontiguousarray(rgba)
        return np.ascontiguousarray(rgba[..., :3])

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(
                    DecodeResult(
                        ProcessingStatus.SUCCESS, self._decode_one(bytes(data))
                    )
                )
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


def register(registry) -> None:
    try:
        registry.codec("webp").register_decoder(WebpSystemDecoder())
    except ImportError:
        pass
    try:
        registry.codec("jpeg2k").register_decoder(OpjJpeg2kDecoder())
    except Exception:
        pass  # libopenjp2 absent or ABI validation failed
    try:
        registry.codec("tiff").register_decoder(TiffSystemDecoder())
    except Exception:
        pass  # libtiff absent
    try:
        registry.codec("jpeg").register_decoder(JpegSystemDecoder())
    except Exception:
        pass  # libjpeg absent or shim build failed
    try:
        registry.codec("png").register_decoder(PngSystemDecoder())
    except Exception:
        pass  # libpng absent or shim build failed
