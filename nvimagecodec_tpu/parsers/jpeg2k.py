"""JPEG 2000 header parser.

Counterpart of src/parsers/jpeg2k.cpp (485 LoC): JP2 signature box
or raw SOC codestream detection (jpeg2k.cpp:34-35); JP2 box walk (ihdr/colr,
:216-278); codestream SIZ parse — X/Y/XO/YO/CSiz and per-component
Ssiz/XRSiz/YRSiz → dtype + chroma (:280-356). Unlike the reference (which
skips XTSiz/YTSiz, :305-308) we also record the tile grid, because tiles are
our context-parallel sharding axis (SURVEY.md §5).
"""
from __future__ import annotations

import struct

from ..core.image_info import ImageInfo, PlaneInfo
from ..core.interfaces import ParserPlugin
from ..core.types import (
    ChromaSubsampling,
    ColorSpec,
    Priority,
    SampleDataType,
    SampleFormat,
)

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
SOC = b"\xff\x4f"
SIZ = 0xFF51


def _parse_siz(cs: bytes) -> dict:
    """Parse the SIZ segment of a raw codestream starting at SOC."""
    if cs[:2] != SOC:
        raise ValueError("J2K: missing SOC")
    if cs[2:4] != b"\xff\x51":
        raise ValueError("J2K: missing SIZ")
    (lsiz,) = struct.unpack_from(">H", cs, 4)
    (rsiz, xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz, csiz) = (
        struct.unpack_from(">HIIIIIIIIH", cs, 6)
    )
    comps = []
    for c in range(csiz):
        ssiz, xrsiz, yrsiz = struct.unpack_from(">BBB", cs, 42 + 3 * c)
        signed = bool(ssiz & 0x80)
        depth = (ssiz & 0x7F) + 1
        comps.append({"depth": depth, "signed": signed, "xr": xrsiz, "yr": yrsiz})
    return {
        "rsiz": rsiz,
        "width": xsiz - xosiz,
        "height": ysiz - yosiz,
        "tile_w": xtsiz,
        "tile_h": ytsiz,
        "tile_ox": xtosiz,
        "tile_oy": ytosiz,
        "comps": comps,
    }


def jp2_color_info(raw: bytes):
    """(method, enum_cs) of the first colr box inside the jp2h superbox —
    enum_cs is meaningful only for method 1 — or None for raw codestreams
    and JP2 files without one. Real box walk (incl. XLBox extended sizes),
    matching the reference's jp2h descent
    (src/parsers/jpeg2k.cpp:216-268)."""
    if raw[:12] != JP2_SIGNATURE:
        return None
    n = len(raw)
    pos = 0
    while pos + 8 <= n:
        (size,) = struct.unpack_from(">I", raw, pos)
        btype = raw[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:  # extended size
            if pos + 16 > n:
                return None
            (size,) = struct.unpack_from(">Q", raw, pos + 8)
            hdr = 16
        elif size == 0:
            size = n - pos
        if btype == b"jp2h":
            sp = pos + hdr
            send = min(pos + size, n)
            while sp + 8 <= send:
                (ssize,) = struct.unpack_from(">I", raw, sp)
                stype = raw[sp + 4 : sp + 8]
                shdr = 8
                if ssize == 1:
                    if sp + 16 > send:
                        return None
                    (ssize,) = struct.unpack_from(">Q", raw, sp + 8)
                    shdr = 16
                elif ssize == 0:
                    ssize = send - sp
                if stype == b"colr" and sp + shdr + 3 <= send:
                    meth = raw[sp + shdr]
                    enum_cs = None
                    if sp + shdr + 7 <= send:
                        (enum_cs,) = struct.unpack_from(
                            ">I", raw, sp + shdr + 3)
                    return (meth, enum_cs)
                if ssize < 8:
                    return None
                sp += ssize
            return None
        if btype == b"jp2c":
            return None  # header boxes precede the codestream
        if size < 8:
            return None
        pos += size
    return None


class Jpeg2kParser(ParserPlugin):
    codec = "jpeg2k"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        if len(data) < 12:
            return False
        b = bytes(data[:12])
        return b == JP2_SIGNATURE or b[:2] == SOC

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data)
        stream_type = "j2k"
        cs_off = 0
        if raw[:12] == JP2_SIGNATURE:
            stream_type = "jp2"
            # Box walk to find the jp2c (contiguous codestream) box
            # (reference: jpeg2k.cpp:216-278).
            pos = 0
            cs_off = None
            while pos + 8 <= len(raw):
                (size,) = struct.unpack_from(">I", raw, pos)
                btype = raw[pos + 4 : pos + 8]
                hdr = 8
                if size == 1:  # extended size
                    (size,) = struct.unpack_from(">Q", raw, pos + 8)
                    hdr = 16
                elif size == 0:
                    size = len(raw) - pos
                if btype == b"jp2c":
                    cs_off = pos + hdr
                    break
                pos += size
            if cs_off is None:
                raise ValueError("JP2: no codestream box")

        siz = _parse_siz(raw[cs_off:])
        comps = siz["comps"]
        ncomp = len(comps)
        depth = comps[0]["depth"]
        signed = comps[0]["signed"]
        if depth <= 8:
            st = SampleDataType.INT8 if signed else SampleDataType.UINT8
        elif depth <= 16:
            st = SampleDataType.INT16 if signed else SampleDataType.UINT16
        else:
            st = SampleDataType.INT32 if signed else SampleDataType.UINT32
        precision = depth if depth not in (8, 16, 32) else 0

        # chroma from XRSiz/YRSiz ratios (reference: jpeg2k.cpp:280-356)
        if ncomp == 1:
            css = ChromaSubsampling.GRAY
        elif ncomp >= 3:
            r = (comps[1]["xr"] // comps[0]["xr"], comps[1]["yr"] // comps[0]["yr"])
            css = {
                (1, 1): ChromaSubsampling.CSS_444,
                (2, 1): ChromaSubsampling.CSS_422,
                (2, 2): ChromaSubsampling.CSS_420,
            }.get(r, ChromaSubsampling.CSS_444)
        else:
            css = ChromaSubsampling.NONE

        h, w = siz["height"], siz["width"]
        planes = tuple(
            PlaneInfo(
                height=(h + c["yr"] - 1) // c["yr"],
                width=(w + c["xr"] - 1) // c["xr"],
                num_channels=1,
                sample_type=st,
                precision=precision,
            )
            for c in comps
        )
        gray = ncomp == 1
        # colr box → color_spec: enumCS 16/17/18 → SRGB/GRAY/SYCC, ICC
        # (method 2) and unknown enums → UNSUPPORTED
        # (reference: src/parsers/jpeg2k.cpp:246-268)
        color = ColorSpec.GRAY if gray else ColorSpec.SRGB
        if stream_type == "jp2":
            ci = jp2_color_info(raw)
            if ci is not None:
                meth, enum_cs = ci
                if meth == 1:
                    color = {
                        16: ColorSpec.SRGB,
                        17: ColorSpec.GRAY,
                        18: ColorSpec.SYCC,
                    }.get(enum_cs, ColorSpec.UNSUPPORTED)
                elif meth == 2:
                    color = ColorSpec.UNSUPPORTED
        return ImageInfo(
            codec=self.codec,
            height=h,
            width=w,
            num_planes=ncomp,
            planes=planes,
            sample_format=SampleFormat.P_Y if gray else SampleFormat.I_RGB,
            color_spec=color,
            chroma_subsampling=css,
            extras={
                "j2k_stream_type": stream_type,
                "j2k_codestream_offset": cs_off,
                "j2k_tile_w": siz["tile_w"],
                "j2k_tile_h": siz["tile_h"],
                "j2k_rsiz": siz["rsiz"],
            },
        )
