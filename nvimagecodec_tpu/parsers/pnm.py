"""PNM (PBM/PGM/PPM) header parser.

Counterpart of src/parsers/pnm.cpp (321 LoC): P1..P6 ascii/binary
variants, maxval → dtype.
"""
from __future__ import annotations

from ..core.image_info import ImageInfo, make_planes
from ..core.interfaces import ParserPlugin
from ..core.types import (
    ChromaSubsampling,
    ColorSpec,
    Priority,
    SampleDataType,
    SampleFormat,
)


def _tokens(raw: bytes):
    """Yield whitespace-separated tokens, skipping '#' comments."""
    i, n = 0, len(raw)
    while i < n:
        c = raw[i : i + 1]
        if c.isspace():
            i += 1
        elif c == b"#":
            while i < n and raw[i : i + 1] != b"\n":
                i += 1
        else:
            j = i
            while j < n and not raw[j : j + 1].isspace():
                j += 1
            yield raw[i:j]
            i = j


class PnmParser(ParserPlugin):
    codec = "pnm"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        if len(data) < 3:
            return False
        b = bytes(data[:3])
        return b[0:1] == b"P" and b[1] in b"123456" and b[2:3].isspace()

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data[:4096])
        toks = _tokens(raw)
        magic = next(toks)
        kind = int(magic[1:2])
        w = int(next(toks))
        h = int(next(toks))
        if kind in (1, 4):  # PBM: bitmap, no maxval
            maxval = 1
        else:
            maxval = int(next(toks))
        nch = 3 if kind in (3, 6) else 1
        st = SampleDataType.UINT16 if maxval > 255 else SampleDataType.UINT8
        precision = max(1, maxval.bit_length()) if maxval not in (255, 65535) else 0
        gray = nch == 1
        return ImageInfo(
            codec=self.codec,
            height=h,
            width=w,
            num_planes=nch,
            planes=make_planes(h, w, nch, st, precision),
            sample_format=SampleFormat.P_Y if gray else SampleFormat.I_RGB,
            color_spec=ColorSpec.GRAY if gray else ColorSpec.SRGB,
            chroma_subsampling=ChromaSubsampling.GRAY if gray else ChromaSubsampling.NONE,
            extras={"pnm_kind": kind, "pnm_maxval": maxval},
        )
