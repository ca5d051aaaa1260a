"""Builtin codec backends (the analog of the reference's extensions/ tree,
SURVEY.md §2.3). Each module registers decoder/encoder plugins with
priorities; the scheduler's fallback chain walks them in priority order."""
from __future__ import annotations


def register_builtin_codecs(registry) -> None:
    from .bmp import BmpDecoder, BmpEncoder
    from .pnm import PnmDecoder, PnmEncoder

    registry.codec("bmp").register_decoder(BmpDecoder())
    registry.codec("bmp").register_encoder(BmpEncoder())
    registry.codec("pnm").register_decoder(PnmDecoder())
    registry.codec("pnm").register_encoder(PnmEncoder())

    # JPEG backends: device hybrid first, CPU fallback after
    # (reference ladder: nvjpeg HW → CUDA → libjpeg_turbo → opencv).
    try:
        from .jpeg import register as register_jpeg

        register_jpeg(registry)
    except ImportError:
        pass

    try:
        from .png import register as register_png

        register_png(registry)
    except ImportError:
        pass

    try:
        from .tiff import register as register_tiff

        register_tiff(registry)
    except ImportError:
        pass

    try:
        from .jpeg2000 import register as register_j2k

        register_j2k(registry)
    except ImportError:
        pass

    try:
        from .webp import register as register_webp

        register_webp(registry)
    except ImportError:
        pass

    # system-library fallbacks (lowest rung of the priority ladder, like the
    # reference's opencv extension)
    try:
        from .system_codecs import register as register_system

        register_system(registry)
    except ImportError:
        pass
