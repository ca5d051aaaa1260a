"""Plugin framework: builtin + external codec module registration.

Counterpart of the reference PluginFramework
(reference: src/plugin_framework.cpp:94-433 — extension discovery from
NVIMGCODEC_EXTENSIONS_PATH, entry-symbol load, versioned dedup;
src/builtin_modules.cpp:25-34 — builtin parser extension).

Extensions here are Python modules exposing `register(registry)`. External
extensions are discovered from the `TPUIMGCODEC_EXTENSIONS_PATH` env var
(colon-separated import paths or file paths); a leading `~` in a name disables
it, matching the reference's disabled-extension convention
(src/plugin_framework.cpp:281-284).
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys
from typing import Set

from .logger import get_logger
from .registry import CodecRegistry

log = get_logger(__name__)

_loaded_extensions: Set[str] = set()


def register_builtin_modules(registry: CodecRegistry) -> None:
    """Register builtin parsers and codec backends
    (reference: NvImgCodecDirector ctor registers builtin parsers then
    discovers extensions, src/nvimgcodec_director.cpp:30-66)."""
    from ..parsers import ALL_PARSERS

    for parser_cls in ALL_PARSERS:
        p = parser_cls()
        registry.codec(p.codec).register_parser(p)

    # Builtin codec backends (the analog of the reference's extensions/ tree).
    from ..codecs import register_builtin_codecs

    register_builtin_codecs(registry)

    discover_and_load_extensions(registry)


def discover_and_load_extensions(registry: CodecRegistry) -> None:
    """Load external extensions from TPUIMGCODEC_EXTENSIONS_PATH
    (reference: discoverAndLoadExtModules, src/plugin_framework.cpp:286-307)."""
    path = os.environ.get("TPUIMGCODEC_EXTENSIONS_PATH", "")
    for entry in filter(None, path.split(":")):
        name = os.path.basename(entry)
        if name.startswith("~"):  # disabled (reference: :281-284)
            log.info("extension %s disabled by ~ prefix", entry)
            continue
        if entry in _loaded_extensions:
            continue
        try:
            if os.path.isfile(entry) and entry.endswith(".py"):
                spec = importlib.util.spec_from_file_location(
                    f"tpuimgcodec_ext_{name[:-3]}", entry
                )
                mod = importlib.util.module_from_spec(spec)
                sys.modules[spec.name] = mod
                spec.loader.exec_module(mod)
            else:
                mod = importlib.import_module(entry)
            entry_fn = getattr(mod, "register", None)
            if entry_fn is None:
                log.warning("extension %s has no register(registry) entry", entry)
                continue
            entry_fn(registry)
            _loaded_extensions.add(entry)
            log.info("loaded extension %s", entry)
        except Exception as e:  # load failures are logged and skipped
            # (reference: src/plugin_framework.cpp:314-351)
            log.warning("failed to load extension %s: %s", entry, e)
