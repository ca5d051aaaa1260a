"""Test configuration: force a virtual 8-device CPU mesh so sharding tests run
without accelerators (chip_smoke.py --multi runs the sharded paths on GPUs),
and build the synthesized encoded-image corpus (see tests/util.py for why the corpus is
synthesized rather than read from the reference's git-lfs stubs)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:  # registration already happened at interpreter start — override config
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from util import make_photo  # noqa: E402

CORPUS_DIR = pathlib.Path(__file__).parent / "_corpus"


@pytest.fixture(scope="session")
def photo():
    return make_photo(426, 640, seed=7)


@pytest.fixture(scope="session")
def photo_gray():
    return make_photo(426, 640, seed=7, channels=1)


@pytest.fixture(scope="session")
def corpus(photo, photo_gray):
    """Directory of synthesized encoded files mirroring the reference corpus
    layout (resources/{jpeg,png,bmp,pnm,webp}/...)."""
    import oracle

    import hashlib

    # corpus content is a function of the generator — regenerate when it changes
    gen_hash = hashlib.sha256(
        open(pathlib.Path(__file__).parent / "util.py", "rb").read()
    ).hexdigest()[:16]
    d = CORPUS_DIR
    stamp = d / ".complete"
    if stamp.exists() and stamp.read_text() == gen_hash:
        return d
    import shutil

    # only remove the subdirs this fixture owns — _corpus/htj2k is a
    # committed conformance corpus (see gen_htj2k_corpus.py), not generated
    for sub in ("jpeg", "png", "bmp", "pnm", "webp"):
        shutil.rmtree(d / sub, ignore_errors=True)
    (d / "jpeg" / "exif").mkdir(parents=True, exist_ok=True)
    (d / "png").mkdir(exist_ok=True)
    (d / "bmp").mkdir(exist_ok=True)
    (d / "pnm").mkdir(exist_ok=True)
    (d / "webp").mkdir(exist_ok=True)

    # --- jpeg: the reference's chroma matrix (resources/jpeg/generate.sh)
    for ss in ("410", "411", "420", "422", "440", "444"):
        (d / "jpeg" / f"photo_{ss}.jpg").write_bytes(
            oracle.jpeg_encode(photo, 90, ss)
        )
    (d / "jpeg" / "photo_gray.jpg").write_bytes(oracle.jpeg_encode(photo_gray, 90))
    (d / "jpeg" / "photo_progressive.jpg").write_bytes(
        oracle.jpeg_encode(photo, 90, "420", progressive=True)
    )
    (d / "jpeg" / "photo_optimized.jpg").write_bytes(
        oracle.jpeg_encode(photo, 90, "420", optimize=True)
    )
    (d / "jpeg" / "photo_restart.jpg").write_bytes(
        oracle.jpeg_encode(photo, 90, "420", restart_interval=8)
    )

    # --- png
    (d / "png" / "photo.png").write_bytes(oracle.png_encode(photo))
    (d / "png" / "photo_gray.png").write_bytes(oracle.png_encode(photo_gray))
    rgba = np.dstack([photo, (photo_gray // 2 + 64)])
    (d / "png" / "photo_alpha.png").write_bytes(oracle.png_encode(rgba))
    photo16 = (photo.astype(np.uint16) << 8) | photo.astype(np.uint16)
    (d / "png" / "photo_16bit.png").write_bytes(oracle.png_encode(photo16))

    # --- webp
    (d / "webp" / "photo_lossy.webp").write_bytes(oracle.webp_encode_rgb(photo, 80.0))
    (d / "webp" / "photo_lossless.webp").write_bytes(
        oracle.webp_encode_rgb(photo, lossless=True)
    )

    # --- bmp / pnm written by our own encoders (simple containers; their
    # correctness is pinned by the hand-built cases in test_bmp_pnm.py)
    from nvimagecodec_tpu.codecs.bmp import encode_bmp
    from nvimagecodec_tpu.codecs.pnm import encode_pnm

    (d / "bmp" / "photo.bmp").write_bytes(encode_bmp(photo))
    (d / "bmp" / "photo_gray.bmp").write_bytes(encode_bmp(photo_gray))
    (d / "pnm" / "photo.ppm").write_bytes(encode_pnm(photo))
    (d / "pnm" / "photo_gray.pgm").write_bytes(encode_pnm(photo_gray))

    stamp.write_text(gen_hash)
    return d
