#!/usr/bin/env python
"""Headline benchmark: JPEG 4:2:0 ImageNet-size decode images/s/chip.

Metric per BASELINE.json. The reference publishes no numbers (BASELINE.md),
so vs_baseline is measured against libjpeg-turbo's single-threaded decode of
the same corpus on this host — the strongest locally measurable reference
decoder (the role OpenCV/libjpeg play as the reference's own CPU fallback).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

After the headline JSON, informational sections run in this same process
(one JAX process per card: a second one could not reserve the card's
memory); `bench.py --section NAME` runs one alone.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

# persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, else a fixed
# path in the repo (the path is part of the cache key)
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
)

N_IMAGES = 512
H, W = 375, 500  # ImageNet-ish
QUALITY = 85
BATCH = 256


def log(*a):
    print(*a, file=sys.stderr)


def _median(xs):
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])


def _build_corpus(restart_interval: int = 0):
    """Deterministic corpus (seeded): the system libjpeg oracle encodes it
    when it builds, else this repo's own encoder."""
    from util import jpeg_corpus

    return jpeg_corpus(N_IMAGES, H, W, QUALITY,
                       restart_interval=restart_interval)


def _force(img):
    """Force device completion without fetching (outputs stay on the device
    for the input pipeline that consumes them). A host array means the
    decode did not run on the device: that is an error here."""
    import jax

    a = img.array
    if not isinstance(a, jax.Array):
        raise TypeError(f"decode returned a host array ({type(a).__name__})")
    jax.block_until_ready(a)


def main() -> None:
    base, jpgs, have_oracle = _build_corpus()

    from nvimagecodec_tpu import Decoder, pipeline

    dec = Decoder()

    # --- warmup (jit compile) ------------------------------------------------
    log("warmup...")
    t0 = time.perf_counter()
    out = dec.decode(jpgs[:BATCH])
    assert all(o is not None for o in out), "warmup decode failed"
    _force(out[-1])
    log(f"warmup done in {time.perf_counter() - t0:.1f}s")

    # --- timed decode ------------------------------------------------------
    # depth-2 pipeline: host stage of batch N overlaps device compute of
    # batch N-1 (jax dispatch is async; force is completion-only).
    def one_pass():
        t0 = time.perf_counter()
        decoded = 0
        batches = (jpgs[i:i + BATCH] for i in range(0, N_IMAGES, BATCH))
        for outs in pipeline.decode_batches(batches, decoder=dec,
                                            drop_failed=False):
            for o in outs:
                assert o is not None
            decoded += len(outs)
        return decoded / (time.perf_counter() - t0)

    # interleaved A/B protocol: ours and the baseline alternate within the
    # same minute so host drift hits both sides equally; median + spread
    # reported alongside best
    from nvimagecodec_tpu.core import trace as _trace

    def base_pass():
        import oracle

        t0 = time.perf_counter()
        for j in jpgs[:256]:
            oracle.jpeg_decode(j)
        return 256 / (time.perf_counter() - t0)

    passes = []
    base_passes = []
    device_wait_s = 0.0
    h2d_bytes = 0
    wall_s = 0.0
    for _i in range(5):
        _trace.start_collect()
        t0 = time.perf_counter()
        passes.append(one_pass())
        wall_s += time.perf_counter() - t0
        col = _trace.stop_collect()
        device_wait_s += col["spans"].get("imgcodec.pipeline.device_wait", 0.0)
        h2d_bytes += col["counters"].get("imgcodec.jpeg.h2d_bytes", 0)
        if have_oracle:
            base_passes.append(base_pass())
    ips = max(passes)
    ips_median = _median(passes)
    spread = max(passes) - min(passes)
    device_ms_frac = device_wait_s / max(wall_s, 1e-9)
    log(f"decode: best of 5 interleaved passes -> {ips:.1f} img/s, "
        f"median {ips_median:.1f} +/- spread {spread:.1f} "
        f"(all: {[round(p, 1) for p in passes]})")
    log(f"device-stage attribution: wire H2D "
        f"{h2d_bytes / max(wall_s, 1e-9) / 1e6:.0f} MB/s "
        f"({h2d_bytes >> 20} MiB over {wall_s:.1f} s), device-completion "
        f"wait {device_wait_s:.2f} s ({device_ms_frac:.1%} of wall)")

    # --- encode throughput + libjpeg-turbo 1-thread encode baseline --------
    encode_ips = encode_vs = None
    try:
        from nvimagecodec_tpu import Encoder
        from nvimagecodec_tpu.core.interfaces import EncodeParams

        enc = Encoder()
        eparams = EncodeParams(quality=85, chroma_subsampling="420")
        enc.encode(base, codec="jpeg", params=eparams)  # warm

        def enc_pass():
            t0 = time.perf_counter()
            outs = enc.encode(base * 8, codec="jpeg", params=eparams)
            n_ok = sum(o is not None for o in outs)
            assert n_ok == len(base) * 8
            return n_ok / (time.perf_counter() - t0)

        enc_passes = [enc_pass() for _ in range(3)]
        encode_ips = max(enc_passes)
        log(f"jpeg encode: best of 3 -> {encode_ips:.1f} img/s "
            f"(all: {[round(p, 1) for p in enc_passes]})")
        if have_oracle:
            import oracle

            def enc_base_pass():
                t0 = time.perf_counter()
                for img in base * 8:
                    oracle.jpeg_encode(img, 85, "420")
                return len(base) * 8 / (time.perf_counter() - t0)

            eb_passes = [enc_base_pass() for _ in range(3)]
            log(f"libjpeg-turbo 1-thread encode: best of 3 -> "
                f"{max(eb_passes):.1f} img/s "
                f"(all: {[round(p, 1) for p in eb_passes]})")
            encode_vs = encode_ips / max(eb_passes)
            log(f"encode vs baseline: {encode_vs:.3f}")
    except Exception as e:
        log("encode bench skipped:", e)

    # --- baseline summary (passes already interleaved with ours above) ----
    vs = vs_median = None
    vs_paired = None
    if base_passes:
        base_ips = max(base_passes)
        log(f"libjpeg-turbo 1-thread: best of 5 interleaved -> "
            f"{base_ips:.1f} img/s, median {_median(base_passes):.1f} "
            f"(all: {[round(p, 1) for p in base_passes]})")
        vs = ips / base_ips
        vs_median = ips_median / _median(base_passes)
        # per-round ratio median: each pass is paired with the baseline pass
        # that ran seconds later, so host drift cancels within the pair
        ratios = [t / b for t, b in zip(passes, base_passes)]
        vs_paired = _median(ratios)
        log(f"decode vs baseline: best/best {vs:.3f}, "
            f"median/median {vs_median:.3f}, paired-ratio median "
            f"{vs_paired:.3f} (ratios: {[round(r, 3) for r in ratios]})")

    print(
        json.dumps(
            {
                "metric": "jpeg420_decode_imagenet_size",
                "value": round(ips, 1),
                "unit": "images/s/chip",
                "vs_baseline": round(vs, 3) if vs else None,
                "vs_baseline_median": round(vs_median, 3) if vs_median else None,
                "vs_baseline_paired": round(vs_paired, 3) if vs_paired else None,
                "median": round(ips_median, 1),
                "spread": round(spread, 1),
                "device_ms_frac": round(device_ms_frac, 3),
                "h2d_mib": h2d_bytes >> 20,
                "passes": [round(p, 1) for p in passes],
                "baseline_passes": [round(p, 1) for p in base_passes],
                "encode_value": round(encode_ips, 1) if encode_ips else None,
                "encode_vs_baseline": round(encode_vs, 3) if encode_vs else None,
            }
        )
    )
    sys.stdout.flush()

    # --- informational sections (stderr only), AFTER the headline JSON
    for name in SECTIONS:
        _run_section(name)


# --------------------------------------------------------------------------
# informational sections — each runnable standalone via --section NAME
# --------------------------------------------------------------------------

def section_scaling() -> None:
    """CPU-only: virtual 8-device mesh scaling audit (bench_scaling.py)."""
    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "bench_scaling.py")],
        capture_output=True, text=True, timeout=240,
        env={k: v for k, v in os.environ.items()
             if k not in ("XLA_FLAGS", "JAX_PLATFORMS")},
    )
    for line in (r.stderr + r.stdout).splitlines():
        log("scaling |", line)


def section_j2k_host() -> None:
    """CPU-only: J2K + HTJ2K decode/encode vs single-thread openjpeg
    (our native EBCOT/HT T1 over the thread pool vs libopenjp2); the
    reference gets these codecs from nvjpeg2k."""
    from util import make_photo

    from nvimagecodec_tpu.codecs.jpeg2000.core import decode_j2k, encode_j2k
    from nvimagecodec_tpu.native import opj_bridge

    big = make_photo(1024, 1024, seed=3)

    def _rate(fn, budget=2.0, min_iters=10):
        # slow contenders (~4 img/s) get too few samples in one budget
        # window — enforce a minimum iteration count for stable ratios
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < budget or n < min_iters:
            fn()
            n += 1
        return n / (time.perf_counter() - t0)

    for label, kw in (("j2k", {}), ("htj2k", {"ht": True})):
        stream = encode_j2k(big, reversible=True, levels=5,
                            stream_type="j2k", **kw)
        decode_j2k(stream)  # warm
        decode_j2k(stream, num_threads=1)
        opj_bridge.decode(stream)  # warm + validates it decodes there
        # interleaved rounds, PAIRED-RATIO MEDIANS: each round's ours/opj
        # ratio cancels host-load drift within the round (same estimator
        # as the headline; a single best-of ratio carries ±10% noise —
        # r4 verdict weak #5)
        r1s, rfs, opjs = [], [], []
        for _r in range(4):
            r1s.append(_rate(lambda: decode_j2k(stream, num_threads=1)))
            opjs.append(_rate(lambda: opj_bridge.decode(stream)))
            rfs.append(_rate(lambda: decode_j2k(stream)))
        x1 = _median([a / b for a, b in zip(r1s, opjs)])
        xf = _median([a / b for a, b in zip(rfs, opjs)])
        log(f"{label} decode 1024x1024 rev: ours-1t {max(r1s):.2f} "
            f"(x{x1:.2f} equal-thread paired-median), ours-free "
            f"{max(rfs):.2f} (x{xf:.2f}) vs openjpeg-1t {max(opjs):.2f} "
            f"img/s (ratios: {[round(a / b, 2) for a, b in zip(r1s, opjs)]})")
        e1s, efs, oes = [], [], []
        for _r in range(4):
            e1s.append(_rate(lambda: encode_j2k(
                big, reversible=True, levels=5, stream_type="j2k",
                num_threads=1, **kw)))
            oes.append(_rate(lambda: opj_bridge.encode_lossless(big)))
            efs.append(_rate(lambda: encode_j2k(
                big, reversible=True, levels=5, stream_type="j2k", **kw)))
        x1 = _median([a / b for a, b in zip(e1s, oes)])
        xf = _median([a / b for a, b in zip(efs, oes)])
        log(f"{label} encode 1024x1024 rev: ours-1t {max(e1s):.2f} "
            f"(x{x1:.2f} equal-thread paired-median), ours-free "
            f"{max(efs):.2f} (x{xf:.2f}) vs openjpeg-1t {max(oes):.2f} "
            f"img/s (ratios: {[round(a / b, 2) for a, b in zip(e1s, oes)]})")


def _corpus_pass(jpgs, dec, pipeline):
    t0 = time.perf_counter()
    decoded = 0
    last = None
    batches = (jpgs[i:i + BATCH] for i in range(0, N_IMAGES, BATCH))
    for outs in pipeline.decode_batches(batches, decoder=dec,
                                        drop_failed=False):
        decoded += len(outs)
        last = outs[-1]
    _force(last)
    return decoded / (time.perf_counter() - t0)


def _entropy_routes(label: str, jpgs) -> None:
    """Corpus rate with the device entropy route vs the host entropy stage,
    interleaved passes, medians (the route decides per bucket; see
    codecs/jpeg/batch._try_device_entropy)."""
    from nvimagecodec_tpu import Decoder, pipeline

    dec = Decoder()
    rates = {"device": [], "host": []}
    for _ in range(3):
        for route in ("device", "host"):
            if route == "host":
                os.environ["TIC_NO_DEVICE_ENTROPY"] = "1"
            try:
                _force(dec.decode(jpgs[:BATCH])[-1])  # warm this route
                rates[route].append(_corpus_pass(jpgs, dec, pipeline))
            finally:
                os.environ.pop("TIC_NO_DEVICE_ENTROPY", None)
    dv, hv = _median(rates["device"]), _median(rates["host"])
    log(f"{label}: device entropy route median {dv:.1f} img/s "
        f"(all: {[round(p, 1) for p in rates['device']]}) vs host entropy "
        f"median {hv:.1f} img/s (all: {[round(p, 1) for p in rates['host']]})"
        f" -> x{dv / max(hv, 1e-9):.2f}")


def section_dri() -> None:
    """Restart-interval corpus (one MCU row per interval): device entropy
    decode vs the host entropy stage."""
    _, jpgs, _ = _build_corpus(restart_interval=-(-W // 16))
    _entropy_routes("restart-interval corpus", jpgs)


def section_j2k_device() -> None:
    """J2K device pixel stage (host IDWT vs device IDWT/MCT route); the
    measured H2D probes drive the automatic choice
    (core.device_route_auto)."""
    import jax

    from util import make_photo

    from nvimagecodec_tpu.codecs.jpeg2000.core import (
        _h2d_mb_per_s, decode_j2k, device_route_auto, encode_j2k)

    big = make_photo(1024, 1024, seed=3)
    stream = encode_j2k(big, reversible=True, levels=5, stream_type="j2k")

    def _rate(fn, budget=2.0, min_iters=10):
        # slow contenders (~4 img/s) get too few samples in one budget
        # window — enforce a minimum iteration count for stable ratios
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < budget or n < min_iters:
            fn()
            n += 1
        return n / (time.perf_counter() - t0)

    def _dev_pass():
        out = decode_j2k(stream, use_jax=True)
        jax.block_until_ready(out)

    decode_j2k(stream, use_jax=True)  # warm/compile
    dev = host = 0.0
    for _r in range(2):
        dev = max(dev, _rate(_dev_pass))
        host = max(host, _rate(lambda: decode_j2k(stream, use_jax=False)))
    auto = device_route_auto(1024 * 1024, True)
    log(f"j2k device pixel stage (reversible): device route {dev:.2f} img/s "
        f"vs host route {host:.2f} img/s (x{dev / host:.2f}); auto picks "
        f"{'device' if auto else 'host'} (H2D {_h2d_mb_per_s():.0f} MB/s)")


SECTIONS = ["scaling", "j2k_host", "dri", "j2k_device"]


def _run_section(name: str) -> None:
    """Run one informational section in this process; a failure is logged
    with its traceback and the next section still runs."""
    t0 = time.perf_counter()
    try:
        globals()[f"section_{name}"]()
    except Exception:
        log(f"section {name} failed:\n{traceback.format_exc()}")
    log(f"section {name}: done in {time.perf_counter() - t0:.0f}s")


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--section":
        globals()[f"section_{sys.argv[2]}"]()
        sys.exit(0)
    main()
