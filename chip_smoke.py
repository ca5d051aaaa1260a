#!/usr/bin/env python
"""Smoke run of the library's main path on one GPU.

    python chip_smoke.py            # phases 1-6 on one GPU
    python chip_smoke.py --multi    # only the 4-GPU sharded paths

Drives the public entry points (Decoder().decode, pipeline.decode_batches,
Encoder().encode, decode_j2k) at the sizes their users run, every device
kernel compiled for the card (never interpreted), and checks each result
against the repo's host reference. Each phase prints its result, tolerance
and wall time; any failure ends the run with a nonzero exit and without the
final line. The last line of stdout is one JSON object naming the device:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The compile cache is JAX_COMPILATION_CACHE_DIR when set, else
<repo>/.jax_cache.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_IMAGES, H, W, QUALITY, BATCH = 512, 375, 500, 85, 256  # bench.py corpus
N_ENCODE = 64
J2K_SIZE, J2K_LEVELS = 1024, 5


def compile_cache_dir(environ=os.environ) -> str:
    """The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
    else the fixed <repo>/.jax_cache (the path is part of the cache key)."""
    return environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                              os.path.join(ROOT, ".jax_cache"))


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times one phase and prints `phase <name>: <result> [<s> s]`."""

    def __init__(self, name: str):
        self.name = name
        self.notes = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else "FAILED"
        for n in self.notes:
            log(f"  {self.name}: {n}")
        log(f"phase {self.name}: {status} [{dt:.1f} s]")
        return False  # never swallow


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs(a, b) -> int:
    import numpy as np

    return int(np.abs(np.asarray(a).astype(np.int32)
                      - np.asarray(b).astype(np.int32)).max())


def on_gpu(arr) -> bool:
    import jax

    return (isinstance(arr, jax.Array)
            and all(d.platform == "gpu" for d in arr.devices()))


# ---------------------------------------------------------------- phase 1

def phase_device():
    import jax

    with Phase("device") as ph:
        devs = jax.devices()
        if devs[0].platform != "gpu":
            raise SystemExit(f"no GPU: JAX found {devs[0].platform} devices")
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        log(f"card: {r.stdout.strip().splitlines()[0]}")
        log(f"jax: {jax.__version__}")
        ph.note(f"{len(devs)} x {devs[0].device_kind}")
    return devs


# ------------------------------------------------- shared route checking

class RouteWatch:
    """Collects core/trace spans and debug-messenger fallback events over
    a block, so a phase can prove which plugin and route decoded."""

    def __enter__(self):
        import nvimagecodec_tpu as nic
        from nvimagecodec_tpu.core import trace

        self.events = []
        self._h = nic.register_debug_messenger(
            lambda sev, cat, data: self.events.append(data.message),
            int(nic.DebugMessageSeverity.ALL),
            int(nic.DebugMessageCategory.ALL))
        trace.start_collect()
        return self

    def __exit__(self, *exc):
        import nvimagecodec_tpu as nic
        from nvimagecodec_tpu.core import trace

        self.spans = trace.stop_collect()["spans"]
        nic.unregister_debug_messenger(self._h)
        return False

    def assert_hybrid_only(self, ph):
        fallbacks = [e for e in self.events if "falling back" in e]
        check(not fallbacks, f"runtime fallback fired: {fallbacks[:3]}")
        check("imgcodec.decode.tpu_jpeg_hybrid_decoder" in self.spans,
              "hybrid JPEG plugin did not run")
        check("imgcodec.decode.cpu_jpeg_decoder" not in self.spans,
              "the CPU JPEG decoder ran")
        ph.note("route: hybrid plugin only, no fallback event")


def host_reference(jpgs, bitexact=False):
    """{stream: host-path pixels} for the distinct streams of a corpus:
    native host entropy decode + the numpy pixel stage."""
    from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
    from nvimagecodec_tpu.codecs.jpeg.native import (
        decode_coefficients_native,
    )
    from nvimagecodec_tpu.codecs.jpeg.pixel import decode_pixels

    ref = {}
    for d in set(jpgs):
        frame = parse_jpeg_structure(d)
        coefs = decode_coefficients_native(frame, d)
        ref[d] = decode_pixels(frame, coefs, use_jax=False,
                               bitexact=bitexact)
    return ref


def decode_corpus(jpgs, decoder):
    from nvimagecodec_tpu import pipeline

    outs = []
    batches = (jpgs[i:i + BATCH] for i in range(0, len(jpgs), BATCH))
    for batch_out in pipeline.decode_batches(batches, decoder=decoder,
                                             drop_failed=False):
        outs.extend(batch_out)
    return outs


def rate(fn, n_items, passes=3):
    """Median items/s over `passes` runs of fn (each ends on the device)."""
    import jax

    rs = []
    for _ in range(passes):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready([o.array for o in out if o is not None])
        rs.append(n_items / (time.perf_counter() - t0))
    return sorted(rs)[len(rs) // 2], rs


def check_corpus_decode(ph, jpgs, have_oracle, label):
    """Decode through pipeline.decode_batches, prove the route, compare."""
    import nvimagecodec_tpu as nic

    dec = nic.Decoder()
    decode_corpus(jpgs[:BATCH], dec)  # compile
    with RouteWatch() as rw:
        outs = decode_corpus(jpgs, dec)
    rw.assert_hybrid_only(ph)
    check(len(outs) == len(jpgs) and all(o is not None for o in outs),
          f"{label}: a sample failed to decode")
    check(all(on_gpu(o.array) for o in outs),
          f"{label}: an output is not a jax.Array on the GPU")
    ref = host_reference(jpgs)
    worst = max(max_abs(o.array, ref[d]) for o, d in zip(outs, jpgs))
    check(worst <= 1, f"{label}: max-abs {worst} vs host path > 1")
    ph.note(f"{len(outs)} images on the GPU; max-abs vs host path {worst} "
            f"(tolerance 1)")

    bx = nic.Decoder(options="tpu_jpeg_hybrid_decoder:bitexact=true")
    with RouteWatch() as rw:
        outs_bx = bx.decode(jpgs[:BATCH])
    rw.assert_hybrid_only(ph)
    ref_bx = host_reference(jpgs[:BATCH], bitexact=True)
    worst_bx = max(max_abs(o.array, ref_bx[d])
                   for o, d in zip(outs_bx, jpgs[:BATCH]))
    check(worst_bx == 0, f"{label}: bitexact decode differs by {worst_bx}")
    ph.note(f"bitexact=true: {BATCH} images byte-exact vs host islow path")

    if have_oracle:
        import oracle

        o_worst = max(max_abs(o.array, oracle.jpeg_decode(d))
                      for o, d in zip(outs[:16], jpgs[:16]))
        check(o_worst <= 4, f"{label}: max-abs {o_worst} vs libjpeg > 4")
        ph.note(f"max-abs vs libjpeg-turbo {o_worst} (tolerance 4)")
    else:
        ph.note("libjpeg oracle unavailable: corpus from the repo encoder")
    return dec, rw.spans


def time_routes(ph, jpgs, dec):
    """Median corpus rate with the device entropy route and without it."""
    on, on_all = rate(lambda: decode_corpus(jpgs, dec), len(jpgs))
    os.environ["TIC_NO_DEVICE_ENTROPY"] = "1"
    try:
        decode_corpus(jpgs[:BATCH], dec)  # compile the host-route stage
        off, off_all = rate(lambda: decode_corpus(jpgs, dec), len(jpgs))
    finally:
        del os.environ["TIC_NO_DEVICE_ENTROPY"]
    ph.note(f"decode rate: {on:.1f} img/s as routed "
            f"({[round(r, 1) for r in on_all]}), {off:.1f} img/s host "
            f"entropy ({[round(r, 1) for r in off_all]})")


# ---------------------------------------------------------------- phase 2

def phase_jpeg_batch():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import jpeg_corpus

    with Phase("jpeg_batch_decode") as ph:
        base, jpgs, have_oracle = jpeg_corpus(N_IMAGES, H, W, QUALITY)
        dec, spans = check_corpus_decode(ph, jpgs, have_oracle, "baseline")
        check("imgcodec.jpeg.host_entropy" in spans,
              "baseline buckets did not take the host entropy stage")
        ph.note("route: host entropy stage + device pixel stage")
        on, on_all = rate(lambda: decode_corpus(jpgs, dec), len(jpgs))
        ph.note(f"decode rate: {on:.1f} img/s "
                f"({[round(r, 1) for r in on_all]})")
    return base, have_oracle


# ---------------------------------------------------------------- phase 3

def kernel_vs_host(ph, jpgs):
    """The entropy kernel alone, compiled for the card at the width of one
    bucket, bit-exact against the native host decoder's coefficients."""
    import numpy as np

    from nvimagecodec_tpu.codecs.jpeg.device_entropy import (
        reassemble_components,
        split_batch_segments,
    )
    from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
    from nvimagecodec_tpu.codecs.jpeg.native import (
        decode_coefficients_native,
    )
    from nvimagecodec_tpu.codecs.jpeg.pixel import ZIGZAG_NAT
    from nvimagecodec_tpu.ops.pallas_entropy import decode_segments_device

    batch = jpgs[:BATCH]
    frames = [parse_jpeg_structure(d) for d in batch]
    max_words = max(f.scans[0].data_end - f.scans[0].data_start
                    for f in frames) // 4 + 8
    words, seg_mcus, nsegs, bad = split_batch_segments(frames, batch,
                                                       max_words)
    check(not bad, "restart split failed")
    t0 = time.perf_counter()
    out, err = decode_segments_device(frames[0], words, seg_mcus)
    out, err = np.asarray(out), np.asarray(err)
    dt = time.perf_counter() - t0
    check(not err.any(), f"kernel flagged {int(err.sum())} segments")
    comps = reassemble_components(np, out, frames[0], len(batch), nsegs)
    host = {}
    for i, d in enumerate(batch):
        if d not in host:
            host[d] = decode_coefficients_native(frames[i], d)
        for c, ref in enumerate(host[d]):
            bh, bw, _ = ref.shape
            mine = np.zeros_like(ref)
            mine[..., ZIGZAG_NAT] = comps[c][i][:bh, :bw]
            check(np.array_equal(mine, ref),
                  f"kernel coefficients differ: image {i} component {c}")
    ph.note(f"kernel: {words.shape[1]} lanes x {words.shape[0]} words, "
            f"coefficients bit-exact vs native host decoder "
            f"(first call incl. compile {dt:.2f} s)")


def phase_jpeg_dri():
    from nvimagecodec_tpu.codecs.jpeg import batch as B

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import jpeg_corpus

    with Phase("jpeg_restart_decode") as ph:
        mcus_x = -(-W // 16)
        _, jpgs, have_oracle = jpeg_corpus(N_IMAGES, H, W, QUALITY,
                                           restart_interval=mcus_x)
        kernel_vs_host(ph, jpgs)
        before = B._device_entropy_fn.cache_info()
        dec, spans = check_corpus_decode(ph, jpgs, have_oracle, "restart")
        after = B._device_entropy_fn.cache_info()
        check(after.hits + after.misses > before.hits + before.misses
              and "imgcodec.jpeg.device_entropy_kernel" in spans
              and "imgcodec.jpeg.host_entropy" not in spans,
              "device entropy route did not decode every bucket")
        ph.note("route: device entropy kernel for every bucket")
        time_routes(ph, jpgs, dec)


# ---------------------------------------------------------------- phase 4

def phase_encode(base):
    import numpy as np

    import nvimagecodec_tpu as nic
    from nvimagecodec_tpu.codecs.jpeg import batch_encode
    from nvimagecodec_tpu.codecs.jpeg.encode import (
        build_encode_frame,
        encode_pixels,
    )
    from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
    from nvimagecodec_tpu.codecs.jpeg.native import (
        decode_coefficients_native,
    )
    from nvimagecodec_tpu.core.interfaces import EncodeParams
    from nvimagecodec_tpu.core.types import ChromaSubsampling
    from util import psnr

    with Phase("jpeg_encode") as ph:
        imgs = [base[i % len(base)] for i in range(N_ENCODE)]
        params = EncodeParams(quality=QUALITY, chroma_subsampling="420")
        enc = nic.Encoder()
        streams, rates = {}, {}
        for route in ("1", "0"):
            os.environ["TIC_ENCODE_DEVICE"] = route
            try:
                enc.encode(imgs, codec="jpeg", params=params)  # compile
                rs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    out = enc.encode(imgs, codec="jpeg", params=params)
                    rs.append(len(imgs) / (time.perf_counter() - t0))
                check(all(o is not None for o in out), "encode failed")
                streams[route], rates[route] = out, sorted(rs)[1]
            finally:
                del os.environ["TIC_ENCODE_DEVICE"]
        ph.note(f"encode rate: device route {rates['1']:.1f} img/s, host "
                f"route {rates['0']:.1f} img/s; unset, the route is "
                f"{'device' if batch_encode.device_stage_auto() else 'host'}")
        # the device route computes the staged pixel stage (encode_pixels)
        # in f32 on the GPU: its quantized coefficients are held to the
        # numpy run of the same stage. The host route's fused encoder uses
        # another fDCT (AAN), so it is held to the same decoded PSNR.
        frame = build_encode_frame(H, W, 3, QUALITY, ChromaSubsampling.CSS_420)
        ndiff = nbig = ntot = nfused = 0
        dpsnr = 0.0
        dec = nic.Decoder()
        for i, img in enumerate(imgs[:len(base)]):
            dv, hv = streams["1"][i], streams["0"][i]
            cd = decode_coefficients_native(parse_jpeg_structure(dv), dv)
            ch = decode_coefficients_native(parse_jpeg_structure(hv), hv)
            ref = encode_pixels(img, frame, use_jax=False)
            for a, r, b in zip(cd, ref, ch):
                d = np.abs(a.astype(np.int32) - np.asarray(r, np.int32))
                ndiff += int((d == 1).sum())
                nbig += int((d > 1).sum())
                ntot += d.size
                nfused += int((a != b).sum())
            pd = psnr(img, np.asarray(dec.decode(dv).cpu()))
            phh = psnr(img, np.asarray(dec.decode(hv).cpu()))
            dpsnr = max(dpsnr, abs(pd - phh))
        frac = ndiff / ntot
        ph.note(f"coefficients device route vs numpy pixel stage: {ndiff} of "
                f"{ntot} off by one ({frac:.2e}, tolerance 1e-4), {nbig} off "
                f"by more; vs the host route's fused encoder {nfused} differ")
        ph.note(f"decoded PSNR device vs host route differs by at most "
                f"{dpsnr:.3f} dB (tolerance 0.05)")
        check(nbig == 0 and frac <= 1e-4, "encode coefficients disagree")
        check(dpsnr <= 0.05, "encode PSNR differs")


# ---------------------------------------------------------------- phase 5

def phase_j2k():
    import jax

    from nvimagecodec_tpu.codecs.jpeg2000 import core
    from util import make_photo

    with Phase("j2k") as ph:
        img = make_photo(J2K_SIZE, J2K_SIZE, seed=3)
        for rev in (True, False):
            stream = core.encode_j2k(img, reversible=rev, levels=J2K_LEVELS,
                                     quality=100.0 if rev else 40.0,
                                     stream_type="j2k")
            dev = core.decode_j2k(stream, use_jax=True)
            check(on_gpu(dev), "J2K device route output is not on the GPU")
            host = core.decode_j2k(stream, use_jax=False)
            worst = max_abs(dev, host)
            tol = 0 if rev else 1
            check(worst <= tol, f"J2K rev={rev}: max-abs {worst} > {tol}")
            ts = {}
            for route in (True, False):
                t0 = time.perf_counter()
                for _ in range(5):
                    jax.block_until_ready(core.decode_j2k(stream,
                                                          use_jax=route))
                ts[route] = (time.perf_counter() - t0) / 5 * 1e3
            auto = core.device_route_auto(J2K_SIZE * J2K_SIZE, rev)
            ph.note(f"{'reversible 5/3' if rev else 'irreversible 9/7'}: "
                    f"max-abs device vs host {worst} (tolerance {tol}); "
                    f"device route {ts[True]:.1f} ms, host route "
                    f"{ts[False]:.1f} ms per {J2K_SIZE}x{J2K_SIZE} image; "
                    f"auto picks {'device' if auto else 'host'}")
        ph.note(f"H2D probe {core._h2d_mb_per_s():.0f} MB/s")


# ---------------------------------------------------------------- phase 6

def phase_mixed(base):
    import numpy as np

    import nvimagecodec_tpu as nic
    from nvimagecodec_tpu.codecs.jpeg.encode import encode_jpeg
    from nvimagecodec_tpu.codecs.jpeg2000.core import encode_j2k
    from nvimagecodec_tpu.codecs.png import encode_png
    from nvimagecodec_tpu.codecs.webp import encode_webp_lossless
    from nvimagecodec_tpu.core.interfaces import EncodeParams

    with Phase("mixed_batch") as ph:
        img = base[0]
        jpg = encode_jpeg(img, EncodeParams(quality=QUALITY,
                                            chroma_subsampling="420"))
        corrupt = jpg[:120]  # cut inside the headers
        batch = [jpg, encode_png(img), encode_j2k(img, reversible=True),
                 encode_webp_lossless(img), corrupt]
        out = nic.Decoder().decode(batch)
        check(out[4] is None, "corrupt sample did not come back as None")
        check(all(o is not None for o in out[:4]), "a valid sample failed")
        ref_jpg = host_reference([jpg])[jpg]
        check(max_abs(out[0].array, ref_jpg) <= 1, "JPEG slot differs")
        for k, name in ((1, "PNG"), (2, "J2K"), (3, "WebP")):
            check(np.array_equal(np.asarray(out[k].cpu()), img),
                  f"{name} slot is not lossless")
        ph.note("slots: JPEG max-abs<=1 vs host, PNG/J2K/WebP lossless, "
                "corrupt -> None")


# ------------------------------------------------------------------ multi

def phase_multi(devs):
    import numpy as np

    import nvimagecodec_tpu as nic
    from nvimagecodec_tpu.codecs.jpeg2000.core import decode_j2k, encode_j2k
    from nvimagecodec_tpu.parallel.mesh import make_mesh

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import jpeg_corpus, make_photo

    check(len(devs) >= 4, f"--multi needs 4 GPUs, found {len(devs)}")
    mesh_dp = make_mesh(dp=4, sp=1)
    for label, ri in (("baseline", 0), ("restart", -(-W // 16))):
        with Phase(f"multi_dp4_{label}") as ph:
            _, jpgs, _ = jpeg_corpus(BATCH, H, W, QUALITY,
                                     restart_interval=ri)
            ref = [np.asarray(o.cpu()) for o in nic.Decoder().decode(jpgs)]
            with RouteWatch() as rw:
                got = nic.Decoder(mesh=mesh_dp).decode(jpgs)
            rw.assert_hybrid_only(ph)
            if ri:
                check("imgcodec.jpeg.device_entropy_kernel" in rw.spans,
                      "sharded device entropy route did not run")
            check(all(np.array_equal(r, np.asarray(g.cpu()))
                      for r, g in zip(ref, got)),
                  f"dp=4 {label} decode differs from one GPU")
            ph.note(f"{BATCH} images, dp=4 bit-exact vs one GPU")
    mesh_sp = make_mesh(dp=1, sp=4)
    img = make_photo(J2K_SIZE, J2K_SIZE, seed=3)
    for label, kw in (("tile_grid", {"tile_size": 256}), ("rows", {})):
        with Phase(f"multi_sp4_j2k_{label}") as ph:
            stream = encode_j2k(img, reversible=True, levels=J2K_LEVELS,
                                stream_type="j2k", **kw)
            one = np.asarray(decode_j2k(stream, use_jax=True))
            four = np.asarray(decode_j2k(stream, mesh=mesh_sp))
            check(np.array_equal(one, four),
                  f"sp=4 J2K {label} differs from one GPU")
            check(np.array_equal(one, img), "J2K reversible not lossless")
            ph.note(f"{J2K_SIZE}x{J2K_SIZE}, sp=4 bit-exact vs one GPU")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU dp/sp sharded paths")
    args = ap.parse_args()
    compile_cache_dir()
    sys.path.insert(0, ROOT)
    devs = phase_device()
    if args.multi:
        phase_multi(devs)
    else:
        base, _ = phase_jpeg_batch()
        phase_jpeg_dri()
        phase_encode(base)
        phase_j2k()
        phase_mixed(base)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
