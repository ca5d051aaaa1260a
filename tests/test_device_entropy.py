"""On-device (Pallas) segment-parallel JPEG entropy decode — interpret-mode
bit-exactness vs the host entropy decoder (the same anchor the host stage is
held to in test_jpeg_entropy.py), the kernel's lookup tables, and the
Decoder's routing around it."""
import os
import subprocess
import sys

import numpy as np
import pytest

import oracle
from nvimagecodec_tpu.codecs.jpeg.device_entropy import (
    device_entropy_key,
    reassemble_components,
    split_batch_segments,
)
from nvimagecodec_tpu.codecs.jpeg.entropy_py import decode_coefficients
from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu.codecs.jpeg.tables import ZIGZAG
from nvimagecodec_tpu.ops.pallas_entropy import (
    LANE_TILE,
    decode_segments_device,
    huffman_lut,
)
from util import make_photo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROMA = ["420", "422", "444", "440", "411", "410"]


def mcus_per_row(frame):
    return -(-frame.width // (8 * frame.hmax))


def _natural(comps):
    # zigzag -> natural order for comparison with the host decoder
    inv = np.zeros(64, np.int64)
    inv[ZIGZAG] = np.arange(64)
    return [np.asarray(c)[..., inv] for c in comps]


def run_device_decode(datas):
    """Decode a bucket of identical-geometry restart-interval JPEGs with
    the Pallas kernel in interpret mode; return per-sample per-component
    natural-order blocks."""
    frames = [parse_jpeg_structure(d) for d in datas]
    f0 = frames[0]
    assert device_entropy_key(f0) is not None
    max_words = max(
        (fr.scans[0].data_end - fr.scans[0].data_start) for fr in frames
    ) // 4 + 8
    packed = split_batch_segments(frames, datas, max_words)
    assert packed is not None
    words, seg_mcus, nsegs, bad = packed
    assert not bad
    out, err = decode_segments_device(f0, words, seg_mcus, interpret=True)
    assert int(np.sum(np.asarray(err))) == 0, "kernel flagged segments"
    comps = reassemble_components(np, np.asarray(out), f0, len(frames), nsegs)
    return _natural(comps), frames


def check_against_host(comps, frames, datas):
    for i, (data, frame) in enumerate(zip(datas, frames)):
        ref = decode_coefficients(frame, data)
        for c, r in enumerate(ref):
            mine = comps[c][i]
            bh, bw, _ = r.shape
            assert mine.shape[0] >= bh and mine.shape[1] >= bw
            np.testing.assert_array_equal(
                mine[:bh, :bw], r,
                err_msg=f"sample {i} component {c} differs",
            )


def check_dri(datas):
    comps, frames = run_device_decode(datas)
    check_against_host(comps, frames, datas)


@pytest.fixture(scope="module")
def photo():
    return make_photo(96, 144, seed=23)


@pytest.mark.parametrize("ss", CHROMA)
def test_chroma_matrix(photo, ss):
    data = oracle.jpeg_encode(photo, 88, ss)
    frame = parse_jpeg_structure(data)
    ri = mcus_per_row(frame)
    check_dri([oracle.jpeg_encode(photo, 88, ss, restart_interval=ri)])


def test_gray(photo):
    data = oracle.jpeg_encode(photo[:, :, 0], 90, restart_interval=1)
    frame = parse_jpeg_structure(data)
    ri = mcus_per_row(frame)
    check_dri([oracle.jpeg_encode(photo[:, :, 0], 90, restart_interval=ri)])


def test_multi_row_segments(photo):
    # restart interval spanning two MCU rows
    data = oracle.jpeg_encode(photo, 85, "420")
    frame = parse_jpeg_structure(data)
    ri = 2 * mcus_per_row(frame)
    check_dri([oracle.jpeg_encode(photo, 85, "420", restart_interval=ri)])


def test_batch_of_different_content(photo):
    imgs = [make_photo(96, 144, seed=s) for s in (1, 2, 3)]
    data = oracle.jpeg_encode(imgs[0], 85, "420")
    frame = parse_jpeg_structure(data)
    ri = mcus_per_row(frame)
    check_dri(
        [oracle.jpeg_encode(im, 85, "420", restart_interval=ri) for im in imgs]
    )


@pytest.mark.parametrize("ss", CHROMA)
def test_bucket_lanes_span_tiles(ss):
    """A bucket of several images per chroma class, one restart interval per
    MCU row: one image's segments straddle lane tiles and the kernel's
    blocks-per-MCU walk restarts on every lane, bit-exact vs the host."""
    imgs = [make_photo(72, 120, seed=s) for s in (4, 5, 6)]
    ri = mcus_per_row(parse_jpeg_structure(oracle.jpeg_encode(imgs[0], 90,
                                                              ss)))
    datas = [oracle.jpeg_encode(im, 90, ss, restart_interval=ri)
             for im in imgs]
    nsegs = len(datas) * -(-72 // (8 * parse_jpeg_structure(datas[0]).vmax))
    assert nsegs > LANE_TILE or nsegs % LANE_TILE != 0
    check_dri(datas)


def test_corrupt_segment_flagged(photo):
    """A segment whose bits do not decode raises its lane's error flag and
    leaves the other lanes' flags clear."""
    data = oracle.jpeg_encode(photo, 85, "420")
    ri = mcus_per_row(parse_jpeg_structure(data))
    good = oracle.jpeg_encode(photo, 85, "420", restart_interval=ri)
    frame = parse_jpeg_structure(good)
    words, seg_mcus, nsegs, bad = split_batch_segments(
        [frame], [good], (frame.scans[0].data_end
                          - frame.scans[0].data_start) // 4 + 8)
    words[:, 1] = 0xFFFFFFFF  # all-ones is no valid Huffman code
    _, err = decode_segments_device(frame, words, seg_mcus, interpret=True)
    err = np.asarray(err)[:nsegs]
    assert err[1] == 1 and err[0] == 0 and err[2:].sum() == 0


@pytest.mark.parametrize("tc,tid", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_huffman_lut_matches_canonical_codes(photo, tc, tid):
    """Every code of the stream's tables resolves to its (length, symbol)
    through the 12-bit table or, for longer codes, the 16-bit one."""
    frame = parse_jpeg_structure(oracle.jpeg_encode(photo, 85, "420"))
    t = (frame.dc_huff, frame.ac_huff)[tc][tid]
    spec = (tuple(t.bits), tuple(t.values))
    lut12, lut16 = huffman_lut(spec, 12), huffman_lut(spec, 16)
    code = k = 0
    for length in range(1, 17):
        for _ in range(t.bits[length - 1]):
            want = (length << 8) | t.values[k]
            peek16 = code << (16 - length)
            e = int(lut12[peek16 >> 4]) or int(lut16[peek16])
            assert e == want
            assert (int(lut12[peek16 >> 4]) != 0) == (length <= 12)
            code += 1
            k += 1
        code <<= 1
    # the all-ones prefix is no code of a valid table
    assert lut16[0xFFFF] == 0


def test_unsupported_streams_rejected(photo):
    # no restart interval -> no DRI key
    f = parse_jpeg_structure(oracle.jpeg_encode(photo, 85, "420"))
    assert device_entropy_key(f) is None
    # progressive -> host path
    f = parse_jpeg_structure(
        oracle.jpeg_encode(photo, 85, "420", progressive=True, restart_interval=9)
    )
    assert device_entropy_key(f) is None


@pytest.mark.parametrize("dp", [1, 4])
def test_lane_plan_whole_tiles(dp):
    """Every device's shard of the lane axis is whole lane tiles, and the
    image count is a power of two (one compile per bucket size class)."""
    from nvimagecodec_tpu.codecs.jpeg.batch import _lane_plan

    for nsegs, ngood in [(6, 16), (24, 256), (7, 33), (1, 17)]:
        ch, S = _lane_plan(nsegs, ngood, dp)
        assert ch >= ngood and ch & (ch - 1) == 0
        assert S >= ch * nsegs and S % (LANE_TILE * dp) == 0


# --- product-path integration (Decoder routes buckets to the kernel) ---


def _dri_batch(photo, n, corrupt=None):
    f = parse_jpeg_structure(oracle.jpeg_encode(photo, 85, "420"))
    ri = mcus_per_row(f)
    datas = [oracle.jpeg_encode(make_photo(96, 144, seed=s), 85, "420",
                                restart_interval=ri) for s in range(n)]
    if corrupt is not None:
        # valid markers, mangled entropy payload
        bad = bytearray(datas[corrupt])
        s0 = parse_jpeg_structure(datas[corrupt]).scans[0].data_start
        bad[s0 + 40:s0 + 48] = b"\xff\xd1" * 4  # stray RSTs break the split
        datas[corrupt] = bytes(bad)
    return datas


def test_decoder_route_and_fallback(photo, monkeypatch):
    """The Decoder takes the device route for a restart-interval bucket,
    falls back per-sample for mixed/corrupt streams, and matches the host
    path bit-exactly on the same streams."""
    import nvimagecodec_tpu as nic
    from nvimagecodec_tpu.codecs.jpeg import batch as B

    monkeypatch.setattr(B, "_MIN_BATCH", 1)
    datas = _dri_batch(photo, 4, corrupt=2)

    dec = nic.Decoder()
    before = B._device_entropy_fn.cache_info().misses
    out = dec.decode(datas)
    assert B._device_entropy_fn.cache_info().misses > before, (
        "device entropy route was not taken")
    for i, (im, d) in enumerate(zip(out, datas)):
        if i == 2:
            continue  # corrupt: any of None/garbage-free fallback is fine
        ref = oracle.jpeg_decode(d)
        diff = np.abs(np.asarray(im.array).astype(int) - ref.astype(int)).max()
        assert diff <= 4

    # device route disabled -> host path gives identical pixels
    monkeypatch.setenv("TIC_NO_DEVICE_ENTROPY", "1")
    out_host = nic.Decoder().decode([datas[0], datas[1], datas[3]])
    np.testing.assert_array_equal(
        np.asarray(out[0].array), np.asarray(out_host[0].array))
    np.testing.assert_array_equal(
        np.asarray(out[3].array), np.asarray(out_host[2].array))


def test_flagged_lanes_redecoded_on_host(photo, monkeypatch):
    """A DRI sample whose segments the kernel flags is re-decoded on the
    host entropy path before decode returns."""
    import nvimagecodec_tpu as nic
    from nvimagecodec_tpu.codecs.jpeg import batch as B
    from nvimagecodec_tpu.core.interfaces import DecodeParams

    monkeypatch.setattr(B, "_MIN_BATCH", 1)
    datas = _dri_batch(photo, 2)
    orig = B._device_entropy_fn

    def flag_all(*a, **kw):
        call = orig(*a, **kw)

        def wrapped(frame, words, side):
            res = call(frame, words, side)
            return res[:-1] + (res[-1] + 1,)

        return wrapped

    redo = []
    orig_batch = B.decode_batch_device

    def spy(batch, *a, **kw):
        if kw.get("device_entropy") is False:
            redo.append(len(batch))
        return orig_batch(batch, *a, **kw)

    host = orig_batch(datas, DecodeParams(), device_entropy=False)
    monkeypatch.setattr(B, "_device_entropy_fn", flag_all)
    monkeypatch.setattr(B, "decode_batch_device", spy)
    out = B.decode_batch_device(datas, DecodeParams())
    assert redo == [2]
    for r, h in zip(out, host):
        np.testing.assert_array_equal(np.asarray(r.array),
                                      np.asarray(h.array))


def test_device_entropy_error_raises(photo, monkeypatch):
    """An error inside the device-entropy route propagates out of the batch
    decode; it is not silently routed to the host entropy stage."""
    from nvimagecodec_tpu.codecs.jpeg import batch as B
    from nvimagecodec_tpu.core.interfaces import DecodeParams

    monkeypatch.setattr(B, "_MIN_BATCH", 1)
    datas = _dri_batch(photo, 2)

    def broken(*a, **kw):
        raise RuntimeError("kernel failed to compile")

    monkeypatch.setattr(B, "_device_entropy_fn", broken)
    with pytest.raises(RuntimeError, match="kernel failed to compile"):
        B.decode_batch_device(datas, DecodeParams())


def test_compile_cache_placement(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    the fixed <repo>/.jax_cache."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}
    assert chip_smoke.compile_cache_dir(env) == "/elsewhere"
    env = {}
    want = os.path.join(REPO, ".jax_cache")
    assert chip_smoke.compile_cache_dir(env) == want
    assert env["JAX_COMPILATION_CACHE_DIR"] == want


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke run fails at once and never reports ok."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
