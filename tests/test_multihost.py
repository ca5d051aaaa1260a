"""Two-process jax.distributed harness (SURVEY.md §4.7): each process is a
"host" owning a shard of encoded streams; it decodes its shard locally,
assembles the global batch with make_array_from_process_local_data, and
cross-host collectives (Gloo over the coordination service) verify the
global result — the CPU stand-in for a multi-host accelerator cluster."""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, %(repo)r)
    sys.path.insert(0, %(repo)r + "/tests")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    pid = int(sys.argv[1])
    port = sys.argv[2]

    from nvimagecodec_tpu.parallel import multihost
    multihost.initialize("127.0.0.1:" + port, 2, pid)
    assert jax.process_count() == 2, jax.process_count()

    import nvimagecodec_tpu as nic
    from nvimagecodec_tpu.codecs.bmp import encode_bmp
    from nvimagecodec_tpu.parallel.mesh import make_mesh

    # every host sees the same global stream list; shard_streams assigns
    # this host its share; the decode runs locally
    rng = np.random.default_rng(0)
    photos = [(rng.random((8, 12, 3)) * 255).astype(np.uint8)
              for _ in range(4)]
    streams = [encode_bmp(p) for p in photos]
    shards = multihost.shard_streams(streams, 2)
    mine = shards[pid]
    outs = nic.Decoder().decode([streams[i] for i in mine])
    local = np.stack([np.asarray(o) for o in outs])

    mesh = make_mesh(dp=4, sp=1)
    arr = multihost.global_batch(local, mesh)
    assert arr.shape == (4, 8, 12, 3), arr.shape

    # cross-host collective: global checksum must equal the sum over the
    # ORIGINAL photos regardless of which host decoded what
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    total = jax.jit(
        lambda x: jnp.sum(x.astype(jnp.int64)),
        out_shardings=NamedSharding(mesh, P()),
    )(arr)
    expect = sum(int(p.astype(np.int64).sum()) for p in photos)
    assert int(total) == expect, (int(total), expect)

    # --- J2K tile grid split across the two hosts -------------------------
    # one 2x2-tile image; each host entropy-decodes only ITS tile row via
    # the true-ROI path (tiles outside the region are never parsed), then
    # the halves assemble into a global sharded array (the multi-host
    # analog of the tile pool, extensions/nvjpeg2k/cuda_decoder.cpp:601-640)
    from nvimagecodec_tpu.codecs.jpeg2000.core import decode_j2k, encode_j2k
    from nvimagecodec_tpu.core.types import Region

    big = (rng.random((128, 128, 3)) * 255).astype(np.uint8)
    j2k = encode_j2k(big, reversible=True, tile_size=64, levels=2)
    half = Region(start_y=pid * 64, start_x=0, end_y=(pid + 1) * 64,
                  end_x=128)
    mine_px = np.asarray(decode_j2k(j2k, region=half))
    assert mine_px.shape == (64, 128, 3)
    # global image sharded over its ROW axis (64 rows per host, 32/device)
    arr2 = multihost.global_batch(mine_px, mesh)
    total2 = jax.jit(
        lambda x: jnp.sum(x.astype(jnp.int64)),
        out_shardings=NamedSharding(mesh, P()),
    )(arr2)
    assert int(total2) == int(big.astype(np.int64).sum())
    print("HOST", pid, "OK", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(180)
def test_two_process_decode_and_global_batch():
    port = _free_port()
    script = _WORKER % {"repo": REPO}
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=150)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {i} failed:\n{out[-2000:]}"
        assert f"HOST {i} OK" in out, out[-2000:]
