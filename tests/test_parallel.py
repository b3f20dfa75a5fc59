"""Distribution layer tests on the virtual 8-device CPU mesh."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libpillowfight_tpu.ops.gaussian import gaussian_on_matrix
from libpillowfight_tpu.parallel import (
    DOCUMENT_CLEANUP,
    BatchRunner,
    compile_pipeline,
    exchange_halo_rows,
    make_mesh,
    normalize_spec,
    page_sharding,
    run_pipeline,
    shard_pages,
    sharded_stencil,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices")


def _batch(rng, b=8, h=128, w=128):
    pages = np.full((b, h, w, 4), 255, np.uint8)
    pages[:, 40:80, 30:100, :3] = 20
    pages[:, :, :10, :3] = 0
    return pages


def test_mesh_shapes():
    mesh = make_mesh(8, rows=2)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("pages", "rows")


def test_sharded_stencil_matches_unsharded(rng):
    mesh = make_mesh(8, rows=2)
    gray = rng.random((4, 128, 128)).astype(np.float32) * 255
    want = np.asarray(gaussian_on_matrix(jnp.asarray(gray), 2.0, 5))
    halo = 10
    fn = sharded_stencil(lambda x: gaussian_on_matrix(x, 2.0, 5), mesh, halo)
    got = np.asarray(fn(shard_pages(jnp.asarray(gray), mesh)))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_halo_exchange_zero_boundary():
    mesh = make_mesh(8, rows=2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jnp.arange(4 * 8 * 4, dtype=jnp.float32).reshape(4, 8, 4)
    xs = jax.device_put(x, NamedSharding(mesh, P("pages", "rows")))
    out = jax.jit(
        jax.shard_map(
            lambda b: exchange_halo_rows(b, 1),
            mesh=mesh, in_specs=P("pages", "rows"),
            out_specs=P("pages", "rows", None),
        )
    )(xs)
    # each local shard of 4 rows becomes 6 (one ghost row each side)
    assert out.shape == (4, 12, 4)
    o = np.asarray(out)
    np.testing.assert_array_equal(o[0, 0], 0)          # top boundary ghost
    np.testing.assert_array_equal(o[0, 5], np.asarray(x)[0, 4])  # from below


def test_pipeline_sharded_matches_single(rng):
    pages = _batch(rng)
    mesh = make_mesh(8, rows=1)
    spec = normalize_spec([("unpaper_blackfilter", ()), ("unpaper_border", ())])
    want = np.asarray(run_pipeline(jnp.asarray(pages), spec))
    sharded = shard_pages(jnp.asarray(pages), mesh)
    got = np.asarray(jax.jit(lambda x: run_pipeline(x, spec))(sharded))
    np.testing.assert_array_equal(got, want)


def test_batch_runner_resume(tmp_path, rng):
    pages = _batch(rng, b=12)
    manifest = str(tmp_path / "run.manifest")
    calls = []

    def source(idx):
        calls.append(tuple(idx))
        return pages[idx % len(pages)]

    sink_out = {}

    def sink(idx, out):
        sink_out.update({int(i): True for i in idx})

    runner = BatchRunner([("unpaper_border", ())], chunk_size=4,
                         manifest_path=manifest)
    m = runner.run(12, source, sink)
    assert m.pages == 12 and m.chunks == 3
    assert len(sink_out) == 12
    lines = [json.loads(x) for x in open(manifest)]
    assert [x["start"] for x in lines] == [0, 4, 8]

    # resume: a fresh runner skips everything already done
    runner2 = BatchRunner([("unpaper_border", ())], chunk_size=4,
                          manifest_path=manifest)
    m2 = runner2.run(12, source, sink)
    assert m2.pages == 0 and m2.chunks == 0


def test_compile_pipeline_full_chain(rng):
    pages = _batch(rng, b=2)
    fn = compile_pipeline(DOCUMENT_CLEANUP)
    out = np.asarray(fn(jnp.asarray(pages)))
    assert out.shape == pages.shape and out.dtype == np.uint8
    # black border removed by the chain
    assert (out[:, :, :10, 0] == 255).mean() > 0.9


def test_heartbeat(tmp_path):
    from libpillowfight_tpu.parallel import Heartbeat

    hb = Heartbeat(str(tmp_path), interval=0.05, timeout=0.5).start()
    import time

    time.sleep(0.3)
    assert hb.stale_hosts() == []
    hb.stop()
    time.sleep(0.7)
    assert hb.stale_hosts() == [0]


def test_make_host_mesh():
    from libpillowfight_tpu.parallel import make_host_mesh

    mesh = make_host_mesh()
    assert mesh.axis_names == ("host", "chip")
    assert mesh.devices.size == 8


def test_fused_unpaper_group_matches_sequential(rng):
    """The gray-threaded unpaper group must be bit-identical to applying
    each filter to RGBA sequentially (a wiped pixel is exactly white, so
    threading gray = where(wipe, 255, gray) preserves every downstream
    decision)."""
    from libpillowfight_tpu.parallel.pipeline import _FILTERS

    pages = np.full((2, 380, 300, 4), 245, np.uint8)
    pages[..., 3] = 255
    pages[:, :, :12, :3] = 0                       # black border
    pages[:, 40:44, 40:260, :3] = 15               # text line
    pages[:, 200:240, 30:90, :3] = 190             # gray shading
    ys = rng.integers(0, 380, 60)
    xs = rng.integers(20, 300, 60)
    pages[:, ys, xs, :3] = 30                      # speckle
    spec = normalize_spec(DOCUMENT_CLEANUP)
    fused = np.asarray(run_pipeline(jnp.asarray(pages), spec))
    seq = jnp.asarray(pages)
    for name, kw in spec:
        seq = _FILTERS[name](seq, **dict(kw))
    np.testing.assert_array_equal(fused, np.asarray(seq))


def test_pipeline_explicit_default_black_threshold(rng):
    """r4 advisor (medium): black_threshold passed explicitly EQUAL to
    the default keeps the bool-plane path — the kwarg must be stripped
    before blackfilter_wipe_dark (no such parameter), and the output
    must equal the no-kwarg spec."""
    from libpillowfight_tpu.core import constants as C

    pages = np.full((1, 300, 260, 4), 245, np.uint8)
    pages[..., 3] = 255
    pages[:, :, :10, :3] = 0
    pages[:, 120:124, 30:230, :3] = 15
    spec_kw = normalize_spec((
        ("unpaper_blackfilter",
         {"black_threshold": C.UNPAPER_BLACK_THRESHOLD}),
        ("unpaper_border", ()),
    ))
    spec_plain = normalize_spec(
        (("unpaper_blackfilter", ()), ("unpaper_border", ())))
    got = np.asarray(run_pipeline(jnp.asarray(pages), spec_kw))
    want = np.asarray(run_pipeline(jnp.asarray(pages), spec_plain))
    np.testing.assert_array_equal(got, want)


def test_pipeline_words_transport_matches_u8(rng):
    """The u32-word transport form (bitmap.host_pages_to_words) must
    produce byte-identical output to the u8 RGBA path."""
    from libpillowfight_tpu.core.bitmap import (
        host_pages_to_words, host_words_to_pages)

    pages = np.full((2, 300, 260, 4), 245, np.uint8)
    pages[..., 3] = 255
    pages[:, :, :10, :3] = 0
    pages[:, 120:124, 30:230, :3] = 15
    ys = rng.integers(0, 300, 40)
    xs = rng.integers(15, 260, 40)
    pages[:, ys, xs, :3] = 30
    spec = normalize_spec(DOCUMENT_CLEANUP)
    a = np.asarray(run_pipeline(jnp.asarray(pages), spec))
    w = np.asarray(run_pipeline(
        jnp.asarray(host_pages_to_words(pages)), spec))
    assert w.dtype == np.uint32 and w.shape == pages.shape[:3]
    np.testing.assert_array_equal(a, host_words_to_pages(w))


def test_batch_runner_steals_from_dead_host(tmp_path):
    """Failure RESPONSE (SURVEY §5): a 2-host batch where host 1 dies
    after one chunk — host 0 must detect the stale heartbeat and
    reprocess host 1's unfinished chunks (real child process, killed)."""
    import subprocess
    import sys as _sys
    import time as _time

    from libpillowfight_tpu.parallel import BatchRunner, Heartbeat

    tmp = str(tmp_path)
    child_src = f"""
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np, os
from libpillowfight_tpu.parallel import BatchRunner, Heartbeat
from libpillowfight_tpu.parallel.batch import BatchMetrics
hb = Heartbeat({tmp!r} + "/hb", interval=0.2, timeout=1.0,
               host_id=1, n_hosts=2).start()
pages = np.full((4, 64, 64, 4), 255, np.uint8)
r = BatchRunner([("unpaper_border", ())], chunk_size=4,
                manifest_path={tmp!r} + "/m.jsonl", host_id=1, n_hosts=2)
r._process_chunk(4, 16, lambda idx: pages, None, BatchMetrics())
os._exit(1)  # crash: chunk 12 (also host 1's) never happens
"""
    proc = subprocess.run([_sys.executable, "-c", child_src], timeout=300)
    assert proc.returncode == 1  # simulated crash

    # host 1's heartbeat file exists but stops updating -> goes stale
    hb0 = Heartbeat(tmp + "/hb", interval=0.2, timeout=1.0,
                    host_id=0, n_hosts=2).start()
    pages = np.full((4, 64, 64, 4), 255, np.uint8)
    seen = []
    runner = BatchRunner([("unpaper_border", ())], chunk_size=4,
                         manifest_path=tmp + "/m.jsonl", host_id=0,
                         n_hosts=2, heartbeat=hb0, steal_poll=0.2)
    m = runner.run(16, lambda idx: pages, lambda idx, out: seen.extend(idx))
    hb0.stop()

    assert m.stolen == 1          # chunk 12 reassigned from the dead host
    assert m.chunks == 3          # own 0, 8 + stolen 12
    assert sorted(seen) == sorted(list(range(0, 4)) + list(range(8, 16)))
    starts = sorted(json.loads(x)["start"] for x in open(tmp + "/m.jsonl"))
    assert starts == [0, 4, 8, 12]  # whole batch complete exactly once
    # claim files are dedup locks, not durable state — completion must
    # clean them up (r4 VERDICT weak #7)
    import glob as _glob
    assert _glob.glob(tmp + "/m.jsonl.claim.*") == []
