"""Real 2-process jax.distributed validation (SURVEY.md §2.4 comm
backend; BASELINE.json config 5).

Spawns two OS processes, each with 4 virtual CPU devices, that
`jax.distributed.initialize` against a shared coordinator, build the
("host", "chip") mesh via multihost.make_host_mesh, run the fused
unpaper pipeline on a globally sharded batch, and assert the gathered
result equals the single-process reference. This exercises the actual
multi-process code path (process_count() == 2, cross-process
collectives/gathers) that the in-process mesh tests cannot.
"""

import os
import socket
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
idx, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
import jax
jax.config.update("jax_platforms", "cpu")  # before distributed init
from libpillowfight_tpu.parallel.multihost import initialize_distributed, make_host_mesh

initialize_distributed(coordinator=f"127.0.0.1:{port}", num_processes=nproc,
                       process_id=idx)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils
from libpillowfight_tpu.parallel.pipeline import (
    DOCUMENT_CLEANUP, normalize_spec, run_pipeline)

mesh = make_host_mesh()
assert mesh.axis_names == ("host", "chip") and mesh.devices.shape == (nproc, 4)

rng = np.random.default_rng(7)
b, h, w = 8, 96, 160
pages = np.full((b, h, w, 4), 245, np.uint8)
pages[..., 3] = 255
pages[:, :, :8, :3] = 0
for y in range(20, 80, 20):
    pages[:, y : y + 2, 30 : w - 20, :3] = 15
ys = rng.integers(5, h - 5, 25); xs = rng.integers(12, w - 5, 25)
pages[:, ys, xs, :3] = 30

spec = normalize_spec(DOCUMENT_CLEANUP)
sharding = NamedSharding(mesh, P(("host", "chip")))
garr = jax.make_array_from_callback(pages.shape, sharding,
                                    lambda i: pages[i])
out = jax.jit(lambda p: run_pipeline(p, spec),
              out_shardings=sharding)(garr)
gathered = multihost_utils.process_allgather(out, tiled=True)

# single-process reference on this host's local default device
ref = np.asarray(run_pipeline(jnp.asarray(pages), spec))
assert np.array_equal(np.asarray(gathered), ref), "sharded != reference"

with open(os.path.join(outdir, f"ok{idx}"), "w") as f:
    f.write("ok")
"""


def test_two_process_distributed_pipeline(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port),
             str(tmp_path)],
            env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
        assert (tmp_path / f"ok{i}").exists()
