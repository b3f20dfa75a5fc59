"""Multi-host execution: distributed init, cross-host mesh, heartbeats.

SURVEY.md §2.4/§5 — the reference is single-process with no failure
handling; here DP runs over hosts via a ("host", "chip") mesh, with
per-host heartbeating so a lost
host surfaces as a detectable stall instead of a silent hang.
"""

from __future__ import annotations

import json
import os
import threading
import time

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """jax.distributed.initialize with env fallbacks (no-op if single
    process or already initialized)."""
    if num_processes in (None, 1) and os.environ.get("JAX_NUM_PROCESSES") in (None, "1"):
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # tolerate ONLY re-initialization; real failures must surface
        if "already initialized" not in str(e).lower():
            raise


def make_host_mesh() -> Mesh:
    """("host", "chip") mesh over all processes' devices: DP batches shard
    over hosts (DCN) and chips (ICI); collectives inside a page stay on ICI."""
    n_hosts = jax.process_count()
    devs = np.array(jax.devices()).reshape(n_hosts, -1)
    return Mesh(devs, ("host", "chip"))


class Heartbeat:
    """Per-host liveness file heartbeat for the batch driver.

    Each host touches `<dir>/host<i>.hb` every `interval` seconds with a
    monotonic sequence number; `stale_hosts` reports hosts whose beat is
    older than `timeout` (the driver retries their chunks elsewhere).
    Uses a shared filesystem — the standard pod-slice arrangement.
    """

    def __init__(self, directory: str, interval: float = 10.0,
                 timeout: float = 60.0, host_id: int | None = None,
                 n_hosts: int | None = None):
        self.dir = directory
        self.interval = interval
        self.timeout = timeout
        self.host_id = jax.process_index() if host_id is None else host_id
        self.n_hosts = jax.process_count() if n_hosts is None else n_hosts
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.dir, f"host{pid}.hb")

    def _beat(self, seq: int) -> None:
        tmp = self._path(self.host_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"seq": seq, "t": time.time()}, f)
        os.replace(tmp, self._path(self.host_id))

    def _run(self):
        seq = 0
        self._beat(seq)  # announce liveness immediately
        while not self._stop.wait(self.interval):
            seq += 1
            self._beat(seq)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval)

    def stale_hosts(self) -> list[int]:
        now = time.time()
        stale = []
        for i in range(self.n_hosts):
            try:
                with open(self._path(i)) as f:
                    beat = json.load(f)
                if now - beat["t"] > self.timeout:
                    stale.append(i)
            except (OSError, ValueError):
                stale.append(i)
        return stale
