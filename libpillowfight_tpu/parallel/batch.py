"""Large-batch driver: resumable, sharded, metered page processing.

SURVEY.md §5 (checkpoint/resume, metrics, failure handling): the
reference is a synchronous single-image library with none of this; the
batch runner provides
  * page-index manifest for resume (crash -> rerun skips finished chunks),
  * page sharding over the device mesh (DP over the pages axis),
  * structured throughput metrics (pages/sec, MP/s, per-chunk timings),
  * per-chunk retry (transient failure -> bounded re-execution).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import jax
import numpy as np

from .mesh import make_mesh, shard_pages
from .pipeline import compile_pipeline, normalize_spec

# retry only device/runtime failures (XLA runtime errors, transient
# device loss). Programming errors — TypeError, ValueError, a broken
# source callback — re-raise immediately: retrying them wastes
# max_retries re-executions and then masks the real traceback depth.
_RETRYABLE = (jax.errors.JaxRuntimeError, RuntimeError, OSError)


def map_chunked(fn, pages: jax.Array, chunk: int) -> jax.Array:
    """Apply fn over the batch axis in device-resident chunks of `chunk`
    pages, inside one jittable computation (lax.map over the chunk axis).

    Bounds peak device memory by the per-chunk live set instead of the
    whole batch's: a 64-page A4 canny holds ~6 full-res f32 planes
    (~13 GB of live planes at batch 64) but streams 16 pages at a time
    in a quarter of that. The chunk that fits best on a given card is
    not measured yet.

    The batch must divide evenly into chunks (pad the tail upstream —
    BatchRunner already chunks its manifest this way)."""
    b = pages.shape[0]
    if b <= chunk:
        return fn(pages)
    if b % chunk:
        raise ValueError(f"batch {b} not divisible by chunk {chunk}")
    folded = pages.reshape((b // chunk, chunk) + pages.shape[1:])
    out = jax.lax.map(fn, folded)
    return out.reshape((b,) + out.shape[2:])


@dataclass
class BatchMetrics:
    pages: int = 0
    megapixels: float = 0.0
    seconds: float = 0.0
    chunks: int = 0
    retries: int = 0
    stolen: int = 0
    chunk_seconds: list = field(default_factory=list)

    @property
    def pages_per_sec(self) -> float:
        return self.pages / self.seconds if self.seconds else 0.0

    @property
    def mp_per_sec(self) -> float:
        return self.megapixels / self.seconds if self.seconds else 0.0

    def to_dict(self) -> dict:
        return {
            "pages": self.pages,
            "megapixels": round(self.megapixels, 3),
            "seconds": round(self.seconds, 4),
            "pages_per_sec": round(self.pages_per_sec, 2),
            "mp_per_sec": round(self.mp_per_sec, 2),
            "chunks": self.chunks,
            "retries": self.retries,
            "stolen": self.stolen,
        }


class BatchRunner:
    """Process a large page set through a pipeline in sharded chunks.

    `source(indices) -> uint8 [n, H, W, 4]` supplies pages on demand;
    `sink(indices, pages)` consumes results. The manifest file records
    finished chunk start-indices, making reruns resumable.
    """

    def __init__(self, spec, chunk_size: int = 64, mesh=None,
                 manifest_path: str | None = None, max_retries: int = 2,
                 host_id: int = 0, n_hosts: int = 1, heartbeat=None,
                 steal_poll: float = 1.0):
        """host_id/n_hosts partition chunks round-robin across hosts (a
        chunk's owner = chunk_index % n_hosts); `heartbeat` (a
        multihost.Heartbeat over a shared directory) enables the failure
        RESPONSE: after finishing its own chunks, a host steals and
        reprocesses the unfinished chunks of any host whose heartbeat has
        gone stale, and waits on live peers until the whole batch is
        done. Steals are de-duplicated via O_EXCL claim files next to the
        manifest (a claim older than the heartbeat timeout is treated as
        abandoned and re-claimable), so completion is at-least-once."""
        self.spec = normalize_spec(spec)
        self.fn = compile_pipeline(self.spec)
        self.chunk_size = chunk_size
        self.mesh = mesh if mesh is not None else make_mesh()
        self.manifest_path = manifest_path
        self.max_retries = max_retries
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.heartbeat = heartbeat
        self.steal_poll = steal_poll
        if heartbeat is not None and manifest_path is None:
            raise ValueError("work stealing needs a shared manifest_path")
        self._done: set[int] = set()
        self._reload_done()

    def _reload_done(self) -> None:
        """Sync finished-chunk set from the (shared) manifest file."""
        if self.manifest_path and os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._done.add(json.loads(line)["start"])

    def _mark_done(self, start: int, n: int, dt: float) -> None:
        self._done.add(start)
        if self.manifest_path:
            with open(self.manifest_path, "a") as f:
                f.write(json.dumps({"start": start, "n": n, "dt": round(dt, 4),
                                    "host": self.host_id}) + "\n")
            # drop any steal-claim marker: the manifest line above is the
            # durable completion record, the claim was only a dedup lock
            try:
                os.remove(f"{self.manifest_path}.claim.{start}")
            except OSError:
                pass

    def _owner(self, start: int) -> int:
        return (start // self.chunk_size) % self.n_hosts

    def _claim(self, start: int) -> bool:
        """Try to claim a steal target (O_EXCL file). Stale claims (older
        than the heartbeat timeout — the claimer died too) are overridden."""
        path = f"{self.manifest_path}.claim.{start}"
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                return False
            if age <= self.heartbeat.timeout:
                return False
            os.utime(path)  # adopt the abandoned claim
            return True
        with os.fdopen(fd, "w") as f:
            f.write(str(self.host_id))
        return True

    def _pad_to_mesh(self, pages: np.ndarray) -> np.ndarray:
        """Pad a chunk to a multiple of the pages axis (last chunk or
        chunk_size not divisible by the mesh) by repeating page 0."""
        n_pages_axis = self.mesh.shape[self.mesh.axis_names[0]]
        pad = -len(pages) % n_pages_axis
        if pad:
            pages = np.concatenate([pages, np.repeat(pages[:1], pad, 0)])
        return pages

    def _dispatch_chunk(self, start: int, total_pages: int, source,
                        m: BatchMetrics | None = None) -> dict:
        """Load a chunk from the source and enqueue transfer + compute.
        Returns immediately (JAX dispatch is async): the H2D transfer and
        the XLA program run while the host loads the NEXT chunk and
        while the previous chunk's results stream back — the pipelined
        run() keeps one chunk in flight, overlapping H2D, compute, and
        D2H (SURVEY.md §7 hard-part 5: overlap loading with compute).

        Synchronous shard/dispatch failures get the same bounded retry
        as async ones (the pipelined split must not narrow the retry
        coverage the serial path had)."""
        n = min(self.chunk_size, total_pages - start)
        idx = np.arange(start, start + n)
        pages = self._pad_to_mesh(np.asarray(source(idx)))
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.perf_counter()
                # host array straight to the mesh: each device receives
                # only its own shard (no staging through device 0)
                sharded = shard_pages(pages, self.mesh)
                # wait for the H2D transfer ONLY (not the compute): the
                # source's double buffer may be recycled as soon as we
                # return, and this wait runs while the device still
                # computes the previous chunk
                jax.block_until_ready(sharded)
                out = self.fn(sharded)
                break
            except _RETRYABLE:
                if attempt == self.max_retries:
                    raise
                if m is not None:
                    m.retries += 1
        return {"start": start, "n": n, "idx": idx, "t0": t0,
                "shape": pages.shape, "out": out}

    def _complete_chunk(self, info: dict, source, sink,
                        m: BatchMetrics) -> None:
        """Block on a dispatched chunk's results, deliver, and record.
        Async execution errors surface here; retries re-fetch the chunk
        from the source (its buffer may have been recycled) and re-run
        synchronously."""
        for attempt in range(self.max_retries + 1):
            try:
                out = np.asarray(jax.block_until_ready(info["out"]))
                break
            except _RETRYABLE:
                if attempt == self.max_retries:
                    raise
                m.retries += 1
                pages = self._pad_to_mesh(np.asarray(source(info["idx"])))
                sharded = shard_pages(pages, self.mesh)
                info["out"] = self.fn(sharded)
        dt = time.perf_counter() - info["t0"]
        n = info["n"]
        if sink is not None:
            sink(info["idx"], out[:n])
        self._mark_done(info["start"], n, dt)
        m.pages += n
        m.megapixels += n * info["shape"][1] * info["shape"][2] / 1e6
        m.chunks += 1
        m.chunk_seconds.append(dt)

    def _process_chunk(self, start: int, total_pages: int, source, sink,
                       m: BatchMetrics) -> None:
        """Serial dispatch + complete (used by the steal path)."""
        self._complete_chunk(
            self._dispatch_chunk(start, total_pages, source, m),
            source, sink, m)

    def run(self, total_pages: int, source, sink=None) -> BatchMetrics:
        m = BatchMetrics()
        t_all = time.perf_counter()
        all_starts = list(range(0, total_pages, self.chunk_size))
        # phase 1: this host's own chunks, software-pipelined one deep —
        # chunk i+1's host load + H2D run while chunk i computes, and
        # chunk i's D2H + sink run while i+1 computes. Peak device
        # memory holds two chunks' in/out buffers; size chunks for it.
        pending = None
        for start in all_starts:
            if start in self._done or self._owner(start) != self.host_id:
                continue
            info = self._dispatch_chunk(start, total_pages, source, m)
            if pending is not None:
                self._complete_chunk(pending, source, sink, m)
            pending = info
        if pending is not None:
            self._complete_chunk(pending, source, sink, m)
        # phase 2 (failure response): steal unfinished chunks from stale
        # hosts; wait on live peers until the whole batch is complete
        while self.heartbeat is not None and self.n_hosts > 1:
            self._reload_done()
            remaining = [s for s in all_starts if s not in self._done]
            if not remaining:
                break
            stale = set(self.heartbeat.stale_hosts())
            stole = False
            for start in remaining:
                if self._owner(start) in stale and self._claim(start):
                    self._process_chunk(start, total_pages, source, sink, m)
                    m.stolen += 1
                    stole = True
            if not stole:
                time.sleep(self.steal_poll)
        m.seconds = time.perf_counter() - t_all
        return m
