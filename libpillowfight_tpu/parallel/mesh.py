"""Device mesh + sharding helpers (SURVEY.md §2.4, §5).

The reference has no distribution at all (single-process C, one image per
call; ACE's pthreads are the only parallelism). Here distribution is
first-class: pages shard over a ("pages",) data axis and, for huge pages,
rows of one page shard over a ("rows",) spatial axis with halo exchange
(see halo.py). Collectives go through jax.sharding + shard_map; every
device reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PAGES_AXIS = "pages"
ROWS_AXIS = "rows"


def map_sharded_pages(fn, mesh: Mesh):
    """Data-parallel page map: shard_map over the pages axis; each device
    runs `fn` on its local page shard. The rows axis must be size 1 —
    spatial sharding goes through GSPMD (jit over page_sharding)."""
    if mesh.shape[ROWS_AXIS] != 1:
        raise ValueError("map_sharded_pages needs a pages-only mesh")
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=P(PAGES_AXIS),
        out_specs=P(PAGES_AXIS),
        check_vma=False,
    )


def make_mesh(n_devices: int | None = None, rows: int = 1) -> Mesh:
    """2-D mesh (pages, rows). rows > 1 enables intra-page spatial sharding."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n % rows != 0:
        raise ValueError(f"{n} devices not divisible by rows={rows}")
    arr = np.array(devs[:n]).reshape(n // rows, rows)
    return Mesh(arr, (PAGES_AXIS, ROWS_AXIS))


def page_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a [B, H, W, ...] page batch: B over pages, H over rows."""
    return NamedSharding(mesh, P(PAGES_AXIS, ROWS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_pages(pages, mesh: Mesh) -> jax.Array:
    """Place a page batch on the mesh (B over pages-axis, H over rows-axis).
    A host (numpy) batch goes to each device as that device's shard only."""
    return jax.device_put(pages, page_sharding(mesh))
