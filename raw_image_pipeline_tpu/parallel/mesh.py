"""Device mesh + sharding helpers.

The reference is strictly single-frame, single-device (SURVEY.md §2.6);
scaling is a new design:

  * axis "data"  — frames are embarrassingly parallel; batches shard over
    all chips/hosts with no collectives in the steady state.
  * axis "space" — optional spatial split of each frame over H. The stencil
    ops (debayer's 1-px window, remap's gather) read across shard
    boundaries; under jit GSPMD inserts the halo exchanges / gathers, and
    per-frame reductions (CCC histogram, WB channel stats) become
    cross-device psums automatically. This is the context-parallel analogue
    for very large frames.

Use `make_mesh()` for a 1-D data mesh (the default production layout:
collectives ride ICI only for metric aggregation), or
`make_mesh(space=k)` to also split frames spatially.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None, space: int = 1) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % space != 0:
        raise ValueError(f"space={space} must divide device count {n}")
    arr = np.array(devices).reshape(n // space, space)
    return Mesh(arr, ("data", "space"))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading batch axis over 'data'; everything else replicated."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def spatial_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard batch over 'data' and H (axis 1) over 'space'."""
    return NamedSharding(mesh, P("data", "space", *([None] * (ndim - 2))))


def shard_batch(pixels: jax.Array, mesh: Mesh, spatial: bool = False) -> jax.Array:
    sh = spatial_sharding(mesh, pixels.ndim) if spatial else batch_sharding(mesh, pixels.ndim)
    return jax.device_put(pixels, sh)
