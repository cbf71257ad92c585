"""Device mesh helpers.

The reference is single-threaded (SURVEY.md §2, parallelism inventory: none);
the distributed dimension of this build is specified by BASELINE.json — the
haystack corpus sharded data-parallel across chips with replicated needle
state.  The natural mesh is 2-D:

* ``data`` axis — corpus segments sharded (the byte-stream analogue of
  sequence/context parallelism); collectives: a single ``pmin`` per query
  batch.
* ``needle`` axis — query batch sharded (embarrassingly parallel); needle
  tables are small, so this axis simply partitions work.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
NEEDLE_AXIS = "needle"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, needle) mesh.  Default: all devices on the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    n_data, n_needle = shape
    if n_data * n_needle != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not cover {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_data, n_needle)
    return Mesh(arr, (DATA_AXIS, NEEDLE_AXIS))


def corpus_sharding(mesh: Mesh) -> NamedSharding:
    """Segments sharded across the data axis; rows/lanes replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, None, None))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Needle tables sharded across the needle axis, replicated over data."""
    return NamedSharding(mesh, P(NEEDLE_AXIS, None))
