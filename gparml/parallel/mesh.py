"""Device mesh construction and data-sharding helpers.

The replacement for GParML's partition bookkeeping
(``local_MapReduce.py`` folder/partition management, SURVEY.md §2 [C-HIGH]):
a 1-D ``jax.sharding.Mesh`` over the data axis plays the role of the worker
pool; per-partition ``.npy`` files become (N, Q)/(N, D) arrays sharded over
that axis with ``NamedSharding``. The same code path runs on the devices of
one host or of many hosts — the mesh just spans more devices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    return Mesh(np.asarray(devices[:n]), (axis,))


def data_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Sharding for (N, ...) arrays: split axis 0 over the data axis."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_data(mesh: Mesh, *arrays, axis: str = DATA_AXIS):
    """Pad leading axis to a multiple of the mesh size, shard over the mesh,
    and return (padded arrays..., weights) where weights is the sharded (N',)
    0/1 mask that keeps sufficient statistics exact under padding.

    This is the moral equivalent of the reference's data partitioner (one
    partition file per worker); padding replaces its tolerance of uneven
    partition sizes.
    """
    k = mesh.devices.size
    n = arrays[0].shape[0]
    n_pad = pad_to_multiple(n, k)
    sh = data_sharding(mesh, axis)
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.shape[0] != n:
            raise ValueError("all arrays must share the leading dimension")
        if n_pad != n:
            pad_block = np.ones((n_pad - n,) + a.shape[1:], dtype=a.dtype)
            a = np.concatenate([a, pad_block], axis=0)
        out.append(jax.device_put(a, sh))
    w = np.zeros((n_pad,), dtype=np.asarray(arrays[0]).dtype)
    w[:n] = 1.0
    out.append(jax.device_put(w, sh))
    return tuple(out)
