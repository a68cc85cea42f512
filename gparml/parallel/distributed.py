"""Multi-host (pod / cluster) execution.

Replacement for the reference's remote/cluster MapReduce backend
(SURVEY.md §2 [C-MED existence]): where GParML dispatched worker jobs over a
shared filesystem, a multi-host JAX program runs the SAME shard_map code path
over a global mesh that spans every device of every host. The pieces this
module adds around that shared path:

  * process-group initialization (idempotent, env-auto-detected on pods),
  * the contiguous global row range each process owns (``process_row_range``),
  * building globally-sharded arrays from per-host blocks WITHOUT ever
    gathering the dataset (``shard_data_multihost``; the reference's
    per-partition file reads map to per-host ``data.load_rows`` calls),
  * replicating coordinator-computed initial parameters to all processes
    (``broadcast_pytree`` — the reference wrote globals to the shared FS),
  * extracting this host's rows back out of a sharded array for per-host
    persistence (``local_block`` — the reference's per-partition file writes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from gparml.parallel.mesh import DATA_AXIS, pad_to_multiple


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the JAX process group (idempotent). On managed clusters the
    arguments are auto-detected from the environment; pass them explicitly
    elsewhere. Safe to call when the group is already up (e.g. a test
    harness initialized before invoking the CLI)."""
    if is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except Exception:
        if kwargs:
            raise  # explicit arguments that fail are a real config error
        # Auto-detection failed: not a managed pod/cluster environment.
        # A single process needs no process group (process_count() == 1 and
        # make_array_from_process_local_data work uninitialized), so the
        # remote code path degrades cleanly to one host.
        return


def is_initialized() -> bool:
    return jax.distributed.is_initialized()


def global_mesh(axis: str = DATA_AXIS) -> Mesh:
    """1-D data mesh over every device of every host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def process_row_range(n_global: int):
    """(start, stop, n_padded): the contiguous global row block THIS process
    owns. N is padded to a multiple of the total device count; each process
    owns an equal block of n_padded / process_count rows (processes are
    homogeneous on a pod, so the per-process block is a whole number of
    per-device shards). Rows >= n_global within the block are padding the
    caller does not load — ``shard_data_multihost`` weights them 0."""
    n_proc = jax.process_count()
    n_pad = pad_to_multiple(n_global, jax.device_count())
    per = n_pad // n_proc
    p = jax.process_index()
    return p * per, (p + 1) * per, n_pad


def shard_host_local(mesh: Mesh, array: np.ndarray, axis: str = DATA_AXIS):
    """Build a globally-sharded jax.Array from this host's local block of the
    data (each host loads only its own rows — the reference's per-partition
    file loading, without ever gathering to one machine).

    ``array`` is THIS host's (N_local, ...) block; hosts are ordered by
    process index along the data axis. N_local must equal N_global /
    process_count and be divisible by the local device count."""
    sharding = NamedSharding(mesh, PartitionSpec(axis))
    return jax.make_array_from_process_local_data(sharding, array)


def shard_data_multihost(mesh: Mesh, n_global: int, *local_arrays, dtype=None):
    """Multi-host analogue of ``mesh.shard_data``: each host passes the rows
    of ITS OWN [start, stop) block (from ``process_row_range``; short when
    stop overhangs n_global), and gets back globally-sharded padded arrays
    plus the 0/1 weights that keep sufficient statistics exact under padding.

    Returns (arrays..., weights)."""
    start, stop, _ = process_row_range(n_global)
    per = stop - start
    n_valid = max(0, min(stop, n_global) - start)
    w_dtype = dtype if dtype is not None else (
        np.asarray(local_arrays[0]).dtype if local_arrays else np.float32
    )
    out = []
    for a in local_arrays:
        a = np.asarray(a, dtype) if dtype is not None else np.asarray(a)
        if a.shape[0] != n_valid:
            raise ValueError(
                f"local block has {a.shape[0]} rows; this process owns rows "
                f"[{start}, {stop}) of N={n_global} -> expected {n_valid}"
            )
        if per != n_valid:
            pad = np.ones((per - n_valid,) + a.shape[1:], dtype=a.dtype)
            a = np.concatenate([a, pad], axis=0)
        out.append(shard_host_local(mesh, a))
    w = np.zeros((per,), dtype=w_dtype)
    w[:n_valid] = 1.0
    out.append(shard_host_local(mesh, w))
    return tuple(out)


def replicate(mesh: Mesh, tree):
    """Fully-replicated global arrays from host-local values (every process
    must pass the same values, e.g. after ``broadcast_pytree``). The
    multi-process-safe version of ``device_put(x, replicated)`` — a plain
    device_put cannot target non-addressable devices."""
    sh = NamedSharding(mesh, PartitionSpec())
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(sh, np.asarray(a)), tree
    )


def broadcast_pytree(tree, is_source: Optional[bool] = None):
    """Replicate a (small, host-local numpy/jax) pytree from the coordinator
    to every process — how globally-agreed initial parameters (Z, hypers)
    reach all hosts. The reference achieved this by writing globals to the
    shared filesystem; here it is one broadcast between processes."""
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(
        tree, is_source=is_coordinator() if is_source is None else is_source
    )


def local_block(arr) -> np.ndarray:
    """This host's contiguous rows of a 1-D-data-sharded global array (the
    inverse of ``shard_host_local``) — used to persist per-host partition
    files without gathering. Shards are concatenated in device order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    blocks = [np.asarray(s.data) for s in shards]
    return np.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0]


def is_coordinator() -> bool:
    return jax.process_index() == 0


def barrier(name: str = "gparml") -> None:
    """Cross-process sync point (e.g. 'all hosts finished writing their
    partition files before the coordinator reads them')."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
