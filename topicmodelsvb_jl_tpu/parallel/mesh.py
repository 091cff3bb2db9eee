"""Device mesh construction and data-parallel wrapping.

The reference has no multi-device capability — its only parallelism is
OpenCL kernels on one GPU (gpuLDA.jl:64).  Here every model's sweep is
wrapped in ``shard_map`` over a ``jax.sharding.Mesh``:

* **DP**: documents (and their per-doc variational state gamma/lambda/
  gimel/…) are sharded over the ``data`` axis; the sufficient-statistics
  reductions (beta_temp/kappa_temp/alef_temp/he_temp, Elogtheta_sum,
  CTM moments, ELBO scalars) are ``psum``'d — the workload's analogue of
  a gradient all-reduce (SURVEY §2.3).
* Global params (alpha/beta/mu/sigma/...) stay replicated; their
  closed-form / Newton updates run identically on every shard.
* A second ``vocab`` axis is reserved for sharding beta over V (TP) for
  very large vocabularies.

A 1-device mesh uses the exact same code path as an N-device mesh, so
single-device and multi-device execution never diverge.  Every GPU of a
host reaches every other at the same rate, so the mesh shape follows
the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    local: bool = False,
) -> Mesh:
    """Build a mesh over the available devices (default: all on ``data``).

    ``local=True`` restricts to THIS process's addressable devices —
    what multi-controller streaming wants (each process sweeps its own
    corpus shard on its own devices; parallel/multihost reduces across
    processes at sweep grain)."""
    devices = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    arr = np.array(devices).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard leading (doc) axis over the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_sharded(tree, mesh: Mesh, axis: str = "data"):
    """device_put a pytree of doc-major arrays with the doc axis sharded."""
    sh = data_sharding(mesh, axis)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def put_replicated(tree, mesh: Mesh):
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)
