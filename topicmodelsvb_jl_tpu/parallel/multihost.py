"""Multi-host initialisation and corpus sharding helpers.

The reference is strictly single-process (SURVEY §2.3); this module is
the build's multi-host entry point.  Workflow on N GPU processes (one
per host, or one per card):

    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.parallel import multihost

    multihost.initialize("host0:1234", N, i)  # jax.distributed handshake
    corp = tm.readcorp(...)                 # every host loads/receives the corpus
    model = tm.LDA(corp, K)                 # mesh spans all hosts' devices
    model.train(...)

Every host runs the same program; `make_mesh` already builds the mesh
over `jax.devices()` (global across hosts once initialised), and the
shard_map'd steps place each host's addressable shard of the doc axis
locally.  Sufficient-statistic psums ride NVLink within a host and the
network across hosts — XLA's collective layer (NCCL on GPUs) is the
backend (SURVEY §5.8).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """`jax.distributed.initialize` with env-var defaults.

    A GPU host detects none of them: every process must pass the
    coordinator's ``host:port`` (any free port on process 0's host),
    the number of processes and its own id, unless a cluster launcher
    (e.g. SLURM) that JAX recognises provides them.  Safe to call once
    per process, before any device computation.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_initialized() -> bool:
    try:
        return jax.process_count() > 1 or jax._src.distributed.global_state.client is not None
    except Exception:
        return False


def make_global_array(a, mesh, spec):
    """Device-place a host array onto a (possibly multi-process) mesh.

    Single-process: plain ``device_put``.  Multi-process (multi-
    controller JAX): every process holds the same host array — the
    documented workflow above, every host loads the corpus — and
    provides its addressable shards via ``make_array_from_callback``,
    which is the supported way to build a global jax.Array whose
    sharding spans non-addressable devices.
    """
    import numpy as np
    from jax.sharding import NamedSharding

    sh = spec if isinstance(spec, NamedSharding) else NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(a, sh)
    if isinstance(a, jax.Array) and not a.is_fully_addressable:
        # already a global array (e.g. the state of a previous train()
        # call); its value cannot be fetched host-side, and it is
        # already placed — pass it through unchanged
        return a
    host = np.asarray(a)
    return jax.make_array_from_callback(host.shape, sh, lambda idx: host[idx])


def make_global_state(tree, sharding_tree):
    """Tree-map :func:`make_global_array` over a state pytree whose
    shardings were already resolved to NamedShardings."""
    return jax.tree_util.tree_map(
        lambda a, sh: make_global_array(a, None, sh), tree, sharding_tree)


def process_doc_range(M: int) -> tuple:
    """[start, end) of the documents this host should own under the
    default contiguous doc sharding (useful for host-side corpus IO
    when each host reads only its own shard)."""
    n = jax.process_count()
    i = jax.process_index()
    per = -(-M // n)
    return i * per, min((i + 1) * per, M)
