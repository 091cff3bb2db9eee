#!/usr/bin/env python
"""DP scaling-efficiency harness.

Measures weak-scaling efficiency of the sharded LDA step over an
N-virtual-device CPU mesh: each device gets a fixed per-device document
load, so perfect scaling keeps step time flat (efficiency = t1 / tN).

This validates the collective structure (psum'd sufficient statistics,
sharded per-doc state).  CAVEAT: virtual CPU devices time-share the
host's physical cores, so on a 1-core host the reported "efficiency"
measures core contention, not collective overhead — the numbers are
only meaningful with >= N real cores or on real devices (set
SCALING_PLATFORM=gpu on a multi-GPU host).

Multi-process mode (SCALING_NPROC=2): the same measurement across REAL
process boundaries — N OS processes × (8/N) virtual devices each, a
global 8-device mesh through jax.distributed, per-process data
placement, and cross-process sufficient-statistic psums — so the
collective structure is exercised where the in-process virtual mesh
cannot exercise it.  Same caveat: on a 1-core host the
numbers measure core contention.

Prints one JSON line per mesh size plus a summary line.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_N_DEV_TOTAL = 8

if "--worker" in sys.argv:
    i = sys.argv.index("--worker")
    _proc_id, _nproc, _port = (int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                               sys.argv[i + 3])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={_N_DEV_TOTAL // _nproc}")
else:
    _proc_id = None
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={_N_DEV_TOTAL}"
        ).strip()

import jax

if os.environ.get("SCALING_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from bench import make_packed_nsf_scale
from topicmodelsvb_jl_tpu.models import lda as lda_mod
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.parallel.shard import dp_jit


def run(n_dev: int, docs_per_dev: int, K: int, iters: int = 3) -> float:
    chunk = min(256, docs_per_dev)
    packed = make_packed_nsf_scale(
        M=docs_per_dev * n_dev, V=4096, mean_terms=40,
        chunk_docs=chunk, pad_multiple=32)
    mesh = make_mesh(n_devices=n_dev, axis_names=("data",))
    state = lda_mod.init(jax.random.PRNGKey(0), packed, K, jnp.float32)
    step_local = lda_mod.make_step(
        packed, K, viter=5, vtol=1.0 / K**2, niter=100, ntol=1.0 / K**2,
        chunk_docs=chunk, axis_name="data", use_pallas=False)
    spec = lda_mod.partition_spec("data")
    step = dp_jit(step_local, mesh, spec, n_data_args=3, n_repl_args=1)
    data = (jnp.asarray(packed.terms), jnp.asarray(packed.counts),
            jnp.asarray(packed.doc_mask),
            jnp.asarray(float(packed.M), jnp.float32))
    state = step(state, *data)
    jax.block_until_ready(state.beta)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state, *data)
    jax.block_until_ready(state.beta)
    return (time.perf_counter() - t0) / iters


def run_worker():
    """Multi-process member: global 8-device mesh over N processes."""
    from topicmodelsvb_jl_tpu.parallel import multihost

    multihost.initialize(f"localhost:{_port}", _nproc, _proc_id)
    K = int(os.environ.get("SCALING_K", 32))
    per_dev = int(os.environ.get("SCALING_DOCS_PER_DEV", 2048))
    iters = 3
    chunk = min(256, per_dev)

    from topicmodelsvb_jl_tpu.api import LDA
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

    packed = make_packed_nsf_scale(
        M=per_dev * _N_DEV_TOTAL, V=4096, mean_terms=40,
        chunk_docs=chunk, pad_multiple=32)
    rt = RuntimeConfig(chunk_docs=chunk, use_pallas=False)
    model = LDA(packed, K, runtime=rt, seed=0)
    assert model.mesh.devices.size == _N_DEV_TOTAL
    # warm (compile) then timed run
    model.train(iter=1, checkelbo=float("inf"), printelbo=False)
    t0 = time.perf_counter()
    model.train(iter=iters, checkelbo=float("inf"), printelbo=False)
    step_s = (time.perf_counter() - t0) / iters
    if _proc_id == 0:
        print(json.dumps({
            "mode": "multiprocess", "processes": _nproc,
            "mesh": _N_DEV_TOTAL, "docs": per_dev * _N_DEV_TOTAL,
            "step_s": round(step_s, 4),
        }), flush=True)


def run_multiproc(nproc: int):
    """Spawn nproc copies of this script as distributed workers."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--worker", str(i), str(nproc), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for i in range(nproc)]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed rc={p.returncode}")
        if out.strip():
            print(out.strip())


def main():
    nproc = int(os.environ.get("SCALING_NPROC", 0))
    if nproc > 1:
        run_multiproc(nproc)
        return
    K = int(os.environ.get("SCALING_K", 32))
    per_dev = int(os.environ.get("SCALING_DOCS_PER_DEV", 2048))
    sizes = [1, 2, 4, 8]
    times = {}
    for n in sizes:
        if n > len(jax.devices()):
            break
        times[n] = run(n, per_dev, K)
        print(json.dumps({
            "mesh": n, "docs": per_dev * n,
            "step_s": round(times[n], 4),
            "weak_scaling_eff": round(times[1] / times[n], 3),
        }))
    effs = {n: times[1] / t for n, t in times.items()}
    print(json.dumps({
        "metric": "lda_dp_weak_scaling_efficiency",
        "value": round(min(effs.values()), 3),
        "unit": "t1/tN",
        "per_mesh": {str(n): round(e, 3) for n, e in effs.items()},
    }))


if __name__ == "__main__":
    if _proc_id is not None:
        run_worker()
    else:
        main()
