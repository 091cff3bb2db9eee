"""Worker for the multi-controller STREAMING tests (
r4 #4/#5).

Launched by tests/test_streaming_multiprocess.py as N OS processes.
Each process owns a batch-strided document shard (its L-row slice of
every global batch + the host per-doc state for those rows), streams
its own batches through its local device, and the sufficient
statistics / bound reduce across processes per sweep.

Usage: python streaming_mp_worker.py <proc_id> <nproc> <port> <mode> [k=v ...]
  mode ∈ {lda, lda_mesh, lda_online, ctpf, ctm, hmtm, flda, fctm, dtm,
          lda_disk, lda_ckpt, lda_resume}
  k=v extras: ckpt=<dir>        auto-checkpoint directory
              every=<n>         auto-checkpoint cadence (default 3)
              iters=<n>         training iterations (default 3)
              packed=<dir>      lda_disk: load_packed read-only memmaps
              state=<dir>       lda_disk: writable per-doc state memmaps
              resume=<path>     lda_resume: streaming checkpoint to load
Prints one JSON line per process (the test reads process 0's).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mode = sys.argv[4]
extra = dict(kv.split("=", 1) for kv in sys.argv[5:])
ckpt_dir = extra.get("ckpt")
iters = int(extra.get("iters", 3))
every = int(extra.get("every", 3))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from topicmodelsvb_jl_tpu.parallel import multihost  # noqa: E402

multihost.initialize(f"localhost:{port}", nproc, proc_id)
assert jax.process_count() == nproc, jax.process_count()

import numpy as np  # noqa: E402

import topicmodelsvb_jl_tpu as tm  # noqa: E402
from topicmodelsvb_jl_tpu.ops.packing import pack_corpus  # noqa: E402
from topicmodelsvb_jl_tpu import streaming as st  # noqa: E402

extra_out = {}
ck = dict(checkpoint_every=(every if ckpt_dir else 0),
          checkpoint_dir=ckpt_dir)

if mode == "ctpf":
    corp = tm.synth_corpus(M=48, V=30, K=3, U=12, seed=6, mean_readers=3)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         with_readers=True, dtype=np.float64)
    s = st.StreamingCTPF(packed, 3, batch_docs=24, chunk_docs=6,
                         dtype="float64", seed=9)
    s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
    glob = np.asarray(s.alef)
elif mode == "ctm":
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    s = st.StreamingCTM(packed, 3, batch_docs=32, chunk_docs=8,
                        dtype="float64", seed=3)
    s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
    glob = np.asarray(s.beta)
elif mode == "hmtm":
    from topicmodelsvb_jl_tpu.ops.packing import unit_counts

    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = unit_counts(pack_corpus(corp, pad_multiple=8,
                                     docs_multiple=16, dtype=np.float64))
    s = st.StreamingHMTM(packed, 3, batch_docs=32, chunk_docs=8,
                         dtype="float64", seed=3)
    s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
    glob = np.asarray(s.beta)
elif mode in ("flda", "fctm"):
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    cls = st.StreamingFLDA if mode == "flda" else st.StreamingFCTM
    s = cls(packed, 3, batch_docs=32, chunk_docs=8,
            dtype="float64", seed=3)
    s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
    glob = np.asarray(s.beta)
elif mode == "dtm":
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    sid = np.zeros(packed.M_pad, np.int32)
    sid[packed.M_pad // 2:] = 1
    s = st.StreamingDTM(packed, 3, T=2, slice_id=sid, batch_docs=32,
                        chunk_docs=8, dtype="float64", seed=3)
    s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
    glob = np.asarray(s.betahat).reshape(-1)
elif mode == "lda_disk":
    # multi-controller × literal disk streaming: the corpus comes from a
    # SHARED read-only packed dir (each process memmaps it and touches
    # only its own batch-strided rows) and the per-doc state lives in
    # writable per-process memmaps — no process ever materialises the
    # full corpus or full state in RAM.
    from topicmodelsvb_jl_tpu.ops.packing import load_packed

    packed = load_packed(extra["packed"])
    s = st.StreamingLDA(packed, 3, batch_docs=32, chunk_docs=8,
                        dtype="float64", seed=3, state_dir=extra["state"])
    s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
    glob = np.asarray(s.beta)
    extra_out = dict(
        corpus_is_memmap=isinstance(packed.terms, np.memmap),
        state_is_memmap=isinstance(s.gamma, np.memmap),
        state_rows=int(s.gamma.shape[0]),
        state_file=os.path.basename(getattr(s.gamma, "filename", "")),
    )
elif mode in ("lda_ckpt", "lda_resume", "lda", "lda_mesh", "lda_online"):
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    if mode == "lda_resume":
        s = st.load(extra["resume"], packed)
        s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
        glob = np.asarray(s.beta)
    else:
        mesh = None
        if mode == "lda_mesh":
            # per-process LOCAL mesh: streaming x in-process DP composed
            # with the cross-process reduction
            from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(local=True, axis_names=("data",))
            assert mesh.devices.size == 2, mesh.devices
        s = st.StreamingLDA(packed, 3, batch_docs=32, chunk_docs=8,
                            dtype="float64", seed=3, mesh=mesh)
        if mode == "lda_online":
            s.train_online(epochs=2, tau0=4.0, kappa=0.7, checkelbo=1,
                           printelbo=False, shuffle_seed=11)
        else:
            s.train(iter=iters, tol=0.0, checkelbo=1, printelbo=False, **ck)
        glob = np.asarray(s.beta)
else:
    raise SystemExit(f"unknown mode {mode}")

assert s.M_rows * nproc == packed.M_pad
g_rows = s._local_to_global_rows(s.M_rows, s.batch_docs,
                                 s._batch_docs_global, proc_id)
print(json.dumps({
    "proc": proc_id,
    "g_rows": g_rows.tolist(),
    "trace": [[k, e, d] for k, e, d in s.trace],
    "glob": glob.tolist(),
    # this process's shard of the per-doc state (checks the scatter)
    "gamma0": np.asarray(getattr(s, s._doc_state[0])).tolist(),
    **extra_out,
}), flush=True)
