"""Multi-controller streaming: 2 OS processes, each
owning the batch-strided half of the corpus (its slice of every global
batch + the host per-doc state for those rows), streaming its own
batches — trajectory must equal the single-process streaming run of the
identical GLOBAL configuration to 1e-10, for both StreamingLDA and
StreamingCTPF, batch and online modes; the directory checkpoint written
by the 2-process run must restore single-process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

import pytest

pytestmark = pytest.mark.slow  # heavy: real OS processes

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "streaming_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_group(nproc, mode, *extras, local_devices=1):
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if local_devices > 1:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count="
                            f"{local_devices}").strip()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), str(nproc), str(port), mode]
        + list(extras),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=os.path.dirname(_HERE), text=True) for i in range(nproc)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=480)
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def _run_pair(mode, ckpt_dir=None, local_devices=1):
    extras = (f"ckpt={ckpt_dir}",) if ckpt_dir else ()
    return _run_group(2, mode, *extras, local_devices=local_devices)


def _single_lda(online=False):
    import jax

    jax.config.update("jax_enable_x64", True)
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus
    from topicmodelsvb_jl_tpu.streaming import StreamingLDA

    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    s = StreamingLDA(packed, 3, batch_docs=32, chunk_docs=8,
                     dtype="float64", seed=3)
    if online:
        s.train_online(epochs=2, tau0=4.0, kappa=0.7, checkelbo=1,
                       printelbo=False, shuffle_seed=11)
    else:
        s.train(iter=3, tol=0.0, checkelbo=1, printelbo=False)
    return s, packed


def test_two_process_streaming_lda_matches_single(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    outs = _run_pair("lda", ckpt_dir)
    # both processes agree bitwise on globals and the reduced trace
    np.testing.assert_array_equal(outs[0]["glob"], outs[1]["glob"])
    np.testing.assert_array_equal(
        [t[1] for t in outs[0]["trace"]], [t[1] for t in outs[1]["trace"]])
    # shards are the disjoint batch-strided halves (L=16, G=32)
    assert outs[0]["g_rows"] == [*range(0, 16), *range(32, 48)]
    assert outs[1]["g_rows"] == [*range(16, 32), *range(48, 64)]

    single, packed = _single_lda()
    strace = [e for _, e, _ in single.trace]
    mtrace = [t[1] for t in outs[0]["trace"]]
    np.testing.assert_allclose(mtrace, strace, rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                               rtol=1e-10)
    # per-doc state: each process's shard matches the single run's rows
    g = np.asarray(single.gamma)
    np.testing.assert_allclose(outs[0]["gamma0"], g[outs[0]["g_rows"]],
                               rtol=1e-10)
    np.testing.assert_allclose(outs[1]["gamma0"], g[outs[1]["g_rows"]],
                               rtol=1e-10)

    # the 2-process DIRECTORY checkpoint restores in THIS single process
    from topicmodelsvb_jl_tpu import streaming as st

    done = sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("ckpt_iter") and not d.endswith(".tmp"))
    assert done
    path = os.path.join(ckpt_dir, done[-1])
    assert os.path.isdir(path)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    loaded = st.load(path, packed)
    np.testing.assert_allclose(np.asarray(loaded.beta),
                               np.asarray(single.beta), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(loaded.gamma), g, rtol=1e-10)


def test_two_process_streaming_lda_local_mesh_matches_single():
    """Streaming x in-process DP x cross-process reduction: each of the
    2 processes sweeps its shard over a LOCAL 2-device mesh; trajectory
    must still equal the plain single-process run."""
    outs = _run_pair("lda_mesh", local_devices=2)
    single, _ = _single_lda()
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                               rtol=1e-10)


def test_two_process_streaming_lda_online_matches_single():
    outs = _run_pair("lda_online")
    single, _ = _single_lda(online=True)
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                               rtol=1e-10)


def test_two_process_streaming_ctpf_matches_single():
    import jax

    jax.config.update("jax_enable_x64", True)
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus
    from topicmodelsvb_jl_tpu.streaming import StreamingCTPF

    outs = _run_pair("ctpf")
    corp = tm.synth_corpus(M=48, V=30, K=3, U=12, seed=6, mean_readers=3)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         with_readers=True, dtype=np.float64)
    single = StreamingCTPF(packed, 3, batch_docs=24, chunk_docs=6,
                           dtype="float64", seed=9)
    single.train(iter=3, tol=0.0, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.alef),
                               rtol=1e-10)
    g = np.asarray(getattr(single, single._doc_state[0]))
    np.testing.assert_allclose(outs[0]["gamma0"], g[outs[0]["g_rows"]],
                               rtol=1e-10)
    np.testing.assert_allclose(outs[1]["gamma0"], g[outs[1]["g_rows"]],
                               rtol=1e-10)


def _single_generic(cls_name, packed_kind="lda"):
    import jax

    jax.config.update("jax_enable_x64", True)
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import streaming as st
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus, unit_counts

    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    if packed_kind == "hmtm":
        packed = unit_counts(packed)
    s = getattr(st, cls_name)(packed, 3, batch_docs=32, chunk_docs=8,
                              dtype="float64", seed=3)
    s.train(iter=3, tol=0.0, checkelbo=1, printelbo=False)
    return s, packed


def test_two_process_streaming_ctm_matches_single():
    """Multi-controller breadth: a CTM-family member —
    moment statistics (vsq/lam sums + lam outer) reduce across
    processes, not just count tables."""
    outs = _run_group(2, "ctm")
    single, _ = _single_generic("StreamingCTM")
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                               rtol=1e-10)
    g = np.asarray(getattr(single, single._doc_state[0]))
    np.testing.assert_allclose(outs[0]["gamma0"], g[outs[0]["g_rows"]],
                               rtol=1e-10)


def test_two_process_streaming_hmtm_matches_single():
    """Multi-controller breadth: HMTM — chain-posterior
    statistics (beta counts + pi/theta expected-log sums) reduce across
    processes."""
    outs = _run_group(2, "hmtm")
    single, _ = _single_generic("StreamingHMTM", packed_kind="hmtm")
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                               rtol=1e-10)


def test_two_process_streaming_flda_fctm_dtm_matches_single():
    """Multi-controller breadth, completed to all seven families
    (one CTM-family member + HMTM; fLDA, fCTM
    and DTM close the matrix).  DTM additionally checks that the
    [T, K, V] smoother state evolves identically while per-doc state is
    process-sharded."""
    for mode, cls_name in (("flda", "StreamingFLDA"),
                           ("fctm", "StreamingFCTM")):
        outs = _run_group(2, mode)
        single, _ = _single_generic(cls_name)
        np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                                   [e for _, e, _ in single.trace],
                                   rtol=1e-10)
        np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                                   rtol=1e-10)

    outs = _run_group(2, "dtm")
    import jax

    jax.config.update("jax_enable_x64", True)
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus
    from topicmodelsvb_jl_tpu.streaming import StreamingDTM

    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    sid = np.zeros(packed.M_pad, np.int32)
    sid[packed.M_pad // 2:] = 1
    single = StreamingDTM(packed, 3, T=2, slice_id=sid, batch_docs=32,
                          chunk_docs=8, dtype="float64", seed=3)
    single.train(iter=3, tol=0.0, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(
        outs[0]["glob"],
        np.asarray(single.betahat).reshape(-1), rtol=1e-10)
    g = np.asarray(single.gamma)
    np.testing.assert_allclose(outs[0]["gamma0"], g[outs[0]["g_rows"]],
                               rtol=1e-10)
    np.testing.assert_allclose(outs[1]["gamma0"], g[outs[1]["g_rows"]],
                               rtol=1e-10)


def test_two_process_streaming_disk_backed_matches_single(tmp_path):
    """The flagship composition: multi-controller ×
    literal disk streaming.  The corpus is packed ONCE to a shared
    read-only dir; each process memmaps it (touching only its own
    batch-strided rows) and keeps its per-doc state in writable
    per-process memmaps — no process materialises the full corpus or
    state in RAM.  Trajectory must equal the plain single-process run."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus, save_packed

    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    pdir = str(tmp_path / "packed")
    save_packed(pdir, packed)
    sdir = str(tmp_path / "state")

    outs = _run_group(2, "lda_disk", f"packed={pdir}", f"state={sdir}")
    single, _ = _single_lda()
    for o in outs:
        # corpus arrives as read-only memmaps; state lives on disk
        assert o["corpus_is_memmap"] and o["state_is_memmap"], o
        # each process holds ONLY its half of the per-doc state rows
        assert o["state_rows"] == packed.M_pad // 2, o["state_rows"]
        assert o["state_file"] == f"gamma.proc{o['proc']}.npy", o
    np.testing.assert_allclose([t[1] for t in outs[0]["trace"]],
                               [e for _, e, _ in single.trace], rtol=1e-10)
    np.testing.assert_allclose(outs[0]["glob"], np.asarray(single.beta),
                               rtol=1e-10)
    # the per-process state memmaps really are on disk, one per process
    files = sorted(os.listdir(sdir))
    assert "gamma.proc0.npy" in files and "gamma.proc1.npy" in files


def test_elastic_restore_any_process_count(tmp_path):
    """Elastic N→M restore: a 2-process directory
    checkpoint resumes at 4 processes and a 4-process one at 2, each
    continuing the exact single-process trajectory."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus
    from topicmodelsvb_jl_tpu.streaming import StreamingLDA

    # reference: single-process, 4 iterations
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=5)
    packed = pack_corpus(corp, pad_multiple=8, docs_multiple=16,
                         dtype=np.float64)
    ref = StreamingLDA(packed, 3, batch_docs=32, chunk_docs=8,
                       dtype="float64", seed=3)
    ref.train(iter=4, tol=0.0, checkelbo=1, printelbo=False)
    ref_trace = [e for _, e, _ in ref.trace]
    g_ref = np.asarray(ref.gamma)

    for n_save, n_resume in ((2, 4), (4, 2)):
        ck = str(tmp_path / f"ck_{n_save}to{n_resume}")
        _run_group(n_save, "lda_ckpt", f"ckpt={ck}", "every=2", "iters=2")
        path = os.path.join(ck, "ckpt_iter000002")
        assert os.path.isdir(path), os.listdir(ck)
        outs = _run_group(n_resume, "lda_resume", f"resume={path}",
                          "iters=2")
        # every resuming process reports the SAME continued trace…
        for o in outs:
            np.testing.assert_allclose(
                [t[1] for t in o["trace"]], ref_trace, rtol=1e-10)
        np.testing.assert_allclose(outs[0]["glob"], np.asarray(ref.beta),
                                   rtol=1e-10)
        # …and the re-sharded per-doc state matches the reference rows
        for o in outs:
            np.testing.assert_allclose(
                o["gamma0"], g_ref[o["g_rows"]], rtol=1e-10,
                err_msg=f"{n_save}->{n_resume} proc {o['proc']}")
