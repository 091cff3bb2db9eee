"""Fault injection: SIGKILL a training process, resume from the last
auto-checkpoint, reproduce the uninterrupted ELBO trace (SURVEY §5.3).

The pieces this closes end-to-end: the Trainer's checkpoint_every
cadence (engine.py), atomic checkpoint writes (api._trainer_kw's
tmp+rename callback), checkpoint portability (checkpoint.py), and
exact ELBO-trace continuation on resume.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

import pytest

pytestmark = pytest.mark.slow  # heavy: real OS processes

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "faultinject_worker.py")
_MP_WORKER = os.path.join(_HERE, "faultinject_mp_worker.py")


def _wait_for_checkpoints(ckpt_dir, min_count, timeout_s=240):
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if os.path.isdir(ckpt_dir):
            done = [f for f in os.listdir(ckpt_dir)
                    if f.startswith("ckpt_iter") and not f.endswith(".tmp")]
            if len(done) >= min_count:
                return sorted(done)
        time.sleep(0.05)
    raise AssertionError("worker produced no checkpoints in time")


def test_sigkill_and_resume_reproduces_elbo_trace(tmp_path):
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import checkpoint as ckptlib
    from topicmodelsvb_jl_tpu.api import LDA
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

    ckpt_dir = str(tmp_path / "ckpts")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, _WORKER, ckpt_dir],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=env, cwd=os.path.dirname(_HERE), text=True,
    )
    try:
        # let a few checkpoints land, then kill without warning mid-run
        _wait_for_checkpoints(ckpt_dir, min_count=2)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL

    files = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt_iter") and not f.endswith(".tmp"))
    assert files, "no completed checkpoint survived the kill"
    last = files[-1]
    k_ckpt = int(last.replace("ckpt_iter", ""))

    # uninterrupted reference run, identical config/seed
    total = k_ckpt + 4
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=21)
    rt = RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)
    ref = LDA(corp, 3, runtime=rt, seed=9)
    ref.train(iter=total, tol=0.0, checkelbo=1, printelbo=False)
    ref_trace = [r.elbo for r in ref.trainer.trace if r.elbo is not None]

    # resume from the killed run's last checkpoint
    resumed = ckptlib.load(os.path.join(ckpt_dir, last), corp)
    assert resumed.trained_iters == k_ckpt
    resumed.train(iter=total - k_ckpt, tol=0.0, checkelbo=1, printelbo=False)
    res_trace = [r.elbo for r in resumed.trainer.trace if r.elbo is not None]

    # the resumed trace must continue the uninterrupted trajectory exactly
    np.testing.assert_allclose(res_trace, ref_trace[k_ckpt:], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(resumed.beta), np.asarray(ref.beta),
                               rtol=1e-10)
    # ...and the global iteration numbering continues without collision
    assert [r.k for r in resumed.trainer.trace] == \
        list(range(k_ckpt + 1, total + 1))
    assert resumed.trained_iters == total


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_mp(proc_id, nproc, port, ckpt_dir, mode, extra=()):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu via jax.config
    return subprocess.Popen(
        [sys.executable, _MP_WORKER, str(proc_id), str(nproc), str(port),
         ckpt_dir, mode, *map(str, extra)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=os.path.dirname(_HERE), text=True,
    )


def test_multiprocess_sigkill_and_resume(tmp_path):
    """The distributed recovery bar: SIGKILL a
    2-OS-process training run mid-flight, resume it as 2 processes from
    the last directory checkpoint, and reproduce the uninterrupted ELBO
    trace to 1e-10.  Also restores the same checkpoint single-process —
    per-doc leaves are keyed by doc id, so the format is process-count
    portable."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import checkpoint as ckptlib
    from topicmodelsvb_jl_tpu.api import LDA
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig

    ckpt_dir = str(tmp_path / "ckpts")
    nproc, port = 2, _free_port()
    procs = [_spawn_mp(i, nproc, port, ckpt_dir, "train")
             for i in range(nproc)]
    try:
        _wait_for_checkpoints(ckpt_dir, min_count=2)
        for p in procs:            # kill every "host" without warning
            p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == -signal.SIGKILL for p in procs)

    done = sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("ckpt_iter") and not d.endswith(".tmp"))
    assert done, "no completed checkpoint survived the kill"
    last = done[-1]
    assert os.path.isdir(os.path.join(ckpt_dir, last))
    assert os.path.exists(os.path.join(ckpt_dir, last, "manifest.json"))
    k_ckpt = int(last.replace("ckpt_iter", ""))
    total = k_ckpt + 3

    # uninterrupted single-process reference on a 4-device mesh (the
    # same global device count the 2×2-device workers had)
    corp = tm.synth_corpus(M=64, V=40, K=3, seed=21)
    rt = RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)
    ref = LDA(corp, 3, runtime=rt, mesh=make_mesh(n_devices=4), seed=9)
    ref.train(iter=total, tol=0.0, checkelbo=1, printelbo=False)
    ref_trace = [r.elbo for r in ref.trainer.trace if r.elbo is not None]

    # resume as 2 fresh OS processes
    port2 = _free_port()
    rprocs = [_spawn_mp(i, nproc, port2, ckpt_dir, "resume", (total,))
              for i in range(nproc)]
    outs = []
    for p in rprocs:
        out, err = p.communicate(timeout=480)
        assert p.returncode == 0, f"resume worker failed:\n{err[-4000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0]["k_ckpt"] == k_ckpt
    np.testing.assert_array_equal(outs[0]["beta"], outs[1]["beta"])
    np.testing.assert_allclose(outs[0]["elbo"], ref_trace[k_ckpt:],
                               rtol=1e-10)
    np.testing.assert_allclose(outs[0]["beta"], np.asarray(ref.beta),
                               rtol=1e-10)

    # cross-process-count restore: the 2-process checkpoint loads and
    # continues in THIS single process, matching the same trajectory
    # AND the same global iteration numbering
    single = ckptlib.load(os.path.join(ckpt_dir, last), corp)
    single.train(iter=total - k_ckpt, tol=0.0, checkelbo=1, printelbo=False)
    strace = [r.elbo for r in single.trainer.trace if r.elbo is not None]
    np.testing.assert_allclose(strace, ref_trace[k_ckpt:], rtol=1e-10)
    assert [r.k for r in single.trainer.trace] == \
        list(range(k_ckpt + 1, total + 1))


def test_checkpoint_overwrites_same_iter_leftovers(tmp_path):
    """Stale same-named leftovers (what a killed run leaves behind) —
    including the multi-host DIRECTORY format and stale .tmp artifacts —
    must be replaced, not crash os.replace
    (ENOTEMPTY/IsADirectoryError)."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import RuntimeConfig
    from topicmodelsvb_jl_tpu.api import LDA

    ckpt_dir = str(tmp_path / "ck")
    os.makedirs(ckpt_dir)
    # plant a non-empty DIRECTORY where iter-2's checkpoint will land
    # (what a killed multi-host run leaves behind) and a stale tmp dir
    for name in ("ckpt_iter000002", "ckpt_iter000002.tmp"):
        os.makedirs(os.path.join(ckpt_dir, name))
        with open(os.path.join(ckpt_dir, name, "proc0.npz"), "wb") as f:
            f.write(b"stale")

    corp = tm.synth_corpus(M=32, V=24, K=2, seed=4)
    rt = RuntimeConfig(chunk_docs=8, pad_multiple=8,
                       checkpoint_every=2, checkpoint_dir=ckpt_dir)
    model = LDA(corp, 2, runtime=rt, seed=1)
    model.train(iter=4, tol=0.0, checkelbo=1, printelbo=False)

    final = os.path.join(ckpt_dir, "ckpt_iter000002")
    assert os.path.isfile(final), "stale dir must be replaced by the file"
    assert not os.path.exists(final + ".tmp")
    import topicmodelsvb_jl_tpu.checkpoint as ckptlib
    resumed = ckptlib.load(final, corp)
    assert resumed.K == 2


def test_checkpoint_file_replace_never_preclears(tmp_path, monkeypatch):
    """Single-host checkpoints are plain files: the callback must rely on
    os.replace's atomicity alone — an os.remove of the existing final
    file before the replace would open a crash window with NO durable
    checkpoint for that iter (regression)."""
    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu import RuntimeConfig
    from topicmodelsvb_jl_tpu.api import LDA

    ckpt_dir = str(tmp_path / "ck")
    corp = tm.synth_corpus(M=32, V=24, K=2, seed=4)
    rt = RuntimeConfig(chunk_docs=8, pad_multiple=8,
                       checkpoint_every=2, checkpoint_dir=ckpt_dir)

    removed = []
    real_remove = os.remove
    monkeypatch.setattr(os, "remove",
                        lambda p: (removed.append(p), real_remove(p)))

    # first run writes ckpt_iter000002/4; second run re-reaches both so
    # every final write happens over an existing FILE
    for _ in range(2):
        model = LDA(corp, 2, runtime=rt, seed=1)
        model.train(iter=4, tol=0.0, checkelbo=1, printelbo=False)

    final = os.path.join(ckpt_dir, "ckpt_iter000002")
    assert os.path.isfile(final)
    assert not any(p.endswith("ckpt_iter000002") or p.endswith("000004")
                   for p in removed), f"final files were pre-cleared: {removed}"
