"""CLI entry point (SURVEY §5.6): python -m topicmodelsvb_jl_tpu.train."""

import json
import os

import numpy as np
import pytest

from topicmodelsvb_jl_tpu.train import run


def test_cli_trains_and_summarises(tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    ckpt = str(tmp_path / "model.ckpt")
    summary = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "64",
        "--synth-v", "40", "--k", "3", "--iter", "5", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
        "--quiet", "--metrics", metrics, "--save", ckpt, "--seed", "3",
    ])
    assert summary["iterations"] == 5
    assert summary["model"] == "lda" and summary["K"] == 3
    assert summary["final_elbo"] is not None
    assert summary["docs_per_s"] > 0 and summary["tokens_per_s"] > 0
    # JSONL metrics emitted, with elbo present on sync rows
    rows = [json.loads(l) for l in open(metrics)]
    assert len(rows) == 5
    assert all(r["elbo"] is not None for r in rows)
    assert os.path.exists(ckpt)


def test_cli_packed_scale_corpus():
    summary = run([
        "--model", "lda", "--corpus", "nsf-scale", "--subset", "512",
        "--k", "4", "--iter", "2", "--checkelbo", "inf",
        "--chunk-docs", "64", "--quiet", "--no-pallas",
    ])
    assert summary["iterations"] == 2
    assert summary["M"] == 512 and summary["V"] == 25_319


def test_cli_ctm_runs():
    summary = run([
        "--model", "ctm", "--corpus", "synth", "--synth-m", "32",
        "--synth-v", "30", "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
        "--niter", "30", "--quiet",
    ])
    deltas = summary["final_elbo"]
    assert np.isfinite(deltas)


def test_cli_streaming_and_online():
    s = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "96",
        "--synth-v", "40", "--k", "3", "--iter", "3", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "16", "--pad-multiple", "8",
        "--streaming", "--batch-docs", "48", "--quiet",
    ])
    assert s["mode"] == "streaming" and np.isfinite(s["final_elbo"])
    o = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "96",
        "--synth-v", "40", "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "16", "--pad-multiple", "8",
        "--online", "--batch-docs", "48", "--tau0", "4", "--quiet",
    ])
    assert o["mode"] == "online" and np.isfinite(o["final_elbo"])


def test_cli_streaming_ctm_and_flda():
    for model in ("ctm", "flda"):
        o = run([
            "--model", model, "--corpus", "synth", "--synth-m", "48",
            "--synth-v", "30", "--k", "3", "--iter", "3",
            "--checkelbo", "1", "--dtype", "float64", "--chunk-docs", "16",
            "--pad-multiple", "8", "--streaming", "--batch-docs", "48",
            "--quiet",
        ])
        assert o["mode"] == "streaming" and np.isfinite(o["final_elbo"])


@pytest.mark.slow
def test_cli_streaming_ctpf_with_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    s = run([
        "--model", "ctpf", "--corpus", "synth", "--synth-m", "64",
        "--synth-v", "40", "--synth-u", "10", "--k", "3", "--iter", "4",
        "--checkelbo", "1", "--dtype", "float64", "--chunk-docs", "16",
        "--pad-multiple", "8", "--streaming", "--batch-docs", "32",
        "--checkpoint-every", "2", "--checkpoint-dir", ckpt_dir, "--quiet",
    ])
    assert s["mode"] == "streaming" and np.isfinite(s["final_elbo"])
    import os
    files = [f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_iter")]
    assert files, "streaming auto-checkpoints missing"
    o = run([
        "--model", "ctpf", "--corpus", "synth", "--synth-m", "64",
        "--synth-v", "40", "--synth-u", "10", "--k", "3", "--iter", "2",
        "--checkelbo", "1", "--dtype", "float64", "--chunk-docs", "16",
        "--pad-multiple", "8", "--online", "--batch-docs", "32",
        "--tau0", "4", "--quiet",
    ])
    assert o["mode"] == "online" and np.isfinite(o["final_elbo"])


@pytest.mark.slow
def test_cli_streaming_dtm_trains_and_checkpoints(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    s = run([
        "--model", "dtm", "--corpus", "synth", "--synth-m", "64",
        "--synth-v", "40", "--synth-slices", "3", "--k", "3",
        "--iter", "3", "--checkelbo", "1", "--dtype", "float64",
        "--chunk-docs", "16", "--pad-multiple", "8", "--streaming",
        "--batch-docs", "32", "--cgiter", "5", "--delta", "1.0",
        "--checkpoint-every", "2", "--checkpoint-dir", ckpt_dir, "--quiet",
    ])
    assert s["mode"] == "streaming" and np.isfinite(s["final_elbo"])
    import os
    files = [f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_iter")]
    assert files, "streaming dtm auto-checkpoints missing"
    o = run([
        "--model", "dtm", "--corpus", "synth", "--synth-m", "64",
        "--synth-v", "40", "--synth-slices", "3", "--k", "3",
        "--iter", "2", "--checkelbo", "1", "--dtype", "float64",
        "--chunk-docs", "16", "--pad-multiple", "8", "--online",
        "--batch-docs", "32", "--cgiter", "5", "--delta", "1.0",
        "--tau0", "4", "--quiet",
    ])
    assert o["mode"] == "online" and np.isfinite(o["final_elbo"])


def test_bench_ab_order_alternates():
    """The kernel-vs-XLA A/B runs its arms in turns (A B B A A B ...), so
    slow clock drift on the card falls on both arms alike."""
    import bench

    order = bench.ab_order(5)
    assert order.count("kernel") == order.count("xla") == 5
    assert order[:4] == ["kernel", "xla", "xla", "kernel"]
    assert all(a != b for a, b in zip(order[::2], order[1::2]))


def test_bench_lines_name_the_device():
    import jax

    import bench

    f = bench.device_fields()
    assert f == {"platform": jax.devices()[0].platform,
                 "device_kind": jax.devices()[0].device_kind,
                 "device_count": len(jax.devices())}


def test_pick_stream_batch_divisibility():
    """The streaming batch choice must satisfy (batch | M_pad,
    n_dev | batch) for ANY device count — the old halving loop exited
    with invalid batches for non-power-of-two meshes (regression)."""
    from topicmodelsvb_jl_tpu.train import _pick_stream_batch

    for M_pad, want, n_dev in [(2048, 8192, 3), (2048, 8192, 1),
                               (1536, 8192, 3), (1024, 64, 4),
                               (120, 7, 5), (128, 4, 8)]:
        b = _pick_stream_batch(M_pad, want, n_dev)
        if b:
            assert M_pad % b == 0 and b % n_dev == 0 and b <= want, \
                (M_pad, want, n_dev, b)
    # no multiple of 3 divides 2^11: must report impossibility, not crash
    assert _pick_stream_batch(2048, 8192, 3) == 0
    assert _pick_stream_batch(1536, 8192, 3) == 1536


def test_cli_hmtm_expands_condensed_corpus():
    """--model hmtm must work with the bundled corpus sources (which all
    carry counts > 1): the CLI expands to one entry per token instead of
    crashing in check_order_preserving (regression)."""
    s = run([
        "--model", "hmtm", "--corpus", "synth", "--synth-m", "24",
        "--synth-v", "30", "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
        "--quiet",
    ])
    assert s["model"] == "hmtm" and np.isfinite(s["final_elbo"])


def test_pick_stream_batch_matches_bruteforce():
    """The O(sqrt M) divisor enumeration must agree with brute force."""
    from topicmodelsvb_jl_tpu.train import _pick_stream_batch

    for M_pad in (1, 7, 36, 97, 120, 1024, 1536):
        for want in (1, 5, 64, 10_000):
            for n_dev in (1, 2, 3, 8):
                brute = max((b for b in range(1, M_pad + 1)
                             if M_pad % b == 0 and b % n_dev == 0
                             and b <= want), default=0)
                assert _pick_stream_batch(M_pad, want, n_dev) == brute


@pytest.mark.slow
def test_cli_packed_dir_streaming_from_disk(tmp_path):
    """--packed-dir + --streaming + --state-dir: the full disk-backed
    path (corpus memmaps in, state memmaps out) through the CLI."""
    import numpy as np

    from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale
    from topicmodelsvb_jl_tpu.ops.packing import save_packed

    packed = synth_packed_nsf_scale(M=96, V=50, mean_terms=10, seed=4,
                                    chunk_docs=16, pad_multiple=8)
    save_packed(str(tmp_path / "corp"), packed)
    s = run([
        "--model", "lda", "--packed-dir", str(tmp_path / "corp"),
        "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "16",
        "--streaming", "--batch-docs", "32", "--quiet",
        "--state-dir", str(tmp_path / "state"),
    ])
    assert s["mode"] == "streaming" and np.isfinite(s["final_elbo"])
    assert (tmp_path / "state" / "gamma.npy").exists()


def test_cli_round5_knobs(tmp_path):
    """--checkpoint-f16 and --elogtheta-f64 reach RuntimeConfig and
    produce a working run (the §5.6 bar: every knob on the CLI)."""
    ck = str(tmp_path / "ck")
    s = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "32",
        "--synth-v", "30", "--k", "3", "--iter", "3", "--checkelbo", "1",
        "--chunk-docs", "8", "--pad-multiple", "8", "--quiet", "--seed", "3",
        "--checkpoint-every", "2", "--checkpoint-dir", ck,
        "--checkpoint-f16", "--elogtheta-f64",
    ])
    assert np.isfinite(s["final_elbo"])
    snaps = sorted(os.listdir(ck))
    assert snaps
    with np.load(os.path.join(ck, snaps[-1]), allow_pickle=False) as z:
        metas = json.loads(bytes(z["__meta__"]))
        assert metas["compress"] == "f16"
        assert any(z[k].dtype == np.float16 for k in z.files
                   if k.startswith("leaf_"))


def test_cli_trim_packed(tmp_path):
    """--trim-packed with --packed-dir: trains on the touched-vocab
    re-key and saves the new->old map next to the state."""
    import dataclasses

    import topicmodelsvb_jl_tpu as tm
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus, save_packed

    corp = tm.synth_corpus(M=32, V=30, K=3, seed=3, mean_terms=10)
    dense = pack_corpus(corp, pad_multiple=8, docs_multiple=16)
    live = dense.counts > 0
    sparse = dataclasses.replace(
        dense, terms=np.where(live, dense.terms * 5 + 1, 0).astype(np.int32),
        V=30 * 5 + 1)
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    save_packed(pdir, sparse)
    s = run([
        "--model", "lda", "--packed-dir", pdir, "--trim-packed",
        "--k", "3", "--iter", "2", "--checkelbo", "1", "--quiet",
        "--chunk-docs", "8", "--streaming", "--batch-docs", "16",
        "--state-dir", sdir, "--json",
    ])
    assert np.isfinite(s["final_elbo"])
    used = np.load(os.path.join(sdir, "vocab_ids.npy"))
    assert s["V"] == len(used) < sparse.V
