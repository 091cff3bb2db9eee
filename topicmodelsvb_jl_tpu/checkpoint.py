"""Checkpoint / resume.

The reference has none — "save/load trained models" is an open wish
(todo.txt item 5); its substitute is that every model struct is a plain
bag of arrays and ``train!`` is resumable by construction (all ``*_old``
fields live in the struct, LDA.jl:16-19).  Here both halves are
first-class:

* :func:`save` / :func:`load` serialise the full variational-state
  pytree plus metadata (model class, K, corpus fingerprint, seed,
  trained-elbo) to a single ``.npz``;
* because the state carries every ``*_old`` buffer, a loaded model's
  ``train()`` continues the ELBO trace exactly (tested in
  tests/test_checkpoint.py).

**Multi-host (multi-controller) runs** write a *directory* instead: each
process serialises only its addressable shards of the doc-sharded state
(per-doc leaves keyed by original document id, so the layout is portable
across mesh sizes and packing permutations) to ``proc{i}.npz``, and
process 0 writes ``manifest.json`` after a cross-process barrier.
:func:`load` accepts either format at **any** process count — a run
killed on N hosts can resume on one, and vice versa.  Assumes the
checkpoint path is a filesystem all processes can reach (the usual
shared-FS/NFS arrangement on multi-host clusters — same assumption
orbax makes).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Tuple

import jax
import numpy as np

from .corpus import Corpus

_FORMAT_VERSION = 2   # v2: corpus fingerprint includes Document.stamp
_MANIFEST = "manifest.json"


def packed_fingerprint(packed) -> str:
    """Stable hash of a PackedCorpus's device-facing arrays (used when a
    model was built directly from packed data, no Corpus available).
    Hash the same (pre- or post-bucketing) packed object on load."""
    h = hashlib.sha256()
    for a in (packed.terms, packed.counts, packed.readers, packed.ratings):
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    return "packed:" + h.hexdigest()


def corpus_fingerprint(corp: Corpus) -> str:
    """Stable hash of the corpus contents (docs + vocab + users)."""
    h = hashlib.sha256()
    for doc in corp.docs:
        h.update(np.asarray(doc.terms, np.int64).tobytes())
        h.update(np.asarray(doc.counts, np.int64).tobytes())
        h.update(np.asarray(doc.readers, np.int64).tobytes())
        h.update(np.asarray(doc.ratings, np.int64).tobytes())
        # stamps drive DTM slice assignment: a stamp edit with unchanged
        # terms must fail the strict fingerprint check on resume
        h.update(np.float64(np.nan if doc.stamp is None else doc.stamp)
                 .tobytes())
    for k in sorted(corp.vocab):
        h.update(f"{k}:{corp.vocab[k]};".encode())
    for k in sorted(corp.users):
        h.update(f"{k}:{corp.users[k]};".encode())
    return h.hexdigest()


def _model_meta(model) -> dict:
    import dataclasses

    fields = list(model.state._fields)
    doc_fields = set(getattr(model, "_per_doc_fields", ()))
    # replay the runtime knobs that shape packing/compute on load (paths,
    # profiling sinks and the checkpoint cadence are environment knobs:
    # replaying checkpoint_every without checkpoint_dir would leave a
    # resumed run silently not checkpointing — re-set both to resume
    # auto-checkpointing)
    runtime = {k: v for k, v in dataclasses.asdict(model.runtime).items()
               if k not in ("metrics_path", "profile_dir",
                            "checkpoint_dir", "checkpoint_every")
               and v is not None}
    return dict(
        format=_FORMAT_VERSION,
        model=type(model).__name__,
        K=model.K,
        seed=model.seed,
        dtype=str(model.dtype),
        runtime=runtime,
        # cached at construction (api.TopicModel.__init__): the corpus is
        # immutable for the model's lifetime, and for packed-built models
        # it hashes the PRE-bucketing object the user holds, so load()
        # with the same input matches
        corpus=model._fingerprint,
        n_leaves=len(fields),
        fields=fields,
        doc_fields=sorted(doc_fields),
        ctor=getattr(model, "_ctor_kwargs", lambda: {})(),
        trained=model.topics is not None,
        # global outer-iteration counter: a resumed run continues k,
        # JSONL rows, and ckpt_iter* names without collision
        iteration=int(getattr(model, "trained_iters", 0)),
    )


def _fetch_replicated(x) -> np.ndarray:
    """Host copy of a global-but-replicated (or addressable) array."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        if not x.is_fully_replicated:
            raise ValueError(
                "global parameter is neither addressable nor replicated")
        return np.asarray(x.addressable_shards[0].data)
    return np.asarray(x)


def _local_doc_shards(x):
    """This process's unique (row_start, host_block) shards of a leaf
    sharded along axis 0 (deduped: replication within a process yields
    identical index ranges)."""
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return [(0, np.asarray(x))]
    seen = {}
    for sh in x.addressable_shards:
        idx = sh.index[0] if sh.index else slice(None)
        start = 0 if idx.start is None else int(idx.start)
        if start not in seen:
            seen[start] = np.asarray(sh.data)
    return sorted(seen.items())


def _row_to_doc(model) -> np.ndarray:
    """packed state row → original 0-based doc id (−1 for padding)."""
    row2doc = np.full(model.packed.M_pad, -1, dtype=np.int64)
    row2doc[model._doc_rows()] = np.arange(model.M, dtype=np.int64)
    return row2doc


def save(path: str, model, compress: str = None) -> None:
    """Save an api.TopicModel's state + metadata.

    Per-document state fields are stored in **original document order**
    (de-permuted through the packing), so a checkpoint is portable
    across mesh shapes / chunk sizes whose bucketed row permutations
    differ.  Under multi-controller JAX (``jax.process_count() > 1``)
    ``path`` becomes a directory of per-process shard files — call from
    every process (it synchronises internally).

    ``compress="f16"`` halves the per-doc leaves' bytes (see
    :func:`snapshot`; on the multi-process path the saving is in shard
    file size / restore bandwidth — the D2H fetch there is synchronous
    either way).
    """
    if jax.process_count() > 1:
        _save_multihost(path, model, compress=compress)
        return
    write_snapshot(path, snapshot(model, compress=compress))


def snapshot(model, compress: str = None) -> tuple:
    """Immutable (meta, state, doc_fields, rows) capture of everything
    :func:`write_snapshot` needs, taken on the training thread.  Starts
    the device→host DMA of every leaf (``copy_to_host_async``) so a
    background writer's ``np.asarray`` only waits for completion instead
    of issuing a blocking fetch — the double-buffered half of async
    checkpointing (the state pytree is immutable, so the capture is
    race-free even while training replaces ``model.state``).

    ``compress="f16"`` casts the per-document leaves — the snapshot's
    dominant bytes (at NSF K=100: 3×[128804, 100] vs beta's 2×[100,
    25319]) — to float16 ON DEVICE before the DMA starts, halving the
    D2H transfer the async writer must hide behind the training steps
    (the bottleneck on a slow host link).
    Restore casts back; a resumed run re-converges the per-doc fixpoint
    from the rounded state, so the trace is no longer bit-reproduced —
    an opt-in size/fidelity trade (RuntimeConfig.checkpoint_f16).

    Globals are never skipped: every global moves every iteration
    (beta/beta_old/alpha are all rewritten by each sweep) and beta_old
    is load-bearing at restore (the ELBO recompute semantics,
    LDA.jl:83-93), so there is no "unchanged globals" mass to elide.
    """
    state = model.state
    meta = _model_meta(model)
    doc_fields = set(getattr(model, "_per_doc_fields", ()))
    if compress == "f16":
        import jax.numpy as jnp

        meta["compress"] = "f16"
        repl = {}
        for n in doc_fields:
            x = getattr(state, n)
            if not (isinstance(x, jax.Array)
                    and jnp.issubdtype(x.dtype, jnp.floating)):
                continue
            # range guard: a leaf with entries beyond f16 range (e.g.
            # gamma rows of a >65k-token document — gamma scales with
            # doc length) stays full precision; casting would write inf
            # into the checkpoint.  NaN max also fails the compare and
            # keeps the leaf uncompressed (restore is per-leaf
            # dtype-agnostic, so a mixed snapshot round-trips fine).
            if float(jnp.max(jnp.abs(x))) < 65504.0:
                repl[n] = x.astype(jnp.float16)
        if repl:
            state = state._replace(**repl)
    elif compress is not None:
        raise ValueError(f"unknown checkpoint compression {compress!r}")
    rows = model._doc_rows()
    for leaf in state:
        if isinstance(leaf, jax.Array):
            try:
                leaf.copy_to_host_async()
            except Exception:
                pass   # best effort; np.asarray below still works
    return meta, state, doc_fields, rows


def write_snapshot(path: str, snap: tuple) -> None:
    """Fetch + serialise a :func:`snapshot` (single-process format)."""
    meta, state, doc_fields, rows = snap
    arrays = {}
    for i, name in enumerate(state._fields):
        arr = np.asarray(getattr(state, name))
        if name in doc_fields:
            arr = arr[rows]              # packed rows → original doc order
        arrays[f"leaf_{i}"] = arr
    # write through a file handle so the exact path is used (np.savez
    # appends '.npz' to bare string paths, breaking the round trip)
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 **arrays)


class AsyncWriter:
    """One-slot background checkpoint writer (todo.txt item 5 aimed at
    the orbax async standard): ``submit(fn)`` runs ``fn`` on a daemon
    thread; a second submit (or ``wait``) first joins the outstanding
    write, so at most one checkpoint is in flight and back-pressure is
    the previous write's remaining time, not a growing queue.  Errors
    re-raise on the next submit/wait."""

    def __init__(self):
        self._thread = None
        self._exc = None

    def submit(self, fn) -> None:
        import threading

        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:   # re-raised on the caller thread
                self._exc = e

        self._thread = threading.Thread(
            target=run, name="tmvb-ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _save_multihost(path: str, model, compress: str = None) -> None:
    """Directory checkpoint: each process writes its addressable shards.

    Per-doc leaves are stored as (doc-id, value) pairs — each process
    covers exactly the documents whose packed rows it holds — so the
    union over processes is the full doc-ordered state regardless of
    mesh size.  Globals (replicated everywhere) come from process 0.
    ``manifest.json`` is written LAST, after a cross-process barrier, so
    a manifest's presence certifies a complete checkpoint.
    """
    from jax.experimental import multihost_utils

    pid, nproc = jax.process_index(), jax.process_count()
    fields = list(model.state._fields)
    doc_fields = set(getattr(model, "_per_doc_fields", ()))
    if compress not in (None, "f16"):
        raise ValueError(f"unknown checkpoint compression {compress!r}")
    row2doc = _row_to_doc(model)
    arrays = {}
    for i, name in enumerate(fields):
        x = getattr(model.state, name)
        if name in doc_fields:
            ids_parts, val_parts = [], []
            for start, block in _local_doc_shards(x):
                ids = row2doc[start:start + block.shape[0]]
                keep = ids >= 0
                ids_parts.append(ids[keep])
                val_parts.append(block[keep])
            vals = (np.concatenate(val_parts) if val_parts
                    else np.zeros((0,) + tuple(x.shape[1:]), x.dtype))
            if (compress == "f16"
                    and np.issubdtype(vals.dtype, np.floating)
                    and vals.size
                    and np.max(np.abs(vals)) < 65504.0):
                # same per-leaf range guard as snapshot(): out-of-range
                # (or NaN-containing) leaves stay full precision
                vals = vals.astype(np.float16)
            arrays[f"leaf_{i}_ids"] = (
                np.concatenate(ids_parts) if ids_parts
                else np.zeros((0,), np.int64))
            arrays[f"leaf_{i}"] = vals
        elif pid == 0:
            arrays[f"leaf_{i}"] = _fetch_replicated(x)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"proc{pid}.npz"), "wb") as f:
        np.savez(f, **arrays)
    multihost_utils.sync_global_devices(f"tmvb_ckpt_shards:{path}")
    if pid == 0:
        manifest = dict(meta=_model_meta(model), n_procs=nproc)
        tmp = os.path.join(path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, _MANIFEST))
    multihost_utils.sync_global_devices(f"tmvb_ckpt_done:{path}")


def _rebuild_model(meta: dict, corp, strict_corpus: bool):
    from . import api
    from .ops.packing import PackedCorpus
    from .utils.config import RuntimeConfig

    if meta["format"] != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint format {meta['format']} "
            f"(this build reads format {_FORMAT_VERSION}).")
    fp = (packed_fingerprint(corp) if isinstance(corp, PackedCorpus)
          else corpus_fingerprint(corp))
    if strict_corpus and fp != meta["corpus"]:
        raise ValueError("checkpoint corpus fingerprint does not match the given corpus.")

    cls = getattr(api, meta["model"])
    if "runtime" in meta:   # replay the saved runtime knobs
        rt = RuntimeConfig(**meta["runtime"])
    else:                   # older checkpoints: dtype + class preference
        rt = RuntimeConfig(dtype=meta["dtype"],
                           chunk_docs=getattr(cls, "_preferred_chunk", 1024))
    model = cls(corp, meta["K"], runtime=rt,
                seed=meta["seed"], **meta.get("ctor", {}))
    # resume the global iteration counter (older checkpoints: 0, i.e.
    # the pre-counter behavior of restarting at k=1)
    model.trained_iters = int(meta.get("iteration", 0))
    return model


def _restore_state(model, meta: dict, global_leaves: dict,
                   doc_chunks: dict) -> None:
    """Install checkpointed leaves into a freshly-built model.

    ``global_leaves[name]`` is the full array; ``doc_chunks[name]`` is a
    list of (doc_ids, values) pairs whose union covers docs 0..M−1 —
    scattered into the load environment's (possibly different) packed
    row permutation, leaving padding rows at their init values.
    """
    doc_fields = set(meta.get("doc_fields", []))
    rows = model._doc_rows()
    fixed = []
    for name in meta["fields"]:
        ref = np.asarray(getattr(model.state, name))
        if name in doc_fields:
            out = ref.copy()
            covered = 0
            for ids, vals in doc_chunks[name]:
                vals = np.asarray(vals)
                if vals.shape[1:] != ref.shape[1:]:
                    raise ValueError(
                        f"checkpoint field {name} row shape {vals.shape[1:]} "
                        f"incompatible with {ref.shape[1:]}")
                out[rows[ids]] = vals
                covered += len(ids)
            if covered < model.M:
                raise ValueError(
                    f"checkpoint field {name} covers {covered} of "
                    f"{model.M} documents")
            fixed.append(out.astype(ref.dtype))
        else:
            saved = np.asarray(global_leaves[name])
            if name == "elbo" and saved.shape == () and ref.shape == (2,):
                # pre-compensation checkpoint: scalar bound → (hi, lo=0)
                saved = np.stack([saved, np.zeros_like(saved)])
            if saved.shape != ref.shape:
                raise ValueError(
                    f"checkpoint field {name} shape {saved.shape} != {ref.shape}")
            fixed.append(saved.astype(ref.dtype))
    model.state = type(model.state)(*fixed)
    # refresh derived artifacts (topics / scores / recs) — but only for a
    # trained checkpoint: an untrained model's recs must stay unranked
    if meta.get("trained", True):
        model._finalize()


def load(path: str, corp: Corpus, strict_corpus: bool = True):
    """Rebuild the api model from a checkpoint + the original corpus.

    ``strict_corpus=True`` verifies the corpus fingerprint so a resumed
    run trains on exactly the data it left off with.  Accepts both the
    single-file ``.npz`` format and the multi-host directory format, at
    any current process count — an N-host run's checkpoint restores on
    one host or M hosts (per-doc leaves are keyed by document id).
    """
    if os.path.isdir(path):
        return _load_multihost(path, corp, strict_corpus)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]

    model = _rebuild_model(meta, corp, strict_corpus)
    all_ids = np.arange(model.M, dtype=np.int64)
    doc_fields = set(meta.get("doc_fields", []))
    global_leaves, doc_chunks = {}, {}
    for name, saved in zip(meta["fields"], leaves):
        if name in doc_fields:
            if saved.shape[0] != model.M:
                raise ValueError(
                    f"checkpoint field {name} has {saved.shape[0]} rows "
                    f"for {model.M} documents")
            doc_chunks[name] = [(all_ids, saved)]
        else:
            global_leaves[name] = saved
    _restore_state(model, meta, global_leaves, doc_chunks)
    return model


def _load_multihost(path: str, corp, strict_corpus: bool):
    """Load a directory checkpoint written by ``_save_multihost``."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    meta = manifest["meta"]
    model = _rebuild_model(meta, corp, strict_corpus)
    doc_fields = set(meta.get("doc_fields", []))
    global_leaves = {}
    doc_chunks = {name: [] for name in doc_fields}
    for p in range(manifest["n_procs"]):
        with np.load(os.path.join(path, f"proc{p}.npz")) as z:
            for i, name in enumerate(meta["fields"]):
                if name in doc_fields:
                    doc_chunks[name].append(
                        (z[f"leaf_{i}_ids"], z[f"leaf_{i}"]))
                elif p == 0:
                    global_leaves[name] = z[f"leaf_{i}"]
    # processes may overlap on fully-addressable saves (each wrote the
    # full doc set); the scatter is idempotent, but trim the coverage
    # count to unique ids so validation stays exact
    for name in doc_fields:
        seen = np.concatenate([ids for ids, _ in doc_chunks[name]]) \
            if doc_chunks[name] else np.zeros((0,), np.int64)
        uniq = np.unique(seen)
        if len(uniq) < model.M:
            raise ValueError(
                f"checkpoint field {name} covers {len(uniq)} of "
                f"{model.M} documents")
    _restore_state(model, meta, global_leaves, doc_chunks)
    return model
