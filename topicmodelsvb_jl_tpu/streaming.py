"""Host-streamed training — corpora larger than device memory.

The reference's own unfulfilled wishlist item ("stream docs from disk",
todo.txt item 6) and this build's concrete analogue of pipeline
parallelism for a CAVI workload (SURVEY §2.3: "host-level pipelining of
corpus shards in/out of HBM for corpora exceeding memory").

The whole corpus — token arrays AND the per-document variational state
(gamma/Elogtheta for LDA, gimel/zayin for CTPF: the O(M·K) memory that
dominates at production scale) — lives in host RAM.  Each outer CAVI
iteration streams fixed-size document batches through the device:

    for each batch b:                       (async pipeline)
        H2D   terms/counts/doc_mask/state[b]
        device: the SAME fused E-step fixpoint as the in-memory path
                (models/lda._estep_chunk / models/ctpf._estep_chunk),
                accumulating the model's sufficient-statistic pytree
                into device-resident buffers
        D2H   updated state[b]
    device: the model's global update once      (models/* semantics)

Because the globals are frozen within a sweep (the batch-synchronous
schedule), streaming changes NOTHING numerically: the trajectory is
bitwise the maths of the in-memory path (tested to 1e-12 at f64 in
tests/test_streaming.py).  Dispatch is asynchronous, so batch b+1's
host→device copy overlaps batch b's compute; the device→host state
fetch is deferred one batch for the same reason.

The batch pipeline itself (:class:`_StreamingModel`) is model-generic —
a subclass supplies the jitted batch sweep, the stat pytree, the global
update, and the batch ELBO.  Every model family streams:
:class:`StreamingLDA`, :class:`StreamingFLDA`, :class:`StreamingCTM`,
:class:`StreamingFCTM`, :class:`StreamingCTPF`, :class:`StreamingHMTM`
and :class:`StreamingDTM` (DTM's [T, K, V]
smoother state stays device-resident as the global block while its
O(M·K) per-doc state streams like every other family's).
Both support checkpoint/resume (:meth:`_StreamingModel.save` /
:func:`load`) including an auto-checkpoint cadence inside ``train`` /
``train_online``, so a SIGKILLed streaming run resumes and reproduces
the uninterrupted trace (tests/test_faultinjection.py).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops.newton import dirichlet_newton
from .models.lda import _estep_chunk, _phi, topics_ranking
from .models import ctm as ctm_mod
from .models import ctpf as ctpf_mod
from .models import fctm as fctm_mod
from .models import flda as flda_mod
from .utils.config import TrainConfig
from .utils.numerics import (
    EPSILON, categorical_entropy, digamma, dirichlet_entropy, dirichlet_ones, elbo_value,
    finite, kbn_add, kbn_psum, kbn_zero, lgamma,
)

_CKPT_FORMAT = 1


# ───────────────────────────── LDA kernels ─────────────────────────────

def make_batch_sweep(V: int, K: int, viter: int, vtol: float,
                     chunk_docs: int, mesh=None, data_axis: str = "data",
                     vocab_axis: Optional[str] = None):
    """Jitted E-sweep over one document batch: returns updated per-doc
    state plus the batch's (beta_temp, Elogtheta_sum) accumulated into
    the running device buffers.

    With ``mesh`` the batch is additionally data-parallel: its rows
    shard over ``data_axis``, the statistics psum across devices into
    replicated accumulators — streaming a beyond-memory corpus through
    a whole mesh, not one chip.  ``vocab_axis`` composes TP with the
    stream on a 2-D mesh: beta and the beta_temp accumulator shard
    their V axis — all_gather going into the E-step, psum_scatter
    coming out, exactly like the in-memory TP mode
    (models/lda.make_step)."""

    def sweep(beta, alpha, terms, counts, doc_mask, gamma, El, Elo,
              beta_temp_acc, El_sum_acc):
        if vocab_axis is not None:
            beta_full = jax.lax.all_gather(beta, vocab_axis, axis=1,
                                           tiled=True)
        else:
            beta_full = beta
        logbetaT = jnp.log(beta_full + jnp.asarray(EPSILON, beta.dtype)).T

        def body(carry, xs):
            bt, es = carry
            t, c, dm, g, el, elo = xs
            g2, el2, elo2, bti, esi = _estep_chunk(
                logbetaT, alpha, t, c, dm, g, el, elo, viter, vtol, V)
            return (bt + bti, es + esi), (g2, el2, elo2)

        n = terms.shape[0]
        B = min(chunk_docs, n)
        sh = lambda a: a.reshape((n // B, B) + a.shape[1:])
        zero = (jnp.zeros((V, K), beta.dtype), jnp.zeros_like(El_sum_acc))
        (bt, es), (g, el, elo) = jax.lax.scan(
            body, zero,
            (sh(terms), sh(counts), sh(doc_mask),
             sh(gamma), sh(El), sh(Elo)))
        if mesh is not None:
            # docs shard over BOTH axes when vocab_axis is set (like the
            # in-memory TP mode): every shard holds distinct documents
            if vocab_axis is not None:
                # sum across vocab shards, keeping this shard's V rows
                bt = jax.lax.psum_scatter(bt, vocab_axis,
                                          scatter_dimension=0, tiled=True)
                es = jax.lax.psum(es, (data_axis, vocab_axis))
            else:
                es = jax.lax.psum(es, data_axis)
            bt = jax.lax.psum(bt, data_axis)
        unsh = lambda a: a.reshape((n,) + a.shape[2:])
        return (unsh(g), unsh(el), unsh(elo),
                beta_temp_acc + bt, El_sum_acc + es)

    if mesh is None:
        return jax.jit(sweep)
    from jax.sharding import PartitionSpec as P

    from .parallel.shard import shard_map

    d = (P((data_axis, vocab_axis)) if vocab_axis is not None
         else P(data_axis))
    bspec = P(None, vocab_axis) if vocab_axis is not None else P()
    btspec = P(vocab_axis) if vocab_axis is not None else P()
    return jax.jit(shard_map(
        sweep, mesh=mesh,
        in_specs=(bspec, P(), d, d, d, d, d, d, btspec, P()),
        out_specs=(d, d, d, btspec, P()), check_vma=False))


@jax.jit
def _mstep(beta_temp, El_sum, alpha, M_total, niter, ntol):
    """update_beta! + update_alpha! (LDA.jl:97-125).

    El_sum is plain-accumulated here (unlike models/lda.py's
    compensated carry): the streaming stat pytrees ride the generic
    leafwise-add sweep and the SVI blend, and their noise budget is
    dominated by minibatch stochasticity, not f32 summation — the
    Newton still gets the cancellation-friendly mean-form gradient
    (ops/newton.py) for free."""
    beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
    alpha_new = dirichlet_newton(alpha, El_sum, M_total, niter, ntol)
    return beta_new, alpha_new


def make_batch_elbo(V: int, K: int, chunk_docs: int, mesh=None,
                    data_axis: str = "data",
                    vocab_axis: Optional[str] = None):
    """Jitted per-batch ELBO contribution (reference LDA.jl:50-93)."""

    def batch_elbo(beta, beta_old, alpha, terms, counts, doc_mask,
                   gamma, El, Elo, acc):
        eps = jnp.asarray(EPSILON, beta.dtype)
        if vocab_axis is not None:
            ag = lambda x: jax.lax.all_gather(x, vocab_axis, axis=1,
                                              tiled=True)
            beta, beta_old = ag(beta), ag(beta_old)
        logbeta_oldT = jnp.log(beta_old + eps).T
        logbetaT = jnp.log(beta + eps).T
        a = alpha
        theta_const = finite(lgamma(jnp.sum(a))) - finite(jnp.sum(lgamma(a)))

        # ONE combined [V, 2K] gather (same per-row-cost argument as
        # models/lda.py make_elbo)
        K = logbetaT.shape[1]
        log_tabT = jnp.concatenate([logbeta_oldT, logbetaT], axis=1)

        def body(acc, xs):
            t, c, dm, g, el, elo = xs
            lt = log_tabT[t]
            p = _phi(lt[..., :K], elo)
            e_ptheta = theta_const + jnp.sum((a - 1.0) * el, -1)
            pc = jnp.einsum("bl,blk->bk", c, p, preferred_element_type=p.dtype)
            e_pz = jnp.sum(pc * el, -1)
            e_pw = jnp.sum(p * lt[..., K:] * c[..., None], axis=(1, 2))
            e_qtheta = dirichlet_entropy(g)
            e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
            return kbn_add(acc, jnp.sum(dm * (e_ptheta + e_pz + e_pw
                                              + e_qtheta + e_qz))), None

        n = terms.shape[0]
        B = min(chunk_docs, n)
        sh = lambda x: x.reshape((n // B, B) + x.shape[1:])
        part, _ = jax.lax.scan(
            body, (jnp.zeros_like(acc[0]), jnp.zeros_like(acc[1])),
            (sh(terms), sh(counts), sh(doc_mask),
             sh(gamma), sh(El), sh(Elo)))
        if mesh is not None:
            part = kbn_psum(part, (data_axis, vocab_axis)
                            if vocab_axis is not None else (data_axis,))
        hi, lo = kbn_add((acc[0], acc[1] + part[1]), part[0])
        return hi, lo

    if mesh is None:
        return jax.jit(batch_elbo)
    from jax.sharding import PartitionSpec as P

    from .parallel.shard import shard_map

    d = (P((data_axis, vocab_axis)) if vocab_axis is not None
         else P(data_axis))
    bspec = P(None, vocab_axis) if vocab_axis is not None else P()
    return jax.jit(shard_map(
        batch_elbo, mesh=mesh,
        in_specs=(bspec, bspec, P(), d, d, d, d, d, d, P()),
        out_specs=P(), check_vma=False))


def make_generic_batch_sweep(prep, chunk_call, chunk_docs: int, mesh=None,
                             data_axis: str = "data"):
    """Jitted batch sweep shared by the streaming models: scan the
    model's fused E-step chunk function over one document batch,
    accumulating its sufficient-statistic pytree.

    ``prep(globs)`` runs once per batch (log/transpose of the global
    parameters); ``chunk_call(prepped, data_chunk, state_chunk)`` wraps
    the model's ``_estep_chunk`` and returns ``(new_state_tuple,
    stat_tuple)``.  All four sweep arguments are pytrees (tuples), so
    one factory serves every model.  With ``mesh`` the batch rows shard
    over ``data_axis`` and the statistics psum into replicated
    accumulators (same contract as :func:`make_batch_sweep`)."""

    def sweep(globs, data, states, accs):
        prepped = prep(globs)
        n = jax.tree_util.tree_leaves(data)[0].shape[0]
        B = min(chunk_docs, n)
        sh = lambda a: a.reshape((n // B, B) + a.shape[1:])

        def body(carry, xs):
            d, s = xs
            s2, st = chunk_call(prepped, d, s)
            return jax.tree_util.tree_map(jnp.add, carry, st), s2

        zero = jax.tree_util.tree_map(jnp.zeros_like, accs)
        carry, ys = jax.lax.scan(
            body, zero,
            (jax.tree_util.tree_map(sh, data),
             jax.tree_util.tree_map(sh, states)))
        if mesh is not None:
            carry = jax.lax.psum(carry, data_axis)
        unsh = lambda a: a.reshape((n,) + a.shape[2:])
        return (jax.tree_util.tree_map(unsh, ys),
                jax.tree_util.tree_map(jnp.add, accs, carry))

    if mesh is None:
        return jax.jit(sweep)
    from jax.sharding import PartitionSpec as P

    from .parallel.shard import shard_map

    d = P(data_axis)
    return jax.jit(shard_map(
        sweep, mesh=mesh, in_specs=(P(), d, d, P()),
        out_specs=(d, P()), check_vma=False))


# ─────────────────────────── generic driver ───────────────────────────

class _StreamingModel:
    """Model-generic host-streaming scaffold.

    Subclasses define:

    * ``_doc_state``: names of the host-resident per-doc arrays
      (attributes, ``[M_pad, ...]`` NumPy);
    * ``_globals``: names of the device-resident global parameters;
    * ``_counters``: names of scalar bookkeeping attrs to checkpoint;
    * ``_data_slices(sl)``: the device-ready corpus arrays for a batch;
    * ``_run_batch(sl, stats)``: one batch through the device — returns
      (per-doc device refs tuple, new stats pytree);
    * ``_global_update(stats)``: the model's M-step from the accumulated
      stats;
    * ``_zero_stats()``: the stat pytree of zeros;
    * ``_sweep_elbo()``: full-corpus streamed bound;
    * ``_finalize()``: post-train artifacts (topics ranking).
    """

    _doc_state: tuple = ()
    _globals: tuple = ()
    _counters: tuple = ("elbo", "_svi_t", "_epochs_done", "trained_iters")
    vocab_axis: Optional[str] = None   # TP composition (StreamingLDA)

    def _init_common(self, packed, K, batch_docs, chunk_docs, dtype, seed,
                     mesh, data_axis, state_dir=None):
        self._state_dir = state_dir
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
        if packed.segments is not None:
            raise ValueError(f"{type(self).__name__} takes a dense "
                             "(non-bucketed) PackedCorpus.")
        # ── multi-controller streaming ──
        # Each OS process owns a BATCH-STRIDED document shard: the p-th
        # L-row slice of EVERY global batch (L = batch_docs / n_proc),
        # i.e. global rows [bG + pL, bG + (p+1)L) for every batch b.
        # Global batch b is then the union of every process's local
        # batch b — the batch PARTITION is process-count invariant, so
        # both batch CAVI and the per-minibatch online SVI trajectory
        # match the single-process run exactly.  Each per-batch read is
        # one contiguous row range (disk-friendly with load_packed
        # memmaps; no host ever materialises the full corpus), and the
        # host per-doc state covers only the owned rows.  Sufficient
        # statistics and the bound reduce across processes once per
        # sweep (online: once per global minibatch) via
        # multihost_utils.process_allgather + a deterministic host-side
        # sum — the DP stat reduction of SURVEY §2.3 at process grain.
        self._nproc = jax.process_count()
        self._pid = jax.process_index()
        if self._nproc > 1:
            if mesh is not None:
                local = {d.id for d in jax.local_devices()}
                if any(d.id not in local for d in mesh.devices.flat):
                    raise ValueError(
                        "multi-process streaming takes a LOCAL mesh (only "
                        "this process's devices): each process streams its "
                        "own document shard; cross-process reduction "
                        "happens at sweep grain, not inside the sweep. "
                        "Build it from jax.local_devices().")
            if packed.M_pad % self._nproc:
                raise ValueError(
                    f"process count {self._nproc} must divide the padded "
                    f"doc count {packed.M_pad} (choose docs_multiple "
                    "accordingly)")
            if batch_docs % self._nproc:
                raise ValueError(
                    f"process count {self._nproc} must divide batch_docs "
                    f"({batch_docs}) — it is the GLOBAL batch size)")
        self.mesh = mesh
        self.data_axis = data_axis
        self.packed = packed
        self.K = int(K)
        self.M, self.V = packed.M, packed.V
        # this process's rows: the p-th L-slice of every global batch
        self.M_rows = packed.M_pad // self._nproc
        self._batch_docs_global = min(batch_docs, packed.M_pad)
        M_pad = self.M_rows
        self.batch_docs = min(self._batch_docs_global // self._nproc, M_pad)
        self._batch_docs_global = self.batch_docs * self._nproc
        if M_pad % self.batch_docs:
            raise ValueError(
                f"batch_docs must divide the per-process doc rows {M_pad} "
                f"(got {self.batch_docs})")
        n_sh = 1 if mesh is None else mesh.shape[data_axis]
        # with TP (vocab_axis) documents shard over BOTH mesh axes
        if mesh is not None and self.vocab_axis:
            n_sh *= mesh.shape[self.vocab_axis]
        self.chunk_docs = min(chunk_docs, self.batch_docs // n_sh)
        if (self.batch_docs // n_sh) % self.chunk_docs or \
                self.batch_docs % n_sh:
            raise ValueError(
                f"chunk_docs ({self.chunk_docs}) × mesh size ({n_sh}) "
                f"must divide batch_docs ({self.batch_docs})")
        self.dtype = jnp.dtype(dtype)
        self.seed = int(seed)
        self.elbo = 0.0
        self.topics: Optional[np.ndarray] = None
        self.trace: list = []
        self._svi_t = 0          # SVI step counter (train_online)
        self._epochs_done = 0    # completed online epochs (rng replay)
        self.trained_iters = 0   # completed batch-CAVI iterations (k)
        self._svi_stats = None   # running online statistics pytree

    def _host_full(self, name, shape, fill, dtype):
        """Host per-doc state array: RAM, or — with ``state_dir`` — a
        writable ``.npy`` memmap so the O(M·K) state also lives on disk
        (full beyond-memory training: corpus AND state out of RAM)."""
        if self._state_dir is None:
            return np.full(shape, fill, dtype)
        from numpy.lib.format import open_memmap

        fname = (f"{name}.npy" if self._nproc == 1
                 else f"{name}.proc{self._pid}.npy")
        a = open_memmap(os.path.join(self._state_dir, fname),
                        mode="w+", dtype=np.dtype(dtype), shape=shape)
        a[...] = fill
        return a

    def _batches(self):
        # LOCAL row slices: under multi-controller each process sweeps
        # its batch-strided shard (see _init_common / _gsl)
        n = self.M_rows // self.batch_docs
        for b in range(n):
            yield slice(b * self.batch_docs, (b + 1) * self.batch_docs)

    def _gsl(self, sl) -> slice:
        """Local batch-aligned slice → global packed-row slice: local
        batch b (rows [bL, (b+1)L)) is the p-th L-slice of global batch
        b (rows [bG + pL, bG + (p+1)L))."""
        L, G = self.batch_docs, self._batch_docs_global
        b, o = sl.start // L, sl.start % L
        g0 = b * G + self._pid * L + o
        return slice(g0, g0 + (sl.stop - sl.start))

    def _local_to_global_rows(self, n_rows: int, L: int, G: int,
                              pid: int) -> np.ndarray:
        """Global packed-row index of each local state row under the
        batch-strided ownership (vectorised; used by checkpoint I/O)."""
        r = np.arange(n_rows, dtype=np.int64)
        return (r // L) * G + pid * L + (r % L)

    def _reduce_stats(self, stats):
        """Cross-process sum of a sufficient-statistic pytree (identity
        single-controller).  Host-side allgather + deterministic sum —
        the per-sweep stat reduction crossing processes (SURVEY §2.3);
        at one reduction per sweep (online: per global minibatch) the
        [V, K]-sized transfer is noise next to the sweep itself."""
        if self._nproc == 1:
            return stats
        from jax.experimental import multihost_utils

        gathered = multihost_utils.process_allgather(
            jax.tree_util.tree_map(np.asarray, stats))
        return jax.tree_util.tree_map(
            lambda g: jnp.asarray(g.sum(axis=0), self.dtype), gathered)

    def _reduce_elbo(self, hi, lo) -> float:
        """Cross-process f64 combination of per-process compensated
        (hi, lo) bound pairs."""
        if self._nproc == 1:
            return elbo_value((hi, lo))
        from jax.experimental import multihost_utils

        pairs = multihost_utils.process_allgather(
            np.array([hi, lo], np.float64))
        return float(np.asarray(pairs, np.float64).sum())

    def _doc_slices(self, sl) -> tuple:
        return tuple(jnp.asarray(getattr(self, n)[sl])
                     for n in self._doc_state)

    def _store(self, sl, *updated) -> None:
        for name, dev in zip(self._doc_state, updated):
            getattr(self, name)[sl] = np.asarray(dev)

    def _streamed_sweep(self, stats):
        """One full pass: every batch through ``_run_batch`` with the
        D2H state fetch deferred one batch (the device is already busy
        on batch b+1 when batch b's state lands back on host)."""
        pending = None
        for sl in self._batches():
            updated, stats = self._run_batch(sl, stats)
            if pending is not None:
                self._store(*pending)
            pending = (sl,) + tuple(updated)
        if pending is not None:
            self._store(*pending)
        return stats

    # ── subclass hooks (defaults cover the common shapes) ──
    def _run_batch(self, sl, stats):
        raise NotImplementedError

    def _global_update(self, stats):
        raise NotImplementedError

    def _zero_stats(self):
        raise NotImplementedError

    def _batch_state(self, sl):
        raise NotImplementedError

    def _data_slices(self, sl) -> tuple:
        p = self.packed
        g = self._gsl(sl)
        return (jnp.asarray(p.terms[g]),
                jnp.asarray(p.counts[g].astype(self.dtype)),
                jnp.asarray(p.doc_mask[g].astype(self.dtype)))

    def _sweep_elbo(self):
        """Full-corpus streamed bound: sum of per-batch evaluations of
        the model's in-memory ELBO over batch-state views (this
        process's shard), reduced across processes."""
        acc = 0.0
        for sl in self._batches():
            acc += elbo_value(self._elbo_fn(self._batch_state(sl),
                                            *self._data_slices(sl)))
        return self._reduce_elbo(acc, 0.0)

    def _finalize(self):
        self.topics = topics_ranking(np.asarray(self.beta))

    def _check(self, k, cfg) -> Optional[float]:
        """check_elbo! cadence shared by both training modes; returns
        the ∆elbo when a check ran."""
        if cfg.checkelbo == float("inf") or k % int(cfg.checkelbo):
            return None
        new_elbo = self._sweep_elbo()
        delta = new_elbo - self.elbo
        self.elbo = new_elbo
        self.trace.append((k, new_elbo, delta))
        if cfg.printelbo:
            print(f"{k} ∆elbo: {round(delta, 3)}")
        return delta

    # extra constructor kwargs a subclass needs at load() time
    # (StreamingDTM: T + the slice assignment)
    def _ctor_meta(self) -> dict:
        return {}

    def _ctor_host_arrays(self) -> dict:
        return {}

    # ── checkpoint/resume ──
    def save(self, path: str) -> None:
        """Single-file npz checkpoint of the full streaming run state:
        host per-doc arrays, device globals, the ELBO trace, and the
        online counters (SVI step t, completed epochs, running stats) —
        everything a resumed ``train``/``train_online`` needs to
        continue the uninterrupted trajectory."""
        from .checkpoint import packed_fingerprint

        meta = dict(
            format=_CKPT_FORMAT, cls=type(self).__name__, K=self.K,
            batch_docs=self._batch_docs_global, chunk_docs=self.chunk_docs,
            dtype=str(self.dtype), seed=self.seed,
            corpus=packed_fingerprint(self.packed),
            trace=self.trace,
            counters={n: getattr(self, n) for n in self._counters},
            trained=self.topics is not None,
        )
        meta["ctor"] = self._ctor_meta()
        arrays = {f"doc_{n}": getattr(self, n) for n in self._doc_state}
        arrays.update({f"glob_{n}": np.asarray(getattr(self, n))
                       for n in self._globals})
        arrays.update({f"ctor_{k}": np.asarray(v)
                       for k, v in self._ctor_host_arrays().items()})
        if self._svi_stats is not None:
            for i, leaf in enumerate(jax.tree_util.tree_leaves(
                    self._svi_stats)):
                arrays[f"svi_{i}"] = np.asarray(leaf)
        if self._nproc > 1:
            # directory layout, one shard file per process; the manifest
            # is written LAST after a cross-process barrier, so its
            # presence certifies a complete checkpoint (same protocol as
            # checkpoint._save_multihost) — the doc arrays are each
            # process's batch-strided row shard, keyed by (L, G, pid) so
            # a restore at ANY process count can recover global row ids
            from jax.experimental import multihost_utils

            meta["nproc"] = self._nproc
            meta["row_map"] = dict(L=self.batch_docs,
                                   G=self._batch_docs_global,
                                   pid=self._pid)
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, f"proc{self._pid}.npz"), "wb") as f:
                np.savez(f, __meta__=np.frombuffer(
                    json.dumps(meta).encode(), np.uint8), **arrays)
            multihost_utils.sync_global_devices(f"tmvb_stream_ckpt:{path}")
            if self._pid == 0:
                # saving into a directory a LARGER process count once
                # used: drop the stale proc{p>=nproc}.npz shards so a
                # later load() can't scatter rows from a dead run (no
                # live process writes those names, so deleting after
                # the barrier races nothing)
                import glob as _glob
                for f in _glob.glob(os.path.join(path, "proc*.npz")):
                    try:
                        p_id = int(os.path.basename(f)[4:-4])
                    except ValueError:
                        p_id = -1
                    if not (0 <= p_id < self._nproc):
                        os.remove(f)
                manifest = dict(format=_CKPT_FORMAT, nproc=self._nproc,
                                cls=type(self).__name__)
                tmpm = os.path.join(path, "manifest.json.tmp")
                with open(tmpm, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmpm, os.path.join(path, "manifest.json"))
            return
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)

    def _restore_doc_shard(self, z, row_map: dict) -> None:
        """Scatter one checkpoint shard's doc arrays into this
        process's rows.  Both sides use the batch-strided ownership
        (``_local_to_global_rows``); shard and restore process counts —
        and global batch sizes — may differ."""
        n_saved = z[f"doc_{self._doc_state[0]}"].shape[0]
        g_saved = self._local_to_global_rows(
            n_saved, int(row_map["L"]), int(row_map["G"]),
            int(row_map["pid"]))
        # which saved rows are mine, and where they land locally
        L, G = self.batch_docs, self._batch_docs_global
        o = g_saved % G
        sel = (o >= self._pid * L) & (o < (self._pid + 1) * L)
        local = (g_saved[sel] // G) * L + (o[sel] - self._pid * L)
        for n in self._doc_state:
            saved = z[f"doc_{n}"]
            if saved.shape[1:] != getattr(self, n).shape[1:]:
                raise ValueError(f"checkpoint field {n} shape mismatch")
            getattr(self, n)[local] = saved[sel]

    def _restore(self, z, meta) -> None:
        self._restore_doc_shard(
            z, meta.get("row_map",
                        dict(L=meta["batch_docs"], G=meta["batch_docs"],
                             pid=0)))
        self._restore_common(z, meta)

    def _restore_common(self, z, meta) -> None:
        for n in self._globals:
            setattr(self, n, jnp.asarray(z[f"glob_{n}"], self.dtype))
        for n, v in meta["counters"].items():
            setattr(self, n, v)
        self.trace = [tuple(t) for t in meta["trace"]]
        if any(k.startswith("svi_") for k in z.files):
            self._svi_stats = tuple(
                jnp.asarray(z[f"svi_{i}"], self.dtype)
                for i in range(sum(k.startswith("svi_") for k in z.files)))
        if meta.get("trained", False):
            self._finalize()

    def _auto_ckpt(self, k, every, ckpt_dir) -> None:
        if not every or not ckpt_dir or k % every:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"ckpt_iter{k:06d}")
        tmp = final + ".tmp"
        self.save(tmp)            # atomic: a SIGKILL mid-write never
        if self._nproc > 1:       # leaves a torn latest checkpoint
            # directory format: save() barriered internally; rank 0 owns
            # the rename (manifest presence already certifies the tmp)
            if self._pid == 0:
                import shutil
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices(f"tmvb_stream_mv:{final}")
            return
        os.replace(tmp, final)

    _api_cls: str = ""      # matching api.TopicModel subclass name

    def to_model(self, runtime=None):
        """Materialise the trained streaming state as the corresponding
        in-memory :mod:`api` model — the full post-hoc surface
        (``showtopics``/``predict``/``infer``/``gendoc``/checkpointing)
        on the exact streamed parameters.

        Use once training is done and the per-doc state fits device
        memory (serving usually runs on a subset anyway); the streamed
        per-doc arrays are scattered through the api model's (possibly
        length-bucketed) packed row permutation."""
        if self._nproc > 1:
            raise ValueError(
                "to_model needs the full per-doc state on one host; a "
                "multi-process streaming run holds only its own shard. "
                "save() a checkpoint and streaming.load() it in a "
                "single-process session first (the directory format "
                "restores at any process count).")
        from . import api
        from .utils.config import RuntimeConfig

        cls = getattr(api, self._api_cls)
        rt = runtime if runtime is not None else RuntimeConfig(
            chunk_docs=self.chunk_docs, dtype=str(self.dtype))
        m = cls(self.packed, self.K, runtime=rt, seed=self.seed)
        rows = m._doc_rows()
        doc_state = set(self._doc_state)
        vals = []
        for f in m.state._fields:
            ref = np.asarray(getattr(m.state, f))
            if f == "elbo":
                # host f64 → compensated (hi, lo) pair: hi carries the
                # f32-rounded value, lo the representation remainder
                hi = np.asarray(self.elbo, ref.dtype)
                lo = np.asarray(self.elbo - float(hi), ref.dtype)
                vals.append(jnp.asarray(np.stack([hi, lo]), ref.dtype))
                continue
            src = np.asarray(getattr(self, f))
            if f in doc_state:
                out = ref.copy()
                if src.ndim >= 2 and src.shape[1] != ref.shape[1]:
                    # per-token state (tau): bucketing narrows the token
                    # axis to the widest segment; within-doc order is
                    # preserved, columns beyond a doc's length are pads
                    out[rows] = src[: self.M, : ref.shape[1]].astype(
                        ref.dtype)
                else:
                    out[rows] = src[: self.M].astype(ref.dtype)
                vals.append(jnp.asarray(out))
            else:
                vals.append(jnp.asarray(src.astype(ref.dtype)))
        m.state = type(m.state)(*vals)
        if self.topics is not None:
            m._finalize()
        return m

    def _wrap_batch_elbo(self, fn, spec, n_data: int = 3):
        """Jit a model's in-memory ``make_elbo`` for per-batch use; with
        a mesh, shard the batch rows like the sweep (``spec`` is the
        model's state partition spec)."""
        if self.mesh is None:
            return jax.jit(fn)
        from jax.sharding import PartitionSpec as P

        from .parallel.shard import shard_map

        d = P(self.data_axis)
        return jax.jit(shard_map(
            fn, mesh=self.mesh, in_specs=(spec,) + (d,) * n_data,
            out_specs=P(), check_vma=False))

    # ── shared training loops (every subclass delegates here) ──
    def _train_loop(self, cfg, checkpoint_every, checkpoint_dir):
        """Batch CAVI: full streamed sweep, one global update, the
        check_elbo! cadence, optional auto-checkpointing."""
        cfg.validate()
        self._cfg = cfg
        self._compile(cfg)

        if cfg.checkelbo <= cfg.iter and not self.trace:
            self.elbo = self._sweep_elbo()

        # k continues past a resume (trained_iters rides _counters), so
        # trace rows stay unique and ckpt_iterNNNNNN names never reuse a
        # pre-resume number — the same monotone global counter the api
        # models keep (api.py trained_iters / checkpoint 'iteration')
        k0 = self.trained_iters
        for k in range(k0 + 1, k0 + cfg.iter + 1):
            stats = self._reduce_stats(self._streamed_sweep(self._zero_stats()))
            self._global_update(stats)
            self.trained_iters = k
            delta = self._check(k, cfg)
            self._auto_ckpt(k, checkpoint_every, checkpoint_dir)
            if delta is not None and delta < cfg.tol:
                break

        self._finalize()
        return self

    # whether the first online step takes the batch statistic whole
    # (ρ=1); classes whose _svi_init_stats seeds from positive priors
    # set this False so the prior never fully drops out (StreamingCTM:
    # its E-step uses the reference's raw log(beta), CTM.jl:177, so a
    # beta column zeroed by one vocab-incomplete minibatch would NaN
    # every later batch's softmax on that term)
    _svi_first_step_whole = True

    def _svi_init_stats(self):
        """Initial running statistics for ``train_online`` (override to
        seed from priors rather than zeros)."""
        return self._zero_stats()

    def _train_online_loop(self, cfg, tau0, kappa, shuffle_seed,
                           checkpoint_every, checkpoint_dir):
        """Online (stochastic) variational training — one or few passes.

        Beyond the reference's capability surface: after each document
        minibatch the global sufficient statistics are blended with the
        batch's corpus-scaled statistics at step size
        ``ρ_t = (τ0 + t)^(−κ)`` (Hoffman et al. 2010/2013 SVI schedule;
        online EM over the model's closed-form M-step, Cappé & Moulines
        2009), and the globals update immediately — so a single pass
        over a huge corpus already yields useful parameters, where batch
        CAVI would need many full sweeps.  ``kappa`` in (0.5, 1]
        guarantees the Robbins–Monro conditions.

        ELBO is checked per EPOCH (a full-corpus streamed evaluation).
        A resumed run (``load``) replays the shuffle rng past its
        completed epochs, so the batch schedule — and therefore the
        trajectory — continues exactly.
        """
        if not (0.5 < kappa <= 1.0):
            raise ValueError("kappa must be in (0.5, 1].")
        cfg.validate()
        self._cfg = cfg
        self._compile(cfg)
        p = self.packed
        n_batches = self.M_rows // self.batch_docs
        # per-batch corpus scale M / (real docs in batch): pad rows carry
        # zero statistics, so scaling by the padded ratio M_pad/batch_docs
        # would give a pad-heavy trailing batch full rho weight with
        # near-zero stats (avoidable gradient variance when M_pad >> M);
        # all-padding batches are dropped from the schedule entirely.
        # Under multi-controller, global batch b = every process's local
        # batch b, so the real-doc counts sum across processes and the
        # shuffle (same seed everywhere) keeps all processes in lockstep.
        real_docs = np.array([
            float(p.doc_mask[self._gsl(slice(b * self.batch_docs,
                                             (b + 1) * self.batch_docs))]
                  .sum()) for b in range(n_batches)])
        if self._nproc > 1:
            from jax.experimental import multihost_utils
            real_docs = multihost_utils.process_allgather(
                real_docs).sum(axis=0)
        live = np.nonzero(real_docs > 0)[0]

        if self._svi_stats is None:
            self._svi_stats = self._svi_init_stats()
        # seed the bound like train() so the first reported ∆elbo is
        # a real improvement, not a difference against 0.0
        if cfg.checkelbo <= cfg.iter and not self.trace:
            self.elbo = self._sweep_elbo()
        rng = np.random.default_rng(shuffle_seed)
        for _ in range(self._epochs_done):   # resume: replay the schedule
            rng.permutation(len(live))
        for _ in range(cfg.iter):
            order = live[rng.permutation(len(live))]
            for b in order:
                scale = float(self.M) / real_docs[b]
                sl = slice(b * self.batch_docs, (b + 1) * self.batch_docs)
                updated, batch_stats = self._run_batch(
                    sl, self._zero_stats())
                batch_stats = self._reduce_stats(batch_stats)
                self._store(sl, *updated)
                # first step takes the batch statistic whole (ρ=1) when
                # the running stats start from zeros — blending a
                # near-zero statistic into the global update at full
                # corpus scale would destabilise it; prior-seeded
                # classes instead keep the ordinary schedule from t=0
                t = self._svi_t
                rho = (1.0 if (t == 0 and self._svi_first_step_whole)
                       else (tau0 + t) ** (-kappa))
                self._svi_stats = jax.tree_util.tree_map(
                    lambda S, s: (1.0 - rho) * S + rho * scale * s,
                    self._svi_stats, batch_stats)
                self._global_update(self._svi_stats)
                self._svi_t = t + 1
            self._epochs_done += 1
            self._check(self._epochs_done, cfg)
            self._auto_ckpt(self._epochs_done, checkpoint_every,
                            checkpoint_dir)

        self._finalize()
        return self


def _stream_cls(name):
    return {c.__name__: c
            for c in (StreamingLDA, StreamingCTM, StreamingFLDA,
                      StreamingFCTM, StreamingCTPF, StreamingHMTM,
                      StreamingDTM)}[name]


def _ctor_extra(z, meta) -> dict:
    """Subclass-specific constructor kwargs persisted by save()
    (scalars in meta['ctor'], arrays as ctor_* entries)."""
    extra = dict(meta.get("ctor", {}))
    extra.update({k[5:]: z[k] for k in z.files if k.startswith("ctor_")})
    return extra


def _check_stream_meta(meta, packed, strict_corpus):
    from .checkpoint import packed_fingerprint

    if meta["format"] != _CKPT_FORMAT:
        raise ValueError(
            f"unsupported streaming checkpoint format {meta['format']}")
    if strict_corpus and packed_fingerprint(packed) != meta["corpus"]:
        raise ValueError(
            "checkpoint corpus fingerprint does not match the given "
            "packed corpus.")


def load(path: str, packed, strict_corpus: bool = True):
    """Rebuild a streaming model from a checkpoint + the same dense
    PackedCorpus, ready to continue training where it left off.

    Accepts both formats at ANY current process count: the single-file
    ``.npz`` and the multi-controller directory (one contiguous doc-row
    shard per writing process + manifest-last) — each loading process
    scatters the overlap of every shard's global row range into its own
    range, so an N-process streaming run resumes on one process and
    vice versa (the portability bar checkpoint.py already meets for the
    in-memory models)."""
    if os.path.isdir(path):
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise ValueError(
                f"incomplete streaming checkpoint (no manifest): {path}")
        with open(mpath) as f:
            manifest = json.load(f)
        # the shard set must be EXACTLY proc0..proc{nproc-1} per the
        # manifest: a missing shard would silently leave its rows at
        # constructor-init values, an extra (stale) one would scatter a
        # dead run's rows over fresh data
        expect = [os.path.join(path, f"proc{p}.npz")
                  for p in range(int(manifest["nproc"]))]
        import glob as _glob

        found = sorted(_glob.glob(os.path.join(path, "proc*.npz")))
        if found != sorted(expect):
            raise ValueError(
                f"streaming checkpoint shard mismatch in {path}: manifest "
                f"says nproc={manifest['nproc']} but found "
                f"{[os.path.basename(f) for f in found]}")
        files = expect
        with np.load(files[0]) as z0:
            meta = json.loads(bytes(z0["__meta__"]).decode())
            _check_stream_meta(meta, packed, strict_corpus)
            model = _stream_cls(meta["cls"])(
                packed, meta["K"], batch_docs=meta["batch_docs"],
                chunk_docs=meta["chunk_docs"], dtype=meta["dtype"],
                seed=meta["seed"], **_ctor_extra(z0, meta))
            model._restore_common(z0, meta)
        for f in files:
            with np.load(f) as z:
                m = json.loads(bytes(z["__meta__"]).decode())
                model._restore_doc_shard(z, m["row_map"])
        return model
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        _check_stream_meta(meta, packed, strict_corpus)
        model = _stream_cls(meta["cls"])(
            packed, meta["K"], batch_docs=meta["batch_docs"],
            chunk_docs=meta["chunk_docs"], dtype=meta["dtype"],
            seed=meta["seed"], **_ctor_extra(z, meta))
        model._restore(z, meta)
    return model


# ─────────────────────────── StreamingLDA ───────────────────────────

class StreamingLDA(_StreamingModel):
    """LDA trained with host-resident corpus + per-doc state.

    ``packed`` is a dense :class:`~.ops.packing.PackedCorpus` (host
    NumPy; use :func:`~.datasets.synth_packed_nsf_scale` or
    :func:`~.ops.packing.pack_corpus`).  ``batch_docs`` bounds device
    memory: peak HBM is O(batch_docs·L·K) for the E-step tile plus the
    [K, V] beta and [V, K] statistic — independent of corpus size.

    Produces exactly the in-memory trajectory (beta/alpha are frozen
    within a sweep, so batch order is irrelevant to the result).
    """

    _doc_state = ("gamma", "Elogtheta", "Elogtheta_old")
    _api_cls = "LDA"
    _globals = ("beta", "beta_old", "alpha")

    def __init__(self, packed, K: int, batch_docs: int = 8192,
                 chunk_docs: int = 1024, dtype=jnp.float32, seed: int = 0,
                 mesh=None, data_axis: str = "data",
                 vocab_axis: Optional[str] = None,
                 state_dir: Optional[str] = None):
        """``mesh`` makes each streamed batch data-parallel over its
        devices (stats psum'd): a beyond-memory corpus streams through a
        whole mesh.  Batch rows must divide chunk_docs × mesh size.
        ``vocab_axis`` (requires a 2-D mesh carrying that axis) also
        shards beta storage over V — streaming × TP composition for
        beyond-memory corpora with huge vocabularies."""
        if vocab_axis is not None and (
                mesh is None or vocab_axis not in mesh.shape):
            raise ValueError("vocab_axis needs a mesh carrying that axis")
        self.vocab_axis = vocab_axis
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        npdt = np.dtype(dtype)
        M_pad = self.M_rows   # this process's doc rows

        # device-resident globals (reference LDA.jl:24-47)
        key = jax.random.PRNGKey(seed)
        self.beta = dirichlet_ones(key, self.V, (self.K,)).astype(self.dtype)
        self.beta_old = self.beta
        self.alpha = jnp.ones((self.K,), self.dtype)
        # host-resident per-doc state (the O(M·K) memory)
        el0 = -sum(1.0 / i for i in range(1, self.K))
        self.gamma = self._host_full("gamma", (M_pad, self.K), 1.0, npdt)
        self.Elogtheta = self._host_full("Elogtheta", (M_pad, self.K), el0, npdt)
        self.Elogtheta_old = self._host_full("Elogtheta_old", (M_pad, self.K), el0, npdt)
        self._sweep = None
        self._batch_elbo = None

    def _compile(self, cfg):
        self._sweep = make_batch_sweep(
            self.V, self.K, cfg.viter, cfg.vtol, self.chunk_docs,
            mesh=self.mesh, data_axis=self.data_axis,
            vocab_axis=self.vocab_axis)
        self._batch_elbo = make_batch_elbo(
            self.V, self.K, self.chunk_docs, mesh=self.mesh,
            data_axis=self.data_axis, vocab_axis=self.vocab_axis)

    def _zero_stats(self):
        return (jnp.zeros((self.V, self.K), self.dtype),
                jnp.zeros((self.K,), self.dtype))

    def _run_batch(self, sl, stats):
        bt, es = stats
        g2, el2, elo2, bt, es = self._sweep(
            self.beta, self.alpha, *self._data_slices(sl),
            *self._doc_slices(sl), bt, es)
        return (g2, el2, elo2), (bt, es)

    def _global_update(self, stats):
        bt, es = stats
        self.beta_old = self.beta
        self.beta, self.alpha = _mstep(
            bt, es, self.alpha,
            jnp.asarray(float(self.M), self.dtype),
            self._cfg.niter, self._cfg.ntol)

    def _sweep_elbo(self, batch_elbo=None, beta=None, beta_old=None):
        batch_elbo = batch_elbo if batch_elbo is not None else self._batch_elbo
        beta = beta if beta is not None else self.beta
        beta_old = beta_old if beta_old is not None else self.beta_old
        acc = kbn_zero(self.dtype)
        for sl in self._batches():
            acc = batch_elbo(beta, beta_old, self.alpha,
                             *self._data_slices(sl),
                             *self._doc_slices(sl), acc)
        return self._reduce_elbo(float(np.asarray(acc[0])),
                                 float(np.asarray(acc[1])))

    def _svi_init_stats(self):
        # running statistics seeded by one pass worth of the beta prior
        return (jnp.asarray(np.asarray(self.beta), self.dtype).T,  # [V, K]
                jnp.zeros((self.K,), self.dtype))

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        cfg = TrainConfig(iter=iter, tol=tol, niter=niter, ntol=ntol,
                          viter=viter, vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online SVI over the reference's normalized-beta M-step + alpha
        Newton (see :meth:`_StreamingModel._train_online_loop`)."""
        cfg = TrainConfig(iter=epochs, niter=niter, ntol=ntol, viter=viter,
                          vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


# ─────────────────────────── StreamingCTPF ───────────────────────────

def make_ctpf_batch_sweep(V: int, K: int, U_seg: int, viter: int,
                          vtol: float, chunk_docs: int, mesh=None,
                          data_axis: str = "data", hyper=ctpf_mod.HYPER):
    """Jitted CTPF E-sweep over one batch: updates the batch's
    gimel/zayin (+olds) and accumulates (alef_temp, he_temp, gimel_sum,
    zayin_sum) into the running device buffers (CTPF.jl:309-323 per doc,
    259-277 for the statistics)."""
    c_h, g_h = hyper["c"], hyper["g"]

    def sweep(alef, bet, dalet, he, vav, het,
              terms, counts, readers, ratings, doc_mask,
              gimel, gimel_old, zayin, zayin_old,
              at_acc, ht_acc, gs_acc, zs_acc):
        dg_alefT = digamma(alef).T
        dg_heT = digamma(he).T
        log_bet = jnp.log(bet)
        log_vav = jnp.log(vav)

        def body(carry, xs):
            at, ht, gs, zs = carry
            t, cnt, rd, rt, dm, gi, gio, za, zao = xs
            gi2, gio2, za2, zao2, ati, hti, gsi, zsi = \
                ctpf_mod._estep_chunk(
                    dg_alefT, dg_heT, log_bet, log_vav, c_h, g_h,
                    t, cnt, rd, rt, dm, gi, gio, za, zao,
                    viter, vtol, V, U_seg, dalet, het)
            return (at + ati, ht + hti, gs + gsi, zs + zsi), \
                (gi2, gio2, za2, zao2)

        n = terms.shape[0]
        B = min(chunk_docs, n)
        sh = lambda a: a.reshape((n // B, B) + a.shape[1:])
        zero = tuple(jnp.zeros_like(a)
                     for a in (at_acc, ht_acc, gs_acc, zs_acc))
        (at, ht, gs, zs), (gi, gio, za, zao) = jax.lax.scan(
            body, zero,
            tuple(map(sh, (terms, counts, readers, ratings, doc_mask,
                           gimel, gimel_old, zayin, zayin_old))))
        if mesh is not None:
            at, ht, gs, zs = jax.lax.psum((at, ht, gs, zs), data_axis)
        unsh = lambda a: a.reshape((n,) + a.shape[2:])
        return (unsh(gi), unsh(gio), unsh(za), unsh(zao),
                at_acc + at, ht_acc + ht, gs_acc + gs, zs_acc + zs)

    if mesh is None:
        return jax.jit(sweep)
    from jax.sharding import PartitionSpec as P

    from .parallel.shard import shard_map

    d = P(data_axis)
    return jax.jit(shard_map(
        sweep, mesh=mesh,
        in_specs=(P(),) * 6 + (d,) * 9 + (P(),) * 4,
        out_specs=(d, d, d, d, P(), P(), P(), P()), check_vma=False))


class StreamingCTPF(_StreamingModel):
    """CTPF trained with host-resident corpus + per-doc state
    (the model whose real workload — recommendations
    over reader streams, CTPF.jl:344-402 — most plausibly exceeds
    memory).  The host keeps gimel/zayin (+olds, the O(M·K) memory);
    the device keeps the Gamma globals alef/bet/dalet/he/vav/het.

    Produces exactly the in-memory trajectory (globals are frozen
    within a sweep; tested to 1e-12 at f64 in tests/test_streaming.py).
    """

    _doc_state = ("gimel", "gimel_old", "zayin", "zayin_old")
    _api_cls = "CTPF"
    _globals = ("alef", "alef_old", "bet", "bet_old", "dalet", "dalet_old",
                "he", "he_old", "vav", "vav_old", "het", "het_old")

    def __init__(self, packed, K: int, batch_docs: int = 8192,
                 chunk_docs: int = 1024, dtype=jnp.float32, seed: int = 0,
                 mesh=None, data_axis: str = "data",
                 state_dir: Optional[str] = None):
        if packed.readers is None or packed.ratings is None:
            raise ValueError("StreamingCTPF needs reader arrays "
                             "(pack with with_readers=True).")
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        self.U = packed.U
        self.U_seg = max(packed.U, 1)
        npdt = np.dtype(dtype)
        M_pad = self.M_rows   # this process's doc rows

        # constructor state (reference CTPF.jl:81-103, = models/ctpf.init)
        key = jax.random.PRNGKey(seed)
        alef = jnp.exp(dirichlet_ones(key, self.V, (self.K,)) - 0.5
                       ).astype(self.dtype)
        ones_k = jnp.ones((self.K,), self.dtype)
        self.alef, self.alef_old = alef, alef
        self.bet, self.bet_old = ones_k, ones_k
        self.dalet, self.dalet_old = ones_k, ones_k
        self.he = jnp.ones((self.K, self.U_seg), self.dtype)
        self.he_old = self.he
        self.vav, self.vav_old = ones_k, ones_k
        self.het, self.het_old = ones_k, ones_k
        # host-resident per-doc state
        self.gimel = self._host_full("gimel", (M_pad, self.K), 1.0, npdt)
        self.gimel_old = self._host_full("gimel_old", (M_pad, self.K), 1.0, npdt)
        self.zayin = self._host_full("zayin", (M_pad, self.K), 1.0, npdt)
        self.zayin_old = self._host_full("zayin_old", (M_pad, self.K), 1.0, npdt)
        self._sweep = None
        self._elbo_first = None
        self._elbo_rest = None

    def _compile(self, cfg):
        self._sweep = make_ctpf_batch_sweep(
            self.V, self.K, self.U_seg, cfg.viter, cfg.vtol,
            self.chunk_docs, mesh=self.mesh, data_axis=self.data_axis)
        kw = dict(chunk_docs=self.chunk_docs)
        spec = ctpf_mod.partition_spec(self.data_axis)
        ax = self.data_axis if self.mesh is not None else None
        self._elbo_first = self._wrap_batch_elbo(ctpf_mod.make_elbo(
            self.packed, self.K, axis_name=ax, **kw), spec, n_data=5)
        self._elbo_rest = self._wrap_batch_elbo(ctpf_mod.make_elbo(
            self.packed, self.K, axis_name=ax,
            include_global_terms=False, **kw), spec, n_data=5)

    def _zero_stats(self):
        z = jnp.zeros((self.K,), self.dtype)
        return (jnp.zeros((self.V, self.K), self.dtype),
                jnp.zeros((self.U_seg, self.K), self.dtype), z, z)

    def _data_slices(self, sl):
        p = self.packed
        g = self._gsl(sl)
        return (jnp.asarray(p.terms[g]),
                jnp.asarray(p.counts[g].astype(self.dtype)),
                jnp.asarray(p.readers[g]),
                jnp.asarray(p.ratings[g].astype(self.dtype)),
                jnp.asarray(p.doc_mask[g].astype(self.dtype)))

    def _run_batch(self, sl, stats):
        at, ht, gs, zs = stats
        out = self._sweep(
            self.alef, self.bet, self.dalet, self.he, self.vav, self.het,
            *self._data_slices(sl), *self._doc_slices(sl), at, ht, gs, zs)
        gi, gio, za, zao, at, ht, gs, zs = out
        return (gi, gio, za, zao), (at, ht, gs, zs)

    def _global_update(self, stats):
        alef_new, bet_new, dalet_new, he_new, vav_new, het_new = \
            _ctpf_mstep(*stats, self.bet, self.vav, self.U > 0)
        self.alef_old, self.alef = self.alef, alef_new
        self.bet_old, self.bet = self.bet, bet_new
        self.dalet_old, self.dalet = self.dalet, dalet_new
        self.he_old, self.he = self.he, he_new
        self.vav_old, self.vav = self.vav, vav_new
        self.het_old, self.het = self.het, het_new

    def _batch_state(self, sl) -> ctpf_mod.CTPFState:
        """CTPFState view whose per-doc leaves are the batch slices —
        lets the streamed bound reuse the in-memory make_elbo verbatim."""
        gi, gio, za, zao = self._doc_slices(sl)
        return ctpf_mod.CTPFState(
            alef=self.alef, alef_old=self.alef_old,
            bet=self.bet, bet_old=self.bet_old,
            gimel=gi, gimel_old=gio,
            dalet=self.dalet, dalet_old=self.dalet_old,
            he=self.he, he_old=self.he_old,
            vav=self.vav, vav_old=self.vav_old,
            zayin=za, zayin_old=zao,
            het=self.het, het_old=self.het_old,
            elbo=jnp.zeros((), self.dtype))

    def _sweep_elbo(self):
        total = 0.0
        for i, sl in enumerate(self._batches()):
            # data-independent alef/he terms enter ONCE globally: via
            # process 0's first batch (the cross-process reduction sums
            # per-process partials)
            fn = (self._elbo_first if i == 0 and self._pid == 0
                  else self._elbo_rest)
            total += elbo_value(fn(self._batch_state(sl),
                                   *self._data_slices(sl)))
        return self._reduce_elbo(total, 0.0)

    def _finalize(self):
        # Ebeta = alef ./ bet (CTPF.jl:378)
        self.topics = topics_ranking(
            np.asarray(self.alef) / np.asarray(self.bet)[:, None])

    def scores(self, docs: Optional[slice] = None) -> np.ndarray:
        """Recommendation scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386)
        for a document slice (default: the whole corpus — [M, U] is
        host-resident; pass a slice to bound memory)."""
        sl = docs if docs is not None else slice(0, self.M)
        Eeta = np.asarray(self.he / self.vav[:, None])          # [K, U]
        Eth = self.gimel[sl] / np.asarray(self.dalet)[None, :]
        Eep = self.zayin[sl] / np.asarray(self.het)[None, :]
        return ((Eth + Eep) @ Eeta)[:, : self.U]

    def train(self, iter: int = 150, tol: float = 1.0, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        """train! (CTPF.jl:344-376) — no niter/ntol (no Newton steps)."""
        cfg = TrainConfig(iter=iter, tol=tol, viter=viter, vtol=vtol,
                          checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online (SVI-schedule) CTPF: the Gamma global
        updates (CTPF.jl:251-305) are conjugate-closed-form in the
        sufficient statistics (alef_temp/he_temp/gimel_sum/zayin_sum),
        so the standard natural-gradient SVI blend is exactly a running
        average of corpus-scaled minibatch statistics at
        ``ρ_t = (τ0 + t)^(−κ)``, with the globals recomputed from the
        blended stats after every minibatch."""
        cfg = TrainConfig(iter=epochs, viter=viter, vtol=vtol,
                          checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


# ─────────────────────────── StreamingCTM ───────────────────────────

def _moment_mstep(vsq_sum, lam_sum, lam_outer, mu_old, M_total):
    """Shared CTM/fCTM Gaussian global updates (update_sigma! with the
    PREVIOUS mu, then update_mu!; CTM.jl:102-111, order CTM.jl:206-208)."""
    centered = (lam_outer
                - jnp.outer(mu_old, lam_sum) - jnp.outer(lam_sum, mu_old)
                + M_total * jnp.outer(mu_old, mu_old))
    sigma = (jnp.diag(vsq_sum) + centered) / M_total
    sigma = 0.5 * (sigma + sigma.T)
    invsigma = jnp.linalg.inv(sigma)
    invsigma = 0.5 * (invsigma + invsigma.T)
    return lam_sum / M_total, sigma, invsigma


@jax.jit
def _ctm_mstep(beta_temp, vsq_sum, lam_sum, lam_outer, mu_old, M_total):
    """CTM global updates (update_beta!/update_sigma!/update_mu!,
    CTM.jl:102-118, order CTM.jl:206-208) from the accumulated sweep
    statistics — identical maths to the tail of models/ctm.make_step."""
    beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
    mu_new, sigma, invsigma = _moment_mstep(
        vsq_sum, lam_sum, lam_outer, mu_old, M_total)
    return mu_new, sigma, invsigma, beta_new


class StreamingCTM(_StreamingModel):
    """CTM trained with host-resident corpus + per-doc state (lambda /
    vsq / logzeta — the O(M·K) memory); the device keeps mu/sigma/beta.
    Same batch pipeline and guarantees as :class:`StreamingLDA`:
    globals are frozen within a sweep, so the trajectory equals the
    in-memory path and is invariant to the batch partition."""

    _doc_state = ("lam", "lam_old", "vsq", "logzeta")
    _api_cls = "CTM"
    _globals = ("mu", "sigma", "invsigma", "beta", "beta_old")

    def __init__(self, packed, K: int, batch_docs: int = 8192,
                 chunk_docs: int = 2048, dtype=jnp.float32, seed: int = 0,
                 mesh=None, data_axis: str = "data",
                 state_dir: Optional[str] = None):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        npdt = np.dtype(dtype)
        M_pad = self.M_rows   # this process's doc rows
        # constructor state (reference CTM.jl:27-52, = models/ctm.init)
        key = jax.random.PRNGKey(seed)
        self.beta = dirichlet_ones(key, self.V, (self.K,)).astype(self.dtype)
        self.beta_old = self.beta
        eye = jnp.eye(self.K, dtype=self.dtype)
        self.mu = jnp.zeros((self.K,), self.dtype)
        self.sigma, self.invsigma = eye, eye
        self.lam = self._host_full("lam", (M_pad, self.K), 0.0, npdt)
        self.lam_old = self._host_full("lam_old", (M_pad, self.K), 0.0, npdt)
        self.vsq = self._host_full("vsq", (M_pad, self.K), 1.0, npdt)
        self.logzeta = self._host_full("logzeta", (M_pad,), 0.5, npdt)
        self._sweep = None
        self._elbo_fn = None

    def _compile(self, cfg):
        V = self.V
        viter, vtol = cfg.viter, cfg.vtol
        niter, ntol = cfg.niter, cfg.ntol

        def prep(globs):
            beta, mu, invsigma = globs
            return jnp.log(beta).T, mu, invsigma   # raw log, CTM.jl:177

        def chunk_call(prepped, d, s):
            logbetaT, mu, invsigma = prepped
            la2, lao2, v2, lz2, bt, vs, ls, lo = ctm_mod._estep_chunk(
                logbetaT, mu, invsigma, *d, *s,
                viter, vtol, niter, ntol, V)
            return (la2, lao2, v2, lz2), (bt, vs, ls, lo)

        self._sweep = make_generic_batch_sweep(
            prep, chunk_call, self.chunk_docs, mesh=self.mesh,
            data_axis=self.data_axis)
        ax = self.data_axis if self.mesh is not None else None
        self._elbo_fn = self._wrap_batch_elbo(
            ctm_mod.make_elbo(self.packed, self.K,
                              chunk_docs=self.chunk_docs, axis_name=ax),
            ctm_mod.partition_spec(self.data_axis))

    def _zero_stats(self):
        z = jnp.zeros((self.K,), self.dtype)
        return (jnp.zeros((self.V, self.K), self.dtype), z, z,
                jnp.zeros((self.K, self.K), self.dtype))

    _svi_first_step_whole = False

    def _svi_init_stats(self):
        # seed from the (strictly positive) prior draw of beta and the
        # constructor moments (vsq=1, lam=0): the blended beta can then
        # never develop an exactly-zero column (see the base-class note)
        return (jnp.asarray(np.asarray(self.beta), self.dtype).T,
                jnp.full((self.K,), float(self.M), self.dtype),
                jnp.zeros((self.K,), self.dtype),
                jnp.zeros((self.K, self.K), self.dtype))

    def _run_batch(self, sl, stats):
        return self._sweep((self.beta, self.mu, self.invsigma),
                           self._data_slices(sl), self._doc_slices(sl),
                           stats)

    def _global_update(self, stats):
        mu, sigma, invsigma, beta = _ctm_mstep(
            *stats, self.mu, jnp.asarray(float(self.M), self.dtype))
        self.beta_old, self.beta = self.beta, beta
        self.mu, self.sigma, self.invsigma = mu, sigma, invsigma

    def _batch_state(self, sl) -> ctm_mod.CTMState:
        la, lao, v, lz = self._doc_slices(sl)
        return ctm_mod.CTMState(
            mu=self.mu, sigma=self.sigma, invsigma=self.invsigma,
            beta=self.beta, beta_old=self.beta_old,
            lam=la, lam_old=lao, vsq=v, logzeta=lz,
            elbo=jnp.zeros((), self.dtype))

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        cfg = TrainConfig(iter=iter, tol=tol, niter=niter, ntol=ntol,
                          viter=viter, vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online SVI CTM: mu/sigma are moment averages and beta a
        normalized count table — all closed-form in the sweep statistics
        (vsq_sum/lam_sum/lam_outer/beta_temp), so the running-average
        blend applies exactly as for LDA/CTPF."""
        cfg = TrainConfig(iter=epochs, niter=niter, ntol=ntol, viter=viter,
                          vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


# ─────────────────────────── StreamingFLDA ───────────────────────────

@jax.jit
def _flda_mstep(beta_temp, kappa_temp, El_sum, tau_counts, alpha,
                M_total, C_total, niter, ntol):
    """fLDA global updates (update_eta!/update_kappa!/update_beta!/
    update_alpha!, fLDA.jl:97-156) from the sweep statistics."""
    beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
    kappa_new = kappa_temp / jnp.sum(kappa_temp)
    alpha_new = dirichlet_newton(alpha, El_sum, M_total, niter, ntol)
    eta_new = tau_counts / C_total
    return eta_new, alpha_new, kappa_new, beta_new


class StreamingFLDA(_StreamingModel):
    """fLDA trained with host-resident corpus + per-doc state.  The
    host keeps gamma/Elogtheta AND the per-token responsibilities tau
    [M_pad, L] — the memory that makes in-memory fLDA infeasible on
    long corpora; the device keeps eta/alpha/kappa/beta."""

    _doc_state = ("gamma", "Elogtheta", "Elogtheta_old", "tau", "tau_old")
    _api_cls = "fLDA"
    _globals = ("eta", "alpha", "kappa", "kappa_old", "beta", "beta_old")

    def __init__(self, packed, K: int, batch_docs: int = 8192,
                 chunk_docs: int = 1024, dtype=jnp.float32, seed: int = 0,
                 mesh=None, data_axis: str = "data",
                 state_dir: Optional[str] = None):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        npdt = np.dtype(dtype)
        M_pad, L = self.M_rows, packed.L   # per-process rows
        # constructor state (reference fLDA.jl:30-58, = models/flda.init)
        k_beta, k_kappa = jax.random.split(jax.random.PRNGKey(seed))
        self.beta = dirichlet_ones(k_beta, self.V, (self.K,)).astype(self.dtype)
        self.beta_old = self.beta
        self.kappa = dirichlet_ones(k_kappa, self.V).astype(self.dtype)
        self.kappa_old = self.kappa
        self.eta = jnp.asarray(0.5, self.dtype)
        self.alpha = jnp.ones((self.K,), self.dtype)
        el0 = -sum(1.0 / i for i in range(1, self.K))
        self.gamma = self._host_full("gamma", (M_pad, self.K), 1.0, npdt)
        self.Elogtheta = self._host_full("Elogtheta", (M_pad, self.K), el0, npdt)
        self.Elogtheta_old = self._host_full("Elogtheta_old", (M_pad, self.K), el0, npdt)
        self.tau = self._host_full("tau", (M_pad, L), 0.5, npdt)
        self.tau_old = self._host_full("tau_old", (M_pad, L), 0.5, npdt)
        self._C_total = float(np.asarray(packed.C, np.float64).sum())
        self._sweep = None
        self._elbo_fn = None

    def _compile(self, cfg):
        V = self.V
        viter, vtol = cfg.viter, cfg.vtol

        def prep(globs):
            beta, kappa, eta, alpha = globs
            eps = jnp.asarray(EPSILON, beta.dtype)
            return jnp.log(beta + eps).T, kappa, eta, alpha

        def chunk_call(prepped, d, s):
            logbetaT, kappa, eta, alpha = prepped
            g2, el2, elo2, ta2, tao2, bt, kt, es, tc = \
                flda_mod._estep_chunk(logbetaT, kappa, eta, alpha,
                                      *d, *s, viter, vtol, V)
            return (g2, el2, elo2, ta2, tao2), (bt, kt, es, tc)

        self._sweep = make_generic_batch_sweep(
            prep, chunk_call, self.chunk_docs, mesh=self.mesh,
            data_axis=self.data_axis)
        ax = self.data_axis if self.mesh is not None else None
        self._elbo_fn = self._wrap_batch_elbo(
            flda_mod.make_elbo(self.packed, self.K,
                               chunk_docs=self.chunk_docs, axis_name=ax),
            flda_mod.partition_spec(self.data_axis))

    def _zero_stats(self):
        return (jnp.zeros((self.V, self.K), self.dtype),
                jnp.zeros((self.V,), self.dtype),
                jnp.zeros((self.K,), self.dtype),
                jnp.zeros((), self.dtype))

    def _run_batch(self, sl, stats):
        return self._sweep((self.beta, self.kappa, self.eta, self.alpha),
                           self._data_slices(sl), self._doc_slices(sl),
                           stats)

    def _global_update(self, stats):
        eta, alpha, kappa, beta = _flda_mstep(
            *stats, self.alpha, jnp.asarray(float(self.M), self.dtype),
            jnp.asarray(self._C_total, self.dtype),
            self._cfg.niter, self._cfg.ntol)
        self.beta_old, self.beta = self.beta, beta
        self.kappa_old, self.kappa = self.kappa, kappa
        self.eta, self.alpha = eta, alpha

    def _batch_state(self, sl) -> flda_mod.FLDAState:
        g, el, elo, ta, tao = self._doc_slices(sl)
        return flda_mod.FLDAState(
            eta=self.eta, alpha=self.alpha,
            kappa=self.kappa, kappa_old=self.kappa_old,
            beta=self.beta, beta_old=self.beta_old,
            gamma=g, Elogtheta=el, Elogtheta_old=elo,
            tau=ta, tau_old=tao, elbo=jnp.zeros((), self.dtype))

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        cfg = TrainConfig(iter=iter, tol=tol, niter=niter, ntol=ntol,
                          viter=viter, vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online SVI fLDA.  All four statistics scale by the standard
        SVI corpus ratio M/|batch|; eta's token-sum statistic inherits
        that doc-ratio scaling, which is unbiased in expectation over
        uniformly drawn batches (token totals per doc are iid across
        the shuffle)."""
        cfg = TrainConfig(iter=epochs, niter=niter, ntol=ntol, viter=viter,
                          vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


# ─────────────────────────── StreamingFCTM ───────────────────────────

@jax.jit
def _fctm_mstep(beta_temp, kappa_temp, vsq_sum, lam_sum, lam_outer,
                mu_old, M_total):
    """fCTM global updates (fCTM.jl:122-150; eta frozen per
    fCTM.jl:267) from the sweep statistics."""
    beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
    kappa_new = kappa_temp / jnp.sum(kappa_temp)
    mu_new, sigma, invsigma = _moment_mstep(
        vsq_sum, lam_sum, lam_outer, mu_old, M_total)
    return mu_new, sigma, invsigma, kappa_new, beta_new


class StreamingFCTM(_StreamingModel):
    """fCTM trained with host-resident corpus + per-doc state (lambda /
    vsq / logzeta plus the per-token tau [M_pad, L]); the device keeps
    eta/mu/sigma/kappa/beta."""

    _doc_state = ("lam", "lam_old", "vsq", "logzeta", "tau", "tau_old")
    _api_cls = "fCTM"
    _globals = ("eta", "mu", "sigma", "invsigma", "kappa", "kappa_old",
                "beta", "beta_old")

    def __init__(self, packed, K: int, batch_docs: int = 8192,
                 chunk_docs: int = 2048, dtype=jnp.float32, seed: int = 0,
                 mesh=None, data_axis: str = "data",
                 state_dir: Optional[str] = None):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        npdt = np.dtype(dtype)
        M_pad, L = self.M_rows, packed.L   # per-process rows
        # constructor state (reference fCTM.jl:33-64, = models/fctm.init)
        k_beta, k_kappa = jax.random.split(jax.random.PRNGKey(seed))
        self.beta = dirichlet_ones(k_beta, self.V, (self.K,)).astype(self.dtype)
        self.beta_old = self.beta
        self.kappa = dirichlet_ones(k_kappa, self.V).astype(self.dtype)
        self.kappa_old = self.kappa
        self.eta = jnp.asarray(0.5, self.dtype)
        eye = jnp.eye(self.K, dtype=self.dtype)
        self.mu = jnp.zeros((self.K,), self.dtype)
        self.sigma, self.invsigma = eye, eye
        self.lam = self._host_full("lam", (M_pad, self.K), 0.0, npdt)
        self.lam_old = self._host_full("lam_old", (M_pad, self.K), 0.0, npdt)
        self.vsq = self._host_full("vsq", (M_pad, self.K), 1.0, npdt)
        self.logzeta = self._host_full("logzeta", (M_pad,), 0.5, npdt)
        self.tau = self._host_full("tau", (M_pad, L), 0.5, npdt)
        self.tau_old = self._host_full("tau_old", (M_pad, L), 0.5, npdt)
        self._sweep = None
        self._elbo_fn = None

    def _compile(self, cfg):
        V = self.V
        viter, vtol = cfg.viter, cfg.vtol
        niter, ntol = cfg.niter, cfg.ntol

        def prep(globs):
            beta, kappa, eta, mu, invsigma = globs
            eps = jnp.asarray(EPSILON, beta.dtype)
            return jnp.log(beta + eps).T, kappa, eta, mu, invsigma

        def chunk_call(prepped, d, s):
            logbetaT, kappa, eta, mu, invsigma = prepped
            (la2, lao2, v2, lz2, ta2, tao2,
             bt, kt, vs, ls, lo) = fctm_mod._estep_chunk(
                logbetaT, kappa, eta, mu, invsigma, *d, *s,
                viter, vtol, niter, ntol, V)
            return (la2, lao2, v2, lz2, ta2, tao2), (bt, kt, vs, ls, lo)

        self._sweep = make_generic_batch_sweep(
            prep, chunk_call, self.chunk_docs, mesh=self.mesh,
            data_axis=self.data_axis)
        ax = self.data_axis if self.mesh is not None else None
        self._elbo_fn = self._wrap_batch_elbo(
            fctm_mod.make_elbo(self.packed, self.K,
                               chunk_docs=self.chunk_docs, axis_name=ax),
            fctm_mod.partition_spec(self.data_axis))

    def _zero_stats(self):
        z = jnp.zeros((self.K,), self.dtype)
        return (jnp.zeros((self.V, self.K), self.dtype),
                jnp.zeros((self.V,), self.dtype), z, z,
                jnp.zeros((self.K, self.K), self.dtype))

    _svi_first_step_whole = False

    def _svi_init_stats(self):
        # prior-seeded like StreamingCTM (positive beta/kappa columns)
        return (jnp.asarray(np.asarray(self.beta), self.dtype).T,
                jnp.asarray(np.asarray(self.kappa), self.dtype),
                jnp.full((self.K,), float(self.M), self.dtype),
                jnp.zeros((self.K,), self.dtype),
                jnp.zeros((self.K, self.K), self.dtype))

    def _run_batch(self, sl, stats):
        return self._sweep(
            (self.beta, self.kappa, self.eta, self.mu, self.invsigma),
            self._data_slices(sl), self._doc_slices(sl), stats)

    def _global_update(self, stats):
        mu, sigma, invsigma, kappa, beta = _fctm_mstep(
            *stats, self.mu, jnp.asarray(float(self.M), self.dtype))
        self.beta_old, self.beta = self.beta, beta
        self.kappa_old, self.kappa = self.kappa, kappa
        self.mu, self.sigma, self.invsigma = mu, sigma, invsigma

    def _batch_state(self, sl) -> fctm_mod.FCTMState:
        la, lao, v, lz, ta, tao = self._doc_slices(sl)
        return fctm_mod.FCTMState(
            eta=self.eta, mu=self.mu, sigma=self.sigma,
            invsigma=self.invsigma,
            kappa=self.kappa, kappa_old=self.kappa_old,
            beta=self.beta, beta_old=self.beta_old,
            lam=la, lam_old=lao, vsq=v, logzeta=lz,
            tau=ta, tau_old=tao, elbo=jnp.zeros((), self.dtype))

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        cfg = TrainConfig(iter=iter, tol=tol, niter=niter, ntol=ntol,
                          viter=viter, vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online SVI fCTM (moment-average globals, eta frozen at 0.5
        per fCTM.jl:267)."""
        cfg = TrainConfig(iter=epochs, niter=niter, ntol=ntol, viter=viter,
                          vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


@functools.partial(jax.jit, static_argnums=(6,))
def _ctpf_mstep(alef_temp, he_temp, gimel_sum, zayin_sum, bet, vav,
                has_users: bool):
    """CTPF global updates in reference order (CTPF.jl:366-371), from
    the accumulated sweep statistics — identical maths to the tail of
    models/ctpf.make_step."""
    h = ctpf_mod.HYPER
    dt = alef_temp.dtype
    he_new = h["e"] + he_temp.T
    alef_new = h["a"] + alef_temp.T
    # dalet (CTPF.jl:295-298): new alef/he, OLD bet/vav
    he_sum = jnp.sum(he_new, axis=1) if has_users \
        else jnp.zeros(gimel_sum.shape, dt)
    alef_sum = jnp.sum(alef_new, axis=1)
    dalet_new = h["d"] + alef_sum / bet + he_sum / vav
    # het (CTPF.jl:302-305): old vav
    het_new = h["h"] + he_sum / vav
    # bet (CTPF.jl:281-284): NEW dalet
    bet_new = h["b"] + gimel_sum / dalet_new
    # vav (CTPF.jl:288-291): NEW dalet and het
    vav_new = h["f"] + gimel_sum / dalet_new + zayin_sum / het_new
    return alef_new, bet_new, dalet_new, he_new, vav_new, het_new


# ─────────────────────────── StreamingHMTM ───────────────────────────

@jax.jit
def _hmtm_mstep(beta_temp, pi_sum, th_sum, eta, alpha, M_total, niter, ntol):
    """HMTM global updates (the completed updateBeta!/updateEta!/
    updateAlpha!, HMTM.jl:103-158) from the sweep statistics — identical
    maths to the tail of models/hmtm.make_step."""
    beta_new = beta_temp.T / jnp.sum(beta_temp.T, axis=1, keepdims=True)
    eta_new = dirichlet_newton(eta, pi_sum, M_total, niter, ntol)
    alpha_new = jax.vmap(
        lambda a, s: dirichlet_newton(a, s, M_total, niter, ntol),
        in_axes=1, out_axes=1)(alpha, th_sum)
    return beta_new, eta_new, alpha_new


class StreamingHMTM(_StreamingModel):
    """HMTM trained with host-resident corpus + per-doc state.  The
    host keeps tau [M, K] and the per-doc transition Dirichlets gamma
    [M, K, K] — the O(M·K²) memory that dominates HMTM at scale; the
    device keeps eta/alpha/beta.  Same batch pipeline and guarantees as
    the other streaming models: globals are frozen within a sweep, so
    the trajectory equals the in-memory path and is invariant to the
    batch partition."""

    _doc_state = ("tau", "gamma")
    _api_cls = "HMTM"
    _globals = ("eta", "alpha", "beta")

    def __init__(self, packed, K: int, batch_docs: int = 8192,
                 chunk_docs: int = 1024, dtype=jnp.float32, seed: int = 0,
                 mesh=None, data_axis: str = "data",
                 state_dir: Optional[str] = None):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        from .models import hmtm as hmtm_mod
        hmtm_mod.check_order_preserving(packed)
        npdt = np.dtype(dtype)
        M_pad = self.M_rows   # this process's doc rows
        # constructor state (HMTM.jl:26-32, = models/hmtm.init)
        key = jax.random.PRNGKey(seed)
        self.beta = dirichlet_ones(key, self.V, (self.K,)).astype(self.dtype)
        self.eta = jnp.ones((self.K,), self.dtype)
        self.alpha = jnp.ones((self.K, self.K), self.dtype)
        self.tau = self._host_full("tau", (M_pad, self.K), 1.0, npdt)
        self.gamma = self._host_full("gamma", (M_pad, self.K, self.K), 1.0, npdt)
        self._sweep = None
        self._elbo_fn = None

    def _compile(self, cfg):
        from .models import hmtm as hmtm_mod

        V = self.V
        viter, vtol = cfg.viter, cfg.vtol

        def prep(globs):
            beta, eta, alpha = globs
            eps = jnp.asarray(EPSILON, beta.dtype)
            return beta.T + eps, eta, alpha

        def chunk_call(prepped, d, s):
            betaT_eps, eta, alpha = prepped
            terms, counts, dm = d
            tmask = (counts > 0).astype(betaT_eps.dtype)
            tau2, gamma2, bt, ps, ts = hmtm_mod._estep_chunk(
                betaT_eps, eta, alpha, terms, tmask, dm, *s,
                viter, vtol, V)
            return (tau2, gamma2), (bt, ps, ts)

        self._sweep = make_generic_batch_sweep(
            prep, chunk_call, self.chunk_docs, mesh=self.mesh,
            data_axis=self.data_axis)
        ax = self.data_axis if self.mesh is not None else None
        self._elbo_fn = self._wrap_batch_elbo(
            hmtm_mod.make_elbo(self.packed, self.K,
                               chunk_docs=self.chunk_docs, axis_name=ax),
            hmtm_mod.partition_spec(self.data_axis))

    def _zero_stats(self):
        return (jnp.zeros((self.V, self.K), self.dtype),
                jnp.zeros((self.K,), self.dtype),
                jnp.zeros((self.K, self.K), self.dtype))

    def _run_batch(self, sl, stats):
        return self._sweep((self.beta, self.eta, self.alpha),
                           self._data_slices(sl), self._doc_slices(sl),
                           stats)

    def _global_update(self, stats):
        beta, eta, alpha = _hmtm_mstep(
            *stats, self.eta, self.alpha,
            jnp.asarray(float(self.M), self.dtype),
            self._cfg.niter, self._cfg.ntol)
        self.beta, self.eta, self.alpha = beta, eta, alpha

    def _batch_state(self, sl):
        from .models import hmtm as hmtm_mod

        tau, gamma = self._doc_slices(sl)
        return hmtm_mod.HMTMState(
            eta=self.eta, alpha=self.alpha, beta=self.beta,
            tau=tau, gamma=gamma, elbo=jnp.zeros((), self.dtype))

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        cfg = TrainConfig(iter=iter, tol=tol, niter=niter, ntol=ntol,
                          viter=viter, vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online SVI HMTM: beta is a normalized count table and the
        eta/alpha Newtons consume per-doc expected-log sums — all
        closed-form in (beta_temp, pi_sum, th_sum), so the
        running-average blend applies exactly as for LDA."""
        cfg = TrainConfig(iter=epochs, niter=niter, ntol=ntol, viter=viter,
                          vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


# ─────────────────────────── StreamingDTM ───────────────────────────

class StreamingDTM(_StreamingModel):
    """DTM trained with host-resident corpus + per-doc state
    (the last family to get a beyond-memory path).

    The [T, K, V] smoother state (alpha/betahat/mbeta/vbeta/v_filt)
    stays device-resident — it is the model's *global* parameter block,
    independent of corpus size — while the O(M·K) per-document state
    (gamma/Elogtheta/lzeta) lives in host RAM or ``state_dir`` memmaps
    and streams through the device in batches, exactly like the other
    six families.  The M-step (per-slice alpha Newtons + the betahat
    Polak–Ribière CG) is the SAME function the in-memory step runs
    (models/dtm.py:make_global_update), so the streamed trajectory is
    the in-memory maths by construction.

    ``slice_id`` is the per-packed-row time-slice assignment
    ([M_pad] int32, 0-based; rows beyond M are ignored — use
    :func:`slices_from_stamps` to build it the reference's way,
    v0.6/src/DTM.jl:58-63).
    """

    _doc_state = ("gamma", "Elogtheta", "lzeta")
    _globals = ("alpha", "betahat", "mbeta", "vbeta", "v_filt")

    def __init__(self, packed, K: int, T: int, slice_id,
                 batch_docs: int = 8192, chunk_docs: int = 1024,
                 dtype=jnp.float32, seed: int = 0, mesh=None,
                 data_axis: str = "data",
                 state_dir: Optional[str] = None):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed,
                          mesh, data_axis, state_dir=state_dir)
        self.T = int(T)
        slice_id = np.asarray(slice_id, np.int32)
        if slice_id.shape != (packed.M_pad,):
            raise ValueError(
                f"slice_id must be [M_pad]={packed.M_pad} int32 "
                f"(got {slice_id.shape})")
        if slice_id.min() < 0 or slice_id[: packed.M].max() >= self.T:
            raise ValueError("slice_id entries must lie in [0, T).")
        self.slice_full = slice_id
        npdt = np.dtype(dtype)
        M_pad = self.M_rows   # this process's doc rows

        # device-resident globals (= models/dtm.init's global block)
        from .models import dtm as dtm_mod

        key = jax.random.PRNGKey(seed)
        self.betahat = jax.random.normal(key, (self.T, self.K, self.V),
                                         self.dtype)
        self.alpha = jnp.ones((self.T, self.K), self.dtype)
        self.v_filt, self.vbeta = dtm_mod.variance_smoother(
            self.T, self.K, self.V, self.dtype)
        self.mbeta = dtm_mod.mean_smoother(self.betahat, self.v_filt)
        # host-resident per-doc state; gamma=1 ⇒ Elogtheta = −H_{K−1}
        el0 = -sum(1.0 / i for i in range(1, self.K))
        self.gamma = self._host_full("gamma", (M_pad, self.K), 1.0, npdt)
        self.Elogtheta = self._host_full(
            "Elogtheta", (M_pad, self.K), el0, npdt)
        self.lzeta = self._host_full("lzeta", (M_pad,), 1.0, npdt)
        self._sweep = None
        self._elbo_fn = None
        self._gupd = None

    def _ctor_meta(self) -> dict:
        return {"T": self.T}

    def _ctor_host_arrays(self) -> dict:
        return {"slice_id": self.slice_full}

    def _data_slices(self, sl) -> tuple:
        p = self.packed
        g = self._gsl(sl)
        return (jnp.asarray(self.slice_full[g]),
                jnp.asarray(p.terms[g]),
                jnp.asarray(p.counts[g].astype(self.dtype)),
                jnp.asarray(p.doc_mask[g].astype(self.dtype)))

    def _compile(self, cfg):
        from .models import dtm as dtm_mod

        T, V = self.T, self.V
        viter, vtol = cfg.viter, cfg.vtol

        def prep(globs):
            alpha, mbeta, vbeta = globs
            # per-sweep overflow-safe Σ_v exp(mbeta + vbeta/2) pieces
            # (DTM.jl:225-228) — identical to models/dtm.make_step
            x = mbeta + 0.5 * vbeta
            maxl = jnp.max(x, axis=(1, 2))
            rowsum_ovfl = jnp.sum(jnp.exp(x - maxl[:, None, None]), axis=2)
            mbeta_flat = jnp.transpose(mbeta, (0, 2, 1)).reshape(T * V, -1)
            return mbeta_flat, alpha, rowsum_ovfl, maxl

        def chunk_call(prepped, d, s):
            mbeta_flat, alpha, rowsum_ovfl, maxl = prepped
            sid, t, c, dm = d
            g, el, lz = s
            g2, el2, lz2, A, wz, els, nd = dtm_mod._estep_chunk(
                mbeta_flat, alpha, rowsum_ovfl, maxl,
                sid, t, c, dm, g, el, lz, viter, vtol, V)
            return (g2, el2, lz2), (A, wz, els, nd)

        self._sweep = make_generic_batch_sweep(
            prep, chunk_call, self.chunk_docs, mesh=self.mesh,
            data_axis=self.data_axis)
        ax = self.data_axis if self.mesh is not None else None
        # batch bound = doc/token terms only; the slice-level
        # Elogpbeta − Elogqbeta terms are added once per sweep
        self._elbo_fn = self._wrap_batch_elbo(
            dtm_mod.make_elbo(self.packed, self.K, self.T,
                              chunk_docs=self.chunk_docs, axis_name=ax,
                              include_slice_terms=False),
            dtm_mod.partition_spec(self.data_axis), n_data=4)
        self._gupd = jax.jit(dtm_mod.make_global_update(
            cfg.niter, cfg.ntol, self._cgiter, self._cgtol))
        self._slice_terms = jax.jit(
            lambda st: dtm_mod.slice_elbo_terms(st))

    def _zero_stats(self):
        return (jnp.zeros((self.T * self.V, self.K), self.dtype),
                jnp.zeros((self.T, self.K), self.dtype),
                jnp.zeros((self.T, self.K), self.dtype),
                jnp.zeros((self.T,), self.dtype))

    def _run_batch(self, sl, stats):
        return self._sweep((self.alpha, self.mbeta, self.vbeta),
                           self._data_slices(sl), self._doc_slices(sl),
                           stats)

    def _global_update(self, stats):
        A, wz, els, nd = stats
        self.alpha, self.betahat, self.mbeta = self._gupd(
            self.alpha, self.betahat, self.v_filt, self.vbeta,
            A, wz, els, jnp.zeros_like(els), nd)

    def _batch_state(self, sl):
        from .models import dtm as dtm_mod

        g, el, lz = self._doc_slices(sl)
        return dtm_mod.DTMState(
            alpha=self.alpha, betahat=self.betahat, mbeta=self.mbeta,
            vbeta=self.vbeta, v_filt=self.v_filt,
            gamma=g, Elogtheta=el, lzeta=lz,
            elbo=jnp.zeros((2,), self.dtype))

    def _sweep_elbo(self):
        acc = 0.0
        for sl in self._batches():
            acc += elbo_value(self._elbo_fn(self._batch_state(sl),
                                            *self._data_slices(sl)))
        total = self._reduce_elbo(acc, 0.0)
        # slice-level terms: replicated across processes, added ONCE
        return total + float(np.asarray(self._slice_terms(
            self._batch_state(slice(0, self.batch_docs)))))

    def _finalize(self):
        from .models import dtm as dtm_mod

        self.topics = dtm_mod.topics_ranking_by_slice(
            np.asarray(self.mbeta))

    def to_model(self, runtime=None):
        raise ValueError(
            "StreamingDTM.to_model is unsupported: the api.DTM "
            "constructor derives its time slices from Corpus stamps "
            "(api.py:DTM), which a PackedCorpus does not carry.  Use "
            "save()/load() for persistence; showtopics-style output is "
            "available via .topics (per-slice rankings).")

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, cgiter: int = 20,
              cgtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        if cgiter <= 0:
            raise ValueError("iteration parameters must be positive integers.")
        self._cgiter = int(cgiter)
        self._cgtol = float(cgtol) if cgtol is not None else 1.0 / self.T**2
        cfg = TrainConfig(iter=iter, tol=tol, niter=niter, ntol=ntol,
                          viter=viter, vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0,
                     kappa: float = 0.7, viter: int = 10,
                     vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, cgiter: int = 20,
                     cgtol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0,
                     checkpoint_dir: Optional[str] = None):
        """Online SVI DTM: A/wz/els/nd are all linear per-document
        sums, so the running-average blend applies exactly as for LDA;
        the CG M-step then maximises against the blended statistics."""
        if cgiter <= 0:
            raise ValueError("iteration parameters must be positive integers.")
        self._cgiter = int(cgiter)
        self._cgtol = float(cgtol) if cgtol is not None else 1.0 / self.T**2
        cfg = TrainConfig(iter=epochs, niter=niter, ntol=ntol, viter=viter,
                          vtol=vtol, checkelbo=checkelbo,
                          printelbo=printelbo).resolved(self.K)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed,
                                       checkpoint_every, checkpoint_dir)


def slices_from_stamps(stamps, delta: float, M_pad: Optional[int] = None):
    """Reference slice assignment (v0.6/src/DTM.jl:58-63): docs with
    stamp ≤ t0 + t·delta land in slice t.  Returns (T, slice_id[M_pad])
    for :class:`StreamingDTM` (pad rows get slice 0; their doc_mask is
    0 so they contribute nothing)."""
    stamps = np.asarray(stamps, np.float64)
    if stamps.size == 0 or not np.all(np.isfinite(stamps)):
        raise ValueError("every document must carry a finite stamp.")
    t0, tM = float(stamps.min()), float(stamps.max())
    import math as _math
    T = max(1, int(_math.ceil((tM - t0) / float(delta))))
    sid = np.clip(np.ceil((stamps - t0) / float(delta)).astype(np.int64),
                  1, T) - 1
    n = M_pad if M_pad is not None else len(stamps)
    out = np.zeros(n, np.int32)
    out[: len(stamps)] = sid
    return T, out
