"""User-facing model API.

Mirrors the reference's public surface (src/TopicModelsVB.jl:11-18):
``Model(corp, K)`` constructors, ``train(...)`` with the reference's
kwargs and defaults, and the post-hoc tools ``topicdist``,
``showtopics``, plus (per model) ``predict``, ``gendoc``/``gencorp``,
``showlibs``/``showdrecs``/``showurecs``.

Unlike the reference there is no CPU/GPU model split and no ``@gpu``
macro (macros.jl:106-284): every model runs the same jitted,
shard_map'd path whether the mesh has 1 device or many.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import corpus as corpuslib
from .corpus import Corpus, CorpusError
from .engine import Trainer
from .models import ctm as ctm_mod
from .models import ctpf as ctpf_mod
from .models import dtm as dtm_mod
from .models import fctm as fctm_mod
from .models import flda as flda_mod
from .models import hmtm as hmtm_mod
from .models import lda as lda_mod
from .ops.packing import bucketize_packed, pack_corpus
from .parallel.mesh import make_mesh
from .parallel.shard import dp_jit
from .utils.config import RuntimeConfig, TrainConfig


from .ops.packing import _round_up  # shared with the packing layer


class TopicModelError(Exception):
    """Mirror of the reference TopicModelError (modelutils.jl:1-5)."""


class TopicModel:
    """Common construction/packing/mesh logic for all five models."""

    _uses_readers = False
    _bucketed = False   # length-bucketed token packing (SURVEY §5.7a)
    _per_doc_fields: tuple = ()   # state fields with a leading doc axis
    # chunk_docs used when the caller passes no RuntimeConfig; the
    # Newton-heavy CTM/fCTM amortize their while-loop latency over
    # larger chunks (tuned on earlier hardware; not measured on the H100)
    _preferred_chunk: int = 1024

    def _ctor_kwargs(self) -> dict:
        """Extra constructor kwargs a checkpoint must replay."""
        return {}

    def __init__(
        self,
        corp,
        K: int,
        runtime: Optional[RuntimeConfig] = None,
        mesh=None,
        seed: int = 0,
    ):
        """``corp`` is a :class:`Corpus`, or a prebuilt
        :class:`~..ops.packing.PackedCorpus` for data that never existed
        as Document objects (synthetic benchmarks, external pipelines);
        with a PackedCorpus the corpus-text post-hoc surface
        (showtopics/showdocs/gendoc word output) is unavailable."""
        from .ops.packing import PackedCorpus

        if K <= 0:
            raise ValueError("number of topics must be a positive integer.")

        self.K = int(K)
        if runtime is None:
            runtime = RuntimeConfig(chunk_docs=self._preferred_chunk)
        self.runtime = runtime
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(self.runtime.data_axis,))
        self.seed = seed
        n_sh = self.mesh.shape[self.runtime.data_axis]

        if isinstance(corp, PackedCorpus):
            self.corp = None
            self.M, self.V, self.U = corp.M, corp.V, corp.U
            if corp.inv_order is not None:
                # already bucketized: rows are length-permuted and
                # interleaved with padding — index back to doc order
                rows = corp.inv_order[: corp.M]
                self.N = corp.N[rows].tolist()
                self.C = corp.C[rows].tolist()
            else:
                self.N = corp.N[: corp.M].tolist()
                self.C = corp.C[: corp.M].tolist()
            if corp.segments is not None and corp.n_shards != n_sh:
                # bucketed rows are SHARD-MAJOR for corp.n_shards shards;
                # a different mesh data-axis size would pair each device's
                # segment rows with the wrong per-doc state rows — a
                # silent-corruption layout, so reject loudly
                raise TopicModelError(
                    f"pre-bucketed corpus was laid out for n_shards="
                    f"{corp.n_shards} but the mesh data axis has {n_sh} "
                    f"devices; re-bucketize with n_shards={n_sh}.")
            per_shard = max(1, math.ceil(max(self.M, 1) / n_sh))
            cand = min(self.runtime.chunk_docs, _round_up(per_shard, 8))
            if corp.segments is not None and corp.chunk:
                # pre-bucketed rows come in multiples of corp.chunk per
                # shard: clamp to a divisor so the scan tiles evenly
                cand = (corp.chunk if cand >= corp.chunk
                        else math.gcd(cand, corp.chunk))
            self.chunk_docs = cand
            self.packed = corp
            # fingerprint source: the user-visible (pre-bucketing) packed
            # object — checkpoint.load compares against the same input;
            # hashed lazily on first checkpoint (see _fingerprint)
            self._fp_src = corp
        else:
            corpuslib.check_corp(corp)
            self.corp = corp.copy()  # corpus-level isolation (LDA.jl:44)
            self.M, self.V, self.U = corp.shape
            self.N = [len(doc) for doc in corp.docs]
            self.C = [doc.size for doc in corp.docs]
            per_shard = max(1, math.ceil(max(self.M, 1) / n_sh))
            self.chunk_docs = min(self.runtime.chunk_docs, _round_up(per_shard, 8))
            self.packed = pack_corpus(
                self.corp,
                pad_multiple=self.runtime.pad_multiple,
                docs_multiple=self.chunk_docs * n_sh,
                with_readers=self._uses_readers,
                dtype=np.dtype(self.runtime.dtype),
            )
            self._fp_src = self.corp
        if self._uses_readers and (
            self.packed.readers is None or self.packed.ratings is None
            or self.packed.R is None
        ):
            raise ValueError(
                "this model requires reader arrays (readers, ratings, R) "
                "in the packed corpus.")
        if self._bucketed and self.packed.segments is None:
            # length-sorted, shard-major, per-segment token widths; doc-
            # indexed accessors map through packed.inv_order
            self.packed = bucketize_packed(
                self.packed, chunk=self.chunk_docs, n_shards=n_sh,
                pad_multiple=min(self.runtime.bucket_pad,
                                 self.runtime.pad_multiple),
            )
        elif not self._bucketed and self.packed.M_pad % (self.chunk_docs * n_sh):
            raise ValueError(
                f"packed doc axis {self.packed.M_pad} must divide into "
                f"chunk_docs×shards = {self.chunk_docs}×{n_sh}")
        self.dtype = jnp.dtype(self.runtime.dtype)
        self.key = jax.random.PRNGKey(seed)
        self.state = None
        self.trainer: Optional[Trainer] = None
        self.topics: Optional[np.ndarray] = None  # [K, V] 1-based rankings
        # global outer-iteration counter (monotone across resumes):
        # checkpoint save/load round-trips it so a resumed run continues
        # k, JSONL rows, and ckpt_iter* filenames without collision
        self.trained_iters: int = 0
        self._ckpt_writer = None   # AsyncWriter when auto-checkpointing
        # serve-path cache: jitted E-step programs keyed by (inference
        # config, packed shape signature) — see infer()/predict().
        # LRU-bounded: a long-lived serving loop over varying corpus
        # shapes must not accumulate compiled executables forever.
        from collections import OrderedDict
        self._infer_cache: OrderedDict = OrderedDict()
        self._infer_cache_max = 8
        self._init_state()

    @property
    def _fingerprint(self) -> str:
        """Corpus fingerprint for checkpoints — computed lazily on the
        first checkpoint (hashing the full corpus costs seconds at NSF
        scale) and cached (immutable for the model's lifetime; the
        auto-checkpoint cadence must not rehash per tick)."""
        if getattr(self, "_fingerprint_cache", None) is None:
            from .checkpoint import corpus_fingerprint, packed_fingerprint

            src = self._fp_src
            self._fingerprint_cache = (
                corpus_fingerprint(src) if isinstance(src, Corpus)
                else packed_fingerprint(src))
            self._fp_src = None   # drop the pre-bucket reference
        return self._fingerprint_cache

    # ── subclass hooks ──
    def _init_state(self):
        raise NotImplementedError

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        raise NotImplementedError

    def _finalize(self):
        """Post-train artifacts (topics ranking etc.)."""
        self.topics = lda_mod.topics_ranking(self._topic_word_matrix())

    def _topic_word_matrix(self) -> np.ndarray:
        return np.asarray(self.state.beta)

    def _dev_data(self, a):
        """Place a doc-major host array sharded over the data axis —
        multi-process-safe (parallel/multihost.make_global_array)."""
        from jax.sharding import PartitionSpec as P

        from .parallel.multihost import make_global_array
        return make_global_array(a, self.mesh, P(self.runtime.data_axis))

    def _dev_repl(self, x, dtype=None):
        """Place a replicated scalar/array — multi-process-safe."""
        from jax.sharding import PartitionSpec as P

        from .parallel.multihost import make_global_array
        a = np.asarray(x, dtype=dtype if dtype is not None else self.dtype)
        return make_global_array(a, self.mesh, P())

    def _data_arrays(self) -> tuple:
        """Device data args (terms, counts, doc_mask) — per-segment tuples
        under bucketed packing, dense arrays otherwise."""
        p = self.packed
        if p.segments is not None:
            return (
                tuple(self._dev_data(s.terms) for s in p.segments),
                tuple(self._dev_data(s.counts) for s in p.segments),
                tuple(self._dev_data(s.doc_mask) for s in p.segments),
            )
        return (self._dev_data(p.terms), self._dev_data(p.counts),
                self._dev_data(p.doc_mask))

    def _padded_tokens(self) -> int:
        """Token slots actually processed per sweep (padding included)."""
        p = self.packed
        if p.segments is not None:
            return int(sum(s.terms.size for s in p.segments))
        return int(np.asarray(p.terms).size)

    def _flops_per_step(self) -> float:
        """Arithmetic estimate for one outer iteration (the TFLOP/s figure).

        E-step lower bound: each of the ``viter`` sweeps does ~6 flops per
        (token-slot, topic) — exp(Elogtheta)·beta gather-multiply, the phi
        normalisation, and the gamma/beta stat mult-adds (LDA.jl:129-154).
        Subclasses add their deterministic extra work (CTM/fCTM Newton
        floor, fLDA/fCTM tau, CTPF xi, DTM smoother+CG, HMTM chains);
        data-dependent early-exited iterations stay uncounted, so the
        reported rate is a lower bound.
        """
        viter = self._cfg.viter if getattr(self, "_cfg", None) else 10
        return float(viter * self._padded_tokens() * 6 * self.K)

    def _step_data(self) -> tuple:
        """Positional device data for the jitted step — (terms, counts,
        doc_mask[, per-model replicated scalars]).  Shared by the
        trainer build and the cached inference path."""
        return self._data_arrays() + (self._dev_repl(float(self.M)),)

    def _packed_sig(self) -> tuple:
        """Shape signature of the packed corpus: two corpora with equal
        signatures trace to the identical jitted program, so a compiled
        inference step is reusable across them."""
        p = self.packed
        if p.segments is not None:
            return (p.M_pad, tuple((s.terms.shape, s.loc_start)
                                   for s in p.segments))
        return (p.M_pad, p.terms.shape)

    def infer(self, corp, iter: int = 10, tol: Optional[float] = None,
              niter: int = 1000, ntol: Optional[float] = None):
        """E-step-only inference on new documents with frozen globals —
        the serve path (reference predict, modelutils.jl:831-855).

        Identical semantics to :func:`predict`, but the compiled step is
        cached on THIS model keyed by (inference config, packed shape
        signature): repeated calls with same-shaped corpora trigger no
        model reconstruction of the jitted program and zero
        recompilation."""
        return predict(corp, self, iter=iter, tol=tol, niter=niter,
                       ntol=ntol)

    def _trainer_kw(self, spec=None) -> dict:
        kw = dict(C=int(sum(self.C)),
                  flops_per_step=self._flops_per_step(),
                  metrics_path=self.runtime.metrics_path,
                  profile_dir=self.runtime.profile_dir,
                  profile_steps=self.runtime.profile_steps)
        rt = self.runtime
        if rt.checkpoint_every > 0 and rt.checkpoint_dir:
            # §5.3 auto-checkpoint cadence: atomic (tmp + rename) so a
            # SIGKILL mid-write never leaves a torn latest checkpoint.
            # Multi-controller runs write the directory format — every
            # process saves its addressable shards, checkpoint.save
            # barriers internally, and process 0 performs the rename —
            # so a multi-host run resumes from its last checkpoint on
            # any process count (SURVEY §5.3 kill-a-host bar).
            import os
            import shutil

            from . import checkpoint as ckptlib

            def _clear(p):
                # leftovers may be a FILE (single-host format) or a
                # non-empty DIRECTORY (multi-host format) — e.g. a
                # killed run's stale tmp (the global iteration counter
                # means a resumed run never reuses an iter number).
                # os.replace handles neither onto-a-dir case itself.
                if os.path.isdir(p):
                    shutil.rmtree(p)
                elif os.path.exists(p):
                    os.remove(p)

            def _ckpt_cb(k, state):
                self.state = state
                self.trained_iters = int(k)   # checkpoint carries global k
                os.makedirs(rt.checkpoint_dir, exist_ok=True)
                final = os.path.join(rt.checkpoint_dir, f"ckpt_iter{k:06d}")
                tmp = final + ".tmp"
                if jax.process_count() == 1:
                    # ASYNC path: capture an immutable snapshot + start the
                    # device→host DMA on this thread (~free), then hand the
                    # fetch + serialise + atomic rename to the background
                    # writer — the training loop never blocks on disk or
                    # a multi-GB transfer (todo.txt item 5, orbax-style).
                    # One-slot back-pressure: a new submit first joins the
                    # previous write.
                    if self._ckpt_writer is None:
                        self._ckpt_writer = ckptlib.AsyncWriter()
                    snap = ckptlib.snapshot(
                        self, compress="f16" if rt.checkpoint_f16 else None)

                    def _write():
                        _clear(tmp)
                        ckptlib.write_snapshot(tmp, snap)
                        if os.path.isdir(final):
                            _clear(final)
                        os.replace(tmp, final)

                    self._ckpt_writer.submit(_write)
                    return
                # multi-controller path stays synchronous: the shard
                # writes and the manifest-last protocol need the same
                # cross-process barriers as checkpoint.save itself
                if jax.process_index() == 0:
                    _clear(tmp)
                # don't let other processes write shard files into a
                # stale tmp dir that process 0 is still removing
                from jax.experimental import multihost_utils
                multihost_utils.sync_global_devices(
                    f"tmvb_ckpt_clear:{final}")
                ckptlib.save(tmp, self)
                if jax.process_index() == 0:
                    # directories (multi-host layout) can't be renamed
                    # over a non-empty target, so clear first
                    if os.path.isdir(final) or os.path.isdir(tmp):
                        _clear(final)
                    os.replace(tmp, final)

            kw["checkpoint_cb"] = _ckpt_cb
            kw["checkpoint_every"] = rt.checkpoint_every
        if spec is not None:
            from jax.sharding import NamedSharding

            kw["state_sharding"] = jax.tree_util.tree_map(
                lambda s: NamedSharding(self.mesh, s), spec)
        return kw

    # ── training (reference train!, LDA.jl:161-191) ──
    def train(
        self,
        iter: int = 150,
        tol: float = 1.0,
        niter: int = 1000,
        ntol: Optional[float] = None,
        viter: int = 10,
        vtol: Optional[float] = None,
        checkelbo: float = 1,
        printelbo: bool = True,
    ):
        cfg = TrainConfig(
            iter=iter, tol=tol, niter=niter, ntol=ntol, viter=viter,
            vtol=vtol, checkelbo=checkelbo, printelbo=printelbo,
        ).resolved(self.K)
        cfg.validate()
        # check_model: every train! entry validates the full variational
        # state (reference modelutils.jl:39-360); on-device reductions
        from .validate import check_model
        check_model(self)
        self._cfg = cfg
        self.trainer = self._build_trainer(cfg)
        all_empty = all(n == 0 for n in self.N)
        try:
            self.state = self.trainer.train(
                self.state, cfg, corpus_all_empty=all_empty,
                start_iter=self.trained_iters)
        except BaseException:
            # drain the writer but keep the TRAINING failure primary: a
            # deferred checkpoint-write error must not mask an in-flight
            # XLA/step exception (it stays reachable via __context__)
            if self._ckpt_writer is not None:
                try:
                    self._ckpt_writer.wait()
                except Exception:
                    pass
            raise
        if self._ckpt_writer is not None:
            # drain the in-flight async checkpoint before returning; a
            # deferred write error surfaces here, on a clean run
            self._ckpt_writer.wait()
        if self.trainer.trace:
            self.trained_iters = self.trainer.trace[-1].k
        self._finalize()
        return self

    # ── post-hoc API ──
    @property
    def elbo(self) -> float:
        from .utils.numerics import elbo_value

        return elbo_value(self.state.elbo)

    def topicdist(self, d):
        """Topic distribution for doc(s), 1-based index (modelutils.jl:946-984)."""
        scalar = np.isscalar(d)
        idx = np.atleast_1d(np.asarray(d, dtype=np.int64))
        if np.any((idx < 1) | (idx > self.M)):
            raise CorpusError("some document indices outside corpus range.")
        out = self._topicdist_rows(self._rows(idx - 1))
        return out[0] if scalar else out

    def _rows(self, doc_idx: np.ndarray) -> np.ndarray:
        """Original 0-based doc indices → packed state rows."""
        if self.packed.inv_order is not None:
            return self.packed.inv_order[doc_idx]
        return doc_idx

    def _doc_rows(self) -> np.ndarray:
        """Packed state rows for docs 1..M in original order."""
        return self._rows(np.arange(self.M, dtype=np.int64))

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def showtopics(self, V: int = 15, topics=None, cols: int = 4):
        """Aligned top-terms display (reference modelutils.jl:656-684)."""
        if V <= 0:
            raise ValueError("number of displayed terms must be a positive integer.")
        if cols <= 0:
            raise ValueError("cols must be a positive integer.")
        if topics is None:
            topics = range(1, self.K + 1)
        if isinstance(topics, int):
            topics = [topics]
        topics = list(topics)
        if not all(1 <= t <= self.K for t in topics):
            raise ValueError("some topic indices are outside range.")
        V = min(V, self.V)
        cols = min(cols, len(topics))
        vocab = self.corp.vocab if self.corp is not None else {}
        rank = self.topics if self.topics is not None else lda_mod.topics_ranking(
            self._topic_word_matrix()
        )

        blocks = [topics[i : i + cols] for i in range(0, len(topics), cols)]
        for n, block in enumerate(blocks):
            col_words = [[vocab.get(int(rank[t - 1, j]), f"#term{int(rank[t - 1, j])}")
                          for j in range(V)] for t in block]
            widths = [
                max(len(f"topic {t}"), max(len(w) for w in words)) + 3
                for t, words in zip(block, col_words)
            ]
            line = "".join(f"topic {t}".ljust(w) for t, w in zip(block, widths))
            print(line.rstrip())
            for j in range(V):
                print("".join(words[j].ljust(w) for words, w in zip(col_words, widths)).rstrip())
            if n < len(blocks) - 1:
                print()

    def _require_corp(self):
        if self.corp is None:
            raise TopicModelError(
                "this model was built from a PackedCorpus; corpus-text "
                "displays need a Corpus.")

    def showdocs(self, docs=None):
        self._require_corp()
        corpuslib.showdocs(self.corp, docs)

    def showtitles(self, docs=None):
        self._require_corp()
        corpuslib.showtitles(self.corp, docs)

    def getvocab(self):
        self._require_corp()
        return corpuslib.getvocab(self.corp)

    def getusers(self):
        self._require_corp()
        return corpuslib.getusers(self.corp)


class LDA(TopicModel):
    """Latent Dirichlet allocation (reference src/LDA.jl, src/gpuLDA.jl)."""

    _bucketed = True
    _per_doc_fields = ("gamma", "Elogtheta", "Elogtheta_old")

    def __repr__(self):
        return f"Latent Dirichlet allocation model with {self.K} topics."

    def _init_state(self):
        self.state = lda_mod.init(self.key, self.packed, self.K, self.dtype)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = lda_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
            use_pallas=None if self.runtime.use_pallas else False,
            elogtheta_f64=self.runtime.elogtheta_f64,
        )
        elbo_local = lda_mod.make_elbo(
            p, self.K, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
        )
        spec = lda_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=3, n_repl_args=1,
                      data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=3, out_spec=P(),
                      data_axis=self.runtime.data_axis)

        data = self._step_data()
        return Trainer(step, elbo, data, data[:3], M=self.M,
                       **self._trainer_kw(spec))

    # alpha/beta/gamma accessors (reference field access)
    @property
    def alpha(self) -> np.ndarray:
        return np.asarray(self.state.alpha)

    @property
    def beta(self) -> np.ndarray:
        return np.asarray(self.state.beta)

    @property
    def gamma(self) -> np.ndarray:
        return np.asarray(self.state.gamma)[self._doc_rows()]

    @property
    def Elogtheta(self) -> np.ndarray:
        return np.asarray(self.state.Elogtheta)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = np.asarray(self.state.gamma)[rows]
        return g / g.sum(axis=-1, keepdims=True)


class HMTM(TopicModel):
    """Hidden Markov topic model — the completed form of the reference's
    unfinished research stub (HMTM/HMTM.jl; ``updatePhi!`` was never
    solved there).  Word order matters: every entry of a document's
    terms vector is one token *in order* and counts are ignored
    (HMTM.jl:63-67), so corpora should not be ``condense``d.  See
    models/hmtm.py for the structured-VB construction."""

    _bucketed = True
    _per_doc_fields = ("tau", "gamma")

    def __repr__(self):
        # reference Base.show (HMTM.jl:42)
        return f"Hidden Markov topic model with {self.K} topics."

    def _init_state(self):
        self.state = hmtm_mod.init(self.key, self.packed, self.K, self.dtype)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = hmtm_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
        )
        elbo_local = hmtm_mod.make_elbo(
            p, self.K, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
        )
        spec = hmtm_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=3,
                      n_repl_args=1, data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=3,
                      out_spec=P(), data_axis=self.runtime.data_axis)

        data = self._step_data()
        return Trainer(step, elbo, data, data[:3], M=self.M,
                       **self._trainer_kw(spec))

    def _flops_per_step(self) -> float:
        """Forward–backward is ~5·K² flops per (token, viter+1) sweep —
        the chain contractions dominate, not the per-token gather."""
        viter = self._cfg.viter if getattr(self, "_cfg", None) else 10
        return float((viter + 1) * self._padded_tokens() * 5 * self.K**2)

    @property
    def eta(self) -> np.ndarray:
        return np.asarray(self.state.eta)

    @property
    def alpha(self) -> np.ndarray:
        return np.asarray(self.state.alpha)

    @property
    def beta(self) -> np.ndarray:
        return np.asarray(self.state.beta)

    @property
    def tau(self) -> np.ndarray:
        return np.asarray(self.state.tau)[self._doc_rows()]

    @property
    def gamma(self) -> np.ndarray:
        return np.asarray(self.state.gamma)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        t = np.asarray(self.state.tau)[rows]
        return t / t.sum(axis=-1, keepdims=True)

    def transdist(self, d):
        """Expected per-doc topic-transition matrix E_q[theta_d]
        (columns sum to 1), 1-based doc index like topicdist."""
        scalar = np.isscalar(d)
        idx = np.atleast_1d(np.asarray(d, dtype=np.int64))
        if np.any((idx < 1) | (idx > self.M)):
            raise CorpusError("some document indices outside corpus range.")
        g = np.asarray(self.state.gamma)[self._rows(idx - 1)]
        out = g / g.sum(axis=-2, keepdims=True)
        return out[0] if scalar else out


class CTM(TopicModel):
    """Correlated topic model (reference src/CTM.jl, src/gpuCTM.jl).

    ``identify=True`` opts into the projection normalisation the
    reference's todo.txt:25 / issue #14 propose for the long-run
    topic-dimension degeneracy (the logistic-normal's K−1 dof let one
    coordinate gauge-fix itself to a deterministic level, collapsing a
    sigma eigenvalue ~1/iter); see models/ctm.py make_step.  Default
    OFF — the exact reference semantics."""

    _bucketed = True
    _per_doc_fields = ("lam", "lam_old", "vsq", "logzeta")
    _preferred_chunk = 2048

    def __init__(self, corp, K, runtime=None, mesh=None, seed: int = 0,
                 identify: bool = False):
        self.identify = bool(identify)
        super().__init__(corp, K, runtime=runtime, mesh=mesh, seed=seed)

    def _ctor_kwargs(self):
        # ride the checkpoint so a resumed run keeps the same gauge
        return {"identify": True} if self.identify else {}

    def __repr__(self):
        return f"Correlated topic model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """Base token-phi bound + the lambda Newton's deterministic floor:
        per viter pass, every doc runs ≥1 Newton iteration whose PCG solve
        does ≥1 [K]@[K,K] matvec (2K²) plus grad/vsq elementwise ~10K.
        Early-exiting Newton/CG iterations beyond the first are data-
        dependent and uncounted — still a lower bound."""
        viter = self._cfg.viter if getattr(self, "_cfg", None) else 10
        return super()._flops_per_step() + float(
            viter * self.packed.M_pad * (2 * self.K**2 + 10 * self.K))

    def _init_state(self):
        self.state = ctm_mod.init(self.key, self.packed, self.K, self.dtype)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = ctm_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
            identify=self.identify,
        )
        elbo_local = ctm_mod.make_elbo(
            p, self.K, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
        )
        spec = ctm_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=3, n_repl_args=1,
                      data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=3, out_spec=P(),
                      data_axis=self.runtime.data_axis)
        data = self._step_data()
        return Trainer(step, elbo, data, data[:3], M=self.M,
                       **self._trainer_kw(spec))

    @property
    def mu(self) -> np.ndarray:
        return np.asarray(self.state.mu)

    @property
    def sigma(self) -> np.ndarray:
        return np.asarray(self.state.sigma)

    @property
    def invsigma(self) -> np.ndarray:
        return np.asarray(self.state.invsigma)

    @property
    def beta(self) -> np.ndarray:
        return np.asarray(self.state.beta)

    @property
    def lam(self) -> np.ndarray:
        return np.asarray(self.state.lam)[self._doc_rows()]

    # Julia field name
    lambda_ = lam

    @property
    def vsq(self) -> np.ndarray:
        return np.asarray(self.state.vsq)[self._doc_rows()]

    @property
    def logzeta(self) -> np.ndarray:
        return np.asarray(self.state.logzeta)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        # E[exp x_i]/Σ E[exp x_j] under the mean-field Gaussian — a
        # (very good) moment approximation to E[exp x_i / Σ exp x_j],
        # exactly the reference's (modelutils.jl:957-960; its own
        # todo.txt:24 documents the approximation)
        x = np.asarray(self.state.lam)[rows] + 0.5 * np.asarray(self.state.vsq)[rows]
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class fCTM(TopicModel):
    """Filtered correlated topic model (reference src/fCTM.jl).

    ``identify=True`` gauge-fixes the Gaussian channel like CTM's
    (see CTM's docstring; reference todo.txt:25 / issue #14)."""

    _bucketed = True
    _per_doc_fields = ("lam", "lam_old", "vsq", "logzeta", "tau", "tau_old")
    _preferred_chunk = 2048

    def __init__(self, corp, K, runtime=None, mesh=None, seed: int = 0,
                 identify: bool = False):
        self.identify = bool(identify)
        super().__init__(corp, K, runtime=runtime, mesh=mesh, seed=seed)

    def _ctor_kwargs(self):
        return {"identify": True} if self.identify else {}

    def __repr__(self):
        return f"Filtered correlated topic model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """CTM-style Newton floor plus fLDA's ~4-flop/token tau update."""
        viter = self._cfg.viter if getattr(self, "_cfg", None) else 10
        return super()._flops_per_step() + float(
            viter * (self.packed.M_pad * (2 * self.K**2 + 10 * self.K)
                     + self._padded_tokens() * 4))

    def _init_state(self):
        self.state = fctm_mod.init(self.key, self.packed, self.K, self.dtype)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = fctm_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
            identify=self.identify,
        )
        elbo_local = fctm_mod.make_elbo(
            p, self.K, chunk_docs=self.chunk_docs, axis_name=self.runtime.data_axis
        )
        spec = fctm_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=3, n_repl_args=1,
                      data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=3, out_spec=P(),
                      data_axis=self.runtime.data_axis)
        data = self._step_data()
        return Trainer(step, elbo, data, data[:3], M=self.M,
                       **self._trainer_kw(spec))

    @property
    def eta(self) -> float:
        return float(self.state.eta)

    @property
    def mu(self) -> np.ndarray:
        return np.asarray(self.state.mu)

    @property
    def sigma(self) -> np.ndarray:
        return np.asarray(self.state.sigma)

    @property
    def invsigma(self) -> np.ndarray:
        return np.asarray(self.state.invsigma)

    @property
    def kappa(self) -> np.ndarray:
        return np.asarray(self.state.kappa)

    @property
    def beta(self) -> np.ndarray:
        return np.asarray(self.state.beta)

    @property
    def lam(self) -> np.ndarray:
        return np.asarray(self.state.lam)[self._doc_rows()]

    @property
    def vsq(self) -> np.ndarray:
        return np.asarray(self.state.vsq)[self._doc_rows()]

    @property
    def logzeta(self) -> np.ndarray:
        return np.asarray(self.state.logzeta)[self._doc_rows()]

    @property
    def tau(self):
        t = np.asarray(self.state.tau)
        rows = self._doc_rows()
        return [t[rows[d], : self.N[d]] for d in range(self.M)]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        x = np.asarray(self.state.lam)[rows] + 0.5 * np.asarray(self.state.vsq)[rows]
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class fLDA(TopicModel):
    """Filtered LDA (reference src/fLDA.jl)."""

    _bucketed = True
    _per_doc_fields = ("gamma", "Elogtheta", "Elogtheta_old", "tau", "tau_old")

    def __repr__(self):
        return f"Filtered latent Dirichlet allocation model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """Base bound + the ~4-flop/token/pass tau update (fLDA.jl:195-200)."""
        viter = self._cfg.viter if getattr(self, "_cfg", None) else 10
        return super()._flops_per_step() + float(
            viter * self._padded_tokens() * 4)

    def _init_state(self):
        self.state = flda_mod.init(self.key, self.packed, self.K, self.dtype)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = flda_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis,
            elogtheta_f64=self.runtime.elogtheta_f64,
        )
        elbo_local = flda_mod.make_elbo(
            p, self.K, chunk_docs=self.chunk_docs, axis_name=self.runtime.data_axis
        )
        spec = flda_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=3, n_repl_args=2,
                      data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=3, out_spec=P(),
                      data_axis=self.runtime.data_axis)
        data = self._step_data()
        return Trainer(step, elbo, data, data[:3], M=self.M,
                       **self._trainer_kw(spec))

    def _step_data(self) -> tuple:
        return self._data_arrays() + (
            self._dev_repl(float(self.M)),
            self._dev_repl(float(sum(self.C))),
        )

    @property
    def eta(self) -> float:
        return float(self.state.eta)

    @property
    def alpha(self) -> np.ndarray:
        return np.asarray(self.state.alpha)

    @property
    def kappa(self) -> np.ndarray:
        return np.asarray(self.state.kappa)

    @property
    def beta(self) -> np.ndarray:
        return np.asarray(self.state.beta)

    @property
    def gamma(self) -> np.ndarray:
        return np.asarray(self.state.gamma)[self._doc_rows()]

    @property
    def Elogtheta(self) -> np.ndarray:
        return np.asarray(self.state.Elogtheta)[self._doc_rows()]

    @property
    def tau(self):
        """Ragged view: list of per-doc tau vectors (reference fLDA.jl:25)."""
        t = np.asarray(self.state.tau)
        rows = self._doc_rows()
        return [t[rows[d], : self.N[d]] for d in range(self.M)]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = np.asarray(self.state.gamma)[rows]
        return g / g.sum(axis=-1, keepdims=True)


class _LazyRecs:
    """Sequence view over ranked recommendations (reference drecs/urecs,
    CTPF.jl:377-400) — each row is ranked on first access instead of
    materialising the full M·U ranking."""

    def __init__(self, model, kind: str, n: int):
        self._model = model
        self._kind = kind
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._model._rec_row(self._kind, i)

    def __iter__(self):
        return (self[i] for i in range(self._n))

    def __repr__(self):
        return f"<lazy {'doc' if self._kind == 'd' else 'user'} recs, {self._n} rows>"


class CTPF(TopicModel):
    """Collaborative topic Poisson factorization (reference src/CTPF.jl).

    Adds the recommender surface: user libraries (``libs``), ranked
    per-document user recommendations (``drecs``) and per-user document
    recommendations (``urecs``), with ``showlibs``/``showdrecs``/
    ``showurecs`` displays (reference CTPF.jl:62-79, 377-400;
    modelutils.jl:691-824).
    """

    _uses_readers = True
    _bucketed = True
    _per_doc_fields = ("gimel", "gimel_old", "zayin", "zayin_old")

    def _flops_per_step(self) -> float:
        """Base token-phi bound + the 2K-wide xi responsibilities over
        rating slots (~6 flops per slot-lane per pass, CTPF.jl:334-337)."""
        viter = self._cfg.viter if getattr(self, "_cfg", None) else 10
        r_slots = (0 if self.packed.readers is None
                   else int(np.asarray(self.packed.readers).size))
        return super()._flops_per_step() + float(
            viter * r_slots * 12 * self.K)

    def __init__(self, corp, K, runtime=None, mesh=None, seed: int = 0):
        super().__init__(corp, K, runtime=runtime, mesh=mesh, seed=seed)
        if self.corp is not None:
            self.R = [len(doc.readers) for doc in self.corp.docs]
            # user libraries (CTPF.jl:62-65), 1-based doc indices
            self.libs = [[] for _ in range(self.U)]
            for d, doc in enumerate(self.corp.docs, start=1):
                for u in doc.readers:
                    self.libs[u - 1].append(d)
        else:
            # PackedCorpus input: recover R/libs from the reader arrays
            # (0-based user ids, rows permuted through the packing)
            rows = self._doc_rows()
            p = self.packed
            self.R = p.R[rows].tolist()
            self.libs = [[] for _ in range(self.U)]
            if self.U > 0:
                for d, row in enumerate(rows, start=1):
                    for u in p.readers[row, : p.R[row]]:
                        self.libs[int(u)].append(d)
        # scores live on DEVICE ([M, U] is 100s of MB at scale; the
        # host here may be a single weak core), fetched to host lazily;
        # recs (unranked complements pre-train, score-ranked post-train,
        # CTPF.jl:67-79/389-400) are lazy per-row sequence views — the
        # reference materialises all M·U ranks eagerly (CTPF.jl:389-400)
        self._scores_dev = None
        self._scores_np = None
        self._lazy_scores = False
        self._urecs = None
        self._drecs = None
        self._ranked = False

    # past this many M·U elements the dense score matrix is never built
    # (not even on device): ranked rec rows come from O((M+U)·K) matvecs
    # against the factor state instead (the large-U regime, CTPF.jl:60)
    _SCORES_DENSE_MAX = 100_000_000

    @property
    def scores(self) -> np.ndarray:
        if self._scores_np is None:
            if self._scores_dev is not None:
                self._scores_np = np.asarray(self._scores_dev)
            elif self._lazy_scores:
                # explicit user ask for the full matrix: build it once,
                # dense, on device (the lazy mode only keeps the recs
                # machinery from doing this implicitly)
                s = ctpf_mod.scores(self.state)
                rows = jnp.asarray(self._doc_rows())
                self._scores_np = np.asarray(s[rows][:, : self.U])
            else:
                self._scores_np = np.zeros((self.M, self.U))
        return self._scores_np

    @scores.setter
    def scores(self, v):
        self._scores_np = np.asarray(v)
        self._scores_dev = None
        self._lazy_scores = False
        # externally assigned scores define the ranking
        self._ranked = bool(np.any(self._scores_np))
        self._urecs = None
        self._drecs = None

    def _score_slice(self, kind: str, i: int) -> np.ndarray:
        if self._scores_np is not None:
            return self._scores_np[i] if kind == "d" else self._scores_np[:, i]
        if self._scores_dev is not None:
            sl = self._scores_dev[i] if kind == "d" else self._scores_dev[:, i]
            return np.asarray(sl)
        if self._lazy_scores:
            return self._score_row_dev(kind, i)
        n = self.U if kind == "d" else self.M
        return np.zeros(n)

    def _score_row_dev(self, kind: str, i: int) -> np.ndarray:
        """One row of Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386) as an
        O((M+U)·K) device matvec — the dense [M, U] never exists."""
        st = self.state
        rows = self._doc_rows()
        if kind == "d":   # users scored for document i: [U]
            r = int(rows[i])
            v = st.gimel[r] / st.dalet + st.zayin[r] / st.het     # [K]
            return np.asarray((v @ (st.he / st.vav[:, None]))[: self.U])
        # documents scored for user i: [M], in doc order
        eeta_i = st.he[:, i] / st.vav                             # [K]
        s = (st.gimel / st.dalet[None, :]
             + st.zayin / st.het[None, :]) @ eeta_i               # [M_pad]
        return np.asarray(s)[rows]

    def _rec_row(self, kind: str, i: int) -> list:
        """Ranked recommendation row (0-based i), computed on demand."""
        if kind == "d":   # users for document i
            n = self.U
            if self.corp is not None:
                excl = np.asarray(self.corp.docs[i].readers, dtype=np.int64)
            else:   # PackedCorpus input: 0-based readers, packed rows
                p = self.packed
                row = int(p.inv_order[i]) if p.inv_order is not None else i
                excl = p.readers[row, : p.R[row]].astype(np.int64) + 1
        else:             # documents for user i
            n = self.M
            excl = np.asarray(self.libs[i], dtype=np.int64)
        if self._ranked and n:
            order = np.argsort(-self._score_slice(kind, i), kind="stable")
        else:
            order = np.arange(n, dtype=np.int64)
        mask = np.ones(n, dtype=bool)
        if excl.size:
            mask[excl - 1] = False
        return (order[mask[order]] + 1).tolist()

    @property
    def urecs(self):
        if self._urecs is None:
            self._urecs = _LazyRecs(self, "u", self.U)
        return self._urecs

    @urecs.setter
    def urecs(self, v):
        self._urecs = v

    @property
    def drecs(self):
        if self._drecs is None:
            self._drecs = _LazyRecs(self, "d", self.M)
        return self._drecs

    @drecs.setter
    def drecs(self, v):
        self._drecs = v

    def __repr__(self):
        return f"Collaborative topic Poisson factorization model with {self.K} topics."

    def _init_state(self):
        self.state = ctpf_mod.init(self.key, self.packed, self.K, self.dtype)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = ctpf_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol,
            chunk_docs=self.chunk_docs, axis_name=self.runtime.data_axis,
        )
        elbo_local = ctpf_mod.make_elbo(
            p, self.K, chunk_docs=self.chunk_docs, axis_name=self.runtime.data_axis
        )
        spec = ctpf_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=5, n_repl_args=0,
                      data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=5, out_spec=P(),
                      data_axis=self.runtime.data_axis)
        arrs = self._step_data()
        return Trainer(step, elbo, arrs, arrs, M=self.M, **self._trainer_kw(spec))

    def _step_data(self) -> tuple:
        p = self.packed
        if p.segments is not None:
            return (
                tuple(self._dev_data(s.terms) for s in p.segments),
                tuple(self._dev_data(s.counts) for s in p.segments),
                self._dev_data(p.readers), self._dev_data(p.ratings),
                tuple(self._dev_data(s.doc_mask) for s in p.segments),
            )
        return (self._dev_data(p.terms), self._dev_data(p.counts),
                self._dev_data(p.readers), self._dev_data(p.ratings),
                self._dev_data(p.doc_mask))

    def train(self, iter: int = 150, tol: float = 1.0, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True):
        """train! (CTPF.jl:344-376) — no niter/ntol (no Newton steps)."""
        return super().train(iter=iter, tol=tol, viter=viter, vtol=vtol,
                             checkelbo=checkelbo, printelbo=printelbo)

    def _topic_word_matrix(self) -> np.ndarray:
        # Ebeta = alef ./ bet (CTPF.jl:378)
        return np.asarray(self.state.alef) / np.asarray(self.state.bet)[:, None]

    def _finalize(self):
        super()._finalize()
        # scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386): one device
        # matmul, kept on device — [M, U] is 100s of MB at CiteULike
        # scale and the ranked recs only ever read a row at a time.
        # Past _SCORES_DENSE_MAX elements (the large-U regime) even the
        # device matrix is skipped: rec rows come from per-row matvecs.
        if self.M * self.U > self._SCORES_DENSE_MAX:
            self._scores_dev = None
            self._lazy_scores = True
        else:
            s = ctpf_mod.scores(self.state)
            rows = jnp.asarray(self._doc_rows())
            self._scores_dev = s[rows][:, : self.U]
            self._lazy_scores = False
        self._scores_np = None
        self._ranked = True
        self._urecs = None
        self._drecs = None

    # ── Hebrew-letter parameter accessors ──
    @property
    def alef(self) -> np.ndarray:
        return np.asarray(self.state.alef)

    @property
    def bet(self) -> np.ndarray:
        return np.asarray(self.state.bet)

    @property
    def gimel(self) -> np.ndarray:
        return np.asarray(self.state.gimel)[self._doc_rows()]

    @property
    def dalet(self) -> np.ndarray:
        return np.asarray(self.state.dalet)

    @property
    def he(self) -> np.ndarray:
        return np.asarray(self.state.he)[:, : self.U]

    @property
    def vav(self) -> np.ndarray:
        return np.asarray(self.state.vav)

    @property
    def zayin(self) -> np.ndarray:
        return np.asarray(self.state.zayin)[self._doc_rows()]

    @property
    def het(self) -> np.ndarray:
        return np.asarray(self.state.het)

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = np.asarray(self.state.gimel)[rows]
        return g / g.sum(axis=-1, keepdims=True)

    def warm_start_from(self, model: "TopicModel") -> "CTPF":
        """Seed alef from a trained LDA/CTM-family beta:
        ``ctpf.alef = exp(beta)`` (reference README.md:669-674)."""
        beta = np.asarray(model.beta)
        if beta.shape != (self.K, self.V):
            raise ValueError("warm-start model must share K and V.")
        import jax.numpy as _jnp

        alef = _jnp.asarray(np.exp(beta), self.dtype)
        self.state = self.state._replace(alef=alef, alef_old=alef)
        return self

    # ── recommender displays (modelutils.jl:691-824) ──
    def showlibs(self, users=None):
        from .utils.display import bullet, juliadots

        self._require_corp()
        if users is None:
            users = range(1, self.U + 1)
        if isinstance(users, int):
            users = [users]
        users = list(users)
        if not all(1 <= u <= self.U for u in users):
            raise ValueError("some user indices are outside range.")
        for n, u in enumerate(users):
            if not self.libs[u - 1]:
                continue
            juliadots(f"User {u}\n")
            name = self.corp.users.get(u, "")
            if name and not name.startswith("#user"):
                juliadots(f"{name}\n")
            for d in self.libs[u - 1]:
                title = self.corp.docs[d - 1].title or f"Document {d}"
                bullet(title)
            if n < len(users) - 1:
                print()

    def showdrecs(self, docs=None, U: int = 15):
        """Top U user recommendations per document (modelutils.jl:729-770)."""
        from .utils.display import juliadots

        self._require_corp()
        if U <= 0:
            raise ValueError("number of displayed users must be a positive integer.")
        if docs is None:
            docs = range(1, self.M + 1)
        if isinstance(docs, int):
            docs = [docs]
        docs = list(docs)
        if not all(1 <= d <= self.M for d in docs):
            raise ValueError("some document indices are outside range.")
        U = min(U, self.U)
        for n, d in enumerate(docs):
            row = self.drecs[d - 1]
            if not row:
                continue
            juliadots(f"Document {d}\n")
            if self.corp.docs[d - 1].title:
                juliadots(f"{self.corp.docs[d - 1].title}\n")
            for rank, u in enumerate(row[:U], start=1):
                print(f"{rank}. {self.corp.users.get(u, f'#user{u}')}")
            if n < len(docs) - 1:
                print()

    def showurecs(self, users=None, M: int = 15):
        """Top M document recommendations per user (modelutils.jl:777-821)."""
        from .utils.display import juliadots

        self._require_corp()
        if M <= 0:
            raise ValueError("number of displayed documents must be a positive integer.")
        if users is None:
            users = range(1, self.U + 1)
        if isinstance(users, int):
            users = [users]
        users = list(users)
        if not all(1 <= u <= self.U for u in users):
            raise ValueError("some user indices are outside range.")
        M = min(M, self.M)
        for n, u in enumerate(users):
            row = self.urecs[u - 1]
            if not row:
                continue
            juliadots(f"User {u}\n")
            name = self.corp.users.get(u, "")
            if name and not name.startswith("#user"):
                juliadots(f"{name}\n")
            for rank, d in enumerate(row[:M], start=1):
                title = self.corp.docs[d - 1].title or f"Document {d}"
                print(f"{rank}. {title}")
            if n < len(users) - 1:
                print()


# ───────────────────── inference on new documents (predict) ─────────────────────

def predict(corp, train_model: TopicModel, iter: int = 10,
            tol: Optional[float] = None, niter: int = 1000,
            ntol: Optional[float] = None) -> TopicModel:
    """E-step-only inference on a new corpus with frozen global parameters
    (reference modelutils.jl:831-944).

    Returns a new model of the same type whose per-document variational
    state is fit against the trained globals; call ``topicdist`` on it.
    Mirrors the reference's semantics — the per-doc fixpoint runs ``iter``
    times with ``tol`` as the convergence break — but fixes two reference
    bugs: the fLDA/fCTM variants reference an undefined ``vtol``
    (modelutils.jl:876,937), and they silently use a freshly-randomised
    kappa; here kappa/eta are carried over from the trained model.
    """
    corpuslib.check_corp(corp)
    if train_model.corp is not None:
        if corp.vocab != train_model.corp.vocab:
            raise CorpusError(
                "predict corpus and train_model corpus must have identical vocabularies."
            )
    elif len(corp.vocab) != train_model.V:   # PackedCorpus-built model
        raise CorpusError(
            "predict corpus vocabulary size must match the trained model's V."
        )
    if tol is not None and tol < 0:
        raise ValueError("tolerance parameter must be nonnegative.")
    if iter < 0:
        raise ValueError("iteration parameter must be nonnegative.")
    if isinstance(train_model, CTPF):
        raise TopicModelError("predict is not defined for CTPF models (as in the reference).")
    if isinstance(train_model, DTM):
        raise TopicModelError("predict is not defined for DTM models.")

    cls = type(train_model)
    new = cls(corp, train_model.K, runtime=train_model.runtime,
              mesh=train_model.mesh, seed=train_model.seed)
    ts = train_model.state

    # copy frozen globals into the fresh state
    if isinstance(train_model, LDA):
        new.state = new.state._replace(alpha=ts.alpha, beta=ts.beta, beta_old=ts.beta)
    elif isinstance(train_model, fLDA):
        new.state = new.state._replace(
            eta=ts.eta, alpha=ts.alpha, kappa=ts.kappa, kappa_old=ts.kappa,
            beta=ts.beta, beta_old=ts.beta,
        )
    elif isinstance(train_model, fCTM):
        new.state = new.state._replace(
            eta=ts.eta, mu=ts.mu, sigma=ts.sigma, invsigma=ts.invsigma,
            kappa=ts.kappa, kappa_old=ts.kappa, beta=ts.beta, beta_old=ts.beta,
        )
    elif isinstance(train_model, CTM):
        new.state = new.state._replace(
            mu=ts.mu, sigma=ts.sigma, invsigma=ts.invsigma,
            beta=ts.beta, beta_old=ts.beta,
        )
    elif isinstance(train_model, HMTM):
        new.state = new.state._replace(eta=ts.eta, alpha=ts.alpha, beta=ts.beta)
    else:
        raise TopicModelError(f"predict not implemented for {cls.__name__}")

    # one outer step with viter=iter/vtol=tol runs exactly the reference's
    # per-doc fixpoint; the trailing M-step output is discarded below.
    cfg = TrainConfig(iter=1, viter=iter, vtol=tol, niter=niter, ntol=ntol,
                      checkelbo=float("inf"), printelbo=False).resolved(train_model.K)
    # serve-path cache: the jitted step depends only on
    # the inference config and the packed SHAPE signature, so repeated
    # calls — batch serving, perplexity over the same held-out split —
    # reuse the compiled program with zero retracing/recompilation
    sig = (cfg.viter, cfg.vtol, cfg.niter, cfg.ntol, new._packed_sig())
    cache = train_model._infer_cache
    step_fn = cache.get(sig)
    if step_fn is None:
        step_fn = new._build_trainer(cfg).step_fn
        cache[sig] = step_fn
        while len(cache) > train_model._infer_cache_max:
            cache.popitem(last=False)            # evict least-recent
    else:
        cache.move_to_end(sig)
    frozen = new.state
    stepped = step_fn(frozen, *new._step_data())

    # keep per-doc fields from the step, restore every global from `frozen`
    new.state = frozen._replace(
        **{f: getattr(stepped, f) for f in cls._per_doc_fields})
    new.topics = train_model.topics
    return new


class DTM(TopicModel):
    """Dynamic topic model (reference v0.6/src/DTM.jl).

    Slices the corpus into T windows of width ``delta`` by document
    timestamp (``Document.stamp``); topic-word distributions evolve over
    slices via a variational Kalman smoother.  Warm-startable from any
    trained LDA/fLDA/CTM/fCTM (DTM.jl:66-93).
    """

    _per_doc_fields = ("gamma", "Elogtheta", "lzeta")

    def _ctor_kwargs(self) -> dict:
        return {"delta": self.delta}

    def __init__(self, corp, K, delta: float, basemodel=None,
                 runtime=None, mesh=None, seed: int = 0):
        if not isinstance(corp, Corpus):
            raise TopicModelError(
                "DTM requires a Corpus with per-document stamps; "
                "PackedCorpus input is not supported.")
        if not (np.isfinite(delta) and delta > 0):
            raise ValueError("delta must be a positive finite number.")
        stamps = [doc.stamp for doc in corp.docs]
        if any(s is None or not np.isfinite(s) for s in stamps):
            raise CorpusError("every document must carry a finite stamp.")
        self.delta = float(delta)
        self._basemodel = basemodel
        super().__init__(corp, K, runtime=runtime, mesh=mesh, seed=seed)

    def __repr__(self):
        return (f"Dynamic topic model with {self.K} topics and "
                f"{self.T} time slices.")

    def _flops_per_step(self) -> float:
        """Base token bound + the [T,K,V] Kalman smoother (~20 flops per
        element forward+backward) and the betahat CG (~10 per element per
        CG iteration via the autodiff gradient) — both deterministic
        per outer iteration (DTM.jl:209-305)."""
        cg = getattr(self, "_cgiter", 20)
        smoother = (20 + 10 * cg) * self.T * self.K * self.V
        return super()._flops_per_step() + float(smoother)

    def _init_state(self):
        stamps = np.array([doc.stamp for doc in self.corp.docs], dtype=np.float64)
        t0, tM = float(stamps.min()), float(stamps.max())
        self.T = max(1, int(math.ceil((tM - t0) / self.delta)))
        # slice assignment (DTM.jl:58-63): docs with stamp ≤ t0 + t·delta
        # land in slice t (1-based there; 0-based here)
        sid = np.clip(np.ceil((stamps - t0) / self.delta).astype(np.int64),
                      1, self.T) - 1
        slice_full = np.zeros(self.packed.M_pad, dtype=np.int32)
        slice_full[: self.M] = sid
        self.slice_id = slice_full
        self.S = [list(np.nonzero(sid == t)[0] + 1) for t in range(self.T)]

        bh0 = a0 = g0 = None
        base = self._basemodel
        if base is not None:  # warm start (DTM.jl:66-93)
            if base.K != self.K or base.M != self.M:
                raise TopicModelError(
                    "basemodel must have matching number of topics and documents.")
            rng = np.random.default_rng(self.seed)
            if isinstance(base, (LDA, fLDA)):
                logb = np.log(np.asarray(base.beta) + 1e-30)
                a0 = np.tile(np.asarray(base.alpha), (self.T, 1))
                g0 = np.zeros((self.packed.M_pad, self.K), np.float64)
                g0[: self.M] = np.asarray(base.gamma)
                g0[self.M:] = 1.0
            elif isinstance(base, (CTM, fCTM)):
                logb = np.log(np.asarray(base.beta) + 1e-30)
                sm = np.exp(np.asarray(base.mu) - np.max(np.asarray(base.mu)))
                a0 = np.tile(sm / sm.sum(), (self.T, 1))
                lam = np.asarray(base.lam)
                e = np.exp(lam - lam.max(axis=1, keepdims=True))
                g0 = np.ones((self.packed.M_pad, self.K), np.float64)
                g0[: self.M] = e / e.sum(axis=1, keepdims=True)
            else:
                raise TopicModelError(
                    "basemodel must be an LDA, fLDA, CTM or fCTM model.")
            bh0 = (logb[None, :, :]
                   + rng.standard_normal((self.T, self.K, self.V)))
        self.state = dtm_mod.init(self.key, self.packed, self.K, self.T,
                                  self.dtype, betahat0=bh0, alpha0=a0,
                                  gamma0=g0)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step_local = dtm_mod.make_step(
            p, self.K, self.T, viter=cfg.viter, vtol=cfg.vtol,
            niter=cfg.niter, ntol=cfg.ntol,
            cgiter=self._cgiter, cgtol=self._cgtol,
            chunk_docs=self.chunk_docs, axis_name=self.runtime.data_axis)
        elbo_local = dtm_mod.make_elbo(
            p, self.K, self.T, chunk_docs=self.chunk_docs,
            axis_name=self.runtime.data_axis)
        spec = dtm_mod.partition_spec(self.runtime.data_axis)
        from jax.sharding import PartitionSpec as P

        step = dp_jit(step_local, self.mesh, spec, n_data_args=4,
                      data_axis=self.runtime.data_axis)
        elbo = dp_jit(elbo_local, self.mesh, spec, n_data_args=4,
                      out_spec=P(), data_axis=self.runtime.data_axis)
        arrs = (self._dev_data(self.slice_id), self._dev_data(p.terms),
                self._dev_data(p.counts), self._dev_data(p.doc_mask))
        return Trainer(step, elbo, arrs, arrs, M=self.M, **self._trainer_kw(spec))

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10,
              vtol: Optional[float] = None, cgiter: int = 20,
              cgtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True):
        """train! (DTM.jl:311-335) — adds cgiter/cgtol for the betahat CG."""
        if cgiter <= 0:
            raise ValueError("iteration parameters must be positive integers.")
        self._cgiter = int(cgiter)
        self._cgtol = float(cgtol) if cgtol is not None else 1.0 / self.T**2
        return super().train(iter=iter, tol=tol, niter=niter, ntol=ntol,
                             viter=viter, vtol=vtol, checkelbo=checkelbo,
                             printelbo=printelbo)

    def _finalize(self):
        # per-slice topic rankings (DTM.jl:336)
        self.topics = dtm_mod.topics_ranking_by_slice(self.state.mbeta)

    def _topic_word_matrix(self) -> np.ndarray:
        return np.asarray(self.state.mbeta).mean(axis=0)

    @property
    def alpha(self) -> np.ndarray:
        return np.asarray(self.state.alpha)

    @property
    def mbeta(self) -> np.ndarray:
        return np.asarray(self.state.mbeta)

    @property
    def vbeta(self) -> np.ndarray:
        return np.asarray(self.state.vbeta)

    @property
    def betahat(self) -> np.ndarray:
        return np.asarray(self.state.betahat)

    @property
    def gamma(self) -> np.ndarray:
        return np.asarray(self.state.gamma)[: self.M]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = np.asarray(self.state.gamma)[rows]
        return g / g.sum(axis=-1, keepdims=True)

    def showtopics(self, V: int = 15, topics=None, cols: int = 4,
                   slices=None):
        """Aligned top-terms per time slice (v0.6 display idiom)."""
        if slices is None:
            slices = range(1, self.T + 1)
        if isinstance(slices, int):
            slices = [slices]
        rank_all = self.topics if self.topics is not None else             dtm_mod.topics_ranking_by_slice(self.state.mbeta)
        for t in slices:
            if not 1 <= t <= self.T:
                raise ValueError("some time-slice indices are outside range.")
            print(f"─ time slice {t} ─")
            saved, self.topics = self.topics, rank_all[t - 1]
            try:
                super().showtopics(V=V, topics=topics, cols=cols)
            finally:
                self.topics = saved


# ───────────────── generative sampling (gendoc / gencorp) ─────────────────

def gendoc(model: TopicModel, laplace_smooth: float = 0.0, rng=None):
    """Sample an artificial document from the fitted generative model
    (reference modelutils.jl:594-633).

    Token-level (z then w) sampling marginalises to a single multinomial
    over the smoothed mixture theta·beta, which is what we draw.  The
    reference's CTM variant contains a latent NameError (``topicdist``
    vs ``topic_dist``, modelutils.jl:626); this implementation is the
    corrected form.
    """
    from .corpus import Document

    if laplace_smooth < 0:
        raise ValueError("laplace_smooth parameter must be nonnegative.")
    if model.M == 0:
        raise TopicModelError("gendoc requires a model trained on a nonempty corpus.")
    rng = np.random.default_rng() if rng is None else rng

    if isinstance(model, (LDA, fLDA)):
        alpha = np.asarray(model.alpha, np.float64)
        theta = rng.dirichlet(alpha)
    elif isinstance(model, (CTM, fCTM)):
        x = rng.multivariate_normal(np.asarray(model.mu, np.float64),
                                    np.asarray(model.sigma, np.float64))
        e = np.exp(x - x.max())
        theta = e / e.sum()
    elif isinstance(model, HMTM):
        # HMTM documents are ordered token sequences: sample the chain
        # (pi, per-doc transition theta, z_1..z_N) and emit tokens in
        # order — terms may repeat, counts are all 1 (HMTM.jl:18-39)
        from .corpus import Document

        eta = np.asarray(model.eta, np.float64)
        alpha = np.asarray(model.alpha, np.float64)
        K = model.K
        pi_d = rng.dirichlet(eta)
        theta_d = np.stack([rng.dirichlet(alpha[:, l]) for l in range(K)],
                           axis=1)                      # [K, K] columns
        beta = np.asarray(model.beta, np.float64)
        V = beta.shape[1]
        beta_s = (beta + laplace_smooth) / (1.0 + laplace_smooth * V)
        beta_s = beta_s / beta_s.sum(axis=1, keepdims=True)
        N = rng.poisson(np.mean(model.N))
        terms, z = [], 0
        for n in range(N):
            p = pi_d if n == 0 else theta_d[:, z]
            z = rng.choice(K, p=p)
            terms.append(int(rng.choice(V, p=beta_s[z])) + 1)
        return Document(terms=terms, counts=[1] * len(terms))
    else:
        raise TopicModelError(
            f"gendoc is not defined for {type(model).__name__} models.")

    C = rng.poisson(np.mean(model.C))
    beta = np.asarray(model.beta, np.float64)
    V = beta.shape[1]
    beta_s = (beta + laplace_smooth) / (1.0 + laplace_smooth * V)
    beta_s = beta_s / beta_s.sum(axis=1, keepdims=True)
    mix = theta @ beta_s
    mix = mix / mix.sum()
    counts = rng.multinomial(C, mix)
    nz = np.nonzero(counts)[0]
    return Document(terms=(nz + 1).tolist(), counts=counts[nz].tolist())


def gencorp(model: TopicModel, M: int, laplace_smooth: float = 0.0,
            seed: Optional[int] = None) -> Corpus:
    """Sample an artificial corpus (reference modelutils.jl:642-649)."""
    if M <= 0:
        raise ValueError("corp_size parameter must be a positive integer.")
    if laplace_smooth < 0:
        raise ValueError("laplace_smooth parameter must be nonnegative.")
    rng = np.random.default_rng(seed)
    docs = [gendoc(model, laplace_smooth, rng) for _ in range(M)]
    if model.corp is not None:
        vocab, users = dict(model.corp.vocab), dict(model.corp.users)
    else:  # PackedCorpus-built model: placeholder names
        vocab = {j + 1: f"#term{j + 1}" for j in range(model.V)}
        users = {u + 1: f"#user{u + 1}" for u in range(model.U)}
    return Corpus(docs=docs, vocab=vocab, users=users)
