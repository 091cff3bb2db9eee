"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh — the standard JAX substitute
for multi-device hardware (SURVEY §4e): sharding semantics (psum
topology, shard-equivalence) are the accelerator's, while kernel
codegen and the scatter's summation order differ (bitwise determinism
holds on the CPU only; see ops/segment.py).  float64 is enabled so the
NumPy oracle comparisons can run at the reference CPU models' precision
(LDA.jl uses f64; gpuLDA f32).  ``TMVB_TEST_PLATFORM=gpu`` runs the
``chip``-marked tests on a card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the platform is set through jax.config so that it holds whatever
# JAX_PLATFORMS the environment carries
jax.config.update("jax_platforms", os.environ.get("TMVB_TEST_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(7)


@pytest.fixture()
def tiny_corpus():
    from topicmodelsvb_jl_tpu.datasets import synth_corpus

    return synth_corpus(M=30, V=40, K=3, seed=11, mean_tokens=25, mean_terms=12)


@pytest.fixture()
def reader_corpus():
    from topicmodelsvb_jl_tpu.datasets import synth_corpus

    return synth_corpus(M=24, V=30, K=3, U=12, seed=5, mean_tokens=20,
                        mean_terms=10, mean_readers=3)


@pytest.fixture()
def ordered_corpus(tiny_corpus):
    """Order-preserving twin of tiny_corpus for HMTM: one entry per
    token (all counts 1) — HMTM rejects condensed corpora loudly."""
    from topicmodelsvb_jl_tpu import Corpus, Document, expand_corp

    docs = [Document(terms=list(d.terms), counts=list(d.counts),
                     title=d.title) for d in tiny_corpus.docs]
    corp = Corpus(docs=docs, vocab=dict(tiny_corpus.vocab),
                  users=dict(tiny_corpus.users))
    expand_corp(corp)
    return corp


@pytest.fixture()
def gpu():
    """The first GPU, or a skip: tests marked ``chip`` need the card.
    Decided here, at run time, never while a module is imported."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with TMVB_TEST_PLATFORM=gpu "
                    "on the card)")
    return devs[0]
