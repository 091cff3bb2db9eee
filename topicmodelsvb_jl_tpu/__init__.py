"""topicmodelsvb_jl_tpu — variational-Bayes topic modeling on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ericproffitt/TopicModelsVB.jl: LDA, filtered LDA, correlated topic
model, filtered CTM, and collaborative topic Poisson factorization,
trained by coordinate-ascent variational inference with
batch-synchronous E-steps, deterministic segment-sum sufficient
statistics, and data-parallel sharding over a device mesh.
"""

from .corpus import (
    Corpus, CorpusError, Document, DocumentError,
    abridge_corp, alphabetize_corp, check_corp, check_doc, check_docs,
    compact_corp, condense_corp, expand_corp, fixcorp, getusers, getvocab,
    pad_corp,
    readcorp, remove_empty_docs, remove_redundant, remove_terms,
    showdocs, showtitles, stop_corp, trim_corp, trim_docs, writecorp,
)
from .datasets import (
    load_citeu, load_mac, load_nsf, load_stopwords, synth_corpus,
)
from .utils.config import RuntimeConfig, TrainConfig

from .api import (
    CTM, CTPF, DTM, HMTM, LDA, TopicModel, TopicModelError, fCTM, fLDA,
    gencorp, gendoc, predict,
)
from .evaluate import (
    heldout_reader_rank, holdout_readers, perplexity, ranked_users,
    recall_at_k,
    topic_coherence,
)
from .ops.packing import load_packed, route_packed, save_packed, trim_packed
from .streaming import (
    StreamingCTM, StreamingCTPF, StreamingDTM, StreamingFCTM, StreamingFLDA,
    StreamingHMTM, StreamingLDA, slices_from_stamps,
)
from .streaming import load as load_streaming_checkpoint
from .checkpoint import load as load_checkpoint
from .checkpoint import save as save_checkpoint
from .validate import check_model

__version__ = "0.3.0"

__all__ = [
    "Corpus", "Document", "CorpusError", "DocumentError", "TopicModelError",
    "readcorp", "writecorp", "fixcorp", "check_corp", "check_doc",
    "showdocs", "showtitles", "getvocab", "getusers",
    "load_nsf", "load_citeu", "load_stopwords", "synth_corpus",
    "LDA", "fLDA", "CTM", "fCTM", "CTPF", "DTM", "HMTM", "TopicModel",
    "predict", "gendoc", "gencorp", "save_checkpoint", "load_checkpoint",
    "StreamingLDA", "StreamingFLDA", "StreamingCTM", "StreamingFCTM",
    "StreamingCTPF", "StreamingHMTM", "StreamingDTM", "slices_from_stamps",
    "load_streaming_checkpoint", "save_packed", "load_packed",
    "trim_packed", "route_packed",
    "perplexity", "topic_coherence", "holdout_readers",
    "heldout_reader_rank", "ranked_users", "recall_at_k",
    "check_model",
    "TrainConfig", "RuntimeConfig",
]
