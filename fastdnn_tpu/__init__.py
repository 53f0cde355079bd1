"""fastdnn_tpu — an acoustic-scoring engine in JAX for NVIDIA GPUs.

From-scratch JAX/XLA/Pallas framework with the capabilities of
ahmetaa/fast-dnn (see SURVEY.md): Kaldi nnet1 feed-forward acoustic models,
int8 linear quantization (signed weights x unsigned sigmoid activations),
lazy (masked) output scoring, and data/model-parallel scaling over device
meshes.

Quick start::

    import fastdnn_tpu as fd

    net = fd.load_model("model.bin")            # reference binary format
    qnet = fd.quantize_net(net, cutoff=3.0)     # int8, transform fused
    scorer = fd.Scorer(qnet)
    posteriors = scorer.score(frames)           # [n, senones]
    lazy = scorer.score_masked(frames, masks)   # masked senone scoring

    ss = fd.StreamingScorer(scorer)             # cross-utterance batching
    fut = ss.submit(frames)                     # from any thread
"""

from .config import EngineConfig
from .decoder import BeamDecoder, Lexicon, random_lexicon
from .engine.scorer import LazyContext, Scorer, score_fn, score_masked_fn
from .engine.stream import StreamingScorer
from .formats import binary as formats_binary
from .formats import kaldi_text
from .formats.binary import RawNetwork, read_features, read_model, write_features, write_model
from .models import feedforward as models_feedforward
from .models.feedforward import (
    FeedForwardNet,
    align,
    apply_transform,
    extend,
    forward,
    from_raw,
    fuse_transform,
    random_net,
    to_raw,
)
from .quant.quantize import (
    QuantizedNet,
    pack_int4_trunk,
    pad_qnet,
    quantize_layer,
    quantize_net,
)
from .quant.serialize import load_qnet, save_qnet
from .utils.synthetic import features as synthetic_features

__version__ = "0.1.0"


def load_model(path) -> FeedForwardNet:
    """Load a reference-format binary model into a float pytree."""
    return from_raw(read_model(path))


def load_model_text(network_path, transform_path) -> FeedForwardNet:
    """Load a Kaldi nnet1 text model + feature-transform file."""
    return from_raw(kaldi_text.load_network_text(network_path, transform_path))


__all__ = [
    "BeamDecoder",
    "EngineConfig",
    "FeedForwardNet",
    "LazyContext",
    "Lexicon",
    "StreamingScorer",
    "random_lexicon",
    "QuantizedNet",
    "RawNetwork",
    "Scorer",
    "align",
    "apply_transform",
    "extend",
    "forward",
    "from_raw",
    "fuse_transform",
    "kaldi_text",
    "load_model",
    "load_model_text",
    "load_qnet",
    "pack_int4_trunk",
    "pad_qnet",
    "save_qnet",
    "synthetic_features",
    "quantize_layer",
    "quantize_net",
    "random_net",
    "read_features",
    "read_model",
    "score_fn",
    "score_masked_fn",
    "to_raw",
    "write_features",
    "write_model",
]
