"""End-to-end ASR-style decoding demo: a real beam search driving lazy masks.

Builds a synthetic word lexicon (left-to-right senone chains), then decodes
seeded stand-in features (389 x 432, utils.synthetic) three ways through
one quantized engine:

  1. dense    — full posteriors every frame (the oracle);
  2. lazy     — frame-synchronous LazyContext scoring ONLY the senones the
                live beam can consume (the reference's lazy API shape,
                /root/reference/src/java/suskun/nn/QuantizedDnn.java:72-107);
  3. rescore  — the recorded mask trajectory scored in ONE device call
                (Scorer.score_masked), the batched consumption shape.

All three must produce the same word sequence; the printout shows the real
mask statistics the beam produced (density ~ the 30-50% the reference
documents for production decoders, README.md:31-33).

    python examples/beam_decoder.py [--backend auto] [--beam 64]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", default="auto")
    p.add_argument("--beam", type=int, default=64)
    p.add_argument("--words", type=int, default=50)
    args = p.parse_args()

    import jax

    import fastdnn_tpu as fd
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.decoder import BeamDecoder, random_lexicon
    from fastdnn_tpu.utils.synthetic import features

    frames = features(389)
    net = fd.align(fd.random_net(jax.random.PRNGKey(0), 429, [512] * 3, 1000), 4, 16)
    qnet = fd.quantize_net(net)
    scorer = fd.Scorer(qnet, EngineConfig(backend=args.backend))

    # Build a lexicon the acoustics can actually traverse: chunk the dense
    # argmax senone track into "true" words, then add random distractors.
    # The search then has real signal to follow and the beam genuinely
    # churns at word boundaries (a random-only lexicon leaves Viterbi with
    # near-uniform scores and a frozen beam).
    rng = np.random.default_rng(11)
    track = scorer.score(frames).argmax(1)
    dedup = track[np.insert(np.diff(track) != 0, 0, True)]
    true_words = [
        tuple(int(s) for s in dedup[i : i + 4])
        for i in range(0, len(dedup) - 3, 4)
    ][:20]
    from fastdnn_tpu.decoder import Lexicon

    distract = random_lexicon(rng, max(args.words - len(true_words), 1), scorer.output_dim)
    lex = Lexicon(tuple(true_words) + distract.words)
    dec = BeamDecoder(lex, scorer.output_dim, beam_width=args.beam)

    t0 = time.perf_counter()
    dense = dec.decode_dense(scorer, frames)
    t_dense = time.perf_counter() - t0

    t0 = time.perf_counter()
    lazy = dec.decode_lazy(scorer, frames)
    t_lazy = time.perf_counter() - t0

    t0 = time.perf_counter()
    rescore = dec.decode_rescore(scorer, frames, lazy.masks)
    t_rescore = time.perf_counter() - t0

    print(f"frames: {frames.shape[0]}, lexicon: {args.words} words, beam {args.beam}")
    print(f"dense   decode: {len(dense.words):3d} words, {t_dense*1e3:7.1f} ms")
    print(f"lazy    decode: {len(lazy.words):3d} words, {t_lazy*1e3:7.1f} ms "
          f"(LazyContext, one device call per frame)")
    print(f"rescore decode: {len(rescore.words):3d} words, {t_rescore*1e3:7.1f} ms "
          f"(whole mask matrix, one device call)")
    print(f"mask stats from the LIVE BEAM: density {lazy.avg_density:.3f}, "
          f"churn {lazy.avg_churn * scorer.output_dim:.1f} senone flips/frame")
    agree = dense.words == lazy.words == rescore.words
    print(f"word sequences agree: {agree}")
    return 0 if agree else 1


if __name__ == "__main__":
    raise SystemExit(main())
