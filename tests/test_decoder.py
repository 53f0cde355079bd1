"""Beam-search decoder integration: genuinely evolving masks through the
lazy API (VERDICT r1 next-step #3 — the README roadmap's "ASR decoder
integration driving real masks")."""

import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.decoder import BeamDecoder, Lexicon, random_lexicon
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.quant.quantize import quantize_net


@pytest.fixture(scope="module")
def scorer(small_net):
    return Scorer(quantize_net(small_net), EngineConfig(backend="xla"))


@pytest.fixture(scope="module")
def decoder(scorer):
    lex = random_lexicon(np.random.default_rng(3), 30, scorer.output_dim)
    return BeamDecoder(lex, scorer.output_dim, beam_width=32, word_exit_beam=4)


@pytest.fixture(scope="module")
def frames(features_16khz):
    return np.asarray(features_16khz[:60], np.float32)


class TestBeamDecoder:
    def test_lazy_decode_matches_dense(self, scorer, decoder, frames):
        """The whole point: decoding over beam-driven lazy masks must find
        the same word sequence as decoding over full posteriors (per-frame
        softmax denominators shift all paths equally — decoder.py docstring)."""
        dense = decoder.decode_dense(scorer, frames)
        lazy = decoder.decode_lazy(scorer, frames)
        assert lazy.words == dense.words
        # and the two searches walked identical beams -> identical masks
        np.testing.assert_array_equal(lazy.masks, dense.masks)

    def test_rescore_matches(self, scorer, decoder, frames):
        lazy = decoder.decode_lazy(scorer, frames)
        rescore = decoder.decode_rescore(scorer, frames, lazy.masks)
        assert rescore.words == lazy.words

    def test_masks_are_genuinely_evolving(self, scorer, decoder, frames):
        """Not the reference FuncTest's random churn: the active sets come
        from live beam dynamics — sparse, nonempty, and changing."""
        res = decoder.decode_lazy(scorer, frames)
        per_frame = res.masks.sum(axis=1)
        assert (per_frame > 0).all()
        assert 0.0 < res.avg_density < 0.6  # sparse (reference: 30-50% typical)
        assert res.avg_churn > 0.0  # the beam actually moves
        assert res.masks.shape == (frames.shape[0], scorer.output_dim)
        # consecutive masks differ on a meaningful share of frames
        # (evolution, not a static set; the beam legitimately settles on
        # steady stretches, so this is not ~1.0)
        diffs = np.abs(np.diff(res.masks.astype(np.int8), axis=0)).sum(axis=1)
        assert (diffs > 0).mean() > 0.1

    def test_active_only_semantics_same_words(self, small_net, decoder, frames):
        """The documented divergence option changes posteriors, not the
        within-frame ordering the search consumes."""
        sc = Scorer(
            quantize_net(small_net),
            EngineConfig(backend="xla", lazy_semantics="active_only"),
        )
        dense = decoder.decode_dense(sc, frames)
        lazy = decoder.decode_lazy(sc, frames)
        assert lazy.words == dense.words

    def test_pallas_backend_same_words(self, small_net, decoder, frames):
        sc = Scorer(
            quantize_net(small_net), EngineConfig(backend="pallas", interpret=True)
        )
        lazy = decoder.decode_lazy(sc, frames[:12])
        dense = decoder.decode_dense(sc, frames[:12])
        assert lazy.words == dense.words

    def test_lexicon_validation(self):
        with pytest.raises(ValueError):
            BeamDecoder(Lexicon(((1, 2, 999),)), 400)
