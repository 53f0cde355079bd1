"""End-to-end pipeline: every stage a reference user would migrate.

    Kaldi artifacts -> parse -> align -> binary model -> quantize ->
    checkpoint -> score (full + lazy) -> serve over TCP -> client

Uses a synthetic Kaldi-text network (the real trained net the reference's
FuncTest converts is not redistributable) and seeded stand-in features.

    python examples/pipeline.py [--backend auto]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import tempfile
import threading
from pathlib import Path

import numpy as np


def synth_kaldi_text(rng, in_dim, hidden, out_dim):
    """A tiny nnet1-format text network + feature transform."""
    def mat(r, c):
        return "\n".join(" ".join(f"{v:.6f}" for v in row) for row in rng.standard_normal((r, c)) * 0.1)

    parts, prev = [], in_dim
    for width in hidden + [out_dim]:
        parts.append(f"<AffineTransform> {width} {prev}")
        parts.append(mat(width, prev))
        parts.append(" ".join(f"{v:.6f}" for v in rng.standard_normal(width) * 0.1))
        parts.append("<Sigmoid>" if width != out_dim else "<Softmax>")
        prev = width
    net_text = "\n".join(parts) + "\n"
    shift = " ".join(f"{v:.6f}" for v in rng.standard_normal(in_dim))
    scale = " ".join(f"{v:.6f}" for v in rng.uniform(0.5, 1.5, in_dim))
    transform = f"[ {shift} ]\n[ {scale} ]\n"
    return net_text, transform


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", default="auto")
    args = p.parse_args()

    import fastdnn_tpu as fd
    from fastdnn_tpu.cli.serve import ScoreClient, ScoreServer
    from fastdnn_tpu.config import EngineConfig

    from fastdnn_tpu.engine.stream import StreamingScorer
    from fastdnn_tpu.formats.kaldi_text import load_network_text

    tmp = Path(tempfile.mkdtemp(prefix="fastdnn_demo_"))
    rng = np.random.default_rng(0)

    # 1. Kaldi text -> parsed network (parser + transform, SURVEY.md §2 #18)
    net_text, transform = synth_kaldi_text(rng, 429, [256, 256], 1000)
    (tmp / "nnet.txt").write_text(net_text)
    (tmp / "final.feature_transform").write_text(transform)
    raw = load_network_text(tmp / "nnet.txt", tmp / "final.feature_transform")
    print(f"1. parsed Kaldi text: {raw.topology()}")

    # 2. align (SSE-era surgery still valid) + binary model round trip
    net = fd.align(fd.from_raw(raw), 4, 16)
    fd.write_model(fd.to_raw(net), tmp / "model.bin")
    net = fd.from_raw(fd.read_model(tmp / "model.bin"))
    print(f"2. aligned + binary round trip: input {net.input_dim}")

    # 3. quantize (transform fused) + durable checkpoint
    qnet = fd.quantize_net(net, cutoff=3.0)
    fd.save_qnet(qnet, tmp / "model.qnet.npz")
    qnet = fd.load_qnet(tmp / "model.qnet.npz")
    print("3. int8 checkpoint round trip")

    # 4. score the features, full + lazy
    scorer = fd.Scorer(qnet, EngineConfig(backend=args.backend))
    frames = fd.synthetic_features(389)
    post = scorer.score(frames)
    masks = (rng.random((len(frames), scorer.output_dim)) < 0.4).astype(np.uint8)
    lazy = scorer.score_masked(frames, masks)
    print(f"4. scored {post.shape}; lazy rowsum [{lazy.sum(1).min():.5f}, {lazy.sum(1).max():.5f}]")

    # 5. serve it: streaming engine + TCP protocol + concurrent client
    server = ScoreServer(("127.0.0.1", 0), StreamingScorer(scorer, max_wait_ms=2.0))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    client = ScoreClient(*server.server_address[:2])
    via_wire = client.score(frames[:32])
    print(f"5. served over TCP: max |direct - wire| = {np.abs(via_wire - post[:32]).max():.2e}")
    print(f"   server stats: {client.stats()}")
    client.close()
    server.shutdown()
    server.stream.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
