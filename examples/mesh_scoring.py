"""Multi-chip scoring with the unified engine: same API, one extra argument.

Runs on whatever devices exist — a real multi-chip slice, or a forced
virtual CPU mesh for trying it out anywhere:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/mesh_scoring.py [--model MODEL.bin] [--tp 2]

Frames are data-parallel, the senone axis is tensor-parallel, posteriors
equal the single-device engine (asserted below).  See docs/scaling.md for
the collective design.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None, help="binary model (default: random 3x512/2000)")
    p.add_argument("--tp", type=int, default=2, help="tensor-parallel size (senone axis)")
    p.add_argument("--backend", default="auto")
    args = p.parse_args()

    import jax

    

    import fastdnn_tpu as fd
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    if n_dev % args.tp:
        raise SystemExit(f"{n_dev} devices not divisible by tp={args.tp}")

    if args.model:
        net = fd.from_raw(fd.read_model(args.model))
    else:
        net = fd.align(fd.random_net(jax.random.PRNGKey(0), 429, [512] * 3, 2000), 4, 16)
    qnet = fd.quantize_net(net, cutoff=3.0)
    frames = fd.synthetic_features(389)

    single = fd.Scorer(qnet, EngineConfig(backend=args.backend))
    ref = single.score(frames)

    mesh = make_mesh(model=args.tp)
    sc = fd.Scorer(qnet, EngineConfig(backend=args.backend), mesh=mesh)
    post = sc.score(frames)

    print(f"devices: {n_dev}, mesh: data={mesh.shape['data']} x model={mesh.shape['model']}")
    print(f"posteriors {post.shape}, rowsum [{post.sum(1).min():.5f}, {post.sum(1).max():.5f}]")
    print(f"max |mesh - single-device| = {np.abs(post - ref).max():.2e}")

    # the lazy path shards identically
    rng = np.random.default_rng(1)
    masks = (rng.random((len(frames), sc.output_dim)) < 0.4).astype(np.uint8)
    pm = sc.score_masked(frames, masks)
    print(f"masked   max |mesh - single-device| = "
          f"{np.abs(pm - single.score_masked(frames, masks)).max():.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
