"""Scorer CLI — the reference CLI's shape (/root/reference/src/cpp/dnn.cc:20-84):

    python -m fastdnn_tpu.cli.score MODEL INPUT [OUT] [BIN|TXT] [--cutoff F]
        [--backend auto|xla|pallas] [--mask-density F] [--iterations N]

Loads a reference-format binary model and binary feature matrix, quantizes,
scores (optionally with synthetic lazy masks), prints topology + timing, and
dumps posteriors to stdout or a file in BIN or TXT format like
BatchData::dumpToFile (/root/reference/src/cpp/float_dnn.cc:128-164).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..config import EngineConfig
from ..engine.scorer import Scorer
from ..formats.binary import read_features, write_features, write_features_text


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastdnn-score", description="Score acoustic features with a quantized DNN"
    )
    p.add_argument(
        "model",
        help="reference-format binary model, or a .npz int8 checkpoint "
        "(save_qnet / `fastdnn-convert quantize`) that skips the "
        "quantization pass",
    )
    p.add_argument("input", help="feature file: binary matrix, or Kaldi text with --text-input")
    p.add_argument("out", nargs="?", default=None, help="output file (default: stdout)")
    p.add_argument(
        "out_type", nargs="?", default="TXT", choices=["BIN", "TXT"], help="output format"
    )
    p.add_argument("--cutoff", type=float, default=3.0, help="weight quantization cutoff")
    p.add_argument(
        "--hidden-bits", type=int, default=None, choices=[8, 4],
        help="hidden-trunk weight width: 4 halves weight bytes (output "
        "layer stays int8); see docs/architecture.md 'int4 hidden trunk'",
    )
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument(
        "--mesh-model",
        type=int,
        default=0,
        help="tensor-parallel size for the senone axis (0 = single device); "
        "frames go data-parallel over the remaining devices",
    )
    p.add_argument(
        "--mesh-data",
        type=int,
        default=None,
        help="data-parallel size (default: all devices not used by --mesh-model)",
    )
    p.add_argument(
        "--mask-density",
        type=float,
        default=None,
        help="if set, score lazily with synthetic evolving masks at this active density",
    )
    p.add_argument(
        "--lazy-mode",
        default="auto",
        choices=["auto", "dense", "gathered"],
        help="masked-scoring strategy (config.EngineConfig.lazy_mode)",
    )
    p.add_argument("--iterations", type=int, default=1, help="repeat scoring (timing)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument(
        "--text-input",
        action="store_true",
        help="input is a Kaldi text feature file; every utterance is scored "
        "in one device pass and the output keeps utterance ids (text format)",
    )
    return p


def generate_masks(rng, count, dim, density, churn_frac=0.03):
    """Evolving decoder-style masks (FuncTest.generateMasks,
    /root/reference/test/java/suskun/nn/FuncTest.java:121-154)."""
    active = max(1, int(dim * density))
    churn = max(1, int(dim * churn_frac))
    masks = np.zeros((count, dim), dtype=np.uint8)
    masks[0, rng.choice(dim, size=active, replace=False)] = 1
    for i in range(1, count):
        masks[i] = masks[i - 1]
        off = np.flatnonzero(masks[i] == 0)
        on = np.flatnonzero(masks[i] == 1)
        if off.size:
            masks[i, rng.choice(off, size=min(churn, off.size), replace=False)] = 1
        if on.size > churn:
            masks[i, rng.choice(on, size=churn, replace=False)] = 0
    return masks


def main(argv=None) -> int:
    from ..config import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)

    if args.text_input and (args.mask_density is not None or args.iterations != 1):
        raise ValueError(
            "--text-input scores all utterances in one pass and does not "
            "combine with --mask-density or --iterations"
        )
    from ..quant.serialize import load_quantized

    qnet, topology = load_quantized(
        args.model, cutoff=args.cutoff, hidden_bits=args.hidden_bits
    )
    print(f"Model File  = {args.model}")
    print(f"Network     = {topology}")
    utts = None
    if args.text_input:
        from ..formats.kaldi_text import load_features_text

        utts = load_features_text(args.input)
        n = sum(m.shape[0] for m in utts.values())
        dim = next(iter(utts.values())).shape[1]
        print(f"Input       = {len(utts)} utterances, {n}x{dim}")
    else:
        frames = read_features(args.input)
        print(f"Input       = {frames.shape[0]}x{frames.shape[1]}")

    mesh = None
    if args.mesh_model or args.mesh_data:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(data=args.mesh_data, model=args.mesh_model or 1)
        print(f"Mesh        = data={mesh.shape['data']} x model={mesh.shape['model']}")
    scorer = Scorer(
        qnet,
        EngineConfig(backend=args.backend, lazy_mode=args.lazy_mode),
        mesh=mesh,
    )

    if utts is not None:
        t0 = time.perf_counter()
        scored = scorer.score_utterances(utts)
        print(f"Dnn calculation time = {(time.perf_counter() - t0) * 1000:.2f} ms.")
        from ..formats.kaldi_text import write_features_text_kaldi

        write_features_text_kaldi(scored, args.out if args.out else sys.stdout)
        return 0

    masks = None
    if args.mask_density is not None:
        rng = np.random.default_rng(args.seed)
        masks = generate_masks(rng, frames.shape[0], scorer.output_dim, args.mask_density)

    # warmup (compile) then timed iterations
    run = (lambda: scorer.score_masked(frames, masks)) if masks is not None else (
        lambda: scorer.score(frames)
    )
    output = run()
    times = []
    for _ in range(args.iterations):
        t0 = time.perf_counter()
        output = run()
        times.append((time.perf_counter() - t0) * 1000)
    print(f"Dnn calculation time = {min(times):.2f} ms.")

    if args.out is None:
        np.savetxt(sys.stdout, output, fmt="%f", delimiter=" ")
    elif args.out_type == "BIN":
        write_features(output, args.out)
    else:
        write_features_text(output, args.out)
    return 0




def _cli(argv=None) -> int:
    """Entry point with one-line error reporting (no tracebacks for
    expected failures like bad paths, dims, or parameters)."""
    try:
        return main(argv)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
