"""Seeded stand-ins for the reference's bundled feature files.

The reference ships two Kaldi text feature files and their x4-aligned
binary serializations (16khz: 193 x 429 text, the first 100 frames as
16khz.bin; 8khz: 389 x 429 text, all of it as 8khz.aligned.bin).  Tests,
examples and the benchmark need inputs of those shapes, not those values,
so this module makes them from a seed.

Frames are 11-frame splices of 39-dim base frames (edges repeated), like
the reference's 429-dim features, and values are multiples of 1/64, so the
Kaldi text (6 decimals) and the binary float32 files hold exactly the same
numbers.
"""

from __future__ import annotations

import os

import numpy as np

from ..formats.binary import write_features
from ..formats.kaldi_text import write_features_text_kaldi

#: name -> (text frames, text dim, frames in the aligned binary file)
SAMPLE_FILES = {"16khz": (193, 429, 100), "8khz": (389, 429, 389)}
ALIGNED_DIM = 432


BASE_DIM, CONTEXT = 39, 5


def features(n_frames: int, dim: int = ALIGNED_DIM, seed: int = 0) -> np.ndarray:
    """float32 [n_frames, dim]: 429 spliced dims (roughly unit normal),
    zero-padded up to `dim` or cut down to it."""
    r = np.random.default_rng(seed)
    base = np.round(r.standard_normal((n_frames, BASE_DIM)) * 64.0) / 64.0
    idx = np.clip(
        np.arange(n_frames)[:, None] + np.arange(-CONTEXT, CONTEXT + 1), 0, n_frames - 1
    )
    spliced = base[idx].reshape(n_frames, -1).astype(np.float32)
    if dim <= spliced.shape[1]:
        return np.ascontiguousarray(spliced[:, :dim])
    return np.pad(spliced, ((0, 0), (0, dim - spliced.shape[1])))


def write_sample_data(directory, seed: int = 0) -> dict:
    """Write 16khz, 16khz.bin, 8khz and 8khz.aligned.bin into `directory`.

    Returns {file name: path}.  The binary files are the text features
    zero-padded to 432 dims, as the reference's FuncTest aligned them.
    """
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for i, (name, (frames, dim, bin_frames)) in enumerate(SAMPLE_FILES.items()):
        text = features(frames, dim, seed=seed + i)
        paths[name] = os.path.join(directory, name)
        write_features_text_kaldi({f"{name}-utt1": text}, paths[name])
        aligned = np.pad(text, ((0, 0), (0, ALIGNED_DIM - dim)))
        bin_name = name + (".bin" if name == "16khz" else ".aligned.bin")
        paths[bin_name] = os.path.join(directory, bin_name)
        write_features(aligned, paths[bin_name], max_frames=bin_frames)
    return paths
