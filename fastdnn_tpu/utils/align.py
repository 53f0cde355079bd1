"""Alignment / padding helpers.

The reference pads dims for SSE lanes (input dim to x4, hidden widths to x16;
see /root/reference/src/java/suskun/nn/FloatData.java:92-107 and
FeedForwardNetwork.java:50-58).  `aligned_size` and `align_vector`
reproduce the reference semantics exactly.
"""

from __future__ import annotations

import numpy as np

def aligned_size(size: int, alignment: int) -> int:
    """Round `size` up to a multiple of `alignment`.

    Mirrors FloatData.alignedSize (/root/reference/src/java/suskun/nn/
    FloatData.java:102-107) and paddedSize (/root/reference/src/cpp/
    float_dnn.cc:77-83).
    """
    if alignment <= 0:
        raise ValueError(f"alignment must be positive, got {alignment}")
    rem = size % alignment
    return size if rem == 0 else size + alignment - rem


def align_vector(vec: np.ndarray, alignment: int) -> np.ndarray:
    """Zero-pad a 1-D array so len is a multiple of `alignment`.

    Mirrors FloatData.alignTo (/root/reference/src/java/suskun/nn/
    FloatData.java:92-100).
    """
    padded = aligned_size(vec.shape[0], alignment)
    if padded == vec.shape[0]:
        return vec
    out = np.zeros(padded, dtype=vec.dtype)
    out[: vec.shape[0]] = vec
    return out
