"""Gathered (capacity-bounded) lazy output scoring — explicit opt-in.

The reference's lazy path computes dot products only for senones the ASR
decoder marks active (~30-50% of 8000, /root/reference/README.md:31-33),
one frame per JNI call (dnn.cc:355-392).  The batched translation here
materializes the union of active senones across the frame block as a
fixed-capacity index vector (static shape -> jit-friendly), gathers the
weight columns, runs the matmul at [B, K] x [K, C], and scatters back to
zero-filled logits.

The gather is not free column-skipping: jnp.take writes the gathered
columns as a NEW [K, C] matrix, so the output stage pays read+write+re-read
of C columns where the dense path pays one read of all N.  So
config.lazy_mode="auto" resolves to dense, and this path runs only on
explicit lazy_mode="gathered".  Whether it wins anywhere on the GPU (small
batches, low densities, output layers far beyond 8k senones) is not
measured yet.

Posteriors are bit-identical to the dense masked path: gathered columns use
the same integer math, non-gathered columns keep the reference's zero logit.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.matmul import masked_softmax_active_only, masked_softmax_reference
from ..quant.quantize import QuantizedNet


def union_active_indices(masks: np.ndarray, capacity: int) -> Tuple[np.ndarray, int]:
    """Host-side: union of active senones across frames -> padded [capacity]
    int32 index vector (padded entries repeat index 0; they are masked out of
    the final logits anyway).  Returns (indices, true_count)."""
    union = np.flatnonzero(masks.any(axis=0))
    count = union.shape[0]
    if count > capacity:
        raise ValueError(f"active union {count} exceeds capacity {capacity}")
    idx = np.zeros(capacity, dtype=np.int32)
    idx[:count] = union
    return idx, count


def gathered_output_posteriors(
    net: QuantizedNet,
    acts_i8: jax.Array,
    masks: jax.Array,
    active_idx: jax.Array,
    *,
    out_dim: int,
    semantics: str = "reference",
) -> jax.Array:
    """Jittable gathered output scoring.

    acts_i8:   [B, K] last-hidden activations (shifted int8)
    masks:     [B, out_dim] nonzero = active
    active_idx:[C] int32 union of active senone ids (static capacity C)
    """
    w = net.weights[-1]
    # gather weight columns / epilogue vectors for the active union
    w_g = jnp.take(w, active_idx, axis=1)  # [K, C] int8
    cs_g = jnp.take(net.colsum128[-1], active_idx)
    b_g = jnp.take(net.biases[-1], active_idx)
    acc = jax.lax.dot_general(
        acts_i8, w_g, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    logits_c = (acc + cs_g).astype(jnp.float32) * net.inv_scales[-1] + b_g  # [B, C]
    # scatter back into dense zero logits (duplicate padded index 0 writes
    # the same value, harmless; inactive columns stay exactly 0.0)
    logits = jnp.zeros((acts_i8.shape[0], out_dim), jnp.float32)
    logits = logits.at[:, active_idx].set(logits_c)
    mask_bool = masks != 0
    if semantics == "reference":
        return masked_softmax_reference(logits, mask_bool)
    return masked_softmax_active_only(logits, mask_bool)
