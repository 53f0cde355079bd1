"""XLA-path compute ops for the quantized engine.

These are pure jnp implementations of the three stages, compiled by XLA
(int8 matmuls with elementwise epilogues).  The fused GPU hidden kernel in
ops/hidden_kernel.py computes bit-identical results (integer matmul is
exact on every backend), so this module doubles as the plain reference for
that kernel and as the engine's XLA backend.

Stage mapping to the reference (SURVEY.md §3.2 call stack):
  input_layer_step    = InputActivations + AddBias + QuantizedSigmoid
                        (/root/reference/src/cpp/dnn.cc:219-286)
  hidden_layer_step   = QuantizedLayerActivations + AddBias + QuantizedSigmoid
                        (dnn.cc:289-318, 402-424)
  output_logits       = QuantizedLayerActivations + AddBias on the output
                        layer (dnn.cc:428-449); softmax applied by callers
  masked_output_step  = LazyOutputActivations (dnn.cc:355-392), vectorized
                        over frames: one [frames, out] mask instead of one
                        JNI crossing per frame (README.md:45)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sigmoid import ZERO_POINT, quantized_sigmoid_shifted_i8


def int8_matmul(a_i8: jax.Array, w_i8: jax.Array) -> jax.Array:
    """[B, K] int8 @ [K, N] int8 -> [B, N] int32 (exact)."""
    return jax.lax.dot_general(
        a_i8,
        w_i8,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def input_layer_step(frames_f32, w_f32, b_f32, precision: str = "highest"):
    """Float first layer -> shifted-int8 quantized sigmoid activations.

    The input layer is not quantized (input dynamic range too large,
    /root/reference/src/cpp/dnn.cc:217-218).  Feature shift/scale is assumed
    fused into (w, b) already.

    precision: matmul precision of the f32 dot (EngineConfig.input_precision);
    below "highest" an accelerator may round the operands (bf16 or TF32
    passes), which can move a linear activation across a sigmoid count.
    """
    lin = jnp.dot(frames_f32, w_f32, precision=precision) + b_f32
    return quantized_sigmoid_shifted_i8(lin)


def dequantize(acc_i32, colsum128_i32, inv_scale_f32, bias_f32):
    """(acc + colsum128) * inv_scale + bias.

    acc is the s8 x s8 dot of shifted activations; adding colsum128 recovers
    the true uint8 x int8 sum, then `sum / (multiplier * 255)` dequantizes
    (/root/reference/src/cpp/dnn.cc:297-313) and float bias is added
    (dnn.cc:250-264).
    """
    return (acc_i32 + colsum128_i32).astype(jnp.float32) * inv_scale_f32 + bias_f32


def hidden_layer_step(acts_i8, w_i8, colsum128_i32, inv_scale_f32, bias_f32):
    """One quantized hidden layer: int8 matmul -> dequant -> bias ->
    quantized sigmoid -> shifted int8."""
    acc = int8_matmul(acts_i8, w_i8)
    lin = dequantize(acc, colsum128_i32, inv_scale_f32, bias_f32)
    return quantized_sigmoid_shifted_i8(lin)


def unpack_int4_pair(packed_i8):
    """[K/2, N] two-nibbles-per-byte int8 -> (lo, hi) int8 weight halves.

    Inverse of quant.quantize.pack_int4_trunk: lo[k] is weight row k, hi[k]
    is weight row K/2+k; arithmetic shifts sign-extend the s4 nibbles."""
    lo = (packed_i8 << 4) >> 4
    hi = packed_i8 >> 4
    return lo, hi


def hidden_layer_step_packed(acts_i8, w_packed_i8, colsum128_i32,
                             inv_scale_f32, bias_f32):
    """hidden_layer_step for a pack_int4_trunk weight matrix: unpack the
    nibbles and run two s8 x s8 dots over the activation halves — exact
    (integer) and bitwise-identical to the unpacked int4 layer."""
    kk = w_packed_i8.shape[0]
    lo, hi = unpack_int4_pair(w_packed_i8)
    acc = int8_matmul(acts_i8[:, :kk], lo) + int8_matmul(acts_i8[:, kk:], hi)
    lin = dequantize(acc, colsum128_i32, inv_scale_f32, bias_f32)
    return quantized_sigmoid_shifted_i8(lin)


def output_logits(acts_i8, w_i8, colsum128_i32, inv_scale_f32, bias_f32):
    """Output layer linear activations (pre-softmax), f32 [B, out]."""
    acc = int8_matmul(acts_i8, w_i8)
    return dequantize(acc, colsum128_i32, inv_scale_f32, bias_f32)


def masked_softmax_reference(logits, mask_bool):
    """Softmax with the reference's lazy semantics: inactive senones keep a
    *zero logit* and still contribute exp(0)=1 to the denominator
    (/root/reference/src/cpp/dnn.cc:369-389) — observable API behavior we
    reproduce exactly (stable-softmax form: the zeros participate in the max).
    """
    z = jnp.where(mask_bool, logits, 0.0)
    m = jnp.max(z, axis=-1, keepdims=True)
    e = jnp.exp(z - m)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def masked_softmax_active_only(logits, mask_bool):
    """Softmax renormalized over active senones only (documented divergence
    option; inactive posteriors are exactly 0).  A fully-masked frame
    yields an all-zero row (not NaN), matching the fused kernels."""
    neg = jnp.finfo(logits.dtype).min
    z = jnp.where(mask_bool, logits, neg)
    m = jnp.max(z, axis=-1, keepdims=True)
    e = jnp.where(mask_bool, jnp.exp(z - m), 0.0)
    s = jnp.sum(e, axis=-1, keepdims=True)
    return e / jnp.maximum(s, jnp.finfo(logits.dtype).tiny)


def masked_output_step(
    acts_i8,
    w_i8,
    colsum128_i32,
    inv_scale_f32,
    bias_f32,
    mask_bool,
    *,
    semantics: str = "reference",
):
    """Dense masked output scoring: full matmul, logits zeroed where the
    mask is inactive, then the chosen softmax semantics.

    At realistic batch sizes the dense output matmul is compute-cheap on the
    device and the weight read is amortized over frames, so batched "lazy"
    is a masking problem, not a gather problem (SURVEY.md §3.3).
    A gathered variant for tiny-batch latency lives in lazy.py.
    """
    logits = output_logits(acts_i8, w_i8, colsum128_i32, inv_scale_f32, bias_f32)
    if semantics == "reference":
        return masked_softmax_reference(logits, mask_bool)
    elif semantics == "active_only":
        return masked_softmax_active_only(logits, mask_bool)
    raise ValueError(f"unknown lazy semantics {semantics!r}")
