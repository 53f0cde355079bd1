"""Per-layer symmetric int8 weight quantization -> QuantizedNet pytree.

Scheme (spec: QuantizedSimdLayer ctor, /root/reference/src/cpp/dnn.cc:460-509):
  * clamp weights to [-cutoff, +cutoff] (default cutoff 3.0,
    /root/reference/src/java/suskun/nn/QuantizedDnn.java:68-70)
  * layer multiplier = round(127 / absmax(clamped))   (dnn.cc:467-479)
  * w_q = round(w_clamped * multiplier) as int8       (dnn.cc:483-502)
  * biases stay float (dnn.cc:504-508); the input layer stays float because
    input dynamic range is too large to quantize (dnn.cc:217-218)
  * dequantization after an int dot with uint8 sigmoid activations divides by
    (multiplier * 255)                                (dnn.cc:297-298)

Deliberate divergences from the reference (SURVEY.md §2 #7):
  * the reference fails to clamp positive outliers before rounding (its
    max-side test reads `minWeight > maxWeight`, dnn.cc:496-498) so w > cutoff
    can overflow signed char; we clamp both sides and clip to [-128, 127].
  * accumulation here is exact int32; the reference's
    _mm_maddubs_epi16 saturates pairwise sums at 16 bits (dnn.cc:340), a
    lossy quirk we do not replicate.
Both make this engine strictly *more* accurate w.r.t. the float model; parity
tests gate against the float oracle at the reference's own tolerance
(FuncTest.java:59-74).

Weight layout is [input_dim, output_dim] (matmul-shaped `x @ W`).  For every
quantized layer we precompute `colsum128 = 128 * sum_k(w_q[k, n])` (int32),
the zero-point correction that lets uint8 activations ride an s8 x s8 matmul:

    sum_k a_u8[k] * w[k, n] = sum_k (a_u8[k] - 128) * w[k, n] + colsum128[n]
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from ..config import ACTIVATION_SCALE, WEIGHT_SCALE, EngineConfig
from ..models.feedforward import FeedForwardNet, fuse_transform

# int4 weights live in HOST numpy arrays with the ml_dtypes.int4 extension
# dtype (== jnp.int4) until a jitted program consumes them: all int4 prep
# math (quantize, pack, pad) runs in numpy, and a device sees s4 bits only
# as packed nibbles riding ordinary int8 (pack_int4_trunk) or as a native-s4
# jit argument.  numpy f32 and XLA-CPU f32 agree bitwise on the elementary
# ops used here (clip/round/mul/div/sum).
INT4 = ml_dtypes.int4


def _round_half_away(x):
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def _round_half_away_np(x):
    return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedNet:
    """Immutable quantized network pytree.

    input_w/input_b: float first layer (f32 [in, h0], [h0]) with the feature
        transform already fused in (shift/scale are gone by construction).
    weights[i]: int8 [in_i, out_i] for hidden layers 1..n-1 and the output
        layer (the last entry doubles as the output layer, like the
        reference, /root/reference/src/cpp/dnn.cc:522).
    colsum128[i]: int32 [out_i] zero-point correction (see module docstring).
    biases[i]: f32 [out_i] (never quantized).
    inv_scales[i]: f32 scalar 1 / (multiplier_i * 255) — the dequantization
        coefficient (dnn.cc:297-298).
    multipliers[i]: f32 scalar, kept for introspection/tests.
    true_output_dim: static metadata set by pad_qnet — the real senone
        count when the output width carries padding columns (None = the
        width IS the true count).  Lets every scoring path
        derive the softmax extent from the net itself instead of relying
        on callers to thread an out_dim argument.
    """

    input_w: jax.Array
    input_b: jax.Array
    weights: Tuple[jax.Array, ...]
    colsum128: Tuple[jax.Array, ...]
    biases: Tuple[jax.Array, ...]
    inv_scales: Tuple[jax.Array, ...]
    multipliers: Tuple[jax.Array, ...]
    true_output_dim: int | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    #: int4 hidden weights stored as two-nibbles-per-byte int8 [K/2, N]
    #: (pack_int4_trunk); the program unpacks them — see that function's doc
    packed_int4: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    #: hidden weights (all but the output layer) stored K-major, [N, K], for
    #: the fused GPU kernel (ops.hidden_kernel.prepare_net)
    hidden_kmajor: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    @property
    def input_dim(self) -> int:
        return self.input_w.shape[0]

    @property
    def output_dim(self) -> int:
        """True senone count (excludes padding columns)."""
        if self.true_output_dim is not None:
            return self.true_output_dim
        return self.weights[-1].shape[1]

    @property
    def padded_output_dim(self) -> int:
        """Output-layer width as stored (includes padding columns)."""
        return self.weights[-1].shape[1]

    @property
    def layer_count(self) -> int:
        """Total layer count including the input layer."""
        return len(self.weights) + 1

    def layer_dims(self):
        return [self.input_w.shape[1]] + [w.shape[1] for w in self.weights]


def quantize_layer(w: jax.Array, cutoff: float, bits: int = 8):
    """Quantize one layer's [in, out] float weights.

    bits=8 is the reference scheme (scale 127, int8); bits=4 is an
    extension — scale 7, stored with the int4 extension dtype (XLA packs
    two weights per byte, halving weight bytes).  The reference has no
    analog (SSE has no 4-bit lanes).

    Returns (w_q int8|int4, multiplier f32 scalar).  bits=4 computes in
    host numpy and returns a HOST array (see module note on INT4).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 8:
        clamped = jnp.clip(w, -cutoff, cutoff)
        absmax = jnp.max(jnp.abs(clamped))
        # an all-zero layer is exactly representable: any finite multiplier
        # quantizes it to zeros; guard the division so it doesn't produce
        # inf/NaN (the reference would divide by zero here, dnn.cc:479)
        absmax = jnp.where(absmax == 0, 1.0, absmax)
        # floor at 1: with a huge cutoff and absmax > 254, round(127/absmax)
        # would hit 0 and poison inv_scale (1/(0*255) = inf -> NaN posteriors)
        multiplier = jnp.maximum(_round_half_away(WEIGHT_SCALE / absmax), 1.0)
        w_q = jnp.clip(_round_half_away(clamped * multiplier), -128, 127)
        return w_q.astype(jnp.int8), multiplier.astype(jnp.float32)
    clamped = np.clip(
        np.asarray(w, np.float32), np.float32(-cutoff), np.float32(cutoff)
    )
    absmax = np.float32(np.max(np.abs(clamped)))
    if absmax == 0:  # same guards as the int8 branch above
        absmax = np.float32(1.0)
    multiplier = np.maximum(
        _round_half_away_np(np.float32(7.0) / absmax), np.float32(1.0)
    )
    w_q = np.clip(_round_half_away_np(clamped * multiplier), -8, 7)
    return w_q.astype(np.int8).astype(INT4), np.float32(multiplier)


def quantize_net(
    net: FeedForwardNet,
    cutoff: float = EngineConfig.cutoff,
    *,
    fuse_input_transform: bool = True,
    hidden_bits: int = 8,
) -> QuantizedNet:
    """FeedForwardNet -> QuantizedNet.

    The input layer stays float; shift/scale are fused into it by default
    (set fuse_input_transform=False only if the net was already fused).

    hidden_bits=4 stores the hidden trunk as int4 (half the weight bytes;
    the dequant algebra is unchanged — colsum128 and inv_scales absorb the
    narrower scale).  The OUTPUT layer always stays int8: its logits feed
    a softmax where 4-bit steps would visibly move posteriors, while
    hidden-layer error is squashed by the 0.01-resolution sigmoid LUT.
    Gate int4 nets against the float oracle at the reference's 0.1
    tolerance (tests/test_quant.py::TestInt4Trunk).
    """
    if cutoff <= 0:
        raise ValueError(f"weight cutoff must be positive, got {cutoff}")
    if net.layer_count < 2:
        raise ValueError("need at least an input layer and an output layer")
    if fuse_input_transform:
        net = fuse_transform(net)
    weights, colsums, biases, inv_scales, multipliers = [], [], [], [], []
    n_quant = net.layer_count - 1
    for i, (w, b) in enumerate(zip(net.weights[1:], net.biases[1:])):
        bits = hidden_bits if i < n_quant - 1 else 8
        w_q, mult = quantize_layer(w, cutoff, bits=bits)
        weights.append(w_q)
        if bits == 4:  # host-numpy prep; see module note on INT4
            colsums.append(
                128 * np.sum(np.asarray(w_q).astype(np.int32), axis=0)
            )
            inv_scales.append(
                np.float32(1.0) / (mult * np.float32(ACTIVATION_SCALE))
            )
        else:
            colsums.append(128 * jnp.sum(w_q.astype(jnp.int32), axis=0))
            inv_scales.append(
                (1.0 / (mult * ACTIVATION_SCALE)).astype(jnp.float32)
            )
        biases.append(b.astype(jnp.float32))
        multipliers.append(mult)
    return QuantizedNet(
        input_w=net.weights[0].astype(jnp.float32),
        input_b=net.biases[0].astype(jnp.float32),
        weights=tuple(weights),
        colsum128=tuple(colsums),
        biases=tuple(biases),
        inv_scales=tuple(inv_scales),
        multipliers=tuple(multipliers),
    )


def pack_int4_trunk(qnet: QuantizedNet) -> QuantizedNet:
    """Repack int4 hidden weights as two-nibbles-per-byte int8 [K/2, N].

    The alternative storage for the int4 trunk (EngineConfig.int4_packed):
    where a toolchain does not lower `jnp.int4` operands natively, the same
    s4 values ride as ordinary int8 bytes — row k of the low nibbles is
    weight row k, row k of the high nibbles is weight row K/2+k — and the
    program unpacks with two arithmetic shifts and runs two plain
    s8 x s8 dots over the activation halves:

        acc = x[:, :K/2] @ lo + x[:, K/2:] @ hi

    Identical math (the nibbles ARE the s4 weights, colsum128/inv_scale
    unchanged), half the HBM weight bytes, zero reliance on s4 support.
    Apply AFTER pad_qnet (Scorer does this when the config flag is
    set): packing first would make the pad land on packed rows and split
    the halves at the wrong K.  Output layer (always int8) is untouched;
    an all-int8 net passes through unchanged.
    """
    if qnet.packed_int4:
        return qnet
    weights = []
    changed = False
    for w in qnet.weights:
        if w.dtype != jnp.int4:
            weights.append(w)
            continue
        k = w.shape[0]
        if k % 2:
            raise ValueError(f"packed int4 needs an even K, got {k}")
        # host-numpy: int4 weights never touch a device unpacked (see INT4)
        w8 = np.asarray(w).astype(np.int8)
        lo, hi = w8[: k // 2], w8[k // 2 :]
        weights.append(((hi << 4) | (lo & 0xF)).astype(np.int8))
        changed = True
    if not changed:
        return qnet
    return dataclasses.replace(qnet, weights=tuple(weights), packed_int4=True)


def _pad2(a, rows: int, cols: int):
    widths = ((0, rows - a.shape[0]), (0, cols - a.shape[1]))
    if a.dtype == jnp.int4:
        # host-numpy via an int8 round trip (np.pad has no int4 kernel and
        # device int4 must never be touched eagerly; see module note on INT4)
        return np.pad(np.asarray(a).astype(np.int8), widths).astype(INT4)
    return jnp.pad(a, widths)


def pad_qnet(qnet: QuantizedNet, lanes: int = 1, out_lanes: int = 1) -> QuantizedNet:
    """Zero-pad hidden node dims up to a multiple of `lanes` and the output
    node dim up to a multiple of `out_lanes`.

    The engine pads for two reasons only: the fused GPU hidden kernel tiles
    hidden widths in blocks (ops.hidden_kernel.prepare_net), and a
    model-sharded mesh splits the output layer evenly over the model axis.

    Padding is mathematically inert end to end: padded weight columns carry
    zero weights and zero bias, so padded hidden activations quantize to
    sigmoid(0) whose shifted-int8 value is 0 and whose outgoing weights are
    zero rows; padded output logits are exactly 0.0 and every scoring path
    keeps them out of the softmax via the true senone count stamped here.
    """

    if qnet.hidden_kmajor:
        raise ValueError("pad before ops.hidden_kernel.prepare_net transposes the trunk")
    if qnet.packed_int4:
        raise ValueError(
            "pad before packing: zero-padding a packed-nibble weight matrix "
            "would split the low/high halves at the wrong K (Scorer applies "
            "pack_int4_trunk after pad_qnet)"
        )

    def up(n: int, m: int = lanes) -> int:
        return -(-n // m) * m

    in_w = qnet.input_w
    last = len(qnet.weights) - 1
    h0 = up(in_w.shape[1])
    in_w = _pad2(in_w, in_w.shape[0], h0)
    in_b = jnp.pad(qnet.input_b, (0, h0 - qnet.input_b.shape[0]))
    weights, colsums, biases = [], [], []
    for i, (w, cs, b) in enumerate(
        zip(qnet.weights, qnet.colsum128, qnet.biases)
    ):
        k = up(w.shape[0])
        n = up(w.shape[1], out_lanes if i == last else lanes)
        weights.append(_pad2(w, k, n))
        colsums.append(jnp.pad(cs, (0, n - cs.shape[0])))
        biases.append(jnp.pad(b, (0, n - b.shape[0])))
    return dataclasses.replace(
        qnet,
        input_w=in_w,
        input_b=in_b,
        weights=tuple(weights),
        colsum128=tuple(colsums),
        biases=tuple(biases),
        true_output_dim=qnet.output_dim,
    )
