"""Quantized sigmoid: uint8 activations in [0, 255].

The reference quantizes sigmoid outputs through a 1280-entry lookup table at
0.01 input resolution (/root/reference/src/cpp/dnn.h:23-47, dnn.cc:100-121):

    k = round(x * 100)
    k <= -640 -> 0;  k >= 640 -> 255
    else      -> round(sigmoid(k / 100) * 255)

On an accelerator a gather through a LUT is slower than arithmetic; the
closed form above *is* the table, so we compute it directly — bit-exact with
the table by construction (both roundings are C round(), i.e.
half-away-from-zero).
`build_reference_lut` reconstructs the table itself for tests.

Activations are carried through the engine as **zero-point-shifted int8**
(q - 128) so both matmul operands are int8; see
fastdnn_tpu/ops/matmul.py for the correction-term algebra.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import (
    ACTIVATION_SCALE,
    SIGMOID_HALF_LOOKUP_SIZE,
    SIGMOID_RESOLUTION,
)

ZERO_POINT = 128  # uint8 activation zero point used for the s8 x s8 matmul


def _round_half_away(x):
    """C round(): round half away from zero (jnp.round is half-to-even)."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def quantized_sigmoid_u8(x: jnp.ndarray) -> jnp.ndarray:
    """f32 -> quantized sigmoid counts in [0, 255], dtype uint8.

    The out-of-table clamps (k <= -640 -> 0, k >= 640 -> 255, dnn.h:35-42)
    need no explicit selects: at the clipped boundary the formula itself
    rounds there — round(sigmoid(-6.4)*255) = round(0.423) = 0 and
    round(sigmoid(6.4)*255) = round(254.58) = 255, with ~0.08 margin, far
    above f32 noise.  (Bit-exactness vs the rebuilt LUT is test-gated.)

    Computed as 127.5 + 127.5*tanh(kc/200) == 255*sigmoid(kc/100): tanh is
    one transcendental where the sigmoid form needs exp + divide.  The two
    table entries whose margin (1.5e-4) is the smallest by far (k = +/-513;
    every other entry's is >= 0.0216) are pinned explicitly, so an
    approximate device tanh cannot round them the wrong way; chip_smoke.py
    checks all 1281 entries bit-exact on the GPU for the XLA path and the
    fused kernel's epilogue, tests/test_quant.py on CPU.
    """
    half = float(SIGMOID_HALF_LOOKUP_SIZE)
    k = _round_half_away(x * SIGMOID_RESOLUTION)
    kc = jnp.clip(k, -half, half)
    v = (ACTIVATION_SCALE / 2.0) + (ACTIVATION_SCALE / 2.0) * jnp.tanh(
        kc * (0.5 / SIGMOID_RESOLUTION)
    )
    q = jnp.floor(v + 0.5)  # v >= 0: half-up == half-away
    q = jnp.where(kc == 513.0, 254.0, q)
    q = jnp.where(kc == -513.0, 1.0, q)
    return q.astype(jnp.uint8)


def quantized_sigmoid_shifted_i8(x: jnp.ndarray) -> jnp.ndarray:
    """f32 -> (quantized sigmoid - 128) as int8, the engine's wire format.

    Trimmed algebra of `quantized_sigmoid_u8` (bit-identical on the integer
    kc domain, gated by tests/test_quant.py and chip_smoke.py):

      * half-away rounding as one trunc:  sign(x)*floor(|x|*r + 0.5)
        == trunc(x*r + copysign(0.5, x))  for every x;
      * no clip: tanh saturates, so every |k| >= 640 already floors to the
        boundary count (127.5*tanh(3.2) = 127.077 -> 127 / -128 shifted);
      * shifted value directly:  floor(v + 0.5) - 128 == floor(u)  where
        u = 127.5*tanh(kc/200) = v - 127.5 (margins unchanged, >= 0.0216
        except the two pinned entries).

    Saves ~5 elementwise ops per element over the v-form.
    """
    half_scale = ACTIVATION_SCALE / 2.0  # 127.5
    k = jnp.trunc(x * SIGMOID_RESOLUTION + jnp.copysign(jnp.float32(0.5), x))
    s = jnp.floor(half_scale * jnp.tanh(k * (0.5 / SIGMOID_RESOLUTION)))
    s = jnp.where(k == 513.0, 126.0, s)
    s = jnp.where(k == -513.0, -127.0, s)
    return s.astype(jnp.int8)


def build_reference_lut() -> np.ndarray:
    """The reference's LUT, rebuilt with float64 like the C++ constructor
    (/root/reference/src/cpp/dnn.cc:100-115).  Test oracle only."""
    half = SIGMOID_HALF_LOOKUP_SIZE
    i = np.arange(-half, half, dtype=np.float64)
    k = i / 100.0
    sig = 1.0 / (1.0 + np.exp(-k))
    # np.round is half-to-even; emulate C round() half-away-from-zero
    q = np.floor(sig * ACTIVATION_SCALE + 0.5)
    return q.astype(np.uint8)


def reference_lut_lookup(x: np.ndarray) -> np.ndarray:
    """QuantizedSigmoid::get via the actual table (/root/reference/src/cpp/
    dnn.h:35-42).  Test oracle only."""
    lut = build_reference_lut()
    half = SIGMOID_HALF_LOOKUP_SIZE
    x = np.asarray(x, dtype=np.float32)
    k = np.sign(x) * np.floor(np.abs(x) * 100.0 + 0.5)
    k = k.astype(np.int64)
    out = np.zeros(x.shape, dtype=np.uint8)
    mid = (k > -half) & (k < half)
    out[mid] = lut[(k[mid] + half)]
    out[k >= half] = int(ACTIVATION_SCALE)
    return out
