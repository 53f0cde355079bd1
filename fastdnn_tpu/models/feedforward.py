"""Float feed-forward acoustic model as an immutable JAX pytree.

Topology matches the reference (/root/reference/README.md:69-70): input layer
(float) -> N sigmoid hidden layers -> softmax output layer, with a per-frame
feature transform `(x + shift) * scale` applied before the first layer.

Unlike the reference this is a JAX-native design:
  * weights are stored [input_dim, output_dim] so a frame batch is scored as
    `x @ W + b` — directly matmul-shaped (the reference stores node-major rows
    for SSE dot products, /root/reference/src/cpp/dnn.cc:123-144);
  * `align` / `extend` are pure array transforms returning new nets
    (spec: FeedForwardNetwork.align/extend, /root/reference/src/java/suskun/
    nn/FeedForwardNetwork.java:50-66,264-307);
  * the feature transform can be *fused into the first layer* so the hot path
    does zero extra elementwise passes (`fuse_transform`).

`forward` is the float oracle the quantized engine is validated against,
mirroring the reference's pure-Java forward pass (FeedForwardNetwork.java:
121-148,360-414) which it uses the same way (FuncTest.java:59-74).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.binary import RawLayer, RawNetwork
from ..utils.align import aligned_size


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FeedForwardNet:
    """Immutable float network pytree.

    weights[i]: f32 [in_dim_i, out_dim_i]  (transposed from file layout)
    biases[i]:  f32 [out_dim_i]
    shift/scale: f32 [input_dim]
    """

    weights: Tuple[jax.Array, ...]
    biases: Tuple[jax.Array, ...]
    shift: jax.Array
    scale: jax.Array

    @property
    def input_dim(self) -> int:
        return self.weights[0].shape[0]

    @property
    def output_dim(self) -> int:
        return self.weights[-1].shape[1]

    @property
    def layer_count(self) -> int:
        return len(self.weights)

    def layer_dims(self) -> List[int]:
        return [w.shape[1] for w in self.weights]


def from_raw(raw: RawNetwork) -> FeedForwardNet:
    """Build the pytree from a parsed model file (transposes weights)."""
    ws = tuple(jnp.asarray(l.weights.T, dtype=jnp.float32) for l in raw.layers)
    bs = tuple(jnp.asarray(l.bias, dtype=jnp.float32) for l in raw.layers)
    return FeedForwardNet(
        ws, bs, jnp.asarray(raw.shift, jnp.float32), jnp.asarray(raw.scale, jnp.float32)
    )


def to_raw(net: FeedForwardNet) -> RawNetwork:
    """Inverse of `from_raw`, for writing reference-format files."""
    layers = [
        RawLayer(np.asarray(w).T.copy(), np.asarray(b).copy())
        for w, b in zip(net.weights, net.biases)
    ]
    return RawNetwork(layers, np.asarray(net.shift).copy(), np.asarray(net.scale).copy())


def _pad_to(arr: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), dtype=arr.dtype)
    out[: arr.shape[0], : arr.shape[1]] = arr
    return out


def align(
    net: FeedForwardNet, input_alignment: int = 4, hidden_alignment: int = 16
) -> FeedForwardNet:
    """Zero-pad dims: input dim to a multiple of `input_alignment`, hidden
    widths to `hidden_alignment`; the output layer is aligned on its input
    side only.  Mirrors FeedForwardNetwork.align (/root/reference/src/java/
    suskun/nn/FeedForwardNetwork.java:50-58).
    """
    ws = [np.asarray(w) for w in net.weights]
    bs = [np.asarray(b) for b in net.biases]
    n = len(ws)
    new_ws, new_bs = [], []
    for i in range(n):
        in_a = input_alignment if i == 0 else hidden_alignment
        out_a = 1 if i == n - 1 else hidden_alignment
        in_dim = aligned_size(ws[i].shape[0], in_a)
        out_dim = aligned_size(ws[i].shape[1], out_a)
        new_ws.append(_pad_to(ws[i], in_dim, out_dim))
        nb = np.zeros(out_dim, dtype=bs[i].dtype)
        nb[: bs[i].shape[0]] = bs[i]
        new_bs.append(nb)
    pad_in = new_ws[0].shape[0]
    shift = np.zeros(pad_in, np.float32)
    shift[: net.shift.shape[0]] = np.asarray(net.shift)
    scale = np.zeros(pad_in, np.float32)
    scale[: net.scale.shape[0]] = np.asarray(net.scale)
    return FeedForwardNet(
        tuple(jnp.asarray(w) for w in new_ws),
        tuple(jnp.asarray(b) for b in new_bs),
        jnp.asarray(shift),
        jnp.asarray(scale),
    )


def _extend_circular(vec: np.ndarray, size: int) -> np.ndarray:
    """Circularly tile a 1-D array to `size` (FeedForwardNetwork.java:301-307)."""
    idx = np.arange(size) % vec.shape[0]
    return vec[idx]


def extend(net: FeedForwardNet, hidden_width: int, output_count: int) -> FeedForwardNet:
    """Grow a net to target sizes by circular weight cloning.

    Used to synthesize the large benchmark net from a smaller trained one
    (FuncTest.java:21-28).  Semantics mirror FeedForwardNetwork.extend
    (/root/reference/src/java/suskun/nn/FeedForwardNetwork.java:60-66):
    hidden layers are extended circularly in both dims; the *output layer is
    zero-padded* (the reference calls align on it, not extend), so synthetic
    extra senones have zero weights and bias.
    """
    ws = [np.asarray(w) for w in net.weights]
    bs = [np.asarray(b) for b in net.biases]
    n = len(ws)
    new_ws, new_bs = [], []
    for i in range(n):
        w, b = ws[i], bs[i]
        if i == n - 1:
            # output layer: zero-pad input side to hidden_width, output side
            # to output_count (align semantics)
            new_ws.append(_pad_to(w, hidden_width, output_count))
            nb = np.zeros(output_count, dtype=b.dtype)
            nb[: b.shape[0]] = b
            new_bs.append(nb)
        else:
            in_target = w.shape[0] if i == 0 else hidden_width
            # circular clone: rows (input dim) then columns (nodes)
            row_idx = np.arange(in_target) % w.shape[0]
            col_idx = np.arange(hidden_width) % w.shape[1]
            new_ws.append(w[row_idx][:, col_idx])
            new_bs.append(_extend_circular(b, hidden_width))
    return FeedForwardNet(
        tuple(jnp.asarray(w) for w in new_ws),
        tuple(jnp.asarray(b) for b in new_bs),
        net.shift,
        net.scale,
    )


def fuse_transform(net: FeedForwardNet) -> FeedForwardNet:
    """Fold `(x + shift) * scale` into the first layer.

    (x + shift) * scale @ W1 + b1  ==  x @ (scale[:,None] * W1)
                                       + (b1 + (shift * scale) @ W1)
    so after fusing, shift becomes 0 and scale becomes 1 and the hot path
    skips the elementwise transform entirely (BASELINE.json north star:
    "feature-transform fused into the first layer").
    """
    w0, b0 = net.weights[0], net.biases[0]
    fused_w0 = net.scale[:, None] * w0
    fused_b0 = b0 + (net.shift * net.scale) @ w0
    return FeedForwardNet(
        (fused_w0,) + tuple(net.weights[1:]),
        (fused_b0,) + tuple(net.biases[1:]),
        jnp.zeros_like(net.shift),
        jnp.ones_like(net.scale),
    )


def apply_transform(net: FeedForwardNet, frames: jax.Array) -> jax.Array:
    """(x + shift) * scale (/root/reference/src/cpp/dnn.cc:175-192)."""
    return (frames + net.shift) * net.scale


def forward(
    net: FeedForwardNet, frames: jax.Array, *, apply_input_transform: bool = True
) -> jax.Array:
    """Float forward pass: posteriors f32 [frames, output_dim].

    The float oracle for quantization-accuracy tests (mirrors the reference's
    naive Java pass, FeedForwardNetwork.java:133-148).  Uses a numerically
    stable softmax (the reference's is unstable, /root/reference/src/cpp/
    dnn.cc:534-544 — SURVEY.md §2 #10 recommends fixing; results agree
    whenever the reference doesn't overflow).
    """
    x = apply_transform(net, frames) if apply_input_transform else frames
    n = net.layer_count
    for i in range(n):
        # full f32 precision: accelerator matmuls default to bf16 or TF32
        # passes, which would blur the oracle this pass exists to be
        x = jnp.dot(x, net.weights[i], precision=jax.lax.Precision.HIGHEST)
        x = x + net.biases[i]
        if i < n - 1:
            x = jax.nn.sigmoid(x)
    return jax.nn.softmax(x, axis=-1)


def random_net(
    key: jax.Array,
    input_dim: int,
    hidden_widths: Sequence[int],
    output_dim: int,
    w_std: float | None = None,
) -> FeedForwardNet:
    """Random test/benchmark net with the reference topology family.

    Weights default to 1/sqrt(fan_in) scaling so pre-activations land in the
    sigmoid's useful range, like a trained net — random unscaled weights
    saturate every sigmoid and exaggerate quantization error unrealistically.
    """
    dims = [input_dim, *hidden_widths, output_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        key, k1, k2 = jax.random.split(key, 3)
        std = w_std if w_std is not None else dims[i] ** -0.5
        ws.append(jax.random.normal(k1, (dims[i], dims[i + 1]), jnp.float32) * std)
        bs.append(jax.random.normal(k2, (dims[i + 1],), jnp.float32) * 0.1)
    key, k1, k2 = jax.random.split(key, 3)
    shift = jax.random.normal(k1, (input_dim,), jnp.float32)
    scale = jax.random.uniform(k2, (input_dim,), jnp.float32, 0.5, 1.5)
    return FeedForwardNet(tuple(ws), tuple(bs), shift, scale)
