"""Fused int8 hidden layer for NVIDIA GPUs (Pallas through Triton).

One kernel per hidden layer computes

    s8 x s8 matmul (int32 accumulator in registers) -> + colsum128
    -> * inv_scale -> + bias -> quantized sigmoid -> shifted int8

so the layer's only device-memory traffic is int8 activations in, int8
weights in and int8 activations out.  The unfused XLA form
(`ops.matmul.hidden_layer_step`) is the plain reference: the integer matmul
is exact and the epilogue is the same f32 closed form
(`ops.sigmoid.quantized_sigmoid_shifted_i8`), so the two agree bitwise.

The grid tiles the output over (frames, nodes); each block walks the K axis
in `block_k` steps with the accumulator held in registers, and Triton
pipelines the K loop's loads over `num_stages` shared-memory buffers.
Weights are taken K-major ([N, K], `w_t`), the operand layout Hopper's
8-bit warpgroup matmul reads without a transpose.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..quant.quantize import QuantizedNet, pad_qnet
from .sigmoid import quantized_sigmoid_shifted_i8

#: hidden widths are padded to this multiple so every layer tiles
LANES = 128

#: frame count -> tiling (block_frames, block_nodes, block_k, num_warps,
#: num_stages); the first entry whose bound the frame count reaches wins.
#: Chosen on an H100 at 2048 x 2048 (tools/time_hidden_layer.py, PERF.md,
#: the fastest measured at 8192, 512 and 128 frames): 128 x 128 tiles with
#: 8 warps for large batches; smaller tiles below, so that enough blocks
#: (256 at 512 frames, 128 at 128 frames) fill the 132 SMs.
TILINGS = (
    (1024, (128, 128, 128, 8, 3)),
    (256, (64, 64, 128, 4, 4)),
    (0, (32, 64, 128, 4, 3)),
)
#: fused_hidden_layer's defaults: the large-batch tiling
BLOCK_FRAMES, BLOCK_NODES, BLOCK_K, NUM_WARPS, NUM_STAGES = TILINGS[0][1]


def tiling(b: int) -> tuple:
    """The (block_frames, block_nodes, block_k, num_warps, num_stages)
    tiling the engine uses for `b` frames."""
    return next(t for bound, t in TILINGS if b >= bound)


def _hidden_kernel(x_ref, w_ref, colsum_ref, bias_ref, inv_scale_ref, out_ref,
                   *, block_k: int):
    bm, k = x_ref.shape
    bn = w_ref.shape[0]

    def body(i, acc):
        ks = pl.ds(pl.multiple_of(i * block_k, block_k), block_k)
        x = plgpu.load(x_ref.at[:, ks])
        w = plgpu.load(w_ref.at[:, ks])
        return acc + pl.dot(x, w, trans_b=True)

    acc = jax.lax.fori_loop(0, k // block_k, body, jnp.zeros((bm, bn), jnp.int32))
    lin = (acc + colsum_ref[...]).astype(jnp.float32) * inv_scale_ref[0] + bias_ref[...]
    out_ref[...] = quantized_sigmoid_shifted_i8(lin)


def tiles(b: int, k: int, n: int, block_frames: int = BLOCK_FRAMES,
          block_nodes: int = BLOCK_NODES, block_k: int = BLOCK_K) -> bool:
    """True when a [b, k] x [k, n] layer tiles exactly into the kernel's
    blocks (the kernel does no masking)."""
    return b % block_frames == 0 and n % block_nodes == 0 and k % block_k == 0


@functools.partial(
    jax.jit,
    static_argnames=("block_frames", "block_nodes", "block_k", "num_warps",
                     "num_stages", "interpret"),
)
def fused_hidden_layer(
    acts_i8: jax.Array,
    w_t_i8: jax.Array,
    colsum128_i32: jax.Array,
    inv_scale_f32: jax.Array,
    bias_f32: jax.Array,
    *,
    block_frames: int = BLOCK_FRAMES,
    block_nodes: int = BLOCK_NODES,
    block_k: int = BLOCK_K,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
) -> jax.Array:
    """Shifted-int8 activations [B, K] x K-major int8 weights [N, K] ->
    shifted-int8 activations [B, N].

    B, N and K must be multiples of block_frames, block_nodes and block_k
    (see `tiles`); the engine buckets frames and pads node widths so.
    """
    b, k = acts_i8.shape
    n, k2 = w_t_i8.shape
    if k != k2:
        raise ValueError(f"K mismatch: activations {k} vs weights {k2}")
    if colsum128_i32.shape != (n,) or bias_f32.shape != (n,):
        raise ValueError(f"colsum/bias must be [{n}]")
    if acts_i8.dtype != jnp.int8 or w_t_i8.dtype != jnp.int8:
        raise ValueError("activations and weights must be int8")
    if not tiles(b, k, n, block_frames, block_nodes, block_k):
        raise ValueError(
            f"shape B={b}, K={k}, N={n} does not tile into blocks "
            f"({block_frames}, {block_nodes}, K step {block_k})"
        )
    return pl.pallas_call(
        functools.partial(_hidden_kernel, block_k=block_k),
        out_shape=jax.ShapeDtypeStruct((b, n), jnp.int8),
        grid=(b // block_frames, n // block_nodes),
        in_specs=[
            pl.BlockSpec((block_frames, k), lambda i, j: (i, 0)),
            pl.BlockSpec((block_nodes, k), lambda i, j: (j, 0)),
            pl.BlockSpec((block_nodes,), lambda i, j: (j,)),
            pl.BlockSpec((block_nodes,), lambda i, j: (j,)),
            pl.BlockSpec((1,), lambda i, j: (0,)),
        ],
        out_specs=pl.BlockSpec((block_frames, block_nodes), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="fused_hidden_layer",
    )(
        acts_i8,
        w_t_i8,
        colsum128_i32,
        bias_f32,
        jnp.reshape(jnp.asarray(inv_scale_f32, jnp.float32), (1,)),
    )


def hidden_layer(acts_i8, w_t_i8, colsum128_i32, inv_scale_f32, bias_f32, *,
                 interpret: bool = False) -> jax.Array:
    """`fused_hidden_layer` at the engine's tiling for this frame count,
    with the frame axis zero-padded to the tile and sliced back."""
    b = acts_i8.shape[0]
    bm, bn, bk, nw, ns = tiling(b)
    pad = -b % bm
    if pad:
        acts_i8 = jnp.pad(acts_i8, ((0, pad), (0, 0)))
    out = fused_hidden_layer(
        acts_i8, w_t_i8, colsum128_i32, inv_scale_f32, bias_f32,
        block_frames=bm, block_nodes=bn, block_k=bk, num_warps=nw,
        num_stages=ns, interpret=interpret,
    )
    return out[:b] if pad else out


def prepare_net(net: QuantizedNet) -> QuantizedNet:
    """The net as the kernel takes it: hidden widths zero-padded to LANES
    (pad_qnet; inert) and hidden weights stored K-major ([N, K]), flagged
    by `hidden_kmajor`.  The kernel is int8-only, so a net whose trunk is
    int4 comes back unchanged and its hidden layers run through XLA.
    """
    hidden = net.weights[:-1]
    if net.hidden_kmajor or not hidden or any(w.dtype != jnp.int8 for w in hidden):
        return net
    net = pad_qnet(net, lanes=LANES)
    return dataclasses.replace(
        net,
        weights=tuple(jnp.asarray(w).T for w in net.weights[:-1]) + (net.weights[-1],),
        hidden_kmajor=True,
    )
