"""Sharded scoring: data-parallel frames x tensor-parallel output layer.

Three layers of API, all returning posteriors equal to the single-device
engine:

  * `make_mesh_programs` — the PRODUCTION path, used by
    `engine.Scorer(..., mesh=...)`: jitted `shard_map` programs running the
    engine's per-shard stack (the fused hidden kernel where the net was
    prepared for it, XLA otherwise) with hand-placed collectives
    (pmax/psum over the model axis) for the globally-exact softmax.
    shard_map sees per-shard local arrays, so the only cross-device
    traffic is the two scalar-per-frame softmax collectives.
  * `score_shard_map` — the standalone explicit-collective scorer over raw
    arrays (didactic/verification surface for the same body).
  * `make_gspmd_scorer` — `jax.jit` with NamedShardings; XLA's SPMD
    partitioner inserts the collectives.  For plain (XLA-path) nets: a
    `pallas_call` is opaque to the partitioner, so use the shard_map paths
    for nets prepared for the fused kernel.

Softmax across a node-sharded output layer needs a global max and a global
sum (SURVEY.md §5 "Multi-host numerics"): with logits z sharded over
MODEL_AXIS,

    m = pmax(max(z_local));  s = psum(sum(exp(z_local - m)))
    softmax = exp(z_local - m) / s

which is exact (not approximate) across shardings.  Masked (lazy) semantics
compose the same way because the reference's zero-logit convention
(/root/reference/src/cpp/dnn.cc:369-389) is just a different z.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 public API, else experimental
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..engine.scorer import (
    hidden_forward,
    masked_posteriors,
    output_logits,
    score_fn,
    score_masked_fn,
)
from ..quant.quantize import QuantizedNet
from .mesh import DATA_AXIS, MODEL_AXIS, frames_sharding, qnet_shardings, qnet_specs


def _valid_cols(n_local: int, out_dim: int | None):
    """Per-shard boolean [1, n_local]: True where the global column index is
    a real senone, False on padding columns (pad_qnet) — those
    must not join the softmax max/denominator (score_fn slices them off in
    the single-device engine; here they live on the last shard)."""
    if out_dim is None:
        return None
    shard = jax.lax.axis_index(MODEL_AXIS)
    col = shard * n_local + jax.lax.broadcasted_iota(jnp.int32, (1, n_local), 1)
    return col < out_dim


def _sharded_softmax(z_local: jax.Array, valid=None) -> jax.Array:
    """Exact softmax over an output axis sharded on MODEL_AXIS."""
    NEG = jnp.float32(-1e30)
    if valid is not None:
        z_local = jnp.where(valid, z_local, NEG)
    m_local = jnp.max(z_local, axis=-1, keepdims=True)
    m = jax.lax.pmax(m_local, MODEL_AXIS)
    e = jnp.exp(z_local - m)
    if valid is not None:
        e = jnp.where(valid, e, 0.0)
    s = jax.lax.psum(jnp.sum(e, axis=-1, keepdims=True), MODEL_AXIS)
    return e / s


def _sharded_posteriors_from_logits(z, masks, valid, semantics):
    """Masked/unmasked collective softmax on local logit shards.

    Runs INSIDE shard_map.  masks: local [B, n_local] (nonzero = active) or
    None.  Reproduces the single-device semantics exactly: reference keeps
    zero logits for inactive senones in the denominator (dnn.cc:369-389),
    active_only renormalizes and emits all-zero rows for fully-masked frames.
    """
    if masks is None:
        return _sharded_softmax(z, valid)
    mask_bool = masks != 0
    if valid is not None:
        mask_bool = mask_bool & valid
    if semantics == "reference":
        z = jnp.where(mask_bool, z, 0.0)
        return _sharded_softmax(z, valid)
    neg = jnp.float32(-1e30)
    zm = jnp.where(mask_bool, z, neg)
    m = jax.lax.pmax(jnp.max(zm, axis=-1, keepdims=True), MODEL_AXIS)
    e = jnp.where(mask_bool, jnp.exp(zm - m), 0.0)
    s = jax.lax.psum(jnp.sum(e, axis=-1, keepdims=True), MODEL_AXIS)
    # a fully-masked frame has s == 0; emit an all-zero row instead
    # of NaN, matching masked_softmax_active_only and the kernels
    return e / jnp.maximum(s, jnp.finfo(jnp.float32).tiny)


# ---------------------------------------------------------------------------
# Production mesh programs (engine.Scorer(mesh=...))
# ---------------------------------------------------------------------------

def make_mesh_programs(
    mesh: Mesh,
    net: QuantizedNet,
    *,
    out_dim: int,
    semantics: str = "reference",
    interpret: bool = False,
    input_precision: str = "highest",
    fast_posteriors: bool = False,
):
    """Jitted shard_map programs for mesh-backed Scorers over `net` (its
    layer count and static layout flags fix the programs' specs).

    Returns (score, score_masked, hidden, masked_from_acts):
      score(net, frames)                -> posteriors
      score_masked(net, frames, masks)  -> posteriors (masks at FULL padded
                                           output width)
      hidden(net, frames)               -> last-hidden int8 activations
      masked_from_acts(net, acts, masks)-> posteriors from stored activations

    With model=1 the bodies run the complete single-device program per data
    shard and emit [B, out_dim].  With model>1 the output layer runs as a
    per-shard logits pass plus the exact collective softmax, emitting the
    padded width [B, N_padded] sharded over (data, model); padding columns
    are 0.
    """
    model = mesh.shape[MODEL_AXIS]
    net_spec = qnet_specs(net)
    fspec = P(DATA_AXIS, None)
    kw = dict(interpret=interpret, input_precision=input_precision)

    def hidden_body(net, frames):
        return hidden_forward(net, frames, input_precision, interpret)

    if model == 1:
        out_spec = P(DATA_AXIS, None)
        mask_spec = P(DATA_AXIS, None)

        def score_body(net, frames):
            return score_fn(
                net, frames, out_dim=out_dim, fast_posteriors=fast_posteriors, **kw
            )

        def masked_body(net, frames, masks):
            # masks arrive at the padded width for API uniformity;
            # score_masked_fn wants the true senone count
            return score_masked_fn(
                net, frames, masks[:, :out_dim], out_dim=out_dim,
                semantics=semantics, fast_posteriors=fast_posteriors, **kw,
            )

        def from_acts_body(net, acts, masks):
            z = output_logits(net, acts)[:, :out_dim]
            return masked_posteriors(z, masks[:, :out_dim], semantics)

    else:
        out_spec = P(DATA_AXIS, MODEL_AXIS)
        mask_spec = P(DATA_AXIS, MODEL_AXIS)

        def _out(net, acts, masks):
            # fast_posteriors on a model-sharded mesh: the cross-shard
            # softmax (stats, collectives, normalize) stays exact in f32;
            # only the final posterior write narrows to bf16
            z = output_logits(net, acts)
            p = _sharded_posteriors_from_logits(
                z, masks, _valid_cols(z.shape[-1], out_dim), semantics
            )
            return p.astype(jnp.bfloat16) if fast_posteriors else p

        def score_body(net, frames):
            return _out(net, hidden_body(net, frames), None)

        def masked_body(net, frames, masks):
            return _out(net, hidden_body(net, frames), masks)

        def from_acts_body(net, acts, masks):
            return _out(net, acts, masks)

    def _wrap(body, in_specs, out_specs):
        # check_vma=False: the static replication checker cannot see through
        # pallas_call/score_fn internals to prove outputs replicated over an
        # unused model axis; the specs here are replication-correct by
        # construction (model=1 bodies never touch the model axis, model>1
        # bodies emit genuinely model-sharded posteriors).
        return jax.jit(
            shard_map(
                body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False,
            )
        )

    score = _wrap(score_body, (net_spec, fspec), out_spec)
    score_masked = _wrap(masked_body, (net_spec, fspec, mask_spec), out_spec)
    hidden = _wrap(hidden_body, (net_spec, fspec), P(DATA_AXIS, None))
    masked_from_acts = _wrap(
        from_acts_body, (net_spec, P(DATA_AXIS, None), mask_spec), out_spec
    )
    return score, score_masked, hidden, masked_from_acts


# ---------------------------------------------------------------------------
# GSPMD path
# ---------------------------------------------------------------------------

def make_gspmd_scorer(
    mesh: Mesh,
    *,
    interpret: bool = False,
    out_dim: Optional[int] = None,
    semantics: str = "reference",
    input_precision: str = "highest",
    fast_posteriors: bool = False,
):
    """Returns jitted (score, score_masked) over the mesh.

    The returned callables take (qnet, frames[, masks]) already or not yet
    device_put — jit moves them per the declared shardings either way.
    Engine knobs pass through to score_fn/score_masked_fn.  For a net
    prepared for the fused kernel the partitioner must gather operands
    around the opaque pallas_call — prefer Scorer(mesh=...) /
    score_shard_map there (module docstring).
    """
    fs = frames_sharding(mesh)
    out_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    mask_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    engine_kw = dict(
        interpret=interpret,
        out_dim=out_dim,
        input_precision=input_precision,
        fast_posteriors=fast_posteriors,
    )
    # jit executables are cached per net STRUCTURE (the in_shardings pytree
    # depends on the layer count): building a fresh jax.jit wrapper per call
    # would retrace + recompile every invocation.
    _cache: dict = {}

    def _jitted(kind: str, qnet: QuantizedNet):
        key = (kind, jax.tree_util.tree_structure(qnet))
        if key not in _cache:
            net_sh = qnet_shardings(mesh)(qnet)
            if kind == "score":
                _cache[key] = jax.jit(
                    functools.partial(score_fn, **engine_kw),
                    in_shardings=(net_sh, fs),
                    out_shardings=out_sharding,
                )
            else:
                _cache[key] = jax.jit(
                    functools.partial(score_masked_fn, semantics=semantics, **engine_kw),
                    in_shardings=(net_sh, fs, mask_sharding),
                    out_shardings=out_sharding,
                )
        return _cache[key]

    def score(qnet, frames):
        return _jitted("score", qnet)(qnet, frames)

    def score_masked(qnet, frames, masks):
        return _jitted("masked", qnet)(qnet, frames, masks)

    return score, score_masked


# ---------------------------------------------------------------------------
# Explicit shard_map path (standalone, raw-array surface)
# ---------------------------------------------------------------------------

#: jitted shard_map programs, keyed on everything that changes the trace.
#: LRU-bounded: a long-running service cycling through many batch shapes
#: must not accumulate compiled executables without limit.
_SHARD_MAP_CACHE: "OrderedDict" = OrderedDict()
_SHARD_MAP_CACHE_MAX = 64


def _cache_get(key, build):
    if key in _SHARD_MAP_CACHE:
        _SHARD_MAP_CACHE.move_to_end(key)
        return _SHARD_MAP_CACHE[key]
    val = build()
    _SHARD_MAP_CACHE[key] = val
    while len(_SHARD_MAP_CACHE) > _SHARD_MAP_CACHE_MAX:
        _SHARD_MAP_CACHE.popitem(last=False)
    return val


def score_shard_map(
    qnet: QuantizedNet,
    frames: jax.Array,
    mesh: Mesh,
    *,
    masks: Optional[jax.Array] = None,
    interpret: bool = False,
    semantics: str = "reference",
    out_dim: Optional[int] = None,
    input_precision: str = "highest",
) -> jax.Array:
    """Explicit-collective scoring.  frames [B, in] with B divisible by the
    data axis; output dim must be divisible by the model axis (pad the net
    with pad_qnet(out_lanes=model) if needed — the padded net carries its
    true senone count, so padding columns stay out of the softmax
    automatically).  Returns posteriors [B, out_padded] sharded
    (data, model); columns at or beyond out_dim are exactly 0.
    """
    if out_dim is None:
        # pad_qnet stamps the true senone count on the net; fall back to it
        # so padded zero-logit columns never join the softmax denominator
        # by default (width == count for unpadded nets).
        out_dim = qnet.output_dim
    net_spec = qnet_specs(qnet)
    in_specs = [net_spec, P(DATA_AXIS, None)]
    args = [qnet, frames]
    if masks is not None:
        in_specs.append(P(DATA_AXIS, MODEL_AXIS))
        args.append(masks)

    def body(net, local_frames, *rest):
        acts = hidden_forward(net, local_frames, input_precision, interpret)
        z = output_logits(net, acts)
        valid = _valid_cols(z.shape[-1], out_dim)
        return _sharded_posteriors_from_logits(
            z, rest[0] if rest else None, valid, semantics
        )

    key = (
        mesh,
        jax.tree_util.tree_structure(qnet),
        tuple(w.shape for w in qnet.weights),
        frames.shape,
        masks is not None,
        interpret,
        semantics,
        out_dim,
        input_precision,
    )
    return _cache_get(
        key,
        lambda: jax.jit(
            shard_map(
                body,
                mesh=mesh,
                in_specs=tuple(in_specs),
                out_specs=P(DATA_AXIS, MODEL_AXIS),
            )
        ),
    )(*args)
