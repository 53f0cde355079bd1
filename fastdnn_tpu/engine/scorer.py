"""Scoring engine: jitted end-to-end forward passes over a QuantizedNet.

Replaces the reference's CalculationContext + JNI + Java API layers
(SURVEY.md §2 #8, #15, #16) with three jitted programs:

  * `score(frames)`            — full posteriors, like QuantizedDnn.calculate
                                 (/root/reference/src/java/suskun/nn/
                                 QuantizedDnn.java:149-167)
  * `score_masked(frames, masks)` — the whole lazy path in ONE device call:
                                 the reference crosses JNI once per frame
                                 (README.md:45); here masks are a
                                 [frames, out] array and the masked output
                                 layer runs batched on the device
  * `LazyContext`              — API-parity shim over score_masked for
                                 decoders that feed masks frame by frame
                                 (QuantizedDnn.java:72-107)

There is no per-call mutable context: XLA owns all buffers, so one Scorer is
trivially shareable across threads (the reference needs a per-call
CalculationContext to be thread-safe, MultiThreadedStressTest.java:48-61).

Frame counts are bucketed (padded up to `config.frame_bucket`) so streaming
workloads hit a small set of compiled shapes — jit-friendly static shapes
instead of the reference's arbitrary-length batch loops.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..ops import hidden_kernel
from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet
from ..utils.align import aligned_size


def _default_platform() -> str:
    return jax.devices()[0].platform


def hidden_forward(
    net: QuantizedNet,
    frames: jax.Array,
    input_precision: str = "highest",
    interpret: bool = False,
):
    """Input layer + all hidden layers -> shifted-int8 activations [B, H].

    Equivalent of CalculateUntilLastHiddenLayer (/root/reference/src/cpp/
    dnn.cc:402-424), minus the in-place shift/scale (fused at quantize time).
    A net prepared for the fused GPU kernel (`net.hidden_kmajor`, see
    ops.hidden_kernel.prepare_net) runs its hidden layers there, in
    interpreter mode when `interpret`; any other net runs them as XLA ops.
    """
    acts = xops.input_layer_step(frames, net.input_w, net.input_b, input_precision)
    for i in range(len(net.weights) - 1):
        args = (acts, net.weights[i], net.colsum128[i], net.inv_scales[i], net.biases[i])
        if net.hidden_kmajor:
            acts = hidden_kernel.hidden_layer(*args, interpret=interpret)
        elif net.packed_int4 and net.weights[i].shape[0] * 2 == acts.shape[-1]:
            # packed-nibble int4 weights are [K/2, N] (pack_int4_trunk)
            acts = xops.hidden_layer_step_packed(*args)
        else:
            acts = xops.hidden_layer_step(*args)
    return acts


def output_logits(net: QuantizedNet, acts: jax.Array) -> jax.Array:
    return xops.output_logits(
        acts, net.weights[-1], net.colsum128[-1], net.inv_scales[-1], net.biases[-1]
    )


def _finish_posteriors(p: jax.Array, fast: bool) -> jax.Array:
    return p.astype(jnp.bfloat16) if fast else p


def score_fn(
    net: QuantizedNet,
    frames: jax.Array,
    *,
    interpret: bool = False,
    out_dim: Optional[int] = None,
    input_precision: str = "highest",
    fast_posteriors: bool = False,
):
    """Full forward pass -> posteriors f32 [B, out] (bf16 with
    fast_posteriors).  Jittable.

    `out_dim` slices away padding columns (pad_qnet) before the softmax —
    padded logits are exactly 0.0 and must not join the denominator.
    Defaults to the net's own true senone count (QuantizedNet.output_dim,
    static metadata set by pad_qnet), so padded nets are safe without
    callers threading the count through.
    """
    if out_dim is None:
        out_dim = net.output_dim
    acts = hidden_forward(net, frames, input_precision, interpret)
    logits = output_logits(net, acts)
    if out_dim != logits.shape[-1]:
        logits = logits[:, :out_dim]
    return _finish_posteriors(jax.nn.softmax(logits, axis=-1), fast_posteriors)


def masked_posteriors(logits, masks, semantics: str) -> jax.Array:
    """Lazy-output softmax of f32 logits under `semantics` (masks nonzero =
    active senone)."""
    mask_bool = masks != 0
    if semantics == "reference":
        return xops.masked_softmax_reference(logits, mask_bool)
    return xops.masked_softmax_active_only(logits, mask_bool)


def score_masked_fn(
    net: QuantizedNet,
    frames: jax.Array,
    masks: jax.Array,
    *,
    interpret: bool = False,
    semantics: str = "reference",
    out_dim: Optional[int] = None,
    input_precision: str = "highest",
    fast_posteriors: bool = False,
):
    """Lazy/masked forward pass -> posteriors f32 [B, out].  Jittable.

    masks: [B, out], nonzero = senone active for that frame (the reference's
    byte mask, /root/reference/src/java/suskun/nn/QuantizedDnn.java:88-93).
    """
    if out_dim is None:
        out_dim = net.output_dim
    acts = hidden_forward(net, frames, input_precision, interpret)
    logits = output_logits(net, acts)
    if out_dim != logits.shape[-1]:
        logits = logits[:, :out_dim]
    return _finish_posteriors(masked_posteriors(logits, masks, semantics), fast_posteriors)


class Scorer:
    """User-facing engine around one immutable QuantizedNet.

    Thread-safe by construction: all state is immutable; jitted executables
    are cached per input shape.

    `mesh` (a jax.sharding.Mesh with axes ("data", "model"), see
    parallel.mesh.make_mesh) turns the same API multi-device: frames are
    data-parallel, the output layer is tensor-parallel, and every public
    method — score / score_masked / score_utterances / LazyContext —
    produces posteriors equal to the single-device engine.  The sharded
    programs run the same per-shard stack under shard_map with explicit
    pmax/psum softmax collectives (parallel.sharded.make_mesh_programs).
    The gathered small-batch lazy path is single-device only (its
    host-side union indexing does not shard); lazy_mode="auto" is dense.
    """

    def __init__(
        self,
        net: QuantizedNet,
        config: Optional[EngineConfig] = None,
        mesh=None,
    ):
        self.config = config or EngineConfig()
        self.mesh = mesh
        self._backend = self.config.resolve_backend(_default_platform())
        self._output_dim = net.output_dim
        self._input_dim = net.input_dim
        if mesh is not None:
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            self._data_size = mesh.shape[DATA_AXIS]
            model_size = mesh.shape[MODEL_AXIS]
            if self.config.lazy_mode == "gathered":
                raise ValueError(
                    "lazy_mode='gathered' is single-device only; use "
                    "'dense' or 'auto' with a mesh"
                )
        else:
            self._data_size = 1
            model_size = 1
        if model_size > 1 and net.padded_output_dim % model_size:
            from ..quant.quantize import pad_qnet

            # the output layer splits evenly over the model axis
            net = pad_qnet(net, out_lanes=model_size)
        if self._backend == "pallas":
            net = hidden_kernel.prepare_net(net)
        if self.config.int4_packed:
            from ..quant.quantize import pack_int4_trunk

            # AFTER padding: packing first would split the nibble halves
            # at the wrong (unpadded) K
            net = pack_int4_trunk(net)
        if mesh is not None:
            from ..parallel.mesh import shard_qnet

            net = shard_qnet(net, mesh)
        else:
            # Commit the weights to the device ONCE: quantize/pack/pad run in
            # host numpy (quant.quantize INT4 note), and a numpy leaf passed
            # as a jit argument would re-upload on every call.
            net = jax.device_put(net)
        self.net = net
        kw = dict(
            interpret=self.config.interpret,
            out_dim=self._output_dim,
            input_precision=self.config.input_precision,
            fast_posteriors=self.config.fast_posteriors,
        )
        if mesh is not None:
            from ..parallel.sharded import make_mesh_programs

            (
                self._score,
                self._score_masked,
                self._hidden,
                self._masked_from_acts,
            ) = make_mesh_programs(
                mesh, net, semantics=self.config.lazy_semantics, **kw
            )
            self._gathered = None
            self._gather_capacity = 0
            return
        self._score = jax.jit(functools.partial(score_fn, **kw))
        self._score_masked = jax.jit(
            functools.partial(score_masked_fn, semantics=self.config.lazy_semantics, **kw)
        )
        self._hidden = jax.jit(
            functools.partial(
                hidden_forward,
                input_precision=self.config.input_precision,
                interpret=self.config.interpret,
            )
        )
        self._masked_from_acts = jax.jit(
            functools.partial(
                self._masked_from_acts_fn,
                semantics=self.config.lazy_semantics,
                out_dim=self._output_dim,
            )
        )
        self._gather_capacity = min(
            aligned_size(max(int(self._output_dim * self.config.lazy_capacity), 1), 128),
            self._output_dim,
        )
        from . import lazy as _lazy

        self._gathered = jax.jit(
            functools.partial(
                _lazy.gathered_output_posteriors,
                out_dim=self._output_dim,
                semantics=self.config.lazy_semantics,
            )
        )

    @staticmethod
    def _masked_from_acts_fn(net, acts, masks, *, semantics, out_dim):
        logits = output_logits(net, acts)
        if out_dim != logits.shape[-1]:
            logits = logits[:, :out_dim]
        return masked_posteriors(logits, masks, semantics)

    # -- helpers ------------------------------------------------------------

    @property
    def input_dim(self) -> int:
        return self._input_dim

    @property
    def output_dim(self) -> int:
        """True (unpadded) senone count."""
        return self._output_dim

    def _prepare(self, frames) -> tuple[jax.Array, int]:
        """Validate dims, pad feature dim with zeros and bucket the frame
        count to a compiled shape.  Returns (padded frames, true count)."""
        frames = jnp.asarray(frames, dtype=jnp.float32)
        if frames.ndim != 2:
            raise ValueError(f"frames must be [n, dim], got shape {frames.shape}")
        n, dim = frames.shape
        if dim > self.input_dim:
            raise ValueError(
                f"input vector size {dim} must be <= network input size {self.input_dim}"
            )
        if dim < self.net.input_dim:  # zero-pad like the x4 alignment path
            frames = jnp.pad(frames, ((0, 0), (0, self.net.input_dim - dim)))
        # under a mesh every data shard must still get a full jit bucket
        bucket = aligned_size(max(n, 1), self.config.frame_bucket * self._data_size)
        if bucket != n:
            frames = jnp.pad(frames, ((0, bucket - n), (0, 0)))
        return frames, n

    def _pad_masks(self, masks, pad_n: int) -> np.ndarray:
        """[n, output_dim] host masks -> the width the masked program wants
        (the padded output width under a mesh; extra columns are inactive
        and excluded from the softmax as padding anyway)."""
        width = self.net.padded_output_dim if self.mesh is not None else self._output_dim
        out = np.zeros((pad_n, width), dtype=np.uint8)
        out[: masks.shape[0], : self._output_dim] = masks != 0
        return out

    def _finish(self, out, n: int) -> np.ndarray:
        """Device posteriors -> host [n, output_dim] f32 (slices away frame
        bucketing and, under a model-sharded mesh, padding columns)."""
        arr = np.asarray(out[:n], dtype=np.float32)
        if arr.shape[1] != self._output_dim:
            arr = arr[:, : self._output_dim]
        return arr

    # -- public API ----------------------------------------------------------

    def score(self, frames) -> np.ndarray:
        """Posteriors f32 [n, out] for a frame batch."""
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 2 and frames.shape[0] == 0:
            return np.zeros((0, self.output_dim), np.float32)
        padded, n = self._prepare(frames)
        out = self._score(self.net, padded)
        return self._finish(out, n)

    def score_device(self, frames: jax.Array) -> jax.Array:
        """Device-resident variant (no host transfers, no padding).

        Width caveat: on a model-sharded mesh (model > 1) the returned
        posteriors keep the padded output width ([B, padded_output_dim],
        padded columns exactly 0) — slicing to the true senone count would
        force a cross-shard reshard, defeating the no-transfer point of this
        API.  Single-device and model=1 programs return [B, output_dim].
        Host-side score()/score_masked() always slice via _finish().
        """
        return self._score(self.net, frames)

    def score_masked(self, frames, masks) -> np.ndarray:
        """Lazy path, whole utterance at once: masks [n, out] (nonzero=active).

        Strategy per config.lazy_mode: the dense masked matmul unless
        "gathered" is explicitly configured.
        """
        frames = np.asarray(frames, dtype=np.float32)
        masks = np.asarray(masks)
        if masks.shape != (frames.shape[0], self.output_dim):
            raise ValueError(
                f"masks must be [n={frames.shape[0]}, out={self.output_dim}], got {masks.shape}"
            )
        padded, n = self._prepare(frames)
        pad_n = padded.shape[0]
        masks_p = self._pad_masks(masks, pad_n)
        if self._use_gathered(n, masks_p):
            from .lazy import union_active_indices

            idx, _ = union_active_indices(masks_p, self._gather_capacity)
            acts = self._hidden(self.net, padded)
            out = self._gathered(self.net, acts, jnp.asarray(masks_p), jnp.asarray(idx))
        else:
            out = self._score_masked(self.net, padded, jnp.asarray(masks_p))
        return self._finish(out, n)

    def _use_gathered(self, n_frames: int, masks: np.ndarray) -> bool:
        mode = self.config.lazy_mode
        if mode != "gathered" or self.mesh is not None:
            # "auto" resolves to dense; gathered runs only on explicit
            # request (config.lazy_mode)
            return False
        union = int(masks.any(axis=0).sum())
        if union > self._gather_capacity:
            raise ValueError(
                f"active union {union} exceeds gather capacity "
                f"{self._gather_capacity}; raise config.lazy_capacity or "
                "use lazy_mode='dense'"
            )
        return True

    def score_utterances(self, utterances):
        """Score many utterances in one device pass.

        Frames are independent (pure MLP over spliced features, SURVEY.md §5)
        so utterances are concatenated into a single frame batch — one padded
        shape, one jit call — and split back.  Accepts a dict {id: [n, dim]}
        or a list of [n, dim] arrays; returns the same container shape.
        """
        keys = None
        if isinstance(utterances, dict):
            keys = list(utterances.keys())
            mats = [np.asarray(utterances[k], np.float32) for k in keys]
        else:
            mats = [np.asarray(u, np.float32) for u in utterances]
        if not mats:
            return {} if keys is not None else []
        counts = [m.shape[0] for m in mats]
        out = self.score(np.concatenate(mats, axis=0))
        splits = np.split(out, np.cumsum(counts)[:-1])
        if keys is not None:
            return dict(zip(keys, splits))
        return list(splits)

    def _score_masked_from_acts(self, acts: jax.Array, masks: np.ndarray) -> np.ndarray:
        """Posteriors for a few rows of stored last-hidden activations.

        Pads rows to what the compiled program needs (divisible by the data
        axis under a mesh) and
        masks to the program's output width, then slices both back.
        """
        b = acts.shape[0]
        rows = aligned_size(b, self._data_size)
        if acts.shape[0] != rows:
            acts = jnp.pad(acts, ((0, rows - b), (0, 0)))
        masks_p = self._pad_masks(np.asarray(masks), rows)
        out = self._masked_from_acts(self.net, acts, jnp.asarray(masks_p))
        return self._finish(out, b)

    def new_lazy_context(self, input_vector_count: int) -> "LazyContext":
        """API-parity with QuantizedDnn.getNewLazyContext
        (/root/reference/src/java/suskun/nn/QuantizedDnn.java:100-107)."""
        return LazyContext(self, input_vector_count)


class LazyContext:
    """Frame-by-frame lazy scoring, mirroring the reference LazyContext
    (/root/reference/src/java/suskun/nn/QuantizedDnn.java:72-98):
    `calculate_until_output(frames)` runs everything up to the last hidden
    layer once and retains the activations; each
    `calculate_for_output_nodes(mask)` scores one frame's active senones.

    For throughput prefer Scorer.score_masked — this shim pays one device
    call per frame, the same control-flow shape whose JNI version costs the
    reference its lazy win (README.md:45).
    """

    def __init__(self, scorer: Scorer, input_vector_count: int):
        self._scorer = scorer
        self.input_vector_count = input_vector_count
        self.current_vector_index = 0
        self._acts: Optional[jax.Array] = None

    def calculate_until_output(self, frames) -> None:
        frames = np.asarray(frames, dtype=np.float32)
        if frames.shape[0] != self.input_vector_count:
            raise ValueError(
                f"expected {self.input_vector_count} frames, got {frames.shape[0]}"
            )
        padded, _ = self._scorer._prepare(frames)
        self._acts = self._scorer._hidden(self._scorer.net, padded)
        self.current_vector_index = 0  # context is reusable across utterances

    def calculate_for_output_nodes(self, mask) -> np.ndarray:
        """Posteriors f32 [out] for the next frame given its active-node mask."""
        if self._acts is None:
            raise RuntimeError("call calculate_until_output first")
        i = self.current_vector_index
        if i >= self.input_vector_count:
            raise IndexError("all frames already consumed")
        mask = (np.asarray(mask).reshape(1, -1) != 0).astype(np.uint8)
        acts_i = jax.lax.dynamic_slice_in_dim(self._acts, i, 1, axis=0)
        if self._scorer._use_gathered(1, mask):
            from .lazy import union_active_indices

            idx, _ = union_active_indices(mask, self._scorer._gather_capacity)
            out = self._scorer._gathered(
                self._scorer.net, acts_i, jnp.asarray(mask), jnp.asarray(idx)
            )
            res = np.asarray(out[0])
        else:
            res = self._scorer._score_masked_from_acts(acts_i, mask)[0]
        self.current_vector_index += 1
        return res
