"""Device mesh construction and sharding layouts.

The reference has no distributed components at all (SURVEY.md §2, "none
exist") — its only concurrency is threads sharing one immutable model.  The
multi-device scaling design (BASELINE.json north star) is:

  * axis "data":  utterance/frame batches are data-parallel
  * axis "model": the output layer (8000+ senones) is tensor-parallel —
    weight matrix sharded on its node dim, posteriors combined with XLA
    collectives between the devices

Hidden layers are replicated (40 MB int8 for the 7x2048 net — cheap) so the
only per-step collectives are on the output layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over the given (default: all) devices.

    With `data=None`, the data axis absorbs all devices not used by `model`.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.array(devices).reshape(data, model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def init_multihost(coordinator_address: Optional[str] = None, **kwargs) -> None:
    """Initialize JAX's multi-host runtime (DCN-level data parallelism).

    Thin wrapper over jax.distributed.initialize so CLIs can expose it as a
    flag; a no-op when running single-process.
    """
    if coordinator_address is None and not kwargs:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address, **kwargs)


def qnet_specs(qnet):
    """PartitionSpecs for a QuantizedNet pytree: hidden layers replicated,
    output layer (last entry of weights/colsum128/biases) sharded over
    MODEL_AXIS on the node dim.  Static fields are kept, so the specs share
    the net's treedef."""
    n = len(qnet.weights)
    rep = P()
    return dataclasses.replace(
        qnet,
        input_w=rep,
        input_b=rep,
        weights=tuple([rep] * (n - 1) + [P(None, MODEL_AXIS)]),
        colsum128=tuple([rep] * (n - 1) + [P(MODEL_AXIS)]),
        biases=tuple([rep] * (n - 1) + [P(MODEL_AXIS)]),
        inv_scales=tuple([rep] * n),
        multipliers=tuple([rep] * n),
    )


def qnet_shardings(mesh: Mesh):
    """NamedShardings for a QuantizedNet pytree on `mesh` (qnet_specs)."""

    def build(qnet):
        return jax.tree_util.tree_map(
            lambda spec: NamedSharding(mesh, spec), qnet_specs(qnet),
            is_leaf=lambda x: isinstance(x, P),
        )

    return build


def shard_qnet(qnet, mesh: Mesh):
    """Place a QuantizedNet on the mesh with the layout above.

    Works on multi-process meshes too: every process holds the same host
    net (deterministic load), and each materializes only its addressable
    shards.
    """
    shardings = qnet_shardings(mesh)(qnet)
    if len(mesh.devices.flat) == len([d for d in mesh.devices.flat if d.process_index == jax.process_index()]):
        return jax.device_put(qnet, shardings)

    def place(leaf, sharding):
        arr = np.asarray(leaf)
        return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])

    return jax.tree_util.tree_map(place, qnet, shardings)


def frames_sharding(mesh: Mesh) -> NamedSharding:
    """Frame batches shard over the data axis, features replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, None))


def shard_frames(frames, mesh: Mesh):
    return jax.device_put(frames, frames_sharding(mesh))
