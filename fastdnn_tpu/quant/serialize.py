"""QuantizedNet serialization — the quantized-model checkpoint.

The reference's durable artifact is the float binary model; quantization is
redone at every load (/root/reference/src/cpp/jni_dnn.cc:7-18).  For serving
it is better to persist the quantized net itself: int8 weights are 4x
smaller on disk and load straight onto the device with no quantization pass.
Format: a single .npz with a version stamp (numpy is the portable container;
no new dependency).

The float model keeps using the reference-compatible binary format
(fastdnn_tpu/formats/binary.py) so artifacts interop with the reference.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .quantize import INT4, QuantizedNet

FORMAT_VERSION = 1


def save_qnet(qnet: QuantizedNet, path) -> None:
    """Persist a QuantizedNet to `path` (.npz)."""
    if qnet.packed_int4:
        raise ValueError(
            "save the unpacked net: packed-nibble weights would persist as "
            "plain int8 and load with the wrong meaning (packing is a "
            "runtime storage choice — EngineConfig.int4_packed)"
        )
    n = len(qnet.weights)
    arrays = {
        "format_version": np.int32(FORMAT_VERSION),
        "n_quantized_layers": np.int32(n),
        # -1 encodes "width is the true senone count" (no padding)
        "true_output_dim": np.int32(
            -1 if qnet.true_output_dim is None else qnet.true_output_dim
        ),
        "input_w": np.asarray(qnet.input_w),
        "input_b": np.asarray(qnet.input_b),
    }
    for i in range(n):
        w = qnet.weights[i]
        # npz has no 4-bit container: int4 layers ride as int8 values with a
        # bits marker and are re-narrowed on load (absent marker = int8,
        # so version-1 checkpoints stay readable)
        bits = 4 if w.dtype == jnp.int4 else 8
        arrays[f"w_{i}"] = np.asarray(w).astype(np.int8)
        arrays[f"bits_{i}"] = np.int32(bits)
        arrays[f"colsum_{i}"] = np.asarray(qnet.colsum128[i])
        arrays[f"b_{i}"] = np.asarray(qnet.biases[i])
        arrays[f"inv_scale_{i}"] = np.asarray(qnet.inv_scales[i])
        arrays[f"mult_{i}"] = np.asarray(qnet.multipliers[i])
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_quantized(path, cutoff: float = 3.0, hidden_bits: "int | None" = None):
    """Load EITHER model artifact the CLIs accept:

      *.npz       — a pre-quantized QuantizedNet checkpoint (save_qnet):
                    loads straight to device, no quantization pass
      anything else — a reference-format binary float model, quantized on
                    load with `cutoff` (what the reference does every load,
                    /root/reference/src/cpp/jni_dnn.cc:7-18); hidden_bits=4
                    selects the int4 hidden trunk

    hidden_bits=None (the default) means "whatever the artifact stores" for
    a checkpoint and int8 for a float model; an EXPLICIT 4 or 8 is a hard
    requirement, raising when a checkpoint's stored bits don't match —
    silently scoring the other trunk width would misreport every downstream
    accuracy/speed comparison.

    Returns (qnet, description string for the CLI topology banner).
    """
    if str(path).endswith(".npz"):
        if cutoff != 3.0:
            import warnings

            warnings.warn(
                f"cutoff={cutoff} has no effect on a pre-quantized .npz "
                "checkpoint (weights were quantized when it was saved); "
                "re-quantize from the float binary model to change cutoff",
                stacklevel=2,
            )
        qnet = load_qnet(path)
        dims = "-".join(str(d) for d in [qnet.input_dim] + qnet.layer_dims())
        stored_int4 = any(w.dtype == jnp.int4 for w in qnet.weights)
        kind = "int4-trunk" if stored_int4 else "int8"
        stored_bits = 4 if stored_int4 else 8
        if hidden_bits is not None and hidden_bits != stored_bits:
            raise ValueError(
                f"hidden_bits={hidden_bits} requested but {path} is a "
                f"pre-quantized {kind} checkpoint (stored bits markers say "
                f"{stored_bits}); quantization happened at save time — "
                "re-quantize from the float binary model to change the "
                "trunk width"
            )
        return qnet, f"{dims} ({kind} checkpoint)"
    from ..formats.binary import read_model
    from ..models.feedforward import from_raw

    from .quantize import quantize_net

    raw = read_model(path)
    qnet = quantize_net(
        from_raw(raw), cutoff=cutoff, hidden_bits=hidden_bits or 8
    )
    return qnet, raw.topology()


def load_qnet(path) -> QuantizedNet:
    """Load a QuantizedNet saved by `save_qnet`."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported qnet format version {version}")
        n = int(z["n_quantized_layers"])
        true_out = None
        if "true_output_dim" in z and int(z["true_output_dim"]) >= 0:
            true_out = int(z["true_output_dim"])
        return QuantizedNet(
            true_output_dim=true_out,
            input_w=jnp.asarray(z["input_w"]),
            input_b=jnp.asarray(z["input_b"]),
            weights=tuple(
                # int4 re-narrows on the HOST (ml_dtypes numpy): device s4
                # must never materialize eagerly (quant.quantize INT4 note)
                z[f"w_{i}"].astype(INT4)
                if f"bits_{i}" in z and int(z[f"bits_{i}"]) == 4
                else jnp.asarray(z[f"w_{i}"], jnp.int8)
                for i in range(n)
            ),
            colsum128=tuple(jnp.asarray(z[f"colsum_{i}"]) for i in range(n)),
            biases=tuple(jnp.asarray(z[f"b_{i}"]) for i in range(n)),
            inv_scales=tuple(jnp.asarray(z[f"inv_scale_{i}"]) for i in range(n)),
            multipliers=tuple(jnp.asarray(z[f"mult_{i}"]) for i in range(n)),
        )
