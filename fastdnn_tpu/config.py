"""Engine configuration.

The reference scatters its knobs across hardcoded constants and method
defaults (SURVEY.md §5 "Config / flag system"):
  - weight cutoff 3.0   (/root/reference/src/java/suskun/nn/QuantizedDnn.java:68-70,
                         /root/reference/src/cpp/dnn.cc:60)
  - batch size 10 (calculate) / 8 (lazy, CLI)
                        (QuantizedDnn.java:149-151,100-102; dnn.cc:66)
  - alignment 4 (input) / 16 (hidden)  (README.md:22)
  - sigmoid LUT: 1280 entries at 0.01 resolution, activation scale 255
                        (/root/reference/src/cpp/dnn.h:23-26)
  - weight scale 127    (/root/reference/src/cpp/dnn.cc:98)

Here they are one frozen dataclass, beside the engine's own knobs
(backend selection, frame-bucket rounding, lazy-output strategy).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Literal

WEIGHT_SCALE = 127.0
ACTIVATION_SCALE = 255.0
SIGMOID_LOOKUP_SIZE = 1280
SIGMOID_HALF_LOOKUP_SIZE = SIGMOID_LOOKUP_SIZE // 2
SIGMOID_RESOLUTION = 100.0  # LUT index = round(x * 100)

DEFAULT_CUTOFF = 3.0
DEFAULT_INPUT_ALIGNMENT = 4
DEFAULT_HIDDEN_ALIGNMENT = 16


#: the compile cache's fixed place inside the checkout (see
#: enable_compilation_cache); .gitignore lists it
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache for CLI/server/benchmark cold starts.

    JAX's persistent cache reuses compiled executables across processes,
    cutting restart latency to disk-read time.  Directory resolution:

      JAX_COMPILATION_CACHE_DIR set  -> that directory (JAX reads the
                                        variable itself; nothing is set here)
      FASTDNN_COMPILE_CACHE=0        -> disabled (the tests' off switch)
      otherwise                      -> DEFAULT_CACHE_DIR, inside the checkout
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if os.environ.get("FASTDNN_COMPILE_CACHE") == "0":
        return
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the scoring engine."""

    # Quantization ---------------------------------------------------------
    #: clamp |w| above this before per-layer linear quantization
    cutoff: float = DEFAULT_CUTOFF

    # Compute path ---------------------------------------------------------
    #: "pallas" = the int8 hidden layers run as the fused Pallas/Triton
    #: kernel (ops.hidden_kernel; GPU only, or interpret=True anywhere),
    #: everything else as XLA; "xla" = pure jnp/XLA ops; "auto" = pallas on
    #: a GPU, xla elsewhere.
    backend: Literal["auto", "pallas", "xla"] = "auto"
    #: run the Pallas kernel in interpreter mode (CPU debugging / tests)
    interpret: bool = False
    #: matmul precision of the float input layer, the only non-int8 matmul
    #: (/root/reference/src/cpp/dnn.cc:217-218).  "highest" is exact f32,
    #: like the reference.  On an H100 "high" runs the dot in TF32 (about 3
    #: decimal digits) and changed 3.3% of the last hidden layer's int8
    #: activations on the flagship net, for 16% less device time per
    #: 8192-frame batch (PERF.md); it stays an explicit opt-in.
    input_precision: Literal["highest", "high", "default"] = "highest"

    #: store an int4 hidden trunk as two-nibbles-per-byte int8 and unpack
    #: in the program (quant.quantize.pack_int4_trunk) instead of shipping
    #: jnp.int4 arrays to the compiler.  Bitwise-identical math and the
    #: same halved weight bytes.  No effect on int8 nets.
    int4_packed: bool = False

    # Batching -------------------------------------------------------------
    #: frame counts are padded up to a multiple of this before jit so that
    #: streams of utterances reuse a small set of compiled shapes.
    frame_bucket: int = 128
    #: emit posteriors as bfloat16: halves device->host transfer and
    #: consumer bandwidth for decoders that accept bf16 scores.  Error is
    #: bf16 rounding concentrated away from the softmax mass; off by
    #: default for bit-parity.
    fast_posteriors: bool = False

    # Lazy / masked output -------------------------------------------------
    #: "reference" reproduces the reference softmax-over-zeros semantics for
    #: inactive senones (/root/reference/src/cpp/dnn.cc:369-389);
    #: "active_only" renormalizes over active senones instead.
    lazy_semantics: Literal["reference", "active_only"] = "reference"
    #: masked-output strategy: "dense" always runs the full output matmul
    #: with post-masking; "gathered" computes only the union of active
    #: senone columns (single-device; for output layers so large that the
    #: full weight read dominates); "auto" is dense.  Which wins on the GPU
    #: at decoder batch sizes and densities is not measured yet.
    lazy_mode: Literal["auto", "dense", "gathered"] = "auto"
    #: capacity (fraction of output nodes) for the gathered lazy matmul;
    #: unions above it raise (explicit "gathered" mode only).
    lazy_capacity: float = 0.6

    def resolve_backend(self, platform: str) -> str:
        """The backend to run on `platform` (jax.devices()[0].platform).

        The Pallas kernel compiles for GPUs only; anywhere else it runs
        only in interpreter mode, and asking for it without that raises.
        """
        if self.backend == "auto":
            return "pallas" if platform == "gpu" else "xla"
        if self.backend == "pallas" and platform != "gpu" and not self.interpret:
            raise ValueError(
                f"backend='pallas' compiles for GPUs only (platform is "
                f"{platform!r}); use backend='xla' or interpret=True"
            )
        return self.backend
