"""Observability: throughput counters and profiler hooks.

The reference's only tracing is wall-clock prints (SURVEY.md §5).  Here:
  * `Throughput` — rolling audio-seconds/s and frames/s counters for serving
  * `trace` — context manager around jax.profiler for TensorBoard traces
  * `device_kernel_events` — device kernel durations of one call, from a trace
  * `Timer` — the plain wall-clock the reference used, for CLIs
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

FRAMES_PER_AUDIO_SECOND = 100.0


class Timer:
    """Wall-clock timer (std::chrono analog, /root/reference/src/cpp/dnn.cc:62-73)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @property
    def ms(self) -> float:
        return self.elapsed * 1e3


@dataclass
class Throughput:
    """Rolling throughput counter for a scoring service.

    `batches` counts device dispatches, so frames/batches is the mean
    batch fill — the one number that says whether cross-utterance packing
    (engine/stream.py) is actually amortizing device calls under load.
    """

    frames: int = 0
    batches: int = 0
    seconds: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, n_frames: int) -> None:
        now = time.perf_counter()
        self.seconds = now - self._t0
        self.frames += n_frames
        self.batches += 1

    def frames_per_s(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0

    def audio_seconds_per_s(self) -> float:
        return self.frames_per_s() / FRAMES_PER_AUDIO_SECOND

    def mean_batch_fill(self) -> float:
        """Mean frames per device dispatch (1 utterance = O(100) frames;
        fill >> one utterance's frames means packing is working)."""
        return self.frames / self.batches if self.batches else 0.0

    def reset(self) -> None:
        self.frames = 0
        self.batches = 0
        self.seconds = 0.0
        self._t0 = time.perf_counter()


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope; view with TensorBoard's profile plugin."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_kernel_events(fn) -> dict:
    """Device kernels of one call of `fn` (which must return a JAX array):
    {kernel name: [duration in ns, ...]} from a profiler trace of the GPU
    planes.  `fn` runs once untraced first, so compilation stays out."""
    import glob
    import os
    import shutil
    import tempfile

    from jax.profiler import ProfileData

    fn().block_until_ready()
    d = tempfile.mkdtemp()
    try:
        with trace(d):
            fn().block_until_ready()
        events: dict = {}
        for path in glob.glob(os.path.join(d, "plugins", "profile", "*", "*.xplane.pb")):
            for plane in ProfileData.from_file(path).planes:
                if plane.name.startswith("/device:GPU"):
                    for line in plane.lines:
                        for e in line.events:
                            events.setdefault(e.name, []).append(e.duration_ns)
        return events
    finally:
        shutil.rmtree(d, ignore_errors=True)
