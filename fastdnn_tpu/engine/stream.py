"""Streaming scorer: cross-utterance batching with pipelined dispatch.

The production serving shape this replaces in the reference is "many Java
threads, each with a private CalculationContext, each paying a JNI round
trip per call" (/root/reference/src/java/suskun/nn/QuantizedDnn.java:149-167,
test/java/suskun/nn/MultiThreadedStressTest.java).  On an accelerator the
economics invert: one big device batch beats many small private ones, so
the streaming engine

  * collects utterances from any number of producer threads,
  * packs them into frame batches up to `max_batch_frames` (padding only to
    the engine's jit bucket, so a steady stream compiles a handful of
    shapes),
  * dispatches asynchronously — JAX dispatch returns before the device
    finishes, so batch N+1 is assembled and transferred while batch N
    computes (double buffering falls out of the runtime), and
  * resolves a `Future` per utterance with its slice of the posteriors.

Frames of distinct utterances are independent (pure MLP over spliced
features, SURVEY.md §5 "Long-context"), which is what makes cross-utterance
packing sound.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.timer import Throughput
from .scorer import Scorer

__all__ = ["StreamingScorer"]


class _Item:
    __slots__ = ("frames", "masks", "future")

    def __init__(self, frames, masks, future):
        self.frames = frames
        self.masks = masks
        self.future = future


_CLOSE = object()


class StreamingScorer:
    """Batches utterances across submitters and scores them in one stream.

    Usage:
        ss = StreamingScorer(scorer)
        fut = ss.submit(frames)              # frames [n, dim] float32
        fut = ss.submit(frames, masks)       # lazy path, masks [n, out]
        posteriors = fut.result()            # [n, out] float32
        ss.close()

    Thread-safe; any number of threads may submit.  Masked and unmasked
    submissions are batched in separate groups (they compile to different
    programs).  `throughput` exposes rolling frames/s / audio-s/s.
    """

    def __init__(
        self,
        scorer: Scorer,
        *,
        max_batch_frames: int = 8192,
        max_wait_ms: float = 3.0,
        max_queue: int = 1024,
    ):
        if max_batch_frames < 1:
            raise ValueError("max_batch_frames must be >= 1")
        self._scorer = scorer
        self._max_frames = max_batch_frames
        self._max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.throughput = Throughput()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._carry: Optional[_Item] = None  # worker-private push-back slot
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def output_dim(self) -> int:
        """Senone count of the wrapped engine (wire-protocol mask width)."""
        return self._scorer.output_dim

    @property
    def input_dim(self) -> int:
        """Feature width of the wrapped engine."""
        return self._scorer.input_dim

    # -- producer side -------------------------------------------------------

    def submit(self, frames, masks=None) -> "Future[np.ndarray]":
        """Enqueue one utterance; returns a Future of posteriors [n, out]."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("StreamingScorer is closed")
            return self._submit_locked(frames, masks)

    def _submit_locked(self, frames, masks) -> "Future[np.ndarray]":
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        if frames.ndim != 2:
            raise ValueError(f"frames must be [n, dim], got {frames.shape}")
        if frames.shape[0] > self._max_frames:
            raise ValueError(
                f"utterance of {frames.shape[0]} frames exceeds "
                f"max_batch_frames={self._max_frames}; split it"
            )
        if masks is not None:
            masks = (np.asarray(masks) != 0).astype(np.uint8)
            if masks.shape != (frames.shape[0], self.output_dim):
                raise ValueError(
                    f"masks must be [{frames.shape[0]}, {self.output_dim}]"
                )
        fut: "Future[np.ndarray]" = Future()
        self._q.put(_Item(frames, masks, fut))
        return fut

    def close(self, wait: bool = True) -> None:
        """Stop accepting work; drain the queue (if wait) and join."""
        with self._submit_lock:
            if self._closed:
                return
            # under the lock no submit() can slip an item behind the
            # sentinel, so everything enqueued before close() is processed
            self._closed = True
            self._q.put(_CLOSE)
        if wait:
            self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- consumer side --------------------------------------------------------

    def _take_group(self) -> Optional[List[_Item]]:
        """Collect compatible items (same masked-ness) up to max_batch_frames,
        waiting at most max_wait for stragglers after the first arrival.

        Push-backs (an incompatible/overflowing item, or the close sentinel)
        go to worker-private slots — never back onto the shared queue, which
        could block forever when producers keep it full (the worker is the
        only consumer)."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            first = self._q.get()
        if first is _CLOSE:
            return None
        group = [first]
        total = first.frames.shape[0]
        masked = first.masks is not None
        deadline = _now() + self._max_wait
        while total < self._max_frames:
            timeout = deadline - _now()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is _CLOSE:
                self._carry = _CLOSE  # re-deliver for the outer loop
                break
            if (item.masks is not None) != masked or (
                total + item.frames.shape[0] > self._max_frames
            ):
                # incompatible or overflowing: carry over, dispatch now
                self._carry = item
                break
            group.append(item)
            total += item.frames.shape[0]
        return group

    def _run(self) -> None:
        pending: List[Tuple[List[_Item], Sequence[int], object]] = []
        while True:
            group = self._take_group()
            if group is None:
                for g, counts, out in pending:
                    self._resolve(g, counts, out)
                return
            counts = [it.frames.shape[0] for it in group]
            frames = np.concatenate([it.frames for it in group], axis=0)
            try:
                if group[0].masks is not None:
                    masks = np.concatenate([it.masks for it in group], axis=0)
                    out = self._dispatch_masked(frames, masks)
                else:
                    # async dispatch; materialize AFTER assembling the next
                    # batch by deferring the np conversion to _resolve
                    out = self._dispatch(frames)
            except Exception as e:  # propagate to every waiter in the group
                for it in group:
                    it.future.set_exception(e)
                continue
            pending.append((group, counts, out))
            # resolve all batches whose results exist; the newest dispatch
            # stays in flight while we wait on older ones
            while len(pending) > 1:
                g, c, o = pending.pop(0)
                self._resolve(g, c, o)
            if self._q.empty() and pending:
                g, c, o = pending.pop(0)
                self._resolve(g, c, o)

    def _dispatch(self, frames: np.ndarray):
        """Async dispatch: returns the device array without blocking."""
        padded, n = self._scorer._prepare(frames)
        out = self._scorer._score(self._scorer.net, padded)
        return (out, n)

    def _dispatch_masked(self, frames: np.ndarray, masks: np.ndarray):
        """Async masked dispatch: BOTH strategies return the in-flight
        device array, so masked streams keep the double-buffering (the
        gathered branch's union-index build is host-side, but the device
        call it feeds still overlaps the next batch's assembly)."""
        sc = self._scorer
        masks = (masks != 0).astype(np.uint8)
        padded, n = sc._prepare(frames)
        masks_p = sc._pad_masks(masks, padded.shape[0])
        import jax.numpy as jnp

        if sc._use_gathered(frames.shape[0], masks_p):
            from .lazy import union_active_indices

            idx, _ = union_active_indices(masks_p, sc._gather_capacity)
            acts = sc._hidden(sc.net, padded)
            out = sc._gathered(sc.net, acts, jnp.asarray(masks_p), jnp.asarray(idx))
        else:
            out = sc._score_masked(sc.net, padded, jnp.asarray(masks_p))
        return (out, n)

    def _resolve(self, group, counts, out) -> None:
        """Materialize one batch's result and settle its futures.

        Materialization can raise (device errors are deferred to the first
        np.asarray), and a waiter may have cancelled its future — neither
        may kill the worker thread, which all other futures depend on."""
        try:
            if isinstance(out, tuple):
                dev, n = out
                arr = self._scorer._finish(dev, n)
            else:
                arr = out
        except Exception as e:
            for it in group:
                if not it.future.cancelled():
                    it.future.set_exception(e)
            return
        self.throughput.add(int(sum(counts)))
        offsets = np.cumsum([0] + list(counts))
        for it, a, b in zip(group, offsets[:-1], offsets[1:]):
            if not it.future.cancelled():
                it.future.set_result(arr[a:b])


def _now() -> float:
    return time.perf_counter()
