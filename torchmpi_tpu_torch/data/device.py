"""Device stage: background host-to-device staging that overlaps the step.

Counterpart of ``torchmpi_tpu/data/device.py``.  A producer thread pulls
each rank-major batch, copies this rank's row into a pinned host buffer,
issues the host-to-device copy on a side CUDA stream and records an event
after it, up to ``depth`` batches ahead of the consumer.  The consumer
makes its current stream wait on that event before it hands the tensors
out, and records that stream on them for the caching allocator (they were
allocated on the side stream).  A pinned buffer goes back into use only
once its copy's event has completed (:class:`~.staging.HostScratchPool`).
On the CPU each batch is staged synchronously on the producer thread: the
staged tensor shares the host array's memory.

Yields ``(Staged, Staged)`` pairs, labels as int64 (the index type of
PyTorch's gathers, as the engine's synchronous path stages them); the
x-side ``Staged`` carries ``wait_s``, how long the consumer blocked for
the pair.  Producer exceptions surface on the consumer, an abandoned
iterator releases its thread promptly, and the bounded queue means a slow
consumer holds at most ``depth + 2`` staged batches (queue, producer's
hand, consumer's hand) of device memory.  The per-batch numbers accumulate
in :class:`StageStats`, and under the live-feed gate
(``obs/serve.metrics_feed``) every consumed batch publishes
``tmpi_data_staged_bytes_total``, ``tmpi_data_batches_total``,
``tmpi_data_wait_seconds_total``, the ``tmpi_data_stage_seconds``
histogram and the ``tmpi_data_input_overlap_fraction`` gauge through
``obs/serve.publish_input``, as the JAX package's stage does.
"""

from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from typing import Any, Optional

import torch

from .host import _DONE, _bounded_get, _bounded_put
from .staging import HostScratchPool, Staged, stage_rank_major

__all__ = ["DeviceStage", "StageStats"]


def _produce(source, device, rank, cast, scratch, stream, q: _queue.Queue,
             stop: threading.Event) -> None:
    """Producer thread body: module-level over the shared primitives on
    purpose (a bound-method target would keep the iterator alive through
    its own thread; see :mod:`.host`)."""
    try:
        ctx = (torch.cuda.device(device) if device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            for batch in source:
                xb, yb = batch
                t0 = time.monotonic()
                sx, ex = stage_rank_major(xb, device, rank, dtype=cast,
                                          scratch=scratch, stream=stream)
                sy, ey = stage_rank_major(yb, device, rank,
                                          dtype=torch.long, scratch=scratch,
                                          stream=stream)
                stage_s = time.monotonic() - t0
                nbytes = int(sx.array.nbytes) + int(sy.array.nbytes)
                # One stream: the event after y's copy covers x's too.
                event = ey if ey is not None else ex
                if not _bounded_put(q, stop, (sx, sy, event, nbytes,
                                              stage_s)):
                    return
                if stop.is_set():
                    return
    except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
        _bounded_put(q, stop, e)
        return
    _bounded_put(q, stop, _DONE)


class StageStats:
    """Per-iteration staging totals (one instance per ``iter()`` pass; the
    owning :class:`DeviceStage` keeps the latest as ``.stats``)."""

    def __init__(self) -> None:
        self.batches = 0
        self.staged_bytes = 0
        self.stage_s = 0.0      # producer time inside stage_rank_major
        self.wait_s = 0.0       # consumer block time in __next__
        self.interval_s = 0.0   # consumer wall time spanned by fetches

    def overlap_fraction(self) -> float:
        """Fraction of the consumer's inter-fetch wall time the input plane
        did not block it: 1.0 is a perfectly hidden input plane."""
        if self.interval_s <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.wait_s / self.interval_s))

    def snapshot(self) -> dict:
        return {
            "batches": self.batches,
            "staged_bytes": self.staged_bytes,
            "staged_bytes_per_batch": (
                self.staged_bytes // self.batches if self.batches else 0),
            "stage_s": self.stage_s,
            "wait_s": self.wait_s,
            "interval_s": self.interval_s,
            "overlap_fraction": self.overlap_fraction(),
        }


class DeviceStage:
    """Wraps a rank-major batch iterator, staging rank ``rank``'s row of
    each batch onto ``device`` from a background thread, ``depth`` batches
    ahead of compute.

    ``cast`` converts the images to another dtype on the host, into the
    pinned buffer.  ``reuse_host_buffers`` takes the pinned buffers from a
    :class:`HostScratchPool` (the pipeline turns it off on the CPU).
    ``publish`` (default: the live-feed gate) controls the per-batch
    registry feed."""

    def __init__(self, it, device, rank: int, depth: int = 2, cast=None,
                 reuse_host_buffers: bool = False,
                 publish: Optional[bool] = None):
        self.it = it
        self.device = torch.device(device)
        self.rank = int(rank)
        self.depth = max(1, int(depth))
        self.cast = cast
        self.reuse_host_buffers = bool(reuse_host_buffers)
        self.publish = publish
        self.stats = StageStats()

    def __len__(self):
        return len(self.it)

    def __iter__(self) -> "DeviceStageIterator":
        self.stats = StageStats()
        return DeviceStageIterator(self)


class DeviceStageIterator:
    """One epoch's live staging iterator (the lifecycle of
    :class:`~.host.HostStageIterator`)."""

    def __init__(self, stage: DeviceStage):
        self._device = stage.device
        self._stats = stage.stats
        self._publish = stage.publish
        self._stop = threading.Event()
        # maxsize=depth staged pairs queued; with the pair in the
        # producer's hand and the one the consumer holds, in-flight device
        # batches are bounded at depth + 2.
        self._q: _queue.Queue = _queue.Queue(maxsize=stage.depth)
        self._exhausted = False
        self._last_fetch: Optional[float] = None
        cuda = stage.device.type == "cuda"
        # Two pinned buffers (x, y) for each of the depth + 2 batches.
        scratch = (HostScratchPool(2 * (stage.depth + 2))
                   if stage.reuse_host_buffers and cuda else None)
        stream = torch.cuda.Stream(device=stage.device) if cuda else None
        self._thread = threading.Thread(
            target=_produce,
            args=(stage.it, stage.device, stage.rank, stage.cast, scratch,
                  stream, self._q, self._stop),
            daemon=True, name="tmpi-data-device")
        self._thread.start()

    def __iter__(self) -> "DeviceStageIterator":
        return self

    def __next__(self):
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        t0 = time.monotonic()
        item = _bounded_get(self._q, self._stop, self._thread)
        now = time.monotonic()
        if item is _DONE:
            self._exhausted = True
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            self.close()
            raise item
        sx, sy, event, nbytes, stage_s = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            sx.array.record_stream(consumer)
            sy.array.record_stream(consumer)
        wait_s = now - t0
        stats = self._stats
        stats.batches += 1
        stats.staged_bytes += nbytes
        stats.stage_s += stage_s
        stats.wait_s += wait_s
        if self._last_fetch is not None:
            stats.interval_s += now - self._last_fetch
        else:
            # First fetch: the pipeline had the whole warm-up to work in;
            # count only the measured wait, so a cold start does not read
            # as free overlap.
            stats.interval_s += wait_s
        self._last_fetch = now
        publish = self._publish
        if publish is None:
            from ..obs import serve as _serve
            publish = _serve.metrics_feed()
        if publish:
            from ..obs import serve as _serve
            _serve.publish_input(
                staged_bytes=nbytes, stage_s=stage_s, wait_s=wait_s,
                overlap_fraction=stats.overlap_fraction())
        return (Staged(sx.array, wait_s=wait_s), sy)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    def __del__(self):  # pragma: no cover - exercised via the leak test
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __enter__(self) -> "DeviceStageIterator":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
