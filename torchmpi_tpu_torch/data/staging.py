"""Device staging: the one host-to-device placement contract.

Counterpart of ``torchmpi_tpu/data/staging.py``.  There a rank-major batch
``(p, b, ...)`` becomes one global array sharded over the mesh; here each
process is one rank, so staging puts **this rank's row** ``(b, ...)`` on
its device.  The engine's synchronous path and the data pipeline's device
stage both place a batch through :func:`stage_rank_major`, so pipeline on
and off cannot differ in layout or values.

On a CUDA device the row is copied into a pinned host buffer, then to the
device with a non-blocking copy on the caller's stream (the device stage
passes a side stream), and an event is recorded after it; the consumer
makes its own stream wait on that event before it reads the tensor.  On
the CPU the "copy" is the host array itself, as ``device_put`` aliases
host memory on JAX's CPU backend: there is nothing to reuse or wait for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Staged", "stage_rank_major", "HostScratchPool"]


@dataclasses.dataclass(frozen=True)
class Staged:
    """A batch tensor already on this rank's device: its row ``(b, ...)``
    of a rank-major batch.  The engine takes a ``Staged`` as it is; every
    bare array takes the full staging path.

    ``wait_s``: seconds the consumer blocked waiting for this batch to come
    out of the pipeline (0.0 for a synchronously staged one)."""

    array: torch.Tensor
    wait_s: float = 0.0


def _row(a, rank: int) -> torch.Tensor:
    """Rank ``rank``'s row of a rank-major host array, as a CPU tensor that
    shares its memory."""
    if isinstance(a, torch.Tensor):
        return a[rank]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rank]))


def stage_rank_major(a, device: torch.device, rank: int, dtype=None,
                     scratch: Optional["HostScratchPool"] = None,
                     stream=None) -> Tuple[Staged, Optional[object]]:
    """Rank ``rank``'s row of the rank-major batch ``a`` on ``device``, in
    ``dtype`` (default: its own), as ``(Staged, event)``.

    On a CUDA device the row goes through a pinned host buffer (from
    ``scratch`` when given) and a non-blocking copy on ``stream`` (default:
    the current one); ``event`` is recorded on that stream after the copy,
    and ``scratch`` keeps the buffer until it has completed.  On the CPU
    the result shares the host array's memory (converted when ``dtype``
    differs) and ``event`` is None.  A ``Staged`` input passes through."""
    if isinstance(a, Staged):
        return a, None
    row = _row(a, rank)
    dtype = row.dtype if dtype is None else dtype
    if device.type != "cuda":
        return Staged(row.to(device, dtype)), None
    host = (scratch.take(row.shape, dtype) if scratch is not None else
            torch.empty(row.shape, dtype=dtype, pin_memory=True))
    host.copy_(row)
    stream = torch.cuda.current_stream(device) if stream is None else stream
    with torch.cuda.stream(stream):
        out = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    if scratch is not None:
        scratch.track(host, event)
    return Staged(out), event


class HostScratchPool:
    """Bounded pool of pinned host buffers for the device stage's copies.

    A buffer goes back into use only once the event recorded after the copy
    that last read it has completed (``query()``): reusing it mid-copy
    would corrupt the batch in flight.  On the CPU the pipeline keeps the
    pool off (``data_reuse_host_buffers``), since the staged tensor there
    is the host memory itself.

    Not thread-safe by design: one pool per device-stage producer."""

    def __init__(self, capacity: int = 4):
        self.capacity = max(1, int(capacity))
        # [buffer, event | None]; a slot whose event has not completed is
        # untouchable.
        self._slots: list = []
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _ready(event) -> bool:
        return event is None or bool(event.query())

    def take(self, shape, dtype) -> torch.Tensor:
        """A pinned buffer of ``shape`` and ``dtype``: a free one from the
        pool, else a new allocation."""
        shape = torch.Size(shape)
        for slot in self._slots:
            buf, event = slot
            if (buf.shape == shape and buf.dtype == dtype
                    and self._ready(event)):
                slot[1] = None   # re-armed by track() after the copy
                self.hits += 1
                return buf
        self.misses += 1
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def track(self, buf: torch.Tensor, event) -> None:
        """Lock ``buf`` until ``event`` completes.  A buffer the pool does
        not hold yet is adopted while capacity lasts."""
        for slot in self._slots:
            if slot[0] is buf:
                slot[1] = event
                return
        if len(self._slots) < self.capacity:
            self._slots.append([buf, event])
