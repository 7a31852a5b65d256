"""Pipeline composition: knobs -> host stage -> device stage -> engine.

Counterpart of ``torchmpi_tpu/data/pipeline.py``.  This module owns every
``data_*`` knob read, so the stages themselves take explicit parameters and
touch no global state.

:class:`DataPipeline` is the user-facing form::

    it = DataPipeline(ShardedIterator(ds, batch, p), mpi.stack.current())
    engine.train(params, it, epochs=...)

:func:`engine_wrap` is the engine's entry: ``train()`` and ``test()`` pass
every compiled-mode iterator through it, and the ``data_pipeline`` knob
decides (``off``: the iterator comes back untouched; ``on``: always wrap;
``auto``: wrap unless the iterator already is a pipeline or a list of
pre-staged pairs).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .device import DeviceStage
from .host import HostStage
from .staging import Staged

__all__ = ["DataPipeline", "engine_wrap", "knob_defaults"]

_PIPELINE_MODES = ("off", "on", "auto")


def knob_defaults() -> dict:
    """The ``data_*`` knobs as one dict (the one place they are read)."""
    from ..runtime import config

    return {
        "pipeline": str(config.get("data_pipeline")),
        "prefetch_depth": int(config.get("data_prefetch_depth")),
        "host_workers": int(config.get("data_host_workers")),
        "host_depth": int(config.get("data_host_depth")),
        "reuse_host_buffers": bool(config.get("data_reuse_host_buffers")),
    }


class DataPipeline:
    """Host stage -> device stage over any rank-major batch iterable.

    ``source`` yields ``(x: (p, b, ...), y: (p, b))`` host batches
    (``ShardedIterator``, a list, ...).  Iterating yields engine-ready
    ``(Staged, Staged)`` pairs: this rank's row of each batch on
    ``device``, produced ``depth`` steps ahead of the consumer by
    background threads.  Where the JAX ``DataPipeline`` takes the mesh to
    shard over, this one takes the communicator (``comm``, default the
    current one), whose rank picks the row, and the device (default the
    one ``lifecycle.start`` bound).

    Geometry defaults come from the ``data_*`` knobs; explicit arguments
    override (None: the knob).  ``transform`` runs per batch on the host
    stage (with ``workers`` > 0, on a reordering worker pool; the order is
    deterministic either way)."""

    def __init__(self, source, comm=None, device=None,
                 depth: Optional[int] = None, cast=None,
                 transform: Optional[Callable[[Any], Any]] = None,
                 workers: Optional[int] = None,
                 host_depth: Optional[int] = None):
        from ..runtime import communicator, lifecycle

        knobs = knob_defaults()
        comm = comm if comm is not None else communicator.stack.current()
        device = (lifecycle.device() if device is None
                  else torch.device(device))
        self.source = source
        depth = knobs["prefetch_depth"] if depth is None else int(depth)
        if transform is None and workers is not None and int(workers) > 0:
            # Explicit misuse fails as HostStage would; the knob alone is
            # inert without a transform (there is no host work to spread).
            raise ValueError("workers > 0 requires a transform to run on "
                             "them (plain production is inherently serial)")
        if transform is None:
            workers = 0
        elif workers is None:
            workers = knobs["host_workers"]
        else:
            workers = int(workers)
        host_depth = (knobs["host_depth"] if host_depth is None
                      else int(host_depth))
        staged_source = source
        # The host stage earns its thread only with host work to run ahead
        # of staging (a transform); bare sources go straight to the device
        # stage, whose producer already pulls them ahead of compute.
        self.host: Optional[HostStage] = None
        if transform is not None:
            self.host = HostStage(source, depth=max(1, host_depth),
                                  workers=workers, transform=transform)
            staged_source = self.host
        self.device = DeviceStage(
            staged_source, device, comm.rank, depth=max(1, depth), cast=cast,
            reuse_host_buffers=(knobs["reuse_host_buffers"]
                                and device.type == "cuda"))

    @property
    def stats(self):
        """The latest iteration pass's :class:`~.device.StageStats`."""
        return self.device.stats

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        return iter(self.device)


def _looks_prestaged(it) -> bool:
    """True for a materialized sequence whose batches are already
    ``Staged`` pairs (peeks ``it[0]`` of sequences only, so no iterator is
    consumed)."""
    if not isinstance(it, (list, tuple)) or not it:
        return False
    first = it[0]
    return (isinstance(first, (list, tuple)) and len(first) >= 1
            and isinstance(first[0], Staged))


def engine_wrap(iterator, comm, device, cast=None):
    """The engine's compiled-mode input adapter, by the ``data_pipeline``
    knob:

    * ``"off"``: the iterator passes through untouched, and the engine
      stages each batch itself inside the step;
    * ``"on"``: every iterator that is not already a pipeline or device
      stage is wrapped (pre-staged ``Staged`` batches pass through the
      stage unchanged, so forcing the pipeline is always correct);
    * ``"auto"``: like ``"on"``, but a list of pre-staged pairs (nothing
      to overlap) comes back untouched instead of paying a thread.
    """
    from ..runtime import config

    mode = str(config.get("data_pipeline"))
    if mode not in _PIPELINE_MODES:
        raise ValueError(
            f"data_pipeline must be one of {_PIPELINE_MODES}, got {mode!r}")
    if mode == "off":
        return iterator
    if isinstance(iterator, (DataPipeline, DeviceStage)):
        return iterator
    if mode == "auto" and _looks_prestaged(iterator):
        return iterator
    return DataPipeline(iterator, comm, device, cast=cast)
