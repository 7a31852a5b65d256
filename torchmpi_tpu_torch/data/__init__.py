"""The input data plane of the port: the counterpart of
``torchmpi_tpu/data``.

* :mod:`.staging` — ``Staged`` and ``stage_rank_major``, the one
  host-to-device placement contract (this rank's row of a rank-major
  batch), and ``HostScratchPool``, the pinned buffers it reuses;
* :mod:`.host` — ``HostStage``: bounded multi-worker host-side production
  with deterministic order, exception propagation and leak-free
  abandonment;
* :mod:`.device` — ``DeviceStage``: pinned host buffers, a side CUDA
  stream and an event per batch, ``depth`` batches in flight, and the
  staged bytes and wait time in ``StageStats``;
* :mod:`.pipeline` — ``DataPipeline`` and ``engine_wrap``, the engine's
  knob-gated input adapter (``data_pipeline``: ``off``, ``on``, ``auto``).

Dataset loading (``load_mnist``, ``synthetic_mnist``) and the epoch sharder
(``ShardedIterator``) stay in ``utils/data.py``: they are the sources this
plane moves batches from.
"""

from .device import DeviceStage, StageStats
from .host import HostStage, HostStageIterator
from .pipeline import DataPipeline, engine_wrap, knob_defaults
from .staging import HostScratchPool, Staged, stage_rank_major

__all__ = [
    "DataPipeline",
    "DeviceStage",
    "HostScratchPool",
    "HostStage",
    "HostStageIterator",
    "StageStats",
    "Staged",
    "engine_wrap",
    "knob_defaults",
    "stage_rank_major",
]
