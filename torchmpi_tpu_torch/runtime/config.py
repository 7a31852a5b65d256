"""Tunable runtime constants of the port: one typed registry.

The port's own copy of the knobs its modules read, under the JAX package's
names, defaults and environment variables, so that ``docs/config.md``
stays the one registry of both packages.  Only the knobs of the ported
modules are here: the span tracer (``obs_trace``, ``obs_span_capacity``),
the event journal (``journal_*``), the serving plane (``serve_*``), the
collective selector and the ring collectives (``use_pallas_collectives``,
``small_allreduce_size_gpu``, the buffer geometry), the communicators'
splits and the hierarchical collectives (``use_hierarchical_collectives``,
``use_cartesian_communicators``, ``use_tree_communicators``), the host
plane's rings (``small_allreduce_size_cpu``, ``bcast_size_tree_based``,
``*_buffer_size_cpu``, ``deadlock_timeout_seconds``, ``hc_*``), the async collectives
(``num_async_collectives_in_flight``), gradient bucketing
(``gradient_bucket_bytes``) and the engine's asynchronous gradient sync
(``engine_async_drain``, ``sync_gradient_frequency``), the tensor-parallel
wire (``manual_wire_dtype``), the input data plane
(``data_*``, read only by ``data/pipeline.py:knob_defaults``) and the
logger's level (``verbose``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable


def _env(name: str, default: Any, cast: Callable[[str], Any]) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Constants:
    """The ported modules' knobs (see ``docs/config.md``)."""

    # --- collectives ---
    # Hierarchical (intra group, then across groups) vs flat collectives:
    # the selector's multi-node cells and the *_hierarchical dispatchers
    # (collectives/hierarchical.py) read it.
    use_hierarchical_collectives: bool = True
    # Cartesian (equal groups: one inter group per intra position) vs tree
    # (one group of the intra roots) splits; read by every Communicator
    # when it is made (runtime/communicator.py).
    use_cartesian_communicators: bool = True
    use_tree_communicators: bool = False
    # Prefer the hand-written ring collectives (collectives/cuda_ring.py)
    # over torch.distributed's; the engine's compiled mode then syncs its
    # gradients through them.
    use_pallas_collectives: bool = False
    # Small-message cutoff in ELEMENTS: at or below it the ring namespace
    # hands a collective to torch.distributed; the engine rings leaves of
    # at least this many elements on their own.
    small_allreduce_size_gpu: int = 1 << 16
    # Ring geometry: sub-chunk bytes within [min, max] and staging slots
    # per ring (capped by the second knob and by 2(p-1)).
    min_buffer_size: int = 1 << 17
    max_buffer_size: int = 1 << 20
    num_buffers_per_collective: int = 3
    max_num_buffers_per_collective_tpu: int = 16

    # --- host plane (the hostcomm TCP rings, collectives/hostcomm.py) ---
    # Small-message cutoff in ELEMENTS: at or below it a ring allreduce or
    # reduce moves the message as one piece.
    small_allreduce_size_cpu: int = 1 << 16
    # At or below this many bytes a ring broadcast moves as one piece;
    # above it, in pieces of the buffer geometry below.
    bcast_size_tree_based: int = 1 << 22
    # Transfer piece bytes within [min, max], one per in-flight buffer
    # (num_buffers_per_collective buffers a message).
    min_buffer_size_cpu: int = 1 << 17
    max_buffer_size_cpu: int = 1 << 18
    # Progress-warning interval of a ring wait: a peer making no progress
    # for this long prints a deadlock warning and the wait goes on.
    deadlock_timeout_seconds: float = 10.0
    # Hard no-progress deadline per blocking ring wait, in ms: past it the
    # collective raises HostcommTimeout.  0 waits forever.
    hc_io_deadline_ms: int = _env("TORCHMPI_TPU_HC_IO_DEADLINE_MS", 0, int)
    # CRC32 trailer on every ring data frame, checked on receive
    # (HostcommCorruption on a mismatch); every rank of a ring must agree.
    hc_frame_crc: bool = _env_bool("TORCHMPI_TPU_HC_FRAME_CRC", False)
    # Gradient bucketing: leaves fuse into flat buckets of at most this
    # many bytes, by dtype, in tree order (nn/bucketing.py).
    gradient_bucket_bytes: int = 32 * 1024 * 1024

    # --- mesh paths (parallel/tp.py, models/llama.py) ---
    # Wire dtype of the tensor-parallel sums (the Megatron f/g pair and the
    # vocab-sharded loss's dh): "auto" (f32 off a TPU, the JAX package's
    # rule), "bfloat16" or "float32".
    manual_wire_dtype: str = _env("TORCHMPI_TPU_MANUAL_WIRE_DTYPE",
                                  "auto", str)

    # --- async collectives and the engine's eager_async mode ---
    # Outstanding async handles before the in-flight registry waits them
    # all (runtime/handles.py).
    num_async_collectives_in_flight: int = 1 << 20
    # How eager_async drains its bucket allreduces: "ready" updates each
    # bucket's parameters as soon as its collective completes, in ready
    # order (nn.async_.drain_at_optimizer); "barrier" waits every bucket,
    # then updates.  The parameters are the same either way.
    engine_async_drain: str = "ready"
    # The async backward syncs gradients every N steps; the steps between
    # update with this rank's own gradients.
    sync_gradient_frequency: int = 1

    # --- input data plane (data/: host stage -> device stage -> engine;
    # every read goes through data/pipeline.py:knob_defaults) ---
    # Engine input adapter (engine_wrap, compiled mode only): "off" hands
    # the iterator back untouched (the engine copies each batch itself,
    # inside the step); "on" wraps every train()/test() iterator that is
    # not already a pipeline in DataPipeline; "auto" is "on" except that a
    # list of pre-staged Staged pairs passes through.
    data_pipeline: str = _env("TORCHMPI_TPU_DATA_PIPELINE", "auto", str)
    # Staged batches the device stage keeps queued beyond the one the
    # consumer holds: at most depth + 2 batches live on the device.
    data_prefetch_depth: int = _env("TORCHMPI_TPU_DATA_PREFETCH_DEPTH",
                                    2, int)
    # Host-stage transform worker threads (0: one producer, no pool); only
    # meaningful with a per-batch transform, order stays deterministic.
    data_host_workers: int = 0
    # Bound (batches) on the host stage's output queue.
    data_host_depth: int = 4
    # Reuse the device stage's pinned host buffers (HostScratchPool) once
    # their copy has completed; off on the CPU, where the "copy" aliases.
    data_reuse_host_buffers: bool = True

    # --- logging ---
    # 1 lifts the loggers' default level from INFO to DEBUG
    # (utils/logging.py; TORCHMPI_TPU_LOG_LEVEL wins over it).
    verbose: int = _env("TORCHMPI_TPU_VERBOSE", 0, int)

    # --- observability: off by default, so span() is one config read ---
    # Master switch of the Python span tracer.
    obs_trace: bool = _env_bool("TORCHMPI_TPU_OBS_TRACE", False)
    # Capacity (spans) of the tracer's finished-span buffer; drop-oldest.
    obs_span_capacity: int = _env(
        "TORCHMPI_TPU_OBS_SPAN_CAPACITY", 4096, int)

    # --- job history plane: persistent event journal (obs/journal.py) ---
    # Master switch: append-only JSONL journal of discrete state changes.
    journal_enabled: bool = _env_bool("TORCHMPI_TPU_JOURNAL_ENABLED", False)
    # Directory for journal segments ("" = current working directory).
    journal_dir: str = _env("TORCHMPI_TPU_JOURNAL_DIR", "", str)
    # Rotate the active segment once it exceeds this many bytes.
    journal_segment_bytes: int = _env(
        "TORCHMPI_TPU_JOURNAL_SEGMENT_BYTES", 1 << 20, int)
    # Newest segments kept per rank (oldest pruned).
    journal_keep: int = _env("TORCHMPI_TPU_JOURNAL_KEEP", 8, int)
    # fsync after every appended line.
    journal_fsync: bool = _env_bool("TORCHMPI_TPU_JOURNAL_FSYNC", False)

    # --- inference serving plane (serving/; all reads funnel through
    # serving.serve_config()) ---
    # Tokens per KV-cache block: the paged pool's allocation unit.
    serve_block_size: int = _env("TORCHMPI_TPU_SERVE_BLOCK_SIZE", 16, int)
    # Total KV blocks in the pool — the replica's whole token budget.
    serve_kv_blocks: int = _env("TORCHMPI_TPU_SERVE_KV_BLOCKS", 256, int)
    # Decode slots per iteration: the most requests batched into one step.
    serve_max_batch: int = _env("TORCHMPI_TPU_SERVE_MAX_BATCH", 8, int)
    # Admitted-but-not-yet-scheduled queue bound (typed queue_full beyond).
    serve_max_queue: int = _env("TORCHMPI_TPU_SERVE_MAX_QUEUE", 64, int)
    # Per-request deadline (ms) when the client sends none; past it the
    # request is shed wherever it is, with reason=deadline.
    serve_default_deadline_ms: int = _env(
        "TORCHMPI_TPU_SERVE_DEADLINE_MS", 10000, int)
    # Cap on tokens generated per request (larger asks are clamped).
    serve_max_new_tokens: int = _env(
        "TORCHMPI_TPU_SERVE_MAX_NEW_TOKENS", 32, int)
    # Fraction of the KV pool that must be free for admission.
    serve_admission_headroom: float = _env(
        "TORCHMPI_TPU_SERVE_ADMISSION_HEADROOM", 0.05, float)
    # Model runner behind the engine: "stub" or "llama".
    serve_runner: str = _env("TORCHMPI_TPU_SERVE_RUNNER", "stub", str)
    # Simulated per-token compute seconds for the stub runner.
    serve_stub_token_s: float = _env(
        "TORCHMPI_TPU_SERVE_STUB_TOKEN_S", 0.0, float)
    # Max seconds a drain waits for in-flight requests before shedding.
    serve_drain_timeout_s: float = _env(
        "TORCHMPI_TPU_SERVE_DRAIN_TIMEOUT_S", 5.0, float)


_constants = Constants()
_lock = threading.Lock()

_FIELDS = {f.name for f in dataclasses.fields(Constants)}


def get(name: str) -> Any:
    """Read a knob."""
    if name not in _FIELDS:
        raise KeyError(f"unknown constant {name!r}")
    return getattr(_constants, name)


def set(name: str, value: Any) -> None:  # noqa: A001 - mirrors the JAX API
    """Write a knob."""
    if name not in _FIELDS:
        raise KeyError(f"unknown constant {name!r}")
    with _lock:
        setattr(_constants, name, value)


def reset(**overrides: Any) -> None:
    """Restore defaults (test helper); optionally apply overrides."""
    global _constants
    with _lock:
        _constants = Constants()
        for k, v in overrides.items():
            if k not in _FIELDS:
                raise KeyError(f"unknown constant {k!r}")
            setattr(_constants, k, v)
