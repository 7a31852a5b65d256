"""Tunable runtime constants of the port: one typed registry.

The port's own copy of the knobs its modules read, under the JAX package's
names, defaults and environment variables, so that ``docs/config.md``
stays the one registry of both packages.  Only the knobs of the ported
modules are here: the span tracer (``obs_trace``, ``obs_span_capacity``),
the event journal (``journal_*``) and the serving plane (``serve_*``).
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
