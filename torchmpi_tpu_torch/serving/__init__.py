"""Inference serving plane of the port: continuous-batching request engine.

- :mod:`torchmpi_tpu_torch.serving.kvcache` — paged KV-cache block pool
  (fixed-size blocks, per-request block lists, deadline-aware eviction).
- :mod:`torchmpi_tpu_torch.serving.engine` — Orca-style iteration-level
  scheduler over a prefill/decode split runner.
- :mod:`torchmpi_tpu_torch.serving.frontend` — the HTTP request plane
  (:class:`ServeFrontend`): admission control, deadlines with typed
  shed responses, correlation ids into the span tracer, drain/resume.
- :mod:`torchmpi_tpu_torch.serving.router` — placement-ring request
  routing across replicas (:class:`ServeRouter`, :class:`NoReplicas`)
  with drain cutover and failover.

All ``serve_*`` knob reads funnel through :func:`serve_config`.
"""
from __future__ import annotations

from typing import Any, Dict

from ..runtime import config


def serve_config() -> Dict[str, Any]:
    """The ``serve_*`` knobs as one dict (see docs/serving.md)."""
    return {
        "block_size": int(config.get("serve_block_size")),
        "kv_blocks": int(config.get("serve_kv_blocks")),
        "max_batch": int(config.get("serve_max_batch")),
        "max_queue": int(config.get("serve_max_queue")),
        "default_deadline_ms": int(config.get("serve_default_deadline_ms")),
        "max_new_tokens": int(config.get("serve_max_new_tokens")),
        "admission_headroom": float(config.get("serve_admission_headroom")),
        "runner": str(config.get("serve_runner")),
        "stub_token_s": float(config.get("serve_stub_token_s")),
        "drain_timeout_s": float(config.get("serve_drain_timeout_s")),
    }


# After serve_config: the engine, which the frontend imports, reads it.
from .frontend import ServeFrontend  # noqa: E402,F401
from .router import NoReplicas, ServeRouter  # noqa: E402,F401
