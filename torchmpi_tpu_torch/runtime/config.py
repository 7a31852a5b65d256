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
(``data_*``, read only by ``data/pipeline.py:knob_defaults``), the
parameter server (``parameterserver_offload_pool_size``, ``ps_*``), the
native trace rings and the flight recorder (``obs_trace_ring_capacity``,
``obs_flight*``), clock alignment and obsdumps (``obs_clocksync_*``,
``obs_dump_dir``), the live endpoint (``obs_http*``), the metrics history
(``history_*``), the alert plane (``alert_*``), transport chaos
(``chaos_*``), elastic resize (``resize_*``), the collective autotuner
(``autotune_*``) and its retune controller (``retune_*``) and the logger's
level (``verbose``).
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

    # --- parameter server (parameterserver/, _native/ps.cpp) ---
    # Offload pool threads of the PS client's async pushes and pulls.
    parameterserver_offload_pool_size: int = 4
    # Max request attempts per PS operation (connect + send + reply).
    # Retries honour the idempotency split: a send-side failure always
    # retries, a lost reply only for idempotent ops (pull/create/free/ping
    # — never a rule=add push).
    ps_retry_max: int = 4
    # Exponential backoff between attempts: base * 2^attempt plus jitter,
    # capped at the max.
    ps_retry_backoff_ms: int = 50
    ps_retry_backoff_max_ms: int = 2000
    # Per-request socket deadline in ms; 0 waits forever.  An expired
    # deadline counts in tmpi_ps_timeout_count and fails the attempt.
    ps_request_deadline_ms: int = 0
    # CRC32 trailers on PS frames (push payloads verified server-side with
    # a retriable NACK, pull replies client-side); mismatches count in
    # tmpi_ps_crc_failure_count.
    ps_frame_crc: bool = False
    # Server-side durable snapshot directory ("" = durability off): the
    # server restores the newest snapshot that validates and starts the
    # cadence writer.
    ps_snapshot_dir: str = _env("TORCHMPI_TPU_PS_SNAPSHOT_DIR", "", str)
    # Cadence of the background snapshot writer in ms (0 = on demand).
    ps_snapshot_interval_ms: int = 0
    # Epoch fence for non-idempotent pushes: a server restarted from a
    # snapshot NACKs stale pushes, and the client's failover re-seeds the
    # shard from its shadow before replaying — `add` lands exactly once.
    ps_epoch_fence: bool = True
    # Client failover budget (reconnect pings; 0 = off, failures raise
    # PSTransportError at once) and its base backoff (exponential, capped
    # at about 2 s).
    ps_failover_max: int = 8
    ps_failover_backoff_ms: int = 250
    # Replicated multi-server group: shard keys on a consistent-hash ring,
    # a backup per shard, promotion of a dead primary, live handoff.
    ps_replication: bool = False
    # Virtual points per server slot on the placement ring (identical on
    # every client of a cluster).
    ps_placement_vnodes: int = 128
    # Reconnect attempts to an unresponsive primary before promoting its
    # backup (replicated mode only).
    ps_promote_reconnect_max: int = 1
    # Promotion-storm suppression window in ms (0 = off).
    ps_promote_jitter_ms: int = _env(
        "TORCHMPI_TPU_PS_PROMOTE_JITTER_MS", 0, int)
    # Bound (frames) on each server's pending-forward queue to its backups.
    ps_forward_queue_max: int = 1024

    # --- the measured collective autotuner (collectives/autotune.py) ---
    # Selector dispatch mode: "off" (the static table, as before the
    # autotuner), "cache" (payload-keyed resolutions consult the winner
    # cache, validated against the fingerprint) or "online" (cache winners
    # with each candidate's ms replaced by its production mean once
    # enough samples exist, agreed over the ranks first).
    autotune_mode: str = _env("TORCHMPI_TPU_AUTOTUNE_MODE", "off", str)
    # Winner-cache file ("" = ~/.cache/torchmpi_tpu/autotune.json).
    autotune_cache_path: str = _env("TORCHMPI_TPU_AUTOTUNE_CACHE_PATH",
                                    "", str)
    # Interleaved best-of trials per cell in the explicit pass.
    autotune_trials: int = 3
    # Warmup calls per candidate before its first timed block.
    autotune_warmup: int = 1
    # Timed reps per block; 0 = auto from a ~4 MiB payload-byte budget.
    autotune_reps: int = 0
    # Histogram samples before "online" trusts a production mean.
    autotune_online_min_samples: int = 20

    # --- the retune controller (collectives/retune.py; all reads funnel
    # through retune.retune_config()) ---
    retune_enabled: bool = _env_bool("TORCHMPI_TPU_RETUNE_ENABLED", False)
    # Step boundaries between controller polls; identical on every rank.
    retune_poll_interval_steps: int = _env(
        "TORCHMPI_TPU_RETUNE_POLL_INTERVAL_STEPS", 1, int)
    # A trigger rule must stay firing this long before a probe.
    retune_debounce_s: float = _env(
        "TORCHMPI_TPU_RETUNE_DEBOUNCE_S", 5.0, float)
    # Quiet window after an apply before the next probe may launch.
    retune_cooldown_s: float = _env(
        "TORCHMPI_TPU_RETUNE_COOLDOWN_S", 60.0, float)
    # Post-apply window in which a regression reverts the flips.
    retune_revert_window_s: float = _env(
        "TORCHMPI_TPU_RETUNE_REVERT_WINDOW_S", 30.0, float)
    # Post-apply / pre-probe step-rate ratio at or below which it reverts.
    retune_revert_drift: float = _env(
        "TORCHMPI_TPU_RETUNE_REVERT_DRIFT", 0.9, float)
    # tmpi_autotune_mix_drift level the autotune_mix_drift alert fires at.
    retune_mix_threshold: float = _env(
        "TORCHMPI_TPU_RETUNE_MIX_THRESHOLD", 0.5, float)
    # Live histogram samples before the mix-drift gauge publishes nonzero.
    retune_mix_min_samples: int = _env(
        "TORCHMPI_TPU_RETUNE_MIX_MIN_SAMPLES", 20, int)

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
    # Capacity (events) of each native trace ring (hostcomm.cpp, ps.cpp);
    # drop-oldest, losses counted in tmpi_{hc,ps}_trace_dropped.
    obs_trace_ring_capacity: int = _env(
        "TORCHMPI_TPU_OBS_TRACE_RING_CAPACITY", 4096, int)
    # Failure flight recorder (obs/flight.py): when on, the PS failover and
    # promotion paths write a post-mortem bundle (spans, drained native
    # ring tails, counters, knobs) to obs_flight_dir ("" = the working
    # directory), keeping at most obs_flight_keep bundles.
    obs_flight: bool = _env_bool("TORCHMPI_TPU_OBS_FLIGHT", False)
    obs_flight_dir: str = _env("TORCHMPI_TPU_OBS_FLIGHT_DIR", "", str)
    obs_flight_keep: int = _env("TORCHMPI_TPU_OBS_FLIGHT_KEEP", 8, int)
    # Ping-pong rounds per peer in the clock-alignment exchange
    # (obs/clocksync.py); the min-RTT round's midpoint estimate wins.
    obs_clocksync_rounds: int = _env(
        "TORCHMPI_TPU_OBS_CLOCKSYNC_ROUNDS", 8, int)
    # Bounded-sample clock alignment: only this many evenly spaced peers
    # are measured, the rest inherit the sampled median offset with a
    # widened uncertainty (0 = measure every peer).
    obs_clocksync_sample_peers: int = _env(
        "TORCHMPI_TPU_OBS_CLOCKSYNC_SAMPLE_PEERS", 0, int)
    # Directory each rank writes its obsdump-<rank>.json bundle into at
    # shutdown ("" = no shutdown dump; obs/aggregate.py).
    obs_dump_dir: str = _env("TORCHMPI_TPU_OBS_DUMP_DIR", "", str)
    # Fan-in of the federation tree (obs/cluster.py): endpoints shard into
    # groups of about this many per aggregator, and a sweep runs at most
    # this many probes at once.
    obs_federation_fanout: int = _env(
        "TORCHMPI_TPU_OBS_FEDERATION_FANOUT", 16, int)
    # --- live telemetry & health plane (obs/serve.py; all reads funnel
    # through obs/native.serve_config) ---
    # Serve /metrics, /healthz, /spans, /journal, /history, /alerts and
    # POST /flight on a daemon thread of this process, started by
    # runtime/lifecycle.start.  Off by default: no socket, no thread.
    obs_http: bool = _env_bool("TORCHMPI_TPU_OBS_HTTP", False)
    # Listen port; 0 picks an ephemeral one (read back by obs.serve.url()).
    obs_http_port: int = _env("TORCHMPI_TPU_OBS_HTTP_PORT", 0, int)
    # Bind address, loopback by default: the endpoint has no auth.
    obs_http_bind: str = _env("TORCHMPI_TPU_OBS_HTTP_BIND",
                              "127.0.0.1", str)

    # --- on-disk metrics history (obs/history.py; all reads funnel
    # through history.history_config) ---
    # Background sampler of the metrics registry, started by
    # runtime/lifecycle.start when on.
    history_enabled: bool = _env_bool("TORCHMPI_TPU_HISTORY_ENABLED", False)
    # Seconds between registry snapshots in the finest tier.
    history_interval_s: float = _env(
        "TORCHMPI_TPU_HISTORY_INTERVAL_S", 1.0, float)
    # Directory of the persisted history-<rank>.json ("" = in memory only).
    history_dir: str = _env("TORCHMPI_TPU_HISTORY_DIR", "", str)
    # Rows per tier ring.
    history_tier_len: int = _env("TORCHMPI_TPU_HISTORY_TIER_LEN", 512, int)
    # Fine rows aggregated into one coarse row between tiers.
    history_downsample: int = _env("TORCHMPI_TPU_HISTORY_DOWNSAMPLE",
                                   30, int)

    # --- alerting plane (obs/alerts.py; all reads funnel through
    # alerts.alerts_config) ---
    # Arm the rules engine on the history sampler's cadence (needs
    # history_enabled).
    alert_enabled: bool = _env_bool("TORCHMPI_TPU_ALERT_ENABLED", False)
    # Ship the default rule pack.
    alert_default_pack: bool = _env_bool(
        "TORCHMPI_TPU_ALERT_DEFAULT_PACK", True)
    # JSON file of author-supplied rule specs ("" = none); a same-named
    # rule replaces the default pack's.
    alert_rules_path: str = _env("TORCHMPI_TPU_ALERT_RULES_PATH", "", str)
    # Sampler ticks between rule evaluations.
    alert_eval_every: int = _env("TORCHMPI_TPU_ALERT_EVAL_EVERY", 1, int)
    # Default hold (seconds) before a pending rule fires.
    alert_for_s: float = _env("TORCHMPI_TPU_ALERT_FOR_S", 3.0, float)
    # Dump a flight bundle when a critical rule fires (still gated by
    # obs_flight).
    alert_flight: bool = _env_bool("TORCHMPI_TPU_ALERT_FLIGHT", True)

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

    # --- transport chaos (runtime/chaos.py: a seeded in-process TCP fault
    # proxy between ring neighbours; wired by endpoint rewriting, so
    # nothing on the fast path reads these) ---
    chaos_enabled: bool = False
    chaos_seed: int = 0
    # Added latency per forwarded chunk (plus uniform jitter).
    chaos_delay_ms: float = 0.0
    chaos_jitter_ms: float = 0.0
    # Throughput cap in bytes/second; 0 = unlimited.
    chaos_bandwidth_bytes_per_s: int = 0
    # Per-forwarded-chunk probabilities of flipping one byte, RST-closing
    # the connection, or black-holing it (stop forwarding, keep it open).
    chaos_corrupt_prob: float = 0.0
    chaos_reset_prob: float = 0.0
    chaos_blackhole_prob: float = 0.0

    # --- the numerics plane (obs/numerics.py; all reads funnel through
    # numerics.numerics_config) ---
    # "off" (the step as it was: no extra launch, no host read),
    # "sentinel" (in-step gradient statistics published each step as
    # tmpi_numerics_* through obs/serve.publish_step) or "audit"
    # (sentinel plus an installed engine.numerics_auditor's cross-rank
    # parameter digest exchange every numerics_audit_interval steps).
    numerics_mode: str = _env("TORCHMPI_TPU_NUMERICS_MODE", "off", str)
    # Steps between cross-rank digest audits in audit mode.
    numerics_audit_interval: int = _env(
        "TORCHMPI_TPU_NUMERICS_AUDIT_INTERVAL", 100, int)
    # Records kept in the in-memory sentinel history ring that flight
    # bundles snapshot.
    numerics_history: int = _env("TORCHMPI_TPU_NUMERICS_HISTORY", 64, int)

    # --- elastic resize (runtime/resize.py; all reads funnel through
    # resize.resize_config()) ---
    # Arms the resize request queue and the live endpoint's POST /resize:
    # with this off, enqueue_request raises.
    resize_enabled: bool = _env_bool("TORCHMPI_TPU_RESIZE_ENABLED", False)
    # Socket deadline (ms) on every out-of-band resize wait: the state
    # ship to a joiner, the joiner's verdict wait, the rejoin state pull.
    resize_io_deadline_ms: int = _env(
        "TORCHMPI_TPU_RESIZE_IO_DEADLINE_MS", 10000, int)
    # Step boundaries between proposal polls (each poll is one small
    # broadcast on the control ring); identical on every rank.
    resize_poll_interval_steps: int = _env(
        "TORCHMPI_TPU_RESIZE_POLL_INTERVAL_STEPS", 1, int)


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


def snapshot() -> dict:
    """All knobs as a dict, for logging / reproducibility."""
    return dataclasses.asdict(_constants)


def reset(**overrides: Any) -> None:
    """Restore defaults (test helper); optionally apply overrides."""
    global _constants
    with _lock:
        _constants = Constants()
        for k, v in overrides.items():
            if k not in _FIELDS:
                raise KeyError(f"unknown constant {k!r}")
            setattr(_constants, k, v)
