"""ctypes binding to the native parameter-server engine (_native/ps.cpp).

Counterpart of ``torchmpi_tpu/parameterserver/native.py``: thin typed
wrappers, no policy (reference: torchmpi/parameterserver/init.lua:50-90,
lib/parameterserver.cpp:674-755).  The engine is the port's own copy of
``ps.cpp`` (byte for byte the JAX package's, so a server of either package
serves a client of the other), built by ``_native/build.py`` into the
ignored ``_native/_build/`` at the first call of :func:`lib`.

Values cross the boundary as contiguous CPU tensors (or numpy arrays);
the dtype codes follow the element type.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .._native.build import build_library

F32, F64, I32, I64, U8, BF16, F16, I8 = 0, 1, 2, 3, 4, 5, 6, 7
RULE_ZERO, RULE_COPY, RULE_ADD = 0, 1, 2

_DTYPES = {
    torch.float32: F32,
    torch.float64: F64,
    torch.int32: I32,
    torch.int64: I64,
    torch.uint8: U8,
    # Sub-word breadth: bf16 and f16 kRuleAdd widen to f32 per pair and
    # round back nearest-even; int8 accumulates widened with a saturating
    # narrow (ps.cpp).
    torch.bfloat16: BF16,
    torch.float16: F16,
    torch.int8: I8,
}
_NUMPY = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.float16): torch.float16,
          np.dtype(np.int8): torch.int8}

_lib: Optional[ctypes.CDLL] = None


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch or numpy dtype (numpy has no bf16: carry
    bf16 values as tensors)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt not in _NUMPY:
        raise ValueError(f"unsupported parameter-server dtype {dt}")
    return _NUMPY[dt]


def dtype_code(dtype) -> int:
    dt = torch_dtype(dtype)
    if dt not in _DTYPES:
        raise ValueError(f"unsupported parameter-server dtype {dt} "
                         f"(have {sorted(str(d) for d in _DTYPES)})")
    return _DTYPES[dt]


_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """Load (building if needed) the native library, declaring signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    path = build_library("tmpi_ps", ["ps.cpp"])
    L = ctypes.CDLL(path)
    u64, u32, i64 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64
    L.tmpi_ps_server_start.argtypes = [ctypes.c_int]
    L.tmpi_ps_server_start.restype = ctypes.c_int
    L.tmpi_ps_server_port.argtypes = [ctypes.c_int]
    L.tmpi_ps_server_port.restype = ctypes.c_int
    # void returns carry an explicit restype = None throughout: ctypes'
    # default restype is c_int, which on a void function reads a stale
    # return register.
    L.tmpi_ps_server_stop.argtypes = [ctypes.c_int]
    L.tmpi_ps_server_stop.restype = None
    L.tmpi_ps_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    L.tmpi_ps_connect.restype = ctypes.c_int
    L.tmpi_ps_disconnect.argtypes = [ctypes.c_int]
    L.tmpi_ps_disconnect.restype = None
    L.tmpi_ps_create.argtypes = [ctypes.c_int, u64, u64, u32, ctypes.c_int]
    L.tmpi_ps_create.restype = ctypes.c_int
    L.tmpi_ps_push.argtypes = [ctypes.c_int, u64, u32, u32, u64, u64, ctypes.c_void_p]
    L.tmpi_ps_push.restype = ctypes.c_int
    L.tmpi_ps_pull.argtypes = [ctypes.c_int, u64, u32, u64, u64, ctypes.c_void_p]
    L.tmpi_ps_pull.restype = ctypes.c_int
    L.tmpi_ps_free_instance.argtypes = [ctypes.c_int, u64]
    L.tmpi_ps_free_instance.restype = ctypes.c_int
    L.tmpi_ps_free_all.argtypes = [ctypes.c_int]
    L.tmpi_ps_free_all.restype = ctypes.c_int
    L.tmpi_ps_ping.argtypes = [ctypes.c_int]
    L.tmpi_ps_ping.restype = ctypes.c_int
    L.tmpi_ps_push_async.argtypes = [ctypes.c_int, u64, u32, u32, u64, u64, ctypes.c_void_p]
    L.tmpi_ps_push_async.restype = i64
    L.tmpi_ps_pull_async.argtypes = [ctypes.c_int, u64, u32, u64, u64, ctypes.c_void_p]
    L.tmpi_ps_pull_async.restype = i64
    # Fenced pushes stamp the serving epoch learned at registration/
    # failover (tmpi_ps_fetch_epoch); result 1 applied, 0 failed, -2
    # epoch-fenced (the rule provably did NOT run — the client must
    # re-register, re-seed via idempotent copy, and replay).  Epoch 0
    # degrades to the unfenced wire behaviour.
    L.tmpi_ps_push_fenced.argtypes = [ctypes.c_int, u64, u32, u32, u64, u64,
                                      ctypes.c_void_p, u64]
    L.tmpi_ps_push_fenced.restype = ctypes.c_int
    L.tmpi_ps_push_async_fenced.argtypes = [ctypes.c_int, u64, u32, u32,
                                            u64, u64, ctypes.c_void_p, u64]
    L.tmpi_ps_push_async_fenced.restype = i64
    L.tmpi_ps_fetch_epoch.argtypes = [ctypes.c_int]
    L.tmpi_ps_fetch_epoch.restype = u64
    # Replicated-group control plane (placement ring lives in Python —
    # parameterserver/placement.py; the server only answers probes,
    # forwards where told, and ships/fences on handoff).
    L.tmpi_ps_fetch_placement.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
    L.tmpi_ps_fetch_placement.restype = ctypes.c_int
    L.tmpi_ps_set_placement_epoch.argtypes = [ctypes.c_int, u64]
    L.tmpi_ps_set_placement_epoch.restype = ctypes.c_int
    L.tmpi_ps_handoff.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_int, u64]
    L.tmpi_ps_handoff.restype = ctypes.c_int
    L.tmpi_ps_set_backup.argtypes = [ctypes.c_int, u64, ctypes.c_char_p,
                                     ctypes.c_int]
    L.tmpi_ps_set_backup.restype = ctypes.c_int
    L.tmpi_ps_drain.argtypes = [ctypes.c_int, u64]
    L.tmpi_ps_drain.restype = ctypes.c_int
    L.tmpi_ps_forward_count.argtypes = []
    L.tmpi_ps_forward_count.restype = u64
    L.tmpi_ps_forward_error_count.argtypes = []
    L.tmpi_ps_forward_error_count.restype = u64
    L.tmpi_ps_handoff_count.argtypes = []
    L.tmpi_ps_handoff_count.restype = u64
    L.tmpi_ps_handoff_torn_count.argtypes = []
    L.tmpi_ps_handoff_torn_count.restype = u64
    L.tmpi_ps_set_forward_queue_max.argtypes = [ctypes.c_int]
    L.tmpi_ps_set_forward_queue_max.restype = None
    L.tmpi_ps_server_placement_epoch.argtypes = [ctypes.c_int]
    L.tmpi_ps_server_placement_epoch.restype = u64
    L.tmpi_ps_wait.argtypes = [i64]
    L.tmpi_ps_wait.restype = ctypes.c_int
    # Server durability + crash-restart failover (snapshot engine in
    # ps.cpp; docs/parameterserver.md "Durability & crash-restart
    # failover") and its drill seams.
    L.tmpi_ps_restore_dir.argtypes = [ctypes.c_int, ctypes.c_char_p]
    L.tmpi_ps_restore_dir.restype = ctypes.c_int
    L.tmpi_ps_snapshot.argtypes = [ctypes.c_int]
    L.tmpi_ps_snapshot.restype = ctypes.c_int
    L.tmpi_ps_server_epoch.argtypes = [ctypes.c_int]
    L.tmpi_ps_server_epoch.restype = u64
    L.tmpi_ps_server_drop_push_acks.argtypes = [ctypes.c_int, ctypes.c_int]
    L.tmpi_ps_server_drop_push_acks.restype = None
    L.tmpi_ps_set_snapshot_interval_ms.argtypes = [ctypes.c_int]
    L.tmpi_ps_set_snapshot_interval_ms.restype = None
    L.tmpi_ps_set_snapshot_crash_point.argtypes = [ctypes.c_int]
    L.tmpi_ps_set_snapshot_crash_point.restype = None
    L.tmpi_ps_snapshot_count.argtypes = []
    L.tmpi_ps_snapshot_count.restype = u64
    L.tmpi_ps_snapshot_error_count.argtypes = []
    L.tmpi_ps_snapshot_error_count.restype = u64
    L.tmpi_ps_snapshot_restore_count.argtypes = []
    L.tmpi_ps_snapshot_restore_count.restype = u64
    L.tmpi_ps_snapshot_torn_count.argtypes = []
    L.tmpi_ps_snapshot_torn_count.restype = u64
    L.tmpi_ps_epoch_fence_count.argtypes = []
    L.tmpi_ps_epoch_fence_count.restype = u64
    L.tmpi_ps_client_fenced_count.argtypes = []
    L.tmpi_ps_client_fenced_count.restype = u64
    # Server-side swallowed-exception counter (each increment dropped a
    # client connection; see ps.cpp serveConnection) — a monitor/test
    # surface, so server bugs stop manifesting as silent client drops.
    L.tmpi_ps_server_exception_count.argtypes = []
    L.tmpi_ps_server_exception_count.restype = u64
    # Client-resilience observables (chaos-drill surface): retries taken,
    # expired request deadlines, client-detected CRC faults.
    L.tmpi_ps_retry_count.argtypes = []
    L.tmpi_ps_retry_count.restype = u64
    L.tmpi_ps_timeout_count.argtypes = []
    L.tmpi_ps_timeout_count.restype = u64
    L.tmpi_ps_crc_failure_count.argtypes = []
    L.tmpi_ps_crc_failure_count.restype = u64
    L.tmpi_ps_set_retry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    L.tmpi_ps_set_retry.restype = None
    L.tmpi_ps_set_request_deadline_ms.argtypes = [ctypes.c_int]
    L.tmpi_ps_set_request_deadline_ms.restype = None
    L.tmpi_ps_set_frame_crc.argtypes = [ctypes.c_int]
    L.tmpi_ps_set_frame_crc.restype = None
    L.tmpi_ps_set_pool_size.argtypes = [ctypes.c_int]
    L.tmpi_ps_set_pool_size.restype = None
    # The fence + teardown entry points (void(), declared like the rest).
    L.tmpi_ps_sync_all.argtypes = []
    L.tmpi_ps_sync_all.restype = None
    L.tmpi_ps_shutdown.argtypes = []
    L.tmpi_ps_shutdown.restype = None
    # Observability plane (_native/trace.h; obs/native.py): phase-event
    # ring + process-wide correlation stamp (async ops capture it at
    # enqueue and replay it on the offload pool).
    L.tmpi_ps_set_trace.argtypes = [ctypes.c_int, ctypes.c_int]
    L.tmpi_ps_set_trace.restype = None
    L.tmpi_ps_trace_drain.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.tmpi_ps_trace_drain.restype = ctypes.c_int
    L.tmpi_ps_trace_dropped.argtypes = []
    L.tmpi_ps_trace_dropped.restype = u64
    L.tmpi_ps_set_correlation.argtypes = [u64]
    L.tmpi_ps_set_correlation.restype = None
    L.tmpi_ps_set_clock_offset.argtypes = [i64]
    L.tmpi_ps_set_clock_offset.restype = None
    from ..runtime import config as _config

    L.tmpi_ps_set_pool_size(int(_config.get("parameterserver_offload_pool_size")))
    # Push the obs_trace knobs at load, like the hostcomm binding
    # (obs/native.apply_config re-pushes after config changes).
    L.tmpi_ps_set_trace(1 if _config.get("obs_trace") else 0,
                        int(_config.get("obs_trace_ring_capacity")))
    _apply_config(L)
    return L


def apply_config() -> None:
    """Push the ps_* knobs from runtime/config.py into the native engine
    (retry budget + backoff shape, per-request deadline, frame CRC,
    snapshot cadence, forward queue).  Called on library load and after a
    ``config.set``/``reset`` whose new values should take effect."""
    _apply_config(lib())


def _apply_config(L: ctypes.CDLL) -> None:
    from ..runtime import config as _config

    L.tmpi_ps_set_retry(int(_config.get("ps_retry_max")),
                        int(_config.get("ps_retry_backoff_ms")),
                        int(_config.get("ps_retry_backoff_max_ms")))
    L.tmpi_ps_set_request_deadline_ms(
        int(_config.get("ps_request_deadline_ms")))
    L.tmpi_ps_set_frame_crc(1 if _config.get("ps_frame_crc") else 0)
    L.tmpi_ps_set_snapshot_interval_ms(
        int(_config.get("ps_snapshot_interval_ms")))
    L.tmpi_ps_set_forward_queue_max(
        int(_config.get("ps_forward_queue_max")))


def failover_config() -> dict:
    """The client-failover, durability and replication knobs in one read
    (``ps_snapshot_*``, ``ps_failover_*``, ``ps_epoch_fence``,
    ``ps_replication`` and its family), consumed by
    ``parameterserver/__init__.py``'s failover path."""
    from ..runtime import config as _config

    return {
        "snapshot_dir": str(_config.get("ps_snapshot_dir")),
        "epoch_fence": bool(_config.get("ps_epoch_fence")),
        "failover_max": int(_config.get("ps_failover_max")),
        "failover_backoff_ms": int(_config.get("ps_failover_backoff_ms")),
        "replication": bool(_config.get("ps_replication")),
        "placement_vnodes": int(_config.get("ps_placement_vnodes")),
        "promote_reconnect_max": int(
            _config.get("ps_promote_reconnect_max")),
        # Storm suppression: first promotion in a window jitters, later
        # ones coalesce into the same placement epoch (0 = off).
        "promote_jitter_ms": int(_config.get("ps_promote_jitter_ms")),
    }


def retry_count() -> int:
    """Monotonic count of PS client re-attempts (after failed attempts)."""
    return int(lib().tmpi_ps_retry_count())


def timeout_count() -> int:
    """Monotonic count of expired per-request deadlines."""
    return int(lib().tmpi_ps_timeout_count())


def crc_failure_count() -> int:
    """Monotonic count of client-detected frame-integrity faults."""
    return int(lib().tmpi_ps_crc_failure_count())


def snapshot_count() -> int:
    """Monotonic count of durable snapshot files landed (rename complete)."""
    return int(lib().tmpi_ps_snapshot_count())


def snapshot_error_count() -> int:
    """Monotonic count of failed snapshot/epoch-marker writes."""
    return int(lib().tmpi_ps_snapshot_error_count())


def snapshot_restore_count() -> int:
    """Monotonic count of successful snapshot restores."""
    return int(lib().tmpi_ps_snapshot_restore_count())


def snapshot_torn_count() -> int:
    """Monotonic count of snapshot files REJECTED by restore validation
    (skipped, never loaded — restore fell back to an older file)."""
    return int(lib().tmpi_ps_snapshot_torn_count())


def forward_count() -> int:
    """Monotonic count of pushes forwarded onto backup servers (landed)."""
    return int(lib().tmpi_ps_forward_count())


def forward_error_count() -> int:
    """Monotonic count of forward frames provably LOST to a backup
    (send/ack failure, queue-overflow drop, stop-time abandon) — each one
    is repaired by the seeder's shadow re-seed at promotion."""
    return int(lib().tmpi_ps_forward_error_count())


def handoff_count() -> int:
    """Monotonic count of completed live shard handoffs (ship + fence)."""
    return int(lib().tmpi_ps_handoff_count())


def handoff_torn_count() -> int:
    """Monotonic count of handoffs that FAILED mid-ship: the old owner
    un-drained and kept serving; nothing cut over."""
    return int(lib().tmpi_ps_handoff_torn_count())


#: drain kinds in the placement probe's second element (ps.cpp
#: kDrainNone/kDrainHandoff/kDrainPromoted): 0 = serving, 1 = handoff
#: fence (successor present or imminent — poll), 2 = promotion fence
#: (no successor ever — re-derive the map from membership).
DRAIN_NONE, DRAIN_HANDOFF, DRAIN_PROMOTED = 0, 1, 2


def fetch_placement(peer: int):
    """(placement_epoch, drain_kind, successor) from a server, or
    ``None`` on transport failure.  ``drain_kind`` is one of
    :data:`DRAIN_NONE`/:data:`DRAIN_HANDOFF`/:data:`DRAIN_PROMOTED`;
    ``successor`` is the ``(host, port)`` tuple a handoff-drained server
    forwards clients to (``None`` when absent — including the transient
    mid-handoff window)."""
    import ctypes as _ct

    ep = _ct.c_uint64(0)
    dr = _ct.c_uint64(0)
    buf = _ct.create_string_buffer(600)
    ok = lib().tmpi_ps_fetch_placement(
        peer, _ct.addressof(ep), _ct.addressof(dr), buf, len(buf))
    if ok != 1:
        return None
    succ = buf.value.decode("utf-8", "replace")
    successor = None
    if succ:
        # The probe reply is untrailed (no CRC even with ps_frame_crc):
        # a malformed successor means a corrupt stream — report the probe
        # failed rather than leak a ValueError through the failover path.
        host, sep, port = succ.rpartition(":")
        if not sep or not port.isdigit():
            return None
        successor = (host, int(port))
    return int(ep.value), int(dr.value), successor


def epoch_fence_count() -> int:
    """Monotonic count of pushes the server NACKed with a stale epoch."""
    return int(lib().tmpi_ps_epoch_fence_count())


def client_fenced_count() -> int:
    """Monotonic count of fenced NACKs THIS process's client received —
    the survivor's audit trail when the server (and its counter) lives in
    a separate, killable process."""
    return int(lib().tmpi_ps_client_fenced_count())


_COUNTERS = ("retry", "timeout", "crc_failure", "snapshot", "snapshot_error",
             "snapshot_restore", "snapshot_torn", "forward",
             "forward_error", "handoff", "handoff_torn", "epoch_fence",
             "client_fenced", "server_exception")


def counters() -> Dict[str, int]:
    """Every native counter of this process's engine, by name
    (``tmpi_ps_<name>_count``)."""
    L = lib()
    return {name: int(getattr(L, f"tmpi_ps_{name}_count")())
            for name in _COUNTERS}


def shutdown() -> None:
    """Drain and tear down all native PS state."""
    if _lib is not None:
        _lib.tmpi_ps_shutdown()
