"""Python side of the native trace rings (``tmpi_{hc,ps}_trace_*``).

Counterpart of ``torchmpi_tpu/obs/native.py``, pointed at the port's own
host-plane libraries (``collectives/hostcomm.py`` and
``parameterserver/native.py``, built from the port's copies of
``hostcomm.cpp`` and ``ps.cpp``).  The rings live inside those ``.so`` s
(``_native/trace.h``); this module plumbs the ``obs_*`` knobs into them,
drains events in bulk into numpy structured arrays, and names the op /
phase codes.  The 32-byte record layout (:data:`EVENT_DTYPE`) is part of
the C ABI — it mirrors ``TmpiTraceEvent`` field for field.
"""

from __future__ import annotations

import numpy as np

#: mirrors _native/trace.h:TmpiTraceEvent — keep in sync.
EVENT_DTYPE = np.dtype([
    ("t_ns", "<u8"),
    ("correlation", "<u8"),
    ("bytes", "<u8"),
    ("rank", "<i4"),
    ("plane", "u1"),
    ("op", "u1"),
    ("phase", "u1"),
    ("pad", "u1"),
])
assert EVENT_DTYPE.itemsize == 32, "TmpiTraceEvent is 32 bytes at the ABI"

PLANES = {0: "hostcomm", 1: "ps"}
PHASES = {0: "enqueue", 1: "start", 2: "chunk", 3: "retry",
          4: "complete", 5: "error"}
#: hostcomm.cpp:HcTraceOp
HC_OPS = {1: "allreduce", 2: "broadcast", 3: "reduce", 4: "sendreceive",
          5: "allgather", 6: "barrier"}
#: ps.cpp:PsTraceOp (0 = a Peer-level retry that doesn't know its op)
PS_OPS = {0: "(request)", 1: "create", 2: "push", 3: "pull",
          4: "free_instance", 5: "free_all", 6: "ping",
          7: "snapshot", 8: "restore", 9: "epoch",
          10: "handoff", 11: "forward", 12: "placement"}


def _hc_lib():
    from ..collectives import hostcomm

    return hostcomm.lib()


def _ps_lib():
    from ..parameterserver import native as ps_native

    return ps_native.lib()


_BINDING_MODULES = {
    "hostcomm": "torchmpi_tpu_torch.collectives.hostcomm",
    "ps": "torchmpi_tpu_torch.parameterserver.native",
}


def loaded(plane: str) -> bool:
    """Whether a plane's engine ``.so`` is already loaded — probes the
    binding module's cache without triggering a first-use build, and
    without importing the binding (a ``sys.modules`` probe: the flight
    recorder may run during interpreter teardown, and a never-imported
    binding has never loaded its engine)."""
    import sys

    name = _BINDING_MODULES.get(plane)
    if name is None:
        raise ValueError(f"plane must be 'hostcomm' or 'ps', got {plane!r}")
    mod = sys.modules.get(name)
    return mod is not None and getattr(mod, "_lib", None) is not None


def apply_config() -> None:
    """Push the ``obs_trace`` / ``obs_trace_ring_capacity`` knobs into the
    LOADED native engines.  An engine that is not loaded yet needs no push:
    its binding reads the knobs itself at load."""
    from ..runtime import config

    enabled = 1 if config.get("obs_trace") else 0
    capacity = int(config.get("obs_trace_ring_capacity"))
    if loaded("hostcomm"):
        _hc_lib().tmpi_hc_set_trace(enabled, capacity)
    if loaded("ps"):
        _ps_lib().tmpi_ps_set_trace(enabled, capacity)


def cluster_config() -> dict:
    """The cluster plane's knobs in one read: clock alignment
    (``obs/clocksync.py``), the federation fan-in (``obs/cluster.py``),
    obsdumps (``obs/aggregate.py``) and the flight recorder
    (``obs/flight.py``)."""
    from ..runtime import config

    return {
        "clocksync_rounds": int(config.get("obs_clocksync_rounds")),
        "clocksync_sample_peers": int(
            config.get("obs_clocksync_sample_peers")),
        "federation_fanout": int(config.get("obs_federation_fanout")),
        "dump_dir": str(config.get("obs_dump_dir")),
        "flight": bool(config.get("obs_flight")),
        "flight_dir": str(config.get("obs_flight_dir")),
        "flight_keep": int(config.get("obs_flight_keep")),
    }


def serve_config() -> dict:
    """The live endpoint's knobs in one read (``obs_http*``), the one
    config touchpoint of ``obs/serve.py``."""
    from ..runtime import config

    return {
        "http": bool(config.get("obs_http")),
        "port": int(config.get("obs_http_port")),
        "bind": str(config.get("obs_http_bind")),
    }


def set_clock_offset(offset_ns: int) -> None:
    """Push a clock-alignment offset into every LOADED native engine's
    trace ring (events stamp ``monotonic - offset``; trace.h)."""
    if loaded("hostcomm"):
        _hc_lib().tmpi_hc_set_clock_offset(int(offset_ns))
    if loaded("ps"):
        _ps_lib().tmpi_ps_set_clock_offset(int(offset_ns))


def drain_events(plane: str, max_events: int = 1 << 16) -> np.ndarray:
    """Drain up to ``max_events`` from one plane's ring, oldest first, as a
    structured array of :data:`EVENT_DTYPE` rows.  The ring forgets them;
    trace-off (or an idle ring) drains empty.  Drained in chunks of 4096
    so a near-empty ring doesn't pay a ``max_events``-sized allocation."""
    if plane == "hostcomm":
        fn = _hc_lib().tmpi_hc_trace_drain
    elif plane == "ps":
        fn = _ps_lib().tmpi_ps_trace_drain
    else:
        raise ValueError(f"plane must be 'hostcomm' or 'ps', got {plane!r}")
    chunks: list[np.ndarray] = []
    remaining = max_events
    while remaining > 0:
        buf = np.empty((min(4096, remaining),), EVENT_DTYPE)
        n = fn(buf.ctypes.data, len(buf))
        if n > 0:
            chunks.append(buf[:n])
            remaining -= n
        if n < len(buf):
            break
    if not chunks:
        return np.empty((0,), EVENT_DTYPE)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


def dropped(plane: str) -> int:
    """Monotonic drop-oldest loss counter of one plane's ring.  A
    never-loaded engine has dropped nothing — reported without forcing
    its first-use build."""
    if not loaded(plane):
        return 0
    if plane == "hostcomm":
        return int(_hc_lib().tmpi_hc_trace_dropped())
    return int(_ps_lib().tmpi_ps_trace_dropped())


def op_name(plane: int, op: int) -> str:
    table = HC_OPS if plane == 0 else PS_OPS
    return table.get(int(op), f"op{int(op)}")


def events_to_rows(events: np.ndarray) -> list:
    """Drained events as JSON-ready dicts with the op and phase named."""
    return [{"t_ns": int(e["t_ns"]), "correlation": int(e["correlation"]),
             "bytes": int(e["bytes"]), "rank": int(e["rank"]),
             "plane": PLANES.get(int(e["plane"]), str(int(e["plane"]))),
             "op": op_name(int(e["plane"]), int(e["op"])),
             "phase": PHASES.get(int(e["phase"]), str(int(e["phase"])))}
            for e in events]
