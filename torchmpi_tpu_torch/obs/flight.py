"""Failure flight recorder: forensic bundles at the moment of a trip.

Counterpart of ``torchmpi_tpu/obs/flight.py``, cut to what the port has.
When a failure path of ``parameterserver/__init__.py`` trips (a failover,
a promotion) or the numerics auditor finds a divergence
(``obs/numerics.py``), :func:`on_failure` snapshots

* the finished spans (**peeked**, not drained),
* the native trace-ring tails of every loaded plane (**drained** — the
  tail around the trip is exactly the evidence),
* the parameter server's counters (native and client side) and a fresh
  metrics-registry snapshot (native counters scraped),
* the knobs, the triggering exception and the active journal segment,
* the numerics plane's sentinel history and last audit
  (``obs/numerics.snapshot``), when it has any,

into ``flight-<pid>-<seq>-<reason>.json`` under ``obs_flight_dir``,
written tmp -> fsync -> atomic rename, so a process that dies mid-dump
never leaves a torn file.  At most ``obs_flight_keep`` bundles are kept a
directory, the oldest pruned.

Off by default (``obs_flight``); :func:`on_failure` with the knob off is a
config read.  Dumping never raises into the failure path it observes.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

from . import journal as obs_journal
from . import native as obs_native
from . import tracer

__all__ = ["enabled", "on_failure", "dump", "last_dump_path"]

SCHEMA = "tmpi-flight-v1"

_seq = itertools.count(1)
_last_path: Optional[str] = None


def enabled() -> bool:
    return bool(obs_native.cluster_config()["flight"])


def last_dump_path() -> Optional[str]:
    """Path of the most recent bundle this process wrote."""
    return _last_path


def on_failure(reason: str, exc: Optional[BaseException] = None,
               **context: Any) -> Optional[str]:
    """The failure-path hook: dump if the recorder is armed, swallow
    everything.  Returns the bundle path, or None (off / dump failed)."""
    if not enabled():
        return None
    try:
        return dump(reason, exc=exc, **context)
    except Exception:
        try:
            from ..utils.logging import get_logger

            get_logger("torchmpi_tpu_torch.obs.flight").exception(
                "flight-recorder dump failed for reason=%s (suppressed)",
                reason)
        except Exception:
            pass
        return None


def _counters() -> Dict[str, int]:
    out: Dict[str, int] = {}
    if obs_native.loaded("ps"):
        from ..parameterserver import native as ps_native

        out.update(ps_native.counters())
    client = sys.modules.get("torchmpi_tpu_torch.parameterserver")
    if client is not None:
        out.update(client.client_counters())
    return out


def dump(reason: str, exc: Optional[BaseException] = None,
         directory: Optional[str] = None, **context: Any) -> str:
    """Write one flight bundle now.  ``directory`` overrides the
    ``obs_flight_dir`` knob; "" falls back to the working directory."""
    global _last_path
    from ..runtime import config

    from .metrics import registry

    cfg = obs_native.cluster_config()
    directory = directory or cfg["flight_dir"] or "."
    os.makedirs(directory, exist_ok=True)
    events: Dict[str, Any] = {}
    for plane in ("hostcomm", "ps"):
        # Only loaded planes: a dump never forces a first-use build.
        if obs_native.loaded(plane):
            events[plane] = obs_native.events_to_rows(
                obs_native.drain_events(plane))
    try:
        registry.scrape_native()
    except Exception:
        pass  # half a panel beats no bundle
    bundle: Dict[str, Any] = {
        "schema": SCHEMA,
        "reason": str(reason),
        "pid": os.getpid(),
        "wall_time": time.time(),
        "monotonic_ns": tracer.now_ns(),
        "clock_offset_ns": tracer.clock_offset(),
        "context": obs_journal._jsonable(context),
        "exception": None if exc is None else {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-8000:],
        },
        "spans": obs_journal._jsonable(tracer.peek()),
        "events": events,
        "dropped": {"spans": tracer.dropped(),
                    "hostcomm": obs_native.dropped("hostcomm"),
                    "ps": obs_native.dropped("ps")},
        "counters": _counters(),
        "metrics": registry.snapshot(),
        "config": obs_journal._jsonable(config.snapshot()),
        # Joins the bundle to the journal record that brackets it.
        "journal_segment": obs_journal.active_segment(),
    }
    # The numerics plane's evidence (obs/numerics.py): the recent sentinel
    # history and the last audit verdict, only when it has any.
    from . import numerics

    num = numerics.snapshot()
    if num["history"] or num["last_audit"]:
        bundle["numerics"] = obs_journal._jsonable(num)
    path = os.path.join(
        directory, f"flight-{os.getpid()}-{next(_seq):04d}-{reason}.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _last_path = path
    obs_journal.prune_files(directory, "flight-*.json",
                            keep=max(1, cfg["flight_keep"]))
    obs_journal.emit("flight.dump", reason=str(reason), path=path)
    return path
