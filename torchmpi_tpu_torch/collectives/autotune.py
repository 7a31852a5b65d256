"""Measured collective autotuner: time every eligible implementation per
(op, dtype, bytes-bucket, placement, scope) cell, keep the winners, and let
the selector dispatch on measurement instead of the static table.

Counterpart of ``torchmpi_tpu/collectives/autotune.py`` for one process per
rank.  The JSON document's keys, the cell algebra, the metric names
(``tmpi_autotune_*``, the ``tmpi_autotune_cache_info`` gauge) and the
journal kinds (``autotune.cache``, ``autotune.pass``, the
``autotune.decision`` mark) are the JAX package's.

* :func:`run_pass` — interleaved best-of trials over every eligible
  candidate of ``selector.preferences()`` per cell.  Each rank times its
  own calls; the ranks then agree on each candidate's time (the max over
  the ranks of its best block) before a winner is picked, so every rank
  holds the same document and resolves every bucket to the same namespace
  (a rank on the ring kernels beside a rank on gloo would wait out the
  ring's timeout).
* A persisted winner cache keyed by a fingerprint: backend, device kind,
  rank count, process count, mesh shape and the knobs that change
  collective behaviour.  A cache whose fingerprint does not match the
  running world is never applied.  Only process rank 0 writes the file,
  and in a world of several processes only rank 0 reads it: the first
  measured resolution broadcasts its load (the doc or its absence), so
  every rank installs the same one.  That first resolution is a
  collective point, as the collective it resolves is.
* :func:`decide` — consulted by ``selector.resolve`` under
  ``autotune_mode`` ``cache`` or ``online`` (``off``, the default, never
  reaches it).  ``online`` folds the production means of the
  ``tmpi_collective_seconds`` histograms into the comparison; in a world
  of several processes only means agreed over the ranks at a collective
  point (:func:`agree_online`) move a resolution.
* The compiled pass (:func:`compiled_pass`) times knob variants of the
  registered programs (``runtime/topology.PROGRAMS``) on the running
  world: the port has no compile-only fabric, so every record is timed.
  Timed scores never tie exactly; variants whose times lie within
  :data:`COMPILED_TIE_REL` of the best, or whose best lies inside the
  best variant's measured range, count as tied, and a tie is no verdict.

A payload here is one rank's own tensor, so a cell is keyed by its full
``nbytes`` (JAX keys a rank-major ``(p, n)`` payload by its per-rank
bytes; the two agree on the same per-rank data).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import tracer as _tracer
from ..runtime import config

CACHE_VERSION = 1

#: ops the default pass measures (each must have at least one _DISPATCH row).
DEFAULT_OPS = ("allreduce", "reduce_scatter", "allgather", "broadcast",
               "reduce")

#: per-op kwargs for a sync bench call.
_OP_KWARGS: Dict[str, Dict[str, Any]] = {
    "allreduce": {"op": "sum"},
    "reduce": {"root": 0, "op": "sum"},
    "broadcast": {"root": 0},
    "allgather": {},
    "reduce_scatter": {"op": "sum"},
}

#: knobs folded into the fingerprint (JAX's list).
FINGERPRINT_KNOBS = (
    "manual_wire_dtype",
    "use_pallas_collectives",
    "use_hierarchical_collectives",
    "small_allreduce_size_cpu",
    "small_allreduce_size_gpu",
    "min_buffer_size",
    "max_buffer_size",
    "min_buffer_size_cpu",
    "max_buffer_size_cpu",
    "num_buffers_per_collective",
    "hc_frame_crc",
    "obs_trace",
)

_lock = threading.RLock()
_active: Optional[Dict[str, Any]] = None     # installed winner-cache doc
_load_attempted = False
# Memoized decisions: (op, placement, scope, mode, dtype, nbytes) ->
# [winner|None, refresh_countdown]; "online" entries recompute every
# _ONLINE_REFRESH hits.
_decisions: Dict[Tuple, List[Any]] = {}
_ONLINE_REFRESH = 64
# Bumped on every memo clear (install, clear, rekey, agreed online means):
# a verdict computed before a clear must not write into the fresh memo.
_generation = 0
# Production means agreed over the ranks by agree_online:
# {(op, bytes_bucket, namespace): (mean_seconds, samples)}.
_online_agreed: Optional[Dict[Tuple[str, str, str], Tuple[float, int]]] = None


def _registry():
    from ..obs import metrics

    return metrics.registry


def _count(name: str, help_: str, labels: Optional[Dict[str, str]] = None,
           ) -> None:
    _registry().counter(name, help_).inc(labels=labels)


def _stale_count() -> None:
    _count("tmpi_autotune_cache_stale_total",
           "winner caches REJECTED on a fingerprint mismatch (changed "
           "fabric or knob) — a stale cache is never applied")


# ------------------------------------------------------------- the world

def _device() -> torch.device:
    from ..runtime import lifecycle

    if lifecycle.started():
        return lifecycle.device()
    return torch.device("cpu")


def _backend() -> str:
    from ..runtime import lifecycle

    if lifecycle.started():
        return lifecycle.device().type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _device_kind(backend: str) -> str:
    if backend != "cuda":
        return "cpu"
    dev = _device()
    return torch.cuda.get_device_name(dev if dev.type == "cuda" else 0)


def _process_count() -> int:
    from ..runtime import lifecycle

    return lifecycle.process_count() if lifecycle.started() else 1


def _current_comm(comm=None):
    if comm is not None:
        return comm
    from ..runtime import communicator as _comm_mod

    try:
        return _comm_mod.stack.current()
    except Exception:  # noqa: BLE001 — pre-start fingerprinting is legal
        return None


def _agree(comm, values: Sequence[float], op: str = "max") -> List[float]:
    """``values`` reduced element-wise over the ranks of ``comm`` (max or
    min), so that every rank acts on the same numbers.  A world of one
    rank, or none started, returns them as they are."""
    vals = [float(v) for v in values]
    if comm is None or comm.size <= 1 or not vals:
        return vals
    import torch.distributed as dist

    if not dist.is_initialized():
        return vals
    group = comm.group
    dev = (_device() if dist.get_backend(group) == "nccl"
           else torch.device("cpu"))
    t = torch.tensor(vals, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                           else dist.ReduceOp.MIN), group=group)
    return t.cpu().tolist()


def _from_rank0(load):
    """``load()`` on process rank 0, its result on every process: one
    ``broadcast_object_list`` over the world when several processes run,
    which every one of them must reach at once; else ``load()`` here."""
    import torch.distributed as dist

    from ..runtime import lifecycle

    if (not lifecycle.started() or lifecycle.process_count() <= 1
            or not dist.is_initialized()):
        return load()
    box = [load() if lifecycle.process_rank() == 0 else None]
    kw = {}
    if dist.get_backend() == "nccl":
        kw["device"] = _device()
    dist.broadcast_object_list(box, src=0, **kw)
    return box[0]


def _is_writer() -> bool:
    """Only process rank 0 writes a shared file."""
    from ..runtime import lifecycle

    return not lifecycle.started() or lifecycle.process_rank() == 0


# ------------------------------------------------------------- fingerprint

def fingerprint(comm=None, topology: Optional[str] = None,
                process_count: Optional[int] = None) -> Dict[str, Any]:
    """The identity a winner cache is valid for: backend, device kind,
    rank count, process count, mesh shape, and the behaviour-relevant
    knobs (:data:`FINGERPRINT_KNOBS`).  ``topology=`` names a fabric this
    host does not own, which needs ``runtime/topology.py``'s named fabrics
    (ROADMAP item 20): it raises
    :class:`~torchmpi_tpu_torch.runtime.topology.NamedFabricUnavailable`.
    ``process_count=`` overrides the counted processes (the resize and
    election re-key)."""
    knobs = {k: config.get(k) for k in FINGERPRINT_KNOBS}
    if topology is not None:
        from ..runtime import topology as _topo

        _topo.topology_devices(topology)
    comm = _current_comm(comm)
    n = comm.size if comm is not None else 1
    backend = _backend()
    return {
        "version": CACHE_VERSION,
        "backend": backend,
        "device_kind": _device_kind(backend),
        "device_count": n,
        "process_count": (int(process_count) if process_count is not None
                          else _process_count()),
        "mesh_shape": [n],
        "knobs": knobs,
    }


def fingerprint_digest(fp: Dict[str, Any]) -> str:
    """Stable short digest of a fingerprint (blake2b over canonical JSON)."""
    blob = json.dumps(fp, sort_keys=True, default=str).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


# -------------------------------------------------------------- cell algebra

def cell_key(op: str, dtype: str, bucket: str, placement: str,
             scope: str) -> str:
    return "|".join((op, dtype, bucket, placement, scope))


def eligible(op: str, placement: str, scope: str, mode: str = "sync",
             ) -> List[str]:
    """The cell's candidates: the selector's preference order restricted to
    namespaces that implement ``op``."""
    from . import selector

    prefs = selector.preferences(placement, scope, mode)
    out: List[str] = []
    for impl in prefs:
        if impl not in out and (op, impl, mode) in selector._DISPATCH:
            out.append(impl)
    return out


def decisive_ops(placement: str = "tpu", scope: Optional[str] = None,
                 ops: Sequence[str] = DEFAULT_OPS) -> Tuple[str, ...]:
    """The ops of ``ops`` with two or more candidates here: the cells a
    pass can decide (a cell of one candidate only records its time)."""
    from . import selector

    scope = scope or selector._auto_scope()
    return tuple(op for op in ops
                 if len(eligible(op, placement, scope, "sync")) >= 2)


def _bytes_bucket(nbytes: int) -> str:
    from ..obs.metrics import bytes_bucket

    return bytes_bucket(nbytes)


# ------------------------------------------------------------ the tune pass

def _fence(out: Any) -> None:
    """Wait for a call's device work: a CUDA synchronisation of the
    output's stream (B1-B3 return host-synchronous; gloo on a CUDA tensor
    does not)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if isinstance(o, torch.Tensor) and o.is_cuda:
            torch.cuda.current_stream(o.device).synchronize()


def _auto_reps(nbytes: int) -> int:
    """Reps per timed block from a ~4 MiB payload-byte budget (floor 2,
    cap 16), unless ``autotune_reps`` is set."""
    knob = int(config.get("autotune_reps"))
    if knob > 0:
        return knob
    return int(max(2, min(16, (4 << 20) // max(nbytes, 1))))


def rank_row(rank: int, elements: int, dtype: str,
             device="cpu") -> torch.Tensor:
    """Row ``rank`` of JAX's rank-major pass payload
    ``(arange(p n) reshape (p, n)) % 13``: small integers, so every sum is
    exact in any order (and every mean at p = 2)."""
    x = torch.arange(rank * elements, (rank + 1) * elements,
                     dtype=torch.int64) % 13
    return x.to(getattr(torch, dtype)).to(device)


def _device_payload(comm, elements: int, dtype: str) -> torch.Tensor:
    """This rank's payload on the world's device (the device column)."""
    return rank_row(comm.rank, elements, dtype, _device())


def _host_payload(comm, elements: int, dtype: str) -> torch.Tensor:
    """This rank's payload in host memory (the host column)."""
    return rank_row(comm.rank, elements, dtype)


def _time_impl(fn, comm, payload, kwargs: Dict[str, Any], reps: int,
               warmup: int) -> float:
    """Seconds per call, fenced inside the timed block; warmup calls
    discarded."""
    for _ in range(warmup):
        _fence(fn(comm, payload, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(comm, payload, **kwargs)
    _fence(out)
    return (time.perf_counter() - t0) / reps


def run_pass(comm=None, ops: Sequence[str] = DEFAULT_OPS,
             sizes: Optional[Sequence[int]] = None,
             dtypes: Sequence[str] = ("float32",),
             placement: str = "tpu", scope: Optional[str] = None,
             trials: Optional[int] = None,
             payload_builder=None, install: bool = True) -> Dict[str, Any]:
    """The explicit autotune pass: measure every eligible candidate per
    (op, dtype, bytes-bucket) cell and return the winner-cache document.
    Every rank of ``comm`` calls it at once with the same arguments.

    Interleaved best-of: trial ``t`` times every candidate once before
    trial ``t+1`` starts; each candidate keeps its best block, and the
    ranks agree on the max over them of that best before the winner is
    picked.  ``install=True`` makes the result the active cache (inert
    until ``autotune_mode`` leaves ``off``).  Sizes default to JAX's:
    2^14, 2^18 and 2^21 elements on the card, 2^10 and 2^14 on the CPU.
    The default payload lies on the world's device for ``placement="tpu"``
    and in host memory for ``"cpu"``."""
    from . import selector

    comm = _current_comm(comm)
    if comm is None:
        raise RuntimeError("run_pass needs a started world or a comm")
    if sizes is None:
        sizes = ((1 << 14, 1 << 18, 1 << 21) if _backend() == "cuda"
                 else (1 << 10, 1 << 14))
    if trials is None:
        trials = int(config.get("autotune_trials"))
    trials = max(1, trials)
    warmup = max(0, int(config.get("autotune_warmup")))
    scope_r = scope or selector._auto_scope()
    build = payload_builder or (_host_payload if placement == "cpu"
                                else _device_payload)

    fp = fingerprint(comm)
    cells: Dict[str, Dict[str, Any]] = {}
    for dtype in dtypes:
        for n in sizes:
            # reduce_scatter needs the row divisible by the ring size.
            n_eff = max(comm.size, (n // comm.size) * comm.size)
            payload = build(comm, n_eff, dtype)
            meta = _payload_meta(payload, placement, rank_count=comm.size)
            nbytes = meta[1] if meta is not None else n_eff * 4
            bucket = _bytes_bucket(nbytes)
            for op in ops:
                cands = eligible(op, placement, scope_r, "sync")
                if not cands:
                    continue
                best: Dict[str, float] = {c: math.inf for c in cands}
                reps = _auto_reps(nbytes)
                for _ in range(trials):
                    for impl in cands:
                        fn = selector.resolve(op, placement, scope_r, "sync",
                                              prefer=impl)
                        with _tracer.span("autotune.bench", op=op, impl=impl,
                                          bytes=nbytes):
                            s = _time_impl(fn, comm, payload,
                                           _OP_KWARGS.get(op, {}), reps,
                                           warmup)
                        best[impl] = min(best[impl], s * 1e3)
                agreed = _agree(comm, [best[c] for c in cands], "max")
                best = dict(zip(cands, agreed))
                winner = min(best, key=best.get)
                cells[cell_key(op, dtype, bucket, placement, scope_r)] = {
                    "op": op, "dtype": dtype, "bytes": nbytes,
                    "bucket": bucket, "placement": placement,
                    "scope": scope_r,
                    "winner": winner, "default": cands[0],
                    "ms": {k: round(v, 4) for k, v in best.items()},
                    "reps": reps, "trials": trials,
                }
    doc = {
        "version": CACHE_VERSION,
        "fingerprint": fp,
        "digest": fingerprint_digest(fp),
        "created_unix": time.time(),
        "cells": cells,
    }
    _count("tmpi_autotune_pass_total",
           "explicit autotune passes completed by this process")
    _journal_emit("autotune.pass", digest=doc["digest"],
                  cells=len(cells), installed=bool(install))
    if install:
        _install(doc)
    return doc


def _journal_emit(kind: str, **data) -> None:
    from ..obs import journal as _journal

    _journal.emit(kind, **data)


# ----------------------------------------------------------------- the cache

def cache_path() -> str:
    """Where the winner cache persists: the ``autotune_cache_path`` knob,
    or ``~/.cache/torchmpi_tpu/autotune.json``."""
    p = str(config.get("autotune_cache_path"))
    if p:
        return os.path.expanduser(p)
    return os.path.join(os.path.expanduser("~"), ".cache", "torchmpi_tpu",
                        "autotune.json")


def save_cache(doc: Dict[str, Any], path: Optional[str] = None) -> str:
    """Persist a pass result atomically (tmp, fsync, rename).  Only process
    rank 0 writes: every rank holds the same agreed document."""
    from ..obs.export import atomic_write_json

    path = path or cache_path()
    if not _is_writer():
        return path
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return atomic_write_json(path, doc, indent=1)


def load_cache(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Load and validate a persisted cache against the running world's
    fingerprint: an unreadable file is a miss, a mismatched digest is
    stale, and neither is returned."""
    path = path or cache_path()
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        _count("tmpi_autotune_cache_miss_total",
               "winner-cache loads that found no readable cache")
        _journal_emit("autotune.cache", result="miss", path=path)
        return None
    current = fingerprint_digest(fingerprint())
    if (not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION
            or doc.get("digest") != current):
        _stale_count()
        _journal_emit("autotune.cache", result="stale", path=path,
                      cache_digest=str((doc or {}).get("digest", "?"))
                      if isinstance(doc, dict) else "?",
                      running_digest=current)
        return None
    _count("tmpi_autotune_cache_hit_total",
           "winner caches loaded with a matching topology fingerprint")
    _journal_emit("autotune.cache", result="hit", path=path,
                  cache_digest=str(doc.get("digest")),
                  cells=len(doc.get("cells", {})))
    return doc


def _install(doc: Dict[str, Any]) -> None:
    """Make ``doc`` the active winner cache and export its fingerprint as
    the one row of the ``tmpi_autotune_cache_info`` gauge."""
    global _active, _generation
    with _lock:
        _active = doc
        _decisions.clear()
        _generation += 1
    _registry().gauge(
        "tmpi_autotune_cache_info",
        "THE active autotune winner cache (constant 1; the cache "
        "fingerprint digest and cell count ride the labels)").replace(
            1.0, labels={"digest": str(doc.get("digest", "?")),
                         "cells": str(len(doc.get("cells", {})))})


def activate(doc: Optional[Dict[str, Any]] = None,
             path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Install a winner cache: an explicit ``doc`` or the validated
    persisted one (rank 0's, on every process at once:
    :func:`_from_rank0`)."""
    if doc is None:
        doc = _from_rank0(lambda: load_cache(path))
    if doc is not None:
        _install(doc)
    return doc


def active() -> Optional[Dict[str, Any]]:
    with _lock:
        return _active


def clear() -> None:
    """Drop the active cache, the one-shot load memo and the agreed online
    means."""
    global _active, _load_attempted, _generation, _online_agreed
    with _lock:
        _active = None
        _load_attempted = False
        _online_agreed = None
        _decisions.clear()
        _generation += 1
    g = _registry().peek("tmpi_autotune_cache_info")
    if g is not None:
        g.clear()


def rekey(process_count: Optional[int] = None,
          comm=None) -> Optional[Dict[str, Any]]:
    """Re-validate the active cache against the current world (the resize
    commit and the election failover call it): a cache measured at N
    processes is dropped, counted stale and journaled when the membership
    becomes M; one whose digest still matches keeps serving with its
    decision memo cleared.  Returns the surviving doc, or None."""
    global _generation
    doc = active()
    if doc is None:
        with _lock:
            _decisions.clear()
            _generation += 1
        return None
    fp = fingerprint(comm, process_count=process_count)
    current = fingerprint_digest(fp)
    if doc.get("digest") == current:
        with _lock:
            _decisions.clear()
            _generation += 1
        return doc
    _stale_count()
    _journal_emit("autotune.cache", result="rekey",
                  cache_digest=str(doc.get("digest", "?")),
                  running_digest=current,
                  process_count=process_count)
    clear()
    return None


def _ensure_loaded() -> Optional[Dict[str, Any]]:
    """One lazy load attempt per process, rank 0's in a world of several
    (:func:`_from_rank0`)."""
    global _load_attempted
    with _lock:
        if _active is not None or _load_attempted:
            return _active
        _load_attempted = True
    doc = _from_rank0(load_cache)
    if doc is not None:
        _install(doc)
    return active()


# ------------------------------------------------------------ the decision

def _payload_meta(payload, placement: str = "tpu",
                  rank_count: Optional[int] = None,
                  ) -> Optional[Tuple[str, int]]:
    """``(dtype, nbytes)`` of one rank's payload: its full size, whatever
    its shape (a port payload is never rank-major), on either column.
    ``placement`` and ``rank_count`` are JAX's arguments, unused here."""
    if isinstance(payload, torch.Tensor):
        return (str(payload.dtype).replace("torch.", ""),
                payload.numel() * payload.element_size())
    if isinstance(payload, np.ndarray):
        return str(payload.dtype), int(payload.nbytes)
    return None


def _find_cell(cells: Dict[str, Any], op: str, dtype: str, nbytes: int,
               placement: str, scope: str) -> Optional[Dict[str, Any]]:
    bucket = _bytes_bucket(nbytes)
    exact = cells.get(cell_key(op, dtype, bucket, placement, scope))
    if exact is not None:
        return exact
    # Nearest bytes-bucket with the same (op, dtype, placement, scope).
    best, best_d = None, None
    want = math.log2(max(nbytes, 1))
    for c in cells.values():
        if (c.get("op") != op or c.get("dtype") != dtype
                or c.get("placement") != placement
                or c.get("scope") != scope):
            continue
        d = abs(math.log2(max(int(c.get("bytes", 1)), 1)) - want)
        if best_d is None or d < best_d:
            best, best_d = c, d
    return best


def _online_sums() -> Dict[Tuple[str, str, str], List[float]]:
    """``{(op, bytes_bucket, "hostcomm"): [seconds, samples]}`` from this
    process's ``tmpi_collective_seconds`` histogram; async spellings fold
    onto the base op."""
    h = _registry().peek("tmpi_collective_seconds")
    if h is None:
        return {}
    acc: Dict[Tuple[str, str, str], List[float]] = {}
    for key, st in h._items():
        labels = dict(key)
        if labels.get("plane") != "hostcomm":
            continue
        op = labels.get("op", "")
        if op.endswith("_async"):
            op = op[: -len("_async")]
        k = (op, labels.get("bytes_bucket", "?"), "hostcomm")
        d = acc.setdefault(k, [0.0, 0])
        d[0] += float(st["sum"])
        d[1] += int(st["count"])
    return acc


def _online_observations() -> Dict[Tuple[str, str, str], Tuple[float, int]]:
    """Production means from this process's histograms:
    ``{(op, bytes_bucket, namespace): (mean_seconds, samples)}``."""
    return {k: (s / c, c) for k, (s, c) in _online_sums().items() if c > 0}


def agree_online(comm=None) -> Dict[Tuple[str, str, str], Tuple[float, int]]:
    """The collective point of ``online`` mode: every rank of ``comm``
    calls it at once (the engine does, at the step boundary).  The ranks'
    histogram sums are pooled, the pooled means become the ones
    :func:`decide` reads, and the decision memo is cleared, so every rank
    moves its resolutions at the same point on the same evidence."""
    global _online_agreed, _generation
    comm = _current_comm(comm)
    mine = _online_sums()
    if comm is not None and comm.size > 1:
        import torch.distributed as dist

        everyone: List[Any] = [None] * comm.size
        dist.all_gather_object(everyone, mine, group=comm.group)
    else:
        everyone = [mine]
    pooled: Dict[Tuple[str, str, str], List[float]] = {}
    for d in everyone:
        for k, (s, c) in d.items():
            acc = pooled.setdefault(tuple(k), [0.0, 0])
            acc[0] += s
            acc[1] += c
    agreed = {k: (s / c, c) for k, (s, c) in pooled.items() if c > 0}
    with _lock:
        _online_agreed = agreed
        _decisions.clear()
        _generation += 1
    return agreed


def _online_evidence() -> Dict[Tuple[str, str, str], Tuple[float, int]]:
    """What ``online`` mode folds in: this process's own means in a world
    of one process (JAX's rule), the agreed means in a world of several
    (none before the first :func:`agree_online`)."""
    if _process_count() <= 1:
        return _online_observations()
    with _lock:
        return dict(_online_agreed or {})


def decide(collective: str, placement: str, scope: str, mode: str,
           payload, candidates: Sequence[str]) -> Optional[str]:
    """The measured verdict for one resolution, or ``None`` (the static
    table).  ``cache``: the active pass winner for the payload's cell (the
    nearest bucket when none is exact).  ``online``: the same comparison
    with each candidate's ms replaced by its production mean where at
    least ``autotune_online_min_samples`` observations exist.  Async
    resolutions ride the sync cell.  A winner outside ``candidates`` is
    discarded, never forced."""
    am = str(config.get("autotune_mode"))
    if am not in ("cache", "online"):
        return None
    if _ensure_loaded() is None:
        return None
    with _lock:
        doc, gen = _active, _generation
    if doc is None:
        return None
    meta = _payload_meta(
        payload, placement,
        rank_count=(doc.get("fingerprint") or {}).get("device_count"))
    if meta is None:
        return None
    dtype, nbytes = meta
    key = (collective, placement, scope, am, dtype, nbytes)
    hit = _decisions.get(key)
    if hit is not None and (am != "online" or hit[1] > 0):
        if am == "online":
            hit[1] -= 1
        return hit[0]
    cell = _find_cell(doc.get("cells", {}), collective, dtype, nbytes,
                      placement, scope)
    winner: Optional[str] = None
    source = "cache"
    if cell is not None:
        ms = {k: float(v) for k, v in cell.get("ms", {}).items()
              if k in candidates}
        if am == "online" and ms:
            min_n = int(config.get("autotune_online_min_samples"))
            bucket = _bytes_bucket(nbytes)
            obs = _online_evidence()
            for ns in list(ms):
                mean_n = obs.get((collective, bucket, ns))
                if mean_n is not None and mean_n[1] >= min_n:
                    ms[ns] = mean_n[0] * 1e3
                    source = "online"
        if ms:
            winner = min(ms, key=ms.get)
    with _lock:
        if _active is doc and _generation == gen:
            _decisions[key] = [winner, _ONLINE_REFRESH]
    if winner is not None:
        _count("tmpi_autotune_decision_total",
               "measured winner computations (decisions are memoized per "
               "cell; online entries refresh periodically)",
               labels={"impl": winner, "op": collective})
        if _tracer.enabled():
            _tracer.dispatch_mark("autotune.decision", op=collective,
                                  impl=winner, bytes=nbytes,
                                  bucket=_bytes_bucket(nbytes),
                                  source=source)
    return winner


# ------------------------------------------------------ compiled-mode pass
#
# Knob variants of whole multi-rank programs (runtime/topology.PROGRAMS),
# each built and timed on the running world; the per-knob verdicts steer
# tp.resolve_wire_dtype("auto") and the selector's fallback preference
# under autotune_mode=cache|online.

#: knobs a compiled-pass variant may pin, left out of the base identity.
COMPILED_VARIED_KNOBS = (
    "manual_wire_dtype",
    "gradient_bucket_bytes",
    "use_hierarchical_collectives",
    "use_pallas_collectives",
)

#: default knob variants: (name, {knob: value}).
COMPILED_VARIANTS: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("wire_f32", {"manual_wire_dtype": "float32"}),
    ("wire_bf16", {"manual_wire_dtype": "bfloat16"}),
)

#: default program subset (JAX's).  Both read the wire knob in the port:
#: llama_dp_tp_step's tp sums ride it too, so neither is an insensitive
#: control here.
COMPILED_PROGRAMS = ("1f1b_manual_tp_combined", "llama_dp_tp_step")

#: timed variants within this fraction of the best time, or whose best
#: lies inside the best variant's measured range over reps and ranks, tie
#: with it; a tie is no verdict.  On an H100 the two wire variants of
#: llama_dp_tp_step, whose time its wire does not move, came out 7.5%
#: apart in one run of four and swapped order between runs: a margin below
#: that lets noise pick the wire.
COMPILED_TIE_REL = 0.10


def base_digest(fp: Dict[str, Any]) -> str:
    """A fingerprint digest with :data:`COMPILED_VARIED_KNOBS` removed:
    the identity a compiled doc matches the running world on."""
    fp = dict(fp)
    fp["knobs"] = {k: v for k, v in (fp.get("knobs") or {}).items()
                   if k not in COMPILED_VARIED_KNOBS}
    return fingerprint_digest(fp)


def _compiled_score(rec: Dict[str, Any]) -> Tuple[float, float]:
    """Lower is better: (timed seconds | collective operand bytes,
    peak-HBM bytes).  A failed build never wins."""
    if not rec.get("compile_ok"):
        return (math.inf, math.inf)
    if rec.get("wall_s") is not None:
        return (float(rec["wall_s"]), 0.0)
    coll = rec.get("collectives") or {}
    bytes_ = coll.get("operand_bytes") or {}
    mem = rec.get("memory") or {}
    return (float(sum(bytes_.values())),
            float(mem.get("peak_hbm_bytes", 0)))


def _spread(rec: Dict[str, Any]) -> float:
    s = rec.get("samples_s") or []
    return (max(s) - min(s)) if len(s) > 1 else 0.0


def _compiled_winner(recs: Dict[str, Any]) -> Optional[str]:
    """The one best variant, or None on a tie.  Scores from HLO bytes tie
    only when equal (JAX's rule); timed scores tie within
    :data:`COMPILED_TIE_REL` of the best or when their ranges overlap (a
    variant's best no slower than the best variant's worst).  A slow rep
    of the slower variant widens its own range only, which overlaps
    nothing."""
    ok = [n for n, v in recs.items() if v.get("compile_ok")]
    if not ok:
        return None
    scores = {n: _compiled_score(recs[n]) for n in ok}
    best = min(scores.values())
    lead = min(ok, key=lambda n: scores[n])
    if all(recs[n].get("wall_s") is not None for n in ok):
        tied = [n for n in ok if scores[n][0] - best[0] <= max(
            COMPILED_TIE_REL * best[0], _spread(recs[lead]))]
    else:
        tied = [n for n in ok if scores[n] == best]
    return tied[0] if len(tied) == 1 else None


def _fence_all() -> None:
    if _device().type == "cuda":
        torch.cuda.synchronize(_device())


def _time_program(fn, args, warmup: int, reps: int
                  ) -> Tuple[List[float], float]:
    """Seconds of each of ``reps`` timed calls after ``warmup`` untimed
    ones, and the first call's loss (NaN where the program returns
    none)."""
    out, first = [], None
    for i in range(warmup + reps):
        t0 = time.perf_counter()
        loss = fn(*args)
        _fence_all()
        if i >= warmup:
            out.append(time.perf_counter() - t0)
        if first is None:
            first = float(loss) if loss is not None else math.nan
    return out, first


def compiled_pass(topology: Optional[str] = None,
                  programs: Optional[Sequence[str]] = None,
                  variants: Optional[Sequence[Tuple[str, Dict[str, Any]]]]
                  = None,
                  timed: Optional[bool] = None,
                  install: bool = False,
                  save: bool = False,
                  comm=None,
                  warmup: int = 1, reps: int = 3,
                  build_kw: Optional[Dict[str, Any]] = None,
                  ) -> Dict[str, Any]:
    """Build and time knob variants of the registered programs on the
    running world and record per-program winners.  Every rank calls it at
    once; each variant's time is the max over the ranks of its best of
    ``reps`` after ``warmup`` calls, and a variant counts as built only if
    it built and ran on every rank.  Each variant's record keeps its
    ``first_loss``, the loss of its first step from the program's seeded
    weights, as ``[min, max]`` over the ranks (the max inf where a rank
    saw no finite loss).

    ``topology`` names a fabric this host does not own (ROADMAP item 20)
    and raises; ``timed=False`` (JAX's compile-only scoring) raises too.
    Variants pin knobs around the build, and every pinned knob is
    restored.  ``build_kw`` goes to each program's builder (its ``cfg``,
    ``batch``, ``seq``, ``dtype``)."""
    from ..runtime import topology as _topo

    if topology is not None:
        _topo.topology_devices(topology)
    if timed is False:
        raise _topo.NamedFabricUnavailable(
            "compiled_pass(timed=False) scores compile-only HLO, which "
            "needs runtime/topology.py's named fabrics (ROADMAP item 20); "
            "the port times the running world")
    comm = _current_comm(comm)
    labels = list(COMPILED_PROGRAMS if programs is None else programs)
    unknown = [l for l in labels if l not in _topo.PROGRAMS]
    if unknown:
        raise KeyError(f"unknown programs {unknown}; "
                       f"known: {list(_topo.PROGRAMS)}")
    vars_ = list(COMPILED_VARIANTS if variants is None else variants)
    varied = sorted({k for _, knobs in vars_ for k in knobs})
    fp = fingerprint(comm)
    priors = {k: config.get(k) for k in varied}
    progs: Dict[str, Any] = {}
    try:
        for label in labels:
            recs: Dict[str, Any] = {}
            for vname, knobs in vars_:
                for k in varied:
                    config.set(k, knobs.get(k, priors[k]))
                rec: Dict[str, Any] = {"program": label, "variant": vname,
                                       "knobs": dict(knobs)}
                samples: List[float] = []
                first = math.nan
                try:
                    with _tracer.span("autotune.compile", program=label,
                                      variant=vname):
                        fn, args = _topo.PROGRAMS[label](
                            None, **(build_kw or {}))
                        samples, first = _time_program(fn, args, warmup,
                                                       max(1, reps))
                    ok = 1.0
                except Exception as e:  # noqa: BLE001 — record, not abort
                    rec["error"] = f"{type(e).__name__}: {str(e)[:600]}"
                    ok = 0.0
                    fn = args = None
                agreed = _agree(comm, [ok], "min")[0]
                if not math.isfinite(first):
                    first = math.inf    # a max over ranks keeps it
                worst = _agree(comm, [min(samples) if samples else math.inf,
                                      max(samples) if samples else math.inf,
                                      first, -first], "max")
                rec["compile_ok"] = bool(agreed)
                if rec["compile_ok"]:
                    rec["wall_s"] = worst[0]
                    rec["samples_s"] = ([worst[0], worst[1]]
                                        if len(samples) > 1 else [worst[0]])
                    rec["first_loss"] = [-worst[3], worst[2]]
                recs[vname] = rec
                del fn, args
            progs[label] = {"winner": _compiled_winner(recs),
                            "variants": recs}
    finally:
        for k in varied:
            config.set(k, priors[k])

    doc = {
        "version": CACHE_VERSION,
        "kind": "compiled",
        "topology": "running",
        "fingerprint": fp,
        "digest": fingerprint_digest(fp),
        "base_digest": base_digest(fp),
        "created_unix": time.time(),
        "timed": True,
        "programs": progs,
        "knob_winners": _knob_winners(progs, vars_),
    }
    _count("tmpi_autotune_compiled_pass_total",
           "compiled-mode autotune passes (knob-variant sweeps) completed "
           "by this process")
    _journal_emit("autotune.compiled_pass", topology="running",
                  digest=doc["digest"], programs=len(progs),
                  winners={l: p["winner"] for l, p in progs.items()},
                  knob_winners=doc["knob_winners"])
    if save:
        save_compiled(doc)
    if install:
        activate_compiled(doc, validate=False)
    return doc


def _knob_winners(progs: Dict[str, Any],
                  vars_: Sequence[Tuple[str, Dict[str, Any]]],
                  ) -> Dict[str, Any]:
    """Per-knob verdicts aggregated across program winners: each winning
    variant votes for every (knob, value) it pins; a knob's winner is the
    value with the most votes (a split jury pins nothing)."""
    by_name = dict(vars_)
    votes: Dict[str, Dict[str, int]] = {}
    for p in progs.values():
        w = p.get("winner")
        if w is None:
            continue
        for k, v in (by_name.get(w) or {}).items():
            votes.setdefault(k, {})[json.dumps(v)] = (
                votes.setdefault(k, {}).get(json.dumps(v), 0) + 1)
    out: Dict[str, Any] = {}
    for k, tally in votes.items():
        best = max(tally.values())
        tops = [v for v, n in tally.items() if n == best]
        if len(tops) == 1:
            out[k] = json.loads(tops[0])
    return out


def compiled_cache_path() -> str:
    """Beside the eager cache: one file holding every world's doc keyed
    by its fingerprint digest."""
    p = cache_path()
    root, ext = os.path.splitext(p)
    return root + ".compiled" + (ext or ".json")


def save_compiled(doc: Dict[str, Any],
                  path: Optional[str] = None) -> str:
    """Merge one world's compiled doc into the store atomically (process
    rank 0 only)."""
    from ..obs.export import atomic_write_json

    path = path or compiled_cache_path()
    if not _is_writer():
        return path
    store: Dict[str, Any] = {"version": CACHE_VERSION, "fabrics": {}}
    try:
        with open(path) as f:
            prior = json.load(f)
        if (isinstance(prior, dict)
                and prior.get("version") == CACHE_VERSION
                and isinstance(prior.get("fabrics"), dict)):
            store = prior
    except (OSError, ValueError):
        pass
    store["fabrics"][str(doc.get("digest"))] = doc
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return atomic_write_json(path, store, indent=1)


def load_compiled(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The persisted compiled doc whose base identity matches the running
    world, or None."""
    path = path or compiled_cache_path()
    try:
        with open(path) as f:
            store = json.load(f)
    except (OSError, ValueError):
        return None
    if (not isinstance(store, dict)
            or store.get("version") != CACHE_VERSION):
        return None
    want = base_digest(fingerprint())
    for doc in (store.get("fabrics") or {}).values():
        if isinstance(doc, dict) and doc.get("base_digest") == want:
            _count("tmpi_autotune_cache_hit_total",
                   "winner caches loaded with a matching topology "
                   "fingerprint")
            return doc
    _stale_count()
    return None


_compiled_active: Optional[Dict[str, Any]] = None
_compiled_load_attempted = False


def activate_compiled(doc: Optional[Dict[str, Any]] = None,
                      validate: bool = True) -> Optional[Dict[str, Any]]:
    """Install a compiled doc for :func:`compiled_wire_dtype` and
    :func:`compiled_preference`; with ``validate`` a doc whose base digest
    does not match the running world is refused.  No ``doc``: the
    persisted one, rank 0's on every process at once."""
    global _compiled_active
    if doc is None:
        doc = _from_rank0(load_compiled)
        validate = False
    if doc is not None and validate:
        if doc.get("base_digest") != base_digest(fingerprint()):
            _stale_count()
            _journal_emit("autotune.cache", result="compiled_stale",
                          cache_digest=str(doc.get("base_digest", "?")))
            return None
    with _lock:
        _compiled_active = doc
    if doc is not None:
        _journal_emit("autotune.cache", result="compiled_active",
                      topology=doc.get("topology"),
                      knob_winners=doc.get("knob_winners"))
    return doc


def compiled_active() -> Optional[Dict[str, Any]]:
    with _lock:
        return _compiled_active


def clear_compiled() -> None:
    """Drop the active compiled doc and its one-shot load memo."""
    global _compiled_active, _compiled_load_attempted
    with _lock:
        _compiled_active = None
        _compiled_load_attempted = False


def _compiled_ensure_loaded() -> Optional[Dict[str, Any]]:
    """As :func:`_ensure_loaded`, for the compiled store."""
    global _compiled_load_attempted
    with _lock:
        if _compiled_active is not None or _compiled_load_attempted:
            return _compiled_active
        _compiled_load_attempted = True
    doc = _from_rank0(load_compiled)
    if doc is not None:
        activate_compiled(doc, validate=False)
    return compiled_active()


def compiled_wire_dtype() -> Optional[str]:
    """The compiled pass's ``manual_wire_dtype`` verdict ("bfloat16" or
    "float32"), or None; consulted by ``tp.resolve_wire_dtype("auto")``
    under ``autotune_mode`` ``cache`` or ``online`` only."""
    if str(config.get("autotune_mode")) not in ("cache", "online"):
        return None
    doc = _compiled_ensure_loaded()
    if doc is None:
        return None
    w = (doc.get("knob_winners") or {}).get("manual_wire_dtype")
    return w if w in ("bfloat16", "float32") else None


def compiled_preference(op: str, placement: str,
                        scope: str) -> Optional[str]:
    """A namespace preference from the compiled knob winners, for
    ``selector.resolve`` when the eager cache has no verdict: a pallas-on
    winner prefers the ring kernels, a hierarchical-on winner the
    hierarchical tree.  Device column only."""
    if placement != "tpu":
        return None
    doc = compiled_active()
    if doc is None:
        return None
    kw = doc.get("knob_winners") or {}
    if kw.get("use_pallas_collectives") is True:
        return "pallas"
    if kw.get("use_hierarchical_collectives") is True:
        return "hierarchical"
    return None


def mix_drift(doc: Optional[Dict[str, Any]] = None,
              min_samples: int = 1, publish: bool = True) -> float:
    """The fraction of ``tmpi_collective_seconds`` samples (async
    spellings folded) in an (op, bytes-bucket) the active cache holds no
    cell for; published as the ``tmpi_autotune_mix_drift`` gauge, the
    series the ``autotune_mix_drift`` alert watches.  No cache, or fewer
    than ``min_samples`` observations, gives 0.0."""
    if doc is None:
        doc = active()
    cached = {(c.get("op"), c.get("bucket"))
              for c in (doc or {}).get("cells", {}).values()}
    total = uncovered = 0
    h = _registry().peek("tmpi_collective_seconds")
    if h is not None:
        for key, st in h._items():
            labels = dict(key)
            op = labels.get("op", "")
            if op.endswith("_async"):
                op = op[: -len("_async")]
            n = int(st["count"])
            total += n
            if (op, labels.get("bytes_bucket")) not in cached:
                uncovered += n
    drift = (uncovered / total
             if doc is not None and total >= max(1, min_samples) else 0.0)
    if publish:
        _registry().gauge(
            "tmpi_autotune_mix_drift",
            "fraction of live collective traffic (by sample count) in "
            "(op, bytes-bucket) cells the active autotune cache never "
            "measured — the autotune_mix_drift alert's series").set(drift)
    return drift


# ------------------------------------------------------- bench integrations

def guarded_bench_section(log=None) -> Dict[str, Any]:
    """:func:`bench_section` for standalone bench scripts: uses the
    started world (it never starts one: the caller chose the device) and
    never raises."""
    try:
        from ..runtime import communicator as _comm_mod
        from ..runtime import lifecycle

        if not lifecycle.started():
            raise RuntimeError("no started world (call start() first)")
        return bench_section(comm=_comm_mod.stack.current())
    except Exception as e:  # noqa: BLE001 — diagnostic, never fatal
        if log is not None:
            log(f"autotune section unavailable ({e!r})")
        return {"error": str(e)[:200]}


def bench_section(comm=None, ops: Sequence[str] = ("allreduce",),
                  sizes: Optional[Sequence[int]] = None,
                  dtypes: Sequence[str] = ("float32",),
                  trials: int = 2, ab_elements: Optional[int] = None,
                  ab_reps: int = 8) -> Dict[str, Any]:
    """The ``autotune`` section a bench records: a quick pass's per-cell
    winners, and the same allreduce loop timed through ``resolve`` with
    ``autotune_mode=off`` and with ``cache`` (``default_ms``,
    ``autotuned_ms``, their ratio).  Every rank calls it at once.  The
    process's active cache and mode are restored after."""
    from . import selector

    comm = _current_comm(comm)
    prior_doc = active()
    doc = run_pass(comm=comm, ops=ops, sizes=sizes, dtypes=dtypes,
                   trials=trials, install=True)
    cells = {}
    for k, c in doc["cells"].items():
        cells[k] = {"winner": c["winner"], "default": c["default"],
                    "ms": c["ms"],
                    "ab_delta_ms": round(c["ms"][c["default"]]
                                         - c["ms"][c["winner"]], 4)}
    if ab_elements is None:
        ab_elements = (1 << 18) if _backend() == "cuda" else (1 << 12)
    n = max(comm.size, (ab_elements // comm.size) * comm.size)
    payload = _device_payload(comm, n, dtypes[0])
    prior = str(config.get("autotune_mode"))

    def _loop() -> float:
        fn = selector.resolve("allreduce", payload=payload)
        _fence(fn(comm, payload, op="sum"))
        t0 = time.perf_counter()
        out = None
        for _ in range(ab_reps):
            fn = selector.resolve("allreduce", payload=payload)
            out = fn(comm, payload, op="sum")
        _fence(out)
        return (time.perf_counter() - t0) / ab_reps * 1e3

    try:
        config.set("autotune_mode", "off")
        default_ms = _loop()
        config.set("autotune_mode", "cache")
        autotuned_ms = _loop()
    finally:
        config.set("autotune_mode", prior)
        if prior_doc is not None:
            _install(prior_doc)
        else:
            clear()
    return {
        "mode": prior,
        "fingerprint_digest": doc["digest"],
        "fingerprint": doc["fingerprint"],
        "cells": cells,
        "ab": {
            "elements": n,
            "reps": ab_reps,
            "default_ms": round(default_ms, 4),
            "autotuned_ms": round(autotuned_ms, 4),
            "ratio": round(autotuned_ms / max(default_ms, 1e-9), 4),
        },
    }


def overlap_ab(n_buckets: int = 5, bucket_elements: int = 1 << 16,
               update_passes: int = 60, reps: int = 3,
               wire_delay_ms: float = 1.0) -> Dict[str, Any]:
    """Measured A/B of the two async-gradient drain disciplines over a
    2-rank loopback host ring (both ranks threads of this process, every
    forwarded chunk delayed ``wire_delay_ms`` by a chaos proxy): ``barrier``
    waits every handle then updates every bucket; ``ready`` updates bucket
    i as soon as it lands while later buckets are in flight.
    ``overlap_fraction`` is the share of the wall the measured rank was
    not blocked in a wait; ``win`` is ready's minus barrier's.  Both
    disciplines' end states are held equal first.  Local to this process
    (no process group, no ring kernel), so it is safe on a thread beside a
    live step loop."""
    from concurrent.futures import ThreadPoolExecutor

    from ..runtime import chaos
    from ..runtime.failure import HostcommError
    from .hostcomm import HostCommunicator, free_ports

    def rank_fn(comm: HostCommunicator, rank: int) -> Dict[str, Any]:
        gen = torch.Generator().manual_seed(7)
        grads = [torch.randn(bucket_elements, generator=gen)
                 for _ in range(n_buckets)]

        def update(g: torch.Tensor) -> torch.Tensor:
            p = torch.zeros_like(g)
            for _ in range(update_passes):
                p = p - 0.01 * (g + 1e-4 * p)
            return p

        def one(discipline: str):
            t_start = time.perf_counter()
            handles = [comm.allreduce_async(g.clone()) for g in grads]
            blocked = 0.0
            outs: List[Any] = [None] * n_buckets
            if rank != 0:
                outs = [h.wait() for h in handles]
            elif discipline == "barrier":
                t0 = time.perf_counter()
                waited = [h.wait() for h in handles]
                blocked += time.perf_counter() - t0
                outs = [update(w) for w in waited]
            else:
                for i, h in enumerate(handles):
                    t0 = time.perf_counter()
                    w = h.wait()
                    blocked += time.perf_counter() - t0
                    outs[i] = update(w)
            total = time.perf_counter() - t_start
            return total, blocked, outs

        res = {}
        for discipline in ("barrier", "ready"):
            best = None
            for _ in range(reps):
                total, blocked, outs = one(discipline)
                comm.barrier()
                if best is None or total < best[0]:
                    best = (total, blocked, outs)
            total, blocked, outs = best
            res[discipline] = {
                "ms": round(total * 1e3, 3),
                "blocked_ms": round(blocked * 1e3, 3),
                "overlap_fraction": round(1.0 - blocked / max(total, 1e-12),
                                          4),
                "_outs": outs,
            }
        return res

    def wire(ex):
        """The proxies and both ranks of the loopback ring.  A port picked
        free may be taken by another socket of the process before its
        rank binds it (the proxies bind ports of their own meanwhile), so
        a ring that fails to wire is made again on fresh ports, at most
        three times."""
        for attempt in range(3):
            eps = [("127.0.0.1", p) for p in free_ports(2)]
            proxies, per_rank = chaos.ring_endpoints(
                eps, chaos.FaultSpec(delay_ms=float(wire_delay_ms)), seed=7)
            futs = [ex.submit(HostCommunicator, r, 2, per_rank[r], 60000,
                              io_deadline_ms=60000) for r in range(2)]
            comms, errors = [], []
            for f in futs:
                try:
                    comms.append(f.result(timeout=90))
                except HostcommError as e:
                    errors.append(e)
            if not errors:
                return proxies, comms
            for c in comms:
                c.close()
            for p in proxies:
                p.close()
            if attempt == 2:
                raise errors[0]

    with ThreadPoolExecutor(2) as ex:
        proxies, comms = wire(ex)
        try:
            futs = [ex.submit(rank_fn, c, r) for r, c in enumerate(comms)]
            results = [f.result(timeout=180) for f in futs]
        finally:
            for c in comms:
                c.close()
            for p in proxies:
                p.close()
    for res in results:
        for a, b in zip(res["barrier"].pop("_outs"), res["ready"].pop("_outs")):
            if not torch.equal(a, b):
                raise AssertionError("overlap_ab: the drain disciplines "
                                     "landed different end states")
    out = {k: v for k, v in results[0].items()}
    out["buckets"] = n_buckets
    out["bytes_per_bucket"] = bucket_elements * 4
    out["wire_delay_ms"] = float(wire_delay_ms)
    out["win"] = round(out["ready"]["overlap_fraction"]
                       - out["barrier"]["overlap_fraction"], 4)
    return out
