"""The numerics plane: the telemetry that watches the values, not the clock.

Counterpart of ``torchmpi_tpu/obs/numerics.py``, with every public name of
it.  Spans, stragglers and ``/healthz`` liveness say whether a rank moves;
this module says whether it computes the right numbers:

* **In-step sentinels** (:func:`sentinel_stats`): per-bucket gradient L2
  norms at the collective-bucket granularity (``nn.bucketing``), the global
  gradient norm, the count of non-finite gradient entries and the
  update/param norm ratio, computed on the gradients' device in f32.  The
  engine computes them in ``compiled`` mode when ``numerics_mode`` is
  ``sentinel`` or ``audit``; :func:`record_sentinels` reads them to the
  host once a step and publishes the ``tmpi_numerics_*`` gauges, counter
  and histogram, and keeps a bounded history ring that flight bundles
  carry.  ``off`` (the default) leaves the step as it was: no extra
  launch, no host read.
* **Cross-rank consistency auditor** (:class:`Auditor`): every
  ``numerics_audit_interval`` steps each rank folds a blake2b fingerprint
  over its parameter leaves and allgathers the 16 bytes over a host-plane
  communicator (``collectives/hostcomm.py``).  On a mismatch it searches
  the leaves by halves, one 16-byte allgather a round, to name the first
  divergent leaf, votes on the outlier rank, bumps
  ``tmpi_numerics_divergence_total``, sets the ``diverged`` health state on
  the outlier (HTTP 503), journals a ``numerics.audit`` record and dumps a
  flight bundle.  Digests are byte-equal to the JAX package's for the same
  values: the same path string as ``jax.tree_util.keystr``, dtype name,
  shape and raw bytes (a bf16 leaf through its 16-bit words).
* **Compute-efficiency gauges** (:func:`probe_step_flops`,
  :func:`publish_flops`): ``tmpi_step_flops`` and ``tmpi_mfu_estimate``.
  JAX reads XLA's cost model without running the step; the port has no
  such model, so the probe counts the FLOPs of a real step with
  ``torch.utils.flop_counter.FlopCounterMode``.  Flash attention's
  forward and backward are operators of their own with a registered
  formula (``ops/flash_attention.attention_flops``), so the mode counts
  each call by it whichever route runs.  A port rank is one process on
  one card, so the MFU divides by one card, not by a device count.

Proof by drill: ``python -m torchmpi_tpu_torch.obs drill --numerics``
(``obs/__main__.py``); on the card, ``tools/numerics_drill.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..utils import tree as _tree

__all__ = [
    "Auditor",
    "AuditResult",
    "DIGEST_BYTES",
    "MODES",
    "device_peak_flops",
    "fold_digests",
    "history",
    "leaf_digests",
    "majority_vote",
    "numerics_config",
    "probe_step_flops",
    "publish_flops",
    "record_sentinels",
    "reset",
    "sentinel_stats",
    "sentinels_enabled",
    "snapshot",
    "tree_digest",
]

#: per-leaf and folded digest width (blake2b truncated): every audit
#: exchange is a 16-byte allgather.
DIGEST_BYTES = 16

MODES = ("off", "sentinel", "audit")
#: the modes that carry the in-step sentinels (audit is sentinel plus the
#: cross-rank digest exchange): the one predicate the engine and
#: ``serve.metrics_feed`` consult.
SENTINEL_MODES = ("sentinel", "audit")

#: histogram buckets for gradient norms: powers of ten.
NORM_BUCKETS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0, 1000.0)


def numerics_config() -> Dict[str, Any]:
    """The ``numerics_*`` knobs in one read."""
    from ..runtime import config

    return {
        "mode": str(config.get("numerics_mode")),
        "audit_interval": int(config.get("numerics_audit_interval")),
        "history": int(config.get("numerics_history")),
    }


def sentinels_enabled() -> bool:
    """Whether the engine's step should compute the in-step sentinels."""
    return numerics_config()["mode"] in SENTINEL_MODES


# ------------------------------------------------------------- sentinels

def _packed(leaves: List[torch.Tensor], plan):
    """Each bucket of ``plan`` as one flat tensor: its leaves packed (a
    bucket holds at most ``gradient_bucket_bytes``, or one larger leaf,
    which is not copied)."""
    for spec in plan.specs:
        idx = spec.leaf_indices
        yield (leaves[idx[0]].reshape(-1) if len(idx) == 1 else
               torch.cat([leaves[i].reshape(-1) for i in idx]))


def _sq_sum(flat: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of a flat tensor.  Not ``vector_norm``: on
    the CPU its f32 accumulation is off by 2.5e-5 relative at 1.9M
    elements, where the sum's pairwise accumulation holds 1e-8."""
    return flat.float().square().sum()


def _bucket_stats(leaves: List[torch.Tensor], plan
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each bucket's squared L2 norm (f32) and the count of non-finite
    entries over all leaves: one packed reduction of each kind a
    bucket."""
    sq, bad = [], []
    for flat in _packed(leaves, plan):
        sq.append(_sq_sum(flat))
        bad.append(flat.numel() - torch.isfinite(flat).sum())
    return torch.stack(sq), torch.stack(bad).sum().to(torch.int32)


def _global_norm(tree: Any) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``tree``, packed by buckets."""
    from ..nn import bucketing

    leaves = _tree.leaves(tree)
    return torch.stack([_sq_sum(flat) for flat in _packed(
        leaves, bucketing.plan_buckets(tree))]).sum().sqrt()


def sentinel_stats(params: Any, grads: Any,
                   updates: Optional[Any] = None) -> Dict[str, Any]:
    """The step's sentinel statistics, as tensors on the gradients' device
    (nothing is read to the host here):

    * ``bucket_grad_norms`` — per-bucket gradient L2 norms at the
      collective-bucket granularity (``nn.bucketing.plan_buckets``);
    * ``grad_norm`` — the global gradient L2 norm;
    * ``nonfinite_count`` — the total of non-finite gradient entries
      (int32);
    * ``update_ratio`` — ||update|| / ||param||, when ``updates`` is
      given.

    Everything accumulates in f32 whatever the leaves' dtype."""
    from ..nn import bucketing

    plan = bucketing.plan_buckets(grads)
    leaves = _tree.leaves(grads)
    if plan.specs:
        bucket_sq, nonfinite = _bucket_stats(leaves, plan)
        total_sq = bucket_sq.sum()
    else:
        bucket_sq = torch.zeros((0,), dtype=torch.float32)
        total_sq = torch.zeros((), dtype=torch.float32)
        nonfinite = torch.zeros((), dtype=torch.int32)
    stats: Dict[str, Any] = {
        "bucket_grad_norms": bucket_sq.sqrt(),
        "grad_norm": total_sq.sqrt(),
        "nonfinite_count": nonfinite,
    }
    if updates is not None:
        stats["update_ratio"] = (
            _global_norm(updates) / _global_norm(params).clamp_min(1e-12))
    return stats


_KEYS = ("bucket_grad_norms", "grad_norm", "nonfinite_count",
         "update_ratio")


def _to_host(stats: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The stats as host arrays: tensors packed into one float64 vector
    and copied with one read, anything else through numpy."""
    keys = [k for k in _KEYS if k in stats]
    vals = [stats[k] for k in keys]
    if not all(isinstance(v, torch.Tensor) for v in vals):
        return {k: np.asarray(v.detach().cpu() if isinstance(
            v, torch.Tensor) else v) for k, v in zip(keys, vals)}
    flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                      for v in vals]).cpu().numpy()
    out, off = {}, 0
    for k, v in zip(keys, vals):
        n = v.numel()
        out[k] = flat[off:off + n].reshape(tuple(v.shape))
        off += n
    return out


_lock = threading.Lock()
_history: collections.deque = collections.deque(maxlen=64)
_last_audit: Optional[Dict[str, Any]] = None


def record_sentinels(step: Optional[int], stats: Dict[str, Any],
                     registry=None) -> Dict[str, Any]:
    """The host side of one step's sentinels: read them (the step's one
    host read of its stats), publish the ``tmpi_numerics_*`` gauges,
    counter and histogram, and append to the bounded history ring."""
    if registry is None:
        from .metrics import registry as registry_
        registry = registry_
    host = _to_host(stats)
    rec: Dict[str, Any] = {
        "step": None if step is None else int(step),
        "grad_norm": float(host["grad_norm"]),
        "nonfinite": int(host["nonfinite_count"]),
        "bucket_grad_norms": [round(float(v), 6) for v in
                              np.asarray(host["bucket_grad_norms"])],
        "wall_time": time.time(),
    }
    if "update_ratio" in host:
        rec["update_ratio"] = float(host["update_ratio"])
    registry.gauge(
        "tmpi_numerics_grad_norm",
        "global gradient L2 norm of the most recent engine step").set(
            rec["grad_norm"])
    registry.gauge(
        "tmpi_numerics_nonfinite",
        "non-finite gradient entries in the most recent engine step").set(
            float(rec["nonfinite"]))
    if rec["nonfinite"]:
        registry.counter(
            "tmpi_numerics_nonfinite_total",
            "non-finite gradient entries the in-step sentinels caught",
        ).inc(float(rec["nonfinite"]))
    if "update_ratio" in rec:
        registry.gauge(
            "tmpi_numerics_update_ratio",
            "update/param L2 norm ratio of the most recent engine step",
        ).set(rec["update_ratio"])
    h = registry.histogram(
        "tmpi_numerics_bucket_grad_norm",
        "per-collective-bucket gradient L2 norms from the in-step "
        "sentinels", buckets=NORM_BUCKETS)
    for v in rec["bucket_grad_norms"]:
        if np.isfinite(v):
            h.observe(v)
    cap = max(1, numerics_config()["history"])
    with _lock:
        global _history
        if _history.maxlen != cap:
            _history = collections.deque(_history, maxlen=cap)
        _history.append(rec)
    return rec


def history(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The most recent ``n`` sentinel records (all when None), oldest
    first."""
    with _lock:
        out = list(_history)
    return out[-n:] if n else out


def snapshot() -> Dict[str, Any]:
    """What a flight bundle embeds: the sentinel history and the last
    audit verdict (either may be empty)."""
    with _lock:
        return {"history": list(_history), "last_audit": _last_audit}


def reset() -> None:
    """Forget the history and the last audit (the ring is per process)."""
    global _last_audit
    with _lock:
        _history.clear()
        _last_audit = None


def _set_last_audit(doc: Dict[str, Any]) -> None:
    global _last_audit
    with _lock:
        _last_audit = doc


# --------------------------------------------------------------- digests

def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a tensor's dtype (``"float32"``, ``"bfloat16"``)."""
    return str(t.dtype).replace("torch.", "")


def _leaf_bytes(leaf: Any) -> Tuple[str, str, bytes]:
    """A leaf's dtype name, shape string and raw bytes: a tensor copied to
    the host once (a bf16 one through its 16-bit words, which numpy
    cannot hold as bf16), anything else through numpy.  The shape is the
    one JAX hashes, that of ``np.ascontiguousarray``, which makes a scalar
    ``(1,)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        shape = tuple(t.shape) or (1,)
        return _dtype_name(t), str(shape), words.numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(leaf))
    return str(a.dtype), str(a.shape), a.tobytes()


def leaf_digests(tree: Any) -> Tuple[List[str], List[bytes]]:
    """Per-leaf fingerprints in tree order: blake2b over the leaf's path
    (``jax.tree_util.keystr``'s string), dtype name, shape and raw bytes,
    so a reshape or a re-keyed tree never aliases a value change."""
    paths: List[str] = []
    digests: List[bytes] = []
    for path, leaf in _tree.flatten_with_paths(tree):
        dtype, shape, raw = _leaf_bytes(leaf)
        key = _tree.keystr(path)
        h = hashlib.blake2b(digest_size=DIGEST_BYTES)
        h.update(key.encode())
        h.update(dtype.encode())
        h.update(shape.encode())
        h.update(raw)
        paths.append(key)
        digests.append(h.digest())
    return paths, digests


def fold_digests(digests: Sequence[bytes], lo: int = 0,
                 hi: Optional[int] = None) -> bytes:
    """Fold a contiguous run of per-leaf digests into one 16-byte digest:
    the tree's fingerprint (the full range) and the search's probe (a
    sub-range)."""
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    for d in digests[lo:len(digests) if hi is None else hi]:
        h.update(d)
    return h.digest()


def tree_digest(tree: Any) -> str:
    """Hex of the folded whole-tree fingerprint."""
    return fold_digests(leaf_digests(tree)[1]).hex()


def majority_vote(digests: Sequence[bytes],
                  reference: Optional[bytes] = None,
                  ) -> Tuple[Optional[bytes], Optional[List[int]]]:
    """The outliers among per-rank digests: the strict-majority value is
    the consensus, ranks holding anything else are outliers.
    ``reference`` (a known-good digest) joins as one extra vote, which
    breaks a two-replica tie.  ``(None, None)`` when no strict majority
    exists."""
    counts = collections.Counter(digests)
    if reference is not None:
        counts[reference] += 1
    total = len(digests) + (1 if reference is not None else 0)
    top, c = counts.most_common(1)[0]
    if c * 2 <= total:
        return None, None
    return top, [r for r, d in enumerate(digests) if d != top]


# --------------------------------------------------------------- auditor

@dataclasses.dataclass
class AuditResult:
    """One audit's verdict (the same on every rank: every decision comes
    from allgathered data alone)."""

    ok: bool
    step: Optional[int]
    rank: int
    size: int
    tree_digest: str
    tree_digests_by_rank: Dict[int, str]
    first_divergent_leaf: Optional[str] = None
    first_divergent_index: Optional[int] = None
    leaf_digests_by_rank: Optional[Dict[int, str]] = None
    outlier_ranks: Optional[List[int]] = None
    consensus: Optional[str] = None
    exchanges: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Auditor:
    """Cross-rank parameter-consistency auditor over a host-plane
    communicator (anything with ``rank``, ``size`` and ``allgather`` of a
    CPU int8 tensor: ``hostcomm.HostCommunicator`` or its hierarchical
    form).

    Every rank runs the same protocol: allgather the 16-byte tree fold; if
    all agree, done.  On a mismatch, search the leaf range by halves with
    one 16-byte allgather a round (the prefix before ``lo`` agrees on every
    rank; the first divergence lies in ``[lo, hi)``), then allgather that
    leaf's digests for :func:`majority_vote`.

    On a divergence ``tmpi_numerics_divergence_total`` moves (which marks
    every observing rank ``degraded`` through the watched counters), the
    outlier's health reads ``diverged`` (every rank's when the vote is
    inconclusive), a ``numerics.audit`` journal record is written and a
    flight bundle holds the leaf path, the per-rank digests and the recent
    sentinel history.  A later clean audit clears the state.
    """

    def __init__(self, comm, interval: Optional[int] = None,
                 health=None, registry=None):
        self.comm = comm
        self.interval = interval
        self._health = health
        self._registry = registry
        self.last_result: Optional[AuditResult] = None
        # Registered at zero now: /healthz's watched-counter scan
        # baselines a family at first sight, so a counter born at 1 in the
        # first divergence would never read as movement on the observers.
        self._reg().counter(
            "tmpi_numerics_divergence_total",
            "cross-rank parameter-divergence events the auditor caught")

    def _health_state(self):
        if self._health is not None:
            return self._health
        from . import serve

        return serve.health

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from .metrics import registry

        return registry

    def _exchange(self, digest: bytes) -> List[bytes]:
        """Every rank's 16 bytes, indexed by global rank."""
        arr = torch.frombuffer(bytearray(digest), dtype=torch.int8)
        raw = np.asarray(self.comm.allgather(arr)).tobytes()
        parts = [raw[i * DIGEST_BYTES:(i + 1) * DIGEST_BYTES]
                 for i in range(self.comm.size)]
        # A hierarchical communicator gathers in (group, position) order,
        # global rank order only for contiguous groups: map back through
        # its groups (a flat ring has none).
        groups = getattr(self.comm, "groups", None)
        if groups is not None:
            by_rank: List[bytes] = [b""] * self.comm.size
            for pos, r in enumerate(r for g in groups for r in g):
                by_rank[r] = parts[pos]
            parts = by_rank
        return parts

    def maybe_audit(self, params: Any, step: int,
                    reference: Any = None) -> Optional[AuditResult]:
        """The engine's per-step entry point: audits only in ``audit``
        mode, on the ``numerics_audit_interval`` cadence."""
        cfg = numerics_config()
        if cfg["mode"] != "audit":
            return None
        interval = self.interval if self.interval else cfg["audit_interval"]
        if interval <= 0 or int(step) % interval != 0:
            return None
        return self.audit(params, step=step, reference=reference)

    def audit(self, params: Any, step: Optional[int] = None,
              reference: Any = None) -> AuditResult:
        """Run one audit now.  ``reference``: a known-good params tree (or
        a ``(paths, digests)`` pair) that joins the outlier vote as one
        extra voter."""
        from . import tracer

        with tracer.span("numerics.audit", step=step, rank=self.comm.rank):
            return self._audit(params, step, reference)

    def _audit(self, params: Any, step: Optional[int],
               reference: Any) -> AuditResult:
        reg = self._reg()
        health = self._health_state()
        paths, digests = leaf_digests(params)
        reg.counter(
            "tmpi_numerics_audit_total",
            "cross-rank parameter-consistency audits run").inc()
        tree = fold_digests(digests)
        got = self._exchange(tree)
        exchanges = 1
        tree_by_rank = {r: d.hex() for r, d in enumerate(got)}
        if all(d == got[0] for d in got):
            recovered = (self.last_result is not None
                         and not self.last_result.ok)
            result = AuditResult(
                ok=True, step=step, rank=self.comm.rank,
                size=self.comm.size, tree_digest=tree.hex(),
                tree_digests_by_rank=tree_by_rank, exchanges=exchanges)
            self.last_result = result
            _set_last_audit(result.to_dict())
            if recovered:
                from . import journal as _journal

                _journal.emit("numerics.audit", rank=self.comm.rank,
                              ok=True, recovered=True, step=step)
            reg.gauge(
                "tmpi_numerics_diverged",
                "1 while the last cross-rank audit found divergence").set(0.0)
            health.clear_diverged()
            return result

        lo, hi = 0, len(digests)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            seg = self._exchange(fold_digests(digests, lo, mid))
            exchanges += 1
            if all(d == seg[0] for d in seg):
                lo = mid
            else:
                hi = mid
        leaf_got = self._exchange(digests[lo])
        exchanges += 1

        ref_digest = None
        if reference is not None:
            if (isinstance(reference, tuple) and len(reference) == 2
                    and isinstance(reference[1], (list, tuple))):
                ref_digest = reference[1][lo]
            else:
                ref_digest = leaf_digests(reference)[1][lo]
        consensus, outliers = majority_vote(leaf_got, ref_digest)

        result = AuditResult(
            ok=False, step=step, rank=self.comm.rank, size=self.comm.size,
            tree_digest=tree.hex(), tree_digests_by_rank=tree_by_rank,
            first_divergent_leaf=paths[lo], first_divergent_index=lo,
            leaf_digests_by_rank={r: d.hex()
                                  for r, d in enumerate(leaf_got)},
            outlier_ranks=outliers,
            consensus=consensus.hex() if consensus else None,
            exchanges=exchanges)
        self.last_result = result
        _set_last_audit(result.to_dict())

        reg.counter(
            "tmpi_numerics_divergence_total",
            "cross-rank parameter-divergence events the auditor caught",
        ).inc()
        reg.gauge(
            "tmpi_numerics_diverged",
            "1 while the last cross-rank audit found divergence").set(1.0)
        # The outlier reads diverged; an inconclusive vote trips every
        # rank (fail safe, never silent).
        if outliers is None or self.comm.rank in outliers:
            health.set_diverged(leaf=paths[lo], step=step,
                                outlier_ranks=outliers)
        from . import journal as _journal

        _journal.emit("numerics.audit", rank=self.comm.rank, ok=False,
                      step=step, first_divergent_leaf=paths[lo],
                      outlier_ranks=outliers,
                      tree_digests_by_rank=tree_by_rank)
        from . import flight

        flight.on_failure(
            "numerics_divergence", step=step, rank=self.comm.rank,
            first_divergent_leaf=paths[lo],
            leaf_digests_by_rank=result.leaf_digests_by_rank,
            tree_digests_by_rank=tree_by_rank,
            outlier_ranks=outliers,
            sentinel_history=history(16))
        return result


# ------------------------------------------------ compute-efficiency feed

#: bf16 dense peak FLOP/s by card name (NVIDIA's data sheet, without
#: sparsity).  Only the H100 SXM part (named "H100 80GB HBM3") is known.
_PEAK_BF16 = {"h100 80gb hbm3": 989.4e12, "h100 sxm": 989.4e12}

_default_peak: Optional[Tuple[Optional[float]]] = None


def device_peak_flops(device=None) -> Optional[float]:
    """bf16 dense peak FLOP/s of ``device`` (default: the current card);
    None on the CPU or on a card not in the table: an MFU against an
    unknown peak is noise.  The default's answer is cached (it cannot
    change within a process)."""
    global _default_peak
    if device is None:
        if _default_peak is not None:
            return _default_peak[0]
        peak = (device_peak_flops(torch.device("cuda"))
                if torch.cuda.is_available() else None)
        _default_peak = (peak,)
        return peak
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    return next((v for k, v in _PEAK_BF16.items() if k in name), None)


def probe_step_flops(fn, args: Tuple[Any, ...]) -> Tuple[Optional[float],
                                                           Any]:
    """The FLOPs of one step, counted while the step runs: ``fn(*args)``
    under a ``FlopCounterMode``.  Returns ``(flops, fn's result)``,
    the flops None when nothing was counted.  The step runs once, for
    real (a step that updates its parameters in place must not run twice),
    and slower than alone: keep it out of timings."""
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    f = float(counter.get_total_flops())
    return (f if f > 0 else None), out


def publish_flops(step_flops: float, step_s: float, registry=None) -> None:
    """Publish ``tmpi_step_flops`` and, where the card's peak is known,
    ``tmpi_mfu_estimate``: the step's FLOP/s over the bf16 peak of the one
    card this rank drives."""
    if registry is None:
        from .metrics import registry as registry_
        registry = registry_
    registry.gauge(
        "tmpi_step_flops",
        "analytical FLOPs of one compiled engine step (XLA cost model)",
    ).set(float(step_flops))
    peak = device_peak_flops()
    if not peak:
        return
    achieved = float(step_flops) / max(float(step_s), 1e-12)
    registry.gauge(
        "tmpi_mfu_estimate",
        "model FLOPs utilization estimate: achieved FLOP/s per chip over "
        "bf16 peak, from tmpi_step_flops and the live step time",
    ).set(achieved / peak)
