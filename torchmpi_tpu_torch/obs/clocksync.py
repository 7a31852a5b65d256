"""Cross-rank clock alignment over the hostcomm plane.

The port's copy of ``torchmpi_tpu/obs/clocksync.py``; the exchange runs
over the port's ``collectives/hostcomm.HostCommunicator`` (one-element
int64 CPU tensors in place of JAX's numpy arrays).  Every rank of a
one-process-per-card job stamps its spans and native
trace events against its own ``CLOCK_MONOTONIC`` — an arbitrary per-host
epoch, so N ranks' traces land on N unrelated timelines and a merged
view is meaningless.  This module estimates each rank's offset against a
common reference (rank 0) with the classic ping-pong midpoint estimator
(Cristian '89; the Dapper/NTP discipline): for each peer, K rounds of

    t0 = ref clock     -> token travels ref -> peer ->
    t1 = peer clock    -> token travels peer -> ref ->
    t2 = ref clock

yield per-round samples ``offset = t1 - (t0 + t2) / 2`` with error
bounded by half the round-trip; the **minimum-RTT round wins** (queueing
and scheduler noise only ever inflate RTT, so the fastest round is the
most symmetric one).  The result is a :class:`ClockMap`: per-rank
``(offset_ns, uncertainty_ns)``, broadcast so every rank holds the same
map.

``apply`` pushes a rank's offset into the span tracer and the loaded
native trace rings (``tmpi_{hc,ps}_set_clock_offset``), so subsequent
stamps are pre-aligned at the source; alternatively, leave stamps raw
and let ``obs/export.merge_ranks`` shift each rank's dump by the offset
recorded in its obsdump bundle — both roads lead to one timeline.

The exchange is a *collective*: every rank of the communicator must call
:func:`align` concurrently (it rides ``sendreceive``, which is routed
through the ring and needs all ranks).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["ClockMap", "align", "apply", "clear", "last_calibration",
           "sample_peers"]


class ClockMap:
    """Per-rank clock calibration against the reference rank's timeline.

    ``offset_ns[r]`` is rank r's clock minus the reference clock: rank
    r's local stamp ``t`` maps to the common timeline as ``t -
    offset_ns[r]``.  ``uncertainty_ns[r]`` bounds the estimation error
    (half the winning round's RTT — the midpoint estimator's worst case
    under arbitrary path asymmetry).  JSON-shaped on purpose: obsdump
    bundles embed ``to_dict()`` verbatim.
    """

    def __init__(self, offset_ns: List[int], uncertainty_ns: List[int],
                 reference_rank: int = 0, rounds: int = 0):
        self.offset_ns = [int(o) for o in offset_ns]
        self.uncertainty_ns = [int(u) for u in uncertainty_ns]
        self.reference_rank = int(reference_rank)
        self.rounds = int(rounds)

    @property
    def size(self) -> int:
        return len(self.offset_ns)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "reference_rank": self.reference_rank,
            "rounds": self.rounds,
            "offset_ns": list(self.offset_ns),
            "uncertainty_ns": list(self.uncertainty_ns),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClockMap":
        return cls(d["offset_ns"], d["uncertainty_ns"],
                   d.get("reference_rank", 0), d.get("rounds", 0))

    def __repr__(self) -> str:
        pairs = ", ".join(
            f"r{r}:{o / 1e6:+.3f}ms±{u / 1e6:.3f}"
            for r, (o, u) in enumerate(zip(self.offset_ns,
                                           self.uncertainty_ns)))
        return f"ClockMap({pairs})"


def _rounds_default() -> int:
    from . import native as obs_native

    return max(1, obs_native.cluster_config()["clocksync_rounds"])


def _sample_peers_default() -> int:
    from . import native as obs_native

    return int(obs_native.cluster_config()["clocksync_sample_peers"])


def sample_peers(size: int, k: int) -> List[int]:
    """The bounded-sample peer set: ``k`` peers spread evenly across the
    rank space (all peers when ``k`` is 0 or covers them).  A pure
    function of ``(size, k)`` — every rank derives the identical list,
    which is what keeps the sampled exchange a collective."""
    peers = list(range(1, size))
    if k <= 0 or k >= len(peers):
        return peers
    step = len(peers) / k
    return sorted({peers[int(i * step)] for i in range(k)})


def align(comm, rounds: Optional[int] = None,
          clock: Callable[[], int] = time.monotonic_ns,
          peers: Optional[int] = None) -> ClockMap:
    """Collective clock-alignment exchange over ``comm`` (a
    ``collectives/hostcomm.HostCommunicator``-shaped object: ``rank``,
    ``size``, and ``sendreceive``/``broadcast`` in place on CPU
    tensors).  Returns the same :class:`ClockMap`
    on every rank.

    ``clock`` is each rank's local nanosecond clock — the default is the
    clock every span and native event is stamped with; tests inject
    skewed callables here so the recovered offsets can be
    checked against a known truth.

    The midpoint estimate's error is bounded by half the winning RTT
    *including* any ring-routing asymmetry (``sendreceive`` relays
    through intermediate ranks, and the forward and return paths may
    have different hop counts) — the published ``uncertainty_ns`` is
    exactly that bound, not a gaussian guess.

    ``peers`` (default ``obs_clocksync_sample_peers``; 0 = all) is the
    bounded-sample mode for wide jobs: only ``peers`` deterministically-
    chosen ranks (:func:`sample_peers` — identical on every rank, so the
    exchange stays a collective) are measured, and the rest inherit the
    MEDIAN sampled offset with an uncertainty widened by the sampled
    spread — an honest estimate for fleets whose hosts share a clock
    discipline, honestly wide when they don't.  Alignment cost stops
    growing with N: O(peers * rounds) sendreceives instead of
    O(N * rounds).
    """
    rounds = int(rounds) if rounds else _rounds_default()
    k = int(peers) if peers is not None else _sample_peers_default()
    p, r = comm.size, comm.rank
    measured = sample_peers(p, k)
    offsets = [0] * p
    uncerts = [0] * p
    token = torch.zeros((1,), dtype=torch.int64)
    for peer in measured:
        best_rtt = None
        for _ in range(rounds):
            t0 = clock() if r == 0 else 0
            comm.sendreceive(token, src=0, dst=peer)
            if r == peer:
                token[0] = clock()          # t1, the peer's stamp
            comm.sendreceive(token, src=peer, dst=0)
            if r == 0:
                t2 = clock()
                t1 = int(token[0])
                rtt = t2 - t0
                if best_rtt is None or rtt < best_rtt:
                    best_rtt = rtt
                    # Classic midpoint: assume t1 was taken half-way
                    # through the round trip; off by at most rtt/2.
                    offsets[peer] = t1 - (t0 + t2) // 2
                    uncerts[peer] = max(rtt // 2, 1)
    if r == 0 and len(measured) < p - 1:
        # Unmeasured peers: the sampled median, bounded by the worst
        # sampled uncertainty plus the sampled spread (how wrong the
        # median can be about a peer that behaves like the sample).
        offs = sorted(offsets[q] for q in measured)
        med = offs[len(offs) // 2] if offs else 0
        spread = max((abs(offsets[q] - med) for q in measured), default=0)
        base = max((uncerts[q] for q in measured), default=1)
        sampled = set(measured)
        for q in range(1, p):
            if q not in sampled:
                offsets[q] = med
                uncerts[q] = max(base + spread, 1)
    # Publish rank 0's verdicts so every rank holds the identical map.
    out = torch.zeros((2 * p,), dtype=torch.int64)
    if r == 0:
        out[:p] = torch.tensor(offsets, dtype=torch.int64)
        out[p:] = torch.tensor(uncerts, dtype=torch.int64)
    comm.broadcast(out, root=0)
    vals = out.tolist()
    cm = ClockMap(vals[:p], vals[p:], reference_rank=0, rounds=rounds)
    # Remember this process's calibration so the default export road —
    # "record the map in the obsdump, shift at merge time" — works
    # without the caller threading the map through: write_obsdump's
    # default clock is last_calibration().  Latest align wins.
    global _last_map, _last_rank
    _last_map, _last_rank = cm, r
    return cm


_last_map: Optional[ClockMap] = None
_last_rank = 0


def last_calibration() -> Dict[str, Any]:
    """This process's clock entry for an obsdump bundle: the latest
    :func:`align` verdict for our rank (``applied`` reflects whether
    :func:`apply` pushed that offset into the stamps), or the raw-clock
    entry (offset 0, unknown uncertainty) when no alignment ran."""
    from . import tracer

    if _last_map is None or _last_rank >= _last_map.size:
        return {"offset_ns": 0, "uncertainty_ns": 0, "applied": False}
    off = int(_last_map.offset_ns[_last_rank])
    return {
        "offset_ns": off,
        "uncertainty_ns": int(_last_map.uncertainty_ns[_last_rank]),
        "applied": tracer.clock_offset() == off and off != 0,
    }


def apply(clockmap: ClockMap, rank: int) -> int:
    """Stamp-at-source alignment: push ``clockmap.offset_ns[rank]`` into
    this process's span tracer and loaded native trace rings, so every
    subsequent span and ring event lands directly on the reference
    rank's timeline.  Returns the applied offset.  Obsdump bundles
    written after this mark their clock as ``applied`` so the merge path
    does not shift twice."""
    from . import native as obs_native
    from . import tracer

    off = int(clockmap.offset_ns[rank])
    tracer.set_clock_offset(off)
    obs_native.set_clock_offset(off)
    return off


def clear() -> None:
    """Back to raw CLOCK_MONOTONIC stamps (tracer + loaded engines)."""
    from . import native as obs_native
    from . import tracer

    tracer.set_clock_offset(0)
    obs_native.set_clock_offset(0)
