"""Leader election and control-plane HA: make rank 0 evictable.

The port of ``torchmpi_tpu/runtime/election.py``, over the port's resize
machine (``runtime/resize.py``).  The leader is a role, not a rank:

* **successor rule**: the leader is the lowest live rank of the committed
  membership (:func:`successor`); after any commit the membership
  renumbers by position, so every member derives "rank 0" locally.
* **epoch-fenced claim**: a prospective leader must :func:`claim_epoch`
  the epoch it will lead into; the claim is a compare-and-swap against the
  highest epoch ever claimed or committed, so exactly one claim per target
  epoch wins and the loser raises :class:`ElectionFenced` (a
  ``TransportFailure``: recoverable).
* **failure detection**: :class:`HealthzDetector` probes each member's
  live ``/healthz`` (``obs/serve.py``); any HTTP answer, even 503, is
  alive, a refused or timed-out connection is dead.  It exports the
  ``tmpi_leader_missing`` gauge the ``leader_missing`` alert rule
  (``obs/alerts.py``) watches.
* **planned handoff**: :meth:`ElectionCoordinator.handoff` drains the
  leader's request queue into a proposal (``replay``, re-queued by the
  successor only at COMMIT) that evicts the leader itself.
* **unplanned failover**: :meth:`ElectionCoordinator.failover` re-forms
  the survivors at ``epoch + 1`` without the dead: the successor claims
  the epoch, every survivor wires a new control ring and allgathers its
  pre-election epoch (an in-flight resize window resolved to one verdict
  on every survivor), and the controller's ``world_hook`` re-forms the
  card's world locally (no barrier on the dead).

Every transition journals ``election.*`` events (detect, claim, elected,
resolve, resume) and exports ``tmpi_leader_rank`` /
``tmpi_election_total``; ``POST /resize`` on a non-leader answers a typed
307 from :func:`leader_info`.  ``obs/rca.py``'s ``leader_failover`` chain
names the story from the journals alone.
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch

from .failure import TransportFailure
from .resize import (
    COMMITTED,
    Membership,
    ResizeController,
    ResizeRejected,
    _drain_requests,
    _journal,
    _registry,
)

__all__ = [
    "ElectionCoordinator",
    "ElectionFenced",
    "HealthzDetector",
    "claim_epoch",
    "leader_info",
    "note_epoch",
    "publish_leader",
    "register_control_endpoint",
    "reset",
    "successor",
]


class ElectionFenced(TransportFailure):
    """A leadership claim lost the epoch fence (another partition
    claimed or committed the epoch first) or the election found the
    survivors split.  Classified recoverable: the fenced partition must
    restart through the elastic layer, never act as a second leader."""


# -------------------------------------------------------- module state
#
# One election scope per process: the fence floor (highest epoch ever
# claimed or committed), the term counter (bumped per leadership
# transition), the published leader view (obs/serve.py's POST /resize
# reads it to answer the typed 307), and the ring-endpoint -> control-
# endpoint map (ring endpoints are the stable identity across commit
# renumbering; HTTP ports are what a redirected client can actually
# reach).

_lock = threading.Lock()
_fence_epoch = -1
_term = 0
_leader: Dict[str, Any] = {
    "rank": 0, "is_self": True, "endpoint": None, "term": 0, "epoch": 0,
}
_control_endpoints: Dict[Tuple[str, int], Tuple[str, int]] = {}


def reset() -> None:
    """Forget fence/term/leader state (test hook, like
    ``resize._clear_requests``)."""
    global _fence_epoch, _term, _leader
    with _lock:
        _fence_epoch = -1
        _term = 0
        _leader = {"rank": 0, "is_self": True, "endpoint": None,
                   "term": 0, "epoch": 0}
        _control_endpoints.clear()


def successor(membership: Membership,
              dead: Iterable[int]) -> Tuple[int, Tuple[str, int]]:
    """The deterministic successor rule: the lowest LIVE rank in the
    committed membership.  Returns ``(old_rank, ring_endpoint)``; every
    member derives the same answer from the same committed endpoint
    list — no extra consensus round."""
    gone = {int(r) for r in dead}
    live = [r for r in range(membership.size) if r not in gone]
    if not live:
        raise ElectionFenced("no live rank left to lead")
    r = min(live)
    return r, membership.endpoints[r]


def claim_epoch(target_epoch: int, *, term: int, leader: int) -> None:
    """The epoch-fenced leadership claim: a compare-and-swap against
    the highest epoch ever claimed or committed.  Exactly one claim per
    target epoch wins; a partition whose view is stale (its target is
    at or below the fence floor) raises :class:`ElectionFenced` — two
    partitions can never both act as leader.  The winning claim is
    journaled; so is the fenced loss."""
    global _fence_epoch
    target_epoch = int(target_epoch)
    with _lock:
        if target_epoch <= _fence_epoch:
            fenced_at = _fence_epoch
            ok = False
        else:
            _fence_epoch = target_epoch
            fenced_at = None
            ok = True
    if not ok:
        _journal("election.fenced", target_epoch=target_epoch,
                 fence_epoch=fenced_at, term=term, leader=leader)
        raise ElectionFenced(
            f"leadership claim for epoch {target_epoch} lost the fence "
            f"(epoch {fenced_at} already claimed or committed) — this "
            "partition must not act as leader")
    _journal("election.claim", target_epoch=target_epoch, term=term,
             leader=leader)


def note_epoch(epoch: int) -> None:
    """Record a COMMITTED epoch on the fence floor (resize._commit
    calls this): a later claim must beat every epoch the job ever
    reached, not only the claimed ones."""
    global _fence_epoch
    with _lock:
        _fence_epoch = max(_fence_epoch, int(epoch))


def bump_term() -> int:
    global _term
    with _lock:
        _term += 1
        return _term


def current_term() -> int:
    with _lock:
        return _term


def register_control_endpoint(ring_ep: Tuple[str, int],
                              http_ep: Tuple[str, int]) -> None:
    """Map a member's RING endpoint (its stable identity across commit
    renumbering) to its live obs HTTP endpoint — what a 307-redirected
    ``POST /resize`` client can actually reach."""
    with _lock:
        _control_endpoints[(str(ring_ep[0]), int(ring_ep[1]))] = (
            str(http_ep[0]), int(http_ep[1]))


def control_endpoint(ring_ep: Tuple[str, int],
                     ) -> Optional[Tuple[str, int]]:
    with _lock:
        return _control_endpoints.get((str(ring_ep[0]), int(ring_ep[1])))


def publish_leader(rank: int, *, is_self: bool,
                   endpoint: Optional[Tuple[str, int]] = None,
                   term: Optional[int] = None,
                   epoch: int = 0, registry=None) -> None:
    """Publish this process's view of the current leader (the view
    ``POST /resize`` answers redirects from) and export the
    ``tmpi_leader_rank`` gauge."""
    global _leader
    with _lock:
        _leader = {
            "rank": int(rank), "is_self": bool(is_self),
            "endpoint": (tuple(endpoint) if endpoint else None),
            "term": int(_term if term is None else term),
            "epoch": int(epoch),
        }
    (registry or _registry()).gauge(
        "tmpi_leader_rank",
        "rank of the current control-plane leader (lowest live rank of "
        "the committed membership)").set(float(rank))


def leader_info() -> Dict[str, Any]:
    """This process's current leader view: ``rank``, ``is_self``,
    ``endpoint`` (the leader's obs HTTP endpoint, when known), ``term``
    and ``epoch``.  The default — no election plane wired — reads
    ``is_self=True``: a job that never elects keeps the old local-queue
    behavior on ``POST /resize``."""
    with _lock:
        return dict(_leader)


def on_commit(membership: Membership, proposal: Mapping[str, Any],
              new_rank: int, registry=None) -> None:
    """Resize-commit hook (called by ``resize._commit`` on every
    member, survivors and departing alike): advance the fence floor and
    re-derive leadership for the new membership — the successor rule
    says the lowest live rank leads, which after renumbering IS rank 0.
    A handoff commit additionally transfers the role: the new leader
    re-queues the proposal's ``replay`` requests (they rode the
    proposal broadcast — applied only now, under the fence) and the
    transition is journaled/counted."""
    note_epoch(membership.epoch)
    handoff = bool(proposal.get("handoff"))
    term = bump_term() if handoff else current_term()
    if handoff and new_rank == 0:
        from . import resize as resize_mod

        replay = list(proposal.get("replay") or [])
        resize_mod._requeue_requests(replay)
        _journal("election.elected", epoch=membership.epoch, term=term,
                 leader=0, rank=new_rank, planned=True,
                 replayed=len(replay))
        (registry or _registry()).counter(
            "tmpi_election_total",
            "leadership transitions (planned handoffs + unplanned "
            "failovers)").inc(labels={"kind": "handoff"})
    publish_leader(
        0, is_self=(new_rank == 0), term=term, epoch=membership.epoch,
        endpoint=control_endpoint(membership.endpoints[0])
        if membership.size else None,
        registry=registry)


# --------------------------------------------------- failure detection

class HealthzDetector:
    """Failure detection over the live-health surface the stack already
    serves (obs/serve.py ``/healthz``).  ``endpoints`` maps each
    member's RING endpoint to its obs HTTP endpoint — ring endpoints
    are the identity that survives commit renumbering.  A probe that
    gets ANY HTTP answer (a 503 stalled/diverged verdict included) is
    ALIVE: liveness, not health, decides elections — a stalled leader
    is the health poller's/watchdog's business, a DEAD one is ours."""

    def __init__(self, endpoints: Mapping[Tuple[str, int],
                                          Tuple[str, int]],
                 timeout_s: float = 0.75, registry=None):
        self.endpoints = {(str(k[0]), int(k[1])): (str(v[0]), int(v[1]))
                          for k, v in dict(endpoints).items()}
        self.timeout_s = float(timeout_s)
        self._registry = registry
        for ring_ep, http_ep in self.endpoints.items():
            register_control_endpoint(ring_ep, http_ep)

    def alive(self, ring_ep: Tuple[str, int]) -> Optional[bool]:
        """True/False liveness for one member; None when the detector
        has no endpoint for it (no verdict — an unprobeable member is
        config, not evidence)."""
        ep = self.endpoints.get((str(ring_ep[0]), int(ring_ep[1])))
        if ep is None:
            return None
        try:
            with urllib.request.urlopen(
                    f"http://{ep[0]}:{ep[1]}/healthz",
                    timeout=self.timeout_s) as r:
                r.read()
            return True
        except urllib.error.HTTPError:
            return True    # it ANSWERED: stalled/diverged is still alive
        except Exception:  # noqa: BLE001 — refused/timeout/reset = dead
            return False

    def dead_ranks(self, membership: Membership) -> set:
        """The membership ranks whose endpoints are provably dead."""
        return {r for r, ep in enumerate(membership.endpoints)
                if self.alive(ep) is False}

    def probe_leader(self, membership: Membership,
                     leader_rank: int) -> bool:
        """One leader-liveness probe, exported as the
        ``tmpi_leader_missing`` gauge the default-pack
        ``leader_missing`` alert rule watches (1.0 = the current leader
        stopped answering; reset to 0 by the next successful probe or
        the next election)."""
        ok = self.alive(membership.endpoints[leader_rank]) is not False
        (self._registry or _registry()).gauge(
            "tmpi_leader_missing",
            "1 when the control-plane leader stopped answering its "
            "/healthz probe (leader_missing alert feed)").set(
            0.0 if ok else 1.0)
        return ok


# ------------------------------------------------------- the coordinator

class ElectionCoordinator:
    """One rank's election half, wrapping its :class:`ResizeController`.

    ``detector`` supplies liveness verdicts (a :class:`HealthzDetector`
    over the job's obs endpoints, or any object with the same
    ``dead_ranks``/``probe_leader`` shape).  ``failover`` is collective
    over the survivors — every survivor must call it (concurrently)
    with the same dead set, exactly like a resize boundary; the engine
    hook (:meth:`on_boundary_fault`) and the drill workers do so from
    the transport-fault path every survivor takes when the leader's
    ring drops."""

    def __init__(self, controller: ResizeController, detector=None,
                 registry=None):
        self.ctl = controller
        self.detector = detector
        self._registry = registry
        self.last_pause_s = 0.0

    @property
    def leader_rank(self) -> int:
        return self.ctl.leader_rank

    # ------------------------------------------------------- planned

    def handoff(self, reason: str = "planned") -> str:
        """The planned path: a healthy leader drains its inbox into the
        proposal (``replay`` — applied by the successor only at COMMIT,
        under the fence) and evicts ITSELF through the ordinary resize
        protocol.  Returns the proposal id; the commit renumbers the
        survivors, rank 0 of the new membership inherits all three
        leader roles, and this rank's ``step_boundary`` returns
        DEPARTED."""
        ctl = self.ctl
        if not ctl.is_leader:
            raise ResizeRejected(
                f"rank {ctl.rank} is not the leader — only the leader "
                "hands leadership off")
        replay = _drain_requests()
        _journal("election.handoff", rank=ctl.rank,
                 epoch=ctl.membership.epoch, planned=True,
                 reason=str(reason), replayed=len(replay))
        return ctl.propose(evict=[ctl.rank], handoff=True, replay=replay)

    # ----------------------------------------------------- unplanned

    def failover(self, dead: Iterable[int]) -> str:
        """The unplanned path: re-form the surviving membership at
        ``epoch + 1`` without the dead rank(s).  The successor (lowest
        live rank) claims the target epoch first — :func:`claim_epoch`
        fences a concurrent partition — then every survivor wires the
        new ring over the surviving endpoint list and allgathers its
        pre-election epoch: the executable form of "an in-flight resize
        window resolved to exactly one verdict on every survivor".
        Returns :data:`resize.COMMITTED`."""
        t0 = time.monotonic()
        ctl = self.ctl
        m = ctl.membership
        dead = {int(r) for r in dead}
        if ctl.leader_rank not in dead:
            raise ResizeRejected(
                f"failover requires a dead leader (leader rank "
                f"{ctl.leader_rank} is not in dead={sorted(dead)})")
        if ctl.rank in dead:
            raise ElectionFenced(
                f"rank {ctl.rank} is in the dead set — a dead rank "
                "cannot run the election")
        succ_rank, succ_ep = successor(m, dead)
        aborted = getattr(ctl, "last_aborted", None)
        _journal("election.detect", epoch=m.epoch, rank=ctl.rank,
                 leader=ctl.leader_rank, dead=sorted(dead),
                 successor=succ_rank)
        target = m.epoch + 1
        term = bump_term()
        if ctl.rank == succ_rank:
            # Only the prospective leader claims; followers follow the
            # ring wire structurally.  A fenced claim aborts the whole
            # election on this partition (recoverable).
            claim_epoch(target, term=term, leader=succ_rank)
        live = [r for r in range(m.size) if r not in dead]
        new_m = Membership(target, [m.endpoints[r] for r in live])
        try:
            ctl.comm.close()
        except Exception:  # noqa: BLE001 — the ring is already dead
            pass
        new_rank = new_m.rank_of(ctl.endpoint)
        if new_rank < 0:
            raise ElectionFenced(
                f"endpoint {ctl.endpoint} absent from the surviving "
                "membership")
        comm = ctl.ring_factory(new_rank, new_m.endpoints)
        # Resume handshake on the NEW ring: every survivor reports the
        # epoch it left behind.  The resize machine's confirm barrier
        # guarantees these agree (commit xor abort, never a fork) —
        # this allgather makes the invariant executable.
        seen = comm.allgather(torch.tensor([m.epoch], dtype=torch.int64))
        epochs = {int(v) for v in seen.reshape(-1).tolist()}
        if len(epochs) != 1:
            try:
                comm.close()
            finally:
                pass
            raise ElectionFenced(
                f"survivors disagree on the pre-election epoch "
                f"({sorted(epochs)}) — the epoch machine split")
        ctl.comm = comm
        ctl.membership = new_m
        ctl.rank = new_rank
        ctl.leader_rank = 0
        ctl._boundary_calls = 0
        ctl.fenced = False
        ctl.last_aborted = None
        note_epoch(target)
        try:
            from ..collectives import autotune

            autotune.rekey(process_count=new_m.size)
        except Exception:  # noqa: BLE001 — tuning must not fail an election
            pass
        # The card's world follows, torn down locally: the dead leader
        # can meet no barrier.
        ctl._reform_world(new_m, new_rank, peers_lost=True)
        reg = self._registry or ctl._registry
        publish_leader(0, is_self=(new_rank == 0), term=term,
                       epoch=target,
                       endpoint=control_endpoint(new_m.endpoints[0]),
                       registry=reg)
        (reg or _registry()).counter(
            "tmpi_election_total",
            "leadership transitions (planned handoffs + unplanned "
            "failovers)").inc(labels={"kind": "failover"})
        (reg or _registry()).gauge(
            "tmpi_leader_missing",
            "1 when the control-plane leader stopped answering its "
            "/healthz probe (leader_missing alert feed)").set(0.0)
        _journal("election.elected", epoch=target, term=term, leader=0,
                 rank=new_rank, planned=False, dead=sorted(dead),
                 size=new_m.size)
        if new_rank == 0:
            if aborted and aborted.get("target_epoch") is not None:
                verdict = ("committed"
                           if m.epoch >= int(aborted["target_epoch"])
                           else "aborted")
                _journal("election.resolve", id=aborted.get("id"),
                         verdict=verdict, epoch=m.epoch,
                         target_epoch=aborted.get("target_epoch"))
            _journal("election.resume", epoch=target, term=term,
                     leader=0, size=new_m.size)
        self.last_pause_s = time.monotonic() - t0
        return COMMITTED

    # ---------------------------------------------------- engine hook

    def on_boundary_fault(self, exc: Optional[BaseException] = None,
                          ) -> str:
        """The engine/worker step-boundary hook: a transport fault with
        a provably dead LEADER runs the failover and returns
        :data:`resize.COMMITTED` (membership advanced — the engine ends
        ``train()`` for a rebuild exactly as for a resize commit).  Any
        other fault re-raises for the elastic layer: a dead follower is
        the restart path's business, not an election."""
        if self.detector is None:
            if exc is not None:
                raise exc
            raise ElectionFenced("no failure detector wired")
        m = self.ctl.membership
        dead = self.detector.dead_ranks(m)
        if self.ctl.leader_rank not in dead:
            if exc is not None:
                raise exc
            raise ElectionFenced(
                "transport fault without a dead leader — not an "
                f"election (dead={sorted(dead)})")
        return self.failover(dead)
