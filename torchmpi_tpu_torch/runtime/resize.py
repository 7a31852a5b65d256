"""Elastic resize: grow and shrink a live job without losing a step.

The port of ``torchmpi_tpu/runtime/resize.py``.  A membership-epoch state
machine over the host control ring (``collectives/hostcomm.
HostCommunicator``, wire-compatible with the JAX package's, so JAX and
port controllers can share one ring):

* **propose**: the leader (rank 0 of the committed membership; see
  ``runtime/election.py`` for how the role moves) holds a queue of resize
  requests (its own :meth:`ResizeController.propose` calls, or ``POST
  /resize`` on the live endpoint via :func:`enqueue_request`).  Each
  accepted proposal targets exactly ``epoch + 1``, so committed epochs are
  strictly monotonic.
* **quiesce**: at a step boundary every member learns the proposal over
  the current control ring (one small header broadcast per poll boundary)
  and fences at a ring barrier: no member is inside a collective when the
  membership changes.
* **state ship**: the leader sends each joiner the live training state
  (host arrays: the card's parameters copied out) over a fresh TCP
  connection, behind the fence: a joiner that never hears COMMIT discards
  it.
* **commit / abort**: the leader broadcasts one verdict over the old ring,
  then a confirm barrier acks that every member heard it.  Commit: every
  member wires a fresh control ring over the new endpoint list (survivors
  keep their ports, ranks renumber by position), the leader drives
  ``parameterserver.rebalance`` over the proposal's ``ps_handoffs``, and
  the ``world_hook`` re-forms the card's world over the new membership
  (:func:`card_world_hook`), so the engine's ring kernels run at the new
  p.  Abort: nothing changed.

Atomicity under chaos: a fault in the ship window aborts cleanly (the old
ring never stopped); a fault on the old ring inside the window raises
:class:`ResizeAborted` (a ``TransportFailure``, so recoverable) on every
survivor with the epoch unchanged.

The frames, headers, JSON proposals and state-ship messages are the JAX
package's byte for byte.  The commit re-keys the autotuner's winner cache
(``collectives/autotune.rekey``), as JAX's does.
"""

from __future__ import annotations

import collections
import json
import socket
import struct
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from . import config
from .failure import TransportFailure

__all__ = [
    "ABORTED",
    "COMMITTED",
    "CONTINUE",
    "DEPARTED",
    "JoinListener",
    "Membership",
    "ResizeAborted",
    "ResizeController",
    "ResizeRejected",
    "StateServer",
    "card_world_hook",
    "enqueue_request",
    "maybe_rejoin",
    "pending_requests",
    "rejoin_sync",
    "resize_config",
]

#: step_boundary outcomes.
CONTINUE = "continue"    # no proposal (or not a poll boundary)
ABORTED = "aborted"      # a proposal ran and aborted; membership unchanged
COMMITTED = "committed"  # membership advanced; controller.comm is the new ring
DEPARTED = "departed"    # this rank drained/was evicted; stop training

_MAGIC = 0x52535A31  # "RSZ1"
_VERDICT_COMMIT = 1
_VERDICT_ABORT = 0


class ResizeRejected(ValueError):
    """A proposal failed validation (stale epoch, unknown rank, draining
    the leader, joining an endpoint already in the membership)."""


class ResizeAborted(TransportFailure):
    """The resize protocol aborted on a transport fault (a member died
    mid-quiesce, the verdict broadcast failed).  The membership epoch is
    UNCHANGED — classified recoverable, so the elastic layer above
    restores and re-forms exactly as for any other transport fault."""


def resize_config() -> Dict[str, Any]:
    """The ``resize_*`` knobs, read once per protocol step (the single
    config touchpoint of this module, like ``failover_config`` for
    ``ps_*``): ``resize_enabled`` arms the request queue / POST route,
    ``resize_io_deadline_ms`` bounds every ship/rejoin socket wait, and
    ``resize_poll_interval_steps`` spaces the per-boundary proposal
    polls."""
    return {
        "enabled": bool(config.get("resize_enabled")),
        "io_deadline_ms": int(config.get("resize_io_deadline_ms")),
        "poll_interval_steps": max(
            1, int(config.get("resize_poll_interval_steps"))),
    }


def _journal(kind: str, **data) -> None:
    from ..obs import journal as _journal_mod

    _journal_mod.emit(kind, **data)


def _summarize_members(items: Sequence[Any], cap: int = 8) -> Any:
    """Membership-list summarization for journal emissions: short lists
    ride verbatim (the shape every RCA rule and existing reader knows),
    long ones collapse to a count + bounded sample — a 256-rank churn
    wave must not journal kilobyte rank rosters on every record.  The
    summary dict stays truthy exactly when the list was non-empty, so
    RCA predicates keyed on ``bool(data["evict"])`` are unaffected."""
    items = list(items)
    if len(items) <= cap:
        return items
    out: Dict[str, Any] = {"n": len(items), "sample": items[:cap]}
    if all(isinstance(i, int) for i in items):
        out["min"], out["max"] = min(items), max(items)
    return out


def _registry():
    from ..obs import metrics

    return metrics.registry


def _count(name: str, help_: str, registry=None) -> None:
    (registry or _registry()).counter(name, help_).inc()


# --------------------------------------------------------------- membership

class Membership:
    """One membership epoch: the ordered endpoint list IS the membership
    (rank r binds ``endpoints[r]``, hostcomm's contract).  Immutable;
    commits replace it wholesale."""

    def __init__(self, epoch: int, endpoints: Sequence[Tuple[str, int]]):
        self.epoch = int(epoch)
        self.endpoints: Tuple[Tuple[str, int], ...] = tuple(
            (str(h), int(p)) for h, p in endpoints)

    @property
    def size(self) -> int:
        return len(self.endpoints)

    def rank_of(self, endpoint: Tuple[str, int]) -> int:
        ep = (str(endpoint[0]), int(endpoint[1]))
        try:
            return self.endpoints.index(ep)
        except ValueError:
            return -1

    def __repr__(self) -> str:
        return f"Membership<epoch={self.epoch}, size={self.size}>"


# ----------------------------------------------------------- state framing
#
# One wire shape for both the join ship and the restart rejoin: an 8-byte
# length-prefixed JSON header followed by the raw buffer bytes in header
# order.  Buffers are C-contiguous numpy arrays keyed by name; dtype and
# shape ride the header so the receiver allocates exactly.

def _send_msg(sock: socket.socket, header: Dict[str, Any],
              buffers: Optional[Dict[str, np.ndarray]] = None) -> None:
    buffers = buffers or {}
    manifest = [{"name": k, "dtype": str(a.dtype), "shape": list(a.shape)}
                for k, a in buffers.items()]
    header = dict(header, manifest=manifest)
    blob = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(struct.pack("!Q", len(blob)) + blob)
    for m in manifest:
        sock.sendall(np.ascontiguousarray(buffers[m["name"]]).tobytes())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(min(1 << 20, n - len(out)))
        if not chunk:
            raise ResizeAborted(
                f"resize state connection closed mid-message "
                f"({len(out)}/{n} bytes)")
        out += chunk
    return bytes(out)


def _recv_msg(sock: socket.socket,
              ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    (n,) = struct.unpack("!Q", _recv_exact(sock, 8))
    if n > (1 << 30):
        raise ResizeAborted(f"resize message header implausibly large ({n})")
    header = json.loads(_recv_exact(sock, n).decode())
    buffers: Dict[str, np.ndarray] = {}
    for m in header.get("manifest", []):
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"])) if m["shape"] else 1
        raw = _recv_exact(sock, count * dt.itemsize)
        buffers[m["name"]] = np.frombuffer(
            raw, dtype=dt).reshape(m["shape"]).copy()
    return header, buffers


# ------------------------------------------------------------ request queue
#
# The leader's inbox.  ``POST /resize`` (obs/serve.py) and in-process
# callers append; the leader's step_boundary pops one request per
# boundary.  Gated by resize_enabled: the live endpoint must not mutate
# membership unless the operator armed it.

_requests: "collections.deque[Dict[str, Any]]" = collections.deque()
_requests_lock = threading.Lock()


def enqueue_request(doc: Dict[str, Any]) -> int:
    """Queue a resize request for the leader (``POST /resize``'s body).
    Accepted shapes: ``{"join": [{"ring": [h,p], "sync": [h,p]}...]}``
    to grow, ``{"drain": [rank...]}`` / ``{"evict": [rank...]}`` to
    shrink, or the autoscaler's abstract ``{"action": "drain"|"evict",
    "rank": r}`` (the leader picks the concrete shape at pop time).
    Raises when ``resize_enabled`` is off or the doc is not a dict."""
    if not resize_config()["enabled"]:
        raise ResizeRejected(
            "resize_enabled is off — arm it before queueing requests")
    if not isinstance(doc, dict):
        raise ResizeRejected(f"resize request must be a JSON object, "
                             f"got {type(doc).__name__}")
    with _requests_lock:
        _requests.append(dict(doc))
        return len(_requests)


def pending_requests() -> int:
    with _requests_lock:
        return len(_requests)


def _pop_request() -> Optional[Dict[str, Any]]:
    with _requests_lock:
        return _requests.popleft() if _requests else None


def _clear_requests() -> None:  # test hook
    with _requests_lock:
        _requests.clear()


def _drain_requests() -> List[Dict[str, Any]]:
    """Drain the whole inbox (leadership handoff: the drained docs ride
    the handoff proposal as ``replay`` and are re-queued by the
    successor at COMMIT — under the fence)."""
    with _requests_lock:
        out = [dict(d) for d in _requests]
        _requests.clear()
    return out


def _requeue_requests(docs: Sequence[Dict[str, Any]]) -> None:
    """Re-queue replayed requests on the new leader (election.on_commit).
    Deliberately bypasses the ``resize_enabled`` gate: these docs were
    each accepted through :func:`enqueue_request` while the gate was
    armed — a handoff must not silently drop them."""
    with _requests_lock:
        _requests.extend(dict(d) for d in docs)


# ------------------------------------------------------------- controller

def _default_ring_factory(rank: int,
                          endpoints: Sequence[Tuple[str, int]],
                          timeout_ms: int = 30000):
    from ..collectives.hostcomm import HostCommunicator

    return HostCommunicator(rank, len(endpoints), list(endpoints),
                            timeout_ms=timeout_ms)


class ResizeController:
    """One rank's half of the membership state machine.

    ``comm`` is the CURRENT hostcomm ring (the controller takes ownership
    of its lifecycle across resizes: a commit closes it and wires the
    next one via ``ring_factory``).  ``state_provider`` returns the
    shippable training state as ``{name: np.ndarray}`` — consulted only
    when this rank ships to a joiner.  Workers call
    :meth:`step_boundary` once per training step, every rank at the same
    step count (the proposal poll is a collective).

    The leader is ``leader_rank`` of the current membership (rank 0
    after every commit — the election layer's successor rule renumbers
    the lowest live rank there); only it accepts proposals
    (:meth:`propose` and the module request queue), and it may drain
    itself only through a ``handoff`` proposal (the election layer's
    planned path — ``runtime/election.py``).  ``fenced`` is True on a
    joiner between state
    receipt and COMMIT — the window in which it must not contribute a
    gradient or PS add (the join path constructs controllers with the
    fence already cleared; the flag is load-bearing on
    :class:`JoinListener`)."""

    def __init__(self, comm, membership: Membership,
                 state_provider: Optional[
                     Callable[[], Dict[str, np.ndarray]]] = None,
                 ring_factory: Callable = _default_ring_factory,
                 registry=None,
                 ps_rebalance: Optional[Callable] = None,
                 world_hook: Optional[Callable] = None):
        self.comm = comm
        self.membership = membership
        self.rank = int(comm.rank)
        self.endpoint = membership.endpoints[self.rank]
        self.state_provider = state_provider
        self.ring_factory = ring_factory
        self.fenced = False
        self.leader_rank = 0
        self.last_aborted: Optional[Dict[str, Any]] = None
        self.last_pause_s = 0.0
        self._registry = registry
        self.ps_rebalance = ps_rebalance
        self.world_hook = world_hook
        self._boundary_calls = 0
        self._pending: "collections.deque[Dict[str, Any]]" = (
            collections.deque())
        self._lock = threading.Lock()

    # ------------------------------------------------------------ leader

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader_rank

    def propose(self, join: Sequence[Dict[str, Any]] = (),
                drain: Sequence[int] = (), evict: Sequence[int] = (),
                ps_handoffs: Sequence[Tuple[int, Tuple[str, int]]] = (),
                target_epoch: Optional[int] = None,
                handoff: bool = False,
                replay: Sequence[Dict[str, Any]] = ()) -> str:
        """Queue a resize proposal on the leader.  ``join``: one
        ``{"ring": (host, port), "sync": (host, port)}`` per new rank
        (``ring`` = its endpoint in the NEW membership, ``sync`` = the
        :class:`JoinListener` it awaits the state ship on).  ``drain`` /
        ``evict``: CURRENT ranks to remove (identical mechanics; evict is
        the autoscaler's involuntary flavour and is journaled as such).
        ``target_epoch`` (optional) must exceed the current epoch — a
        concurrent proposer that lost the race is rejected here instead
        of at the boundary.  ``handoff`` marks a leadership handoff: it
        is the ONLY way the leader itself may appear in ``drain`` /
        ``evict``, and ``replay`` (queued request docs drained by
        ``election.handoff``) rides the proposal broadcast so the
        successor re-queues them at COMMIT — under the fence, never
        before a verdict.  Returns the proposal id."""
        if not self.is_leader:
            raise ResizeRejected(
                f"rank {self.rank} is not the leader (rank "
                f"{self.leader_rank} of the current membership) — route "
                "proposals to the leader")
        if target_epoch is not None and target_epoch <= self.membership.epoch:
            raise ResizeRejected(
                f"target epoch {target_epoch} is not beyond the current "
                f"membership epoch {self.membership.epoch}")
        req = {
            "id": uuid.uuid4().hex[:12],
            "join": [{"ring": tuple(j["ring"]), "sync": tuple(j["sync"])}
                     for j in join],
            "drain": [int(r) for r in drain],
            "evict": [int(r) for r in evict],
            "ps_handoffs": [(int(s), (str(t[0]), int(t[1])))
                            for s, t in ps_handoffs],
            "handoff": bool(handoff),
            "replay": [dict(d) for d in replay],
        }
        # Eager feedback against the CURRENT membership; the boundary
        # revalidates at pop time (membership may have moved since).
        self._validate(req)
        with self._lock:
            self._pending.append(req)
        return req["id"]

    def _next_proposal(self) -> Optional[Dict[str, Any]]:
        """Pop the next valid proposal (leader, at a poll boundary).
        Invalid requests are rejected with a journal record and skipped —
        a stale request must not wedge the queue."""
        while True:
            with self._lock:
                req = self._pending.popleft() if self._pending else None
            if req is None:
                req = _pop_request()
                if req is None:
                    return None
                req = self._shape_abstract(req)
                if req is None:
                    continue
            try:
                return self._validate(req)
            except ResizeRejected as e:
                _journal("resize.reject", id=req.get("id"), reason=str(e))

    def _shape_abstract(self, doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Turn an abstract autoscaler request (``{"action": ...}``) into
        a concrete proposal against the CURRENT membership."""
        action = doc.get("action")
        if action is None:
            return {
                "id": str(doc.get("id") or uuid.uuid4().hex[:12]),
                "join": [{"ring": tuple(j["ring"]), "sync": tuple(j["sync"])}
                         for j in doc.get("join", [])],
                "drain": [int(r) for r in doc.get("drain", [])],
                "evict": [int(r) for r in doc.get("evict", [])],
                "ps_handoffs": [(int(s), (str(t[0]), int(t[1])))
                                for s, t in doc.get("ps_handoffs", [])],
                "handoff": bool(doc.get("handoff")),
                "replay": [dict(d) for d in doc.get("replay", [])],
            }
        if action in ("drain", "evict"):
            rank = doc.get("rank")
            if rank is None:
                rank = self.membership.size - 1
            key = "evict" if action == "evict" else "drain"
            handoff = int(rank) == self.leader_rank
            replay: List[Dict[str, Any]] = []
            if handoff:
                # The autoscaler named the LEADER (this rank): route the
                # request through the planned-handoff path — the rest of
                # the inbox rides the proposal as replay so the
                # successor re-queues it at COMMIT, under the fence.
                replay = _drain_requests()
                _journal("election.handoff", rank=self.rank,
                         epoch=self.membership.epoch, planned=True,
                         reason=f"autoscaler {action}",
                         replayed=len(replay))
            return {"id": uuid.uuid4().hex[:12], "join": [],
                    "drain": [int(rank)] if key == "drain" else [],
                    "evict": [int(rank)] if key == "evict" else [],
                    "ps_handoffs": [], "handoff": handoff,
                    "replay": replay}
        if action == "grow":
            join = doc.get("join") or []
            if not join:
                # Growth needs concrete endpoints from a provisioner; an
                # endpointless grow request is advisory only.
                _journal("resize.reject", reason="grow request carries no "
                         "join endpoints (no provisioner attached)")
                return None
            return {"id": uuid.uuid4().hex[:12],
                    "join": [{"ring": tuple(j["ring"]),
                              "sync": tuple(j["sync"])} for j in join],
                    "drain": [], "evict": [], "ps_handoffs": [],
                    "handoff": False, "replay": []}
        _journal("resize.reject", reason=f"unknown action {action!r}")
        return None

    def _validate(self, req: Dict[str, Any]) -> Dict[str, Any]:
        m = self.membership
        leaving = sorted(set(req["drain"]) | set(req["evict"]))
        for r in leaving:
            if not 0 <= r < m.size:
                raise ResizeRejected(
                    f"rank {r} is not in the current membership "
                    f"(size {m.size})")
            if r == self.leader_rank and not req.get("handoff"):
                raise ResizeRejected(
                    f"cannot drain/evict the leader (rank {r}) in a "
                    "plain proposal — hand leadership off first "
                    "(election.handoff, or a proposal flagged handoff)")
        ring_eps = [tuple(j["ring"]) for j in req["join"]]
        for ep in ring_eps:
            if m.rank_of(ep) >= 0:
                raise ResizeRejected(
                    f"join endpoint {ep} is already a member")
        if len(set(ring_eps)) != len(ring_eps):
            raise ResizeRejected("duplicate join endpoints")
        if m.size - len(leaving) < 1:
            raise ResizeRejected("resize would leave no survivors")
        new_endpoints = ([ep for r, ep in enumerate(m.endpoints)
                          if r not in leaving] + list(ring_eps))
        return dict(req, target_epoch=m.epoch + 1, leaving=leaving,
                    new_endpoints=[list(ep) for ep in new_endpoints])

    # ---------------------------------------------------------- boundary

    def step_boundary(self) -> str:
        """The per-step resize checkpoint — called by EVERY member at the
        same step count.  One tiny header broadcast per poll boundary; a
        pending proposal runs the quiesce → ship → verdict machine and
        returns :data:`COMMITTED`, :data:`ABORTED` or :data:`DEPARTED`
        (:data:`CONTINUE` otherwise)."""
        cfg = resize_config()
        self._boundary_calls += 1
        if self._boundary_calls % cfg["poll_interval_steps"]:
            return CONTINUE
        proposal = self._next_proposal() if self.is_leader else None
        if proposal is not None:
            blob = json.dumps(proposal, separators=(",", ":")).encode()
            hdr = torch.tensor([_MAGIC, 1, proposal["target_epoch"],
                                len(blob)], dtype=torch.int64)
        else:
            hdr = torch.tensor([_MAGIC, 0, 0, 0], dtype=torch.int64)
            blob = b""
        t0 = time.monotonic()
        try:
            self.comm.broadcast(hdr, root=self.leader_rank)
            if int(hdr[0]) != _MAGIC:
                raise ResizeAborted(
                    f"resize header desync (got magic {int(hdr[0]):#x})")
            if int(hdr[1]) == 0:
                return CONTINUE
            payload = (torch.frombuffer(bytearray(blob), dtype=torch.int8)
                       if self.is_leader
                       else torch.zeros(int(hdr[3]), dtype=torch.int8))
            self.comm.broadcast(payload, root=self.leader_rank)
            if not self.is_leader:
                proposal = json.loads(payload.numpy().tobytes().decode())
            outcome = self._run_proposal(proposal, cfg)
        except TransportFailure as e:
            # The OLD ring failed mid-protocol (a member died in the
            # resize window): no verdict was (or can be) delivered, no
            # rank reaches the new epoch — the epoch is unchanged on
            # every survivor and the fault is recoverable above.  The
            # aborted window is remembered so the election layer can
            # journal the single resolved verdict after a failover.
            self.last_aborted = {
                "id": proposal.get("id") if proposal else None,
                "target_epoch": (int(proposal["target_epoch"])
                                 if proposal else None),
            }
            _journal("resize.abort", id=proposal.get("id") if proposal
                     else None, epoch=self.membership.epoch,
                     reason=f"transport: {type(e).__name__}: {e}"[:300],
                     rank=self.rank)
            _count("tmpi_resize_abort_total",
                   "resize proposals that aborted (membership unchanged)",
                   self._registry)
            if isinstance(e, ResizeAborted):
                raise
            raise ResizeAborted(
                f"resize window transport fault: {type(e).__name__}: {e}"
            ) from e
        finally:
            self.last_pause_s = time.monotonic() - t0
        return outcome

    # ------------------------------------------------------- the protocol

    def _run_proposal(self, proposal: Dict[str, Any],
                      cfg: Dict[str, Any]) -> str:
        m = self.membership
        target = int(proposal["target_epoch"])
        if target != m.epoch + 1:
            # A replayed/duplicate proposal must not skip or rewind the
            # epoch; every rank derives the same verdict locally.
            raise ResizeAborted(
                f"proposal targets epoch {target}, current is {m.epoch}")
        if self.rank != self.leader_rank and not proposal.get("id"):
            raise ResizeAborted("malformed proposal (no id)")
        if self.is_leader:
            _journal("resize.propose", id=proposal["id"], epoch=m.epoch,
                     target_epoch=target,
                     join=_summarize_members(
                         [list(j["ring"]) for j in proposal["join"]]),
                     drain=_summarize_members(proposal["drain"]),
                     evict=_summarize_members(proposal["evict"]),
                     size=m.size,
                     new_size=len(proposal["new_endpoints"]))
        # ---- quiesce: every member parks at the step boundary.
        _journal("resize.quiesce", id=proposal["id"], epoch=m.epoch,
                 rank=self.rank, target_epoch=target)
        self._phase("quiesce", proposal)
        self.comm.barrier()
        self._phase("ship", proposal)
        # ---- ship (leader only): state to each joiner, out-of-band.
        ships: List[Tuple[socket.socket, Dict[str, Any]]] = []
        verdict = _VERDICT_COMMIT
        reason = ""
        if self.is_leader and proposal["join"]:
            state = self.state_provider() if self.state_provider else {}
            deadline_s = max(0.2, cfg["io_deadline_ms"] / 1000.0)
            for j in proposal["join"]:
                s = None
                try:
                    s = socket.create_connection(
                        tuple(j["sync"]), timeout=deadline_s)
                    s.settimeout(deadline_s)
                    _send_msg(s, {
                        "phase": "state",
                        "target_epoch": target,
                        "new_endpoints": proposal["new_endpoints"],
                        "ring": list(j["ring"]),
                        "proposal_id": proposal["id"],
                    }, state)
                    if _recv_exact(s, 2) != b"OK":
                        raise OSError("joiner NACKed the state ship")
                    ships.append((s, j))
                except (OSError, ResizeAborted) as e:
                    if s is not None:
                        try:
                            s.close()
                        except OSError:
                            pass
                    verdict = _VERDICT_ABORT
                    reason = (f"state ship to {tuple(j['sync'])} failed: "
                              f"{type(e).__name__}: {e}")[:300]
                    break
        # ---- verdict: ONE collective broadcast over the old ring,
        # then a CONFIRM barrier.  The ring broadcast alone is
        # fire-and-forget (bytes in a kernel buffer count as sent), so
        # without the confirm a fault downstream of the leader could
        # commit upstream ranks while downstream aborts.  The barrier is
        # the ack that every member HEARD the verdict; a member that
        # fails the confirm — even having heard COMMIT — takes the
        # transport-abort path above with the epoch unchanged.  A split
        # now needs the barrier itself to half-complete, and a survivor
        # that commits into that window fails the new-ring wire and
        # surfaces the same recoverable transport fault.
        self._phase("verdict", proposal)
        vbuf = torch.tensor([verdict, target], dtype=torch.int64)
        self.comm.broadcast(vbuf, root=self.leader_rank)
        verdict = int(vbuf[0])
        self._phase("confirm", proposal)
        self.comm.barrier()
        # Tell the joiners (best-effort — a joiner that never hears the
        # verdict times out fenced and discards the state).
        for s, _j in ships:
            try:
                s.sendall(struct.pack("!Q", verdict))
            except OSError:
                pass
            finally:
                try:
                    s.close()
                except OSError:
                    pass
        if verdict != _VERDICT_COMMIT:
            if self.is_leader:
                _journal("resize.abort", id=proposal["id"], epoch=m.epoch,
                         reason=reason or "leader aborted", rank=self.rank)
            _count("tmpi_resize_abort_total",
                   "resize proposals that aborted (membership unchanged)",
                   self._registry)
            return ABORTED
        return self._commit(proposal, target)

    def _phase(self, name: str, proposal: Dict[str, Any]) -> None:
        """Protocol-phase seam, called right before each phase of the
        resize window commits to the wire (``quiesce`` → ``ship`` →
        ``verdict`` → ``confirm``).  A no-op in production; the chaos
        tests and drills override it to kill a member at an exact phase
        boundary (every survivor must land on the same epoch, commit xor
        abort, whichever boundary the leader dies at)."""

    def _election_commit(self, new_m: Membership,
                         proposal: Dict[str, Any], new_rank: int) -> None:
        """Hand the committed membership to the election layer: advance
        the epoch fence floor, re-derive/publish leadership, and — on a
        handoff commit — transfer the role (the successor re-queues the
        proposal's ``replay``).  Must not fail the commit: the ring is
        already rewired."""
        try:
            from . import election

            election.on_commit(new_m, proposal, new_rank,
                               registry=self._registry)
        except Exception as e:  # noqa: BLE001 — the membership commit
            # already happened; leadership bookkeeping must not undo it.
            _journal("election.error", id=proposal.get("id"),
                     error=f"{type(e).__name__}: {e}"[:300])

    def _commit(self, proposal: Dict[str, Any], target: int) -> str:
        new_m = Membership(target, [tuple(ep)
                                    for ep in proposal["new_endpoints"]])
        new_rank = new_m.rank_of(self.endpoint)
        _journal("resize.commit", id=proposal["id"], epoch=target,
                 size=new_m.size, rank=self.rank, new_rank=new_rank,
                 evicted=_summarize_members(proposal["evict"]),
                 drained=_summarize_members(proposal["drain"]))
        _count("tmpi_resize_commit_total",
               "resize proposals committed (membership advanced)",
               self._registry)
        reg = self._registry or _registry()
        reg.gauge("tmpi_resize_epoch",
                  "current membership epoch").set(float(target))
        # The old ring is done either way: survivors re-bind the same
        # ports, so close-before-wire is mandatory.
        self.comm.close()
        if new_rank < 0:
            # This rank drained/was evicted: it leaves AFTER the verdict,
            # so every survivor knows it is gone by construction.
            _journal("resize.depart", id=proposal["id"], epoch=target,
                     rank=self.rank,
                     evicted=self.rank in proposal["evict"])
            self.membership = new_m
            self._election_commit(new_m, proposal, new_rank)
            self._reform_world(new_m, new_rank)
            return DEPARTED
        self.comm = self.ring_factory(new_rank, new_m.endpoints)
        self.membership = new_m
        self.rank = new_rank
        # Leadership follows the successor rule: the lowest live rank of
        # the committed membership — which renumbering puts at rank 0.
        self.leader_rank = 0
        self.last_aborted = None
        self._election_commit(new_m, proposal, new_rank)
        # Poll alignment: a joiner's controller starts its boundary count
        # at zero, so every survivor resets too — with a poll interval
        # above 1 the counts must agree (the poll is a collective).
        self._boundary_calls = 0
        # Autotune winner cache re-key: the fingerprint keys on process
        # count, so a cache measured at the old size must not survive.
        try:
            from ..collectives import autotune

            autotune.rekey(process_count=new_m.size)
        except Exception:  # noqa: BLE001 — tuning must not fail a commit
            pass
        # PS placement rebalance (leader only): drive the live handoff
        # over the slots whose ring share moves.
        if self.is_leader and proposal["ps_handoffs"]:
            try:
                rebalance = self.ps_rebalance
                if rebalance is None:
                    from .. import parameterserver as ps

                    rebalance = ps.rebalance
                rebalance(proposal["ps_handoffs"])
            except Exception as e:  # noqa: BLE001 — PS exactness machinery
                # owns repair; the membership commit already happened.
                _journal("resize.ps_rebalance_error",
                         id=proposal["id"],
                         error=f"{type(e).__name__}: {e}"[:300])
        self._reform_world(new_m, new_rank)
        return COMMITTED

    def _reform_world(self, membership: Membership, new_rank: int,
                      peers_lost: bool = False) -> None:
        """The card's world follows the committed membership: every old
        member tears its world down (together, as every one of them is
        alive at a commit, unless ``peers_lost``) and every member of the
        new one starts it (``world_hook``; none = the control ring only,
        as in JAX)."""
        if self.world_hook is not None:
            self.world_hook(membership, new_rank, peers_lost)


# ----------------------------------------------------------------- joining

class JoinListener:
    """The joiner's half of the ship: a listening socket whose endpoint
    rides the proposal's ``sync`` field.  :meth:`wait` blocks for the
    state ship and the verdict; COMMIT wires the ring and returns a live
    :class:`ResizeController`; anything else (abort verdict, timeout,
    torn ship) raises :class:`ResizeAborted` with the shipped state
    DISCARDED — the fence guarantee.  ``fenced`` reads True from state
    receipt until the COMMIT verdict lands."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.endpoint: Tuple[str, int] = self._sock.getsockname()[:2]
        self.fenced = False

    def wait(self, timeout_s: float = 60.0,
             ring_factory: Callable = _default_ring_factory,
             state_provider=None, registry=None, world_hook=None,
             ) -> Tuple[ResizeController, Dict[str, np.ndarray]]:
        self._sock.settimeout(timeout_s)
        try:
            conn, _addr = self._sock.accept()
        except socket.timeout:
            raise ResizeAborted(
                f"join listener {self.endpoint} timed out waiting for the "
                "state ship") from None
        try:
            conn.settimeout(timeout_s)
            try:
                header, state = _recv_msg(conn)
                if header.get("phase") != "state":
                    raise ResizeAborted(
                        f"unexpected join phase {header.get('phase')!r}")
                self.fenced = True
                conn.sendall(b"OK")
            except OSError as e:
                # socket.timeout included: EVERY ship-window fault must
                # surface as ResizeAborted (a TransportFailure) so the
                # elastic layer classifies the joiner recoverable.
                raise ResizeAborted(
                    f"state ship to joiner failed mid-window: "
                    f"{type(e).__name__}: {e}") from e
            try:
                (verdict,) = struct.unpack("!Q", _recv_exact(conn, 8))
            except (OSError, ResizeAborted):
                raise ResizeAborted(
                    "no verdict reached the joiner — discarding the "
                    "shipped state (fence holds)") from None
            if verdict != _VERDICT_COMMIT:
                raise ResizeAborted(
                    "resize aborted before this rank joined — shipped "
                    "state discarded (fence holds)")
        finally:
            try:
                conn.close()
            except OSError:
                pass
            self.close()
        membership = Membership(int(header["target_epoch"]),
                                [tuple(ep)
                                 for ep in header["new_endpoints"]])
        my_rank = membership.rank_of(tuple(header["ring"]))
        if my_rank < 0:
            raise ResizeAborted(
                f"join ring endpoint {header['ring']} absent from the "
                "committed membership")
        comm = ring_factory(my_rank, membership.endpoints)
        self.fenced = False
        _journal("resize.join", id=header.get("proposal_id"),
                 epoch=membership.epoch, rank=my_rank,
                 state_keys=sorted(state))
        ctl = ResizeController(comm, membership,
                               state_provider=state_provider,
                               ring_factory=ring_factory,
                               registry=registry, world_hook=world_hook)
        ctl._reform_world(membership, my_rank)
        return ctl, state

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "JoinListener":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# -------------------------------------------------------- restart rejoin
#
# A supervisor-restarted rank must not rejoin cold (fresh state, stale
# peers): any live peer runs a StateServer, the supervisor stamps the
# relaunch environment (TORCHMPI_TPU_RESIZE_REJOIN / _RESIZE_PEER), and
# the restarted rank pulls the live state through the same framing the
# join ship uses before re-entering its loop.

REJOIN_ENV = "TORCHMPI_TPU_RESIZE_REJOIN"
REJOIN_PEER_ENV = "TORCHMPI_TPU_RESIZE_PEER"


class StateServer:
    """A live peer's on-demand state endpoint: every accepted connection
    gets one state message (``state_provider()`` snapshotted per
    request) and is closed.  Serves both the restart-rejoin path and any
    out-of-band state probe; never raises into the training loop."""

    def __init__(self, state_provider: Callable[[], Dict[str, np.ndarray]],
                 host: str = "127.0.0.1", port: int = 0,
                 meta: Optional[Dict[str, Any]] = None):
        self.state_provider = state_provider
        self.meta = dict(meta or {})
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self._sock.settimeout(0.25)
        self.endpoint: Tuple[str, int] = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"resize-state-{self.endpoint[1]}")
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(10.0)
                _send_msg(conn, dict(self.meta, phase="rejoin_state"),
                          self.state_provider())
            except Exception:  # noqa: BLE001 — a failed probe must not
                pass           # kill the server thread
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "StateServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def rejoin_sync(peer: Tuple[str, int], timeout_s: float = 10.0,
                ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Pull live state from a peer's :class:`StateServer` (the restart
    rejoin path).  Returns ``(meta, state)``; raises
    :class:`ResizeAborted` (recoverable) when the peer is unreachable."""
    try:
        with socket.create_connection(
                (str(peer[0]), int(peer[1])), timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            header, state = _recv_msg(s)
    except OSError as e:
        raise ResizeAborted(
            f"rejoin state sync from {tuple(peer)} failed: "
            f"{type(e).__name__}: {e}") from e
    _journal("resize.rejoin", peer=list(peer),
             state_keys=sorted(state), meta_phase=header.get("phase"))
    return header, state


def maybe_rejoin(timeout_s: float = 10.0,
                 ) -> Optional[Tuple[Dict[str, Any], Dict[str, np.ndarray]]]:
    """The restarted worker's entry hook: when the supervisor stamped the
    relaunch environment (REJOIN_ENV on every relaunch; REJOIN_PEER_ENV
    pointing at a live peer's StateServer), pull the live state before
    re-entering the loop.
    Returns None when not a supervised rejoin (cold start is correct
    then); raises :class:`ResizeAborted` when a rejoin was requested but
    the peer cannot be reached — recoverable, so the supervisor's
    backoff/retry owns it rather than the rank silently rejoining cold."""
    import os

    if not os.environ.get(REJOIN_ENV, "").strip():
        return None
    peer_raw = os.environ.get(REJOIN_PEER_ENV, "").strip()
    if not peer_raw:
        _journal("resize.rejoin", peer=None, cold=True,
                 reason="REJOIN set but no peer endpoint configured")
        return None
    host, _, port = peer_raw.rpartition(":")
    try:
        port_n = int(port)
    except ValueError:
        raise ResizeAborted(
            f"{REJOIN_PEER_ENV}={peer_raw!r} is not host:port — fix the "
            "supervisor environment (recoverable: backoff owns the "
            "retry, the rank must not silently rejoin cold)") from None
    return rejoin_sync((host or "127.0.0.1", port_n),
                       timeout_s=timeout_s)


# ------------------------------------------------------------- card world

def rendezvous(directory: str, membership: Membership) -> str:
    """The ``init_method`` of the card world of ``membership``: a
    ``file://`` store under ``directory`` (which every member sees), named
    by the epoch and the endpoint list, so no two worlds share a store."""
    import os
    import zlib

    tag = zlib.crc32(repr(membership.endpoints).encode())
    return "file://" + os.path.join(
        os.path.abspath(directory),
        f"world-e{membership.epoch}-{tag:08x}")


def card_world_hook(directory: str, device=None,
                    timeout_s: Optional[float] = None) -> Callable:
    """A ``world_hook`` that re-forms the card's world (``lifecycle``)
    over each committed membership: tear the old world down (locally when
    a peer was lost), then, on a member, start the new one at its rank
    over :func:`rendezvous` (``device`` default: the old world's)."""
    def hook(membership: Membership, new_rank: int,
             peers_lost: bool) -> None:
        from . import lifecycle

        dev = device
        if dev is None and lifecycle.started():
            dev = lifecycle.device()
        lifecycle.stop(peers_lost=peers_lost)
        if new_rank < 0:
            return
        lifecycle.start(dev, rank=new_rank, world_size=membership.size,
                        init_method=rendezvous(directory, membership),
                        timeout_s=timeout_s)

    return hook
