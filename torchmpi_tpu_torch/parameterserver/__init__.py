"""Sharded CPU-side parameter server.

Counterpart of ``torchmpi_tpu/parameterserver/__init__.py``.  The reference
shards every registered tensor across the ranks of the current
communicator: each rank owns a contiguous shard in host memory, clients
push updates (zero/copy/add rules) and pull the sharded value back, and a
background server thread services requests (reference:
lib/parameterserver.cpp:241-663; Lua API torchmpi/parameterserver/init.lua).

The PS stays on the CPU by design (reference docs/parameterserver.md:1-3):
shards live in **host** memory of each server process and traffic rides
framed TCP (the port's copy of ``_native/ps.cpp``, the JAX package's wire
protocol byte for byte, so either package's server serves the other's
client).  The card never sees PS traffic: values cross this API as
contiguous CPU tensors or numpy arrays, and a caller whose parameters live
on the card mirrors them into host buffers first (``update.py`` keeps
pinned mirrors and copies explicitly).  A CUDA tensor here raises.

Sharding follows the reference's ``getRange`` exactly: floor split with the
remainder spread over the first ranks (parameterserver.cpp:282-294).

Synchronization: sends/receives return
:class:`~torchmpi_tpu_torch.runtime.handles.ParameterServerSynchronizationHandle` s
waited via ``mpi.sync_handle`` — pushes are ACKed only after the update rule
ran on the server, the reference's deliberate Ssend happens-before
(parameterserver.cpp:340-347).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import flight as _flight
from ..obs import journal as _journal
from ..obs import tracer as _tracer
from ..runtime.failure import PSFenceError, PSTransportError
from ..runtime.handles import ParameterServerSynchronizationHandle
from ..utils import tree as _tree
from . import native
from .placement import PlacementRing

__all__ = [
    "get_range", "init_cluster", "cluster_size", "shutdown",
    "init", "send", "receive", "free", "free_all", "barrier", "handoff",
    "rebalance",
    "init_tensors", "prefetch_tensors", "integrate_tensors", "send_tensors",
    "PSTensor", "client_counters",
]


@contextlib.contextmanager
def _ps_span(name: str, nbytes: int = 0):
    """Span + native correlation stamp around a batch of PS client ops:
    every request dispatched inside (sync, or async via the enqueue-time
    capture in ps.cpp) emits trace events carrying the span's id, so the
    native frames join the Python timeline (obs/native.py).  With
    obs_trace off this is a shared no-op and the stamp is skipped.

    The native stamp (``tmpi_ps_set_correlation``) is one process-wide
    slot, so PS batches issued concurrently from several Python threads
    may attribute each other's frames; the spans themselves stay
    correct."""
    outer = _tracer.current_correlation()
    with _tracer.span(name, bytes=nbytes) as corr:
        if corr:
            native.lib().tmpi_ps_set_correlation(corr)
        try:
            yield corr
        finally:
            if corr:
                # Restore the enclosing span's stamp (0 if none) rather
                # than clearing: a nested batch must not unstamp a parent
                # whose async ops are still being enqueued.
                native.lib().tmpi_ps_set_correlation(outer)


def get_range(total: int, num_shards: int, shard: int) -> Tuple[int, int]:
    """(offset, count) of ``shard``'s slice: floor split + remainder spread
    (reference: getRange, parameterserver.cpp:282-294)."""
    if not (0 <= shard < num_shards):
        raise ValueError(f"shard {shard} out of range [0, {num_shards})")
    base, rem = divmod(total, num_shards)
    count = base + (1 if shard < rem else 0)
    offset = shard * base + min(shard, rem)
    return offset, count


# ---------------------------------------------------------------- cluster

class _Cluster:
    """Process-global PS cluster state: one local server + peers to every
    server endpoint (including our own, via loopback).

    Peers live in **slots** — stable indexes into the endpoint list.
    Non-replicated (the seed contract) addresses shard k at slot k; with
    ``ps_replication`` on, shard keys place onto slots via the
    deterministic consistent-hash ring (``placement.PlacementRing``), a
    slot's endpoint can change under it (supervisor restart, live
    handoff), and a slot that dies for good leaves the ring (promotion)."""

    def __init__(self) -> None:
        self.server_id: Optional[int] = None
        self.peers: List[int] = []          # peer ids, one per server slot
        self.endpoints: List[Tuple[str, int]] = []
        self.lock = threading.RLock()
        self.next_instance = 1
        self.tensors: Dict[int, "PSTensor"] = {}
        # Per-slot serving epoch learned at registration/failover
        # (0 = unfenced: server without durability, or fence off).
        self.epochs: List[int] = []
        # Optional endpoint re-resolver consulted by failover before
        # reconnecting (a restarted server may come back elsewhere).
        self.resolver: Optional[Callable[[int, Tuple[str, int]],
                                         Tuple[str, int]]] = None
        # Replication & placement state (all None/trivial with
        # ps_replication off — the seed paths never touch it).
        self.replicated = False
        self.ring: Optional[PlacementRing] = None
        self.alive: List[bool] = []
        # Membership-change counter shared with the servers
        # (kSetPlacementEpoch, monotonic): every client that promotes or
        # cuts over publishes its bumped view so late joiners start
        # current.  The MAP itself is always derived locally from
        # (alive slots, vnodes) — no coordination on any lookup.
        self.placement_epoch = 0
        # Storm-suppression window (monotonic deadline): promotions that
        # land before this instant coalesce into the placement epoch the
        # window opened with — one bump, one drain fence per preemption
        # wave (``ps_promote_jitter_ms``; 0 keeps every promotion its
        # own epoch, the pre-scale behavior).
        self.promote_window_until = 0.0

    @property
    def started(self) -> bool:
        return bool(self.peers)


_cluster = _Cluster()


def init_cluster(
    endpoints: Optional[Sequence[Tuple[str, int]]] = None,
    listen_port: int = 0,
    start_server: bool = True,
    endpoint_resolver: Optional[Callable[[int, Tuple[str, int]],
                                         Tuple[str, int]]] = None,
) -> List[Tuple[str, int]]:
    """Start the local shard server and connect to every server endpoint.

    Single-host (default): starts one local server and connects to it over
    loopback — the stand-in for a cluster, like ``mpirun -n K`` on one
    machine in the reference.  Multi-host: pass the full endpoint list
    ``[(host, port), ...]``, identical and in identical order on every host
    (shard k lives on endpoints[k]); each host also starts its own server on
    ``listen_port``.

    Durability: with ``ps_snapshot_dir`` set, the local server restores the
    newest snapshot that validates from that directory and starts the
    ``ps_snapshot_interval_ms`` cadence writer — a SIGKILLed server restarted
    against the same directory comes back with its shards and a bumped
    serving epoch (docs/parameterserver.md).  ``endpoint_resolver(i, (h, p))
    -> (h, p)`` is consulted by client failover before reconnecting to a
    restarted shard server (default: same endpoint).

    Returns the endpoint list in shard order.
    """
    with _cluster.lock:
        if _cluster.started:
            raise RuntimeError("parameter-server cluster already initialised")
        L = native.lib()
        # Re-sync the resilience knobs (ps_retry_*, ps_request_deadline_ms,
        # ps_frame_crc) from config at the cluster boundary: the library
        # snapshots them at load, and a config.set() made since (tests, a
        # second cluster with different settings) must take effect here
        # the way hc_* knobs are read at HostCommunicator construction.
        native.apply_config()
        fo = native.failover_config()
        if start_server:
            sid = L.tmpi_ps_server_start(listen_port)
            if sid < 0:
                raise RuntimeError(f"could not start PS server on port {listen_port}")
            _cluster.server_id = sid
            if fo["snapshot_dir"]:
                restored = L.tmpi_ps_restore_dir(
                    sid, fo["snapshot_dir"].encode())
                if restored < 0:
                    raise RuntimeError(
                        f"could not attach PS snapshot dir "
                        f"{fo['snapshot_dir']!r}")
        if endpoints is None:
            if not start_server:
                raise ValueError("endpoints required when start_server=False")
            endpoints = [("127.0.0.1", L.tmpi_ps_server_port(_cluster.server_id))]
        _cluster.endpoints = [(str(h), int(p)) for h, p in endpoints]
        _cluster.resolver = endpoint_resolver
        for host, port in _cluster.endpoints:
            _cluster.peers.append(L.tmpi_ps_connect(host.encode(), port))
        # Liveness rendezvous with every server (reference: init barriers,
        # parameterserver.cpp:677-684).  Spanned so the rendezvous pings'
        # native frames join the cluster-init interval on the timeline.
        with _ps_span("ps.init_cluster"):
            for peer in _cluster.peers:
                if L.tmpi_ps_ping(peer) != 1:
                    raise PSTransportError(
                        "PS server unreachable during init_cluster")
            # Learn each server's serving epoch for the push fence (0 =
            # durability off at that server, which degrades to unfenced).
            _cluster.epochs = [
                int(L.tmpi_ps_fetch_epoch(peer)) if fo["epoch_fence"] else 0
                for peer in _cluster.peers]
            # Replicated group: every slot starts alive on the placement
            # ring, and the placement epoch starts at the max the servers
            # already carry (a client joining after a promotion/handoff
            # must not publish a stale 0 over it — monotonic either way).
            _cluster.replicated = bool(fo["replication"])
            _cluster.alive = [True] * len(_cluster.peers)
            if _cluster.replicated:
                _cluster.ring = PlacementRing(
                    range(len(_cluster.peers)), fo["placement_vnodes"])
                epochs = [native.fetch_placement(peer)
                          for peer in _cluster.peers]
                _cluster.placement_epoch = max(
                    [e[0] for e in epochs if e is not None] or [0])
        return list(_cluster.endpoints)


def cluster_size() -> int:
    return len(_cluster.peers)


def shutdown() -> None:
    """Tear down cluster state + the native engine (drains async work first);
    called by ``mpi.stop()``."""
    with _cluster.lock:
        native.shutdown()
        _cluster.server_id = None
        _cluster.peers = []
        _cluster.endpoints = []
        _cluster.tensors = {}
        _cluster.next_instance = 1
        _cluster.epochs = []
        _cluster.resolver = None
        _cluster.replicated = False
        _cluster.ring = None
        _cluster.alive = []
        _cluster.placement_epoch = 0


def _require_cluster() -> _Cluster:
    if not _cluster.started:
        init_cluster()
    return _cluster


# ------------------------------------------------------------- placement
#
# Shard addressing.  Non-replicated keeps the seed contract bit-for-bit:
# shard k lives on endpoints[k] under the tensor's own instance id.  With
# ``ps_replication`` on, every (tensor, shard) key places onto a slot via
# the consistent-hash ring, the next DISTINCT slot is its backup, and the
# server-side shard is keyed by a WIRE instance that folds the shard
# index into the low 16 bits — two shards of one tensor may then share a
# server without colliding.

#: low bits of the wire instance reserved for the shard index under
#: replication; bounds the group at 65536 slots (and instances at 2^47).
_SHARD_BITS = 16


def _shard_key(instance: int, k: int) -> str:
    return f"{instance}/{k}"


def _wire_instance(c: _Cluster, instance: int, k: int) -> int:
    return ((instance << _SHARD_BITS) | k) if c.replicated else instance


def _owner_slot(c: _Cluster, instance: int, k: int) -> int:
    if not c.replicated:
        return k
    return c.ring.owner(_shard_key(instance, k))


def _owner_backup(c: _Cluster, instance: int, k: int,
                  ) -> Tuple[int, Optional[int]]:
    if not c.replicated:
        return k, None
    return c.ring.owner_backup(_shard_key(instance, k))


# ---------------------------------------------------------------- failover
#
# The crash-restart half of the durability story (the server half is the
# snapshot engine in _native/ps.cpp).  When a request exhausts its native
# retry budget — or a fenced push is NACKed — the client does NOT give up
# with PSTransportError the way the chaos PR's client did.
#
# Non-replicated (the PR 5 contract): re-resolve the endpoint, reconnect
# with the ps_failover_* budget sized to span a supervisor restart,
# re-learn the serving epoch, re-register every tensor, and re-seed each
# shard via an idempotent `copy` of the client-side shadow before the
# caller replays — exactly-once for non-idempotent `add` pushes across a
# server SIGKILL (docs/parameterserver.md "Durability & crash-restart
# failover").
#
# Replicated: the same shadow machinery, placement-addressed.  A failed
# slot gets a short reconnect probe (``ps_promote_reconnect_max``); if it
# answers drained, the client follows the handoff forwarding pointer and
# CUTS OVER to the successor; if it stays dead, the client PROMOTES — the
# slot leaves the ring, every key it owned lands on its old backup (the
# ring successor, which already holds the forwarded replica), the seeder
# re-seeds the moved shards from its shadow (exactly-once preserved), new
# backup chains are wired, and the bumped placement epoch is published.
# Every client derives the identical post-failure map from membership
# alone — no coordinator anywhere.

_counter_names: Dict[str, None] = {}


def _metric(name: str, help_: str = ""):
    """A monotonic client-side counter of this process, in the metrics
    registry (``obs/metrics.py``) as the JAX package keeps it; the names
    touched are remembered for :func:`client_counters`."""
    from ..obs.metrics import registry

    _counter_names.setdefault(name, None)
    return registry.counter(name, help_)


def client_counters() -> Dict[str, int]:
    """The client's failover counters by name (``tmpi_ps_failover_total``,
    ``tmpi_ps_reseed_total``, ``tmpi_ps_promote_total``, ...), read from
    the registry."""
    from ..obs.metrics import registry

    return {n: int(registry.counter(n).value()) for n in _counter_names}


def _reconnect_slot(c: _Cluster, i: int, attempts: int,
                    use_resolver: bool = True) -> Tuple[int, int]:
    """Dial slot ``i``'s endpoint up to ``attempts`` times with
    exponential backoff.  Returns (peer, serving epoch) or (-1, 0).
    ``use_resolver=False`` for a handoff cutover: the endpoint was just
    set to the SUCCESSOR, and a slot-keyed resolver (which answers "where
    does slot i restart") would redirect the dial back to the drained old
    owner.  Caller holds ``c.lock``."""
    fo = native.failover_config()
    L = native.lib()
    host, port = c.endpoints[i]
    if use_resolver and c.resolver is not None:
        host, port = c.resolver(i, (host, port))
        c.endpoints[i] = (str(host), int(port))
    backoff = max(1, fo["failover_backoff_ms"]) / 1e3
    for attempt in range(attempts):
        peer = L.tmpi_ps_connect(str(host).encode(), int(port))
        if L.tmpi_ps_ping(peer) == 1:
            epoch = (int(L.tmpi_ps_fetch_epoch(peer))
                     if fo["epoch_fence"] else 0)
            # tmpi_ps_fetch_epoch returns 0 for BOTH "no durability
            # attached" and "probe failed" — and a server this client
            # saw serve epoch N > 0 cannot be serving 0.  Degrading to
            # the unfenced stamp would silently disable the
            # exactly-once fence, so treat it as mid-restart churn
            # and retry like a failed ping.
            if not (fo["epoch_fence"] and c.epochs[i] > 0 and epoch == 0):
                return peer, epoch
        L.tmpi_ps_disconnect(peer)
        # Exponential, capped at 2 s: sized to span a supervisor
        # restart (process relaunch + import + bind), not a GC pause.
        time.sleep(min(2.0, backoff * (2 ** attempt)))
    return -1, 0


def _swap_peer(c: _Cluster, i: int, peer: int, epoch: int) -> None:
    old = c.peers[i]
    c.peers[i] = peer
    native.lib().tmpi_ps_disconnect(old)
    c.epochs[i] = epoch


def _wire_backup(c: _Cluster, owner: int, backup: Optional[int],
                 wire_inst: int, cnt: int, dt: int,
                 force: int = 0) -> None:
    """(Re)establish the replication chain for one shard: ensure the
    backup's replica exists (``force=0`` keeps forwarded contents;
    ``force=1`` for a fresh registration zeroes a stale replica from a
    previous run) and point the owner's forwarder at it; a ``None``
    backup clears the forwarder."""
    L = native.lib()
    if backup is None:
        L.tmpi_ps_set_backup(c.peers[owner], wire_inst, b"", 0)
        return
    L.tmpi_ps_create(c.peers[backup], wire_inst, cnt, dt, force)
    host, port = c.endpoints[backup]
    L.tmpi_ps_set_backup(c.peers[owner], wire_inst,
                         str(host).encode(), int(port))


def _reregister_slot(c: _Cluster, i: int) -> bool:
    """Re-register (create keep-contents) every shard slot ``i`` serves —
    and, with the fence on, re-seed the seeder's shards from the client
    shadow via idempotent `copy`.  The shadow holds every ACKed update,
    so this also repairs snapshot/replication lag: acked pushes newer
    than the restored/forwarded state are not lost, and the ambiguous
    applied-but-unacked push is overwritten before the caller replays it
    — applied exactly once either way.  Replicated mode also refreshes
    the backup chains the slot participates in.  Caller holds ``c.lock``."""
    fo = native.failover_config()
    L = native.lib()
    for t in list(c.tensors.values()):
        dt = native.dtype_code(t.dtype)
        for k, (off, cnt) in enumerate(t.ranges):
            if cnt == 0:
                continue
            owner, backup = _owner_backup(c, t.instance, k)
            if owner != i and backup != i:
                continue
            wi = _wire_instance(c, t.instance, k)
            if L.tmpi_ps_create(c.peers[owner], wi, cnt, dt, 0) != 1:
                return False
            if (owner == i and fo["epoch_fence"] and t.shadow is not None
                    and t.seeder):
                ptr = t.shadow.data_ptr() + off * t.itemsize
                if L.tmpi_ps_push_fenced(c.peers[owner], wi,
                                         native.RULE_COPY, dt, 0, cnt, ptr,
                                         c.epochs[owner]) != 1:
                    return False
                _metric("tmpi_ps_reseed_total",
                        "shards re-seeded from the client shadow after a "
                        "server restart/promotion/cutover").inc()
            if c.replicated:
                _wire_backup(c, owner, backup, wi, cnt, dt)
    return True


def _failover_peer(c: _Cluster, i: int) -> bool:
    """Non-replicated failover (the PR 5 contract): reconnect shard
    server ``i`` and re-establish client state against its restored
    epoch.  Caller holds ``c.lock``.  Returns False when failover is off
    (``ps_failover_max`` 0) or the budget is exhausted — the caller
    raises :class:`PSTransportError` then."""
    fo = native.failover_config()
    if fo["failover_max"] <= 0:
        return False
    with _tracer.span("ps.failover", peer=i):
        _metric("tmpi_ps_failover_total",
                "PS client failover attempts after an exhausted retry "
                "budget or an epoch-fence NACK").inc()
        # Flight recorder: the murdered/unreachable primary wrote nothing
        # (nothing SIGKILLed can) — the SURVIVOR's bundle is the forensic
        # record of the failure, captured before recovery traffic
        # overwrites the ring tails (obs_flight knob; never raises).
        _flight.on_failure("ps_failover", slot=i,
                           endpoint=c.endpoints[i])
        _journal.emit("ps.failover", slot=i, endpoint=list(c.endpoints[i]),
                      replicated=False)
        peer, epoch = _reconnect_slot(c, i, fo["failover_max"])
        if peer < 0:
            return False
        _swap_peer(c, i, peer, epoch)
        return _reregister_slot(c, i)


def _publish_placement(c: _Cluster) -> None:
    """Best-effort publish of the client's placement epoch to every live
    server (monotonic max server-side): late-joining clients then fetch a
    current epoch at init_cluster.  Failures are ignored — the map itself
    never depends on this, it derives from membership locally."""
    L = native.lib()
    for s, alive in enumerate(c.alive):
        if alive:
            L.tmpi_ps_set_placement_epoch(c.peers[s], c.placement_epoch)


def _cutover_slot(c: _Cluster, i: int, successor: Tuple[str, int],
                  server_placement_epoch: int) -> bool:
    """Follow a drained server's forwarding pointer: slot ``i`` keeps its
    ring identity (zero keys move) but its endpoint becomes the handoff
    successor.  Caller holds ``c.lock``."""
    fo = native.failover_config()
    _journal.emit("ps.cutover", slot=i,
                  successor=[str(successor[0]), int(successor[1])],
                  placement_epoch=int(server_placement_epoch))
    with _tracer.span("ps.cutover", peer=i):
        c.endpoints[i] = (str(successor[0]), int(successor[1]))
        # The successor is a DIFFERENT server: the old slot's serving
        # epoch must not gate the reconnect (a fresh target may
        # legitimately serve epoch 0 = no durability attached), and the
        # slot-keyed resolver must not redirect the dial back to the
        # drained old owner's restart address.
        c.epochs[i] = 0
        peer, epoch = _reconnect_slot(c, i, max(1, fo["failover_max"]),
                                      use_resolver=False)
        if peer < 0:
            return False
        _swap_peer(c, i, peer, epoch)
        c.placement_epoch = max(c.placement_epoch + 1,
                                int(server_placement_epoch))
        ok = _reregister_slot(c, i)
        _publish_placement(c)
        return ok


def _promote_slot(c: _Cluster, i: int) -> bool:
    """Slot ``i`` is dead for good: remove it from the ring — every key
    it owned lands on its old backup (the ring successor), which already
    holds the forwarded replica — re-seed the moved shards (seeder), wire
    new backup chains, publish the bumped placement epoch.  Caller holds
    ``c.lock``."""
    prev = c.ring
    if len(prev.slots) <= 1:
        return False  # nothing to promote onto
    fo = native.failover_config()
    window_s = max(0, int(fo["promote_jitter_ms"])) / 1e3
    coalesced = window_s > 0 and time.monotonic() < c.promote_window_until
    if window_s > 0 and not coalesced:
        # First promotion of a storm window: a token-bucket jitter
        # de-phases the N clients that all watched the same preemption
        # wave, so their re-seed pushes don't land on the survivors in
        # lockstep.  Sleeping under ``c.lock`` is deliberate — it
        # serializes THIS client's own promotions, which is exactly what
        # lets the rest of the wave coalesce below.
        time.sleep(random.uniform(0.0, window_s))
        c.promote_window_until = time.monotonic() + window_s
    _metric("tmpi_ps_promote_total",
            "backup servers promoted to shard owners after a dead "
            "primary left the placement ring").inc()
    _flight.on_failure("ps_promote", slot=i, endpoint=c.endpoints[i],
                       placement_epoch=c.placement_epoch)
    _journal.emit("ps.promote", slot=i, endpoint=list(c.endpoints[i]),
                  placement_epoch=c.placement_epoch,
                  coalesced=bool(coalesced))
    with _tracer.span("ps.promote", peer=i):
        c.alive[i] = False
        c.ring = prev.without(i)
        if coalesced:
            # Inside the window: reuse the epoch the window opened with.
            # The placement map is always derived locally from the alive
            # set; the epoch is only a monotonic change detector and
            # drain fence, so a storm of K promotions needs one bump —
            # every demoted server still gets fenced (below) at it.
            _metric("tmpi_promote_coalesced_total",
                    "promotions folded into an already-open storm "
                    "window's placement-epoch bump instead of bumping "
                    "again").inc()
        else:
            c.placement_epoch += 1
        L = native.lib()
        ok = True
        for t in list(c.tensors.values()):
            dt = native.dtype_code(t.dtype)
            for k, (off, cnt) in enumerate(t.ranges):
                if cnt == 0:
                    continue
                key = _shard_key(t.instance, k)
                moved = prev.owner(key) == i
                if not moved and prev.owner_backup(key)[1] != i:
                    continue  # slot i played no role for this shard
                wi = _wire_instance(c, t.instance, k)
                # create keep-contents: a moved shard keeps the replica
                # the forwarder built on the new owner (= old backup).
                # In a preemption STORM the successor may have died in
                # the same wave — cascade: fail over (promote) the dead
                # successor too, re-derive this shard's placement from
                # the shrunk ring, and retry.  Bounded by the slot
                # count: every cascade step removes a slot from the
                # ring or repairs it in place.
                owner = backup = None
                for _ in range(len(prev.slots)):
                    o, b = c.ring.owner_backup(key)
                    if L.tmpi_ps_create(c.peers[o], wi, cnt, dt, 0) == 1:
                        owner, backup = o, b
                        break
                    if len(c.ring.slots) <= 1 or not _failover_slot(c, o):
                        break
                if owner is None:
                    ok = False
                    continue
                if (moved and fo["epoch_fence"] and t.shadow is not None
                        and t.seeder):
                    # The forwarded replica is best-effort (async, bounded
                    # queue): the seeder's shadow re-seed re-bases the new
                    # owner to the last-ACKed state — the same idempotent
                    # `copy` that makes the add-replay exactly-once.
                    ptr = t.shadow.data_ptr() + off * t.itemsize
                    if L.tmpi_ps_push_fenced(c.peers[owner], wi,
                                             native.RULE_COPY, dt, 0, cnt,
                                             ptr, c.epochs[owner]) != 1:
                        ok = False
                        continue
                    _metric("tmpi_ps_reseed_total",
                            "shards re-seeded from the client shadow "
                            "after a server restart/promotion/cutover",
                            ).inc()
                _wire_backup(c, owner, backup, wi, cnt, dt)
        # Best-effort promotion fence on the demoted server: if it was
        # merely unreachable to THIS client (a connectivity blip, not a
        # death), this stops it accepting writes as a second owner —
        # other clients' pushes NACK, their probes read the promotion
        # fence (kind 2), and they derive the identical map.  A genuinely
        # dead server just fails the send inside its retry budget.
        L.tmpi_ps_drain(c.peers[i], c.placement_epoch)
        L.tmpi_ps_disconnect(c.peers[i])
        _publish_placement(c)
        return ok


def _failover_slot(c: _Cluster, i: int) -> bool:
    """Re-establish a live owner for every key slot ``i`` serves: the
    non-replicated reconnect contract, or (replicated) probe → cutover →
    promote.  Caller holds ``c.lock``."""
    if not c.replicated:
        return _failover_peer(c, i)
    fo = native.failover_config()
    if fo["failover_max"] <= 0:
        return False
    if not c.alive[i]:
        return True  # already promoted away; keys live elsewhere now
    with _tracer.span("ps.failover", peer=i):
        _metric("tmpi_ps_failover_total",
                "PS client failover attempts after an exhausted retry "
                "budget or an epoch-fence NACK").inc()
        _flight.on_failure("ps_failover", slot=i,
                           endpoint=c.endpoints[i], replicated=True)
        _journal.emit("ps.failover", slot=i, endpoint=list(c.endpoints[i]),
                      replicated=True)
        backoff = max(1, fo["failover_backoff_ms"]) / 1e3
        # Dead-server probes are few (ps_promote_reconnect_max: with a
        # warm backup, promotion is the cheap move) — but a server that
        # ANSWERS gets the patience of the full failover budget: a
        # handoff ship in flight takes seconds, and promoting a live,
        # mid-handoff owner would fork the map from the initiator's.
        probes = max(1, fo["promote_reconnect_max"])
        budget = max(probes, fo["failover_max"])
        dead = 0
        for attempt in range(budget):
            peer, epoch = _reconnect_slot(c, i, 1)
            if peer < 0:
                dead += 1
                if dead >= probes:
                    return _promote_slot(c, i)   # consistently unreachable
                continue
            pl = native.fetch_placement(peer)
            if pl is None:
                native.lib().tmpi_ps_disconnect(peer)
                dead += 1
                if dead >= probes:
                    return _promote_slot(c, i)
                continue
            dead = 0  # it answered: it is not dead
            placement_epoch, drain_kind, successor = pl
            if drain_kind == native.DRAIN_NONE:
                # Alive and serving (a supervisor restarted it in place):
                # the PR 5 reconnect path, placement untouched.
                _swap_peer(c, i, peer, epoch)
                return _reregister_slot(c, i)
            native.lib().tmpi_ps_disconnect(peer)
            if drain_kind == native.DRAIN_PROMOTED:
                # Another client already promoted past this server and
                # fenced it — derive the identical post-promotion map.
                return _promote_slot(c, i)
            if successor is not None:
                return _cutover_slot(c, i, successor, placement_epoch)
            # Handoff fence with no successor yet: a ship is in flight.
            # It either lands (the successor appears) or fails (the
            # drain comes back down) — keep polling; NEVER promote a
            # live mid-handoff owner.
            time.sleep(min(2.0, backoff * (2 ** attempt)))
        # Budget exhausted while the server kept answering mid-handoff:
        # fail this op rather than fork the map.
        return False


def _failover_slot_or_raise(c: _Cluster, t: "PSTensor", slot: int,
                            why: int) -> None:
    """``_failover_slot`` with the send path's error contract (``why``:
    the tmpi_ps_wait result that triggered it).  Caller holds ``c.lock``."""
    if _failover_slot(c, slot):
        return
    if why == -2:
        raise PSFenceError(
            f"PS push fenced by restarted server {c.endpoints[slot]} "
            f"and failover is off/exhausted for {t}")
    raise PSTransportError(
        f"PS send failed for {t}: shard server {c.endpoints[slot]} "
        "unreachable past the failover budget")


def _push_shard(c: _Cluster, t: "PSTensor", k: int, rule_code: int,
                flat: torch.Tensor) -> None:
    """(Re)play one shard's push against its CURRENT owner (promotion or
    cutover may have moved it).  Caller holds ``c.lock``."""
    L = native.lib()
    slot = _owner_slot(c, t.instance, k)
    off, cnt = t.ranges[k]
    ptr = flat.data_ptr() + off * t.itemsize
    r = L.tmpi_ps_push_fenced(c.peers[slot],
                              _wire_instance(c, t.instance, k), rule_code,
                              native.dtype_code(t.dtype), 0, cnt, ptr,
                              c.epochs[slot])
    if r != 1:
        raise PSTransportError(
            f"PS push replay failed (result {r}) for {t} on "
            f"{c.endpoints[slot]}")


def barrier() -> None:
    """Client-side fence: ping every live server after draining async
    work — combined with ack-after-apply pushes this gives the
    barrier-fenced determinism the reference PS tests rely on
    (test/parameterserver.lua:88-102).  A server that stopped answering
    gets one failover cycle (reconnect / cutover / promotion) before the
    barrier fails."""
    c = _require_cluster()
    with _ps_span("ps.barrier"):
        native.lib().tmpi_ps_sync_all()
        for i in range(len(c.peers)):
            if c.alive and not c.alive[i]:
                continue  # promoted away: its keys are fenced elsewhere
            if native.lib().tmpi_ps_ping(c.peers[i]) == 1:
                continue
            with c.lock:
                ok = _failover_slot(c, i)
            if not ok or (c.alive[i]
                          and native.lib().tmpi_ps_ping(c.peers[i]) != 1):
                raise PSTransportError(
                    f"PS barrier failed: shard server {c.endpoints[i]} "
                    "unreachable")


def handoff(slot: int, target: Tuple[str, int]) -> None:
    """Live shard handoff: drain the (hot, doomed, or deprecating) server
    at ``slot`` onto a fresh server at ``target`` — mid-training, with
    zero elastic restarts.  The old owner snapshot-ships every shard to
    the target, fences itself at a bumped placement epoch behind a
    forwarding pointer, and this client cuts over immediately; every
    other client cuts over on its next fenced push (the NACK → placement
    probe → successor path).  The target inherits the slot's ring
    identity, so zero keys move.  Raises :class:`PSTransportError` on a
    torn ship (the old owner un-drains and keeps serving — nothing moved)."""
    c = _require_cluster()
    if not c.replicated:
        raise RuntimeError(
            "handoff requires the replicated placement group "
            "(config.set('ps_replication', True) before init_cluster)")
    L = native.lib()
    with c.lock:
        if not (0 <= slot < len(c.peers)) or not c.alive[slot]:
            raise ValueError(f"slot {slot} is not a live server slot")
        host, port = str(target[0]), int(target[1])
        _journal.emit("ps.handoff", slot=slot, target=[host, port])
        with _ps_span("ps.handoff"):
            L.tmpi_ps_sync_all()  # in-flight pushes settle before the fence
            new_epoch = c.placement_epoch + 1
            if L.tmpi_ps_handoff(c.peers[slot], host.encode(), port,
                                 new_epoch) != 1:
                # tmpi_ps_handoff is deliberately NOT retried on a lost
                # reply (re-shipping a drained server refuses), so a 0
                # is ambiguous: torn ship, or completed-but-reply-lost.
                # The placement probe disambiguates — a drained owner
                # advertising OUR target means the ship landed.
                pl = native.fetch_placement(c.peers[slot])
                if not (pl is not None
                        and pl[1] == native.DRAIN_HANDOFF
                        and pl[2] == (host, port)):
                    raise PSTransportError(
                        f"handoff of slot {slot} to {target} failed "
                        "(torn ship or unreachable server; the old "
                        "owner still serves)")
            if not _cutover_slot(c, slot, (host, port), new_epoch):
                raise PSTransportError(
                    f"handoff target {target} unreachable after a "
                    "completed ship")


def rebalance(handoffs: Sequence[Tuple[int, Tuple[str, int]]],
              ) -> List[int]:
    """Drive :func:`handoff` over every ``(slot, target)`` pair — the
    elastic-resize commit's PS placement rebalance (``runtime/resize.py``
    calls this from the leader when a membership change moves ring
    shares).  Handoffs run sequentially in the given order; the first
    failure raises with the already-moved slots journaled (each completed
    handoff is individually exact — the handoff protocol owns torn-ship
    repair, docs/parameterserver.md).  Returns the moved slots."""
    moved: List[int] = []
    for slot, target in handoffs:
        _journal.emit("ps.rebalance", slot=int(slot),
                      target=[str(target[0]), int(target[1])],
                      moved_so_far=list(moved))
        handoff(int(slot), (str(target[0]), int(target[1])))
        moved.append(int(slot))
    return moved


# ----------------------------------------------------------------- tensors

class PSTensor:
    """A tensor registered with the parameter server (the reference's
    per-tensor PS instance, cached in torchmpi/cache.lua parameterServers).
    ``dtype`` is a torch dtype."""

    def __init__(self, instance: int, shape: Tuple[int, ...],
                 dtype: torch.dtype):
        self.instance = instance
        self.shape = tuple(shape)
        self.dtype = native.torch_dtype(dtype)
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.total = int(np.prod(shape)) if shape else 1
        c = _require_cluster()
        self.ranges = [get_range(self.total, len(c.peers), i)
                       for i in range(len(c.peers))]
        # Client-side shadow of the sharded value (flat, c-contiguous):
        # every ACKed update is folded in, so a failover can re-seed a
        # restarted server via idempotent `copy` before replaying a
        # non-idempotent push.  Kept only with ps_epoch_fence on (it costs
        # one host copy of the tensor); exact under the single-logical-
        # writer usage the update rules assume — with concurrent writers
        # the re-seed re-bases the shard to THIS client's last-acked view
        # (docs/parameterserver.md).
        self.shadow: Optional[torch.Tensor] = None
        # True once THIS client has written authoritative full state
        # (seeding init, or an ACKed full `copy`/`zero` push).  Only a
        # seeder's failover re-seeds the restarted server from its shadow:
        # a worker that registered with initial='zero' against an
        # already-seeded tensor carries a zeros shadow, and re-seeding
        # from it would wipe the restored shard.
        self.seeder = False

    def __repr__(self) -> str:
        return (f"PSTensor<#{self.instance}, shape={self.shape}, "
                f"{self.dtype}, shards={len(self.ranges)}>")


def _host(value: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``value`` (a CPU tensor or a numpy array) as a contiguous CPU
    tensor, in ``dtype`` when given (a cast is a copy).  A CUDA tensor
    raises: the caller mirrors it into a host buffer, explicitly."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise ValueError(
                f"parameter-server values live on the host; got a tensor on "
                f"{value.device} (copy it into a host buffer first)")
        t = value.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(value))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.contiguous()


def init(value: Any, initial: str = "copy", reset: bool = True,
         ) -> PSTensor:
    """Register a tensor, creating one shard per server.

    ``initial='copy'`` seeds the shards with ``value`` (the reference's
    psInitFun copying rank-0's tensor, parameterserver/init.lua:138-145);
    ``initial='zero'`` keeps the default-zero shards the reference tests
    rely on.  In multi-host deployments only one host should seed
    (process_index 0) — callers gate that, matching rank-0 psInitFun.

    ``reset=True`` (a fresh registration) zeroes any shard a previous run
    left on a still-running server under the same instance id;
    ``reset=False`` (a late worker registering a tensor the seeding worker
    already registered) keeps a matching existing shard's contents.
    """
    c = _require_cluster()
    if initial not in ("copy", "zero"):
        raise ValueError("initial must be 'copy' or 'zero'")
    value = _host(value)
    dt = native.dtype_code(value.dtype)
    with c.lock:
        inst = c.next_instance
        c.next_instance += 1
    t = PSTensor(inst, value.shape, value.dtype)
    L = native.lib()
    with _ps_span("ps.init", value.numel() * t.itemsize):
        for k, (off, cnt) in enumerate(t.ranges):
            owner, backup = _owner_backup(c, inst, k)
            wi = _wire_instance(c, inst, k)
            force = 1 if reset else 0
            if L.tmpi_ps_create(c.peers[owner], wi, cnt, dt, force) != 1:
                raise PSTransportError(f"PS create failed for {t}")
            if c.replicated and cnt:
                # Replication chain: the backup's replica + the owner's
                # forwarder, derived from the ring by every client alike.
                # The registration's reset semantics carry through: a
                # fresh registration zeroes a stale backup replica too.
                _wire_backup(c, owner, backup, wi, cnt, dt, force=force)
    if native.failover_config()["epoch_fence"]:
        t.shadow = torch.zeros((t.total,), dtype=t.dtype)
    t.seeder = initial == "copy"
    # Registration before seeding: the seeding send() must see the tensor
    # in c.tensors so its failover path can re-register it, and updates
    # the shadow like any other acked push.
    with c.lock:
        c.tensors[inst] = t
    if initial == "copy":
        try:
            send(t, value, rule="copy").wait()
        except Exception:
            # A seed that failed past the failover budget must leave no
            # trace: a registered tensor with a zeros shadow would be
            # re-seeded to zeros on every later failover.
            with c.lock:
                c.tensors.pop(inst, None)
            raise
    return t


def send(t: PSTensor, value: Any, rule: str = "add",
         ) -> ParameterServerSynchronizationHandle:
    """Async push of ``value`` to all shards with an update rule
    (reference: clientSend, parameterserver.cpp:309-353).  Returns a handle;
    completion means every server applied the rule **exactly once**: a push
    that fails past the native retry budget, or is epoch-fenced by a server
    restarted from a snapshot, rides the failover path — reconnect,
    re-register, re-seed via idempotent ``copy`` of the client shadow, then
    replay — inside ``handle.wait()``.  ``value`` (a CPU tensor or numpy
    array) is cast to the registered dtype."""
    c = _require_cluster()
    rules = {"zero": native.RULE_ZERO, "copy": native.RULE_COPY, "add": native.RULE_ADD}
    if rule not in rules:
        raise ValueError(f"rule must be one of {sorted(rules)}")
    flat = _host(value, t.dtype).reshape(-1)
    if flat.numel() != t.total:
        raise ValueError(f"value size {flat.numel()} != registered {t.total}")
    nbytes = t.total * t.itemsize
    dt = native.dtype_code(t.dtype)
    L = native.lib()
    # (shard index, DISPATCH slot, native handle): the slot each push was
    # addressed to is recorded so the failure path below can tell which
    # ACKed shards rode a slot that later had to be re-seeded.
    pending: List[Tuple[int, int, int]] = []
    with _ps_span("ps.send", nbytes) as corr:
        # The enqueue happens inside the span: ps.cpp captures the
        # correlation id per async op and replays it on the offload pool,
        # so the pooled pushes' native events join this span.  Every push
        # is the fenced variant: epoch 0 (fence off / no durability)
        # degrades to the unfenced wire behaviour.
        for k, (off, cnt) in enumerate(t.ranges):
            if cnt == 0:
                continue
            slot = _owner_slot(c, t.instance, k)
            ptr = flat.data_ptr() + off * t.itemsize
            pending.append((k, slot, L.tmpi_ps_push_async_fenced(
                c.peers[slot], _wire_instance(c, t.instance, k),
                rules[rule], dt, 0, cnt, ptr, c.epochs[slot])))

    def wait_fn(pending=pending, keepalive=flat):
        # keepalive pins the buffer until completion — the analogue of the
        # reference's retained storages (torch_mpi.h:64-91).
        bad = [(k, slot, r) for k, slot, r in
               ((k, slot, L.tmpi_ps_wait(h)) for k, slot, h in pending)
               if r != 1]
        if bad:
            with c.lock:
                fo = native.failover_config()
                failed: Dict[int, int] = {}   # slot -> first failure code
                for k, slot, r in bad:
                    failed.setdefault(slot, r)
                for slot, why in failed.items():
                    _failover_slot_or_raise(c, t, slot, why)
                replay = {k for k, slot, r in bad}
                if fo["epoch_fence"] and t.shadow is not None and t.seeder:
                    # A failed slot may host SEVERAL shards of this send
                    # (consistent hashing co-locates), and some of their
                    # pushes may have ACKed before the crash.  The
                    # seeder's failover re-seeded the slot's shards from
                    # the shadow — which does not yet fold THIS update —
                    # so the ACKed shards' applies were just erased:
                    # replay them too (exactly once either way: the
                    # re-seed wiped whatever had landed).
                    replay |= {k for k, slot, h in pending
                               if slot in failed}
                for k in sorted(replay):
                    _push_shard(c, t, k, rules[rule], flat)
        if t.shadow is not None:
            # Every shard ACKed (directly or via replay): fold the update
            # into the shadow so a future re-seed carries it.
            with c.lock:
                if rule == "zero":
                    t.shadow.zero_()
                    t.seeder = True
                elif rule == "copy":
                    t.shadow.copy_(flat)
                    t.seeder = True
                else:
                    t.shadow.add_(flat)
        return True

    return ParameterServerSynchronizationHandle.from_native(
        wait_fn, correlation=corr,
        op_label="ps.send.e2e" if corr else None, op_bytes=nbytes,
        dispatch_t_ns=_tracer.now_ns() if corr else 0)


def receive(t: PSTensor, out: Optional[torch.Tensor] = None,
            ) -> Tuple[ParameterServerSynchronizationHandle, torch.Tensor]:
    """Async pull of the full sharded value (reference: clientReceive's
    post-Irecvs-then-trigger, parameterserver.cpp:356-400).  Returns
    (handle, buffer): a CPU tensor (``out``, e.g. a pinned host mirror,
    or a new one), valid after ``handle.wait()``."""
    c = _require_cluster()
    if out is None:
        out = torch.empty(t.shape, dtype=t.dtype)
    elif (tuple(out.shape) != t.shape or out.dtype != t.dtype
          or not out.is_contiguous() or out.device.type != "cpu"):
        raise ValueError("out buffer must be a contiguous CPU tensor with "
                         "matching shape/dtype")
    flat = out.view(-1)
    nbytes = t.total * t.itemsize
    dt = native.dtype_code(t.dtype)
    L = native.lib()
    pending: List[Tuple[int, int]] = []   # (shard index, native handle)
    with _ps_span("ps.receive", nbytes) as corr:
        for k, (off, cnt) in enumerate(t.ranges):
            if cnt == 0:
                continue
            slot = _owner_slot(c, t.instance, k)
            ptr = flat.data_ptr() + off * t.itemsize
            pending.append((k, L.tmpi_ps_pull_async(
                c.peers[slot], _wire_instance(c, t.instance, k), dt,
                0, cnt, ptr)))

    def wait_fn(pending=pending, keepalive=out):
        bad = [k for k, h in pending if L.tmpi_ps_wait(h) != 1]
        if bad:
            # Pulls are idempotent: failover each DISTINCT failed slot
            # once (consistent hashing co-locates shards, and a second
            # failover against the already-repaired successor would just
            # churn its healthy connection), then re-pull every failed
            # shard from its (possibly new) owner.
            with c.lock:
                for slot in {_owner_slot(c, t.instance, k) for k in bad}:
                    if not _failover_slot(c, slot):
                        raise PSTransportError(
                            f"PS receive failed for {t}: shard server "
                            f"{c.endpoints[slot]} unreachable past the "
                            "failover budget")
                for k in bad:
                    slot = _owner_slot(c, t.instance, k)
                    off, cnt = t.ranges[k]
                    ptr = flat.data_ptr() + off * t.itemsize
                    if L.tmpi_ps_pull(c.peers[slot],
                                      _wire_instance(c, t.instance, k),
                                      dt, 0, cnt, ptr) != 1:
                        raise PSTransportError(
                            f"PS receive replay failed for {t} on "
                            f"{c.endpoints[slot]}")
        return keepalive

    return ParameterServerSynchronizationHandle.from_native(
        wait_fn, payload=out, correlation=corr,
        op_label="ps.receive.e2e" if corr else None, op_bytes=nbytes,
        dispatch_t_ns=_tracer.now_ns() if corr else 0), out


def free(t: PSTensor) -> None:
    """Drop a tensor's shards on all servers (reference:
    torchmpi_parameterserver_free_*, parameterserver.cpp:700-720).
    Replicated: drops each shard's wire instance from its owner AND its
    backup, and clears the owner's forwarder first (a forward racing the
    free would just recreate nothing — the backup ACKs an unknown
    instance with 0 and the forwarder counts it)."""
    c = _require_cluster()
    L = native.lib()
    L.tmpi_ps_sync_all()
    if c.replicated:
        with c.lock:
            for k, (off, cnt) in enumerate(t.ranges):
                if cnt == 0:
                    continue
                owner, backup = _owner_backup(c, t.instance, k)
                wi = _wire_instance(c, t.instance, k)
                L.tmpi_ps_set_backup(c.peers[owner], wi, b"", 0)
                L.tmpi_ps_free_instance(c.peers[owner], wi)
                if backup is not None:
                    L.tmpi_ps_free_instance(c.peers[backup], wi)
            c.tensors.pop(t.instance, None)
        return
    for peer in c.peers:
        L.tmpi_ps_free_instance(peer, t.instance)
    with c.lock:
        c.tensors.pop(t.instance, None)


def free_all() -> None:
    """Drop every shard everywhere (reference: free_all, :722-745)."""
    c = _require_cluster()
    L = native.lib()
    L.tmpi_ps_sync_all()
    for s, peer in enumerate(c.peers):
        if not c.alive or c.alive[s]:
            L.tmpi_ps_free_all(peer)
    with c.lock:
        c.tensors.clear()


# ------------------------------------------------- tree helper layer
# (reference: parameterserver/init.lua:128-219 initTensors / prefetchTensors /
#  integrateTensors / sendTensors over a table of tensors)

def _leaves(tree) -> List[torch.Tensor]:
    """The tree's leaves (dicts of tensors, JAX leaf order) as contiguous
    CPU tensors."""
    return [_host(x) for x in _tree.leaves(tree)]


def init_tensors(tree, initial: str = "copy", reset: bool = True,
                 ) -> List[PSTensor]:
    """Register every leaf of a tree; returns PSTensors in leaf order."""
    return [init(leaf, initial=initial, reset=reset) for leaf in _leaves(tree)]


def prefetch_tensors(tensors: Sequence[PSTensor], outs=None,
                     ) -> List[Tuple[ParameterServerSynchronizationHandle,
                                     torch.Tensor]]:
    """Launch async pulls for all tensors (reference: prefetchTensors —
    fetch-ahead so integrate overlaps with compute), into ``outs`` (host
    buffers, one a tensor) when given."""
    outs = outs if outs is not None else [None] * len(tensors)
    return [receive(t, out=o) for t, o in zip(tensors, outs)]


def integrate_tensors(prefetched, tree):
    """Wait all prefetches and rebuild a tree shaped like ``tree`` from the
    fetched values (reference: integrateTensors), each leaf in its
    template leaf's dtype, on the host."""
    vals = [h.wait() for h, _ in prefetched]
    leaves, treedef = _tree.flatten(tree)
    vals = [v.to(l.dtype) if isinstance(l, torch.Tensor) else v
            for v, l in zip(vals, leaves)]
    return _tree.unflatten(treedef, vals)


def send_tensors(tensors: Sequence[PSTensor], tree, rule: str = "add",
                 ) -> List[ParameterServerSynchronizationHandle]:
    """Async push of every leaf (reference: sendTensors)."""
    return [send(t, leaf, rule=rule) for t, leaf in zip(tensors, _leaves(tree))]
