"""Replica router: consistent-hash request routing with drain cutover.

The port's copy of ``torchmpi_tpu/serving/router.py``.  Reuses the
parameter-server placement ring
(:class:`~torchmpi_tpu_torch.parameterserver.placement.PlacementRing`,
the JAX ring's hash and virtual points, so a key lands on the same slot
in either package) as a request router: a request key (client/session id) hashes to an owning
replica, so a session's requests keep hitting the same KV-warm replica,
and membership changes move only the keys they must.

Drain/handoff semantics (the parameter server's handoff protocol
applied to serving): a replica entering its handoff window — ``/healthz``
reads ``draining``, or a caller marks it directly — is removed from the *routing view*
(``ring.without``) while staying in the membership, so keys cut over to
their next owner immediately and cut back when the replica rejoins.  A
dead replica (connection refused / SIGKILL) is detected on dispatch and
failed over the same way, with ``tmpi_serve_router_failover_total``
counting the events.
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from ..parameterserver.placement import PlacementRing


class NoReplicas(Exception):
    """Every replica is draining or dead — nothing to route to."""


class ServeRouter:
    """Routes ``POST /generate`` bodies across replica frontends.

    ``replicas`` maps replica slot (int) -> frontend base URL
    (``http://host:port``).  ``probe_urls`` optionally maps the same
    slots to obs endpoints whose ``/healthz`` the router polls —
    ``draining``/unreachable replicas leave the routing view until they
    recover (the roll-restart window).
    """

    def __init__(self, replicas: Dict[int, str],
                 probe_urls: Optional[Dict[int, str]] = None,
                 registry=None, timeout: float = 10.0):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self._replicas = dict(replicas)
        self._probe_urls = dict(probe_urls or {})
        self._ring = PlacementRing(sorted(self._replicas))
        self._out: set = set()          # slots routed around (drain/dead)
        self._lock = threading.Lock()
        self._registry = registry
        self.timeout = float(timeout)

    # -- membership --------------------------------------------------------
    def add_replica(self, slot: int, url: str,
                    probe_url: Optional[str] = None) -> None:
        with self._lock:
            self._replicas[int(slot)] = str(url)
            if probe_url:
                self._probe_urls[int(slot)] = str(probe_url)
            self._ring = self._ring.with_slot(int(slot))
            self._out.discard(int(slot))

    def remove_replica(self, slot: int) -> None:
        with self._lock:
            self._replicas.pop(int(slot), None)
            self._probe_urls.pop(int(slot), None)
            self._out.discard(int(slot))
            live = sorted(self._replicas)
            self._ring = PlacementRing(live) if live else self._ring

    def mark_draining(self, slot: int) -> None:
        """Route around ``slot`` (handoff window) without forgetting it."""
        with self._lock:
            self._out.add(int(slot))

    def unmark(self, slot: int) -> None:
        with self._lock:
            self._out.discard(int(slot))

    def replicas(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._replicas)

    def routable(self) -> List[int]:
        with self._lock:
            return [s for s in sorted(self._replicas) if s not in self._out]

    # -- routing -----------------------------------------------------------
    def _view(self) -> PlacementRing:
        with self._lock:
            ring = self._ring
            if not (set(self._replicas) - self._out):
                return ring     # nothing live: keep the full ring view
            for s in self._out & set(self._replicas):
                ring = ring.without(s)
            return ring

    def route(self, key: str) -> int:
        """The owning replica slot for ``key`` in the current view."""
        candidates = self.routable()
        if not candidates:
            raise NoReplicas("all replicas draining or removed")
        view = self._view()
        owner = view.owner(key)
        if owner in candidates:
            return owner
        return candidates[0]

    # -- health probing ----------------------------------------------------
    def probe(self) -> Dict[int, str]:
        """Refresh the routing view from every replica's health surface.

        A replica with a registered ``probe_url`` answers on its obs
        endpoint's ``/healthz``; the rest are probed on the serving
        frontend's own ``GET /serve`` — so a slot that dispatch marked
        draining after a transport failure rejoins the view when the
        replica comes back even when no obs endpoint was registered.
        ``draining`` (or any 503 state) and unreachable replicas leave
        the view; recovered ones rejoin.  Returns slot -> state."""
        with self._lock:
            targets = {slot: (f"{base}/serve", False)
                       for slot, base in self._replicas.items()}
            targets.update(
                {slot: (f"{base}/healthz", True)
                 for slot, base in self._probe_urls.items()})
        states: Dict[int, str] = {}
        for slot, (url, is_healthz) in sorted(targets.items()):
            state = "unreachable"
            try:
                with urllib.request.urlopen(url, timeout=self.timeout) as r:
                    doc = json.loads(r.read().decode())
                    if is_healthz:
                        state = doc.get("state", "healthy")
                    else:
                        # /serve stats: the frontend reports both the
                        # health drain flag and the engine's own.
                        state = "draining" if (
                            doc.get("health_draining")
                            or doc.get("draining")) else "healthy"
            except urllib.error.HTTPError as e:
                try:
                    state = json.loads(e.read().decode()).get(
                        "state", "unhealthy")
                except Exception:  # noqa: BLE001 - body need not be JSON
                    state = "unhealthy"
            except Exception:  # noqa: BLE001 - refused/reset/timeout
                state = "unreachable"
            states[slot] = state
            if state in ("healthy", "degraded"):
                self.unmark(slot)
            else:
                self.mark_draining(slot)
        return states

    # -- dispatch ----------------------------------------------------------
    def _count(self, name: str, help_: str, labels: Dict[str, str]) -> None:
        if self._registry is None:
            return
        self._registry.counter(name, help_).inc(1, labels)

    def _post(self, slot: int, body: Dict[str, Any]) -> Tuple[int, dict]:
        url = f"{self._replicas[slot]}/generate"
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            # An admission/shed 503 is an ANSWER, not a dead replica —
            # only transport-level failure triggers failover.
            try:
                return e.code, json.loads(e.read().decode() or "{}")
            except Exception:  # noqa: BLE001 - body need not be JSON
                return e.code, {}

    def dispatch(self, key: str, body: Dict[str, Any]) -> Tuple[int, dict]:
        """Route ``key``, POST the request, fail over once on transport
        failure (connection refused/reset — the SIGKILL case) to the
        ring's backup owner."""
        slot = self.route(key)
        self._count("tmpi_serve_router_requests_total",
                    "Requests dispatched by the replica router",
                    {"replica": str(slot)})
        try:
            return self._post(slot, body)
        except OSError:
            self.mark_draining(slot)
            self._count("tmpi_serve_router_failover_total",
                        "Dispatch failovers after a replica transport "
                        "failure", {})
            backup = self.route(key)
            if backup == slot:
                raise
            return self._post(backup, body)
