"""Failure detection and elastic recovery.

The port of ``torchmpi_tpu/runtime/failure.py``:

* :class:`HeartbeatMonitor`: host-plane peer liveness (UDP ping/echo, the
  JAX package's HBT2 wire format and job token byte for byte, so a port
  rank and a JAX rank watch each other).  A peer silent past the timeout
  is declared dead exactly once, to a callback.  Deliberately not a
  collective: it must keep working when a peer is gone.
* :func:`abort_on_peer_failure` and :class:`Watchdog`: detection turned
  into a process exit (``EXIT_PEER_FAILURE``, ``EXIT_STALLED``) for a
  supervisor to re-form on; the watchdog publishes its liveness to
  ``obs/serve.health``.
* :class:`FaultInjector` + :func:`is_device_failure`: fault injection for
  drills and tests, and the classifier separating recoverable faults from
  programming errors.
* :func:`run_elastic`: the checkpoint-fenced training driver.

In the port a "device" of the elastic loop is a **rank**: a process with
one card.  JAX's :func:`run_elastic` is single-controller and rebuilds on
the surviving devices of its one process; here every rank runs the loop,
and a fault re-forms the world of processes.  Survivors tear the old
world down (``lifecycle.stop``: together when every rank is alive, as
after an injected fault; locally, meeting no peer, when a rank died),
start a fresh one over the surviving ranks (a new rendezvous), agree on
the checkpoint to resume from (``utils/checkpoint.agreed_latest_step``)
and rebuild.  A rank that is not among the survivors leaves cleanly.

What counts as recoverable (:func:`is_device_failure`): JAX's table for
the types both packages share (:class:`InjectedFault`,
:class:`TransportFailure`, a ``RuntimeError``/``OSError`` carrying a
device-loss status code), plus the port's own: the ring's
``RingTimeout`` (a peer never arrived; this rank's stream drained), the
store errors of ``torch.distributed`` (``DistNetworkError``) and the gloo
transport's peer-loss messages.  A sticky CUDA error is never
recoverable: it poisons the process's CUDA context, so no in-process
restart can run a kernel again; the process must exit and a supervisor
relaunch it.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HeartbeatMonitor",
    "FaultInjector",
    "InjectedFault",
    "TransportFailure",
    "HostcommError",
    "HostcommTimeout",
    "HostcommCorruption",
    "PSTransportError",
    "PSFenceError",
    "Watchdog",
    "abort_on_peer_failure",
    "EXIT_PEER_FAILURE",
    "EXIT_STALLED",
    "is_device_failure",
    "run_elastic",
    "free_udp_ports",
]


# ----------------------------------------------------- typed transport faults
#
# The host planes (hostcomm rings, the parameter-server client) raise these
# instead of bare RuntimeErrors so :func:`is_device_failure` classifies a
# sick network as recoverable.  A fault poisons the transport it happened
# on; recovery is a fresh one.

class TransportFailure(RuntimeError):
    """A host-plane transport fault (timeout, corruption, reset).  Base of
    the typed errors below."""


class HostcommError(TransportFailure):
    """hostcomm ring I/O failure: a peer closed or reset its connection
    mid-operation, or the ring could not be wired."""


class HostcommTimeout(HostcommError):
    """A ring wait went past ``hc_io_deadline_ms`` with no progress.  The
    message carries the native side's rank, operation and bytes moved.
    With the knob at 0 this never fires: the ring warns and waits."""


class HostcommCorruption(HostcommError):
    """A received hostcomm frame failed its CRC32 trailer check
    (``hc_frame_crc``): the payload was damaged in flight and was not
    applied."""


class PSTransportError(TransportFailure):
    """A parameter-server request failed after its bounded retry/backoff
    budget (connect failures, expired per-request deadlines, torn frames)."""


class PSFenceError(PSTransportError):
    """A fenced (non-idempotent) PS push was NACKed by a server restarted
    from a snapshot — the rule provably never ran — and the client could
    not complete the failover re-seed-and-replay contract
    (``ps_failover_max`` 0 or exhausted)."""


def _log():
    from ..utils.logging import get_logger

    return get_logger("torchmpi_tpu_torch.failure")


_serve_mod = None


def _health():
    """The live health plane (obs/serve.py), resolved once — Watchdog
    publishes its liveness there so GET /healthz can flip to ``stalled``
    at HALF the watchdog budget and an external poller converts the wedge
    to EXIT_STALLED before in-process expiry does."""
    global _serve_mod
    if _serve_mod is None:
        from ..obs import serve as _serve_mod_

        _serve_mod = _serve_mod_
    return _serve_mod.health


def free_udp_ports(n: int) -> List[int]:
    """``n`` distinct currently-free UDP ports (bind-probe; as with
    hostcomm.free_ports a port can be raced away before use, but probing
    the right protocol family avoids the TCP-free/UDP-busy trap)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


# ------------------------------------------------------------------ heartbeat

# "HBT2": bumped with the wire format when the job-token field was added —
# mixed-version ranks in one job must fail the magic check loudly instead of
# silently length-dropping each other's datagrams and reporting false peer
# deaths during a rolling upgrade.
_MAGIC = 0x48425432  # "HBT2"
_PING, _PONG = 1, 2
_FMT = "!IIBIQ"      # magic, job token, kind, sender rank, seq
_MSG_LEN = struct.calcsize(_FMT)


def _default_token(endpoints) -> int:
    """Per-job token derived from the full endpoint list: a stray datagram
    from another job (or a stale process of a previous run with a different
    topology) fails the token check instead of refreshing liveness.  Jobs
    with an identical endpoint list still collide — pass an explicit
    ``token`` (e.g. derived from the coordinator address + launch id) to
    separate them; the heartbeat plane is assumed trusted (same hosts the
    hostcomm TCP ring runs on), this is hygiene, not authentication."""
    import zlib

    return zlib.crc32(repr(sorted(tuple(e) for e in endpoints)).encode())


class HeartbeatMonitor:
    """UDP peer liveness over the host plane.

    ``endpoints[r]`` is rank r's ``(host, port)``; the monitor binds rank
    ``rank``'s port, echoes every ping, and probes all other ranks every
    ``interval`` seconds.  A peer whose last echo is older than ``timeout``
    is dead: reported by :meth:`dead_peers` and to ``on_failure(rank)``
    (fired once per peer, from the prober thread).  A dead peer that later
    answers again is NOT resurrected — real deployments must treat a flapping
    host as failed until the job re-forms (restart with a new monitor).

    UDP is the right transport: lossy is fine (one lost ping does not kill a
    peer; ``timeout`` should span several intervals), and there is no
    connection state to wedge on a half-dead host.
    """

    def __init__(self, rank: int, endpoints: Sequence[Tuple[str, int]],
                 interval: float = 0.2, timeout: Optional[float] = None,
                 on_failure: Optional[Callable[[int], None]] = None,
                 startup_grace: Optional[float] = None,
                 token: Optional[int] = None):
        if not 0 <= rank < len(endpoints):
            raise ValueError(f"rank {rank} out of range for "
                             f"{len(endpoints)} endpoints")
        self.rank = rank
        self.endpoints = [tuple(e) for e in endpoints]
        # All ranks must agree on the token (they share the endpoint list,
        # so the default agrees by construction).
        self.token = (int(token) & 0xFFFFFFFF) if token is not None \
            else _default_token(self.endpoints)
        self.interval = float(interval)
        self.timeout = float(timeout) if timeout is not None else 5 * interval
        if self.timeout <= self.interval:
            raise ValueError("timeout must exceed the probe interval")
        # A peer never heard from gets this long to come up before it can be
        # declared dead — peers start at different times and dead peers are
        # never resurrected, so the first-contact deadline must span the
        # job's slowest process launch, not one probe timeout.
        self.startup_grace = (float(startup_grace) if startup_grace is not None
                              else max(10 * self.timeout, 5.0))
        self.on_failure = on_failure
        self._lock = threading.Lock()
        now = time.monotonic()
        self._start = now
        self._heard: set[int] = set()
        self._last_seen: Dict[int, float] = {
            r: now for r in range(len(endpoints)) if r != rank}
        self._dead: set[int] = set()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(self.endpoints[rank])
        self._sock.settimeout(0.1)
        self._seq = 0
        self._rx = threading.Thread(target=self._serve, daemon=True,
                                    name=f"hb-rx-{rank}")
        self._tx = threading.Thread(target=self._probe, daemon=True,
                                    name=f"hb-tx-{rank}")
        self._rx.start()
        self._tx.start()

    # Each thread owns one direction: _rx answers pings and records pongs,
    # _tx sends pings and applies the timeout verdicts.
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(256)
            except socket.timeout:
                continue
            except OSError:       # socket closed during stop()
                return
            if len(data) != _MSG_LEN:
                continue
            magic, token, kind, sender, seq = struct.unpack(_FMT, data)
            if magic != _MAGIC or token != self.token or sender == self.rank:
                continue
            with self._lock:
                # Any valid traffic from the peer proves liveness — recorded
                # before the pong attempt so a send-side failure can't mask
                # a received ping.
                if sender in self._last_seen:
                    self._last_seen[sender] = time.monotonic()
                    self._heard.add(sender)
            if kind == _PING:
                try:
                    self._sock.sendto(
                        struct.pack(_FMT, _MAGIC, self.token, _PONG,
                                    self.rank, seq), addr)
                except OSError:
                    # A transient send failure (ENOBUFS, firewall) must not
                    # kill the rx thread; only stop() ends it.
                    if self._stop.is_set():
                        return

    def _probe(self) -> None:
        while not self._stop.wait(self.interval):
            self._seq += 1
            msg = struct.pack(_FMT, _MAGIC, self.token, _PING, self.rank,
                              self._seq)
            for r, ep in enumerate(self.endpoints):
                if r == self.rank:
                    continue
                try:
                    self._sock.sendto(msg, ep)
                except OSError:
                    pass
            now = time.monotonic()
            newly_dead: List[int] = []
            with self._lock:
                for r, seen in self._last_seen.items():
                    if r in self._dead:
                        continue
                    limit = (self.timeout if r in self._heard
                             else self.startup_grace)
                    base = seen if r in self._heard else self._start
                    if now - base > limit:
                        self._dead.add(r)
                        newly_dead.append(r)
            for r in newly_dead:
                if self.on_failure is not None:
                    try:
                        self.on_failure(r)
                    except Exception:  # noqa: BLE001 — monitor must survive
                        _log().exception(
                            "heartbeat on_failure callback raised for "
                            "dead peer %d (suppressed; monitor continues)", r)

    def alive_peers(self) -> List[int]:
        """Peers not declared dead — optimistic: includes peers still inside
        their startup grace that have never spoken.  Use :meth:`heard_peers`
        for confirmed-alive."""
        with self._lock:
            return sorted(r for r in self._last_seen if r not in self._dead)

    def heard_peers(self) -> List[int]:
        """Peers confirmed alive at least once (traffic received)."""
        with self._lock:
            return sorted(self._heard - self._dead)

    def dead_peers(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)

    def stop(self) -> None:
        """Idempotent; safe to call from an ``on_failure`` callback (which
        runs on the prober thread — a thread never joins itself)."""
        self._stop.set()
        cur = threading.current_thread()
        for t in (self._tx, self._rx):
            if t is not cur:
                t.join(timeout=5)
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# -------------------------------------------------- detection -> launcher exit
#
# The two halves of the elastic story meet here: HeartbeatMonitor (above)
# DETECTS a dead peer in-job, and a supervisor RESTARTS on a nonzero worker
# *exit* — these helpers turn detection into that exit, so a worker that
# merely hangs (a frozen process, a wedged host) still brings the
# incarnation down: its PEERS stop hearing it, abort with
# EXIT_PEER_FAILURE, and the supervisor's teardown kills the hung rank
# before relaunching smaller.

EXIT_PEER_FAILURE = 43   # a heartbeat peer died/froze; abort for re-form
EXIT_STALLED = 44        # this process's own training loop stopped moving


def abort_on_peer_failure(rank: int, exit_code: int = EXIT_PEER_FAILURE
                          ) -> Callable[[int], None]:
    """``on_failure`` callback for :class:`HeartbeatMonitor` that force-exits
    the process so the elastic launcher sees a nonzero worker and re-forms
    the job.  ``os._exit`` on purpose: the callback runs on the prober
    thread while the main thread may be wedged inside a collective —
    ``sys.exit`` would raise only in the prober thread and change nothing.
    """
    def cb(dead_rank: int) -> None:
        _log().error(
            "rank %d: heartbeat lost peer %d — aborting for elastic "
            "re-form (exit %d)", rank, dead_rank, exit_code)
        os._exit(exit_code)

    return cb


class Watchdog:
    """Self-detection for the wedge heartbeats cannot see: a process whose
    OS threads still answer pings while its main thread sits forever in a
    collective.  The training loop calls :meth:`kick` every step; if no
    kick arrives for ``timeout`` seconds the watchdog force-exits with
    ``EXIT_STALLED`` and the launcher re-forms the job.

    Pair with :func:`abort_on_peer_failure`: the watchdog catches *my own*
    stall, the heartbeat callback catches *everyone else's* death — either
    way exactly one incarnation teardown follows.
    """

    def __init__(self, timeout: float, rank: int = 0,
                 exit_code: int = EXIT_STALLED,
                 _on_expire: Optional[Callable[[], None]] = None):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be positive")
        self.timeout = float(timeout)
        self.rank = rank
        self._exit_code = exit_code
        self._on_expire = _on_expire       # test seam; default force-exits
        self._last = time.monotonic()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"watchdog-{rank}")
        self._thread.start()
        try:
            _health().register_watchdog(self.timeout)
        except Exception:  # the watchdog must run even if obs cannot
            pass

    def kick(self) -> None:
        with self._lock:
            self._last = time.monotonic()
        try:
            _health().note("watchdog")
        except Exception:
            pass

    def _watch(self) -> None:
        # Poll at a fraction of the timeout: detection latency <= 1.25x.
        while not self._stop.wait(self.timeout / 4):
            with self._lock:
                idle = time.monotonic() - self._last
            if idle > self.timeout:
                _log().error(
                    "rank %d: training loop made no progress for %.1fs "
                    "(watchdog timeout %.1fs) — aborting for elastic "
                    "re-form (exit %d)", self.rank, idle, self.timeout,
                    self._exit_code)
                # The wedged step is about to become EXIT_STALLED and the
                # process dies with everything undrained — the flight
                # recorder's bundle is the only evidence that survives
                # (obs_flight knob).  Dumped on a daemon thread with a
                # bounded join: on_failure swallows exceptions but cannot
                # unblock a hung fsync (wedged NFS, blocking full disk —
                # plausible in exactly the degraded clusters a stalled
                # step lives in), and the EXIT_STALLED conversion must
                # win over its own forensics.
                try:
                    from ..obs import journal as _obs_journal

                    # Same bounded-daemon-thread discipline as the
                    # flight dump below: a journal append blocking on a
                    # wedged NFS mount or full disk (plausible on
                    # exactly the host that is stalling) must not defeat
                    # the EXIT_STALLED conversion this thread exists for.
                    jt = threading.Thread(
                        target=_obs_journal.emit,
                        args=("watchdog.expired",),
                        kwargs={"rank": self.rank,
                                "idle_s": round(idle, 3),
                                "timeout_s": self.timeout,
                                "exit_code": self._exit_code},
                        daemon=True,
                        name=f"watchdog-journal-{self.rank}")
                    jt.start()
                    jt.join(timeout=2.0)
                except Exception:  # noqa: BLE001 — same contract as the
                    pass           # flight dump below
                try:
                    from ..obs import flight as _obs_flight

                    if _obs_flight.enabled():
                        dumper = threading.Thread(
                            target=_obs_flight.on_failure,
                            args=("watchdog_stalled",),
                            kwargs={"rank": self.rank,
                                    "idle_s": round(idle, 3),
                                    "timeout_s": self.timeout,
                                    "exit_code": self._exit_code},
                            daemon=True,
                            name=f"watchdog-flight-{self.rank}")
                        dumper.start()
                        dumper.join(timeout=10.0)
                except Exception:  # noqa: BLE001 — a failed Thread.start
                    # (RLIMIT_NPROC on the very host that is stalling)
                    # must not kill the watchdog before the EXIT_STALLED
                    # conversion it exists for.
                    pass
                if self._on_expire is not None:
                    self._on_expire()
                    return
                os._exit(self._exit_code)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        try:
            # A STOPPED watchdog (training ended cleanly) must not leave
            # a stale mark that reads as stalled forever after.
            _health().unregister_watchdog()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# ------------------------------------------------------- fault classification

class InjectedFault(RuntimeError):
    """A deliberately injected device failure (drills and tests)."""


class FaultInjector:
    """Raise :class:`InjectedFault` at chosen global steps.

    ``FaultInjector({3: "rank 5 lost"})`` fails step 3 once; a step listed
    n times in a list fails its first n occurrences (the elastic loop
    replays steps after a restore, so repeated faults at one step number
    are a meaningful drill).  Thread-safe; ``maybe_fail(step)`` is a no-op
    for unlisted steps.
    """

    def __init__(self, at_steps):
        self._msgs: Dict[int, str] = {}
        self._count: Dict[int, int] = {}
        if isinstance(at_steps, dict):
            for s, msg in at_steps.items():
                self._msgs[int(s)] = str(msg)
                self._count[int(s)] = 1
        else:
            for s in at_steps:
                s = int(s)
                self._msgs[s] = f"injected fault at step {s}"
                self._count[s] = self._count.get(s, 0) + 1
        self._lock = threading.Lock()
        self.fired: List[int] = []

    def maybe_fail(self, step: int) -> None:
        with self._lock:
            remaining = self._count.get(step, 0)
            if remaining:
                self._count[step] = remaining - 1
                self.fired.append(step)
                msg = self._msgs[step]
            else:
                msg = None
        if msg is not None:
            raise InjectedFault(msg)


# ------------------------------------------------------- fault classification

# PJRT/absl status codes that mean the device or runtime (not the program)
# failed: the JAX package's table, kept so the two packages answer alike
# for the types they share.  Deliberately NOT a substring match on
# "device": that word appears in unrelated errors ("No space left on
# device", "tensor on wrong device") which must re-raise.
_DEVICE_FAILURE_MARKERS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED",
    "DATA_LOSS", "device halted", "device is in an invalid state",
)

# The gloo transport's messages when a peer process is gone: its socket
# closed or reset under a send or a receive, or a wait on it ran out.
_PEER_LOSS_MARKERS = (
    "Connection closed by peer", "Connection reset by peer",
    "Broken pipe", "Timed out waiting", "Socket Timeout",
)

# A sticky CUDA error poisons the context: every later CUDA call of the
# process fails, so a restart inside the process cannot succeed.
_STICKY_CUDA_MARKERS = ("CUDA error", "CUDA driver error")


def _is_sticky_cuda(exc: BaseException) -> bool:
    return (type(exc).__name__ == "AcceleratorError"
            or any(m in str(exc) for m in _STICKY_CUDA_MARKERS))


def _is_peer_loss(exc: BaseException) -> bool:
    """The port's own recoverable faults: the ring gave up on a peer, a
    ``torch.distributed`` store connection failed, or the gloo transport
    lost a peer."""
    from ..collectives.cuda_ring import RingTimeout

    if isinstance(exc, RingTimeout):
        return True
    try:
        from torch.distributed import DistNetworkError
    except ImportError:  # a torch built without distributed
        DistNetworkError = ()
    if DistNetworkError and isinstance(exc, DistNetworkError):
        return True
    return (isinstance(exc, (RuntimeError, OSError))
            and any(m in str(exc) for m in _PEER_LOSS_MARKERS))


def is_device_failure(exc: BaseException) -> bool:
    """True for faults worth a checkpoint-restore-rebuild cycle: injected
    faults, typed host-plane transport faults (:class:`TransportFailure`),
    errors carrying a device-loss status code, a ring that gave up on a
    peer, and a lost ``torch.distributed`` peer.  Programming errors
    (TypeError, shape mismatches), deterministic runtime errors (out of
    memory) and sticky CUDA errors are not recoverable and re-raise."""
    if isinstance(exc, (InjectedFault, TransportFailure)):
        return True
    if _is_sticky_cuda(exc):
        return False
    if _is_peer_loss(exc):
        return True
    if (type(exc).__name__ == "XlaRuntimeError"
            or isinstance(exc, (RuntimeError, OSError))):
        return any(m in str(exc) for m in _DEVICE_FAILURE_MARKERS)
    return False


# --------------------------------------------------------------- elastic loop

def _world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _reform(directory: str) -> Callable:
    """The world re-form of :func:`run_elastic`: tear the
    world down (together when the fault was injected, so every rank is
    alive; locally otherwise) and, on a survivor, start a fresh one over
    the surviving ranks, its rendezvous a ``file://`` store under
    ``directory`` (the checkpoint directory, which every rank sees) named
    by the restart and the survivors."""
    def reform(ranks: Sequence[int], me: int, fault: BaseException,
               generation: int) -> None:
        from . import lifecycle

        dev = lifecycle.device() if lifecycle.started() else None
        lifecycle.stop(peers_lost=not isinstance(fault, InjectedFault))
        if me not in ranks:
            return
        name = f".rendezvous-{generation}-" + "-".join(map(str, ranks))
        lifecycle.start(dev, rank=list(ranks).index(me),
                        world_size=len(ranks),
                        init_method="file://" + os.path.join(
                            os.path.abspath(directory), name))

    return reform


def run_elastic(build: Callable[[Sequence[int], Optional[Any]],
                                Tuple[Any, Callable]],
                manager, n_steps: int,
                ranks: Optional[Sequence[int]] = None,
                max_restarts: int = 2,
                injector: Optional[FaultInjector] = None,
                on_restart: Optional[Callable[[int, BaseException],
                                              None]] = None,
                healthy_ranks: Optional[Callable[[], Sequence[int]]] = None,
                state_template: Optional[Any] = None,
                watchdog: Optional[Watchdog] = None,
                ) -> Dict[str, Any]:
    """Checkpoint-fenced elastic training loop, run by every rank.

    ``build(ranks, restored_state) -> (state, step_fn)`` constructs (or
    reconstructs) the training state and a ``step_fn(state, step) ->
    state`` over the started world; with ``restored_state`` (host tensors
    from the last checkpoint, CPU) it must resume from it: placing it on
    the card is the builder's business.  ``manager`` is a
    ``CheckpointManager`` on a directory every rank sees; rank 0 of the
    current world saves every state its schedule selects, with the step
    in the metadata.

    ``ranks`` names the members of the started world (default ``0..p-1``;
    this process is the one at its rank in the world); the names stay
    fixed across re-forms while world ranks renumber.  On an exception
    for which :func:`is_device_failure` holds, every rank asks
    ``healthy_ranks()`` (default: the current members; pass a probe, such
    as a :class:`HeartbeatMonitor`'s verdict, for a real death) and
    re-forms the world over them (:func:`_reform`).  A rank not among the
    survivors returns with ``departed`` set; the survivors agree on the
    latest checkpoint (``agreed_latest_step``), restore it, rebuild via
    ``build`` and replay from the checkpointed step.  Anything else, or
    more than ``max_restarts`` faults, re-raises.

    Returns ``{"state", "restarts", "steps_run", "departed", "ranks"}``.
    ``steps_run`` counts every step executed, replays included.
    ``injector.maybe_fail(step)`` is consulted before each step (the drill
    entry point; in a drill every rank fires at the same step).
    ``watchdog`` is kicked per executed step and per successful (re)build,
    and stopped when the loop returns or raises.
    """
    if ranks is None:
        ranks = list(range(_world_size()))
    ranks = [int(r) for r in ranks]
    me = ranks[_world_rank()]
    reform = _reform(manager.directory)
    members = {"ranks": list(ranks)}
    get_ranks = healthy_ranks or (lambda: members["ranks"])

    state = step_fn = None
    template = state_template
    fault: Optional[BaseException] = None
    try:
        try:
            state, step_fn = build(list(ranks), None)
            if template is None:
                template = _dtype_template(state)
            if watchdog is not None:
                watchdog.kick()
        except Exception as exc:  # noqa: BLE001 — classified below
            if not is_device_failure(exc):
                raise
            fault = _drop_frames(exc)
        return _elastic_loop(build, manager, n_steps, max_restarts,
                             injector, on_restart, get_ranks, template,
                             watchdog, state, step_fn, fault, reform, me,
                             members)
    finally:
        if watchdog is not None:
            watchdog.stop()


def _elastic_loop(build, manager, n_steps, max_restarts, injector,
                  on_restart, get_ranks, template, watchdog, state,
                  step_fn, fault, reform, me, members):
    """The restore -> re-form -> rebuild -> replay loop of
    :func:`run_elastic` (split out so the watchdog lifetime wraps it in
    one ``finally``)."""
    from ..obs import tracer as _obs_tracer
    from ..utils import checkpoint as ckpt

    restarts = 0
    steps_run = 0
    step = 0
    while True:
        if fault is not None:
            from ..obs import flight as _obs_flight
            from ..obs import journal as _obs_journal

            _obs_flight.on_failure("elastic_restore", fault,
                                   restarts_so_far=restarts, step=step)
            _obs_journal.emit("elastic.restore",
                              fault=type(fault).__name__,
                              message=str(fault)[:500],
                              restarts_so_far=restarts, step=step)
            while True:
                if restarts >= max_restarts:
                    raise fault
                restarts += 1
                if on_restart is not None:
                    on_restart(restarts, fault)
                try:
                    ranks = [int(r) for r in get_ranks()]
                    if not ranks:
                        raise RuntimeError("no healthy ranks left") from fault
                    if hasattr(manager, "wait"):
                        manager.wait()
                    with _obs_tracer.span("elastic.reform",
                                          restart=restarts):
                        reform(ranks, me, fault, restarts)
                    members["ranks"] = ranks
                    if me not in ranks:
                        return {"state": None, "restarts": restarts,
                                "steps_run": steps_run, "departed": True,
                                "ranks": ranks}
                    last = ckpt.agreed_latest_step(manager.directory)
                    restored = None
                    if last is not None:
                        if template is None:
                            raise RuntimeError(
                                "checkpoints exist but no dtype template is "
                                "available (the initial build never "
                                "succeeded) — pass state_template"
                            ) from fault
                        with _obs_tracer.span("elastic.restore",
                                              restart=restarts):
                            restored, meta = ckpt.restore(
                                manager.directory, template, step=last)
                        step = int(meta.get("elastic_step", last)) + 1
                    else:
                        step = 0
                    with _obs_tracer.span("elastic.rebuild",
                                          restart=restarts):
                        state, step_fn = build(ranks, restored)
                    if template is None:
                        template = _dtype_template(state)
                    if watchdog is not None:
                        watchdog.kick()
                    fault = None
                    break
                except Exception as exc2:  # noqa: BLE001 — classified below
                    if not is_device_failure(exc2):
                        raise
                    fault = _drop_frames(exc2)
        if step >= n_steps:
            break
        try:
            if injector is not None:
                injector.maybe_fail(step)
            state = step_fn(state, step)
            steps_run += 1
            if watchdog is not None:
                watchdog.kick()
            if _world_rank() == 0:
                manager.maybe_save(step, state, {"elastic_step": step})
            step += 1
        except Exception as exc:  # noqa: BLE001 — classified below
            if not is_device_failure(exc):
                raise
            fault = _drop_frames(exc)
    return {"state": state, "restarts": restarts, "steps_run": steps_run,
            "departed": False, "ranks": list(members["ranks"])}


def _drop_frames(exc: BaseException) -> BaseException:
    """Clear the locals of the fault's finished frames, and of its causes'.
    They hold the failed collective's communicator, and so the old
    world's process group: kept alive through the re-form, its sockets
    stay open, and a peer blocked on this rank would wait out the
    backend's timeout instead of failing at once when this rank tears
    its world down."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if e.__traceback__ is not None:
            traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__
    return exc


def _dtype_template(tree: Any) -> Any:
    """0-d placeholders preserving each leaf's dtype (CPU tensors for
    tensors, numpy for the rest): all ``restore`` needs from a template
    when the builder owns placement, so the restored state comes back on
    the host."""
    import numpy as np
    import torch

    from ..utils import tree as _tree

    def one(a):
        if isinstance(a, torch.Tensor):
            return torch.zeros((), dtype=a.dtype)
        return np.zeros((), a.dtype if hasattr(a, "dtype")
                        else np.asarray(a).dtype)

    return _tree.tree_map(one, tree)
