"""Transport chaos layer: a seeded in-process TCP fault proxy.

The port's copy of the JAX package's ``runtime/chaos.py`` (standard library
only; the port keeps its own so that it imports nothing of the JAX
package).  A :class:`ChaosProxy` listens on a fresh loopback port and
forwards to a real endpoint, applying a :class:`FaultSpec`; callers hand
the proxied address to a transport exactly where the real one would go
(``ring_endpoints`` rewrites a hostcomm ring's endpoint list; a resize
joiner's ``sync`` endpoint can be proxied the same way).  With chaos off
nothing on the fast path changes: no transport code reads these classes.

Faults (per forwarded chunk, deterministic per seed so drills replay):

* ``delay_ms``/``jitter_ms``: added latency (a slow but live peer);
* ``bandwidth_bytes_per_s``: a throughput cap;
* ``corrupt_prob`` / ``corrupt_at_byte``: flip one byte (a torn frame,
  what the hostcomm CRC32 trailers catch);
* ``reset_prob`` / ``reset_after_bytes``: RST-close both sides;
* ``blackhole_prob`` / ``blackhole_after_bytes``: stop forwarding but keep
  the connection open, the hang the I/O deadlines exist to catch;
* ``kill_pid_after_bytes`` (+ ``kill_pid`` / ``kill_pid_file``,
  ``kill_direction``): SIGKILL a process when one direction's forwarded
  byte count crosses a threshold.

Each accepted connection gets RNGs seeded by ``(seed, connection index,
direction)``; ``fault_connections`` scopes faults to chosen connection
indices.  :func:`straggler_delay` is the compute-plane injector (a rank
arriving late into a collective) and :func:`kill_after` the wall-clock
process kill.  Every fired per-event fault journals a ``chaos.fault``
record, so a drill's journal names its own root cause (``obs/rca.py``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["FaultSpec", "ChaosProxy", "ring_endpoints", "spec_from_config",
           "kill_after", "straggler_delay"]


@dataclasses.dataclass
class FaultSpec:
    """What a :class:`ChaosProxy` does to traffic.  The default injects
    nothing (a pure relay — the passthrough row of the drill matrix)."""

    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    bandwidth_bytes_per_s: int = 0          # 0 = unlimited
    corrupt_prob: float = 0.0
    reset_prob: float = 0.0
    blackhole_prob: float = 0.0
    # Deterministic byte-offset triggers (per connection, forward stream
    # offset); -1 = off.  These make single-shot drills exactly
    # reproducible without probability at all.
    corrupt_at_byte: int = -1
    reset_after_bytes: int = -1
    blackhole_after_bytes: int = -1
    # Process-kill fault: when the ``kill_direction`` pump's per-connection
    # forwarded byte count crosses ``kill_pid_after_bytes``, SIGKILL the
    # target — ``kill_pid`` directly, or the pid read from
    # ``kill_pid_file`` at fire time (a supervised target's pid changes
    # per incarnation; the file always names the live one).  The bytes up
    # to the threshold are forwarded first, so the victim dies MID-frame:
    # the exact "server applied half a push and vanished" ambiguity the
    # PS epoch fence + re-seed contract resolves.
    kill_pid: int = -1
    kill_pid_file: str = ""
    kill_pid_after_bytes: int = -1
    kill_direction: str = "fwd"   # which stream's count triggers: fwd | bwd
    # Only connections whose accept-order index is in this set get faults
    # (None = all).  Lets a drill fault incarnation 1 and spare the
    # rebuilt incarnation 2.
    fault_connections: Optional[Set[int]] = None

    def faulty(self) -> bool:
        return bool(self.delay_ms or self.jitter_ms
                    or self.bandwidth_bytes_per_s
                    or self.corrupt_prob or self.reset_prob
                    or self.blackhole_prob or self.corrupt_at_byte >= 0
                    or self.reset_after_bytes >= 0
                    or self.blackhole_after_bytes >= 0
                    or self.kill_pid_after_bytes >= 0)


def _journal_fault(fault: str, **data) -> None:
    """Self-labelling injections (obs/journal.py; one config read when
    journaling is off): every fired fault leaves a ``chaos.fault`` record,
    so a drill's journal names its own root cause — ``obs/rca.py``
    scores an incident chain that STARTS with an injection as injected,
    not mystery.  Per-fire faults only (corrupt/reset/blackhole/kill/
    straggler); the per-chunk shaping faults (delay, bandwidth) would
    write a line per packet and are left to the proxy stats."""
    from ..obs import journal as _journal

    _journal.emit("chaos.fault", fault=fault, **data)


def spec_from_config() -> FaultSpec:
    """Build a :class:`FaultSpec` from the ``chaos_*`` knobs
    (runtime/config.py) — the drill's bridge from config taxonomy to
    proxy behaviour.  Returns a no-op spec when ``chaos_enabled`` is off."""
    from . import config

    if not config.get("chaos_enabled"):
        return FaultSpec()
    return FaultSpec(
        delay_ms=float(config.get("chaos_delay_ms")),
        jitter_ms=float(config.get("chaos_jitter_ms")),
        bandwidth_bytes_per_s=int(config.get("chaos_bandwidth_bytes_per_s")),
        corrupt_prob=float(config.get("chaos_corrupt_prob")),
        reset_prob=float(config.get("chaos_reset_prob")),
        blackhole_prob=float(config.get("chaos_blackhole_prob")),
    )


class _Pump(threading.Thread):
    """One direction of one proxied connection: recv from ``src``, apply
    the fault schedule, send to ``dst``."""

    def __init__(self, proxy: "ChaosProxy", src: socket.socket,
                 dst: socket.socket, rng: random.Random, apply_faults: bool,
                 name: str, direction: str = "fwd"):
        super().__init__(daemon=True, name=name)
        self._proxy = proxy
        self._src, self._dst = src, dst
        self._rng = rng
        self._apply = apply_faults
        self._direction = direction
        self._forwarded = 0

    def run(self) -> None:  # noqa: C901 - one branch per fault class
        spec = self._proxy.spec
        stats = self._proxy.stats
        try:
            while not self._proxy._stop.is_set():
                try:
                    chunk = self._src.recv(16384)
                except OSError:
                    break
                if not chunk:
                    break
                if self._apply:
                    if (spec.kill_pid_after_bytes >= 0
                            and self._direction == spec.kill_direction):
                        start = self._forwarded
                        end = start + len(chunk)
                        if start <= spec.kill_pid_after_bytes < end:
                            # Forward up to the threshold FIRST, so the
                            # victim has consumed a partial frame when it
                            # dies — mid-push/mid-pull exactly — then cut
                            # the proxied connection like the kernel RSTs
                            # a murdered process's sockets.  NOT forwarding
                            # the remainder matters: bytes already sitting
                            # in the proxy's receive buffer would otherwise
                            # deliver a complete frame from a dead server,
                            # and the drill would prove nothing.
                            cut = spec.kill_pid_after_bytes - start
                            if cut:
                                try:
                                    self._dst.sendall(chunk[:cut])
                                except OSError:
                                    pass
                            self._fire_kill()
                            self._reset_both()
                            return
                    if spec.bandwidth_bytes_per_s > 0:
                        time.sleep(len(chunk) / spec.bandwidth_bytes_per_s)
                    if spec.delay_ms or spec.jitter_ms:
                        time.sleep((spec.delay_ms
                                    + spec.jitter_ms * self._rng.random())
                                   / 1e3)
                        stats.bump("delays")
                    start = self._forwarded
                    end = start + len(chunk)
                    if (0 <= spec.corrupt_at_byte < end
                            and spec.corrupt_at_byte >= start):
                        chunk = self._flip(chunk,
                                           spec.corrupt_at_byte - start)
                    elif spec.corrupt_prob and (self._rng.random()
                                                < spec.corrupt_prob):
                        chunk = self._flip(
                            chunk, self._rng.randrange(len(chunk)))
                    if ((0 <= spec.reset_after_bytes < end)
                            or (spec.reset_prob
                                and self._rng.random() < spec.reset_prob)):
                        stats.bump("resets")
                        _journal_fault("reset", direction=self._direction,
                                       after_bytes=self._forwarded)
                        self._reset_both()
                        return
                    if ((0 <= spec.blackhole_after_bytes < end)
                            or (spec.blackhole_prob
                                and self._rng.random()
                                < spec.blackhole_prob)):
                        # Stop forwarding, keep the sockets open: the peer
                        # sees a connection that is alive but silent — the
                        # deadline knobs' target failure mode.
                        stats.bump("blackholes")
                        _journal_fault("blackhole",
                                       direction=self._direction,
                                       after_bytes=self._forwarded)
                        self._proxy._stop.wait()
                        return
                try:
                    self._dst.sendall(chunk)
                except OSError:
                    break
                self._forwarded += len(chunk)
                stats.bump("bytes_forwarded", len(chunk))
        finally:
            # Half-close so the other direction's pump sees EOF cleanly.
            for s in (self._dst, self._src):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def _flip(self, chunk: bytes, pos: int) -> bytes:
        self._proxy.stats.bump("corruptions")
        _journal_fault("corrupt", direction=self._direction,
                       at_byte=self._forwarded + pos)
        b = bytearray(chunk)
        b[pos] ^= 0xFF
        return bytes(b)

    def _fire_kill(self) -> None:
        """SIGKILL the spec's target: ``kill_pid_file`` (read NOW — a
        supervised target's pid changes per incarnation) wins over the
        static ``kill_pid``.  Fires at most once per pump (the byte
        threshold is crossed once); a dead/missing target is a no-op."""
        spec = self._proxy.spec
        pid = spec.kill_pid
        if spec.kill_pid_file:
            try:
                pid = int(open(spec.kill_pid_file).read().strip())
            except (OSError, ValueError):
                pid = -1
        if pid > 0:
            try:
                os.kill(pid, signal.SIGKILL)
                self._proxy.stats.bump("kills")
                _journal_fault("kill", pid=pid,
                               after_bytes=self._forwarded,
                               direction=self._direction)
            except OSError:
                pass

    def _reset_both(self) -> None:
        # SO_LINGER(on, 0) marks the teardown for RST (the abrupt
        # "connection reset by peer" a crashed host produces); shutdown()
        # — not close() — delivers it: the opposite-direction pump sits
        # blocked in recv() on the same fd, whose in-kernel file reference
        # would DEFER a bare close()'s teardown until that recv returns,
        # turning "reset" into silence.  shutdown propagates immediately;
        # the actual close (and RST, given the unread bytes parked in the
        # receive buffer) follows when the pumps unwind.
        for s in (self._src, self._dst):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _Stats:
    """Thread-safe fault counters, snapshot()-able for drill artifacts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "connections": 0, "bytes_forwarded": 0, "delays": 0,
            "corruptions": 0, "resets": 0, "blackholes": 0, "kills": 0,
        }

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)


class ChaosProxy:
    """A TCP relay in front of ``target`` applying a :class:`FaultSpec`.

    ``proxy.endpoint`` is the rewritten ``(host, port)`` to hand to the
    transport in place of ``target``.  Accepts any number of connections;
    each gets a deterministic per-(seed, connection, direction) RNG.
    ``close()`` stops the relay and drops every proxied connection.
    """

    def __init__(self, target: Tuple[str, int],
                 spec: Optional[FaultSpec] = None, seed: Optional[int] = None,
                 listen_host: str = "127.0.0.1"):
        self.target = (str(target[0]), int(target[1]))
        self.spec = spec or FaultSpec()
        if seed is None:
            # Config-taxonomy default (`chaos_seed`), so a proxy wired from
            # the knobs alone (spec_from_config) replays deterministically.
            from . import config

            seed = int(config.get("chaos_seed"))
        self.seed = int(seed)
        self.stats = _Stats()
        self._stop = threading.Event()
        self._conn_serial = 0
        self._pumps: List[_Pump] = []
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(64)
        # Timed accept: a bare close() cannot wake a thread already parked
        # in accept() (the blocked syscall holds the in-kernel file ref),
        # which would cost close() a full join timeout per proxy.
        self._listener.settimeout(0.25)
        self.endpoint: Tuple[str, int] = self._listener.getsockname()
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True,
                                          name=f"chaos-{self.endpoint[1]}")
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            client.settimeout(None)   # pumps use blocking I/O
            idx = self._conn_serial
            self._conn_serial += 1
            self.stats.bump("connections")
            upstream = self._dial_upstream()
            if upstream is None:
                client.close()
                continue
            for s in (client, upstream):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            apply_faults = (self.spec.fault_connections is None
                            or idx in self.spec.fault_connections)
            # Int-mixed (seed, connection, direction) keys — tuple seeds
            # are deprecated — keep drills replayable per seed.
            fwd = _Pump(self, client, upstream,
                        random.Random(self.seed * 0x9E3779B1 + idx * 2),
                        apply_faults,
                        name=f"chaos-fwd-{self.endpoint[1]}-{idx}",
                        direction="fwd")
            bwd = _Pump(self, upstream, client,
                        random.Random(self.seed * 0x9E3779B1 + idx * 2 + 1),
                        apply_faults,
                        name=f"chaos-bwd-{self.endpoint[1]}-{idx}",
                        direction="bwd")
            self._pumps += [fwd, bwd]
            fwd.start()
            bwd.start()

    def _dial_upstream(self) -> Optional[socket.socket]:
        """Connect to the real target, riding out a BRIEF refused window
        (<= 2 s, 50 ms steps).  An elastic rebuild races the proxy: the
        dialing rank can reach the proxy before the proxied rank's fresh
        listener is bound, and a single no-retry dial then turns one
        lost scheduling race into a wiring deadlock — the refused dial
        drops the client, the proxied rank waits its FULL wiring timeout
        for a prev-connection that never comes (a pre-existing ~60 s
        flake in the elastic chaos drill, reproduced on the unmodified
        tree).  A genuinely dead target still fails: 2 s of refusals,
        then the client is dropped exactly as before."""
        deadline = time.monotonic() + 2.0
        while not self._stop.is_set():
            try:
                return socket.create_connection(self.target, timeout=10)
            except OSError:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.05)
        return None

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for p in self._pumps:
            for s in (p._src, p._dst):
                try:
                    s.close()
                except OSError:
                    pass
        for p in self._pumps:
            p.join(timeout=5)
        self._acceptor.join(timeout=5)

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def ring_endpoints(endpoints: Sequence[Tuple[str, int]],
                   spec: Optional[FaultSpec] = None,
                   seed: Optional[int] = None,
                   ) -> Tuple[List[ChaosProxy],
                              List[List[Tuple[str, int]]]]:
    """Rewrite a hostcomm ring's endpoint list through chaos proxies.

    A ring endpoint list serves two roles (collectives/hostcomm.py): rank
    r *binds* ``endpoints[r]`` and *connects to* ``endpoints[(r+1)%n]`` —
    so one shared proxied list would make ranks bind proxy ports.  This
    returns ``(proxies, per_rank)`` where ``per_rank[r]`` keeps every
    entry real except the next-neighbour one, which points at that
    neighbour's proxy: every ring hop now crosses a fault proxy, and rank
    r still binds its true port.  Per-proxy seeds derive from ``seed`` so
    one drill seed fixes the whole ring's schedule (default: the
    ``chaos_seed`` knob, same as a directly constructed proxy).
    """
    if seed is None:
        from . import config

        seed = int(config.get("chaos_seed"))
    n = len(endpoints)
    proxies = [ChaosProxy(ep, spec, seed=seed * 1000003 + i)
               for i, ep in enumerate(endpoints)]
    per_rank: List[List[Tuple[str, int]]] = []
    for r in range(n):
        mine = [tuple(ep) for ep in endpoints]
        nxt = (r + 1) % n
        mine[nxt] = proxies[nxt].endpoint
        per_rank.append(mine)
    return proxies, per_rank


def straggler_delay(spec: FaultSpec, rng: random.Random) -> float:
    """Compute-plane chaos: the stall a straggling RANK injects before
    entering each collective — ``delay_ms + jitter_ms * U[0,1)`` seconds,
    the same knobs the wire proxy applies per forwarded chunk, seeded the
    same way so drills replay.  Returns the seconds slept.

    This exists because the wire faults cannot make a *late arriver*: a
    proxy delay slows bytes IN FLIGHT, which a synchronous ring absorbs
    symmetrically (every rank's completion waits on the slow hop, so all
    ranks start the next collective together and arrival skew stays
    flat).  A slow HOST — arriving late into the collective and gating
    every peer — is the Tail-at-Scale shape the obs straggler detector
    measures, and this helper is its deterministic injector."""
    d = (spec.delay_ms + spec.jitter_ms * rng.random()) / 1e3
    if d > 0:
        _journal_fault("straggler", delay_ms=round(d * 1e3, 3))
        time.sleep(d)
    return d


def kill_after(pid: int, delay_s: float) -> threading.Timer:
    """Time-triggered process murder: SIGKILL ``pid`` after ``delay_s``
    seconds — the wall-clock cousin of ``FaultSpec.kill_pid_after_bytes``
    for drills where "sometime mid-run" is the point and byte-exact timing
    is not (the end-to-end ``run_elastic`` failover cell).  Returns the
    started :class:`threading.Timer`; ``cancel()`` it to disarm."""
    def _fire() -> None:
        try:
            os.kill(pid, signal.SIGKILL)
            _journal_fault("kill", pid=pid, delay_s=delay_s)
        except OSError:
            pass

    t = threading.Timer(delay_s, _fire)
    t.daemon = True
    t.start()
    return t
