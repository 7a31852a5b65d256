"""Transport chaos of the port (``torchmpi_tpu_torch/runtime/chaos.py``)
against the port's host ring, and against the JAX package's proxy.

* ``ChaosProxy`` on every hop of a 2-rank port ``HostCommunicator`` ring
  (``ring_endpoints``): a pure relay is invisible; a blackhole raises
  ``HostcommTimeout`` within ``hc_io_deadline_ms``; a flipped byte raises
  ``HostcommCorruption`` with ``hc_frame_crc`` on; a reset raises
  ``HostcommError`` long before the deadline; delays with the CRC on stay
  correct.  Every wait is bounded (60 s).
* The same proxy as JAX's: ``spec_from_config`` from the same knobs,
  ``ring_endpoints``' rewriting, the byte a deterministic corruption
  flips and ``fault_connections``' scoping, ``straggler_delay``'s draw
  from the same seed, and ``kill_after`` killing a process.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torchmpi_tpu.runtime import chaos as jchaos
from torchmpi_tpu.runtime import config as jconfig
from torchmpi_tpu_torch.collectives import hostcomm as thc
from torchmpi_tpu_torch.runtime import chaos as tchaos
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime.failure import (HostcommCorruption,
                                                HostcommError,
                                                HostcommTimeout)

WALL = 60.0


@pytest.fixture(autouse=True)
def _fresh():
    tconfig.reset()
    jconfig.reset()
    yield
    tconfig.reset()
    jconfig.reset()


def _ring_through(spec, **cfg):
    """A 2-rank port ring with every hop crossing a port chaos proxy
    (two wiring attempts: a free port can be raced away before the ring
    binds it)."""
    tconfig.reset(**cfg)
    err = None
    for _ in range(2):
        eps = [("127.0.0.1", p) for p in thc.free_ports(2)]
        proxies, per_rank = tchaos.ring_endpoints(eps, spec, seed=7)
        wired, errs = [], []
        with ThreadPoolExecutor(2) as ex:
            for f in [ex.submit(thc.HostCommunicator, r, 2, per_rank[r],
                                60000) for r in range(2)]:
                try:
                    wired.append(f.result(timeout=WALL))
                except Exception as exc:  # noqa: BLE001 — retried once
                    errs.append(exc)
        if not errs:
            return proxies, wired
        for c in wired:
            c.close()
        for p in proxies:
            p.close()
        err = errs[0]
    raise err


def _run_ranks(comms, fn):
    with ThreadPoolExecutor(len(comms)) as ex:
        futs = [ex.submit(fn, c, r) for r, c in enumerate(comms)]
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=WALL))
            except Exception as exc:  # noqa: BLE001 — asserted by callers
                out.append(exc)
        return out


def _allreduce(c, r):
    return c.allreduce(torch.full((50000,), float(r)))


@pytest.mark.parametrize("case", ["passthrough", "blackhole", "corrupt",
                                  "reset", "delay"])
def test_proxy_against_the_port_ring(case):
    spec, cfg = {
        "passthrough": (tchaos.FaultSpec(), {}),
        "blackhole": (tchaos.FaultSpec(blackhole_after_bytes=2000),
                      {"hc_io_deadline_ms": 800}),
        "corrupt": (tchaos.FaultSpec(corrupt_at_byte=1234),
                    {"hc_frame_crc": True, "hc_io_deadline_ms": 10000}),
        "reset": (tchaos.FaultSpec(reset_after_bytes=4000),
                  {"hc_io_deadline_ms": 30000}),
        "delay": (tchaos.FaultSpec(delay_ms=2.0, jitter_ms=1.0),
                  {"hc_frame_crc": True, "hc_io_deadline_ms": 10000}),
    }[case]
    proxies, comms = _ring_through(spec, **cfg)
    try:
        t0 = time.perf_counter()
        outs = _run_ranks(comms, _allreduce)
        took = time.perf_counter() - t0
        if case in ("passthrough", "delay"):
            assert all(torch.equal(o, torch.ones(50000)) for o in outs), outs
            assert sum(p.stats["bytes_forwarded"] for p in proxies) > 0
        elif case == "blackhole":
            assert all(isinstance(o, HostcommTimeout) for o in outs), outs
            assert all("allreduce" in str(o) for o in outs)
            assert any(p.stats["blackholes"] for p in proxies)
            assert took < 20
        elif case == "corrupt":
            assert any(isinstance(o, HostcommCorruption) for o in outs), outs
            assert all(isinstance(o, HostcommError) for o in outs), outs
            assert any(p.stats["corruptions"] for p in proxies)
        else:
            assert all(type(o) is HostcommError for o in outs), outs
            assert took < 20
    finally:
        for c in comms:
            c.close()
        for p in proxies:
            p.close()


# ------------------------------------------------------ the same as JAX's

def test_spec_from_config_equals_jax():
    knobs = dict(chaos_enabled=True, chaos_delay_ms=3.0, chaos_jitter_ms=1.5,
                 chaos_bandwidth_bytes_per_s=1 << 20, chaos_corrupt_prob=0.1,
                 chaos_reset_prob=0.01, chaos_blackhole_prob=0.02)
    assert dataclasses.asdict(tchaos.spec_from_config()) == \
        dataclasses.asdict(jchaos.spec_from_config())
    tconfig.reset(**knobs)
    jconfig.reset(**knobs)
    assert dataclasses.asdict(tchaos.spec_from_config()) == \
        dataclasses.asdict(jchaos.spec_from_config())
    assert tchaos.spec_from_config().faulty()


def test_ring_endpoints_rewrite_as_jax():
    eps = [("127.0.0.1", p) for p in thc.free_ports(3)]
    got = tchaos.ring_endpoints(eps, seed=5)
    want = jchaos.ring_endpoints(eps, seed=5)
    try:
        for (tp, tr), (jp, jr) in [(got, want)]:
            assert [p.target for p in tp] == [p.target for p in jp]
            assert [p.seed for p in tp] == [p.seed for p in jp]
            for r in range(3):
                nxt = (r + 1) % 3
                assert tr[r][nxt] == tp[nxt].endpoint
                assert jr[r][nxt] == jp[nxt].endpoint
                assert [e for i, e in enumerate(tr[r]) if i != nxt] == \
                    [e for i, e in enumerate(jr[r]) if i != nxt]
    finally:
        for p in got[0] + want[0]:
            p.close()


class _Sink:
    """A loopback server that keeps every connection's bytes."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.sock.settimeout(10)
        self.endpoint = self.sock.getsockname()
        self.got = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        for _ in range(2):
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            conn.settimeout(10)
            buf = bytearray()
            with conn:
                while True:
                    try:
                        chunk = conn.recv(65536)
                    except OSError:
                        break
                    if not chunk:
                        break
                    buf += chunk
            self.got.append(bytes(buf))

    def close(self):
        self.thread.join(timeout=30)
        self.sock.close()


@pytest.mark.parametrize("mod", [jchaos, tchaos], ids=["jax", "port"])
def test_corruption_is_the_same_byte_as_jax(mod):
    """The byte ``corrupt_at_byte`` flips, and ``fault_connections``
    sparing the second connection, in either package's proxy."""
    payload = bytes(range(256)) * 64
    sink = _Sink()
    proxy = mod.ChaosProxy(sink.endpoint, mod.FaultSpec(
        corrupt_at_byte=1000, fault_connections={0}), seed=3)
    try:
        for _ in range(2):
            with socket.create_connection(proxy.endpoint, timeout=10) as s:
                s.sendall(payload)
            deadline = time.monotonic() + 10
            n = len(sink.got)
            while len(sink.got) == n and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        proxy.close()
        sink.close()
    want = bytearray(payload)
    want[1000] ^= 0xFF
    assert sink.got == [bytes(want), payload]
    assert proxy.stats["corruptions"] == 1


def test_straggler_delay_draws_as_jax():
    t = tchaos.FaultSpec(delay_ms=1.0, jitter_ms=4.0)
    j = jchaos.FaultSpec(delay_ms=1.0, jitter_ms=4.0)
    got = [tchaos.straggler_delay(t, random.Random(11)) for _ in range(3)]
    want = [jchaos.straggler_delay(j, random.Random(11)) for _ in range(3)]
    assert got == want and all(0.001 <= d <= 0.005 for d in got)


def test_kill_after_kills_the_process():
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(60)"])
    try:
        tchaos.kill_after(p.pid, 0.2)
        assert p.wait(timeout=30) == -9
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
