"""Observability CLI of the port: ``python -m torchmpi_tpu_torch.obs``.

Counterpart of ``torchmpi_tpu/obs/__main__.py`` (JAX's ``tmpi-trace``),
with its subcommands and flags:

    snapshot [--prom]                 # metrics registry (after a native
                                      # scrape) as JSON or Prometheus text
    drill --numerics [...]            # NUMERICS drill: auditor against a
                                      # one-byte silent corruption, NaN
                                      # sentinel, diverged /healthz, flight
                                      # evidence, sentinel overhead
    drill --live [...]                # LIVE-plane drill: endpoint
                                      # aggregation, /healthz stall
                                      # conversion, federation survival,
                                      # scrape overhead
    why DIR [--json]                  # root-cause analysis over journals
                                      # + flight bundles + history in DIR
    journal --endpoints ...           # federated live journal tail
    alerts --endpoints ...            # federated live alert view
    top --endpoints U1,U2,...         # refreshing job-level table over
                                      # live per-rank endpoints
    serve [--port P]                  # standalone live endpoint
    merge SPANS EVENTS OUT            # drained spans (json) + events (npy)
          [--device-trace T]          # [+ a torch.profiler Chrome trace]
                                      # -> one Chrome trace
    merge-ranks DIR OUT               # N obsdump bundles -> ONE aligned
                                      # multi-rank trace with flow arrows
    dump DIR [--rank R]               # this process's obsdump-<rank>.json
    report DIR                        # straggler/skew report over DIR

Two flags differ from JAX's: ``merge`` takes ``--device-trace`` (a
``torch.profiler`` Chrome trace, as ``obs/export`` does) where JAX takes
``--xplane``, and ``drill`` takes ``--device`` (the card unless ``cpu``
is asked for).  Of the drills, ``--numerics`` and ``--live`` are here;
the base drill, ``--cluster``, ``--rca`` and ``--alerts`` raise
:class:`DrillNotPorted` (ROADMAP.md item 20).  A drill writes its artifact
to ``--out`` (default: ``<workdir>/<NAME>.json``) and exits 0 on PASS.

The live drill's conversion leg polls the wedged worker's ``/healthz``
itself and kills it on ``stalled``, where JAX's leg runs its
``elastic_launch --health-poll`` supervisor (item 20).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: every wait of a drill's host rings, and the wiring's bound.
_RING_MS = 30000


class DrillNotPorted(NotImplementedError):
    """A drill mode of the JAX CLI that the port has not yet (ROADMAP.md
    item 20: the base drill, ``--cluster``, ``--rca``, ``--alerts``)."""


def _not_ported(name: str):
    raise DrillNotPorted(
        f"drill {name} is not ported yet: it comes with the drills of "
        f"ROADMAP.md item 20 (here: drill --numerics, drill --live)")


def _percentile_ms(samples_s: List[float]) -> float:
    return round(sorted(samples_s)[len(samples_s) // 2] * 1e3, 3)


def _ring(nranks: int, endpoints=None, connect_to=None):
    """``nranks`` host-ring ranks on loopback, wired on threads of this
    process; ``connect_to`` (per rank) overrides the endpoint list a rank
    dials (a chaos proxy on one hop)."""
    from ..collectives.hostcomm import HostCommunicator, free_ports

    eps = endpoints or [("127.0.0.1", p) for p in free_ports(nranks)]
    with ThreadPoolExecutor(nranks) as ex:
        futs = [ex.submit(HostCommunicator, r, nranks,
                          (connect_to or {}).get(r, eps), _RING_MS,
                          io_deadline_ms=_RING_MS)
                for r in range(nranks)]
        return [f.result(timeout=60) for f in futs]


def _write(out_path: str, artifact: Dict[str, Any]) -> None:
    if out_path:
        from .export import atomic_write_json

        atomic_write_json(out_path, artifact, indent=1)


# ------------------------------------------------------------- live drill

def _drill_straggler(nranks: int, straggler: int, steps: int,
                     delay_ms: float, dump_dir: str):
    """A host ring of ``nranks`` runs ``steps`` allreduces under cluster
    correlation ids while ``runtime/chaos.py``'s delay stalls one rank
    before each; a clock alignment over the same ring follows, and each
    rank's spans and native events go into its obsdump bundle."""
    import random

    import torch

    from . import aggregate, clocksync, tracer
    from . import native as obs_native
    from .export import atomic_write_json
    from ..runtime import chaos

    spec = chaos.FaultSpec(delay_ms=delay_ms, jitter_ms=delay_ms / 4)
    comms = _ring(nranks)
    try:
        def work(r):
            rng = random.Random(1000 + r)
            arr = torch.ones(4096)
            comms[r].barrier()
            for step in range(steps):
                corr = tracer.cluster_correlation("drill.step", step)
                if r == straggler:
                    chaos.straggler_delay(spec, rng)
                with tracer.span("drill.step", correlation=corr,
                                 rank=r, step=step):
                    comms[r].allreduce(arr)
            return True

        with ThreadPoolExecutor(nranks) as ex:
            if not all(ex.map(work, range(nranks))):
                raise RuntimeError("a straggler-leg rank failed")
        with ThreadPoolExecutor(nranks) as ex:
            maps = list(ex.map(
                lambda r: clocksync.align(comms[r], rounds=4),
                range(nranks)))
        clockmap = maps[0]
    finally:
        for c in comms:
            c.close()
    spans = tracer.drain()
    events = obs_native.drain_events("hostcomm")
    for rank in range(nranks):
        bundle = aggregate.make_bundle(
            rank, [s for s in spans if s["attrs"].get("rank") == rank],
            aggregate.events_to_rows(events[events["rank"] == rank]),
            clock={"offset_ns": clockmap.offset_ns[rank],
                   "uncertainty_ns": clockmap.uncertainty_ns[rank],
                   "applied": False})
        atomic_write_json(os.path.join(dump_dir, f"obsdump-{rank}.json"),
                          bundle, indent=1)
    return clockmap


def _drill_live_straggler(nranks: int, straggler: int, steps: int,
                          delay_ms: float, workdir: str) -> Dict[str, Any]:
    """The live aggregation path: the chaos-stalled collective workload,
    the detector's verdicts folded into one rank's registry, one HTTP
    endpoint per simulated rank, and the aggregator naming the straggler
    from the ``tmpi_rank_skew_attributed_seconds`` gauges it reads over
    HTTP, with the federation document's families emitted once."""
    from . import aggregate, cluster, metrics, serve

    dump_dir = os.path.join(workdir, "live_dumps")
    os.makedirs(dump_dir, exist_ok=True)
    _drill_straggler(nranks, straggler, steps, delay_ms, dump_dir)
    records = aggregate.collective_skew(aggregate.load_obsdumps(dump_dir))
    regs = [metrics.Registry() for _ in range(nranks)]
    aggregate.fold_skew_into_registry(records, registry=regs[0])
    for r in range(nranks):
        regs[r].counter("tmpi_engine_steps_total",
                        "engine steps completed by this process").inc(steps)
    servers = [serve.ObsHTTPServer(registry=regs[r],
                                   health=serve.HealthState(),
                                   scrape=False, rank=r)
               for r in range(nranks)]
    try:
        results = cluster.fetch([s.url for s in servers], timeout_s=2.0)
        view = cluster.job_view(results)
        fed = cluster.federate({r: results[r].get("metrics_text", "")
                                for r in range(nranks)})
    finally:
        for s in servers:
            s.close()
    return {
        "nranks": nranks,
        "steps": steps,
        "injected_rank": straggler,
        "injected_delay_ms": delay_ms,
        "detected_rank": view["straggler"],
        "detected_ok": view["straggler"] == straggler,
        "skew_attributed_s": view["skew_attributed_s"],
        "job_verdict": view["verdict"],
        "federation_type_lines_once": fed.count(
            "# TYPE tmpi_rank_skew_attributed_seconds gauge") == 1,
    }


def _drill_live_healthz(wd_timeout: float) -> Dict[str, Any]:
    """A wedged step must flip ``/healthz`` to ``stalled`` before the
    in-process watchdog would expire: register a watchdog-derived
    threshold set, beat briefly, stop, and poll until the verdict
    lands."""
    from . import cluster, serve

    hs = serve.HealthState()
    hs.register_watchdog(wd_timeout)
    srv = serve.ObsHTTPServer(health=hs, scrape=False)
    states_seen: List[str] = []
    t_stall = None
    try:
        for _ in range(4):
            hs.note("watchdog")
            time.sleep(0.05)
        t_wedge = time.monotonic()
        while time.monotonic() - t_wedge < wd_timeout + 2:
            h = json.loads(cluster._get(srv.url + "/healthz", 2.0))
            if not states_seen or states_seen[-1] != h["state"]:
                states_seen.append(h["state"])
            if h["state"] == "stalled":
                t_stall = time.monotonic() - t_wedge
                break
            time.sleep(wd_timeout / 40)
    finally:
        srv.close()
    return {
        "watchdog_timeout_s": wd_timeout,
        "states_seen": states_seen,
        "stalled_after_s": round(t_stall, 3) if t_stall is not None else None,
        "before_watchdog_expiry": (t_stall is not None
                                   and t_stall < wd_timeout),
    }


_LIVE_WORKER = '''\
import sys, time
sys.path.insert(0, {repo!r})
from torchmpi_tpu_torch.runtime import config, failure
from torchmpi_tpu_torch.obs import serve
port, wd_timeout, beat_s = (int(sys.argv[1]), float(sys.argv[2]),
                            float(sys.argv[3]))
config.set("obs_http", True)
config.set("obs_http_port", port)
serve.maybe_start()
wd = failure.Watchdog(wd_timeout)          # the real watchdog: it exits
t0 = time.monotonic()                      # 44 if nobody converts first
while time.monotonic() - t0 < beat_s:
    wd.kick()
    time.sleep(0.1)
print("WEDGE_T=%.3f" % time.time(), flush=True)
time.sleep(3600)                           # the wedge
'''


def _drill_live_conversion(workdir: str, wd_timeout: float,
                           poll_s: float = 0.5) -> Dict[str, Any]:
    """A live wedge converted from outside: a worker process serves its
    endpoint, beats its real watchdog, then wedges; the drill polls its
    ``/healthz`` as a supervisor would and kills it on ``stalled``, which
    must come before the worker's own watchdog expires (the endpoint
    flips at half the watchdog's budget)."""
    import signal

    from . import cluster
    from ..collectives.hostcomm import free_ports

    port = free_ports(1)[0]
    worker = os.path.join(workdir, "live_worker.py")
    with open(worker, "w") as f:
        f.write(_LIVE_WORKER.format(repo=_REPO))
    proc = subprocess.Popen(
        [sys.executable, worker, str(port), str(wd_timeout), "1.0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    lines: List[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    url = f"http://127.0.0.1:{port}"
    converted, t_end = False, None
    deadline = time.monotonic() + wd_timeout + 120
    try:
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                state = json.loads(cluster._get(url + "/healthz",
                                                poll_s))["state"]
            except Exception:  # noqa: BLE001 - not up yet, or gone
                state = None
            if state == "stalled":
                proc.send_signal(signal.SIGTERM)
                t_end = time.time()
                converted = True
                break
            time.sleep(poll_s)
        try:
            rc = proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
    m = re.search(r"WEDGE_T=([0-9.]+)", "".join(lines))
    convert_s = (round(t_end - float(m.group(1)), 3)
                 if m and t_end is not None else None)
    return {
        "watchdog_timeout_s": wd_timeout,
        "converted": converted,
        "watchdog_expired": rc == 44,
        "convert_s": convert_s,
        "before_watchdog_expiry": (converted and rc != 44
                                   and convert_s is not None
                                   and convert_s < wd_timeout),
        "worker_rc": rc,
    }


def _wait_http(url: str, timeout_s: float = 180) -> bool:
    from . import cluster

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            cluster._get(url + "/healthz", 1.0)
            return True
        except Exception:  # noqa: BLE001 - not up yet
            time.sleep(0.2)
    return False


def _drill_live_federation(timeout_s: float = 1.0) -> Dict[str, Any]:
    """Federation survival: two live in-process endpoints, one real
    subprocess endpoint that gets SIGKILLed, and one accepted-but-silent
    socket (connect succeeds, bytes never come).  The sweep must mark both
    sick ranks ``unreachable``, degrade the job verdict and return inside
    the bound."""
    import signal
    import socket

    from . import cluster, metrics, serve
    from ..collectives.hostcomm import free_ports

    regs = [metrics.Registry() for _ in range(2)]
    for reg in regs:
        reg.counter("tmpi_engine_steps_total",
                    "engine steps completed by this process").inc(5)
    servers = [serve.ObsHTTPServer(registry=regs[r],
                                   health=serve.HealthState(),
                                   scrape=False, rank=r) for r in range(2)]
    port = free_ports(1)[0]
    sub = subprocess.Popen(
        [sys.executable, "-m", "torchmpi_tpu_torch.obs", "serve",
         "--port", str(port)], cwd=_REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    sub_url = f"http://127.0.0.1:{port}"
    silent = socket.socket()
    out: Dict[str, Any] = {"subprocess_up": False}
    try:
        out["subprocess_up"] = _wait_http(sub_url)
        silent.bind(("127.0.0.1", 0))
        silent.listen(1)   # the kernel's backlog accepts; nobody answers
        silent_url = f"http://127.0.0.1:{silent.getsockname()[1]}"
        eps = [servers[0].url, servers[1].url, sub_url]
        pre = cluster.job_view(cluster.fetch(eps, timeout_s=timeout_s))
        os.kill(sub.pid, signal.SIGKILL)
        sub.wait(timeout=30)
        t0 = time.monotonic()
        results = cluster.fetch(eps + [silent_url], timeout_s=timeout_s)
        elapsed = time.monotonic() - t0
        view = cluster.job_view(results)
        out.update({
            "pre_kill_verdict": pre["verdict"],
            "post_kill_states": [r["state"] for r in view["ranks"]],
            "post_kill_verdict": view["verdict"],
            "sweep_s": round(elapsed, 3),
            # parallel probes: about one timeout plus the backstop's
            # slack, not nranks timeouts, and never a hang.
            "bounded": elapsed < timeout_s * 3 + 2,
            "sigkilled_unreachable": view["ranks"][2]["state"]
            == cluster.UNREACHABLE,
            "silent_unreachable": view["ranks"][3]["state"]
            == cluster.UNREACHABLE,
        })
    finally:
        for s in servers:
            s.close()
        silent.close()
        if sub.poll() is None:
            sub.kill()
            sub.wait(timeout=30)
    return out


def _overhead_ab_http(n: int, reps: int) -> Dict[str, Any]:
    """ms per host-ring allreduce with the live endpoint off against on
    and scraped (a thread fetching ``/metrics`` every 20 ms beside the
    collectives), in interleaved blocks, best of each."""
    import torch

    from . import cluster as _cluster
    from . import native as obs_native
    from . import serve, tracer

    out: Dict[str, Any] = {}
    samples: Dict[str, List[float]] = {"http_off": [], "http_on": []}
    block = 5
    comms = _ring(2)
    try:
        arrs = [torch.ones(n) for _ in range(2)]

        def leg(r):
            got = []
            for _ in range(block):
                t0 = time.perf_counter()
                comms[r].allreduce(arrs[r])
                got.append(time.perf_counter() - t0)
            return got

        for _ in range(max(1, reps // block)):
            for label in ("http_off", "http_on"):
                srv = scraper = None
                stop_ev = threading.Event()
                if label == "http_on":
                    srv = serve.ObsHTTPServer(health=serve.HealthState())

                    def scrape_loop(url=srv.url):
                        while not stop_ev.is_set():
                            try:
                                _cluster._get(url + "/metrics", 2.0)
                            except Exception:  # noqa: BLE001
                                pass
                            stop_ev.wait(0.02)

                    scraper = threading.Thread(target=scrape_loop,
                                               daemon=True)
                    scraper.start()
                try:
                    with ThreadPoolExecutor(2) as ex:
                        samples[label].extend(
                            list(ex.map(leg, range(2)))[0])
                finally:
                    if srv is not None:
                        stop_ev.set()
                        scraper.join(timeout=5)
                        srv.close()
    finally:
        for c in comms:
            c.close()
    obs_native.drain_events("hostcomm")
    tracer.drain()
    for label, got in samples.items():
        out[label + "_ms"] = round(min(got) * 1e3, 3)
        out[label + "_median_ms"] = _percentile_ms(got)
    out["delta_ms"] = round(out["http_on_ms"] - out["http_off_ms"], 3)
    return out


def run_live_drill(quick: bool = False, out_path: str = "",
                   workdir: str = "") -> Dict[str, Any]:
    """Live straggler naming over HTTP, /healthz stall detection inside
    the watchdog budget, the conversion of a live wedge, federation over a
    murdered rank, and the endpoint-on scrape-overhead guard: one
    OBSLIVE artifact."""
    import tempfile

    from . import native as obs_native
    from . import tracer
    from ..runtime import config

    workdir = workdir or tempfile.mkdtemp(prefix="tmpi_obslive_")
    nranks, straggler = 3, 1
    steps = 6 if quick else 10
    delay_ms = 15.0 if quick else 30.0
    overhead_n = 1 << 18 if quick else 1 << 22   # 1 MiB / 16 MiB f32
    overhead_reps = 10 if quick else 30
    wd_timeout = 4.0 if quick else 6.0

    config.reset(obs_trace=True, hc_io_deadline_ms=60000)
    obs_native.apply_config()
    tracer.drain()
    obs_native.drain_events("hostcomm")
    try:
        straggler_cell = _drill_live_straggler(nranks, straggler, steps,
                                               delay_ms, workdir)
        health_cell = _drill_live_healthz(wd_timeout)
        conversion_cell = _drill_live_conversion(workdir, wd_timeout=12.0)
        federation_cell = _drill_live_federation()
        overhead = _overhead_ab_http(overhead_n, overhead_reps)
    finally:
        config.reset()
        obs_native.apply_config()

    straggler_ok = (straggler_cell["detected_ok"]
                    and straggler_cell["federation_type_lines_once"])
    health_ok = health_cell["before_watchdog_expiry"]
    conversion_ok = conversion_cell["before_watchdog_expiry"]
    federation_ok = (federation_cell["subprocess_up"]
                     and federation_cell["bounded"]
                     and federation_cell["sigkilled_unreachable"]
                     and federation_cell["silent_unreachable"]
                     and federation_cell["post_kill_verdict"] == "degraded")
    # The bar: 2 ms of absolute noise on loopback, or 25% of the op,
    # whichever is looser on the machine at hand (JAX's).
    overhead_ok = (overhead["delta_ms"]
                   <= max(2.0, 0.25 * overhead["http_off_ms"]))
    verdict = ("PASS" if straggler_ok and health_ok and conversion_ok
               and federation_ok and overhead_ok else "FAIL")
    artifact = {
        "artifact": "OBSLIVE",
        "script": "python -m torchmpi_tpu_torch.obs drill --live",
        "quick": bool(quick),
        "verdict": verdict,
        "straggler_cell": straggler_cell,
        "healthz_cell": health_cell,
        "conversion_cell": conversion_cell,
        "federation_cell": federation_cell,
        "overhead_16MiB_allreduce" if not quick else
        "overhead_1MiB_allreduce": overhead,
    }
    _write(out_path, artifact)
    return artifact


# --------------------------------------------------------- numerics drill

# The checks that this drill and the card's (``tools/numerics_drill.py``)
# share, each in one place.

def healthz(url: str, timeout_s: float = 5.0):
    """``(status, verdict document)`` of ``url``'s ``/healthz``, read for
    an error status too (503 carries the verdict in its body)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/healthz",
                                    timeout=timeout_s) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def flight_evidence(path: Optional[str]) -> Dict[str, Any]:
    """What a divergence's flight bundle at ``path`` holds."""
    cell: Dict[str, Any] = {"bundle": path, "parseable": False}
    if path and os.path.exists(path):
        with open(path) as f:
            b = json.load(f)
        ctx = b.get("context", {})
        cell.update({
            "parseable": b.get("schema") == "tmpi-flight-v1",
            "reason": b.get("reason"),
            "first_divergent_leaf": ctx.get("first_divergent_leaf"),
            "has_per_rank_digests": bool(ctx.get("leaf_digests_by_rank")),
            "has_sentinel_history": "sentinel_history" in ctx,
            "has_numerics_snapshot": "numerics" in b,
        })
    return cell


def _equal_bits(a, b) -> bool:
    """Whether two tensors hold the same bits."""
    import torch

    words = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(
        a.view(words.get(a.dtype, a.dtype)), b.view(words.get(b.dtype,
                                                               b.dtype)))


def off_against_on(run, batches, mode: str) -> Dict[str, Any]:
    """``run(mode, batches)`` trains from one start and returns ``(final
    parameter tensors, record)``: ``"off"`` and ``mode`` must end bit for
    bit alike (the sentinels only observe).  Returns both records."""
    from . import numerics

    numerics.reset()
    p_off, off = run("off", batches)
    numerics.reset()
    p_on, on = run(mode, batches)
    return {"off": off, "on": on,
            "off_bit_identical": len(p_off) == len(p_on) and all(
                _equal_bits(a, b) for a, b in zip(p_off, p_on))}


def nan_step(run, batches, step: int, rank: int, mode: str
             ) -> Dict[str, Any]:
    """``run`` (as for :func:`off_against_on`) in ``mode`` over
    rank-major ``batches`` with a NaN in rank ``rank``'s first row of
    step ``step``'s batch: the sentinels must flag that step, and
    ``tmpi_numerics_nonfinite_total`` must move."""
    from . import metrics, numerics

    dirty = [(x.copy(), y.copy()) for x, y in batches]
    dirty[step][0][(rank, 0) + (0,) * (dirty[step][0].ndim - 2)] = \
        float("nan")

    def nonfinite_total() -> float:
        name = "tmpi_numerics_nonfinite_total"
        return (metrics.registry.counter(name).value()
                if name in metrics.registry.to_prometheus() else 0.0)

    before = nonfinite_total()
    numerics.reset()
    _, rec = run(mode, dirty)
    history = numerics.history()
    flagged = [r["step"] for r in history if r["nonfinite"] > 0]
    return {"nan_injected_at_step": step, "nan_rank": rank, "record": rec,
            "nonfinite_by_step": {r["step"]: r["nonfinite"]
                                  for r in history},
            "first_flagged_step": flagged[0] if flagged else None,
            "flagged_steps": flagged,
            "caught_within_one_step": bool(flagged) and flagged[0] == step,
            "nonfinite_total_moved": nonfinite_total() > before}


def _drill_numerics_corruption(workdir: str, quick: bool) -> Dict[str, Any]:
    """The silent-corruption negative control, answered: a 2-rank host
    ring whose rank 0 -> rank 1 hop crosses a chaos proxy flipping one
    byte with ``hc_frame_crc`` off.  Rank 1's replica forks; the auditor
    must detect it from 16-byte allgathers, name the first divergent leaf,
    name the corrupted rank by vote (the drill's clean replay joins as the
    tie-breaking voter), set the outlier's /healthz to ``diverged`` (503)
    and leave a flight bundle with the evidence; a clean audit after must
    clear the state."""
    import numpy as np
    import torch

    from . import flight, metrics, numerics, serve
    from ..collectives.hostcomm import free_ports
    from ..runtime import chaos, config

    config.set("obs_flight", True)
    config.set("obs_flight_dir", os.path.join(workdir, "numerics_flight"))
    config.set("hc_frame_crc", False)      # the negative control, explicit
    config.set("hc_io_deadline_ms", _RING_MS)

    # Several named leaves, so "first divergent leaf" is a real search;
    # sizes put the corrupt byte mid-payload of leaf index 2 with about
    # 2 KiB of slack for frame headers and the wiring handshake.
    rng = np.random.default_rng(12)
    base = {
        "emb/w": rng.standard_normal(2048).astype(np.float32),
        "emb/b": rng.standard_normal(256).astype(np.float32),
        "blk0/w": rng.standard_normal(1024).astype(np.float32),
        "blk0/b": rng.standard_normal(256).astype(np.float32),
        "head/w": rng.standard_normal(512).astype(np.float32),
    }
    keys = list(base)
    n_steps = 2
    deltas = [{k: rng.standard_normal(base[k].size).astype(np.float32) * 0.01
               for k in keys} for _ in range(n_steps)]
    corrupt_at = (2048 + 256) * 4 + 2048

    eps = [("127.0.0.1", p) for p in free_ports(2)]
    px = chaos.ChaosProxy(eps[1], chaos.FaultSpec(corrupt_at_byte=corrupt_at),
                          seed=9)
    comms = []
    try:
        comms = _ring(2, endpoints=eps,
                      connect_to={0: [eps[0], px.endpoint]})

        def work(r):
            cur = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
            for step in range(n_steps):
                for k in keys:
                    buf = torch.from_numpy(deltas[step][k].copy())
                    comms[r].broadcast(buf, root=0)
                    cur[k] += buf
            return cur

        with ThreadPoolExecutor(2) as ex:
            trees = list(ex.map(work, range(2)))

        # Ground truth: the deltas applied in the ranks' own order (float
        # addition is not associative).
        reference = {k: torch.from_numpy(base[k].copy()) for k in keys}
        for d in deltas:
            for k in keys:
                reference[k] += torch.from_numpy(d[k])
        divergent = {r: [k for k in keys
                         if not torch.equal(trees[r][k], reference[k])]
                     for r in range(2)}
        corrupted_rank = next((r for r in range(2) if divergent[r]), None)
        expected_first = (divergent[corrupted_rank][0]
                          if corrupted_rank is not None else None)

        regs = [metrics.Registry() for _ in range(2)]
        healths = [serve.HealthState(error_window_s=0.5) for _ in range(2)]
        auditors = [numerics.Auditor(comms[r], health=healths[r],
                                     registry=regs[r]) for r in range(2)]
        # Baseline the watched counters, so that movement reads on the
        # rank that is not the outlier too.
        for r in range(2):
            healths[r].evaluate(regs[r])
        ref_digests = numerics.leaf_digests(reference)
        with ThreadPoolExecutor(2) as ex:
            results = list(ex.map(
                lambda r: auditors[r].audit(trees[r], step=n_steps,
                                            reference=ref_digests),
                range(2)))

        servers = [serve.ObsHTTPServer(registry=regs[r], health=healths[r],
                                       scrape=False, rank=r)
                   for r in range(2)]
        try:
            health_rows = []
            for r in range(2):
                code, doc = healthz(servers[r].url)
                health_rows.append({"rank": r, "code": code,
                                    "state": doc["state"],
                                    "reasons": [c["code"]
                                                for c in doc["reasons"]]})
            # Recovery: every replica back on the reference.
            with ThreadPoolExecutor(2) as ex:
                rec = list(ex.map(
                    lambda r: auditors[r].audit(
                        {k: v.clone() for k, v in reference.items()},
                        step=n_steps + 1),
                    range(2)))
            time.sleep(0.6)    # let the counter-movement window lapse
            recovered = [healthz(servers[r].url)[1]["state"]
                         for r in range(2)]
        finally:
            for s in servers:
                s.close()

        flight_cell = flight_evidence(flight.last_dump_path())

        res = results[0]
        outlier = (health_rows[corrupted_rank]
                   if corrupted_rank is not None else {})
        return {
            "n_steps": n_steps,
            "corrupt_at_byte": corrupt_at,
            "hc_frame_crc": False,
            "empirical_corrupted_rank": corrupted_rank,
            "empirical_divergent_leaves": divergent,
            "detected": not res.ok,
            "first_divergent_leaf": res.first_divergent_leaf,
            "first_leaf_named_ok": (
                expected_first is not None
                and res.first_divergent_leaf is not None
                and expected_first in res.first_divergent_leaf),
            "outlier_ranks": res.outlier_ranks,
            "corrupted_rank_named": (corrupted_rank is not None
                                     and res.outlier_ranks
                                     == [corrupted_rank]),
            "results_identical_on_all_ranks": (
                {**results[0].to_dict(), "rank": None, "tree_digest": None}
                == {**results[1].to_dict(), "rank": None,
                    "tree_digest": None}),
            "digest_exchanges": res.exchanges,
            "divergence_total": [
                regs[r].counter("tmpi_numerics_divergence_total").value()
                for r in range(2)],
            "healthz": health_rows,
            "healthz_503_on_affected_rank": (
                (outlier.get("code"), outlier.get("state"))
                == (503, "diverged")),
            "recovered_ok": (all(r.ok for r in rec)
                             and all(s == "healthy" for s in recovered)),
            "recovered_states": recovered,
            "flight": flight_cell,
        }
    finally:
        for c in comms:
            c.close()
        px.close()


def _toy_engine_inputs(p: int, width: int, n: int, seed: int):
    """A tanh MLP's loss, parameters and ``n`` rank-major batches."""
    import numpy as np
    import torch

    def loss_fn(params, batch):
        x, y = batch
        pred = torch.tanh(x @ params["w0"]) @ params["w1"]
        return torch.mean((pred[:, 0] - y) ** 2)

    prng = np.random.default_rng(seed)
    params = {"w0": prng.standard_normal((width, 16)).astype(np.float32)
              * 0.1,
              "w1": prng.standard_normal((16, 1)).astype(np.float32) * 0.1}
    rng = np.random.default_rng(seed + 1)
    batches = [(rng.standard_normal((p, 4, width)).astype(np.float32),
                rng.standard_normal((p, 4)).astype(np.float32))
               for _ in range(n)]
    return loss_fn, params, batches


def _started_comm(device):
    """The current communicator and device, starting the runtime on
    ``device`` if nothing has."""
    from ..runtime import communicator, lifecycle

    dev = (lifecycle.device() if lifecycle.started()
           else lifecycle.start(device))
    return communicator.stack.current(), dev


def _drill_numerics_sentinel(quick: bool, device) -> Dict[str, Any]:
    """A compiled-engine run with a NaN in one step's batch: the in-step
    sentinels must flag that step; and the ``off`` run trains to the same
    parameters bit for bit as ``sentinel`` (the sentinels only observe)."""
    import torch

    from ..engine import AllReduceSGDEngine
    from ..runtime import config

    comm, dev = _started_comm(device)
    n_batches, inject_at = (5, 3) if quick else (8, 5)
    loss_fn, params0, clean = _toy_engine_inputs(comm.size, 8, n_batches, 3)

    def run(mode, batches):
        config.set("numerics_mode", mode)
        e = AllReduceSGDEngine(loss_fn, lr=0.05, comm=comm, mode="compiled")
        out = e.train({k: torch.from_numpy(v.copy()).to(dev)
                       for k, v in params0.items()}, list(batches))["params"]
        return [out[k].detach().cpu() for k in sorted(out)], None

    prior_mode = str(config.get("numerics_mode"))
    try:
        pinned = off_against_on(run, clean, "sentinel")
        nan = nan_step(run, clean, inject_at, 0, "sentinel")
    finally:
        config.set("numerics_mode", prior_mode)
    return {
        "batches": n_batches,
        **{k: nan[k] for k in ("nan_injected_at_step", "first_flagged_step",
                               "flagged_steps", "caught_within_one_step",
                               "nonfinite_total_moved")},
        "off_bit_identical": pinned["off_bit_identical"],
    }


def _drill_numerics_overhead(quick: bool, device) -> Dict[str, Any]:
    """Sentinel on against off engine step time (interleaved rounds, best
    of each) and the audit's digest cost."""
    import torch

    from . import numerics
    from ..engine import AllReduceSGDEngine
    from ..runtime import config

    comm, dev = _started_comm(device)
    n = 8 if quick else 20
    rounds = 2 if quick else 3
    loss_fn, params0, batches = _toy_engine_inputs(comm.size, 64, n, 5)
    params0 = {k: torch.from_numpy(v).to(dev) for k, v in params0.items()}
    engine = AllReduceSGDEngine(loss_fn, lr=0.01, comm=comm, mode="compiled")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prior_mode = str(config.get("numerics_mode"))
    samples: Dict[str, List[float]] = {"off": [], "sentinel": []}
    try:
        for _ in range(rounds):
            for mode in ("off", "sentinel"):
                config.set("numerics_mode", mode)
                st = engine.train({k: v.clone() for k, v in params0.items()},
                                  batches[:2])
                sync()
                t0 = time.perf_counter()
                st = engine.train(st["params"], batches)
                float(st["loss"])
                samples[mode].append((time.perf_counter() - t0) / n)
    finally:
        config.set("numerics_mode", prior_mode)
    t0 = time.perf_counter()
    numerics.fold_digests(numerics.leaf_digests(params0)[1])
    audit_ms = (time.perf_counter() - t0) * 1e3
    interval = int(config.get("numerics_audit_interval"))
    off_ms = round(min(samples["off"]) * 1e3, 3)
    on_ms = round(min(samples["sentinel"]) * 1e3, 3)
    return {
        "device": str(dev),
        "sentinel_off_ms": off_ms,
        "sentinel_on_ms": on_ms,
        "sentinel_overhead_ms": round(on_ms - off_ms, 3),
        "steps_per_sample": n,
        "audit_ms": round(audit_ms, 3),
        "audit_interval": interval,
        "audit_amortized_ms": round(audit_ms / max(interval, 1), 4),
    }


def run_numerics_drill(quick: bool = False, out_path: str = "",
                       workdir: str = "", device=None) -> Dict[str, Any]:
    """The auditor against the chaos proxy's silent one-byte corruption
    (crc off), the in-step sentinels against an injected NaN, the off-mode
    bit-for-bit pin, the diverged /healthz state over HTTP, the flight
    evidence and the sentinel overhead: one NUMERICS artifact.  The engine
    legs run on ``device`` (the card unless ``"cpu"``)."""
    import tempfile

    from . import native as obs_native
    from . import numerics, tracer
    from ..runtime import config, lifecycle

    workdir = workdir or tempfile.mkdtemp(prefix="tmpi_numerics_")
    config.reset()
    obs_native.apply_config()
    numerics.reset()
    tracer.drain()
    owned = not lifecycle.started()
    try:
        _started_comm(device)       # no card and no device: raises here
        corruption_cell = _drill_numerics_corruption(workdir, quick)
        sentinel_cell = _drill_numerics_sentinel(quick, device)
        overhead = _drill_numerics_overhead(quick, device)
    finally:
        if owned and lifecycle.started():
            lifecycle.stop()
        config.reset()
        obs_native.apply_config()

    corruption_ok = (corruption_cell["detected"]
                     and corruption_cell["first_leaf_named_ok"]
                     and corruption_cell["corrupted_rank_named"]
                     and corruption_cell["healthz_503_on_affected_rank"]
                     and corruption_cell["recovered_ok"]
                     and corruption_cell["flight"]["parseable"]
                     and corruption_cell["flight"]["has_per_rank_digests"])
    sentinel_ok = (sentinel_cell["caught_within_one_step"]
                   and sentinel_cell["nonfinite_total_moved"]
                   and sentinel_cell["off_bit_identical"])
    artifact = {
        "artifact": "NUMERICS",
        "script": "python -m torchmpi_tpu_torch.obs drill --numerics",
        "quick": bool(quick),
        "verdict": "PASS" if corruption_ok and sentinel_ok else "FAIL",
        "corruption_cell": corruption_cell,
        "sentinel_cell": sentinel_cell,
        "numerics": overhead,
        "workdir": workdir,
    }
    _write(out_path, artifact)
    return artifact


# ------------------------------------------------------------------- CLI

def _endpoints(raw: str) -> List[str]:
    return [e.strip() for e in raw.split(",") if e.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.obs",
        description="torchmpi_tpu_torch observability: snapshot / drill / "
                    "merge")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("snapshot", help="scrape native counters and print "
                        "the metrics registry")
    sp.add_argument("--prom", action="store_true",
                    help="Prometheus text instead of JSON")

    dp = sub.add_parser("drill", help="instrumented fault drill -> "
                        "artifact (--numerics or --live)")
    dp.add_argument("--quick", action="store_true")
    dp.add_argument("--cluster", action="store_true",
                    help="the CLUSTER drill (ROADMAP.md item 20)")
    dp.add_argument("--live", action="store_true",
                    help="the live-plane drill (endpoint aggregation, "
                    "/healthz stall conversion, federation survival, "
                    "scrape overhead) -> OBSLIVE artifact")
    dp.add_argument("--numerics", action="store_true",
                    help="the NUMERICS drill (silent-corruption audit, NaN "
                    "sentinel, diverged /healthz, flight evidence, "
                    "sentinel overhead) -> NUMERICS artifact")
    dp.add_argument("--rca", action="store_true",
                    help="the RCA drill (ROADMAP.md item 20)")
    dp.add_argument("--alerts", action="store_true",
                    help="the ALERTS drill (ROADMAP.md item 20)")
    dp.add_argument("--out", default=None)
    dp.add_argument("--live-out", default=None,
                    help="OBSLIVE artifact path (with --live)")
    dp.add_argument("--trace-out", default=None)
    dp.add_argument("--workdir", default="",
                    help="drill scratch dir (default: a tempdir)")
    dp.add_argument("--device", default=None,
                    help="where the engine legs run: the card by default, "
                         "'cpu' on request")

    mp = sub.add_parser("merge", help="offline merge: spans json + events "
                        "npy (EVENT_DTYPE) [+ a torch.profiler Chrome "
                        "trace] -> Chrome trace")
    mp.add_argument("spans")
    mp.add_argument("events")
    mp.add_argument("out")
    mp.add_argument("--device-trace", default=None)

    mr = sub.add_parser("merge-ranks", help="N obsdump-<rank>.json bundles "
                        "-> ONE clock-aligned multi-rank Chrome trace with "
                        "cross-rank flow arrows")
    mr.add_argument("dir")
    mr.add_argument("out")

    du = sub.add_parser("dump", help="write this process's obsdump bundle "
                        "(drains spans + ring tails) into DIR")
    du.add_argument("dir")
    du.add_argument("--rank", type=int, default=0)

    rp = sub.add_parser("report", help="straggler/skew report over the "
                        "obsdump bundles in DIR")
    rp.add_argument("dir")
    rp.add_argument("--top", type=int, default=10)
    rp.add_argument("--json", action="store_true", dest="as_json")

    tp = sub.add_parser("top", help="refreshing job-level table federated "
                        "from live per-rank obs endpoints")
    tp.add_argument("--endpoints", default="",
                    help="comma-separated base URLs (http://host:port), "
                         "rank order")
    tp.add_argument("--ring", default="",
                    help="comma-separated host-ring host:port endpoint "
                         "list; obs endpoints derive as --http-port + "
                         "rank*--stride on each host")
    tp.add_argument("--http-port", type=int, default=8780,
                    help="obs HTTP base port for --ring")
    tp.add_argument("--stride", type=int, default=1,
                    help="port stride per rank for --ring (0 = one port "
                         "per host)")
    tp.add_argument("--interval", type=float, default=2.0)
    tp.add_argument("--timeout", type=float, default=2.0,
                    help="per-rank probe bound (a dead rank shows "
                         "unreachable after this, never hangs the sweep)")
    tp.add_argument("--once", action="store_true",
                    help="one sweep, no refresh loop")
    tp.add_argument("--iterations", type=int, default=None)
    tp.add_argument("--json", action="store_true", dest="as_json",
                    help="print the final job view as JSON")
    tp.add_argument("--federate", metavar="OUT", default=None,
                    help="also write the merged /metrics federation "
                         "document to OUT ('-' = stdout)")

    wy = sub.add_parser("why", help="root-cause analysis over an evidence "
                        "directory (journal segments + flight bundles + "
                        "metrics history): a ranked verdict with its "
                        "evidence chain")
    wy.add_argument("dir")
    wy.add_argument("--top", type=int, default=5)
    wy.add_argument("--json", action="store_true", dest="as_json")

    jn = sub.add_parser("journal", help="federated journal tail over live "
                        "per-rank obs endpoints (GET /journal)")
    jn.add_argument("--endpoints", required=True,
                    help="comma-separated base URLs, rank order")
    jn.add_argument("--limit", type=int, default=64)
    jn.add_argument("--timeout", type=float, default=2.0)

    al = sub.add_parser("alerts", help="federated alert view over live "
                        "per-rank obs endpoints (GET /alerts); exit 1 when "
                        "anything is firing")
    al.add_argument("--endpoints", required=True,
                    help="comma-separated base URLs, rank order")
    al.add_argument("--timeout", type=float, default=2.0)
    al.add_argument("--json", action="store_true", dest="as_json")

    sv = sub.add_parser("serve", help="standalone live obs endpoint for "
                        "this process (a training rank starts its own via "
                        "the obs_http knob)")
    sv.add_argument("--port", type=int, default=0)
    sv.add_argument("--bind", default="127.0.0.1")

    args = ap.parse_args(argv)

    if args.cmd == "snapshot":
        from . import metrics

        metrics.registry.scrape_native()
        print(metrics.registry.to_prometheus() if args.prom
              else metrics.registry.to_json())
        return 0

    if args.cmd == "merge":
        import numpy as np

        from . import export

        with open(args.spans) as f:
            spans = json.load(f)
        events = np.load(args.events)
        export.save(args.out,
                    export.chrome_trace(spans, events, args.device_trace))
        print(json.dumps({"out": args.out, "spans": len(spans),
                          "events": int(events.shape[0])}))
        return 0

    if args.cmd in ("merge-ranks", "report"):
        from . import aggregate, export

        dumps = aggregate.load_obsdumps(args.dir)
        if not dumps:
            print(f"no obsdump-*.json bundles in {args.dir}",
                  file=sys.stderr)
            return 1
        if args.cmd == "report":
            report = aggregate.skew_report(dumps, top=args.top)
            print(json.dumps(report, indent=1) if args.as_json
                  else aggregate.format_report(report))
            return 0
        trace = export.merge_ranks(dumps)
        export.save(args.out, trace)
        print(json.dumps({"out": args.out, "ranks": len(dumps),
                          "flow_join": export.flow_join_report(trace)}))
        return 0

    if args.cmd == "dump":
        from . import aggregate

        path = aggregate.write_obsdump(args.dir, rank=args.rank)
        print(json.dumps({"out": path}))
        return 0

    if args.cmd == "top":
        from . import cluster

        if args.endpoints:
            eps = _endpoints(args.endpoints)
        elif args.ring:
            ring = []
            for entry in _endpoints(args.ring):
                host, _, port = entry.partition(":")
                if not host or not port.isdigit():
                    print(f"--ring entry {entry!r} is not host:port",
                          file=sys.stderr)
                    return 2
                ring.append((host, int(port)))
            eps = cluster.endpoints_from_ring(ring, args.http_port,
                                              stride=args.stride)
        else:
            print("need --endpoints or --ring", file=sys.stderr)
            return 2
        iterations = 1 if args.once else args.iterations
        last: Dict[str, Any] = {}
        view = cluster.top(eps, interval_s=args.interval,
                           iterations=iterations, timeout_s=args.timeout,
                           clear=not (args.once or args.as_json),
                           sink=lambda v, results: last.update(r=results))
        if args.federate is not None:
            # From the same final sweep the table rendered.
            texts = {r: res.get("metrics_text", "")
                     for r, res in enumerate(last.get("r", []))}
            doc = cluster.federate(texts)
            if args.federate == "-":
                print(doc)
            else:
                with open(args.federate, "w") as f:
                    f.write(doc)
        if args.as_json:
            print(json.dumps(view, indent=1))
        return 0 if view.get("verdict") != "stalled" else 1

    if args.cmd == "why":
        from . import rca

        report = rca.analyze(args.dir, top=args.top)
        print(json.dumps(report, indent=1) if args.as_json
              else rca.format_report(report))
        return 0 if report["verdicts"] else 1

    if args.cmd == "journal":
        from . import cluster

        eps = _endpoints(args.endpoints)
        if not eps:
            print("need --endpoints", file=sys.stderr)
            return 2
        print(json.dumps(cluster.fetch_journal(
            eps, limit=args.limit, timeout_s=args.timeout), indent=1))
        return 0

    if args.cmd == "alerts":
        from . import cluster

        eps = _endpoints(args.endpoints)
        if not eps:
            print("need --endpoints", file=sys.stderr)
            return 2
        doc = cluster.fetch_alerts(eps, timeout_s=args.timeout)
        if args.as_json:
            print(json.dumps(doc, indent=1))
        else:
            lines = [f"{'rank':>4} {'reach':<6} {'enabled':<8} "
                     f"{'rules':>5} {'firing':>6}"]
            for r in doc["ranks"]:
                lines.append(
                    f"{r['rank']:>4} {str(r['reachable']):<6} "
                    f"{str(r['enabled']):<8} {r['rules']:>5} "
                    f"{r['firing']:>6}"
                    + (f"  {r['error']}" if r.get("error") else ""))
            for al_ in doc["firing"]:
                ann = al_.get("annotation") or {}
                lines.append(
                    f"  r{al_['rank']} {al_['severity']:<8} "
                    f"{al_['name']}"
                    + (f" [phase {al_['phase']}]" if al_.get("phase")
                       else "")
                    + (f" — {ann['summary']}" if ann.get("summary")
                       else ""))
            if not doc["firing"]:
                lines.append("  (nothing firing)")
            print("\n".join(lines))
        return 1 if doc["firing"] else 0

    if args.cmd == "serve":
        import signal as _signal

        from . import serve as serve_mod

        srv = serve_mod.ObsHTTPServer(bind=args.bind, port=args.port)
        print(json.dumps({"url": srv.url, "pid": os.getpid()}), flush=True)
        ev = threading.Event()
        _signal.signal(_signal.SIGTERM, lambda *_: ev.set())
        _signal.signal(_signal.SIGINT, lambda *_: ev.set())
        while not ev.wait(0.2):
            pass
        srv.close()
        return 0

    # drill
    for flag in ("alerts", "rca", "cluster"):
        if getattr(args, flag):
            _not_ported(f"--{flag}")
    if not (args.numerics or args.live):
        _not_ported("(the base drill)")
    workdir = args.workdir
    if not workdir:
        import tempfile

        workdir = tempfile.mkdtemp(prefix="tmpi_drill_")
    if args.numerics:
        out = args.out or os.path.join(workdir, "NUMERICS.json")
        artifact = run_numerics_drill(quick=args.quick, out_path=out,
                                      workdir=workdir, device=args.device)
        print(json.dumps({k: artifact[k] for k in
                          ("verdict", "corruption_cell", "sentinel_cell",
                           "numerics")}, default=str), flush=True)
    else:
        out = args.live_out or args.out or os.path.join(workdir,
                                                        "OBSLIVE.json")
        artifact = run_live_drill(quick=args.quick, out_path=out,
                                  workdir=workdir)
        print(json.dumps({k: artifact[k] for k in
                          ("verdict", "straggler_cell", "healthz_cell",
                           "conversion_cell", "federation_cell")},
                         default=str), flush=True)
    print(json.dumps({"out": out}), flush=True)
    return 0 if artifact["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
