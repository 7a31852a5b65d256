"""The port's observability CLI (``python -m torchmpi_tpu_torch.obs``)
against the JAX package's (``tmpi-trace``) on the same evidence.

* ``report`` and ``merge-ranks`` over obsdump bundles that the port's
  straggler leg writes (three host-ring ranks, one delayed by
  ``runtime/chaos.py``): the same JSON report, the same ranks and flow
  join.
* ``why`` over a directory that holds the journals and flight bundle of a
  numerics divergence the port's auditor found: the same verdicts.
* ``top --once --json``, ``journal`` and ``alerts`` against live port
  endpoints; ``merge`` with ``--device-trace``; ``snapshot``.
* ``drill --numerics --quick --device cpu`` end to end in a subprocess
  (about 8 s): PASS, its artifact written; the drill modes the port has
  not yet raise ``DrillNotPorted`` naming item 20, and the numerics drill
  refuses to fall back to the CPU without ``--device cpu``.
* Three legs of ``drill --live``: the ``/healthz`` stall inside the
  watchdog budget, the conversion of a live wedge before the worker's own
  watchdog expires, federation over a SIGKILLed and a silent endpoint.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchmpi_tpu.obs import __main__ as jcli
from torchmpi_tpu.runtime import config as jconfig

from torchmpi_tpu_torch.obs import __main__ as tcli
from torchmpi_tpu_torch.obs import journal as tjournal
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import native as tnative
from torchmpi_tpu_torch.obs import numerics as tnumerics
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.obs import tracer as ttracer
from torchmpi_tpu_torch.runtime import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh():
    for c in (jconfig, tconfig):
        c.reset()
    yield
    for c in (jconfig, tconfig):
        c.reset()
    tnative.apply_config()
    tjournal.reset()
    tnumerics.reset()


def _run(main, argv, capsys):
    code = main(argv)
    return code, capsys.readouterr().out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Obsdump bundles of three host-ring ranks, rank 1 delayed."""
    d = tmp_path_factory.mktemp("dumps")
    tconfig.reset(obs_trace=True, hc_io_deadline_ms=20000)
    tnative.apply_config()
    ttracer.drain()
    tnative.drain_events("hostcomm")
    try:
        tcli._drill_straggler(3, 1, 6, 10.0, str(d))
    finally:
        tconfig.reset()
        tnative.apply_config()
    return d


def test_report_matches_jax(dumps, capsys):
    got = _run(tcli.main, ["report", str(dumps), "--json"], capsys)
    want = _run(jcli.main, ["report", str(dumps), "--json"], capsys)
    assert got == want and got[0] == 0
    assert json.loads(got[1])["straggler"] == 1
    text = _run(tcli.main, ["report", str(dumps)], capsys)
    assert text == _run(jcli.main, ["report", str(dumps)], capsys)


def test_merge_ranks_matches_jax(dumps, tmp_path, capsys):
    code, out = _run(tcli.main, ["merge-ranks", str(dumps),
                                 str(tmp_path / "t.json")], capsys)
    jcode, jout = _run(jcli.main, ["merge-ranks", str(dumps),
                                   str(tmp_path / "j.json")], capsys)
    got, want = json.loads(out), json.loads(jout)
    assert code == jcode == 0
    assert (got["ranks"], got["flow_join"]) == (want["ranks"],
                                                want["flow_join"])
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert tcli.main(["merge-ranks", str(tmp_path / "none"),
                      str(tmp_path / "x.json")]) == 1


def test_why_names_the_divergence_like_jax(tmp_path, capsys):
    from torchmpi_tpu_torch.collectives import hostcomm

    tconfig.set("journal_enabled", True)
    tconfig.set("journal_dir", str(tmp_path))
    tconfig.set("obs_flight", True)
    tconfig.set("obs_flight_dir", str(tmp_path))
    eps = [("127.0.0.1", p) for p in hostcomm.free_ports(2)]
    with ThreadPoolExecutor(2) as ex:
        comms = [f.result(timeout=60) for f in [
            ex.submit(hostcomm.HostCommunicator, r, 2, eps, 30000,
                      io_deadline_ms=20000) for r in range(2)]]
    try:
        base = {"w": torch.arange(8.0), "b": torch.ones(3)}
        forked = {"w": base["w"].clone(), "b": base["b"] + 1}
        auds = [tnumerics.Auditor(comms[r], health=tserve.HealthState(),
                                  registry=tmetrics.Registry())
                for r in range(2)]
        ref = tnumerics.leaf_digests(base)
        with ThreadPoolExecutor(2) as ex:
            res = list(ex.map(lambda r: auds[r].audit(
                [base, forked][r], step=12, reference=ref), range(2)))
        assert res[0].outlier_ranks == [1]
    finally:
        for c in comms:
            c.close()
    tjournal.reset()                      # flush and close the segment
    got = _run(tcli.main, ["why", str(tmp_path), "--json"], capsys)
    want = _run(jcli.main, ["why", str(tmp_path), "--json"], capsys)
    assert got[0] == want[0] == 0
    gv, wv = json.loads(got[1])["verdicts"], json.loads(want[1])["verdicts"]
    assert [v["cause"] for v in gv] == [v["cause"] for v in wv]
    assert gv[0]["cause"] == "silent data corruption"
    # The text report: the same below its title line (each names its CLI).
    text = _run(tcli.main, ["why", str(tmp_path)], capsys)[1]
    jtext = _run(jcli.main, ["why", str(tmp_path)], capsys)[1]
    assert text.splitlines()[1:] == jtext.splitlines()[1:]


def test_live_subcommands(capsys, tmp_path):
    reg = tmetrics.Registry()
    reg.counter("tmpi_engine_steps_total", "steps").inc(4)
    srv = tserve.ObsHTTPServer(registry=reg, health=tserve.HealthState(),
                               scrape=False)
    try:
        code, out = _run(tcli.main, ["top", "--endpoints", srv.url,
                                     "--once", "--json", "--federate",
                                     str(tmp_path / "fed.prom")], capsys)
        view = json.loads(out[out.index("\n{") + 1:])  # after the table
        assert code == 0 and view["verdict"] == "healthy"
        assert 'tmpi_engine_steps_total{rank="0"} 4' in (
            tmp_path / "fed.prom").read_text()
        code, out = _run(tcli.main, ["journal", "--endpoints", srv.url],
                         capsys)
        assert code == 0 and json.loads(out)["unreachable"] == []
        code, out = _run(tcli.main, ["alerts", "--endpoints", srv.url],
                         capsys)
        assert code == 0 and "(nothing firing)" in out
    finally:
        srv.close()
    assert tcli.main(["top"]) == 2
    assert tcli.main(["top", "--ring", "nohost"]) == 2
    code, out = _run(tcli.main, ["snapshot", "--prom"], capsys)
    assert code == 0


def test_merge_takes_a_device_trace(tmp_path, capsys):
    (tmp_path / "spans.json").write_text(json.dumps([{
        "name": "engine.step", "t0_ns": 1000, "t1_ns": 5000,
        "correlation": 7, "thread": 1, "attrs": {"step": 0}}]))
    np.save(tmp_path / "events.npy", np.zeros(0, tnative.EVENT_DTYPE))
    (tmp_path / "dev.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0,
         "dur": 3.0, "pid": 0, "tid": 7}]}))
    code, out = _run(tcli.main, [
        "merge", str(tmp_path / "spans.json"), str(tmp_path / "events.npy"),
        str(tmp_path / "out.json"), "--device-trace",
        str(tmp_path / "dev.json")], capsys)
    assert code == 0 and json.loads(out)["spans"] == 1
    names = [e.get("name") for e in json.loads(
        (tmp_path / "out.json").read_text())["traceEvents"]]
    assert "gemm" in names and "engine.step" in names


@pytest.mark.parametrize("flags", [[], ["--cluster"], ["--rca"],
                                   ["--alerts"]])
def test_drills_of_item_20_raise(flags):
    with pytest.raises(tcli.DrillNotPorted, match="item 20"):
        tcli.main(["drill", *flags])


def test_numerics_drill_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["drill", "--numerics", "--quick"])


def test_numerics_drill_quick_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.obs", "drill",
         "--numerics", "--quick", "--device", "cpu", "--workdir",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    head = json.loads(res.stdout.splitlines()[0])
    assert head["verdict"] == "PASS"
    art = json.loads((tmp_path / "NUMERICS.json").read_text())
    assert art["corruption_cell"]["outlier_ranks"] == [
        art["corruption_cell"]["empirical_corrupted_rank"]]
    assert art["sentinel_cell"]["off_bit_identical"]
    assert art["numerics"]["device"] == "cpu"


def test_live_drill_legs(tmp_path):
    health = tcli._drill_live_healthz(2.0)
    assert health["before_watchdog_expiry"], health
    conv = tcli._drill_live_conversion(str(tmp_path), wd_timeout=4.0,
                                       poll_s=0.25)
    assert conv["before_watchdog_expiry"], conv
    fed = tcli._drill_live_federation()
    assert fed["subprocess_up"] and fed["bounded"], fed
    assert fed["sigkilled_unreachable"] and fed["silent_unreachable"]
    assert fed["post_kill_verdict"] == "degraded"
