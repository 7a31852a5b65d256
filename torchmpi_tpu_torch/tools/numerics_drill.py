"""The numerics plane on config 1, end to end.

    python -m torchmpi_tpu_torch.tools.numerics_drill [--device cpu]

Four ranks are spawned (on the card every one binds ``cuda:0``: they share
it) and run config 1, the MNIST MLP 784-1024-1024-10 in f32 at global batch
128 (32 a rank), in ``compiled`` mode with ``use_pallas_collectives`` on
(three B1 ring allreduces a step) and ``obs_http`` on (each rank serves its
``/metrics`` and ``/healthz``).  Every rank wires a host ring
(``collectives/hostcomm.py``) and installs an ``obs.numerics.Auditor`` over
it as the engine's ``numerics_auditor``.  The legs, in order:

* ``off`` and ``audit``: the same seeds and batches, ``STEPS`` steps with
  ``numerics_mode="off"``, then again with ``"audit"`` at audit interval
  ``AUDIT_EVERY``, each step timed.  The parameters must be bit-equal and
  B1's launches equal, and every audit of the run clean.  A third run in
  audit mode copies every step's parameters and local gradients to the
  host: each step's sentinels (the history it recorded) are held against
  a float64 recomputation from every rank's local gradients, gathered over
  the process group: the bucket norms, the gradient norm and the
  non-finite count, and the update ratio from the step's parameters.
* ``fork``: rank 2 moves one element of ``FORK_LEAF`` by one ulp; the next
  audit must name that leaf and outlier rank 2 on every rank, rank 2's
  ``/healthz`` must answer 503 ``diverged``, ``tmpi_numerics_divergence_total``
  must move, and its flight bundle must hold the leaf.  Rank 0 then reads
  the four endpoints: ``cluster.job_view(cluster.fetch(...))`` must show
  the job ``diverged`` with rank 2 the diverged rank, and
  ``cluster.federate`` one exposition with a ``rank`` label on every
  sample.  A clean audit after must clear the state.
* ``nan``: ``NAN_STEPS`` steps in audit mode from the start with a NaN in
  rank ``NAN_ROW``'s first row of step ``NAN_AT``'s batch (steps count
  from 0, as the history records them): every rank's sentinels must flag
  that step first, and ``tmpi_numerics_nonfinite_total`` must move.

The off/audit pin, the NaN leg, the ``/healthz`` read and the flight
bundle's evidence are the CLI drill's (``obs/__main__.py``:
``off_against_on``, ``nan_step``, ``healthz``, ``flight_evidence``), run
here on config 1 at p = 4.

The FLOP probe (under the feed gate, on each engine's first step) must
give ``tmpi_step_flops`` equal to the MLP step's analytic count
(:func:`mlp_step_flops`), and ``tmpi_mfu_estimate`` must be published on
the card.  :func:`run` returns every rank's record; :func:`checks` lists
what failed (launch counts and the MFU gauge only on the card).  Every
wait is bounded, and every spawned process is joined or killed before it
returns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List

P = 4
BATCH = 128
LR = 0.1
SEED = 0
STEPS = 8
AUDIT_EVERY = 2
NAN_STEPS, NAN_AT, NAN_ROW = 3, 1, 3
FORK_RANK = 2
FORK_LEAF = "w1"
FORK_INDEX = (5, 7)
RINGS_PER_STEP = 3
HC_DEADLINE_MS = 20000       # every host-ring wait
HTTP_TIMEOUT_S = 5.0
WALL_S = 600.0
#: the sentinels against the float64 recomputation: norms and the ratio
#: within RTOL relative plus ATOL absolute (the f32 ring sums and f32
#: norms against float64; the history keeps bucket norms to 6 decimals).
RTOL, ATOL = 1e-5, 1e-6
LAYERS = (784, 1024, 1024, 10)


def mlp_step_flops(batch: int, layers=LAYERS) -> float:
    """FLOPs of one MLP step at ``batch`` rows as the probe counts them
    (matrix products only, 2 m n k each): the forward's, the weight
    gradients' and the input gradients of every layer but the first (the
    data needs none)."""
    mm = [2.0 * batch * a * b for a, b in zip(layers[:-1], layers[1:])]
    return 2 * sum(mm) + sum(mm[1:])


def _batches(n: int):
    """``n`` rank-major config 1 batches ``(P, BATCH / P, 784)``, the same
    on every rank."""
    import numpy as np

    from ..utils.data import synthetic_mnist

    ds = synthetic_mnist(n=n * BATCH)
    x = ds.x.reshape(n, P, BATCH // P, -1).astype(np.float32)
    y = ds.y.reshape(n, P, BATCH // P).astype(np.int64)
    return [(x[i], y[i]) for i in range(n)]


def _f64_stats(local_grads: List[List[Any]], plan, old, new
               ) -> Dict[str, Any]:
    """The sentinels in float64 from every rank's local gradients (in tree
    order) and the step's parameters before and after."""
    import numpy as np

    mean = [np.mean([np.asarray(r[i], np.float64) for r in local_grads],
                    axis=0) for i in range(len(local_grads[0]))]
    sq = [float(np.sum(np.square(g))) for g in mean]
    buckets = [np.sqrt(sum(sq[i] for i in spec.leaf_indices))
               for spec in plan.specs]
    upd = sum(float(np.sum(np.square(np.asarray(b, np.float64)
                                     - np.asarray(a, np.float64))))
              for a, b in zip(old, new))
    par = sum(float(np.sum(np.square(np.asarray(a, np.float64))))
              for a in old)
    return {"bucket_grad_norms": buckets, "grad_norm": np.sqrt(sum(sq)),
            "nonfinite": int(sum(int(np.sum(~np.isfinite(g)))
                                 for g in mean)),
            "update_ratio": np.sqrt(upd) / max(np.sqrt(par), 1e-12)}


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= ATOL + RTOL * abs(want)


def _rank_main(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """One rank: the three legs; returns its record."""
    import torch
    import torch.distributed as dist

    from ..collectives import cuda_ring
    from ..collectives.hostcomm import HostCommunicator
    from ..engine import AllReduceSGDEngine
    from ..engine import sgdengine
    from ..models import mlp
    from ..nn import bucketing
    from ..obs import __main__ as obs_cli
    from ..obs import cluster, flight, metrics, numerics, serve
    from ..runtime import config, lifecycle
    from ..utils import tree as _tree

    rank = int(os.environ["RANK"])
    if cfg["device"] == "cpu":
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
    config.set("use_pallas_collectives", True)
    config.set("obs_http", True)
    config.set("obs_http_port", cfg["http"][rank])
    config.set("obs_flight", True)
    config.set("obs_flight_dir", os.path.join(cfg["dir"], f"flight{rank}"))
    config.set("numerics_audit_interval", AUDIT_EVERY)
    lifecycle.start(dev if dev.type == "cpu" else None)
    ring = HostCommunicator(rank, P, [tuple(e) for e in cfg["ring"]],
                            timeout_ms=60000, io_deadline_ms=HC_DEADLINE_MS)
    rec: Dict[str, Any] = {"rank": rank, "device": str(dev)}
    try:
        reg = metrics.registry
        auditor = numerics.Auditor(ring)
        audits: List[Dict[str, Any]] = []
        audit_ms: List[float] = []
        real_audit = auditor.audit

        def timed_audit(*a, **kw):
            t0 = time.perf_counter()
            res = real_audit(*a, **kw)
            audit_ms.append((time.perf_counter() - t0) * 1e3)
            audits.append({"step": res.step, "ok": res.ok})
            return res

        auditor.audit = timed_audit

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        # Every step's local gradients (the ring's input) and parameters,
        # on the host, for the float64 recomputation.
        seen: Dict[str, List[Any]] = {"local": [], "params": []}
        real_sync = sgdengine.ring_sync

        def capturing_sync(loss, grads, comm):
            seen["local"].append([t.detach().cpu().clone()
                                  for t in _tree.leaves(grads)])
            return real_sync(loss, grads, comm)

        def engine_run(mode: str, batches, params, capture=False):
            """One ``train`` call in ``mode``; ``capture`` copies every
            step's parameters and local gradients to the host (for the
            float64 check: it slows the step, so timed runs leave it
            off)."""
            config.set("numerics_mode", mode)
            numerics.reset()
            audits.clear()
            audit_ms.clear()
            step_ms: List[float] = []
            box: Dict[str, float] = {}

            def on_sample(state):
                sync()
                if capture:
                    seen["params"].append([t.detach().cpu().clone() for t in
                                           _tree.leaves(state["params"])])
                box["t0"] = time.perf_counter()

            def on_update(state):
                sync()
                step_ms.append((time.perf_counter() - box["t0"]) * 1e3)

            eng = AllReduceSGDEngine(mlp.loss_fn, lr=LR, mode="compiled",
                                     hooks={"on_sample": on_sample,
                                            "on_update": on_update})
            eng.numerics_auditor = auditor
            cuda_ring.ring_allreduce_launches = 0
            seen["local"].clear()
            seen["params"].clear()
            sgdengine.ring_sync = capturing_sync if capture else real_sync
            try:
                state = eng.train(params, batches)
            finally:
                sgdengine.ring_sync = real_sync
            sync()
            final = [t.detach().cpu().clone()
                     for t in _tree.leaves(state["params"])]
            seen["params"].append(final)
            return {"params": state["params"], "final": final,
                    "launches": cuda_ring.ring_allreduce_launches,
                    "step_ms": step_ms, "history": numerics.history(),
                    "audits": list(audits), "audit_ms": list(audit_ms),
                    "local": list(seen["local"]),
                    "steps_params": list(seen["params"])}

        def check_sentinels(run) -> Dict[str, Any]:
            """Each step's recorded sentinels against the float64
            recomputation over every rank's gathered local gradients."""
            plan = bucketing.plan_buckets(run["params"])
            bad, worst = [], 0.0
            for i, hrec in enumerate(run["history"]):
                everyone: List[Any] = [None] * P
                dist.all_gather_object(everyone, [t.numpy() for t in
                                                  run["local"][i]])
                want = _f64_stats(everyone, plan, run["steps_params"][i],
                                  run["steps_params"][i + 1])
                pairs = list(zip(hrec["bucket_grad_norms"],
                                 want["bucket_grad_norms"]))
                pairs += [(hrec["grad_norm"], want["grad_norm"]),
                          (hrec["update_ratio"], want["update_ratio"])]
                for g, w in pairs:
                    worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
                ok = (all(_close(g, w) for g, w in pairs)
                      and hrec["nonfinite"] == want["nonfinite"]
                      and hrec["step"] == i)
                if not ok:
                    bad.append({"step": hrec["step"], "got": hrec,
                                "want": {k: (list(map(float, v))
                                             if isinstance(v, list)
                                             else float(v))
                                         for k, v in want.items()}})
            return {"steps": len(run["history"]), "mismatched": bad,
                    "max_rel_err": worst}

        x_steps = _batches(STEPS)
        params0 = mlp.init(SEED, device=dev)

        def run(mode, batches):
            # From the same start every time (obs_cli's legs).
            out = engine_run(mode, batches,
                             {k: v.clone() for k, v in params0.items()})
            return out["final"], out

        # off, then audit, from the same start, timed; then audit again
        # with every step captured for the float64 check.
        pinned = obs_cli.off_against_on(run, x_steps, "audit")
        off, audit = pinned["off"], pinned["on"]
        rec["audits"] = audit["audits"]
        rec["audit_ms"] = audit["audit_ms"]
        checked = engine_run("audit", x_steps,
                             {k: v.clone() for k, v in params0.items()},
                             capture=True)
        rec["off_launches"] = off["launches"]
        rec["audit_launches"] = audit["launches"]
        rec["checked_launches"] = checked["launches"]
        rec["bit_equal"] = pinned["off_bit_identical"]
        rec["off_step_ms"] = off["step_ms"]
        rec["audit_step_ms"] = audit["step_ms"]
        rec["sentinels"] = check_sentinels(checked)
        rec["history_len"] = len(checked["history"])
        rec["step_flops"] = reg.gauge("tmpi_step_flops").value()
        rec["mfu_estimate"] = (reg.gauge("tmpi_mfu_estimate").value()
                               if "tmpi_mfu_estimate" in reg.to_prometheus()
                               else None)

        # fork: one ulp on rank 2, then the next audit.  A /healthz read
        # first baselines the watched counters, so that the divergence
        # counter's movement reads on the observers too.
        obs_cli.healthz(serve.url(), HTTP_TIMEOUT_S)
        params = audit["params"]
        leaf = params[FORK_LEAF]
        before_div = reg.counter("tmpi_numerics_divergence_total").value()
        if rank == FORK_RANK:
            with torch.no_grad():
                v = leaf[FORK_INDEX].clone()
                leaf[FORK_INDEX] = torch.nextafter(
                    v, torch.tensor(float("inf"), device=v.device))
        audits.clear()
        res = auditor.maybe_audit(params, STEPS + AUDIT_EVERY)
        rec["fork"] = {
            "ok": res.ok, "leaf": res.first_divergent_leaf,
            "outliers": res.outlier_ranks, "exchanges": res.exchanges,
            "divergence_moved": reg.counter(
                "tmpi_numerics_divergence_total").value() > before_div}
        code, doc = obs_cli.healthz(serve.url(), HTTP_TIMEOUT_S)
        rec["fork"]["healthz"] = {"code": code, "state": doc["state"]}
        rec["fork"]["flight"] = obs_cli.flight_evidence(
            flight.last_dump_path())
        urls: List[Any] = [None] * P
        dist.all_gather_object(urls, serve.url())
        if rank == 0:
            results = cluster.fetch(urls, timeout_s=HTTP_TIMEOUT_S)
            view = cluster.job_view(results)
            fed = cluster.federate({r: results[r].get("metrics_text", "")
                                    for r in range(P)})
            samples = cluster.parse_prometheus(fed)["samples"]
            rec["cluster"] = {
                "verdict": view["verdict"],
                "states": [r["state"] for r in view["ranks"]],
                "diverged_ranks": [r["rank"] for r in view["ranks"]
                                   if r["state"] == "diverged"],
                "mfu": [r.get("mfu") for r in view["ranks"]],
                "samples": len(samples),
                "every_sample_has_rank": all(
                    "rank" in s["labels"] for s in samples),
                "ranks_in_federation": sorted({s["labels"]["rank"]
                                               for s in samples})}
        dist.barrier()
        # The replicas agree again: a clean audit clears the state.
        if rank == FORK_RANK:
            with torch.no_grad():
                leaf[FORK_INDEX] = v
        res = auditor.maybe_audit(params, STEPS + 2 * AUDIT_EVERY)
        rec["fork"]["recovered"] = res.ok and obs_cli.healthz(
            serve.url(), HTTP_TIMEOUT_S)[1]["state"] != "diverged"

        # nan: a NaN in one rank's rows of one batch (obs_cli's leg).
        nan = obs_cli.nan_step(run, x_steps[:NAN_STEPS], NAN_AT, NAN_ROW,
                               "audit")
        rec["nan"] = {"launches": nan["record"]["launches"],
                      **{k: nan[k] for k in (
                          "nonfinite_by_step", "caught_within_one_step",
                          "nonfinite_total_moved")}}
        dist.barrier()
    finally:
        ring.close()
        lifecycle.stop()
    return rec


def run(device: str = "cuda", directory: str = None) -> Dict[str, Any]:
    """Spawn the four ranks and collect their records."""
    import socket

    from ..runtime import launch

    directory = directory or tempfile.mkdtemp(prefix="numerics_drill_")
    ports = []
    socks = []
    for _ in range(2 * P):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    cfg = {"device": device, "dir": os.path.abspath(directory),
           "ring": [("127.0.0.1", p) for p in ports[:P]],
           "http": ports[P:]}
    t0 = time.perf_counter()
    recs = launch.spawn(P, _rank_main, (cfg,), timeout_s=WALL_S)
    return {"device": device, "seconds": time.perf_counter() - t0,
            "ranks": recs, "expected_step_flops": mlp_step_flops(BATCH // P)}


def checks(out: Dict[str, Any]) -> List[str]:
    """What failed, by name."""
    failed = []
    card = out["device"] != "cpu"
    ranks = out["ranks"]
    for r in ranks:
        me = f"rank{r['rank']}"
        if not r["bit_equal"]:
            failed.append(f"{me}: audit run not bit-equal to off run")
        if card and not (r["off_launches"] == r["audit_launches"]
                         == r["checked_launches"] == RINGS_PER_STEP * STEPS
                         and r["nan"]["launches"]
                         == RINGS_PER_STEP * NAN_STEPS):
            failed.append(f"{me}: B1 launches off {r['off_launches']} "
                          f"audit {r['audit_launches']} checked "
                          f"{r['checked_launches']} nan "
                          f"{r['nan']['launches']}")
        if r["sentinels"]["mismatched"] or r["sentinels"]["steps"] != STEPS:
            failed.append(f"{me}: sentinels against float64: "
                          f"{r['sentinels']['mismatched'][:1]}")
        if [a["step"] for a in r["audits"]] != list(
                range(AUDIT_EVERY, STEPS + 1, AUDIT_EVERY)) or not all(
                a["ok"] for a in r["audits"]):
            failed.append(f"{me}: audits of the clean run {r['audits']}")
        if r["step_flops"] != out["expected_step_flops"]:
            failed.append(f"{me}: tmpi_step_flops {r['step_flops']} != "
                          f"{out['expected_step_flops']}")
        if card and not r["mfu_estimate"]:
            failed.append(f"{me}: no tmpi_mfu_estimate")
        f = r["fork"]
        if f["ok"] or f["leaf"] != f"['{FORK_LEAF}']" or \
                f["outliers"] != [FORK_RANK] or not f["divergence_moved"]:
            failed.append(f"{me}: fork audit {f}")
        want = ((503, "diverged") if r["rank"] == FORK_RANK
                else (200, "degraded"))
        if (f["healthz"]["code"], f["healthz"]["state"]) != want:
            failed.append(f"{me}: /healthz after the fork {f['healthz']}")
        if not f["flight"]["parseable"] or f["flight"][
                "first_divergent_leaf"] != f"['{FORK_LEAF}']":
            failed.append(f"{me}: flight bundle {f['flight']}")
        if not f["recovered"]:
            failed.append(f"{me}: no recovery after a clean audit")
        if not (r["nan"]["caught_within_one_step"]
                and r["nan"]["nonfinite_total_moved"]):
            failed.append(f"{me}: NaN step not flagged "
                          f"{r['nan']['nonfinite_by_step']}")
    c = ranks[0].get("cluster", {})
    if c.get("verdict") != "diverged" or c.get("diverged_ranks") != [
            FORK_RANK]:
        failed.append(f"job view {c.get('verdict')} {c.get('states')}")
    if not c.get("every_sample_has_rank") or c.get(
            "ranks_in_federation") != [str(r) for r in range(P)]:
        failed.append("federation: a sample without its rank label")
    return failed


def summary(out: Dict[str, Any]) -> Dict[str, Any]:
    """The drill's numbers: step ms of both timed runs over the steady
    steps that end in no audit (the first step, slowed by the FLOP probe,
    and every step that ends in an audit left out: the audit's time is
    ``audit_ms``), mean over the ranks; the sentinels' largest error; the
    audits' ms and the fork's and NaN's verdicts."""
    import numpy as np

    ranks = out["ranks"]
    plain = [i for i in range(1, STEPS) if (i + 1) % AUDIT_EVERY]

    def steady(key):
        return float(np.mean([np.mean([r[key][i] for i in plain])
                              for r in ranks]))

    off_ms, audit_ms = steady("off_step_ms"), steady("audit_step_ms")
    return {
        "seconds": out["seconds"], "steady_steps": plain,
        "off_step_ms": off_ms, "audit_step_ms": audit_ms,
        "sentinel_overhead_ms": audit_ms - off_ms,
        "audit_ms": float(np.mean([np.mean(r["audit_ms"])
                                   for r in ranks])),
        "audits_per_run": len(ranks[0]["audits"]),
        "b1_launches": {"off": ranks[0]["off_launches"],
                        "audit": ranks[0]["audit_launches"],
                        "checked": ranks[0]["checked_launches"],
                        "nan": ranks[0]["nan"]["launches"]},
        "b1_launches_all_ranks": sum(
            r["off_launches"] + r["audit_launches"] + r["checked_launches"]
            + r["nan"]["launches"] for r in ranks),
        "sentinel_max_rel_err": max(r["sentinels"]["max_rel_err"]
                                    for r in ranks),
        "step_flops": ranks[0]["step_flops"],
        "expected_step_flops": out["expected_step_flops"],
        "mfu_estimate": [r["mfu_estimate"] for r in ranks],
        "fork": {k: ranks[0]["fork"][k] for k in ("leaf", "outliers",
                                                  "exchanges")},
        "cluster": ranks[0].get("cluster"),
        "nan": ranks[0]["nan"]["nonfinite_by_step"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("numerics_drill: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 2
        from .. import _build

        _build.build("ring")
    out = run(args.device, args.dir)
    failed = checks(out)
    print(json.dumps({"summary": summary(out), "failed": failed},
                     default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
