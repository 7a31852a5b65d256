"""The ring kernels (B1-B3) against their plain versions on one GPU, p ranks.

    python -m torchmpi_tpu_torch.tools.ring_bench [--nproc 2] [--quick]

Spawns p ranks on the visible GPU (every rank binds ``cuda:0`` when there is
one card, with a gloo group).  For each case, every rank builds all ranks'
inputs from the seed on the card, runs the kernel wrapper on its own input
and checks its result against the plain schedule (``_ring_*_plain``) over
all inputs, **bit for bit**.  Cases: allreduce in f32, bf16 and int32,
reduce-scatter and allgather in f32 and bf16, each at n = 25,557,032
(ResNet-50's parameter count), 3,000 (not lane-aligned) and 5 (8 for the
reduce-scatter, which needs p | n); the small sizes once more with
``max_buffer_size`` cut to 64 KiB (sub-chunks) and one staging slot.

Then the rings of one ResNet-50 training step as ``AllReduceSGDEngine``
runs them (``engine.sgdengine.ring_plan`` over the full-width gradient
leaves: 42 leaves of 65,536 to 2,359,296 elements one by one, then the
309,288-element tail), f32, ``mean=True``, the engine's collective ids,
each held against the plain schedule bit for bit.  Rank 0 times the 43
rings as one step (CUDA events, median of 5 after a warm-up), the plain
schedule over the same inputs and gloo's ``all_reduce`` of the same 43
tensors, and one ring alone at the largest leaf and at the tail.  The same
again for the buckets of one ``eager_async`` step (``nn.bucketing.
plan_ready_order`` over the full-width parameters: 4 buckets of 2,057,536 to
8,271,616 elements, in dispatch order, on the ring's default collective id
as the selector's async cell calls it).

At n = 25,557,032 in f32 it times, on rank 0, the kernel (CUDA events
around each call, median of 10 after 2 warm-up calls), the plain version
(median of 3) and the library yardstick: gloo's ``all_reduce`` on the same
CUDA tensors (reduce-scatter: that all_reduce and a slice; allgather:
gloo's ``all_gather``, which stages a CUDA tensor through the host).  Then
it drives the public collectives once through the selector with
``use_pallas_collectives`` on, at n = 25,557,032 (the ``collectives`` path;
the launch counts are taken around it), then the first call of a ring on a
collective id of its own while rank 0's stream is still busy (its staging
must be zeroed before a neighbour can send into it), bit for bit against
the plain schedule, and last two forced stalls: rank 1
skips a ring, and rank 0 must raise ``RingError`` within the deadline; then
rank 1 runs that ring late, after rank 0 gave up on it, and must raise in
turn without lowering rank 0's released data word.

Prints one JSON line per case and a summary; ``chip_smoke.py`` calls
:func:`run` for p = 2 and p = 4.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

BIG_N = 25_557_032
KINDS = ("allreduce", "reduce_scatter", "allgather")
STALL_TIMEOUT_S = 1.0
# What tmpi_ring_abort raises a rank's data and credit words to.
ABORTED_WORD = 1 << 62
# The fresh-state case: a collective id no other case uses, its size, and
# the sleep queued on rank 0's stream first (about 0.2 s on an H100).
FRESH_COLLECTIVE_ID = 0x7E
FRESH_N = 300_000
FRESH_SLEEP_CYCLES = 400_000_000


def _cases(quick: bool):
    out = []
    for kind in KINDS:
        dtypes = ("float32", "bfloat16") + (("int32",) if kind == "allreduce"
                                            else ())
        small = 8 if kind == "reduce_scatter" else 5
        for dt in dtypes:
            sizes = (3000, small) if quick else (BIG_N, 3000, small)
            for n in sizes:
                out.append({"kind": kind, "dtype": dt, "n": n, "knobs": {}})
            for n in (3000, small):
                out.append({"kind": kind, "dtype": dt, "n": n, "knobs": {
                    "max_buffer_size": 1 << 16, "min_buffer_size": 1 << 12,
                    "num_buffers_per_collective": 1}})
    return out


def _inputs(torch, case, p, seed):
    dt = getattr(torch, case["dtype"])
    xs = []
    for r in range(p):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + r)
        if dt == torch.int32:
            xs.append(torch.randint(-1000, 1000, (case["n"],), generator=g,
                                    device="cuda", dtype=torch.int32))
        else:
            xs.append(torch.randn(case["n"], generator=g,
                                  device="cuda").to(dt))
    return xs


def _bits(torch, t):
    """``t``'s bits as integers, for an exact comparison (NaN included)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _ms(torch, fn, warmup: int, iters: int) -> float:
    """Median device time of one call (CUDA events), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rank_main(quick: bool, seed: int) -> dict:
    """One rank's part of the bench; returns its records."""
    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import cuda_ring as cr
    from torchmpi_tpu_torch.collectives import eager, selector
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.runtime.communicator import stack

    lifecycle.start()
    try:
        comm = stack.world()
        p, me = comm.size, comm.rank
        kernels = {"allreduce": lambda x: cr.ring_allreduce(comm, x),
                   "reduce_scatter": lambda x: cr.ring_reduce_scatter(comm, x),
                   "allgather": lambda x: cr.ring_allgather(comm, x)}
        plains = {"allreduce": cr._ring_allreduce_plain,
                  "reduce_scatter": cr._ring_reduce_scatter_plain,
                  "allgather": cr._ring_allgather_plain}
        records = []
        for i, case in enumerate(_cases(quick)):
            config.reset(**case["knobs"])
            xs = _inputs(torch, case, p, seed + i)
            got = kernels[case["kind"]](xs[me])
            torch.cuda.synchronize()
            want = plains[case["kind"]](xs)[me]
            rec = {**case, "p": p, **_compare(torch, got, want)}
            if case["n"] == BIG_N and case["dtype"] == "float32":
                x = xs[me]
                rec["kernel_ms"] = _ms(torch, lambda: kernels[case["kind"]](x),
                                       2, 10)
                rec["plain_ms"] = _ms(torch, lambda: plains[case["kind"]](xs),
                                      1, 3)
                y = x.clone()
                lib = {"allreduce": lambda: dist.all_reduce(y),
                       "reduce_scatter": lambda: eager.reduce_scatter(comm, x),
                       "allgather": lambda: eager.allgather(comm, x)}
                rec["library_ms"] = _ms(torch, lib[case["kind"]], 1, 5)
            records.append(rec)
            del xs, got, want
        config.reset()
        resnet_rings = _resnet_step_rings(torch, dist, cr, comm, quick, seed)
        torch.cuda.empty_cache()
        bucket_rings = _resnet_bucket_rings(torch, dist, cr, comm, quick,
                                            seed)
        torch.cuda.empty_cache()

        # The collectives path: the public API through the selector.
        config.reset(use_pallas_collectives=True)
        n = BIG_N
        x = torch.randn(n, generator=torch.Generator(device="cuda")
                        .manual_seed(seed + me), device="cuda")
        cr.ring_allreduce_launches = cr.ring_reduce_scatter_launches = 0
        cr.ring_allgather_launches = 0
        ar = selector.resolve("allreduce")(comm, x, op="mean")
        rs = selector.resolve("reduce_scatter")(comm, x[:n - n % p])
        ag = selector.resolve("allgather")(comm, x)
        torch.cuda.synchronize()
        counts = _counts(cr)
        api_ok = (tuple(ar.shape) == (n,) and tuple(rs.shape) == (n // p,)
                  and tuple(ag.shape) == (p, n)
                  and bool(torch.equal(ag[me], x)))
        del ar, rs, ag
        fresh = _fresh_state(torch, dist, cr, comm, seed)
        return {"rank": me, "p": p, "records": records,
                "resnet_rings": resnet_rings, "bucket_rings": bucket_rings,
                "collectives_launches": counts, "collectives_ok": api_ok,
                "fresh_state": fresh,
                **_stalls(torch, dist, cr, comm, x[:4096])}
    finally:
        lifecycle.stop()


def _compare(torch, got, want) -> dict:
    same = (got.dtype == want.dtype and got.shape == want.shape
            and bool(torch.equal(_bits(torch, got), _bits(torch, want))))
    err = float((got.double() - want.double()).abs().max())
    return {"bitwise_equal": same, "max_abs_err": err}


def resnet50_ring_sizes(device="cuda") -> list:
    """Elements of each ring of one ResNet-50 (full width) training step,
    in the engine's order."""
    from torchmpi_tpu_torch.engine.sgdengine import ring_plan
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.runtime import config
    from torchmpi_tpu_torch.utils import tree

    params, _ = resnet.init(0, resnet.config(depth=50), device=device)
    leaves = tree.leaves(params)
    plan = ring_plan(leaves, int(config.get("small_allreduce_size_gpu")))
    return [sum(leaves[i].numel() for i in idxs) for idxs in plan]


def resnet50_bucket_sizes(device="cuda") -> list:
    """Elements of each bucket of one ResNet-50 (full width) ``eager_async``
    step, in the order ``nn.async_`` dispatches them
    (``nn.bucketing.plan_ready_order``)."""
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.nn import bucketing

    params, _ = resnet.init(0, resnet.config(depth=50), device=device)
    dp = bucketing.plan_ready_order(params)
    return [dp.plan.specs[bi].total for bi in dp.order]


def _resnet_step_rings(torch, dist, cr, comm, quick: bool, seed: int) -> dict:
    """The rings of one ResNet-50 compiled-mode step (the engine's ids)."""
    sizes = resnet50_ring_sizes()
    ids = [cr.CALLER_COLLECTIVE_ID_BASE + i % 8 for i in range(len(sizes))]
    return _held_rings(torch, dist, cr, comm, sizes, ids, quick, seed + 100)


def _resnet_bucket_rings(torch, dist, cr, comm, quick: bool,
                         seed: int) -> dict:
    """The buckets of one ResNet-50 eager_async step, in dispatch order, on
    the ring's default id as the selector's async cell calls it."""
    sizes = resnet50_bucket_sizes()
    return _held_rings(torch, dist, cr, comm, sizes, [None] * len(sizes),
                       quick, seed + 200)


def _held_rings(torch, dist, cr, comm, sizes, ids, quick: bool,
                seed: int) -> dict:
    """Rings of ``sizes`` elements (f32, mean, collective ``ids``), each
    against the plain schedule; on rank 0 (unless ``quick``) the rings
    timed together as one step and one ring at the largest size and the
    last."""
    p, me = comm.size, comm.rank
    case = {"dtype": "float32"}
    inputs, bad, err = [], [], 0.0
    for i, n in enumerate(sizes):
        xs = _inputs(torch, {**case, "n": n}, p, seed + i)
        got = cr.inner_ring_allreduce(xs[me], p, mean=True,
                                      collective_id=ids[i], comm=comm)
        torch.cuda.synchronize()
        cmp = _compare(torch, got, cr._ring_allreduce_plain(xs, mean=True)[me])
        err = max(err, cmp["max_abs_err"])
        if not cmp["bitwise_equal"]:
            bad.append(n)
        inputs.append(xs)
    out = {"p": p, "rings": len(sizes), "sizes": sizes,
           "elements": sum(sizes), "largest": max(sizes), "tail": sizes[-1],
           "bitwise_equal": not bad, "unequal_sizes": bad,
           "max_abs_err": err}
    if quick:
        return out
    mine = [xs[me] for xs in inputs]

    def step():
        for x, cid in zip(mine, ids):
            cr.inner_ring_allreduce(x, p, mean=True, collective_id=cid,
                                    comm=comm)

    def plain_step():
        for xs in inputs:
            cr._ring_allreduce_plain(xs, mean=True)

    copies = [x.clone() for x in mine]

    def gloo_step():
        for y in copies:
            dist.all_reduce(y)

    def one(i):
        return lambda: cr.inner_ring_allreduce(mine[i], p, mean=True,
                                               collective_id=ids[i],
                                               comm=comm)

    largest = sizes.index(max(sizes))
    out.update(kernel_ms=_ms(torch, step, 1, 5),
               plain_ms=_ms(torch, plain_step, 1, 3),
               library_ms=_ms(torch, gloo_step, 1, 3),
               largest_ms=_ms(torch, one(largest), 2, 10),
               tail_ms=_ms(torch, one(len(sizes) - 1), 2, 10))
    return out


def _fresh_state(torch, dist, cr, comm, seed: int) -> dict:
    """A ring on a collective id of its own, its first call, made while rank
    0's stream is still busy (a sleep kernel of about 0.2 s queued just
    before): rank 0's staging must be zeroed before its handle reaches the
    neighbour, whose first send may land at once.  Held against the plain
    schedule bit for bit."""
    p, me = comm.size, comm.rank
    xs = [torch.randn(FRESH_N, generator=torch.Generator(device="cuda")
                      .manual_seed(seed * 31 + r), device="cuda")
          for r in range(p)]
    torch.cuda.synchronize()
    dist.barrier(group=comm.group)
    if me == 0:
        torch.cuda._sleep(FRESH_SLEEP_CYCLES)
    got = cr.inner_ring_allreduce(xs[me], p, collective_id=FRESH_COLLECTIVE_ID,
                                  comm=comm)
    torch.cuda.synchronize()
    return {"n": FRESH_N, **_compare(torch, got,
                                     cr._ring_allreduce_plain(xs)[me])}


def _stalls(torch, dist, cr, comm, x) -> dict:
    """Two forced stalls on a ring of its own.  First rank 1 skips a call
    that rank 0 makes: rank 0 must raise within the deadline.  Then rank 1
    makes that call late, after rank 0 gave up on it: rank 1 must raise in
    turn, and its signals (at p = 2 its send raises rank 0's data word; at
    p = 4 its add returns a credit to rank 0) must not lower the words rank
    0's abort set past every step."""
    p, me = comm.size, comm.rank
    cid = 0x7F
    cr.inner_ring_allreduce(x, p, collective_id=cid, comm=comm)
    torch.cuda.synchronize()
    dist.barrier()
    old_timeout = cr.RING_TIMEOUT_S
    cr.RING_TIMEOUT_S = STALL_TIMEOUT_S

    def attempt():
        t0 = time.monotonic()
        try:
            cr.inner_ring_allreduce(x, p, collective_id=cid, comm=comm)
            rec = {"raised": False}
        except cr.RingError as e:
            rec = {"raised": True, "message": str(e)}
        rec["seconds"] = time.monotonic() - t0
        rec["deadline_s"] = STALL_TIMEOUT_S
        return rec

    try:
        stall = attempt() if me == 0 else {}
        dist.barrier()
        late = attempt() if me == 1 else {}
        dist.barrier()
        if me == 0:
            _, data, credit = cr._states[(id(comm), comm.ranks,
                                          cid)].flag_words()
            late = {"aborted_data_word": data, "aborted_credit_word": credit,
                    "kept_past_every_step": min(data, credit) >= ABORTED_WORD}
        lates = [None] * p
        dist.all_gather_object(lates, late)
    finally:
        cr.RING_TIMEOUT_S = old_timeout
    return {"stall": stall, "late": {**lates[1], **lates[0]}}


def _counts(cr) -> dict:
    return {"ring_allreduce": cr.ring_allreduce_launches,
            "ring_reduce_scatter": cr.ring_reduce_scatter_launches,
            "ring_allgather": cr.ring_allgather_launches}


def stalls_ok(stall: dict, late: dict) -> bool:
    """Both stalled rings raised within five deadlines, and the late send
    left the aborted word where the abort put it."""
    return bool(stall.get("raised") and stall["seconds"] < 5 * STALL_TIMEOUT_S
                and late.get("raised")
                and late["seconds"] < 5 * STALL_TIMEOUT_S
                and late.get("kept_past_every_step"))


def bound_ms(kind: str, n: int, p: int, esize: int,
             hbm_bytes_per_s: float = 3.35e12) -> float:
    """Least time on one card: every rank's input read once and every
    rank's output written once, all through the one HBM."""
    out = {"allreduce": n, "reduce_scatter": n // p, "allgather": p * n}[kind]
    return p * (n + out) * esize / hbm_bytes_per_s * 1e3


def run(nproc: int, quick: bool = False, seed: int = 0) -> list:
    """Build the ring source, spawn ``nproc`` ranks on the GPU and return
    every rank's result."""
    from torchmpi_tpu_torch import _build
    from torchmpi_tpu_torch.runtime import launch

    _build.build("ring")
    return launch.spawn(nproc, rank_main, (quick, seed), timeout_s=900)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="skip the n = 25,557,032 cases")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ring_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    results = run(args.nproc, args.quick)
    ok = True
    for res in results:
        for rec in res["records"]:
            if res["rank"] == 0:
                print(json.dumps(rec), flush=True)
            ok = ok and rec["bitwise_equal"]
        ok = ok and res["collectives_ok"]
    rings = results[0]["resnet_rings"]
    print(json.dumps({"resnet_rings": {k: v for k, v in rings.items()
                                       if k != "sizes"}}), flush=True)
    ok = ok and all(r["resnet_rings"]["bitwise_equal"] for r in results)
    buckets = results[0]["bucket_rings"]
    print(json.dumps({"bucket_rings": buckets}), flush=True)
    ok = ok and all(r["bucket_rings"]["bitwise_equal"] for r in results)
    print(json.dumps({"fresh_state": [r["fresh_state"] for r in results]}),
          flush=True)
    ok = ok and all(r["fresh_state"]["bitwise_equal"] for r in results)
    stall, late = results[0]["stall"], results[0]["late"]
    print(json.dumps({"collectives_launches": results[0]["collectives_launches"],
                      "stall": stall, "late": late}), flush=True)
    ok = ok and stalls_ok(stall, late)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
