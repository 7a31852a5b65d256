"""The ring kernels (B1-B3) against their plain versions on one GPU, p ranks.

    python -m torchmpi_tpu_torch.tools.ring_bench [--nproc 2] [--quick]

Spawns p ranks on the visible GPU (every rank binds ``cuda:0`` when there is
one card, with a gloo group).  For each case, every rank builds all ranks'
inputs from the seed on the card, runs the kernel wrapper on its own input
and checks its result against the kernel's plain version over all inputs
(``_oneshot_allreduce_plain``, ``_oneshot_reduce_scatter_plain``,
``_oneshot_allgather_plain``), **bit for bit**.  Cases: allreduce and
allgather in f32, bf16 and int32, reduce-scatter in f32 and bf16, each at
n = 25,557,032 (ResNet-50's parameter count), 3,000 (not lane-aligned) and
5 (for the reduce-scatter, which needs p | n, the least common multiple of
8 and p); the small sizes once more
with ``max_buffer_size`` cut to 64 KiB (sub-chunks) and one staging slot.

Then the rings of one ResNet-50 training step as ``AllReduceSGDEngine``
runs them (``engine.sgdengine.ring_plan`` over the full-width gradient
leaves: 42 leaves of 65,536 to 2,359,296 elements one by one, then the
309,288-element tail), f32, ``mean=True``, the engine's collective ids,
each held against its plain version bit for bit.  Rank 0 times the 43
rings as one step (CUDA events, median of 5 after a warm-up), the plain
version over the same inputs and gloo's ``all_reduce`` of the same 43
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
must be zeroed before a peer can signal into it), bit for bit against
the plain version, then for the allreduce and for the allgather three
calls back to back on one collective id (both staging slots, then the
first again; the second input an offset view, which takes the kernels'
unaligned path), each bit for bit, then, for each of the two, two
forced stalls: rank 1 skips a ring, and rank 0 must raise ``RingError``
within the deadline; then rank 1 runs that ring late, after rank 0 gave
up on it, and must raise in turn without lowering rank 0's released
READY word.  Last, the same stall of B1 with rank 0 tearing its ring
states down (``release_local``) before rank 1 enters: rank 1's late call
must raise ``RingTimeout``, reading rank 0's error word in the block rank
0 keeps until every rank has left the call.

Prints one JSON line per case and a summary; ``chip_smoke.py`` calls
:func:`run` for p = 2 and p = 4, and with ``quick`` for p = 3.

    python -m torchmpi_tpu_torch.tools.ring_bench --breakdown

takes B1's and B3's cost apart instead, call by call: the 43 rings of a
ResNet-50 step at p = 2 (f32, mean, the engine's ids), one B1 ring and
one B3 allgather of n = 25,557,032 at p = 2 and p = 4 (f32, the default
ids), each after two warm-up rounds.
For each call it reports the host µs in the wrapper without its wait for
the call's event, the wrapper's end-to-end µs (both by the host clock over
``BREAKDOWN_ROUNDS`` rounds, unprofiled), and from a ``torch.profiler``
trace of ``PROFILED_ROUNDS`` more rounds on every rank (CPU and CUDA
activity): rank 0's device operations by name, their busy µs, and the gaps
between them (the stream waits on the peers and the card's switches to
their contexts), with the lead from the call's start to its first device
operation; then every rank's trace on one clock, for the window of each
call across the ranks, the share of it in which no rank's operation ran,
the skew between the ranks' starts and, for the one-shot kernels, the
handoff from the last STAGE to the first REDUCE or GATHER and the tail
from the last of those to the last rank's return.  Medians over the
rounds; for the 43 rings, their sums a step.  It drives only the public
wrappers, so it runs on an older tree too (copied in under another name).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

BIG_N = 25_557_032
KINDS = ("allreduce", "reduce_scatter", "allgather")
STALL_TIMEOUT_S = 1.0
# What tmpi_ring_abort raises a rank's READY word to.
ABORTED_WORD = 1 << 62
# The fresh-state case: a collective id no other case uses, its size, and
# the sleep queued on rank 0's stream first (about 0.2 s on an H100).
FRESH_COLLECTIVE_ID = 0x7E
FRESH_N = 300_000
FRESH_SLEEP_CYCLES = 400_000_000
# The back-to-back cases: a collective id of its own for each kind, and
# their size.
BACK_TO_BACK_COLLECTIVE_IDS = {"allreduce": 0x7D, "allgather": 0x7C}
BACK_TO_BACK_N = 1_000_003
# The stalls: a collective id of its own for each kind, and one for the
# stall whose first rank tears down before the late one enters.
STALL_COLLECTIVE_IDS = {"allreduce": 0x7F, "allgather": 0x7B}
TEARDOWN_COLLECTIVE_ID = 0x7A
# The breakdown: unprofiled rounds (host clock) and profiled rounds.
BREAKDOWN_ROUNDS = 5
PROFILED_ROUNDS = 3


def _cases(quick: bool, p: int):
    out = []
    for kind in KINDS:
        dtypes = ("float32", "bfloat16") + (("int32",)
                                            if kind != "reduce_scatter"
                                            else ())
        # A reduce-scatter's n is a multiple of p: 8 at p = 2 and 4.
        small = math.lcm(8, p) if kind == "reduce_scatter" else 5
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
        plains = {"allreduce": cr._oneshot_allreduce_plain,
                  "reduce_scatter": cr._oneshot_reduce_scatter_plain,
                  "allgather": cr._oneshot_allgather_plain}
        records = []
        for i, case in enumerate(_cases(quick, p)):
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
                "back_to_back": {k: _back_to_back(torch, cr, comm, k, seed)
                                 for k in BACK_TO_BACK_COLLECTIVE_IDS},
                "stalls": {k: _stalls(torch, dist, cr, comm, k, x[:4096])
                           for k in STALL_COLLECTIVE_IDS},
                # Last: it takes every ring state of the world down.
                "teardown": _teardown_stall(torch, dist, cr, comm,
                                            x[:4096])}
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
        cmp = _compare(torch, got,
                       cr._oneshot_allreduce_plain(xs, mean=True)[me])
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
            cr._oneshot_allreduce_plain(xs, mean=True)

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
                                     cr._oneshot_allreduce_plain(xs)[me])}


def _ring_call(cr, comm, kind: str, x, cid: int, mean: bool = False):
    """One ``kind`` call ('allreduce' or 'allgather') of this rank's ``x``
    on collective id ``cid``."""
    if kind == "allreduce":
        return cr.inner_ring_allreduce(x, comm.size, mean=mean,
                                       collective_id=cid, comm=comm)
    return cr.ring_allgather(comm, x, collective_id=cid)


def _back_to_back(torch, cr, comm, kind: str, seed: int) -> list:
    """Three ``kind`` calls on one collective id of their own, one after the
    other: slots 0 and 1, then slot 0 again, which every peer must have
    read by then.  The second input is an offset view (4 bytes into its
    storage: the kernels' unaligned path) and, for the allreduce, the
    second call takes the mean.  Each held against its plain version bit
    for bit."""
    p, me = comm.size, comm.rank
    out = []
    for call in range(3):
        xs = [torch.randn(BACK_TO_BACK_N + 1, generator=torch.Generator(
            device="cuda").manual_seed(seed * 77 + call * p + r),
            device="cuda")[call % 2:][:BACK_TO_BACK_N] for r in range(p)]
        mean = kind == "allreduce" and call == 1
        got = _ring_call(cr, comm, kind, xs[me],
                         BACK_TO_BACK_COLLECTIVE_IDS[kind], mean)
        want = (cr._oneshot_allreduce_plain(xs, mean=mean) if kind ==
                "allreduce" else cr._oneshot_allgather_plain(xs))[me]
        out.append({"call": call, "offset_view": xs[me].storage_offset() > 0,
                    "mean": mean, **_compare(torch, got, want)})
    return out


def _stalls(torch, dist, cr, comm, kind: str, x) -> dict:
    """Two forced stalls of ``kind`` calls on a ring of its own.  First
    rank 1 skips a call that rank 0 makes: rank 0 must raise within the
    deadline.  Then rank 1 makes that call late, after rank 0 gave up on
    it: rank 1 must raise in turn (at p = 2 its wait passes, since rank 0
    had staged, and its REDUCE or GATHER finds rank 0's error word; at
    p = 4 it waits in vain for ranks 2 and 3), and its STAGE's add must not
    lower the READY word rank 0's abort set past every count."""
    p, me = comm.size, comm.rank
    cid = STALL_COLLECTIVE_IDS[kind]
    _ring_call(cr, comm, kind, x, cid)
    torch.cuda.synchronize()
    dist.barrier()
    old_timeout = cr.RING_TIMEOUT_S
    cr.RING_TIMEOUT_S = STALL_TIMEOUT_S

    def attempt():
        t0 = time.monotonic()
        try:
            _ring_call(cr, comm, kind, x, cid)
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
            ready = cr._states[(id(comm), comm.ranks, cid)].flag_words()[1]
            late = {"aborted_ready_word": ready,
                    "kept_past_every_step": ready >= ABORTED_WORD}
        lates = [None] * p
        dist.all_gather_object(lates, late)
    finally:
        cr.RING_TIMEOUT_S = old_timeout
    return {"stall": stall, "late": {**lates[1], **lates[0]}}


def _teardown_stall(torch, dist, cr, comm, x) -> dict:
    """A stall in which the rank that gave up tears down before the late
    rank enters, as a survivor of a lost peer does: rank 1 skips a B1
    call that rank 0 makes, rank 0 raises and takes its ring states down
    locally (``release_local``), then rank 1 makes the call late and must
    raise ``RingTimeout`` in turn (at p = 2 its REDUCE reads rank 0's
    error word through its mapping of rank 0's kept block).  Then every
    rank takes its states down and frees the kept blocks after a
    barrier; none may be left."""
    me = comm.rank
    cid = TEARDOWN_COLLECTIVE_ID
    _ring_call(cr, comm, "allreduce", x, cid)
    torch.cuda.synchronize()
    dist.barrier()
    old_timeout = cr.RING_TIMEOUT_S
    cr.RING_TIMEOUT_S = STALL_TIMEOUT_S

    def attempt():
        t0 = time.monotonic()
        try:
            _ring_call(cr, comm, "allreduce", x, cid)
            rec = {"raised": None}
        except cr.RingError as e:
            rec = {"raised": type(e).__name__, "message": str(e)}
        rec["seconds"] = time.monotonic() - t0
        return rec

    try:
        rec = {}
        if me == 0:
            rec["gave_up"] = attempt()
            cr.release_local()
            rec["kept_blocks"] = len(cr._retired)
        dist.barrier()
        if me == 1:
            rec["late"] = attempt()
        dist.barrier()
        cr.release_local()
        dist.barrier()
        cr.free_retired()
        rec["left"] = len(cr._states) + len(cr._retired)
        recs = [None] * comm.size
        dist.all_gather_object(recs, rec)
    finally:
        cr.RING_TIMEOUT_S = old_timeout
    return {"gave_up": recs[0]["gave_up"],
            "kept_blocks": recs[0]["kept_blocks"], "late": recs[1]["late"],
            "left": [r["left"] for r in recs]}


def teardown_ok(rec: dict) -> bool:
    """Both stalled calls of :func:`_teardown_stall` raised ``RingTimeout``
    within five deadlines, rank 0 kept its blocks, and no state is left."""
    return (all(rec[k]["raised"] == "RingTimeout"
                and rec[k]["seconds"] < 5 * STALL_TIMEOUT_S
                for k in ("gave_up", "late"))
            and rec["kept_blocks"] > 0 and not any(rec["left"]))


def _counts(cr) -> dict:
    return {"ring_allreduce": cr.ring_allreduce_launches,
            "ring_reduce_scatter": cr.ring_reduce_scatter_launches,
            "ring_allgather": cr.ring_allgather_launches}


def stalls_ok(stalls: dict) -> bool:
    """For every kind in ``stalls`` ({kind: {"stall": ..., "late": ...}}),
    both stalled rings raised within five deadlines, and the late STAGE
    left the aborted word where the abort put it."""
    return bool(stalls) and all(
        s["stall"].get("raised")
        and s["stall"]["seconds"] < 5 * STALL_TIMEOUT_S
        and s["late"].get("raised")
        and s["late"]["seconds"] < 5 * STALL_TIMEOUT_S
        and s["late"].get("kept_past_every_step")
        for s in stalls.values())


def _ops_by_call(ranges, device_ops) -> list:
    """The device operations (name, start, end) whose start lies in each
    call's host range (every call waits for its own end, so no call's
    operations run into the next's), in order of start."""
    ops = sorted(device_ops, key=lambda o: o[1])
    return [[o for o in ops if start <= o[1] <= end] for start, end in ranges]


def _union(ops) -> float:
    """µs covered by the operations' intervals (sorted by start)."""
    busy, reach = 0.0, None
    for _, s, e in ops:
        if reach is None or s >= reach:
            busy += e - s
            reach = e
        elif e > reach:
            busy += e - reach
            reach = e
    return busy


def split_calls(ranges, device_ops) -> list:
    """Each call's device operations from a trace: ``ranges`` are the calls'
    host (start, end) µs, ``device_ops`` (name, start, end) µs on the same
    clock.  Per call: the operations by name, their count, busy µs (the
    union of their intervals), the gaps between them (first start to last
    end, less the busy time) and the lead from the call's start to its
    first operation."""
    out = []
    for (start, _), mine in zip(ranges, _ops_by_call(ranges, device_ops)):
        names: dict = {}
        for name, _, _ in mine:
            names[name] = names.get(name, 0) + 1
        busy = _union(mine)
        span = (mine[-1][2] - mine[0][1]) if mine else 0.0
        out.append({"ops": len(mine), "names": names, "busy_us": busy,
                    "gap_us": span - busy,
                    "lead_us": (mine[0][1] - start) if mine else None})
    return out


def across_ranks(traces) -> list:
    """Each call seen from every rank at once: ``traces`` holds each rank's
    (ranges, device_ops) on one clock.  Per call: the window from the first
    rank's start to the last rank's end, the µs in it when some rank's
    operation ran on the card (``busy_any_us``) and when none did
    (``idle_us``: switches between the ranks' contexts, stream waits, and
    hosts not yet at the call), the skew between the ranks' starts and, for
    the one-shot kernels, the handoff from the last STAGE's end to the
    first REDUCE's or GATHER's start and the tail from the last one's end
    to the last rank's return."""
    per_rank = [(ranges, _ops_by_call(ranges, ops)) for ranges, ops in traces]
    out = []
    for i in range(min(len(r) for r, _ in per_rank)):
        starts = [r[i][0] for r, _ in per_rank]
        ends = [r[i][1] for r, _ in per_rank]
        ops = sorted((o for _, calls in per_rank for o in calls[i]),
                     key=lambda o: o[1])
        window = max(ends) - min(starts)
        busy = _union(ops)
        rec = {"window_us": window, "busy_any_us": busy,
               "idle_us": window - busy, "skew_us": max(starts) - min(starts)}
        stages = [o for o in ops if "stage_kernel" in o[0]]
        after = [o for o in ops
                 if "reduce_kernel" in o[0] or "gather_kernel" in o[0]]
        if len(stages) == len(after) == len(per_rank):
            rec["handoff_us"] = (min(o[1] for o in after)
                                 - max(o[2] for o in stages))
            rec["tail_us"] = max(ends) - max(o[2] for o in after)
        out.append(rec)
    return out


def _median_call(calls: list, keys) -> dict:
    return {k: statistics.median(c[k] for c in calls) for k in keys}


def breakdown_main(seed: int) -> dict:
    """One rank of the breakdown (spawned): at p = 2 the 43 rings of a
    ResNet-50 step, and at p = 2 and 4 one B1 ring and one B3 allgather of
    n = BIG_N."""
    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import cuda_ring as cr
    from torchmpi_tpu_torch.runtime import lifecycle
    from torchmpi_tpu_torch.runtime.communicator import stack

    lifecycle.start()
    try:
        comm = stack.world()
        p, me = comm.size, comm.rank
        cases = {"one_ring": ("allreduce", [BIG_N], [None], False),
                 "allgather": ("allgather", [BIG_N], [None], False)}
        if p == 2:
            sizes = resnet50_ring_sizes()
            cases = {"resnet50_step": (
                "allreduce", sizes, [cr.CALLER_COLLECTIVE_ID_BASE + i % 8
                                     for i in range(len(sizes))], True),
                **cases}
        return {"rank": me, "p": p,
                "cases": {name: _breakdown_case(torch, dist, cr, comm, *case,
                                                seed=seed + i)
                          for i, (name, case) in enumerate(cases.items())}}
    finally:
        lifecycle.stop()


def _breakdown_case(torch, dist, cr, comm, kind, sizes, ids, mean,
                    seed) -> dict:
    """The per-call breakdown of one round of ``kind`` calls (see the module
    docstring); every rank makes the same calls, rank 0 reports.  The
    allgather goes through ``ring_allgather``'s own id, as on an older
    tree."""
    p, me = comm.size, comm.rank
    mine = [_inputs(torch, {"dtype": "float32", "n": n}, p, seed + i)[me]
            for i, n in enumerate(sizes)]
    waited = [0.0]
    wait = cr._wait

    def timed_wait(event, seconds):
        t0 = time.perf_counter()
        try:
            return wait(event, seconds)
        finally:
            waited[0] += time.perf_counter() - t0

    def call(i):
        if kind == "allgather":
            return cr.ring_allgather(comm, mine[i])
        return cr.inner_ring_allreduce(mine[i], p, mean=mean,
                                       collective_id=ids[i], comm=comm)

    cr._wait = timed_wait
    try:
        for _ in range(2):
            for i in range(len(sizes)):
                call(i)
        torch.cuda.synchronize()
        dist.barrier(group=comm.group)
        rounds = []
        for _ in range(BREAKDOWN_ROUNDS):
            calls = []
            for i in range(len(sizes)):
                waited[0] = 0.0
                t0 = time.perf_counter()
                call(i)
                e2e = time.perf_counter() - t0
                calls.append({"e2e_us": e2e * 1e6,
                              "host_us": (e2e - waited[0]) * 1e6})
            rounds.append(calls)
        torch.cuda.synchronize()
        traced, joint = _profiled_rounds(torch, dist, comm, call, len(sizes))
        torch.cuda.synchronize()
        dist.barrier(group=comm.group)
    finally:
        cr._wait = wait
    if me != 0:
        return {}
    flat = [c for r in rounds for c in r]
    per_call = _median_call(flat, ("e2e_us", "host_us"))
    per_round = {k: statistics.median(sum(c[k] for c in r) for r in rounds)
                 / 1e3 for k in ("e2e_us", "host_us")}
    out = {"kind": kind, "p": p, "rings": len(sizes), "elements": sum(sizes),
           "per_call": per_call,
           "per_round_ms": {"e2e": per_round["e2e_us"],
                            "host": per_round["host_us"]}}
    dev = [c for c in traced if c["ops"]]
    out["trace_has_device_time"] = bool(dev)
    if dev:
        n = len(sizes)
        out["per_call"].update(_median_call(
            dev, ("ops", "busy_us", "gap_us", "lead_us")))
        out["per_round_ms"].update({
            k: statistics.median(
                sum(c[key] for c in traced[r * n:(r + 1) * n])
                for r in range(PROFILED_ROUNDS)) / 1e3
            for k, key in (("device_busy", "busy_us"), ("gaps", "gap_us"))})
        out["per_round_ms"]["device_ops"] = sum(
            c["ops"] for c in traced[:n])
        names: dict = {}
        for c in traced[:n]:
            for k, v in c["names"].items():
                names[k] = names.get(k, 0) + v
        out["device_ops_by_name_per_round"] = names
        keys = [k for k in ("window_us", "busy_any_us", "idle_us", "skew_us",
                            "handoff_us", "tail_us") if k in joint[0]]
        out["across_ranks_per_call"] = _median_call(joint, keys)
        out["across_ranks_per_round_ms"] = {
            k[:-3]: statistics.median(
                sum(c[k] for c in joint[r * n:(r + 1) * n])
                for r in range(PROFILED_ROUNDS)) / 1e3 for k in keys}
    return out


def _profiled_rounds(torch, dist, comm, call, n: int) -> tuple:
    """PROFILED_ROUNDS rounds of the n calls under ``torch.profiler`` on
    every rank, each started before the ranks meet at a barrier (so no
    peer's ring waits on a profiler's start).  Returns, on rank 0, its own
    calls' device operations (:func:`split_calls`) and every call seen
    across the ranks (:func:`across_ranks`), the ranks' traces put on one
    clock by the wall time stamped at each call's start; on the other
    ranks two empty lists."""
    from torch.profiler import ProfilerActivity, profile, record_function

    stamps = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dist.barrier(group=comm.group)
        for _ in range(PROFILED_ROUNDS):
            for i in range(n):
                with record_function(f"ring_call_{i}"):
                    stamps.append(time.time_ns() / 1e3)
                    call(i)
    ranges, device_ops = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.name.startswith("ring_call_"):
            # The range on the host; its copy on the device's track is
            # an annotation, not an operation.
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges.append(span)
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            device_ops.append((ev.name, *span))
    ranges.sort()
    shift = statistics.median(w - r[0] for w, r in zip(stamps, ranges))
    trace = ([(a + shift, b + shift) for a, b in ranges],
             [(name, a + shift, b + shift) for name, a, b in device_ops])
    traces = [None] * comm.size
    dist.all_gather_object(traces, trace, group=comm.group)
    if comm.rank != 0:
        return [], []
    return split_calls(ranges, device_ops), across_ranks(traces)


def breakdown() -> list:
    """The breakdown at p = 2 and p = 4: rank 0's records."""
    from torchmpi_tpu_torch import _build
    from torchmpi_tpu_torch.runtime import launch

    _build.build("ring")
    return [launch.spawn(p, breakdown_main, (0,), timeout_s=900)[0]
            for p in (2, 4)]


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
    ap.add_argument("--breakdown", action="store_true",
                    help="take B1's and B3's calls apart instead (p = 2 "
                         "and 4)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ring_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.breakdown:
        for res in breakdown():
            for name, rec in res["cases"].items():
                print(json.dumps({"breakdown": name, **rec}), flush=True)
        return 0
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
    print(json.dumps({"back_to_back": [r["back_to_back"] for r in results]}),
          flush=True)
    ok = ok and all(c["bitwise_equal"] for r in results
                    for calls in r["back_to_back"].values() for c in calls)
    stalls = results[0]["stalls"]
    print(json.dumps({"collectives_launches": results[0]["collectives_launches"],
                      "stalls": stalls}), flush=True)
    ok = ok and stalls_ok(stalls)
    print(json.dumps({"teardown": results[0]["teardown"]}), flush=True)
    ok = ok and teardown_ok(results[0]["teardown"])
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
