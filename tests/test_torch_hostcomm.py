"""The port's host plane (``collectives/hostcomm.py`` over its copy of
``_native/hostcomm.cpp``) against the JAX package's, ranks as threads in one
process on loopback, as ``tests/test_hostcomm.py`` runs them.

* The cases of ``tests/test_hostcomm.py`` at p in {2, 4}: every result is
  held bit for bit against the JAX package's ``HostCommunicator`` run on
  the same bytes (the same C++), with torch CPU tensors on the port's side,
  bf16, f16 and i8 included; random data from ``numpy.random.RandomState``.
* One mixed ring: ranks 0 and 2 the JAX package's, ranks 1 and 3 the
  port's; its allreduce and broadcast equal a JAX ring's bit for bit (the
  wire protocol).
* ``HierarchicalHostCommunicator`` over 2x2 and 3+1 groups against JAX's,
  bit for bit, and the selector's host column through it (JAX's
  ``test_selector_routes_hierarchy``, ``test_selector_bf16_mean_allowed``
  and ``test_selector_host_allgather_and_barrier``).
* The typed errors: a peer that never enters raises ``HostcommTimeout``
  within the ring's ``io_deadline_ms``; a missing peer or a bad port fails
  the wiring with ``HostcommError``; a call from the ring's own worker
  thread raises instead of deadlocking.

Every ring here sets ``io_deadline_ms``, so no wait can hang the run.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.collectives import hostcomm as thc
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime.failure import (HostcommError,
                                                HostcommTimeout)

DEADLINE_MS = 20000      # far above any op here; a hang fails in 20 s
WIRE_MS = 60000


def _jhc():
    from torchmpi_tpu.collectives import hostcomm as jhc

    return jhc


def _ring(cls, size, **kw):
    """A loopback ring of ``size`` ranks of ``cls`` (one class, or one per
    rank), each wired on its own thread."""
    classes = cls if isinstance(cls, (list, tuple)) else [cls] * size
    eps = [("127.0.0.1", p) for p in thc.free_ports(size)]
    kw = {"timeout_ms": WIRE_MS, "io_deadline_ms": DEADLINE_MS, **kw}
    with ThreadPoolExecutor(max_workers=size) as ex:
        futs = [ex.submit(c, r, size, eps, **kw)
                for r, c in enumerate(classes)]
        return [f.result(timeout=120) for f in futs]


def _run_all(comms, fn):
    with ThreadPoolExecutor(max_workers=len(comms)) as ex:
        futs = [ex.submit(fn, c, r) for r, c in enumerate(comms)]
        return [f.result(timeout=120) for f in futs]


@pytest.fixture(scope="module", params=[2, 4])
def rings(request):
    """A port ring and a JAX ring of the same size."""
    p = request.param
    t = _ring(thc.HostCommunicator, p)
    j = _ring(_jhc().HostCommunicator, p)
    yield p, t, j
    for c in t + j:
        c.close()


# ------------------------------------------------------------- the same bytes

def _as_np(t: torch.Tensor) -> np.ndarray:
    """A numpy array with the tensor's bytes (bf16 as ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def _inputs(p, n, dtype, seed, kind="rand"):
    rng = np.random.RandomState(seed)
    if kind == "rand" and dtype.is_floating_point:
        vals = rng.randn(p, n) * 3
    elif dtype == torch.int8:
        vals = rng.randint(-60, 60, (p, n))
    else:
        vals = rng.randint(-1000, 1000, (p, n))
    return [torch.tensor(vals[r], dtype=torch.float64).to(dtype)
            for r in range(p)]


def _both(rings, op, xs):
    """op(comm, buffer, rank) on each rank of both rings, each rank's
    buffer a copy of xs[rank]; returns both rings' outputs."""
    _, t, j = rings
    tout = _run_all(t, lambda c, r: op(c, xs[r].clone(), r))
    jout = _run_all(j, lambda c, r: op(c, _as_np(xs[r]), r))
    return tout, jout


def _same(tout, jout):
    for r, (a, b) in enumerate(zip(tout, jout)):
        if isinstance(a, tuple):
            _same(a, b)
            continue
        assert np.array_equal(_bytes(a), _bytes(b)), f"rank {r}"


DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64,
          torch.bfloat16, torch.int8, torch.float16]


def _ar(opname):
    def op(c, a, r):
        c.allreduce(a, op=opname)
        return a
    return op


@pytest.mark.parametrize("opname", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_allreduce_equals_jax(rings, dtype, opname):
    """1000 elements (not a multiple of p: the remainder chunks)."""
    xs = _inputs(rings[0], 1000, dtype, seed=len(str(dtype)) + len(opname))
    _same(*_both(rings, _ar(opname), xs))


def test_allreduce_fewer_elements_than_ranks(rings):
    xs = _inputs(rings[0], 1, torch.float32, seed=1)
    _same(*_both(rings, _ar("sum"), xs))


def test_int8_sum_saturates_as_jax(rings):
    p = rings[0]
    xs = [torch.full((17,), 100, dtype=torch.int8)] * p
    tout, jout = _both(rings, _ar("sum"), xs)
    _same(tout, jout)
    assert all(int(o.max()) == 127 for o in tout)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_broadcast_equals_jax(rings, dtype):
    p = rings[0]
    xs = _inputs(p, 257, dtype, seed=3)
    for root in sorted({0, p - 1}):
        tout, jout = _both(
            rings, lambda c, a, r, root=root: c.broadcast(a, root=root), xs)
        _same(tout, jout)
        assert all(torch.equal(o, xs[root]) for o in tout)


@pytest.mark.parametrize("opname", ["sum", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64], ids=str)
def test_reduce_equals_jax(rings, dtype, opname):
    """Root gets the reduction; every other rank's buffer is untouched."""
    p = rings[0]
    xs = _inputs(p, 777, dtype, seed=5)
    tout, jout = _both(rings, lambda c, a, r: c.reduce(a, op=opname,
                                                       root=p - 1), xs)
    _same(tout, jout)
    for r in range(p - 1):
        assert torch.equal(tout[r], xs[r])


def test_chunk_pipelined_reduce_and_allreduce(rings):
    """Above the small cutoff the rings move buffer-size pieces (the same
    knobs on both sides)."""
    from torchmpi_tpu.runtime import config as jconfig

    knobs = dict(small_allreduce_size_cpu=256, min_buffer_size_cpu=512,
                 max_buffer_size_cpu=1024)
    jconfig.reset(**knobs)
    tconfig.reset(**knobs)
    try:
        xs = _inputs(rings[0], 5000, torch.float32, seed=7)
        _same(*_both(rings, lambda c, a, r: c.reduce(a, root=0), xs))
        _same(*_both(rings, _ar("sum"), xs))
    finally:
        jconfig.reset()
        tconfig.reset()


def test_default_geometry_at_100000_elements(rings):
    """nbytes // 3 is not a whole number of elements: the piece is."""
    xs = _inputs(rings[0], 100000, torch.float32, seed=9)
    _same(*_both(rings, _ar("sum"), xs))


@pytest.mark.parametrize("n", [1, 1000, 100000, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
def test_chunk_bytes_equal_jax(n, dtype):
    x = torch.zeros(n, dtype=dtype)
    for key in ("small_allreduce_size_cpu", None):
        assert thc._chunk_bytes(x, key) == _jhc()._chunk_bytes(_as_np(x), key)


def test_sendreceive_equals_jax(rings):
    p = rings[0]
    xs = _inputs(p, 123, torch.float32, seed=11)
    pairs = [(0, p - 1)] + ([(p - 1, 1)] if p > 2 else [])  # a wrapped route
    for src, dst in pairs:
        tout, jout = _both(rings, lambda c, a, r, s=src, d=dst:
                           c.sendreceive(a, s, d), xs)
        _same(tout, jout)
        assert torch.equal(tout[dst], xs[src])


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16], ids=str)
def test_allgather_equals_jax(rings, dtype):
    """Unequal sizes: the output resizes, in rank order."""
    p = rings[0]
    xs = [x[:r + 3] for r, x in enumerate(_inputs(p, 8, dtype, seed=13))]
    tout, jout = _both(rings, lambda c, a, r: c.allgather(a), xs)
    _same(tout, jout)
    assert torch.equal(tout[0], torch.cat(xs))


def test_barrier_and_async_forms_equal_jax(rings):
    p = rings[0]
    xs = _inputs(p, 200, torch.float32, seed=15)
    gs = _inputs(p, 5, torch.float32, seed=16)

    def work(c, a, r):
        own = (lambda v: v.clone()) if isinstance(a, torch.Tensor) else _as_np
        c.barrier()
        h1 = c.reduce_async(a, op="sum", root=0)
        h2 = c.allgather_async(own(gs[r]))
        s = own(xs[r])       # not a copy of a: h1 may be writing a
        h3 = c.allreduce_async(s)
        h1.wait()
        h3.wait()
        b = a.copy() if isinstance(a, np.ndarray) else a.clone()
        c.broadcast_async(b, root=p - 1).wait()
        c.sendreceive_async(b, 0, p - 1).wait()
        return a, h2.wait(), s, b

    _same(*_both(rings, work, xs))


def test_sync_op_queues_behind_async(rings):
    """A sync collective issued while an async one is in flight runs after
    it on the ring's one worker thread: both results are right."""
    p, t, _ = rings
    n = 1 << 14
    a_async = [torch.full((n,), float(r)) for r in range(p)]
    a_sync = [torch.full((n,), float(10 * r)) for r in range(p)]
    handles = [c.allreduce_async(a) for c, a in zip(t, a_async)]
    results = [None] * p

    def sync_op(i):
        results[i] = t[i].allreduce(a_sync[i])

    threads = [threading.Thread(target=sync_op, args=(i,)) for i in range(p)]
    for th in threads:
        th.start()
    for h in handles:
        h.wait()
    for th in threads:
        th.join(timeout=60)
    s = float(sum(range(p)))
    assert all(torch.equal(a, torch.full((n,), s)) for a in a_async)
    assert all(torch.equal(r, torch.full((n,), 10 * s)) for r in results)


def test_validation(rings):
    c = rings[1][0]
    with pytest.raises(ValueError, match="contiguous"):
        c.allreduce(torch.zeros(8, 8)[:, ::2])
    with pytest.raises(ValueError, match="dtype"):
        c.allreduce(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CPU"):
        c.allreduce(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="op"):
        c.allreduce(torch.zeros(4), op="mean")
    with pytest.raises(ValueError, match="root"):
        c.broadcast(torch.zeros(4), root=rings[0])


# ----------------------------------------------------------- the mixed ring

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_mixed_ring_speaks_the_jax_wire_protocol(dtype):
    """Ranks 0 and 2 the JAX package's, 1 and 3 the port's: allreduce and
    broadcast equal a JAX ring's bit for bit."""
    jcls, tcls = _jhc().HostCommunicator, thc.HostCommunicator
    mixed = _ring([jcls, tcls, jcls, tcls], 4)
    pure = _ring(jcls, 4)
    xs = _inputs(4, 70000, dtype, seed=17)

    def work(c, r):
        a = _as_np(xs[r]) if r % 2 == 0 or c in pure else xs[r].clone()
        c.allreduce(a)
        b = _as_np(xs[r]) if r % 2 == 0 or c in pure else xs[r].clone()
        c.broadcast(b, root=1)
        return a, b

    try:
        _same(_run_all(mixed, work), _run_all(pure, work))
    finally:
        for c in mixed + pure:
            c.close()


# -------------------------------------------------------------- the hierarchy

def _hier(module, groups):
    n = sum(len(g) for g in groups)
    intra = [("127.0.0.1", p) for p in thc.free_ports(n)]
    inter = [("127.0.0.1", p) for p in thc.free_ports(len(groups))]
    with ThreadPoolExecutor(max_workers=n) as ex:
        futs = [ex.submit(module.HierarchicalHostCommunicator, r, groups,
                          intra, inter, timeout_ms=WIRE_MS,
                          io_deadline_ms=DEADLINE_MS) for r in range(n)]
        return [f.result(timeout=120) for f in futs]


@pytest.fixture(scope="module", params=[[[0, 1], [2, 3]], [[0, 1, 2], [3]]],
                ids=["2x2", "3+1"])
def hier(request):
    t = _hier(thc, request.param)
    j = _hier(_jhc(), request.param)
    yield request.param, t, j
    for c in t + j:
        c.close()


def test_hierarchy_equals_jax(hier):
    groups, t, j = hier
    n = len(t)
    xs = _inputs(n, 257, torch.float32, seed=19, kind="int")
    bs = _inputs(n, 65, torch.bfloat16, seed=20)

    def work(c, r):
        own = (lambda v: v.clone()) if isinstance(c, thc.HierarchicalHostCommunicator) \
            else _as_np
        outs = []
        for op in ("sum", "max"):
            a = own(xs[r])
            outs.append(c.allreduce(a, op=op))
        outs.append(c.allreduce(own(bs[r])))
        for root in (0, n - 1, 1):
            outs.append(c.broadcast(own(xs[r]), root=root))
            outs.append(c.reduce(own(xs[r]), root=root))
        outs.append(c.allgather(own(xs[r])[:r + 1]))
        outs.append(c.sendreceive(own(xs[r]), src=1, dst=n - 1))
        c.barrier()
        return tuple(outs)

    tout, jout = _run_all(t, work), _run_all(j, work)
    _same(tout, jout)
    total = torch.stack(xs).sum(0)
    assert all(torch.equal(o[0], total) for o in tout)


def _selector_cell(fn_name, hier, dtype, op):
    from torchmpi_tpu.collectives import selector as jsel

    from torchmpi_tpu_torch.collectives import selector as tsel

    groups, t, j = hier
    n = len(t)
    xs = _inputs(n, 5, dtype, seed=21, kind="int")

    def run(sel, comms, wrap):
        def work(c, r):
            class _C:
                host_ring = c
            kw = {} if op is None else {"op": op}
            out = getattr(sel, fn_name)("allgather" if op is None
                                        else "allreduce")(_C(), wrap(xs[r]),
                                                          **kw)
            sel._hostcomm_barrier(_C())
            return out
        return _run_all(comms, work)

    tout = run(tsel, t, lambda v: v.clone())
    _same(tout, run(jsel, j, _as_np))
    return tout, xs


def test_selector_routes_hierarchy_as_jax(hier):
    tout, xs = _selector_cell("_hostcomm_fn", hier, torch.float32, "mean")
    want = torch.stack(xs).sum(0) / len(xs)
    assert all(torch.equal(o, want) for o in tout)


def test_selector_bf16_mean_allowed_as_jax(hier):
    tout, _ = _selector_cell("_hostcomm_fn", hier, torch.bfloat16, "mean")
    assert all(o.dtype == torch.bfloat16 for o in tout)


def test_selector_host_allgather_and_barrier_as_jax(hier):
    groups = hier[0]
    tout, xs = _selector_cell("_hostcomm_fn", hier, torch.float32, None)
    want = torch.cat([xs[r] for g in groups for r in g])
    assert all(torch.equal(o, want) for o in tout)


def test_selector_host_cell_refuses_an_integer_mean(hier):
    from torchmpi_tpu_torch.collectives import selector as tsel

    class _C:
        host_ring = hier[1][0]

    with pytest.raises(TypeError, match="float payload"):
        tsel._hostcomm_fn("allreduce")(_C(), torch.ones(3, dtype=torch.int32),
                                       op="mean")
    with pytest.raises(ValueError, match="groups"):
        tsel._hostcomm_fn("allreduce")(_C(), torch.ones(3), groups=((0, 1),))


# -------------------------------------------------------------- typed errors

def test_a_peer_that_never_enters_times_out():
    """Rank 1 never calls: rank 0's allreduce raises HostcommTimeout within
    the ring's deadline, well before the progress warning."""
    c0, c1 = _ring(thc.HostCommunicator, 2, io_deadline_ms=500,
                   io_timeout_ms=60000)
    try:
        t0 = time.perf_counter()
        with pytest.raises(HostcommTimeout):
            c0.allreduce(torch.ones(1 << 16))
        assert time.perf_counter() - t0 < 10.0
        # The ring is poisoned: the next call fails at once.
        with pytest.raises(HostcommError):
            c0.allreduce(torch.ones(4))
    finally:
        c0.close()
        c1.close()


def test_a_missing_peer_fails_the_wiring_fast():
    p1, p2 = thc.free_ports(2)
    t0 = time.perf_counter()
    with pytest.raises(HostcommError, match="failed to wire"):
        thc.HostCommunicator(0, 2, [("127.0.0.1", p1), ("127.0.0.1", p2)],
                             timeout_ms=1500, io_deadline_ms=1000)
    assert time.perf_counter() - t0 < 10.0


def test_an_out_of_range_port_is_refused():
    with pytest.raises(HostcommError, match="failed to wire"):
        thc.HostCommunicator(0, 2, [("127.0.0.1", 70000),
                                    ("127.0.0.1", 70001)], timeout_ms=500,
                             io_deadline_ms=1000)


def test_self_deadlock_guard():
    port, = thc.free_ports(1)
    with thc.HostCommunicator(0, 1, [("127.0.0.1", port)],
                              io_deadline_ms=1000) as hc:
        x = torch.ones(4)
        assert hc.allreduce(x) is x
        fut = hc._pool.submit(hc.barrier)
        with pytest.raises(RuntimeError, match="self-deadlock"):
            fut.result(timeout=10)
