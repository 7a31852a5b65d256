"""The port's communicators, eager collectives, selector, bucketing and tree
order against the JAX package's.

* Communicator split tables (groups, their count, size) equal JAX's for
  n = 2..8 ranks and several key rules.
* The eager surface over a gloo world (one pool of 4 spawned ranks for the
  module; p = 2 runs on ranks 0-1) equals ``torchmpi_tpu.collectives.eager``
  on p virtual devices row by row, exactly: the values are small integers in
  f32, so every summation order gives the same sum.
* The async forms (``*_async``, handles registered in flight) and
  ``sendreceive`` give the fill = rank algebra at p = 4, directly and
  through the selector's async cell with the ring knob on and off.
* The selector's cells equal JAX's ``preferences("tpu", "singlenode",
  mode)`` with the ring knob on and off, every collective resolves in both
  modes to the executable JAX resolves (by name), and the small-message
  rule makes JAX's choices.
* Bucket plans and ready-order dispatch plans equal
  ``nn.bucketing.plan_buckets``' and ``plan_ready_order``'s, per-bucket
  squared norms equal ``bucket_sq_norms``' to f32 rounding (1e-6
  relative: another summation order), and the port's tree order equals
  ``jax.tree.flatten``'s.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.collectives import eager as teager
from torchmpi_tpu_torch.collectives import selector as tselector
from torchmpi_tpu_torch.nn import bucketing as tbucketing
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime.communicator import (Communicator,
                                                     CommunicatorStack)
from torchmpi_tpu_torch.utils import tree as ttree


@pytest.fixture()
def both_configs():
    from torchmpi_tpu.runtime import config as jconfig

    jconfig.reset()
    tconfig.reset()
    yield jconfig
    jconfig.reset()
    tconfig.reset()


# --------------------------------------------------------------- communicators

KEY_RULES = {
    "halves": lambda r, n: r // max(1, n // 2),
    "parity": lambda r, n: r % 2,
    "threes": lambda r, n: r // 3,
    "first_three": lambda r, n: int(r < 3),
    "same": lambda r, n: 0,
    "reversed": lambda r, n: n - r,
}


def _table(c):
    return (c.group_ranks, c.size, c.num_groups)


@pytest.mark.parametrize("n", range(2, 9))
@pytest.mark.parametrize("rule", list(KEY_RULES))
def test_split_tables_match_jax(both_configs, rule, n):
    import jax

    from torchmpi_tpu.runtime.communicator import Communicator as JComm

    keys = [str(KEY_RULES[rule](r, n)) for r in range(n)]
    j = JComm(jax.devices()[:n], keys)
    t = Communicator(range(n), keys, my_rank=0)
    assert _table(t) == (j.group_ranks, j.size, j.num_groups)


def test_stack_push_refines_like_jax(both_configs):
    import jax

    from torchmpi_tpu.runtime.communicator import (Communicator as JComm,
                                                   CommunicatorStack as JStack)

    js, ts = JStack(), CommunicatorStack()
    js.reset(JComm(jax.devices()[:8]))
    ts.reset(Communicator(range(8), my_rank=3))
    for keys in (lambda r: r // 4, lambda r: r % 2):
        assert js.push(keys) == ts.push(keys)
        j = js.current()
        assert _table(ts.current()) == (j.group_ranks, j.size, j.num_groups)
    assert ts.current().rank == 3
    assert ts.world().size == 8


def test_communicator_errors():
    with pytest.raises(ValueError):
        Communicator([])
    with pytest.raises(ValueError, match="one key"):
        Communicator(range(3), ["a"])
    with pytest.raises(RuntimeError, match="not in"):
        Communicator([0, 1], my_rank=5).rank  # noqa: B018


# ----------------------------------------------------------- eager over gloo

def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    # One intra-op thread a rank: the cases move small tensors, and the
    # tier-1 run shares the host's cores with other test workers.
    torch.set_num_threads(1)
    lifecycle.start(device="cpu")


def _eager_job(p, name, kwargs, arrays):
    import torch.distributed as dist

    comm = Communicator(range(p), my_rank=dist.get_rank())
    comm.group  # noqa: B018 - new_group is collective over the world
    me = dist.get_rank()
    if me >= p:
        return None
    x = torch.from_numpy(arrays[me].copy())
    if name == "allreduce_scalar":
        return teager.allreduce_scalar(comm, float(arrays[me][0]), **kwargs)
    if name == "barrier":
        teager.barrier(comm)
        return "ok"
    return getattr(teager, name)(comm, x, **kwargs).numpy()


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup_cpu)
    yield pl
    pl.close()


EAGER_CASES = [
    ("allreduce", {"op": "sum"}),
    ("allreduce", {"op": "mean"}),
    ("allreduce", {"op": "max"}),
    ("allreduce", {"op": "min"}),
    ("broadcast", {"root": 1}),
    ("reduce", {"root": 1, "op": "sum"}),
    ("reduce", {"root": 0, "op": "max"}),
    ("allgather", {}),
    ("reduce_scatter", {"op": "sum"}),
    ("reduce_scatter", {"op": "mean"}),
    ("allreduce_scalar", {"op": "sum"}),
]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name,kwargs", EAGER_CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in EAGER_CASES])
def test_eager_rows_equal_jax(pool, p, name, kwargs):
    import jax

    from torchmpi_tpu.collectives import eager as jeager
    from torchmpi_tpu.runtime.communicator import Communicator as JComm

    rng = np.random.RandomState(p * 31 + len(name))
    vals = rng.randint(-50, 50, size=(p, 12)).astype(np.float32)
    got = pool.run(_eager_job, p, name, kwargs, vals)
    comm = JComm(jax.devices()[:p])
    if name == "allreduce_scalar":
        ref = jeager.allreduce_scalar(comm, list(vals[:, 0]), dtype=np.float64,
                                      **kwargs)
    else:
        ref = jeager.to_numpy(getattr(jeager, name)(
            comm, jeager.shard(comm, vals), **kwargs))
    for r in range(p):
        np.testing.assert_array_equal(np.asarray(got[r]), np.asarray(ref[r]))


def test_barrier_and_later_forms(pool):
    assert pool.run(_eager_job, 4, "barrier", {}, np.zeros((4, 1))) == ["ok"] * 4
    for fn in (teager.allgatherv, teager.alltoall):
        with pytest.raises(NotImplementedError, match="later slice"):
            fn(None, None)
    with pytest.raises(NotImplementedError, match="later slice"):
        teager.allreduce(None, torch.zeros(2), groups=((0, 1),))


def _async_job(case, prefer_rings):
    """One rank's result of ``case`` on x = fill(rank) at p = 4, and how
    many handles it left in flight before and after the wait."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime import handles

    tconfig.reset(use_pallas_collectives=prefer_rings,
                  small_allreduce_size_gpu=8)
    try:
        comm = Communicator(range(4), my_rank=dist.get_rank())
        x = torch.full((12,), float(comm.rank))
        handles.sync_all()
        if case == "sendreceive":
            return teager.sendreceive(comm, x, src=1, dst=3).numpy(), 0, 0
        name, kwargs = {
            "allreduce_async-sum": ("allreduce_async", {"op": "sum"}),
            "allreduce_async-mean": ("allreduce_async", {"op": "mean"}),
            "broadcast_async": ("broadcast_async", {"root": 1}),
            "reduce_async": ("reduce_async", {"root": 2, "op": "sum"}),
            "allgather_async": ("allgather_async", {}),
            "sendreceive_async": ("sendreceive_async", {"src": 1, "dst": 3}),
            "selector-allreduce": ("allreduce", {"op": "mean"}),
            "selector-reduce_scatter": ("reduce_scatter", {"op": "sum"}),
            "selector-allgather": ("allgather", {}),
        }[case]
        if case.startswith("selector-"):
            from torchmpi_tpu_torch.collectives import selector

            h = selector.resolve(name, mode="async")(comm, x, **kwargs)
        else:
            h = getattr(teager, name)(comm, x, **kwargs)
        pending = len(handles.in_flight)
        out = h.wait()
        assert h.done and h.wait() is out
        handles.sync_all()
        return out.numpy(), pending, len(handles.in_flight)
    finally:
        tconfig.reset()


ASYNC_WANT = {
    "allreduce_async-sum": lambda r: np.full(12, 6.0),
    "allreduce_async-mean": lambda r: np.full(12, 1.5),
    "broadcast_async": lambda r: np.full(12, 1.0),
    "reduce_async": lambda r: np.full(12, 6.0 if r == 2 else float(r)),
    "allgather_async": lambda r: np.repeat(np.arange(4.0), 12).reshape(4, 12),
    "sendreceive_async": lambda r: np.full(12, 1.0 if r == 3 else float(r)),
    "sendreceive": lambda r: np.full(12, 1.0 if r == 3 else float(r)),
    "selector-allreduce": lambda r: np.full(12, 1.5),
    "selector-reduce_scatter": lambda r: np.full(3, 6.0),
    "selector-allgather": lambda r: np.repeat(np.arange(4.0),
                                              12).reshape(4, 12),
}


# The ring knob changes only what the selector resolves.
ASYNC_CASES = [(c, False) for c in ASYNC_WANT] + [
    (c, True) for c in ASYNC_WANT if c.startswith("selector-")]


@pytest.mark.parametrize("case,prefer_rings", ASYNC_CASES,
                         ids=[f"{c}-{'rings' if r else 'eager'}"
                              for c, r in ASYNC_CASES])
def test_async_forms_give_the_fill_rank_algebra(pool, case, prefer_rings):
    got = pool.run(_async_job, case, prefer_rings)
    for r, (out, pending, after) in enumerate(got):
        np.testing.assert_array_equal(out, ASYNC_WANT[case](r))
        # Each async form registers its handle in flight; sync forms none.
        assert pending == (case != "sendreceive") and after == 0


# ------------------------------------------------------------------ selector

RING_COLLECTIVES = ("allreduce", "reduce_scatter", "allgather")


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("collective", RING_COLLECTIVES
                         + ("broadcast", "reduce", "sendreceive", "barrier"))
@pytest.mark.parametrize("prefer_rings", [False, True])
def test_selector_cell_matches_jax(both_configs, prefer_rings, collective,
                                   mode):
    from torchmpi_tpu.collectives import selector as jselector

    both_configs.reset(use_pallas_collectives=prefer_rings)
    tconfig.reset(use_pallas_collectives=prefer_rings)
    jselector.configure()
    try:
        assert tselector.preferences() == jselector.preferences(
            "tpu", "singlenode", mode)
        if collective == "barrier" and mode == "async":
            for resolve in (lambda: tselector.resolve(collective, mode=mode),
                            lambda: jselector.resolve(collective, "tpu",
                                                      "singlenode", mode)):
                with pytest.raises(KeyError, match="no implementation"):
                    resolve()
            return
        rings = prefer_rings and collective in RING_COLLECTIVES
        want = tselector._DISPATCH[(collective, "pallas" if rings else "xla",
                                    mode)]
        got = tselector.resolve(collective, mode=mode)
        assert got is want
        assert got.__name__ == jselector.resolve(
            collective, "tpu", "singlenode", mode).__name__
    finally:
        jselector.configure()
    with pytest.raises(KeyError, match="no implementation"):
        tselector.resolve("alltoall")
    with pytest.raises(ValueError, match="mode"):
        tselector.resolve("allreduce", mode="eager")


def test_small_message_rule_matches_jax(both_configs):
    """The ring namespace takes a message only above the cutoff, ungrouped,
    sum or mean, and JAX's rule decides the same for every size."""
    import jax.numpy as jnp

    from torchmpi_tpu.collectives import selector as jselector

    cutoff = int(tconfig.get("small_allreduce_size_gpu"))
    for n in (1, cutoff - 1, cutoff, cutoff + 1, 4 * cutoff):
        for op in ("sum", "mean", "max"):
            for groups in (None, ((0, 1),)):
                t = tselector._pallas_ring_eligible(None, torch.zeros(n), op,
                                                    groups)
                j = jselector._pallas_ring_eligible(
                    None, jnp.zeros((2, n)), op, groups)
                assert t == j, (n, op, groups)


def test_small_messages_fall_back_to_eager(monkeypatch):
    from torchmpi_tpu_torch.collectives import cuda_ring

    calls = []
    monkeypatch.setattr(teager, "allreduce",
                        lambda c, x, op="sum", groups=None: calls.append("eager"))
    monkeypatch.setattr(cuda_ring, "ring_allreduce",
                        lambda c, x, op="sum": calls.append("ring"))
    cutoff = int(tconfig.get("small_allreduce_size_gpu"))
    tselector._pallas_allreduce(None, torch.zeros(cutoff))
    tselector._pallas_allreduce(None, torch.zeros(cutoff + 1))
    tselector._pallas_allreduce(None, torch.zeros(cutoff + 1), op="max")
    assert calls == ["eager", "ring", "eager"]


# --------------------------------------------------------- buckets and trees

def _mixed_tree():
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    bf16 = lambda *s: rng.randn(*s).astype(np.float32)
    return {"zeta": f32(300), "alpha": [f32(20, 30), bf16(4000), f32(7)],
            "mid": {"b": bf16(16, 16), "a": f32(5000), "c": None},
            "beta": (f32(3), f32(2, 2))}, ("alpha", 1), ("mid", "b")


def _as(tree, to, bf16_paths):
    """The same tree with the two bf16 leaves cast, in either package."""
    import jax.numpy as jnp

    def cast(a, path):
        if to == "jax":
            return jnp.asarray(a, jnp.bfloat16 if path in bf16_paths
                               else jnp.float32)
        t = torch.from_numpy(a)
        return t.to(torch.bfloat16) if path in bf16_paths else t

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(v, path + (i,)) for i, v in enumerate(t)]
            return out if isinstance(t, list) else tuple(out)
        if t is None:
            return None
        return cast(t, path)

    return walk(tree, ())


def test_tree_order_matches_jax():
    import jax

    tree, *bf = _mixed_tree()
    jl = jax.tree.leaves(_as(tree, "jax", bf))
    tl, td = ttree.flatten(_as(tree, "torch", bf))
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    back = ttree.unflatten(td, tl)
    assert sorted(back) == sorted(tree) and back["mid"]["c"] is None
    assert isinstance(back["beta"], tuple)


@pytest.mark.parametrize("bucket_bytes", [64, 4096, 20_000, 1 << 25])
def test_bucket_plans_match_jax(bucket_bytes):
    from torchmpi_tpu.nn import bucketing as jbucketing

    tree, *bf = _mixed_tree()
    jp = jbucketing.plan_buckets(_as(tree, "jax", bf), bucket_bytes)
    tp = tbucketing.plan_buckets(_as(tree, "torch", bf), bucket_bytes)
    assert len(jp.specs) == len(tp.specs)
    for j, t in zip(jp.specs, tp.specs):
        assert (j.leaf_indices, j.shapes, j.sizes) == (
            t.leaf_indices, t.shapes, t.sizes)
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("bucket_bytes", [64, 4096, 20_000, 1 << 25])
def test_ready_order_plans_and_sq_norms_match_jax(bucket_bytes):
    import jax.numpy as jnp

    from torchmpi_tpu.nn import bucketing as jbucketing

    tree, *bf = _mixed_tree()
    jt, tt = _as(tree, "jax", bf), _as(tree, "torch", bf)
    jd = jbucketing.plan_ready_order(jt, bucket_bytes)
    td = tbucketing.plan_ready_order(tt, bucket_bytes)
    assert td.order == jd.order
    assert sorted(td.order) == list(range(len(td.plan.specs)))
    assert [(s.leaf_indices, s.sizes) for s in td.plan.specs] == [
        (s.leaf_indices, s.sizes) for s in jd.plan.specs]
    assert td.plan.specs == tbucketing.plan_buckets(tt, bucket_bytes).specs
    want = np.asarray(jbucketing.bucket_sq_norms(jt, jd.plan), np.float32)
    got = tbucketing.bucket_sq_norms(tt, td.plan)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    empty = tbucketing.plan_ready_order({})
    assert empty.order == () and tuple(
        tbucketing.bucket_sq_norms({}, empty.plan).shape) == (0,)
    assert jnp.asarray(jbucketing.bucket_sq_norms(
        {}, jbucketing.plan_buckets({}))).shape == (0,)


def test_bucket_roundtrip_and_map():
    tree, *bf = _mixed_tree()
    t = _as(tree, "torch", bf)
    plan = tbucketing.plan_buckets(t, 4096)
    back = tbucketing.unflatten(tbucketing.flatten(t, plan), plan)
    for a, b in zip(ttree.leaves(back), ttree.leaves(t)):
        assert torch.equal(a, b)
    doubled = tbucketing.map_bucketed(lambda b: b * 2, t, 4096)
    for a, b in zip(ttree.leaves(doubled), ttree.leaves(t)):
        assert torch.equal(a, b * 2)


def test_resnet_bucket_plan_matches_jax():
    """The ResNet tree, converted: conv leaves change layout (HWIO -> OIHW)
    but not size, so the plan's leaf groups and sizes are JAX's."""
    import jax

    from torchmpi_tpu.models import resnet as jresnet
    from torchmpi_tpu.nn import bucketing as jbucketing
    from torchmpi_tpu_torch.models import resnet as tresnet

    cfg = jresnet.config(depth=18, n_classes=10, width_multiplier=0.125)
    jp, _ = jresnet.init(jax.random.PRNGKey(0), cfg)
    tp = tresnet.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for bb in (1 << 12, 1 << 16):
        a = jbucketing.plan_buckets(jp, bb)
        b = tbucketing.plan_buckets(tp, bb)
        assert [(s.leaf_indices, s.sizes) for s in a.specs] == [
            (s.leaf_indices, s.sizes) for s in b.specs]
