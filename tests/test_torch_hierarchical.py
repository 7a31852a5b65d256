"""The port's grouped, v-form, scalar and tree collectives and the ``mpi.*``
surface under a split stack, against the JAX package's, over a gloo world
(one spawned pool of 4 ranks for the module, one intra-op thread a rank;
``tests/test_torch_hierarchical_p3.py`` runs the same cases at p = 3 in a
pool of its own).

Each case runs a pushed split's groups through both packages on the same
inputs (``numpy.random.RandomState``): rank r's port result is held
against row r of the JAX result, on JAX's 8-device CPU mesh over a
``Communicator`` of the first p devices.  Integer-valued f32 must match
bit for bit; random f32 within 1e-6 of the inputs' largest magnitude,
relative (gloo sums in another order than XLA).  Where JAX refuses a call
(a root outside a group, uneven ``allgather`` groups, overlapping
``allgatherv`` groups), the port raises the same error with the same
message.

Splits: cartesian 2x2 (keys r // 2), the same under
``use_tree_communicators`` and uneven 3+1 here, 2+1 at p = 3.  The
``mpi.*`` surface is driven through ``set_communicator`` and
``set_collective_span`` on the three-level stack of
``tests/test_span_semantics.py`` cut to 4 ranks, against JAX's
``groups_for_cursor`` and eager calls, which JAX's ``mpi.*`` make.  Then
the selector's host column across processes: a ``HostCommunicator`` wired
from endpoints gathered over the world group, and the refusal of a
ringless host call in a multi-process world.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.runtime import config as tconfig

N = 12   # divisible by 2, 3 and 4 (alltoall, reduce_scatter)

SPLITS = {"2x2": (4, (0, 0, 1, 1), False),
          "2x2-tree": (4, (0, 0, 1, 1), True),
          "3+1": (4, (0, 0, 0, 1), False),
          "2+1": (3, (0, 0, 1), False)}


def _intra(lv):
    return lv.group_ranks


def _inter(lv):
    return lv.inter_group_ranks


def _cases():
    """name -> (arithmetic?, port fn(te, th, world, level, x),
    JAX fn(je, jh, world, level, X))."""
    c = {}
    for op in ("sum", "mean", "max", "min"):
        for side, g in (("intra", _intra), ("inter", _inter)):
            c[f"allreduce-{op}-{side}"] = (
                op in ("sum", "mean"),
                lambda te, th, w, lv, x, op=op, g=g: te.allreduce(
                    w, x, op=op, groups=g(lv)),
                lambda je, jh, w, lv, X, op=op, g=g: je.allreduce(
                    w, X, op=op, groups=g(lv)))
    c["allreduce-mean-world"] = (
        True, lambda te, th, w, lv, x: te.allreduce(w, x, op="mean"),
        lambda je, jh, w, lv, X: je.allreduce(w, X, op="mean"))
    for side, g, root in (("intra", _intra, 0), ("inter", _inter, 0),
                          ("inter-root1", _inter, 1),
                          ("intra-root2", _intra, 2)):
        c[f"broadcast-{side}"] = (
            False,
            lambda te, th, w, lv, x, g=g, root=root: te.broadcast(
                w, x, root=root, groups=g(lv)),
            lambda je, jh, w, lv, X, g=g, root=root: je.broadcast(
                w, X, root=root, groups=g(lv)))
    for op, side, g, root in (("sum", "intra", _intra, 0),
                              ("mean", "intra", _intra, 0),
                              ("max", "intra", _intra, 0),
                              ("sum", "inter-root1", _inter, 1)):
        c[f"reduce-{op}-{side}"] = (
            op != "max",
            lambda te, th, w, lv, x, op=op, g=g, root=root: te.reduce(
                w, x, root=root, op=op, groups=g(lv)),
            lambda je, jh, w, lv, X, op=op, g=g, root=root: je.reduce(
                w, X, root=root, op=op, groups=g(lv)))
    for side, g in (("intra", _intra), ("inter", _inter)):
        c[f"allgather-{side}"] = (
            False,
            lambda te, th, w, lv, x, g=g: te.allgather(w, x, groups=g(lv)),
            lambda je, jh, w, lv, X, g=g: je.allgather(w, X, groups=g(lv)))
        c[f"allgatherv-{side}"] = (
            False,
            lambda te, th, w, lv, x, g=g: te.allgatherv(w, x, groups=g(lv)),
            lambda je, jh, w, lv, X, g=g: je.allgatherv(w, X, groups=g(lv)))
    c["allgatherv-world"] = (
        False, lambda te, th, w, lv, x: te.allgatherv(w, x),
        lambda je, jh, w, lv, X: je.allgatherv(w, X))
    c["allgatherv-overlapping"] = (
        False,
        lambda te, th, w, lv, x: te.allgatherv(w, x, groups=((0, 1), (1, 2))),
        lambda je, jh, w, lv, X: je.allgatherv(w, X, groups=((0, 1), (1, 2))))
    for op in ("sum", "mean"):
        c[f"reduce_scatter-{op}-intra"] = (
            True,
            lambda te, th, w, lv, x, op=op: te.reduce_scatter(
                w, x, op=op, groups=_intra(lv)),
            lambda je, jh, w, lv, X, op=op: je.reduce_scatter(
                w, X, op=op, groups=_intra(lv)))
    c["alltoall"] = (False, lambda te, th, w, lv, x: te.alltoall(w, x),
                     lambda je, jh, w, lv, X: je.alltoall(w, X))
    c["sendreceive"] = (
        False,
        lambda te, th, w, lv, x: te.sendreceive(w, x, src=1, dst=w.size - 1),
        lambda je, jh, w, lv, X: je.sendreceive(w, X, src=1, dst=w.size - 1))
    # The scalar forms: this rank's first element, as a float64 value.
    c["allreduce_scalar-intra"] = (
        True,
        lambda te, th, w, lv, x: te.allreduce_scalar(
            w, float(x[0]), groups=_intra(lv)),
        lambda je, jh, w, lv, X: je.allreduce_scalar(
            w, list(np.asarray(X)[:, 0]), groups=_intra(lv)))
    c["broadcast_scalar-inter"] = (
        False,
        lambda te, th, w, lv, x: te.broadcast_scalar(
            w, float(x[0]), root=0, groups=_inter(lv)),
        lambda je, jh, w, lv, X: je.broadcast_scalar(
            w, list(np.asarray(X)[:, 0]), root=0, groups=_inter(lv)))
    c["reduce_scalar-intra"] = (
        True,
        lambda te, th, w, lv, x: te.reduce_scalar(
            w, float(x[0]), root=1, groups=_intra(lv)),
        lambda je, jh, w, lv, X: je.reduce_scalar(
            w, list(np.asarray(X)[:, 0]), root=1, groups=_intra(lv)))
    c["sendreceive_scalar"] = (
        False,
        lambda te, th, w, lv, x: te.sendreceive_scalar(
            w, float(x[0]), src=0, dst=w.size - 1),
        lambda je, jh, w, lv, X: je.sendreceive_scalar(
            w, list(np.asarray(X)[:, 0]), src=0, dst=w.size - 1))
    # The async forms, waited.
    c["allreduce_async-mean-intra"] = (
        True,
        lambda te, th, w, lv, x: te.allreduce_async(
            w, x, op="mean", groups=_intra(lv)).wait(),
        lambda je, jh, w, lv, X: je.allreduce_async(
            w, X, op="mean", groups=_intra(lv)).wait())
    c["broadcast_async-inter"] = (
        False,
        lambda te, th, w, lv, x: te.broadcast_async(
            w, x, root=0, groups=_inter(lv)).wait(),
        lambda je, jh, w, lv, X: je.broadcast_async(
            w, X, root=0, groups=_inter(lv)).wait())
    c["reduce_async-intra"] = (
        True,
        lambda te, th, w, lv, x: te.reduce_async(
            w, x, root=0, groups=_intra(lv)).wait(),
        lambda je, jh, w, lv, X: je.reduce_async(
            w, X, root=0, groups=_intra(lv)).wait())
    c["allgather_async-inter"] = (
        False,
        lambda te, th, w, lv, x: te.allgather_async(
            w, x, groups=_inter(lv)).wait(),
        lambda je, jh, w, lv, X: je.allgather_async(
            w, X, groups=_inter(lv)).wait())
    # The tree forms and their dispatchers, over the pushed level.
    for op in ("sum", "mean", "max"):
        c[f"allreduce_tree-{op}"] = (
            op != "max",
            lambda te, th, w, lv, x, op=op: th.allreduce_tree(lv, x, op=op),
            lambda je, jh, w, lv, X, op=op: jh.allreduce_tree(lv, X, op=op))
    for which in ("first", "last"):
        root = (lambda lv: 0) if which == "first" else (lambda lv: lv.size - 1)
        c[f"broadcast_tree-{which}"] = (
            False,
            lambda te, th, w, lv, x, root=root: th.broadcast_tree(
                lv, x, root=root(lv)),
            lambda je, jh, w, lv, X, root=root: jh.broadcast_tree(
                lv, X, root=root(lv)))
        for op in ("sum", "mean"):
            c[f"reduce_tree-{op}-{which}"] = (
                True,
                lambda te, th, w, lv, x, op=op, root=root: th.reduce_tree(
                    lv, x, root=root(lv), op=op),
                lambda je, jh, w, lv, X, op=op, root=root: jh.reduce_tree(
                    lv, X, root=root(lv), op=op))
    for op in ("sum", "max"):
        c[f"allreduce_hierarchical-{op}"] = (
            op == "sum",
            lambda te, th, w, lv, x, op=op: th.allreduce_hierarchical(
                lv, x, op=op),
            lambda je, jh, w, lv, X, op=op: jh.allreduce_hierarchical(
                lv, X, op=op))
        c[f"reduce_hierarchical-{op}"] = (
            op == "sum",
            lambda te, th, w, lv, x, op=op: th.reduce_hierarchical(
                lv, x, root=lv.size - 1, op=op),
            lambda je, jh, w, lv, X, op=op: jh.reduce_hierarchical(
                lv, X, root=lv.size - 1, op=op))
    c["broadcast_hierarchical"] = (
        False,
        lambda te, th, w, lv, x: th.broadcast_hierarchical(
            lv, x, root=lv.size - 1),
        lambda je, jh, w, lv, X: jh.broadcast_hierarchical(
            lv, X, root=lv.size - 1))
    return c


CASES = _cases()
PARAMS = [(split, case, kind) for split in SPLITS if SPLITS[split][0] == 4
          for case in CASES
          for kind in (("int", "rand") if CASES[case][0] else ("int",))]


def _inputs(p, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "int":
        return rng.randint(-50, 50, (p, N)).astype(np.float32)
    return rng.randn(p, N).astype(np.float32)


def _plain(out):
    """A result as numpy (a tuple item by item; an error as its type and
    message)."""
    if isinstance(out, tuple):
        return tuple(_plain(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


def _level(keys, tree):
    """A stack over the world with one level pushed by ``keys``; the
    level's process groups are made on every rank by the push."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime.communicator import (Communicator,
                                                         CommunicatorStack)

    tconfig.reset(use_tree_communicators=tree,
                  use_cartesian_communicators=not tree)
    s = CommunicatorStack()
    s.reset(Communicator(range(dist.get_world_size()),
                         my_rank=dist.get_rank()))
    s.push(lambda r: keys[r])
    return s


def _case_job(split, case, arrays):
    from torchmpi_tpu_torch.collectives import eager as te
    from torchmpi_tpu_torch.collectives import hierarchical as th

    _, keys, tree = SPLITS[split]
    s = _level(keys, tree)
    try:
        w = s.world()
        x = torch.from_numpy(arrays[w.rank].copy())
        try:
            return _plain(CASES[case][1](te, th, w, s.current(), x))
        except ValueError as e:
            return ("raised", type(e).__name__, str(e))
    finally:
        tconfig.reset()


def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(1)
    lifecycle.start(device="cpu")


def make_pool(p):
    """A pool of p gloo ranks started on the CPU, for a module fixture."""
    from torchmpi_tpu_torch.runtime import launch

    return launch.Pool(p, setup=_setup_cpu, timeout_s=120)


@pytest.fixture(scope="module")
def pool():
    pl = make_pool(4)
    yield pl
    pl.close()


def _jax_level(p, keys, tree):
    import jax

    from torchmpi_tpu.runtime import config as jconfig
    from torchmpi_tpu.runtime.communicator import (Communicator as JComm,
                                                   CommunicatorStack as JStack)

    jconfig.reset(use_tree_communicators=tree,
                  use_cartesian_communicators=not tree)
    try:
        js = JStack()
        js.reset(JComm(jax.devices()[:p]))
        js.push(lambda r: keys[r])
        return js
    finally:
        jconfig.reset()


def _raised(v) -> bool:
    return isinstance(v, tuple) and isinstance(v[0], str) and v[0] == "raised"


def _row(je, want, r):
    """Rank r's part of a JAX result."""
    if _raised(want):
        return want
    if isinstance(want, tuple):                 # allgatherv: (out, counts)
        return (je.to_numpy(want[0])[r], want[1])
    if isinstance(want, np.ndarray) and want.ndim == 1:     # scalar forms
        return want[r]
    return je.to_numpy(want)[r]


def _compare(got, want, kind, scale):
    if _raised(want):
        assert tuple(got) == want
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _compare(g, w, kind, scale)
        return
    assert np.shape(got) == np.shape(want)
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def check_case(pool, split, case, kind):
    """Run ``case`` over ``split`` in ``pool`` and hold every rank's result
    against the JAX package's row."""
    from torchmpi_tpu.collectives import eager as je
    from torchmpi_tpu.collectives import hierarchical as jh

    p, keys, tree = SPLITS[split]
    X = _inputs(p, kind, seed=zlib.crc32(f"{split}{case}{kind}".encode()))
    got = pool.run(_case_job, split, case, X)
    js = _jax_level(p, keys, tree)
    try:
        want = CASES[case][2](je, jh, js.world(), js.current(),
                              je.shard(js.world(), X))
    except ValueError as e:
        want = ("raised", type(e).__name__, str(e))
    for r in range(p):
        _compare(got[r], _row(je, want, r), kind, float(np.abs(X).max()))


@pytest.mark.parametrize("split,case,kind", PARAMS,
                         ids=[f"{s}-{c}-{k}" for s, c, k in PARAMS])
def test_case_rows_equal_jax(pool, split, case, kind):
    check_case(pool, split, case, kind)


# ------------------------------------------------------- the mpi.* surface

# tests/test_span_semantics.py's three-level stack cut to 4 ranks: level 1
# {0,1,2} {3}, level 2 {0,1} {2} {3}.
L1_KEY = (0, 0, 0, 1)
L2_KEY = (0, 0, 1, 0)
CURSORS = [("level", (0,)), ("level", (1,)), ("level", (2,)),
           ("inter", (1,)), ("inter", (2,)), ("span", (0, 2)),
           ("span", (1, 3)), ("span", (0, 3)), ("span", (2, 3))]
SURFACE = {
    "allreduce": (lambda m, x: m.allreduce(x),
                  lambda je, w, g, X: je.allreduce(w, X, groups=g)),
    "allreduce-mean": (lambda m, x: m.allreduce(x, op="mean"),
                       lambda je, w, g, X: je.allreduce(w, X, op="mean",
                                                        groups=g)),
    "broadcast": (lambda m, x: m.broadcast(x, root=0),
                  lambda je, w, g, X: je.broadcast(w, X, root=0, groups=g)),
    "reduce": (lambda m, x: m.reduce(x, root=0),
               lambda je, w, g, X: je.reduce(w, X, root=0, groups=g)),
    "allgather": (lambda m, x: m.allgather(x),
                  lambda je, w, g, X: je.allgather(w, X, groups=g)),
    "allgatherv": (lambda m, x: m.allgatherv(x),
                   lambda je, w, g, X: je.allgatherv(w, X, groups=g)),
    "reduce_scatter": (lambda m, x: m.reduce_scatter(x),
                       lambda je, w, g, X: je.reduce_scatter(w, X, groups=g)),
    "allreduce_scalar": (
        lambda m, x: m.allreduce_scalar(float(x[0])),
        lambda je, w, g, X: je.allreduce_scalar(w, list(X[:, 0]), groups=g)),
    "broadcast_scalar": (
        lambda m, x: m.broadcast_scalar(float(x[0])),
        lambda je, w, g, X: je.broadcast_scalar(w, list(X[:, 0]), groups=g)),
    "reduce_scalar": (
        lambda m, x: m.reduce_scalar(float(x[0])),
        lambda je, w, g, X: je.reduce_scalar(w, list(X[:, 0]), groups=g)),
    "async_allreduce": (lambda m, x: m.sync_handle(m.async_.allreduce(x)),
                        lambda je, w, g, X: je.allreduce(w, X, groups=g)),
}
SURFACE_PARAMS = [(c, a, s) for c, a in CURSORS for s in SURFACE]


def _set_cursor(stack, ctype, cursor, args):
    if cursor == "span":
        stack.set_collective_span(*args)
    else:
        stack.set_communicator(*args, ctype.INTER if cursor == "inter"
                               else ctype.INTRA)


def _surface_job(cursor, args, name, arrays):
    import torchmpi_tpu_torch as mpi

    world = mpi.stack.world()
    try:
        for keys in (L1_KEY, L2_KEY):
            mpi.push_communicator(lambda r, k=keys: k[r])
        _set_cursor(mpi.stack, mpi.CommunicatorType, cursor, args)
        x = torch.from_numpy(arrays[mpi.rank()].copy())
        try:
            return _plain(SURFACE[name][0](mpi, x))
        except ValueError as e:
            return ("raised", type(e).__name__, str(e))
    finally:
        mpi.stack.reset(world)


@pytest.mark.parametrize("cursor,args,name", SURFACE_PARAMS,
                         ids=[f"{c}{a}-{s}" for c, a, s in SURFACE_PARAMS])
def test_surface_under_the_cursor_equals_jax(pool, cursor, args, name):
    import jax

    from torchmpi_tpu.collectives import eager as je
    from torchmpi_tpu.collectives import hierarchical as jh
    from torchmpi_tpu.runtime.communicator import (Communicator as JComm,
                                                   CommunicatorStack as JStack,
                                                   CommunicatorType as JType)

    X = _inputs(4, "int", seed=len(name) * 7 + len(CURSORS))
    got = pool.run(_surface_job, cursor, args, name, X)
    js = JStack()
    js.reset(JComm(jax.devices()[:4]))
    for keys in (L1_KEY, L2_KEY):
        js.push(lambda r, k=keys: k[r])
    _set_cursor(js, JType, cursor, args)
    w, groups = jh.groups_for_cursor(js)
    try:
        want = SURFACE[name][1](je, w, groups, je.shard(w, X))
    except ValueError as e:
        want = ("raised", type(e).__name__, str(e))
    for r in range(4):
        _compare(got[r], _row(je, want, r), "int", 0.0)


# ------------------------------------------------- the host column, across ranks

def _host_column_job():
    """The selector's host column across the world's processes: refused
    without a ring, then run on a ring wired from endpoints gathered over
    the world group."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import hostcomm, selector
    from torchmpi_tpu_torch.runtime.communicator import stack

    world = stack.world()
    me, p = world.rank, world.size
    x = torch.full((5,), float(me))
    try:
        selector.resolve("allreduce", placement="cpu")(world, x)
        refused = False
    except RuntimeError as e:
        refused = "without an attached ring" in str(e)
    eps = [None] * p
    dist.all_gather_object(eps, ("127.0.0.1", hostcomm.free_ports(1)[0]))
    ring = hostcomm.HostCommunicator(me, p, eps, timeout_ms=60000,
                                     io_deadline_ms=20000)
    world.host_ring = ring
    try:
        out = {
            "mean": selector.resolve("allreduce", placement="cpu")(
                world, x, op="mean"),
            "bcast": selector.resolve("broadcast", placement="cpu")(
                world, x, root=p - 1),
            "gather": selector.resolve("allgather", placement="cpu")(
                world, x[:me + 1]),
            "async": selector.resolve("reduce", placement="cpu",
                                      mode="async")(world, x, root=0).wait(),
        }
        selector.resolve("barrier", placement="cpu")(world)
        return refused, {k: v.tolist() for k, v in out.items()}, x.tolist()
    finally:
        world.host_ring = None
        ring.close()


def test_host_column_across_processes(pool):
    p = 4
    for r, (refused, out, x) in enumerate(pool.run(_host_column_job)):
        assert refused
        assert x == [float(r)] * 5          # the caller's tensor untouched
        assert out["mean"] == [(p - 1) / 2] * 5
        assert out["bcast"] == [float(p - 1)] * 5
        assert out["gather"] == [float(q) for q in range(p)
                                 for _ in range(q + 1)]
        assert out["async"] == ([float(sum(range(p)))] * 5 if r == 0
                                else [float(r)] * 5)
