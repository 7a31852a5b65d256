"""The port's mesh (``parallel/mesh.py``) and its axis-name collectives
(``collectives/innerjit.py``) against the JAX package's.

``make_mesh`` is held against JAX's on 8 ranks without a world (a
``Communicator`` of ranks 0-7 seen from each rank in turn): axis order,
shape, the rank at every coordinate against ``mesh.devices``' ids, this
rank's coordinates, the group of every axis subset, the ``-1`` wildcard
and the same errors with the same messages.  The collectives run in one
spawned gloo pool of 4 ranks (one intra-op thread a rank) on a {dp 2,
tp 2} mesh: rank r's result is held against device r's of the same JAX
function in a ``shard_map`` over ``devices[:4]`` of the 8-device CPU mesh,
on the same inputs (``numpy.random.RandomState``).  Integer-valued f32
(every order of summation gives the same bits) must match bit for bit; the
gradients of the differentiable ones (ring_shift, allgather,
reduce_scatter, alltoall) of ``sum(w * f(x))`` likewise, against
``jax.grad`` through the ``shard_map``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.collectives import innerjit as tij
from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.runtime.communicator import Communicator

MESH_AXES = [{"tp": 4, "dp": 2}, {"dp": -1, "tp": 2},
             {"dp": 2, "pp": 2, "tp": 2}, {"sp": 2, "dp": 2, "tp": 2},
             {"tp": 2, "custom": 2, "dp": 2}, {"dp": 8}]
BAD_AXES = [{"dp": 3, "tp": 2}, {"dp": -1, "tp": -1}, {"dp": -1, "tp": 3}]


def _jax_mesh(axes, n=8):
    import jax

    from torchmpi_tpu import parallel as jparallel

    return jparallel.make_mesh(axes, devices=jax.devices()[:n])


@pytest.mark.parametrize("axes", MESH_AXES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_make_mesh_matches_jax(axes):
    jm = _jax_mesh(axes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    names = tuple(jm.axis_names)
    for r in range(8):
        tm = tmesh.make_mesh(axes, comm=Communicator(range(8), my_rank=r))
        assert tm.axis_names == names
        assert tm.shape == dict(jm.shape)
        np.testing.assert_array_equal(tm.ranks, ids)
        where = tuple(int(c) for c in np.argwhere(ids == r)[0])
        assert tm.coords == dict(zip(names, where))
        for n in range(1, len(names) + 1):
            for sub in itertools.combinations(names, n):
                # The devices that share r's coordinates off ``sub``,
                # row-major over ``sub``.
                idx = tuple(slice(None) if a in sub else where[i]
                            for i, a in enumerate(names))
                want = ids[idx].reshape(-1)
                assert tm.comm(sub).ranks == tuple(int(x) for x in want)
                assert tm.comm(sub).rank == list(want).index(r)
                assert tij.axis_size(sub, mesh=tm) == len(want)
                assert tij.axis_rank(sub, mesh=tm) == list(want).index(r)


@pytest.mark.parametrize("axes", BAD_AXES, ids=["product", "two-wild",
                                                "indivisible"])
def test_make_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as jerr:
        _jax_mesh(axes)
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(axes, comm=Communicator(range(8), my_rank=0))
    assert str(terr.value) == str(jerr.value)


def test_mesh_helpers_and_unbound_axis():
    from torchmpi_tpu import parallel as jparallel

    comm = Communicator(range(8), my_rank=5)
    dp = tmesh.data_parallel_mesh(comm=comm)
    assert dp.axis_names == ("dp",) and dp.shape == {"dp": 8}
    m = tmesh.make_mesh({"dp": 2, "tp": 4}, comm=comm)
    jm = _jax_mesh({"dp": 2, "tp": 4})
    assert tmesh.mesh_axis_size(m, "tp") == jparallel.mesh_axis_size(jm, "tp")
    # One host: no fast axis crosses hosts (JAX: one process).
    assert tmesh.validate_hosts_on_slow_axes(m)
    assert jparallel.validate_hosts_on_slow_axes(jm)
    assert tmesh.AXIS_ORDER == jparallel.mesh.AXIS_ORDER
    # JAX names an axis the mesh lacks "unbound" (lax.psum over it).
    with pytest.raises(NameError, match="unbound axis name: sp"):
        m.comm("sp")
    with pytest.raises(RuntimeError, match="no mesh"):
        tij.axis_size("tp")
    with m:
        assert tij.axis_size("tp") == 4 and tij.axis_rank("dp") == 1


# --------------------------------------------------------- the collectives

N = 8        # rows of each rank's (N, 4) input: divisible by 2 and 4


def _cases():
    """name -> (port fn(x, mesh), JAX fn(x) inside shard_map,
    differentiable)."""
    c = {}
    for op, axis in itertools.product(("sum", "mean", "max", "min"),
                                      ("tp", "dp", ("dp", "tp"))):
        name = f"allreduce-{op}-{'x'.join((axis,) if isinstance(axis, str) else axis)}"
        c[name] = (lambda x, m, op=op, axis=axis: tij.allreduce(
            x, axis, op, mesh=m),
            lambda ji, x, op=op, axis=axis: ji.allreduce(x, axis, op), False)
    c["broadcast-tp-root1"] = (
        lambda x, m: tij.broadcast(x, "tp", root=1, mesh=m),
        lambda ji, x: ji.broadcast(x, "tp", root=1), False)
    c["reduce-dp-root0-max"] = (
        lambda x, m: tij.reduce(x, "dp", root=0, op="max", mesh=m),
        lambda ji, x: ji.reduce(x, "dp", root=0, op="max"), False)
    for axis, dim in (("tp", 0), ("dp", 1), (("dp", "tp"), 0)):
        tag = "x".join((axis,) if isinstance(axis, str) else axis)
        c[f"allgather-{tag}-dim{dim}"] = (
            lambda x, m, axis=axis, dim=dim: tij.allgather(
                x, axis, concat_axis=dim, mesh=m),
            lambda ji, x, axis=axis, dim=dim: ji.allgather(
                x, axis, concat_axis=dim), True)
    c["allgather-tp-untiled"] = (
        lambda x, m: tij.allgather(x, "tp", concat_axis=1, tiled=False,
                                   mesh=m),
        lambda ji, x: ji.allgather(x, "tp", concat_axis=1, tiled=False),
        True)
    c["reduce_scatter-dp-dim0"] = (
        lambda x, m: tij.reduce_scatter(x, "dp", scatter_axis=0, mesh=m),
        lambda ji, x: ji.reduce_scatter(x, "dp", scatter_axis=0), True)
    c["reduce_scatter-tp-dim1"] = (
        lambda x, m: tij.reduce_scatter(x, "tp", scatter_axis=1, mesh=m),
        lambda ji, x: ji.reduce_scatter(x, "tp", scatter_axis=1), True)
    c["alltoall-tp-0to1"] = (
        lambda x, m: tij.alltoall(x, "tp", split_axis=0, concat_axis=1,
                                  mesh=m),
        lambda ji, x: ji.alltoall(x, "tp", split_axis=0, concat_axis=1),
        True)
    c["alltoall-dpxtp-1to0"] = (
        lambda x, m: tij.alltoall(x, ("dp", "tp"), split_axis=1,
                                  concat_axis=0, mesh=m),
        lambda ji, x: ji.alltoall(x, ("dp", "tp"), split_axis=1,
                                  concat_axis=0), True)
    c["ring_shift-dp"] = (
        lambda x, m: tij.ring_shift(x, "dp", mesh=m),
        lambda ji, x: ji.ring_shift(x, "dp"), True)
    c["ring_shift-dpxtp-back"] = (
        lambda x, m: tij.ring_shift(x, ("dp", "tp"), shift=-1, mesh=m),
        lambda ji, x: ji.ring_shift(x, ("dp", "tp"), shift=-1), True)
    c["sendreceive-tp-0to1"] = (
        lambda x, m: tij.sendreceive(x, "tp", [(0, 1)], mesh=m),
        lambda ji, x: ji.sendreceive(x, "tp", [(0, 1)]), False)
    c["sendreceive-dpxtp-cycle"] = (
        lambda x, m: tij.sendreceive(x, ("dp", "tp"),
                                     [(0, 2), (2, 3), (3, 0), (1, 1)],
                                     mesh=m),
        lambda ji, x: ji.sendreceive(x, ("dp", "tp"),
                                     [(0, 2), (2, 3), (3, 0), (1, 1)]),
        False)
    return c


CASES = _cases()


def _inputs(case: str):
    rng = np.random.RandomState(sum(map(ord, case)))
    return rng, rng.randint(-20, 20, (4, N, 4)).astype(np.float32)


def _collective_job(case: str, X: np.ndarray, W):
    import torch.distributed as dist

    m = tmesh.make_mesh({"dp": 2, "tp": 2})
    r = dist.get_rank()
    fn, _, diff = CASES[case]
    x = torch.from_numpy(X[r].copy())
    if not diff:
        return fn(x, m).numpy(), None
    x.requires_grad_(True)
    out = fn(x, m)
    (torch.from_numpy(W[r].copy()) * out).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _jax_side(case: str, X: np.ndarray, rng):
    """Device r's output of the JAX function, and for a differentiable
    one the weights and the gradient of ``sum(w * f(x))``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from torchmpi_tpu._compat import shard_map
    from torchmpi_tpu.collectives import innerjit as jij

    _, jfn, diff = CASES[case]
    mesh = _jax_mesh({"dp": 2, "tp": 2}, n=4)
    spec = JP(("dp", "tp"))
    f = jax.jit(shard_map(lambda x: jfn(jij, x[0])[None], mesh=mesh,
                          in_specs=spec, out_specs=spec, check_vma=False))
    out = np.asarray(f(jnp.asarray(X)))
    if not diff:
        return out, None, None
    W = rng.randint(-3, 4, out.shape).astype(np.float32)
    grad = jax.grad(lambda X: jnp.sum(jnp.asarray(W) * f(X)))(jnp.asarray(X))
    return out, W, np.asarray(grad)


def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(1)
    lifecycle.start(device="cpu")


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup_cpu, timeout_s=120)
    yield pl
    pl.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_jax(pool, case):
    rng, X = _inputs(case)
    want, W, want_grad = _jax_side(case, X, rng)
    got = pool.run(_collective_job, case, X, W)
    for r, (out, grad) in enumerate(got):
        np.testing.assert_array_equal(out, want[r], err_msg=f"rank {r}")
        if want_grad is not None:
            np.testing.assert_array_equal(grad, want_grad[r],
                                          err_msg=f"rank {r} grad")


def _guard_job():
    m = tmesh.make_mesh({"dp": 2, "tp": 2})
    x = torch.ones(3, requires_grad=True)
    try:
        tij.allreduce(x, "tp", mesh=m)
    except RuntimeError as e:
        return str(e)
    return None


def test_non_differentiable_collectives_refuse_a_gradient(pool):
    for msg in pool.run(_guard_job):
        assert msg and "not differentiable" in msg
