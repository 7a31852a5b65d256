"""The port's tensor parallelism (``parallel/tp.py``) against the JAX
package's, in one spawned gloo pool of 4 ranks (one intra-op thread a
rank).

MPLinear over {tp 4} and the Megatron MLP over {dp 2, tp 2}, forward and
gradients, on inputs made with ``numpy.random.RandomState``: the forward
against the JAX function in its ``shard_map`` over ``devices[:4]`` of the
8-device CPU mesh; the gradients (this rank's shard of each weight's, and
the replicated input's, whole on every rank) against ``jax.grad`` of the
same computation on whole arrays, the gradient the partitioner's
transposes give (the port differentiates each rank's program, with the
Megatron f/g pair carrying the wires).  f32, within 1e-5 relative (and
1e-5 absolute for values near 0): the tp sums add partials in another
order than one dot does.  Then the f/g pair itself (and the wire knob), and
the spec helpers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.parallel import tp as ttp
from torchmpi_tpu_torch.runtime import config as tconfig

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _jax_mesh(axes):
    import jax

    from torchmpi_tpu import parallel as jparallel

    return jparallel.make_mesh(axes, devices=jax.devices()[:4])


def _mp_job(w, b, x):
    m = tmesh.make_mesh({"tp": 4})
    full = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    params = ttp.shard_mp_linear(full, m)
    for t in params.values():
        t.requires_grad_(True)
    y = ttp.make_mp_linear(m)(params, torch.from_numpy(x))
    (y ** 2).sum().backward()
    return (y.detach().numpy(), params["w"].grad.numpy(),
            params["b"].grad.numpy(), m.coords["tp"])


def test_mp_linear_matches_jax(pool):
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu.parallel import tp as jtp

    mesh = _jax_mesh({"tp": 4})
    params = jtp.mp_linear_init(jax.random.PRNGKey(0), 32, 16)
    rng = np.random.RandomState(0)
    params["b"] = jnp.asarray(rng.randn(16), jnp.float32)
    x = rng.randn(4, 32).astype(np.float32)
    sharded = jtp.shard_mp_linear(params, mesh)
    fn = jtp.make_mp_linear(mesh)
    want = np.asarray(fn(sharded, jnp.asarray(x)))
    g = jax.grad(lambda p: jnp.sum(fn(p, jnp.asarray(x)) ** 2))(sharded)
    w, b = np.asarray(params["w"]), np.asarray(params["b"])
    for y, gw, gb, t in pool.run(_mp_job, w, b, x):
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(gw, np.asarray(g["w"])[8 * t:8 * (t + 1)],
                                   **TOL)
        np.testing.assert_allclose(gb, np.asarray(g["b"]), **TOL)


def _mlp_job(x, wu, bu, wd, bd):
    m = tmesh.make_mesh({"dp": 2, "tp": 2})
    t = m.coords["tp"]
    n = wu.shape[1] // 2
    shards = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (
        x, wu[:, t * n:(t + 1) * n], bu[t * n:(t + 1) * n],
        wd[t * n:(t + 1) * n], bd)]
    y = ttp.mlp_block(*shards, mesh=m)
    (y ** 2).sum().backward()
    return (y.detach().numpy(), t) + tuple(s.grad.numpy() for s in shards)


def test_megatron_mlp_matches_jax(pool):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from torchmpi_tpu._compat import shard_map
    from torchmpi_tpu.parallel import tp as jtp

    mesh = _jax_mesh({"dp": 2, "tp": 2})
    rng = np.random.RandomState(0)
    d, hidden = 12, 16
    arrs = [rng.randn(2, d), rng.randn(d, hidden), rng.randn(hidden),
            rng.randn(hidden, d), rng.randn(d)]
    x, wu, bu, wd, bd = (a.astype(np.float32) for a in arrs)
    fn = shard_map(lambda *a: jtp.mlp_block(*a), mesh=mesh,
                   in_specs=(JP(), JP(None, "tp"), JP("tp"), JP("tp", None),
                             JP()), out_specs=JP(), check_vma=False)
    want = np.asarray(fn(*map(jnp.asarray, (x, wu, bu, wd, bd))))

    def dense(x, wu, bu, wd, bd):
        return jnp.sum((jax.nn.relu(x @ wu + bu) @ wd + bd) ** 2)

    grads = [np.asarray(a) for a in jax.grad(dense, argnums=tuple(range(5)))(
        *map(jnp.asarray, (x, wu, bu, wd, bd)))]
    for y, t, gx, gwu, gbu, gwd, gbd in pool.run(_mlp_job, x, wu, bu, wd,
                                                  bd):
        sl = slice(t * hidden // 2, (t + 1) * hidden // 2)
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(gx, grads[0], **TOL)
        np.testing.assert_allclose(gwu, grads[1][:, sl], **TOL)
        np.testing.assert_allclose(gbu, grads[2][sl], **TOL)
        np.testing.assert_allclose(gwd, grads[3][sl], **TOL)
        np.testing.assert_allclose(gbd, grads[4], **TOL)


def _marker_job(knob):
    tconfig.reset(manual_wire_dtype=knob)
    try:
        m = tmesh.make_mesh({"dp": 2, "tp": 2})
        r = m.coords["tp"] + 2 * m.coords["dp"]
        base = torch.tensor([1.0 + 2.0 ** -9, 3.0]) * (r + 1)
        x = base.clone().requires_grad_(True)
        y = ttp.block_input(x, mesh=m)
        (y * (r + 1)).sum().backward()
        fwd_in, grad_in = y.detach().numpy(), x.grad.numpy()
        part = base.clone().requires_grad_(True)
        out = ttp.block_output(part, mesh=m)
        (out * (r + 1)).sum().backward()
        return (fwd_in, grad_in, out.detach().numpy(), part.grad.numpy(),
                str(ttp.resolve_wire_dtype()))
    finally:
        tconfig.reset()


@pytest.mark.parametrize("knob", ["auto", "bfloat16"])
def test_megatron_markers(pool, knob):
    """f: identity forward, a tp sum of the gradient backward; g: a tp sum
    forward, the gradient passed on backward; both on the wire dtype of
    the knob (bf16 rounds 1 + 2^-9 to 1)."""
    wire = torch.float32 if knob == "auto" else torch.bfloat16
    for r, (fwd_in, grad_in, out, grad_out, dt) in enumerate(
            pool.run(_marker_job, knob)):
        tp_peers = [r - r % 2, r - r % 2 + 1]
        base = [torch.tensor([1.0 + 2.0 ** -9, 3.0]) * (q + 1)
                for q in tp_peers]
        np.testing.assert_array_equal(fwd_in, base[r % 2].numpy())
        want_g = sum(torch.full((2,), float(q + 1)).to(wire)
                     for q in tp_peers).float()
        np.testing.assert_array_equal(grad_in, want_g.numpy())
        want_s = sum(b.to(wire) for b in base).float()
        np.testing.assert_array_equal(out, want_s.numpy())
        np.testing.assert_array_equal(grad_out, np.full(2, r + 1.0,
                                                        np.float32))
        assert dt == str(wire)


@pytest.mark.parametrize("knob", ["auto", "float32", "bfloat16", "int8"])
def test_resolve_wire_dtype_matches_jax(knob):
    from torchmpi_tpu.parallel import tp as jtp
    from torchmpi_tpu.runtime import config as jconfig

    jconfig.reset(manual_wire_dtype=knob)
    tconfig.reset(manual_wire_dtype=knob)
    try:
        try:
            want = np.dtype(jtp.resolve_wire_dtype()).name
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                ttp.resolve_wire_dtype()
            assert str(err.value) == str(e)
            return
        assert str(ttp.resolve_wire_dtype()).split(".")[-1] == want
        assert ttp.resolve_wire_dtype(torch.bfloat16) is torch.bfloat16
    finally:
        jconfig.reset()
        tconfig.reset()


def test_specs_match_jax():
    from torchmpi_tpu.parallel import tp as jtp

    for shard_output in (True, False):
        for got, want in zip(ttp.tp_specs_linear(shard_output),
                             jtp.tp_specs_linear(shard_output)):
            assert tuple(got) == tuple(want)
    params = ttp.mp_linear_init(0, 8, 4, device="cpu")
    assert params["w"].shape == (8, 4) and not params["b"].any()
