"""The expert-parallel MoE layer of the port (``parallel/moe.py``) against
the JAX package's on the same inputs.

* ``route_topk`` case for case (k = 1, 2; renormalisation on and off):
  the experts and the queue positions equal, the weights within 1e-6;
* ``make_moe_layer`` in one spawned gloo pool of 4 ranks (one thread a
  rank; rank r holds tokens [8r, 8r + 8) of 32 and experts r of 4) against
  JAX's layer on ``{ep 4}`` over ``devices[:4]``: the output within 1e-5
  relative and absolute, top-2 at capacity 8 (some units dropped) and
  ample, top-1 at capacity 1 (where the tokens whose every choice was
  dropped pass through unchanged, bit for bit); the
  gradients of ``sum(y**2)`` for the gate (summed over the ranks), each
  rank's experts and its tokens within 1e-4 relative and 1e-5 absolute;
* JAX's validation errors, and the one ``route_topk`` both MoE forms
  route through.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.parallel import moe as tmoe

T, D, F_, E, P = 32, 8, 16, 4, 4
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# name -> (capacity, k)
LAYERS = {"top2": (8, 2), "top2-ample": (32, 2), "top1-cap1": (1, 1)}


def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(1)
    lifecycle.start(device="cpu")


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(P, setup=_setup_cpu, timeout_s=120)
    yield pl
    pl.close()


def _inputs(seed=0):
    import jax

    from torchmpi_tpu.parallel import moe as jmoe

    params = jax.tree.map(np.asarray,
                          jmoe.init_experts(jax.random.PRNGKey(seed), E, D,
                                            F_))
    x = np.random.RandomState(seed).randn(T, D).astype(np.float32)
    return params, x


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("renormalize", [True, False])
def test_route_topk_matches_jax(k, renormalize):
    import jax

    from torchmpi_tpu.parallel import moe as jmoe

    logits = np.random.RandomState(3).randn(12, E).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    want = jmoe.route_topk(probs, k, renormalize)
    got = tmoe.route_topk(torch.from_numpy(probs), k, renormalize)
    for name, w, g in zip(("expert", "weight", "onehot", "pos"), want, got):
        if name == "weight":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Leading group axes route each group on its own.
    batched = tmoe.route_topk(torch.from_numpy(np.stack([probs, probs[::-1]])),
                              k, renormalize)
    single = tmoe.route_topk(torch.from_numpy(probs[::-1].copy()), k,
                             renormalize)
    for b, s in zip(batched, single):
        np.testing.assert_array_equal(b[1].numpy(), s.numpy())


def _layer_job(name, params, x):
    capacity, k = LAYERS[name]
    m = tmesh.make_mesh({"ep": P})
    r = m.coords["ep"]
    fn = tmoe.make_moe_layer(m, n_experts=E, capacity=capacity, k=k)
    p = tmoe.shard_experts({a: torch.from_numpy(v) for a, v in
                            params.items()}, m)
    for t in p.values():
        t.requires_grad_(True)
    xl = torch.from_numpy(x[8 * r:8 * r + 8].copy()).requires_grad_(True)
    y = fn(p, xl)
    torch.sum(y ** 2).backward()
    return (r, y.detach().numpy(), {a: t.grad.numpy() for a, t in p.items()},
            xl.grad.numpy())


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(pool, name):
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.parallel import moe as jmoe

    capacity, k = LAYERS[name]
    params, x = _inputs()
    mesh = jparallel.make_mesh({"ep": P}, devices=jax.devices()[:P])
    fn = jmoe.make_moe_layer(mesh, n_experts=E, capacity=capacity, k=k)
    sharded = jmoe.shard_experts(params, mesh)
    want = np.asarray(fn(sharded, x))
    gp, gx = jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2), argnums=(0, 1))(
        sharded, x)
    gp = jax.tree.map(np.asarray, gp)
    gate = np.zeros_like(gp["gate"])
    for r, y, grads, gxl in pool.run(_layer_job, name, params, x):
        rows = slice(8 * r, 8 * r + 8)
        np.testing.assert_allclose(y, want[rows], **TOL)
        for a in ("w_in", "w_out"):
            np.testing.assert_allclose(grads[a], gp[a][r:r + 1], **GRAD_TOL)
        np.testing.assert_allclose(gxl, np.asarray(gx)[rows], **GRAD_TOL)
        gate += grads["gate"]
    np.testing.assert_allclose(gate, gp["gate"], **GRAD_TOL)
    if capacity == 1:
        same = np.all(want == x, axis=1)
        assert 1 <= (~same).sum() <= P * E     # at most E tokens a rank
        assert same.any()


def test_errors_match_jax():
    m = tmesh.Mesh(np.arange(4).reshape(4), ("ep",), None)
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.make_moe_layer(m, n_experts=6, capacity=4)
    with pytest.raises(ValueError, match="capacity"):
        tmoe.make_moe_layer(m, n_experts=4, capacity=0)
    with pytest.raises(ValueError, match="k must be"):
        tmoe.make_moe_layer(m, n_experts=4, capacity=8, k=5)


def test_route_topk_shared_by_both_moe_forms(monkeypatch):
    """One routing definition: Llama's MoE FFN routes through
    ``parallel.moe.route_topk`` (JAX holds the same rule)."""
    from torchmpi_tpu_torch.models import llama as tl

    route = tmoe.route_topk
    calls = []

    def counting(*a, **kw):
        calls.append(a[1])
        return route(*a, **kw)

    monkeypatch.setattr(tmoe, "route_topk", counting)
    cfg = tl.moe_tiny()
    params = tl.init(0, cfg, device="cpu")
    with torch.no_grad():
        tl.apply(cfg, params, torch.zeros((1, 8), dtype=torch.int64))
    assert calls == [cfg.expert_top_k] * cfg.n_layers
