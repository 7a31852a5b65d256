"""Llama's mixture-of-experts paths in the port (``models/llama.py`` with
``n_experts > 0``) against the JAX package on the same inputs.

``moe_tiny()`` (4 experts, top-2), f32, weights from the JAX package's
``init`` carried across by ``from_jax_params``, tokens from
``numpy.random.RandomState``:

* one device, at 16-token routing groups: ``apply``'s logits within 1e-5
  (relative and absolute) of JAX's and the aux loss within 1e-6
  relative; the loss and the router/expert gradients within 1e-5; the
  dropless greedy tokens of ``make_generate_fn`` equal JAX's and the
  teacher-forced argmax;
* ``_moe_group`` on JAX's sliver cases, and ``mixtral_8x7b()``'s fields;
* greedy ``make_generate_fn(mesh=)`` on both meshes below: the global
  tokens of every rank equal JAX's;
* in one spawned gloo pool of 4 ranks (one thread a rank), three SGD
  steps of ``make_train_step`` on {dp 2, ep 2} (the routing groups span
  the dp ranks: the gathered path) and on {ep 2, tp 2} (whole groups on
  every rank; JAX's step needs a dp axis, so both take dp 1), their
  losses within 1e-4 relative of JAX's on the same
  mesh over ``devices[:4]`` (the bound JAX's
  ``test_ep_train_matches_dp_only`` holds), and every leaf gathered back
  whole within 1e-5 relative and 1e-6 absolute of JAX's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.models import llama as tl
from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.utils import tree as ttree

LR = 0.5
STEPS = 3
MESHES = {"dp2ep2": {"dp": 2, "ep": 2}, "ep2tp2": {"dp": 1, "ep": 2, "tp": 2}}


def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(1)
    lifecycle.start(device="cpu")


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup_cpu, timeout_s=180)
    yield pl
    pl.close()


@functools.lru_cache(maxsize=None)
def _jax_params_cached(cfg, seed):
    import jax

    from torchmpi_tpu.models import llama as jl

    init = jax.jit(lambda key: jl.init(key, cfg))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _jax_params(cfg, seed=0):
    import jax

    return jax.tree.map(np.copy, _jax_params_cached(cfg, seed))


def _batch(cfg, B, L, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def test_forward_loss_and_gradients_match_jax():
    """16-token routing groups (4 of them): the logits, the aux loss, the
    loss and the gradients against JAX's, computed in one jitted call."""
    import jax

    from torchmpi_tpu.models import llama as jl

    cfg = dataclasses.replace(jl.moe_tiny(), moe_group_size=16)
    tcfg = dataclasses.replace(tl.moe_tiny(), moe_group_size=16)
    params = _jax_params(cfg)
    tokens, targets = _batch(cfg, 4, 16)

    def reference(p, t, y):
        out = jl.apply(cfg, p, t, return_aux=True)
        return out, jax.value_and_grad(jl.make_loss_fn(cfg))(p, (t, y))

    (want, aux), (loss, grads) = jax.jit(reference)(params, tokens, targets)
    tp = tl.from_jax_params(params, device="cpu")
    with torch.no_grad():
        got, gaux = tl.apply(tcfg, tp, torch.from_numpy(tokens),
                             return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(gaux), float(aux), rtol=1e-6)
    assert 0.5 < float(gaux) < 2.0
    for t in tl._leaves(tp):
        t.requires_grad_(True)
    tloss = tl.make_loss_fn(tcfg)(
        tp, (torch.from_numpy(tokens), torch.from_numpy(targets)))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-6)
    for name in ("router", "w_gate", "w_up", "w_down", "wq"):
        np.testing.assert_allclose(tp["layers"][name].grad.numpy(),
                                   np.asarray(grads["layers"][name]),
                                   rtol=1e-5, atol=1e-6)


GEN_PROMPT, GEN_NEW = (2, 8), 6


@functools.lru_cache(maxsize=None)
def _jax_generated():
    """The JAX package's greedy tokens and the prompt (capacity factor 8:
    the teacher-forced forward is dropless too)."""
    import jax

    from torchmpi_tpu.models import llama as jl

    cfg = dataclasses.replace(jl.moe_tiny(), capacity_factor=8.0)
    prompt = np.random.RandomState(7).randint(0, cfg.vocab, GEN_PROMPT)
    prompt = prompt.astype(np.int32)
    toks = jl.make_generate_fn(cfg, GEN_PROMPT[1], GEN_NEW)(
        _jax_params(cfg, seed=3), prompt, jax.random.PRNGKey(0))
    return prompt, np.asarray(toks)


def test_generate_matches_jax_and_teacher_forced():
    from torchmpi_tpu.models import llama as jl

    tcfg = dataclasses.replace(tl.moe_tiny(), capacity_factor=8.0)
    prompt, want = _jax_generated()
    tparams = tl.from_jax_params(_jax_params(
        dataclasses.replace(jl.moe_tiny(), capacity_factor=8.0), seed=3),
        device="cpu")
    got = tl.make_generate_fn(tcfg, GEN_PROMPT[1], GEN_NEW, device="cpu")(
        tparams, torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)
    seq = prompt
    with torch.no_grad():
        for i in range(GEN_NEW):
            logits = tl.apply(tcfg, tparams, torch.from_numpy(seq))
            nxt = logits[:, -1].argmax(-1).numpy().astype(np.int32)
            np.testing.assert_array_equal(got[:, i], nxt)
            seq = np.concatenate([seq, nxt[:, None]], axis=1)


@pytest.mark.parametrize("n", [2048, 2 * 1021, 1021, 48, 64, 7])
def test_moe_group_matches_jax(n):
    from torchmpi_tpu.models import llama as jl

    cfg = dataclasses.replace(jl.moe_tiny(), moe_group_size=512)
    tcfg = dataclasses.replace(tl.moe_tiny(), moe_group_size=512)
    assert tl._moe_group(tcfg, n) == jl._moe_group(cfg, n)
    g = tl._moe_group(tcfg, n)
    assert tl._moe_capacity(tcfg, g) == jl._moe_capacity(cfg, g)


def test_mixtral_fields_equal_jax():
    from torchmpi_tpu.models import llama as jl

    assert dataclasses.asdict(tl.mixtral_8x7b()) == \
        dataclasses.asdict(jl.mixtral_8x7b())
    assert dataclasses.asdict(tl.moe_tiny()) == \
        dataclasses.asdict(jl.moe_tiny())
    assert tl.param_shapes(tl.moe_tiny()) == {
        "embed": (256, 64), "norm": (64,), "head": (64, 256),
        "layers": {k: tuple(v.shape) for k, v in
                   _jax_params(jl.moe_tiny())["layers"].items()}}
    with pytest.raises(ValueError):
        tl.Config(n_experts=2, expert_top_k=3)


def _train_job(name, params, tokens, targets):
    cfg = tl.moe_tiny()
    m = tmesh.make_mesh(MESHES[name])
    p = tl.shard_params(tl.from_jax_params(params, device="cpu"), m, cfg)
    shapes = {k: tuple(v.shape) for k, v in p["layers"].items()}
    step = tl.make_train_step(cfg, m, lr=LR)
    losses = []
    for _ in range(STEPS):
        p, _, loss = step(p, None, torch.from_numpy(tokens),
                          torch.from_numpy(targets))
        losses.append(float(loss))
    whole = tl.gather_params(p, m, cfg)
    return losses, shapes, [t.detach().numpy() for t in ttree.leaves(whole)]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_train_step_matches_jax(pool, name):
    import jax

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.models import llama as jl

    cfg = jl.moe_tiny()
    params = _jax_params(cfg)
    tokens, targets = _batch(cfg, 8, 16)
    mesh = jparallel.make_mesh(MESHES[name], devices=jax.devices()[:4])
    jp = jl.shard_params(params, mesh, cfg)
    step = jl.make_train_step(cfg, mesh, lr=LR)
    want = []
    for _ in range(STEPS):
        jp, _, loss = step(jp, None, tokens, targets)
        want.append(float(loss))
    want_leaves = [np.asarray(a) for a in jax.tree.leaves(jp)]
    axes = MESHES[name]
    for losses, shapes, leaves in pool.run(_train_job, name, params, tokens,
                                           targets):
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        assert shapes["w_gate"] == (2, 4 // axes.get("ep", 1), 64,
                                    128 // axes.get("tp", 1))
        for got, w in zip(leaves, want_leaves):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    assert want[-1] < want[0]


def _generate_job(name, params, prompt):
    cfg = dataclasses.replace(tl.moe_tiny(), capacity_factor=8.0)
    m = tmesh.make_mesh(MESHES[name])
    p = tl.shard_params(tl.from_jax_params(params, device="cpu"), m, cfg)
    return tl.make_generate_fn(cfg, GEN_PROMPT[1], GEN_NEW, mesh=m,
                               device="cpu")(p, torch.from_numpy(prompt)
                                             ).numpy()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_generate_on_mesh_matches_jax(pool, name):
    """Greedy generation over the mesh (the prefill's routing groups span
    the dp ranks on {dp 2, ep 2}; the dropless decode's expert outputs sum
    over ep x tp): every rank's global tokens equal JAX's."""
    from torchmpi_tpu.models import llama as jl

    cfg = dataclasses.replace(jl.moe_tiny(), capacity_factor=8.0)
    prompt, want = _jax_generated()
    for got in pool.run(_generate_job, name, _jax_params(cfg, seed=3),
                        prompt):
        np.testing.assert_array_equal(got, want)
