"""Llama's mesh paths in the port (``models/llama.py`` with ``mesh=``)
against the JAX package's GSPMD program on the same mesh shape, in one
spawned gloo pool of 4 ranks (one intra-op thread a rank).

``llama.tiny()`` (KV 2, so tp <= 2), f32, weights from the JAX package's
``init`` carried across by ``from_jax_params`` and placed by
``shard_params``, tokens from ``numpy.random.RandomState``; the JAX side
runs on ``devices[:4]`` of the 8-device CPU mesh (its Pallas flash blocks
in interpret mode).  Every rank passes the global batch:

* ``apply(mesh=)`` on {dp 2, tp 2}: each rank's block of the logits (its dp
  rows, the whole vocab) against JAX's logits, within 1e-5 relative
  (and 1e-5 absolute near 0: the tp sums add partials in another order);
* one ``make_train_step`` on {dp 2, tp 2} (``full``, ``flash``) and on
  {sp 2, tp 2} (``ring``, ``ring-zigzag``, ``ring-xla``, and ``full``,
  which gathers K/V over sp; the loss each returns is the loss under that
  mode; JAX's step needs a dp axis, so both take {dp 1, sp 2, tp 2}),
  SGD: the loss within 1e-5
  relative, and every leaf gathered back whole (``gather_params``) within
  1e-5 relative and 1e-6 absolute of JAX's updated leaf;
* Adam, with ``zero1`` on and off, on {dp 2, tp 2}: the loss within 1e-5
  relative; each leaf within 1e-4 relative and 1e-2 of the learning rate,
  except elements whose gradient (JAX's, at the start) is below 1e-4 of
  the leaf's largest: Adam's first step is ``-lr * g / (|g| + eps)``, so
  an element whose gradient nearly cancels carries the two programs'
  summation differences into its step at full size (as in
  ``tests/test_torch_llama_train.py``); those must still lie within the
  2 lr a step can differ by at most;
* greedy ``make_generate_fn(mesh=)`` on {dp 2, tp 2}: the same tokens as
  JAX's.

Then what still raises, with JAX's errors where JAX has them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.models import llama as tl
from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.runtime.communicator import Communicator
from torchmpi_tpu_torch.utils import tree as ttree

TOL = dict(rtol=1e-5, atol=1e-5)
LEAF_TOL = dict(rtol=1e-5, atol=1e-6)
SGD_LR, ADAM_LR = 0.1, 1e-3

# name -> (mesh axes, attn, optimizer, zero1, remat, loss_chunk)
STEPS = {
    "dp2tp2-full": ({"dp": 2, "tp": 2}, "full", None, False, "none", 0),
    "dp2tp2-flash": ({"dp": 2, "tp": 2}, "flash", None, False, "dots", 8),
    "sp2tp2-ring": ({"dp": 1, "sp": 2, "tp": 2}, "ring", None, False, "dots",
                    8),
    "sp2tp2-ring-zigzag": ({"dp": 1, "sp": 2, "tp": 2}, "ring-zigzag", None,
                           False, "full", 0),
    "sp2tp2-ring-xla": ({"dp": 1, "sp": 2, "tp": 2}, "ring-xla", None,
                        False, "none", 0),
    "sp2tp2-full": ({"dp": 1, "sp": 2, "tp": 2}, "full", None, False, "none",
                    0),
    "dp2tp2-adam": ({"dp": 2, "tp": 2}, "full", "adam", False, "none", 0),
    "dp2tp2-adam-zero1": ({"dp": 2, "tp": 2}, "flash", "adam", True, "dots",
                          8),
}


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


def _jax_params(cfg):
    import jax

    from torchmpi_tpu.models import llama as jl

    return jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), cfg))


def _jax_mesh(axes):
    import jax

    from torchmpi_tpu import parallel as jparallel

    return jparallel.make_mesh(axes, devices=jax.devices()[:4])


def _batch(cfg, B, L, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _apply_job(params, tokens):
    cfg = tl.tiny()
    m = tmesh.make_mesh({"dp": 2, "tp": 2})
    p = tl.shard_params(tl.from_jax_params(params, device="cpu"), m, cfg)
    with torch.no_grad():
        out = tl.apply(cfg, p, torch.from_numpy(tokens), mesh=m)
    return m.coords["dp"], out.numpy()


def test_apply_logits_match_jax(pool):
    import jax

    from torchmpi_tpu.models import llama as jl

    cfg = jl.tiny()
    params = _jax_params(cfg)
    tokens, _ = _batch(cfg, 4, 16)
    mesh = _jax_mesh({"dp": 2, "tp": 2})
    sharded = jl.shard_params(params, mesh, cfg)
    want = np.asarray(jax.jit(lambda p, t: jl.apply(cfg, p, t, mesh=mesh))(
        sharded, tokens))
    for dp_i, got in pool.run(_apply_job, params, tokens):
        np.testing.assert_allclose(got, want[2 * dp_i:2 * dp_i + 2], **TOL)


def _step_job(name, params, tokens, targets):
    from torchmpi_tpu_torch import optim

    axes, attn, opt_name, zero1, remat, chunk = STEPS[name]
    cfg = tl.tiny()
    m = tmesh.make_mesh(axes)
    p = tl.shard_params(tl.from_jax_params(params, device="cpu"), m, cfg)
    opt = optim.adam(ADAM_LR) if opt_name else None
    st = opt.init(p) if opt else None
    step = tl.make_train_step(cfg, m, lr=SGD_LR, attn=attn, optimizer=opt,
                              remat=remat, loss_chunk=chunk, zero1=zero1,
                              opt_state_example=st)
    p, st, loss = step(p, st, torch.from_numpy(tokens),
                       torch.from_numpy(targets))
    whole = tl.gather_params(p, m, cfg)
    leaves = [t.detach().numpy() for t in ttree.leaves(whole)]
    return float(loss), leaves


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_jax(pool, name):
    import jax
    import optax

    from torchmpi_tpu.models import llama as jl

    axes, attn, opt_name, zero1, remat, chunk = STEPS[name]
    cfg = jl.tiny()
    params = _jax_params(cfg)
    B = 2 * axes["dp"]
    tokens, targets = _batch(cfg, B, 16)
    mesh = _jax_mesh(axes)
    sharded = jl.shard_params(params, mesh, cfg)
    opt = optax.adam(ADAM_LR) if opt_name else None
    st, oex = None, None
    if opt is not None:
        oex = jax.eval_shape(opt.init, sharded)
        osh = jl._zero1_opt_shardings(cfg, mesh, oex) if zero1 else None
        st = jax.jit(opt.init, out_shardings=osh)(sharded)
    grads = None
    if opt is not None:
        loss_fn = jl.make_loss_fn(cfg, mesh=mesh, attn=attn, remat=remat,
                                  loss_chunk=chunk)
        grads = [np.abs(np.asarray(g)) for g in jax.tree.leaves(
            jax.grad(loss_fn)(sharded, (tokens, targets)))]
    step = jl.make_train_step(cfg, mesh, lr=SGD_LR, attn=attn, optimizer=opt,
                              remat=remat, loss_chunk=chunk, zero1=zero1,
                              opt_state_example=oex)
    want_p, _, want_loss = step(sharded, st, tokens, targets)
    want_leaves = [np.asarray(a) for a in jax.tree.leaves(want_p)]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want_p)]
    for r, (loss, leaves) in enumerate(pool.run(_step_job, name, params,
                                                tokens, targets)):
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        assert len(leaves) == len(want_leaves)
        for i, (got, want) in enumerate(zip(leaves, want_leaves)):
            what = f"rank {r} {paths[i]}"
            if opt is None:
                np.testing.assert_allclose(got, want, **LEAF_TOL,
                                           err_msg=what)
                continue
            off = ~np.isclose(got, want, rtol=1e-4, atol=1e-2 * ADAM_LR)
            assert (grads[i][off] < 1e-4 * grads[i].max()).all(), what
            assert (np.abs(got - want) <= 2 * ADAM_LR * (1 + 1e-3)).all(), \
                what


def _generate_job(params, prompt):
    cfg = tl.tiny()
    m = tmesh.make_mesh({"dp": 2, "tp": 2})
    p = tl.shard_params(tl.from_jax_params(params, device="cpu"), m, cfg)
    return tl.make_generate_fn(cfg, prompt.shape[1], 6, mesh=m,
                               device="cpu")(p, prompt).numpy()


def test_generate_tokens_match_jax(pool):
    import jax

    from torchmpi_tpu.models import llama as jl

    cfg = jl.tiny()
    params = _jax_params(cfg)
    prompt, _ = _batch(cfg, 4, 8, seed=3)
    mesh = _jax_mesh({"dp": 2, "tp": 2})
    gen = jl.make_generate_fn(cfg, prompt_len=8, max_new=6, mesh=mesh)
    want = np.asarray(gen(jl.shard_params(params, mesh, cfg), prompt,
                          jax.random.PRNGKey(1)))
    for got in pool.run(_generate_job, params, prompt):
        np.testing.assert_array_equal(got, want)


def _one_rank_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, comm=Communicator(range(n), my_rank=0))


def test_what_still_raises():
    """MoE names item 12a and the pp axis item 14; tp must divide the KV
    heads (JAX's generate check, same message); flash over sp names the
    ring modes; ring modes need an sp axis (JAX: an unbound axis)."""
    from torchmpi_tpu.models import llama as jl

    cfg = tl.tiny()
    moe = dataclasses.replace(cfg, n_experts=4)
    with pytest.raises(NotImplementedError, match="item 12a"):
        tl.make_train_step(moe, _one_rank_mesh({"dp": 1}))
    with pytest.raises(NotImplementedError, match="item 14"):
        tl.make_train_step(cfg, _one_rank_mesh({"pp": 2}))
    with pytest.raises(NotImplementedError, match="item 12a"):
        tl.make_train_step(cfg, _one_rank_mesh({"ep": 2}))
    kv1 = dataclasses.replace(cfg, n_kv_heads=1)
    with pytest.raises(ValueError) as jerr:
        jl.make_generate_fn(jl.tiny(), 8, 4, mesh=_jax_mesh({"tp": 4}))
    with pytest.raises(ValueError) as terr:
        tl.make_generate_fn(cfg, 8, 4, mesh=_one_rank_mesh({"tp": 4}),
                            device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="n_kv_heads"):
        tl.make_train_step(kv1, _one_rank_mesh({"tp": 2}))
    tokens = torch.zeros((2, 8), dtype=torch.long)
    params = tl.init(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tl.apply(cfg, params, tokens, mesh=_one_rank_mesh({"sp": 2}),
                 attn="flash")
    with pytest.raises(NameError, match="unbound axis name: sp"):
        tl.apply(cfg, params, tokens, mesh=_one_rank_mesh({"dp": 1}),
                 attn="ring")
    with pytest.raises(ValueError, match="zero1 needs optimizer"):
        tl.make_train_step(cfg, _one_rank_mesh({"dp": 1}), zero1=True)
