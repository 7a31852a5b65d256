"""Llama's pipeline steps in the port (``make_pp_train_step``, GPipe, and
``make_1f1b_train_step``, 1F1B) against the JAX package's on the same mesh
shape, in one spawned gloo pool of 4 ranks (one intra-op thread a rank).

Weights from the JAX package's ``init`` (f32) carried across by
``from_jax_params`` and placed by ``shard_params_pp``, tokens from
``numpy.random.RandomState``; the JAX side runs on ``devices[:4]`` of the
8-device CPU mesh (its Pallas flash blocks in interpret mode).  Every rank
passes the global batch.  One step each:

* GPipe on {pp 2, dp 2}: ``llama.tiny()`` (V = 1, M = 2, loss_chunk 8),
  and 4 layers (V = 2, M = 4, remat "dots"), SGD;
* GPipe on {pp 2, tp 2} with ``stage_tp="manual"``, ``attn="flash"``
  ({dp 2, pp 2, tp 2} would be 8 ranks);
* GPipe with Adam and ``zero1`` on {pp 2, dp 2};
* 1F1B on {pp 2, tp 2}, manual flash, ``"combined"`` and
  ``"alternating"`` (M = 4), and on {pp 2, dp 2} on the auto path.

The loss within 1e-5 relative and every leaf, gathered back whole
(``gather_params_pp``), within JAX's own bounds for the pipeline step
(``tests/test_llama.py``: rtol 2e-4, atol 2e-5); under Adam the leaves as
in ``tests/test_torch_llama_mesh.py`` (an element whose gradient nearly
cancels carries the two programs' summation differences into its step at
full size).  The whole trees of the 4 ranks are equal bit for bit: the
replicated leaves (embed, norm, and the head off tp) stay equal on every
pp and dp rank.  The 1F1B stash never exceeds the schedule's bound.  Then
the errors both packages raise.
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

LEAF_TOL = dict(rtol=2e-4, atol=2e-5)
SGD_LR, ADAM_LR = 0.1, 1e-3

# name -> (mesh axes, schedule, n_layers, M, attn, remat, loss_chunk,
#          optimizer, zero1, stage_tp, manual_schedule)
STEPS = {
    "gpipe-pp2dp2": ({"pp": 2, "dp": 2}, "gpipe", 2, 2, "full", "none", 8,
                     None, False, "auto", None),
    "gpipe-pp2dp2-v2-dots": ({"pp": 2, "dp": 2}, "gpipe", 4, 4, "full",
                             "dots", 0, None, False, "auto", None),
    "gpipe-pp2tp2-manual-flash": ({"pp": 2, "tp": 2}, "gpipe", 2, 2,
                                  "flash", "none", 0, None, False, "manual",
                                  None),
    "gpipe-pp2dp2-adam-zero1": ({"pp": 2, "dp": 2}, "gpipe", 2, 2, "full",
                                "none", 0, "adam", True, "auto", None),
    "1f1b-pp2tp2-combined": ({"pp": 2, "tp": 2}, "1f1b", 2, 4, "flash",
                             "none", 0, None, False, "manual", "combined"),
    "1f1b-pp2tp2-alternating": ({"pp": 2, "tp": 2}, "1f1b", 2, 4, "flash",
                                "none", 0, None, False, "manual",
                                "alternating"),
    "1f1b-pp2dp2-auto": ({"pp": 2, "dp": 2}, "1f1b", 2, 4, "full", "none",
                         0, None, False, "auto", None),
}


def _cfg(n_layers):
    if n_layers == 2:
        return tl.tiny()
    return dataclasses.replace(tl.tiny(), n_layers=n_layers)


def _setup():
    """A rank of the pool: the process group is up; each job starts the
    runtime on it and stops it (:func:`_in_world`), so a job may run an
    example that starts it itself."""
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def _in_world(fn, *args):
    from torchmpi_tpu_torch.runtime import lifecycle

    lifecycle.start(device="cpu")
    try:
        return fn(*args)
    finally:
        lifecycle.stop()


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup, timeout_s=180)
    yield pl
    pl.close()


def _batch(cfg, B, L, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _step_kwargs(name):
    axes, sched, _, M, attn, remat, chunk, _, _, stage_tp, ms = STEPS[name]
    kw = dict(n_microbatches=M, attn=attn, remat=remat, loss_chunk=chunk,
              stage_tp=stage_tp)
    if sched == "1f1b":
        kw["lr"] = SGD_LR
        if ms is not None:
            kw["manual_schedule"] = ms
    return kw


def _step_job(name, params, tokens, targets):
    from torchmpi_tpu_torch import optim

    axes, sched, n_layers, _, _, _, _, opt_name, zero1, _, _ = STEPS[name]
    cfg = _cfg(n_layers)
    m = tmesh.make_mesh(axes)
    p = tl.shard_params_pp(tl.from_jax_params(params, device="cpu"), m, cfg)
    kw = _step_kwargs(name)
    high = None
    if sched == "1f1b":
        step, V = tl.make_1f1b_train_step(cfg, m, **kw)
        p, loss = step(p, torch.from_numpy(tokens), torch.from_numpy(targets))
        high = (step.pipe.stash_high_water, step.pipe.stash_bound)
    elif opt_name:
        opt = optim.adam(ADAM_LR)
        st = opt.init(p)    # a zero1 step cuts a whole state to its blocks
        step, V = tl.make_pp_train_step(cfg, m, optimizer=opt, zero1=zero1,
                                        opt_state_example=st, **kw)
        p, st, loss = step(p, st, torch.from_numpy(tokens),
                           torch.from_numpy(targets))
    else:
        step, V = tl.make_pp_train_step(cfg, m, lr=SGD_LR, **kw)
        p, loss = step(p, torch.from_numpy(tokens), torch.from_numpy(targets))
    whole = tl.gather_params_pp(p, m, cfg)
    leaves = [t.detach().numpy() for t in ttree.leaves(whole)]
    return float(loss), leaves, V, high


_ORACLE = {}


def _oracle(n_layers, tokens, targets):
    """The JAX package's single-device loss and gradients on the same
    weights and batch (the reference its own pipeline tests hold its pp
    steps to), once per depth."""
    import jax

    from torchmpi_tpu.models import llama as jl

    if n_layers not in _ORACLE:
        cfg = jl.Config(**dataclasses.asdict(_cfg(n_layers)))
        params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), cfg))
        loss, grads = jax.jit(jax.value_and_grad(jl.make_loss_fn(cfg)))(
            params, (tokens, targets))
        _ORACLE[n_layers] = (params, float(loss), grads)
    return _ORACLE[n_layers]


def _check_ranks(res, want_loss, want, paths, grads=None):
    for r, (loss, leaves, _, high) in enumerate(res):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert len(leaves) == len(want)
        for i, (got, w) in enumerate(zip(leaves, want)):
            what = f"rank {r} {paths[i]}"
            if grads is None:
                np.testing.assert_allclose(got, w, **LEAF_TOL, err_msg=what)
                continue
            off = ~np.isclose(got, w, rtol=1e-4, atol=1e-2 * ADAM_LR)
            assert (grads[i][off] < 1e-4 * grads[i].max()).all(), what
            assert (np.abs(got - w) <= 2 * ADAM_LR * (1 + 1e-3)).all(), what
        for got, first in zip(leaves, res[0][1]):
            assert np.array_equal(got, first), f"rank {r} differs"
        if high is not None:
            assert 1 <= high[0] <= high[1], high


@pytest.mark.parametrize("name", sorted(STEPS))
def test_pp_train_step_matches_jax(pool, name):
    """One step against the JAX package's single-device step on the same
    weights and batch: ``p - lr g`` (or optax's Adam) with
    ``jax.value_and_grad(make_loss_fn(cfg))``."""
    import jax
    import optax

    _, sched, n_layers, _, _, _, _, opt_name, _, _, _ = STEPS[name]
    cfg = _cfg(n_layers)
    tokens, targets = _batch(cfg, 8, 16)
    params, want_loss, g = _oracle(n_layers, tokens, targets)
    grads = None
    if opt_name:
        opt = optax.adam(ADAM_LR)
        want_p = jax.jit(lambda g, p: optax.apply_updates(
            p, opt.update(g, opt.init(p), p)[0]))(g, params)
        grads = [np.abs(np.asarray(a)) for a in jax.tree.leaves(g)]
    else:
        want_p = jax.tree.map(lambda p, d: p - SGD_LR * d, params, g)
    want = [np.asarray(a) for a in jax.tree.leaves(want_p)]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want_p)]
    res = pool.run(_in_world, _step_job, name, params, tokens, targets)
    assert all(v == n_layers // 2 for _, _, v, _ in res)
    _check_ranks(res, want_loss, want, paths, grads)


def test_1f1b_combined_matches_jax_pipeline_step(pool):
    """The 1F1B combined step on {pp 2, tp 2} against the JAX package's own
    ``make_1f1b_train_step`` on the same mesh shape (its cond-free body,
    flash in interpret mode)."""
    import jax

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.models import llama as jl

    name = "1f1b-pp2tp2-combined"
    axes = STEPS[name][0]
    cfg = jl.tiny()
    tokens, targets = _batch(cfg, 8, 16)
    params, _, _ = _oracle(2, tokens, targets)
    mesh = jparallel.make_mesh(axes, devices=jax.devices()[:4])
    step, V = jl.make_1f1b_train_step(cfg, mesh, **_step_kwargs(name))
    want_p, want_loss = step(
        jl.shard_params_pp(jax.tree.map(np.copy, params), mesh, cfg),
        tokens, targets)
    want = [np.asarray(a) for a in jax.tree.leaves(jax.device_get(want_p))]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want_p)]
    res = pool.run(_in_world, _step_job, name, params, tokens, targets)
    assert all(v == V for _, _, v, _ in res)
    _check_ranks(res, float(want_loss), want, paths)


def _one_rank_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, comm=Communicator(range(n), my_rank=0))


def test_pp_errors_equal_jax():
    """MoE, n_layers % S, attn, manual without flash or without a tp axis,
    tp not dividing, zero1 without an optimizer, stage_tp and
    manual_schedule: the JAX package's errors (type and message)."""
    import jax

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.models import llama as jl

    cfg = tl.tiny()
    jcfg = jl.tiny()
    moe = dataclasses.replace(cfg, n_experts=4)
    jmoe = dataclasses.replace(jcfg, n_experts=4)
    three = dataclasses.replace(cfg, n_layers=3)
    jthree = dataclasses.replace(jcfg, n_layers=3)
    devs = jax.devices()
    cases = [
        ({"pp": 2}, lambda mod, m, c: mod.make_pp_train_step(c, m, 2),
         "moe"),
        ({"pp": 2}, lambda mod, m, c: mod.make_1f1b_train_step(c, m, 2),
         "moe"),
        ({"pp": 2}, lambda mod, m, c: mod.make_pp_train_step(c, m, 2),
         "three"),
        ({"pp": 2}, lambda mod, m, c: mod.make_pp_train_step(
            c, m, 2, attn="ring"), None),
        ({"pp": 2, "tp": 2}, lambda mod, m, c: mod.make_pp_train_step(
            c, m, 2, stage_tp="manual"), None),
        ({"pp": 2, "dp": 2}, lambda mod, m, c: mod.make_pp_train_step(
            c, m, 2, attn="flash", stage_tp="manual"), None),
        ({"pp": 2, "dp": 2}, lambda mod, m, c: mod.make_1f1b_train_step(
            c, m, 2, attn="flash", stage_tp="manual"), None),
        ({"pp": 2, "tp": 4}, lambda mod, m, c: mod.make_1f1b_train_step(
            dataclasses.replace(c, vocab=250), m, 2, attn="flash",
            stage_tp="manual"), None),
        ({"pp": 2}, lambda mod, m, c: mod.make_pp_train_step(
            c, m, 2, zero1=True), None),
        ({"pp": 2}, lambda mod, m, c: mod.make_pp_train_step(
            c, m, 2, stage_tp="bogus"), None),
        ({"pp": 2, "tp": 2}, lambda mod, m, c: mod.make_1f1b_train_step(
            c, m, 2, attn="flash", stage_tp="manual",
            manual_schedule="bogus"), None),
        ({"pp": 2}, lambda mod, m, c: mod.make_1f1b_train_step(
            c, m, 2, manual_schedule="alternating"), None),
    ]
    for axes, make, which in cases:
        n = int(np.prod(list(axes.values())))
        jmesh = jparallel.make_mesh(axes, devices=devs[:n])
        c, jc = {"moe": (moe, jmoe), "three": (three, jthree)}.get(
            which, (cfg, jcfg))
        with pytest.raises((ValueError, NotImplementedError)) as jerr:
            make(jl, jmesh, jc)
        with pytest.raises((ValueError, NotImplementedError)) as terr:
            make(tl, _one_rank_mesh(axes), c)
        assert type(terr.value) is type(jerr.value)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="sp axis"):
        tl.make_pp_train_step(cfg, _one_rank_mesh({"pp": 2, "sp": 2}), 2)


def _train_llama_job(argv):
    import contextlib
    import io

    from torchmpi_tpu_torch.examples import train_llama

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            train_llama._run(train_llama.parse_args(argv))
    finally:
        torch.set_num_threads(1)
    return out.getvalue()


def test_train_llama_pp_example(pool):
    """``train_llama --pp 2 --microbatches 4`` (with ``--dp 2`` to fill the
    4 ranks) trains, prints the pipeline line, and generates after
    gathering the stages back."""
    text = pool.run(_train_llama_job, [
        "--device", "cpu", "--pp", "2", "--dp", "2", "--microbatches", "4",
        "--steps", "4", "--generate", "2"])[0]
    assert "pipeline: 2 stages x 1 layers/stage, 4 micro-batches" in text
    assert "tok/s" in text and "generation legality" in text, text
    with pytest.raises(SystemExit, match="does not compose with --pp"):
        _train_llama_job(["--device", "cpu", "--pp", "2", "--attn", "ring"])
