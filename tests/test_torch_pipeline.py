"""The port's pipeline over the ``pp`` axis (``parallel/pipeline.py``,
``parallel/blocks.py``) against the JAX package's, on the same seeded numpy
inputs.

* ``schedule_1f1b``: the (T, S) forward and backward arrays and the stash
  bound equal JAX's exactly for S in 1..4, M in 1..8, both settings of
  ``combined``; ``pipeline_stats`` and ``microbatch``/``unmicrobatch``
  equal JAX's too.
* ``partition_contiguous`` and ``BlockSequential`` as in JAX's
  ``tests/test_parallel.py``: the forward, the flatten/unflatten round
  trip and ``backward_step`` against the monolithic gradient, on the
  parameters of JAX's ``BlockSequential.init`` (f32, rtol 1e-6).
* ``make_pipeline_fn`` (GPipe) in one spawned gloo pool of 4 ranks (one
  intra-op thread a rank), on {pp 2, dp 2} and {pp 4}, with ``sharded_io``
  on and off, the residual-ReLU stage of ``mnist_pipeline``: this rank's
  outputs, its stage's gradients and its input gradients of
  ``sum(y ** 2)`` against JAX's on ``devices[:S]``, within 1e-5 relative
  (1e-6 absolute): f32 sums of at most 64 products, in other orders.
* ``make_1f1b_step`` on {pp 2, tp 2} with a hand-sharded Megatron stage
  (the f/g pair), loss parameters and ``return_dx``, ``"combined"`` and
  ``"alternating"``; and the base form on {pp 4}: the loss, this rank's
  stage gradients, the loss-parameter gradients and ``dx`` against JAX's,
  within 1e-5 relative (1e-6 absolute); the stash never above the
  schedule's bound.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.parallel import blocks as tblocks
from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.parallel import pipeline as tpl

TOL = dict(rtol=1e-5, atol=1e-6)
D, MB = 8, 2


# ------------------------------------------------------------ the numpy part

@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("S", range(1, 5))
def test_schedule_1f1b_equals_jax(S, M, combined):
    from torchmpi_tpu.parallel import pipeline as jpl

    fs, bs, stash = tpl.schedule_1f1b(S, M, combined=combined)
    jfs, jbs, jstash = jpl.schedule_1f1b(S, M, combined=combined)
    np.testing.assert_array_equal(fs, jfs)
    np.testing.assert_array_equal(bs, jbs)
    assert stash == jstash
    assert fs.dtype == jfs.dtype == np.int32


@pytest.mark.parametrize("mode", ["gpipe", "1f1b", "1f1b-combined"])
def test_pipeline_stats_equal_jax(mode):
    from torchmpi_tpu.parallel import pipeline as jpl

    for S, M in ((1, 1), (2, 4), (3, 5), (4, 8), (4, 16), (8, 64)):
        assert tpl.pipeline_stats(S, M, mode) == jpl.pipeline_stats(S, M,
                                                                    mode)
    with pytest.raises(ValueError) as jerr:
        jpl.pipeline_stats(2, 4, "bogus")
    with pytest.raises(ValueError) as terr:
        tpl.pipeline_stats(2, 4, "bogus")
    assert str(terr.value) == str(jerr.value)


def test_microbatch_roundtrip_equals_jax():
    from torchmpi_tpu.parallel import pipeline as jpl

    x = np.arange(24.0, dtype=np.float32).reshape(12, 2)
    m = tpl.microbatch(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jpl.microbatch(x, 4)))
    np.testing.assert_array_equal(tpl.unmicrobatch(m).numpy(), x)
    with pytest.raises(ValueError) as jerr:
        jpl.microbatch(x, 5)
    with pytest.raises(ValueError) as terr:
        tpl.microbatch(torch.from_numpy(x), 5)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------- BlockSequential

@pytest.mark.parametrize("sizes,n", [([10, 10, 10, 10], 2), ([1] * 7, 3),
                                     ([5], 4), ([100, 1, 1, 1], 2),
                                     ([], 3), ([3, 1, 4, 1, 5, 9, 2, 6], 4)])
def test_partition_contiguous_equals_jax(sizes, n):
    from torchmpi_tpu.parallel import blocks as jblocks

    assert tblocks.partition_contiguous(sizes, n) == \
        jblocks.partition_contiguous(sizes, n)


def _jax_layers():
    import jax
    import jax.numpy as jnp

    def dense(d_in, d_out):
        def init(k):
            return {"w": jax.random.normal(k, (d_in, d_out)) * 0.3,
                    "b": jnp.zeros((d_out,))}
        return init, lambda p, x: jnp.tanh(x @ p["w"] + p["b"])

    return [dense(4, 8), dense(8, 8), dense(8, 8), dense(8, 2)]


def _torch_layers():
    def dense(d_in, d_out):
        def init(gen):
            return {"w": torch.randn((d_in, d_out), generator=gen,
                                     device=gen.device) * 0.3,
                    "b": torch.zeros((d_out,), device=gen.device)}
        return init, lambda p, x: torch.tanh(x @ p["w"] + p["b"])

    return [dense(4, 8), dense(8, 8), dense(8, 8), dense(8, 2)]


def _to_torch(tree):
    if isinstance(tree, list):
        return [_to_torch(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_block_sequential_matches_jax():
    """The blocks, the forward, the flatten/unflatten round trip, zero_grad
    and update_parameters, and ``backward_step`` (last block first) against
    the monolithic gradient, on JAX's parameters."""
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu.parallel import blocks as jblocks

    jseq = jblocks.BlockSequential(_jax_layers(), max_blocks=2)
    jparams = jseq.init(jax.random.PRNGKey(0))
    tseq = tblocks.BlockSequential(_torch_layers(), max_blocks=2)
    tseq.init(0, device="cpu")
    assert tseq.bounds == jseq.bounds and tseq.num_blocks == 2
    params = _to_torch(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(tseq.apply(params, torch.from_numpy(x)).numpy(),
                               np.asarray(jseq.apply(jparams, x)), rtol=1e-6,
                               atol=1e-7)
    for i in range(2):
        flat = tseq.flatten_block(params, i)
        np.testing.assert_array_equal(flat.numpy(),
                                      np.asarray(jseq.flatten_block(jparams, i)))
        back = tseq.unflatten_block(params, i, flat)
        a, b = tseq.bounds[i]
        for got, want in zip(back, params[a:b]):
            for k in want:
                assert torch.equal(got[k], want[k])
    zeros = tseq.zero_grad(params)
    assert all(float(t.abs().sum()) == 0 for p in zeros for t in p.values())

    def tloss(ps, x):
        return torch.sum(tseq.apply(ps, x) ** 2)

    def jloss(ps, x):
        return jnp.sum(jseq.apply(ps, x) ** 2)

    got = list(tseq.backward_step(tloss, params, torch.from_numpy(x)))
    want = list(jseq.backward_step(jloss, jparams, x))
    assert [i for i, _ in got] == [i for i, _ in want] == [1, 0]
    for (_, g_t), (_, g_j) in zip(got, want):
        for gt, gj in zip(g_t, g_j):
            for k in gj:
                np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                           rtol=1e-5, atol=1e-6)
    grads = [g for _, gs in reversed(got) for g in gs]
    new = tseq.update_parameters(params, grads, 0.1)
    jnew = jseq.update_parameters(jparams, [g for _, gs in reversed(want)
                                            for g in gs], 0.1)
    for a, b in zip(new, jnew):
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ the spawned schedules

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


def _stages(S, seed):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(D, D) * (2.0 / D) ** 0.5).astype(np.float32),
             "b": (rng.randn(D) * 0.1).astype(np.float32)}
            for _ in range(S)]


def _gpipe_job(S, M, sharded, stages, x):
    """This rank's outputs, stage gradients and input gradients of
    sum(y ** 2) through the port's GPipe."""
    axes = {"pp": S} if S == 4 else {"pp": S, "dp": 4 // S}
    mesh = tmesh.make_mesh(axes)
    s = mesh.coords["pp"]
    stacked = tpl.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in st.items()} for st in stages])
    local = tpl.stage_sharding(mesh, stacked)
    for t in local.values():
        t.requires_grad_(True)

    def stage_fn(p, h):
        return torch.relu(h @ p["w"] + p["b"]) + h

    fn = tpl.make_pipeline_fn(mesh, stage_fn, M, sharded_io=sharded)
    xt = torch.from_numpy(x)
    if sharded:
        G = M // S
        xt = xt[s * G:(s + 1) * G]
    xt = xt.clone().requires_grad_(True)
    y = fn(local, xt)
    gw, gb, gx = torch.autograd.grad(torch.sum(y ** 2),
                                     [local["w"], local["b"], xt])
    return {"s": s, "y": y.detach().numpy(), "w": gw.numpy(),
            "b": gb.numpy(), "x": gx.numpy()}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("sharded", [True, False])
def test_make_pipeline_fn_matches_jax(pool, S, sharded):
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.parallel import pipeline as jpl

    M = 4
    stages = _stages(S, seed=S)
    x = np.random.RandomState(10 + S).randn(M, MB, D).astype(np.float32)
    mesh = jparallel.make_mesh({"pp": S}, devices=jax.devices()[:S])
    stacked = jpl.stage_sharding(mesh, jpl.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in st.items()} for st in stages]))
    fn = jpl.make_pipeline_fn(
        mesh, lambda p, h: jax.nn.relu(h @ p["w"] + p["b"]) + h, M,
        sharded_io=sharded)
    y = np.asarray(jax.jit(fn)(stacked, x))
    g_p, g_x = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2),
                                argnums=(0, 1)))(stacked, x)
    G = M // S
    for r in pool.run(_in_world, _gpipe_job, S, M, sharded, stages, x):
        s = r["s"]
        rows = slice(s * G, (s + 1) * G) if sharded else slice(None)
        np.testing.assert_allclose(r["y"], y[rows], **TOL)
        np.testing.assert_allclose(r["x"], np.asarray(g_x)[rows], **TOL)
        np.testing.assert_allclose(r["w"], np.asarray(g_p["w"])[s:s + 1],
                                   **TOL)
        np.testing.assert_allclose(r["b"], np.asarray(g_p["b"])[s:s + 1],
                                   **TOL)


F_TP, C = 8, 3          # the stage's hidden width (sharded over tp), classes


def _1f1b_inputs(M, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, MB, D).astype(np.float32)
    tgt = rng.randn(M, MB, C).astype(np.float32)
    head = (rng.randn(D, C) * 0.5).astype(np.float32)
    stages = [{"w1": (rng.randn(D, F_TP) * 0.4).astype(np.float32),
               "w2": (rng.randn(F_TP, D) * 0.4).astype(np.float32)}
              for _ in range(2)]
    return x, tgt, head, stages


def _1f1b_manual_job(schedule, M, x, tgt, head, stages):
    from torchmpi_tpu_torch.parallel import tp

    mesh = tmesh.make_mesh({"pp": 2, "tp": 2})
    s, k = mesh.coords["pp"], mesh.coords["tp"]
    n = F_TP // 2
    local = {"w1": torch.from_numpy(stages[s]["w1"][None, :, k * n:(k + 1) * n]),
             "w2": torch.from_numpy(stages[s]["w2"][None, k * n:(k + 1) * n])}

    def stage_fn(p, h):
        x_ = tp.block_input(h, "tp", mesh=mesh)
        return h + tp.block_output(torch.tanh(x_ @ p["w1"]) @ p["w2"], "tp",
                                   mesh=mesh)

    def loss_fn(lp, h, t):
        return torch.mean((h @ lp["w"] - t) ** 2)

    step = tpl.make_1f1b_step(mesh, stage_fn, loss_fn, M,
                              loss_params_example={"w": None},
                              return_dx=True, manual_axes=("tp",),
                              manual_schedule=schedule)
    loss, grads, lp_grads, dx = step(local, {"w": torch.from_numpy(head)},
                                     torch.from_numpy(x), torch.from_numpy(tgt))
    return {"s": s, "k": k, "loss": float(loss),
            "w1": grads["w1"].numpy(), "w2": grads["w2"].numpy(),
            "head": lp_grads["w"].numpy(), "dx": dx.numpy(),
            "high": step.stash_high_water, "bound": step.stash_bound}


@pytest.mark.parametrize("schedule", ["combined", "alternating"])
def test_make_1f1b_step_manual_tp_matches_jax(pool, schedule):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.parallel import pipeline as jpl
    from torchmpi_tpu.parallel import tp as jtp

    M = 4
    x, tgt, head, stages = _1f1b_inputs(M, seed=3)
    mesh = jparallel.make_mesh({"pp": 2, "tp": 2},
                               devices=jax.devices()[:4])

    def stage_fn(p, h):
        x_ = jtp.block_input(h, "tp")
        return h + jtp.block_output(jnp.tanh(x_ @ p["w1"]) @ p["w2"], "tp")

    def loss_fn(lp, h, t):
        return jnp.mean((h @ lp["w"] - t) ** 2)

    stacked = jpl.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in st.items()} for st in stages])
    step = jpl.make_1f1b_step(
        mesh, stage_fn, loss_fn, M, loss_params_example={"w": head},
        return_dx=True, manual_axes=("tp",),
        param_in_specs={"w1": P("pp", None, "tp"), "w2": P("pp", "tp", None)},
        manual_schedule=schedule)
    loss, g, g_lp, dx = jax.jit(step)(stacked, {"w": jnp.asarray(head)}, x,
                                      tgt)
    n = F_TP // 2
    _, _, bound = jpl.schedule_1f1b(2, M, combined=schedule == "combined")
    for r in pool.run(_in_world, _1f1b_manual_job, schedule, M, x, tgt, head, stages):
        s, k = r["s"], r["k"]
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(
            r["w1"], np.asarray(g["w1"])[s:s + 1, :, k * n:(k + 1) * n], **TOL)
        np.testing.assert_allclose(
            r["w2"], np.asarray(g["w2"])[s:s + 1, k * n:(k + 1) * n], **TOL)
        np.testing.assert_allclose(r["head"], np.asarray(g_lp["w"]), **TOL)
        np.testing.assert_allclose(r["dx"], np.asarray(dx), **TOL)
        assert r["bound"] == bound and 1 <= r["high"] <= bound


def _1f1b_base_job(M, x, tgt, stages):
    mesh = tmesh.make_mesh({"pp": 4})
    s = mesh.coords["pp"]
    local = {k: torch.from_numpy(v[None]) for k, v in stages[s].items()}
    step = tpl.make_1f1b_step(
        mesh, lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
        lambda h, t: torch.mean((h - t) ** 2), M)
    loss, grads = step(local, torch.from_numpy(x), torch.from_numpy(tgt))
    return {"s": s, "loss": float(loss), "w": grads["w"].numpy(),
            "b": grads["b"].numpy(), "high": step.stash_high_water,
            "bound": step.stash_bound}


def test_make_1f1b_step_base_form_matches_jax(pool):
    """No manual axes, no loss parameters: the alternating schedule on {pp
    4}, as JAX's ``test_1f1b_matches_sequential``."""
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.parallel import pipeline as jpl

    M = 8
    stages = _stages(4, seed=7)
    rng = np.random.RandomState(8)
    x = rng.randn(M, MB, D).astype(np.float32)
    tgt = rng.randn(M, MB, D).astype(np.float32)
    mesh = jparallel.make_mesh({"pp": 4}, devices=jax.devices()[:4])
    stacked = jpl.stage_sharding(mesh, jpl.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in st.items()} for st in stages]))
    step = jpl.make_1f1b_step(
        mesh, lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        lambda h, t: jnp.mean((h - t) ** 2), M)
    loss, g = jax.jit(step)(stacked, x, tgt)
    _, _, bound = jpl.schedule_1f1b(4, M)
    for r in pool.run(_in_world, _1f1b_base_job, M, x, tgt, stages):
        s = r["s"]
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(r["w"], np.asarray(g["w"])[s:s + 1], **TOL)
        np.testing.assert_allclose(r["b"], np.asarray(g["b"])[s:s + 1], **TOL)
        assert r["bound"] == bound and 1 <= r["high"] <= bound


def test_validation_errors_equal_jax():
    """The errors a caller meets before any rank runs: sharded_io's
    divisibility, manual_schedule, io_batch_axis outside manual_axes, and
    a stacked stage count that is not the pp axis."""
    import jax

    from torchmpi_tpu import parallel as jparallel
    from torchmpi_tpu.parallel import pipeline as jpl
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    jmesh = jparallel.make_mesh({"pp": 2}, devices=jax.devices()[:2])
    tmesh_ = tmesh.make_mesh({"pp": 2}, comm=Communicator(range(2),
                                                          my_rank=0))
    f = lambda p, h: h  # noqa: E731
    cases = [
        (lambda m, mod: mod.make_pipeline_fn(m, f, 3, sharded_io=True)),
        (lambda m, mod: mod.make_1f1b_step(m, f, f, 4,
                                           manual_schedule="bogus")),
        (lambda m, mod: mod.make_1f1b_step(m, f, f, 4,
                                           io_batch_axis="dp")),
    ]
    for case in cases:
        with pytest.raises(ValueError) as jerr:
            case(jmesh, jpl)
        with pytest.raises(ValueError) as terr:
            case(tmesh_, tpl)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="stacked stage count 4 != pp axis"):
        tpl._check_one_stage_per_device({"w": torch.zeros((2, 3))}, 2)


# ---------------------------------------------------------- config 4's example

def _mnist_pipeline_job(argv):
    import contextlib
    import io

    from torchmpi_tpu_torch.examples import mnist_pipeline as ex

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ex.run(ex.parse_args(argv))
    return res, out.getvalue()


def test_mnist_pipeline_example_converges(pool):
    """BASELINE config 4 on the 4 ranks ({pp 4}, sharded I/O) at a small
    synthetic size, by the JAX package's bar for its examples
    (``tests/test_examples.py`` ``_assert_converged``: the loss down by
    0.2, accuracy above 30%); the ranks agree on the losses."""
    res = pool.run(_mnist_pipeline_job, [
        "--device", "cpu", "--limit", "1024", "--epochs", "2"])
    (r0, text), _ = res[0], None
    assert "pipeline: 4 stages x 4 micro-batches, width 128" in text
    assert "final accuracy" in text and "epoch 1: loss" in text
    losses = r0["epoch_losses"]
    assert losses[-1] < losses[0] - 0.2, losses
    assert r0["accuracy"] > 0.30, r0["accuracy"]
    assert all(r["epoch_losses"] == losses and r["accuracy"] == r0["accuracy"]
               for r, _ in res)
    assert r0["devices"] == ["cpu"]
