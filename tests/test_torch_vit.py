"""Parity of the port's ViT (``torchmpi_tpu_torch/models/vit.py``) with the
JAX package's ``models/vit.py``.

``vit.tiny()`` (32x32x3 images, patch 8: 16 patches, d_model 64, 4 heads
of 16, 2 layers, 10 classes), weights from the JAX package's ``init``
carried across by ``from_jax_params``, images and labels from
``numpy.random.RandomState``.  The JAX side runs its Pallas flash kernels
in interpret mode (automatic off-TPU); the port's flash path on CPU tensors
runs the kernels' plain versions.  Both compute in f32 unless stated, so
the tolerance is f32 summation order (1e-5).

The mesh cases run in one spawned gloo pool of 4 ranks (one intra-op
thread a rank), every rank passing the global batch: {tp 2} (two meshes,
ranks 0-1 and 2-3), {dp 2, tp 2} and {tp 4} (whose 10-class head tp does
not divide, so it stays replicated) forwards against JAX's unsharded
``apply``; ``make_loss_fn(mesh=)``'s loss and gradients on {dp 2, tp 2};
the shard/gather round trip; and ``AllReduceSGDEngine`` in
``compiled`` mode with the rings on over the dp pairs of {dp 2, tp 2}
(two independent 2-rank trainings), whose step losses must follow a JAX
``value_and_grad`` SGD replay over the global batch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmpi_tpu.models import vit as jv
from torchmpi_tpu_torch.models import vit as tv
from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.runtime.communicator import Communicator

TOL = dict(rtol=1e-5, atol=1e-5)
SGD_LR, ENGINE_STEPS, RANK_BATCH = 0.05, 4, 4


def _cfg(n_registers=0):
    return dataclasses.replace(jv.tiny(), n_registers=n_registers)


def _tcfg(n_registers=0):
    return dataclasses.replace(tv.tiny(), n_registers=n_registers)


def _jax_params(cfg, dtype=jnp.float32):
    return jax.tree.map(np.asarray, jv.init(jax.random.PRNGKey(0), cfg,
                                            dtype=dtype))


def _batch(B=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.int32)
    return x, y


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("n_registers", [0, 16])
@pytest.mark.parametrize("attn", ["full", "flash"])
def test_apply_matches_jax(attn, n_registers):
    cfg = _cfg(n_registers)
    params = _jax_params(cfg)
    x, _ = _batch()
    want = np.asarray(jax.jit(lambda p, x: jv.apply(cfg, p, x, attn=attn))(
        params, x))
    with torch.no_grad():
        got = tv.apply(_tcfg(n_registers),
                       tv.from_jax_params(params, device="cpu"),
                       torch.from_numpy(x), attn=attn)
    assert got.shape == (4, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _port_loss_and_grads(cfg, params, batch, **kw):
    p = tv.from_jax_params(params, device="cpu")
    leaves = [t.requires_grad_() for _, t in _leaves(p)]
    x, y = batch
    loss = tv.make_loss_fn(cfg, **kw)(p, (torch.from_numpy(x),
                                          torch.from_numpy(y)))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _check_grads(got_loss, got, want_loss, want):
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    for (name, w), g in zip(_leaves(want), got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_loss_and_every_gradient_match_jax(attn):
    # Registers included: they join attention, so they take a gradient.
    cfg = _cfg(16)
    params = _jax_params(cfg)
    batch = _batch(seed=1)
    want_loss, want = jax.jit(jax.value_and_grad(
        jv.make_loss_fn(cfg, attn=attn)))(params, batch)
    got_loss, got = _port_loss_and_grads(_tcfg(16), params, batch,
                                         attn=attn)
    _check_grads(got_loss, got, want_loss, want)
    assert np.abs(got[[n for n, _ in _leaves(params)].index("/registers")]
                  ).sum() > 0


@functools.lru_cache(maxsize=None)
def _jax_remat_reference(remat):
    # JAX's two layer loops compute the same function of the parameters;
    # one compile a remat mode keeps the file fast.
    cfg = _cfg()
    return jax.jit(jax.value_and_grad(jv.make_loss_fn(
        cfg, remat=remat, layer_loop="scan")))(_jax_params(cfg),
                                               _batch(seed=2))


@pytest.mark.parametrize("layer_loop", ["unroll", "scan"])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_and_layer_loop_match_jax(remat, layer_loop):
    want_loss, want = _jax_remat_reference(remat)
    got_loss, got = _port_loss_and_grads(
        _tcfg(), _jax_params(_cfg()), _batch(seed=2), remat=remat,
        layer_loop=layer_loop)
    _check_grads(got_loss, got, want_loss, want)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_bf16_params_match_jax_bf16(attn):
    # bf16 weights (layer norms f32 on both sides): roundings differ in
    # place (the f32-accumulated einsums and products round once in each),
    # so within 2e-2 of the logits' largest magnitude.
    cfg = _cfg(16)
    params = _jax_params(cfg, dtype=jnp.bfloat16)
    p = tv.from_jax_params(params, device="cpu")
    assert p["layers"]["wqkv"].dtype == torch.bfloat16
    assert p["layers"]["ln1_scale"].dtype == torch.float32
    x, _ = _batch(seed=3)
    want = np.asarray(jax.jit(lambda p, x: jv.apply(cfg, p, x, attn=attn))(
        params, x))
    with torch.no_grad():
        got = tv.apply(_tcfg(16), p, torch.from_numpy(x), attn=attn)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_init_keeps_the_jax_tree_and_dtypes():
    cfg = _tcfg(16)
    p = tv.init(0, cfg, dtype=torch.bfloat16, device="cpu")
    want = _jax_params(_cfg(16), dtype=jnp.bfloat16)
    for (name, a), (wname, w) in zip(_leaves(p), _leaves(want)):
        assert name == wname and tuple(a.shape) == w.shape, name
        assert (a.dtype == torch.float32) == (w.dtype == np.float32), name
    assert tv.param_shapes(cfg) == jax.tree.map(
        lambda a: tuple(a.shape), want)


def test_vit_b16_param_count_on_meta():
    n = tv.num_params(tv.init(0, tv.vit_b16(), device="meta"))
    assert 85e6 < n < 90e6, n
    assert tv.vit_b16().head_dim == 64
    assert tv.vit_b16(60).seq_len == 256


def test_patchify_is_bit_equal():
    cfg = _cfg()
    x, _ = _batch(B=3, seed=4)
    want = np.asarray(jv.patchify(cfg, jnp.asarray(x)))
    got = tv.patchify(_tcfg(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kw,msg", [
    (dict(attn="ring"), "attn must be 'full' or 'flash'"),
    (dict(layer_loop="while"), "layer_loop must be 'unroll' or 'scan'"),
    (dict(remat="some"), "remat must be 'none', 'dots', or 'full'")])
def test_value_errors_match_jax(kw, msg):
    cfg = _cfg()
    params = _jax_params(cfg)
    x, _ = _batch(B=1)
    with pytest.raises(ValueError, match=msg):
        jv.apply(cfg, params, jnp.asarray(x), **kw)
    with pytest.raises(ValueError, match=msg):
        tv.apply(_tcfg(), tv.from_jax_params(params, device="cpu"),
                 torch.from_numpy(x), **kw)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tv.init(0, tv.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tv.from_jax_params(_jax_params(_cfg()))


# ----------------------------------------------------------------- the mesh

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


def _mesh(kind):
    """This rank's mesh: every rank makes every mesh of ``kind`` in one
    order (making a mesh makes its process groups)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    if kind == "tp2":
        pairs = [tmesh.make_mesh({"tp": 2}, comm=Communicator(r, my_rank=rank))
                 for r in ((0, 1), (2, 3))]
        return pairs[rank // 2]
    axes = {"dp2tp2": {"dp": 2, "tp": 2}, "tp4": {"tp": 4}}[kind]
    return tmesh.make_mesh(axes)


def _apply_job(kind, params, x, n_registers, attn):
    cfg = _tcfg(n_registers)
    m = _mesh(kind)
    p = tv.shard_params(tv.from_jax_params(params, device="cpu"), m, cfg)
    with torch.no_grad():
        out = tv.apply(cfg, p, torch.from_numpy(x), attn=attn, mesh=m)
    return m.coords.get("dp", 0), out.numpy()


@pytest.mark.parametrize("kind,n_registers,attn", [
    ("tp2", 16, "flash"), ("dp2tp2", 0, "full"), ("dp2tp2", 16, "flash"),
    ("tp4", 0, "flash")])
def test_mesh_forward_matches_jax(pool, kind, n_registers, attn):
    cfg = _cfg(n_registers)
    params = _jax_params(cfg)
    x, _ = _batch()
    want = np.asarray(jax.jit(lambda p, x: jv.apply(cfg, p, x, attn=attn))(
        params, x))
    for dp_i, got in pool.run(_apply_job, kind, params, x, n_registers,
                              attn):
        rows = 2 if kind == "dp2tp2" else 4
        assert got.shape == (rows, 10)
        np.testing.assert_allclose(got, want[dp_i * rows:(dp_i + 1) * rows],
                                   **TOL)


def _roundtrip_job(kind, params):
    cfg = _tcfg(16)
    m = _mesh(kind)
    whole = tv.from_jax_params(params, device="cpu")
    shard = tv.shard_params(whole, m, cfg)
    back = tv.gather_params(shard, m, cfg)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(back), _leaves(whole)))
    return (m.coords["tp"], same,
            {n: a.numpy() for n, a in _leaves(shard)})


@pytest.mark.parametrize("kind", ["dp2tp2", "tp4"])
def test_shard_gather_round_trip(pool, kind):
    """Every rank gathers the whole tree back bit for bit; ``wqkv`` is cut
    by heads within each of q, k and v, ``wo`` by its rows (the same
    heads), the head by its classes where tp divides them."""
    cfg = _cfg(16)
    params = _jax_params(cfg)
    tp = {"dp2tp2": 2, "tp4": 4}[kind]
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    for tp_i, same, shard in pool.run(_roundtrip_job, kind, params):
        assert same
        heads = slice(tp_i * H // tp, (tp_i + 1) * H // tp)
        qkv = params["layers"]["wqkv"].reshape(cfg.n_layers, D, 3, H, hd)
        np.testing.assert_array_equal(
            shard["/layers/wqkv"],
            qkv[:, :, :, heads].reshape(cfg.n_layers, D, -1))
        rows = slice(tp_i * D // tp, (tp_i + 1) * D // tp)
        np.testing.assert_array_equal(shard["/layers/wo"],
                                      params["layers"]["wo"][:, rows])
        head = params["head"]
        if cfg.n_classes % tp == 0:
            n = cfg.n_classes // tp
            head = head[:, tp_i * n:(tp_i + 1) * n]
        np.testing.assert_array_equal(shard["/head"], head)
        np.testing.assert_array_equal(shard["/registers"],
                                      params["registers"])


def _with_leaves(tree, values):
    """``tree``'s structure with ``values`` in ``_leaves``' order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def _mesh_grads_job(params, x, y):
    from torchmpi_tpu_torch.collectives import innerjit

    cfg = _tcfg(16)
    m = _mesh("dp2tp2")
    shard = tv.shard_params(tv.from_jax_params(params, device="cpu"), m, cfg)
    leaves = [t.requires_grad_() for _, t in _leaves(shard)]
    loss = tv.make_loss_fn(cfg, attn="flash", remat="dots", mesh=m)(
        shard, (torch.from_numpy(x), torch.from_numpy(y)))
    grads = _with_leaves(shard, torch.autograd.grad(loss, leaves))
    # This rank's gradients are its dp rows' mean's: gathered whole over
    # tp, then averaged over dp, they are the global batch's.
    whole = tv.gather_params(grads, m, cfg)
    with torch.no_grad():
        return float(loss.detach()), [
            innerjit.allreduce(g, "dp", op="mean", mesh=m).numpy()
            for _, g in _leaves(whole)]


def test_mesh_loss_and_gradients_match_jax(pool):
    """``make_loss_fn(mesh=)`` on {dp 2, tp 2}: the loss over the global
    batch on every rank, and the ranks' gradients, gathered over tp and
    averaged over dp, JAX's over the global batch (the class-sharded
    head's gathered logits, the Megatron pair and the dp mean's backward
    included)."""
    cfg = _cfg(16)
    params = _jax_params(cfg)
    batch = _batch(seed=6)
    want_loss, want = jax.jit(jax.value_and_grad(
        jv.make_loss_fn(cfg, attn="flash", remat="dots")))(params, batch)
    for got_loss, got in pool.run(_mesh_grads_job, params, *batch):
        _check_grads(got_loss, got, want_loss, want)


def _engine_batches():
    """One rank-major (2, 4, 32, 32, 3) batch a step, labels with a signal
    (the brightness of the image), as JAX's engine test."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(ENGINE_STEPS):
        x = rng.randn(2, RANK_BATCH, 32, 32, 3).astype(np.float32)
        y = (np.arange(2 * RANK_BATCH).reshape(2, RANK_BATCH)
             % 4).astype(np.int32)
        out.append((x + y[..., None, None, None] * 0.5, y))
    return out


def _engine_job(params, batches):
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.runtime import config

    cfg = _tcfg()
    comm = tmesh.make_mesh({"dp": 2, "tp": 2}).comm("dp")
    losses = []
    before = config.get("use_pallas_collectives")
    config.set("use_pallas_collectives", True)
    try:
        engine = AllReduceSGDEngine(
            tv.make_loss_fn(cfg), lr=SGD_LR,
            comm=comm, mode="compiled",
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        engine.train(tv.from_jax_params(params, device="cpu"), batches)
    finally:
        config.set("use_pallas_collectives", before)
    return losses


def test_engine_losses_match_a_jax_sgd_replay(pool):
    cfg = _cfg()
    params = _jax_params(cfg)
    batches = _engine_batches()
    vg = jax.jit(jax.value_and_grad(jv.make_loss_fn(cfg)))
    p, want = jax.tree.map(jnp.asarray, params), []
    for x, y in batches:
        loss, g = vg(p, (x.reshape(-1, 32, 32, 3), y.reshape(-1)))
        want.append(float(loss))
        p = jax.tree.map(lambda a, b: a - SGD_LR * b, p, g)
    assert want[-1] < want[0]
    for got in pool.run(_engine_job, params, batches):
        np.testing.assert_allclose(got, want, rtol=1e-5)
