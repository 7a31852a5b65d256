"""Parity of the port's Llama training path with the JAX package's.

The JAX package initialises the parameters; ``from_jax_params`` carries
them into the port, and both packages then run on the same numpy tokens.
The port runs on the CPU (``device="cpu"``), where flash attention, forward
and backward, is the plain version of its CUDA kernels; the JAX side runs
its Pallas kernels in interpret mode.  Everything is f32, so values agree
to f32 summation order: logits and losses to rtol/atol 1e-4, each gradient
leaf to rtol 2e-4 with atol 2e-5 times the leaf's largest JAX magnitude
(a leaf's small entries are sums of cancelling terms).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmpi_tpu import parallel
from torchmpi_tpu.models import llama as jl
from torchmpi_tpu_torch.models import llama as tl

tfa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(cfg, seed=0):
    jp = jl.init(jax.random.PRNGKey(seed), cfg)
    return jp, tl.from_jax_params(_np_tree(jp), device="cpu")


def _batch(cfg, B, L, seed=1):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab, (B, L + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _assert_grads_close(tgrads, jgrads):
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(leaves) == 12
    for path, jg in leaves:
        jg = np.asarray(jg)
        tg = _leaf(tgrads, path)
        assert tg is not None, path
        np.testing.assert_allclose(
            tg.detach().numpy(), jg, rtol=2e-4,
            atol=2e-5 * float(np.abs(jg).max()),
            err_msg=jax.tree_util.keystr(path))


def _port_loss_and_grads(cfg, tp, tokens, targets, **kw):
    leaves = list(tl._leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    loss = tl.make_loss_fn(cfg, **kw)(
        tp, (torch.from_numpy(tokens), torch.from_numpy(targets)))
    loss.backward()
    return loss, jax.tree.map(lambda p: p.grad, tp)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_apply_logits_match_jax(attn):
    cfg = jl.tiny(seq=64)
    jp, tp = _both(cfg)
    tokens, _ = _batch(cfg, 2, 64)
    ref = jl.apply(cfg, jp, jnp.asarray(tokens), attn=attn)
    with torch.no_grad():
        got, aux = tl.apply(cfg, tp, torch.from_numpy(tokens), attn=attn,
                            return_aux=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # The hidden states are what the head is applied to, in either loop.
    with torch.no_grad():
        hid = tl.apply(cfg, tp, torch.from_numpy(tokens), attn=attn,
                       return_hidden=True, layer_loop="unroll")
    torch.testing.assert_close((hid @ tp["head"]).float(), got)


def test_apply_positions_match_jax():
    # Explicit (non-contiguous) RoPE positions ride through both packages.
    cfg = jl.tiny(seq=64)
    jp, tp = _both(cfg)
    tokens, _ = _batch(cfg, 1, 16)
    pos = np.arange(16)[::-1].copy()
    ref = jl.apply(cfg, jp, jnp.asarray(tokens), positions=jnp.asarray(pos))
    with torch.no_grad():
        got = tl.apply(cfg, tp, torch.from_numpy(tokens),
                       positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("attn", ["full", "flash"])
def test_loss_and_every_gradient_match_jax(attn, remat, loss_chunk):
    cfg = jl.tiny(seq=32)
    jp, tp = _both(cfg)
    tokens, targets = _batch(cfg, 2, 32)
    kw = dict(attn=attn, remat=remat, loss_chunk=loss_chunk)
    jloss, jgrads = jax.jit(jax.value_and_grad(jl.make_loss_fn(cfg, **kw)))(
        jp, (jnp.asarray(tokens), jnp.asarray(targets)))
    tloss, tgrads = _port_loss_and_grads(cfg, tp, tokens, targets, **kw)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _assert_grads_close(tgrads, jgrads)


def test_long_sequence_flash_gradients_match_jax():
    # L = 2048 takes 1024-row tiles on both sides, so the causal skip of
    # both backward passes (k tiles above the diagonal in dq, q tiles above
    # it in dk/dv) runs.
    cfg = jl.tiny(seq=2048)
    jp, tp = _both(cfg)
    tokens, targets = _batch(cfg, 1, 2048)
    kw = dict(attn="flash", remat="none", loss_chunk=512)
    jloss, jgrads = jax.jit(jax.value_and_grad(jl.make_loss_fn(cfg, **kw)))(
        jp, (jnp.asarray(tokens), jnp.asarray(targets)))
    tloss, tgrads = _port_loss_and_grads(cfg, tp, tokens, targets, **kw)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _assert_grads_close(tgrads, jgrads)


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("dots", 2),
                                                 ("full", 2)])
def test_flash_forward_runs_per_step_as_the_remat_mode_implies(
        monkeypatch, remat, fwd_per_layer):
    # The launch counts chip_smoke.py asserts on the card, counted here on
    # the plain versions: the forward once per layer, and once more under
    # remat (the checkpointed layer runs again in the backward); each
    # backward pass once per layer.
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "_flash_bh_plain",
                        counting("fwd", tfa._flash_bh_plain))
    monkeypatch.setattr(tfa, "_flash_bh_bwd_dq_plain",
                        counting("dq", tfa._flash_bh_bwd_dq_plain))
    monkeypatch.setattr(tfa, "_flash_bh_bwd_dkv_plain",
                        counting("dkv", tfa._flash_bh_bwd_dkv_plain))
    cfg = tl.tiny(seq=32)
    params = tl.init(0, cfg, device="cpu")
    tokens, targets = map(torch.from_numpy, _batch(cfg, 1, 32))
    step = tl.make_train_step(cfg, lr=0.1, attn="flash", remat=remat,
                              loss_chunk=8)
    step(params, None, tokens, targets)
    assert calls == {"fwd": fwd_per_layer * cfg.n_layers,
                     "dq": cfg.n_layers, "dkv": cfg.n_layers}


def test_train_step_matches_jax_over_three_sgd_steps():
    cfg = jl.tiny(seq=32)
    jp, tp = _both(cfg)
    tokens, targets = _batch(cfg, 4, 32)
    mesh = parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    kw = dict(lr=0.3, attn="flash", remat="dots", loss_chunk=16)
    jstep = jl.make_train_step(cfg, mesh, **kw)
    tstep = tl.make_train_step(cfg, **kw)
    jt, jtg = jnp.asarray(tokens), jnp.asarray(targets)
    tt, ttg = torch.from_numpy(tokens), torch.from_numpy(targets)
    jlosses, tlosses = [], []
    for _ in range(3):
        jp, _, jloss = jstep(jp, None, jt, jtg)
        tp2, state, tloss = tstep(tp, None, tt, ttg)
        assert tp2 is tp and state is None and not tloss.requires_grad
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert tlosses[-1] < tlosses[0]
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(jp)):
        np.testing.assert_allclose(_leaf(tp, path).detach().numpy(), leaf,
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_sgd_update_rounds_like_jax_in_bf16():
    # JAX rounds the weakly typed lr to bf16, then lr * g and the difference
    # once each; bit for bit on a vector where a fused update would differ.
    rs = np.random.RandomState(2)
    p = rs.randn(4096).astype(np.float32)
    g = rs.randn(4096).astype(np.float32)
    lr = 1e-2
    jp, jg = (jnp.asarray(a, jnp.bfloat16) for a in (p, g))
    ref = np.asarray(jax.jit(lambda p, g: p - lr * g.astype(p.dtype))(jp, jg)
                     .astype(jnp.float32))
    tp = torch.tensor(np.asarray(jp.astype(jnp.float32))).bfloat16()
    tg = torch.tensor(np.asarray(jg.astype(jnp.float32))).bfloat16()
    tl._sgd_update_(tp, tg, lr)
    np.testing.assert_array_equal(tp.float().numpy(), ref)


def test_every_leaf_gets_a_gradient_and_generation_builds_no_graph():
    cfg = tl.tiny(seq=32)
    params = tl.init(0, cfg, device="cpu")
    tokens, targets = map(torch.from_numpy, _batch(cfg, 2, 16))
    _, grads = _port_loss_and_grads(cfg, params, tokens.numpy(),
                                    targets.numpy(), attn="flash",
                                    remat="dots", loss_chunk=8)
    assert all(g is not None for g in tl._leaves(grads))
    assert params["layers"]["wq"].grad.shape == params["layers"]["wq"].shape
    logits, _ = tl._prefill(cfg, params,
                            tl.init_kv_cache(cfg, 1, 16, device="cpu"),
                            tokens[:1])
    assert logits.grad_fn is None and not logits.requires_grad
    toks = tl.make_generate_fn(cfg, 16, 3, device="cpu")(params, tokens[:1])
    assert toks.grad_fn is None


def test_stacked_leaves_get_their_gradient_through_one_stack():
    # A select (leaf[i]) per layer would write each layer's gradient into a
    # zero tensor the size of the whole stacked leaf and add n of them;
    # unbind's backward stacks them once.
    cfg = tl.tiny(seq=16)
    params = tl.init(0, cfg, device="cpu")
    for p in tl._leaves(params):
        p.requires_grad_(True)
    tokens, targets = map(torch.from_numpy, _batch(cfg, 1, 16))
    loss = tl.make_loss_fn(cfg)(params, (tokens, targets))
    stacked = {id(p) for p in params["layers"].values()}
    into_stacked, seen, todo = set(), set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if id(getattr(nxt, "variable", None)) in stacked:
                into_stacked.add(type(fn).__name__)
            todo.append(nxt)
    assert into_stacked == {"UnbindBackward0"}


@pytest.mark.parametrize("bad", ["loss_chunk", "remat", "layer_loop"])
def test_argument_errors_match_jax(bad):
    cfg = jl.tiny(seq=32)
    jp, tp = _both(cfg)
    tokens, targets = _batch(cfg, 1, 24)
    kw = {"loss_chunk": dict(loss_chunk=7), "remat": dict(remat="some"),
          "layer_loop": dict(layer_loop="while")}[bad]
    with pytest.raises(ValueError):
        jl.make_loss_fn(cfg, **kw)(jp, (jnp.asarray(tokens),
                                        jnp.asarray(targets)))
    with pytest.raises(ValueError):
        tl.make_loss_fn(cfg, **kw)(tp, (torch.from_numpy(tokens),
                                        torch.from_numpy(targets)))


@pytest.mark.parametrize("kw", [dict(mesh={"dp": 1}),
                                dict(optimizer=object()),
                                dict(zero1=True)])
def test_train_step_parts_of_later_slices_raise(kw):
    """What once waited for the mesh (item 12) does what the JAX package
    does with the same call: ``mesh=`` builds a step on a real mesh (one
    rank here), whose first loss is JAX's on a one-device mesh; ``zero1``
    without an optimizer raises JAX's ValueError; ``optimizer=`` builds a
    step."""
    if "optimizer" in kw:
        assert callable(tl.make_train_step(tl.tiny(), **kw))
        return
    if "zero1" in kw:
        mesh = parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
        with pytest.raises(ValueError, match="zero1 needs optimizer"):
            jl.make_train_step(jl.tiny(), mesh, **kw)
        with pytest.raises(ValueError, match="zero1 needs optimizer"):
            tl.make_train_step(tl.tiny(), **kw)
        return
    from torchmpi_tpu_torch.parallel import mesh as tmesh
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    cfg = jl.tiny(seq=32)
    jp, tp = _both(cfg)
    tokens, targets = _batch(cfg, 2, 16)
    jmesh = parallel.make_mesh(kw["mesh"], devices=jax.devices()[:1])
    tmsh = tmesh.make_mesh(kw["mesh"], comm=Communicator([0], my_rank=0))
    _, _, jloss = jl.make_train_step(cfg, jmesh, lr=0.1)(
        jp, None, jnp.asarray(tokens), jnp.asarray(targets))
    _, _, tloss = tl.make_train_step(cfg, tmsh, lr=0.1)(
        tp, None, torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


ADAM_LR, ADAM_STEPS = 1e-3, 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax_over_three_adam_steps(dtype):
    """``make_train_step(optimizer=adam)`` against the JAX step with
    ``optax.adam`` on a one-device mesh, flash attention, remat "dots".

    Adam divides each element's update by that element's own gradient
    scale, so an element whose gradient nearly cancels carries the two
    frameworks' summation differences into its step at full size.  f32:
    losses at rtol/atol 1e-4, each parameter within rtol 1e-4 and 1e-2 of
    lr (measured 1.7e-3 of lr at most).  bf16 (parameters, gradients and
    moments in bf16, as optax keeps them): the forward's bf16 roundings
    differ, so losses agree to rtol 1e-3 (measured 2.5e-4), and each
    element lies within three steps of either sign and one bf16 rounding
    of the leaf's largest magnitude, ``2 * 3 * steps * lr + 2^-8 max|p|``
    (measured 4.9 lr at most), with the mean difference over a leaf below
    lr / 4 (most elements take the same steps)."""
    import optax

    from torchmpi_tpu_torch import optim

    cfg = jl.tiny(seq=32)
    jp = jl.init(jax.random.PRNGKey(0), cfg, dtype=getattr(jnp, dtype))
    tp = tl.from_jax_params(_np_tree(jp), device="cpu")
    tokens, targets = _batch(cfg, 4, 32)
    mesh = parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    kw = dict(attn="flash", remat="dots", loss_chunk=16)
    jstep = jl.make_train_step(cfg, mesh, optimizer=optax.adam(ADAM_LR), **kw)
    tstep = tl.make_train_step(cfg, optimizer=optim.adam(ADAM_LR), **kw)
    js, ts = optax.adam(ADAM_LR).init(jp), optim.adam(ADAM_LR).init(tp)
    jt, jtg = jnp.asarray(tokens), jnp.asarray(targets)
    tt, ttg = torch.from_numpy(tokens), torch.from_numpy(targets)
    jlosses, tlosses = [], []
    for _ in range(ADAM_STEPS):
        jp, js, jloss = jstep(jp, js, jt, jtg)
        tp2, ts, tloss = tstep(tp, ts, tt, ttg)
        assert tp2 is tp and not tloss.requires_grad
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    assert int(ts[0].count) == ADAM_STEPS
    assert tlosses[-1] < tlosses[0]
    f32 = dtype == "float32"
    np.testing.assert_allclose(tlosses, jlosses,
                               **(TOL if f32 else dict(rtol=1e-3)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        got = _leaf(tp, path).detach()
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype)
        want = np.asarray(leaf.astype(jnp.float32))
        got = got.float().numpy()
        what = jax.tree_util.keystr(path)
        if f32:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-2 * ADAM_LR, err_msg=what)
        else:
            diff = np.abs(got - want)
            bound = (6 * ADAM_STEPS * ADAM_LR
                     + 2.0 ** -8 * float(np.abs(want).max()))
            assert float(diff.max()) <= bound, what
            assert float(diff.mean()) <= ADAM_LR / 4, what
    # The moments stay in the parameters' dtypes.
    for m, p in zip(optim._tree.leaves(ts[0].mu), optim._tree.leaves(tp)):
        assert m.dtype == p.dtype


def test_moe_and_mesh_forms_raise():
    """MoE no longer raises (item 12a): a MoE config's loss equals the JAX
    package's on the same weights (within 1e-6 relative).  The mesh forms
    do what the JAX package does: ``apply(mesh=)`` on a one-rank mesh gives
    the logits without one; a ring mode raises JAX's errors, with no mesh
    and on a mesh with no sp axis."""
    import dataclasses

    from torchmpi_tpu_torch.parallel import mesh as tmesh
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    moe = dataclasses.replace(tl.tiny(), n_experts=4)
    jmoe = dataclasses.replace(jl.tiny(), n_experts=4)
    jpm = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), jmoe))
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) % 256
    want = float(jax.jit(jl.make_loss_fn(jmoe))(jpm, (toks, toks)))
    with torch.no_grad():
        got = float(tl.make_loss_fn(moe)(
            tl.from_jax_params(jpm, device="cpu"),
            (torch.from_numpy(toks), torch.from_numpy(toks))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert callable(tl.make_train_step(moe))
    cfg = tl.tiny()
    tokens = torch.zeros((1, 8), dtype=torch.long)
    params = tl.init(0, cfg, device="cpu")
    tmsh = tmesh.make_mesh({"dp": 1}, comm=Communicator([0], my_rank=0))
    with torch.no_grad():
        np.testing.assert_array_equal(
            tl.apply(cfg, params, tokens, mesh=tmsh).numpy(),
            tl.apply(cfg, params, tokens).numpy())
    jmesh = parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jp = jl.init(jax.random.PRNGKey(0), jl.tiny())
    for mesh_t, mesh_j, err in ((None, None, ValueError),
                                (tmsh, jmesh, NameError)):
        with pytest.raises(err) as jerr:
            jl.apply(jl.tiny(), jp, jnp.zeros((1, 8), jnp.int32),
                     mesh=mesh_j, attn="ring")
        with pytest.raises(err) as terr:
            tl.apply(cfg, params, tokens, mesh=mesh_t, attn="ring")
        assert str(terr.value) == str(jerr.value)
