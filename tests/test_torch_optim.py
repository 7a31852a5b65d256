"""The port's optax-shaped optimizers (``torchmpi_tpu_torch/optim.py``)
against optax itself.

Five updates of ``adam`` (optax's defaults at two learning rates, and
other constants with ``eps_root``) and of ``sgd`` (without momentum and
with it) on a mixed tree of f32 and bf16 leaves, the same gradients on
both sides, optax's ``update`` jitted as the JAX engine runs it.

Tolerance.  f32 leaves: within 1e-6 of the leaf's largest magnitude
(XLA fuses optax's update and rewrites ``(m / bc) / d`` into ``m / (bc *
d)``; the port rounds each operation of optax's source once; measured
about 6e-8).  bf16 leaves: within one bf16 rounding step (2^-8) of the
leaf's largest magnitude, since a one-ulp difference in an f32
intermediate can flip a bf16 rounding.  ``apply_`` (in place, in slices)
equals ``update`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch import optim
from torchmpi_tpu_torch.utils import tree as ttree

F32_TOL, BF16_TOL = 1e-6, 2.0 ** -8
STEPS = 5


def _jax_tree(rng):
    import jax.numpy as jnp

    return {"w": jnp.asarray(rng.randn(8, 5), jnp.float32),
            "b": jnp.asarray(rng.randn(5), jnp.float32),
            "e": jnp.asarray(rng.randn(6, 4), jnp.bfloat16),
            "n": [jnp.asarray(rng.randn(3), jnp.bfloat16),
                  jnp.asarray(rng.randn(2, 3, 2), jnp.float32)]}


def _to_torch(tree):
    import jax
    import jax.numpy as jnp

    def one(a):
        dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dt)

    return jax.tree.map(one, tree)


def _optimizers(name):
    import optax

    return {
        "adam": (optax.adam(1e-2), optim.adam(1e-2)),
        "adam-eps_root": (optax.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6,
                                     eps_root=1e-9),
                          optim.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6,
                                     eps_root=1e-9)),
        "sgd": (optax.sgd(0.1), optim.sgd(0.1)),
        "sgd-momentum": (optax.sgd(0.1, momentum=0.9),
                         optim.sgd(0.1, momentum=0.9)),
        "adam-1e-4": (optax.adam(1e-4), optim.adam(1e-4)),
    }[name]


NAMES = ["adam", "adam-eps_root", "adam-1e-4", "sgd", "sgd-momentum"]


def _close(got: torch.Tensor, want) -> None:
    import jax.numpy as jnp

    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    g = got.float().numpy().astype(np.float64)
    assert g.shape == w.shape
    tol = BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= tol * scale


def _run_both(name, steps=STEPS, start=0):
    """``steps`` updates on both sides from the same tree, after ``start``
    updates of optax alone (whose state the port then takes over through
    ``from_jax_opt_state``)."""
    import jax
    import optax

    rng = np.random.RandomState(7)
    jo, to = _optimizers(name)
    jp = _jax_tree(rng)
    grads = [jax.tree.map(lambda a: (0.1 * jax.numpy.asarray(
        rng.randn(*a.shape), a.dtype)), jp) for _ in range(start + steps)]
    upd = jax.jit(jo.update)
    js = jo.init(jp)
    for g in grads[:start]:
        u, js = upd(g, js, jp)
        jp = optax.apply_updates(jp, u)
    tp = _to_torch(jp)
    ts = (optim.from_jax_opt_state(jax.tree.map(np.asarray, js), tp)
          if start else to.init(tp))
    for g in grads[start:]:
        u, js = upd(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = to.update(_to_torch(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
    return jp, js, tp, ts, to, [_to_torch(g) for g in grads[start:]]


@pytest.mark.parametrize("name", NAMES)
def test_five_updates_match_optax(name):
    import jax

    jp, js, tp, ts, _, _ = _run_both(name)
    for got, want in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        _close(got, want)
    # The state: optax's structure, leaf for leaf (count int32).
    want_state = jax.tree.leaves(js)
    got_state = ttree.leaves(ts)
    assert len(got_state) == len(want_state)
    for got, want in zip(got_state, want_state):
        if got.dtype == torch.int32:
            assert int(got) == int(want) == STEPS
        else:
            _close(got, want)


def test_state_structure_is_optaxs():
    import jax
    import optax

    rng = np.random.RandomState(0)
    jp = _jax_tree(rng)
    tp = _to_torch(jp)
    for jo, to in [(optax.adam(1e-3), optim.adam(1e-3)),
                   (optax.sgd(0.1), optim.sgd(0.1)),
                   (optax.sgd(0.1, momentum=0.5),
                    optim.sgd(0.1, momentum=0.5))]:
        js, ts = jo.init(jp), to.init(tp)
        jpaths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(js)[0]]
        tpaths = ["".join(f"[{k!r}]" if isinstance(k, str)
                          and not k.startswith(".") else
                          (k if isinstance(k, str) else f"[{k}]")
                          for k in path)
                  for path, _ in ttree.flatten_with_paths(ts)]
        assert tpaths == jpaths
        for (_, j), t in zip(jax.tree_util.tree_flatten_with_path(js)[0],
                             ttree.leaves(ts)):
            assert tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).split(".")[-1] == str(j.dtype)


@pytest.mark.parametrize("name", NAMES)
def test_apply_in_place_equals_update(name):
    _, _, tp, ts, to, grads = _run_both(name)
    p2 = ttree.tree_map(lambda t: t.clone(),
                        _to_torch(_jax_tree(np.random.RandomState(7))))
    s2 = to.init(p2)
    for g in grads:
        leaves = ttree.leaves(g)
        # Tiny slices: every leaf goes through in several pieces.
        s2 = to.apply_(ttree.leaves(p2), leaves, s2, chunk_bytes=16)
        assert all(x is None for x in leaves)
    for a, b in zip(ttree.leaves(p2), ttree.leaves(tp)):
        assert torch.equal(a, b)
    for a, b in zip(ttree.leaves(s2), ttree.leaves(ts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adam", "sgd-momentum", "sgd"])
def test_from_jax_opt_state_continues_optax(name):
    """Two updates of optax, its state converted, then five on both sides."""
    import jax

    jp, js, tp, ts, _, _ = _run_both(name, start=2)
    for got, want in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        _close(got, want)
    for got, want in zip(ttree.leaves(ts), jax.tree.leaves(js)):
        if got.dtype == torch.int32:
            assert int(got) == int(want) == 2 + STEPS
        else:
            _close(got, want)


def test_from_jax_opt_state_lays_out_with_the_model():
    """A ResNet's moments convert with its ``from_jax_params`` (HWIO ->
    OIHW) when it is given."""
    import jax
    import optax

    from torchmpi_tpu.models import resnet as jr
    from torchmpi_tpu_torch.models import resnet as tr

    cfg = jr.config(depth=18, n_classes=4, width_multiplier=0.125)
    params, _ = jr.init(jax.random.PRNGKey(0), cfg)
    js = optax.adam(1e-3).init(params)
    js = (js[0]._replace(mu=jax.tree.map(lambda a: a + 1.5, js[0].mu)),
          js[1])
    tp = tr.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    ts = optim.from_jax_opt_state(jax.tree.map(np.asarray, js), tp,
                                  from_params=tr.from_jax_params)
    want = tr.from_jax_params(jax.tree.map(np.asarray, js[0].mu),
                              device="cpu")
    for a, b in zip(ttree.leaves(ts[0].mu), ttree.leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(ttree.leaves(ts[0].nu), ttree.leaves(tp)):
        assert a.shape == b.shape and not a.any()


def test_checkpoint_round_trip_and_the_jax_layout(tmp_path):
    """The port's state saved and restored bit for bit; and a state the
    JAX package saved (optax's) restores into the port's template."""
    import jax

    from torchmpi_tpu.utils import checkpoint as jckpt
    from torchmpi_tpu_torch.utils import checkpoint as tckpt

    jp, js, tp, ts, to, _ = _run_both("adam")
    tckpt.save(str(tmp_path / "port"), 5, {"params": tp, "opt_state": ts})
    template = {"params": ttree.tree_map(torch.zeros_like, tp),
                "opt_state": to.init(tp)}
    back, meta = tckpt.restore(str(tmp_path / "port"), template)
    assert meta["step"] == 5
    for a, b in zip(ttree.leaves(back), ttree.leaves({"params": tp,
                                                      "opt_state": ts})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["opt_state"][0], optim.ScaleByAdamState)
    # JAX writes optax's state under the same paths (".count", ".mu", ...).
    jckpt.save(str(tmp_path / "jax"), 5, {"opt_state": js})
    got, _ = tckpt.restore(str(tmp_path / "jax"),
                           {"opt_state": to.init(tp)})
    for a, b in zip(ttree.leaves(got), jax.tree.leaves(js)):
        if a.dtype == torch.int32:
            assert int(a) == int(b)
        else:
            np.testing.assert_array_equal(
                a.float().numpy(),
                np.asarray(b.astype(jax.numpy.float32)))


def test_count_stays_at_the_int32_maximum():
    to = optim.adam(1e-3)
    p = {"w": torch.ones(3)}
    st = to.init(p)
    st = (st[0]._replace(count=torch.tensor(2 ** 31 - 1, dtype=torch.int32)),
          st[1])
    _, st = to.update({"w": torch.ones(3)}, st)
    assert int(st[0].count) == 2 ** 31 - 1
