"""The port's ResNet (``models/resnet.py``) against the JAX package's.

Both start from the JAX ``resnet.init`` parameters, converted with
``from_jax_params`` (HWIO -> OIHW), and see the same numpy images.  Three
cases cover depth 18 and 50 at width 0.125, images 32 and 33 (even and odd:
XLA's asymmetric SAME padding differs at each), with and without the
space-to-depth stem.  Compared: the training-mode logits, the
inference-mode logits (with non-trivial BN running statistics), the loss,
the gradient of every leaf and the EMA of ``make_update_stats_fn``.

Tolerance.  Both sides compute in f32 with other summation orders (XLA's
and PyTorch's convolutions and reductions), so each result must lie within
1e-4 of JAX's, relative to the largest magnitude in that whole result (all
logits, all gradient leaves, all running statistics).  Training-mode batch
norm over a handful of images is ill-conditioned in f32: its variance is
E[x^2] - E[x]^2, and where a channel's values are nearly equal the two
frameworks' rounding differences are amplified.  Measured between the two
packages on the same f32 model: ResNet-50 logits at 32x32 differ by 0.56
relative with 2 images, 3.4e-3 with 4 and 3.9e-4 with 8; at 33x33 with 8
images (2x2 positions left at the last stage) by 7.6e-5.  So each case uses
the batch at which the comparison is well-posed.

At depth 50 the JAX package's own f32 gradients are not good to 1e-4: they
lie about 2.4e-2 (of the largest gradient) from the same algebra evaluated
in f64, and up to 0.44 of a leaf's own scale.  There the reference is that
f64 evaluation: the JAX package's ``loss_fn`` and ``make_update_stats_fn``
run under x64 with the module's ``jnp.float32`` read as f64, so its f32
batch statistics and logits are f64 as well.  The port's f32 gradients are
held to it at 1e-4 leaf by leaf (the norm of a leaf's error over the norm
of the leaf: measured 7.5e-5 at most) and at 1e-4 of the largest gradient
element by element (measured 4.5e-5); its running statistics at 1e-4 of
each leaf's largest element (measured 6.9e-6).  As a second check the
port's results also lie within twice the JAX f32 results' distance from
that f64 evaluation of them (and never closer than 1e-4 is asked).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.models import resnet as tr
from torchmpi_tpu_torch.utils import tree as ttree

RTOL = 1e-4
# (depth, image, space-to-depth stem, batch)
CASES = [(18, 33, False, 4), (18, 32, True, 4), (50, 33, False, 8)]


def _close(got, want, what, scale=None, tol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol:.3g}"


def _conv_to_torch_layout(key, a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if key in tr._CONV_KEYS else a


def _walk_pairs(jtree, ttree_, key=None):
    """(key, jax leaf, torch leaf) over two trees of the same keys."""
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _walk_pairs(jtree[k], ttree_[k], k)
    elif isinstance(jtree, (list, tuple)):
        for a, b in zip(jtree, ttree_):
            yield from _walk_pairs(a, b, key)
    else:
        yield key, jtree, ttree_


@pytest.fixture(scope="module", params=CASES,
                ids=[f"d{d}-img{i}-s2d{int(s)}-b{b}" for d, i, s, b in CASES])
def case(request):
    """JAX's results for one case, computed once for the module."""
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu.models import resnet as jr

    depth, image, s2d, batch = request.param
    cfg = jr.config(depth=depth, n_classes=10, width_multiplier=0.125,
                    stem_space_to_depth=s2d)
    params, state = jr.init(jax.random.PRNGKey(depth + image), cfg)
    rng = np.random.RandomState(image)
    x = rng.rand(batch, image, image, 3).astype(np.float32)
    y = (np.arange(batch) * 3 % 10).astype(np.int32)
    # Non-trivial running statistics for the inference-mode forward.
    state = jax.tree.map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5),
        state)
    loss, grads = jax.jit(jax.value_and_grad(jr.make_loss_fn(cfg)))(
        params, (jnp.asarray(x), jnp.asarray(y)))
    stats = jr.make_update_stats_fn(cfg)(params, state, jnp.asarray(x))
    floors = {"grads": RTOL, "stats": RTOL}
    f64 = None
    if depth == 50:
        g64, st64 = _f64_reference(jr, cfg, params, state, x, y)
        floors = {"grads": _spread(grads, g64), "stats": _spread(stats, st64)}
        f64 = {"grads": jax.tree.map(np.asarray, g64),
               "stats": jax.tree.map(np.asarray, st64)}
    out = {
        "cfg_args": (depth, s2d), "params": jax.tree.map(np.asarray, params),
        "state": jax.tree.map(np.asarray, state), "x": x, "y": y,
        "train_logits": np.asarray(jr.apply(cfg, params, x, train=True)),
        "eval_logits": np.asarray(jr.apply(cfg, params, x, state=state,
                                           train=False)),
        "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
        "stats": jax.tree.map(np.asarray, stats),
        "tol": {k: max(RTOL, 2 * v) for k, v in floors.items()},
        "f64": f64,
    }
    return out


class _F64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _f64_reference(jr, cfg, params, state, x, y):
    """The JAX package's gradients and EMA statistics in f64 throughout:
    its module reads ``jnp`` at trace time, so its f32 statistics and
    logits become f64 while it traces under x64."""
    import jax
    import jax.numpy as jnp

    real = jr.jnp
    try:
        jr.jnp = _F64Numpy()
        with jax.enable_x64(True):
            p64, s64 = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                (params, state))
            x64 = jnp.asarray(x, jnp.float64)
            _, g64 = jax.jit(jax.value_and_grad(jr.make_loss_fn(cfg)))(
                p64, (x64, jnp.asarray(y)))
            st64 = jr.make_update_stats_fn(cfg)(p64, s64, x64)
            return jax.tree.map(np.asarray, (g64, st64))
    finally:
        jr.jnp = real


def _spread(a, b) -> float:
    """Largest difference between two trees of the same structure, relative
    to the largest magnitude in the first."""
    import jax

    la = [np.asarray(x, np.float64) for x in jax.tree.leaves(a)]
    lb = [np.asarray(x, np.float64) for x in jax.tree.leaves(b)]
    scale = max(float(np.abs(x).max()) for x in la)
    return max(float(np.abs(x - y).max()) for x, y in zip(la, lb)) / scale


def _torch_side(case):
    depth, s2d = case["cfg_args"]
    cfg = tr.config(depth=depth, n_classes=10, width_multiplier=0.125,
                    stem_space_to_depth=s2d)
    params = tr.from_jax_params(case["params"], device="cpu")
    state = tr.from_jax_state(case["state"], device="cpu")
    return cfg, params, state, torch.from_numpy(case["x"]), torch.from_numpy(
        case["y"])


def test_train_and_eval_logits_match_jax(case):
    cfg, params, state, x, _ = _torch_side(case)
    with torch.no_grad():
        _close(tr.apply(cfg, params, x, train=True), case["train_logits"],
               "train logits")
        ev = tr.apply(cfg, params, x, state=state, train=False)
    assert ev.dtype == torch.float32
    _close(ev, case["eval_logits"], "eval logits")


def _norm_close(got, want, what, tol=RTOL):
    """The norm of the error within ``tol`` of the norm of ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol:.3g}"


def test_loss_and_every_gradient_match_jax(case):
    from torchmpi_tpu_torch.engine.sgdengine import value_and_grad

    cfg, params, _, x, y = _torch_side(case)
    loss, grads = value_and_grad(tr.make_loss_fn(cfg), params, (x, y))
    _close(loss, case["loss"], "loss")
    pairs = list(_walk_pairs(case["grads"], grads))
    assert len(pairs) == len(ttree.leaves(params))
    scale = max(float(np.abs(jg).max()) for _, jg, _ in pairs)
    for key, jg, tg in pairs:
        _close(tg, _conv_to_torch_layout(key, jg), f"grad of {key}", scale,
               case["tol"]["grads"])
    if case["f64"] is not None:
        pairs = list(_walk_pairs(case["f64"]["grads"], grads))
        scale = max(float(np.abs(jg).max()) for _, jg, _ in pairs)
        for key, jg, tg in pairs:
            want = _conv_to_torch_layout(key, jg)
            _norm_close(tg, want, f"grad of {key} vs f64")
            _close(tg, want, f"grad of {key} vs f64", scale)


def test_update_stats_matches_jax(case):
    cfg, params, state, x, _ = _torch_side(case)
    new = tr.make_update_stats_fn(cfg)(params, state, x)
    pairs = list(_walk_pairs(case["stats"], new))
    scale = max(float(np.abs(js).max()) for _, js, _ in pairs)
    for key, js, ts in pairs:
        _close(ts, js, f"running stat {key}", scale, case["tol"]["stats"])
    if case["f64"] is not None:
        for key, js, ts in _walk_pairs(case["f64"]["stats"], new):
            _close(ts, js, f"running stat {key} vs f64")


def test_accuracy_fn_and_flops_match_jax(case):
    import jax.numpy as jnp

    from torchmpi_tpu.models import resnet as jr

    depth, s2d = case["cfg_args"]
    jcfg = jr.config(depth=depth, n_classes=10, width_multiplier=0.125)
    cfg, params, state, x, y = _torch_side(case)
    acc = tr.make_accuracy_fn(cfg, state)(params, (x, y))
    jacc = jr.make_accuracy_fn(jcfg, case["state"])(
        case["params"], (jnp.asarray(case["x"]), jnp.asarray(case["y"])))
    assert float(acc) == float(jacc)
    for image in (32, 33, 224):
        assert tr.flops_per_image(cfg, image) == jr.flops_per_image(jcfg, image)


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
    (112, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (7, 1, 1, (0, 0))])
def test_same_padding_is_xla_s(size, k, stride, want):
    """XLA pads SAME low total // 2 and high the rest; at stride 2 on an
    even input that is asymmetric, unlike conv2d(padding=k // 2)."""
    assert tr._same_pad(size, k, stride) == want


def test_config_and_init_shapes_match_jax():
    import jax

    from torchmpi_tpu.models import resnet as jr

    for depth in (18, 34, 50):
        j = jr.config(depth=depth, width_multiplier=0.25)
        t = tr.config(depth=depth, width_multiplier=0.25)
        assert (t.kind, t.widths, t.strides, t.stem_width, t.n_classes) == (
            j.kind, j.widths, j.strides, j.stem_width, j.n_classes)
    cfg = jr.config(depth=50, width_multiplier=0.125, n_classes=10)
    jshapes = jax.eval_shape(lambda k: jr.init(k, cfg),
                             jax.random.PRNGKey(0))
    params, state = tr.init(0, tr.config(depth=50, width_multiplier=0.125,
                                          n_classes=10), device="cpu")
    for key, js, tp in _walk_pairs(jshapes[0], params):
        want = (tuple(js.shape[i] for i in (3, 2, 0, 1))
                if key in tr._CONV_KEYS else tuple(js.shape))
        assert tuple(tp.shape) == want, key
    assert sorted(ttree.flatten(state)[1][1]) == sorted(jshapes[1])
    with pytest.raises(ValueError, match="depth"):
        tr.config(depth=20)


def test_resnet50_full_width_leaf_count():
    """161 leaves and 25,557,032 parameters; 42 leaves at or above the
    65,536-element cutoff hold 25,247,744 of them: 43 rings a step."""
    params, _ = tr.init(0, tr.config(depth=50), device="cpu")
    sizes = [leaf.numel() for leaf in ttree.leaves(params)]
    assert (len(sizes), sum(sizes)) == (161, 25_557_032)
    big = [s for s in sizes if s >= 65536]
    assert (len(big), sum(big)) == (42, 25_247_744)
