"""The port's MNIST models (``models/mlp.py``, ``models/cnn.py``) against
the JAX package's.

Both start from the JAX ``init`` parameters, converted with
``from_jax_params`` (a copy: the port keeps the JAX layouts), and take the
same seeded batch of 8.  Checked: the logits of ``apply``, ``loss_fn``,
``accuracy`` and the gradient of the loss (``jax.grad`` against the port's
autograd), leaf for leaf.

Tolerances, f32 on both sides: the MLP at hidden (64, 32) to rtol 1e-5
(matrix products of at most 784 terms, summed in other orders by XLA and
PyTorch); the CNN at image 16, width 8, hidden 32 to rtol 1e-4 (the 5x5
convolutions sum 25 * C terms a pixel in the libraries' own orders, and
the pools pass on whichever of two near-equal values wins).  Absolute
floors are 1e-6 of each array's largest magnitude.  An NCHW flatten in the
CNN would permute ``w3``'s rows and miss by far more.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.models import cnn as tcnn
from torchmpi_tpu_torch.models import mlp as tmlp

B = 8


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _case(name):
    import jax

    from torchmpi_tpu.models import cnn as jcnn
    from torchmpi_tpu.models import mlp as jmlp

    rng = np.random.RandomState(7)
    if name == "mlp":
        jmod, tmod, rtol = jmlp, tmlp, 1e-5
        params = jmlp.init(jax.random.PRNGKey(3), hidden=(64, 32))
        x = rng.rand(B, 28, 28).astype(np.float32)
    else:
        jmod, tmod, rtol = jcnn, tcnn, 1e-4
        params = jcnn.init(jax.random.PRNGKey(3), image=16, width=8,
                           hidden=32)
        x = rng.rand(B, 16, 16).astype(np.float32)
    y = (np.arange(B) % 10).astype(np.int32)
    return jmod, tmod, rtol, jax.tree.map(np.asarray, params), x, y


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_forward_loss_accuracy_match_jax(name):
    jmod, tmod, rtol, params, x, y = _case(name)
    tp = tmod.from_jax_params(params, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in params.items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _close(tmod.apply(tp, tx), jmod.apply(params, x), rtol)
    _close(tmod.loss_fn(tp, (tx, ty)), jmod.loss_fn(params, (x, y)), rtol)
    assert float(tmod.accuracy(tp, (tx, ty))) == float(
        jmod.accuracy(params, (x, y)))


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_loss_gradient_matches_jax(name):
    import jax

    jmod, tmod, rtol, params, x, y = _case(name)
    want = jax.grad(jmod.loss_fn)(params, (x, y))
    tp = {k: v.requires_grad_(True)
          for k, v in tmod.from_jax_params(params, device="cpu").items()}
    loss = tmod.loss_fn(tp, (torch.from_numpy(x), torch.from_numpy(y)))
    grads = torch.autograd.grad(loss, list(tp.values()))
    for (k, _), g in zip(tp.items(), grads):
        _close(g, want[k], rtol)


def test_cnn_flattens_nhwc():
    # w3's rows follow the NHWC flatten of the last pool: permuting them
    # as an NCHW flatten would change the logits.
    _, _, _, params, x, _ = _case("cnn")
    tp = tcnn.from_jax_params(params, device="cpu")
    want = tcnn.apply(tp, torch.from_numpy(x))
    hw, c = 4 * 4, 16
    perm = torch.arange(hw * c).reshape(hw, c).t().reshape(-1)
    tp["w3"] = tp["w3"][perm]
    assert not torch.allclose(tcnn.apply(tp, torch.from_numpy(x)), want,
                              rtol=1e-3)


@pytest.mark.parametrize("name,kwargs,shapes", [
    ("mlp", {}, {"w0": (784, 1024), "b0": (1024,), "w1": (1024, 1024),
                 "b1": (1024,), "w2": (1024, 10), "b2": (10,)}),
    ("cnn", {}, {"conv1": (5, 5, 1, 32), "b1": (32,), "conv2": (5, 5, 32, 64),
                 "b2": (64,), "w3": (3136, 256), "b3": (256,),
                 "w4": (256, 10), "b4": (10,)})])
def test_init_shapes_and_scale_at_full_width(name, kwargs, shapes):
    mod = tmlp if name == "mlp" else tcnn
    p = mod.init(0, device="cpu", **kwargs)
    assert {k: tuple(v.shape) for k, v in p.items()} == shapes
    again = mod.init(torch.Generator().manual_seed(0), device="cpu", **kwargs)
    for k in p:
        assert torch.equal(p[k], again[k])
        assert p[k].dtype == torch.float32
        if k.startswith("b"):
            assert not p[k].any()
    w = p["w0"] if name == "mlp" else p["w3"]
    assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.05 * (
        2.0 / w.shape[0]) ** 0.5
