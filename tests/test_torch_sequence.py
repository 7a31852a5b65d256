"""The port's sequence parallelism (``parallel/sequence.py``) against the
JAX package's, in one spawned gloo pool of 4 ranks on a {dp 2, sp 2} mesh
(one intra-op thread a rank; the dp replicas compute the same).

Each case runs the same function in both packages on the same inputs
(``numpy.random.RandomState``): the JAX one over ``devices[:4]`` of the
8-device CPU mesh (its Pallas flash blocks in interpret mode, as
``tests/test_sequence.py`` runs them), the port's on the ranks (its flash
blocks' plain versions on the CPU).  Forward outputs, and the gradients of
``sum(w * o)`` for fixed random weights ``w``, in f32 within 1e-5 relative
and 1e-5 absolute (values are of unit scale; the plain blocks and the
interpreted kernels tile alike but sum in their own orders):

* ``make_ring_attention`` (global arrays in and out, every rank the same)
  with ``impl`` "ring" (the einsum oracle) and "ring_flash", causal and
  not, at 2 and 1 KV heads of 4 (GQA circulates K/V at the native count);
  "ulysses" and "ulysses_flash" (heads and KV heads split over sp);
* ``make_zigzag_ring_attention`` (causal; the (2Lc x Lc) and (Lc x 2Lc)
  blocks of the balanced ring) and ``make_zigzag_layout``;
* the batched bodies ``ring_flash_attention_batched`` and
  ``zigzag_ring_flash_attention_batched`` on this rank's chunk, against
  device r's chunk of the JAX body in its ``shard_map``;
* ``zigzag_indices``.

The fast set (``-m 'not slow'``) takes each strategy once; the rest of the
sweep is marked ``slow``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.parallel import mesh as tmesh
from torchmpi_tpu_torch.parallel import sequence as tseq

P = 4           # ranks
SP = 2          # the ring's length
MESH = {"dp": 2, "sp": SP}
TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (impl, causal, L, H, KV, D)
GLOBAL = {
    "ring-causal": ("ring", True, 32, 4, 2, 8),
    "ring-full": ("ring", False, 32, 4, 2, 8),
    "ring_flash-causal-kv2": ("ring_flash", True, 32, 4, 2, 16),
    "ring_flash-causal-kv1": ("ring_flash", True, 32, 4, 1, 16),
    "ring_flash-full-kv2": ("ring_flash", False, 32, 4, 2, 16),
    "ring_flash-full-kv1": ("ring_flash", False, 32, 4, 1, 16),
    "ulysses-causal": ("ulysses", True, 32, 4, 2, 8),
    "ulysses_flash-causal": ("ulysses_flash", True, 32, 4, 2, 16),
    "zigzag": ("zigzag", True, 32, 4, 2, 16),
    "zigzag-layout": ("zigzag-layout", True, 32, 4, 1, 16),
}
BATCHED = {
    "ring_flash_batched": ("ring_flash", True, 2, 32, 4, 2, 16),
    "zigzag_batched": ("zigzag", True, 2, 32, 4, 2, 16),
}


def _inputs(name, shapes):
    rng = np.random.RandomState(sum(map(ord, name)))
    return [rng.randn(*s).astype(np.float32) for s in shapes]


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


def _jax_mesh():
    import jax

    from torchmpi_tpu import parallel as jparallel

    return jparallel.make_mesh(MESH, devices=jax.devices()[:P])


def _global_fn(pkg, impl, causal, mesh):
    """The function of the global arrays in one package."""
    seq = pkg
    if impl == "zigzag":
        return seq.make_zigzag_ring_attention(mesh)
    if impl == "zigzag-layout":
        to_zz, from_zz, attention = seq.make_zigzag_layout(mesh)
        return lambda q, k, v: from_zz(attention(to_zz(q), to_zz(k),
                                                 to_zz(v)))
    return seq.make_ring_attention(mesh, causal=causal, impl=impl)


def _global_job(name, q, k, v, w):
    impl, causal = GLOBAL[name][:2]
    m = tmesh.make_mesh(MESH)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    o = _global_fn(tseq, impl, causal, m)(*ts)
    (torch.from_numpy(w) * o).sum().backward()
    return (o.detach().numpy(),) + tuple(t.grad.numpy() for t in ts)


# The fast set covers each strategy once (ring_flash causal at rep 4 and
# non-causal at rep 2); the other cases are a sweep, marked slow.
SLOW = {"ring-full", "ring_flash-causal-kv2", "ring_flash-full-kv1",
        "zigzag-layout", "ring_flash_batched"}


def _params(names):
    return [pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
            for n in sorted(names)]


@pytest.mark.parametrize("name", _params(GLOBAL))
def test_global_attention_matches_jax(pool, name):
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu.parallel import sequence as jseq

    impl, causal, L, H, KV, D = GLOBAL[name]
    q, k, v, w = _inputs(name, [(L, H, D), (L, KV, D), (L, KV, D),
                                (L, H, D)])
    fn = _global_fn(jseq, impl, causal, _jax_mesh())
    args = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(fn(*args))
    grads = jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * fn(*a)),
                     argnums=(0, 1, 2))(*args)
    for r, got in enumerate(pool.run(_global_job, name, q, k, v, w)):
        np.testing.assert_allclose(got[0], want, **TOL,
                                   err_msg=f"rank {r} o")
        for g, gw, what in zip(got[1:], grads, "qkv"):
            np.testing.assert_allclose(g, np.asarray(gw), **TOL,
                                       err_msg=f"rank {r} d{what}")


def _batched_body(seq, impl, mesh=None):
    if impl == "zigzag":
        return lambda q, k, v: seq.zigzag_ring_flash_attention_batched(
            q, k, v, **({} if mesh is None else {"mesh": mesh}))
    return lambda q, k, v: seq.ring_flash_attention_batched(
        q, k, v, causal=True, **({} if mesh is None else {"mesh": mesh}))


def _batched_job(name, q, k, v, w):
    impl = BATCHED[name][0]
    m = tmesh.make_mesh(MESH)
    n = q.shape[1] // SP
    sl = slice(m.coords["sp"] * n, (m.coords["sp"] + 1) * n)
    ts = [torch.from_numpy(a[:, sl].copy()).requires_grad_(True)
          for a in (q, k, v)]
    o = _batched_body(tseq, impl, m)(*ts)
    (torch.from_numpy(w[:, sl].copy()) * o).sum().backward()
    return (m.coords["sp"], o.detach().numpy()) + tuple(
        t.grad.numpy() for t in ts)


@pytest.mark.parametrize("name", _params(BATCHED))
def test_batched_bodies_match_jax(pool, name):
    """Each rank's chunk (in the layout the body takes: contiguous, or the
    zigzag pair of chunks) against device r's of the JAX body."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from torchmpi_tpu._compat import shard_map
    from torchmpi_tpu.parallel import sequence as jseq

    impl, _, B, L, H, KV, D = BATCHED[name]
    q, k, v, w = _inputs(name, [(B, L, H, D), (B, L, KV, D), (B, L, KV, D),
                                (B, L, H, D)])
    spec = JP(None, "sp", None, None)
    fn = jax.jit(shard_map(_batched_body(jseq, impl), mesh=_jax_mesh(),
                           in_specs=(spec,) * 3, out_specs=spec,
                           check_vma=False))
    args = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(fn(*args))
    grads = [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(jnp.asarray(w) * fn(*a)), argnums=(0, 1, 2))(
        *args)]
    n = L // SP
    for sp_i, o, *got in pool.run(_batched_job, name, q, k, v, w):
        sl = slice(sp_i * n, (sp_i + 1) * n)
        np.testing.assert_allclose(o, want[:, sl], **TOL)
        for g, gw, what in zip(got, grads, "qkv"):
            np.testing.assert_allclose(g, gw[:, sl], **TOL,
                                       err_msg=f"sp {sp_i} d{what}")


@pytest.mark.parametrize("L,p", [(16, 2), (64, 4), (48, 3)])
def test_zigzag_indices_match_jax(L, p):
    from torchmpi_tpu.parallel import sequence as jseq

    np.testing.assert_array_equal(tseq.zigzag_indices(L, p),
                                  jseq.zigzag_indices(L, p))
    with pytest.raises(ValueError) as jerr:
        jseq.zigzag_indices(L + 1, p)
    with pytest.raises(ValueError) as terr:
        tseq.zigzag_indices(L + 1, p)
    assert str(terr.value) == str(jerr.value)


def test_full_attention_matches_jax():
    """The single-device oracle, causal, GQA, bf16 in (f32 softmax)."""
    import jax.numpy as jnp

    from torchmpi_tpu.parallel import sequence as jseq

    q, k, v = _inputs("full", [(32, 4, 8), (32, 2, 8), (32, 2, 8)])
    for causal in (False, True):
        want = np.asarray(jseq.full_attention(*map(jnp.asarray, (q, k, v)),
                                              causal=causal))
        got = tseq.full_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal).numpy()
        np.testing.assert_allclose(got, want, **TOL)
