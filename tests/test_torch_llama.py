"""Parity of the port's Llama inference with the JAX package's.

The JAX package initialises the parameters; ``from_jax_params`` carries
them into the port, and both packages then run on the same numpy inputs.
The port runs on the CPU (``device="cpu"``), where its flash attention is
the plain version of its CUDA kernel; the JAX side runs its Pallas kernel
in interpret mode.  Everything is f32, so values agree to f32 summation
order: rtol/atol 1e-4 on logits and caches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmpi_tpu.models import llama as jl
from torchmpi_tpu_torch.models import llama as tl

TOL = dict(rtol=1e-4, atol=1e-4)


def _jparams(cfg, seed=0, dtype=jnp.float32):
    return jl.init(jax.random.PRNGKey(seed), cfg, dtype)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(cfg, seed=0):
    jp = _jparams(cfg, seed)
    return jp, tl.from_jax_params(_np_tree(jp), device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32), **TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_jax_params_carries_every_leaf(dtype):
    jp = _np_tree(_jparams(jl.tiny(), dtype=dtype))
    tp = tl.from_jax_params(jp, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == 12
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name
        np.testing.assert_array_equal(node.float().numpy(),
                                      leaf.astype(np.float32))
    assert tl.num_params(tp) == jl.num_params(jp)


def test_rms_norm_and_rope_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 9, 4, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = np.arange(100, 109)
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))


def test_causal_attention_gqa_repeat_matches_jax():
    # jnp.repeat repeats each KV head in place (repeat_interleave), not
    # the whole head block (Tensor.repeat); the two differ for KV > 1.
    rs = np.random.RandomState(1)
    q = rs.randn(1, 12, 4, 8).astype(np.float32)
    k = rs.randn(1, 12, 2, 8).astype(np.float32)
    v = rs.randn(1, 12, 2, 8).astype(np.float32)
    _close(tl._causal_attention(*map(torch.from_numpy, (q, k, v)), 0.35),
           jl._causal_attention(*map(jnp.asarray, (q, k, v)), 0.35))


@pytest.mark.parametrize("attn,Lp", [("full", 24), ("flash", 64)])
def test_prefill_logits_and_cache_match_jax(attn, Lp):
    cfg = jl.tiny(seq=128)
    jp, tp = _both(cfg)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, (2, Lp))
    jlog, jcache = jl._prefill(cfg, jp, jl.init_kv_cache(cfg, 2, 96),
                               jnp.asarray(prompt, jnp.int32), attn=attn)
    tlog, tcache = tl._prefill(cfg, tp, tl.init_kv_cache(cfg, 2, 96,
                                                         device="cpu"),
                               torch.from_numpy(prompt), attn=attn)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_decode_step_matches_jax():
    cfg = jl.tiny(seq=64)
    jp, tp = _both(cfg)
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, cfg.vocab, (2, 10))
    jcache = jl._prefill(cfg, jp, jl.init_kv_cache(cfg, 2, 32),
                         jnp.asarray(prompt, jnp.int32))[1]
    tcache = tl.from_jax_params(_np_tree(jcache), device="cpu")
    toks = rs.randint(0, cfg.vocab, (2,))
    jlog, jc = jl._decode_step(cfg, jp, jcache, jnp.asarray(toks, jnp.int32),
                               jnp.int32(10))
    tlog, tc = tl._decode_step(cfg, tp, tcache, torch.from_numpy(toks), 10)
    _close(tlog, jlog)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("prompt_len", [8, 1024])
def test_greedy_generation_matches_jax(prompt_len):
    # 8 tokens: full-attention prefill on both sides; 1024: the auto rule
    # picks flash on both sides (Pallas interpret vs the plain version).
    cfg = jl.tiny(seq=prompt_len + 8)
    jp, tp = _both(cfg)
    prompt = np.random.RandomState(4).randint(0, cfg.vocab, (1, prompt_len))
    jtoks = jl.make_generate_fn(cfg, prompt_len, 4)(
        jp, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0))
    ttoks = tl.make_generate_fn(cfg, prompt_len, 4, device="cpu")(
        tp, prompt)
    assert ttoks.dtype == torch.int32
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    assert tl._auto_attn(prompt_len) == ("flash" if prompt_len >= 1024
                                         else "full")
    jlog, _ = jl._prefill(cfg, jp, jl.init_kv_cache(cfg, 1, prompt_len),
                          jnp.asarray(prompt, jnp.int32))
    tlog, _ = tl._prefill(cfg, tp, tl.init_kv_cache(cfg, 1, prompt_len,
                                                    device="cpu"),
                          torch.from_numpy(prompt))
    _close(tlog, jlog)


@pytest.mark.parametrize("Lp,mode", [(1023, "full"), (1024, "flash"),
                                     (1088, "full"), (1536, "flash"),
                                     (2048, "flash")])
def test_prefill_auto_rule(Lp, mode):
    # 1088's largest power-of-two tile (64) is under 128: _auto_block
    # raises and both packages stay on full attention.
    assert tl._auto_attn(Lp) == mode


def _jax_filter(l, top_k, top_p):
    """``make_generate_fn``'s top-k/top-p threshold logic in jnp
    (torchmpi_tpu/models/llama.py ``pick``), as the reference.

    JAX's filter is inline in the closure ``pick`` and the reference
    package is not edited, so this copy is the only reference that can be
    called alone on given logits.  ``make_generate_fn`` runs the real one
    in the two tests below it, through the top-k and the top-p path."""
    neg = jnp.asarray(-1e30, l.dtype)
    if top_k:
        kth = jax.lax.top_k(l, top_k)[0][..., -1:]
        l = jnp.where(l < kth, neg, l)
    if 0.0 < top_p < 1.0:
        sorted_l = jnp.sort(l, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sorted_l, axis=-1)
        cum_excl = jnp.cumsum(probs, axis=-1) - probs
        cut = jnp.sum((cum_excl < top_p).astype(jnp.int32), axis=-1)
        thresh = jnp.take_along_axis(
            sorted_l, jnp.maximum(cut[..., None] - 1, 0), axis=-1)
        l = jnp.where(l < thresh, neg, l)
    return l


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.9),
                                         (7, 0.5), (0, 1e-6), (1, 0.0)])
def test_sampling_filter_matches_jax(top_k, top_p):
    l = np.random.RandomState(5).randn(3, 64).astype(np.float32) * 3
    ref = np.asarray(_jax_filter(jnp.asarray(l), top_k, top_p))
    got = tl.filter_logits(torch.from_numpy(l), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("top_k,top_p", [(1, 0.0), (0, 1e-6)])
def test_sampling_that_keeps_one_token_matches_jax(top_k, top_p):
    # A filter that keeps only the top token makes sampling deterministic,
    # so the two packages' generators cannot make the tokens differ.
    cfg = jl.tiny(seq=16)
    jp, tp = _both(cfg)
    prompt = np.random.RandomState(6).randint(0, cfg.vocab, (2, 8))
    kw = dict(temperature=0.7, top_k=top_k, top_p=top_p)
    jtoks = jl.make_generate_fn(cfg, 8, 4, **kw)(
        jp, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(1))
    ttoks = tl.make_generate_fn(cfg, 8, 4, device="cpu", **kw)(
        tp, prompt, torch.Generator().manual_seed(1))
    assert ttoks.tolist() == np.asarray(jtoks).tolist()


def test_top_p_threshold_keeps_the_dominant_token_like_jax():
    # Through JAX's real filter: at the temperature chosen here the greedy
    # token holds 55% of the mass at the least confident of the 4 steps,
    # so top_p=0.5 must keep it alone at every step (the exclusive mass of
    # the second token is 0.55 >= 0.5), while sampling without the filter
    # would leave it 45% of the time at that step.  Over 8 keys a wrong
    # threshold shows as a token that differs from greedy.
    cfg = jl.tiny(seq=16)
    jp, tp = _both(cfg)
    prompt = np.random.RandomState(7).randint(0, cfg.vocab, (1, 8))
    jprompt = jnp.asarray(prompt, jnp.int32)
    greedy = np.asarray(jl.make_generate_fn(cfg, 8, 4)(
        jp, jprompt, jax.random.PRNGKey(0)))
    seq = np.concatenate([prompt, greedy[:, :3]], axis=1)
    logits = np.stack([np.asarray(jl._prefill(
        cfg, jp, jl.init_kv_cache(cfg, 1, n),
        jnp.asarray(seq[:, :n], jnp.int32))[0][0]) for n in range(8, 12)])
    assert (logits.argmax(-1) == greedy[0]).all()

    def least_top_prob(t):
        z = logits / t
        p = np.exp(z - z.max(-1, keepdims=True))
        return (p.max(-1) / p.sum(-1)).min()

    lo, hi = 1e-3, 1e3                      # least_top_prob falls with t
    for _ in range(60):
        mid = (lo * hi) ** 0.5
        lo, hi = (mid, hi) if least_top_prob(mid) > 0.55 else (lo, mid)
    temperature = lo
    assert 0.55 <= least_top_prob(temperature) < 0.56
    kw = dict(temperature=temperature, top_p=0.5)
    jfn = jl.make_generate_fn(cfg, 8, 4, **kw)
    tfn = tl.make_generate_fn(cfg, 8, 4, device="cpu", **kw)
    for seed in range(8):
        assert np.asarray(jfn(jp, jprompt, jax.random.PRNGKey(seed))
                          ).tolist() == greedy.tolist()
        assert tfn(tp, prompt, torch.Generator().manual_seed(seed)
                   ).tolist() == greedy.tolist()


def test_sampling_uses_the_generator():
    cfg = jl.tiny(seq=16)
    tp = tl.init(0, cfg, device="cpu")
    fn = tl.make_generate_fn(cfg, 4, 6, temperature=1.0, device="cpu")
    prompt = [[1, 2, 3, 4]]
    a = fn(tp, prompt, torch.Generator().manual_seed(7))
    b = fn(tp, prompt, torch.Generator().manual_seed(7))
    assert a.tolist() == b.tolist()
    assert ((a >= 0) & (a < cfg.vocab)).all()


@pytest.mark.parametrize("kw", [
    dict(prompt_len=0, max_new=4), dict(prompt_len=4, max_new=0),
    dict(prompt_len=4, max_new=4, top_p=1.5),
    dict(prompt_len=4, max_new=4, temperature=1.0, top_k=-1),
    dict(prompt_len=4, max_new=4, temperature=1.0, top_k=10 ** 6),
    dict(prompt_len=4, max_new=4, top_k=3),
    dict(prompt_len=4, max_new=4, top_p=0.5),
])
def test_generate_argument_errors_match_jax(kw):
    cfg = jl.tiny()
    with pytest.raises(ValueError):
        jl.make_generate_fn(cfg, **kw)
    with pytest.raises(ValueError):
        tl.make_generate_fn(cfg, device="cpu", **kw)


def test_generate_rejects_wrong_prompt_length():
    cfg = jl.tiny()
    jp = _jparams(cfg)
    tp = tl.from_jax_params(_np_tree(jp), device="cpu")
    with pytest.raises(ValueError):
        jl.make_generate_fn(cfg, 8, 2)(jp, jnp.zeros((1, 7), jnp.int32),
                                       jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        tl.make_generate_fn(cfg, 8, 2, device="cpu")(tp, np.zeros((1, 7),
                                                                  np.int64))


@pytest.mark.parametrize("attn", ["ring", "ring-xla", "ring-zigzag"])
def test_ring_attention_waits_for_a_later_slice(attn):
    """The ring modes are ported (the mesh, item 12): without a mesh they
    raise what the JAX package raises, with the same message."""
    with pytest.raises(ValueError) as jerr:
        jl._make_attn_impl(jl.tiny(), attn, None, 0.25)
    with pytest.raises(ValueError) as terr:
        tl._make_attn_impl(tl.tiny(), attn, None, 0.25)
    assert str(terr.value) == str(jerr.value)


def test_init_matches_jax_shapes_and_scales():
    cfg = jl.tiny()
    jp = _np_tree(_jparams(cfg))
    tp = tl.init(0, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        # Same distributions: per-leaf std within 15% of the JAX draw's.
        np.testing.assert_allclose(node.float().std().item(),
                                   leaf.std(), rtol=0.15, atol=1e-6)
