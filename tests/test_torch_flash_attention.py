"""Parity of the port's flash attention, forward and backward, with the
JAX package's.

Both sides get the same inputs, made with numpy from a seed.  The JAX side
runs its Pallas kernels in interpret mode (automatic off-TPU); the port's
side runs on CPU tensors, i.e. the plain PyTorch versions of its CUDA
kernels (the kernels themselves are held against those plain versions on
the card by chip_smoke.py and the ``cuda`` tests here).  Both compute in
f32, so the tolerance is f32 summation order: rtol 1e-4, atol 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# The modules, not the functions of the same name the packages export.
jfa = importlib.import_module("torchmpi_tpu.ops.flash_attention")
tfa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, shape, lk=None):
    rs = np.random.RandomState(seed)
    kshape = shape if lk is None else (shape[0], lk) + shape[2:]
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(None, None), (32, 32), (16, 64),
                                    (64, 16)])
def test_flash_attention_matches_jax(causal, blocks):
    q, k, v = _qkv(0, (2, 64, 3, 16))
    bq, bk = blocks
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=bq, block_k=bk)
    with torch.no_grad():
        got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  block_q=bq, block_k=bk)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_block_lk_ne_lq_out_f32(causal):
    # The ring callers' form: (BH, Lq, D) Q against a longer K/V chunk,
    # outputs carried in f32; o and lse both compared.
    q, k, v = _qkv(1, (4, 32, 16), lk=64)
    ro, rlse = jfa.flash_fwd_block(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=16, block_k=32,
                                   out_dtype=jnp.float32)
    to, tlse = tfa.flash_fwd_block(_t(q), _t(k), _t(v), causal=causal,
                                   block_q=16, block_k=32,
                                   out_dtype=torch.float32)
    assert to.dtype == torch.float32 and tlse.shape == (4, 32, 1)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(rlse),
                               rtol=RTOL, atol=ATOL)


def test_flash_fwd_block_bf16_in_f32_out():
    # bf16 inputs are widened to f32 before both products on both sides.
    q, k, v = _qkv(2, (2, 32, 16))
    jb = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    ro, rlse = jfa.flash_fwd_block(*jb, causal=True, out_dtype=jnp.float32)
    to, tlse = tfa.flash_fwd_block(*tb, causal=True, out_dtype=torch.float32)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(rlse),
                               rtol=RTOL, atol=ATOL)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError:
        return ("ValueError", None)


@pytest.mark.parametrize("L", [64, 1024, 1536, 2048, 1088, 4096 + 64, 8192,
                               4096 + 128])
def test_auto_block_contract(L):
    assert _outcome(tfa._auto_block, L) == _outcome(jfa._auto_block, L)


@pytest.mark.parametrize("lens,blocks", [
    ((64, 64), (None, None)), ((64, 128), (32, None)), ((48, 64), (32, 32)),
    ((1088, 1024), (None, None)), ((1536, 2048), (None, 256)),
    ((100, 100), (64, 50)), ((2048, 2048), (4096, 4096)),
])
def test_resolve_blocks_contract(lens, blocks):
    assert _outcome(tfa._resolve_blocks, *lens, *blocks) \
        == _outcome(jfa._resolve_blocks, *lens, *blocks)


@pytest.mark.parametrize("shape_k,blocks", [
    ((1, 64, 2, 16), (48, None)),       # block does not divide L
    ((1, 32, 2, 16), (None, None)),     # k/v shape differs from q's
])
def test_flash_attention_shape_errors(shape_k, blocks):
    q = np.zeros((1, 64, 2, 16), np.float32)
    k = np.zeros(shape_k, np.float32)
    with pytest.raises(ValueError):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                            block_q=blocks[0], block_k=blocks[1])
    with pytest.raises(ValueError):
        tfa.flash_attention(_t(q), _t(k), _t(k), block_q=blocks[0],
                            block_k=blocks[1])


def _port_grads(q, k, v, do, **kw):
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **kw)
    return torch.autograd.grad(out, (tq, tk, tv), _t(do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(None, None), (32, 32), (16, 64)])
def test_flash_attention_gradients_match_jax(causal, blocks):
    # dq, dk, dv through _FlashCore (the dq and dk/dv passes) against
    # jax.vjp through the JAX custom_vjp (its two Pallas backward kernels).
    q, k, v = _qkv(3, (2, 64, 3, 16))
    do = np.random.RandomState(13).randn(*q.shape).astype(np.float32)
    bq, bk = blocks
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, block_q=bq, block_k=bk),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = _port_grads(q, k, v, do, causal=causal, block_q=bq, block_k=bk)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blocks", [(None, None), (16, 32)])
def test_flash_attention_gradients_match_plain_causal_attention(blocks):
    # A second oracle: autograd through the port's own plain causal
    # attention (full f32 softmax), with one KV head per head.
    from torchmpi_tpu_torch.models import llama as tl

    q, k, v = _qkv(5, (2, 64, 3, 16))
    do = np.random.RandomState(15).randn(*q.shape).astype(np.float32)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    ref = torch.autograd.grad(tl._causal_attention(tq, tk, tv, 0.25),
                              (tq, tk, tv), _t(do))
    got = _port_grads(q, k, v, do, causal=True, block_q=blocks[0],
                      block_k=blocks[1])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_block_lk_ne_lq_external_lse_out_f32(causal):
    # The ring callers' form: (BH, Lq, D) Q against a longer K/V chunk, with
    # an lse and delta handed in from outside and gradients carried in f32.
    q, k, v = _qkv(6, (4, 32, 16), lk=64)
    rs = np.random.RandomState(16)
    do = rs.randn(*q.shape).astype(np.float32)
    lse = (rs.rand(4, 32, 1) * 2 + 3).astype(np.float32)
    delta = rs.randn(4, 32, 1).astype(np.float32)
    ref = jfa.flash_bwd_block(*map(jnp.asarray, (q, k, v, do, lse, delta)),
                              causal=causal, block_q=16, block_k=32,
                              out_dtype=jnp.float32)
    got = tfa.flash_bwd_block(*map(_t, (q, k, v, do, lse, delta)),
                              causal=causal, block_q=16, block_k=32,
                              out_dtype=torch.float32)
    assert [tuple(g.shape) for g in got] == [(4, 32, 16), (4, 64, 16),
                                             (4, 64, 16)]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


def test_flash_bwd_block_keeps_input_dtypes():
    # dq in q's dtype and dk/dv in k's when no out_dtype is given.
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(7, (2, 32, 16)))
    do = torch.ones_like(q)
    lse = torch.zeros((2, 32, 1))
    dq, dk, dv = tfa.flash_bwd_block(q, k, v, do, lse, torch.zeros_like(lse),
                                     causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


@pytest.mark.parametrize("op", ["fwd", "bwd"])
def test_block_ops_refuse_a_gradient(op):
    # As in JAX the block ops are not differentiable; flash_attention is.
    q, k, v = (_t(a).requires_grad_() for a in _qkv(8, (2, 32, 16)))
    with pytest.raises(RuntimeError, match="non-differentiable"):
        if op == "fwd":
            tfa.flash_fwd_block(q, k, v, causal=True)
        else:
            row = torch.zeros((2, 32, 1))
            tfa.flash_bwd_block(q, k, v, q, row, row, causal=True)
    with torch.no_grad():
        tfa.flash_fwd_block(q, k, v, causal=True)


def test_plain_version_does_not_count_as_a_launch():
    before = (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
              tfa.flash_bwd_dkv_launches)
    q, k, v = (_t(a).requires_grad_() for a in _qkv(4, (1, 32, 2, 16)))
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
            tfa.flash_bwd_dkv_launches) == before


@pytest.mark.parametrize("part,shifted", [
    ("dq", "q"), ("dq", "do"), ("dkv", "k"), ("dkv", "v")])
def test_bf16_bwd_kernels_refuse_unaligned_tensors(monkeypatch, part,
                                                   shifted):
    # The tensor-core dq and dk/dv kernels read q, k, v and do with TMA:
    # the wrappers check every one, with the forward's message, before a
    # launch.  (The checks of device and shape are the card's business.)
    monkeypatch.setattr(tfa, "_check_bwd_kernel_inputs", lambda *a: None)

    def no_launch(*a, **kw):
        raise AssertionError("an unaligned tensor reached the launch")

    monkeypatch.setattr(tfa, "_launch", no_launch)
    flat = torch.zeros(2 * 8 * 128 + 1, dtype=torch.bfloat16)
    ins = {n: flat[:2 * 8 * 128].view(2, 8, 128) for n in "qkv"}
    ins["do"] = ins["q"]
    ins[shifted] = flat[1:].view(2, 8, 128)
    row = torch.zeros((2, 8, 1))
    fn = {"dq": tfa._flash_bh_bwd_dq_kernel,
          "dkv": tfa._flash_bh_bwd_dkv_kernel}[part]
    with pytest.raises(ValueError,
                       match=f"bf16 flash kernels need 16-byte aligned "
                             f"tensors; {shifted} is not"):
        fn(ins["q"], ins["k"], ins["v"], ins["do"], row, row, causal=True,
           scale=0.1, out_dtype=torch.bfloat16)


def _tc_bwd_model(q, k, v, do, lse, delta, *, scale, split):
    """The tensor-core backward's arithmetic in f32 PyTorch, causal: s and
    dp in f32, p and ds handed to the second-stage products as bf16 (or as
    bf16 hi + lo parts, which sum exactly in f32)."""
    def as_operand(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi

    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    rows = torch.arange(q.shape[1])[:, None]
    cols = torch.arange(k.shape[1])[None, :]
    p = torch.exp(torch.where(rows >= cols, s, torch.tensor(-1e30)) - lse)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, v) - delta) * scale
    p, ds = as_operand(p), as_operand(ds)
    return (torch.einsum("bqk,bkd->bqd", ds, k),
            torch.einsum("bqk,bqd->bkd", ds, q),
            torch.einsum("bqk,bqd->bkd", p, do))


def test_bf16_p_and_ds_fit_the_bf16_tolerance_and_need_a_split_for_f32():
    # Why the f32-output kernels split p and ds: a causal flash_bwd_block
    # as a ring caller runs it (Lk > Lq, lse + log 2, another output's
    # delta), bf16-rounded inputs, D = 128.  Against the f32 plain
    # backward, bf16 p and ds stay inside chip_smoke.py's bf16-output
    # tolerance (1e-2 abs + 1e-2 rel) but break its f32-output one (5e-4
    # abs + 1e-3 rel); the hi + lo split keeps that one.
    rs = np.random.RandomState(21)
    bh, lq, lk, d = 2, 256, 512, 128
    q, do = (torch.from_numpy(rs.randn(bh, lq, d).astype(np.float32))
             .bfloat16().float() for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(bh, lk, d).astype(np.float32))
            .bfloat16().float() for _ in range(2))
    scale = d ** -0.5
    _, lse = tfa._flash_bh_plain(q, k, v, causal=True, block_q=lq,
                                 block_k=lk, scale=scale,
                                 out_dtype=torch.float32)
    lse = lse + np.log(2.0)
    delta = torch.from_numpy(rs.randn(bh, lq, 1).astype(np.float32))
    kw = dict(causal=True, block_q=lq, block_k=lk, scale=scale,
              out_dtype=torch.float32)
    ref = (tfa._flash_bh_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
           *tfa._flash_bh_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))

    def worst(split, atol, rtol):
        got = _tc_bwd_model(q, k, v, do, lse, delta, scale=scale,
                            split=split)
        return max(float(((a - b).abs() / (atol + rtol * b.abs())).max())
                   for a, b in zip(got, ref))

    assert worst(False, 1e-2, 1e-2) <= 1.0
    assert worst(False, 5e-4, 1e-3) > 1.0
    assert worst(True, 5e-4, 1e-3) <= 1.0


def _split_parts(x):
    """x's bf16 hi and lo parts, as f32 values."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tf32(x):
    """x rounded to TF32's 10 significand bits (to nearest, ties away)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)


def _product(eq, a, b, form):
    """One product of the tensor cores' arithmetic in f32 PyTorch:
    ``"split3"`` A_hi B_hi + A_hi B_lo + A_lo B_hi (each exact in f32),
    ``"bf16"`` or ``"tf32"`` one product of the rounded operands."""
    if form == "split3":
        (ah, al), (bh, bl) = _split_parts(a), _split_parts(b)
        return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, al, bh))
    r = _tf32 if form == "tf32" else (lambda x: x.bfloat16().float())
    return torch.einsum(eq, r(a), r(b))


@pytest.mark.parametrize("form,fits", [("split3", True), ("bf16", False),
                                       ("tf32", False)])
def test_f32_inputs_need_three_bf16_products(form, fits):
    # Why the f32-input kernel forms S = Q K^T and O = P V as three bf16
    # products each: causal, bh 2, L 256, D 128, against the f32 plain
    # forward, the three-product form stays inside chip_smoke.py's f32
    # tolerance (2e-4 abs on o; ~0.07 of it), where one bf16 product (~40x
    # over) or one TF32 product (~6x over) does not.
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, (2, 256, 128)))
    scale = 128 ** -0.5
    ref, _ = tfa._flash_bh_plain(q, k, v, causal=True, block_q=256,
                                 block_k=256, scale=scale,
                                 out_dtype=torch.float32)
    s = _product("bqd,bkd->bqk", q, k, form) * scale
    rows, cols = torch.arange(256)[:, None], torch.arange(256)[None, :]
    s = torch.where(rows >= cols, s, torch.tensor(tfa.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _product("bqk,bkd->bqd", p, v, form) / p.sum(-1, keepdim=True)
    worst = float((o - ref).abs().max()) / 2e-4
    assert (worst <= 0.5) if fits else (worst > 2.0), worst


def test_f32_kernel_gets_its_inputs_as_one_split(monkeypatch):
    # The f32 forward hands the kernel q, k and v as their bf16 hi + lo
    # buffers, made by one call of the split for all three, and keeps the
    # f32 tensors for shapes and the dtype code.  (On CPU tensors the split
    # takes its plain version; the launch is the card's business.)
    monkeypatch.setattr(tfa, "_check_kernel_inputs", lambda *a: None)
    seen, splits = {}, []
    real_split = tfa.bf16_split

    def split(library, *xs):
        splits.append(library)
        return real_split(library, *xs)

    monkeypatch.setattr(tfa, "bf16_split", split)
    monkeypatch.setattr(tfa, "_launch", lambda symbol, ins, outs, **kw:
                        seen.update(symbol=symbol, ins=ins, outs=outs, **kw))
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, (2, 8, 128), lk=24))
    o, lse = tfa._flash_bh_kernel(q, k, v, causal=True, scale=0.1,
                                  out_dtype=torch.bfloat16)
    assert splits == ["flash_attention_fwd"]
    assert seen["symbol"] == "tmpi_flash_fwd"
    assert all(a is b for a, b in zip(seen["ins"], (q, k, v)))
    assert all(a is b for a, b in zip(seen["outs"], (o, lse)))
    assert o.dtype == torch.bfloat16 and len(seen["feed"]) == 3
    for x, buf in zip((q, k, v), seen["feed"]):
        assert buf.shape == (2, *x.shape) and buf.dtype == torch.bfloat16
        assert torch.equal(buf[0], x.bfloat16())
        assert torch.equal(buf[1], (x - x.bfloat16().float()).bfloat16())


def test_f32_kernel_refuses_unaligned_tensors(monkeypatch):
    # The split reads f32 q, k, v in 16-byte pieces and the kernel writes o
    # in vector stores: an f32 view one element in is refused before any
    # split or launch.
    monkeypatch.setattr(tfa, "_check_kernel_inputs", lambda *a: None)

    def no_call(*a, **kw):
        raise AssertionError("an unaligned tensor reached the kernels")

    monkeypatch.setattr(tfa, "bf16_split", no_call)
    monkeypatch.setattr(tfa, "_launch", no_call)
    flat = torch.zeros(2 * 8 * 128 + 1)
    q = flat[:2 * 8 * 128].view(2, 8, 128)
    v = flat[1:].view(2, 8, 128)
    with pytest.raises(ValueError, match="f32 flash kernels need 16-byte "
                                         "aligned tensors; v is not"):
        tfa._flash_bh_kernel(q, q, v, causal=False, scale=0.1,
                             out_dtype=torch.float32)


def _bf16_rn(x):
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _toward_zero(x):
    """f64 values rounded to f32 toward zero: to nearest, then one ulp in
    where that went out past x."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return (r.view(np.int32) - over).view(np.float32)


def _tc_product(acc, a, b, split, first=False):
    """acc + A B (A (m, n), B (n, p), f32 numpy) in the tensor cores'
    arithmetic: ``split`` A_hi B_hi + A_hi B_lo + A_lo B_hi from bf16 hi +
    lo parts, else one product of bf16(A) and bf16(B); one k16 step at a
    time along n, each step's sum (exact: bf16 x bf16 products) added into
    the f32 accumulator rounding toward zero, as wgmma does.  ``first``:
    the first step overwrites acc."""
    def parts(x):
        hi = _bf16_rn(x)
        return (hi, _bf16_rn(x - hi)) if split else (hi,)

    a, b = parts(a), parts(b)
    pairs = [(a[0], b[0])] + ([(a[0], b[1]), (a[1], b[0])] if split else [])
    for x, y in pairs:
        for j in range(0, x.shape[1], 16):
            step = (x[:, j:j + 16].astype(np.float64)
                    @ y[j:j + 16].astype(np.float64))
            acc = _toward_zero(step if first else acc + step)
            first = False
    return acc


def _split_bwd_model_error(split, L=2048, rows=64, tile=32, d=128):
    """The f32 backward kernels' arithmetic at one head, causal, L = 2048,
    on the rows with the longest sums: dq of the last 64 q rows (each over
    up to 2048 keys) and dk, dv of the first 64 k rows (each over 2048 q
    rows).  S and dP come from three bf16 products (or one), p and ds are
    formed in f32 and split in registers, and each second-stage product
    runs tile by tile (32 rows, 2 k16 steps a part): 384 truncating steps
    into each accumulator.  Returns the worst error over dq, dk and dv in
    units of the f32 tolerance, 5e-4 abs + 1e-3 rel, against the f64
    gradients of the same f32 inputs, lse and delta."""
    rs = np.random.RandomState(17)
    q, k, v, do = (rs.randn(L, d).astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    f64 = np.float64
    s = np.where(np.tril(np.ones((L, L), bool)),
                 q.astype(f64) @ k.T.astype(f64) * scale, -np.inf)
    m = s.max(1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(1, keepdims=True))).astype(np.float32)
    p = np.exp(s - lse.astype(f64))
    delta = (do.astype(f64) * (p @ v.astype(f64))).sum(
        1, keepdims=True).astype(np.float32)
    ds = p * (do.astype(f64) @ v.T.astype(f64) - delta.astype(f64)) * scale
    want = (ds[-rows:] @ k, ds[:, :rows].T @ q, p[:, :rows].T @ do)

    def p_ds(st, dpt, lse_r, delta_r, keep):
        x = np.where(keep, st * np.float32(scale) - lse_r, -np.inf)
        pp = np.exp(x.astype(np.float32))
        return pp, (pp * (dpt - delta_r) * np.float32(scale)).astype(
            np.float32)

    zero = np.zeros((rows, L), np.float32)
    sq = _tc_product(zero, q[-rows:], k.T, split, first=True)
    dpq = _tc_product(zero, do[-rows:], v.T, split, first=True)
    keep = np.arange(L - rows, L)[:, None] >= np.arange(L)[None]
    _, dsq = p_ds(sq, dpq, lse[-rows:], delta[-rows:], keep)
    st = _tc_product(zero, k[:rows], q.T, split, first=True)
    dpt = _tc_product(zero, v[:rows], do.T, split, first=True)
    keep = np.arange(L)[None] >= np.arange(rows)[:, None]
    pt, dst = p_ds(st, dpt, lse.T, delta.T, keep)
    dq, dk, dv = (np.zeros((rows, d), np.float32) for _ in range(3))
    for t in range(0, L, tile):
        dq = _tc_product(dq, dsq[:, t:t + tile], k[t:t + tile], split)
        dv = _tc_product(dv, pt[:, t:t + tile], do[t:t + tile], split)
        dk = _tc_product(dk, dst[:, t:t + tile], q[t:t + tile], split)
    return max(float((np.abs(g - w) / (5e-4 + 1e-3 * np.abs(w))).max())
               for g, w in zip((dq, dk, dv), want))


@pytest.mark.parametrize("form,fits", [("split3", True), ("bf16", False)])
def test_f32_backward_needs_three_bf16_products(form, fits):
    # Why the f32-input backward forms every product as three bf16
    # products, and why it needs no per-chunk sums: with the tensor cores'
    # truncating accumulation modelled step by step, the three-product form
    # keeps dq, dk and dv within ~0.04 of chip_smoke.py's f32 tolerance at
    # L = 2048, where one bf16 product (bf16 inputs, p and ds) is ~16x over.
    worst = _split_bwd_model_error(form == "split3")
    assert (worst <= 0.25) if fits else (worst > 2.0), worst


def test_f32_backward_splits_its_inputs_once_for_both_passes(monkeypatch):
    # An f32 backward call splits q, k, v and do with one launch of the
    # backward library's split, and both passes read those four buffers
    # (with lse and delta) in place of the f32 tensors, which still give
    # the shapes and the dtype code.  (On CPU tensors the split takes its
    # plain version; the launches are the card's business.)
    monkeypatch.setattr(tfa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(tfa, "_check_bwd_kernel_inputs", lambda *a: None)
    splits, launches = [], []
    real_split = tfa.bf16_split

    def split(library, *xs):
        splits.append((library, xs))
        return real_split(library, *xs)

    monkeypatch.setattr(tfa, "bf16_split", split)
    monkeypatch.setattr(tfa, "_launch", lambda symbol, ins, outs, **kw:
                        launches.append((symbol, ins, outs, kw["feed"])))
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, (2, 8, 128), lk=24))
    do = torch.from_numpy(_qkv(11, (2, 8, 128))[0])
    lse, delta = torch.zeros((2, 8, 1)), torch.ones((2, 8, 1))
    dq, dk, dv = tfa._flash_bh_bwd(q, k, v, do, lse, delta, causal=True,
                                   block_q=8, block_k=8,
                                   out_dtype=torch.bfloat16)
    assert [lib for lib, _ in splits] == ["flash_attention_bwd"]
    assert all(a is b for a, b in zip(splits[0][1], (q, k, v, do)))
    assert [sym for sym, *_ in launches] == ["tmpi_flash_bwd_dq",
                                             "tmpi_flash_bwd_dkv"]
    first, second = launches[0][3], launches[1][3]
    assert len(first) == 6 and all(a is b for a, b in zip(first, second))
    assert first[4] is lse and first[5] is delta
    for x, buf in zip((q, k, v, do), first[:4]):
        assert buf.shape == (2, *x.shape) and buf.dtype == torch.bfloat16
        assert torch.equal(buf[0], x.bfloat16())
        assert torch.equal(buf[1], (x - x.bfloat16().float()).bfloat16())
    for sym, ins, outs, _ in launches:
        assert all(a is b for a, b in zip(ins, (q, k, v, do, lse, delta)))
    assert launches[0][2] == (dq,) and launches[1][2] == (dk, dv)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("part,shifted", [
    ("dq", "q"), ("dq", "do"), ("dkv", "k"), ("dkv", "v"), ("both", "do")])
def test_f32_bwd_kernels_refuse_unaligned_tensors(monkeypatch, part,
                                                  shifted):
    # The split reads the f32 inputs in 16-byte pieces and the kernels write
    # their outputs in vector stores: an f32 view one element in is refused
    # before any split or launch, called pass by pass or as one backward.
    monkeypatch.setattr(tfa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(tfa, "_check_bwd_kernel_inputs", lambda *a: None)

    def no_call(*a, **kw):
        raise AssertionError("an unaligned tensor reached the kernels")

    monkeypatch.setattr(tfa, "bf16_split", no_call)
    monkeypatch.setattr(tfa, "_launch", no_call)
    flat = torch.zeros(2 * 8 * 128 + 1)
    ins = {n: flat[:2 * 8 * 128].view(2, 8, 128) for n in ("q", "k", "v",
                                                           "do")}
    ins[shifted] = flat[1:].view(2, 8, 128)
    row = torch.zeros((2, 8, 1))
    args = (ins["q"], ins["k"], ins["v"], ins["do"], row, row)
    fn = {"dq": tfa._flash_bh_bwd_dq_kernel,
          "dkv": tfa._flash_bh_bwd_dkv_kernel}.get(part)
    with pytest.raises(ValueError,
                       match=f"f32 flash kernels need 16-byte aligned "
                             f"tensors; {shifted} is not"):
        if fn is None:
            tfa._flash_bh_bwd(*args, causal=True, block_q=8, block_k=8)
        else:
            fn(*args, causal=True, scale=0.1, out_dtype=torch.float32)


def test_bf16_kernel_refuses_unaligned_tensors():
    # The tensor-core forward reads q, k, v with TMA and writes o in vector
    # stores; a view one element in is not on a 16-byte boundary.
    flat = torch.zeros(2 * 128 + 1, dtype=torch.bfloat16)
    aligned, shifted = flat[:256], flat[1:257]
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2
    tfa._check_aligned(q=aligned, k=aligned)
    with pytest.raises(ValueError, match="16-byte aligned.* k is not"):
        tfa._check_aligned(q=aligned, k=shifted)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::tc::flash_fwd_wgmma<false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, void*, float*, int, int, float, int)",
     "flash_attention_fwd"),
    ("void (anonymous namespace)::tc::flash_fwd_wgmma<true, true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, void*, float*, int, "
     "int, float, int)", "flash_attention_fwd"),
    ("void (anonymous namespace)::tc::flash_bwd_dq_wgmma<false>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
     "const*, float const*, void*, int, int, float, float, int)",
     "flash_attention_bwd_dq"),
    ("void (anonymous namespace)::tc::flash_bwd_dkv_wgmma<true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
     "const*, float const*, void*, void*, int, int, float, float, int)",
     "flash_attention_bwd_dkv"),
    ("void (anonymous namespace)::tc::flash_bwd_dq_wgmma<true, true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
     "const*, float const*, void*, int, int, float, float, int)",
     "flash_attention_bwd_dq"),
    ("void (anonymous namespace)::tc::flash_bwd_dkv_wgmma<false, true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
     "const*, float const*, void*, void*, int, int, float, float, int)",
     "flash_attention_bwd_dkv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul")])
def test_profile_train_sorts_the_port_kernels_by_name(name, kind):
    # tools/profile_train sums device time by kernel name; each pass's
    # instantiations (bf16 inputs, and f32 inputs as three bf16 products)
    # count as that pass.
    from torchmpi_tpu_torch.tools import profile_train

    assert profile_train.kind_of(name) == kind


@pytest.mark.cuda
@pytest.mark.parametrize("causal,lq,lk", [(True, 512, 2048),
                                          (False, 100, 300),
                                          (True, 100, 300)])
def test_bf16_in_f32_out_keeps_f32_accuracy_on_the_card(causal, lq, lk):
    # The ring carry: bf16 q/k/v, o in f32, held at the f32 cases' 2e-4.
    # A bf16 P alone misses that on short causal rows; the kernel's
    # P_hi V + P_lo V split keeps ~16 bits of p.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((8, lq, 128), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((8, lk, 128), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    o, lse = tfa.flash_fwd_block(q, k, v, causal=causal,
                                 out_dtype=torch.float32)
    bq, bk = tfa._resolve_blocks(lq, lk, None, None)
    po, plse = tfa._flash_bh_plain(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk, scale=128 ** -0.5,
                                   out_dtype=torch.float32)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, po, rtol=0, atol=2e-4)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,lq,lk", [
    ("bfloat16", True, 256, 256), ("float32", True, 256, 256),
    ("bfloat16", False, 128, 384), ("float32", False, 100, 300),
    ("bfloat16", True, 100, 300), ("bfloat16", False, 100, 300),
    ("bfloat16", True, 512, 2048)])
def test_kernel_matches_plain_version_on_the_card(dtype, causal, lq, lk):
    # The CUDA kernel exists only on the card; chip_smoke.py runs the same
    # comparison at the generate path's full shape.  bf16 forms each of
    # its two products as one bf16 product (ragged Lq 100 / Lk 300 and
    # Lk != Lq included), f32 as three.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((8, n, 128), generator=g, device="cuda").to(dt)
               for n in (lq, lk, lk))
    before = tfa.flash_fwd_launches
    o, lse = tfa.flash_fwd_block(q, k, v, causal=causal)
    assert tfa.flash_fwd_launches == before + 1
    bq, bk = tfa._resolve_blocks(lq, lk, None, None)
    po, plse = tfa._flash_bh_plain(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk, scale=128 ** -0.5,
                                   out_dtype=dt)
    # f32: summation order only.  bf16 output: one last-place flip, and the
    # bf16 P of the tensor-core kernel (at most 2^-9 of sum p|v| / l).
    tol = dict(rtol=0, atol=2e-4) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(o.float(), po.float(), **tol)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("out,causal,lq,lk", [
    ("bfloat16", True, 256, 256), ("bfloat16", False, 100, 300),
    ("float32", True, 100, 300), ("float32", True, 512, 2048)])
def test_f32_inputs_match_plain_version_on_the_card(out, causal, lq, lk):
    # f32 q, k, v: one split launch for all three, then one launch of the
    # three-product kernel, for either output type; f32 out at the f32
    # cases' 2e-4, bf16 out at the bf16 tolerance.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")
    odt = getattr(torch, out)
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn((8, n, 128), generator=g, device="cuda")
               for n in (lq, lk, lk))
    before = (tfa.flash_fwd_launches, split.bf16_split_launches)
    o, lse = tfa.flash_fwd_block(q, k, v, causal=causal, out_dtype=odt)
    assert (tfa.flash_fwd_launches, split.bf16_split_launches) == (
        before[0] + 1, before[1] + 1)
    bq, bk = tfa._resolve_blocks(lq, lk, None, None)
    po, plse = tfa._flash_bh_plain(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk, scale=128 ** -0.5,
                                   out_dtype=odt)
    tol = dict(rtol=0, atol=2e-4) if out == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    assert o.dtype == odt
    torch.testing.assert_close(o.float(), po.float(), **tol)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("library", ["flash_attention_fwd", "conv3x3"])
def test_split_kernel_matches_its_plain_version_on_the_card(library):
    # Bit for bit, in both libraries that export it: aligned operands of a
    # length that is a multiple of 8, a ragged tail, and a source one
    # element into its storage (element by element).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")
    g = torch.Generator(device="cuda").manual_seed(7)
    flat = torch.randn(4099, generator=g, device="cuda") * 100
    xs = (flat[:4096].view(32, 128), flat[:1001], flat[1:4097])
    before = split.bf16_split_launches
    got = split.bf16_split(library, *xs)
    assert split.bf16_split_launches == before + 1
    for x, buf in zip(xs, got):
        assert torch.equal(buf, split.bf16_split_plain(x))


def _bwd_inputs(dtype, causal, lq, lk, ring, seed=1):
    """q, k, v, do on the card, the forward's lse and the delta of its
    output; ``ring``: as a ring caller hands them in, lse + log 2 (a second
    chunk of equal mass) and another output's delta."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((8, lq, 128), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((8, lk, 128), generator=g, device="cuda").to(dt)
            for _ in range(2))
    with torch.no_grad():
        o, lse = tfa.flash_fwd_block(q, k, v, causal=causal)
    if ring:
        return (q, k, v, do, lse + float(np.log(2.0)),
                torch.randn((8, lq, 1), generator=g, device="cuda"))
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out,causal,lq,lk", [
    ("bfloat16", None, True, 256, 256), ("float32", None, True, 256, 256),
    ("bfloat16", None, False, 128, 384), ("float32", None, False, 100, 300),
    ("bfloat16", None, True, 100, 300), ("bfloat16", None, False, 100, 300),
    ("bfloat16", "float32", True, 512, 2048),
    ("bfloat16", "float32", False, 100, 300)])
def test_bwd_kernels_match_plain_versions_on_the_card(dtype, out, causal, lq,
                                                      lk):
    # The dq and dk/dv kernels exist only on the card; chip_smoke.py runs
    # the same comparison at the training path's full shape.  bf16 runs
    # the tensor-core kernels (ragged Lq 100 / Lk 300 and Lk != Lq
    # included; an f32 output as the ring carry, with the ring's lse and
    # delta), f32 the same kernels as three bf16 products.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    odt = getattr(torch, out or dtype)
    q, k, v, do, lse, delta = _bwd_inputs(dtype, causal, lq, lk,
                                          ring=out is not None)
    before = (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches)
    got = tfa.flash_bwd_block(q, k, v, do, lse, delta, causal=causal,
                              out_dtype=odt)
    assert (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    bq, bk = tfa._resolve_blocks(lq, lk, None, None)
    kw = dict(causal=causal, block_q=bq, block_k=bk, scale=128 ** -0.5,
              out_dtype=odt)
    ref = (tfa._flash_bh_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
           *tfa._flash_bh_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    # f32 output: the same f32 products summed in another order (and, from
    # bf16 inputs, p and ds as bf16 hi + lo parts).  bf16 output: one
    # last-place flip, and the bf16 p and ds of the tensor-core kernels.
    tol = dict(rtol=1e-3, atol=5e-4) if odt == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(got, ref):
        assert a.dtype == odt
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("out,causal,lq,lk", [
    ("float32", True, 2048, 2048), ("bfloat16", True, 2048, 2048),
    ("float32", False, 100, 300), ("bfloat16", True, 100, 300),
    ("float32", True, 512, 2048)])
def test_f32_bwd_kernels_match_plain_versions_on_the_card(out, causal, lq,
                                                          lk):
    # f32 q, k, v, do: one split launch for all four, then one launch of
    # each three-product pass, for either output type; f32 out at the f32
    # cases' 5e-4 abs + 1e-3 rel (the main shape's 2048-step sums
    # included), bf16 out at the bf16 tolerance.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")
    odt = getattr(torch, out)
    q, k, v, do, lse, delta = _bwd_inputs("float32", causal, lq, lk,
                                          ring=lq != lk)
    before = (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches,
              split.bf16_split_launches)
    got = tfa.flash_bwd_block(q, k, v, do, lse, delta, causal=causal,
                              out_dtype=odt)
    assert (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches,
            split.bf16_split_launches) == (before[0] + 1, before[1] + 1,
                                           before[2] + 1)
    bq, bk = tfa._resolve_blocks(lq, lk, None, None)
    kw = dict(causal=causal, block_q=bq, block_k=bk, scale=128 ** -0.5,
              out_dtype=odt)
    ref = (tfa._flash_bh_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
           *tfa._flash_bh_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    tol = dict(rtol=1e-3, atol=5e-4) if out == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(got, ref):
        assert a.dtype == odt
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
def test_split_kernel_takes_four_operands_on_the_card():
    # The backward's split: q, k, v and do in one launch, bit for bit,
    # beside a ragged tail and a source one element into its storage.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")
    g = torch.Generator(device="cuda").manual_seed(8)
    flat = torch.randn(8195, generator=g, device="cuda") * 100
    xs = (flat[:4096].view(32, 128), flat[4096:8192].view(2, 16, 128),
          flat[:1001], flat[1:4097])
    before = split.bf16_split_launches
    got = split.bf16_split("flash_attention_bwd", *xs)
    assert split.bf16_split_launches == before + 1
    for x, buf in zip(xs, got):
        assert torch.equal(buf, split.bf16_split_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("out,causal,lq,lk", [
    ("bfloat16", True, 512, 512), ("float32", True, 512, 2048),
    ("bfloat16", False, 100, 300)])
def test_bf16_bwd_kernels_are_deterministic_on_the_card(out, causal, lq, lk):
    # Two passes and no atomics: every output row is summed by one CTA in
    # a fixed order, so two calls give bitwise-equal dq, dk and dv.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args = _bwd_inputs("bfloat16", causal, lq, lk, ring=out == "float32")
    odt = getattr(torch, out)
    first = tfa.flash_bwd_block(*args, causal=causal, out_dtype=odt)
    second = tfa.flash_bwd_block(*args, causal=causal, out_dtype=odt)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_build_is_keyed_by_source_and_refuses_without_nvcc(monkeypatch,
                                                          tmp_path):
    from torchmpi_tpu_torch import _build

    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    first = _build.library_path("k")
    assert first == _build.library_path("k")          # stable
    src.write_text("// two\n")
    assert _build.library_path("k") != first          # keyed by content
    assert _build.sources() == ["k"]
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build("k")
    with pytest.raises(_build.BuildError, match="no kernel source"):
        _build.library_path("missing")


def test_chip_smoke_bound_at_the_generate_shape():
    # The bound chip_smoke.py reports for the prefill's attention: causal
    # (q, k) pairs L(L+1)/2 per head, 4 ops per pair per head-dim unit.
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    ms, by = chip_smoke.attention_bound_ms(32, 2048, 2048, 128, True,
                                           "bfloat16", 2, 2)
    ops = 4.0 * 32 * (2048 * 2049 // 2) * 128
    assert by == "operations"
    assert ms == pytest.approx(ops / 989e12 * 1e3)
    assert 0.034 < ms < 0.036
    ms, by = chip_smoke.attention_bound_ms(32, 1, 2048, 128, False,
                                           "bfloat16", 2, 2)
    assert by == "bytes"       # one query row against the cache: a read


def test_chip_smoke_f32_bound_is_three_bf16_products():
    # f32 rows are bounded at 989e12 / 3 operations a second, the dense
    # bf16 rate over the three products an f32-accurate product takes on
    # the tensor cores: B4 f32 at the generate shape 0.104 ms, B5 / B6 f32
    # 0.156 / 0.209 ms at the training shape, B7 f32 0.090 ms at each
    # bench shape.
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    assert chip_smoke.PEAK_OPS_PER_S["float32"] == 989e12 / 3
    one_product = 2.0 * 32 * (2048 * 2049 // 2) * 128
    ms, by = chip_smoke.attention_bound_ms(32, 2048, 2048, 128, True,
                                           "float32", 4, 4)
    assert by == "operations"
    assert ms == pytest.approx(2 * one_product / (989e12 / 3) * 1e3)
    assert ms == pytest.approx(0.104, abs=0.001)
    for kernel, want in (("dq", 0.156), ("dkv", 0.209)):
        ms, by = chip_smoke.attention_bwd_bound_ms(kernel, 32, 2048, 2048,
                                                   128, True, "float32", 4,
                                                   4)
        assert by == "operations" and ms == pytest.approx(want, abs=0.001)
    for n, h, c in ((128, 7, 512), (128, 14, 256)):
        ms, by = chip_smoke.conv_bound_ms(n, h, h, c, c, "float32", 4)
        assert by == "operations"
        assert ms == pytest.approx(2.0 * n * h * h * 9 * c * c
                                   / (989e12 / 3) * 1e3)
        assert ms == pytest.approx(0.090, abs=0.001)


def test_chip_smoke_backward_bounds_at_the_training_shape():
    # dq: three products (s, dp, dq), dk/dv: four (s, dp, dv, dk), each
    # 2 ops per causal pair per head-dim unit: 5.2e10 and 6.9e10 operations,
    # 52 and 70 us at the bf16 tensor-core rate.
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    one_product = 2.0 * 32 * (2048 * 2049 // 2) * 128
    for kernel, products, us in (("dq", 3, 52.1), ("dkv", 4, 69.5)):
        ms, by = chip_smoke.attention_bwd_bound_ms(kernel, 32, 2048, 2048,
                                                   128, True, "bfloat16", 2, 2)
        assert by == "operations"
        assert ms == pytest.approx(products * one_product / 989e12 * 1e3)
        assert ms * 1e3 == pytest.approx(us, abs=0.1)
