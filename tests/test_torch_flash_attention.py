"""Parity of the port's flash-attention forward with the JAX package's.

Both sides get the same inputs, made with numpy from a seed.  The JAX side
runs its Pallas kernel in interpret mode (automatic off-TPU); the port's
side runs on CPU tensors, i.e. the plain PyTorch version of its CUDA
kernel (the kernel itself is held against that plain version on the card
by chip_smoke.py).  Both compute in f32, so the tolerance is f32 summation
order: rtol 1e-4, atol 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

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


def test_gradient_raises_until_the_training_slice():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(3, (1, 32, 2, 16)))
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q, k, v, causal=True)


def test_plain_version_does_not_count_as_a_launch():
    before = tfa.flash_fwd_launches
    q, k, v = (_t(a) for a in _qkv(4, (2, 32, 16)))
    tfa.flash_fwd_block(q, k, v, causal=True)
    assert tfa.flash_fwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,lq,lk", [
    ("bfloat16", True, 256, 256), ("float32", True, 256, 256),
    ("bfloat16", False, 128, 384), ("float32", False, 100, 300)])
def test_kernel_matches_plain_version_on_the_card(dtype, causal, lq, lk):
    # The CUDA kernel exists only on the card; chip_smoke.py runs the same
    # comparison at the generate path's full shape.
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
    # f32: summation order only.  bf16 output: one last-place flip.
    tol = dict(rtol=0, atol=2e-4) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(o.float(), po.float(), **tol)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


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
