"""The port's 3x3 convolution op (``ops/conv3x3.py``) against the JAX
benchmark's ``pallas_conv3x3`` and ``xla_conv3x3``.

The JAX kernel runs in interpret mode on the CPU, loaded from
``benchmarks/pallas_conv_bench.py``, at that script's ``--check`` geometry
for both of its shapes: x ``(8, H, W, 64)`` with H = W = 7 and 14, w
``(3, 3, 64, 128)``, ``bn=4``, ``bc=128``, f32, inputs from
``numpy.random.RandomState(0)``.  Tolerance 2e-4 (relative and absolute),
the script's own: both sides sum the nine taps' f32 products in another
order.  In bf16 the two agree to one bf16 ulp at the output's scale: both
widen to f32 and round once on store, so only a sum that lands next to a
rounding boundary may round the other way.
"""

from __future__ import annotations

import importlib
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

# The package exports the function under the module's name.
tconv = importlib.import_module("torchmpi_tpu_torch.ops.conv3x3")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_bench", ROOT / "benchmarks" / "pallas_conv_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_inputs():
    """The script's --check inputs, both shapes, in its order."""
    rng = np.random.RandomState(0)
    out = []
    for h in (7, 14):
        x = rng.randn(8, h, h, 64).astype(np.float32)
        w = (rng.randn(3, 3, 64, 128) * 0.1).astype(np.float32)
        out.append((x, w))
    return out


@pytest.mark.parametrize("shape", [0, 1], ids=["7x7", "14x14"])
def test_plain_matches_the_pallas_kernel_and_xla(bench, shape):
    import jax.numpy as jnp

    x, w = _check_inputs()[shape]
    got = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), bn=4,
                        bc=128).numpy()
    pallas = np.asarray(bench.pallas_conv3x3(
        jnp.asarray(x), jnp.asarray(w), bn=4, bc=128, interpret=True))
    xla = np.asarray(bench.xla_conv3x3(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == pallas.shape == (8, x.shape[1], x.shape[2], 128)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)


def test_bf16_within_one_ulp_of_the_pallas_kernel(bench):
    import jax.numpy as jnp

    x, w = _check_inputs()[0]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = tconv.conv3x3(xb, wb, bn=4, bc=128)
    assert got.dtype == torch.bfloat16
    want = np.asarray(bench.pallas_conv3x3(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16), bn=4, bc=128,
        interpret=True)).astype(np.float32)
    ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


@pytest.mark.parametrize("n,cout,bn,bc", [(8, 128, 3, 128), (8, 128, 4, 96),
                                          (6, 256, 4, 256)])
def test_bn_and_bc_must_divide_like_jax(bench, n, cout, bn, bc):
    import jax.numpy as jnp

    x = np.zeros((n, 7, 7, 16), np.float32)
    w = np.zeros((3, 3, 16, cout), np.float32)
    with pytest.raises(ValueError) as jerr:
        bench.pallas_conv3x3(jnp.asarray(x), jnp.asarray(w), bn=bn, bc=bc,
                             interpret=True)
    with pytest.raises(ValueError) as terr:
        tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), bn=bn, bc=bc)
    assert str(terr.value) == str(jerr.value)


def test_wrong_filter_shape_raises():
    with pytest.raises(ValueError, match=r"\(3, 3, C, Cout\)"):
        tconv.conv3x3(torch.zeros(8, 7, 7, 16), torch.zeros(3, 3, 8, 256))


def test_forward_only_refuses_a_gradient():
    x = torch.zeros(8, 7, 7, 16, requires_grad=True)
    w = torch.zeros(3, 3, 16, 256)
    with pytest.raises(RuntimeError, match="forward-only"):
        tconv.conv3x3(x, w)
    with torch.no_grad():
        assert tconv.conv3x3(x, w).shape == (8, 7, 7, 256)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = tconv.conv3x3_launches
    x, w = _check_inputs()[0]
    out = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), bn=4,
                        bc=128)
    assert torch.equal(out, tconv.conv3x3_plain(torch.from_numpy(x),
                                                torch.from_numpy(w)))
    assert tconv.conv3x3_launches == before


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(tconv, "conv3x3_plain",
                        lambda *a: called.append(1))
    x = torch.zeros(8, 7, 7, 16, device="meta")
    w = torch.zeros(3, 3, 16, 256, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tconv.conv3x3(x, w)
    assert not called


def _rounded_product(a, b, form):
    """``a @ b`` in the tensor cores' arithmetic, in f32 PyTorch:
    ``"split3"`` A_hi B_hi + A_hi B_lo + A_lo B_hi from bf16 hi + lo parts
    (each product exact in f32), ``"bf16"`` or ``"tf32"`` one product of
    the rounded operands (TF32: 10 significand bits, ties away)."""
    def parts(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()

    if form == "split3":
        (ah, al), (bh, bl) = parts(a), parts(b)
        return ah @ bh + ah @ bl + al @ bh
    if form == "tf32":
        def r(x):
            return ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(
                torch.float32)
    else:
        def r(x):
            return x.bfloat16().float()
    return r(a) @ r(b)


@pytest.mark.parametrize("form,fits", [("split3", True), ("bf16", False),
                                       ("tf32", False)])
def test_f32_inputs_need_three_bf16_products(form, fits):
    # Why the f32 kernel forms each chunk's product as three bf16
    # products: at C = Cout = 64 (K = 576) over 200 pixels, the
    # three-product form stays inside chip_smoke.py's f32 tolerance (1e-5
    # of the output's scale; ~0.4 of it), where one bf16 product (~200x
    # over) or one TF32 product (~30x over) does not.
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 10, 10, 64).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, 64, 64) / 24.0).astype(np.float32))
    ref = tconv.conv3x3_plain(x, w)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    got = torch.zeros(200, 64)
    for tap in range(9):
        win = xp[:, tap // 3:tap // 3 + 10, tap % 3:tap % 3 + 10]
        got += _rounded_product(win.reshape(200, 64), w[tap // 3, tap % 3],
                                form)
    worst = float((got.reshape(ref.shape) - ref).abs().max()) / (
        1e-5 * float(ref.abs().max()))
    assert (worst <= 0.75) if fits else (worst > 5.0), worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(16, 7, 7, 512, 512),
                                   (8, 14, 14, 256, 256),
                                   (8, 5, 9, 40, 72),
                                   (3, 5, 9, 72, 40),
                                   (2, 6, 7, 13, 20)],
                         ids=["7x7x512", "14x14x256", "ragged", "ragged_tiles",
                              "c13"])
def test_kernel_matches_plain_version_on_the_card(dtype, shape):
    # The CUDA kernel exists only on the card; chip_smoke.py runs the same
    # comparison at the bench's full batch of 128.  bf16 runs the
    # tensor-core kernel in one product a chunk, f32 in three from its
    # split (one split launch for x and w): "ragged_tiles" has N*H*W, C and
    # Cout off its 128 x 128 tile and 64-channel chunk, "c13" a C and a
    # Cout that are not multiples of 8 (its masked element loads; the
    # split's element-by-element path).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, wd, c, cout = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, h, wd, c), generator=g, device="cuda").to(dt)
    w = (torch.randn((3, 3, c, cout), generator=g, device="cuda")
         * 0.05).to(dt)
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")
    before = (tconv.conv3x3_launches, split.bf16_split_launches)
    got = tconv.conv3x3(x, w, bn=n, bc=cout)
    assert (tconv.conv3x3_launches, split.bf16_split_launches) == (
        before[0] + 1, before[1] + (dtype == "float32"))
    assert got.dtype == dt
    want = tconv.conv3x3_plain(x, w)
    scale = float(want.float().abs().max())
    # f32: summation order only.  bf16: one ulp at the output's scale.
    atol = 1e-5 * scale if dtype == "float32" else \
        2.0 ** (math.floor(math.log2(scale)) - 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
