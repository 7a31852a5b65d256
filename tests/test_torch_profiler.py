"""The port's step-window profiler (``torchmpi_tpu_torch/utils/profiler.py``)
against the JAX package's behaviour (``tests/test_utils.py``:
``TestStepWindowProfiler``, ``TestOpBreakdown``, ``TestTimer``,
``TestDispatchLatency``): the window traces only its steps, the hooks
drive it through the engine, ``op_breakdown`` reads the trace, the timer
skips its warmup and the latency check warns past its budget."""

from __future__ import annotations

import json
import os
import time
import warnings

import pytest
import torch

from torchmpi_tpu_torch.utils import profiler as tprof


def _steps(prof, n, tag):
    x = torch.randn(32, 32)
    for t in range(n):
        with torch.profiler.record_function(f"{tag}{t}"):
            x = torch.tanh(x @ x / 32)
        prof.step(t)
    prof.stop()


def test_window_traces_only_its_steps(tmp_path):
    prof = tprof.StepWindowProfiler(logdir=str(tmp_path / "tr"),
                                    start_step=2, end_step=4, enabled=True)
    _steps(prof, 6, "mark")
    prof.stop()                                 # idempotent
    assert prof.trace_path and prof.trace_path.startswith(str(tmp_path))
    with open(prof.trace_path) as f:
        data = json.load(f)
    names = {e.get("name") for e in data["traceEvents"]}
    # step(t) follows step t's work, as the engine's on_update hook does:
    # the window opens after mark2 and closes after mark4, so it holds the
    # two steps mark3 and mark4, and none before or after.
    assert {"mark3", "mark4"} <= names
    assert not names & {"mark0", "mark1", "mark2", "mark5"}
    assert data[tprof._STEPS_KEY] == 2


def test_disabled_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_PROFILE", raising=False)
    prof = tprof.StepWindowProfiler(logdir=str(tmp_path))
    _steps(prof, 10, "m")
    assert prof.trace_path is None and not os.listdir(tmp_path)


def test_environment_switch_enables(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_PROFILE", "1")
    prof = tprof.StepWindowProfiler(logdir=str(tmp_path), start_step=1,
                                    end_step=2)
    _steps(prof, 3, "m")
    assert prof.trace_path is not None and os.path.exists(prof.trace_path)


def test_engine_hooks_drive_the_window(tmp_path):
    """profiler_hooks (composed with another hook dict) wires the window
    into the engine's hook protocol: one rank on the CPU, compiled mode."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import lifecycle
    from torchmpi_tpu_torch.utils.data import ShardedIterator, synthetic_mnist

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    prof = tprof.StepWindowProfiler(logdir=str(tmp_path / "tr"),
                                    start_step=1, end_step=3, enabled=True)
    seen = []
    hooks = tprof.compose_hooks(tprof.profiler_hooks(prof),
                                {"on_update": lambda s: seen.append(s["t"])})
    ds = synthetic_mnist(n=128, image_shape=(8, 8), n_classes=4)
    it = ShardedIterator(ds, global_batch=32, num_shards=1)
    lifecycle.start(device="cpu")
    try:
        eng = AllReduceSGDEngine(mlp.loss_fn, lr=0.1, hooks=hooks)
        eng.train(mlp.init(0, in_dim=64, hidden=(16,), n_classes=4,
                           device="cpu"), it)
    finally:
        lifecycle.stop()
    assert seen == [1, 2, 3, 4]
    assert prof.trace_path is not None
    b = tprof.op_breakdown(prof.trace_path, timeline="host")
    assert b["steps"] == 2 and b["total_ms_per_step"] > 0


def test_op_breakdown_reads_the_host_timeline(tmp_path):
    x = torch.randn(128, 128)
    with tprof.trace(str(tmp_path), steps=4):
        for _ in range(4):
            x = torch.relu(x @ x / 128)
    b = tprof.op_breakdown(str(tmp_path), timeline="host")
    assert b["steps"] == 4 and b["timeline"] == "host"
    names = [n for n, _ in b["top_ops"]]
    assert "aten::matmul" in names and "aten::relu" in names
    cats = {c for c, _, _ in b["categories"]}
    assert "matmul" in cats
    assert abs(sum(s for _, _, s in b["categories"]) - 1.0) < 1e-9
    lines = tprof.print_breakdown(str(tmp_path), timeline="host")
    assert lines[0].startswith("# 4 steps")


def test_cpu_trace_has_no_device_timeline(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the trace holds device kernels")
    with tprof.trace(str(tmp_path)):
        torch.randn(64, 64).sum()
    with pytest.raises(ValueError, match="device timeline"):
        tprof.op_breakdown(str(tmp_path))


def test_missing_trace_raises(tmp_path):
    with pytest.raises(ValueError, match="trace"):
        tprof.op_breakdown(str(tmp_path / "nope"))


@pytest.mark.parametrize("name,want", [
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>", "convolution"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128", "matmul"),
    ("Memcpy DtoD (Device -> Device)", "async DMA (copy/slice)"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective: nccl"),
    ("(anonymous namespace)::reduce_kernel(RingArgs)", "collective: ring"),
    ("(anonymous namespace)::stage_kernel(StageArgs)", "collective: ring"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp>", "reduction"),
    ("void tc::flash_fwd_wgmma<false, true>(FwdArgs)", "attention (flash)"),
    ("void at::native::max_pool_backward_nchw<float>",
     "select-and-scatter (pool bwd)"),
    ("void at::native::multi_tensor_apply_kernel<...>",
     "optimizer (foreach)"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
])
def test_categories(name, want):
    assert tprof._categorize(name) == want


def test_timer_skips_its_warmup():
    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.01)

    mean = tprof.Timer(warmup=3, runs=4).measure(fn)
    assert len(calls) == 7
    assert 0.005 < mean < 0.1


def test_fast_dispatch_passes():
    assert tprof.assert_dispatch_latency(lambda: None, budget_s=1.0,
                                         tries=3) < 1.0


def test_slow_dispatch_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tprof.assert_dispatch_latency(lambda: time.sleep(0.002),
                                      budget_s=1e-6, tries=2)
    assert any("latency" in str(x.message) for x in w)


@pytest.mark.cuda
def test_window_traces_device_kernels_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prof = tprof.StepWindowProfiler(logdir=str(tmp_path), start_step=1,
                                    end_step=3, enabled=True)
    x = torch.randn(256, 256, device="cuda")
    for t in range(4):
        x = torch.tanh(x @ x / 256)
        prof.step(t)
    prof.stop()
    b = tprof.op_breakdown(prof.trace_path)
    assert b["timeline"] == "device" and b["total_ms_per_step"] > 0
    assert "matmul" in {c for c, _, _ in b["categories"]}
    dev_ms = tprof.Timer(warmup=2, runs=5, device="cuda").measure(
        lambda: x @ x)
    assert dev_ms > 0
