"""Profiling: steady-state step-window traces, and what they hold.

Counterpart of ``torchmpi_tpu/utils/profiler.py``.  The reference brackets
steps 3..8 of training with cudaProfilerStart/Stop so a trace covers a
steady-state window (``torchmpi/engine/sgdengine.lua:38-63``); here
:class:`StepWindowProfiler` runs ``torch.profiler`` (CPU activity, and CUDA
on a card) around the same window and writes a Chrome trace of it.  Also
the bench-timer discipline (warmup-skipping :class:`Timer`, CUDA events on
the card) and the async dispatch-latency check (under 50 us in the
reference, ``collectives_all.lua:192-199``).

:func:`op_breakdown` reads such a trace: the device kernels (or, with
``timeline="host"``, the host's aten ops) summed by name and by category
per step, in the JAX module's categories where they apply.  The JAX
module's XLA trace format has no counterpart.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

_STEPS_KEY = "tmpi_steps"


def default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "torchmpi_tpu_torch_trace")


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_file(logdir: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                                f"{os.getpid()}_{time.monotonic_ns()}.json")


class StepWindowProfiler:
    """Trace steps ``[start_step, end_step)`` of a training loop.

    Call :meth:`step` once per iteration (or install it into the engine
    with :func:`profiler_hooks`).  Idempotent after the window.  Enabled by
    ``enabled=True`` or the environment variable ``TPU_PROFILE=1`` (the
    JAX package's switch).  ``trace_path`` names the Chrome trace written.

    Starting and stopping ``torch.profiler`` can take seconds (the first
    start loads CUPTI).  Where one rank profiles and its peers meet it in
    the ring collectives, which give up after ``RING_TIMEOUT_S``, fence the
    window's edges with a barrier on every rank (``chip_smoke.py``'s
    options phase does)."""

    def __init__(self, logdir: Optional[str] = None, start_step: int = 3,
                 end_step: int = 8, enabled: Optional[bool] = None):
        self.logdir = logdir if logdir is not None else default_logdir()
        self.start_step = start_step
        self.end_step = end_step
        self.enabled = (bool(int(os.environ.get("TPU_PROFILE", "0")))
                        if enabled is None else enabled)
        self._prof = None
        self._t0_ns: Optional[int] = None
        self.trace_path: Optional[str] = None

    def step(self, t: int) -> None:
        if not self.enabled:
            return
        if t == self.start_step and self._prof is None:
            from torch.profiler import profile

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof = profile(activities=_activities())
            self._prof.__enter__()
            self._t0_ns = time.monotonic_ns()
        elif t >= self.end_step and self._prof is not None:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.add_metadata_json(_STEPS_KEY,
                               str(self.end_step - self.start_step))
        prof.__exit__(None, None, None)
        self.trace_path = _trace_file(self.logdir)
        prof.export_chrome_trace(self.trace_path)
        # The window registers as an observability span (a no-op with
        # obs_trace off), so the span timeline shows which steps it covers.
        from ..obs import tracer as _tracer

        if self._t0_ns is not None and _tracer.enabled():
            _tracer.record("profiler.window", self._t0_ns,
                           time.monotonic_ns(), _tracer.current_correlation(),
                           trace_path=self.trace_path,
                           start_step=self.start_step,
                           end_step=self.end_step)
        self._t0_ns = None


def profiler_hooks(profiler: StepWindowProfiler) -> Dict[str, Callable]:
    """Engine hooks installing the window (the reference engine's NVPROF
    hooks, sgdengine.lua:38-63); merge with others by
    :func:`compose_hooks`."""
    return {
        "on_update": lambda state: profiler.step(state["t"]),
        "on_end": lambda state: profiler.stop(),
    }


def compose_hooks(*hook_dicts: Dict[str, Callable]) -> Dict[str, Callable]:
    """Merge engine hook dicts: for each hook name, every contributor runs
    in argument order."""
    merged: Dict[str, list] = {}
    for hooks in hook_dicts:
        for name, fn in hooks.items():
            merged.setdefault(name, []).append(fn)

    def _chain(fns):
        def run(state):
            for fn in fns:
                fn(state)
        return run

    return {name: _chain(fns) for name, fns in merged.items()}


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, steps: int = 1):
    """A trace of the block (``steps`` is what :func:`op_breakdown`
    divides by); yields the logdir the trace is written to on exit."""
    from torch.profiler import profile

    logdir = logdir if logdir is not None else default_logdir()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof = profile(activities=_activities())
    prof.__enter__()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.add_metadata_json(_STEPS_KEY, str(steps))
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(_trace_file(logdir))


class Timer:
    """Warmup-skipping timer (tester.lua:61-126): the warmup calls are
    discarded, the timed ones averaged.  With ``device`` a card, the runs
    are timed with CUDA events on its current stream, else on the host's
    clock (``fn`` must then block on its own completion)."""

    def __init__(self, warmup: int = 10, runs: int = 10, device=None):
        self.warmup = warmup
        self.runs = runs
        self.device = device

    def measure(self, fn: Callable[[], Any]) -> float:
        """Mean seconds per call of ``fn``."""
        for _ in range(self.warmup):
            fn()
        if self.device is not None and torch.device(self.device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.runs):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / self.runs
        t0 = time.perf_counter()
        for _ in range(self.runs):
            fn()
        return (time.perf_counter() - t0) / self.runs


def assert_dispatch_latency(fn: Callable[[], Any], budget_s: float = 5e-5,
                            tries: int = 20) -> float:
    """Best observed dispatch latency of ``fn`` (which must not block);
    warns past ``budget_s``, the reference's 50 us launch assertion
    (collectives_all.lua:192-199).  Returns the best latency."""
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    if best > budget_s:
        import warnings

        warnings.warn(f"async dispatch latency {best * 1e6:.1f}us exceeds "
                      f"budget {budget_s * 1e6:.0f}us")
    return best


# -------------------------------------------------------- trace analysis

def _categorize(name: str) -> str:
    """Heuristic category of a kernel or an aten op, by name; the JAX
    module's categories where they apply."""
    n = name.lower()
    if n.startswith("memcpy") or n.startswith("memset") or "aten::copy_" in n:
        return "async DMA (copy/slice)"
    if "nccl" in n:
        return "collective: nccl"
    if re.search(r"\b(stage|gather)_kernel\b", n) or (
            "reduce_kernel" in n and "at::native" not in n):
        return "collective: ring"
    if "flash_" in n:
        return "attention (flash)"
    if "max_pool" in n and "backward" in n:
        return "select-and-scatter (pool bwd)"
    if "max_pool" in n:
        return "reduce-window (pool fwd)"
    if ("conv" in n or "cudnn" in n or "implicit_gemm" in n or "fprop" in n
            or "dgrad" in n or "wgrad" in n):
        return "convolution"
    if "gemm" in n or "aten::mm" in n or "aten::addmm" in n or "matmul" in n:
        return "matmul"
    if "multi_tensor_apply" in n or "_foreach_" in n:
        return "optimizer (foreach)"
    if "batch_norm" in n:
        return "batch norm"
    if "softmax" in n:
        return "softmax"
    if "reduce_kernel" in n or "aten::sum" in n or "aten::mean" in n:
        return "reduction"
    if "elementwise" in n or n.startswith("aten::"):
        return "elementwise"
    return name[:40]


def _load(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        files = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
        if not files:
            raise ValueError(f"no trace (.json) under {path!r} -- did the "
                             f"trace block run?")
        path = max(files, key=os.path.getmtime)
    if not os.path.exists(path):
        raise ValueError(f"no trace at {path!r} -- did the trace block run?")
    with open(path) as f:
        return json.load(f)


def op_breakdown(trace_path: str, top: int = 25,
                 timeline: str = "device") -> Dict[str, Any]:
    """Sum a trace's events by name and by category, per step.

    ``trace_path``: a Chrome trace a :class:`StepWindowProfiler` or
    :func:`trace` wrote, or a directory (its newest trace).  ``timeline``
    ``"device"`` reads the card's kernels, memcpys and memsets, and raises
    a ``ValueError`` on a trace without them (a CPU run's); ``"host"``
    reads the host's top-level aten ops.  Returns::

        {"steps": int, "timeline": str, "total_ms_per_step": float,
         "categories": [(name, ms_per_step, share), ...],
         "top_ops": [(name, ms_per_step), ...]}"""
    if timeline not in ("device", "host"):
        raise ValueError("timeline must be 'device' or 'host'")
    data = _load(trace_path)
    steps = max(1, int(data.get(_STEPS_KEY, 1)))
    per_op: collections.Counter = collections.Counter()
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    if timeline == "device":
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                per_op[e["name"]] += float(e.get("dur", 0.0))
        if not per_op:
            raise ValueError(
                "trace has no device timeline (no CUDA kernels: a CPU run "
                "records only host ops) -- capture on a card, or read "
                "timeline='host'")
    else:
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                     key=lambda e: (e.get("tid"), e["ts"], -e.get("dur", 0)))
        end_by_tid: Dict[Any, float] = {}
        for e in ops:          # top-level ops only: children nest inside
            tid = e.get("tid")
            if e["ts"] >= end_by_tid.get(tid, float("-inf")):
                per_op[e["name"]] += float(e.get("dur", 0.0))
                end_by_tid[tid] = e["ts"] + e.get("dur", 0.0)
        if not per_op:
            raise ValueError("trace has no host ops")
    cats: collections.Counter = collections.Counter()
    for name, us in per_op.items():
        cats[_categorize(name)] += us
    total = sum(per_op.values())
    return {
        "steps": steps, "timeline": timeline,
        "total_ms_per_step": total / 1e3 / steps,
        "categories": [(c, us / 1e3 / steps, us / total)
                       for c, us in cats.most_common()],
        "top_ops": [(n, us / 1e3 / steps)
                    for n, us in per_op.most_common(top)],
    }


def print_breakdown(trace_path: str, top: int = 15,
                    timeline: str = "device") -> List[str]:
    """Print :func:`op_breakdown`'s categories and top ops; returns the
    lines."""
    b = op_breakdown(trace_path, top=top, timeline=timeline)
    lines = [f"# {b['steps']} steps, {b['total_ms_per_step']:.3f} ms/step "
             f"on the {b['timeline']} timeline"]
    lines += [f"{ms:9.3f} ms/step {100 * share:5.1f}%  {c}"
              for c, ms, share in b["categories"] if share >= 0.002]
    lines.append("# top ops:")
    lines += [f"{ms:9.3f} ms/step  {n[:100]}" for n, ms in b["top_ops"][:top]]
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":  # python -m torchmpi_tpu_torch.utils.profiler T
    import sys

    print_breakdown(sys.argv[1] if len(sys.argv) > 1 else default_logdir(),
                    timeline=sys.argv[2] if len(sys.argv) > 2 else "device")
