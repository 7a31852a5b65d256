"""Benchmark and correctness harness for the collectives: the tester.

Counterpart of ``torchmpi_tpu/utils/tester.py`` (itself the reference's
``torchmpi/tester.lua`` with ``test/collectives_all.lua``): sweep tensor
sizes 2^8..2^23 elements with a random jitter, skip the warmup runs, check
the first size of each collective against the algebraic result of
rank-valued fills, and report GB/s on the bus through the same
per-collective volume models.

Each process is one rank and passes its own tensor, so every rank runs
the sweep together; its report lines come from rank 0.  ``impl`` picks the
implementation:

* ``"eager"``: ``collectives/eager.py`` (``torch.distributed``: NCCL with
  a card per rank, gloo otherwise, which stages a CUDA tensor through the
  host for all but allreduce and broadcast);
* ``"ring"``: ``collectives/cuda_ring.py``, the hand-written kernels at
  every size: B1 for allreduce, B2 for reduce-scatter, B3 for allgather
  (on CPU tensors their per-rank CPU form).

Timing fences (``fence``): ``"sync"`` waits for the device
(``torch.cuda.synchronize``; nothing to wait for on the CPU), ``"value"``
reads one element of the result back to the host.

:func:`mfu_sweep` is the compute side: a Llama training step over (batch,
remat), each cell's FLOPs counted by the numerics plane's probe
(``obs/numerics.probe_step_flops``) on its first warmup step and its MFU
taken against the card's bf16 peak.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..collectives import cuda_ring, eager
from ..runtime.communicator import Communicator

# Per-collective communication volume models in *bytes on the bus*, as a
# function of (elements, element_size, p); the JAX package's, which are the
# reference's (collectives_all.lua:215-457).
VOLUME_MODELS: Dict[str, Callable[[int, int, int], float]] = {
    "allreduce": lambda n, es, p: 2.0 * n * es * (p - 1) / p,
    "broadcast": lambda n, es, p: float(n * es),
    "reduce": lambda n, es, p: float(n * es),
    "sendreceive": lambda n, es, p: float(n * es),
    "allgather": lambda n, es, p: float(n * es * (p - 1)),
    "reduce_scatter": lambda n, es, p: float(n * es * (p - 1) / p),
    "alltoall": lambda n, es, p: float(n * es * (p - 1) / p),
}

# The collectives the ring kernels implement.
RING_COLLECTIVES = ("allreduce", "reduce_scatter", "allgather")
IMPLS = ("eager", "ring")
FENCES = ("sync", "value")


@dataclasses.dataclass
class BenchResult:
    collective: str
    elements: int
    dtype: str
    p: int
    mean_seconds: float
    min_seconds: float
    bus_gbs: float          # volume model / mean time
    checked: bool
    # The card's allocator high-water mark during this config's runs, and
    # only when this config raised it (the mark only grows in a process);
    # None on the CPU.
    peak_hbm_bytes: Optional[int] = None


def peak_hbm_bytes(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of ``device`` when it is a card,
    else None."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


@dataclasses.dataclass
class MFUResult:
    """One row of :func:`mfu_sweep`.  ``step_flops`` is the step's FLOPs as
    the probe counted them on a real step, ``flash_flops`` the share it
    counted for the flash-attention operators by their closed formula (0
    without ``attn="flash"``); ``mfu_estimate`` is the FLOP/s of this one
    card over its bf16 peak (None where the peak is unknown: on the CPU,
    ``numerics.device_peak_flops``).  ``first_loss`` is the loss of the
    probed step, from the fresh parameters."""
    batch: int
    seq_len: int
    remat: str
    mean_seconds: float
    min_seconds: float
    step_flops: Optional[float]
    flops_per_s: Optional[float]       # step_flops / mean_seconds
    mfu_estimate: Optional[float]      # flops_per_s / bf16 peak
    peak_hbm_bytes: Optional[int] = None
    flash_flops: Optional[float] = None
    first_loss: Optional[float] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: the seed of :func:`sweep_batch`'s token ids.
SWEEP_SEED = 0


def sweep_batch(batch: int, seq_len: int, vocab: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (tokens, targets) of a :func:`mfu_sweep` cell: ids drawn
    uniformly from the vocabulary from :data:`SWEEP_SEED` (``seq_len + 1``
    a row, the targets the tokens shifted by one).  The JAX sweep feeds
    zeros, which make every position's value row the same: attention's
    output then cannot show its weights, and the first loss checks
    nothing of them."""
    ids = torch.randint(vocab, (batch, seq_len + 1),
                        generator=torch.Generator().manual_seed(SWEEP_SEED))
    ids = ids.to(device)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def mfu_sweep(
    batch_sizes: Sequence[int] = (2, 4, 8),
    remats: Sequence[str] = ("none", "dots"),
    seq_len: int = 32,
    warmup: int = 1,
    iters: int = 3,
    mesh=None,
    cfg=None,
    report: Optional[Callable[[str], None]] = print,
    *,
    attn: str = "full",
    dtype: torch.dtype = torch.float32,
    device=None,
) -> List[MFUResult]:
    """Sweep a Llama training step (``llama.make_train_step``, plain SGD)
    over (batch, remat) and record each cell's time, FLOP/s and MFU.

    Each cell starts from fresh parameters (the step updates them in
    place).  Its first warmup step runs under the FLOP probe
    (``numerics.probe_step_flops``), which counts that step as it runs;
    the probe slows it, so it is never timed.  Then ``iters`` steps are
    timed, each ended by a device synchronize.  Peak memory is the card's
    allocator high-water mark over the cell (None on the CPU).  With
    ``mesh`` every rank passes the global batch (rounded to the dp axis)
    and the numbers are this rank's, on its one card.

    The JAX sweep's arguments come first; ``attn``, ``dtype`` and
    ``device`` (the card unless the CPU is asked for: no GPU and no
    ``device`` raises) are the port's.  The tokens are
    :func:`sweep_batch`'s."""
    import importlib

    from torch.utils.flop_counter import FlopCounterMode

    from ..models import llama
    from ..models._common import resolve_device
    from ..obs import numerics as _numerics

    fa = importlib.import_module("..ops.flash_attention", __package__)

    dev = resolve_device(device)
    cfg = cfg or llama.tiny()
    dp = mesh.shape.get("dp", 1) if mesh is not None else 1
    peak = _numerics.device_peak_flops(dev)
    results: List[MFUResult] = []
    for remat in remats:
        step = llama.make_train_step(cfg, mesh, lr=0.1, attn=attn,
                                     remat=remat)
        for b in batch_sizes:
            b_eff = max(dp, (b // dp) * dp)
            params = llama.init(0, cfg, dtype=dtype, device=dev)
            if mesh is not None:
                params = llama.shard_params(params, mesh, cfg)
            tokens, targets = sweep_batch(b_eff, seq_len, cfg.vocab, dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            # The probe (``numerics.probe_step_flops``'s counter, kept here
            # for the flash share).
            counter = FlopCounterMode(display=False)
            with counter:
                _, _, loss = step(params, None, tokens, targets)
            flops = float(counter.get_total_flops()) or None
            for _ in range(max(warmup, 1) - 1):
                step(params, None, tokens, targets)
            _sync(dev)
            times: List[float] = []
            for _ in range(iters):
                t0 = time.perf_counter()
                step(params, None, tokens, targets)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            mean_t = float(np.mean(times))
            fps = (flops / mean_t) if flops else None
            mfu = (fps / peak) if (fps and peak) else None
            r = MFUResult(
                batch=b_eff, seq_len=seq_len, remat=remat,
                mean_seconds=mean_t, min_seconds=float(np.min(times)),
                step_flops=flops, flops_per_s=fps, mfu_estimate=mfu,
                peak_hbm_bytes=peak_hbm_bytes(dev),
                flash_flops=fa.counted_flops(counter),
                first_loss=float(loss))
            results.append(r)
            del params
            if report:
                mfu_s = "     n/a" if mfu is None else f"{mfu:8.4f}"
                fps_s = ("      n/a" if fps is None
                         else f"{fps / 1e12:9.4f}")
                report(f"mfu b={b_eff:<4} L={seq_len:<4} remat={remat:<5} "
                       f"t={mean_t * 1e3:9.2f}ms tflops={fps_s} "
                       f"mfu={mfu_s}")
    return results


def _device(device) -> torch.device:
    """``device``, or the one ``lifecycle.start`` bound this rank to (no
    default to the CPU: the runtime decides, and raises unstarted)."""
    if device is not None:
        return torch.device(device)
    from ..runtime import lifecycle

    return lifecycle.device()


def _call_args(collective: str, comm: Communicator) -> dict:
    """The sweep's fixed topology: root 0; sendreceive 0 -> last rank."""
    if collective in ("broadcast", "reduce"):
        return {"root": 0}
    if collective == "sendreceive":
        return {"src": 0, "dst": comm.size - 1 if comm.size > 1 else 0}
    return {}


def run_collective(collective: str, comm: Communicator, x: torch.Tensor,
                   impl: str = "eager") -> torch.Tensor:
    """One call of ``collective`` on this rank's ``x``; an allgather gives
    ``(p, n)`` in either implementation."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if collective not in VOLUME_MODELS:
        raise ValueError(f"unknown collective {collective!r}")
    if impl == "ring":
        if collective not in RING_COLLECTIVES:
            raise ValueError(f"impl='ring' supports {RING_COLLECTIVES}, not "
                             f"{collective!r}")
        if collective == "allgather":
            return cuda_ring.ring_allgather(comm, x).view(comm.size, -1)
        fn = {"allreduce": cuda_ring.ring_allreduce,
              "reduce_scatter": cuda_ring.ring_reduce_scatter}[collective]
        return fn(comm, x)
    return getattr(eager, collective)(comm, x, **_call_args(collective,
                                                            comm))


def _expected(collective: str, comm: Communicator, n: int) -> np.ndarray:
    """This rank's result for fill = rank inputs (collectives_all.lua:
    fill = rank makes allreduce p(p-1)/2)."""
    p, r = comm.size, comm.rank
    total = p * (p - 1) / 2.0
    if collective == "allreduce":
        return np.full((n,), total)
    if collective == "broadcast":
        return np.zeros((n,))
    if collective == "reduce":
        return np.full((n,), total if r == 0 else float(r))
    if collective == "sendreceive":
        return np.full((n,), 0.0 if r == (p - 1 if p > 1 else 0)
                       else float(r))
    if collective == "allgather":
        return np.tile(np.arange(p, dtype=np.float64)[:, None], (1, n))
    if collective == "reduce_scatter":
        return np.full((n // p,), total)
    if collective == "alltoall":
        return np.repeat(np.arange(p, dtype=np.float64), n // p)
    raise ValueError(f"no correctness check for {collective!r}")


def _fill(comm: Communicator, n: int, dtype, device) -> torch.Tensor:
    return torch.full((n,), float(comm.rank), dtype=dtype, device=device)


def check_collective(collective: str, comm: Communicator, n: int,
                     impl: str = "eager", device=None) -> None:
    """First-run correctness with rank-valued fills; raises on a wrong
    result."""
    x = _fill(comm, n, torch.float32, _device(device))
    out = run_collective(collective, comm, x, impl=impl)
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               _expected(collective, comm, n), rtol=1e-5)


def _fence(out: torch.Tensor, mode: str) -> None:
    """Wait until ``out`` is computed: ``"sync"`` waits for the card,
    ``"value"`` reads one element to the host."""
    if mode == "value":
        out.reshape(-1)[0].item()
    elif mode == "sync":
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    else:
        raise ValueError(f"fence must be one of {FENCES}, got {mode!r}")


def run_one_config(collective: str, comm: Communicator, elements: int,
                   dtype=torch.float32, warmup: int = 10, iters: int = 10,
                   check: bool = True, jitter: bool = True, seed: int = 0,
                   fence: str = "sync", impl: str = "eager",
                   device=None) -> BenchResult:
    """Time one (collective, size) config (tester.lua:61-126): the warmup
    runs skipped, each timed run fenced, GB/s from the volume model.
    ``jitter`` adds the JAX tester's random offset below 128 elements, the
    same on every rank."""
    rng = np.random.RandomState(seed + elements)
    n = int(elements + (rng.randint(0, 128) if jitter else 0))
    p = comm.size
    if collective in ("reduce_scatter", "alltoall"):
        n = max(p, (n // p) * p)
    dev = _device(device)
    before = peak_hbm_bytes(dev)
    if check:
        check_collective(collective, comm, n, impl=impl, device=dev)
    x = _fill(comm, n, dtype, dev)
    for _ in range(max(warmup, 1)):
        out = run_collective(collective, comm, x, impl=impl)
    _fence(out, fence)
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run_collective(collective, comm, x, impl=impl)
        _fence(out, fence)
        times.append(time.perf_counter() - t0)
    es = torch.empty((), dtype=dtype).element_size()
    mean_t = float(np.mean(times))
    after = peak_hbm_bytes(dev)
    return BenchResult(
        collective=collective, elements=n, dtype=str(dtype).split(".")[-1],
        p=p, mean_seconds=mean_t, min_seconds=float(np.min(times)),
        bus_gbs=VOLUME_MODELS[collective](n, es, p) / mean_t / 1e9,
        checked=check,
        peak_hbm_bytes=(after if after is not None and (
            before is None or after > before) else None))


def sweep(comm: Communicator,
          collectives: Sequence[str] = ("allreduce", "broadcast",
                                        "allgather"),
          min_pow: int = 8, max_pow: int = 23, dtype=torch.float32,
          warmup: int = 10, iters: int = 10, check_first: bool = True,
          report: Optional[Callable[[str], None]] = print,
          fence: str = "sync", impl: str = "eager",
          device=None) -> List[BenchResult]:
    """Size sweep 2^min_pow..2^max_pow (collectives_all.lua:554-598), the
    first size of each collective checked; ``report`` gets rank 0's
    lines."""
    results: List[BenchResult] = []
    for coll in collectives:
        for po in range(min_pow, max_pow + 1):
            r = run_one_config(coll, comm, 1 << po, dtype=dtype,
                               warmup=warmup, iters=iters,
                               check=check_first and po == min_pow,
                               fence=fence, impl=impl, device=device)
            results.append(r)
            if report and comm.rank == 0:
                mem = ("" if r.peak_hbm_bytes is None
                       else f" hbm={r.peak_hbm_bytes / 1e6:8.1f} MB")
                report(f"{coll:>14} n=2^{po:<2} ({r.elements:>8}) p={r.p} "
                       f"t={r.mean_seconds * 1e6:9.1f}us "
                       f"bus={r.bus_gbs:8.3f} GB/s{mem}")
    return results
