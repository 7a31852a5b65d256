#!/usr/bin/env python3
"""Drive the PyTorch port (torchmpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: requires CUDA; prints the card; turns TF32 off for matmuls and
   convolutions, so f32 means f32.
2. build: builds every kernel source under torchmpi_tpu_torch/ops/csrc with
   nvcc, one compiler for each source, all started together, and prints
   the build time.
3. kernel: the flash-attention forward kernel (B4) against its plain
   PyTorch version at the training and generate paths' shape (B=1, H=32,
   L=2048, D=128, causal) in bf16 and f32, plus a non-causal, an Lk != Lq
   (f32 out) and a ragged case; then the backward kernels, dq (B5) and
   dk/dv (B6), against theirs in the same five cases (the Lk != Lq one
   through flash_bwd_block with an external lse and delta).  Each max
   error is printed beside its tolerance, with the kernel's, the plain
   version's and a PyTorch library call's time (scaled_dot_product_attention
   forward, and its backward; a yardstick only, the port never calls it)
   beside the card's bound.
4. generate: make_generate_fn at Llama-3-8B width, bf16 weights from a
   seeded torch.Generator, B=1, a 2048-token prompt, 16 new tokens,
   greedy; the prefill must launch the forward kernel once per layer.  The
   prefill logits through the kernel are held against full attention.
5. serve: ServeEngine over a LlamaRunner at the same width, f32 weights,
   4 slots, max_len 2048, four requests of 37, 300, 700 and 1500 prompt
   tokens and 16 new tokens each, single-stepped through iteration() until
   every request is done; the shortest is held against make_generate_fn.
6. train: make_train_step at Llama-3-8B width, bf16 weights from a seeded
   torch.Generator, B=1, L=2048, attn="flash", remat="dots",
   loss_chunk=512, plain SGD for 4 steps on one repeated batch of the
   synthetic Markov corpus.  Every loss must be finite and the fourth lower
   than the first; each step must launch dq and dk/dv once per layer and
   the forward as often as the remat mode implies (twice per layer under
   "dots": once in the forward, once when the backward recomputes the
   layer); step 1's loss is held against full attention's.

7. ring_kernels: the ring allreduce (B1), reduce-scatter (B2) and
   allgather (B3) kernels with p = 2 and p = 4 ranks spawned on the one
   card (``tools/ring_bench.py``): f32 and bf16 (and int32 for B1) at n =
   25,557,032, 3,000 and 5, the small sizes again with 64 KiB sub-chunks and
   one staging slot, and B1 once more at the 43 ring sizes of a ResNet-50
   training step (f32, mean, the engine's collective ids), each rank's
   result held against the plain schedule bit for bit; kernel, plain and
   library (gloo on the same tensors) times at n = 25,557,032 in f32 and
   for the 43 rings of a step; the public collectives driven once through
   the selector at n = 25,557,032 (the ``collectives`` path); two forced
   stalls (a rank that never enters, and one that enters after its
   neighbour gave up) that must raise within their deadline without
   lowering the aborted rank's flag words.
8. train_resnet: ResNet-50 at full width (224x224x3, 1000 classes, f32, TF32
   off) trained data-parallel by AllReduceSGDEngine in ``compiled`` mode
   with ``use_pallas_collectives`` on, 2 ranks spawned on the one card, 32
   images per rank, lr 0.1, 5 steps on one repeated batch of synthetic
   images: every step must launch B1 exactly 43 times on each rank and B2/B3
   never, every ring of step 1 must equal the plain schedule over both
   ranks' gradients (gathered over gloo) bit for bit, the loss must be
   finite and fall from step 1 to step 5, and ``check_with_allreduce`` must
   find the replicas' parameters bitwise equal; then one ``eager_sync`` step
   and an inference-mode evaluation.

Then a line with the card's name and power limit, a ``kernels`` JSON line,
and last ``{"ok": true, "device": {...}}``.  ``--layers`` cuts the depth of
phases 4-6 to no fewer than 8 layers (never the width); a cut is printed.
Exits non-zero and prints no result when no GPU is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# name -> (source, the TPU kernel it replaces, its function there, the
# PyTorch call timed as library_ms)
SDPA_BWD = "scaled_dot_product_attention backward (dq, dk and dv in one call)"
KERNELS = {
    "flash_attention_fwd": (
        "torchmpi_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "torchmpi_tpu/ops/flash_attention.py:36", "_attn_kernel",
        "scaled_dot_product_attention forward"),
    "flash_attention_bwd_dq": (
        "torchmpi_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "torchmpi_tpu/ops/flash_attention.py:140", "_attn_bwd_dq_kernel",
        SDPA_BWD),
    "flash_attention_bwd_dkv": (
        "torchmpi_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "torchmpi_tpu/ops/flash_attention.py:183", "_attn_bwd_dkv_kernel",
        SDPA_BWD),
}
# The training phase: SGD learning rate, and forward launches per layer and
# step that each remat mode implies (a checkpointed layer runs its forward
# again in the backward).
TRAIN_LR = 1.0
TRAIN_REMAT = "dots"
FWD_PER_LAYER = {"none": 1, "dots": 2, "full": 2}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 no TF32


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


# The ring kernels: name -> (source, the TPU kernel it replaces, its
# function there, the cuda_ring counter, the library call timed beside it).
RING_SRC = "torchmpi_tpu_torch/ops/csrc/ring.cu"
RING_KERNELS = {
    "ring_allreduce": ("torchmpi_tpu/collectives/pallas_ring.py:194",
                       "_ar_kernel", "allreduce",
                       "torch.distributed.all_reduce (gloo)"),
    "ring_reduce_scatter": ("torchmpi_tpu/collectives/pallas_ring.py:165",
                            "_rs_kernel", "reduce_scatter",
                            "torch.distributed.all_reduce (gloo) and a slice"),
    "ring_allgather": ("torchmpi_tpu/collectives/pallas_ring.py:241",
                       "_ag_kernel", "allgather",
                       "torch.distributed.all_gather (gloo, via the host)"),
}
RESNET_STEPS, RESNET_BATCH, RESNET_LR, RESNET_RINGS = 5, 32, 0.1, 43
# The ring kernels' design on one card (ops/csrc/ring.cu, chosen by
# tools/ring_probe.py): the ranks' contexts are time-sliced, so each ring
# step is a send and an add (or store) kernel ordered across processes by
# stream waits on monotone flag words, not one kernel spinning on flags.
RING_DESIGN = ("two kernels per ring step (send into the neighbour's "
               "cudaIpc slot; add or store), ordered across processes by "
               "cuStreamWaitValue64 on monotone data/credit words")

COUNTERS = {"flash_attention_fwd": "flash_fwd_launches",
            "flash_attention_bwd_dq": "flash_bwd_dq_launches",
            "flash_attention_bwd_dkv": "flash_bwd_dkv_launches"}


def reset_counts(fa) -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for attr in COUNTERS.values():
        setattr(fa, attr, 0)


def read_counts(fa) -> dict:
    """Every kernel's launch count, by kernel name."""
    return {name: getattr(fa, attr) for name, attr in COUNTERS.items()}


def cuda_ms(torch, fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def causal_pairs(lq: int, lk: int, causal: bool) -> int:
    """(q, k) pairs a mask keeps: all of them, or row >= col."""
    if causal:
        return sum(min(lk, i + 1) for i in range(lq))
    return lq * lk


def bound_ms(ops: float, nbytes: float, in_dtype: str):
    """The larger of ops over the input type's peak and bytes over the HBM
    rate, with the one that bounds."""
    t_ops = ops / PEAK_OPS_PER_S[in_dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def attention_bound_ms(bh, lq, lk, d, causal, in_dtype, in_bytes, out_bytes):
    """Least time for the attention forward on this card: the larger of its
    bytes (q, k, v read once, o and lse written once) over HBM rate and its
    multiply-adds (the (q, k) pairs this causal mask keeps) over the peak
    rate of the input type."""
    ops = 4.0 * bh * causal_pairs(lq, lk, causal) * d   # q.k and p.v
    nbytes = bh * (lq * d * in_bytes + 2 * lk * d * in_bytes
                   + lq * d * out_bytes + lq * 4)
    return bound_ms(ops, nbytes, in_dtype)


def attention_bwd_bound_ms(kernel, bh, lq, lk, d, causal, in_dtype, in_bytes,
                           out_bytes):
    """Least time for one backward pass: ``"dq"`` does three products over
    the kept pairs (s, dp, dq) and writes dq; ``"dkv"`` four (s, dp, dv,
    dk) and writes dk and dv.  Both read q, k, v, do once and lse and
    delta (f32) once."""
    products, out_rows = {"dq": (3, lq), "dkv": (4, 2 * lk)}[kernel]
    ops = 2.0 * products * bh * causal_pairs(lq, lk, causal) * d
    nbytes = bh * ((2 * lq + 2 * lk) * d * in_bytes + 2 * lq * 4
                   + out_rows * d * out_bytes)
    return bound_ms(ops, nbytes, in_dtype)


def phase_kernel(torch, fa):
    """Kernel against its plain version; returns the main-shape record."""
    g = torch.Generator(device="cuda").manual_seed(0)
    # (name, BH, Lq, Lk, causal, in dtype, out dtype, o atol, o rtol).
    # f32: same f32 products, different summation order: 2e-4 abs.
    # bf16 out: both sides compute in f32 and round once to bf16, where a
    # last-place flip is 2^-7 relative: 1e-2 abs + 1e-2 rel.
    # lse is f32 on both sides, log of a sum of <= 2048 terms: 1e-3 abs.
    cases = [
        ("main_bf16", 32, 2048, 2048, True, torch.bfloat16, None, 1e-2, 1e-2),
        ("main_f32", 32, 2048, 2048, True, torch.float32, None, 2e-4, 0.0),
        ("noncausal_bf16", 8, 1024, 1024, False, torch.bfloat16, None,
         1e-2, 1e-2),
        ("lk_ne_lq_f32out", 32, 512, 2048, True, torch.bfloat16,
         torch.float32, 2e-4, 0.0),
        ("ragged_f32", 4, 100, 300, False, torch.float32, None, 2e-4, 0.0),
    ]
    records = {}
    for name, bh, lq, lk, causal, dt, odt, atol, rtol in cases:
        q = torch.randn((bh, lq, 128), generator=g, device="cuda").to(dt)
        k = torch.randn((bh, lk, 128), generator=g, device="cuda").to(dt)
        v = torch.randn((bh, lk, 128), generator=g, device="cuda").to(dt)
        odt = odt or dt
        bq, bk = fa._resolve_blocks(lq, lk, None, None)
        scale = 1.0 / math.sqrt(128)

        def kern():
            return fa._flash_bh_kernel(q, k, v, causal=causal, scale=scale,
                                       out_dtype=odt)

        def plain():
            return fa._flash_bh_plain(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk, scale=scale, out_dtype=odt)

        o, lse = kern()
        torch.cuda.synchronize()
        po, plse = plain()
        diff = (o.float() - po.float()).abs()
        o_err = float(diff.max())
        o_ok = bool((diff <= atol + rtol * po.float().abs()).all())
        lse_err = float((lse - plse).abs().max())
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        rec = {"case": name, "bh": bh, "lq": lq, "lk": lk, "causal": causal,
               "dtype": str(dt).split(".")[-1],
               "out_dtype": str(odt).split(".")[-1],
               "o_max_abs_err": o_err, "o_atol": atol, "o_rtol": rtol,
               "lse_max_abs_err": lse_err, "lse_atol": 1e-3,
               "finite": finite}
        if name.startswith("main"):
            rec["kernel_ms"] = cuda_ms(torch, kern)
            rec["plain_ms"] = cuda_ms(torch, plain, warmup=1, iters=3)
            qs, ks, vs = (x.view(1, bh, -1, 128) for x in (q, k, v))
            rec["library_ms"] = cuda_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal))
            esize = torch.tensor([], dtype=dt).element_size()
            rec["bound_ms"], rec["bound_by"] = attention_bound_ms(
                bh, lq, lk, 128, causal, rec["dtype"], esize,
                torch.tensor([], dtype=odt).element_size())
        emit(phase="kernel", **rec)
        if not (o_ok and lse_err <= 1e-3 and finite):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"in case {name}: {rec}")
        records[name] = rec
        del q, k, v, o, lse, po, plse, diff
    torch.cuda.empty_cache()
    return records


def phase_kernel_bwd(torch, fa):
    """The dq (B5) and dk/dv (B6) kernels against their plain versions;
    returns the records by case, each with a ``dq`` and a ``dkv`` part."""
    g = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, BH, Lq, Lk, causal, in dtype, out dtype, atol, rtol, block op).
    # f32 out: the same f32 products summed in another order; each gradient
    # entry sums up to 2048 terms (ds k, ds q, p do) of size up to ~1 with
    # cancellation, so 5e-4 abs + 1e-3 rel.
    # bf16 out: both sides compute in f32 and round once to bf16, where a
    # last-place flip is 2^-8 relative: 1e-2 abs + 1e-2 rel.
    cases = [
        ("main_bf16", 32, 2048, 2048, True, bf16, None, 1e-2, 1e-2, False),
        ("main_f32", 32, 2048, 2048, True, f32, None, 5e-4, 1e-3, False),
        ("noncausal_bf16", 8, 1024, 1024, False, bf16, None, 1e-2, 1e-2,
         False),
        ("block_lk_ne_lq_f32out", 32, 512, 2048, True, bf16, f32, 5e-4,
         1e-3, True),
        ("ragged_f32", 4, 100, 300, True, f32, None, 5e-4, 1e-3, False),
    ]
    records = {}
    for name, bh, lq, lk, causal, dt, odt, atol, rtol, block in cases:
        q, do = (torch.randn((bh, lq, 128), generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn((bh, lk, 128), generator=g, device="cuda").to(dt)
                for _ in range(2))
        odt = odt or dt
        scale = 1.0 / math.sqrt(128)
        o, lse = fa._flash_bh_kernel(q, k, v, causal=causal, scale=scale,
                                     out_dtype=dt)
        if block:
            # As a ring caller hands them in: the lse of a combination with
            # a second chunk of equal mass, and some other output's delta.
            lse = lse + math.log(2.0)
            delta = torch.randn((bh, lq, 1), generator=g, device="cuda")
        else:
            delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
        bq, bk = fa._resolve_blocks(lq, lk, None, None)
        args = (q, k, v, do, lse, delta)
        kw = dict(causal=causal, scale=scale, out_dtype=odt)
        pkw = dict(kw, block_q=bq, block_k=bk)
        fns = {
            "dq": (lambda: fa._flash_bh_bwd_dq_kernel(*args, **kw),
                   lambda: fa._flash_bh_bwd_dq_plain(*args, **pkw)),
            "dkv": (lambda: fa._flash_bh_bwd_dkv_kernel(*args, **kw),
                    lambda: fa._flash_bh_bwd_dkv_plain(*args, **pkw)),
        }
        if block:
            got = fa.flash_bwd_block(*args, causal=causal, out_dtype=odt)
        else:
            got = (fns["dq"][0](), *fns["dkv"][0]())
        torch.cuda.synchronize()
        ref = (fns["dq"][1](), *fns["dkv"][1]())
        errs, ok = {}, True
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            diff = (a.float() - b.float()).abs()
            errs[gname] = float(diff.max())
            ok = ok and bool((diff <= atol + rtol * b.float().abs()).all()) \
                and bool(torch.isfinite(a.float()).all()) and a.dtype == odt
        rec = {"case": name, "bh": bh, "lq": lq, "lk": lk, "causal": causal,
               "dtype": str(dt).split(".")[-1],
               "out_dtype": str(odt).split(".")[-1], "block_op": block,
               **{f"{k}_max_abs_err": e for k, e in errs.items()},
               "atol": atol, "rtol": rtol}
        if name.startswith("main"):
            esize = q.element_size()
            osize = torch.tensor([], dtype=odt).element_size()
            # The library yardstick: scaled_dot_product_attention's
            # backward, which computes dq, dk and dv in one call.
            qs, ks, vs = (x.view(1, bh, -1, 128).detach().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal)
            dos = do.view(1, bh, lq, 128)
            lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), dos, retain_graph=True))
            for part, (kern, plain) in fns.items():
                b_ms, b_by = attention_bwd_bound_ms(
                    part, bh, lq, lk, 128, causal, rec["dtype"], esize, osize)
                rec[part] = {"kernel_ms": cuda_ms(torch, kern),
                             "plain_ms": cuda_ms(torch, plain, warmup=1,
                                                 iters=3),
                             "library_ms": lib_ms, "bound_ms": b_ms,
                             "bound_by": b_by}
            del qs, ks, vs, out
        emit(phase="kernel_bwd", **rec)
        if not ok:
            raise AssertionError(f"backward kernels disagree with their "
                                 f"plain versions in case {name}: {rec}")
        records[name] = rec
        del q, k, v, do, o, lse, delta, got, ref, args, fns
    torch.cuda.empty_cache()
    return records


def phase_train(torch, llama, fa, train_mod, layers: int,
                lr: float = TRAIN_LR, remat: str = TRAIN_REMAT):
    """Four SGD steps at Llama-3-8B width through the three kernels."""
    cfg = llama.llama3_8b()
    if layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    L, chunk = 2048, 512
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    params = llama.init(g, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data, _ = train_mod.synthetic_tokens(cfg, n_seq=1, seq_len=L)
    batch = torch.from_numpy(data).to("cuda", torch.long)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    # Reference: step 1's loss through plain full attention.
    with torch.no_grad():
        ref_loss = float(llama.make_loss_fn(cfg, attn="full",
                                            loss_chunk=chunk)(
            params, (tokens, targets)))
    step = llama.make_train_step(cfg, lr=lr, attn="flash", remat=remat,
                                 loss_chunk=chunk)
    expected = {"flash_attention_fwd": FWD_PER_LAYER[remat] * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers}
    losses, step_ms, per_step = [], [], []
    reset_counts(fa)
    for _ in range(4):
        before = read_counts(fa)
        t0 = time.perf_counter()
        params, _, loss = step(params, None, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        after = read_counts(fa)
        per_step.append({k: after[k] - before[k] for k in after})
    counts = read_counts(fa)
    steady_ms = sorted(step_ms[1:])[1]          # median of steps 2-4
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    rec = {"phase": "train", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": 1, "seq": L, "dtype": "bfloat16",
           "attn": "flash", "remat": remat, "loss_chunk": chunk, "lr": lr,
           "init_s": init_s, "losses": losses,
           "step1_loss_full_attention": ref_loss,
           "step1_loss_rel_err_vs_full": rel, "step_ms": step_ms,
           "steady_step_ms": steady_ms,
           "tokens_per_s": L / (steady_ms / 1e3),
           "launches": counts, "launches_per_step": per_step,
           "expected_launches_per_step": expected,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(rec), flush=True)
    del params, step
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall at lr {lr}: {losses}")
    if any(s != expected for s in per_step):
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{expected} (remat={remat!r})")
    if not rel < 1e-2:
        raise AssertionError(f"step 1's loss {losses[0]} is {rel:.3g} "
                             f"relative from full attention's {ref_loss}")
    return rec


def phase_generate(torch, llama, fa, layers: int):
    cfg = llama.llama3_8b()
    if layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    g = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    params = llama.init(g, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab, (1, 2048), generator=g,
                           device="cuda")
    first = llama.make_generate_fn(cfg, 2048, 1)
    fn = llama.make_generate_fn(cfg, 2048, 16)
    fn(params, prompt)            # warm-up: kernels' first loads, cuBLAS
    torch.cuda.synchronize()

    reset_counts(fa)
    t0 = time.perf_counter()
    toks = fn(params, prompt)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(fa)
    launches = counts["flash_attention_fwd"]
    if counts != {**counts, "flash_attention_fwd": cfg.n_layers,
                  "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}:
        raise AssertionError(f"generate launched {counts}, expected the "
                             f"forward {cfg.n_layers} times and no backward")

    t0 = time.perf_counter()
    first(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    # Reference: the same prefill with plain full attention.
    logits_full, _ = llama._prefill(
        cfg, params, llama.init_kv_cache(cfg, 1, 2048, torch.bfloat16),
        prompt, attn="full")
    logits_flash, _ = llama._prefill(
        cfg, params, llama.init_kv_cache(cfg, 1, 2048, torch.bfloat16),
        prompt, attn="flash")
    rel = float((logits_flash - logits_full).norm() / logits_full.norm())
    toks_l = toks.cpu().tolist()[0]
    ok = (tuple(toks.shape) == (1, 16)
          and all(0 <= t < cfg.vocab for t in toks_l)
          and bool(torch.isfinite(logits_flash).all()) and rel < 5e-2)
    rec = {"phase": "generate", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "prompt_len": 2048, "max_new": 16,
           "dtype": "bfloat16", "init_s": init_s,
           "flash_fwd_launches": launches, "launches": counts,
           "total_ms": total_s * 1e3,
           "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_token": (total_s - prefill_s) * 1e3 / 15,
           "prefill_logits_rel_err_vs_full": rel,
           "greedy_first_token_flash_vs_full":
               [int(logits_flash.argmax()), int(logits_full.argmax())],
           "tokens": toks_l,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"generate phase output wrong: {rec}")
    return rec, cfg


def phase_serve(torch, llama, fa, engine_mod, serving, cfg):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = engine_mod.LlamaRunner(4, cfg=cfg, rng_seed=2, max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = serving.serve_config()
    ecfg["max_batch"] = 4
    eng = engine_mod.ServeEngine(runner=runner, cfg=ecfg)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (37, 300, 700, 1500)]
    # Warm-up request: first loads of the f32 kernels stay out of the TTFTs.
    warm = eng.submit(prompts[0][:8], max_new=2, deadline_ms=120000)
    while not warm.done.is_set():
        eng.iteration()
    torch.cuda.synchronize()
    reset_counts(fa)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=16, deadline_ms=120000) for p in prompts]
    iters = 0
    while not all(r.done.is_set() for r in reqs):
        eng.iteration()
        iters += 1
        if iters > 200:
            raise AssertionError("requests did not settle in 200 iterations")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts(fa)
    launches = counts["flash_attention_fwd"]
    bad = [(r.id, r.state, r.shed_reason, len(r.tokens)) for r in reqs
           if r.state != "done" or len(r.tokens) != 16]
    # Reference: the shortest request through make_generate_fn on the
    # runner's own parameters.
    ref = llama.make_generate_fn(cfg, len(prompts[0]), 16)(
        runner.params, [prompts[0]])[0].tolist()
    rec = {"phase": "serve", "n_layers": cfg.n_layers, "dtype": "float32",
           "slots": 4, "max_len": 2048, "init_s": init_s,
           "iterations": iters, "wall_ms": wall_s * 1e3,
           "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall_s,
           "flash_fwd_launches": launches, "launches": counts,
           "requests": [{"prompt": len(r.prompt), "state": r.state,
                         "ttft_ms": r.ttft_s * 1e3,
                         "latency_ms": r.latency_ms(),
                         "tokens": r.tokens} for r in reqs],
           "shortest_matches_generate": reqs[0].tokens == ref,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(rec), flush=True)
    if bad:
        raise AssertionError(f"requests not done with 16 tokens: {bad}")
    if reqs[0].tokens != ref:
        raise AssertionError(f"serve tokens {reqs[0].tokens} differ from "
                             f"make_generate_fn's {ref}")
    if counts["flash_attention_bwd_dq"] or counts["flash_attention_bwd_dkv"]:
        raise AssertionError(f"serving launched a backward kernel: {counts}")
    return counts


def phase_ring_kernels():
    """B1-B3 against their plain versions at p = 2 and 4 on the one card;
    returns the p = 2 and p = 4 results of rank 0."""
    from torchmpi_tpu_torch.tools import ring_bench

    out = {}
    for p in (2, 4):
        t0 = time.perf_counter()
        results = ring_bench.run(p)
        bad = [r for res in results for r in res["records"]
               if not r["bitwise_equal"]]
        r0 = results[0]
        for rec in r0["records"]:
            if "kernel_ms" in rec:
                rec["bound_ms"] = ring_bench.bound_ms(rec["kind"], rec["n"], p,
                                                      4)
                emit(phase="ring_kernels", design=RING_DESIGN, **rec)
        rings = r0["resnet_rings"]
        rings["bound_ms"] = sum(ring_bench.bound_ms("allreduce", n, p, 4)
                                for n in rings["sizes"])
        emit(phase="ring_kernels", design=RING_DESIGN, resnet_step_rings={
            k: v for k, v in rings.items() if k != "sizes"})
        bad += [r["resnet_rings"] for r in results
                if not r["resnet_rings"]["bitwise_equal"]]
        emit(phase="ring_kernels", p=p, cases=len(r0["records"]),
             all_bitwise_equal=not bad,
             collectives_launches=r0["collectives_launches"],
             collectives_ok=all(r["collectives_ok"] for r in results),
             stall=r0["stall"], late=r0["late"],
             seconds=time.perf_counter() - t0)
        if bad:
            raise AssertionError(f"ring kernels disagree with the plain "
                                 f"schedule at p={p}: {bad[:3]}")
        if not all(r["collectives_ok"] for r in results):
            raise AssertionError(f"collectives path wrong at p={p}")
        if r0["collectives_launches"] != dict.fromkeys(RING_KERNELS, 1):
            raise AssertionError(f"collectives path launched "
                                 f"{r0['collectives_launches']}")
        if not ring_bench.stalls_ok(r0["stall"], r0["late"]):
            raise AssertionError(f"a stalled ring did not raise in time or "
                                 f"lost its aborted flag words: "
                                 f"{r0['stall']} {r0['late']}")
        out[p] = r0
    return out


def _ring_timer(torch, cuda_ring, box, check):
    """Wrap inner_ring_allreduce to add each call's device time (CUDA events
    on the rank's stream, from the moment the stream reaches the ring) to
    box[0], in ms.  While check["on"] holds, each ring's result is also held
    against the plain schedule over every rank's input (gathered over the
    process group through the host), bit for bit; check counts the rings
    held, the unequal ones and the largest error."""
    import torch.distributed as dist

    ring = cuda_ring.inner_ring_allreduce

    def timed(x, p, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            out = ring(x, p, **kwargs)
        finally:
            b.record()
            b.synchronize()
            box[0] += a.elapsed_time(b)
        if check["on"]:
            xs = [torch.empty_like(x, device="cpu") for _ in range(p)]
            dist.all_gather(xs, x.cpu(), group=kwargs["comm"].group)
            want = cuda_ring._ring_allreduce_plain(
                [t.to(x.device) for t in xs],
                mean=kwargs.get("mean", False))[kwargs["comm"].rank]
            same = bool(torch.equal(out.view(torch.int32),
                                    want.view(torch.int32)))
            check["rings"] += 1
            check["unequal"] += not same
            check["max_abs_err"] = max(check["max_abs_err"], float(
                (out.double() - want.double()).abs().max()))
        return out

    cuda_ring.inner_ring_allreduce = timed


def resnet_rank_main(steps: int, batch: int, lr: float) -> dict:
    """One rank of the train_resnet phase (spawned)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.set("use_pallas_collectives", True)
    device = lifecycle.start()
    try:
        p, rank = lifecycle.size(), lifecycle.rank()
        cfg = resnet.config(depth=50, n_classes=1000, width_multiplier=1.0)
        params, bn_state = resnet.init(7, cfg, device=device)
        ds = synthetic_mnist(n=p * batch, n_classes=1000, seed=1,
                             image_shape=(224, 224, 3))
        one = (ds.x.reshape(p, batch, 224, 224, 3), ds.y.reshape(p, batch))
        ring_s = [0.0]
        check = {"on": False, "rings": 0, "unequal": 0, "max_abs_err": 0.0}
        _ring_timer(torch, cuda_ring, ring_s, check)
        losses, step_ms, launches, ring_ms = [], [], [], []
        marks = {}

        def counts():
            return {"ring_allreduce": cuda_ring.ring_allreduce_launches,
                    "ring_reduce_scatter": cuda_ring.ring_reduce_scatter_launches,
                    "ring_allgather": cuda_ring.ring_allgather_launches}

        def on_sample(state):
            torch.cuda.synchronize()
            check["on"] = not step_ms          # the rings of step 1
            marks["t0"], marks["c0"], ring_s[0] = (time.perf_counter(),
                                                   counts(), 0.0)

        def on_update(state):
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
            ring_ms.append(ring_s[0])
            losses.append(float(state["loss"]))
            c = counts()
            launches.append({k: c[k] - marks["c0"][k] for k in c})

        engine = AllReduceSGDEngine(
            resnet.make_loss_fn(cfg), lr=lr, mode="compiled",
            hooks={"on_sample": on_sample, "on_update": on_update})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_ring.ring_allreduce_launches = 0
        cuda_ring.ring_reduce_scatter_launches = 0
        cuda_ring.ring_allgather_launches = 0
        state = engine.train(params, [one] * steps, epochs=1)
        check["on"] = False
        total = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = state["params"]
        mpinn.check_with_allreduce(params, tol=0.0)
        digest = hashlib.sha256()
        for leaf in tree.leaves(params):
            digest.update(leaf.detach().cpu().numpy().tobytes())
        digests = [None] * p
        dist.all_gather_object(digests, digest.hexdigest())

        # One eager_sync step, then the inference-mode evaluation.
        cuda_ring.ring_allreduce_launches = 0
        eager = AllReduceSGDEngine(resnet.make_loss_fn(cfg), lr=lr,
                                   mode="eager_sync",
                                   sync_parameters_on_start=False)
        est = eager.train(params, [one], epochs=1)
        eager_launches = cuda_ring.ring_allreduce_launches
        x = torch.as_tensor(one[0][rank]).to(device)
        bn_state = resnet.make_update_stats_fn(cfg)(est["params"], bn_state, x)
        acc = engine.test(est["params"], [one],
                          resnet.make_accuracy_fn(cfg, bn_state))
        return {"rank": rank, "p": p, "losses": losses, "step_ms": step_ms,
                "ring_ms": ring_ms, "launches_per_step": launches,
                "launches": total, "peak_gb": peak_gb,
                "step1_rings_vs_plain": {k: v for k, v in check.items()
                                         if k != "on"},
                "replicas_bitwise_equal": len(set(digests)) == 1,
                "eager_sync_loss": float(est["loss"]),
                "eager_sync_ring_launches": eager_launches,
                "eval_accuracy": acc}
    finally:
        lifecycle.stop()


def phase_train_resnet(torch, rings):
    """ResNet-50 at full width on 2 ranks of the one card through B1.  The
    ring's share of a step is read two ways: the rings' device time inside
    the steps (CUDA events), and the ring_kernels phase's time for the 43
    rings of a step at their own sizes at p = 2, over the step."""
    from torchmpi_tpu_torch.runtime import launch

    t0 = time.perf_counter()
    res = launch.spawn(2, resnet_rank_main,
                       (RESNET_STEPS, RESNET_BATCH, RESNET_LR), timeout_s=900)
    r0 = res[0]
    steady = sorted(r0["step_ms"][1:])
    steady_ms = (steady[1] + steady[2]) / 2          # median of steps 2-5
    ring_steady = sorted(r0["ring_ms"][1:])
    ring_ms = (ring_steady[1] + ring_steady[2]) / 2
    bench_ms = rings[2]["resnet_rings"]["kernel_ms"]
    expected = {"ring_allreduce": RESNET_RINGS, "ring_reduce_scatter": 0,
                "ring_allgather": 0}
    rec = {"phase": "train_resnet", "model": "resnet50", "width": 1.0,
           "image": 224, "classes": 1000, "dtype": "float32", "ranks": 2,
           "batch_per_rank": RESNET_BATCH, "lr": RESNET_LR,
           "losses": [r["losses"] for r in res],
           "step_ms": r0["step_ms"], "steady_step_ms": steady_ms,
           "images_per_s_per_card": 2 * RESNET_BATCH / (steady_ms / 1e3),
           "ring_ms_per_step": r0["ring_ms"], "steady_ring_ms": ring_ms,
           "ring_share_of_step": ring_ms / steady_ms,
           "bench_step_rings_ms": bench_ms,
           "bench_ring_share_of_step": bench_ms / steady_ms,
           "launches": r0["launches"],
           "launches_per_step": [r["launches_per_step"] for r in res],
           "step1_rings_vs_plain": [r["step1_rings_vs_plain"] for r in res],
           "expected_launches_per_step": expected,
           "peak_memory_gb_per_rank": [r["peak_gb"] for r in res],
           "replicas_bitwise_equal": r0["replicas_bitwise_equal"],
           "eager_sync_loss": r0["eager_sync_loss"],
           "eager_sync_ring_launches": r0["eager_sync_ring_launches"],
           "eval_accuracy": r0["eval_accuracy"],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    for r in res:
        if any(s != expected for s in r["launches_per_step"]):
            raise AssertionError(f"rank {r['rank']} launched "
                                 f"{r['launches_per_step']}, expected "
                                 f"{expected} a step")
        held = r["step1_rings_vs_plain"]
        if held["rings"] != RESNET_RINGS or held["unequal"]:
            raise AssertionError(f"rank {r['rank']}: step 1's rings against "
                                 f"the plain schedule: {held}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"non-finite loss {r['losses']}")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"loss did not fall: {r['losses']}")
    if not r0["replicas_bitwise_equal"]:
        raise AssertionError("replicas' parameters differ after the steps")
    if not (math.isfinite(r0["eager_sync_loss"])
            and 0.0 <= r0["eval_accuracy"] <= 1.0):
        raise AssertionError(f"eager_sync step or evaluation wrong: {rec}")
    return rec


def ring_kernel_record(name, rings, train_launches, train_rec):
    """One ``kernels`` entry of a ring kernel at p = 2: B1 at the path's own
    work, the 43 rings of a ResNet-50 step (times, bound and the largest
    error over them, the ring_kernels cases and step 1's rings of the train
    phase); B2 and B3 at n = 25,557,032 in f32, the collectives path's
    size.  Launches of every path."""
    replaces, function, kind, library = RING_KERNELS[name]
    big = next(r for r in rings[2]["records"]
               if r["kind"] == kind and "kernel_ms" in r)
    by_path = {"train_resnet": train_launches[name],
               "collectives": rings[2]["collectives_launches"][name]}
    timing = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    err = max(r["max_abs_err"] for p in (2, 4)
              for r in rings[p]["records"] if r["kind"] == kind)
    rec = {"name": name, "route": "cuda", "source": RING_SRC,
           "replaces": replaces, "replaces_function": function,
           "launches": sum(by_path.values()), "launches_by_path": by_path,
           "bound_by": "bytes", "library": library, "design": RING_DESIGN}
    if kind == "allreduce":
        step = rings[2]["resnet_rings"]
        err = max([err, step["max_abs_err"]]
                  + [h["max_abs_err"] for h in train_rec["step1_rings_vs_plain"]])
        return {**rec, "max_abs_err": err, "ms": step["kernel_ms"],
                **{k: step[k] for k in timing},
                "shape": (f"the {step['rings']} rings of one ResNet-50 step "
                          f"({step['elements']} f32 elements, largest "
                          f"{step['largest']}, tail {step['tail']}), mean, "
                          f"p=2 ranks on one card"),
                "largest_ring_ms": step["largest_ms"],
                "tail_ring_ms": step["tail_ms"],
                "at_n_25557032": {k: big[k] for k in timing}}
    return {**rec, "max_abs_err": err, "ms": big["kernel_ms"],
            **{k: big[k] for k in timing},
            "shape": "n=25557032 f32, p=2 ranks on one card"}


def kernel_record(name, recs, part, err_keys, launches_by_path):
    """One entry of the ``kernels`` line: the main bf16 case's times, the
    largest error over every case, and the launches of every path."""
    source, replaces, function, library = KERNELS[name]
    main = recs["main_bf16"] if part is None else recs["main_bf16"][part]
    f32 = recs["main_f32"] if part is None else recs["main_f32"][part]
    timing = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "replaces_function": function,
        "launches": sum(p[name] for p in launches_by_path.values()),
        "launches_by_path": {path: p[name]
                             for path, p in launches_by_path.items()},
        "max_abs_err": max(r[k] for r in recs.values() for k in err_keys),
        "ms": main["kernel_ms"], **{k: main[k] for k in timing},
        "library": library,
        "shape": "B=1 H=32 L=2048 D=128 causal bf16",
        "f32": {k: f32[k] for k in timing},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of phases 4-6: 8 to 32 (Llama-3-8B has 32)")
    args = ap.parse_args()
    if not 8 <= args.layers <= 32:
        ap.error(f"--layers must be 8 to 32, got {args.layers}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import importlib

    import torchmpi_tpu_torch  # noqa: F401
    from torchmpi_tpu_torch import _build, serving
    from torchmpi_tpu_torch.examples import train_llama as train_mod
    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.serving import engine as engine_mod

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, HERE) for p in libs])

    kernel_recs = phase_kernel(torch, fa)
    bwd_recs = phase_kernel_bwd(torch, fa)
    rings = phase_ring_kernels()
    resnet_rec = phase_train_resnet(torch, rings)
    if args.layers != 32:
        emit(phase="cut", n_layers=args.layers, of=32)
    gen, cfg = phase_generate(torch, llama, fa, args.layers)
    # The kernel's share of the prefill: its time at this very shape,
    # times its launches, over the measured prefill.
    attn_ms = kernel_recs["main_bf16"]["kernel_ms"] * gen["flash_fwd_launches"]
    emit(phase="prefill_breakdown", prefill_ms=gen["prefill_ms"],
         flash_kernel_ms=attn_ms, flash_kernel_share=attn_ms / gen["prefill_ms"])
    torch.cuda.empty_cache()
    launches = {"generate": gen["launches"],
                "serve": phase_serve(torch, llama, fa, engine_mod, serving,
                                     cfg)}
    torch.cuda.empty_cache()
    train = phase_train(torch, llama, fa, train_mod, args.layers)
    launches["train"] = train["launches"]
    # The three kernels' share of a steady step: their times at this very
    # shape (kernel phase), times their launches in one step, over the step.
    per_step = train["launches_per_step"][-1]
    kernel_ms = {
        "flash_attention_fwd": kernel_recs["main_bf16"]["kernel_ms"],
        "flash_attention_bwd_dq": bwd_recs["main_bf16"]["dq"]["kernel_ms"],
        "flash_attention_bwd_dkv": bwd_recs["main_bf16"]["dkv"]["kernel_ms"]}
    in_step = {k: per_step[k] * kernel_ms[k] for k in kernel_ms}
    emit(phase="train_breakdown", steady_step_ms=train["steady_step_ms"],
         kernel_ms_per_step=in_step,
         kernel_share={k: v / train["steady_step_ms"]
                       for k, v in in_step.items()},
         kernels_share=sum(in_step.values()) / train["steady_step_ms"])

    print(smi, flush=True)
    emit(kernels=[
        kernel_record("flash_attention_fwd", kernel_recs, None,
                      ("o_max_abs_err",), launches),
        kernel_record("flash_attention_bwd_dq", bwd_recs, "dq",
                      ("dq_max_abs_err",), launches),
        kernel_record("flash_attention_bwd_dkv", bwd_recs, "dkv",
                      ("dk_max_abs_err", "dv_max_abs_err"), launches),
        *(ring_kernel_record(name, rings, resnet_rec["launches"],
                             resnet_rec) for name in RING_KERNELS),
    ])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
