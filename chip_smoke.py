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
    ])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
