#!/usr/bin/env python3
"""Drive the PyTorch port (torchmpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: requires CUDA; prints the card; turns TF32 off for matmuls and
   convolutions, so f32 means f32.
2. build: builds every kernel under torchmpi_tpu_torch/ops/csrc with nvcc
   and prints the build time.
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version at the generate path's shape (B=1, H=32, L=2048, D=128, causal)
   in bf16 and f32, plus a non-causal, an Lk != Lq (f32 out) and a ragged
   case; prints each max error beside its tolerance, and the kernel's,
   the plain version's and scaled_dot_product_attention's time (the last
   only as a yardstick: the port never calls it) beside the card's bound.
4. generate: make_generate_fn at Llama-3-8B width, bf16 weights from a
   seeded torch.Generator, B=1, a 2048-token prompt, 16 new tokens,
   greedy; the prefill must launch the kernel once per layer.  The prefill
   logits through the kernel are held against full attention.
5. serve: ServeEngine over a LlamaRunner at the same width, f32 weights,
   4 slots, max_len 2048, four requests of 37, 300, 700 and 1500 prompt
   tokens and 16 new tokens each, single-stepped through iteration() until
   every request is done; the shortest is held against make_generate_fn.

Then a line with the card's name and power limit, a ``kernels`` JSON line,
and last ``{"ok": true, "device": {...}}``.  ``--layers`` cuts the depth of
phases 4-5 to no fewer than 8 layers (never the width); a cut is printed.
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
KERNEL_SOURCE = "torchmpi_tpu_torch/ops/csrc/flash_attention_fwd.cu"
REPLACES = "torchmpi_tpu/ops/flash_attention.py:36"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 no TF32


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


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


def attention_bound_ms(bh, lq, lk, d, causal, in_dtype, in_bytes, out_bytes):
    """Least time for the attention forward on this card: the larger of its
    bytes (q, k, v read once, o and lse written once) over HBM rate and its
    multiply-adds (the (q, k) pairs this causal mask keeps) over the peak
    rate of the input type."""
    if causal:
        pairs = sum(min(lk, i + 1) for i in range(lq))
    else:
        pairs = lq * lk
    ops = 4.0 * bh * pairs * d                    # q.k and p.v, 2 ops each
    nbytes = bh * (lq * d * in_bytes + 2 * lk * d * in_bytes
                   + lq * d * out_bytes + lq * 4)
    t_ops = ops / PEAK_OPS_PER_S[in_dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


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

    fa.flash_fwd_launches = 0
    t0 = time.perf_counter()
    toks = fn(params, prompt)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = fa.flash_fwd_launches
    if launches != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel {launches} "
                             f"times, expected {cfg.n_layers}")

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
           "flash_fwd_launches": launches, "total_ms": total_s * 1e3,
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
    fa.flash_fwd_launches = 0
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
    launches = fa.flash_fwd_launches
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
           "flash_fwd_launches": launches,
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
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of phases 4-5: 8 to 32 (Llama-3-8B has 32)")
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
    libs = [_build.build(n) for n in _build.sources()]
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, HERE) for p in libs])

    kernel_recs = phase_kernel(torch, fa)
    if args.layers != 32:
        emit(phase="cut", n_layers=args.layers, of=32)
    gen, cfg = phase_generate(torch, llama, fa, args.layers)
    # The kernel's share of the prefill: its time at this very shape,
    # times its launches, over the measured prefill.
    attn_ms = kernel_recs["main_bf16"]["kernel_ms"] * gen["flash_fwd_launches"]
    emit(phase="prefill_breakdown", prefill_ms=gen["prefill_ms"],
         flash_kernel_ms=attn_ms, flash_kernel_share=attn_ms / gen["prefill_ms"])
    torch.cuda.empty_cache()
    launches = {"generate": gen["flash_fwd_launches"],
                "serve": phase_serve(torch, llama, fa, engine_mod, serving,
                                     cfg)}

    main_rec = kernel_recs["main_bf16"]
    f32_rec = kernel_recs["main_f32"]
    print(smi, flush=True)
    emit(kernels=[{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "replaces_function": "_attn_kernel",
        "launches": launches["generate"],
        "launches_by_path": launches,
        "max_abs_err": max(r["o_max_abs_err"] for r in kernel_recs.values()),
        "ms": main_rec["kernel_ms"],
        "kernel_ms": main_rec["kernel_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "shape": "B=1 H=32 L=2048 D=128 causal bf16",
        "f32": {k: f32_rec[k] for k in ("kernel_ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")},
    }])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
