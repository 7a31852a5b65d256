"""Where a training step's time goes: host wall against device busy time,
and device time by kind of kernel.

    python -m torchmpi_tpu_torch.tools.profile_train [--layers N]
        [--seq L] [--remat dots|full|none] [--steps S]
        [--dtype bfloat16|float32]
    python -m torchmpi_tpu_torch.tools.profile_train --model resnet50
        [--batch B] [--steps S]

``llama`` (the default) initialises Llama-3-8B width (``--dtype``, bf16 by
default, random weights from a seeded ``torch.Generator``) on the current
GPU and builds ``make_train_step`` as ``chip_smoke.py``'s train and
train_f32 phases do (B=1, attn="flash", loss_chunk=512, plain SGD; f32
runs every flash kernel as three bf16 products after a split launch, and
needs ``--layers 16`` or fewer to fit the card).  ``resnet50`` runs one rank's
share of ``chip_smoke.py``'s train_resnet step alone on the card: ResNet-50
at full width, f32 with TF32 off, ``--batch`` images of 224x224x3, the
engine's loss and gradients and SGD update with no gradient sync.  After
one warm-up step it times ``S`` synchronised steps, then profiles ``S``
more under ``torch.profiler``, which gives the device's busy time and its
kernels.  Device time is summed by kind: the port's flash kernels,
convolutions, cuBLAS/CUTLASS matrix products, and everything else
(elementwise, reductions, copies).  Prints the card's name and power
limit, then one JSON line.  The profiler adds host time, so its wall is
longer than the timed one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

KINDS = (("flash_attention_fwd", ("flash_fwd_wgmma",)),
         ("flash_attention_bwd_dq", ("flash_bwd_dq_wgmma",)),
         ("flash_attention_bwd_dkv", ("flash_bwd_dkv_wgmma",)),
         ("bf16_split", ("split_kernel",)),
         ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd")),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, marks in KINDS:
        if any(m in low for m in marks):
            return kind
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--model", default="llama", choices=["llama", "resnet50"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="llama: the weights' type")
    ap.add_argument("--batch", type=int, default=32,
                    help="resnet50: images per step")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, info = (_resnet50(args) if args.model == "resnet50"
                 else _llama(args))

    torch.cuda.reset_peak_memory_stats()
    run(1)                                                  # warm-up
    t0 = time.perf_counter()
    run(args.steps)
    timed_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    by_kind = {kind: 0.0 for kind, _ in KINDS}
    by_kind["other"] = 0.0
    kernels, aten_ops, top = 0, 0, []
    for ev in prof.key_averages():
        if ev.key.startswith("aten::"):
            aten_ops += ev.count
        if ev.device_type.name != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        kernels += ev.count
        by_kind[kind_of(ev.key)] += us / 1e3 / args.steps
        top.append((us / 1e3 / args.steps, ev.count / args.steps,
                    ev.key[:90]))
    busy_ms = sum(by_kind.values())
    top.sort(reverse=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    per_s = info.pop("per_step") / (timed_ms / 1e3)
    print(json.dumps({
        **info, "steps": args.steps, "timed_ms_per_step": timed_ms,
        ("images_per_s" if args.model == "resnet50" else "tokens_per_s"):
            per_s,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
        "device_ms_per_step_by_kind": by_kind,
        "kernels_per_step": kernels / args.steps,
        "aten_ops_per_step": aten_ops / args.steps,
        "top_kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                        for ms, n, name in top[:15]],
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)
    return 0


def _llama(args):
    """The Llama-3-8B-width train step: ``(run(n), info)``."""
    import torch

    from ..examples.train_llama import synthetic_tokens
    from ..models import llama

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=args.layers)
    g = torch.Generator(device="cuda").manual_seed(4)
    params = llama.init(g, cfg, dtype=getattr(torch, args.dtype))
    data, _ = synthetic_tokens(cfg, n_seq=1, seq_len=args.seq)
    batch = torch.from_numpy(data).to("cuda", torch.long)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    step = llama.make_train_step(cfg, lr=0.25, attn="flash",
                                 remat=args.remat, loss_chunk=512)

    def run(n):
        nonlocal params
        for _ in range(n):
            params, _, loss = step(params, None, tokens, targets)
        torch.cuda.synchronize()
        return float(loss)

    return run, {"model": "llama", "n_layers": cfg.n_layers,
                 "d_model": cfg.d_model, "dtype": args.dtype, "batch": 1,
                 "seq": args.seq, "remat": args.remat, "loss_chunk": 512,
                 "per_step": args.seq}


def _resnet50(args):
    """One rank's ResNet-50 step without the gradient sync: ``(run(n),
    info)``."""
    import torch

    from ..engine.sgdengine import sgd_update, value_and_grad
    from ..models import resnet

    cfg = resnet.config(depth=50, n_classes=1000, width_multiplier=1.0)
    params, _ = resnet.init(7, cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((args.batch, 224, 224, 3), generator=g, device="cuda")
    y = torch.randint(0, 1000, (args.batch,), generator=g, device="cuda")
    loss_fn = resnet.make_loss_fn(cfg)

    def run(n):
        nonlocal params
        for _ in range(n):
            loss, grads = value_and_grad(loss_fn, params, (x, y))
            params = sgd_update(params, grads, 0.1)
        torch.cuda.synchronize()
        return float(loss)

    return run, {"model": "resnet50", "image": 224, "classes": 1000,
                 "dtype": "float32", "batch": args.batch,
                 "per_step": args.batch}


if __name__ == "__main__":
    raise SystemExit(main())
