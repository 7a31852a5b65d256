"""Where a decode step's time goes: host wall against device busy time.

    python -m torchmpi_tpu_torch.tools.profile_decode [--layers N]
        [--prompt-len L] [--steps S]

Initialises Llama-3-8B width (bf16, random weights from a seeded
``torch.Generator``) on the current GPU, prefills an ``L``-token prompt,
then runs ``S`` greedy ``_decode_step`` calls twice: once timed alone
(wall clock around synchronised steps), once under ``torch.profiler``,
which gives the device's busy time, the CUDA kernels and the aten ops of
a step.  Last it times decode through the entry point, as
``chip_smoke.py`` does: ``make_generate_fn`` with 16 new tokens less the
same with 1, over 15.  Prints the card's name and power limit, then one
JSON line.  The profiler adds host time, so its wall is longer than the
timed one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models import llama

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=args.layers)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init(g, cfg, dtype=torch.bfloat16)
    plen, steps = args.prompt_len, args.steps
    prompt = torch.randint(0, cfg.vocab, (1, plen), generator=g,
                           device="cuda")

    def run_steps(cache, tok, first_pos):
        for i in range(steps):
            logits, cache = llama._decode_step(cfg, params, cache, tok,
                                               first_pos + i)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        return tok

    cache = llama.init_kv_cache(cfg, 1, plen + 3 * steps, torch.bfloat16)
    logits, cache = llama._prefill(cfg, params, cache, prompt)
    tok = run_steps(cache, logits.argmax(-1), plen)          # warm-up
    t0 = time.perf_counter()
    tok = run_steps(cache, tok, plen + steps)
    timed_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(cache, tok, plen + 2 * steps)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    busy_us, kernels, aten_ops = 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.key.startswith("aten::"):
            aten_ops += ev.count
        if ev.device_type.name == "CUDA":
            kernels += ev.count
            busy_us += getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0.0))
    busy_ms = busy_us / 1e3

    def entry_ms(max_new):
        fn = llama.make_generate_fn(cfg, plen, max_new)
        fn(params, prompt)                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, prompt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    entry_ms_per_token = (entry_ms(16) - entry_ms(1)) / 15
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    print(json.dumps({
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": "bfloat16",
        "prompt_len": plen, "steps": steps,
        "timed_ms_per_step": timed_ms / steps,
        "entry_decode_ms_per_token": entry_ms_per_token,
        "profiled_wall_ms_per_step": prof_wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms if busy_ms else None,
        "kernels_per_step": kernels / steps,
        "aten_ops_per_step": aten_ops / steps}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
