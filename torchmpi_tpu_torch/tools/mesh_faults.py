"""Which of the mesh phase's checks catch a wrong mesh path.

    python -m torchmpi_tpu_torch.tools.mesh_faults [--faults F ...]
        [--out DIR]

Runs ``chip_smoke.py``'s ``mesh`` phase (one card, its ranks spawned on
it) once sound and once under each planted fault.  A fault is injected in
the spawned ranks only, at run time; the one-rank references the phase
computes in this process stay sound.  The faults:

- ``dq_half``: every ring block's dq halved (``flash_bwd_block`` as the
  ring and the zigzag ring call it): a backward fault, which step 1's loss
  cannot see;
- ``skip_past``: the contiguous ring's past block launched but left out of
  the (o, lse) carry: a forward fault on sp rank 1;
- ``tp_sum_layer0``: in generation, layer 0's attention tp sum left out
  (each rank keeps its own heads' share), in every prefill and decode
  step.

Prints the card's name and power limit, then one JSON line a run: the
names of the checks that failed and the readings they compare with their
bounds.  ``--out`` keeps each run's whole output.  ``--faults`` with no
name runs the phase alone, sound.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAULTS = ("dq_half", "skip_past", "tp_sum_layer0")


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _plant(fault: str) -> None:
    import torch

    from ..models import llama
    from ..parallel import sequence

    if fault == "dq_half":
        orig_bwd = sequence.flash_bwd_block

        def bwd(*a, **kw):
            dq, dk, dv = orig_bwd(*a, **kw)
            return dq * 0.5, dk, dv

        sequence.flash_bwd_block = bwd
    elif fault == "skip_past":
        orig_fwd = sequence.flash_fwd_block

        def fwd(q, k, v, *, causal, **kw):
            o, lse = orig_fwd(q, k, v, causal=causal, **kw)
            # The contiguous ring's past block (zigzag has no L x L
            # non-causal block).
            if not causal and q.shape[1] == k.shape[1] == 2048:
                return (torch.zeros_like(o),
                        torch.full_like(lse, sequence.NEG_INF))
            return o, lse

        sequence.flash_fwd_block = fwd
    elif fault == "tp_sum_layer0":
        orig_sum = llama._MeshPlan.tp_sum

        def tp_sum(self, part):
            if getattr(self, "_drop", False):
                self._drop = False
                return part
            return orig_sum(self, part)

        llama._MeshPlan.tp_sum = tp_sum
        for name in ("_prefill", "_decode_step"):
            orig = getattr(llama, name)

            def forward(*a, _orig=orig, **kw):
                if kw.get("tp") is not None:
                    kw["tp"]._drop = True      # its first sum: layer 0's
                return _orig(*a, **kw)

            setattr(llama, name, forward)
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def fault_rank_main(fault: str, part: str, gen_layers: int = 32) -> dict:
    """One rank of the mesh phase with ``fault`` planted."""
    _plant(fault)
    return _chip_smoke().mesh_rank_main(part, gen_layers)


def _summary(rec: dict) -> dict:
    out = {"failed": sorted({b["check"] for b in rec["failed"]})}
    for attn, r in rec["sgd"].items():
        out[attn] = {"step1_loss_rel_err": r["step1_loss_rel_err"],
                     "last_loss_rel_err": r["last_loss_rel_err"],
                     "moved_equal_share": {k: v["moved_equal_share"]
                                           for k, v in r["leaves"].items()}}
    a = rec["adam_zero1"]
    out["adam_zero1"] = {k: a[k] for k in ("step1_loss_rel_err",
                                           "last_loss_rel_err")}
    for name, g in rec["generate"].items():
        out[f"generate_{name}"] = {
            "prefill_logits_rel_err": g["prefill_logits_rel_err"],
            "tokens_equal_one_rank": g["tokens"] == g["one_rank_tokens"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", nargs="*", default=list(FAULTS),
                    choices=FAULTS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import functools
    import importlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_faults: no CUDA device is visible")
    from .. import _build
    from ..examples import train_llama as train_mod
    from ..models import llama

    # Spawned ranks import this module by its name, not as __main__.
    from . import mesh_faults

    cs = _chip_smoke()
    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for fault in ["", *args.faults]:
        # phase_mesh spawns its module's mesh_rank_main.
        cs.mesh_rank_main = functools.partial(mesh_faults.fault_rank_main,
                                              fault)
        buf, raised = io.StringIO(), None
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cs.phase_mesh(torch, llama, fa, train_mod, 32)
        except AssertionError as e:
            raised = str(e)[:200]
        name = fault or "sound"
        text = buf.getvalue()
        if args.out:
            with open(os.path.join(args.out, f"mesh_{name}.txt"), "w") as f:
                f.write(text)
        recs = [json.loads(line) for line in text.splitlines()
                if line.startswith('{"phase": "mesh"')]
        blocks = [json.loads(line) for line in text.splitlines()
                  if line.startswith('{"phase": "mesh_blocks"')]
        print(json.dumps({
            "run": name, "seconds": time.perf_counter() - t0,
            "raised": raised,
            "blocks": {b["block"]: {k: b[k] for k in (
                "o_max_abs_err", "lse_max_abs_err", "dq_max_abs_err",
                "dk_max_abs_err", "dv_max_abs_err", "fwd_ms", "bwd_ms")}
                for b in blocks},
            **(_summary(recs[-1]) if recs else {})}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    import atexit

    # As chip_smoke.py's main block: registered before torch imports
    # multiprocessing, so that it runs after multiprocessing's own exit
    # handler (no process of the run is left behind).
    atexit.register(lambda: _chip_smoke().stop_children())
    sys.exit(main())
