"""How fast can processes that share one GPU wait on each other?

    python -m torchmpi_tpu_torch.tools.ring_probe [--iters 1000] [--out FILE]

Spawns two ranks on the GPU (``runtime.launch``; on one card both bind
``cuda:0`` over gloo).  Each allocates one flag word per mode with
``cudaMalloc`` (the ring library's staging allocator), the cudaIPC handles
are swapped over the process group, and the ranks ping-pong ``--iters``
round trips in three modes, kernels in ``tools/csrc/ring_probe.cu``:

0. one persistent kernel in each process spinning on its flag;
1. one launch per half round trip, the wait spinning inside the kernel;
2. stream memory operations (``cuStreamWaitValue64`` /
   ``cuStreamWriteValue64``) around a one-thread kernel: the wait is in the
   stream, not on the SMs.

Each spinning wait gives up after ``--timeout`` seconds; a stream wait
cannot, so a rank whose mode 2 outlasts it exits and the run fails.
Prints one JSON line (round trips finished, seconds and microseconds per
round trip for each mode, with the card's name and power limit) and writes
it to ``--out`` when given.  Needs a GPU.  The ring kernels' design rests
on these numbers (``ops/csrc/ring.cu``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

MODES = {0: "persistent_spin_kernel", 1: "kernel_per_step_spin",
         2: "stream_wait_value"}
PROBE_SRC = Path(__file__).resolve().parent / "csrc"


def rank_main(iters: int, timeout_s: float) -> dict:
    """One rank's ping-pong in every mode (spawned)."""
    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch import _build
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.runtime import lifecycle

    lifecycle.start()
    try:
        rank = dist.get_rank()
        lib = cuda_ring._library()
        probe = _build.load("ring_probe", PROBE_SRC)
        probe.tmpi_ring_probe.restype = ctypes.c_int
        probe.tmpi_ring_probe.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_void_p]
        flags = ctypes.c_void_p()
        cuda_ring._check_cuda(lib.tmpi_ring_alloc(256, ctypes.byref(flags)),
                              "cudaMalloc")
        handle = ctypes.create_string_buffer(lib.tmpi_ring_ipc_handle_bytes())
        cuda_ring._check_cuda(lib.tmpi_ring_ipc_get(flags, handle),
                              "cudaIpcGetMemHandle")
        handles = [None] * dist.get_world_size()
        dist.all_gather_object(handles, handle.raw)
        peer = ctypes.c_void_p()
        cuda_ring._check_cuda(lib.tmpi_ring_ipc_open(handles[1 - rank],
                                                     ctypes.byref(peer)),
                              "cudaIpcOpenMemHandle")
        out = {"rank": rank, "device": torch.cuda.get_device_name()}
        stream = torch.cuda.current_stream().cuda_stream
        for mode, name in MODES.items():
            scratch = torch.zeros(2, dtype=torch.int32, device="cuda")
            dist.barrier()
            t0 = time.perf_counter()
            # Mode 1 bounds each wait, and skips every launch after a miss.
            wait_s = timeout_s if mode == 0 else 2.0
            cuda_ring._check_cuda(probe.tmpi_ring_probe(
                mode, flags.value + 64 * mode, peer.value + 64 * mode, rank,
                iters, 0, int(wait_s * 1e9), scratch.data_ptr(), stream),
                f"probe mode {mode}")
            ev = torch.cuda.Event()
            ev.record()
            while not ev.query():
                if mode == 2 and time.perf_counter() - t0 > timeout_s + 5:
                    os._exit(3)        # a stream wait cannot be cancelled
                time.sleep(1e-4)
            secs = time.perf_counter() - t0
            sc = scratch.tolist()
            done = sc[0] if mode == 0 else (iters if sc[0] == 0 else sc[0] - 1)
            out[name] = {"round_trips": done, "of": iters, "seconds": secs,
                         "us_per_round_trip": secs / max(done, 1) * 1e6}
        dist.barrier()
        return out
    finally:
        lifecycle.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--timeout", type=float, default=20.0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ring_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    from torchmpi_tpu_torch import _build
    from torchmpi_tpu_torch.runtime import launch

    _build.build("ring")
    _build.build("ring_probe", PROBE_SRC)
    results = launch.spawn(2, rank_main, (args.iters, args.timeout),
                           timeout_s=4 * args.timeout + 240)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    line = json.dumps({"probe": results, "nvidia_smi": smi})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
