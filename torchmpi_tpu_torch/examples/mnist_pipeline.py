"""Pipelined block-model-parallel MNIST — BASELINE config 4
("BlockSequential model-parallel CNN pipelined across TPU chips"): the
network body is partitioned into pipeline stages (the BlockSequential
partition promoted to a true micro-batch GPipe schedule across the pp
axis); embed and head stay outside the uniform-carrier pipeline.  The port
of ``examples/mnist/mnist_pipeline.py``:

    python -m torchmpi_tpu_torch.examples.mnist_pipeline --nproc 4
    python -m torchmpi_tpu_torch.examples.mnist_pipeline --nproc 4 \\
        --device cpu --limit 2048 --epochs 2

``--nproc p`` spawns the p ranks itself (a mesh of ``pp`` = ``--stages``
and ``dp`` = the rest); under ``torchrun`` each process is one rank.
Every rank reads the same synthetic batches and draws the same weights
from one seed; each rank keeps its stage's row of the body
(``parallel/pipeline.py`` ``stage_sharding``).  The pipeline's I/O is
sharded as in JAX (``make_pipeline_fn``'s default): each rank feeds its
group of micro-batches and gets back their outputs, so each computes the
head and the loss on its own rows; the loss and the embed and head
gradients are then summed over pp (one allreduce), which keeps those
replicated leaves equal on every rank.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--limit", type=int, default=8192,
                    help="synthetic training samples")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: this process is one "
                         "rank, as under torchrun)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """One rank's run; returns its numbers."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.parallel import make_mesh
    from torchmpi_tpu_torch.parallel import pipeline as pl
    from torchmpi_tpu_torch.utils.data import ShardedIterator, synthetic_mnist
    from torchmpi_tpu_torch.utils.meters import AverageValueMeter

    device = mpi.start(device=args.device)
    try:
        mesh = make_mesh({"pp": args.stages, "dp": -1})
        S, M, d = args.stages, args.microbatches, args.width
        rank = mpi.rank()
        pp = mesh.comm("pp")
        if rank == 0:
            print(f"pipeline: {S} stages x {M} micro-batches, width {d}",
                  flush=True)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        rng = np.random.RandomState(0)
        embed = {"w": t(rng.randn(784, d) * (2.0 / 784) ** 0.5),
                 "b": t(np.zeros((d,)))}
        head = {"w": t(rng.randn(d, 10) * (1.0 / d) ** 0.5),
                "b": t(np.zeros((10,)))}
        stages = [{"w": t(rng.randn(d, d) * (2.0 / d) ** 0.5),
                   "b": t(np.zeros((d,)))} for _ in range(S)]
        body = pl.stage_sharding(mesh, pl.stack_stage_params(stages))
        del stages
        outer = [embed["w"], embed["b"], head["w"], head["b"]]
        params = outer + [body["b"], body["w"]]
        for p in params:
            p.requires_grad_(True)

        def stage_fn(p, h):
            # residual keeps depth trainable
            return torch.relu(h @ p["w"] + p["b"]) + h

        # Sharded I/O whenever M % S == 0 (the default of
        # make_pipeline_fn): each rank feeds G micro-batches, its group g.
        sharded = S > 1 and M % S == 0
        pipe = pl.make_pipeline_fn(mesh, stage_fn, n_microbatches=M,
                                   sharded_io=sharded)
        G, g = (M // S, mesh.coords["pp"]) if sharded else (M, 0)

        def logits_and_rows(x):
            """This rank's rows' logits and the rows (sharded I/O)."""
            h = x.reshape(x.shape[0], -1) @ embed["w"] + embed["b"]
            hm = pl.microbatch(h, M)[g * G:(g + 1) * G]
            h = pl.unmicrobatch(pipe(body, hm))
            n = h.shape[0]
            return h @ head["w"] + head["b"], slice(g * n, (g + 1) * n)

        def step(x, y):
            logits, rows = logits_and_rows(x)
            # This rank's share of the global mean.
            loss = F.cross_entropy(logits, y[rows], reduction="sum") \
                / x.shape[0]
            grads = torch.autograd.grad(loss, params)
            # The loss and the embed/head gradients summed over pp (with
            # replicated I/O every rank holds them whole already).
            flat = torch.cat([loss.detach().reshape(1)]
                             + [gr.reshape(-1) for gr in grads[:4]])
            flat = eager.allreduce(pp, flat) if sharded else flat
            off = 1
            with torch.no_grad():
                for i, p in enumerate(params):
                    gr = grads[i]
                    if i < 4:
                        gr = flat[off:off + p.numel()].view(p.shape)
                        off += p.numel()
                    p.sub_(args.lr * gr)
            return float(flat[0])

        ds = synthetic_mnist(n=args.limit)
        it = ShardedIterator(ds, global_batch=args.batch, num_shards=1)
        epoch_losses, step_s = [], []
        for epoch in range(args.epochs):
            meter = AverageValueMeter()
            for xb, yb in it:
                t0 = time.perf_counter()
                loss = step(torch.from_numpy(xb[0]).to(device),
                            torch.from_numpy(yb[0]).to(device).long())
                meter.add(loss)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_s.append(time.perf_counter() - t0)
            epoch_losses.append(meter.mean)
            if rank == 0:
                print(f"epoch {epoch}: loss {meter.mean:.4f}", flush=True)

        hits = n_seen = 0
        with torch.no_grad():
            for xb, yb in ShardedIterator(ds, global_batch=args.batch,
                                          num_shards=1, shuffle=False):
                x = torch.from_numpy(xb[0]).to(device)
                logits, rows = logits_and_rows(x)
                pred = logits.argmax(-1).cpu().numpy()
                hits += int(np.sum(pred == yb[0][rows]))
                n_seen += len(pred)
        counts = torch.tensor([hits, n_seen], dtype=torch.float64,
                              device=device)
        counts = eager.allreduce(pp, counts) if sharded else counts
        acc = float(counts[0] / counts[1])
        if rank == 0:
            print(f"final accuracy {100 * acc:.2f}%", flush=True)
        return {"rank": rank, "stages": S, "epoch_losses": epoch_losses,
                "accuracy": acc, "step_s": step_s,
                "devices": sorted({str(p.device) for p in params})}
    finally:
        mpi.stop()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("mnist_pipeline: no CUDA device is available; pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 2
    if args.nproc:
        from torchmpi_tpu_torch.runtime import launch

        launch.spawn(args.nproc, run, (args,))
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
