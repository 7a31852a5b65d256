"""Model-parallel MNIST — the reference's MPLinear example (reference:
examples/mnist/mnist_modelparallel.lua:28-55): the hidden Linear's input
dimension is sharded across the tp axis; each rank computes a partial
product and the activations are summed forward over tp
(``parallel/tp.py``: ``make_mp_linear``).  The port of
``examples/mnist/mnist_modelparallel.py``:

    python -m torchmpi_tpu_torch.examples.mnist_modelparallel --nproc 2
    python -m torchmpi_tpu_torch.examples.mnist_modelparallel --nproc 2 \\
        --device cpu --limit 2048 --epochs 2

``--nproc p`` spawns the p ranks itself (one mesh axis ``tp`` of p);
under ``torchrun`` each process is one rank.  Every rank reads the same
synthetic batches; the output head is replicated.  Each rank
differentiates its own program: the weight gradients of its shard come
from its own features, the replicated head's are the same on every rank,
so no gradient needs a sum.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--hidden", type=int, default=1024)
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
    from torchmpi_tpu_torch.parallel import make_mesh, tp
    from torchmpi_tpu_torch.utils.data import ShardedIterator, synthetic_mnist
    from torchmpi_tpu_torch.utils.meters import AverageValueMeter

    device = mpi.start(device=args.device)
    try:
        mesh = make_mesh({"tp": -1})
        p = mesh.shape["tp"]
        rank = mpi.rank()
        if rank == 0:
            print(f"model parallel over tp={p}", flush=True)
        layer1 = tp.shard_mp_linear(
            tp.mp_linear_init(0, 784, args.hidden, device=device),
            mesh)
        layer2 = tp.mp_linear_init(1, args.hidden, 10,
                                   device=device)   # small head: replicated
        params = [layer1["w"], layer1["b"], layer2["w"], layer2["b"]]
        for t in params:
            t.requires_grad_(True)
        mp_fwd = tp.make_mp_linear(mesh, activation=F.relu)

        def logits(x):
            h = mp_fwd(layer1, x.reshape(x.shape[0], -1))
            return h @ layer2["w"] + layer2["b"]

        ds = synthetic_mnist(n=args.limit)
        it = ShardedIterator(ds, global_batch=args.batch, num_shards=1)
        epoch_losses, step_s = [], []
        for epoch in range(args.epochs):
            meter = AverageValueMeter()
            for xb, yb in it:
                t0 = time.perf_counter()
                x = torch.from_numpy(xb[0]).to(device)
                y = torch.from_numpy(yb[0]).to(device).long()
                loss = F.cross_entropy(logits(x), y)
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    for t, g in zip(params, grads):
                        t.sub_(g * args.lr)
                meter.add(float(loss.detach()))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_s.append(time.perf_counter() - t0)
            epoch_losses.append(meter.mean)
            if rank == 0:
                print(f"epoch {epoch}: loss {meter.mean:.4f}", flush=True)

        accs = []
        with torch.no_grad():
            for xb, yb in ShardedIterator(ds, global_batch=args.batch,
                                          num_shards=1, shuffle=False):
                x = torch.from_numpy(xb[0]).to(device)
                pred = logits(x).argmax(-1).cpu().numpy()
                accs.append(float(np.mean(pred == yb[0])))
        acc = float(np.mean(accs))
        if rank == 0:
            print(f"final accuracy {100 * acc:.2f}%", flush=True)
        return {"rank": rank, "tp": p, "epoch_losses": epoch_losses,
                "accuracy": acc, "step_s": step_s,
                "devices": sorted({str(t.device) for t in params})}
    finally:
        mpi.stop()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("mnist_modelparallel: no CUDA device is available; pass "
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
