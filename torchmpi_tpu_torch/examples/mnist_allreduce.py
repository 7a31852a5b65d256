"""Synchronous data-parallel MNIST — the reference's flagship example: start,
shard the data by rank, broadcast the initial parameters, allreduce the
gradients every step, SGD, and assert the replicas' consistency during
training.  The port of ``examples/mnist/mnist_allreduce.py``:

    python -m torchmpi_tpu_torch.examples.mnist_allreduce --nproc 2
    python -m torchmpi_tpu_torch.examples.mnist_allreduce --nproc 2 \\
        --device cpu --data synthetic --limit 2048 --epochs 2
    torchrun --nproc-per-node 2 -m torchmpi_tpu_torch.examples.mnist_allreduce

``--nproc p`` spawns the p ranks itself; under ``torchrun`` each process is
one rank.  On a GPU every rank binds ``cuda:LOCAL_RANK % device_count``;
``--device cpu`` runs on the CPU over gloo.  The model is the MLP
784-1024-1024-10 in f32.  ``--mode compiled`` reads its batches through a
``DataPipeline`` and rings the gradients through the ring kernels
(``use_pallas_collectives`` on: w0 and w1 ring alone, the other four
leaves in one tail bucket, 3 rings a step); ``eager_sync`` syncs them with
``nn.synchronize_gradients``; ``eager_async`` dispatches their bucket as an
async allreduce (through the ring kernel above the small-message cutoff).
The eager modes check the replicas every 10 steps and at the end.
``--ckpt-dir`` saves every ``--ckpt-every`` steps and at the end, and a
rerun with the same directory resumes where the last save left off.
"""

from __future__ import annotations

import argparse
import sys

CHECK_FREQUENCY = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128,
                    help="global batch size")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--mode", default="compiled",
                    choices=["compiled", "eager_sync", "eager_async"])
    ap.add_argument("--data", default="auto",
                    choices=["auto", "real", "synthetic"],
                    help="real MNIST (cached or downloaded), synthetic, or "
                         "auto (real when available)")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the training samples (0 = all)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: this process is one "
                         "rank, as under torchrun)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial parameters and the shuffle")
    ap.add_argument("--ckpt-dir", default="",
                    help="save checkpoints here and resume from the latest")
    ap.add_argument("--ckpt-every", type=int, default=20)
    return ap.parse_args(argv)


def run(args, hooks=None) -> dict:
    """One rank's run; returns its numbers.  ``hooks``: more engine hooks,
    each called after the example's own of the same name."""
    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.data import DataPipeline
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.utils import checkpoint as ckpt
    from torchmpi_tpu_torch.utils.data import (ShardedIterator, load_mnist,
                                               resume_at)

    mpi.config.set("use_pallas_collectives", args.mode != "eager_sync")
    device = mpi.start(device=args.device)
    try:
        p, rank = mpi.size(), mpi.rank()
        ds, source = load_mnist("train", prefer=args.data, limit=args.limit)
        print(f"[proc {mpi.process_rank()}/{mpi.process_count()}] ranks={p} "
              f"device={device} mode={args.mode} data={source}", flush=True)
        params = mlp.init(args.seed, device=device)

        mgr, start_step, own = None, 0, {}
        if args.ckpt_dir:
            mgr = ckpt.AsyncCheckpointManager(args.ckpt_dir,
                                              save_interval=args.ckpt_every)
            params, _, start_step = ckpt.resume_or_init(mgr, params)
            if start_step and rank == 0:
                print(f"resumed from step {start_step}", flush=True)
            own = ckpt.checkpoint_hooks(mgr)

        it, done_epochs = resume_at(
            ShardedIterator(ds, global_batch=args.batch, num_shards=p,
                            seed=args.seed), start_step)
        if args.mode == "compiled":
            it = DataPipeline(it, mpi.stack.current())

        losses = []

        def on_update(state):
            losses.append(state["loss"].detach())

        def on_end_epoch(state):
            if rank == 0:
                mean, std = state["loss_meter"].value()
                print(f"epoch {done_epochs + state['epoch']}: loss "
                      f"{mean:.4f} (+-{std:.4f})", flush=True)

        own = {**own, "on_end_epoch": on_end_epoch,
               "on_update": _chain(own.get("on_update"), on_update)}
        for name, fn in (hooks or {}).items():
            own[name] = _chain(own.get(name), fn)
        engine = AllReduceSGDEngine(mlp.loss_fn, lr=args.lr, mode=args.mode,
                                    hooks=own,
                                    check_frequency=CHECK_FREQUENCY)
        state = engine.train(params, it, epochs=args.epochs - done_epochs,
                             start_step=start_step)
        if mgr is not None:
            mgr.close()

        # Held out: the test split of the training data's provenance.
        test_ds, _ = load_mnist("test", prefer=source)
        test_it = ShardedIterator(test_ds, global_batch=args.batch,
                                  num_shards=p, shuffle=False)
        acc = engine.test(state["params"], test_it, mlp.accuracy)
        out = {"rank": rank, "size": p, "steps": state["t"],
               "losses": [float(x) for x in losses],
               "loss": state["loss_meter"].mean, "accuracy": acc,
               "data": source, "device": str(device),
               "stage": (it.stats.snapshot()
                         if isinstance(it, DataPipeline) else None)}
        if rank == 0:
            print(f"final train loss {out['loss']:.4f}, accuracy "
                  f"{acc * 100:.2f}%", flush=True)
        if args.mode != "compiled":
            mpinn.check_with_allreduce(state["params"])
            if rank == 0:
                print("replica consistency check passed", flush=True)
        out["params"] = {k: v.detach().cpu() for k, v in
                         state["params"].items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out
    finally:
        mpi.stop()


def _chain(first, second):
    if first is None:
        return second

    def both(state):
        first(state)
        second(state)

    return both


def _spawned_rank(args) -> None:
    """A spawned rank's run.  Its numbers stay in the rank: the parameters
    it returns are tensors, which a queue passes as shared-memory handles
    that die with the rank."""
    run(args)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("mnist_allreduce: no CUDA device is available; pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 2
    if args.nproc:
        from torchmpi_tpu_torch.runtime import launch

        if args.device != "cpu":
            from torchmpi_tpu_torch import _build

            _build.build("ring")     # once, before the ranks load it
        launch.spawn(args.nproc, _spawned_rank, (args,))
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
