"""Data-parallel ResNet training: one process per rank, gradients synced
every step.

    python -m torchmpi_tpu_torch.examples.train_resnet --nproc 2
    torchrun --nproc-per-node 2 -m torchmpi_tpu_torch.examples.train_resnet

``--nproc p`` spawns the p ranks itself (``runtime.launch``); under
``torchrun`` each process is one rank.  On a GPU
every rank binds ``cuda:LOCAL_RANK % device_count``; ``--device cpu`` runs
on the CPU over gloo.  ``--mode compiled`` follows
``use_pallas_collectives`` (``runtime.config``, off by default) as the JAX
example does: off, it is GSPMD over the global batch (batch norm's
statistics span the ranks, the gradients are averaged with one
``torch.distributed`` allreduce); on, the gradients ring through the ring
kernels and batch norm is per rank.  ``--mode eager_sync`` syncs them
through ``nn.synchronize_gradients``; ``--mode eager_async`` as async
bucket allreduces drained per ``--async-drain`` (``ready``: each bucket's
parameters update as its collective completes; ``barrier``: after all of
them), through the ring kernels above the small-message cutoff when the
knob is on; the compiled mode reads its batches through a
``DataPipeline``.  The data is ``synthetic_mnist`` at the image size asked
for.  Every ``--stats-every`` steps the BN running statistics are
refreshed from the last global batch (every rank's rows, so every rank
holds the same statistics), and the run ends with an inference-mode
evaluation.  ``--ckpt-dir`` saves the parameters and the BN statistics
every ``--ckpt-every`` steps and at the end, asynchronously, and a rerun
with the same directory resumes from the latest save.  The defaults are a small net on 32x32 images; ``--depth 50
--width 1.0 --image 224 --classes 1000`` is ResNet-50 at full width.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image", type=int, default=32)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32,
                    help="images per rank and step")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--mode", choices=("compiled", "eager_sync",
                                       "eager_async"), default="compiled")
    ap.add_argument("--async-drain", choices=("ready", "barrier"),
                    default="ready",
                    help="how eager_async drains its bucket allreduces")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: this process is one "
                         "rank, as under torchrun)")
    ap.add_argument("--stats-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="enable periodic async checkpointing and resume")
    ap.add_argument("--ckpt-every", type=int, default=20)
    return ap.parse_args(argv)


def run(args) -> dict:
    """One rank's run; returns its final numbers and its BN running
    statistics (numpy leaves in tree order)."""
    import torch

    from torchmpi_tpu_torch.data import DataPipeline
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine, sample_array
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.runtime import communicator, config, lifecycle
    from torchmpi_tpu_torch.utils import checkpoint as ckpt
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import (ShardedIterator, resume_at,
                                               synthetic_mnist)

    config.set("engine_async_drain", args.async_drain)
    device = lifecycle.start(device=args.device)
    try:
        p, rank = lifecycle.size(), lifecycle.rank()
        cfg = resnet.config(depth=args.depth, n_classes=args.classes,
                            width_multiplier=args.width)
        n = max(p * args.batch * args.steps, p * args.batch)
        ds = synthetic_mnist(n=n, n_classes=args.classes, seed=args.seed,
                             image_shape=(args.image, args.image, 3))
        params, bn_state = resnet.init(args.seed, cfg, device=device)
        update_stats = resnet.make_update_stats_fn(
            cfg, comm=communicator.stack.current())
        box = {"state": bn_state, "x": None}

        mgr, start_step, hooks = None, 0, {}
        if args.ckpt_dir:
            mgr = ckpt.AsyncCheckpointManager(args.ckpt_dir,
                                              save_interval=args.ckpt_every)
            step0 = ckpt.agreed_latest_step(args.ckpt_dir)
            if step0 is not None:
                # The BN statistics resume with the parameters: trained
                # parameters beside fresh statistics evaluate to garbage.
                tree, meta = ckpt.restore(
                    args.ckpt_dir, {"params": params, "stats": bn_state},
                    step=step0, strict=False)
                params, box["state"] = tree["params"], tree["stats"]
                start_step = int(meta.get("t", meta["step"]))
                if rank == 0:
                    print(f"resumed from step {start_step}", flush=True)
            hooks = ckpt.checkpoint_hooks(
                mgr, extra=lambda s: {"stats": box["state"]})

        base = ShardedIterator(ds, global_batch=p * args.batch, num_shards=p,
                               seed=args.seed)
        epochs = max(1, -(-args.steps // len(base)))
        it, done_epochs = resume_at(base, start_step)
        if args.mode == "compiled":
            it = DataPipeline(it, communicator.stack.current())

        def on_sample(state):
            box["x"] = sample_array(state)[0]

        def on_update(state):
            if state["t"] % args.stats_every == 0:
                x = torch.as_tensor(box["x"]).to(device)
                box["state"] = update_stats(state["params"], box["state"], x)
            if rank == 0:
                print(f"step {state['t']}: loss {float(state['loss']):.4f}",
                      flush=True)
            if "on_update" in hooks:
                hooks["on_update"](state)

        engine = AllReduceSGDEngine(
            resnet.make_loss_fn(cfg), lr=args.lr, mode=args.mode,
            hooks={**hooks, "on_sample": on_sample, "on_update": on_update})
        state = engine.train(params, it, epochs=epochs - done_epochs,
                             start_step=start_step)
        if mgr is not None:
            mgr.close()
        eval_it = ShardedIterator(ds, global_batch=p * args.batch,
                                  num_shards=p, shuffle=False)
        acc = engine.test(state["params"], eval_it,
                          resnet.make_accuracy_fn(cfg, box["state"]))
        out = {"rank": rank, "size": p, "steps": state["t"],
               "loss": state["loss_meter"].mean, "accuracy": acc,
               "device": str(device),
               "bn_stats": [t.cpu().numpy() for t in tree.leaves(box["state"])]}
        if rank == 0:
            print(f"final train loss {out['loss']:.4f}, inference-mode "
                  f"accuracy {acc * 100:.2f}%", flush=True)
        return out
    finally:
        lifecycle.stop()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("train_resnet: no CUDA device is available; pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 2
    if args.nproc:
        from torchmpi_tpu_torch.runtime import launch

        if args.device != "cpu":
            from torchmpi_tpu_torch import _build

            _build.build("ring")     # once, before the ranks load it
        launch.spawn(args.nproc, run, (args,))
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
