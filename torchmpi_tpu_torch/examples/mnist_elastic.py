"""Elastic data-parallel MNIST: a lost rank mid-training is survived by a
checkpoint restore and a re-formed, smaller world (``runtime/failure.
run_elastic``).  The port of ``examples/mnist/mnist_elastic.py``:

    python -m torchmpi_tpu_torch.examples.mnist_elastic --nproc 4
    python -m torchmpi_tpu_torch.examples.mnist_elastic --device cpu \\
        --nproc 4 --survivors 2 --steps 30 --fail-at 12

The flow every rank runs:

1. train config 1 (the MLP 784-1024-1024-10 in f32, ``compiled``)
   through ``AllReduceSGDEngine`` over all ``--nproc`` ranks, rank 0
   checkpointing every ``--ckpt-every`` steps;
2. an injected fault fires on every rank at step ``--fail-at``
   (``FaultInjector``; a lost process raises the same class of error on
   the survivors);
3. ``run_elastic`` tears the world down, the first ``--survivors`` ranks
   start a fresh one (the others leave), agree on the latest checkpoint,
   restore it and train on from the step after it.

``--nproc p`` spawns the p ranks itself; under ``torchrun`` each process is
one rank.  On a GPU every rank binds ``cuda:LOCAL_RANK % device_count``;
``--device cpu`` runs on the CPU over gloo.  The ranks need a checkpoint
directory they all see (``--ckpt-dir``, default a fresh temporary one).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=128,
                    help="global batch size")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--fail-at", type=int, default=25,
                    help="step at which the injected fault fires")
    ap.add_argument("--survivors", type=int, default=2,
                    help="ranks left after the fault (elastic shrink)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: this process is one "
                         "rank, as under torchrun)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial parameters")
    return ap.parse_args(argv)


def make_build(args, ds, device, on_step=None):
    """The example's ``build(ranks, restored)`` for ``run_elastic``: the
    engine and the data sharding over the started world, the parameters
    from ``restored`` or the seed.  ``on_step(step, state, p)`` is called
    after every step."""
    import numpy as np

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    def build(ranks, restored):
        comm = mpi.stack.world()
        p = comm.size
        lead = comm.rank == 0
        if lead:
            print(f"[elastic] (re)built over {p} ranks"
                  f"{' from checkpoint' if restored is not None else ''}",
                  flush=True)
        engine = AllReduceSGDEngine(mlp.loss_fn, lr=args.lr, comm=comm,
                                    mode="compiled",
                                    sync_parameters_on_start=False)
        # The largest multiple of p not above --batch: a world re-formed
        # at a p that does not divide it (3 of 128) keeps equal shards.
        batches = list(ShardedIterator(ds, global_batch=args.batch
                                       - args.batch % p, num_shards=p,
                                       seed=3))
        params = ({k: v.to(device) for k, v in restored["params"].items()}
                  if restored is not None
                  else mlp.init(args.seed, device=device))

        def step_fn(state, step):
            out = engine.train(state["params"],
                               [batches[step % len(batches)]])
            new = {"params": out["params"], "loss": out["loss"]}
            if step % 10 == 0 and lead:
                print(f"step {step}: loss {float(out['loss']):.4f} "
                      f"({p} ranks)", flush=True)
            if on_step is not None:
                on_step(step, new, p)
            return new

        return {"params": params, "loss": np.inf}, step_fn

    return build


def run(args, on_step=None) -> dict:
    """One rank's run; returns its numbers and, on a survivor, its final
    parameters on the host (``departed`` for a rank the shrink left
    out).  ``on_step`` as in :func:`make_build`."""
    import numpy as np
    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.runtime import FaultInjector, run_elastic
    from torchmpi_tpu_torch.utils.checkpoint import CheckpointManager
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    device = mpi.start(device=args.device)
    p0 = mpi.size()
    if not 0 < args.survivors <= p0:
        raise SystemExit(f"--survivors must be in (0, {p0}]")
    for p in (p0, args.survivors):
        if args.batch % p:
            raise SystemExit(f"--batch {args.batch} must be divisible by "
                             f"{p} (rank count before and after shrink)")
    manager = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every)
    build = make_build(args, synthetic_mnist(n=8192), device, on_step)
    members = {"ranks": list(range(p0))}

    def healthy():
        members["ranks"] = members["ranks"][:args.survivors]
        return members["ranks"]

    me = mpi.rank()
    injector = (FaultInjector([args.fail_at])
                if 0 <= args.fail_at < args.steps else None)
    try:
        out = run_elastic(
            build, manager, n_steps=args.steps, injector=injector,
            healthy_ranks=healthy,
            on_restart=lambda n, exc: me == 0 and print(
                f"[elastic] restart {n}: {type(exc).__name__}: {exc}",
                flush=True))
        if out["departed"]:
            print(f"[elastic] rank {me} left the world", flush=True)
            return {"rank": me, "departed": True,
                    "restarts": out["restarts"]}
        loss = float(out["state"]["loss"])
        final = mpi.size()
        if mpi.rank() == 0:
            print(f"done: {out['steps_run']} steps, {out['restarts']} "
                  f"restart(s), final loss {loss:.4f} on {final} ranks",
                  flush=True)
        assert np.isfinite(loss)
        if injector is not None:
            assert out["restarts"] >= 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return {"rank": me, "departed": False, "loss": loss,
                "steps_run": out["steps_run"], "restarts": out["restarts"],
                "size": final,
                "params": {k: v.detach().cpu()
                           for k, v in out["state"]["params"].items()}}
    finally:
        mpi.stop()


def _spawned_rank(args) -> None:
    """A spawned rank's run.  Its numbers stay in the rank: the parameters
    it returns are tensors, which a queue passes as shared-memory handles
    that die with the rank."""
    if args.device is not None:
        import torch

        if torch.device(args.device).type == "cpu":
            # The ranks share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // max(1, args.nproc)))
    run(args)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("mnist_elastic: no CUDA device is available; pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 2
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="mnist_elastic_")
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
