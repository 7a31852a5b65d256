"""MNIST asynchronous SGD through the sharded parameter server — the
Downpour and EASGD configurations (reference:
examples/mnist/mnist_parameterserver_dsgd.lua and
mnist_parameterserver_easgd.lua; BASELINE config 3, "MNIST async-SGD via
parameter-server shard"): local SGD on the worker, with periodic push/pull
cycles against parameter shards spread over CPU-side servers.  The port of
``examples/mnist/mnist_parameterserver.py``:

    python -m torchmpi_tpu_torch.examples.mnist_parameterserver --rule easgd
    python -m torchmpi_tpu_torch.examples.mnist_parameterserver \\
        --device cpu --data synthetic --limit 2048 --epochs 2

``--servers K`` starts K shard servers in this process behind loopback
endpoints (the reference's ``mpirun -n K`` on one machine); multi-host
deployments pass ``--endpoints host:port,...`` instead.  The model lives
on the card (``--device cpu``: on the CPU); its parameters cross to the
servers through pinned host mirrors (``parameterserver/update.py``).
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
    ap.add_argument("--rule", default="downpour",
                    choices=["downpour", "easgd"])
    ap.add_argument("--servers", type=int, default=4,
                    help="in-process shard servers (single-host stand-in)")
    ap.add_argument("--endpoints", default=None,
                    help="comma-separated host:port shard servers "
                         "(multi-host)")
    ap.add_argument("--update-frequency", type=int, default=4)
    ap.add_argument("--data", default="auto",
                    choices=["auto", "real", "synthetic"],
                    help="real MNIST (cached or downloaded), synthetic, or "
                         "auto (real when available)")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the training samples (0 = all)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    return ap.parse_args(argv)


def run(args, record: list = None) -> dict:
    """The worker's run; returns its numbers (``counters``: the native
    client's and servers' counters over this run).  With ``record`` (a
    list), appends the registered values (``("seed", [tensors])``) and
    every vector pushed with the 'add' rule (``("add", [tensors])``),
    host copies, in order."""
    import numpy as np
    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import parameterserver as ps
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.parameterserver import native
    from torchmpi_tpu_torch.parameterserver.update import (DownpourUpdate,
                                                           EASGDUpdate)
    from torchmpi_tpu_torch.utils.data import ShardedIterator, load_mnist
    from torchmpi_tpu_torch.utils.meters import AverageValueMeter

    device = mpi.start(device=args.device)
    try:
        if args.endpoints:
            endpoints = [(h, int(p)) for h, p in
                         (e.split(":") for e in args.endpoints.split(","))]
            ps.init_cluster(endpoints=endpoints)
        else:
            L = native.lib()
            sids = [L.tmpi_ps_server_start(0) for _ in range(args.servers)]
            endpoints = [("127.0.0.1", L.tmpi_ps_server_port(s))
                         for s in sids]
            ps.init_cluster(endpoints=endpoints, start_server=False)
        print(f"parameter server: {len(endpoints)} shard servers", flush=True)
        # The native counters are monotonic over the process: this run's
        # are the difference.
        counters0 = native.counters()

        ds, source = load_mnist("train", prefer=args.data, limit=args.limit)
        print(f"data={source}", flush=True)
        it = ShardedIterator(ds, global_batch=args.batch, num_shards=1)
        params = mlp.init(0, device=device)
        if args.rule == "downpour":
            upd = DownpourUpdate(lr=args.lr, init_delay=1,
                                 update_frequency=args.update_frequency)
        else:
            # size = EASGD CLIENT count (each process is one worker here).
            upd = EASGDUpdate(beta=0.9, size=mpi.process_count(),
                              init_delay=1,
                              update_frequency=args.update_frequency)
        if record is not None:
            _record(upd, record)

        leaves = list(params.values())
        for t in leaves:
            t.requires_grad_(True)
        step, step_s, epoch_losses = 0, [], []
        for epoch in range(args.epochs):
            meter = AverageValueMeter()
            for xb, yb in it:
                t0 = time.perf_counter()
                x = torch.from_numpy(xb.reshape(-1, *xb.shape[2:])).to(device)
                y = torch.from_numpy(yb.reshape(-1)).to(device)
                loss = mlp.loss_fn(params, (x, y))
                grads = dict(zip(params, torch.autograd.grad(loss, leaves)))
                with torch.no_grad():
                    for k, g in grads.items():
                        params[k].sub_(g * args.lr)
                params = upd.update(params, grads, step)
                meter.add(float(loss.detach()))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_s.append(time.perf_counter() - t0)
                step += 1
            epoch_losses.append(meter.mean)
            print(f"epoch {epoch}: loss {meter.mean:.4f}", flush=True)
        params = upd.flush(params)

        # The test split of the training data's provenance.
        test_ds, _ = load_mnist("test", prefer=source)
        test_it = ShardedIterator(test_ds, global_batch=args.batch,
                                  num_shards=1, shuffle=False)
        with torch.no_grad():
            accs = [float(mlp.accuracy(params, (
                torch.from_numpy(x.reshape(-1, *x.shape[2:])).to(device),
                torch.from_numpy(y.reshape(-1)).to(device))))
                for x, y in test_it]
        acc = float(np.mean(accs))
        print(f"final accuracy {100 * acc:.2f}%", flush=True)
        center = ps.integrate_tensors(ps.prefetch_tensors(upd.tensors),
                                      {k: v.detach().cpu()
                                       for k, v in params.items()})
        return {"rule": args.rule, "steps": step, "step_s": step_s,
                "epoch_losses": epoch_losses, "accuracy": acc,
                "data": source, "stats": dict(upd.stats),
                "counters": {k: v - counters0[k]
                             for k, v in native.counters().items()},
                "client_counters": ps.client_counters(),
                "devices": sorted({str(t.device) for t in params.values()}),
                "center": center}
    finally:
        mpi.stop()


def _record(upd, record: list) -> None:
    """Wrap the driver's registration and push to log host copies."""
    from torchmpi_tpu_torch.utils import tree as _tree

    shard, push = upd._shard, upd._push

    def logged_shard(params):
        record.append(("seed", [t.detach().to("cpu", copy=True)
                                for t in _tree.leaves(params)]))
        shard(params)

    def logged_push(deltas):
        record.append(("add", [d.clone() for d in deltas]))
        push(deltas)

    upd._shard, upd._push = logged_shard, logged_push


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("mnist_parameterserver: no CUDA device is available; pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
