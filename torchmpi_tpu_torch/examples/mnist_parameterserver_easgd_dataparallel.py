"""MNIST EASGD composed with synchronous data parallelism (reference:
examples/mnist/mnist_parameterserver_easgd_dataparallel.lua): workers are
partitioned into DP groups of ``--div`` consecutive ranks (an unequal last
group, like the reference's ceil((rank+1)/div) keying at :28-34).  Within
a group every step runs synchronous DP (gradients ring-allreduced over the
host plane, the port's ``HostCommunicator``); only the group's DP-rank-0
is an EASGD (or Downpour) parameter-server client, and after each
integration the integrated parameters are broadcast over the DP plane
(``EASGDUpdate(dp=...)``).  The port of
``examples/mnist/mnist_parameterserver_easgd_dataparallel.py``:

    python -m torchmpi_tpu_torch.examples.\\
mnist_parameterserver_easgd_dataparallel --nproc 4 --div 3
    ... --device cpu --nproc 3 --div 2 --epochs 2 --limit 2048

The launcher hosts the PS shard servers (``--servers``), then spawns
``--nproc`` workers (``runtime/launch.py``); on a GPU every worker binds
the card (``cuda:LOCAL_RANK % device_count``) and keeps its model there.
A DP group checks that its replicas are equal after every integration and
at the end (the reference's checkWithAllreduce, scoped to the DP plane).
"""

from __future__ import annotations

import argparse
import sys
import time


# Every host-ring wait's no-progress deadline: a stalled peer raises.
IO_DEADLINE_MS = 60_000


def group_members(pid: int, nproc: int, div: int):
    """DP group = ``div`` consecutive ranks (reference :28-34 keying)."""
    gid = pid // div
    return gid, [r for r in range(nproc) if r // div == gid]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--div", type=int, default=3,
                    help="DP group width (unequal last group, like the ref)")
    ap.add_argument("--rule", default="easgd",
                    choices=["downpour", "easgd"])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--tau", type=int, default=4,
                    help="PS communication cycle length (EASGD paper)")
    ap.add_argument("--init-delay", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--limit", type=int, default=8192,
                    help="synthetic training samples")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    return ap.parse_args(argv)


def _replicas_equal(group, params) -> bool:
    import torch

    local = torch.cat([t.detach().float().cpu().reshape(-1)
                       for t in params.values()])
    summed = local.clone()
    group.allreduce(summed)
    return bool(torch.allclose(summed, group.size * local, atol=1e-5))


def worker(args, world_ports, group_ports, ps_endpoints) -> dict:
    """One worker (a spawned rank)."""
    import numpy as np
    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import parameterserver as ps
    from torchmpi_tpu_torch.collectives.hostcomm import HostCommunicator
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.parameterserver.update import (DownpourUpdate,
                                                           EASGDUpdate)
    from torchmpi_tpu_torch.utils.data import ShardedIterator, synthetic_mnist
    from torchmpi_tpu_torch.utils.meters import AverageValueMeter

    device = mpi.start(device=args.device)
    pid, nproc = mpi.rank(), args.nproc
    dl = IO_DEADLINE_MS
    world = HostCommunicator(pid, nproc, [("127.0.0.1", p)
                                          for p in world_ports],
                             io_deadline_ms=dl)
    gid, members = group_members(pid, nproc, args.div)
    n_groups = (nproc + args.div - 1) // args.div
    group = None
    if len(members) > 1:
        group = HostCommunicator(
            members.index(pid), len(members),
            [("127.0.0.1", group_ports[m]) for m in members],
            io_deadline_ms=dl)
    try:
        ps.init_cluster(endpoints=ps_endpoints, start_server=False)
        # Same seed everywhere == the reference's synchronizeParameters.
        params = mlp.init(args.seed, device=device)
        if args.rule == "easgd":
            upd = EASGDUpdate(beta=args.beta, size=n_groups,
                              init_delay=args.init_delay,
                              update_frequency=args.tau,
                              rank=gid, fence=world.barrier, dp=group)
        else:
            upd = DownpourUpdate(lr=args.lr, init_delay=args.init_delay,
                                 update_frequency=args.tau,
                                 rank=gid, fence=world.barrier, dp=group)

        def dp_mean_grads(grads):
            """Synchronous DP inside the group: a host-plane allreduce of
            every gradient leaf (owned host copies), then the mean."""
            if group is None:
                return grads
            out = {}
            for k, g in grads.items():
                a = g.detach().to("cpu", torch.float32, copy=True)
                group.allreduce(a)
                out[k] = (a * (1.0 / len(members))).to(g.device, g.dtype)
            return out

        ds = synthetic_mnist(n=args.limit)
        it = ShardedIterator(ds, global_batch=args.batch * nproc,
                             num_shards=nproc)
        leaves = list(params.values())
        for t in leaves:
            t.requires_grad_(True)
        step, step_s, checks, epoch_losses = 0, [], 0, []
        for epoch in range(args.epochs):
            meter = AverageValueMeter()
            for xb, yb in it:
                t0 = time.perf_counter()
                x = torch.from_numpy(xb[pid]).to(device)
                y = torch.from_numpy(yb[pid]).to(device)
                loss = mlp.loss_fn(params, (x, y))
                grads = dict(zip(params, torch.autograd.grad(loss, leaves)))
                grads = dp_mean_grads(grads)
                with torch.no_grad():
                    for k, g in grads.items():
                        params[k].sub_(g * args.lr)
                params = upd.update(params, grads, step)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_s.append(time.perf_counter() - t0)
                if group is not None and upd.broadcast_last_step:
                    assert _replicas_equal(group, params), \
                        f"DP group {gid} replicas diverged at step {step}"
                    checks += 1
                meter.add(float(loss.detach()))
                step += 1
            epoch_losses.append(meter.mean)
            if pid == 0:
                print(f"epoch {epoch}: loss {meter.mean:.4f}", flush=True)
        params = upd.flush(params)
        if group is not None:
            assert _replicas_equal(group, params), \
                "DP group replicas diverged after the final broadcast"
            checks += 1
            if members.index(pid) == 0:
                print(f"group {gid}: replica consistency check passed",
                      flush=True)

        test_it = ShardedIterator(ds, global_batch=args.batch, num_shards=1,
                                  shuffle=False)
        with torch.no_grad():
            accs = [float(mlp.accuracy(params, (
                torch.from_numpy(x.reshape(-1, *x.shape[2:])).to(device),
                torch.from_numpy(y.reshape(-1)).to(device))))
                for x, y in test_it]
        acc = torch.tensor([np.mean(accs)], dtype=torch.float32)
        world.allreduce(acc)   # the mean worker accuracy
        if pid == 0:
            print(f"final accuracy {100 * float(acc[0]) / nproc:.2f}%",
                  flush=True)
        world.barrier()
        return {"rank": pid, "group": gid, "client": upd._client,
                "epoch_losses": epoch_losses,
                "accuracy": float(acc[0]) / nproc, "replica_checks": checks,
                "step_s": step_s, "stats": dict(upd.stats),
                "devices": sorted({str(t.device) for t in params.values()})}
    finally:
        world.close()
        if group is not None:
            group.close()
        mpi.stop()


def launch(args) -> list:
    """Host the shard servers here and run the workers; returns their
    results in rank order."""
    from torchmpi_tpu_torch import parameterserver as ps
    from torchmpi_tpu_torch.collectives.hostcomm import free_ports
    from torchmpi_tpu_torch.parameterserver import native
    from torchmpi_tpu_torch.runtime import launch as _launch

    L = native.lib()
    sids = [L.tmpi_ps_server_start(0) for _ in range(args.servers)]
    try:
        eps = [("127.0.0.1", L.tmpi_ps_server_port(s)) for s in sids]
        # One draw for both planes: distinctness holds within one call.
        ports = free_ports(2 * args.nproc)
        return _launch.spawn(args.nproc, worker,
                             (args, ports[:args.nproc], ports[args.nproc:],
                              eps), timeout_s=900)
    finally:
        ps.shutdown()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("mnist_parameterserver_easgd_dataparallel: no CUDA device "
                  "is available; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
    launch(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
