"""Llama training: the port's counterpart of ``examples/llama/train_llama.py``.

    python -m torchmpi_tpu_torch.examples.train_llama [--preset tiny|8b]
        [--dp N] [--tp N] [--sp N]
        [--attn full|flash|ring|ring-zigzag|ring-xla]
        [--remat none|dots|full] [--loss-chunk N] [--generate N]
        [--device cpu]

Plain SGD over a synthetic Markov corpus (no download): the loss must fall,
and ``--generate N`` then scores how many generated transitions are legal
under the corpus' table.  Runs on the current CUDA device in bf16 unless
``--device`` names another; on the CPU in f32 (low precision on the
accelerator, as the JAX example does).  8B-scale memory controls are on by
default: ``--remat dots`` always, and for ``--preset 8b`` the chunked
vocab loss (``--loss-chunk``, auto 512; 0 forces the dense loss).

``--dp``/``--tp``/``--sp`` (or a ring attention mode) train on a dp x sp x
tp mesh: one rank per mesh position, spawned here (``runtime/launch``), a
gloo world on the CPU with ``--device cpu``, and on one card every rank on
that card (each rank holds its own shards and runs its own collectives).
Ring attention needs an sp axis (``--sp``, default 2 with a ring mode).
Every rank draws the same weights and batches; rank 0 prints.  The
mixture-of-experts and pipeline flags wait for their slices of the port.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import llama


def synthetic_tokens(cfg, n_seq, seq_len, seed=0):
    """A learnable synthetic corpus: order-1 Markov chains over the vocab so
    next-token loss genuinely falls below ln(vocab) (zero-egress stand-in
    for a tokenized dataset).  Returns ``(tokens, table)``; the transition
    table doubles as a generation-quality oracle (--generate)."""
    rng = np.random.RandomState(seed)
    # Each token deterministically maps to a small candidate set; sequences
    # random-walk through it.
    fanout = 4
    table = rng.randint(0, cfg.vocab, (cfg.vocab, fanout))
    toks = np.empty((n_seq, seq_len + 1), np.int64)
    toks[:, 0] = rng.randint(0, cfg.vocab, n_seq)
    for t in range(seq_len):
        pick = rng.randint(0, fanout, n_seq)
        toks[:, t + 1] = table[toks[:, t], pick]
    return toks.astype(np.int32), table


def legality(seqs: np.ndarray, table: np.ndarray, start: int) -> float:
    """Percent of the transitions from position ``start`` on that the
    Markov table allows."""
    legal = total = 0
    for row in seqs:
        for t in range(start, seqs.shape[1] - 1):
            legal += int(row[t + 1] in table[row[t]])
            total += 1
    return 100.0 * legal / total


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tiny", choices=["tiny", "8b"])
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel axis size (a mesh rank each)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel axis size")
    ap.add_argument("--sp", type=int, default=0,
                    help="sequence-parallel axis size (default: 2 with a "
                         "ring attention mode, else 1)")
    ap.add_argument("--batch", type=int, default=8, help="sequences/step")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--attn", default="full",
                    choices=["full", "flash", "ring", "ring-zigzag",
                             "ring-xla"])
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--loss-chunk", type=int, default=-1,
                    help="sequence chunk for the vocab loss (0 = dense; "
                         "default: auto — dense for tiny, 512 for 8b)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for --generate (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits when sampling")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass when sampling (0 = off)")
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, generate N tokens per prompt and "
                         "score what fraction of transitions are legal "
                         "under the synthetic Markov corpus")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.loss_chunk < 0:
        args.loss_chunk = 512 if args.preset == "8b" else 0
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    if args.generate < 0:
        raise SystemExit("--generate must be >= 0")
    if args.sp == 0:
        args.sp = 2 if args.attn.startswith("ring") else 1
    if min(args.dp, args.tp, args.sp) < 1:
        raise SystemExit("--dp, --tp and --sp must be >= 1")
    nproc = args.dp * args.tp * args.sp
    if nproc > 1 or args.attn.startswith("ring"):
        from ..runtime import launch

        if args.device is None:
            llama.resolve_device(None)      # a card, or the usual error
        launch.spawn(nproc, _run, (args,))
        return
    _run(args)


def _run(args) -> None:
    """Train (and generate) on one device, or as one rank of the mesh."""
    mesh, rank = None, 0
    nproc = args.dp * args.tp * args.sp
    if nproc > 1 or args.attn.startswith("ring"):
        from .. import parallel
        from ..runtime import lifecycle

        if args.device is not None and torch.device(args.device).type == "cpu":
            # The ranks share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
        dev = lifecycle.start(device=args.device)
        rank = lifecycle.rank()
        axes = {"dp": args.dp, "tp": args.tp}
        if args.sp > 1 or args.attn.startswith("ring"):
            axes["sp"] = args.sp
        mesh = parallel.make_mesh(axes)
    else:
        dev = llama.resolve_device(args.device)
    try:
        _train(args, dev, mesh, rank)
    finally:
        if mesh is not None:
            lifecycle.stop()


def _train(args, dev, mesh, rank: int) -> None:
    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    cfg = llama.llama3_8b() if args.preset == "8b" else llama.tiny(
        vocab=512, seq=args.seq)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    where = f"mesh {mesh.shape} " if mesh is not None else ""
    say(f"device {dev} {where}dtype {str(dtype).split('.')[-1]} "
        f"attn={args.attn} remat={args.remat} loss_chunk={args.loss_chunk}")
    params = llama.init(0, cfg, dtype=dtype, device=dev)
    say(f"params: {llama.num_params(params) / 1e6:.1f}M")
    if mesh is not None:
        params = llama.shard_params(params, mesh, cfg)
    step = llama.make_train_step(cfg, mesh, lr=args.lr, attn=args.attn,
                                 remat=args.remat,
                                 loss_chunk=args.loss_chunk)

    data, table = synthetic_tokens(cfg, n_seq=max(args.batch * 8, 64),
                                   seq_len=args.seq)
    rng = np.random.RandomState(1)
    losses = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        batch = torch.from_numpy(data[rng.randint(0, len(data), args.batch)])
        batch = batch.to(dev)
        params, _, loss = step(params, None, batch[:, :-1], batch[:, 1:])
        losses.append(float(loss))
        if it % 10 == 0 or it == args.steps - 1:
            say(f"step {it}: loss {losses[-1]:.4f}")
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.seq * args.steps / dt
    say(f"trained {args.steps} steps in {dt:.1f}s ({tok_s:,.0f} tok/s); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not decrease"

    if args.generate:
        # Train -> generate -> score.  Chance level is fanout/vocab; a
        # trained model should be far above it.
        pl = min(16, args.seq)
        prompts = data[:4, :pl]
        gen = llama.make_generate_fn(cfg, prompt_len=pl,
                                     max_new=args.generate,
                                     temperature=args.temperature,
                                     top_k=args.top_k, top_p=args.top_p,
                                     mesh=mesh, device=dev)
        out = gen(params, prompts, 7).cpu().numpy()
        seqs = np.concatenate([prompts, out], axis=1)
        chance = 100.0 * table.shape[1] / cfg.vocab
        say(f"generation legality: {legality(seqs, table, pl - 1):.1f}% of "
            f"transitions in the Markov table (chance {chance:.1f}%)")


if __name__ == "__main__":
    main()
