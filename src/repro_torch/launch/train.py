"""Training launcher, PyTorch port of `repro.launch.train`.

Composes: config registry -> the optimizer -> the deterministic batch
source -> the stateless step -> the elastic serverless driver (the port's
`WrenExecutor`), with the JAX launcher's arguments, plus ``--device``.  On
the GPU by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --reduced --steps 4

and on the CPU (the plain versions of the kernels):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --reduced \\
      --device cpu --steps 8 --seq 64 --batch 4 [--workers 2] [--microbatches 2]

Weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import time
from functools import partial

from repro_torch import resolve_device
from repro_torch.configs import CONFIGS
from repro_torch.core import WrenExecutor
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.train import ElasticTrainConfig, adamw, cosine_schedule, train_elastic
from repro_torch.train import checkpoint as ck


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--reduced", action="store_true", help="CPU-size config")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--steps-per-chunk", type=int, default=5)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--run", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = CONFIGS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    run = args.run or f"{args.arch}-{'r' if args.reduced else 'f'}"
    device = resolve_device(args.device)

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch, vocab_size=cfg.vocab_size)
    opt = adamw(cosine_schedule(args.lr, warmup=args.steps // 10 + 1, total=args.steps))
    batch_fn = partial(synthetic_batch, dcfg, cfg=cfg)

    wex = WrenExecutor(num_workers=args.workers)
    try:
        tcfg = ElasticTrainConfig(
            run=run,
            steps_per_chunk=args.steps_per_chunk,
            total_steps=args.steps,
            microbatches=args.microbatches,
        )
        t0 = time.time()
        hist = train_elastic(wex, cfg, opt, tcfg, batch_fn, device=device)
        dt = time.time() - t0
        print(f"arch={args.arch} run={run}")
        print(f"losses: {[round(h['loss'], 4) for h in hist]}")
        print(
            f"{args.steps} steps, {dt:.1f}s, "
            f"{args.steps * args.batch * args.seq / dt:.0f} tok/s, "
            f"checkpoint v{ck.latest_version(wex.store, run)}"
        )
    finally:
        wex.shutdown()


if __name__ == "__main__":
    main()
