"""End-to-end driver on the PyTorch port: train a ~100M-param LM on the
stateless runtime, with checkpoint/restart, a mid-run worker kill and an
elastic resize — the full 'PyWren for training' story (the twin of
``examples/train_lm.py``).

The model is the llama3-8b config scaled to ~100M params (same family and
code path as the full config; the full sizes are exercised by the
dry-run).  Each chunk of steps runs on the GPU (the hand-written flash
attention kernel in the forward, its plain version's backward) unless
``--device cpu`` is given; it never falls back to the CPU.  ``--reduced``
trains the llama3-8b reduced config instead, a CPU-size run.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 200] [--device cpu]
"""

import argparse
import dataclasses
import json
import time
from functools import partial

from repro_torch import resolve_device
from repro_torch.configs import CONFIGS
from repro_torch.core import WrenExecutor
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.train import ElasticTrainConfig, adamw, cosine_schedule, train_elastic
from repro_torch.train import checkpoint as ck


def make_100m_config():
    base = CONFIGS["llama3-8b"]
    return dataclasses.replace(
        base,
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        vocab_size=2048,
        dtype="float32",
        param_dtype="float32",
    )


def main(argv=None) -> dict:
    """-> {"hist": the chunks' metrics, "more": after the kill, "version":
    the last checkpoint, "tok_s": tokens per second of the first run}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="the llama3-8b reduced config")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CONFIGS["llama3-8b"].reduced() if args.reduced else make_100m_config()
    n_params = cfg.param_count()[0]
    print(f"model: {cfg.name} {'reduced' if args.reduced else '100m derivative'}, "
          f"{n_params/1e6:.1f}M params, on {device}")

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch, vocab_size=cfg.vocab_size)
    opt = adamw(
        cosine_schedule(1.5e-3, warmup=20, total=args.steps),
        weight_decay=0.0,
    )
    # a partial of a module function: the port's runtime ships tasks with
    # the standard pickle, which refuses a lambda
    batch_fn = partial(synthetic_batch, dcfg, cfg=cfg)

    wex = WrenExecutor(num_workers=2)
    try:
        tcfg = ElasticTrainConfig(
            run="lm100m", steps_per_chunk=10, total_steps=args.steps,
        )
        # elastic plan: grow the pool a quarter of the way in, shrink at
        # three fifths (chunks 5 and 12 of 200 steps)
        n_chunks = args.steps // tcfg.steps_per_chunk
        plan = {c: n for c, n in ((max(1, n_chunks // 4), 4), (max(2, 3 * n_chunks // 5), 2))
                if c < n_chunks}
        t0 = time.perf_counter()
        hist = train_elastic(wex, cfg, opt, tcfg, batch_fn, scale_plan=plan, device=device)
        dt = time.perf_counter() - t0
        tok_s = args.steps * args.batch * args.seq / dt
        print(f"chunk losses: {[round(h['loss'], 3) for h in hist]}")
        print(
            f"{args.steps} steps in {dt:.1f}s "
            f"({tok_s:.0f} tok/s on {device.type}); "
            f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; "
            f"pool resized at chunks {sorted(plan)}"
        )
        assert hist[-1]["loss"] < hist[0]["loss"], "loss must decrease"

        # ---- kill a worker and keep going (fault tolerance) --------------
        wex.pool.kill_worker(0)
        more = train_elastic(
            wex, cfg, opt,
            ElasticTrainConfig(run="lm100m", steps_per_chunk=10,
                               total_steps=args.steps + 30),
            batch_fn, device=device,
        )
        version = ck.latest_version(wex.store, "lm100m")
        print(f"after worker kill, trained 3 more chunks: "
              f"{[round(h['loss'], 3) for h in more]}")
        print(f"final checkpoint version: {version}")
        print("launches " + json.dumps({"flash_attention": flash_attention.launches}))
    finally:
        wex.shutdown()
    return {"hist": hist, "more": more, "version": version, "tok_s": tok_s}


if __name__ == "__main__":
    main()
