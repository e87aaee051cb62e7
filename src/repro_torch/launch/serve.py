"""Serving engine worker, PyTorch port: one continuous-batching engine over
the request plane (port of `repro.launch.serve`).

Each invocation is ONE stateless engine worker, the paper's scaling unit.
Point any number of them at the same ``--kv-root``/``--obj-root`` (a shared
filesystem) and they drain the ``serve/q/*`` request queues together:
leases keep two engines off the same request, heartbeats keep live work
fenced, and a worker that dies mid-stream is reaped by the survivors and
its requests re-served (greedy decoding and per-request sampling seeds make
the re-serve deterministic).  The roots hold the JAX package's on-disk
format, so torch workers and JAX workers can drain one queue.

Worker over a shared directory, on the GPU (start N of these; clients
submit with ``repro_torch.serve.request_plane.submit`` against the same
roots):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --kv-root /srv/kv --obj-root /srv/obj --engine-id e0 --idle-timeout 10

Self-contained demo (no roots: in-memory stores; submits its own requests
and serves them):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --demo-requests 8

and on the CPU at a reduced width (the plain versions of the kernels):

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --demo-requests 4

``--arch`` takes the dense family (llama3-8b, qwen3-32b, gemma2-27b), the
MoE family (``--arch olmoe-1b-7b``, ``--arch deepseek-v3-671b`` with MLA),
the Mamba2 hybrid (``--arch zamba2-1.2b``), xLSTM (``--arch xlstm-1.3b``)
and the VLM ``--arch internvl2-1b``, served text-only (no request carries
patch embeddings), as the JAX worker serves it.  ``--arch
whisper-large-v3`` raises ``NotImplementedError``, as the JAX worker does:
its requests carry no audio frames (``Engine.generate`` with
``extras={"audio_frames": ...}`` serves whisper).

The worker prints ``READY <engine-id>`` after warmup so orchestrators can
wait for it before submitting, and on idle exit ``launches {...}``, each
CUDA kernel's launches while it served (JSON; all 0 on the CPU, which runs
the plain versions), then the stats line; while it serves, ``prefill
[ids]`` for each prefill group as it runs (a bf16 prefill's bits depend on
its group's size, so a comparison of two runs' tokens needs the groups).
Weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import CONFIGS
from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, mlstm
from repro_torch.models import init_params
from repro_torch.serve import ContinuousEngine, ServeConfig
from repro_torch.serve import request_plane as rp
from repro_torch.storage import FileBackend, FileKVStore, KVStore, ObjectStore


KERNELS = {
    "decode_attention": decode_attention.decode_attention,
    "flash_attention": flash_attention.flash_attention,
    "ssd": mamba2_ssd.ssd,
    "mlstm": mlstm.mlstm,
}


def build_engine(args) -> ContinuousEngine:
    cfg = CONFIGS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    scfg = ServeConfig(
        max_batch=args.batch,
        max_len=args.max_len,
        max_new_tokens=args.new_tokens,
        decode_chunk=args.decode_chunk,
        n_queues=args.queues,
        lease_timeout_s=args.lease_timeout,
        cache_dtype=args.cache_dtype,
    )
    engine = ContinuousEngine(cfg, params, scfg, device=device)
    # build the kernels and warm the allocator before READY
    engine.admit([("warm", [1, 2, 3], 2)])
    while engine.n_live():
        engine.step_chunk()
    for k in engine.stats:
        engine.stats[k] = 0
    for fn in KERNELS.values():
        fn.launches = 0
    return engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-32b", choices=sorted(CONFIGS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cache-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--kv-root", help="shared FileKVStore directory (request plane)")
    ap.add_argument("--obj-root", help="shared FileBackend directory (bodies/results)")
    ap.add_argument("--engine-id", default="engine-0")
    ap.add_argument("--idle-timeout", type=float, default=5.0,
                    help="exit after the queue stays empty this long (s)")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps between admission/stream boundaries")
    ap.add_argument("--queues", type=int, default=1, help="serve/q/ shard count")
    ap.add_argument("--lease-timeout", type=float, default=2.0)
    ap.add_argument("--demo-requests", type=int, default=0,
                    help="submit this many synthetic requests first (demo mode; "
                    "uses in-memory stores when no roots are given)")
    args = ap.parse_args(argv)

    if bool(args.kv_root) != bool(args.obj_root):
        ap.error("--kv-root and --obj-root must be given together")
    if args.kv_root:
        kv = FileKVStore(args.kv_root, num_shards=2)
        store = ObjectStore(backend=FileBackend(args.obj_root))
    else:
        if not args.demo_requests:
            ap.error("no shared roots: give --kv-root/--obj-root, or "
                     "--demo-requests N for a self-contained in-memory demo")
        kv = KVStore(num_shards=2)
        store = ObjectStore()

    engine = build_engine(args)
    engine.on_prefill = lambda ids: print("prefill " + json.dumps(ids), flush=True)
    print(f"READY {args.engine_id}", flush=True)

    if args.demo_requests:
        rng = np.random.default_rng(0)
        for i in range(args.demo_requests):
            prompt = rng.integers(0, engine.cfg.vocab_size, size=int(rng.integers(4, 16))).tolist()
            rp.submit(store, kv, f"req-{i:04d}", prompt, n_queues=args.queues)
        print(f"submitted {args.demo_requests} requests", flush=True)

    t0 = time.time()
    stats = engine.run(store, kv, engine_id=args.engine_id, idle_timeout_s=args.idle_timeout)
    dt = time.time() - t0
    print("launches " + json.dumps({name: fn.launches for name, fn in KERNELS.items()}),
          flush=True)
    print(
        f"{args.engine_id}: served {stats['served']} requests, "
        f"{stats['tokens_out']} tokens in {dt:.1f}s "
        f"({stats['tokens_out'] / max(dt, 1e-9):.1f} tok/s; "
        f"{stats['mid_batch_admissions']} mid-batch admissions, "
        f"{stats['decode_steps']} decode steps)",
        flush=True,
    )


if __name__ == "__main__":
    sys.exit(main())
