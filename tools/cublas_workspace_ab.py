#!/usr/bin/env python3
"""What ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (set by importing `repro_torch`,
for the elastic trainer's deterministic mode) does to serving on one NVIDIA
H100.

    python3 tools/cublas_workspace_ab.py [--reps 4]

Runs the same serving workload in fresh processes, alternating the
setting as A, B, B, A, ... (``default``: the variable set empty, so
PyTorch takes its own default workspace; ``4096:8``: the port's value):
llama3-8b at full width (bf16, random weights from seed 0) through
``Engine.generate`` on 4 rows of a 300-token prompt, 32 greedy tokens,
after one warm-up call.  Each process prints one JSON line: the setting,
the host-clock ms of the prefill and of a decode step (the mean over the
31 steps after the first token), measured with ``torch.cuda.synchronize``
around each; the parent prints the card's name and power limit, each
line, and the per-setting medians.  Needs the card (exits 2 without one).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = {"default": "", "4096:8": ":4096:8"}


def child() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import CONFIGS
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    dev = torch.device("cuda", 0)
    cfg = CONFIGS["llama3-8b"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 300)),
                           device=dev)

    def run():
        cache = init_cache(cfg, 4, 1024, torch.float32, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache, n = prefill(params, cfg, {"tokens": toks}, cache)
            tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(31):
                lg, cache = decode_step(params, cfg, tok[:, None], cache, n + i)
                tok = lg[:, 0].argmax(-1)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / 31

    run()
    prefill_ms, step_ms = run()
    print(json.dumps({"setting": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                      "prefill_ms": prefill_ms, "decode_step_ms": step_ms}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = ["default", "4096:8", "4096:8", "default"] * ((reps + 1) // 2)
    rows = {k: [] for k in SETTINGS}
    for name in order[: 2 * reps]:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=SETTINGS[name])
        out = subprocess.run([sys.executable, __file__, "--child"], env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows[name].append(row)
        print(json.dumps({"name": name, **row}), flush=True)
    print(json.dumps({"medians": {
        k: {m: statistics.median(r[m] for r in v) for m in ("prefill_ms", "decode_step_ms")}
        for k, v in rows.items()}, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        child()
    else:
        sys.exit(main())
