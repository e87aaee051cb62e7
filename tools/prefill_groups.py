#!/usr/bin/env python3
"""Which op makes a bf16 request's greedy tokens depend on the other
requests of its prefill group, on one NVIDIA H100.

    python3 tools/prefill_groups.py [--trace-request 3]

``chip_smoke.py`` phase 6b serves the same 16 requests twice (one worker,
then two workers, one SIGKILLed) and compares each request's tokens.  The
engine prefills the requests admitted together at one padded length
(buckets of 16) as one batch, so a request's prefill runs at a batch size
(and GEMM height M = rows x padded length) set by whoever arrived with it;
decode always runs all slots.  This script builds the worker's model
(llama3-8b at full width, random bf16 weights from seed 0, fp32 cache,
``launch.serve``'s ``ServeConfig``) and phase 6b's 16 prompts, and prints
JSON lines:

1. ``prefill``: per request, its last-token logits prefilled alone against
   prefilled in a group of 2 and of 4 rows of its padded length (the other
   rows random prompts of that length from a seed), the same group run
   twice, and the group of 2 in the other row order: the largest
   |difference|, bit-equality, and whether the greedy token agrees;
2. ``trace``: for one request, every torch function call of the prefill
   (a ``TorchFunctionMode``) alone and in a group of 4: its rows of each
   call's tensor inputs and output, compared bit for bit; the first call
   whose inputs are equal and whose output is not names the op (calls
   without a tensor input, such as ``torch.empty``, are not compared), and
   the counts of such calls by op name;
3. ``decode``: one decode step of the request prefilled alone, with the
   other three slots empty and then holding other requests: its logits
   bit-equal or not (decode's batch is always all slots).

The card's name and power limit come first.  Needs the card (exits 2
without one); ``--reduced --device cpu`` is a dry run of the code paths at
the reduced width, whose numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_REQUESTS = 16  # chip_smoke.py SHARED_REQUESTS
BUCKET = 16  # ServeConfig.prefill_bucket


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-request", type=int, default=3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("prefill_groups: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.overrides import TorchFunctionMode

    from repro_torch.configs import CONFIGS
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.serve import ContinuousEngine, ServeConfig

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    cfg = CONFIGS["llama3-8b"].reduced() if args.reduced else CONFIGS["llama3-8b"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    scfg = ServeConfig(max_batch=4, max_len=1024, max_new_tokens=64, lease_timeout_s=2.0,
                       cache_dtype="float32")
    rng = np.random.default_rng(0)  # chip_smoke.py phase_shared_roots
    lens = [int(n) for n in rng.integers(16, 301, size=N_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    fill = np.random.default_rng(1)

    def padded(n):
        return min(-(-n // BUCKET) * BUCKET, scfg.max_len - 1)

    @torch.no_grad()
    def last_logits(rows, lpad):
        """Prefill ``rows`` (token lists) as one group of padded length
        ``lpad``, as ``ContinuousEngine.admit`` does -> each row's logits at
        its last prompt token (fp32)."""
        toks = np.zeros((len(rows), lpad), np.int64)
        for j, r in enumerate(rows):
            toks[j, :len(r)] = r
        small = init_cache(cfg, len(rows), scfg.max_len, torch.float32, dev)
        logits, _, _ = prefill(params, cfg, {"tokens": torch.from_numpy(toks).to(dev)}, small,
                               all_logits=True)
        idx = torch.tensor([len(r) - 1 for r in rows], device=dev)
        return logits[torch.arange(len(rows), device=dev), idx].float()

    def companions(n, lpad):
        return [fill.integers(0, cfg.vocab_size, size=lpad - int(fill.integers(0, BUCKET))
                              ).tolist() for _ in range(n)]

    # 1. every request alone, in groups of 2 and 4, and one group twice
    for i, p in enumerate(prompts):
        lpad = padded(len(p))
        alone = last_logits([p], lpad)[0]
        row = {"phase": "prefill", "request": i, "len": len(p), "padded": lpad}
        others = companions(3, lpad)
        for n in (2, 4):
            grp = last_logits([p, *others[:n - 1]], lpad)[0]
            again = last_logits([p, *others[:n - 1]], lpad)[0]
            row[f"group{n}"] = {
                "max_abs_diff": float((grp - alone).abs().max()),
                "bit_equal": bool(torch.equal(grp, alone)),
                "greedy_equal": int(grp.argmax()) == int(alone.argmax()),
                "repeat_bit_equal": bool(torch.equal(grp, again)),
            }
            if n == 2:
                swapped = last_logits([others[0], p], lpad)[1]
                row["group2"]["row_order_bit_equal"] = bool(torch.equal(grp, swapped))
        top2 = alone.topk(2).values
        row["top2_margin"] = float(top2[0] - top2[1])
        emit(row)

    # 2. the first op whose output differs, for one request alone vs in 4 rows
    p = prompts[args.trace_request]
    lpad = padded(len(p))

    class Recorder(TorchFunctionMode):
        def __init__(self, n):
            super().__init__()
            self.n, self.calls = n, []

        def rows(self, t):
            """The traced request's rows (row 0 of the group) of a tensor
            whose leading dim is the group or group x padded length."""
            if not isinstance(t, torch.Tensor) or t.dim() == 0:
                return None
            if t.shape[0] == self.n * lpad and self.n > 1:
                return t[:lpad].detach().clone()
            if t.shape[0] == self.n:
                return t[:1].detach().clone()
            if self.n == 1 and t.shape[0] == lpad:
                return t.detach().clone()
            return None

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat = [t for a in args for t in (a if isinstance(a, (tuple, list)) else (a,))]
            ins = [self.rows(a) for a in flat if isinstance(a, torch.Tensor)]
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.calls.append((getattr(func, "__name__", str(func)), ins,
                               [self.rows(o) for o in outs]))
            return out

    traces = {}
    for n in (1, 4):
        rec = Recorder(n)
        rows = [p, *companions(n - 1, lpad)]
        with rec:
            last_logits(rows, lpad)
        traces[n] = rec.calls

    def same(a, b):
        return a is not None and b is not None and a.shape == b.shape and torch.equal(a, b)

    first, counts, compared = None, {}, 0
    for k, ((name, ins1, outs1), (name4, ins4, outs4)) in enumerate(zip(traces[1], traces[4])):
        if name != name4:
            break
        pairs = [(a, b) for a, b in zip(outs1, outs4) if a is not None and b is not None
                 and a.shape == b.shape]
        if not pairs or not ins1:  # no output rows, or a factory (empty, zeros)
            continue
        compared += 1
        inputs_equal = all(same(a, b) for a, b in zip(ins1, ins4) if a is not None
                           and b is not None and a.shape == b.shape)
        outputs_equal = all(torch.equal(a, b) for a, b in pairs)
        if inputs_equal and not outputs_equal:
            counts[name] = counts.get(name, 0) + 1
            if first is None:
                a, b = pairs[0]
                n_mm = sum(c[0] == name for c in traces[1][:k])
                first = {"call": k, "op": name, "nth_call_of_op": n_mm,
                         "input_shapes_alone": [list(t.shape) for t in ins1 if t is not None],
                         "max_abs_diff": float((a.float() - b.float()).abs().max()),
                         "dtype": str(a.dtype)}
    emit({"phase": "trace", "request": args.trace_request, "len": len(p), "padded": lpad,
          "calls": len(traces[1]), "compared": compared, "first_differing_op": first,
          "differing_with_equal_inputs_by_op": counts})

    # 3. decode: the same prefilled request with the other slots empty or busy
    @torch.no_grad()
    def decode_row(others):
        eng = ContinuousEngine(cfg, params, scfg, device=dev)
        eng.admit([("r", p, 64)])
        if others:
            eng.admit([(f"o{j}", o, 64) for j, o in enumerate(others)])
        logits, _ = decode_step(params, cfg, torch.from_numpy(eng.tokens[:, None]).to(dev),
                                eng.cache, torch.from_numpy(eng.cache_lens).to(dev))
        return logits[0, 0].float()

    empty, busy = decode_row([]), decode_row(prompts[:3])
    emit({"phase": "decode", "request": args.trace_request,
          "bit_equal": bool(torch.equal(empty, busy)),
          "max_abs_diff": float((empty - busy).abs().max())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
