"""§Perf hillclimb: re-analyze a dry-run cell under optimization
variants and log hypothesis → change → before/after (port of
`repro.launch.hillclimb`).

Variants are environment/kwarg levers over the SAME model code, the ones
the port has:
  axis=tp_model|fsdp_all      logical axis mapping (TP16 vs pure ZeRO-3)
  sp=0|1                      Megatron sequence-parallel residual stream
  ce=fused|plain              vocab-chunked cross-entropy
  remat=nothing|none          layer recompute on / off
  mb=N                        gradient-accumulation microbatches
  moe_group=N                 MoE dispatch group size

``remat=dots`` and ``pbf16`` raise: the port has no dots-saveable remat
policy, and it computes attention's probabilities in fp32 (ROADMAP Queue 3,
"Attention precision").

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama3-8b \
      --shape train_4k --variant axis=fsdp_all --variant sp=1
Each run writes reports/perf_torch/<cell>__<variant-string>.json.
"""

import argparse
import json
import os
import sys

from repro_torch.launch import dryrun

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "perf_torch")

REFUSED = {
    "pbf16": "the port computes attention's probabilities in fp32; it has no bf16 "
             "probability lever (ROADMAP Queue 3, 'Attention precision')",
    "remat=dots": "the port's remat recomputes whole layers (torch.utils.checkpoint); it has "
                  "no dots-saveable policy",
}


def apply_variant(tokens):
    """Set each variant's environment lever (``os.environ``) and return
    (keyword levers for `dryrun.analyze_cell`, the variant tag)."""
    kw = {}
    tags = []
    for t in tokens:
        key, val = t.split("=", 1)
        if key == "axis":
            os.environ["REPRO_AXIS_MAP"] = val
        elif key == "sp":
            os.environ["REPRO_SEQ_PARALLEL"] = val
        elif key == "remat":
            if val == "dots":
                raise ValueError(f"remat=dots: {REFUSED['remat=dots']}")
            if val not in ("nothing", "none"):
                raise ValueError(f"unknown remat policy {val}")
            kw["remat"] = val == "nothing"
        elif key == "ce":
            os.environ["REPRO_FUSED_CE"] = "1" if val == "fused" else "0"
        elif key == "pbf16":
            raise ValueError(f"pbf16: {REFUSED['pbf16']}")
        elif key == "mb":
            kw["microbatches"] = int(val)
        elif key == "moe_group":
            kw["moe_group"] = int(val)
        else:
            raise ValueError(f"unknown variant key {key}")
        tags.append(f"{key}-{val}")
    return kw, "_".join(tags) if tags else "baseline"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()

    kw, tag = apply_variant(args.variant)
    out = dryrun.analyze_cell(args.arch, args.shape, multi_pod=args.multipod, **kw)
    out["variant"] = tag
    os.makedirs(REPORT_DIR, exist_ok=True)
    path = os.path.join(REPORT_DIR, f"{args.arch}__{args.shape}__{out['mesh']}__{tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
