"""Generate the §Dry-run / §Roofline tables from
reports/dryrun_torch/*.json (and §Perf rows from reports/perf_torch/*.json),
the port's twin of `repro.analysis.report`: per device of an H100 80GB.

Usage: PYTHONPATH=src python -m repro_torch.analysis.report [--section dryrun|roofline|perf|all]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
HBM_PER_CHIP = 80e9  # H100 80GB


def load(dirname: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(ROOT, "reports", dirname, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b: float) -> str:
    if b < 0:
        return "-"
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def dryrun_table(cells: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | compile s | args/dev | temp/dev | fits 80G "
        "(args) | HLO flops/dev | coll bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for d in cells:
        ms = d["memory_stats"]
        fits = "yes" if 0 <= ms["argument_bytes"] <= HBM_PER_CHIP else "NO"
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['compile_s']:.1f} "
            f"| {fmt_bytes(ms['argument_bytes'])} | {fmt_bytes(ms['temp_bytes'])} "
            f"| {fits} | {d['hlo_flops_per_device']:.2e} "
            f"| {d['collective_bytes_per_device']:.2e} |"
        )
    return "\n".join(rows)


def roofline_table(cells: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | compute s | memory s | collective s | dominant "
        "| 6ND/HLO | roofline frac | bound s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for d in cells:
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {d['compute_s']:.3f} | {d['memory_s']:.3f} | {d['collective_s']:.3f} "
            f"| **{d['dominant']}** | {d['useful_ratio']:.2f} "
            f"| {d['roofline_fraction']:.3f} | {d['step_bound_s']:.3f} |"
        )
    return "\n".join(rows)


def perf_table(cells: List[Dict]) -> str:
    rows = [
        "| cell | variant | compute s | memory s | collective s | dominant | roofline frac |",
        "|---|---|---|---|---|---|---|",
    ]
    for d in cells:
        rows.append(
            f"| {d['arch']}/{d['shape']}/{d['mesh']} | {d.get('variant','baseline')} "
            f"| {d['compute_s']:.3f} | {d['memory_s']:.3f} | {d['collective_s']:.3f} "
            f"| {d['dominant']} | {d['roofline_fraction']:.3f} |"
        )
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", choices=["dryrun", "roofline", "perf", "all"], default="all")
    args = ap.parse_args()
    cells = load("dryrun_torch")
    perf = load("perf_torch")
    if args.section in ("dryrun", "all"):
        print("## §Dry-run\n")
        print(dryrun_table(cells))
        print()
    if args.section in ("roofline", "all"):
        print("## §Roofline\n")
        print(roofline_table(cells))
        print()
    if args.section in ("perf", "all") and perf:
        print("## §Perf variants\n")
        print(perf_table(perf))


if __name__ == "__main__":
    main()
