#!/usr/bin/env python3
"""Cold builds of the port's CUDA kernels, by one builder and by several at
once (card machine: needs ``nvcc``).

    python3 tools/cold_build.py [--builders 1 2] [--dir build/cold_build]

For each count N in ``--builders``: empties ``--dir``, starts N processes
that each import ``repro_torch.kernels._build`` with its build directory
set to ``--dir``, releases them together into ``build_all()``, and prints
one JSON line: the wall seconds from the release to the last exit, each
builder's seconds per kernel (``build_all``'s return: compiled there or
waited for) and the kernels it ran ``nvcc`` for (``_build.compiled``).
Every kernel must be compiled exactly once across the N builders (the
build's per-kernel lock), and built, or the script exits 1.  The card's
name and power limit (``nvidia-smi``) come first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys
from pathlib import Path
from repro_torch.kernels import _build
_build.build_dir = lambda: Path(sys.argv[1])
print("ready", flush=True)
sys.stdin.readline()
try:
    print(json.dumps({"times": _build.build_all(), "compiled": _build.compiled}), flush=True)
except RuntimeError as exc:  # a failed compile: its output, as every caller raises it
    print(json.dumps({"error": str(exc), "compiled": _build.compiled}), flush=True)
"""


def race(out: Path, n: int) -> dict:
    """``n`` builders released together on the empty ``out`` -> the row
    (``per_builder``: each one's ``times`` or ``error``, and ``compiled``)."""
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(out)], env=env, text=True,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(n)]
    try:
        for p in procs:
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError(f"a builder did not start: {p.stderr.read()[-2000:]}")
        t0 = time.perf_counter()
        for p in procs:
            p.stdin.write("\n")
            p.stdin.flush()
        rows = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"a builder exited {p.returncode}: {stderr[-4000:]}")
            rows.append(json.loads(stdout.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    compiled = sorted(k for r in rows for k in r["compiled"])
    return {"builders": n, "wall_s": wall, "per_builder": rows, "nvcc_runs": compiled}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--builders", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--dir", default=str(ROOT / "build" / "cold_build"))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    ok = True
    for n in args.builders:
        row = race(Path(args.dir), n)
        row["once_each"] = row["nvcc_runs"] == sorted(_build.KERNELS)
        ok &= row["once_each"] and not any("error" in r for r in row["per_builder"])
        print(json.dumps(row), flush=True)
    shutil.rmtree(args.dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
