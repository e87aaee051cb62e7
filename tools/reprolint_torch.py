#!/usr/bin/env python
"""reprolint CLI for the PyTorch port: the control-plane invariant lint
(``repro_torch.analysis.lint``) over the port's tree.

Usage:
    python tools/reprolint_torch.py [PATHS...] [--strict] \
        [--baseline tools/reprolint_torch_baseline.json] [--update-baseline]

Exit codes:
    0  clean (no active findings; disable counts within baseline)
    1  active findings, or the per-rule disable count grew past the
       baseline (new `# reprolint: disable=` waivers need a conscious
       baseline update, not a silent merge)

With no PATHS, lints ``src/repro_torch`` relative to the repo root.  The
same flags and exit codes as ``tools/reprolint.py``, the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO_ROOT, "src"))

from repro_torch.analysis import lint  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("paths", nargs="*", help="files or trees to lint")
    parser.add_argument(
        "--strict", action="store_true",
        help="exit nonzero on any active (non-disabled) finding",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="JSON file holding the allowed per-rule disable counts",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline file from the current tree",
    )
    parser.add_argument(
        "--quiet", action="store_true", help="suppress per-finding output"
    )
    args = parser.parse_args(argv)

    paths = args.paths or [os.path.join(_REPO_ROOT, "src", "repro_torch")]
    findings = []
    for p in paths:
        findings.extend(lint.lint_tree(p))

    bad = lint.active(findings)
    waived = [f for f in findings if f.disabled]
    if not args.quiet:
        for f in bad:
            print(f.format())
            print(f"    fix-it: {f.fixit}")

    failed = False
    if bad:
        print(f"reprolint: {len(bad)} active finding(s) "
              f"({len(waived)} waived by disable comments)")
        if args.strict:
            failed = True
    elif not args.quiet:
        print(f"reprolint: clean ({len(waived)} waived by disable comments)")

    counts = lint.disabled_counts(findings)
    if args.baseline:
        if args.update_baseline:
            with open(args.baseline, "w", encoding="utf-8") as fh:
                json.dump({"disabled_findings": counts}, fh, indent=2, sort_keys=True)
                fh.write("\n")
            print(f"reprolint: baseline updated -> {args.baseline}")
        else:
            try:
                with open(args.baseline, "r", encoding="utf-8") as fh:
                    allowed = json.load(fh).get("disabled_findings", {})
            except FileNotFoundError:
                print(f"reprolint: baseline file {args.baseline} missing "
                      f"(run with --update-baseline to create it)")
                return 1
            for rule, n in sorted(counts.items()):
                cap = int(allowed.get(rule, 0))
                if n > cap:
                    print(
                        f"reprolint: {rule} disable count grew: {n} > "
                        f"baseline {cap} — remove the new waiver or update "
                        f"{args.baseline} deliberately"
                    )
                    failed = True

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
