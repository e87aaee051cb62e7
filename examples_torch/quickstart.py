"""Quickstart: the paper's 'cloud button', on the PyTorch port's runtime.

Take existing single-machine code (a plain Python function) and run it at
scale with one call — no cluster, no config.  Mirrors the PyWren README.
The port ships each function with the standard ``pickle``, so a mapped
function is one a module defines (a lambda raises ``TypeError``):

>>> from functools import partial
>>> from repro_torch.core import WrenExecutor, get_all
>>> with WrenExecutor(num_workers=2) as wex:
...     futures = wex.map(partial(pow, exp=2), [1, 2, 3])
...     get_all(futures, timeout_s=60)
[1, 4, 9]

This is the twin of ``examples/quickstart.py``: the same function, the
same sweeps, the same results.  The runtime is host code; no device is
used.

Run:  PYTHONPATH=src python examples_torch/quickstart.py
"""

import numpy as np

from repro_torch.core import WrenExecutor, get_all

GRID = list(np.linspace(0.1, 2.0, 32))
MORE = list(np.linspace(2.0, 4.0, 16))


def my_function(x: float) -> float:
    """Existing, optimized, single-machine code (per §2.1)."""
    rng = np.random.default_rng(int(x))
    m = rng.normal(size=(128, 128))
    return float(np.linalg.eigvalsh(m @ m.T).max() * x)


def main() -> dict:
    """Both sweeps; -> {"grid": results, "more": results}."""
    with WrenExecutor(num_workers=8) as wex:
        # hyperparameter-sweep shape: one stateless function per point
        futures = wex.map(my_function, GRID)
        results = get_all(futures, timeout_s=120)
        best = int(np.argmax(results))
        print(f"swept {len(GRID)} points on {wex.pool.alive_count()} workers")
        print(f"best point: x={GRID[best]:.3f} -> {results[best]:.2f}")

        # elasticity: scale the pool mid-session, run a second sweep
        wex.scale_to(4)
        more = wex.map_get(my_function, MORE)
        print(f"second sweep done on {wex.pool.alive_count()} workers; "
              f"max={max(more):.2f}")

        stats = wex.pool.stats()
        cold = sum(s.cold_starts for s in stats.values())
        ok = sum(s.tasks_ok for s in stats.values())
        print(f"tasks={ok} cold_starts={cold} (containers stay warm, §4)")
    return {"grid": results, "more": more}


if __name__ == "__main__":
    main()
