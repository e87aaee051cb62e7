"""Parameter server on the KV store (paper §3.3 'Parameter Servers'), on the
PyTorch port's runtime (the twin of ``examples/hogwild_ps.py``).

HOGWILD! SGD where the ONLY coordination between stateless workers is the
low-latency KV store: pull blocks, compute a gradient, push deltas via
server-side range updates.  Demonstrates the paper's flexible-consistency
point with a staleness bound, and int8 gradient compression on the wire.
The gradient function is module-level (the port ships it with the standard
``pickle``).  The runtime is host code (numpy on worker threads); no device
is used.

Run:  PYTHONPATH=src python examples_torch/hogwild_ps.py
"""

import numpy as np

from repro_torch.core import ParameterServer, PSConfig, WrenExecutor, hogwild_sgd

PS_CONFIGS = [
    ("hogwild (fully async)", PSConfig(num_blocks=8)),
    ("staleness<=4", PSConfig(num_blocks=8, max_staleness=4)),
    ("hogwild + int8 grads", PSConfig(num_blocks=8, compress_int8=True)),
]


def grad_fn(w, shard):
    X, y = shard
    return 2.0 * X.T @ (X @ w - y) / len(y)


def main() -> dict:
    """-> {label: {"rel_err", "kv_ops"}} for each of the three configs."""
    rng = np.random.default_rng(0)
    dim, n_shards, n_per = 64, 8, 128
    w_true = rng.normal(size=dim)
    shards = []
    for _ in range(n_shards):
        X = rng.normal(size=(n_per, dim))
        y = X @ w_true + 0.01 * rng.normal(size=n_per)
        shards.append((X, y))

    rows = {}
    for label, cfg in PS_CONFIGS:
        with WrenExecutor(num_workers=6) as wex:
            ps = ParameterServer(wex.kv, np.zeros(dim), cfg)
            w = hogwild_sgd(
                wex, ps, grad_fn, shards, steps_per_worker=60, lr=0.01
            )
            err = float(np.linalg.norm(w - w_true) / np.linalg.norm(w_true))
            kv_ops = wex.kv.total_ops()
            print(f"{label:24s} rel-err={err:.4f} kv_ops={kv_ops}")
        rows[label] = {"rel_err": err, "kv_ops": kv_ops}
    return rows


if __name__ == "__main__":
    main()
