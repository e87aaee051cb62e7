"""Map + monolithic Reduce (paper §3.3, Table 2), on the PyTorch port's
runtime (the twin of ``examples/featurize_reduce.py``).

The ImageNet-GIST workflow shape: a wide stateless map featurizes image
shards into S3, then a single 'big machine' fetches the (small) features and
fits a linear classifier with a closed-form solve — 'a single node is
sufficient (and most efficient) for model building'.

The port ships the mapped function with the standard ``pickle``, so it is
a ``functools.partial`` of a module-level function here; the label noise
still comes from the one generator every worker thread shares, as in the
JAX example, so the labels depend on the threads' order.  The runtime is
host code (numpy on worker threads); no device is used.

Run:  PYTHONPATH=src python examples_torch/featurize_reduce.py
"""

import time
from functools import partial

import numpy as np

from repro_torch.core import WrenExecutor, get_all
from repro_torch.storage import ObjectStore, S3_2017

N_SHARDS, PER_SHARD, HW = 12, 32, 24
# the label noise's generator, shared by the worker threads (set by `main`)
_NOISE = {}


def featurize(store: ObjectStore, w_true: np.ndarray, i: int) -> str:
    w = f"fw{i}"
    imgs = store.get(f"imgs/{i}", worker=w)
    feats = np.stack([np.abs(np.fft.rfft2(im)).reshape(-1) for im in imgs])
    labels = (feats @ w_true + _NOISE["rng"].normal(size=len(feats)) * 0.1 > 0).astype(np.float32)
    store.put(f"feat/{i}", (feats.astype(np.float32), labels), worker=w)
    return f"feat/{i}"


def main() -> dict:
    """-> {"features": the map's (features, labels) by shard, "phases": the
    map's mean virtual seconds per phase, "n_images", "accuracy"}."""
    store = ObjectStore(profile=S3_2017)
    rng = np.random.default_rng(0)
    _NOISE["rng"] = rng

    # stage synthetic "images" with a linearly separable structure
    w_true = rng.normal(size=(HW * (HW // 2 + 1),))
    for i in range(N_SHARDS):
        imgs = rng.normal(size=(PER_SHARD, HW, HW)).astype(np.float32)
        store.put(f"imgs/{i}", imgs, worker="stage")

    with WrenExecutor(store=store, num_workers=6) as wex:
        t0 = time.perf_counter()
        futs = wex.map(partial(featurize, store, w_true), list(range(N_SHARDS)))
        keys = get_all(futs, timeout_s=120)
        # per-phase virtual times (Table 2 shape)
        phases = {}
        for f in futs:
            for k, v in f.peek().phases.items():
                phases[k] = phases.get(k, 0.0) + v
        phases = {k: round(v / N_SHARDS, 2) for k, v in phases.items()}
        print("map phase (virtual s):", phases)

    # ---- monolithic reduce ------------------------------------------------
    Xs, ys = [], []
    for k in keys:
        X, y = store.get(k, worker="reduce")
        Xs.append(X)
        ys.append(y)
    X = np.concatenate(Xs)
    y = np.concatenate(ys)
    lam = 1e-1
    w = np.linalg.solve(X.T @ X + lam * np.eye(X.shape[1]), X.T @ (2 * y - 1))
    acc = float((((X @ w) > 0) == y.astype(bool)).mean())
    print(f"featurized {len(X)} images across {N_SHARDS} stateless maps")
    print(f"single-node fit accuracy: {acc:.3f} "
          f"(wall {time.perf_counter() - t0:.2f}s)")
    return {"features": dict(zip(keys, zip(Xs, ys))), "phases": phases, "n_images": len(X),
            "accuracy": acc}


if __name__ == "__main__":
    main()
