"""Elastic remesh on the PyTorch port: resume training on a DIFFERENT
device mesh (the twin of ``examples/elastic_remesh.py``).

The PyWren property applied to distributed training: because ALL durable
state lives in storage and steps are stateless, scaling the mesh is just
checkpoint -> re-place on the new mesh -> continue.  This script starts 8
rank processes (one process group): they train with the port's sharded
train step on a (4 data x 2 model) mesh, rank 0 checkpoints the run
(`repro_torch.train.checkpoint`) into a shared file store, and every rank
reloads it onto a (2 data x 4 model) mesh and keeps training — losses
continue smoothly across the remesh.

The ranks run on 8 GPUs over NCCL unless ``--device cpu`` is given (gloo,
8 CPU processes); they never fall back to the CPU.  ``--inputs PATH``
(``torch.save`` of {"params": ..., "batches": [...]}) trains from given
weights on given batches, as a parity check feeds it the JAX example's.

Run:  PYTHONPATH=src python examples_torch/elastic_remesh.py [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

WORLD = 8
STEPS = 10  # per mesh
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def config():
    from repro_torch.configs import CONFIGS
    from repro_torch.data import DataConfig
    from repro_torch.train import adamw

    cfg = dataclasses.replace(
        CONFIGS["llama3-8b"].reduced(), n_layers=2, d_model=128, d_ff=256,
        n_heads=4, n_kv_heads=4, head_dim=32, vocab_size=512,
    )
    opt = adamw(3e-3, weight_decay=0.0)
    dcfg = DataConfig(seq_len=32, global_batch=8, vocab_size=cfg.vocab_size)
    return cfg, opt, dcfg


def place(tree, mesh, pspec):
    from repro_torch.launch.shardings import to_shardings
    from repro_torch.models.sharding import distribute

    return distribute(tree, to_shardings(mesh, pspec))


def run_steps(state, cfg, opt, batch_at, mesh, start, n):
    from repro_torch.launch.shardings import batch_pspec, state_pspec
    from repro_torch.models.sharding import use_mesh
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, opt)
    losses = []
    state = place(state, mesh, state_pspec(mesh, state))
    with use_mesh(mesh):
        for i in range(start, start + n):
            batch = batch_at(i)
            state, m = step(state, place(batch, mesh, batch_pspec(mesh, batch)))
            loss = m["loss"]
            losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss))
    return state, losses


def rank_main(args) -> None:
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.storage import FileBackend, ObjectStore
    from repro_torch.train import TrainState, init_train_state
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import _as_state
    from repro_torch.util import tree_map

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{args.port}", rank=args.rank,
                            world_size=WORLD)
    try:
        cfg, opt, dcfg = config()
        if args.inputs:
            given = torch.load(args.inputs, weights_only=False)
            params = tree_map(lambda x: x.to(device), given["params"])
            state = TrainState(params, opt.init(params))

            def batch_at(i):
                return {k: v.to(device) for k, v in given["batches"][i].items()}
        else:
            state = init_train_state(cfg, opt, torch.Generator(device=device).manual_seed(0),
                                     device)

            def batch_at(i):
                return {k: v.to(device) for k, v in synthetic_batch(dcfg, i, cfg).items()}

        store = ObjectStore(backend=FileBackend(os.path.join(args.out, "store")))
        mesh_a = make_mesh(4, 2, device=device.type)
        state, losses_a = run_steps(state, cfg, opt, batch_at, mesh_a, 0, STEPS)
        full = tree_map(lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x, tuple(state))
        if args.rank == 0:
            ck.save(store, "remesh", 1, full, meta={"step": STEPS})
            print(f"mesh (4x2): losses {losses_a[0]:.3f} -> {losses_a[-1]:.3f}", flush=True)
        dist.barrier()

        # ---- elastic remesh: reload the run on a different mesh ----------
        mesh_b = make_mesh(2, 4, device=device.type)
        loaded, meta, _ = ck.load(store, "remesh", device=device, cfg=cfg, opt=opt)
        state_b, losses_b = run_steps(_as_state(loaded), cfg, opt, batch_at, mesh_b,
                                      meta["step"], STEPS)
        if args.rank == 0:
            print(f"mesh (2x4): losses {losses_b[0]:.3f} -> {losses_b[-1]:.3f}", flush=True)
            with open(os.path.join(args.out, "losses.json"), "w") as f:
                json.dump({"losses_a": losses_a, "losses_b": losses_b}, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    """Start the ranks and wait for them; -> {"losses_a", "losses_b"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default, 8 GPUs) or cpu")
    ap.add_argument("--inputs", default=None, help="torch.save of {'params', 'batches'}")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}

    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            OMP_NUM_THREADS="1")
        extra = ["--device", args.device] + (["--inputs", args.inputs] if args.inputs else [])
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--port", str(port), "--out", out] + extra, env=env)
                 for r in range(WORLD)]
        deadline = time.monotonic() + args.timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        bad = {r: p.returncode for r, p in enumerate(procs) if p.returncode}
        if bad:
            raise RuntimeError(f"ranks failed: {bad}")
        with open(os.path.join(out, "losses.json")) as f:
            got = json.load(f)
    assert got["losses_b"][0] < got["losses_a"][0], "training must continue, not restart"
    print("remesh resume OK: storage-resident state + stateless steps "
          "(the PyWren contract) make mesh shape a per-task detail")
    return got


if __name__ == "__main__":
    main()
