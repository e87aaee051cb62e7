"""The port's sharded execution on real gloo meshes of 4 CPU ranks, fp32.

One spawn per file: a module-scoped fixture starts 4 rank processes (this
file run as a script), each of which runs every case below in order on
(2, 2) and (1, 4) meshes of ``device="cpu"`` and writes what each case
gave; every case is then its own test, which passes when all four ranks
passed it.  The spawn has its own timeout, so a hang fails the tests
instead of holding the suite.  This file holds the mesh constructors and
the forward and gradients; `tests/test_torch_distributed_state.py` (its
own spawn, this file's helpers) decode, the reshard and the int8
moments.

"Sharded" is compared with the unsharded port in the same rank, on the
same weights (seed 0) and inputs: logits within 2e-5 (the fp32 attention
bar of `tests/test_kernels.py`), gradients within 1e-5, greedy tokens
identical.  Parameters, batches, caches and train states are placed by the
port's rules (`models.sharding.param_sharding`, `launch.shardings`).

The ``*_collectives`` cases run one train step (llama3, olmoe, zamba2) or
one decode step (llama3) on the (2, 2) mesh under the dry-run's
``CollectiveRecorder`` (``CommDebugMode``) and record every collective;
`test_dryrun_collectives_beside_dtensor` holds the dry-run's count of the
same step, made on torch's fake process group, equal to it op for op.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import traceback

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD = 4
TIMEOUT_S = 150
CASES = (
    "mesh_constructors",
    "llama_forward_and_grads",
    "olmoe_forward_and_grads",
    "zamba2_forward_and_grads",
    "xlstm_forward",
    "llama_gqa_tp_above_kv_heads",
    "llama_train_step_collectives",
    "llama_decode_step_collectives",
    "olmoe_train_step_collectives",
    "zamba2_train_step_collectives",
)
# the cases whose collectives the dry-run's count is held to (rank 0's
# record, ``collectives_<case>.json`` in the spawn's output directory)
COLLECTIVE_CASES = {
    "llama_train_step_collectives": ("llama3-8b", "train"),
    "llama_decode_step_collectives": ("llama3-8b", "decode"),
    "olmoe_train_step_collectives": ("olmoe-1b-7b", "train"),
    "zamba2_train_step_collectives": ("zamba2-1.2b", "train"),
}
TRAIN_B, TRAIN_S = 4, 8  # the batch of the collective cases' train step
DECODE_B, DECODE_S, DECODE_LEN = 4, 16, 3  # their decode step: rows, cache length, position
OUT_DIR = None  # the spawn's output directory, set in each rank


# ---------------------------------------------------------------------------
# the cases, run in each rank
# ---------------------------------------------------------------------------

def _cfg(arch):
    from repro_torch.configs import CONFIGS

    base = CONFIGS[arch].reduced()
    if arch == "llama3-8b":  # 4 heads of 16, 2 KV heads
        return dataclasses.replace(base, d_model=64, n_heads=4, head_dim=16, n_kv_heads=2,
                                   n_layers=2, vocab_size=256, d_ff=128)
    if arch == "olmoe-1b-7b":  # 8 experts, divisible by tp
        return dataclasses.replace(base, n_layers=2)
    if arch == "zamba2-1.2b":  # one period: a super block of Mamba layers, the shared block
        return dataclasses.replace(base, n_layers=base.shared_attn_every)
    if arch == "deepseek-v3-671b":  # MLA, the dense prefix, MoE and the MTP head
        return base
    return dataclasses.replace(base, n_layers=base.xlstm.slstm_every)  # one xLSTM group


_MESHES = {}


def _mesh(dp, tp):
    from repro_torch.launch.mesh import make_mesh

    if (dp, tp) not in _MESHES:
        _MESHES[dp, tp] = make_mesh(dp, tp, device="cpu")
    return _MESHES[dp, tp]


def _params(cfg):
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _tokens(cfg, B, S, seed=1):
    return torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(seed))


def _place(tree, mesh, pspec):
    from repro_torch.launch.shardings import to_shardings
    from repro_torch.models.sharding import distribute

    return distribute(tree, to_shardings(mesh, pspec))


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _close(a, b, tol, what):
    err = (_full(a) - b).abs().max().item()
    assert err <= tol, f"{what}: max abs error {err} > {tol}"


def _forward_and_grads(arch, dp, tp, grads=True, seq=8, fused_ce=False):
    from repro_torch.launch.shardings import batch_pspec
    from repro_torch.models import forward
    from repro_torch.models.sharding import param_pspec, use_mesh
    from repro_torch.train.train_step import grad_fn, make_loss_fn
    from repro_torch.util import tree_flatten

    cfg, mesh = _cfg(arch), _mesh(dp, tp)
    p = _params(cfg)
    tokens = _tokens(cfg, 4, seq + 1)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    loss_fn = make_loss_fn(cfg, fused_ce=fused_ce)
    ref = forward(p, cfg, batch)[0]
    sp = _place(p, mesh, param_pspec(mesh, p))
    sbatch = _place(batch, mesh, batch_pspec(mesh, batch))
    with use_mesh(mesh):
        _close(forward(sp, cfg, sbatch)[0], ref, 2e-5, f"{arch} logits")
        if not grads:
            return
        g, metrics = grad_fn(loss_fn, sp, sbatch)
    ref_g, ref_metrics = grad_fn(loss_fn, p, batch)
    _close(metrics["loss"], ref_metrics["loss"], 2e-5, f"{arch} loss")
    for i, (a, b, leaf) in enumerate(zip(g, ref_g, tree_flatten(sp)[0])):
        assert a.placements == leaf.placements, (i, a.placements, leaf.placements)
        _close(a, b, 1e-5, f"{arch} gradient {i} {tuple(b.shape)}")


def _decode(arch, dp, tp, B):
    from repro_torch.launch.shardings import cache_pspec
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.sharding import param_pspec, use_mesh

    cfg, mesh = _cfg(arch), _mesh(dp, tp)
    p = _params(cfg)
    prompt = _tokens(cfg, B, 8, seed=2)

    def run(params, cache, ctx):
        toks, logits = [], []
        with torch.no_grad(), ctx:
            out, cache, n = prefill(params, cfg, {"tokens": prompt}, cache)
            for i in range(5):
                logits.append(_full(out[:, -1]))
                toks.append(logits[-1].argmax(-1))
                if i < 4:
                    out, cache = decode_step(params, cfg, toks[-1][:, None], cache, n + i)
        return toks, logits, cache

    import contextlib

    cache = init_cache(cfg, B, 16, torch.float32, "cpu")
    spec = cache_pspec(mesh, cfg, cache)
    scache = _place(cache, mesh, spec)
    ref_toks, ref_logits, _ = run(p, cache, contextlib.nullcontext())
    toks, logits, scache = run(_place(p, mesh, param_pspec(mesh, p)), scache, use_mesh(mesh))
    for i, (a, b, la, lb) in enumerate(zip(toks, ref_toks, logits, ref_logits)):
        assert torch.equal(a, b), f"{arch} step {i}: tokens {a.tolist()} != {b.tolist()}"
        _close(la, lb, 2e-5, f"{arch} step {i} logits")
    return spec, scache


def case_mesh_constructors():
    """The twin of the JAX package's ``test_mesh_constructors``."""
    from repro_torch.launch.mesh import make_mesh, mesh_num_devices

    m = make_mesh(2, 2, device="cpu")
    assert m.mesh_dim_names == ("data", "model") and mesh_num_devices(m) == 4
    m2 = make_mesh(1, 2, pods=2, device="cpu")
    assert m2.mesh_dim_names == ("pod", "data", "model") and mesh_num_devices(m2) == 4
    try:
        make_mesh(2, 4, device="cpu")
    except ValueError as e:
        assert "8" in str(e) and "4" in str(e), e
    else:
        raise AssertionError("a (2, 4) mesh over 4 ranks")


def case_llama_forward_and_grads():
    _forward_and_grads("llama3-8b", 2, 2)


def case_olmoe_forward_and_grads():
    _forward_and_grads("olmoe-1b-7b", 2, 2)


def case_zamba2_forward_and_grads():
    _forward_and_grads("zamba2-1.2b", 2, 2)


def case_xlstm_forward():
    _forward_and_grads("xlstm-1.3b", 2, 2, grads=False)


def case_llama_gqa_tp_above_kv_heads():
    """tp 4 over 2 KV heads: each rank's query head reads its own KV group
    in the kernel's local call, and the decode cache (heads whole) shards
    its sequence over tp."""
    from torch.distributed.tensor import Shard

    _forward_and_grads("llama3-8b", 1, 4)
    _, cache = _decode("llama3-8b", 1, 4, B=4)
    assert cache["decoder"][0]["k"].placements == (Shard(0), Shard(1))


def _record_collectives(arch, kind):
    """One train step (remat, AdamW with bf16 moments) or one decode step of
    ``arch`` on the (2, 2) mesh under the dry-run's ``CollectiveRecorder``,
    on the dry-run's input dtypes (int32 tokens): rank 0 writes every
    recorded (op, result bytes, group's mesh dims) for the test to hold the
    dry-run's count to."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shardings import batch_pspec, cache_pspec, state_pspec
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.sharding import param_pspec, use_mesh
    from repro_torch.train import TrainState, adamw, make_train_step

    cfg, mesh = _cfg(arch), _mesh(2, 2)
    p = _params(cfg)
    rec = dryrun.CollectiveRecorder(mesh)
    if kind == "train":
        opt = adamw(1e-4, moment_dtype=torch.bfloat16)
        state = TrainState(p, opt.init(p))
        state = _place(state, mesh, state_pspec(mesh, state))
        tokens = _tokens(cfg, TRAIN_B, TRAIN_S + 1).to(torch.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        batch = _place(batch, mesh, batch_pspec(mesh, batch))
        step = make_train_step(cfg, opt, remat=True, fused_ce=False)
        with use_mesh(mesh), rec:
            step(state, batch)
    else:
        params = _place(p, mesh, param_pspec(mesh, p))
        cache = init_cache(cfg, DECODE_B, DECODE_S, torch.float32, "cpu")
        cache = _place(cache, mesh, cache_pspec(mesh, cfg, cache))
        toks = {"tokens": _tokens(cfg, DECODE_B, 1).to(torch.int32)}
        toks = _place(toks, mesh, batch_pspec(mesh, toks))["tokens"]
        with torch.no_grad(), use_mesh(mesh), rec:
            decode_step(params, cfg, toks, cache, DECODE_LEN)
    import torch.distributed as dist

    if dist.get_rank() == 0:
        with open(os.path.join(OUT_DIR, f"collectives_{arch}_{kind}.json"), "w") as f:
            json.dump({"events": rec.events}, f)


def case_llama_train_step_collectives():
    _record_collectives("llama3-8b", "train")


def case_llama_decode_step_collectives():
    _record_collectives("llama3-8b", "decode")


def case_olmoe_train_step_collectives():
    _record_collectives("olmoe-1b-7b", "train")


def case_zamba2_train_step_collectives():
    _record_collectives("zamba2-1.2b", "train")


# ---------------------------------------------------------------------------
# the spawn
# ---------------------------------------------------------------------------

def rank_main(cases, argv) -> None:
    """One rank: every case of ``cases`` ({name: function}) in order, each
    outcome written to ``rank<r>.json`` as it ends.  ``argv``: rank, port,
    output directory."""
    import torch.distributed as dist

    global OUT_DIR
    rank, port, out_dir = int(argv[0]), int(argv[1]), argv[2]
    OUT_DIR = out_dir
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    results = {}
    try:
        for name, fn in cases.items():
            t0 = time.perf_counter()
            try:
                fn()
                results[name] = [True, f"{time.perf_counter() - t0:.2f} s"]
            except Exception:  # noqa: BLE001 - reported to the test of that case
                results[name] = [False, traceback.format_exc()[-4000:]]
            with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(script: str, out) -> tuple:
    """``script`` run as ``WORLD`` rank processes (one gloo group), waited
    for at most ``TIMEOUT_S``; -> (each rank's outcomes, the PIDs killed at
    the timeout, each rank's stderr tail)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = []
    for r in range(WORLD):
        with open(out / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen([sys.executable, script, str(r), str(port), str(out)],
                                          env=env, stdout=subprocess.DEVNULL, stderr=err))
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    timed_out = [p.pid for p in procs if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    got = {}
    for r in range(WORLD):
        path = out / f"rank{r}.json"
        got[r] = json.loads(path.read_text()) if path.exists() else {}
    errs = {r: (out / f"rank{r}.err").read_text()[-2000:] for r in range(WORLD)}
    return got, timed_out, errs


def check_case(results, case) -> None:
    """``case`` passed on every rank."""
    got, timed_out, errs = results
    missing = [r for r in range(WORLD) if case not in got[r]]
    assert not missing, (f"ranks {missing} did not finish '{case}'"
                         f"{f' within {TIMEOUT_S} s' if timed_out else ''}: {errs[missing[0]]}")
    failed = {r: got[r][case][1] for r in range(WORLD) if not got[r][case][0]}
    assert not failed, f"'{case}' failed on ranks {sorted(failed)}:\n{next(iter(failed.values()))}"


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def results(ranks_dir):
    return run_ranks(os.path.abspath(__file__), ranks_dir)


@pytest.mark.parametrize("case", CASES)
def test_sharded(results, case):
    check_case(results, case)


if __name__ == "__main__":
    rank_main({name: globals()["case_" + name] for name in CASES}, sys.argv[1:])


# The dry-run's count of each collective case's step on a (2, 2) mesh of
# torch's fake process group (fake tensors, a child process) equals the
# gloo record of the same step on real tensors: the same ops, each as many
# times, moving the same wire bytes.


def _dryrun_collectives(arch, kind):
    from repro_torch.launch import dryrun
    from repro_torch.models.sharding import AbstractMesh

    mesh = AbstractMesh((2, 2), ("data", "model"))
    if kind == "train":
        count = dryrun.count_program(_cfg(arch), kind, TRAIN_B, TRAIN_S, [mesh], fused_ce=False,
                                     timeout=TIMEOUT_S)
    else:
        count = dryrun.count_program(_cfg(arch), kind, DECODE_B, DECODE_S, [mesh],
                                     cache_dtype=torch.float32, cache_len=DECODE_LEN,
                                     timeout=TIMEOUT_S)
    return count.collectives["2x2"]


def _by_op(stats):
    return {op: [n, stats.by_op[op]] for op, n in sorted(stats.counts.items())}


@pytest.mark.parametrize("case", list(COLLECTIVE_CASES))
def test_dryrun_collectives_beside_dtensor(results, ranks_dir, case):
    from repro_torch.launch import dryrun

    check_case(results, case)
    arch, kind = COLLECTIVE_CASES[case]
    record = json.loads((ranks_dir / f"collectives_{arch}_{kind}.json").read_text())
    dtensor = dryrun.event_stats(record["events"], (2, 2))
    count = _dryrun_collectives(arch, kind)
    print(f"{case}: op, DTensor on gloo [count, wire bytes], dry-run [count, wire bytes]")
    for op in sorted(set(dtensor.counts) | set(count.counts)):
        print(f"  {op}: {_by_op(dtensor).get(op)} {_by_op(count).get(op)}")
    assert dtensor.counts, record
    assert _by_op(count) == _by_op(dtensor)
    assert count.by_link == dtensor.by_link == {"nvlink": dtensor.wire_bytes}
