"""The port's serving plane: continuous batching against the JAX engine (the
dense, MoE, hybrid and xLSTM families, the vlm text-only), slot semantics,
the copied request plane, and the serve CLI on the CPU."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import request_plane as jrp  # noqa: E402
from repro.storage import KVStore as JKVStore  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig, serve_pending, submit_request  # noqa: E402
from repro_torch.serve import request_plane as rp  # noqa: E402
from repro_torch.storage import KVStore, ObjectStore  # noqa: E402

torch.set_num_threads(1)

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))
# the _setup settings of tests/test_serve_continuous.py
_SETUP = dict(max_batch=3, max_len=64, max_new_tokens=6, decode_chunk=2, prefill_bucket=8)
_PARAMS = {}


def _setup(arch="qwen3-32b", **kw):
    if arch not in _PARAMS:
        jp = jinit_params(JCONFIGS[arch].reduced(), jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                             CONFIGS[arch].reduced()))
    return CONFIGS[arch].reduced(), _PARAMS[arch], {**_SETUP, **kw}


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]


def _drain(eng):
    out = {}
    while eng.n_live():
        done, _ = eng.step_chunk()
        out.update({r: s.out for r, s in done.items()})
    return out


def test_greedy_tokens_match_jax_continuous_engine():
    cfg, (jp, tp), kw = _setup()
    prompts = _prompts(cfg, [3, 11, 7, 5, 9], seed=1)
    ids = [f"r{i}" for i in range(len(prompts))]

    jstore, jkv = JObjectStore(), JKVStore(num_shards=2)
    for r, p in zip(ids, prompts):
        jrp.submit(jstore, jkv, r, p)
    JContinuousEngine(JCONFIGS["qwen3-32b"].reduced(), jp, JServeConfig(**kw)).run(
        jstore, jkv, engine_id="e0", idle_timeout_s=0.3)
    exp = jrp.get_results(jstore, ids, timeout_s=5)

    store, kv = ObjectStore(), KVStore(num_shards=2)
    for r, p in zip(ids, prompts):
        rp.submit(store, kv, r, p)
    eng = ContinuousEngine(cfg, tp, ServeConfig(**kw), device="cpu")
    stats = eng.run(store, kv, engine_id="e0", idle_timeout_s=0.3)
    got = rp.get_results(store, ids, timeout_s=5)
    assert stats["served"] == len(ids)
    for r in ids:
        assert got[r]["tokens"] == exp[r]["tokens"], r


def test_hybrid_greedy_tokens_match_jax_continuous_engine():
    """zamba2 (reduced): prefill groups of one exact prompt length, one
    admission mid-batch, greedy tokens equal to the JAX engine's on the
    same weights.  No JAX test serves the hybrid, so the JAX engine is
    driven here the same way."""
    cfg, (jp, tp), kw = _setup("zamba2-1.2b", max_new_tokens=8)
    pa, pb, pc = _prompts(cfg, [5, 5, 11], seed=4)

    def drive(eng):
        eng.admit([("a", pa, 8), ("b", pb, 8)])  # one prefill group of length 5
        done, _ = eng.step_chunk(2)
        eng.admit([("c", pc, 8)])
        assert eng.stats["mid_batch_admissions"] == 1 and eng.stats["prefill_groups"] == 2
        out = {r: s.out for r, s in done.items()}
        while eng.n_live():
            done, _ = eng.step_chunk()
            out.update({r: s.out for r, s in done.items()})
        return out

    exp = drive(JContinuousEngine(JCONFIGS["zamba2-1.2b"].reduced(), jp, JServeConfig(**kw)))
    got = drive(ContinuousEngine(cfg, tp, ServeConfig(**kw), device="cpu"))
    assert sorted(got) == ["a", "b", "c"]
    for r in got:
        assert len(got[r]) == 8 and got[r] == exp[r], r


def test_xlstm_greedy_tokens_match_jax_continuous_engine():
    """xlstm (reduced): exact-length prefill groups (a one-token prompt
    among them, which takes the recurrent branch), one admission mid-batch,
    greedy tokens equal to the JAX engine's on the same weights -- the
    oracle tests/test_serve_continuous.py drives for xlstm."""
    cfg, (jp, tp), kw = _setup("xlstm-1.3b", max_new_tokens=8)
    pa, pb, pc, pd = _prompts(cfg, [6, 6, 13, 1], seed=6)

    def drive(eng):
        eng.admit([("a", pa, 8), ("b", pb, 8)])  # one prefill group of length 6
        done, _ = eng.step_chunk(2)
        eng.admit([("c", pc, 8)])
        assert eng.stats["mid_batch_admissions"] == 1 and eng.stats["prefill_groups"] == 2
        out = {r: s.out for r, s in done.items()}
        while eng.n_live() == 3:
            done, _ = eng.step_chunk(1)
            out.update({r: s.out for r, s in done.items()})
        eng.admit([("d", pd, 8)])
        while eng.n_live():
            done, _ = eng.step_chunk()
            out.update({r: s.out for r, s in done.items()})
        return out

    exp = drive(JContinuousEngine(JCONFIGS["xlstm-1.3b"].reduced(), jp, JServeConfig(**kw)))
    got = drive(ContinuousEngine(cfg, tp, ServeConfig(**kw), device="cpu"))
    assert sorted(got) == ["a", "b", "c", "d"]
    for r in got:
        assert len(got[r]) == 8 and got[r] == exp[r], r


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_greedy_tokens_match_jax_continuous_engine(arch):
    """MoE (reduced; deepseek with MLA's latent cache): prompts right-padded
    to the same prefill buckets of 8 with token 0 on both sides (the pad
    tokens take expert capacity), one group of two prompts, admissions
    mid-batch, greedy tokens equal to the JAX engine's on the same
    weights (the JAX package serves deepseek, tests/test_serve_continuous.py)."""
    cfg, (jp, tp), kw = _setup(arch, max_new_tokens=8)
    pa, pb, pc, pd = _prompts(cfg, [5, 7, 11, 1], seed=8)

    def drive(eng):
        eng.admit([("a", pa, 8), ("b", pb, 8)])  # one prefill group, bucket 8
        done, _ = eng.step_chunk(2)
        eng.admit([("c", pc, 8)])
        out = {r: s.out for r, s in done.items()}
        while eng.n_live() == 3:
            done, _ = eng.step_chunk(1)
            out.update({r: s.out for r, s in done.items()})
        eng.admit([("d", pd, 8)])
        assert eng.stats["mid_batch_admissions"] == 2 and eng.stats["prefill_groups"] == 3
        while eng.n_live():
            done, _ = eng.step_chunk()
            out.update({r: s.out for r, s in done.items()})
        return out

    exp = drive(JContinuousEngine(JCONFIGS[arch].reduced(), jp, JServeConfig(**kw)))
    got = drive(ContinuousEngine(cfg, tp, ServeConfig(**kw), device="cpu"))
    assert sorted(got) == ["a", "b", "c", "d"]
    for r in got:
        assert len(got[r]) == 8 and got[r] == exp[r], r


def test_vlm_text_only_greedy_tokens_match_jax_continuous_engine():
    """internvl2 (reduced) behind the continuous engine: no request carries
    a prefix, so it serves text only on both sides (QKV bias, GQA group 2,
    tied head); buckets of 8, one admission mid-batch."""
    cfg, (jp, tp), kw = _setup("internvl2-1b", max_new_tokens=8)
    pa, pb, pc = _prompts(cfg, [5, 12, 3], seed=9)

    def drive(eng):
        eng.admit([("a", pa, 8), ("b", pb, 8)])
        done, _ = eng.step_chunk(2)
        eng.admit([("c", pc, 8)])
        assert eng.stats["mid_batch_admissions"] == 1
        out = {r: s.out for r, s in done.items()}
        while eng.n_live():
            done, _ = eng.step_chunk()
            out.update({r: s.out for r, s in done.items()})
        return out

    exp = drive(JContinuousEngine(JCONFIGS["internvl2-1b"].reduced(), jp, JServeConfig(**kw)))
    got = drive(ContinuousEngine(cfg, tp, ServeConfig(**kw), device="cpu"))
    assert sorted(got) == ["a", "b", "c"]
    for r in got:
        assert len(got[r]) == 8 and got[r] == exp[r], r


def test_mid_stream_admission_without_draining():
    cfg, (_, tp), kw = _setup(max_new_tokens=10)
    scfg = ServeConfig(**kw)
    eng = ContinuousEngine(cfg, tp, scfg, device="cpu")
    pa, pb = _prompts(cfg, [5, 9])
    eng.admit([("a", pa, 10)])
    eng.step_chunk(2)
    a_slot = next(s for s in eng.slots if s is not None)
    a_pos = int(eng.cache_lens[eng.slots.index(a_slot)])
    assert len(a_slot.out) == 3  # 1 at admit + 2 decode steps
    eng.admit([("b", pb, 10)])
    assert eng.stats["mid_batch_admissions"] == 1 and eng.n_live() == 2
    assert len(a_slot.out) == 3
    assert int(eng.cache_lens[eng.slots.index(a_slot)]) == a_pos
    finished = _drain(eng)
    ref = Engine(cfg, tp, scfg, device="cpu")
    for rid, prompt in (("a", pa), ("b", pb)):
        assert finished[rid] == ref.generate(np.asarray([prompt]))[0].tolist(), rid


def test_slot_reuse_never_reads_prior_occupants_kv():
    cfg, (_, tp), kw = _setup(max_batch=1)
    scfg = ServeConfig(**kw)
    eng = ContinuousEngine(cfg, tp, scfg, device="cpu")
    long_p, short_p = _prompts(cfg, [40, 4], seed=3)
    eng.admit([("long", long_p, 6)])
    _drain(eng)
    eng.admit([("short", short_p, 6)])
    out = _drain(eng)
    fresh = ContinuousEngine(cfg, tp, scfg, device="cpu")
    fresh.admit([("short", short_p, 6)])
    assert out["short"] == _drain(fresh)["short"]


def test_serve_pending_publishes_batch_results_once():
    cfg, (_, tp), kw = _setup()
    eng = Engine(cfg, tp, ServeConfig(**kw), device="cpu")
    store = ObjectStore()
    prompts = _prompts(cfg, [4, 6], seed=2)
    for i, p in enumerate(prompts):
        submit_request(store, f"s{i}", p)
    assert serve_pending(store, eng, batch_size=8) == 2
    assert serve_pending(store, eng, batch_size=8) == 0  # already served
    padded = np.zeros((2, 6), np.int32)
    padded[0, 2:], padded[1] = prompts[0], prompts[1]  # left-padded, as served
    exp = eng.generate(padded)
    for i in range(2):
        assert store.get(f"serve/done/s{i}")["tokens"] == exp[i].tolist()


def test_lease_lapse_reaped_and_requeued_exactly_once():
    store, kv = ObjectStore(), KVStore(num_shards=2)
    rp.submit(store, kv, "r0", [1, 2, 3])
    leased = rp.lease_requests(store, kv, "dead", 4, lease_timeout_s=0.05)
    assert [r for r, _ in leased] == ["r0"]
    assert kv.llen(rp.queue_key(0)) == 0
    time.sleep(0.06)  # the lease lapses (its engine is "dead")
    assert rp.reap_expired(store, kv) == 1
    assert rp.reap_expired(store, kv) == 0  # exactly once
    relea = rp.lease_requests(store, kv, "alive", 4)
    assert [r for r, _ in relea] == ["r0"]
    rec = kv.mget([rp.lease_key("r0")])[0]
    assert rec["engine"] == "alive" and rec["term"] == 2


def test_sampled_decode_is_per_request_deterministic():
    cfg, (_, tp), kw = _setup(temperature=0.8)
    prompt = _prompts(cfg, [6], seed=5)[0]

    def serve(ids):
        store, kv = ObjectStore(), KVStore(num_shards=2)
        for r in ids:
            rp.submit(store, kv, r, prompt)
        ContinuousEngine(cfg, tp, ServeConfig(**kw), device="cpu").run(
            store, kv, engine_id="e", idle_timeout_s=0.3)
        return rp.get_results(store, ids, timeout_s=5)

    both = serve(["x", "y"])
    assert both["x"]["tokens"] != both["y"]["tokens"]  # independent streams
    assert serve(["x"])["x"]["tokens"] == both["x"]["tokens"]  # batch-invariant replay


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
         "--demo-requests", "4", "--idle-timeout", "0.5", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "READY engine-0"
    assert "served 4 requests, 16 tokens" in lines[-1]


def test_serve_cli_serves_the_hybrid_on_cpu():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "zamba2-1.2b", "--reduced",
         "--device", "cpu", "--demo-requests", "4", "--idle-timeout", "0.5",
         "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "READY engine-0"
    assert "served 4 requests, 16 tokens" in lines[-1]


def test_serve_cli_serves_xlstm_on_cpu():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "xlstm-1.3b", "--reduced",
         "--device", "cpu", "--demo-requests", "4", "--idle-timeout", "0.5",
         "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "READY engine-0"
    assert "served 4 requests, 16 tokens" in lines[-1]


def test_serve_cli_serves_olmoe_on_cpu():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmoe-1b-7b", "--reduced",
         "--device", "cpu", "--demo-requests", "4", "--idle-timeout", "0.5",
         "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "READY engine-0"
    assert "served 4 requests, 16 tokens" in lines[-1]


def test_serve_cli_serves_internvl2_text_only_on_cpu():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "internvl2-1b", "--reduced",
         "--device", "cpu", "--demo-requests", "4", "--idle-timeout", "0.5",
         "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "READY engine-0"
    assert "served 4 requests, 16 tokens" in lines[-1]


def test_serve_cli_refuses_whisper_as_the_jax_cli_does():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "whisper-large-v3",
         "--reduced", "--device", "cpu", "--demo-requests", "1"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "READY" not in proc.stdout
    assert "NotImplementedError: encdec serving needs encoder inputs per request" in proc.stderr


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(CONFIGS["llama3-8b"].reduced(), {}, ServeConfig())
