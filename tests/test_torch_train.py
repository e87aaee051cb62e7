"""The port's training path (`repro_torch.train`, `repro_torch.data`)
against the JAX package's (`repro.train`, `repro.data`), on the CPU.

Inputs are made with numpy from a seed, or taken from the JAX side
(`repro.data.synthetic_batch`, `repro.models.init_params` at a PRNGKey,
converted by `repro_torch.bridge`), and fed to both frameworks; all in fp32
at reduced widths.  Tolerances:

- optimizer updates (fp32 moments) 1e-6 relative; int8 moments: codes
  equal but for at most ``Q8_TIE_CODES`` entries one code apart (a
  division that lands within an ulp of a rounding tie), scales within
  1e-7 (absolute: XLA contracts the moment update into fused multiply-adds,
  so a block's max may differ by an ulp, 1.1e-7 relative); schedules 1e-7;
  ``clip_by_global_norm`` 1e-6;
- the fused CE: value 1e-6, gradients 1e-5;
- losses and every metric 1e-5; gradients per leaf within 1e-4 of the
  leaf's max |g|;
- five train steps: losses 1e-4, parameters 1e-5 but for at most 1e-4 of
  the elements, all within 0.1 lr (see the test); the bridged fp32
  moments within 1e-4 of each leaf's max.
"""

import dataclasses
import pickle
import pickletools
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import synthetic_batch as j_synthetic_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import fused_ce as jfce  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.core import WrenExecutor  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels._build import PlainBackwardFn  # noqa: E402
from repro_torch.kernels import mamba2_ssd as smod  # noqa: E402
from repro_torch.kernels import mlstm as mmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import init_params as t_init_params  # noqa: E402
from repro_torch.storage import ObjectStore  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import elastic as tel  # noqa: E402
from repro_torch.train import fused_ce as tfce  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.util import tree_flatten, tree_map, tree_unflatten  # noqa: E402

torch.set_num_threads(1)

Q8_TIE_CODES = 4  # int8 codes allowed one apart over the test's leaves and steps (measured: 0)

CFG = TCONFIGS["llama3-8b"].reduced()
DCFG = DataConfig(seq_len=24, global_batch=4, vocab_size=CFG.vocab_size)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

TREE_SHAPES = {"a": (37, 64), "b": (300,), "c": {"d": (8, 32), "e": (5, 3, 7)}}


def _rand_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    leaves, struct = tree_flatten(TREE_SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    return tree_unflatten(struct, [(rng.normal(size=s) * scale).astype(np.float32) for s in leaves])


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return tree_map(_t, tree)


def _j_state_to_port(js):
    """The same flat tree on both sides, so q8 leaves ({"q", "scale"}) map one to one."""
    m, v = (jax.tree_util.tree_map(lambda x: _t(np.asarray(x)), t) for t in (js.m, js.v))
    return topt.AdamWState(step=torch.tensor(int(js.step), dtype=torch.int32), m=m, v=v)


# grad scales per step: a jump makes the new gradient dominate the moments,
# so the update's RMS leaves 1 and the int8 path's clip acts
GRAD_SCALES = [1.0, 0.03, 30.0, 1.0]


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_matches_jax_over_steps(quantize):
    sched_j = jopt.cosine_schedule(1e-2, warmup=2, total=10)
    sched_t = topt.cosine_schedule(1e-2, warmup=2, total=10)
    jo = jopt.adamw(sched_j, quantize_moments=quantize)
    to = topt.adamw(sched_t, quantize_moments=quantize)
    params = _rand_tree(0)
    js = jo.init(_jtree(params))
    code_diffs = 0
    for i, scale in enumerate(GRAD_SCALES):
        grads = _rand_tree(10 + i, scale)
        ts = _j_state_to_port(js)  # each step from JAX's state: no drift
        ju, js = jo.update(_jtree(grads), js, _jtree(params))
        tu, ts2 = to.update(_ttree(grads), ts, _ttree(params))
        for j, t in zip(jax.tree_util.tree_leaves(ju), tree_flatten(tu)[0]):
            j, t = np.asarray(j), t.numpy()
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6 * np.abs(j).max())
        assert int(ts2.step) == int(js.step) == i + 1
        if quantize:
            jl = jax.tree_util.tree_leaves((js.m, js.v))
            tl = tree_flatten((ts2.m, ts2.v))[0]
            for j, t in zip(jl, tl):
                j, t = np.asarray(j), t.numpy()
                if j.dtype == np.int8:
                    diff = np.abs(j.astype(np.int32) - t.astype(np.int32))
                    assert diff.max() <= 1
                    code_diffs += int((diff > 0).sum())
                else:
                    np.testing.assert_allclose(t, j, rtol=0, atol=1e-7)
        else:
            for j, t in zip(jax.tree_util.tree_leaves((js.m, js.v)), tree_flatten((ts2.m, ts2.v))[0]):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, jax.device_get(ju))
    assert code_diffs <= Q8_TIE_CODES, f"{code_diffs} int8 codes one apart"


@pytest.mark.parametrize("kind", ["constant", "cosine"])
def test_schedules_match_jax(kind):
    if kind == "constant":
        j, t = jopt.constant_schedule(3e-4), topt.constant_schedule(3e-4)
    else:
        j, t = jopt.cosine_schedule(1e-3, warmup=7, total=40), topt.cosine_schedule(1e-3, 7, 40)
    for step in range(51):
        exp = float(j(jnp.asarray(step, jnp.int32)))
        got = float(t(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(exp, rel=1e-7, abs=1e-12), step


def test_clip_by_global_norm_matches_jax():
    grads = _rand_tree(3, 2.0)
    jg, jn = jopt.clip_by_global_norm(_jtree(grads), 1.5)
    tg, tn = topt.clip_by_global_norm(_ttree(grads), 1.5)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for j, t in zip(jax.tree_util.tree_leaves(jg), tree_flatten(tg)[0]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_update_equals_update_then_apply(quantize, dtype):
    opt = topt.adamw(topt.cosine_schedule(1e-2, 1, 10), quantize_moments=quantize)
    params = tree_map(lambda a: _t(a).to(dtype), _rand_tree(0))
    state = opt.init(params)
    for i, scale in enumerate(GRAD_SCALES):
        grads = tree_map(lambda a: _t(a).to(dtype), _rand_tree(20 + i, scale))
        clipped, norm = topt.clip_by_global_norm(grads, 1.0)
        upd, exp_state = opt.update(clipped, state, params)
        exp_params = topt.apply_updates(params, upd)
        p2 = tree_map(torch.clone, params)
        s2 = topt.AdamWState(state.step.clone(), tree_map(torch.clone, state.m),
                             tree_map(torch.clone, state.v))
        flat_g = tree_flatten(grads)[0]
        got_state = opt.update_(flat_g, s2, p2, grad_scale=topt.clip_factor(norm, 1.0))
        assert all(g is None for g in flat_g)  # the update consumed the gradients
        for a, b in zip(tree_flatten((exp_params, exp_state))[0], tree_flatten((p2, got_state))[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        params, state = exp_params, exp_state


# ---------------------------------------------------------------------------
# fused cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,chunk", [(None, 64), (30.0, 48), (None, 8192)])
def test_fused_ce_matches_jax_and_plain(cap, chunk):
    rng = np.random.default_rng(5)
    N, D, V = 37, 24, 200  # V not a multiple of 48 or 64
    h = rng.normal(size=(N, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, size=(N,)).astype(np.int32)
    labels[[3, 10, 11]] = -1  # ignore-index rows

    def jloss(h, W):
        nll, cnt = jfce.fused_cross_entropy(h, W, jnp.asarray(labels), final_softcap=cap,
                                            vocab_chunk=chunk)
        return nll, cnt

    (jn, jc), (jdh, jdW) = jloss(jnp.asarray(h), jnp.asarray(W)), jax.grad(
        lambda h, W: jloss(h, W)[0], argnums=(0, 1))(jnp.asarray(h), jnp.asarray(W))
    th, tW = _t(h).requires_grad_(True), _t(W).requires_grad_(True)
    tn, tc = tfce.fused_cross_entropy(th, tW, _t(labels), final_softcap=cap, vocab_chunk=chunk)
    dh, dW = torch.autograd.grad(tn, (th, tW))
    assert int(tc) == int(jc) == N - 3
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dW.numpy(), np.asarray(jdW), atol=1e-5, rtol=1e-5)
    # the port's own plain CE over materialised logits
    ph, pW = _t(h).requires_grad_(True), _t(W).requires_grad_(True)
    logits = (ph @ pW).float()
    if cap:
        logits = cap * torch.tanh(logits / cap)
    pn, _ = tts.cross_entropy(logits[None], _t(labels)[None])
    pdh, pdW = torch.autograd.grad(pn, (ph, pW))
    assert float(tn) == pytest.approx(float(pn), rel=1e-6)
    torch.testing.assert_close(dh, pdh, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dW, pdW, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# loss, gradients, train step
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(arch, **changes):
    key = (arch, tuple(sorted(changes.items())))
    if key not in _MODELS:
        jc = dataclasses.replace(JCONFIGS[arch].reduced(), **changes)
        tc = dataclasses.replace(TCONFIGS[arch].reduced(), **changes)
        jp = j_init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _batches(jc, seq=16, batch=2, step=0):
    jb = j_synthetic_batch(JDataConfig(seq_len=seq, global_batch=batch,
                                       vocab_size=jc.vocab_size), step, jc)
    nb = {k: np.asarray(v) for k, v in jb.items()}
    return {k: jnp.asarray(v) for k, v in nb.items()}, {k: _t(v) for k, v in nb.items()}


LOSS_CASES = [
    ("llama3-8b", {}),
    ("olmoe-1b-7b", {"n_layers": 2}),  # MoE aux loss
    ("deepseek-v3-671b", {"n_layers": 2}),  # MLA, dense prefix, MTP head
    ("internvl2-1b", {"n_layers": 2}),  # prefix labels set to -1
    ("zamba2-1.2b", {}),  # Mamba2 super blocks + the shared attention block
    ("xlstm-1.3b", {}),  # mLSTM blocks + an sLSTM block
    ("whisper-large-v3", {"n_layers": 2}),  # encoder over the audio frames
]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch,changes", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_and_metrics_match_jax(arch, changes, fused):
    jc, tc, jp, tp = _model(arch, **changes)
    jb, tb = _batches(jc)
    jl, jm = jts.make_loss_fn(jc, fused_ce=fused)(jp, jb)
    tl, tm = tts.make_loss_fn(tc, fused_ce=fused)(tp, tb)
    assert set(tm) == set(jm)
    assert float(tl) == pytest.approx(float(jl), **dict(rel=1e-5, abs=1e-5))
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    if arch == "internvl2-1b":
        assert int(tm["tokens"]) == tb["labels"].numel()  # the prefix rows carry no loss
    if arch == "deepseek-v3-671b":
        assert "mtp_nll" in tm and "router_aux" in tm


def test_gradients_match_jax_and_remat_changes_nothing():
    jc, tc, jp, tp = _model("llama3-8b", n_layers=2)
    jb, tb = _batches(jc)
    jg = jax.grad(lambda p: jts.make_loss_fn(jc)(p, jb)[0])(jp)
    jg_port = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), tc)
    grads = {}
    for remat in (False, True):
        g, _ = tts.grad_fn(tts.make_loss_fn(tc, remat=remat), tp, tb)
        grads[remat] = g
    for a, b, j in zip(grads[False], grads[True], tree_flatten(jg_port)[0]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        tol = 1e-4 * float(j.abs().max())
        assert float((a - j).abs().max()) <= tol
        assert float(a.abs().max()) > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_gradients_match_jax(arch):
    """The hybrid's SSD scan and the xLSTM's cells (JAX: its jnp scan on
    the CPU) under autograd, remat on: each leaf within 1e-4 of its max."""
    jc, tc, jp, tp = _model(arch)
    jb, tb = _batches(jc)
    jg = jax.grad(lambda p: jts.make_loss_fn(jc)(p, jb)[0])(jp)
    jg_port = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), tc)
    g, _ = tts.grad_fn(tts.make_loss_fn(tc, remat=True), tp, tb)
    for a, j in zip(g, tree_flatten(jg_port)[0]):
        assert float((a - j).abs().max()) <= 1e-4 * float(j.abs().max())
        assert float(a.abs().max()) > 0


def _moment_errors(jtree, ttree, tc):
    """Each leaf's largest |port - JAX| over the JAX leaf's largest |value|."""
    exp = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), tc)
    return [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(tree_flatten(ttree)[0], tree_flatten(exp)[0])]


def test_optimizer_moments_match_jax_on_the_same_gradients():
    """The two AdamW updates alone: JAX's five clipped gradients, each at
    JAX's parameters of that step, fed to both optimizers.  With the same
    inputs the moments agree to 1e-6 of each leaf's max (measured on the
    CPU: bit for bit, 0.0) and the updates to 1e-6 (measured 1.9e-7)."""
    jc, tc, jp, tp = _model("llama3-8b", n_layers=2)
    jo = jopt.adamw(jopt.cosine_schedule(3e-3, warmup=2, total=5))
    to = topt.adamw(topt.cosine_schedule(3e-3, warmup=2, total=5))
    loss = jts.make_loss_fn(jc)
    grad = jax.jit(jax.grad(lambda p, b: loss(p, b)[0]))
    params, jstate, tstate = jp, jo.init(jp), to.init(tp)
    for i in range(5):
        jb, _ = _batches(jc, step=i)
        g, _ = jopt.clip_by_global_norm(grad(params, jb), 1.0)
        to_port = partial(params_from_jax, cfg=tc)
        jup, jstate = jo.update(g, jstate, params)
        tup, tstate = to.update(to_port(jax.tree_util.tree_map(np.asarray, g)), tstate,
                                to_port(jax.tree_util.tree_map(np.asarray, params)))
        params = jopt.apply_updates(params, jup)
    assert max(_moment_errors(jstate.m, tstate.m, tc)) <= 1e-6
    assert max(_moment_errors(jstate.v, tstate.v, tc)) <= 1e-6
    assert max(_moment_errors(jup, tup, tc)) <= 1e-6


def test_five_train_steps_match_jax():
    """Five whole train steps (loss, clipped gradients, AdamW) from the same
    parameters.  The moments agree within 1e-5 of each leaf's max after
    step 1 (measured on the CPU: 2.2e-6 for m, 2.6e-6 for v).  After that
    the parameters differ (Adam moves an element whose gradient is near 0
    by up to lr in a direction its noise sets), so the later gradients are
    taken at slightly different points: the moments' drift measured 1.04e-4
    after step 2 and 0.88e-4, 0.88e-4, 1.00e-4 (m; v 8.3e-5) after steps
    3-5, spread over 19 of the 21 leaves, and never growing.  So each leaf
    of the 5-step moments is held to 3e-4 of its max (3x the worst measured
    drift), and the drift after step 5 to at most twice the drift after
    step 2 (no accumulation).  Optimizer parity on equal gradients is
    `test_optimizer_moments_match_jax_on_the_same_gradients` (1e-6)."""
    jc, tc, jp, tp = _model("llama3-8b", n_layers=2)
    jo = jopt.adamw(jopt.cosine_schedule(3e-3, warmup=2, total=5))
    to = topt.adamw(topt.cosine_schedule(3e-3, warmup=2, total=5))
    jstate = jts.TrainState(params=jp, opt_state=jo.init(jp))
    tstate = tts.TrainState(params=tp, opt_state=to.init(tp))
    jstep = jax.jit(jts.make_train_step(jc, jo))
    tstep = tts.make_train_step(tc, to)
    drift = []
    for i in range(5):
        jb, tb = _batches(jc, step=i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4, abs=1e-4)
        drift.append(max(_moment_errors(jstate.opt_state.m, tstate.opt_state.m, tc)
                         + _moment_errors(jstate.opt_state.v, tstate.opt_state.v, tc)))
        if i == 0:
            assert drift[0] <= 1e-5
    # Adam moves an element whose gradient is near 0 by up to lr in a
    # direction set by that gradient's noise, so a few elements miss 1e-5
    # (measured: 14 of 459392, the worst 1.1e-4 = 0.036 lr); every element
    # stays within 0.1 lr
    exp = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), tc)
    diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in
                       zip(tree_flatten(tstate.params)[0], tree_flatten(exp)[0])])
    assert int((diffs > 1e-5).sum()) <= 1e-4 * diffs.numel()
    assert float(diffs.max()) <= 0.1 * 3e-3
    # JAX's fp32 moments have the parameter tree's structure: the bridge
    # converts them as it converts the parameters
    assert int(tstate.opt_state.step) == int(jstate.opt_state.step) == 5
    assert drift[4] <= 3e-4 and drift[4] <= 2 * drift[1]


@pytest.mark.parametrize("arch,seq", [
    ("gemma2-27b", 24), ("zamba2-1.2b", 24), ("olmoe-1b-7b", 24), ("whisper-large-v3", 24),
    ("xlstm-1.3b", 320),  # S > 256: the plain mLSTM's blockwise scan
])
def test_backward_through_every_stage_with_remat(arch, seq):
    """No op on the no-cache forward path writes into a tensor autograd
    saved: every family's stages (remat on) give finite gradients, and the
    blockwise mLSTM's gradients equal the naive reference's."""
    cfg = TCONFIGS[arch].reduced()
    p = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = synthetic_batch(DataConfig(seq_len=seq, global_batch=1, vocab_size=cfg.vocab_size), 0, cfg)
    grads, m = tts.grad_fn(tts.make_loss_fn(cfg, remat=True), p, batch)
    assert np.isfinite(float(m["loss"])) and all(bool(torch.isfinite(g).all()) for g in grads)
    if arch == "xlstm-1.3b":
        rng = np.random.default_rng(3)
        ins = [_t(rng.normal(size=s).astype(np.float32)) for s in ((1, seq, 2, 16),) * 3]
        gates = [_t(rng.normal(size=(1, seq, 2)).astype(np.float32) + b) for b in (0.0, 2.0)]
        a = [t.clone().requires_grad_(True) for t in ins + gates]
        b = [t.clone().requires_grad_(True) for t in ins + gates]
        ga = torch.autograd.grad(mmod.mlstm_plain(*a).sum(), a)
        gb = torch.autograd.grad(mmod.mlstm_reference(*b).sum(), b)
        for x, y in zip(ga, gb):
            assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())


def _fresh_state(opt, seed=0):
    return tts.init_train_state(CFG, opt, torch.Generator().manual_seed(seed), "cpu")


def test_adamw_reduces_loss():
    opt = topt.adamw(3e-3, weight_decay=0.0)
    state = _fresh_state(opt)
    step = tts.make_train_step(CFG, opt)
    losses = []
    for i in range(25):
        state, m = step(state, synthetic_batch(DCFG, i % 4, CFG))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_int8_optimizer_trains_in_place():
    opt = topt.adamw(3e-3, quantize_moments=True)
    state = _fresh_state(opt)
    step = tts.make_train_step(CFG, opt, inplace=True, fused_ce=True, remat=True)
    losses = []
    for i in range(15):
        state, m = step(state, synthetic_batch(DCFG, i % 4, CFG))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_microbatch_equivalence():
    """grad accumulation over microbatches == single big batch (same loss)."""
    opt = topt.adamw(1e-3)
    state = _fresh_state(opt, 1)
    batch = synthetic_batch(DCFG, 0, CFG)
    s1, m1 = tts.make_train_step(CFG, opt, microbatches=1)(state, batch)
    s2, m2 = tts.make_train_step(CFG, opt, microbatches=2)(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    p1, p2 = tree_flatten(s1.params)[0][0], tree_flatten(s2.params)[0][0]
    torch.testing.assert_close(p1, p2, atol=2e-4, rtol=0)


def test_grad_clip_bounds_update():
    opt = topt.adamw(1e-3)
    state = _fresh_state(opt)
    new_state, _ = tts.make_train_step(CFG, opt, grad_clip=1e-9)(state, synthetic_batch(DCFG, 0, CFG))
    delta = topt.global_norm(tree_map(lambda a, b: a - b, new_state.params, state.params))
    assert float(delta) < 1.0


# ---------------------------------------------------------------------------
# PlainBackwardFn: the backward plumbing, with the plain forward plugged in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=5, logit_cap=20.0),
                                dict(causal=False, scale=0.3)])
def test_flash_attention_fn_backward_equals_autograd_of_plain(kw):
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32))
               for s in ((2, 13, 4, 16), (2, 13, 2, 16), (2, 13, 2, 16)))
    go = _t(rng.normal(size=(2, 13, 4, 16)).astype(np.float32))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = fmod.flash_attention_plain
    out = PlainBackwardFn.apply(plain, plain, kw, *ins)
    got = torch.autograd.grad(out, ins, go)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    exp_out = fmod.flash_attention_plain(*ref, **kw)
    exp = torch.autograd.grad(exp_out, ref, go)
    torch.testing.assert_close(out, exp_out, atol=0, rtol=0)
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the SSD scan and the mLSTM through PlainBackwardFn, the plain forward plugged in
# ---------------------------------------------------------------------------

def _fn_and_plain(run, base, go):
    """[(output, grads of every leaf)] of ``run(leaves, through_fn)``
    through the Function and through the plain version, each from fresh
    leaves of ``base`` (None stays None)."""
    runs = []
    for through_fn in (True, False):
        leaves = [None if t is None else t.clone().requires_grad_(True) for t in base]
        out = run(leaves, through_fn)
        runs.append((out, torch.autograd.grad(out, [t for t in leaves if t is not None], go)))
    return runs


def _assert_bit_equal(runs, n_grads):
    (out, got), (exp_out, exp) = runs
    torch.testing.assert_close(out, exp_out, atol=0, rtol=0)
    assert len(got) == len(exp) == n_grads
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("S,chunk,with_d", [(37, 16, True), (64, 16, False), (5, 16, True)])
def test_ssd_fn_backward_equals_autograd_of_plain(S, chunk, with_d):
    """A ragged last chunk, D = None, S below the chunk; x, B and C are
    views of one conv-output buffer, taken as they are."""
    rng = np.random.default_rng(S)
    Bz, H, G, P, N = 2, 4, 2, 8, 8
    d_in, gn = H * P, G * N
    xbc = _t(rng.normal(size=(Bz, S, d_in + 2 * gn)).astype(np.float32))
    dt = _t(np.log1p(np.exp(rng.normal(size=(Bz, S, H)))).astype(np.float32))
    A = _t(-np.exp(rng.normal(size=(H,))).astype(np.float32))
    D = _t(rng.normal(size=(H,)).astype(np.float32)) if with_d else None
    go = _t(rng.normal(size=(Bz, S, H, P)).astype(np.float32))
    kw = dict(chunk=chunk, return_state=False)

    def run(leaves, through_fn):
        xbc, dt, A, D = leaves
        x = xbc[..., :d_in].reshape(Bz, S, H, P)
        Bm = xbc[..., d_in:d_in + gn].reshape(Bz, S, G, N)
        Cm = xbc[..., d_in + gn:].reshape(Bz, S, G, N)
        assert not x.is_contiguous()
        if through_fn:
            return PlainBackwardFn.apply(smod.ssd_plain, smod.ssd_plain, kw, x, dt, A, Bm, Cm, D)
        return smod.ssd_plain(x, dt, A, Bm, Cm, D, **kw)

    _assert_bit_equal(_fn_and_plain(run, (xbc, dt, A, D), go), 4 if with_d else 3)


def test_ssd_plain_gradient_is_finite_where_a_chunk_decay_overflows():
    """zamba2-1.2b's A = -(1..64) and dt up to 0.1 make a 128-row chunk's
    decay exp(a_t - a_s) overflow fp32 above the diagonal, which the scan
    masks away.  JAX's jnp scan masks after the exp, so its gradient is
    nan there (0 * inf); the port masks before it: the same forward, and
    the gradient of the same function taken with chunks short enough not
    to overflow (JAX's, at chunk 8)."""
    rng = np.random.default_rng(12)
    Bz, S, H, G, P, N = 1, 160, 4, 1, 8, 8
    x, Bm, Cm = (rng.normal(size=s).astype(np.float32)
                 for s in ((Bz, S, H, P), (Bz, S, G, N), (Bz, S, G, N)))
    dt = rng.uniform(0.05, 0.1, size=(Bz, S, H)).astype(np.float32)
    A = -np.array([1.0, 8.0, 32.0, 64.0], np.float32)
    D = np.ones((H,), np.float32)

    def jgrads(chunk):
        def f(*args):
            return jops.ssd_scan(*args, chunk=chunk).sum()

        return jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)))

    assert any(bool(jnp.isnan(g).any()) for g in jgrads(128))
    exp = jgrads(8)
    ins = [_t(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm, D)]
    y = smod.ssd_plain(*ins, chunk=128)
    got = torch.autograd.grad(y.sum(), ins)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk=128)),
        rtol=2e-5, atol=2e-5)
    for a, j in zip(got, exp):
        j = np.asarray(j)
        assert bool(torch.isfinite(a).all())
        assert float(np.abs(a.numpy() - j).max()) <= 1e-4 * float(np.abs(j).max())


def test_ssd_fn_refuses_the_state(monkeypatch):
    """Under autograd on the card (the CPU stands in) ``ops.ssd_scan``
    refuses the final state, naming the kernel."""
    monkeypatch.setattr(ops, "_grad_on_card", lambda *t: True)
    x = torch.zeros((1, 4, 2, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd"):
        ops.ssd_scan(x, torch.ones((1, 4, 2)), -torch.ones(2), torch.zeros((1, 4, 1, 8)),
                     torch.zeros((1, 4, 1, 8)), None, chunk=4, return_state=True)


@pytest.mark.parametrize("S", [13, 320])  # the reference; the blockwise scan (S > 256)
def test_mlstm_fn_backward_equals_autograd_of_plain(S):
    rng = np.random.default_rng(S)
    B, H, D = 1, 2, 16
    base = [_t(rng.normal(size=(B, S, H, D)).astype(np.float32)) for _ in range(3)]
    base += [_t((rng.normal(size=(B, S, H)) + b).astype(np.float32)) for b in (0.0, 2.0)]
    go = _t(rng.normal(size=(B, S, H, D)).astype(np.float32))

    def run(leaves, through_fn):
        if through_fn:
            return PlainBackwardFn.apply(mmod.mlstm_plain, mmod.mlstm_plain, {}, *leaves)
        return mmod.mlstm_plain(*leaves)

    _assert_bit_equal(_fn_and_plain(run, base, go), 5)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_ops_route_through_the_functions_under_remat(monkeypatch, arch):
    """``ops`` as it routes on the card (the CPU stands in: its plain
    versions, counted, take the kernels' place): under per-layer remat each
    layer's Function runs its forward twice (the forward, then the
    recompute) and its backward once, and the gradients equal the plain
    path's bit for bit."""
    cfg = TCONFIGS[arch].reduced()
    p = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = synthetic_batch(DataConfig(seq_len=24, global_batch=2, vocab_size=cfg.vocab_size),
                            0, cfg)
    loss_fn = tts.make_loss_fn(cfg, remat=True)
    exp, _ = tts.grad_fn(loss_fn, p, batch)
    name, plain = (("ssd_kernel", smod.ssd_plain) if arch == "zamba2-1.2b"
                   else ("mlstm_kernel", mmod.mlstm_plain))
    calls = {"forward": 0, "backward": 0}

    def kernel(*a, **k):
        calls["forward"] += 1
        return plain(*a, **k)

    orig = PlainBackwardFn.backward

    def backward(ctx, *g):
        calls["backward"] += ctx.plain is plain
        return orig(ctx, *g)

    monkeypatch.setattr(ops, "_grad_on_card", lambda *t: torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in t))
    monkeypatch.setattr(ops, name, kernel)
    monkeypatch.setattr(PlainBackwardFn, "backward", staticmethod(backward))
    got, _ = tts.grad_fn(loss_fn, p, batch)
    layers = cfg.n_layers  # the hybrid's Mamba layers; the xLSTM's mLSTM blocks:
    if arch == "xlstm-1.3b":
        layers -= cfg.n_layers // cfg.xlstm.slstm_every
    assert calls == {"forward": 2 * layers, "backward": layers}
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_batch_is_a_pure_function_with_the_chain_structure():
    d = DataConfig(seq_len=256, global_batch=8, vocab_size=1000)
    a, b, c = synthetic_batch(d, 3), synthetic_batch(d, 3), synthetic_batch(d, 4)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    toks, labels = a["tokens"], a["labels"]
    assert toks.shape == labels.shape == (8, 256) and toks.dtype == torch.int32
    assert torch.equal(toks[:, 1:], labels[:, :-1])  # labels are the shifted tokens
    follows = (labels.long() == (31 * toks.long() + 17) % 1000).float().mean().item()
    assert abs(follows - 0.85) <= 0.03
    assert int(toks.min()) >= 0 and int(toks.max()) < 1000


@pytest.mark.parametrize("arch,key,shape", [
    ("internvl2-1b", "prefix_embed", lambda c: (2, c.num_prefix_tokens, c.d_model)),
    ("whisper-large-v3", "audio_frames", lambda c: (2, c.encoder_seq, c.d_model)),
])
def test_synthetic_batch_stub_shapes(arch, key, shape):
    cfg = TCONFIGS[arch].reduced()
    b = synthetic_batch(DataConfig(seq_len=8, global_batch=2, vocab_size=cfg.vocab_size), 0, cfg)
    assert tuple(b[key].shape) == shape(cfg) and b[key].dtype == torch.float32
    assert 0.01 < float(b[key].std()) < 0.03


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _mixed_tree():
    rng = np.random.default_rng(4)
    return {
        "w": rng.normal(size=(7, 9)).astype(np.float32),
        "b16": rng.normal(size=(300,)).astype(np.float32),  # bf16 on both sides
        "q": rng.integers(-127, 128, size=(3, 256)).astype(np.int8),
        "step": np.asarray(7, np.int32),
    }


def _port_tree(tree):
    out = {k: _t(v) for k, v in tree.items()}
    out["b16"] = out["b16"].to(torch.bfloat16)
    return out


def test_checkpoint_round_trip_of_every_leaf_dtype():
    store = ObjectStore()
    state = (_port_tree(_mixed_tree()), [torch.ones(3)])
    assert ck.save(store, "r", 0, state)
    loaded, meta, v = ck.load(store, "r", 0)
    assert v == 0 and meta == {}
    for a, b in zip(tree_flatten(state)[0], tree_flatten(loaded)[0]):
        # a 0-d leaf comes back as (1,), as the JAX package's does
        assert b.shape == (a.shape or (1,)) and a.dtype == b.dtype
        assert torch.equal(a.reshape(b.shape), b)
    assert isinstance(loaded, tuple) and isinstance(loaded[1], list)


def test_checkpoint_layout_and_bytes_match_jax():
    tree = _mixed_tree()
    jtree = dict(tree, b16=jnp.asarray(tree["b16"], jnp.bfloat16))
    jstore, tstore = JObjectStore(), ObjectStore()
    jck.save(jstore, "x", 2, jtree)
    ck.save(tstore, "x", 2, _port_tree(tree))
    jkeys, tkeys = jstore.list("ckpt/"), tstore.list("ckpt/")
    assert jkeys == tkeys
    jman, tman = jstore.get(jck._manifest_key("x", 2)), tstore.get(ck._manifest_key("x", 2))
    assert [dict(d, shape=tuple(d["shape"])) for d in jman["descs"]] == tman["descs"]
    for key in jkeys:
        if not key.endswith("manifest"):
            assert jstore.get_bytes(key) == tstore.get_bytes(key), key


def test_checkpoint_versions_gc_and_duplicate_publish():
    store = ObjectStore()
    state = _port_tree(_mixed_tree())
    assert ck.save(store, "g", 0, state)
    assert not ck.save(store, "g", 0, state)  # a duplicate loses the publish
    for v in range(1, 5):
        ck.save(store, "g", v, state, meta={"step": v})
    assert ck.latest_version(store, "g") == 4
    assert ck.gc_old_versions(store, "g", keep=2) > 0
    assert ck.latest_version(store, "g") == 4
    assert sorted({k.split("/")[2] for k in store.list("ckpt/g/")}) == ["v00000003", "v00000004"]
    with pytest.raises(Exception):
        ck.load(store, "g", 0)


class _NoGlobals(pickle.Unpickler):
    def find_class(self, module, name):
        raise AssertionError(f"manifest pickles {module}.{name}")


def test_manifest_holds_no_pickled_object_from_outside():
    store = ObjectStore()
    opt = topt.adamw(1e-3, quantize_moments=True)
    ck.save(store, "m", 0, tuple(_fresh_state(opt)), meta={"step": 0, "metrics": {"loss": 1.5}})
    blob = store.get_bytes(ck._manifest_key("m", 0))
    payload = bytes(memoryview(blob)[13:])  # past the RWRN header
    assert not [op for op, _, _ in pickletools.genops(payload) if "GLOBAL" in op.name]
    man = _NoGlobals(__import__("io").BytesIO(payload)).load()
    assert man["run"] == "m" and man["meta"]["metrics"]["loss"] == 1.5


# ---------------------------------------------------------------------------
# elastic training through the port's runtime
# ---------------------------------------------------------------------------

def test_elastic_train_with_scale_and_resume():
    opt = topt.adamw(2e-3)
    batch_fn = partial(synthetic_batch, DCFG, cfg=CFG)
    wex = WrenExecutor(num_workers=2)
    try:
        tcfg = tel.ElasticTrainConfig(run="el", steps_per_chunk=2, total_steps=8)
        hist = tel.train_elastic(wex, CFG, opt, tcfg, batch_fn, scale_plan={2: 3}, device="cpu")
        assert len(hist) == 4
        assert ck.latest_version(wex.store, "el") == 4
        assert sum(h["warm_start"] for h in hist) >= 2  # warm-container reuse
        tcfg2 = tel.ElasticTrainConfig(run="el", steps_per_chunk=2, total_steps=12)
        hist2 = tel.train_elastic(wex, CFG, opt, tcfg2, batch_fn, device="cpu")
        assert len(hist2) == 2
        assert ck.latest_version(wex.store, "el") == 6
    finally:
        wex.shutdown()
        tel.WARM_CACHE.clear()


def test_elastic_chunk_duplicates_write_identical_bytes():
    opt = topt.adamw(1e-3, quantize_moments=True)
    batch_fn = partial(synthetic_batch, DCFG, cfg=CFG)
    store = ObjectStore()
    tcfg = tel.ElasticTrainConfig(run="det", steps_per_chunk=2, total_steps=4)
    ck.save(store, "det", 0, tuple(_fresh_state(opt)))
    chunk = tel.make_chunk_fn(CFG, opt, store, tcfg, batch_fn, "cpu")
    chunk = pickle.loads(pickle.dumps(chunk))  # ships with the standard pickle
    try:
        chunk(0)
        blobs = {k: store.get_bytes(k) for k in store.list("ckpt/det/v00000001/")}
        tel.WARM_CACHE.clear()
        for k in store.list("ckpt/det/v00000001/"):
            store.delete(k)
        chunk(0)
        again = {k: store.get_bytes(k) for k in store.list("ckpt/det/v00000001/")}
    finally:
        tel.WARM_CACHE.clear()
    assert blobs.keys() == again.keys() and len(blobs) > 1
    assert all(blobs[k] == again[k] for k in blobs if "/leaf/" in k)
