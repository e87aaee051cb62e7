"""The port's model layers and models (dense, MoE with MLA and MTP, zamba2
hybrid, xLSTM, the vlm text-only) against the JAX package's; whisper and
the vlm's prefix are in `tests/test_torch_encdec.py`.

Weights come from `repro.models.init_params` at PRNGKey(0), converted by
`repro_torch.bridge`; inputs are made with numpy from a seed and fed to
both frameworks.  Tolerances: fp32 1e-5 for single layers, 2e-3 for model
logits and decode-vs-forward (`test_decode_matches_forward_exactly`'s bar).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache_update as jcu  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache_update as tcu  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402

torch.set_num_threads(1)

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-3, rtol=1e-3)

# (arch, n_kv_heads override): reduced() gives 4/4 heads (group 1); the
# override makes group 2 so GQA grouping is held against JAX at model level
MODEL_CASES = [
    ("llama3-8b", None),
    ("qwen3-32b", None),      # qk-norm
    ("gemma2-27b", None),     # window, softcaps, sandwich norms, tied head
    ("llama3-8b", 2),         # GQA group 2
    ("zamba2-1.2b", None),    # hybrid: 4 layers, shared_attn_every=2
    ("zamba2-1.2b", 5),       # hybrid with a tail layer
    ("xlstm-1.3b", None),     # ssm: one group of 3 mLSTM + 1 sLSTM, mLSTM head dim 64
    ("xlstm-1.3b", 8),        # ssm: two groups
    ("internvl2-1b", None),   # vlm, text only (no prefix_embed): QKV bias, group 2, tied head
]
_CACHE = {}


def _cfgs(arch, kv=None):
    """Reduced configs; ``kv`` overrides n_kv_heads, except for the hybrid
    and ssm families where it overrides n_layers (hybrid 5: two super
    blocks of 2 and a tail; ssm 8: two groups)."""
    jc, tc = JCONFIGS[arch].reduced(), TCONFIGS[arch].reduced()
    if kv is not None:
        field = "n_layers" if jc.family in ("hybrid", "ssm") else "n_kv_heads"
        jc, tc = dataclasses.replace(jc, **{field: kv}), dataclasses.replace(tc, **{field: kv})
    return jc, tc


def _params(arch, kv=None):
    if (arch, kv) not in _CACHE:
        jc, tc = _cfgs(arch, kv)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
        _CACHE[(arch, kv)] = (jc, tc, jp, tp)
    return _CACHE[(arch, kv)]


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm():
    x, w = _rand(0, (2, 5, 64)), _rand(1, (64,)) * 0.1
    _close(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6), LAYER_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    x = _rand(2, (3, 6, 4, 32))
    pos = np.arange(6)[None] + (np.asarray([[0], [7], [130]]) if per_row else 0)
    out = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    _close(out, exp, LAYER_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(act):
    x = _rand(3, (2, 5, 32))
    p = {k: _rand(i + 4, s) * 0.2 for i, (k, s) in enumerate(
        [("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))])}
    out = tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), act)
    exp = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    _close(out, exp, LAYER_TOL)


@pytest.mark.parametrize("index", [5, np.asarray([0, 9, 3], np.int32)])
def test_write_row(index):
    cache, row = _rand(7, (3, 10, 2, 8)), _rand(8, (3, 1, 2, 8))
    idx_t = torch.from_numpy(index) if isinstance(index, np.ndarray) else index
    out = tcu.write_row(torch.from_numpy(cache.copy()), torch.from_numpy(row), idx_t)
    exp = jcu.write_row(jnp.asarray(cache), jnp.asarray(row), jnp.asarray(index), dus_ok=False)
    _close(out, exp, dict(atol=0, rtol=0))


def test_insert_rows_and_write_segment():
    big, small = _rand(9, (4, 2, 10, 8)), _rand(10, (2, 2, 10, 8))
    slots = np.asarray([3, 1])
    out = tcu.insert_rows(torch.from_numpy(big.copy()), torch.from_numpy(small),
                          torch.from_numpy(slots), axis=0)
    exp = jcu.insert_rows(jnp.asarray(big), jnp.asarray(small), jnp.asarray(slots), axis=0)
    _close(out, exp, dict(atol=0, rtol=0))
    cache, seg = _rand(11, (2, 10, 2, 8)), _rand(12, (2, 6, 2, 8))
    out = tcu.write_segment(torch.from_numpy(cache.copy()), torch.from_numpy(seg), 0)
    exp = jcu.write_segment(jnp.asarray(cache), jnp.asarray(seg), 0, dus_ok=False)
    _close(out, exp, dict(atol=0, rtol=0))


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_attn_apply(mode):
    jc, tc, jp, tp = _params("qwen3-32b", 2)
    jpa = jax.tree_util.tree_map(lambda a: a[0, 0], jp["decoder"]["attn"])
    tpa = tp["decoder"][0]["attn"]
    B, S, max_len = 3, (1 if mode == "decode" else 9), 16
    x = _rand(13, (B, S, jc.d_model))
    kw_j, kw_t = {}, {}
    if mode != "no_cache":
        kc = _rand(14, (B, max_len, jc.n_kv_heads, jc.hd))
        vc = _rand(15, (B, max_len, jc.n_kv_heads, jc.hd))
        kw_j["cache"] = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
        kw_t["cache"] = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
        if mode == "prefill":
            kw_j["cache_len"], kw_t["cache_len"] = jnp.int32(0), 0
        else:
            clen = np.asarray([0, 5, 11], np.int32)  # a dead slot, two live ones
            kw_j["cache_len"], kw_t["cache_len"] = jnp.asarray(clen), torch.from_numpy(clen)
            kw_j["positions"] = jnp.asarray(clen)[:, None]
            kw_t["positions"] = torch.from_numpy(clen)[:, None]
    out_j, cache_j = jattn.attn_apply(jpa, jnp.asarray(x), jc, **kw_j)
    out_t, cache_t = tattn.attn_apply(tpa, torch.from_numpy(x), tc, **kw_t)
    _close(out_t, out_j, LAYER_TOL)
    if mode != "no_cache":
        for k in ("k", "v"):
            _close(cache_t[k], cache_j[k], LAYER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    x, k, b = _rand(16, (2, 7, 12)), _rand(17, (4, 12)), _rand(18, (12,))
    st = _rand(19, (2, 3, 12)) if with_state else None
    y, ns = tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                                  None if st is None else torch.from_numpy(st))
    ey, ens = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    _close(y, ey, LAYER_TOL)
    _close(ns, ens, LAYER_TOL)


def test_causal_conv1d_casts_the_state_to_the_activations_dtype():
    """An fp32 cache state under bf16 compute: no promotion, and the new
    state carries the bf16-rounded values (what the cache then stores)."""
    x = torch.from_numpy(_rand(20, (1, 2, 8))).bfloat16()
    st = torch.from_numpy(_rand(21, (1, 3, 8))) / 3
    y, ns = tlayers.causal_conv1d(x, torch.ones((4, 8), dtype=torch.bfloat16), None, st)
    assert y.dtype == ns.dtype == torch.bfloat16
    torch.testing.assert_close(ns[:, :1].float(), st[:, 2:].bfloat16().float(), rtol=0, atol=0)


def test_grouped_rmsnorm():
    x, w = _rand(22, (2, 5, 64)), _rand(23, (64,)) * 0.1
    _close(tlayers.grouped_rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 4, eps=1e-5),
           jlayers.grouped_rmsnorm(jnp.asarray(x), jnp.asarray(w), 4, eps=1e-5), LAYER_TOL)


@pytest.mark.parametrize("mode", ["forward", "prefill", "decode"])
def test_mamba2_apply(mode):
    jc, tc, jp, tp = _params("zamba2-1.2b")
    jpm = jax.tree_util.tree_map(lambda a: a[0, 1], jp["decoder"]["super"])
    tpm = tp["decoder"]["super"][0][1]
    B, S = 2, (1 if mode == "decode" else 21)  # 21: a ragged second chunk of 16
    x = _rand(24, (B, S, jc.d_model))
    js = ts = None
    if mode != "forward":
        st = jmamba.init_mamba_state(jc, B)
        if mode == "decode":  # a live state: the decode step must carry it
            st = {"conv": jnp.asarray(_rand(25, st["conv"].shape)),
                  "ssm": jnp.asarray(_rand(26, st["ssm"].shape))}
        js = st
        ts = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    out_j, st_j = jmamba.mamba2_apply(jpm, jnp.asarray(x), jc, state=js)
    out_t, st_t = tmamba.mamba2_apply(tpm, torch.from_numpy(x), tc, state=ts)
    _close(out_t, out_j, MODEL_TOL)
    if mode != "forward":
        for k in ("conv", "ssm"):
            assert st_t[k].dtype == torch.float32
            _close(st_t[k], st_j[k], MODEL_TOL)


XL_MODES = ["forward", "prefill", "decode", "prompt1"]


def _xl_state(init_fn, jc, B, mode, seed):
    """A JAX state and its torch copy: fresh for prefill and a one-token
    prompt, live (random, m finite) for a decode step."""
    st = init_fn(jc, B)
    if mode == "decode":
        st = {k: jnp.asarray(_rand(seed + i, v.shape) - (3.0 if k == "m" else 0.0))
              for i, (k, v) in enumerate(st.items())}
        if "h" not in st:  # the mLSTM normalizer state n stays positive-ish
            st["n"] = jnp.abs(st["n"])
    return st, {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


@pytest.mark.parametrize("mode", XL_MODES)
def test_mlstm_block_apply(mode):
    """The mLSTM block in its three modes and a one-token prompt (which takes
    the recurrent branch, as in the JAX block).  The prefill state comes
    from the closed form here and from the step-by-step replay in JAX:
    c and n at 1e-4 of their largest entry, m at 1e-5."""
    jc, tc, jp, tp = _params("xlstm-1.3b")
    jpm = jax.tree_util.tree_map(lambda a: a[0, 1], jp["decoder"]["mlstm"])
    tpm = tp["decoder"][0]["m"][1]
    B, S = 2, {"forward": 21, "prefill": 37, "decode": 1, "prompt1": 1}[mode]
    x = _rand(27, (B, S, jc.d_model))
    js = ts = None
    if mode != "forward":
        js, ts = _xl_state(jxl.init_mlstm_state, jc, B, mode, 28)
    out_j, st_j = jxl.mlstm_block_apply(jpm, jnp.asarray(x), jc, state=js)
    out_t, st_t = txl.mlstm_block_apply(tpm, torch.from_numpy(x), tc, state=ts)
    _close(out_t, out_j, MODEL_TOL)
    if mode != "forward":
        for k in ("conv", "c", "n", "m"):
            assert st_t[k].dtype == torch.float32
            exp = np.asarray(st_j[k])
            rel = 1e-5 if k == "m" else 1e-4
            err = np.abs(st_t[k].numpy() - exp).max()
            assert err <= rel * np.abs(exp).max() + (1e-6 if k == "conv" else 0.0), (k, err)


@pytest.mark.parametrize("mode", XL_MODES)
def test_slstm_block_apply(mode):
    jc, tc, jp, tp = _params("xlstm-1.3b")
    jps = jax.tree_util.tree_map(lambda a: a[0], jp["decoder"]["slstm"])
    tps = tp["decoder"][0]["s"]
    B, S = 2, {"forward": 21, "prefill": 13, "decode": 1, "prompt1": 1}[mode]
    x = _rand(29, (B, S, jc.d_model))
    js = ts = None
    if mode != "forward":
        js, ts = _xl_state(jxl.init_slstm_state, jc, B, mode, 30)
    out_j, st_j = jxl.slstm_block_apply(jps, jnp.asarray(x), jc, state=js)
    out_t, st_t = txl.slstm_block_apply(tps, torch.from_numpy(x), tc, state=ts)
    _close(out_t, out_j, MODEL_TOL)
    if mode != "forward":
        for k in ("conv", "c", "n", "m", "h"):
            _close(st_t[k], st_j[k], MODEL_TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch,kv", MODEL_CASES)
def test_forward_logits_match_jax(arch, kv):
    jc, tc, jp, tp = _params(arch, kv)
    toks = _tokens(jc, 2, 24, 0)
    exp, _, _ = jmodel.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    out, aux, extras = tmodel.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    _close(out, exp, MODEL_TOL)
    assert float(aux) == 0.0 and extras == {}


@pytest.mark.parametrize("arch,kv", MODEL_CASES)
def test_decode_matches_forward_exactly(arch, kv):
    """Torch twin of tests/test_models.py::test_decode_matches_forward_exactly."""
    _, tc, _, tp = _params(arch, kv)
    B, S_prompt, n_dec = 2, 12, 3
    toks = torch.from_numpy(_tokens(tc, B, S_prompt + n_dec, 1)).long()
    full, _, _ = tmodel.forward(tp, tc, {"tokens": toks})
    cache = tmodel.init_cache(tc, B, S_prompt + n_dec + 4, torch.float32, "cpu")
    lg, cache, clen = tmodel.prefill(tp, tc, {"tokens": toks[:, :S_prompt]}, cache)
    torch.testing.assert_close(lg[:, -1], full[:, S_prompt - 1], **MODEL_TOL)
    for t in range(n_dec):
        lg, cache = tmodel.decode_step(tp, tc, toks[:, S_prompt + t][:, None], cache, clen)
        clen += 1
        torch.testing.assert_close(lg[:, 0], full[:, S_prompt + t], **MODEL_TOL)


MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]  # deepseek: MLA, dense prefix, MTP


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch):
    """Logits, the summed MoE aux loss and (deepseek) the MTP head's logits."""
    jc, tc, jp, tp = _params(arch)
    toks = _tokens(jc, 2, 24, 0)
    exp, aux_j, ex_j = jmodel.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    out, aux_t, ex_t = tmodel.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    _close(out, exp, MODEL_TOL)
    _close(aux_t, aux_j, MODEL_TOL)
    assert sorted(ex_t) == sorted(ex_j) == (["mtp_logits"] if jc.mtp_depth else [])
    for k in ex_t:
        assert ex_t[k].shape == (2, 23, jc.vocab_size)
        _close(ex_t[k], ex_j[k], MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch):
    """Prefill then 3 decode steps with per-slot lengths, against JAX's
    prefill and decode on the same batch (so the same tokens share each
    capacity group on both sides)."""
    jc, tc, jp, tp = _params(arch)
    B, S_prompt, n_dec, max_len = 2, 12, 3, 20
    toks = _tokens(jc, B, S_prompt + n_dec, 1)
    jcache = jmodel.init_cache(jc, B, max_len, cache_dtype=jnp.float32)
    tcache = tmodel.init_cache(tc, B, max_len, torch.float32, "cpu")
    lg_j, jcache, _ = jmodel.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :S_prompt])}, jcache)
    lg_t, tcache, _ = tmodel.prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :S_prompt]).long()},
                                     tcache)
    _close(lg_t, lg_j, MODEL_TOL)
    clen = np.full((B,), S_prompt, np.int32)
    for t in range(n_dec):
        step = toks[:, S_prompt + t][:, None]
        lg_j, jcache = jmodel.decode_step(jp, jc, jnp.asarray(step), jcache, jnp.asarray(clen))
        lg_t, tcache = tmodel.decode_step(tp, tc, torch.from_numpy(step).long(), tcache,
                                          torch.from_numpy(clen))
        _close(lg_t, lg_j, MODEL_TOL)
        clen = clen + 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_close_to_forward(arch):
    """Torch twin of tests/test_models.py::test_decode_close_for_moe:
    capacity may drop other tokens at another batch composition, so the
    prefill's last logits need only be close to the forward's (top token
    agreeing on at least half the rows, max error < 0.2)."""
    _, tc, _, tp = _params(arch)
    B, S_prompt = 2, 12
    toks = torch.from_numpy(_tokens(tc, B, S_prompt + 1, 1)).long()
    full, _, _ = tmodel.forward(tp, tc, {"tokens": toks})
    cache = tmodel.init_cache(tc, B, S_prompt + 8, torch.float32, "cpu")
    lg, cache, _ = tmodel.prefill(tp, tc, {"tokens": toks[:, :S_prompt]}, cache)
    top_full, top_pre = full[:, S_prompt - 1].argmax(-1), lg[:, -1].argmax(-1)
    assert (top_full == top_pre).float().mean() >= 0.5
    assert (lg[:, -1] - full[:, S_prompt - 1]).abs().max().item() < 0.2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cache_layout_matches_jax(arch):
    """{"dense_prefix": [...], "decoder": [...]}: a KV dict per layer, or
    MLA's latent dict, each leaf the JAX stack's (n, 1, ...) slice."""
    jc, tc, _, _ = _params(arch)
    jcache = jmodel.init_cache(jc, 3, 16, cache_dtype=jnp.float32)
    tcache = tmodel.init_cache(tc, 3, 16, torch.float32, "cpu")
    assert sorted(tcache) == sorted(jcache)
    for stage, layers in tcache.items():
        for name, leaf in jcache[stage].items():
            assert leaf.shape[:2] == (len(layers), 1)
            assert all(tuple(lay[name].shape) == leaf.shape[2:] for lay in layers)
    axes = tmodel.cache_batch_axes(tc)
    assert all(a == 0 for a in jax.tree_util.tree_leaves(axes))


def test_unknown_family_raises():
    """As JAX's `init_params` does: ValueError naming the family."""
    cfg = dataclasses.replace(TCONFIGS["llama3-8b"].reduced(), family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        tmodel.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        tmodel.init_cache(cfg, 1, 8, torch.float32, "cpu")
