"""The port's enc-dec family (whisper-large-v3: encoder, cross-attending
decoder, learned positions) and the VLM prefix (internvl2-1b) against the
JAX package's.

Reduced configs in fp32 (whisper: 2 encoder + 4 decoder layers, d_model
128, encoder_seq 16; internvl2: 4 layers, 4 prefix rows); weights from
`repro.models.init_params` at PRNGKey(0) through `repro_torch.bridge`;
inputs from numpy with a seed, fed to both frameworks.  Tolerances are the
reference's: attention 2e-5 (`tests/test_kernels.py`), logits and decode
against forward 2e-3 (`tests/test_models.py`), greedy tokens identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig  # noqa: E402
from repro_torch.util import tree_flatten, tree_map  # noqa: E402

torch.set_num_threads(1)

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=2e-3, rtol=1e-3)
WHISPER, VLM = "whisper-large-v3", "internvl2-1b"
_CACHE = {}


def _params(arch, **changes):
    key = (arch, tuple(sorted(changes.items())))
    if key not in _CACHE:
        jc = dataclasses.replace(JCONFIGS[arch].reduced(), **changes)
        tc = dataclasses.replace(TCONFIGS[arch].reduced(), **changes)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
        _CACHE[key] = (jc, tc, jp, tp)
    return _CACHE[key]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _batches(cfg, toks, seed):
    """The same batch for both frameworks: tokens plus the family's stub
    input at scale 0.1 (as `tests/test_models.py` makes it)."""
    np_batch = {"tokens": toks}
    if cfg.family == "encdec":
        np_batch["audio_frames"] = _rand(seed, (toks.shape[0], cfg.encoder_seq, cfg.d_model), 0.1)
    if cfg.frontend == "vision_stub":
        np_batch["prefix_embed"] = _rand(seed, (toks.shape[0], cfg.num_prefix_tokens, cfg.d_model), 0.1)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
          for k, v in np_batch.items()}
    return jb, tb


def _layer(jp, tp, stage, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], jp[stage]), tp[stage][i]


# ---------------------------------------------------------------------------
# whisper: cross-attention and the stages
# ---------------------------------------------------------------------------

def test_cross_kv_init_matches_jax():
    jc, tc, jp, tp = _params(WHISPER)
    jl, tl = _layer(jp, tp, "decoder", 1)
    enc = _rand(0, (2, jc.encoder_seq, jc.d_model))
    jk, jv = jattn.cross_kv_init(jl["cross_attn"], jnp.asarray(enc), jc)
    tk, tv = tattn.cross_kv_init(tl["cross_attn"], torch.from_numpy(enc), tc)
    assert tk.shape == (2, jc.encoder_seq, jc.n_kv_heads, jc.hd)
    _close(tk, jk, ATTN_TOL)
    _close(tv, jv, ATTN_TOL)


@pytest.mark.parametrize("S", [1, 7])  # a decode step, a prompt
def test_cross_attn_apply_matches_jax(S):
    jc, tc, jp, tp = _params(WHISPER)
    jl, tl = _layer(jp, tp, "decoder", 2)
    x, enc = _rand(1, (3, S, jc.d_model)), _rand(2, (3, jc.encoder_seq, jc.d_model))
    jkv = jattn.cross_kv_init(jl["cross_attn"], jnp.asarray(enc), jc)
    tkv = tattn.cross_kv_init(tl["cross_attn"], torch.from_numpy(enc), tc)
    out_j, cj = jattn.attn_apply(jl["cross_attn"], jnp.asarray(x), jc, cross_kv=jkv)
    out_t, ct = tattn.attn_apply(tl["cross_attn"], torch.from_numpy(x), tc, cross_kv=tkv)
    assert cj is None and ct is None
    _close(out_t, out_j, ATTN_TOL)


def test_cross_attn_with_bias_matches_jax():
    """``wq_b`` is added to q (the cross K/V take ``wk_b``/``wv_b``): whisper
    has no bias, so a reduced whisper with ``attn_bias`` and random biases."""
    jc, tc, jp, tp = _params(WHISPER)
    jc, tc = (dataclasses.replace(c, attn_bias=True) for c in (jc, tc))
    jl, tl = _layer(jp, tp, "decoder", 0)
    bias = {k: _rand(3 + i, (jc.n_heads, jc.hd)) for i, k in enumerate(("wq_b", "wk_b", "wv_b"))}
    jpa = {**jl["cross_attn"], **{k: jnp.asarray(v) for k, v in bias.items()}}
    tpa = {**tl["cross_attn"], **{k: torch.from_numpy(v) for k, v in bias.items()}}
    x, enc = _rand(6, (2, 5, jc.d_model)), _rand(7, (2, jc.encoder_seq, jc.d_model))
    jkv = jattn.cross_kv_init(jpa, jnp.asarray(enc), jc)
    tkv = tattn.cross_kv_init(tpa, torch.from_numpy(enc), tc)
    out_j, _ = jattn.attn_apply(jpa, jnp.asarray(x), jc, cross_kv=jkv)
    out_t, _ = tattn.attn_apply(tpa, torch.from_numpy(x), tc, cross_kv=tkv)
    _close(out_t, out_j, ATTN_TOL)


def test_encoder_stage_matches_jax():
    jc, tc, jp, tp = _params(WHISPER)
    h = _rand(8, (2, jc.encoder_seq, jc.d_model))
    out_j = jtfm.encoder_stage_apply(jp["encoder"], jnp.asarray(h), jc)
    out_t = ttfm.encoder_stage_apply(tp["encoder"], torch.from_numpy(h), tc)
    _close(out_t, out_j, MODEL_TOL)


def _self_cache(jc, B, max_len, seed):
    """A random self-attention cache per layer: JAX's stacked (L, ...), the
    port's list of {"self": kv}."""
    shape = (jc.n_layers, B, max_len, jc.n_kv_heads, jc.hd)
    kc, vc = _rand(seed, shape), _rand(seed + 1, shape)
    jcache = {"self": {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}}
    tcache = [{"self": {"k": torch.from_numpy(kc[i].copy()), "v": torch.from_numpy(vc[i].copy())}}
              for i in range(jc.n_layers)]
    return jcache, tcache


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_xdecoder_stage_matches_jax(mode):
    """No cache (cross K/V from the encoder output), prefill into a fresh
    cache (adds the cross K/V), and a decode step with per-row lengths that
    reads the cross K/V from the cache (the encoder output is not given)."""
    jc, tc, jp, tp = _params(WHISPER)
    B, max_len = 3, 16
    S = 1 if mode == "decode" else 9
    h = _rand(9, (B, S, jc.d_model))
    enc = _rand(10, (B, jc.encoder_seq, jc.d_model))
    kw_j = dict(enc_out=jnp.asarray(enc), positions=jnp.arange(S))
    kw_t = dict(enc_out=torch.from_numpy(enc), positions=torch.arange(S))
    if mode == "prefill":
        jcache = jmodel.init_cache(jc, B, max_len, cache_dtype=jnp.float32)["decoder"]
        tcache = tmodel.init_cache(tc, B, max_len, torch.float32, "cpu")["decoder"]
        kw_j.update(cache=jcache, cache_len=jnp.int32(0))
        kw_t.update(cache=tcache, cache_len=0)
    elif mode == "decode":
        jcache, tcache = _self_cache(jc, B, max_len, 11)
        ck = _rand(13, (jc.n_layers, B, jc.encoder_seq, jc.n_kv_heads, jc.hd))
        cv = _rand(14, ck.shape)
        jcache["cross"] = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
        for i, c in enumerate(tcache):
            c["cross"] = {"k": torch.from_numpy(ck[i].copy()), "v": torch.from_numpy(cv[i].copy())}
        clen = np.asarray([0, 5, 11], np.int32)
        kw_j = dict(positions=jnp.asarray(clen)[:, None], cache=jcache, cache_len=jnp.asarray(clen))
        kw_t = dict(positions=torch.from_numpy(clen)[:, None], cache=tcache,
                    cache_len=torch.from_numpy(clen))
    out_j, cache_j = jtfm.xdecoder_stage_apply(jp["decoder"], jnp.asarray(h), jc, **kw_j)
    out_t, cache_t = ttfm.xdecoder_stage_apply(tp["decoder"], torch.from_numpy(h), tc, **kw_t)
    _close(out_t, out_j, MODEL_TOL)
    if mode == "no_cache":
        assert cache_j is None and cache_t is None
        return
    for i, c in enumerate(cache_t):
        assert sorted(c) == ["cross", "self"]
        for part in ("self", "cross"):
            for k in ("k", "v"):
                _close(c[part][k], cache_j[part][k][i], ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_adds_cross_cache_in_the_activations_dtype(dtype):
    """After prefill each layer's cache holds "cross" K/V of shape (B,
    S_enc, K, hd) in the activations' dtype, not ``cache_dtype`` (fp32
    here), as in JAX: with bf16 activations a bf16 cross cache."""
    _, tc, _, tp = _params(WHISPER)
    tc = dataclasses.replace(tc, dtype=dtype, param_dtype=dtype)
    tp = tree_map(lambda t: t.to(getattr(torch, dtype)), tp)
    B = 2
    cache = tmodel.init_cache(tc, B, 16, torch.float32, "cpu")
    assert all(sorted(c) == ["self"] for c in cache["decoder"])
    _, tb = _batches(tc, _tokens(tc, B, 5, 0), 1)
    _, cache, n = tmodel.prefill(tp, tc, tb, cache)
    assert n == 5
    for c in cache["decoder"]:
        for k in ("k", "v"):
            assert c["cross"][k].shape == (B, tc.encoder_seq, tc.n_kv_heads, tc.hd)
            assert c["cross"][k].dtype == getattr(torch, dtype)
            assert c["self"][k].dtype == torch.float32


# ---------------------------------------------------------------------------
# whisper: the model
# ---------------------------------------------------------------------------

def test_whisper_forward_logits_match_jax():
    jc, tc, jp, tp = _params(WHISPER)
    jb, tb = _batches(jc, _tokens(jc, 2, 12, 0), 1)
    exp, aux_j, ex_j = jmodel.forward(jp, jc, jb)
    out, aux_t, ex_t = tmodel.forward(tp, tc, tb)
    assert out.shape == (2, 12, jc.vocab_size) and ex_t == ex_j == {}
    _close(out, exp, MODEL_TOL)
    assert float(aux_t) == float(aux_j) == 0.0


def test_whisper_decode_matches_forward_exactly():
    """Torch twin of tests/test_models.py::test_decode_matches_forward_exactly
    for whisper: prefill 12 tokens, 3 decode steps reading the cross cache."""
    _, tc, _, tp = _params(WHISPER)
    B, S_prompt, n_dec = 2, 12, 3
    _, tb = _batches(tc, _tokens(tc, B, S_prompt + n_dec, 1), 2)
    full, _, _ = tmodel.forward(tp, tc, tb)
    cache = tmodel.init_cache(tc, B, S_prompt + n_dec + 4, torch.float32, "cpu")
    lg, cache, clen = tmodel.prefill(tp, tc, {**tb, "tokens": tb["tokens"][:, :S_prompt]}, cache)
    torch.testing.assert_close(lg[:, -1], full[:, S_prompt - 1], **MODEL_TOL)
    for t in range(n_dec):
        lg, cache = tmodel.decode_step(tp, tc, tb["tokens"][:, S_prompt + t][:, None], cache, clen)
        clen += 1
        torch.testing.assert_close(lg[:, 0], full[:, S_prompt + t], **MODEL_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_learned_positions_past_the_table_match_jax(per_row):
    """A table of 8 rows: a 6-token prefill then 5 decode steps run past it
    (positions 6..10), each clamped at row 7 as in JAX; per-row lengths
    (the continuous-batching form) or one scalar."""
    jc, tc, jp, tp = _params(WHISPER, max_target_positions=8)
    assert tp["embed"]["pos"].shape == (8, tc.d_model)
    B, S_prompt, max_len = 2, 6, 16
    toks = _tokens(jc, B, S_prompt + 5, 3)
    jb, tb = _batches(jc, toks[:, :S_prompt], 4)
    jcache = jmodel.init_cache(jc, B, max_len, cache_dtype=jnp.float32)
    tcache = tmodel.init_cache(tc, B, max_len, torch.float32, "cpu")
    lg_j, jcache, _ = jmodel.prefill(jp, jc, jb, jcache)
    lg_t, tcache, _ = tmodel.prefill(tp, tc, tb, tcache)
    _close(lg_t, lg_j, MODEL_TOL)
    for t in range(5):
        clen = S_prompt + t
        step = toks[:, S_prompt + t][:, None]
        jl = jnp.full((B,), clen, jnp.int32) if per_row else jnp.int32(clen)
        tl = torch.full((B,), clen, dtype=torch.int32) if per_row else clen
        lg_j, jcache = jmodel.decode_step(jp, jc, jnp.asarray(step), jcache, jl)
        lg_t, tcache = tmodel.decode_step(tp, tc, torch.from_numpy(step).long(), tcache, tl)
        _close(lg_t, lg_j, MODEL_TOL)


def test_whisper_negated_frames_change_the_logits():
    """Torch twin of tests/test_models.py::test_whisper_encoder_affects_decoder."""
    _, tc, _, tp = _params(WHISPER)
    _, tb = _batches(tc, _tokens(tc, 1, 8, 5), 6)
    l1, _, _ = tmodel.forward(tp, tc, tb)
    l2, _, _ = tmodel.forward(tp, tc, {**tb, "audio_frames": -tb["audio_frames"]})
    assert (l1 - l2).abs().max().item() > 1e-4


def test_whisper_engine_generate_matches_jax():
    """`Engine.generate(prompts, extras={"audio_frames": ...})`: greedy
    tokens identical to the JAX engine's on the same weights and frames
    (numpy extras on the port's side, moved to its device)."""
    jc, tc, jp, tp = _params(WHISPER)
    scfg = dict(max_batch=3, max_len=32, max_new_tokens=8)
    prompts = _tokens(jc, 3, 4, 7)
    frames = _rand(8, (3, jc.encoder_seq, jc.d_model), 0.1)
    exp = JEngine(jc, jp, JServeConfig(**scfg)).generate(
        jnp.asarray(prompts), {"audio_frames": jnp.asarray(frames)})
    got = Engine(tc, tp, ServeConfig(**scfg), device="cpu").generate(
        prompts, extras={"audio_frames": frames})
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(exp))


def test_continuous_engine_refuses_whisper_on_both_sides():
    jc, tc, jp, tp = _params(WHISPER)
    msg = "encdec serving needs encoder inputs per request"
    with pytest.raises(NotImplementedError, match=msg):
        JContinuousEngine(jc, jp, JServeConfig())
    with pytest.raises(NotImplementedError, match=msg):
        ContinuousEngine(tc, tp, ServeConfig(), device="cpu")


# ---------------------------------------------------------------------------
# internvl2: the VLM prefix
# ---------------------------------------------------------------------------

def test_vlm_forward_over_prefix_and_text_matches_jax():
    jc, tc, jp, tp = _params(VLM)
    jb, tb = _batches(jc, _tokens(jc, 2, 10, 9), 10)
    exp, _, _ = jmodel.forward(jp, jc, jb)
    out, _, _ = tmodel.forward(tp, tc, tb)
    assert out.shape == (2, jc.num_prefix_tokens + 10, jc.vocab_size)
    _close(out, exp, MODEL_TOL)


def test_vlm_prefill_counts_the_prefix_and_decode_matches_forward():
    """Prefill returns P + S (as JAX's), its logits match JAX's, and 3
    decode steps from that length match `forward` at the text positions."""
    jc, tc, jp, tp = _params(VLM)
    B, S_prompt, n_dec = 2, 12, 3
    P = tc.num_prefix_tokens
    toks = _tokens(tc, B, S_prompt + n_dec, 11)
    _, tb = _batches(tc, toks, 12)
    jb_pre, tb_pre = _batches(tc, toks[:, :S_prompt], 12)
    full, _, _ = tmodel.forward(tp, tc, tb)
    cache = tmodel.init_cache(tc, B, P + S_prompt + n_dec + 4, torch.float32, "cpu")
    lg, cache, clen = tmodel.prefill(tp, tc, tb_pre, cache)
    jcache = jmodel.init_cache(jc, B, P + S_prompt + n_dec + 4, cache_dtype=jnp.float32)
    lg_j, _, clen_j = jmodel.prefill(jp, jc, jb_pre, jcache)
    assert clen == int(clen_j) == P + S_prompt
    _close(lg, lg_j, MODEL_TOL)
    torch.testing.assert_close(lg[:, -1], full[:, P + S_prompt - 1], **MODEL_TOL)
    for t in range(n_dec):
        lg, cache = tmodel.decode_step(tp, tc, tb["tokens"][:, S_prompt + t][:, None], cache, clen)
        clen += 1
        torch.testing.assert_close(lg[:, 0], full[:, P + S_prompt + t], **MODEL_TOL)


def test_vlm_prefix_changes_the_text_logits():
    """Torch twin of tests/test_models.py::test_vlm_prefix_changes_text_logits."""
    _, tc, _, tp = _params(VLM)
    _, tb = _batches(tc, _tokens(tc, 1, 8, 13), 14)
    l1, _, _ = tmodel.forward(tp, tc, tb)
    l2, _, _ = tmodel.forward(tp, tc, {**tb, "prefix_embed": tb["prefix_embed"] + 1.0})
    assert (l1[:, -1] - l2[:, -1]).abs().max().item() > 1e-4


def test_vlm_engine_generate_with_prefix_matches_jax():
    jc, tc, jp, tp = _params(VLM)
    scfg = dict(max_batch=2, max_len=32, max_new_tokens=8)
    prompts = _tokens(jc, 2, 5, 15)
    prefix = _rand(16, (2, jc.num_prefix_tokens, jc.d_model), 0.1)
    exp = JEngine(jc, jp, JServeConfig(**scfg)).generate(
        jnp.asarray(prompts), {"prefix_embed": jnp.asarray(prefix)})
    got = Engine(tc, tp, ServeConfig(**scfg), device="cpu").generate(
        prompts, extras={"prefix_embed": torch.from_numpy(prefix)})
    np.testing.assert_array_equal(got, np.asarray(exp))


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_bridge_lands_every_jax_leaf_once(arch):
    """Every JAX leaf lands in the port's tree once per layer it stacks,
    with the layer's shape and values; no other leaf appears.  whisper's
    encoder and decoder stack layers on one axis, (L, ...); the vlm's
    decoder is a dense one, (L, 1, ...)."""
    jc, _, jp, tp = _params(arch)
    jnp_tree = jax.tree_util.tree_map(np.asarray, jp)
    landed = 0
    for path, leaf in _paths(jnp_tree):
        if path[0] in ("encoder", "decoder"):
            layers = tp[path[0]]
            per = leaf.reshape(len(layers), *leaf.shape[1 if arch == WHISPER else 2:])
            for i, lay in enumerate(layers):
                t = lay
                for k in path[1:]:
                    t = t[k]
                np.testing.assert_array_equal(t.numpy(), per[i])
                landed += 1
        else:
            t = tp
            for k in path:
                t = t[k]
            np.testing.assert_array_equal(t.numpy(), leaf)
            landed += 1
    assert landed == len(tree_flatten(tp)[0])
    if arch == WHISPER:
        assert len(tp["encoder"]) == jc.n_encoder_layers and len(tp["decoder"]) == jc.n_layers
        assert tp["embed"]["pos"].shape == (jc.max_target_positions, jc.d_model)
        assert tp["enc_pos"].shape == (jc.encoder_seq, jc.d_model)
