"""The port's MoE layer, MLA and the Dv != D attention rule against the JAX
package's (olmoe and deepseek-v3, reduced).

Weights come from `repro.models.init_params` at PRNGKey(0), converted by
`repro_torch.bridge`; inputs are made with numpy from a seed and fed to
both frameworks.  Tolerances: fp32 1e-5 for single layers (`LAYER_TOL`);
routing (the experts each token picks) and dispatch (which tokens each
expert keeps, in which capacity slot) must be identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.util import tree_flatten  # noqa: E402

torch.set_num_threads(1)

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
_CACHE = {}


def _params(arch):
    if arch not in _CACHE:
        jc, tc = JCONFIGS[arch].reduced(), TCONFIGS[arch].reduced()
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
        _CACHE[arch] = (jc, tc, jp, tp)
    return _CACHE[arch]


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_layer(arch, unit_experts):
    """The first MoE layer's parameters (JAX tree, port tree).  With
    ``unit_experts`` the expert weights are redrawn at unit scale (both
    sides the same numbers): `dense_init(E, D, F)` makes expert outputs
    about 1e-3, which would sit inside `LAYER_TOL`'s atol."""
    jc, tc, jp, tp = _params(arch)
    jl = jax.tree_util.tree_map(lambda a: np.asarray(a[0, 0]), jp["decoder"]["moe"])
    if unit_experts:
        jl["experts"] = {k: _rand(40 + i, v.shape) / np.float32(np.sqrt(v.shape[1]))
                         for i, (k, v) in enumerate(sorted(jl["experts"].items()))}
    tl = params_from_jax({"decoder": {"moe": jax.tree_util.tree_map(
        lambda a: a[None, None], jl)}}, tc)["decoder"][0]["moe"]
    return jax.tree_util.tree_map(jnp.asarray, jl), tl


def _capture_jax_combine(monkeypatch):
    """Record the dispatch tensor JAX's `moe_apply` builds: it passes
    through `shard(combine, DP, None, TP, None)`, the one call with that
    spec."""
    seen = []
    real = jmoe.shard

    def shard(x, *spec):
        if spec == (jmoe.DP, None, jmoe.TP, None):
            seen.append(np.asarray(x))
        return real(x, *spec)

    monkeypatch.setattr(jmoe, "shard", shard)
    return seen


# (B, S, capacity_factor): one group (N <= group_size 64), a padded tail
# (N = 100: two groups, the second padded by 28 tokens routed to expert 0),
# and capacity lowered to 8 per expert so that tokens drop
MOE_CASES = [(2, 24, None), (4, 25, None), (2, 64, 0.5)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,cf", MOE_CASES)
@pytest.mark.parametrize("unit_experts", [False, True])
def test_moe_apply_matches_jax(monkeypatch, arch, B, S, cf, unit_experts):
    jc, tc, _, _ = _params(arch)
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=cf))
    jl, tl = _moe_layer(arch, unit_experts)
    x = _rand(1 + S, (B, S, jc.d_model))
    seen = _capture_jax_combine(monkeypatch)
    out_j, aux_j = jmoe.moe_apply(jl, jnp.asarray(x), jc)
    out_t, aux_t = tmoe.moe_apply(tl, torch.from_numpy(x), tc)
    _close(out_t, out_j, LAYER_TOL)
    _close(aux_t, aux_j, LAYER_TOL)
    # routing and dispatch identical
    N = B * S
    gates_j, idx_j, _ = jmoe._route(jl, jnp.asarray(x).reshape(N, -1), jc)
    gates_t, idx_t, _ = tmoe._route(tl, torch.from_numpy(x).reshape(N, -1), tc)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(gates_t, gates_j, LAYER_TOL)
    combine_t, g = tmoe.dispatch_plan(gates_t, idx_t, tc, N)
    (combine_j,) = seen
    assert combine_t.shape == combine_j.shape
    np.testing.assert_array_equal(combine_t.numpy() > 0, combine_j > 0)
    _close(combine_t, combine_j, LAYER_TOL)
    if cf is not None:  # the lowered capacity drops some of the N * k choices
        assert int((combine_j > 0).sum()) < N * jc.moe.top_k


def test_moe_padded_tail_takes_expert_zero_capacity():
    """The padded tail of the last group is routed to expert 0 with gate 0:
    never dispatched, but counted against expert 0's capacity, as in the
    JAX package (`moe.py:110-143`)."""
    tc = TCONFIGS["olmoe-1b-7b"].reduced()  # E=8, k=2, groups of 64
    cap = tmoe.capacity(tc, 64)
    n = 70  # a second group of 6 tokens and 58 pad tokens
    idx = torch.tensor([[1, 2]] * 64 + [[3, 0]] * 6)
    combine, g = tmoe.dispatch_plan(torch.full((n, 2), 0.5), idx, tc, n)
    assert g == 64 and combine.shape == (2, 64, 8, cap) and cap < 58
    # group 1: 64 first choices of expert 1, the first cap of them kept
    kept = (combine[0, :, 1] > 0).any(-1)
    assert kept[:cap].all() and not kept[cap:].any()
    # group 2: the pad tokens filled expert 0 in slot 0 (gate 0, never
    # dispatched), so the real tokens' second choice, expert 0, is dropped
    assert int((combine[1, :6, 3] > 0).sum()) == 6
    assert not (combine[1, :, 0] > 0).any()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_layer(layer):
    jc, tc, jp, tp = _params("deepseek-v3-671b")
    if layer == "dense":
        return jc, tc, jax.tree_util.tree_map(lambda a: a[0, 0], jp["dense_prefix"]["attn"]), \
            tp["dense_prefix"][0]["attn"]
    return jc, tc, jax.tree_util.tree_map(lambda a: a[1, 0], jp["decoder"]["attn"]), \
        tp["decoder"][1]["attn"]


@pytest.mark.parametrize("S", [40, 300])  # Sq * Sk below and above 256^2
@pytest.mark.parametrize("with_cache", [False, True])
def test_mla_prefill_matches_jax(S, with_cache):
    jc, tc, jpa, tpa = _mla_layer("moe")
    B, max_len = 2, 320
    x = _rand(50 + S, (B, S, jc.d_model))
    kw_j, kw_t = {}, {}
    if with_cache:
        jcache = jmla.init_mla_cache(jc, B, max_len, jnp.float32)
        kw_j = dict(cache=jcache, cache_len=jnp.int32(0))
        kw_t = dict(cache=tmla.init_mla_cache(tc, B, max_len, torch.float32), cache_len=0)
    out_j, cache_j = jmla.mla_apply(jpa, jnp.asarray(x), jc, **kw_j)
    out_t, cache_t = tmla.mla_apply(tpa, torch.from_numpy(x), tc, **kw_t)
    _close(out_t, out_j, LAYER_TOL)
    if with_cache:
        for k in ("c_kv", "k_pe"):
            _close(cache_t[k], cache_j[k], LAYER_TOL)


@pytest.mark.parametrize("layer", ["dense", "moe"])
def test_mla_absorbed_decode_matches_jax(layer):
    """Per-slot cache_len (a dead slot, two live ones) against a live
    latent cache; the mask takes every position <= cache_len, the row just
    written included."""
    jc, tc, jpa, tpa = _mla_layer(layer)
    B, max_len = 3, 16
    m = jc.mla
    x = _rand(60, (B, 1, jc.d_model))
    ckv, kpe = _rand(61, (B, max_len, m.kv_lora_rank)), _rand(62, (B, max_len, m.rope_head_dim))
    clen = np.asarray([0, 5, 11], np.int32)
    out_j, cache_j = jmla.mla_apply(
        jpa, jnp.asarray(x), jc, positions=jnp.asarray(clen)[:, None],
        cache={"c_kv": jnp.asarray(ckv), "k_pe": jnp.asarray(kpe)}, cache_len=jnp.asarray(clen))
    out_t, cache_t = tmla.mla_apply(
        tpa, torch.from_numpy(x), tc, positions=torch.from_numpy(clen)[:, None],
        cache={"c_kv": torch.from_numpy(ckv.copy()), "k_pe": torch.from_numpy(kpe.copy())},
        cache_len=torch.from_numpy(clen))
    _close(out_t, out_j, LAYER_TOL)
    for k in ("c_kv", "k_pe"):
        _close(cache_t[k], cache_j[k], LAYER_TOL)


# ---------------------------------------------------------------------------
# attention with Dv != D: the reference up to 256^2, the chunked scan above
# ---------------------------------------------------------------------------

# B, Sq, Sk, H, K, D, Dv, causal, window, cap, q_offset, block_k
CHUNK_CASES = [
    (2, 40, 40, 4, 4, 48, 32, True, None, None, 0, 16),      # MLA-like, ragged blocks
    (1, 33, 100, 8, 2, 64, 32, True, 20, 30.0, 67, 32),      # GQA, offset, window, cap
    (2, 64, 64, 4, 1, 32, 48, False, None, None, 0, 4096),   # one block, non-causal
]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_attention_chunked_matches_reference_and_jax(case):
    B, Sq, Sk, H, K, D, Dv, causal, window, cap, off, bk = case
    q, k, v = _rand(70, (B, Sq, H, D)), _rand(71, (B, Sk, K, D)), _rand(72, (B, Sk, K, Dv))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off, scale=D ** -0.5)
    T = torch.from_numpy
    out = ops.attention_chunked(T(q), T(k), T(v), block_k=bk, **kw)
    assert out.shape == (B, Sq, H, Dv)
    _close(out, ref.mha_reference(T(q), T(k), T(v), **kw), LAYER_TOL)
    exp = jops._attention_chunked_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      block_k=bk, **kw)
    _close(out, exp, LAYER_TOL)


@pytest.mark.parametrize("Sq", [200, 300])  # 200^2 <= 256^2 < 300^2
def test_ops_routes_dv_ne_d_by_shape_like_jax(monkeypatch, Sq):
    """Dv != D never reaches the kernel's wrapper: the reference up to
    Sq * Sk <= 256^2, the chunked scan above, as JAX's `ops.flash_attention`
    picks on the CPU (its result matches either way)."""
    calls = []
    monkeypatch.setattr(ops, "flash_attention_kernel", lambda *a, **k: calls.append(a))
    q, k, v = _rand(73, (1, Sq, 4, 48)), _rand(74, (1, Sq, 4, 48)), _rand(75, (1, Sq, 4, 32))
    T = torch.from_numpy
    launches = fmod.flash_attention.launches
    out = ops.flash_attention(T(q), T(k), T(v), causal=True)
    assert not calls and fmod.flash_attention.launches == launches
    kw = dict(causal=True, window=None, logit_cap=None, q_offset=0, scale=48 ** -0.5)
    route = ref.mha_reference(T(q), T(k), T(v), **kw) if Sq * Sq <= 256 * 256 \
        else ops.attention_chunked(T(q), T(k), T(v), **kw)
    torch.testing.assert_close(out, route, rtol=0, atol=0)
    _close(out, jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), LAYER_TOL)
    _close(out, jref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True),
           LAYER_TOL)


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_converts_the_moe_and_mtp_trees(arch):
    jc, tc, jp, tp = _params(arch)
    nd = jc.moe.num_dense_layers
    assert len(tp["decoder"]) == jc.n_layers - nd
    assert ("dense_prefix" in tp) == bool(nd) and len(tp.get("dense_prefix", [])) == nd
    assert ("mtp" in tp) == bool(jc.mtp_depth)
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = tree_flatten(tp)[0]
    assert sum(a.size for a in jleaves) == sum(t.numel() for t in tleaves)
    for o, layer in enumerate(tp["decoder"]):
        for k in ("router", "router_bias"):
            np.testing.assert_array_equal(layer["moe"][k].numpy(), np.asarray(jp["decoder"]["moe"][k][o, 0]))
        np.testing.assert_array_equal(layer["moe"]["experts"]["w_down"].numpy(),
                                      np.asarray(jp["decoder"]["moe"]["experts"]["w_down"][o, 0]))
        if jc.moe.num_shared:
            np.testing.assert_array_equal(layer["moe"]["shared"]["w_up"].numpy(),
                                          np.asarray(jp["decoder"]["moe"]["shared"]["w_up"][o, 0]))
    if jc.mtp_depth:
        np.testing.assert_array_equal(tp["mtp"]["proj"].numpy(), np.asarray(jp["mtp"]["proj"]))
        np.testing.assert_array_equal(tp["mtp"]["block"]["attn"]["kv_up"].numpy(),
                                      np.asarray(jp["mtp"]["block"]["attn"]["kv_up"]))
