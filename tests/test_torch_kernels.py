"""The port's kernels (attention, Mamba2 SSD, mLSTM) against the JAX
package's.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against `repro.kernels.ref` (and the Pallas kernels in interpret mode)
on the same numpy inputs, at `tests/test_kernels.py`'s bars: attention fp32
2e-5; SSD atol 5e-4 + rtol 1e-3 (the same scan in another summation
order), decode steps 1e-4 + 1e-3.  The plain mLSTM is held at 2e-5 (atol,
rtol 1e-4) to the JAX reference, the interpret-mode Pallas kernel and the
blockwise scan JAX runs at S = 300; the closed-form prefill state at 1e-4
relative (c, n) and 1e-5 (m) to the step-by-step replay.
The CUDA kernels themselves are compared with the plain versions by
`tests/test_torch_cuda.py` (marked `cuda`, skipped without a GPU) and by
`chip_smoke.py`.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mamba2_ssd import ssd_pallas  # noqa: E402
from repro.kernels.mlstm_kernel import mlstm_pallas  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import mamba2_ssd as smod  # noqa: E402
from repro_torch.kernels import mlstm as mmod  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=1e-4)

# the flash and decode cases of tests/test_kernels.py
FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, window, cap, q_offset
    (2, 128, 128, 4, 4, 64, True, None, None, 0),
    (1, 256, 256, 8, 2, 64, True, None, None, 0),      # GQA 4:1
    (1, 128, 128, 4, 1, 128, True, None, None, 0),     # MQA
    (2, 128, 128, 4, 2, 32, True, 64, None, 0),        # sliding window
    (1, 128, 128, 2, 2, 64, True, None, 50.0, 0),      # softcap (gemma2)
    (1, 128, 256, 4, 4, 64, True, None, None, 128),    # continuation offset
    (1, 128, 128, 2, 1, 64, False, None, None, 0),     # encoder (full)
    (2, 77, 77, 4, 2, 32, True, None, None, 0),        # ragged Sq (prefill bucket)
]
DECODE_CASES = [
    # S, H, K, D, window, cap
    (256, 8, 2, 64, None, None),
    (512, 4, 4, 32, None, None),
    (256, 8, 1, 128, 64, None),
    (256, 4, 2, 64, None, 30.0),
    (97, 4, 2, 32, None, None),   # prime cache length
    (300, 8, 8, 64, None, None),
]


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _flash_inputs(case):
    B, Sq, Sk, H, K, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    return _np(rng, (B, Sq, H, D)), _np(rng, (B, Sk, K, D)), _np(rng, (B, Sk, K, D))


def _decode_inputs(S, H, K, D, B=3):
    rng = np.random.default_rng(S + H + D)
    q, kc, vc = _np(rng, (B, H, D)), _np(rng, (B, S, K, D)), _np(rng, (B, S, K, D))
    clen = np.asarray([S, S // 2, 17][:B], np.int32)
    return q, kc, vc, clen


T = torch.from_numpy


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax_ref(case):
    _, _, _, _, _, _, causal, window, cap, off = case
    q, k, v = _flash_inputs(case)
    out = fmod.flash_attention(
        T(q), T(k), T(v), causal=causal, window=window, logit_cap=cap, q_offset=off
    )
    exp = jref.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, window=window, logit_cap=cap, q_offset=off,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("S,H,K,D,window,cap", DECODE_CASES)
def test_decode_plain_matches_jax_ref(S, H, K, D, window, cap):
    q, kc, vc, clen = _decode_inputs(S, H, K, D)
    out = dmod.decode_attention(T(q), T(kc), T(vc), T(clen), window=window, logit_cap=cap)
    exp = jref.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        window=window, logit_cap=cap,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("case", [
    (1, 128, 128, 2, 1, 32, True, None, None, 0),
    (1, 128, 128, 4, 2, 32, True, 32, 30.0, 0),
])
def test_flash_plain_matches_pallas_interpret(case):
    _, _, _, _, _, _, causal, window, cap, off = case
    q, k, v = _flash_inputs(case)
    out = fmod.flash_attention(
        T(q), T(k), T(v), causal=causal, window=window, logit_cap=cap, q_offset=off
    )
    exp = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        logit_cap=cap, q_offset=off, block_q=64, block_k=64, interpret=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("S,H,K,D,window,cap", [
    (97, 4, 2, 32, None, None),
    (128, 8, 2, 32, 40, 20.0),
])
def test_decode_plain_matches_pallas_interpret(S, H, K, D, window, cap):
    q, kc, vc, clen = _decode_inputs(S, H, K, D)
    out = dmod.decode_attention(T(q), T(kc), T(vc), T(clen), window=window, logit_cap=cap)
    exp = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        window=window, logit_cap=cap, block_k=32, interpret=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_decode_per_slot_lengths_are_independent():
    """Each row attends over exactly its own cache_len: a row's output
    equals a single-row call at that length, whatever the other rows hold."""
    q, kc, vc, clen = _decode_inputs(128, 8, 2, 32)
    out = dmod.decode_attention(T(q), T(kc), T(vc), T(clen))
    for b, n in enumerate(clen):
        one = dmod.decode_attention(
            T(q[b:b + 1]), T(kc[b:b + 1, :n]), T(vc[b:b + 1, :n]),
            torch.tensor([n], dtype=torch.int32),
        )
        np.testing.assert_allclose(out[b:b + 1].numpy(), one.numpy(), **TOL)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    fmod.flash_attention.launches = 0
    dmod.decode_attention.launches = 0
    q, k, v = _flash_inputs(FLASH_CASES[-1])
    a = ops.flash_attention(T(q), T(k), T(v))
    b = ref.mha_reference(T(q), T(k), T(v))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    q, kc, vc, clen = _decode_inputs(97, 4, 2, 32)
    a = ops.decode_attention(T(q), T(kc), T(vc), T(clen))
    b = ref.decode_attention_reference(T(q), T(kc), T(vc), T(clen))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fmod.flash_attention.launches == 0
    assert dmod.decode_attention.launches == 0


@pytest.mark.parametrize("B,K", [
    (4, 8),      # llama3-8b's serving shape: 8 splits
    (4, 32),     # zamba2-1.2b's shared block (MHA): 2
    (8, 8),      # phase 2's B=8 cases: 4
    (1, 1), (3, 2), (33, 1), (128, 8), (300, 2),
])
def test_decode_cluster_split_covers_the_live_rows(B, K):
    """The host's pick of splits is a portable cluster size (the grid's x
    dimension is one cluster) that fills about two CTAs per SM; the
    kernel's cut of a row's live range (mirrored by `row_parts`) gives
    each CTA whole tiles, disjoint, covering [lo, L) exactly once, for
    every L in 0..S, with and without a window (one starting mid-tile)."""
    splits = dmod.cluster_splits(B, K)
    assert splits in dmod.CLUSTER_SIZES
    target = 2 * 132
    assert B * K * splits <= max(target, B * K)
    assert splits == max(dmod.CLUSTER_SIZES) or B * K * splits * 2 > target
    S = 77
    for window in (None, 5, 40):
        for L in range(S + 1):
            lo = max(0, L - window) if window else 0
            parts = dmod.row_parts(L, S, window, splits)
            assert len(parts) == splits
            rows = [r for a, b in parts for r in range(a, b)]
            assert rows == list(range(lo, L))
            sizes = [b - a for a, b in parts]
            assert all((a - lo) % dmod.GRAIN == 0 for a, b in parts if b > a)
            live = [n for n in sizes if n]
            assert all(n % dmod.GRAIN == 0 for n in live[:-1])
            assert len(set(live[:-1])) <= 1 and (not live or live[-1] <= live[0])


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

SSD_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_kernels.py:167
STEP_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_kernels.py:199
# the ssd_pallas cases of tests/test_kernels.py:151-155
SSD_CASES = [
    # S, H, P, G, N, chunk
    (128, 4, 16, 2, 8, 32),
    (256, 2, 32, 1, 16, 64),
    (192, 8, 8, 4, 4, 64),
]


def _ssd_inputs(B, S, H, P, G, N, seed):
    """x, dt (softplus'd), A (negative), B, C, D as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = _np(rng, (B, S, H, P))
    dt = np.log1p(np.exp(_np(rng, (B, S, H))))
    A = -np.exp(_np(rng, (H,)))
    Bm, Cm, D = _np(rng, (B, S, G, N)), _np(rng, (B, S, G, N)), _np(rng, (H,))
    return x, dt, A, Bm, Cm, D


def _j(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [None if a is None else T(a) for a in arrs]


@pytest.mark.parametrize("oracle", ["sequential", "pallas_interpret"])
@pytest.mark.parametrize("S,H,P,G,N,chunk", SSD_CASES)
def test_ssd_plain_matches_jax(S, H, P, G, N, chunk, oracle):
    inp = _ssd_inputs(2, S, H, P, G, N, S)
    out = smod.ssd(*_t(inp), chunk=chunk)
    if oracle == "sequential":
        exp = jref.ssd_reference(*_j(inp))
    else:
        exp = ssd_pallas(*_j(inp), chunk=chunk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **SSD_TOL)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [60, 100, 128])
def test_ssd_pad_path_matches_sequential(B, S):
    """The twin of tests/test_kernels.py::test_ssd_jnp_chunked_pad_path (which
    skips without hypothesis): S not a chunk multiple pads with dt = 0."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, S, 2, 8, 1, 4, B * S)
    out = ops.ssd_scan(*_t([x, dt, A, Bm, Cm]), None, chunk=32)
    exp = jref.ssd_reference(*_j([x, dt, A, Bm, Cm]), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **SSD_TOL)


@pytest.mark.parametrize("S,chunk,with_d", [(100, 32, True), (64, 32, False), (24, 128, True)])
def test_ssd_return_state_matches_jax_ops(S, chunk, with_d):
    """y and the fp32 final state against ops.ssd_scan(return_state=True),
    the call Mamba2 prefill makes (chunk larger than S shrinks to S)."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, S, 4, 8, 2, 4, S + chunk)
    D = D if with_d else None
    y, h = ops.ssd_scan(*_t([x, dt, A, Bm, Cm, D]), chunk=chunk, return_state=True)
    ey, eh = jops.ssd_scan(*_j([x, dt, A, Bm, Cm, D]), chunk=chunk, return_state=True)
    assert h.dtype == torch.float32 and h.shape == (2, 4, 8, 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **SSD_TOL)


def test_ssd_references_match_jax():
    """The port's own oracles (sequential with init_state, chunked) against
    the JAX package's."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, 64, 4, 8, 2, 4, 3)
    h0 = _np(np.random.default_rng(4), (2, 4, 8, 4))
    for fn_t, fn_j, kw in ((ref.ssd_reference, jref.ssd_reference, {}),
                           (ref.ssd_chunked_reference, jref.ssd_chunked_reference, {"chunk": 16})):
        y, h = fn_t(*_t([x, dt, A, Bm, Cm, D]), init_state=T(h0), return_state=True, **kw)
        ey, eh = fn_j(*_j([x, dt, A, Bm, Cm, D]), init_state=jnp.asarray(h0),
                      return_state=True, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(ey), **SSD_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(eh), **SSD_TOL)


def test_ssd_decode_step_matches_jax():
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, 1, 4, 8, 2, 4, 5)
    h0 = _np(np.random.default_rng(6), (2, 4, 8, 4))
    h, y = ops.ssd_decode_step(T(h0), *_t([x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D]))
    eh, ey = jops.ssd_decode_step(jnp.asarray(h0), *_j([x[:, 0], dt[:, 0], A, Bm[:, 0],
                                                        Cm[:, 0], D]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), **STEP_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **STEP_TOL)


def test_ssd_prefill_state_continues_decode():
    """The twin of tests/test_kernels.py::test_ssd_prefill_state_continues_decode:
    the state returned by the scan continues one decode step at a time."""
    S = 64
    x, dt, A, Bm, Cm, _ = _t(_ssd_inputs(1, S + 8, 2, 8, 1, 4, 9))
    full = ref.ssd_reference(x, dt, A, Bm, Cm)
    _, state = ops.ssd_scan(x[:, :S], dt[:, :S], A, Bm[:, :S], Cm[:, :S], chunk=32,
                            return_state=True)
    outs = []
    for t in range(S, S + 8):
        state, y = ops.ssd_decode_step(state, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        outs.append(y)
    torch.testing.assert_close(torch.stack(outs, 1), full[:, S:], **STEP_TOL)


def test_ssd_dispatch_cpu_tensors_to_plain_version():
    smod.ssd.launches = 0
    inp = _t(_ssd_inputs(1, 40, 4, 8, 2, 4, 11))
    y, h = ops.ssd_scan(*inp, chunk=16, return_state=True)
    ey, eh = smod.ssd_plain(*inp, chunk=16, return_state=True)
    torch.testing.assert_close(y, ey, rtol=0, atol=0)
    torch.testing.assert_close(h, eh, rtol=0, atol=0)
    assert smod.ssd.launches == 0


def _operand(v, bf16_single):
    """An fp32 MMA operand as the bf16 route takes it: exact (None), one
    bf16 rounding (True), or bf16 hi + lo halves (False)."""
    if bf16_single is None:
        return v
    hi = v.to(torch.bfloat16).float()
    return hi if bf16_single else hi + (v - hi).to(torch.bfloat16).float()


def _ssd_state_passing(x, dt, A, Bm, Cm, D, chunk, single=None):
    """The bf16 SSD kernels' three phases in plain torch: each chunk's state
    contribution dS_c = x^T (w o B), the state passed across chunks
    (h_c = exp(a_tot_c) h_{c-1} + dS_c), then y per chunk from the scores,
    the entering state and the D skip.  ``single`` None: fp32 operands;
    else the set of products ("scores", "wB", "h") whose fp32 operand is
    rounded to bf16 once, the others split into hi + lo."""
    Bz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    rnd = {k: None if single is None else k in single for k in ("scores", "wB", "h")}
    chunk = min(chunk, S)
    pad = (-S) % chunk
    xf, dtf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)), F.pad(dt.float(), (0, 0, 0, pad))
    Bh, Ch = (F.pad(m.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, 2) for m in (Bm, Cm))
    nc = (S + pad) // chunk
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    parts = []
    for c in range(nc):  # phase 1 (and the chunk's own scores, used in phase 3)
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, bc, cc = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        a_cum = torch.cumsum(A.float() * dtc, dim=1)
        a_tot = a_cum[:, -1]
        w = torch.exp(a_tot[:, None] - a_cum) * dtc
        d_state = torch.einsum("bshp,bshn->bhpn", xc, _operand(w[..., None] * bc, rnd["wB"]))
        parts.append((xc, dtc, cc, bc, a_cum, a_tot, d_state))
    h = torch.zeros(Bz, H, P, N)
    ys = []
    for xc, dtc, cc, bc, a_cum, a_tot, d_state in parts:  # phases 2 and 3
        seg = a_cum[:, :, None, :] - a_cum[:, None, :, :]
        L = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        scores = torch.einsum("bthn,bshn->btsh", cc, bc) * L * dtc[:, None]
        y = torch.einsum("btsh,bshp->bthp", _operand(scores, rnd["scores"]), xc)
        y = y + torch.exp(a_cum)[..., None] * torch.einsum("bthn,bhpn->bthp", cc,
                                                           _operand(h, rnd["h"]))
        ys.append(y)
        h = h * torch.exp(a_tot)[..., None, None] + d_state
    y = torch.cat(ys, 1)[:, :S]
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return y, h


@pytest.mark.parametrize("P,N", [(p, n) for p, n in smod.WIDTHS if p % 16 or n % 16])
def test_ssd_padding_to_the_mma_tile_changes_nothing(P, N):
    """The kernels pad P and N up to a multiple of 16 in shared memory, with
    zeros: the chunk-parallel decomposition over zero-padded x, B and C,
    cut back to (P, N), is the plain scan at the unpadded widths."""
    x, dt, A, Bm, Cm, D = _t(_ssd_inputs(1, 150, 4, P, 2, N, P + N))
    pp, nn = smod._tile(P), smod._tile(N)
    xp = F.pad(x, (0, pp - P))
    Bp, Cp = (F.pad(m, (0, nn - N)) for m in (Bm, Cm))
    y, h = _ssd_state_passing(xp, dt, A, Bp, Cp, D, 64)
    ey, eh = smod.ssd_plain(x, dt, A, Bm, Cm, D, chunk=64, return_state=True)
    torch.testing.assert_close(y[..., :P], ey, **SSD_TOL)
    torch.testing.assert_close(h[..., :P, :N], eh, **SSD_TOL)
    for pad in (y[..., P:], h[..., P:, :], h[..., N:]):  # the padding stays zero
        assert int(torch.count_nonzero(pad)) == 0


def test_ssd_wrapper_takes_every_width_of_the_set_and_no_other():
    for P, N in smod.WIDTHS + ((32, 64), (64, 32), (128, 64), (12, 8)):
        x, dt, A, Bm, Cm, D = _t(_ssd_inputs(1, 8, 2, P, 1, N, 0))
        if (P, N) in smod.WIDTHS:
            smod._check(x, dt, A, Bm, Cm, D, 128)
        else:
            with pytest.raises(ValueError, match="not supported"):
                smod._check(x, dt, A, Bm, Cm, D, 128)
    assert [smod._tile(w) for w in (4, 8, 16, 32, 64, 128)] == [16, 16, 16, 32, 64, 128]


@pytest.mark.parametrize("S", [16, 128, 129, 300])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_state_passing_matches_plain(S, G, chunk):
    """The chunk-parallel decomposition the bf16 kernels run (per-chunk
    dS, state passing, the inter-chunk term) is the chunked scan: y and the
    final state equal `ssd_plain`'s at the SSD bar."""
    x, dt, A, Bm, Cm, D = _t(_ssd_inputs(1, S, 4, 16, G, 16, S + G + chunk))
    y, h = _ssd_state_passing(x, dt, A, Bm, Cm, D, chunk)
    ey, eh = smod.ssd_plain(x, dt, A, Bm, Cm, D, chunk=chunk, return_state=True)
    torch.testing.assert_close(y, ey, **SSD_TOL)
    torch.testing.assert_close(h, eh, **SSD_TOL)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(B, S, H, D, seed, model_gates=False):
    """q, k, v, i, f as numpy fp32: the JAX test's gates (i ~ N(0,1),
    f ~ N(2,1)), or with ``model_gates`` the ranges of the model's gate
    biases (i near -10, f biases 3-6)."""
    rng = np.random.default_rng(seed)
    q, k, v = _np(rng, (B, S, H, D)), _np(rng, (B, S, H, D)), _np(rng, (B, S, H, D))
    ig, fg = _np(rng, (B, S, H)), _np(rng, (B, S, H)) + 2.0
    if model_gates:
        ig = ig * 0.1 - 10.0
        fg = fg * 0.1 + np.linspace(3.0, 6.0, H, dtype=np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("oracle", ["reference", "jax_ops"])
@pytest.mark.parametrize("S,H,D,model_gates", [
    (48, 2, 16, False), (300, 2, 32, False), (300, 4, 64, True), (520, 1, 16, False),
])
def test_mlstm_plain_matches_jax(S, H, D, model_gates, oracle):
    """S <= 256 runs the reference; S = 300 and 520 the blockwise scan
    (block_k 4 and 8 by the JAX rule), as `ops.mlstm_parallel` does."""
    inp = _mlstm_inputs(2, S, H, D, S + D, model_gates)
    out = mmod.mlstm(*_t(inp))
    fn = jref.mlstm_reference if oracle == "reference" else jops.mlstm_parallel
    np.testing.assert_allclose(out.numpy(), np.asarray(fn(*_j(inp))), **TOL)


@pytest.mark.parametrize("S,H,D,bq,bk", [
    (128, 2, 32, 64, 64),   # the cases of tests/test_kernels.py
    (256, 4, 16, 128, 64),
    (128, 2, 64, 128, 32),
])
def test_mlstm_plain_matches_pallas_interpret(S, H, D, bq, bk):
    inp = _mlstm_inputs(2, S, H, D, S + D)
    out = mmod.mlstm(*_t(inp))
    exp = mlstm_pallas(*_j(inp), block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_mlstm_chunked_matches_reference():
    """The twin of tests/test_kernels.py::test_mlstm_chunked_jnp_matches_ref."""
    inp = _t(_mlstm_inputs(1, 512, 2, 16, 11))
    out = mmod.mlstm_plain(*inp, block_k=128)
    torch.testing.assert_close(out, ref.mlstm_reference(*inp), **TOL)


def _state(rng, B, H, D):
    c, n = _np(rng, (B, H, D, D)), _np(rng, (B, H, D))
    m = rng.uniform(-3.0, 1.0, size=(B, H)).astype(np.float32)
    return c, n, m


def test_mlstm_recurrent_step_matches_jax():
    """The in-place decode step and the port's oracle step against the JAX
    package's, from a live state."""
    q, k, v, ig, fg = _mlstm_inputs(3, 1, 2, 16, 21)
    c, n, m = _state(np.random.default_rng(22), 3, 2, 16)
    step = [a[:, 0] for a in (q, k, v, ig, fg)]
    (ec, en, em), eh = jops.mlstm_decode_step(*_j([c, n, m] + step))
    (rc, rn, rm), rh = ref.mlstm_recurrent_step(*_t([c, n, m] + step))
    tc, tn, tm = (torch.tensor(a) for a in (c, n, m))  # owned copies: updated in place
    h = ops.mlstm_decode_step(tc, tn, tm, *_t(step))
    for got in ((tc, tn, tm, h), (rc, rn, rm, rh)):
        for a, e in zip(got, (ec, en, em, eh)):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), **STEP_TOL)


@pytest.mark.parametrize("model_gates", [False, True])
def test_mlstm_closed_form_prefill_state_matches_replay(model_gates):
    """`models.xlstm.mlstm_prefill_state` from a live state against the
    port's step-by-step replay and the JAX package's steps."""
    B, S, H, D = 2, 77, 2, 16
    q, k, v, ig, fg = _mlstm_inputs(B, S, H, D, 23, model_gates)
    c, n, m = _state(np.random.default_rng(24), B, H, D)
    st = {key: torch.tensor(a) for key, a in zip("cnm", (c, n, m))}  # updated in place
    txl.mlstm_prefill_state(st, T(k), T(v), T(ig), mmod.gate_cumsum(T(fg)))
    rep = ref.mlstm_prefill_replay(*_t([c, n, m, q, k, v, ig, fg]))
    jc, jn, jm = (jnp.asarray(a) for a in (c, n, m))
    for t in range(S):
        (jc, jn, jm), _ = jops.mlstm_decode_step(jc, jn, jm, *(jnp.asarray(a[:, t])
                                                               for a in (q, k, v, ig, fg)))
    for key, r, j in zip("cnm", rep, (jc, jn, jm)):
        tol = dict(atol=0, rtol=1e-5) if key == "m" else dict(atol=0, rtol=1e-4)
        scale = r.abs().max().item()  # relative to the state's largest entry
        assert (st[key] - r).abs().max().item() <= tol["rtol"] * scale, key
        assert np.abs(st[key].numpy() - np.asarray(j)).max() <= tol["rtol"] * scale, key


def test_mlstm_prefill_state_continues_decode():
    """The twin of tests/test_kernels.py::test_mlstm_recurrent_matches_parallel
    across the prefill/decode seam: the closed-form state after 40 tokens,
    continued by 8 in-place decode steps, gives the parallel form's
    outputs at those positions."""
    S, n_dec = 40, 8
    q, k, v, ig, fg = _t(_mlstm_inputs(2, S + n_dec, 2, 8, 13))
    full = ref.mlstm_reference(q, k, v, ig, fg)
    st = {"c": torch.zeros(2, 2, 8, 8), "n": torch.zeros(2, 2, 8), "m": torch.full((2, 2), -1e9)}
    txl.mlstm_prefill_state(st, k[:, :S], v[:, :S], ig[:, :S], mmod.gate_cumsum(fg[:, :S]))
    outs = [ops.mlstm_decode_step(st["c"], st["n"], st["m"], q[:, t], k[:, t], v[:, t],
                                  ig[:, t], fg[:, t]) for t in range(S, S + n_dec)]
    torch.testing.assert_close(torch.stack(outs, 1), full[:, S:], **STEP_TOL)


def test_mlstm_dispatch_cpu_tensors_to_plain_version():
    mmod.mlstm.launches = 0
    for S in (17, 300):
        inp = _t(_mlstm_inputs(1, S, 2, 16, S))
        torch.testing.assert_close(ops.mlstm_parallel(*inp), mmod.mlstm_plain(*inp),
                                   rtol=0, atol=0)
    assert mmod.mlstm.launches == 0


# ---------------------------------------------------------------------------
# the bf16 tensor-core routes: mLSTM scratch chunks and the hi + lo split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,S,cap", [
    (4, 300, mmod.SCRATCH_CAP_BYTES),     # xlstm-1.3b serving prefill: one chunk
    (8, 2048, mmod.SCRATCH_CAP_BYTES),    # 2 x 4 heads x 2048: 134 MB, one chunk
    (8, 2048, 32 << 20),
    (6, 300, 499_200),                    # the last block's own scratch
    (6, 77, 199_680),
    (3, 1, 1 << 20),
    (64, 5000, 128 << 20),
])
def test_mlstm_chunk_plan_covers_rows_within_the_cap(bh, S, cap):
    chunks = mmod.plan_chunks(bh, S, cap)
    assert chunks[0][0] == 0 and chunks[-1][1] == S
    assert all(a < b for a, b in chunks)
    assert all(b == a2 for (_, b), (a2, _) in zip(chunks, chunks[1:]))  # in order, no gap
    assert all(a % mmod.BLOCK == 0 for a, _ in chunks)
    assert all(b % mmod.BLOCK == 0 for _, b in chunks[:-1])
    assert all(mmod.chunk_scratch_bytes(bh, a, b) <= cap for a, b in chunks)
    fits = mmod.chunk_scratch_bytes(bh, 0, S) <= cap
    assert (len(chunks) == 1) == fits
    # each chunk is as long as the cap allows: one more block would not fit
    for a, b in chunks[:-1]:
        assert mmod.chunk_scratch_bytes(bh, a, min(S, b + mmod.BLOCK)) > cap


def test_mlstm_chunk_plan_raises_below_one_block():
    with pytest.raises(ValueError):
        mmod.plan_chunks(8, 2048, mmod.chunk_scratch_bytes(8, 1984, 2048) - 1)


BF16_ULP = 2.0 ** -7


def _bf16_rule_ratio(out, exp):
    """Worst |out - exp| over its limit under chip_smoke.py's `compare` rule
    for bf16 outputs: one bf16 step at the row's largest value (+1e-5),
    capped by 2e-2 + 2e-2 |exp|."""
    out, exp = out.float(), exp.float()
    mag = exp.abs()
    lim = (BF16_ULP * mag.amax(-1, keepdim=True) + 1e-5).minimum(2e-2 + 2e-2 * mag)
    return ((out - exp).abs() / lim).max().item()


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _second_product(p, v, split):
    """p @ v with p rounded to bf16 as the tensor cores take it: once, or as
    hi + lo halves in two products (the kernels' design)."""
    hi = _bf16(p)
    return hi @ v + _bf16(p - hi) @ v if split else hi @ v


def _mlstm_bf16_route(q, k, v, ig, fg, split):
    """The bf16 mLSTM kernels' arithmetic in plain PyTorch: fp32 q.k of bf16
    inputs, w in fp32, W rounded for the W V product."""
    B, S, H, D = q.shape
    Fh = mmod.gate_cumsum(fg).permute(0, 2, 1)
    ih = ig.float().permute(0, 2, 1)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    dmat = (Fh[..., :, None] - Fh[..., None, :] + ih[..., None, :]).masked_fill(~causal, -1e30)
    m = dmat.amax(-1)
    w = (qf @ kf.transpose(-1, -2)) / math.sqrt(D) * torch.exp(dmat - m[..., None])
    w = w.masked_fill(~causal, 0.0)
    den = torch.maximum(w.sum(-1).abs(), torch.exp(-m))
    out = _second_product(w, vf, split) / den[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _flash_bf16_route(q, k, v, split):
    """The bf16 flash kernel's arithmetic in plain PyTorch (causal, one
    softmax pass): P rounded for the P V product."""
    B, S, H, D = q.shape
    group = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (x.float().permute(0, 2, 1, 3).repeat_interleave(group, 1) for x in (k, v))
    s = (qf @ kf.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = _second_product(p, vf, split) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("B,S,H,D,seed", [
    (2, 77, 3, 192, 1),     # tests/test_torch_cuda.py's JAX-gate bf16 case
    (1, 300, 4, 1024, 0),   # xlstm-1.3b's serving shape at the JAX test's gates
])
def test_mlstm_bf16_route_needs_the_split_second_product(B, S, H, D, seed):
    """Pins the design: at the JAX test's gates, one bf16 rounding of W
    misses the bf16 comparison bar against the fp32 plain version; the
    kernels' hi + lo split meets it."""
    rng = np.random.default_rng(seed)
    q, k, v = (T(_np(rng, (B, S, H, D))).bfloat16() for _ in range(3))
    ig, fg = T(_np(rng, (B, S, H))), T(_np(rng, (B, S, H))) + 2.0
    exp = mmod.mlstm_plain(q, k, v, ig, fg)
    assert _bf16_rule_ratio(_mlstm_bf16_route(q, k, v, ig, fg, split=True), exp) <= 1.0
    assert _bf16_rule_ratio(_mlstm_bf16_route(q, k, v, ig, fg, split=False), exp) > 1.0


@pytest.mark.parametrize("S,H,K,D", [
    (300, 8, 8, 64),     # zamba2's shared block: MHA at D=64
    (304, 8, 2, 128),    # llama3-8b's prefill: group 4 at D=128
])
def test_flash_bf16_route_split_second_product_meets_the_bar(S, H, K, D):
    """The flash kernel's hi + lo split of P meets the bf16 bar with room;
    one bf16 rounding of P sits at its edge."""
    rng = np.random.default_rng(S + D)
    q = T(_np(rng, (1, S, H, D))).bfloat16()
    k, v = (T(_np(rng, (1, S, K, D))).bfloat16() for _ in range(2))
    exp = fmod.flash_attention_plain(q, k, v)
    split = _bf16_rule_ratio(_flash_bf16_route(q, k, v, split=True), exp)
    single = _bf16_rule_ratio(_flash_bf16_route(q, k, v, split=False), exp)
    assert split <= 0.9 and split < single


@pytest.mark.parametrize("product", ["scores", "wB", "h"])
def test_ssd_bf16_route_needs_the_split_of_each_product(product):
    """Pins the bf16 SSD kernels' design at zamba2-1.2b's serving shape
    (1 x 300, H = 64, G = 2, P = N = 64, chunk 128): with every fp32
    operand split into bf16 hi + lo, y meets `compare`'s bf16 bar and the
    fp32 final state the SSD state bar with room; one bf16 rounding of any
    one of the three (the scores before scores.x, w o B before x^T (w o B),
    the entering state before C h^T) misses a bar -- y for all three, the
    state too for w o B."""
    x, dt, A, Bm, Cm, D = _t(_ssd_inputs(1, 300, 64, 64, 2, 64, 0))
    x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    ey, eh = smod.ssd_plain(x, dt, A, Bm, Cm, D, chunk=128, return_state=True)

    def ratios(single):
        y, h = _ssd_state_passing(x, dt, A, Bm, Cm, D, 128, single=single)
        state = ((h - eh).abs() / (SSD_TOL["atol"] + SSD_TOL["rtol"] * eh.abs())).max().item()
        return _bf16_rule_ratio(y.to(torch.bfloat16), ey), state

    y_split, state_split = ratios(set())
    assert y_split <= 1.0 and state_split <= 0.1
    y_single, state_single = ratios({product})
    assert y_single > 1.0
    assert (state_single > 1.0) == (product == "wB")
