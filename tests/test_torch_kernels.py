"""The port's attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against `repro.kernels.ref` (and the Pallas kernels in interpret mode)
on the same numpy inputs, at fp32 2e-5 (`tests/test_kernels.py`'s bar).
The CUDA kernels themselves are compared with the plain versions by
`tests/test_torch_cuda.py` (marked `cuda`, skipped without a GPU) and by
`chip_smoke.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
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


def test_split_plan_covers_the_cache():
    for B, K, S in [(4, 8, 1024), (8, 8, 4096), (1, 1, 5), (3, 2, 97), (128, 8, 256)]:
        splits, chunk = dmod.split_plan(B, K, S)
        assert chunk % 32 == 0 and splits * chunk >= S > (splits - 1) * chunk
