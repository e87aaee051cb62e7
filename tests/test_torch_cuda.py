"""The port's CUDA kernels (attention, Mamba2 SSD, mLSTM) against their
plain PyTorch versions, on the card; the MoE layer and MLA, which run no
kernel of the port, on the card against the CPU; and whisper and the VLM
prefix (reduced, 2 layers) on the card against the CPU.

Needs an NVIDIA GPU (marked `cuda`; each test skips without one) and
imports only torch and the port, so it runs where jax is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, by the output's dtype: fp32 2e-5 (`tests/test_kernels.py`'s
bar); bf16 one bf16 step at the largest value of the output row, and never
more than `tests/test_kernels.py`'s 2e-2 (both sides are fp32 results
rounded to bf16).  The SSD's fp32 final state: atol 5e-4 + rtol 1e-3
(`tests/test_kernels.py`'s SSD bar).  The mLSTM in fp32: atol 5e-4 + rtol
1e-3 (`tests/test_kernels.py`'s mLSTM bar); in bf16 the rule above.

bf16 inputs run the tensor-core kernels (the serving path), fp32 inputs
the scalar ones; the flash, SSD and mLSTM tests check which route ran.
The MoE and MLA layers in fp32 (reduced configs, TF32 off): 1e-5 (the
layer bar of `tests/test_torch_moe.py`), with the same experts picked.
Decode attention is one kernel for every dtype mix (fp32 math), one
launch per call with a cluster of CTAs per (row, kv head).

Training (fp32 and bf16): attention under autograd runs the flash kernel
forward inside ``_build.PlainBackwardFn``, whose backward is the plain
version's derivative, so the gradients are held to autograd of the plain
version at 1e-6 relative (the same computation; fp32 inside); the SSD scan
and the mLSTM run theirs inside it the same way, their gradients held equal to autograd of the plain version bit for bit; the
wrappers called directly (and decode attention) raise under autograd; one
reduced train step on the card against the CPU (fp32, TF32 off) for
llama3-8b, xlstm-1.3b and zamba2-1.2b (its reduced config as it is, P = N
= 16): loss and metrics 1e-5, parameters 1e-5 but for at most 1e-4 of the
elements, all within lr; and `launch.train --arch zamba2-1.2b --reduced`
on the default device.

The storage plane on the card: two ``repro_torch.launch.serve`` workers
(reduced llama3-8b, the default device) over shared file roots, one
SIGKILLed while it holds live leases after publishing a result; the survivor
serves every request exactly once and leaves the victim's results as they
were; and a bf16 train state of CUDA tensors through a ``FileBackend``
checkpoint, back bit for bit.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import mamba2_ssd as smod  # noqa: E402
from repro_torch.kernels import mlstm as mmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.util import tree_flatten, tree_map  # noqa: E402

BF16_ULP = 2.0 ** -7  # spacing of bfloat16 values in [1, 2)


def assert_matches_plain(out, exp):
    assert out.dtype == exp.dtype and out.shape == exp.shape
    fp32 = out.dtype == torch.float32
    out, exp = out.float(), exp.float()
    mag = exp.abs()
    if fp32:
        lim = 2e-5 + 2e-5 * mag
    else:
        lim = (BF16_ULP * mag.amax(-1, keepdim=True) + 1e-5).minimum(2e-2 + 2e-2 * mag)
    ratio = ((out - exp).abs() / lim).max().item()
    assert ratio <= 1.0, f"error {ratio:.3g}x its limit"

FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, window, cap, q_offset
    (2, 128, 128, 4, 4, 64, True, None, None, 0),
    (1, 256, 256, 8, 2, 64, True, None, None, 0),
    (1, 128, 128, 4, 1, 128, True, None, None, 0),
    (2, 128, 128, 4, 2, 32, True, 64, None, 0),
    (1, 128, 128, 2, 2, 64, True, None, 50.0, 0),
    (1, 128, 256, 4, 4, 64, True, None, None, 128),
    (1, 128, 128, 2, 1, 64, False, None, None, 0),
    (2, 77, 77, 4, 2, 32, True, None, None, 0),        # ragged Sq
    (1, 33, 100, 8, 1, 128, True, 20, 30.0, 67),       # ragged, offset, window, cap
    (1, 300, 300, 32, 32, 64, True, None, None, 0),    # zamba2 shared block prefill
    (1, 16, 16, 32, 32, 64, True, None, None, 0),
    (1, 304, 304, 32, 8, 128, True, None, None, 0),    # llama3-8b prefill group
    (1, 200, 200, 16, 2, 128, True, None, None, 0),    # group 8
    (2, 150, 150, 8, 8, 32, True, None, None, 0),      # D=32, ragged
    (1, 304, 304, 16, 16, 128, True, None, None, 0),   # olmoe-1b-7b prefill group (MHA)
    (1, 77, 77, 16, 16, 128, True, None, None, 0),     # olmoe, ragged
    (4, 1500, 1500, 20, 20, 64, False, None, None, 0),  # whisper encoder: full, ragged tail
    (4, 4, 1500, 20, 20, 64, False, None, None, 0),    # whisper cross-attention, prefill
    (4, 1, 1500, 20, 20, 64, False, None, None, 0),    # whisper cross-attention, decode
    (4, 260, 260, 14, 2, 64, True, None, None, 0),     # internvl2: 256-row prefix + 4 tokens
]
DECODE_CASES = [
    # S, H, K, D, window, cap
    (256, 8, 2, 64, None, None),
    (512, 4, 4, 32, None, None),
    (256, 8, 1, 128, 64, None),
    (256, 4, 2, 64, None, 30.0),
    (97, 4, 2, 32, None, None),
    (300, 14, 2, 64, None, None),    # group 7
    (300, 32, 2, 128, None, None),   # group 16
    (1024, 32, 32, 64, None, None),  # zamba2 shared block decode: MHA, D=64
    (1024, 16, 16, 128, None, None),  # olmoe-1b-7b decode: MHA (group 1), D=128
    (448, 20, 20, 64, None, None),   # whisper self-attention decode (448 positions)
    (1024, 14, 2, 64, None, None),   # internvl2-1b decode: group 7, D=64
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(rng, shape, dev, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, H, K, D, causal, window, cap, off = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (_t(rng, s, cuda, dtype) for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off)
    route = fmod.ROUTES[dtype]
    before, before_route = fmod.flash_attention.launches, fmod.flash_attention.route_launches[route]
    out = fmod.flash_attention(q, k, v, **kw)
    assert fmod.flash_attention.launches == before + 1
    assert fmod.flash_attention.route_launches[route] == before_route + 1
    assert route == ("scalar" if dtype == torch.float32 else "mma")
    exp = fmod.flash_attention_plain(q, k, v, **kw)
    assert_matches_plain(out, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,K,D,window,cap", DECODE_CASES)
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
])
def test_decode_kernel_matches_plain(cuda, S, H, K, D, window, cap, q_dtype, kv_dtype):
    rng = np.random.default_rng(S + H + D)
    B = 4
    q = _t(rng, (B, H, D), cuda, q_dtype)
    kc, vc = _t(rng, (B, S, K, D), cuda, kv_dtype), _t(rng, (B, S, K, D), cuda, kv_dtype)
    clen = torch.tensor([S, S // 2, 17, 1], dtype=torch.int32, device=cuda)
    kw = dict(window=window, logit_cap=cap)
    out = dmod.decode_attention(q, kc, vc, clen, **kw)
    exp = dmod.decode_attention_plain(q, kc, vc, clen, **kw)
    assert_matches_plain(out, exp)


# (B, K): one shape for each cluster size `cluster_splits` returns (8, 4,
# 2, 1), each with room for all the edge lengths
CLUSTER_SHAPES = [(8, 4), (8, 8), (8, 16), (33, 8)]
EDGE_LENS = [0, 1, 15, 16, 17]  # then S - 1 and S, then cycling


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", CLUSTER_SHAPES)
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("window", [None, 37])  # 37: starts mid-tile
def test_decode_kernel_live_lengths_in_every_cluster_size(cuda, B, K, q_dtype, kv_dtype, window):
    """Live lengths 0, 1, 15, 16, 17, S - 1 and S in one batch, in each
    cluster size the host picks: the device-side split of the live rows
    against the plain version, for all four dtype mixes."""
    S, G, D = 300, 4, 64
    rng = np.random.default_rng(B * K)
    q = _t(rng, (B, K * G, D), cuda, q_dtype)
    kc, vc = _t(rng, (B, S, K, D), cuda, kv_dtype), _t(rng, (B, S, K, D), cuda, kv_dtype)
    lens = (EDGE_LENS + [S - 1, S] + list(range(S, 0, -41)))[:B]
    lens += [int(x) for x in rng.integers(0, S + 1, size=B - len(lens))]
    clen = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = dmod.decode_attention(q, kc, vc, clen, window=window)
    assert_matches_plain(out, dmod.decode_attention_plain(q, kc, vc, clen, window=window))


@pytest.mark.cuda
def test_decode_cluster_sizes_cover_every_pick(cuda):
    assert {dmod.cluster_splits(B, K) for B, K in CLUSTER_SHAPES} == set(dmod.CLUSTER_SIZES)


@pytest.mark.cuda
def test_decode_call_is_one_launch_and_allocates_only_its_output(cuda):
    """One call: one kernel on the device (no combine kernel) and one
    allocation (the output; no per-call scratch)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    B, S, K, G, D = 4, 1024, 8, 4, 128
    q = _t(rng, (B, K * G, D), cuda, torch.bfloat16)
    kc, vc = _t(rng, (B, S, K, D), cuda, torch.float32), _t(rng, (B, S, K, D), cuda, torch.float32)
    clen = torch.tensor([332, 48, 305, 17], dtype=torch.int32, device=cuda)
    dmod.decode_attention(q, kc, vc, clen)  # built and warm
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    before = dmod.decode_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = dmod.decode_attention(q, kc, vc, clen)
        torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] - allocs == 1
    assert dmod.decode_attention.launches == before + 1
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_kernel" in kernels[0].name, [e.name for e in kernels]
    assert_matches_plain(out, dmod.decode_attention_plain(q, kc, vc, clen))


@pytest.mark.cuda
def test_decode_kernel_reads_strided_cache_slices(cuda):
    """A per-layer view of a larger cache (as the engine holds it) is read
    through its strides, not copied."""
    rng = np.random.default_rng(0)
    big = _t(rng, (3, 2, 64, 4, 32), cuda, torch.float32)  # (B, kv, S, K, D)
    kc, vc = big[:, 0], big[:, 1]
    q = _t(rng, (3, 8, 32), cuda, torch.float32)
    clen = torch.tensor([64, 5, 33], dtype=torch.int32, device=cuda)
    out = dmod.decode_attention(q, kc, vc, clen)
    exp = dmod.decode_attention_plain(q, kc, vc, clen)
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((2, 6, 48), device=cuda)  # head_dim 48
    kc = torch.zeros((2, 16, 2, 48), device=cuda)
    with pytest.raises(ValueError):
        dmod.decode_attention(q, kc, kc, torch.ones(2, dtype=torch.int32, device=cuda))
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        fmod.flash_attention(q, q.bfloat16(), q.bfloat16())


def _ssd_inputs(rng, B, S, H, G, dev, dtype, with_d=True, P=64, N=64):
    x, Bm, Cm = (_t(rng, s, dev, dtype) for s in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
    dt = torch.nn.functional.softplus(_t(rng, (B, S, H), dev, torch.float32))
    A = -torch.exp(_t(rng, (H,), dev, torch.float32))
    D = _t(rng, (H,), dev, torch.float32) if with_d else None
    return x, dt, A, Bm, Cm, D


def _check_ssd(out, exp, return_state):
    if return_state:
        assert_matches_plain(out[0], exp[0])
        torch.testing.assert_close(out[1], exp[1], atol=5e-4, rtol=1e-3)
    else:
        assert_matches_plain(out, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 77, 128, 300])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_d,return_state", [(True, True), (False, False)])
def test_ssd_kernel_matches_plain(cuda, S, G, dtype, with_d, return_state):
    rng = np.random.default_rng(S + G)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, 2, S, 8, G, cuda, dtype, with_d)
    _ssd_route_check(x, dt, A, Bm, Cm, D, dtype, return_state)


# every (P, N) of the kernels (smod.WIDTHS): zamba2, the reduced configs,
# the JAX kernel tests' (16, 8), (32, 16), (8, 4), and Mamba2's N = 128
@pytest.mark.cuda
@pytest.mark.parametrize("P,N", smod.WIDTHS)
@pytest.mark.parametrize("S,dtype", [(77, torch.float32), (300, torch.float32),
                                     (77, torch.bfloat16), (300, torch.bfloat16),
                                     (1100, torch.bfloat16)])
@pytest.mark.parametrize("return_state", [True, False])
def test_ssd_kernel_matches_plain_at_every_width(cuda, P, N, S, dtype, return_state):
    """Both routes at each width: one ragged chunk, three (the bf16 cluster
    launch), and 9 in bf16 (the three launches through scratch; fp32 stays
    at serving lengths, where the unnormalised scan meets its 2e-5 bar)."""
    rng = np.random.default_rng(P + N + S)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, 2, S, 8, 2, cuda, dtype, True, P, N)
    _ssd_route_check(x, dt, A, Bm, Cm, D, dtype, return_state)


def _ssd_route_check(x, dt, A, Bm, Cm, D, dtype, return_state):
    route = smod.ROUTES[dtype]
    before, before_route = smod.ssd.launches, smod.ssd.route_launches[route]
    out = smod.ssd(x, dt, A, Bm, Cm, D, chunk=128, return_state=return_state)
    assert smod.ssd.launches == before + 1
    assert smod.ssd.route_launches[route] == before_route + 1
    assert route == ("scalar" if dtype == torch.float32 else "mma")
    exp = smod.ssd_plain(x, dt, A, Bm, Cm, D, chunk=128, return_state=return_state)
    _check_ssd(out, exp, return_state)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 128, 129, 300, 2048])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("with_d,return_state", [(True, True), (False, False), (True, False)])
def test_ssd_bf16_chunk_parallel_matches_plain(cuda, S, G, chunk, with_d, return_state):
    """The bf16 route (chunk-parallel, tensor cores): ragged and whole
    chunks, one chunk and many, with and without D and the final state;
    every launch counted on the `mma` route."""
    rng = np.random.default_rng(S + G + chunk)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, 2, S, 8, G, cuda, torch.bfloat16, with_d)
    before, before_mma = smod.ssd.launches, smod.ssd.route_launches["mma"]
    out = smod.ssd(x, dt, A, Bm, Cm, D, chunk=chunk, return_state=return_state)
    assert smod.ssd.launches == before + 1
    assert smod.ssd.route_launches["mma"] == before_mma + 1
    exp = smod.ssd_plain(x, dt, A, Bm, Cm, D, chunk=chunk, return_state=return_state)
    _check_ssd(out, exp, return_state)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_conv_output_views(cuda, dtype):
    """x, B and C as the Mamba2 layer hands them over: views of one
    (B, S, conv_dim) conv output, read through their strides; chunk 32."""
    rng = np.random.default_rng(1)
    Bz, S, H, G = 2, 101, 8, 2
    d_in, gn = H * 64, G * 64
    xbc = _t(rng, (Bz, S, d_in + 2 * gn), cuda, dtype)
    x = xbc[..., :d_in].reshape(Bz, S, H, 64)
    Bm = xbc[..., d_in:d_in + gn].reshape(Bz, S, G, 64)
    Cm = xbc[..., d_in + gn:].reshape(Bz, S, G, 64)
    _, dt, A, _, _, D = _ssd_inputs(rng, Bz, S, H, G, cuda, dtype)
    out = smod.ssd(x, dt, A, Bm, Cm, D, chunk=32, return_state=True)
    exp = smod.ssd_plain(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), D,
                         chunk=32, return_state=True)
    _check_ssd(out, exp, True)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", [(8, 4), (16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_narrow_conv_output_views(cuda, P, N, dtype):
    """Views of one conv output whose B and C rows are not whole 16-byte
    pieces (N = 4 or 8 at an odd group count): the element-by-element
    loads."""
    rng = np.random.default_rng(P + N)
    Bz, S, H, G = 2, 150, 6, 3
    d_in, gn = H * P, G * N
    xbc = _t(rng, (Bz, S, d_in + 2 * gn), cuda, dtype)
    x = xbc[..., :d_in].reshape(Bz, S, H, P)
    Bm = xbc[..., d_in:d_in + gn].reshape(Bz, S, G, N)
    Cm = xbc[..., d_in + gn:].reshape(Bz, S, G, N)
    _, dt, A, _, _, D = _ssd_inputs(rng, Bz, S, H, G, cuda, dtype, True, P, N)
    out = smod.ssd(x, dt, A, Bm, Cm, D, chunk=64, return_state=True)
    exp = smod.ssd_plain(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), D,
                         chunk=64, return_state=True)
    _check_ssd(out, exp, True)


@pytest.mark.cuda
def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(2)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, 1, 16, 4, 2, cuda, torch.float32)
    with pytest.raises(ValueError):  # (P, N) = (32, 64), not among smod.WIDTHS
        smod.ssd(x[..., :32].contiguous(), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError):  # (P, N) = (64, 32)
        smod.ssd(x, dt, A, Bm[..., :32].contiguous(), Cm[..., :32].contiguous(), D)
    with pytest.raises(TypeError):  # bf16 dt
        smod.ssd(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(TypeError):  # mixed x / B types
        smod.ssd(x, dt, A, Bm.bfloat16(), Cm, D)
    with pytest.raises(ValueError):  # a chunk larger than the kernel's tile
        smod.ssd(torch.cat([x] * 16, 1), torch.cat([dt] * 16, 1), A,
                 torch.cat([Bm] * 16, 1), torch.cat([Cm] * 16, 1), D, chunk=256)


def _mlstm_inputs(rng, B, S, H, D, dev, dtype, model_gates):
    """q, k, v in ``dtype``; fp32 gates: the model's ranges (i near -10, f
    biases 3-6) or the JAX test's (i ~ N(0,1), f ~ N(2,1))."""
    q, k, v = (_t(rng, (B, S, H, D), dev, dtype) for _ in range(3))
    ig = _t(rng, (B, S, H), dev, torch.float32)
    fg = _t(rng, (B, S, H), dev, torch.float32) + 2.0
    if model_gates:
        ig = ig * 0.1 - 10.0
        fg = fg * 0.1 + torch.linspace(3.0, 6.0, H, device=dev)
    return q, k, v, ig, fg


def _check_mlstm(out, exp):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, exp, atol=5e-4, rtol=1e-3)
    else:
        assert_matches_plain(out, exp)


MLSTM_CASES = [
    # B, S, H, D, dtype, model gates: the cases of chip_smoke.py's phase 2
    (1, 300, 4, 1024, torch.bfloat16, True),   # xlstm-1.3b serving prefill
    (1, 16, 4, 1024, torch.bfloat16, True),
    (2, 2048, 4, 1024, torch.bfloat16, True),  # long stateless forward
    (2, 1, 4, 64, torch.float32, False),       # ragged S
    (2, 17, 4, 64, torch.float32, False),
    (2, 1000, 4, 64, torch.float32, False),
    (2, 300, 4, 1024, torch.float32, True),
    (2, 77, 3, 192, torch.bfloat16, False),    # D a multiple of 64, not of 128
    (1, 130, 2, 128, torch.float32, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,dtype,model_gates", MLSTM_CASES)
def test_mlstm_kernel_matches_plain(cuda, B, S, H, D, dtype, model_gates):
    rng = np.random.default_rng(S + D)
    inp = _mlstm_inputs(rng, B, S, H, D, cuda, dtype, model_gates)
    route = mmod.ROUTES[dtype]
    before, before_route = mmod.mlstm.launches, mmod.mlstm.route_launches[route]
    out = mmod.mlstm(*inp)
    assert mmod.mlstm.launches == before + 1
    assert mmod.mlstm.route_launches[route] == before_route + 1
    assert route == ("scalar" if dtype == torch.float32 else "mma")
    _check_mlstm(out, mmod.mlstm_plain(*inp))


@pytest.mark.cuda
@pytest.mark.parametrize("S,model_gates", [(300, True), (77, False), (200, False)])
def test_mlstm_kernel_runs_query_row_chunks(cuda, monkeypatch, S, model_gates):
    """A scratch cap below the whole W splits the bf16 route into
    query-row chunks; the output is the same, bit for bit (each weight and
    each row sum is formed the same way in a chunk), and matches plain."""
    B, H, D = 2, 3, 192
    rng = np.random.default_rng(S + 7)
    inp = _mlstm_inputs(rng, B, S, H, D, cuda, torch.bfloat16, model_gates)
    whole = mmod.mlstm(*inp)
    cap = mmod.chunk_scratch_bytes(B * H, (S - 1) // 64 * 64, S)  # the last block's own
    assert len(mmod.plan_chunks(B * H, S, cap)) > 1
    monkeypatch.setattr(mmod, "SCRATCH_CAP_BYTES", cap)
    out = mmod.mlstm(*inp)
    assert torch.equal(out, whole)
    _check_mlstm(out, mmod.mlstm_plain(*inp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_reads_strided_inputs(cuda, dtype):
    """q, k, v as views: head-major storage permuted to (B, S, H, D), and
    slices of one wider buffer; non-contiguous gates."""
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 150, 4, 128
    q = _t(rng, (B, H, S, D), cuda, dtype).transpose(1, 2)
    kv = _t(rng, (B, S, H, 2 * D), cuda, dtype)
    k, v = kv[..., :D], kv[..., D:]
    g = _t(rng, (B, H, S, 2), cuda, torch.float32).transpose(1, 2)
    ig, fg = g[..., 0] - 1.0, g[..., 1] + 2.0
    out = mmod.mlstm(q, k, v, ig, fg)
    _check_mlstm(out, mmod.mlstm_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                       ig.contiguous(), fg.contiguous()))


@pytest.mark.cuda
def test_mlstm_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(4)
    q, k, v, ig, fg = _mlstm_inputs(rng, 1, 16, 2, 64, cuda, torch.float32, False)
    with pytest.raises(ValueError):  # head_dim 32
        mmod.mlstm(q[..., :32].contiguous(), k[..., :32].contiguous(),
                   v[..., :32].contiguous(), ig, fg)
    with pytest.raises(TypeError):  # mixed q / k types
        mmod.mlstm(q, k.bfloat16(), v, ig, fg)
    with pytest.raises(ValueError):  # gates of another length
        mmod.mlstm(q, k, v, ig[:, :8], fg)
    with pytest.raises(ValueError):  # last dim not contiguous
        mmod.mlstm(torch.cat([q, q], -1)[..., ::2], k, v, ig, fg)


# ---------------------------------------------------------------------------
# MoE and MLA: plain PyTorch on every device, the card against the CPU
# ---------------------------------------------------------------------------

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _layer_params(arch, stage, key):
    """One layer's ``key`` subtree of a reduced ``arch``, on the CPU."""
    cfg = CONFIGS[arch].reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, p[stage][0][key]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("B,S", [(2, 24), (4, 25)])  # one group; a padded tail
def test_moe_apply_cuda_matches_cpu(cuda, monkeypatch, arch, B, S):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, p = _layer_params(arch, "decoder", "moe")
    rng = np.random.default_rng(B * S)
    for k, w in p["experts"].items():  # unit scale: dense_init's outputs sit inside atol
        p["experts"][k] = torch.from_numpy(rng.normal(size=w.shape).astype(np.float32)) / w.shape[1] ** 0.5
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))
    out_c, aux_c = moe_mod.moe_apply(p, x, cfg)
    p_g = tree_map(lambda t: t.to(cuda), p)
    out_g, aux_g = moe_mod.moe_apply(p_g, x.to(cuda), cfg)
    _, idx_c, _ = moe_mod._route(p, x.reshape(B * S, -1), cfg)
    _, idx_g, _ = moe_mod._route(p_g, x.to(cuda).reshape(B * S, -1), cfg)
    assert torch.equal(idx_g.cpu(), idx_c)
    torch.testing.assert_close(out_g.cpu(), out_c, **LAYER_TOL)
    torch.testing.assert_close(aux_g.cpu(), aux_c, **LAYER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prefill-40", "prefill-300", "decode"])
def test_mla_apply_cuda_matches_cpu(cuda, monkeypatch, mode):
    """Prefill below and above Sq * Sk = 256^2 (the reference, the chunked
    scan), and absorbed decode with per-slot lengths; no flash launch."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, p = _layer_params("deepseek-v3-671b", "decoder", "attn")
    m = cfg.mla
    rng = np.random.default_rng(7)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    if mode == "decode":
        B, S, max_len = 3, 1, 16
        clen = torch.tensor([0, 5, 11], dtype=torch.int32)
        cache = {"c_kv": f(B, max_len, m.kv_lora_rank), "k_pe": f(B, max_len, m.rope_head_dim)}
        kw = dict(positions=clen[:, None], cache_len=clen)
    else:
        B, S = 2, int(mode.split("-")[1])
        cache = mla_mod.init_mla_cache(cfg, B, S + 8, torch.float32)
        kw = dict(cache_len=0)
    x = f(B, S, cfg.d_model)
    launches = fmod.flash_attention.launches
    dev_kw = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    out_g, cache_g = mla_mod.mla_apply(tree_map(lambda t: t.to(cuda), p), x.to(cuda), cfg,
                                       cache=tree_map(lambda t: t.to(cuda), cache), **dev_kw)
    out_c, cache_c = mla_mod.mla_apply(p, x, cfg, cache=cache, **kw)
    assert fmod.flash_attention.launches == launches
    torch.testing.assert_close(out_g.cpu(), out_c, **LAYER_TOL)
    for k in ("c_kv", "k_pe"):
        torch.testing.assert_close(cache_g[k].cpu(), cache_c[k], **LAYER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [200, 300])  # the reference, the chunked scan
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dv_ne_d_attention_launches_no_flash_kernel(cuda, monkeypatch, Sq, dtype):
    """MLA's shapes (Dqk 192, Dv 128) go to plain PyTorch by shape: no
    flash launch on any route.  In fp32 the result is the CPU's; in bf16
    the chunked scan rounds its scores to bf16 (as the JAX scan does), and
    the two devices' GEMMs may round a score apart, so only the shape, the
    dtype and finite values are held there."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(Sq)
    q, k = _t(rng, (1, Sq, 8, 192), cuda, dtype), _t(rng, (1, Sq, 8, 192), cuda, dtype)
    v = _t(rng, (1, Sq, 8, 128), cuda, dtype)
    before = (fmod.flash_attention.launches, dict(fmod.flash_attention.route_launches))
    out = ops.flash_attention(q, k, v, causal=True)
    assert (fmod.flash_attention.launches, fmod.flash_attention.route_launches) == before
    exp = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    assert out.dtype == dtype and out.shape == (1, Sq, 8, 128) and out.isfinite().all()
    if dtype == torch.float32:
        assert_matches_plain(out.cpu(), exp)


# ---------------------------------------------------------------------------
# whisper and the VLM prefix: the card against the CPU
# ---------------------------------------------------------------------------

MODEL_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes", [
    ("whisper-large-v3", dict(encoder_seq=150)),  # a ragged encoder length
    ("internvl2-1b", dict(num_prefix_tokens=64)),
])
def test_whisper_and_vlm_prefix_cuda_match_cpu(cuda, monkeypatch, arch, changes):
    """Reduced widths at 2 layers (whisper: 2 encoder + 2 decoder), fp32
    (TF32 off): prefill of two right-padded prompts with the family's stub
    input, 4 greedy decode steps, then `forward`; identical tokens, logits
    within 2e-3; on the card the flash and decode kernels ran."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(CONFIGS[arch].reduced(), n_layers=2, **changes)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    lens = torch.tensor([20, 13])
    B, L = 2, 20
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, L)))
    extras, P = {}, 0
    if cfg.family == "encdec":
        extras["audio_frames"] = torch.from_numpy(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1)
    else:
        P = cfg.num_prefix_tokens
        extras["prefix_embed"] = torch.from_numpy(
            rng.normal(size=(B, P, cfg.d_model)).astype(np.float32) * 0.1)
    runs = {}
    launches = (fmod.flash_attention.launches, dmod.decode_attention.launches)
    cpu = torch.device("cpu")
    for name, d, p in (("cuda", cuda, tree_map(lambda t: t.to(cuda), p_cpu)), ("cpu", cpu, p_cpu)):
        ex = {k: v.to(d) for k, v in extras.items()}
        cache = init_cache(cfg, B, P + L + 8, torch.float32, d)
        lg, cache, n = prefill(p, cfg, {"tokens": toks.to(d), **ex}, cache, all_logits=True)
        assert n == P + L
        last = lg[torch.arange(B, device=d), (P + lens - 1).to(d)]
        logits, picks, clen = [last.cpu()], [last.argmax(-1).cpu()], (P + lens).to(d).int()
        for _ in range(4):
            step, cache = decode_step(p, cfg, picks[-1].to(d)[:, None], cache, clen)
            clen = clen + 1
            logits.append(step[:, 0].cpu())
            picks.append(step[:, 0].argmax(-1).cpu())
        seq = torch.cat([toks, torch.stack(picks[:4], 1)], 1).to(d)
        fwd, _, _ = forward(p, cfg, {"tokens": seq, **ex})
        runs[name] = (torch.stack(logits), torch.stack(picks), fwd.cpu())
        if name == "cuda":
            flash = fmod.flash_attention.launches - launches[0]
            decode = dmod.decode_attention.launches - launches[1]
            assert flash > 0 and decode > 0, (flash, decode)
    (lg_g, tk_g, fw_g), (lg_c, tk_c, fw_c) = runs["cuda"], runs["cpu"]
    assert torch.equal(tk_g, tk_c)
    torch.testing.assert_close(lg_g, lg_c, **MODEL_TOL)
    torch.testing.assert_close(fw_g, fw_c, **MODEL_TOL)


# ---------------------------------------------------------------------------
# training: the flash kernel under autograd, the forward-only guards, a step
# ---------------------------------------------------------------------------

GRAD_CASES = [
    # B, S, H, K, D, causal, window, cap
    (2, 128, 8, 2, 128, True, None, None),   # GQA 4
    (1, 77, 14, 2, 64, True, None, None),    # GQA 7, ragged S
    (2, 150, 8, 8, 64, True, 64, None),      # window, ragged
    (1, 100, 4, 1, 128, True, None, 50.0),   # softcap, GQA 4
    (1, 96, 4, 4, 64, False, None, None),    # full
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_through_the_kernel(cuda, case, dtype):
    B, S, H, K, D, causal, window, cap = case
    rng = np.random.default_rng(sum(case[:5]))
    base = [_t(rng, s, cuda, dtype) for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]
    go = _t(rng, (B, S, H, D), cuda, dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    ins = [t.clone().requires_grad_(True) for t in base]
    before = fmod.flash_attention.launches
    out = ops.flash_attention(*ins, **kw)
    assert fmod.flash_attention.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, ins, go)
    ref = [t.clone().requires_grad_(True) for t in base]
    exp_out = fmod.flash_attention_plain(*ref, **kw)
    exp = torch.autograd.grad(exp_out, ref, go)
    assert_matches_plain(out.detach(), exp_out.detach())
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and a.abs().max() > 0
        torch.testing.assert_close(a, b, atol=0, rtol=1e-6)
    with torch.no_grad():  # serving calls go to the wrapper as they are
        assert ops.flash_attention(*ins, **kw).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("S,with_d", [(300, True), (77, False), (1024, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradients_through_the_kernel(cuda, S, with_d, dtype):
    """``ops.ssd_scan`` under autograd: one launch per call on the dtype's
    route, x, B and C taken as views of the conv output; the gradients of
    every input equal autograd of the plain version; the state refused."""
    rng = np.random.default_rng(S + 11)
    Bz, H, G = 2, 8, 2
    d_in, gn = H * 64, G * 64
    xbc = _t(rng, (Bz, S, d_in + 2 * gn), cuda, dtype)
    _, dt, A, _, _, D = _ssd_inputs(rng, Bz, S, H, G, cuda, dtype, with_d)
    go = _t(rng, (Bz, S, H, 64), cuda, dtype)
    base = [t for t in (xbc, dt, A, D) if t is not None]

    def run(leaves, fn):
        x = leaves[0][..., :d_in].reshape(Bz, S, H, 64)
        Bm = leaves[0][..., d_in:d_in + gn].reshape(Bz, S, G, 64)
        Cm = leaves[0][..., d_in + gn:].reshape(Bz, S, G, 64)
        return fn(x, leaves[1], leaves[2], Bm, Cm, leaves[3] if with_d else None, chunk=128)

    ins = [t.clone().requires_grad_(True) for t in base]
    route = smod.ROUTES[dtype]
    before, before_route = smod.ssd.launches, smod.ssd.route_launches[route]
    out = run(ins, ops.ssd_scan)
    assert smod.ssd.launches == before + 1 and smod.ssd.route_launches[route] == before_route + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, go)
    ref = [t.clone().requires_grad_(True) for t in base]
    exp_out = run(ref, smod.ssd_plain)
    exp = torch.autograd.grad(exp_out, ref, go)
    assert_matches_plain(out.detach(), exp_out.detach())
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and a.abs().max() > 0
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="ssd"):
        run(ins, lambda *a, **k: ops.ssd_scan(*a, **k, return_state=True))
    with torch.no_grad():  # serving calls go to the wrapper as they are
        assert run(ins, ops.ssd_scan).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,dtype,model_gates", [
    (1, 300, 4, 1024, torch.bfloat16, True),   # xlstm-1.3b, the blockwise plain backward
    (2, 77, 3, 192, torch.bfloat16, False),
    (2, 130, 2, 128, torch.float32, False),
])
def test_mlstm_gradients_through_the_kernel(cuda, B, S, H, D, dtype, model_gates):
    """``ops.mlstm_parallel`` under autograd: one launch per call on the
    dtype's route; the gradients of q, k, v and both gates equal autograd
    of the plain version (the gates' in fp32)."""
    rng = np.random.default_rng(S + D)
    base = _mlstm_inputs(rng, B, S, H, D, cuda, dtype, model_gates)
    go = _t(rng, (B, S, H, D), cuda, dtype)
    ins = [t.clone().requires_grad_(True) for t in base]
    route = mmod.ROUTES[dtype]
    before, before_route = mmod.mlstm.launches, mmod.mlstm.route_launches[route]
    out = ops.mlstm_parallel(*ins)
    assert mmod.mlstm.launches == before + 1
    assert mmod.mlstm.route_launches[route] == before_route + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, ins, go)
    ref = [t.clone().requires_grad_(True) for t in base]
    exp_out = mmod.mlstm_plain(*ref)
    exp = torch.autograd.grad(exp_out, ref, go)
    _check_mlstm(out.detach(), exp_out.detach())
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and a.abs().max() > 0
        assert torch.equal(a, b)
    assert got[3].dtype == got[4].dtype == torch.float32
    with torch.no_grad():
        assert ops.mlstm_parallel(*ins).grad_fn is None


@pytest.mark.cuda
def test_forward_only_kernels_raise_under_autograd(cuda):
    rng = np.random.default_rng(6)
    q = _t(rng, (2, 8, 64), cuda, torch.float32).requires_grad_(True)
    kc, vc = (_t(rng, (2, 64, 2, 64), cuda, torch.float32) for _ in range(2))
    lens = torch.tensor([10, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attention"):
        dmod.decode_attention(q, kc, vc, lens)
    with torch.no_grad():
        dmod.decode_attention(q, kc, vc, lens)
    x = _t(rng, (1, 32, 4, 64), cuda, torch.float32).requires_grad_(True)
    dt = torch.nn.functional.softplus(_t(rng, (1, 32, 4), cuda, torch.float32))
    A = -torch.exp(_t(rng, (4,), cuda, torch.float32))
    Bm, Cm = (_t(rng, (1, 32, 1, 64), cuda, torch.float32) for _ in range(2))
    with pytest.raises(RuntimeError, match="ssd"):
        smod.ssd(x, dt, A, Bm, Cm)
    with torch.no_grad():
        smod.ssd(x, dt, A, Bm, Cm)
    mq, mk, mv, ig, fg = _mlstm_inputs(rng, 1, 16, 2, 64, cuda, torch.float32, False)
    with pytest.raises(RuntimeError, match="mlstm"):
        mmod.mlstm(mq.requires_grad_(True), mk, mv, ig, fg)
    with pytest.raises(RuntimeError, match="flash_attention"):
        fmod.flash_attention(x, x.detach(), x.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_reduced_train_step_cuda_matches_cpu(cuda, monkeypatch, fused):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = CONFIGS["llama3-8b"].reduced()
    opt = topt.adamw(1e-3)
    step = tts.make_train_step(cfg, opt, remat=True, fused_ce=fused)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = fmod.flash_attention.launches
    s_gpu, m_gpu = step(tts.TrainState(tree_map(lambda t: t.to(cuda), p_cpu),
                                       opt.init(tree_map(lambda t: t.to(cuda), p_cpu))),
                        {k: v.to(cuda) for k, v in batch.items()})
    assert fmod.flash_attention.launches - before == 2 * cfg.n_layers  # forward + recompute
    s_cpu, m_cpu = step(tts.TrainState(p_cpu, opt.init(p_cpu)), batch)
    for k in m_cpu:
        assert float(m_gpu[k]) == pytest.approx(float(m_cpu[k]), rel=1e-5, abs=1e-5), k
    # Adam moves an element whose gradient is near eps by up to lr in a
    # direction its noise sets (measured: 2 of 32768 elements of one leaf,
    # 1.2e-4 = 0.12 lr); all others within 1e-5
    diffs = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in
                       zip(tree_flatten(s_gpu.params)[0], tree_flatten(s_cpu.params)[0])])
    assert int((diffs > 1e-5).sum()) <= 1e-4 * diffs.numel()
    assert float(diffs.max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_recurrent_train_step_cuda_matches_cpu(cuda, monkeypatch, arch):
    """One train step (remat, the fused CE) through the SSD or mLSTM kernel
    on the card against the plain versions on the CPU, as the llama3-8b
    step above: each kernel launched twice per layer (the forward and the
    recompute)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    if arch == "zamba2-1.2b":
        cfg, counter = CONFIGS[arch].reduced(), smod.ssd
        layers = cfg.n_layers
    else:
        cfg, counter = CONFIGS[arch].reduced(), mmod.mlstm
        layers = cfg.n_layers - cfg.n_layers // cfg.xlstm.slstm_every
    opt = topt.adamw(1e-3)
    step = tts.make_train_step(cfg, opt, remat=True, fused_ce=True)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 41)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = counter.launches
    s_gpu, m_gpu = step(tts.TrainState(tree_map(lambda t: t.to(cuda), p_cpu),
                                       opt.init(tree_map(lambda t: t.to(cuda), p_cpu))),
                        {k: v.to(cuda) for k, v in batch.items()})
    assert counter.launches - before == 2 * layers
    s_cpu, m_cpu = step(tts.TrainState(p_cpu, opt.init(p_cpu)), batch)
    for k in m_cpu:
        assert float(m_gpu[k]) == pytest.approx(float(m_cpu[k]), rel=1e-5, abs=1e-5), k
    diffs = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in
                       zip(tree_flatten(s_gpu.params)[0], tree_flatten(s_cpu.params)[0])])
    assert int((diffs > 1e-5).sum()) <= 1e-4 * diffs.numel()
    assert float(diffs.max()) <= 1e-3


@pytest.mark.cuda
def test_launch_train_reduced_hybrid_on_the_default_device(cuda):
    """``launch.train --arch zamba2-1.2b --reduced`` with no ``--device``:
    the reduced hybrid (P = N = 16) through the SSD kernel on the card."""
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "zamba2-1.2b",
         "--reduced", "--steps", "4", "--steps-per-chunk", "2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].endswith("checkpoint v2"), lines
    losses = json.loads(lines[-2].split(": ", 1)[1])
    assert len(losses) == 2 and all(np.isfinite(losses))  # one loss per 2-step chunk


# ---------------------------------------------------------------------------
# the storage plane on the card
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _worker(kv_root, obj_root, engine_id):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3-8b", "--reduced",
           "--kv-root", kv_root, "--obj-root", obj_root, "--engine-id", engine_id,
           "--batch", "4", "--max-len", "128", "--new-tokens", "48", "--decode-chunk", "1",
           "--lease-timeout", "1", "--idle-timeout", "3"]
    env = dict(os.environ, PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    lines, ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("READY"):
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, lines, ready, reader


@pytest.mark.cuda
def test_two_card_workers_survive_a_sigkill(cuda, tmp_path):
    from repro_torch.serve import request_plane as rp
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    kv, store = FileKVStore(kv_root, num_shards=2), ObjectStore(backend=FileBackend(obj_root))
    workers = {name: _worker(kv_root, obj_root, name) for name in ("victim", "survivor")}
    try:
        for name, (proc, lines, ready, _) in workers.items():
            assert ready.wait(120), f"{name} never printed READY: {''.join(lines)[-3000:]}"
        cfg = CONFIGS["llama3-8b"].reduced()
        rng = np.random.default_rng(0)
        ids = [f"g{i}" for i in range(32)]
        for r in ids:
            rp.submit(store, kv, r, rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 64))).tolist())
        victim = workers["victim"][0]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            now, keys = time.time(), kv.scan(rp.LEASE_PREFIX)
            live = [k for k, rec in zip(keys, kv.mget(keys))
                    if rec and rec["engine"] == "victim" and float(rec["expires"]) > now]
            done = store.get_many(sorted(store.exists_many([rp.done_key(r) for r in ids])))
            if live and any(rec["engine"] == "victim" for rec in done.values()) and len(done) < len(ids):
                break
            time.sleep(0.01)
        else:
            pytest.fail("the victim never held live leases after publishing a result")
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=30)
        before = {k: store.get(k) for k in store.exists_many([rp.done_key(r) for r in ids])}
        survivor, lines, _, reader = workers["survivor"]
        assert survivor.wait(timeout=300) == 0, "".join(lines)[-3000:]
        reader.join(timeout=30)  # the last lines are read after the exit
    finally:
        for proc, _, _, _ in workers.values():
            if proc.poll() is None:
                proc.kill()
    assert victim.returncode == -signal.SIGKILL
    out = "".join(workers["survivor"][1])
    assert "survivor: served" in out, out[-3000:]
    launches = json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("launches ")).split(" ", 1)[1])
    assert launches["decode_attention"] > 0 and launches["flash_attention"] > 0, out[-3000:]
    assert sorted(store.list("serve/done/")) == sorted(rp.done_key(r) for r in ids)
    res = rp.get_results(store, ids, timeout_s=10)
    assert all(len(res[r]["tokens"]) == 48 for r in ids), {r: len(res[r]["tokens"]) for r in ids}
    for k, rec in before.items():  # the victim's published results stand
        assert store.get(k) == rec
    assert any(rec["engine"] == "victim" for rec in res.values())
    assert any(rec["engine"] == "survivor" for rec in res.values())
    kv.close()
    store.backend.close()


@pytest.mark.cuda
def test_bf16_cuda_checkpoint_round_trips_through_a_file_backend(cuda, tmp_path):
    from repro_torch.storage import FileBackend, ObjectStore
    from repro_torch.train import checkpoint as ck

    cfg = dataclasses.replace(CONFIGS["llama3-8b"].reduced(), param_dtype="bfloat16")
    opt = topt.adamw(1e-3, quantize_moments=True)
    state = tts.init_train_state(cfg, opt, torch.Generator(device=cuda).manual_seed(0), cuda)
    assert ck.save(ObjectStore(backend=FileBackend(str(tmp_path))), "c", 0, tuple(state))
    loaded, _, _ = ck.load(ObjectStore(backend=FileBackend(str(tmp_path))), "c", 0, device=cuda)
    a, b = tree_flatten(tuple(state))[0], tree_flatten(loaded)[0]
    assert len(a) == len(b) and any(x.dtype == torch.bfloat16 for x in a)
    for x, y in zip(a, b):
        assert y.device.type == "cuda" and x.dtype == y.dtype
        assert torch.equal(x.reshape(y.shape), y)  # a 0-d leaf comes back as (1,)


@pytest.mark.cuda
def test_sharded_program_on_a_one_card_nccl_mesh(cuda):
    """Phase 9a of ``chip_smoke.py`` at the reduced width: a (1, 1) mesh over
    NCCL (world size 1), parameters and caches placed by the port's rules,
    prefill of two prompts and 4 greedy decode steps under ``use_mesh``
    equal to the plain-tensor run (tokens identical, logits within 2e-5),
    the flash and decode kernels launched on the local shards; then one
    train step on the sharded state: a finite loss, every leaf's gradient
    nonzero."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspec, cache_pspec, state_pspec, to_shardings
    from repro_torch.models.sharding import distribute, param_sharding, use_mesh
    from repro_torch.train import TrainState, adamw

    cfg = dataclasses.replace(CONFIGS["llama3-8b"].reduced(), n_layers=2)
    full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x  # noqa: E731
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(1), cuda)
        prompts = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda,
                                generator=torch.Generator(device=cuda).manual_seed(2))

        def generate(p, cache):
            toks, logits = [], []
            out, cache, n = prefill(p, cfg, {"tokens": prompts}, cache)
            for i in range(5):
                logits.append(full(out[:, -1]))
                toks.append(logits[-1].argmax(-1))
                if i < 4:
                    out, cache = decode_step(p, cfg, toks[-1][:, None], cache, n + i)
            return torch.stack(toks), torch.stack(logits)

        with torch.no_grad():
            ref_toks, ref_logits = generate(params, init_cache(cfg, 2, 64, torch.float32, cuda))
        sp = distribute(params, param_sharding(mesh, params))
        cache = init_cache(cfg, 2, 64, torch.float32, cuda)
        cache = distribute(cache, to_shardings(mesh, cache_pspec(mesh, cfg, cache)))
        before = (fmod.flash_attention.launches, dmod.decode_attention.launches)
        with torch.no_grad(), use_mesh(mesh):
            toks, logits = generate(sp, cache)
        assert fmod.flash_attention.launches > before[0]
        assert dmod.decode_attention.launches > before[1]
        assert torch.equal(toks, ref_toks)
        assert (logits - ref_logits).abs().max().item() <= 2e-5

        opt = adamw(1e-4)
        state = TrainState(sp, opt.init(sp))
        state = distribute(state, to_shardings(mesh, state_pspec(mesh, state)))
        tokens = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(3))
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        batch = distribute(batch, to_shardings(mesh, batch_pspec(mesh, batch)))
        with use_mesh(mesh):
            grads, _ = tts.grad_fn(tts.make_loss_fn(cfg), state.params, batch)
            assert all(bool((full(g) != 0).any()) for g in grads)
            _, metrics = tts.make_train_step(cfg, opt, inplace=True)(state, batch)
        assert np.isfinite(float(full(metrics["loss"])))
    finally:
        dist.destroy_process_group()
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_vocabulary_lookup_and_sampler_on_the_card(cuda, dtype):
    """Ids past the table give NaN rows and negative ids wrap, on the card
    as on the CPU, with no device-side assert; a NaN row's sampled and
    greedy token is 0, and the other rows keep their draws."""
    from repro_torch.models.model import take_rows
    from repro_torch.serve.engine import sample_tokens

    V = 512
    table = torch.randn(V, 16, generator=torch.Generator().manual_seed(0)).to(dtype)
    ids = torch.tensor([[0, V - 1, -1, -V, V, V + 388, -V - 1]])
    got = take_rows(table.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), take_rows(table, ids), rtol=0, atol=0, equal_nan=True)
    assert got.isnan().all(-1).tolist() == [[False, False, False, False, True, True, True]]
    logits = torch.randn(3, V, generator=torch.Generator().manual_seed(1)).to(cuda)
    clean = sample_tokens(logits, [1, 2, 3], 0, 0.8)
    logits[1] = float("nan")
    toks = sample_tokens(logits, [1, 2, 3], 0, 0.8)
    torch.cuda.synchronize()
    assert toks.tolist() == [clean[0].item(), 0, clean[2].item()]
    assert sample_tokens(logits, None, 0, 0.0)[1].item() == 0
