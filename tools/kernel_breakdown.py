#!/usr/bin/env python3
"""Where the flash attention, mLSTM, decode attention and SSD kernels of the
PyTorch/CUDA port (``src/repro_torch``) spend their time on one NVIDIA H100.

    python3 tools/kernel_breakdown.py [--kernels flash,mlstm,decode,ssd]

Needs the card (exits 2 without one).  Prints the card's name and power
limit (``nvidia-smi``), then one JSON line per measurement:

* ``kernels``: device time of each kernel a wrapper launches, per call
  (``torch.profiler``, mean over 20 calls), at the serving shapes: flash
  attention at llama3-8b's and zamba2-1.2b's prefill (1x304, H=32, K=8,
  D=128; 1x300, H=K=32, D=64) beside ``F.scaled_dot_product_attention``
  (a yardstick only), and every kernel of the bf16 mLSTM wrapper (the
  forget-gate scan, the stabilizer, pass 1, pass 2) at 1x300 and 2x2048
  (H=4, D=1024).  ``cold``: the L2 cache is overwritten before each call,
  as ``chip_smoke.py`` times; ``warm``: it is not.
* ``flash_variant``: the flash kernel rebuilt from its source with the
  second product's lo half taken out (``no_lo``) or with the whole P.V
  product taken out (``no_pv``; the compiler then drops its loads and the
  split too).  Timing probes only: their outputs are wrong.
* ``flash_phases``: the flash kernel rebuilt with ``%globaltimer`` stamps
  written by thread 0 of each CTA (one cold call at llama3-8b's shape):
  for each query block, the median over heads of the time from the CTA's
  start until Q and the first K/V tile have landed, and per key tile the
  time spent starting the next tile's copies, in S = Q K^T, in scale, mask
  and softmax, and in P.V plus the wait for the next tile.

* ``decode``: device time per call of decode attention (cold and warm L2)
  at llama3-8b's and zamba2-1.2b's serving shapes (B=4, S=1024, bf16 q,
  fp32 cache, cache_len [332, 48, 305, 17]) and at B=8, S=4096 (bf16);
  ``decode_phases``: the kernel rebuilt with stamps (one cold call), for
  each CTA the time from its start until cache_len is read and the first
  copies are issued, the first tile has landed, the tile loop ends, the
  warps' partials are merged, the first cluster barrier is passed, the
  cluster combine is written and the second barrier is passed; medians
  over CTAs and the maxima, and the span from the first CTA's start to the
  last CTA's end.
* ``ssd``: device time per kernel of the bf16 SSD scan (cold and warm) at
  zamba2-1.2b's prefill (1x300, one cluster launch), 1x16 and 4x2048 (three
  launches); ``ssd_phases``: the cluster kernel rebuilt with stamps at
  1x300 (thread 0 of each CTA): a_cum done, dS done, warp 0's part of y
  that needs no state done, the cluster barrier passed, the entering
  state formed, y done.

The variants are built by patching a copy of the kernel's source under
``build/kernel_breakdown/``; a patch whose anchor is gone fails loudly.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MLSTM_SHAPES = ((1, 300), (2, 2048))  # (B, S) at H=4, D=1024
FLASH_SHAPES = ((304, 32, 8, 128), (300, 32, 32, 64))  # (S, H, K, D) at B=1

PV_LO = ("        tc::mma(acc[2 * dp], pl, bv[0], bv[1]);\n"
         "        tc::mma(acc[2 * dp + 1], pl, bv[2], bv[3]);\n")
PV_HI = ("        tc::mma(acc[2 * dp], ph, bv[0], bv[1]);\n"
         "        tc::mma(acc[2 * dp + 1], ph, bv[2], bv[3]);\n")
STAMP = ("if (threadIdx.x == 0 && {cond}) {{ long long t_; asm volatile(\"mov.u64 %0, "
         "%%globaltimer;\" : \"=l\"(t_)); trace[blockIdx.y * gridDim.x + blockIdx.x][{i}] = t_; }}\n")
PHASE_STAMPS = [  # (anchor, stamp index, stamp goes before the anchor)
    ("  bf16* vs = ks + 2 * BK * P;                    // 2 stages of BK x P\n", "0", False),
    ("  __syncthreads();  // Q and the first K/V tile have landed\n", "1", False),
    ("    __syncthreads();         // ... for every thread; tile j-1's readers are done\n",
     "2 + 4 * j", False),
    ("    const bf16* kt = ks + (j & 1) * BK * P;\n", "3 + 4 * j", True),
    ("    // scale, softcap, mask", "4 + 4 * j", True),
    ("    // O += P V, P as bf16 hi + lo register fragments", "5 + 4 * j", True),
    ("  tc::cp_async_wait<0>();  // no copy outlives the CTA\n", "22", False),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def patched_source(kind: str) -> str:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()

    def sub(old: str, new: str) -> None:
        nonlocal src
        if old not in src:
            raise RuntimeError(f"kernel_breakdown: patch anchor not found: {old[:60]!r}")
        src = src.replace(old, new, 1)

    if kind in ("no_lo", "no_pv"):
        sub(PV_LO, "")
        if kind == "no_pv":
            sub(PV_HI, "")
    elif kind == "phases":
        sub("namespace fa2 {\n", "namespace fa2 {\n__device__ long long trace[4096][24];\n")
        for anchor, i, before in PHASE_STAMPS:
            stamp = STAMP.format(cond="j < 5" if "j" in i else "true", i=i)
            sub(anchor, (stamp + anchor) if before else (anchor + stamp))
        src += ('\nextern "C" int flash_trace_read(void* host) {\n'
                "  return (int)cudaMemcpyFromSymbol(host, fa2::trace, sizeof(fa2::trace));\n}\n")
    return src


TRACE = ('__device__ long long g_trace[8192][8];\n'
         '#define STAMP(i) do { if (threadIdx.x == 0) { long long t_; asm volatile('
         '"mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_trace[(blockIdx.z * gridDim.y + '
         'blockIdx.y) * gridDim.x + blockIdx.x][i] = t_; } } while (0)\n')
TRACE_READ = ('\nextern "C" int trace_read(void* host) {\n'
              '  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n')
DECODE_STAMPS = [  # (anchor, code put before it, code put after it)
    ("  cg::cluster_group cluster = cg::this_cluster();\n", "STAMP(0);\n", ""),
    ("  // the group's q rows, scaled", "STAMP(1);\n", ""),
    ("    __syncthreads();                  // ... everyone's; tile j-1's readers are done\n",
     "", "if (j == 0) STAMP(2);\n"),
    ("  tc::cp_async_wait<0>();\n  __syncthreads();  // the ring is free", "STAMP(3);\n", ""),
    ("  cluster.sync();  // every CTA's partial is written\n", "STAMP(4);\n", "STAMP(5);\n"),
    ("  cluster.sync();  // peers are done reading this CTA's shared memory\n", "STAMP(6);\n",
     "STAMP(7);\n"),
]
DECODE_PHASES = ("first_copies_issued", "first_tile_landed", "tiles_done", "cta_merged",
                 "cluster_barrier_1", "combined", "cluster_barrier_2")
SSD_STAMPS = [
    ("  const int c = static_cast<int>(cluster.block_rank()), h = blockIdx.y, b = blockIdx.z;\n",
     "", "STAMP(0);\n"),
    ("  const float a_tot = sm.acs[L - 1];\n  tc::cp_async_wait<0>();\n", "STAMP(1);\n", ""),
    ("  // arrive now, wait after the part of y that needs no entering state\n", "STAMP(2);\n", ""),
    ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n', "STAMP(3);\n",
     "STAMP(4);\n"),
    ("  __syncthreads();\n  bf16* yb = y_rows(a, b, h, c);\n#pragma unroll\n", "STAMP(5);\n", ""),
    ("  cluster.sync();  // the peers are done reading this CTA's dS\n", "STAMP(6);\n", ""),
]
SSD_PHASES = ("a_cum_done", "dS_done", "y_intra_done", "cluster_barrier", "entering_state",
              "y_done")


def stamped_source(name: str, stamps) -> str:
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    for anchor, before, after in stamps:
        if anchor not in src:
            raise RuntimeError(f"kernel_breakdown: patch anchor not found: {anchor[:60]!r}")
        src = src.replace(anchor, before + anchor + after, 1)
    return src.replace('#include "mma.cuh"\n', '#include "mma.cuh"\n' + TRACE, 1) + TRACE_READ


def build_source(name: str, kind: str, src: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "kernel_breakdown" / kind
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for the {kind} build of {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def build_variant(kind: str) -> ctypes.CDLL:
    return build_source("flash_attention", kind, patched_source(kind))


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("kernel_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mamba2_ssd as smod
    from repro_torch.kernels import mlstm as mmod

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="flash,mlstm,decode,ssd",
                    help="comma-separated subset of flash,mlstm,decode,ssd")
    which = set(ap.parse_args().kernels.split(","))

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def device_us(fn, cold: bool, n: int = 20):
        """{kernel name: device us per call} over n calls of fn."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    flush.zero_()
                torch.cuda._sleep(1_000_000)  # the host enqueues fn while this runs
                fn()
            torch.cuda.synchronize()
        skip = ("spin_kernel", "FillFunctor")
        return {e.key[:90]: e.self_device_time_total / n for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not any(s in e.key for s in skip)}

    if "decode" in which:
        breakdown_decode(torch, np, dmod, _build, device_us, flush, dev)
    if "ssd" in which:
        breakdown_ssd(torch, np, smod, _build, device_us, flush, dev)
    if "flash" in which:
        breakdown_flash(torch, np, F, fmod, _build, device_us, flush, rnd)
    if "mlstm" in which:
        breakdown_mlstm(torch, mmod, device_us, gen, rnd, dev)
    return 0


def read_stamps(lib, n: int):
    import numpy as np

    buf = np.zeros((8192, 8), dtype=np.int64)
    rc = lib.trace_read(ctypes.c_void_p(buf.ctypes.data))
    if rc:
        raise RuntimeError(f"reading the trace failed: CUDA error {rc}")
    return buf[:n].astype(np.float64) / 1e3  # us


def phase_summary(np, t, names):
    """Per phase: median and max over CTAs of the time since each CTA's
    start (column 0), and the span from the first start to the last stamp."""
    rel = t[:, 1:len(names) + 1] - t[:, :1]
    return {"ctas": len(t), "span_us": float(t[:, len(names)].max() - t[:, 0].min()),
            "start_spread_us": float(t[:, 0].max() - t[:, 0].min()),
            **{n: [float(np.median(rel[:, i])), float(rel[:, i].max())]
               for i, n in enumerate(names)}}


def one_cold_call(torch, flush, fn):
    fn()
    torch.cuda.synchronize()
    flush.zero_()
    torch.cuda._sleep(1_000_000)
    fn()
    torch.cuda.synchronize()


def breakdown_decode(torch, np, dmod, _build, device_us, flush, dev):
    clen8 = [4096, 2048, 17, 1, 3000, 1024, 4095, 512]
    cases = [  # name, B, S, K, G, D, cache_len, q dtype, cache dtype
        ("llama3-8b", 4, 1024, 8, 4, 128, [332, 48, 305, 17], torch.bfloat16, torch.float32),
        ("zamba2-1.2b", 4, 1024, 32, 1, 64, [332, 48, 305, 17], torch.bfloat16, torch.float32),
        ("b8-s4096", 8, 4096, 8, 4, 128, clen8, torch.bfloat16, torch.bfloat16),
    ]
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = {}
    for name, B, S, K, G, D, clen, qd, kd in cases:
        q = torch.randn((B, K * G, D), generator=gen, device=dev).to(qd)
        kc, vc = (torch.randn((B, S, K, D), generator=gen, device=dev).to(kd) for _ in range(2))
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        inputs[name] = (B, K, q, kc, vc, cl)
        for cold in (True, False):
            emit({"kernels": "decode_attention", "case": name, "cold": cold,
                  "splits": dmod.cluster_splits(B, K),
                  "us": device_us(lambda: dmod.decode_attention(q, kc, vc, cl), cold)})
    built = _build.load("decode_attention")
    lib = build_source("decode_attention", "stamps", stamped_source("decode_attention",
                                                                    DECODE_STAMPS))
    try:
        _build._LOADED["decode_attention"] = lib
        for name, (B, K, q, kc, vc, cl) in inputs.items():
            one_cold_call(torch, flush, lambda: dmod.decode_attention(q, kc, vc, cl))
            splits = dmod.cluster_splits(B, K)
            t = read_stamps(lib, splits * K * B)
            longest = int(cl.argmax().item())  # the CTAs of the longest row: grid (splits, K, B)
            rows = t.reshape(B, K * splits, 8)[longest]
            emit({"decode_phases": name, "splits": splits, **phase_summary(np, t, DECODE_PHASES),
                  "longest_row_tiles_us": float(np.median(rows[:, 3] - rows[:, 2]))})
    finally:
        _build._LOADED["decode_attention"] = built


def breakdown_ssd(torch, np, smod, _build, device_us, flush, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = {}
    for B, S, state in ((1, 300, True), (1, 16, True), (4, 2048, False)):
        H, G = 64, 2
        x = torch.randn((B, S, H, 64), generator=gen, device=dev).bfloat16()
        Bm, Cm = (torch.randn((B, S, G, 64), generator=gen, device=dev).bfloat16() for _ in range(2))
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
        D = torch.randn((H,), generator=gen, device=dev)
        fn = (lambda x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D, state=state:
              smod.ssd(x, dt, A, Bm, Cm, D, return_state=state))
        inputs[(B, S)] = fn
        for cold in (True, False):
            emit({"kernels": "ssd", "B": B, "S": S, "H": H, "G": G, "return_state": state,
                  "cold": cold, "us": device_us(fn, cold)})
    built = _build.load("mamba2_ssd")
    lib = build_source("mamba2_ssd", "stamps", stamped_source("mamba2_ssd", SSD_STAMPS))
    try:
        _build._LOADED["mamba2_ssd"] = lib
        one_cold_call(torch, flush, inputs[(1, 300)])
        t = read_stamps(lib, 3 * 64)  # grid (3 chunks, 64 heads, 1)
        emit({"ssd_phases": {"B": 1, "S": 300, "H": 64}, **phase_summary(np, t, SSD_PHASES)})
    finally:
        _build._LOADED["mamba2_ssd"] = built


def breakdown_flash(torch, np, F, fmod, _build, device_us, flush, rnd):
    flash_in = {}
    for S, H, K, D in FLASH_SHAPES:
        q, k, v = rnd(1, S, H, D), rnd(1, S, K, D), rnd(1, S, K, D)
        flash_in[(S, H, K, D)] = (q, k, v)
        for cold in (True, False):
            emit({"kernels": "flash_attention", "S": S, "H": H, "K": K, "D": D, "cold": cold,
                  "us": device_us(lambda: fmod.flash_attention(q, k, v), cold),
                  "sdpa_us": device_us(lambda: F.scaled_dot_product_attention(
                      q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      is_causal=True, enable_gqa=True), cold)})
    built = _build.load("flash_attention")
    try:
        for kind in ("no_lo", "no_pv"):
            _build._LOADED["flash_attention"] = build_variant(kind)
            for (S, H, K, D), (q, k, v) in flash_in.items():
                emit({"flash_variant": kind, "S": S, "H": H, "K": K, "D": D,
                      "cold_us": device_us(lambda: fmod.flash_attention(q, k, v), True)})
        lib = build_variant("phases")
        _build._LOADED["flash_attention"] = lib
        (S, H, K, D), (q, k, v) = next(iter(flash_in.items()))
        fmod.flash_attention(q, k, v)
        torch.cuda.synchronize()
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        fmod.flash_attention(q, k, v)
        torch.cuda.synchronize()
        buf = np.zeros((4096, 24), dtype=np.int64)
        rc = lib.flash_trace_read(ctypes.c_void_p(buf.ctypes.data))
        if rc:
            raise RuntimeError(f"reading the trace failed: CUDA error {rc}")
        nq = (S + 63) // 64
        t = buf[: nq * H].astype(np.float64) / 1e3  # us
        start = t[:, 0].min()
        for x in range(nq):  # blockIdx.x; the query block is nq - 1 - x
            rows = t[[hh * nq + x for hh in range(H)]]
            med = lambda i: float(np.median(rows[:, i] - rows[:, 0]))  # noqa: E731
            ntile = min(5, nq - x)
            tiles = []
            for j in range(ntile):
                nxt = 2 + 4 * (j + 1) if j + 1 < ntile else 22
                tiles.append({"copy_next": med(3 + 4 * j) - med(2 + 4 * j),
                              "s": med(4 + 4 * j) - med(3 + 4 * j),
                              "softmax": med(5 + 4 * j) - med(4 + 4 * j),
                              "pv_and_wait": med(nxt) - med(5 + 4 * j)})
            emit({"flash_phases": {"S": S, "H": H, "K": K, "D": D}, "q_block": nq - 1 - x,
                  "cta_start_us": float(np.median(rows[:, 0] - start)),
                  "first_tile_landed_us": med(1), "tiles_us": tiles,
                  "loop_end_us": med(22)})
    finally:
        _build._LOADED["flash_attention"] = built


def breakdown_mlstm(torch, mmod, device_us, gen, rnd, dev):
    for B, S in MLSTM_SHAPES:
        q, k, v = rnd(B, S, 4, 1024), rnd(B, S, 4, 1024), rnd(B, S, 4, 1024)
        ig = torch.randn((B, S, 4), generator=gen, device=dev) * 0.1 - 10.0
        fg = torch.randn((B, S, 4), generator=gen, device=dev) * 0.1 + 4.0
        for cold in (True, False):
            emit({"kernels": "mlstm", "B": B, "S": S, "H": 4, "D": 1024, "cold": cold,
                  "us": device_us(lambda: mmod.mlstm(q, k, v, ig, fg), cold)})


if __name__ == "__main__":
    sys.exit(main())
