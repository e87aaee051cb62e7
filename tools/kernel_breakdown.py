#!/usr/bin/env python3
"""Where the bf16 flash attention and mLSTM kernels of the PyTorch/CUDA port
(``src/repro_torch``) spend their time on one NVIDIA H100.

    python3 tools/kernel_breakdown.py

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

The variants are built by patching a copy of ``csrc/flash_attention.cu``
under ``build/kernel_breakdown/``; a patch whose anchor is gone fails
loudly.
"""

from __future__ import annotations

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


def build_variant(kind: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "kernel_breakdown" / kind
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "flash_attention.cu", out / "flash_attention.so"
    cu.write_text(patched_source(kind))
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for the {kind} variant:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


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
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mlstm as mmod

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
    for B, S in MLSTM_SHAPES:
        q, k, v = rnd(B, S, 4, 1024), rnd(B, S, 4, 1024), rnd(B, S, 4, 1024)
        ig = torch.randn((B, S, 4), generator=gen, device=dev) * 0.1 - 10.0
        fg = torch.randn((B, S, 4), generator=gen, device=dev) * 0.1 + 4.0
        for cold in (True, False):
            emit({"kernels": "mlstm", "B": B, "S": S, "H": 4, "D": 1024, "cold": cold,
                  "us": device_us(lambda: mmod.mlstm(q, k, v, ig, fg), cold)})

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
