"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.  Builds happen
at first use, never at import; :func:`build_all` starts one ``nvcc`` per
source at once.  A build that fails raises with the compiler's output.

Builds are safe across processes: each library has an exclusive ``flock``
on ``<name>-<hash>.lock`` beside it, held from the check that the library
exists through the compile to the ``os.replace`` that publishes it, and
taken in sorted name order (so two callers cannot deadlock).  Any number
of processes calling :func:`build_all` on one build directory run one
``nvcc`` per kernel and source hash; the others wait and load its library.
A compile that fails leaves no library, and its output in
``<name>-<hash>.err``, which every caller that overlapped it raises with
(a later call compiles again).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
KERNELS = ("decode_attention", "flash_attention", "mamba2_ssd", "mlstm")

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout (``build/``
    is git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else torch's CUDA home's, else ``nvcc`` on
    the ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    homes = [os.environ.get("CUDA_HOME"), CUDA_HOME]
    cand = [os.path.join(h, "bin", "nvcc") for h in homes if h]
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


# names this process ran ``nvcc`` for, in order (tools/cold_build.py reads it)
compiled: List[str] = []


def _lock(lib: Path) -> int:
    """Block on the exclusive lock of ``lib``'s build -> its fd (closing
    it releases the lock)."""
    fd = os.open(lib.with_suffix(".lock"), os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
    except BaseException:
        os.close(fd)
        raise
    return fd


# A failed build's ``.err`` younger than this when a call starts belongs to a
# build the call overlapped (file times tick coarser than time.time()); an
# older one is stale, and the call compiles again.
_ERR_FRESH_S = 1.0


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel not yet built, one ``nvcc`` each, all
    started together, each under its library's lock (module docstring).
    Returns seconds per name: 0.0 where already built, else until the
    library was there (compiled here or by the process this one waited
    for); ``ptxas`` register/spill reports go to ``<name>.log`` beside
    the library."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0, started = time.perf_counter(), time.time() - _ERR_FRESH_S
    times: Dict[str, float] = {}
    held: List[int] = []
    procs: List = []
    errors = []
    try:
        for name in sorted(set(names)):
            lib = _lib_path(name)
            if lib.exists():
                times[name] = 0.0
                continue
            held.append(_lock(lib))
            err = lib.with_suffix(".err")
            if lib.exists():  # built by the process this one waited for
                times[name] = time.perf_counter() - t0
                continue
            if err.exists() and err.stat().st_mtime >= started:  # that build failed
                errors.append(err.read_text())
                continue
            err.unlink(missing_ok=True)
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            compiled.append(name)
            procs.append((name, lib, tmp, err, p))
        for name, lib, tmp, err, p in procs:
            log, _ = p.communicate()
            times[name] = time.perf_counter() - t0
            (out / f"{name}.log").write_text(log)
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                msg = f"nvcc failed for {name} (rc {p.returncode}):\n{log}"
                err.write_text(msg)
                errors.append(msg)
                continue
            os.replace(tmp, lib)
    finally:
        for _, _, tmp, _, p in procs:
            if p.poll() is None:  # interrupted: stop the compiles this call started
                p.kill()
                p.wait()
                tmp.unlink(missing_ok=True)
        for fd in held:
            os.close(fd)  # releases the flock
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED.setdefault(name, ctypes.CDLL(str(_lib_path(name))))
    return lib


def no_backward(kernel: str, *tensors) -> None:
    """Raise if autograd would need a gradient through ``kernel``: the CUDA
    kernels are forward-only (the JAX package has no backward kernel
    either), and a launch through raw pointers returns a tensor with no
    ``grad_fn``, so the gradients of its inputs would silently be lost;
    training goes through :class:`PlainBackwardFn` instead."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel is forward-only and an input requires grad; "
            "run it under torch.no_grad(), or differentiate through its plain version"
        )


class PlainBackwardFn(torch.autograd.Function):
    """A forward-only kernel under autograd.

    ``apply(fwd, plain, kw, *tensors)``: the forward is ``fwd(*tensors,
    **kw)`` (a kernel's CUDA wrapper in training; a test may pass the plain
    version) and saves the tensors as they are (strided views are not
    copied; None stays None).  The backward recomputes the output with
    ``plain(*tensors, **kw)`` (fp32 inside) and returns its gradients, each
    in its input's dtype (None for a None input): the plain version's
    derivative, as ``jax.grad`` of the Pallas kernel's reference would
    give, not a backward kernel (neither package has one).  Whatever the
    plain version materialises (attention's fp32 logits, each SSD chunk's
    decay matrix) is made once per call."""

    @staticmethod
    def forward(ctx, fwd, plain, kw, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.plain, ctx.kw = plain, kw
        return fwd(*tensors, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = ctx.plain(*leaves, **ctx.kw)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t is not None], grad_out))
        return (None, None, None, *(None if t is None else next(grads) for t in leaves))


def ptxas_report(name: str) -> Optional[str]:
    """The ``ptxas -v`` lines of the last build of ``name`` (registers,
    shared memory, stack and spills per kernel), if any."""
    log = build_dir() / f"{name}.log"
    if not log.exists():
        return None
    return "\n".join(l for l in log.read_text().splitlines() if "ptxas" in l or "spill" in l)
