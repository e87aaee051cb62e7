"""The kernel build is safe across processes (``repro_torch.kernels._build``).

Two processes that start ``build_all`` on one cold build directory together
run one ``nvcc`` per kernel between them, and both end with every library;
a compile that fails raises, with the compiler's output, in both, and leaves
no library.  ``nvcc`` is a stub script found through ``CUDA_HOME`` that
sleeps, writes its ``-o`` file and appends the kernel's name to a counter;
the builders are ``tools/cold_build.py``'s, each with ``_build.build_dir``
patched onto the test's directory.
"""

import importlib.util
import os
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STUB_SLEEP_S = 1.5
_spec = importlib.util.spec_from_file_location("cold_build", ROOT / "tools" / "cold_build.py")
cold_build = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cold_build)


def _stub_cuda_home(tmp_path: Path, fail: bool) -> Path:
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    counter = tmp_path / "nvcc-runs.txt"
    stub = home / "bin" / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import os, sys, time\n"
        "args = sys.argv[1:]\n"
        "name = os.path.basename(args[-1])[:-len('.cu')]\n"
        f"with open({str(counter)!r}, 'a') as f:\n"
        "    f.write(name + '\\n')\n"
        f"time.sleep({STUB_SLEEP_S})\n"
        + ("print('stub-nvcc: error in ' + name)\nsys.exit(2)\n" if fail else
           "open(args[args.index('-o') + 1], 'wb').write(b'stub ' + name.encode())\n")
    )
    stub.chmod(0o755)
    return home


def _race(tmp_path: Path, monkeypatch, fail: bool, n: int = 2):
    """``n`` builders released together into ``build_all`` by
    ``tools/cold_build.py`` -> (their rows, the names the stub compiled,
    the build directory)."""
    monkeypatch.setenv("CUDA_HOME", str(_stub_cuda_home(tmp_path, fail)))
    out = tmp_path / "build"
    row = cold_build.race(out, n)
    runs = (tmp_path / "nvcc-runs.txt").read_text().split()
    return row["per_builder"], runs, out


@pytest.mark.parametrize("n", [2, 4])
def test_two_concurrent_builders_compile_each_kernel_once(tmp_path, monkeypatch, n):
    rows, runs, out = _race(tmp_path, monkeypatch, fail=False, n=n)
    assert sorted(runs) == sorted(_build.KERNELS), runs
    assert not any("error" in r for r in rows), rows
    compiled = [name for r in rows for name in r["compiled"]]
    assert sorted(compiled) == sorted(_build.KERNELS), rows
    for r in rows:  # each caller compiled, or waited for the other's compile
        assert sorted(r["times"]) == sorted(_build.KERNELS)
        assert max(r["times"].values()) > STUB_SLEEP_S / 2, r
    libs = sorted(p.name.split("-")[0] for p in out.glob("*.so"))
    assert libs == sorted(_build.KERNELS), sorted(os.listdir(out))
    assert not list(out.glob("*.tmp*")) and not list(out.glob("*.err"))
    for lib in out.glob("*.so"):
        assert lib.read_bytes() == b"stub " + lib.name.split("-")[0].encode()


def test_a_failed_compile_raises_in_every_concurrent_caller(tmp_path, monkeypatch):
    rows, runs, out = _race(tmp_path, monkeypatch, fail=True)
    assert sorted(runs) == sorted(_build.KERNELS), runs  # the waiter did not retry
    assert all("error" in r for r in rows), rows
    for r in rows:
        for name in _build.KERNELS:
            assert f"stub-nvcc: error in {name}" in r["error"], r["error"]
    assert not list(out.glob("*.so")), sorted(os.listdir(out))  # no library, no temp file
    assert len(list(out.glob("*.err"))) == len(_build.KERNELS)


def test_a_stale_failure_is_compiled_again(tmp_path, monkeypatch):
    """A ``.err`` older than the call is a build that no caller is waiting
    on: the next call compiles again, and a good compile clears it."""
    home = _stub_cuda_home(tmp_path, fail=False)
    out = tmp_path / "build"
    out.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "build_dir", lambda: out)
    monkeypatch.setattr(_build, "compiled", [])
    err = _build._lib_path("mlstm").with_suffix(".err")
    err.write_text("nvcc failed for mlstm (an old run)")
    old = err.stat().st_mtime - 10 * _build._ERR_FRESH_S
    os.utime(err, (old, old))
    times = _build.build_all(["mlstm"])
    assert _build.compiled == ["mlstm"] and times["mlstm"] > 0
    assert _build._lib_path("mlstm").exists() and not err.exists()
    assert _build.build_all(["mlstm"]) == {"mlstm": 0.0}  # built: no lock, no nvcc
    assert (tmp_path / "nvcc-runs.txt").read_text().split() == ["mlstm"]
