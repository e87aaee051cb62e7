"""The PyTorch port stands alone: nothing under src/repro_torch/, nor
chip_smoke.py, nor the port's tools (``PORT_TOOLS``) imports jax, the JAX package (`repro`) or cloudpickle (the
card's machine has none; the port's runtime ships callables with the
standard pickle), not even inside a function body, and importing the
port's entry points, its runtime, data pipeline, trainer and storage plane
(the file stores and the wire tier included) loads none of them, and
neither does the ``repro-kvd`` daemon's CLI serving a client (which
loads no torch either, with the runtime and the request plane)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "cloudpickle")
# the port's tools: its lint CLI, the cold-build race, the card's measurements
PORT_TOOLS = ("reprolint_torch", "cold_build", "kernel_breakdown", "prefill_groups",
              "cublas_workspace_ab")
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + [ROOT / "tools" / f"{name}.py" for name in PORT_TOOLS])


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_entry_points_load_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.launch.serve, repro_torch.kernels.ops\n"
        "import repro_torch.launch.train, repro_torch.train, repro_torch.core, repro_torch.data\n"
        "import repro_torch.storage, repro_torch.storage.file_kv, repro_torch.storage.inotify\n"
        "import repro_torch.storage.net_kv, repro_torch.storage.net_server\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.sanitizer\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
        "import repro_torch.analysis.roofline, repro_torch.analysis.report\n"
        "repro_torch.analysis.sanitizer.install()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_daemons_cli_serving_a_client_loads_neither(tmp_path):
    sock = str(tmp_path / "kvd.sock")
    code = (
        "import os, sys, threading, time\n"
        "from repro_torch.storage import NetKVStore, net_server\n"
        f"args = ['--root', {str(tmp_path / 'kvd')!r}, '--uds', {sock!r}, '--fsync', 'never']\n"
        "threading.Thread(target=net_server.main, args=(args,), daemon=True).start()\n"
        "deadline = time.monotonic() + 30\n"
        f"while not os.path.exists({sock!r}) and time.monotonic() < deadline:\n"
        "    time.sleep(0.01)\n"
        f"kv = NetKVStore('unix:' + {sock!r})\n"
        "kv.set('k', [1]); assert kv.get('k') == [1]\n"
        "import repro_torch.core, repro_torch.serve.request_plane\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad, 'torch' in sys.modules)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LISTENING unix:" in proc.stdout
    # nor torch: the daemon, the runtime and the request plane start without
    # it (a restarted daemon is serving in a fraction of a second)
    assert proc.stdout.strip().endswith("[] False"), proc.stdout
