"""The example twins of `examples_torch/` run on the CPU at a small size,
each held to what its JAX example holds or gives.

* quickstart: the port's results equal the JAX example's function mapped
  on the JAX runtime over the same grids.
* elastic_remesh: 8 gloo ranks train on a (4, 2) mesh, checkpoint, and
  reload onto (2, 4); the losses carry on across the remesh, and the
  first losses equal the JAX example's step on the same weights
  (`bridge.params_from_jax`) and batches (JAX's ``synthetic_batch``).
* serve_llm: two engine processes over shared roots, one SIGKILLed with
  requests outstanding; every request is published once.
* train_lm: the elastic trainer's loss falls, and after a worker kill it
  resumes from the checkpoint.
* every twin's module docstring passes `tools/doctest_examples.py`, and
  `examples/` and `examples_torch/` hold the same file names.

The six runtime twins (terasort, featurize_reduce, hogwild_ps,
multi_driver, driver_failover, net_cluster) are held to their JAX examples
in `tests/test_torch_examples_runtime.py`.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
TWINS = ("elastic_remesh", "train_lm", "serve_llm", "quickstart", "terasort",
         "featurize_reduce", "hogwild_ps", "multi_driver", "driver_failover", "net_cluster")
# the doctest examples of each twin's header, as in its JAX example's
# (quickstart's has one more: the partial that stands in for JAX's lambda)
DOCTESTS = {"quickstart": 3, "serve_llm": 10, "terasort": 5, "multi_driver": 8,
            "driver_failover": 7, "net_cluster": 17}


def _load(folder, name):
    """The example module ``folder/name.py``, registered under a name of
    its own (its functions are pickled by reference)."""
    mod_name = f"{folder}_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_every_twin_exists_beside_its_jax_example():
    names = lambda folder: sorted(  # noqa: E731
        f[:-3] for f in os.listdir(os.path.join(ROOT, folder)) if f.endswith(".py"))
    assert names("examples") == names("examples_torch") == sorted(TWINS)
    for name in TWINS:
        assert os.path.exists(os.path.join(ROOT, "examples", f"{name}.py")), name
        src = open(os.path.join(ROOT, "examples_torch", f"{name}.py")).read()
        assert "import jax" not in src and "from repro." not in src and "import repro\n" not in src


def test_doctest_headers():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    paths = sorted(glob.glob(os.path.join(ROOT, "examples_torch", "*.py")))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "doctest_examples.py")]
                         + paths, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 failures" in out.stdout
    for name, n in DOCTESTS.items():
        assert f"{name}.py: {n} examples, 0 failures" in out.stdout, name
    assert f"{sum(DOCTESTS.values())} examples, 0 failures" in out.stdout


def test_quickstart_equals_the_jax_example():
    from repro.core import WrenExecutor as JWrenExecutor

    twin, jax_example = _load("examples_torch", "quickstart"), _load("examples", "quickstart")
    got = twin.main()
    with JWrenExecutor(num_workers=4) as wex:
        want = {"grid": wex.map_get(jax_example.my_function, twin.GRID),
                "more": wex.map_get(jax_example.my_function, twin.MORE)}
    assert got == want


def _jax_remesh_inputs(twin, path, steps):
    """The JAX example's weights and batches (its config, ``PRNGKey(0)``,
    its ``synthetic_batch``) in the port's layout, and the losses of its
    first ``steps`` steps (one device: a mesh changes the layout, not the
    values)."""
    import jax

    from repro.configs import CONFIGS as JCONFIGS
    from repro.data import DataConfig as JDataConfig
    from repro.data import synthetic_batch as jbatch
    from repro.train import adamw as jadamw
    from repro.train import init_train_state as jinit
    from repro.train import make_train_step as jstep
    from repro_torch.bridge import params_from_jax

    cfg, _, dcfg = twin.config()
    jcfg = dataclasses.replace(
        JCONFIGS["llama3-8b"].reduced(), n_layers=2, d_model=128, d_ff=256,
        n_heads=4, n_kv_heads=4, head_dim=32, vocab_size=512,
    )
    jdcfg = JDataConfig(seq_len=dcfg.seq_len, global_batch=dcfg.global_batch,
                        vocab_size=dcfg.vocab_size)
    jopt = jadamw(3e-3, weight_decay=0.0)
    state = jinit(jcfg, jopt, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params), cfg)
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in jbatch(jdcfg, i, jcfg).items()}
               for i in range(2 * twin.STEPS)]
    step = jax.jit(jstep(jcfg, jopt))
    losses = []
    for i in range(steps):
        state, m = step(state, jbatch(jdcfg, i, jcfg))
        losses.append(float(m["loss"]))
    torch.save({"params": params, "batches": batches}, path)
    return losses


def test_elastic_remesh_carries_on_from_the_jax_examples_weights(tmp_path):
    twin = _load("examples_torch", "elastic_remesh")
    want = _jax_remesh_inputs(twin, tmp_path / "inputs.pt", steps=3)
    got = twin.main(["--device", "cpu", "--inputs", str(tmp_path / "inputs.pt"),
                     "--timeout", "240"])
    assert len(got["losses_a"]) == len(got["losses_b"]) == twin.STEPS
    np.testing.assert_allclose(got["losses_a"][:3], want, rtol=0, atol=1e-4)
    assert got["losses_b"][0] < got["losses_a"][0]
    assert got["losses_b"][-1] < got["losses_b"][0]


def test_serve_llm_publishes_every_request_once():
    twin = _load("examples_torch", "serve_llm")
    got = twin.main(["--device", "cpu"])
    ids = [f"req-{i:03d}" for i in range(twin.N_REQ)]
    assert sorted(got["results"]) == ids
    assert sum(got["served"].values()) == twin.N_REQ
    assert all(got["results"][r]["tokens"] for r in ids)
    assert got["tokens"] > 0 and got["seconds"] > 0
    # A died holding work, and B served what it left
    assert got["outstanding_at_kill"] > 0 and got["served"].get("engine-B", 0) > 0


def test_train_lm_loss_falls_and_resumes_after_a_kill():
    twin = _load("examples_torch", "train_lm")
    got = twin.main(["--device", "cpu", "--reduced", "--steps", "20", "--seq", "32",
                     "--batch", "4"])
    assert len(got["hist"]) == 2 and got["hist"][-1]["loss"] < got["hist"][0]["loss"]
    assert len(got["more"]) == 3 and got["version"] == 5
    assert all(np.isfinite(h["loss"]) for h in got["more"])
    assert got["tok_s"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
@pytest.mark.parametrize("name", ("elastic_remesh", "train_lm", "serve_llm"))
def test_twin_refuses_a_missing_gpu(name):
    """With no ``--device`` a twin runs on the GPU; on a machine with none
    it raises, and never falls back to the CPU."""
    twin = _load("examples_torch", name)
    with pytest.raises((RuntimeError, AssertionError)):
        twin.main(["--timeout", "120"] if name == "elastic_remesh" else [])
