"""The port's dry-run (`repro_torch.launch.dryrun`) held to oracles that run
on the CPU.

Memory: for every config x applicable shape x both production meshes, the
dry-run's per-device argument bytes equal the sum of shard bytes that the
JAX package's own ``state_pspec``, ``cache_pspec`` and ``batch_pspec`` give
on ``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees (no
compile).  JAX pads a dim its spec does not divide, the port replicates
it; each such leaf is listed by name and the list asserted.

FLOPs: on a reduced dense config the counted train, prefill and decode
FLOPs equal a closed form: 2 M N K per projection and per head, attention's
two products as the plain version computes them (dense, every key), and
for the train step the forward, the backward at twice the forward, and
remat's recompute of the layers, which stops (torch's non-reentrant
checkpoint) before each layer's last product.

The CLI: one cell of ``python -m repro_torch.launch.dryrun`` in a
subprocess, after which no process group is initialized and no module of
``torch.testing._internal`` is loaded beyond those torch's own imports
load (``import torch`` and ``FakeTensorMode()`` in a bare process): the
collective count's process group and DTensor run in a child per mesh.
The port's sources name no ``torch.testing`` module.  The cell's
collective term is in its bound.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxMesh

from repro.configs import CONFIGS as JCONFIGS
from repro.launch import shardings as jshard
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.train import adamw as jadamw
from repro.train.train_step import TrainState as JTrainState
from repro_torch.configs import CONFIGS, SHAPES, applicable_shapes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_production_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SRC_ROOT = Path(SRC)
CELLS = [(arch, s.name) for arch, cfg in CONFIGS.items() for s in applicable_shapes(cfg)]
# leaves whose dim a production mesh does not divide: JAX pads them, the
# port replicates them (none: every rule falls back to replication where a
# dim is not divisible, on both sides)
RAGGED: list = []


def _local_bytes(shape, itemsize, spec, mesh_shape):
    """JAX's per-device bytes of one leaf: each split dim padded up."""
    n = 1
    ragged = False
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, e in zip(shape, entries):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        k = math.prod(mesh_shape[a] for a in axes)
        n *= -(-d // k)
        ragged = ragged or d % k != 0
    return n * itemsize, ragged


def _jax_tree_bytes(tree, specs, mesh_shape, name):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves), name
    total, ragged = 0, []
    for (path, x), spec in zip(leaves, spec_leaves):
        b, r = _local_bytes(x.shape, jnp.dtype(x.dtype).itemsize, spec, mesh_shape)
        total += b
        if r:
            ragged.append(f"{name}{jax.tree_util.keystr(path)}")
    return total, ragged


@functools.lru_cache(maxsize=None)
def _jax_trees(arch, shape_name):
    """(state or params, cache, batch) of JAX's dry-run for one cell, as
    ``jax.eval_shape`` trees (JAX's ``input_specs``, ``_state_structs``,
    ``_param_structs`` and ``_cache_structs``)."""
    shape = SHAPES[shape_name]
    jcfg = dryrun.shape_adjusted_config(JCONFIGS[arch], shape)
    B, S = shape.global_batch, shape.seq_len
    key = jax.random.PRNGKey(0)
    kind = "decode" if shape.kind == "long_decode" else shape.kind
    with torch.device("meta"):
        batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), {torch.int32: jnp.int32,
                                                          torch.bfloat16: jnp.bfloat16}[v.dtype])
                 for k, v in dryrun.input_batch(jcfg, kind, B, S).items()}
    if kind == "train":
        opt = jadamw(1e-4, moment_dtype=jnp.bfloat16)

        def make():
            params = jinit_params(jcfg, key)
            return JTrainState(params=params, opt_state=opt.init(params))

        return jcfg, kind, jax.eval_shape(make), None, batch
    params = jax.eval_shape(lambda: jinit_params(jcfg, key))

    def make_cache():
        c = jinit_cache(jcfg, B, S, cache_dtype=jnp.bfloat16)
        if kind == "decode" and jcfg.family == "encdec":
            K, hd = jcfg.n_kv_heads, jcfg.hd
            cross = {"k": jnp.zeros((jcfg.n_layers, B, jcfg.encoder_seq, K, hd), jnp.bfloat16),
                     "v": jnp.zeros((jcfg.n_layers, B, jcfg.encoder_seq, K, hd), jnp.bfloat16)}
            c["decoder"] = {"self": c["decoder"]["self"], "cross": cross}
        return c

    return jcfg, kind, params, jax.eval_shape(make_cache), batch


def jax_argument_bytes(arch, shape_name, multi_pod):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    jm, ms = JaxMesh(shape, names), dict(zip(names, shape))
    jcfg, kind, main, cache, batch = _jax_trees(arch, shape_name)
    total, ragged = _jax_tree_bytes(batch, jshard.batch_pspec(jm, batch), ms, "batch")
    b, r = _jax_tree_bytes(main, jshard.state_pspec(jm, main), ms, "state")
    total, ragged = total + b, ragged + r
    if cache is not None:
        b, r = _jax_tree_bytes(cache, jshard.cache_pspec(jm, jcfg, cache), ms, "cache")
        total, ragged = total + b, ragged + r
    if kind == "decode":
        total += 4  # the int32 cache_len scalar
    return total, ragged


@pytest.mark.parametrize("arch,shape_name", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_argument_bytes_match_jax_specs(arch, shape_name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = SHAPES[shape_name]
    cfg = dryrun.shape_adjusted_config(CONFIGS[arch], shape)
    kind = "decode" if shape.kind == "long_decode" else shape.kind
    with FakeTensorMode():
        args = dryrun.cell_args(cfg, kind, shape.global_batch, shape.seq_len)
        for multi_pod in (False, True):
            mesh = abstract_production_mesh(multi_pod)
            got, donated = dryrun.argument_bytes(mesh, cfg, kind, args)
            want, ragged = jax_argument_bytes(arch, shape_name, multi_pod)
            assert ragged == RAGGED, (arch, shape_name, multi_pod, ragged)
            assert got == want, (arch, shape_name, dryrun.mesh_name(mesh), got, want)
            assert 0 < donated < got


_BSHD, _BSGD = ("b", None, "h", None), ("b", None, "g", None)
_SPLITS = [
    # (q, k shapes; the lead's split; axis sizes) -> (split kept, whole groups)
    (((4, 8, 8, 16), (4, 8, 4, 16)), {"data": "b", "model": "h"}, {"data": 2, "model": 4},
     ({"data": "b", "model": "h"}, False)),
    (((4, 8, 8, 16), (3, 8, 4, 16)), {"data": "b"}, {"data": 2},  # k's batch 3: not split
     ({}, False)),
    (((4, 8, 8, 16), (4, 8, 2, 16)), {"model": "h"}, {"model": 4},  # tp above 2 KV heads
     ({"model": "h"}, True)),
    (((4, 8, 6, 16), (4, 8, 2, 16)), {"model": "h"}, {"model": 4},  # 6 heads over 4: not
     ({}, False)),
    # 12 heads over 6: a rank's 2 heads straddle KV groups of 3
    (((4, 8, 12, 16), (4, 8, 4, 16)), {"model": "h"}, {"model": 6},
     ({}, False)),
]


@pytest.mark.parametrize("shapes,lead,sizes,want", _SPLITS)
def test_local_split(shapes, lead, sizes, want):
    """`ops.local_split`, which `_local_launch` calls on DTensor
    placements: the lead's batch and head splits are kept where every
    input divides them, and grouped heads split with the heads or stay
    whole per rank."""
    from repro_torch.kernels import ops

    assert ops.local_split(list(shapes), [_BSHD, _BSGD], lead, sizes) == want


def test_abstract_production_mesh_matches_jax():
    # src/repro/launch/mesh.py:12-15
    single, multi = abstract_production_mesh(), abstract_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert dryrun.mesh_name(single) == "16x16" and dryrun.mesh_name(multi) == "2x16x16"


def _dense_cfg():
    base = CONFIGS["llama3-8b"].reduced()
    return dataclasses.replace(base, d_model=64, n_heads=4, head_dim=16, n_kv_heads=2,
                               n_layers=2, vocab_size=256, d_ff=128)


def _closed_form(cfg, kind, B, S):
    D, H, K, hd, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                            cfg.vocab_size, cfg.n_layers)
    Sq, Sk = (1, S) if kind == "decode" else (S, S)
    T = B * Sq
    proj = 2 * T * D * H * hd + 2 * (2 * T * D * K * hd) + 2 * T * H * hd * D
    mlp = 3 * (2 * T * D * F)
    attn = 2 * (2 * B * H * Sq * Sk * hd)  # logits and probabilities x values
    layers = L * (proj + mlp + attn)
    head_rows = T if kind == "train" else B  # prefill and decode: the last token
    head = 2 * head_rows * D * V
    if kind == "train":
        # forward, backward at twice the forward, and remat's recompute of
        # each layer, which stops at the last tensor the backward needs
        # (torch's non-reentrant checkpoint stops early): the layer's last
        # product, w_down, is not run again
        return 3 * (layers + head) + layers - L * 2 * T * F * D
    return layers + head


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_counted_flops_match_the_closed_form(kind):
    cfg = _dense_cfg()
    assert not cfg.tie_embeddings and cfg.family == "dense"
    B, S = 2, 16
    got = dryrun.count_program(cfg, kind, B, S, [abstract_production_mesh()], fused_ce=False)
    assert got.flops == _closed_form(cfg, kind, B, S), (got.flops, _closed_form(cfg, kind, B, S))
    assert got.bytes > 0 and got.ops > 0


def test_remat_adds_one_forward_of_the_layers():
    cfg, B, S = _dense_cfg(), 2, 16
    on = dryrun.count_program(cfg, "train", B, S, [], fused_ce=False).flops
    off = dryrun.count_program(cfg, "train", B, S, [], fused_ce=False, remat=False).flops
    T, D, F = B * S, cfg.d_model, cfg.d_ff
    layers = _closed_form(cfg, "prefill", B, S) - 2 * B * D * cfg.vocab_size
    assert on - off == layers - cfg.n_layers * 2 * T * F * D


def test_cli_cell_uses_no_process_group(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun\n"
        f"sys.argv = ['dryrun', '--arch', 'internvl2-1b', '--shape', 'decode_32k', "
        f"'--report-dir', {str(tmp_path)!r}]\n"
        "rc = dryrun.main()\n"
        "import torch.distributed as dist\n"
        "print('PG', dist.is_available() and dist.is_initialized())\n"
        "print('INTERNAL', sorted(m for m in sys.modules "
        "if m.startswith('torch.testing._internal')))\n"
        "sys.exit(rc)\n"
    )
    # torch itself loads a few of its torch.testing._internal modules:
    # ``import torch`` (2.13) two, and ``FakeTensorMode()`` through
    # torch._dynamo and torch.distributed.fsdp the fake process group's
    # module; a bare process that does just that is the baseline
    bare = ("import sys, torch\n"
            "from torch._subclasses.fake_tensor import FakeTensorMode\n"
            "FakeTensorMode()\n"
            "print('INTERNAL', sorted(m for m in sys.modules "
            "if m.startswith('torch.testing._internal')))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    base = subprocess.run([sys.executable, "-c", bare], env=env, capture_output=True,
                          text=True, timeout=120)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PG False" in out.stdout, out.stdout[-2000:]
    internal = [line for line in out.stdout.splitlines() if line.startswith("INTERNAL")]
    assert internal and internal[0] in base.stdout, (internal, base.stdout)
    # and the port names no torch.testing module anywhere
    for path in sorted((SRC_ROOT / "repro_torch").rglob("*.py")):
        assert "torch.testing" not in path.read_text(), path
    assert "[internvl2-1b x decode_32k x 16x16]" in out.stdout
    cell = json.loads((tmp_path / "internvl2-1b__decode_32k__16x16.json").read_text())
    for key in ("compile_s", "probe_s", "total_params", "active_params", "tokens_per_step",
                "memory_stats", "collective_by_op", "collective_counts", "roofline_fraction",
                "step_bound_s", "link", "flops_counted", "bytes_counted",
                "collectives_counted"):
        assert key in cell, key
    assert "collective_in_bound" not in cell
    # the collective term is in the bound and can decide it
    assert cell["collective_s"] > 0
    terms = {k: cell[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert cell["step_bound_s"] == max(terms.values())
    assert cell["dominant"] == max(terms, key=terms.get)
    assert cell["probe_s"] == 0.0 and cell["memory_stats"]["temp_bytes"] == -1
    assert cell["n_devices"] == 256 and cell["link"] == "network"
    assert cell["hlo_flops_per_device"] > 0 and cell["collective_bytes_per_device"] > 0


@pytest.mark.parametrize("lever", [("REPRO_AXIS_MAP", "fsdp_all"), ("REPRO_SEQ_PARALLEL", "1")],
                         ids=["axis=fsdp_all", "sp=1"])
def test_hillclimb_lever_moves_the_collective_term(lever, monkeypatch):
    """A hillclimb lever reaches the collective count's child through the
    environment and changes DTensor's program: pure ZeRO-3 over both mesh
    dims, or the residual stream sharded over the sequence."""
    from repro_torch.models.sharding import AbstractMesh

    cfg, mesh = _dense_cfg(), AbstractMesh((2, 2), ("data", "model"))
    monkeypatch.delenv("REPRO_AXIS_MAP", raising=False)
    monkeypatch.delenv("REPRO_SEQ_PARALLEL", raising=False)
    base = dryrun.count_collectives(cfg, "train", 4, 16, mesh, fused_ce=False, timeout=300)
    monkeypatch.setenv(*lever)
    moved = dryrun.count_collectives(cfg, "train", 4, 16, mesh, fused_ce=False, timeout=300)
    assert base.time_s > 0 and moved.time_s > 0
    assert (moved.counts, moved.wire_bytes) != (base.counts, base.wire_bytes)
    assert moved.time_s != base.time_s
