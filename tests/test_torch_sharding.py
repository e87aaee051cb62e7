"""The port's sharding rules against the JAX package's, in one process.

JAX's rules run on ``jax.sharding.AbstractMesh`` over ``jax.eval_shape``
trees, the port's on `repro_torch.models.sharding.AbstractMesh` over
meta-device trees (nothing allocated on either side), for every config in
the registry, reduced and at full size: parameters, caches (batches the
data axes divide and batch 1, the long-decode branches), fp32 and int8
train states, and batches, on meshes (2, 4), (4, 2), (2, 2, 2), (16, 16)
and (2, 16, 16) under both ``REPRO_AXIS_MAP`` values.  The port keeps
per-layer lists where JAX stacks layers on leading axes: each port spec is
compared with the trailing dims of JAX's leaf (whose stacking dims must be
unsharded), parameters after `bridge._to_jax_layout`, cache leaves by their
JAX path.  Equality is exact.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxMesh
from jax.sharding import PartitionSpec

from repro.configs import CONFIGS as JCONFIGS
from repro.launch import shardings as jshard
from repro.models import attention as jattn
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import sharding as jsh
from repro.train import adamw as jadamw
from repro.train.train_step import TrainState as JTrainState
from repro_torch.bridge import _to_jax_layout
from repro_torch.configs import CONFIGS
from repro_torch.launch import shardings as tshard
from repro_torch.models import attention as tattn
from repro_torch.models import init_cache, init_params
from repro_torch.models import sharding as tsh
from repro_torch.train import TrainState, adamw
from repro_torch.util import tree_flatten, tree_map_with_path, tree_unflatten

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
ARCHS = sorted(CONFIGS)
SIZES = ["reduced", "full"]


def _cfgs(arch, size):
    if size == "reduced":
        return JCONFIGS[arch].reduced(), CONFIGS[arch].reduced()
    return JCONFIGS[arch], CONFIGS[arch]


def _meshes(name):
    shape, names = MESHES[name]
    return JaxMesh(shape, names), tsh.AbstractMesh(shape, names)


@pytest.fixture(params=["tp_model", "fsdp_all"])
def axis_map(request, monkeypatch):
    monkeypatch.setenv("REPRO_AXIS_MAP", request.param)
    return request.param


@functools.lru_cache(maxsize=None)
def _jax_params(arch, size):
    jcfg, _ = _cfgs(arch, size)
    return jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch, size):
    _, cfg = _cfgs(arch, size)
    return init_params(cfg, torch.Generator().manual_seed(0), "meta")


class _Spec:
    """A port spec as one opaque leaf, so `_to_jax_layout` stacks specs."""

    def __init__(self, spec) -> None:
        self.spec = spec


def _stack_same(specs):
    assert all(s.spec == specs[0].spec for s in specs), [s.spec for s in specs]
    return specs[0]


def _jax_layout(spec_tree, cfg):
    """The port's per-layer spec tree in JAX's stacked layout (every layer
    of a stack must have one spec), as a flat list in JAX's leaf order."""
    leaves, struct = tree_flatten(spec_tree, is_leaf=lambda x: isinstance(x, tsh.P))
    wrapped = tree_unflatten(struct, [_Spec(s) for s in leaves])
    return [w.spec for w in tree_flatten(_to_jax_layout(wrapped, cfg, _stack_same))[0]]


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def norm(spec, ndim=None) -> tuple:
    """A spec as a tuple of axis-name tuples, one per dim (JAX's
    ``PartitionSpec`` writes a one-axis tuple ``('data',)`` as ``'data'``,
    and may leave trailing unsharded dims out)."""
    out = tuple(() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)
    return out + ((),) * ((ndim or len(out)) - len(out))


def assert_trailing(jax_specs, jax_shapes, port_specs, what):
    """Each port spec equals the trailing dims of JAX's, whose leading
    (stacking) dims are unsharded."""
    assert len(jax_specs) == len(port_specs), (what, len(jax_specs), len(port_specs))
    for i, (js, shape, ts) in enumerate(zip(jax_specs, jax_shapes, port_specs)):
        js, ts = norm(js, len(shape)), norm(ts)
        lead = len(js) - len(ts)
        assert lead >= 0 and not any(js[:lead]), (what, i, js, ts)
        assert js[lead:] == ts, (what, i, shape, js, ts)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_jax(arch, size, mesh, axis_map):
    jm, tm = _meshes(mesh)
    _, cfg = _cfgs(arch, size)
    jshapes = _jax_params(arch, size)
    jspecs = _jax_leaves(jsh.param_pspec(jm, jshapes))
    tspecs = _jax_layout(tsh.param_pspec(tm, _port_params(arch, size)), cfg)
    assert_trailing(jspecs, [x.shape for x in jax.tree_util.tree_leaves(jshapes)], tspecs,
                    f"{arch} {size} {mesh}")


@functools.lru_cache(maxsize=None)
def _states(arch, quantize):
    """(JAX's train state shapes, the port's meta-device train state)."""
    jcfg, _ = _cfgs(arch, "reduced")
    jopt = jadamw(1e-4, quantize_moments=quantize)

    def make():
        p = jinit_params(jcfg, jax.random.PRNGKey(0))
        return JTrainState(params=p, opt_state=jopt.init(p))

    params = _port_params(arch, "reduced")
    return jax.eval_shape(make), TrainState(params, adamw(1e-4, quantize_moments=quantize)
                                            .init(params))


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_pspec_matches_jax(arch, mesh, quantize, axis_map):
    """TrainState(params, AdamWState(step, m, v)): the moments follow the
    parameters' rules; int8 moment leaves (``q``, ``scale``) match no rule
    and stay replicated, in JAX's stacked blocks and the port's per-layer
    ones alike."""
    jm, tm = _meshes(mesh)
    _, cfg = _cfgs(arch, "reduced")
    jstate, state = _states(arch, quantize)
    jspecs = _jax_leaves(jshard.state_pspec(jm, jstate))
    jshapes = [x.shape for x in jax.tree_util.tree_leaves(jstate)]
    spec = tshard.state_pspec(tm, state)
    assert isinstance(spec, TrainState)
    n_p = len(jax.tree_util.tree_leaves(jstate.params))
    assert_trailing(jspecs[: n_p + 1], jshapes[: n_p + 1],
                    _jax_layout(spec.params, cfg) + [spec.opt_state.step], arch)
    if quantize:
        moments = [s for tree in (spec.opt_state.m, spec.opt_state.v)
                   for s in tree_flatten(tree, is_leaf=lambda x: isinstance(x, tsh.P))[0]]
        assert not any(any(norm(s)) for s in jspecs[n_p + 1:])
        assert moments and not any(any(norm(s)) for s in moments)
    else:
        tspecs = _jax_layout(spec.opt_state.m, cfg) + _jax_layout(spec.opt_state.v, cfg)
        assert_trailing(jspecs[n_p + 1:], jshapes[n_p + 1:], tspecs, arch)


def _cache_by_path(spec_tree, shape_tree):
    """{JAX path: (spec, shape)} of a JAX cache spec tree."""
    specs = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    shapes = jax.tree_util.tree_leaves(shape_tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): (spec, shape)
            for (path, spec), shape in zip(specs, shapes)}


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, size, B, S):
    jcfg, _ = _cfgs(arch, size)
    return jax.eval_shape(lambda: jinit_cache(jcfg, B, S, cache_dtype=jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _port_cache(arch, size, B, S):
    return init_cache(_cfgs(arch, size)[1], B, S, torch.bfloat16, "meta")


@pytest.mark.parametrize("batch", ["divisible", "tiny"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_matches_jax(arch, size, mesh, batch, axis_map):
    jm, tm = _meshes(mesh)
    jcfg, cfg = _cfgs(arch, size)
    dp = tsh.axis_size(tm, tsh.physical_axes(tm, tsh.DP))
    B, S = (2 * dp if batch == "divisible" else 1), 64 if size == "reduced" else 4096
    jshapes = _jax_cache(arch, size, B, S)
    by_path = _cache_by_path(jshard.cache_pspec(jm, jcfg, jshapes), jshapes)
    seen = set()

    def check(path, spec):
        key = tsh.path_str(path)
        js, shape = by_path[key]
        assert_trailing([js], [shape.shape], [spec], f"{arch} {key}")
        seen.add(key)

    tree_map_with_path(check, tshard.cache_pspec(tm, cfg, _port_cache(arch, size, B, S)),
                       is_leaf=lambda x: isinstance(x, tsh.P))
    assert seen == set(by_path), (sorted(seen), sorted(by_path))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_pspec_matches_jax(mesh, axis_map):
    jm, tm = _meshes(mesh)
    for B in (512, 8, 3):
        shapes = {"tokens": (B, 16), "labels": (B, 16), "prefix_embed": (B, 4, 32),
                  "audio_frames": (B, 16, 32)}
        jspec = jshard.batch_pspec(jm, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                        for k, s in shapes.items()})
        tspec = tshard.batch_pspec(tm, {k: torch.empty(s, device="meta")
                                        for k, s in shapes.items()})
        for k in shapes:
            assert norm(jspec[k], len(shapes[k])) == norm(tspec[k]), (k, B, jspec[k], tspec[k])


@pytest.mark.parametrize("seq_parallel", ["0", "1"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match_jax(mesh, seq_parallel, axis_map, monkeypatch):
    """The residual stream's constraint (``REPRO_SEQ_PARALLEL`` on and off)
    and the KV cache's logical spec, as each package's model code asks for
    them under the mesh (``shard`` recorded on both sides)."""
    monkeypatch.setenv("REPRO_SEQ_PARALLEL", seq_parallel)
    jm, tm = _meshes(mesh)
    asked = {"jax": [], "torch": []}
    monkeypatch.setattr(jsh, "current_mesh", lambda: jm)
    monkeypatch.setattr(jattn, "current_mesh", lambda: jm)
    monkeypatch.setattr(jsh, "shard", lambda x, *l: asked["jax"].append(jsh.make_pspec(jm, *l)))
    monkeypatch.setattr(tsh, "shard", lambda x, *l: asked["torch"].append(tsh.make_pspec(tm, *l)))
    with tsh.use_mesh(tm):
        for S in (256, 64, 3):
            jsh.residual_shard(jax.ShapeDtypeStruct((8, S, 32), jnp.float32))
            tsh.residual_shard(torch.empty((8, S, 32), device="meta"))
        assert asked["jax"] and [norm(s) for s in asked["jax"]] == [
            norm(s) for s in asked["torch"]], asked
        for arch in ("llama3-8b", "qwen3-32b", "gemma2-27b"):
            for B in (512, 8, 1):
                for tp in (2, 4, 16):
                    js = jattn.cache_logical_spec(JCONFIGS[arch], tp, B)
                    assert js == tattn.cache_logical_spec(CONFIGS[arch], tp, B), (arch, B, tp)


def test_param_pspec_rules():
    """The twin of the JAX package's ``test_param_pspec_rules``."""
    tm = tsh.AbstractMesh((2, 4), ("data", "model"))
    cfg = CONFIGS["llama3-8b"].reduced()
    specs = tsh.param_pspec(tm, init_params(cfg, torch.Generator().manual_seed(0), "meta"))
    # embeddings vocab-sharded over model (512 % 4 == 0)
    assert specs["embed"]["tok"] == tsh.P("model", ("data",)), specs["embed"]["tok"]
    # a per-layer wq (D, H, hd): the rule's trailing dims, as JAX's stacked ones
    wq = specs["decoder"][0]["attn"]["wq"]
    assert tuple(wq) == (("data",), "model", None), wq


def test_placements_follow_the_mesh_order():
    """A spec entry naming two mesh axes shards its tensor dim on both, in
    mesh order (JAX's pod-major ``P(("pod", "data"))``); out of order it
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    tm = tsh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert tsh.placements(tm, tsh.P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert tsh.placements(tm, tsh.P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements(tm, tsh.P(("data", "pod")))


def test_no_mesh_leaves_tensors_alone():
    """With no mesh ambient, ``shard`` and ``residual_shard`` return their
    input object itself."""
    assert tsh.current_mesh() is None
    x = torch.zeros(2, 3, 4)
    assert tsh.shard(x, tsh.DP, None, tsh.TP) is x
    assert tsh.residual_shard(x) is x


def test_importing_the_models_loads_no_dtensor():
    """``import repro_torch.models`` (and a forward with no mesh) leaves
    ``torch.distributed.tensor`` unloaded."""
    code = (
        "import sys, torch\n"
        "import repro_torch.models as m\n"
        "from repro_torch.configs import CONFIGS\n"
        "cfg = CONFIGS['llama3-8b'].reduced()\n"
        "p = m.init_params(cfg, device='cpu')\n"
        "m.forward(p, cfg, {'tokens': torch.zeros(1, 4, dtype=torch.long)})\n"
        "assert 'torch.distributed.tensor' not in sys.modules, 'loaded'\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_make_mesh_defaults_to_the_card():
    """``make_mesh`` with no ``device`` asks for ``cuda`` (NCCL), which
    raises where there is no GPU; there is no fallback."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    for build in (lambda: make_mesh(2, 2), lambda: make_production_mesh()):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
