"""The reverse bridge and checkpoints the JAX package wrote, read by the
port, on the CPU.

- `bridge.params_to_jax` inverts `bridge.params_from_jax` leaf for leaf
  (bits, shapes, dtypes and JAX's tree structure) for every family in
  ``PORTED``, at reduced sizes, in fp32 and in bf16.
- The JAX package's ``train_elastic`` writes a run to a ``FileBackend``
  root; the port reads it (`checkpoint.load(..., cfg=, opt=)`, which never
  unpickles the manifest's ``treedef``) and continues it through its own
  ``train_elastic``.  The reduced llama3-8b is widened to d_model 256 so
  every per-layer leaf holds a multiple of 256 elements: then the loaded
  parameters and moments equal JAX's bit for bit (int8 blocks sliced), the
  next chunk's losses match JAX's within 1e-4 and the parameters at
  `test_torch_train.py::test_five_train_steps_match_jax`'s bars.  At
  d_model 128 the 128-wide norms' int8 moments are re-blocked (dequantised,
  each layer quantised afresh): each value within one int8 step of the new
  block, and the next loss still JAX's.
- A mismatched config fails naming the leaf; JAX cannot read the port's
  checkpoints (its ``load`` wants a pickled ``PyTreeDef``).
"""

import dataclasses
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.core import WrenExecutor as JWrenExecutor  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import synthetic_batch as j_synthetic_batch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.storage import FileBackend as JFileBackend  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import elastic as jel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.core import WrenExecutor  # noqa: E402
from repro_torch.storage import FileBackend, ObjectStore  # noqa: E402
from repro_torch.storage import serialization  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import elastic as tel  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.util import tree_flatten  # noqa: E402

torch.set_num_threads(1)

FAMILY_CASES = [  # (arch, n_layers): every family in PORTED, the hybrid with and without a tail
    ("llama3-8b", None), ("gemma2-27b", None), ("olmoe-1b-7b", None),
    ("deepseek-v3-671b", None), ("zamba2-1.2b", None), ("zamba2-1.2b", 5),
    ("xlstm-1.3b", 8), ("whisper-large-v3", None), ("internvl2-1b", None),
]
LR = 2e-3


def _cfgs(arch, **changes):
    return (dataclasses.replace(JCONFIGS[arch].reduced(), **changes),
            dataclasses.replace(TCONFIGS[arch].reduced(), **changes))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,n_layers", FAMILY_CASES)
def test_params_to_jax_inverts_params_from_jax(arch, n_layers, dtype):
    changes = {"param_dtype": dtype, **({"n_layers": n_layers} if n_layers else {})}
    jc, tc = _cfgs(arch, **changes)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jc, jax.random.PRNGKey(0)))
    arrays, dtypes = params_to_jax(params_from_jax(jp, tc), tc)
    back = jax.tree_util.tree_map(
        lambda a, n: a.view(ml_dtypes.bfloat16) if n == "bfloat16" else a, arrays, dtypes)
    jl, jdef = jax.tree_util.tree_flatten(jp)
    bl, bdef = jax.tree_util.tree_flatten(back)
    assert jdef == bdef
    assert any(a.dtype.name == dtype for a in jl)
    for a, b in zip(jl, bl):
        assert (a.dtype, a.shape) == (b.dtype, b.shape) and a.tobytes() == b.tobytes()
    assert all(a.dtype == np.uint16 for a, n in zip(jax.tree_util.tree_leaves(arrays),
                                                   jax.tree_util.tree_leaves(dtypes))
               if n == "bfloat16")


# ---------------------------------------------------------------------------
# a JAX run continued by the port
# ---------------------------------------------------------------------------

class _JaxBatches:
    """The JAX package's batches for each step, as CPU tensors (the port's
    synthetic batches draw from another generator)."""

    def __init__(self, jc, steps):
        dcfg = JDataConfig(seq_len=16, global_batch=2, vocab_size=jc.vocab_size)
        self.table = {s: {k: np.asarray(v) for k, v in j_synthetic_batch(dcfg, s, jc).items()}
                      for s in range(steps)}

    def __call__(self, step):
        return {k: torch.from_numpy(v.copy()) for k, v in self.table[step].items()}


def _jax_run(tmp_path, jc, quantize):
    """JAX trains 2 chunks of 2 steps into root ``a``; ``b`` is a copy of
    it; JAX then trains a third chunk in ``a``.  -> (losses, roots)."""
    jo = jopt.adamw(LR, quantize_moments=quantize)
    batches = _JaxBatches(jc, 6)
    jbatch = lambda s: {k: jax.numpy.asarray(v) for k, v in batches.table[s].items()}  # noqa: E731
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    wex = JWrenExecutor(store=JObjectStore(backend=JFileBackend(a, fsync="never")),
                        num_workers=1)
    try:
        hist = jel.train_elastic(wex, jc, jo, jel.ElasticTrainConfig(
            run="mig", steps_per_chunk=2, total_steps=4), jbatch)
        shutil.copytree(a, b)
        hist += jel.train_elastic(wex, jc, jo, jel.ElasticTrainConfig(
            run="mig", steps_per_chunk=2, total_steps=6), jbatch)
    finally:
        wex.shutdown()
        jel.WARM_CACHE.clear()
    return [h["loss"] for h in hist], a, b, batches


def _jax_state(root, version):
    state, _, _ = jck.load(JObjectStore(backend=JFileBackend(root)), "mig", version)
    return jax.tree_util.tree_map(np.asarray, state)


def _expected_moment(jleaf, shape, idx):
    """JAX's dequantised stacked moment, sliced at layer ``idx``."""
    full = np.asarray(jopt._q8_decode({k: np.asarray(v) for k, v in jleaf.items()}, shape))
    return torch.from_numpy(np.ascontiguousarray(full[idx]))


def _continue_in_port(root, tc, quantize, batches):
    to = topt.adamw(LR, quantize_moments=quantize)
    wex = WrenExecutor(store=ObjectStore(backend=FileBackend(root, fsync="never")),
                       num_workers=1)
    try:
        hist = tel.train_elastic(wex, tc, to, tel.ElasticTrainConfig(
            run="mig", steps_per_chunk=2, total_steps=6), batches, device="cpu")
    finally:
        wex.shutdown()
        tel.WARM_CACHE.clear()
    return [h["loss"] for h in hist], to


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32-moments", "int8-moments"])
def test_port_continues_a_jax_run_exactly_where_blocks_align(tmp_path, quantize):
    jc, tc = _cfgs("llama3-8b", d_model=256, n_layers=2)
    jlosses, a, b, batches = _jax_run(tmp_path, jc, quantize)
    to = topt.adamw(LR, quantize_moments=quantize)
    # the loaded version equals JAX's, bit for bit
    jparams, (jstep, jm, jv) = _jax_state(b, 2)
    (params, (step, m, v)), meta, version = ck.load(
        ObjectStore(backend=FileBackend(b)), "mig", cfg=tc, opt=to)
    assert version == 2 and meta["step"] == 4 and int(step.reshape(())) == int(jstep.reshape(())) == 4
    for x, y in zip(tree_flatten(params)[0], tree_flatten(params_from_jax(jparams, tc))[0]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    is_q8 = topt._is_q8
    for port_m, jax_m in ((m, jm), (v, jv)):
        if not quantize:  # fp32 moments have the parameters' structure
            for x, y in zip(tree_flatten(port_m)[0], tree_flatten(params_from_jax(jax_m, tc))[0]):
                assert torch.equal(x, y)
            continue
        # int8: each layer's blocks dequantise to JAX's stacked moment, sliced
        shapes = [a.shape for a in jax.tree_util.tree_leaves(jparams["decoder"])]
        jleaves = jax.tree_util.tree_leaves(jax_m["decoder"], is_leaf=is_q8)
        for li, layer in enumerate(port_m["decoder"]):
            for got, jleaf, shape in zip(tree_flatten(layer, is_leaf=is_q8)[0], jleaves, shapes):
                exp = _expected_moment(jleaf, shape, (li, 0))
                assert torch.equal(topt._q8_decode(got, shape[2:]), exp)
        for name in ("embed", "final_norm", "lm_head"):  # not stacked: JAX's blocks as they are
            for got, exp in zip(tree_flatten(port_m[name])[0], tree_flatten(jax_m[name])[0]):
                assert torch.equal(got, torch.from_numpy(np.array(exp)))
    # the next chunk: the port's losses are JAX's
    tlosses, _ = _continue_in_port(b, tc, quantize, batches)
    assert tlosses[0] == pytest.approx(jlosses[2], rel=1e-4, abs=1e-4)
    if not quantize:  # the parameters at the five-step test's bars
        exp = params_from_jax(_jax_state(a, 3)[0], tc)
        got, _, _ = ck.load(ObjectStore(backend=FileBackend(b)), "mig", 3)
        diffs = torch.cat([(x - y).abs().reshape(-1) for x, y in
                           zip(tree_flatten(got[0])[0], tree_flatten(exp)[0])])
        assert int((diffs > 1e-5).sum()) <= 1e-4 * diffs.numel()
        assert float(diffs.max()) <= 0.1 * LR
        for x, y in zip(tree_flatten(got[1][1])[0], tree_flatten(params_from_jax(
                _jax_state(a, 3)[1][1], tc))[0]):
            assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


def test_unaligned_int8_moments_are_reblocked(tmp_path):
    """d_model 128: a layer's 128-wide norm is half a block of JAX's
    stacked leaf, so the port quantises each layer's slice afresh."""
    jc, tc = _cfgs("llama3-8b", n_layers=2)
    jlosses, _, b, batches = _jax_run(tmp_path, jc, True)
    to = topt.adamw(LR, quantize_moments=True)
    jparams, (_, jm, jv) = _jax_state(b, 2)
    (_, (_, m, v)), _, _ = ck.load(ObjectStore(backend=FileBackend(b)), "mig", cfg=tc, opt=to)
    for port_m, jax_m in ((m, jm), (v, jv)):
        for name in ("ln1", "ln2"):
            shape = jparams["decoder"][name].shape
            assert shape == (2, 1, 128)
            for li, layer in enumerate(port_m["decoder"]):
                q8 = layer[name]
                assert q8["q"].shape == (1, 256) and q8["scale"].shape == (1, 1)
                exp = _expected_moment(jax_m["decoder"][name], shape, (li, 0))
                scale = float(q8["scale"])
                assert scale == pytest.approx(float(exp.abs().max()) / 127, rel=1e-6)
                got = topt._q8_decode(q8, (128,))
                assert float((got - exp).abs().max()) <= 0.5 * scale * (1 + 1e-5)
        # a leaf whose layers hold whole blocks is sliced, not re-blocked
        got = topt._q8_decode(port_m["decoder"][1]["attn"]["wq"], (128, 4, 32))
        exp = _expected_moment(jax_m["decoder"]["attn"]["wq"],
                               jparams["decoder"]["attn"]["wq"].shape, (1, 0))
        assert torch.equal(got, exp)
    tlosses, _ = _continue_in_port(b, tc, True, batches)
    assert tlosses[0] == pytest.approx(jlosses[2], rel=1e-4, abs=1e-4)


def test_mismatched_config_names_the_leaf_and_treedef_stays_pickled(tmp_path, monkeypatch):
    jc, tc = _cfgs("llama3-8b", n_layers=2)
    jo = jopt.adamw(LR, quantize_moments=True)
    from repro.train import train_step as jts

    state = jts.init_train_state(jc, jo, jax.random.PRNGKey(0))
    jck.save(JObjectStore(backend=JFileBackend(str(tmp_path))), "r", 0, tuple(state))
    store = ObjectStore(backend=FileBackend(str(tmp_path)))
    treedef = store.get(ck._manifest_key("r", 0))["treedef"]
    seen = []
    real_loads = serialization.pickle.loads
    monkeypatch.setattr(serialization.pickle, "loads",
                        lambda b, *a, **k: seen.append(bytes(b)) or real_loads(b, *a, **k))
    ck.load(store, "r", cfg=tc, opt=topt.adamw(LR, quantize_moments=True))
    assert seen and treedef not in seen and not any(treedef in s for s in seen[1:])
    with pytest.raises(ValueError, match="pass cfg= and opt="):
        ck.load(store, "r")
    wide = dataclasses.replace(tc, d_ff=512)
    with pytest.raises(ValueError, match=r"leaf \d+ \(params/decoder/mlp/w_down\) is "
                                         r"float32\[2, 1, 256, 128\]"):
        ck.load(store, "r", cfg=wide, opt=topt.adamw(LR, quantize_moments=True))
    with pytest.raises(ValueError, match=r"holds 61 leaves; .* has 37"):
        ck.load(store, "r", cfg=tc, opt=topt.adamw(LR))  # fp32 moments expected


def test_jax_cannot_read_the_ports_checkpoints(tmp_path):
    ck.save(ObjectStore(backend=FileBackend(str(tmp_path))), "p", 0, {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="treedef"):
        jck.load(JObjectStore(backend=JFileBackend(str(tmp_path))), "p", 0)
    man = pickle.loads(bytes(JObjectStore(backend=JFileBackend(str(tmp_path))).get_bytes(
        ck._manifest_key("p", 0)))[13:])
    assert "tree" in man and "treedef" not in man
