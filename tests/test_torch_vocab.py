"""Token ids outside the vocabulary, and the sLSTM scan, against the JAX
package on the CPU.

* The port's lookup gives ``jnp.take``'s rows: ids in ``[-V, 0)`` wrap,
  any id outside ``[-V, V)`` gives a NaN row (JAX's default fill mode).
* The port's `ContinuousEngine` serves prompts holding such ids as the JAX
  engine does (a NaN row's greedy token is 0), and lives on to serve the
  next request; at temperature > 0 a NaN row gives 0 too, and the other
  rows keep their seeded draws.
* ``ops.slstm_scan`` equals JAX's, with and without a carry, and the xLSTM
  block's ``ops.slstm_recurrence`` equals it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import request_plane as jrp
from repro.storage import KVStore as JKVStore
from repro.storage import ObjectStore as JObjectStore
from repro_torch.bridge import params_from_jax
from repro_torch.configs import CONFIGS
from repro_torch.kernels import ops
from repro_torch.models.model import _embed_tokens, take_rows
from repro_torch.serve import ContinuousEngine, ServeConfig
from repro_torch.serve import request_plane as rp
from repro_torch.serve.engine import sample_tokens
from repro_torch.storage import KVStore, ObjectStore

torch.set_num_threads(1)

V = 512
# in range, last, wrapped, wrapped to row 0, past the end, far past, below -V
IDS = [0, V - 1, -1, -V, V, V + 388, -V - 1]
# the ServeConfig of tests/test_serve_continuous.py's engine
SETUP = dict(max_batch=3, max_len=64, max_new_tokens=6, decode_chunk=2, prefill_bucket=8)
PROMPTS = [[1, 2, 3, 4, 5, 6], [1, 2, 900, 4, 5, 6], [1, 2, -3, 4, 5, 6], [1, 2, 3, 4, 5, 700]]
MORE = [7, 8, 9, 10, 11, 12]
_PARAMS = {}


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_equals_jnp_take(dtype):
    table = np.random.default_rng(0).normal(size=(V, 16)).astype(np.float32)
    ids = np.asarray([IDS, IDS[::-1]], np.int32)
    want = _np32(jnp.take(jnp.asarray(table, dtype), jnp.asarray(ids), axis=0))
    ttable = torch.from_numpy(table).to(getattr(torch, dtype))
    got = take_rows(ttable, torch.from_numpy(ids).long())
    assert got.dtype == ttable.dtype and got.shape == (2, len(IDS), 16)
    np.testing.assert_array_equal(_np32(got), want)  # NaN rows in the same places
    nan_rows = np.isnan(want).all(-1)
    assert nan_rows.sum() == 6 and not np.isnan(want[~nan_rows]).any()
    cfg = CONFIGS["qwen3-32b"].reduced()
    assert not cfg.embed_scale
    np.testing.assert_array_equal(
        _np32(_embed_tokens({"embed": {"tok": ttable}}, cfg, torch.from_numpy(ids).long())), want)


def _params():
    if not _PARAMS:
        jp = jinit_params(JCONFIGS["qwen3-32b"].reduced(), jax.random.PRNGKey(0))
        _PARAMS["jax"] = jp
        _PARAMS["port"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                          CONFIGS["qwen3-32b"].reduced())
    return _PARAMS["jax"], _PARAMS["port"]


def _serve_twice(engine, plane, store, kv, batches):
    """Each batch of (id, prompt) submitted together, then served by the
    same ``engine`` until idle -> {id: tokens}."""
    out = {}
    for batch in batches:
        for r, p in batch:
            plane.submit(store, kv, r, p)
        engine.run(store, kv, engine_id="e0", idle_timeout_s=0.3)
        res = plane.get_results(store, [r for r, _ in batch], timeout_s=5)
        out.update({r: res[r]["tokens"] for r, _ in batch})
    return out


def test_engine_serves_out_of_vocabulary_prompts_as_jax_does_and_lives_on():
    jp, tp = _params()
    batches = [[(f"r{i}", p) for i, p in enumerate(PROMPTS)], [("next", MORE)]]
    want = _serve_twice(
        JContinuousEngine(JCONFIGS["qwen3-32b"].reduced(), jp, JServeConfig(**SETUP)),
        jrp, JObjectStore(), JKVStore(num_shards=2), batches)
    eng = ContinuousEngine(CONFIGS["qwen3-32b"].reduced(), tp, ServeConfig(**SETUP), device="cpu")
    got = _serve_twice(eng, rp, ObjectStore(), KVStore(num_shards=2), batches)
    assert got == want
    assert got["r1"] == got["r3"] == [0] * 6  # a NaN row's argmax
    assert got["r0"] != [0] * 6 and got["r2"] != [0] * 6 and got["next"] != [0] * 6


def test_sampled_out_of_vocabulary_row_gives_zero_and_spares_the_others():
    _, tp = _params()
    cfg = CONFIGS["qwen3-32b"].reduced()

    def serve(prompts):
        ids = [f"s{i}" for i in range(len(prompts))]
        store, kv = ObjectStore(), KVStore(num_shards=2)
        for r, p in zip(ids, prompts):
            rp.submit(store, kv, r, p)
        ContinuousEngine(cfg, tp, ServeConfig(**SETUP, temperature=0.8), device="cpu").run(
            store, kv, engine_id="e", idle_timeout_s=0.3)
        res = rp.get_results(store, ids, timeout_s=5)
        return [res[r]["tokens"] for r in ids]

    bad = serve([PROMPTS[0], PROMPTS[1]])
    good = serve([PROMPTS[0], MORE])
    assert bad[1] == [0] * 6
    assert bad[0] == good[0] and good[1] != [0] * 6


def test_sampler_nan_rows_take_the_first_nan_and_keep_other_draws():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(4, V)).astype(np.float32))
    seeds, steps = [11, 12, 13, 14], [3, 0, 5, 1]
    clean = sample_tokens(logits, seeds, steps, 0.8)
    poisoned = logits.clone()
    poisoned[1] = float("nan")
    poisoned[3, 7:] = float("nan")
    got = sample_tokens(poisoned, seeds, steps, 0.8)
    assert got.tolist() == [clean[0].item(), 0, clean[2].item(), 7]
    assert sample_tokens(poisoned, None, 0, 0.0).tolist()[1] == 0  # greedy agrees


@pytest.mark.parametrize("with_init", [False, True])
def test_slstm_scan_equals_jax(with_init):
    rng = np.random.default_rng(2 + with_init)
    B, S, H, D = 2, 9, 3, 8
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    gx = rng.normal(size=(B, S, H, D, 4)).astype(np.float32)
    r = (0.3 * rng.normal(size=(H, D, D, 4))).astype(np.float32)
    init = None
    if with_init:
        init = tuple(rng.normal(size=(B, H, D)).astype(np.float32) for _ in range(4))
        init = (np.abs(init[0]), np.abs(init[1]) + 1.0, init[2], init[3])
    want = np.asarray(jops.slstm_scan(jnp.asarray(x), jnp.asarray(gx), jnp.asarray(r),
                                      None if init is None else tuple(map(jnp.asarray, init))))
    got = ops.slstm_scan(torch.from_numpy(x), torch.from_numpy(gx), torch.from_numpy(r),
                         None if init is None else tuple(map(torch.from_numpy, init)))
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the xLSTM block's recurrence (its weight laid out (H, D, 4 D)) is the
    # same scan
    zeros = torch.zeros(B, H, D)
    carry = (zeros, zeros, zeros - 1e9, zeros) if init is None else tuple(map(torch.from_numpy, init))
    hs = ops.slstm_recurrence(torch.from_numpy(gx), torch.from_numpy(r).reshape(H, D, 4 * D),
                              *carry)[0]
    np.testing.assert_allclose(hs.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
