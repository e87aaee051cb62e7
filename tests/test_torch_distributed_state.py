"""The port's sharded decode, elastic reshard and int8 moments on real
gloo meshes of 4 CPU ranks, fp32: the second spawn of
`tests/test_torch_distributed.py`, whose helpers, bars and spawn it uses
(the cases split over two files to keep each within its time).

Decode: prefill of 8 tokens and 4 greedy steps with caches placed by
``cache_pspec``, tokens identical and logits within 2e-5 of the unsharded
port in the same rank.  The reshard twin of the JAX package's
``test_checkpoint_reshard_across_meshes``: 6 steps on (2, 2), ``save``,
``load(shardings=)`` on (1, 4), one more step, within 1e-5 of an
unsharded run's 7th loss.  Int8 moments: one step on (2, 2), each moment
within half an int8 step of the unsharded run's.  MLA with the sequence
sharded, and the vocab-chunked CE on a mesh: logits and gradients against
the unsharded port, as the first spawn's forward cases.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

from test_torch_distributed import (  # tests/ is on sys.path
    _cfg, _decode, _forward_and_grads, _full, _mesh, _params, _place, check_case, rank_main,
    run_ranks,
)

CASES = (
    "llama_decode",
    "zamba2_decode",
    "llama_batch1_decode_sequence_sharded",
    "reshard_2x2_to_1x4",
    "int8_moments",
    "deepseek_mla_sequence_parallel",
    "llama_fused_ce_grads",
)


def case_llama_decode():
    _decode("llama3-8b", 2, 2, B=4)


def case_zamba2_decode():
    _decode("zamba2-1.2b", 2, 2, B=4)


def case_llama_batch1_decode_sequence_sharded():
    from torch.distributed.tensor import Shard

    spec, cache = _decode("llama3-8b", 2, 2, B=1)
    k = cache["decoder"][0]["k"]
    assert Shard(1) in k.placements, (spec["decoder"][0]["k"], k.placements)


def case_deepseek_mla_sequence_parallel():
    """MLA (Dv != D: plain attention by shape, the chunked scan above
    Sq * Sk = 256^2) with the residual stream sequence-sharded over tp:
    the plain version runs on each rank's local shards (`ops._local_launch`),
    as a kernel does; before, it sliced the DTensors themselves."""
    os.environ["REPRO_SEQ_PARALLEL"] = "1"
    try:
        _forward_and_grads("deepseek-v3-671b", 1, 4, seq=260)
    finally:
        del os.environ["REPRO_SEQ_PARALLEL"]


def case_llama_fused_ce_grads():
    """The vocab-chunked CE (the hillclimb's ``ce=fused``) on the mesh: each
    rank's rows against the whole head (`train.fused_ce._on_local_rows`)."""
    _forward_and_grads("llama3-8b", 2, 2, fused_ce=True)


def _train_parts(quantize):
    from repro_torch.data import DataConfig
    from repro_torch.train import adamw

    cfg = _cfg("llama3-8b")
    opt = adamw(3e-3, weight_decay=0.0, quantize_moments=quantize)
    return cfg, opt, DataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size)


def _state(cfg, opt):
    from repro_torch.train import TrainState

    p = _params(cfg)
    return TrainState(p, opt.init(p))


def case_reshard_2x2_to_1x4():
    """The twin of ``test_checkpoint_reshard_across_meshes``: 6 steps on
    (2, 2), save, load onto (1, 4) and one more step."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.shardings import batch_pspec, state_pspec, to_shardings
    from repro_torch.models.sharding import use_mesh
    from repro_torch.storage import ObjectStore
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import AdamWState

    cfg, opt, dcfg = _train_parts(False)
    step = make_train_step(cfg, opt, inplace=True)
    ref, ref_losses = _state(cfg, opt), []
    for i in range(7):
        ref, m = step(ref, synthetic_batch(dcfg, i, cfg))
        ref_losses.append(float(m["loss"]))

    def batch(mesh, i):
        b = synthetic_batch(dcfg, i, cfg)
        return _place(b, mesh, batch_pspec(mesh, b))

    mesh_a, mesh_b = _mesh(2, 2), _mesh(1, 4)
    state = _state(cfg, opt)
    state = _place(state, mesh_a, state_pspec(mesh_a, state))
    losses = []
    with use_mesh(mesh_a):
        for i in range(6):
            state, m = step(state, batch(mesh_a, i))
            losses.append(float(_full(m["loss"])))
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        assert abs(a - b) <= 1e-5, f"step {i}: loss {a} vs unsharded {b}"
    store = ObjectStore()
    ck.save(store, "rt", 1, tuple(state))
    like = _state(cfg, opt)
    loaded, _, _ = ck.load(store, "rt", shardings=to_shardings(mesh_b, state_pspec(mesh_b, like)))
    params, (step_n, mom, vel) = loaded
    resumed_state = TrainState(params, AdamWState(step_n, mom, vel))
    assert params["decoder"][0]["attn"]["wq"].device_mesh is mesh_b
    with use_mesh(mesh_b):
        _, m = step(resumed_state, batch(mesh_b, 6))
    resumed = float(_full(m["loss"]))
    assert resumed < losses[0], (resumed, losses[0])
    assert abs(resumed - ref_losses[6]) <= 1e-5, (resumed, ref_losses[6])


def case_int8_moments():
    """One step on (2, 2) with int8 moments: each moment, decoded, lies
    within half an int8 step of the unsharded run's (fp32) moment; the int8
    leaves are replicated and blocked as an unsharded run blocks them."""
    from torch.distributed.tensor import Replicate

    from repro_torch.data import synthetic_batch
    from repro_torch.launch.shardings import batch_pspec, state_pspec
    from repro_torch.models.sharding import use_mesh
    from repro_torch.train import make_train_step
    from repro_torch.util import tree_flatten

    cfg, opt, dcfg = _train_parts(True)
    _, opt32, _ = _train_parts(False)
    b = synthetic_batch(dcfg, 0, cfg)
    ref, _ = make_train_step(cfg, opt32, inplace=True)(_state(cfg, opt32), b)
    mesh = _mesh(2, 2)
    state = _state(cfg, opt)
    state = _place(state, mesh, state_pspec(mesh, state))
    with use_mesh(mesh):
        state, _ = make_train_step(cfg, opt, inplace=True)(state, _place(b, mesh,
                                                                         batch_pspec(mesh, b)))
    is_q8 = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}  # noqa: E731
    for name, enc, want in (("m", state.opt_state.m, ref.opt_state.m),
                            ("v", state.opt_state.v, ref.opt_state.v)):
        for i, (e, w) in enumerate(zip(tree_flatten(enc, is_leaf=is_q8)[0], tree_flatten(want)[0])):
            assert all(p == Replicate() for p in e["q"].placements), (name, i, e["q"].placements)
            q, scale = e["q"].full_tensor(), e["scale"].full_tensor()
            assert q.shape == (-(-w.numel() // 256), 256), (name, i, q.shape, w.shape)
            dec = (q.float() * scale).reshape(-1)[: w.numel()]
            # v is kept as int8 sqrt(v)
            w = (w if name == "m" else torch.sqrt(w)).reshape(-1)
            half = (0.5 * scale.expand(-1, 256).reshape(-1)[: w.numel()]) + 1e-7
            bad = ((dec - w).abs() > half).sum().item()
            assert bad == 0, f"moment {name} leaf {i}: {bad} values beyond half an int8 step"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(os.path.abspath(__file__), tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("case", CASES)
def test_sharded(results, case):
    check_case(results, case)


if __name__ == "__main__":
    rank_main({name: globals()["case_" + name] for name in CASES}, sys.argv[1:])
