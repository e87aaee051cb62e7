"""The port's sharded program at the production meshes, on torch's own
fake process group (`launch.dryrun.count_collectives_many`: a child
process per mesh, fake tensors, nothing allocated).

Each cell runs one step of its program (the train step with remat and
AdamW, a prefill or a decode step) at full width with depth cut to 2
layers (one period for zamba2 and xlstm) on 16 x 16 ("data", "model") and
2 x 16 x 16 ("pod", "data", "model"), its arguments placed by the port's
specs, and must raise nowhere.  The first six cells raised before their
repairs (ROADMAP Queue 3, "Repaired"):

  * llama3-8b train and prefill, qwen3-32b train: GQA's 8 KV heads, whose
    flattened projection DTensor split over model = 16 and then refused to
    unflatten (`models.attention._proj`, now `sharding.reshape`);
  * xlstm-1.3b train: 4 heads over 16 in the head-wise projections
    (`models.xlstm._headwise`), and the sLSTM's log-sigmoid backward,
    which DTensor has no rule for (`ops.slstm_recurrence` on local shards);
  * zamba2-1.2b train: the grouped norm's 2 groups, unflattened in the
    backward (`layers.grouped_rmsnorm`);
  * deepseek-v3-671b train: the plain MLA attention slicing DTensors
    (`ops.flash_attention` now runs it on local shards) and the MTP
    head's input, a partial lookup added to a partial sum (the lookup now
    reduced in `models.model._embed_tokens`).

The other four families take one cell each.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro_torch.analysis import roofline as rl
from repro_torch.configs import CONFIGS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.models import sharding as sh

FAULT_CELLS = [("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"), ("qwen3-32b", "train_4k"),
               ("xlstm-1.3b", "train_4k"), ("zamba2-1.2b", "train_4k"),
               ("deepseek-v3-671b", "train_4k")]
OTHER_CELLS = [("gemma2-27b", "prefill_32k"), ("olmoe-1b-7b", "decode_32k"),
               ("whisper-large-v3", "decode_32k"), ("internvl2-1b", "prefill_32k")]
CELLS = FAULT_CELLS + OTHER_CELLS
MESHES = {"16x16": False, "2x16x16": True}
TIMEOUT_S = 1200  # a child's limit: the xLSTM cell alone takes minutes on a busy host


def cut_config(arch, shape_name):
    """The cell's config at full width, depth cut to 2 layers (one period
    for the hybrid and the xLSTM)."""
    cfg = dryrun.shape_adjusted_config(CONFIGS[arch], SHAPES[shape_name])
    layers = cfg.shared_attn_every or (cfg.xlstm.slstm_every if cfg.xlstm else 2)
    return dataclasses.replace(cfg, n_layers=layers)


def _cell(arch, shape_name):
    shape = SHAPES[shape_name]
    return dryrun.collective_cell(cut_config(arch, shape_name), shape.kind,
                                  shape.global_batch, shape.seq_len)


# the children, by their cost: the xLSTM's one period runs the sLSTM loop
# over 4096 steps three times (forward, recompute, backward), and the
# 2 x 16 x 16 train steps spend most of theirs in DTensor's strategy search
GROUPS = [[("xlstm-1.3b", "train_4k")],
          [c for c in CELLS if c[0] != "xlstm-1.3b"]]
SPLIT_2POD = [("zamba2-1.2b", "train_4k"), ("deepseek-v3-671b", "train_4k")]


@pytest.fixture(scope="module")
def counts():
    """{(arch, shape, mesh name): CollectiveStats or the error it raised};
    five children at once."""
    jobs = []
    for name, multi in MESHES.items():
        mesh = abstract_production_mesh(multi)
        for part in GROUPS:
            if multi and len(part) > 1:
                jobs.append((mesh, [c for c in part if c in SPLIT_2POD]))
                jobs.append((mesh, [c for c in part if c not in SPLIT_2POD]))
            else:
                jobs.append((mesh, part))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(dryrun.count_collectives_many, [_cell(*c) for c in part], mesh,
                               timeout=TIMEOUT_S) for mesh, part in jobs]
        out = {}
        for (mesh, part), fut in zip(jobs, futures):
            for cell, got in zip(part, fut.result()):
                out[cell + (dryrun.mesh_name(mesh),)] = got
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_one_step_at_the_production_mesh(counts, arch, shape_name, mesh):
    got = counts[(arch, shape_name, mesh)]
    if isinstance(got, Exception):
        raise got
    assert isinstance(got, rl.CollectiveStats)
    assert sum(got.counts.values()) > 0 and got.wire_bytes > 0 and got.time_s > 0
    assert set(got.by_link) <= {"nvlink", "network"}


@pytest.mark.parametrize("in_shape,out_shape,want", [
    ((4, 8, 1024), (4, 8, 8, 128), [([0], [0]), ([1], [1]), ([2], [2, 3])]),
    ((4, 8, 8, 128), (4, 8, 1024), [([0], [0]), ([1], [1]), ([2, 3], [2])]),
    ((4, 1, 64), (4, 64), [([0], [0]), ([2], [1])]),
    ((2, 3, 4), (6, 4), [([0, 1], [0]), ([2], [1])]),
    ((6, 4), (4, 6), [([0, 1], [0, 1])]),
])
def test_reshape_groups(in_shape, out_shape, want):
    """`sharding.reshape`'s view of a reshape: the dims each group of
    input dims becomes (size-1 dims left out), from which it reads whether
    a mesh dim's shard is carried (the group's first dim, its first output
    part divisible) or must be replicated first."""
    assert sh._view_groups(in_shape, out_shape) == want
