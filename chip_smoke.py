#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (one process per source, all at once) and drives the port through
its phases, each printing JSON lines; any failed check raises and the
script exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``) and the kernel
   build time;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   (see `compare` for the tolerances; the SSD's fp32 final state and the
   fp32 mLSTM at the JAX package's bars; bf16 flash attention, SSD and
   mLSTM run the tensor-core kernels, fp32 the scalar ones; decode
   attention is one cluster launch per call, with live lengths at the tile
   edges and every cluster size among its cases), with its time, the plain
   version's, the least time the card could take (``bound_ms``) and one
   PyTorch library call's where one computes the same function
   (``F.scaled_dot_product_attention``, a yardstick the port never calls;
   none for the SSD scan and the mLSTM), at the serving shapes of phases
   3, 3b, 3c, 3d, 3f and 3g first; at the train steps' shapes of phases 5d
   and 5e (flash MHA 32 x 64 and the SSD at 2 x 1024, the mLSTM at 4 x 512
   and at 2 x 1024, bf16) also the gradients through ``PlainBackwardFn``
   (``ops`` under autograd), which must equal autograd of the plain version
   bit for bit, and the plain backward's device time; the SSD also at every
   other (P, N) its kernels take (``WIDTHS``: the reduced configs' 16 x 16,
   the JAX kernel tests' 16 x 8, 32 x 16 and 8 x 4, Mamba2's 64 x 128), in
   bf16 and fp32, with the final state, and in bf16 over 9 chunks;
3. serve: llama3-8b at full width (32 layers, random weights from a seed)
   behind ``ContinuousEngine`` over the in-memory request plane: 8 requests
   arriving 150 ms apart, 4 slots, 32 new tokens each; every request
   published exactly once, some admitted mid-batch, and both attention
   kernels' launch counters > 0 during this phase (flash attention's all
   on its tensor-core route); then a profile of the decode step;
3b. serve: zamba2-1.2b (the Mamba2 hybrid) at full width (38 layers, the
   shared attention block every 6) the same way; the ssd, flash and decode
   counters all > 0 during this phase (flash and the SSD all on their
   tensor-core routes); then its decode-step profile;
3c. serve: xlstm-1.3b at full width (mLSTM head dim 1024) cut in depth to
   ``XLSTM_SERVE_LAYERS`` = 16 of its 48 blocks (2 of its 6 groups of 7
   mLSTM + 1 sLSTM) the same way; the mlstm counter > 0 during
   this phase; then its decode-step profile, whose least step time counts
   the recurrent state read and written beside the weights;
3d. serve: olmoe-1b-7b at full width (64 experts, top-8, MHA 16 x 128
   with qk-norm) cut in depth to ``OLMOE_SERVE_LAYERS`` = 8 of its 16 MoE
   layers, the same way; the decode and flash counters
   > 0 during this phase (flash all on its tensor-core route); then its
   profiles;
3e. serve: deepseek-v3-671b at full width (d_model 7168, 128 heads, MLA,
   256 experts top-8 and 1 shared, vocab 129280) cut in depth to
   ``DEEPSEEK_SERVE_LAYERS`` = 4 (the 3 dense MLA layers and 1 MoE layer;
   the MTP head initialised, unused by serving), the same way; both
   attention counters stay at 0 (MLA's Dv != D takes plain PyTorch by
   shape); then its profiles;
3f. generate: whisper-large-v3 at full width and depth (32 encoder + 32
   decoder layers, d_model 1280, 20 heads of 64) through
   ``Engine.generate`` with ``extras={"audio_frames": ...}``: 4 rows of 1500
   random frames, a 4-token prompt each, 32 greedy tokens, ``max_len`` 448
   (the learned position table); the flash and decode counters equal the
   launches the code implies, every flash launch on the tensor-core route,
   negated frames change the tokens or the logits; the encoder's time, a
   prefill profile and a decode-step profile whose least step counts the
   decoder's weights and the cross cache;
3g. serve: internvl2-1b at full width and depth (24 layers, GQA 14/2 at
   head_dim 64) text-only behind ``ContinuousEngine`` as in phase 3; then
   ``Engine.generate`` with a 256-row ``prefix_embed`` per row (prefill
   length 256 + the prompt, launch counts as the code implies);
4. consistency: llama3-8b width at 2 layers in fp32 (TF32 off), prefill and
   4 decode steps on the card (kernels) against the same weights on the CPU
   (plain versions): identical greedy tokens, logits within 2e-3;
4b. the same for zamba2 width at 7 layers (one super block and a tail
   layer), two prompts of 200 tokens (a ragged second chunk), then
   ``forward`` over the whole sequence on both devices;
4c. the same for xlstm width at 8 layers (one group of 7 mLSTM + 1 sLSTM),
   prompts of 200 and of 137 tokens, each prefilled alone at its exact
   length (as the engine groups them), then ``forward``;
4d. the same for olmoe width at 2 MoE layers (all 64 experts), then
   ``forward``; the router's scores on both devices beside the smallest
   margin between the k-th and (k+1)-th score;
4e. the same for deepseek width at 2 layers (one dense MLA layer, one MoE
   layer cut to ``DEEPSEEK_CHECK_EXPERTS`` = 16 routed experts, top-8 and
   1 shared kept), then ``forward`` with the MTP head's logits (also held
   within 2e-3);
4f. the same for whisper width at 2 encoder + 2 decoder layers over 1500
   random audio frames, then ``forward``;
4g. the same for internvl2 width at 2 layers behind a 256-row prefix, then
   ``forward``;
5a. train: llama3-8b at full width and depth (32 layers, bf16, 8.03 B
   parameters) through ``make_train_step`` with int8 moments, remat, the
   fused CE and the in-place update, one microbatch of 2 x 1024 tokens,
   three steps (the last under ``torch.profiler``): losses and grad norms
   finite, every parameter leaf's gradient nonzero (wq/wk/wv of every layer
   among them), exactly 2 x 32 flash launches per step (forward and the
   remat recompute) all on the tensor-core route, peak memory under 75 GB;
   step time, tokens/s, the device-busy share, the flash forward's device
   time against the plain attention backward's;
5b. elastic: llama3-8b width cut to 1 layer through ``train_elastic`` on
   ``WrenExecutor(num_workers=2)`` over the in-memory store (int8 moments,
   fused CE, 2 steps per chunk, 4 steps scaled to 3 workers at chunk 1,
   then a resume to 6; 6 and 8 until the script needed the time):
   versions 2 then 3, a warm start, and chunk 0 run
   again after the warm cache is cleared and v1 deleted writes the same
   leaf bytes; ``python -m repro_torch.launch.train --arch llama3-8b
   --reduced --steps 4 --steps-per-chunk 2`` runs at 5e;
5c. train consistency: llama3-8b width at 1 layer in fp32 (TF32 off), one
   batch of 128 tokens, the loss and gradients on the card against the CPU,
   then the int8 optimizer given the same gradients on both devices;
5d. train: zamba2-1.2b at full width and depth (38 Mamba2 layers, the
   shared block every 6; 1.227 B parameters) as in 5a: the SSD and flash
   kernels inside ``PlainBackwardFn`` (the plain version's derivative in the
   backward), exactly 76 SSD
   and 12 flash launches per step (all on the tensor-core route), every
   leaf's gradient nonzero (in_proj, A_log, dt_bias and D of every Mamba
   layer, the shared block's wq/wk/wv among them), peak memory under 14
   GB; the device ms of the plain SSD and attention backwards;
5e. train: xlstm-1.3b at full width cut to 1 of its 6 groups
   (``XLSTM_TRAIN_LAYERS``: 7 mLSTM + 1 sLSTM blocks) the same way: the
   mLSTM kernels inside ``PlainBackwardFn``, exactly 14 launches per step
   (all on the tensor-core route), every leaf nonzero
   (w_qhw/w_khw/w_vhw/w_igate/w_fgate of every mLSTM block and r_kernel of
   every sLSTM block among them), peak memory under 19 GB, its sequence
   cut to 4 x 512 tokens (``TRAIN_SHAPE``: the sLSTM loop's time); the
   device ms of the plain mLSTM backward and the sLSTM blocks' share of
   each step on the host clock; then ``python -m repro_torch.launch.train
   --reduced`` for llama3-8b (5b's), xlstm-1.3b and zamba2-1.2b (the
   reduced hybrid, P = N = 16) on the card, the three processes started
   together;
5f. train consistency as in 5c for zamba2 width at 7 layers (one super
   block of 6 Mamba layers with the shared block, one tail layer) and
   xlstm width at 8 (7 mLSTM + 1 sLSTM), the fp32 kernels launched as the
   layers imply;
6a. storage: the file stores across two processes on the card machine's
   filesystem (CPU only): a ``blpop`` woken by the other process's push, a
   ``put_if_absent`` race in which each key has one winner, and the
   committed prefix after a SIGKILLed writer plus half a frame; the
   watcher's mode (inotify or poll) and its ``poll_wakeups``;
6b. serve over shared roots: llama3-8b at full width and depth (32 layers,
   bf16 weights from seed 0, the fp32 cache) in ``python -m
   repro_torch.launch.serve --kv-root K --obj-root O`` workers, the smoke's
   own process holding no model: one worker serves 16 requests (prompts of
   16-300 tokens from seed 0, ``SERVE_NEW_TOKENS`` = 16 new tokens, 4
   slots); then two workers
   serve them again, and one is SIGKILLed once it has published a result
   and still holds live leases; the survivor finishes every request, one
   result object each, the victim's results untouched, and exits 0 on
   idle; each worker's time to READY, the kill-to-last-result time, the
   survivor's tokens/s, both worker PIDs among the card's processes with
   their weights' memory, how many requests' tokens equal the one-worker
   run's, and each request's prefill group in both runs (the workers'
   ``prefill [...]`` lines): a bf16 prefill's bits depend on how many
   rows its group has (the GEMMs' M; ``tools/prefill_groups.py``), so the
   tokens must be equal for every request prefilled in the same group in
   both runs, and the others are counted; each worker's kernel launches
   (its ``launches`` line);
6c. elastic resume: llama3-8b width cut to 1 layer (bf16, int8 moments, 2
   x 512 tokens, 2 steps a chunk): 1 chunk on a ``FileBackend`` root
   here (2 until the script needed the time), then the second twice, here
   from the state in memory (the
   uninterrupted run) and in a fresh process from the root, whose losses
   must equal the uninterrupted run's bit for bit; the disk's room first (three versions'
   worth or the phase fails), the bytes of a version and the seconds to
   write and read one;
7. BSP on the port's runtime over file roots (``FileBackend`` and a
   4-shard ``FileKVStore`` in a temp dir), host only (no kernel runs), in
   at most ``BSP_BUDGET_S`` = 120 s: 7a word count over ``make_documents``
   in 333 partitions (about 25 MB of text), 8 workers, equal to an
   in-process ``Counter``; 7b terasort of 1.25 x 10^5 100-byte records in 20
   objects -> 20 partitions, intermediates on the KV: sorted, 400
   intermediate objects, none left after the merge; 7c a sort driver
   process SIGKILLed between partition and merge, adopted by a fresh
   process with ``adopt_job`` (only the merge tasks run; every record
   written once, none lost); 7d HOGWILD! on the KV store as
   ``examples/hogwild_ps.py`` runs it (8 data shards; no bound, a
   staleness bound of 4, int8 compression): the loss falls; each part's
   wall time on the host clock; all of it under the port's runtime
   sanitizer (`repro_torch.analysis.sanitizer`, installed here for the
   rest of the script, and in 7c's children): a ``sanitizer`` line, the
   reports (none allowed) and the ops it saw in each process (above zero);
8. the ``repro-kvd`` wire tier on the card's machine, in at most
   ``WIRE_BUDGET_S`` = 150 s: the port's daemon through its CLI
   (``python -m repro_torch.storage.net_server``) on a Unix socket (one
   for 8a's two runs, one for 8b-8d); 8a llama3-8b at full width and
   depth, 6b's engine (``WIRE_ENGINE``) in this process behind
   ``ContinuousEngine.run`` over ``NetKVStore`` + ``NetBackend``:
   ``WIRE_REQUESTS`` = 8 requests drawn as 6b's are, 6 at once and 2 the
   moment the idle engine has entered ``blpop`` (which must return the
   first of them), served over in-memory stores, then over a steady
   daemon, then over one SIGKILLed once the first result is published and
   restarted on its root and address; every request published once, the
   engine's client reconnected once (two server generations seen), tokens
   equal to the in-memory run's wherever the prefill group was the same;
   tokens/s, TTFT p50, the kill to the next result (the daemon's restart
   and the client's reconnect apart), bytes pickled and sent as buffer
   frames, modelled requests, the kernels' launches; 8b 7b's terasort over
   one daemon with 8 workers, the sorted partitions equal to 7b's byte for
   byte; 8c 7c's adoption over one daemon, both children rebuilding the
   stores from their ``net_kv`` / ``net_obj`` specs; 8d 7d's HOGWILD!
   with the executor and the parameter server on one daemon, at half
   7d's steps per worker, in 7d's bands; under the sanitizer as 7 is, the daemons started with
   ``REPRO_SANITIZE=1``, and its ``sanitizer`` line.  No fallback: a
   daemon that does not start fails the phase.
9. sharded execution, in at most ``DIST_BUDGET_S`` = 45 s: a (1, 1)
   ``DeviceMesh`` ("data", "model") over NCCL, world size 1 (the process
   group from a ``HashStore``, torn down at the end), parameters, caches,
   batch and train state placed by the port's rules
   (`repro_torch.models.sharding`, `repro_torch.launch.shardings`), the
   models run under ``use_mesh`` and each kernel reached on the local
   shards through ``local_map``; 9a llama3-8b at full width, 2 layers,
   fp32 (TF32 off): prefill of two prompts of 64 tokens and 4 greedy decode
   steps against the same run on plain tensors (identical tokens, logits
   within 2e-5), the flash and decode counters > 0, then one train step
   (finite loss, every leaf's gradient nonzero, flash launched); 9b
   zamba2-1.2b at full width, one period (6 Mamba2 layers and the shared
   block), the same serving checks with the ssd counter > 0, then one
   ``ops.mlstm_parallel`` on DTensors at xlstm-1.3b's shape (1 x 300, 4
   heads of 1024, bf16), bit-equal to the call on plain tensors, the mlstm
   counter > 0; each ``dist_*`` line with its seconds and the card's name
   and power limit.
10. the dry-run's roofline against the card, in at most
   ``ROOFLINE_BUDGET_S`` = 60 s: `repro_torch.launch.dryrun` counts, on
   fake CPU tensors over a one-card ``AbstractMesh`` (no process group, no
   launch), 5a's llama3-8b train step and phase 3's llama3-8b decode step
   as this script ran them; each ``roofline`` line holds the compute,
   memory and bound terms (the datasheet constants of
   `repro_torch.analysis.roofline`) beside the measured step on the host
   clock and its device-busy time, and decode's ``least_step_ms`` beside
   the memory term; a bound above the device-busy time it bounds fails.
11. the example twins on the card, in at most ``TWINS_BUDGET_S`` = 60 s,
   each a fresh process as a user runs it, both at once: ``examples_torch/train_lm.py
   --steps 20`` (the 100M llama3 derivative through ``train_elastic``, a
   pool resize, a worker kill and 3 more chunks from the checkpoint) and
   ``examples_torch/serve_llm.py`` (two ``launch.serve`` engines over
   shared file roots, the second started while the first serves, the
   first SIGKILLed holding live leases, every request published once);
   each ``twin`` line holds its tokens/s, seconds, kill lines and kernel
   launches (the flash counter > 0 in both, the decode counter > 0 in
   serve_llm's surviving engine, and serve_llm's requests outstanding at
   the kill > 0) with the card's name and power limit; a twin that exits
   non-zero fails the phase.  serve_llm draws its prompt ids below
   1000, over a table of 512, as the JAX example does: most prompts hold
   ids past the vocabulary, whose NaN rows give token 0;
12. 12a, the vocabulary on the card: an in-process ``ContinuousEngine``
   (reduced qwen3-32b in bf16, random weights from seed 0, a bf16 cache,
   ``VOCAB_SERVE``) serves ``VOCAB_PROMPTS`` submitted together, two of
   which hold ids past the 512-entry table (a NaN row, as ``jnp.take``
   gives it) and one a negative id (wrapped): those two give ``[0] * 6``,
   through the CUDA prefill and decode kernels (both counters > 0), the
   other two give the tokens of the same group with the bad ids replaced
   (the same group shape: a bf16 prefill's bits depend on its row count),
   the engine then serves one more request, and at temperature 0.8 the
   bad rows give 0 too; a device-side assert would fail the synchronize;
   12b, the six runtime example twins (``RUNTIME_TWINS``: terasort,
   featurize_reduce, hogwild_ps, multi_driver, driver_failover,
   net_cluster), each a fresh process as a user runs it, all at once, in
   at most ``RUNTIME_TWINS_BUDGET_S`` = 45 s: host code only (the port's
   runtime, stores and ``repro-kvd`` wire on Python and the card
   machine's torch, no jax); each ``runtime_twin`` line holds its seconds
   and last lines, and its own result is checked (terasort globally
   ordered at every shard count, the fit's accuracy at least 0.95, each
   HOGWILD! relative error below 0.01, driver B's tasks, the failover's
   empty keyspaces, the daemon client's reconnects at least 1); a twin
   that exits non-zero or times out fails the phase.

``python3 chip_smoke.py serve-ab ROOT`` runs no phase: it times phase
3's llama3-8b decode step on this tree against the tree at ROOT (the
parent commit unpacked with ``git archive``), alternating fresh processes;
``python3 chip_smoke.py sanitize-ab ROOT`` times phases 7 and 8 the same
way (this tree's sanitized, ROOT's as that tree runs them).

The line before the last lists every kernel (name, route, source, the TPU
kernel it replaces, launches per serving and training phase, error and
times at the serving shapes, and at the train steps' shapes with the plain
backward's time); the last line is the result object.  Without a GPU, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

BF16_ULP = 2.0 ** -7  # spacing of bfloat16 values in [1, 2)
DECODE_SRC = "src/repro_torch/kernels/csrc/decode_attention.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/mamba2_ssd.cu"
MLSTM_SRC = "src/repro_torch/kernels/csrc/mlstm.cu"
SSD_STATE_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_kernels.py:167
MLSTM_F32_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_kernels.py:242
SUBMIT_GAP_S = 0.15  # phase 3: one request every 150 ms
DEEPSEEK_SERVE_LAYERS = 4  # phase 3e: the 3 dense MLA layers + 1 MoE layer (31.6 GB in bf16)
OLMOE_SERVE_LAYERS = 8  # phase 3d: 8 of 16 MoE layers (16 until PR 24; 37.7-46.9 s there)
# phases 3c and 5c cut in depth so that phases 6-8 fit the script's time
# limit: xlstm-1.3b serves 2 of its 6 groups (its sLSTM loop grows with the
# depth; 3c took 55.1-60.4 s at 48 blocks), and the card-against-CPU train
# check of llama3-8b's width runs 1 layer (the CPU's share is the
# embedding and the head; 5c took 105.7-106.9 s at 2 layers)
XLSTM_SERVE_LAYERS = 16
LLAMA_CONSISTENCY_LAYERS = 1
DEEPSEEK_CHECK_EXPERTS = 16  # phase 4e: routed experts of its MoE layer (fp32 on both devices)
SPIN_CYCLES = 2_000_000  # about 1 ms of device spin ahead of each timed launch
GEN_ROWS, GEN_PROMPT, GEN_NEW = 4, 4, 32  # phases 3f/3g: `Engine.generate` rows, prompt, tokens


# phase 10's inputs: phase 3's llama3-8b decode profile and 5a's train step
MEASURED = {}
ROOFLINE_BUDGET_S = 60  # phase 10
TWINS_BUDGET_S = 60  # phase 11, both twins
RUNTIME_TWINS_BUDGET_S = 45  # phase 12b, all six at once
RUNTIME_TWINS = ("terasort.py", "featurize_reduce.py", "hogwild_ps.py", "multi_driver.py",
                 "driver_failover.py", "net_cluster.py")
# phase 12a: the JAX engine's test settings; ids past the 512-entry table
# (900, 700) and one wrapped (-3)
VOCAB_SERVE = dict(max_batch=3, max_len=64, max_new_tokens=6, decode_chunk=2, prefill_bucket=8)
VOCAB_PROMPTS = ([1, 2, 3, 4, 5, 6], [1, 2, 900, 4, 5, 6], [1, 2, -3, 4, 5, 6],
                 [1, 2, 3, 4, 5, 700])
VOCAB_MORE = [7, 8, 9, 10, 11, 12]
DECODE_SLOT_LENS = (16, 300, 57, 128)  # the live slots of `profile_decode`


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def compare(out, exp, fp32: bool):
    """(ok, max_abs_err, worst error / limit) of a kernel's output against
    its plain version's.  fp32: |out - exp| <= 2e-5 + 2e-5 |exp|.  bf16
    output: both sides are fp32 results rounded to bf16, so they may differ
    by one bf16 step; each element's limit is the smaller of that step at
    the largest value of its output row (+1e-5) and the 2e-2 bar of
    `tests/test_kernels.py`.  Outputs of long rows are small, so a kernel
    that drops or double-counts part of a row fails this by far."""
    out, exp = out.float(), exp.float()
    err = (out - exp).abs()
    mag = exp.abs()
    if fp32:
        lim = 2e-5 + 2e-5 * mag
    else:
        lim = (BF16_ULP * mag.amax(-1, keepdim=True) + 1e-5).minimum(2e-2 + 2e-2 * mag)
    ratio = (err / lim).max().item()
    return ratio <= 1.0, err.max().item(), ratio


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after the L2 cache is overwritten (cold cache, as a layer's
    cache slice is in the serving loop).  A spin kernel ahead of the start
    event keeps the device busy while the host enqueues ``fn``, so the
    events see device time, not the wrapper's host overhead (which
    `call_ms` reports)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def call_ms(torch, fn, iters: int = 20) -> float:
    """Host-clock time per call of ``fn`` back to back, ending in a
    synchronize: what a caller pays, host overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def hardware():
    """The H100 SXM's datasheet constants, from the port's roofline (one
    source): HBM_BW bytes/s, PEAK_FLOPS (dense bf16) and PEAK_FLOPS_FP32."""
    from repro_torch.analysis import roofline

    return roofline


def bound(nbytes: float, flops: float, dtype: str):
    hw = hardware()
    peak = {"bfloat16": hw.PEAK_FLOPS, "float32": hw.PEAK_FLOPS_FP32}[dtype]
    t_bytes, t_ops = nbytes / hw.HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def grad_check(torch, flush, run, base, go):
    """The training path of a kernel at one shape: ``run(leaves, True)``
    calls the dispatch (``ops``) under autograd, which launches the kernel
    inside its autograd Function, ``run(leaves, False)`` the plain version.
    The Function's backward is that plain version recomputed, so the
    gradients of every input must be finite and equal autograd of the
    plain version's on the same inputs bit for bit.  Also the device time
    of the Function's backward (the plain recompute and its derivative)."""
    ins = [t.clone().requires_grad_(True) for t in base]
    out = run(ins, True)
    got = torch.autograd.grad(out, ins, go, retain_graph=True)
    ref = [t.clone().requires_grad_(True) for t in base]
    exp = torch.autograd.grad(run(ref, False), ref, go)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, exp))
    equal = all(torch.equal(a, b) and bool(torch.isfinite(a).all()) for a, b in zip(got, exp))
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(out, ins, go, retain_graph=True), 3,
                     flush)
    return {"grad_fn": type(out.grad_fn).__name__,
            "grads_equal_plain": equal, "grad_max_abs_diff": diff,
            "backward_plain_ms": bwd_ms}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_case(torch, F, dmod, flush, dev, name, B, S, K, G, D, clen, q_dt, kv_dt,
                window=None, cap=None):
    g = torch.Generator(device=dev).manual_seed(B * S + G)
    H = K * G
    q = torch.randn((B, H, D), generator=g, device=dev).to(getattr(torch, q_dt))
    kc = torch.randn((B, S, K, D), generator=g, device=dev).to(getattr(torch, kv_dt))
    vc = torch.randn((B, S, K, D), generator=g, device=dev).to(getattr(torch, kv_dt))
    cl = torch.tensor(clen, dtype=torch.int32, device=dev)
    kw = dict(window=window, logit_cap=cap)
    out = dmod.decode_attention(q, kc, vc, cl, **kw)
    exp = dmod.decode_attention_plain(q, kc, vc, cl, **kw)
    torch.cuda.synchronize()
    ok, err, ratio = compare(out, exp, q_dt == "float32")
    live = [n - (max(0, n - window) if window else 0) for n in clen]
    nbytes = 2 * q.numel() * q.element_size() + cl.numel() * 4 \
        + sum(live) * K * D * 2 * kc.element_size()
    flops = 4.0 * D * H * sum(live)
    b_ms, b_by = bound(nbytes, flops, "float32" if "float32" in (q_dt, kv_dt) else "bfloat16")
    lib_ms = None
    if cap is None:  # SDPA has no softcap
        pos = torch.arange(S, device=dev)[None, :]
        valid = pos < cl[:, None]
        if window:
            valid &= pos > cl[:, None] - 1 - window
        mask = valid[:, None, None, :]
        # SDPA takes one dtype: q is cast to the cache's once, outside the
        # timing (bf16 -> fp32 is exact, so the function is the same)
        q4, k4, v4 = q.to(kc.dtype)[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True), 20, flush)
    row = {
        "phase": "kernel", "kernel": "decode_attention", "case": name,
        "B": B, "S": S, "H": H, "K": K, "D": D, "cache_len": clen,
        "splits": dmod.cluster_splits(B, K),
        "q_dtype": q_dt, "cache_dtype": kv_dt, "window": window, "softcap": cap,
        "max_abs_err": err, "err_over_limit": ratio, "ok": bool(ok),
        "kernel_ms": time_ms(torch, lambda: dmod.decode_attention(q, kc, vc, cl, **kw), 50, flush),
        "call_ms": call_ms(torch, lambda: dmod.decode_attention(q, kc, vc, cl, **kw)),
        "plain_ms": time_ms(torch, lambda: dmod.decode_attention_plain(q, kc, vc, cl, **kw), 10, flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    }
    emit(row)
    check(ok, f"decode_attention {name}: error {ratio:.3g}x its limit (max_abs_err {err})")
    return row


def flash_case(torch, F, fmod, flush, dev, name, B, Sq, Sk, K, G, D, dt,
               causal=True, window=None, cap=None, q_offset=0, yardstick=None, ops=None):
    """With ``yardstick`` (the decode attention module; Sq = 1, non-causal)
    the row also times the decode kernel on the same q, K and V with every
    length Sk: the same function, as a yardstick only.  With ``ops`` (the
    dispatch module: a training shape) also `grad_check`."""
    g = torch.Generator(device=dev).manual_seed(B * Sq + Sk + G)
    H = K * G
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(getattr(torch, dt))
    k = torch.randn((B, Sk, K, D), generator=g, device=dev).to(getattr(torch, dt))
    v = torch.randn((B, Sk, K, D), generator=g, device=dev).to(getattr(torch, dt))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    out = fmod.flash_attention(q, k, v, **kw)
    exp = fmod.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    ok, err, ratio = compare(out, exp, dt == "float32")
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum().item())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 4.0 * D * H * B * pairs, dt)
    lib_ms = None
    if cap is None:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if causal and not window and q_offset == 0 and Sq == Sk:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_ms = time_ms(torch, lib, 10, flush)
    row = {
        "phase": "kernel", "kernel": "flash_attention", "case": name,
        "B": B, "Sq": Sq, "Sk": Sk, "H": H, "K": K, "D": D, "dtype": dt,
        "causal": causal, "window": window, "softcap": cap, "q_offset": q_offset,
        "route": fmod.ROUTES[q.dtype], "max_abs_err": err, "err_over_limit": ratio, "ok": bool(ok),
        "kernel_ms": time_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw), 10, flush),
        "call_ms": call_ms(torch, lambda: fmod.flash_attention(q, k, v, **kw)),
        "plain_ms": time_ms(torch, lambda: fmod.flash_attention_plain(q, k, v, **kw), 5, flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    }
    if yardstick is not None:
        lens = torch.full((B,), Sk, dtype=torch.int32, device=dev)
        row["decode_yardstick_ms"] = time_ms(
            torch, lambda: yardstick.decode_attention(q[:, 0], k, v, lens), 10, flush)
    if ops is not None:
        go = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        row.update(grad_check(torch, flush, lambda t, fn: (
            ops.flash_attention if fn else fmod.flash_attention_plain)(*t, **kw), [q, k, v], go))
    emit(row)
    check(ok, f"flash_attention {name}: error {ratio:.3g}x its limit (max_abs_err {err})")
    check(ops is None or row["grads_equal_plain"],
          f"flash_attention {name}: gradients differ from the plain version's by "
          f"{row.get('grad_max_abs_diff')}")
    return row


def ssd_case(torch, F, smod, flush, dev, name, B, S, H, G, dt, with_d=True,
             return_state=True, chunk=128, ops=None, P=64, N=64):
    """x, B and C are views of one (B, S, conv_dim) buffer, as the Mamba2
    layer hands them over (the conv output, row stride conv_dim).  With
    ``ops`` (the dispatch module: a training shape, no state) also
    `grad_check` over the buffer, dt, A and D."""
    g = torch.Generator(device=dev).manual_seed(B * S + H + G)
    d_in, gn = H * P, G * N
    xbc = torch.randn((B, S, d_in + 2 * gn), generator=g, device=dev).to(getattr(torch, dt))
    x = xbc[..., :d_in].reshape(B, S, H, P)
    Bm = xbc[..., d_in:d_in + gn].reshape(B, S, G, N)
    Cm = xbc[..., d_in + gn:].reshape(B, S, G, N)
    dtv = F.softplus(torch.randn((B, S, H), generator=g, device=dev))
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    D = torch.randn((H,), generator=g, device=dev) if with_d else None
    kw = dict(chunk=chunk, return_state=return_state)
    out = smod.ssd(x, dtv, A, Bm, Cm, D, **kw)
    exp = smod.ssd_plain(x, dtv, A, Bm, Cm, D, **kw)
    torch.cuda.synchronize()
    y, y_exp = (out[0], exp[0]) if return_state else (out, exp)
    ok, err, ratio = compare(y, y_exp, dt == "float32")
    state_err = state_ratio = None
    if return_state:
        serr = (out[1] - exp[1]).abs()
        state_err = serr.max().item()
        state_ratio = (serr / (SSD_STATE_TOL["atol"] + SSD_STATE_TOL["rtol"] * exp[1].abs())
                       ).max().item()
        ok = ok and state_ratio <= 1.0
    # each input read once, each output written once; the work the data
    # needs: the causal half of each chunk's (c x c) products, and the
    # inter-chunk term only where the entering state is not the zero start
    es = x.element_size()
    nbytes = B * S * (d_in + 2 * gn) * es + B * S * H * 4 + 2 * H * 4 + B * S * d_in * es \
        + (B * H * P * N * 4 if return_state else 0)
    c = min(chunk, S)
    flops = 0.0
    for c0 in range(0, S, c):
        nv = min(c, S - c0)
        pairs = nv * (nv + 1) / 2
        flops += 2 * (N + P) * pairs + 2 * nv * P * N * (2 if c0 else 1)
    b_ms, b_by = bound(nbytes, flops * B * H, dt)
    row = {
        "phase": "kernel", "kernel": "ssd", "case": name,
        "B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": chunk, "dtype": dt,
        "D": with_d, "return_state": return_state,
        "max_abs_err": err, "err_over_limit": ratio,
        "state_max_abs_err": state_err, "state_err_over_limit": state_ratio, "ok": bool(ok),
        "kernel_ms": time_ms(torch, lambda: smod.ssd(x, dtv, A, Bm, Cm, D, **kw), 20, flush),
        "call_ms": call_ms(torch, lambda: smod.ssd(x, dtv, A, Bm, Cm, D, **kw)),
        "plain_ms": time_ms(torch, lambda: smod.ssd_plain(x, dtv, A, Bm, Cm, D, **kw), 5, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes the SSD scan
    }
    if ops is not None:
        def run(t, fn):
            views = (t[0][..., :d_in].reshape(B, S, H, P), t[1], t[2],
                     t[0][..., d_in:d_in + gn].reshape(B, S, G, N),
                     t[0][..., d_in + gn:].reshape(B, S, G, N), t[3] if with_d else None)
            return (ops.ssd_scan if fn else smod.ssd_plain)(*views, chunk=chunk)

        go = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
        row.update(grad_check(torch, flush, run, [xbc, dtv, A] + ([D] if with_d else []), go))
    emit(row)
    check(ok, f"ssd {name}: y error {ratio:.3g}x its limit (max_abs_err {err}), "
              f"state error {state_ratio}x its limit")
    check(ops is None or row["grads_equal_plain"],
          f"ssd {name}: gradients differ from the plain version's by "
          f"{row.get('grad_max_abs_diff')}")
    return row


def mlstm_case(torch, mmod, flush, dev, name, B, S, H, D, dt, model_gates, chunks=1, ops=None):
    """q, k, v in ``dt``, fp32 gates: with ``model_gates`` in the ranges of
    xlstm's gate biases (i near -10, f biases 3-6), else the JAX test's
    (i ~ N(0,1), f ~ N(2,1)).  ``kernel_ms`` times the wrapper's device
    work: the kernels and the F cumsum it computes first.  With ``chunks``
    > 1 (bf16 only) the scratch cap is lowered for this case until the
    wrapper runs at least that many query-row chunks, and the output must
    equal the one-chunk run's bit for bit.  With ``ops`` (the dispatch
    module: a training shape) also `grad_check`."""
    g = torch.Generator(device=dev).manual_seed(B * S + H + D)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(getattr(torch, dt))
               for _ in range(3))
    ig = torch.randn((B, S, H), generator=g, device=dev)
    fg = torch.randn((B, S, H), generator=g, device=dev) + 2.0
    if model_gates:
        ig = ig * 0.1 - 10.0
        fg = fg * 0.1 + torch.linspace(3.0, 6.0, H, device=dev)
    whole = mmod.mlstm(q, k, v, ig, fg) if chunks > 1 else None
    cap = mmod.SCRATCH_CAP_BYTES
    while len(mmod.plan_chunks(B * H, S, cap)) < chunks:
        cap //= 2
    chunks = len(mmod.plan_chunks(B * H, S, cap))
    default_cap, mmod.SCRATCH_CAP_BYTES = mmod.SCRATCH_CAP_BYTES, cap
    try:
        out = mmod.mlstm(q, k, v, ig, fg)
        exp = mmod.mlstm_plain(q, k, v, ig, fg)
        torch.cuda.synchronize()
        check(whole is None or torch.equal(out, whole),
              f"mlstm {name}: {chunks} query-row chunks differ from one")
        kernel_ms = time_ms(torch, lambda: mmod.mlstm(q, k, v, ig, fg), 20, flush)
        wrapper_ms = call_ms(torch, lambda: mmod.mlstm(q, k, v, ig, fg))
    finally:
        mmod.SCRATCH_CAP_BYTES = default_cap
    if dt == "float32":
        err_t = (out - exp).abs()
        ratio = (err_t / (MLSTM_F32_TOL["atol"] + MLSTM_F32_TOL["rtol"] * exp.abs())).max().item()
        ok, err = ratio <= 1.0, err_t.max().item()
    else:
        ok, err, ratio = compare(out, exp, False)
    # each input read once (q, k, v, both gates), the output written once;
    # the causal pairs' q.k and w.v products
    es = q.element_size()
    nbytes = 4 * B * S * H * D * es + 2 * B * S * H * 4
    flops = 4.0 * D * B * H * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops, dt)
    row = {
        "phase": "kernel", "kernel": "mlstm", "case": name,
        "B": B, "S": S, "H": H, "D": D, "dtype": dt, "model_gates": model_gates,
        "route": mmod.ROUTES[q.dtype], "chunks": chunks,
        "max_abs_err": err, "err_over_limit": ratio, "ok": bool(ok),
        "kernel_ms": kernel_ms, "call_ms": wrapper_ms,
        "plain_ms": time_ms(torch, lambda: mmod.mlstm_plain(q, k, v, ig, fg), 5, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes the mLSTM cell
    }
    if ops is not None:
        go = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        row.update(grad_check(torch, flush, lambda t, fn: (
            ops.mlstm_parallel if fn else mmod.mlstm_plain)(*t), [q, k, v, ig, fg], go))
    emit(row)
    check(ok, f"mlstm {name}: error {ratio:.3g}x its limit (max_abs_err {err})")
    check(ops is None or row["grads_equal_plain"],
          f"mlstm {name}: gradients differ from the plain version's by "
          f"{row.get('grad_max_abs_diff')}")
    return row


def phase_mlstm(torch, mmod, ops, dev):
    """The mLSTM cases: xlstm-1.3b's serving shapes (H=4, D=1024, bf16)
    first, then a long stateless forward, the JAX test's gates at a head
    dim that is not a multiple of 128, runs split into query-row chunks by
    a lowered scratch cap, ragged fp32 cases, and with the gradient check
    the train step's shape (``TRAIN_SHAPE``, phase 5e) and 2 x 1024."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for case in (
        ("serve-300", 1, 300, 4, 1024, "bfloat16", True),
        ("serve-16", 1, 16, 4, 1024, "bfloat16", True),
        ("forward-2x2048", 2, 2048, 4, 1024, "bfloat16", True),
        ("jax-gates-77-d192", 2, 77, 3, 192, "bfloat16", False),
        ("chunked-300", 1, 300, 4, 1024, "bfloat16", True, 3),
        ("chunked-2x2048", 2, 2048, 4, 1024, "bfloat16", True, 4),
        ("s1-f32-d64", 2, 1, 4, 64, "float32", False),
        ("s17-f32-d64", 2, 17, 4, 64, "float32", False),
        ("s1000-f32-d64", 2, 1000, 4, 64, "float32", False),
        ("serve-300-f32", 1, 300, 4, 1024, "float32", True),
    ):
        rows.append(mlstm_case(torch, mmod, flush, dev, *case))
    # the train step's shape (phase 5e) and 2 rows x 1024, xlstm-1.3b
    # heads, through ops.mlstm_parallel under autograd
    B, S = TRAIN_SHAPE["xlstm-1.3b"]
    rows.append(mlstm_case(torch, mmod, flush, dev, MLSTM_TRAIN_CASE, B, S, 4, 1024,
                           "bfloat16", True, ops=ops))
    rows.append(mlstm_case(torch, mmod, flush, dev, "grad-2x1024", 2, 1024, 4, 1024,
                           "bfloat16", True, ops=ops))
    del flush
    return rows


def phase_kernels(torch, dmod, fmod, smod, ops, dev):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    S = 4096
    clen8 = [S, S // 2, 17, 1, 3000, 1024, S - 1, 512]
    rows = {"decode_attention": [], "flash_attention": [], "ssd": []}
    d = lambda *a, **k: rows["decode_attention"].append(  # noqa: E731
        decode_case(torch, F, dmod, flush, dev, *a, **k))
    f = lambda *a, **k: rows["flash_attention"].append(  # noqa: E731
        flash_case(torch, F, fmod, flush, dev, *a, **k))
    m = lambda *a, **k: rows["ssd"].append(  # noqa: E731
        ssd_case(torch, F, smod, flush, dev, *a, **k))
    # the serving shapes of phase 3 first: 4 slots x 1024 positions, llama3-8b
    # heads, bf16 q against the default fp32 cache; prefill groups of one
    # prompt (requests arrive apart), right-padded to a multiple of 16: the
    # longest (300 -> 304) and the shortest (16, one block of 16 live rows)
    d("serve", 4, 1024, 8, 4, 128, [332, 48, 305, 17], "bfloat16", "float32")
    f("serve-304", 1, 304, 304, 8, 4, 128, "bfloat16")
    f("serve-16", 1, 16, 16, 8, 4, 128, "bfloat16")
    # the train step's shape (phase 5a): llama3-8b heads, 2 rows x 1024
    f("train-2x1024", 2, 1024, 1024, 8, 4, 128, "bfloat16")
    # the serving shapes of phase 3b: zamba2's shared block is MHA (group 1)
    # at head_dim 64; its prefill groups have the exact prompt length; every
    # Mamba layer's scan runs at H=64, P=N=64, G=2 (two full chunks + 44
    # rows at the longest prompt, one partial chunk at the shortest)
    d("zamba2-serve", 4, 1024, 32, 1, 64, [332, 48, 305, 17], "bfloat16", "float32")
    f("zamba2-serve-300", 1, 300, 300, 32, 1, 64, "bfloat16")
    f("zamba2-serve-16", 1, 16, 16, 32, 1, 64, "bfloat16")
    # the train step's shapes (phase 5d): the shared block's MHA and every
    # Mamba layer's scan at 2 rows x 1024 (8 chunks: one cluster launch),
    # through ops under autograd
    f("zamba2-train-2x1024", 2, 1024, 1024, 32, 1, 64, "bfloat16", ops=ops)
    # the serving shapes of phase 3d: olmoe-1b-7b is MHA (group 1) at
    # head_dim 128; prefill groups right-padded to a multiple of 16 (304),
    # and one ragged length
    d("olmoe-serve", 4, 1024, 16, 1, 128, [332, 48, 305, 17], "bfloat16", "float32")
    f("olmoe-serve-304", 1, 304, 304, 16, 1, 128, "bfloat16")
    f("olmoe-ragged-77", 1, 77, 77, 16, 1, 128, "bfloat16")
    # the serving shapes of phase 3f: whisper-large-v3 is MHA (group 1) at
    # head_dim 64; its encoder attends non-causally over 1500 frames (4
    # rows), its cross-attention runs 4 prompt rows (prefill) and one row
    # (decode) per batch row against the 1500 encoder rows; self-attention
    # decodes over at most 448 positions (lengths 0, 1, 447, 448 here)
    f("whisper-encoder-4x1500", 4, 1500, 1500, 20, 1, 64, "bfloat16", causal=False)
    f("whisper-encoder-1500-f32", 1, 1500, 1500, 20, 1, 64, "float32", causal=False)
    f("whisper-cross-prefill-4x1500", 4, 4, 1500, 20, 1, 64, "bfloat16", causal=False)
    f("whisper-cross-decode-1x1500", 4, 1, 1500, 20, 1, 64, "bfloat16", causal=False,
      yardstick=dmod)
    d("whisper-self", 4, 448, 20, 1, 64, [0, 1, 447, 448], "bfloat16", "float32")
    # the serving shapes of phase 3g: internvl2-1b is GQA 14/2 (group 7) at
    # head_dim 64; prefill of a 256-row prefix + 4 text tokens (4 rows), a
    # text bucket of 304; decode at serving lengths and at the tile edges
    d("internvl2-serve", 4, 1024, 2, 7, 64, [332, 48, 305, 17], "bfloat16", "float32")
    d("internvl2-edges", 8, 1024, 2, 7, 64, [0, 1, 15, 16, 17, 299, 1023, 1024],
      "bfloat16", "float32")
    f("internvl2-prefix-4x260", 4, 260, 260, 2, 7, 64, "bfloat16")
    f("internvl2-serve-304", 1, 304, 304, 2, 7, 64, "bfloat16")
    m("serve-300", 1, 300, 64, 2, "bfloat16")
    m("serve-16", 1, 16, 64, 2, "bfloat16")
    m("forward-4x2048", 4, 2048, 64, 2, "bfloat16", return_state=False)
    m("serve-300-f32", 1, 300, 64, 2, "float32")
    m("serve-16-f32", 1, 16, 64, 2, "float32")
    m("s128-bf16", 1, 128, 64, 2, "bfloat16")
    m("s128-f32-noD", 1, 128, 64, 2, "float32", with_d=False)
    m("g1-300-bf16", 1, 300, 64, 1, "bfloat16")
    m("chunk64-300-bf16", 2, 300, 64, 2, "bfloat16", chunk=64)
    m("train-2x1024", 2, 1024, 64, 2, "bfloat16", return_state=False, ops=ops)
    # every other (P, N) the kernels take (smod.WIDTHS): the reduced
    # configs' (16, 16), the JAX kernel tests' (16, 8), (32, 16), (8, 4) and
    # Mamba2's published N = 128, at 16 heads: one serving prompt with its
    # final state in both dtypes, and 9 chunks in bf16 (three launches)
    for P, N in smod.WIDTHS[1:]:
        for dt in ("bfloat16", "float32"):
            m(f"p{P}n{N}-300-{dt}", 1, 300, 16, 2, dt, P=P, N=N)
        m(f"p{P}n{N}-2x1100-bfloat16", 2, 1100, 16, 2, "bfloat16", return_state=False, P=P, N=N)
    for G in (4, 8):
        d(f"g{G}-bf16", 8, S, 8, G, 128, clen8, "bfloat16", "bfloat16")
        d(f"g{G}-bf16q-f32cache", 8, S, 8, G, 128, clen8, "bfloat16", "float32")
    d("g4-f32", 8, S, 8, 4, 128, clen8, "float32", "float32")
    d("g4-window1024", 8, S, 8, 4, 128, clen8, "bfloat16", "bfloat16", window=1024)
    d("g4-softcap50", 8, S, 8, 4, 128, clen8, "bfloat16", "bfloat16", cap=50.0)
    # live lengths at the tile edges in one batch (0, 1, 15, 16, 17, S - 1,
    # S), a window that starts mid-tile, and a shape for each cluster size
    # the host picks (B*K sets splits to 8, 4, 2, 1)
    edges = [0, 1, 15, 16, 17, 299, 300, 150]
    for K in (4, 8, 16, 64):
        d(f"edges-k{K}-bf16", 8, 300, K, 2, 64, edges, "bfloat16", "bfloat16")
    d("edges-window37-f32", 8, 300, 8, 4, 64, edges, "float32", "float32", window=37)
    d("edges-window37-bf16q-f32cache", 8, 300, 8, 4, 128, edges, "bfloat16", "float32", window=37)
    for Sq in (77, 512):
        for dt in ("bfloat16", "float32"):
            f(f"causal-{Sq}-{dt}", 4, Sq, Sq, 8, 4, 128, dt)
    f("window128-512", 4, 512, 512, 8, 4, 128, "bfloat16", window=128)
    f("softcap50-512", 4, 512, 512, 8, 4, 128, "bfloat16", cap=50.0)
    f("qoffset435-77x512", 4, 77, 512, 8, 4, 128, "bfloat16", q_offset=435)
    f("full-512-f32", 4, 512, 512, 8, 4, 128, "float32", causal=False)
    f("d32-300", 1, 300, 300, 16, 1, 32, "bfloat16")
    f("group8-300", 1, 300, 300, 4, 8, 128, "bfloat16")
    del flush
    return rows


# ---------------------------------------------------------------------------
# phase 3: each family at full width behind the continuous-batching engine
# ---------------------------------------------------------------------------

def reset_counters(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0
        for r in getattr(fn, "route_launches", {}):
            fn.route_launches[r] = 0


def tree_bytes(port, tree) -> int:
    return sum(t.numel() * t.element_size() for t in port["tree_flatten"](tree)[0])


def phase_serve(torch, np, port, dev, card, cfg, kernels, idle=()):
    """Serve ``cfg`` (full width; depth as given); ``kernels`` names the
    wrappers of its path, each of which must launch during this phase, and
    ``idle`` the wrappers that must not (a path that takes plain PyTorch
    by shape)."""
    arch = cfg.name
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = port["init_params"](cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in port["tree_flatten"](params)[0])
    scfg = port["ServeConfig"](max_batch=4, max_len=1024, max_new_tokens=32)
    eng = port["ContinuousEngine"](cfg, params, scfg, device=dev)
    eng.admit([("warm", [1, 2, 3], 2)])  # allocator and first-call warmup
    while eng.n_live():
        eng.step_chunk()
    for k in eng.stats:
        eng.stats[k] = 0

    rp, store, kv = port["rp"], port["ObjectStore"](), port["KVStore"](num_shards=2)
    rng = np.random.default_rng(0)
    lens = [16, 300, 57, 128, 200, 33, 271, 90]
    ids = [f"req-{i}" for i in range(len(lens))]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]

    def client():  # open-loop arrivals, so requests join a running batch
        for r, p in zip(ids, prompts):
            rp.submit(store, kv, r, p)
            time.sleep(SUBMIT_GAP_S)

    wrappers = port["wrappers"]
    reset_counters(wrappers)
    t0 = time.perf_counter()
    sender = threading.Thread(target=client, name="chip-smoke-client")
    sender.start()
    stats = eng.run(store, kv, engine_id="chip", idle_timeout_s=5.0, max_requests=len(ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sender.join(timeout=60)
    check(not sender.is_alive(), "client thread did not finish")
    launches = {name: wrappers[name].launches for name in (*kernels, *idle)}
    routes = {name: dict(wrappers[name].route_launches) for name in kernels
              if hasattr(wrappers[name], "route_launches")}

    res = rp.get_results(store, ids, timeout_s=10)
    bodies = store.get_many([rp.req_key(r) for r in ids], missing="error")
    markers = {r: [c for c in kv.lrange(rp.stream_key(r)) if "done" in c] for r in ids}
    ttft = sorted(res[r]["t_first"] - bodies[rp.req_key(r)]["ts"] for r in ids)
    row = {
        "phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": n_params, "init_s": init_s, "max_batch": 4, "max_len": 1024,
        "cache_dtype": scfg.cache_dtype, "requests": len(ids), "prompt_lens": lens,
        "published": len(res), "served": stats["served"], "tokens_out": stats["tokens_out"],
        "wall_s": wall, "tok_per_s": stats["tokens_out"] / wall,
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "decode_steps": stats["decode_steps"], "prefill_groups": stats["prefill_groups"],
        "mid_batch_admissions": stats["mid_batch_admissions"],
        "launches": launches, "route_launches": routes, "card": card,
    }
    emit(row)
    check(stats["served"] == len(ids) and len(res) == len(ids), "not every request was served")
    for r in ids:
        toks = res[r]["tokens"]
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"{r}: {len(toks)} tokens, expected 32 in range")
        check(len(markers[r]) == 1 and markers[r][0]["done"] == 32,
              f"{r}: published {len(markers[r])} times")
    check(stats["mid_batch_admissions"] > 0, "no request was admitted mid-batch")
    for name in kernels:
        check(launches[name] > 0, f"{name} kernel never launched on the {arch} serving path")
    for name in idle:
        check(launches[name] == 0, f"{name} kernel launched {launches[name]} times on the "
                                   f"{arch} serving path, which takes plain PyTorch by shape")
    for name, by_route in routes.items():  # bf16 serving runs the tensor-core kernels
        check(by_route["mma"] == launches[name],
              f"{name}: {by_route} of {launches[name]} launches on the tensor-core route")
    # the weights a decode step reads: all but the MTP head, which only
    # `forward` runs
    weight_bytes = tree_bytes(port, {k: v for k, v in params.items() if k != "mtp"})
    # a recurrent family reads and writes its whole state every step
    state_bytes = tree_bytes(port, eng.cache) if cfg.family == "ssm" else 0
    profile_decode(torch, np, eng, cfg, weight_bytes, state_bytes)
    profile_prefill(torch, port, params, cfg, dev)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def generate_run(torch, np, port, dev, cfg, params, extras, max_len, seed=0):
    """`Engine.generate` over ``GEN_ROWS`` rows of a ``GEN_PROMPT``-token
    prompt each plus ``extras`` (numpy), ``GEN_NEW`` greedy tokens, with
    the kernel counters set to 0 just before -> (tokens, launches, flash
    launches by route, wall s, prompts)."""
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(GEN_ROWS, GEN_PROMPT))
    scfg = port["ServeConfig"](max_batch=GEN_ROWS, max_len=max_len, max_new_tokens=GEN_NEW)
    eng = port["Engine"](cfg, params, scfg, device=dev)
    wrappers = port["wrappers"]
    reset_counters(wrappers)
    t0 = time.perf_counter()
    out = eng.generate(prompts, extras=extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    routes = dict(wrappers["flash_attention"].route_launches)
    check(out.shape == (GEN_ROWS, GEN_NEW) and ((out >= 0) & (out < cfg.vocab_size)).all(),
          f"{cfg.name}: {out.shape} tokens, expected {GEN_NEW} per row in range")
    return out, launches, routes, wall, prompts


def check_counts(cfg, launches, routes, expect) -> None:
    for name, n in expect.items():
        check(launches[name] == n, f"{cfg.name}: {launches[name]} {name} launches, the code "
                                   f"implies {n}")
    for name in ("ssd", "mlstm"):
        check(launches[name] == 0, f"{cfg.name}: {name} launched {launches[name]} times")
    check(routes["mma"] == launches["flash_attention"],
          f"{cfg.name}: flash {routes} of {launches['flash_attention']} on the tensor-core route")


def phase_whisper(torch, np, port, dev, card, cfg):
    """whisper-large-v3 at full width and depth through `Engine.generate`
    with 1500 random audio frames per row; launch counts held to what the
    code implies; negated frames must change the tokens or the logits; the
    encoder's device time, a prefill profile and a decode-step profile."""
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = port["init_params"](cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    shape = (GEN_ROWS, cfg.encoder_seq, cfg.d_model)
    frames = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    max_len = cfg.max_target_positions
    out, launches, routes, wall, prompts = generate_run(
        torch, np, port, dev, cfg, params, {"audio_frames": frames}, max_len)
    neg, *_ = generate_run(torch, np, port, dev, cfg, params, {"audio_frames": -frames}, max_len)
    batch = {"tokens": torch.as_tensor(prompts, device=dev),
             "audio_frames": torch.as_tensor(frames, device=dev)}
    init_cache, prefill = port["init_cache"], port["prefill"]
    lg = prefill(params, cfg, batch, init_cache(cfg, GEN_ROWS, max_len, torch.float32, dev))[0]
    lg_neg = prefill(params, cfg, {**batch, "audio_frames": -batch["audio_frames"]},
                     init_cache(cfg, GEN_ROWS, max_len, torch.float32, dev))[0]
    logit_diff = (lg - lg_neg).abs().max().item()
    L, L_enc = cfg.n_layers, cfg.n_encoder_layers
    # per encoder layer one flash launch; per decoder layer a self- and a
    # cross-attention flash in prefill, then per decode call one cross
    # flash and one decode launch (generate decodes after every token)
    expect = {"flash_attention": L_enc + 2 * L + GEN_NEW * L, "decode_attention": GEN_NEW * L}
    # the encoder alone on the batch, between two events (launch gaps included)
    h = batch["audio_frames"].to(getattr(torch, cfg.dtype)) + params["enc_pos"][None]
    port["transformer"].encoder_stage_apply(params["encoder"], h, cfg)
    s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s_ev.record()
    port["transformer"].encoder_stage_apply(params["encoder"], h, cfg)
    e_ev.record()
    e_ev.synchronize()
    emit({
        "phase": "generate", "arch": cfg.name, "n_layers": L, "n_encoder_layers": L_enc,
        "d_model": cfg.d_model, "init_s": init_s,
        "params": sum(t.numel() for t in port["tree_flatten"](params)[0]),
        "rows": GEN_ROWS, "prompt_len": GEN_PROMPT, "new_tokens": GEN_NEW,
        "audio_frames": list(shape), "max_len": max_len, "cache_dtype": "float32",
        "wall_s": wall, "tok_per_s": GEN_ROWS * GEN_NEW / wall, "launches": launches,
        "expected_launches": expect, "flash_route_launches": routes,
        "tokens_row0": out[0].tolist(), "negated_frames_tokens_differ": bool((out != neg).any()),
        "negated_frames_prefill_logit_max_diff": logit_diff,
        "encoder_event_ms": s_ev.elapsed_time(e_ev), "card": card,
    })
    check_counts(cfg, launches, routes, expect)
    check(bool((out != neg).any()) or logit_diff > 1e-4,
          "whisper: negated audio frames changed neither the tokens nor the logits")
    profile_prefill(torch, port, params, cfg, dev, batch=batch, max_len=max_len)
    # decode steps after a prefill of the batch: the decoder's weights (not
    # the encoder's, which decode never reads) and the cross cache once
    cache = init_cache(cfg, GEN_ROWS, max_len, torch.float32, dev)
    lg, cache, clen = prefill(params, cfg, batch, cache)
    state = {"tok": lg[:, -1].argmax(-1), "clen": clen}

    def run(n):
        for _ in range(n):
            step, _ = port["decode_step"](params, cfg, state["tok"][:, None], cache, state["clen"])
            state["clen"] += 1
            state["tok"] = step[:, 0].argmax(-1)

    run(2)
    enc_keys = ("encoder", "enc_pos", "encoder_norm")
    weight_bytes = tree_bytes(port, {k: v for k, v in params.items() if k not in enc_keys})
    cross_bytes = tree_bytes(port, [c["cross"] for c in cache["decoder"]])
    step_profile(torch, cfg, lambda: run(8), 8, weight_bytes, cross_bytes=cross_bytes)
    del params, cache
    torch.cuda.empty_cache()
    return launches


def phase_vlm_prefix(torch, np, port, dev, card, cfg):
    """internvl2-1b at full width and depth through `Engine.generate` with a
    ``num_prefix_tokens``-row random ``prefix_embed`` per row: the prefill
    length counts the prefix, launch counts held to what the code implies;
    then the prefill's profile."""
    params = port["init_params"](cfg, torch.Generator(device=dev).manual_seed(0), dev)
    P = cfg.num_prefix_tokens
    rng = np.random.default_rng(1)
    prefix = (rng.standard_normal((GEN_ROWS, P, cfg.d_model)) * 0.1).astype(np.float32)
    out, launches, routes, wall, prompts = generate_run(
        torch, np, port, dev, cfg, params, {"prefix_embed": prefix}, 1024)
    batch = {"tokens": torch.as_tensor(prompts, device=dev),
             "prefix_embed": torch.as_tensor(prefix, device=dev)}
    _, _, n = port["prefill"](params, cfg, batch,
                              port["init_cache"](cfg, GEN_ROWS, 1024, torch.float32, dev))
    L = cfg.n_layers
    expect = {"flash_attention": L, "decode_attention": GEN_NEW * L}
    emit({
        "phase": "generate", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
        "rows": GEN_ROWS, "prefix_rows": P, "prompt_len": GEN_PROMPT, "prefill_len": n,
        "new_tokens": GEN_NEW, "wall_s": wall, "tok_per_s": GEN_ROWS * GEN_NEW / wall,
        "launches": launches, "expected_launches": expect, "flash_route_launches": routes,
        "tokens_row0": out[0].tolist(), "card": card,
    })
    check(n == P + GEN_PROMPT, f"internvl2 prefill length {n}, expected {P} + {GEN_PROMPT}")
    check_counts(cfg, launches, routes, expect)
    profile_prefill(torch, port, params, cfg, dev, batch=batch)
    del params
    torch.cuda.empty_cache()
    return launches


def profile_decode(torch, np, eng, cfg, weight_bytes, state_bytes, n_steps=8):
    """Where a decode step's time goes with all 4 slots of ``eng`` live (see
    `step_profile`)."""
    rng = np.random.default_rng(1)
    eng.admit([(f"prof-{i}", rng.integers(0, cfg.vocab_size, size=n).tolist(), 10**6)
               for i, n in enumerate(DECODE_SLOT_LENS)])
    eng.step_chunk(2)
    step_profile(torch, cfg, lambda: eng.step_chunk(n_steps), n_steps, weight_bytes, state_bytes)


def step_profile(torch, cfg, run, n_steps, weight_bytes, state_bytes=0, cross_bytes=0):
    """``run`` takes ``n_steps`` decode steps: host-clock step time,
    device-busy time per step (the sum of the kernels `torch.profiler` saw,
    one stream so no overlap), the idle share, the least step time (the
    weights read once, a recurrent state read and written once, an
    enc-dec's cross cache read once), and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev, busy_ms, top = device_summary(prof, n_steps)
    summary_s = time.perf_counter() - t0
    hbm = hardware().HBM_BW
    row = {
        "phase": "serve_profile", "arch": cfg.name, "live_slots": 4, "steps": n_steps,
        "profiler_saw_device": bool(ev),
        "step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
        "device_launches_per_step": sum(e.count for e in ev) / n_steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "weights_bound_ms": weight_bytes / hbm * 1e3,
        "state_bound_ms": 2 * state_bytes / hbm * 1e3,
        "cross_cache_bound_ms": cross_bytes / hbm * 1e3,
        "least_step_ms": (weight_bytes + 2 * state_bytes + cross_bytes) / hbm * 1e3,
        "top_device_ms_per_step": top, "profile_summary_s": summary_s,
    }
    emit(row)
    MEASURED.setdefault(f"{cfg.name}-decode", row)  # phase 10 reads phase 3's


DeviceEvents = collections.namedtuple("DeviceEvents", "key self_device_time_total count")


def raw_events(prof):
    """The finished profile's events as the tracer recorded them.  Read
    from these, a summary costs about a microsecond an event; ``key_averages``
    and ``events`` first turn every host event into a Python object (about
    90 us each on the host, 17-43 s for one profiled train step)."""
    return prof.profiler.kineto_results.events()


def device_summary(prof, n, annotations=()):
    """(device events, device-busy ms per run, the 8 largest [name, ms per
    run, launches per run]) of a profile over ``n`` runs, as
    ``key_averages`` groups them: by demangled name, each with its device
    time in us and its count.  Device-side events only: an operator's
    entry repeats its kernels' time; the device-side copies of
    ``record_function`` ranges named in ``annotations`` are left out (they
    span kernels counted already).  The sum of the events' counts over
    ``n`` is the device launches per run."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name

    by_key = {}
    for e in raw_events(prof):
        if e.device_type() != DeviceType.CUDA:
            continue
        key = _rewrite_name(e.name(), with_wildcard=True)
        us, count = by_key.get(key, (0.0, 0))
        by_key[key] = (us + e.duration_ns() / 1e3, count + 1)
    ev = [DeviceEvents(k, us, c) for k, (us, c) in by_key.items()
          if us > 0 and k not in annotations]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    return ev, busy_ms, [[e.key[:80], e.self_device_time_total / 1e3 / n, e.count // n]
                         for e in top]


def range_device_time(prof, names):
    """{name: [calls, device us]} of the host-side ``record_function``
    ranges named ``names``: the calls, and the device time of the kernels
    launched inside them, as ``events()`` gives a range's
    ``device_time_total``: a device event belongs to the host op whose
    correlation id it is linked to, and that op to the range that holds
    its start on its thread."""
    from torch.autograd import DeviceType

    spans, op_at, device = {}, {}, []
    for e in raw_events(prof):
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() != 0:  # a runtime call, tied to its op
                continue
            if e.name() in names:
                spans.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), e.name()))
            op_at[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        else:
            device.append((e.linked_correlation_id(), e.duration_ns()))
    out = {name: [0, 0.0] for name in names}
    for rows in spans.values():
        rows.sort()
        for _, _, name in rows:
            out[name][0] += 1
    starts = {thread: [r[0] for r in rows] for thread, rows in spans.items()}
    for corr, ns in device:
        thread, t = op_at.get(corr, (None, 0))
        if thread not in spans:
            continue
        i = bisect.bisect_right(starts[thread], t) - 1  # these ranges do not nest
        if i >= 0 and t <= spans[thread][i][1]:
            out[spans[thread][i][2]][1] += ns / 1e3
    return out


def profile_prefill(torch, port, params, cfg, dev, n_tok=300, batch=None, max_len=1024):
    """Where the time of one ``n_tok``-token prefill goes (what a request's
    TTFT pays once admitted), or of one prefill of ``batch`` where given:
    host-clock ms, device busy, the idle share, the largest kernels; for
    xLSTM also the host-clock ms of its sLSTM blocks alone (their
    recurrence runs one eager step per token)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(3)
    if batch is None:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n_tok), generator=g, device=dev)}
    B, n_tok = batch["tokens"].shape

    def run():
        cache = port["init_cache"](cfg, B, max_len, torch.float32, dev)
        port["prefill"](params, cfg, batch, cache)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    t0 = time.perf_counter()
    ev, busy_ms, top = device_summary(prof, 1)
    summary_s = time.perf_counter() - t0
    row = {
        "phase": "prefill_profile", "arch": cfg.name, "batch": B, "prompt_len": n_tok,
        "inputs": {k: list(v.shape) for k, v in batch.items()},
        "profiler_saw_device": bool(ev), "prefill_ms": prefill_ms, "device_busy_ms": busy_ms,
        "device_launches": sum(e.count for e in ev),
        "device_idle_share": max(0.0, 1.0 - busy_ms / prefill_ms), "top_device_ms": top,
        "profile_summary_s": summary_s,
    }
    if cfg.family == "ssm":
        xl = port["xlstm"]
        h = torch.randn((1, n_tok, cfg.d_model), generator=g, device=dev).to(getattr(torch, cfg.dtype))
        t0 = time.perf_counter()
        for grp in params["decoder"]:
            xl.slstm_block_apply(grp["s"], h, cfg, state=xl.init_slstm_state(cfg, 1, dev))
        torch.cuda.synchronize()
        row["slstm_blocks"] = len(params["decoder"])
        row["slstm_ms"] = (time.perf_counter() - t0) * 1e3
    emit(row)


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU at full width, few layers, fp32
# ---------------------------------------------------------------------------

def route_recorder(torch, moe):
    """Wrap ``moe._route`` to record, per call, each token's selection
    scores (what top-k picks from: softmax probabilities, or sigmoid
    scores plus the bias with MLA) and the picked experts, on the CPU.
    Returns (records, undo)."""
    records, orig = [], moe._route

    def rec(p, tokens, cfg):
        gates, idx, aux = orig(p, tokens, cfg)
        logits = tokens.float() @ p["router"]
        sel = (torch.sigmoid(logits) + p["router_bias"] if cfg.mla is not None
               else torch.softmax(logits, dim=-1))
        records.append((sel.cpu(), idx.cpu()))
        return gates, idx, aux

    moe._route = rec
    return records, lambda: setattr(moe, "_route", orig)


def router_summary(torch, rec_g, rec_c, k):
    """The router error between the devices (max |score difference|), the
    calls whose picked experts differ, and the smallest margin between the
    k-th and (k+1)-th selection score on the CPU: a margin below the error
    is a near-tie the devices may break apart."""
    check(len(rec_g) == len(rec_c), f"router calls {len(rec_g)} on cuda, {len(rec_c)} on cpu")
    err, differ, margin = 0.0, 0, float("inf")
    for (sg, ig), (sc, ic) in zip(rec_g, rec_c):
        err = max(err, (sg - sc).abs().max().item())
        differ += int(not torch.equal(ig, ic))
        top = sc.topk(k + 1, dim=-1).values
        margin = min(margin, (top[:, k - 1] - top[:, k]).min().item())
    return {"router_calls": len(rec_c), "router_max_abs_err": err,
            "router_calls_with_other_experts": differ, "router_min_topk_margin": margin}


def phase_consistency(torch, port, dev, arch, n_layers, lens, with_forward=False, **changes):
    """Prefill one prompt per entry of ``lens`` (right-padded to the
    longest), then 4 greedy decode steps, on the card and on the CPU from
    the same weights; with ``with_forward`` also ``forward`` over prompt +
    decoded tokens (all rows one length), and its MTP logits where the
    model has the head.  ``changes`` replace fields of the config (a MoE
    cut).  For MoE also the router's scores on both devices."""
    cfg = dataclasses.replace(
        port["CONFIGS"][arch], n_layers=n_layers, dtype="float32", param_dtype="float32",
        **changes,
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    p_gpu = port["init_params"](cfg, gen, dev)
    p_cpu = port["tree_map"](lambda t: t.cpu(), p_gpu)
    prefill, decode_step, init_cache = port["prefill"], port["decode_step"], port["init_cache"]
    lens = torch.tensor(lens)
    B, L = len(lens), int(lens.max())
    cpu_gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=cpu_gen)
    extras, P = {}, 0  # the family's stub input at scale 0.1, from the same generator
    if cfg.family == "encdec":
        extras["audio_frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=cpu_gen) * 0.1
    if cfg.frontend == "vision_stub":
        P = cfg.num_prefix_tokens
        extras["prefix_embed"] = torch.randn((B, P, cfg.d_model), generator=cpu_gen) * 0.1
    results, routes = {}, {}
    for name, p, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
        records, undo = route_recorder(torch, port["moe"])
        ex = {k: v.to(d) for k, v in extras.items()}
        try:
            cache = init_cache(cfg, B, P + L + 16, torch.float32, d)
            logits, cache, _ = prefill(p, cfg, {"tokens": toks.to(d), **ex}, cache, all_logits=True)
            last = logits[torch.arange(B, device=d), (P + lens - 1).to(d)]
            steps, tok, clen = [last.cpu()], last.argmax(-1), (P + lens).to(d).to(torch.int32)
            picked = [tok.cpu()]
            for _ in range(4):
                lg, cache = decode_step(p, cfg, tok[:, None], cache, clen)
                clen = clen + 1
                tok = lg[:, 0].argmax(-1)
                steps.append(lg[:, 0].cpu())
                picked.append(tok.cpu())
            fwd = mtp = None
            if with_forward:  # the fed tokens: the prompt and the first 4 picks
                seq = torch.cat([toks, torch.stack(picked[:4], 1)], 1).to(d)
                fwd, _, fx = port["forward"](p, cfg, {"tokens": seq, **ex})
                fwd = fwd.cpu()
                mtp = fx["mtp_logits"].cpu() if "mtp_logits" in fx else None
        finally:
            undo()
        results[name] = (torch.stack(steps), torch.stack(picked), fwd, mtp)
        routes[name] = records
    (lg_g, tk_g, fw_g, mtp_g), (lg_c, tk_c, fw_c, mtp_c) = results["cuda"], results["cpu"]
    del p_gpu
    torch.cuda.empty_cache()
    err = (lg_g - lg_c).abs().max().item()
    same = bool(torch.equal(tk_g, tk_c))
    close = bool(torch.allclose(lg_g, lg_c, atol=2e-3, rtol=1e-3))
    fwd_err = mtp_err = None
    if with_forward:
        fwd_err = (fw_g - fw_c).abs().max().item()
        close = close and bool(torch.allclose(fw_g, fw_c, atol=2e-3, rtol=1e-3))
    if cfg.mtp_depth and with_forward:
        mtp_err = (mtp_g - mtp_c).abs().max().item()
        close = close and bool(torch.allclose(mtp_g, mtp_c, atol=2e-3, rtol=1e-3))
    row = {
        "phase": "consistency", "arch": cfg.name, "n_layers": n_layers, "dtype": "float32",
        "changes": {k: str(v) for k, v in changes.items()},
        "tf32": torch.backends.cuda.matmul.allow_tf32, "prompt_lens": lens.tolist(),
        "inputs": {k: list(v.shape) for k, v in extras.items()},
        "decode_steps": 4,
        "greedy_tokens_cuda": tk_g.T.tolist(), "greedy_tokens_cpu": tk_c.T.tolist(),
        "tokens_identical": same, "max_abs_logit_err": err,
        "forward_max_abs_logit_err": fwd_err, "mtp_max_abs_logit_err": mtp_err,
        "tol": 2e-3, "ok": same and close,
    }
    if cfg.family == "moe":
        row.update(router_summary(torch, routes["cuda"], routes["cpu"], cfg.moe.top_k))
    emit(row)
    check(same, f"{arch}: greedy tokens differ between cuda and cpu")
    check(close, f"{arch}: logits differ by {err} (forward {fwd_err}, mtp {mtp_err}) > 2e-3")


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 3  # phases 5a, 5d, 5e
# phase 5e's rows x sequence: the sLSTM loop's host time grows with the
# sequence (about 25 s a step at 2 x 1024), not with the rows, so the
# sequence is cut to fit the script's time limit and the rows keep the
# 2048 tokens of a step
TRAIN_SHAPE = {"xlstm-1.3b": (4, 512)}
MLSTM_TRAIN_CASE = "train-%dx%d" % TRAIN_SHAPE["xlstm-1.3b"]  # phase 2's row at 5e's shape
# phase 5b: llama3-8b width cut to 1 layer (4 layers until phase 6 needed
# the time, 2 until the script took 1288.0 s in PR 24's proof run)
ELASTIC_LAYERS, ELASTIC_SEQ = 1, 512
# phase 5e: xlstm-1.3b cut to 1 of its 6 groups (7 mLSTM + 1 sLSTM blocks)
# to fit phases 6-8 in the time limit: the sLSTM loop and the summary of its
# profiled step grow with the depth (5e took 207.9-245.6 s at 48 blocks,
# 87.7 s at 16)
XLSTM_TRAIN_LAYERS = 8
# peak memory of the train phases.  5d and 5e: the parameters and int8
# moments measured on an H100 plus twice the rest of the measured peak
# (gradients, activations, the plain backwards' fp32 temporaries):
# zamba2 4.94 + 2 x 4.56 GB, xlstm 8.42 + 2 x 5.23 GB (at 48 blocks; 5e's
# 16-block cut stays below it)
MEM_LIMIT_GB = {
    "llama3-8b": 75.0,  # 5a: about 48 GB persistent + one leaf's temporaries
    "zamba2-1.2b": 14.0,
    "xlstm-1.3b": 19.0,
}
# per kernel of a train step: (short name, profiler range over its
# Function's backward, the plain recompute; device kernel names)
TRAIN_KERNELS = {
    "flash_attention": ("flash", "attention_backward_plain", r"flash"),
    "ssd": ("ssd", "ssd_backward_plain", r"ssd_"),
    "mlstm": ("mlstm", "mlstm_backward_plain",
              r"\b(mlstm_kernel|stabilizer_kernel|w_kernel|wv_kernel)\b"),
}
# leaves that must get a nonzero gradient, by name, in every layer that has them
TRAIN_LEAVES = {
    "llama3-8b": ("wq", "wk", "wv"),
    "zamba2-1.2b": ("in_proj", "A_log", "dt_bias", "D", "wq", "wk", "wv"),
    "xlstm-1.3b": ("w_qhw", "w_khw", "w_vhw", "w_igate", "w_fgate", "r_kernel"),
}


def train_launches(cfg):
    """Kernel launches of one train step with remat, from the
    configuration's fields: two per layer that runs a kernel (the forward,
    then the recompute in the backward).  The hybrid's layers are all Mamba
    layers, the shared block after every ``shared_attn_every`` of them; one
    xLSTM block in ``slstm_every`` is an sLSTM block."""
    if cfg.family == "hybrid":
        return {"ssd": 2 * cfg.n_layers,
                "flash_attention": 2 * (cfg.n_layers // cfg.shared_attn_every)}
    if cfg.family == "ssm":
        return {"mlstm": 2 * (cfg.n_layers - cfg.n_layers // cfg.xlstm.slstm_every)}
    return {"flash_attention": 2 * cfg.n_layers}


# the launches per step of phases 5a, 5d and 5e, as numbers: 32 attention
# layers; 38 Mamba layers and 6 shared-block calls; 7 mLSTM blocks (5e's
# 8 of 48)
TRAIN_LAUNCHES = {
    "llama3-8b": {"flash_attention": 64},
    "zamba2-1.2b": {"ssd": 76, "flash_attention": 12},
    "xlstm-1.3b": {"mlstm": 14},
}


def backward_timer(torch, fn_cls, names):
    """Wrap ``fn_cls.backward`` (the plain recompute) in a profiler range,
    named by ``names[ctx.plain]`` after the plain version it recomputes;
    -> undo."""
    from torch.profiler import record_function

    orig = fn_cls.backward

    def backward(ctx, *grads):
        with record_function(names[ctx.plain]):
            return orig(ctx, *grads)

    fn_cls.backward = staticmethod(backward)
    return lambda: setattr(fn_cls, "backward", staticmethod(orig))


def slstm_host_timer(torch, xl):
    """Add up the host-clock time of the sLSTM blocks in a train step: each
    block's forward call, and its backward from the gradient's arrival at
    its output to its arrival at its input (the remat recompute runs
    inside that span; the block's residual is inside it too, so the input's
    gradient is complete only when the block's backward is).  -> (totals,
    undo); ``totals`` is reset by the caller."""
    orig = xl.slstm_block_apply
    totals = {"forward_s": 0.0, "backward_s": 0.0}
    open_at = []

    def apply(p, h, cfg, **kw):
        t0 = time.perf_counter()
        out, state = orig(p, h, cfg, **kw)
        if open_at or not (torch.is_grad_enabled() and h.requires_grad):
            return out, state  # the recompute (inside a backward span), or no autograd
        totals["forward_s"] += time.perf_counter() - t0

        def arrived_at_output(_):
            open_at.append(time.perf_counter())

        def arrived_at_input(_):
            totals["backward_s"] += time.perf_counter() - open_at.pop()

        out.register_hook(arrived_at_output)
        h.register_hook(arrived_at_input)
        return out, state

    xl.slstm_block_apply = apply
    return totals, lambda: setattr(xl, "slstm_block_apply", orig)


def phase_train_step(torch, np, port, dev, card, cfg):
    """``cfg`` at full width and depth, bf16: int8 moments, remat, the
    fused CE, one microbatch of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens
    (``TRAIN_SHAPE`` where it names the model) and the in-place update,
    ``TRAIN_STEPS`` steps; the last one under ``torch.profiler``.  Every loss and grad norm finite; every parameter
    leaf's gradient nonzero (read from the first moment after step 1,
    which is (1 - b1) g: its int8 codes are all 0 only where g is), the
    leaves ``TRAIN_LEAVES`` names among them in every layer; exactly the
    kernel launches per step ``train_launches`` gives (forward and the
    remat recompute), all on the tensor-core route, and one plain backward
    per layer; peak memory under the phase's ``MEM_LIMIT_GB``.  The
    profiled step's device time of each kernel's forward and of each plain
    backward (a profiler range each); for the xLSTM also the sLSTM blocks'
    share of each step on the host clock."""
    import gc
    import re

    from torch.profiler import ProfilerActivity, profile

    tr = port["train"]
    batch_rows, seq = TRAIN_SHAPE.get(cfg.name, (TRAIN_BATCH, TRAIN_SEQ))
    expect = train_launches(cfg)
    check(expect == TRAIN_LAUNCHES[cfg.name],
          f"{cfg.name}: launches per step {expect}, expected {TRAIN_LAUNCHES[cfg.name]}")
    mem_limit = MEM_LIMIT_GB[cfg.name]
    L = cfg.n_layers
    # the peak is this phase's own: an earlier phase's tensors that only a
    # reference cycle still holds are freed first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = tr.adamw(tr.cosine_schedule(3e-4, warmup=1, total=100), quantize_moments=True)
    state = tr.init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    persistent = tree_bytes(port, state.params) + tree_bytes(port, (state.opt_state.m,
                                                                     state.opt_state.v))
    step_fn = tr.make_train_step(cfg, opt, remat=True, fused_ce=True, inplace=True)
    dcfg = port["DataConfig"](seq_len=seq, global_batch=batch_rows, vocab_size=cfg.vocab_size)
    wrappers = port["wrappers"]
    ranges = [TRAIN_KERNELS[k][1] for k in expect]
    rows, nonzero = [], None
    undos = [backward_timer(torch, port["PlainBackwardFn"],
                            {port["plains"][k]: TRAIN_KERNELS[k][1] for k in expect})]
    slstm = None
    if cfg.family == "ssm":
        slstm, undo = slstm_host_timer(torch, port["xlstm"])
        undos.append(undo)
    try:
        for i in range(TRAIN_STEPS):
            batch = {k: v.to(dev) for k, v in port["synthetic_batch"](dcfg, i, cfg).items()}
            profiled = i == TRAIN_STEPS - 1
            reset_counters(wrappers)
            if slstm is not None:
                slstm.update(forward_s=0.0, backward_s=0.0)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                if profiled else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if prof is not None:
                with prof:
                    state, m = step_fn(state, batch)
                    torch.cuda.synchronize()
            else:
                state, m = step_fn(state, batch)
                torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in wrappers.items()}
            row = {"step": i + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "tokens": int(m["tokens"]), "step_s": step_s, "profiled": profiled,
                   "tok_per_s": batch_rows * seq / step_s, "launches": launches}
            for k in expect:
                row[f"{TRAIN_KERNELS[k][0]}_route_launches"] = dict(wrappers[k].route_launches)
            if slstm is not None:
                row.update({f"slstm_{k}": v for k, v in slstm.items()})
                row["slstm_share_of_step_host"] = sum(slstm.values()) / step_s
            if i == 0:  # m after step 1 is (1 - b1) g
                leaves = port["tree_flatten"](state.opt_state.m, is_leaf=lambda x: (
                    isinstance(x, dict) and set(x) == {"q", "scale"}))[0]
                nonzero = [bool((leaf["q"] != 0).any()) for leaf in leaves]
            if prof is not None:
                t_post = time.perf_counter()
                ev, busy_ms, top = device_summary(prof, 1, annotations=tuple(ranges))
                in_ranges = range_device_time(prof, ranges)
                unprofiled_ms = rows[-1]["step_s"] * 1e3
                row.update({
                    "profiler_saw_device": bool(ev), "device_busy_ms": busy_ms,
                    "device_busy_share_profiled_step": min(1.0, busy_ms / (step_s * 1e3)),
                    "device_busy_share_of_step_before": min(1.0, busy_ms / unprofiled_ms),
                })
                for k in expect:
                    short, rng, pattern = TRAIN_KERNELS[k]
                    fwd = [e for e in ev if re.search(pattern, e.key)]
                    row.update({
                        f"{short}_forward_device_ms":
                            sum(e.self_device_time_total for e in fwd) / 1e3,
                        f"{rng}_calls": in_ranges[rng][0],
                        f"{rng}_device_ms": in_ranges[rng][1] / 1e3,
                    })
                row["top_device_ms"] = top
                row["profile_summary_s"] = time.perf_counter() - t_post
            rows.append(row)
            emit({"phase": "train_step", "arch": cfg.name, **row})
    finally:
        for undo in undos:
            undo()
    peak = torch.cuda.max_memory_allocated()
    MEASURED.setdefault(f"{cfg.name}-train", {  # phase 10 reads 5a's
        "step_s": rows[-2]["step_s"], "device_busy_ms": rows[-1]["device_busy_ms"],
        "batch": batch_rows, "seq": seq})
    n_params = sum(t.numel() for t in port["tree_flatten"](state.params)[0])
    names = [path.rsplit(".", 1)[-1] for path in param_paths(port, state.params)]
    named = {name: [nonzero[i] for i, n in enumerate(names) if n == name]
             for name in TRAIN_LEAVES[cfg.name]} if nonzero else {}
    emit({
        "phase": "train", "arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
        "params": n_params, "dtype": cfg.dtype, "batch": batch_rows, "seq": seq,
        "microbatches": 1, "quantize_moments": True, "remat": True, "fused_ce": True,
        "inplace_update": True, "init_s": init_s, "persistent_bytes": persistent,
        "max_memory_allocated": peak, "mem_limit_gb": mem_limit,
        "leaves": len(nonzero or []), "leaves_with_nonzero_grad": sum(nonzero or []),
        "named_leaves_nonzero": {k: [sum(v), len(v)] for k, v in named.items()},
        "launches_per_step": expect,
        "step_s": [r["step_s"] for r in rows],
        "losses": [r["loss"] for r in rows], "ln_vocab": float(np.log(cfg.vocab_size)),
        "card": card,
    })
    for r in rows:
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"train step {r['step']}: loss {r['loss']}, grad norm {r['grad_norm']}")
        for name in wrappers:
            check(r["launches"][name] == expect.get(name, 0),
                  f"train step {r['step']}: {r['launches'][name]} {name} launches, "
                  f"expected {expect.get(name, 0)}")
        for k, n in expect.items():
            routes = r[f"{TRAIN_KERNELS[k][0]}_route_launches"]
            check(routes["mma"] == n, f"train step {r['step']}: {k} routes {routes}")
    check(bool(nonzero) and all(nonzero), "a parameter leaf got a zero gradient")
    for name, flags in named.items():
        check(bool(flags) and all(flags), f"{name}: {sum(flags)} of {len(flags)} leaves "
                                          "got a nonzero gradient")
    check(abs(rows[0]["loss"] - np.log(cfg.vocab_size)) < 2.0,
          f"first loss {rows[0]['loss']} far from ln V")
    for k, n in expect.items():
        rng = TRAIN_KERNELS[k][1]
        check(rows[-1][f"{rng}_calls"] == n // 2,
              f"{rows[-1][f'{rng}_calls']} {rng} calls, expected {n // 2}")
    check(peak < mem_limit * 1e9, f"peak memory {peak / 1e9:.1f} GB > {mem_limit} GB")
    launches = {name: sum(r["launches"][name] for r in rows) for name in wrappers}
    del state, m
    torch.cuda.empty_cache()
    return launches


def param_paths(port, params):
    """Dotted paths of the parameter leaves, in ``tree_flatten`` order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, f"{path}.{i}")
        else:
            out.append(path)

    walk(params, "")
    return out


def leaf_digests(store, prefix):
    import hashlib

    return {k.split("/leaf/")[1]: hashlib.sha256(store.get_bytes(k)).hexdigest()
            for k in store.list(prefix) if "/leaf/" in k}


def phase_elastic(torch, np, port, dev, card, cfg):
    """The elastic trainer at llama3-8b width cut to ``ELASTIC_LAYERS``
    layers, composed as ``launch/train.py`` composes it (int8 moments and
    the fused CE for the 128256-row head): ``WrenExecutor(num_workers=2)``
    over the in-memory store, 2 steps per chunk, 4 steps with the pool
    scaled to 3 at chunk 1, then a resume to 6; then chunk 0 run again
    after ``WARM_CACHE.clear()`` and the deletion of v1 writes the same
    leaf bytes (sha256 per leaf blob)."""
    from functools import partial

    tr, el, ck = port["train"], port["elastic"], port["ckpt"]
    wrappers = port["wrappers"]
    dcfg = port["DataConfig"](seq_len=ELASTIC_SEQ, global_batch=TRAIN_BATCH,
                              vocab_size=cfg.vocab_size)
    opt = tr.adamw(tr.cosine_schedule(1e-3, warmup=1, total=8), quantize_moments=True)
    batch_fn = partial(port["synthetic_batch"], dcfg, cfg=cfg)
    os_env = __import__("os").environ
    prev_fused = os_env.get("REPRO_FUSED_CE")
    os_env["REPRO_FUSED_CE"] = "1"
    wex = port["WrenExecutor"](num_workers=2)
    reset_counters(wrappers)
    try:
        t0 = time.perf_counter()
        tcfg = el.ElasticTrainConfig(run="smoke", steps_per_chunk=2, total_steps=4,
                                     keep_checkpoints=5)
        hist = el.train_elastic(wex, cfg, opt, tcfg, batch_fn, scale_plan={1: 3}, device=dev)
        v_first = ck.latest_version(wex.store, "smoke")
        tcfg2 = dataclasses.replace(tcfg, total_steps=6)
        hist2 = el.train_elastic(wex, cfg, opt, tcfg2, batch_fn, device=dev)
        v_resumed = ck.latest_version(wex.store, "smoke")
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        store = wex.store
        before = leaf_digests(store, "ckpt/smoke/v00000001/")
        version_bytes = sum(len(store.get_bytes(k)) for k in store.list("ckpt/smoke/v00000001/")
                            if "/leaf/" in k)
        el.WARM_CACHE.clear()
        store.delete_prefix("ckpt/smoke/v00000001/")
        torch.cuda.empty_cache()
        el.make_chunk_fn(cfg, opt, store, tcfg, batch_fn, dev)(0)
        after = leaf_digests(store, "ckpt/smoke/v00000001/")
    finally:
        wex.shutdown()
        el.WARM_CACHE.clear()
        if prev_fused is None:
            os_env.pop("REPRO_FUSED_CE", None)
        else:
            os_env["REPRO_FUSED_CE"] = prev_fused
    same = before == after
    hist = hist + hist2
    emit({
        "phase": "elastic", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": TRAIN_BATCH, "seq": ELASTIC_SEQ, "steps_per_chunk": 2, "chunks": len(hist),
        "latest_version": v_first, "latest_version_after_resume": v_resumed,
        "warm_starts": sum(h["warm_start"] for h in hist),
        "losses": [h["loss"] for h in hist], "wall_s": wall, "launches": launches,
        "version_leaf_bytes": version_bytes, "leaf_blobs": len(before),
        "duplicate_chunk_bytes_identical": same, "card": card,
    })
    check(v_first == 2 and v_resumed == 3, f"elastic versions {v_first}, {v_resumed}; "
                                           "expected 2 then 3")
    check(sum(h["warm_start"] for h in hist) >= 1, "no warm start")
    check(all(np.isfinite(h["loss"]) for h in hist), "a non-finite elastic loss")
    check(len(before) > 0 and same, "the duplicate chunk wrote other leaf bytes")
    check(launches["flash_attention"] > 0, "the elastic run launched no flash kernel")
    torch.cuda.empty_cache()
    return launches


def phase_launch_train(card, archs):
    """``python -m repro_torch.launch.train --arch <arch> --reduced`` on the
    card for each of ``archs``, the processes started together (each is
    mostly process and worker start-up on the host)."""
    import tempfile

    env = dict(__import__("os").environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    runs = []
    try:
        for arch in archs:
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                   "--reduced", "--steps", "4", "--steps-per-chunk", "2"]
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            runs.append((arch, cmd, subprocess.Popen(cmd, stdout=out, stderr=err, env=env),
                         out, err))
        for arch, cmd, proc, out, err in runs:
            proc.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            emit({"phase": "launch_train", "cmd": " ".join(cmd[1:]), "rc": proc.returncode,
                  "wall_s": time.perf_counter() - t0, "stdout": lines[-3:], "card": card})
            check(proc.returncode == 0, f"launch.train --arch {arch} failed: {err.read()[-2000:]}")
            check(bool(lines) and lines[-1].endswith("checkpoint v2"), f"launch.train printed {lines}")
    finally:
        for _, _, proc, out, err in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def phase_train_consistency(torch, np, port, dev, card, arch="llama3-8b", n_layers=2, seq=128):
    """``arch``'s width cut to ``n_layers`` layers in fp32 (TF32 off), the
    same parameters and one batch on the card and the CPU, remat and the
    fused CE: the loss within 1e-5 relative, each leaf's gradient within
    1e-3 of its largest |g|, the kernels launched as ``train_launches``
    says (their fp32 routes); then the int8 optimizer given the CPU's
    gradients on both devices: the same codes (ties counted), scales within
    1e-7 and updates within 1e-6 relative.  -> the kernel launches."""
    tr, ts = port["train"], port["train_step"]
    cfg = dataclasses.replace(port["CONFIGS"][arch], n_layers=n_layers,
                              dtype="float32", param_dtype="float32")
    expect = train_launches(cfg)
    laps = [time.perf_counter()]
    p_gpu = port["init_params"](cfg, torch.Generator(device=dev).manual_seed(1), dev)
    p_cpu = port["tree_map"](lambda t: t.cpu(), p_gpu)
    dcfg = port["DataConfig"](seq_len=seq, global_batch=1, vocab_size=cfg.vocab_size)
    batch = port["synthetic_batch"](dcfg, 0, cfg)
    loss_fn = ts.make_loss_fn(cfg, remat=True, fused_ce=True)
    wrappers = port["wrappers"]
    reset_counters(wrappers)
    g_gpu, m_gpu = ts.grad_fn(loss_fn, p_gpu, {k: v.to(dev) for k, v in batch.items()})
    launches = {name: fn.launches for name, fn in wrappers.items()}
    g_gpu = [g.cpu() for g in g_gpu]
    laps.append(time.perf_counter())
    g_cpu, m_cpu = ts.grad_fn(loss_fn, p_cpu, batch)
    laps.append(time.perf_counter())
    loss_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    grad_ratio = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                     for a, b in zip(g_gpu, g_cpu))
    opt = tr.adamw(1e-3, quantize_moments=True)
    struct = port["tree_flatten"](p_cpu)[1]
    grads = port["tree_unflatten"](struct, g_cpu)
    u_c, s_c = opt.update(grads, opt.init(p_cpu), p_cpu)
    laps.append(time.perf_counter())
    u_g, s_g = opt.update(port["tree_map"](lambda t: t.to(dev), grads), opt.init(p_gpu), p_gpu)
    torch.cuda.synchronize()
    laps.append(time.perf_counter())
    code_diffs, code_max, scale_err, upd_ratio = 0, 0, 0.0, 0.0
    for a, b in zip(port["tree_flatten"]((s_g.m, s_g.v))[0], port["tree_flatten"]((s_c.m, s_c.v))[0]):
        a = a.cpu()
        if b.dtype == torch.int8:  # codes lie in [-127, 127]: int16 holds their difference
            d = (a.to(torch.int16) - b.to(torch.int16)).abs_()
            code_diffs += int(torch.count_nonzero(d))
            code_max = max(code_max, int(d.max()))
        else:
            scale_err = max(scale_err, float((a - b).abs().max()))
    for a, b in zip(port["tree_flatten"](u_g)[0], port["tree_flatten"](u_c)[0]):
        upd_ratio = max(upd_ratio, float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    n_codes = sum(t.numel() for t in port["tree_flatten"]((s_c.m, s_c.v))[0]
                  if t.dtype == torch.int8)
    laps.append(time.perf_counter())
    ok = loss_err <= 1e-5 and grad_ratio <= 1e-3 and code_max <= 1 and scale_err <= 1e-7 \
        and upd_ratio <= 1e-6
    emit({
        "phase": "train_consistency", "arch": cfg.name, "n_layers": n_layers, "seq": seq,
        "dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_cuda": float(m_gpu["loss"]), "loss_cpu": float(m_cpu["loss"]),
        "loss_rel_err": loss_err, "grad_err_over_leaf_max": grad_ratio,
        "int8_codes": n_codes, "int8_codes_one_apart": code_diffs, "int8_code_max_diff": code_max,
        "scale_max_abs_err": scale_err, "update_err_over_leaf_max": upd_ratio,
        "launches": launches, "expected_launches": expect,
        # host-clock seconds of its parts
        "parts_s": dict(zip(("init_and_card_step", "cpu_step", "cpu_optimizer",
                             "card_optimizer", "compare"), (b - a for a, b in zip(laps, laps[1:])))),
        "tol": {"loss_rel": 1e-5, "grad_over_leaf_max": 1e-3, "scale_abs": 1e-7,
                "update_over_leaf_max": 1e-6},
        "ok": ok, "card": card,
    })
    for name in wrappers:
        check(launches[name] == expect.get(name, 0),
              f"{arch} train consistency: {launches[name]} {name} launches, "
              f"expected {expect.get(name, 0)}")
    check(loss_err <= 1e-5, f"train loss differs by {loss_err} relative between cuda and cpu")
    check(grad_ratio <= 1e-3, f"gradients differ by {grad_ratio} of their leaf's max")
    check(code_max <= 1 and scale_err <= 1e-7 and upd_ratio <= 1e-6,
          f"int8 optimizer: codes {code_diffs} apart (max {code_max}), scales {scale_err}, "
          f"updates {upd_ratio}")
    del p_gpu, u_g, s_g
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: BSP, MapReduce, terasort and the parameter server (host only)
# ---------------------------------------------------------------------------

# 7a: the paper's 333 partitions, about 25 MB of text (50 MB until a slow
# host's run passed the time limit with phase 7 at 93.9 s of its 120)
WC_DOCS, WC_LINES = 333, 1650
WC_WORKERS, WC_REDUCERS = 8, 8
# 7b (and 8b): 12.5 MB of 100-byte records -> 20 partitions (100 MB until a
# slow host's run took 1288.0 s, 7b 28.7 s and 8b 46.6 s there; 50 MB until
# the sanitizer put phase 8 at 107-116 s of its 150 with 8b 20.6-24.4 s;
# 25 MB until 8b took 17.7 s of a slow host's 70.7 s phase 8)
SORT_RECORDS, SORT_FILES = 125 * 10 ** 3, 20
ADOPT_RECORDS, ADOPT_FILES = 10 ** 5, 10  # 7c: the SIGKILLed driver's job
KV_SHARDS = 4
PS_DIM, PS_SHARDS, PS_ROWS, PS_STEPS = 64, 8, 128, 60  # 7d: as examples/hogwild_ps.py
BSP_BUDGET_S = 120  # phase 7's wall time, all four parts


def bsp_stores(root, workers=WC_WORKERS, lease_s=None):
    """A port ``WrenExecutor`` over file roots under ``root`` (FileBackend +
    a ``KV_SHARDS``-shard FileKVStore, no fsync: phases 6a and 6c hold the
    stores to their durability)."""
    import os

    from repro_torch.core import SchedulerConfig, WrenExecutor
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    kv = FileKVStore(os.path.join(root, "kv"), num_shards=KV_SHARDS, fsync="never")
    store = ObjectStore(backend=FileBackend(os.path.join(root, "obj"), fsync="never"))
    cfg = SchedulerConfig(driver_lease_timeout_s=lease_s) if lease_s else None
    return kv, store, WrenExecutor(store=store, kv=kv, num_workers=workers,
                                   scheduler_config=cfg)


def sort_inputs(store, n_records, n_files, seed=0):
    """``n_records`` 100-byte records (``make_sort_records``) in ``n_files``
    objects -> their keys."""
    from repro_torch.storage import shuffle as shf

    per = n_records // n_files
    keys = [f"sortin/part{i:03d}" for i in range(n_files)]
    store.put_many({k: shf.make_sort_records(per, seed=seed + i) for i, k in enumerate(keys)})
    return keys


def _ps_loss(w, shards):
    import numpy as np

    return float(np.mean([np.mean((X @ w - y) ** 2) for X, y in shards]))


def ps_grad(w, shard):
    """7d's least-squares gradient (module level: the port pickles it by
    reference)."""
    X, y = shard
    return 2.0 * X.T @ (X @ w - y) / len(y)


def sanitized():
    """The port's runtime sanitizer, installed (idempotent, with no undo:
    every store, executor and scheduler built from here on is
    instrumented), its reports and op count cleared."""
    from repro_torch.analysis import sanitizer

    sanitizer.install()
    sanitizer.state.clear()
    return sanitizer


def sanitizer_counts(san):
    """This process's sanitizer reports (as text) and the ops it saw."""
    return {"reports": [str(r) for r in san.state.snapshot()], "ops_seen": san.state.ops_seen}


def sanitizer_check(part, san, children):
    """Phase ``part``'s sanitizer line: the reports of this process and of
    its children (their `sanitizer_counts`), and the ops each saw; any
    report fails, and so does a process that saw no op (a sanitizer never
    installed)."""
    own = sanitizer_counts(san)
    reports = own["reports"] + [r for c in children for r in c["reports"]]
    emit({"phase": "sanitizer", "part": part, "reports": len(reports),
          "ops_seen": own["ops_seen"], "children_ops_seen": [c["ops_seen"] for c in children],
          "report_list": reports})
    check(not reports, f"phase {part}: {len(reports)} sanitizer report(s): {reports}")
    check(own["ops_seen"] > 0 and all(c["ops_seen"] > 0 for c in children),
          f"phase {part}: the sanitizer saw no op in a process: {own['ops_seen']}, "
          f"{[c['ops_seen'] for c in children]}")


def phase_bsp(card):
    """7: the paper's higher-level models on the port's runtime over file
    roots, host only (no kernel runs), under the port's runtime sanitizer
    (installed here, for the rest of the script): word count, terasort, a
    SIGKILLed sort driver adopted by a fresh process, HOGWILD! on the KV
    store."""
    import os
    import shutil
    import tempfile
    from collections import Counter

    from repro_torch.core import WrenExecutor, word_count
    from repro_torch.data import make_documents

    san = sanitized()
    root = tempfile.mkdtemp(prefix="chip-smoke-bsp-")
    t_phase = time.perf_counter()
    try:
        # 7a: word count
        t0 = time.perf_counter()
        docs = make_documents(WC_DOCS, WC_LINES, seed=0)
        text_B = sum(len(line) + 1 for d in docs for line in d)
        truth = Counter(w for d in docs for line in d for w in line.split())
        setup_s = time.perf_counter() - t0
        kv, store, wex = bsp_stores(os.path.join(root, "wc"))
        try:
            ops0 = len(store.ledger.records()) + len(kv.ledger.records())
            t0 = time.perf_counter()
            wc = word_count(wex, docs, num_reducers=WC_REDUCERS)
            wall = time.perf_counter() - t0
            requests = len(store.ledger.records()) + len(kv.ledger.records()) - ops0
        finally:
            wex.shutdown()
            kv.close()
        words = sum(truth.values())
        emit({"phase": "bsp_word_count", "docs": WC_DOCS, "lines_per_doc": WC_LINES,
              "text_B": text_B, "words": words, "workers": WC_WORKERS,
              "reducers": WC_REDUCERS, "setup_s": setup_s, "wall_s": wall,
              "modelled_requests": requests, "words_per_s": words / wall,
              "clock": "host", "card": card})
        check(wc == dict(truth), "word count differs from an in-process Counter")

        # 7b: terasort, intermediates on the KV_SHARDS-shard KV
        sort7b = run_terasort(*bsp_stores(os.path.join(root, "sort")), "bsp_terasort", card)

        # 7c: a sort driver SIGKILLed between partition and merge, adopted by
        # a fresh process
        adopted = run_adoption(os.path.join(root, "adopt"), "bsp_adopt", card)

        # 7d: HOGWILD! on the KV store, as examples/hogwild_ps.py runs it
        run_hogwild(lambda: WrenExecutor(num_workers=6), "bsp_hogwild", card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    sanitizer_check("7", san, adopted["sanitizer"])
    emit({"phase": "bsp", "wall_s": wall, "budget_s": BSP_BUDGET_S, "clock": "host",
          "card": card})
    check(wall <= BSP_BUDGET_S, f"phase 7 took {wall:.1f} s of its {BSP_BUDGET_S} s")
    return sort7b


def run_adoption(where, phase, card):
    """7c: a sort driver child (``ADOPT_RECORDS`` records) SIGKILLed between
    partition and merge, adopted by a fresh child, both over the stores
    ``where`` names (`child_stores`) and both sanitized; checked.  -> the
    adopter's row, with both children's `sanitizer_counts` under
    ``sanitizer``."""
    t0 = time.perf_counter()
    drv = spawn_child("sort-driver", where)
    try:
        drv.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        drv.kill()
        check(False, "the sort driver never reached its kill barrier")
    check(drv.returncode == -9, f"the sort driver exited {drv.returncode}: "
                                f"{drv.stderr.read()[-2000:]}")
    driver = json.loads(drv.stdout.read().strip().splitlines()[-1])  # its line before the kill
    adopted = child_json(spawn_child("sort-adopt", where), "the adopting process")
    adopted.update(phase=phase, wall_s=time.perf_counter() - t0, clock="host", card=card,
                   sanitizer=[driver["sanitizer"], adopted["sanitizer"]])
    emit(adopted)
    check(adopted["sorted"] and adopted["records_equal_inputs"]
          and adopted["n_records"] == ADOPT_RECORDS and adopted["merge_tasks"] == ADOPT_FILES
          and adopted["shuffle_keys_left"] == 0, f"adoption: {adopted}")
    return adopted


def run_terasort(kv, store, wex, phase, card):
    """7b's job (``SORT_RECORDS`` records in ``SORT_FILES`` objects ->
    ``SORT_FILES`` partitions, intermediates on ``kv``) on these stores,
    checked; shuts ``wex`` down.  -> its row, with each sorted partition's
    sha256 in key order."""
    import hashlib

    from repro_torch.core import terasort, verify_sorted

    try:
        t0 = time.perf_counter()
        keys = sort_inputs(store, SORT_RECORDS, SORT_FILES)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = terasort(wex, keys, "sorted", SORT_FILES, intermediate=kv)
        wall = time.perf_counter() - t0
        ok = verify_sorted(store, "sorted")
        left = kv.scan("shuffle/")
        outs = {k: store.get_bytes(k) for k in store.list("sorted")}
        n_out = sum(len(store.get(k)) for k in outs)
    finally:
        wex.shutdown()
        kv.close()
    row = {"phase": phase, "records": SORT_RECORDS, "input_objects": SORT_FILES,
           "partitions": SORT_FILES, "kv_shards": KV_SHARDS, "setup_s": setup_s,
           "wall_s": wall, "MB_per_s": SORT_RECORDS * 100 / 1e6 / wall,
           "n_records": rep.n_records, "n_intermediate_objects": rep.n_intermediate_objects,
           "hottest_shard_vtime_s": rep.hottest_shard_vtime, "sorted": ok,
           "shuffle_keys_left": len(left),
           "sorted_sha256": [hashlib.sha256(outs[k]).hexdigest() for k in sorted(outs)],
           "clock": "host", "card": card}
    emit(row)
    check(ok and rep.n_records == n_out == SORT_RECORDS, "terasort: not sorted, or "
          f"{rep.n_records} / {n_out} records of {SORT_RECORDS}")
    check(rep.n_intermediate_objects == SORT_FILES * SORT_FILES,
          f"{rep.n_intermediate_objects} intermediate objects")
    check(not left, f"{len(left)} shuffle intermediates left after the merge")
    return row


def run_hogwild(make_executor, phase, card, steps=PS_STEPS):
    """7d: HOGWILD! as ``examples/hogwild_ps.py`` runs it (``steps`` per
    worker), in its three configurations, on a fresh ``make_executor()``
    each (the parameter server on its KV), checked against the loss and
    push bands."""
    import numpy as np

    from repro_torch.core import ParameterServer, PSConfig, hogwild_sgd

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=PS_DIM)
    shards = []
    for _ in range(PS_SHARDS):
        X = rng.normal(size=(PS_ROWS, PS_DIM))
        shards.append((X, X @ w_true + 0.01 * rng.normal(size=PS_ROWS)))
    for label, cfg in (("hogwild", PSConfig(num_blocks=8)),
                       ("staleness<=4", PSConfig(num_blocks=8, max_staleness=4)),
                       ("int8", PSConfig(num_blocks=8, compress_int8=True))):
        with make_executor() as wex:
            server = ParameterServer(wex.kv, np.zeros(PS_DIM), cfg)
            wex.kv.ledger.clear()
            t0 = time.perf_counter()
            w = hogwild_sgd(wex, server, ps_grad, shards, steps_per_worker=steps, lr=0.01)
            wall = time.perf_counter() - t0
            # a straggler's speculative copy may still be running when the
            # job returns: stopping the pool lets it finish its steps
            # (HOGWILD! takes its pushes), so the pushes and the attempts
            # that ran are counted together
            wex.shutdown()
            applied = sum(int(v) for v in wex.kv.mget(
                [server._vkey(b) for b in range(cfg.num_blocks)]))
            recs = [r for r in wex.kv.ledger.records() if r.worker.startswith("psw")]
            attempts = sum(st.tasks_ok + st.tasks_superseded
                           for st in wex.pool.stats().values())
        loss0, loss1 = _ps_loss(np.zeros(PS_DIM), shards), _ps_loss(w, shards)
        row = {"phase": phase, "config": label, "shards": PS_SHARDS,
               "steps_per_worker": steps, "wall_s": wall, "loss_start": loss0,
               "loss_end": loss1, "task_attempts": attempts, "pushes": attempts * steps,
               "blocks_applied": applied,
               "blocks_rejected": attempts * steps * cfg.num_blocks - applied,
               "kv_requests": len(recs), "kv_bytes": sum(r.nbytes for r in recs),
               "rel_err": float(np.linalg.norm(w - w_true) / np.linalg.norm(w_true)),
               "clock": "host", "card": card}
        emit(row)
        check(loss1 < 0.1 * loss0, f"HOGWILD! ({label}): the loss went {loss0} -> {loss1}")
        check(attempts >= PS_SHARDS and row["blocks_rejected"] >= 0
              and (row["blocks_rejected"] == 0 or cfg.max_staleness is not None),
              f"HOGWILD! ({label}): {attempts} task attempts, {applied} blocks applied")



def child_stores(where, workers=4, lease_s=1.0):
    """7c's and 8c's stores: file roots under a directory, or, for
    ``net:<hex>``, the handles the parent pickled, which this process
    rebuilds from their ``net_kv`` / ``net_obj`` reconnect specs."""
    if not where.startswith("net:"):
        return bsp_stores(where, workers=workers, lease_s=lease_s)
    import pickle

    from repro_torch.core import SchedulerConfig, WrenExecutor

    kv, store = pickle.loads(bytes.fromhex(where[len("net:"):]))
    return kv, store, WrenExecutor(store=store, kv=kv, num_workers=workers,
                                   scheduler_config=SchedulerConfig(driver_lease_timeout_s=lease_s))


def bsp_child(role, where) -> None:
    """7c's and 8c's two processes: ``sort-driver`` submits a terasort and
    SIGKILLs itself the instant the partition barrier commits;
    ``sort-adopt`` adopts the job in a fresh process and prints what it
    finds, and how it reached the stores.  Both run under the port's
    runtime sanitizer, and print its `sanitizer_counts` (the driver on a
    line of its own just before its kill)."""
    import os
    import signal

    import numpy as np

    from repro_torch.core import adopt_job, bsp, verify_sorted
    from repro_torch.storage import object_store

    san = sanitized()
    kv, store, wex = child_stores(where)
    if role == "sort-driver":
        orig = bsp._stage_barrier

        def killing_barrier(wex_, job, idx, plan, outputs, **kw):
            out = orig(wex_, job, idx, plan, outputs, **kw)
            if idx == 1:  # the partition stage's barrier
                print(json.dumps({"sanitizer": sanitizer_counts(san)}), flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            return out

        bsp._stage_barrier = killing_barrier
        keys = sort_inputs(store, ADOPT_RECORDS, ADOPT_FILES, seed=100)
        bsp.terasort(wex, keys, "sorted", ADOPT_FILES, intermediate=kv, job_id="smoke-sort")
        raise SystemExit("the sort driver survived its kill barrier")
    submits = []
    orig_submit = wex.scheduler.submit_many
    wex.scheduler.submit_many = lambda tasks: submits.append(len(tasks)) or orig_submit(tasks)
    t0 = time.perf_counter()
    rep = adopt_job(wex, "smoke-sort", wait_timeout_s=60.0, timeout_s=CHILD_TIMEOUT_S)
    adopt_s = time.perf_counter() - t0
    outs = np.concatenate([store.get(k) for k in store.list("sorted")])
    ins = np.concatenate([store.get(k) for k in store.list("sortin/")])
    row = {"n_records": rep.n_records, "merge_tasks": sum(submits), "adopt_s": adopt_s,
           "sorted": verify_sorted(store, "sorted"), "output_records": len(outs),
           "records_equal_inputs": sorted(map(bytes, outs)) == sorted(map(bytes, ins)),
           "shuffle_keys_left": len(kv.scan("shuffle/")),
           "manifest_keys_left": len(kv.scan("sched/job/smoke-sort/")),
           "stores": [type(kv).__name__, type(store.backend).__name__],
           "reconnected": sorted(kind for kind, _ in object_store._RECONNECT_CACHE)}
    wex.shutdown()
    kv.close()
    row["sanitizer"] = sanitizer_counts(san)
    print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# phase 6: the storage plane (file stores, stateless workers over shared roots)
# ---------------------------------------------------------------------------

# phases 6b and 8a: new tokens a request (64 until a slow host's run passed
# the time limit: at 64, 8a's three runs took 66 s of phase 8's 87 s)
SERVE_NEW_TOKENS = 16
SERVE_WORKER_ARGS = ["--arch", "llama3-8b", "--batch", "4", "--max-len", "1024",
                     "--new-tokens", str(SERVE_NEW_TOKENS), "--lease-timeout", "2"]  # phase 6b
SHARED_REQUESTS = 16  # phase 6b: requests per run, prompts of 16-300 tokens
# phase 6b: a worker exits after its queue stays empty this long, which must
# outlast a dead peer's lease (2 s) and one reap period (2 s) or the
# survivor leaves before it can re-serve the victim's requests
WORKER_IDLE_S = 5
# phase 6c: llama3-8b width at 1 layer (2 until PR 24, for the script's
# time), 2 x 512 tokens a step
RESUME_LAYERS, RESUME_SEQ = 1, 512
CHILD_TIMEOUT_S = 300


def src_env():
    import os

    src = str(Path(__file__).resolve().parent / "src")
    return dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))


def spawn_child(*args, env=None):
    """This script as a child process (``child <role> ...``), lines on stdout."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "child", *args],
                            env=env or src_env(), text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def child_json(proc, what):
    """The last stdout line of a child that must exit 0, as JSON."""
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        check(False, f"{what} did not finish in {CHILD_TIMEOUT_S} s")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def child_main(role, args) -> int:
    """The child processes of phases 6a, 6c, 7c and 8c."""
    import os

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    if role == "blpop":  # 6a: block in blpop until the parent's push lands
        kv = FileKVStore(args[0], num_shards=1)
        print("ready", flush=True)
        got = kv.blpop("wake", timeout_s=30.0)
        w = kv._watcher
        print(json.dumps({"latency_s": time.time() - got, "mode": w.mode,
                          "poll_wakeups": w.poll_wakeups}), flush=True)
        kv.close()
    elif role == "race":  # 6a: put_if_absent on every key the parent races for
        kv = FileKVStore(args[0], num_shards=1)
        store = ObjectStore(backend=FileBackend(args[1]))
        print("ready", flush=True)
        kv.blpop("go", timeout_s=30.0)
        wins = [k for k in range(int(args[2])) if store.put(f"race/{k}", "child", if_absent=True)]
        print(json.dumps({"wins": len(wins)}), flush=True)
    elif role == "writer":  # 6a: append until SIGKILLed
        kv = FileKVStore(args[0], num_shards=1, fsync="never")
        i = 0
        while True:
            kv.rpush("log", i, worker="w")
            kv.mset({"a": i, "b": i}, worker="w")
            i += 1
    elif role in ("sort-driver", "sort-adopt"):  # 7c, 8c
        bsp_child(role, args[0])
    elif role == "elastic":  # 6c: resume the run of the pickled config from the root
        import pickle

        os.environ["REPRO_FUSED_CE"] = "1"
        cfg = pickle.loads(bytes.fromhex(args[3]))
        t0 = time.perf_counter()
        hist = elastic_run(cfg, args[0], int(args[1]), args[2])
        print(json.dumps({"losses": [h["loss"] for h in hist],
                          "elastic_run_s": time.perf_counter() - t0}), flush=True)
    else:
        raise SystemExit(f"unknown child role {role!r}")
    return 0


def phase_storage(card):
    """6a: the file stores' contract across two processes on this machine's
    filesystem (CPU only): a blpop woken by another process's push, a
    put_if_absent race that each key's one writer wins, and the committed
    prefix after a SIGKILLed writer plus a torn frame."""
    import os
    import shutil
    import signal
    import tempfile

    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore
    from repro_torch.storage.inotify import Inotify

    root = tempfile.mkdtemp(prefix="chip-smoke-stores-")
    row = {"phase": "storage", "root_fs": root, "inotify_available": Inotify.available(),
           "card": card}
    n = 400
    wroot = os.path.join(root, "torn")
    try:
        # the three children start together
        blpop = spawn_child("blpop", os.path.join(root, "wake"))
        race = spawn_child("race", os.path.join(root, "race-kv"), os.path.join(root, "race-obj"),
                           str(n))
        writer = spawn_child("writer", wroot)
        # a cross-process blpop wake
        check(blpop.stdout.readline().strip() == "ready", "the blpop child did not start")
        time.sleep(0.5)  # let it park in blpop
        kv = FileKVStore(os.path.join(root, "wake"), num_shards=1)
        kv.rpush("wake", time.time(), worker="parent")
        row["blpop"] = child_json(blpop, "the blpop child")
        kv.close()
        check(row["blpop"]["latency_s"] < 2.0, f"cross-process wake took {row['blpop']}")
        # a put_if_absent race: exactly one process wins each key
        kv = FileKVStore(os.path.join(root, "race-kv"), num_shards=1)
        store = ObjectStore(backend=FileBackend(os.path.join(root, "race-obj")))
        check(race.stdout.readline().strip() == "ready", "the race child did not start")
        kv.rpush("go", 1, worker="parent")
        mine = sum(store.put(f"race/{k}", "parent", if_absent=True) for k in range(n))
        theirs = child_json(race, "the race child")["wins"]
        owners = store.get_many([f"race/{k}" for k in range(n)], missing="error")
        row["race"] = {"keys": n, "parent_wins": mine, "child_wins": theirs,
                       "objects": len(store.list("race/"))}
        check(mine + theirs == n and len(owners) == n
              and sum(v == "parent" for v in owners.values()) == mine,
              f"put_if_absent race: {row['race']}")
        kv.close()
        store.backend.close()
        # torn tail: SIGKILL the writer, add half a frame, reopen
        kv = FileKVStore(wroot, num_shards=1)
        deadline = time.monotonic() + 60
        while kv.llen("log") < 200:
            check(writer.poll() is None and time.monotonic() < deadline,
                  "the writer made no progress")
            time.sleep(0.01)
        os.kill(writer.pid, signal.SIGKILL)
        writer.wait(timeout=30)
        kv.close()
        from repro_torch.storage.kv_store import encode_frame

        frame = encode_frame([("s", "lost", "never committed")])
        with open(os.path.join(wroot, "shard-0.log"), "ab") as f:
            f.write(frame[:-3])
        kv = FileKVStore(wroot, num_shards=1)
        entries, (a, b) = kv.lrange("log"), kv.mget(["a", "b"])
        kv.set("after", 1, worker="parent")  # truncates the torn tail
        kv.close()
        kv = FileKVStore(wroot, num_shards=1)
        after = kv.get("after")
        kv.close()
        row["torn_tail"] = {"writer_rc": writer.returncode, "recovered": len(entries)}
        check(entries == list(range(len(entries))) and a == b and after == 1,
              f"after the SIGKILL: {len(entries)} entries, a={a}, b={b}, after={after}")
        # the watcher of this filesystem, in this process
        kv = FileKVStore(os.path.join(root, "wake"), num_shards=1)
        peer = FileKVStore(os.path.join(root, "wake"), num_shards=1)
        got = []
        th = threading.Thread(target=lambda: got.append(kv.blpop("w2", timeout_s=20.0)))
        th.start()
        time.sleep(0.3)
        peer.rpush("w2", "x", worker="parent")
        th.join(timeout=20)
        row["watcher"] = {"mode": kv._watcher.mode, "poll_wakeups": kv._watcher.poll_wakeups}
        kv.close()
        peer.close()
        check(got == ["x"], "an in-process cross-handle wake was lost")
    finally:
        for proc in (blpop, race, writer):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    emit(row)


class Worker:
    """One ``python -m repro_torch.launch.serve`` worker over shared roots,
    its stdout read by a thread."""

    def __init__(self, kv_root, obj_root, engine_id):
        self.id, self.t0 = engine_id, time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_WORKER_ARGS,
             "--kv-root", kv_root, "--obj-root", obj_root, "--engine-id", engine_id,
             "--idle-timeout", str(WORKER_IDLE_S)],
            env=src_env(), text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.lines, self.ready_s, self.ready = [], None, threading.Event()
        self.groups = []  # each prefill group's request ids, as printed (a victim's too)
        self._err = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        threading.Thread(target=lambda: self._err.extend(self.proc.stderr), daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if line.startswith("prefill "):
                self.groups.append(json.loads(line.split(" ", 1)[1]))
            if line.startswith("READY"):
                self.ready_s = time.perf_counter() - self.t0
                self.ready.set()
        self.ready.set()

    def wait_ready(self):
        self.ready.wait(CHILD_TIMEOUT_S)
        check(self.ready_s is not None, f"worker {self.id} never printed READY: "
                                        f"{''.join(self._err)[-2000:]}")

    def finish(self):
        """Wait for the idle exit; -> (stats line, kernel launches)."""
        try:
            rc = self.proc.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            check(False, f"worker {self.id} did not exit")
        self._reader.join(timeout=30)  # the last lines are read after the exit
        check(rc == 0, f"worker {self.id} exited {rc}: {''.join(self._err)[-2000:]}")
        stats = [ln for ln in self.lines if ln.startswith(f"{self.id}: served")]
        launches = [ln for ln in self.lines if ln.startswith("launches ")]
        check(len(stats) == 1 and len(launches) == 1, f"worker {self.id} printed {self.lines}")
        return stats[0], json.loads(launches[0].split(" ", 1)[1])

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def gpu_processes(torch):
    """The card's compute processes as ``[[pid, MiB], ...]``, from
    ``torch.cuda.list_gpu_processes`` (NVML) and from ``nvidia-smi``, and the
    device memory in use (``torch.cuda.mem_get_info``)."""
    import re

    listed = torch.cuda.list_gpu_processes(0)
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    free, total = torch.cuda.mem_get_info(0)
    return {
        "list_gpu_processes": [[int(p), float(m)] for p, m in
                               re.findall(r"process\s+(\d+) uses\s+([\d.]+) MB", listed)],
        "nvidia_smi": [[int(p), float(m)] for p, m in re.findall(r"(\d+),\s*([\d.]+)", smi)],
        "device_used_B": total - free,
    }


def serve_run(torch, port, root, ids, prompts, worker_ids, victim=None):
    """Workers over fresh roots under ``root``: submit the requests once all
    are READY; with a ``victim``, SIGKILL it once it has published a result
    and still holds live leases.  -> a row of what happened."""
    import os
    import signal

    rp = port["rp"]
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    kv_root, obj_root = os.path.join(root, "kv"), os.path.join(root, "obj")
    kv = FileKVStore(kv_root, num_shards=2)
    store = ObjectStore(backend=FileBackend(obj_root))
    workers = {w: Worker(kv_root, obj_root, w) for w in worker_ids}
    row = {"workers": list(worker_ids)}
    try:
        for w in workers.values():
            w.wait_ready()
        free, total = torch.cuda.mem_get_info(0)
        row["device_used_B_ready"] = total - free
        row["ready_s"] = {w.id: w.ready_s for w in workers.values()}
        t0 = time.perf_counter()
        for r, p in zip(ids, prompts):
            rp.submit(store, kv, r, p)
        done_keys = [rp.done_key(r) for r in ids]
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        if victim is not None:
            seen = {}  # done key -> the engine that published it
            while True:
                check(time.monotonic() < deadline and workers[victim].proc.poll() is None,
                      "the victim never held live leases after publishing a result")
                new = sorted(store.exists_many(done_keys) - seen.keys())
                seen.update({k: rec["engine"] for k, rec in store.get_many(new).items()})
                if victim in seen.values() and len(seen) < len(ids):
                    now, keys = time.time(), kv.scan(rp.LEASE_PREFIX)
                    live = [k for k, rec in zip(keys, kv.mget(keys))
                            if rec and rec["engine"] == victim and float(rec["expires"]) > now]
                    if live:
                        break
                time.sleep(0.02)
            row["gpu_processes"] = gpu_processes(torch)
            row["worker_pids"] = {w.id: w.proc.pid for w in workers.values()}
            before = {k: store.get_bytes(k) for k in store.exists_many(done_keys)}
            os.kill(workers[victim].proc.pid, signal.SIGKILL)
            t_kill = time.time()
            workers[victim].proc.wait(timeout=30)
            row.update(victim=victim, victim_rc=workers[victim].proc.returncode,
                       victim_live_leases=len(live), done_at_kill=len(before),
                       victim_results_at_kill=sum(store.get(k)["engine"] == victim for k in before))
        while len(store.exists_many(done_keys)) < len(ids):
            check(time.monotonic() < deadline, "not every request was served")
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        survivors = [w for w in workers.values() if w.id != victim]
        finished = {w.id: w.finish() for w in survivors}
    finally:
        for w in workers.values():
            w.kill()
    res = rp.get_results(store, ids, timeout_s=10)
    # each request's prefill group in the worker that published its result
    # (the last group that held it there)
    groups = {r: next(g for g in reversed(workers[res[r]["engine"]].groups) if r in g)
              for r in ids}
    row.update(wall_s=wall, stats={k: v[0] for k, v in finished.items()},
               launches={k: v[1] for k, v in finished.items()},
               done_objects=len(store.list("serve/done/")),
               served_by={w: sum(res[r]["engine"] == w for r in ids) for w in worker_ids})
    check(sorted(store.list("serve/done/")) == sorted(done_keys),
          f"{row['done_objects']} result objects for {len(ids)} requests")
    if victim is not None:
        check(row["victim_rc"] == -signal.SIGKILL, f"the victim exited {row['victim_rc']}")
        for k, blob in before.items():
            check(store.get_bytes(k) == blob, f"{k}, published before the kill, changed")
        row["kill_to_last_result_s"] = max(res[r]["t_done"] for r in ids) - t_kill
    kv.close()
    store.backend.close()
    return row, {r: res[r]["tokens"] for r in ids}, groups


def phase_shared_roots(torch, np, port, card):
    """6b: llama3-8b at full width and depth in stateless worker processes
    over shared file roots: one worker alone serves the requests, then two
    workers serve them again and one is SIGKILLed mid-stream; the survivor
    finishes every request exactly once.  -> the survivor's launches."""
    import gc
    import re
    import shutil
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    print(f"[6b] torch.cuda.memory_allocated before the workers: {allocated} B",
          file=sys.stderr, flush=True)
    cfg = port["CONFIGS"]["llama3-8b"]
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(16, 301, size=SHARED_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    ids = [f"req-{i:02d}" for i in range(SHARED_REQUESTS)]
    root = tempfile.mkdtemp(prefix="chip-smoke-roots-")
    try:
        solo, solo_tokens, solo_groups = serve_run(torch, port, root + "/solo", ids, prompts,
                                                   ["solo"])
        pair, tokens, groups = serve_run(torch, port, root + "/pair", ids, prompts,
                                         ["e0", "e1"], victim="e1")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    survivor = pair["stats"]["e0"]
    tok_s = float(re.search(r"\(([\d.]+) tok/s", survivor).group(1))
    gp, pids = pair["gpu_processes"], pair["worker_pids"]
    same_group = [r for r in ids if groups[r] == solo_groups[r]]
    weights = 16.06e9  # B: llama3-8b's bf16 weights, each worker's own copy
    # NVML names the processes by the PIDs of its own namespace: where they
    # are not the workers' PIDs, every process here is listed (as one PID),
    # and what tells the workers apart is the count of entries holding the
    # weights
    listed = gp["list_gpu_processes"]
    by_pid = all(any(p == pid and mib * 2**20 >= weights for p, mib in listed)
                 for pid in pids.values())
    holding = sum(mib * 2**20 >= weights for _, mib in listed)
    row = {
        "phase": "shared_roots", "arch": cfg.name, "n_layers": cfg.n_layers,
        "memory_allocated_before_B": allocated, "prompt_lens": lens,
        "worker_args": SERVE_WORKER_ARGS, "cache_dtype": "float32",
        "one_worker": solo, "two_workers": pair,
        "survivor_tok_per_s": tok_s,
        "tokens_equal_to_one_worker": sum(tokens[r] == solo_tokens[r] for r in ids),
        "prefill_group_sizes": {"one_worker": [len(solo_groups[r]) for r in ids],
                                "two_workers": [len(groups[r]) for r in ids]},
        "same_prefill_group": same_group,
        "tokens_equal_where_group_same": sum(tokens[r] == solo_tokens[r] for r in same_group),
        "worker_pids_listed_with_weights": by_pid,
        "listed_processes_holding_the_weights": holding, "card": card,
    }
    emit(row)
    check(allocated < 1 << 30, f"the smoke's process holds {allocated} B before the workers")
    # a bf16 prefill's bits depend on its group's size (the GEMMs' M; decode
    # is all slots, so its rows do not; tools/prefill_groups.py), so the
    # tokens must be equal where a request's group was the same in both runs
    check(all(tokens[r] == solo_tokens[r] for r in same_group),
          f"tokens differ from the one-worker run's for a request prefilled in the same "
          f"group in both runs: {[r for r in same_group if tokens[r] != solo_tokens[r]]}")
    check(pair["served_by"]["e1"] >= 1 and pair["done_objects"] == SHARED_REQUESTS,
          f"served by {pair['served_by']}")
    check(by_pid or holding >= 2,
          f"the card does not list the two workers {pids} with their weights: {gp}")
    check(gp["device_used_B"] - allocated >= 2 * weights,
          f"{gp['device_used_B']} B in use on the card while two workers serve")
    for name in ("decode_attention", "flash_attention"):
        check(pair["launches"]["e0"][name] > 0 and solo["launches"]["solo"][name] > 0,
              f"{name} never launched in a worker")
    return {"one_worker": solo["launches"]["solo"], "survivor": pair["launches"]["e0"]}


def elastic_parts(cfg):
    """The optimizer (int8 moments) and the batch source (2 x ``RESUME_SEQ``
    tokens a step) of phase 6c's runs."""
    from functools import partial

    from repro_torch import train
    from repro_torch.data import DataConfig, synthetic_batch

    dcfg = DataConfig(seq_len=RESUME_SEQ, global_batch=2, vocab_size=cfg.vocab_size)
    opt = train.adamw(train.cosine_schedule(1e-3, warmup=1, total=8), quantize_moments=True)
    return opt, partial(synthetic_batch, dcfg, cfg=cfg)


def elastic_run(cfg, root, total_steps, device):
    """``train_elastic`` of ``cfg`` with the fused CE, 2 steps a chunk, on
    ``WrenExecutor(num_workers=1)`` over ``ObjectStore(backend=FileBackend(
    root))``, on ``device``, to ``total_steps``; two versions kept.  The
    last version's state stays in ``WARM_CACHE``.  -> the chunks' metrics."""
    from repro_torch.core import WrenExecutor
    from repro_torch.storage import FileBackend, ObjectStore
    from repro_torch.train import elastic

    opt, batch_fn = elastic_parts(cfg)
    wex = WrenExecutor(store=ObjectStore(backend=FileBackend(root)), num_workers=1)
    try:
        tcfg = elastic.ElasticTrainConfig(run="resume", steps_per_chunk=2,
                                          total_steps=total_steps, keep_checkpoints=2)
        return elastic.train_elastic(wex, cfg, opt, tcfg, batch_fn, device=device)
    finally:
        wex.shutdown()
        wex.store.backend.close()


def phase_elastic_resume(torch, np, port, dev, card):
    """6c: the elastic trainer resumed from a ``FileBackend`` root in a fresh
    process.  Chunk 0 runs here (versions 0 and 1 on disk; chunks 0 and 1
    until the script needed the time); chunk 1 then runs twice: here, from
    the state chunk 0 left in memory (the uninterrupted run: the state
    never leaves the process), and in a child process that starts from
    version 1 on disk.  The losses must be equal
    bit for bit.  -> this process's kernel launches."""
    import math
    import os
    import pickle
    import shutil
    import tempfile

    from repro_torch.storage import FileBackend, ObjectStore

    ck, el, wrappers = port["ckpt"], port["elastic"], port["wrappers"]
    cfg = dataclasses.replace(port["CONFIGS"]["llama3-8b"], n_layers=RESUME_LAYERS)
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    os_env = os.environ
    prev_fused = os_env.get("REPRO_FUSED_CE")
    os_env["REPRO_FUSED_CE"] = "1"
    try:
        # the room three versions take (two kept, one being written): bf16
        # parameters and int8 moments with their fp32 block scales
        opt, batch_fn = elastic_parts(cfg)
        like, _ = ck.jax_state_skeleton(cfg, opt)
        n = sum(math.prod(s.shape) for s in port["tree_flatten"](like)[0])
        version_est = n * 2 + 2 * (n + 4 * math.ceil(n / 256))
        disk = shutil.disk_usage(root)
        print(f"[6c] disk_usage({root}): {disk}", file=sys.stderr, flush=True)
        check(disk.free >= 3 * version_est,
              f"phase 6c needs room for three checkpoint versions, {3 * version_est / 1e9:.1f} "
              f"GB, and {root} has {disk.free / 1e9:.1f} GB free")
        reset_counters(wrappers)
        t0 = time.perf_counter()
        first = elastic_run(cfg, root, 2, dev)
        t_first = time.perf_counter() - t0
        store = ObjectStore(backend=FileBackend(root))
        keys = [k for k in store.list("ckpt/resume/v00000001/") if "/leaf/" in k]
        version_bytes = sum(os.path.getsize(store.backend._path(k)) for k in keys)
        # one version written and read back on its own
        warm = el.WARM_CACHE[("resume", 1)]
        t0 = time.perf_counter()
        ck.save(store, "probe", 0, tuple(warm))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _, _ = ck.load(store, "probe", 0, device=dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        del back
        store.delete_prefix("ckpt/probe/")
        # the uninterrupted run's chunk 1, from the warm state
        tcfg = el.ElasticTrainConfig(run="resume", steps_per_chunk=2, total_steps=4)
        chunk = el.make_chunk_fn(cfg, opt, ObjectStore(), tcfg, batch_fn, dev)
        t0 = time.perf_counter()
        cont = [chunk(1)]
        t_cont = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        el.WARM_CACHE.clear()
        del warm, chunk
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = child_json(spawn_child("elastic", root, "4", str(dev), pickle.dumps(cfg).hex()),
                             "the resuming process")
        rest = resumed["losses"]
        t_rest = time.perf_counter() - t0
        latest = ck.latest_version(store, "resume")
        store.backend.close()
    finally:
        el.WARM_CACHE.clear()
        shutil.rmtree(root, ignore_errors=True)
        if prev_fused is None:
            os_env.pop("REPRO_FUSED_CE", None)
        else:
            os_env["REPRO_FUSED_CE"] = prev_fused
    head = [h["loss"] for h in first]
    whole_l, split_l = head + [h["loss"] for h in cont], head + rest
    emit({
        "phase": "elastic_resume", "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "batch": 2, "seq": RESUME_SEQ, "steps_per_chunk": 2,
        "params": n, "disk_free_B": disk.free, "version_leaf_bytes": version_bytes,
        "version_write_s": write_s, "version_read_s": read_s,
        "first_chunk_s": t_first, "warm_chunk_s": t_cont, "resume_process_s": t_rest,
        "resume_elastic_run_s": resumed["elastic_run_s"],
        "warm_starts": [h["warm_start"] for h in cont],
        "losses_uninterrupted": whole_l, "losses_resumed": split_l, "latest_version": latest,
        "launches": launches, "card": card,
    })
    check(all(h["warm_start"] == 1.0 for h in cont), "the uninterrupted run reloaded its state")
    check(len(whole_l) == 2 and split_l == whole_l,
          f"resumed losses {split_l} differ from the uninterrupted run's {whole_l}")
    check(latest == 2, f"the resumed run ended at v{latest}, expected v2")
    check(launches["flash_attention"] > 0, "the elastic runs launched no flash kernel")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the repro-kvd wire tier on the card's machine
# ---------------------------------------------------------------------------

WIRE_BUDGET_S = 150  # phase 8's wall time, all four parts
# 8a: its requests, and how many are submitted at once, then once the
# engine idles in blpop (16 and (12, 4) until a slow host's 8a took 32.6 s)
WIRE_REQUESTS, WIRE_WAVES = 8, (6, 2)
# 8d: 7d's steps per worker halved (60 until the sanitizer: 8d took 4.7-7.5 s
# of phase 8's 90.3-92.5 s without it and 13.3-16.5 s of 107.4-112.5 s with it)
WIRE_PS_STEPS = PS_STEPS // 2
# 8a's engine: 6b's workers' (SERVE_WORKER_ARGS), built by the serve CLI's build_engine
WIRE_ENGINE = dict(arch="llama3-8b", reduced=False, device="cuda", batch=4, max_len=1024,
                   new_tokens=SERVE_NEW_TOKENS, decode_chunk=8, queues=1, lease_timeout=2.0,
                   cache_dtype="float32")
DAEMON_TIMEOUT_S = 60  # a daemon's start or stop


class Daemon:
    """The port's ``repro-kvd`` daemon (``python -m
    repro_torch.storage.net_server``, its CLI, with ``REPRO_SANITIZE=1``:
    the port's sanitizer instruments its stores) on a Unix socket under
    ``root``, SIGKILLable and restartable on the same root and address."""

    def __init__(self, root):
        import os

        self.data = os.path.join(root, "data")
        self.address = "unix:" + os.path.join(root, "kvd.sock")
        self.proc, self.start_s, self.lines = None, [], []

    def spawn(self):
        """Start the process; `listening` waits for it to accept."""
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.storage.net_server", "--root", self.data,
             "--uds", self.address[len("unix:"):], "--num-shards", str(KV_SHARDS),
             "--fsync", "never"],
            env=dict(src_env(), REPRO_SANITIZE="1"), text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        self._listening, t_listen = threading.Event(), []
        self._t_listen = t_listen

        def read(proc=self.proc, listening=self._listening):
            for line in proc.stdout:
                self.lines.append(line.rstrip("\n"))
                if line.startswith("LISTENING"):
                    t_listen.append(time.perf_counter())
                    listening.set()

        threading.Thread(target=read, daemon=True).start()
        return self

    def listening(self):
        ok = self._listening.wait(DAEMON_TIMEOUT_S)
        check(ok and self.lines[-1] == f"LISTENING {self.address}",
              f"the daemon did not start in {DAEMON_TIMEOUT_S} s: {self.lines[-20:]}")
        self.start_s.append(self._t_listen[0] - self._t0)  # to LISTENING, waited or not
        return self

    def start(self):
        return self.spawn().listening()

    def kill(self):
        import signal

        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=DAEMON_TIMEOUT_S)
        check(self.proc.returncode == -signal.SIGKILL, f"the daemon exited {self.proc.returncode}")

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=DAEMON_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=DAEMON_TIMEOUT_S)


def net_stores(address):
    from repro_torch.storage import NetBackend, NetKVStore, ObjectStore

    return NetKVStore(address), ObjectStore(backend=NetBackend(address))


def wire_serve_run(port, engine, stores, run, prompts, daemon=None):
    """One run of 8a: ``engine.run`` over ``stores`` (the engine's pair,
    then a submitting user's pair; one in-memory pair serves as both), the
    requests ``<run>/req-NN``.  The first ``WIRE_WAVES[0]`` are submitted
    at once; with a ``daemon``, it is SIGKILLed once the first result is
    published and restarted on its root and address; the rest are
    submitted the moment the idle engine has entered ``blpop``, which must
    return the first of them (woken by the push, not by a later pop).
    -> (row, each request's tokens, each request's prefill group as
    request numbers)"""
    import numpy as np

    rp = port["rp"]
    ids = [f"{run}/req-{i:02d}" for i in range(len(prompts))]
    (ekv, estore), (ukv, ustore) = stores
    groups, parked, woken = [], threading.Event(), []
    orig_blpop = ekv.blpop

    def blpop(key, timeout_s, **kw):  # the engine's idle wait, recorded
        parked.set()
        got = orig_blpop(key, timeout_s, **kw)
        woken.append(got)
        return got

    ekv.blpop = blpop
    engine.on_prefill = lambda group: groups.append(list(group))
    for k in engine.stats:
        engine.stats[k] = 0
    n_a = WIRE_WAVES[0]
    submitted, row, failed = {}, {"requests": len(ids)}, []

    def submit(batch):
        for r, p in batch:
            submitted[r] = time.time()
            rp.submit(ustore, ukv, r, p)

    def driver():  # the user: waves, and the daemon's kill and restart
        try:
            done_keys = [rp.done_key(r) for r in ids[:n_a]]
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            if daemon is not None:
                while not ustore.exists_many(done_keys):
                    check(time.monotonic() < deadline, "no result before the kill")
                    time.sleep(0.005)
                gens = len(ekv._client.generations)
                t_kill = time.time()
                daemon.kill()
                daemon.start()
                t_up = time.time()
                while len(ekv._client.generations) == gens:
                    check(time.monotonic() < deadline, "the engine's client never reconnected")
                    time.sleep(0.001)
                row.update(t_kill=t_kill, daemon_restart_s=t_up - t_kill,
                           client_reconnect_s=time.time() - t_up)
            while len(ustore.exists_many(done_keys)) < n_a:
                check(time.monotonic() < deadline, "the first wave was not served")
                time.sleep(0.01)
            parked.clear()
            check(parked.wait(30), "the engine never parked in blpop")
            row["woken_from"] = len(woken)
            submit(list(zip(ids[n_a:], prompts[n_a:])))
        except BaseException as exc:  # surfaced by the caller after the run
            failed.append(exc)

    submit(list(zip(ids[:n_a], prompts[:n_a])))
    helper = threading.Thread(target=driver)
    t0 = time.perf_counter()
    helper.start()
    stats = engine.run(estore, ekv, engine_id="wire", idle_timeout_s=30.0,
                       max_requests=len(ids))
    wall = time.perf_counter() - t0
    helper.join(timeout=CHILD_TIMEOUT_S)
    ekv.blpop = orig_blpop
    check(not failed and not helper.is_alive(), f"8a's user thread failed: {failed}")
    res = rp.get_results(ustore, ids, timeout_s=30)
    tokens = {r: res[r]["tokens"] for r in ids}
    done = ustore.list(f"serve/done/{run}/")
    check(sorted(done) == sorted(rp.done_key(r) for r in ids)
          and stats["served"] == len(ids) and all(res[r]["engine"] == "wire" for r in ids),
          f"{stats['served']} served, {len(done)} results for {len(ids)}")
    check(woken[row["woken_from"]] == ids[n_a],
          f"the parked blpop did not return {ids[n_a]}: {woken[row['woken_from']:][:4]}")
    ttft = sorted(res[r]["t_first"] - submitted[r] for r in ids)
    row.update(wall_s=wall, tokens_out=stats["tokens_out"],
               tok_per_s=stats["tokens_out"] / wall, ttft_p50_s=float(np.median(ttft)),
               prefill_groups=stats["prefill_groups"], decode_steps=stats["decode_steps"],
               modelled_requests=sum(r.worker == "wire" for h in (ekv, estore)
                                     for r in h.ledger.records()))
    if "t_kill" in row:
        row["kill_to_next_result_s"] = min(res[r]["t_done"] for r in ids
                                           if res[r]["t_done"] > row["t_kill"]) - row["t_kill"]
    if hasattr(ekv, "_client"):
        clients = [ekv._client, estore.backend._client]
        row.update(bytes_pickled=sum(c.bytes_pickled for c in clients),
                   bytes_buffer=sum(c.bytes_buffer for c in clients),
                   reconnects=ekv._client.reconnects,
                   generations=len(ekv._client.generations))
    number = {r: i for i, r in enumerate(ids)}
    by_number = {number[r]: [number[x] for x in g] for g in groups for r in g}
    return row, [tokens[r] for r in ids], by_number


def phase_wire(torch, np, port, card, sort7b):
    """8: the port's ``repro-kvd`` daemon (its CLI, on a Unix socket) on the
    card's machine: 8a llama3-8b served over it (steady, then across a
    SIGKILL), 8b 7b's terasort, 8c 7c's adoption with the adopter reaching
    the stores through their net specs, 8d 7d's HOGWILD!; all of it, the
    daemons and 8c's children under the port's runtime sanitizer.  -> 8a's
    kernel launches (the in-memory reference run, the two wire runs)."""
    import argparse
    import contextlib
    import gc
    import pickle
    import shutil
    import tempfile

    from repro_torch.core import WrenExecutor
    from repro_torch.launch import serve as serve_cli

    wrappers = {k: port["wrappers"][k] for k in ("decode_attention", "flash_attention")}
    san = sanitized()
    root = tempfile.mkdtemp(prefix="chip-smoke-wire-")
    t_phase = time.perf_counter()
    # both daemons start now, while the engine is built and serves in memory
    daemons = [Daemon(f"{root}/{name}").spawn() for name in ("serve", "bsp")]
    launches = {}
    try:
        # 8a: the engine of 6b's workers, in this process
        t0 = time.perf_counter()
        engine = serve_cli.build_engine(argparse.Namespace(**WIRE_ENGINE))
        build_s = time.perf_counter() - t0
        cfg = engine.cfg
        rng = np.random.default_rng(0)
        lens = [int(n) for n in rng.integers(16, 301, size=WIRE_REQUESTS)]
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
        reset_counters(wrappers)
        kv, store = port["KVStore"](num_shards=KV_SHARDS), port["ObjectStore"]()
        ref, ref_tokens, ref_groups = wire_serve_run(port, engine, ((kv, store), (kv, store)),
                                                     "memory", prompts)
        launches["llama3-8b-wire-reference"] = {k: fn.launches for k, fn in wrappers.items()}
        reset_counters(wrappers)
        runs = {}
        d = daemons[0].listening()  # both runs, each its own requests
        for name in ("steady", "kill"):
            stores = (net_stores(d.address), net_stores(d.address))
            try:
                runs[name] = wire_serve_run(port, engine, stores, name, prompts,
                                            daemon=d if name == "kill" else None)
            finally:
                for kv_, store_ in stores:
                    kv_.close()
                    store_.backend.close()
        launches["llama3-8b-wire"] = {k: fn.launches for k, fn in wrappers.items()}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        row = {"phase": "wire_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
               "engine_build_s": build_s, "prompt_lens": lens, "waves": WIRE_WAVES,
               "in_memory": ref, "launches": launches, "card": card}
        for name, (r, tokens, groups) in runs.items():
            same = [i for i in range(len(prompts)) if groups[i] == ref_groups[i]]
            r.update(tokens_equal_to_in_memory=sum(t == u for t, u in zip(tokens, ref_tokens)),
                     same_prefill_group=len(same),
                     tokens_equal_where_group_same=sum(tokens[i] == ref_tokens[i] for i in same))
            row[name] = r
            check(all(tokens[i] == ref_tokens[i] for i in same),
                  f"8a ({name}): tokens differ from the in-memory run's where the prefill "
                  f"group was the same: {[i for i in same if tokens[i] != ref_tokens[i]]}")
        row["kill"]["daemon_start_s"] = d.start_s
        emit(row)
        k = row["kill"]
        check(k["reconnects"] >= 1 and k["generations"] == 2,
              f"8a: the engine's client reconnected {k['reconnects']} times, "
              f"{k['generations']} server generations seen")
        check(row["steady"]["reconnects"] == 0, "8a: a reconnect with a steady daemon")
        for name in wrappers:
            check(launches["llama3-8b-wire"][name] > 0, f"{name} never launched in 8a")

        # 8b: 7b's terasort over one daemon (8c and 8d reuse it)
        d = daemons[1].listening()
        kv, store = net_stores(d.address)
        wex = WrenExecutor(store=store, kv=kv, num_workers=WC_WORKERS)
        sort8b = run_terasort(kv, store, wex, "wire_terasort", card)
        store.delete_many(store.list("sortin/") + store.list("sorted"))  # 8c's namespace
        store.backend.close()
        emit({"phase": "wire_terasort_vs_file", "MB_per_s": sort8b["MB_per_s"],
              "file_MB_per_s": sort7b["MB_per_s"],
              "hottest_shard_vtime_s": sort8b["hottest_shard_vtime_s"],
              "file_hottest_shard_vtime_s": sort7b["hottest_shard_vtime_s"], "card": card})
        check(sort8b["sorted_sha256"] == sort7b["sorted_sha256"],
              "8b: the sorted partitions differ from 7b's")

        # 8c: 7c over the daemon; both children rebuild the stores from specs
        kv, store = net_stores(d.address)
        adopted = run_adoption("net:" + pickle.dumps((kv, store)).hex(), "wire_adopt", card)
        kv.close()
        store.backend.close()
        check(adopted["stores"] == ["_SanitizedNetKVStore", "_SanitizedNetBackend"]
              and {"net_kv", "net_obj"} <= set(adopted["reconnected"]),
              f"8c: the adopter reached {adopted['stores']} via {adopted['reconnected']}")

        # 8d: 7d's HOGWILD!, the executor and the parameter server on the daemon
        @contextlib.contextmanager
        def wire_executor():
            kv_, store_ = net_stores(d.address)
            try:
                with WrenExecutor(store=store_, kv=kv_, num_workers=6) as wex_:
                    yield wex_
            finally:
                kv_.close()
                store_.backend.close()

        run_hogwild(wire_executor, "wire_hogwild", card, steps=WIRE_PS_STEPS)
    finally:
        for d in daemons:
            d.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    sanitizer_check("8", san, adopted["sanitizer"])
    emit({"phase": "wire", "wall_s": wall, "budget_s": WIRE_BUDGET_S,
          "daemon_start_s": [s_ for d in daemons for s_ in d.start_s], "clock": "host",
          "card": card})
    check(wall <= WIRE_BUDGET_S, f"phase 8 took {wall:.1f} s of its {WIRE_BUDGET_S} s")
    return launches

# ---------------------------------------------------------------------------
# phase 9: sharded execution on a one-card NCCL mesh
# ---------------------------------------------------------------------------

DIST_BUDGET_S = 45  # phase 9's wall time, all three parts
DIST_PROMPT, DIST_STEPS, DIST_MAX_LEN = 64, 4, 128  # two prompts, greedy decode steps
DIST_TOL = 2e-5  # the fp32 attention bar of tests/test_kernels.py


def full_tensor(x):
    """A DTensor's whole value; a tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def dist_generate(torch, port, cfg, params, cache, prompts, ctx):
    """Prefill ``prompts`` then ``DIST_STEPS`` greedy steps under ``ctx``
    -> (tokens (steps + 1, B), last-position logits (steps + 1, B, V)),
    DTensor outputs gathered."""
    toks, logits = [], []
    with torch.no_grad(), ctx:
        out, cache, n = port["prefill"](params, cfg, {"tokens": prompts}, cache)
        for i in range(DIST_STEPS + 1):
            logits.append(full_tensor(out[:, -1]))
            toks.append(logits[-1].argmax(-1))
            if i < DIST_STEPS:
                out, cache = port["decode_step"](params, cfg, toks[-1][:, None], cache, n + i)
    return torch.stack(toks), torch.stack(logits)


def dist_serve_check(torch, port, dev, smi, mesh, cfg, kernels):
    """9a/9b's serving half: ``cfg`` in fp32 on the card, prefill of two
    prompts and ``DIST_STEPS`` greedy steps with parameters and caches
    placed on ``mesh`` by the port's rules, against the same run on plain
    tensors; ``kernels``' counters > 0 in the sharded run.  -> (the row,
    the sharded parameters)."""
    import contextlib

    from repro_torch.launch.shardings import cache_pspec, to_shardings
    from repro_torch.models.sharding import distribute, param_sharding, use_mesh

    t0 = time.perf_counter()
    params = port["init_params"](cfg, torch.Generator(device=dev).manual_seed(1), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, DIST_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    cache = port["init_cache"](cfg, 2, DIST_MAX_LEN, torch.float32, dev)
    ref_toks, ref_logits = dist_generate(torch, port, cfg, params, cache, prompts,
                                         contextlib.nullcontext())
    sp = distribute(params, param_sharding(mesh, params))
    cache = port["init_cache"](cfg, 2, DIST_MAX_LEN, torch.float32, dev)
    scache = distribute(cache, to_shardings(mesh, cache_pspec(mesh, cfg, cache)))
    wrappers = port["wrappers"]
    reset_counters(wrappers)
    toks, logits = dist_generate(torch, port, cfg, sp, scache, prompts, use_mesh(mesh))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    err = (logits - ref_logits).abs().max().item()
    same = bool(torch.equal(toks, ref_toks))
    row = {
        "phase": f"dist_{cfg.name}", "n_layers": cfg.n_layers, "dtype": "float32",
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "backend": torch.distributed.get_backend(),
        "prompts": [2, DIST_PROMPT], "decode_steps": DIST_STEPS,
        "tokens_identical": same, "max_abs_logit_err": err, "tol": DIST_TOL,
        "launches": launches, "seconds": time.perf_counter() - t0, "nvidia_smi": smi,
    }
    check(same, f"{cfg.name} on the mesh: greedy tokens differ from the plain-tensor run")
    check(err <= DIST_TOL, f"{cfg.name} on the mesh: logits differ by {err} > {DIST_TOL}")
    for name in kernels:
        check(launches[name] > 0, f"{cfg.name} on the mesh: {name} never launched")
    del params, cache, scache
    return row, sp, launches


def phase_dist(torch, port, dev, smi):
    """9: sharded execution on a (1, 1) ``DeviceMesh`` ("data", "model")
    over NCCL, world size 1, from a ``HashStore``.  9a llama3-8b at full
    width, 2 layers, fp32: prefill, decode, and one train step (finite
    loss, every leaf's gradient nonzero) with the state placed by
    ``state_pspec``; 9b zamba2-1.2b at full width, one period, the same
    serving checks; then ``ops.mlstm_parallel`` on DTensors at xlstm-1.3b's
    shape, bit-equal to the call on plain tensors.  -> the launches of
    each part."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspec, state_pspec, to_shardings
    from repro_torch.models.sharding import distribute, placements, use_mesh

    t_phase = time.perf_counter()
    CONFIGS, ts = port["CONFIGS"], port["train_step"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1)
    launches = {}
    try:
        mesh = make_mesh(1, 1, device=dev.type)
        # 9a: serving, then one train step on the same sharded parameters
        llama = dataclasses.replace(CONFIGS["llama3-8b"], n_layers=2, dtype="float32",
                                    param_dtype="float32")
        row, sp, launches["dist-llama3-8b"] = dist_serve_check(
            torch, port, dev, smi, mesh, llama, ("flash_attention", "decode_attention"))
        t0 = time.perf_counter()
        opt = port["train"].adamw(1e-4)
        state = port["train"].TrainState(sp, opt.init(sp))
        state = distribute(state, to_shardings(mesh, state_pspec(mesh, state)))
        dcfg = port["DataConfig"](seq_len=DIST_PROMPT, global_batch=2, vocab_size=llama.vocab_size)
        batch = {k: v.to(dev) for k, v in port["synthetic_batch"](dcfg, 0, llama).items()}
        batch = distribute(batch, to_shardings(mesh, batch_pspec(mesh, batch)))
        reset_counters(port["wrappers"])
        with use_mesh(mesh):
            grads, _ = ts.grad_fn(ts.make_loss_fn(llama), state.params, batch)
            zero = [i for i, g in enumerate(grads) if not bool((g.to_local() != 0).any())]
            del grads
            state, metrics = ts.make_train_step(llama, opt, inplace=True)(state, batch)
            loss = float(full_tensor(metrics["loss"]))
        train_flash = port["wrappers"]["flash_attention"].launches
        launches["dist-llama3-8b"]["flash_attention"] += train_flash
        row.update(train_loss=loss, train_zero_grad_leaves=zero, train_flash_launches=train_flash,
                   train_seconds=time.perf_counter() - t0)
        emit(row)
        check(math.isfinite(loss), f"the sharded train step's loss is {loss}")
        check(not zero, f"the sharded train step left leaves {zero} without a gradient")
        check(train_flash > 0, "the sharded train step never launched flash attention")
        del state, sp, batch
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # 9b: zamba2, one period (shared_attn_every Mamba2 layers and the shared block)
        zamba = CONFIGS["zamba2-1.2b"]
        zamba = dataclasses.replace(zamba, n_layers=zamba.shared_attn_every, dtype="float32",
                                    param_dtype="float32")
        row, sp, launches["dist-zamba2-1.2b"] = dist_serve_check(
            torch, port, dev, smi, mesh, zamba, ("ssd", "flash_attention", "decode_attention"))
        emit(row)
        del sp
        # 9b: one mLSTM call on DTensors at xlstm-1.3b's prefill shape, bf16
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(3)
        B, S, H, D = 1, 300, 4, 1024
        qkv = [torch.randn((B, S, H, D), device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3)]
        gates = [torch.randn((B, S, H), device=dev, generator=g) for _ in range(2)]
        exp = ops.mlstm_parallel(*qkv, *gates)
        from torch.distributed.tensor import distribute_tensor

        # batch over dp, heads over tp: (B, S, H, D) and (B, S, H)
        dts = [distribute_tensor(t, mesh, placements(mesh, ("data", None, "model", None)[:t.dim()]),
                                 src_data_rank=None) for t in (*qkv, *gates)]
        reset_counters(port["wrappers"])
        with use_mesh(mesh):
            out = ops.mlstm_parallel(*dts).full_tensor()
        n = port["wrappers"]["mlstm"].launches
        launches["dist-xlstm-1.3b-mlstm"] = {"mlstm": n}
        equal = bool(torch.equal(out, exp))
        emit({"phase": "dist_mlstm", "shape": [B, S, H, D], "dtype": "bfloat16",
              "bit_equal": equal, "launches": n, "seconds": time.perf_counter() - t0,
              "nvidia_smi": smi})
        check(equal, "mlstm on DTensors differs from the call on plain tensors")
        check(n > 0, "mlstm on DTensors never launched the kernel")
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t_phase
    emit({"phase": "dist", "wall_s": wall, "budget_s": DIST_BUDGET_S, "clock": "host",
          "nvidia_smi": smi})
    check(wall <= DIST_BUDGET_S, f"phase 9 took {wall:.1f} s of its {DIST_BUDGET_S} s")
    return launches


# ---------------------------------------------------------------------------
# the no-mesh serving path against another tree (not a phase)
# ---------------------------------------------------------------------------

def load_tree(root):
    """The ``chip_smoke.py`` of the tree at ROOT, its port loaded (this
    process imports that tree's ``repro_torch``) and its kernels built.
    -> (the module, what its `load_port` returns)"""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("tree_chip_smoke", Path(root) / "chip_smoke.py")
    tree = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = tree  # its functions pickle by reference (7d's gradient)
    spec.loader.exec_module(tree)
    port = tree.load_port()
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    return tree, port


def serve_profile(root) -> int:
    """``python3 chip_smoke.py serve-profile ROOT``: phase 3's llama3-8b
    serve and decode-step profile, run by the ``chip_smoke.py`` of the tree
    at ROOT on that tree's port (kernels built first)."""
    import numpy as np
    import torch

    tree, port = load_tree(root)
    tree.phase_serve(torch, np, port, torch.device("cuda", 0), torch.cuda.get_device_name(0),
                     port["CONFIGS"]["llama3-8b"], ("decode_attention", "flash_attention"))
    return 0


def serve_ab(other_root, reps: int = 2) -> int:
    """``python3 chip_smoke.py serve-ab ROOT``: the decode step of phase 3's
    llama3-8b serve (no mesh) on this tree against the tree at ROOT (the
    parent commit, unpacked with ``git archive``), each in a fresh process,
    in the order ROOT, this, this, ROOT (``reps`` times); prints each
    run's ``serve_profile`` row, then the card's name and power limit and
    each side's step times and median."""
    import statistics

    here, other = Path(__file__).resolve().parent, Path(other_root).resolve()
    steps = {"other": [], "this": []}
    for side in ["other", "this", "this", "other"] * reps:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "serve-profile",
                              str(other if side == "other" else here)],
                             capture_output=True, text=True, check=True, timeout=600).stdout
        row = next(json.loads(line) for line in out.splitlines()
                   if line.startswith("{") and '"serve_profile"' in line)
        emit({"side": side, **row})
        steps[side].append(row["step_ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"serve_ab": str(other), "nvidia_smi": smi, "step_ms": steps,
          "median_ms": {k: statistics.median(v) for k, v in steps.items()}})
    return 0


def bsp_wire(root) -> int:
    """``python3 chip_smoke.py bsp-wire ROOT``: phases 7 and 8, run by the
    ``chip_smoke.py`` of the tree at ROOT on that tree's port (kernels
    built first)."""
    import numpy as np
    import torch

    tree, port = load_tree(root)
    card = torch.cuda.get_device_name(0)
    tree.phase_wire(torch, np, port, card, tree.phase_bsp(card))
    return 0


# the rows `sanitize_ab` keeps of a `bsp_wire` run: phase -> its keys
AB_ROWS = {
    "bsp_word_count": ("wall_s",), "bsp_terasort": ("wall_s",), "bsp_adopt": ("wall_s",),
    "bsp_hogwild": ("config", "wall_s"), "bsp": ("wall_s",), "wire_terasort": ("wall_s",),
    "wire_adopt": ("wall_s",), "wire_hogwild": ("config", "wall_s"), "wire": ("wall_s",),
    "sanitizer": ("part", "reports", "ops_seen", "children_ops_seen"),
}


def sanitize_ab(other_root, out_dir=None, reps: int = 1) -> int:
    """``python3 chip_smoke.py sanitize-ab ROOT [OUT_DIR]``: phases 7 and 8
    on this tree (under the port's runtime sanitizer) against the tree at
    ROOT (the parent commit, unpacked with ``git archive``, which runs them
    unsanitized), each in a fresh process, in the order ROOT, this, this,
    ROOT (``reps`` times); prints each run's part times (8a: tokens/s and
    TTFT p50 in memory, steady, across the kill), writes each run's whole
    output to OUT_DIR (default ``build/sanitize_ab``), then prints the
    card's name and power limit."""
    here, other = Path(__file__).resolve().parent, Path(other_root).resolve()
    out_dir = Path(out_dir) if out_dir else here / "build" / "sanitize_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, side in enumerate(["other", "this", "this", "other"] * reps):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "bsp-wire",
                               str(other if side == "other" else here)],
                              capture_output=True, text=True, timeout=900)
        (out_dir / f"{i}-{side}.out").write_text(proc.stdout + "\n--- stderr\n" + proc.stderr)
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        parts = [{"phase": r["phase"], **{k: r[k] for k in AB_ROWS[r["phase"]]}}
                 for r in rows if r.get("phase") in AB_ROWS]
        serve = next((r for r in rows if r.get("phase") == "wire_serve"), None)
        if serve is not None:
            parts.append({"phase": "wire_serve", **{
                run: [serve[run]["tok_per_s"], serve[run]["ttft_p50_s"]]
                for run in ("in_memory", "steady", "kill")}})
        emit({"side": side, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
              "parts": parts})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"sanitize_ab": str(other), "nvidia_smi": smi})
    return 0


def phase_roofline(torch, port, smi):
    """Phase 10: the dry-run's count (`repro_torch.launch.dryrun`) of two
    llama3-8b programs at full width and depth, exactly as this script ran
    them, on a one-card ``AbstractMesh((1, 1))`` with no process group:
    5a's train step (bf16, int8 moments, remat, the fused CE, the in-place
    update) and phase 3's decode step (4 live slots of a 1024-row fp32
    cache, each at its own length).  The count runs the port's program on
    fake CPU tensors (the kernels' plain versions compute each kernel's
    result; no launch, no allocation); a kernel's bytes are its operands
    and results, decode attention's cache to each slot's length.  Each
    program's roofline terms beside the step the script measured on both
    clocks; a bound above the device-busy time it bounds means the count
    is wrong."""
    from repro_torch.launch import dryrun
    from repro_torch.models.sharding import AbstractMesh

    rl = hardware()
    t_phase = time.perf_counter()
    mesh = AbstractMesh((1, 1), ("data", "model"))
    cfg, tr, wrappers = port["CONFIGS"]["llama3-8b"], port["train"], port["wrappers"]
    before = {name: fn.launches for name, fn in wrappers.items()}
    train, decode = MEASURED["llama3-8b-train"], MEASURED["llama3-8b-decode"]
    total_p, active_p = cfg.param_count()
    rows = []
    for program, measured in (("train", train), ("decode", decode)):
        t0 = time.perf_counter()
        if program == "train":
            B, S = train["batch"], train["seq"]
            opt = tr.adamw(tr.cosine_schedule(3e-4, warmup=1, total=100), quantize_moments=True)
            count = dryrun.count_program(cfg, "train", B, S, [mesh], opt=opt, remat=True,
                                         fused_ce=True, inplace=True)
            tokens, host_s, busy_s = B * S, measured["step_s"], measured["device_busy_ms"] / 1e3
        else:
            B, S = len(DECODE_SLOT_LENS), 1024
            count = dryrun.count_program(cfg, "decode", B, S, [mesh],
                                         cache_dtype=torch.float32,
                                         cache_len=list(DECODE_SLOT_LENS))
            tokens = B
            host_s = measured["step_ms"] / 1e3
            busy_s = measured["device_busy_ms_per_step"] / 1e3
        count_s = time.perf_counter() - t0
        roof = rl.Roofline(
            arch=cfg.name, shape=f"chip_smoke {program} {B}x{S}", mesh="1x1", n_devices=1,
            hlo_flops_per_device=count.flops, hlo_bytes_per_device=count.bytes,
            collective_bytes_per_device=0.0,
            model_flops=rl.model_flops_per_step(total_p, active_p, tokens,
                                                "train" if program == "train" else "serve"),
            memory_stats=count.memory["1x1"],
        ).finalize()
        d = roof.to_dict()
        row = {
            "phase": "roofline", "program": program, "card": smi, "batch": B, "seq": S,
            "flops": count.flops, "bytes": count.bytes, "aten_ops": count.ops,
            "compute_s": d["compute_s"], "memory_s": d["memory_s"],
            "step_bound_s": d["step_bound_s"], "dominant": d["dominant"],
            "measured_host_s": host_s, "measured_device_busy_s": busy_s,
            "host_over_bound": host_s / d["step_bound_s"],
            "busy_over_bound": busy_s / d["step_bound_s"],
            "argument_bytes": d["memory_stats"]["argument_bytes"], "count_s": count_s,
            "flops_counted": dryrun.FLOPS_COUNTED, "bytes_counted": dryrun.BYTES_COUNTED,
        }
        if program == "decode":
            row["least_step_ms"] = measured["least_step_ms"]
            row["memory_ms_over_least_step_ms"] = d["memory_s"] * 1e3 / measured["least_step_ms"]
        emit(row)
        rows.append(row)
    elapsed = time.perf_counter() - t_phase
    emit({"phase": "roofline_summary", "card": smi, "seconds": elapsed,
          "budget_s": ROOFLINE_BUDGET_S})
    after = {name: fn.launches for name, fn in wrappers.items()}
    check(after == before, f"the dry-run's count launched kernels: {before} -> {after}")
    for r in rows:
        check(r["step_bound_s"] > 0 and math.isfinite(r["step_bound_s"]),
              f"{r['program']}: bound {r['step_bound_s']}")
        check(r["step_bound_s"] <= r["measured_device_busy_s"],
              f"{r['program']}: the roofline bound {r['step_bound_s']:.6f} s exceeds the "
              f"device-busy time {r['measured_device_busy_s']:.6f} s it bounds")
    check(elapsed <= ROOFLINE_BUDGET_S, f"phase 10 took {elapsed:.1f} s > {ROOFLINE_BUDGET_S} s")


def start_twin(args):
    """One example twin (``examples_torch/<args[0]>``) started in a fresh
    process on the card, as a user runs it."""
    script = Path(__file__).resolve().parent / "examples_torch" / args[0]
    return subprocess.Popen([sys.executable, str(script), *args[1:]], env=src_env(),
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def twin_row(args, proc, t0, smi):
    """A started twin waited for -> its ``twin`` row: the tokens/s and the
    kernel launches it printed, its seconds from the phase's start."""
    import re

    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        check(False, f"{args[0]} did not finish in {CHILD_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{args[0]} exited {proc.returncode}: {out[-1500:]} {err[-2500:]}")
    rate = re.findall(r"\(([0-9.]+) tok/s", out)
    found = [ln for ln in out.splitlines() if ln.startswith("launches ")]
    check(bool(rate) and bool(found), f"{args[0]} printed no tok/s or launches: {out[-1500:]}")
    row = {"phase": "twin", "twin": args[0], "args": args[1:], "card": smi,
           "tok_s": float(rate[0]), "seconds": seconds,
           "launches": json.loads(found[-1][len("launches "):]),
           "kill_lines": [ln for ln in out.splitlines() if "kill" in ln.lower()],
           "last_lines": out.strip().splitlines()[-3:]}
    emit(row)
    return row


def phase_twins(smi):
    """Phase 11: the train_lm and serve_llm twins, each as a user runs it,
    both at once on the card; -> their launches by twin."""
    t0 = time.perf_counter()
    runs = [(args, start_twin(args)) for args in (["train_lm.py", "--steps", "20"],
                                                 ["serve_llm.py"])]
    train, serve = [twin_row(args, proc, t0, smi) for args, proc in runs]
    elapsed = time.perf_counter() - t0
    emit({"phase": "twins_summary", "card": smi, "seconds": elapsed,
          "budget_s": TWINS_BUDGET_S})
    check(train["launches"]["flash_attention"] > 0, f"train_lm launched no flash: {train}")
    for name in ("flash_attention", "decode_attention"):
        check(serve["launches"][name] > 0, f"serve_llm's survivor launched no {name}: {serve}")
    outstanding = [int(w) for ln in serve["kill_lines"]
                   for w in ln.split() if ln.startswith("SIGKILLed engine-A") and w.isdigit()]
    check(outstanding and outstanding[0] > 0, f"serve_llm killed A holding nothing: {serve}")
    check(elapsed <= TWINS_BUDGET_S, f"phase 11 took {elapsed:.1f} s > {TWINS_BUDGET_S} s")
    return {"train_lm-twin": train["launches"], "serve_llm-twin": serve["launches"]}


def vocab_serve(port, cfg, params, dev, batches, **changes):
    """Each batch of prompts submitted together and served by one engine
    until idle -> [[tokens of each request] per batch]."""
    rp = port["rp"]
    scfg = port["ServeConfig"](**VOCAB_SERVE, cache_dtype="bfloat16", **changes)
    eng = port["ContinuousEngine"](cfg, params, scfg, device=dev)
    store, kv = port["ObjectStore"](), port["KVStore"](num_shards=2)
    out = []
    for b, prompts in enumerate(batches):
        ids = [f"v{b}-{i}" for i in range(len(prompts))]
        for r, p in zip(ids, prompts):
            rp.submit(store, kv, r, list(p))
        eng.run(store, kv, engine_id="vocab", idle_timeout_s=0.3)
        res = rp.get_results(store, ids, timeout_s=10)
        out.append([res[r]["tokens"] for r in ids])
    return out


def phase_vocab(torch, port, dev, smi):
    """Phase 12a: prompts holding ids past the vocabulary (and one
    negative id) through the port's engine on the card, reduced qwen3-32b
    in bf16; -> its kernel launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(port["CONFIGS"]["qwen3-32b"].reduced(), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = port["init_params"](cfg, torch.Generator(device=dev).manual_seed(0), dev)
    wrappers = port["wrappers"]
    reset_counters(wrappers)
    bad, more = vocab_serve(port, cfg, params, dev, [VOCAB_PROMPTS, [VOCAB_MORE]])
    torch.cuda.synchronize()  # a device-side assert raises here
    launches = {name: wrappers[name].launches for name in ("flash_attention", "decode_attention")}
    swapped = [[t % cfg.vocab_size if t >= 0 else t for t in p] for p in VOCAB_PROMPTS]
    (good,) = vocab_serve(port, cfg, params, dev, [swapped])
    (sampled,) = vocab_serve(port, cfg, params, dev, [VOCAB_PROMPTS], temperature=0.8)
    torch.cuda.synchronize()
    row = {"phase": "vocab", "card": smi, "arch": cfg.name, "dtype": cfg.dtype,
           "prompts": [list(p) for p in VOCAB_PROMPTS], "tokens": bad, "more": more[0],
           "swapped_prompts": swapped, "swapped_tokens": good, "sampled_tokens": sampled,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(row)
    for name, n in launches.items():
        check(n > 0, f"phase 12a launched no {name}: {launches}")
    for i in (1, 3):
        check(bad[i] == [0] * 6, f"out-of-vocabulary prompt {VOCAB_PROMPTS[i]} gave {bad[i]}")
        check(sampled[i] == [0] * 6, f"sampled out-of-vocabulary row {i} gave {sampled[i]}")
    for i in (0, 2):
        check(bad[i] == good[i], f"prompt {i}: {bad[i]} beside bad ids, {good[i]} without")
        check(all(0 <= t < cfg.vocab_size for t in bad[i] + sampled[i]), f"prompt {i}: {bad[i]}")
    check(len(more[0]) == 6 and all(0 <= t < cfg.vocab_size for t in more[0]),
          f"the engine's next request gave {more[0]}")
    del params
    torch.cuda.empty_cache()
    return launches


def runtime_twin_row(script, proc, seconds, timed_out, out, err, smi):
    """A finished runtime twin -> its ``runtime_twin`` row, its own result
    checked from what it printed."""
    import re

    check(not timed_out, f"{script} did not finish in {CHILD_TIMEOUT_S} s: {out[-1500:]}")
    check(proc.returncode == 0, f"{script} exited {proc.returncode}: {out[-1500:]} {err[-2500:]}")
    lines = out.strip().splitlines()
    name = script[:-3]
    if name == "terasort":
        check(sum("globally ordered: True" in ln for ln in lines) == 3, f"terasort: {lines}")
    elif name == "featurize_reduce":
        acc = re.findall(r"fit accuracy: ([0-9.]+)", out)
        check(bool(acc) and float(acc[0]) >= 0.95, f"featurize_reduce: {lines}")
    elif name == "hogwild_ps":
        errs = [float(e) for e in re.findall(r"rel-err=([0-9.]+)", out)]
        check(len(errs) == 3 and max(errs) < 0.01, f"hogwild_ps: {lines}")
    elif name == "multi_driver":
        check("both drivers executed tasks of a job only A submitted" in lines, f"{lines}")
    elif name == "driver_failover":
        check("[parent] sched/job/ and shuffle/ keyspaces empty after GC" in lines, f"{lines}")
    elif name == "net_cluster":
        rec = re.findall(r"client reconnects: ([0-9]+)", out)
        check(bool(rec) and int(rec[0]) >= 1, f"net_cluster: {lines}")
    row = {"phase": "runtime_twin", "twin": script, "card": smi, "seconds": seconds,
           "last_lines": lines[-3:]}
    emit(row)
    return row


def phase_runtime_twins(smi):
    """Phase 12b: the six runtime twins, each as a user runs it, all at
    once (each waited for on a thread of its own, so each has its own
    seconds from the phase's start); -> their rows."""
    t0 = time.perf_counter()
    procs = {script: start_twin([script]) for script in RUNTIME_TWINS}
    done = {}

    def reap(script, proc):
        timed_out = False
        try:
            out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            timed_out = True
            proc.kill()
            out, err = proc.communicate()
        done[script] = (time.perf_counter() - t0, timed_out, out, err)

    waiters = [threading.Thread(target=reap, args=a, name=f"reap-{a[0]}") for a in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    rows = [runtime_twin_row(script, proc, *done[script], smi) for script, proc in procs.items()]
    elapsed = time.perf_counter() - t0
    emit({"phase": "runtime_twins_summary", "card": smi, "seconds": elapsed,
          "budget_s": RUNTIME_TWINS_BUDGET_S,
          "per_twin": {r["twin"]: r["seconds"] for r in rows}})
    check(elapsed <= RUNTIME_TWINS_BUDGET_S,
          f"phase 12b took {elapsed:.1f} s > {RUNTIME_TWINS_BUDGET_S} s")
    return rows


def load_port():
    """The port's modules and functions the phases use, by name."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import CONFIGS
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mamba2_ssd as smod
    from repro_torch.kernels import mlstm as mmod
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
    from repro_torch.models import moe, transformer, xlstm
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
    from repro_torch.serve import request_plane as rp
    from repro_torch.storage import KVStore, ObjectStore
    from repro_torch import train
    from repro_torch.core import WrenExecutor
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, train_step
    from repro_torch.util import tree_flatten, tree_map, tree_unflatten

    return dict(
        CONFIGS=CONFIGS, decode_step=decode_step, forward=forward, init_cache=init_cache,
        init_params=init_params, prefill=prefill, ContinuousEngine=ContinuousEngine,
        Engine=Engine, transformer=transformer,
        wrappers={"decode_attention": dmod.decode_attention,
                  "flash_attention": fmod.flash_attention, "ssd": smod.ssd,
                  "mlstm": mmod.mlstm},
        ServeConfig=ServeConfig, rp=rp, KVStore=KVStore, ObjectStore=ObjectStore,
        tree_flatten=tree_flatten, tree_map=tree_map, xlstm=xlstm, moe=moe,
        PlainBackwardFn=_build.PlainBackwardFn,
        plains={"flash_attention": fmod.flash_attention_plain, "ssd": smod.ssd_plain,
                "mlstm": mmod.mlstm_plain},
        train=train, train_step=train_step, elastic=elastic, ckpt=ckpt,
        DataConfig=DataConfig, synthetic_batch=synthetic_batch, WrenExecutor=WrenExecutor,
        tree_unflatten=tree_unflatten,
    )


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "child":  # phases 6a, 6c, 7c and 8c
        return child_main(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "serve-profile":
        return serve_profile(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "serve-ab":
        return serve_ab(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "bsp-wire":
        return bsp_wire(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "sanitize-ab":
        return sanitize_ab(*sys.argv[2:4])
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    port = load_port()
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import mamba2_ssd as smod
    from repro_torch.kernels import mlstm as mmod

    CONFIGS = port["CONFIGS"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(name):  # each phase's wall time, on stderr
        laps.append(time.perf_counter())
        print(f"[time] {name} {laps[-1] - laps[-2]:.1f}s", file=sys.stderr, flush=True)

    # phase 1: device and kernel build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.KERNELS:
        print(f"[{name}] " + (_build.ptxas_report(name) or "(cached build)"), file=sys.stderr)
    card = torch.cuda.get_device_name(0)
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": card, "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "build_s_per_kernel": build,
    })

    lap("1 device and build")
    rows = phase_kernels(torch, dmod, fmod, smod, ops, dev)
    rows["mlstm"] = phase_mlstm(torch, mmod, ops, dev)
    lap("2 kernels")
    attention = ("decode_attention", "flash_attention")
    deepseek = dataclasses.replace(CONFIGS["deepseek-v3-671b"], n_layers=DEEPSEEK_SERVE_LAYERS)
    launches = {}
    for cfg, kernels, idle in (
        (CONFIGS["llama3-8b"], attention, ()),
        (CONFIGS["zamba2-1.2b"], (*attention, "ssd"), ()),
        (dataclasses.replace(CONFIGS["xlstm-1.3b"], n_layers=XLSTM_SERVE_LAYERS), ("mlstm",), ()),
        (dataclasses.replace(CONFIGS["olmoe-1b-7b"], n_layers=OLMOE_SERVE_LAYERS), attention, ()),
        (deepseek, (), attention),  # MLA: Dv != D takes plain PyTorch by shape
    ):
        launches[cfg.name] = phase_serve(torch, np, port, dev, card, cfg, kernels, idle)
        lap(f"3 serve {cfg.name}")
    whisper, vlm = CONFIGS["whisper-large-v3"], CONFIGS["internvl2-1b"]
    launches[whisper.name] = phase_whisper(torch, np, port, dev, card, whisper)
    launches[vlm.name] = phase_serve(torch, np, port, dev, card, vlm, attention)
    launches[vlm.name + "+prefix"] = phase_vlm_prefix(torch, np, port, dev, card, vlm)
    lap("3f-3g whisper, internvl2")
    phase_consistency(torch, port, dev, "llama3-8b", 2, [48, 37])
    phase_consistency(torch, port, dev, "zamba2-1.2b", 7, [200, 200], with_forward=True)
    for n in (200, 137):  # exact-length prefill, as the engine groups xlstm prompts
        phase_consistency(torch, port, dev, "xlstm-1.3b", 8, [n], with_forward=True)
    phase_consistency(torch, port, dev, "olmoe-1b-7b", 2, [48, 37], with_forward=True)
    ds_moe = CONFIGS["deepseek-v3-671b"].moe
    phase_consistency(  # one dense MLA layer + one MoE layer of 16 experts (top-8, 1 shared)
        torch, port, dev, "deepseek-v3-671b", 2, [48, 37], with_forward=True,
        moe=dataclasses.replace(ds_moe, num_experts=DEEPSEEK_CHECK_EXPERTS, num_dense_layers=1),
    )
    phase_consistency(torch, port, dev, "whisper-large-v3", 2, [48, 37], with_forward=True,
                      n_encoder_layers=2)
    phase_consistency(torch, port, dev, "internvl2-1b", 2, [48, 37], with_forward=True)
    lap("4-4g consistency")
    llama = CONFIGS["llama3-8b"]
    launches["llama3-8b-train"] = phase_train_step(torch, np, port, dev, card, llama)
    lap("5a llama3-8b train")
    launches["llama3-8b-elastic"] = phase_elastic(
        torch, np, port, dev, card, dataclasses.replace(llama, n_layers=ELASTIC_LAYERS))
    lap("5b elastic")
    launches["llama3-8b-train-consistency"] = phase_train_consistency(
        torch, np, port, dev, card, n_layers=LLAMA_CONSISTENCY_LAYERS)
    lap("5c train consistency")
    xlstm_train = dataclasses.replace(CONFIGS["xlstm-1.3b"], n_layers=XLSTM_TRAIN_LAYERS)
    for cfg in (CONFIGS["zamba2-1.2b"], xlstm_train):  # phases 5d, 5e
        launches[f"{cfg.name}-train"] = phase_train_step(torch, np, port, dev, card, cfg)
        lap(f"5d/5e {cfg.name} train")
    # 5b's and 5e's launch.train runs, together (the reduced hybrid: P = N = 16)
    phase_launch_train(card, ("llama3-8b", "xlstm-1.3b", "zamba2-1.2b"))
    lap("5b/5e launch.train llama3-8b, xlstm-1.3b, zamba2-1.2b")
    # phase 5f: one super block of 6 Mamba layers + the shared block + 1
    # tail layer; one group of 7 mLSTM blocks + 1 sLSTM block
    for arch, n in (("zamba2-1.2b", 7), ("xlstm-1.3b", 8)):
        launches[f"{arch}-train-consistency"] = phase_train_consistency(
            torch, np, port, dev, card, arch, n)
        lap(f"5f {arch} train consistency")

    # phase 6: the storage plane; the smoke's process holds no model from here
    phase_storage(card)
    lap("6a file stores across processes")
    workers = phase_shared_roots(torch, np, port, card)
    launches["llama3-8b-one-worker"] = workers["one_worker"]
    launches["llama3-8b-shared-roots-survivor"] = workers["survivor"]
    lap("6b two llama3-8b workers over shared roots")
    launches["llama3-8b-elastic-resume"] = phase_elastic_resume(torch, np, port, dev, card)
    lap("6c elastic resume from disk")
    sort7b = phase_bsp(card)
    lap("7 BSP, MapReduce, terasort, the parameter server")
    launches.update(phase_wire(torch, np, port, card, sort7b))
    lap("8 the repro-kvd wire tier")
    launches.update(phase_dist(torch, port, dev, smi))
    lap("9 sharded execution on a one-card mesh")
    phase_roofline(torch, port, smi)
    lap("10 the dry-run's roofline against the card")
    launches.update(phase_twins(smi))
    lap("11 the example twins")
    launches["qwen3-32b-vocab"] = phase_vocab(torch, port, dev, smi)
    lap("12a out-of-vocabulary ids on the card")
    phase_runtime_twins(smi)
    lap("12b the runtime example twins")

    replaces = {
        "decode_attention": ("src/repro/kernels/decode_attention.py:96", DECODE_SRC),
        "flash_attention": ("src/repro/kernels/flash_attention.py:112", FLASH_SRC),
        "ssd": ("src/repro/kernels/mamba2_ssd.py:96", SSD_SRC),
        "mlstm": ("src/repro/kernels/mlstm_kernel.py:98", MLSTM_SRC),
    }
    times = lambda r: {  # noqa: E731
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    }

    def train_times(name, case):
        row = next(r for r in rows[name] if r["case"] == case)
        return {**times(row), "backward_plain_ms": row["backward_plain_ms"]}

    kernels = []
    for name, (rep, src) in replaces.items():
        # the first row is the longest serving shape of the first phase that
        # runs the kernel (attention: llama3-8b; ssd: zamba2's 300 tokens;
        # mlstm: xlstm-1.3b's 300 tokens)
        by_phase = {arch: n[name] for arch, n in launches.items() if name in n}
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            **times(rows[name][0]),
        }
        if name in ("decode_attention", "flash_attention"):  # at the other families' shapes too
            for arch in ("zamba2", "olmoe", "whisper", "internvl2"):
                entry[arch] = times(next(r for r in rows[name] if r["case"].startswith(arch)))
        # the train steps' shapes (phases 5a, 5d, 5e); 5d's and 5e's with
        # the plain backward's time
        if name == "flash_attention":
            entry["train"] = times(next(r for r in rows[name] if r["case"] == "train-2x1024"))
            entry["zamba2_train"] = train_times(name, "zamba2-train-2x1024")
        if name == "ssd":
            entry["train"] = train_times(name, "train-2x1024")
            entry["widths"] = sorted({(r["P"], r["N"]) for r in rows[name]})
            entry["build_s"] = build["mamba2_ssd"]
        if name == "mlstm":
            entry["train"] = train_times(name, MLSTM_TRAIN_CASE)
        kernels.append(entry)
    print(f"{smi}  total {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
