#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself, builds the CUDA kernels from
``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together,
into ``build/repro_torch``), and then:

* phase 1 holds each kernel against its plain PyTorch version on the card:
  ``dirty_blocks`` and ``dirty_pack`` over float32, bfloat16, int8 and int32,
  aligned, odd and ragged block geometries, 0%, 8% page-spread and 100%
  dirty blocks, an unchanged all-NaN block and an unaligned view.  Flags,
  ``count`` and ``packed[:count]`` must be bit-identical (tolerance: none),
  here and again on every tensor of phase 2 at its own shape.
* phase 2 drives the main path, ``OutOfCoreAdamW.sync_masters_from_device``,
  over the internlm2-1.8b parameter tree at full widths (depth cut to 2
  layers) with float32 masters on the card: three syncs (8% of every
  tensor's pages touched page-spread; ``lm_head`` and every norm rewritten;
  no change).  After each, the flushed bytes must equal the changed pages
  times the page size (each sync's flush time, the host's span apply and
  write-back, is printed), the window file read back with ``np.fromfile`` must
  equal the masters, the window's transfer counters must show one bitmap
  transfer per sync, one payload transfer per sync that changed a byte and
  no per-span transfer, and both kernels must have launched.

* phase 1b holds ``ops.flash_attention`` against its plain version on
  the card, bf16 through ``flash_attention_tc`` and float32 through
  ``flash_attention_tc32`` (both on the tensor cores), each of which must
  launch, and the earlier CUDA-core float32 kernel (``flash_attention``,
  on no path, a comparator) over the same float32 cases: the sweep of
  ``tests/test_kernels.py`` (four shapes; causal,
  full and window 24; causal only where S == T) plus d = 128, d = 256 and
  a ``t_actual`` case, float32 at 2e-5 and bfloat16 at 2e-2, and the main
  paths' shapes (internlm2-1.8b's B 4, H 16, K 8, S 2000, d 128, causal;
  recurrentgemma-2b's B 4, H 10, K 1, S 2000, d 256, causal, window 2048;
  and B 1, S 4096 with that window, where it binds; read through the model
  layout's strides, q and k drawn wide so the softmax is peaked) in
  float32 at 2e-5 and in bf16 at rtol 1e-2, atol 1e-4; both prefill
  shapes must also give the same bits twice.  A value head dimension
  unlike the query's goes through both kernels too: a sweep of dv in {8,
  40, 128, 256} with d in {16, 192} (causal, full and window 24, at the
  sweep's limits).  Phase 9's prefill shapes are held as the main shapes
  are (q and k wide, at their limits, the same bits twice): gemma-7b's B
  4, H = K 16, S 2000, d 256; qwen2-72b's H 64 and llama4-maverick's H 40
  over K 8 at d 128; and deepseek-v2's MLA prefill, B 4, H = K 128, d 192
  for q and k, dv 128.
* phase 3 drives the serving path, ``Engine`` with a ``SessionStore``, at
  internlm2-1.8b's full widths and depth (24 layers, 1.89 B parameters
  made on the card from a seed, cast once to bf16): 4 requests of 2000
  prompt tokens, 200 greedy steps in a 4096-position cache (the two-tier
  tail merges into main at 2048).  Run 1 is ``Engine.generate``; run 2
  saves the session (factor 0.5, under ``build/chip_smoke/``) at token
  100, drops the engine, opens a fresh one on the same store, loads, and
  runs on.  Run 2's 200 tokens must equal run 1's, the bf16 flash kernel
  (``flash_attention_tc``) must have launched once per layer in each
  prefill, and decode after
  prefill(2000) must agree with prefill(2001) to 0.02 relative
  (``tests/test_models.py``), with finite logits.  The same reading for
  two parameter seeds and four prompts is printed beside it, to show its
  spread.  Beside it, a float32 gate outside the bf16 noise: internlm2-1.8b
  at full widths cut to 4 layers, ``dtype="float32"``, a float32 cache,
  TF32 off; decode after prefill(2000) against prefill(2001) within 1e-4
  relative, with the float32 kernel (``flash_attention_tc32``) launched
  once per layer in each of its two prefills (in phases 4 and 5 the same
  holds for the float32 gates' ``ssd_scan_tc32`` and
  ``flash_attention_tc32``).
* phase 1c holds ``ops.ssd_scan`` against its plain version on the card,
  bf16 through ``ssd_scan_tc`` and float32 through ``ssd_scan_tc32`` (both
  on the tensor cores, chunks in parallel), each of which must launch, and
  the earlier CUDA-core float32 kernel (``ssd_scan``, a comparator) over
  the same float32 cases: the sweep of ``tests/test_kernels.py`` (three
  shapes, float32 at 1e-4
  and bf16 at 3e-2 relative to the largest |y|), and one mamba2-2.7b
  prefill layer (B 4, H 80, S 2000, P 64, N 128; x a view of the model's
  (B,S,H,P) activations, Bm and C one group read with a head stride of 0;
  dt log-uniform in [1e-3, 1e-1] and A = -U[1, 16], Mamba-2's published
  ranges, under which the state carries across chunks) for float32 and
  bf16 inputs: y within 1e-4 of the plain version in every 256-position
  chunk (relative to the chunk's largest |y|), the final state within
  1e-4, a plain version that zeroes the incoming state at each chunk
  boundary outside that limit, and the same bits twice.
* phase 1d holds ``ops.rg_lru_scan`` (``rg_lru_pipe``, which must
  launch) and the first RG-LRU kernel (``rg_lru``, on no path, a
  comparator) against their plain version on the card, bit for bit: the
  sweep of ``tests/test_kernels.py`` (ragged S included) and a shape with
  ragged S and W that wraps the kernel's ring of stages many times (B 3,
  S 1999, W 2600; also read through a view one element in, which takes
  the element-by-element copies) in float32 and bf16, and one
  recurrentgemma-2b prefill layer (B 4, S 2000, W 2560) with a in
  Griffin's published range (per channel u ~ U[0.9, 0.999], a = u^r,
  r ~ U(0, 1)), under which the state carries across hundreds of
  positions; a plain version that zeroes the state at each 256-position
  block start must fail 1e-5 there, and two runs must give the same
  bits.
* phase 4 drives Mamba-2 serving, ``Engine`` with a ``SessionStore``, at
  mamba2-2.7b's full widths and depth (64 layers, 2.70 B parameters made
  on the card from a seed, ``A_log`` and ``dt_bias`` set in the published
  ranges, cast once to bf16), with phase 3's traffic and session: run 2's
  200 tokens must equal run 1's, ``ssd_scan_tc`` must launch once per
  layer in each prefill, and the float32 gate (4 layers) must hold at 1e-4.  The
  bf16 full-depth readings for phase 3's seeds are printed beside it, not
  held: at 64 layers on an H100 all eight read above phase 3's 0.02, while
  the float32 gate reads about 3e-6 (PERF.md).
* phase 5 drives RecurrentGemma serving the same way at
  recurrentgemma-2b's full widths and depth (26 layers: 18 ``rglru`` and
  8 ``local_attn`` blocks, 2.89 B parameters made on the card from a seed,
  every ``lam`` set in Griffin's published range, cast once to bf16), with
  phase 3's traffic: the local-attention ring of 2048 slots wraps during
  decode, before the session is saved at token 100.  Run 2's tokens must
  equal run 1's, ``flash_attention_tc`` must launch 8 times and
  ``rg_lru_pipe`` 18 times in each prefill, and the float32 gate (4
  layers: rglru, rglru, local_attn, rglru) with a prompt of 2100 + 1, so
  that the window binds in the prefill and the ring has wrapped before the
  decode step, must hold at 1e-4.  As in phase 3, the bf16 full-depth reading on seed 0 must
  be under 0.02, with the readings for phase 3's seeds printed beside it
  (on an H100 all eight read 0.011-0.015; PERF.md).  In phases 3 to 5 the
  resumed run's final decode state must also equal the uninterrupted
  run's, bit for bit: a random recurrentgemma-2b repeats one token id,
  which would hide a wrong resume from the tokens alone.
* phase 6 trains internlm2-1.8b through ``Trainer`` at full widths (depth
  cut to 2 layers as in phase 2, 504,899,584 float32 parameters made on
  the card from seed 0, its own remat="full") on the repo's train_4k
  shape cut to one card (seq 4096, 2 sequences x 2 microbatches a step,
  ``SyntheticLM`` batches), under ``torch.use_deterministic_algorithms``
  (``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts).  Run A takes 6
  fused AdamW steps; run B the same with asynchronous A/B window
  checkpoints every 2 steps under ``build/chip_smoke/``, stopped after 4;
  run C, a fresh ``Trainer`` on that directory, must restore step 4 and
  continue to 6 with its params, moments, step and two losses equal to
  run A's, bit for bit.  Each save's window file read back must equal the
  tree saved, and its flushed bytes the tree's changed pages times the
  page size (counted by the phase from its own host copy); the newest
  manifest must validate through ``restore()``; step 0's loss must lie
  within 0.5 of a random model's ln V + 1/2.  Two offload-mode steps
  follow (bf16 params on the card, ``OutOfCoreAdamW`` on the host): finite
  losses, and after the sync the window file must equal the masters.  No
  kernel of the package may launch in phase 6: the reference's training
  path runs none (its loss runs ``blockwise_attention`` in XLA, and no
  kernel has a backward).  Both windows are removed at the end.
* phases 6b and 6c train the SSM and hybrid families through phase 6's
  routine (``TRAIN_PHASES``) on the same shape and under deterministic
  algorithms, with parameters from seed 0 in the published dynamics (as
  in phases 4 and 5): 6b mamba2-2.7b at full widths, depth cut to 2
  layers (209,141,728 parameters; the chunked SSD scan in plain torch),
  runs A, B and C with C equal to A bit for bit and each save checked,
  one microbatch a step (cut for time), no offload run; 6c
  recurrentgemma-2b at full widths, depth cut to one (rglru, rglru,
  local_attn) group (912,314,880 parameters; the RG-LRU through the
  log-depth ``linear_scan``, the window of 2048 binding at seq 4096), run
  A only (3 steps, cut from 6 for time).  In both the losses must be finite,
  step 0's bf16 loss within 2e-2 relative of the same loss in float32
  (same parameters and batch; the tied, scaled head breaks phase 6's
  ln V + 1/2 rule), and no kernel may launch: B3, B4 and B5 stay on the
  prefills.
* phase 7 drives the MPI layer across processes, with the card as the
  origin.  7a runs phase 2's configuration and traffic with the 6.06 GB
  window owned by a spawned worker (``Communicator(1, transport="mp")``):
  phase 2's checks, plus exactly one control message per sync reaching
  the owner (a ``wsync`` with spans and mask when a page changed, a bare
  ``sync`` when none did).  7b splits the masters by tensor into three
  groups of about equal bytes, puts each into the storage window of one
  of ranks 1-3 of ``Communicator(4, transport="mp")`` and syncs each
  group's first phase-2 change there with ``sync_shards_from_device``
  (flushed bytes = that rank's changed pages x 4096, one ``wsync`` each);
  7c fills a 4 x 4,096-slot storage DHT to 80% with random keys
  (``benchmarks/dht_bench.py``'s traffic and table, cut from 4 x 16,384
  slots for time; ``items()`` must equal a dict of the keys); 7d runs ``MapReduce1S`` with a checkpoint a task over
  ``benchmarks/mapreduce_bench.py``'s 24 tasks of 20,000 words (the
  result must equal ``wordcount_reduce``).  7b-7d run under inproc and mp,
  whose window files must be byte-identical.  A worker that cannot start
  or a ``TransportError`` ends the run; nothing falls back to inproc.
* phase 8 drives fault tolerance with the card as the origin.  8a puts
  7b's three groups into a storage window with
  ``storage_alloc_replication=2`` (rank r's copy on rank r + 1, rank 3's
  on rank 0; 6.06 GB of files), under inproc (a death is ``mark_dead``)
  and mp (a real ``kill_rank``): the baseline put and sync, after which
  every ``shards.bin.rep1.<r>`` must equal ``shards.bin.<r>``; phase 2's
  change 1 from the card (flushed bytes = changed pages x 4096, replicas
  equal again); rank 2's worker killed and phase 2's changes 1 and 2
  together synced into rank 2 (non-blocking: the failover runs in a pool
  task), then ranks 1 and 3 -- under mp rank 2's own op must find the
  death, flushed bytes stay exact, rank 1's mirror to rank 2 must leave its
  spans pending, and every tensor read back through the window must equal
  the masters; ``comm.rebuild_rank(2)``, which must copy exactly the pages
  ranks 1 and 2 changed meanwhile; a clean sync, after which every primary
  must equal its replica; the inproc and mp files must be byte-identical.
  8b runs ``repro_torch.launch.replicated_failover`` under mp at 7c's table
  size (4 x 16,384 slots, on 8a's mp world) with 1,024 inserts a rank
  (``benchmarks/dht_bench.py``'s keys; cut from 4,096 for time):
  rank 1 killed after a sync, reported dead by the ``FailureDetector`` and
  its monitor, every synced key served, 1,000 more inserts, a rebuild
  bit-exact with the replica and every key served again.  8c saves 7b's
  second group of the masters (503 MB, ten tensors) twice, the second
  selective, through ``CheckpointManager(..., replication=2)`` over a
  2-rank mp world, kills rank 0's worker, and ``restore()`` must return
  step 2 equal to the masters, bit for bit.
* phase 9 serves the configurations added last (``PHASE9``) at their
  published widths through phase 3's routine, random parameters from
  seed 0 (float32 cast once to bf16, or bf16 where the config's
  ``param_dtype`` is), SERVE's 4 x 2000-token prompts in a 4096-position
  cache, depth cut only where the card's 80 GB forces it, each cut
  printed with its reason: 9a gemma-7b at its 28 layers (8.5 B; MHA at
  head_dim 256), 64 steps and no session, the bf16 reading on seed 0
  under 0.02; 9b qwen2-72b cut to 4 layers (QKV bias), 64 steps, no
  session; 9c deepseek-v2-236b cut to 3 layers (the dense first layer
  and two MoE layers of 160 experts, top-6, MLA), 200 steps with the
  session saved at token 100 and reopened (the latent tail merges at
  2048); 9d llama4-maverick cut to one (attn, moe) pair (128 experts,
  top-1), 200 steps and the session.  Resumed tokens and final cache
  must equal the uninterrupted run's; ``flash_attention_tc`` must launch
  once per layer in each prefill (``moe`` blocks and MLA count as
  attention); float32 gates, with the float32 kernel, hold 9a and 9b at
  4 layers and 9c at 3 (its prompt 500 and capacity factor E/k, so that
  no assignment can drop: at the published 1.25 the capacity drops
  different assignments for S and S + 1 tokens) within 1e-4.  The other
  bf16 readings are printed, with each MoE config's routing line: how many
  of the compared token's top-k sets differ between decode and prefill(S
  + 1), and the assignments the capacity dropped.  No comparator and no
  kernel but B3 may launch.  B3 is then timed at each config's prefill
  shape in both dtypes against SDPA (``library_refused`` where SDPA does
  not take the shape).

Diagnostics go to earlier lines of standard output: the card's name and
power limit (``nvidia-smi``), build times, per-sync times, the serving
times, phase 6's step times, step profile and per-save split (host copy,
staging, flush), phase 7's mp and inproc times, wire bytes and host
memory, phase 8's sync ms per step beside 7b's, control messages, respawn
and rebuild seconds, DHT rates and checkpoint times, phases 6b's and 6c's
step times, step profiles, saves and restore, phase 9's serving times,
readings and peak device bytes, the phase walls and the command's wall,
and one JSON line
``{"kernels": [...]}`` with each of the seven
kernels of the main paths: time, launches, bound, plain-version and
library times (B1 and B2 launch in phases 2, 7a, 7b and 8a: their launches
are the sum; every row splits its launches by phase in
``launches_by_phase``, the training phases 6, 6b and 6c at 0, phase 9 at
0 but for B3, whose rows carry phase 9's shapes under ``phase9``; B3 and
B4 have a bf16 and a float32 tensor-core kernel each; the float32 B3 and B4 rows and the B5 row carry the earlier
kernel's check and times under ``comparator``, measured in the same run,
with its launches in phases 3 to 5, counted there and required to be 0;
B2 has no library time, as no one PyTorch call computes diff + pack, and
the two-call composition is timed beside it).  The last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0 and no such line is printed; the same holds when CUDA is not
available or the package is missing.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

START = time.perf_counter()  # the command's wall is printed from here

# phase 6 runs under torch.use_deterministic_algorithms, whose cuBLAS
# products need this workspace setting before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PAGE = 4096
DIRTY_FRAC = 0.08            # page-spread traffic of benchmarks/selective_sync.py
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores (data sheet)
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
# float32-accurate products on the tensor cores: each is three TF32
# products (hi.hi, hi.lo, lo.hi of operands split into TF32 hi + lo) at the
# data sheet's dense 495 TFLOP/s; the bound of the float32 attention and
# scan, whose limits need float32-accurate products
F32_MMA_FLOPS = 495e12 / 3
SMOKE_LAYERS = 2             # depth cut of internlm2-1.8b (24 layers)
WORKDIR = ROOT / "build" / "chip_smoke"
TRAIN_DIR = WORKDIR / "train"
# phase 3 traffic: 4 requests of 2000 prompt tokens, 200 greedy steps in a
# 4096-position cache, the session saved at token 100 into a combined
# window that keeps half of it in memory
SERVE = dict(batch=4, prompt=2000, max_len=4096, steps=200, save_at=100,
             factor=0.5)
# the consistency reading is also taken for these parameter and prompt
# seeds, to show its spread beside the check on seed 0 (0.02, the limit of
# tests/test_models.py)
CONSISTENCY_SEEDS = dict(params=(0, 1), prompts=(0, 1, 2, 3))
# one prefill layer's attention at the SERVE shape: B, H, K, S = T, d
ATTN_MAIN = (4, 16, 8, 2000, 128)
# recurrentgemma-2b's local attention at the SERVE shape (its window of 2048
# does not bind at S 2000), and a shape where the window binds
RG_WINDOW = 2048
ATTN_RG = (4, 10, 1, 2000, 256)
ATTN_RG_WRAP = (1, 10, 1, 4096, 256)
# the float32 consistency gate: depth cut, limit (the float32 limit of
# tests/test_torch_models.py), far above float32 rounding and far below a
# wrong cache
F32_LAYERS = 4
F32_LIMIT = 1e-4
# phases 6, 6b and 6c: trained on the repo's train_4k shape (seq 4096,
# global batch 256) cut to one card: 2 sequences a microbatch and each
# phase's microbatches a step (phase 6: 2, 16,384 tokens); run A trains the
# phase's steps, run B the same with a checkpoint every CKPT_EVERY steps and
# stops after KILL_AFTER, run C restores and continues to the phase's
# steps; the offload run takes OFFLOAD_STEPS steps
TRAIN = dict(shape="train_4k", batch=2, ckpt_every=2, kill_after=4,
             offload_steps=2)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=8)
# a random model's step-0 loss: the reference's init gives logits of unit
# variance (lm_head at fan_in^-1/2 over a unit-rms input), so its
# cross-entropy is about ln V + 1/2; held within TRAIN_LOSS0_TOL of that
TRAIN_LOSS0_TOL = 0.5
# phases 6b and 6c train the SSM and hybrid families through phase 6's
# routine at full widths on TRAIN's shape.  A tied, scaled or soft-capped
# head (theirs is tied and, for recurrentgemma-2b, scaled) breaks the
# ln V + 1/2 rule, so such a model's step-0 bf16 loss is held to the same
# loss in float32 (same params and batch) within TRAIN_F32_TOL.  Each
# phase: its config and depth, why that depth, the runs it makes (A; B and
# C: the kill and restore), whether it adds the offload run, and its steps
# and microbatches a step.  Phase 6 takes 6 steps of 2 microbatches; for
# the time limit (the whole command took 1060 s of its 1200 s on a slow
# H100 host with phase 9) 6c runs 3 steps and 6b one microbatch a step
# (the planned cuts, in that order)
TRAIN_F32_TOL = 2e-2
TRAIN_PHASES = {
    "6": dict(arch="internlm2-1.8b", n_layers=SMOKE_LAYERS,
              why="host memory: about five copies of the checkpoint tree at "
                  "once, run time limit and disk",
              runs="ABC", offload=True, steps=6, microbatches=2),
    "6b": dict(arch="mamba2-2.7b", n_layers=2,
               why="phase 6's budget: a 2.51 GB params, m and v window "
                   "against phase 6's 6.06 GB",
               runs="ABC", offload=False, steps=6, microbatches=1),
    "6c": dict(arch="recurrentgemma-2b", n_layers=3,
               why="one (rglru, rglru, local_attn) group; its 912 M "
                   "parameters make a 10.95 GB window, whose kill and "
                   "restore would hold about 71 GB on the host",
               runs="A", offload=False, steps=3, microbatches=2),
}

KERNELS = {
    "dirty_diff": {"source": "src/repro_torch/csrc/dirty_diff.cu",
                   "replaces": "src/repro/kernels/dirty_diff.py:77"},
    "diff_pack": {"source": "src/repro_torch/csrc/pack_diff.cu",
                  "replaces": "src/repro/kernels/pack_diff.py:84"},
    "flash_attention_tc": {
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86"},
    "flash_attention_tc32": {
        "source": "src/repro_torch/csrc/flash_attention_tc32.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86"},
    "flash_attention": {"source": "src/repro_torch/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention.py:86"},
    "ssd_scan_tc": {"source": "src/repro_torch/csrc/ssd_scan_tc.cu",
                    "replaces": "src/repro/kernels/ssd_scan.py:70"},
    "ssd_scan_tc32": {"source": "src/repro_torch/csrc/ssd_scan_tc32.cu",
                      "replaces": "src/repro/kernels/ssd_scan.py:70"},
    "ssd_scan": {"source": "src/repro_torch/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan.py:70"},
    "rg_lru_pipe": {"source": "src/repro_torch/csrc/rg_lru_pipe.cu",
                    "replaces": "src/repro/kernels/rg_lru.py:47"},
    "rg_lru": {"source": "src/repro_torch/csrc/rg_lru.cu",
               "replaces": "src/repro/kernels/rg_lru.py:47"},
}
# the sources to build: every kernel's
BUILD = [Path(k["source"]).stem for k in KERNELS.values()]
# the device functions of csrc/*.cu, as the profiler names them
OWN_KERNELS = re.compile(r"\(anonymous namespace\)::"
                         r"(dirty_diff|pack_rows|scan_tile|flash_|ssd_|rg_lru)")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# -- the main path (phase 2), shared with tests/test_torch_slice.py ----------

def smoke_config(n_layers: int = SMOKE_LAYERS, **widths):
    """internlm2-1.8b with its depth cut (and, for CPU tests, its widths)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("internlm2-1.8b"),
                               n_layers=n_layers, **widths)


def make_masters(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 master weights of ``param_specs(cfg)``, random from ``seed``
    (normal, std 0.02), made on ``device``."""
    from repro_torch.convert import resolve_device
    from repro_torch.models import param_specs
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(s.shape, generator=gen, device=dev,
                           dtype=torch.float32) * 0.02
            for k, s in sorted(param_specs(cfg).items())}


def mutation_plan(shapes: dict, seed: int) -> list[dict]:
    """The three syncs' changes: ``{name: flat element indices}`` where one
    element is bumped by 1.0, or ``{name: None}`` where the whole tensor is.

    1. DIRTY_FRAC of each tensor's pages, page-spread, first element of each;
    2. ``lm_head`` and every norm in full (a dense change on a subset);
    3. nothing."""
    rng = np.random.default_rng(seed)
    spread = {}
    per_page = PAGE // 4
    for k in sorted(shapes):
        n = int(np.prod(shapes[k]))
        pages = -(-n // per_page)
        pick = rng.choice(pages, size=int(pages * DIRTY_FRAC), replace=False)
        spread[k] = np.sort(pick) * per_page
    dense = {k: None for k in sorted(shapes)
             if k == "lm_head" or "norm" in k.split("/")[-1]}
    return [spread, dense, {}]


def apply_mutation(tree: dict, change: dict) -> None:
    """Apply one sync's changes in place (torch tensors or numpy arrays)."""
    for k, idx in change.items():
        flat = tree[k].reshape(-1)
        if idx is None:
            flat += 1.0
        else:
            flat[idx] += 1.0


def changed_pages(slots: dict, shapes: dict, change: dict) -> int:
    """Pages of the optimizer window a change touches, from the indices."""
    pages = set()
    for k, idx in change.items():
        off = slots[f"master/{k}"].offset
        if idx is None:
            nbytes = int(np.prod(shapes[k])) * 4
            pages.update(range(off // PAGE, -(-(off + nbytes) // PAGE)))
        else:
            pages.update(((off + np.asarray(idx) * 4) // PAGE).tolist())
    return len(pages)


def read_back_equal(path: Path, slots: dict, masters: dict) -> bool:
    """The window file at each master slot equals the masters' bytes."""
    for k, t in masters.items():
        slot = slots[f"master/{k}"]
        disk = np.fromfile(path, dtype=np.float32, count=t.numel(),
                           offset=slot.offset)
        host = t.detach().to("cpu").numpy().reshape(-1)
        if not np.array_equal(disk.view(np.uint32), host.view(np.uint32)):
            return False
    return True


class _Timed:
    """Wall time of a callable, summed over calls (seconds)."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.seconds += time.perf_counter() - t0


def run_main_path(cfg, *, device, directory: Path, seed: int = 0,
                  on_sync=None, log=print, transport: str = "inproc") -> dict:
    """Phase 2: ``OutOfCoreAdamW`` over ``param_specs(cfg)`` with masters on
    ``device``; three ``sync_masters_from_device`` calls, each checked.

    ``transport`` is the one-rank communicator's: ``inproc`` (phase 2) or
    ``mp`` (phase 7a), where a spawned worker process owns the storage
    window and each sync must reach it as exactly one control message (a
    ``wsync`` carrying spans and mask, or a bare ``sync`` when nothing
    changed).  ``on_sync(i, change, masters, snapshot)`` runs after sync
    ``i`` and before the snapshot takes the new masters.  Returns the
    counts and per-sync records."""
    from repro_torch.configs import get_config
    from repro_torch.core import Communicator
    from repro_torch.kernels import dirty_diff, pack_diff
    from repro_torch.models import param_specs
    from repro_torch.train import AdamWConfig, OutOfCoreAdamW

    dev = torch.device(device)
    specs = param_specs(cfg)
    shapes = {k: s.shape for k, s in specs.items()}
    nparams = sum(int(np.prod(s)) for s in shapes.values())
    full = get_config(cfg.name).n_layers
    log(f"reduced: n_layers {full}->{cfg.n_layers} (run time limit); "
        f"{nparams} parameters in {len(shapes)} tensors, "
        f"{nparams * 4} bytes of float32 masters on {dev}, "
        f"{nparams * 12} bytes of optimizer window")
    masters = make_masters(cfg, seed, dev)
    t0 = time.perf_counter()
    comm = Communicator(1, transport=transport)
    world_s = time.perf_counter() - t0
    channel = ChannelCount(comm.transport) if transport == "mp" else None
    # the owner's resident set (its page cache lives there), sampled
    owners = ([PeakRss(pid=comm.transport._procs[0].pid).__enter__()]
              if transport == "mp" else [])
    opt = OutOfCoreAdamW(comm, {k: (s, np.float32) for k, s in shapes.items()},
                         str(directory), AdamWConfig())
    path = Path(directory) / "optstate.bin"
    records = []
    try:
        t0 = time.perf_counter()
        opt.initialize(masters)
        opt.sync()  # clean baseline on disk
        log(f"initialize + full sync: {time.perf_counter() - t0:.3f} s")
        snapshot = {k: v.clone() for k, v in masters.items()}
        slots = opt.state.slots
        timed = _Timed(comm.transport.write_spans_masked)
        comm.transport.write_spans_masked = timed
        plan = mutation_plan(shapes, seed)
        launches = {"dirty_diff": 0, "diff_pack": 0}
        for i, change in enumerate(plan):
            apply_mutation(masters, change)
            want = changed_pages(slots, shapes, change) * PAGE
            timed.seconds = 0.0
            wire0 = comm.transport.wire_stats_snapshot()
            if channel is not None:
                channel.clear()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            # count only the main path's launches: 0 just before, read
            # just after (the measurements in on_sync launch too)
            dirty_diff.launches = 0
            pack_diff.launches = 0
            t0 = time.perf_counter()
            flushed = opt.sync_masters_from_device(masters, snapshot)
            sync_s = time.perf_counter() - t0
            launches["dirty_diff"] += dirty_diff.launches
            launches["diff_pack"] += pack_diff.launches
            st = dict(opt.state.win.device_sync_stats())
            rec = {"sync": i + 1, "flushed_bytes": flushed,
                   "expected_bytes": want, "sync_ms": sync_s * 1e3,
                   "flush_ms": timed.seconds * 1e3,
                   "dirty_diff_launches": dirty_diff.launches,
                   "diff_pack_launches": pack_diff.launches,
                   "stats": st}
            if channel is not None:
                wire1 = comm.transport.wire_stats_snapshot()
                rec["messages"] = list(channel.ops)
                rec["spans_logical_bytes"] = (wire1["spans_logical_bytes"]
                                              - wire0["spans_logical_bytes"])
                rec["spans_wire_bytes"] = (wire1["spans_wire_bytes"]
                                           - wire0["spans_wire_bytes"])
                # the roofline policy's state after this sync: its encode
                # rate and save ratio, moving averages of what it measured
                rec["codec_policy"] = comm.transport.codec_policy.snapshot()
                # one control message per sync reaches the owner: a wsync
                # with spans and mask, or a bare sync when nothing changed
                want_msgs = [(0, "wsync" if change else "sync")]
                check(rec["messages"] == want_msgs,
                      f"sync {i + 1}: control messages {rec['messages']}, "
                      f"want {want_msgs}")
            check(flushed == want,
                  f"sync {i + 1}: flushed {flushed} bytes, changed pages "
                  f"give {want}")
            check(read_back_equal(path, slots, masters),
                  f"sync {i + 1}: window file differs from the masters")
            check(st["bitmap_transfers"] == st["syncs"] == i + 1,
                  f"sync {i + 1}: one bitmap transfer per sync: {st}")
            with_change = sum(1 for c in plan[:i + 1] if c)
            check(st["payload_transfers"] == with_change,
                  f"sync {i + 1}: one payload transfer per changed sync: {st}")
            check(st["span_transfers"] == 0,
                  f"sync {i + 1}: per-span transfers on the packed route: {st}")
            if dev.type == "cuda":
                check(rec["dirty_diff_launches"] > 0
                      and rec["diff_pack_launches"] > 0,
                      f"sync {i + 1}: kernels not launched: {rec}")
            if on_sync is not None:
                on_sync(i, change, masters, snapshot)
            for k in change:
                snapshot[k].copy_(masters[k])
            records.append(rec)
            log("sync " + json.dumps({k: v for k, v in rec.items()
                                      if k != "stats"}))
    finally:
        for o in owners:
            o.__exit__(None, None, None)
        if channel is not None:
            channel.close()
        opt.free()
        comm.close()
    return {"records": records, "launches": launches, "nparams": nparams,
            "world_s": world_s,
            "owner_peak_rss_bytes": [o.peak for o in owners] or None}


class ChannelCount:
    """The ``(rank, op)`` of every control-channel message an mp transport
    sends, counted as ``tests/test_transport.py`` counts them: its
    ``_call`` and ``_post`` are wrapped on the instance until
    :meth:`close`."""

    def __init__(self, transport):
        self.ops: list[tuple[int, str]] = []
        call, post = transport._call, transport._post
        self._restore = (transport, call, post)

        def counted_call(rank, msg):
            self.ops.append((rank, msg[0]))
            return call(rank, msg)

        def counted_post(rank, msg):
            self.ops.append((rank, msg[0]))
            return post(rank, msg)

        transport._call, transport._post = counted_call, counted_post

    def clear(self) -> None:
        self.ops.clear()

    def close(self) -> None:
        transport, transport._call, transport._post = self._restore


# -- phase 1: kernels against their plain versions ----------------------------

def _case(dtype, n: int, block_elems: int, pattern: str, gen, rng, dev):
    """A (cur, snap) pair of ``n`` elements with the given dirty pattern
    (data from the torch generator ``gen``, dirty blocks from ``rng``)."""
    if dtype.is_floating_point:
        snap = (torch.randn(n, generator=gen, device=dev) * 4).to(dtype)
    else:
        info = torch.iinfo(dtype)
        snap = torch.randint(max(info.min, -1000), min(info.max, 1000), (n,),
                             generator=gen, device=dev, dtype=dtype)
    cur = snap.clone()
    nblocks = -(-n // block_elems)
    if pattern == "nan":
        # an unchanged all-NaN block stays clean; block 2 changes
        cur[block_elems:2 * block_elems] = float("nan")
        snap[block_elems:2 * block_elems] = float("nan")
        cur[2 * block_elems] += 1
        return cur, snap
    if pattern == "sparse":
        dirty = rng.choice(nblocks, size=max(1, int(nblocks * DIRTY_FRAC)),
                           replace=False)
    elif pattern == "all":
        dirty = np.arange(nblocks)
    else:
        dirty = np.arange(0)
    idx = np.minimum(dirty * block_elems + dirty % block_elems, n - 1)
    cur[torch.from_numpy(idx).to(dev)] += 1
    return cur, snap


def phase1(dev, log=print) -> float:
    """Every kernel against its plain version, bit for bit; returns the
    largest absolute difference seen (0 when they agree)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    ncases = 0
    worst = 0.0
    geoms = [(1024, 1024 * 300), (1000, 1000 * 250 + 123), (37, 37 * 4001)]
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.int32):
        for block_elems, n in geoms:
            pats = ["clean", "sparse", "all"]
            if dtype.is_floating_point:
                pats.append("nan")
            for pattern in pats:
                cur, snap = _case(dtype, n, block_elems, pattern, gen, rng,
                                  dev)
                for c, s in ((cur, snap), (cur[1:], snap[1:])):  # + unaligned
                    worst = max(worst, _compare(ops, ref, c, s, block_elems))
                    torch.cuda.synchronize(dev)
                    ncases += 1
    log(f"phase 1: {ncases} cases, dirty_blocks and dirty_pack bit-identical "
        "to their plain versions")
    return worst


def _compare(ops, ref, cur, snap, block_elems) -> float:
    c2 = ops.padded_rows(cur, block_elems)
    s2 = ops.padded_rows(snap, block_elems)
    want_flags = ref.dirty_diff_ref(c2, s2)
    flags = ops.dirty_blocks(cur, snap, block_elems=block_elems)
    check(torch.equal(flags, want_flags),
          f"dirty_blocks != plain version ({cur.dtype}, {block_elems})")
    pf, packed, count = ops.dirty_pack(cur, snap, block_elems=block_elems)
    rf, rpacked, rcount = ref.diff_pack_ref(c2, s2)
    check(torch.equal(pf, rf), "dirty_pack flags != plain version")
    check(torch.equal(count, rcount), "dirty_pack count != plain version")
    k = int(rcount.item())
    got = packed[:k].reshape(-1).view(torch.uint8)
    want = rpacked[:k].reshape(-1).view(torch.uint8)
    check(torch.equal(got, want), f"dirty_pack rows != plain version "
          f"({cur.dtype}, {block_elems}, {k} rows)")
    return float((got.int() - want.int()).abs().max()) if k else 0.0


# -- phase 1b: attention kernel against its plain version ----------------------

ATTN_SWEEP = [  # B, H, K, S, T, d: tests/test_kernels.py's shapes + d = 128
    (1, 2, 2, 64, 64, 32), (2, 4, 2, 96, 96, 16), (1, 4, 1, 40, 72, 32),
    (2, 2, 2, 33, 65, 64), (1, 4, 2, 130, 130, 128),
    (1, 4, 2, 130, 130, 256), (2, 10, 1, 70, 70, 256)]  # + d = 256
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the main path's shape: (rtol, atol).  bf16 at one bf16 ulp relative (both
# sides round the same f32 result once), float32 at the sweep's 2e-5.  q and
# k are drawn with std ATTN_MAIN_QK_STD so the softmax is peaked and a key
# tile that is dropped, misplaced or mis-masked moves rows far past these
# limits (at std 0.4 it is nearly uniform and an error hides below 2e-2)
ATTN_MAIN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-4)}
ATTN_MAIN_QK_STD = 1.5
# a value head dimension unlike the query's: a sweep of (B, H, K, S, T, d,
# dv) held like the test_kernels sweep: dv in {8, 40, 128, 256}, d in {16,
# 192}
ATTN_DV_SWEEP = [(1, 4, 2, 70, 70, d, dv) for d in (16, 192)
                 for dv in (8, 40, 128, 256)]
# phase 9's prefill attention at the SERVE shape, per config: (B, H, K, S,
# d) and dv where it differs from d (deepseek-v2's MLA: K = H, the
# up-projected keys are per head).  Held like the main shapes in phase 1b
# and timed against SDPA in both dtypes
ATTN_NEW = {
    "gemma-7b": ((4, 16, 16, 2000, 256), None),
    "qwen2-72b": ((4, 64, 8, 2000, 128), None),
    "llama4-maverick-400b-a17b": ((4, 40, 8, 2000, 128), None),
    "deepseek-v2-236b": ((4, 128, 128, 2000, 192), 128),
}


def attention_inputs(B, H, K, S, T, d, dtype, gen, dev, qk_std=0.4,
                     dv=None):
    """q (B,H,S,d) and k (B,K,T,d), normal * ``qk_std``, and v (B,K,T,dv),
    normal * 0.4 (dv defaults to d), from ``gen``, as the model hands them
    to the kernel: (B,S,H,·) storage seen through a transpose."""
    def mk(n, heads, std, width):
        x = torch.randn(B, n, heads, width, generator=gen, device=dev) * std
        return x.to(dtype).transpose(1, 2)
    return (mk(S, H, qk_std, d), mk(T, K, qk_std, d),
            mk(T, K, 0.4, d if dv is None else dv))


def _attention_err(ops, ref, q, k, v, tol=None, **kw) -> float:
    """Max abs difference of the kernel from its plain version; fails
    unless within ``tol`` = (rtol, atol), by default ATTN_TOL's."""
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    rtol, atol = tol or (ATTN_TOL[q.dtype],) * 2
    check(got.dtype == q.dtype
          and got.shape == (*q.shape[:3], v.shape[3]),
          f"flash_attention output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol)),
          f"flash_attention != plain version at rtol {rtol}, atol {atol} "
          f"({q.dtype}, {tuple(q.shape)}, {tuple(k.shape)}, {kw})")
    return float((got.float() - want.float()).abs().max())


def _comparator_attention(q, k, v, *, causal=True, window=None):
    """The earlier CUDA-core float32 attention kernel, as ``ops`` calls it."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=q.shape[-1] ** -0.5,
                                t_actual=k.shape[2])


def _comparator_ssd(x, dt, A, Bm, C, *, return_state=False):
    """The earlier CUDA-core float32 scan, as ``ops`` calls it."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    y, h = ssd_scan_cuda(x, dt, A, Bm, C)
    return (y, h) if return_state else y


# ``ops``-shaped access to the comparators (on no path) for the checks
COMPARATOR = SimpleNamespace(flash_attention=_comparator_attention,
                             ssd_scan=_comparator_ssd)


def phase1b(dev, log=print) -> dict:
    """``ops.flash_attention`` against its plain version: bf16 through
    ``flash_attention_tc``, float32 through ``flash_attention_tc32`` (both
    must launch), and the comparator (``flash_attention``) on the float32
    cases.  Returns ``{dtype or "comparator": largest absolute difference
    at the main paths' shapes}``."""
    from repro_torch.kernels import flash_attention, ops, ref
    gen = torch.Generator(device=dev).manual_seed(2)
    mods = {dt: ops.kernel_module("flash_attention", dt) for dt in ATTN_TOL}
    for mod in (*mods.values(), flash_attention):
        mod.launches = 0
    ncases, worst = 0, {}
    for dtype in ATTN_TOL:
        for B, H, K, S, T, d in ATTN_SWEEP:
            q, k, v = attention_inputs(B, H, K, S, T, d, dtype, gen, dev)
            for causal, window in ((True, None), (False, None), (True, 24)):
                if causal and S != T:
                    continue  # causal assumes aligned q/kv ends
                err = _attention_err(ops, ref, q, k, v, causal=causal,
                                     window=window)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                ncases += 1
                if dtype == torch.float32:
                    err = _attention_err(COMPARATOR, ref, q, k, v,
                                         causal=causal, window=window)
                    worst["comparator"] = max(worst.get("comparator", 0.0),
                                              err)
        q, k, v = attention_inputs(1, 4, 2, 96, 96, 64, dtype, gen, dev)
        _attention_err(ops, ref, q, k, v, causal=False, t_actual=70)
        ncases += 1
        for B, H, K, S, T, d, dv in ATTN_DV_SWEEP:
            q, k, v = attention_inputs(B, H, K, S, T, d, dtype, gen, dev,
                                       dv=dv)
            for causal, window in ((True, None), (False, None), (True, 24)):
                err = _attention_err(ops, ref, q, k, v, causal=causal,
                                     window=window, scale=0.1)
                worst[dtype] = max(worst[dtype], err)
                ncases += 1
    main_err = {}
    for name, shape, window, twice in (
            ("internlm2", ATTN_MAIN, None, True),
            ("recurrentgemma", ATTN_RG, RG_WINDOW, True),
            ("window binds", ATTN_RG_WRAP, RG_WINDOW, False),
            *((arch, new_shape if dv is None else (*new_shape, dv), None,
               True) for arch, (new_shape, dv) in ATTN_NEW.items())):
        B, H, K, S, d = shape[:5]
        dv = shape[5] if len(shape) > 5 else None
        # MLA's own scale, (dn + dr)^-1/2, is d's
        for dtype, tol in ATTN_MAIN_TOL.items():
            q, k, v = attention_inputs(B, H, K, S, S, d, dtype, gen, dev,
                                       qk_std=ATTN_MAIN_QK_STD, dv=dv)
            main_err[f"{name} {shape} window {window}, "
                     f"{str(dtype).removeprefix('torch.')}"] = _attention_err(
                ops, ref, q, k, v, tol=tol, causal=True, window=window)
            ncases += 1
            if dtype == torch.float32 and dv is None:
                main_err[f"{name} {shape} window {window}, "
                         "comparator"] = _attention_err(
                    COMPARATOR, ref, q, k, v, tol=tol, causal=True,
                    window=window)
        if twice:
            again = [ops.flash_attention(q, k, v, causal=True, window=window)
                     for _ in range(2)]
            check(torch.equal(again[0], again[1]),
                  f"flash_attention gave different bits on the same inputs "
                  f"at {shape}")
    torch.cuda.synchronize(dev)
    every = (*mods.values(), flash_attention)
    check(all(mod.launches > 0 for mod in every),
          "phase 1b: a kernel of flash_attention never launched: "
          + str({_kernel_name(m): m.launches for m in every}))
    log(f"phase 1b: {ncases} cases ("
        + ", ".join(f"{_kernel_name(m)} {m.launches} launches"
                    for m in every)
        + "), flash_attention within "
        f"{ATTN_TOL[torch.float32]} (f32, worst {worst[torch.float32]:.3g}; "
        f"comparator {worst['comparator']:.3g}) "
        f"and {ATTN_TOL[torch.bfloat16]} (bf16, worst "
        f"{worst[torch.bfloat16]:.3g}) of its plain version, dv != d "
        f"included ({len(ATTN_DV_SWEEP)} shapes, d 16 and 192, dv 8 to "
        f"256); main shapes (phase 9's too, MLA's d 192, dv 128), "
        f"causal, q and k std {ATTN_MAIN_QK_STD}, f32 at rtol = atol = 2e-5 "
        "and bf16 at rtol 1e-2, atol 1e-4, max abs err: "
        + json.dumps(main_err) + "; deterministic")
    return {key: max(v for k, v in main_err.items() if k.endswith(suffix))
            for key, suffix in ((torch.float32, "float32"),
                                (torch.bfloat16, "bfloat16"),
                                ("comparator", "comparator"))}


def measure_attention(dev, shape=ATTN_MAIN, window=None,
                      dtype=torch.bfloat16, dv=None) -> dict:
    """Kernel, plain-version and library times of one prefill layer's
    attention at a main path's shape (causal, ``window``; v of head
    dimension ``dv``, by default d) in ``dtype``, which picks the kernel
    (``flash_attention_tc`` or ``flash_attention_tc32``; for float32 with
    dv = d the comparator, the CUDA-core ``flash_attention``, is timed
    beside it on the same inputs), and its bound at the card's rate for
    that dtype's products (float32: float32-accurate products on the tensor
    cores): 2·B·H·(d + dv)·S(S+1)/2 FLOP against q, k, v and the output
    read or written once.  The library call is causal attention without a
    window: the same function wherever the window does not bind (S <=
    window).  Where SDPA refuses the shape, ``library_ms`` is None and
    ``library_refused`` says why; nothing stands in for it."""
    from repro_torch.kernels import ops, ref
    B, H, K, S, d = shape
    dv = d if dv is None else dv
    check(window is None or S <= window,
          f"the library call has no window, which binds at S {S}")
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = attention_inputs(B, H, K, S, S, d, dtype, gen, dev, dv=dv)
    flops = 2 * B * H * (d + dv) * (S * (S + 1) // 2)  # causal pairs
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + B * H * S * dv)
    t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16
                     else F32_MMA_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = {
        "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                  window=window)),
        "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window)),
        "flops": flops, "bytes": nbytes,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    try:
        out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    except RuntimeError as err:  # a shape no SDPA backend takes
        out["library_ms"] = None
        out["library_refused"] = str(err).splitlines()[0][:200]
    if dtype == torch.float32 and dv == d:
        out["comparator_ms"] = cuda_ms(lambda: _comparator_attention(
            q, k, v, causal=True, window=window))
    return out


# -- phase 1c: SSD scan kernel against its plain version ----------------------

SSD_SWEEP = [(1, 2, 64, 16, 8), (2, 3, 50, 8, 16), (1, 1, 128, 32, 4)]
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py
# one mamba2-2.7b prefill layer at the SERVE shape: B, H, S, P, N; y is
# compared per SSD_CHECK_CHUNK positions (the TPU kernel's chunk) at
# SSD_MAIN_TOL of the chunk's largest |y|, for both input dtypes (both sides
# compute in float32 from the same inputs)
SSD_MAIN = (4, 80, 2000, 64, 128)
SSD_CHECK_CHUNK = 256
SSD_MAIN_TOL = 1e-4


def ssd_sweep_inputs(B, H, S, P, N, dtype, gen, dev):
    """tests/test_kernels.py's distributions: x, Bm, C normal * 0.4 in
    ``dtype``, dt = softplus(normal * 0.4), A = -exp(normal * 0.12)."""
    def mk(*shape, scale=0.4):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return (mk(B, H, S, P).to(dtype), F.softplus(mk(B, H, S)),
            -torch.exp(mk(H, scale=0.12)), mk(B, H, S, N).to(dtype),
            mk(B, H, S, N).to(dtype))


def ssd_main_inputs(dtype, gen, dev, shape=SSD_MAIN):
    """One prefill layer's scan inputs as the model hands them over: x a
    (B,H,S,P) view of (B,S,conv_dim) activations, Bm and C one group
    broadcast over the heads (head stride 0), dt (B,H,S) a view of (B,S,H);
    dt log-uniform in [1e-3, 1e-1] and A = -U[1, 16] (Mamba-2's published
    ranges: the state carries across many chunks)."""
    B, H, S, P, N = shape
    xbc = torch.randn(B, S, H * P + 2 * N, generator=gen, device=dev).to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)

    def group(t):
        return t[:, :, None, :].expand(B, S, H, N).transpose(1, 2)
    bm, c = group(xbc[..., H * P:H * P + N]), group(xbc[..., H * P + N:])
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt = torch.exp(torch.rand(B, S, H, generator=gen, device=dev)
                   * (hi - lo) + lo).transpose(1, 2)
    A = -(1 + 15 * torch.rand(H, generator=gen, device=dev))
    return x, dt, A, bm, c


def chunk_errors(y, want, chunk: int = SSD_CHECK_CHUNK,
                 dim: int = 2) -> list[float]:
    """Per ``chunk`` positions along ``dim`` (S of (B,H,S,P) by default):
    the largest |y - want| over the chunk's largest |want|."""
    errs = []
    for s0 in range(0, want.shape[dim], chunk):
        n = min(chunk, want.shape[dim] - s0)
        w = want.narrow(dim, s0, n)
        d = (y.narrow(dim, s0, n) - w).abs().max()
        errs.append(float(d / w.abs().max().clamp_min(1e-30)))
    return errs


def phase1c(dev, log=print) -> dict:
    """``ops.ssd_scan`` against its plain version: bf16 through
    ``ssd_scan_tc``, float32 through ``ssd_scan_tc32`` (both must launch),
    and the comparator (``ssd_scan``) on the float32 cases.  Returns
    ``{dtype or "comparator": largest absolute difference of y at the main
    path's shape}``."""
    from repro_torch.kernels import ops, ref, ssd_scan
    gen = torch.Generator(device=dev).manual_seed(4)
    mods = {dt: ops.kernel_module("ssd_scan", dt) for dt in SSD_TOL}
    for mod in (*mods.values(), ssd_scan):
        mod.launches = 0
    # the kernels by the key of their results: each dtype's, and the
    # comparator on the float32 inputs
    runs = [(torch.bfloat16, torch.bfloat16, ops),
            (torch.float32, torch.float32, ops),
            ("comparator", torch.float32, COMPARATOR)]
    ncases, worst = 0, {}
    for key, dtype, impl in runs:
        tol = SSD_TOL[dtype]
        gen.manual_seed(4)  # the comparator sees float32's inputs
        for shape in SSD_SWEEP:
            args = ssd_sweep_inputs(*shape, dtype, gen, dev)
            y, h = impl.ssd_scan(*args, return_state=True)
            want, want_h = ref.ssd_scan_ref(*args, return_state=True)
            err = max(float((y - want).abs().max() / want.abs().max()),
                      float((h - want_h).abs().max() / want_h.abs().max()))
            check(y.dtype == torch.float32 and y.shape == want.shape,
                  f"ssd_scan output {y.dtype} {tuple(y.shape)}")
            check(err < tol, f"ssd_scan != plain version: {err} ({key}, "
                  f"{shape})")
            worst[key] = max(worst.get(key, 0.0), err)
            ncases += 1
    main = {}
    for key, dtype, impl in runs:
        gen.manual_seed(5)
        args = ssd_main_inputs(dtype, gen, dev)
        y, h = impl.ssd_scan(*args, return_state=True)
        want, want_h = ref.ssd_scan_ref(*args, return_state=True)
        y_err = max(chunk_errors(y, want))
        h_err = float((h - want_h).abs().max() / want_h.abs().max())
        check(y_err < SSD_MAIN_TOL and h_err < SSD_MAIN_TOL,
              f"ssd_scan at {SSD_MAIN} ({key}): y per chunk {y_err}, "
              f"state {h_err}, limit {SSD_MAIN_TOL}")
        # the check can fail: the incoming state zeroed at each chunk start
        x, dt, A, bm, c = args
        k = SSD_CHECK_CHUNK
        mutant = torch.cat([ref.ssd_scan_ref(
            x[:, :, s0:s0 + k], dt[:, :, s0:s0 + k], A, bm[:, :, s0:s0 + k],
            c[:, :, s0:s0 + k]) for s0 in range(0, x.shape[2], k)], dim=2)
        mutant_err = max(chunk_errors(mutant, want))
        check(mutant_err > SSD_MAIN_TOL,
              f"a scan that drops the carried state passes: {mutant_err}")
        again = impl.ssd_scan(*args, return_state=True)
        check(torch.equal(y, again[0]) and torch.equal(h, again[1]),
              "ssd_scan gave different bits on the same inputs")
        main[key] = {"y": y_err, "state": h_err, "zeroed_state": mutant_err,
                     "max_abs": float((y - want).abs().max())}
        ncases += 1
    torch.cuda.synchronize(dev)
    every = (*mods.values(), ssd_scan)
    check(all(mod.launches > 0 for mod in every),
          "phase 1c: a kernel of ssd_scan never launched: "
          + str({_kernel_name(m): m.launches for m in every}))
    log(f"phase 1c: {ncases} cases ("
        + ", ".join(f"{_kernel_name(m)} {m.launches} launches"
                    for m in every)
        + f"), ssd_scan within {SSD_TOL[torch.float32]} "
        f"(f32, worst {worst[torch.float32]:.3g}; comparator "
        f"{worst['comparator']:.3g}) and "
        f"{SSD_TOL[torch.bfloat16]} (bf16, worst "
        f"{worst[torch.bfloat16]:.3g}) of its plain version; main shape "
        f"{SSD_MAIN} per {SSD_CHECK_CHUNK}-position chunk (limit "
        f"{SSD_MAIN_TOL}): " + json.dumps(
            {str(k).removeprefix("torch."): v for k, v in main.items()})
        + "; deterministic")
    return {key: v["max_abs"] for key, v in main.items()}


def measure_ssd(dev, dtype=torch.bfloat16) -> dict:
    """Kernel, plain-version and plain chunked-form times of one prefill
    layer's scan at the main path's shape with x, Bm and C in ``dtype``,
    which picks the kernel (``ssd_scan_tc`` or ``ssd_scan_tc32``, chunks
    in parallel; for float32 the comparator, the CUDA-core ``ssd_scan``, is
    timed beside it on the same inputs), and its bound at the card's rate
    for that dtype's products (float32: float32-accurate tensor-core
    products).  The kernel's scratch, read from the caching allocator (the
    peak of one call beyond what was allocated before it and the outputs
    it returns, in the allocator's rounded blocks), is reported beside the
    bound, which counts only the function's inputs and outputs."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import ssd_chunked
    B, H, S, P, N = SSD_MAIN
    kernel = ops.kernel_module("ssd_scan", dtype)
    chunk = kernel.CHUNK
    gen = torch.Generator(device=dev).manual_seed(5)
    x, dt, A, bm, c = ssd_main_inputs(dtype, gen, dev)
    # the least work: the chunked form at the kernel's chunk, scores only
    # for i >= j (l(l+1)/2 of a chunk of l), C.h and the state update
    pairs = sum(min(chunk, S - s0) * (min(chunk, S - s0) + 1) // 2
                for s0 in range(0, S, chunk))
    flops = 2 * B * H * (pairs * (N + P) + 2 * S * N * P)
    # each input read once (Bm and C: one group, B*S*N values each), y and
    # the final state written once
    nbytes = (x.element_size() * (B * S * H * P + 2 * B * S * N)
              + 4 * (B * H * S + H) + 4 * (B * H * S * P + B * H * N * P))
    rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_MMA_FLOPS
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    model = (x.transpose(1, 2), dt.transpose(1, 2), A, bm.transpose(1, 2),
             c.transpose(1, 2))
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    y, h = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    torch.cuda.synchronize(dev)
    scratch = torch.cuda.max_memory_allocated(dev) - before \
        - y.nbytes - h.nbytes
    del y, h
    out = {
        "ms": cuda_ms(lambda: ops.ssd_scan(x, dt, A, bm, c,
                                           return_state=True)),
        "plain_ms": cuda_ms(lambda: ref.ssd_scan_ref(x, dt, A, bm, c,
                                                     return_state=True)),
        "chunked_torch_ms": cuda_ms(
            lambda: ssd_chunked(*model, chunk=SSD_CHECK_CHUNK)),
        "flops": flops, "bytes": nbytes,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "scratch_bytes": scratch,
    }
    if dtype == torch.float32:
        out["comparator_ms"] = cuda_ms(lambda: _comparator_ssd(
            x, dt, A, bm, c, return_state=True))
    return out


# -- phase 1d: RG-LRU kernel against its plain version -------------------------

RG_SWEEP = [(1, 64, 16), (2, 70, 32), (1, 256, 8)]  # tests/test_kernels.py
# ragged S and W that wrap the kernel's ring of stages many times, read
# through an aligned and an unaligned (offset by one element) view
RG_WRAP = (3, 1999, 2600)
# one recurrentgemma-2b prefill layer at the SERVE shape: B, S, W.  y must
# equal the plain version's bit for bit (both round the product and the sum
# one at a time); a plain version that drops the carried state at every
# RG_CHECK_BLOCK positions (the TPU kernel's block) must fail RG_TOL there,
# relative to the block's largest |y| (RG_TOL: tests/test_kernels.py)
RG_MAIN = (4, 2000, 2560)
RG_CHECK_BLOCK = 256
RG_TOL = 1e-5
# Griffin's published range for a (arXiv:2402.19427, section 2.4: a^c
# uniform in [0.9, 0.999])
RG_A_RANGE = (0.9, 0.999)


def rg_lru_main_inputs(gen, dev, shape=RG_MAIN):
    """One prefill layer's recurrence inputs: per channel u ~ U(RG_A_RANGE)
    and a = u^r with r ~ U(0, 1) per position (the gate r_t of
    ``_gates``), gx = sqrt(1 - a^2) * normal, all float32."""
    B, S, W = shape
    lo, hi = RG_A_RANGE
    u = lo + (hi - lo) * torch.rand(W, generator=gen, device=dev)
    a = u ** torch.rand(B, S, W, generator=gen, device=dev)
    gx = torch.sqrt(1 - a * a) * torch.randn(B, S, W, generator=gen,
                                             device=dev)
    return a, gx


def _comparator_rg_lru(a, gx):
    """The first RG-LRU kernel, loads in the walk, as ``ops`` calls it."""
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    return rg_lru_cuda(a, gx)


def phase1d(dev, log=print) -> dict:
    """``ops.rg_lru_scan`` (``rg_lru_pipe``, which must launch) and the
    comparator (``rg_lru``) against the plain version, bit for bit; returns
    ``{"kernel" or "comparator": largest absolute difference}`` (0 when
    they agree)."""
    from repro_torch.kernels import ops, ref
    kernel = ops.kernel_module("rg_lru", torch.float32)
    kernel.launches = 0
    gen = torch.Generator(device=dev).manual_seed(6)
    # (shape, offset): offset 1 is a view one element in, which the
    # kernel reads by its element-by-element copies
    shapes = [(shape, 0) for shape in RG_SWEEP] + [(RG_WRAP, 0), (RG_WRAP, 1)]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, W), off in shapes:
            a = torch.sigmoid(torch.randn(B, S, W + off, generator=gen,
                                          device=dev) * 0.4).to(dtype)
            gx = (torch.randn(B, S, W + off, generator=gen, device=dev)
                  * 0.4).to(dtype)
            cases.append((a[..., off:], gx[..., off:]))
    for a, gx in cases:
        want = ref.rg_lru_ref(a, gx)
        for label, fn in (("rg_lru_scan", ops.rg_lru_scan),
                          ("comparator", _comparator_rg_lru)):
            y = fn(a, gx)
            check(y.dtype == torch.float32 and y.shape == a.shape,
                  f"{label} output {y.dtype} {tuple(y.shape)}")
            check(torch.equal(y, want), f"{label} != plain version "
                  f"({a.dtype}, {tuple(a.shape)}, stride {a.stride()}, "
                  f"offset {a.storage_offset()})")
    a, gx = rg_lru_main_inputs(gen, dev)
    want = ref.rg_lru_ref(a, gx)
    worst = {}
    for label, fn in (("kernel", ops.rg_lru_scan),
                      ("comparator", _comparator_rg_lru)):
        y = fn(a, gx)
        worst[label] = float((y - want).abs().max())
        check(torch.equal(y, want), f"{label} at {RG_MAIN} != plain "
              f"version: max abs {worst[label]}")
        check(torch.equal(y, fn(a, gx)),
              f"{label} gave different bits on the same inputs")
    # the check can fail: the carried state dropped at each block start
    k = RG_CHECK_BLOCK
    mutant = torch.cat([ref.rg_lru_ref(a[:, s0:s0 + k], gx[:, s0:s0 + k])
                        for s0 in range(0, a.shape[1], k)], dim=1)
    mutant_err = max(chunk_errors(mutant, want, k, dim=1))
    check(mutant_err > RG_TOL,
          f"a recurrence that drops the carried state passes: {mutant_err}")
    torch.cuda.synchronize(dev)
    check(kernel.launches > 0, f"{_kernel_name(kernel)} never launched")
    log(f"phase 1d: {len(cases) + 1} cases, rg_lru_scan "
        f"({_kernel_name(kernel)}) and the comparator bit-identical to the "
        f"plain version (f32 and bf16 sweep, {RG_WRAP} aligned and offset "
        f"by one; main shape {RG_MAIN} with a in Griffin's range "
        f"{RG_A_RANGE}); the state zeroed every {RG_CHECK_BLOCK} positions: "
        f"{mutant_err:.3g} per block, limit {RG_TOL}; deterministic")
    return worst


def measure_rg_lru(dev) -> dict:
    """Kernel, comparator and plain-version times of one prefill layer's
    recurrence at the main path's shape (float32, as the model hands it
    over), and its bound.  No PyTorch call computes the recurrence; beside
    it, ``torch.add(a, gx)`` moves the same bytes (``same_bytes_ms``: what
    PyTorch's elementwise kernel reaches for that traffic)."""
    from repro_torch.kernels import ops, ref
    B, S, W = RG_MAIN
    gen = torch.Generator(device=dev).manual_seed(7)
    a, gx = rg_lru_main_inputs(gen, dev)
    y = torch.empty_like(a)
    flops = 2 * B * S * W  # a product and a sum per element
    nbytes = 4 * 3 * B * S * W  # a and gx read, y written, float32
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    # 20 launches a mean: at 0.1 ms a launch, the host's latency to the
    # first one would weigh in a mean of 5
    return {
        "ms": cuda_ms(lambda: ops.rg_lru_scan(a, gx), reps=20),
        "comparator_ms": cuda_ms(lambda: _comparator_rg_lru(a, gx), reps=20),
        "same_bytes_ms": cuda_ms(lambda: torch.add(a, gx, out=y), reps=20),
        "plain_ms": cuda_ms(lambda: ref.rg_lru_ref(a, gx)),
        "flops": flops, "bytes": nbytes,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


# -- phase 3: the serving path ------------------------------------------------------

def _timed_ms(fn, dev):
    """(result, wall ms) of ``fn``, the card synchronised on both sides."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def device_profile(fn, nrep: int = 1) -> dict:
    """Wall time of ``nrep`` calls of ``fn`` against the card's busy time
    in them (the sum of the kernel and copy times that ``torch.profiler``
    traces on the device; one stream, so they do not overlap), the
    kernels by device time, and the device time of each of this package's
    kernels (``own_ms``, by OWN_KERNELS)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nrep):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / nrep
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / nrep
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "device_ops_per_call": sum(e.count for e in events) / nrep,
            "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 / nrep
                       for e in top},
            "own_ms": {e.key[:60]: e.self_device_time_total / 1e3 / nrep
                       for e in events if OWN_KERNELS.search(e.key)}}


def consistency_rel_err(cfg, eng, tokens: np.ndarray) -> float:
    """Decode after prefill(S) against prefill(S + 1) on ``eng`` (S =
    ``tokens.shape[1] - 1``, ``tokens[:, -1]`` the decoded token): the
    largest absolute difference of the logits over the largest |logit|.
    Fails on a non-finite logit."""
    from repro_torch.models import make_prefill_fn
    S = tokens.shape[1] - 1
    eng.prefill({"inputs": tokens[:, :S]})
    dec = eng.decode_logits(tokens[:, S:])
    full, _ = make_prefill_fn(cfg)(
        eng.params, {"inputs": torch.from_numpy(tokens).long().to(eng.device)},
        eng.cache)
    a, b = dec.float().cpu().numpy(), full.float().cpu().numpy()
    check(bool(np.isfinite(a).all() and np.isfinite(b).all()),
          "non-finite logits")
    return float(np.abs(a - b).max() / max(1e-6, float(np.abs(b).max())))


def prefill_kernels(cfg) -> dict:
    """``{kernel module: launches in one prefill of cfg}``: each layer's
    prefill launches its kind's kernel once (a ``moe`` block's attention,
    GQA or MLA, is attention), attention and the SSD scan
    the one for ``cfg.dtype`` (``flash_attention_tc``/``ssd_scan_tc`` for
    bf16, ``flash_attention_tc32``/``ssd_scan_tc32`` for float32), the
    recurrence ``rg_lru_pipe`` for both."""
    from repro_torch.kernels import ops
    dtype = getattr(torch, cfg.dtype)
    attn = ops.kernel_module("flash_attention", dtype)
    of_kind = {"attn": attn, "local_attn": attn, "moe": attn,
               "ssm": ops.kernel_module("ssd_scan", dtype),
               "rglru": ops.kernel_module("rg_lru", dtype)}
    out: dict = {}
    for reps, pattern in cfg.groups():
        for kind in pattern:
            out[of_kind[kind]] = out.get(of_kind[kind], 0) + reps
    return out


def _kernel_name(module) -> str:
    return module.__name__.rsplit(".", 1)[-1]


def float32_consistency(cfg, params: dict, tokens: np.ndarray, *,
                        device) -> float:
    """:func:`consistency_rel_err` with everything in float32: ``cfg`` at
    ``dtype="float32"`` (``Engine`` turns TF32 off) and the cache allocated
    in float32 too (the reference's cache specs are bf16 even in a float32
    config, which would put bf16 rounding into the reading)."""
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(cfg, dtype="float32")
    eng = Engine(cfg, params, batch=tokens.shape[0], max_len=tokens.shape[1],
                 device=device)
    eng.cache = {k: v.float() for k, v in eng.cache.items()}
    return consistency_rel_err(cfg, eng, tokens)


def ssm_dynamics(cfg, seed: int) -> dict[str, np.ndarray]:
    """``A_log`` and ``dt_bias`` of every SSM layer in Mamba-2's published
    initialization ranges, from numpy: dt log-uniform in [1e-3, 1e-1] with
    ``dt_bias = dt + log(-expm1(-dt))`` (softplus inverted) and A = -U[1, 16].
    Under the reference's zeros the state forgets within a few tokens, which
    would hide a fault in the carried state."""
    from repro_torch.models import param_specs
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(param_specs(cfg).items()):
        leaf = name.split("/")[-1]
        if leaf == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), spec.shape))
            out[name] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        elif leaf == "A_log":
            out[name] = np.log(rng.uniform(1, 16, spec.shape)).astype(
                np.float32)
    return out


class RouteLog:
    """While open, records each MoE layer's routing (``lm.moe_mlp`` is
    wrapped): per call, the top-k experts of every request's last position
    (B, k), and how many of the call's assignments the capacity dropped,
    over all positions and for the last ones.  The records cost one router
    product and one sort a call; nothing of the model's result changes."""

    def __init__(self):
        self.calls: list[dict] = []

    def __enter__(self):
        from repro_torch.models import lm, moe
        self._lm, self._orig = lm, lm.moe_mlp

        def recorded(cfg, p, x, **kw):
            B, S, D = x.shape
            xf = x.reshape(B * S, D)
            _, _, eidx = moe.route(xf.float() @ p["router"].float(),
                                   cfg.top_k)
            cap = moe.moe_capacity(B * S, cfg.n_experts, cfg.top_k,
                                   cfg.capacity_factor)
            keep = moe.assignment_slots(eidx, cfg.n_experts, cap)[1]
            keep = keep.reshape(B, S, cfg.top_k)
            self.calls.append({
                "last": eidx.reshape(B, S, -1)[:, -1].cpu().numpy(),
                "dropped": int((~keep).sum()),
                "dropped_last": int((~keep[:, -1]).sum())})
            return self._orig(cfg, p, x, **kw)

        lm.moe_mlp = recorded
        return self

    def __exit__(self, *exc):
        self._lm.moe_mlp = self._orig


def route_flips(n_moe: int, calls: list[dict]) -> dict:
    """From a RouteLog of :func:`consistency_rel_err` (prefill(S), the
    decode step, prefill(S + 1): ``n_moe`` calls each): how many (layer,
    request) top-k sets of the compared token differ between the decode
    step and prefill(S + 1), and the assignments the capacity dropped in
    each prefill (all, and the compared token's)."""
    check(len(calls) == 3 * n_moe, f"{len(calls)} MoE calls, not "
          f"3 x {n_moe}")
    dec, full = calls[n_moe:2 * n_moe], calls[2 * n_moe:]
    flips = sum(set(a.tolist()) != set(b.tolist())
                for d, f in zip(dec, full)
                for a, b in zip(d["last"], f["last"]))
    return {"top_k_sets_differ": flips,
            "of": n_moe * len(dec[0]["last"]) if n_moe else 0,
            "dropped_prefill_S": sum(c["dropped"] for c in calls[:n_moe]),
            "dropped_prefill_S1": sum(c["dropped"] for c in full),
            "dropped_compared_token_S1": sum(c["dropped_last"]
                                             for c in full)}


def run_serving(cfg, params: dict, tokens: np.ndarray, *, device,
                directory: Path, max_len: int, steps: int,
                save_at: int | None, factor,
                consistency_limit: float | None = 0.02) -> dict:
    """Phase 3: greedy serving of ``tokens[:, :-1]`` through ``Engine``.

    Run 1 is ``Engine.generate(steps)``.  Run 2 takes ``save_at`` tokens,
    saves the session into a ``SessionStore`` under ``directory``, drops
    the engine, opens a fresh one on the same store, loads the session and
    takes the rest (``save_at`` None: run 2 takes every step on one
    engine, with no session).  Then decode after prefill(S) is compared
    with prefill(S + 1) (S = the prompt length, ``tokens[:, -1]`` the extra
    token); for a MoE config the compared token's routing in the two is
    compared too (``route_flips``).  Checks: run 2's tokens equal run 1's,
    and so does its decode
    state after the last step, bit for bit (a token stream that repeats one
    id, as a random model's may, would hide a resume that went wrong); on a
    card, each prefill
    kernel launched as often in each prefill as :func:`prefill_kernels`
    says; the logits are finite and, unless ``consistency_limit`` is None,
    consistent within it.  Returns the tokens, the counts (``launches``:
    per kernel, over both prefills) and the times."""
    from repro_torch.core import Communicator
    from repro_torch.models import init_cache_specs
    from repro_torch.serve import Engine, SessionStore

    dev = torch.device(device)
    batch, S = tokens.shape[0], tokens.shape[1] - 1
    inputs = {"inputs": tokens[:, :S]}
    on_card = dev.type == "cuda"
    out = {}

    def engine(**kw):
        return Engine(cfg, params, batch=batch, max_len=max_len,
                      device=dev, **kw)

    # the main path: counts at 0 just before it, read just after
    kernels = prefill_kernels(cfg)
    for mod in kernels:
        mod.launches = 0
    eng = engine()
    run1, out["generate_ms"] = _timed_ms(
        lambda: eng.generate(inputs, steps), dev)
    launches_run1 = {mod: mod.launches for mod in kernels}
    final1 = {k: v.cpu() for k, v in eng.cache.items()}  # host: no peak
    del eng
    store = None if save_at is None else SessionStore(
        Communicator(1), str(directory / "session.bin"),
        init_cache_specs(cfg, batch, max_len), factor=factor)
    try:
        eng = engine(session=store)
        first, out["prefill_ms"] = _timed_ms(lambda: eng.prefill(inputs), dev)
        launches_prefill2 = {mod: mod.launches - launches_run1[mod]
                             for mod in kernels}
        seq, step_ms = [first], []

        def take(n):
            for _ in range(n):
                nxt, ms = _timed_ms(lambda: eng.step(seq[-1]), dev)
                seq.append(nxt)
                step_ms.append(ms)

        if store is None:
            take(steps - 1)
        else:
            take(save_at - 1)
            eng.generated = list(seq)
            out["session_flushed_bytes"], out["save_ms"] = _timed_ms(
                eng.save_session, dev)
            del eng
            eng, out["engine_open_ms"] = _timed_ms(
                lambda: engine(session=store), dev)
            _, out["load_ms"] = _timed_ms(eng.load_session, dev)
            check(eng.pos == S + save_at - 1,
                  f"loaded position {eng.pos}, saved {S + save_at - 1}")
            take(steps - save_at)
        out["launches"] = {_kernel_name(mod): mod.launches for mod in kernels}
        run2 = np.stack(seq, axis=1)
        out["tokens"] = run2
        check(np.array_equal(run1, run2),
              "the resumed session's tokens differ from the uninterrupted "
              f"run's: first at {np.argwhere(run1 != run2)[:1].tolist()}")
        differ = [k for k, v in final1.items()
                  if not torch.equal(v, eng.cache[k].cpu())]
        check(not differ, "the resumed session's final decode state differs "
              f"from the uninterrupted run's in {differ[:3]}")
        out["distinct_tokens"] = int(np.unique(run2).size)
        if on_card:
            for mod, want in kernels.items():
                check(launches_run1[mod] == launches_prefill2[mod] == want,
                      f"{_kernel_name(mod)} launched {launches_run1[mod]} "
                      f"and {launches_prefill2[mod]} times in the prefills, "
                      f"not {want} ({cfg.n_layers} layers)")
        if on_card:  # where the time goes, after the main path
            nxt = seq[-1]

            def step():
                nonlocal nxt
                nxt = eng.step(nxt)
            out["decode_profile"] = device_profile(step, nrep=3)
            out["prefill_profile"] = device_profile(
                lambda: eng.prefill(inputs))
        n_moe = sum(reps * pattern.count("moe")
                    for reps, pattern in cfg.groups())
        with RouteLog() as routes:
            out["consistency_rel_err"] = consistency_rel_err(cfg, eng,
                                                             tokens)
        if n_moe:
            out["routing"] = route_flips(n_moe, routes.calls)
        if consistency_limit is not None:
            check(out["consistency_rel_err"] < consistency_limit,
                  f"decode after prefill({S}) vs prefill({S + 1}): relative "
                  f"error {out['consistency_rel_err']}")
        del eng
    finally:
        if store is not None:
            store.free()
    out["step_ms"] = step_ms
    out["decode_ms_per_step"] = float(np.mean(step_ms))
    out["decode_ms_per_step_median"] = float(np.median(step_ms))
    out["decode_tokens_per_s"] = batch * 1e3 / out["decode_ms_per_step"]
    out["prefill_tokens_per_s"] = batch * S * 1e3 / out["prefill_ms"]
    return out


def rglru_dynamics(cfg, seed: int) -> dict[str, np.ndarray]:
    """``lam`` of every RG-LRU layer in Griffin's published range, from
    numpy: per channel u ~ U(RG_A_RANGE) and ``softplus(lam) = -ln(u)/8``,
    so that a_t = u^(r_t) (arXiv:2402.19427, section 2.4).  Under the
    reference's ones a is about e^-5 a position at r ~ 0.5, and the state
    is forgotten within a token or two, which would hide a fault in the
    carried state."""
    from repro_torch.models import param_specs
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(param_specs(cfg).items()):
        if name.split("/")[-1] == "lam":
            sp = -np.log(rng.uniform(*RG_A_RANGE, spec.shape)) / 8
            out[name] = np.log(np.expm1(sp)).astype(np.float32)
    return out


def prompt_tokens(cfg, seed: int, length: int = SERVE["prompt"]) -> np.ndarray:
    """SERVE's requests: (batch, length + 1) token ids from numpy."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(SERVE["batch"], length + 1)).astype(np.int32)


def model_params(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    """Random float32 parameters of ``cfg`` from ``seed``, made on
    ``device``; SSM layers take :func:`ssm_dynamics`, RG-LRU layers
    :func:`rglru_dynamics`."""
    from repro_torch.models import init_params, param_specs
    params = init_params(param_specs(cfg), seed, device=device)
    for k, a in {**ssm_dynamics(cfg, seed),
                 **rglru_dynamics(cfg, seed)}.items():
        params[k].copy_(torch.from_numpy(a))
    return params


def bf16_readings(cfg, dev) -> dict[str, float]:
    """:func:`consistency_rel_err` of ``cfg`` (bf16, SERVE's batch and
    cache) for every pair of CONSISTENCY_SEEDS."""
    from repro_torch.serve import Engine
    readings = {}
    for pseed in CONSISTENCY_SEEDS["params"]:
        params = model_params(cfg, pseed, dev)
        eng = Engine(cfg, params, batch=SERVE["batch"],
                     max_len=SERVE["max_len"], device=dev)
        for tseed in CONSISTENCY_SEEDS["prompts"]:
            readings[f"params {pseed}, prompt {tseed}"] = consistency_rel_err(
                cfg, eng, prompt_tokens(cfg, tseed))
        del eng, params
    return readings


def serving_phase(arch: str, dev, *, consistency_limit: float | None,
                  depths: tuple[int, ...] = (),
                  f32_prompt: int = SERVE["prompt"], log=print) -> dict:
    """``arch`` served at full widths and depth (:func:`run_serving` with
    SERVE's traffic); then the bf16 consistency reading for other parameter
    and prompt seeds (reported beside the check, which is made on seed 0
    only, where ``consistency_limit`` is given), and the same readings
    with the depth cut to each of ``depths``; then the float32 gate at
    F32_LAYERS layers with a prompt of ``f32_prompt`` + 1, held to
    F32_LIMIT.  The comparators (the CUDA-core ``flash_attention`` and
    ``ssd_scan`` and the first ``rg_lru``, on no path) must not launch in
    any of it: their counts are set to 0 at the start and read at the end
    (``comparator_launches``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, rg_lru, ssd_scan
    comparators = (flash_attention, ssd_scan, rg_lru)
    for mod in comparators:
        mod.launches = 0
    cfg = get_config(arch)
    params = model_params(cfg, 0, dev)
    nparams = sum(t.numel() for t in params.values())
    log(f"serving {cfg.name}: {cfg.n_layers} layers, {nparams} parameters "
        f"made on {dev} in float32; {SERVE}")
    shutil.rmtree(WORKDIR, ignore_errors=True)
    WORKDIR.mkdir(parents=True)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        out = run_serving(cfg, params, prompt_tokens(cfg, 0), device=dev,
                          directory=WORKDIR,
                          consistency_limit=consistency_limit,
                          **{k: SERVE[k] for k in
                             ("max_len", "steps", "save_at", "factor")})
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["nparams"] = nparams
    del params
    out["consistency_readings"] = bf16_readings(cfg, dev)
    out["consistency_readings_by_depth"] = {
        n: bf16_readings(dataclasses.replace(cfg, n_layers=n), dev)
        for n in depths}
    cut = dataclasses.replace(cfg, n_layers=F32_LAYERS)
    # the gate runs the float32 kernels: two prefills (the engine's and the
    # prefill of S + 1), each kernel once per layer of its kind
    f32_kernels = prefill_kernels(dataclasses.replace(cut, dtype="float32"))
    for mod in f32_kernels:
        mod.launches = 0
    out["float32_rel_err"] = float32_consistency(
        cut, model_params(cut, 0, dev), prompt_tokens(cut, 0, f32_prompt),
        device=dev)
    out["float32_launches"] = {_kernel_name(mod): mod.launches
                               for mod in f32_kernels}
    for mod, want in f32_kernels.items():
        check(mod.launches == 2 * want,
              f"{cfg.name} float32 gate: {_kernel_name(mod)} launched "
              f"{mod.launches} times, not {2 * want}")
    check(out["float32_rel_err"] < F32_LIMIT,
          f"{cfg.name}, {F32_LAYERS} layers in float32: decode after "
          f"prefill({f32_prompt}) vs prefill({f32_prompt + 1}): "
          f"relative error {out['float32_rel_err']}")
    out["comparator_launches"] = {_kernel_name(mod): mod.launches
                                  for mod in comparators}
    check(not any(out["comparator_launches"].values()),
          f"{cfg.name}: a comparator on no path launched: "
          f"{out['comparator_launches']}")
    return out

# -- phase 9: the configurations added last, served -------------------------

# phase 9 serves each configuration at its published widths, random
# parameters from seed 0 (in float32 unless the config's param_dtype is
# bf16), depth cut only where the card's 80 GB forces it.  Per sub-phase:
# the config, its depth and why, the decode steps, whether SERVE's session
# is saved and reopened (gemma-7b's 7.5 GB cache would cost tens of seconds
# to save and load, and phase 3 holds the dense session), the limit of the
# bf16 consistency reading on seed 0 (None: printed, not held) and the
# float32 gate: its depth, prompt and config changes (None: no gate)
PHASE9 = {
    "9a": dict(arch="gemma-7b", n_layers=None, why=None, steps=64,
               session=False, consistency_limit=0.02,
               f32=dict(n_layers=F32_LAYERS, prompt=SERVE["prompt"])),
    "9b": dict(arch="qwen2-72b", n_layers=4,
               why="80 layers are 145 GB in bf16; 4 are 6.0 B parameters",
               steps=64, session=False, consistency_limit=None,
               f32=dict(n_layers=4, prompt=SERVE["prompt"])),
    # the gate's capacity is raised to E/k, where no assignment can drop:
    # at the published 1.25 the capacity drops different assignments for
    # S and S + 1 tokens (the routing line shows them in the bf16 run),
    # which would move the reading far from the cache it holds; its
    # prompt is cut so that the (E, T + 1, D) float32 dispatch fits
    "9c": dict(arch="deepseek-v2-236b", n_layers=3,
               why="60 layers are 472 GB in bf16; 3 (the dense first and "
                   "two MoE layers) are 9.3 B parameters",
               steps=SERVE["steps"], session=True, consistency_limit=None,
               f32=dict(n_layers=3, prompt=500, capacity="no drops")),
    # top-1 routing: one flipped token moves the last logits far, and a
    # float32 copy of 37 GB of experts does not fit beside the served
    # model; llama4's float32 gate is held on the CPU at smoke size
    "9d": dict(arch="llama4-maverick-400b-a17b", n_layers=2,
               why="48 layers are 802 GB in bf16; one (attn, moe) pair is "
                   "18.7 B parameters",
               steps=SERVE["steps"], session=True, consistency_limit=None,
               f32=None),
}


# phase 9's traffic: SERVE's requests and cache; the steps are PHASE9's
PHASE9_TRAFFIC = {k: SERVE[k] for k in ("batch", "prompt", "max_len",
                                        "save_at", "factor")}


def phase9_config(sub: str, smoke: bool = False):
    """The served config of a PHASE9 entry: published widths, depth cut
    (``smoke``: the smoke config, as tests/test_torch_slice.py runs it)."""
    from repro_torch.configs import get_config
    spec = PHASE9[sub]
    cfg = get_config(spec["arch"], smoke=smoke)
    if spec["n_layers"] is not None and not smoke:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    return cfg


def phase9_gate_config(cfg, gate: dict):
    """The float32 gate's config: float32 compute and parameters, depth
    cut; ``capacity="no drops"`` sets the capacity factor to E/k, so that
    every expert holds T + 1 assignments: top-k experts are distinct, so
    none gets more than T and nothing drops."""
    kw = dict(dtype="float32", param_dtype="float32")
    if gate["n_layers"] < cfg.n_layers:
        kw["n_layers"] = gate["n_layers"]
    if gate.get("capacity") == "no drops":
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    return dataclasses.replace(cfg, **kw)


def new_config_phase(sub: str, dev, *, directory: Path = WORKDIR,
                     traffic: dict = PHASE9_TRAFFIC, smoke: bool = False,
                     log=print) -> dict:
    """One PHASE9 sub-phase: ``run_serving`` with ``traffic``'s batch,
    prompt and cache and the entry's steps and session, then the float32
    gate (for a MoE config with the compared token's routing beside it).
    The comparators must not launch; on a card the attention kernel must
    launch once per layer in each prefill (``run_serving`` and the gate
    check it).  ``smoke`` and a small ``traffic`` (with ``steps`` and
    ``gate_prompt``) run it on the CPU."""
    from repro_torch.kernels import flash_attention, rg_lru, ssd_scan
    comparators = (flash_attention, ssd_scan, rg_lru)
    for mod in comparators:
        mod.launches = 0
    spec = PHASE9[sub]
    t0 = time.perf_counter()
    dev = torch.device(dev)
    cfg = phase9_config(sub, smoke)
    params = model_params(cfg, 0, dev)
    nparams = sum(t.numel() for t in params.values())
    from repro_torch.configs import get_config
    cut = "" if spec["n_layers"] is None or smoke else (
        f", reduced: n_layers {get_config(cfg.name).n_layers}->"
        f"{cfg.n_layers} ({spec['why']})")
    steps = traffic.get("steps", spec["steps"])
    log(f"phase {sub}: serving {cfg.name}, {cfg.n_layers} layers{cut}, "
        f"{nparams} parameters made on {dev} in {cfg.param_dtype}; "
        f"{steps} steps, session {spec['session']}, {traffic}")
    on_card = dev.type == "cuda"

    def tokens(length):
        return np.random.default_rng(0).integers(
            0, cfg.vocab, size=(traffic["batch"], length + 1)).astype(
                np.int32)

    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        out = run_serving(
            cfg, params, tokens(traffic["prompt"]), device=dev,
            directory=directory, max_len=traffic["max_len"], steps=steps,
            save_at=traffic["save_at"] if spec["session"] else None,
            factor=traffic["factor"],
            consistency_limit=spec["consistency_limit"])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if on_card:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["nparams"] = nparams
    del params
    if on_card:
        torch.cuda.empty_cache()
    gate = spec["f32"]
    if gate is not None:
        gcfg = phase9_gate_config(cfg, gate)
        f32_kernels = prefill_kernels(gcfg)
        for mod in f32_kernels:
            mod.launches = 0
        n_moe = sum(reps * pattern.count("moe")
                    for reps, pattern in gcfg.groups())
        gate_prompt = traffic.get("gate_prompt", gate["prompt"])
        with RouteLog() as routes:
            out["float32_rel_err"] = float32_consistency(
                gcfg, model_params(gcfg, 0, dev), tokens(gate_prompt),
                device=dev)
        if n_moe:
            out["float32_routing"] = route_flips(n_moe, routes.calls)
        out["float32_launches"] = {_kernel_name(mod): mod.launches
                                   for mod in f32_kernels}
        for mod, want in f32_kernels.items():
            check(not on_card or mod.launches == 2 * want,
                  f"{cfg.name} float32 gate: {_kernel_name(mod)} launched "
                  f"{mod.launches} times, not {2 * want}")
        check(out["float32_rel_err"] < F32_LIMIT,
              f"{cfg.name}, {gcfg.n_layers} layers in float32: decode after "
              f"prefill({gate_prompt}) vs prefill({gate_prompt + 1}): "
              f"relative error {out['float32_rel_err']}")
        if on_card:
            torch.cuda.empty_cache()
    out["comparator_launches"] = {_kernel_name(mod): mod.launches
                                  for mod in comparators}
    check(not any(out["comparator_launches"].values()),
          f"{cfg.name}: a comparator on no path launched: "
          f"{out['comparator_launches']}")
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 6: training with window checkpoints --------------------------------

def host_tree(tree: dict) -> dict[str, np.ndarray]:
    """The phase's own host copy of a checkpoint tree: each tensor's bytes
    (bf16 through an int16 view)."""
    out = {}
    for k, t in tree.items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[k] = t.to("cpu", copy=True).numpy().reshape(-1).view(np.uint8)
    return out


def window_equal(path: Path, slots: dict, host: dict) -> bool:
    """The window file at each slot holds the host copy's bytes."""
    for k, raw in host.items():
        disk = np.fromfile(path, dtype=np.uint8, count=raw.nbytes,
                           offset=slots[k].offset)
        if not np.array_equal(disk, raw):
            return False
    return True


class PeakRss:
    """The largest resident set (``VmRSS``) of this process, or of process
    ``pid``, seen while the context is open, sampled every ``interval``
    seconds by a thread.  ``start`` is the resident set on entry;
    :meth:`mark` closes an interval: ``marks`` keeps, for each, its label,
    its peak and the resident set at its end."""

    def __init__(self, interval: float = 0.05, pid: int | str = "self"):
        import threading
        self.status = Path(f"/proc/{pid}/status")
        self.interval = interval
        self.peak = 0
        self.marks: list[dict] = []
        self._since = 0  # the peak since the last mark
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def rss(self) -> int:
        for line in self.status.read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        raise RuntimeError(f"no VmRSS in {self.status}")

    def _run(self) -> None:
        while not self._stop.is_set():
            now = self.rss()
            self.peak = max(self.peak, now)
            self._since = max(self._since, now)
            self._stop.wait(self.interval)

    def mark(self, label: str) -> None:
        now = self.rss()
        self.marks.append({"label": label, "peak": max(self._since, now),
                           "end": now})
        self._since = now

    def __enter__(self):
        self.start = self._since = self.rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())


class SaveChecks:
    """Checks each checkpoint save of a Trainer as it completes.

    :meth:`hook` gives one ``Trainer.run`` its ``on_save``: before a save
    it joins the previous one (as ``save_async`` itself does first),
    checks that save, and keeps the phase's own host copy of the new
    tree.  A save is checked against that copy: the window file read back
    must hold its bytes, and the bytes flushed must equal the pages that
    differ from what the manager last saved to that window, times the
    page size.  In this schedule each save is its manager's first to its
    window, so every page of the tree differs (and the check says so if
    that changes)."""

    def __init__(self, directory: Path, mark=lambda label: None):
        self.directory = directory
        self.mark = mark  # called before each save, with a label
        self.pending = None
        self.records: list[dict] = []

    def hook(self, trainer, run: str):
        """``on_save`` for ``trainer.run`` (a run makes a fresh manager)."""
        targets: set[str] = set()  # the windows this run's manager saved to

        def on_save(step, tree):
            trainer.ckpt.wait()
            self.verify()
            self.mark(f"{run} to the save at step {step}")
            self.pending = (trainer.ckpt, targets, step, host_tree(tree))

        return on_save

    def verify(self) -> None:
        """Check the last save; its flush must have completed."""
        if self.pending is None:
            return
        manager, targets, step, host = self.pending
        self.pending = None
        rec = manager.records[-1]
        check(rec["step"] == step, f"save at step {step} not committed: "
              f"{manager.records}")
        check(rec["target"] not in targets,
              f"step {step}: a second save to window {rec['target']} by one "
              "manager; count the pages that differ from its last save")
        targets.add(rec["target"])
        pages = sum(-(-a.nbytes // PAGE) for a in host.values())
        check(rec["bytes"] == pages * PAGE,
              f"step {step}: flushed {rec['bytes']} bytes, the tree's "
              f"changed pages give {pages * PAGE}")
        path = self.directory / f"ckpt_{rec['target']}.bin"
        check(window_equal(path, manager.windows[rec["target"]].slots, host),
              f"step {step}: {path.name} differs from the tree saved")
        self.records.append(rec)


def run_training(cfg, *, device, directory: Path, seq: int,
                 batch: int = TRAIN["batch"],
                 phase: str = "6", log=print,
                 mark=lambda label: None) -> dict:
    """Phase 6, 6b or 6c (``phase``, the entry of TRAIN_PHASES that sets
    the runs): the ``Trainer`` on ``cfg`` (random parameters from seed 0
    with the published dynamics, :func:`model_params`, made on
    ``device``) under deterministic algorithms, with the phase's steps and
    microbatches (its TRAIN_PHASES entry).  Run A trains the steps as fused
    steps, its losses finite and step 0's near a
    random model's (ln V + 1/2, or for a tied, scaled or soft-capped head
    the float32 loss); run B the same with asynchronous window
    checkpoints every TRAIN["ckpt_every"] steps, stopped after
    TRAIN["kill_after"]; a fresh manager restores the newest checkpoint;
    run C, a fresh Trainer on the same directory, restores and continues.
    C's final params, moments and step, and its losses, must equal A's
    bit for bit.  Then, where the phase has it, TRAIN["offload_steps"]
    offload-mode steps.  ``mark`` is called with a label at the end of
    each stretch of the phase (the host memory is read there).  Returns
    the measurements."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import make_loss_fn, param_specs
    from repro_torch.train import (AdamWConfig, TrainConfig, Trainer,
                                   adamw_update)

    spec = TRAIN_PHASES[phase]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    opt = AdamWConfig(**TRAIN_OPT)
    steps, microbatches = spec["steps"], spec["microbatches"]
    every, kill = TRAIN["ckpt_every"], TRAIN["kill_after"]
    ds = SyntheticLM(cfg, batch=batch, seq=seq, microbatches=microbatches)
    nparams = sum(int(np.prod(s.shape)) for s in param_specs(cfg).values())
    out = {"nparams": nparams, "tokens_per_step": batch * microbatches * seq}

    class Stream:
        def __init__(self, start=0):
            self.step = start

        def __next__(self):
            self.step += 1
            return ds.batch_at(self.step - 1)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def tcfg(**kw):
        return TrainConfig(steps=steps, microbatches=microbatches,
                           log_every=0, **kw)

    torch.use_deterministic_algorithms(True)
    try:
        # run A: uninterrupted, no checkpoint; step times synchronised
        marks = []

        def timed(step, rec):
            sync()
            marks.append(time.perf_counter())

        if cuda:
            torch.cuda.synchronize(dev)  # CUDA starts before the reset
            torch.cuda.reset_peak_memory_stats(dev)
        params0 = model_params(cfg, 0, dev)
        trA = Trainer(cfg, opt, tcfg(), device=dev)
        pA, oA = trA.run(Stream(), params0, on_step=timed)
        lossA = [m["loss"] for m in trA.metrics_log]
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        out["losses"] = lossA
        out["step_ms"] = step_ms
        out["step_ms_median"] = float(np.median(step_ms))
        out["tokens_per_s"] = (out["tokens_per_step"]
                               / (out["step_ms_median"] / 1e3))
        if cuda:
            out["peak_device_bytes_run_a"] = torch.cuda.max_memory_allocated(
                dev)
            probe = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.batch_at(steps).items()}
            out["step_profile"] = device_profile(lambda: adamw_update(
                pA, trA.loss_and_grads(pA, probe)[1], oA, opt))
        check(all(math.isfinite(x) for x in lossA), f"losses {lossA}")
        if not (cfg.tie_embeddings or cfg.scale_embeddings
                or cfg.logit_softcap):
            want0 = math.log(cfg.vocab) + 0.5
            check(abs(lossA[0] - want0) <= TRAIN_LOSS0_TOL,
                  f"step 0 loss {lossA[0]}, a random model's is about {want0}")
        else:  # step 0's loss in float32: the same params, the same batch
            loss_f32 = make_loss_fn(dataclasses.replace(cfg, dtype="float32"))
            first = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.batch_at(0).items()}
            with torch.no_grad():
                want0 = float(sum(loss_f32(params0, {k: v[i] for k, v in
                                                     first.items()})[0]
                                  for i in range(microbatches))
                              / microbatches)
            out["loss0_float32"] = want0
            out["loss0_rel_err"] = abs(lossA[0] - want0) / abs(want0)
            check(out["loss0_rel_err"] <= TRAIN_F32_TOL,
                  f"step 0 loss {lossA[0]} in {cfg.dtype}, {want0} in "
                  f"float32: {out['loss0_rel_err']} relative")
            del first
        mark("run A")

        if "B" in spec["runs"]:
            # run B: the same, checkpointing, "killed" after KILL_AFTER steps
            saves = SaveChecks(directory, mark)
            tcB = tcfg(ckpt_dir=str(directory), ckpt_every=every,
                       ckpt_async=True)
            tr = Trainer(cfg, opt, tcB, device=dev)
            tr.run(Stream(), params0, stop_after=kill,
                   on_save=saves.hook(tr, "run B"))
            saves.verify()
            check([m["loss"] for m in tr.metrics_log] == lossA[:kill],
                  "run B's losses differ from run A's")
            tr.close()
            mark("run B's last save, checked; run B closed")

            # run C: a fresh Trainer on the same directory restores the
            # newest manifest (its step and CRCs validate) and continues
            tr = Trainer(cfg, opt, tcB, device=dev)

            def restored_mark(step, rec):
                if step == kill:
                    mark("run C's restore and first step")

            pC, oC = tr.run(Stream(kill), params0, on_step=restored_mark,
                            on_save=saves.hook(tr, "run C"))
            saves.verify()
            restored = tr.ckpt.restore_records
            check(tr.restored_step == kill and len(restored) == 1
                  and not restored[0]["fell_back"],
                  f"run C restored {restored}, not step {kill}")
            out["restore_ms"] = restored[0]["ms"]
            lossC = [m["loss"] for m in tr.metrics_log]
            check(lossC == lossA[kill:],
                  f"run C's losses {lossC} differ from run A's {lossA[kill:]}")
            same = {k: torch.equal(pC[k], pA[k])
                    and torch.equal(oC["m"][k], oA["m"][k])
                    and torch.equal(oC["v"][k], oA["v"][k]) for k in pA}
            check(all(same.values()),
                  "run C's params or moments differ from run A's: "
                  f"{sorted(k for k, v in same.items() if not v)}")
            check(torch.equal(oC["step"], oA["step"]), "run C's step differs")
            tr.close()
            mark("run C's last save, checked; run C closed")
            out["saves"] = saves.records
            del pC, oC, tr
        if cuda:
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        del pA, oA, trA, params0

        if spec["offload"]:
            # offload mode: bf16 params on the device, OutOfCoreAdamW
            # walking its window on the host, synced at the last step
            n_off = TRAIN["offload_steps"]
            oo_dir = directory / "offload"
            tr = Trainer(cfg, opt, TrainConfig(
                steps=n_off, microbatches=microbatches, log_every=0,
                mode="offload", ckpt_dir=str(oo_dir), ckpt_every=n_off),
                device=dev)
            t0 = time.perf_counter()
            pO, _ = tr.run(Stream(), model_params(cfg, 0, dev))
            out["offload_s"] = time.perf_counter() - t0
            out["offload_losses"] = [m["loss"] for m in tr.metrics_log]
            check(all(math.isfinite(x) for x in out["offload_losses"]),
                  f"offload losses {out['offload_losses']}")
            path = oo_dir / "optstate.bin"
            check(path.exists(), f"{path} missing")
            masters = tr.offload_opt.masters()
            slots = tr.offload_opt.state.slots
            check(window_equal(path, {k: slots[f"master/{k}"]
                                      for k in masters},
                               {k: v.reshape(-1).view(np.uint8)
                                for k, v in masters.items()}),
                  "offload: the window file differs from the masters")
            check(all(torch.equal(torch.from_numpy(masters[k]).to(
                dev, torch.bfloat16), v) for k, v in pO.items()),
                  "offload: the params are not the masters in bf16")
            tr.close()
            mark("offload")
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def train_config(phase: str):
    """The config of a TRAIN_PHASES entry: full widths, depth cut."""
    from repro_torch.configs import get_config
    spec = TRAIN_PHASES[phase]
    return dataclasses.replace(get_config(spec["arch"]),
                               n_layers=spec["n_layers"])


def training_phase(dev, phase: str = "6", log=print) -> dict:
    """Phase 6, 6b or 6c (TRAIN_PHASES) at its config's full widths (depth
    cut, its own remat) on the train_4k shape cut to one card; no kernel of
    the package may launch (the training path runs none)."""
    from repro_torch.configs import SHAPES, get_config
    mods = [importlib.import_module(f"repro_torch.kernels.{name}")
            for name in BUILD]
    for mod in mods:
        mod.launches = 0
    spec = TRAIN_PHASES[phase]
    cfg = train_config(phase)
    shape = SHAPES[TRAIN["shape"]]
    steps, microbatches = spec["steps"], spec["microbatches"]
    gbatch = TRAIN["batch"] * microbatches
    log(f"phase {phase}, {cfg.name}, reduced: n_layers "
        f"{get_config(cfg.name).n_layers}->{cfg.n_layers} ({spec['why']}); "
        f"{shape.name} global batch {shape.batch}->{gbatch} (one card: "
        f"{TRAIN['batch']} sequences x {microbatches} microbatches), "
        f"seq {shape.seq}; steps {steps}, runs {spec['runs']}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    try:
        with PeakRss() as rss:
            out = run_training(cfg, device=dev, directory=TRAIN_DIR,
                               seq=shape.seq, phase=phase, log=log,
                               mark=rss.mark)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out["peak_host_rss_bytes"] = rss.peak  # sampled every 50 ms
    out["host_rss_at_start_bytes"] = rss.start
    out["host_rss_stretches"] = rss.marks
    out["kernel_launches"] = {name: mod.launches
                              for name, mod in zip(BUILD, mods)}
    check(not any(out["kernel_launches"].values()),
          f"phase {phase}'s training path launched a kernel: "
          f"{out['kernel_launches']}")
    return out


# -- phase 7: the MPI layer across processes ----------------------------------

MP_DIR = WORKDIR / "mp"
# 7c: benchmarks/dht_bench.py's traffic and table (random keys from seed 0,
# op "sum", 80% of 4 x 4,096 slots: 13,107 inserts), cut from a table four
# times larger for the time limit (its mp inserts, a round trip each, took
# 60-112 s there); 7d: benchmarks/mapreduce_bench.py's 24 tasks of 20,000
# words over its 20-word vocabulary
MP_DHT = dict(ranks=4, lv_entries=1 << 12, fill=0.8)
# host memory phase 7 may take, checked for this process's growth over
# its start of the phase and for the peak of 7a's window owner: a quarter
# of a 96 GiB host each, four times the 6.06 GB window.  A codec that
# built its run arrays over a 758 MB incompressible sync took 39 GB here
MP_HOST_LIMIT = 24_000_000_000
MP_MR = dict(ranks=4, lv_entries=1 << 12, tasks=24, words=20000,
             vocab=("alpha beta gamma delta epsilon zeta eta theta iota "
                    "kappa lambda mu nu xi omicron pi rho sigma tau "
                    "upsilon").split())


def shard_groups(shapes: dict, n: int = 3) -> list[list[str]]:
    """The masters split by tensor, in ``param_specs`` order, into ``n``
    groups of about equal bytes: a tensor goes to the group whose share of
    the running total holds its midpoint."""
    names = sorted(shapes)
    nbytes = {k: int(np.prod(shapes[k])) * 4 for k in names}
    total = sum(nbytes.values())
    groups, cum = [[] for _ in range(n)], 0
    for k in names:
        groups[min(n - 1, (2 * cum + nbytes[k]) * n // (2 * total))].append(k)
        cum += nbytes[k]
    check(all(groups), f"an empty shard group: {groups}")
    return groups


def shard_layout(group: list[str], shapes: dict) -> dict:
    """Page-aligned byte offsets of a group's tensors in its rank's window,
    as ``changed_pages`` reads them (``slots["master/<k>"].offset``)."""
    slots, off = {}, 0
    for k in group:
        slots[f"master/{k}"] = SimpleNamespace(offset=off)
        off += -(-int(np.prod(shapes[k])) * 4 // PAGE) * PAGE
    return {"slots": slots, "bytes": off}


def run_shards(cfg, comm, *, device, directory: Path, seed: int = 0,
               log=print) -> dict:
    """Phase 7b over ``comm`` (4 ranks): ranks 1-3 each own a storage
    window holding one group of the masters; each group's first phase-2
    change goes to its rank with ``sync_shards_from_device``.  Checks
    every rank's flushed bytes against its changed pages (and one
    ``wsync`` per rank under mp)."""
    from repro_torch.core import Window
    from repro_torch.kernels import dirty_diff, pack_diff
    from repro_torch.models import param_specs
    kind = comm.transport.kind
    shapes = {k: s.shape for k, s in param_specs(cfg).items()}
    groups = shard_groups(shapes)
    layouts = [shard_layout(g, shapes) for g in groups]
    size = max(lay["bytes"] for lay in layouts)
    change = mutation_plan(shapes, seed)[0]
    masters = make_masters(cfg, seed, device)
    snapshot = {k: v.clone() for k, v in masters.items()}
    channel = ChannelCount(comm.transport) if kind == "mp" else None
    win = Window.allocate(comm, size, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(directory / "shards.bin")})
    out = {"window_bytes": size, "ranks": []}
    try:
        t0 = time.perf_counter()
        for r, (g, lay) in enumerate(zip(groups, layouts), start=1):
            for k in g:
                host = snapshot[k].detach().to("cpu").numpy().reshape(-1)
                win.put(host, r, lay["slots"][f"master/{k}"].offset)
            win.sync(r)
        out["baseline_s"] = time.perf_counter() - t0
        apply_mutation(masters, change)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wire0 = comm.transport.wire_stats_snapshot()
        for r, (g, lay) in enumerate(zip(groups, layouts), start=1):
            sub = {k: change[k] for k in g}
            want = changed_pages(lay["slots"], shapes, sub) * PAGE
            if channel is not None:
                channel.clear()
            dirty_diff.launches = 0
            pack_diff.launches = 0
            t0 = time.perf_counter()
            flushed = win.sync_shards_from_device(r, [
                (masters[k], snapshot[k], lay["slots"][f"master/{k}"].offset)
                for k in g], blocking=True)
            rec = {"rank": r, "tensors": len(g),
                   "group_bytes": sum(int(np.prod(shapes[k])) * 4
                                      for k in g),
                   "flushed_bytes": flushed, "expected_bytes": want,
                   "sync_ms": (time.perf_counter() - t0) * 1e3,
                   "dirty_diff_launches": dirty_diff.launches,
                   "diff_pack_launches": pack_diff.launches}
            check(flushed == want,
                  f"7b {kind} rank {r}: flushed {flushed}, changed pages "
                  f"give {want}")
            if device.type == "cuda":
                check(rec["dirty_diff_launches"] > 0
                      and rec["diff_pack_launches"] > 0,
                      f"7b {kind} rank {r}: kernels not launched: {rec}")
            if channel is not None:
                check(channel.ops == [(r, "wsync")],
                      f"7b rank {r}: control messages {channel.ops}")
            out["ranks"].append(rec)
        wire1 = comm.transport.wire_stats_snapshot()
        out["wire"] = {k: wire1[k] - wire0[k] for k in wire1}
    finally:
        if channel is not None:
            channel.close()
        win.free()
    log(f"7b {kind}: " + json.dumps(out))
    return out


def dht_run(comm, directory: Path, spec: dict = MP_DHT) -> dict:
    """Phase 7c over ``comm``: fill 80% of a storage-window DHT with random
    keys, check ``items()`` against a dict of the same keys, sync."""
    from collections import Counter

    from repro_torch.core import DistributedHashTable
    n = int(comm.size * spec["lv_entries"] * spec["fill"])
    keys = np.random.default_rng(0).integers(1, 1 << 40, n)
    dht = DistributedHashTable(comm, spec["lv_entries"], info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(directory / "dht.bin")})
    try:
        t0 = time.perf_counter()
        for k in keys:
            dht.insert(int(k), 1, op="sum")
        dt = time.perf_counter() - t0
        items = dht.items()
        check(dict(items) == dict(Counter(int(k) for k in keys)),
              f"7c {comm.transport.kind}: items() differs from a dict of "
              "the same keys")
        t0 = time.perf_counter()
        flushed = dht.sync()
        sync_s = time.perf_counter() - t0
        heap = [dht.heap_used(r) for r in range(comm.size)]
    finally:
        dht.free()
    return {"inserts": n, "insert_s": dt, "inserts_per_s": n / dt,
            "conflicts": dht.insert_conflicts, "heap_used": heap,
            "sync_s": sync_s, "flushed_bytes": flushed, "items": items}


def mapreduce_run(comm, directory: Path, spec: dict = MP_MR) -> dict:
    """Phase 7d over ``comm``: MapReduce1S with a checkpoint per task over
    the benchmark's tasks; the result must equal ``wordcount_reduce``."""
    from repro_torch.core import MapReduce1S
    from repro_torch.core.mapreduce import wordcount_map, wordcount_reduce
    rng = np.random.default_rng(0)
    tasks = [" ".join(rng.choice(spec["vocab"], spec["words"]))
             for _ in range(spec["tasks"])]
    mr = MapReduce1S(comm, spec["lv_entries"], info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(directory / "mr.bin")})
    try:
        t0 = time.perf_counter()
        mr.run(tasks)
        dt = time.perf_counter() - t0
        result = mr.result()
        check(result == wordcount_reduce(wordcount_map(t) for t in tasks),
              f"7d {comm.transport.kind}: result differs from "
              "wordcount_reduce")
        check(mr.completed_tasks() == len(tasks) == mr.ckpt_count,
              f"7d: {mr.completed_tasks()} tasks done, "
              f"{mr.ckpt_count} checkpoints")
    finally:
        mr.free()
    return {"tasks": len(tasks), "seconds": dt, "ckpt_bytes": mr.ckpt_bytes,
            "words": len(result)}


def same_files(a: Path, b: Path) -> list[str]:
    """The names of the files in ``a``; raises unless ``b`` holds the same
    names with byte-identical contents."""
    import filecmp
    names = sorted(p.name for p in a.iterdir())
    check(names == sorted(p.name for p in b.iterdir()) and names,
          f"file sets differ: {a} {b}")
    for n in names:
        check(filecmp.cmp(a / n, b / n, shallow=False),
              f"{a / n} and {b / n} differ")
    return names


def _over_worlds(cfg, dev, worlds: dict, directory: Path, dht: dict,
                 mr: dict, log) -> dict:
    """Phases 7b-7d in each of ``worlds`` (``inproc``, ``mp``): the same
    flushed bytes, items and results, and byte-identical files."""
    out = {}
    runs = {}
    for kind, comm in worlds.items():
        d = directory / f"shards_{kind}"
        d.mkdir(parents=True)
        runs[kind] = run_shards(cfg, comm, device=dev, directory=d, log=log)
    files = same_files(directory / "shards_inproc", directory / "shards_mp")
    check([r["flushed_bytes"] for r in runs["mp"]["ranks"]]
          == [r["flushed_bytes"] for r in runs["inproc"]["ranks"]],
          "7b: flushed bytes differ between inproc and mp")
    out["7b"] = {"files_identical": files, **runs}
    out["7b"]["launches"] = {
        name: sum(rec[f"{name}_launches"] for r in runs.values()
                  for rec in r["ranks"])
        for name in ("dirty_diff", "diff_pack")}
    shutil.rmtree(directory)
    runs = {}
    for kind, comm in worlds.items():
        d = directory / f"dht_{kind}"
        d.mkdir(parents=True)
        runs[kind] = dht_run(comm, d, dht)
    check(runs["mp"].pop("items") == runs["inproc"].pop("items"),
          "7c: items() differ between inproc and mp")
    out["7c"] = {"files_identical": same_files(directory / "dht_inproc",
                                               directory / "dht_mp"),
                 **runs}
    runs = {}
    for kind, comm in worlds.items():
        d = directory / f"mr_{kind}"
        d.mkdir(parents=True)
        runs[kind] = mapreduce_run(comm, d, mr)
    out["7d"] = {"files_identical": same_files(directory / "mr_inproc",
                                               directory / "mr_mp"),
                 **runs}
    return out


def mp_phase(cfg, dev, phase2: dict, directory: Path, *,
             dht: dict = MP_DHT, mr: dict = MP_MR, log=print,
             mark=lambda label: None) -> dict:
    """Phase 7: the MPI layer across processes, with the card as origin.

    7a runs phase 2's main path with the storage window owned by a spawned
    worker (``Communicator(1, transport="mp")``); 7b sends each of three
    groups of the masters to the rank (1-3) that owns it under mp and
    under inproc, whose files must be byte-identical; 7c and 7d run the
    paper's DHT and MapReduce under inproc and mp, with the same items,
    results and files.  ``phase2`` is phase 2's result (its per-sync
    times are printed beside 7a's); everything is written under
    ``directory``, which is removed at the end.  ``mark(label)`` runs at
    the end of 7a and of 7b-7d (``PeakRss.mark``)."""
    from repro_torch.core import Communicator
    out = {}
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    try:
        a = run_main_path(cfg, device=dev, directory=directory,
                          transport="mp",
                          log=lambda m: log("7a " + m))
        check(torch.device(dev).type != "cuda"
              or all(v > 0 for v in a["launches"].values()),
              f"7a: a kernel of the main path never launched: "
              f"{a['launches']}")
        check(max(a["owner_peak_rss_bytes"]) <= MP_HOST_LIMIT,
              f"7a: the window's owner peaked at "
              f"{a['owner_peak_rss_bytes']} B, over {MP_HOST_LIMIT}")
        out["7a"] = {"world_s": a["world_s"], "launches": a["launches"],
                     "owner_peak_rss_bytes": a["owner_peak_rss_bytes"],
                     "syncs": [{
                         "sync": r["sync"], "flushed_bytes":
                         r["flushed_bytes"], "mp_sync_ms": r["sync_ms"],
                         "mp_flush_ms": r["flush_ms"],
                         "inproc_sync_ms": p["sync_ms"],
                         "inproc_flush_ms": p["flush_ms"],
                         "spans_logical_bytes": r["spans_logical_bytes"],
                         "spans_wire_bytes": r["spans_wire_bytes"],
                         "codec_policy": r["codec_policy"],
                         "messages": r["messages"]}
                         for r, p in zip(a["records"], phase2["records"])]}
        mark("7a")
        shutil.rmtree(directory)  # free the 6 GB window file before 7b
        # 7b-7d: one 4-rank world per transport; the mp world's workers
        # start once (each also imports this script's modules)
        t0 = time.perf_counter()
        worlds = {"inproc": Communicator(4),
                  "mp": Communicator(4, transport="mp")}
        mp_world_s = time.perf_counter() - t0
        try:
            out.update(_over_worlds(cfg, dev, worlds, directory, dht, mr,
                                    log))
        finally:
            for comm in worlds.values():
                comm.close()
        out["7b"]["mp_world_s"] = mp_world_s
        mark("7b-7d")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return out


# -- phase 8: fault tolerance, with the card as the origin --------------------

REP_DIR = WORKDIR / "rep"
# 8a: the rank whose worker dies; its partition fails over to rank 3
REP_VICTIM = 2
# 8b: examples/replicated_failover.py's path at 4 x 16,384 slots (on 8a's
# 4-rank mp world) with benchmarks/dht_bench.py's keys (seed 0); 1,024
# inserts a rank, cut from 4,096 for the run's time limit
REP_DHT = dict(lv_entries=1 << 14, keys=4 * 1024, more=1000)


def replicas_equal(directory: Path, name: str, nranks: int) -> None:
    """Raises unless every ``<name>.rep1.<r>`` equals ``<name>.<r>``."""
    import filecmp
    for r in range(nranks):
        prim, rep = directory / f"{name}.{r}", directory / f"{name}.rep1.{r}"
        check(filecmp.cmp(prim, rep, shallow=False),
              f"{rep.name} differs from {prim.name}")


def _op_counts(ops: list) -> dict:
    """Control messages by ``rank:op``, from a :class:`ChannelCount`."""
    from collections import Counter
    return dict(sorted(Counter(f"{r}:{op}" for r, op in ops).items()))


def rep_shards(cfg, comm, *, device, directory: Path, seed: int = 0,
               log=print, on_step=None) -> dict:
    """Phase 8a over ``comm`` (4 ranks): phase 7b's groups in a storage
    window with ``storage_alloc_replication=2`` (rank r's copy on rank
    r + 1, rank 3's on rank 0), then

    1. the baseline put and sync: every replica file equals its primary;
    2. phase 2's change 1 from the device (``sync_shards_from_device``):
       exact flushed bytes, replicas equal again;
    3. rank 2 dies (``kill_rank`` under mp, nothing marked; ``mark_dead``
       in process), and phase 2's changes 1 and 2 together go to rank 2
       first (a non-blocking sync: its failover runs in a pool task), then
       ranks 1 and 3: under mp rank 2's op finds the death itself; flushed
       bytes exact; rank 1's mirror to rank 2 skipped, its spans pending;
       every tensor read back through the window equals the masters;
    4. ``comm.rebuild_rank(2)``: the rank probes alive, and the bytes it
       copies are the delta: the pages ranks 1 and 2 changed in step 3;
    5. a clean sync (no change) replays the pending mirrors: every
       primary file equals its replica.

    ``on_step(name, rank, value)``, if given, sees each operation with its
    host data and result (a test replays them on the JAX package)."""
    from repro_torch.core import Window
    from repro_torch.kernels import dirty_diff, pack_diff
    from repro_torch.models import param_specs
    kind = comm.transport.kind
    shapes = {k: s.shape for k, s in param_specs(cfg).items()}
    groups = shard_groups(shapes)
    layouts = [shard_layout(g, shapes) for g in groups]
    size = max(lay["bytes"] for lay in layouts)
    plan = mutation_plan(shapes, seed)
    changes = [plan[0], {**plan[0], **plan[1]}, {}]
    masters = make_masters(cfg, seed, device)
    snapshot = {k: v.clone() for k, v in masters.items()}
    channel = ChannelCount(comm.transport) if kind == "mp" else None
    win = Window.allocate(comm, size, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(directory / "shards.bin"),
        "storage_alloc_replication": "2"})
    out = {"window_bytes": size, "replication": win.replication,
           "steps": []}
    launches = {"dirty_diff": 0, "diff_pack": 0}

    def host(k):
        return snapshot[k].detach().to("cpu").numpy().reshape(-1)

    def device_syncs(label, change, order, blocking=True):
        """Each rank's share of ``change``, synced from the device."""
        apply_mutation(masters, change)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wire0 = comm.transport.wire_stats_snapshot()
        recs = []
        for r in order:
            g, lay = groups[r - 1], layouts[r - 1]
            sub = {k: change[k] for k in g if k in change}
            want = changed_pages(lay["slots"], shapes, sub) * PAGE
            shards = [(masters[k], snapshot[k],
                       lay["slots"][f"master/{k}"].offset) for k in g]
            if channel is not None:
                channel.clear()
            dead_before = r in comm.dead_ranks
            dirty_diff.launches = 0
            pack_diff.launches = 0
            t0 = time.perf_counter()
            got = win.sync_shards_from_device(r, shards, blocking=blocking)
            flushed = got if blocking else got.wait()
            rec = {"rank": r, "flushed_bytes": flushed,
                   "expected_bytes": want,
                   "sync_ms": (time.perf_counter() - t0) * 1e3,
                   "dead_before": dead_before,
                   "dead_after": r in comm.dead_ranks,
                   "mirror_pending_pages": win._mirror_pending[r].dirty_count,
                   "dirty_diff_launches": dirty_diff.launches,
                   "diff_pack_launches": pack_diff.launches}
            launches["dirty_diff"] += dirty_diff.launches
            launches["diff_pack"] += pack_diff.launches
            if channel is not None:
                rec["messages"] = _op_counts(channel.ops)
            check(flushed == want,
                  f"8a {kind} {label} rank {r}: flushed {flushed}, changed "
                  f"pages give {want}")
            if device.type == "cuda":
                check(rec["dirty_diff_launches"] > 0
                      and rec["diff_pack_launches"] > 0,
                      f"8a {kind} {label} rank {r}: kernels not launched: "
                      f"{rec}")
            if on_step is not None:
                on_step("device_sync", r, (
                    [(c.cpu().numpy(), s.cpu().numpy(), off)
                     for c, s, off in shards], flushed))
            recs.append(rec)
        for k in change:
            snapshot[k].copy_(masters[k])
        wire1 = comm.transport.wire_stats_snapshot()
        out["steps"].append({"step": label, "ranks": recs,
                             "wire": {k: wire1[k] - wire0[k] for k in wire1}})
        return {rec["rank"]: rec for rec in recs}

    try:
        t0 = time.perf_counter()
        for r, (g, lay) in enumerate(zip(groups, layouts), start=1):
            for k in g:
                off = lay["slots"][f"master/{k}"].offset
                win.put(host(k), r, off)
                if on_step is not None:
                    on_step("put", r, (off, host(k)))
            flushed = win.sync(r)
            if on_step is not None:
                on_step("sync", r, flushed)
        out["baseline_s"] = time.perf_counter() - t0
        replicas_equal(directory, "shards.bin", comm.size)

        device_syncs("change 1", changes[0], (1, 2, 3))
        replicas_equal(directory, "shards.bin", comm.size)

        # step 3: the victim's worker dies; nothing is marked under mp
        if kind == "mp":
            comm.transport.kill_rank(REP_VICTIM)
        else:
            comm.mark_dead(REP_VICTIM)
        if on_step is not None:
            on_step("kill", REP_VICTIM, None)
        recs = device_syncs("changes 1 and 2, rank 2 dead", changes[1],
                            (REP_VICTIM, 1, 3), blocking=False)
        v = recs[REP_VICTIM]
        check(v["dead_after"] and v["dead_before"] == (kind != "mp"),
              f"8a {kind}: rank {REP_VICTIM}'s death was not found by its "
              f"own sync: {v}")
        check(recs[1]["mirror_pending_pages"] > 0,
              f"8a {kind}: rank 1's mirror to the dead rank 2 left nothing "
              f"pending: {recs[1]}")
        t0 = time.perf_counter()
        for r, (g, lay) in enumerate(zip(groups, layouts), start=1):
            for k in g:
                t = masters[k]
                got = win.get(r, lay["slots"][f"master/{k}"].offset,
                              t.numel(), np.float32)
                check(np.array_equal(
                    got.view(np.uint32),
                    t.detach().cpu().numpy().reshape(-1).view(np.uint32)),
                    f"8a {kind}: {k} read back from rank {r} differs from "
                    "the masters")
        out["read_back_s"] = time.perf_counter() - t0

        # step 4: respawn (mp) and rebuild; only the delta is copied
        respawn = None
        if kind == "mp":
            respawn = _Timed(comm.transport.respawn_rank)
            comm.transport.respawn_rank = respawn
        t0 = time.perf_counter()
        try:
            copied = comm.rebuild_rank(REP_VICTIM)
        finally:
            if respawn is not None:
                del comm.transport.respawn_rank
        out["rebuild_s"] = time.perf_counter() - t0
        out["respawn_s"] = respawn.seconds if respawn is not None else None
        out["rebuild_bytes"] = copied
        if on_step is not None:
            on_step("rebuild", REP_VICTIM, copied)
        want = sum(recs[r]["flushed_bytes"] for r in (1, REP_VICTIM))
        check(comm.probe(REP_VICTIM),
              f"8a {kind}: rank {REP_VICTIM} did not come back")
        check(copied == want,
              f"8a {kind}: the rebuild copied {copied} B, not the delta "
              f"{want} B (what ranks 1 and {REP_VICTIM} changed while it "
              "was dead)")

        device_syncs("clean", changes[2], (1, 2, 3))
        replicas_equal(directory, "shards.bin", comm.size)
    finally:
        if channel is not None:
            channel.close()
        win.free()
    out["launches"] = launches
    log(f"8a {kind}: " + json.dumps(out))
    return out


def ckpt_survives(cfg, comm, *, device, directory: Path, seed: int = 0,
                  log=print) -> dict:
    """Phase 8c over ``comm`` (2 ranks, mp): ``CheckpointManager(...,
    replication=2)`` over 7b's second group of the masters (503 MB, ten
    tensors; the whole tree is cut for the run's time limit), one window
    (each save diffs against the last); the baseline save, then phase 2's
    change 1, whose save is selective; rank 0's worker is SIGKILLed, and
    ``restore()`` must return step 2 with a tree equal to the masters, bit
    for bit, served from the replica with no restart."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models import param_specs
    every = {k: s.shape for k, s in param_specs(cfg).items()}
    shapes = {k: every[k] for k in shard_groups(every)[1]}
    masters = {k: t for k, t in make_masters(cfg, seed, device).items()
               if k in shapes}
    cm = CheckpointManager(str(directory), comm,
                           {k: (s, np.float32) for k, s in shapes.items()},
                           double_buffer=False, replication=2)
    try:
        cm.save(1, masters)
        change = {k: idx for k, idx in
                  mutation_plan(every, seed)[0].items() if k in shapes}
        apply_mutation(masters, change)
        slots = {f"master/{k}": s for k, s in cm.windows["a"].slots.items()}
        want = changed_pages(slots, shapes, change) * PAGE
        cm.save(2, masters)
        saves = [dict(r) for r in cm.records]
        check(saves[1]["bytes"] == want,
              f"8c: the selective save flushed {saves[1]['bytes']} B, the "
              f"changed pages give {want}")
        comm.transport.kill_rank(0)
        res = cm.restore()
        check(res is not None and res.step == 2,
              f"8c: restore gave {res and res.step}, not step 2")
        check(not comm.probe(0), "8c: rank 0 was alive during the restore")
        for k, t in masters.items():
            check(np.array_equal(
                res.tree[k].reshape(-1).view(np.uint32),
                t.detach().cpu().numpy().reshape(-1).view(np.uint32)),
                f"8c: restored {k} differs from the masters")
        out = {"tree_bytes": sum(t.numel() * 4 for t in masters.values()),
               "saves": saves, "restore": cm.restore_records[-1]}
    finally:
        cm.close()
    log("8c: " + json.dumps(out))
    return out


def replicated_phase(cfg, dev, shards7b: dict, directory: Path, *,
                     dht: dict = REP_DHT, log=print,
                     mark=lambda label: None) -> dict:
    """Phase 8: fault tolerance with the card as the origin.

    8a runs :func:`rep_shards` under inproc and mp (files byte-identical;
    each step's sync ms beside 7b's unreplicated ones, from ``shards7b``);
    8b runs ``repro_torch.launch.replicated_failover`` on the same 4-rank
    mp world (whole again after 8a's rebuild) at 7c's table size; 8c
    :func:`ckpt_survives` over a 2-rank mp world.  Everything is written
    under ``directory``, removed at the end."""
    from repro_torch.core import Communicator
    from repro_torch.launch import replicated_failover
    out = {}
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        worlds = {"inproc": Communicator(4),
                  "mp": Communicator(4, transport="mp")}
        out["mp_world_s"] = time.perf_counter() - t0
        runs = {}
        try:
            for kind, comm in worlds.items():
                d = directory / f"rep_{kind}"
                d.mkdir()
                runs[kind] = rep_shards(cfg, comm, device=dev, directory=d,
                                        log=log)
            worlds.pop("inproc").close()
            files = same_files(directory / "rep_inproc",
                               directory / "rep_mp")
            check(runs["mp"]["rebuild_bytes"]
                  == runs["inproc"]["rebuild_bytes"],
                  "8a: rebuild bytes differ between inproc and mp")
            out["8a"] = {"files_identical": files, **runs,
                         "unreplicated_7b_sync_ms": {
                             kind: [r["sync_ms"]
                                    for r in shards7b[kind]["ranks"]]
                             for kind in ("inproc", "mp")}}
            out["8a"]["launches"] = {
                name: sum(r["launches"][name] for r in runs.values())
                for name in ("dirty_diff", "diff_pack")}
            mark("8a")
            shutil.rmtree(directory)
            directory.mkdir()
            out["8b"] = replicated_failover.run(
                worlds["mp"], directory, lv_entries=dht["lv_entries"],
                keys=dht["keys"], more=dht["more"],
                log=lambda m: log("8b " + m))
        finally:
            for comm in worlds.values():
                comm.close()
        mark("8b")
        shutil.rmtree(directory)
        directory.mkdir()

        comm = Communicator(2, transport="mp")
        try:
            out["8c"] = ckpt_survives(cfg, comm, device=dev,
                                      directory=directory, log=log)
        finally:
            comm.close()
        mark("8c")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return out


# -- measurements ----------------------------------------------------------------

def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card's clock (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def measure_sync(masters: dict, snapshot: dict, block_elems: int) -> dict:
    """Each kernel against its plain version at the main path's shapes (bit
    for bit), then kernel, copy, plain-version and library times over one
    sync's shard set (every master tensor against its snapshot)."""
    from repro_torch.kernels import ops, ref
    pairs = [(masters[k], snapshot[k]) for k in sorted(masters)]
    worst = max(_compare(ops, ref, c, s, block_elems) for c, s in pairs)
    rows = [(ops.padded_rows(c, block_elems), ops.padded_rows(s, block_elems))
            for c, s in pairs]
    n_bytes = sum(c.numel() * c.element_size() for c, _ in pairs)
    nblocks = sum(c2.shape[0] for c2, _ in rows)
    out = {"bytes": n_bytes, "blocks": nblocks, "max_abs_err": worst}
    out["dirty_diff_ms"] = cuda_ms(lambda: [
        ops.dirty_blocks(c, s, block_elems=block_elems) for c, s in pairs])
    out["diff_pack_ms"] = cuda_ms(lambda: [
        ops.dirty_pack(c, s, block_elems=block_elems) for c, s in pairs])
    out["dirty_diff_plain_ms"] = cuda_ms(lambda: [
        ref.dirty_diff_ref(c2, s2) for c2, s2 in rows])
    out["diff_pack_plain_ms"] = cuda_ms(lambda: [
        ref.diff_pack_ref(c2, s2) for c2, s2 in rows])
    out["dirty_diff_library_ms"] = cuda_ms(lambda: [
        (c2 != s2).view(c2.shape[0], -1).any(1) for c2, s2 in rows])
    # no one PyTorch call computes diff + pack: B2 has no library time.
    # For information, the two-call composition (compare, then gather the
    # changed rows), which gives neither the flags nor the count
    out["diff_pack_library_ms"] = None
    out["diff_pack_two_calls_ms"] = cuda_ms(lambda: [
        c2[(c2 != s2).view(c2.shape[0], -1).any(1)] for c2, s2 in rows])
    packs = [ops.dirty_pack(c, s, block_elems=block_elems) for c, s in pairs]
    flags = [f for f, _, _ in packs]
    ks = [int(f.sum()) for f in flags]
    parts = [p[:k].view(torch.uint8).reshape(-1)
             for (_, p, _), k in zip(packs, ks) if k]
    out["dirty_blocks"] = sum(ks)
    out["dirty_bytes"] = sum(k * block_elems * c.element_size()
                             for (c, _), k in zip(pairs, ks))
    out["bitmap_copy_ms"] = host_ms(lambda: torch.cat(flags).cpu())
    out["payload_copy_ms"] = (host_ms(lambda: torch.cat(parts).cpu())
                              if parts else 0.0)
    # bounds: each input read once, each output written once
    out["dirty_diff_bound_ms"] = (2 * n_bytes + 4 * nblocks) \
        / HBM_BYTES_PER_S * 1e3
    out["diff_pack_bound_ms"] = (2 * n_bytes + 4 * nblocks
                                 + out["dirty_bytes"] + 4) \
        / HBM_BYTES_PER_S * 1e3
    return out


def comparator_row(name: str, m: dict, err: float, launches: int) -> dict:
    """A comparator's entry of the kernels line: its check and its time on
    the same inputs as the kernel it was replaced by (``m``, which also
    gives the bound and the plain and library times), and its launches in
    the serving phases (``serving_phase``'s count, 0: it is on no path)."""
    return {"name": name, "route": "cuda", **KERNELS[name],
            "launches": launches,
            "max_abs_err": err, "ms": m["comparator_ms"],
            **{k: m.get(k) for k in ("plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}


def gpu_line() -> str:
    smi = shutil.which("nvidia-smi")
    check(smi is not None, "nvidia-smi not found")
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.convert import exact_float32

    exact_float32()  # the plain versions' float32 products stay float32
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          "device(s)")
    t0 = time.perf_counter()
    built = _build.build(BUILD)
    for name, b in built.items():
        print(f"built {name} in {b['seconds']:.2f} s -> {b['path']}")
        for line in b["log"].splitlines():
            if "entry function" in line:  # the instantiation that follows
                print(f"  ptxas {name}: {line.split()[-3][-60:]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build wall: {time.perf_counter() - t0:.2f} s")

    marks = [time.perf_counter()]  # phase boundaries, for the walls line
    worst = phase1(dev)
    attn_err = phase1b(dev)
    ssd_err = phase1c(dev)
    rg_err = phase1d(dev)
    marks.append(time.perf_counter())

    shutil.rmtree(WORKDIR, ignore_errors=True)
    WORKDIR.mkdir(parents=True)
    cfg = smoke_config()
    block_elems = PAGE // 4
    measured = {}

    def on_sync(i, change, masters, snapshot):
        m = measure_sync(masters, snapshot, block_elems)
        print(f"sync {i + 1} times ({card}): " + json.dumps(m))
        measured[i] = m

    try:
        result = run_main_path(cfg, device=dev, directory=WORKDIR,
                               on_sync=on_sync)
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    launches = result["launches"]
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    print(f"phase 2 flush ms per sync, host span apply and write-back "
          f"({card}): " + json.dumps(
              [round(r["flush_ms"], 3) for r in result["records"]]))
    worst = max([worst] + [v["max_abs_err"] for v in measured.values()])
    m = measured[0]  # the 8% page-spread sync: the main traffic
    kernels = []
    for name in ("dirty_diff", "diff_pack"):
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "max_abs_err": worst,
            "ms": m[f"{name}_ms"], "plain_ms": m[f"{name}_plain_ms"],
            "bound_ms": m[f"{name}_bound_ms"], "bound_by": "bytes",
            "library_ms": m[f"{name}_library_ms"]})
    kernels[-1]["two_calls_ms"] = m["diff_pack_two_calls_ms"]

    marks.append(time.perf_counter())
    serve = serving_phase("internlm2-1.8b", dev, consistency_limit=0.02)
    print(f"serve ({card}): " + json.dumps(
        {k: v for k, v in serve.items() if k not in ("tokens", "step_ms")}))
    print("serve tokens (request 0, first 16): "
          f"{serve['tokens'][0, :16].tolist()}")
    a = measure_attention(dev)
    print(f"attention at {ATTN_MAIN}, bf16 ({card}): " + json.dumps(a))
    a32 = measure_attention(dev, dtype=torch.float32)
    print(f"attention at {ATTN_MAIN}, float32 ({card}): " + json.dumps(a32))

    marks.append(time.perf_counter())
    # phase 4: Mamba-2 serving.  Its bf16 readings are printed, not held:
    # at 64 layers they spread 0.022-0.030 over CONSISTENCY_SEEDS on an
    # H100, every one above phase 3's 0.02, while the float32 gate reads
    # about 3e-6 (PERF.md); the gate holds the cache and the scan.  The
    # readings at 4 (the gate's depth) and 24 layers show how they grow
    # with depth in bf16
    ssm = serving_phase("mamba2-2.7b", dev, consistency_limit=None,
                        depths=(F32_LAYERS, 24))
    print(f"serve mamba2 ({card}): " + json.dumps(
        {k: v for k, v in ssm.items() if k not in ("tokens", "step_ms")}))
    print("serve mamba2 tokens (request 0, first 16): "
          f"{ssm['tokens'][0, :16].tolist()}")
    # B4: the bf16 kernel runs the prefills, the float32 kernel the gate;
    # no PyTorch call computes the scan (the plain chunked form is beside)
    for dtype, name, n in (
            (torch.bfloat16, "ssd_scan_tc", ssm["launches"]["ssd_scan_tc"]),
            (torch.float32, "ssd_scan_tc32",
             ssm["float32_launches"]["ssd_scan_tc32"])):
        m = measure_ssd(dev, dtype)
        print(f"{name} at {SSD_MAIN} ({card}): " + json.dumps(m))
        row = {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": n, "max_abs_err": ssd_err[dtype],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "chunked_torch_ms": m["chunked_torch_ms"],
            "scratch_bytes": m["scratch_bytes"]}
        if dtype == torch.float32:
            ssd32 = row, m  # its comparator's entry follows phase 5
        kernels.append(row)
    marks.append(time.perf_counter())

    # phase 5: RecurrentGemma serving.  Its bf16 readings fell under 0.02
    # on every seed of CONSISTENCY_SEEDS on an H100 (0.011-0.015, PERF.md),
    # so seed 0 is held there as in phase 3; the float32 gate, with a prompt
    # past the window, holds the ring cache and the carried state
    rg = serving_phase("recurrentgemma-2b", dev, consistency_limit=0.02,
                       f32_prompt=2100)
    print(f"serve recurrentgemma ({card}): " + json.dumps(
        {k: v for k, v in rg.items() if k not in ("tokens", "step_ms")}))
    print("serve recurrentgemma tokens (request 0, first 16): "
          f"{rg['tokens'][0, :16].tolist()}")
    a_rg = measure_attention(dev, ATTN_RG, RG_WINDOW)
    print(f"attention at {ATTN_RG}, window {RG_WINDOW}, bf16 ({card}): "
          + json.dumps(a_rg))
    a32_rg = measure_attention(dev, ATTN_RG, RG_WINDOW, dtype=torch.float32)
    print(f"attention at {ATTN_RG}, window {RG_WINDOW}, float32 ({card}): "
          + json.dumps(a32_rg))
    m = measure_rg_lru(dev)
    print(f"rg_lru at {RG_MAIN} ({card}): " + json.dumps(m))
    # the comparators' launches in phases 3-5, each phase's read at its end
    on_paths = {name: sum(p["comparator_launches"][name]
                          for p in (serve, ssm, rg))
                for name in ("flash_attention", "ssd_scan", "rg_lru")}
    ssd32[0]["comparator"] = comparator_row(
        "ssd_scan", ssd32[1], ssd_err["comparator"], on_paths["ssd_scan"])
    # B3 runs in phases 3 and 5: the bf16 kernel in the prefills, the
    # float32 kernel in the gates.  Launches are both paths', times phase
    # 3's shape, with phase 5's beside them
    times = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for at, (name, dtype, at_main, at_rg, path) in enumerate((
            ("flash_attention_tc", torch.bfloat16, a, a_rg, "launches"),
            ("flash_attention_tc32", torch.float32, a32, a32_rg,
             "float32_launches"))):
        row = {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": serve[path][name] + rg[path][name],
            "max_abs_err": attn_err[dtype],
            **{k: at_main[k] for k in times},
            "recurrentgemma": {
                "shape": list(ATTN_RG), "window": RG_WINDOW,
                "launches": rg[path][name],
                **{k: at_rg[k] for k in times}}}
        if dtype == torch.float32:
            row["comparator"] = comparator_row(
                "flash_attention", at_main, attn_err["comparator"],
                on_paths["flash_attention"])
            row["comparator"]["recurrentgemma"] = comparator_row(
                "flash_attention", at_rg, attn_err["comparator"],
                rg["comparator_launches"]["flash_attention"])
        kernels.insert(2 + at, row)
    # B5: one kernel for both dtypes; the prefills pass it float32
    kernels.append({
        "name": "rg_lru_pipe", "route": "cuda", **KERNELS["rg_lru_pipe"],
        "launches": rg["launches"]["rg_lru_pipe"],
        "max_abs_err": rg_err["kernel"], "ms": m["ms"],
        **{k: m[k] for k in ("plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        "comparator": comparator_row("rg_lru", m, rg_err["comparator"],
                                     on_paths["rg_lru"])})
    marks.append(time.perf_counter())

    # phases 6, 6b and 6c: training with window checkpoints (no kernel of
    # the package runs on these paths; the counts are set to 0 before each
    # and must stay 0)
    trained = {}
    for phase in TRAIN_PHASES:
        out = trained[phase] = training_phase(dev, phase)
        label = f"train {phase} {TRAIN_PHASES[phase]['arch']}"
        prof = out.pop("step_profile")
        saves = out.pop("saves", None)
        print(f"{label} ({card}): " + json.dumps(out))
        print(f"{label} step profile, accumulation over "
              f"{TRAIN_PHASES[phase]['microbatches']} microbatches + AdamW ({card}): "
              + json.dumps(prof))
        if saves is not None:
            print(f"{label} saves ({card}): " + json.dumps(saves))
        marks.append(time.perf_counter())
    train = trained["6"]

    # phase 7: the MPI layer across processes.  A failure to spawn a worker
    # or a TransportError ends the run: nothing falls back to inproc
    with PeakRss() as rss:
        mp = mp_phase(cfg, dev, result, MP_DIR, mark=rss.mark)
    print(f"mp host memory, this process ({card}): " + json.dumps(
        {"start_bytes": rss.start, "peak_bytes": rss.peak,
         "stretches": rss.marks,
         "phase_6_peak_bytes": train["peak_host_rss_bytes"]}))
    check(rss.peak - rss.start <= MP_HOST_LIMIT,
          f"phase 7 took this process from {rss.start} to {rss.peak} B, "
          f"more than {MP_HOST_LIMIT} over its start: {rss.marks}")
    print(f"mp 7a, the main path into a worker-owned window, beside phase "
          f"2's inproc numbers ({card}): " + json.dumps(mp["7a"]))
    print(f"mp 7b, ranks 1-3 as targets ({card}): " + json.dumps(mp["7b"]))
    print(f"mp 7c, DHT ({card}): " + json.dumps(mp["7c"]))
    print(f"mp 7d, MapReduce ({card}): " + json.dumps(mp["7d"]))
    marks.append(time.perf_counter())

    # phase 8: fault tolerance.  A worker that cannot start, or a failover
    # that raises, ends the run
    with PeakRss() as rss:
        rep = replicated_phase(cfg, dev, mp["7b"], REP_DIR, mark=rss.mark)
    print(f"rep host memory, this process ({card}): " + json.dumps(
        {"start_bytes": rss.start, "peak_bytes": rss.peak,
         "stretches": rss.marks}))
    check(rss.peak - rss.start <= MP_HOST_LIMIT,
          f"phase 8 took this process from {rss.start} to {rss.peak} B, "
          f"more than {MP_HOST_LIMIT} over its start: {rss.marks}")
    print(f"rep 8a, replicated device syncs through a SIGKILL, beside 7b's "
          f"unreplicated syncs ({card}): " + json.dumps(rep["8a"]))
    print(f"rep 8b, replicated DHT through a SIGKILL ({card}): "
          + json.dumps(rep["8b"]))
    print(f"rep 8c, a checkpoint restored with its owner dead ({card}): "
          + json.dumps(rep["8c"]))
    # B1/B2 run on four paths: phase 2, 7a, 7b and 8a, each counted from 0
    for row in kernels[:2]:
        by_phase = {"2": launches[row["name"]],
                    "7a": mp["7a"]["launches"][row["name"]],
                    "7b": mp["7b"]["launches"][row["name"]],
                    "8a": rep["8a"]["launches"][row["name"]]}
        check(all(by_phase.values()),
              f"{row['name']} never launched on a path: {by_phase}")
        row["launches"] = sum(by_phase.values())
        row["launches_by_phase"] = by_phase
    marks.append(time.perf_counter())

    # phase 9: the configurations added last, served at their published
    # widths (depth cut where the card's memory forces it).  Every kernel's
    # launches are counted over the whole phase: only B3 may launch
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in BUILD}
    for mod in mods.values():
        mod.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 9 starts with {torch.cuda.memory_allocated(dev)} B "
          "allocated on the card")
    new = {}
    for sub in PHASE9:
        out = new[sub] = new_config_phase(sub, dev)
        print(f"serve {sub} {PHASE9[sub]['arch']} ({card}): " + json.dumps(
            {k: v for k, v in out.items() if k not in ("tokens", "step_ms")}))
        print(f"serve {sub} tokens (request 0, first 16): "
              f"{out['tokens'][0, :16].tolist()}")
        gc.collect()
        torch.cuda.empty_cache()
    in_phase = {name: mod.launches for name, mod in mods.items()}
    check(all(n == 0 for name, n in in_phase.items()
              if not name.startswith("flash_attention_tc")),
          f"phase 9 launched a kernel off its path: {in_phase}")
    # the main paths' launches: each sub-phase's two serving prefills (bf16
    # kernel) and its gate's two (float32 kernel), as in phases 3-5
    phase9_launches = {name: sum(
        out[path].get(name, 0) for out in new.values()
        for path in ("launches", "float32_launches") if path in out)
        for name in mods}
    print("phase 9 walls (s): " + json.dumps(
        {sub: round(out["wall_s"], 1) for sub, out in new.items()}))
    # B3 at each new config's prefill shape, both kernels
    attn_new = {}
    for arch, (shape, dv) in ATTN_NEW.items():
        for dtype in (torch.bfloat16, torch.float32):
            m = attn_new[arch, dtype] = measure_attention(dev, shape,
                                                          dtype=dtype, dv=dv)
            print(f"attention at {shape}, dv {dv or shape[4]}, {arch}, "
                  f"{str(dtype).removeprefix('torch.')} ({card}): "
                  + json.dumps(m))
    for row in kernels[2:4]:
        dtype = torch.float32 if row["name"].endswith("32") else \
            torch.bfloat16
        path = "float32_launches" if dtype == torch.float32 else "launches"
        row["launches"] += phase9_launches[row["name"]]
        row["phase9"] = {
            arch: {"shape": list(shape), "dv": dv or shape[4],
                   "launches": sum(out[path].get(row["name"], 0)
                                   for sub, out in new.items()
                                   if PHASE9[sub]["arch"] == arch
                                   and path in out),
                   **{k: attn_new[arch, dtype].get(k) for k in
                      (*times, "library_refused")}}
            for arch, (shape, dv) in ATTN_NEW.items()}
    marks.append(time.perf_counter())

    # B3-B5 run in the serving phases' prefills (and float32 gates)
    for row in kernels[2:]:
        name, path = row["name"], ("float32_launches" if row["name"].endswith(
            "32") else "launches")
        row["launches_by_phase"] = {
            ph: out[path][name] for ph, out in (("3", serve), ("4", ssm),
                                                ("5", rg))
            if name in out[path]}
    # every kernel in the training phases (0, checked there) and in phase 9
    for row in kernels:
        stem = Path(KERNELS[row["name"]]["source"]).stem
        row["launches_by_phase"].update(
            {ph: out["kernel_launches"][stem] for ph, out in trained.items()})
        row["launches_by_phase"]["9"] = phase9_launches[stem]
    print("phase walls (s): " + json.dumps(
        {name: round(b - a, 1) for name, a, b in zip(
            ("phases 1, 1b, 1c, 1d", "phase 2", "phase 3", "phase 4",
             "phase 5", *(f"phase {ph}" for ph in TRAIN_PHASES), "phase 7",
             "phase 8", "phase 9"), marks, marks[1:])}))
    print(f"command wall (s): {time.perf_counter() - START:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # spawn re-runs the main script in every mp worker unless the main
    # module's spec is named "__main__" (as for ``python -m pkg``); the
    # workers call nothing of this file, and its torch import would cost
    # each start (world or respawn) seconds
    from importlib.machinery import ModuleSpec
    __spec__ = ModuleSpec("__main__", None)
    sys.exit(main())
