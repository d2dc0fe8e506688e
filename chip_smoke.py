"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

1. prints the card's name and power limit, builds the CUDA kernels from the
   sources in the checkout (one ``nvcc`` each, in parallel, beside one
   ``nvcc -Xptxas -v`` of each for its registers and spills): the flash
   forward (its serving instances and the training instances that also
   write the log-sum-exp), the flash backward, the decode kernel and the
   row-invariant GEMM (``gemm.cu``: bf16 instances by TMA and by guarded
   loads, the float32 one, the split-K sum, each also batched for
   ``bgemm``; a spill at any of them fails);
2. holds the Triton ``era_update`` kernel against its plain PyTorch version
   (max abs error <= 1e-5, the reference's fused-step tolerance) at the
   rows of qwen2-1.5b's, hymba-1.5b's, xlstm-350m's, whisper-base's and
   paligemma-3b's 8x256 batches and ragged and one-row cases, also with
   half the rows spent under a step mask (their ``x_next`` bitwise ``x``)
   at qwen2's, hymba's and paligemma's rows;
   times it by profiler device time, L2-warm and L2-cold, beside the CUDA
   event time of a wrapper call;
3. holds the CUDA ``flash_attention`` kernel against its plain version
   (all-float32 math) at qwen2-1.5b shapes in bf16 (the ERA path's 8x256
   and 8x128, the AR prefill's causal 8x512, phase 7's seq buckets with
   their per-row length masks) and in the masking, softcap,
   ragged-tile and head-dim variants, and in cases whose positions are not
   tile indices (queries offset from keys, a wrapped ring with empty slots,
   whole kv tiles masked in some rows), so that a tile skip decided from
   indices would fail; the (192, 128) instance of MLA (deepseek-v2-lite:
   q/k 128 + 64 rope dims, v 128) at phase 10's 8x256 causal batch with
   per-row lengths, its 8x512 AR prefill and a ragged S, hymba-1.5b's
   (hd 64, G 5: phase 11's non-causal 8x256 batch with window 1024 and
   per-row lengths, its causal 8x640 prefill with 128 protected meta
   positions), the (256, 256) instance of paligemma-3b (H 8 over one kv
   head: phase 12's non-causal 8x256 batch with per-row lengths, its causal
   8x768 prefill after 256 patches, a ragged S), whisper-base's shapes
   (hd 64: phase 12's causal 8x256 decoder batch with per-row lengths, the
   encoder's non-causal 8x1500, the cross-attention prefill of 512 queries
   at position 0 over 1500 keys), and a CUDA call
   with a head-dim pair that has no instance ((192, 64), (256, 128)) must
   raise; prints each instance's registers, spills (none allowed at (128,
   128)) and shared memory; times it at the three path shapes beside SDPA,
   the MLA instance at 8x256, L2-warm and L2-cold, beside SDPA, hymba's
   two, and phase 12's four (paligemma's 8x256 and prefill, whisper's
   encoder and cross prefill) L2-warm and L2-cold beside SDPA;
4. the ERA path: ``warmup()`` captures the bucket graphs, then requests are
   served through the port's ``BatchedSampler`` on a full-width qwen2-1.5b
   denoiser (28 layers, d_model 1536, bf16, random seeded weights) with ERA
   at nfe=10 as graph replays; checks the outputs, that a replay leaves an
   earlier result unchanged, that the launch counters (taken from the
   replays) show the path's kernels, and that the same batch run eagerly
   through the program's loop agrees; profiles the replay and the eager
   run for the device's busy time (the union of the trace's device
   intervals) and idle share (over that trace's own span; the share over
   the unprofiled wall is printed beside it); then the mesh: the 8x256 batch (1 + 3 rows) drained
   by an engine on ``make_sampler_mesh()`` (dp = the card count) and by
   one without a mesh, each warmed, bitwise equal at dp = 1 with the same
   launches (7 ``era_update``, 280 ``flash_attention``); and the dry run's
   count of that request (``launch/dryrun.py``'s ``run_solver_program`` on
   a meta denoiser) over the replay's busy time: the achieved TFLOP/s and
   its share of the bf16 peak, which must lie in (0, 1];
5. holds the CUDA ``decode_attention`` kernel against its plain version at
   the AR path's shape (half-empty and full cache, the position as a host
   int and as a tensor on the card), wrapped rings with window and
   protected slots (whole blocks of a cluster outside the window; every
   slot outside it), a cache length that is not a multiple of the tile or
   the cluster's span, G=5, G=20, head dims 64 and 32, hymba-1.5b's
   1024-slot ring (H=25, KV=5, hd 64) with 128 protected slots half full,
   full and wrapped under its window, a batch large enough
   for a cluster of one block, a query with no valid slot (exact
   zeros), the hd-256 instance at paligemma-3b's KV=1, G=8 on a 1024-slot
   ring half full, full and wrapped, the non-causal mode over whisper-base's
   1500 encoder keys with the query at 100 (the causal mode must differ)
   and whisper's G=1 self ring; prints each instance's registers, spills
   and shared memory and the cluster size; times it on both caches, L2-warm
   and L2-cold (L2 flushed before each call), beside SDPA, also at hymba's
   ring, paligemma's ring and whisper's cross keys and self ring;
6. the AR path: ``Engine.generate`` on the full-width qwen2-1.5b token model
   (vocab padded to 153,600, random seeded weights), batch 8, prompt 512,
   64 new tokens, 1024 cache slots; checks the launch counters and, as a
   smoke check, that the decode logits equal a fresh prefill's, and that
   this check sees a planted fault; profiles the decode loop (the decode
   kernel's time a launch inside it and its share of the loop's device
   time) and counts the rope's share of its device ops;
7. the bucketed ERA drain: an engine with seq buckets (128, 256) and nfe
   bucket 10 captures its 2 graphs in ``warmup()`` (and once more with a
   memory pool per graph, to measure what the shared pool saves), then
   serves four requests of mixed seq_len and nfe in exactly two fused
   batches; checks each result's shape and step count, each against its
   solo drain, that nothing is captured during the drains, and profiles the
   drain;
8. the baseline solvers: checks that the port registers all eight solver
   programs, then serves each of the seven baselines (DDIM, AB4 and PECE
   Adams, DPM-Solver 2 / fast / ++2M, adaptive DPM) through
   ``build_engine``: an 8x256 nfe=10 batch as a graph replay captured by
   ``warmup()``, checked finite, bitwise equal to the same batch run
   eagerly through the program's loop, unchanged by a later replay, with
   exactly 280 ``flash_attention`` launches and no ``era_update``;
   profiles the replay and the eager run; for the five programs that
   support steps, a drain of budgets 10, 8 and 6 fused into one 8-row
   batch of NFE bucket 10, each request bitwise equal to its solo drain;
9. the serving surface: ``serve_frontdoor`` on a loopback port over an
   ERA engine (batch buckets 1 and 8, seq 256, nfe 10) whose two graphs the
   front door's background warmup captures; a 1-row wire request is served
   while the warmup runs (the warmup holds after its first graph until that
   request has replayed it, and captures the second while the result is
   encoded and sent) and is bitwise its solo drain; ``/readyz`` turns 200
   when the grid is in (time to ready, warmup wall, ``memory_reserved``
   growth); eight concurrent 1-row wire requests ride one 8-row replay
   (+280 ``flash_attention``, +7 ``era_update`` launches, no capture), each
   bitwise its solo drain at the same bucket and at bucket 1; a 429 and a 504 come back
   typed from a held queue; ``/metrics`` parses; an open-loop stream of 32
   requests through ``AsyncBatchedSampler`` (p50/p99, throughput, batches,
   idle share); and the launcher's ``--listen`` default grid (batch 1, 8,
   64 at seq 256) is captured for its wall and memory;
10. the MoE and MLA families, one model on the card at a time: the
   full-width deepseek-v2-lite-16b denoiser (27 layers of MLA + 64-expert
   top-6 MoE with 2 shared experts, bf16, random seeded weights) serves an
   8x256 nfe=10 ERA batch as a replay of the graphs ``warmup()`` captured
   (batch 8 x seq 128, 256), with exactly 270 ``flash_attention`` and 7
   ``era_update`` launches, finite, bitwise its eager run and unchanged by
   a later replay; two requests of 200 and 256 fused into one seq-256
   batch, each bitwise its solo drain; the replay profiled (busy, idle
   share, shares of GEMMs, the MoE dispatch's index kernels and flash).
   Its token model runs ``Engine.generate`` (batch 8, prompt 512, 32 new
   tokens, 1024 slots): decode ms a step, idle share, and decode logits
   held to a fresh prefill's (both without MoE drops) with a planted fault
   (the newest prompt entry dropped) that the check must see.  minitron-4b
   at full width: the same replay against eager (320 flash launches) and a
   short ``generate`` (16 tokens) with the logits check.  mixtral-8x7b at
   full width cut to 4 of its 32 layers: the replay against eager (40
   flash launches);
11. the SSM and hybrid families, one model on the card at a time, at full
   width in bf16 with random seeded weights: xlstm-350m (24 blocks of
   mLSTM / sLSTM, no attention) and hymba-1.5b (32 layers of attention and
   Mamba heads, 128 meta tokens).  Each denoiser serves an 8x256 nfe=10
   ERA batch as a replay of the graphs ``warmup()`` captured (batch 8 x seq
   128, 256): finite, bitwise its eager run, unchanged by a later replay,
   exactly 7 ``era_update`` and 320 (hymba) or 0 (xlstm)
   ``flash_attention`` launches, two requests of 200 and 256 fused into
   one seq-256 batch each bitwise its solo drain, nothing captured during
   the drains; the replay profiled (busy, idle share, device ops per NFE,
   GEMM and flash shares), then the program captured again with a marker
   kernel around each scan call, bitwise the served result, and its
   replay's device time split by the markers: each scan's share (Mamba's
   chunk scan, mLSTM's chunkwise pass, the sLSTM time loop, their own
   products included) beside the GEMMs, flash and the rest outside them.
   Each token model runs
   ``Engine.generate`` (batch 8, prompt 512, 32 new tokens, 1024 slots;
   hymba prefills 640 positions with 128 protected): exactly 32 flash and
   32 x 31 decode launches for hymba, none for xlstm; decode logits held
   to a fresh prefill's, with a planted fault the check must see (hymba:
   the K and V of the 128 protected slots overwritten with the newest
   prompt entries' in every layer; xlstm: one mLSTM
   layer's ``c`` zeroed after the prefill).  The flash and decode kernels
   are checked and timed at hymba's shapes in phases 3 and 5;
12. the audio and vlm families, one model on the card at a time, at full
   width in bf16 with random seeded weights: whisper-base (a 6-layer
   encoder over (8, 1500, 512) stub frames, 6 ``xdec`` decoder layers,
   learned positions) and paligemma-3b (18 Gemma layers, 8 heads over one
   kv head of 256, 256 stub image patches), the stub inputs drawn by
   ``frontend_features`` from a seeded numpy generator.  Each denoiser
   serves an 8x256 nfe=10 ERA batch as a replay of the graphs ``warmup()``
   captured (batch 8 x seq 128, 256): finite, bitwise its eager run,
   unchanged by a later replay, exactly 7 ``era_update`` and 60 (whisper:
   decoder-only, no cross-attention) or 180 (paligemma) ``flash_attention``
   launches, two requests of 200 and 256 fused into one seq-256 batch each
   bitwise its solo drain; the replay profiled (busy, idle share, device
   ops per NFE, GEMM and flash shares).  Each token model runs
   ``Engine.generate`` (batch 8, prompt 512, 32 new tokens, 1024 slots):
   paligemma prefills its 256 patches and the prompt (768 positions, 18
   flash launches) and decodes from position 768 (18 x 31 decode
   launches); whisper encodes the frames and prefills (6 encoder, 6 self
   and 6 cross flash launches) and decodes with 6 self and 6 non-causal
   cross launches a step; decode logits held to a fresh prefill's, with a
   planted fault the check must see (whisper: one layer's ``xk`` zeroed
   after the prefill; paligemma: the patch slots' K overwritten in every
   layer);
13. training: holds the CUDA flash backward kernel (``flash_attention``
   under autograd: a row-preparation launch, then dK/dV and dQ on
   ``wgmma``, fed by TMA through an ``mbarrier`` ring, dK/dV split over a
   thread-block cluster and summed through distributed shared memory, no
   atomics) against ``flash_attention_bwd_plain`` (all-float32
   formulas, given the plain forward's output) on dq, dk and dv, and the
   forward's training instance against ``flash_attention_plain`` on its
   output and its log-sum-exp, at qwen2-1.5b's 8x256 diffusion batch with
   per-row lengths, its causal 8x512, hymba-1.5b's hd 64 at G = 5 with
   window 1024 and 128 protected keys (S = 1280), a ragged S, a fully
   masked row (zero grads), queries offset from keys and softcap at hd 32,
   and at deepseek-v2-lite's MLA (192, 128) (causal 8x256, H = KV = 16,
   row lengths 200 x3 / 256 x5) and paligemma's (256, 256) (8x256, H 8
   over KV 1, row lengths 200 x4 / 256 x4), each also at a ragged S = 200
   with a fully masked row; two runs bitwise equal; a call at (96, 96), a
   pair with no instance, must raise before any launch; its registers and
   spills (none at any instance, nor at any of the forward's training
   instances); its device time, and each launch's, L2-warm and L2-cold
   beside its bound (the five products the gradient needs, or its bytes)
   and one autograd backward of SDPA, at qwen2's 8x256 and causal 8x512,
   hymba's 2x1280, MLA's causal 8x256 and paligemma's 8x256.  Then
   full-width qwen2-1.5b (float32 parameters, bf16 compute) trains through
   ``launch/train.py``'s ``setup``: 10 steps of the diffusion objective,
   then 5 of the LM objective, batch 8 x 256, each step with exactly 28
   flash forward and 28 backward launches and a finite loss, the first
   loss equal to the same loss under ``no_grad`` on the same draws, every
   attention weight with a non-zero gradient, steps/s, tokens/s, peak
   memory, one profiled step (GEMM, flash forward / backward shares) and
   AdamW's update timed alone; a checkpoint round trip at qwen2's widths
   cut to 2 layers (a full archive is 21 GB), restored into a fresh
   denoiser whose ``eps`` is bitwise the trained one's; then every other
   registry arch but the three largest, one model at a time at full
   width: llama3.2-1b, paligemma-3b, deepseek-v2-lite-16b cut to its
   first 7 of 27 layers (MoE routing unpinned, its aux losses in the
   loss), whisper-base (the token model's encoder over 8 x 1,500 stub
   frames and cross-attention), hymba-1.5b (window 1024 and 128 protected
   meta keys; batch 4) and xlstm-350m, each 3 diffusion and 2 LM steps
   with the same checks, flash launches a step read from the config (16,
   18, 7, whisper 6 / 18, 32, 0) and the scans' weights (Mamba, mLSTM,
   sLSTM) among those that must get a gradient;
14. the int8 KV cache (after the profiled phases): phase 6's model with
   ``kv_quant="int8"`` through ``Engine.generate`` (batch 8, prompt 512,
   32 new tokens, 1024 slots; 28 flash and 28 x 31 decode launches), the
   prefill's int8 entries the bf16 cache's rounded to nearest, its
   teacher-forced decode logits within 0.2 of the bf16 cache's scale (the
   reference's bound), a planted fault (one layer's int8 K zeroed after
   the prefill) that the cache check must see, its bytes a slot (528
   against 1,024) and its decode ms a step beside the bf16 cache's; and
   ``Engine(mesh=make_sampler_mesh())`` generating bitwise the tokens of
   the engine without a mesh; then each ``examples/torch_*.py`` at its
   tiny defaults on the card in a subprocess of its own, the three
   started together (quickstart, solver comparison, AR serving over the
   families); a failure fails the phase;
15. the dry run's memory against the card's: the qwen2-1.5b ERA request
   at 8x256 (nfe 10), run eagerly through the program's loop, and one
   qwen2-1.5b diffusion training step at 8x256, each from a clean
   allocator: ``max_memory_allocated()`` over the run against the dry
   run's count of the same program on meta (the state it is handed plus
   its activation peak), within 10% of the measured total, and the
   activation part alone within 5% of the measured one; then one
   partitioned count on this host (the request at 2x4 on a fake process
   group), its collective bytes a card and its wall;
16. the determinism contract (``docs/serving.md``; run after phase 9, on
   its denoiser): eight one-row requests (seq 256, nfe 10, seeds 0-7)
   drained alone at batch bucket 1, in one 8-row replay and inside a
   64-row replay among other seeds, each ``x0`` and ERS selection bitwise
   the same in all three (the launches of these drains are the GEMM's,
   rmsnorm's and ``row_sq_sums``'s main path, each checked non-zero); the
   8-row and the 1-row replay's wall and busy time; a 200-position request
   bitwise the same exact and padded to seq bucket 256; every solver
   program of the registry bitwise at buckets 1 and 8; whisper-base's
   denoiser (LayerNorm, counted) bitwise at buckets 1 and 8; the families
   whose products do not all go through ``Linear`` (MoE experts and
   router, the mLSTM / sLSTM products, Mamba's readout: ``bgemm``), one
   at a time at full width: deepseek-v2-lite-16b, mixtral-8x7b cut to 4 of
   its 32 layers, hymba-1.5b and xlstm-350m, each with a forward hook on
   every module over one ``eps`` call of 8 rows and of their first row
   alone (no module's output may differ) and eight requests' ``x0`` and
   ERS selections bitwise at buckets 1, 8 and 64 (counted: ``gemm`` and
   ``bgemm`` launches in each; the MoE families get no seq-padding check, their
   capacity comes from the padded length in both packages); then
   ``gemm`` against ``gemm_plain`` at every ``Linear`` (K, N) of
   qwen2-1.5b and llama3.2-1b and at the guarded-load shapes, at 1 to
   16,384 rows (among them counts at the grid's edges: fewer tiles than
   SMs, one wave, one tile over, many waves) with and without
   a bias (atol = rtol = 2^-6 in bf16; 1e-4 /
   1e-5 in float32), rows of ``x[:m]`` bitwise those of ``x``; ``bgemm``
   against ``bgemm_plain`` at every ``bgemm_shapes`` entry of the four
   families (and the split-K and guarded-load shapes) at G 1-24 (one
   wave of the grid and one over among them) and M 1-640 with
   and without a bias (the same tolerances), rows of
   ``x[:, :m]`` and batches of ``x[:g]`` bitwise those of ``x``, and
   ``gemm(x, w)`` bitwise ``bgemm(x[None], w[None])[0]`` at every qwen2
   ``Linear`` shape; Mamba's readout bitwise for the first row at 1 to 64
   rows of 256 and 128 positions; the Triton
   ``rmsnorm`` / ``layernorm`` (2^-7) and ``row_sq_sums`` (1e-5 relative)
   against their plain versions, prefix rows bitwise, ``row_sq_sums``
   padding-invariant; each timed L2-warm and L2-cold beside its bound, its
   plain version and ``torch.matmul`` / the fused PyTorch op (``bgemm``
   beside ``torch.bmm`` at the experts', Mamba's readout's, the mLSTM's
   and the sLSTM's shapes; the readout also beside the einsum); the
   ``gemm`` / ``bgemm`` launches of every path read by path;
17. prints one ``{"solvers": {...}}`` line with phase 8's figures, one
   ``{"frontdoor": {...}}`` line with phase 9's, one ``{"families":
   {...}}`` line with phases 10, 11 and 12's, one ``{"training": {...}}``
   line with phase 13's, one line with the mesh, the request's FLOPs, the
   int8 cache and the examples' walls, one ``{"dryrun_memory": {...}}``
   line with phase 15's, one ``{"batch_invariance": {...}}`` line with
   phase 16's, and one ``{"kernels": [...]}`` line with each
   kernel's launches (by path), error and times beside its bound, then
   the result line.

``python3 chip_smoke.py --era-ab PARENT/src`` instead times only the ERA
path (one denoiser forward, drains at batch buckets 8 and 1, each with a
replay's busy time) and reads phase 16's probe (the modules that differ,
each bucket's ``|x0|`` difference from bucket 1 at buckets 8 and 64;
nothing checked) with the
``repro_torch`` under ``PARENT/src`` against this checkout's, in the
order parent, this, this, parent, one process each; ``--era-arch`` names
the denoisers (default qwen2-1.5b; ``families`` for phase 16's four).
``python3 chip_smoke.py --flash-ab PARENT/src`` instead compares flash
kernels in one process: the one under ``PARENT/src`` (through its own
wrapper), this checkout's and tile variants of it, each checked and then
timed beside SDPA, in turns.
``python3 chip_smoke.py --decode-ab PARENT/src`` compares decode kernels in
one process the same way: the one under ``PARENT/src`` (through its own
wrapper), this checkout's and its cluster and warp variants, each checked
in every phase-5 case, then timed L2-warm and L2-cold at the half-full and
full cache, in turns.
``python3 chip_smoke.py --bwd-ab PARENT/src`` compares flash backward
kernels in one process: the one under ``PARENT/src`` (through its own
wrapper) and this checkout's, each checked in every phase-13 case, then
timed at qwen2's 8x256 and causal 8x512, hymba's 2x1280 and MLA's and
paligemma's 8x256 in the order parent, this, this, parent (a kernel with
no instance at a case's head-dim pair skips it, and says so).
``python3 chip_smoke.py --train-fit`` runs only the memory trials behind
phase 13's cuts: two LM steps of deepseek-v2-lite-16b at 7 and 8 layers
and of hymba-1.5b at batch 4 and 8, each with its peak memory or its
out-of-memory error.
``python3 chip_smoke.py --mesh-only`` runs only the mesh checks, data
parallel over every local card: phase 4's drain (three drains with and
without the mesh, x0 within ``MESH_X0_ATOL`` of the unsplit drain's) and
``Engine(mesh=)`` (each block's prefill logits within ``MESH_LOGIT_RTOL``
of the whole batch's, ``generate`` timed, its launches counted).

It imports nothing of the JAX package.  Any failed check raises, so the
script exits non-zero and prints no result line; it also fails when no
CUDA device is present or the port's sources are missing.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet), the denominators of bound_ms
from repro_torch.launch.mesh import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as PEAK_BF16_FLOPS  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as PEAK_F32_FLOPS  # noqa: E402

# launches of each kernel per fused batch on the sampling path
NFE = 10
K = 4

# tolerance of the flash kernel against its all-float32 plain version,
# |kernel - plain| <= FLASH_ATOL + FLASH_RTOL * |plain|: both outputs are
# rounded to bf16 (half an ulp each, together at most one ulp, 2^-7
# relative), and the kernel rounds P to bf16 before P.V (at most 2^-9
# relative a term, so at most 2^-9 * max|v| < 2^-6 for |v| < 8)
FLASH_ATOL = 2 ** -6
FLASH_RTOL = 2 ** -7
ERA_TOL = 1e-5
# the decode kernel against its plain version: both compute in float32 and
# round the output to bf16 once, so they differ by at most one bf16 ulp of
# |o| (2^-7 relative); near zero by the float32 difference of the sums
DECODE_RTOL = 2 ** -7
DECODE_ATOL = 1e-5

# deepseek-v2-lite's MLA attention: heads, q/k head dim (128 + 64 rope), v
MLA_H, MLA_HD, MLA_HD_V = 16, 192, 128
# hymba-1.5b's attention: heads, kv heads, head dim, window, meta tokens,
# and its AR prefill's length (the meta tokens, then the 512 prompt)
HY_H, HY_KV, HY_HD, HY_WINDOW, HY_META = 25, 5, 64, 1024, 128
HY_PREFILL = HY_META + 512
# paligemma-3b's Gemma attention: heads, kv heads, head dim, image patches,
# and its AR prefill's length (the patches, then the 512 prompt)
PG_H, PG_KV, PG_HD, PG_PATCHES = 8, 1, 256, 256
PG_PREFILL = PG_PATCHES + 512
# whisper-base's attention: heads (as many kv heads), head dim, and the
# encoder's frames (the cross-attention's keys)
WH_H, WH_HD, WH_FRAMES = 8, 64, 1500

# the AR path: batch, prompt, new tokens, cache slots (max_len)
AR_BATCH, AR_PROMPT, AR_GEN, AR_MAX_LEN = 8, 512, 64, 1024
AR_CHECK_STEPS = (1, 32, AR_GEN - 1)
# decode vs prefill logits, max |diff| <= AR_LOGIT_RTOL[family] * max
# |logit|: a smoke check of the whole path, not a kernel check, tuned by
# family on the H100, each between the served path's ratio and that of a
# planted fault the check must see.  Subtler faults are left to the kernel
# checks of phases 3 and 5, which hold the kernels to their plain versions
# at the path's shapes.
AR_LOGIT_RTOL = {
    # The two paths round to bf16 in different places at each of the 28
    # layers (GEMMs of 8 rows against 8 * S rows; the flash kernel rounds P
    # to bf16, the decode kernel keeps it in float32): 1.6-2.0% of the
    # logits' scale, against 6.3-8.8% with the newest prompt key dropped.
    "dense": 0.05,
    # MoE models (phase 10, routing pinned: PinnedMoE): the residual stream
    # carries the routed experts' ~1e2-scale outputs (the reference's
    # fan-in init divides the expert weights by the expert count), so the
    # rounding moves the logits further: 5.5-6.7% on full-width
    # deepseek-v2-lite, against 24% with the newest prompt entry dropped.
    "moe": 0.12,
    # xlstm-350m carries 512 steps of recurrent state through 24 layers:
    # the chunkwise prefill and the step-by-step decode round differently
    # at each step, 3.6-4.9%, against 112% with one mLSTM layer's memory
    # zeroed.
    "ssm": 0.10,
    # hymba-1.5b's paths differ by 2.4-2.7%; its planted fault overwrites
    # the K and V of all 128 protected (meta-token) slots with the newest
    # prompt entries', what a ring that did not protect them would hold.
    "hybrid": 0.05,
    # whisper-base's paths differ by 0.75-0.76%; one decoder layer's
    # cross-attention keys zeroed after the prefill moves the logits by
    # 2.9%.
    "audio": 0.015,
    # paligemma-3b's paths differ by 0.64-0.74%; the 256 image-patch
    # slots' K overwritten in every layer (with the newest prompt entries')
    # moves the logits by 9.0%.
    "vlm": 0.025,
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: era_update
# ---------------------------------------------------------------------------


def era_inputs(rows: int, n: int, k: int, cap: int, gen, i: int = 6):
    """Inputs of the ERA step at step ``i``: as ERS selects them, each row's
    bases are strictly increasing entries of [0, i] ending at ``i`` itself,
    and the corrector's history is entries (i, i-1, i-2)."""
    dev = "cuda"
    x = torch.randn(rows, n, generator=gen, device=dev)
    buf = torch.randn(cap, rows, n, generator=gen, device=dev)
    last = torch.full((1,), i, device=dev)
    tau = torch.stack([
        torch.cat([torch.sort(
            torch.randperm(i, generator=gen, device=dev)[: k - 1]).values, last])
        for _ in range(rows)
    ]).to(torch.int32)
    lag_w = torch.randn(rows, k, generator=gen, device=dev)
    cx = torch.rand(rows, generator=gen, device=dev) + 0.5
    ce = torch.randn(rows, generator=gen, device=dev) * 0.1
    return x, buf, tau, (i, i - 1, i - 2), lag_w, cx, ce


def era_bytes(x, tau, hist) -> float:
    """Bytes the step must move: x and each distinct buffer entry a row
    reads (its bases and history, which overlap) once, two outputs once."""
    n = x.shape[1]
    words = sum(1 + len(set(row) | set(hist)) + 2 for row in tau.tolist())
    return 4.0 * n * words


def is_era_kernel(name: str) -> bool:
    """A profiler row of the Triton ``era_update`` kernel."""
    return "era_kernel" in name


def phase_era(ku):
    from repro_torch.core.era import AM4

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    cases = {
        "main B=8 N=256*1536": (8, 256 * 1536),
        "ragged B=3 N=1000": (3, 1000),
        "shared one row N=8*256*1536": (1, 8 * 256 * 1536),
        # phase 11's rows: hymba-1.5b's and xlstm-350m's 8x256 batches
        "hymba B=8 N=256*1600": (8, 256 * 1600),
        "xlstm B=8 N=256*1024": (8, 256 * 1024),
        # phase 12's rows: whisper-base's and paligemma-3b's 8x256 batches
        "whisper B=8 N=256*512": (8, 256 * 512),
        "paligemma B=8 N=256*2048": (8, 256 * 2048),
    }
    timing = None
    for name, (rows, n) in cases.items():
        x, buf, tau, hist, lag_w, cx, ce = era_inputs(rows, n, K, NFE + 1, gen)
        got = ku.era_update(x, buf, tau, hist, lag_w, AM4, cx, ce)
        want = ku.era_update_plain(x, buf, tau, hist, lag_w, AM4, cx, ce)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        errs[name] = err
        log(f"era_update {name}: max_abs_err {err:.3e}")
        check(err <= ERA_TOL, f"era_update {name} error {err} > {ERA_TOL}")
        if timing is None:
            args = (x, buf, tau, hist, lag_w, AM4, cx, ce)
            nbytes = era_bytes(x, tau, hist)
            # predictor 2k, corrector 7, DDIM update 3 flops an element
            flops = float(rows * n * (2 * K + 10))
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            # profiler device time, L2-warm and L2-cold (only the kernel's
            # rows); CUDA events around back-to-back calls give the
            # wrapper's cost, host included
            timing = dict(
                ms=device_ms(lambda: ku.era_update(*args)),
                ms_l2_cold=device_ms(lambda: ku.era_update(*args), cold=True,
                                     pick=is_era_kernel),
                wrapper_ms=time_ms(lambda: ku.era_update(*args)),
                plain_ms=device_ms(lambda: ku.era_update_plain(*args), iters=5),
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, shape=f"B={rows} N={n} k={K}")
            log(f"era_update bound: {nbytes / (rows * n * 4):.2f} float32 "
                f"words an element, {bound_ms:.5f} ms")
            log(f"era_update timing {timing['shape']}: kernel {timing['ms']:.5f} "
                f"ms L2-warm, {timing['ms_l2_cold']:.5f} ms L2-cold (profiler "
                f"device time); a wrapper call {timing['wrapper_ms']:.5f} ms "
                f"(CUDA events, host included); plain {timing['plain_ms']:.5f} "
                f"ms; kernel / bound {timing['ms'] / bound_ms:.3f} warm, "
                f"{timing['ms_l2_cold'] / bound_ms:.3f} cold")
    # the step-masked step: half the rows spent; theirs must come back as x,
    # bitwise, with eps_bar zero, and the live rows as without the mask
    for shape, (rows, n) in (("main", (8, 256 * 1536)),
                             ("hymba", (8, 256 * 1600)),
                             ("paligemma", (8, 256 * 2048))):
        x, buf, tau, hist, lag_w, cx, ce = era_inputs(rows, n, K, NFE + 1, gen)
        active = torch.tensor([1, 0] * (rows // 2), dtype=torch.int32,
                              device="cuda")
        got = ku.era_update(x, buf, tau, hist, lag_w, AM4, cx, ce, active=active)
        want = ku.era_update_plain(x, buf, tau, hist, lag_w, AM4, cx, ce, active)
        torch.cuda.synchronize()
        live, spent = active.bool(), ~active.bool()
        name = f"active {shape} B=8 N={n}, 4 rows spent"
        check(torch.equal(got[0][spent], x[spent]),
              f"era_update {name}: spent x moved")
        check(bool((got[1][spent] == 0).all()),
              f"era_update {name}: spent eps_bar not 0")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        errs[name] = err
        log(f"era_update {name}: max_abs_err {err:.3e}, spent rows bitwise x, "
            f"eps_bar 0")
        check(err <= ERA_TOL, f"era_update {name} error {err} > {ERA_TOL}")
        same = torch.equal(got[0][live], ku.era_update(
            x, buf, tau, hist, lag_w, AM4, cx, ce)[0][live])
        log(f"era_update {name}: live rows bitwise equal to the unmasked "
            f"kernel's: {same}")
    return errs, timing


# ---------------------------------------------------------------------------
# phase 3: flash_attention
# ---------------------------------------------------------------------------


def fused_kv_mask(dev):
    """Phases 11 and 12's fused seq-256 batch: row lengths 200 x4, 256 x4."""
    lens = torch.tensor([200] * 4 + [256] * 4, device=dev)
    return (torch.arange(256, device=dev)[None, :] < lens[:, None]).to(torch.int32)


def hymba_ring(dev):
    """A 1024-slot hymba ring after its ring part wrapped: slots 0-127 hold
    the meta positions 0-127, slots 128-1023 positions 2105-3000 rotated as
    ``protected + (pos - protected) % 896`` places them."""
    pos = torch.arange(HY_META, dtype=torch.int32, device=dev)
    ring = torch.arange(2105, 3001, dtype=torch.int32, device=dev)
    slots = HY_META + (ring - HY_META) % (AR_MAX_LEN - HY_META)
    out = torch.empty(AR_MAX_LEN, dtype=torch.int32, device=dev)
    out[:HY_META] = pos
    out[slots.long()] = ring
    return out


def flash_cases(kf) -> float:
    """Hold the kernel against its plain version in every case; return the
    largest error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    h, kvh, hd = 12, 2, 128

    def run(name, b, s, h, kvh, hd, *, hd_v=None, sk=None, q_pos=None,
            kv_pos=None, zero_row=None, **kw):
        sk = s if sk is None else sk
        hd_v = hd if hd_v is None else hd_v
        q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, sk, kvh, hd, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, sk, kvh, hd_v, generator=gen, device=dev).to(torch.bfloat16)
        if q_pos is None:
            q_pos = torch.arange(s, dtype=torch.int32, device=dev)
        if kv_pos is None:
            kv_pos = torch.arange(sk, dtype=torch.int32, device=dev)
        got = kf.flash_attention(q, k, v, q_pos, kv_pos, **kw)
        want = kf.flash_attention_plain(q, k, v, q_pos, kv_pos, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"flash {name}: non-finite")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - FLASH_RTOL * want.float().abs()).max())
        log(f"flash_attention {name}: max_abs_err {err:.3e}")
        check(excess <= FLASH_ATOL,
              f"flash {name} error {err} beyond {FLASH_ATOL} + {FLASH_RTOL}*|o|")
        if zero_row is not None:
            # the row whose every key is masked must come out exactly zero
            check(bool((got[zero_row] == 0).all()),
                  f"flash {name}: masked row not zero")
        return err

    b, s = 8, 256
    pos = torch.arange(s, device=dev)
    lengths = torch.tensor([s, s // 2, 1, 0] + [s] * (b - 4), device=dev)
    padded = (pos[None, :] < lengths[:, None]).to(torch.int32)
    # whole 64-key tiles masked in some rows and not in others; row 3 has
    # every tile masked
    dead_tiles = [(), (0,), (1, 2), (0, 1, 2, 3), (3,), (0, 2), (1,), (0, 1, 3)]
    tiles = (pos // 64)[None, :]
    tile_mask = torch.stack([
        ~torch.isin(tiles[0], torch.tensor(d, device=dev, dtype=torch.long))
        for d in dead_tiles
    ]).to(torch.int32)
    # a wrapped ring: slot j holds position (j - 200) mod 512, slots 64-127
    # are empty; an index-driven causal or window skip would drop live tiles
    ring = torch.roll(torch.arange(512, dtype=torch.int32, device=dev), 200)
    ring[64:128] = -1
    # the bucketed drain's two batches (phase 7): kv_mask from per-row
    # lengths, as the attention layer builds it
    seq_masks = {
        sq: (torch.arange(sq, device=dev)[None, :]
             < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        for sq, lens in ((256, [256, 200, 200, 200, 256, 256, 256, 256]),
                         (128, [100] * 4 + [128] * 4))
    }
    seq_masks["mla"] = (
        torch.arange(256, device=dev)[None, :]
        < torch.tensor([200] * 3 + [256] * 5, device=dev)[:, None]
    ).to(torch.int32)
    ps = AR_PROMPT
    errs = [
        run("seq bucket 8x256, row lengths 256, 200 x3, 256 x4 (phase 7)",
            b, 256, h, kvh, hd, causal=False, kv_mask=seq_masks[256]),
        run("seq bucket 8x128, row lengths 100 x4, 128 x4 (phase 7)",
            b, 128, h, kvh, hd, causal=False, kv_mask=seq_masks[128]),
        run(f"qwen2 B={b} S={s} H={h} KV={kvh} hd={hd} non-causal",
            b, s, h, kvh, hd, causal=False),
        run(f"qwen2 B={b} S=128 non-causal (ERA seq-128 batch)",
            b, 128, h, kvh, hd, causal=False),
        # the AR path's prefill: causal over the 512-token prompt, no window
        run(f"AR prefill B={AR_BATCH} S={ps} H={h} KV={kvh} hd={hd} causal",
            AR_BATCH, ps, h, kvh, hd, causal=True),
        run("kv_mask padded rows + fully masked row", b, s, h, kvh, hd,
            causal=False, kv_mask=padded, zero_row=3),
        run("kv_mask whole 64-key tiles per row + fully masked row",
            b, s, h, kvh, hd, causal=False, kv_mask=tile_mask, zero_row=3),
        run("q_pos = arange(312, 512), Sq=200 < Sk=512, causal",
            b, 200, h, kvh, hd, sk=512, causal=True,
            q_pos=torch.arange(312, 512, dtype=torch.int32, device=dev)),
        run("ring kv_pos (rolled by 200, slots 64-127 empty), "
            "causal+window=96+protected=4",
            b, 512, h, kvh, hd, kv_pos=ring, causal=True, window=96,
            protected=4),
        run("causal+window=48+protected=4", b, s, h, kvh, hd,
            causal=True, window=48, protected=4),
        run("softcap=30", b, s, h, kvh, hd, causal=False, softcap=30.0),
        run("S=200 (ragged tile)", 2, 200, h, kvh, hd, causal=False),
        run("hd=64 (llama3.2-1b heads)", 2, 256, 32, 8, 64, causal=False),
        run("hd=32 (smoke heads)", 2, 96, 4, 2, 32, causal=True),
        # hymba-1.5b (H=25, KV=5, hd 64): phase 11's denoiser batch
        # (non-causal, its swa window, row lengths 200 x4, 256 x4) and its
        # AR prefill (128 meta positions protected, then the 512 prompt)
        run("hymba 8x256 non-causal window=1024, row lengths 200 x4, 256 x4 "
            "(phase 11)", 8, 256, HY_H, HY_KV, HY_HD, causal=False,
            window=HY_WINDOW, kv_mask=fused_kv_mask(dev)),
        run(f"hymba AR prefill {AR_BATCH}x{HY_PREFILL} causal window=1024 "
            f"protected={HY_META}", AR_BATCH, HY_PREFILL, HY_H, HY_KV, HY_HD,
            causal=True, window=HY_WINDOW, protected=HY_META),
        run("hymba causal window=200 protected=128 (the window bites)",
            2, HY_PREFILL, HY_H, HY_KV, HY_HD, causal=True, window=200,
            protected=HY_META),
    ]
    if (MLA_HD, MLA_HD_V) in getattr(kf, "HEAD_DIM_PAIRS", ()):
        # deepseek-v2-lite's MLA: q/k 128 + 64 rope dims, v 128, 16 heads
        # with one kv head each; always causal (phase 10's 8x256 batch with
        # its per-row lengths, its 8x512 AR prefill, a ragged S)
        mla = dict(hd_v=MLA_HD_V, causal=True)
        errs += [
            run("MLA 8x256 causal, row lengths 200 x3, 256 x5 (phase 10)",
                8, 256, MLA_H, MLA_H, MLA_HD, kv_mask=seq_masks["mla"], **mla),
            run(f"MLA AR prefill {AR_BATCH}x{ps} causal", AR_BATCH, ps, MLA_H,
                MLA_H, MLA_HD, **mla),
            run("MLA S=200 (ragged tile) causal", 2, 200, MLA_H, MLA_H,
                MLA_HD, **mla),
        ]
        # a CUDA tensor of a pair without an instance raises
        refuses_head_dims(kf, MLA_HD, 64)
    if (PG_HD, PG_HD) in getattr(kf, "HEAD_DIM_PAIRS", ()):
        # paligemma-3b's Gemma heads (H=8 over one kv head of 256): phase
        # 12's 8x256 denoiser batch (non-causal, row lengths 200 x4, 256
        # x4), its causal 8x768 AR prefill (256 patches, then the prompt),
        # a ragged S
        errs += [
            run("paligemma 8x256 non-causal, row lengths 200 x4, 256 x4 "
                "(phase 12)", 8, 256, PG_H, PG_KV, PG_HD, causal=False,
                kv_mask=fused_kv_mask(dev)),
            run(f"paligemma AR prefill {AR_BATCH}x{PG_PREFILL} causal",
                AR_BATCH, PG_PREFILL, PG_H, PG_KV, PG_HD, causal=True),
            run("paligemma S=200 (ragged tile) non-causal, hd 256", 2, 200,
                PG_H, PG_KV, PG_HD, causal=False),
        ]
        refuses_head_dims(kf, PG_HD, 128)
        # whisper-base (H = KV = 8, hd 64): phase 12's 8x256 decoder batch
        # (its self-attention is causal, with row lengths), the encoder's
        # 8x1500 (non-causal), the cross-attention prefill (512 queries at
        # position 0 over the 1500 encoder keys, non-causal)
        errs += [
            run("whisper 8x256 causal, row lengths 200 x4, 256 x4 (phase 12)",
                8, 256, WH_H, WH_H, WH_HD, causal=True,
                kv_mask=fused_kv_mask(dev)),
            run(f"whisper encoder {AR_BATCH}x{WH_FRAMES} non-causal", AR_BATCH,
                WH_FRAMES, WH_H, WH_H, WH_HD, causal=False),
            run(f"whisper cross prefill {AR_BATCH}x{AR_PROMPT} over "
                f"{WH_FRAMES} keys, queries at 0, non-causal", AR_BATCH,
                AR_PROMPT, WH_H, WH_H, WH_HD, sk=WH_FRAMES, causal=False,
                q_pos=torch.zeros(AR_PROMPT, dtype=torch.int32, device=dev)),
        ]
    # the TMA edges at every pair: Sq not a multiple of the 64-row query
    # tile and Sk not a multiple of any key tile (32, 64 or 128), so the
    # last tiles of Q, K and V read rows past their batch row's end as
    # zeros; queries offset from keys under a causal mask, and a
    # non-causal batch with a row whose every key is masked
    for d, dv in getattr(kf, "HEAD_DIM_PAIRS", ()):
        edge = torch.ones(3, 93, dtype=torch.int32, device=dev)
        edge[1] = 0
        edge[2, 40:] = 0
        errs += [
            run(f"({d}, {dv}) Sq=100 over Sk=157, queries at 57-156, causal",
                2, 100, 4, 2, d, hd_v=dv, sk=157, causal=True,
                q_pos=torch.arange(57, 157, dtype=torch.int32, device=dev)),
            run(f"({d}, {dv}) Sq=37 over Sk=93 non-causal, row 1 fully masked",
                3, 37, 4, 1, d, hd_v=dv, sk=93, causal=False, kv_mask=edge,
                zero_row=1),
        ]
    # more kv tiles than the forward's flags hold at once (a chunk of 1,024
    # tiles of 32 or 64 keys): its producer marks the later chunks as it
    # reaches them, with live, dead and full tiles on both sides of a chunk
    # boundary, and a dead run that crosses one
    pairs = getattr(kf, "HEAD_DIM_PAIRS", ())
    if (PG_HD, PG_HD) in pairs:
        far = torch.arange(80_000, dtype=torch.int32, device=dev)
        far[66_000:70_000] = -1
        far_mask = torch.ones(1, 80_000, dtype=torch.int32, device=dev)
        far_mask[0, 1_000:1_500] = 0
        errs.append(run(
            "(256, 256) Sq=100 over Sk=80,000 causal, queries at 75,000-75,099, "
            "keys 66,000-69,999 empty, kv_mask holes", 1, 100, 2, 1, PG_HD,
            sk=80_000, causal=True, kv_pos=far, kv_mask=far_mask,
            q_pos=torch.arange(75_000, 75_100, dtype=torch.int32, device=dev)))
    if (128, 128) in pairs:
        errs.append(run(
            "(128, 128) Sq=70 over Sk=40,000 causal, window=1024, protected=128, "
            "queries at 38,000-38,069", 2, 70, 4, 2, 128, sk=40_000, causal=True,
            window=1024, protected=128,
            q_pos=torch.arange(38_000, 38_070, dtype=torch.int32, device=dev)))
    if (64, 64) in pairs:
        errs.append(run("(64, 64) Sq=64 over Sk=70,000 non-causal", 1, 64, 2, 2,
                        64, sk=70_000, causal=False))
    flash_lse_cases(kf)
    return max(errs)


def flash_lse_cases(kf) -> None:
    """At every pair: the training (``LSE``) launch's output bitwise the
    serving launch's, its log-sum-exp within ``LSE_ATOL`` of the float32
    logsumexp (+inf exactly on the rows with no valid key), and two serving
    launches bitwise equal; on a ragged Sq and Sk with a fully masked row,
    causal with queries offset from keys, then with a softcap."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    worst = 0.0
    for d, dv in getattr(kf, "HEAD_DIM_PAIRS", ()):
        b, sq, sk, h, kvh = 3, 100, 157, 4, 2
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, sk, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, sk, kvh, dv, generator=gen, device=dev).to(torch.bfloat16)
        q_pos = torch.arange(sk - sq, sk, dtype=torch.int32, device=dev)
        kv_pos = torch.arange(sk, dtype=torch.int32, device=dev)
        kv_mask = torch.ones(b, sk, dtype=torch.int32, device=dev)
        kv_mask[1] = 0
        for softcap in (0.0, 30.0):
            opts = dict(kv_mask=kv_mask, window=0, causal=True, softcap=softcap,
                        protected=0)
            name = f"({d}, {dv})" + (f" softcap={softcap:g}" if softcap else "")
            serve = [kf._forward(q, k, v, q_pos, kv_pos, **opts)[0] for _ in range(2)]
            out, lse = kf._forward(q, k, v, q_pos, kv_pos, **opts, with_lse=True)
            torch.cuda.synchronize()
            check(torch.equal(serve[0], serve[1]),
                  f"flash {name}: two serving launches differ")
            check(torch.equal(out, serve[0]), f"flash {name}: the LSE launch's "
                  "output is not bitwise the serving launch's")
            want = lse_plain(kf, q, k, q_pos, kv_pos, **opts)
            empty = torch.isinf(want)
            check(torch.equal(torch.isinf(lse), empty) and bool((lse[empty] > 0).all()),
                  f"flash {name}: lse is not +inf exactly on the empty rows")
            err = float((lse[~empty] - want[~empty]).abs().max())
            check(err <= LSE_ATOL, f"flash {name}: lse error {err:.3e} over {LSE_ATOL}")
            check(bool((serve[0][1] == 0).all()), f"flash {name}: masked row not zero")
            worst = max(worst, err)
    log(f"flash_attention LSE instances: output bitwise the serving launch's, "
        f"two launches bitwise equal, lse error {worst:.3e} (tolerance "
        f"{LSE_ATOL:.3e}) at every pair")


def refuses_head_dims(kf, hd: int, hd_v: int) -> None:
    """A CUDA call at head dims (``hd``, ``hd_v``), a pair without an
    instance, must raise, not fall back."""
    q = torch.zeros(1, 64, 2, hd, dtype=torch.bfloat16, device="cuda")
    v = torch.zeros(1, 64, 2, hd_v, dtype=torch.bfloat16, device="cuda")
    p64 = torch.arange(64, dtype=torch.int32, device="cuda")
    try:
        kf.flash_attention(q, q, v, p64, p64)
        raised = False
    except ValueError:
        raised = True
    check(raised, f"flash_attention took the head dims ({hd}, {hd_v})")
    log(f"flash_attention: head dims ({hd}, {hd_v}) on the card raise")


def is_flash_kernel(name: str) -> bool:
    return "flash_fwd_kernel" in name


def flash_timings(kf) -> dict:
    """Device time of the kernel, its plain version and one SDPA call at
    the three shapes the main paths run: ERA 8x256 and 8x128 (non-causal),
    AR prefill 8x512 (causal)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device="cuda").manual_seed(4)
    h, kvh, hd = 12, 2, 128
    g = h // kvh

    def library(q, k, v, causal):
        """One SDPA call on the same tensors: K/V as (B, KV, S, hd) views,
        the G query heads of a kv head folded into the query axis when no
        causal mask ties a query to its position, else ``enable_gqa``
        (SDPA's flash backend forced, so no K/V copy is made)."""
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if not causal:
            bb, ss = q.shape[:2]
            qf = q.reshape(bb, ss, kvh, g, hd).permute(0, 2, 3, 1, 4)
            qf = qf.reshape(bb, kvh, g * ss, hd)
            return lambda: F.scaled_dot_product_attention(qf, kt, vt)
        qt = q.transpose(1, 2)

        def call():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        return call

    def timed(bb, ss, causal):
        """The profiler's device time, since host time can exceed a short
        call's device time and CUDA events would then time the host."""
        q, k, v = (torch.randn(bb, ss, n, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        pos = torch.arange(ss, dtype=torch.int32, device="cuda")

        def kernel():
            return kf.flash_attention(q, k, v, pos, pos, causal=causal)
        ms = device_ms(kernel, pick=is_flash_kernel, kernels=1)
        ms_l2_cold = device_ms(kernel, cold=True, pick=is_flash_kernel, kernels=1)
        plain_ms = device_ms(
            lambda: kf.flash_attention_plain(q, k, v, pos, pos, causal=causal),
            iters=5,
        )
        library_ms = device_ms(library(q, k, v, causal))
        library_ms_l2_cold = device_ms(library(q, k, v, causal), cold=True)
        # a causal mask leaves (S + 1) / 2S of the scores to compute
        frac = (ss + 1) / (2 * ss) if causal else 1.0
        flops = 4.0 * bb * h * ss * ss * hd * frac
        nbytes = 2.0 * (2 * bb * ss * h * hd + 2 * bb * ss * kvh * hd)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        t = dict(
            ms=ms, ms_l2_cold=ms_l2_cold, plain_ms=plain_ms,
            library_ms=library_ms, library_ms_l2_cold=library_ms_l2_cold,
            kernel_over_library=ms / library_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape=f"B={bb} S={ss} H={h} KV={kvh} hd={hd} bf16"
                  + (" causal" if causal else ""),
        )
        log(f"flash_attention timing {t['shape']}: kernel {ms:.5f} ms L2-warm, "
            f"{ms_l2_cold:.5f} ms L2-cold; plain {plain_ms:.5f} ms; SDPA "
            f"{library_ms:.5f} / {library_ms_l2_cold:.5f} ms; "
            f"kernel_over_library {t['kernel_over_library']:.3f}; "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
        return t

    def timed_lse(bb, ss, causal):
        """The training (LSE) launch at qwen2's training shape beside the
        serving launch on the same inputs, L2-warm and L2-cold."""
        q, k, v = (torch.randn(bb, ss, n, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        pos = torch.arange(ss, dtype=torch.int32, device="cuda")
        opts = dict(kv_mask=None, window=0, causal=causal, softcap=0.0, protected=0)

        def train():
            return kf._forward(q, k, v, pos, pos, **opts, with_lse=True)

        def serve():
            return kf._forward(q, k, v, pos, pos, **opts)
        t = dict(
            ms=device_ms(train, pick=is_flash_kernel, kernels=1),
            ms_l2_cold=device_ms(train, cold=True, pick=is_flash_kernel, kernels=1),
            serving_ms=device_ms(serve, pick=is_flash_kernel, kernels=1),
            serving_ms_l2_cold=device_ms(serve, cold=True, pick=is_flash_kernel,
                                         kernels=1),
            shape=f"B={bb} S={ss} H={h} KV={kvh} hd={hd} bf16"
                  + (" causal" if causal else "") + ", with lse",
        )
        log(f"flash_attention timing (training, LSE) {t['shape']}: "
            f"{t['ms']:.5f} ms L2-warm, {t['ms_l2_cold']:.5f} ms L2-cold; the "
            f"serving launch {t['serving_ms']:.5f} / {t['serving_ms_l2_cold']:.5f} ms")
        return t

    timing = timed(8, 256, causal=False)
    timing["era_seq128"] = timed(8, 128, causal=False)
    timing["prefill"] = timed(AR_BATCH, AR_PROMPT, causal=True)
    timing["lse"] = {"diffusion": timed_lse(TRAIN_BATCH, TRAIN_SEQ, False),
                     "lm": timed_lse(TRAIN_BATCH, TRAIN_SEQ, True)}
    timing["hymba"] = hymba_flash_timings(kf)
    timing.update(audio_vlm_flash_timings(kf))
    return timing


def audio_vlm_flash_timings(kf) -> dict:
    """The flash kernel at phase 12's shapes: paligemma's (256, 256)
    instance at its 8x256 denoiser batch (non-causal, row lengths 200 x4,
    256 x4) and its causal 8x768 AR prefill; whisper's (64, 64) at its
    encoder's 8x1500 (non-causal) and its cross-attention prefill (512
    queries over 1500 keys, non-causal).  Each L2-warm and L2-cold, beside
    its plain version and one SDPA call on the same inputs (warm and cold;
    SDPA's own backend choice, the row lengths as a boolean mask built
    outside the timed call), and the bound (the pairs these inputs keep)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(10)
    dev = "cuda"
    out = {}
    cases = (
        ("paligemma_era", 8, 256, 256, PG_H, PG_KV, PG_HD, "lengths"),
        ("paligemma_prefill", AR_BATCH, PG_PREFILL, PG_PREFILL, PG_H, PG_KV,
         PG_HD, "causal"),
        ("whisper_encoder", AR_BATCH, WH_FRAMES, WH_FRAMES, WH_H, WH_H, WH_HD,
         "full"),
        ("whisper_cross", AR_BATCH, AR_PROMPT, WH_FRAMES, WH_H, WH_H, WH_HD,
         "full"),
    )
    for name, b, sq, sk, h, kvh, hd, mask in cases:
        g = h // kvh
        q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, sk, kvh, hd, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        q_pos = (torch.zeros(sq, dtype=torch.int32, device=dev) if sq != sk
                 else torch.arange(sq, dtype=torch.int32, device=dev))
        kv_pos = torch.arange(sk, dtype=torch.int32, device=dev)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if mask == "lengths":
            km = fused_kv_mask(dev)
            kw = dict(causal=False, kv_mask=km)
            qf = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(
                b, kvh, g * sq, hd)
            am = km.bool()[:, None, None, :]

            def sdpa(qf=qf, kt=kt, vt=vt, am=am):
                return F.scaled_dot_product_attention(qf, kt, vt, attn_mask=am)
            pairs = float(sq * km.sum())
        elif mask == "causal":
            kw = dict(causal=True)
            qt = q.transpose(1, 2)

            def sdpa(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            pairs = float(b * sq * (sq + 1) / 2)
        else:
            kw = dict(causal=False)
            qt = q.transpose(1, 2)

            def sdpa(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(qt, kt, vt)
            pairs = float(b * sq * sk)

        def kernel(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, kw=kw):
            return kf.flash_attention(q, k, v, q_pos, kv_pos, **kw)
        flops = 4.0 * h * hd * pairs
        nbytes = 2.0 * (2 * b * sq * h * hd + 2 * b * sk * kvh * hd)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        t = dict(
            ms=device_ms(kernel, pick=is_flash_kernel, kernels=1),
            ms_l2_cold=device_ms(kernel, cold=True, pick=is_flash_kernel,
                                 kernels=1),
            plain_ms=device_ms(lambda: kf.flash_attention_plain(
                q, k, v, q_pos, kv_pos, **kw), iters=3),
            library_ms=device_ms(sdpa),
            library_ms_l2_cold=device_ms(sdpa, cold=True),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape=f"B={b} Sq={sq} Sk={sk} H={h} KV={kvh} hd={hd} bf16 {mask}",
        )
        t["kernel_over_library"] = t["ms"] / t["library_ms"]
        log(f"flash_attention timing ({name}) {t['shape']}: kernel "
            f"{t['ms']:.5f} ms L2-warm, {t['ms_l2_cold']:.5f} ms L2-cold; plain "
            f"{t['plain_ms']:.5f} ms; SDPA {t['library_ms']:.5f} / "
            f"{t['library_ms_l2_cold']:.5f} ms; kernel_over_library "
            f"{t['kernel_over_library']:.3f}; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}, {nbytes / 1e6:.1f} MB, {flops:.3e} FLOP)")
        out[name] = t
    return out


def mla_flash_timings(kf) -> dict:
    """The (192, 128) instance at phase 10's 8x256 causal batch: device
    time L2-warm and L2-cold, its plain version and one SDPA call (its
    default backend choice: q/k and v head dims differ), and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    b, s, h = 8, 256, MLA_H
    q, k = (torch.randn(b, s, h, MLA_HD, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn(b, s, h, MLA_HD_V, generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kernel():
        return kf.flash_attention(q, k, v, pos, pos, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    # each of q, k, v read once and the output written once, bf16; the
    # causal half of 2 * (hd + hd_v) flops a (query, key, head)
    nbytes = 2.0 * (2 * b * s * h * MLA_HD + 2 * b * s * h * MLA_HD_V)
    flops = 2.0 * b * h * s * s * (MLA_HD + MLA_HD_V) * (s + 1) / (2 * s)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    t = dict(
        ms=device_ms(kernel, pick=is_flash_kernel, kernels=1),
        ms_l2_cold=device_ms(kernel, cold=True, pick=is_flash_kernel, kernels=1),
        plain_ms=device_ms(lambda: kf.flash_attention_plain(q, k, v, pos, pos),
                           iters=5),
        library_ms=device_ms(sdpa), library_ms_l2_cold=device_ms(sdpa, cold=True),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        shape=f"B={b} S={s} H={h} KV={h} hd={MLA_HD} hd_v={MLA_HD_V} bf16 causal",
    )
    t["kernel_over_library"] = t["ms"] / t["library_ms"]
    log(f"flash_attention timing {t['shape']}: kernel {t['ms']:.5f} ms "
        f"L2-warm, {t['ms_l2_cold']:.5f} ms L2-cold; plain {t['plain_ms']:.5f} "
        f"ms; SDPA {t['library_ms']:.5f} / {t['library_ms_l2_cold']:.5f} ms; "
        f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return t


def ptxas_start(build, source: str):
    """Start a second ``nvcc`` of ``source`` with ``-Xptxas -v`` (beside the
    build, into a file that is thrown away) for its register and spill
    report."""
    out = build.BUILD_DIR / f"ptxas-{Path(source).stem}.{os.getpid()}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [*build.compile_command(source, out), "-Xptxas", "-v"]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def parse_ptxas(text: str, kernel: str = "flash_fwd_kernel",
                lse: bool = False) -> dict:
    """{hd: {registers, spill_stores, spill_loads}} of each instance of
    ``kernel`` in ``nvcc -Xptxas -v`` output; of the flash forward, the
    serving instances, or with ``lse`` the training ones (the template's
    bool, mangled ``Lb0E`` / ``Lb1E``)."""
    import re

    report, hd = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            hd = re.search(rf"{kernel}ILi(\d+)E", name)
            hd = int(hd.group(1)) if hd else None
            if hd is not None and "Lb" in name and ("Lb1E" in name) != lse:
                hd = None
            continue
        if hd is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report.setdefault(hd, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(hd, {})["registers"] = int(m.group(1))
    return report


def ptxas_report(started, kf) -> dict:
    """Each flash instance's registers, spills, shared memory and resident
    blocks an SM (:func:`flash_ptxas` of the build started by
    :func:`ptxas_start`); fails on a spill at any of the ten instances."""
    out, proc = started
    text, _ = proc.communicate()
    out.unlink(missing_ok=True)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
    report = flash_ptxas(text, kf._library(), kf.HEAD_DIM_PAIRS)
    for key, r in report.items():
        if key != "warnings":
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                  f"flash_attention {key} spills registers")
    return report


def flash_ptxas(text: str, lib, pairs) -> dict:
    """Each flash instance's registers and spills from ``nvcc -Xptxas -v``
    output ``text``, keyed "hd x hd_v" (serving) and "hd x hd_v lse"
    (training), with the serving instance's shared memory and resident
    blocks an SM at Sk = 256 from ``lib``'s C entry points; ptxas's
    warnings of wgmma serialisation (a product waiting on the one before
    it) are kept under "warnings"."""
    import ctypes

    smem_fn = lib.repro_flash_attention_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 3
    smem_fn.restype = ctypes.c_longlong
    occ_fn = lib.repro_flash_attention_blocks_per_sm
    occ_fn.argtypes = [ctypes.c_int] * 3
    occ_fn.restype = ctypes.c_int
    # instances are named by their first template argument, the q/k head
    # dim, which tells the pairs apart
    serving, training = parse_ptxas(text), parse_ptxas(text, lse=True)
    out = {}
    for d, dv in pairs:
        for key, rep in ((f"{d}x{dv}", serving), (f"{d}x{dv} lse", training)):
            check(d in rep and "registers" in rep[d],
                  f"no ptxas report for flash {key}:\n{text}")
            r = out[key] = dict(rep[d])
            r["smem_bytes_s256"] = int(smem_fn(d, dv, 256))
            r["blocks_per_sm_s256"] = int(occ_fn(d, dv, 256))
            log(f"flash_attention {key}: {r['registers']} registers, spill "
                f"stores {r['spill_stores']} B, loads {r['spill_loads']} B, "
                f"{r['smem_bytes_s256']} B shared memory at Sk=256, "
                f"{r['blocks_per_sm_s256']} blocks an SM")
    warnings = [line.strip() for line in text.splitlines()
                if "flash_fwd_kernel" in line and "Performance" in line]
    for line in warnings:
        log(f"flash_attention ptxas: {line}")
    out["warnings"] = warnings
    return out


def decode_ptxas_report(text: str, kd, lib=None) -> dict:
    """Each decode instance's registers and spills (from ``-Xptxas -v``
    output ``text``), its shared memory and resident blocks an SM at the AR
    path's plan (B=8, KV=2, G=6, 1024 slots), and that plan's cluster."""
    lib = kd._library() if lib is None else lib
    cluster, stages = kd.split_plan(AR_BATCH, 2, AR_MAX_LEN, 6)
    report = parse_ptxas(text, "decode_attention_kernel")
    tiles = -(-AR_MAX_LEN // kd.TILE)
    for d in kd.HEAD_DIMS:
        check(d in report and "registers" in report[d],
              f"no ptxas report for decode hd={d}:\n{text}")
        r = report[d]
        r["smem_bytes_ar"] = int(lib.repro_decode_attention_smem_bytes(
            d, stages, -(-tiles // cluster), cluster))
        r["blocks_per_sm_ar"] = int(lib.repro_decode_attention_blocks_per_sm(
            d, r["smem_bytes_ar"]))
        log(f"decode_attention hd={d}: {r['registers']} registers, spill "
            f"stores {r['spill_stores']} B, loads {r['spill_loads']} B, "
            f"{r['smem_bytes_ar']} B shared memory and {r['blocks_per_sm_ar']} "
            f"blocks an SM at the AR plan")
    log(f"decode_attention AR plan: cluster {cluster} blocks, {stages} ring "
        f"stages a warp, {AR_BATCH * 2 * cluster} blocks")
    out = {str(k): v for k, v in sorted(report.items())}
    out["cluster_ar"], out["stages_ar"] = cluster, stages
    return out


# ---------------------------------------------------------------------------
# phase 4: the sampling slice
# ---------------------------------------------------------------------------


def gemm_kernels(kg) -> int:
    """gemm.cu's kernels: the bf16 kernel at each (BN, stages) pair with
    both loaders, unbatched and batched; the float32 tiled kernel at both
    load widths, unbatched and batched; the dot kernels (a warp or a thread
    a row) at both load widths; the split sums in bf16 and float32,
    unbatched and batched."""
    return 4 * len(kg.BF16_INSTANCES) + 4 + 4 + 4


def gemm_ptxas_report(text: str, kernels: int) -> dict:
    """{instance: {registers, spill_stores, spill_loads}} of every kernel of
    ``gemm.cu`` in ``nvcc -Xptxas -v`` output (an instance is the kernel's
    name and its mangled template arguments), and ptxas's warnings (a wgmma
    it serialised); fails on a spill."""
    import re

    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(gemm_\w+?_kernel)I(.+?)EEv", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(name, {})["registers"] = int(m.group(1))
    check(len(report) == kernels, f"gemm.cu's ptxas report has {sorted(report)}")
    for inst, r in report.items():
        check(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0,
              f"gemm {inst} spills: {r}")
    report["warnings"] = [l.strip() for l in text.splitlines()
                          if "warning" in l.lower()]
    log(f"gemm.cu ptxas: {report}")
    return report


#: the kernels whose launches every path reads (:func:`read_counts`): the
#: three TPU kernels' ports and the row-invariant GEMM (``gemm``, ``bgemm``)
COUNTED = ("era_update", "flash_attention", "decode_attention", "gemm", "bgemm")


def reset_counts(*wrappers) -> None:
    """Zero the wrappers' counts, and the GEMM's (``gemm``, ``bgemm``)."""
    from repro_torch.kernels import gemm as kg

    for counted in (*wrappers, kg.gemm, kg.bgemm):
        counted.launches = 0


def read_counts(ku, kf, kd) -> dict:
    """The :data:`COUNTED` kernels' launches since :func:`reset_counts`."""
    from repro_torch.kernels import gemm as kg

    return {"era_update": ku.era_update.launches,
            "flash_attention": kf.flash_attention.launches,
            "decode_attention": kd.decode_attention.launches,
            "gemm": kg.gemm.launches, "bgemm": kg.bgemm.launches}


def launches_are(launches: dict, want: dict) -> bool:
    """Each kernel ``want`` names launched exactly as often as it says; the
    GEMM's counts, which follow the model's products, are read beside them
    and held only where ``want`` names them."""
    return all(launches[k] == v for k, v in want.items())


def reserved_mb() -> float:
    """Device memory the caching allocator holds, after handing back what
    no live tensor or graph pool uses."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**20


def build_dlm(cfg=None):
    """A full-width denoiser (default: qwen2-1.5b), random weights from seed
    0."""
    from repro_torch.configs import get_config
    from repro_torch.models import DiffusionLM

    if cfg is None:
        cfg = get_config("qwen2-1.5b")
        check(
            (cfg.num_layers, cfg.d_model, cfg.dtype) == (28, 1536, torch.bfloat16),
            f"unexpected config {cfg}",
        )
    t0 = time.perf_counter()
    dlm = DiffusionLM(cfg, seed=0)  # on the card
    # the reference zero-inits eps_head (eps = x_t); small random weights
    # make the backbone reach the output
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(cfg.d_model, cfg.d_model, generator=gen, device="cuda")
    dlm.eps_head.w.copy_(w * (0.5 / cfg.d_model**0.5))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dlm.parameters())
    log(f"model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
        f"{n_params / 1e9:.3f}B params, built in {time.perf_counter() - t0:.1f}s")
    return dlm


def profile_replays(submit, drain, what: str, wall_ms: float, nfe: int,
                    flash: int, era: int) -> tuple[float, float]:
    """Profile a drain of graph replays (``submit`` queues its requests)
    and hold the trace's kernel rows against the launches the captures
    recorded.  The profiler can drop records of a long replay (or a whole
    trace), so a trace short of them is taken again, up to five times;
    every trace short fails.  Returns the idle share, device busy ms and
    the trace's (ms, count, name) rows."""
    for attempt in range(5):
        submit()
        try:
            idle, _, rows, busy = profile_device(drain, what, wall_ms, nfe, "NFE")
        except RuntimeError as e:  # a whole trace dropped: trace again
            log(f"{what}: trace {attempt}: {e}; traced again")
            continue
        fl = sum(r[1] for r in rows if "flash_fwd_kernel" in r[2])
        er = sum(r[1] for r in rows if is_era_kernel(r[2]))
        if (fl, er) == (flash, era):
            log(f"{what}: the trace holds the {fl} flash and {er} era_update "
                f"kernels the captures recorded")
            return idle, busy, rows
        log(f"{what}: trace {attempt} holds flash {fl}, era_update {er} of "
            f"the {flash}, {era} kernels recorded; traced again")
    raise RuntimeError(f"chip_smoke: FAILED: {what}: no trace holds the "
                       f"recorded kernels")


def phase_slice(ku, kf, kd, dlm):
    from repro_torch.core import get_program, linear_schedule
    from repro_torch.serving import BatchedSampler, SampleRequest, result_keys

    cfg = dlm.config
    sched = linear_schedule()
    eng = BatchedSampler(dlm, sched)
    reqs = [
        SampleRequest(batch=1, seq_len=256, nfe=NFE, solver="era", seed=11),
        SampleRequest(batch=3, seq_len=256, nfe=NFE, solver="era", seed=12),
        SampleRequest(batch=4, seq_len=128, nfe=NFE, solver="era", seed=13),
    ]
    # capture the grid: batch buckets (1, 8, 64) x seq 256, 128 x nfe 10
    mem0 = reserved_mb()
    t0 = time.perf_counter()
    report = eng.warmup(seq_lens=(256, 128))
    warmup_s = time.perf_counter() - t0
    graph_mb = reserved_mb() - mem0
    check(report["fresh"] == report["programs"] == 6,
          f"warmup captured {report['fresh']} of {report['programs']} graphs")
    log(f"warmup: {report['programs']} graphs captured in {warmup_s:.2f}s; "
        f"the graph cache holds {graph_mb:.0f} MiB")

    futs = [eng.submit_with_future(r)[1] for r in reqs]
    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = read_counts(ku, kf, kd)
    results = [f.result() for f in futs]
    check(eng.compile_stats()["fresh"] == 6, "the drain captured a graph")
    fused = len({(r.seq_len, r.nfe) for r in reqs})
    log(f"drain: {len(reqs)} requests in {fused} fused batches (graph "
        f"replays), {drain_s:.3f}s, launches {launches}")
    check(launches["era_update"] == fused * (NFE - K + 1),
          f"era_update launches {launches['era_update']} != "
          f"{fused * (NFE - K + 1)}")
    check(launches["flash_attention"] == fused * cfg.num_layers * NFE,
          f"flash_attention launches {launches['flash_attention']} != "
          f"{fused * cfg.num_layers * NFE}")
    check(launches["decode_attention"] == 0, "the ERA path ran decode_attention")
    for req, res in zip(reqs, results):
        check(tuple(res.x0.shape) == (req.batch, req.seq_len, cfg.d_model),
              f"x0 shape {tuple(res.x0.shape)}")
        check(bool(torch.isfinite(res.x0).all()), "x0 not finite")
        for key in (result_keys.DELTA_EPS_HISTORY,
                    result_keys.DELTA_EPS_HISTORY_PER_SAMPLE,
                    result_keys.ERS_SELECTION_HISTORY, *result_keys.INFO_KEYS):
            check(key in res.info, f"missing result key {key}")
        check(tuple(res.aux[result_keys.ERS_SELECTION_HISTORY].shape)
              == (NFE, req.batch, K), "selection history shape")
        log(f"request batch={req.batch} seq={req.seq_len}: x0 std "
            f"{float(res.x0.std()):.4f}, batch wall {res.batch_wall_s:.3f}s "
            f"({res.batch_wall_s / NFE * 1e3:.2f} ms/NFE), padded batch "
            f"{res.padded_batch}, delta_eps[-1] "
            f"{[round(float(d), 3) for d in res.aux['delta_eps_history_per_sample'][-1]]}")

    # copy-out: another request through the same 8x256 graph must leave the
    # first drain's results as they were
    kept = [r.x0.clone() for r in results]
    eng.submit_with_future(SampleRequest(batch=4, seq_len=256, nfe=NFE, seed=21))
    eng.drain()
    for res, k in zip(results, kept):
        check(torch.equal(res.x0, k), "a replay changed an earlier result")
    log("copy-out: the first drain's results unchanged after another replay "
        "of their graphs")

    # the same requests again: a request's x0 depends only on its seed and
    # shape, so the repeat is bitwise equal; its wall time is the steady state
    futs2 = [eng.submit_with_future(r)[1] for r in reqs]
    t0 = time.perf_counter()
    eng.drain()
    repeat_s = time.perf_counter() - t0
    for res, fut in zip(results, futs2):
        check(torch.equal(res.x0, fut.result().x0), "repeat drain differs")
    log(f"repeat drain: {repeat_s:.3f}s, batch walls "
        f"{sorted({round(f.result().batch_wall_s, 3) for f in futs2})}s")

    # the batch-of-3 request alone: its rows must not depend on batch-mates.
    # Both runs pad to the same 8-row bucket, so every matrix product has the
    # same shape; we expect agreement to bf16 rounding of the latents.
    _, solo_fut = eng.submit_with_future(reqs[1])
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    graph_wall_ms = (time.perf_counter() - t0) * 1e3
    solo = solo_fut.result()
    fused_res = results[1]
    diff = float((solo.x0 - fused_res.x0).abs().max())
    same_sel = bool(torch.equal(
        solo.aux["ers_selection_history"], fused_res.aux["ers_selection_history"]
    ))
    log(f"batch-of-3 fused vs solo: max_abs_diff {diff:.3e}, "
        f"ERS selections equal {same_sel}")
    check(same_sel, "ERS selections differ between fused and solo runs")
    check(diff <= 1e-2, f"fused vs solo x0 differ by {diff}")

    # the same 8x256 chunk run eagerly, through the program's own loop in
    # this process: the first two requests' noise and four zero pad rows
    ex = eng.executor
    program = get_program("era")
    ecfg = dataclasses.replace(ex.config_for("era"), nfe=NFE)
    x_init = torch.cat([ex.noise(reqs[0]), ex.noise(reqs[1]),
                        torch.zeros(4, 256, cfg.d_model, device="cuda")])
    ts = program.step_times(sched, NFE, ecfg, device="cuda")

    def eager():
        return program.sample_scan(
            dlm.eps_fn(), x_init, program.alloc_buffers(x_init, ecfg), sched,
            ecfg, ts=ts)

    eager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eager()
    torch.cuda.synchronize()
    eager_wall_ms = (time.perf_counter() - t0) * 1e3
    graph_x0 = torch.cat([results[0].x0, results[1].x0])
    graph_sel = torch.cat([results[0].aux["ers_selection_history"],
                           results[1].aux["ers_selection_history"]], dim=1)
    ediff = float((out.x0[:4] - graph_x0).abs().max())
    esel = bool(torch.equal(out.aux["ers_selection_history"][:, :4], graph_sel))
    log(f"graph replay vs eager, 8x256: max_abs_diff {ediff:.3e}, bitwise "
        f"{bool(torch.equal(out.x0[:4], graph_x0))}, ERS selections equal {esel}")
    check(esel, "ERS selections differ between the graph and the eager run")
    check(ediff <= 1e-2, f"graph vs eager x0 differ by {ediff}")

    # both under the profiler, for the breakdown and the idle shares
    g_idle, g_busy, _ = profile_replays(
        lambda: eng.submit_with_future(reqs[1]), eng.drain,
        f"graph replay of one 8x256 batch, nfe={NFE}", graph_wall_ms, NFE,
        cfg.num_layers * NFE, NFE - K + 1)
    e_idle, _, _, e_busy = profile_device(
        eager, f"eager run of the same 8x256 batch, nfe={NFE}", eager_wall_ms,
        NFE, "NFE")
    log(f"8x256 batch: graph replay wall {graph_wall_ms:.1f} ms, device busy "
        f"{g_busy:.1f} ms, idle share {g_idle:.3f}; eager wall "
        f"{eager_wall_ms:.1f} ms, device busy {e_busy:.1f} ms, idle share "
        f"{e_idle:.3f}; warmup() {warmup_s:.2f}s")
    per_nfe_ms = drain_s / (fused * NFE) * 1e3
    del eng
    return launches, drain_s, per_nfe_ms, g_busy


# ---------------------------------------------------------------------------
# phase 5: decode_attention
# ---------------------------------------------------------------------------


def decode_cases(kd, fn=None) -> float:
    """Hold ``fn`` (default ``kd.decode_attention``; another build's wrapper
    in ``--decode-ab``) against the plain version in every case; return the
    largest error.  Positions are passed as a (1,) int32 tensor on the card
    where ``fn`` is this checkout's wrapper, else as a host int."""
    this = fn is None
    fn = kd.decode_attention if fn is None else fn
    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = "cuda"

    def run(name, b, h, kvh, s, hd, *, empty=0, shift=0, window=0, prot=0,
            pos=None, q_pos=None, zeros=False, as_int=False, causal=True):
        """A cache of ``s`` slots holding positions 0.. in order, its last
        ``empty`` slots empty (-1), rotated by ``shift`` slots as a wrapped
        ring is (or the given ``pos``); the query sits at the largest
        position (or ``q_pos``).  ``causal=False``: the cross-attention
        mode, which must keep the keys past ``q_pos``."""
        q = torch.randn(b, h, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, s, kvh, hd, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, s, kvh, hd, generator=gen, device=dev).to(torch.bfloat16)
        if pos is None:
            pos = torch.arange(s, dtype=torch.int32, device=dev)
            pos[s - empty:] = -1
            pos = torch.roll(pos, shift)
        if q_pos is None:
            q_pos = s - empty - 1
        kw = dict(window=window, protected=prot)
        if not causal:
            kw["causal"] = False
        qp = q_pos if (as_int or not this) else torch.tensor(
            [q_pos], dtype=torch.int32, device=dev)
        got = fn(q, k, v, qp, pos, **kw)
        want = kd.decode_attention_plain(q, k, v, q_pos, pos, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"decode {name}: non-finite")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - DECODE_RTOL * want.float().abs()).max())
        log(f"decode_attention {name}: max_abs_err {err:.3e}")
        check(excess <= DECODE_ATOL,
              f"decode {name} error {err} beyond {DECODE_ATOL} + {DECODE_RTOL}*|o|")
        if zeros:
            check(bool((got == 0).all()), f"decode {name}: not exact zeros")
        if not causal:
            dropped = fn(q, k, v, qp, pos, **dict(kw, causal=True))
            check(not torch.equal(dropped, got),
                  f"decode {name}: the causal mode kept every key")
        if this and not as_int:
            # the int form writes the position to the card first; the
            # kernel then reads the same value
            again = fn(q, k, v, q_pos, pos, **kw)
            check(torch.equal(got, again), f"decode {name}: int and tensor q_pos differ")
        return err

    b, h, kvh, s, hd = 8, 12, 2, 1024, 128
    # a full 1024-slot ring whose positions run 5000.. from slot 300; with
    # the query at 6023 and window 48 the valid slots are 252-299, 4 of the
    # 64 tiles, so blocks 3-6 of each cluster hold no valid slot
    ring = torch.roll(torch.arange(5000, 5000 + s, dtype=torch.int32, device=dev), 300)
    errs = [
        run("qwen2 B=8 H=12 KV=2 S=1024 hd=128, 512 empty slots, host-int q_pos",
            b, h, kvh, s, hd, empty=512, as_int=True),
        run("q_pos as a (1,) int32 tensor on the card, 512 empty slots",
            b, h, kvh, s, hd, empty=512),
        run("qwen2 full cache", b, h, kvh, s, hd),
        run("wrapped ring, 7 empty, window=200+protected=4",
            b, h, kvh, s, hd, empty=7, shift=300, window=200, prot=4),
        run("wrapped ring, window=48: 4 of 8 blocks of every cluster "
            "outside the window", b, h, kvh, s, hd, pos=ring, q_pos=6023,
            window=48),
        run("wrapped ring, every slot outside the window (exact zeros)",
            b, h, kvh, s, hd, pos=ring, q_pos=9000, window=48, zeros=True),
        run("S=1000 (not a multiple of the 16-slot tile or the cluster's "
            "128-slot span), 37 empty", b, h, kvh, 1000, hd, empty=37, shift=11),
        run("G=5 (hymba heads H=25 KV=5) hd=64", 2, 25, 5, 300, 64,
            empty=20, window=64, prot=8),
        run("G=20 (three 8-head chunks, H=40 KV=2) hd=64", 2, 40, 2, 520, 64,
            empty=9),
        run("hd=64 (llama3.2-1b heads H=32 KV=8)", 8, 32, 8, 1024, 64,
            empty=100),
        run("hd=32 (smoke heads)", 2, 4, 2, 96, 32),
        run("hymba ring B=8 H=25 KV=5 S=1024 hd=64, protected=128, window=1024, "
            "512 empty", AR_BATCH, HY_H, HY_KV, AR_MAX_LEN, HY_HD, empty=512,
            window=HY_WINDOW, prot=HY_META),
        run("hymba ring full, protected=128, window=1024", AR_BATCH, HY_H,
            HY_KV, AR_MAX_LEN, HY_HD, window=HY_WINDOW, prot=HY_META),
        run("hymba ring wrapped past its 128 protected slots, window=300",
            AR_BATCH, HY_H, HY_KV, AR_MAX_LEN, HY_HD, pos=hymba_ring(dev),
            q_pos=3000, window=300, prot=HY_META),
        run("cluster of one (B*KV=512: llama heads at batch 64)",
            64, 32, 8, 512, 64, empty=30),
        run("no valid slot (exact zeros)", b, h, kvh, s, hd,
            pos=torch.full((s,), -1, dtype=torch.int32, device=dev), q_pos=0,
            zeros=True),
    ]
    if this:
        # phase 12's decode: paligemma's hd-256 instance (KV=1, G=8 in one
        # 8-head chunk) on a 1024-slot ring half full, full and wrapped;
        # whisper's cross-attention (non-causal over the 1500 encoder keys,
        # the query at 100, so 1399 keys lie past it) and its self ring
        # (G=1)
        errs += [
            run(f"paligemma B=8 H={PG_H} KV={PG_KV} S=1024 hd={PG_HD}, 512 "
                f"empty", AR_BATCH, PG_H, PG_KV, AR_MAX_LEN, PG_HD, empty=512),
            run("paligemma full cache, hd 256", AR_BATCH, PG_H, PG_KV,
                AR_MAX_LEN, PG_HD),
            run("paligemma wrapped ring, 7 empty, hd 256", AR_BATCH, PG_H,
                PG_KV, AR_MAX_LEN, PG_HD, empty=7, shift=300),
            # 64 groups: a cluster of 2, 32 tiles a block; the wrapper cuts
            # a warp's ring to the 2 stages of 16.5 KB that fit the block
            run("paligemma at batch 64 (a warp's ring cut to fit), hd 256",
                64, PG_H, PG_KV, AR_MAX_LEN, PG_HD, empty=100),
            run(f"whisper cross: {WH_FRAMES} keys, q_pos 100, non-causal",
                AR_BATCH, WH_H, WH_H, WH_FRAMES, WH_HD, q_pos=100,
                causal=False),
            run("whisper self ring G=1, 512 empty", AR_BATCH, WH_H, WH_H,
                AR_MAX_LEN, WH_HD, empty=512),
        ]
    return max(errs)


def is_decode_kernel(name: str) -> bool:
    """A profiler row of a decode kernel (this one's or a parent's split
    and combine kernels)."""
    return "decode_" in name and "kernel" in name


def decode_timings(kd, fn, q, k, v, q_pos, pos, what, *, full=True,
                   window: int = 0, protected: int = 0, kernels: int = 0,
                   causal: bool = True) -> dict:
    """Device time of ``fn`` at one cache, L2-warm (20 calls in a row) and
    L2-cold (L2 flushed before each call, only the decode kernels' rows
    counted); with ``full``, also the plain version, one SDPA call (the G
    query heads of a kv head as the query axis against K/V viewed as (B,
    KV, S, hd), the slot mask built outside the timed call) warm and cold,
    and the bound."""
    import torch.nn.functional as F

    b, s, kvh, hd = k.shape
    h = q.shape[1]
    kw = dict(window=window, protected=protected)
    if not causal:
        kw["causal"] = False
    t = dict(ms=device_ms(lambda: fn(q, k, v, q_pos, pos, **kw),
                          pick=is_decode_kernel, kernels=kernels),
             ms_l2_cold=device_ms(lambda: fn(q, k, v, q_pos, pos, **kw),
                                  cold=True, pick=is_decode_kernel,
                                  kernels=kernels))
    if not full:
        return t
    qp = int(q_pos) if not isinstance(q_pos, torch.Tensor) else int(q_pos.item())
    qg = q.view(b, kvh, h // kvh, hd)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    valid = (pos >= 0) & (pos <= qp) if causal else pos >= 0
    if window > 0:
        valid &= (pos > qp - window) | (pos < protected)
    mask = valid[None, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qg, kt, vt, attn_mask=mask)

    # the function needs K/V of the valid slots only, once; q, out and
    # kv_pos once.  Each valid slot costs 4 flops a head and dim.
    n_valid = int(valid.sum())
    nbytes = 2.0 * (2 * b * n_valid * kvh * hd + 2 * b * h * hd) + 4.0 * s
    flops = 4.0 * b * h * n_valid * hd
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    t.update(
        plain_ms=device_ms(lambda: kd.decode_attention_plain(q, k, v, qp, pos, **kw),
                           iters=5),
        library_ms=device_ms(sdpa),
        library_ms_l2_cold=device_ms(sdpa, cold=True),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        shape=f"B={b} H={h} KV={kvh} S={s} hd={hd} bf16, {what}",
        plan=kd.split_plan(b, kvh, s, h // kvh),
    )
    t["kernel_over_library"] = t["ms"] / t["library_ms"]
    t["kernel_over_library_l2_cold"] = t["ms_l2_cold"] / t["library_ms_l2_cold"]
    log(f"decode_attention timing ({what}): kernel {t['ms']:.5f} ms L2-warm, "
        f"{t['ms_l2_cold']:.5f} ms L2-cold; plain {t['plain_ms']:.5f} ms; SDPA "
        f"{t['library_ms']:.5f} / {t['library_ms_l2_cold']:.5f} ms; bound "
        f"{t['bound_ms']:.5f} ms ({t['bound_by']}, {n_valid} valid slots); "
        f"(cluster, stages) {t['plan']}")
    return t


def decode_inputs(empty: int):
    """The AR path's decode shapes (B=8, H=12, KV=2, 1024 slots, hd=128):
    q, the cache, the query position as a (1,) int32 tensor on the card and
    the slot positions (the last ``empty`` slots empty)."""
    b, h, kvh, s, hd = AR_BATCH, 12, 2, AR_MAX_LEN, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, s, kvh, hd, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, s, kvh, hd, generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    pos[s - empty:] = -1
    q_pos = torch.tensor([s - empty - 1], dtype=torch.int32, device="cuda")
    return q, k, v, q_pos, pos


def phase_decode(kd):
    check(kd.split_plan(64, 8, 512, 4)[0] == 1, "batch-64 case has a cluster")
    err = decode_cases(kd)
    # timing at the AR path's cache half full and full, the position on
    # the card as the attention layer passes it
    half = decode_inputs(empty=512)
    timing = decode_timings(kd, kd.decode_attention, *half, "512 of 1024 slots valid",
                            kernels=1)
    timing["wrapper_ms"] = time_ms(lambda: kd.decode_attention(*half))
    log(f"decode_attention: a wrapper call {timing['wrapper_ms']:.5f} ms, "
        f"host included")
    full = decode_inputs(empty=0)
    timing["full"] = decode_timings(kd, kd.decode_attention, *full, "full cache",
                                    kernels=1)
    # hymba-1.5b's ring (phase 11's AR path): 128 protected slots, window
    timing["hymba"] = {
        key: decode_timings(kd, kd.decode_attention, *hymba_decode_inputs(empty),
                            what, window=HY_WINDOW, protected=HY_META, kernels=1)
        for key, empty, what in (
            ("half", 512, "hymba, 512 of 1024 slots valid, protected 128"),
            ("full", 0, "hymba, full cache, protected 128"))}
    # phase 12's: paligemma's hd-256 ring half full and full; whisper's
    # cross-attention over the 1500 encoder keys (non-causal, the query at
    # 100) and its G=1 self ring half full
    timing["paligemma"] = {
        key: decode_timings(kd, kd.decode_attention,
                            *ring_inputs(PG_H, PG_KV, PG_HD, AR_MAX_LEN, empty, 11),
                            what, kernels=1)
        for key, empty, what in (
            ("half", 512, "paligemma hd 256, 512 of 1024 slots valid"),
            ("full", 0, "paligemma hd 256, full cache"))}
    q, k, v, _, pos = ring_inputs(WH_H, WH_H, WH_HD, WH_FRAMES, 0, 12)
    q_pos = torch.tensor([100], dtype=torch.int32, device="cuda")
    timing["whisper"] = dict(
        cross=decode_timings(kd, kd.decode_attention, q, k, v, q_pos, pos,
                             f"whisper cross, {WH_FRAMES} keys, non-causal",
                             kernels=1, causal=False),
        self_half=decode_timings(
            kd, kd.decode_attention,
            *ring_inputs(WH_H, WH_H, WH_HD, AR_MAX_LEN, 512, 13),
            "whisper self ring, 512 of 1024 slots valid", kernels=1))
    return err, timing


def ring_inputs(h: int, kvh: int, hd: int, s: int, empty: int, seed: int):
    """Decode inputs at batch 8: q (B, H, hd), a cache of ``s`` slots, the
    query position as a (1,) int32 tensor on the card and the slot
    positions (the last ``empty`` slots empty, the query at the newest)."""
    b = AR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, s, kvh, hd, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    pos[s - empty:] = -1
    q_pos = torch.tensor([s - empty - 1], dtype=torch.int32, device="cuda")
    return q, k, v, q_pos, pos


# ---------------------------------------------------------------------------
# phase 6: the AR serving path
# ---------------------------------------------------------------------------


# decode steps a profiled decode loop runs: an eager step is ~2,000-4,000
# device ops, and the profiler's host work grows with every op it records
PROFILED_STEPS = 8


def decode_steps(eng, prompts, start: int, extras: dict | None = None):
    """A prefill of ``prompts`` (after the stub inputs in ``extras``), then
    a closure that runs PROFILED_STEPS greedy decode steps from its cache
    at positions ``start`` on."""
    logits, cache = eng.prefill_step(prompts, extras=extras)

    def loop():
        t = eng.sample_token(logits)
        for i in range(PROFILED_STEPS):
            lg, _ = eng.decode_step(cache, t[:, None], start + i)
            t = eng.sample_token(lg)
    return loop


def profile_decode_loop(eng, prompts, start: int, what: str,
                        extras: dict | None = None):
    """PROFILED_STEPS decode steps after a prefill, timed unprofiled, then
    the same steps after a fresh prefill under the profiler (the decode
    steps update the cache in place): :func:`profile_device`'s idle share,
    device ops, rows and busy ms."""
    loop = decode_steps(eng, prompts, start, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    loop = decode_steps(eng, prompts, start, extras)
    torch.cuda.synchronize()
    return profile_device(
        loop, f"{what}, {PROFILED_STEPS} steps of {prompts.shape[0]} tokens",
        wall_ms, PROFILED_STEPS, "step")


def phase_ar(ku, kf, kd):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config("qwen2-1.5b")
    check(
        (cfg.num_layers, cfg.d_model, cfg.padded_vocab, cfg.dtype)
        == (28, 1536, 153600, torch.bfloat16),
        f"unexpected config {cfg}",
    )
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)  # on the card
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"AR model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} vocab "
        f"{cfg.vocab_size} padded to {cfg.padded_vocab}, "
        f"{n_params / 1e9:.3f}B params, built in {time.perf_counter() - t0:.1f}s")
    eng = Engine(model, ServeConfig(max_len=AR_MAX_LEN))
    check(eng.slots == AR_MAX_LEN, f"cache slots {eng.slots}")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (AR_BATCH, AR_PROMPT))
    ).to(torch.int32).cuda()

    eng.generate(prompts, AR_GEN)  # warm: cuBLAS plans, allocator
    torch.cuda.synchronize()
    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
    t0 = time.perf_counter()
    toks = eng.generate(prompts, AR_GEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = read_counts(ku, kf, kd)
    log(f"generate: {tuple(toks.shape)} in {gen_s:.3f}s "
        f"({AR_BATCH * AR_GEN / gen_s:.1f} tok/s), launches {launches}")
    check(tuple(toks.shape) == (AR_BATCH, AR_GEN), "generated shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a generated token is outside the vocabulary")
    check(launches_are(launches, {
              "era_update": 0, "flash_attention": cfg.num_layers,
              "decode_attention": cfg.num_layers * (AR_GEN - 1)}),
          f"AR launches {launches}")

    # the same generation step by step, timed: prefill, then the decode
    # loop; the decode logits at a few steps are kept for the check below
    keep = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill_step(prompts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nxt = [eng.sample_token(logits)]
    for i in range(AR_GEN - 1):
        logits, cache = eng.decode_step(cache, nxt[-1][:, None], AR_PROMPT + i)
        if i + 1 in AR_CHECK_STEPS:
            keep[i + 1] = logits
        nxt.append(eng.sample_token(logits))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(torch.stack(nxt, dim=1), toks), "step-by-step tokens differ")
    prefill_ms = (t1 - t0) * 1e3
    decode_wall_ms = (t2 - t1) * 1e3
    per_token_ms = decode_wall_ms / (AR_GEN - 1)
    log(f"AR timing: prefill {prefill_ms:.2f} ms ({AR_BATCH}x{AR_PROMPT}), "
        f"decode {per_token_ms:.3f} ms per step of {AR_BATCH} tokens "
        f"({decode_wall_ms:.1f} ms for {AR_GEN - 1} steps)")

    # end to end, a smoke check of the whole path (the kernels themselves
    # are held to their plain versions at these shapes in phases 3 and 5):
    # the decode logits at step i equal the last-token logits of a fresh
    # prefill over prompt + the first i generated tokens
    for i, dec in keep.items():
        seq = torch.cat([prompts, toks[:, :i]], dim=1)
        ref, _ = model.prefill(seq, AR_MAX_LEN)
        ref = ref.float()
        diff = float((dec.float() - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"decode vs prefill logits at step {i}: max_abs_diff {diff:.4f}, "
            f"max |logit| {scale:.3f}, ratio {diff / scale:.4f}")
        check(diff <= AR_LOGIT_RTOL["dense"] * scale,
              f"decode logits at step {i} differ from prefill by {diff} "
              f"(> {AR_LOGIT_RTOL['dense']} x {scale})")

    # the smoke check must see a planted fault: the last checked step
    # decoded again from a prefill of the tokens before it, once as served
    # and once with the newest prompt key's slot marked empty (one of the
    # 512+ keys every layer attends over)
    i = AR_CHECK_STEPS[-1]
    seq = torch.cat([prompts, toks[:, :i]], dim=1)
    ref = model.prefill(seq, AR_MAX_LEN)[0].float()
    scale = float(ref.abs().max())
    ratios = {}
    for fault in (False, True):
        _, c = model.prefill(seq[:, :-1], AR_MAX_LEN)
        if fault:
            for ring in model.rings(c):
                ring["pos"][AR_PROMPT - 1] = -1
        lg = model.decode(c, seq[:, -1:], seq.shape[1] - 1)[0].float()
        ratios[fault] = float((lg - ref).abs().max()) / scale
    log(f"decode vs prefill at step {i}: ratio {ratios[False]:.4f} as "
        f"served, {ratios[True]:.4f} with one key dropped (tolerance "
        f"{AR_LOGIT_RTOL['dense']})")
    check(ratios[False] <= AR_LOGIT_RTOL["dense"] < ratios[True],
          f"the smoke check does not tell a dropped key from the served "
          f"path: {ratios}")

    # the decode loop once more under the profiler, for the breakdown
    idle, n_ops, rows, busy_ms = profile_decode_loop(
        eng, prompts, AR_PROMPT, "decode loop")
    # the decode kernel inside the loop: one kernel name, one launch a layer
    # and step, its time per launch and share of the loop's device time
    dec = [r for r in rows if is_decode_kernel(r[2])]
    check(len(dec) == 1, f"decode loop: decode kernels {[r[2] for r in dec]}")
    dec_ms, dec_n, dec_name = dec[0]
    check(dec_n == cfg.num_layers * PROFILED_STEPS,
          f"decode loop: {dec_n} launches of {dec_name}")
    in_loop = dict(kernel=dec_name, ms=dec_ms, launches=dec_n,
                   ms_per_launch=dec_ms / dec_n, busy_share=dec_ms / busy_ms)
    log(f"decode_attention in the loop: {dec_ms:.3f} ms for {dec_n} launches, "
        f"{in_loop['ms_per_launch'] * 1e3:.3f} us a launch, "
        f"{in_loop['busy_share']:.4f} of {busy_ms:.1f} ms device busy")
    # the rope's share of those ops: the device ops of the loop's rope
    # calls (q and k in every layer of every step) at the decode shapes,
    # profiled as long as the loop (the count of a one-step trace varied by
    # ~100 ops from run to run on the H100)
    from repro_torch.models import layers as L

    hd = cfg.resolved_head_dim
    qx = torch.randn(AR_BATCH, 1, cfg.num_heads, hd, device="cuda")
    kx = torch.randn(AR_BATCH, 1, cfg.num_kv_heads, hd, device="cuda")
    qx, kx = qx.to(cfg.dtype), kx.to(cfg.dtype)
    at = torch.full((1,), AR_PROMPT, dtype=torch.int32, device="cuda")

    def loop_ropes():
        for _ in range(PROFILED_STEPS * cfg.num_layers):
            L.apply_rope(qx, at, cfg.rope_theta)
            L.apply_rope(kx, at, cfg.rope_theta)

    rows = device_events(loop_ropes)[0]
    rope_ops = sum(r[1] for r in rows)
    per_layer = rope_ops / (PROFILED_STEPS * cfg.num_layers)
    log(f"rope: {per_layer:.2f} device ops a layer (q and k), {rope_ops} "
        f"of the decode loop's {n_ops} ({rope_ops / n_ops:.3f})")
    return launches, dict(prefill_ms=prefill_ms, decode_ms_per_step=per_token_ms,
                          tok_s=AR_BATCH * AR_GEN / gen_s, idle_share=idle,
                          rope_op_share=rope_ops / n_ops, decode_in_loop=in_loop)


# ---------------------------------------------------------------------------
# phase 7: the bucketed ERA drain
# ---------------------------------------------------------------------------

SEQ_BUCKETS, NFE_BUCKETS = (128, 256), (NFE,)
# (batch, seq_len, nfe, seed): two seq buckets of 4 and 6 rows, each padded
# to one 8-row batch that runs 10 step-masked steps
BUCKETED_REQS = ((1, 256, 10, 31), (3, 200, 8, 32), (4, 100, 6, 33),
                 (2, 128, 10, 34))


def phase_bucketed(ku, kf, kd, dlm):
    from unittest import mock

    from repro_torch.core import linear_schedule
    from repro_torch.serving import BatchedSampler, SampleRequest, result_keys

    cfg = dlm.config

    def engine():
        # one batch bucket: a solo drain below runs the same GEMM shapes as
        # its fused batch, so their ERS selections can be held equal
        return BatchedSampler(dlm, linear_schedule(), batch_buckets=(8,),
                              seq_buckets=SEQ_BUCKETS, nfe_buckets=NFE_BUCKETS)

    # the graphs share one memory pool; a second engine whose captures each
    # take a private pool measures what sharing saves
    mem0 = reserved_mb()
    private = engine()
    with mock.patch.object(torch.cuda, "graph_pool_handle", lambda: None):
        private.warmup()
    private_mb = reserved_mb() - mem0
    del private
    mem0 = reserved_mb()
    eng = engine()
    t0 = time.perf_counter()
    report = eng.warmup()
    warmup_s = time.perf_counter() - t0
    shared_mb = reserved_mb() - mem0
    check(report["programs"] == report["fresh"] == 2
          and len(eng.compile_cache()) == 2,
          f"bucketed warmup: {report}")
    log(f"bucketed warmup: 2 graphs (seq buckets {SEQ_BUCKETS}, nfe bucket "
        f"{NFE_BUCKETS[0]}, batch 8) captured in {warmup_s:.2f}s; the graph "
        f"cache holds {shared_mb:.0f} MiB with one shared pool, "
        f"{private_mb:.0f} MiB with a pool per graph")

    reqs = [SampleRequest(batch=b, seq_len=s, nfe=n, seed=sd)
            for b, s, n, sd in BUCKETED_REQS]
    futs = [eng.submit_with_future(r)[1] for r in reqs]
    batches0 = eng.metrics.get("sampler_batches_total").value()
    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(ku, kf, kd)
    results = [f.result() for f in futs]
    batches = eng.metrics.get("sampler_batches_total").value() - batches0
    log(f"bucketed drain: {len(reqs)} requests in {batches:.0f} fused batches, "
        f"{drain_ms:.1f} ms, launches {launches}")
    check(batches == 2, f"bucketed drain ran {batches} batches, not 2")
    check(launches_are(launches, {"era_update": 2 * (NFE - K + 1),
                                  "flash_attention": 2 * cfg.num_layers * NFE,
                                  "decode_attention": 0}),
          f"bucketed drain launches {launches}")
    check(eng.compile_stats()["fresh"] == 2, "the bucketed drain captured a graph")
    for req, res in zip(reqs, results):
        check(tuple(res.x0.shape) == (req.batch, req.seq_len, cfg.d_model),
              f"bucketed x0 shape {tuple(res.x0.shape)} for {req}")
        check(bool(torch.isfinite(res.x0).all()), "bucketed x0 not finite")
        check((res.padded_batch, res.padded_seq_len, res.padded_nfe)
              == (8, 256 if req.seq_len > 128 else 128, NFE),
              f"bucketed padding {res.padded_batch, res.padded_seq_len, res.padded_nfe}")
        check(tuple(res.aux[result_keys.ERS_SELECTION_HISTORY].shape)
              == (req.nfe, req.batch, K), "bucketed selection history shape")
        check(tuple(res.aux[result_keys.DELTA_EPS_HISTORY_PER_SAMPLE].shape)
              == (req.nfe, req.batch), "bucketed delta_eps history shape")

    # each request against its solo drain through the same engine (the same
    # graph, its rows at other offsets and among other pad rows)
    for req, res in zip(reqs, results):
        _, fut = eng.submit_with_future(req)
        eng.drain()
        solo = fut.result()
        diff = float((solo.x0 - res.x0).abs().max())
        same_sel = bool(torch.equal(solo.aux["ers_selection_history"],
                                    res.aux["ers_selection_history"]))
        log(f"bucketed {req.batch}x{req.seq_len} nfe={req.nfe} fused vs solo: "
            f"max_abs_diff {diff:.3e}, bitwise {bool(torch.equal(solo.x0, res.x0))}, "
            f"ERS selections equal {same_sel}")
        check(same_sel, f"bucketed ERS selections differ from solo for {req}")
        check(diff <= 1e-2, f"bucketed fused vs solo x0 differ by {diff}")
    check(eng.compile_stats()["fresh"] == 2, "a solo drain captured a graph")

    idle, busy, _ = profile_replays(
        lambda: [eng.submit_with_future(r) for r in reqs], eng.drain,
        "bucketed drain, 2 batches of 8 rows, 10 step-masked steps",
        drain_ms, 2 * NFE, 2 * cfg.num_layers * NFE, 2 * (NFE - K + 1))
    del eng
    return launches, dict(drain_ms=drain_ms, busy_ms=busy, idle_share=idle,
                          warmup_s=warmup_s, graph_mib_shared=shared_mb,
                          graph_mib_private=private_mb)


# ---------------------------------------------------------------------------
# phase 8: the baseline solvers
# ---------------------------------------------------------------------------

BASELINES = ("ddim", "explicit_adams", "implicit_adams_pece", "dpm_solver_2",
             "dpm_solver_fast", "dpm_solver_pp2m", "dpm_adaptive")
STEPPED_BASELINES = ("ddim", "explicit_adams", "implicit_adams_pece",
                     "dpm_solver_pp2m", "dpm_adaptive")
# (batch, seq_len, nfe, seed): one 8-row batch of NFE bucket 10
MIXED_NFE_REQS = ((1, 256, 10, 41), (3, 256, 8, 42), (4, 256, 6, 43))


def phase_solvers(ku, kf, kd, dlm):
    """Serve each baseline's 8x256 nfe=10 batch as a graph replay through
    ``build_engine`` (replay == eager run bitwise, copy-out, 280 flash
    launches, no era_update), then, for the programs that support steps, a
    mixed-NFE drain fused into one batch, each request bitwise its solo
    drain.  Returns the launches of the served drains and a report a
    solver."""
    from repro_torch.core import get_program, linear_schedule, solver_names
    from repro_torch.serving import EngineConfig, SampleRequest, build_engine

    cfg = dlm.config
    sched = linear_schedule()
    check(solver_names() == sorted(BASELINES + ("era",)),
          f"the port's solvers are {solver_names()}")
    flash_per_batch = cfg.num_layers * NFE
    total = dict.fromkeys(COUNTED, 0)

    def served(drain) -> dict:
        """Drive one drain of the main path with the counts set to 0, and
        add what it launched to the phase's total."""
        reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
        drain()
        torch.cuda.synchronize()
        counts = read_counts(ku, kf, kd)
        for k, v in counts.items():
            total[k] += v
        return counts

    report = {}
    for name in BASELINES:
        program = get_program(name)
        eng = build_engine(dlm, sched, EngineConfig(
            solver=name, nfe=NFE, batch_buckets=(8,)))
        t0 = time.perf_counter()
        rep = eng.warmup(seq_lens=(256,))
        warmup_s = time.perf_counter() - t0
        check(rep["fresh"] == rep["programs"] == 1, f"{name} warmup: {rep}")
        req = SampleRequest(batch=8, seq_len=256, nfe=NFE, seed=51)
        _, fut = eng.submit_with_future(req)
        t0 = time.perf_counter()
        launches = served(eng.drain)
        replay_ms = (time.perf_counter() - t0) * 1e3
        res = fut.result()
        check(launches_are(launches, {"era_update": 0,
                                      "flash_attention": flash_per_batch,
                                      "decode_attention": 0}),
              f"{name} launches {launches}")
        check(tuple(res.x0.shape) == (8, 256, cfg.d_model),
              f"{name} x0 shape {tuple(res.x0.shape)}")
        check(bool(torch.isfinite(res.x0).all()), f"{name} x0 not finite")

        # copy-out: a replay with other noise leaves the result as it was
        kept = res.x0.clone()
        eng.submit_with_future(dataclasses.replace(req, seed=52))
        eng.drain()
        check(torch.equal(res.x0, kept), f"{name}: a replay changed a result")
        # two more replays of the same request: the same x0, and the walls
        walls = [replay_ms]
        for _ in range(2):
            _, again = eng.submit_with_future(req)
            t0 = time.perf_counter()
            eng.drain()
            walls.append((time.perf_counter() - t0) * 1e3)
            check(torch.equal(again.result().x0, res.x0),
                  f"{name}: a repeated replay differs")
        replay_ms = sorted(walls)[1]
        check(eng.compile_stats()["fresh"] == 1, f"{name}: a drain captured")

        # the same batch eagerly, through the program's own loop
        ex = eng.executor
        ecfg = ex.config_for(name)
        x_init = ex.noise(req)
        ts = program.step_times(sched, NFE, ecfg, device="cuda")

        def eager():
            return program.sample_scan(
                dlm.eps_fn(), x_init, program.alloc_buffers(x_init, ecfg),
                sched, ecfg, ts=ts)

        eager()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eager()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(out.x0, res.x0),
              f"{name}: graph replay differs from the eager run by "
              f"{float((out.x0 - res.x0).abs().max())}")
        for key, value in out.aux.items():
            check(torch.equal(value, res.aux[key]),
                  f"{name}: aux {key} differs between replay and eager")
        _, eager_span, _, eager_busy = device_events(eager)

        idle, busy, _ = profile_replays(
            lambda: eng.submit_with_future(req), eng.drain,
            f"{name}: graph replay of one 8x256 batch, nfe={NFE}", replay_ms,
            NFE, flash_per_batch, 0)
        entry = dict(replay_ms=replay_ms, replay_ms_runs=walls, busy_ms=busy,
                     idle_share=idle,
                     eager_ms=eager_ms, eager_busy_ms=eager_busy,
                     eager_idle_share=1 - eager_busy / eager_span,
                     warmup_s=warmup_s, reported_nfe=out.nfe)
        log(f"{name}: 8x256 nfe={NFE} replay {replay_ms:.1f} ms (median of "
            f"{[round(w, 1) for w in walls]}; device busy "
            f"{busy:.1f} ms, idle {idle:.3f}), eager {eager_ms:.1f} ms (busy "
            f"{eager_busy:.1f} ms, idle {entry['eager_idle_share']:.3f}), "
            f"replay == eager bitwise, warmup {warmup_s:.2f}s, reported nfe "
            f"{out.nfe}")
        del eng

        if name in STEPPED_BASELINES:
            entry.update(mixed_nfe(name, sched, dlm, served))
        report[name] = entry
    return total, report


def mixed_nfe(name, sched, dlm, served) -> dict:
    """Requests of budget 10, 8 and 6 in NFE bucket 10: one fused 8-row
    graph replay, each request bitwise its solo drain."""
    from repro_torch.serving import EngineConfig, SampleRequest, build_engine

    eng = build_engine(dlm, sched, EngineConfig(
        solver=name, nfe=NFE, batch_buckets=(8,), nfe_buckets=(NFE,)))
    rep = eng.warmup(seq_lens=(256,))
    check(rep["fresh"] == rep["programs"] == 1, f"{name} mixed warmup: {rep}")
    reqs = [SampleRequest(batch=b, seq_len=s, nfe=n, seed=sd)
            for b, s, n, sd in MIXED_NFE_REQS]
    futs = [eng.submit_with_future(r)[1] for r in reqs]
    batches0 = eng.metrics.get("sampler_batches_total").value()
    t0 = time.perf_counter()
    launches = served(eng.drain)
    drain_ms = (time.perf_counter() - t0) * 1e3
    batches = eng.metrics.get("sampler_batches_total").value() - batches0
    check(batches == 1, f"{name}: the mixed-NFE drain ran {batches} batches")
    check(launches["flash_attention"] == dlm.config.num_layers * NFE
          and launches["era_update"] == launches["decode_attention"] == 0,
          f"{name} mixed-NFE launches {launches}")
    realized = []
    for req, fut in zip(reqs, futs):
        res = fut.result()
        check((res.padded_batch, res.padded_seq_len, res.padded_nfe)
              == (8, 256, NFE), f"{name} mixed padding for {req}")
        check(bool(torch.isfinite(res.x0).all()), f"{name} mixed x0 not finite")
        _, solo = eng.submit_with_future(req)
        eng.drain()
        solo = solo.result()
        check(torch.equal(res.x0, solo.x0),
              f"{name}: {req} fused differs from its solo drain by "
              f"{float((res.x0 - solo.x0).abs().max())}")
        if "realized_nfe" in res.aux:
            check(torch.equal(res.aux["realized_nfe"],
                              solo.aux["realized_nfe"]),
                  f"{name}: realized_nfe differs from the solo drain")
            realized.append(res.aux["realized_nfe"].tolist())
    check(eng.compile_stats()["fresh"] == 1, f"{name}: a mixed drain captured")
    log(f"{name}: mixed-NFE drain (nfe 10, 8, 6) in one 8-row batch, "
        f"{drain_ms:.1f} ms, each request bitwise its solo drain"
        + (f"; realized_nfe per request {realized}" if realized else ""))
    del eng
    return dict(mixed_drain_ms=drain_ms,
                **({"realized_nfe": realized} if realized else {}))


# ---------------------------------------------------------------------------
# phase 9: the serving surface (scheduler and HTTP front door)
# ---------------------------------------------------------------------------

FD_SEQ, FD_BUCKETS = 256, (1, 8)
# long enough that eight concurrent wire requests fuse into one batch (an
# 8-row queue launches at once at occupancy 1.0)
FD_MAX_WAIT_MS = 2000.0
# the open-loop stream: requests and arrivals a second (the launcher's
# --continuous defaults for the rest: max_wait 25 ms, occupancy 1.0, seed 0)
FD_STREAM = (32, 20.0)


def parse_metrics(text: str) -> dict:
    """Prometheus text exposition -> {sample with its labels: value}."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        check(bool(name), f"/metrics line {line!r} does not parse")
        samples[name] = float(value)
    return samples


def time_host(fn) -> float:
    """Host wall ms of one call."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def wire_equal(wire, local) -> bool:
    """A wire result (CPU tensors) bitwise a local one (any device)."""
    return torch.equal(wire.x0, local.x0.cpu()) and all(
        torch.equal(wire.aux[k], v.cpu()) for k, v in local.aux.items())


def typed_errors(engine, req) -> float:
    """A typed 429 (a burst past ``max_queue_rows``) and 504 (a deadline
    that expires in the queue) through the wire client, from a front door
    over an unstarted scheduler on a fake clock, so the queue holds until
    it is pumped.  Returns the 429's ``Retry-After`` seconds."""
    import threading

    from repro_torch.serving import (
        AsyncBatchedSampler, DeadlineExceededError, FrontDoor,
        FrontDoorClient, QueueFullError, SchedulerPolicy)

    clk = [0.0]
    held = AsyncBatchedSampler(
        engine, SchedulerPolicy(max_wait_ms=10.0, max_queue_rows=2),
        clock=lambda: clk[0])
    out = {}
    retry_after = None
    with FrontDoor(held) as door:
        client = FrontDoorClient(door.url, timeout=300)

        def call(name, r):
            try:
                out[name] = client.sample(r)
            except Exception as e:  # noqa: BLE001 - checked below
                out[name] = e

        calls = [threading.Thread(target=call, args=a) for a in
                 (("doomed", req(200, deadline_ms=50.0)), ("kept", req(201)))]
        for t in calls:
            t.start()
        t0 = time.perf_counter()
        while held.pending < 2 and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        check(held.pending == 2, "the held queue did not fill")
        try:
            client.sample(req(202))
        except QueueFullError as e:
            retry_after = e.retry_after_s
        check(retry_after is not None, "no 429 past max_queue_rows")
        clk[0] = 1.0
        check(held.drain_once(now=clk[0]) == 1, "held queue launch")
        for t in calls:
            t.join(timeout=300)
    held.stop()
    check(isinstance(out.get("doomed"), DeadlineExceededError),
          f"no typed 504: {out.get('doomed')!r}")
    check(hasattr(out.get("kept"), "x0")
          and bool(torch.isfinite(out["kept"].x0).all()),
          f"the admitted request failed: {out.get('kept')!r}")
    log(f"frontdoor: 429 QueueFullError (Retry-After {retry_after:g}s) and "
        f"504 DeadlineExceededError came back typed")
    return retry_after


def listen_default_grid(dlm) -> dict:
    """Capture the launcher's ``--listen`` default grid at seq 256 (batch
    buckets 1, 8, 64 x nfe 10): its wall and graph memory."""
    from repro_torch.core import linear_schedule
    from repro_torch.launch import serve
    from repro_torch.serving import build_engine, warmup_kwargs

    args = serve.build_parser().parse_args(
        ["--mode", "diffusion", "--listen", "--seq", str(FD_SEQ)])
    cfg = serve._engine_config(args, per_sample=True, fused=True,
                               warmup_seq_lens=(FD_SEQ,))
    engine = build_engine(dlm, linear_schedule(), cfg)
    mem0 = reserved_mb()
    t0 = time.perf_counter()
    rep = engine.warmup(solvers=(args.solver,), **warmup_kwargs(cfg))
    wall_s = time.perf_counter() - t0
    graph_mb = reserved_mb() - mem0
    check(rep["fresh"] == rep["programs"] == 3, f"default grid warmup {rep}")
    log(f"frontdoor: the --listen default grid (batch {cfg.batch_buckets} x "
        f"seq {FD_SEQ} x nfe {NFE}) captured in {wall_s:.2f}s, "
        f"memory_reserved +{graph_mb:.0f} MiB")
    return dict(batch_buckets=list(cfg.batch_buckets), seq=FD_SEQ, nfe=NFE,
                graphs=rep["programs"], wall_s=wall_s, graph_mib=graph_mb)


def phase_frontdoor(ku, kf, kd, dlm):
    """The serving surface on the card: ``serve_frontdoor`` over an ERA
    engine (batch buckets 1, 8 at seq 256, nfe 10) whose two graphs are
    captured on the front door's background warmup while a wire request is
    served; eight concurrent wire requests fused into one 8-row replay; a
    typed 429 and 504; ``/metrics``; an open-loop stream through
    ``AsyncBatchedSampler``; and the launcher's ``--listen`` default grid
    (batch 1, 8, 64 at seq 256) captured for its wall and memory.  Returns
    the launches of the fused wire batch and a report."""
    import threading

    from repro_torch.core import linear_schedule
    from repro_torch.launch import serve
    from repro_torch.serving import (
        EngineConfig, FrontDoorClient, SampleRequest, SchedulerPolicy,
        build_engine, decode_result, encode_result, serve_frontdoor,
        warmup_kwargs)

    cfg = dlm.config
    sched = linear_schedule()
    ecfg = EngineConfig(nfe=NFE, batch_buckets=FD_BUCKETS, warmup="grid",
                        warmup_seq_lens=(FD_SEQ,))
    engine = build_engine(dlm, sched, ecfg)
    ex = engine.executor
    batches = engine.metrics.get("sampler_batches_total")
    report = {}

    def req(seed, **kw):
        return SampleRequest(batch=1, seq_len=FD_SEQ, nfe=NFE, seed=seed, **kw)

    # the warmup captures the 1-row graph, then holds until the request
    # sent during the warmup has replayed it, then captures the 8-row graph
    # while that request's result is encoded, sent and decoded
    held = {}

    def progress(done, total):
        if done == 1:
            t0 = time.perf_counter()
            while batches.value() < 1:
                if time.perf_counter() - t0 > 120:
                    raise RuntimeError("the request sent during the warmup "
                                       "did not run")
                time.sleep(0.002)
            held["s"] = time.perf_counter() - t0

    kw = warmup_kwargs(ecfg)
    mem0 = reserved_mb()
    t_start = time.perf_counter()
    door = serve_frontdoor(
        engine, SchedulerPolicy(max_wait_ms=FD_MAX_WAIT_MS,
                                target_occupancy=1.0),
        warmup=lambda: engine.warmup(progress=progress, **kw))
    try:
        client = FrontDoorClient(door.url, timeout=300)
        check(not client.readyz()["ready"], "/readyz was 200 before the warmup")
        t0 = time.perf_counter()
        early = client.sample(req(100))
        early_ms = (time.perf_counter() - t0) * 1e3
        after = client.readyz()
        log(f"frontdoor: a 1-row request sent during the warmup came back in "
            f"{early_ms:.1f} ms (server latency {early.latency_s * 1e3:.1f} "
            f"ms); /readyz then: ready {after['ready']}, warmup "
            f"{after['warmup'].get('state')} {after['warmup'].get('done')}/"
            f"{after['warmup'].get('total')}")
        while True:
            payload = client.readyz()
            if payload["ready"] or "error" in payload:
                break
            check(time.perf_counter() - t_start < 300, "/readyz never turned 200")
            time.sleep(0.02)
        ready_s = time.perf_counter() - t_start
        check(payload["ready"], f"the warmup failed: {payload.get('error')}")
        status = payload["warmup"]
        graph_mb = reserved_mb() - mem0
        check(status["state"] == "done" and status["fresh"] == 2
              and ex.compile_stats()["fresh"] == 2,
              f"warmup status {status}, {ex.compile_stats()}")
        report.update(
            ready_s=ready_s, warmup_wall_s=status["wall_s"],
            warmup_held_s=held["s"],
            warmup_capture_s=status["wall_s"] - held["s"],
            graph_mib=graph_mb, early_wire_ms=early_ms,
            early_latency_ms=early.latency_s * 1e3,
            early_back_before_ready=not after["ready"])
        log(f"frontdoor: /readyz 200 {ready_s:.2f}s after start; warmup "
            f"{status['wall_s']:.2f}s ({held['s']:.2f}s of it held for the "
            f"early request), 2 graphs; memory_reserved +{graph_mb:.0f} MiB")

        # the early request against the same request drained solo in
        # process on the same engine (the same 1-row graph)
        _, fut = engine.submit_with_future(req(100))
        engine.drain()
        check(wire_equal(early, fut.result()),
              "the request served during the warmup differs from its solo "
              "drain")
        log("frontdoor: the request served during the warmup is bitwise its "
            "solo drain")

        # eight concurrent 1-row wire requests: one 8-row replay
        reqs = [req(s) for s in range(8)]
        out = [None] * 8
        b0, fresh0 = batches.value(), ex.compile_stats()["fresh"]

        def call(i):
            t0 = time.perf_counter()
            res = client.sample(reqs[i])
            out[i] = (res, (time.perf_counter() - t0) * 1e3)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        fused_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(ku, kf, kd)
        check(all(o is not None for o in out), "a concurrent wire request "
              "did not come back")
        check(batches.value() - b0 == 1,
              f"8 wire requests ran {batches.value() - b0:.0f} batches, not 1")
        check(ex.compile_stats()["fresh"] == fresh0, "a capture after ready")
        check(launches_are(launches, {"era_update": NFE - K + 1,
                                      "flash_attention": cfg.num_layers * NFE,
                                      "decode_attention": 0}),
              f"fused wire batch launches {launches}")
        check(all(r.padded_batch == 8 for r, _ in out), "not one 8-row batch")
        # each against the same request drained alone at the same 8-row
        # bucket, and against its 1-row drain on the front door's engine
        # (bucket 1): bitwise both (the determinism contract, phase 16)
        solo8 = build_engine(dlm, sched, EngineConfig(nfe=NFE,
                                                      batch_buckets=(8,)))
        solo8.warmup(seq_lens=(FD_SEQ,))
        cross = []
        for r, (res, wire_ms) in zip(reqs, out):
            check(bool(torch.isfinite(res.x0).all())
                  and tuple(res.x0.shape) == (1, FD_SEQ, cfg.d_model),
                  f"wire x0 {tuple(res.x0.shape)}")
            _, f8 = solo8.submit_with_future(r)
            solo8.drain()
            check(wire_equal(res, f8.result()),
                  f"wire request seed {r.seed} differs from its solo drain")
            _, f1 = engine.submit_with_future(r)
            engine.drain()
            one = f1.result()
            cross.append((float((res.x0 - one.x0.cpu()).abs().max()),
                          torch.equal(res.aux["ers_selection_history"],
                                      one.aux["ers_selection_history"].cpu()),
                          one.batch_wall_s * 1e3))
        del solo8
        check(all(c[0] == 0.0 and c[1] for c in cross),
              f"a wire request's bucket-1 drain differs from its 8-row replay: "
              f"max abs {max(c[0] for c in cross)}, ERS selections equal in "
              f"{sum(c[1] for c in cross)} of 8")
        report.update(
            fused_wall_ms=fused_ms,
            fused_wire_ms=[round(w, 3) for _, w in out],
            fused_latency_ms=[round(r.latency_s * 1e3, 3) for r, _ in out],
            fused_batch_wall_ms=out[0][0].batch_wall_s * 1e3,
            bucket1_vs_bucket8_max_abs=max(c[0] for c in cross),
            bucket1_vs_bucket8_same_selections=sum(c[1] for c in cross),
            one_row_replay_ms=sorted(c[2] for c in cross)[4])
        log(f"frontdoor: 8 concurrent wire requests in one 8-row replay "
            f"(batch wall {out[0][0].batch_wall_s * 1e3:.1f} ms), {fused_ms:.1f} "
            f"ms for all; launches {launches}; each bitwise its solo drain at "
            f"bucket 8 and its 1-row drain (bucket 1: max abs "
            f"{report['bucket1_vs_bucket8_max_abs']}, ERS selections "
            f"equal in {report['bucket1_vs_bucket8_same_selections']} of 8); "
            f"a 1-row replay takes {report['one_row_replay_ms']:.1f} ms "
            f"(median of 8)")
        for r, (res, wire_ms) in zip(reqs, out):
            log(f"  seed {r.seed}: wire {wire_ms:.1f} ms, in-process latency "
                f"{res.latency_s * 1e3:.1f} ms")
        # the host work a response costs, alone: the server's encode (base64
        # and JSON) and the client's decode of one 1-row result
        body = json.dumps(encode_result(out[0][0]))
        enc = sorted(time_host(lambda: json.dumps(encode_result(out[0][0])))
                     for _ in range(5))[2]
        dec = sorted(time_host(lambda: decode_result(json.loads(body)))
                     for _ in range(5))[2]
        report.update(response_bytes=len(body), encode_ms=enc, decode_ms=dec)
        log(f"frontdoor: a 1-row response is {len(body) / 1e6:.2f} MB of JSON; "
            f"encode {enc:.1f} ms, decode {dec:.1f} ms (host, median of 5)")

        report["retry_after_s"] = typed_errors(engine, req)

        samples = parse_metrics(client.metrics())
        group = f'{{nfe="{NFE}",seq="{FD_SEQ}",solver="era"}}'
        for name in (f"sampler_queue_depth_rows{group}",
                     "sampler_request_latency_seconds_count",
                     'frontdoor_http_requests_total{code="200",route="/v1/sample"}',
                     'frontdoor_http_requests_total{code="200",route="/readyz"}',
                     f"sampler_admission_rejects_total{group}",
                     "sampler_deadline_expired_total"):
            check(name in samples, f"/metrics lacks {name}")
        check(samples["sampler_request_latency_seconds_count"] >= 10,
              "latency histogram count")
        report["metrics_samples"] = len(samples)
        log(f"frontdoor: /metrics parses ({len(samples)} samples), queue, "
            f"latency and HTTP counters present")
    finally:
        door.stop()

    # an open-loop stream in process through the launcher's --continuous
    # stream, at its defaults, on the same engine
    n, rate = FD_STREAM
    args = serve.build_parser().parse_args(
        ["--mode", "diffusion", "--continuous", "--requests", str(n),
         "--rate", str(rate), "--seq", str(FD_SEQ), "--nfe", str(NFE)])
    stream = serve.continuous_stream(engine, args)
    idle, _, _, busy = profile_device(
        lambda: serve.continuous_stream(engine, args),
        f"open loop, {n} requests at {rate:g}/s", stream["makespan_s"] * 1e3,
        n, "request")
    report["open_loop"] = dict(
        requests=n, rate=rate, max_wait_ms=args.max_wait_ms,
        occupancy=args.occupancy, **stream, busy_ms=busy, idle_share=idle)
    log(f"frontdoor: open loop {n} req @ {rate:g}/s: p50 "
        f"{stream['p50_ms']:.1f} ms, p99 {stream['p99_ms']:.1f} ms, "
        f"{stream['throughput_rps']:.2f} req/s, {stream['batches']} batches "
        f"of {stream['mean_batch_rows']:.2f} rows, idle share {idle:.3f}")
    check(ex.compile_stats()["fresh"] == 2, "the stream captured a graph")
    del engine, ex

    report["default_grid"] = listen_default_grid(dlm)
    return launches, report


# ---------------------------------------------------------------------------
# phase 16: the determinism contract on the card (after phase 9)
# ---------------------------------------------------------------------------

#: the bf16 GEMM against cuBLAS (``gemm_plain``): each element's float32 sum
#: runs in another order, so the bf16 result may lie a step or two of its
#: magnitude away
GEMM_ATOL = GEMM_RTOL = 2 ** -6
#: the float32 GEMM against cuBLAS's float32 product (another order of K)
GEMM_F32_ATOL, GEMM_F32_RTOL = 1e-4, 1e-5
#: the bf16 norms against their plain versions: the output's rounding step
#: (a float32 statistic a last bit apart can round the other way)
NORM_ATOL = NORM_RTOL = 2 ** -7
#: ``row_sq_sums`` against its plain version (float32 sums in another order)
ROW_SQ_RTOL = 1e-5
#: rows the kernels are held at, and the prefixes whose rows must be
#: bitwise the full input's.  Beside the path's counts, rows at the edges
#: of the bf16 grid's waves (a block a tile, one block an SM of the H100's
#: 132 at a time) at qwen2's widths: at wq (12 column tiles) 1,408 rows
#: are 11 row tiles, exactly one wave, 1,409 one row tile over; at wk / wv
#: (2 column tiles x 3 splits) 2,816 rows are one wave, 2,817 one over; 256
#: rows leave most SMs without a tile, 16,384 are many waves
INV_MS = (1, 8, 200, 256, 1408, 1409, 2048, 2816, 2817, 16384)
INV_PREFIX = (1, 7, 64, 255, 1408, 1409, 2048, 2817)
#: the shapes whose row pitch breaks TMA's 16-byte rule (the guarded-load
#: instance): hymba's dt_proj and x_proj, xLSTM's gates
GEMM_LDG_SHAPES = ((100, 3200), (3200, 132), (2048, 4))
#: qwen2-1.5b's products of the ERA path, timed at 8 x 256 and 1 x 256 rows
GEMM_TIMED = (("wq", 1536, 1536), ("wk", 1536, 256), ("wg", 1536, 8960),
              ("mlp_wo", 8960, 1536))
INV_SEEDS = tuple(range(8))
#: the 64-row replay: the eight one-row requests among seven 8-row ones
INV_OTHERS = tuple(100 + i for i in range(7))
INV_PAD = 200


def held(y, ref, atol: float, rtol: float, what: str) -> float:
    """Check |y - ref| <= atol + rtol |ref| elementwise (and y finite), in
    chunks of rows; return the max abs error."""
    worst, ok = 0.0, True
    for i in range(0, max(1, y.shape[0]), 2048):
        a, b = y[i:i + 2048].float(), ref[i:i + 2048].float()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            (diff <= atol + rtol * b.abs()).all())
    check(ok, f"{what}: max abs error {worst} outside atol {atol} rtol {rtol}")
    return worst


def gemm_cases(kg) -> dict:
    """``gemm`` against ``gemm_plain`` at every ``Linear`` (K, N) of
    qwen2-1.5b and llama3.2-1b (bf16 and float32) and at the guarded-load
    shapes, at each of ``INV_MS`` rows with and without a bias; rows of
    ``x[:m]`` bitwise the same rows of ``x`` for m in ``INV_PREFIX``.
    Returns the max abs error a shape."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(27)
    shapes = set()
    for arch in ("qwen2-1.5b", "llama3.2-1b"):
        shapes |= kg.linear_shapes(get_config(arch))
    shapes |= {(k, n, torch.bfloat16) for k, n in GEMM_LDG_SHAPES}
    errs = {}
    for k, n, dt in sorted(shapes, key=lambda s: (str(s[2]), s[0], s[1])):
        f32 = dt == torch.float32
        atol, rtol = (GEMM_F32_ATOL, GEMM_F32_RTOL) if f32 else (GEMM_ATOL, GEMM_RTOL)
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dt)
        b = torch.randn(n, generator=gen, device="cuda").to(dt)
        x = torch.randn(max(INV_MS), k, generator=gen, device="cuda").to(dt)
        worst = 0.0
        for m in INV_MS:
            for bias in (None, b):
                worst = max(worst, held(kg.gemm(x[:m], w, bias),
                                        kg.gemm_plain(x[:m], w, bias), atol, rtol,
                                        f"gemm {k}x{n} {dt} M={m}"))
        full = kg.gemm(x, w, b)
        for m in INV_PREFIX:
            check(torch.equal(kg.gemm(x[:m], w, b), full[:m]),
                  f"gemm {k}x{n} {dt}: the rows of x[:{m}] differ from the "
                  f"same rows of x")
        cfg = kg.gemm_config(k, n, dt)
        errs[f"{k}x{n} {str(dt).split('.')[-1]}"] = worst
        log(f"gemm {k}x{n} {dt} ({cfg.loader}, BN {cfg.bn}, split {cfg.split}): "
            f"max abs error {worst:.3e} at M {INV_MS}, rows invariant at "
            f"prefixes {INV_PREFIX}")
    return errs


def rownorm_cases(kr) -> dict:
    """The Triton norms against their plain versions (bf16, qwen2's,
    llama's and whisper's widths, ``INV_MS`` rows) and ``row_sq_sums``
    (float32 64 x 256 x 1536 with per-row lengths, and rank 2); prefix rows
    bitwise, and ``row_sq_sums`` of a 200-position batch bitwise the same
    batch padded to 256 with junk in the masked positions."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    errs = {}
    for d in (1536, 2048, 512):
        x = (torch.randn(max(INV_MS), d, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        scale = torch.rand(d, generator=gen, device="cuda") + 0.5
        bias = torch.randn(d, generator=gen, device="cuda")
        for name, fn, plain in (
                ("rmsnorm", lambda t: kr.rmsnorm(t, scale),
                 lambda t: kr.rmsnorm_plain(t, scale)),
                ("layernorm", lambda t: kr.layernorm(t, scale, bias),
                 lambda t: kr.layernorm_plain(t, scale, bias))):
            worst = max(held(fn(x[:m]), plain(x[:m]), NORM_ATOL, NORM_RTOL,
                             f"{name} d={d} rows={m}") for m in INV_MS)
            full = fn(x)
            for m in INV_PREFIX:
                check(torch.equal(fn(x[:m]), full[:m]),
                      f"{name} d={d}: the rows of x[:{m}] differ")
            errs[f"{name} {d}"] = worst
    dd = torch.randn(64, 256, 1536, generator=gen, device="cuda")
    lengths = torch.randint(1, 257, (64,), generator=gen, device="cuda")
    valid = torch.arange(256, device="cuda")[None] < lengths[:, None]
    for what, args in (("row_sq_sums", (dd, valid)), ("row_sq_sums rank 2",
                                                      (dd[:, 0], None))):
        y, ref = kr.row_sq_sums(*args), kr.row_sq_sums_plain(*args)
        rel = float(((y - ref).abs() / ref.abs()).max())
        check(rel <= ROW_SQ_RTOL, f"{what}: relative error {rel}")
        errs[what] = float((y - ref).abs().max())
        for m in (1, 7, 8, 63):
            a = args[1][:m] if args[1] is not None else None
            check(torch.equal(kr.row_sq_sums(args[0][:m], a), y[:m]),
                  f"{what}: the rows of d[:{m}] differ")
    exact = kr.row_sq_sums(dd[:, :INV_PAD].contiguous(), None)
    pad_valid = (torch.arange(256, device="cuda") < INV_PAD)[None].expand(64, 256)
    check(torch.equal(kr.row_sq_sums(dd, pad_valid), exact),
          f"row_sq_sums: {INV_PAD} positions padded to 256 differ from exact")
    log(f"rownorm: max abs errors {errs}; rows invariant; row_sq_sums of "
        f"{INV_PAD} positions bitwise the same padded to 256")
    return errs


@functools.cache
def timing_stream():
    """The one stream every timing graph is captured on: cuBLAS keeps a
    workspace for each stream it has run on for the rest of the process
    (32 MiB or more each), so a new stream a graph would hold on to about
    a gigabyte by the end of phase 16."""
    return torch.cuda.Stream()


def graph_time_ms(body, replays: int = 5) -> float:
    """CUDA-event time of one replay of a CUDA graph of ``body``, run once
    first on the stream the graph is then captured on: builds, allocations
    and cuBLAS's workspace for that stream all happen outside the
    capture."""
    side = timing_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        body()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def graph_ms(fn, *, cold: bool = False, reps: int = 20) -> float:
    """Device time of one call of ``fn``: CUDA events around replays of a
    graph of ``reps`` calls, so no host time sits between the launches and
    no profiler record can be lost (late in this script a trace has held a
    fraction of a short kernel's launches).  ``cold`` writes
    ``FLUSH_BYTES`` before each call and takes a graph of the flushes
    alone off."""
    flush = l2_flush() if cold else None

    def body():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    total = graph_time_ms(body)
    if flush is not None:
        total -= graph_time_ms(lambda: [flush() for _ in range(reps)])
    return total / reps


def timed(fn, bound_ms: float, bound_by: str, plain=None, library=None) -> dict:
    """Device time of ``fn`` (:func:`graph_ms`) L2-warm and L2-cold beside
    its bound, its plain version's and a library call's."""
    out = dict(ms=graph_ms(fn), ms_l2_cold=graph_ms(fn, cold=True),
               bound_ms=bound_ms, bound_by=bound_by,
               plain_ms=None if plain is None else graph_ms(plain),
               library_ms=None if library is None else graph_ms(library),
               library_ms_l2_cold=(None if library is None
                                   else graph_ms(library, cold=True)))
    out["kernel_over_bound"] = out["ms"] / bound_ms
    return out


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    ops, mem = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def rowkernel_timings(kg, kr) -> dict:
    """Device times (:func:`graph_ms`) at qwen2-1.5b's shapes: each ERA-path
    product at 8 x 256 and 1 x 256 rows beside ``torch.matmul``, TimeMLP's
    float32 product at 8 rows, rmsnorm over 8 x 256 rows of 1536, layernorm
    over whisper's 8 x 256 rows of 512, and ``row_sq_sums`` over an 8 x 256
    x 1536 float32 error with per-row lengths."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    out = {}
    for rows in (2048, 256):
        for name, k, n in GEMM_TIMED:
            x = torch.randn(rows, k, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).bfloat16()
            b_ms, b_by = bound(2.0 * rows * k * n, 2.0 * (rows * k + k * n + rows * n),
                               PEAK_BF16_FLOPS)
            out[f"{name} {rows}x{k}x{n}"] = timed(
                lambda: kg.gemm(x, w), b_ms, b_by, plain=lambda: kg.gemm_plain(x, w),
                library=lambda: torch.matmul(x, w))
    x = torch.randn(8, 1536, generator=gen, device="cuda")
    w = torch.randn(1536, 1536, generator=gen, device="cuda") * 1536 ** -0.5
    b = torch.randn(1536, generator=gen, device="cuda")
    b_ms, b_by = bound(2.0 * 8 * 1536 * 1536, 4.0 * (8 * 1536 + 1536 * 1536 + 1536 + 8 * 1536),
                       PEAK_F32_FLOPS)
    out["time_mlp_w2 f32 8x1536x1536"] = timed(
        lambda: kg.gemm(x, w, b), b_ms, b_by, plain=lambda: kg.gemm_plain(x, w, b),
        library=lambda: torch.addmm(b, x, w))
    F = torch.nn.functional
    for name, d in (("rmsnorm", 1536), ("layernorm", 512)):
        x = torch.randn(8, 256, d, generator=gen, device="cuda").bfloat16()
        scale = torch.rand(d, generator=gen, device="cuda") + 0.5
        bias = torch.randn(d, generator=gen, device="cuda")
        b_ms, b_by = bound(0.0, 2.0 * 2 * x.numel() + 4.0 * 2 * d, PEAK_F32_FLOPS)
        if name == "rmsnorm":
            lib = (lambda: F.rms_norm(x, (d,), scale.bfloat16(), 1e-5)) if hasattr(
                F, "rms_norm") else None
            out[f"rmsnorm 2048x{d}"] = timed(
                lambda: kr.rmsnorm(x, scale), b_ms, b_by,
                plain=lambda: kr.rmsnorm_plain(x, scale), library=lib)
        else:
            out[f"layernorm 2048x{d}"] = timed(
                lambda: kr.layernorm(x, scale, bias), b_ms, b_by,
                plain=lambda: kr.layernorm_plain(x, scale, bias),
                library=lambda: F.layer_norm(x, (d,), scale.bfloat16(),
                                             bias.bfloat16(), 1e-5))
    dd = torch.randn(8, 256, 1536, generator=gen, device="cuda")
    valid = torch.arange(256, device="cuda")[None] < torch.tensor(
        [256, 200, 256, 128, 256, 256, 1, 255], device="cuda")[:, None]
    b_ms, b_by = bound(0.0, 4.0 * dd.numel() + valid.numel() + 4 * 8, PEAK_F32_FLOPS)
    out["row_sq_sums 8x256x1536"] = timed(
        lambda: kr.row_sq_sums(dd, valid), b_ms, b_by,
        plain=lambda: kr.row_sq_sums_plain(dd, valid))
    for name, t in out.items():
        lib = "" if t["library_ms"] is None else f", library {t['library_ms']:.4f} ms"
        log(f"timing {name}: {t['ms']:.4f} ms (L2-cold {t['ms_l2_cold']:.4f}), "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['kernel_over_bound']:.2f}x), plain {t['plain_ms']:.4f} ms{lib}")
    return out


#: the batched GEMM's batches and rows at each shape; the rows and batches
#: whose prefixes must be bitwise the whole input's.  At deepseek's expert
#: widths (11 column tiles) 240 rows are 22 tiles a batch: 6 batches are
#: exactly one wave of the bf16 grid, 7 one over, 24 four waves; 30 rows
#: are 11 tiles a batch, so 24 batches are two waves
BGEMM_GS = (1, 3, 6, 7, 8, 24)
BGEMM_MS = (1, 30, 80, 240, 640)
BGEMM_ROW_PREFIX = (1, 7, 30, 129)
BGEMM_BATCH_PREFIX = (1, 2, 5, 6, 7, 13)
#: shapes beside the families' that reach the split of K (qwen2's wk / wv)
#: and the guarded-load loader (hymba's dt_proj, xLSTM's gates)
BGEMM_EXTRA = ((1536, 256, torch.bfloat16), (100, 3200, torch.bfloat16),
               (2048, 4, torch.bfloat16))


def bgemm_cases(kg) -> dict:
    """``bgemm`` against ``bgemm_plain`` (``torch.bmm``) at every
    ``bgemm_shapes`` entry of the four families at 256 and 128 positions
    (and at ``BGEMM_EXTRA``), at G in ``BGEMM_GS`` and M in ``BGEMM_MS``,
    with and without a bias; rows of ``x[:, :m]`` and batches of
    ``x[:g]`` bitwise the same of ``x``.  Returns the max abs error a
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    shapes = set(BGEMM_EXTRA)
    for name, layers in INV_FAMILIES:
        for seq in (256, 128):
            shapes |= kg.bgemm_shapes(family_config(name, layers), seq)
    gmax, mmax = max(BGEMM_GS), max(BGEMM_MS)
    errs = {}
    for k, n, dt in sorted(shapes, key=lambda s: (str(s[2]), s[0], s[1])):
        f32 = dt == torch.float32
        atol, rtol = (GEMM_F32_ATOL, GEMM_F32_RTOL) if f32 else (GEMM_ATOL, GEMM_RTOL)
        w = (torch.randn(gmax, k, n, generator=gen, device="cuda") * k ** -0.5).to(dt)
        b = torch.randn(gmax, n, generator=gen, device="cuda").to(dt)
        x = torch.randn(gmax, mmax, k, generator=gen, device="cuda").to(dt)
        worst = 0.0
        for g in BGEMM_GS:
            for m in BGEMM_MS:
                for bias in (None, b[:g]):
                    args = (x[:g, :m], w[:g], bias)
                    worst = max(worst, held(
                        kg.bgemm(*args).flatten(0, 1), kg.bgemm_plain(*args).flatten(0, 1),
                        atol, rtol, f"bgemm {g}x{m}x{k}x{n} {dt}"))
        full = kg.bgemm(x, w, b)
        for m in BGEMM_ROW_PREFIX:
            check(torch.equal(kg.bgemm(x[:, :m], w, b), full[:, :m]),
                  f"bgemm {k}x{n} {dt}: the rows of x[:, :{m}] differ from the "
                  f"same rows of x")
        for g in BGEMM_BATCH_PREFIX:
            check(torch.equal(kg.bgemm(x[:g], w[:g], b[:g]), full[:g]),
                  f"bgemm {k}x{n} {dt}: the batches of x[:{g}] differ")
        cfg = kg.gemm_config(k, n, dt)
        errs[f"{k}x{n} {str(dt).split('.')[-1]}"] = worst
        log(f"bgemm {k}x{n} {dt} ({cfg.loader}, BN {cfg.bn}, split {cfg.split}): "
            f"max abs error {worst:.3e} at G {BGEMM_GS} x M {BGEMM_MS}; rows "
            f"invariant at {BGEMM_ROW_PREFIX}, batches at {BGEMM_BATCH_PREFIX}")
    return errs


def gemm_is_bgemm_of_one(kg) -> int:
    """``gemm(x, w, b) == bgemm(x[None], w[None], b[None])[0]`` bitwise at
    every ``Linear`` shape of qwen2-1.5b, 2,048 and 7 rows, with and
    without a bias: the 2-D launch and the batched one compute alike.
    Returns the shapes held."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(31)
    shapes = sorted(kg.linear_shapes(get_config("qwen2-1.5b")), key=str)
    for k, n, dt in shapes:
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dt)
        b = torch.randn(n, generator=gen, device="cuda").to(dt)
        x = torch.randn(2048, k, generator=gen, device="cuda").to(dt)
        for m in (2048, 7):
            for bias in (None, b):
                one = kg.bgemm(x[None, :m], w[None], None if bias is None else bias[None])
                check(torch.equal(kg.gemm(x[:m], w, bias), one[0]),
                      f"gemm {k}x{n} {dt} M={m}: the 2-D launch differs from "
                      f"the batched one")
    log(f"gemm == bgemm of one batch, bitwise, at qwen2's {len(shapes)} "
        f"Linear shapes")
    return len(shapes)


def bgemm_timings(kg) -> dict:
    """Device times (:func:`graph_ms`) of ``bgemm`` at the main path's
    shapes beside ``torch.bmm`` (its plain version and the library call):
    deepseek-v2-lite's and mixtral's expert products at batch buckets 8
    and 1 (G = E, M = groups x capacity), the mLSTM's score, inter-chunk
    and ``den`` products at xlstm's 8 x 256 and the sLSTM's step at batch
    8; and Mamba's readout at hymba's 8 x 256 chunk (G = B x L, M =
    d_inner, K = 16, N = 1) beside the einsum cuBLAS ran it as before."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    bf, f32 = torch.bfloat16, torch.float32
    cases = (("experts_wg deepseek", 64, 240, 2048, 1408, bf),
             ("experts_wg deepseek 1-row", 64, 30, 2048, 1408, bf),
             ("experts_wg mixtral", 8, 640, 4096, 14336, bf),
             ("experts_wo mixtral 1-row", 8, 80, 14336, 4096, bf),
             ("mamba_readout hymba", 2048, 3200, 16, 1, f32),
             ("mlstm_scores xlstm", 32, 256, 512, 256, f32),
             ("mlstm_inter xlstm", 32, 256, 512, 512, f32),
             ("mlstm_den xlstm", 8192, 1, 512, 1, f32),
             ("slstm_step xlstm", 4, 8, 256, 1024, f32))
    out = {}
    for name, g, m, k, n, dt in cases:
        x = torch.randn(g, m, k, generator=gen, device="cuda").to(dt)
        w = (torch.randn(g, k, n, generator=gen, device="cuda") * k ** -0.5).to(dt)
        size = 2 if dt == bf else 4
        b_ms, b_by = bound(2.0 * g * m * k * n, size * g * (m * k + k * n + m * n),
                           PEAK_BF16_FLOPS if dt == bf else PEAK_F32_FLOPS)
        key = f"bgemm {name} {g}x{m}x{k}x{n}"
        out[key] = timed(lambda: kg.bgemm(x, w), b_ms, b_by,
                         plain=lambda: kg.bgemm_plain(x, w),
                         library=lambda: torch.bmm(x, w))
        if name.startswith("mamba"):
            hh = x.view(8, 256, m, k)
            c = w.view(8, 256, k)
            out[key]["einsum_ms"] = graph_ms(
                lambda: torch.einsum("bsdn,bsn->bsd", hh, c))
    for name, t in out.items():
        extra = f", einsum {t['einsum_ms']:.4f} ms" if "einsum_ms" in t else ""
        log(f"timing {name}: {t['ms']:.4f} ms (L2-cold {t['ms_l2_cold']:.4f}), "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['kernel_over_bound']:.2f}x), torch.bmm {t['library_ms']:.4f} ms{extra}")
    return out


def readout_invariance() -> list:
    """Mamba's readout (``ssm.mamba_readout``: ``bgemm``'s dot instance at
    N = 1) at hymba's widths: the first row's output bitwise the same at 1
    to 64 rows of a 256- and a 128-position chunk.  Returns the (positions,
    rows) held."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("hymba-1.5b")
    d_inner, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    gen = torch.Generator(device="cuda").manual_seed(33)
    held = []
    for seq in (256, 128):
        hh = torch.randn(64, seq, d_inner, n, generator=gen, device="cuda")
        c = torch.randn(64, seq, n, generator=gen, device="cuda")
        one = ssm.mamba_readout(hh[:1], c[:1])
        for rows in (2, 3, 8, 16, 64):
            check(torch.equal(ssm.mamba_readout(hh[:rows], c[:rows])[:1], one),
                  f"Mamba's readout: the first row at {rows} rows of {seq} "
                  f"positions differs from the row alone")
            held.append((seq, rows))
        del hh, c
    log(f"Mamba's readout: the first row bitwise alone and among "
        f"{sorted({r for _, r in held})} rows at 256 and 128 positions")
    return held


def bucket_drains(dlm, solver: str | None, buckets=(1, 8, 64)) -> dict:
    """The eight one-row requests (seeds ``INV_SEEDS``, seq 256, nfe 10) of
    ``solver`` drained alone at batch bucket 1, fused into one 8-row
    replay, and (with 64 in ``buckets``) inside a 64-row replay among other
    seeds, each on an engine of that one bucket; returns {bucket: (the
    eight results, the engine)}."""
    from repro_torch.core import linear_schedule
    from repro_torch.serving import EngineConfig, SampleRequest, build_engine

    def engine(bucket):
        return build_engine(dlm, linear_schedule(), EngineConfig(
            solver=solver or "era", nfe=NFE, batch_buckets=(bucket,)))

    reqs = [SampleRequest(batch=1, seq_len=256, nfe=NFE, seed=s) for s in INV_SEEDS]
    out = {}
    for bucket in buckets:
        eng = engine(bucket)
        if bucket == 1:
            res = []
            for r in reqs:
                _, f = eng.submit_with_future(r)
                eng.drain()
                res.append(f.result())
        else:
            others = [SampleRequest(batch=8, seq_len=256, nfe=NFE, seed=s)
                      for s in INV_OTHERS] if bucket == 64 else []
            futs = [eng.submit_with_future(r)[1] for r in others[:4] + reqs + others[4:]]
            eng.drain()
            res = [f.result() for f in futs][len(others[:4]):][:len(reqs)]
        check(all(r.padded_batch == bucket for r in res),
              f"{solver or 'era'}: not padded to bucket {bucket}")
        out[bucket] = (res, eng)
    return out


def same_results(a, b) -> bool:
    """x0 and (ERA's) ERS selections bitwise equal."""
    from repro_torch.serving import result_keys

    key = result_keys.ERS_SELECTION_HISTORY
    return torch.equal(a.x0, b.x0) and (
        key not in a.aux or torch.equal(a.aux[key], b.aux[key]))


#: the families whose products do not all go through ``Linear``, each with
#: the depth phase 16 runs it at (mixtral cut to 4 of its 32 layers, as
#: phase 10 runs it; the others whole)
INV_FAMILIES = (("deepseek-v2-lite-16b", None), ("mixtral-8x7b", 4),
                ("hymba-1.5b", None), ("xlstm-350m", None))
#: the seed of the module probe's 8 rows
PROBE_SEED = 71


def family_config(name: str, layers: int | None):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg if layers is None else cfg.with_(num_layers=layers)


def module_probe(dlm) -> list:
    """One ``eps`` call on 8 rows of 256 positions and one on the first row
    alone, each with a forward hook on every module of the denoiser: the
    modules whose output for that row differs between the two calls, in
    the order their hooks fired (a module's children before it), each with
    its class and largest difference.  A module's part for the first row is
    the prefix of its output along the first axis whose size differs
    between the calls (the batch, or the token groups of an expert
    buffer)."""
    gen = torch.Generator(device="cuda").manual_seed(PROBE_SEED)
    x = torch.randn(8, 256, dlm.config.d_model, generator=gen, device="cuda")
    runs, records = [], []

    def hook(name):
        def fn(mod, args, out):
            t = out[0] if isinstance(out, tuple) else out
            if isinstance(t, torch.Tensor):
                records.append((name, type(mod).__name__, t.detach().clone()))
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in dlm.named_modules() if n]
    try:
        for rows in (x[:1], x):
            records.clear()
            with torch.no_grad():
                dlm.eps(rows, 0.5)
            runs.append(list(records))
    finally:
        for h in handles:
            h.remove()
    check([r[0] for r in runs[0]] == [r[0] for r in runs[1]],
          "module probe: the two calls ran other modules")
    out = []
    for (name, cls, one), (_, _, eight) in zip(*runs):
        if one.dim() == eight.dim():
            for d in range(one.dim()):
                if one.shape[d] != eight.shape[d]:
                    eight = eight.narrow(d, 0, one.shape[d])
                    break
        if one.shape != eight.shape:
            out.append(dict(module=name, cls=cls, shapes=[list(one.shape),
                                                          list(eight.shape)]))
        elif not torch.equal(one, eight):
            out.append(dict(module=name, cls=cls, max_abs=float(
                (one.float() - eight.float()).abs().max())))
    del runs, records
    return out


def bucket_reading(dlm, buckets=(1, 8, 64)) -> dict:
    """The eight one-row requests of :func:`bucket_drains` at ``buckets``
    (1 first): each later bucket's largest ``|x0|`` difference from bucket
    1, its requests and ERS selection entries that differ; the largest
    difference and the differing requests over all of them.  Nothing is
    checked."""
    from repro_torch.serving import result_keys

    d = bucket_drains(dlm, None, buckets=buckets)
    torch.cuda.synchronize()
    key = result_keys.ERS_SELECTION_HISTORY
    out = dict(by_bucket={},
               ers_entries=int(d[1][0][0].aux[key].numel()) * len(d[1][0]))
    for bucket in buckets[1:]:
        dx, sel, reqs = 0.0, 0, 0
        for a, b in zip(d[1][0], d[bucket][0]):
            diff = float((a.x0.float() - b.x0.float()).abs().max())
            dx = max(dx, diff)
            n_sel = int((a.aux[key] != b.aux[key]).sum())
            sel += n_sel
            reqs += int(diff > 0 or n_sel > 0)
        out["by_bucket"][bucket] = dict(max_abs_dx0=dx, requests_differ=reqs,
                                        ers_entries_differ=sel)
    out["max_abs_dx0"] = max(r["max_abs_dx0"] for r in out["by_bucket"].values())
    out["requests_differ"] = sum(r["requests_differ"] for r in out["by_bucket"].values())
    del d
    return out


def family_invariance(name: str, layers: int | None, counted: dict) -> dict:
    """One family's denoiser at full width (``layers`` cut when given): the
    module probe (:func:`module_probe`), then :func:`bucket_reading` at
    batch buckets 1, 8 and 64 with the drains' launches of each wrapper of
    ``counted`` ({name: wrapper}), counted from 0; fails unless every
    request and every module is bitwise the same."""
    t0 = time.perf_counter()
    dlm = build_dlm(family_config(name, layers))
    probe = module_probe(dlm)
    reset_counts(*counted.values())
    report = bucket_reading(dlm)
    report.update(modules_differ=len(probe), first_modules=probe[:6])
    report["launches"] = {n: w.launches for n, w in counted.items()}
    report["wall_s"] = time.perf_counter() - t0
    log(f"invariance {name}{'' if layers is None else f' ({layers} layers)'}: "
        f"against bucket 1 {json.dumps(report['by_bucket'])} of "
        f"{report['ers_entries']} ERS entries; {report['modules_differ']} "
        f"modules differ, first {json.dumps(report['first_modules'])}; "
        f"launches {report['launches']} ({report['wall_s']:.1f}s)")
    check(report["requests_differ"] == 0 and not report["modules_differ"],
          f"{name}: x0 differs across batch buckets: {report['by_bucket']}; "
          f"modules {report['first_modules']}")
    del dlm
    reserved_mb()
    return report


def phase_batch_invariance(ku, kf, kd, kg, kr, dlm):
    """The reference's determinism contract (``docs/serving.md``) on the
    card at full width: a request's ``x0`` and ERS selections bitwise the
    same at batch buckets 1, 8 and 64, a 200-position request bitwise the
    same exact and padded to 256, every solver program bitwise at buckets 1
    and 8, whisper-base's denoiser (LayerNorm) at buckets 1 and 8, and the
    families of ``INV_FAMILIES`` at buckets 1, 8 and 64; then the kernels
    behind it held against their plain versions and timed.
    Returns the launches of the served drains and a report."""
    from repro_torch.configs import get_config
    from repro_torch.core import linear_schedule, solver_names
    from repro_torch.serving import BatchedSampler, SampleRequest, result_keys

    wrappers = (ku.era_update, kf.flash_attention, kd.decode_attention, kg.gemm,
                kr.rmsnorm, kr.layernorm, kr.row_sq_sums, kg.bgemm)
    names = ("era_update", "flash_attention", "decode_attention", "gemm",
             "rmsnorm", "layernorm", "row_sq_sums", "bgemm")
    t_phase = time.perf_counter()
    report = {}

    # ERA at buckets 1, 8 and 64: the main path of this phase, counted
    reset_counts(*wrappers)
    drains = bucket_drains(dlm, None)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in zip(names, wrappers)}
    for n in ("era_update", "flash_attention", "gemm", "rmsnorm", "row_sq_sums"):
        check(launches[n] > 0, f"the bucket drains launched no {n}")
    check(launches["decode_attention"] == 0 and launches["layernorm"] == 0
          and launches["bgemm"] == 0, f"the ERA drains launched {launches}")
    one = drains[1][0]
    for bucket in (8, 64):
        for i, (a, b) in enumerate(zip(one, drains[bucket][0])):
            check(torch.equal(a.x0, b.x0),
                  f"seed {i}: x0 at bucket {bucket} differs from bucket 1 by "
                  f"{float((a.x0.float() - b.x0.float()).abs().max())}")
            check(torch.equal(a.aux[result_keys.ERS_SELECTION_HISTORY],
                              b.aux[result_keys.ERS_SELECTION_HISTORY]),
                  f"seed {i}: ERS selections at bucket {bucket} differ")
    log(f"invariance: 8 requests' x0 and ERS selections bitwise the same at "
        f"batch buckets 1, 8 and 64; launches {launches} "
        f"({time.perf_counter() - t_phase:.1f}s)")

    # the 8-row and the 1-row replay: wall (after capture) and busy time
    for bucket, rows in ((8, INV_SEEDS), (1, INV_SEEDS[:1])):
        eng = drains[bucket][1]
        reqs = [SampleRequest(batch=1, seq_len=256, nfe=NFE, seed=s) for s in rows]

        def submit():
            for r in reqs:
                eng.submit_with_future(r)

        walls = []
        for _ in range(3):
            submit()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.drain()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[1]
        submit()
        idle, _, _, busy = profile_device(eng.drain, f"ERA {bucket}x256 replay",
                                          wall, NFE, "NFE")
        report[f"era_{bucket}x256_replay"] = dict(wall_ms=wall, walls_ms=walls,
                                                  busy_ms=busy, idle_share=idle)
    del drains

    # a 200-position request exact and padded to seq bucket 256
    req = SampleRequest(batch=1, seq_len=INV_PAD, nfe=NFE, seed=21)
    exact = BatchedSampler(dlm, linear_schedule(), batch_buckets=(1,))
    padded = BatchedSampler(dlm, linear_schedule(), batch_buckets=(8,),
                            seq_buckets=(256,))
    res = []
    for eng in (exact, padded):
        _, f = eng.submit_with_future(req)
        eng.drain()
        res.append(f.result())
    check(res[0].padded_seq_len == INV_PAD and res[1].padded_seq_len == 256,
          "the padding case did not run exact and padded")
    check(same_results(res[0], res[1]),
          f"{INV_PAD} positions padded to 256 differ from exact by "
          f"{float((res[0].x0.float() - res[1].x0.float()).abs().max())}")
    log(f"invariance: a {INV_PAD}-position request bitwise the same exact "
        f"(bucket 1) and padded to 256 (bucket 8)")
    del exact, padded

    # every solver program of the registry at buckets 1 and 8
    for name in solver_names():
        d = bucket_drains(dlm, name, buckets=(1, 8))
        for i, (a, b) in enumerate(zip(d[1][0], d[8][0])):
            check(same_results(a, b),
                  f"{name} seed {i}: bucket 8 differs from bucket 1 by "
                  f"{float((a.x0.float() - b.x0.float()).abs().max())}")
        del d
    report["solvers_bitwise"] = solver_names()
    log(f"invariance: every solver program {solver_names()} bitwise the same "
        f"at buckets 1 and 8 ({time.perf_counter() - t_phase:.1f}s)")

    # whisper-base's denoiser (LayerNorm): buckets 1 and 8, counted
    wh = build_dlm(get_config("whisper-base"))
    reset_counts(*wrappers)
    d = bucket_drains(wh, None, buckets=(1, 8))
    torch.cuda.synchronize()
    wh_launches = {n: w.launches for n, w in zip(names, wrappers)}
    check(wh_launches["layernorm"] > 0 and wh_launches["gemm"] > 0,
          f"whisper's drains launched {wh_launches}")
    for i, (a, b) in enumerate(zip(d[1][0], d[8][0])):
        check(same_results(a, b), f"whisper-base seed {i}: bucket 8 differs "
              f"from bucket 1")
    for n, v in wh_launches.items():
        launches[n] += v
    log(f"invariance: whisper-base's 8 requests bitwise the same at buckets 1 "
        f"and 8; launches {wh_launches}")
    del d, wh
    reserved_mb()

    # the MoE, Mamba and xLSTM families (their products through bgemm): a
    # module probe and 8 requests at buckets 1, 8 and 64, counted
    report["families"] = {}
    for name, layers in INV_FAMILIES:
        r = family_invariance(name, layers, dict(zip(names, wrappers)))
        for n, v in r["launches"].items():
            launches[n] += v
        uses_bgemm = bool(kg.bgemm_shapes(family_config(name, layers), 256))
        check((r["launches"]["bgemm"] > 0) == uses_bgemm and r["launches"]["gemm"] > 0,
              f"{name}'s drains launched {r['launches']}")
        if name.startswith(("deepseek", "mixtral")):
            log(f"invariance {name}: no seq-padding check: a MoE layer's "
                f"capacity comes from the padded length in both packages "
                f"(ROADMAP queue 3, mirrored)")
        report["families"][name] = r
    log(f"invariance: {[n for n, _ in INV_FAMILIES]} bitwise at buckets 1, 8 "
        f"and 64 ({time.perf_counter() - t_phase:.1f}s)")

    report["gemm_max_abs_err"] = gemm_cases(kg)
    report["bgemm_max_abs_err"] = bgemm_cases(kg)
    report["gemm_is_bgemm_of_one"] = gemm_is_bgemm_of_one(kg)
    report["readout_rows_held"] = readout_invariance()
    report["rownorm_max_abs_err"] = rownorm_cases(kr)
    report["timings"] = rowkernel_timings(kg, kr) | bgemm_timings(kg)
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 16 took {report['wall_s']:.1f}s")
    return launches, report


# ---------------------------------------------------------------------------
# phase 10: the MoE and MLA families, and minitron-4b
# ---------------------------------------------------------------------------

# an 8x256 nfe=10 batch, and two requests fused into one seq-256 batch (one
# padded from 200, one exact)
FAM_REQ = (8, 256, 61)
FAM_FUSED = ((4, 200, 62), (4, 256, 63))
# AR: prompt and cache slots (phase 6's); deepseek generates 32 tokens,
# minitron 16
FAM_AR_PROMPT, FAM_AR_SLOTS = 512, 1024
# kernel-name fragments of a trace's rows: cuBLAS / CUTLASS GEMMs (the
# experts' batched products among them), and the MoE dispatch's index
# work (top-k, the rank's cumulative sum, the rank gather, the token copy
# into the capacity buffer, the combine's index_select)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
DISPATCH_NAMES = ("topk", "TopK", "sort", "Sort", "scan", "index", "Index",
                  "gather", "scatter")


def attn_layers(cfg) -> int:
    """Layers of ``cfg``'s block stack that attend (every kind but the
    xLSTM cells)."""
    return sum(n for kind, n in cfg.blocks if kind not in ("mlstm", "slstm"))


def ar_launches(cfg, gen: int) -> dict:
    """The kernel launches of one ``Engine.generate`` of ``gen`` tokens:
    one flash launch a layer at the prefill (whisper: also each encoder
    layer's, and each decoder layer's cross-attention), then one decode
    launch a layer and step (whisper: two, self and cross; MLA's absorbed
    decode launches none)."""
    audio = cfg.family == "audio"
    flash = attn_layers(cfg) * (2 if audio else 1) + cfg.num_encoder_layers
    per_step = 0 if cfg.mla is not None else attn_layers(cfg) * (2 if audio else 1)
    return {"era_update": 0, "flash_attention": flash,
            "decode_attention": per_step * (gen - 1)}


def drop_newest_prompt_entry(model, cache) -> None:
    """The AR check's default planted fault: the newest prompt entry's slot
    of every ring marked empty."""
    off = model.config.num_meta_tokens
    for ring in model.rings(cache):
        ring["pos"][off + FAM_AR_PROMPT - 1] = -1


def family_shares(rows, busy_ms: float) -> dict:
    """Shares of ``busy_ms`` taken by the (ms, count, name) ``rows`` of a
    trace: GEMMs, the MoE dispatch's index kernels, flash, era_update, and
    the rest of the rows (elementwise work)."""
    def ms(pick):
        return sum(r[0] for r in rows if pick(r[2]))

    gemm = ms(lambda n: any(g in n for g in GEMM_NAMES))
    flash = ms(lambda n: "flash_fwd_kernel" in n)
    era = ms(is_era_kernel)
    dispatch = ms(lambda n: any(g in n for g in DISPATCH_NAMES)
                  and not any(g in n for g in GEMM_NAMES)
                  and "flash_fwd_kernel" not in n)
    rest = sum(r[0] for r in rows) - gemm - flash - era - dispatch
    return {k: v / busy_ms for k, v in dict(
        gemm=gemm, moe_dispatch=dispatch, flash=flash, era_update=era,
        rest=rest).items()}


def family_era(ku, kf, kd, dlm, seq_buckets, *, fuse=False, profile=False,
               scans=False):
    """An 8x256 nfe=10 ERA batch served as a replay of the graph that
    ``warmup()`` captured (batch bucket 8 x ``seq_buckets``): exact launch
    counts, finite, copy-out, bitwise the same batch run eagerly through
    the bucket's program; with ``fuse``, two requests (200 and 256 long) in
    one seq-256 batch, each bitwise its solo drain; with ``profile``, the
    replay's busy time, idle share and device-time shares, and with
    ``scans`` the scans' share of a replay (:func:`scan_shares`).  Returns the
    launches of the served drains and a report."""
    from repro_torch.core import linear_schedule
    from repro_torch.serving import BatchedSampler, SampleRequest, result_keys

    cfg = dlm.config
    total = dict.fromkeys(COUNTED, 0)
    want = {"era_update": NFE - K + 1, "flash_attention": attn_layers(cfg) * NFE,
            "decode_attention": 0}

    def served(drain) -> dict:
        reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
        drain()
        torch.cuda.synchronize()
        counts = read_counts(ku, kf, kd)
        for k, v in counts.items():
            total[k] += v
        check(launches_are(counts, want), f"{cfg.name}: launches {counts} != {want}")
        return counts

    eng = BatchedSampler(dlm, linear_schedule(), batch_buckets=(8,),
                         seq_buckets=seq_buckets)
    mem0 = reserved_mb()
    t0 = time.perf_counter()
    rep = eng.warmup()
    warmup_s = time.perf_counter() - t0
    graph_mb = reserved_mb() - mem0
    check(rep["fresh"] == rep["programs"] == len(seq_buckets),
          f"{cfg.name} warmup: {rep}")
    b, seq, seed = FAM_REQ
    req = SampleRequest(batch=b, seq_len=seq, nfe=NFE, seed=seed)
    walls = []
    for i in range(3):
        _, fut = eng.submit_with_future(req)
        t0 = time.perf_counter()
        if i == 0:
            served(eng.drain)
        else:
            eng.drain()
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            res = fut.result()
            check(tuple(res.x0.shape) == (b, seq, cfg.d_model),
                  f"{cfg.name} x0 shape {tuple(res.x0.shape)}")
            check(bool(torch.isfinite(res.x0).all()), f"{cfg.name} x0 not finite")
            # copy-out: a replay with other noise leaves the result as it was
            kept = res.x0.clone()
            eng.submit_with_future(dataclasses.replace(req, seed=seed + 10))
            eng.drain()
            check(torch.equal(res.x0, kept), f"{cfg.name}: a replay changed a result")
        else:
            check(torch.equal(fut.result().x0, res.x0),
                  f"{cfg.name}: a repeated replay differs")
    replay_ms = sorted(walls)[1]
    check(eng.compile_stats()["fresh"] == len(seq_buckets),
          f"{cfg.name}: a drain captured a graph")

    # the same batch eagerly, through the bucket's program on this stream
    ex = eng.executor
    masked = ex.seq_masked("era")
    key = ("era", dataclasses.replace(ex.config_for("era"), nfe=NFE), b, seq,
           masked, False)
    x_init = ex.noise(req)
    lengths = (torch.full((b,), seq, dtype=torch.int32, device="cuda")
               if masked else None)

    # the bucket's capture already ran this program eagerly once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ex._run_program(key, x_init, lengths, None)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(out.x0, res.x0),
          f"{cfg.name}: replay differs from the eager run by "
          f"{float((out.x0 - res.x0).abs().max())}")
    check(torch.equal(out.aux[result_keys.ERS_SELECTION_HISTORY],
                      res.aux[result_keys.ERS_SELECTION_HISTORY]),
          f"{cfg.name}: ERS selections differ between replay and eager")
    report = dict(replay_ms=replay_ms, replay_ms_runs=walls, eager_ms=eager_ms,
                  warmup_s=warmup_s, graphs=rep["programs"], graph_mib=graph_mb,
                  x0_std=float(res.x0.std()))
    log(f"{cfg.name}: 8x256 nfe={NFE} replay {replay_ms:.1f} ms (median of "
        f"{[round(w, 1) for w in walls]}), eager {eager_ms:.1f} ms, replay == "
        f"eager bitwise, launches {want}; warmup of {rep['programs']} graphs "
        f"{warmup_s:.2f}s, {graph_mb:.0f} MiB")

    if fuse:
        reqs = [SampleRequest(batch=bb, seq_len=ss, nfe=NFE, seed=sd)
                for bb, ss, sd in FAM_FUSED]
        futs = [eng.submit_with_future(r)[1] for r in reqs]
        batches0 = eng.metrics.get("sampler_batches_total").value()
        served(eng.drain)
        batches = eng.metrics.get("sampler_batches_total").value() - batches0
        check(batches == 1, f"{cfg.name}: the fused drain ran {batches} batches")
        for r, f in zip(reqs, futs):
            fused = f.result()
            check(fused.padded_seq_len == 256 and fused.padded_batch == 8,
                  f"{cfg.name}: fused padding for {r}")
            _, solo = eng.submit_with_future(r)
            eng.drain()
            check(torch.equal(fused.x0, solo.result().x0),
                  f"{cfg.name}: {r.batch}x{r.seq_len} fused differs from its "
                  f"solo drain by {float((fused.x0 - solo.result().x0).abs().max())}")
        log(f"{cfg.name}: requests of 200 and 256 fused into one seq-256 batch, "
            f"each bitwise its solo drain")
        report["fused_equals_solo"] = True

    if profile:
        idle, busy, rows = profile_replays(
            lambda: eng.submit_with_future(req), eng.drain,
            f"{cfg.name}: graph replay of one 8x256 batch, nfe={NFE}",
            replay_ms, NFE, want["flash_attention"], want["era_update"])
        shares = family_shares(rows, busy)
        log(f"{cfg.name}: replay device busy {busy:.1f} ms, idle share "
            f"{idle:.3f}; shares {json.dumps({k: round(v, 4) for k, v in shares.items()})}")
        report.update(busy_ms=busy, idle_share=idle, shares=shares,
                      device_ops=sum(r[1] for r in rows))
    if scans:
        report["replay_breakdown"] = rb = scan_shares(
            ex, key, x_init, lengths, res.x0, report["busy_ms"])
        for name, r in rb["scans"].items():
            log(f"{cfg.name}: {name}: {r['ms_per_batch']:.1f} ms and "
                f"{r['device_ops']} device ops in {r['calls']} calls a batch, "
                f"{r['share']:.3f} of the marked replay's busy "
                f"{rb['busy_ms']:.1f} ms (served replay {busy:.1f} ms)")
        log(f"{cfg.name}: marked replay shares "
            f"{json.dumps({k: round(v, 4) for k, v in rb['shares'].items()})}")
    del eng
    return total, report


class PinnedMoE:
    """The AR logits check of a MoE model compares a decode step with a
    prefill, and in bf16 the two paths round differently: where a token's
    k-th and (k+1)-th router probabilities are close, the paths pick other
    experts, whose outputs differ by far more than the rounding, and over
    27 layers nearly every row meets such a flip; a check so run measures
    the flips, not the attention path.  So within the block every MoE layer
    takes a capacity that drops nothing (a prefill of S tokens drops
    assignments past int(S * k / E * 1.25) that a one-token decode keeps,
    as in the reference), ``record()`` keeps the routing of the next
    prefill, and ``replay(tokens)`` hands those tokens' recorded routing to
    the next call of each layer: the compared paths run the same experts
    with the same weights, and differ only as the attention path and its
    cache make them.  A model without MoE layers passes through."""

    def __init__(self, model):
        from repro_torch.models.moe import MoE

        self.moes = [m for m in model.modules() if isinstance(m, MoE)]
        self.routes = {}

    def __enter__(self):
        self.cfgs = [m.cfg for m in self.moes]
        for m in self.moes:
            e, k = m.cfg.moe.num_experts, m.cfg.moe.top_k
            m.cfg = m.cfg.with_(moe=dataclasses.replace(
                m.cfg.moe, capacity_factor=float(e) / k + 1))
        return self

    def __exit__(self, *exc):
        for m, c in zip(self.moes, self.cfgs):
            m.cfg = c
            m.__dict__.pop("route", None)

    def record(self):
        for m in self.moes:
            def route(x, token_dims, m=m):
                weights, ids, aux = type(m).route(m, x, token_dims)
                self.routes[m] = (weights, ids)
                return weights, ids, aux
            m.route = route

    def replay(self, tokens: slice):
        for m in self.moes:
            def route(x, token_dims, m=m):
                _, _, aux = type(m).route(m, x, token_dims)
                weights, ids = self.routes[m]
                return weights[:, tokens], ids[:, tokens], aux
            m.route = route


def family_ar(ku, kf, kd, model, gen: int, plant=drop_newest_prompt_entry,
              fault_name: str = "the newest prompt entry dropped"):
    """``Engine.generate`` (batch 8, prompt 512 after the config's prefix,
    ``gen`` tokens, 1024 slots) on a full-width token model: launch counts,
    tokens in the vocabulary, the step-by-step loop equal to generate,
    decode ms a step; the decode logits at three steps against a fresh
    prefill's (MoE routing pinned, :class:`PinnedMoE`), and a planted fault
    (``plant(model, cache)`` after the prefill; by default the newest
    prompt entry of the cache dropped) that the check must see; the decode
    loop's idle share.  The audio and vlm families get their stub inputs
    (frames, image patches) from ``frontend_features`` with the prompts'
    seeded generator, as the launcher draws them."""
    import numpy as np

    from repro_torch.data import frontend_features
    from repro_torch.serving import Engine, ServeConfig

    cfg = model.config
    eng = Engine(model, ServeConfig(max_len=FAM_AR_SLOTS))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (AR_BATCH, FAM_AR_PROMPT))
    ).to(torch.int32).cuda()
    extras = {}
    if cfg.frontend is not None:
        extras["frames" if cfg.family == "audio" else "patches"] = torch.from_numpy(
            frontend_features(rng, AR_BATCH, cfg.frontend.num_positions,
                              cfg.d_model)).cuda()
    # decode positions follow the meta tokens and the image patches
    off = cfg.num_meta_tokens + (extras["patches"].shape[1]
                                 if "patches" in extras else 0)
    eng.generate(prompts, gen, extras=extras)  # warm: cuBLAS plans, allocator
    torch.cuda.synchronize()
    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
    t0 = time.perf_counter()
    toks = eng.generate(prompts, gen, extras=extras)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = read_counts(ku, kf, kd)
    want = ar_launches(cfg, gen)
    check(launches_are(launches, want), f"{cfg.name} AR launches {launches} != {want}")
    check(tuple(toks.shape) == (AR_BATCH, gen), f"{cfg.name} generated shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{cfg.name}: a generated token is outside the vocabulary")

    # step by step, timed: the same tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill_step(prompts, extras=extras)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nxt = [eng.sample_token(logits)]
    for i in range(gen - 1):
        logits, cache = eng.decode_step(cache, nxt[-1][:, None],
                                        off + FAM_AR_PROMPT + i)
        nxt.append(eng.sample_token(logits))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(torch.stack(nxt, dim=1), toks),
          f"{cfg.name}: step-by-step tokens differ")
    prefill_ms, decode_wall_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    per_step = decode_wall_ms / (gen - 1)
    log(f"{cfg.name} AR: generate {tuple(toks.shape)} in {gen_s:.3f}s, prefill "
        f"{prefill_ms:.2f} ms, decode {per_step:.3f} ms a step, launches {launches}")

    # decode vs prefill logits: at three steps, the last-token logits of a
    # prefill over the prompt and the tokens generated before the step,
    # against a decode of that token from the cache of a prefill of the
    # rest; then the same with a planted fault in the cache that the check
    # must see.  MoE models run it with the routing pinned (PinnedMoE)
    steps = (1, gen // 2, gen - 1)
    ratios, fault = [], None
    with PinnedMoE(model) as pin:
        for i in steps:
            seq = torch.cat([prompts, toks[:, :i]], dim=1)
            n = seq.shape[1]
            pin.record()
            ref = model.prefill(seq, FAM_AR_SLOTS, **extras)[0].float()
            for planted in ((False, True) if i == steps[-1] else (False,)):
                pin.replay(slice(0, n - 1))
                _, c = model.prefill(seq[:, :-1], FAM_AR_SLOTS, **extras)
                if planted:
                    plant(model, c)
                pin.replay(slice(n - 1, n))
                lg = model.decode(c, seq[:, -1:], off + n - 1)[0].float()
                r = float((lg - ref).abs().max()) / float(ref.abs().max())
                if planted:
                    fault = r
                else:
                    ratios.append(r)
    tol = AR_LOGIT_RTOL[cfg.family]
    log(f"{cfg.name}: decode vs prefill logits at steps {steps}: ratios "
        f"{[round(r, 4) for r in ratios]}; {fault:.4f} with {fault_name} "
        f"(tolerance {tol})")
    check(max(ratios) <= tol < fault,
          f"{cfg.name}: the logits check does not tell {fault_name} from "
          f"the served path: {ratios}, {fault}")

    idle, n_ops, _, busy = profile_decode_loop(
        eng, prompts, off + FAM_AR_PROMPT, f"{cfg.name} decode loop", extras)
    del eng
    return launches, dict(prefill_ms=prefill_ms, decode_ms_per_step=per_step,
                          tok_s=AR_BATCH * gen / gen_s, idle_share=idle,
                          busy_ms=busy, profiled_steps=PROFILED_STEPS,
                          ops_per_step=n_ops / PROFILED_STEPS,
                          logit_ratios=ratios, fault_ratio=fault)


def token_model(cfg):
    """The full-width token model of ``cfg`` on the card, random weights
    from seed 0, and its parameter count."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"AR model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model}, "
        f"{n / 1e9:.3f}B params, built in {time.perf_counter() - t0:.1f}s")
    return model, n


def phase_families(ku, kf, kd):
    """deepseek-v2-lite-16b at full width (denoiser, then token model),
    minitron-4b at full width (denoiser, token model), mixtral-8x7b at full
    width cut to 4 of its 32 layers (denoiser); one model on the card at a
    time.  Returns the launches of the served runs and a report."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTED, 0)
    report = {}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    ds = get_config("deepseek-v2-lite-16b")
    check((ds.num_layers, ds.d_model, ds.num_heads, ds.mla.kv_lora_rank,
           ds.moe.num_experts, ds.moe.top_k, ds.moe.num_shared,
           ds.moe.d_ff_expert, ds.dtype)
          == (27, 2048, 16, 512, 64, 6, 2, 1408, torch.bfloat16),
          f"unexpected config {ds}")
    dlm = build_dlm(ds)
    n_dlm = sum(p.numel() for p in dlm.parameters())
    counts, era = family_era(ku, kf, kd, dlm, SEQ_BUCKETS, fuse=True, profile=True)
    add(counts)
    del dlm
    reserved_mb()
    model, n_model = token_model(ds)
    counts, ar = family_ar(ku, kf, kd, model, gen=32)
    add(counts)
    del model
    reserved_mb()
    report[ds.name] = dict(params_denoiser=n_dlm, params_token_model=n_model,
                           era=era, ar=ar)

    mt = get_config("minitron-4b")
    check((mt.num_layers, mt.d_model, mt.num_heads, mt.num_kv_heads)
          == (32, 3072, 24, 8), f"unexpected config {mt}")
    dlm = build_dlm(mt)
    counts, era = family_era(ku, kf, kd, dlm, (256,))
    add(counts)
    del dlm
    reserved_mb()
    model, n_model = token_model(mt)
    counts, ar = family_ar(ku, kf, kd, model, gen=16)
    add(counts)
    del model
    reserved_mb()
    report[mt.name] = dict(params_token_model=n_model, era=era, ar=ar)

    mx = get_config("mixtral-8x7b").with_(num_layers=4)
    dlm = build_dlm(mx)
    n_dlm = sum(p.numel() for p in dlm.parameters())
    counts, era = family_era(ku, kf, kd, dlm, (256,))
    add(counts)
    del dlm
    reserved_mb()
    report[mx.name] = dict(params_denoiser=n_dlm, era=era,
                           reduced="4 of 32 layers")
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"families phase: {report['wall_s']:.1f}s")
    return total, report


# ---------------------------------------------------------------------------
# phase 11: the SSM and hybrid families
# ---------------------------------------------------------------------------


#: the scans of ``repro_torch.models.ssm`` whose device time phase 11
#: attributes: function name -> the name it is reported under
SCAN_FNS = {"chunked_ssm_outputs": "mamba_chunk_scan",
            "mlstm_chunkwise": "mlstm_chunkwise",
            "slstm_scan": "slstm_time_loop"}


#: part of the name of the kernel ``torch.cuda._sleep`` launches
#: (``at::cuda::(anonymous namespace)::spin_kernel(long)``); phase 11's
#: markers are found by it in the marked replay's own trace, since a
#: separate trace of a few markers alone is short enough for the profiler
#: to drop whole
MARKER_KERNEL = "spin_kernel"


def device_timeline(fn) -> list:
    """The device events (kernels, memcpy, memset) of ``fn`` under
    torch.profiler, in the order they started: (start us, ms, name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(
        (e.time_range.start, (e.time_range.end - e.time_range.start) / 1e3,
         e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))


def scan_shares(ex, key, x_init, lengths, x0, served_busy_ms: float) -> dict:
    """Where a replay's device time goes, the scans apart: the bucket's
    program (``key``, on the served batch's ``x_init`` and ``lengths``)
    captured again with a marker kernel (``torch.cuda._sleep(1)``, traced
    under a name holding :data:`MARKER_KERNEL`) before and after each call
    of a scan of :data:`SCAN_FNS`, its replay profiled, and each device
    event between a pair of markers given to that call's scan.  The marked
    replay must give the served result ``x0`` bitwise.  Returns each scan's device ms, ops and calls in one batch, and the
    shares of the replay's busy time (markers excluded): the scans (their
    own products included), then the rest as :func:`family_shares` splits
    it; the shares add up to 1."""
    from repro_torch.models import ssm as S

    calls, saved = [], {f: getattr(S, f) for f in SCAN_FNS}

    def marked(f):
        def run(*args, **kw):
            calls.append(SCAN_FNS[f])
            torch.cuda._sleep(1)
            out = saved[f](*args, **kw)
            torch.cuda._sleep(1)
            return out
        return run

    static = x_init.clone()
    graph = torch.cuda.CUDAGraph()
    for f in SCAN_FNS:
        setattr(S, f, marked(f))
    try:
        with torch.cuda.graph(graph):
            out = ex._run_program(key, static, lengths, None)
    finally:
        for f, fn in saved.items():
            setattr(S, f, fn)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(out.x0, x0), "the marked replay differs from the served one")
    for attempt in range(3):
        events = device_timeline(graph.replay)
        names = {e[2] for e in events if MARKER_KERNEL in e[2]}
        n_marks = sum(1 for e in events if e[2] in names)
        if len(names) == 1 and n_marks == 2 * len(calls):
            break
        log(f"marked replay trace {attempt}: {n_marks} markers of "
            f"{2 * len(calls)} under {sorted(names)}; traced again")
    else:
        raise RuntimeError("chip_smoke: FAILED: no trace of the marked replay "
                           "holds every marker")
    marker = names.pop()
    scans = {name: dict(ms_per_batch=0.0, device_ops=0, calls=0)
             for name in dict.fromkeys(calls)}
    outside, inside, k = [], None, 0
    for _, ms, name in events:
        if name == marker:
            if inside is None:
                inside, k = scans[calls[k]], k + 1
                inside["calls"] += 1
            else:
                inside = None
        elif inside is None:
            outside.append((ms, 1, name))
        else:
            inside["ms_per_batch"] += ms
            inside["device_ops"] += 1
    busy = sum(ms for _, ms, name in events if name != marker)
    for r in scans.values():
        r.update(ms_per_call=r["ms_per_batch"] / r["calls"],
                 share=r["ms_per_batch"] / busy)
    shares = {name: r["share"] for name, r in scans.items()}
    shares.update(family_shares(outside, busy))
    del graph, out
    return dict(scans=scans, shares=shares, busy_ms=busy,
                served_busy_ms=served_busy_ms, markers=n_marks)


def hymba_flash_timings(kf) -> dict:
    """The flash kernel at hymba-1.5b's shapes (H=25, KV=5, hd 64): phase
    11's non-causal 8x256 batch (window 1024, row lengths 200 x4, 256 x4)
    and its causal 8x640 AR prefill (window 1024, 128 protected); device
    time beside its plain version, one SDPA call on the same inputs (the
    row lengths as a boolean mask built outside the timed call; the window
    reaches past both sequences and the prefill is causal, so no other mask
    is needed) and the bound (the keys each row's lengths leave)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8)
    h, kvh, hd, g = HY_H, HY_KV, HY_HD, HY_H // HY_KV
    out = {}
    for name, b, s, causal in (("era_8x256", 8, 256, False),
                               ("ar_prefill", AR_BATCH, HY_PREFILL, True)):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        pos = torch.arange(s, dtype=torch.int32, device="cuda")
        if causal:
            kw = dict(causal=True, window=HY_WINDOW, protected=HY_META)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

            def sdpa(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            pairs = float(b * s * (s + 1) / 2)
        else:
            mask = fused_kv_mask("cuda")
            kw = dict(causal=False, window=HY_WINDOW, kv_mask=mask)
            lens = mask.sum(1)
            qf = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(
                b, kvh, g * s, hd)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            am = mask.bool()[:, None, None, :]

            def sdpa(qf=qf, kt=kt, vt=vt, am=am):
                return F.scaled_dot_product_attention(qf, kt, vt, attn_mask=am)
            pairs = float(s * lens.sum())
        flops = 4.0 * h * hd * pairs
        nbytes = 2.0 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        def kernel(q=q, k=k, v=v, pos=pos, kw=kw):
            return kf.flash_attention(q, k, v, pos, pos, **kw)
        t = dict(
            ms=device_ms(kernel, pick=is_flash_kernel, kernels=1),
            ms_l2_cold=device_ms(kernel, cold=True, pick=is_flash_kernel, kernels=1),
            plain_ms=device_ms(
                lambda: kf.flash_attention_plain(q, k, v, pos, pos, **kw), iters=5),
            library_ms=device_ms(sdpa),
            library_ms_l2_cold=device_ms(sdpa, cold=True),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape=f"B={b} S={s} H={h} KV={kvh} hd={hd} bf16 "
                  + ("causal window=1024 protected=128" if causal
                     else "window=1024 row lengths 200 x4, 256 x4"),
        )
        t["kernel_over_library"] = t["ms"] / t["library_ms"]
        log(f"flash_attention timing (hymba) {t['shape']}: kernel "
            f"{t['ms']:.5f} ms L2-warm, {t['ms_l2_cold']:.5f} ms L2-cold; plain "
            f"{t['plain_ms']:.5f} ms; SDPA {t['library_ms']:.5f} / "
            f"{t['library_ms_l2_cold']:.5f} ms; kernel_over_library "
            f"{t['kernel_over_library']:.3f}; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
        out[name] = t
    return out


def hymba_decode_inputs(empty: int):
    """hymba-1.5b's decode shapes (B=8, H=25, KV=5, 1024 slots, hd 64): q,
    the cache, the query position as a (1,) int32 tensor on the card and
    the slot positions (the last ``empty`` slots empty)."""
    b, s = AR_BATCH, AR_MAX_LEN
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(b, HY_H, HY_HD, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, s, HY_KV, HY_HD, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    pos[s - empty:] = -1
    q_pos = torch.tensor([s - empty - 1], dtype=torch.int32, device="cuda")
    return q, k, v, q_pos, pos


def phase_ssm_hybrid(ku, kf, kd):
    """xlstm-350m and hymba-1.5b at full width, one model on the card at a
    time: the denoiser's ERA replay (with the scans' shares), then the
    token model's AR generate with its planted fault.  Returns the launches of the served runs and a report
    keyed by model name."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTED, 0)
    report = {}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def mark(what):
        log(f"phase 11: {what} at {time.perf_counter() - t_phase:.1f}s")

    xl = get_config("xlstm-350m")
    check((xl.num_layers, xl.d_model, xl.num_heads, xl.blocks, xl.dtype)
          == (24, 1024, 4, (("mlstm", 7), ("slstm", 1)) * 3, torch.bfloat16),
          f"unexpected config {xl}")
    hy = get_config("hymba-1.5b")
    check((hy.num_layers, hy.d_model, hy.num_heads, hy.num_kv_heads,
           hy.resolved_head_dim, hy.ssm.expand * hy.d_model, hy.num_meta_tokens,
           hy.sliding_window, hy.dtype)
          == (32, 1600, HY_H, HY_KV, HY_HD, 3200, HY_META, HY_WINDOW,
              torch.bfloat16), f"unexpected config {hy}")

    def zero_mlstm_c(model, cache):
        cache["0_mlstm"]["c"][0].zero_()

    def overwrite_protected(model, cache):
        # what a ring that did not protect its meta slots would hold: the
        # newest 128 prompt entries' K and V over slots 0-127 in every layer
        end = HY_META + FAM_AR_PROMPT
        for ring in model.rings(cache):
            for kv in ("k", "v"):
                ring[kv][:, :, :HY_META] = ring[kv][:, :, end - HY_META:end]

    faults = {xl.name: (zero_mlstm_c, "mLSTM layer 0's c zeroed"),
              hy.name: (overwrite_protected,
                        "the 128 protected slots' K and V overwritten")}
    for cfg in (xl, hy):
        dlm = build_dlm(cfg)
        n_dlm = sum(p.numel() for p in dlm.parameters())
        counts, era = family_era(ku, kf, kd, dlm, SEQ_BUCKETS, fuse=True,
                                 profile=True, scans=True)
        era["ops_per_nfe"] = era["device_ops"] / NFE
        add(counts)
        del dlm
        reserved_mb()
        mark(f"{cfg.name} ERA served and profiled")
        model, n_model = token_model(cfg)
        plant, name = faults[cfg.name]
        counts, ar = family_ar(ku, kf, kd, model, gen=32, plant=plant,
                               fault_name=name)
        add(counts)
        del model
        reserved_mb()
        mark(f"{cfg.name} AR done")
        report[cfg.name] = dict(params_denoiser=n_dlm, params_token_model=n_model,
                                era=era, ar=ar)
    report["ssm_hybrid_wall_s"] = time.perf_counter() - t_phase
    log(f"SSM and hybrid phase: {report['ssm_hybrid_wall_s']:.1f}s")
    return total, report


# ---------------------------------------------------------------------------
# phase 12: the audio and vlm families
# ---------------------------------------------------------------------------


def phase_audio_vlm(ku, kf, kd):
    """whisper-base and paligemma-3b at full width, one model on the card at
    a time: the denoiser's ERA replay (profiled), then the token model's AR
    generate with the stub frames / patches and a planted fault.  Returns
    the launches of the served runs and a report keyed by model name."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTED, 0)
    report = {}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def mark(what):
        log(f"phase 12: {what} at {time.perf_counter() - t_phase:.1f}s")

    wh = get_config("whisper-base")
    check((wh.num_layers, wh.num_encoder_layers, wh.d_model, wh.num_heads,
           wh.num_kv_heads, wh.resolved_head_dim, wh.frontend.num_positions,
           wh.max_position, wh.blocks, wh.dtype)
          == (6, 6, 512, WH_H, WH_H, WH_HD, WH_FRAMES, 524288, (("xdec", 6),),
              torch.bfloat16), f"unexpected config {wh}")
    pg = get_config("paligemma-3b")
    check((pg.num_layers, pg.d_model, pg.num_heads, pg.num_kv_heads,
           pg.resolved_head_dim, pg.d_ff, pg.mlp_act, pg.frontend.num_positions,
           pg.dtype)
          == (18, 2048, PG_H, PG_KV, PG_HD, 16384, "gelu", PG_PATCHES,
              torch.bfloat16), f"unexpected config {pg}")

    def zero_xk(model, cache):
        # one decoder layer's cross-attention keys lost after the prefill
        cache["0_xdec"]["xk"][0].zero_()

    def overwrite_patch_keys(model, cache):
        # the 256 patch slots' K in every layer overwritten with the newest
        # 256 prompt entries': the image the decode steps attend to is gone
        for ring in model.rings(cache):
            ring["k"][:, :, :PG_PATCHES] = ring["k"][:, :, PG_PREFILL - PG_PATCHES:PG_PREFILL]

    faults = {wh.name: (zero_xk, "layer 0's xk zeroed"),
              pg.name: (overwrite_patch_keys,
                        "the 256 patch slots' K overwritten")}
    for cfg in (wh, pg):
        dlm = build_dlm(cfg)
        n_dlm = sum(p.numel() for p in dlm.parameters())
        counts, era = family_era(ku, kf, kd, dlm, SEQ_BUCKETS, fuse=True,
                                 profile=True)
        era["ops_per_nfe"] = era["device_ops"] / NFE
        add(counts)
        del dlm
        reserved_mb()
        mark(f"{cfg.name} ERA served and profiled")
        model, n_model = token_model(cfg)
        plant, name = faults[cfg.name]
        counts, ar = family_ar(ku, kf, kd, model, gen=32, plant=plant,
                               fault_name=name)
        add(counts)
        del model
        reserved_mb()
        mark(f"{cfg.name} AR done")
        report[cfg.name] = dict(params_denoiser=n_dlm, params_token_model=n_model,
                                era=era, ar=ar)
    report["audio_vlm_wall_s"] = time.perf_counter() - t_phase
    log(f"audio and vlm phase: {report['audio_vlm_wall_s']:.1f}s")
    return total, report


# ---------------------------------------------------------------------------
# phase 13: training (the flash backward kernel, full-width qwen2-1.5b)
# ---------------------------------------------------------------------------

# |kernel - plain| <= BWD_RTOL * max|plain|, per gradient: the kernel rounds
# P and dS to bf16 before their products (2^-9 relative a term) and its
# gradients to bf16 (2^-9), against the plain version's float32; measured
# 2^-8.2 to 2^-7.5 of the largest gradient on the H100, so 2^-6 leaves a
# margin of 3 or more
BWD_RTOL = 2 ** -6
# |lse - plain| <= LSE_ATOL (base 2): the kernel's m * mul + log2(l), l a
# float32 sum of at most 1280 terms here (at most 1280 * 2^-24 = 7.6e-5
# relative, 1.1e-4 in log2), against float32 logsumexp of the same scores
LSE_ATOL = 2 ** -10
LOG2E = 1.4426950408889634
# training: batch x sequence of both objectives, and the steps of each
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_STEPS = {"diffusion": 10, "lm": 5}
# the other registry archs trained after qwen2-1.5b, one on the card at a time,
# at full width: arch -> (layers kept or None for all, batch).
# deepseek-v2-lite-16b's 27 layers take ~250 GB of training state (float32
# weights, gradients and AdamW's two moments: 16 bytes a parameter, ~585 M
# parameters a layer), so it keeps the first DS_TRAIN_LAYERS, the most that
# fit: on an H100 80GB (79.2 GiB) its LM step peaked at 71,689 MiB with 7
# layers, and an 8th adds ~9 GB.  hymba-1.5b trains at batch HY_TRAIN_BATCH:
# with its 128 meta tokens its LM step at batch 8 ran out of the card's
# memory (at batch 4 it peaked at 59,971 MiB).  minitron-4b, mixtral-8x7b and deepseek-67b are left out: their
# attention is hd 128, which qwen2-1.5b trains, and their sizes would only
# add chip time
DS_TRAIN_LAYERS = 7
HY_TRAIN_BATCH = 4
TRAIN_FAMILIES = {"llama3.2-1b": (None, TRAIN_BATCH),
                  "paligemma-3b": (None, TRAIN_BATCH),
                  "deepseek-v2-lite-16b": (DS_TRAIN_LAYERS, TRAIN_BATCH),
                  "whisper-base": (None, TRAIN_BATCH),
                  "hymba-1.5b": (None, HY_TRAIN_BATCH),
                  "xlstm-350m": (None, TRAIN_BATCH)}
FAMILY_TRAIN_STEPS = {"diffusion": 3, "lm": 2}
# the checkpoint round trip's model: qwen2-1.5b's widths, 2 of 28 layers
CKPT_LAYERS = 2


def lse_plain(kf, q, k, q_pos, kv_pos, *, kv_mask, window, causal, softcap,
              protected) -> torch.Tensor:
    """Each row's log-sum-exp as the forward's training instances write it:
    base 2, of the scaled (and softcapped) scores the masks keep, (B, H, Sq)
    float32 in float32 math, +inf for a row with no valid key."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * hd**-0.5
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = kf._valid(q, k, q_pos, kv_pos, kv_mask, window, causal, protected)
    lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), -1) * LOG2E
    lse = torch.where(valid.any(-1), lse, torch.full_like(lse, float("inf")))
    return lse.reshape(b, h, sq)


def bwd_case(kf, name, b, sq, sk, h, kvh, hd, *, causal, window=0,
             protected=0, lengths=None, softcap=0.0, empty_row=False,
             q_pos=None, hd_v=None) -> float:
    """The backward kernel through autograd of ``flash_attention``: its
    forward (the training instance) against ``flash_attention_plain`` at
    phase 3's tolerance and its lse against :func:`lse_plain`; its dq, dk,
    dv against ``flash_attention_bwd_plain`` given the plain output; two
    backward runs bitwise equal; returns the largest gradient error over
    max|plain|."""
    gen = torch.Generator(device="cuda").manual_seed(b * 131 + sq)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for s, n, d in ((sq, h, hd), (sk, kvh, hd), (sk, kvh, hd_v or hd)))
    q_pos = (torch.arange(sq, dtype=torch.int32, device="cuda")
             if q_pos is None else q_pos)
    kv_pos = torch.arange(sk, dtype=torch.int32, device="cuda")
    kv_mask = None
    if lengths is not None:
        kv_mask = (torch.arange(sk, device="cuda")[None]
                   < torch.tensor(lengths, device="cuda")[:, None]).to(torch.int32)
    if empty_row:
        kv_mask = torch.ones(b, sk, dtype=torch.int32, device="cuda")
        kv_mask[0] = 0
    opts = dict(kv_mask=kv_mask, window=window, causal=causal,
                softcap=softcap, protected=protected)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kf.flash_attention(*leaves, q_pos, kv_pos, **opts)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out.backward(dout)
    torch.cuda.synchronize()
    want = kf.flash_attention_plain(q, k, v, q_pos, kv_pos, **opts)
    excess = float(((out.detach().float() - want.float()).abs()
                    - FLASH_RTOL * want.float().abs()).max())
    check(excess <= FLASH_ATOL, f"flash backward {name}: the training forward "
          f"is {excess:.3e} beyond {FLASH_ATOL} + {FLASH_RTOL}*|o| of its plain version")
    out2, lse = kf._forward(q, k, v, q_pos, kv_pos, **opts, with_lse=True)
    check(torch.equal(out2, out.detach()), f"flash backward {name}: the LSE "
          "launch's output differs from the autograd forward's")
    lse_want = lse_plain(kf, q, k, q_pos, kv_pos, **opts)
    empty = torch.isinf(lse_want)
    check(torch.equal(torch.isinf(lse), empty) and bool((lse[empty] > 0).all()),
          f"flash backward {name}: lse is not +inf exactly on the empty rows")
    lse_err = float((lse[~empty] - lse_want[~empty]).abs().max()) if bool(
        (~empty).any()) else 0.0
    check(lse_err <= LSE_ATOL, f"flash backward {name}: lse error {lse_err:.3e} "
          f"over {LSE_ATOL}")
    plain = kf.flash_attention_bwd_plain(q, k, v, want, dout, q_pos, kv_pos,
                                         **opts)
    worst = 0.0
    for gname, leaf, p in zip(("dq", "dk", "dv"), leaves, plain):
        got = leaf.grad
        check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()),
              f"flash backward {name}: {gname} not finite bf16")
        scale = float(p.abs().max())
        err = float((got.float() - p).abs().max()) / max(scale, 1e-30)
        check(err <= BWD_RTOL, f"flash backward {name}: {gname} error {err:.3e} "
              f"of max|plain| {scale:.3e} over {BWD_RTOL}")
        worst = max(worst, err)
        # batch 0 has every key masked: its queries see none and its keys
        # are seen by none
        check(not empty_row or bool((got[0] == 0).all()),
              f"flash backward {name}: {gname} of a fully masked row is not 0")
    runs = [kf.flash_attention_bwd(q, k, v, out.detach(), dout, q_pos, kv_pos,
                                   lse=lse, **opts) for _ in range(2)]
    check(all(torch.equal(a, c) for a, c in zip(*runs)),
          f"flash backward {name}: two runs differ")
    log(f"flash backward {name}: forward within tolerance, lse error "
        f"{lse_err:.3e} (tolerance {LSE_ATOL:.3e}), gradients' max error "
        f"{worst:.3e} of max|plain| (tolerance {BWD_RTOL:.3e}), two runs "
        "bitwise equal")
    return worst


def bwd_instances(kf) -> tuple:
    """The head-dim pairs ``kf``'s backward has an instance of (a parent
    checkout of ``--bwd-ab`` may name fewer than its forward's)."""
    return getattr(kf, "BWD_HEAD_DIM_PAIRS", kf.HEAD_DIM_PAIRS)


def bwd_cases(kf) -> dict:
    """The backward kernel's cases: qwen2-1.5b's 8x256 diffusion batch with
    per-row lengths, its causal 8x512 (the AR prefill's shape), hymba-1.5b's
    hd 64 at G = 5 with window 1024 and 128 protected keys past the window,
    a ragged S, a fully masked row, queries offset from keys, softcap at hd
    32; deepseek-v2-lite's MLA (192, 128) at phase 10's causal 8x256 batch
    with row lengths 200 x3, 256 x5, paligemma's (256, 256) at phase 12's
    8x256 batch (H 8 over KV 1) with row lengths 200 x4, 256 x4, and each
    at a ragged S with a fully masked row (a ``kf`` whose backward lacks
    those pairs skips them and says so); then a CUDA call at (96, 96), a
    pair with no forward instance, must raise before any launch."""
    errs = {
        "qwen2 8x256 lengths": bwd_case(
            kf, "qwen2 8x256 lengths", 8, 256, 256, 12, 2, 128, causal=False,
            lengths=[256, 200] * 4),
        "qwen2 8x512 causal": bwd_case(
            kf, "qwen2 8x512 causal", 8, 512, 512, 12, 2, 128, causal=True),
        "hymba hd64 G5 window": bwd_case(
            kf, "hymba hd64 G5 window", 2, 1280, 1280, HY_H, HY_KV, HY_HD,
            causal=True, window=HY_WINDOW, protected=HY_META),
        "ragged S 200": bwd_case(kf, "ragged S 200", 2, 200, 200, 12, 2, 128,
                                 causal=True),
        "fully masked row": bwd_case(kf, "fully masked row", 2, 64, 96, 4, 2,
                                     64, causal=False, empty_row=True),
        "queries offset, window": bwd_case(
            kf, "queries offset, window", 2, 70, 300, 6, 6, 128, causal=True,
            window=64, protected=3,
            q_pos=torch.arange(230, 300, dtype=torch.int32, device="cuda")),
        "softcap hd32": bwd_case(kf, "softcap hd32", 2, 100, 130, 6, 1, 32,
                                 causal=False, softcap=5.0),
    }
    wide = {
        "MLA 8x256 causal lengths": dict(
            args=(8, 256, 256, MLA_H, MLA_H, MLA_HD), hd_v=MLA_HD_V,
            causal=True, lengths=[200] * 3 + [256] * 5),
        "MLA ragged S 200, fully masked row": dict(
            args=(2, 200, 200, MLA_H, MLA_H, MLA_HD), hd_v=MLA_HD_V,
            causal=True, empty_row=True),
        "paligemma 8x256 lengths": dict(
            args=(8, 256, 256, PG_H, PG_KV, PG_HD), causal=False,
            lengths=[200] * 4 + [256] * 4),
        "paligemma ragged S 200, fully masked row": dict(
            args=(2, 200, 200, PG_H, PG_KV, PG_HD), causal=False,
            empty_row=True),
    }
    for name, case in wide.items():
        case = dict(case)
        args = case.pop("args")
        pair = (args[-1], case.get("hd_v", args[-1]))
        if pair not in bwd_instances(kf):
            log(f"flash backward {name}: skipped, this backward has no {pair} "
                "instance")
            continue
        errs[name] = bwd_case(kf, name, *args, **case)
    q = torch.zeros(1, 8, 2, 96, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    pos = torch.arange(8, dtype=torch.int32, device="cuda")
    before = (kf.flash_attention.launches, kf.flash_attention_bwd.launches)
    try:
        kf.flash_attention(q, q, q, pos, pos)
    except ValueError as e:
        log(f"flash backward: (96, 96) refused: {e}")
    else:
        check(False, "flash_attention under grad at (96, 96) did not raise")
    check((kf.flash_attention.launches, kf.flash_attention_bwd.launches) == before,
          "the refused (96, 96) call launched")
    return errs


# the backward's launches, by kernel name: this design's (first) and PR
# 21's mma.sync design's, which ``--bwd-ab`` times beside it
BWD_LAUNCHES = {
    "prep": ("bwd_prep_kernel", "bwd_delta_kernel"),
    "dkdv": ("bwd_dkdv_wgmma_kernel", "bwd_dkdv_kernel"),
    "dq": ("bwd_dq_wgmma_kernel", "bwd_dq_kernel"),
}


def bwd_launch(name: str) -> str | None:
    """Which launch of the backward a kernel name is, or None."""
    for key, names in BWD_LAUNCHES.items():
        if any(n in name for n in names):
            return key
    return None


def is_bwd_kernel(name: str) -> bool:
    return bwd_launch(name) is not None


def bwd_pairs(sq: int, causal: bool, window: int, protected: int) -> float:
    """(query, key) pairs a head's masks keep, queries and keys at 0..S-1."""
    pos = torch.arange(sq, device="cuda")
    qp, kp = pos[:, None], pos[None, :]
    valid = torch.ones(sq, sq, dtype=torch.bool, device="cuda")
    if causal:
        valid &= kp <= qp
    if window > 0:
        valid &= (kp > qp - window) | (kp < protected)
    return float(valid.sum())


def bwd_timings(kf) -> dict:
    """Device time of the backward, L2-warm and L2-cold, and of each of its
    launches (the row preparation, dK/dV, dQ), beside its plain version and
    one autograd backward of SDPA on the same tensors, at qwen2-1.5b's
    diffusion shape (B=8, S=256, H=12, KV=2, hd=128, non-causal), its causal
    8x512 and hymba-1.5b's (B=2, S=1280, H=25, KV=5, hd 64, causal, window
    1024, 128 protected; SDPA given the mask as a boolean (S, S) tensor),
    and, where ``kf``'s backward has the pairs, deepseek-v2-lite's MLA
    (192, 128) at phase 10's 8x256 causal batch (H = KV = 16) and
    paligemma's (256, 256) at phase 12's 8x256 (H 8, KV 1, non-causal; every
    row whole); and the host time of one wrapper call (its enqueue: the
    tensor maps are encoded in each call)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(13)

    def timed(bb, ss, h, kvh, hd, causal, window=0, protected=0, hd_v=None):
        hd_v = hd_v or hd
        q, k, v = (torch.randn(bb, ss, n, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n, d in ((h, hd), (kvh, hd), (kvh, hd_v)))
        pos = torch.arange(ss, dtype=torch.int32, device="cuda")
        opts = dict(kv_mask=None, window=window, causal=causal, softcap=0.0,
                    protected=protected)
        out, lse = kf._forward(q, k, v, pos, pos, **opts, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        call = lambda: kf.flash_attention_bwd(  # noqa: E731
            q, k, v, out, dout, pos, pos, lse=lse, **opts)
        split = device_ms(call, pick=is_bwd_kernel, kernels=3, by=bwd_launch)
        split_cold = device_ms(call, cold=True, pick=is_bwd_kernel, kernels=3,
                               by=bwd_launch)
        ms, ms_cold = sum(split.values()), sum(split_cold.values())
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        plain_ms = device_ms(lambda: kf.flash_attention_bwd_plain(
            q, k, v, out, dout, pos, pos, **opts), iters=5)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        if window > 0:
            qp, kp = pos[:, None], pos[None, :]
            mask = (kp <= qp) & ((kp > qp - window) | (kp < protected))
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=causal)
        ot = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa)
        dot = dout.transpose(1, 2)
        library_ms = device_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        library_cold = device_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), cold=True)
        # the five products the gradient needs over the pairs the masks
        # keep (Q K^T, dS^T Q, dS K over hd; dO V^T, P^T dO over hd_v; a
        # design's recompute of P is its own cost, not the bound's); bytes:
        # q, dq (hd) and o, dO (hd_v) at H heads, k, dk (hd) and v, dv (hd_v)
        # at KV heads, lse read
        flops = (2.0 * bb * h * (3 * hd + 2 * hd_v)
                 * bwd_pairs(ss, causal, window, protected))
        nbytes = 4.0 * bb * ss * (h + kvh) * (hd + hd_v) + 4.0 * bb * h * ss
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        t = dict(
            ms=ms, ms_l2_cold=ms_cold, launch_ms=split,
            launch_ms_l2_cold=split_cold, wrapper_host_ms=host_ms,
            plain_ms=plain_ms,
            library_ms=library_ms, library_ms_l2_cold=library_cold,
            kernel_over_library=ms / library_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            flops=flops, bytes=nbytes,
            shape=f"B={bb} S={ss} H={h} KV={kvh} hd={hd}"
                  + (f" hd_v={hd_v}" if hd_v != hd else "") + " bf16"
                  + (" causal" if causal else "")
                  + (f" window={window} protected={protected}" if window else ""),
        )
        log(f"flash backward timing {t['shape']}: kernel {ms:.5f} ms warm "
            f"({', '.join(f'{k} {v:.5f}' for k, v in split.items())}), "
            f"{ms_cold:.5f} ms cold "
            f"({', '.join(f'{k} {v:.5f}' for k, v in split_cold.items())}), "
            f"host {host_ms:.4f} ms a call, plain {plain_ms:.4f} ms, SDPA "
            f"backward {library_ms:.5f} / {library_cold:.5f} ms, "
            f"kernel_over_library {t['kernel_over_library']:.3f}, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
        return t

    timing = timed(8, 256, 12, 2, 128, causal=False)
    timing["lm_causal_512"] = timed(8, 512, 12, 2, 128, causal=True)
    timing["hymba"] = timed(2, 1280, HY_H, HY_KV, HY_HD, causal=True,
                            window=HY_WINDOW, protected=HY_META)
    if (MLA_HD, MLA_HD_V) in bwd_instances(kf):
        timing["mla"] = timed(8, 256, MLA_H, MLA_H, MLA_HD, causal=True,
                              hd_v=MLA_HD_V)
    if (PG_HD, PG_HD) in bwd_instances(kf):
        timing["paligemma"] = timed(8, 256, PG_H, PG_KV, PG_HD, causal=False)
    return timing


# the backward's kernels, as ``-Xptxas -v`` names them
BWD_KERNELS = tuple(names[0] for names in BWD_LAUNCHES.values())


def bwd_ptxas_report(text: str, pairs, kernels=BWD_KERNELS) -> dict:
    """Registers and spills of each backward kernel's instance at each
    head-dim pair of ``pairs`` (keyed by the q/k head dim, the template's
    first argument; none may spill)."""
    out = {}
    for kernel in kernels:
        report = parse_ptxas(text, kernel)
        for d, dv in pairs:
            check(d in report and "registers" in report[d],
                  f"no ptxas report for {kernel} ({d}, {dv}):\n{text}")
            r = report[d]
            log(f"{kernel} ({d}, {dv}): {r['registers']} registers, spill "
                f"stores {r['spill_stores']} B, loads {r['spill_loads']} B")
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                  f"{kernel} ({d}, {dv}) spills registers")
        out[kernel] = {str(k): v for k, v in sorted(report.items())}
    return out


def train_shares(rows, busy_ms: float) -> dict:
    """Shares of a train step's device time: GEMMs, the flash forward and
    backward kernels, the rest (elementwise, reductions, AdamW)."""
    gemm = sum(ms for ms, _, n in rows if any(g in n for g in GEMM_NAMES))
    fwd = sum(ms for ms, _, n in rows if is_flash_kernel(n))
    bwd = sum(ms for ms, _, n in rows if is_bwd_kernel(n))
    out = dict(gemm=gemm / busy_ms, flash_fwd=fwd / busy_ms,
               flash_bwd=bwd / busy_ms,
               rest=(busy_ms - gemm - fwd - bwd) / busy_ms)
    log("  train step shares: " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def train_flash_launches(cfg, diffusion: bool) -> int:
    """Flash forward (and backward) launches of one train step of ``cfg``:
    one a layer that attends; whisper's token model also runs its encoder's
    layers and each decoder layer's cross-attention (its denoiser runs
    neither)."""
    n = attn_layers(cfg)
    if cfg.family == "audio" and not diffusion:
        n = 2 * n + cfg.num_encoder_layers
    return n


def trained_weight_names(cfg, diffusion: bool, names) -> list:
    """The weights a train step of ``cfg`` must give a gradient: every
    attention projection (MLA's wq, wkv_a, wkv_b, wo among them; whisper's
    denoiser has no cross-attention), and the scans' weights: hymba's Mamba
    heads, every weight of xlstm's mLSTM and sLSTM blocks."""
    import re

    def keep(name):
        if cfg.family == "audio" and diffusion and "cross_attn." in name:
            return False
        return bool(re.search(r"(attn|mla)\.\w+\.w$", name)) or ".mamba." in name or (
            cfg.family == "ssm" and name.startswith("backbone.layers."))

    return [n for n in names if keep(n)]


def train_objective(kf, cfg, objective: str, steps: int | None = None,
                    profile: bool = True, batch_size: int = TRAIN_BATCH) -> dict:
    """``launch/train.py``'s setup on full-width ``cfg``, ``steps`` steps
    (by default ``TRAIN_STEPS``) of ``batch_size`` x 256: per step its loss
    (finite) and wall, exactly :func:`train_flash_launches` flash forward
    and backward launches; the first loss equal to the same loss computed
    under ``no_grad`` on the same batch and draws; after the last step, a
    non-zero gradient on every weight of :func:`trained_weight_names` (a
    flash call invisible to autograd leaves wq, wk, wv without one; the
    denoiser's first step gives the backbone none at all, its ``eps_head``
    starting at zero as the reference's does).  Reports steps/s and
    tokens/s (steps after the first) and peak memory; with ``profile``,
    one more step profiled and AdamW's update timed alone."""
    from repro_torch.core import linear_schedule
    from repro_torch.launch import train as lt
    from repro_torch.kernels import gemm as kg
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import batch_to_device

    diffusion = objective == "diffusion"
    steps = steps or TRAIN_STEPS[objective]
    reserved_mb()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step, batches = lt.setup(cfg, diffusion=diffusion, steps=steps,
                             batch=batch_size, seq=TRAIN_SEQ, seed=0)
    module, params = step.module, step.params
    n_params = sum(p.numel() for p in params.values())
    check(all(p.dtype == torch.float32 and p.requires_grad for p in params.values()),
          f"{objective}: parameters not float32 with gradients on")
    state = opt.init_state(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_step = train_flash_launches(cfg, diffusion)
    losses, walls = [], []
    # the flash and GEMM launches of every step, read from the counters after it
    launches = {"flash_attention": 0, "flash_attention_bwd": 0, "gemm": 0, "bgemm": 0}

    def count_step(what):
        check(kf.flash_attention.launches == per_step
              and kf.flash_attention_bwd.launches == per_step,
              f"{cfg.name} {objective} {what}: {kf.flash_attention.launches} "
              f"flash forward / {kf.flash_attention_bwd.launches} backward "
              f"launches, not {per_step} each")
        launches["flash_attention"] += kf.flash_attention.launches
        launches["flash_attention_bwd"] += kf.flash_attention_bwd.launches
        launches["gemm"] += kg.gemm.launches
        launches["bgemm"] += kg.bgemm.launches

    for i in range(steps):
        batch = batch_to_device(next(batches), "cuda")
        if i == 0:
            draws = torch.Generator(device="cuda")
            draws.set_state(gen.get_state())
            with torch.no_grad():
                if diffusion:
                    x0 = batch["latents"]
                    u0 = torch.rand((), generator=draws, device="cuda")
                    noise = torch.randn(x0.shape, generator=draws, device="cuda")
                    ref_loss = float(module.loss_at(x0, u0, noise,
                                                    linear_schedule())[0])
                else:
                    ref_loss = float(module.loss(batch)[0])
        reset_counts(kf.flash_attention, kf.flash_attention_bwd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        count_step(f"step {i}")
        loss = float(metrics["loss"])
        check(loss == loss and abs(loss) < 1e6,
              f"{cfg.name} {objective} step {i}: loss {loss}")
        losses.append(loss)
        if i == 0:
            check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
                  f"{cfg.name} {objective}: first loss {loss} != no_grad loss "
                  f"{ref_loss}")
            first_diff = abs(loss - ref_loss)
        log(f"train {cfg.name} {objective} step {i}: loss {loss:.6f}, grad norm "
            f"{float(metrics['grad_norm']):.4f}, lr {float(metrics['lr']):.3e}, "
            f"{walls[-1] * 1e3:.1f} ms")
    names = trained_weight_names(cfg, diffusion, params)
    norms = {n: float(params[n].grad.norm()) if params[n].grad is not None else 0.0
             for n in names}
    zero = [k for k, v in norms.items() if not v > 0]
    check(names and not zero, f"{cfg.name} {objective}: of {len(names)} attention "
          f"and scan weights, these have no gradient: {zero[:6]}")
    peak = torch.cuda.max_memory_allocated() - base
    per_step_s = sum(walls[1:]) / (steps - 1)
    out = dict(
        params=n_params, steps=steps, batch=batch_size, seq=TRAIN_SEQ,
        losses=losses, step_ms=[w * 1e3 for w in walls],
        steps_per_s=1.0 / per_step_s,
        tokens_per_s=batch_size * TRAIN_SEQ / per_step_s,
        peak_mb=peak / 2**20, base_mb=base / 2**20,
        first_loss_vs_no_grad=first_diff,
        flash_per_step=per_step, weights_checked=len(names),
        attn_grad_norm_min=min(norms.values()),
    )
    if profile:
        # one more step under the profiler: where a step's device time goes
        batch = batch_to_device(next(batches), "cuda")
        reset_counts(kf.flash_attention, kf.flash_attention_bwd)
        idle, ops, rows, busy = profile_device(
            lambda: step(state, batch, gen), f"{objective} train step",
            per_step_s * 1e3, 1, "step")
        count_step("profiled step")
        shares = train_shares(rows, busy)
        # AdamW alone (one more update from the last step's gradients): its
        # device time beside the step's busy time, its device ops and its wall
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        adam = lambda: opt.apply_updates(step.opt_cfg, params, grads,  # noqa: E731
                                         state)
        adam()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adam()
        torch.cuda.synchronize()
        adam_wall = (time.perf_counter() - t0) * 1e3
        adam_rows = device_events(adam)[0]
        adamw = dict(busy_ms=sum(r[0] for r in adam_rows),
                     device_ops=sum(r[1] for r in adam_rows), wall_ms=adam_wall)
        adamw["share_of_step_busy"] = adamw["busy_ms"] / busy
        log(f"  AdamW alone: device busy {adamw['busy_ms']:.2f} ms "
            f"({adamw['share_of_step_busy']:.3f} of the step's), "
            f"{adamw['device_ops']} device ops, wall {adam_wall:.1f} ms")
        out.update(busy_ms=busy, idle_share=idle, device_ops=ops, shares=shares,
                   adamw=adamw)
        del grads
    out["flash_launches"] = launches
    log(f"train {cfg.name} {objective}: {n_params / 1e9:.3f} B params, "
        f"{out['steps_per_s']:.3f} steps/s, {out['tokens_per_s']:.0f} tokens/s, "
        f"peak {out['peak_mb']:.0f} MiB, first step {walls[0] * 1e3:.0f} ms, "
        f"{per_step} flash launches a step each way, smallest of "
        f"{len(names)} attention / scan grad norms {out['attn_grad_norm_min']:.3e}")
    del step, module, params, state, batch
    torch.cuda.empty_cache()
    return out


def checkpoint_round_trip(kf, cfg) -> dict:
    """``train`` at qwen2-1.5b's widths cut to ``CKPT_LAYERS`` layers (a
    full archive is 21 GB: a disk test, not a port test): 2 steps with a
    checkpoint, restored into a fresh denoiser whose ``eps`` must equal the
    trained one's bitwise."""
    import shutil

    from repro_torch.interop import params_from_jax
    from repro_torch.kernels import gemm as kg
    from repro_torch.launch import train as lt
    from repro_torch.models import DiffusionLM
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import train

    small = cfg.with_(num_layers=CKPT_LAYERS)
    ckpt_dir = ROOT / "build" / f"train_ckpt.{os.getpid()}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    step, batches = lt.setup(small, diffusion=True, steps=2, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, seed=0)
    t0 = time.perf_counter()
    reset_counts(kf.flash_attention, kf.flash_attention_bwd)
    train(step, batches, 2, ckpt_dir=str(ckpt_dir), print_fn=log)
    launches = {"flash_attention": kf.flash_attention.launches,
                "flash_attention_bwd": kf.flash_attention_bwd.launches}
    check(all(n == 2 * CKPT_LAYERS for n in launches.values()),
          f"checkpoint round trip's 2 steps: flash launches {launches}, not "
          f"{2 * CKPT_LAYERS} each")
    launches |= {"gemm": kg.gemm.launches, "bgemm": kg.bgemm.launches}
    path = ckpt.latest(str(ckpt_dir))
    tree, st = ckpt.restore(path)
    check(st == 2 and int(tree["opt"]["step"]) == 2, f"checkpoint step {st}")
    fresh = DiffusionLM(lt.train_config(small), device="cuda", seed=1)
    fresh.load_state_dict(params_from_jax(tree["params"], small))
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, small.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    a = step.module.eps(x.to(small.dtype), 0.5)
    b = fresh.eps(x.to(small.dtype), 0.5)
    check(torch.equal(a, b), "restored denoiser's eps differs from the saved one's")
    size = os.path.getsize(path)
    shutil.rmtree(ckpt_dir)
    log(f"checkpoint round trip ({CKPT_LAYERS} layers, {size / 2**20:.0f} MiB "
        f"archive): eps bitwise equal, {time.perf_counter() - t0:.1f}s")
    return dict(layers=CKPT_LAYERS, archive_mb=size / 2**20, eps_bitwise=True,
                flash_launches=launches)


def phase_training(kf) -> tuple[dict, dict]:
    """Phase 13: full-width qwen2-1.5b trained with the diffusion objective,
    then the LM objective (float32 parameters, bf16 compute), then the
    checkpoint round trip.  Returns the flash launches of every training
    step (each read from the counters after its step) and the figures."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b")
    figures = {obj: train_objective(kf, cfg, obj) for obj in TRAIN_STEPS}
    figures["checkpoint"] = checkpoint_round_trip(kf, cfg)
    runs = [figures[obj] for obj in TRAIN_STEPS] + [figures["checkpoint"]]
    figures["families"] = train_families(kf)
    runs += [f[obj] for f in figures["families"].values() if isinstance(f, dict)
             for obj in FAMILY_TRAIN_STEPS]
    launches = {name: sum(f["flash_launches"][name] for f in runs)
                for name in ("flash_attention", "flash_attention_bwd", "gemm", "bgemm")}
    return {**launches, "era_update": 0, "decode_attention": 0}, figures


def family_train_config(arch: str, layers: int | None):
    """Full-width ``arch``, cut to its first ``layers`` layers (None: all)
    as ``launch/train.py --layers`` cuts it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_layers

    cfg = get_config(arch)
    return cfg if layers is None else cut_layers(cfg, layers)


def train_families(kf) -> dict:
    """Every arch of ``TRAIN_FAMILIES``, one model on the card at a time:
    ``FAMILY_TRAIN_STEPS`` steps of the diffusion objective, then of the LM
    objective (the vlm family with stub patches, the audio family with stub
    frames), each through :func:`train_objective` without its profile."""
    t_phase = time.perf_counter()
    out = {}
    for arch, (layers, batch) in TRAIN_FAMILIES.items():
        cfg = family_train_config(arch, layers)
        out[arch] = {}
        for obj, steps in FAMILY_TRAIN_STEPS.items():
            out[arch][obj] = train_objective(kf, cfg, obj, steps, profile=False,
                                             batch_size=batch)
            # hand the cached blocks back before the next objective, as
            # --train-fit does between its trials: deepseek's LM steps peak
            # within 9 GB of the card
            reserved_mb()
        out[arch]["flash_per_step"] = {
            obj: train_flash_launches(cfg, obj == "diffusion")
            for obj in FAMILY_TRAIN_STEPS}
        reduced = [f"{layers} of {family_train_config(arch, None).num_layers} "
                   "layers"] if layers is not None else []
        reduced += [f"batch {batch}"] if batch != TRAIN_BATCH else []
        if reduced:
            out[arch]["reduced"] = ", ".join(reduced)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"families trained: {out['wall_s']:.1f}s")
    return out


def train_fit() -> None:
    """Why phase 13 cuts what it cuts: two LM steps of deepseek-v2-lite-16b
    at DS_TRAIN_LAYERS and one layer more, and of hymba-1.5b at batch
    HY_TRAIN_BATCH and twice it, each on a freshly emptied card; prints
    each one's peak memory, or that it ran out of the card's memory."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kf

    build.build_all([kf.SOURCE, kf.BWD_SOURCE])
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    trials = [("deepseek-v2-lite-16b", n, TRAIN_BATCH)
              for n in (DS_TRAIN_LAYERS, DS_TRAIN_LAYERS + 1)]
    trials += [("hymba-1.5b", None, b) for b in (HY_TRAIN_BATCH, 2 * HY_TRAIN_BATCH)]
    rows = []
    for arch, layers, batch in trials:
        cfg = family_train_config(arch, layers)
        row = dict(arch=arch, layers=cfg.num_layers, batch=batch, card_mb=total)
        try:
            r = train_objective(kf, cfg, "lm", 2, profile=False, batch_size=batch)
            row.update(peak_mb=r["peak_mb"], params=r["params"])
        except torch.OutOfMemoryError as e:
            row["out_of_memory"] = str(e).splitlines()[0]
        reserved_mb()
        log(json.dumps(row))
        rows.append(row)
    log(json.dumps({"train_fit": rows}))


# ---------------------------------------------------------------------------
# the mesh, the dry run's count of an ERA request, the int8 KV cache and the
# examples
# ---------------------------------------------------------------------------


# a split batch against the whole one on the card (dp > 1): each block's
# GEMMs have other row counts, so cuBLAS may pick other kernels; x0 is held
# to phase 4's graph-against-eager bound, logits to 1e-2 of their scale
MESH_X0_ATOL = 1e-2
MESH_LOGIT_RTOL = 1e-2
# drains timed with and without the mesh (the first one's results and
# launches are checked)
MESH_DRAINS = 3


def phase_mesh(ku, kf, kd, dlm) -> tuple[dict, dict]:
    """Phase 4's 8x256 ERA batch (1 + 3 rows, seeds 11 and 12, padded to
    8) through an engine on ``make_sampler_mesh()`` (data parallel over the
    local cards) and through one without a mesh: each warmed (one graph a
    card), then one drain as graph replays, with dp times the launches of
    one 8/dp-row block.  With dp = 1 the drains must be bitwise equal (7
    ``era_update``, 280 ``flash_attention``); with dp > 1 x0 within
    MESH_X0_ATOL of the unsplit drain's.  MESH_DRAINS drains of each are
    timed: the first replays a graph for the first time."""
    from repro_torch.core import linear_schedule
    from repro_torch.launch.mesh import make_sampler_mesh
    from repro_torch.serving import BatchedSampler, SampleRequest

    mesh = make_sampler_mesh()
    dp = mesh.shape["data"]
    check(dp == torch.cuda.device_count(), f"sampler mesh {mesh.shape}")
    sched = linear_schedule()
    reqs = [SampleRequest(batch=1, seq_len=256, nfe=NFE, seed=11),
            SampleRequest(batch=3, seq_len=256, nfe=NFE, seed=12)]
    results, launches, walls = {}, {}, {}
    for label, m in (("plain", None), ("mesh", mesh)):
        eng = BatchedSampler(dlm, sched, batch_buckets=(8,), mesh=m)
        report = eng.warmup(seq_lens=(256,))
        check(report["fresh"] == (dp if m is not None else 1),
              f"{label}: warmup captured {report['fresh']} graphs")
        walls[label] = []
        for run in range(MESH_DRAINS):
            futs = [eng.submit_with_future(r)[1] for r in reqs]
            reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
            t0 = time.perf_counter()
            eng.drain()
            for dev in (mesh.devices if m is not None else ["cuda"]):
                torch.cuda.synchronize(dev)
            walls[label].append((time.perf_counter() - t0) * 1e3)
            if run == 0:
                launches[label] = read_counts(ku, kf, kd)
                results[label] = [f.result() for f in futs]
        check(eng.compile_stats()["fresh"] == report["fresh"],
              f"{label}: the drain captured a graph")
        del eng
    want = {"era_update": dp * (NFE - K + 1),
            "flash_attention": dp * dlm.config.num_layers * NFE, "decode_attention": 0}
    check(launches_are(launches["mesh"], want),
          f"mesh launches {launches['mesh']} != {want}")
    same = all(
        torch.equal(a.x0, b.x0) and set(a.aux) == set(b.aux)
        and all(torch.equal(a.aux[k], b.aux[k]) for k in a.aux)
        for a, b in zip(results["plain"], results["mesh"]))
    diff = max(float((a.x0 - b.x0).abs().max())
               for a, b in zip(results["plain"], results["mesh"]))
    log(f"mesh (dp={dp}): 8x256 drains {[round(w, 1) for w in walls['mesh']]} "
        f"ms against {[round(w, 1) for w in walls['plain']]} without a mesh (the "
        f"first replays of a graph upload it); launches {launches['mesh']} "
        f"against {launches['plain']}; x0 and aux bitwise equal {same}, x0 "
        f"max abs diff {diff:.3e}")
    if dp == 1:
        check(launches["mesh"] == launches["plain"], "mesh launch counts differ")
        check(same, "the dp=1 mesh drain differs from the drain without a mesh")
    check(diff <= MESH_X0_ATOL, f"the mesh drain's x0 is {diff} off")
    return launches["mesh"], dict(dp=dp, drain_ms=walls["mesh"][0],
                                  plain_drain_ms=walls["plain"][0],
                                  drain_ms_runs=walls["mesh"],
                                  plain_drain_ms_runs=walls["plain"], bitwise=same,
                                  x0_max_abs_diff=diff)


def mesh_engine(ku, kf, kd) -> dict:
    """``Engine(mesh=make_sampler_mesh())`` on full-width qwen2-1.5b's token
    model against the engine without a mesh: each mesh block's prefill
    logits (its rows, on its card's copy of the weights) within
    MESH_LOGIT_RTOL of the whole batch's, and 16 greedy tokens of batch 8,
    prompt 512, with dp times a block's launches; the share of tokens equal
    is reported."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_sampler_mesh
    from repro_torch.parallel.sharding import device_scope
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config("qwen2-1.5b")
    model, _ = token_model(cfg)
    serve = ServeConfig(max_len=AR_MAX_LEN)
    mesh = make_sampler_mesh()
    dp = mesh.shape["data"]
    eng, meng = Engine(model, serve), Engine(model, serve, mesh=mesh)
    rng = np.random.default_rng(23)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (AR_BATCH, AR_PROMPT)).astype(np.int32)).cuda()
    whole, _ = eng.prefill_step(prompts)
    worst = 0.0
    for block, rows in meng._blocks(AR_BATCH):
        with device_scope(block.device):
            part, _ = block.prefill(prompts[rows].to(block.device), meng.slots)
        part = part.to(whole.device).float()
        ref = whole[rows].float()
        worst = max(worst, float((part - ref).abs().max() / ref.abs().max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = eng.generate(prompts, 16)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
    t0 = time.perf_counter()
    meshed = meng.generate(prompts, 16)
    for i in range(dp):
        torch.cuda.synchronize(mesh.devices[i])
    mesh_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(ku, kf, kd)
    want = {"era_update": 0, "flash_attention": dp * cfg.num_layers,
            "decode_attention": dp * cfg.num_layers * 15}
    agree = float((plain == meshed).float().mean())
    log(f"Engine(mesh={mesh.shape}): prefill logits of each block within "
        f"{worst:.3e} of the whole batch's (bound {MESH_LOGIT_RTOL}); 16 "
        f"tokens, {agree:.3f} of them equal to those without a mesh, "
        f"{mesh_ms:.1f} ms against {plain_ms:.1f}; launches {launches}")
    check(launches_are(launches, want), f"mesh generate launches {launches} != {want}")
    check(worst <= MESH_LOGIT_RTOL, f"mesh prefill logits {worst} off")
    check(tuple(meshed.shape) == (AR_BATCH, 16), f"tokens {tuple(meshed.shape)}")
    if dp == 1:
        check(agree == 1.0, "the dp=1 mesh generated other tokens")
    del model, eng, meng
    return dict(dp=dp, prefill_logit_rel_err=worst, tokens_equal=agree,
                launches=launches, generate_ms=mesh_ms, plain_generate_ms=plain_ms)


def mesh_only() -> None:
    """Only the mesh checks, over every local card: phase 4's drain
    (:func:`phase_mesh`) and the AR engine (:func:`mesh_engine`); one JSON
    line.  Run on a machine with several cards for dp > 1."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import era_update as ku
    from repro_torch.kernels import flash_attention as kf

    t0 = time.perf_counter()
    build.build_all([kf.SOURCE, kd.SOURCE])
    log(f"built in {time.perf_counter() - t0:.1f}s; {torch.cuda.device_count()} cards")
    dlm = build_dlm()
    launches, drain = phase_mesh(ku, kf, kd, dlm)
    del dlm
    engine = mesh_engine(ku, kf, kd)
    print(json.dumps({"mesh_only": dict(drain=drain, drain_launches=launches,
                                        engine=engine)}), flush=True)


def phase_request_flops(busy_ms: float) -> dict:
    """The dry run's count of one qwen2-1.5b ERA request (8 x 256, nfe 10,
    on a meta denoiser) over phase 4's replay busy time of the same
    request: the achieved rate and its share of the bf16 peak."""
    from repro_torch.launch.dryrun import run_solver_program

    rec = run_solver_program("qwen2-1.5b", "1x1", out_dir=None, nfe=NFE,
                             batch=8, seq=256)
    rate = rec["flops"] / (busy_ms * 1e-3)
    share = rate / PEAK_BF16_FLOPS
    log(f"ERA request 8x256 nfe={NFE}: {rec['flops']:.4e} FLOPs counted on "
        f"meta ({rec['nfe_flops']:.4e} a NFE, counted in {rec['count_s']:.1f}s) "
        f"over {busy_ms:.1f} ms of replay busy time: {rate / 1e12:.1f} TFLOP/s, "
        f"{share:.3f} of the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak")
    check(0 < share <= 1, f"achieved share of peak {share} outside (0, 1]")
    return dict(flops=rec["flops"], kept_flops=rec["kept_flops"],
                nfe_flops=rec["nfe_flops"], bytes=rec["bytes"], busy_ms=busy_ms,
                tflops_per_s=rate / 1e12, share_of_bf16_peak=share)


# the int8 phase: new tokens, the layer whose int8 K the planted fault zeroes
INT8_GEN = 32
INT8_FAULT_LAYER = 14
# the reference's own bound on int8 against full-cache decode logits
# (tests/test_attention.py), max |diff| / max |logit| over the steps.  It
# is loose: on an H100 80GB HBM3 int8 lands at 0.022-0.026 of the logits'
# scale and one layer's K zeroed (of 28) at 0.036, so the planted fault is
# seen by the cache check below, not by this bound.
INT8_RTOL = 0.2
# the int8 cache against the bf16 cache it quantizes, element by element,
# where both caches were written from the same K/V (every layer's prompt
# slots; layer 0's decode slots under teacher forcing):
# |q * scale - k| <= scale / 2 (round to nearest), with room for float32
# rounding
INT8_CACHE_SLACK = 1.001
# the second planted fault: layer 0's K scale of this decode step written
# to the next step's slot as well (a scale written to the wrong slot)
INT8_FAULT_STEP = 3


def cache_bytes(cache: dict, layers: int, batch: int, slots: int) -> float:
    """Bytes of K/V (and their scales) a slot, layer and batch row."""
    ring = cache["0_dense"]
    return sum(t.numel() * t.element_size() for name, t in ring.items()
               if name != "pos") / (layers * batch * slots)


def int8_cache_error(cf: dict, cq: dict, slots: slice,
                     layers: slice = slice(None)) -> float:
    """The largest |dequantized int8 - bf16| over half a quantization step,
    of K and V over ``layers`` and ``slots``: at most 1 when the int8 cache
    holds the bf16 cache's entries rounded to nearest."""
    ring, qring = cf["0_dense"], cq["0_dense"]
    worst = torch.zeros((), device="cuda")
    for name in ("k", "v"):
        q = qring[name][layers, :, slots]
        scale = qring[f"{name}_scale"][layers, :, slots]
        diff = (q.float() * scale - ring[name][layers, :, slots].float()).abs()
        worst = torch.maximum(worst, (diff / (0.5 * scale)).max())
    return float(worst)


def phase_int8(ku, kf, kd) -> tuple[dict, dict]:
    """Full-width qwen2-1.5b with ``kv_quant="int8"`` through
    ``Engine.generate`` (batch 8, prompt 512, 32 new tokens, 1024 slots),
    against the same weights with the bf16 cache: the prefill's int8
    entries (every layer) and the teacher-forced decode's (layer 0, whose
    K/V the two engines compute from the same token) the bf16 cache's
    rounded to nearest, teacher-forced decode logits within INT8_RTOL of
    the bf16 cache's, two planted faults that the cache check must see
    (one layer's int8 K zeroed after the prefill, whose logits are
    reported; a decode step's K scale copied into the next step's slot),
    the cache's bytes, decode ms a step beside bf16's, 28 decode launches a
    step.  Then ``Engine(mesh=make_sampler_mesh())`` must generate the
    tokens of the engine without a mesh, bitwise."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_sampler_mesh
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config("qwen2-1.5b")
    model, _ = token_model(cfg)
    qmodel = build_model(cfg.with_(kv_quant="int8"), seed=0)
    qmodel.load_state_dict(model.state_dict())
    serve = ServeConfig(max_len=AR_MAX_LEN)
    eng, qeng = Engine(model, serve), Engine(qmodel, serve)
    rng = np.random.default_rng(23)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (AR_BATCH, AR_PROMPT)).astype(np.int32)).cuda()

    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
    toks = qeng.generate(prompts, INT8_GEN)
    torch.cuda.synchronize()
    launches = read_counts(ku, kf, kd)
    check(tuple(toks.shape) == (AR_BATCH, INT8_GEN), f"tokens {tuple(toks.shape)}")
    want = {"era_update": 0, "flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * (INT8_GEN - 1)}
    check(launches_are(launches, want), f"int8 generate launches {launches} != {want}")

    prompt_slots = slice(0, AR_PROMPT)
    decode_slots = slice(AR_PROMPT, AR_PROMPT + INT8_GEN - 1)

    def teacher_forced(plant: bool):
        lf, cf = eng.prefill_step(prompts)
        lq, cq = qeng.prefill_step(prompts)
        same_prefill = bool(torch.equal(lf, lq))
        if plant:
            cq["0_dense"]["k"][INT8_FAULT_LAYER].zero_()
        cache_err = int8_cache_error(cf, cq, prompt_slots)
        tok = eng.sample_token(lf)
        errs = []
        for i in range(INT8_GEN - 1):
            lf, _ = eng.decode_step(cf, tok[:, None], AR_PROMPT + i)
            lq, _ = qeng.decode_step(cq, tok[:, None], AR_PROMPT + i)
            errs.append((lf - lq).abs().max().float() / lf.abs().max().float())
            tok = eng.sample_token(lf)
        return torch.stack(errs).cpu(), same_prefill, cache_err, cf, cq

    errs, same_prefill, cache_err, cf, cq = teacher_forced(plant=False)
    decode_err = int8_cache_error(cf, cq, decode_slots, slice(0, 1))
    scale = cq["0_dense"]["k_scale"][0]
    slot = AR_PROMPT + INT8_FAULT_STEP
    scale[:, slot + 1] = scale[:, slot]
    decode_fault_err = int8_cache_error(cf, cq, decode_slots, slice(0, 1))
    del cf, cq, scale
    fault, _, fault_cache_err, cf, cq = teacher_forced(plant=True)
    del cf, cq
    log(f"int8 cache: prefill entries within {cache_err:.4f} half-steps of the "
        f"bf16 cache's, layer 0's decode entries within {decode_err:.4f} (bound "
        f"{INT8_CACHE_SLACK}); decode logits against the bf16 cache's, max "
        f"|diff| / max |logit| {float(errs.max()):.4f} (steps "
        f"{[round(float(e), 4) for e in errs[:4]]} ...), bound {INT8_RTOL}; with "
        f"layer {INT8_FAULT_LAYER}'s int8 K zeroed: cache {fault_cache_err:.1f} "
        f"half-steps, logits {float(fault.max()):.4f}; with decode step "
        f"{INT8_FAULT_STEP}'s K scale in the next slot too: {decode_fault_err:.1f} "
        f"half-steps; prefill logits equal {same_prefill}")
    check(same_prefill, "the int8 prefill's logits differ from bf16's (the "
                        "prefill attends over its fresh K/V)")
    check(cache_err <= INT8_CACHE_SLACK, f"int8 cache {cache_err} half-steps off")
    check(decode_err <= INT8_CACHE_SLACK,
          f"int8 decode writes {decode_err} half-steps off")
    check(float(errs.max()) < INT8_RTOL, f"int8 logits {float(errs.max())} off")
    check(fault_cache_err > INT8_CACHE_SLACK,
          f"the cache check missed the planted fault ({fault_cache_err})")
    check(decode_fault_err > INT8_CACHE_SLACK,
          f"the decode cache check missed the misplaced scale ({decode_fault_err})")

    # bytes a slot, layer and row; decode ms a step (bf16, int8, int8, bf16)
    _, cf = eng.prefill_step(prompts)
    _, cq = qeng.prefill_step(prompts)
    args = (cfg.num_layers, AR_BATCH, AR_MAX_LEN)
    bf16_b, int8_b = cache_bytes(cf, *args), cache_bytes(cq, *args)
    del cf, cq
    check((bf16_b, int8_b) == (1024, 528), f"cache bytes {bf16_b}, {int8_b}")
    step_ms = {"bf16": [], "int8": []}
    for label in ("bf16", "int8", "int8", "bf16"):
        e = eng if label == "bf16" else qeng
        logits, cache = e.prefill_step(prompts)
        tok = e.sample_token(logits)
        torch.cuda.synchronize()
        reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention)
        t0 = time.perf_counter()
        for i in range(INT8_GEN - 1):
            logits, _ = e.decode_step(cache, tok[:, None], AR_PROMPT + i)
            tok = e.sample_token(logits)
        torch.cuda.synchronize()
        step_ms[label].append((time.perf_counter() - t0) * 1e3 / (INT8_GEN - 1))
        check(kd.decode_attention.launches == cfg.num_layers * (INT8_GEN - 1),
              f"{label}: {kd.decode_attention.launches} decode launches")
        del cache
    log(f"int8 cache: {int8_b:.0f} B a slot, layer and row against {bf16_b:.0f} "
        f"({int8_b / bf16_b:.3f}x); decode {step_ms['int8']} ms a step against "
        f"bf16's {step_ms['bf16']}; {cfg.num_layers} decode launches a step")

    mesh = make_sampler_mesh()
    plain = eng.generate(prompts, 16)
    meshed = Engine(model, serve, mesh=mesh).generate(prompts, 16)
    torch.cuda.synchronize()
    check(torch.equal(plain, meshed),
          "Engine(mesh=) generated other tokens than the engine without a mesh")
    log(f"Engine(mesh={mesh.shape}).generate: 16 tokens bitwise those without a mesh")
    del model, qmodel, eng, qeng
    return launches, dict(
        max_rel_err=float(errs.max()), fault_rel_err=float(fault.max()),
        bound=INT8_RTOL, cache_half_steps=cache_err,
        decode_cache_half_steps=decode_err,
        fault_cache_half_steps=fault_cache_err,
        decode_fault_cache_half_steps=decode_fault_err, bytes_per_slot_layer_row=int8_b,
        bf16_bytes_per_slot_layer_row=bf16_b, decode_ms_per_step=step_ms["int8"],
        bf16_decode_ms_per_step=step_ms["bf16"],
        decode_launches_per_step=cfg.num_layers, mesh_tokens_bitwise=True)


EXAMPLES = ("torch_quickstart", "torch_compare_solvers", "torch_serve_multi_arch")


def phase_examples() -> dict:
    """Each ``examples/torch_*.py`` at its tiny defaults on the card, in a
    subprocess of its own, the three started together (each wall from the
    common start to its exit); a failure fails the phase."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs, walls = {}, {}
    try:
        for name in EXAMPLES:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
                env=env, stdout=out, stderr=err, text=True), out, err)
        while len(walls) < len(procs):
            for name, (proc, _, _) in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            check(time.perf_counter() - t0 < 300, f"examples still running: "
                  f"{[n for n in procs if n not in walls]}")
            time.sleep(0.1)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (proc, out, err) in procs.items():
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        check(proc.returncode == 0, f"example {name} failed:\n{stdout[-3000:]}"
                                    f"\n{stderr[-3000:]}")
        for line in stdout.strip().splitlines()[-3:]:
            log(f"  {name}: {line}")
    log(f"examples: {', '.join(f'{k} {v:.1f}s' for k, v in walls.items())}; "
        f"together {max(walls.values()):.1f}s")
    return walls


# ---------------------------------------------------------------------------
# phase 15: the dry run's memory against the card's
# ---------------------------------------------------------------------------

# the dry run's prediction of a program's device memory (the state it is
# handed plus its activation peak, counted on meta) against
# max_memory_allocated() over the same program on the card: within 10% of
# the measured total.  The activation part differs by what the kernels
# allocate beside their outputs (the flash forward's log-sum-exp for the
# backward, the backward's float32 dq), which the meta handlers do not
DRYRUN_MEM_RTOL = 0.10
# the activation part alone, predicted against measured (the peak above
# what the program was handed): 0.987 of it in both programs on an H100,
# so 5% sees a peak tracker that is off by more than the kernels' buffers
DRYRUN_ACT_RTOL = 0.05


def peak_above(run, before: int) -> tuple[int, int]:
    """(max_memory_allocated over ``run()`` above ``before``, and above
    what was allocated just before ``run``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak - before, peak - held


def memory_check(what: str, predicted_state: int, predicted_act: int,
                 measured: int, measured_act: int) -> dict:
    """Log and check one program's predicted against measured memory."""
    predicted = predicted_state + predicted_act
    ratio = predicted / measured
    act_ratio = predicted_act / measured_act
    log(f"dry-run memory, {what}: predicted {predicted / 2**20:.1f} MiB "
        f"(state {predicted_state / 2**20:.1f} + activations "
        f"{predicted_act / 2**20:.1f}), measured {measured / 2**20:.1f} MiB "
        f"(activations {measured_act / 2**20:.1f}): {ratio:.4f}, "
        f"activations {act_ratio:.4f}")
    check(abs(ratio - 1) <= DRYRUN_MEM_RTOL,
          f"dry-run memory of {what}: predicted {predicted} B, measured "
          f"{measured} B, outside {DRYRUN_MEM_RTOL:.0%}")
    check(abs(act_ratio - 1) <= DRYRUN_ACT_RTOL,
          f"dry-run activations of {what}: predicted {predicted_act} B, measured "
          f"{measured_act} B, outside {DRYRUN_ACT_RTOL:.0%}")
    return dict(predicted_bytes=predicted, predicted_state_bytes=predicted_state,
                predicted_activation_bytes=predicted_act, measured_bytes=measured,
                measured_activation_bytes=measured_act, predicted_over_measured=ratio,
                activations_predicted_over_measured=act_ratio)


def phase_dryrun_memory(ku, kf, kd) -> tuple[dict, dict]:
    """Phase 15: the dry run's memory (``launch/dryrun.py`` on meta, one
    card) against the card's: the qwen2-1.5b ERA request at 8 x 256 (nfe
    10) run eagerly through the program's loop, and one qwen2-1.5b
    diffusion training step at 8 x 256 from ``launch/train.py``'s setup,
    each from a clean allocator; then one sharded count on this host (the
    same request at 2x4, a fake process group), its collectives and its
    wall.  Returns the launches of the two runs and the figures."""
    from repro_torch.configs import get_config
    from repro_torch.core import ERAConfig, get_program, linear_schedule
    from repro_torch.kernels import gemm as kg
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as lt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import batch_to_device

    cfg = get_config("qwen2-1.5b")
    out = {}
    launches = dict.fromkeys((*COUNTED, "flash_attention_bwd"), 0)

    def add_launches():
        for name, fn in (("era_update", ku.era_update),
                         ("flash_attention", kf.flash_attention),
                         ("decode_attention", kd.decode_attention),
                         ("flash_attention_bwd", kf.flash_attention_bwd),
                         ("gemm", kg.gemm), ("bgemm", kg.bgemm)):
            launches[name] += fn.launches

    # the ERA request, eagerly
    reserved_mb()
    before = torch.cuda.memory_allocated()
    dlm = build_dlm()
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(8, 256, cfg.d_model, generator=gen, device="cuda")
    program = get_program("era")
    ecfg = ERAConfig(nfe=NFE, k=K, per_sample=True)
    result = {}

    def request():
        with torch.no_grad():
            result["x0"] = program.sample_scan(
                dlm.eps_fn(), x, program.alloc_buffers(x, ecfg), linear_schedule(),
                ecfg).x0

    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention,
                 kf.flash_attention_bwd)
    measured, measured_act = peak_above(request, before)
    add_launches()
    x0 = result.pop("x0")
    check(x0.shape == x.shape and bool(torch.isfinite(x0).all()),
          "dry-run memory: the ERA request's x0 is not finite")
    del x0, dlm, x
    rec = dryrun.run_solver_program("qwen2-1.5b", "1x1", out_dir=None, nfe=NFE,
                                    batch=8, seq=256)
    state = rec["param_bytes_per_device"] + 8 * 256 * cfg.d_model * 4
    out["era_request"] = memory_check(
        "ERA request 8x256", int(state), rec["peak_activation_bytes_per_device"],
        measured, measured_act)
    out["era_request"]["count_s"] = rec["count_s"]

    # one diffusion training step
    reserved_mb()
    before = torch.cuda.memory_allocated()
    step, batches = lt.setup(cfg, diffusion=True, steps=1, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, seed=0)
    state = opt.init_state(step.params)
    batch = batch_to_device(next(batches), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def train_step():
        _, metrics = step(state, batch, gen)
        result["loss"] = float(metrics["loss"])

    reset_counts(ku.era_update, kf.flash_attention, kd.decode_attention,
                 kf.flash_attention_bwd)
    measured, measured_act = peak_above(train_step, before)
    add_launches()
    check(result["loss"] == result["loss"], "dry-run memory: the training loss is NaN")
    del step, state, batch
    reserved_mb()
    rec = dryrun.count_train_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out["diffusion_train_step"] = memory_check(
        f"diffusion training step {TRAIN_BATCH}x{TRAIN_SEQ}",
        int(rec["state_bytes_per_device"]["total"]),
        rec["peak_activation_bytes_per_device"], measured, measured_act)
    out["diffusion_train_step"]["count_s"] = rec["count_s"]

    # the partitioned count on this host: the fake process group imports
    rec = dryrun.run_solver_program("qwen2-1.5b", "2x4", out_dir=None, nfe=NFE,
                                    batch=8, seq=256)
    check(not torch.distributed.is_initialized(),
          "dry-run memory: the sharded count left its process group up")
    check(rec["collective_bytes_total"] > 0,
          "dry-run memory: the 2x4 count issued no collective")
    out["sharded_request_2x4"] = dict(
        collectives=rec["collectives"],
        collective_bytes_total=rec["collective_bytes_total"],
        flops_per_device=rec["flops_per_device"],
        peak_activation_bytes_per_device=rec["peak_activation_bytes_per_device"],
        count_s=rec["count_s"])
    log(f"dry run at 2x4, ERA request 8x256: {rec['collective_bytes_total']:.4e} "
        f"collective bytes a card {rec['collectives']}, counted in "
        f"{rec['count_s']:.1f}s")
    out["launches"] = dict(launches)
    return launches, out


# ---------------------------------------------------------------------------
# timing and tracing
# ---------------------------------------------------------------------------


def device_ms(fn, iters: int = 20, warmup: int = 3, *, cold: bool = False,
              pick=None, kernels: int = 0, by=None):
    """Mean device time of one call: the profiler's device time of every
    kernel ``iters`` calls launch, over ``iters``.  Unlike :func:`time_ms`
    it leaves out the host time of a wrapper whose kernels are shorter than
    its own Python.  ``cold`` writes ``FLUSH_BYTES`` before every call, so
    the call finds L2 holding none of its inputs, and leaves the flush's own
    kernels out of the sum; ``pick`` keeps only the rows whose kernel name
    it accepts.  With ``kernels``, the picked launches one call makes, the
    time is the mean of the launches the trace holds, times ``kernels``:
    the profiler drops a record or two of a short run now and then (18 or
    19 of 20 seen), which the mean over ``iters`` would count as no time.
    A trace that holds fewer than half of them is taken again, up to three
    times, each time over half as many calls (late in a long run a trace
    has held 23 or 27 of 60 launches, the same count three times in a
    row).  A trace that holds none of the call's kernels is taken again
    too; where three hold none and the whole call is timed (no ``pick``, no
    ``by``), CUDA events around each call give its time (an L2-cold trace
    of SDPA's backward once held none of its kernels, only the flush's).
    With ``by`` (a kernel name to a key), a dict instead: each key's
    mean device time a launch, from a trace that holds ``kernels`` keys,
    each with a quarter of its launches or more."""
    flush = l2_flush() if cold else None
    skip = set()
    if flush is not None:
        skip = {r[2] for r in traced(lambda: [flush() for _ in range(iters)])}
    for _ in range(warmup):
        if flush is not None:
            flush()
        fn()

    def run(n):
        for _ in range(n):
            if flush is not None:
                flush()
            fn()

    n = iters
    for attempt in range(3):
        rows = [r for r in traced(lambda: run(n))
                if r[2] not in skip and (pick is None or pick(r[2]))]
        held = sum(r[1] for r in rows)
        counts = {}
        for _, count, name in rows:
            key = by(name) if by is not None else None
            counts[key] = counts.get(key, 0) + count
        if by is not None:
            ok = len(counts) >= kernels and min(counts.values(), default=0) * 4 >= n
        else:
            ok = bool(rows) and (not kernels or 2 * held >= n * kernels)
        if ok:
            break
        log(f"device_ms: trace {attempt} holds {held} of the {n * kernels} "
            f"kernels timed ({counts}); traced again over {max(5, n // 2)} calls")
        n = max(5, n // 2)
    else:
        if pick is None and by is None:
            log("device_ms: no trace holds the call's kernels; timed by CUDA "
                "events around each call instead")
            return events_ms(fn, iters, flush)
        raise RuntimeError("chip_smoke: FAILED: no trace holds the timed kernels")
    if by is not None:
        split = {}
        for ms, count, name in rows:
            key = by(name)
            tot, c = split.get(key, (0.0, 0))
            split[key] = (tot + ms, c + count)
        return {key: tot / c for key, (tot, c) in split.items()}
    if kernels:
        return sum(r[0] for r in rows) / held * kernels
    return sum(r[0] for r in rows) / n


def events_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of one call, from CUDA events around each call
    alone (``flush``, where given, runs before each, outside the events)."""
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def traced(fn) -> list:
    """:func:`device_events` rows of ``fn``, traced again (up to three
    times) when the profiler drops a whole short trace."""
    for attempt in range(3):
        try:
            return device_events(fn)[0]
        except RuntimeError:
            if attempt == 2:
                raise
    return []


# bytes written between two L2-cold calls: over five times the H100's 50 MB
# L2, so no line of the timed call's inputs survives
FLUSH_BYTES = 256 << 20


@functools.cache
def l2_flush():
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


#: marker kernels each trace starts with, for the tracer to drop in place
#: of the traced work's first records
TRACER_WARMUP = 256


def device_events(fn):
    """Run ``fn`` under torch.profiler; return ((device ms, count, name)
    rows sorted by time, device span ms (first device op to last),
    profiled wall ms, device busy ms: the union of every device op's
    interval in this trace, so never more than the span)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a moment for the tracer before the first launch, and marker
        # kernels for it to drop: late in a long run a trace has come back
        # without its first few dozen records (in PR 27, the first layer of
        # every whisper replay traced, five times in a row); the markers
        # are left out of everything below
        time.sleep(0.01)
        for _ in range(TRACER_WARMUP):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and MARKER_KERNEL not in e.name]
    check(bool(spans), "profiler traced no device op")
    span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    busy_us, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start >= end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy, memset); the CPU-side
        # aten ops carry their kernels' time too and would count it twice
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or MARKER_KERNEL in evt.key):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows, span_ms, wall_ms, busy_us / 1e3


def profile_device(fn, what: str, plain_wall_ms: float, per: int,
                   unit: str) -> tuple[float, int, list, float]:
    """Run ``fn`` once under torch.profiler; print the device-time breakdown
    by kernel and the device's idle share, and return the idle share, the
    number of device ops, the profiler's (ms, count, name) rows and the
    device busy ms.  Busy is the union of the device ops' intervals in this
    one trace (not the sum of per-name totals, which can count a stretch
    twice).  The idle share returned is over the same trace's device span
    (first device op to last), so busy and span come from one run and the
    share lies in [0, 1].  The share over the wall of the same work run
    unprofiled (``plain_wall_ms``) is printed beside it, labelled, and not
    returned: the profiler stretches the traced run (its own host work
    between launches), so that busy time and that wall come from two runs
    and the share can read below 0."""
    rows, span_ms, wall_ms, busy_ms = device_events(fn)
    check(busy_ms <= span_ms + 1e-6,
          f"{what}: busy {busy_ms} ms above the trace's span {span_ms} ms")
    launches = sum(r[1] for r in rows)
    idle = 1 - busy_ms / span_ms
    log(f"profile ({what}): device busy {busy_ms:.1f} ms (union of the "
        f"trace's device intervals; per-kernel totals sum to "
        f"{sum(r[0] for r in rows):.1f} ms), {launches} device ops "
        f"({launches / per:.0f} per {unit})")
    log(f"  idle share over the trace's device span {span_ms:.1f} ms: "
        f"{idle:.3f}; side figure, busy over another (unprofiled) run's wall "
        f"{plain_wall_ms:.1f} ms: {1 - busy_ms / plain_wall_ms:.3f}; profiled "
        f"wall {wall_ms:.1f} ms")
    for ms, count, name in rows[:12]:
        log(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}")
    return idle, launches, rows, busy_ms


# ---------------------------------------------------------------------------
# optional: the ERA path's host cost, one tree against another
# ---------------------------------------------------------------------------


#: ``--era-arch families``: the families phase 16 added, each with its cut
ERA_FAMILIES = ",".join(n if l is None else f"{n}:{l}" for n, l in INV_FAMILIES)


def use_package(src: str) -> None:
    """Make the ``repro_torch`` under ``src`` the one later imports load:
    this script imported this checkout's at its top, so drop it."""
    sys.path.insert(0, str(Path(src).resolve()))
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(Path(src).resolve()),
          f"imported {repro_torch.__file__}, not the package under {src}")


def era_host(src: str, archs: str = "qwen2-1.5b") -> None:
    """Time the ERA path with the ``repro_torch`` package under ``src``, for
    each of ``archs`` (comma-separated ``name`` or ``name:layers``, one
    full-width denoiser on the card at a time): one denoiser forward at
    8x256 (host time to issue it, its wall with a sync, its device busy
    time), three drains of the 8-row-bucket request of phase 4 and three of
    a 1-row request (bucket 1), each with one traced replay's device busy
    time; then phase 16's probe (:func:`module_probe`,
    :func:`bucket_reading`); print one JSON line an arch."""
    import gc

    use_package(src)
    from repro_torch.configs import get_config
    from repro_torch.core import linear_schedule
    from repro_torch.models import DiffusionLM
    from repro_torch.serving import BatchedSampler, SampleRequest

    for arch in archs.split(","):
        name, _, layers = arch.partition(":")
        cfg = get_config(name)
        if layers:
            cfg = cfg.with_(num_layers=int(layers))
        era_host_arch(src, cfg, DiffusionLM, linear_schedule, BatchedSampler,
                      SampleRequest)
        gc.collect()
        torch.cuda.empty_cache()


def era_host_arch(src, cfg, DiffusionLM, linear_schedule, BatchedSampler,
                  SampleRequest) -> None:
    """:func:`era_host` for one config, with the classes of the package
    under ``src``."""
    import statistics

    dlm = DiffusionLM(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(cfg.d_model, cfg.d_model, generator=gen, device="cuda")
    dlm.eps_head.w.copy_(w * (0.5 / cfg.d_model**0.5))
    x = torch.randn(8, 256, cfg.d_model, generator=gen, device="cuda")
    for _ in range(3):
        dlm.eps(x, 0.5)
    issue, wall = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dlm.eps(x, 0.5)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    rows = device_events(lambda: dlm.eps(x, 0.5))[0]
    eng = BatchedSampler(dlm, linear_schedule())
    drains = {}
    for batch in (3, 1):  # batch buckets 8 and 1
        req = SampleRequest(batch=batch, seq_len=256, nfe=NFE, solver="era",
                            seed=12)
        drains[batch] = []
        for _ in range(4):  # the first one warms the kernels (and captures)
            eng.submit_with_future(req)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.drain()
            torch.cuda.synchronize()
            drains[batch].append((time.perf_counter() - t0) * 1e3 / NFE)
        eng.submit_with_future(req)
        drains[f"busy_{batch}"] = device_events(eng.drain)[3]
    del eng
    probe = module_probe(dlm)
    reading = bucket_reading(dlm)
    print(json.dumps(dict(
        src=src, arch=cfg.name, layers=cfg.num_layers,
        forward_issue_ms=statistics.median(issue),
        forward_wall_ms=statistics.median(wall),
        forward_busy_ms=sum(r[0] for r in rows),
        forward_ops=sum(r[1] for r in rows),
        drain_ms_per_nfe=drains[3][1:], replay_busy_ms=drains["busy_3"],
        drain1_ms_per_nfe=drains[1][1:], replay1_busy_ms=drains["busy_1"],
        modules_differ=len(probe), first_modules=probe[:6], **reading,
    )), flush=True)


def era_ab(parent_src: str, archs: str = "qwen2-1.5b") -> None:
    """:func:`era_host` for ``parent_src`` and this checkout's ``src`` in
    the order parent, this, this, parent, each in a process of its own
    that times every arch of ``archs``."""
    this_src = str(ROOT / "src")
    for src in (parent_src, this_src, this_src, parent_src):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--era-host", src,
             "--era-arch", archs],
            capture_output=True, text=True, timeout=1500, check=True,
        )
        for line in out.stdout.strip().splitlines():
            if line.startswith("{"):
                log(line)


# variants of the shipped flash kernel that --flash-ab times beside it: name
# -> {q/k head dim: (keys a kv tile, stages of the ring, blocks an SM the
# register budget is set for)}, each replacing that head dim's entry of
# FLASH_FWD_CFG in a copy of the source
FLASH_VARIANTS = {
    "hd32/64: BK32, 3 stages, 4 blocks": {32: (32, 3, 4), 64: (32, 3, 4)},
    "hd32/64: BK64, 2 stages, 4 blocks": {32: (64, 2, 4), 64: (64, 2, 4)},
    "hd32/64: BK32, 4 stages, 4 blocks": {32: (32, 4, 4), 64: (32, 4, 4)},
    "hd128: BK64, 2 stages, 2 blocks": {128: (64, 2, 2)},
    "hd256: BK64, 2 stages": {256: (64, 2, 1)},
}

# the forward's path shapes (PERF.md's table) and qwen2's training shape:
# (name, B, Sq, Sk, H, KV, hd, hd_v, mask, options); mask "full" (every
# key), "causal" or "lengths" (row lengths 200 x4, 256 x4 as kv_mask)
FLASH_AB_SHAPES = (
    ("qwen2 ERA 8x256", 8, 256, 256, 12, 2, 128, 128, "full", {}),
    ("qwen2 ERA 8x128", 8, 128, 128, 12, 2, 128, 128, "full", {}),
    ("qwen2 AR prefill 8x512 causal", 8, 512, 512, 12, 2, 128, 128, "causal", {}),
    ("qwen2 training 8x256 with lse", 8, 256, 256, 12, 2, 128, 128, "full",
     {"with_lse": True}),
    ("MLA 8x256 causal", 8, 256, 256, MLA_H, MLA_H, MLA_HD, MLA_HD_V, "causal", {}),
    ("hymba ERA 8x256", 8, 256, 256, HY_H, HY_KV, HY_HD, HY_HD, "lengths",
     {"window": HY_WINDOW}),
    ("hymba prefill 8x640 causal", 8, HY_PREFILL, HY_PREFILL, HY_H, HY_KV, HY_HD,
     HY_HD, "causal", {"window": HY_WINDOW, "protected": HY_META}),
    ("paligemma ERA 8x256", 8, 256, 256, PG_H, PG_KV, PG_HD, PG_HD, "lengths", {}),
    ("paligemma prefill 8x768 causal", 8, PG_PREFILL, PG_PREFILL, PG_H, PG_KV,
     PG_HD, PG_HD, "causal", {}),
    ("whisper encoder 8x1500", 8, WH_FRAMES, WH_FRAMES, WH_H, WH_H, WH_HD, WH_HD,
     "full", {}),
    ("whisper cross 8x512 over 1500", 8, AR_PROMPT, WH_FRAMES, WH_H, WH_H, WH_HD,
     WH_HD, "full", {}),
)


def flash_ab_inputs():
    """Inputs of every ``FLASH_AB_SHAPES`` entry: name -> (kernel(kf), one
    SDPA call on the same tensors, bound ms)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for name, b, sq, sk, h, kvh, hd, hd_v, mask, extra in FLASH_AB_SHAPES:
        extra = dict(extra)
        with_lse = extra.pop("with_lse", False)
        q = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(b, sk, kvh, hd, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(b, sk, kvh, hd_v, generator=gen, device="cuda").to(torch.bfloat16)
        q_pos = (torch.zeros(sq, dtype=torch.int32, device="cuda") if sq != sk
                 else torch.arange(sq, dtype=torch.int32, device="cuda"))
        kv_pos = torch.arange(sk, dtype=torch.int32, device="cuda")
        g = h // kvh
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        # G query heads folded into the query axis where no causal mask ties
        # a query to its position (SDPA's flash backend then makes no K/V
        # copy), enable_gqa under a causal mask
        qf = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(b, kvh, g * sq, hd)
        kv_mask, am = None, None
        if mask == "lengths":
            kv_mask = fused_kv_mask("cuda")
            am = kv_mask.bool()[:, None, None, :]
            pairs = float(sq * kv_mask.sum())
        elif mask == "causal":
            pairs = float(b * sq * (sq + 1) / 2)
        else:
            pairs = float(b * sq * sk)
        opts = dict(kv_mask=kv_mask, window=extra.get("window", 0),
                    causal=mask == "causal", softcap=0.0,
                    protected=extra.get("protected", 0))

        def kernel(kf, q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, opts=opts,
                   with_lse=with_lse):
            return lambda: kf._forward(q, k, v, q_pos, kv_pos, **opts,
                                       with_lse=with_lse)

        if mask == "causal":
            qt = q.transpose(1, 2)

            def sdpa(qt=qt, kt=kt, vt=vt, gqa=kvh != h):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=gqa)
        else:
            def sdpa(qf=qf, kt=kt, vt=vt, am=am):
                return F.scaled_dot_product_attention(qf, kt, vt, attn_mask=am)
        nbytes = 2.0 * (b * sq * h * (hd + hd_v) + b * sk * kvh * (hd + hd_v))
        flops = 2.0 * h * (hd + hd_v) * pairs
        bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        out[name] = (kernel, sdpa, bound)
    return out


# the clock64 sums of a flash forward built with -DFLASH_CLOCKS (--flash-ab),
# as flash_attention.cu's consumer warps take them: waiting on the ring's
# barriers, issuing the products and waiting for the scores, mask and
# softmax, waiting for P.V behind the softmax, rescaling O and forming P
CLOCK_SLOTS = ("ring_wait", "scores", "mask_softmax", "pv_tail", "rescale")


def clock_split(lib, kernel, slots) -> dict:
    """One launch of ``kernel`` through the clocked build ``lib``: each
    slot's share of the warps' cycles, the rest of the loop's (its start
    and the tiles' bookkeeping), the epilogue's, and the warps' cycles."""
    import ctypes

    read = lib.repro_flash_clocks
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (len(slots) + 2))()
    check(read(buf) == 0, "repro_flash_clocks failed")
    kernel()
    torch.cuda.synchronize()
    check(read(buf) == 0, "repro_flash_clocks failed")
    *parts, loop, total = (float(x) for x in buf)
    out = {name: x / total for name, x in zip(slots, parts)}
    out["start_and_rest"] = (loop - sum(parts)) / total
    out["epilogue"] = (total - loop) / total
    out["warp_cycles"] = total
    return out


def flash_variant_source(text: str, cfg: dict) -> str:
    """``text`` with the FLASH_FWD_CFG entries of ``cfg``'s head dims
    replaced."""
    import re

    for hd, entry in cfg.items():
        pat = rf"X\({hd}(, \d+){{{len(entry)}}}\)"
        check(len(re.findall(pat, text)) == 1, f"flash source: no single {pat}")
        text = re.sub(pat, f"X({', '.join(str(x) for x in (hd, *entry))})", text)
    return text


def flash_ab(parent_src: str) -> None:
    """Build the flash kernel of ``parent_src`` (through its own wrapper),
    this checkout's and the variants of this one (``FLASH_VARIANTS``), each
    with ``-Xptxas -v``, and a -DFLASH_CLOCKS copy of this one; report
    every instance's registers, spills and shared memory; hold each
    against the plain version in every phase-3 case; split the clocked
    copy's loop cycles at every path shape; then time each at every
    ``FLASH_AB_SHAPES`` shape beside SDPA, in the order given and then
    reversed.  Prints one JSON line per variant and round, then a summary
    line."""
    import ctypes
    import importlib.util

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kf

    this = (build.CSRC_DIR / kf.SOURCE).read_text()
    parent_dir = Path(parent_src) / "repro_torch"
    parent_text = (parent_dir / "csrc" / kf.SOURCE).read_text()
    # name -> (source, include directory, extra nvcc flags)
    sources = {"this": (this, build.CSRC_DIR, [])}
    for name, cfg in FLASH_VARIANTS.items():
        sources[name] = (flash_variant_source(this, cfg), build.CSRC_DIR, [])
    sources["parent"] = (parent_text, parent_dir / "csrc", [])
    sources["this clock64"] = (this, build.CSRC_DIR, ["-DFLASH_CLOCKS"])
    vdir = build.BUILD_DIR / f"flash_ab.{os.getpid()}"
    vdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (text, inc, flags)) in enumerate(sources.items()):
        cu, so = vdir / f"v{i}.cu", vdir / f"v{i}.so"
        cu.write_text(text)
        cmd = [build.nvcc_path(), "-I", str(inc), *build.NVCC_FLAGS, *flags,
               "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    # the parent's own wrapper module (its C signature may differ), its
    # library the parent's build
    spec = importlib.util.spec_from_file_location(
        "parent_flash_attention", parent_dir / "kernels" / "flash_attention.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on flash variant {name}:\n{text}")
        lib = ctypes.CDLL(str(so))
        libs[name] = parent.bind(lib) if name == "parent" else kf.bind(lib)
        log(f"flash variant {name}:")
        regs[name] = flash_ptxas(text, lib, kf.HEAD_DIM_PAIRS)
    clocked = libs.pop("this clock64")

    def use(name, lib=None):
        """The wrapper module of ``name``, pointed at its build."""
        mod = parent if name == "parent" else kf
        mod._library = lambda lib=lib or libs[name]: lib
        return mod

    for name in libs:
        log(f"flash variant {name}: max_abs_err {flash_cases(use(name)):.3e}")
    shapes = flash_ab_inputs()

    # where the cycles go: one launch a shape, each consumer warp's kv-loop
    # parts summed over the grid
    mod = use("this", clocked)
    split = {s: clock_split(clocked, kernel(mod), CLOCK_SLOTS)
             for s, (kernel, _, _) in shapes.items()}
    for s, r in split.items():
        log(f"flash this clock64 {s}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in r.items() if k != "warp_cycles"))
    log(json.dumps({"flash_this_clock64": split}))

    names = list(libs)
    rows = []
    for rnd, order in enumerate((names, names[::-1])):
        sdpa_ms = {s: device_ms(sd) for s, (_, sd, _) in shapes.items()}
        for name in order:
            mod = use(name)
            row = dict(variant=name, round=rnd)
            for s, (kernel, _, bound) in shapes.items():
                ms = device_ms(kernel(mod), pick=is_flash_kernel, kernels=1)
                row[s] = dict(ms=ms, library_ms=sdpa_ms[s],
                              kernel_over_library=ms / sdpa_ms[s], bound_ms=bound)
            rows.append(row)
            log(json.dumps(row))
    summary = {}
    for s in shapes:
        mean = {n: sum(r[s]["ms"] for r in rows if r["variant"] == n) / 2 for n in names}
        lib_ms = sum(r[s]["library_ms"] for r in rows) / len(rows)
        summary[s] = dict(
            ms={n: round(m, 6) for n, m in mean.items()}, library_ms=lib_ms,
            bound_ms=shapes[s][2],
            parent_over={n: mean["parent"] / m for n, m in mean.items()})
        log(f"flash-ab {s}: parent {mean['parent']:.5f} ms, this {mean['this']:.5f} "
            f"ms ({mean['parent'] / mean['this']:.2f}x), SDPA {lib_ms:.5f} ms, best "
            f"variant {min(mean, key=mean.get)}")
    log(json.dumps({"flash_ab_summary": summary,
                    "ptxas": {n: regs[n] for n in names}}))


def bwd_ab(parent_src: str) -> None:
    """Build the flash backward of ``parent_src`` and this checkout's, each
    with ``-Xptxas -v``; hold each against the plain version in every
    phase-13 case (through its own wrapper, the forward this checkout's),
    then time each at qwen2's 8x256 and causal 8x512 and hymba's 2x1280,
    parent, this, this, parent.  Prints one JSON line per kernel and
    round."""
    import ctypes
    import importlib.util

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kf

    parent_dir = Path(parent_src) / "repro_torch"
    vdir = build.BUILD_DIR / f"bwd_ab.{os.getpid()}"
    vdir.mkdir(parents=True, exist_ok=True)
    build.build(kf.SOURCE)
    procs = {}
    for name, csrc in (("parent", parent_dir / "csrc"), ("this", build.CSRC_DIR)):
        so = vdir / f"{name}.so"
        cmd = [build.nvcc_path(), "-I", str(csrc), *build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(so), str(csrc / kf.BWD_SOURCE)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    spec = importlib.util.spec_from_file_location(
        "parent_flash_attention", parent_dir / "kernels" / "flash_attention.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    mods, regs = {"parent": parent, "this": kf}, {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on the {name} backward:\n{text}")
        # whichever design's kernel names the source has
        regs[name] = {n: r for names in BWD_LAUNCHES.values() for n in names
                      if (r := parse_ptxas(text, n))}
        lib = mods[name].bind_bwd(ctypes.CDLL(str(so)))
        mods[name]._bwd_library = lambda lib=lib: lib
        mods[name]._library = kf._library
    for name, mod in mods.items():
        errs = bwd_cases(mod)
        log(f"flash backward {name}: ptxas {regs[name]}, worst gradient error "
            f"{max(errs.values()):.3e} of max|plain|")
    for rnd, name in enumerate(("parent", "this", "this", "parent")):
        t = bwd_timings(mods[name])
        row = dict(kernel=name, round=rnd)
        for key, shape in (("qwen2_8x256", t), ("causal_8x512", t["lm_causal_512"]),
                           ("hymba_2x1280", t["hymba"]), ("mla_8x256", t.get("mla")),
                           ("paligemma_8x256", t.get("paligemma"))):
            if shape is None:
                log(f"flash backward {name}: no {key} timing, no instance")
                continue
            row[key] = {k: shape[k] for k in (
                "ms", "ms_l2_cold", "launch_ms", "launch_ms_l2_cold",
                "wrapper_host_ms", "library_ms", "kernel_over_library",
                "bound_ms")}
        log(json.dumps(row))


# variants of the shipped decode kernel that --decode-ab times beside it:
# name -> (blocks a cluster, or None for the plan's own; warps a block)
DECODE_VARIANTS = {
    "cluster 4": (4, 4),
    "cluster 16 (non-portable)": (16, 4),
    "8 warps a block": (None, 8),
}


def decode_ab(parent_src: str) -> None:
    """Build the decode kernel of ``parent_src``, this checkout's and the
    variants of this one (``DECODE_VARIANTS``), each with ``-Xptxas -v``;
    bind the parent's through its own wrapper (its own C signature: a
    host-int position and partial buffers); hold each against the plain
    version in every phase-5 case; then time each at the AR path's cache
    half full and full, L2-warm and L2-cold, in the order parent, this,
    variants, and back.  Prints one JSON line per variant and round."""
    import ctypes
    import importlib.util
    import re
    import types

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as kd

    this = (build.CSRC_DIR / kd.SOURCE).read_text()
    m = re.findall(r"constexpr int NWARPS = (\d+);", this)
    check(len(m) == 1, "decode source: no single NWARPS constant")
    nw0 = int(m[0])
    sources = {f"w{nw0}": this}
    for _, nw in DECODE_VARIANTS.values():
        sources.setdefault(f"w{nw}", this.replace(f"constexpr int NWARPS = {nw0};",
                                                  f"constexpr int NWARPS = {nw};"))
    parent_dir = Path(parent_src) / "repro_torch"
    sources["parent"] = (parent_dir / "csrc" / kd.SOURCE).read_text()
    vdir = build.BUILD_DIR / f"decode_ab.{os.getpid()}"
    vdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = vdir / f"{name}.cu", vdir / f"{name}.so"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, ptx = {}, {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on decode build {name}:\n{text}")
        ptx[name] = text
        libs[name] = ctypes.CDLL(str(so))
    # the parent's own wrapper module, its library the parent's build
    spec = importlib.util.spec_from_file_location(
        "parent_decode_attention", parent_dir / "kernels" / "decode_attention.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    parent.build = types.SimpleNamespace(load=lambda source: libs["parent"])
    log(f"decode parent: ptxas {parse_ptxas(ptx['parent'], 'decode_split_kernel').get(128)}")

    plan = kd.split_plan
    variants = {f"this: plan's cluster, {nw0} warps": (None, nw0), **DECODE_VARIANTS}
    for name in libs:
        if name != "parent":
            kd.bind(libs[name])

    def use(name):
        """Point ``kd`` at the variant's build and cluster size."""
        cluster, nw = variants[name]
        kd._library = lambda lib=libs[f"w{nw}"]: lib
        kd.smem_bytes.cache_clear()
        kd.NWARPS = nw
        kd.split_plan = lambda b, kvh, s, g, cluster=cluster: plan(b, kvh, s, g, cluster)

    for name in variants:
        use(name)
        report = decode_ptxas_report(ptx[f"w{variants[name][1]}"], kd)
        log(f"decode variant {name}: ptxas hd=128 {report['128']}, "
            f"max_abs_err {decode_cases(kd):.3e}")
    log(f"decode parent: max_abs_err {decode_cases(kd, parent.decode_attention):.3e}")

    half, full = decode_inputs(empty=512), decode_inputs(empty=0)
    names = ["parent", *variants]
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            row = dict(variant=name, round=rnd)
            for key, (q, k, v, q_pos, pos) in (("half", half), ("full", full)):
                if name == "parent":
                    t = decode_timings(kd, parent.decode_attention, q, k, v,
                                       int(q_pos.item()), pos, key, full=False)
                else:
                    use(name)
                    t = decode_timings(kd, kd.decode_attention, q, k, v, q_pos,
                                       pos, key, full=name == names[1])
                row[key] = {k: t[k] for k in
                            ("ms", "ms_l2_cold", "library_ms", "library_ms_l2_cold",
                             "bound_ms", "plan") if k in t}
            log(json.dumps(row))


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--era-ab", metavar="PARENT_SRC",
                    help="only time the ERA path's host cost: the "
                         "repro_torch under PARENT_SRC against this one")
    ap.add_argument("--flash-ab", metavar="PARENT_SRC",
                    help="only compare flash kernels: the one under "
                         "PARENT_SRC, this one and its tile variants")
    ap.add_argument("--decode-ab", metavar="PARENT_SRC",
                    help="only compare decode kernels: the one under "
                         "PARENT_SRC, this one and its variants")
    ap.add_argument("--bwd-ab", metavar="PARENT_SRC",
                    help="only compare flash backward kernels: the one under "
                         "PARENT_SRC and this one")
    ap.add_argument("--train-fit", action="store_true",
                    help="only the training memory trials behind phase 13's "
                         "cuts (deepseek's depth, hymba's batch)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only the mesh checks, data parallel over every "
                         "local card")
    ap.add_argument("--era-arch", default="qwen2-1.5b",
                    help="the denoisers --era-ab times, comma-separated "
                         "name or name:layers; 'families' stands for "
                         f"{ERA_FAMILIES}")
    ap.add_argument("--era-host", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    archs = ",".join(ERA_FAMILIES if a == "families" else a
                     for a in args.era_arch.split(","))
    if args.era_host:
        return era_host(args.era_host, archs)
    smi = nvidia_smi()
    log(smi)
    if args.era_ab:
        return era_ab(args.era_ab, archs)
    if args.flash_ab:
        return flash_ab(args.flash_ab)
    if args.decode_ab:
        return decode_ab(args.decode_ab)
    if args.bwd_ab:
        return bwd_ab(args.bwd_ab)
    if args.mesh_only:
        return mesh_only()
    if args.train_fit:
        return train_fit()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import era_update as ku
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import rownorm as kr

    t0 = time.perf_counter()
    ptxas = ptxas_start(build, kf.SOURCE)
    dptxas_out, dptxas = ptxas_start(build, kd.SOURCE)
    bptxas_out, bptxas = ptxas_start(build, kf.BWD_SOURCE)
    gptxas_out, gptxas = ptxas_start(build, kg.SOURCE)
    libs = build.build_all([kf.SOURCE, kd.SOURCE, kf.BWD_SOURCE, kg.SOURCE])
    log(f"built {[lib.name for lib in libs]} in {time.perf_counter() - t0:.1f}s")
    flash_ptxas = ptxas_report(ptxas, kf)
    text, _ = dptxas.communicate()
    dptxas_out.unlink(missing_ok=True)
    check(dptxas.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
    decode_ptxas = decode_ptxas_report(text, kd)
    text, _ = bptxas.communicate()
    bptxas_out.unlink(missing_ok=True)
    check(bptxas.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
    bwd_ptxas = bwd_ptxas_report(text, kf.HEAD_DIM_PAIRS)
    bwd_ptxas["flash_fwd_kernel_lse"] = {
        k: v for k, v in flash_ptxas.items() if k.endswith(" lse")}
    text, _ = gptxas.communicate()
    gptxas_out.unlink(missing_ok=True)
    check(gptxas.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
    gemm_ptxas = gemm_ptxas_report(text, gemm_kernels(kg))

    def done(phase):
        log(f"phase {phase} done at {time.perf_counter() - t0:.1f}s")

    era_errs, era_t = phase_era(ku)
    done(2)
    flash_err, flash_t = flash_cases(kf), flash_timings(kf)
    flash_mla_t = mla_flash_timings(kf)
    done(3)
    dlm = build_dlm()
    era_launches, drain_s, per_nfe_ms, era_busy_ms = phase_slice(ku, kf, kd, dlm)
    check(era_launches["gemm"] > 0, f"the ERA path launched no gemm: {era_launches}")
    mesh_launches, mesh = phase_mesh(ku, kf, kd, dlm)
    request_flops = phase_request_flops(era_busy_ms)
    done(4)
    decode_err, decode_t = phase_decode(kd)
    done(5)
    ar_launches, ar = phase_ar(ku, kf, kd)
    done(6)
    bucketed_launches, bucketed = phase_bucketed(ku, kf, kd, dlm)
    done(7)
    solver_launches, solvers = phase_solvers(ku, kf, kd, dlm)
    done(8)
    frontdoor_launches, frontdoor = phase_frontdoor(ku, kf, kd, dlm)
    done(9)
    invariance_launches, invariance = phase_batch_invariance(ku, kf, kd, kg, kr,
                                                             dlm)
    done(16)
    del dlm
    reserved_mb()
    families_launches, families = phase_families(ku, kf, kd)
    done(10)
    ssm_launches, ssm_hybrid = phase_ssm_hybrid(ku, kf, kd)
    done(11)
    families.update(ssm_hybrid)
    audio_vlm_launches, audio_vlm = phase_audio_vlm(ku, kf, kd)
    done(12)
    families.update(audio_vlm)
    bwd_errs, bwd_t = bwd_cases(kf), bwd_timings(kf)
    training_launches, training = phase_training(kf)
    done(13)
    # after the profiled phases, so that they run as they always have
    int8_launches, int8 = phase_int8(ku, kf, kd)
    examples = phase_examples()
    done(14)
    dryrun_launches, dryrun_memory = phase_dryrun_memory(ku, kf, kd)
    done(15)

    def counts(name):
        by_path = {"era": era_launches[name], "mesh": mesh_launches[name],
                   "ar": ar_launches[name], "ar_int8": int8_launches[name],
                   "bucketed": bucketed_launches[name],
                   "solvers": solver_launches[name],
                   "frontdoor": frontdoor_launches[name],
                   "families": families_launches[name],
                   "ssm_hybrid": ssm_launches[name],
                   "audio_vlm": audio_vlm_launches[name],
                   "training": training_launches[name],
                   "dryrun_memory": dryrun_launches[name]}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    kernels = [
        dict(name="era_update", route="triton",
             source="src/repro_torch/kernels/era_update.py",
             replaces="src/repro/kernels/era_update.py:31",
             **counts("era_update"), max_abs_err=max(era_errs.values()),
             max_abs_err_by_case=era_errs,
             ms=era_t["ms"], kernel_ms=era_t["ms"],
             ms_l2_cold=era_t["ms_l2_cold"], wrapper_ms=era_t["wrapper_ms"],
             plain_ms=era_t["plain_ms"],
             bound_ms=era_t["bound_ms"], bound_by=era_t["bound_by"],
             library_ms=None, shape=era_t["shape"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:34",
             **counts("flash_attention"), max_abs_err=flash_err,
             ms=flash_t["ms"], kernel_ms=flash_t["ms"],
             ms_l2_cold=flash_t["ms_l2_cold"],
             plain_ms=flash_t["plain_ms"], bound_ms=flash_t["bound_ms"],
             bound_by=flash_t["bound_by"], library_ms=flash_t["library_ms"],
             library_ms_l2_cold=flash_t["library_ms_l2_cold"],
             kernel_over_library=flash_t["kernel_over_library"],
             shape=flash_t["shape"], era_seq128=flash_t["era_seq128"],
             ar_prefill=flash_t["prefill"], lse_training=flash_t["lse"],
             mla=flash_mla_t,
             hymba=flash_t["hymba"],
             audio_vlm={k: flash_t[k] for k in (
                 "paligemma_era", "paligemma_prefill", "whisper_encoder",
                 "whisper_cross")},
             ptxas=flash_ptxas),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:23",
             **counts("decode_attention"), max_abs_err=decode_err,
             ms=decode_t["ms"], kernel_ms=decode_t["ms"],
             ms_l2_cold=decode_t["ms_l2_cold"],
             wrapper_ms=decode_t["wrapper_ms"],
             plain_ms=decode_t["plain_ms"], bound_ms=decode_t["bound_ms"],
             bound_by=decode_t["bound_by"],
             library_ms=decode_t["library_ms"],
             library_ms_l2_cold=decode_t["library_ms_l2_cold"],
             kernel_over_library=decode_t["kernel_over_library"],
             kernel_over_library_l2_cold=decode_t["kernel_over_library_l2_cold"],
             shape=decode_t["shape"], plan=decode_t["plan"],
             full_cache=decode_t["full"], in_loop=ar["decode_in_loop"],
             hymba=decode_t["hymba"], paligemma=decode_t["paligemma"],
             whisper=decode_t["whisper"], ptxas=decode_ptxas),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="none: the TPU reference differentiates its naive / "
                      "chunked SDPA with XLA autodiff (src/repro/models/"
                      "attention.py); the backward of "
                      "src/repro/kernels/flash_attention.py:34",
             launches=(training_launches["flash_attention_bwd"]
                       + dryrun_launches["flash_attention_bwd"]),
             launches_by_path={"training": training_launches["flash_attention_bwd"],
                               "dryrun_memory": dryrun_launches["flash_attention_bwd"]},
             max_abs_err=max(bwd_errs.values()), max_abs_err_of="max|plain|",
             max_abs_err_by_case=bwd_errs,
             ms=bwd_t["ms"], kernel_ms=bwd_t["ms"],
             ms_l2_cold=bwd_t["ms_l2_cold"], plain_ms=bwd_t["plain_ms"],
             bound_ms=bwd_t["bound_ms"], bound_by=bwd_t["bound_by"],
             library_ms=bwd_t["library_ms"],
             library_ms_l2_cold=bwd_t["library_ms_l2_cold"],
             kernel_over_library=bwd_t["kernel_over_library"],
             launch_ms=bwd_t["launch_ms"],
             launch_ms_l2_cold=bwd_t["launch_ms_l2_cold"],
             wrapper_host_ms=bwd_t["wrapper_host_ms"],
             shape=bwd_t["shape"], lm_causal_512=bwd_t["lm_causal_512"],
             hymba=bwd_t["hymba"], mla=bwd_t["mla"],
             paligemma=bwd_t["paligemma"], ptxas=bwd_ptxas),
    ]
    inv_t = invariance["timings"]

    def row_kernel(name, route, source, replaces, errs, shape, **extra):
        t = inv_t[shape]
        by_path = {"batch_invariance": invariance_launches[name]}
        if name in COUNTED:
            by_path |= counts(name)["launches_by_path"]
        return dict(name=name, route=route, source=source, replaces=replaces,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
                    ms=t["ms"], kernel_ms=t["ms"], ms_l2_cold=t["ms_l2_cold"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"],
                    library_ms_l2_cold=t["library_ms_l2_cold"],
                    kernel_over_bound=t["kernel_over_bound"], shape=shape, **extra)

    gemm_errs = invariance["gemm_max_abs_err"]
    norm_errs = invariance["rownorm_max_abs_err"]
    kernels += [
        row_kernel("gemm", "cuda", "src/repro_torch/csrc/gemm.cu",
                   "none: the reference's products are XLA dots outside "
                   "Pallas (src/repro/models/layers.py:119, linear)",
                   gemm_errs, "wg 2048x1536x8960",
                   timings={k: v for k, v in inv_t.items() if not k.startswith(
                       ("rmsnorm", "layernorm", "row_sq", "bgemm"))},
                   ptxas=gemm_ptxas),
        row_kernel("bgemm", "cuda", "src/repro_torch/csrc/gemm.cu",
                   "none: the reference's batched products are XLA einsums "
                   "outside Pallas (src/repro/models/moe.py:72, "
                   "src/repro/models/ssm.py:119 and :268-297, slstm's :436)",
                   invariance["bgemm_max_abs_err"],
                   "bgemm experts_wg deepseek 64x240x2048x1408",
                   timings={k: v for k, v in inv_t.items() if k.startswith("bgemm")},
                   gemm_is_bgemm_of_one=invariance["gemm_is_bgemm_of_one"]),
        row_kernel("rmsnorm", "triton", "src/repro_torch/kernels/rownorm.py",
                   "none: the reference's rmsnorm is XLA ops outside Pallas "
                   "(src/repro/models/layers.py:85)",
                   {k: v for k, v in norm_errs.items() if k.startswith("rmsnorm")},
                   "rmsnorm 2048x1536"),
        row_kernel("layernorm", "triton", "src/repro_torch/kernels/rownorm.py",
                   "none: the reference's layernorm is XLA ops outside Pallas "
                   "(src/repro/models/layers.py:97)",
                   {k: v for k, v in norm_errs.items() if k.startswith("layernorm")},
                   "layernorm 2048x512"),
        row_kernel("row_sq_sums", "triton", "src/repro_torch/kernels/rownorm.py",
                   "none: the reference's _seq_sq_sums is XLA ops outside "
                   "Pallas (src/repro/core/era.py:128)",
                   {k: v for k, v in norm_errs.items() if k.startswith("row_sq")},
                   "row_sq_sums 8x256x1536"),
    ]
    log(f"ERA path: drain {drain_s:.3f}s, {per_nfe_ms:.2f} ms per NFE")
    log(f"bucketed ERA drain: {bucketed['drain_ms']:.1f} ms, device busy "
        f"{bucketed['busy_ms']:.1f} ms, idle share {bucketed['idle_share']:.3f}; "
        f"warmup {bucketed['warmup_s']:.2f}s")
    for name, r in solvers.items():
        log(f"solver {name}: replay {r['replay_ms']:.1f} ms, device busy "
            f"{r['busy_ms']:.1f} ms, idle share {r['idle_share']:.3f}; eager "
            f"{r['eager_ms']:.1f} ms; warmup {r['warmup_s']:.2f}s"
            + (f"; mixed-NFE drain {r['mixed_drain_ms']:.1f} ms"
               if "mixed_drain_ms" in r else ""))
    log(f"AR path: prefill {ar['prefill_ms']:.2f} ms, decode "
        f"{ar['decode_ms_per_step']:.3f} ms per step, {ar['tok_s']:.1f} tok/s, "
        f"decode-loop idle share {ar['idle_share']:.3f}, rope "
        f"{ar['rope_op_share']:.3f} of its device ops")
    log(json.dumps({"solvers": solvers}))
    log(json.dumps({"frontdoor": frontdoor}))
    log(json.dumps({"families": families}))
    trained = [("qwen2-1.5b", obj, training[obj]) for obj in TRAIN_STEPS]
    trained += [(arch, obj, f[obj]) for arch, f in training["families"].items()
                if isinstance(f, dict) for obj in FAMILY_TRAIN_STEPS]
    for arch, obj, t in trained:
        log(f"training {arch} {obj}: {t['steps_per_s']:.3f} steps/s, "
            f"{t['tokens_per_s']:.0f} tokens/s, peak {t['peak_mb']:.0f} MiB, "
            f"losses {[round(x, 5) for x in t['losses']]}")
    log(json.dumps({"training": training}))
    log(json.dumps({"mesh": mesh, "request_flops": request_flops,
                    "int8_cache": int8, "examples_s": examples}))
    log(json.dumps({"dryrun_memory": dryrun_memory}))
    log(json.dumps({"batch_invariance": {k: v for k, v in invariance.items()
                                         if k != "timings"}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
