#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and the result lines are
printed only when every phase passed:

1. Card: the GPU's name and power limit, torch/CUDA versions, the nvcc
   build of every kernel from the sources in this checkout (sm_90a), and
   TF32 switched off for matmul and cuDNN.
2. Kernels against their plain versions on the card: fedavg at the main
   paths' fold shapes (the sync folds and the async slice's K=4 flushes)
   and at an LM-scale fold, f32 and bf16, with times
   (CUDA events, median of 20; at the main path's small shapes also as
   device time inside a CUDA graph) beside the memory bound, the plain
   version and one PyTorch call that computes the same function, and the
   host time per call of each of the three (host clock, no synchronise
   inside a window of calls) at K=8 and K=4, N=6922 and at the LM scale.
3. The sync slice: ``repro_torch.api.run_scenario`` on the quickstart
   configuration (3 synthetic tasks, 40 clients, participation 0.2,
   tau=3, 25 rounds, alpha=3, vmap backend) on the card, with fedfair and
   random allocation. Every non-empty (round, task) fold must launch the
   fedavg kernel exactly once.
4. Card against CPU: the same fedfair and round_robin runs on the CPU.
5. The fused_aggregate kernel against its plain version on the card, in
   every mode, at the async slice's flush shapes and at an LM-scale flush
   (rtol/atol 1e-6), with times beside the bytes bound of each mode, the
   plain version and ``disc @ x`` (the one PyTorch call for the reduce
   alone; it leaves out the discount and the moment update).
6. The async slice: ``run_scenario`` with mode="async" (the quickstart's
   tasks and clients, bimodal speeds with spread 4, buffer 4, beta 0.5,
   tau 3, 200 arrivals, vmap backend) on the card, with fedadam (server lr
   0.1, the repo's benchmark setting) and with the default fedavg. Every
   flush must launch fused_aggregate (fedadam) or fedavg (fedavg) exactly
   once. The fedadam run's final server moments must stay on the card.
7. Card against CPU for async: the fedadam run with round_robin must give
   identical event traces on both devices; fedfair is compared too.
8. The rmsnorm kernel against its plain version on the card at the dense
   LM's norm shapes, at the MoE and xLSTM families' widths 2048 and 4096,
   MLA's latent width 512 and phi-3-vision's 3072, and at the edges of its
   launcher (where the threads a row step up, the
   two-pass kernel's widths, part-full blocks; rows x d, f32, bf16 and f16;
   atol 1e-5 / 5e-2 / 1e-2), two calls bit-equal at each, with times at
   (8192, 576), (2048, 2048), (2048, 4096) and (2048, 3072) f32 (device,
   eager and host per call) beside the bytes bound, the plain version and
   ``torch.nn.functional.rms_norm``.
9. The flash_attention kernel: its library's SASS must hold wgmma
   (HGMMA) and TMA loads (UTMALDG); then against its plain version on the
   card at smollm-135m's, a qwen3-like, zamba2-7b's, qwen2-moe-a2.7b's and
   phi-3-vision's (hd 96) attention shape, a small one and a ragged Sq !=
   Sk one, causal and not, f32 and bf16 (atol 2e-5 / 3e-2), with times at
   smollm's, zamba2's, qwen2-moe's and phi-3's shapes in both dtypes beside
   the operations and bytes bound (f32 at the three-pass TF32 rate, with
   the CUDA cores' 67 TFLOP/s figure beside it), the plain version and
   ``scaled_dot_product_attention`` in the same run, eager, as device
   time inside a CUDA graph (beside the device time before the Hopper
   redesign, from PERF.md) and as host time per call.
10. Serving smollm-135m at full width on the card through
   ``repro_torch.launch.serve.generate`` (weights from PRNGKey(0), batch 8,
   prompt 128, 32 greedy tokens): prefill and decode tokens/s, and exactly
   61 rmsnorm launches per forward (30 layers x 2 + the final norm). The
   same generation at batch 2 on the host CPU must give identical tokens
   and prefill logits within 1e-3.
11. The forward loss of smollm-135m with ``use_pallas=True`` at B=4,
   S=2048 on the card: exactly 30 flash_attention and 61 rmsnorm launches
   per forward, the loss within 2e-4 of the ``use_pallas=False`` loss, ms
   per forward and peak memory; card against CPU at B=1, S=256 within 1e-4.
   Then smollm's weights are freed.
12. The gated_rmsnorm kernel against its plain version on the card at
   Mamba2's gate shapes (rows x d for d 128, zamba2's d_inner 7168 and a
   ragged 1001, f32 and bf16; atol 2e-5 / 5e-2), with times at (2048, 7168)
   f32 beside the bytes bound, the plain version and the composite
   ``F.rms_norm(x * F.silu(z))`` (no single PyTorch call computes it).
13. The ssd_scan kernel: its library's Hopper kernels must hold wgmma
   (HGMMA) and TMA loads (UTMALDG) and no mma.sync (HMMA); then against its
   plain versions on the card: against ``ref_ssd`` (the sequential
   recurrence) at the JAX sweep's shapes (atol 5e-4, rtol 1e-3) and its
   chunk invariance (5e-5 / 1e-4); against the model's ``ssd_chunked`` (y
   and final state) at zamba2-7b's loss shape (1, 112, 2048, 64), chunk 256,
   and serve-prefill shape (8, 112, 128, 64), chunk 64, with B and C as
   stride-0 head views, and chunks 64 and 256 against each other at the
   loss shape; bf16 against ``ref_ssd`` at both. The wrapper's size rule
   (``hopper_takes``) sends both shapes to the Hopper route (TMA-fed
   wgmma: a state kernel with the pass over the chunks folded in, then an
   output kernel; 2 device launches a call, and the graph must name only
   those). Times at both shapes in f32 and bf16
   (eager, as device time inside a CUDA graph beside the device time
   before the Hopper redesign from PERF.md, and host time per call) beside
   the operations and bytes bounds (f32 at the three-pass TF32 rate, the
   CUDA cores' figure beside it), ``ref_ssd`` and ``ssd_chunked``, the
   device launches per call, and the mma.sync kernels forced at the same
   inputs (the chunk-parallel ones with 4 launches; at the serve shape also
   the walk per (batch, head) with 2).
14. Serving zamba2-7b at full width and depth (81 layers, 13 shared slots,
   f32 weights from PRNGKey(0)) with ``use_pallas=True``: batch 8, prompt
   128 (so chunk 64), 32 greedy tokens; prefill and decode tokens/s and the
   launches per forward (prefill: 81 gated_rmsnorm, 81 ssd_scan, 108
   rmsnorm; a decode step: 189 rmsnorm). Card against CPU at full width and
   7 layers (one shared slot, one tail layer): batch 2, 4 tokens, identical
   greedy tokens and prefill logits within 1e-3.
15. The zamba2-7b loss at B=1, S=2048, full depth, with ``use_pallas=True``
   (13 flash_attention, 81 ssd_scan, 81 gated_rmsnorm, 108 rmsnorm
   launches) and without: ms per forward, peak memory, the two losses
   within 2e-4.
16. Sync incentives and policies (``benchmarks/experiments.py`` at
   fast=False, one seed, vmap backend): exp5 (synth-mnist and synth-cifar,
   40 clients, participation 0.6, 100 rounds, budget 29, ``exp4`` bids)
   under maxmin_fair, budget_fair and gmmfair; exp11's policies (3 tasks,
   120 clients, participation 0.25, 100 rounds) ucb_bandit and grad_norm;
   exp11's incentives (gmmfair, budget 20, 60 rounds) one_shot and
   periodic_auction every 5. Rounds/s, min-accuracy and the auction
   summary of each; fedavg exactly once per non-empty fold. The kernel is
   then held against its plain version at every (K, N) fold those runs
   made (each cohort is folded at its own size). The exp5 gmmfair and the
   periodic runs with round_robin on the card and on the CPU: identical
   auction ledgers and allocation traces.
17. Async robust aggregators and cost models: exp13 (synth-mnist and
   synth-fmnist, 16 clients, 600 arrivals, buffer 3, beta 0.5, bimodal
   speeds with spread 8) under fedmedian and trimmed_mean (no kernel
   launch) and qfedavg (fedavg once per flush); exp14 (spread 4,
   lognormal_straggler) under thompson and ucb_bandit, with cost_dropouts
   and time to accuracy 0.55; fedadam (server lr 0.1) under
   lognormal_straggler (fused_aggregate once per flush); trace_replay with
   an inline trace drawn from the seed. Flushes/s and min-accuracy of
   each; fedavg and fused_aggregate then held against their plain
   versions at every flush shape those runs made.
   Card against CPU: lognormal_straggler with round_robin gives identical
   event traces and cost_dropouts; fedmedian with round_robin at buffer 4
   params within 1e-4. A 2x2 sweep (alpha x fedmedian/qfedavg, 150
   arrivals a point) with two spawned workers equals the sequential
   payload but for wall times.
18. LM training, sync (``run_scenario`` on the ``arch`` family, vmap
   backend): smollm-135m at full width with tau 2 (true FedAvg: the fedavg
   kernel folds each round's 8 rows at its 134.5 M parameters) and
   qwen3-0.6b at full width with tau 1 (the fused AdamW server step), seq
   256, batch 8, 8 clients, participation 0.5, fedfair alpha 3, 3 rounds.
   s/round, trained tokens/s, final loss and next-token accuracy, peak
   memory; fedavg exactly once per non-empty smollm fold and never for
   qwen3, then held against its plain version at every fold shape; the
   rmsnorm launches of one training step of each (forward through the
   kernel, backward plain). Then one fused AdamW step of zamba2-7b at full
   width and 7 of its 81 layers, B=1, S=512 (time, peak memory). Card
   against CPU: the tiny presets of smollm-135m, qwen1.5-0.5b and zamba2-7b
   (seq 32, batch 4, tau 2, 6 clients, 2 rounds, round_robin): identical
   allocation traces, losses within 1e-3.
19. LM training, async: the same two tasks, both tau 2, 8 clients, 16
   arrivals, buffer 4, beta 0.5, bimodal speeds, fedadam (server lr 0.1).
   Flushes/s, the measured next-token accuracy of every flush, peak
   memory; fused_aggregate exactly once per flush, then held against its
   plain version at every flush shape. The fold kernels are timed at the
   LM shapes of phases 18-19. Card against CPU: the tiny three-task spec
   with 9 arrivals, buffer 3, fedavg, round_robin: identical event traces.
20. Client populations: ``examples/specs/big_population.json`` as written
   (100,000 clients, lazy shards, serial backend, 2 rounds), the same spec
   on the vmap backend (fedavg once per fold, at the cohort's K, each fold
   held against ``ref_fedavg``), and an async run at 100,000 lazy clients
   (bimodal speeds, poisson arrivals, fedadam, buffer 4, 200 arrivals;
   fused_aggregate once per flush). Wall time, rounds/s or flushes/s,
   min-accuracy, launches, peak device memory and peak host RSS; each run
   on the CPU too, with identical allocation or event traces and accuracy
   within 0.01.
21. Checkpoint and resume: (a) the sync quickstart (fedfair, vmap,
   checkpoint every 5 rounds), (b) the async fedadam slice of phase 6
   (checkpoint every 10 flushes), (c) phase 18's LM training (a step after
   round 1, ``checkpoint_keep`` 1, in a temporary directory the phase
   deletes). Each runs uninterrupted with checkpoints, then stopped at a
   mid-run step (by ``rounds`` or ``total_arrivals``) and resumed: the
   same allocation or event trace, params within 1e-6 (LM losses within
   1e-5 where both curves are finite, with no NaN and inf at the same
   places), the same history records; the first flush after the async
   resume launches fused_aggregate; the restored trees on the card.
   Seconds per save, bytes per step, restore time. (d) Across devices:
   steps written on the card resume on the CPU and steps written on the
   CPU resume on the card (quickstart and async fedadam, round_robin),
   with identical traces.
22. qwen2-moe-a2.7b at full width and depth (24 layers, 14.3e9 f32 params
   drawn on the card from PRNGKey(0); init time and peak memory): serving
   batch 8, prompt 128, 32 greedy tokens (chunked attention, as the JAX
   package serves) with exactly 49 rmsnorm launches per prefill and per
   decode step; the loss at B=1, S=2048 with ``use_pallas`` (24
   flash_attention and 49 rmsnorm launches) and without, within 2e-4, ms
   per forward and peak memory. Card against CPU at full width and 1
   layer: batch 2, 4 tokens, identical greedy tokens, prefill logits
   within 1e-3, identical routing (each token's experts and every
   nonzero-gate pick).
23. xlstm-1.3b at full width and depth (42 mLSTM and 6 sLSTM layers, 2.9e9
   params): serving as phase 22's (chunk 64) with exactly 97 rmsnorm
   launches per prefill and per decode step; the loss at B=1, S=2048
   (chunk 256), ms per forward and peak memory, beside the same loss with
   every norm taken by its plain version and with each of its outputs one
   ulp up (how far rounding alone moves it). Card against CPU at full
   width and its first 8 layers (7 mLSTM, 1 sLSTM): identical greedy
   tokens, logits within 1e-3, the loss at B=1, S=256 within 1e-4.
24. LM training on ``examples/train_concurrent_lms.py``'s mix
   (``run_scenario``, arch family, sync, vmap backend): smollm-135m at
   full width with tau 2 (the fedavg fold), xlstm-1.3b at full width and 8
   of 48 layers and qwen2-moe-a2.7b at full width and 2 of 24 layers, both
   tau 1 (fused AdamW); seq 256, batch 8, 8 clients, participation 0.5,
   fedfair alpha 3, 3 rounds. Per task s/round, trained tokens/s, final
   loss and accuracy and the rmsnorm launches of one training step; the
   run's peak memory; fedavg exactly once per non-empty smollm fold, each
   held against ``ref_fedavg`` on its own inputs. Then two fused AdamW
   steps each of xlstm-1.3b at 24 of 48 layers and qwen2-moe-a2.7b at 2 of
   24 layers, B=1, S=512 (time, peak memory). Card against CPU on the tiny
   presets of the three: sync round_robin tau 2 (identical allocation
   traces, losses within 1e-3, fedavg once per non-empty fold) and async
   fedadam (identical event traces, fused_aggregate once per flush); the
   card's folds and flushes of both are held against ``ref_fedavg`` and
   ``ref_fused_aggregate`` at the shapes they were made at.
25. deepseek-v2-lite-16b (MLA on the MoE) at full width and depth (27
   layers, 15,706,484,224 f32 params drawn on the card from PRNGKey(0);
   init time and peak memory against the predicted 72.7 GiB): serving as
   phase 22's, once with the latent expanded in decode and once absorbed
   (``mla_absorb``), each with exactly 82 rmsnorm launches (ln1, ln2 and
   the latent's kv_norm of 27 layers, and the final norm) and no other
   kernel per prefill and per decode step; the two settings' decode logits
   over the same inputs within 2e-3; the loss at B=1, S=2048 with
   ``use_pallas`` (MLA takes no kernel: 82 rmsnorm launches) and without,
   within 2e-4, beside one layer's MLA attention and MoE FFN timed alone.
   Card against CPU at full width and 2 layers (the dense
   first layer and one MoE layer), both settings: batch 2, 4 tokens,
   identical greedy tokens, prefill logits within 1e-3, identical routing.
26. whisper-medium at full size (24 encoder and 24 decoder layers,
   811,864,064 params): serving batch 8 over frames (8, 1500, 1024) drawn
   as the serve launcher draws them, prompt 128, 32 greedy tokens, and the
   loss at B=4, S=448 over 1,500 frames, with no kernel launched (LayerNorm
   and the chunked attention, as in the JAX package). Card against CPU at 2
   encoder and 2 decoder layers: identical greedy tokens, prefill logits
   within 1e-3.
27. Both archs in training (``run_scenario``, arch family, vmap backend,
   phase 18's settings): whisper-medium at full size with tau 2 (the
   fedavg fold at 811.9 M params, each call held against ``ref_fedavg``)
   and deepseek-v2-lite at full width and 2 layers with tau 1 (fused
   AdamW), sync, 3 rounds; s/round, trained tokens/s, peak memory. Then
   whisper alone async (tau 2, 16 arrivals, fedadam) at a buffer of 2 (4
   does not fit its flush on the card): fused_aggregate once per flush,
   flushes/s, peak memory. Card against CPU on the tiny presets of both,
   sync (round_robin, tau 2) and async (fedadam): identical allocation or
   event traces, losses within 1e-3.
28. phi-3-vision-4.2b (the vlm family) at full width and depth (32
   layers, 3,822,259,200 f32 params drawn on the card from PRNGKey(0)):
   serving as phase 22's behind 256 zero image embeddings (decode positions
   after the image), exactly 65 rmsnorm launches per prefill and per
   decode step; the loss at B=1, S=2048 (256 image embeddings, 0.02 *
   normal, and 1,792 text tokens) with ``use_pallas`` (32 flash_attention
   launches at hd 96 and 65 rmsnorm) and without, within 2e-4. Card
   against CPU at full width and 2 layers, the image included: batch 2, 4
   tokens, identical greedy tokens, prefill logits within 1e-3.
29. phi-3-vision in training (``run_scenario``, arch family, vmap backend,
   phase 18's settings at seq 512: 256 image slots and 256 text tokens),
   each mode alone, cut in depth: sync tau 1 (fused AdamW) at 8 of 32
   layers; sync tau 2 at 4 (the fedavg fold at 651.2 M params, each call
   held against ``ref_fedavg``); async fedadam at 4, buffer 2
   (fused_aggregate once per flush, each flush shape held). s/round,
   trained tokens/s, flushes/s, peak memory. Card against CPU on the tiny
   presets of phi-3 and smollm-135m, sync (round_robin, tau 2) and async
   (fedadam): identical allocation or event traces, losses within 1e-3.
30. The serving queue at full width: 16 requests drawn from a seed
   (prompts of 16-128 tokens, 8-32 new ones) through 8 slots, after a
   two-request warm-up. ``WaveBatcher`` over smollm-135m and phi-3 (a
   vlm's waves behind zero images): every wave equals ``generate`` on its
   left-padded batch. ``ContinuousBatcher`` over qwen1.5-0.5b and phi-3
   (per-row decode; a vlm is fed no image, as in the JAX package): every
   request equals a direct B=1 prefill and decode fed its tokens. A
   flipped token fails the phase unless its margin (top logit less the
   logit of the token served) is below the logit difference the phase
   measured between the two paths (printed). tok/s, mean latency, mean
   TTFT; rmsnorm the only kernel launched.
31. Multi-GPU paths on the one card. (a) The ``sharded`` cohort backend
   (``run_scenario``, ``backend="sharded"``) on phase 3's quickstart spec
   and exp13's fedadam async spec: on the default cohort mesh (this
   host's cards; with one card ``vmap``'s path) bit-equal to the ``vmap``
   run, and on meshes that repeat the card (``(cuda:0, cuda:0)``,
   ``(cuda:0,) * 3``: each cohort split into parts, one ``local_fn`` a
   part) with identical traces, each cohort bit-equal to ``vmap`` run on
   its parts and measured against ``vmap`` on the whole cohort beside
   ``serial`` (``CohortCheck``), the sync run within 1e-6 of ``vmap``'s
   and the async fedadam run, which carries each flush's rounding into
   the next, by phase 7's rule (final accuracy within 0.01); fedavg once
   per non-empty fold and fused_aggregate once per flush, as on
   ``vmap``, each held against its plain version at the shapes the runs
   made; rounds/s and flushes/s beside ``vmap``'s (not a multi-GPU
   figure).
   (b) qwen3-0.6b at full width and depth (596.2 M f32 params), B=8,
   S=256, on DTensors of a (1, 1) ('data', 'model') mesh of a 1-rank NCCL
   group (``sharding.partition``: the params laid out by
   ``tree_param_specs``, the activations and logits constrained) against
   the same params as plain tensors: the loss with and without
   ``use_pallas`` (113 rmsnorm launches a forward, 28 flash under
   ``use_pallas``, on both sides; within 1e-6 relative), one AdamW step
   (``server_opt``): gradients within 1e-6 x max(1, max|g|), params by
   the first-step rule of ``tests/test_torch_train.py``, every param's
   placements kept; step time on DTensors against plain, peak memory.
32. Every family on DTensors, and the dry-run. (a) zamba2-7b (one group
   of 6 Mamba2 layers and its shared slot), qwen2-moe-a2.7b and
   deepseek-v2-lite-16b (2 layers; MLA expanded, and absorbed with its
   cache split by sequence), xlstm-1.3b (7 mLSTM + 1 sLSTM) and
   whisper-medium (2 + 2 layers) at full width, f32, and qwen3-0.6b at
   full depth, on DTensors of a (1, 1) mesh of a 1-rank NCCL group
   against the same params as plain tensors: the loss at B=4, S=256 with
   and without ``use_pallas`` (within 1e-6 relative; the same launches a
   forward on both sides, zamba2's ``ssd_scan`` and ``gated_rmsnorm`` on
   the local shards), a prefill of 8 x 128 and 8 greedy tokens with caches
   laid out by ``partition.cache_spec`` (identical tokens and MoE routing,
   logits within 1e-4). (b) ``python -m repro_torch.launch.dryrun`` of
   qwen3-0.6b x train_4k and deepseek-v2-lite-16b x decode_32k on the
   host, each in its own process on a fake group of 256 ranks, with a
   timeout: each record ``ok``, on meta tensors only.
33. The key-driven allocators and the linter. (a) ``core.allocation``'s
   ``allocate`` under fedfair, random and round_robin, 8 keys each, at
   the quickstart's 40 clients and ``examples/specs/big_population.json``'s
   100,000, ``assign_completion`` over 1,000 keys in one call with
   eligibility rows from a seeded numpy stream (an all-zero row gives -1)
   and its first 100 keys one call each, and ``selection_probability``, on
   the card against the same calls on the CPU: task ids bit-equal, the
   probabilities within 1e-6 relative, every card call made with its
   inputs on the card under torch's sync debug mode (any host sync
   raises). ms per call on the card (CUDA events) and host us per one-key
   ``assign_completion`` call, all taken first. (b) After (a)'s timings,
   beside its checks, in fresh processes on the card's host: ``python -m
   repro_torch.analysis src/repro_torch`` exits 0 with 0 findings, with
   its wall time, and ``python -m repro_torch.analysis --dump-markdown``
   and ``python -m repro_torch.api.registry --dump-markdown`` equal the
   committed ``docs/ANALYSIS_TORCH.md`` and ``docs/REGISTRY_TORCH.md``.
34. A JSON line describing every kernel, the card line, and the final
   ``{"ok": true, "device": ...}`` line.

In phases 16-20, 24, 27 and 29 every fedavg call of the card's runs is also held
against ``ref_fedavg`` on its own inputs as it runs (``FoldShapes``); the
seconds and the device memory of that check are kept out of the times and
peaks the phases report.

Needs CUDA, nvcc (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda``)
and nothing of the JAX package. Runs with the CUDA caching allocator's
expandable segments (``PYTORCH_CUDA_ALLOC_CONF``, unless set otherwise).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores,
# dense bf16 rate of the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# f32-accurate products on the tensor cores: the dense TF32 rate over the
# three passes of the big/small split (one TF32 pass keeps ~3 digits). The
# least time the card can take for f32 attention or SSD products; a kernel
# on that route may beat the CUDA-core bound at PEAK_F32_FLOP_PER_S.
PEAK_TF32X3_FLOP_PER_S = 494.7e12 / 3

MAIN_K = (1, 3, 4, 8, 16)           # sync cohorts; K=4 is the async slice's flush
MAIN_N = (1738, 3786, 6922, 2049)   # synth-mnist, -fmnist, -cifar MLPs; a ragged N
TIMED_MAIN = (8, 6922)              # the largest fold the sync slice makes
LM_K, LM_N = 8, 2**27               # about smollm-135m's parameter count
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TASKS = ("synth-mnist", "synth-cifar", "synth-fmnist")
ROUNDS = 25

FUSED_K = (1, 3, 4, 8)
FUSED_TIMED = (4, 6922)             # the largest flush the async slice makes
FUSED_TOL = 1e-6                    # rtol and atol, as tests/test_aggregators.py
FUSED_SCALARS = dict(beta=0.5, lr=1.0, beta1=0.9, beta2=0.99, eps=1e-3)
ARRIVALS = 200
SERVER_OPTIONS = {"fedadam": {"lr": 0.1}}   # benchmarks/experiments.py exp13

LM_ARCH = "smollm-135m"
# (rows, d): a token of smollm (d 576) at 1, B*S = 8192 and a ragged 8193
# rows; qwen3's qk-norms (d = hd) over 4096 tokens x 9 and 2048 x 16 heads;
# qwen3's d_model 1024 at a ragged 4097 rows
# qwen2-moe's and xlstm's d_model 2048 and mLSTM's gate width 4096, and
# MLA's kv_norm over deepseek-v2-lite's latent of 512, at a decode step (8
# rows), the serve prefill (8 x 128) and the loss (1 x 2048); phi-3-vision's
# d_model 3072 at a decode step, its serve prefill (8 x (256 + 128)) and loss
NORM_SHAPES = ((1, 576), (8192, 576), (8193, 576), (4096 * 9, 64), (2048 * 16, 128),
               (4097, 1024), (8, 2048), (1024, 2048), (2048, 2048), (8, 4096), (1024, 4096),
               (2048, 4096), (8, 512), (1024, 512), (2048, 512), (8, 3072), (3072, 3072),
               (2048, 3072))
# the edges of the kernel's launcher (tests/test_torch_lm_kernels.py):
# where the threads a row step up (d 2048, 4096, 8192, just past 2048 and
# the most, 16384), the two-pass kernel (d 33000 beyond the registers, d
# 1001 and, in 2-byte types, d 100 off the 16-byte packs) and part-full
# blocks (2047, 1025, 257 rows)
NORM_EDGES = ((2047, 2048), (2048, 2052), (1025, 4096), (3, 8192), (2, 16384), (3, 33000),
              (33, 1001), (5, 100), (300, 64), (257, 128))
NORM_TIMED = (8192, 576)
NORM_FAMILIES = ((2048, 2048), (2048, 4096), (2048, 3072))   # the families' loss shapes, timed
# tests/test_kernels.py; f16 one f16 ulp below 16 (tests/test_torch_lm_kernels.py)
NORM_TOL = {"float32": 1e-5, "bfloat16": 5e-2, "float16": 1e-2}
# (B, H, KV, Sq, Sk, hd): smollm-135m's forward at B=4 S=2048, a qwen3-like
# head layout, the JAX sweep's small shape, a ragged Sq != Sk, zamba2-7b's
# shared attention at B=1 S=2048 (hd 3584 / 32 = 112), qwen2-moe-a2.7b's
# loss at B=1 S=2048 (hd 2048 / 16 = 128), phi-3-vision's loss at B=1
# S=2048 (hd 3072 / 32 = 96)
FLASH_SHAPES = ((4, 9, 3, 2048, 2048, 64), (1, 16, 8, 2048, 2048, 128), (2, 4, 2, 256, 256, 32),
                (1, 4, 2, 200, 456, 64), (1, 32, 32, 2048, 2048, 112),
                (1, 16, 16, 2048, 2048, 128), (1, 32, 32, 2048, 2048, 96))
FLASH_ZAMBA = FLASH_SHAPES[4]
FLASH_MOE = FLASH_SHAPES[5]
FLASH_VLM = FLASH_SHAPES[6]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}    # tests/test_kernels.py
# flash's device times (CUDA graph, ms) at the timed shapes before the
# Hopper redesign (the mma.sync kernel), as PERF.md row 3 records them
# (NVIDIA H100 80GB HBM3, 700 W). Printed as text beside this run's times
# and kept out of the kernels line, which holds only this run's numbers.
FLASH_BEFORE_MS = {(FLASH_SHAPES[0], "float32"): 0.4517, (FLASH_SHAPES[0], "bfloat16"): 0.1100,
                   (FLASH_ZAMBA, "float32"): 0.7313, (FLASH_ZAMBA, "bfloat16"): 0.1464,
                   (FLASH_MOE, "float32"): 0.4200, (FLASH_MOE, "bfloat16"): 0.1126,
                   (FLASH_VLM, "float32"): 0.5889, (FLASH_VLM, "bfloat16"): 0.1389}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 128, 32
LOSS_B, LOSS_S = 4, 2048

HYBRID_ARCH = "zamba2-7b"
# (rows, d) of Mamba2's gate: a decode row, the serve prefill (8 x 128) and
# the loss (1 x 2048) at zamba2's d_inner, a ragged row count, the smoke
# width, a width that is no multiple of 8
GATED_SHAPES = ((1, 7168), (1024, 7168), (2048, 7168), (257, 7168), (300, 128), (33, 1001))
GATED_TIMED = (2048, 7168)
GATED_TOL = {"float32": 2e-5, "bfloat16": 5e-2}    # tests/test_kernels.py (f32), RMSNorm's (bf16)
# (B, H, L, P, N, chunk): tests/test_kernels.py::test_ssd_scan_sweep's shapes
# and a ragged one (L % chunk != 0, N not a multiple of 4)
SSD_SMALL = ((1, 1, 64, 16, 8, 16), (2, 3, 128, 32, 16, 32), (1, 2, 96, 8, 4, 48),
             (2, 1, 256, 64, 64, 128), (1, 3, 100, 12, 6, 32))
# zamba2-7b's scans: H = 112 heads of P = 64, state N = 64; the loss at B=1
# S=2048 (chunk 256) and the serve prefill at B=8 P=128 (chunk 64)
SSD_LOSS = (1, 112, 2048, 64, 64, 256)
SSD_SERVE = (8, 112, 128, 64, 64, 64)
SSD_TOL = dict(atol=5e-4, rtol=1e-3)               # tests/test_kernels.py
SSD_CHUNK_TOL = dict(atol=5e-5, rtol=1e-4)         # test_ssd_scan_state_continuity
SSD_BF16_TOL = dict(atol=5e-2, rtol=1e-2)          # y in bf16 (tests/test_torch_ssm_kernels.py)
# ssd_scan's device times (CUDA graph, ms) and device launches a call at the
# two shapes before the Hopper redesign (the mma.sync kernels), as PERF.md
# row 6 records them (NVIDIA H100 80GB HBM3, 700 W). Printed as text beside
# this run's times and kept out of the kernels line.
SSD_BEFORE_MS = {("loss", "float32"): 0.2630, ("loss", "bfloat16"): 0.3317,
                 ("serve", "float32"): 0.0873, ("serve", "bfloat16"): 0.0950}
SSD_BEFORE_LAUNCHES = {"loss": 4, "serve": 2}
HYBRID_CPU_LAYERS, HYBRID_CPU_BATCH, HYBRID_CPU_GEN = 7, 2, 4
HYBRID_LOSS_B, HYBRID_LOSS_S = 1, 2048

# benchmarks/experiments.py at fast=False, one seed: exp5 (auctions feeding
# FedFairMMFL), exp11 (policies; incentives), exp13 (aggregators), exp14
# (cost models)
EXP5 = dict(tasks=("synth-mnist", "synth-cifar"), clients=40, participation=0.6, rounds=100,
            budget=29.0, mechanisms=("maxmin_fair", "budget_fair", "gmmfair"))
EXP11 = dict(tasks=TASKS, clients=120, participation=0.25, rounds=100,
             policies={"ucb_bandit": {"epsilon": 0.2}, "grad_norm": {}})
# exp11's incentive half: exp5's tasks and clients at another budget and length
EXP11_INC = dict(budget=20.0, rounds=60,
                 incentives={"one_shot": {}, "periodic_auction": {"every": 5}})
EXP13 = dict(tasks=("synth-mnist", "synth-fmnist"), clients=16, arrivals=600, buffer=3,
             spread=8.0, aggregators={"fedmedian": {}, "trimmed_mean": {"trim": 0.2},
                                      "qfedavg": {"q": 1.0}})
EXP14_SPREAD, EXP14_TARGET = 4.0, 0.55
# the sweep's runs, cut from exp13's 600 arrivals: it checks that spawned
# workers give the sequential payload, which needs no full-length run
SWEEP_ARRIVALS = 150
LOGNORMAL = {"sigma": 0.6, "straggler_frac": 0.25, "straggler_factor": 4.0, "dropout_prob": 0.05}

# LM training (the arch family): two full-width tasks, smollm-135m as true
# FedAvg (tau 2: the fedavg fold at its full parameter count) and
# qwen3-0.6b as the fused AdamW server step (tau 1); async both at tau 2
# under fedadam (fused_aggregate at both parameter counts)
ARCH_SYNC = dict(tasks={"smollm-135m": dict(preset="full", seq=256, batch=8, tau=2),
                        "qwen3-0.6b": dict(preset="full", seq=256, batch=8, tau=1)},
                 clients=8, participation=0.5, rounds=3)
ARCH_ASYNC = dict(tau=2, arrivals=16, buffer=4, beta=0.5, aggregator="fedadam",
                  options={"lr": 0.1})
# zamba2-7b at full width: 7 of its 81 layers (f32 params, grads and two
# AdamW moments of all 81 need 108.6 GB), B=1 S=512
ARCH_ZAMBA = (7, 1, 512)
# client populations (phase 20): the repo's 100,000-client spec, and an
# async run of the same population
BIG_POP = ROOT / "examples" / "specs" / "big_population.json"
POP_ASYNC = dict(arrivals=200, buffer=4, speed_profile="bimodal", arrival_process="poisson",
                 aggregator="fedadam", options={"lr": 0.1})
# checkpoint and resume (phase 21): the cadence of each run and the step
# it is stopped after
RESUME_SYNC = dict(every=5, stop_round=10)
RESUME_ASYNC = dict(every=10, stop_arrivals=100)
RESUME_PARAMS_TOL, RESUME_LOSS_TOL = 1e-6, 1e-5
# card against CPU: the tiny presets of three archs
ARCH_TINY = dict(archs=("smollm-135m", "qwen1.5-0.5b", "zamba2-7b"),
                 options=dict(preset="tiny", seq=32, batch=4, tau=2), clients=6, rounds=2,
                 arrivals=9, buffer=3)

# the MoE and xLSTM families (phases 22-24): serving and the loss at full
# width and depth, weights from PRNGKey(0); card against CPU at full width
# and the first layers (1 of qwen2-moe's 24; xlstm's first group, 7 mLSTM
# and 1 sLSTM), batch 2, 4 tokens
MOE_ARCH, XLSTM_ARCH = "qwen2-moe-a2.7b", "xlstm-1.3b"
MOE_LOSS_B, MOE_LOSS_S = 1, 2048
XLSTM_LOSS_B, XLSTM_LOSS_S = 1, 2048
MOE_CPU_LAYERS, XLSTM_CPU_LAYERS = 1, 8
CPU_BATCH, CPU_GEN = 2, 4
XLSTM_CPU_LOSS_S = 256
# examples/train_concurrent_lms.py's mix: smollm-135m at full width as true
# FedAvg (tau 2: the fedavg fold), xlstm-1.3b and qwen2-moe-a2.7b at full
# width as the fused AdamW step (tau 1), cut in depth; then two AdamW steps
# each at (layers, B, S). The step's peak is about 32 B a param (params,
# grads, clipped grads and two f32 moments, and the new params and moments
# before the old ones go): 93 GB for all of xlstm's 48 layers (2.9e9
# params), 75 GB for 3 of qwen2-moe's 24 (2.3e9), of the card's 80
FAMILIES_SYNC = dict(tasks={"smollm-135m": dict(preset="full", seq=256, batch=8, tau=2),
                            "xlstm-1.3b": dict(preset="full", seq=256, batch=8, tau=1),
                            "qwen2-moe-a2.7b": dict(preset="full", seq=256, batch=8, tau=1)},
                     layers={"xlstm-1.3b": 8, "qwen2-moe-a2.7b": 2}, clients=8)
FAMILIES_STEP = {"xlstm-1.3b": (24, 1, 512), "qwen2-moe-a2.7b": (2, 1, 512)}
FAMILIES_TINY = dict(archs=("smollm-135m", "xlstm-1.3b", "qwen2-moe-a2.7b"),
                     options=dict(preset="tiny", seq=32, batch=4, tau=2), clients=6, rounds=2,
                     arrivals=9, buffer=3)

# deepseek-v2-lite-16b (MLA on the MoE; phase 25) and whisper-medium
# (encoder-decoder; phase 26) at full width and depth, weights from
# PRNGKey(0); the MLA loss at B=1 S=2048 and whisper's at B=4 S=448 (its
# published text context) over 1,500 frames; card against CPU at full
# width and the first layers (deepseek's dense layer and one MoE layer;
# whisper's first 2 encoder and 2 decoder layers), batch 2, 4 tokens
MLA_ARCH, AUDIO_ARCH = "deepseek-v2-lite-16b", "whisper-medium"
MLA_PARAMS = 15_706_484_224
MLA_INIT_PEAK_GIB = 72.7            # predicted: qwen2-moe's init overhead scaled by the leaf
MLA_LOSS_B, MLA_LOSS_S = 1, 2048
AUDIO_LOSS_B, AUDIO_LOSS_S = 4, 448
MLA_CPU_LAYERS, AUDIO_CPU_LAYERS = 2, 2
# phase 27: both archs in training, with phases 18 and 24's settings:
# whisper-medium at full size (tau 2, the fedavg fold) and deepseek at full
# width and 2 layers (tau 1, fused AdamW); async whisper alone at tau 2
# under fedadam at a buffer of 2: a flush holds several (buffer, N) copies
# of its 3.02 GiB of params (the cohort, the deltas, their stack, the flat
# copy) beside the moments, retained versions and a row's activations over
# 4 x 1,500 frames, and at a buffer of 2 it already peaked at 74.7 GiB of
# an H100's 79
MLA_AUDIO_SYNC = dict(tasks={AUDIO_ARCH: dict(preset="full", seq=256, batch=8, tau=2),
                             MLA_ARCH: dict(preset="full", seq=256, batch=8, tau=1)},
                      layers={MLA_ARCH: 2}, clients=8)
AUDIO_ASYNC_BUFFER = 2
MLA_AUDIO_TINY = dict(archs=(MLA_ARCH, AUDIO_ARCH),
                      options=dict(preset="tiny", seq=32, batch=4, tau=2), clients=6, rounds=2,
                      arrivals=9, buffer=3)

# phi-3-vision-4.2b (the vlm family; phase 28) at full width and depth,
# weights from PRNGKey(0): serving as smollm's behind 256 zero image
# embeddings (the vision tower is a stub, as in the JAX package); the loss
# at B=1 S=2048 (256 image + 1,792 text tokens) over 0.02 * normal image
# embeddings; card against CPU at full width and 2 layers
VLM_ARCH = "phi-3-vision-4.2b"
VLM_PARAMS = 3_822_259_200
VLM_LOSS_B, VLM_LOSS_S = 1, 2048
VLM_CPU_LAYERS = 2
# phase 29: phase 18's settings at seq 512 (256 image + 256 text tokens;
# at seq 256 the text would be empty and the loss 0), each mode alone,
# cut in depth: AdamW's ~32 B a param holds tau 1 to 8 of 32 layers
# (1.104e9 params, 35.3 GB); the tau 2 fold (8 rows of 651.2 M params and
# their copies, ~47 GB) and the async flush at a buffer of 2 to 4 layers
VLM_TRAIN = dict(seq=512, batch=8, clients=8, adamw_layers=8, fold_layers=4, async_layers=4,
                 async_buffer=2)
VLM_TINY = dict(archs=(VLM_ARCH, "smollm-135m"),
                options=dict(preset="tiny", seq=32, batch=4, tau=2), clients=6, rounds=2,
                arrivals=9, buffer=3)
# phase 30: a correctness smoke of the serving queue at full width (not a
# user workload): 16 requests (prompts of 16-128 tokens, 8-32 new ones,
# drawn from the seed) through 8 slots, enough to fill waves and to
# admit into freed slots; WaveBatcher over smollm-135m and phi-3,
# ContinuousBatcher over qwen1.5-0.5b and phi-3 (its horizon: the
# longest prompt and answer)
QUEUE = dict(requests=16, prompt=(16, 128), max_new=(8, 32), slots=8, seed=30)
QUEUE_WAVE = ("smollm-135m", VLM_ARCH)
QUEUE_CONTINUOUS = ("qwen1.5-0.5b", VLM_ARCH)
# phase 31: the sharded backend over forced meshes that repeat the one card
# (a device named twice runs two parts of each cohort), and the dense LM
# step on DTensors of a 1-rank NCCL group's (1, 1) ('data', 'model') mesh
SHARDED_MESHES = (("cuda:0", "cuda:0"), ("cuda:0",) * 3)
DTENSOR_LM = dict(arch="qwen3-0.6b", B=8, S=256, reps=3)
ADAM_ILL, ADAM_SHARE = 1e-6, 1e-3      # tests/test_torch_train.py's first-step rule


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, inner: int = 1, reps: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, inner: int = 200, reps: int = 20) -> float:
    """Host time per call: median over ``reps`` windows of ``inner``
    back-to-back calls on the host clock, with no synchronise inside a
    window (so the kernels a call enqueues do not hold the host back while
    the launch queue has room) and one between windows."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter_ns() - t0) / 1e6 / inner)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(fn, inner: int = 200, reps: int = 20) -> float:
    """Device time per call: ``inner`` calls captured once in a CUDA graph,
    the graph replayed and timed as in ``time_ms``. Unlike back-to-back
    eager calls this leaves out the host's per-call overhead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, reps=reps) / inner


def fold_bound_ms(K: int, N: int, in_bytes: int, out_bytes: int) -> tuple:
    """Least time for the fold: x and w read once, out written once, at the
    data-sheet bandwidth; 2*K*N f32 flops at the f32 rate. The larger wins."""
    bytes_ms = (K * N * in_bytes + 4 * K + N * out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * K * N / PEAK_F32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_card():
    import torch

    from repro_torch.kernels.build import KERNELS, load_all

    print("== phase 1: card")
    line = card_line()
    print(f"card: {line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for name, built in load_all(KERNELS).items():
        print(f"nvcc build {name}: {built.seconds:.2f} s -> {built.path.name}")
        for ln in built.log.strip().splitlines():
            print(f"  {ln}")
    print(f"all kernels built in {time.perf_counter() - t0:.2f} s (one nvcc per source, "
          "started together)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


def _fold_inputs(rng, K, N, dev):
    import numpy as np
    import torch

    x = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(dev)
    r = rng.standard_normal(K).astype(np.float64)
    w = np.exp(r - r.max())
    return x, torch.from_numpy((w / w.sum()).astype(np.float32)).to(dev)


def phase_kernels():
    import numpy as np
    import torch

    from repro_torch.kernels import fedavg
    from repro_torch.kernels.ref import ref_fedavg

    print("== phase 2: fedavg kernel vs plain version on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    timed = {}
    for K in MAIN_K:
        for N in MAIN_N:
            x32, w = _fold_inputs(rng, K, N, dev)
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                x = x32.to(dtype)
                got, want = fedavg(x, w), ref_fedavg(x, w)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != (N,):
                    fail(f"fedavg K={K} N={N} {name}: got {got.dtype} {tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                errs[name] = max(errs[name], err)
                if not err <= TOL[name]:
                    fail(f"fedavg K={K} N={N} {name}: max |err| {err} > {TOL[name]}")
            if (K, N) in (TIMED_MAIN, FUSED_TIMED):
                bound, by = fold_bound_ms(K, N, 4, 4)
                fns = {"": lambda: fedavg(x32, w), "plain_": lambda: ref_fedavg(x32, w),
                       "library_": lambda: w @ x32}
                rec = timed[(K, N)] = {"bound_ms": bound, "bound_by": by}
                for key, fn in fns.items():
                    rec[f"{key}ms"] = graph_ms(fn)
                    rec[f"eager_{key}ms"] = time_ms(fn, inner=200)
                    rec[f"host_{key}ms"] = host_ms(fn)
    print(f"main-path shapes K in {MAIN_K} x N in {MAIN_N}: max |err| "
          f"f32 {errs['float32']:.3g} (tol {TOL['float32']}), "
          f"bf16 {errs['bfloat16']:.3g} (tol {TOL['bfloat16']})")
    for (K, N), rec in timed.items():
        print(f"main-path fold K={K} N={N} f32, device time (CUDA graph): kernel "
              f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms, library (w @ x) "
              f"{rec['library_ms']:.5f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}); "
              f"eager per call: kernel {rec['eager_ms']:.5f} ms, plain "
              f"{rec['eager_plain_ms']:.5f} ms, library {rec['eager_library_ms']:.5f} ms; "
              f"host per call: wrapper {rec['host_ms']:.5f} ms, plain {rec['host_plain_ms']:.5f} "
              f"ms, library {rec['host_library_ms']:.5f} ms")

    lm = {}
    t0 = time.perf_counter()
    x32 = torch.from_numpy(rng.random((LM_K, LM_N), dtype=np.float32)).to(dev).mul_(2).sub_(1)
    _, w = _fold_inputs(rng, LM_K, 1, dev)
    print(f"LM-scale inputs K={LM_K} N={LM_N}: {time.perf_counter() - t0:.1f} s to make")
    for name, dtype, size in (("float32", torch.float32, 4), ("bfloat16", torch.bfloat16, 2)):
        x = x32 if dtype == torch.float32 else x32.to(dtype)
        got, want = fedavg(x, w), ref_fedavg(x, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[name]:
            fail(f"fedavg LM-scale {name}: max |err| {err} > {TOL[name]}")
        errs[name] = max(errs[name], err)
        bound, by = fold_bound_ms(LM_K, LM_N, size, size)
        w_lib = w.to(dtype)
        fns = {"": lambda: fedavg(x, w), "plain_": lambda: ref_fedavg(x, w),
               "library_": lambda: w_lib @ x}
        rec = {"bound_ms": bound, "bound_by": by, "max_abs_err": err}
        for key, fn in fns.items():
            rec[f"{key}ms"] = time_ms(fn)
            rec[f"host_{key}ms"] = host_ms(fn, inner=5, reps=5)
        lm[name] = rec
        del got, want
        print(f"LM-scale fold K={LM_K} N={LM_N} {name}: kernel {rec['ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of the {by} bound {rec['bound_ms']:.4f} ms), "
              f"plain {rec['plain_ms']:.4f} ms, library (w @ x) {rec['library_ms']:.4f} ms, "
              f"max |err| {err:.3g}; host per call: wrapper {rec['host_ms']:.5f} ms, plain "
              f"{rec['host_plain_ms']:.5f} ms, library {rec['host_library_ms']:.5f} ms")
    del x32
    torch.cuda.empty_cache()
    return errs, timed, lm


def quickstart_spec(strategy: str):
    from repro_torch.api import (AllocationSpec, ClientPopulationSpec, RuntimeSpec,
                                 ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=f"quickstart-{strategy}",
        seed=0,
        tasks=[TaskSpec(t, options={"n_range": [100, 150]}) for t in TASKS],
        clients=ClientPopulationSpec(n_clients=40, participation=0.2),
        allocation=AllocationSpec(strategy=strategy, alpha=3.0),
        runtime=RuntimeSpec(backend="vmap", rounds=ROUNDS, tau=3))


def run_counted(spec, device: str):
    """One run of a slice with the launch counts set to 0 just before it;
    returns the result and the counts read just after."""
    from repro_torch.api import run_scenario
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    held = FoldShapes.held_s
    res = run_scenario(spec, device=device)
    # the seconds FoldShapes spent holding fedavg calls are not the run's
    res.wall_time -= FoldShapes.held_s - held
    return res, dict(LAUNCHES)


def phase_slice():
    import numpy as np

    print("== phase 3: the sync slice on the card (run_scenario, vmap backend)")
    runs = {}
    for strategy in ("fedfair", "random"):
        res, launches = run_counted(quickstart_spec(strategy), "cuda")
        folds = int((res.alloc_counts > 0).sum())
        if launches.get("fedavg", 0) != folds:
            fail(f"{strategy}: fedavg launched {launches.get('fedavg', 0)} times for "
                 f"{folds} non-empty (round, task) folds")
        devices = {leaf.device.type for p in res.params for layer in p for leaf in layer.values()}
        if devices != {"cuda"}:
            fail(f"{strategy}: final params on {devices}")
        if res.acc.shape != (ROUNDS, len(TASKS)) or not np.isfinite(res.acc).all():
            fail(f"{strategy}: accuracy curve {res.acc.shape} not finite")
        runs[strategy] = (res, launches)
        print(f"{strategy}: {ROUNDS / res.wall_time:.2f} rounds/s ({res.wall_time:.3f} s), "
              f"fedavg launches {launches['fedavg']} = non-empty folds {folds} "
              f"({launches['fedavg'] / ROUNDS:.2f} per round), final acc "
              + " ".join(f"{n}={a:.4f}" for n, a in zip(res.task_names, res.acc[-1]))
              + f", min-acc {res.fairness['min_acc']:.4f}")
    return runs


def phase_card_vs_cpu(gpu_fedfair):
    import numpy as np

    print("== phase 4: card vs CPU")
    cpu, _ = run_counted(quickstart_spec("fedfair"), "cpu")
    diff = np.abs(cpu.acc - gpu_fedfair.acc).max()
    differ = np.nonzero((cpu.alloc != gpu_fedfair.alloc).any(axis=1))[0]
    print(f"fedfair on the CPU: {ROUNDS / cpu.wall_time:.2f} rounds/s ({cpu.wall_time:.3f} s)")
    print(f"fedfair: max |acc card - acc cpu| {diff:.6f}; allocation traces "
          + (f"first differ at round {int(differ[0])}" if len(differ) else "identical"))
    if not diff <= 0.01:
        fail(f"fedfair card vs CPU accuracy differs by {diff}")
    rr_gpu, _ = run_counted(quickstart_spec("round_robin"), "cuda")
    rr_cpu, _ = run_counted(quickstart_spec("round_robin"), "cpu")
    rr_diff = np.abs(rr_cpu.acc - rr_gpu.acc).max()
    same = bool((rr_cpu.alloc == rr_gpu.alloc).all())
    print(f"round_robin: allocation traces identical={same}, "
          f"max |acc card - acc cpu| {rr_diff:.6f}")
    if not same or not rr_diff <= 0.01:
        fail("round_robin card vs CPU disagree")


def fused_bound_ms(K: int, N: int, mode: str) -> tuple:
    """Least time for one fused flush: x, w and s read once, the moments
    the mode reads read once, the update and the moments it writes written
    once, at the data-sheet bandwidth; 2*K*N reduce flops plus a dozen per
    column for the moments at the f32 rate. The larger wins."""
    moments = {"fedavg": 0, "fedavgm": 1, "fedadam": 2, "fedyogi": 2}[mode]
    nbytes = 4 * K * N + 8 * K + 4 * N * (1 + 2 * moments)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (2 * K * N + 12 * N) / PEAK_F32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _flush_inputs(gen, K, N, dev):
    """Deltas, p_k-like weights, staleness 0..3, and moments with v > 0,
    made on the card from a seeded generator."""
    import torch

    x = torch.randn(K, N, generator=gen, device=dev).mul_(0.1)
    w = torch.rand(K, generator=gen, device=dev).mul_(0.9).add_(0.1)
    s = torch.randint(0, 4, (K,), generator=gen, device=dev).float()
    m = torch.randn(N, generator=gen, device=dev).mul_(0.01)
    v = torch.rand(N, generator=gen, device=dev).mul_(1e-2).add_(1e-6)
    return x, w, s, m, v


def check_fused(x, w, s, m, v, mode: str, where: str) -> tuple:
    """The kernel against its plain version at rtol/atol FUSED_TOL; returns
    (max |err|, number of Yogi ties). Where v and d^2 agree to within the
    reduce's rounding, Yogi's sign(v - d^2) may fall either way: there the
    kernel's v' must be one of the three branches and its update must
    follow from its own v'."""
    import torch

    from repro_torch.kernels import fused_aggregate
    from repro_torch.kernels.ref import ref_fused_aggregate

    norm = w.sum()
    got = fused_aggregate(x, w, s, m, v, mode=mode, normalizer=float(norm), **FUSED_SCALARS)
    want = ref_fused_aggregate(x, w, s, m, v, mode=mode, normalizer=norm, **FUSED_SCALARS)
    torch.cuda.synchronize()
    ties = torch.zeros_like(m, dtype=torch.bool)
    if mode == "fedyogi":
        sc = dict(FUSED_SCALARS, lr=1.0)
        d2 = ref_fused_aggregate(x, w, s, m, v, mode="fedavg", normalizer=norm, **sc)[0] ** 2
        ties = (v - d2).abs() <= 1e-5 * d2
        step = (1.0 - FUSED_SCALARS["beta2"]) * d2
        branch = torch.stack([v - step, v, v + step]).sub_(got[2]).abs_().amin(0)
        follows = FUSED_SCALARS["lr"] * got[1] / (got[2].sqrt() + FUSED_SCALARS["eps"])
        if not bool(((branch <= FUSED_TOL * (1 + v.abs())) | ~ties).all()) or not bool(
                (((got[0] - follows).abs() <= FUSED_TOL * (1 + follows.abs())) | ~ties).all()):
            fail(f"fused_aggregate {mode} {where}: a tie element took no branch of the sign")
    err = 0.0
    for name, g, r in zip(("update", "m", "v"), got, want):
        if g.shape != r.shape or g.dtype != torch.float32 or g.device.type != "cuda":
            fail(f"fused_aggregate {mode} {where} {name}: got {g.dtype} {tuple(g.shape)} "
                 f"on {g.device}")
        diff = (g - r).abs()
        if name != "m":
            diff.masked_fill_(ties, 0.0)
        err = max(err, diff.max().item())
        if not bool((diff <= FUSED_TOL + FUSED_TOL * r.abs()).all()):
            fail(f"fused_aggregate {mode} {where} {name}: max |err| {diff.max().item()} "
                 f"over rtol/atol {FUSED_TOL}")
    return err, int(ties.sum())


def phase_fused_kernel():
    import torch

    from repro_torch.kernels import FUSED_MODES, fused_aggregate
    from repro_torch.kernels.ref import ref_fused_aggregate

    print("== phase 5: fused_aggregate kernel vs plain version on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err, ties = 0.0, 0
    timed = {}
    for K in FUSED_K:
        for N in MAIN_N:
            inputs = _flush_inputs(gen, K, N, dev)
            for mode in FUSED_MODES:
                e, t = check_fused(*inputs, mode, f"K={K} N={N}")
                err, ties = max(err, e), ties + t
            if (K, N) != FUSED_TIMED:
                continue
            x, w, s, m, v = inputs
            norm, norm_dev = float(w.sum()), w.sum()
            disc = w * (1.0 + s) ** -FUSED_SCALARS["beta"] / norm_dev
            for mode in FUSED_MODES:
                def kernel(mode=mode):
                    return fused_aggregate(x, w, s, m, v, mode=mode, normalizer=norm,
                                           **FUSED_SCALARS)

                def plain(mode=mode):
                    return ref_fused_aggregate(x, w, s, m, v, mode=mode, normalizer=norm_dev,
                                               **FUSED_SCALARS)

                bound, by = fused_bound_ms(K, N, mode)
                timed[mode] = {"ms": graph_ms(kernel), "eager_ms": time_ms(kernel, inner=200),
                               "plain_ms": graph_ms(plain),
                               "eager_plain_ms": time_ms(plain, inner=200),
                               "bound_ms": bound, "bound_by": by}
            reduce_ms = graph_ms(lambda: disc @ x)
            reduce_eager_ms = time_ms(lambda: disc @ x, inner=200)
    print(f"flush shapes K in {FUSED_K} x N in {MAIN_N}, all modes: max |err| {err:.3g} "
          f"(rtol/atol {FUSED_TOL}), Yogi ties {ties}")
    K, N = FUSED_TIMED
    for mode, r in timed.items():
        print(f"flush K={K} N={N} {mode}: device time (CUDA graph) kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); eager per "
              f"call kernel {r['eager_ms']:.5f} ms, plain {r['eager_plain_ms']:.5f} ms")
    print(f"flush K={K} N={N}: disc @ x (the reduce alone) {reduce_ms:.5f} ms device, "
          f"{reduce_eager_ms:.5f} ms eager")

    lm = {}
    t0 = time.perf_counter()
    x, w, s, m, v = _flush_inputs(gen, LM_K, LM_N, dev)
    torch.cuda.synchronize()
    print(f"LM-scale flush inputs K={LM_K} N={LM_N}: {time.perf_counter() - t0:.1f} s to make")
    norm, norm_dev = float(w.sum()), w.sum()
    disc = w * (1.0 + s) ** -FUSED_SCALARS["beta"] / norm_dev
    lm_reduce_ms = time_ms(lambda: disc @ x)
    for mode in FUSED_MODES:
        e, t = check_fused(x, w, s, m, v, mode, "LM-scale")
        err, ties = max(err, e), ties + t
        bound, by = fused_bound_ms(LM_K, LM_N, mode)
        rec = {
            "ms": time_ms(lambda: fused_aggregate(x, w, s, m, v, mode=mode, normalizer=norm,
                                                  **FUSED_SCALARS)),
            "plain_ms": time_ms(lambda: ref_fused_aggregate(x, w, s, m, v, mode=mode,
                                                            normalizer=norm_dev,
                                                            **FUSED_SCALARS)),
            "bound_ms": bound, "bound_by": by, "max_abs_err": e, "yogi_ties": t,
        }
        lm[mode] = rec
        print(f"LM-scale flush K={LM_K} N={LM_N} {mode}: kernel {rec['ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of the {by} bound {rec['bound_ms']:.4f} ms), "
              f"plain {rec['plain_ms']:.4f} ms, max |err| {e:.3g}, Yogi ties {t}")
    print(f"LM-scale flush: disc @ x (the reduce alone) {lm_reduce_ms:.4f} ms")
    del x, m, v, disc
    torch.cuda.empty_cache()
    return err, ties, timed, (reduce_ms, reduce_eager_ms), lm, lm_reduce_ms


def async_spec(aggregator, strategy: str = "fedfair"):
    from repro_torch.api import (AllocationSpec, ClientPopulationSpec, RuntimeSpec,
                                 ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=f"async-{aggregator or 'fedavg'}-{strategy}",
        seed=0,
        tasks=[TaskSpec(t, options={"n_range": [100, 150]}) for t in TASKS],
        clients=ClientPopulationSpec(n_clients=40, speed_profile="bimodal", speed_spread=4.0),
        allocation=AllocationSpec(strategy=strategy, alpha=3.0),
        runtime=RuntimeSpec(mode="async", backend="vmap", tau=3, total_arrivals=ARRIVALS,
                            buffer_size=4, beta=0.5, aggregator=aggregator,
                            aggregator_options=dict(SERVER_OPTIONS.get(aggregator, {}))))


def _devices(tree) -> set:
    from repro_torch.tree import tree_leaves

    return {leaf.device.type for leaf in tree_leaves(tree)}


def phase_async():
    import numpy as np

    print("== phase 6: the async slice on the card (run_scenario mode='async', vmap backend)")
    runs = {}
    for aggregator, kernel in (("fedadam", "fused_aggregate"), (None, "fedavg")):
        name = aggregator or "fedavg"
        res, launches = run_counted(async_spec(aggregator), "cuda")
        flushes = len(res.time)
        if flushes == 0 or launches != {kernel: flushes}:
            fail(f"async {name}: launches {launches} for {flushes} flushes, expected "
                 f"{kernel} once per flush")
        if _devices(res.params) != {"cuda"}:
            fail(f"async {name}: final params on {_devices(res.params)}")
        if res.acc.shape != (flushes, len(TASKS)) or not np.isfinite(res.acc).all():
            fail(f"async {name}: accuracy curve {res.acc.shape} not finite")
        runs[name] = (res, launches)
        print(f"async {name}: {flushes / res.wall_time:.2f} flushes/s ({flushes} flushes of "
              f"{ARRIVALS} arrivals, {res.wall_time:.3f} s), {kernel} launches "
              f"{launches[kernel]} = flushes, final acc "
              + " ".join(f"{n}={a:.4f}" for n, a in zip(res.task_names, res.acc[-1]))
              + f", min-acc {res.fairness['min_acc']:.4f}")
    check_server_moments(runs["fedadam"][0])
    return runs


def check_server_moments(res) -> None:
    """The fedadam run once more, through the synthetic family's async
    engine so that the server moments can be read: the same event trace
    as ``res``, and the moments on the card."""
    import numpy as np

    from repro_torch.api.registry import TASK_FAMILIES

    runner = TASK_FAMILIES.get("synthetic")().async_engine(async_spec("fedadam"), device="cuda")
    again = runner.run()
    moments = _devices(runner.engine._server_state)
    if not np.array_equal(again.time, res.time) or moments != {"cuda"}:
        fail(f"async fedadam through the engine: server moments on {moments}, trace "
             f"{'equal to' if np.array_equal(again.time, res.time) else 'unlike'} run_scenario's")
    print("async fedadam: the final server moments are on the card")


def phase_async_card_vs_cpu(gpu_fedadam):
    import numpy as np

    print("== phase 7: async card vs CPU")
    trace = ("time", "versions", "buffer_sizes")

    def first_difference(a, b):
        """(first flush whose time differs, first dispatch that differs)."""
        n = min(len(a.time), len(b.time))
        flush = np.nonzero(a.time[:n] != b.time[:n])[0]
        flush = int(flush[0]) if len(flush) else (None if len(a.time) == len(b.time) else n)
        dispatch = next((i for i, (x, y) in enumerate(zip(a.assignments, b.assignments))
                         if x != y), None)
        return flush, dispatch

    cpu, _ = run_counted(async_spec("fedadam"), "cpu")
    print(f"async fedadam on the CPU: {len(cpu.time) / cpu.wall_time:.2f} flushes/s "
          f"({cpu.wall_time:.3f} s)")
    same = (all(np.array_equal(getattr(cpu, k), getattr(gpu_fedadam, k)) for k in trace)
            and cpu.assignments == gpu_fedadam.assignments)
    if same:
        diff = np.abs(cpu.acc - gpu_fedadam.acc).max()
        print(f"fedadam fedfair: event traces identical, max |acc card - acc cpu| {diff:.6f}")
    else:
        diff = np.abs(cpu.acc[-1] - gpu_fedadam.acc[-1]).max()
        flush, dispatch = first_difference(cpu, gpu_fedadam)
        print(f"fedadam fedfair: event traces first differ at flush {flush} (dispatch "
              f"{dispatch}); final max |acc card - acc cpu| {diff:.6f}")
    if not diff <= 0.01:
        fail(f"fedadam fedfair card vs CPU accuracy differs by {diff}")
    rr_gpu, _ = run_counted(async_spec("fedadam", "round_robin"), "cuda")
    rr_cpu, _ = run_counted(async_spec("fedadam", "round_robin"), "cpu")
    same = (all(np.array_equal(getattr(rr_cpu, k), getattr(rr_gpu, k)) for k in trace)
            and rr_cpu.assignments == rr_gpu.assignments)
    rr_diff = np.abs(rr_cpu.acc - rr_gpu.acc).max() if same else float("inf")
    print(f"fedadam round_robin: event traces identical={same}, "
          f"max |acc card - acc cpu| {rr_diff:.6f}")
    if not same or not rr_diff <= 0.01:
        fail("fedadam round_robin card vs CPU disagree")


def _rotating(make, count: int):
    """``count`` copies of the inputs ``make()`` returns, handed out in turn:
    more bytes than the 50 MB L2 cache, so a timed call finds its inputs
    in device memory as a layer of the model does."""
    import itertools

    return itertools.cycle([make() for _ in range(count)])


def phase_rmsnorm():
    import torch

    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.ref import ref_rmsnorm

    print("== phase 8: rmsnorm kernel vs plain version on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    errs = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    for rows, d in NORM_SHAPES + NORM_EDGES:
        x32 = torch.randn(rows, d, generator=gen, device=dev)
        w32 = torch.randn(d, generator=gen, device=dev).mul_(0.1).add_(1.0)
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                            ("float16", torch.float16)):
            x, w = x32.to(dtype), w32.to(dtype)
            got, want = rmsnorm(x, w), ref_rmsnorm(x, w)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != x.shape:
                fail(f"rmsnorm ({rows}, {d}) {name}: got {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            errs[name] = max(errs[name], err)
            if not err <= NORM_TOL[name]:
                fail(f"rmsnorm ({rows}, {d}) {name}: max |err| {err} > {NORM_TOL[name]}")
            if not torch.equal(got, rmsnorm(x, w)):
                fail(f"rmsnorm ({rows}, {d}) {name}: two calls on the same inputs differ")
    print(f"shapes {NORM_SHAPES + NORM_EDGES}: max |err| f32 {errs['float32']:.3g} (tol "
          f"{NORM_TOL['float32']}), bf16 {errs['bfloat16']:.3g} (tol {NORM_TOL['bfloat16']}), "
          f"f16 {errs['float16']:.3g} (tol {NORM_TOL['float16']}); two calls bit-equal at each")

    rec = {"shape": list(NORM_TIMED), "dtype": "float32", "max_abs_err": errs["float32"],
           "max_abs_err_bf16": errs["bfloat16"], "max_abs_err_f16": errs["float16"],
           **_time_norm(gen, *NORM_TIMED)}
    rec["families"] = {f"{rows}x{d}": _time_norm(gen, rows, d) for rows, d in NORM_FAMILIES}
    for shape, r in [(NORM_TIMED, rec)] + [(sh, rec["families"][f"{sh[0]}x{sh[1]}"])
                                           for sh in NORM_FAMILIES]:
        print(f"rmsnorm {shape} f32, device time (CUDA graph, inputs cycled past L2): kernel "
              f"{r['ms']:.5f} ms ({r['bound_ms'] / r['ms']:.1%} of the bytes bound "
              f"{r['bound_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, library (F.rms_norm) "
              f"{r['library_ms']:.5f} ms; eager per call: kernel {r['eager_ms']:.5f} ms, plain "
              f"{r['eager_plain_ms']:.5f} ms, library {r['eager_library_ms']:.5f} ms; host per "
              f"call: wrapper {r['host_ms']:.5f} ms, plain {r['host_plain_ms']:.5f} ms, library "
              f"{r['host_library_ms']:.5f} ms")
    torch.cuda.empty_cache()
    return rec


def _time_norm(gen, rows: int, d: int) -> dict:
    """rmsnorm at (rows, d) f32 beside its bytes bound, its plain version
    and ``F.rms_norm``: device time in a CUDA graph, eager time and host
    time per call, inputs cycled past the L2 cache."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.ref import ref_rmsnorm

    dev = torch.device("cuda")
    w = torch.randn(d, generator=gen, device=dev).mul_(0.1).add_(1.0)
    xs = _rotating(lambda: torch.randn(rows, d, generator=gen, device=dev), 4)
    fns = {"": lambda: rmsnorm(next(xs), w), "plain_": lambda: ref_rmsnorm(next(xs), w),
           "library_": lambda: F.rms_norm(next(xs), (d,), w, 1e-6)}
    nbytes = 2 * rows * d * 4 + 4 * d
    rec = {"bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    for key, fn in fns.items():
        rec[f"{key}ms"] = graph_ms(fn, inner=40)
        rec[f"eager_{key}ms"] = time_ms(fn, inner=40)
        rec[f"host_{key}ms"] = host_ms(fn)
    return rec


def flash_bound_ms(B, H, KV, Sq, Sk, hd, causal: bool, size: int, peak_flops: float) -> tuple:
    """Least time for one attention call: 4*hd flops per (query, key) pair
    the mask keeps (QK^T and PV), at ``peak_flops``; q, k, v read once and
    o written once at the data-sheet bandwidth. The larger wins."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    ops_ms = 4 * hd * pairs * B * H / peak_flops * 1e3
    bytes_ms = (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd) * size / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_flash():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import device_launches, flash_attention
    from repro_torch.kernels.build import sass
    from repro_torch.kernels.ref import ref_attention

    print("== phase 9: flash_attention kernel vs plain version on the card")
    code = sass("flash_attention")
    ops = {op: code.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
    print(f"flash_attention SASS: {ops['HGMMA']} HGMMA (wgmma), {ops['UTMALDG']} UTMALDG (TMA "
          f"loads), {ops['HMMA']} HMMA (mma.sync)")
    if not ops["HGMMA"] or not ops["UTMALDG"]:
        fail(f"flash_attention: the library's SASS lacks wgmma or TMA loads: {ops}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    errs = {"float32": (0.0, None), "bfloat16": (0.0, None)}   # (max |err|, where)
    timed = {}
    for B, H, KV, Sq, Sk, hd in FLASH_SHAPES:
        q32 = torch.randn(B, H, Sq, hd, generator=gen, device=dev)
        k32 = torch.randn(B, KV, Sk, hd, generator=gen, device=dev)
        v32 = torch.randn(B, KV, Sk, hd, generator=gen, device=dev)
        for name, dtype, size, peak in (("float32", torch.float32, 4, PEAK_TF32X3_FLOP_PER_S),
                                        ("bfloat16", torch.bfloat16, 2, PEAK_BF16_FLOP_PER_S)):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            for causal in (True, False):
                got, want = flash_attention(q, k, v, causal=causal), ref_attention(q, k, v, causal)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != q.shape:
                    fail(f"flash_attention {(B, H, KV, Sq, Sk, hd)} {name}: got {got.dtype} "
                         f"{tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                where = f"{(B, H, KV, Sq, Sk, hd)} causal={causal}"
                if err >= errs[name][0]:
                    errs[name] = (err, where)
                if not err <= FLASH_TOL[name]:
                    fail(f"flash_attention {where}: max |err| {err} > {FLASH_TOL[name]}")
                del got, want
            if (B, H, KV, Sq, Sk, hd) not in (FLASH_SHAPES[0], FLASH_ZAMBA, FLASH_MOE, FLASH_VLM):
                continue
            bound, by = flash_bound_ms(B, H, KV, Sq, Sk, hd, True, size, peak)
            rec = timed[(B, H, KV, Sq, Sk, hd), name] = {
                "ms": time_ms(lambda: flash_attention(q, k, v, causal=True), reps=10),
                "plain_ms": time_ms(lambda: ref_attention(q, k, v, True), reps=10),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), reps=10),
                "bound_ms": bound, "bound_by": by,
                "device_launches_per_call": device_launches(
                    lambda: flash_attention(q, k, v, causal=True)),
                # device time without the host's per-call work (CUDA graph)
                "device_ms": graph_ms(lambda: flash_attention(q, k, v, causal=True), inner=10),
                "library_device_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), inner=10),
                # host time per call, no synchronise inside a window
                "host_ms": host_ms(lambda: flash_attention(q, k, v, causal=True), inner=100,
                                   reps=10),
            }
            if name == "float32":
                rec["bound_ms_cuda_cores"] = flash_bound_ms(
                    B, H, KV, Sq, Sk, hd, True, size, PEAK_F32_FLOP_PER_S)[0]
            torch.cuda.empty_cache()
    for name, (err, where) in errs.items():
        print(f"{name}: max |err| {err:.3g} (tol {FLASH_TOL[name]}) at {where}")
    for (shape, name), r in timed.items():
        cores = (f"; {r['bound_ms_cuda_cores']:.4f} ms at 67 TFLOP/s on the CUDA cores"
                 if "bound_ms_cuda_cores" in r else "")
        print(f"flash causal {shape} {name}: kernel {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%} of the {r['bound_by']} bound "
              f"{r['bound_ms']:.4f} ms{cores}), plain {r['plain_ms']:.4f} ms, library (SDPA) "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x); device time (CUDA "
              f"graph): kernel {r['device_ms']:.4f} ms "
              f"({r['bound_ms'] / r['device_ms']:.1%} of the bound; before the Hopper redesign "
              f"{FLASH_BEFORE_MS[shape, name]:.4f} ms as PERF.md records it, not this run's), SDPA "
              f"{r['library_device_ms']:.4f} ms ({r['device_ms'] / r['library_device_ms']:.2f}x); "
              f"host {r['host_ms'] * 1e3:.2f} us per call")
    torch.cuda.empty_cache()
    return {name: err for name, (err, _) in errs.items()}, timed


def phase_serve():
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_api, param_count
    from repro_torch.models.transformer import init_lm
    from repro_torch.tree import tree_map

    print(f"== phase 10: serving {LM_ARCH} at full width on the card")
    cfg = get_config(LM_ARCH)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_lm(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    print(f"init_lm(PRNGKey(0)) on the card: {param_count(params)} params, "
          f"{time.perf_counter() - t0:.2f} s")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    prompts = prng.randint(prng.PRNGKey(0, device=dev), (B, P), 0, cfg.vocab_size)
    norms = 2 * cfg.n_layers + 1
    generate(params, cfg, prompts, 2)                          # warm-up: cuBLAS, allocator
    reset_launches()
    res = generate(params, cfg, prompts, G)
    launches = dict(LAUNCHES)
    if launches != {"rmsnorm": norms * G}:
        fail(f"serve: launches {launches}, expected rmsnorm {norms} x {G} forwards")
    api = get_api(cfg)
    with torch.no_grad():
        reset_launches()
        logits, caches = api.prefill_fn(params, cfg, {"tokens": prompts, "labels": prompts})
        per_prefill = dict(LAUNCHES)
        reset_launches()
        api.decode_fn(params, cfg, res.tokens[:, :1], P, caches)
        per_decode = dict(LAUNCHES)
    if per_prefill != {"rmsnorm": norms} or per_decode != {"rmsnorm": norms}:
        fail(f"serve: one prefill launched {per_prefill}, one decode step {per_decode}")
    if res.tokens.shape != (B, G) or not bool(((res.tokens >= 0)
                                                & (res.tokens < cfg.vocab_size)).all()):
        fail(f"serve: tokens {tuple(res.tokens.shape)} out of range")
    rec = {"arch": LM_ARCH, "batch": B, "prompt": P, "gen": G,
           "prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "prefill_tok_s": B * P / res.prefill_s, "decode_tok_s": B * (G - 1) / res.decode_s,
           "rmsnorm_launches": launches["rmsnorm"], "rmsnorm_per_forward": norms}
    print(f"serve {LM_ARCH} batch {B} prompt {P} gen {G}: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({rec['prefill_tok_s']:.0f} tok/s), decode {res.decode_s * 1e3:.2f} ms for {G - 1} "
          f"steps ({rec['decode_tok_s']:.0f} tok/s); rmsnorm launches {launches['rmsnorm']} = "
          f"{norms} x {G} forwards, {norms} per prefill and per decode step")

    cpu = torch.device("cpu")
    params_cpu = tree_map(lambda t: t.to(cpu), params)
    small = prompts[:2]
    gpu2 = generate(params, cfg, small, G)
    t0 = time.perf_counter()
    cpu2 = generate(params_cpu, cfg, small.to(cpu), G)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        lg_gpu, _ = api.prefill_fn(params, cfg, {"tokens": small, "labels": small})
        lg_cpu, _ = api.prefill_fn(params_cpu, cfg, {"tokens": small.to(cpu),
                                                     "labels": small.to(cpu)})
    diff = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    same = torch.equal(gpu2.tokens.cpu(), cpu2.tokens)
    print(f"batch 2 on the host CPU ({cpu_s:.2f} s): greedy tokens identical={same}, "
          f"max |prefill logits card - cpu| {diff:.3g}")
    if not same or not diff <= 1e-3:
        fail("serve: card and CPU disagree")
    rec.update(cpu_tokens_identical=same, cpu_prefill_logits_max_abs_diff=diff)
    del params_cpu, caches, logits
    return params, rec


def phase_loss(params):
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import get_api
    from repro_torch.tree import tree_map

    print(f"== phase 11: the forward loss of {LM_ARCH} with use_pallas=True on the card")
    cfg = get_config(LM_ARCH)
    pallas = cfg.replace(use_pallas=True)
    api = get_api(cfg)
    dev = torch.device("cuda")
    tokens = prng.randint(prng.PRNGKey(1, device=dev), (LOSS_B, LOSS_S), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        api.loss_fn(params, pallas, batch)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss, _ = api.loss_fn(params, pallas, batch)
        launches = dict(LAUNCHES)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        loss_plain, _ = api.loss_fn(params, cfg, batch)
        ms = time_ms(lambda: api.loss_fn(params, pallas, batch), reps=5)
        ms_plain = time_ms(lambda: api.loss_fn(params, cfg, batch), reps=5)
    norms = 2 * cfg.n_layers + 1
    if launches != {"flash_attention": cfg.n_layers, "rmsnorm": norms}:
        fail(f"loss: launches {launches}, expected flash_attention {cfg.n_layers} and "
             f"rmsnorm {norms}")
    diff = abs(loss.item() - loss_plain.item())
    print(f"loss B={LOSS_B} S={LOSS_S}: use_pallas {loss.item():.6f}, chunked attention "
          f"{loss_plain.item():.6f}, |diff| {diff:.3g} (tol 2e-4); {ms:.2f} ms per forward "
          f"({ms_plain:.2f} ms without the flash kernel); peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}")
    if not torch.isfinite(loss) or not diff <= 2e-4:
        fail(f"loss: use_pallas {loss.item()} vs {loss_plain.item()}")
    small = {"tokens": tokens[:1, :256], "labels": tokens[:1, :256]}
    params_cpu = tree_map(lambda t: t.cpu(), params)
    with torch.no_grad():
        l_gpu, _ = api.loss_fn(params, pallas, small)
        l_cpu, _ = api.loss_fn(params_cpu, pallas, tree_map(lambda t: t.cpu(), small))
    cpu_diff = abs(l_gpu.item() - l_cpu.item())
    print(f"loss B=1 S=256: card {l_gpu.item():.6f}, CPU {l_cpu.item():.6f}, |diff| "
          f"{cpu_diff:.3g} (tol 1e-4)")
    if not cpu_diff <= 1e-4:
        fail(f"loss: card vs CPU differ by {cpu_diff}")
    return {"B": LOSS_B, "S": LOSS_S, "loss": loss.item(), "loss_plain_path": loss_plain.item(),
            "ms": ms, "ms_plain_path": ms_plain, "peak_bytes": peak, "launches": launches,
            "cpu_loss_diff": cpu_diff}


def phase_gated():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import gated_rmsnorm
    from repro_torch.kernels.ref import ref_gated_rmsnorm

    print("== phase 12: gated_rmsnorm kernel vs plain version on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for rows, d in GATED_SHAPES:
        x32 = torch.randn(rows, d, generator=gen, device=dev)
        z32 = torch.randn(rows, d, generator=gen, device=dev)
        w32 = torch.randn(d, generator=gen, device=dev).mul_(0.1).add_(1.0)
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, z, w = x32.to(dtype), z32.to(dtype), w32.to(dtype)
            got, want = gated_rmsnorm(x, z, w), ref_gated_rmsnorm(x, z, w)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != x.shape:
                fail(f"gated_rmsnorm ({rows}, {d}) {name}: got {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            errs[name] = max(errs[name], err)
            if not err <= GATED_TOL[name]:
                fail(f"gated_rmsnorm ({rows}, {d}) {name}: max |err| {err} > {GATED_TOL[name]}")
    print(f"shapes {GATED_SHAPES}: max |err| f32 {errs['float32']:.3g} (tol "
          f"{GATED_TOL['float32']}), bf16 {errs['bfloat16']:.3g} (tol {GATED_TOL['bfloat16']})")

    rows, d = GATED_TIMED
    w = torch.randn(d, generator=gen, device=dev).mul_(0.1).add_(1.0)
    xz = _rotating(lambda: (torch.randn(rows, d, generator=gen, device=dev),
                            torch.randn(rows, d, generator=gen, device=dev)), 3)
    fns = {"": lambda: gated_rmsnorm(*next(xz), w),
           "plain_": lambda: ref_gated_rmsnorm(*next(xz), w),
           "composite_": lambda: (lambda x, z: F.rms_norm(x * F.silu(z), (d,), w, 1e-6))(*next(xz))}
    nbytes = 3 * rows * d * 4 + 4 * d
    rec = {"shape": [rows, d], "dtype": "float32", "max_abs_err": errs["float32"],
           "max_abs_err_bf16": errs["bfloat16"],
           "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
           # no single PyTorch call computes the fused gate; the composite
           # F.rms_norm(x * F.silu(z)) stands beside it
           "library_ms": None}
    for key, fn in fns.items():
        rec[f"{key}ms"] = graph_ms(fn, inner=30)
        rec[f"eager_{key}ms"] = time_ms(fn, inner=30)
    print(f"gated_rmsnorm ({rows}, {d}) f32, device time (CUDA graph, inputs cycled past L2): "
          f"kernel {rec['ms']:.5f} ms ({rec['bound_ms'] / rec['ms']:.1%} of the bytes bound "
          f"{rec['bound_ms']:.5f} ms), plain {rec['plain_ms']:.5f} ms, composite "
          f"F.rms_norm(x * F.silu(z)) {rec['composite_ms']:.5f} ms; eager per call: kernel "
          f"{rec['eager_ms']:.5f} ms, plain {rec['eager_plain_ms']:.5f} ms, composite "
          f"{rec['eager_composite_ms']:.5f} ms")
    del xz, fns
    torch.cuda.empty_cache()
    return rec


def ssd_bound_ms(B, H, L, P, N, chunk, shared_bc: bool, size: int = 4,
                 cuda_cores: bool = False) -> tuple:
    """Least time for one scan. Operations, per chunk of Q steps: the
    scores C_i . B_j, 2 N flops per causal (i, j <= i) pair, once per
    (batch, chunk) when b and c are one group for all heads, else per
    head; per head, their product with x, 2 P flops per pair, and 2 N P
    flops per step for each of the carry-in and the chunk state. Each
    product at f32 accuracy, at the fastest rate its operands allow: two
    f32 operands (the f32 inputs, or a decay-scaled factor times the f32
    state) at the three-pass TF32 rate; with bf16 inputs (``size`` 2), the
    scores of two bf16 inputs at the bf16 rate (their products are exact),
    and an input times an f32 factor at a third of it (the factor split
    into three bf16 parts). ``cuda_cores`` counts every flop at the f32
    rate outside the tensor cores instead. Bytes: x read and y written once
    (``size`` bytes each, like b and c), a once, b and c once per distinct
    (batch, head) view, the final state written once in f32, at the
    data-sheet bandwidth. The larger wins."""
    Z, Q = -(-L // chunk), min(chunk, L)
    pairs = B * Z * Q * (Q + 1) // 2
    bc_heads = 1 if shared_bc else H
    scores = 2 * N * pairs * bc_heads
    mixed = H * (2 * P * pairs + 4 * B * Z * Q * N * P)
    if cuda_cores:
        ops_ms = (scores + mixed) / PEAK_F32_FLOP_PER_S * 1e3
    elif size == 2:
        ops_ms = (scores / PEAK_BF16_FLOP_PER_S + mixed / (PEAK_BF16_FLOP_PER_S / 3)) * 1e3
    else:
        ops_ms = (scores + mixed) / PEAK_TF32X3_FLOP_PER_S * 1e3
    nbytes = (size * (2 * B * H * L * P + 2 * B * bc_heads * L * N)
              + 4 * (B * H * L + B * H * N * P))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _ssd_inputs(gen, B, H, L, P, N, dev, shared_bc):
    """x scaled 0.5, a = -softplus(normal), b and c scaled 0.3 (the JAX
    sweep's inputs), b and c one (B, L, N) group viewed over the heads
    when ``shared_bc``."""
    import torch
    import torch.nn.functional as F

    x = torch.randn(B, H, L, P, generator=gen, device=dev).mul_(0.5)
    a = -F.softplus(torch.randn(B, H, L, generator=gen, device=dev))
    if shared_bc:
        b, c = (torch.randn(B, 1, L, N, generator=gen, device=dev).mul_(0.3).expand(B, H, L, N)
                for _ in range(2))
    else:
        b, c = (torch.randn(B, H, L, N, generator=gen, device=dev).mul_(0.3) for _ in range(2))
    return x, a, b, c


def _chunked(x, a, b, c, chunk):
    """The model's ssd_chunked on the kernel's (B, H, L, *) layout (one
    group shared by the heads): (y (B, H, L, P), final state (B, H, N, P))."""
    from repro_torch.models.ssm import ssd_chunked

    y, h = ssd_chunked(x.transpose(1, 2)[:, :, None], a.transpose(1, 2)[:, :, None],
                       b[:, 0, :, None], c[:, 0, :, None], chunk)
    return y[:, :, 0].transpose(1, 2), h[:, 0]


def _close(got, want, tol, what: str) -> float:
    """max |got - want|; fails unless it is within atol + rtol |want| everywhere."""
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all()):
        fail(f"{what}: max |err| {diff.max().item()} over {tol}")
    return diff.max().item()


def _hopper_sass(name: str) -> dict:
    """HGMMA, UTMALDG and HMMA counts of each of a library's Hopper kernels
    (the functions whose names hold ``_tma``), from its SASS."""
    from repro_torch.kernels.build import sass

    funcs = {f.split("\n", 1)[0]: f for f in sass(name).split("Function : ")[1:]}
    return {fn[:120]: {"HGMMA": f.count("HGMMA"), "UTMALDG": f.count("UTMALDG"),
                       "HMMA": f.count("HMMA")}
            for fn, f in funcs.items() if "_tma" in fn}


def phase_ssd():
    import torch

    from repro_torch.kernels import graph_kernels, ssd_scan
    from repro_torch.kernels.ref import ref_ssd
    from repro_torch.kernels.ssd_scan import hopper_takes

    print("== phase 13: ssd_scan kernel vs plain versions on the card")
    hop = _hopper_sass("ssd_scan")
    print(f"ssd_scan Hopper kernels' SASS: {hop}")
    if len(hop) != 4 or not all(c["HGMMA"] and c["UTMALDG"] and not c["HMMA"]
                                for c in hop.values()):
        fail(f"ssd_scan: the Hopper kernels' SASS lacks wgmma or TMA loads, or holds mma.sync: "
             f"{hop}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    err = 0.0
    for B, H, L, P, N, chunk in SSD_SMALL:
        x, a, b, c = _ssd_inputs(gen, B, H, L, P, N, dev, shared_bc=False)
        got, h = ssd_scan(x, a, b, c, chunk, return_state=True)
        want, want_h = ref_ssd(x, a, b, c, return_state=True)
        torch.cuda.synchronize()
        for what, g, r in (("y", got, want), ("state", h, want_h)):
            err = max(err, _close(g, r, SSD_TOL, f"ssd_scan {(B, H, L, P, N, chunk)} {what}"))
    x, a, b, c = _ssd_inputs(gen, 1, 2, 128, 16, 8, dev, shared_bc=False)
    inv = _close(ssd_scan(x, a, b, c, 16), ssd_scan(x, a, b, c, 128), SSD_CHUNK_TOL,
                 "ssd_scan chunk 16 vs 128")
    print(f"small shapes {SSD_SMALL} against ref_ssd: max |err| {err:.3g} ({SSD_TOL}); chunks "
          f"16 vs 128 at (1, 2, 128, 16, 8): max |diff| {inv:.3g} ({SSD_CHUNK_TOL})")

    def launched(fn, label, name):
        """The device kernels of one call; fails unless they are the Hopper
        route's two (the route the size rule names at Mamba2's shapes)."""
        kernels = graph_kernels(fn)
        if len(kernels) != 2 or not all("_tma" in k for k in kernels):
            fail(f"ssd_scan {label} {name}: expected the Hopper route's two kernels, the graph "
                 f"holds {kernels}")
        return len(kernels)

    def other_routes(rec, label, call, want, tol, where):
        """The mma.sync kernels forced at the same inputs: their error,
        launches and device time."""
        for path in ("chunks",) + (("seq",) if label == "serve" else ()):
            rec[f"{path}_path"] = {
                "max_abs_err": _close(call(path)[0], want, tol, f"{where} on path {path}"),
                "device_launches_per_call": len(graph_kernels(lambda: call(path))),
                "device_ms": graph_ms(lambda: call(path), inner=10)}

    timed = {}
    for label, (B, H, L, P, N, chunk) in (("loss", SSD_LOSS), ("serve", SSD_SERVE)):
        x, a, b, c = _ssd_inputs(gen, B, H, L, P, N, dev, shared_bc=True)
        got, h = ssd_scan(x, a, b, c, chunk, return_state=True)
        want, want_h = _chunked(x, a, b, c, chunk)
        torch.cuda.synchronize()
        where = f"ssd_scan {label} {(B, H, L, P, N, chunk)} vs ssd_chunked"
        e_y = _close(got, want, SSD_TOL, f"{where}: y")
        e_h = _close(h, want_h, SSD_TOL, f"{where}: state")
        err = max(err, e_y, e_h)
        rec = {"shape": [B, H, L, P, N], "chunk": chunk, "dtype": "float32",
               "bc": "one group, stride-0 head view", "max_abs_err_vs_chunked": max(e_y, e_h)}
        if label == "loss":
            rec["chunk64_vs_256_max_abs_diff"] = _close(ssd_scan(x, a, b, c, 64), got, SSD_TOL,
                                                         "ssd_scan loss shape chunk 64 vs 256")
        call = lambda: ssd_scan(x, a, b, c, chunk, return_state=True)  # noqa: E731
        if not hopper_takes(x, b, c, chunk, True):
            fail(f"{where}: the size rule does not send zamba2-7b's scan to the Hopper route")
        rec["bound_ms"], rec["bound_by"] = ssd_bound_ms(B, H, L, P, N, chunk, True)
        rec["bound_ms_cuda_cores"] = ssd_bound_ms(B, H, L, P, N, chunk, True,
                                                  cuda_cores=True)[0]
        rec["device_launches_per_call"] = launched(call, label, "float32")
        rec["ms"] = time_ms(call, inner=5)
        rec["device_ms"] = graph_ms(call, inner=10)
        rec["host_ms"] = host_ms(call, inner=100, reps=10)
        other_routes(rec, label, lambda path: ssd_scan(
            x, a, b, c, chunk, return_state=True, path=path), want, SSD_TOL, where)
        rec["plain_ms"] = time_ms(lambda: ref_ssd(x, a, b, c, return_state=True), reps=3)
        rec["chunked_ms"] = time_ms(lambda: _chunked(x, a, b, c, chunk), reps=5)
        rec["library_ms"] = None          # no PyTorch call computes the scan
        # bf16 x, b, c (b and c still one group as stride-0 head views)
        xh, bh, ch = (t[:, :1].to(torch.bfloat16).expand(B, H, L, t.shape[-1]) if t is not x
                      else t.to(torch.bfloat16) for t in (x, b, c))
        got16, h16 = ssd_scan(xh, a, bh, ch, chunk, return_state=True)
        want16, want_h16 = ref_ssd(xh, a, bh, ch, return_state=True)
        torch.cuda.synchronize()
        bf16 = {"max_abs_err_vs_ref_ssd": max(
            _close(got16, want16, SSD_BF16_TOL, f"{where} bf16 vs ref_ssd: y"),
            _close(h16, want_h16, SSD_TOL, f"{where} bf16 vs ref_ssd: state"))}
        call16 = lambda: ssd_scan(xh, a, bh, ch, chunk, return_state=True)  # noqa: E731
        bf16["bound_ms"], bf16["bound_by"] = ssd_bound_ms(B, H, L, P, N, chunk, True, 2)
        bf16["device_launches_per_call"] = launched(call16, label, "bfloat16")
        bf16["ms"] = time_ms(call16, inner=5)
        bf16["device_ms"] = graph_ms(call16, inner=10)
        bf16["host_ms"] = host_ms(call16, inner=100, reps=10)
        other_routes(bf16, label, lambda path: ssd_scan(
            xh, a, bh, ch, chunk, return_state=True, path=path), want16, SSD_BF16_TOL,
            f"{where} bf16")
        bf16["chunked_ms"] = time_ms(lambda: _chunked(xh, a, bh, ch, chunk), reps=5)
        bf16["library_ms"] = None
        rec["bf16"] = bf16
        timed[label] = rec
        print(f"ssd_scan {label} {(B, H, L, P, N)} chunk {chunk}: y max |err| vs ssd_chunked "
              f"{e_y:.3g}, state {e_h:.3g}"
              + (f", chunk 64 vs 256 {rec['chunk64_vs_256_max_abs_diff']:.3g}" if label == "loss"
                 else "")
              + f"; bf16 max |err| vs ref_ssd {bf16['max_abs_err_vs_ref_ssd']:.3g}; ref_ssd "
              f"{rec['plain_ms']:.3f} ms, ssd_chunked {rec['chunked_ms']:.4f} ms (bf16 "
              f"{bf16['chunked_ms']:.4f})")
        for name, r in (("float32", rec), ("bfloat16", bf16)):
            alt = "; ".join(f"{k[:-5]} {v['device_ms']:.4f} ms ({v['device_launches_per_call']} "
                            f"launches)" for k, v in r.items() if k.endswith("_path"))
            cores = (f"; {r['bound_ms_cuda_cores']:.4f} ms at 67 TFLOP/s on the CUDA cores"
                     if "bound_ms_cuda_cores" in r else "")
            print(f"ssd_scan {label} {name}: kernel {r['device_ms']:.4f} ms device (CUDA graph; "
                  f"{r['bound_ms'] / r['device_ms']:.1%} of the {r['bound_by']} bound "
                  f"{r['bound_ms']:.4f} ms{cores}; before the Hopper redesign "
                  f"{SSD_BEFORE_MS[label, name]:.4f} ms and {SSD_BEFORE_LAUNCHES[label]} device "
                  f"launches as PERF.md records them, not this run's), {r['ms']:.4f} ms eager, "
                  f"host {r['host_ms'] * 1e3:.2f} us per call, {r['device_launches_per_call']} "
                  f"device launches per call; the mma.sync kernels here: {alt}")
        del x, a, b, c, got, h, want, want_h, xh, bh, ch, got16, h16, want16, want_h16
    torch.cuda.empty_cache()
    return err, timed


def _hybrid_counts(api, params, cfg, prompts, token, features=None):
    """Launches of one prefill (with ``features``, whisper's frames or a
    vlm's image embeddings, where given) and of one decode step after it
    (after a vlm's image slots)."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import image_offset
    from repro_torch.models import pad_cache

    P = prompts.shape[1] + image_offset(cfg, features)
    with torch.no_grad():
        reset_launches()
        _, caches = api.prefill_fn(params, cfg, {"tokens": prompts, "labels": prompts,
                                                 **(features or {})})
        prefill = dict(LAUNCHES)
        caches = pad_cache(caches, P, P + 1)
        reset_launches()
        api.decode_fn(params, cfg, token, P, caches)
        decode = dict(LAUNCHES)
    del caches
    return prefill, decode


def phase_hybrid_serve():
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models import get_api, param_count
    from repro_torch.models.hybrid import n_shared_slots
    from repro_torch.tree import tree_map

    print(f"== phase 14: serving {HYBRID_ARCH} at full width and depth on the card (use_pallas)")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    cfg = serve_config(get_config(HYBRID_ARCH).replace(use_pallas=True), P)
    api = get_api(cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = api.init_params(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"init_params(PRNGKey(0)) on the card: {n_params} params ({cfg.n_layers} layers, "
          f"{n_shared_slots(cfg)} shared slots, ssm_chunk {cfg.ssm_chunk}), "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = prng.randint(prng.PRNGKey(0, device=dev), (B, P), 0, cfg.vocab_size)
    L, slots = cfg.n_layers, n_shared_slots(cfg)
    norms = L + 2 * slots + 1
    want_prefill = {"gated_rmsnorm": L, "ssd_scan": L, "rmsnorm": norms}
    want_decode = {"rmsnorm": norms + L}
    generate(params, cfg, prompts, 2)                          # warm-up: cuBLAS, allocator
    reset_launches()
    res = generate(params, cfg, prompts, G)
    launches = dict(LAUNCHES)
    want = {"gated_rmsnorm": L, "ssd_scan": L, "rmsnorm": norms + (G - 1) * (norms + L)}
    if launches != want:
        fail(f"hybrid serve: launches {launches}, expected {want}")
    per_prefill, per_decode = _hybrid_counts(api, params, cfg, prompts, res.tokens[:, :1])
    if per_prefill != want_prefill or per_decode != want_decode:
        fail(f"hybrid serve: one prefill launched {per_prefill} (expected {want_prefill}), one "
             f"decode step {per_decode} (expected {want_decode})")
    if res.tokens.shape != (B, G) or not bool(((res.tokens >= 0)
                                                & (res.tokens < cfg.vocab_size)).all()):
        fail(f"hybrid serve: tokens {tuple(res.tokens.shape)} out of range")
    rec = {"arch": HYBRID_ARCH, "params": n_params, "batch": B, "prompt": P, "gen": G,
           "ssm_chunk": cfg.ssm_chunk, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "prefill_tok_s": B * P / res.prefill_s, "decode_tok_s": B * (G - 1) / res.decode_s,
           "launches": launches, "per_prefill": per_prefill, "per_decode_step": per_decode}
    print(f"serve {HYBRID_ARCH} batch {B} prompt {P} gen {G}: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({rec['prefill_tok_s']:.0f} tok/s), decode {res.decode_s * 1e3:.2f} ms for {G - 1} "
          f"steps ({rec['decode_tok_s']:.1f} tok/s); launches {launches}; per prefill "
          f"{per_prefill}, per decode step {per_decode}")

    # card against CPU: the first 7 layers and the first shared slot of the
    # same weights, at full width
    small_cfg = cfg.replace(n_layers=HYBRID_CPU_LAYERS)
    n_small = n_shared_slots(small_cfg)
    small = dict(params, layers=tree_map(lambda t: t[:HYBRID_CPU_LAYERS], params["layers"]),
                 lora=tree_map(lambda t: t[:n_small], params["lora"]))
    cpu = torch.device("cpu")
    small_cpu = tree_map(lambda t: t.to(cpu), small)
    few = prompts[:HYBRID_CPU_BATCH]
    gpu2 = generate(small, small_cfg, few, HYBRID_CPU_GEN)
    t0 = time.perf_counter()
    cpu2 = generate(small_cpu, small_cfg, few.to(cpu), HYBRID_CPU_GEN)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        lg_gpu, _ = api.prefill_fn(small, small_cfg, {"tokens": few, "labels": few})
        lg_cpu, _ = api.prefill_fn(small_cpu, small_cfg, {"tokens": few.to(cpu),
                                                          "labels": few.to(cpu)})
    diff = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    same = torch.equal(gpu2.tokens.cpu(), cpu2.tokens)
    print(f"{HYBRID_CPU_LAYERS} layers ({n_small} shared slot), batch {HYBRID_CPU_BATCH}, "
          f"{HYBRID_CPU_GEN} tokens on the host CPU ({cpu_s:.2f} s): greedy tokens identical="
          f"{same}, max |prefill logits card - cpu| {diff:.3g}")
    if not same or not diff <= 1e-3:
        fail("hybrid serve: card and CPU disagree")
    rec.update(cpu_layers=HYBRID_CPU_LAYERS, cpu_tokens_identical=same,
               cpu_prefill_logits_max_abs_diff=diff)
    del small_cpu, small
    return params, rec


def phase_hybrid_loss(params):
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import get_api
    from repro_torch.models.hybrid import n_shared_slots

    print(f"== phase 15: the forward loss of {HYBRID_ARCH} at full depth on the card")
    cfg = get_config(HYBRID_ARCH)
    pallas = cfg.replace(use_pallas=True)
    api = get_api(cfg)
    dev = torch.device("cuda")
    tokens = prng.randint(prng.PRNGKey(1, device=dev), (HYBRID_LOSS_B, HYBRID_LOSS_S), 0,
                          cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    L, slots = cfg.n_layers, n_shared_slots(cfg)
    want = {"flash_attention": slots, "ssd_scan": L, "gated_rmsnorm": L,
            "rmsnorm": L + 2 * slots + 1}
    with torch.no_grad():
        api.loss_fn(params, pallas, batch)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss, _ = api.loss_fn(params, pallas, batch)
        launches = dict(LAUNCHES)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss_plain, _ = api.loss_fn(params, cfg, batch)
        torch.cuda.synchronize()
        peak_plain = torch.cuda.max_memory_allocated()
        ms = time_ms(lambda: api.loss_fn(params, pallas, batch), reps=3)
        ms_plain = time_ms(lambda: api.loss_fn(params, cfg, batch), reps=3)
    if launches != want:
        fail(f"hybrid loss: launches {launches}, expected {want}")
    diff = abs(loss.item() - loss_plain.item())
    print(f"loss B={HYBRID_LOSS_B} S={HYBRID_LOSS_S}: use_pallas {loss.item():.6f}, plain path "
          f"{loss_plain.item():.6f}, |diff| {diff:.3g} (tol 2e-4); {ms:.2f} ms per forward "
          f"({ms_plain:.2f} ms without the kernels); peak memory {peak / 2**30:.3f} GiB "
          f"({peak_plain / 2**30:.3f} GiB); launches {launches}")
    if not torch.isfinite(loss) or not diff <= 2e-4:
        fail(f"hybrid loss: use_pallas {loss.item()} vs {loss_plain.item()}")
    return {"B": HYBRID_LOSS_B, "S": HYBRID_LOSS_S, "loss": loss.item(),
            "loss_plain_path": loss_plain.item(), "ms": ms, "ms_plain_path": ms_plain,
            "peak_bytes": peak, "peak_bytes_plain_path": peak_plain, "launches": launches}


def exp5_spec(mechanism: str, strategy: str = "fedfair", incentive: str = "one_shot",
              rounds: int = EXP5["rounds"], budget: float = EXP5["budget"],
              incentive_options=None):
    """exp5 (and exp11's incentive runs, which differ only in budget,
    rounds and incentive) on the vmap backend."""
    from repro_torch.api import (AllocationSpec, AuctionSpec, ClientPopulationSpec,
                                 RuntimeSpec, ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=f"exp5-{mechanism}-{incentive}-{strategy}", seed=0, data_seed=0,
        tasks=[TaskSpec(t, options={"n_range": [60, 90]}) for t in EXP5["tasks"]],
        clients=ClientPopulationSpec(n_clients=EXP5["clients"],
                                     participation=EXP5["participation"]),
        allocation=AllocationSpec(strategy=strategy, alpha=3.0),
        auction=AuctionSpec(mechanism=mechanism, budget=budget, bid_model="exp4", bid_seed=0,
                            incentive=incentive, incentive_options=dict(incentive_options or {})),
        runtime=RuntimeSpec(backend="vmap", rounds=rounds, tau=3))


def exp11_spec(policy: str):
    from repro_torch.api import (AllocationSpec, ClientPopulationSpec, PolicySpec, RuntimeSpec,
                                 ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=f"exp11-{policy}", seed=0, data_seed=0,
        tasks=[TaskSpec(t, options={"n_range": [60, 90]}) for t in EXP11["tasks"]],
        clients=ClientPopulationSpec(n_clients=EXP11["clients"],
                                     participation=EXP11["participation"]),
        allocation=AllocationSpec(strategy="fedfair", alpha=3.0),
        policy=PolicySpec(policy, dict(EXP11["policies"][policy])),
        runtime=RuntimeSpec(backend="vmap", rounds=EXP11["rounds"], tau=3))


def exp11_incentive_spec(incentive: str, strategy: str = "fedfair"):
    return exp5_spec("gmmfair", strategy, incentive, EXP11_INC["rounds"], EXP11_INC["budget"],
                     EXP11_INC["incentives"][incentive])


def run_sync_counted(label: str, spec, device: str = "cuda"):
    """One sync run through ``run_counted``: on the card, fedavg must
    launch once per non-empty (round, task) fold and nothing else."""
    import numpy as np

    res, launches = run_counted(spec, device)
    rounds = spec.runtime.rounds
    folds = int((res.alloc_counts > 0).sum())
    if device == "cuda" and launches != {"fedavg": folds}:
        fail(f"{label}: launches {launches} for {folds} non-empty (round, task) folds")
    if res.acc.shape != (rounds, len(spec.tasks)) or not np.isfinite(res.acc).all():
        fail(f"{label}: accuracy curve {res.acc.shape} not finite")
    if device == "cuda":
        print(f"{label}: {rounds / res.wall_time:.2f} rounds/s ({res.wall_time:.3f} s), fedavg "
              f"launches {launches['fedavg']} = non-empty folds {folds}, min-acc "
              f"{res.fairness['min_acc']:.4f}"
              + ("" if res.auction is None else f", auction {json.dumps(res.auction)}"))
    return res, launches


HELD_SPAN = 2**24        # columns of a fold held against ref_fedavg at once


class FoldShapes:
    """Records the shapes the runs of phases 16-19 hand to the fold
    kernels, with the number of calls at each: (K, N, dtype) of each
    ``fedavg`` call of the vmap backend (every sync fold, every qfedavg and
    fedavg flush) and (K, N, mode) of each ``fused_aggregate`` flush. A
    pass-through around the port's two call sites that only records; each
    wrapper still counts its launches. Each fedavg call is also held
    against ``ref_fedavg`` on its own inputs (``held``: the max |err| and
    the dtype of each call; ``check_run_shapes`` checks them). That check
    stays out of what the phases report: its seconds add up in ``held_s``,
    which ``run_counted`` and ``TaskClock`` take off their times, and the
    device's peak is read before it allocates and reset after it
    (``reset_peak``, ``peak_bytes``)."""

    held_s = 0.0        # seconds of the held checks, over every window

    def __init__(self):
        import collections

        # shape -> number of calls
        self.fedavg, self.fused = collections.Counter(), collections.Counter()
        self.held = []
        self.held_peak, self.seconds = 0, 0.0

    def __enter__(self):
        import torch

        import repro_torch.api.aggregator as aggregator
        import repro_torch.api.backend as backend
        from repro_torch.kernels.ref import ref_fedavg

        self._saved = fedavg, fused = backend.fedavg, aggregator.fused_aggregate

        def fedavg_rec(stacked, weights):
            self.fedavg[(*stacked.shape, str(stacked.dtype).removeprefix("torch."))] += 1
            out = fedavg(stacked, weights)
            torch.cuda.synchronize()
            self.held_peak = max(self.held_peak, torch.cuda.max_memory_allocated())
            t0 = time.perf_counter()
            # in spans of columns: an LM fold's plain version at once would
            # need one more (N,) buffer than the fold itself
            N = stacked.shape[1]
            err = max((out[a:a + HELD_SPAN].float() - ref_fedavg(
                stacked[:, a:a + HELD_SPAN], weights).float()).abs().max().item()
                for a in range(0, N, HELD_SPAN))
            dt = time.perf_counter() - t0
            self.seconds += dt
            FoldShapes.held_s += dt
            torch.cuda.reset_peak_memory_stats()
            self.held.append((err, str(stacked.dtype).removeprefix("torch.")))
            return out

        def fused_rec(x, *args, mode, **kw):
            self.fused[(*x.shape, mode)] += 1
            return fused(x, *args, mode=mode, **kw)

        backend.fedavg, aggregator.fused_aggregate = fedavg_rec, fused_rec
        return self

    def __exit__(self, *exc):
        import repro_torch.api.aggregator as aggregator
        import repro_torch.api.backend as backend

        backend.fedavg, aggregator.fused_aggregate = self._saved

    def reset_peak(self):
        import torch

        torch.cuda.reset_peak_memory_stats()
        self.held_peak = 0

    def peak_bytes(self) -> int:
        """The device's peak since ``reset_peak``, without the checks'."""
        import torch

        return max(self.held_peak, torch.cuda.max_memory_allocated())


def check_run_shapes(label: str, shapes: FoldShapes) -> dict:
    """Hold each fold kernel against its plain version at every shape the
    runs gave it (phase 2 and 5 check a fixed grid of K; the vmap backend
    folds each cohort at its own size), on seeded inputs, at ``TOL`` and
    ``FUSED_TOL``. Made after the runs' counts were read, so these
    launches count nowhere."""
    import numpy as np
    import torch

    from repro_torch.kernels import fedavg
    from repro_torch.kernels.ref import ref_fedavg

    bad = [(e, name) for e, name in shapes.held if not e <= TOL[name]]
    if bad:
        fail(f"{label}: fedavg calls of the runs against ref_fedavg on their own inputs: "
             f"max |err| {bad} (tol {TOL})")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"fedavg": max((e for e, _ in shapes.held), default=0.0), "fused_aggregate": 0.0}
    for K, N, name in sorted(shapes.fedavg):
        if K * N > 2**24:                 # an LM fold: draw it on the card
            x32 = torch.randn(K, N, generator=gen, device=dev)
            w = torch.rand(K, generator=gen, device=dev).add_(0.1)
            w /= w.sum()
        else:
            x32, w = _fold_inputs(rng, K, N, dev)
        x = x32.to(getattr(torch, name))
        got, want = fedavg(x, w), ref_fedavg(x, w)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        if got.dtype != x.dtype or got.shape != (N,) or not e <= TOL[name]:
            fail(f"{label}: fedavg at the run shape K={K} N={N} {name}: {got.dtype} "
                 f"{tuple(got.shape)}, max |err| {e} (tol {TOL[name]})")
        err["fedavg"] = max(err["fedavg"], e)
        del x, x32, got, want
    for K, N, mode in sorted(shapes.fused):
        e, _ = check_fused(*_flush_inputs(gen, K, N, dev), mode, f"{label} run shape K={K} N={N}")
        err["fused_aggregate"] = max(err["fused_aggregate"], e)
    ks = sorted({k for k, _, _ in shapes.fedavg})
    print(f"{label}: "
          + (f"each of the {len(shapes.held)} fedavg calls held against ref_fedavg on its own "
             f"inputs and at all {len(shapes.fedavg)} (K, N, dtype) "
             f"folds the runs made (K {ks[0]}-{ks[-1]}, N in "
             f"{sorted({n for _, n, _ in shapes.fedavg})}, "
             f"{sorted({d for _, _, d in shapes.fedavg})}): max |err| {err['fedavg']:.3g} "
             f"(tol {TOL}; the checks took {shapes.seconds:.3f} s, kept out of the runs' "
             f"times)" if ks else "no fedavg fold")
          + (f"; fused_aggregate at all {len(shapes.fused)} (K, N, mode) flushes "
             f"({sorted(shapes.fused)}): max |err| {err['fused_aggregate']:.3g} "
             f"(rtol/atol {FUSED_TOL})" if shapes.fused else ""))
    return {"fedavg_shapes": len(shapes.fedavg), "fedavg_calls_held": len(shapes.held),
            "fused_shapes": len(shapes.fused), **err}


def phase_incentives(line: str):
    """Phase 16: the sync slice under the auctions and the stateful policies."""
    import numpy as np

    print("== phase 16: sync incentives and policies on the card (run_scenario, vmap backend)")
    print(f"card: {line}")
    runs = {}
    with FoldShapes() as shapes:
        for mech in EXP5["mechanisms"]:
            runs[f"exp5-{mech}"] = run_sync_counted(f"exp5 {mech}", exp5_spec(mech))
        for policy in EXP11["policies"]:
            runs[f"exp11-{policy}"] = run_sync_counted(f"exp11 {policy}", exp11_spec(policy))
        for incentive in EXP11_INC["incentives"]:
            runs[f"exp11-{incentive}"] = run_sync_counted(f"exp11 {incentive}",
                                                          exp11_incentive_spec(incentive))
    checked = check_run_shapes("phase 16", shapes)
    if runs["exp11-periodic_auction"][0].auction["auctions_run"] < 2:
        fail("exp11 periodic_auction ran fewer than two auctions")
    for label, make in (("exp5 gmmfair", lambda: exp5_spec("gmmfair", "round_robin")),
                        ("exp11 periodic_auction",
                         lambda: exp11_incentive_spec("periodic_auction", "round_robin"))):
        gpu, _ = run_sync_counted(f"{label} round_robin", make())
        cpu, _ = run_sync_counted(f"{label} round_robin (CPU)", make(), "cpu")
        same = gpu.auction == cpu.auction and np.array_equal(gpu.alloc, cpu.alloc)
        diff = float(np.abs(gpu.acc - cpu.acc).max())
        print(f"{label} round_robin card vs CPU: auction ledgers and allocation traces "
              f"identical={same}, max |acc card - acc cpu| {diff:.6f}, CPU "
              f"{len(cpu.alloc) / cpu.wall_time:.2f} rounds/s")
        if not same or not diff <= 0.01:
            fail(f"{label} round_robin card vs CPU disagree")
    return {k: launches for k, (_, launches) in runs.items()}, checked


def exp13_spec(aggregator, options=None, strategy: str = "fedfair", buffer: int = EXP13["buffer"],
               spread: float = EXP13["spread"], cost_model=None, cost_options=None,
               policy=None, name: str = "exp13", arrivals: int = EXP13["arrivals"]):
    """exp13's skewed two-task async scenario; exp14 is the same at spread
    4 with a cost model and a policy."""
    from repro_torch.api import (AllocationSpec, ClientPopulationSpec, PolicySpec, RuntimeSpec,
                                 ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=f"{name}-{aggregator or 'fedavg'}-{cost_model or 'constant'}-{policy or strategy}",
        seed=0, data_seed=0,
        tasks=[TaskSpec(t, options={"n_range": [60, 90]}) for t in EXP13["tasks"]],
        clients=ClientPopulationSpec(n_clients=EXP13["clients"], speed_profile="bimodal",
                                     speed_spread=spread),
        allocation=AllocationSpec(strategy=strategy, alpha=3.0),
        policy=None if policy is None else PolicySpec(policy),
        runtime=RuntimeSpec(mode="async", backend="vmap", tau=3,
                            total_arrivals=arrivals, buffer_size=buffer, beta=0.5,
                            aggregator=aggregator, aggregator_options=dict(options or {}),
                            cost_model=cost_model, cost_model_options=dict(cost_options or {})))


def exp14_spec(policy=None, strategy: str = "fedfair", aggregator=None, options=None):
    return exp13_spec(aggregator, options, strategy, spread=EXP14_SPREAD,
                      cost_model="lognormal_straggler", cost_options=LOGNORMAL, policy=policy,
                      name="exp14")


def trace_spec():
    """exp14's scenario under ``trace_replay``: an inline trace of eight
    latencies per client, drawn from a lognormal with the script's seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    lat = rng.lognormal(0.0, 0.6, (EXP13["clients"], 8)).round(4) + 0.05
    trace = {"latencies": {str(c): lat[c].tolist() for c in range(EXP13["clients"])}}
    return exp13_spec(None, spread=EXP14_SPREAD, cost_model="trace_replay",
                      cost_options={"trace": trace}, name="trace")


def run_async_counted(label: str, spec, kernel, device: str = "cuda"):
    """One async run through ``run_counted``: on the card ``kernel`` must
    launch once per flush and nothing else (``None``: nothing at all)."""
    import numpy as np

    res, launches = run_counted(spec, device)
    flushes = len(res.time)
    want = {} if kernel is None else {kernel: flushes}
    if flushes == 0 or (device == "cuda" and launches != want):
        fail(f"{label}: launches {launches} for {flushes} flushes, expected {want}")
    if res.acc.shape != (flushes, len(spec.tasks)) or not np.isfinite(res.acc).all():
        fail(f"{label}: accuracy curve {res.acc.shape} not finite")
    if device == "cuda":
        print(f"{label}: {flushes / res.wall_time:.2f} flushes/s ({flushes} flushes of "
              f"{spec.runtime.total_arrivals} arrivals, {res.wall_time:.3f} s), launches "
              f"{launches or 'none (no hand-written kernel)'}, cost_dropouts "
              f"{res.cost_dropouts}, min-acc {res.fairness['min_acc']:.4f}")
    return res, launches


def _same_events(a, b) -> bool:
    import numpy as np

    return (all(np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean"))
            and a.assignments == b.assignments and a.cost_dropouts == b.cost_dropouts)


def phase_robust_costs(line: str):
    """Phase 17: the async slice under the robust rules, qfedavg and the
    heavy-tailed and replayed cost models; the sweep."""
    import numpy as np

    from repro_torch.api import sweep_scenarios
    from repro_torch.interop import params_to_numpy

    print("== phase 17: async robust aggregators and cost models on the card "
          "(run_scenario mode='async', vmap backend)")
    print(f"card: {line}")
    runs = {}
    with FoldShapes() as shapes:
        for agg, opts in EXP13["aggregators"].items():
            kernel = "fedavg" if agg == "qfedavg" else None
            runs[f"exp13-{agg}"] = run_async_counted(f"exp13 {agg}", exp13_spec(agg, opts),
                                                     kernel)
        print("fedmedian and trimmed_mean are plain torch (a sort along the cohort axis, as "
              "the JAX package's jnp): they launch no hand-written kernel")
        for policy in ("thompson", "ucb_bandit"):
            res, _ = runs[f"exp14-{policy}"] = run_async_counted(
                f"exp14 lognormal_straggler {policy}", exp14_spec(policy), "fedavg")
            t2a = res.time_to_accuracy(EXP14_TARGET)
            print(f"exp14 lognormal_straggler {policy}: time_to_accuracy({EXP14_TARGET}) "
                  f"{json.dumps(t2a)}")
            if res.cost_dropouts <= 0:
                fail(f"exp14 {policy}: no cost-model dropouts")
        runs["fedadam-lognormal"] = run_async_counted(
            "fedadam (server lr 0.1) lognormal_straggler",
            exp14_spec(aggregator="fedadam", options=SERVER_OPTIONS["fedadam"]),
            "fused_aggregate")
        runs["trace_replay"] = run_async_counted("trace_replay", trace_spec(), "fedavg")
    checked = check_run_shapes("phase 17", shapes)

    gpu, _ = run_async_counted("exp14 lognormal_straggler round_robin",
                               exp14_spec(strategy="round_robin"), "fedavg")
    cpu, _ = run_async_counted("(CPU)", exp14_spec(strategy="round_robin"), "fedavg", "cpu")
    same = _same_events(gpu, cpu)
    print(f"exp14 lognormal_straggler round_robin card vs CPU: event traces and cost_dropouts "
          f"({gpu.cost_dropouts}) identical={same}, CPU {len(cpu.time) / cpu.wall_time:.2f} "
          "flushes/s")
    if not same:
        fail("lognormal_straggler round_robin card vs CPU event traces differ")
    gpu, _ = run_async_counted("exp13 fedmedian round_robin buffer 4",
                               exp13_spec("fedmedian", strategy="round_robin", buffer=4), None)
    cpu, _ = run_async_counted("(CPU)", exp13_spec("fedmedian", strategy="round_robin", buffer=4),
                               None, "cpu")
    diff = max(float(np.abs(a - b).max())
               for pa, pb in zip(params_to_numpy(gpu.params), params_to_numpy(cpu.params))
               for la, lb in zip(pa, pb) for a, b in ((la["w"], lb["w"]), (la["b"], lb["b"])))
    same = _same_events(gpu, cpu)
    print(f"exp13 fedmedian round_robin buffer 4 card vs CPU: event traces identical={same}, "
          f"max |params card - params cpu| {diff:.3g}")
    if not same or not diff <= 1e-4:
        fail("fedmedian round_robin card vs CPU disagree")

    base = exp13_spec(None, name="sweep", arrivals=SWEEP_ARRIVALS)
    grid = {"allocation.alpha": [1.0, 3.0], "runtime.aggregator": ["fedmedian", "qfedavg"]}
    t0 = time.perf_counter()
    seq = sweep_scenarios(base, grid, device="cuda")
    t1 = time.perf_counter()
    par = sweep_scenarios(base, grid, device="cuda", max_workers=2)
    t2 = time.perf_counter()
    for payload in (seq, par):
        for run in payload["runs"]:
            run.pop("wall_time")
            run["result"].pop("wall_time")
    print(f"sweep 2x2 (alpha x aggregator), {SWEEP_ARRIVALS} arrivals a point: sequential {t1 - t0:.2f} s, "
          f"2 spawned workers {t2 - t1:.2f} s; payloads equal but for wall times={seq == par}")
    if seq != par or len(seq["runs"]) != 4:
        fail("sweep: the parallel payload differs from the sequential one")
    return {k: launches for k, (_, launches) in runs.items()}, checked


def arch_spec(name: str, tasks: dict, clients: int, *, mode: str = "sync",
              strategy: str = "fedfair", rounds: int = ARCH_SYNC["rounds"],
              arrivals: int = ARCH_ASYNC["arrivals"], buffer: int = ARCH_ASYNC["buffer"],
              aggregator=None, options=None):
    """An ``arch`` scenario on the vmap backend: ``tasks`` maps each arch to
    its TaskSpec options; bimodal client speeds (the async runs' clock)."""
    from repro_torch.api import (AllocationSpec, ClientPopulationSpec, RuntimeSpec,
                                 ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=name, seed=0, data_seed=0,
        tasks=[TaskSpec(a, family="arch", options=dict(o)) for a, o in tasks.items()],
        clients=ClientPopulationSpec(n_clients=clients, participation=ARCH_SYNC["participation"],
                                     speed_profile="bimodal"),
        allocation=AllocationSpec(strategy=strategy, alpha=3.0),
        runtime=RuntimeSpec(mode=mode, backend="vmap", rounds=rounds,
                            tau=max(o["tau"] for o in tasks.values()),
                            total_arrivals=arrivals, buffer_size=buffer, beta=ARCH_ASYNC["beta"],
                            aggregator=aggregator, aggregator_options=dict(options or {})))


def _trained_tokens(spec, res) -> int:
    """Tokens the sync run trained on: rows x seq x tau for every task a
    round gave clients."""
    return sum(int((res.alloc_counts[:, s] > 0).sum()) * t.options["batch"] * t.options["seq"]
               * t.options["tau"] for s, t in enumerate(spec.tasks))


def norms_per_step(task, params) -> int:
    """rmsnorm launches of one training forward and backward of ``task``'s
    model (B 1, its seq), counted alone, after the run's counts were read:
    every norm's forward is the kernel, its backward plain."""
    import torch

    import repro_torch.launch.train as train
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import get_api

    o = task.options
    # the config build_task makes (through DepthCut where one is active)
    cfg = (train.smoke_config if o["preset"] == "tiny" else train.get_config)(task.name)
    toks = torch.randint(0, cfg.vocab_size, (1, o["seq"]), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    reset_launches()
    train.loss_and_grads(get_api(cfg), cfg, params, train.arch_features(cfg, toks))
    torch.cuda.synchronize()
    return LAUNCHES["rmsnorm"]


def time_lm_shapes(shapes: FoldShapes) -> dict:
    """Time the fold kernels at each shape the LM runs gave them (CUDA
    events, median of 20), beside the bound, the plain version and, for
    fedavg, ``w @ x``; fused_aggregate also beside ``disc @ x``, the reduce
    alone (no single PyTorch call computes the fused flush). Inputs drawn
    on the card."""
    import torch

    from repro_torch.kernels import fedavg, fused_aggregate
    from repro_torch.kernels.ref import ref_fedavg, ref_fused_aggregate

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for K, N, _ in sorted(shapes.fedavg):
        x = torch.randn(K, N, generator=gen, device=dev)
        w = torch.rand(K, generator=gen, device=dev).add_(0.1)
        w /= w.sum()
        bound, by = fold_bound_ms(K, N, 4, 4)
        out.append({"kernel": "fedavg", "shape": [K, N], "ms": time_ms(lambda: fedavg(x, w)),
                    "plain_ms": time_ms(lambda: ref_fedavg(x, w)),
                    "library_ms": time_ms(lambda: w @ x), "bound_ms": bound, "bound_by": by})
        del x
    for K, N, mode in sorted(shapes.fused):
        x, w, s, m, v = _flush_inputs(gen, K, N, dev)
        norm, norm_dev = float(w.sum()), w.sum()
        disc = w * (1.0 + s) ** -FUSED_SCALARS["beta"] / norm_dev
        bound, by = fused_bound_ms(K, N, mode)
        out.append({
            "kernel": "fused_aggregate", "shape": [K, N], "mode": mode,
            "ms": time_ms(lambda: fused_aggregate(x, w, s, m, v, mode=mode, normalizer=norm,
                                                  **FUSED_SCALARS)),
            "plain_ms": time_ms(lambda: ref_fused_aggregate(x, w, s, m, v, mode=mode,
                                                            normalizer=norm_dev,
                                                            **FUSED_SCALARS)),
            "library_ms": None, "reduce_only_ms": time_ms(lambda: disc @ x),
            "bound_ms": bound, "bound_by": by})
        del x, m, v, disc
    torch.cuda.empty_cache()
    for r in out:
        print(f"{r['kernel']} at the run shape K={r['shape'][0]} N={r['shape'][1]}"
              f"{' ' + r['mode'] if 'mode' in r else ''}: kernel {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%} of the {r['bound_by']} bound "
              f"{r['bound_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              + (f"library (w @ x) {r['library_ms']:.4f} ms" if r["library_ms"] is not None
                 else f"disc @ x (the reduce alone) {r['reduce_only_ms']:.4f} ms"))
    return out


def _loss_gap(gpu, cpu) -> float:
    import numpy as np

    return float(np.abs(np.asarray(gpu.loss) - np.asarray(cpu.loss)).max())


def phase_arch_sync(line: str):
    """Phase 18: LM training through run_scenario in sync mode."""
    import numpy as np
    import torch

    from repro_torch.models import param_count

    print("== phase 18: sync arch training on the card (run_scenario, vmap backend)")
    print(f"card: {line}")
    torch.cuda.empty_cache()
    spec = arch_spec("arch-sync", ARCH_SYNC["tasks"], ARCH_SYNC["clients"])
    with FoldShapes() as shapes:
        shapes.reset_peak()
        res, launches = run_counted(spec, "cuda")
    peak = shapes.peak_bytes()
    rounds = spec.runtime.rounds
    names = res.task_names
    folded = [s for s, t in enumerate(spec.tasks) if t.options["tau"] > 1]
    folds = int((res.alloc_counts[:, folded] > 0).sum())
    n = {a: param_count(p) for a, p in zip(names, res.params)}
    want_shapes = {(t.options["batch"], n[t.name], "float32"): int((res.alloc_counts[:, s] > 0)
                                                                   .sum())
                   for s, t in enumerate(spec.tasks) if s in folded}
    want_shapes = {k: v for k, v in want_shapes.items() if v}
    if not folds or launches.get("fedavg", 0) != folds or dict(shapes.fedavg) != want_shapes:
        fail(f"phase 18: fedavg launched {launches.get('fedavg', 0)} times at "
             f"{dict(shapes.fedavg)} for {folds} non-empty tau>1 folds {want_shapes}")
    if set(launches) - {"fedavg", "rmsnorm"} or launches.get("rmsnorm", 0) <= 0:
        fail(f"phase 18: launches {launches}")
    # the prevailing loss is inf until a task first trains (as in the
    # reference); from then on every reported loss must be finite
    trained = np.cumsum(res.alloc_counts > 0, axis=0) > 0
    if not (trained[-1].all() and np.isfinite(res.loss[trained]).all()
            and np.isfinite(res.acc).all()):
        fail(f"phase 18: loss {res.loss} or accuracy {res.acc} not finite, or a task never "
             f"trained ({res.alloc_counts.tolist()})")
    tokens = _trained_tokens(spec, res)
    per_step = {t.name: norms_per_step(t, p) for t, p in zip(spec.tasks, res.params)}
    rec = {"s_per_round": res.wall_time / rounds, "trained_tokens_per_s": tokens / res.wall_time,
           "trained_tokens": tokens, "wall_s": res.wall_time, "peak_bytes": peak,
           "final_loss": res.final_loss, "final_acc": dict(zip(names, res.acc[-1].tolist())),
           "alloc_counts": res.alloc_counts.tolist(), "params": n, "launches": launches,
           "fedavg_folds": folds, "rmsnorm_per_training_step": per_step}
    print(f"arch sync {names}: {rec['s_per_round']:.3f} s/round, {rec['trained_tokens_per_s']:.1f} "
          f"trained tokens/s ({tokens} tokens in {res.wall_time:.3f} s), peak "
          f"{peak / 2**30:.3f} GiB; final loss {json.dumps(res.final_loss)}, final acc "
          f"{json.dumps(rec['final_acc'])}; launches {launches}, fedavg = non-empty tau>1 folds "
          f"{folds} at {dict(shapes.fedavg)}; rmsnorm launches per training step (forward "
          f"through the kernel, backward plain) {per_step}")
    checked = check_run_shapes("phase 18", shapes)
    del res
    timed = time_lm_shapes(shapes)

    # zamba2-7b at full width, ARCH_ZAMBA layers: fused AdamW steps
    zrec = _adamw_step("phase 18", "zamba2-7b", *ARCH_ZAMBA)

    tiny = arch_spec("arch-tiny", {a: ARCH_TINY["options"] for a in ARCH_TINY["archs"]},
                     ARCH_TINY["clients"], strategy="round_robin", rounds=ARCH_TINY["rounds"])
    gpu, _ = run_counted(tiny, "cuda")
    cpu, _ = run_counted(tiny, "cpu")
    same = np.array_equal(gpu.alloc, cpu.alloc)
    gap = _loss_gap(gpu, cpu)
    print(f"tiny {list(ARCH_TINY['archs'])} round_robin card vs CPU: allocation traces identical="
          f"{same}, max |loss card - loss cpu| {gap:.3g}, accuracy curves identical="
          f"{np.array_equal(gpu.acc, cpu.acc)}")
    if not same or not gap <= 1e-3:
        fail("phase 18: tiny arch round_robin card vs CPU disagree")
    return {**rec, "zamba2_step": zrec, "card_vs_cpu_loss_gap": gap}, checked, timed


def phase_arch_async(line: str):
    """Phase 19: LM training through run_scenario in async mode."""
    import numpy as np
    import torch

    from repro_torch.models import param_count

    print("== phase 19: async arch training on the card (run_scenario mode='async', vmap backend)")
    print(f"card: {line}")
    torch.cuda.empty_cache()
    tasks = {a: dict(o, tau=ARCH_ASYNC["tau"]) for a, o in ARCH_SYNC["tasks"].items()}
    spec = arch_spec("arch-async", tasks, ARCH_SYNC["clients"], mode="async",
                     aggregator=ARCH_ASYNC["aggregator"], options=ARCH_ASYNC["options"])
    with FoldShapes() as shapes:
        shapes.reset_peak()
        res, launches = run_counted(spec, "cuda")
    peak = shapes.peak_bytes()
    flushes = len(res.time)
    n = [param_count(p) for p in res.params]
    if (flushes == 0 or launches.get("fused_aggregate", 0) != flushes
            or set(launches) - {"fused_aggregate", "rmsnorm"} or not launches.get("rmsnorm")):
        fail(f"phase 19: launches {launches} for {flushes} flushes")
    if (sum(shapes.fused.values()) != flushes
            or {(K, N) for K, N, _ in shapes.fused} - {(ARCH_ASYNC["buffer"], N) for N in n}):
        fail(f"phase 19: flush shapes {dict(shapes.fused)}, params {n}")
    if not (np.isfinite(res.loss).all() and np.isfinite(res.acc).all()):
        fail(f"phase 19: metric {res.loss} or accuracy {res.acc} not finite")
    rec = {"flushes": flushes, "flushes_per_s": flushes / res.wall_time, "wall_s": res.wall_time,
           "peak_bytes": peak, "acc_eval": res.acc.tolist(), "metric": res.loss.tolist(),
           "versions": np.asarray(res.versions).tolist(), "launches": launches,
           "flush_shapes": {f"{K}x{N} {m}": c for (K, N, m), c in sorted(shapes.fused.items())}}
    print(f"arch async {res.task_names}: {rec['flushes_per_s']:.3f} flushes/s ({flushes} flushes "
          f"of {spec.runtime.total_arrivals} arrivals, {res.wall_time:.3f} s), peak "
          f"{peak / 2**30:.3f} GiB, launches {launches}, flush shapes {rec['flush_shapes']}")
    for i, (t, acc, metric) in enumerate(zip(res.time, res.acc, res.loss)):
        print(f"  flush {i + 1}: t={t:.3f} acc_eval {acc.tolist()} eval loss {metric.tolist()}")
    checked = check_run_shapes("phase 19", shapes)
    del res
    timed = time_lm_shapes(shapes)

    tiny = arch_spec("arch-tiny-async",
                     {a: ARCH_TINY["options"] for a in ARCH_TINY["archs"]}, ARCH_TINY["clients"],
                     mode="async", strategy="round_robin", arrivals=ARCH_TINY["arrivals"],
                     buffer=ARCH_TINY["buffer"])
    gpu, _ = run_counted(tiny, "cuda")
    cpu, _ = run_counted(tiny, "cpu")
    same = _same_events(gpu, cpu)
    gap = _loss_gap(gpu, cpu)
    print(f"tiny {list(ARCH_TINY['archs'])} async fedavg round_robin card vs CPU: event traces "
          f"identical={same}, max |eval loss card - cpu| {gap:.3g}, accuracy curves identical="
          f"{np.array_equal(gpu.acc, cpu.acc)}")
    if not same or not gap <= 1e-3:
        fail("phase 19: tiny arch async card vs CPU disagree")
    return {**rec, "card_vs_cpu_loss_gap": gap}, checked, timed


class HostPeak:
    """Peak resident set of this process over a block, sampled from
    /proc/<pid>/status every 5 ms by a child process (the kernel's own
    high-water mark cannot be reset here, and a thread would contend
    with the run for the interpreter). ``bytes`` is None where /proc is
    missing."""

    SAMPLER = ("import signal, sys, time\n"
               "peak = 0\n"
               "def stop(*_):\n"
               "    print(peak, flush=True)\n"
               "    sys.exit(0)\n"
               "signal.signal(signal.SIGTERM, stop)\n"
               "print('ready', flush=True)\n"
               "while True:\n"
               "    try:\n"
               "        for ln in open(f'/proc/{sys.argv[1]}/status'):\n"
               "            if ln.startswith('VmRSS:'):\n"
               "                peak = max(peak, int(ln.split()[1]) * 1024)\n"
               "    except OSError:\n"
               "        stop()\n"
               "    time.sleep(0.005)\n")

    def __enter__(self):
        import os

        self.bytes = None
        self._proc = subprocess.Popen([sys.executable, "-c", self.SAMPLER, str(os.getpid())],
                                      stdout=subprocess.PIPE, text=True)
        self._proc.stdout.readline()          # sampling has started
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        out = self._proc.communicate(timeout=30)[0].split()
        self.bytes = int(out[-1]) if out and int(out[-1]) > 0 else None


def big_population_spec(backend: str = "serial", mode: str = "sync"):
    """``examples/specs/big_population.json`` as written; ``mode="async"``
    runs the same population through the async engine (POP_ASYNC)."""
    from repro_torch.api import ScenarioSpec

    spec = ScenarioSpec.load(str(BIG_POP))
    spec.runtime.backend = backend
    if mode == "async":
        spec.name = "big-population-async"
        spec.runtime.mode = "async"
        spec.runtime.total_arrivals = POP_ASYNC["arrivals"]
        spec.runtime.buffer_size = POP_ASYNC["buffer"]
        spec.runtime.aggregator = POP_ASYNC["aggregator"]
        spec.runtime.aggregator_options = dict(POP_ASYNC["options"])
        spec.clients.speed_profile = POP_ASYNC["speed_profile"]
        spec.clients.arrival_process = POP_ASYNC["arrival_process"]
    return spec


def phase_population(line: str):
    """Phase 20: 100,000-client populations through run_scenario."""
    import numpy as np
    import torch

    print("== phase 20: client populations on the card (100,000 clients, lazy shards)")
    print(f"card: {line}")
    runs, out = {}, {}
    with FoldShapes() as shapes:
        for label, spec, kernel in (
                ("sync serial", big_population_spec("serial"), None),
                ("sync vmap", big_population_spec("vmap"), "fedavg"),
                ("async vmap fedadam", big_population_spec("vmap", "async"), "fused_aggregate")):
            torch.cuda.synchronize()
            shapes.reset_peak()
            with HostPeak() as host:
                res, launches = run_counted(spec, "cuda")
            peak, rss = shapes.peak_bytes(), host.bytes
            n = len(res.time) if res.mode == "async" else spec.runtime.rounds
            folds = n if res.mode == "async" else int((res.alloc_counts > 0).sum())
            want = {} if kernel is None else {kernel: folds}
            if launches != want:
                fail(f"phase 20 {label}: launches {launches}, expected {want}")
            if (res.acc.shape != (n, len(spec.tasks)) or not np.isfinite(res.acc).all()
                    or spec.clients.n_clients != 100_000):
                fail(f"phase 20 {label}: accuracy {res.acc.shape} not finite")
            if _devices(res.params) != {"cuda"}:
                fail(f"phase 20 {label}: params on {_devices(res.params)}")
            rate = n / res.wall_time
            unit = "flushes/s" if res.mode == "async" else "rounds/s"
            rec = {"wall_s": res.wall_time, unit.replace("/", "_per_"): rate,
                   "min_acc": res.fairness["min_acc"], "launches": launches,
                   "cohort_per_round": (res.alloc_counts.sum(axis=1).tolist()
                                        if res.mode == "sync" else None),
                   "peak_device_bytes": peak, "peak_host_rss_bytes": rss}
            print(f"{label}: {rate:.3f} {unit} ({n} of them, {res.wall_time:.3f} s), min-acc "
                  f"{rec['min_acc']:.4f}, launches {launches or 'none (serial fold)'}, peak "
                  f"device {peak / 2**20:.1f} MiB, peak host RSS "
                  + (f"{rss / 2**30:.3f} GiB" if rss else "not measured"))
            runs[label], out[label] = res, rec
    checked = check_run_shapes("phase 20", shapes)
    for label, spec in (("sync serial", big_population_spec("serial")),
                        ("sync vmap", big_population_spec("vmap")),
                        ("async vmap fedadam", big_population_spec("vmap", "async"))):
        gpu = runs[label]
        cpu, _ = run_counted(spec, "cpu")
        same = (_same_events(gpu, cpu) if gpu.mode == "async"
                else np.array_equal(gpu.alloc, cpu.alloc))
        diff = float(np.abs(gpu.acc - cpu.acc).max())
        print(f"{label} card vs CPU: {'event' if gpu.mode == 'async' else 'allocation'} traces "
              f"identical={same}, max |acc card - acc cpu| {diff:.6f}, CPU "
              f"{cpu.wall_time:.3f} s")
        if not same or not diff <= 0.01:
            fail(f"phase 20 {label}: card vs CPU disagree")
        out[label]["card_vs_cpu_acc_gap"] = diff
    return out, checked


class CheckpointTimes:
    """Times every ``CheckpointManager.save`` (seconds and the bytes of the
    step it wrote) and every resume (``begin``, which reads the step to
    host tensors, plus the moves of the restored trees onto the engine's
    device). A pass-through that only measures."""

    def __enter__(self):
        import repro_torch.api.engine as engine
        import repro_torch.checkpoint as ck
        import repro_torch.fed.async_engine as async_engine

        self.saves, self.restores = [], []
        self._saved = (ck.CheckpointManager.save, ck.CheckpointManager.begin,
                       ck.to_device, engine.to_device, async_engine.to_device)
        save, begin, to_device = self._saved[:3]
        times = self

        def timed_save(mgr, step, tasks, *args, **kw):
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(mgr, step, tasks, *args, **kw)
            sd = Path(mgr._step_dir(step))
            times.saves.append((time.perf_counter() - t0,
                                sum(f.stat().st_size for f in sd.rglob("*") if f.is_file())))

        def timed_begin(mgr, *args, **kw):
            t0 = time.perf_counter()
            hit = begin(mgr, *args, **kw)
            if hit is not None:
                times.restores.append(time.perf_counter() - t0)
            return hit

        def timed_to_device(tree, device):
            import torch

            t0 = time.perf_counter()
            out = to_device(tree, device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            if times.restores:
                times.restores[-1] += time.perf_counter() - t0
            return out

        ck.CheckpointManager.save, ck.CheckpointManager.begin = timed_save, timed_begin
        ck.to_device = engine.to_device = async_engine.to_device = timed_to_device
        return self

    def __exit__(self, *exc):
        import repro_torch.api.engine as engine
        import repro_torch.checkpoint as ck
        import repro_torch.fed.async_engine as async_engine

        (ck.CheckpointManager.save, ck.CheckpointManager.begin, ck.to_device,
         engine.to_device, async_engine.to_device) = self._saved

    def summary(self) -> dict:
        return {"saves": len(self.saves),
                "s_per_save": statistics.median(s for s, _ in self.saves) if self.saves else None,
                "bytes_per_step": max(b for _, b in self.saves) if self.saves else None,
                "restore_s": list(self.restores)}


def _history(d: str) -> list:
    with open(Path(d) / "history.jsonl") as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _same_records(a: list, b: list, tol: float) -> bool:
    """Two sidecars' records: same kinds, keys and integers, floats within
    ``tol``."""
    def close(x, y):
        if isinstance(x, dict):
            return isinstance(y, dict) and x.keys() == y.keys() and all(
                close(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return isinstance(y, list) and len(x) == len(y) and all(map(close, x, y))
        if isinstance(x, float) or isinstance(y, float):
            return abs(x - y) <= tol
        return x == y

    return len(a) == len(b) and all(map(close, a, b))


def _params_gap(a, b) -> float:
    from repro_torch.tree import tree_leaves

    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for pa, pb in zip(a, b) for x, y in zip(tree_leaves(pa), tree_leaves(pb)))


def _with_ckpt(spec, d, every, resume=False, keep=3, **runtime):
    spec = spec.from_json(spec.to_json())
    spec.runtime.checkpoint_dir, spec.runtime.checkpoint_every = d, every
    spec.runtime.checkpoint_keep, spec.runtime.resume = keep, resume
    for k, v in runtime.items():
        setattr(spec.runtime, k, v)
    return spec


def _resume_case(label: str, spec, tmp: str, every: int, stop: dict, device: str = "cuda",
                 resume_device: str = "cuda", keep: int = 3, records_tol: float = 1e-6):
    """Uninterrupted with checkpoints, then stopped after a mid-run step
    (``stop``: runtime fields) and resumed on ``resume_device``. Returns
    (uninterrupted, resumed, step, launches of the resumed run, times,
    traces identical, sidecar records identical)."""
    import numpy as np

    full_dir, part_dir = str(Path(tmp) / f"{label}-full"), str(Path(tmp) / f"{label}-part")
    full, _ = run_counted(_with_ckpt(spec, full_dir, every, keep=keep), device)
    with CheckpointTimes() as times:
        run_counted(_with_ckpt(spec, part_dir, every, keep=keep, **stop), device)
        step = int((Path(part_dir) / "LATEST").read_text())
        resumed, launches = run_counted(_with_ckpt(spec, part_dir, every, resume=True, keep=keep),
                                        resume_device)
    ok = _same_events(full, resumed) if full.mode == "async" else (
        np.array_equal(full.alloc, resumed.alloc) and np.array_equal(full.alloc_counts,
                                                                    resumed.alloc_counts))
    same_records = _same_records(_history(full_dir), _history(part_dir), records_tol)
    return full, resumed, step, launches, times.summary(), ok, same_records


def curve_gap(a, b) -> tuple:
    """The largest |a - b| over the places where both curves are finite, and
    whether they agree elsewhere: no NaN in either, and an inf at the same
    places with the same sign in both."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    finite = np.isfinite(a) & np.isfinite(b)
    agree = (a.shape == b.shape and not np.isnan(a).any() and not np.isnan(b).any()
             and np.array_equal(np.isinf(a), np.isinf(b))
             and np.array_equal(a[np.isinf(a)], b[np.isinf(b)]))
    gap = float(np.abs(a[finite] - b[finite]).max(initial=0.0)) if a.shape == b.shape else np.inf
    return gap, bool(agree)


def phase_resume(line: str):
    """Phase 21: mid-run checkpoints and resume on the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import TASK_FAMILIES
    from repro_torch.kernels import LAUNCHES, reset_launches

    print("== phase 21: checkpoint and resume on the card")
    print(f"card: {line}")
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (a) the sync quickstart
        full, res, step, launches, times, ok, recs = _resume_case(
            "sync", quickstart_spec("fedfair"), tmp, RESUME_SYNC["every"],
            {"rounds": RESUME_SYNC["stop_round"]})
        gap = _params_gap(full.params, res.params)
        folds = int((res.alloc_counts[step:] > 0).sum())
        print(f"(a) sync quickstart: stopped after round {step}, resumed to {ROUNDS}: allocation "
              f"trace identical={ok}, max |params| gap {gap:.3g}, history records identical="
              f"{recs}; fedavg launches after the resume {launches.get('fedavg', 0)} = folds "
              f"{folds}; {times['s_per_save']:.4f} s per save, {times['bytes_per_step']} bytes "
              f"per step, restore {times['restore_s'][0]:.4f} s")
        if (not ok or not recs or not gap <= RESUME_PARAMS_TOL or step != RESUME_SYNC["stop_round"]
                or launches != {"fedavg": folds} or _devices(res.params) != {"cuda"}):
            fail("phase 21 (a): the resumed sync run differs from the uninterrupted one")
        out["sync"] = {"step": step, "params_gap": gap, "launches_after_resume": launches,
                       **times}

        # (b) the async fedadam slice; the first flush after the resume
        # runs fused_aggregate on restored moments
        full, res, step, launches, times, ok, recs = _resume_case(
            "async", async_spec("fedadam"), tmp, RESUME_ASYNC["every"],
            {"total_arrivals": RESUME_ASYNC["stop_arrivals"]})
        gap = _params_gap(full.params, res.params)
        after = len(res.time) - step
        print(f"(b) async fedadam: stopped after flush {step}, resumed to {ARRIVALS} arrivals: "
              f"event trace identical={ok}, max |params| gap {gap:.3g}, history records "
              f"identical={recs}; fused_aggregate launches after the resume "
              f"{launches.get('fused_aggregate', 0)} = flushes {after}; "
              f"{times['s_per_save']:.4f} s per save, {times['bytes_per_step']} bytes per step, "
              f"restore {times['restore_s'][0]:.4f} s")
        if (not ok or not recs or not gap <= RESUME_PARAMS_TOL or after <= 0
                or launches != {"fused_aggregate": after}):
            fail("phase 21 (b): the resumed async run differs from the uninterrupted one")
        runner = TASK_FAMILIES.get("synthetic")().async_engine(_with_ckpt(async_spec("fedadam"),
                                                   str(Path(tmp) / "async-part"),
                                                   RESUME_ASYNC["every"], resume=True),
                                        device="cuda")
        runner.engine.cfg.total_arrivals = 0      # restore only
        runner.engine.run()
        on = _devices(runner.engine._server_state) | _devices(runner.engine._params)
        if on != {"cuda"}:
            fail(f"phase 21 (b): restored params and moments on {on}")
        out["async"] = {"step": step, "params_gap": gap, "launches_after_resume": launches,
                        **times}

        # (c) LM training at full width: a step after round 1, resumed to
        # round 3; keep 1 (one step of qwen3's params and moments is GBs)
        torch.cuda.empty_cache()
        arch = arch_spec("arch-resume", ARCH_SYNC["tasks"], ARCH_SYNC["clients"])
        lm_dir = str(Path(tmp) / "lm")
        full, _ = run_counted(arch, "cuda")
        with CheckpointTimes() as times:
            run_counted(_with_ckpt(arch, lm_dir, 1, keep=1, rounds=1), "cuda")
            engine = TASK_FAMILIES.get("arch")().sync_engine(
                _with_ckpt(arch, lm_dir, 1000, resume=True, keep=1), device="cuda")
            reset_launches()
            res = engine.run()
            launches = dict(LAUNCHES)
        times = times.summary()
        loss_gap, curves_agree = curve_gap(full.loss, res.loss)
        recs = _history(lm_dir)
        on = set().union(*(_devices(engine.tasks[a]["params"]) | _devices(engine.tasks[a]["opt"])
                           for a in engine.names),
                         *(_devices(s) for s in engine._server_state.values() if s is not None))
        ok = np.array_equal(full.alloc, res.alloc)
        print(f"(c) LM training {res.task_names} at full width: step after round 1, resumed to "
              f"round {ARCH_SYNC['rounds']}: allocation trace identical={ok}, loss curves without "
              f"NaN and with inf at the same places={curves_agree}, max |loss| gap over the "
              f"finite places {loss_gap:.3g}, history records {len(recs)} rounds; launches after "
              f"the resume {launches}; restored trees on {on}; save {times['s_per_save']:.3f} s "
              f"for {times['bytes_per_step'] / 2**30:.3f} GiB, restore "
              f"{times['restore_s'][0]:.3f} s")
        if (not ok or not curves_agree or not loss_gap <= RESUME_LOSS_TOL
                or len(recs) != ARCH_SYNC["rounds"]
                or on != {"cuda"} or not launches.get("rmsnorm")
                or launches.get("fedavg", 0) != int((res.alloc_counts[1:, 0] > 0).sum())):
            fail("phase 21 (c): the resumed LM run differs from the uninterrupted one")
        out["lm"] = {"loss_gap": loss_gap, "launches_after_resume": launches, **times}
        del engine, res, full
        shutil.rmtree(lm_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # (d) across devices: card -> CPU and CPU -> card, round_robin
        cross = {}
        for label, spec, every, stop in (
                ("sync", quickstart_spec("round_robin"), RESUME_SYNC["every"],
                 {"rounds": RESUME_SYNC["stop_round"]}),
                ("async", async_spec("fedadam", "round_robin"), RESUME_ASYNC["every"],
                 {"total_arrivals": RESUME_ASYNC["stop_arrivals"]})):
            for first, second in (("cuda", "cpu"), ("cpu", "cuda")):
                full, res, step, _, _, ok, _ = _resume_case(
                    f"x-{label}-{first}", spec, tmp, every, stop, device=first,
                    resume_device=second)
                cross[f"{label} {first}->{second}"] = ok
                print(f"(d) {label} round_robin: a step written on {first} (after "
                      f"{'round' if label == 'sync' else 'flush'} {step}) resumed on {second}: "
                      f"trace identical to the uninterrupted {first} run={ok}")
                if not ok:
                    fail(f"phase 21 (d): {label} {first} -> {second} traces differ")
        out["cross_device"] = cross
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


class MoeInputs:
    """Records the input of every ``moe_ffn`` call of the MoE LM (a
    pass-through around the port's call site), so the routing of a run can
    be recomputed with ``models.moe.moe_route`` and compared across
    devices."""

    def __enter__(self):
        import repro_torch.models.transformer as transformer

        self._saved = moe_ffn = transformer.moe_ffn
        self.inputs = []

        def rec(p, cfg, x, groups=1):
            self.inputs.append(x.detach().clone())
            return moe_ffn(p, cfg, x, groups)

        transformer.moe_ffn = rec
        return self

    def __exit__(self, *exc):
        import repro_torch.models.transformer as transformer

        transformer.moe_ffn = self._saved


def _routing(layers, cfg, inputs):
    """Per recorded MoE call of ``inputs`` (in layer order, call after
    call): the experts each token chose and each expert's picks with a
    nonzero gate (token index, -1 where the gate is 0), on the host."""
    import torch

    from repro_torch.models.moe import moe_route
    from repro_torch.tree import unstack

    out = []
    stack = unstack(layers)
    with torch.no_grad():
        # the i-th recorded call is layer i mod L's (prefill, then each step)
        for i, x in enumerate(inputs):
            p_l = stack[i % len(stack)]
            _, topi, w_sel, idx = moe_route(p_l["ffn"], cfg, x.reshape(1, -1, x.shape[-1]))
            out.append((topi.cpu(), torch.where(w_sel > 0, idx, -1).cpu()))
    return out


def _card_vs_cpu_generate(params, params_cpu, cfg, prompts, gen, features=None):
    """Greedy tokens and prefill logits of the same weights on the card and
    the host CPU (with ``features``, whisper's frames, on both). Returns
    (tokens identical, max |logits diff|, CPU s)."""
    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.models import get_api

    api = get_api(cfg)
    cpu = torch.device("cpu")
    features = features or {}
    host_features = {k: v.to(cpu) for k, v in features.items()}
    gpu = generate(params, cfg, prompts, gen, features)
    t0 = time.perf_counter()
    host = generate(params_cpu, cfg, prompts.to(cpu), gen, host_features)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        lg_gpu, _ = api.prefill_fn(params, cfg, {"tokens": prompts, "labels": prompts,
                                                 **features})
        lg_cpu, _ = api.prefill_fn(params_cpu, cfg, {"tokens": prompts.to(cpu),
                                                     "labels": prompts.to(cpu), **host_features})
    diff = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    return torch.equal(gpu.tokens.cpu(), host.tokens), diff, cpu_s


def _init_family(arch: str, cfg):
    """Init ``arch`` at full width and depth on the card from PRNGKey(0):
    (params, record of time, param count and memory)."""
    import torch

    from repro_torch import prng
    from repro_torch.models import get_api, param_count

    api = get_api(cfg)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = api.init_params(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params = param_count(params)
    held = torch.cuda.memory_allocated() - base
    print(f"init_params(PRNGKey(0)) on the card: {n_params} params ({cfg.n_layers} layers), "
          f"{init_s:.2f} s, {held / 2**30:.3f} GiB held, peak {init_peak / 2**30:.3f} GiB "
          f"during the init")
    return params, {"arch": arch, "params": n_params, "layers": cfg.n_layers, "init_s": init_s,
                    "init_peak_bytes": init_peak, "params_bytes": held}


def _serve_with(label: str, params, cfg, prompts, want: dict, features=None) -> dict:
    """Serve ``prompts`` (batch 8, prompt 128) for 32 greedy tokens after a
    warm-up: the launches of the run must be ``want`` per forward (32
    forwards), and so must those of one prefill and of one decode step;
    tokens in range. Returns the record."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_api

    api = get_api(cfg)
    (B, P), G = prompts.shape, SERVE_GEN
    generate(params, cfg, prompts, 2, features)                # warm-up: cuBLAS, allocator
    reset_launches()
    res = generate(params, cfg, prompts, G, features)
    launches = dict(LAUNCHES)
    if launches != {k: n * G for k, n in want.items()}:
        fail(f"{label}: serve launches {launches}, expected {want} x {G} forwards")
    per_prefill, per_decode = _hybrid_counts(api, params, cfg, prompts, res.tokens[:, :1],
                                             features)
    if per_prefill != want or per_decode != want:
        fail(f"{label}: one prefill launched {per_prefill}, one decode step {per_decode}, "
             f"expected {want} each")
    if res.tokens.shape != (B, G) or not bool(((res.tokens >= 0)
                                                & (res.tokens < cfg.vocab_size)).all()):
        fail(f"{label}: tokens {tuple(res.tokens.shape)} out of range")
    rec = {"batch": B, "prompt": P, "gen": G, "ssm_chunk": cfg.ssm_chunk,
           "prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "prefill_tok_s": B * P / res.prefill_s, "decode_tok_s": B * (G - 1) / res.decode_s,
           "launches": launches, "per_prefill": per_prefill, "per_decode_step": per_decode,
           "tokens": res.tokens}
    print(f"serve {cfg.name} batch {B} prompt {P} gen {G}: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({rec['prefill_tok_s']:.0f} tok/s), decode {res.decode_s * 1e3:.2f} ms for {G - 1} "
          f"steps ({rec['decode_tok_s']:.1f} tok/s); launches {launches}; per prefill "
          f"{per_prefill}, per decode step {per_decode}")
    return rec


def _serve_prompts(cfg):
    """The serve prompts, batch 8 of 128 tokens, from PRNGKey(0) on the card."""
    import torch

    from repro_torch import prng

    return prng.randint(prng.PRNGKey(0, device=torch.device("cuda")),
                        (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)


def _serve_family(label: str, arch: str, cfg, norms: int):
    """Init ``arch`` at full width and depth on the card from PRNGKey(0)
    (time and peak memory), then serve batch 8, prompt 128, 32 greedy
    tokens: ``norms`` rmsnorm launches per prefill and per decode step,
    none of another kernel. Returns (params, prompts, record)."""
    params, rec = _init_family(arch, cfg)
    prompts = _serve_prompts(cfg)
    served = _serve_with(label, params, cfg, prompts, {"rmsnorm": norms})
    served.pop("tokens")
    return params, prompts, {**rec, **served}


def _family_loss(label: str, params, cfg, B: int, S: int, want: dict, reps: int,
                 pallas: bool, features=None):
    """The forward loss at (B, S) on the card (with ``features``, whisper's
    frames or a vlm's image embeddings, where given; a vlm's S counts its
    image slots, so its text is S - n_img_tokens): launches of one forward
    (must equal ``want``), ms per forward and peak memory; with ``pallas``
    also the ``use_pallas=False`` loss, which must agree within 2e-4."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import image_offset
    from repro_torch.models import get_api

    api = get_api(cfg)
    run_cfg = cfg.replace(use_pallas=True) if pallas else cfg
    dev = torch.device("cuda")
    text = S - image_offset(cfg, features)
    tokens = prng.randint(prng.PRNGKey(1, device=dev), (B, text), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens, **(features or {})}
    rec = {"B": B, "S": S, "ssm_chunk": cfg.ssm_chunk}
    with torch.no_grad():
        api.loss_fn(params, run_cfg, batch)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        loss, metrics = api.loss_fn(params, run_cfg, batch)
        launches = dict(LAUNCHES)
        torch.cuda.synchronize()
        rec.update(loss=loss.item(), peak_bytes=torch.cuda.max_memory_allocated(),
                   activation_peak_bytes=torch.cuda.max_memory_allocated() - base,
                   launches=launches, ms=time_ms(lambda: api.loss_fn(params, run_cfg, batch),
                                                 reps=reps))
        if "aux" in metrics:
            rec["aux"] = float(metrics["aux"])
        if pallas:
            loss_plain, _ = api.loss_fn(params, cfg, batch)
            rec.update(loss_plain_path=loss_plain.item(),
                       ms_plain_path=time_ms(lambda: api.loss_fn(params, cfg, batch), reps=reps))
    if launches != want:
        fail(f"{label}: loss launches {launches}, expected {want}")
    if not torch.isfinite(loss):
        fail(f"{label}: loss {loss.item()}")
    line = (f"loss B={B} S={S}{' use_pallas' if pallas else ''}: {rec['loss']:.6f}, "
            f"{rec['ms']:.2f} ms per forward, peak memory {rec['peak_bytes'] / 2**30:.3f} GiB "
            f"({rec['activation_peak_bytes'] / 2**30:.3f} GiB above the weights); launches "
            f"{launches}")
    if pallas:
        rec["diff"] = abs(rec["loss"] - rec["loss_plain_path"])
        line += (f"; plain path {rec['loss_plain_path']:.6f} ({rec['ms_plain_path']:.2f} ms), "
                 f"|diff| {rec['diff']:.3g} (tol 2e-4)")
        if not rec["diff"] <= 2e-4:
            fail(f"{label}: use_pallas loss {rec['loss']} vs plain {rec['loss_plain_path']}")
    print(line)
    return rec


def phase_moe(line: str):
    """Phase 22: qwen2-moe-a2.7b at full width and depth."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_config
    from repro_torch.models import get_api, param_count
    from repro_torch.tree import tree_map

    print(f"== phase 22: {MOE_ARCH} at full width and depth on the card")
    print(f"card: {line}")
    cfg = serve_config(get_config(MOE_ARCH), SERVE_PROMPT)
    norms = 2 * cfg.n_layers + 1
    params, prompts, served = _serve_family("phase 22", MOE_ARCH, cfg, norms)
    loss = _family_loss("phase 22", params, cfg, MOE_LOSS_B, MOE_LOSS_S,
                        {"flash_attention": cfg.n_layers, "rmsnorm": norms}, reps=3, pallas=True)

    # card against CPU: the first MOE_CPU_LAYERS layers of the same weights
    L = MOE_CPU_LAYERS
    small_cfg = cfg.replace(n_layers=L)
    small = dict(params, moe_layers=tree_map(lambda t: t[:L], params["moe_layers"]))
    small_cpu = tree_map(lambda t: t.cpu(), small)
    few = prompts[:CPU_BATCH]
    same, diff, cpu_s = _card_vs_cpu_generate(small, small_cpu, small_cfg, few, CPU_GEN)
    api = get_api(small_cfg)
    with torch.no_grad():
        with MoeInputs() as on_gpu:
            api.prefill_fn(small, small_cfg, {"tokens": few, "labels": few})
        with MoeInputs() as on_cpu:
            api.prefill_fn(small_cpu, small_cfg, {"tokens": few.cpu(), "labels": few.cpu()})
    r_gpu = _routing(small["moe_layers"], small_cfg, on_gpu.inputs)
    r_cpu = _routing(small_cpu["moe_layers"], small_cfg, on_cpu.inputs)
    routing_same = len(r_gpu) == len(r_cpu) == L and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(r_gpu, r_cpu))
    picks = sum(int((r[1] >= 0).sum()) for r in r_gpu)
    print(f"{L} of {cfg.n_layers} layers ({param_count(small_cpu)} params), batch {CPU_BATCH}, "
          f"{CPU_GEN} tokens on the host CPU ({cpu_s:.2f} s): greedy tokens "
          f"identical={same}, max |prefill logits card - cpu| {diff:.3g} (tol 1e-3), routing "
          f"(top-{cfg.top_k} experts and {picks} nonzero-gate picks) identical={routing_same}")
    if not same or not diff <= 1e-3 or not routing_same:
        fail("phase 22: card and CPU disagree")
    served.update(cpu_layers=L, cpu_tokens_identical=same,
                  cpu_prefill_logits_max_abs_diff=diff, cpu_routing_identical=routing_same,
                  cpu_nonzero_picks=picks)
    del small_cpu, small, params
    torch.cuda.empty_cache()
    return served, loss


def phase_xlstm(line: str):
    """Phase 23: xlstm-1.3b at full width and depth."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_config
    from repro_torch.models import get_api, param_count
    from repro_torch.models.xlstm_lm import _layout
    from repro_torch.tree import tree_map

    print(f"== phase 23: {XLSTM_ARCH} at full width and depth on the card")
    print(f"card: {line}")
    full = get_config(XLSTM_ARCH)
    cfg = serve_config(full, SERVE_PROMPT)
    _, n_groups, _, n_tail = _layout(cfg)
    norms = 2 * cfg.n_layers + 1           # ln and gate_norm / out_norm per block, final norm
    params, prompts, served = _serve_family("phase 23", XLSTM_ARCH, cfg, norms)
    loss = _family_loss("phase 23", params, full, XLSTM_LOSS_B, XLSTM_LOSS_S,
                        {"rmsnorm": norms}, reps=1, pallas=False)
    loss["parts"] = _xlstm_parts(params, full)
    loss["norm_rounding"] = _norm_rounding(params, full, XLSTM_LOSS_B, XLSTM_LOSS_S, loss["loss"])

    # card against CPU: the first group (XLSTM_CPU_LAYERS layers: 7 mLSTM,
    # 1 sLSTM) of the same weights
    L = XLSTM_CPU_LAYERS
    small_cfg = cfg.replace(n_layers=L)
    _, g, mpg, tail = _layout(small_cfg)
    small = dict(params, mlstm_layers=tree_map(lambda t: t[:g * mpg + tail],
                                               params["mlstm_layers"]),
                 slstm_layers=tree_map(lambda t: t[:g], params["slstm_layers"]))
    small_cpu = tree_map(lambda t: t.cpu(), small)
    few = prompts[:CPU_BATCH]
    same, diff, cpu_s = _card_vs_cpu_generate(small, small_cpu, small_cfg, few, CPU_GEN)
    api = get_api(small_cfg)
    toks = prng.randint(prng.PRNGKey(2), (1, XLSTM_CPU_LOSS_S), 0, cfg.vocab_size)
    with torch.no_grad():
        l_gpu, _ = api.loss_fn(small, small_cfg, {"tokens": toks.cuda(), "labels": toks.cuda()})
        l_cpu, _ = api.loss_fn(small_cpu, small_cfg, {"tokens": toks, "labels": toks})
    loss_diff = abs(l_gpu.item() - l_cpu.item())
    print(f"{L} of {cfg.n_layers} layers ({g * mpg + tail} mLSTM, {g} sLSTM; "
          f"{param_count(small_cpu)} params), batch {CPU_BATCH}, {CPU_GEN} tokens on the host "
          f"CPU ({cpu_s:.2f} s): greedy tokens identical={same}, max |prefill logits card - cpu| "
          f"{diff:.3g} (tol 1e-3); loss B=1 S={XLSTM_CPU_LOSS_S}: card {l_gpu.item():.6f}, CPU "
          f"{l_cpu.item():.6f}, |diff| {loss_diff:.3g} (tol 1e-4)")
    if not same or not diff <= 1e-3 or not loss_diff <= 1e-4:
        fail("phase 23: card and CPU disagree")
    served.update(groups=n_groups, tail=n_tail, cpu_layers=L, cpu_tokens_identical=same,
                  cpu_prefill_logits_max_abs_diff=diff, cpu_loss_diff=loss_diff)
    del small_cpu, small, params
    torch.cuda.empty_cache()
    return served, loss


def _norm_rounding(params, cfg, B: int, S: int, kernel_loss: float) -> dict:
    """The loss at (B, S) with every RMSNorm taken by its plain version, and
    by the plain version with each output moved one f32 ulp toward +inf:
    how far the full-depth loss moves with the norms' rounding alone,
    beside the kernel's ``kernel_loss`` (mLSTM divides by a normaliser
    that can cancel). A record, not a gate."""
    import torch

    import repro_torch.models.layers as layers
    from repro_torch import prng
    from repro_torch.kernels.ref import ref_rmsnorm
    from repro_torch.models import get_api

    def ulp_up(x, w, eps=1e-6):
        y = ref_rmsnorm(x, w, eps)
        return torch.nextafter(y, torch.full_like(y, float("inf")))

    api = get_api(cfg)
    tokens = prng.randint(prng.PRNGKey(1, device=torch.device("cuda")), (B, S), 0,
                          cfg.vocab_size)
    kernel, rec = layers.rmsnorm, {"kernel": kernel_loss}
    try:
        for name, norm in (("plain", ref_rmsnorm), ("plain_ulp_up", ulp_up)):
            layers.rmsnorm = norm
            with torch.no_grad():
                rec[name] = api.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})[0].item()
    finally:
        layers.rmsnorm = kernel
    print(f"loss B={B} S={S} by the norms' rounding: kernel {kernel_loss:.6f}, plain "
          f"{rec['plain']:.6f}, plain one ulp up {rec['plain_ulp_up']:.6f}")
    return rec


def _xlstm_parts(params, cfg) -> dict:
    """Time, at the xlstm loss's shape (B=1, S=2048, chunk 256), its two
    sequence mixers alone, one layer each: mLSTM's plain ``ssd_chunked``
    (G = H = 4 groups of one head, N = dk = 1024, P = dk + 1 = 1025; the
    shape the ``ssd_scan`` kernel cannot take) on seeded inputs, and one
    sLSTM layer's forward (its Python loop over the sequence) on the model's
    first sLSTM weights."""
    import torch

    from repro_torch.models import ssm, xlstm
    from repro_torch.models.xlstm_lm import _layout
    from repro_torch.tree import tree_map

    B, L = XLSTM_LOSS_B, XLSTM_LOSS_S
    _, H, dk = xlstm._mdims(cfg)
    _, n_groups, mpg, tail = _layout(cfg)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(B, L, H, 1, dk + 1, generator=gen, device=dev)
    a = torch.rand(B, L, H, 1, generator=gen, device=dev).mul_(-0.1)
    k = torch.randn(B, L, H, dk, generator=gen, device=dev).mul_(dk ** -0.5)
    q = torch.randn(B, L, H, dk, generator=gen, device=dev)
    u = torch.randn(B, L, cfg.d_model, generator=gen, device=dev)
    p_s = tree_map(lambda t: t[0], params["slstm_layers"]["cell"])
    with torch.no_grad():
        rec = {"mlstm_scan_ms": time_ms(lambda: ssm.ssd_chunked(x, a, k, q, cfg.ssm_chunk),
                                        reps=3),
               "mlstm_layers": n_groups * mpg + tail,
               "slstm_layer_ms": time_ms(lambda: xlstm.slstm_forward(p_s, cfg, u), reps=1),
               "slstm_layers": n_groups}
    print(f"the loss's mixers alone, one layer each: mLSTM ssd_chunked at (B={B}, L={L}, "
          f"G={H}, N={dk}, P={dk + 1}, chunk {cfg.ssm_chunk}) {rec['mlstm_scan_ms']:.2f} ms "
          f"(x {rec['mlstm_layers']} layers), one sLSTM layer's forward "
          f"{rec['slstm_layer_ms']:.2f} ms (x {rec['slstm_layers']} layers)")
    del x, a, k, q, u
    return rec


class DepthCut:
    """Builds the named archs of the ``arch`` family at fewer layers (their
    widths unchanged): a pass-through around ``launch.train.get_config``.
    Layer i of a cut model is layer i of the full one (a key split is
    positional), so the cut is the first layers of the same model."""

    def __init__(self, layers: dict):
        self.layers = layers

    def __enter__(self):
        import repro_torch.launch.train as train

        self._saved = get_config = train.get_config

        def cut(name):
            cfg = get_config(name)
            return cfg.replace(n_layers=self.layers[name]) if name in self.layers else cfg

        train.get_config = cut
        return self

    def __exit__(self, *exc):
        import repro_torch.launch.train as train

        train.get_config = self._saved


class TaskClock:
    """Seconds and rounds of each task's share of a sync arch run: a
    pass-through around ``ArchSyncEngine._run_task_round`` that
    synchronises the card before and after each call (less the seconds of
    ``FoldShapes``' checks)."""

    def __enter__(self):
        import collections

        import torch

        from repro_torch.api import engine

        self.seconds, self.rounds = collections.Counter(), collections.Counter()
        self._saved = run = engine.ArchSyncEngine._run_task_round

        def timed(eng, name, *args, **kw):
            torch.cuda.synchronize()
            t0, held = time.perf_counter(), FoldShapes.held_s
            out = run(eng, name, *args, **kw)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0 - (FoldShapes.held_s - held)
            self.rounds[name] += 1
            return out

        engine.ArchSyncEngine._run_task_round = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.api import engine

        engine.ArchSyncEngine._run_task_round = self._saved


def _adamw_step(label: str, arch: str, layers: int, B: int, S: int) -> dict:
    """Two fused AdamW steps of ``arch`` at full width and ``layers``
    layers, from ``build_task``'s seed, on (B, S) tokens (the SSM chunk cut
    to a quarter of S, at least 8, as ``build_task`` cuts it): time of
    each, peak memory, losses."""
    import zlib

    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.train import arch_fused_step, server_opt
    from repro_torch.models import get_api, param_count

    cfg = get_config(arch).replace(n_layers=layers)
    cfg = cfg.replace(ssm_chunk=min(cfg.ssm_chunk, max(8, S // 4)))
    api = get_api(cfg)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(prng.PRNGKey(zlib.crc32(arch.encode()) % 2**31, device=dev), cfg,
                             device=dev)
    opt = server_opt().init(params)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": toks, "labels": toks, "client_weights": torch.ones(B, device=dev)}
    step, _ = arch_fused_step(api, cfg)
    times, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        fail(f"{label}: {arch} step losses {losses}")
    rec = {"layers": layers, "batch": B, "seq": S, "ssm_chunk": cfg.ssm_chunk,
           "params": param_count(params), "step_s": times, "losses": losses, "peak_bytes": peak}
    print(f"{arch} full width, {layers} of {get_config(arch).n_layers} layers, one "
          f"arch_fused_step at B={B} S={S}: {times[1]:.3f} s (first {times[0]:.3f} s), losses "
          f"{losses}, peak {peak / 2**30:.3f} GiB, {rec['params']} params")
    del params, opt, batch
    torch.cuda.empty_cache()
    return rec


def phase_families_train(line: str):
    """Phase 24: LM training on the example's three-task mix."""
    import numpy as np
    import torch

    from repro_torch.models import param_count

    print("== phase 24: sync arch training of the example's mix on the card (run_scenario, "
          "vmap backend)")
    print(f"card: {line}")
    torch.cuda.empty_cache()
    tasks = FAMILIES_SYNC["tasks"]
    spec = arch_spec("arch-families", tasks, FAMILIES_SYNC["clients"])
    with DepthCut(FAMILIES_SYNC["layers"]), FoldShapes() as shapes, TaskClock() as clock:
        shapes.reset_peak()
        res, launches = run_counted(spec, "cuda")
    peak = shapes.peak_bytes()
    names = res.task_names
    folded = [s for s, t in enumerate(spec.tasks) if t.options["tau"] > 1]
    folds = int((res.alloc_counts[:, folded] > 0).sum())
    n = {a: param_count(p) for a, p in zip(names, res.params)}
    want_shapes = {(tasks[names[s]]["batch"], n[names[s]], "float32"):
                   int((res.alloc_counts[:, s] > 0).sum()) for s in folded}
    want_shapes = {k: v for k, v in want_shapes.items() if v}
    if not folds or launches.get("fedavg", 0) != folds or dict(shapes.fedavg) != want_shapes:
        fail(f"phase 24: fedavg launched {launches.get('fedavg', 0)} times at "
             f"{dict(shapes.fedavg)} for {folds} non-empty tau>1 folds {want_shapes}")
    if set(launches) - {"fedavg", "rmsnorm"} or launches.get("rmsnorm", 0) <= 0:
        fail(f"phase 24: launches {launches}")
    trained = np.cumsum(res.alloc_counts > 0, axis=0) > 0
    if not (trained[-1].all() and np.isfinite(res.loss[trained]).all()
            and np.isfinite(res.acc).all()):
        fail(f"phase 24: loss {res.loss} or accuracy {res.acc} not finite, or a task never "
             f"trained ({res.alloc_counts.tolist()})")
    per_task = {}
    for s, t in enumerate(spec.tasks):
        o = t.options
        tok = int((res.alloc_counts[:, s] > 0).sum()) * o["batch"] * o["seq"] * o["tau"]
        per_task[t.name] = {
            "layers": FAMILIES_SYNC["layers"].get(t.name), "tau": o["tau"], "params": n[t.name],
            "rounds_trained": clock.rounds[t.name], "seconds": clock.seconds[t.name],
            "s_per_round": clock.seconds[t.name] / max(clock.rounds[t.name], 1),
            "trained_tokens": tok,
            "trained_tokens_per_s": tok / clock.seconds[t.name] if clock.seconds[t.name] else 0.0,
            "final_loss": res.final_loss[t.name], "final_acc": float(res.acc[-1, s])}
    with DepthCut(FAMILIES_SYNC["layers"]):
        per_step = {t.name: norms_per_step(t, p) for t, p in zip(spec.tasks, res.params)}
    for a, count in per_step.items():
        per_task[a]["rmsnorm_per_training_step"] = count
    tokens = _trained_tokens(spec, res)
    rec = {"s_per_round": res.wall_time / spec.runtime.rounds,
           "trained_tokens_per_s": tokens / res.wall_time, "wall_s": res.wall_time,
           "peak_bytes": peak, "alloc_counts": res.alloc_counts.tolist(), "launches": launches,
           "fedavg_folds": folds, "tasks": per_task}
    print(f"arch sync {names} (depths {FAMILIES_SYNC['layers']}): {rec['s_per_round']:.3f} "
          f"s/round, {rec['trained_tokens_per_s']:.1f} trained tokens/s ({tokens} tokens in "
          f"{res.wall_time:.3f} s), peak {peak / 2**30:.3f} GiB; launches {launches}, fedavg = "
          f"non-empty tau>1 folds {folds} at {dict(shapes.fedavg)}")
    for a, r in per_task.items():
        print(f"  {a}: {r['s_per_round']:.3f} s/round over {r['rounds_trained']} rounds, "
              f"{r['trained_tokens_per_s']:.1f} trained tokens/s, final loss "
              f"{r['final_loss']:.4f}, final acc {r['final_acc']:.4f}, rmsnorm launches per "
              f"training step {r['rmsnorm_per_training_step']}")
    checked = check_run_shapes("phase 24", shapes)
    if checked["fedavg_calls_held"] != folds:
        fail(f"phase 24: {checked['fedavg_calls_held']} fedavg calls held for {folds} folds")
    del res
    timed = time_lm_shapes(shapes)

    steps = {a: _adamw_step("phase 24", a, *shape) for a, shape in FAMILIES_STEP.items()}

    # the tiny mix on the card, its folds and flushes recorded (and each
    # fedavg call held) at the shapes these runs give the kernels
    tiny = arch_spec("families-tiny", {a: FAMILIES_TINY["options"] for a in FAMILIES_TINY["archs"]},
                     FAMILIES_TINY["clients"], strategy="round_robin",
                     rounds=FAMILIES_TINY["rounds"])
    tiny_async = arch_spec("families-tiny-async",
                           {a: FAMILIES_TINY["options"] for a in FAMILIES_TINY["archs"]},
                           FAMILIES_TINY["clients"], mode="async", strategy="round_robin",
                           arrivals=FAMILIES_TINY["arrivals"], buffer=FAMILIES_TINY["buffer"],
                           aggregator="fedadam", options=ARCH_ASYNC["options"])
    with FoldShapes() as tiny_shapes:
        gpu, tlaunch = run_counted(tiny, "cuda")
        agpu, alaunch = run_counted(tiny_async, "cuda")
    tfolds, flushes = int((gpu.alloc_counts > 0).sum()), len(agpu.time)
    if (tlaunch.get("fedavg", 0) != tfolds or sum(tiny_shapes.fedavg.values()) != tfolds
            or alaunch.get("fedavg", 0) or sum(tiny_shapes.fused.values()) != flushes):
        fail(f"phase 24: tiny runs' launches {tlaunch} / {alaunch} and shapes "
             f"{dict(tiny_shapes.fedavg)} / {dict(tiny_shapes.fused)} for {tfolds} tau 2 folds "
             f"and {flushes} flushes")
    cpu, _ = run_counted(tiny, "cpu")
    same = np.array_equal(gpu.alloc, cpu.alloc)
    gap = _loss_gap(gpu, cpu)
    print(f"tiny {list(FAMILIES_TINY['archs'])} round_robin tau 2 card vs CPU: allocation traces "
          f"identical={same}, max |loss card - loss cpu| {gap:.3g}, accuracy curves identical="
          f"{np.array_equal(gpu.acc, cpu.acc)}; fedavg {tlaunch.get('fedavg', 0)} launches for "
          f"{tfolds} non-empty folds")
    if not same or not gap <= 1e-3:
        fail("phase 24: tiny arch sync card vs CPU disagree")
    acpu, _ = run_counted(tiny_async, "cpu")
    asame = _same_events(agpu, acpu)
    agap = _loss_gap(agpu, acpu)
    print(f"tiny async fedadam round_robin card vs CPU: event traces identical={asame}, max "
          f"|eval loss card - cpu| {agap:.3g}; fused_aggregate {alaunch.get('fused_aggregate', 0)} "
          f"launches for {flushes} flushes")
    if not asame or not agap <= 1e-3 or alaunch.get("fused_aggregate", 0) != flushes:
        fail("phase 24: tiny arch async card vs CPU disagree, or fused_aggregate did not run "
             "once per flush")
    tiny_checked = check_run_shapes("phase 24 tiny", tiny_shapes)
    return ({**rec, "adamw_steps": steps, "card_vs_cpu_loss_gap": gap,
             "card_vs_cpu_async_loss_gap": agap, "tiny_sync_folds": tfolds,
             "tiny_sync_launches": tlaunch, "tiny_async_flushes": flushes,
             "tiny_async_launches": alaunch}, checked, tiny_checked, timed)


def _decode_logits(params, cfg, prompts, tokens) -> list:
    """Logits (host) of prefill over ``prompts`` and of a decode step for
    each of ``tokens``' columns after the first, fed in turn (the same
    inputs whatever ``cfg.mla_absorb``)."""
    import torch

    from repro_torch.models import get_api, pad_cache

    api = get_api(cfg)
    P, G = prompts.shape[1], tokens.shape[1]
    with torch.no_grad():
        logits, caches = api.prefill_fn(params, cfg, {"tokens": prompts, "labels": prompts})
        caches = pad_cache(caches, P, P + G)
        out = [logits.cpu()]
        for i in range(G - 1):
            logits, caches = api.decode_fn(params, cfg, tokens[:, i:i + 1], P + i, caches)
            out.append(logits.cpu())
    return out


def phase_mla(line: str):
    """Phase 25: deepseek-v2-lite-16b at full width and depth."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models import param_count
    from repro_torch.tree import tree_map

    print(f"== phase 25: {MLA_ARCH} (MLA) at full width and depth on the card")
    print(f"card: {line}")
    cfg = serve_config(get_config(MLA_ARCH), SERVE_PROMPT)
    # ln1, ln2 and the latent's kv_norm in every layer, and the final norm
    norms = 3 * cfg.n_layers + 1
    params, rec = _init_family(MLA_ARCH, cfg)
    print(f"  init peak {rec['init_peak_bytes'] / 2**30:.3f} GiB against the predicted "
          f"{MLA_INIT_PEAK_GIB} GiB; {rec['params']} params (expected {MLA_PARAMS})")
    if rec["params"] != MLA_PARAMS:
        fail(f"phase 25: {rec['params']} params, expected {MLA_PARAMS}")
    prompts = _serve_prompts(cfg)
    served = {}
    for absorb in (False, True):
        run_cfg = cfg.replace(mla_absorb=absorb)
        served[absorb] = _serve_with(f"phase 25 absorb={absorb}", params, run_cfg, prompts,
                                     {"rmsnorm": norms})
    toks = served[False].pop("tokens")
    served[True].pop("tokens")
    expand = _decode_logits(params, cfg, prompts, toks)
    absorbed = _decode_logits(params, cfg.replace(mla_absorb=True), prompts, toks)
    settings_diff = max((a - b).abs().max().item() for a, b in zip(expand, absorbed))
    print(f"  decode logits with the latent expanded and absorbed, the same {toks.shape[1]} "
          f"forwards: max |diff| {settings_diff:.3g} (tol 2e-3)")
    if not settings_diff <= 2e-3:
        fail(f"phase 25: absorbed and expanded decode logits differ by {settings_diff}")
    loss = _family_loss("phase 25", params, cfg, MLA_LOSS_B, MLA_LOSS_S, {"rmsnorm": norms},
                        reps=3, pallas=True)
    loss["parts"] = _mla_parts(params, cfg)

    # card against CPU: the dense first layer and one MoE layer
    L = MLA_CPU_LAYERS
    small_cfg = cfg.replace(n_layers=L)
    small = dict(params, moe_layers=tree_map(lambda t: t[:L - cfg.first_dense_layers],
                                             params["moe_layers"]))
    small_cpu = tree_map(lambda t: t.cpu(), small)
    few = prompts[:CPU_BATCH]
    cpu = {}
    for absorb in (False, True):
        c = small_cfg.replace(mla_absorb=absorb)
        same, diff, cpu_s = _card_vs_cpu_generate(small, small_cpu, c, few, CPU_GEN)
        # each device's routing, recomputed from its own MoE inputs of a
        # whole generate (prefill and every decode step)
        with MoeInputs() as on_gpu:
            generate(small, c, few, CPU_GEN)
        with MoeInputs() as on_cpu:
            generate(small_cpu, c, few.cpu(), CPU_GEN)
        r_gpu = _routing(small["moe_layers"], c, on_gpu.inputs)
        r_cpu = _routing(small_cpu["moe_layers"], c, on_cpu.inputs)
        routing_same = len(r_gpu) == len(r_cpu) > 0 and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(r_gpu, r_cpu))
        print(f"  {L} of {cfg.n_layers} layers ({param_count(small_cpu)} params), absorb={absorb}, "
              f"batch {CPU_BATCH}, {CPU_GEN} tokens on the host CPU ({cpu_s:.2f} s): greedy "
              f"tokens identical={same}, max |prefill logits card - cpu| {diff:.3g} (tol "
              f"1e-3), routing of {len(r_gpu)} MoE calls identical={routing_same}")
        if not same or not diff <= 1e-3 or not routing_same:
            fail(f"phase 25: card and CPU disagree (absorb={absorb})")
        cpu[absorb] = {"tokens_identical": same, "prefill_logits_max_abs_diff": diff,
                       "routing_identical": routing_same, "moe_calls": len(r_gpu)}
    del small_cpu, small, params
    torch.cuda.empty_cache()
    out = {**rec, "serve_expand": served[False], "serve_absorb": served[True],
           "absorb_vs_expand_logits_max_abs_diff": settings_diff, "cpu_layers": L,
           "cpu_expand": cpu[False], "cpu_absorb": cpu[True]}
    return out, loss


def _mla_parts(params, cfg) -> dict:
    """Time, at the MLA loss's shape (B=1, S=2048), one layer's parts alone
    on the model's weights and seeded activations: the MLA attention
    (projections, the latent's norm and expansion, the chunked attention)
    of the first MoE layer, and that layer's MoE FFN (router, expert and
    shared-expert products, combine)."""
    import torch

    from repro_torch.models import attention, moe
    from repro_torch.tree import tree_map

    B, S = MLA_LOSS_B, MLA_LOSS_S
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    h = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    p_l = tree_map(lambda t: t[0], params["moe_layers"])
    with torch.no_grad():
        rec = {"mla_attention_ms": time_ms(lambda: attention.mla_train(p_l["attn"], cfg, h, pos),
                                           reps=5),
               "moe_ffn_ms": time_ms(lambda: moe.moe_ffn(p_l["ffn"], cfg, h), reps=5),
               "moe_layers": cfg.n_layers - cfg.first_dense_layers, "layers": cfg.n_layers}
    print(f"  one layer's parts alone at B={B} S={S}: MLA attention {rec['mla_attention_ms']:.2f} "
          f"ms (x {rec['layers']} layers), MoE FFN {rec['moe_ffn_ms']:.2f} ms (x "
          f"{rec['moe_layers']} layers)")
    del h
    return rec


def phase_audio(line: str):
    """Phase 26: whisper-medium at full size."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_features
    from repro_torch.models import param_count
    from repro_torch.tree import tree_map

    print(f"== phase 26: {AUDIO_ARCH} (encoder-decoder) at full size on the card")
    print(f"card: {line}")
    cfg = get_config(AUDIO_ARCH)
    params, rec = _init_family(AUDIO_ARCH, cfg)
    dev = torch.device("cuda")
    # the serve launcher's frames and prompts, both from its key
    key = prng.PRNGKey(0, device=dev)
    features = serve_features(key, cfg, SERVE_BATCH)
    prompts = _serve_prompts(cfg)
    served = _serve_with("phase 26", params, cfg, prompts, {}, features)
    served.pop("tokens")
    served["frames"] = list(features["frames"].shape)
    frames = serve_features(prng.PRNGKey(1, device=dev), cfg, AUDIO_LOSS_B)
    loss = _family_loss("phase 26", params, cfg, AUDIO_LOSS_B, AUDIO_LOSS_S, {}, reps=3,
                        pallas=False, features=frames)
    loss["frames"] = list(frames["frames"].shape)

    # card against CPU: the first encoder and decoder layers, batch 2
    L = AUDIO_CPU_LAYERS
    small_cfg = cfg.replace(n_layers=L, n_enc_layers=L)
    small = dict(params, enc_layers=tree_map(lambda t: t[:L], params["enc_layers"]),
                 dec_layers=tree_map(lambda t: t[:L], params["dec_layers"]))
    small_cpu = tree_map(lambda t: t.cpu(), small)
    few = {"frames": features["frames"][:CPU_BATCH]}
    same, diff, cpu_s = _card_vs_cpu_generate(small, small_cpu, small_cfg, prompts[:CPU_BATCH],
                                              CPU_GEN, few)
    print(f"  {L} encoder and {L} decoder layers ({param_count(small_cpu)} params), batch "
          f"{CPU_BATCH}, {CPU_GEN} tokens on the host CPU ({cpu_s:.2f} s): greedy tokens "
          f"identical={same}, max |prefill logits card - cpu| {diff:.3g} (tol 1e-3)")
    if not same or not diff <= 1e-3:
        fail("phase 26: card and CPU disagree")
    del small_cpu, small, params
    torch.cuda.empty_cache()
    return ({**rec, **served, "cpu_layers": L, "cpu_tokens_identical": same,
             "cpu_prefill_logits_max_abs_diff": diff}, loss)


def phase_mla_audio_train(line: str):
    """Phase 27: deepseek-v2-lite and whisper-medium in training."""
    import numpy as np
    import torch

    from repro_torch.models import param_count

    print("== phase 27: arch training of deepseek-v2-lite and whisper-medium on the card "
          "(run_scenario, vmap backend)")
    print(f"card: {line}")
    torch.cuda.empty_cache()
    tasks = MLA_AUDIO_SYNC["tasks"]
    spec = arch_spec("arch-mla-audio", tasks, MLA_AUDIO_SYNC["clients"])
    with DepthCut(MLA_AUDIO_SYNC["layers"]), FoldShapes() as shapes, TaskClock() as clock:
        shapes.reset_peak()
        res, launches = run_counted(spec, "cuda")
    peak = shapes.peak_bytes()
    names = res.task_names
    folded = [s for s, t in enumerate(spec.tasks) if t.options["tau"] > 1]
    folds = int((res.alloc_counts[:, folded] > 0).sum())
    n = {a: param_count(p) for a, p in zip(names, res.params)}
    want_shapes = {(tasks[names[s]]["batch"], n[names[s]], "float32"):
                   int((res.alloc_counts[:, s] > 0).sum()) for s in folded}
    want_shapes = {k: v for k, v in want_shapes.items() if v}
    if not folds or launches.get("fedavg", 0) != folds or dict(shapes.fedavg) != want_shapes:
        fail(f"phase 27: fedavg launched {launches.get('fedavg', 0)} times at "
             f"{dict(shapes.fedavg)} for {folds} non-empty tau>1 folds {want_shapes}")
    if set(launches) - {"fedavg", "rmsnorm"} or launches.get("rmsnorm", 0) <= 0:
        fail(f"phase 27: launches {launches}")
    trained = np.cumsum(res.alloc_counts > 0, axis=0) > 0
    if not (trained[-1].all() and np.isfinite(res.loss[trained]).all()
            and np.isfinite(res.acc).all()):
        fail(f"phase 27: loss {res.loss} or accuracy {res.acc} not finite, or a task never "
             f"trained ({res.alloc_counts.tolist()})")
    per_task = {}
    for s, t in enumerate(spec.tasks):
        o = t.options
        tok = int((res.alloc_counts[:, s] > 0).sum()) * o["batch"] * o["seq"] * o["tau"]
        sec = clock.seconds[t.name]
        per_task[t.name] = {
            "layers": MLA_AUDIO_SYNC["layers"].get(t.name), "tau": o["tau"], "params": n[t.name],
            "rounds_trained": clock.rounds[t.name], "seconds": sec,
            "s_per_round": sec / max(clock.rounds[t.name], 1), "trained_tokens": tok,
            "trained_tokens_per_s": tok / sec if sec else 0.0,
            "final_loss": res.final_loss[t.name], "final_acc": float(res.acc[-1, s])}
    with DepthCut(MLA_AUDIO_SYNC["layers"]):
        per_step = {t.name: norms_per_step(t, p) for t, p in zip(spec.tasks, res.params)}
    for a, count in per_step.items():
        per_task[a]["rmsnorm_per_training_step"] = count
    tokens = _trained_tokens(spec, res)
    rec = {"s_per_round": res.wall_time / spec.runtime.rounds,
           "trained_tokens_per_s": tokens / res.wall_time, "wall_s": res.wall_time,
           "peak_bytes": peak, "alloc_counts": res.alloc_counts.tolist(), "launches": launches,
           "fedavg_folds": folds, "tasks": per_task}
    print(f"arch sync {names} (depths {MLA_AUDIO_SYNC['layers']}): {rec['s_per_round']:.3f} "
          f"s/round, {rec['trained_tokens_per_s']:.1f} trained tokens/s ({tokens} tokens in "
          f"{res.wall_time:.3f} s), peak {peak / 2**30:.3f} GiB; launches {launches}, fedavg = "
          f"non-empty tau>1 folds {folds} at {dict(shapes.fedavg)}")
    for a, r in per_task.items():
        print(f"  {a}: {r['s_per_round']:.3f} s/round over {r['rounds_trained']} rounds, "
              f"{r['trained_tokens_per_s']:.1f} trained tokens/s, final loss "
              f"{r['final_loss']:.4f}, final acc {r['final_acc']:.4f}, rmsnorm launches per "
              f"training step {r['rmsnorm_per_training_step']}")
    checked = check_run_shapes("phase 27", shapes)
    if checked["fedavg_calls_held"] != folds:
        fail(f"phase 27: {checked['fedavg_calls_held']} fedavg calls held for {folds} folds")
    del res
    torch.cuda.empty_cache()
    timed = time_lm_shapes(shapes)

    # async: whisper alone at tau 2 under fedadam, AUDIO_ASYNC_BUFFER a flush
    torch.cuda.empty_cache()
    aspec = arch_spec("arch-audio-async", {AUDIO_ARCH: dict(tasks[AUDIO_ARCH],
                                                            tau=ARCH_ASYNC["tau"])},
                      MLA_AUDIO_SYNC["clients"], mode="async", buffer=AUDIO_ASYNC_BUFFER,
                      aggregator=ARCH_ASYNC["aggregator"], options=ARCH_ASYNC["options"])
    with FoldShapes() as ashapes:
        ashapes.reset_peak()
        ares, alaunch = run_counted(aspec, "cuda")
    apeak = ashapes.peak_bytes()
    flushes = len(ares.time)
    an = param_count(ares.params[0])
    if (flushes == 0 or alaunch != {"fused_aggregate": flushes}
            or dict(ashapes.fused) != {(AUDIO_ASYNC_BUFFER, an, "fedadam"): flushes}):
        fail(f"phase 27: async launches {alaunch} at {dict(ashapes.fused)} for {flushes} "
             f"flushes")
    if not (np.isfinite(ares.loss).all() and np.isfinite(ares.acc).all()):
        fail(f"phase 27: async metric {ares.loss} or accuracy {ares.acc} not finite")
    arec = {"flushes": flushes, "flushes_per_s": flushes / ares.wall_time,
            "wall_s": ares.wall_time, "peak_bytes": apeak, "buffer": AUDIO_ASYNC_BUFFER,
            "params": an, "launches": alaunch, "acc_eval": ares.acc.tolist(),
            "metric": ares.loss.tolist()}
    print(f"arch async {ares.task_names} buffer {AUDIO_ASYNC_BUFFER}: "
          f"{arec['flushes_per_s']:.3f} flushes/s ({flushes} flushes of "
          f"{aspec.runtime.total_arrivals} arrivals, {ares.wall_time:.3f} s), peak "
          f"{apeak / 2**30:.3f} GiB, launches {alaunch}")
    achecked = check_run_shapes("phase 27 async", ashapes)
    del ares
    torch.cuda.empty_cache()
    atimed = time_lm_shapes(ashapes)

    # the tiny presets on the card and the CPU, sync and async
    opts = MLA_AUDIO_TINY["options"]
    tiny = arch_spec("mla-audio-tiny", {a: opts for a in MLA_AUDIO_TINY["archs"]},
                     MLA_AUDIO_TINY["clients"], strategy="round_robin",
                     rounds=MLA_AUDIO_TINY["rounds"])
    tiny_async = arch_spec("mla-audio-tiny-async", {a: opts for a in MLA_AUDIO_TINY["archs"]},
                           MLA_AUDIO_TINY["clients"], mode="async", strategy="round_robin",
                           arrivals=MLA_AUDIO_TINY["arrivals"], buffer=MLA_AUDIO_TINY["buffer"],
                           aggregator="fedadam", options=ARCH_ASYNC["options"])
    with FoldShapes() as tiny_shapes:
        gpu, tlaunch = run_counted(tiny, "cuda")
        agpu, talaunch = run_counted(tiny_async, "cuda")
    tfolds, tflushes = int((gpu.alloc_counts > 0).sum()), len(agpu.time)
    if (tlaunch.get("fedavg", 0) != tfolds or sum(tiny_shapes.fedavg.values()) != tfolds
            or talaunch.get("fedavg", 0) or sum(tiny_shapes.fused.values()) != tflushes
            or talaunch.get("fused_aggregate", 0) != tflushes):
        fail(f"phase 27: tiny runs' launches {tlaunch} / {talaunch} and shapes "
             f"{dict(tiny_shapes.fedavg)} / {dict(tiny_shapes.fused)} for {tfolds} folds and "
             f"{tflushes} flushes")
    cpu, _ = run_counted(tiny, "cpu")
    acpu, _ = run_counted(tiny_async, "cpu")
    same, gap = np.array_equal(gpu.alloc, cpu.alloc), _loss_gap(gpu, cpu)
    asame, agap = _same_events(agpu, acpu), _loss_gap(agpu, acpu)
    print(f"tiny {list(MLA_AUDIO_TINY['archs'])} card vs CPU: sync round_robin tau 2 allocation "
          f"traces identical={same}, max |loss card - cpu| {gap:.3g}, fedavg "
          f"{tlaunch.get('fedavg', 0)} launches for {tfolds} folds; async fedadam event traces "
          f"identical={asame}, max |eval loss card - cpu| {agap:.3g}, fused_aggregate "
          f"{talaunch.get('fused_aggregate', 0)} launches for {tflushes} flushes")
    if not same or not gap <= 1e-3 or not asame or not agap <= 1e-3:
        fail("phase 27: tiny deepseek-v2-lite and whisper card vs CPU disagree")
    tiny_checked = check_run_shapes("phase 27 tiny", tiny_shapes)
    return ({**rec, "async": arec, "card_vs_cpu_loss_gap": gap,
             "card_vs_cpu_async_loss_gap": agap, "tiny_sync_launches": tlaunch,
             "tiny_async_launches": talaunch},
            {k: max(checked[k], achecked[k], tiny_checked[k]) for k in
             ("fedavg", "fused_aggregate")}
            | {"fedavg_shapes": checked["fedavg_shapes"] + tiny_checked["fedavg_shapes"],
               "fused_shapes": achecked["fused_shapes"] + tiny_checked["fused_shapes"]},
            timed + atimed)


def _vlm_features(cfg, B: int, seed: int):
    """Image embeddings ``0.02 * normal`` (B, n_img_tokens, d_model) on the
    card from PRNGKey(seed)."""
    import torch

    from repro_torch import prng

    key = prng.PRNGKey(seed, device=torch.device("cuda"))
    return {"img_embeds": prng.normal(key, (B, cfg.n_img_tokens, cfg.d_model)).mul_(0.02)}


def phase_vlm(line: str):
    """Phase 28: phi-3-vision-4.2b at full width and depth."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_config, serve_features
    from repro_torch.models import param_count
    from repro_torch.tree import tree_map

    print(f"== phase 28: {VLM_ARCH} (vlm) at full width and depth on the card")
    print(f"card: {line}")
    cfg = serve_config(get_config(VLM_ARCH), SERVE_PROMPT)
    norms = 2 * cfg.n_layers + 1
    params, rec = _init_family(VLM_ARCH, cfg)
    if rec["params"] != VLM_PARAMS:
        fail(f"phase 28: {rec['params']} params, expected {VLM_PARAMS}")
    # the serve launcher's zero image embeddings, then the prompts
    features = serve_features(prng.PRNGKey(0, device=torch.device("cuda")), cfg, SERVE_BATCH)
    prompts = _serve_prompts(cfg)
    served = _serve_with("phase 28", params, cfg, prompts, {"rmsnorm": norms}, features)
    served.pop("tokens")
    served["img_embeds"] = list(features["img_embeds"].shape)
    loss = _family_loss("phase 28", params, cfg, VLM_LOSS_B, VLM_LOSS_S,
                        {"flash_attention": cfg.n_layers, "rmsnorm": norms}, reps=3, pallas=True,
                        features=_vlm_features(cfg, VLM_LOSS_B, 1))
    loss["text_tokens"] = VLM_LOSS_S - cfg.n_img_tokens

    # card against CPU: the first VLM_CPU_LAYERS layers, the image included
    L = VLM_CPU_LAYERS
    small_cfg = cfg.replace(n_layers=L)
    small = dict(params, dense_layers=tree_map(lambda t: t[:L], params["dense_layers"]))
    small_cpu = tree_map(lambda t: t.cpu(), small)
    few = _vlm_features(cfg, CPU_BATCH, 2)
    same, diff, cpu_s = _card_vs_cpu_generate(small, small_cpu, small_cfg, prompts[:CPU_BATCH],
                                              CPU_GEN, few)
    print(f"  {L} of {cfg.n_layers} layers ({param_count(small_cpu)} params), batch {CPU_BATCH} "
          f"behind {cfg.n_img_tokens} image embeddings, {CPU_GEN} tokens on the host CPU "
          f"({cpu_s:.2f} s): greedy tokens identical={same}, max |prefill logits card - cpu| "
          f"{diff:.3g} (tol 1e-3)")
    if not same or not diff <= 1e-3:
        fail("phase 28: card and CPU disagree")
    del small_cpu, small, params
    torch.cuda.empty_cache()
    return ({**rec, **served, "cpu_layers": L, "cpu_tokens_identical": same,
             "cpu_prefill_logits_max_abs_diff": diff}, loss)


def _vlm_sync(label: str, layers: int, tau: int, shapes) -> dict:
    """One sync arch run of phi-3 alone at full width and ``layers``
    layers, phase 18's settings at VLM_TRAIN's seq: s/round, trained
    tokens/s (text and image slots), peak memory, launches; fedavg once per
    non-empty fold (tau > 1) at (batch, N), never at tau 1; rmsnorm and no
    other kernel besides."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import param_count

    opts = dict(preset="full", seq=VLM_TRAIN["seq"], batch=VLM_TRAIN["batch"], tau=tau)
    spec = arch_spec(f"vlm-tau{tau}", {VLM_ARCH: opts}, VLM_TRAIN["clients"])
    with DepthCut({VLM_ARCH: layers}):
        shapes.reset_peak()
        res, launches = run_counted(spec, "cuda")
    peak = shapes.peak_bytes()
    n = param_count(res.params[0])
    folds = int((res.alloc_counts[:, 0] > 0).sum()) if tau > 1 else 0
    want = {(opts["batch"], n, "float32"): folds} if folds else {}
    if launches.get("fedavg", 0) != folds or dict(shapes.fedavg) != want:
        fail(f"{label}: fedavg launched {launches.get('fedavg', 0)} times at "
             f"{dict(shapes.fedavg)} for {folds} non-empty tau>1 folds")
    if set(launches) - {"fedavg", "rmsnorm"} or launches.get("rmsnorm", 0) <= 0:
        fail(f"{label}: launches {launches}")
    if not (res.alloc_counts[:, 0] > 0).any() or not np.isfinite(res.final_loss[VLM_ARCH]) \
            or not np.isfinite(res.acc).all():
        fail(f"{label}: loss {res.loss} or accuracy {res.acc} not finite, or never trained")
    # rows x seq x tau, the image slots counted as positions; the text
    # tokens (those with a loss) beside
    tokens = _trained_tokens(spec, res)
    text = tokens * (opts["seq"] - get_config(VLM_ARCH).n_img_tokens) // opts["seq"]
    with DepthCut({VLM_ARCH: layers}):
        per_step = norms_per_step(spec.tasks[0], res.params[0])
    rec = {"layers": layers, "tau": tau, "params": n, "params_bytes": 4 * n,
           "s_per_round": res.wall_time / spec.runtime.rounds,
           "trained_tokens_per_s": tokens / res.wall_time, "trained_tokens": tokens,
           "text_tokens_per_s": text / res.wall_time,
           "wall_s": res.wall_time, "peak_bytes": peak, "launches": launches,
           "fedavg_folds": folds, "final_loss": res.final_loss[VLM_ARCH],
           "final_acc": float(res.acc[-1, 0]), "rmsnorm_per_training_step": per_step}
    print(f"{VLM_ARCH} sync tau {tau} at {layers} of 32 layers ({n} params, "
          f"{4 * n / 1e9:.2f} GB): {rec['s_per_round']:.3f} s/round, "
          f"{rec['trained_tokens_per_s']:.1f} trained tokens/s ({tokens} in "
          f"{res.wall_time:.3f} s; {rec['text_tokens_per_s']:.1f} text tokens/s), peak "
          f"{peak / 2**30:.3f} GiB, final loss "
          f"{rec['final_loss']:.4f}, acc {rec['final_acc']:.4f}; launches {launches}, fedavg = "
          f"non-empty folds {folds}; rmsnorm launches per training step {per_step}")
    return rec


def phase_vlm_train(line: str):
    """Phase 29: phi-3-vision in training."""
    import numpy as np
    import torch

    from repro_torch.models import param_count

    print(f"== phase 29: arch training of {VLM_ARCH} on the card (run_scenario, vmap backend)")
    print(f"card: {line}")
    torch.cuda.empty_cache()
    with FoldShapes() as adamw_shapes:
        adamw = _vlm_sync("phase 29 adamw", VLM_TRAIN["adamw_layers"], 1, adamw_shapes)
    torch.cuda.empty_cache()
    with FoldShapes() as shapes:
        fold = _vlm_sync("phase 29 fold", VLM_TRAIN["fold_layers"], 2, shapes)
    checked = check_run_shapes("phase 29", shapes)
    if checked["fedavg_calls_held"] != fold["fedavg_folds"]:
        fail(f"phase 29: {checked['fedavg_calls_held']} fedavg calls held for "
             f"{fold['fedavg_folds']} folds")
    torch.cuda.empty_cache()
    timed = time_lm_shapes(shapes)

    # async fedadam, tau 2, at a buffer of VLM_TRAIN["async_buffer"]
    torch.cuda.empty_cache()
    opts = dict(preset="full", seq=VLM_TRAIN["seq"], batch=VLM_TRAIN["batch"],
                tau=ARCH_ASYNC["tau"])
    buffer = VLM_TRAIN["async_buffer"]
    aspec = arch_spec("vlm-async", {VLM_ARCH: opts}, VLM_TRAIN["clients"], mode="async",
                      buffer=buffer, aggregator=ARCH_ASYNC["aggregator"],
                      options=ARCH_ASYNC["options"])
    with DepthCut({VLM_ARCH: VLM_TRAIN["async_layers"]}), FoldShapes() as ashapes:
        ashapes.reset_peak()
        ares, alaunch = run_counted(aspec, "cuda")
    apeak = ashapes.peak_bytes()
    flushes = len(ares.time)
    an = param_count(ares.params[0])
    if (flushes == 0 or alaunch.get("fused_aggregate", 0) != flushes
            or set(alaunch) - {"fused_aggregate", "rmsnorm"}
            or dict(ashapes.fused) != {(buffer, an, "fedadam"): flushes}):
        fail(f"phase 29: async launches {alaunch} at {dict(ashapes.fused)} for {flushes} "
             f"flushes")
    if not (np.isfinite(ares.loss).all() and np.isfinite(ares.acc).all()):
        fail(f"phase 29: async metric {ares.loss} or accuracy {ares.acc} not finite")
    arec = {"layers": VLM_TRAIN["async_layers"], "flushes": flushes,
            "flushes_per_s": flushes / ares.wall_time, "wall_s": ares.wall_time,
            "peak_bytes": apeak, "buffer": buffer, "params": an, "launches": alaunch,
            "acc_eval": ares.acc.tolist(), "metric": ares.loss.tolist()}
    print(f"{VLM_ARCH} async fedadam at {arec['layers']} layers, buffer {buffer}: "
          f"{arec['flushes_per_s']:.3f} flushes/s ({flushes} flushes of "
          f"{aspec.runtime.total_arrivals} arrivals, {ares.wall_time:.3f} s), peak "
          f"{apeak / 2**30:.3f} GiB, launches {alaunch}")
    achecked = check_run_shapes("phase 29 async", ashapes)
    del ares
    torch.cuda.empty_cache()
    atimed = time_lm_shapes(ashapes)

    # the tiny presets of phi-3 and smollm on the card and the CPU
    o = VLM_TINY["options"]
    tiny = arch_spec("vlm-tiny", {a: o for a in VLM_TINY["archs"]}, VLM_TINY["clients"],
                     strategy="round_robin", rounds=VLM_TINY["rounds"])
    tiny_async = arch_spec("vlm-tiny-async", {a: o for a in VLM_TINY["archs"]},
                           VLM_TINY["clients"], mode="async", strategy="round_robin",
                           arrivals=VLM_TINY["arrivals"], buffer=VLM_TINY["buffer"],
                           aggregator="fedadam", options=ARCH_ASYNC["options"])
    with FoldShapes() as tiny_shapes:
        gpu, tlaunch = run_counted(tiny, "cuda")
        agpu, talaunch = run_counted(tiny_async, "cuda")
    tfolds, tflushes = int((gpu.alloc_counts > 0).sum()), len(agpu.time)
    if (tlaunch.get("fedavg", 0) != tfolds or sum(tiny_shapes.fedavg.values()) != tfolds
            or talaunch.get("fedavg", 0) or talaunch.get("fused_aggregate", 0) != tflushes
            or sum(tiny_shapes.fused.values()) != tflushes):
        fail(f"phase 29: tiny runs' launches {tlaunch} / {talaunch} for {tfolds} folds and "
             f"{tflushes} flushes")
    cpu, _ = run_counted(tiny, "cpu")
    acpu, _ = run_counted(tiny_async, "cpu")
    same, gap = np.array_equal(gpu.alloc, cpu.alloc), _loss_gap(gpu, cpu)
    asame, agap = _same_events(agpu, acpu), _loss_gap(agpu, acpu)
    print(f"tiny {list(VLM_TINY['archs'])} card vs CPU: sync round_robin tau 2 allocation traces "
          f"identical={same}, max |loss card - cpu| {gap:.3g}, fedavg {tlaunch.get('fedavg', 0)} "
          f"launches for {tfolds} folds; async fedadam event traces identical={asame}, max |eval "
          f"loss card - cpu| {agap:.3g}, fused_aggregate {talaunch.get('fused_aggregate', 0)} "
          f"launches for {tflushes} flushes")
    if not same or not gap <= 1e-3 or not asame or not agap <= 1e-3:
        fail("phase 29: tiny phi-3 card vs CPU disagree")
    tiny_checked = check_run_shapes("phase 29 tiny", tiny_shapes)
    return ({"adamw": adamw, "fold": fold, "async": arec, "card_vs_cpu_loss_gap": gap,
             "card_vs_cpu_async_loss_gap": agap, "tiny_sync_launches": tlaunch,
             "tiny_async_launches": talaunch},
            {k: max(checked[k], achecked[k], tiny_checked[k]) for k in
             ("fedavg", "fused_aggregate")}
            | {"fedavg_shapes": checked["fedavg_shapes"] + tiny_checked["fedavg_shapes"],
               "fused_shapes": achecked["fused_shapes"] + tiny_checked["fused_shapes"]},
            timed + atimed)


def _queue_requests(module, vocab: int) -> list:
    """QUEUE's requests, drawn from its seed, as ``module.Request``s."""
    import numpy as np

    rng = np.random.default_rng(QUEUE["seed"])
    out = []
    for i in range(QUEUE["requests"]):
        P = int(rng.integers(QUEUE["prompt"][0], QUEUE["prompt"][1] + 1))
        G = int(rng.integers(QUEUE["max_new"][0], QUEUE["max_new"][1] + 1))
        out.append(module.Request(i, rng.integers(0, vocab, size=P, dtype=np.int32), max_new=G))
    return out


def _replay(api, cfg, params, prompts, fed, length: int, per_row=False):
    """Host logits (steps, B, vocab) of the prompts' prefill and of a decode
    step for each column of ``fed`` (B, steps - 1), fed in turn (teacher
    forcing), on caches of ``length`` slots (text only: a vlm fed no image
    has no image slots). With ``per_row`` every token instead goes through
    per-row decode from an empty per-row cache, the prompt a token at a
    time (the continuous batcher's path), and the logits of the last
    prompt token and after are kept."""
    import torch

    from repro_torch.models import pad_cache

    B, P = prompts.shape
    V = cfg.vocab_size
    out = []
    with torch.no_grad():
        if per_row:
            caches = api.init_cache_fn(params, cfg, B, length, torch.float32, per_row=True)
            seq = torch.cat([prompts, fed], dim=1)
            for i in range(seq.shape[1]):
                pos = torch.full((B,), i, dtype=torch.int32, device=prompts.device)
                logits, caches = api.decode_fn(params, cfg, seq[:, i:i + 1], pos, caches)
                if i >= P - 1:
                    out.append(logits[:, 0, :V].cpu())
            return torch.stack(out)
        logits, caches = api.prefill_fn(params, cfg, {"tokens": prompts, "labels": prompts})
        caches = pad_cache(caches, P, P + length)
        out.append(logits[:, -1, :V].cpu())
        for i in range(fed.shape[1]):
            logits, caches = api.decode_fn(params, cfg, fed[:, i:i + 1], P + i, caches)
            out.append(logits[:, -1, :V].cpu())
    return torch.stack(out)


def _flips(label: str, want_logits, got: list, gap: float) -> list:
    """Each step where the greedy token of ``want_logits`` (steps, vocab)
    differs from ``got``: (step, margin = top logit - logit of the token
    got). A flip passes only where its margin is below ``gap``, the logit
    difference the phase measured between the two paths."""
    flips = []
    for step, tok in enumerate(got):
        row = want_logits[step]
        top = int(row.argmax())
        if top != tok:
            margin = float(row[top] - row[tok])
            flips.append((step, margin))
            print(f"  {label}: token flip at step {step}: {tok} against {top}, margin "
                  f"{margin:.3g}, measured logit difference {gap:.3g}")
            if not margin < gap:
                fail(f"phase 30: {label} token {tok} at step {step} against {top} (margin "
                     f"{margin} >= {gap})")
    return flips


def _serve_queue(kind: str, arch: str, params, cfg, horizon: int) -> tuple:
    """QUEUE's requests through ``kind`` (after a two-request warm-up), the
    launch counts set to 0 just before: (requests, metrics with the
    launches)."""
    import repro_torch.launch.queue as queue
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import get_api

    api = get_api(cfg)
    warm = getattr(queue, kind)(api, cfg, params, slots=QUEUE["slots"], horizon=horizon)
    for r in _queue_requests(queue, cfg.vocab_size)[:2]:
        warm.submit(r)
    warm.run()
    del warm
    b = getattr(queue, kind)(api, cfg, params, slots=QUEUE["slots"], horizon=horizon)
    reqs = _queue_requests(queue, cfg.vocab_size)
    for r in reqs:
        b.submit(r)
    reset_launches()
    stats = b.run()
    stats["launches"] = dict(LAUNCHES)
    if stats["requests"] != len(reqs) or any(len(r.out) != r.max_new for r in reqs):
        fail(f"phase 30: {kind} {arch} served {stats}")
    if set(stats["launches"]) != {"rmsnorm"}:
        fail(f"phase 30: {kind} {arch} launches {stats['launches']}")
    print(f"{kind} {arch}: {stats['requests']} requests, {stats['tokens']} tokens in "
          f"{stats['wall_s']:.3f} s: {stats['tok_per_s']:.1f} tok/s, mean latency "
          f"{stats['mean_latency_s']:.3f} s, mean TTFT {stats['mean_ttft_s']:.3f} s; launches "
          f"{stats['launches']}")
    return reqs, stats


def _check_waves(arch: str, params, cfg, reqs, horizon: int) -> dict:
    """Every wave (QUEUE's slots in submission order) equals ``generate``
    on its left-padded batch (a vlm behind zero image embeddings), token
    for token up to each request's max_new: the batcher runs the same
    prefill, ``pad_cache`` and decode calls, so any difference fails."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.launch.serve import generate, serve_features

    dev = torch.device("cuda")
    S = QUEUE["slots"]
    feats = serve_features(prng.PRNGKey(0, device=dev), cfg, S)
    for w0 in range(0, len(reqs), S):
        wave = reqs[w0:w0 + S]
        P = max(len(r.prompt) for r in wave)
        toks = np.zeros((S, P), np.int64)
        for i, r in enumerate(wave):
            toks[i, P - len(r.prompt):] = r.prompt
        ref = generate(params, cfg, torch.from_numpy(toks).to(dev), horizon, feats).tokens.cpu()
        for i, r in enumerate(wave):
            if ref[i, :len(r.out)].tolist() != r.out:
                fail(f"phase 30: WaveBatcher {arch} request {r.rid} gave {r.out}, generate "
                     f"{ref[i, :len(r.out)].tolist()}")
    print(f"  WaveBatcher {arch}: every wave equals generate on its left-padded batch")
    return {"identical_to_generate": True}


def _check_continuous(arch: str, params, cfg, reqs, horizon: int) -> dict:
    """Every request equals a direct B=1 prefill and decode: the direct
    path's logits, fed the request's own tokens, must pick each of them;
    a flip passes only below the logit difference measured between the
    per-row path (every token through per-row decode) and the direct path
    on the longest request."""
    import torch

    from repro_torch.models import get_api

    api = get_api(cfg)
    dev = torch.device("cuda")
    direct = {}
    for r in reqs:
        prompt = torch.from_numpy(r.prompt.astype("int64"))[None].to(dev)
        fed = torch.tensor([r.out[:-1]], dtype=torch.int64, device=dev)
        direct[r.rid] = (prompt, fed, _replay(api, cfg, params, prompt, fed, len(r.out))[:, 0])
    longest = max(reqs, key=lambda r: len(r.prompt) + len(r.out))
    prompt, fed, want = direct[longest.rid]
    per_row = _replay(api, cfg, params, prompt, fed, horizon, per_row=True)[:, 0]
    gap = float((per_row - want).abs().max())
    flips = []
    for r in reqs:
        flips += _flips(f"ContinuousBatcher {arch} request {r.rid}", direct[r.rid][2], r.out, gap)
    print(f"  ContinuousBatcher {arch}: every request against a direct B=1 prefill and decode "
          f"fed its tokens: {len(flips)} token flips; max |logits per-row path - direct path| "
          f"{gap:.3g} on request {longest.rid} ({len(longest.prompt)} + {len(longest.out)} "
          f"tokens)")
    return {"flips": flips, "logit_gap": gap}


def phase_queue(line: str):
    """Phase 30: the serving queue at full width."""
    import torch

    from repro_torch.configs import get_config

    print("== phase 30: the serving queue (launch/queue.py) at full width on the card")
    print(f"card: {line}")
    wave_h = QUEUE["max_new"][1]
    cont_h = QUEUE["prompt"][1] + QUEUE["max_new"][1]
    out = {}
    for arch in dict.fromkeys(QUEUE_WAVE + QUEUE_CONTINUOUS):
        cfg = get_config(arch)
        params, rec = _init_family(arch, cfg)
        out[arch] = {"params": rec["params"]}
        for kind, archs, horizon, check in (
                ("WaveBatcher", QUEUE_WAVE, wave_h, _check_waves),
                ("ContinuousBatcher", QUEUE_CONTINUOUS, cont_h, _check_continuous)):
            if arch not in archs:
                continue
            reqs, stats = _serve_queue(kind, arch, params, cfg, horizon)
            out[arch][kind] = {**stats, "horizon": horizon,
                               **check(arch, params, cfg, reqs, horizon)}
        del params
        torch.cuda.empty_cache()
    return out


class CohortCheck:
    """Every cohort the forced-mesh backends run is held twice, from the
    same params and inputs. (1) Bit for bit against ``vmap`` run on each
    part alone (the parts split here by ``numpy.array_split``, the
    results joined in cohort order): the backend's split, device moves
    and gather. (2) Against ``vmap`` on the whole cohort, beside
    ``serial``'s distance from it: a batched product rounds by its batch
    count on the card (cuBLAS picks its kernel by it), so neither a part
    nor ``serial``'s one-client calls are bit-equal to their rows of the
    whole cohort; both distances are recorded (``worst``,
    ``serial_vs_vmap``: the largest max |diff| / max(1, max |leaf|)
    seen). Its seconds go to ``FoldShapes.held_s``, which
    ``run_counted`` takes off the run's time; the synthetic tasks' local
    updates launch no kernel."""

    worst = 0.0
    serial_vs_vmap = 0.0
    cohorts = 0


def _cohort_gap(a, b) -> float:
    """max over leaves of max |a - b| / max(1, max |b|)."""
    from repro_torch.tree import tree_leaves

    return max(float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
               for x, y in zip(tree_leaves((a.updates, a.losses)),
                               tree_leaves((b.updates, b.losses))))


def _forced_backend(mesh) -> str:
    """Register a ``sharded`` backend over ``mesh`` (a tuple of devices, a
    constructor argument only) whose cohorts ``CohortCheck`` holds;
    returns its registry key."""
    from repro_torch.api import (BACKENDS, ClientBatch, SerialBackend, ShardedBackend,
                                 VmapBackend)
    from repro_torch.tree import tree_leaves, tree_map

    name = "sharded-" + "-".join(d.replace(":", "") for d in mesh)
    if name in BACKENDS:
        return name

    class Forced(ShardedBackend):
        def __init__(self, device=None):
            super().__init__(device, mesh=mesh)

        def run_cohort(self, task_state, client_batch, rng=None):
            import numpy as np
            import torch

            got = super().run_cohort(task_state, client_batch, rng)
            t0 = time.perf_counter()
            vmap = VmapBackend(self.device)
            parts = []
            for rows in np.array_split(np.arange(len(client_batch)), len(mesh)):
                if len(rows) == 0:
                    continue
                lo, hi = int(rows[0]), int(rows[-1]) + 1
                keys = None if client_batch.keys is None else client_batch.keys[lo:hi]
                parts.append(vmap.run_cohort(task_state, ClientBatch(
                    client_batch.client_ids[lo:hi], keys,
                    tuple(tree_map(lambda t: t[lo:hi], d) for d in client_batch.data))))
            whole = vmap.run_cohort(task_state, client_batch, rng)
            one = SerialBackend(self.device).run_cohort(task_state, client_batch, rng)
            joined = tree_map(lambda *ls: torch.cat(ls), *((p.updates, p.losses) for p in parts))
            if len(client_batch) > 1 and not all(torch.equal(x, y) for x, y in zip(
                    tree_leaves((got.updates, got.losses)), tree_leaves(joined))):
                fail(f"{name}: a cohort of {len(client_batch)} differs from vmap run on its "
                     "parts in turn")
            CohortCheck.worst = max(CohortCheck.worst, _cohort_gap(got, whole))
            CohortCheck.serial_vs_vmap = max(CohortCheck.serial_vs_vmap, _cohort_gap(one, whole))
            CohortCheck.cohorts += 1
            torch.cuda.synchronize()
            FoldShapes.held_s += time.perf_counter() - t0
            return got

    BACKENDS.add(name, Forced)
    return name


def _backend(spec, name: str):
    import copy

    spec = copy.deepcopy(spec)
    spec.runtime.backend = name
    return spec


def _run_gap(a, b) -> float:
    """max |difference| of two runs' curves and final params (0 where
    bit-equal); fails unless their allocation or event traces are
    identical."""
    import numpy as np

    from repro_torch.tree import tree_leaves

    if a.mode == "async":
        if not _same_events(a, b):
            fail(f"{b.spec.runtime.backend}: event trace unlike {a.spec.runtime.backend}'s")
    elif not (np.array_equal(a.alloc, b.alloc) and np.array_equal(a.alloc_counts,
                                                                  b.alloc_counts)):
        fail(f"{b.spec.runtime.backend}: allocation trace unlike {a.spec.runtime.backend}'s")
    gap = max(float(np.abs(a.loss - b.loss).max()), float(np.abs(a.acc - b.acc).max()))
    return max([gap] + [float((x - y).abs().max())
                        for x, y in zip(tree_leaves(a.params), tree_leaves(b.params))])


def phase_sharded(line: str):
    """Phase 31 (a): the ``sharded`` backend on the quickstart sync spec and
    exp13's fedadam async spec, on the default cohort mesh (this host's
    cards) and on meshes that repeat the one card, against ``vmap``."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_cohort_mesh

    print("== phase 31 (a): the sharded cohort backend (run_scenario, backend='sharded')")
    print(f"card: {line}")
    default = make_cohort_mesh(device="cuda")
    print(f"default cohort mesh: {[str(d) for d in default]} "
          f"(torch.cuda.device_count() = {torch.cuda.device_count()})")
    out = {"default_mesh": [str(d) for d in default]}
    for kind, spec, kernel in (
            ("sync", quickstart_spec("fedfair"), "fedavg"),
            ("async", exp13_spec("fedadam", SERVER_OPTIONS["fedadam"]), "fused_aggregate")):
        runs = {}
        for label, backend in [("vmap", "vmap"), ("sharded", "sharded")] + [
                (f"sharded x{len(m)}", _forced_backend(m)) for m in SHARDED_MESHES]:
            CohortCheck.worst, CohortCheck.serial_vs_vmap, CohortCheck.cohorts = 0.0, 0.0, 0
            with FoldShapes() as shapes:
                if kind == "sync":
                    res, launches = run_sync_counted(f"{kind} {label}", _backend(spec, backend))
                else:
                    res, launches = run_async_counted(f"{kind} {label}", _backend(spec, backend),
                                                      kernel)
            checked = check_run_shapes(f"{kind} {label}", shapes)
            n = spec.runtime.rounds if kind == "sync" else len(res.time)
            runs[label] = res
            rec = {"wall_s": res.wall_time, f"{'rounds' if kind == 'sync' else 'flushes'}_per_s":
                   n / res.wall_time, "launches": launches, "max_abs_err": checked[kernel]}
            if label != "vmap":
                if launches != out[kind]["vmap"]["launches"]:
                    fail(f"{kind} {label}: launches {launches}, vmap's "
                         f"{out[kind]['vmap']['launches']}")
                gap = _run_gap(runs["vmap"], res)
                rec["max_diff_vs_vmap"] = gap
                final = float(np.abs(runs["vmap"].acc[-1] - res.acc[-1]).max())
                if label == "sharded" and gap != 0.0:
                    fail(f"{kind} sharded on the default mesh: not bit-equal to vmap ({gap})")
                if label != "sharded":
                    rec["cohorts_held"] = CohortCheck.cohorts
                    rec["cohort_max_diff_vs_vmap"] = CohortCheck.worst
                    rec["cohort_serial_max_diff_vs_vmap"] = CohortCheck.serial_vs_vmap
                    # sync folds average the cohort once a round; the async
                    # fedadam run feeds each flush's rounding into the next
                    # 200 (a cohort's bmm rounds by its batch count on the
                    # card): there the run is held to phase 7's card/CPU rule
                    if not (gap <= 1e-6 if kind == "sync" else final <= 0.01):
                        fail(f"{kind} {label}: max |diff| {gap} against vmap, final accuracy "
                             f"{final} apart")
                print(f"{kind} {label}: traces identical to vmap's; "
                      + ("bit-equal" if gap == 0.0 else f"curves and params within {gap:.3g}")
                      + (f"; each of its {CohortCheck.cohorts} cohorts bit-equal to vmap run "
                         f"on its parts, and within {CohortCheck.worst:.3g} x max(1, "
                         f"max|leaf|) of vmap on the whole cohort (serial: "
                         f"{CohortCheck.serial_vs_vmap:.3g})"
                         if label != "sharded" else ""))
            out.setdefault(kind, {})[label] = rec
        rate = "rounds_per_s" if kind == "sync" else "flushes_per_s"
        print(f"{kind}: " + ", ".join(f"{k} {r[rate]:.2f} {rate.replace('_per_s', '')}/s"
                                      for k, r in out[kind].items())
              + " (one card; the forced meshes run their parts in turn on it)")
    return out


def phase_dtensor_lm(line: str):
    """Phase 31 (b): qwen3-0.6b at full width and depth on DTensors of a
    (1, 1) ('data', 'model') mesh of a 1-rank NCCL group, against the
    same params as plain tensors: the loss with and without use_pallas
    and one AdamW step, with the kernels' launches per forward."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import loss_and_grads, server_opt
    from repro_torch.models import get_api
    from repro_torch.sharding import partition as part
    from repro_torch.tree import tree_leaves, tree_map

    print("== phase 31 (b): the dense LM step on DTensors (1-rank NCCL group, (1, 1) mesh)")
    print(f"card: {line}")
    arch, B, S, reps = (DTENSOR_LM[k] for k in ("arch", "B", "S", "reps"))
    cfg = get_config(arch)
    api = get_api(cfg)
    norms_per_forward = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device_type="cuda")
        params, rec = _init_family(arch, cfg)
        gen = torch.Generator(device="cuda").manual_seed(31)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        opt = server_opt()
        out = {"arch": arch, "params": rec["params"], "B": B, "S": S,
               "mesh": [list(mesh.shape), list(mesh.mesh_dim_names)]}

        def run(p, b, c):
            """(loss, launches) of one forward without autograd."""
            reset_launches()
            with torch.no_grad():
                loss = api.loss_fn(p, c, b)[0]
            torch.cuda.synchronize()
            return loss, dict(LAUNCHES)

        def step(p, b, state):
            loss, grads = loss_and_grads(api, cfg, p, b)
            new, _ = opt.update(p, grads, state)
            return loss, grads, new

        def timed(fn, *args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                got = fn(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del got
            return statistics.median(times) * 1e3, torch.cuda.max_memory_allocated()

        pcfg = cfg.replace(use_pallas=True)
        plain = {}
        for name, c in (("loss", cfg), ("loss_use_pallas", pcfg)):
            plain[name] = run(params, batch, c)
        state = opt.init(params)
        reset_launches()
        want_loss, want_grads, want_new = step(params, batch, state)
        torch.cuda.synchronize()
        plain_step_launches = dict(LAUNCHES)
        plain_ms, plain_peak = timed(step, params, batch, state)
        del state

        with part.use_mesh(mesh):
            dp = part.dp_axes(mesh)
            part.set_sharding_ctx(activation=(mesh, part.P(dp, None, "model")),
                                  logits=(mesh, part.P(dp, None, "model")))
            dparams = part.distribute_tree(params, part.tree_param_specs(params, cfg), mesh)
            dbatch = {k: distribute_tensor(v, mesh, part.placements(
                mesh, part.batch_spec(mesh, B, v.ndim))) for k, v in batch.items()}
            got = {}
            for name, c in (("loss", cfg), ("loss_use_pallas", pcfg)):
                got[name] = run(dparams, dbatch, c)
            dstate = opt.init(dparams)
            reset_launches()
            loss, grads, new = step(dparams, dbatch, dstate)
            torch.cuda.synchronize()
            step_launches = dict(LAUNCHES)
            d_ms, d_peak = timed(step, dparams, dbatch, dstate)
            kept = all(list(n.placements) == list(p.placements)
                       for n, p in zip(tree_leaves(new), tree_leaves(dparams)))
            loss_v = float(loss.full_tensor())
            grads = tree_map(lambda t: t.full_tensor(), grads)
            new = tree_map(lambda t: t.full_tensor(), new)
            got = {k: (float(v.full_tensor()), n) for k, (v, n) in got.items()}
        plain = {k: (float(v), n) for k, (v, n) in plain.items()}

        for name in plain:
            (lw, nw), (lg, ng) = plain[name], got[name]
            want_n = {"rmsnorm": norms_per_forward}
            if name == "loss_use_pallas":
                want_n["flash_attention"] = cfg.n_layers
            if nw != want_n or ng != want_n:
                fail(f"dtensor {name}: launches plain {nw}, DTensor {ng}, expected {want_n}")
            if not abs(lg - lw) <= 1e-6 * abs(lw):
                fail(f"dtensor {name}: DTensor loss {lg} against plain {lw} (1e-6 relative)")
            out[name] = {"plain": lw, "dtensor": lg, "launches": ng}
            print(f"{name}: DTensor {lg:.7f}, plain {lw:.7f}, launches per forward {ng} on "
                  "both")
        if not kept:
            fail("dtensor step: a param left the step with other placements than it had")
        if not abs(loss_v - float(want_loss)) <= 1e-6 * abs(float(want_loss)):
            fail(f"dtensor step: loss {loss_v} against plain {float(want_loss)}")
        g_err = 0.0
        n_ill = total = 0
        p_err = 0.0
        for gd, gw, nd, nw in zip(tree_leaves(grads), tree_leaves(want_grads),
                                  tree_leaves(new), tree_leaves(want_new)):
            tol = 1e-6 * max(1.0, float(gw.abs().max()))
            e = float((gd - gw).abs().max())
            g_err = max(g_err, e / tol * 1e-6)
            if not e <= tol:
                fail(f"dtensor step: gradient max |diff| {e} over {tol}")
            d = (nd.float() - nw.float()).abs()
            ill = gw.abs() < ADAM_ILL
            if bool((d[~ill] > 1e-5).any()):
                fail(f"dtensor step: params max |diff| {float(d[~ill].max())} where |g| >= "
                     f"{ADAM_ILL}")
            n_ill += int((d > 1e-5).sum())
            total += d.numel()
            p_err = max(p_err, float(d.max()))
        if n_ill > ADAM_SHARE * total:
            fail(f"dtensor step: {n_ill} of {total} params beyond 1e-5")
        if step_launches.get("rmsnorm") != norms_per_forward or (
                plain_step_launches.get("rmsnorm") != norms_per_forward):
            fail(f"dtensor step: rmsnorm launches DTensor {step_launches}, plain "
                 f"{plain_step_launches}, expected {norms_per_forward} (the forward)")
        out["step"] = {"loss_plain": float(want_loss), "loss_dtensor": loss_v,
                       "grad_max_diff_over_scale": g_err, "params_max_diff": p_err,
                       "params_beyond_1e-5": n_ill, "placements_kept": kept,
                       "launches": step_launches, "ms_dtensor": d_ms, "ms_plain": plain_ms,
                       "peak_bytes_dtensor": d_peak, "peak_bytes_plain": plain_peak}
        print(f"AdamW step (server_opt): loss DTensor {loss_v:.7f}, plain {float(want_loss):.7f}; "
              f"grads within {g_err:.3g} x max(1, max|g|); params max |diff| {p_err:.3g} "
              f"({n_ill} of {total} beyond 1e-5, all where |g| < {ADAM_ILL}); placements kept; "
              f"rmsnorm launches {step_launches.get('rmsnorm')} (the forward)")
        print(f"step time (median of {reps}): DTensor {d_ms:.1f} ms, plain {plain_ms:.1f} ms "
              f"({d_ms / plain_ms:.2f}x); peak memory DTensor {d_peak / 2**30:.2f} GiB, plain "
              f"{plain_peak / 2**30:.2f} GiB")
        del params, dparams, grads, new, want_grads, want_new
        torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


# phase 32: every family on DTensors of a (1, 1) mesh, and the dry-run on the host
DTENSOR_FAMILIES = (
    # (label, arch, config cut in depth, decode settings)
    ("zamba2-7b", "zamba2-7b", dict(n_layers=6), ({},)),     # one group of 6 + its shared slot
    ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", dict(n_layers=2), ({},)),
    ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", dict(n_layers=2),
     ({"mla_absorb": False}, {"mla_absorb": True, "mla_cache_shard": "seq"})),
    ("xlstm-1.3b", "xlstm-1.3b", dict(n_layers=8), ({},)),    # 7 mLSTM + 1 sLSTM
    ("whisper-medium", "whisper-medium", dict(n_layers=2, n_enc_layers=2), ({},)),
    ("qwen3-0.6b", "qwen3-0.6b", {}, ({},)),                 # dense decode, full depth
)
DTENSOR_FAMILY_LOSS = dict(B=4, S=256)                       # S % 128: flash under use_pallas
DTENSOR_FAMILY_GEN = 8
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"))
DRYRUN_TIMEOUT = 400


def _dtensor_family(label: str, arch: str, cut: dict, decodes, mesh) -> dict:
    """One family at full width, f32, cut in depth: its loss with and
    without use_pallas (launches per forward), then a prefill of B 8 x 128
    and 8 greedy tokens, on plain tensors and on DTensors of ``mesh`` (the
    caches laid out by ``partition.cache_spec``), from the same params."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    import repro_torch.models.moe as moe_mod
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_features
    from repro_torch.models import get_api, pad_cache
    from repro_torch.sharding import partition as part

    cfg = get_config(arch).replace(**cut)
    api = get_api(cfg)
    params, rec = _init_family(label, cfg)
    B, S, G = DTENSOR_FAMILY_LOSS["B"], DTENSOR_FAMILY_LOSS["S"], DTENSOR_FAMILY_GEN
    gen = torch.Generator(device="cuda").manual_seed(32)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous(),
             **serve_features(prng.PRNGKey(32, device=torch.device("cuda")), cfg, B)}
    prompts = _serve_prompts(cfg)
    pbatch = {"tokens": prompts, "labels": prompts,
              **serve_features(prng.PRNGKey(0, device=torch.device("cuda")), cfg, SERVE_BATCH)}
    routes = []
    orig_route = moe_mod.moe_route

    def route(p, c, xf):
        out = orig_route(p, c, xf)
        routes.append((out[1].cpu(), torch.where(out[2] > 0, out[3], -1).cpu()))
        return out

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def loss(p, b, c):
        """(loss, launches, ms) of one forward without autograd."""
        with torch.no_grad():
            api.loss_fn(p, c, b)                              # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            value = float(full(api.loss_fn(p, c, b)[0]))
            ms = (time.perf_counter() - t0) * 1e3
        return value, dict(LAUNCHES), ms

    def generate(p, c, b, sharded):
        routes.clear()
        with torch.no_grad():
            reset_launches()
            logits, caches = api.prefill_fn(p, c, b)
            caches = pad_cache(caches, SERVE_PROMPT, SERVE_PROMPT + G)
            if sharded:
                caches = part.distribute_caches(caches, mesh, SERVE_BATCH)
            logs, out = [full(logits)[:, -1].float().cpu()], []
            tok = torch.argmax(logits[:, -1:, :c.vocab_size], dim=-1)
            for i in range(G):
                out.append(full(tok).cpu())
                logits, caches = api.decode_fn(p, c, tok, SERVE_PROMPT + i, caches)
                logs.append(full(logits)[:, -1].float().cpu())
                tok = torch.argmax(logits[:, -1:, :c.vocab_size], dim=-1)
            torch.cuda.synchronize()
        return torch.cat(out, 1), torch.stack(logs), list(routes), dict(LAUNCHES)

    moe_mod.moe_route = route
    try:
        pcfg = cfg.replace(use_pallas=True)
        plain = {name: loss(params, batch, c) for name, c in (("loss", cfg),
                                                               ("loss_use_pallas", pcfg))}
        plain_gen = [generate(params, cfg.replace(**d), pbatch, False) for d in decodes]
        with part.use_mesh(mesh):
            dp = part.dp_axes(mesh)
            part.set_sharding_ctx(activation=(mesh, part.P(dp, None, "model")),
                                  logits=(mesh, part.P(dp, None, "model")))
            dparams = part.distribute_tree(params, part.tree_param_specs(params, cfg), mesh)

            def on_mesh(b, n):
                return {k: distribute_tensor(v, mesh, part.placements(
                    mesh, part.batch_spec(mesh, n, v.ndim))) for k, v in b.items()}

            got = {name: loss(dparams, on_mesh(batch, B), c)
                   for name, c in (("loss", cfg), ("loss_use_pallas", pcfg))}
            got_gen = []
            for d in decodes:
                part.set_sharding_ctx(mla_cache_shard=d.get("mla_cache_shard", "latent"))
                got_gen.append(generate(dparams, cfg.replace(**d), on_mesh(pbatch, SERVE_BATCH),
                                        True))
            del dparams
    finally:
        moe_mod.moe_route = orig_route
    for name in plain:
        (lw, nw, msw), (lg, ng, msg) = plain[name], got[name]
        if nw != ng or (name == "loss_use_pallas" and arch == "zamba2-7b" and not (
                ng.get("ssd_scan") == ng.get("gated_rmsnorm") == cfg.n_layers)):
            fail(f"{label} {name}: launches plain {nw}, DTensor {ng}")
        if not abs(lg - lw) <= 1e-6 * abs(lw):
            fail(f"{label} {name}: DTensor loss {lg} against plain {lw} (1e-6 relative)")
        rec[name] = {"plain": lw, "dtensor": lg, "launches": ng, "ms_plain": msw,
                     "ms_dtensor": msg}
        print(f"{label} {name} (B {B}, S {S}): DTensor {lg:.7f}, plain {lw:.7f}; launches per "
              f"forward {ng} on both; {msg:.1f} ms against {msw:.1f} ms plain")
    rec["decode"] = []
    for d, (ptok, plog, proute, pl), (dtok, dlog, droute, dl) in zip(decodes, plain_gen, got_gen):
        gap = float((plog - dlog).abs().max())
        same_routes = len(proute) == len(droute) and all(
            torch.equal(a, b) for pr, dr in zip(proute, droute) for a, b in zip(pr, dr))
        if not torch.equal(ptok, dtok) or gap > 1e-4 or not same_routes or pl != dl:
            fail(f"{label} {d}: tokens equal {torch.equal(ptok, dtok)}, logits gap {gap}, "
                 f"routing equal {same_routes} ({len(droute)} calls), launches {pl} / {dl}")
        rec["decode"].append({"settings": d, "logits_max_diff": gap, "moe_calls": len(droute),
                              "launches": dl})
        print(f"{label} prefill {SERVE_BATCH} x {SERVE_PROMPT} and {G} greedy tokens {d}: "
              f"identical tokens, logits within {gap:.3g}, routing identical over "
              f"{len(droute)} MoE calls, launches {dl} on both")
    del params
    torch.cuda.empty_cache()
    return rec


def _dryrun_cells() -> dict:
    """The dry-run of ``DRYRUN_CELLS`` on the host, each in its own process
    (its own fake group of 256 ranks), at once, with a timeout."""
    import os
    import subprocess
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    tmp = tempfile.mkdtemp()
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(tmp, f"{arch}_{shape}.json")
        procs[arch, shape] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--out", out], env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    recs = {}
    t0 = time.perf_counter()
    for (arch, shape), (out, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for _, other in procs.values():
                other.kill()
            fail(f"dry-run {arch} x {shape}: over {DRYRUN_TIMEOUT} s")
        if proc.returncode != 0 or not os.path.exists(out):
            fail(f"dry-run {arch} x {shape}: exit {proc.returncode}: {err[-2000:]}")
        rec = json.loads(Path(out).read_text())
        if not rec.get("ok") or rec.get("devices") != ["meta"]:
            fail(f"dry-run {arch} x {shape}: {rec.get('error')} devices {rec.get('devices')}")
        keep = ("mesh", "n_devices", "lower_s", "memory", "flops", "bytes", "collectives",
                "roofline", "params_total", "params_active", "model_flops_per_device",
                "useful_flop_ratio", "kernels")
        recs[f"{arch} x {shape}"] = {k: rec[k] for k in keep}
        print(f"dry-run {arch} x {shape} on a fake {rec['mesh']} group: ok in {rec['lower_s']} s; "
              f"flops/device {rec['flops']:.4e}, collectives {rec['collectives']['total_bytes']:.4e} "
              f"B, peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB, bottleneck "
              f"{rec['roofline']['bottleneck']}")
    return recs


def phase_dtensor_families(line: str) -> dict:
    """Phase 32: (a) each non-dense family at full width, f32, cut in depth,
    and qwen3-0.6b's decode, on DTensors of a (1, 1) ('data', 'model')
    mesh of a 1-rank NCCL group against the same params as plain tensors;
    (b) the dry-run of two cells on the host."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    print("== phase 32: every family on DTensors (1-rank NCCL group, (1, 1) mesh); the dry-run")
    print(f"card: {line}")
    out = {"families": {}}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device_type="cuda")
        for label, arch, cut, decodes in DTENSOR_FAMILIES:
            out["families"][label] = _dtensor_family(label, arch, cut, decodes, mesh)
    finally:
        dist.destroy_process_group()
    out["families_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["dryrun"] = _dryrun_cells()
    out["dryrun_s"] = time.perf_counter() - t1
    print(f"phase 32: (a) {out['families_s']:.1f} s, (b) {out['dryrun_s']:.1f} s")
    return out


# phase 33: the quickstart's three tasks at fixed losses, its 40 clients
# and examples/specs/big_population.json's 100,000; keys per strategy and
# for the one-client completion draw
ALLOC_LOSSES = (0.82, 0.35, 0.61)
ALLOC_CLIENTS = (40, 100_000)
ALLOC_KEYS, COMPLETION_KEYS, COMPLETION_ALONE = 8, 1000, 100
ALLOC_ALPHA = 3.0
ALLOC_STRATEGIES = ("fedfair", "random", "round_robin")
SELECTION = dict(n_selected=8, n_clients=40)
SELECTION_RTOL = 1e-6
LINT_TIMEOUT = 120
# host time of a one-key assign_completion: 5 windows of 10 calls
HOST_INNER, HOST_REPS = 10, 5
# phase 33 (b): the linter on the port and the two generators, as a user
# runs them (python -m ...)
LINT_COMMANDS = {"lint": ("repro_torch.analysis", "src/repro_torch"),
                 "docs/ANALYSIS_TORCH.md": ("repro_torch.analysis", "--dump-markdown"),
                 "docs/REGISTRY_TORCH.md": ("repro_torch.api.registry", "--dump-markdown")}


@contextlib.contextmanager
def no_host_sync():
    """torch raises on any call inside that syncs the host with the card."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_allocation_lint(line: str) -> dict:
    """Phase 33: (a) the key-driven allocators on the card against the CPU;
    (b) the port's linter and its two generated references."""
    import os

    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.core import allocation

    print("== phase 33: key-driven allocators (card against CPU); the linter")
    print(f"card: {line}")
    t0 = time.perf_counter()
    losses = np.asarray(ALLOC_LOSSES, np.float32)
    # inputs on the card, so that no call copies from the host: the card's
    # calls run with torch's sync debug mode raising on any host sync
    card_losses = torch.from_numpy(losses).cuda()
    keys = [prng.PRNGKey(k, device="cuda") for k in range(ALLOC_KEYS)]
    elig = (np.random.default_rng(33).random((COMPLETION_KEYS, len(losses))) < 0.5
            ).astype(np.float32)
    cpu_keys = prng.split(prng.PRNGKey(33), COMPLETION_KEYS)
    card_keys, card_elig = cpu_keys.cuda(), torch.from_numpy(elig).cuda()
    key0, elig0 = card_keys[0], card_elig[0]

    # (a)'s timings first, with nothing else running on the host
    def one_key():
        return allocation.assign_completion(key0, card_losses, elig0, ALLOC_ALPHA)

    out = {"allocate": {f"{strategy} n={n}": {"keys": ALLOC_KEYS, "ms": time_ms(
        lambda: allocation.allocate(keys[0], strategy, card_losses, n, ALLOC_ALPHA))}
        for strategy in ALLOC_STRATEGIES for n in ALLOC_CLIENTS}}
    out["assign_completion"] = {
        "keys": COMPLETION_KEYS, "keys_alone": COMPLETION_ALONE, "ms": time_ms(one_key),
        "host_us_per_call": 1e3 * host_ms(one_key, inner=HOST_INNER, reps=HOST_REPS),
        "batch_ms": time_ms(lambda: allocation.assign_completion(card_keys, card_losses,
                                                                 card_elig, ALLOC_ALPHA))}
    out["selection_probability"] = {"ms": time_ms(lambda: allocation.selection_probability(
        card_losses, ALLOC_ALPHA, **SELECTION))}
    out["timing_s"] = time.perf_counter() - t0

    # (b) in fresh processes (this process's registries also hold the
    # backends phase 31 registered), on the host while (a)'s checks run
    t1 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, args in LINT_COMMANDS.items()}

    for name, cell in out["allocate"].items():
        strategy, n = name.split(" n=")[0], int(name.split(" n=")[1])
        with no_host_sync():
            card = [allocation.allocate(k, strategy, card_losses, n, ALLOC_ALPHA,
                                        round_idx=i) for i, k in enumerate(keys)]
        cpu = [allocation.allocate(prng.PRNGKey(k), strategy, losses, n, ALLOC_ALPHA,
                                   round_idx=k) for k in range(ALLOC_KEYS)]
        for i, (a, b) in enumerate(zip(card, cpu)):
            if a.device.type != "cuda" or a.dtype != torch.int32 or not torch.equal(a.cpu(), b):
                fail(f"allocate {name} key {i}: card and CPU differ")
        print(f"allocate {name}: {ALLOC_KEYS} keys bit-equal with the CPU; "
              f"{cell['ms']:.3f} ms per call")
    empty = elig.sum(1) == 0
    if not empty.any():
        fail("assign_completion: the eligibility stream drew no all-zero row")
    with no_host_sync():
        card = allocation.assign_completion(card_keys, card_losses, card_elig, ALLOC_ALPHA)
    cpu = allocation.assign_completion(cpu_keys, losses, elig, ALLOC_ALPHA)
    if card.device.type != "cuda" or not torch.equal(card.cpu(), cpu):
        fail(f"assign_completion: {int((card.cpu() != cpu).sum())} of {COMPLETION_KEYS} keys "
             "differ between the card and the CPU")
    card = card.cpu().numpy()
    if not np.array_equal(card == -1, empty):
        fail("assign_completion: -1 is not exactly the all-zero rows")
    picked = card[~empty]
    if not elig[~empty][np.arange(picked.size), picked].all():
        fail("assign_completion: a client was given a task it is not eligible for")
    # one client a call, as the engines would call it: the first keys alone
    with no_host_sync():
        alone = torch.stack([allocation.assign_completion(card_keys[i], card_losses,
                                                          card_elig[i], ALLOC_ALPHA)
                             for i in range(COMPLETION_ALONE)])
    if not np.array_equal(alone.cpu().numpy(), card[:COMPLETION_ALONE]):
        fail("assign_completion: a key alone differs from its draw in the batch")
    got = out["assign_completion"]
    got["empty_rows"] = int(empty.sum())
    print(f"assign_completion: {COMPLETION_KEYS} keys in one call bit-equal with the CPU "
          f"({got['empty_rows']} all-zero rows give -1), {got['batch_ms']:.3f} ms; the first "
          f"{COMPLETION_ALONE} alone the same, {got['ms']:.3f} ms and "
          f"{got['host_us_per_call']:.1f} host us per call")
    with no_host_sync():
        card_p = allocation.selection_probability(card_losses, ALLOC_ALPHA, **SELECTION)
    cpu_p = allocation.selection_probability(losses, ALLOC_ALPHA, **SELECTION)
    rel = float(((card_p.cpu() - cpu_p).abs() / cpu_p.abs().clamp_min(1e-30)).max())
    if card_p.device.type != "cuda" or rel > SELECTION_RTOL:
        fail(f"selection_probability: card and CPU differ by {rel:.3e} relative")
    out["selection_probability"].update(max_rel_err=rel,
                                        bit_equal=bool(torch.equal(card_p.cpu(), cpu_p)))
    print(f"selection_probability: {rel:.3e} relative to the CPU "
          f"(bit-equal: {out['selection_probability']['bit_equal']}), "
          f"{out['selection_probability']['ms']:.3f} ms")

    waited = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=LINT_TIMEOUT)
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other.kill()
                other.communicate()
            fail(f"{' '.join(LINT_COMMANDS[name])}: over {LINT_TIMEOUT} s")
        if proc.returncode != 0:
            fail(f"{' '.join(LINT_COMMANDS[name])}: exit {proc.returncode}: "
                 f"{stdout[-2000:]}{stderr[-2000:]}")
        waited[name] = (stdout, time.perf_counter() - t1)
    stdout, lint_s = waited["lint"]
    last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    if not last.startswith("0 finding(s)"):
        fail(f"the linter on src/repro_torch: {stdout[-2000:]}")
    for doc in ("docs/ANALYSIS_TORCH.md", "docs/REGISTRY_TORCH.md"):
        if (ROOT / doc).read_text() != waited[doc][0]:
            fail(f"{doc} differs from its generator's output")
    out["lint"] = {"exit": 0, "summary": last, "wall_s": lint_s}
    print(f"python -m repro_torch.analysis src/repro_torch: {last} (exit 0) in {lint_s:.2f} s "
          "(beside the card checks); docs/ANALYSIS_TORCH.md and docs/REGISTRY_TORCH.md match "
          "their generators")
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 33: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import os

    # before CUDA starts: phase 27's whisper fold holds ~73 GiB of the card's
    # 79, which fits only where freed blocks can be remapped (without this
    # 7.6 GiB of free blocks were too small for one 3.03 GiB tensor)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    line = phase_card()
    errs, timed, lm = phase_kernels()
    runs = phase_slice()
    phase_card_vs_cpu(runs["fedfair"][0])
    f_err, f_ties, f_timed, f_reduce, f_lm, f_lm_reduce = phase_fused_kernel()
    async_runs = phase_async()
    phase_async_card_vs_cpu(async_runs["fedadam"][0])
    norm = phase_rmsnorm()
    flash_errs, flash_timed = phase_flash()
    params, served = phase_serve()
    loss = phase_loss(params)
    del params
    torch.cuda.empty_cache()
    gated = phase_gated()
    ssd_err, ssd_timed = phase_ssd()
    hparams, hserved = phase_hybrid_serve()
    hloss = phase_hybrid_loss(hparams)
    del hparams
    torch.cuda.empty_cache()
    sync_launches, sync_checked = phase_incentives(line)
    async_launches, async_checked = phase_robust_costs(line)
    arch_sync, arch_sync_checked, arch_sync_timed = phase_arch_sync(line)
    arch_async, arch_async_checked, arch_async_timed = phase_arch_async(line)
    population, pop_checked = phase_population(line)
    resume = phase_resume(line)
    torch.cuda.empty_cache()
    moe_served, moe_loss = phase_moe(line)
    xlstm_served, xlstm_loss = phase_xlstm(line)
    families, families_checked, tiny_checked, families_timed = phase_families_train(line)
    mla_served, mla_loss = phase_mla(line)
    audio_served, audio_loss = phase_audio(line)
    mla_audio, mla_audio_checked, mla_audio_timed = phase_mla_audio_train(line)
    vlm_served, vlm_loss = phase_vlm(line)
    vlm_train, vlm_checked, vlm_timed = phase_vlm_train(line)
    queue = phase_queue(line)
    sharded = phase_sharded(line)
    dtensor = phase_dtensor_lm(line)
    families32 = phase_dtensor_families(line)
    alloc_lint = phase_allocation_lint(line)
    fam32 = families32["families"]
    fedavg = {
        "name": "fedavg",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg.cu",
        "replaces": "src/repro/kernels/fedavg.py:43",
        "launches": runs["fedfair"][1]["fedavg"],
        "launches_async_fedavg": async_runs["fedavg"][1]["fedavg"],
        # phases 16-17: each run's fedavg launches (0 for the robust rules)
        "launches_incentives": {k: v.get("fedavg", 0) for k, v in sync_launches.items()},
        "launches_robust_costs": {k: v.get("fedavg", 0) for k, v in async_launches.items()},
        # phase 18: one per non-empty fold of the tau 2 LM task
        "launches_arch_sync": arch_sync["launches"]["fedavg"],
        # phases 20-21: the 100,000-client vmap run's folds (at the cohort's
        # K), the folds after the sync quickstart's and the LM run's resume
        "launches_population": population["sync vmap"]["launches"]["fedavg"],
        "launches_resume_sync": resume["sync"]["launches_after_resume"]["fedavg"],
        "launches_resume_lm": resume["lm"]["launches_after_resume"].get("fedavg", 0),
        # phase 24: one per non-empty fold of the tau 2 smollm task of the
        # example's three-task mix, and of the tiny mix's tau 2 tasks
        "launches_families_sync": families["launches"]["fedavg"],
        "launches_families_tiny_sync": families["tiny_sync_launches"]["fedavg"],
        # phase 27: one per non-empty fold of whisper-medium's tau 2 task
        # (at its 811.9 M params) and of the tiny deepseek/whisper mix
        "launches_mla_audio_sync": mla_audio["launches"]["fedavg"],
        "launches_mla_audio_tiny_sync": mla_audio["tiny_sync_launches"]["fedavg"],
        # phase 29: one per non-empty fold of phi-3's tau 2 run (4 layers)
        # and of the tiny phi-3/smollm pair's
        "launches_phi3_sync": vlm_train["fold"]["launches"]["fedavg"],
        "launches_phi3_tiny_sync": vlm_train["tiny_sync_launches"]["fedavg"],
        # phase 31 (a): the quickstart sync run on each cohort mesh, one
        # per non-empty fold as on vmap
        "launches_sharded_sync": {k: r["launches"]["fedavg"]
                                  for k, r in sharded["sync"].items()},
        "max_abs_err": max(errs["float32"], sharded["sync"]["sharded x3"]["max_abs_err"],
                           sync_checked["fedavg"], async_checked["fedavg"],
                           arch_sync_checked["fedavg"], pop_checked["fedavg"],
                           families_checked["fedavg"], tiny_checked["fedavg"],
                           mla_audio_checked["fedavg"], vlm_checked["fedavg"]),
        "max_abs_err_bf16": errs["bfloat16"],
        # phases 16-18, 20 and 24: the (K, N) folds those runs made, each
        # held against ref_fedavg after the runs
        "run_shapes_checked": (sync_checked["fedavg_shapes"] + async_checked["fedavg_shapes"]
                               + arch_sync_checked["fedavg_shapes"]
                               + pop_checked["fedavg_shapes"]
                               + families_checked["fedavg_shapes"]
                               + tiny_checked["fedavg_shapes"]
                               + mla_audio_checked["fedavg_shapes"]
                               + vlm_checked["fedavg_shapes"]),
        "shape": list(TIMED_MAIN),
        "dtype": "float32",
        **timed[TIMED_MAIN],
        "async_flush": {"shape": list(FUSED_TIMED), **timed[FUSED_TIMED]},
        "lm_scale": {"shape": [LM_K, LM_N], **lm},
        "arch_sync_folds": arch_sync_timed,
        "families_sync_folds": families_timed,
        "mla_audio_folds": [r for r in mla_audio_timed if r["kernel"] == "fedavg"],
        "phi3_folds": [r for r in vlm_timed if r["kernel"] == "fedavg"],
    }
    fused = {
        "name": "fused_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_aggregate.cu",
        "replaces": "src/repro/kernels/fedavg.py:145",
        "launches": async_runs["fedadam"][1]["fused_aggregate"],
        "launches_lognormal_fedadam": async_launches["fedadam-lognormal"]["fused_aggregate"],
        # phase 19: one per flush of the two LM tasks
        "launches_arch_async": arch_async["launches"]["fused_aggregate"],
        # phases 20-21: the 100,000-client async run's flushes, and the
        # flushes after the async resume (from restored moments)
        "launches_population_async": population["async vmap fedadam"]["launches"][
            "fused_aggregate"],
        "launches_resume_async": resume["async"]["launches_after_resume"]["fused_aggregate"],
        # phase 24: one per flush of the tiny three-task mix's async fedadam run
        "launches_families_tiny_async": families["tiny_async_launches"]["fused_aggregate"],
        # phase 27: one per flush of whisper-medium's async fedadam run and of
        # the tiny deepseek/whisper mix's
        "launches_whisper_async": mla_audio["async"]["launches"]["fused_aggregate"],
        "launches_mla_audio_tiny_async": mla_audio["tiny_async_launches"]["fused_aggregate"],
        # phase 29: one per flush of phi-3's async fedadam run (4 layers) and
        # of the tiny phi-3/smollm pair's
        "launches_phi3_async": vlm_train["async"]["launches"]["fused_aggregate"],
        "launches_phi3_tiny_async": vlm_train["tiny_async_launches"]["fused_aggregate"],
        # phase 31 (a): exp13's fedadam run on each cohort mesh, one per flush
        "launches_sharded_async": {k: r["launches"]["fused_aggregate"]
                                   for k, r in sharded["async"].items()},
        "max_abs_err": max(f_err, sharded["async"]["sharded x3"]["max_abs_err"],
                           async_checked["fused_aggregate"],
                           arch_async_checked["fused_aggregate"], pop_checked["fused_aggregate"],
                           tiny_checked["fused_aggregate"], mla_audio_checked["fused_aggregate"],
                           vlm_checked["fused_aggregate"]),
        "run_shapes_checked": (async_checked["fused_shapes"] + arch_async_checked["fused_shapes"]
                               + pop_checked["fused_shapes"] + tiny_checked["fused_shapes"]
                               + mla_audio_checked["fused_shapes"]
                               + vlm_checked["fused_shapes"]),
        "yogi_ties": f_ties,
        "mode": "fedadam",
        "shape": list(FUSED_TIMED),
        "dtype": "float32",
        **f_timed["fedadam"],
        # no single PyTorch call computes the fused flush; disc @ x is the
        # reduce alone, without the discount and the moment update
        "library_ms": None,
        "reduce_only_ms": f_reduce[0],
        "eager_reduce_only_ms": f_reduce[1],
        "modes": f_timed,
        "lm_scale": {"shape": [LM_K, LM_N], "reduce_only_ms": f_lm_reduce, **f_lm},
        "arch_async_flushes": arch_async_timed,
        "whisper_async_flushes": [r for r in mla_audio_timed if r["kernel"] == "fused_aggregate"],
        "phi3_async_flushes": [r for r in vlm_timed if r["kernel"] == "fused_aggregate"],
    }
    flash = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:74",
        "launches": loss["launches"]["flash_attention"],
        "launches_zamba2_loss": hloss["launches"]["flash_attention"],
        "launches_qwen2_moe_loss": moe_loss["launches"]["flash_attention"],
        # phase 28: phi-3-vision's use_pallas loss, hd 96, one per layer
        "launches_phi3_loss": vlm_loss["launches"]["flash_attention"],
        # phase 31 (b): qwen3-0.6b's use_pallas loss on DTensors, one per layer
        "launches_dtensor_loss": dtensor["loss_use_pallas"]["launches"]["flash_attention"],
        # phase 32 (a): the use_pallas loss on DTensors of a (1, 1) mesh, per forward
        "launches_dtensor_families": {k: r["loss_use_pallas"]["launches"].get(
            "flash_attention", 0) for k, r in fam32.items()},
        "max_abs_err": flash_errs["float32"],
        "max_abs_err_bf16": flash_errs["bfloat16"],
        "shape": list(FLASH_SHAPES[0]),
        "causal": True,
        "dtype": "float32",
        **flash_timed[FLASH_SHAPES[0], "float32"],
        "bf16": flash_timed[FLASH_SHAPES[0], "bfloat16"],
        "zamba2_hd112": {"shape": list(FLASH_ZAMBA), "float32": flash_timed[FLASH_ZAMBA, "float32"],
                         "bf16": flash_timed[FLASH_ZAMBA, "bfloat16"]},
        "qwen2_moe_hd128": {"shape": list(FLASH_MOE), "float32": flash_timed[FLASH_MOE, "float32"],
                            "bf16": flash_timed[FLASH_MOE, "bfloat16"]},
        "phi3_hd96": {"shape": list(FLASH_VLM), "float32": flash_timed[FLASH_VLM, "float32"],
                      "bf16": flash_timed[FLASH_VLM, "bfloat16"]},
    }
    rms = {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:39",
        "launches": served["rmsnorm_launches"],
        "launches_loss": loss["launches"]["rmsnorm"],
        "launches_zamba2_serve": hserved["launches"]["rmsnorm"],
        "launches_zamba2_loss": hloss["launches"]["rmsnorm"],
        # phases 18-19: the training runs (forwards of the steps and the
        # eval probes) and one training step of each LM alone
        "launches_arch_sync": arch_sync["launches"]["rmsnorm"],
        "launches_arch_async": arch_async["launches"]["rmsnorm"],
        "launches_per_training_step": arch_sync["rmsnorm_per_training_step"],
        # phase 21 (c): the LM run after its resume
        "launches_resume_lm": resume["lm"]["launches_after_resume"]["rmsnorm"],
        # phases 22-24: serving (per prefill and per decode step) and the loss
        # of qwen2-moe and xlstm, the three-task training run and one
        # training step of each of its tasks
        "launches_qwen2_moe_serve": moe_served["launches"]["rmsnorm"],
        "launches_qwen2_moe_loss": moe_loss["launches"]["rmsnorm"],
        "launches_xlstm_serve": xlstm_served["launches"]["rmsnorm"],
        "launches_xlstm_loss": xlstm_loss["launches"]["rmsnorm"],
        "launches_families_sync": families["launches"]["rmsnorm"],
        "launches_per_training_step_families": {
            a: r["rmsnorm_per_training_step"] for a, r in families["tasks"].items()},
        # phases 25 and 27: deepseek-v2-lite serving (per prefill and per
        # decode step, either decode setting) and its loss, 82 a forward;
        # the deepseek/whisper training run (whisper launches none)
        "launches_deepseek_serve": mla_served["serve_expand"]["launches"]["rmsnorm"],
        "launches_deepseek_serve_absorb": mla_served["serve_absorb"]["launches"]["rmsnorm"],
        "launches_deepseek_loss": mla_loss["launches"]["rmsnorm"],
        "launches_mla_audio_sync": mla_audio["launches"]["rmsnorm"],
        # phases 28-30: phi-3-vision serving (per prefill and per decode
        # step) and its loss, 65 a forward; its three training runs; the
        # queue's timed runs
        "launches_phi3_serve": vlm_served["launches"]["rmsnorm"],
        "launches_phi3_loss": vlm_loss["launches"]["rmsnorm"],
        "launches_phi3_train": {k: vlm_train[k]["launches"]["rmsnorm"]
                                for k in ("adamw", "fold", "async")},
        "launches_phi3_per_training_step": {k: vlm_train[k]["rmsnorm_per_training_step"]
                                            for k in ("adamw", "fold")},
        # phase 31 (b): qwen3-0.6b on DTensors, per forward (28 x 4 + 1)
        # and in the forward of one AdamW step
        "launches_dtensor_loss": dtensor["loss"]["launches"]["rmsnorm"],
        "launches_dtensor_step": dtensor["step"]["launches"]["rmsnorm"],
        # phase 32 (a): each family's loss on DTensors, per forward
        "launches_dtensor_families": {k: r["loss"]["launches"].get("rmsnorm", 0)
                                      for k, r in fam32.items()},
        "launches_queue": {f"{kind} {arch}": r["launches"]["rmsnorm"]
                           for arch, by in queue.items() for kind, r in by.items()
                           if kind != "params"},
        **norm,
    }
    gated_rec = {
        "name": "gated_rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gated_rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:63",
        "launches": hserved["launches"]["gated_rmsnorm"],
        "launches_loss": hloss["launches"]["gated_rmsnorm"],
        # phase 32 (a): zamba2's use_pallas loss on DTensors, on the local shards
        "launches_dtensor_loss": fam32["zamba2-7b"]["loss_use_pallas"]["launches"]["gated_rmsnorm"],
        **gated,
    }
    ssd = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:64",
        "launches": hserved["launches"]["ssd_scan"],
        "launches_loss": hloss["launches"]["ssd_scan"],
        "launches_dtensor_loss": fam32["zamba2-7b"]["loss_use_pallas"]["launches"]["ssd_scan"],
        "max_abs_err": ssd_err,
        **ssd_timed["loss"],
        "serve_prefill": ssd_timed["serve"],
    }
    print(json.dumps({"serve": served, "loss": loss, "zamba2_serve": hserved,
                      "zamba2_loss": hloss}))
    print(json.dumps({"arch_sync": arch_sync, "arch_async": arch_async}))
    print(json.dumps({"population": population, "resume": resume}))
    print(json.dumps({"qwen2_moe_serve": moe_served, "qwen2_moe_loss": moe_loss,
                      "xlstm_serve": xlstm_served, "xlstm_loss": xlstm_loss,
                      "families_sync": families}))
    print(json.dumps({"deepseek_v2_lite": mla_served, "deepseek_v2_lite_loss": mla_loss,
                      "whisper_medium": audio_served, "whisper_medium_loss": audio_loss,
                      "mla_audio_train": mla_audio}))
    print(json.dumps({"phi3_vision": vlm_served, "phi3_vision_loss": vlm_loss,
                      "phi3_vision_train": vlm_train, "queue": queue}))
    print(json.dumps({"sharded": sharded, "dtensor_lm": dtensor}))
    print(json.dumps({"dtensor_families": families32}))
    print(json.dumps({"allocation_lint": alloc_lint}))
    print(json.dumps({"kernels": [fedavg, fused, flash, rms, gated_rec, ssd]}))
    print(f"card: {line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
