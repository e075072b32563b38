#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failed check exits non-zero:

1. the card's name and power limit (``nvidia-smi``), and the build of every
   Hopper kernel from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a;
2. K1 (paged decode) against its plain PyTorch version at full-width
   qwen2-0.5b shapes: B=8, 2 KV heads, 7 query heads each, head dim 64,
   16-token pages, ragged positions up to 2047 over shuffled page tables
   (1023 and 1024 on both sides of a 256-key split boundary); and each
   request alone, whose rows must equal its rows in the batch bit for bit;
3. K2 (ragged prefill) the same way: 256-token chunks starting at
   0, 256, ..., 1792; and the same chunks cut in two at token 96, whose
   rows must equal the one-chunk rows bit for bit;
4. K3 (speculative verify) the same way: B=8, Q=5 queries per row (four
   drafts), positions up to 2043, ragged live-query counts 1..5 and idle
   rows (pos 0, null table); and K3 with one live query per row against
   K1 on the same inputs, bit for bit, and each request alone against its
   rows in the batch, bit for bit;
5. the int8 modes of K1, K2 and K3 against their plain versions, on pools
   quantized from the same bf16 data by the port's ``quantize_int8``
   (K2-int8 with phase 3's chunk split, bit for bit);
6. the port's main path: full-width qwen2-0.5b (24 layers, random weights
   from ``--seed``) served by the continuous-batching engine on the
   ``hopper`` backend — 8 requests of 128 to 1024 prompt tokens sharing a
   64-token prefix, prefix cache on, 256-token prefill chunks, 32 new
   tokens each — with the kernels' launch counts read around that run
   alone; then the same requests on the ``reference`` backend, and both
   held to the dual gate along the hopper run's tokens.  A rerun of the
   hopper requests under ``torch.profiler`` prints the device's busy share
   and top kernels;
7. speculative serving of the same requests (``speculate_tokens=4``,
   hopper): (a) with the n-gram proposer users run, (b) with an oracle
   proposer drafting the non-speculative run's own tokens, so that rows
   of up to five live queries and accepted drafts really run; each held
   to the dual gate, each with K3 launched 24 times a verify step and K1
   never;
8. int8 pages (``kv_dtype="int8"``, hopper) without and with speculation,
   each held to the dual gate against the int8 reference replay, with the
   quantization error against the bf16 reference replay printed;
9. at full-width starcoder2-7b shapes (4 KV x 9 query heads of 128,
   16-token pages, a 4096-token window: 257-page rings, 258 with the
   speculation slack page), bf16 and int8: K4 (sliding-window prefill) on
   4 chunks of 256 at starts 0, 3840, 4352 and 5888 (one with 200 live
   tokens); K1 in ring mode at positions up to 6100; K3 in ring mode with
   Q=5 and live queries 1..5, and at one live query against K1-ring bit
   for bit; and K1-ring, K3-ring and K4, bf16 and int8, on one window of
   K/V laid out in a 257-page and in a 258-page ring at positions past the
   wrap, bit for bit (the ring kernels sum in the order of absolute
   positions, so the ring's length changes nothing);
10. the sliding-window path: full-width starcoder2-7b, its depth cut to 2
   of 32 layers (the whole smoke, phase 24 included, must stay within
   the call's limit on a slow host; random weights from
   ``--seed``) on the hopper backend, 4 requests of
   1024, 3072, 4608 and 6144 prompt tokens, 256-token chunks, 32 new
   tokens, prefix cache requested (and refused: a page ring is not
   cacheable): bf16 (K4 and K1-ring, counted), K = 4 n-gram speculation
   (K3-ring), int8 pages and int8 with speculation, each held to the
   reference replay along its own tokens by the dual gate and counted
   against the bf16 run; each speculative stream must equal the plain
   stream of its pool dtype token for token;
11. K2 at head dim 128 (minitron-4b: 8 KV x 3 query heads of 128, the 8
   chunks of phase 3), bf16 and int8, each with phase 3's chunk split; K3
   in ring mode at command-r-plus-104b shapes (8 KV x 12 query heads of
   128: Q=5 is 60 rows per (request, KV head), split over two blocks),
   B=4 at positions up to 6000, bf16 and
   int8, and at one live query against K1-ring bit for bit; K8 (the RBM's
   fused GEMM + sigmoid) at every layer's positive, negative and
   forward-propagation shapes of mnist-dbn, fp32 within 1e-5, layer 0's
   positive phase in bf16, and Fig. 8's CD job ([2048, 784] x [784, 512]
   and [2048, 512] x W.T, fp32), each with a second call equal bit for
   bit and rows computed alone equal to theirs in the batch;
12. full-width minitron-4b, its depth cut to 2 of 32 layers (to keep the
   smoke under the call's limit on a slow host, where phases 21, 22 and
   24 add up to ~400 s), served as phase 6 serves qwen2-0.5b (K2 at D=128 for
   every prefill chunk, a profiled rerun with K2's share of the device
   time), bf16 and int8, each held to the dual gate;
13. command-r-plus-104b at full width, its depth cut to 2 of 64 layers
   (full depth is ~210 GB): phase 10's four runs, the speculative ones
   through K3's 60-row ring mode; gate 1 of its dual gates holds each
   token's logits within 2 bf16 ulps of that row's largest |logit| (its
   random logits lie near 32 to 64, where one ulp is 0.25), and the
   speculative streams again equal the plain ones;
14. the paper's path: full-width mnist-dbn (784-1000-500-250-30) on 60000
   synthetic digits, one CD-1 epoch per RBM (batch 100) through K8 (3
   launches a CD step, 1 a layer's forward-propagation job), one epoch of
   autoencoder and one of classifier fine-tuning (the reconstruction error
   must fall, the test error beat chance), the CD samples that flip
   between K8 and its plain version, and a fine-tuning step through
   ``core.mapreduce`` over NCCL at world size 1 equal to the plain step
   bit for bit;
15. K5 (MLA latent decode), K6 (MLA chunk prefill) and K7 (MLA latent
   verify) against their plain versions at full-width deepseek-v2 shapes
   (128 heads, a 512-wide latent and 64-wide rope key, 16-token pages),
   bf16 and int8 (pools quantized from the same bf16 data by
   ``quantize_int8``): K5 at B=8, ragged positions up to 2047 over
   shuffled tables and two idle rows, each request alone equal to its
   rows in the batch bit for bit; K6 on 8 chunks of 256 at starts 0,
   256, ..., 1792, the last with 200 live tokens (its padding rows
   computed), each request alone equal to its rows in the batch bit for
   bit, and K6's stage A (every key's K/V built once, ``mla_build_kv``)
   against its plain version, bf16 K/V bit for bit; K7 at B=8, Q=5,
   positions up to 2043, live-query counts 1..5 and two idle rows, its
   dead rows exact zeros, at one live query against K5 and each request
   alone against its rows in the batch, bit for bit; K5 and K7 with the
   device time a call of each of their CUDA kernels (split and merge) and
   the bound of the products they issue (PV's doubled);
16. the MLA + MoE path: deepseek-v2-236b at full width, its depth cut to
   2 of 60 layers (layer 0 dense, 1 MoE; full depth is ~470 GB of bf16
   weights; 2 rather than 4 for the smoke's time), served as phase 6
   serves qwen2-0.5b (K6 and its stage A for every prefill chunk, K5 for
   every decode step, counted), with the
   device's busy share from a profiled rerun, then on the reference
   backend, and held to the reference replay by the dual gate; then K = 4
   speculation with n-gram and oracle drafts (K7 four times a verify step,
   K5 never), int8 latent pages (K5-int8, K6-int8) and int8 with
   speculation (K7-int8), each held to the reference replay of its pool
   dtype by the dual gate.

17. K9 (the causal GQA flash attention of the training forward) against
   its plain version at full-width qwen2-0.5b's training shape (B 8, S
   1024, 14 / 2 heads of 64) causal in bf16, the same full (causal=False)
   and in fp32, and minitron-4b's heads (24 / 8 of 128) causal in bf16,
   each timed beside ``scaled_dot_product_attention`` on K/V repeated to
   the query heads, with the bound of the function (4 D flops a pair)
   and that of the tensor-core body's two-term PV (6 D); bit for bit, each
   request alone against its rows in the batch, and the causal rows
   0..999 of a call at S = 1000 against those at S = 1024 on the same
   inputs; the ``ptxas`` lines of its library; and its differentiable
   form's gradients against autograd through the plain version in fp32
   (relative L2 within 1e-5);
18. the training path: full-width, full-depth qwen2-0.5b (random weights
   from ``--seed``, AdamW at 3e-4 with linear warmup and cosine) on
   ``token_batches(vocab, 8, 1024)``: (a) 20 steps on the hopper backend,
   K9 launched 24 times a step, the mean loss of the last 5 steps below
   that of the first 5, with step time, tokens/s, peak memory and, from a
   profiled 3-step rerun, the device's busy share and K9's share of the
   device time; (b) one step's loss and
   gradients on hopper and on reference at B 2 (the reference keeps every
   layer's fp32 probabilities for its backward), |dloss| within 0.01 and
   every leaf's gradient within 0.1 relative L2 (K9 keeps p in fp32 where
   the chunked attention rounds it to bf16; on the CPU at 4 layers the
   two part by 3e-4 and 0.016); (c) one mapreduce step over NCCL at world
   size 1 equal to the pjit step bit for bit; (d) a checkpoint at step 2
   and a resume (2 of 24 layers: the checkpoint holds the 136M-entry
   embedding's fp32 master and moments) whose loss history and final
   state equal an uninterrupted run's bit for bit.

19. the paper's experiments (run right after phase 14), through their
   entry points at mnist-dbn's full width on 60000 / 10000 synthetic
   digits: Fig. 6 (``launch/fig6_unsup_error.py``: 3 CD-1 epochs a layer
   at batch 128, autoencoder fine-tuning cut from 8 to 3 epochs; the test
   reconstruction error must fall), Fig. 7 (``fig7_sup_error.py``, cut
   from 25 to 5 epochs; the test error below chance, 0.9), AdaBoost
   (``core/adaboost.py``, ``BoostConfig()``; a learner kept, the test
   error below 0.9), Fig. 8 (``fig8_scaling.py``: one worker process on
   NCCL, 11 CD jobs of 784 x 512 on 2048 rows) and the two demos
   (``examples/train_{classifier,autoencoder}_torch.py``), each CSV row
   printed and K8's launches on each path held to 3 a CD step + 1 a
   layer's forward-propagation job (AdaBoost: 0; Fig. 8's worker reports
   its own).

20. the streaming front end, overload control and fault injection (run
   right after phase 6, on its weights and its 8 requests, hopper
   backend): (a) ``run_offline(overlap=True)`` (``Engine.pump()``: step
   N+1's plan staged while step N runs) against ``run_offline()`` on a
   fresh engine, tokens bit for bit, plans staged and used (used + dropped
   = staged), every ``_stage_next`` call under
   ``torch.cuda.set_sync_debug_mode("error")`` (nothing in staging may
   wait for the stream), with both loops' decode step p50 and tokens/s and
   the host pipeline's dispatch / stage / collect sums
   (``launch.trace_report.host_pipeline``); (b) ``launch.serve_http``'s
   smoke in this process on an ephemeral port over phase 6's weights: 8
   SSE streams of up to 256 prompt tokens, each index exactly once and in
   order, the streamed tokens those of the ``done`` frame and held to the
   reference replay by the dual gate, ``/metrics``, a 24-client burst
   with deadlines that must draw 503s with ``Retry-After``, and ``/health``
   walking starting, healthy, draining, drained; (c) faults on phase 6's
   workload (admitted one request a prefill by the 256-token chunk
   budget, in an order the faults do not change: 8 requests in 8 slots
   and a pool with room for all), bf16 and int8 pages: ``nan_logits``,
   ``step_error`` and ``client_disconnect`` on three requests, each target
   ending with its reason (the poisoned row's finite flag False through
   K1, K1-int8) and every survivor's tokens equal to the fault-free run's
   of its pool dtype bit for bit; then ``pool_pressure`` (hostage pages
   that force a preemption), every request surviving, held to the
   reference replay by the dual gate.  K1's and K2's launches over the
   phase must be positive.

21. the state-slot families (no kernel on their path): full-width
   mamba2-780m cut to 12 of its 48 SSD layers (d 1536; the smoke's time)
   on phase 6's 8
   requests (the prefix cache refused with a warning) and
   recurrentgemma-2b (8 x (RG-LRU, RG-LRU, local attention) + 2 RG-LRU
   layers, d 2560) on 4 prompts of 1500, 2040, 2100 and 3000 tokens
   straddling its 2048-token window, so that its ring wraps in a prefill
   and during decode, 32 new tokens each, random weights from ``--seed``,
   hopper backend: (a) the engine's own logits (a rerun, which must give
   the same tokens, records them) held to single-request replays
   (``replay_logits``) by the dual gate, and the tokens equal to the
   static single-request baseline's counted; (b) the requests of slots 0
   and 1 preempted mid-decode (checkpointed to host memory) and restored
   into each other's slots, every stream equal to the un-preempted run's
   bit for bit (decode runs at the fixed [max_slots] shape); (c)
   ``nan_logits`` on request 1 through its state row: it ends with its
   reason, every survivor equals the fault-free run bit for bit; (d)
   tokens/s, decode step p50, TTFT p50, the device's busy share (a
   profiled rerun), peak memory and state bytes a slot, beside the card's
   name and power limit, and the launches of K1-K9 over the phase (none
   is expected: the JAX package runs no Pallas kernel there either).

22. the frontend-conditioned families (run before 23), random weights from
   ``--seed``, hopper backend: (a) at their new shapes, each against its
   plain version, timed beside SDPA with its bound: K1 and K2, bf16 and
   int8, at seamless-m4t's 16 KV heads of 64 with one query head each
   (G = 1; K2's chunk split at token 96, not a multiple of 64, bit for
   bit), K1, K2 and K3 at llava's 8 KV x 7 query heads of 128, and K9 in
   its full mode at the encoder's shape (B 2, S 4096, 16 / 16 heads of
   64); (b) full-width seamless-m4t-large-v2 cut to 6 of its 24 encoder
   and 6 of its 24 decoder layers (the smoke's time) on 8 requests of
   32..512 decoder prompt tokens, each conditioned on 4096 frames
   (``enc_len``), 128-token chunks, 32 new tokens, bf16 then int8 pages:
   K1 a decode step a layer, K2 a prefill step a layer, K9 an encoder
   layer a first-chunk prefill (continuation chunks run no encoder),
   16,777,216 B of cross K/V a slot a decoder layer, and the
   engine's logits (recorded in the run, one device-to-host copy a step)
   held to single-request reference replays of its pool dtype by the dual
   gate;
   (c) full-width llava-next-34b cut to 8 of 60 layers on 4 requests of
   576 image + 64..512 text tokens (prefix cache asked for and refused,
   a 256-token chunk budget that never chunks), 32 new tokens: bf16, gated
   the same way, then speculation at K = 4 with n-gram and with oracle
   drafts (K3 a verify step a layer, K1 never), each stream equal to the
   plain stream bit for bit.  tok/s, TTFT p50 and decode step p50 of each
   run, and the device's busy share of a rerun of the bf16 runs traced on
   the device alone (their ~10^5 host ops a rerun take the profiler
   minutes to record).

23. the training forward of the last four families (run last), random
   weights from ``--seed``: (c) K9 at their training shapes against its
   plain version (``flash_case``): causal at llava's 56 / 8 heads of 128
   over S 1088 (576 image + 512 text positions), full at the seamless
   encoder's 16 / 16 heads of 64 over S 512, causal at its decoder's; (b)
   one step's loss and gradients from the same parameters and batch:
   seamless-m4t-large-v2 and llava-next-34b (2 of 60 layers) on hopper
   against reference, |dloss| within 0.01 and every leaf within 0.1
   relative L2 (phase 18's bounds; the cross-attention's key bias, whose
   gradient is zero in exact arithmetic, within 0.01 of the query bias's
   norm instead), seamless gated at 6 + 6 layers; at its full depth the
   two bf16 runs are printed, and a witness holds both against the
   reference in fp32: hopper no further from it than 1.25x the bf16
   reference, at the median and the worst leaf (the reference with its
   cores' probabilities kept in fp32, as K9 keeps them, printed beside);
   mamba2-780m (2 layers) and recurrentgemma-2b (3, one local-attention
   layer), whose two backends run the same ops, in fp32 on the card
   against the CPU at B 1, S 128, within 1e-4 and 1e-3;
   (a) 3 AdamW steps of each family through ``make_train_step(...,
   attn_backend="hopper")`` on 3 batches of B 2, S 512 text tokens,
   frames [2, 512, 1024] for seamless and 576 image embeddings for llava,
   drawn with numpy from ``--seed``: mamba2-780m and seamless-m4t at full
   depth, recurrentgemma-2b at 8 of 26 layers and llava at 2 of 60 (the
   depth cuts are for memory: the
   out-of-place AdamW step holds two optimizer states, ~32 B a
   parameter), every loss finite, with step time, tokens/s and peak
   memory, and K9's launches by mode counted around each run: full D 64
   once an encoder layer a step and causal D 64 once a decoder layer
   (seamless), causal D 128 once a layer (llava), none for the other
   two.  The K9-full entry adds the encoder's launches, the K9-D128 entry
   counts llava's and the K9-G1 entry the seamless decoder's.
24. the attention logit softcap (run last; every scaled score becomes c *
   tanh(s / c) before the mask): (a) K1, K1-int8, K1-ring(-int8), K2,
   K2-int8, K2-D128, K3, K3-ring(-int8), K4 and K4-int8 in their softcap
   mode at c = 50 (Gemma 2's, arXiv:2408.00118) against their plain
   versions, with the shapes and checks of phases 2-9, beside the same
   calls at c = 0, and in a saturating case (queries x 64: the largest
   visible |s| at least 3c); their ``library_ms`` is one compiled
   ``flex_attention`` call with a tanh ``score_mod`` and the same mask,
   held to the capped attend in fp32 (SDPA has no softcap; its uncapped
   time is kept as ``sdpa_uncapped_ms``); (b) full-width, full-depth
   qwen2-0.5b capped, wq drawn at the gain that gives pre-cap scores of
   std ``CAP_SCORE_SD`` (random weights give 0.008 at full depth, where
   no cap acts): a witness serves 4 of phase 6's prompts uncapped and
   replays their tokens capped at 50, 30, 20, 10, 5 in turn, taking the
   first cap that moves a logit by more than 4 x the gate's 0.25; at that
   cap ``phase_serve`` (K1, K2), ``phase_speculate`` (K3) and
   ``phase_int8_serve`` without speculation on those prompts; (e) its
   training: one step's loss and gradients on hopper against reference,
   3 AdamW steps at B 2, S 512, K9 launched no time (the capped layers
   take the chunked core, as JAX trains them); (c) minitron-4b cut to 2
   layers through ``phase_serve`` (K2 at head dim 128); (d)
   starcoder2-7b as phase 10 through ``phase_window_serve`` at the cap
   (K4, K1 and K3 in ring mode); (f) c = 50 at pre-cap std
   ``CAP_GAP_SD``, where it moves the logits (``cap_gap``): qwen2-0.5b
   served at c = 0 and at 50; along each run's tokens every K1/K2 call
   of a hopper replay held to its plain version on the model's own
   inputs, the dual gate against the reference replay printed (peaked
   attention at full depth spreads bf16 runs beyond it, capped or not),
   and hopper's distance from a replay with fp32 parameters held within
   ``CAP_GAP_RATIO`` x the bf16 reference's.
25. the dry run against the card (run last, no new step, seconds):
   ``repro_torch.launch.dryrun.dryrun_cell`` plans qwen2-0.5b on ``meta``
   at phase 18's training shape (B 8, S 1024, AdamW) and a static decode
   step at phase 6's batch (8 rows over its 1056-token ``max_len``), on
   the one-process mesh; each plan's live bytes beside the card's
   ``max_memory_allocated`` (phase 18's steps; phase 6's hopper serve),
   two step lower bounds beside the measured step p50 (the traced
   reference path's under ``hlo_cost``'s byte rule, and the least: model
   FLOPs and the bytes the step must move), and the model-FLOPs share of
   the bf16 peak, with the card's name and power limit.  Fails if a
   roofline share reads over 1.0 (a bound above the measured time is a
   wrong count) or a planned live size lies outside 0.5-2x the measured
   peak.

In phases 7, 10, 13 and 16 a verify step's rows must equal decode steps
at ``pos + j`` bit for bit, and in 10, 13 and 16 every speculative stream
must equal the plain stream of its pool dtype.

Each attention kernel, and K8 in bf16, is held to its plain version,
element by element, within one
bf16 ulp of the largest magnitude in the element's row (one head of one
token, head-dim values), never below 2^-14.  Both take fp32 scores and sums
of the same bf16 operands in another order; where two such sums differ in
their last bit, a probability can round to its other bf16 neighbour, which
moves the whole row by up to an ulp of its larger terms, so an element that
cancels to near 0 cannot be held to its own ulp.  Times are CUDA-event medians with the 50 MB L2
flushed before every launch (in serving, the other 23 layers' weights and
pages pass through L2 between two calls of one layer) and the stream held
by a ~0.1 ms device spin meanwhile, so that the host's enqueue of a call
is not timed (without it, a call shorter on the device than its wrapper
on the host reads as the host's time).  ``bound_ms`` is the
larger of the bytes the function must move over 3.35 TB/s and its
operations over 989 TFLOP/s (H100 SXM bf16 dense; the rates are
``repro_torch.launch.mesh``'s), counted for this run's
inputs (K9 in fp32: over 67 TFLOP/s, the H100's fp32 rate without
tensor cores; K8 in fp32: the lesser of that and its three TF32 terms
over 495 TFLOP/s, the TF32 tensor cores' rate; K6's stage A with bf16
pages, whose K/V are fp64 sums: over 67 TFLOP/s, the fp64 tensor cores'
rate).  ``library_ms`` times
``scaled_dot_product_attention`` on the gathered K/V (dequantized to bf16
for int8 pools; with the verify mask for K3; for K9 on K/V repeated to
the query heads, ``is_causal``), one einsum of the gathered latent with
``wkv_b`` for K6's stage A, and ``sigmoid(addmm)`` for K8, as a
yardstick; the port never calls any of them.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the H100's rates: one definition, the port's launch/mesh.py (without the
# repository beside the script this import fails, and so does the script)
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S,
    PEAK_FLOPS_FP32 as FP32_FLOPS_PER_S,
    PEAK_FLOPS_TF32 as TF32_FLOPS_PER_S)
L2_FLUSH_BYTES = 64 << 20      # > the H100's 50 MB L2
CAP_OPS = 3                    # the softcap's fp32 ops a score: /, tanh, *
LOGIT_TOL = 0.25               # dual-gate bound on max |dlogit|
LOGIT_ROW_ULPS = 2.0           # command-r's bound, in bf16 ulps of the row
K8_TOL = 1e-5                  # K8 vs plain in fp32 (another sum order)
CLASSIFIER_LR = 1.0            # examples/quickstart.py's fine-tuning rate
ULP_FLOOR = 2.0 ** -14         # least kernel-vs-plain bound (ulp at ~0.01)
FLEX_ROW_ULPS = 4.0            # flex_attention's yardstick vs fp32, row ulps

MINITRON_LAYERS = 2            # of 32: phase 12's depth cut
STARCODER_LAYERS = 2           # of 32: phase 10's depth cut
CR_LAYERS = 2                  # of 64: phase 13's depth cut

# the main path's workload: 8 requests of 128..1024 prompt tokens sharing a
# 64-token prefix, 16-token pages, 256-token prefill chunks, 32 new tokens
N_REQUESTS, PREFIX, PROMPT_LO, PROMPT_HI = 8, 64, 128, 1024
PAGE, CHUNK, GEN_TOKENS = 16, 256, 32


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Timer:
    """Median CUDA-event time of a callable, L2 flushed before each run.
    A device-side spin of ``HOLD_CYCLES`` after the flush keeps the stream
    busy while the host enqueues the call, so a call whose wrapper takes
    longer on the host than its kernels on the device is timed by its
    kernels, not by the host."""

    HOLD_CYCLES = 200_000          # ~0.1 ms at the H100's 1.98 GHz

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound(nbytes: float, flops: float, capped_scores: int = 0):
    """(least ms, what bounds it) of ``nbytes`` moved and ``flops`` on the
    bf16 tensor cores; ``capped_scores``: the logit softcap's fp32 work
    beside them, a division, a tanh and a product (``CAP_OPS``) a score,
    over the fp32 rate of the units outside the tensor cores."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / BF16_FLOPS_PER_S,
                capped_scores * CAP_OPS / FP32_FLOPS_PER_S) * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations")


def paged_pool(torch, rng, lengths, K, D, ps, width):
    """Random bf16 pages for requests of ``lengths`` tokens, each request's
    pages drawn from a shuffled pool; table entries past a request's pages
    point at the null page 0.  Returns (k_pages, v_pages, tables [B, width]
    int32)."""
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = torch.zeros((len(lengths), width), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = torch.as_tensor(perm[at:at + n])
        at += n
    gen = torch.Generator(device="cuda").manual_seed(1)
    k = torch.randn((P, ps, K, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((P, ps, K, D), generator=gen, device="cuda").bfloat16()
    return k, v, tables.cuda()


def ulp_ratio(torch, got, want):
    """|got - want| element by element over one bf16 ulp (8 significant
    bits) of the largest |want| in the element's row (the last axis),
    never below ``ULP_FLOOR``.  Returns (max |got - want|, the worst
    ratio, its flat index, the rows' largest |want| broadcast)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    row = w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    tol = torch.exp2(torch.floor(torch.log2(row)) - 7).clamp_min(ULP_FLOOR)
    r = diff / tol
    at = int(r.argmax().item())
    return diff.max().item(), r.flatten()[at].item(), at, row


def check_kernel(torch, name, got, want):
    """Hold ``got`` to ``want`` element by element: |got - want| within one
    bf16 ulp of the largest |want| in the element's row (``ulp_ratio``).
    Returns (max |got - want|, worst ratio of error to bound)."""
    g, w = got.float(), want.float()
    err, ratio, at, row = ulp_ratio(torch, g, w)
    ok = bool(torch.isfinite(g).all().item()) and ratio <= 1.0
    print(f"[smoke] {name}: max|kernel - plain| = {err:.6g}, worst "
          f"|kernel - plain| / (one bf16 ulp of the row's max |plain|, "
          f">= 2^-14) = {ratio:.4g} (kernel {g.flatten()[at].item():.6g}, "
          f"plain {w.flatten()[at].item():.6g}, row max "
          f"{row.expand_as(w).flatten()[at].item():.6g}) "
          f"-> {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err, ratio


def rows_alone(torch, name, got, call):
    """Hold each request's rows alone (``call(b)``: the kernel on request b
    by itself) to its rows in the batch's output ``got``, bit for bit: K1
    and K3 split a row's keys over blocks and merge the partials in split
    order, K4 anchors its key tiles at absolute pages and chunk token 0,
    K5 and K7 split a row's keys at absolute pages and merge in order, K6
    builds each key's K/V and sums a row's keys in 64-key tiles
    anchored at key 0, and K9 sums a row's keys in 64-key tiles anchored at
    key 0, so no row may depend on the rest of its batch."""
    equal = all(torch.equal(call(b), got[b:b + 1])
                for b in range(got.shape[0]))
    print(f"[smoke] {name}: each of the {got.shape[0]} requests alone gives "
          f"its rows in the batch bit for bit "
          f"{'-> OK' if equal else '-> DIFFER'}", flush=True)
    if not equal:
        fail(f"{name}: a row's result depends on the rest of its batch")
    return equal


def capped_exact(torch, q4, kg, vg, mask, scale, G, softcap):
    """The capped attend in fp32 on the gathered K/V, q4 [B, H, Sq, D]
    against kg, vg [B, S, K, D] repeated to the query heads, keys that
    ``mask`` hides dropped.  Returns (the largest |scaled score| of a
    visible key before the cap, the output [B, H, Sq, D] fp32)."""
    kh, vh = (t.float().transpose(1, 2).repeat_interleave(G, 1)
              for t in (kg, vg))
    s = torch.einsum("bhqd,bhsd->bhqs", q4.float(), kh) * scale
    top = s.abs().masked_fill(~mask, 0.0).amax().item()
    s = (softcap * torch.tanh(s / softcap)).masked_fill(~mask, -math.inf)
    return top, torch.einsum("bhqs,bhsd->bhqd", s.softmax(-1), vh)


_FLEX = {}                     # the compiled flex_attention, made once


def flex_ms(torch, timer, q4, kg, vg, mask, scale, softcap):
    """Time one compiled ``flex_attention`` call on the gathered K/V that
    computes the capped attend: a ``score_mod`` of c * tanh(s / c) on the
    scaled scores, a block mask made from ``mask`` (one for every head),
    each K/V head shared by H / K query heads (``enable_gqa``).  The
    first call compiles (one compile a shape) and is not timed.  Returns
    (ms, compile seconds, the output [B, H, Sq, D])."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        dyn = torch._dynamo.config
        for key in ("recompile_limit", "cache_size_limit"):
            if hasattr(dyn, key):
                setattr(dyn, key, max(getattr(dyn, key), 64))
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    flex = _FLEX["fn"]
    B, H, Sq, _ = q4.shape
    kh, vh = (t.transpose(1, 2).contiguous() for t in (kg, vg))
    seen = mask[:, 0].expand(B, Sq, kh.shape[2]).contiguous()

    def cap(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    def visible(b, h, qi, ki):
        return seen[b, qi, ki]
    block = create_block_mask(visible, B, None, Sq, kh.shape[2],
                              device="cuda")
    q = q4.contiguous()

    def call():
        return flex(q, kh, vh, score_mod=cap, block_mask=block, scale=scale,
                    enable_gqa=True)
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    return timer(call), compile_s, out


def yardstick(torch, timer, q4, kg, vg, mask, scale, G, softcap=0.0):
    """A paged attend's library numbers: ``library_ms``, one SDPA call on
    the gathered K/V.  SDPA has no softcap: for a capped call
    ``library_ms`` is one compiled ``flex_attention`` call (``flex_ms``),
    held to the capped attend in fp32 (``capped_exact``) within
    ``FLEX_ROW_ULPS`` row ulps, SDPA's uncapped time kept as
    ``sdpa_uncapped_ms`` for context, and ``max_abs_score`` the largest
    |scaled score| of a visible key before the cap."""
    ms = sdpa_ms(torch, timer, q4, kg, vg, mask, scale, G)
    if not softcap:
        return {"library_ms": ms}
    lib_ms, compile_s, out = flex_ms(torch, timer, q4, kg, vg, mask, scale,
                                     softcap)
    top, want = capped_exact(torch, q4, kg, vg, mask, scale, G, softcap)
    _, ratio, _, _ = ulp_ratio(torch, out, want)
    if not ratio <= FLEX_ROW_ULPS:
        fail(f"flex_attention with the softcap is {ratio:.3g} row ulps "
             f"from the capped attend: it computes another function")
    return {"library_ms": lib_ms, "library": "flex_attention",
            "library_row_ulps": ratio, "library_compile_s": compile_s,
            "sdpa_uncapped_ms": ms, "max_abs_score": top}


def lib_text(lib):
    """The library part of a phase's timing line."""
    if "sdpa_uncapped_ms" not in lib:
        return f"sdpa {lib['library_ms']:.4f} ms"
    return (f"flex_attention (tanh score_mod) {lib['library_ms']:.4f} ms "
            f"({lib['library_row_ulps']:.3g} row ulps from fp32, compiled "
            f"in {lib['library_compile_s']:.1f} s), sdpa (uncapped) "
            f"{lib['sdpa_uncapped_ms']:.4f} ms, max |s| "
            f"{lib['max_abs_score']:.1f}")


def sdpa_ms(torch, timer, q4, kg, vg, mask, scale, G):
    """Time one ``scaled_dot_product_attention`` call on gathered K/V
    (``[B, S, K, D]``, head-repeated to the query heads) — the yardstick of
    a paged attend; the port never calls it."""
    import torch.nn.functional as F
    kh = kg.transpose(1, 2).repeat_interleave(G, 1)
    vh = vg.transpose(1, 2).repeat_interleave(G, 1)
    return timer(lambda: F.scaled_dot_product_attention(
        q4, kh, vh, attn_mask=mask, scale=scale))


def device_us(torch, timer, fn, pattern):
    """The device time a call of each CUDA kernel that ``fn`` launches
    (names matching ``pattern``): ``timer.iters`` calls, the L2 flushed
    before each, under ``torch.profiler`` tracing the device alone.
    Returns {kernel name: us a call}, or None where it was not measured."""
    import re
    n = timer.iters

    def calls():
        for _ in range(n):
            timer.flush.zero_()
            fn()
    prof = profile_device(torch, calls, device_only=True)
    if prof is None:
        return None
    us = {}
    for key, t, _ in prof[1]:
        name = re.search(pattern, key)
        if name:
            us[name.group(0)] = us.get(name.group(0), 0.0) + t / n
    return us


def print_device_us(name, us, tag="smoke"):
    print(f"[{tag}] {name}: " + (", ".join(
        f"{k} {v:.1f} us" for k, v in us.items()) if us else
        "device time not measured") + " a call on the device", flush=True)


def quantized(torch, k, v):
    """(k8, v8, k_scale, v_scale) quantized by the port's own contract."""
    from repro_torch.models.attention import quantize_int8
    (k8, ks), (v8, vs) = quantize_int8(k), quantize_int8(v)
    return k8, v8, ks, vs


def cap_name(label: str, int8: bool, softcap: float) -> str:
    """A kernel mode's name: ``label``, then ``-int8`` and ``-softcap``
    for those modes."""
    return label + ("-int8" if int8 else "") + ("-softcap" if softcap else "")


def kv_bytes(tokens: int, K: int, D: int, int8: bool) -> int:
    """Bytes of K and V that ``tokens`` token slots hold: bf16 values, or
    int8 values plus one bf16 scale per token and head."""
    return tokens * K * 2 * (D + 2 if int8 else 2 * D)


def phase_decode(torch, rng, timer, int8=False, K=2, G=7, D=64,
                 label="K1", softcap=0.0, q_gain=1.0):
    """K1 against its plain version at full-width decode shapes: qwen2's 2
    KV x 7 query heads of 64 by default, seamless-m4t's 16 x 1 of 64 or
    llava's 8 x 7 of 128 in phase 22; ``int8``: its int8 mode, on the pool
    quantized by ``quantize_int8``; ``softcap``: its logit-softcap mode
    (phase 24), the queries times ``q_gain`` (a power of 2: exact in
    bf16)."""
    from repro_torch.kernels.paged_attention import (paged_decode,
                                                     paged_decode_plain)
    from repro_torch.models.attention import gather_kv
    B, ps, width = 8, 16, 128
    H, name = K * G, cap_name(label, int8, softcap)
    pos = [2047, 1500, 1023, 1024, 15, 0, 777, 1900]   # page edges, 0, last
    k, v, tables = paged_pool(torch, rng, [p + 1 for p in pos], K, D, ps,
                              width)
    kw = dict(scale=1.0 / math.sqrt(D))
    if softcap:
        kw["softcap"] = softcap
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = quantized(torch, k, v)
    gen = torch.Generator(device="cuda").manual_seed(5 if int8 else 2)
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16() \
        * q_gain
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = paged_decode(q, k, v, tables, pos_t, **kw)
    want = paged_decode_plain(q, k, v, tables, pos_t, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} paged_decode", got, want)
    alone = rows_alone(torch, f"{name} paged_decode", got, lambda b: (
        paged_decode(q[b:b + 1], k, v, tables[b:b + 1], pos_t[b:b + 1],
                     **kw)))
    ms = timer(lambda: paged_decode(q, k, v, tables, pos_t, **kw))
    plain_ms = timer(lambda: paged_decode_plain(q, k, v, tables, pos_t,
                                                **kw))
    # yardstick: one SDPA call over the gathered, head-repeated K/V
    kg, vg = gather_kv(k, v, tables, kw.get("k_scale"), kw.get("v_scale"))
    mask = (torch.arange(width * ps, device="cuda")[None, :]
            <= pos_t[:, None])[:, None, None, :]
    lib = yardstick(torch, timer, q[:, :, None, :], kg.bfloat16(),
                    vg.bfloat16(), mask, kw["scale"], G, softcap)
    live = sum(p + 1 for p in pos)
    nbytes = kv_bytes(live, K, D, int8) + 2 * q.numel() * 2 \
        + tables.numel() * 4 + B * 4
    bms, by = bound(nbytes, live * H * D * 4,
                    live * H if softcap else 0)
    print(f"[smoke] {name} paged_decode: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib_text(lib)}, bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.2f} MB of pages, q, out, tables)",
          flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            **lib, "row_alone_bit_equal": alone}


def phase_prefill(torch, rng, timer, int8=False, K=2, G=7, D=64,
                  label="K2", softcap=0.0, q_gain=1.0):
    """K2 against its plain version at full-width chunk shapes: qwen2's 2
    KV x 7 query heads of 64 by default, minitron-4b's 8 x 3 of 128 with
    ``K=8, G=3, D=128``; ``int8``: its int8 mode, on the pool quantized by
    ``quantize_int8``; ``softcap`` and ``q_gain`` as ``phase_decode``."""
    from repro_torch.kernels.ragged_prefill import (ragged_prefill,
                                                    ragged_prefill_plain)
    from repro_torch.models.attention import gather_kv
    B, ps, T, width = 8, 16, 256, 128
    H, name = K * G, cap_name(label, int8, softcap)
    kw = dict(scale=1.0 / math.sqrt(D))
    if softcap:
        kw["softcap"] = softcap
    starts = [256 * i for i in range(B)]
    k, v, tables = paged_pool(torch, rng, [s + T for s in starts], K, D, ps,
                              width)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = quantized(torch, k, v)
    gen = torch.Generator(device="cuda").manual_seed(6 if int8 else 3)
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16() \
        * q_gain
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    got = ragged_prefill(q, k, v, tables, st, **kw)
    want = ragged_prefill_plain(q, k, v, tables, st, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} ragged_prefill", got, want)
    # the same chunks cut in two at token 96: each row's result depends
    # only on its q, its keys and its position, so the bits are the same
    cut = 96
    two = torch.cat([ragged_prefill(q[:, :cut].contiguous(), k, v, tables,
                                    st, **kw),
                     ragged_prefill(q[:, cut:].contiguous(), k, v, tables,
                                    st + cut, **kw)], dim=1)
    split_equal = torch.equal(got, two)
    print(f"[smoke] {name} ragged_prefill chunk split: the {B} chunks of {T} "
          f"prefilled as [0, {cut}) + [{cut}, {T}) give the one-chunk rows "
          f"bit for bit -> {'OK' if split_equal else 'FAIL'}", flush=True)
    if not split_equal:
        fail(f"{name}: a row's result depends on how its prompt was cut "
             "into chunks")
    ms = timer(lambda: ragged_prefill(q, k, v, tables, st, **kw))
    plain_ms = timer(lambda: ragged_prefill_plain(q, k, v, tables, st,
                                                  **kw))
    kg, vg = gather_kv(k, v, tables, kw.get("k_scale"), kw.get("v_scale"))
    qpos = st[:, None] + torch.arange(T, device="cuda")[None, :]
    mask = (torch.arange(width * ps, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    lib = yardstick(torch, timer, q.transpose(1, 2), kg.bfloat16(),
                    vg.bfloat16(), mask, kw["scale"], G, softcap)
    keys = sum(s + T for s in starts)
    pairs = sum(T * s + T * (T + 1) // 2 for s in starts)   # causal (q, k)
    nbytes = kv_bytes(keys, K, D, int8) + 2 * q.numel() * 2 \
        + tables.numel() * 4 + B * 4
    bms, by = bound(nbytes, pairs * H * D * 4, pairs * H if softcap else 0)
    print(f"[smoke] {name} ragged_prefill: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib_text(lib)}, bound {bms:.4f} ms "
          f"({by}: {pairs * H * D * 4 / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            **lib, "chunk_split_bit_equal": split_equal}


def verify_inputs(torch, rng, K=2, G=7, D=64):
    """K3's full-width verify shapes: B=8 rows of Q=5 queries (the last
    token and four drafts), qwen2's 2 KV x 7 query heads of 64 by default
    (llava's 8 x 7 of 128 in phase 22), 16-token pages; ragged live counts
    1..5 at positions up to 2043, a row at a page edge, and two idle rows
    (pos 0, one query, null table)."""
    B, ps, width, Q = 8, 16, 128, 5
    pos = [2043, 1500, 1023, 0, 15, 0, 777, 1900]
    n_q = [5, 3, 1, 1, 5, 1, 2, 4]
    lengths = [p + n for p, n in zip(pos, n_q)]
    lengths[3] = lengths[5] = 0                    # idle rows
    k, v, tables = paged_pool(torch, rng, lengths, K, D, ps, width)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((B, Q, K * G, D), generator=gen, device="cuda").bfloat16()
    return (q, k, v, tables,
            torch.tensor(pos, dtype=torch.int32, device="cuda"),
            torch.tensor(n_q, dtype=torch.int32, device="cuda"), G)


def verify_mask(torch, pos, n_q, Q, S):
    """[B, 1, Q, S] boolean verify mask for the SDPA yardstick; dead query
    rows keep key 0 visible (SDPA returns NaN for an all-masked row), the
    kernel returns zeros there."""
    j = torch.arange(Q, device="cuda")
    idx = torch.arange(S, device="cuda")
    m = (idx[None, None, :] <= (pos[:, None] + j[None, :])[:, :, None]) \
        & (j[None, :] < n_q[:, None])[:, :, None]
    m[..., 0] = True
    return m[:, None]


def phase_verify(torch, rng, timer, int8=False, K=2, G=7, D=64,
                 label="K3", softcap=0.0, q_gain=1.0):
    """K3 against its plain version at full-width verify shapes
    (``verify_inputs``), and with one live query per row against K1 bit for
    bit; ``softcap`` and ``q_gain`` as ``phase_decode``."""
    from repro_torch.kernels.paged_attention import (paged_decode,
                                                     paged_verify,
                                                     paged_verify_plain)
    from repro_torch.models.attention import gather_kv
    q, k, v, tables, pos, n_q, G = verify_inputs(torch, rng, K, G, D)
    q = q * q_gain
    B, Q, H, D = q.shape
    K, scale = H // G, 1.0 / math.sqrt(D)
    name = cap_name(label, int8, softcap)
    kw = {"softcap": softcap} if softcap else {}
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = quantized(torch, k, v)
    got = paged_verify(q, k, v, tables, pos, n_q, scale=scale, **kw)
    want = paged_verify_plain(q, k, v, tables, pos, n_q, scale=scale, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} paged_verify", got, want)
    dead = torch.arange(Q, device="cuda")[None, :] >= n_q[:, None]
    if bool((got[dead] != 0).any().item()):
        fail(f"{name}: dead query rows are not exact zeros")
    ones = torch.ones_like(n_q)
    one = paged_verify(q, k, v, tables, pos, ones, scale=scale, **kw)[:, 0]
    dec = paged_decode(q[:, 0].contiguous(), k, v, tables, pos, scale=scale,
                       **kw)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(one, dec))
    print(f"[smoke] {name} with one live query per row vs K1 on the same "
          f"inputs: bit for bit {'equal -> OK' if bit_equal else 'DIFFER'}",
          flush=True)
    if not bit_equal:
        fail(f"{name} at n_q = 1 differs from K1")
    alone = rows_alone(torch, f"{name} paged_verify", got, lambda b: (
        paged_verify(q[b:b + 1], k, v, tables[b:b + 1], pos[b:b + 1],
                     n_q[b:b + 1], scale=scale, **kw)))
    ms = timer(lambda: paged_verify(q, k, v, tables, pos, n_q, scale=scale,
                                    **kw))
    plain_ms = timer(lambda: paged_verify_plain(q, k, v, tables, pos, n_q,
                                                scale=scale, **kw))
    kg, vg = gather_kv(k, v, tables, kw.get("k_scale"), kw.get("v_scale"))
    mask = verify_mask(torch, pos, n_q, Q, kg.shape[1])
    lib = yardstick(torch, timer, q.transpose(1, 2), kg.bfloat16(),
                    vg.bfloat16(), mask.expand(B, H, Q, -1), scale, G,
                    softcap)
    live = [(int(p), int(n)) for p, n in zip(pos.tolist(), n_q.tolist())]
    keys = sum(p + n for p, n in live)
    pairs = sum(p + j + 1 for p, n in live for j in range(n))
    nbytes = kv_bytes(keys, K, D, int8) + 2 * q.numel() * 2 \
        + tables.numel() * 4 + 2 * B * 4
    bms, by = bound(nbytes, pairs * H * D * 4, pairs * H if softcap else 0)
    print(f"[smoke] {name} paged_verify: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib_text(lib)}, bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.2f} MB of live pages, q, out, tables)",
          flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            **lib, "n_q1_bit_equal_k1": bit_equal,
            "row_alone_bit_equal": alone}


# starcoder2-7b's attention at full width: 4 KV heads x 9 query heads of
# 128, a 4096-token window over 16-token pages: a ring of window_pages(4096,
# 16) = 257 pages, 258 with speculation's slack page
SC_K, SC_G, SC_D, SC_WINDOW = 4, 9, 128, 4096


def ring_pool(torch, rng, B, n_ring, K, D, ps):
    """Random bf16 pages and B disjoint rings of ``n_ring`` shuffled pages
    (the null page 0 in none).  Returns (k_pages, v_pages, tables [B,
    n_ring] int32)."""
    P = B * n_ring + 1
    tables = torch.as_tensor((rng.permutation(P - 1) + 1)
                             .reshape(B, n_ring).astype(np.int32))
    gen = torch.Generator(device="cuda").manual_seed(7)
    k = torch.randn((P, ps, K, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((P, ps, K, D), generator=gen, device="cuda").bfloat16()
    return k, v, tables.cuda()


SC_CHUNKS = ((0, 256), (3840, 256), (4352, 256), (5888, 200))


def phase_windowed_prefill(torch, rng, timer, int8=False, chunks=SC_CHUNKS,
                           label="K4", softcap=0.0, q_gain=1.0):
    """K4 against its plain version at full-width starcoder2-7b chunk
    shapes: by default B=4 chunks of 256 at starts 0, 3840, 4352 and 5888
    (the last one with 200 live tokens) over 257-page pre-write rings: one
    chunk starts on an empty ring, two read a wrapped ring, and those two
    cross the window; ``chunks``: other (start, live tokens) pairs, one a
    request; ``int8``: int8 ring pages, the fresh K/V bf16; ``softcap``
    and ``q_gain`` as ``phase_decode``.  Padding rows must be exact zeros,
    and each request alone must give its rows in the batch bit for
    bit."""
    from repro_torch.kernels.ragged_prefill import (windowed_prefill,
                                                    windowed_prefill_plain)
    from repro_torch.models.attention import gather_kv, ring_chunk_mask
    from repro_torch.models.cache_spec import window_pages
    B, K, G, D, ps, T, window = len(chunks), SC_K, SC_G, SC_D, PAGE, 256, \
        SC_WINDOW
    H, name = K * G, cap_name(label, int8, softcap)
    n_ring = window_pages(window, ps)
    k, v, tables = ring_pool(torch, rng, B, n_ring, K, D, ps)
    kw = dict(scale=1.0 / math.sqrt(D), window=window)
    if softcap:
        kw["softcap"] = softcap
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = quantized(torch, k, v)
    gen = torch.Generator(device="cuda").manual_seed(9 if int8 else 8)
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16() \
        * q_gain
    kn = torch.randn((B, T, K, D), generator=gen, device="cuda").bfloat16()
    vn = torch.randn((B, T, K, D), generator=gen, device="cuda").bfloat16()
    st = torch.tensor([c[0] for c in chunks], dtype=torch.int32,
                      device="cuda")
    nl = torch.tensor([c[1] for c in chunks], dtype=torch.int32,
                      device="cuda")
    args = (q, kn, vn, k, v, tables, st, nl)
    got = windowed_prefill(*args, **kw)
    want = windowed_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} windowed_prefill", got, want)
    live = torch.arange(T, device="cuda")[None, :] < nl[:, None]
    if bool((got[~live] != 0).any().item()):
        fail(f"{name}: padding rows are not exact zeros")
    alone = rows_alone(torch, f"{name} windowed_prefill", got, lambda b: (
        windowed_prefill(*(x[b:b + 1] for x in (q, kn, vn)), k, v,
                         tables[b:b + 1], st[b:b + 1], nl[b:b + 1], **kw)))
    ms = timer(lambda: windowed_prefill(*args, **kw))
    plain_ms = timer(lambda: windowed_prefill_plain(*args, **kw))
    n = n_ring * ps
    seen = ring_chunk_mask(st, nl, n, T, window)
    kr, vr = gather_kv(k, v, tables, kw.get("k_scale"), kw.get("v_scale"))
    kc = torch.cat([kr.bfloat16(), kn], 1)
    vc = torch.cat([vr.bfloat16(), vn], 1)
    lib = yardstick(torch, timer, q.transpose(1, 2), kc, vc, seen[:, None],
                    kw["scale"], G, softcap)
    pairs = int((seen & live[:, :, None]).sum().item())     # (row, key)
    used = int(seen.any(1).sum().item())        # key slots some row sees
    nbytes = kv_bytes(used, K, D, int8) \
        + 2 * (q.numel() + kn.numel() + vn.numel()) * 2 \
        + tables.numel() * 4 + 2 * B * 4
    bms, by = bound(nbytes, pairs * H * D * 4, pairs * H if softcap else 0)
    print(f"[smoke] {name} windowed_prefill: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib_text(lib)}, bound {bms:.4f} ms "
          f"({by}: {pairs * H * D * 4 / 1e9:.2f} GFLOP over {pairs} "
          f"(query, key) pairs, {nbytes / 1e6:.2f} MB)", flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            **lib, "row_alone_bit_equal": alone}


# starcoder2-7b's ring cases: K1 at B=4 over 257-page rings at positions 15
# (ring not yet full), 4111 (its last slot), 4600 and 6100 (wrapped); K3 at
# B=5 over 258-page rings (the slack page), Q=5, live queries 1..5 at
# positions up to 6100.  (kernel id, B, slack pages, positions, live
# queries)
SC_RING_CASES = (("K1-ring", 4, 0, [15, 4111, 4600, 6100], None),
                 ("K3-ring", 5, 1, [6100, 15, 4120, 4600, 5000],
                  [1, 2, 3, 4, 5]))
# command-r-plus-104b's: K3 at B=4, Q=5 over 258-page rings, 8 KV x 12
# query heads of 128 -- 60 rows per (request, KV head), two blocks
CR_K, CR_G = 8, 12
CR_RING_CASES = (("K3-ring", 4, 1, [6000, 15, 4120, 5000], [5, 1, 3, 5]),)


def phase_ring(torch, rng, timer, int8=False, K=SC_K, G=SC_G,
               cases=SC_RING_CASES, label="", softcap=0.0, q_gain=1.0):
    """K1 and K3 in ring mode against their plain versions at full-width
    shapes (starcoder2-7b's by default; ``cases`` as ``SC_RING_CASES``),
    and K3 with one live query per row against K1 on the same ring bit
    for bit.  Returns {kernel id: numbers}; ``label`` is added to the
    printed names; ``softcap`` and ``q_gain`` as ``phase_decode``."""
    from repro_torch.kernels.paged_attention import (paged_decode,
                                                     paged_decode_plain,
                                                     paged_verify,
                                                     paged_verify_plain)
    from repro_torch.models.attention import (decode_valid_mask, gather_kv,
                                              verify_valid_mask)
    from repro_torch.models.cache_spec import window_pages
    D, ps, window = SC_D, PAGE, SC_WINDOW
    H, sfx = K * G, cap_name("", int8, softcap)
    scale = 1.0 / math.sqrt(D)
    out = {}
    for kid, B, slack, pos, live_q in cases:
        name = kid + label + sfx
        n_ring = window_pages(window, ps) + slack
        n = n_ring * ps
        k, v, tables = ring_pool(torch, rng, B, n_ring, K, D, ps)
        kw = dict(scale=scale, window=window)
        if softcap:
            kw["softcap"] = softcap
        if int8:
            k, v, kw["k_scale"], kw["v_scale"] = quantized(torch, k, v)
        gen = torch.Generator(device="cuda").manual_seed(11 + B + int8)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kg, vg = gather_kv(k, v, tables, kw.get("k_scale"),
                           kw.get("v_scale"))
        if kid == "K1-ring":
            q = torch.randn((B, H, D), generator=gen,
                            device="cuda").bfloat16() * q_gain
            args = (q, k, v, tables, pos_t)
            fn, plain = paged_decode, paged_decode_plain
            seen = decode_valid_mask(pos_t, n, window=window)[:, None]
            q4 = q[:, :, None, :]
            mask = seen[:, None]
            pairs = int(seen.sum().item())
            used = pairs
        else:
            Q = 5
            q = torch.randn((B, Q, H, D), generator=gen,
                            device="cuda").bfloat16() * q_gain
            n_q = torch.tensor(live_q, dtype=torch.int32, device="cuda")
            args = (q, k, v, tables, pos_t, n_q)
            fn, plain = paged_verify, paged_verify_plain
            seen = verify_valid_mask(pos_t, n_q, Q, n, window=window)
            q4 = q.transpose(1, 2)
            mask = seen.clone()
            mask[..., 0] |= ~seen.any(-1)      # SDPA: no all-masked row
            mask = mask[:, None].expand(B, H, Q, n)
            pairs = int(seen.sum().item())
            used = int(seen.any(1).sum().item())
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err, ratio = check_kernel(torch, f"{name} {fn.__name__}", got, want)
        res = {"max_abs_err": err, "err_over_ulp": ratio}
        if kid == "K3-ring":
            dead = torch.arange(Q, device="cuda")[None, :] >= n_q[:, None]
            if bool((got[dead] != 0).any().item()):
                fail(f"{name}: dead query rows are not exact zeros")
            one = paged_verify(q, k, v, tables, pos_t, torch.ones_like(n_q),
                               **kw)[:, 0]
            dec = paged_decode(q[:, 0].contiguous(), k, v, tables, pos_t,
                               **kw)
            torch.cuda.synchronize()
            res["n_q1_bit_equal_k1"] = bool(torch.equal(one, dec))
            print(f"[smoke] {name} with one live query per row vs "
                  f"K1-ring{label}{sfx} on the same ring: bit for bit "
                  f"{'equal -> OK' if res['n_q1_bit_equal_k1'] else 'DIFFER'}",
                  flush=True)
            if not res["n_q1_bit_equal_k1"]:
                fail(f"{name} at n_q = 1 differs from K1-ring{label}{sfx}")
        ms = timer(lambda: fn(*args, **kw))
        plain_ms = timer(lambda: plain(*args, **kw))
        lib = yardstick(torch, timer, q4, kg.bfloat16(), vg.bfloat16(),
                        mask, scale, G, softcap)
        nbytes = kv_bytes(used, K, D, int8) + 2 * q.numel() * 2 \
            + tables.numel() * 4 + 2 * B * 4
        bms, by = bound(nbytes, pairs * H * D * 4,
                        pairs * H if softcap else 0)
        print(f"[smoke] {name} {fn.__name__}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {lib_text(lib)}, bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB of ring K/V seen, "
              f"q, out, tables)", flush=True)
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   **lib)
        out[kid] = res
    return out


def ring_history(torch, hist, tables, ps, upto):
    """Pages [P, ps, ...] holding, in each row's ring of ``tables`` [B, n]
    pages, the newest ``n * ps`` positions up to ``upto[b]`` of ``hist[b]``
    ([B, N, ...], one entry per absolute position): position a sits at slot
    a mod (n * ps), as the engine writes it.  Page 0 (the null page) and
    slots not yet written hold zeros."""
    B, n = tables.shape
    ring = n * ps
    pages = hist.new_zeros((int(tables.max().item()) + 1, ps)
                           + tuple(hist.shape[2:]))
    for b in range(B):
        a = torch.arange(max(0, upto[b] - ring + 1), upto[b] + 1,
                         device=hist.device)
        slot = a % ring
        pages[tables[b, slot // ps].long(), slot % ps] = hist[b, a]
    return pages


# Part of phase 9: the same window of K/V laid out in starcoder2-7b's
# 257-page ring and in the speculative pool's 258-page ring, at positions
# past the wrap.  (kernel id, positions or chunk starts, live queries or
# live chunk tokens)
RING_LENGTH_CASES = (("K1-ring", [4200, 4600, 5000, 6100], None),
                     ("K3-ring", [4120, 4600, 5000, 6100, 4500],
                      [1, 2, 3, 4, 5]),
                     ("K4", [4352, 5888, 4128, 6000], [256, 256, 256, 200]))


def phase_ring_lengths(torch, rng, int8=False):
    """K1-ring, K3-ring and K4 on one window of K/V held in a 257-page ring
    and in a 258-page ring (the speculative pool's slack page), at
    starcoder2-7b shapes: the kernels sweep a ring's pages in the order of
    their absolute positions, so the two outputs must be equal bit for bit
    (the windowed speculative stream equals the plain stream).  Returns
    {kernel id: True}."""
    from repro_torch.kernels.paged_attention import paged_decode, paged_verify
    from repro_torch.kernels.ragged_prefill import windowed_prefill
    from repro_torch.models.cache_spec import window_pages
    K, G, D, ps, window = SC_K, SC_G, SC_D, PAGE, SC_WINDOW
    H, sfx, T, Q = K * G, "-int8" if int8 else "", 256, 5
    n0 = window_pages(window, ps)
    gen = torch.Generator(device="cuda").manual_seed(21 + int8)
    out = {}
    for kid, pos, live in RING_LENGTH_CASES:
        B = len(pos)
        # each row's K/V at every absolute position it has written
        upto = [p + (live[b] - 1 if kid == "K3-ring" else 0) if kid != "K4"
                else p - 1 for b, p in enumerate(pos)]
        N = max(upto) + 1
        hk = torch.randn((B, N, K, D), generator=gen, device="cuda").bfloat16()
        hv = torch.randn((B, N, K, D), generator=gen, device="cuda").bfloat16()
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        if kid == "K1-ring":
            q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
        elif kid == "K3-ring":
            q = torch.randn((B, Q, H, D), generator=gen,
                            device="cuda").bfloat16()
        else:
            q = torch.randn((B, T, H, D), generator=gen,
                            device="cuda").bfloat16()
            kn = torch.randn((B, T, K, D), generator=gen,
                             device="cuda").bfloat16()
            vn = torch.randn((B, T, K, D), generator=gen,
                             device="cuda").bfloat16()
        outs = []
        for n_ring in (n0, n0 + 1):
            tables = torch.as_tensor(
                (rng.permutation(B * n_ring) + 1).reshape(B, n_ring)
                .astype(np.int32), device="cuda")
            k = ring_history(torch, hk, tables, ps, upto)
            v = ring_history(torch, hv, tables, ps, upto)
            kw = dict(scale=1.0 / math.sqrt(D), window=window)
            if int8:
                k, v, kw["k_scale"], kw["v_scale"] = quantized(torch, k, v)
            if kid == "K1-ring":
                o = paged_decode(q, k, v, tables, pos_t, **kw)
            elif kid == "K3-ring":
                o = paged_verify(q, k, v, tables, pos_t, torch.tensor(
                    live, dtype=torch.int32, device="cuda"), **kw)
            else:
                o = windowed_prefill(q, kn, vn, k, v, tables, pos_t,
                                     torch.tensor(live, dtype=torch.int32,
                                                  device="cuda"), **kw)
            outs.append(o)
        torch.cuda.synchronize()
        equal = bool(torch.equal(outs[0], outs[1]))
        diff = (outs[0].float() - outs[1].float()).abs().max().item()
        print(f"[smoke] {kid}{sfx} on one window in a {n0}-page and a "
              f"{n0 + 1}-page ring (positions {pos}): bit for bit "
              f"{'equal -> OK' if equal else f'DIFFER (max {diff:.3g})'}",
              flush=True)
        if not equal:
            fail(f"{kid}{sfx}: the ring's length changes its output")
        out[kid] = equal
    return out


# deepseek-v2-236b's MLA at full width: 128 heads, a 512-wide latent and a
# 64-wide rope key per token (one shared latent "KV head"), 128 + 64 query
# dims and 128 value dims a head
DS_H, DS_L, DS_R, DS_NOPE, DS_V = 128, 512, 64, 128, 128
# the flops K5 and K7 issue a (query, key, head): QK^T over L + R, PV with
# p as two bf16 terms (csrc/mla_attention.cuh)
MLA_TWO_TERM_FLOPS = 2 * (DS_L + DS_R) + 4 * DS_L
# the CUDA kernels of K5 and K7 (split, merge; attend: an earlier tree's)
MLA_KERNEL_NAMES = r"mla_(?:split|merge)_kernel|attend_kernel"


def latent_pool(torch, rng, lengths, width):
    """Random bf16 latent pages (ckv [P, 16, 512], krope [P, 16, 64]) for
    requests of ``lengths`` tokens over shuffled tables (entries past a
    request's pages, and idle rows, point at the null page 0)."""
    need = [-(-n // PAGE) for n in lengths]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = torch.zeros((len(lengths), width), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = torch.as_tensor(perm[at:at + n])
        at += n
    gen = torch.Generator(device="cuda").manual_seed(31)
    ckv = torch.randn((P, PAGE, DS_L), generator=gen,
                      device="cuda").bfloat16()
    kr = torch.randn((P, PAGE, DS_R), generator=gen, device="cuda").bfloat16()
    return ckv, kr, tables.cuda()


def latent_bytes(tokens: int, int8: bool) -> int:
    """Bytes of the latent pages that ``tokens`` token slots hold: bf16
    ckv and krope, or int8 values plus one bf16 scale each."""
    return tokens * ((DS_L + DS_R) + 4 if int8 else (DS_L + DS_R) * 2)


def latent_int8(torch, ckv, kr):
    """(ckv8, krope8, {ckv_scale, krope_scale}) quantized from the bf16
    latent pages by the port's ``quantize_int8``."""
    from repro_torch.models.attention import quantize_int8
    (c8, cs), (r8, rs) = quantize_int8(ckv), quantize_int8(kr)
    return c8, r8, {"ckv_scale": cs, "krope_scale": rs}


def latent_sdpa(torch, timer, q_eff, q_rope, ckv, kr, tables, kw, mask,
                scale):
    """Time the yardstick of a latent attend: SDPA of q_eff ++ q_rope ([B,
    H, Q, E]) against the gathered ckv ++ krope, v = ckv, one KV head
    shared by the query heads (int8 pages dequantized to bf16 first)."""
    import torch.nn.functional as F
    from repro_torch.models.attention import gather_kv
    cc, cr = gather_kv(ckv, kr, tables, kw.get("ckv_scale"),
                       kw.get("krope_scale"))
    cc, cr = cc.bfloat16(), cr.bfloat16()
    B, S = cc.shape[:2]
    H = q_eff.shape[1]
    qk = torch.cat([q_eff, q_rope], -1)
    kk = torch.cat([cc, cr], -1)[:, None].expand(B, H, S, DS_L + DS_R)
    vv = cc[:, None].expand(B, H, S, DS_L)
    return timer(lambda: F.scaled_dot_product_attention(
        qk, kk, vv, attn_mask=mask, scale=scale))


def mla_decode_inputs(torch, rng, pos, Q=None):
    """Full-width deepseek-v2 latent attend inputs: B = len(pos) rows at
    positions ``pos`` over shuffled tables (rows at position 0 idle: the
    null table), 128 heads, 16-token pages; ``Q`` query tokens a row
    (None: decode's [B, H, *])."""
    lengths = [p + (Q or 1) if p else 0 for p in pos]
    ckv, kr, tables = latent_pool(torch, rng, lengths, 128)
    gen = torch.Generator(device="cuda").manual_seed(32 + (Q or 0))
    shape = (len(pos), DS_H) if Q is None else (len(pos), Q, DS_H)
    q_eff = torch.randn(shape + (DS_L,), generator=gen,
                        device="cuda").bfloat16()
    q_rope = torch.randn(shape + (DS_R,), generator=gen,
                         device="cuda").bfloat16()
    return (q_eff, q_rope, ckv, kr, tables,
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def phase_mla_decode(torch, rng, timer, int8=False):
    """K5 against its plain version at full-width deepseek-v2 decode
    shapes: B=8, 128 heads, 16-token latent pages, ragged positions up to
    2047 over shuffled tables and two idle rows (pos 0, null table), each
    request alone equal to its rows in the batch, bit for bit; ``int8``:
    its int8 mode, on the pool quantized by ``quantize_int8``.  Prints
    the device time a call of each of its CUDA kernels and the bound of
    the products the kernel issues (PV's doubled: p as two bf16 terms)."""
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_decode_plain)
    pos = [2047, 1500, 1023, 0, 15, 0, 777, 1900]
    q_eff, q_rope, ckv, kr, tables, pos_t = mla_decode_inputs(torch, rng,
                                                              pos)
    B = len(pos)
    name = "K5-int8" if int8 else "K5"
    kw = {"scale": 1.0 / math.sqrt(DS_NOPE + DS_R)}
    if int8:
        ckv, kr, scales = latent_int8(torch, ckv, kr)
        kw.update(scales)
    args = (q_eff, q_rope, ckv, kr, tables, pos_t)
    got = mla_paged_decode(*args, **kw)
    want = mla_paged_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} mla_paged_decode", got, want)
    alone = rows_alone(torch, f"{name} mla_paged_decode", got, lambda b: (
        mla_paged_decode(*(x[b:b + 1] for x in args[:2]), ckv, kr,
                         tables[b:b + 1], pos_t[b:b + 1], **kw)))
    ms = timer(lambda: mla_paged_decode(*args, **kw))
    dev_us = device_us(torch, timer, lambda: mla_paged_decode(*args, **kw),
                       MLA_KERNEL_NAMES)
    print_device_us(f"{name} mla_paged_decode", dev_us)
    plain_ms = timer(lambda: mla_paged_decode_plain(*args, **kw))
    S = tables.shape[1] * PAGE
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos_t[:, None])[:, None, None, :]
    library_ms = latent_sdpa(torch, timer, q_eff[:, :, None],
                             q_rope[:, :, None], ckv, kr, tables, kw, mask,
                             kw["scale"])
    live = sum(p + 1 for p in pos)
    nbytes = latent_bytes(live, int8) + (q_eff.numel() + q_rope.numel()
                                         + got.numel()) * 2 \
        + tables.numel() * 4 + B * 4
    flops = live * DS_H * (2 * (DS_L + DS_R) + 2 * DS_L)
    bms, by = bound(nbytes, flops)
    bms2, _ = bound(nbytes, live * DS_H * MLA_TWO_TERM_FLOPS)
    print(f"[smoke] {name} mla_paged_decode: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.2f} MB of latent pages, q, out, tables; "
          f"{flops / 1e9:.2f} GFLOP), two-term bound {bms2:.4f} ms",
          flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bound_two_term_ms": bms2, "library_ms": library_ms,
            "device_us": dev_us, "row_alone_bit_equal": alone}


def phase_mla_verify(torch, rng, timer, int8=False):
    """K7 against its plain version at full-width deepseek-v2 verify
    shapes: B=8 rows of Q=5 queries (the last token and four drafts), 128
    heads, 16-token latent pages, ragged live counts 1..5 at positions up
    to 2043 and two idle rows (pos 0, one query, null table); dead rows
    must be exact zeros; with one live query per row against K5 on the
    same inputs, and each request alone against its rows in the batch,
    bit for bit.  ``int8``: its int8 mode.  Prints the device time a call
    of each of its CUDA kernels and the two-term bound."""
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_verify,
                                                     mla_paged_verify_plain)
    pos = [2043, 1500, 1023, 0, 15, 0, 777, 1900]
    n_q = [5, 3, 1, 1, 5, 1, 2, 4]
    Q = 5
    q_eff, q_rope, ckv, kr, tables, pos_t = mla_decode_inputs(torch, rng,
                                                              pos, Q)
    B = len(pos)
    nq_t = torch.tensor(n_q, dtype=torch.int32, device="cuda")
    name = "K7-int8" if int8 else "K7"
    kw = {"scale": 1.0 / math.sqrt(DS_NOPE + DS_R)}
    if int8:
        ckv, kr, scales = latent_int8(torch, ckv, kr)
        kw.update(scales)
    args = (q_eff, q_rope, ckv, kr, tables, pos_t, nq_t)
    got = mla_paged_verify(*args, **kw)
    want = mla_paged_verify_plain(*args, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} mla_paged_verify", got, want)
    dead = torch.arange(Q, device="cuda")[None, :] >= nq_t[:, None]
    if bool((got[dead] != 0).any().item()):
        fail(f"{name}: dead query rows are not exact zeros")
    one = mla_paged_verify(*args[:-1], torch.ones_like(nq_t), **kw)[:, 0]
    dec = mla_paged_decode(q_eff[:, 0].contiguous(),
                           q_rope[:, 0].contiguous(), *args[2:-1], **kw)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(one, dec))
    print(f"[smoke] {name} with one live query per row vs K5 on the same "
          f"inputs: bit for bit {'equal -> OK' if bit_equal else 'DIFFER'}",
          flush=True)
    if not bit_equal:
        fail(f"{name} at n_q = 1 differs from K5")
    alone = rows_alone(torch, f"{name} mla_paged_verify", got, lambda b: (
        mla_paged_verify(*(x[b:b + 1] for x in args[:2]), ckv, kr,
                         *(x[b:b + 1] for x in args[4:]), **kw)))
    ms = timer(lambda: mla_paged_verify(*args, **kw))
    dev_us = device_us(torch, timer, lambda: mla_paged_verify(*args, **kw),
                       MLA_KERNEL_NAMES)
    print_device_us(f"{name} mla_paged_verify", dev_us)
    plain_ms = timer(lambda: mla_paged_verify_plain(*args, **kw))
    mask = verify_mask(torch, pos_t, nq_t, Q, tables.shape[1] * PAGE)
    library_ms = latent_sdpa(torch, timer, q_eff.transpose(1, 2),
                             q_rope.transpose(1, 2), ckv, kr, tables, kw,
                             mask, kw["scale"])
    keys = sum(p + n for p, n in zip(pos, n_q))
    pairs = sum(p + j + 1 for p, n in zip(pos, n_q) for j in range(n))
    nbytes = latent_bytes(keys, int8) + (q_eff.numel() + q_rope.numel()
                                         + got.numel()) * 2 \
        + tables.numel() * 4 + 2 * B * 4
    flops = pairs * DS_H * (2 * (DS_L + DS_R) + 2 * DS_L)
    bms, by = bound(nbytes, flops)
    bms2, _ = bound(nbytes, pairs * DS_H * MLA_TWO_TERM_FLOPS)
    print(f"[smoke] {name} mla_paged_verify: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}: {flops / 1e9:.2f} GFLOP over {pairs} live (query, key) "
          f"pairs, {nbytes / 1e6:.2f} MB), two-term bound {bms2:.4f} ms",
          flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bound_two_term_ms": bms2, "library_ms": library_ms,
            "device_us": dev_us, "n_q1_bit_equal_k5": bit_equal,
            "row_alone_bit_equal": alone}


FP64_FLOPS_PER_S = 67e12       # H100 SXM fp64 tensor cores, data sheet
MLA_CHUNKS = tuple((256 * i, 256) for i in range(7)) + ((1792, 200),)


def phase_mla_prefill(torch, rng, timer, int8=False, chunks=MLA_CHUNKS,
                      label="K6"):
    """K6 against its plain version at full-width deepseek-v2 chunk shapes:
    by default B=8 chunks of 256 tokens at starts 0, 256, ..., 1792 over
    shuffled tables, the last with 200 live tokens (its table ends there:
    its padding rows read the null page, as in the engine), 128 heads,
    per-head K/V materialized from the latent with a random ``wkv_b``;
    ``chunks``: other (start, live tokens) pairs, one a request; ``int8``:
    its int8 mode, on the pool quantized by ``quantize_int8``.  Each
    request alone must give its rows in the batch bit for bit.  Stage A
    (``mla_build_kv``, every key's K/V once) is checked against its plain
    version too: bf16 K/V bit for bit, int8 hi + lo within 2^-16 of each
    row's largest |x|.  Returns (K6's numbers, stage A's numbers); stage
    A's are None for a tree whose K6 has no stage A (``prefill_cost.py``
    times an older tree through the same wrapper)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.kernels.ragged_prefill import (mla_ragged_prefill,
                                                    mla_ragged_prefill_plain)
    from repro_torch.models.attention import gather_kv
    stage_a = hasattr(rp, "mla_build_kv")
    B, T, width = len(chunks), 256, 128
    starts = [c[0] for c in chunks]
    n_live = [c[1] for c in chunks]
    ckv, kr, tables = latent_pool(torch, rng,
                                  [s + n for s, n in zip(starts, n_live)],
                                  width)
    gen = torch.Generator(device="cuda").manual_seed(33)
    E = DS_NOPE + DS_R
    q = torch.randn((B, T, DS_H, E), generator=gen, device="cuda").bfloat16()
    wkv_b = (torch.randn((DS_L, DS_H, DS_NOPE + DS_V), generator=gen,
                         device="cuda") / math.sqrt(DS_L)).bfloat16()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    name = label + ("-int8" if int8 else "")
    kw = {"nope": DS_NOPE}
    if int8:
        ckv, kr, scales = latent_int8(torch, ckv, kr)
        kw.update(scales)
    args = (q, ckv, kr, wkv_b, tables, st)
    got = mla_ragged_prefill(*args, **kw)
    want = mla_ragged_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, f"{name} mla_ragged_prefill", got, want)
    pad = sum(T - n for n in n_live)
    print(f"[smoke] {name} mla_ragged_prefill: {tuple(got.shape)} rows "
          f"(none past T), the {pad} padding rows computed and held to the "
          f"plain version with the rest", flush=True)
    del want
    alone = rows_alone(torch, f"{name} mla_ragged_prefill", got, lambda b: (
        mla_ragged_prefill(q[b:b + 1], ckv, kr, wkv_b, tables[b:b + 1],
                           st[b:b + 1], **kw)))
    ms = timer(lambda: mla_ragged_prefill(*args, **kw))
    plain_ms = timer(lambda: mla_ragged_prefill_plain(*args, **kw))
    # the keys K6 sweeps: each request's pages up to its last row's
    keys = sum(min((s + T - 1) // PAGE + 1, width) * PAGE for s in starts)
    pairs = sum(T * s + T * (T + 1) // 2 for s in starts)
    kv_flops = keys * DS_H * DS_L * (DS_NOPE + DS_V) * 2
    attend_flops = pairs * DS_H * (E + DS_V) * 2
    kv_numbers = mla_stage_a(torch, timer, name, ckv, wkv_b, tables, st, T,
                             kv_flops, latent_bytes(keys, int8),
                             kw.get("ckv_scale")) if stage_a else None
    # yardstick: the einsum that materializes K/V from the gathered latent
    # (int8: dequantized to bf16), then SDPA with the chunk's causal mask
    cc, cr = gather_kv(ckv, kr, tables, kw.get("ckv_scale"),
                       kw.get("krope_scale"))
    cc, cr = cc.bfloat16(), cr.bfloat16()
    S = cc.shape[1]
    qpos = st[:, None] + torch.arange(T, device="cuda")[None, :]
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qh = q.transpose(1, 2)

    def library():
        kv = torch.einsum("bsl,lhe->bhse", cc, wkv_b)
        k = torch.cat([kv[..., :DS_NOPE], cr[:, None].expand(
            B, DS_H, S, DS_R)], -1)
        return F.scaled_dot_product_attention(qh, k, kv[..., DS_NOPE:],
                                              attn_mask=mask,
                                              scale=1.0 / math.sqrt(E))
    library_ms = timer(library)
    flops = kv_flops + attend_flops
    nbytes = latent_bytes(keys, int8) + (q.numel() + got.numel()
                                         + wkv_b.numel()) * 2 \
        + tables.numel() * 4 + B * 4
    bms, by = bound(nbytes, flops)
    # bf16 pages' K/V must be fp64 sums: their products at the fp64 tensor
    # cores' rate, then the attend at the bf16 rate
    fp64_ms = (kv_flops / FP64_FLOPS_PER_S + attend_flops / BF16_FLOPS_PER_S) \
        * 1e3
    print(f"[smoke] {name} mla_ragged_prefill: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, einsum + sdpa {library_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, K/V "
          f"materialization included, {nbytes / 1e6:.2f} MB)"
          + ("" if int8 else f"; under the fp64 contract of bf16 pages' "
             f"K/V {fp64_ms:.4f} ms ({kv_flops / 1e9:.2f} GFLOP at "
             f"{FP64_FLOPS_PER_S / 1e12:.0f} TFLOP/s + "
             f"{attend_flops / 1e9:.2f} at "
             f"{BF16_FLOPS_PER_S / 1e12:.0f})")
          + (f"; the attend (stage B) {ms - kv_numbers['ms']:.4f} ms of it"
             if stage_a else ""), flush=True)
    return ({"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": library_ms, "fp64_contract_bound_ms": fp64_ms,
             "row_alone_bit_equal": alone}, kv_numbers)


def mla_stage_a(torch, timer, name, ckv, wkv_b, tables, st, T, kv_flops,
                latent_nbytes, cs):
    """K6's stage A (``mla_build_kv``) against its plain version on every
    key it builds -- bf16 K/V bit for bit; int8 hi + lo within 2^-16 of
    each row's largest |x| of the fp32 einsum x (hi + lo keeps 16 bits of
    the kernel's own fp32 x) -- and its times: kernel, plain, and one
    einsum of the gathered latent with ``wkv_b`` (bf16 pages: fp64
    operands, int8: the fp32 dequantized latent) as the yardstick.
    Returns its numbers."""
    from repro_torch.kernels.ragged_prefill import (mla_build_kv,
                                                    mla_build_kv_plain)
    from repro_torch.kernels.ragged_prefill.ops import mla_built_keys
    from repro_torch.models.attention import dequant_int8, gather_pages
    int8 = cs is not None
    kv_args = (ckv, wkv_b, tables, st, T)
    cc = gather_pages(ckv, tables)
    cc = dequant_int8(cc, gather_pages(cs, tables)) if int8 \
        else cc.double()
    w = wkv_b.float() if int8 else wkv_b.double()
    ws = mla_build_kv(*kv_args, nope=DS_NOPE, ckv_scale=cs)
    # bf16: the plain version's K/V; int8: the fp32 einsum x itself
    ws_plain = torch.einsum("bsl,lhe->bhse", cc, w) if int8 \
        else mla_build_kv_plain(*kv_args, ckv_scale=cs)
    built = mla_built_keys(st, T, tables.shape[1], PAGE).tolist()
    kv_err, kv_rel, n_diff = 0.0, 0.0, 0
    for b, n in enumerate(built):
        g, p = ws[b, :, :n].float(), ws_plain[b, :, :n].float()
        if int8:           # hi + lo
            g = g[..., :DS_NOPE + DS_V] + g[..., DS_NOPE + DS_V:]
        d = (g - p).abs()
        kv_err = max(kv_err, d.max().item())
        kv_rel = max(kv_rel, (d / p.abs().amax(-1, keepdim=True)
                              .clamp_min(1e-30)).max().item())
        n_diff += int((d != 0).sum().item())
    kv_ok = kv_rel <= 2.0 ** -16 if int8 else n_diff == 0
    print(f"[smoke] {name} mla_build_kv (stage A): "
          + (f"hi + lo within {kv_rel:.4g} of each row's largest |x| of the "
             f"fp32 einsum (bound 2^-16 = {2.0 ** -16:.4g})" if int8 else
             f"{n_diff} K/V elements of "
             f"{sum(built) * DS_H * (DS_NOPE + DS_V)} differ from the plain "
             f"einsum's (bound 0)")
          + f" -> {'OK' if kv_ok else 'FAIL'}", flush=True)
    if not kv_ok:
        fail(f"{name}: stage A's K/V disagree with the plain einsum")
    del ws, ws_plain
    ms = timer(lambda: mla_build_kv(*kv_args, nope=DS_NOPE, ckv_scale=cs))
    plain_ms = timer(lambda: mla_build_kv_plain(*kv_args, ckv_scale=cs))
    library_ms = timer(lambda: torch.einsum("bsl,lhe->bhse", cc, w))
    del cc, w
    keys = sum(built)
    nbytes = latent_nbytes + wkv_b.numel() * 2 \
        + keys * DS_H * (DS_NOPE + DS_V) * (4 if int8 else 2)
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kv_flops / (BF16_FLOPS_PER_S if int8 else FP64_FLOPS_PER_S) * 1e3
    bms, by = max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"
    print(f"[smoke] {name} mla_build_kv (stage A): kernel {ms:.4f} ms = "
          f"{kv_flops / ms / 1e9:.2f} TFLOP/s "
          f"({'bf16 tensor cores, of 989' if int8 else 'fp64, of 67'}), "
          f"plain {plain_ms:.4f} ms, einsum {library_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}: {kv_flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return {"max_abs_err": kv_err, "err_over_row_max": kv_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "tflops": kv_flops / ms / 1e9}


def serving_workload(rng, vocab):
    shared = rng.randint(1, vocab, size=PREFIX).tolist()
    lens = [int(x) for x in np.linspace(PROMPT_LO, PROMPT_HI, N_REQUESTS)]
    return [shared + rng.randint(1, vocab, size=n - PREFIX).tolist()
            for n in lens]


def serve_kwargs():
    return dict(page_size=PAGE, max_slots=N_REQUESTS,
                max_len=-(-(PROMPT_HI + GEN_TOKENS) // PAGE) * PAGE,
                prefix_cache=True, prefill_chunk_tokens=CHUNK)


def phase_serve(torch, cfg, seed, profile=True, params=None, prompts=None):
    """Serve ``cfg`` on the hopper backend, then on the reference backend,
    and hold them to each other (``profile``: with a profiled rerun of the
    hopper requests between); ``params`` and ``prompts`` are drawn from
    ``seed`` unless given.  Returns (launch counts of the hopper run,
    dual-gate report, params, prompts, hopper tokens, replay cache); the
    report's ``peak_memory_bytes`` is the hopper run's peak of what this
    call holds (its parameters, pool and activations, nothing else on
    the card)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.kernels.ragged_prefill import ragged_prefill
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Engine, dual_gate, replay_logits
    if prompts is None:
        prompts = serving_workload(np.random.RandomState(seed), cfg.vocab)
    kw = serve_kwargs()
    scfg = ServeConfig(attn_backend="hopper", **kw)
    ref_scfg = ServeConfig(attn_backend="reference", **kw)
    device = "cuda"
    with torch.no_grad():
        t0 = time.perf_counter()
        # what else is on the card, so that the hopper run's peak counts
        # this call's parameters, pool and activations alone
        base = torch.cuda.memory_allocated()
        if params is None:
            params = init_params(cfg, seed, device)
        else:
            base -= sum(leaf.numel() * leaf.element_size()
                        for _, leaf in tree_leaves(params))
        torch.cuda.synchronize()
        n_params = sum(leaf.numel() for _, leaf in tree_leaves(params))
        print(f"[smoke] {cfg.name}: {n_params / 1e6:.1f} M parameters, "
              f"{cfg.n_layers} layers, softcap {cfg.attn_logit_softcap}, on "
              f"{device} in {time.perf_counter() - t0:.1f} s", flush=True)
        eng = Engine(cfg, scfg, params, seed=seed, device=device)
        paged_decode.launches = 0
        ragged_prefill.launches = 0
        torch.cuda.reset_peak_memory_stats()
        results, m = eng.run_offline(prompts, GEN_TOKENS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = {"K1": paged_decode.launches, "K2": ragged_prefill.launches}
        tokens = [r.tokens for r in results]
        print(f"[smoke] hopper serve: {m['n_requests']} requests, "
              f"{m['new_tokens']} tokens in {m['wall_s']:.3f} s = "
              f"{m['tokens_per_s']:.1f} tok/s, TTFT p50 "
              f"{m['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
              f"{m['decode_step_ms_p50']:.3f} ms over {m['decode_steps']} "
              f"steps, {m['prefill_steps']} prefill steps "
              f"({m['chunked_prefill_steps']} continuation chunks), prefix "
              f"cache hit rate {m['cache_hit_rate']:.3f}, on {m['device']}",
              flush=True)
        print(f"[smoke] launches in the hopper run: K1 {counts['K1']}, "
              f"K2 {counts['K2']} ({cfg.n_layers} layers)", flush=True)
        if any(r.failed for r in results) \
                or any(len(t) != GEN_TOKENS for t in tokens) \
                or not all(0 <= x < cfg.vocab_padded for t in tokens
                           for x in t):
            fail("hopper serve returned failed, short or out-of-range "
                 "requests")
        if counts["K1"] != m["decode_steps"] * cfg.n_layers:
            fail(f"K1 launches {counts['K1']} != decode steps "
                 f"{m['decode_steps']} x {cfg.n_layers} layers")
        if counts["K2"] != m["prefill_steps"] * cfg.n_layers:
            fail(f"K2 launches {counts['K2']} != prefill steps "
                 f"{m['prefill_steps']} x {cfg.n_layers} layers")
        if profile:
            profile_rerun(torch, eng, prompts)
        del eng
        ref = Engine(cfg, ref_scfg, params, seed=seed, device=device)
        ref_results, rm = ref.run_offline(prompts, GEN_TOKENS)
        del ref
        ref_tokens = [r.tokens for r in ref_results]
        print(f"[smoke] reference serve: {rm['tokens_per_s']:.1f} tok/s, "
              f"decode step p50 {rm['decode_step_ms_p50']:.3f} ms",
              flush=True)
        same = sum(a == b for t, u in zip(tokens, ref_tokens)
                   for a, b in zip(t, u))
        total = sum(len(t) for t in tokens)
        identical = sum(t == u for t, u in zip(tokens, ref_tokens))
        ref_logits = [replay_logits(cfg, scfg, params, p, t,
                                    attn_backend="reference")
                      for p, t in zip(prompts, tokens)]
        test_logits = [replay_logits(cfg, scfg, params, p, t,
                                     attn_backend="hopper")
                       for p, t in zip(prompts, tokens)]
        report = dual_gate(ref_logits, test_logits, tokens, tol=LOGIT_TOL)
        report.update(engine_tokens_equal=same, engine_tokens=total,
                      identical_requests=identical,
                      tokens_per_s=m["tokens_per_s"],
                      ttft_p50_ms=m["ttft_p50_s"] * 1e3,
                      decode_step_ms_p50=m["decode_step_ms_p50"],
                      peak_memory_bytes=peak,
                      ref_tokens_per_s=rm["tokens_per_s"],
                      ref_decode_step_ms_p50=rm["decode_step_ms_p50"])
        print(f"[smoke] hopper vs reference engines: {same}/{total} "
              f"tokens equal, {identical}/{len(tokens)} requests identical",
              flush=True)
        print(f"[smoke] dual gate along the hopper tokens: max |dlogit| "
              f"{report['max_logit_err']:.5f} (tol {LOGIT_TOL}), "
              f"{report['greedy_equal_tokens']}/{report['n_tokens']} tokens "
              f"equal the reference replay's greedy token, "
              f"{report['high_margin_mismatches']} mismatches over "
              f"{report['high_margin_tokens']} high-margin tokens -> "
              f"{'OK' if report['ok'] else 'FAIL'}", flush=True)
        if not report["ok"]:
            fail("hopper serving failed the dual gate against reference")
    replays = {("reference", "bf16", i, tuple(t)): r
               for i, (t, r) in enumerate(zip(tokens, ref_logits))}
    replays.update({("hopper", "bf16", i, tuple(t)): r
                    for i, (t, r) in enumerate(zip(tokens, test_logits))})
    return counts, report, params, prompts, tokens, replays


class Replays:
    """Teacher-forced replays of token sequences, cached by (backend, pool
    dtype, request, tokens): the speculative runs mostly repeat the
    non-speculative run's tokens."""

    def __init__(self, cfg, params, prompts, cache, base=None):
        self.cfg, self.params, self.prompts = cfg, params, prompts
        self.cache = cache
        self.base = base or serve_kwargs()

    def __call__(self, backend, kv_dtype, tokens):
        from repro_torch.configs import ServeConfig
        from repro_torch.serving import replay_logits
        scfg = ServeConfig(**self.base)
        out = []
        for i, t in enumerate(tokens):
            key = (backend, kv_dtype, i, tuple(t))
            if key not in self.cache:
                self.cache[key] = replay_logits(
                    self.cfg, scfg, self.params, self.prompts[i], t,
                    attn_backend=backend, kv_dtype=kv_dtype)
            out.append(self.cache[key])
        return out


def serve_run(torch, cfg, params, prompts, label, proposer=None, base=None,
              seed=0, record=False, **kw):
    """One hopper engine run of ``prompts`` (``GEN_TOKENS`` new tokens
    each, serve settings ``base`` updated by ``kw``, the engine's frontend
    inputs drawn from ``seed``) with every launch count set to 0 just
    before and read just after; ``record``: the engine's logits kept too
    (``record_logits``, one device-to-host copy a step), as
    ``engine.recorded``.  Returns (tokens, metrics, counts, engine)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_verify,
                                                     paged_decode,
                                                     paged_verify)
    from repro_torch.kernels.ragged_prefill import (mla_build_kv,
                                                    mla_ragged_prefill,
                                                    ragged_prefill,
                                                    windowed_prefill)
    from repro_torch.serving import Engine
    eng = Engine(cfg, ServeConfig(attn_backend="hopper",
                                  **{**(base or serve_kwargs()), **kw}),
                 params, seed=seed, device="cuda")
    if proposer is not None:
        eng.proposer = proposer
    if record:
        eng.recorded = record_logits(torch, eng)
    kernels = {"K1": paged_decode, "K2": ragged_prefill, "K3": paged_verify,
               "K4": windowed_prefill, "K5": mla_paged_decode,
               "K6": mla_ragged_prefill, "K6-kv": mla_build_kv,
               "K7": mla_paged_verify, "K9": flash_attention}
    for fn in kernels.values():
        fn.launches = 0
    results, m = eng.run_offline(prompts, GEN_TOKENS)
    torch.cuda.synchronize()
    counts = {kid: fn.launches for kid, fn in kernels.items()}
    tokens = [r.tokens for r in results]
    if any(r.failed for r in results) \
            or any(len(t) != GEN_TOKENS for t in tokens) \
            or not all(0 <= x < cfg.vocab_padded for t in tokens for x in t):
        fail(f"{label}: failed, short or out-of-range requests")
    return tokens, m, counts, eng


def gate_line(label, rep):
    ulps = rep["max_logit_err_row_ulps"]
    tol = f"{ulps:.3f} row ulps (tol {rep['tol_row_ulps']} row ulps)" \
        if rep["tol_row_ulps"] is not None \
        else f"{ulps:.3f} row ulps (tol {rep['tol']})"
    print(f"[smoke] {label}: max |dlogit| {rep['max_logit_err']:.5f} = "
          f"{tol}, {rep['greedy_equal_tokens']}/{rep['n_tokens']} "
          f"tokens equal the reference replay's greedy token, "
          f"{rep['high_margin_mismatches']} mismatches over "
          f"{rep['high_margin_tokens']} high-margin tokens -> "
          f"{'OK' if rep['ok'] else 'FAIL'}", flush=True)
    if not rep["ok"]:
        fail(f"{label} failed the dual gate")


class Oracle:
    """Drafts the non-speculative hopper run's own continuation of each
    prompt, so verify steps run with up to ``k`` drafts that are accepted
    wherever the verify argmax reproduces that run."""

    def __init__(self, k, prompts, continuations):
        self.k = k
        self.plan = [(list(p), list(c))
                     for p, c in zip(prompts, continuations)]

    def propose(self, tokens):
        toks = list(tokens)
        for p, cont in self.plan:
            if toks[:len(p)] == p:
                g = len(toks) - len(p)
                return cont[g:g + self.k]
        return []


def spec_report(label, m, counts, tokens, base_tokens, n_layers,
                verify="K3", decode="K1"):
    """Print a speculative run's numbers and check its launch counts: the
    ``verify`` kernel (K3; K7 for MLA) once a layer per verify step, the
    ``decode`` kernel (K1; K5) never.  ``base_tokens`` are the
    non-speculative run's on the same pool dtype."""
    steps = m["decode_steps"]
    emitted = m["new_tokens"] - m["n_requests"]    # first tokens: prefill
    # each row of a verify step emits its accepted drafts plus one token
    per_row = emitted / max(emitted - m["spec_accepted"], 1)
    per_request = [sum(a == b for a, b in zip(t, u))
                   for t, u in zip(tokens, base_tokens)]
    same = sum(per_request)
    print(f"[smoke] {label}: {m['spec_proposed']} drafts proposed, "
          f"{m['spec_accepted']} accepted (accept rate "
          f"{m['spec_accept_rate']:.3f}), {per_row:.3f} tokens per row and "
          f"{emitted / max(steps, 1):.3f} per step over {steps} verify "
          f"steps, "
          f"{m['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{m['ttft_p50_s'] * 1e3:.1f} ms, step p50 "
          f"{m['decode_step_ms_p50']:.3f} ms, {same}/{m['new_tokens']} tokens "
          f"equal the non-speculative hopper run (per request "
          f"{per_request}); launches "
          f"{', '.join(f'{k} {c}' for k, c in counts.items() if c)}",
          flush=True)
    if counts[verify] != steps * n_layers or counts[decode] != 0:
        fail(f"{label}: {verify} launches {counts[verify]} != verify steps "
             f"{steps} x {n_layers} layers, or {decode} launched "
             f"{counts[decode]} times")
    return {"proposed": m["spec_proposed"], "accepted": m["spec_accepted"],
            "accept_rate": m["spec_accept_rate"],
            "tokens_per_row_step": per_row,
            "tokens_per_verify_step": emitted / max(steps, 1),
            "verify_steps": steps, "tokens_per_s": m["tokens_per_s"],
            "step_ms_p50": m["decode_step_ms_p50"],
            "tokens_equal_non_speculative": same,
            "tokens_equal_per_request": per_request}


def verify_rows(torch, cfg, params, prompts, tokens, Q=5, base=None):
    """Row j of a verify step against the decode step at pos + j, on the
    hopper backend at full width: all requests prefilled into one pool,
    one verify step over each request's first Q generated tokens, then Q
    decode steps fed the same tokens.  The verify step runs every dense op
    on each query token's [B, d] slice, the decode step's GEMM shape, and
    K3's row j runs K1's instruction sequence at pos + j, so every row must
    be bit for bit equal (the JAX package's contract)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models.attn_backend import (decode_meta, meta_to_device,
                                                 prefill_meta, verify_meta)
    from repro_torch.models.registry import build_model
    from repro_torch.serving import PagedKVPool
    model = build_model(cfg, "hopper")
    pool = PagedKVPool(cfg, ServeConfig(**(base or serve_kwargs())),
                       device="cuda")
    B = len(prompts)
    tables = np.zeros((B, pool.table_width), np.int32)
    for b, p in enumerate(prompts):
        pages = pool.alloc(pool.pages_for(len(p) + Q))
        tables[b, :len(pages)] = pages
        T = len(p)
        Tp = -(-T // PAGE) * PAGE
        toks = np.zeros((1, Tp), np.int32)
        toks[0, :T] = p
        meta = meta_to_device(prefill_meta(
            cfg, PAGE, tables[b:b + 1], np.zeros(1, np.int32),
            np.zeros(1, np.int32), np.array([T], np.int32), Tp), "cuda")
        model.prefill_paged(params, pool.kv, {}, meta,
                            torch.as_tensor(toks, device="cuda"))
    pos = np.array([len(p) for p in prompts], np.int32)
    vt = np.array([t[:Q] for t in tokens], np.int32)
    meta = meta_to_device(verify_meta(cfg, PAGE, tables, pos,
                                      np.full(B, Q, np.int32), Q), "cuda")
    vl = model.verify_paged(params, pool.kv, {}, meta,
                            torch.as_tensor(vt, device="cuda"))[0].float()
    err, equal_rows, same_argmax = 0.0, 0, 0
    for j in range(Q):
        meta = meta_to_device(decode_meta(cfg, PAGE, tables, pos + j), "cuda")
        dl = model.decode_paged(params, pool.kv, {}, meta, torch.as_tensor(
            vt[:, j], device="cuda"))[0].float()
        err = max(err, (dl - vl[:, j]).abs().max().item())
        equal_rows += int((dl == vl[:, j]).all(-1).sum().item())
        same_argmax += int((dl.argmax(-1) == vl[:, j].argmax(-1)).sum()
                           .item())
    print(f"[smoke] {cfg.name} verify rows vs decode steps at pos + j "
          f"(hopper, {B} rows x Q={Q}): {equal_rows}/{B * Q} rows bit for "
          f"bit equal, "
          f"{same_argmax}/{B * Q} equal argmax, max |dlogit| {err:.5f}",
          flush=True)
    if equal_rows != B * Q:
        fail(f"{cfg.name}: {B * Q - equal_rows} verify rows differ from the "
             "decode step at pos + j")
    return {"rows": B * Q, "bit_equal_rows": equal_rows,
            "equal_argmax": same_argmax, "max_logit_err": err}


def phase_speculate(torch, cfg, params, prompts, base_tokens, base_m,
                    replay):
    """Speculative serving, bf16, K = 4: (a) the n-gram proposer, (b) an
    oracle drafting the non-speculative run's tokens.  Each run is held to
    the dual gate along its own tokens.  Returns (K3 launches of run (a),
    report)."""
    from repro_torch.serving import dual_gate
    out = {"non_speculative": {"tokens_per_s": base_m["tokens_per_s"],
                               "step_ms_p50": base_m["decode_step_ms_p50"]}}
    k3 = 0
    with torch.no_grad():
        for label, proposer in (("ngram", None),
                                ("oracle", Oracle(4, prompts, base_tokens))):
            tokens, m, counts, _ = serve_run(
                torch, cfg, params, prompts, f"speculative {label}",
                proposer=proposer, speculate_tokens=4)
            out[label] = spec_report(f"speculative serve ({label})", m,
                                     counts, tokens, base_tokens,
                                     cfg.n_layers)
            rep = dual_gate(replay("reference", "bf16", tokens),
                            replay("hopper", "bf16", tokens), tokens,
                            tol=LOGIT_TOL)
            gate_line(f"dual gate along the speculative ({label}) tokens",
                      rep)
            out[label]["max_logit_err"] = rep["max_logit_err"]
            if label == "ngram":
                k3 = counts["K3"]
        out["verify_rows"] = verify_rows(torch, cfg, params, prompts,
                                         base_tokens)
    if out["oracle"]["accepted"] <= 0:
        fail("the oracle run accepted no draft")
    return k3, out


def phase_int8_serve(torch, cfg, params, prompts, replay, spec=(0, 4)):
    """int8 pages on hopper, without and with speculation (K = 4; ``spec``
    the draft lengths to run).  Each run is held to the dual gate against
    the int8 reference replay along its tokens; its quantization error is
    the bf16 reference replay's distance from the int8 one.  Returns
    (launch counts {K1-int8, K2-int8, K3-int8}, report)."""
    from repro_torch.serving import dual_gate
    counts, out, base = {"K2-int8": 0}, {}, None
    with torch.no_grad():
        for label, k in (("int8", 0), ("int8 speculative", 4)):
            if k not in spec:
                continue
            tokens, m, c, eng = serve_run(torch, cfg, params, prompts, label,
                                          kv_dtype="int8", speculate_tokens=k)
            bpt = eng.pool.kv_bytes_per_token
            del eng
            counts["K2-int8"] += c["K2"]
            if k:
                counts["K3-int8"] = c["K3"]
                out[label] = spec_report(f"{label} serve", m, c, tokens,
                                         base, cfg.n_layers)
            else:
                base = tokens
                counts["K1-int8"] = c["K1"]
                if c["K1"] != m["decode_steps"] * cfg.n_layers:
                    fail(f"int8: K1 launches {c['K1']} != decode steps "
                         f"{m['decode_steps']} x {cfg.n_layers} layers")
                out[label] = {"tokens_per_s": m["tokens_per_s"],
                              "step_ms_p50": m["decode_step_ms_p50"]}
            ref8 = replay("reference", "int8", tokens)
            rep = dual_gate(ref8, replay("hopper", "int8", tokens), tokens,
                            tol=LOGIT_TOL)
            quant = dual_gate(replay("reference", "bf16", tokens), ref8,
                              tokens, tol=LOGIT_TOL)
            print(f"[smoke] {label} serve: {m['new_tokens']} tokens, "
                  f"{m['tokens_per_s']:.1f} tok/s, TTFT p50 "
                  f"{m['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
                  f"{m['decode_step_ms_p50']:.3f} ms, pool {bpt:.0f} B per "
                  f"token; launches K1 {c['K1']}, K2 {c['K2']}, K3 "
                  f"{c['K3']}", flush=True)
            gate_line(f"dual gate of the {label} run against the int8 "
                      "reference replay", rep)
            print(f"[smoke] {label} quantization error: int8 vs bf16 "
                  f"reference replay along these tokens, max |dlogit| "
                  f"{quant['max_logit_err']:.5f}, "
                  f"{quant['greedy_equal_tokens']}/{quant['n_tokens']} "
                  f"tokens equal the bf16 greedy token", flush=True)
            out[label].update(max_logit_err=rep["max_logit_err"],
                              quant_max_logit_err=quant["max_logit_err"],
                              quant_greedy_equal=quant["greedy_equal_tokens"],
                              kv_bytes_per_token=bpt)
    return counts, out


FAULTS = "nan_logits:rid=1,at=2;step_error:rid=4,at=3;client_disconnect:rid=6,at=2"
FAULT_REASONS = {1: "nan_logits", 4: "step_error", 6: "cancelled"}
PRESSURE = "pool_pressure:at=20,pages=300,steps=10"
CARD = ""                      # nvidia-smi's name and power limit


def phase_frontend(torch, cfg, params, prompts, replay, seed):
    """Phase 20 (see the module docstring): the overlapped pipeline, the
    HTTP front end and fault injection on phase 6's weights and requests.
    Returns (launch counts {K1, K2} over the phase, report)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.kernels.ragged_prefill import ragged_prefill
    from repro_torch.launch import serve_http
    from repro_torch.launch.trace_report import host_pipeline
    from repro_torch.serving import Engine, FaultPlan, dual_gate
    t_phase = time.perf_counter()
    paged_decode.launches = 0
    ragged_prefill.launches = 0
    out = {}
    with torch.no_grad():
        # (a) pump() against step() on fresh engines, staging never syncing
        runs = {}
        for overlap in (False, True):
            eng = Engine(cfg, ServeConfig(attn_backend="hopper",
                                          **serve_kwargs()),
                         params, seed=seed, device="cuda")
            stage, n_stage = eng._stage_next, [0]

            def strict(pending, stage=stage, n_stage=n_stage):
                n_stage[0] += 1
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return stage(pending)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            eng._stage_next = strict
            results, m = eng.run_offline(prompts, GEN_TOKENS,
                                         overlap=overlap)
            torch.cuda.synchronize()
            if any(r.failed for r in results):
                fail(f"overlap={overlap}: a request failed")
            reg = eng.metrics
            runs[overlap] = {
                "tokens": [r.tokens for r in results],
                "tokens_per_s": m["tokens_per_s"],
                "decode_step_ms_p50": m["decode_step_ms_p50"],
                "decode_steps": m["decode_steps"], "wall_s": m["wall_s"],
                "stage_calls": n_stage[0],
                "staged": reg.value("engine.overlap_staged"),
                "used": reg.value("engine.overlap_used"),
                "dropped": reg.value("engine.overlap_dropped"),
                "host_pipeline_s": host_pipeline(
                    eng.tracer.to_dict()).get("per_phase_s", {})}
            del eng
        sync, ov = runs[False], runs[True]
        print(f"[smoke] pump vs step ({CARD}): step() {sync['tokens_per_s']:.1f} "
              f"tok/s, decode step p50 {sync['decode_step_ms_p50']:.3f} ms; "
              f"pump() {ov['tokens_per_s']:.1f} tok/s, decode step p50 "
              f"{ov['decode_step_ms_p50']:.3f} ms; plans staged "
              f"{ov['staged']}, used {ov['used']}, dropped {ov['dropped']} "
              f"({ov['stage_calls']} _stage_next calls under sync debug "
              f"mode 'error'); host pipeline "
              + ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in ov["host_pipeline_s"].items()),
              flush=True)
        if ov["tokens"] != sync["tokens"]:
            fail("pump() tokens differ from step() tokens")
        if not (ov["staged"] > 0 and ov["used"] > 0
                and ov["used"] + ov["dropped"] == ov["staged"]):
            fail(f"overlap counters staged {ov['staged']}, used {ov['used']}, "
                 f"dropped {ov['dropped']}")
        out["overlap"] = {k: {x: v for x, v in r.items() if x != "tokens"}
                          for k, r in (("step", sync), ("pump", ov))}
        base = sync["tokens"]

        # (b) the HTTP/SSE front end over phase 6's weights
        t0 = time.perf_counter()
        args = serve_http.parse_args([
            "--smoke", str(N_REQUESTS), "--slots", str(N_REQUESTS),
            "--prompt-len", "256", "--gen", str(GEN_TOKENS),
            "--attn-backend", "hopper", "--overload", "--timeout-s", "120",
            "--seed", str(seed)])
        eng, _, scfg = serve_http.build_engine(args, params=params)
        rc, http = serve_http.serve(eng, cfg, scfg, args)
        del eng
        http["seconds"] = time.perf_counter() - t0
        print(f"[smoke] HTTP front end ({CARD}): {http.get('streams')} "
              f"streams, {http.get('exact_tokens')}/{http.get('tokens')} "
              f"tokens equal the reference replay's greedy token, "
              f"{http.get('tokens_per_s', 0):.1f} tok/s, burst of "
              f"{http.get('overload_clients')}: "
              f"{http.get('overload_served')} served, "
              f"{http.get('overload_shed_503')} shed with 503, "
              f"{http.get('overload_failed')} failed in the engine; health "
              f"{' -> '.join(http.get('health_history', []))}; "
              f"{http['seconds']:.1f} s", flush=True)
        if rc != 0:
            fail("the serve_http smoke failed (see its lines above)")
        if http.get("health_history") != ["starting", "healthy", "draining",
                                          "drained"]:
            fail(f"health history {http.get('health_history')}")
        out["http"] = http

        # (c) faults, bf16 and int8: targets end with their reason, every
        # survivor equals the fault-free run of its pool dtype bit for bit
        out["faults"] = {}
        for kv_dtype in ("bf16", "int8"):
            kw = {**serve_kwargs(), "kv_dtype": kv_dtype}
            clean = base
            if kv_dtype == "int8":
                eng = Engine(cfg, ServeConfig(attn_backend="hopper", **kw),
                             params, seed=seed, device="cuda")
                clean = [r.tokens for r in
                         eng.run_offline(prompts, GEN_TOKENS)[0]]
                del eng
            plan = FaultPlan.parse(FAULTS)
            eng = Engine(cfg, ServeConfig(attn_backend="hopper", **kw),
                         params, seed=seed, device="cuda", faults=plan)
            results, _ = eng.run_offline(prompts, GEN_TOKENS, overlap=True)
            torch.cuda.synchronize()
            errors = {r.rid: r.error for r in results if r.failed}
            survivors = [r for r in results if r.rid not in FAULT_REASONS]
            equal = sum(r.tokens == clean[r.rid] for r in survivors)
            prefix = all(r.tokens == clean[r.rid][:len(r.tokens)]
                         for r in results if r.rid in FAULT_REASONS)
            print(f"[smoke] faults on {kv_dtype} pages ({FAULTS}): "
                  f"terminals {errors}, {equal}/{len(survivors)} survivors "
                  f"equal the fault-free run bit for bit, quarantined "
                  f"{eng.metrics.value('engine.quarantined')}, pages "
                  f"scrubbed {eng.metrics.value('pool.pages_scrubbed')}",
                  flush=True)
            if plan.unfired() or errors != FAULT_REASONS \
                    or equal != len(survivors) or not prefix \
                    or not eng.pool.conservation_ok():
                fail(f"faults on {kv_dtype} pages: unfired {plan.unfired()}, "
                     f"terminals {errors}, {equal}/{len(survivors)} "
                     f"survivors exact, target prefixes {prefix}")
            out["faults"][kv_dtype] = {
                "errors": errors, "survivors_equal": equal,
                "survivors": len(survivors)}
            del eng

        # pool pressure: hostage pages force a preemption; the replayed
        # prefills may batch differently, so the gate is the dual gate
        plan = FaultPlan.parse(PRESSURE)
        eng = Engine(cfg, ServeConfig(attn_backend="hopper",
                                      **serve_kwargs()),
                     params, seed=seed, device="cuda", faults=plan)
        results, _ = eng.run_offline(prompts, GEN_TOKENS, overlap=True)
        torch.cuda.synchronize()
        tokens = [r.tokens for r in results]
        n_pre = sum(r.n_preemptions for r in results)
        same = sum(a == b for t, u in zip(tokens, base)
                   for a, b in zip(t, u))
        del eng
        rep = dual_gate(replay("reference", "bf16", tokens),
                        replay("hopper", "bf16", tokens), tokens,
                        tol=LOGIT_TOL)
        print(f"[smoke] {PRESSURE}: {n_pre} preemptions, "
              f"{sum(not r.failed for r in results)}/{len(results)} requests "
              f"survived, {same}/{sum(map(len, tokens))} tokens equal the "
              f"fault-free run", flush=True)
        gate_line("dual gate of the pool-pressure run", rep)
        if plan.unfired() or any(r.failed for r in results) \
                or any(len(t) != GEN_TOKENS for t in tokens):
            fail(f"pool pressure: unfired {plan.unfired()} or a request "
                 "failed or came back short")
        out["pool_pressure"] = {"preemptions": n_pre, "tokens_equal": same,
                                "max_logit_err": rep["max_logit_err"]}
    torch.cuda.synchronize()
    counts = {"K1": paged_decode.launches, "K2": ragged_prefill.launches}
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[smoke] launches over phase 20: K1 {counts['K1']}, K2 "
          f"{counts['K2']}", flush=True)
    if counts["K1"] <= 0 or counts["K2"] <= 0:
        fail("K1 or K2 never launched in phase 20")
    return counts, out


# starcoder2-7b's serving workload: 4 requests of 1024, 3072, 4608 and 6144
# prompt tokens (the last two past the 4096-token window), 256-token
# chunks, 32 new tokens each, 16-token pages, prefix cache requested
SC_PROMPTS = (1024, 3072, 4608, 6144)


def window_serve_kwargs():
    return dict(page_size=PAGE, max_slots=len(SC_PROMPTS),
                max_len=-(-(max(SC_PROMPTS) + GEN_TOKENS) // PAGE) * PAGE,
                prefix_cache=True, prefill_chunk_tokens=CHUNK)


def phase_window_serve(torch, seed, arch="starcoder2-7b", n_layers=None,
                       why="", profile=True, tol_row_ulps=None, softcap=0.0,
                       score_sd=None):
    """A sliding-window path at full width (random weights from ``seed``;
    with ``score_sd``, wq at the gain that gives that pre-cap score std,
    ``capped_params``): ``arch`` at full depth, or cut to ``n_layers``
    layers for the reason ``why``, its scores capped at ``softcap``;
    served on the hopper backend, bf16 (K4 for every prefill
    chunk, K1 in ring mode for every decode step), then with K = 4 n-gram
    speculation (K3 in ring mode), then int8 pages without and with
    speculation.  Every run is held to the reference replay along its own
    tokens by the dual gate (gate 1 in row ulps where ``tol_row_ulps`` is
    given), and counts its agreement with the bf16
    non-speculative run (a speculative run also with the non-speculative
    run of its pool dtype); then a verify step's rows are compared with
    decode steps at ``pos + j``.  Returns (launch counts {K4, K1-ring,
    K3-ring, K4-int8, K1-ring-int8, K3-ring-int8}, report)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    from repro_torch.serving import dual_gate
    cfg = get_arch(arch)
    depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=n_layers or depth,
                              attn_logit_softcap=softcap)
    L = cfg.n_layers
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist() for n in SC_PROMPTS]
    base = window_serve_kwargs()
    counts, out = {}, {}
    with torch.no_grad():
        t0 = time.perf_counter()
        params = init_params(cfg, seed, "cuda") if score_sd is None \
            else capped_params(torch, cfg, seed, score_sd)[0]
        torch.cuda.synchronize()
        n_params = sum(leaf.numel() for _, leaf in tree_leaves(params))
        cut = f" (depth cut from {depth}: {why})" if L != depth else ""
        print(f"[smoke] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
              f"{L} layers{cut}, d_model {cfg.d_model}, {cfg.n_heads} query "
              f"/ {cfg.n_kv_heads} KV heads of {cfg.head_dim_}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab}, window {cfg.sliding_window}, "
              f"softcap {softcap}, pre-cap score std "
              f"{score_sd or 'as drawn'}, drawn on cuda in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        replay = Replays(cfg, params, prompts, {}, base=base)
        base_tokens, plain_tokens = None, {}
        for label, kv, k in (("bf16", "bf16", 0),
                             ("bf16 speculative", "bf16", 4),
                             ("int8", "int8", 0),
                             ("int8 speculative", "int8", 4)):
            t1 = time.perf_counter()
            tokens, m, c, eng = serve_run(
                torch, cfg, params, prompts, f"{cfg.name} {label}",
                base=base, kv_dtype=kv, speculate_tokens=k)
            bpt = eng.pool.kv_bytes_per_token
            sfx = "-int8" if kv == "int8" else ""
            if eng.radix is not None:
                fail(f"{label}: the prefix cache serves a page ring")
            if c["K4"] != m["prefill_steps"] * L or c["K2"]:
                fail(f"{label}: K4 launches {c['K4']} != prefill steps "
                     f"{m['prefill_steps']} x {L} layers, or K2 launched "
                     f"{c['K2']} times")
            if k:
                res = spec_report(f"{cfg.name} {label} serve", m, c, tokens,
                                  plain_tokens[kv], L)
                counts["K3-ring" + sfx] = c["K3"]
                # the ring kernels sum in position order, so the slack
                # page of the speculative pool changes no bit
                if res["tokens_equal_non_speculative"] != m["new_tokens"]:
                    fail(f"{cfg.name} {label}: "
                         f"{res['tokens_equal_non_speculative']}/"
                         f"{m['new_tokens']} tokens equal the {kv} "
                         "non-speculative stream")
            else:
                if c["K1"] != m["decode_steps"] * L or c["K3"]:
                    fail(f"{label}: K1 launches {c['K1']} != decode steps "
                         f"{m['decode_steps']} x {L} layers, or K3 "
                         f"launched {c['K3']} times")
                counts["K1-ring" + sfx] = c["K1"]
                counts["K4" + sfx] = c["K4"]
                res = {"tokens_per_s": m["tokens_per_s"],
                       "step_ms_p50": m["decode_step_ms_p50"],
                       "decode_steps": m["decode_steps"]}
                plain_tokens[kv] = tokens
            if base_tokens is None:
                base_tokens = tokens
                if profile:
                    profile_rerun(torch, eng, prompts[:2])
            del eng
            same = sum(a == b for t, u in zip(tokens, base_tokens)
                       for a, b in zip(t, u))
            print(f"[smoke] {cfg.name} {label} serve: {m['new_tokens']} "
                  f"tokens in {m['wall_s']:.3f} s = {m['tokens_per_s']:.1f} "
                  f"tok/s, decode step p50 {m['decode_step_ms_p50']:.3f} ms "
                  f"over {m['decode_steps']} steps, {m['prefill_steps']} "
                  f"prefill steps, pool {bpt:.0f} B per token, prefix cache "
                  f"off; launches K1 {c['K1']}, K2 {c['K2']}, K3 {c['K3']}, "
                  f"K4 {c['K4']}; {same}/{m['new_tokens']} tokens equal the "
                  f"bf16 non-speculative run", flush=True)
            ref = replay("reference", kv, tokens)
            rep = dual_gate(ref, replay("hopper", kv, tokens), tokens,
                            tol=LOGIT_TOL, tol_row_ulps=tol_row_ulps)
            gate_line(f"dual gate of the {cfg.name} {label} run against the "
                      f"{kv} reference replay", rep)
            res.update(max_logit_err=rep["max_logit_err"],
                       max_logit_err_row_ulps=rep["max_logit_err_row_ulps"],
                       greedy_equal_tokens=rep["greedy_equal_tokens"],
                       high_margin_tokens=rep["high_margin_tokens"],
                       tokens_equal_bf16_run=same, kv_bytes_per_token=bpt,
                       prefill_steps=m["prefill_steps"],
                       phase_s=time.perf_counter() - t1)
            if kv == "int8":
                quant = dual_gate(replay("reference", "bf16", tokens), ref,
                                  tokens, tol=LOGIT_TOL)
                print(f"[smoke] {cfg.name} {label} quantization error: int8 "
                      f"vs bf16 reference replay, max |dlogit| "
                      f"{quant['max_logit_err']:.5f} = "
                      f"{quant['max_logit_err_row_ulps']:.3f} row ulps, "
                      f"{quant['greedy_equal_tokens']}/{quant['n_tokens']} "
                      f"tokens equal the bf16 greedy token", flush=True)
                res["quant_max_logit_err"] = quant["max_logit_err"]
                res["quant_max_logit_err_row_ulps"] = \
                    quant["max_logit_err_row_ulps"]
            out[label] = res
        # where the speculative stream parts from the plain one: a verify
        # step's rows against decode steps at pos + j, on 2048-token
        # prefixes of the prompts
        out["verify_rows"] = verify_rows(
            torch, cfg, params, [p[:2048] for p in prompts],
            [t[:5] for t in base_tokens], base=base)
    return counts, out


# deepseek-v2-236b's depth cut: layer 0 dense and 1 MoE layer of 60 at
# full width (60 layers would be ~470 GB of bf16 weights)
DS_LAYERS = 2


def phase_mla_serve(torch, seed):
    """The MLA + MoE path: full-width deepseek-v2-236b cut to ``DS_LAYERS``
    layers (random weights from ``seed``) served on the hopper backend with
    phase 6's workload -- K6 for every prefill chunk (its stage A counted
    apart, once a K6 call), K5 for every decode step, counted -- with a
    profiled rerun for the device's busy share; then on the reference
    backend, and the hopper run held to the reference replay along its
    tokens by the dual gate.  Returns (launch counts {K5, K6, K6-kv, ...},
    report)."""
    import dataclasses
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_verify,
                                                     paged_decode,
                                                     paged_verify)
    from repro_torch.kernels.ragged_prefill import (mla_build_kv,
                                                    mla_ragged_prefill,
                                                    ragged_prefill,
                                                    windowed_prefill)
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Engine, dual_gate
    full = get_arch("deepseek-v2-236b")
    cfg = dataclasses.replace(full, n_layers=DS_LAYERS)
    L = cfg.n_layers
    rng = np.random.RandomState(seed + 2)
    prompts = serving_workload(rng, cfg.vocab)
    kw = serve_kwargs()
    kernels = (mla_paged_decode, mla_ragged_prefill, mla_paged_verify,
               paged_decode, paged_verify, ragged_prefill, windowed_prefill)
    with torch.no_grad():
        t0 = time.perf_counter()
        params = init_params(cfg, seed, "cuda")
        torch.cuda.synchronize()
        n_params = sum(leaf.numel() for _, leaf in tree_leaves(params))
        print(f"[smoke] {cfg.name}: {n_params / 1e9:.3f} B parameters "
              f"({n_params * 2 / 1e9:.1f} GB bf16), {L} layers (depth cut "
              f"from {full.n_layers}: full depth does not fit one card; "
              f"{cfg.first_k_dense} dense, {L - cfg.first_k_dense} MoE of "
              f"{cfg.n_experts} experts top-{cfg.top_k} + "
              f"{cfg.n_shared_experts} shared), d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads, kv_lora {cfg.kv_lora_rank}, vocab "
              f"{cfg.vocab}, drawn on cuda in {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
        eng = Engine(cfg, ServeConfig(attn_backend="hopper", **kw), params,
                     device="cuda")
        for fn in kernels + (mla_build_kv,):
            fn.launches = 0
        results, m = eng.run_offline(prompts, GEN_TOKENS)
        torch.cuda.synchronize()
        counts = {"K5": mla_paged_decode.launches,
                  "K6": mla_ragged_prefill.launches,
                  "K6-kv": mla_build_kv.launches}
        others = sum(fn.launches for fn in kernels[2:])
        tokens = [r.tokens for r in results]
        bpt = eng.pool.kv_bytes_per_token
        print(f"[smoke] {cfg.name} hopper serve: {m['n_requests']} requests, "
              f"{m['new_tokens']} tokens in {m['wall_s']:.3f} s = "
              f"{m['tokens_per_s']:.1f} tok/s, TTFT p50 "
              f"{m['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
              f"{m['decode_step_ms_p50']:.3f} ms over {m['decode_steps']} "
              f"steps, {m['prefill_steps']} prefill steps "
              f"({m['chunked_prefill_steps']} continuation chunks), prefix "
              f"cache hit rate {m['cache_hit_rate']:.3f}, pool {bpt:.0f} B "
              f"per token; launches K5 {counts['K5']}, K6 {counts['K6']} "
              f"(stage A {counts['K6-kv']}), K7 and K1-K4 {others}",
              flush=True)
        if any(r.failed for r in results) \
                or any(len(t) != GEN_TOKENS for t in tokens) \
                or not all(0 <= x < cfg.vocab_padded for t in tokens
                           for x in t):
            fail(f"{cfg.name}: failed, short or out-of-range requests")
        if counts["K5"] != m["decode_steps"] * L \
                or counts["K6"] != m["prefill_steps"] * L \
                or counts["K6-kv"] != counts["K6"] or others:
            fail(f"{cfg.name}: K5 launches {counts['K5']} != decode steps "
                 f"{m['decode_steps']} x {L}, or K6 launches {counts['K6']} "
                 f"(stage A {counts['K6-kv']}) "
                 f"!= prefill steps {m['prefill_steps']} x {L}, or K7 or a "
                 f"GQA kernel launched {others} times")
        busy = profile_rerun(torch, eng, prompts)
        del eng
        ref = Engine(cfg, ServeConfig(attn_backend="reference", **kw),
                     params, device="cuda")
        ref_results, rm = ref.run_offline(prompts, GEN_TOKENS)
        del ref
        ref_tokens = [r.tokens for r in ref_results]
        same = sum(a == b for t, u in zip(tokens, ref_tokens)
                   for a, b in zip(t, u))
        print(f"[smoke] {cfg.name} reference serve: {rm['tokens_per_s']:.1f}"
              f" tok/s, decode step p50 {rm['decode_step_ms_p50']:.3f} ms; "
              f"{same}/{m['new_tokens']} tokens equal the hopper run",
              flush=True)
        replay = Replays(cfg, params, prompts, {}, base=kw)
        ref_logits = replay("reference", "bf16", tokens)
        rep = dual_gate(ref_logits, replay("hopper", "bf16", tokens), tokens,
                        tol=LOGIT_TOL)
        top = [float(np.abs(r).max(-1).min()) for r in ref_logits] \
            + [float(np.abs(r).max(-1).max()) for r in ref_logits]
        print(f"[smoke] {cfg.name} reference replay logits: each token's "
              f"largest |logit| lies in [{min(top):.3f}, {max(top):.3f}]",
              flush=True)
        gate_line(f"dual gate of the {cfg.name} hopper run against the "
                  "reference replay", rep)
        t0 = time.perf_counter()
        spec_counts, spec = mla_speculate_int8(torch, cfg, params, prompts,
                                               tokens, replay, kw)
        counts.update(spec_counts)
        print(f"[smoke] {cfg.name} speculative and int8 runs took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params
    return counts, {**spec, 
        "n_layers": L, "tokens_per_s": m["tokens_per_s"],
        "decode_step_ms_p50": m["decode_step_ms_p50"],
        "decode_steps": m["decode_steps"],
        "prefill_steps": m["prefill_steps"], "busy_share": busy,
        "ref_tokens_per_s": rm["tokens_per_s"],
        "ref_decode_step_ms_p50": rm["decode_step_ms_p50"],
        "tokens_equal_reference_engine": same,
        "kv_bytes_per_token": bpt, "max_logit_err": rep["max_logit_err"],
        "max_logit_err_row_ulps": rep["max_logit_err_row_ulps"],
        "greedy_equal_tokens": rep["greedy_equal_tokens"],
        "n_tokens": rep["n_tokens"],
        "high_margin_tokens": rep["high_margin_tokens"],
        "high_margin_mismatches": rep["high_margin_mismatches"]}


def mla_speculate_int8(torch, cfg, params, prompts, base_tokens, replay,
                       base):
    """The MLA path's speculative and int8 runs on the hopper backend, with
    ``base_tokens`` the bf16 non-speculative run's tokens: K = 4 speculation
    with (a) the n-gram proposer and (b) an oracle drafting the base run's
    tokens (K7 four times a verify step, K5 never), then verify rows against
    decode steps at pos + j; then int8 latent pages without (K5-int8,
    K6-int8) and with speculation (K7-int8).  The n-gram and the int8 runs
    are profiled in a rerun of 4 tokens for the device's busy share (the
    other two are not: a profiled rerun of this model takes tens of
    seconds).  Each run is held to the reference replay of its pool dtype
    along its own tokens by the dual gate (the int8 runs' quantization
    error against the bf16 reference replay printed); each speculative
    stream must equal the plain stream of its pool dtype token for token.
    Returns (launch counts {K7, K5-int8, K6-int8, K6-kv-int8, K7-int8},
    report)."""
    from repro_torch.serving import dual_gate
    L = cfg.n_layers
    counts, out, plain = {}, {}, {"bf16": base_tokens}
    for label, kv, k, proposer, profile in (
            ("speculative ngram", "bf16", 4, None, True),
            ("speculative oracle", "bf16", 4,
             Oracle(4, prompts, base_tokens), False),
            ("int8", "int8", 0, None, True),
            ("int8 speculative", "int8", 4, None, False)):
        tokens, m, c, eng = serve_run(torch, cfg, params, prompts,
                                      f"{cfg.name} {label}", proposer=proposer,
                                      base=base, kv_dtype=kv,
                                      speculate_tokens=k)
        bpt = eng.pool.kv_bytes_per_token
        busy = profile_rerun(torch, eng, prompts, n_new=4) if profile \
            else None
        del eng
        if c["K6"] != m["prefill_steps"] * L or c["K6-kv"] != c["K6"] \
                or sum(c[kid] for kid in ("K1", "K2", "K3", "K4")):
            fail(f"{label}: K6 launches {c['K6']} (stage A {c['K6-kv']}) "
                 f"!= prefill steps {m['prefill_steps']} x {L}, or a GQA "
                 "kernel launched")
        sfx = "-int8" if kv == "int8" else ""
        if k:
            res = spec_report(f"{cfg.name} {label} serve", m, c, tokens,
                              plain[kv], L, verify="K7", decode="K5")
            counts.setdefault(f"K7{sfx}", c["K7"])
            if tokens != plain[kv]:
                fail(f"{cfg.name} {label}: the speculative stream differs "
                     f"from the plain {kv} stream")
        else:
            plain[kv] = tokens
            if c["K5"] != m["decode_steps"] * L or c["K7"]:
                fail(f"{label}: K5 launches {c['K5']} != decode steps "
                     f"{m['decode_steps']} x {L}, or K7 launched")
            counts.update({f"K5{sfx}": c["K5"], f"K6{sfx}": c["K6"],
                           f"K6-kv{sfx}": c["K6-kv"]})
            res = {"tokens_per_s": m["tokens_per_s"],
                   "step_ms_p50": m["decode_step_ms_p50"],
                   "decode_steps": m["decode_steps"]}
            print(f"[smoke] {cfg.name} {label} serve: {m['new_tokens']} "
                  f"tokens, {m['tokens_per_s']:.1f} tok/s, decode step p50 "
                  f"{m['decode_step_ms_p50']:.3f} ms over "
                  f"{m['decode_steps']} steps, pool {bpt:.0f} B per token; "
                  f"launches K5 {c['K5']}, K6 {c['K6']}", flush=True)
        ref = replay("reference", kv, tokens)
        rep = dual_gate(ref, replay("hopper", kv, tokens), tokens,
                        tol=LOGIT_TOL)
        gate_line(f"dual gate of the {cfg.name} {label} run against the "
                  f"{kv} reference replay", rep)
        res.update(max_logit_err=rep["max_logit_err"], kv_bytes_per_token=bpt,
                   busy_share=busy,
                   tokens_equal_plain=sum(a == b for t, u in zip(
                       tokens, plain[kv]) for a, b in zip(t, u)))
        if kv == "int8":
            quant = dual_gate(replay("reference", "bf16", tokens), ref,
                              tokens, tol=LOGIT_TOL)
            print(f"[smoke] {cfg.name} {label} quantization error: int8 vs "
                  f"bf16 reference replay along these tokens, max |dlogit| "
                  f"{quant['max_logit_err']:.5f}, "
                  f"{quant['greedy_equal_tokens']}/{quant['n_tokens']} "
                  f"tokens equal the bf16 greedy token", flush=True)
            res.update(quant_max_logit_err=quant["max_logit_err"],
                       quant_greedy_equal=quant["greedy_equal_tokens"])
        out[label] = res
    if out["speculative oracle"]["accepted"] <= 0:
        fail(f"{cfg.name}: the oracle run accepted no draft")
    out["verify_rows"] = verify_rows(torch, cfg, params, prompts,
                                     base_tokens, base=base)
    return counts, out


def k8_bound(M, N, K, esize):
    """(bound ms, bound_by, three-term bound ms, its bound_by) of one K8
    call: x, w, b read and out written once; 2 M N K flops at the fp32
    CUDA cores' 67 TFLOP/s (bf16: 989), and, for fp32, the 3 x 2 M N K
    TF32 flops of the tensor-core body's three terms at 495 TFLOP/s (bf16:
    one term, the same as the first)."""
    flops = 2 * M * N * K
    nbytes = (M * K + K * N + N + M * N) * esize
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    rate = FP32_FLOPS_PER_S if esize == 4 else BF16_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    t3 = 3 * flops / TF32_FLOPS_PER_S * 1e3 if esize == 4 else t_ops
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations",
            max(t_mem, t3), "bytes" if t_mem >= t3 else "operations")


def phase_gemm_sigmoid(torch, timer, seed):
    """K8 against its plain version at every layer of full-width mnist-dbn
    (784-1000-500-250-30): the positive phase [100, n_vis] x W, the
    negative phase [100, n_hid] x W.T (a view the kernel reads by index)
    and the forward-propagation job [60000, n_vis] x W, in fp32 within
    ``K8_TOL``; and layer 0's positive phase in bf16 within one bf16 ulp
    of the row's max; and Fig. 8's CD job, [2048, 784] x [784, 512] and
    [2048, 512] x W.T, in fp32.  Each shape also: a second call equal to the first
    bit for bit, and rows 0 and M - 1 computed alone equal to theirs in
    the batch (the split plan depends on N and K only); the fp32 CUDA-core
    bound and the three-term TF32 bound, the share of the lesser; and
    K8's registers and spills as ``ptxas`` reported them.  Returns a list
    of per-shape numbers, the fp32 layer-0 positive phase first, and the
    ptxas rows."""
    from repro_torch.configs.mnist_dbn import STACK
    from repro_torch.kernels import build_all
    from repro_torch.kernels.rbm_cd import gemm_sigmoid, gemm_sigmoid_plain
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")
    cases = []
    for i in range(len(STACK) - 1):
        nv, nh = STACK[i], STACK[i + 1]
        w = 0.1 * torch.randn((nv, nh), generator=gen, device="cuda")
        bv, bh = 0.1 * rand(nv), 0.1 * rand(nh)
        cases += [
            (f"L{i} hidden [100,{nv}]x[{nv},{nh}]", rand(100, nv), w, bh),
            (f"L{i} visible [100,{nh}]xW.T", (rand(100, nh) < 0.5).float(),
             w.T, bv),
            (f"L{i} forward-prop [60000,{nv}]x[{nv},{nh}]", rand(60000, nv),
             w, bh)]
    x, w, b = cases[0][1:]
    cases.append((cases[0][0], x.bfloat16(), w.bfloat16(), b.bfloat16()))
    # Fig. 8's CD job: RBM 784 x 512 on its whole global batch of 2048
    w = 0.1 * torch.randn((784, 512), generator=gen, device="cuda")
    bv, bh = 0.1 * rand(784), 0.1 * rand(512)
    cases += [("Fig. 8 hidden [2048,784]x[784,512]", rand(2048, 784), w, bh),
              ("Fig. 8 visible [2048,512]xW.T",
               (rand(2048, 512) < 0.5).float(), w.T, bv)]
    out = []
    for label, x, w, b in cases:
        name = f"K8 gemm_sigmoid {label} {str(x.dtype)[6:]}"
        got = gemm_sigmoid(x, w, b)
        want = gemm_sigmoid_plain(x, w, b)
        again = gemm_sigmoid(x, w, b)
        rows = [gemm_sigmoid(x[r:r + 1], w, b) for r in (0, x.shape[0] - 1)]
        torch.cuda.synchronize()
        if x.dtype == torch.float32:
            err = (got - want).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) and err <= K8_TOL
            print(f"[smoke] {name}: max|kernel - plain| = {err:.6g} (tol "
                  f"{K8_TOL}) -> {'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} disagrees with its plain version")
        else:
            err, _ = check_kernel(torch, name, got, want)
        repeat = torch.equal(got, again)
        alone = all(torch.equal(r[0], got[i]) for r, i in
                    zip(rows, (0, x.shape[0] - 1)))
        print(f"[smoke] {name}: a second call equal bit for bit: {repeat}; "
              f"rows 0 and {x.shape[0] - 1} alone equal to theirs in the "
              f"batch: {alone} -> {'OK' if repeat and alone else 'FAIL'}",
              flush=True)
        if not (repeat and alone):
            fail(f"{name}: two calls on the same inputs differ, or a row "
                 "alone differs from its row in the batch")
        ms = timer(lambda: gemm_sigmoid(x, w, b))
        plain_ms = timer(lambda: gemm_sigmoid_plain(x, w, b))
        library_ms = timer(lambda: torch.sigmoid(torch.addmm(b, x, w)))
        (M, K), N = x.shape, w.shape[1]
        bms, by, b3, by3 = k8_bound(M, N, K, x.element_size())
        least = min(bms, b3)
        print(f"[smoke] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sigmoid(addmm) {library_ms:.4f} ms ({ms / library_ms:.2f}x); "
              f"bound {bms:.4f} ms ({by}, fp32 CUDA cores), three-term "
              f"bound {b3:.4f} ms ({by3}, TF32 tensor cores); "
              f"{2 * M * N * K / ms / 1e9:.2f} TFLOP/s, {least / ms:.3f} of "
              f"the lesser bound", flush=True)
        out.append({"shape": label, "dtype": str(x.dtype)[6:],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": least, "bound_by": by if bms <= b3 else by3,
                    "bound_fp32_ms": bms, "bound_three_term_ms": b3,
                    "share_of_bound": least / ms, "library_ms": library_ms,
                    "repeat_bit_equal": repeat, "alone_bit_equal": alone})
    _, libs = build_all()
    ptxas = print_ptxas("gemm_sigmoid",
                        libs["gemm_sigmoid"].with_suffix(".log"))
    return out, ptxas


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cd_flips(torch, x, seed, steps=20):
    """The same CD-1 steps of mnist-dbn's first RBM (784 x 1000, batch 100)
    from the same parameters and the same uniforms (generators seeded
    alike), once through K8 and once through its plain version: a sample
    ``u < p`` flips where p moved across u, after which the two runs part.
    Returns (flips per step, max |dparam| and |d recon err| per step)."""
    from repro_torch.core.rbm import (RBMConfig, hidden_probs,
                                      phase_statistics, rbm_init, update,
                                      visible_probs)
    from repro_torch.kernels.rbm_cd import gemm_sigmoid_plain
    cfg = RBMConfig(n_vis=784, n_hid=1000)
    p0 = rbm_init(torch.Generator(device="cuda").manual_seed(seed + 3), cfg)

    def run(hid, vis):
        gen = torch.Generator(device="cuda").manual_seed(seed + 4)
        p = dict(p0)
        vel = {k: torch.zeros_like(v) for k, v in p.items()}
        trace = []
        for s in range(steps):
            v = x[s * 100:(s + 1) * 100]
            h_prob = hid(p, v)
            u = torch.rand(h_prob.shape, generator=gen, device="cuda")
            h_sample = (u < h_prob).float()
            v_neg = vis(p, h_sample)
            h_neg = hid(p, v_neg)
            stats = phase_statistics(v, h_prob, v_neg, h_neg)
            err = stats.pop("err")
            p, vel = update(p, vel, stats, cfg, 0)
            trace.append((h_sample, p, err))
        return trace
    with torch.no_grad():
        kern = run(hidden_probs, visible_probs)
        plain = run(lambda p, v: gemm_sigmoid_plain(v, p["W"], p["bh"]),
                    lambda p, h: gemm_sigmoid_plain(h, p["W"].T, p["bv"]))
    flips = [int((a[0] != b[0]).sum().item()) for a, b in zip(kern, plain)]
    dparam = [max((a[1][k] - b[1][k]).abs().max().item() for k in a[1])
              for a, b in zip(kern, plain)]
    derr = [abs(a[2].item() - b[2].item()) for a, b in zip(kern, plain)]
    return flips, dparam, derr


def phase_paper(torch, seed, n_train=60000, n_test=10000):
    """The paper's path at full width: mnist-dbn (784-1000-500-250-30)
    pre-trained layer by layer with one CD-1 epoch per RBM (batch 100)
    through K8 on ``n_train`` synthetic digits, then one epoch of
    autoencoder and one of classifier fine-tuning; the reconstruction error
    before and after, the classifier's test error against chance (0.9),
    the K8 launch count (3 a CD step and 1 a layer's forward-propagation
    job), the flips of CD samples between K8 and its plain version, and
    one fine-tuning step through ``core.mapreduce`` over NCCL at world
    size 1 against the plain step, bit for bit.  Returns (K8 launches,
    report)."""
    import torch.distributed as dist
    from repro_torch.configs.mnist_dbn import CONFIG, N_CLASSES, STACK
    from repro_torch.core import (DBNConfig, autoencoder, dp_groups,
                                  finetune, train_dbn)
    from repro_torch.data import train_test
    from repro_torch.kernels.rbm_cd import gemm_sigmoid
    from repro_torch.models.params import tree_leaves, tree_map
    t0 = time.perf_counter()
    Xtr, ytr, Xte, yte = train_test(n_train=n_train, n_test=n_test,
                                    seed=seed)
    print(f"[smoke] paper: {CONFIG.name} {STACK}, {n_train} / {n_test} "
          f"synthetic digits from seed {seed} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = 100
    cfg = DBNConfig(stack=STACK, max_epoch=1, batch_size=batch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    marks = []

    def mark(layer, epoch, recon_err):
        torch.cuda.synchronize()
        marks.append((layer, time.perf_counter(), recon_err))
    xtr = torch.as_tensor(Xtr, device="cuda")
    torch.cuda.synchronize()
    gemm_sigmoid.launches = 0
    t1 = time.perf_counter()
    stack = train_dbn(xtr, cfg, gen, callback=mark)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t1
    launches = gemm_sigmoid.launches
    steps_per_layer = n_train // batch
    cd_steps = steps_per_layer * (len(STACK) - 1)
    expected = 3 * cd_steps + (len(STACK) - 1)
    layers, last = [], t1
    for layer, t, err in marks:
        layers.append({"layer": layer, "n_vis": STACK[layer],
                       "n_hid": STACK[layer + 1], "cd_steps": steps_per_layer,
                       "seconds": t - last, "recon_err": err})
        print(f"[smoke] paper: RBM {STACK[layer]}x{STACK[layer + 1]}: "
              f"{steps_per_layer} CD steps in {t - last:.3f} s (with the "
              f"forward-propagation job before it) = "
              f"{steps_per_layer / (t - last):.1f} steps/s, recon err "
              f"{err:.5f}", flush=True)
        last = t
    print(f"[smoke] paper: pre-training took {pre_s:.3f} s = "
          f"{cd_steps / pre_s:.1f} CD steps/s; K8 launches {launches} (3 x "
          f"{cd_steps} CD steps + {len(STACK) - 1} forward-prop jobs = "
          f"{expected})", flush=True)
    if launches != expected:
        fail(f"paper: K8 launches {launches} != {expected}")
    if any(not math.isfinite(m[2]) for m in marks):
        fail("paper: non-finite reconstruction error in pre-training")

    busy = None
    prof = profile_device(torch, lambda: train_dbn(
        xtr[:50 * batch], DBNConfig(stack=STACK[:2], max_epoch=1,
                                    batch_size=batch),
        torch.Generator(device="cuda").manual_seed(seed)))
    if prof is not None:
        busy = print_profile("50 CD steps of the first RBM and its "
                             "forward-propagation job", *prof)

    ytr_t = torch.as_tensor(ytr.astype(np.int64), device="cuda")
    perm = torch.randperm(n_train, generator=gen, device="cuda")
    ae = autoencoder.unroll(stack)
    err_pre = autoencoder.reconstruction_error(ae, Xte)
    step = autoencoder.make_finetune_step(None)
    vel = tree_map(torch.zeros_like, ae)
    t1 = time.perf_counter()
    for b in range(steps_per_layer):
        ae, vel, loss, _ = step(ae, vel, {"x": xtr[perm[b * batch:
                                                        (b + 1) * batch]]})
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t1
    err_post = autoencoder.reconstruction_error(ae, Xte)
    print(f"[smoke] paper: autoencoder fine-tuning, {steps_per_layer} steps "
          f"in {ft_s:.3f} s; test reconstruction error per image "
          f"{err_pre:.4f} pre-trained -> {err_post:.4f} fine-tuned -> "
          f"{'OK' if err_post < err_pre else 'FAIL'}", flush=True)
    if not err_post < err_pre:
        fail("paper: fine-tuning did not lower the reconstruction error")

    clf = finetune.classifier_init(stack, N_CLASSES, gen)
    cstep = finetune.make_classifier_step(None, lr=CLASSIFIER_LR)
    cvel = tree_map(torch.zeros_like, clf)
    t1 = time.perf_counter()
    for b in range(steps_per_layer):
        idx = perm[b * batch:(b + 1) * batch]
        clf, cvel, loss, aux = cstep(clf, cvel, {"x": xtr[idx],
                                                 "y": ytr_t[idx]})
    torch.cuda.synchronize()
    cl_s = time.perf_counter() - t1
    test_err = finetune.error_rate(clf, Xte, yte)
    print(f"[smoke] paper: classifier fine-tuning, {steps_per_layer} steps "
          f"in {cl_s:.3f} s; test error {test_err:.4f} (chance 0.9) -> "
          f"{'OK' if test_err < 0.9 else 'FAIL'}", flush=True)
    if not test_err < 0.9:
        fail("paper: the classifier does not beat chance")

    flips, dparam, derr = cd_flips(torch, xtr, seed)
    first = next((s for s, f in enumerate(flips) if f), None)
    before = slice(0, len(flips) if first is None else first)
    dp_before = max(dparam[before], default=0.0)
    de_before = max(derr[before], default=0.0)
    ok = dp_before <= 1e-4 and de_before <= 1e-5
    print(f"[smoke] paper: {len(flips)} CD steps of layer 0, K8 vs plain "
          f"from the same parameters and uniforms: {sum(flips)} of "
          f"{len(flips) * batch * STACK[1]} samples flipped (first at step "
          f"{first}); before the first flip max|dparam| {dp_before:.3g} "
          f"(tol 1e-4), max|d recon err| {de_before:.3g} (tol 1e-5); over "
          f"all steps {max(dparam):.3g} and {max(derr):.3g} -> "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("paper: K8 and its plain version part before any flip")

    mb = {"x": xtr[:batch], "y": ytr_t[:batch]}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        a = finetune.make_classifier_step(None, lr=CLASSIFIER_LR)(
            clf, cvel, mb)
        b = finetune.make_classifier_step(dp_groups(1), lr=CLASSIFIER_LR)(
            clf, cvel, mb)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    ws1_equal = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_leaves(list(a[:3])), tree_leaves(list(b[:3]))))
    verdict = "equal bit for bit -> OK" if ws1_equal else "DIFFER"
    print(f"[smoke] paper: a classifier fine-tuning step through "
          f"core.mapreduce (NCCL, world size 1) vs the plain step: params, "
          f"velocities and loss {verdict}", flush=True)
    if not ws1_equal:
        fail("paper: the world-size-1 MapReduce step differs from the plain "
             "step")
    return launches, {
        "config": CONFIG.name, "stack": list(STACK), "n_train": n_train,
        "n_test": n_test, "batch": batch, "rbm_epochs": 1, "layers": layers,
        "pretrain_s": pre_s, "cd_steps": cd_steps,
        "cd_steps_per_s": cd_steps / pre_s, "k8_launches": launches,
        "k8_launches_expected": expected, "busy_share_cd": busy,
        "recon_err_pretrained": err_pre, "recon_err_finetuned": err_post,
        "finetune_s": ft_s, "classifier_test_error": test_err,
        "classifier_s": cl_s,
        "kernel_vs_plain": {"steps": len(flips), "flips": sum(flips),
                            "first_flip_step": first,
                            "max_dparam_before_flip": dp_before,
                            "max_derr_before_flip": de_before,
                            "max_dparam": max(dparam),
                            "max_derr": max(derr)},
        "mapreduce_ws1_bit_equal": ws1_equal}


FIG6_EPOCHS, FIG7_EPOCHS = 3, 5   # of the scripts' 8 and 25 fine-tuning
FIG_BATCH, FIG_RBM_EPOCHS = 128, 3  # the scripts' batch and max_epoch


def load_example(name: str):
    """``examples/<name>.py`` as a module (``examples/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_figures(torch, seed, n_train=60000, n_test=10000):
    """The paper's experiments through their entry points at mnist-dbn's
    full width (784-1000-500-250-30) on ``n_train`` / ``n_test`` synthetic
    digits from ``seed``: Fig. 6 (pre-training's 3 epochs, fine-tuning cut
    to ``FIG6_EPOCHS``; the test reconstruction error must fall from the
    first epoch to the last), Fig. 7 (``FIG7_EPOCHS``; the test error must
    beat chance, 0.9), AdaBoost with ``BoostConfig()`` on the training
    digits (a learner kept, the test error below 0.9), Fig. 8 at one
    worker on NCCL (a process of its own, which reports its K8 launches),
    and the two demos' ``main()`` at their own sizes.  K8's launches on
    each path must equal 3 a CD step + 1 a layer's forward-propagation job
    (0 for AdaBoost, whose hidden layer is plain torch), and every number
    must be finite.  Returns (K8 launches, report)."""
    from repro_torch.configs.mnist_dbn import CONFIG, STACK
    from repro_torch.core import adaboost
    from repro_torch.data import train_test
    from repro_torch.kernels.rbm_cd import gemm_sigmoid
    from repro_torch.launch import (fig6_unsup_error, fig7_sup_error,
                                    fig8_scaling)
    t_phase = time.perf_counter()
    report, total = {}, 0

    def expected(n, stack):
        return (3 * (n // FIG_BATCH) * FIG_RBM_EPOCHS + 1) * (len(stack) - 1)

    def run(fn):
        torch.cuda.synchronize()
        gemm_sigmoid.launches = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, gemm_sigmoid.launches, time.perf_counter() - t

    def check(label, launches, want, seconds, numbers):
        nonlocal total
        finite = all(math.isfinite(v) for v in numbers)
        ok = launches == want and finite
        print(f"[smoke] figures: {label}: {seconds:.1f} s; K8 launches "
              f"{launches} (expected {want}); numbers finite: {finite} -> "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if launches != want:
            fail(f"figures: {label}: K8 launches {launches} != {want}")
        if not finite:
            fail(f"figures: {label}: a number is not finite")
        total += launches
        report[label] = {"seconds": seconds, "k8_launches": launches}

    print(f"[smoke] figures: {CONFIG.name} {STACK} on {n_train} / {n_test} "
          f"digits from seed {seed}; fine-tuning cut from the scripts' 8 "
          f"to {FIG6_EPOCHS} epochs (Fig. 6) and from 25 to {FIG7_EPOCHS} "
          f"(Fig. 7) for the smoke's time; pre-training keeps its "
          f"{FIG_RBM_EPOCHS}", flush=True)
    sizes = dict(n_train=n_train, n_test=n_test, stack=STACK,
                 batch=FIG_BATCH, seed=seed, device="cuda")
    rows, n, s = run(lambda: fig6_unsup_error.run(
        epochs=FIG6_EPOCHS, **sizes))
    check("Fig. 6", n, expected(n_train, STACK), s,
          [v for r in rows for v in r[1:]])
    falls = rows[-1][2] < rows[0][2]
    print(f"[smoke] figures: Fig. 6 test reconstruction error "
          f"{rows[0][2]:.4f} (epoch 0) -> {rows[-1][2]:.4f} (epoch "
          f"{rows[-1][0]}) -> {'OK' if falls else 'FAIL'}", flush=True)
    if not falls:
        fail("figures: Fig. 6's test reconstruction error did not fall")
    report["Fig. 6"]["rows"] = rows

    rows, n, s = run(lambda: fig7_sup_error.run(
        epochs=FIG7_EPOCHS, **sizes))
    check("Fig. 7", n, expected(n_train, STACK), s,
          [v for r in rows for v in r[1:]])
    print(f"[smoke] figures: Fig. 7 final test error {rows[-1][2]:.4f} "
          f"(chance 0.9) -> {'OK' if rows[-1][2] < 0.9 else 'FAIL'}",
          flush=True)
    if not rows[-1][2] < 0.9:
        fail("figures: Fig. 7's classifier does not beat chance")
    report["Fig. 7"]["rows"] = rows

    Xtr, ytr, Xte, yte = train_test(n_train=n_train, n_test=n_test,
                                    seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = adaboost.BoostConfig()
    (learners, alphas), n, s = run(lambda: adaboost.fit(
        Xtr, ytr, cfg, gen))
    err = adaboost.error_rate(learners, alphas, Xte, yte)
    check("AdaBoost", n, 0, s, alphas + [err])
    ok = bool(learners) and err < 0.9
    print(f"[smoke] figures: AdaBoost {cfg}: {len(learners)} weak learners, "
          f"alphas {[round(a, 4) for a in alphas]}, test error {err:.4f} "
          f"(chance 0.9) -> {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("figures: AdaBoost kept no learner or does not beat chance")
    report["AdaBoost"].update(n_learners=len(learners), alphas=alphas,
                              test_error=err)

    t = time.perf_counter()
    row = fig8_scaling.run(device="cuda")[0]
    check("Fig. 8", row["k8_launches"], 3 * (fig8_scaling.TIMED_JOBS + 1),
          time.perf_counter() - t, [row["s_per_job"], row["err"]])
    print(f"[smoke] figures: Fig. 8 row {json.dumps(row)}", flush=True)
    report["Fig. 8"]["row"] = row

    demo, n, s = run(lambda: load_example("train_classifier_torch").main([]))
    check("classifier demo", n, expected(demo["n_train"], (784, 256, 64)),
          s, [v for v in demo.values() if isinstance(v, float)])
    report["classifier demo"].update(demo)
    demo, n, s = run(lambda: load_example("train_autoencoder_torch").main([]))
    check("autoencoder demo", n, expected(demo["n_train"], demo["stack"]),
          s, [v for v in demo.values() if isinstance(v, float)])
    report["autoencoder demo"].update(demo)
    report["seconds"] = time.perf_counter() - t_phase
    return total, report


# K9 and the training path: full-width qwen2-0.5b (14 query / 2 KV heads of
# 64) on token_batches(vocab, 8, 1024), AdamW at 3e-4, linear warmup + cosine
TR_B, TR_S, TR_STEPS, TR_LR = 8, 1024, 20, 3e-4
TR_REF_B = 2                   # (b): the reference backward keeps fp32 probs
TR_CKPT_LAYERS = 2             # (d): depth of the checkpoint/resume run
K9_FP32_TOL = 1e-5             # K9 vs plain in fp32 (another sum order)
K9_GRAD_TOL = 1e-5             # K9's backward vs autograd of plain, rel L2
TR_LOSS_TOL = 1e-2             # (b) |loss hopper - loss reference|
TR_GRAD_TOL = 0.1              # (b) per-leaf rel L2 of the gradients


K9_KERNELS = ("flash_wgmma_kernel", "flash_ffma_kernel",
              "flash_fwd_kernel")     # the last: the FFMA-only K9's name


def k9_bound(B, S, H, K, D, causal, esize, terms=1):
    """(bound ms, bound_by, flops, bytes) of one K9 call: (2 + 2 terms) B H
    D flops per (query, key) pair the mask keeps -- the function's 4 D, or
    6 D for the tensor-core body's PV with p as two bf16 terms -- and q, k,
    v and out read or written once."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = (2 + 2 * terms) * B * H * D * pairs
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * esize
    rate = BF16_FLOPS_PER_S if esize == 2 else FP32_FLOPS_PER_S
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations",
            flops, nbytes)


def flash_case(torch, timer, gen, label, B, S, H, K, D, causal, dt):
    """K9 on random inputs of one shape against its plain version (bf16
    within one bf16 ulp of the row's max, fp32 within ``K9_FP32_TOL``);
    bit for bit, each request alone against its rows in the batch and,
    causal, rows 0..999 of the inputs cut to S = 1000 against the full
    call's (S // 2 where S <= 1000); timed beside the plain version and
    ``scaled_dot_product_attention`` on K/V repeated to the query heads
    (the yardstick; the port never calls it), with the function's bound
    and, in bf16, the two-term body's.  Returns the numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt)
    name = f"K9 flash_attention {label} D={D} {str(dt)[6:]}"
    got = flash_attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if dt == torch.float32:
        err = (got - want).abs().max().item()
        ratio = err / K9_FP32_TOL
        ok = bool(torch.isfinite(got).all().item()) and ratio <= 1.0
        print(f"[smoke] {name}: max|kernel - plain| = {err:.6g} (tol "
              f"{K9_FP32_TOL}) -> {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
    else:
        err, ratio = check_kernel(torch, name, got, want)
    del want
    alone = rows_alone(torch, name, got, lambda b: flash_attention(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal))
    prefix = None
    if causal:
        cut = 1000 if S > 1000 else S // 2
        prefix = torch.equal(flash_attention(
            *(t[:, :cut].contiguous() for t in (q, k, v)),
            causal=True), got[:, :cut])
        print(f"[smoke] {name}: rows 0..{cut - 1} of the inputs cut to "
              f"S = {cut} equal the S = {S} call's bit for bit "
              f"{'-> OK' if prefix else '-> DIFFER'}", flush=True)
        if not prefix:
            fail(f"{name}: a causal row depends on the keys past it")
    ms = timer(lambda: flash_attention(q, k, v, causal=causal))
    plain_ms = timer(lambda: attention_plain(q, k, v, causal=causal))
    G = H // K
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, 1)
    vh = v.transpose(1, 2).repeat_interleave(G, 1)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal))
    esize = q.element_size()
    bms, by, flops, nbytes = k9_bound(B, S, H, K, D, causal, esize)
    two = (k9_bound(B, S, H, K, D, causal, esize, terms=2)[0]
           if dt == torch.bfloat16 else None)
    print(f"[smoke] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)"
          + (f", two-term bound {two:.4f} ms (6 D flops a pair)"
             if two else "")
          + f"; {flops / ms / 1e9:.2f} TFLOP/s of the function",
          flush=True)
    return {"shape": f"{label} B={B} S={S} H={H} K={K} D={D}",
            "dtype": str(dt)[6:], "max_abs_err": err,
            "err_over_bound": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by,
            "bound_two_term_ms": two, "library_ms": library_ms,
            "alone_bit_equal": alone, "prefix_bit_equal": prefix}


def phase_flash(torch, timer):
    """K9 against its plain version (``flash_case``): qwen2-0.5b's training
    shape (B 8, S 1024, 14 / 2 heads of 64) causal in bf16 (the main path's
    call), the same full (causal=False) and in fp32, and minitron-4b's heads
    (24 / 8 of 128) causal in bf16.  Then the ``ptxas`` lines of K9's
    library and the differentiable form's gradients against autograd
    through the plain version in fp32.  Returns the main shape's numbers
    with the others under "shapes"."""
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import (
        attention_plain, flash_attention, flash_attention_train)
    gen = torch.Generator(device="cuda").manual_seed(91)
    cases = [("qwen2-0.5b causal", 14, 2, 64, True, torch.bfloat16),
             ("qwen2-0.5b full", 14, 2, 64, False, torch.bfloat16),
             ("qwen2-0.5b causal", 14, 2, 64, True, torch.float32),
             ("minitron-4b causal", 24, 8, 128, True, torch.bfloat16)]
    out = [flash_case(torch, timer, gen, label, TR_B, TR_S, H, K, D, causal,
                      dt) for label, H, K, D, causal, dt in cases]

    _, libs = build_all()
    ptxas = print_ptxas("flash_attention",
                        libs["flash_attention"].with_suffix(".log"))
    B, S, H, K, D = 2, TR_S, 14, 2, 64
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda")
            for _ in range(2))
    n0 = flash_attention.launches
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(
        (flash_attention_train(*qkv, causal=True) * do).sum(), qkv)
    launched = flash_attention.launches - n0
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (attention_plain(*qkv, causal=True) * do).sum(), qkv)
    rel = {n: ((g - w).norm() / w.norm()).item()
           for n, g, w in zip("qkv", got, want)}
    ok = max(rel.values()) <= K9_GRAD_TOL and launched == 1
    print(f"[smoke] K9 gradients (B={B} S={S} 14/2 heads of 64, fp32, "
          f"causal) vs autograd through the plain version: rel L2 dq "
          f"{rel['q']:.3g}, dk {rel['k']:.3g}, dv {rel['v']:.3g} (tol "
          f"{K9_GRAD_TOL}); K9 launched {launched} time(s) for forward + "
          f"backward -> {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("K9's backward disagrees with autograd of its plain version")
    return {**out[0], "shapes": out, "grad_rel_l2": rel, "ptxas": ptxas}


def train_batches(cfg, B, S, n, seed):
    from repro_torch.data import token_batches
    it = token_batches(cfg.vocab, B, S, seed=seed)
    return [next(it)["tokens"] for _ in range(n)]


def train_run(torch, seed):
    """Phase 18 (a), and ``launch/train_cost.py --part train``: full-width,
    full-depth qwen2-0.5b with random weights from ``seed`` trained
    ``TR_STEPS`` AdamW steps on the hopper backend (K9 for each layer's
    attention): the loss, step time p50, tokens/s, peak memory and K9
    launches a step, failing unless the loss falls and K9 runs once a
    layer a step; then 3 more steps under ``torch.profiler``: the device's
    busy share of the wall time and K9's share of the device time.
    Returns (K9 launches, report, (cfg, ocfg, step, params0, state0,
    batches)) for the rest of phase 18."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = get_arch("qwen2-0.5b")
    ocfg = OptConfig(lr=TR_LR, schedule="linear_warmup_cosine",
                     warmup=max(1, TR_STEPS // 10), total_steps=TR_STEPS)
    params = init_params(cfg, seed, "cuda")
    state = init_opt_state(params, ocfg)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    batches = [torch.as_tensor(b, device="cuda")
               for b in train_batches(cfg, TR_B, TR_S, TR_STEPS + 3, seed)]
    step = make_train_step(cfg, ocfg, attn_backend="hopper")
    p0, s0 = params, state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    losses, times = [], []
    for b in batches[:TR_STEPS]:
        t0 = time.perf_counter()
        params, state, m = step(params, state, {"tokens": b})
        losses.append(m["loss"].item())           # synchronizes
        times.append(time.perf_counter() - t0)
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    p50 = sorted(times)[len(times) // 2]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ok = all(math.isfinite(x) for x in losses) and last < first \
        and launches == cfg.n_layers * TR_STEPS
    print(f"[smoke] train: {cfg.name} ({n_params / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers), B={TR_B} S={TR_S}, AdamW lr {TR_LR} "
          f"linear warmup + cosine, hopper: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the first 5 {first:.4f}, of the last "
          f"5 {last:.4f}); step p50 {p50 * 1e3:.1f} ms (first {times[0] * 1e3:.1f}"
          f" ms), {TR_B * TR_S / p50:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; K9 launches {launches} = "
          f"{launches / TR_STEPS:.1f} a step ({cfg.n_layers} layers) -> "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("train: the loss did not fall, or K9 was not launched once a "
             "layer a step")

    def more():
        nonlocal params, state
        for b in batches[TR_STEPS:]:
            params, state, m = step(params, state, {"tokens": b})
            m["loss"].item()
    busy = k9_ms = k9_share = None
    prof = profile_device(torch, more)
    if prof is not None:
        busy = print_profile("3 training steps (B=8, S=1024, hopper)", *prof)
        k9_us = sum(t for key, t, _ in prof[1]
                    if any(n in key for n in K9_KERNELS))
        k9_ms = k9_us / 1e3
        k9_share = k9_us / sum(t for _, t, _ in prof[1])
        print(f"[smoke] K9 in those 3 steps: {k9_ms:.3f} ms = "
              f"{k9_share:.3f} of device time", flush=True)
    del params, state
    torch.cuda.empty_cache()
    report = {
        "config": cfg.name, "n_params": n_params, "batch": TR_B,
        "seq_len": TR_S, "steps": TR_STEPS, "lr": TR_LR, "losses": losses,
        "loss_first5": first, "loss_last5": last,
        "step_ms_p50": p50 * 1e3, "tokens_per_s": TR_B * TR_S / p50,
        "peak_memory_gib": peak / 2**30,
        "k9_launches_per_step": launches / TR_STEPS, "busy_share": busy,
        "k9_device_ms_3_steps": k9_ms, "k9_share_of_device": k9_share}
    return launches, report, (cfg, ocfg, step, p0, s0, batches)


# the state-slot families' workloads (phase 21): mamba2-780m takes phase
# 6's 8 requests; recurrentgemma-2b 4 prompts straddling its 2048-token
# local-attention window, so that its ring wraps inside a prefill and
# during decode
RG_PROMPTS = (1500, 2040, 2100, 3000)
SS_LAYERS = {"mamba2-780m": 12}   # of 48: phase 21's depth cut
STATE_FAULT = "nan_logits:rid=1,at=4"


def state_workload(cfg, seed):
    """(prompts, serve settings, slots) of phase 21 for ``cfg``."""
    rng = np.random.RandomState(seed)
    if cfg.family == "ssm":
        return serving_workload(rng, cfg.vocab), serve_kwargs()
    kw = dict(page_size=PAGE, max_slots=len(RG_PROMPTS),
              max_len=-(-(max(RG_PROMPTS) + GEN_TOKENS) // PAGE) * PAGE)
    return [rng.randint(1, cfg.vocab, size=n).tolist()
            for n in RG_PROMPTS], kw


def record_logits(torch, eng):
    """Wrap ``eng``'s prefill (first and continuation chunk) and decode
    steps so that they keep, for every request, the logits each of its
    tokens was drawn from (copied to the host): {rid: [logits row, ...]}.
    The steps compute what the engine's own do (the model's step, argmax,
    finite flags).  The steps reach ``eng`` through a weak proxy: they
    are stored on it, so a strong reference would make a cycle that keeps
    the engine's pools on the card after ``del eng`` until the cyclic
    collector runs."""
    import weakref
    from repro_torch.models.registry import build_model
    model = build_model(eng.cfg, eng.attn_backend)
    rec = {}
    eng = weakref.proxy(eng)

    def recording(prefill):
        def prefill_rec(params, kv, state, meta, tokens, extras):
            logits, kv, state = prefill(params, kv, state, meta, tokens,
                                        extras)
            host = logits.float().cpu().numpy()
            n_live = meta["n_tail"].tolist()
            for r, i in enumerate(meta["slots"].tolist()):
                slot = eng.sched.slots[i] if i < len(eng.sched.slots) \
                    else None
                # only a prompt's last chunk draws its first token
                if slot is not None and slot.n_filled + n_live[r] \
                        >= len(slot.req.prompt):
                    rec.setdefault(slot.req.rid, []).append(host[r])
            return logits, kv, state
        return prefill_rec

    def decode_rec(params, kv, state, meta, tokens):
        logits, kv, state = model.decode_paged(params, kv, state, meta,
                                               tokens)
        host = logits.float().cpu().numpy()
        for i in eng.sched.decode_ready():
            rec[eng.sched.slots[i].req.rid].append(host[i])
        return (logits.argmax(-1).to(torch.int32),
                torch.isfinite(logits).all(-1), kv, state)
    eng._prefill, eng._decode = recording(eng._prefill), decode_rec
    eng._prefill_cont = recording(eng._prefill_cont)
    return rec


def phase_state_slots(torch, seed):
    """Phase 21 (see the module docstring): mamba2-780m and
    recurrentgemma-2b at full width and depth on the hopper backend.
    Returns the report; K1-K9's launches over the phase are printed (the
    path runs none of them)."""
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_verify,
                                                     paged_decode,
                                                     paged_verify)
    from repro_torch.kernels.ragged_prefill import (mla_build_kv,
                                                    mla_ragged_prefill,
                                                    ragged_prefill,
                                                    windowed_prefill)
    from repro_torch.kernels.rbm_cd import gemm_sigmoid
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    from repro_torch.serving import (Engine, FaultPlan, dual_gate,
                                     generate_static, replay_logits)
    kernels = {"K1": paged_decode, "K2": ragged_prefill, "K3": paged_verify,
               "K4": windowed_prefill, "K5": mla_paged_decode,
               "K6": mla_ragged_prefill, "K6-kv": mla_build_kv,
               "K7": mla_paged_verify, "K8": gemm_sigmoid,
               "K9": flash_attention}
    for fn in kernels.values():
        fn.launches = 0
    out = {}
    t_phase = time.perf_counter()
    for arch in ("mamba2-780m", "recurrentgemma-2b"):
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        if arch in SS_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=SS_LAYERS[arch])
        prompts, kw = state_workload(cfg, seed)
        scfg = ServeConfig(attn_backend="hopper", **kw)
        rep = {"layers": cfg.n_layers,
               "prompt_tokens": [len(p) for p in prompts]}

        def engine(**extra):
            return Engine(cfg, scfg, params, seed=seed, device="cuda",
                          **extra)
        with torch.no_grad():
            params = init_params(cfg, seed, "cuda")
            rep["parameters"] = sum(x.numel() for _, x in tree_leaves(params))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eng = engine()
            results, m = eng.run_offline(prompts, GEN_TOKENS)
            torch.cuda.synchronize()
            tokens = [r.tokens for r in results]
            rep.update(tokens_per_s=m["tokens_per_s"],
                       decode_step_ms_p50=m["decode_step_ms_p50"],
                       ttft_p50_ms=m["ttft_p50_s"] * 1e3,
                       prefill_steps=m["prefill_steps"],
                       decode_steps=m["decode_steps"],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       state_bytes_per_slot=eng.states.slot_nbytes)
            print(f"[smoke] {arch} ({cfg.n_layers} layers, "
                  f"{rep['parameters'] / 1e9:.3f} B parameters) on the "
                  f"hopper backend ({CARD}): {m['n_requests']} requests, "
                  f"{m['new_tokens']} tokens in {m['wall_s']:.3f} s = "
                  f"{m['tokens_per_s']:.1f} tok/s, TTFT p50 "
                  f"{rep['ttft_p50_ms']:.1f} ms, decode step p50 "
                  f"{m['decode_step_ms_p50']:.3f} ms over "
                  f"{m['decode_steps']} steps, {m['prefill_steps']} prefill "
                  f"steps, peak memory {rep['peak_gb']:.2f} GB, state "
                  f"{eng.states.slot_nbytes} B a slot", flush=True)
            if any(r.failed for r in results) \
                    or any(len(t) != GEN_TOKENS for t in tokens) \
                    or not all(0 <= x < cfg.vocab_padded for t in tokens
                               for x in t):
                fail(f"{arch}: failed, short or out-of-range requests")
            rep["busy_share"] = profile_rerun(torch, eng, prompts,
                                              device_only=True)
            del eng

            # (a) the engine's own logits (a rerun that records them)
            # against single-request replays, by the dual gate; and the
            # tokens equal to the static single-request baseline's
            eng = engine()
            rec = record_logits(torch, eng)
            again = [r.tokens for r in eng.run_offline(prompts,
                                                       GEN_TOKENS)[0]]
            del eng
            if again != tokens:
                fail(f"{arch}: a rerun's tokens differ from the first run's")
            replays = [replay_logits(cfg, scfg, params, p, t)
                       for p, t in zip(prompts, tokens)]
            gate = dual_gate(replays, [np.stack(rec[i])
                                       for i in range(len(prompts))],
                             tokens, tol=LOGIT_TOL)
            base, _ = generate_static(cfg, params, prompts, GEN_TOKENS, scfg,
                                      batch_size=1)
            same = sum(a == b for t, u in zip(tokens, base)
                       for a, b in zip(t, u))
            rep["gate"] = {k: gate[k] for k in (
                "max_logit_err", "max_logit_err_row_ulps", "n_tokens",
                "greedy_equal_tokens", "high_margin_tokens",
                "high_margin_mismatches", "ok")}
            rep["static_equal_tokens"] = same
            gate_line(f"{arch}: the engine's logits against single-request "
                      "replays", gate)
            print(f"[smoke] {arch}: {same}/{sum(map(len, tokens))} tokens "
                  f"equal the static single-request baseline's (--verify)",
                  flush=True)

            # (b) checkpoint and restore: the requests of slots 0 and 1
            # preempted mid-decode (0 first, so each is restored into the
            # other's slot); every stream equals the first run's
            eng = engine()
            for p in prompts:
                eng.add_request(p, GEN_TOKENS)
            moved = {}
            while eng.step():
                live = [eng.sched.slots[i] for i in (0, 1)]
                if not moved and not eng.sched.queue and all(
                        s is not None and len(s.req.generated) >= 4
                        for s in live):
                    for i in (0, 1):
                        moved[eng.sched.slots[i].req.rid] = i
                        eng.sched.preempt(i)
                for i, slot in enumerate(eng.sched.slots):
                    if slot is not None and slot.req.rid in moved \
                            and moved[slot.req.rid] == i:
                        fail(f"{arch}: request {slot.req.rid} restored into "
                             "the slot it left")
            res = sorted(eng.collect(), key=lambda r: r.rid)
            restores = eng.metrics.value("engine.state_restores")
            exact = sum(r.tokens == t for r, t in zip(res, tokens))
            print(f"[smoke] {arch}: checkpoint/restore of requests "
                  f"{sorted(moved)} into each other's slots: "
                  f"{restores} restores, {exact}/{len(res)} streams equal "
                  f"the un-preempted run bit for bit", flush=True)
            if len(moved) != 2 or restores != 2 or exact != len(res) \
                    or eng.states.num_claimed:
                fail(f"{arch}: checkpoint/restore: {len(moved)} preempted, "
                     f"{restores} restores, {exact}/{len(res)} exact")
            rep["restore"] = {"restores": restores, "exact_streams": exact}
            del eng

            # (c) a NaN-poisoned state row: its request ends with its
            # reason, every survivor equals the fault-free run bit for bit
            plan = FaultPlan.parse(STATE_FAULT)
            eng = engine(faults=plan)
            res, _ = eng.run_offline(prompts, GEN_TOKENS, overlap=True)
            torch.cuda.synchronize()
            errors = {r.rid: r.error for r in res if r.failed}
            equal = sum(r.tokens == tokens[r.rid] for r in res
                        if r.rid != 1)
            print(f"[smoke] {arch}: fault {STATE_FAULT}: terminals "
                  f"{errors}, {equal}/{len(res) - 1} survivors equal the "
                  f"fault-free run bit for bit", flush=True)
            if plan.unfired() or errors != {1: "nan_logits"} \
                    or equal != len(res) - 1 \
                    or res[1].tokens != tokens[1][:len(res[1].tokens)]:
                fail(f"{arch}: state-row poison: unfired {plan.unfired()}, "
                     f"terminals {errors}, {equal} survivors exact")
            rep["fault"] = {"errors": errors, "survivors_equal": equal}
            del eng, params
        torch.cuda.empty_cache()
        rep["seconds"] = time.perf_counter() - t_arch
        out[arch] = rep
    torch.cuda.synchronize()
    out["launches"] = {k: fn.launches for k, fn in kernels.items()}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[smoke] launches of K1-K9 over phase 21 (none expected): "
          + ", ".join(f"{k} {v}" for k, v in out["launches"].items()),
          flush=True)
    return out


# phase 22: seamless-m4t-large-v2 at full width, SM_LAYERS + SM_LAYERS of
# its 24 + 24 layers, 8 requests of
# 32..512 decoder prompt tokens, each conditioned on 4096 frames (the JAX
# package's ENC_LEN_DECODE), 128-token chunks; llava-next-34b at full width
# cut to 8 of 60 layers, 4 requests of 576 image + 64..512 text tokens
SM_ENC_LEN, SM_CHUNK = 4096, 128
SM_LAYERS = 6                  # encoder and decoder layers, of 24 + 24
SM_PROMPTS = [int(x) for x in np.linspace(32, 512, 8)]
LV_LAYERS = 8
LV_PROMPTS = [int(x) for x in np.linspace(64, 512, 4)]


def frontend_gate(torch, cfg, params, prompts, tokens, rec, scfg, seed,
                  label):
    """The engine's own logits ``rec`` (``serve_run(record=True)``) along
    its ``tokens`` against single-request ``replay_logits`` on the
    reference backend with the same pool dtype and each request's frontend
    input, by the dual gate.  Returns the gate's report."""
    from repro_torch.serving import dual_gate, replay_logits
    from repro_torch.serving.engine import _synthetic_frontend
    t0 = time.perf_counter()
    replays = [replay_logits(cfg, scfg, params, p, t,
                             attn_backend="reference",
                             frontend=_synthetic_frontend(cfg, scfg, seed, i))
               for i, (p, t) in enumerate(zip(prompts, tokens))]
    gate = dual_gate(replays, [np.stack(rec[i]) for i in range(len(prompts))],
                     tokens, tol=LOGIT_TOL)
    print(f"[smoke] {label}: {len(replays)} reference replays and the gate "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gate_line(f"{label}: the engine's logits against single-request "
              f"reference replays", gate)
    return {k: gate[k] for k in (
        "max_logit_err", "max_logit_err_row_ulps", "n_tokens",
        "greedy_equal_tokens", "high_margin_tokens", "high_margin_mismatches",
        "ok")}


def frontend_metrics(m):
    return {"tokens_per_s": m["tokens_per_s"],
            "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
            "decode_step_ms_p50": m["decode_step_ms_p50"],
            "prefill_steps": m["prefill_steps"],
            "chunked_prefill_steps": m["chunked_prefill_steps"],
            "decode_steps": m["decode_steps"]}


def phase_frontend_families(torch, rng, timer, seed):
    """Phase 22 (see the module docstring): (a) K1, K2 (bf16, int8) at
    G = 1 with 16 KV heads of 64, K1, K2 and K3 at G = 7 with 8 KV heads of
    128, and K9 in its full mode at the encoder's shape, each against its
    plain version; (b) seamless-m4t-large-v2 and (c) llava-next-34b served
    on the hopper backend.  Returns (launch counts, kernel numbers,
    report)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    t_phase = time.perf_counter()
    kern = {}
    for q in (False, True):
        sfx = "-int8" if q else ""
        kern["K1-G1" + sfx] = phase_decode(torch, rng, timer, int8=q, K=16,
                                           G=1, D=64, label="K1-G1")
        kern["K2-G1" + sfx] = phase_prefill(torch, rng, timer, int8=q, K=16,
                                            G=1, D=64, label="K2-G1")
    kern["K1-G7-D128"] = phase_decode(torch, rng, timer, K=8, G=7, D=128,
                                      label="K1-G7-D128")
    kern["K2-G7-D128"] = phase_prefill(torch, rng, timer, K=8, G=7, D=128,
                                       label="K2-G7-D128")
    kern["K3-G7-D128"] = phase_verify(torch, rng, timer, K=8, G=7, D=128,
                                      label="K3-G7-D128")
    gen = torch.Generator(device="cuda").manual_seed(92)
    kern["K9-full"] = flash_case(torch, timer, gen, "seamless encoder full",
                                 2, SM_ENC_LEN, 16, 16, 64, False,
                                 torch.bfloat16)
    torch.cuda.empty_cache()
    out = {"kernel_checks_s": time.perf_counter() - t_phase}
    counts = {}

    # (b) seamless-m4t-large-v2: SM_LAYERS + SM_LAYERS layers, bf16 then
    # int8 pages
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("seamless-m4t-large-v2"),
                              n_enc_layers=SM_LAYERS, n_dec_layers=SM_LAYERS)
    L = cfg.n_dec_layers
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist() for n in SM_PROMPTS]
    base = dict(page_size=PAGE, max_slots=len(prompts),
                max_len=-(-(max(SM_PROMPTS) + GEN_TOKENS) // PAGE) * PAGE,
                enc_len=SM_ENC_LEN, prefill_chunk_tokens=SM_CHUNK)
    rep = {"prompt_tokens": SM_PROMPTS, "enc_len": SM_ENC_LEN}
    with torch.no_grad():
        params = init_params(cfg, seed, "cuda")
        rep["parameters"] = sum(x.numel() for _, x in tree_leaves(params))
        for kv in ("bf16", "int8"):
            label = f"seamless-m4t-large-v2 {kv}"
            tokens, m, c, eng = serve_run(torch, cfg, params, prompts, label,
                                          base=base, seed=seed, kv_dtype=kv,
                                          record=True)
            slot = eng.states.slot_nbytes
            first = m["prefill_steps"] - m["chunked_prefill_steps"]
            r = {**frontend_metrics(m), "slot_bytes": slot,
                 "launches": {k: c[k] for k in ("K1", "K2", "K9")}}
            print(f"[smoke] {label} ({SM_LAYERS} + {SM_LAYERS} of 24 + 24 "
                  "layers, "
                  f"{rep['parameters'] / 1e9:.3f} B parameters, hopper, "
                  f"{CARD}): {m['n_requests']} requests, {m['new_tokens']} "
                  f"tokens in {m['wall_s']:.3f} s = {m['tokens_per_s']:.1f} "
                  f"tok/s, TTFT p50 {r['ttft_p50_ms']:.1f} ms, decode step "
                  f"p50 {m['decode_step_ms_p50']:.3f} ms over "
                  f"{m['decode_steps']} steps, {m['prefill_steps']} prefill "
                  f"steps ({m['chunked_prefill_steps']} continuation "
                  f"chunks), {slot} B of cross K/V a slot; launches K1 "
                  f"{c['K1']}, K2 {c['K2']}, K9 {c['K9']}", flush=True)
            if c["K1"] != m["decode_steps"] * L \
                    or c["K2"] != m["prefill_steps"] * L \
                    or c["K9"] != first * cfg.n_enc_layers \
                    or not m["chunked_prefill_steps"] \
                    or slot != 2 * L * SM_ENC_LEN * 16 * 64 * 2:
                fail(f"{label}: launches K1 {c['K1']}, K2 {c['K2']}, K9 "
                     f"{c['K9']} for {m['decode_steps']} decode and "
                     f"{m['prefill_steps']} prefill steps ({first} first "
                     f"chunks), or {slot} B a slot")
            if kv == "bf16":
                # ~10^5 host ops a rerun: trace the device alone, once
                t1 = time.perf_counter()
                r["busy_share"] = profile_rerun(torch, eng, prompts,
                                                device_only=True)
                print(f"[smoke] {label}: profiled rerun "
                      f"{time.perf_counter() - t1:.1f} s", flush=True)
            r["gate"] = frontend_gate(torch, cfg, params, prompts, tokens,
                                      eng.recorded, eng.scfg, seed, label)
            del eng
            sfx = "" if kv == "bf16" else "-int8"
            counts["K1-G1" + sfx] = c["K1"]
            counts["K2-G1" + sfx] = c["K2"]
            counts["K9-full"] = counts.get("K9-full", 0) + c["K9"]
            rep[kv] = r
        del params
    torch.cuda.empty_cache()
    rep["seconds"] = time.perf_counter() - t0
    out["seamless-m4t-large-v2"] = rep

    # (c) llava-next-34b at full width, 8 of 60 layers: bf16, then n-gram
    # speculation at K = 4, whose stream must equal the plain one
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("llava-next-34b"), n_layers=LV_LAYERS)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist() for n in LV_PROMPTS]
    base = dict(page_size=PAGE, max_slots=len(prompts),
                max_len=-(-(max(LV_PROMPTS) + GEN_TOKENS) // PAGE) * PAGE,
                prefix_cache=True, prefill_chunk_tokens=256)
    rep = {"layers": LV_LAYERS, "image_tokens": cfg.n_image_tokens,
           "prompt_tokens": LV_PROMPTS}
    with torch.no_grad():
        params = init_params(cfg, seed, "cuda")
        rep["parameters"] = sum(x.numel() for _, x in tree_leaves(params))
        label = "llava-next-34b bf16"
        tokens, m, c, eng = serve_run(torch, cfg, params, prompts, label,
                                      base=base, seed=seed, record=True)
        print(f"[smoke] {label} ({LV_LAYERS} of 60 layers, "
              f"{rep['parameters'] / 1e9:.3f} B parameters, hopper, {CARD}): "
              f"{m['n_requests']} requests of {cfg.n_image_tokens} image + "
              f"{LV_PROMPTS} text tokens, {m['new_tokens']} tokens in "
              f"{m['wall_s']:.3f} s = {m['tokens_per_s']:.1f} tok/s, TTFT "
              f"p50 {m['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
              f"{m['decode_step_ms_p50']:.3f} ms over {m['decode_steps']} "
              f"steps, {m['prefill_steps']} prefill steps "
              f"({m['chunked_prefill_steps']} chunked), prefix cache "
              f"{'refused' if eng.radix is None else 'ON'}; launches K1 "
              f"{c['K1']}, K2 {c['K2']}, K3 {c['K3']}", flush=True)
        if eng.radix is not None or m["chunked_prefill_steps"] \
                or c["K1"] != m["decode_steps"] * LV_LAYERS \
                or c["K2"] != m["prefill_steps"] * LV_LAYERS:
            fail(f"{label}: the prefix cache was not refused, a prompt was "
                 f"chunked, or launches K1 {c['K1']}, K2 {c['K2']} do not "
                 "match the steps")
        r = {**frontend_metrics(m),
             "launches": {k: c[k] for k in ("K1", "K2", "K3")},
             "busy_share": profile_rerun(torch, eng, prompts,
                                         device_only=True),
             "gate": frontend_gate(torch, cfg, params, prompts, tokens,
                                   eng.recorded, eng.scfg, seed, label)}
        del eng
        counts["K1-G7-D128"], counts["K2-G7-D128"] = c["K1"], c["K2"]
        rep["bf16"] = r
        # n-gram drafts (what users run), then an oracle drafting the
        # plain run's own tokens, so that verify rows of up to five live
        # queries and accepted drafts really run at llava's shapes
        for how, proposer in (("ngram", None),
                              ("oracle", Oracle(4, prompts, tokens))):
            stokens, m, c, eng = serve_run(
                torch, cfg, params, prompts, f"llava-next-34b {how}",
                proposer=proposer, base=base, seed=seed, speculate_tokens=4)
            del eng
            rep[how] = {**frontend_metrics(m), **spec_report(
                f"llava-next-34b speculative serve ({how}, K = 4)", m, c,
                stokens, tokens, LV_LAYERS)}
            if stokens != tokens:
                fail(f"llava-next-34b: the speculative ({how}) stream "
                     "differs from the plain stream")
            if how == "ngram":
                counts["K3-G7-D128"] = c["K3"]
                counts["K2-G7-D128"] += c["K2"]
        if rep["oracle"]["accepted"] <= 0:
            fail("llava-next-34b: the oracle run accepted no draft")
        del params
    torch.cuda.empty_cache()
    rep["seconds"] = time.perf_counter() - t0
    out["llava-next-34b"] = rep
    out["seconds"] = time.perf_counter() - t_phase
    return counts, kern, out


# phase 23: the training forward of the last four families.  recurrentgemma
# is cut for memory: the out-of-place AdamW step holds the old and the new
# optimizer state (fp32 master, mu, nu) beside the fp32 gradients, ~32 B a
# parameter, 113.6 GB at its full 3.55 B parameters; 8 of 26 layers (2
# groups of (RG-LRU, RG-LRU, local attention) and the 2 tail layers) hold
# 2.0 B.  llava-next-34b keeps 2 of 60 layers (2.04 B parameters, 65 GB).
TF_B, TF_S, TF_STEPS = 2, 512, 3
TF_LAYERS = {"recurrentgemma-2b": 8, "llava-next-34b": 2}
TF_CHECK_B, TF_CHECK_S = 1, 128         # (b) cuda vs CPU, fp32
TF_CHECK_LAYERS = {"mamba2-780m": 2, "recurrentgemma-2b": 3}
TF_CHECK_LOSS_TOL = 1e-4                # (b) |loss cuda - loss CPU|
TF_CHECK_GRAD_TOL = 1e-3                # (b) per-leaf rel L2, cuda vs CPU
TF_ZERO_TOL = 1e-2                      # (b) |grad bk| / |grad bq|, enc-dec
# (b) seamless's hopper-vs-reference gate runs at 6 + 6 layers: at 24 + 24
# the two bf16 runs part by a median 0.099, worst 0.114 on an H100 (6 + 6:
# 0.079 / 0.087; llava's 2 layers: 0.010 / 0.011), and each lies ~0.11
# from the reference in fp32 (K9 0.112 / 0.124, reference 0.107 / 0.124).
# So at full depth the witness (``fp32_witness``) holds hopper's distance
# from fp32 to the bf16 reference's, within a quarter at the median and at
# the worst leaf (JAX's own bf16 seamless gradients part from its fp32
# ones ~6x as far as llava's: tests/test_torch_train_families.py)
TF_REF_LAYERS = 6
TF_WITNESS_RATIO = 1.25


def family_batch(torch, cfg, B, S, seed, device):
    """A training batch drawn with numpy from ``seed``: tokens [B, S] and
    the arch's frontend input as JAX ``registry.input_defs`` declares it
    -- frames [B, S, frontend_dim] (enc-dec) or image embeddings [B,
    n_image_tokens, frontend_dim] (vlm) -- standard normals rounded to
    bf16, as the engine's ``_synthetic_frontend`` draws them."""
    rng = np.random.default_rng([seed, 23])
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                     device=device)}
    n = S if cfg.enc_dec else cfg.n_image_tokens
    if n:
        x = rng.standard_normal((B, n, cfg.frontend_dim), np.float32)
        key = "frames" if cfg.enc_dec else "image_embeds"
        out[key] = torch.from_numpy(x).to(device=device,
                                          dtype=torch.bfloat16)
    return out


def grad_gap(torch, got, want):
    """(|dloss|, worst per-leaf rel L2, its leaf, median, zero-leaf ratio)
    of two ``value_and_grad`` results, on ``got``'s device.  The enc-dec
    cross-attention's key bias has a zero gradient in exact arithmetic (q
    . bk is the same for every key, and the softmax cancels it): it is
    left out of the relative errors, and the ratio returned is the larger
    of its gradient's norm over the query bias's on either side (None
    without such a leaf)."""
    from repro_torch.models.params import tree_leaves
    g, w = dict(tree_leaves(got[2])), dict(tree_leaves(want[2]))

    def norm(t):
        return t.float().norm().item()

    rel, zero = {}, None
    for p, a in g.items():
        b = w[p].to(a.device)
        if p.endswith("cross_attn/bk"):
            q = p[:-2] + "bq"
            zero = max(norm(a) / norm(g[q]), norm(b) / norm(w[q]))
            continue
        rel[p] = norm(a.float() - b.float()) / max(norm(b), 1e-30)
    worst = max(rel, key=rel.get)
    return (abs(got[0].item() - want[0].item()), rel[worst], worst,
            float(np.median(list(rel.values()))), zero)


def vs_reference(torch, name, cfg, params, batch, gate, witness=False):
    """Phase 23 (b) for one enc-dec or vlm config: one step's loss and
    gradients on hopper against reference from the same parameters and
    batch, printed, and failing the run beyond ``TR_LOSS_TOL`` /
    ``TR_GRAD_TOL`` (the enc-dec key bias's gradient, zero exactly, within
    ``TF_ZERO_TOL`` of the query bias's) when ``gate``; ``witness``: then
    ``fp32_witness`` on the same step.  Returns the numbers."""
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.models.registry import build_model
    got, want = (value_and_grad(build_model(cfg, be).loss, params, batch)
                 for be in ("hopper", "reference"))
    dloss, worst, leaf, med, zero = grad_gap(torch, got, want)
    ok = dloss <= TR_LOSS_TOL and worst <= TR_GRAD_TOL \
        and (zero is None or zero <= TF_ZERO_TOL)
    print(f"[smoke] train {name}: one step at B={TF_B}, hopper (K9, fp32 p) "
          f"vs reference (chunked, bf16 p): loss {got[0].item():.6f} vs "
          f"{want[0].item():.6f}, |dloss| {dloss:.3g} (tol {TR_LOSS_TOL}); "
          f"gradients rel L2 median {med:.3g}, worst {worst:.3g} at {leaf} "
          f"(tol {TR_GRAD_TOL})"
          + ("" if zero is None else
             f"; cross_attn/bk (zero exactly) {zero:.3g} of bq's norm (tol "
             f"{TF_ZERO_TOL})")
          + (f" -> {'OK' if ok else 'FAIL'}" if gate else " (not gated)"),
          flush=True)
    if gate and not ok:
        fail(f"train {name}: hopper and reference gradients part")
    out = {"dloss": dloss, "grad_rel_l2_worst": worst,
           "grad_rel_l2_worst_leaf": leaf, "grad_rel_l2_median": med,
           "zero_leaf_ratio": zero, "gated": gate}
    if witness:
        out["witness"] = fp32_witness(torch, name, cfg, params, batch, got,
                                      want)
    del got, want
    torch.cuda.empty_cache()
    return out


class Fp32Probs:
    """The reference backend with the probabilities of its two training
    cores (the decoder's causal self-attention, the encoder's full one)
    kept in fp32, as K9 keeps them: q, k and v enter in fp32 (exactly),
    the output is rounded back to their dtype.  Everything else is the
    reference's."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, attr):
        return getattr(self.base, attr)

    def train_attend(self, q, k, v, **kw):
        return self.base.train_attend(q.float(), k.float(), v.float(),
                                      **kw).to(v.dtype)

    def full_attend(self, q, k, v, **kw):
        return self.base.full_attend(q.float(), k.float(), v.float(),
                                     **kw).to(v.dtype)


def fp32_witness(torch, name, cfg, params, batch, got, want):
    """Phase 23 (b)'s witness of where the gap between ``got`` (hopper,
    bf16) and ``want`` (reference, bf16) comes from, on the same step: (1)
    the reference with its cores' probabilities in fp32 (``Fp32Probs``)
    against hopper; (2) the reference in fp32 (the parameters cast to fp32,
    TF32 off), against which both bf16 runs are held.  Fails the run when
    hopper's gradients are further from the fp32 ones than
    ``TF_WITNESS_RATIO`` times the reference's, at the median or the worst
    leaf, or its loss beyond ``TR_LOSS_TOL``.  Returns the numbers."""
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.models.params import tree_map
    from repro_torch.models.registry import build_model

    def gap(a, b):
        d = grad_gap(torch, a, b)
        return {"dloss": d[0], "grad_rel_l2_worst": d[1],
                "grad_rel_l2_worst_leaf": d[2], "grad_rel_l2_median": d[3]}
    model = build_model(cfg, "reference")
    model.attn_backend = Fp32Probs(model.attn_backend)
    probs = value_and_grad(model.loss, params, batch)
    out = {"hopper_vs_fp32_probs": gap(got, probs)}
    del probs
    torch.cuda.empty_cache()
    p32 = tree_map(lambda t: t.float(), params)
    fp32 = value_and_grad(build_model(cfg, "reference").loss, p32, batch)
    del p32
    out["hopper_vs_fp32"] = gap(got, fp32)
    out["reference_vs_fp32"] = gap(want, fp32)
    del fp32
    torch.cuda.empty_cache()
    k9, ref = out["hopper_vs_fp32"], out["reference_vs_fp32"]
    ok = k9["dloss"] <= TR_LOSS_TOL and all(
        k9[k] <= TF_WITNESS_RATIO * ref[k]
        for k in ("grad_rel_l2_median", "grad_rel_l2_worst"))
    for what, d in out.items():
        print(f"[smoke] train {name}: witness {what.replace('_', ' ')}: "
              f"|dloss| {d['dloss']:.3g}; gradients rel L2 median "
              f"{d['grad_rel_l2_median']:.3g}, worst "
              f"{d['grad_rel_l2_worst']:.3g} at "
              f"{d['grad_rel_l2_worst_leaf']}", flush=True)
    print(f"[smoke] train {name}: hopper's gradients from fp32's within "
          f"{TF_WITNESS_RATIO}x the reference's (median "
          f"{k9['grad_rel_l2_median']:.3g} vs {ref['grad_rel_l2_median']:.3g}"
          f", worst {k9['grad_rel_l2_worst']:.3g} vs "
          f"{ref['grad_rel_l2_worst']:.3g}; |dloss| {k9['dloss']:.3g}, tol "
          f"{TR_LOSS_TOL}) -> {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"train {name}: hopper's gradients are further from fp32's "
             f"than {TF_WITNESS_RATIO}x the reference's")
    out["ok"] = ok
    return out


def phase_train_families(torch, timer, seed):
    """Phase 23 (see the module docstring): (c) K9 at the training shapes
    of llava (causal, 56 / 8 heads of 128, S 1088) and of seamless's
    encoder (full) and decoder (causal), 16 / 16 of 64 at S 512, against
    its plain version; (b)
    one step's loss and gradients, seamless and llava on hopper against
    reference, mamba2 and recurrentgemma in fp32 on the card against the
    CPU; (a) ``TF_STEPS`` AdamW steps of each family through
    ``make_train_step(attn_backend="hopper")`` with K9's launches by mode
    counted around each run.  Returns (launch counts, kernel numbers,
    report)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.registry import build_model, init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    t_phase = time.perf_counter()
    # the AdamW steps need the card: what the earlier phases still hold,
    # before and after the cyclic collector (``record_logits`` made cycles
    # that held phase 22's engines until it ran)
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[smoke] train families: {held / 2**30:.2f} GiB held on the card "
          f"at the phase's start, {torch.cuda.memory_allocated() / 2**30:.2f}"
          " after gc.collect()", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(93)
    lv = get_arch("llava-next-34b")
    kern = {
        "K9-D128": flash_case(torch, timer, gen, "llava train causal", TF_B,
                              TF_S + lv.n_image_tokens, lv.n_heads,
                              lv.n_kv_heads, lv.head_dim_, True,
                              torch.bfloat16),
        "K9-full": flash_case(torch, timer, gen, "seamless encoder train "
                              "full", TF_B, TF_S, 16, 16, 64, False,
                              torch.bfloat16),
        "K9-G1": flash_case(torch, timer, gen, "seamless decoder train "
                            "causal", TF_B, TF_S, 16, 16, 64, True,
                            torch.bfloat16)}
    torch.cuda.empty_cache()
    out = {"kernel_checks_s": time.perf_counter() - t_phase}

    def arch(name, layers):
        cfg = get_arch(name)
        return dataclasses.replace(cfg, n_layers=layers) if layers else cfg

    # (b) mamba2 / recurrentgemma: the same ops on the card and the CPU
    t0 = time.perf_counter()
    checks = {}
    for name, layers in TF_CHECK_LAYERS.items():
        cfg = arch(name, layers)
        p = tree_map(lambda t: t.float(), init_params(cfg, seed, "cuda"))
        pc = tree_map(lambda t: t.cpu(), p)
        b = family_batch(torch, cfg, TF_CHECK_B, TF_CHECK_S, seed, "cuda")
        got = value_and_grad(build_model(cfg, "hopper").loss, p, b)
        want = value_and_grad(build_model(cfg, "reference").loss, pc,
                              {k: v.cpu() for k, v in b.items()})
        dloss, worst, leaf, med, _ = grad_gap(torch, got, want)
        ok = dloss <= TF_CHECK_LOSS_TOL and worst <= TF_CHECK_GRAD_TOL
        print(f"[smoke] train {name} ({layers} layers, full width, fp32, "
              f"B={TF_CHECK_B} S={TF_CHECK_S}): one step on the card "
              f"(hopper) vs the CPU (reference): loss {got[0].item():.6f} vs "
              f"{want[0].item():.6f}, |dloss| {dloss:.3g} (tol "
              f"{TF_CHECK_LOSS_TOL}); gradients rel L2 median {med:.3g}, "
              f"worst {worst:.3g} at {leaf} (tol {TF_CHECK_GRAD_TOL}) -> "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"train {name}: the card's step and the CPU's part")
        checks[name] = {"layers": layers, "dloss": dloss,
                        "grad_rel_l2_worst": worst,
                        "grad_rel_l2_worst_leaf": leaf,
                        "grad_rel_l2_median": med}
        del p, pc, got, want
        torch.cuda.empty_cache()
    out["cuda_vs_cpu_s"] = time.perf_counter() - t0

    counts = {}
    ocfg = OptConfig(lr=TR_LR)
    for name in ("mamba2-780m", "recurrentgemma-2b",
                 "seamless-m4t-large-v2", "llava-next-34b"):
        t0 = time.perf_counter()
        cfg = arch(name, TF_LAYERS.get(name))
        params = init_params(cfg, seed, "cuda")
        n_params = sum(x.numel() for _, x in tree_leaves(params))
        batches = [family_batch(torch, cfg, TF_B, TF_S, seed + i, "cuda")
                   for i in range(TF_STEPS)]
        rep = {"layers": cfg.n_dec_layers + cfg.n_enc_layers
               if cfg.enc_dec else cfg.n_layers, "parameters": n_params}
        if cfg.enc_dec or cfg.n_image_tokens:
            # (b) hopper vs reference, one step from these params; seamless
            # gated at TF_REF_LAYERS + TF_REF_LAYERS and, at full depth,
            # against fp32 by the witness (see TF_REF_LAYERS)
            rep["vs_reference"] = vs_reference(
                torch, name, cfg, params, batches[0], gate=not cfg.enc_dec,
                witness=cfg.enc_dec)
            if cfg.enc_dec:
                small = dataclasses.replace(cfg, n_enc_layers=TF_REF_LAYERS,
                                            n_dec_layers=TF_REF_LAYERS)
                rep["vs_reference_gated"] = vs_reference(
                    torch, f"{name} ({TF_REF_LAYERS} + {TF_REF_LAYERS} "
                    "layers)", small, init_params(small, seed, "cuda"),
                    batches[0], gate=True)
        # (a) AdamW steps through the entry point, K9 counted by mode
        state = init_opt_state(params, ocfg)
        step = make_train_step(cfg, ocfg, attn_backend="hopper")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.mode_launches.clear()
        losses, times = [], []
        for batch in batches:
            t1 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())           # synchronizes
            times.append(time.perf_counter() - t1)
        modes = {f"{c} D{d}": n
                 for (c, d), n in flash_attention.mode_launches.items()}
        launches = sum(modes.values())
        peak = torch.cuda.max_memory_allocated()
        del params, state, step, batches, batch
        torch.cuda.empty_cache()
        want_modes = {}
        if cfg.enc_dec:
            want_modes = {"full D64": cfg.n_enc_layers * TF_STEPS,
                          "causal D64": cfg.n_dec_layers * TF_STEPS}
        elif cfg.n_image_tokens:
            want_modes = {f"causal D{cfg.head_dim_}": cfg.n_layers * TF_STEPS}
        ok = all(math.isfinite(x) for x in losses) and modes == want_modes
        p50 = sorted(times)[len(times) // 2]
        ntok = TF_B * (TF_S + cfg.n_image_tokens)
        print(f"[smoke] train {name} ({rep['layers']} layers, "
              f"{n_params / 1e9:.3f} B parameters, {CARD}), B={TF_B} "
              f"S={TF_S}{f' + {cfg.n_image_tokens} image' if cfg.n_image_tokens else ''}"
              f", AdamW lr {TR_LR}, hopper: losses "
              f"{[round(x, 4) for x in losses]}; step p50 {p50 * 1e3:.1f} ms "
              f"(first {times[0] * 1e3:.1f} ms), {ntok / p50:.0f} tokens/s; "
              f"peak memory {peak / 2**30:.2f} GiB; K9 launches {launches} "
              f"{modes} (expected {want_modes}) -> "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"train {name}: a loss is not finite, or K9's launches "
                 "by mode do not match the layers")
        if cfg.enc_dec:
            counts["K9-full"] = modes["full D64"]
            counts["K9-G1"] = modes["causal D64"]
        elif cfg.n_image_tokens:
            counts["K9-D128"] = modes["causal D128"]
        rep.update({"losses": losses, "step_ms_p50": p50 * 1e3,
                    "step_ms_first": times[0] * 1e3,
                    "tokens_per_s": ntok / p50,
                    "peak_memory_gib": peak / 2**30, "k9_launches": modes,
                    "seconds": time.perf_counter() - t0})
        if name in checks:
            rep["cuda_vs_cpu"] = checks[name]
        out[name] = rep
    out["seconds"] = time.perf_counter() - t_phase
    return counts, kern, out


# phase 24: the attention logit softcap (``cfg.attn_logit_softcap``: every
# scaled score becomes c * tanh(s / c) before the mask) through K1-K4.  No
# registered arch sets a cap; Gemma 2 caps its attention logits at 50
# (arXiv:2408.00118).  Capped configs are registered ones with the cap set
# (``dataclasses.replace``), as the JAX tests build them.
CAP = 50.0                     # Gemma 2's attention logit softcap
CAP_WITNESS = (50.0, 30.0, 20.0, 10.0, 5.0)   # the witness's caps, in order
CAP_WITNESS_MIN = 4 * LOGIT_TOL    # the least max |dlogit| the cap must make
CAP_SAT_GAIN = 64              # saturating case: q x 64 (exact in bf16)
# Random weights give pre-cap scores of std d_model * std(wq) * std(wk)
# (unit-RMS inputs; 0.008 at full-depth qwen2-0.5b, whose stacked init
# counts the layer axis in the fan-in), where no cap of 5 or more acts.
# Phase 24's models draw wq at the gain that gives them std CAP_SCORE_SD,
# as a trained model's attention logits spread: the largest of a few
# thousand keys then reach about 3.5 x that.
CAP_SCORE_SD = 3.0
# At std 4, c = 50 moves full-depth qwen2's logits by more than
# CAP_WITNESS_MIN; phase 24 (f) runs it there, beside the uncapped model.
CAP_GAP_SD = 4.0
CAP_GAP_RATIO = 1.25           # hopper's distance from fp32 / reference's
CAP_PROMPTS = (1, 3, 5, 7)     # qwen2: 4 of the main path's 8 prompts
CAP_MT_LAYERS = 2              # minitron-4b, of 32: K2 at head dim 128


def capped_params(torch, cfg, seed, sd=CAP_SCORE_SD):
    """``init_params(cfg, seed)`` on the card with every layer's wq times
    the gain that gives pre-cap scores of std ``sd``: a score is the
    scaled dot of q and k over the head dim, each a d_model-long sum of
    unit-RMS inputs times weights, so its std is d_model * std(wq) *
    std(wk).  Returns (params, gain)."""
    from repro_torch.models.registry import init_params
    params = init_params(cfg, seed, "cuda")
    attn = params["blocks"]["attn"]
    gain = sd / (cfg.d_model * attn["wq"].float().std().item()
                 * attn["wk"].float().std().item())
    attn["wq"].mul_(gain)
    return params, gain


def shadow_backend(torch):
    """The ``shadow`` attention backend, registered on first use: hopper's
    K1-K4, each call also run through its plain version on the same
    inputs and on those inputs in fp32 (exact p, fp32 out).  ``.worst``
    keeps by kernel mode the worst ``ulp_ratio`` over the live rows of
    kernel vs plain, kernel vs fp32 and plain vs fp32.  Its outputs are
    hopper's."""
    from repro_torch.models import attn_backend as ab
    if "shadow" in ab.available_backends():
        return ab.get_backend("shadow")
    ref = ab.get_backend("reference")

    def mode(kid, kw):
        ring = "-ring" if kw.get("window") and kid != "K4" else ""
        return kid + ring + ("-int8" if kw.get("k_scale") is not None
                             else "")

    def f32(t):
        return t.float() if torch.is_tensor(t) and t.is_floating_point() \
            else t

    @ab.register_backend
    class Shadow(ab.HopperBackend):
        name = "shadow"
        worst = {}

        def hold(self, kid, got, plain, q, args, kw, live=None):
            exact = plain(f32(q), *map(f32, args),
                          **{k: f32(v) for k, v in kw.items()})
            want = plain(q, *args, **kw)
            if live is not None:        # rows past a request's live ones
                got, want, exact = (t * live[:, :, None, None]
                                    for t in (got, want, exact))
            w = self.worst.setdefault(kid, dict.fromkeys(
                ("kernel_vs_plain", "kernel_vs_fp32", "plain_vs_fp32"), 0.0))
            for key, a, b in (("kernel_vs_plain", got, want),
                              ("kernel_vs_fp32", got, exact),
                              ("plain_vs_fp32", want, exact)):
                w[key] = max(w[key], ulp_ratio(torch, a, b)[1])

        def decode_attend(self, q, *args, **kw):
            got = super().decode_attend(q, *args, **kw)
            self.hold(mode("K1", kw), got, ref.decode_attend, q, args, kw)
            return got

        def prefill_attend(self, q, *args, **kw):
            got = super().prefill_attend(q, *args, **kw)
            live = torch.arange(q.shape[1], device=q.device)[None, :] \
                < args[6][:, None]                          # n_live
            self.hold(mode("K4" if kw.get("window") else "K2", kw), got,
                      ref.prefill_attend, q, args, kw, live)
            return got

        def verify_attend(self, q, *args, **kw):
            got = super().verify_attend(q, *args, **kw)
            live = torch.arange(q.shape[1], device=q.device)[None, :] \
                < args[4][:, None]                          # n_q
            self.hold(mode("K3", kw), got, ref.verify_attend, q, args, kw,
                      live)
            return got
    return ab.get_backend("shadow")


def cap_gap(torch, seed, sd=CAP_GAP_SD, cap=CAP):
    """Phase 24 (f): qwen2-0.5b at full width and depth, wq at the gain
    that gives pre-cap scores of std ``sd``, served on hopper at softcap
    ``cap``.  Along the run's tokens, at softcap ``cap`` and at 0, replays
    on the ``shadow`` backend (hopper, every K1/K2 call also held to its
    plain version and to its fp32 attend on the model's own inputs), on
    the reference backend, and on the reference with the parameters in
    fp32 (pages bf16).  Prints hopper's distance from the reference (the
    capped run's dual gate, not gated: peaked attention at this depth
    spreads bf16 runs apart, capped or not), each bf16 replay's distance
    from the fp32 one, and the witness (hopper capped vs uncapped).
    Fails when a kernel mode's calls lie further from their fp32 attend
    than its plain version's do plus one row ulp, when hopper lies
    further from fp32 than ``CAP_GAP_RATIO`` x the reference does, or
    when the cap moves no logit by more than ``CAP_WITNESS_MIN``.
    Returns the report."""
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.models.params import tree_map
    from repro_torch.serving import dual_gate, replay_logits
    t0 = time.perf_counter()
    cfg0 = get_arch("qwen2-0.5b")
    params, gain = capped_params(torch, cfg0, seed, sd)
    p32 = tree_map(lambda t: t.float(), params)
    prompts = [serving_workload(np.random.RandomState(seed), cfg0.vocab)[i]
               for i in CAP_PROMPTS]
    base = {**serve_kwargs(), "max_slots": len(prompts)}
    scfg = ServeConfig(**base)
    shadow = shadow_backend(torch)
    tokens, m, counts, eng = serve_run(
        torch, dataclasses.replace(cfg0, attn_logit_softcap=cap), params,
        prompts, f"{cfg0.name} std {sd} softcap {cap}", base=base)
    del eng

    def replays(cfg, backend, prm):
        return [replay_logits(cfg, scfg, prm, p, t, attn_backend=backend)
                for p, t in zip(prompts, tokens)]

    def dist(a, b):
        per = np.concatenate([np.abs(x - y).max(-1) for x, y in zip(a, b)])
        return float(per.max()), float(np.median(per))
    out = {"score_sd": sd, "wq_gain": gain, "cap": cap,
           "launches": {k: n for k, n in counts.items() if n}}
    hops = {}
    for c in (cap, 0.0):
        cfg = dataclasses.replace(cfg0, attn_logit_softcap=c)
        shadow.worst.clear()
        hops[c] = hop = replays(cfg, "shadow", params)
        ref = replays(cfg, "reference", params)
        f32 = replays(cfg, "reference", p32)
        (d_max, d_med), (h_max, h_med), (r_max, r_med) = (
            dist(hop, ref), dist(hop, f32), dist(ref, f32))
        worst = {k: dict(w) for k, w in shadow.worst.items()}
        rep = dual_gate(ref, hop, tokens, tol=LOGIT_TOL) if c else None
        print(f"[smoke] {cfg.name} at pre-cap score std {sd}, softcap {c}, "
              f"along the softcap-{cap} run's tokens: hopper vs reference "
              f"replay max |dlogit| {d_max:.5f} (the gate's {LOGIT_TOL}: "
              f"{'within' if d_max <= LOGIT_TOL else 'beyond'}; not gated)"
              f", median {d_med:.5f}"
              + (f", {rep['greedy_equal_tokens']}/{rep['n_tokens']} tokens "
                 f"equal the reference's greedy token, "
                 f"{rep['high_margin_mismatches']} high-margin mismatches"
                 if rep else "")
              + f"; from the fp32 replay: hopper max {h_max:.5f} median "
              f"{h_med:.5f}, reference max {r_max:.5f} median {r_med:.5f}; "
              f"every kernel call on the model's inputs, worst row ulps "
              f"(kernel vs plain, kernel vs fp32, plain vs fp32): "
              + ", ".join(f"{k} {w['kernel_vs_plain']:.3g} / "
                          f"{w['kernel_vs_fp32']:.3g} / "
                          f"{w['plain_vs_fp32']:.3g}"
                          for k, w in worst.items()), flush=True)
        if any(w["kernel_vs_fp32"] > w["plain_vs_fp32"] + 1.0
               for w in worst.values()):
            fail(f"{cfg.name} at softcap {c}: a kernel lies further from the "
                 "fp32 attend than its plain version plus one row ulp")
        if h_max > CAP_GAP_RATIO * r_max:
            fail(f"{cfg.name} at softcap {c}: hopper lies further from fp32 "
                 f"than {CAP_GAP_RATIO} x the reference does")
        out[f"softcap_{c:g}"] = {
            "hopper_vs_reference": [d_max, d_med],
            "hopper_vs_fp32": [h_max, h_med],
            "reference_vs_fp32": [r_max, r_med], "kernel_row_ulps": worst,
            **({k: rep[k] for k in ("greedy_equal_tokens", "n_tokens",
                                    "high_margin_mismatches")}
               if rep else {})}
    out["witness_max_logit_delta"] = dist(hops[cap], hops[0.0])[0]
    print(f"[smoke] softcap witness at pre-cap score std {sd}: "
          f"{cfg0.name} along the same tokens, hopper at softcap {cap} vs "
          f"none: max |dlogit| {out['witness_max_logit_delta']:.4f} (needs "
          f"> {CAP_WITNESS_MIN})", flush=True)
    if out["witness_max_logit_delta"] <= CAP_WITNESS_MIN:
        fail(f"softcap witness at std {sd}: softcap {cap} moves no logit by "
             f"more than {CAP_WITNESS_MIN}")
    del params, p32
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def cap_witness(torch, cfg0, params, prompts, base):
    """Serve ``prompts`` on hopper without a cap, then replay the run's
    tokens on hopper without a cap and at each cap of ``CAP_WITNESS`` in
    turn; the first cap whose replay parts from the uncapped one by more
    than ``CAP_WITNESS_MIN`` in some logit is the phase's.  Returns (cap,
    {cap: max |dlogit|})."""
    import dataclasses
    from repro_torch.configs import ServeConfig
    from repro_torch.serving import replay_logits
    tokens, m, c, eng = serve_run(torch, cfg0, params, prompts,
                                  f"{cfg0.name} uncapped", base=base)
    del eng
    scfg = ServeConfig(**base)

    def replays(cfg):
        return [replay_logits(cfg, scfg, params, p, t, attn_backend="hopper")
                for p, t in zip(prompts, tokens)]
    ref = replays(cfg0)
    deltas = {}
    for cap in CAP_WITNESS:
        got = replays(dataclasses.replace(cfg0, attn_logit_softcap=cap))
        deltas[cap] = max(float(np.abs(a - b).max())
                          for a, b in zip(got, ref))
        print(f"[smoke] softcap witness: {cfg0.name} along the uncapped "
              f"hopper run's {m['new_tokens']} tokens, softcap {cap} vs "
              f"none: max |dlogit| {deltas[cap]:.4f} (needs > "
              f"{CAP_WITNESS_MIN})", flush=True)
        if deltas[cap] > CAP_WITNESS_MIN:
            return cap, deltas
    fail(f"softcap witness: no cap of {CAP_WITNESS} moves a logit by more "
         f"than {CAP_WITNESS_MIN}")


def cap_train(torch, cfg, params, seed):
    """Capped training: one step's loss and gradients on hopper against
    reference (phase 18's bounds), then ``TF_STEPS`` AdamW steps through
    ``make_train_step(attn_backend="hopper")``, every loss finite.  K9 has
    no softcap (nor has the TPU kernel), so a capped layer takes the
    chunked core: K9 must launch no time.  Returns the report."""
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import build_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    batches = [family_batch(torch, cfg, TF_B, TF_S, seed + i, "cuda")
               for i in range(TF_STEPS)]
    flash_attention.launches = 0
    got, want = (value_and_grad(build_model(cfg, be).loss, params,
                                batches[0])
                 for be in ("hopper", "reference"))
    dloss, worst, leaf, med, _ = grad_gap(torch, got, want)
    ok = dloss <= TR_LOSS_TOL and worst <= TR_GRAD_TOL
    print(f"[smoke] train {cfg.name} at softcap {cfg.attn_logit_softcap}: "
          f"one step at B={TF_B} S={TF_S}, hopper vs reference: loss "
          f"{got[0].item():.6f} vs {want[0].item():.6f}, |dloss| "
          f"{dloss:.3g} (tol {TR_LOSS_TOL}); gradients rel L2 median "
          f"{med:.3g}, worst {worst:.3g} at {leaf} (tol {TR_GRAD_TOL}) -> "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("capped training: hopper and reference gradients part")
    del got, want
    ocfg = OptConfig(lr=TR_LR)
    state = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg, attn_backend="hopper")
    losses, times = [], []
    for batch in batches:
        t1 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t1)
    k9 = flash_attention.launches
    ok = all(math.isfinite(x) for x in losses) and k9 == 0
    p50 = sorted(times)[len(times) // 2]
    print(f"[smoke] train {cfg.name} at softcap {cfg.attn_logit_softcap} "
          f"({cfg.n_layers} layers), B={TF_B} S={TF_S}, AdamW lr {TR_LR}, "
          f"hopper: losses {[round(x, 4) for x in losses]}; step p50 "
          f"{p50 * 1e3:.1f} ms; K9 launches {k9} (0 expected: the capped "
          f"layers take the chunked core) -> {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("capped training: a loss is not finite, or K9 launched")
    del params, state, step
    torch.cuda.empty_cache()
    return {"dloss": dloss, "grad_rel_l2_worst": worst,
            "grad_rel_l2_worst_leaf": leaf, "grad_rel_l2_median": med,
            "losses": losses, "step_ms_p50": p50 * 1e3, "k9_launches": k9}


def phase_softcap(torch, timer, seed, base):
    """Phase 24 (see the module docstring): (a) ``softcap_kernels``, then
    the capped models, ``softcap_models``.  Returns (launch counts by
    kernel id, kernel numbers, report)."""
    import gc
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    kern = softcap_kernels(torch, timer, seed, base)
    t0 = time.perf_counter()
    counts, out = softcap_models(torch, seed)
    out.update(kernel_checks_s=t0 - t_phase,
               seconds=time.perf_counter() - t_phase)
    return counts, kern, out


def softcap_kernels(torch, timer, seed, base):
    """Phase 24 (a): every capped kernel mode against its plain version
    at ``CAP`` and in a saturating case, beside the uncapped call's time
    (``base``: {kernel id: the c = 0 numbers}).  Returns {kernel id:
    numbers}."""
    rng = np.random.RandomState(seed + 24)
    quick = Timer(torch, iters=1)
    runs = (("K1", phase_decode, {}),
            ("K1-int8", phase_decode, {"int8": True}),
            ("K2", phase_prefill, {}),
            ("K2-int8", phase_prefill, {"int8": True}),
            ("K2-D128", phase_prefill,
             {"K": 8, "G": 3, "D": 128, "label": "K2-D128"}),
            ("K3", phase_verify, {}), ("K4", phase_windowed_prefill, {}),
            ("K4-int8", phase_windowed_prefill, {"int8": True}),
            ("", phase_ring, {}), ("-int8", phase_ring, {"int8": True}))
    kern = {}
    for kid, fn, kw in runs:
        res = fn(torch, rng, timer, softcap=CAP, **kw)
        sat = fn(torch, rng, quick, softcap=CAP, q_gain=CAP_SAT_GAIN, **kw)
        if fn is phase_ring:           # {K1-ring, K3-ring}, int8 or not
            res, sat = ({k + kid: v for k, v in r.items()}
                        for r in (res, sat))
        else:
            res, sat = {kid: res}, {kid: sat}
        for k, r in res.items():
            s = sat[k]
            if s["max_abs_score"] < 3 * CAP:
                fail(f"{k}-softcap saturating case: max |s| "
                     f"{s['max_abs_score']:.1f} < 3 x {CAP}")
            r["saturating"] = {"q_gain": CAP_SAT_GAIN,
                               "max_abs_score": s["max_abs_score"],
                               "max_abs_err": s["max_abs_err"],
                               "err_over_ulp": s["err_over_ulp"]}
            r["uncapped_ms"] = base[k]["ms"]
            print(f"[smoke] {k}-softcap: kernel {r['ms']:.4f} ms at softcap "
                  f"{CAP} (max |s| {r['max_abs_score']:.1f}) vs "
                  f"{base[k]['ms']:.4f} ms uncapped (phases 2-9); "
                  f"saturating (q x {CAP_SAT_GAIN}, max |s| "
                  f"{s['max_abs_score']:.1f}): worst {s['err_over_ulp']:.3g}"
                  f" row ulps", flush=True)
            kern[k + "-softcap"] = r
    torch.cuda.empty_cache()
    return kern


def softcap_models(torch, seed):
    """Phase 24 (b)-(f): full-width, full-depth qwen2-0.5b capped (the
    witness picks the cap, then ``phase_serve``, ``phase_speculate`` and
    ``phase_int8_serve`` on the gained weights, then its training);
    minitron-4b at ``CAP_MT_LAYERS`` layers through ``phase_serve`` (K2 at
    head dim 128); starcoder2-7b through ``phase_window_serve`` (K4, K1
    and K3 in ring mode); then ``cap_gap`` at c = 50.  Returns (launch
    counts by kernel id, report)."""
    from repro_torch.configs import get_arch
    out = {}

    # (b) qwen2-0.5b: the witness, then bf16, n-gram and int8 serving
    t0 = time.perf_counter()
    cfg0 = get_arch("qwen2-0.5b")
    params, gain = capped_params(torch, cfg0, seed)
    prompts = [serving_workload(np.random.RandomState(seed), cfg0.vocab)[i]
               for i in CAP_PROMPTS]
    base_kw = {**serve_kwargs(), "max_slots": len(prompts)}
    cap, deltas = cap_witness(torch, cfg0, params, prompts, base_kw)
    cfg = dataclasses.replace(cfg0, attn_logit_softcap=cap)
    print(f"[smoke] softcap phase: cap {cap} (the largest of {CAP_WITNESS} "
          f"whose logits part from the uncapped model's by more than "
          f"{CAP_WITNESS_MIN}); wq drawn at gain {gain:.2f} (pre-cap score "
          f"std {CAP_SCORE_SD})", flush=True)
    c, rep, _, _, tokens, cache = phase_serve(
        torch, cfg, seed, profile=False, params=params, prompts=prompts)
    replay = Replays(cfg, params, prompts, cache)
    k3, spec = phase_speculate(
        torch, cfg, params, prompts, tokens,
        {"tokens_per_s": rep["tokens_per_s"],
         "decode_step_ms_p50": rep["decode_step_ms_p50"]}, replay)
    c8, int8 = phase_int8_serve(torch, cfg, params, prompts, replay,
                                spec=(0,))
    del replay, cache
    counts = {"K1-softcap": c["K1"], "K2-softcap": c["K2"],
              "K3-softcap": k3, "K1-int8-softcap": c8["K1-int8"],
              "K2-int8-softcap": c8["K2-int8"]}
    out.update(cap=cap, wq_gain=gain, score_sd=CAP_SCORE_SD,
               witness_max_logit_delta=deltas,
               qwen2={"bf16": {k: v for k, v in rep.items()
                               if k != "per_request"},
                      "speculative": spec, "int8": int8},
               qwen2_s=time.perf_counter() - t0)

    # (e) capped training on the same weights
    t0 = time.perf_counter()
    out["train"] = cap_train(torch, cfg, params, seed)
    out["train"]["seconds"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    # (c) minitron-4b: K2 at head dim 128
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(get_arch("minitron-4b"),
                               n_layers=CAP_MT_LAYERS,
                               attn_logit_softcap=cap)
    params, _ = capped_params(torch, mcfg, seed)
    mc, mrep, *_ = phase_serve(torch, mcfg, seed, profile=False,
                               params=params, prompts=prompts[1::2])
    counts["K2-D128-softcap"] = mc["K2"]
    out["minitron"] = {**{k: v for k, v in mrep.items()
                          if k != "per_request"},
                       "layers": CAP_MT_LAYERS,
                       "seconds": time.perf_counter() - t0}
    del params
    torch.cuda.empty_cache()

    # (d) starcoder2-7b: the ring kernels
    t0 = time.perf_counter()
    sc, sr = phase_window_serve(
        torch, seed, n_layers=STARCODER_LAYERS, why="as phase 10",
        profile=False, softcap=cap, score_sd=CAP_SCORE_SD)
    counts.update({f"{k}-softcap": n for k, n in sc.items()})
    out["starcoder2"] = {**sr, "layers": STARCODER_LAYERS,
                         "seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    # (f) c = 50 where random weights reach it, beside the uncapped model
    out["gap"] = cap_gap(torch, seed)
    print(f"[smoke] launches over phase 24 (softcap {cap}): "
          f"{', '.join(f'{k} {n}' for k, n in counts.items())}", flush=True)
    return counts, out


def phase_train(torch, seed):
    """The LM training path: full-width, full-depth qwen2-0.5b with random
    weights from ``seed``.  (a) ``train_run``: ``TR_STEPS`` AdamW steps on
    the hopper backend (K9 for each layer's attention), the loss, step
    time, tokens/s, peak memory and K9 launches a step, then 3 more steps
    under ``torch.profiler`` for the device's busy share and K9's share of
    it; (b) one step's loss and gradients from the same params and batch
    (B = ``TR_REF_B``) on hopper and on reference; (c) one ``--engine
    mapreduce`` step over NCCL at world size 1 against the pjit step, bit
    for bit; (d) a checkpoint and resume (depth cut to ``TR_CKPT_LAYERS``)
    whose loss history equals an uninterrupted run's.  Returns (K9
    launches in (a), report)."""
    import dataclasses
    import shutil
    import torch.distributed as dist
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.launch.train import local_group
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import build_model, init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import LoopConfig, TrainLoop
    launches, report, (cfg, ocfg, step, p0, s0, batches) = train_run(
        torch, seed)

    # (b) hopper vs reference: one step's loss and gradients
    batch = {"tokens": batches[0][:TR_REF_B]}
    (hl, _, hg), (rl, _, rg) = (
        value_and_grad(build_model(cfg, be).loss, p0, batch)
        for be in ("hopper", "reference"))
    rel = {p: ((a.float() - b.float()).norm()
               / b.float().norm().clamp_min(1e-30)).item()
           for (p, a), (_, b) in zip(tree_leaves(hg), tree_leaves(rg))}
    worst = max(rel, key=rel.get)
    dloss = abs(hl.item() - rl.item())
    ok = dloss <= TR_LOSS_TOL and rel[worst] <= TR_GRAD_TOL
    print(f"[smoke] train: one step at B={TR_REF_B}, hopper (K9, fp32 p) vs "
          f"reference (chunked, bf16 p): loss {hl.item():.6f} vs "
          f"{rl.item():.6f}, |dloss| {dloss:.3g} (tol {TR_LOSS_TOL}); "
          f"gradients rel L2 median {np.median(list(rel.values())):.3g}, "
          f"worst {rel[worst]:.3g} at {worst} (tol {TR_GRAD_TOL}) -> "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("train: hopper and reference gradients part")
    del hg, rg
    torch.cuda.empty_cache()

    # (c) the mapreduce engine over NCCL at world size 1 vs the pjit step
    batch = {"tokens": batches[0]}
    a = step(p0, s0, batch)
    groups = local_group(torch.device("cuda"))
    try:
        b = make_train_step(cfg, ocfg, engine="mapreduce", groups=groups,
                            attn_backend="hopper")(p0, s0, batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    mr_equal = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_leaves(list(a[:2]) + [a[2]["loss"]]),
        tree_leaves(list(b[:2]) + [b[2]["loss"]])))
    print(f"[smoke] train: a step through core.mapreduce (NCCL, world size 1)"
          f" vs the pjit step: params, optimizer state and loss "
          f"{'equal bit for bit -> OK' if mr_equal else 'DIFFER'}",
          flush=True)
    if not mr_equal:
        fail("train: the world-size-1 MapReduce step differs from the pjit "
             "step")
    del a, b, p0, s0
    torch.cuda.empty_cache()

    # (d) checkpoint, resume, and the loss history of an uninterrupted run
    small = dataclasses.replace(cfg, n_layers=TR_CKPT_LAYERS)
    sstep = make_train_step(small, ocfg, attn_backend="hopper")
    sp = init_params(small, seed, "cuda")
    sstate = (sp, init_opt_state(sp, ocfg))
    data = [{"tokens": b} for b in batches[:4]]

    def loop_step(st, b):
        p, o, m = sstep(*st, {"tokens": torch.as_tensor(b["tokens"],
                                                        device="cuda")})
        return (p, o), m
    ckpt_dir = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        full = TrainLoop(loop_step, sstate, iter(data), LoopConfig(
            log_every=0))
        full.run(4)
        lcfg = LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=100, log_every=0)
        one = TrainLoop(loop_step, sstate, iter(data), lcfg)
        one.run(2)
        two = TrainLoop(loop_step, sstate, iter(data), lcfg, device="cuda")
        resumed_at = two.step
        two.run(2)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    resume_equal = resumed_at == 2 \
        and one.history + two.history == full.history \
        and all(torch.equal(x, y) for (_, x), (_, y) in zip(
            tree_leaves(full.state), tree_leaves(two.state)))
    print(f"[smoke] train: checkpoint at step 2 and resume ({small.name} at "
          f"full width, {TR_CKPT_LAYERS} layers, B={TR_B} S={TR_S}, "
          f"{time.perf_counter() - t0:.1f} s): loss history "
          f"{[round(x, 6) for x in one.history + two.history]} vs "
          f"uninterrupted {[round(x, 6) for x in full.history]}, final state "
          f"{'equal bit for bit -> OK' if resume_equal else 'DIFFERS'}",
          flush=True)
    if not resume_equal:
        fail("train: the resumed run differs from the uninterrupted run")
    return launches, {
        **report,
        "vs_reference": {"batch": TR_REF_B, "dloss": dloss,
                         "grad_rel_l2_worst": rel[worst],
                         "grad_rel_l2_worst_leaf": worst,
                         "grad_rel_l2_median": float(np.median(list(
                             rel.values())))},
        "mapreduce_ws1_bit_equal": mr_equal,
        "resume_equal": resume_equal}


DRY_LIVE_RATIO = (0.5, 2.0)     # planned live bytes / the card's peak


def phase_dryrun(torch, serve, train):
    """Phase 25: the dry run's plan against what the card did, with no new
    step.  ``launch.dryrun.dryrun_cell`` traces qwen2-0.5b on ``meta`` at
    phase 18's training shape (B ``TR_B``, S ``TR_S``, AdamW) and a static
    decode step at phase 6's batch (``N_REQUESTS`` rows over its
    ``max_len``), both on the one-process mesh (data=1); each plan is
    printed beside phase 18's or phase 6's readings: the planned live
    bytes beside ``max_memory_allocated`` (phase 6: its hopper serve,
    prefill included, the paged pool in place of the static cache), two
    step lower bounds beside the step p50: ``roofline``, the traced
    reference path's under ``hlo_cost``'s byte rule (not the hopper path
    the card ran), and ``roofline_min``, the model FLOPs and the bytes the
    step must move at least (no share may pass 1.0: a bound above the
    measured time is a wrong count); and the model-FLOPs share of the bf16
    peak.  Fails unless each planned live
    size lies within ``DRY_LIVE_RATIO`` of the measured peak."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    cells = {
        "train": (ShapeConfig("smoke_train", "train", TR_S, TR_B),
                  train["step_ms_p50"] / 1e3,
                  train["peak_memory_gib"] * 2**30,
                  f"phase 18 (hopper, {TR_STEPS} AdamW steps)"),
        "decode": (ShapeConfig("smoke_decode", "decode",
                               serve_kwargs()["max_len"], N_REQUESTS),
                   serve["decode_step_ms_p50"] / 1e3,
                   serve["peak_memory_bytes"],
                   "phase 6 (hopper serve, paged decode)"),
    }
    out = {"card": CARD}
    for kind, (shape, p50, peak, where) in cells.items():
        t0 = time.perf_counter()
        rec = dryrun_cell("qwen2-0.5b", shape, mesh=mesh, verbose=False)
        roof = rec["roofline"]
        bound = roof["step_lower_bound_s"]
        flash = rec["roofline_flash"]["step_lower_bound_s"]
        least = rec["roofline_min"]
        live_ratio = rec["live_bytes_per_device"] / peak
        share = {"roofline_share": bound / p50,
                 "roofline_flash_share": flash / p50,
                 "roofline_min_share": least["step_lower_bound_s"] / p50,
                 "model_flops_share": rec["model_flops_global"]
                 / (p50 * BF16_FLOPS_PER_S)}
        ok = max(share["roofline_share"], share["roofline_min_share"]) \
            <= 1.0 and DRY_LIVE_RATIO[0] <= live_ratio <= DRY_LIVE_RATIO[1]
        print(f"[smoke] dry run vs the card, qwen2-0.5b {kind} (B "
              f"{shape.global_batch}, S {shape.seq_len}; {CARD}): planned "
              f"live {rec['live_bytes_per_device'] / 2**30:.3f} GiB vs "
              f"measured peak {peak / 2**30:.3f} GiB in {where} "
              f"(x{live_ratio:.3f}); the traced reference path's bound "
              f"under hlo_cost's byte rule {bound * 1e3:.4f} ms "
              f"({roof['dominant']}: compute {roof['compute_s'] * 1e3:.4f}, "
              f"memory {roof['memory_s'] * 1e3:.4f} ms) vs step p50 "
              f"{p50 * 1e3:.3f} ms = roofline share "
              f"{share['roofline_share']:.4f} (without the score traffic "
              f"the fused kernels keep on chip {flash * 1e3:.4f} ms = "
              f"{share['roofline_flash_share']:.4f}); least bound "
              f"{least['step_lower_bound_s'] * 1e3:.4f} ms ("
              f"{least['dominant']}: model FLOPs "
              f"{least['compute_s'] * 1e3:.4f} ms, "
              f"{rec['min_bytes_per_device'] / 1e9:.4f} GB moved at least "
              f"{least['memory_s'] * 1e3:.4f} ms) = share "
              f"{share['roofline_min_share']:.4f}; model FLOPs "
              f"{rec['model_flops_global']:.4e} (traced "
              f"{rec['traced_flops_per_device']:.4e}, {rec['n_ops']} ops) = "
              f"{share['model_flops_share']:.4f} of the bf16 peak; traced in "
              f"{time.perf_counter() - t0:.1f} s -> {'OK' if ok else 'FAIL'}",
              flush=True)
        out[kind] = {
            "batch": shape.global_batch, "seq_len": shape.seq_len,
            "planned_live_bytes": rec["live_bytes_per_device"],
            "measured_peak_bytes": peak, "live_ratio": live_ratio,
            "step_lower_bound_s": bound, "dominant": roof["dominant"],
            "flash_lower_bound_s": flash,
            "min_lower_bound_s": least["step_lower_bound_s"],
            "min_bytes": rec["min_bytes_per_device"],
            "step_p50_s": p50, "model_flops": rec["model_flops_global"],
            "traced_flops": rec["traced_flops_per_device"],
            "bytes": rec["bytes"], "eager_bytes": rec["eager_bytes"],
            "n_ops": rec["n_ops"], **share}
        if not ok:
            fail(f"dry run vs the card ({kind}): a roofline share above 1.0 "
                 f"or planned live bytes outside {DRY_LIVE_RATIO} of the "
                 "measured peak")
    return out


def profile_device(torch, fn, device_only=False):
    """Run ``fn`` under ``torch.profiler``; returns (wall us, kernel rows
    [(name, self device us, calls)] by time, device us over every event),
    or None when the profiler's own start fails (tracing refused) or it
    records no device time: both print "not measured".  ``device_only``
    traces the device alone, without the host ops, whose recording slows
    a host-bound engine several times over.  A failure of ``fn``
    propagates."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA] if device_only else
                   [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:
        print(f"[smoke] profile: not measured ({e})", flush=True)
        return None
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        prof.__exit__(None, None, None)
    # kernels are the events on the device; an aten op's self device time
    # repeats the time of the kernels it launched, so only the former count
    rows = [(a.key, getattr(a, "self_device_time_total", 0.0), a.count,
             getattr(a, "device_type", None)
             == torch.autograd.DeviceType.CUDA)
            for a in prof.key_averages()]
    kernels = sorted(((k, t, n) for k, t, n, on_device in rows if on_device),
                     key=lambda r: -r[1])
    if not sum(t for _, t, _ in kernels):
        print("[smoke] profile: no device time recorded (not measured)",
              flush=True)
        return None
    return wall_us, kernels, sum(r[1] for r in rows)


def print_profile(what, wall_us, kernels, every_us):
    busy = sum(t for _, t, _ in kernels)
    print(f"[smoke] profile of {what}, {wall_us / 1e3:.1f} ms wall: device "
          f"busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall (sum over "
          f"kernels; over every event, kernels and the ops that launched "
          f"them, {every_us / wall_us:.3f})", flush=True)
    for key, t, n in kernels[:10]:
        print(f"[smoke]   {t / 1e3:9.3f} ms {n:6d} calls  {key[:90]}",
              flush=True)
    return busy / wall_us


def profile_rerun(torch, eng, prompts, n_new=8, device_only=False):
    """Where the time goes: rerun the requests (prefixes now cached) for
    ``n_new`` tokens under ``torch.profiler`` and print the device's busy
    share of the wall time, its top kernels by self device time and, where
    K2 ran, K2's share of the device time (``device_only``: tracing the
    device alone, for an engine whose host ops are too many to record in
    the smoke's time).  Returns the busy share (None: not measured)."""
    reg = eng.metrics
    steps0 = (reg.value("engine.prefill_steps"),
              reg.get("engine.decode_step_s").count)
    res = profile_device(torch, lambda: eng.run_offline(prompts, n_new),
                         device_only=device_only)
    if res is None:
        return None
    prefill_steps = reg.value("engine.prefill_steps") - steps0[0]
    decode_steps = reg.get("engine.decode_step_s").count - steps0[1]
    busy = print_profile(f"a rerun of {len(prompts)} requests for {n_new} "
                         f"tokens ({decode_steps} decode steps, "
                         f"{prefill_steps} prefill steps)", *res)
    k2 = [(t, n) for key, t, n in res[1] if "ragged_prefill_kernel" in key]
    if k2:
        k2_us = sum(t for t, _ in k2)
        print(f"[smoke] K2 in that rerun: {k2_us / 1e3:.3f} ms over "
              f"{sum(n for _, n in k2)} calls = "
              f"{k2_us / sum(t for _, t, _ in res[1]):.3f} of device time",
              flush=True)
    return busy


def print_ptxas(stem, log_path) -> list:
    """One line per kernel instantiation of a library: registers, spill
    stores and static shared memory, as ``ptxas -v`` reported them when it
    was built.  Returns them as [{"kernel", "registers", "spill_bytes",
    "static_smem"}] (empty without a build log)."""
    import re
    rows = []
    if not log_path.exists():
        print(f"[smoke] ptxas {stem}: no build log (not measured)",
              flush=True)
        return rows
    name = None
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)I((?:L[ib]\d+E)+|f|13__nv_"
                          r"bfloat16)E", m.group(1))
            args = [("false", "true")[int(v)] if t == "b" else v
                    for t, v in re.findall(r"L([ib])(\d+)E", k.group(2))] \
                or [{"f": "float"}.get(k.group(2), "bf16")] if k else []
            name = f"{k.group(1)}<{', '.join(args)}>" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            print(f"[smoke] ptxas {stem}: {name}: {m.group(1)} registers, "
                  f"{spill} B spill stores, {m.group(2) or 0} B static "
                  f"shared memory", flush=True)
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "spill_bytes": int(spill),
                         "static_smem": int(m.group(2) or 0)})
            name = None
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an "
             "NVIDIA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run "
             "it from a checkout of the repository")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build_all

    # fp32 matmuls in the plain versions stay full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    global CARD
    CARD = smi
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    secs, libs = build_all()
    print(f"[smoke] built {len(libs)} kernel libraries "
          f"({', '.join(sorted(libs))}) with nvcc for sm_90a in "
          f"{secs:.1f} s", flush=True)
    for stem in sorted(libs):
        print_ptxas(stem, libs[stem].with_suffix(".log"))

    rng = np.random.RandomState(args.seed)
    timer = Timer(torch)
    t0 = time.perf_counter()
    k1 = phase_decode(torch, rng, timer)
    k2 = phase_prefill(torch, rng, timer)
    k3 = phase_verify(torch, rng, timer)
    k1q = phase_decode(torch, rng, timer, int8=True)
    k2q = phase_prefill(torch, rng, timer, int8=True)
    k3q = phase_verify(torch, rng, timer, int8=True)
    k2w, k2wq = (phase_prefill(torch, rng, timer, int8=q, K=8, G=3, D=128,
                               label="K2-D128") for q in (False, True))
    k4 = phase_windowed_prefill(torch, rng, timer)
    k4q = phase_windowed_prefill(torch, rng, timer, int8=True)
    ring = phase_ring(torch, rng, timer)
    ringq = phase_ring(torch, rng, timer, int8=True)
    cr, crq = (phase_ring(torch, rng, timer, int8=q, K=CR_K, G=CR_G,
                          cases=CR_RING_CASES, label="-60")["K3-ring"]
               for q in (False, True))
    ring_lengths = {f"{kid}{'-int8' if q else ''}": equal
                    for q in (False, True)
                    for kid, equal in phase_ring_lengths(torch, rng,
                                                         int8=q).items()}
    k8, k8_ptxas = phase_gemm_sigmoid(torch, timer, args.seed)
    k5, k5q = (phase_mla_decode(torch, rng, timer, int8=q)
               for q in (False, True))
    (k6, k6kv), (k6q, k6kvq) = (phase_mla_prefill(torch, rng, timer, int8=q)
                                for q in (False, True))
    k7, k7q = (phase_mla_verify(torch, rng, timer, int8=q)
               for q in (False, True))
    k9 = phase_flash(torch, timer)
    print(f"[smoke] kernel phases took {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = get_arch("qwen2-0.5b")
    t0 = time.perf_counter()
    counts, report, params, prompts, tokens, cache = phase_serve(
        torch, cfg, args.seed)
    print(f"[smoke] main path phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    replay = Replays(cfg, params, prompts, cache)
    t0 = time.perf_counter()
    frontend_counts, frontend = phase_frontend(torch, cfg, params, prompts,
                                               replay, args.seed)
    counts.update({f"{k} (phase 20)": c for k, c in frontend_counts.items()})
    print(f"[smoke] front-end phase took {time.perf_counter() - t0:.1f} s "
          f"({CARD})", flush=True)
    t0 = time.perf_counter()
    counts["K3"], spec = phase_speculate(
        torch, cfg, params, prompts, tokens,
        {"tokens_per_s": report["tokens_per_s"],
         "decode_step_ms_p50": report["decode_step_ms_p50"]}, replay)
    print(f"[smoke] speculative phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    int8_counts, int8 = phase_int8_serve(torch, cfg, params, prompts, replay)
    counts.update(int8_counts)
    print(f"[smoke] int8 phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    del params, replay, cache
    torch.cuda.empty_cache()

    # minitron-4b: the dense path at head dim 128 (K2-D128), bf16 and int8,
    # its depth cut for the smoke's time (see phase 12 above)
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(get_arch("minitron-4b"),
                               n_layers=MINITRON_LAYERS)
    mc, mreport, params, prompts, _, cache = phase_serve(
        torch, mcfg, args.seed)
    m8c, m8 = phase_int8_serve(torch, mcfg, params, prompts,
                               Replays(mcfg, params, prompts, cache),
                               spec=(0,))
    counts.update({"K2-D128": mc["K2"], "K2-D128-int8": m8c["K2-int8"],
                   "K1 (minitron-4b)": mc["K1"],
                   "K1-int8 (minitron-4b)": m8c["K1-int8"]})
    minitron = {**{k: mreport[k] for k in (
        "max_logit_err", "n_tokens", "greedy_equal_tokens",
        "high_margin_tokens", "high_margin_mismatches", "tokens_per_s",
        "ttft_p50_ms", "decode_step_ms_p50", "ref_tokens_per_s",
        "ref_decode_step_ms_p50")},
        "int8": m8["int8"]}
    del params, cache
    torch.cuda.empty_cache()
    print(f"[smoke] minitron-4b serving phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    window_counts, window = phase_window_serve(
        torch, args.seed, n_layers=STARCODER_LAYERS,
        why="to keep the smoke within the call's limit on a slow host")
    counts.update(window_counts)
    print(f"[smoke] sliding-window serving phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # command-r-plus-104b: K3 above 48 rows (G = 12), depth cut to 2 layers
    t0 = time.perf_counter()
    cr_counts, command_r = phase_window_serve(
        torch, args.seed, arch="command-r-plus-104b", n_layers=CR_LAYERS,
        why="full depth does not fit one card", profile=False,
        tol_row_ulps=LOGIT_ROW_ULPS)
    counts.update({"K3-ring-60": cr_counts.pop("K3-ring"),
                   "K3-ring-60-int8": cr_counts.pop("K3-ring-int8")})
    counts.update({f"{k} (command-r-plus-104b)": c
                   for k, c in cr_counts.items()})
    torch.cuda.empty_cache()
    print(f"[smoke] command-r-plus-104b serving phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    mla_counts, deepseek = phase_mla_serve(torch, args.seed)
    counts.update(mla_counts)
    torch.cuda.empty_cache()
    print(f"[smoke] deepseek-v2-236b serving phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    counts["K8"], paper = phase_paper(torch, args.seed)
    print(f"[smoke] paper's path phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k8_figures, figures = phase_figures(torch, args.seed)
    counts["K8"] += k8_figures
    print(f"[smoke] figures phase took {time.perf_counter() - t0:.1f} s "
          f"(K8 launches {k8_figures})", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts["K9"], train = phase_train(torch, args.seed)
    print(f"[smoke] training phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state_slots = phase_state_slots(torch, args.seed)
    print(f"[smoke] state-slot phase took {time.perf_counter() - t0:.1f} s "
          f"({CARD})", flush=True)
    t0 = time.perf_counter()
    ff_counts, ff_kernels, families = phase_frontend_families(
        torch, rng, timer, args.seed)
    counts.update(ff_counts)
    print(f"[smoke] frontend-families phase took "
          f"{time.perf_counter() - t0:.1f} s ({CARD})", flush=True)
    t0 = time.perf_counter()
    tf_counts, tf_kernels, train_families = phase_train_families(
        torch, timer, args.seed)
    counts["K9-full"] += tf_counts.pop("K9-full")
    counts.update(tf_counts)
    print(f"[smoke] train-families phase took "
          f"{time.perf_counter() - t0:.1f} s ({CARD})", flush=True)
    t0 = time.perf_counter()
    sc_counts, sc_kernels, softcap = phase_softcap(
        torch, timer, args.seed,
        {"K1": k1, "K1-int8": k1q, "K2": k2, "K2-int8": k2q, "K2-D128": k2w,
         "K3": k3, "K4": k4, "K4-int8": k4q, "K1-ring": ring["K1-ring"],
         "K3-ring": ring["K3-ring"], "K1-ring-int8": ringq["K1-ring"],
         "K3-ring-int8": ringq["K3-ring"]})
    counts.update(sc_counts)
    print(f"[smoke] softcap phase took {time.perf_counter() - t0:.1f} s "
          f"({CARD})", flush=True)
    t0 = time.perf_counter()
    dryrun = phase_dryrun(torch, report, train)
    print(f"[smoke] dry-run phase took {time.perf_counter() - t0:.1f} s "
          f"({CARD})", flush=True)
    for kid, c in counts.items():
        if c <= 0:
            fail(f"{kid} was never launched on its serving path")

    def entry(kid, name, source, replaces, numbers):
        return {"id": kid, "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": counts[kid], "check": "ok", **numbers}

    kernels = [
        entry("K1", "paged_decode", "paged_decode.cu",
              "paged_attention/kernel.py:139", k1),
        entry("K1-int8", "paged_decode", "paged_decode.cu",
              "paged_attention/kernel.py:139", k1q),
        entry("K2", "ragged_prefill", "ragged_prefill.cu",
              "ragged_prefill/kernel.py:141", k2),
        entry("K2-int8", "ragged_prefill", "ragged_prefill.cu",
              "ragged_prefill/kernel.py:141", k2q),
        entry("K3", "paged_verify", "paged_verify.cu",
              "paged_attention/kernel.py:241", k3),
        entry("K3-int8", "paged_verify", "paged_verify.cu",
              "paged_attention/kernel.py:241", k3q),
        entry("K2-D128", "ragged_prefill", "ragged_prefill.cu",
              "ragged_prefill/kernel.py:141", k2w),
        entry("K2-D128-int8", "ragged_prefill", "ragged_prefill.cu",
              "ragged_prefill/kernel.py:141", k2wq),
        entry("K1-ring", "paged_decode", "paged_decode.cu",
              "paged_attention/kernel.py:139", ring["K1-ring"]),
        entry("K1-ring-int8", "paged_decode", "paged_decode.cu",
              "paged_attention/kernel.py:139", ringq["K1-ring"]),
        entry("K3-ring", "paged_verify", "paged_verify.cu",
              "paged_attention/kernel.py:241", ring["K3-ring"]),
        entry("K3-ring-int8", "paged_verify", "paged_verify.cu",
              "paged_attention/kernel.py:241", ringq["K3-ring"]),
        entry("K3-ring-60", "paged_verify", "paged_verify.cu",
              "paged_attention/kernel.py:241", cr),
        entry("K3-ring-60-int8", "paged_verify", "paged_verify.cu",
              "paged_attention/kernel.py:241", crq),
        entry("K4", "windowed_prefill", "windowed_ragged_prefill.cu",
              "ragged_prefill/kernel.py:289", k4),
        entry("K4-int8", "windowed_prefill", "windowed_ragged_prefill.cu",
              "ragged_prefill/kernel.py:289", k4q),
        entry("K8", "gemm_sigmoid", "gemm_sigmoid.cu",
              "rbm_cd/kernel.py:40",
              {**k8[0], "shapes": k8, "ptxas": k8_ptxas}),
        entry("K5", "mla_paged_decode", "mla_paged_decode.cu",
              "paged_attention/kernel.py:338", k5),
        entry("K5-int8", "mla_paged_decode", "mla_paged_decode.cu",
              "paged_attention/kernel.py:338", k5q),
        entry("K6", "mla_ragged_prefill", "mla_ragged_prefill.cu",
              "ragged_prefill/kernel.py:438", k6),
        entry("K6-int8", "mla_ragged_prefill", "mla_ragged_prefill.cu",
              "ragged_prefill/kernel.py:438", k6q),
        entry("K6-kv", "mla_build_kv", "mla_build_kv.cu",
              "ragged_prefill/kernel.py:438", k6kv),
        entry("K6-kv-int8", "mla_build_kv", "mla_build_kv.cu",
              "ragged_prefill/kernel.py:438", k6kvq),
        entry("K7", "mla_paged_verify", "mla_paged_verify.cu",
              "paged_attention/kernel.py:432", k7),
        entry("K7-int8", "mla_paged_verify", "mla_paged_verify.cu",
              "paged_attention/kernel.py:432", k7q),
        entry("K9", "flash_attention", "flash_attention.cu",
              "flash_attention/kernel.py:79", k9),
        entry("K9-full", "flash_attention", "flash_attention.cu",
              "flash_attention/kernel.py:79",
              {**ff_kernels["K9-full"],
               "train_shape": tf_kernels["K9-full"]}),
        entry("K9-D128", "flash_attention", "flash_attention.cu",
              "flash_attention/kernel.py:79", tf_kernels["K9-D128"]),
        entry("K9-G1", "flash_attention", "flash_attention.cu",
              "flash_attention/kernel.py:79", tf_kernels["K9-G1"]),
        *(entry(kid, name, src, at, ff_kernels[kid])
          for kid, name, src, at in (
              ("K1-G1", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K1-G1-int8", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K2-G1", "ragged_prefill", "ragged_prefill.cu",
               "ragged_prefill/kernel.py:141"),
              ("K2-G1-int8", "ragged_prefill", "ragged_prefill.cu",
               "ragged_prefill/kernel.py:141"),
              ("K1-G7-D128", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K2-G7-D128", "ragged_prefill", "ragged_prefill.cu",
               "ragged_prefill/kernel.py:141"),
              ("K3-G7-D128", "paged_verify", "paged_verify.cu",
               "paged_attention/kernel.py:241"))),
        *(entry(kid, name, src, at, sc_kernels[kid])
          for kid, name, src, at in (
              ("K1-softcap", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K1-int8-softcap", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K1-ring-softcap", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K1-ring-int8-softcap", "paged_decode", "paged_decode.cu",
               "paged_attention/kernel.py:139"),
              ("K2-softcap", "ragged_prefill", "ragged_prefill.cu",
               "ragged_prefill/kernel.py:141"),
              ("K2-int8-softcap", "ragged_prefill", "ragged_prefill.cu",
               "ragged_prefill/kernel.py:141"),
              ("K2-D128-softcap", "ragged_prefill", "ragged_prefill.cu",
               "ragged_prefill/kernel.py:141"),
              ("K3-softcap", "paged_verify", "paged_verify.cu",
               "paged_attention/kernel.py:241"),
              ("K3-ring-softcap", "paged_verify", "paged_verify.cu",
               "paged_attention/kernel.py:241"),
              ("K3-ring-int8-softcap", "paged_verify", "paged_verify.cu",
               "paged_attention/kernel.py:241"),
              ("K4-softcap", "windowed_prefill", "windowed_ragged_prefill.cu",
               "ragged_prefill/kernel.py:289"),
              ("K4-int8-softcap", "windowed_prefill",
               "windowed_ragged_prefill.cu",
               "ragged_prefill/kernel.py:289"))),
    ]
    print(json.dumps({"kernels": kernels, "serve": {
        k: report[k] for k in ("max_logit_err", "n_tokens",
                               "greedy_equal_tokens", "high_margin_tokens",
                               "high_margin_mismatches",
                               "engine_tokens_equal", "engine_tokens",
                               "identical_requests", "tokens_per_s",
                               "ttft_p50_ms",
                               "decode_step_ms_p50", "ref_tokens_per_s",
                               "ref_decode_step_ms_p50")},
        "speculative": spec, "int8": int8, "minitron": minitron,
        "ring_length_bit_equal": ring_lengths, "sliding_window": window,
        "command_r": command_r, "deepseek": deepseek, "paper": paper,
        "figures": figures, "train": train, "frontend": frontend,
        "state_slots": state_slots, "frontend_families": families,
        "train_families": train_families, "softcap": softcap,
        "dryrun": dryrun}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
