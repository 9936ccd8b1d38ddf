#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It imports the port (``src/repro_torch``)
and nothing of JAX or of the JAX package, and fails (non-zero exit, no
result line) without a CUDA device or without the checkout. Phases, each
printing its own lines; any failed phase exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``); sm_90 check.
2. build — compiles every kernel of ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build seconds and the
   compiler's register / shared-memory report.
3. kernels — each kernel against its plain PyTorch version on the card
   (3b: the MoE kernels K5–K7 — K6's copy in both designs and its scaled
   gather bit-exact, its gather-dot within ``K6_DOT_RTOL``, K7 in both
   designs, bit-equal to each other — and K2–K4 at the MoE attention
   shape),
   at the serving and the training path's shapes and at the edges (prefix
   0, full, ragged, per-group prefixes and weights that differ, transposed
   operands, shapes that are not tile multiples, window and softcap), each
   held to a stated fp32 tolerance. K3 / K4 run in their plan's variant
   (printed) and in the simt variant, each twice and bit-equal to itself,
   and once on an offset view, which the plan sends to simt.
4. times, serving shapes — per kernel and shape: kernel ms, plain ms, the
   library call's ms (``torch.matmul``; ``F.scaled_dot_product_attention``
   with KV repeated — timed here only, never called by the port) and the
   bound ``max(bytes / 3.35 TB/s, operations / 67 TFLOP/s fp32)``; for K1
   and K2 also the 3×TF32 tensor-core bound ``max(bytes / 3.35 TB/s,
   3 · operations / 495 TFLOP/s)``, the achieved rates, and the device
   time per call of kernel and library from ``torch.profiler`` (these
   calls are short enough that back-to-back timing measures the host).
5. serving slice — granite-3-8b at its published width and depth (40
   layers, d_model 4096, fp32, torch-seeded weights) served by
   ``EdgeServer`` through the kernels: 4 elastic requests on 2 slots. Every
   request must finish with finite logits, both forward kernels must have
   launched in that run, every K1 launch through a tensor-core variant
   (``elastic_dense.launches_by_variant``), and the same requests through the dense masked
   path (no kernels) must give identical greedy tokens and logits within a
   stated tolerance. The serving model is then released.
6. times, training shapes — the same columns for K1's forward, dx and dw
   products, K2, and the backward kernels K3 (dq) and K4 (dk/dv), whose
   library call is ``torch.autograd.grad`` through SDPA (all three
   gradients). K3, K4 and SDPA are timed in turns: 7 rounds of the pair as
   the autograd backward runs it (delta, K3, K4), K3 and K4 mma, K3 and K4
   simt, SDPA pinned to the backend the default dispatch picks (named) and
   SDPA unpinned; medians and min–max, and a row for the pair.
7. training slice — two sync CFL rounds of 4 clients (the full spec and
   three elastic ones) of granite-3-8b at its published width, depth cut
   to 2 layers, through ``BatchedRoundEngine.run_fl_round`` on the kernels
   and then on the dense masked path, each path after one untimed warm-up
   round on its own copy of the starting parameters. Every kernel must
   launch as often as the design says (K1 only through its tensor-core
   variants, K3 / K4 only through ``mma``), the round-1 parameters of the
   two paths must agree within 1e-3 of how far the round moved them, and
   every client's accuracy must agree to one eval token, and each client's
   test CE under the two paths' round-1 models must agree within a stated
   tolerance. Prints round seconds, training tokens/s, peak device memory,
   one local step's device idle share and each path kernel's share of its
   device time (K3 / K4's device ms printed apart), and the kernel path's
   first round (its warm-up) against a warm round, both under
   ``torch.profiler``: host and device seconds and the entries that
   grew.
8. times, MoE shapes — the same columns for K5 (grouped expert-prefix
   matmul, with its plan variant: forward, dxs and dws at the MoE cohort's
   expert prefixes, and a decode step, also beside its 3×TF32 bound and,
   at decode, its device time), K6 (the dispatch gather) and K7 (the
   combine gather-reduce), each timed in turns with its first design (7
   rounds, medians and min–max; the decode rows with both designs' device
   time), K6's scaled gather and gather-dot (the combine's VJP), the whole
   ``_Combine.backward`` against the composition it replaced in turns,
   each wrapper's host µs per call (and the stream lookup's, before and
   after the wrappers took ``backend.stream_handle``), and K2–K4 at
   head_dim 64. (Phase 3b holds K5–K7 to their plain versions at these
   shapes and the edges — every K5 variant: tile, stream, simt; every K6
   and K7 variant, twice each and bit-equal run to run — and K2–K4 at the
   MoE path's attention shape.)
9. MoE training slice — phase 7 for granite-moe-1b-a400m at its published
   width (32 experts top-8), depth cut to 12 layers, 4 clients with
   expert prefixes 32 / 16 / 24 / 8: K5–K7 (with K6's gather-dot) and
   K2–K4 must launch as the design says, every K5 launch through its
   tensor-core ``tile``, every K6 / K7 launch through its redesign (K6's
   copy or scaled gather, K7's ``split``), every K3 / K4 launch through
   ``mma``; also
   counts the routing decisions (top-k expert sets) on which the two
   paths differ.
10. MoE serving slice — phase 5 for granite-moe-1b-a400m at all 24
   layers: K5–K7 and K2 must launch, every K5 launch through its
   weight-streaming ``stream`` variant, greedy tokens must equal the dense
   path's.
3c. (run after 3b) K8 / K9 — the SSD chunk scan and its transposed
   backward (K9 fed by K8's own states) — against their plain versions at
   the SSM slices' shapes (training rows with per-client head prefixes
   80 / 40 / 60 / 20, the prefill) and at the edges: prefix 0, ragged and
   full per row, two groups, one chunk and four, a chunk that is not a
   multiple of the 64-row tile, the per-chunk states, a chunk whose
   Σ|dt·A| passes 88 (where the reference's dense path overflows), the
   prefill with a ragged head prefix, and the shapes of K8's simt
   variant; each case prints K8's plan (variant, P tile) and K9's
   (variant, head slice), and runs K9 in each variant the shapes take
   (mma and simt, or simt alone), twice each, bit-equal.
11. times, SSM shapes — K8 (forward, forward with states), K9 and the
   prefill's K8: kernel ms, plain ms and the fp32 and 3×TF32 bounds (and
   the prefill's device time); K9's mma and simt variants and the whole
   ``ssd_scan_bwd`` in each timed in turns (7 rounds, medians, min–max),
   with the device time of each CUDA kernel of one mma call; no single
   PyTorch call computes an SSD scan, so there is no library time (the
   dense masked path's time is printed beside it as information, not as a
   yardstick).
12. SSM training slice — phase 7 for mamba2-2.7b at its published width
   (d_model 2560, 80 SSD heads of 64, d_state 128, chunk 256), depth cut
   to 8 layers, sequences of 512 tokens (two chunks), 4 clients with SSD
   heads 80 / 40 / 60 / 20 (the last dropping layer 0): K8 and K9 must
   launch as the design says, every K8 and K9 launch through its ``mma``
   variant (K9's device ms in the local step printed), every parameter of
   both paths must stay finite.
13. SSM serving slice — phase 5 for mamba2-2.7b at 32 of its 64 layers
   (``SSM_SERVE_LAYERS``), prompts of 512 tokens: K8
   must launch once a layer per prefill, each through its ``mma`` variant
   with P split, greedy tokens must equal the dense path's.
3d. (run after 3c) the paper CNN's convolutions: K1 against its plain
   version at the six im2col products of ``PAPER_CNN``'s stages (8
   clients, batch 32, per-client channel prefixes 8–32 / 16–64 / 32–128)
   and ``elastic_conv2d`` against ``elastic_conv2d_plain`` (a direct
   convolution under the same masks): forward, dx, dw and the per-client
   bias's gradient, prefixes 0 / ragged / full / None, strides 1 and 2,
   7×7 inputs; each case twice and bit-equal, each product's plan variant
   printed, and K1 with the per-group bias bit-equal to K1 without one
   plus the bias.
14. CNN training slice — the paper's three algorithms on
   ``CFLSession.from_synthetic(PAPER_CNN, kind="synthcifar", n_workers=8,
   n_samples=4000, algorithm=...)``, the paper's parent at full width and
   depth: CFL (random feasible specs, then the genetic search scored by
   the predictor; batched round, aggregate, predictor update) and FedAvg
   (every client the full spec) 2 timed sync rounds each on the kernels
   and on the dense masked path, each after an untimed warm-up round of
   its own session; IL (the same local budget, no aggregation) one
   free-running call at one round's budget and the sequential trainer
   (``batched_rounds=False``) on each client's first step, with its
   round-0 specs drawn untrained and held equal to the batched round's,
   both untimed, to leave the script's time budget to phase 21.
   Every free-running run (no ReLU record or count) has its launches
   counted from 0: K1 21 × (3 · steps + 1) a round of CFL and FedAvg and
   21 × 3 · steps + 21 the IL call,
   all ``tile`` / ``skinny``, ``F.conv2d`` only for the stem; none on the
   sequential trainer, whose plain forward calls ``F.conv2d`` once a
   conv. The free-running paths
   drift apart through ReLU decisions that rounding flips (counted, per
   forward), so the held comparisons run in separate untimed sessions
   with the same seeds: the dense path replays the kernel path's recorded
   ReLU decisions (``tests/relu_replay.py``) — CFL: round-0 specs
   identical, round-0 parameters within 1e-3 of the round's movement, test
   CE within ``TRAIN_LOSS_RTOL``, accuracies within one test sample, later
   specs identical while the earlier accuracies are; FedAvg: the same
   parameter, CE and accuracy checks; IL: accuracies within one test
   sample after one round's budget (after the whole budget, printed: the replayed
   paths drift, as CFL's later rounds do). The sequential trainer is held
   to the batched dense engine on each client's first local step in fp64
   (1e-3 of the movement, accuracies within one sample; fp32 printed).
   The timed kernel runs
   repeat the record runs' round-0 parameters to the bit (CFL, FedAvg).
   Prints round seconds, train images/s, the host seconds, predictor
   MAE, fairness, peak memory, Table II (CFL / FedAvg / IL: round s,
   images/s, accuracy mean / min / std / Jain, simulated round s), one
   local step's wall, device busy and idle share with K1's device share,
   and that step with cuDNN's deterministic algorithms off and on (twice
   each from one state: bit-equal or the first leaf that differs; wall
   and device ms).
14a. times, CNN shapes — per conv shape: K1, its plain version and
   ``torch.matmul`` on the im2col product (forward, dx, dw), the grouped
   ``F.conv2d`` (cuDNN, TF32 off) of the whole conv and the im2col, beside
   the fp32 and 3×TF32 bounds and the launches a round; and the whole
   conv as the kernel path runs it (``elastic_conv2d``: im2col + K1) and
   its plain version beside the conv's own fp32 bound.

15. zoo sessions — ``CFLSession.from_synthetic(TransformerElasticFamily(
   cfg, seq_len=...), kind="synthlm", n_workers=4, n_samples=32,
   heterogeneity="both")`` (8 train / 8 test sequences a client, batch 4,
   2 local steps) at each parent's published width, with phase 7's / 9's
   / 12's depth and sequence length: granite-3-8b CFL 3 timed rounds on
   the kernels (after an untimed warm-up session round), FedAvg 1 round,
   IL 1 round's budget; granite-moe-1b-a400m and mamba2-2.7b 1 CFL round;
   each parent 1 round on the sequential trainer (``batched_rounds=
   False``). Every timed run is free-running, its launches counted from 0:
   each kernel of the path as ``design_launches`` says, through the
   expected variants; none on the sequential trainer. Held: the dense
   path's round 0 from the same state (MoE: on the kernel path's routes,
   recorded in an untimed kernel run that repeats the timed one to the
   bit) — the same specs, parameters within 1e-3 of the round's movement
   beyond ``ULP_FLOOR`` fp32 ulps of their magnitude (``ulp_floored``),
   test CE within ``TRAIN_LOSS_RTOL``; the sequential round's parameters
   within ``SEQ_FP32_TOL`` of the dense round's, beyond the same floor
   (dense, SSM; printed for
   the MoE parent, whose masked path sizes expert capacity by all experts
   and the extracted submodel by its own); each client's first local step
   on the sequential trainer against a one-client batched dense engine in
   fp64 within ``SEQ_FP64_TOL`` and its fp32 local training within
   ``SEQ_FP32_TOL`` (a MoE client's engine sizing capacity by the client's
   experts and replaying the sequential run's routes). Prints round
   seconds and tokens/s per algorithm, the host seconds of the search,
   the predictor and the LUT, launches by variant, peak memory, the
   routing decisions that differ, the global accuracy (``evaluate``) and
   the card line.
16. partial participation, the selection policies and async buffered
   rounds with fault injection (``phase_selection``), on phase 14's
   population (one population and initial parameters for every session,
   as ``from_synthetic`` builds them) and one zoo parent; every timed run
   free-running after an untimed warm-up round, its launches counted from
   0. 16a: CFL sync under "uniform", "fairness" and "latency" (4 of 8
   clients), 2 timed rounds each: K1 21 × (3 · S + 1) a round through
   ``tile`` / ``skinny``, ``F.conv2d`` only for the stem; held on round 0
   (the dense path on the kernel path's recorded ReLU decisions; the
   record round is the warm-up): the same participants, weights and
   specs, parameters within 1e-3 of the movement beyond ``ULP_FLOOR``
   ulps, test CE within ``TRAIN_LOSS_RTOL``. 16b: async at the sync
   operating point (uniform, the buffer the cohort, no staleness
   discount), 2 aggregates: parameters and history columns bit-equal to
   16a's uniform run (``aggregate_lag`` within ``LAG_ULPS`` ulps of the
   clock). 16c: buffered async (``BUFFERED_RUN``: B = 2, discount 0.5,
   drop / straggle / corrupt 0.1, the quarantine gate), 4 aggregates on
   the kernels and on the dense path: identical event columns, finite
   parameters, the last buffered step within ``BUFFER_RTOL`` of its fp64
   recomputation from the same group deltas. 16d: FedAvg under
   "fairness", a sync round and an async aggregate at the sync point,
   bit-equal as 16b. 16e: a granite-3-8b CFL round at phase 15's
   settings under "uniform" (2 of 4): K1, K2–K4 as ``design_launches``,
   held as phase 15. Prints round (aggregate) seconds, images/s or
   tok/s, host seconds of selection / search / predictor and Table II's
   columns per run, and the phase's seconds by part.

3e. (run after 3d) the kernels at the shapes of the zoo's last three
   decoder parents (``phase_a11_kernels``): K2, K3 and K4 at head_dim 256
   (gemma2-9b's training attention, 16 / 8 heads, softcap 50, per-row head
   prefixes, without a window and with a window of 64 that binds;
   gemma-7b's MHA; a 32-token prefill) against their plain versions, K3 /
   K4 in both variants, twice each and bit-equal, and on an offset view;
   times beside SDPA (K3, K4 and SDPA's backward in turns) and the fp32 /
   3×TF32 bounds. K6 (copy, scaled gather, gather-dot) and K7 at
   deepseek-v2-lite-16b's top 6 of 64 experts, d 2048, and K8 / K9 at
   zamba2-1.2b's SSD (d_state 64), each held and timed.
3f. (run after 3e) K2, K3 and K4 at head_dim 80 (hubert-xlarge): its
   training attention (4 × 512 frames, 16 heads, non-causal) with all
   heads and head prefixes 16 / 8, rows that are not tile multiples
   (non-causal; causal GQA; window and softcap), K3 / K4 in both variants
   twice each and bit-equal, an offset view, each held to K2_TOL /
   K34_TOL; then timed at the training shape as phase 6 times them (3×TF32
   and fp32 bounds, plain, SDPA and its all-grads backward, non-causal).

17. the zoo's last three decoder parents end to end: ``EdgeServer`` as
   phase 5 on gemma2-9b (10 of its 21 pairs), zamba2-1.2b (its first two
   segments and its last, 14 of 38 layers) and deepseek-v2-lite-16b (its
   dense first layer and 8 of its 26 MoE layers), widths published, kernel
   path against dense path (greedy tokens
   equal, logits within ``SLICE_LOGIT_RTOL``), every kernel of the path
   launched; then phase 15's sessions (``phase_zoo``) at published width:
   gemma2 one (local, global) pair and deepseek its dense and one MoE
   layer, 2 clients each, zamba2 its first 6-layer segment with the
   shared block and its last segment, 4 clients, 512-token sequences —
   CFL 1 timed round, launches as ``design_launches_of`` says, round 0
   held against the dense path (deepseek on replayed routes), the
   sequential trainer's holds.

18. fleet checkpoints, the overlap ring and the hand-off to serving
   (``phase_fleet``): 18a, CFL sync on phase 14's population (full
   participation, 8 clients) for 2 rounds on the kernels — uninterrupted,
   killed after round 1 (``checkpoint_every=1``) and restored into a fresh
   session, and with the prefetch ring on (its copies from pinned buffers
   on a side stream): the resumed and ring-on runs bit-equal to the
   uninterrupted one (parameters and history), the ring's hits ≥ 1 and
   misses 0, K1 launched as often ring on as off, all ``tile``; the ring-off
   and ring-on rounds run in turns and print their walls. 18b: phase 16c's
   buffered async with faults killed after 2 aggregates with groups in
   flight, restored, run to 4: bit-equal. 18c: a granite-3-8b CFL round at
   phase 15's settings, then ``session.serving()`` on the kernels against
   the dense path (greedy tokens equal, logits within
   ``SLICE_LOGIT_RTOL``), ``export_submodel`` → ``load_submodel`` of the
   last client's spec bit-equal to ``extract``, ``distill_to_spec`` 5 steps with
   the kernel teacher against the dense one (KL within ``DISTILL_RTOL``,
   K1 / K2 a teacher forward a step) and the fused prefill against the
   stepwise decode within 1e-5 (absolute on the fp64 parent, relative to
   the largest value on the fp32 one).

19. the CNN's RL gates and the zoo's LM training (``phase_lm``): 19a,
   ``train_gates`` on ``PAPER_CNN`` at full width and depth as
   ``benchmarks/fig7_gates.py`` runs the reference's (50 soft steps at
   quality 3, 80 sampled steps on the mixed-quality set, batch 64, lr
   2e-3, penalty 0.15), a soft and a sampled step held card against CPU
   (the CPU replaying the card's ReLU decisions), the hard gates' compute
   share and gated / ungated accuracy at qualities 3 / 0 / 4 on 256
   images, ``gate_depth_policy``, the hard decisions identical card vs
   CPU. 19b: ``make_train_step`` on qwen3-4b and gemma-7b at published
   width, 2 layers, 3 steps of ``synthetic_lm_batches(cfg, 4, 256)``,
   adamw 3e-4 with weight decay 0.01, kernel path against dense path in
   fp32 (losses, step-1 gradients), remat on against off, microbatch 2
   against 1, a bf16 dense step, K1–K4 launches as
   ``lm_design_launches`` says. 19c: llava-next-mistral-7b (2 layers, one
   4096-position sequence of 2880 image embeddings and 1216 tokens) and
   hubert-xlarge (2 layers, 4 × 512 frames, head_dim 80): ``loss_fn``
   and its gradients kernel vs dense, one train step, llava's
   ``make_prefill_step`` logits kernel vs dense.

20. the tile-accounting gate (``phase_gate``,
   ``repro_torch.launch.elastic_kernels``): each tile-skipping op — K1's
   output- and contraction-prefix MLP projections, K5, K6 / K7's dispatch
   and combine, K8 (+ K9 backward), K2 (+ K3 / K4 backward), the CNN conv
   on K1 — swept over 25 / 50 / 75 / 100 % of its width at the
   reference's bench shapes and at the main widths, forward and backward:
   the counted build of every kernel (``csrc/tile_counters.cuh``) must
   give the host model's tiles and DMA blocks exactly
   (``launch/roofline.py``), also at prefix 0, ragged per-group prefixes,
   shapes that are not tile multiples and in every variant; ``max_err``
   against the plain version in fp64 ≤ 1e-5 (the main SSD row's on the
   reference bench's inputs as well, where dA cancels) and
   ``gate_elastic_rows`` (the reference's rules and defaults) must pass on
   both sets. Prints every row (tiles, DMA, arithmetic intensity,
   counters, error, fast and dense-masked ms, time share of the full
   width), the gate's verdict and its seconds.
21. cohort sharding (``phase_cohort``): ``run_fl_round`` with
   ``cohort_shards=2`` on 2 ranks started by ``spawn_cohort``, both on the
   one card over an explicit gloo group, for the paper's CNN (8 clients,
   full width and depth), granite-moe-1b-a400m and mamba2-2.7b (2 layers,
   4 clients, full width): each rank's block bit-equal to that block run
   alone in this process, the hierarchical aggregate within
   ``COHORT_RTOL`` of the movement from the flat one on the same blocks,
   the ranks bit-equal, one all-reduce a round, every kernel of the path
   launched on each rank; each rank's round wall, the all-reduce's bytes
   and ms and its launches printed. Then ``nccl_checks``: NCCL at world
   size 1 bit-equal to the unsharded engine, and on 2 and 4 cards where
   the machine has them (printed as not run otherwise).

The last lines are a ``kernels:`` line, the slices' stats, the card line,
one JSON object with every kernel's launches and times, and the result
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

K1_TOL = 1e-4                  # K up to 12800 fp32 products, outputs O(1)
K2_TOL = 2e-5                  # D-length dots and one softmax, outputs O(1)
K34_TOL = 1e-4                 # two D-length dots per pair, then sums over up
                               # to G·S pairs; outputs O(1-10)
K5_TOL = 1e-4                  # K ≤ 1024 fp32 products, outputs O(1), as K1
K7_RTOL = 1e-6                 # k ≤ 8 fp32 terms, relative to max|out|; K6
                               # copies (and scales) bit for bit
K6_DOT_RTOL = 1e-5             # the gather-dot, per entry relative to its
                               # Σ_d |z·x|: d ≤ 1024 fp32 terms, the kernel's
                               # order (32 per lane, a 5-step butterfly, ≤ 4
                               # slices) bounded by ~40 roundings, the plain
                               # einsum's by its own
K8_RTOL = 5e-5                 # y relative to max|y|: cum is bit-equal (fp64
                               # sum), the dot products run over N, P and Q
                               # ≤ 256 fp32 terms in another order
K9_RTOL = 1e-4                 # each output relative to its max: three
                               # chained products, then the du suffix sum of
                               # Q terms; dA = Σ_s du·dt relative to
                               # Σ_s |du·dt| (the sum cancels along s)
SLICE_LOGIT_RTOL = 1e-3        # 40 fp32 layers summed in another order
TRAIN_LOSS_RTOL = 1e-4         # eval CE after a round: 2 fp32 layers and 2
                               # SGD steps summed in another order
IL_PARAM_TOL = 1e-3            # IL's trained clients against the fp64 dense
                               # path on the kernel path's ReLU decisions,
                               # over their movement: 4.7e-4 after 33 steps
                               # on an H100 (the fp32 dense path: 3.5e-3)
SLICE = dict(arch="granite-3-8b", slots=2, n_requests=4, prompt_len=32,
             gen=8, seed=0)
# the training slice: granite-3-8b at its published width, depth cut to 2
# layers so that 4 clients' parameters, momenta and gradients fit the card;
# the CFLConfig defaults for lr and momentum, the engine's default clip
TRAIN = dict(n_layers=2, clients=4, batch=4, seq_len=128, train_seqs=8,
             test_seqs=4, lr=0.05, momentum=0.9, grad_clip=5.0, rounds=2,
             seed=0)
# the training cohort's specs from the elastic grid, one per client:
# (drops the first layer, ff_frac, attn_head_frac)
TRAIN_SPECS = ((False, 1.0, 1.0), (False, 0.5, 1.0), (False, 1.0, 0.5),
               (True, 0.75, 0.75))
# the MoE slices: granite-moe-1b-a400m at its published width; training
# with the depth cut to 12 layers (4 clients' parameters, momenta and
# gradients of all 24 would need ~91 GB), serving at all 24; the other
# settings as the dense slices'
MOE_SLICE = dict(SLICE, arch="granite-moe-1b-a400m")
MOE_TRAIN = dict(TRAIN, n_layers=12)
# (drops the first layer, expert_frac, attn_head_frac): routed experts
# 32 / 16 / 24 / 8 of 32
MOE_TRAIN_SPECS = ((False, 1.0, 1.0), (False, 0.5, 1.0), (False, 0.75, 0.5),
                   (True, 0.25, 1.0))
# the SSM slices: mamba2-2.7b at its published width; sequences of 512
# tokens, two of the published 256-token chunks; training with the depth
# cut to 8 layers (~450 M parameters a copy), serving at 32 of its 64
# layers (the script's time budget)
SSM_SLICE = dict(SLICE, arch="mamba2-2.7b", prompt_len=512)
SSM_SERVE_LAYERS = 32
SSM_TRAIN = dict(TRAIN, n_layers=8, seq_len=512)
# (drops the first layer, ssm_head_frac): SSD heads 80 / 40 / 60 / 20
SSM_TRAIN_SPECS = ((False, 1.0), (False, 0.5), (False, 0.75), (True, 0.25))


# the CUDA functions of each kernel wrapper (csrc/*.cu), by which a
# profile's device time is attributed to it
KERNEL_FUNCTIONS = {
    "elastic_dense": ("edense_",), "flash_attention": ("flash_fwd_",),
    "flash_attention_dq": ("flash_dq_",),
    "flash_attention_dkv": ("flash_dkv_",), "grouped_matmul": ("gmm_",),
    "gather_rows": ("gather_rows_",), "gather_dot": ("gather_dot_",),
    "gather_reduce": ("gather_reduce_",),
    "ssd_scan": ("ssd_fwd_", "ssd_cb_", "ssd_cum_"),
    "ssd_scan_bwd": ("ssd_bwd_",)}


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def ptxas_summary(log):
    """One line per kernel of an ``-Xptxas -v`` report: the kernel with its
    template arguments, registers, spill stores / loads and static shared
    memory."""
    import re
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+([a-z_]+_kernel)(I\w*?EE)?", m.group(1))
            args = re.findall(r"L[ib](\d+)E", name.group(2) or "") \
                if name else []
            kernel = (name.group(1) if name else m.group(1)) + \
                (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and kernel:
            out.append(f"{kernel}: {m.group(1)} registers, {spill}, "
                       f"{m.group(2) or 0} B static smem")
            kernel = None
    return out


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, device, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    from repro_torch.launch.mesh import FP32_OPS_PER_S, HBM_BYTES_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def add_tc_bound(row, nbytes: float, ops: float):
    """The 3×TF32 tensor-core bound of a K1 / K2 row beside its fp32 SIMT
    bound: max(bytes / 3.35 TB/s, 3 · operations / 495 TFLOP/s) — three
    TF32 products per fp32 product — and the achieved rates (operations
    and bytes the function needs over the kernel's time)."""
    from repro_torch.launch.mesh import HBM_BYTES_PER_S, TF32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3.0 * ops / TF32_OPS_PER_S * 1e3
    row["tc_bound_ms"] = max(t_bytes, t_ops)
    row["tc_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    row["tflops"] = ops / row["ms"] / 1e9
    row["tb_per_s"] = nbytes / row["ms"] / 1e9


def device_split_ms(fn, device, iters=20):
    """{CUDA kernel: device ms per call of ``fn``} from a ``torch.profiler``
    trace of ``iters`` calls (None off the card or without device time):
    where a wrapper's time goes among the kernels it launches."""
    import re
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return None
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync(device)
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) or 0
        if us and str(getattr(e, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+_kernel(?:<[^>]*>)?)", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out or None


def device_ms(fn, device, iters=20) -> float:
    """Device time per call of ``fn``: the sum of its kernels' time in a
    ``torch.profiler`` trace of ``iters`` calls (None where the profiler
    reports no device time). Unlike ``cuda_ms`` it leaves out the host's
    enqueue time, which bounds back-to-back calls of a short kernel."""
    split = device_split_ms(fn, device, iters)
    return sum(split.values()) if split else None


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _i32(vals, device):
    import torch
    return torch.tensor(vals, dtype=torch.int32, device=device)


def k1_cases(d_model, d_ff, slots, prompt_len):
    """(label, G, M, K, N, prefixes, act, bias) for elastic_dense: the
    serving shapes first, then the edges."""
    full = None
    return [
        ("decode up", slots, 1, d_model, d_ff, full, None, False),
        ("decode up ragged", slots, 1, d_model, d_ff,
         dict(n=[d_ff // 4 + 3] + [d_ff] * (slots - 1)), "silu", False),
        ("decode down", slots, 1, d_ff, d_model, full, None, False),
        ("decode down ragged", slots, 1, d_ff, d_model,
         dict(k=[d_ff // 2 + 5] + [d_ff // 4] * (slots - 1)), None, False),
        ("prefill up", 1, prompt_len, d_model, d_ff, full, "silu", False),
        ("prefill down ragged", 1, prompt_len, d_ff, d_model,
         dict(k=[3 * d_ff // 4]), None, False),
        ("prefix 0", 3, 1, 300, 200, dict(k=[0, 0, 0], n=[0, 5, 200]),
         "gelu", True),
        ("per-group prefixes", 5, 1, 257, 130,
         dict(k=[257, 0, 100, 31, 256], n=[130, 64, 1, 129, 33],
              m=[1, 1, 0, 1, 1]), "relu", True),
        ("tiles ragged", 3, 37, 1000, 777,
         dict(k=[1000, 13, 999], n=[777, 700, 65], m=[37, 20, 0]), "gelu",
         True),
        ("rows ragged", 2, 3, 129, 1000, dict(m=[3, 1]), "silu", True),
        ("rows no split", 2, 1, 64, 100, dict(n=[100, 37]), "gelu", True),
        ("tiles no split", 1, 20, 50, 70, dict(k=[33]), "silu", True),
        # 16-byte-aligned rows (the tensor-core variants): shapes that are
        # not multiples of their tiles, row counts on both sides of the
        # skinny / tile boundary (64), prefixes that end inside an mma
        # fragment (k 5, n 9), prefix 0, per-group prefixes that differ
        ("tile edge", 1, 129, 40, 136, dict(k=[5], n=[9]), "silu", True),
        ("skinny rows 33", 1, 33, 40, 136, dict(k=[37], n=[131]), None,
         True),
        ("skinny rows 63", 3, 21, 256, 136,
         dict(k=[5, 256, 0], n=[9, 136, 64], m=[21, 7, 21]), "gelu", True),
        ("skinny rows 64", 2, 32, 128, 200, dict(k=[128, 77], n=[200, 9]),
         "relu", False),
        ("tile rows 65", 5, 13, 96, 136,
         dict(k=[96, 0, 5, 40, 93], n=[136, 136, 9, 0, 100],
              m=[13, 13, 1, 13, 0]), "silu", True),
        ("skinny prefix 0", 2, 1, 64, 128, dict(k=[0, 0], n=[0, 128]),
         "gelu", True),
    ]


def k2_cases(n_heads, n_kv, head_dim, prompt_len):
    """(label, B, S, H, KV, D, h_active, causal, window, cap)."""
    return [
        ("prefill causal", 1, prompt_len, n_heads, n_kv, head_dim, None,
         True, None, None),
        ("prefill heads ragged", 1, prompt_len, n_heads, n_kv, head_dim,
         [n_heads // 2], True, None, None),
        ("heads 0 / per-batch", 3, 37, 8, 2, 64, [0, 8, 4], True, None,
         None),
        ("window + softcap", 2, 70, 4, 2, 128, [4, 2], True, 9, 50.0),
        ("non-causal ragged S", 1, 45, 4, 1, 32, None, False, None, None),
        ("window non-causal", 1, 33, 2, 2, 64, [2], False, 5, 20.0),
        # S past one 64-query tile; heads past the prefix inside a GQA
        # group (3 of a group of 4 live in row 1)
        ("S 65 window + softcap", 2, 65, 8, 2, 32, [8, 3], True, 17, 30.0),
        ("S 130 D 64", 1, 130, 4, 2, 64, [3], True, None, None),
        ("S 130 non-causal cap", 1, 130, 4, 1, 128, [4], False, None, 25.0),
        ("S 65 D 128 window", 1, 65, 4, 2, 128, [2], True, 40, None),
    ]


def k1_train_cases(d_model, d_ff, ff, tokens):
    """(label, G, M, K, N, prefixes, act, layout) for elastic_dense with
    one weight per group, at the training slice's shapes: the forward
    products, the backward's dx (wᵀ read in place: layout "dx") and dw (xᵀ
    read in place: layout "dw"), then the edges. ``ff``: the clients' d_ff
    prefixes, carried where the product carries them."""
    G, M = len(ff), tokens
    return [
        ("train up/gate", G, M, d_model, d_ff, dict(n=ff), "silu", "group"),
        ("train down", G, M, d_ff, d_model, dict(k=ff), None, "group"),
        ("train dx up", G, M, d_ff, d_model, dict(k=ff), None, "dx"),
        ("train dx down", G, M, d_model, d_ff, dict(n=ff), None, "dx"),
        ("train dw up", G, d_model, M, d_ff, dict(n=ff), None, "dw"),
        ("train dw down", G, d_ff, M, d_model, dict(m=ff), None, "dw"),
        ("group ragged", 3, 37, 100, 77,
         dict(k=[100, 13, 0], n=[77, 70, 5], m=[37, 20, 1]), "gelu",
         "group"),
        ("dx ragged", 3, 45, 130, 70, dict(k=[130, 64, 1], n=[3, 70, 69]),
         None, "dx"),
        ("dw ragged", 2, 70, 33, 90, dict(k=[33, 10], m=[70, 3]), None,
         "dw"),
        ("group rows", 4, 2, 40, 300, dict(n=[300, 0, 150, 77]), "relu",
         "group"),
        # aligned rows: the tensor-core variants in all three layouts, with
        # shapes that are not tile multiples, groups of 33 to 129 rows and
        # per-group prefixes that end inside an mma fragment
        ("group edge", 3, 129, 40, 136,
         dict(k=[5, 40, 0], n=[9, 136, 100], m=[129, 64, 1]), "silu",
         "group"),
        ("dx edge", 3, 129, 136, 40,
         dict(k=[9, 136, 0], n=[5, 40, 33], m=[129, 65, 0]), None, "dx"),
        ("dw edge", 3, 136, 40, 132,
         dict(k=[5, 40, 0], n=[9, 132, 100], m=[136, 65, 1]), None, "dw"),
        ("group rows 33", 2, 33, 64, 136, dict(k=[64, 5], n=[9, 136]),
         "relu", "group"),
        ("dw rows 64", 2, 64, 40, 136, dict(k=[40, 5], m=[64, 63]), None,
         "dw"),
        ("dx rows 65", 2, 65, 136, 40, dict(k=[136, 9], n=[40, 5]), None,
         "dx"),
        ("dx rows 33", 2, 33, 136, 40, dict(k=[5, 136], n=[40, 9],
                                           m=[33, 17]), None, "dx"),
    ]


def k34_cases(n_heads, n_kv, head_dim, heads, rows, seq):
    """(label, B, S, H, KV, D, h_active, causal, window, cap) for the
    training path's attention, forward and backward: the training slice's
    shapes (B = clients × rows; row b belongs to client b // rows), with
    the per-row head prefixes that the clients' ``heads`` give, then the
    edges of the forward's cases."""
    B = len(heads) * rows
    has = [heads[b // rows] for b in range(B)]
    return [
        ("train causal", B, seq, n_heads, n_kv, head_dim, None, True,
         None, None),
        ("train heads per row", B, seq, n_heads, n_kv, head_dim, has,
         True, None, None),
    ] + k2_cases(n_heads, n_kv, head_dim, seq)[2:]


def _k1_inputs(G, M, K, N, prefixes, bias, device, gen, layout=None):
    """x, w, bias, prefixes. ``layout``: None (w shared), "group" (w per
    group), "dx" (w per group, stored transposed), "dw" (w per group, x
    stored transposed); transposed operands are views of contiguous
    tensors."""
    import torch
    if layout == "dw":
        x = torch.randn((G, K, M), generator=gen,
                        device=device).transpose(-1, -2)
    else:
        x = torch.randn((G, M, K), generator=gen, device=device)
    if layout is None:
        w = torch.randn((K, N), generator=gen, device=device) / math.sqrt(K)
    elif layout == "dx":
        w = (torch.randn((G, N, K), generator=gen, device=device)
             / math.sqrt(K)).transpose(-1, -2)
    else:
        w = torch.randn((G, K, N), generator=gen, device=device) \
            / math.sqrt(K)
    b = torch.randn((N,), generator=gen, device=device) if bias else None
    pre = {f"{a}_active": (_i32(prefixes[a], device)
                           if prefixes and a in prefixes else None)
           for a in ("k", "n", "m")}
    return x, w, b, pre


def k1_variant(x, w):
    """The variant of the K1 launch plan for x and w (``plain`` on the
    CPU, where the wrapper runs the plain version)."""
    if x.device.type != "cuda":
        return "plain"
    from repro_torch.kernels.elastic_matmul import launch_plan
    return launch_plan(x, w)[1].variant


def _k2_inputs(B, S, H, KV, D, ha, device, gen):
    import torch
    q = torch.randn((B, S, H, D), generator=gen, device=device)
    k = torch.randn((B, S, KV, D), generator=gen, device=device)
    v = torch.randn((B, S, KV, D), generator=gen, device=device)
    return q, k, v, (_i32(ha, device) if ha is not None else None)


def flash_bwd_variant(q, k, v, do):
    """The variant of the K3 / K4 launch plan for these operands (``plain``
    on the CPU, where the wrappers run the plain versions)."""
    if q.device.type != "cuda":
        return "plain"
    from repro_torch.kernels.flash_attention import bwd_launch_plan
    return bwd_launch_plan(q, k, v, do).variant


def check_flash(device, cases, gen, worst, failed):
    """K2 forward, then K3 / K4 fed by K2's own o and lse (the plain
    backward takes the plain forward's), each against its plain version on
    ``cases`` (``k34_cases`` rows): K3 and K4 in the plan's variant and in
    the simt variant, each run twice and required to agree with itself bit
    for bit; then K3 / K4 on an offset view (rows not 16-byte aligned),
    which the plan sends to the simt variant. Records the worst errors in
    ``worst`` and failed labels in ``failed``."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_dkv, flash_attention_dkv_plain,
        flash_attention_dq, flash_attention_dq_plain,
        flash_attention_fwd_plain)

    def bwd(variant, *args, **kw):
        """K3 and K4 twice in ``variant``: (dq, dk, dv), bit-equal?"""
        runs = [(flash_attention_dq(*args, variant=variant, **kw),)
                + flash_attention_dkv(*args, variant=variant, **kw)
                for _ in range(2)]
        return runs[0], all(torch.equal(a, b) for a, b in zip(*runs))

    for label, B, S, H, KV, D, ha, causal, window, cap in cases:
        q, k, v, hat = _k2_inputs(B, S, H, KV, D, ha, device, gen)
        do = torch.randn(q.shape, generator=gen, device=device)
        kw = dict(causal=causal, window=window, cap=cap)
        o, lse = flash_attention(q, k, v, hat, **kw)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, hat, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do, o).contiguous()
        delta_p = torch.einsum("bshd,bshd->bhs", do, o_p).contiguous()
        want = (flash_attention_dq_plain(q, k, v, do, lse_p, delta_p, hat,
                                         **kw),) + \
            flash_attention_dkv_plain(q, k, v, do, lse_p, delta_p, hat, **kw)
        args = (q, k, v, do, lse, delta, hat)
        plan = flash_bwd_variant(q, k, v, do)
        got = {plan: bwd(None, *args, **kw)}
        if plan != "plain":
            got["simt"] = bwd("simt", *args, **kw)
        sync(device)
        err_fwd = max(float((o - o_p).abs().max()),
                      float((lse - lse_p).abs().max()))
        worst["flash_attention"] = max(worst["flash_attention"], err_fwd)
        ok = err_fwd <= K2_TOL and all(bool(torch.isfinite(t).all())
                                       for t in (o, lse))
        scale = max(float(t.abs().max()) for t in want)
        parts = []
        for variant, ((dq, dk, dv), same) in got.items():
            e_dq = float((dq - want[0]).abs().max())
            e_dkv = max(float((dk - want[1]).abs().max()),
                        float((dv - want[2]).abs().max()))
            worst["flash_attention_dq"] = max(worst["flash_attention_dq"],
                                              e_dq)
            worst["flash_attention_dkv"] = max(worst["flash_attention_dkv"],
                                               e_dkv)
            ok = ok and same and e_dq <= K34_TOL and e_dkv <= K34_TOL and \
                all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
            parts.append(f"{variant}: dq={e_dq:.3e} dk,dv={e_dkv:.3e}"
                         f"{' bit-equal' if same else ' NOT bit-equal'}")
        print(f"  flash fwd+bwd {label:22s} B={B} S={S} H={H} KV={KV} "
              f"D={D} h_active={'per row' if ha and len(ha) > 4 else ha} "
              f"causal={causal} window={window} cap={cap} "
              f"max|err| o,lse={err_fwd:.3e} (tol {K2_TOL:g}); "
              f"{'; '.join(parts)} (max|grad| {scale:.2f}, tol "
              f"{K34_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"flash fwd+bwd {label}")
    # an offset view: q starts 4 bytes past an aligned address
    D = cases[0][5]
    q, k, v, _ = _k2_inputs(2, 40, 8, 2, D, None, device, gen)
    qo = torch.empty(q.numel() + 1, device=device)[1:].view(q.shape)
    qo.copy_(q)
    do = torch.randn(q.shape, generator=gen, device=device)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do, o_p).contiguous()
    want = (flash_attention_dq_plain(q, k, v, do, lse_p, delta),) + \
        flash_attention_dkv_plain(q, k, v, do, lse_p, delta)
    plan = flash_bwd_variant(qo, k, v, do)
    (dq, dk, dv), same = bwd(None, qo, k, v, do, lse_p, delta)
    sync(device)
    errs = [float((a - b).abs().max()) for a, b in zip((dq, dk, dv), want)]
    worst["flash_attention_dq"] = max(worst["flash_attention_dq"], errs[0])
    worst["flash_attention_dkv"] = max(worst["flash_attention_dkv"],
                                       *errs[1:])
    ok = same and max(errs) <= K34_TOL and plan in ("simt", "plain")
    print(f"  flash bwd offset view q B=2 S=40 H=8 KV=2 D={D}: {plan} "
          f"dq={errs[0]:.3e} dk,dv={max(errs[1:]):.3e} "
          f"{'bit-equal' if same else 'NOT bit-equal'} (tol {K34_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("flash bwd offset view")


def phase_kernels(device, d_model, d_ff, n_heads, n_kv, head_dim, slots,
                  prompt_len, clients=2, rows=4, seq=40, ff=None,
                  heads=None):
    """Each kernel against its plain version, at the serving shapes, the
    training shapes (``clients`` clients of ``rows`` sequences of ``seq``
    tokens; ``ff`` / ``heads``: each client's d_ff and query-head prefix,
    full by default) and the edges; returns the worst error of each
    kernel. Raises PhaseError past a tolerance."""
    import torch
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd_plain)
    gen = torch.Generator(device=device).manual_seed(1)
    worst = {"elastic_dense": 0.0, "flash_attention": 0.0,
             "flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    failed = []
    for label, G, M, K, N, pre, act, bias in k1_cases(d_model, d_ff, slots,
                                                      prompt_len):
        x, w, b, p = _k1_inputs(G, M, K, N, pre, bias, device, gen)
        got = elastic_dense(x, w, b, act=act, **p)
        want = elastic_dense_plain(x, w, b, act=act, **p)
        sync(device)
        err = float((got - want).abs().max())
        worst["elastic_dense"] = max(worst["elastic_dense"], err)
        ok = err <= K1_TOL and bool(torch.isfinite(got).all())
        print(f"  elastic_dense {label:22s} G={G} M={M} K={K} N={N} "
              f"act={act} {k1_variant(x, w)} max|err|={err:.3e} "
              f"tol={K1_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"elastic_dense {label}")
    ff = list(ff) if ff is not None else [d_ff] * clients
    heads = list(heads) if heads is not None else [n_heads] * clients
    for label, G, M, K, N, pre, act, layout in k1_train_cases(
            d_model, d_ff, ff, rows * seq):
        x, w, _, p = _k1_inputs(G, M, K, N, pre, False, device, gen, layout)
        got = elastic_dense(x, w, act=act, **p)
        want = elastic_dense_plain(x, w, act=act, **p)
        sync(device)
        err = float((got - want).abs().max())
        worst["elastic_dense"] = max(worst["elastic_dense"], err)
        ok = err <= K1_TOL and bool(torch.isfinite(got).all())
        print(f"  elastic_dense {label:22s} G={G} M={M} K={K} N={N} "
              f"act={act} layout={layout} {k1_variant(x, w)} "
              f"max|err|={err:.3e} tol={K1_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"elastic_dense {label}")
    # the training path's attention as it runs there
    check_flash(device, k34_cases(n_heads, n_kv, head_dim, heads, rows,
                                  seq), gen, worst, failed)
    for label, B, S, H, KV, D, ha, causal, window, cap in k2_cases(
            n_heads, n_kv, head_dim, prompt_len):
        q, k, v, hat = _k2_inputs(B, S, H, KV, D, ha, device, gen)
        o, lse = flash_attention(q, k, v, hat, causal=causal, window=window,
                                 cap=cap)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, hat, causal=causal,
                                               window=window, cap=cap)
        sync(device)
        err = max(float((o - o_p).abs().max()),
                  float((lse - lse_p).abs().max()))
        worst["flash_attention"] = max(worst["flash_attention"], err)
        ok = err <= K2_TOL and bool(torch.isfinite(o).all())
        print(f"  flash_attention {label:20s} B={B} S={S} H={H} KV={KV} "
              f"D={D} h_active={ha} causal={causal} window={window} "
              f"cap={cap} max|err|={err:.3e} tol={K2_TOL:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"flash_attention {label}")
    if failed:
        raise PhaseError(f"kernels disagree with their plain versions: "
                         f"{failed}")
    return worst


# ---------------------------------------------------------------------------
# phase 3b: the MoE kernels against their plain versions
# ---------------------------------------------------------------------------
def k5_cases(d_model, d_ff, n_experts, clients, cap, slots, experts):
    """(label, G, E, M, K, N, layout, g_active) for grouped_matmul: the
    training path's products (forward on one layer of a client-stacked
    weight, the VJP's dxs with wsᵀ and dws with xsᵀ read in place) at the
    cohort's expert prefixes, the decode and prefill shapes (shared
    weights, one prefix per slot), then the edges."""
    E, ga = n_experts, list(experts)
    dec = [E, max(1, E // 4)] + [E // 2] * (slots - 2)
    return [
        ("train up/gate", clients, E, cap, d_model, d_ff, "layer", ga),
        ("train down", clients, E, cap, d_ff, d_model, "layer", ga),
        ("train dxs up", clients, E, cap, d_ff, d_model, "dx", ga),
        ("train dxs down", clients, E, cap, d_model, d_ff, "dx", ga),
        ("train dws up", clients, E, d_model, cap, d_ff, "dw", ga),
        ("train dws down", clients, E, d_ff, cap, d_model, "dw", ga),
        ("decode up", slots, E, 8, d_model, d_ff, "shared", dec[:slots]),
        ("decode down", slots, E, 8, d_ff, d_model, "shared",
         dec[:slots][::-1]),
        ("prefill up", 1, E, 16, d_model, d_ff, "shared", [E * 3 // 4]),
        ("prefix 0", 3, 5, 13, 37, 70, "group", [0, 0, 0]),
        ("tiles ragged", 3, 5, 70, 37, 130, "group", [0, 3, 5]),
        ("shared rows ragged", 5, 4, 3, 100, 65, "shared", [4, 0, 2, 1, 3]),
        ("shared dxs", 2, 3, 9, 33, 70, "shared dx", [3, 1]),
        ("dxs ragged", 2, 3, 65, 40, 17, "dx", [1, 3]),
        ("dws ragged", 3, 2, 50, 77, 66, "dw", [2, 0, 1]),
        ("no prefix", 2, 3, 10, 20, 30, "group", None),
        # 16-byte-aligned rows (the tensor-core variants): 160 capacity rows
        # in every training layout with columns and contractions that are
        # not tile multiples, prefix 0 and ragged prefixes, rows on both
        # sides of the stream / tile boundary (64), a split contraction, and
        # the 128-row tile with a ragged last row tile
        ("rows 160 layer", 3, 3, 160, 36, 132, "layer", [3, 0, 2]),
        ("rows 160 dxs", 2, 3, 160, 132, 36, "dx", [1, 3]),
        ("rows 160 dws", 2, 3, 68, 160, 132, "dw", [3, 2]),
        ("tile prefix 0", 2, 2, 81, 40, 136, "group", [0, 0]),
        ("stream rows 33", 3, 5, 11, 40, 136, "shared", [5, 0, 2]),
        ("stream rows 64", 2, 4, 32, 64, 200, "shared", [1, 4]),
        ("tile rows 65", 5, 3, 13, 96, 136, "shared", [3, 0, 1, 2, 3]),
        ("stream split", 2, 4, 4, 1024, 136, "shared", [4, 1]),
        ("stream grouped", 3, 4, 24, 136, 40, "group", [4, 2, 0]),
        ("tile 128 dws", 2, 3, 252, 160, 132, "dw", [3, 1]),
        ("tile 128 dxs", 2, 2, 250, 136, 40, "dx", [2, 0]),
    ]


def _k5_inputs(G, E, M, K, N, layout, device, gen):
    """xs, ws in ``layout``: "shared" (E, K, N); "group" (G, E, K, N);
    "layer" one layer of a (G, 2, E, K, N) stack (a strided view); "dx" /
    "shared dx" ws a transposed view; "dw" xs a transposed view."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = rn(G, E, K, M).transpose(-1, -2) if layout == "dw" else \
        rn(G, E, M, K)
    scale = 1.0 / math.sqrt(K)
    if layout == "shared":
        w = rn(E, K, N) * scale
    elif layout == "shared dx":
        w = (rn(E, N, K) * scale).transpose(-1, -2)
    elif layout == "layer":
        w = (rn(G, 2, E, K, N) * scale)[:, 1]
    elif layout == "dx":
        w = (rn(G, E, N, K) * scale).transpose(-1, -2)
    else:
        w = rn(G, E, K, N) * scale
    return x, w


def k5_variant(x, w):
    """The variant (and row tile, and split) of K5's launch plan for x and
    w (``plain`` on the CPU, where the wrapper runs the plain version)."""
    if x.device.type != "cuda":
        return "plain"
    from repro_torch.kernels.grouped_matmul import launch_plan
    plan = launch_plan(x, w)[1]
    return f"{plan.variant} bm={plan.bm} splits={plan.splits}"


def moe_tables(device, G, T, E, k, cap, experts, d, gen):
    """Rows, gates and the gather kernels' 1-D tables of one MoE layer as
    the main path builds them (``models.moe``: top-k of random router
    logits under the groups' expert prefixes, the sort-based capacity
    rule, the group axis flattened into the rows)."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    xt = torch.randn((G, T, d), generator=gen, device=device)
    router = torch.randn((d, E), generator=gen, device=device) / \
        math.sqrt(d)
    mask = (torch.arange(E, device=device)[None, :]
            < _i32(experts, device)[:, None]).float()
    _, _, gates, idx = moe.route(router, xt, MoEConfig(E, k, 1), mask)
    tables = moe.slot_tables(idx, gates, E=E, cap=cap, expert_mask=mask)
    src, valid, dest, kept = moe.flat_tables(tables, T)
    gate_eff = (gates * kept.reshape(G, T, k).to(gates.dtype)).reshape(
        G * T, k).contiguous()
    return dict(xt=xt.reshape(G * T, d), src=src, valid=valid, dest=dest,
                kept=kept, gate_eff=gate_eff,
                slot_gate=tables.slot_gate.reshape(-1).contiguous(),
                y=torch.randn((G * E * cap, d), generator=gen, device=device))


def k67_cases(d_model, n_experts, top_k, clients, tokens, cap, slots,
              experts):
    """(label, G, T, E, k, cap, experts, d) of the MoE gathers: the
    training layer, a decode step (one token per slot, cap 8), and edges
    (a row that is not a multiple of 4 floats, k = 1, tiny capacity)."""
    E = n_experts
    return [
        ("train", clients, tokens, E, top_k, cap, list(experts), d_model),
        ("decode", slots, 1, E, top_k, 8, [E, max(top_k, E // 4)][:slots]
         + [E] * (slots - 2), d_model),
        ("d odd, drops", 3, 37, 5, 2, 8, [5, 2, 3], 33),
        ("k 1", 2, 20, 3, 1, 8, [3, 1], 12),
    ]


def _twice(fn):
    """Two runs of ``fn`` and whether they are bit-equal."""
    import torch
    a, b = fn(), fn()
    return a, bool(torch.equal(a, b))


def check_gathers(device, t, k, label, d, worst):
    """K6 and K7 on one MoE layer's tables ``t`` (``moe_tables``; an
    optional ``misaligned`` (T, d) view of token rows) against their plain
    versions: K6's copy in both designs (the dispatch, the rows the
    combine's gate cotangent reads, and the misaligned view), its scaled
    gather (the combine's slot cotangent: the token rows ``xt`` standing
    for the output cotangent, times ``slot_gate``) bit-exact with dead
    slots exactly 0; its gather-dot within ``K6_DOT_RTOL`` of each entry's
    Σ_d |z·x|, dropped assignments exactly 0; K7 in both designs (the
    combine, and the dispatch's VJP) within ``K7_RTOL`` of max|out|, the
    designs bit-equal to each other. Each launch runs twice and must be
    bit-equal run to run. Updates ``worst``; returns the failed checks."""
    import torch
    from repro_torch.kernels.moe_dispatch import (
        GATHER_VARIANTS, REDUCE_VARIANTS, gather_dot, gather_dot_plain,
        gather_reduce, gather_reduce_plain, gather_rows, gather_rows_plain)
    failed = []
    T_all = t["gate_eff"].shape[0]
    live = (t["gate_eff"].reshape(-1) != 0).to(torch.int32)

    def report(name, ok, text):
        print(f"  {name} {label:12s} {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {label} {text.split(':')[0]}")
    copies = [("dispatch", t["xt"], t["src"], t["valid"], None),
              ("combine vjp rows", t["y"], t["dest"], live, None),
              ("combine vjp dy", t["xt"], t["src"], t["valid"],
               t["slot_gate"])]
    if "misaligned" in t:
        copies.append(("misaligned", t["misaligned"], t["src"], t["valid"],
                       None))
    for name, x, idx, valid, scale in copies:
        want = gather_rows_plain(x, idx, valid, scale)
        for variant in GATHER_VARIANTS if scale is None else (None,):
            got, same = _twice(lambda: gather_rows(x, idx, valid, scale,
                                                   variant=variant))
            sync(device)
            err = float((got - want).abs().max()) if got.numel() else 0.0
            exact = bool(torch.equal(got, want))
            dead = not bool(got[valid == 0].any())
            worst["gather_rows"] = max(worst.get("gather_rows", 0.0), err)
            report("gather_rows", exact and same and dead,
                   f"{name:17s} {variant or 'unrolled'}"
                   f"{' scaled' if scale is not None else ''}: "
                   f"R={idx.shape[0]} from {x.shape[0]} rows, d={d}: "
                   f"bit-exact {'yes' if exact else 'NO'}, twice equal "
                   f"{'yes' if same else 'NO'}, dead rows 0 "
                   f"{'yes' if dead else 'NO'}")
    z = t["xt"]
    got, same = _twice(lambda: gather_dot(t["y"], t["dest"], live, z, k))
    want = gather_dot_plain(t["y"], t["dest"], live, z, k)
    rows = gather_rows_plain(t["y"], t["dest"], live).reshape(T_all, k, -1)
    mag = torch.einsum("td,tjd->tj", z.abs().double(), rows.abs().double())
    rel = float(((got.double() - want.double()).abs()
                 / mag.clamp_min(1e-30)).max()) if got.numel() else 0.0
    dead = not bool(got.reshape(-1)[live == 0].any())
    worst["gather_dot"] = max(worst.get("gather_dot", 0.0), rel)
    report("gather_dot", rel <= K6_DOT_RTOL and same and dead
           and bool(torch.isfinite(got).all()),
           f"combine vjp dgate T={T_all} k={k}, d={d}: max|err|/Σ|z·x| "
           f"{rel:.3e} tol={K6_DOT_RTOL:g}, twice equal "
           f"{'yes' if same else 'NO'}, dropped 0 {'yes' if dead else 'NO'}")
    dest = t["dest"].reshape(T_all, k)
    for name, gates in (("combine", t["gate_eff"]),
                        ("dispatch vjp", t["kept"].reshape(T_all, k).float())):
        want = gather_reduce_plain(t["y"], dest, gates)
        outs = {}
        for variant in REDUCE_VARIANTS:
            outs[variant], same = _twice(lambda: gather_reduce(
                t["y"], dest, gates, variant=variant))
            sync(device)
            got = outs[variant]
            rel = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            worst["gather_reduce"] = max(worst.get("gather_reduce", 0.0), rel)
            report("gather_reduce", rel <= K7_RTOL and same
                   and bool(torch.isfinite(got).all()),
                   f"{name:13s} {variant}: T={T_all} k={k} from "
                   f"{t['y'].shape[0]} rows, d={d}: max|err|/max|out| "
                   f"{rel:.3e} tol={K7_RTOL:g}, twice equal "
                   f"{'yes' if same else 'NO'}")
        equal = bool(torch.equal(*outs.values()))
        report("gather_reduce", equal, f"{name:13s} designs: bit-equal "
               f"{'yes' if equal else 'NO'}")
    return failed


def phase_moe_kernels(device, d_model, d_ff, n_experts, top_k, clients,
                      tokens, slots, experts, n_heads=None, n_kv=None,
                      head_dim=None, rows=4, seq=None, heads=None):
    """K5 / K6 / K7 against their plain versions at the MoE training path's
    shapes (``clients`` clients of ``tokens`` tokens, expert prefixes
    ``experts``), at a decode step's and at the edges; with ``n_heads``,
    also K2–K4 at the MoE path's attention shape and per-row head prefixes
    (``heads`` per client, ``rows`` sequences of ``seq`` per client).
    Returns the worst error of each kernel (K7's relative to its output's
    largest value). Raises PhaseError past a tolerance."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_plain)
    from repro_torch.models.moe import capacity
    gen = torch.Generator(device=device).manual_seed(4)
    cap = capacity(tokens, MoEConfig(n_experts, top_k, d_ff))
    worst = {"grouped_matmul": 0.0, "gather_rows": 0.0, "gather_dot": 0.0,
             "gather_reduce": 0.0}
    failed = []
    for label, G, E, M, K, N, layout, ga in k5_cases(
            d_model, d_ff, n_experts, clients, cap, slots, experts):
        x, w = _k5_inputs(G, E, M, K, N, layout, device, gen)
        gat = None if ga is None else _i32(ga, device)
        variant = k5_variant(x, w)
        got = grouped_matmul(x, w, gat)
        want = grouped_matmul_plain(x, w, gat)
        sync(device)
        err = float((got - want).abs().max())
        worst["grouped_matmul"] = max(worst["grouped_matmul"], err)
        dead_zero = ga is None or all(not bool(got[g, n:].any())
                                      for g, n in enumerate(ga))
        ok = err <= K5_TOL and dead_zero and bool(torch.isfinite(got).all())
        shown = ga if ga is None or len(ga) < 6 else "per group"
        print(f"  grouped_matmul {label:18s} G={G} E={E} M={M} K={K} N={N} "
              f"layout={layout} g_active={shown} {variant} "
              f"max|err|={err:.3e} tol={K5_TOL:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"grouped_matmul {label}")
        del x, w, got, want
    for label, G, T, E, k, cp, ga, d in k67_cases(
            d_model, n_experts, top_k, clients, tokens, cap, slots,
            experts):
        t = moe_tables(device, G, T, E, k, cp, ga, d, gen)
        if label.startswith("d odd"):          # a 16-byte-misaligned row
            base = torch.randn(G * T * d + 1, generator=gen, device=device)
            t["misaligned"] = base[1:].view(G * T, d)
        failed += check_gathers(device, t, k, label, d, worst)
        del t
    if n_heads is not None:
        for name in ("flash_attention", "flash_attention_dq",
                     "flash_attention_dkv"):
            worst[name] = 0.0
        check_flash(device, k34_cases(n_heads, n_kv, head_dim, heads, rows,
                                      seq)[:2], gen, worst, failed)
    if failed:
        raise PhaseError(f"MoE kernels disagree with their plain versions: "
                         f"{failed}")
    return worst


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def phase_times(device, d_model, d_ff, n_heads, n_kv, head_dim, slots,
                prompt_len, iters=20):
    """Kernel / plain / library ms and the bound at the serving shapes.
    Returns {kernel: [row, ...]} (the first row is the kernel's headline
    shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd_plain)
    gen = torch.Generator(device=device).manual_seed(2)
    rows = {"elastic_dense": [], "flash_attention": []}
    for label, G, M, K, N, act in (
            ("decode up/gate", slots, 1, d_model, d_ff, "silu"),
            ("decode down", slots, 1, d_ff, d_model, None),
            ("prefill up/gate", 1, prompt_len, d_model, d_ff, "silu"),
            ("prefill down", 1, prompt_len, d_ff, d_model, None)):
        x, w, _, _ = _k1_inputs(G, M, K, N, None, False, device, gen)
        x2 = x.reshape(G * M, K)
        row = dict(shape=f"{label} ({G},{M},{K})@({K},{N})",
                   ms=cuda_ms(lambda: elastic_dense(x, w, act=act), device,
                              iters),
                   plain_ms=cuda_ms(lambda: elastic_dense_plain(
                       x, w, act=act), device, iters),
                   library_ms=cuda_ms(lambda: torch.matmul(x2, w), device,
                                      iters))
        nbytes, ops = 4.0 * (G * M * K + K * N + G * M * N), \
            2.0 * G * M * K * N
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
        add_tc_bound(row, nbytes, ops)
        # serving calls are short: device time beside the back-to-back time
        row["device_ms"] = device_ms(lambda: elastic_dense(x, w, act=act),
                                     device)
        row["library_device_ms"] = device_ms(lambda: torch.matmul(x2, w),
                                             device)
        rows["elastic_dense"].append(row)
    for label, B, S, H, KV, D in (
            ("prefill causal", 1, prompt_len, n_heads, n_kv, head_dim),):
        q, k, v, _ = _k2_inputs(B, S, H, KV, D, None, device, gen)
        G = H // KV
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        row = dict(shape=f"{label} q({B},{S},{H},{D}) kv({B},{S},{KV},{D})",
                   ms=cuda_ms(lambda: flash_attention(q, k, v), device,
                              iters),
                   plain_ms=cuda_ms(lambda: flash_attention_fwd_plain(
                       q, k, v), device, iters),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True), device, iters))
        pairs = B * H * S * (S + 1) / 2          # valid (query, key) pairs
        nbytes = 4.0 * (2 * B * S * H * D + 2 * B * S * KV * D + B * H * S)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * D * pairs)
        add_tc_bound(row, nbytes, 4.0 * D * pairs)
        row["device_ms"] = device_ms(lambda: flash_attention(q, k, v),
                                     device)
        row["library_device_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), device)
        rows["flash_attention"].append(row)
    print_rows(rows)
    # host cost of one call at a size whose device time is negligible: the
    # serving path makes 120 elastic_dense calls per decode step
    x, w, _, _ = _k1_inputs(2, 1, 64, 64, None, False, device, gen)
    na = _i32([64, 32], device)
    q, k, v, _ = _k2_inputs(1, 16, 2, 1, 32, None, device, gen)
    host = {"elastic_dense": host_us(
                lambda: elastic_dense(x, w, n_active=na, act="silu"), device),
            "torch.matmul": host_us(lambda: torch.matmul(x, w), device),
            "flash_attention": host_us(
                lambda: flash_attention(q, k, v), device)}
    print("  host us per call: " + ", ".join(f"{n} {t:.1f}"
                                             for n, t in host.items()))
    rows["elastic_dense"][0]["host_us"] = host["elastic_dense"]
    rows["elastic_dense"][0]["library_host_us"] = host["torch.matmul"]
    rows["flash_attention"][0]["host_us"] = host["flash_attention"]
    return rows


def host_us(fn, device, iters=200) -> float:
    """Host-clock microseconds per call of ``fn`` (enqueue cost; the
    device work of the calls is far shorter at the sizes used)."""
    import torch
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    sync(device)
    return t * 1e6 / iters


# ---------------------------------------------------------------------------
# phase 5: the serving slice
# ---------------------------------------------------------------------------
def path_counters(cfg, serving=False):
    """The kernel wrappers whose launches a path of ``cfg`` must show: K1
    for every MLP block (a dense parent's, deepseek's dense first layer,
    zamba2's shared block), K2 for every GQA attention block (not MLA's,
    which runs plain ops as in the reference), K5–K7 for MoE blocks (and
    K6's gather-dot in training), K8 for SSM blocks; in training also the
    backward kernels K3 / K4 and K9 (serving launches the forward ones
    only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul, moe_dispatch, ssd_scan
    from repro_torch.kernels.elastic_matmul import elastic_dense
    attn = [s for s in cfg.segments if s.kind != "ssm"]
    out = ()
    if cfg.shared_attn_d_ff or any(not s.use_moe for s in attn):
        out += (elastic_dense,)
    if any(s.use_moe for s in attn):
        out += (grouped_matmul.grouped_matmul, moe_dispatch.gather_rows,
                moe_dispatch.gather_reduce) + (() if serving else (
                    moe_dispatch.gather_dot,))
    if cfg.shared_attn_d_ff or (attn and cfg.attn_type == "gqa"):
        out += (fa.flash_attention,) + (() if serving else (
            fa.flash_attention_dq, fa.flash_attention_dkv))
    if cfg.ssm is not None:
        out += (ssd_scan.ssd_scan,) + (() if serving
                                       else (ssd_scan.ssd_scan_bwd,))
    return out


def variant_counters():
    """{kernel name: (wrapper, its variants)} of the kernels whose plan has
    variants, or whose first design stays for measurement: K1, K3–K9 (K6
    counts its first design, copy and scaled gather)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import elastic_matmul as em
    return {"elastic_dense": (em.elastic_dense, em.VARIANTS),
            "flash_attention_dq": (fa.flash_attention_dq,
                                   fa.FLASH_BWD_VARIANTS),
            "flash_attention_dkv": (fa.flash_attention_dkv,
                                    fa.FLASH_BWD_VARIANTS),
            "grouped_matmul": (gm.grouped_matmul, gm.VARIANTS),
            "gather_rows": (md.gather_rows, md.GATHER_COUNTS),
            "gather_reduce": (md.gather_reduce, md.REDUCE_VARIANTS),
            "ssd_scan": (ss.ssd_scan, ss.SSD_VARIANTS),
            "ssd_scan_bwd": (ss.ssd_scan_bwd, ss.SSD_BWD_VARIANTS)}


def reset_launches(counters):
    """Set every counter of ``counters`` (and the per-variant counts of K1,
    K3–K9) to 0 just before a path runs."""
    for c in counters:
        c.launches = 0
    for fn, variants in variant_counters().values():
        fn.launches_by_variant = dict.fromkeys(variants, 0)


def check_variants(launches, problems, moe_variant, ssm_variant):
    """The launches of the path just run, by plan variant, of the kernels
    in ``launches`` that have variants: every K1 launch through a
    tensor-core variant (tile or skinny), never the SIMT tile kept for
    unaligned rows; every K3 / K4 launch through the tensor-core ``mma``;
    every K5 launch through ``moe_variant`` (the training path's ``tile``,
    the serving path's ``stream``; a tuple where the plan takes either at
    the path's shapes); every K6 and K7 launch through the
    redesign (K6's copy or scaled gather, K7's ``split``), never their
    first designs; every K8 launch through ``ssm_variant``; every K9 launch
    through ``mma``. Returns {kernel: counts by variant}."""
    want = {"elastic_dense": ("tile", "skinny"),
            "flash_attention_dq": ("mma",), "flash_attention_dkv": ("mma",),
            "grouped_matmul": moe_variant if isinstance(moe_variant, tuple)
            else (moe_variant,),
            "gather_rows": ("copy", "scaled"), "gather_reduce": ("split",),
            "ssd_scan": (ssm_variant,), "ssd_scan_bwd": ("mma",)}
    out = {}
    for name, (fn, _) in variant_counters().items():
        if name not in launches:
            continue
        by = dict(fn.launches_by_variant)
        out[name] = by
        print(f"  {name} launches by variant: {by}")
        if sum(by[v] for v in want[name]) != launches[name]:
            problems.append(f"{name} launches by variant {by}: not all "
                            f"{launches[name]} through {want[name]}")
    return out


def phase_slice(device, cfg, *, slots, n_requests, prompt_len, gen, seed,
                profiled=("kernel", "dense")):
    """Serve elastic requests through the kernels, then through the dense
    masked path; then one batched decode step of each path in
    ``profiled``, timed and profiled. Returns (launch counts of the kernel
    run, stats)."""
    import numpy as np
    from repro_torch.core.elastic import family_for
    from repro_torch.serving import EdgeServer, Request

    fam = family_for(cfg)
    t0 = time.perf_counter()
    params = fam.init_params(seed=seed, device=device)
    sync(device)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params fp32 on {device} "
          f"(init {time.perf_counter() - t0:.1f} s)")
    rng = random.Random(seed)
    specs = [fam.random_spec(rng) for _ in range(n_requests - 1)] + \
        [fam.full_spec()]
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_requests, prompt_len))
    reqs = [Request(uid=i, spec=specs[i], prompt=prompts[i],
                    max_new_tokens=gen) for i in range(n_requests)]

    def serve(backend):
        server = EdgeServer(fam, params, slots=slots, prompt_len=prompt_len,
                            max_new_tokens=gen, backend=backend,
                            trace_logits=True, device=device)
        sync(device)
        t = time.perf_counter()
        out = server.run(reqs)
        sync(device)
        return out, time.perf_counter() - t

    counters = path_counters(cfg, serving=True)
    reset_launches(counters)
    comps, secs = serve("auto")
    launches = {c.__name__: c.launches for c in counters}
    print(f"  kernel path: {n_requests} requests, {n_requests * gen} "
          f"tokens in {secs:.3f} s -> {n_requests / secs:.3f} req/s, "
          f"{n_requests * gen / secs:.2f} tok/s; launches {launches}")
    problems = []
    if len(comps) != n_requests:
        problems.append(f"{len(comps)} of {n_requests} requests completed")
    for c in comps:
        if len(c.tokens) != gen or not all(np.isfinite(l).all()
                                           for l in c.logits):
            problems.append(f"request {c.uid}: {len(c.tokens)} tokens, "
                            "non-finite logits or short")
    for name, n in launches.items():
        if n <= 0:
            problems.append(f"{name} never launched on the serving path")
    by_variant = check_variants(launches, problems, "stream", "mma")
    if cfg.ssm is not None:          # one K8 per layer and prefill
        want = cfg.n_layers * n_requests
        if launches["ssd_scan"] != want:
            problems.append(f"ssd_scan launched {launches['ssd_scan']} "
                            f"times on the serving path, design {want}")
    ref, ref_secs = serve(None)
    print(f"  dense path: {n_requests * gen / ref_secs:.2f} tok/s")
    worst = 0.0
    for c, r in zip(comps, ref):
        if c.tokens != r.tokens:
            problems.append(f"request {c.uid}: kernel tokens {c.tokens} != "
                            f"dense tokens {r.tokens}")
        for a, b in zip(c.logits, r.logits):
            worst = max(worst, float(np.max(np.abs(a - b)) /
                                     max(1.0, float(np.max(np.abs(b))))))
    same = not any("tokens" in p for p in problems)
    print(f"  kernel vs dense path: greedy tokens "
          f"{'identical' if same else 'DIFFER'}, "
          f"max relative logit err {worst:.3e} (tol {SLICE_LOGIT_RTOL:g})")
    if worst > SLICE_LOGIT_RTOL:
        problems.append(f"logits differ by {worst:.3e}")
    for c in comps:
        print(f"  req{c.uid} ff={c.spec.ff_frac} experts="
              f"{c.spec.expert_frac} heads={c.spec.attn_head_frac} "
              f"ssm_heads={c.spec.ssm_head_frac} "
              f"layers={len(c.spec.layers[0])}: {c.tokens}")
    if problems:
        raise PhaseError("; ".join(problems))
    stats = {"seconds": secs, "requests_per_s": n_requests / secs,
             "tokens_per_s": n_requests * gen / secs,
             "dense_tokens_per_s": n_requests * gen / ref_secs,
             "max_rel_logit_err": worst}
    stats["launches_by_variant"] = by_variant
    if device.type == "cuda":
        fns = {name: decode_step_fn(device, fam, params, specs[:slots], b)
               for name, b in (("kernel", "auto"), ("dense", None))
               if name in profiled}
        walls = {name: step_wall_ms(fn, device) for name, fn in fns.items()}
        for name, fn in fns.items():
            busy, top, _ = step_device_ms(fn, device)
            prof = {"wall_ms": walls[name], "device_busy_ms": busy,
                    "device_idle_share": None if busy is None
                    else max(0.0, 1.0 - busy / walls[name]),
                    "top_kernels_ms": top}
            stats[f"{name}_decode_step"] = prof
            print(f"  {name} path decode step ({slots} slots): "
                  f"{json.dumps(prof)}")
    return launches, stats


def decode_step_fn(device, fam, params, specs, backend):
    """A closure running one batched masked decode step (a slot per spec)
    through ``backend``'s kernel table."""
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.models import transformer as T
    cfg = fam.cfg
    kernels = kernel_dispatch(backend).table()
    caches = T.init_decode_caches(cfg, len(specs), 64, torch.float32, device)
    hosts = [fam.decode_masks(s) for s in specs]
    masks = {k: (tuple(torch.as_tensor(np.stack([h[k][i] for h in hosts]),
                                       device=device)
                       for i in range(len(hosts[0][k])))
                 if isinstance(hosts[0][k], tuple)
                 else torch.as_tensor(np.stack([h[k] for h in hosts]),
                                      device=device)) for k in hosts[0]}
    toks = torch.ones((len(specs), 1), dtype=torch.int64, device=device)
    pos = torch.arange(len(specs), device=device) + 30

    def step():
        T.decode_step(params, cfg, caches, toks, pos, masks=masks,
                      kernels=kernels)
    return step


def step_wall_ms(step, device, steps=3) -> float:
    """Host-clock ms per call of ``step``, ending in a synchronize (run
    before any profiler session: a finished session still slows
    launches)."""
    import torch
    step()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / steps


def step_device_ms(step, device, steps=3):
    """(device-busy ms per call of ``step``, its five costliest kernels,
    the ms of every kernel by name) from ``torch.profiler``; (None, {}, {})
    where it reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
    # device rows only: an operator's row repeats its kernels' time
    kernels_us = {e.key: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) or 0
                  for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")}
    busy = sum(kernels_us.values()) / 1e3 / steps if kernels_us else None
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:5]
    return busy, {k[:60]: v / 1e3 / steps for k, v in top}, \
        {k: v / 1e3 / steps for k, v in kernels_us.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: kernel times at the training slice's shapes
# ---------------------------------------------------------------------------
def attn_pairs(B, S, H, causal=True):
    """Valid (query, key) pairs over every (row, head) of a full-length
    attention."""
    return B * H * (S * (S + 1) / 2 if causal else S * S)


def phase_train_times(device, d_model, d_ff, n_heads, n_kv, head_dim,
                      clients, rows, seq, iters=5):
    """Kernel / plain / library ms and the bound of every kernel at the
    training slice's shapes (full prefixes). Returns {kernel: [row, ...]}
    (K1's rows: forward, dx and dw products; K2, K3, K4: one row each)."""
    import torch
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    gen = torch.Generator(device=device).manual_seed(3)
    G, M = clients, rows * seq
    rows_out = {"elastic_dense": []}
    # (label, layout, rows, contraction, columns, act): the three products
    # of each projection — dx = dpre @ wᵀ, dw = xᵀ @ dpre
    for label, layout, Mx, K, N, act in (
            ("train up/gate fwd", "group", M, d_model, d_ff, "silu"),
            ("train down fwd", "group", M, d_ff, d_model, None),
            ("train dx up", "dx", M, d_ff, d_model, None),
            ("train dx down", "dx", M, d_model, d_ff, None),
            ("train dw up", "dw", d_model, M, d_ff, None),
            ("train dw down", "dw", d_ff, M, d_model, None)):
        x, w, _, _ = _k1_inputs(G, Mx, K, N, None, False, device, gen,
                                layout)
        row = dict(shape=f"{label} ({G},{Mx},{K})@({G},{K},{N})",
                   ms=cuda_ms(lambda: elastic_dense(x, w, act=act), device,
                              iters, 1),
                   plain_ms=cuda_ms(lambda: elastic_dense_plain(
                       x, w, act=act), device, iters, 1),
                   library_ms=cuda_ms(lambda: torch.matmul(x, w), device,
                                      iters, 1))
        nbytes, ops = 4.0 * G * (Mx * K + K * N + Mx * N), \
            2.0 * G * Mx * K * N
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
        add_tc_bound(row, nbytes, ops)
        rows_out["elastic_dense"].append(row)
        del x, w
    rows_out.update(flash_times(device, G * rows, seq, n_heads, n_kv,
                                head_dim, gen, iters))
    print_rows(rows_out)
    return rows_out


def print_rows(rows_out):
    for name, rs in rows_out.items():
        for r in rs:
            lib = "-" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f} ms"
            line = (f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms"
                    + (f" (first design {r['first_ms']:.4f} ms)"
                       if "first_ms" in r else "")
                    + f", plain {r['plain_ms']:.4f} ms, library {lib}, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            if "tc_bound_ms" in r:
                line += (f", 3xTF32 bound {r['tc_bound_ms']:.4f} ms "
                         f"({r['tc_bound_by']}); {r['tflops']:.1f} TFLOP/s, "
                         f"{r['tb_per_s']:.3f} TB/s")
            if None not in (r.get("device_ms"), r.get("library_device_ms")):
                line += (f"; device {r['device_ms']:.4f} ms, library "
                         f"device {r['library_device_ms']:.4f} ms")
            if r.get("first_device_ms") is not None:
                line += f", first design device {r['first_device_ms']:.4f} ms"
            print(line)
            # K3 / K4 / SDPA, and K6 / K7 against their first designs
            if name == "flash_attention_bwd" or ("turns" in r and len(
                    r["turns"]) > 1 and not name.startswith("flash")):
                print("    in turns (median [min, max] ms over "
                      f"{r['rounds']} rounds): " + "; ".join(
                          f"{k} {v['median']:.4f} [{v['min']:.4f}, "
                          f"{v['max']:.4f}]" for k, v in r["turns"].items()))
    if "flash_attention_dq" in rows_out:
        print("  (library for dq, dk/dv and the pair: one "
              "torch.autograd.grad through F.scaled_dot_product_attention, "
              "all three gradients, pinned to the backend the default "
              "dispatch picks)")


def _spread(ts):
    ts = sorted(ts)
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {"median": med, "min": ts[0], "max": ts[-1]}


def turns_ms(device, fns, iters, rounds=7):
    """{name: median, min and max ms} of each callable of ``fns``, timed in
    turns: ``rounds`` rounds, each timing every callable in order
    (``iters`` calls back to back, one warm-up)."""
    times = {n: [] for n in fns}
    for _ in range(rounds):
        for n, fn in fns.items():
            times[n].append(cuda_ms(fn, device, iters, 1))
    return {n: _spread(ts) for n, ts in times.items()}


def flash_times(device, B, S, H, KV, D, gen, iters=5, rounds=7,
                causal=True):
    """Kernel / plain / library ms and the bound of K2, K3 and K4 at one
    training shape, causal unless ``causal`` is False (full head
    prefixes): {kernel: [row]}, with a ``flash_attention_bwd`` row for the
    backward pair. K3, K4 and SDPA's
    all-grads backward are timed in turns: ``rounds`` rounds, each timing
    (``iters`` calls, one warm-up) back to back in this order the pair as
    ``_Flash.backward`` runs it (delta, K3, K4), K3 and K4 in the mma
    variant, K3 and K4 in the simt variant, SDPA's backward pinned to the
    backend the default dispatch picks for these fp32 inputs, and SDPA's
    backward unpinned; each row's ``ms`` (and ``library_ms``) is the
    median, ``turns`` holds every median, min and max."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_dkv,
        flash_attention_dkv_plain, flash_attention_dq,
        flash_attention_dq_plain, flash_attention_fwd_plain)
    rows_out = {}
    q, k, v, _ = _k2_inputs(B, S, H, KV, D, None, device, gen)
    do = torch.randn(q.shape, generator=gen, device=device)
    kw = dict(causal=causal)
    o, lse = flash_attention(q, k, v, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do, o).contiguous()
    Gq = H // KV
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(Gq, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    vt = v.repeat_interleave(Gq, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    backend = sdpa_backend(qt, kt, vt, causal)
    if backend is None:
        ot_pin, backend_name = None, "unknown (default dispatch)"
    else:
        from torch.nn.attention import sdpa_kernel
        with sdpa_kernel([backend]):
            ot_pin = F.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=causal)
        backend_name = backend.name
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    ot_pin = ot if ot_pin is None else ot_pin
    shape = f"q({B},{S},{H},{D}) kv({B},{S},{KV},{D}) " + \
        ("causal" if causal else "non-causal")
    pairs = attn_pairs(B, S, H, causal)
    qbytes, kvbytes, rbytes = 4.0 * B * S * H * D, 4.0 * B * S * KV * D, \
        4.0 * B * H * S
    fwd = dict(shape=shape,
               ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), device,
                          iters),
               plain_ms=cuda_ms(lambda: flash_attention_fwd_plain(
                   q, k, v, **kw), device, iters),
               library_ms=cuda_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt.detach(), kt.detach(), vt.detach(),
                       is_causal=causal), device, iters))
    fwd["bound_ms"], fwd["bound_by"] = bound(
        2 * qbytes + 2 * kvbytes + rbytes, 4.0 * D * pairs)
    add_tc_bound(fwd, 2 * qbytes + 2 * kvbytes + rbytes, 4.0 * D * pairs)
    rows_out["flash_attention"] = [fwd]
    args = (q, k, v, do, lse, delta)
    fns = {
        "pair": lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
        "dq mma": lambda: flash_attention_dq(*args, variant="mma", **kw),
        "dkv mma": lambda: flash_attention_dkv(*args, variant="mma", **kw),
        "dq simt": lambda: flash_attention_dq(*args, variant="simt", **kw),
        "dkv simt": lambda: flash_attention_dkv(*args, variant="simt", **kw),
        f"sdpa {backend_name}": lambda: torch.autograd.grad(
            ot_pin, (qt, kt, vt), dot, retain_graph=True),
        "sdpa unpinned": lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True)}
    turns = turns_ms(device, fns, iters, rounds)
    lib = turns[f"sdpa {backend_name}"]["median"]
    common = dict(shape=f"{shape} {flash_bwd_variant(q, k, v, do)}",
                  library_ms=lib,
                  library_unpinned_ms=turns["sdpa unpinned"]["median"],
                  sdpa_backend=backend_name, rounds=rounds, turns=turns)

    def row(ms, nbytes, ops, **extra):
        r = dict(common, ms=ms, **extra)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
        add_tc_bound(r, nbytes, ops)
        return [r]
    # K3 reads q, do, k, v, lse, delta and writes dq, 6·D operations a
    # valid pair; K4 writes dk, dv, 8·D; the pair reads q, o, do, k, v, lse
    # and writes dq, dk, dv, and the function needs S, dP, dQ, dK and dV
    # once each: 10·D
    rows_out["flash_attention_dq"] = row(
        turns["dq mma"]["median"], 3 * qbytes + 2 * kvbytes + 2 * rbytes,
        6.0 * D * pairs, simt_ms=turns["dq simt"]["median"],
        plain_ms=cuda_ms(lambda: flash_attention_dq_plain(*args, **kw),
                         device, iters))
    rows_out["flash_attention_dkv"] = row(
        turns["dkv mma"]["median"], 2 * qbytes + 4 * kvbytes + 2 * rbytes,
        8.0 * D * pairs, simt_ms=turns["dkv simt"]["median"],
        plain_ms=cuda_ms(lambda: flash_attention_dkv_plain(*args, **kw),
                         device, iters))
    rows_out["flash_attention_bwd"] = row(
        turns["pair"]["median"], 4 * qbytes + 4 * kvbytes + rbytes,
        10.0 * D * pairs, shape=f"{shape} K3 + K4 pair with delta",
        plain_ms=cuda_ms(lambda: (flash_attention_dq_plain(*args, **kw),
                                  flash_attention_dkv_plain(*args, **kw)),
                         device, iters))
    return rows_out


def sdpa_backend(q, k, v, causal=True):
    """The backend PyTorch's default dispatch picks for SDPA on these
    inputs, or None where this PyTorch does not say."""
    import torch
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v,
                                                  is_causal=causal))
    except (AttributeError, ImportError, RuntimeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# phase 8: kernel times at the MoE slices' shapes
# ---------------------------------------------------------------------------
def k5_work(G, E, M, K, N, ga, shared):
    """(bytes, operations) K5 must at least move and do: each live expert's
    rows and weights read once (a shared weight once for every group),
    every output written once; 2 operations per multiply-add of the live
    experts."""
    live = sum(ga)
    w_reads = max(ga) if shared else live
    return (4.0 * (live * M * K + w_reads * K * N + G * E * M * N),
            2.0 * live * M * K * N)


def design_row(device, shape, fns, iters, plain, library, nbytes, ops,
               short, rounds=7):
    """A timing row of a kernel whose callables ``fns`` (the design on the
    main path first, then ``first``, the first design, where it has one) are
    timed in turns (``turns_ms``): ``ms`` the first callable's median,
    ``first_ms`` the first design's, ``turns`` every median and min–max;
    ``plain_ms``, ``library_ms`` (None without a library call) and the
    bound of ``nbytes`` and ``ops``. With ``short`` also the device time per
    call of each design and of the library call (their back-to-back time
    is the host's)."""
    turns = turns_ms(device, fns, iters, rounds)
    main = next(iter(fns))
    row = dict(shape=shape, ms=turns[main]["median"], rounds=rounds,
               turns=turns, plain_ms=cuda_ms(plain, device, iters),
               library_ms=None if library is None
               else cuda_ms(library, device, iters))
    if "first" in fns:
        row["first_ms"] = turns["first"]["median"]
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
    if short:
        row["device_ms"] = device_ms(fns[main], device)
        row["first_device_ms"] = device_ms(fns["first"], device)
        row["library_device_ms"] = None if library is None \
            else device_ms(library, device)
    return row


def combine_vjp_first(dout, y_flat, gate_eff, dest_tj, slot_src, slot_valid,
                      slot_gate):
    """The combine's VJP as the port ran it before its K6 functions were
    fused (timed here only, the yardstick of ``combine_vjp``): the slot
    rows' cotangent by K6's first design and then a multiply by the gates;
    K6's first design again for the slot rows each assignment pointed at,
    and an einsum."""
    import torch
    from repro_torch.kernels.moe_dispatch import gather_rows
    T, k = gate_eff.shape
    dy = gather_rows(dout, slot_src, slot_valid, variant="first") * \
        slot_gate[:, None]
    yg = gather_rows(y_flat, dest_tj,
                     (gate_eff.reshape(-1) != 0).to(torch.int32),
                     variant="first")
    dgate = torch.einsum("td,tjd->tj", dout.float(),
                         yg.reshape(T, k, -1).float())
    return dy, dgate


def phase_moe_times(device, d_model, d_ff, n_experts, top_k, n_heads, n_kv,
                    head_dim, clients, rows, seq, slots, experts, iters=5):
    """Kernel / plain / library ms and the bound of K5, K6 and K7 at the MoE
    training slice's shapes (the cohort's expert prefixes) and at a decode
    step's, and of K2–K4 at the MoE path's attention shape (head_dim 64).
    Returns {kernel: [row, ...]}. Library calls (timed here only):
    ``torch.bmm`` over the G·E expert matrices (``torch.matmul`` with the
    weights broadcast at decode) for K5; ``torch.index_select`` then the
    validity mask for K6; ``torch.index_select`` then ``torch.einsum``
    for K7 (two calls: no single call computes it). The decode rows of K5,
    K6 and K7 also carry the device time per call of kernel and library
    (``device_ms``, ``library_device_ms``): their back-to-back time is the
    host's."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_plain)
    from repro_torch.kernels.backend import stream_handle
    from repro_torch.kernels.moe_dispatch import (
        combine_vjp, gather_dot, gather_dot_plain, gather_reduce,
        gather_reduce_plain, gather_rows, gather_rows_plain)
    from repro_torch.models.moe import capacity
    gen = torch.Generator(device=device).manual_seed(5)
    G, E, tokens = clients, n_experts, rows * seq
    cap = capacity(tokens, MoEConfig(E, top_k, d_ff))
    ga = list(experts)
    dec = [E, max(1, E // 4)][:slots] + [E // 2] * (slots - 2)
    out = {"grouped_matmul": [], "gather_rows": [], "gather_dot": [],
           "gather_reduce": []}
    for label, g, M, K, N, layout, pre in (
            ("train up/gate fwd", G, cap, d_model, d_ff, "layer", ga),
            ("train down fwd", G, cap, d_ff, d_model, "layer", ga),
            ("train dxs up", G, cap, d_ff, d_model, "dx", ga),
            ("train dxs down", G, cap, d_model, d_ff, "dx", ga),
            ("train dws up", G, d_model, cap, d_ff, "dw", ga),
            ("train dws down", G, d_ff, cap, d_model, "dw", ga),
            ("decode up/gate", slots, 8, d_model, d_ff, "shared", dec),
            ("decode down", slots, 8, d_ff, d_model, "shared", dec)):
        x, w = _k5_inputs(g, E, M, K, N, layout, device, gen)
        gat = _i32(pre, device)
        if layout == "shared":
            lib = lambda: torch.matmul(x, w)                 # noqa: E731
        else:
            xb = x.reshape(g * E, M, K) if x.is_contiguous() else \
                x.contiguous().reshape(g * E, M, K)
            wb = w.contiguous().reshape(g * E, K, N)
            lib = lambda: torch.bmm(xb, wb)                  # noqa: E731
        row = dict(shape=f"{label} ({g},{E},{M},{K})@{tuple(w.shape)} "
                         f"g_active={pre} {k5_variant(x, w)}",
                   ms=cuda_ms(lambda: grouped_matmul(x, w, gat), device,
                              iters, 1),
                   plain_ms=cuda_ms(lambda: grouped_matmul_plain(x, w, gat),
                                    device, iters, 1),
                   library_ms=cuda_ms(lib, device, iters, 1))
        work = k5_work(g, E, M, K, N, pre, layout == "shared")
        row["bound_ms"], row["bound_by"] = bound(*work)
        add_tc_bound(row, *work)
        if layout == "shared":     # short: device time beside back to back
            row["device_ms"] = device_ms(lambda: grouped_matmul(x, w, gat),
                                         device)
            row["library_device_ms"] = device_ms(lib, device)
        out["grouped_matmul"].append(row)
        del x, w, lib
    host = {}
    for label, g, T, cp, pre in (("train", G, tokens, cap, ga),
                                 ("decode", slots, 1, 8, dec)):
        t = moe_tables(device, g, T, E, top_k, cp, pre, d_model, gen)
        d, R, T_all = d_model, t["src"].shape[0], g * T
        n_valid = int(t["valid"].sum())
        # the bound reads each input once: a token row that fills several
        # slots is read once
        n_src = int(torch.unique(t["src"][t["valid"] != 0]).numel())
        valid_f = t["valid"].float()[:, None]
        src_c = t["src"].long().clamp(max=T_all - 1)
        short = label == "decode"      # device time beside back to back
        xt, src, valid, y = t["xt"], t["src"], t["valid"], t["y"]
        out["gather_rows"].append(design_row(
            device, f"{label} dispatch R={R} from {T_all} tokens, d={d}, "
            f"{n_valid} valid, {n_src} tokens read",
            {"unrolled": lambda: gather_rows(xt, src, valid),
             "first": lambda: gather_rows(xt, src, valid, variant="first")},
            iters, lambda: gather_rows_plain(xt, src, valid),
            lambda: torch.index_select(xt, 0, src_c) * valid_f,
            4.0 * d * (n_src + R) + 8.0 * R, 0.0, short))
        dest = t["dest"].reshape(T_all, top_k)
        gates = t["gate_eff"]
        nnz = int((gates != 0).sum())
        dest_c = t["dest"].long().clamp(max=y.shape[0] - 1)
        out["gather_reduce"].append(design_row(
            device, f"{label} combine T={T_all} k={top_k} from {y.shape[0]} "
            f"slots, d={d}, {nnz} gathered",
            {"split": lambda: gather_reduce(y, dest, gates),
             "first": lambda: gather_reduce(y, dest, gates, variant="first")},
            iters, lambda: gather_reduce_plain(y, dest, gates),
            lambda: torch.einsum("tj,tjd->td", gates, torch.index_select(
                y, 0, dest_c).view(T_all, top_k, d)),
            4.0 * d * (nnz + T_all) + 8.0 * T_all * top_k, 2.0 * nnz * d,
            short))
        live = (gates.reshape(-1) != 0).to(torch.int32)
        if short:                 # host cost of one call of each wrapper
            z = torch.randn((T_all, d), generator=gen, device=device)
            host = {"gather_rows": host_us(
                        lambda: gather_rows(xt, src, valid), device),
                    "gather_reduce": host_us(
                        lambda: gather_reduce(y, dest, gates), device),
                    "gather_dot": host_us(
                        lambda: gather_dot(y, t["dest"], live, z, top_k),
                        device)}
            if device.type == "cuda":
                # the stream lookup each wrapper makes, before and after
                # they took backend.stream_handle
                host["torch.cuda.current_stream().cuda_stream"] = host_us(
                    lambda: torch.cuda.current_stream(xt.device).cuda_stream,
                    device)
                host["backend.stream_handle"] = host_us(
                    lambda: stream_handle(xt.device), device)
            for name in ("gather_rows", "gather_reduce"):
                out[name][-1]["host_us"] = host[name]
            continue
        # the combine's VJP at the training shape: its two K6 functions,
        # and the whole VJP against the composition it replaced, in turns
        dout = torch.randn((T_all, d), generator=gen, device=device)
        sg = t["slot_gate"]
        sgv = (sg * t["valid"].float())[:, None]
        dy_work = (4.0 * d * (n_src + R) + 12.0 * R, 1.0 * n_valid * d)
        dot_work = (4.0 * d * (nnz + T_all) + 12.0 * T_all * top_k,
                    2.0 * nnz * d)
        out["gather_rows"].append(design_row(
            device, f"train combine vjp dy (scaled) R={R} from {T_all} "
            f"tokens, d={d}, {n_valid} valid",
            {"scaled": lambda: gather_rows(dout, src, valid, scale=sg)},
            iters, lambda: gather_rows_plain(dout, src, valid, sg),
            lambda: torch.index_select(dout, 0, src_c) * sgv, *dy_work,
            False))
        live_f = live.float().view(T_all, top_k)
        out["gather_dot"].append(design_row(
            device, f"train combine vjp dgate T={T_all} k={top_k} from "
            f"{y.shape[0]} slots, d={d}, {nnz} gathered",
            {"dot": lambda: gather_dot(y, t["dest"], live, dout, top_k)},
            iters, lambda: gather_dot_plain(y, t["dest"], live, dout, top_k),
            lambda: torch.einsum("td,tjd->tj", dout, torch.index_select(
                y, 0, dest_c).view(T_all, top_k, d)) * live_f, *dot_work,
            False))
        args = (dout, y, gates, t["dest"], src, valid, sg)
        out["combine_vjp"] = [design_row(
            device, f"train _Combine.backward (dy and dgate), T={T_all} "
            f"k={top_k}, R={R}, d={d}",
            {"fused": lambda: combine_vjp(*args),
             "first": lambda: combine_vjp_first(*args)},
            iters, lambda: (gather_rows_plain(dout, src, valid, sg),
                            gather_dot_plain(y, t["dest"], live, dout,
                                             top_k)),
            None, dy_work[0] + dot_work[0], dy_work[1] + dot_work[1],
            False)]
        del dout, sgv, live_f
    del t
    out.update(flash_times(device, G * rows, seq, n_heads, n_kv, head_dim,
                           gen, iters))
    print_rows(out)
    print("  (library for K7: torch.index_select then torch.einsum, two "
          "calls; for K6: torch.index_select then the validity mask, or the "
          "gates for the scaled gather; for the gather-dot: "
          "torch.index_select, torch.einsum, then the validity mask)")
    print("  host us per call: " + ", ".join(f"{n} {v:.1f}"
                                             for n, v in host.items()))
    return out


# ---------------------------------------------------------------------------
# phase 7: the training slice — federated CFL rounds
# ---------------------------------------------------------------------------
def cut_depth(cfg, n_layers):
    """``cfg`` with its depth cut, its widths kept: ``n_layers`` an int
    cuts a one-segment parent to that many layers; a tuple of (segment
    index, layers) keeps those segments, in that order, each cut to its
    layers (a pair segment's layers are pairs; a kept segment keeps its
    shared block)."""
    import dataclasses
    if isinstance(n_layers, int):
        seg, = cfg.segments
        segs = (dataclasses.replace(seg, n_layers=n_layers),)
    else:
        segs = tuple(dataclasses.replace(cfg.segments[i], n_layers=n)
                     for i, n in n_layers)
    total = sum(s.n_layers * (2 if s.kind == "attn_pair" else 1)
                for s in segs)
    return dataclasses.replace(cfg, name=f"{cfg.name}-{total}l",
                               n_layers=total, segments=segs)


def train_family(cfg, n_layers, seq_len=32, capacity_experts=None):
    """The elastic family of ``cfg`` with its depth cut (``cut_depth``) and
    ``seq_len`` tokens a sample (the latency cost model's and the LM
    population's); a MoE parent may size its capacity by
    ``capacity_experts``."""
    import dataclasses
    from repro_torch.core.elastic import TransformerElasticFamily
    cut = cut_depth(cfg, n_layers)
    if capacity_experts is not None:
        cut = dataclasses.replace(cut, moe=dataclasses.replace(
            cut.moe, capacity_experts=capacity_experts))
    return TransformerElasticFamily(cut, seq_len=seq_len)


def train_specs(fam):
    """The cohort's specs: the full spec plus three from the elastic grid
    that together cut d_ff (``TRAIN_SPECS``; the routed experts on a MoE
    parent, ``MOE_TRAIN_SPECS``), cut the query heads and drop a layer; on
    an SSM parent they cut the SSD heads and drop a layer
    (``SSM_TRAIN_SPECS``)."""
    from repro_torch.core.submodel import TransformerSubSpec
    n = fam.cfg.segments[0].n_layers
    if fam.cfg.ssm is not None:
        return [TransformerSubSpec((tuple(range(1 if drop else 0, n)),),
                                   ssm_head_frac=w)
                for drop, w in SSM_TRAIN_SPECS]
    moe = fam.cfg.moe is not None
    width = "expert_frac" if moe else "ff_frac"
    return [TransformerSubSpec((tuple(range(1 if drop else 0, n)),),
                               attn_head_frac=ah, **{width: w})
            for drop, w, ah in (MOE_TRAIN_SPECS if moe else TRAIN_SPECS)]


def train_prefixes(fam):
    """Each client's d_ff (or routed-expert) and query-head prefix (SSD-head
    prefix on an SSM parent) in the training cohort, read off the cohort's
    forward masks (host side)."""
    fwd = fam.cohort_masks(train_specs(fam), "cpu").fwd
    if fam.cfg.ssm is not None:
        return {"heads": [int(n) for n in fwd["ssm_heads"].sum(-1)]}
    width = "experts" if fam.cfg.moe is not None else "ff"
    return {width: [int(n) for n in fwd[width].sum(-1)],
            "heads": [int(n) for n in fwd["heads"].sum(-1)]}


def design_launches(n_layers, steps, rounds, moe=False, ssm=False):
    """Launches per kernel that the design gives for ``rounds`` rounds of
    ``steps`` local steps (every client stepping) and one eval pass each,
    per layer: K2 1 per step and eval pass, K3 and K4 1 per step; on a
    dense parent K1 3 forward + 7 backward per step (dx and dw of up, gate
    and down, and the gate's pre-activation recomputed) and 3 per eval
    pass; on a MoE parent, per step K5 3 + 6 (dxs and dws of up, gate and
    down), K6 1 + 2 (the dispatch; the combine's VJP: the scaled gather of
    the slot rows' cotangent on ``gather_rows``, the gather-dot of its gate
    cotangent on ``gather_dot``), K7 1 + 1 (the combine; the dispatch's
    VJP), and per eval pass K5 3, K6 1, K7 1. On an
    SSM parent, per step K8 2 (the forward, and the backward's rerun for
    the per-chunk states) and K9 1, and per eval pass K8 1."""
    if ssm:
        per = {"ssd_scan": (2, 1), "ssd_scan_bwd": (1, 0)}
        return {name: rounds * n_layers * (step * steps + ev)
                for name, (step, ev) in per.items()}
    per = {"flash_attention": (1, 1), "flash_attention_dq": (1, 0),
           "flash_attention_dkv": (1, 0)}
    per.update({"grouped_matmul": (9, 3), "gather_rows": (2, 1),
                "gather_dot": (1, 0), "gather_reduce": (2, 1)} if moe
               else {"elastic_dense": (10, 3)})
    return {name: rounds * n_layers * (step * steps + ev)
            for name, (step, ev) in per.items()}


def design_launches_of(cfg, steps, rounds):
    """``design_launches`` summed over the blocks of ``cfg``, whatever its
    segments: every attention block (a pair's two, the shared block once a
    site) with GQA attention K2–K4, an MLA one none; every MLP block (the
    shared block's too) K1's, every MoE block K5–K7's, every SSM block
    K8 / K9's. A dropped layer still runs (its gate is 0), so the counts do
    not depend on the specs."""
    blocks = []                       # (moe, ssm, gqa) per block a forward
    for seg in cfg.segments:
        per = 2 if seg.kind == "attn_pair" else 1
        blocks += [(seg.use_moe, seg.kind == "ssm",
                    cfg.attn_type == "gqa")] * (per * seg.n_layers)
        if seg.shared_attn_after:
            blocks.append((False, False, True))
    out = {}
    for moe, ssm, gqa in blocks:
        for name, n in design_launches(1, steps, rounds, moe=moe,
                                       ssm=ssm).items():
            if gqa or ssm or not name.startswith("flash"):
                out[name] = out.get(name, 0) + n
    return out


def phase_train(device, cfg, *, n_layers, clients, batch, seq_len,
                train_seqs, test_seqs, lr, momentum, grad_clip, rounds,
                seed):
    """``rounds`` sync CFL rounds of ``clients`` clients through
    ``BatchedRoundEngine.run_fl_round`` on the kernels, then the same
    rounds on the dense masked path; returns (launch counts of the kernel
    run, stats). Each path first runs one untimed warm-up round on its own
    copy of the starting parameters, so that both paths' round 1 is timed
    warm; the kernel path's warm-up round and one more warm round run
    under ``torch.profiler``, and their split (host time, device time, the
    entries that cost most in the first round over the warm one) says what
    a path's first round pays. Raises PhaseError unless every kernel
    launched as often as the design says, the two paths' round-1
    parameters agree and every client's accuracy agrees to one eval
    token."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.data.synth import make_lm_dataset
    from repro_torch.fl.engine import BatchedRoundEngine
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    fam = train_family(cfg, n_layers)
    cfg = fam.cfg
    t0 = time.perf_counter()
    params0 = fam.init_params(seed=seed, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params0))
    specs = train_specs(fam)
    train = [make_lm_dataset(train_seqs, seq_len, cfg.vocab_size,
                             seed=seed * 100 + k, chain_seed=1000 + k)
             for k in range(clients)]
    test = [make_lm_dataset(test_seqs, seq_len, cfg.vocab_size,
                            seed=seed * 100 + 50 + k, chain_seed=1000 + k)
            for k in range(clients)]
    sizes = [len(d["y"]) for d in train]
    print(f"  {cfg.name}: d_model {cfg.d_model}, {n_params / 1e6:.1f} M "
          f"params fp32 per copy, {clients} clients x {train_seqs} train / "
          f"{test_seqs} test sequences of {seq_len} tokens, batch {batch}; "
          f"init {time.perf_counter() - t0:.1f} s")
    for k, sp in enumerate(specs):
        print(f"  client {k}: layers {sp.layers[0]} ff_frac {sp.ff_frac} "
              f"expert_frac {sp.expert_frac} attn_head_frac "
              f"{sp.attn_head_frac} ssm_head_frac {sp.ssm_head_frac}")
    kw = dict(batch_size=batch, epochs=1)
    moe = cfg.moe is not None
    counters = path_counters(cfg)
    routes = {}

    def run(backend, replay=None, n_rounds=rounds, start=None, log=True):
        """``n_rounds`` rounds on ``backend``'s path from ``start`` (the
        starting parameters by default). With ``log`` (a warm-up round logs
        nothing), every MoE layer call's top-k ids and margins are recorded
        in ``routes[backend]`` (a ``RouteLog``); with ``replay`` (a
        ``RouteLog``), each call takes its logged ids in place of its own
        top-k."""
        eng = BatchedRoundEngine(fam, lr=lr, momentum=momentum,
                                 grad_clip=grad_clip, backend=backend,
                                 device=device)
        if replay is not None:
            hook = replay("replay")
        elif log:
            hook = routes.setdefault(backend, RouteLog(margins=True))(
                "record")
        else:
            hook = contextlib.nullcontext()
        p, out = params0 if start is None else start, []
        with hook:
            for r in range(n_rounds):
                sync(device)
                t = time.perf_counter()
                p, accs, n_steps = eng.run_fl_round(
                    p, specs, train, test, sizes, coverage_norm=r > 0,
                    seeds=[seed * 1000 + r * clients + k
                           for k in range(clients)], **kw)
                sync(device)
                out.append(dict(params=p, accs=accs, n_steps=n_steps,
                                seconds=time.perf_counter() - t))
        if replay is not None and replay.pos != len(replay.ids):
            raise PhaseError(f"replayed {replay.pos} of {len(replay.ids)} "
                             "recorded routes")
        return eng, out

    def profiled_rounds(backend):
        """The first two rounds of ``backend``'s path, each on its own copy
        of the starting parameters, in one ``torch.profiler`` session (a
        second session slows a host-bound path's launches): for each, wall
        seconds, the host's self time, the device's busy time, and per
        entry (operator, runtime call or kernel) its host and device ms.
        Events are assigned to a round by their start time (the device is
        synchronised at the end of each round)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        walls = []
        with profile(activities=acts) as prof:
            for label in ("first", "warm"):
                start = tree_map(lambda a: a.clone(), params0)
                sync(device)
                t = time.perf_counter()
                with record_function(f"chip_smoke {label} round"):
                    run(backend, n_rounds=1, start=start, log=False)
                    sync(device)
                walls.append(time.perf_counter() - t)
                del start
        events = prof.events()
        second = min(e.time_range.start for e in events
                     if e.name == "chip_smoke warm round")
        out = [{"wall_s": w, "entries": {}} for w in walls]
        for e in events:
            if e.name.startswith("chip_smoke "):
                continue
            on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
            us = (getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) or 0) \
                if on_device else e.self_cpu_time_total
            entries = out[int(e.time_range.start >= second)]["entries"]
            host, dev = entries.get(e.key, (0.0, 0.0))
            entries[e.key] = (host + (0 if on_device else us / 1e3),
                              dev + (us / 1e3 if on_device else 0))
        for o in out:
            o["host_self_s"] = sum(h for h, _ in o["entries"].values()) / 1e3
            o["device_busy_s"] = sum(d for _, d in
                                     o["entries"].values()) / 1e3
        return out

    cuda = device.type == "cuda"
    # untimed warm-up rounds, each path on its own copy of the starting
    # parameters: the kernel path's first two under the profiler
    first, warm = profiled_rounds("auto")
    run(None, n_rounds=1, start=tree_map(lambda a: a.clone(), params0),
        log=False)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches(counters)
    eng, kern = run("auto")
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    steps = int(kern[0]["n_steps"].max())
    want = design_launches(n_layers, steps, rounds, moe=moe,
                           ssm=cfg.ssm is not None)
    tokens = int(sum(kern[0]["n_steps"])) * batch * seq_len
    _, dense = run(None)
    problems = []
    route_stats = replayed = None
    if moe:
        route_stats = routing_stats(routes["auto"], routes[None],
                                    cfg.moe.top_k, n_layers)
        if route_stats["calls"][0] != route_stats["calls"][1]:
            problems.append("the paths made different numbers of MoE "
                            "layer calls")
        # the dense path again, under the kernel path's routing: top-k is
        # discontinuous, so a flip from 1e-7 noise upstream cascades (see
        # routing_stats); with the routes held equal the two paths compute
        # the same function and their parameters must agree
        _, replayed = run(None, replay=routes["auto"])
        routes.clear()
    for name, n in launches.items():
        print(f"  {name}: {n} launches (design: {want[name]})")
        if n <= 0 or n != want[name]:
            problems.append(f"{name} launched {n} times, design "
                            f"{want[name]}")
    # (the dense path runs no kernel: the counts are still the kernel run's)
    by_variant = check_variants(launches, problems, "tile", "mma")
    # the first round's cost: the kernel path's warm-up round against the
    # warm round after it, both under the profiler
    split = first_round_split(first, warm)
    print(f"  kernel path, first round (the warm-up) against a warm round, "
          f"both under torch.profiler: {json.dumps(split)}")
    for r, (a, b) in enumerate(zip(kern, dense)):
        print(f"  round {r + 1} ({'coverage_norm' if r else 'paper rule'},"
              f" after a warm-up round per path):"
              f" kernel path {a['seconds']:.3f} s "
              f"({tokens / a['seconds']:.0f} train tok/s), dense path "
              f"{b['seconds']:.3f} s ({tokens / b['seconds']:.0f} tok/s); "
              f"accs kernel {np.round(a['accs'], 5).tolist()} dense "
              f"{np.round(b['accs'], 5).tolist()}; steps "
              f"{a['n_steps'].tolist()}")
        eval_tokens = test_seqs * (seq_len - 1)
        worst_acc = max(abs(x - y) for x, y in zip(a["accs"], b["accs"]))
        if worst_acc > 1.0 / eval_tokens + 1e-6:
            problems.append(f"round {r + 1}: accuracies differ by "
                            f"{worst_acc:.5f} > one eval token")
        for name, res in (("kernel", a), ("dense", b)):
            if not all(bool(torch.isfinite(t).all())
                       for t in tree_leaves(res["params"])):
                problems.append(f"round {r + 1}: non-finite parameters on "
                                f"the {name} path")
    moved = max(float((y - z).abs().max()) for y, z in zip(
        tree_leaves(dense[0]["params"]), tree_leaves(params0)))
    ratios = {}
    for name, other in (("dense", dense), ("dense, kernel routes", replayed)):
        if other is None:
            continue
        diff = max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(kern[0]["params"]), tree_leaves(other[0]["params"])))
        ratios[name] = diff / moved
        held = other is replayed or not moe
        print(f"  round-1 parameters: max|kernel - {name}| {diff:.3e}, "
              f"max|dense - initial| {moved:.3e}, ratio {diff / moved:.3e} "
              + ("(tol 1e-3)" if held else "(not held: routes differ)"))
        if held and not diff <= 1e-3 * moved:
            problems.append(f"round-1 parameters ({name}) differ by "
                            f"{diff:.3e} > 1e-3 x {moved:.3e}")
    # accuracies stay near 0 at these settings (random weights, 2 steps):
    # each path's round-1 model also scores every client's test set by its
    # own forward (the kernels', or the dense masked path)
    loss = {"kernel": eval_losses(fam, specs, test, kern[0]["params"],
                                  "auto", device)}
    for name, other in (("dense", dense), ("dense, kernel routes", replayed)):
        if other is None:
            continue
        loss[name] = eval_losses(fam, specs, test, other[0]["params"], None,
                                 device)
        worst_loss = float(np.max(np.abs(loss["kernel"] - loss[name])
                                  / np.abs(loss[name])))
        if not (np.isfinite(loss["kernel"]).all()
                and np.isfinite(loss[name]).all()):
            problems.append(f"round-1 eval losses ({name}) not finite")
        print(f"  round-1 eval CE per client: kernel "
              f"{np.round(loss['kernel'], 6).tolist()} {name} "
              f"{np.round(loss[name], 6).tolist()}; max relative "
              f"difference {worst_loss:.3e} (tol {TRAIN_LOSS_RTOL:g})")
        if not worst_loss <= TRAIN_LOSS_RTOL:
            problems.append(f"round-1 eval losses ({name}) differ by "
                            f"{worst_loss:.3e}")
    print(f"  peak device memory (kernel-path rounds): {peak / 2**30:.2f} "
          f"GiB")
    stats = {"round_seconds": [a["seconds"] for a in kern],
             "dense_round_seconds": [b["seconds"] for b in dense],
             "train_tokens_per_round": tokens,
             "train_tokens_per_s": [tokens / a["seconds"] for a in kern],
             "dense_train_tokens_per_s": [tokens / b["seconds"]
                                          for b in dense],
             "accs": [a["accs"] for a in kern],
             "dense_accs": [b["accs"] for b in dense],
             "round1_param_diff_over_move": ratios,
             "round1_max_param_move": moved,
             "round1_eval_ce": {k: v.tolist() for k, v in loss.items()},
             "max_memory_allocated_gib": peak / 2**30,
             "launches_design": want, "routing": route_stats,
             "first_round_split": split, "launches_by_variant": by_variant}
    del kern, dense, replayed
    if problems:
        raise PhaseError("; ".join(problems))
    if not cuda:
        return launches, stats
    step = local_step_fn(eng, fam, params0, specs, train, batch, device)
    wall = step_wall_ms(step, device)
    busy, top, by_name = step_device_ms(step, device)
    prof = {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": None if busy is None
            else max(0.0, 1.0 - busy / wall), "top_kernels_ms": top}
    # each kernel of the path: its device ms in the step and share of busy
    prof["kernels_ms"] = {}
    for name in launches:
        ms = sum(v for k, v in by_name.items()
                 if any(f in k for f in KERNEL_FUNCTIONS[name]))
        prof["kernels_ms"][name] = ms
        prof["kernels_ms"][f"{name} share"] = ms / busy if busy else None
    stats["kernel_local_step"] = prof
    print(f"  kernel path local step ({clients} clients x {batch} x "
          f"{seq_len}): {json.dumps(prof)}")
    if "flash_attention_dq" in launches and busy:
        km = prof["kernels_ms"]
        print(f"  K3 / K4 in the local step ({n_layers} layers, device): "
              f"dq {km['flash_attention_dq']:.4f} ms, dk/dv "
              f"{km['flash_attention_dkv']:.4f} ms of {busy:.4f} ms busy")
    if "ssd_scan_bwd" in launches and busy:
        km = prof["kernels_ms"]
        print(f"  K9 in the local step ({n_layers} layers, device): "
              f"{km['ssd_scan_bwd']:.4f} ms of {busy:.4f} ms busy "
              f"(share {km['ssd_scan_bwd share']:.4f}); K8 "
              f"{km['ssd_scan']:.4f} ms")
    return launches, stats


def first_round_split(first, warm, top=6):
    """Where a path's first round goes: wall, host self and device busy
    seconds of the first (cold) round and of a warm one, and the entries
    whose host + device ms grew most from the warm round to the first."""
    keys = set(first["entries"]) | set(warm["entries"])
    grown = []
    for k in keys:
        h1, d1 = first["entries"].get(k, (0.0, 0.0))
        h2, d2 = warm["entries"].get(k, (0.0, 0.0))
        grown.append(((h1 + d1) - (h2 + d2), k, h1, h2, d1, d2))
    grown.sort(reverse=True)
    return {name: {"first": first[f], "warm": warm[f]}
            for name, f in (("wall_s", "wall_s"),
                            ("host_self_s", "host_self_s"),
                            ("device_busy_s", "device_busy_s"))} | {
        "largest_new_ms": [
            {"entry": k[:70], "host_first": round(h1, 3),
             "host_warm": round(h2, 3), "device_first": round(d1, 3),
             "device_warm": round(d2, 3)}
            for _, k, h1, h2, d1, d2 in grown[:top]]}


def routing_stats(kern, dense, top_k, n_layers):
    """Where two paths' MoE routing differs: their ``RouteLog`` records
    (the kernel path's with margins), per MoE layer call, in call order.
    Counts the token-layer decisions whose expert *sets* differ, per call,
    and, at the first call with a difference, the kernel path's margins of
    the tokens that differ (a flip from noise upstream shows a margin near
    the noise; later differences cascade from it through attention,
    capacity and the next layers)."""
    import torch
    per_call = [int((torch.sort(a, -1).values != torch.sort(b, -1).values)
                    .any(-1).sum()) for a, b in zip(kern.ids, dense.ids)]
    decisions = sum(a.shape[0] * a.shape[1] for a in kern.ids)
    first = next((i for i, n in enumerate(per_call) if n), None)
    margins = None
    if first is not None:
        a, m, b = kern.ids[first], kern.margins[first], dense.ids[first]
        diff = (torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
        margins = sorted(float(x) for x in m[diff])[:8]
    stats = {"decisions": decisions, "differ": sum(per_call),
             "per_call": per_call, "calls": [len(kern.ids), len(dense.ids)],
             "first_call": first, "first_margins": margins,
             "min_margin": min(float(m.min()) for m in kern.margins)}
    where = "" if first is None else (
        f"; first at call {first} (pass {first // n_layers}, layer "
        f"{first % n_layers}), kernel-path top-{top_k} margins of its "
        f"differing tokens {margins}")
    print(f"  routing: {stats['differ']} of {decisions} token-layer top-"
          f"{top_k} expert sets differ between the kernel and the dense "
          f"path ({len(kern.ids)} / {len(dense.ids)} MoE layer calls)"
          f"{where}; "
          f"per call {per_call}; smallest margin of any decision "
          f"{stats['min_margin']:.3e}")
    return stats


def eval_losses(fam, specs, test, params, backend, device):
    """Per-client next-token CE of one parent on each client's test set,
    each client through its own submodel's masks, on ``backend``'s path."""
    import torch
    from repro_torch.fl.engine import pack_eval
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.optim.optimizers import tree_map
    G = len(specs)
    pack = pack_eval(test)
    stacked = tree_map(lambda a: a.expand((G,) + a.shape), params)
    with torch.no_grad():
        ce = fam.masked_loss(
            stacked, fam.cohort_masks(specs, device).fwd,
            torch.as_tensor(pack.x, device=device).long(), None,
            torch.as_tensor(pack.valid, device=device),
            kernels=kernel_dispatch(backend).table())
    return ce.cpu().numpy()


def local_step_fn(eng, fam, params0, specs, train, batch, device):
    """A closure running one local step of every client (the body of one
    round's local training) through ``eng``."""
    import torch
    from repro_torch.fl.engine import pack_cohort_data
    G = len(specs)
    params, opt_state = eng.local_state(eng.broadcast_params(params0, G))
    masks = fam.cohort_masks(specs, device)
    x = torch.as_tensor(pack_cohort_data(train)[0][:, :batch],
                        device=device).long()
    sw = torch.ones((G, batch), device=device)

    def step():
        eng.local_step(params, opt_state, masks, x, sw)
    return step


# ---------------------------------------------------------------------------
# phases 3c and 11: the SSD scan kernels (K8, K9)
# ---------------------------------------------------------------------------
def ssd_cases(d_model, head_dim, d_state, clients, rows, seq, chunk, heads,
              prompt_len):
    """(label, R, S, H, P, G, N, Q, h_active, dt range) for K8 / K9: the
    training path's shapes (R = clients × rows; row r belongs to client
    r // rows, with that client's SSD-head prefix), the prefill, then the
    edges (prefix 0 / ragged / full per row, two groups, one chunk and
    four, a chunk that is not a multiple of the 64-row tile, dt = 1 with A
    down to −16, whose Σ|dt·A| in a chunk passes 88, the prefill with a
    ragged head prefix, and two shapes of K8's simt variant)."""
    H = 2 * d_model // head_dim
    has = [heads[r // rows] for r in range(clients * rows)]
    pchunk = min(chunk, prompt_len)  # a shorter prompt is one chunk (model)
    return [
        ("train", clients * rows, seq, H, head_dim, 1, d_state, chunk, has,
         (0.01, 0.3)),
        ("prefill", 1, prompt_len, H, head_dim, 1, d_state, pchunk, None,
         (0.01, 0.3)),
        ("prefix 0/ragged/full", 3, 128, 40, 64, 1, 32, 64, [0, 37, 40],
         (0.01, 0.3)),
        ("groups 2", 2, 128, 8, 32, 2, 16, 32, [8, 5], (0.01, 0.3)),
        ("one chunk", 2, 64, 4, 64, 1, 128, 64, [4, 1], (0.01, 0.3)),
        ("chunk 100", 2, 300, 3, 32, 1, 64, 100, [3, 2], (0.01, 0.3)),
        ("sum|dt A| > 88", 1, 256, 4, 64, 1, 128, 128, None, (1.0, 1.0)),
        # the prefill's P split with heads past a ragged prefix; d_state
        # not a multiple of 8 and a chunk above 256 (the simt variant)
        ("prefill heads ragged", 1, prompt_len, H, head_dim, 1, d_state,
         pchunk, [H // 2 + 3], (0.01, 0.3)),
        ("d_state 20", 2, 64, 4, 32, 1, 20, 32, [4, 2], (0.01, 0.3)),
        ("chunk 320", 1, 640, 2, 64, 1, 64, 320, None, (0.01, 0.3)),
    ]


def k8_plan(x, Bm, Cm, Q):
    """K8's launch plan for these operands, as text (``plain`` on the CPU,
    where the wrapper runs the plain version)."""
    if x.device.type != "cuda":
        return "plain"
    from repro_torch.kernels.ssd_scan import launch_plan
    plan = launch_plan(x, Bm, Cm, Q)
    return f"{plan.variant} p_tile={plan.p_tile}"


def k9_variants(x, Bm, Cm, st, dy, Q):
    """K9's plan for these operands as text, and the variants phase 3c
    runs: the plan's, and simt beside mma (``plain`` and none on the
    CPU)."""
    if x.device.type != "cuda":
        return "plain", [None]
    from repro_torch.kernels.ssd_scan import bwd_launch_plan
    plan = bwd_launch_plan(x, Bm, Cm, st, dy, Q)
    text = f"{plan.variant} head_slice={plan.head_slice}"
    return text, (["mma", "simt"] if plan.variant == "mma" else ["simt"])


def _ssd_inputs(R, S, H, P, G, N, dt_range, device, gen):
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    lo, hi = dt_range
    dt = lo + (hi - lo) * torch.rand((R, S, H), generator=gen,
                                     device=device)
    # each row its own A (each client its own A_log), −1 … −16
    A = -torch.exp(torch.linspace(0.0, math.log(16.0), H, device=device)
                   )[None].expand(R, H) * (
        1.0 + 0.1 * torch.rand((R, 1), generator=gen, device=device))
    return rn(R, S, H, P), dt.contiguous(), A.contiguous(), \
        rn(R, S, G, N), rn(R, S, G, N)


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def phase_ssd_kernels(device, d_model, head_dim, d_state, clients, rows,
                      seq, chunk, heads, prompt_len, edges=True):
    """K8 (y and the per-chunk states) and K9 (its own outputs dx, ddt, du,
    and dB, dC per group, fed by K8's own states; the plain backward takes
    the plain forward's) against their plain versions on ``ssd_cases``,
    each error relative to the largest value of its output; and dA, the
    sum of K9's fp64 partials Σ_s du·dt, relative to Σ_s |du·dt|. K9 runs in
    each variant the operands take (mma and simt where the plan is mma),
    twice each, and each run must equal the first bit for bit; heads past
    the prefix must get exact zeros. Returns the worst error of each
    kernel. Raises PhaseError past a tolerance or on a non-finite value.
    ``edges=False`` runs the training and the prefill case alone (another
    parent's shapes, the edges having run once)."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd_raw,
                                              ssd_scan_bwd_raw_plain,
                                              ssd_scan_plain)
    gen = torch.Generator(device=device).manual_seed(6)
    worst = {"ssd_scan": 0.0, "ssd_scan_bwd": 0.0}
    failed = []
    cases = ssd_cases(d_model, head_dim, d_state, clients, rows, seq, chunk,
                      heads, prompt_len)
    for label, R, S, H, P, G, N, Q, ha, dtr in cases[:None if edges else 2]:
        x, dt, A, Bm, Cm = _ssd_inputs(R, S, H, P, G, N, dtr, device, gen)
        hat = None if ha is None else _i32(ha, device)
        plan = k8_plan(x, Bm, Cm, Q)
        y, st = ssd_scan(x, dt, A, Bm, Cm, Q, h_active=hat,
                         return_states=True)
        y1 = ssd_scan(x, dt, A, Bm, Cm, Q, h_active=hat)
        y_p, st_p = ssd_scan_plain(x, dt, A, Bm, Cm, Q, hat, True)
        dy = torch.randn(x.shape, generator=gen, device=device)
        g_p = ssd_scan_bwd_raw_plain(x, dt, A, Bm, Cm, st_p, dy, Q, hat)
        sync(device)
        e8 = max(_rel_err(y, y_p), _rel_err(st, st_p) if st_p.any() else
                 float(st.abs().max()))
        ok8 = e8 <= K8_RTOL and bool(torch.equal(y, y1)) and all(
            bool(torch.isfinite(t).all()) for t in (y, st)) and (
            ha is None or all(not bool(y[r, :, n:].any())
                              for r, n in enumerate(ha)))
        worst["ssd_scan"] = max(worst["ssd_scan"], e8)
        shown = ha if ha is None or len(ha) < 6 else "per client"
        sum_dA = float((dt * A[:, None, :]).reshape(
            R, S // Q, Q, H).sum(2).abs().max())
        print(f"  ssd_scan fwd {label:20s} R={R} S={S} H={H} P={P} G={G}"
              f" N={N} Q={Q} h_active={shown} {plan} max chunk sum|dt A| "
              f"{sum_dA:.1f}: max|err|/max y,states {e8:.3e} (tol "
              f"{K8_RTOL:g}) {'ok' if ok8 else 'FAIL'}")
        if not ok8:
            failed.append(f"ssd_scan {label}")
        bplan, variants = k9_variants(x, Bm, Cm, st, dy, Q)
        for variant in variants:
            kw = {} if variant is None else {"variant": variant}
            g = ssd_scan_bwd_raw(x, dt, A, Bm, Cm, st, dy, Q, h_active=hat,
                                 **kw)
            g1 = ssd_scan_bwd_raw(x, dt, A, Bm, Cm, st, dy, Q,
                                  h_active=hat, **kw)
            sync(device)
            e9s = {n: _rel_err(a, b) for n, a, b in
                   zip(("dx", "ddt", "du", "dB", "dC"), g, g_p)}
            # dA = Σ of K9's fp64 partials Σ_s du·dt, which cancel along
            # s: their rounding scales with Σ_s |du·dt|
            dA, dA_p = (t[5].sum(-1) for t in (g, g_p))
            e9s["dA"] = float((dA - dA_p).abs().max()) / max(float(
                torch.einsum("rsh,rsh->rh", g_p[2].abs(), dt).max()),
                1e-30)
            e9 = max(e9s.values())
            worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], e9)
            finite = all(bool(torch.isfinite(t).all()) for t in g)
            same = all(bool(torch.equal(a, b)) for a, b in zip(g, g1))
            dead_zero = ha is None or all(
                not any(bool(t[r, :, n:].any()) for t in g[:3])
                for r, n in enumerate(ha))
            ok = e9 <= K9_RTOL and finite and same and dead_zero
            print(f"    ssd_scan_bwd {variant or 'plain'} (plan {bplan}): "
                  f"cotangents {e9:.3e} (tol {K9_RTOL:g}; worst "
                  f"{max(e9s, key=e9s.get)}), second run bit-equal {same}, "
                  f"dead heads zero {dead_zero} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"ssd_scan_bwd {variant} {label}")
            del g, g1
        del x, dt, A, Bm, Cm, y, st, y_p, st_p, g_p
    if failed:
        raise PhaseError(f"SSD kernels disagree with their plain versions: "
                         f"{failed}")
    return worst


def ssd_work(R, S, H, P, G, N, Q, ha, backward=False, states=False):
    """(bytes, operations) K8 (or K9) must at least move and do, with the
    causal triangle T = Q(Q+1)/2 and 2T·N per (row, group, chunk) with a
    live head for C·Bᵀ (one product per group). K8: 2T·P + 4QPN per live
    (row, head, chunk). K9, per live (row, head): 2T(2N+2P) per chunk (dG,
    and the intra-chunk products of dxdt, dC and dB), 2QPN per chunk for
    dy·h_in (dC's inter-chunk term; inter dcum = e_t Σ_n C_t∘(dy·h_in)_t
    reuses it), and 6QPN per chunk but one: the state terms xdt·dh and
    B·dhᵀ where dh ≠ 0 (every chunk but the last) and dh_y where it is
    used (every chunk but the first). (The earlier count followed the
    simt kernel's work, 2T(3N+2P) + 10QPN per live (row, head, chunk),
    with C·Bᵀ per head and dB / dC written per head: 87.5 GFLOP and 1.05
    GB at the training slice.) x and y (K9: x, dy and dx) once per live head, B,
    C and dt once per row, the states written (K8) or read (K9) once per
    live head, and K9's outputs (ddt, du per head, dB, dC per group)
    once."""
    has = list(ha) if ha is not None else [H] * R
    live = sum(has)
    groups = sum(-(-min(h, H) // (H // G)) for h in has)
    nc = S // Q
    T = Q * (Q + 1) / 2
    if backward:
        ops = (nc * (2 * T * (2 * N + 2 * P) + 2 * Q * P * N)
               + (nc - 1) * 6 * Q * P * N) * live + 2 * T * N * groups * nc
        nbytes = 4.0 * (3 * live * S * P + R * S * (2 * G * N + H)
                        + live * nc * P * N + R * S * (2 * H + 2 * G * N))
    else:
        ops = (2 * T * P + 4 * Q * P * N) * live * nc \
            + 2 * T * N * groups * nc
        nbytes = 4.0 * (2 * live * S * P + R * S * (2 * G * N + H)
                        + (live * nc * P * N if states else 0))
    return nbytes, ops


def phase_ssd_times(device, d_model, head_dim, d_state, clients, rows, seq,
                    chunk, heads, prompt_len, iters=5, rounds=7):
    """Kernel / plain ms and the bound of K8 (forward; forward with the
    states) and K9 at the SSM training slice's shapes (its head prefixes),
    and of K8 at the prefill's. K9 is timed in turns: ``rounds`` rounds,
    each timing (``iters`` calls, one warm-up) its mma and simt variants
    and the whole ``ssd_scan_bwd`` (K9 and dA) in each; its row's ``ms``
    is the plan's variant's median, ``turns`` holds every median, min and
    max, and ``device_split_ms`` the device time of each CUDA kernel of
    one call of the plan's variant. No single PyTorch call computes an SSD scan (``library_ms``
    None); the dense masked path's time (``models.ssm.ssd_chunked``, and
    autograd through it) is kept as ``dense_ms``, information and not a
    yardstick."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                              ssd_scan_bwd_raw,
                                              ssd_scan_bwd_raw_plain,
                                              ssd_scan_plain)
    from repro_torch.models.ssm import ssd_chunked
    gen = torch.Generator(device=device).manual_seed(7)
    H = 2 * d_model // head_dim
    out = {"ssd_scan": [], "ssd_scan_bwd": []}
    R = clients * rows
    ha = [heads[r // rows] for r in range(R)]
    x, dt, A, Bm, Cm = _ssd_inputs(R, seq, H, head_dim, 1, d_state,
                                   (0.01, 0.3), device, gen)
    hat = _i32(ha, device)
    shape = (f"train xh({R},{seq},{H},{head_dim}) B,C({R},{seq},1,"
             f"{d_state}) chunk {chunk} h_active {sorted(set(heads))}")
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, Bm, Cm)]
    y_d, _ = ssd_chunked(*leaves, chunk)
    dy = torch.randn(x.shape, generator=gen, device=device)
    shape += f" {k8_plan(x, Bm, Cm, chunk)}"
    for label, states in (("fwd", False), ("fwd+states", True)):
        row = dict(shape=f"{shape} {label}",
                   ms=cuda_ms(lambda: ssd_scan(
                       x, dt, A, Bm, Cm, chunk, h_active=hat,
                       return_states=states), device, iters, 1),
                   plain_ms=cuda_ms(lambda: ssd_scan_plain(
                       x, dt, A, Bm, Cm, chunk, hat, states), device, iters,
                       1),
                   library_ms=None)
        with torch.no_grad():
            row["dense_ms"] = cuda_ms(lambda: ssd_chunked(
                x, dt, A, Bm, Cm, chunk), device, iters, 1)
        work = ssd_work(R, seq, H, head_dim, 1, d_state, chunk, ha,
                        states=states)
        row["bound_ms"], row["bound_by"] = bound(*work)
        add_tc_bound(row, *work)
        out["ssd_scan"].append(row)
    _, st = ssd_scan(x, dt, A, Bm, Cm, chunk, h_active=hat,
                     return_states=True)
    bplan, variants = k9_variants(x, Bm, Cm, st, dy, chunk)
    raw = {v: (lambda v=v: ssd_scan_bwd_raw(
        x, dt, A, Bm, Cm, st, dy, chunk, h_active=hat,
        **({} if v is None else {"variant": v}))) for v in variants}
    vjp = {v: (lambda v=v: ssd_scan_bwd(
        x, dt, A, Bm, Cm, st, dy, chunk, h_active=hat,
        **({} if v is None else {"variant": v}))) for v in variants}
    fns = {**{f"K9 {v}": f for v, f in raw.items()},
           **{f"ssd_scan_bwd {v}": f for v, f in vjp.items()}}
    turns = turns_ms(device, fns, iters, rounds)
    head = variants[0]
    row = dict(shape=f"{shape} bwd {bplan}",
               ms=turns[f"K9 {head}"]["median"],
               simt_ms=turns.get("K9 simt", {}).get("median"),
               vjp_ms=turns[f"ssd_scan_bwd {head}"]["median"],
               vjp_simt_ms=turns.get("ssd_scan_bwd simt", {}).get("median"),
               rounds=rounds, turns=turns,
               plain_ms=cuda_ms(lambda: ssd_scan_bwd_raw_plain(
                   x, dt, A, Bm, Cm, st, dy, chunk, hat), device, iters, 1),
               library_ms=None,
               dense_ms=cuda_ms(lambda: torch.autograd.grad(
                   y_d, leaves, dy, retain_graph=True), device, iters, 1))
    work = ssd_work(R, seq, H, head_dim, 1, d_state, chunk, ha,
                    backward=True)
    row["bound_ms"], row["bound_by"] = bound(*work)
    add_tc_bound(row, *work)
    row["device_split_ms"] = device_split_ms(raw[head], device)
    out["ssd_scan_bwd"].append(row)
    del x, dt, A, Bm, Cm, leaves, y_d, st, dy
    x, dt, A, Bm, Cm = _ssd_inputs(1, prompt_len, H, head_dim, 1, d_state,
                                   (0.01, 0.3), device, gen)
    chunk = min(chunk, prompt_len)   # a shorter prompt is one chunk
    row = dict(shape=f"prefill xh(1,{prompt_len},{H},{head_dim}) chunk "
                     f"{chunk} {k8_plan(x, Bm, Cm, chunk)}",
               ms=cuda_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk), device,
                          iters),
               plain_ms=cuda_ms(lambda: ssd_scan_plain(x, dt, A, Bm, Cm,
                                                       chunk), device,
                                iters),
               library_ms=None)
    with torch.no_grad():
        row["dense_ms"] = cuda_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm,
                                                      chunk), device, iters)
    work = ssd_work(1, prompt_len, H, head_dim, 1, d_state, chunk, None)
    row["bound_ms"], row["bound_by"] = bound(*work)
    add_tc_bound(row, *work)
    row["device_ms"] = device_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk),
                                 device)
    out["ssd_scan"].append(row)
    for name, rs in out.items():
        for r in rs:
            line = (f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, library — (none exists), "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            if "tc_bound_ms" in r:
                line += (f", 3xTF32 bound {r['tc_bound_ms']:.4f} ms "
                         f"({r['tc_bound_by']}); {r['tflops']:.1f} TFLOP/s")
            if r.get("device_ms") is not None:
                line += f"; device {r['device_ms']:.4f} ms"
            print(line + f"; dense masked path {r['dense_ms']:.4f} ms "
                  f"(information only)")
            if "turns" in r:             # K9 in turns
                print(f"    in turns (median [min, max] ms over "
                      f"{r['rounds']} rounds): " + "; ".join(
                          f"{k} {v['median']:.4f} [{v['min']:.4f}, "
                          f"{v['max']:.4f}]" for k, v in r["turns"].items()))
            if r.get("device_split_ms"):
                print("    device ms per call by kernel: " + "; ".join(
                    f"{k} {v:.4f}" for k, v in r["device_split_ms"].items()))
    return out


# ---------------------------------------------------------------------------
# phases 3d, 14a and 14: the paper's CNN, its stage convolutions on K1
# ---------------------------------------------------------------------------
# the CFL slice: the quickstart session on PAPER_CNN at its published width
# and depth, 8 clients of the synthetic CIFAR-10 stand-in with quality
# heterogeneity, 2 sync rounds (3 until phase 16 needed the time), the
# CFLConfig defaults otherwise (batch 32, lr 0.05, momentum 0.9, one local
# epoch)
CNN_SLICE = dict(kind="synthcifar", n_workers=8, n_samples=4000,
                 heterogeneity="quality", rounds=2, seed=0)
CNN_BATCH = 32
# the IL witness's budget (phase 14): the kernel path's recorded ReLU
# decisions replayed on the dense path in fp32 and fp64 over one round's
# local steps (the timed IL calls keep the slice's rounds); cut from the
# timed budget to make room for phase 20
IL_WITNESS_ROUNDS = 1
# the phase 3d / 14a cohort's width per client: channel prefixes 8 / 16 /
# 24 / 32 of stage 0, 16 ... 64 of stage 1, 32 ... 128 of stage 2, ragged
# and differing per client
CNN_WIDTHS = (0.25, 0.5, 0.75, 1.0, 1.0, 0.75, 0.5, 0.25)
CNN_CONVS_PER_FORWARD = 21      # 3 stages x (down + 3 blocks x 2 convs)


def cnn_convs(cfg):
    """The six conv shapes of the CNN's stages: (label, input side, stride,
    cin, cout, stage, convs of this shape in one forward, the stage whose
    prefix is the conv's input prefix — None for the stem's output, which
    every submodel keeps whole)."""
    out, size, cin = [], cfg.image_size, cfg.stem_channels
    for si, (c, n) in enumerate(cfg.stages):
        out.append((f"stage {si} down", size, 2, cin, c, si, 1,
                    si - 1 if si else None))
        size = -(-size // 2)
        out.append((f"stage {si} blocks", size, 1, c, c, si, 2 * n, si))
        cin = c
    return out


def cnn_cases(cfg, clients, batch):
    """(label, G, B, side, stride, cin, cout, cin prefixes, cout prefixes)
    for elastic_conv2d: the six stage shapes at the cohort's ragged
    prefixes (per client, differing), then the edges — prefix 0, full,
    None, 7×7 inputs at stride 2 and 1, prefixes that end inside an mma
    fragment."""
    from repro_torch.core.submodel import channels_of
    widths = CNN_WIDTHS[:clients]
    cases = []
    for label, side, s, cin, cout, si, _, psi in cnn_convs(cfg):
        co = [channels_of(cfg, si, w) for w in widths]
        ci = None if psi is None else [channels_of(cfg, psi, w)
                                       for w in widths]
        cases.append((f"{label} ragged", clients, batch, side, s, cin, cout,
                      ci, co))
    return cases + [
        ("prefix 0", 4, 4, 16, 1, 32, 32, [0, 32, 8, 0], [32, 0, 0, 8]),
        ("full", 2, 4, 16, 2, 32, 64, [32, 32], [64, 64]),
        ("None", 2, 4, 8, 1, 64, 64, None, None),
        ("7x7 stride 2", 3, 4, 7, 2, 16, 24, [16, 5, 9], [24, 7, 13]),
        ("7x7 stride 1", 3, 4, 7, 1, 24, 24, [24, 3, 0], [9, 24, 1]),
    ]


def _conv_inputs(G, B, side, cin, cout, device, gen):
    import torch
    x = torch.randn((G, B, side, side, cin), generator=gen, device=device)
    w = torch.randn((G, 3, 3, cin, cout), generator=gen, device=device) \
        / math.sqrt(9 * cin)
    b = torch.randn((G, cout), generator=gen, device=device)
    return x, w, b


def _grads(fn, leaves, dy):
    """fn's output and its gradients in ``leaves`` (fresh copies that
    require grad) for the cotangent dy."""
    import torch
    ts = [t.detach().clone().requires_grad_(True) for t in leaves]
    y = fn(*ts)
    return (y.detach(),) + torch.autograd.grad(y, ts, dy)


def _rel_max(got, want):
    """max |got − want| over max(1, max |want|): K1's fp32 tolerance holds
    for outputs O(1); a gradient summed over 8192 rows is O(100)."""
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def phase_cnn_kernels(device, cfg, clients, batch):
    """K1 against its plain version at the CNN's im2col products, and
    ``elastic_conv2d`` against ``elastic_conv2d_plain`` (a direct
    convolution under the same masks): forward, dx, dw and the per-group
    bias's gradient, each case twice and bit-equal, the plan's variant of
    each product printed; also K1 with the per-group bias bit-equal to K1
    without it plus the bias. Returns {"elastic_dense": worst error};
    raises PhaseError past ``K1_TOL``."""
    import torch
    from repro_torch.kernels.elastic_conv import (_im2col,
                                                  conv_weight_matrix,
                                                  elastic_conv2d,
                                                  elastic_conv2d_plain)
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    gen = torch.Generator(device=device).manual_seed(11)
    worst, failed = 0.0, []
    for label, G, B, side, s, cin, cout, ci, co in cnn_cases(cfg, clients,
                                                             batch):
        x, w, b = _conv_inputs(G, B, side, cin, cout, device, gen)
        cat = None if ci is None else _i32(ci, device)
        cot = None if co is None else _i32(co, device)
        pat, (_, oh, ow) = _im2col(x, 3, 3, s)
        wmat = conv_weight_matrix(w)
        ka = None if cat is None else _i32([9 * c for c in ci], device)
        dy = torch.randn((G, B, oh, ow, cout), generator=gen, device=device)
        dy2 = dy.reshape(G, -1, cout)
        conv = [lambda x, w, b, f=f: f(x, w, b, stride=s, cin_active=cat,
                                       cout_active=cot)
                for f in (elastic_conv2d, elastic_conv2d_plain)]
        prod = [lambda p, m, b, f=f: f(p, m, b, k_active=ka, n_active=cot)
                for f in (elastic_dense, elastic_dense_plain)]
        errs, stable, finite = [], True, True
        for (kern, plain), args, cot_ in ((conv, (x, w, b), dy),
                                          (prod, (pat, wmat, b), dy2)):
            got = _grads(kern, args, cot_)
            again = _grads(kern, args, cot_)
            want = _grads(plain, args, cot_)
            sync(device)
            stable &= all(torch.equal(a, c) for a, c in zip(got, again))
            finite &= all(bool(torch.isfinite(g).all()) for g in got)
            errs += [_rel_max(g, r) for g, r in zip(got, want)]
        # the per-group bias: K1 without a bias, plus the bias, bit for bit
        raw = elastic_dense(pat, wmat, None, k_active=ka, n_active=cot)
        with_b = elastic_dense(pat, wmat, b, k_active=ka, n_active=cot)
        live = torch.arange(cout, device=device)[None, None, :] < (
            cot[:, None, None] if cot is not None else cout)
        bias_ok = torch.equal(with_b, torch.where(
            live, raw + b[:, None, :], torch.zeros((), device=device)))
        err = max(errs)
        worst = max(worst, err)
        ok = err <= K1_TOL and stable and finite and bias_ok
        plans = [k1_variant(*a) for a in (
            (pat, wmat), (dy2, wmat.transpose(-1, -2)),
            (pat.transpose(-1, -2), dy2))]
        print(f"  elastic_conv2d {label:18s} x({G},{B},{side},{side},{cin}) "
              f"stride {s} cout {cout} cin_active {ci} cout_active {co}: "
              f"K1 ({G},{pat.shape[1]},{pat.shape[2]})@(.,.,{cout}) "
              f"fwd/dx/dw {'/'.join(plans)}; max rel err conv y/dx/dw/db "
              f"{'/'.join(f'{e:.2e}' for e in errs[:4])}, K1 "
              f"{'/'.join(f'{e:.2e}' for e in errs[4:])} tol {K1_TOL:g}; "
              f"twice bit-equal {stable}; bias bit-equal {bias_ok} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"elastic_conv2d {label}")
    if failed:
        raise PhaseError(f"CNN convolutions disagree with their plain "
                         f"versions: {failed}")
    return {"elastic_dense": worst}


def phase_cnn_times(device, cfg, clients, batch, steps, iters=5):
    """Per CNN conv shape (full prefixes): K1's ms, its plain version's and
    ``torch.matmul``'s on the same im2col product, for the forward, dx and
    dw products; for the whole conv also ``models.cnn.conv2d`` (one grouped
    ``F.conv2d``, cuDNN, TF32 off — the dense path's, never the kernel
    path's), the im2col's own ms, ``elastic_conv2d``'s forward (B2: im2col
    + K1) and its plain version beside the whole conv's fp32 bound; the
    fp32 and 3×TF32 bounds, the launches per round (``steps`` local steps
    and one eval pass) and the plan's variant. Returns {"elastic_dense": [row, ...]}."""
    import torch
    from repro_torch.kernels.elastic_conv import (_im2col,
                                                  conv_weight_matrix,
                                                  elastic_conv2d,
                                                  elastic_conv2d_plain)
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    from repro_torch.models.cnn import conv2d
    gen = torch.Generator(device=device).manual_seed(12)
    rows = []
    for label, side, s, cin, cout, _, n_convs, _ in cnn_convs(cfg):
        x, w, b = _conv_inputs(clients, batch, side, cin, cout, device, gen)
        pat, _ = _im2col(x, 3, 3, s)
        wmat = conv_weight_matrix(w)
        G, M, K = pat.shape
        N = cout
        dy = torch.randn((G, M, N), generator=gen, device=device)
        for kind, a, c, bias, per_round in (
                ("fwd", pat, wmat, b, n_convs * (steps + 1)),
                ("dx", dy, wmat.transpose(-1, -2), None, n_convs * steps),
                ("dw", pat.transpose(-1, -2), dy, None, n_convs * steps)):
            Mx, Kx = a.shape[1], a.shape[2]
            Nx = c.shape[-1]
            row = dict(
                shape=f"cnn {label} {kind} ({G},{Mx},{Kx})@({G},{Kx},{Nx}) "
                      f"{k1_variant(a, c)}",
                ms=cuda_ms(lambda: elastic_dense(a, c, bias), device, iters,
                           1),
                plain_ms=cuda_ms(lambda: elastic_dense_plain(a, c, bias),
                                 device, iters, 1),
                library_ms=cuda_ms(lambda: torch.matmul(a, c), device,
                                   iters, 1),
                launches_per_round=per_round)
            if kind == "fwd":
                row["conv_library_ms"] = cuda_ms(
                    lambda: conv2d(x, w, b, s), device, iters, 1)
                row["im2col_ms"] = cuda_ms(lambda: _im2col(x, 3, 3, s),
                                           device, iters, 1)
                # B2, the whole conv as the kernel path runs it
                # (``elastic_conv2d``: im2col, then K1) and its plain
                # version, beside the conv's own bound: x, w and b read
                # once, y written once, 2·9·cin·cout operations an output
                row["conv_ms"] = cuda_ms(
                    lambda: elastic_conv2d(x, w, b, stride=s), device,
                    iters, 1)
                row["conv_plain_ms"] = cuda_ms(
                    lambda: elastic_conv2d_plain(x, w, b, stride=s), device,
                    iters, 1)
                conv_bytes = 4.0 * G * (x[0].numel() + w[0].numel()
                                        + N + Mx * N)
                row["conv_bound_ms"], row["conv_bound_by"] = bound(
                    conv_bytes, 2.0 * G * Mx * Kx * N)
            nbytes = 4.0 * G * (Mx * Kx + Kx * Nx + Mx * Nx
                                + (Nx if bias is not None else 0))
            ops = 2.0 * G * Mx * Kx * Nx
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
            add_tc_bound(row, nbytes, ops)
            rows.append(row)
        del x, w, b, pat, wmat, dy
    for r in rows:
        extra = "" if "conv_library_ms" not in r else (
            f"; whole conv: F.conv2d (cuDNN, TF32 off) "
            f"{r['conv_library_ms']:.4f} ms, im2col {r['im2col_ms']:.4f} ms,"
            f" elastic_conv2d (im2col + K1) {r['conv_ms']:.4f} ms, its "
            f"plain version {r['conv_plain_ms']:.4f} ms, the conv's bound "
            f"{r['conv_bound_ms']:.4f} ms ({r['conv_bound_by']})")
        print(f"  elastic_dense {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), 3xTF32 "
              f"bound {r['tc_bound_ms']:.4f} ms ({r['tc_bound_by']}); "
              f"{r['tflops']:.2f} TFLOP/s, {r['tb_per_s']:.3f} TB/s; "
              f"{r['launches_per_round']} launches a round{extra}")
    return {"elastic_dense": rows}


def cnn_specs(genes):
    """The SubmodelSpecs of a history entry's genes."""
    from repro_torch.core.submodel import SubmodelSpec
    return [SubmodelSpec(tuple(g[:len(g) // 2]),
                         tuple(v / 100 for v in g[len(g) // 2:]))
            for g in genes]


def cnn_eval_losses(fam, specs, test, params, backend, device):
    """Per-client test CE of one parent, each client through its own
    submodel's masks, on ``backend``'s path."""
    import torch
    from repro_torch.fl.engine import pack_eval
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.optim.optimizers import tree_map
    G = len(specs)
    pack = pack_eval(test)
    stacked = tree_map(lambda a: a.expand((G,) + a.shape), params)
    with torch.no_grad():
        ce = fam.masked_loss(
            stacked, fam.cohort_masks(specs, device).fwd,
            torch.as_tensor(pack.x, device=device),
            torch.as_tensor(pack.y, device=device),
            torch.as_tensor(pack.valid, device=device),
            kernels=kernel_dispatch(backend).table("cnn"))
    return ce.cpu().numpy()


def cnn_design_launches(steps, per_forward=CNN_CONVS_PER_FORWARD):
    """K1 launches the design gives for rounds of ``steps`` local steps
    (every client stepping) and one eval pass each: ``per_forward`` (21)
    stage convs a forward; a step's backward adds dx and dw of each (the
    per-group bias's gradient is a column sum, no launch); the eval pass
    is one forward. The stem is ``F.conv2d``, one call a forward."""
    return {"elastic_dense": sum(per_forward * (3 * n + 1) for n in steps),
            "F.conv2d": sum(n + 1 for n in steps)}


def relu_decisions():
    """The CNN's ReLU record / count / replay (``ReluDecisions`` of
    ``tests/relu_replay.py``, the test support the CPU session tests use
    too); a record that does not fit raises PhaseError."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from relu_replay import ReluDecisions
    return ReluDecisions(error=PhaseError)


def named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a parameter tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def first_difference(a, b):
    """None where two parameter trees are equal to the bit, else (the
    first leaf that differs, its max |a − b|, the number of leaves that
    differ)."""
    import torch
    diff = [(n, float((x - y).abs().max())) for (n, x), (_, y) in
            zip(named_leaves(a), named_leaves(b)) if not torch.equal(x, y)]
    return (diff[0][0], diff[0][1], len(diff)) if diff else None


def move_ratio(got, want, init):
    """(max |got − want| over max |want − init|, the two maxima)."""
    moved = max(float((w - i).abs().max()) for w, i in zip(_leaves(want),
                                                          _leaves(init)))
    diff = max(float((g - w).abs().max()) for g, w in zip(_leaves(got),
                                                         _leaves(want)))
    return diff / moved, diff, moved


ULP_FLOOR = 2                   # phase 15's parameter holds: fp32 ulps of
                               # |p| below which two rounds cannot differ
                               # measurably (each local step rounds the
                               # parameters to fp32 at their magnitude)


def ulp_floored(got, want, ulps=ULP_FLOOR):
    """(max over elements of |got − want| less ``ulps`` ulps of the larger
    magnitude, floored at 0; the largest |got − want| and its size in ulps
    of its element's magnitude). Two runs that round the same parameter at
    magnitude |p| differ by about an ulp of |p| per rounding, whatever
    their updates: the first number is the part of the difference above
    that floor, the one a 1e-3-of-the-movement hold can resolve."""
    import torch
    excess, worst = 0.0, (0.0, 0.0)
    for g, w in zip(_leaves(got), _leaves(want)):
        a = torch.maximum(g.abs(), w.abs())
        ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
        d = (g - w).abs()
        excess = max(excess, float((d - ulps * ulp).clamp_min(0).max()))
        i = int(torch.argmax(d))
        if float(d.flatten()[i]) > worst[0]:
            worst = (float(d.flatten()[i]),
                     float(d.flatten()[i] / ulp.flatten()[i]))
        del a, ulp, d
    return excess, worst[0], worst[1]


class CnnCounters:
    """K1's launches (by plan variant) and the library convolutions
    (``F.conv2d`` calls) of one path's run: every count set to 0 on entry
    and read on exit."""

    def __init__(self):
        import torch.nn.functional as F
        from repro_torch.kernels.elastic_matmul import elastic_dense
        self._F, self._k1, self._real = F, elastic_dense, F.conv2d

    def __enter__(self):
        reset_launches((self._k1,))
        self.conv_calls = 0

        def counting(*a, **k):
            self.conv_calls += 1
            return self._real(*a, **k)
        self._F.conv2d = counting
        return self

    def __exit__(self, *exc):
        self._F.conv2d = self._real
        self.launches = self._k1.launches
        self.by_variant = dict(self._k1.launches_by_variant)


class KeptTrained:
    """While entered, keeps a copy of the client-stacked parameters every
    ``BatchedRoundEngine.eval_cohort`` call is given: IL's trained
    clients (``independent_learning`` evaluates them once, at the end)."""

    def __init__(self):
        from repro_torch.fl.engine import BatchedRoundEngine
        self._cls, self._real = BatchedRoundEngine, \
            BatchedRoundEngine.eval_cohort
        self.trees = []

    def __enter__(self):
        from repro_torch.optim.optimizers import tree_map
        real, trees = self._real, self.trees

        def keep(engine, params_stacked, *a, **k):
            trees.append(tree_map(lambda t: t.detach().clone(),
                                  params_stacked))
            return real(engine, params_stacked, *a, **k)
        self._cls.eval_cohort = keep
        return self

    def __exit__(self, *exc):
        self._cls.eval_cohort = self._real


def cnn_seq_conv_calls(cfg, specs, n_steps):
    """``F.conv2d`` calls of a sequential round: each client's submodel
    forward (the stem, each stage's down conv and two a kept block) once
    a local step and once in its eval pass; the backward calls none."""
    return sum((n + 1) * (1 + sum(1 + 2 * d for d in s.depth))
               for s, n in zip(specs, n_steps))


def phase_cnn(device, *, kind, n_workers, n_samples, heterogeneity, rounds,
              seed, cfg=None):
    """The paper's three algorithms on ``cfg`` (``PAPER_CNN``): sessions of
    ``CFLSession.from_synthetic(cfg, ...)`` with ``algorithm`` "cfl",
    "fedavg" and "il", each on the kernel path (``elastic_kernels=True``)
    and on the dense masked path, and the CFL session on the sequential
    trainer (``batched_rounds=False``).

    Timing (each run free-running, with neither a ReLU record nor a
    count): cfl and fedavg ``rounds`` timed rounds of a fresh session after
    an untimed warm-up round of another. IL and the sequential trainer run
    untimed, to leave the script's time budget to phase 21: IL one
    free-running call at the witness's budget, the sequential server its
    round-0 specs drawn untrained, held equal to the batched round's, and
    each client's first step. The counts of
    K1's launches and of the library convolutions are set to 0 just before
    each free-running run and read just after it: K1 must launch 21 ×
    (3 · steps + 1) a round on cfl / fedavg, 21 × 3 · steps · rounds + 21
    on il, every launch through a tensor-core variant, and ``F.conv2d``
    only for the stem; the sequential path launches no K1 and calls
    ``F.conv2d`` once a conv of each submodel forward.

    The held comparisons run in separate, untimed sessions with the same
    seeds: the kernel path records its ReLU decisions
    (``relu_replay.ReluDecisions``), the dense path replays them. cfl (3
    rounds): round-0 specs identical, round-0 parameters within 1e-3 of
    the round's movement, each client's test CE within ``TRAIN_LOSS_RTOL``,
    accuracies within one test sample, later specs identical while the
    earlier accuracies are; fedavg (1 round): the same parameter, CE and
    accuracy checks; il (``IL_WITNESS_ROUNDS``' budget): the dense path
    replays the decisions in fp32 and in fp64, the witness of what they
    give without fp32 rounding; the kernel path's trained clients within
    ``IL_PARAM_TOL`` of their movement of the witness's and its
    accuracies within one test sample of the witness's (the fp32 dense
    path's drift from the witness printed). The sequential
    trainer is held to the batched dense engine on each client's first
    local step (a one-batch, one-epoch ``run_fl_round`` on both, the
    round-0 specs, seeds and parameters) in fp64, within 1e-3 of the
    step's movement and accuracies within one test sample (in fp32 a ReLU
    flip on rounding noise can move a step by more: printed, not held).
    Repeatability: the timed kernel runs' round-0 parameters of cfl and
    fedavg equal the record runs' to the bit. Printed, not held: the
    free-running dense path against the kernel path (ReLU decisions that
    differ per forward, the parameter ratio), the sequential round against
    the batched dense round, and Table II (CFL / FedAvg / IL). Returns
    ({path: K1 launches}, stats)."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core.fairness import accuracy_fairness
    from repro_torch.fl.baselines import independent_learning
    from repro_torch.fl.engine import (BatchedRoundEngine,
                                       SequentialFamilyTrainer,
                                       n_stream_steps)
    from repro_torch.fl.server import CFLConfig
    from repro_torch.fl.session import CFLSession
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = PAPER_CNN if cfg is None else cfg
    cuda = device.type == "cuda"
    relus = relu_decisions()
    convs = 1 + sum(1 + 2 * n for _, n in cfg.stages)
    k1_per_forward = convs - 1           # the stage convs; the stem is F's
    per_forward = convs                  # one F.relu after each conv's norm

    def snapshot(params):
        return tree_map(lambda a: a.clone(), params)

    def make(algorithm, ek, batched=True):
        t = time.perf_counter()
        sess = CFLSession.from_synthetic(
            cfg, kind=kind, n_workers=n_workers, n_samples=n_samples,
            heterogeneity=heterogeneity, seed=seed, device=device,
            algorithm=algorithm,
            fl_cfg=CFLConfig(n_workers=n_workers, elastic_kernels=ek,
                             batched_rounds=batched, seed=seed))
        return sess, time.perf_counter() - t

    def timed(algorithm, ek, n, batched=True):
        """An untimed warm-up round of its own session, then ``n`` timed
        free-running rounds of a fresh one, counted."""
        warm, _ = make(algorithm, ek, batched)
        warm.run(1)
        del warm
        sess, build_s = make(algorithm, ek, batched)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        out = []
        with CnnCounters() as count:
            for r in range(n):
                sync(device)
                t = time.perf_counter()
                rec = sess.server.run_round()
                sync(device)
                out.append(dict(rec=rec, seconds=time.perf_counter() - t,
                                params=snapshot(sess.params) if r == 0
                                else None))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        return sess, out, dict(build_s=build_s, peak=peak,
                               launches=count.launches,
                               by_variant=count.by_variant,
                               conv_calls=count.conv_calls)

    def held(algorithm, ek, n, mode):
        """``n`` untimed rounds of a fresh session under the ReLU record's
        ``mode`` (a count covers round 0 only)."""
        sess, _ = make(algorithm, ek)
        out = []
        with relus(mode):
            for r in range(n):
                if r == 1 and mode == "count":
                    relus.mode = "off"
                rec = sess.server.run_round()
                out.append(dict(rec=rec, params=snapshot(sess.params)
                                if r == 0 else None))
        return sess, out

    def il_call(ek, mode=None, kept=None, n=rounds):
        """One IL call of ``n`` rounds' local budget on a fresh session:
        timed and counted when free-running; ``kept`` keeps its trained
        clients."""
        sess, _ = make("il", ek)
        with CnnCounters() as count, (relus(mode) if mode
                                      else contextlib.nullcontext()), \
                (kept or contextlib.nullcontext()):
            sync(device)
            t = time.perf_counter()
            sess.run(n)
            sync(device)
        return sess, time.perf_counter() - t, count

    def replayed_il():
        """IL at ``IL_WITNESS_ROUNDS`` rounds' budget on one set of ReLU
        decisions: the kernel path records them, the dense path replays
        them in fp32 and in fp64 (the witness: what those decisions give
        with fp32 rounding taken out). Returns ({pair: ratio of the trained
        clients' difference to their movement}, {pair: accuracy
        differences in test samples}, the kernel path's session, the dense
        path's session)."""
        kept = KeptTrained()
        il_r, _, _ = il_call(True, "record", kept, IL_WITNESS_ROUNDS)
        il_p, _, _ = il_call(False, "replay", kept, IL_WITNESS_ROUNDS)
        replayed = [relus.pos]

        def wide(ds):
            return [dict(d, x=d["x"].astype(np.float64)) for d in ds]
        with relus("replay"), kept:
            accs64 = independent_learning(
                il_r.family, tree_map(lambda a: a.double(),
                                      il_r._init_params),
                il_r.clients, wide(il_r.client_data), wide(il_r.test_data),
                rounds=IL_WITNESS_ROUNDS, fl_cfg=dataclasses.replace(
                    il_r.fl, elastic_kernels=False), device=device)
        replayed.append(relus.pos)
        if replayed != [len(relus.masks)] * 2:
            problems.append(f"il: the replays took {replayed} of "
                            f"{len(relus.masks)} recorded ReLU calls")
        relus.masks.clear()
        paths = dict(zip(("kernel", "dense", "dense fp64"), kept.trees))
        accs = {"kernel": il_r.il_accs, "dense": il_p.il_accs,
                "dense fp64": accs64}
        pairs = (("kernel", "dense"), ("kernel", "dense fp64"),
                 ("dense", "dense fp64"))
        ratios = {f"{a} - {b}": move_ratio(paths[a], paths[b],
                                            il_r._init_params)[0]
                  for a, b in pairs}
        acc_diff = {f"{a} - {b}": [round((x - y) * n, 1) for x, y, n in
                                   zip(accs[a], accs[b], n_test)]
                    for a, b in pairs}
        return ratios, acc_diff, il_r, il_p

    problems = []

    def check_launches(label, info, want_k1, want_conv):
        tc = sum(info["by_variant"].get(v, 0) for v in ("tile", "skinny"))
        print(f"  {label}: elastic_dense {info['launches']} launches "
              f"(design {want_k1}), by variant {info['by_variant']}; "
              f"F.conv2d {info['conv_calls']} calls (design {want_conv})")
        if info["launches"] != want_k1:
            problems.append(f"{label}: elastic_dense launched "
                            f"{info['launches']} times, design {want_k1}")
        if tc != info["launches"]:
            problems.append(f"{label}: elastic_dense launches by variant "
                            f"{info['by_variant']}: not all through the "
                            f"tensor-core variants")
        if info["conv_calls"] != want_conv:
            problems.append(f"{label}: {info['conv_calls']} library "
                            f"convolutions, design {want_conv}")

    def repeat_check(label, a, b):
        d = first_difference(a, b)
        print(f"  {label}: round-0 parameters of the timed run and the "
              f"record run " + ("equal to the bit" if d is None else
                                f"DIFFER: first at {d[0]} by {d[1]:.3e} "
                                f"({d[2]} leaves differ)"))
        if d is not None:
            problems.append(f"{label}: the kernel path does not repeat to "
                            f"the bit (first at {d[0]})")
        return d is None

    def ce(sess, specs, params, backend, mode=None):
        with relus(mode) if mode else contextlib.nullcontext():
            return cnn_eval_losses(sess.family, specs, sess.test_data,
                                   params, backend, device)

    t0 = time.perf_counter()
    # ---- CFL: timed free-running, then record / count / replay -----------
    kern_sess, kern, kinfo = timed("cfl", True, rounds)
    dense_sess, dense, dinfo = timed("cfl", False, rounds)
    rec_sess, record = held("cfl", True, rounds, "record")
    recorded = len(relus.masks)
    _, counted = held("cfl", False, 1, "count")
    flips, decisions = relus.flips(), relus.decisions
    flips_by_forward = relus.flips(per_forward)
    _, replay = held("cfl", False, rounds, "replay")
    replayed = relus.pos
    relus.masks.clear()
    fam = kern_sess.family
    clients = kern_sess.clients
    n_test = [len(d["y"]) for d in kern_sess.test_data]
    n_params = sum(t.numel() for t in tree_leaves(kern_sess.params))
    print(f"  {cfg.name}: {n_params / 1e6:.3f} M params fp32, "
          f"{n_workers} clients ({kind}, {heterogeneity}: qualities "
          f"{[c.quality for c in clients]}, devices "
          f"{[c.device for c in clients]}), train / test samples "
          f"{[c.n_samples for c in clients]} / {n_test}, batch "
          f"{CNN_BATCH}; session build (population + LUT + init) "
          f"{kinfo['build_s']:.2f} s, LUT {len(kern_sess.server.latency)} "
          f"entries built in {kern_sess.server.lut_seconds:.3f} s (host)")
    steps = [max(o["rec"]["n_steps"]) for o in kern]
    want = cnn_design_launches(steps, k1_per_forward)
    check_launches("cfl, kernel path", kinfo, want["elastic_dense"],
                   want["F.conv2d"])
    cfl_repeat = repeat_check("cfl, kernel path", kern[0]["params"],
                              record[0]["params"])
    print(f"  ReLU decisions: {recorded} F.relu calls recorded on the kernel "
          f"path ({rounds} rounds), {replayed} replayed by the dense path; "
          f"in round 0 the free-running dense path takes {flips} of "
          f"{decisions} decisions ({flips / max(decisions, 1):.3e}) the "
          f"other way; by forward (the local steps, then the eval pass) "
          f"{flips_by_forward}")
    if replayed != recorded:
        problems.append(f"the replay took {replayed} of {recorded} recorded "
                        f"ReLU calls")
    per_round = []
    equal_so_far = True
    for r, (a, b, c, d) in enumerate(zip(kern, dense, record, replay)):
        ra, rb, rc, rd = a["rec"], b["rec"], c["rec"], d["rec"]
        hs = ra["host_seconds"]
        images = sum(ra["n_steps"]) * CNN_BATCH
        same_specs = rc["specs"] == rd["specs"]
        acc_diff = [x - y for x, y in zip(rc["accs"], rd["accs"])]
        free_diff = [x - y for x, y in zip(ra["accs"], rb["accs"])]
        print(f"  cfl round {r}: kernel path {a['seconds']:.3f} s "
              f"({images / a['seconds']:.0f} train images/s), dense path "
              f"{b['seconds']:.3f} s ({images / b['seconds']:.0f} images/s)"
              f", both free-running; host s (kernel path) "
              f"{json.dumps({k: round(v, 4) for k, v in hs.items()})}"
              f"; predictor MAE {ra['predictor_mae']:.4f}; fairness mean / "
              f"min / std {ra['fairness']['mean']:.4f} / "
              f"{ra['fairness']['min']:.4f} / {ra['fairness']['std']:.4f} "
              f"(dense {rb['fairness']['mean']:.4f} / "
              f"{rb['fairness']['min']:.4f} / {rb['fairness']['std']:.4f}); "
              f"record / replay specs "
              f"{'identical' if same_specs else 'DIFFER'} {rc['specs']} "
              f"(free-running: "
              f"{'identical' if ra['specs'] == rb['specs'] else 'differ'})")
        if r == 0 or equal_so_far:
            if not same_specs:
                problems.append(f"cfl round {r}: the paths' specs differ "
                                f"({rc['specs']} / {rd['specs']})")
        else:
            print(f"  cfl round {r}: specs not held (an earlier round's "
                  f"accuracies differed), only finiteness")
        for k, (dd, fd, n) in enumerate(zip(acc_diff, free_diff, n_test)):
            if dd != 0.0 or fd != 0.0:
                print(f"  cfl round {r}: client {k} accuracy kernel - dense "
                      f"{fd * n:+.1f} test samples (free-running), "
                      f"{dd * n:+.1f} (the kernel path's ReLUs)")
        if r == 0 and max(abs(x) * n for x, n in zip(acc_diff, n_test)) \
                > 1.0 + 1e-4:
            problems.append(f"cfl round 0: an accuracy differs by more than "
                            f"one test sample: {acc_diff}")
        for name, rec in (("kernel", ra), ("dense", rb), ("record", rc),
                          ("replay", rd)):
            if not np.isfinite(rec["accs"]).all():
                problems.append(f"cfl round {r}: non-finite accuracy "
                                f"({name})")
        equal_so_far &= acc_diff == [0.0] * len(acc_diff)
        per_round.append(dict(
            seconds=a["seconds"], dense_seconds=b["seconds"],
            train_images=images, images_per_s=images / a["seconds"],
            dense_images_per_s=images / b["seconds"],
            host_seconds=ra["host_seconds"],
            dense_host_seconds=rb["host_seconds"],
            predictor_mae=ra["predictor_mae"],
            dense_predictor_mae=rb["predictor_mae"],
            fairness=ra["fairness"], dense_fairness=rb["fairness"],
            accs=ra["accs"], dense_accs=rb["accs"],
            record_accs=rc["accs"], replayed_accs=rd["accs"],
            specs=ra["specs"], specs_identical=same_specs,
            free_specs_identical=ra["specs"] == rb["specs"]))
    for name, s in (("kernel", kern_sess), ("dense", dense_sess)):
        if not all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(s.params)):
            problems.append(f"cfl: non-finite parameters on the {name} "
                            f"path")
    init = fam.init_params(seed=seed, device=device)
    ratios = {}
    for name, got, ref, is_held in (
            ("dense (free-running)", dense[0]["params"], kern[0]["params"],
             False),
            ("dense on the kernel path's ReLUs", replay[0]["params"],
             record[0]["params"], True)):
        ratio, diff, moved = move_ratio(got, ref, init)
        ratios[name] = ratio
        print(f"  cfl round-0 parameters: max|kernel - {name}| {diff:.3e}, "
              f"max|kernel - initial| {moved:.3e}, ratio {ratio:.3e} "
              + ("(tol 1e-3)" if is_held else "(not held: ReLUs differ)"))
        if is_held and not ratio <= 1e-3:
            problems.append(f"cfl round-0 parameters differ by {ratio:.3e} "
                            f"of the movement > 1e-3")
    specs0 = cnn_specs(record[0]["rec"]["specs"])
    ce_k = ce(rec_sess, specs0, record[0]["params"], "auto", "record")
    loss = {"kernel": ce_k,
            "dense, kernel ReLUs": ce(rec_sess, specs0, replay[0]["params"],
                                      None, "replay")}
    relus.masks.clear()
    loss["dense"] = ce(rec_sess, specs0, dense[0]["params"], None)
    worst_loss = {k: float(np.max(np.abs(ce_k - v) / np.abs(v)))
                  for k, v in loss.items() if k != "kernel"}
    print(f"  cfl round-0 test CE per client: "
          + "; ".join(f"{k} {np.round(v, 6).tolist()}"
                      for k, v in loss.items())
          + f"; max relative difference {json.dumps(worst_loss)} (tol "
          f"{TRAIN_LOSS_RTOL:g} on the kernel path's ReLUs)")
    if not (np.isfinite(ce_k).all() and worst_loss["dense, kernel ReLUs"]
            <= TRAIN_LOSS_RTOL):
        problems.append(f"cfl round-0 test CE differs by "
                        f"{worst_loss['dense, kernel ReLUs']:.3e}")
    print(f"  peak device memory (cfl timed rounds) kernel path "
          f"{kinfo['peak'] / 2**30:.3f} GiB, dense "
          f"{dinfo['peak'] / 2**30:.3f} GiB")
    cfl_s = time.perf_counter() - t0

    # ---- FedAvg ----------------------------------------------------------
    t1 = time.perf_counter()
    fk_sess, fkern, fkinfo = timed("fedavg", True, rounds)
    fd_sess, fdense, fdinfo = timed("fedavg", False, rounds)
    frec_sess, frecord = held("fedavg", True, 1, "record")
    _, freplay = held("fedavg", False, 1, "replay")
    freplayed, frecorded = relus.pos, len(relus.masks)
    relus.masks.clear()
    fsteps = [max(o["rec"]["n_steps"]) for o in fkern]
    fwant = cnn_design_launches(fsteps, k1_per_forward)
    check_launches("fedavg, kernel path", fkinfo, fwant["elastic_dense"],
                   fwant["F.conv2d"])
    fed_repeat = repeat_check("fedavg, kernel path", fkern[0]["params"],
                              frecord[0]["params"])
    if freplayed != frecorded:
        problems.append(f"fedavg: the replay took {freplayed} of "
                        f"{frecorded} recorded ReLU calls")
    fratio, fdiff, fmoved = move_ratio(freplay[0]["params"],
                                       frecord[0]["params"], init)
    ffree, _, _ = move_ratio(fdense[0]["params"], fkern[0]["params"], init)
    full = [fam.full_spec()] * n_workers
    fce_k = ce(frec_sess, full, frecord[0]["params"], "auto", "record")
    fce_d = ce(frec_sess, full, freplay[0]["params"], None, "replay")
    relus.masks.clear()
    fce = float(np.max(np.abs(fce_k - fce_d) / np.abs(fce_d)))
    facc = [x - y for x, y in zip(frecord[0]["rec"]["accs"],
                                  freplay[0]["rec"]["accs"])]
    for r, (a, b) in enumerate(zip(fkern, fdense)):
        images = sum(a["rec"]["n_steps"]) * CNN_BATCH
        print(f"  fedavg round {r}: kernel path {a['seconds']:.3f} s "
              f"({images / a['seconds']:.0f} train images/s), dense path "
              f"{b['seconds']:.3f} s ({images / b['seconds']:.0f} images/s)"
              f"; accuracy mean / min {a['rec']['fairness']['mean']:.4f} / "
              f"{a['rec']['fairness']['min']:.4f} (dense "
              f"{b['rec']['fairness']['mean']:.4f} / "
              f"{b['rec']['fairness']['min']:.4f}); simulated round "
              f"{a['rec']['timing']['round_time']:.3f} s")
    print(f"  fedavg round-0 parameters: max|kernel - dense on the kernel "
          f"path's ReLUs| {fdiff:.3e}, movement {fmoved:.3e}, ratio "
          f"{fratio:.3e} (tol 1e-3); free-running ratio {ffree:.3e} (not "
          f"held); test CE kernel {np.round(fce_k, 6).tolist()}, max "
          f"relative difference {fce:.3e} (tol {TRAIN_LOSS_RTOL:g}); "
          f"accuracy differences "
          f"{[round(x * n, 1) for x, n in zip(facc, n_test)]} test "
          f"samples")
    if not fratio <= 1e-3:
        problems.append(f"fedavg round-0 parameters differ by {fratio:.3e} "
                        f"of the movement > 1e-3")
    if not (np.isfinite(fce_k).all() and fce <= TRAIN_LOSS_RTOL):
        problems.append(f"fedavg round-0 test CE differs by {fce:.3e}")
    if max(abs(x) * n for x, n in zip(facc, n_test)) > 1.0 + 1e-4:
        problems.append(f"fedavg round 0: an accuracy differs by more than "
                        f"one test sample: {facc}")
    fed_s = time.perf_counter() - t1

    # ---- IL --------------------------------------------------------------
    t1 = time.perf_counter()
    il_ratios, il_acc, il_k, il_d = replayed_il()
    # K1's launches from a free-running, untimed call at the same budget
    _, _, il_count = il_call(True, n=IL_WITNESS_ROUNDS)
    il_steps = max(n_stream_steps(c.n_samples, CNN_BATCH, 1)
                   for c in clients)
    il_want = k1_per_forward * (3 * il_steps * IL_WITNESS_ROUNDS + 1)
    check_launches("il, kernel path", dict(
        launches=il_count.launches, by_variant=il_count.by_variant,
        conv_calls=il_count.conv_calls), il_want,
        il_steps * IL_WITNESS_ROUNDS + 1)
    print(f"  il ({IL_WITNESS_ROUNDS} round's budget, {il_steps} local "
          f"steps; not timed): accuracies kernel "
          f"{np.round(il_k.il_accs, 4).tolist()}, dense on its ReLUs "
          f"{np.round(il_d.il_accs, 4).tolist()}")
    print(f"  il on the kernel path's ReLU decisions, trained clients: max "
          f"difference over movement "
          + json.dumps({k: float(f"{v:.3e}") for k, v in il_ratios.items()})
          + f" (kernel - dense fp64 tol {IL_PARAM_TOL:g}); accuracy "
          f"differences in test samples {json.dumps(il_acc)} (kernel - "
          f"dense fp64 tol 1)")
    if not il_ratios["kernel - dense fp64"] <= IL_PARAM_TOL:
        problems.append(f"il: on the kernel path's ReLUs the trained "
                        f"clients differ from the fp64 dense path's by "
                        f"{il_ratios['kernel - dense fp64']:.3e} of their "
                        f"movement > {IL_PARAM_TOL:g}")
    if max(abs(x) for x in il_acc["kernel - dense fp64"]) > 1.0 + 1e-4:
        problems.append(f"il: on the kernel path's ReLUs an accuracy "
                        f"differs from the fp64 dense path's by more than "
                        f"one test sample: {il_acc['kernel - dense fp64']}")
    if not (np.isfinite(il_k.il_accs).all()
            and np.isfinite(il_d.il_accs).all()):
        problems.append("il: non-finite accuracy")
    il_s = time.perf_counter() - t1

    # ---- the sequential trainer --------------------------------------------
    # (not timed: its first steps run on round 0's specs, drawn from its
    # own server untrained, which must be the batched round's)
    t1 = time.perf_counter()
    seq_sess, _ = make("cfl", False, batched=False)
    sserver = seq_sess.server
    sgenes = [sserver.family.genes(s) for s in sserver.cohort_specs(
        [int(i) for i in sserver.tracker.select(0).participants])]
    same0 = sgenes == dense[0]["rec"]["specs"]
    print(f"  cfl on the sequential trainer: round-0 specs "
          f"{'identical' if same0 else 'DIFFER'} to the batched round's")
    if not same0:
        problems.append("sequential: round-0 specs differ from the batched "
                        "round's")
    sspecs = cnn_specs(sgenes)
    first_steps = {}
    for dtype in (torch.float64, torch.float32):
        wide = np.float64 if dtype == torch.float64 else np.float32
        one = [dict(d, x=d["x"][:CNN_BATCH].astype(wide),
                    y=d["y"][:CNN_BATCH]) for d in seq_sess.client_data]
        tests = [dict(d, x=d["x"].astype(wide)) for d in seq_sess.test_data]
        p0 = tree_map(lambda a: a.to(dtype), init)
        kw = dict(batch_size=CNN_BATCH, epochs=1,
                  seeds=[seq_sess.server._client_seed(k)
                         for k in range(n_workers)])
        sizes = [CNN_BATCH] * n_workers
        with CnnCounters() as scount:
            got, accs_s, ssteps = SequentialFamilyTrainer(
                cfg, lr=seq_sess.fl.lr, momentum=seq_sess.fl.momentum
            ).run_fl_round(p0, sspecs, one, tests, sizes, **kw)
        if dtype == torch.float32:
            sinfo = dict(launches=scount.launches,
                         by_variant=scount.by_variant,
                         conv_calls=scount.conv_calls)
            check_launches("cfl, sequential trainer (one step a client)",
                           sinfo, 0, cnn_seq_conv_calls(cfg, sspecs, ssteps))
        with CnnCounters():
            want_p, accs_b, _ = BatchedRoundEngine(
                cfg, lr=seq_sess.fl.lr, momentum=seq_sess.fl.momentum,
                backend=None, device=device).run_fl_round(
                    p0, sspecs, one, tests, sizes, **kw)
        ratio, diff, moved = move_ratio(got, want_p, p0)
        worst = max(abs(x - y) * n for x, y, n in zip(accs_s, accs_b,
                                                       n_test))
        first_steps[str(dtype)] = dict(ratio=ratio, diff=diff, moved=moved,
                                       acc_diff_samples=worst)
        is_held = dtype == torch.float64
        print(f"  sequential vs batched dense, each client's first local "
              f"step ({dtype}): max diff {diff:.3e}, movement {moved:.3e}, "
              f"ratio {ratio:.3e} "
              + ("(tol 1e-3)" if is_held else "(not held: a ReLU on "
                 "rounding noise can flip)")
              + f"; accuracies differ by up to {worst:.1f} test samples"
              + (" (tol 1)" if is_held else ""))
        if is_held and not (ratio <= 1e-3 and worst <= 1.0 + 1e-4):
            problems.append(f"sequential: first local steps differ from the "
                            f"batched engine's by {ratio:.3e} of the "
                            f"movement, accuracies by {worst:.1f} samples")
    seq_s = time.perf_counter() - t1

    # ---- Table II ----------------------------------------------------------
    def med(xs):
        return float(np.median(xs))

    def summary(accs):
        f = accuracy_fairness(accs)
        return {k: f[k] for k in ("mean", "min", "std", "jain_index")}

    table = {}
    for name, k_runs, d_runs in (("CFL", kern, dense),
                                 ("FedAvg", fkern, fdense)):
        images = [sum(o["rec"]["n_steps"]) * CNN_BATCH for o in k_runs]
        table[name] = dict(
            round_s=med([o["seconds"] for o in k_runs]),
            dense_round_s=med([o["seconds"] for o in d_runs]),
            images_per_s=sum(images) / sum(o["seconds"] for o in k_runs),
            dense_images_per_s=sum(images) / sum(o["seconds"]
                                                 for o in d_runs),
            accs=summary(k_runs[-1]["rec"]["accs"]),
            dense_accs=summary(d_runs[-1]["rec"]["accs"]),
            simulated_round_s=med([o["rec"]["timing"]["round_time"]
                                   for o in k_runs]))
    table["IL"] = dict(
        round_s=None, dense_round_s=None, images_per_s=None,
        dense_images_per_s=None, accs=summary(il_k.il_accs),
        dense_accs=summary(il_d.il_accs), simulated_round_s=None)
    print(f"  Table II ({rounds} rounds, {n_workers} clients; "
          f"round s: median of the timed rounds; IL: not timed, its "
          f"accuracies at {IL_WITNESS_ROUNDS} round's budget, the dense "
          f"path on its ReLUs; accuracies after the last round; dense path "
          f"in brackets):")
    print("  algorithm | round s | train images/s | accuracy mean / min / "
          "std / Jain | simulated round s")
    def accs(a):
        return (f"{a['mean']:.4f} / {a['min']:.4f} / {a['std']:.4f} / "
                f"{a['jain_index']:.4f}")
    for name, row in table.items():
        sim = "—" if row["simulated_round_s"] is None \
            else f"{row['simulated_round_s']:.3f}"
        speed = "— | —" if row["round_s"] is None else (
            f"{row['round_s']:.3f} [{row['dense_round_s']:.3f}] | "
            f"{row['images_per_s']:.0f} [{row['dense_images_per_s']:.0f}]")
        print(f"  {name} | {speed} | {accs(row['accs'])} "
              f"[{accs(row['dense_accs'])}] | {sim}")
    phase_s = time.perf_counter() - t0
    print(f"  phase {phase_s:.1f} s (cfl {cfl_s:.1f}, fedavg {fed_s:.1f}, "
          f"il {il_s:.1f}, sequential {seq_s:.1f})")
    launches = {"cnn_training": {"elastic_dense": kinfo["launches"]},
                "cnn_fedavg": {"elastic_dense": fkinfo["launches"]},
                "cnn_il": {"elastic_dense": il_count.launches},
                "cnn_sequential": {"elastic_dense": sinfo["launches"]}}
    stats = {"rounds": per_round, "steps_per_round": steps,
             "launches_design": want,
             "launches_by_variant": {"elastic_dense": kinfo["by_variant"]},
             "library_conv_calls": kinfo["conv_calls"],
             "relu_calls": recorded, "relu_flips_round0": flips,
             "relu_decisions_round0": decisions,
             "relu_flips_round0_by_forward": flips_by_forward,
             "round0_param_diff_over_move": ratios,
             "round0_test_ce": {k: v.tolist() for k, v in loss.items()},
             "repeat_bit_equal": {"cfl": cfl_repeat, "fedavg": fed_repeat},
             "fedavg": dict(
                 launches=fkinfo["launches"], launches_design=fwant,
                 by_variant=fkinfo["by_variant"],
                 conv_calls=fkinfo["conv_calls"],
                 seconds=[o["seconds"] for o in fkern],
                 dense_seconds=[o["seconds"] for o in fdense],
                 round0_ratio=fratio, round0_free_ratio=ffree,
                 round0_test_ce_rel=fce),
             "il": dict(launches=il_count.launches, launches_design=il_want,
                        by_variant=il_count.by_variant,
                        budget_rounds=IL_WITNESS_ROUNDS,
                        accs=il_k.il_accs, dense_accs=il_d.il_accs,
                        replayed_param_ratios=il_ratios,
                        replayed_acc_diff_samples=il_acc),
             "sequential": dict(conv_calls=sinfo["conv_calls"],
                                specs_same_as_batched=same0,
                                first_steps=first_steps),
             "table_ii": table,
             "max_memory_allocated_gib": kinfo["peak"] / 2**30,
             "dense_max_memory_allocated_gib": dinfo["peak"] / 2**30,
             "session_build_s": kinfo["build_s"],
             "lut_build_s": kern_sess.server.lut_seconds,
             "lut_entries": len(kern_sess.server.latency),
             "phase_s": phase_s}
    if problems:
        raise PhaseError("; ".join(problems))
    if not cuda:
        return launches, stats
    stats["kernel_local_step"] = cnn_local_step(
        device, kern_sess, cnn_specs(kern[-1]["rec"]["specs"]), fk_sess)
    return launches, stats


def cnn_local_step(device, sess, specs, fed_sess, turns=1):
    """One local step of the kernel path's cohort (``specs``, the session's
    parameters): wall ms and ``torch.profiler``'s device ms and idle share
    with K1's share. Then what cuDNN's deterministic algorithms cost
    (``resolve_device`` turns them on): with them off and on in turn,
    ``turns`` times each, the step's wall ms, a round of ``fed_sess`` (a
    FedAvg kernel-path session: every round the same work) in seconds,
    and last the step's device ms (a finished profiler session slows the
    launches after it); medians, and each setting's step run twice from
    one state, bit-equal or the first leaf that differs."""
    import numpy as np
    import torch
    from repro_torch.fl.engine import pack_cohort_data
    from repro_torch.optim.optimizers import tree_map
    eng, fam = sess.server.engine, sess.family
    G = len(specs)
    theta0 = eng.broadcast_params(sess.params, G)
    params, opt_state = eng.local_state(theta0)
    masks = fam.cohort_masks(specs, device)
    xs, ys = pack_cohort_data(sess.client_data)
    x = torch.as_tensor(xs[:, :CNN_BATCH], device=device)
    y = torch.as_tensor(ys[:, :CNN_BATCH], device=device).long()
    sw = torch.ones((G, CNN_BATCH), device=device)

    def step():
        eng.local_step(params, opt_state, masks, x, sw, None, y)

    def fresh_step():
        p, o = eng.local_state(theta0)
        eng.local_step(p, o, masks, x, sw, None, y)
        return tree_map(lambda t: t.detach(), p)

    def fed_round():
        sync(device)
        t = time.perf_counter()
        fed_sess.server.run_round()
        sync(device)
        return time.perf_counter() - t

    def in_turns(runs, key, measure):
        for _ in range(turns):
            for flag in (False, True):
                torch.backends.cudnn.deterministic = flag
                runs[flag][key].append(measure())

    runs = {flag: {"wall_ms": [], "fedavg_round_s": [], "device_busy_ms": []}
            for flag in (False, True)}
    try:
        in_turns(runs, "wall_ms", lambda: step_wall_ms(step, device))
        in_turns(runs, "fedavg_round_s", fed_round)
        torch.backends.cudnn.deterministic = True
        wall = step_wall_ms(step, device)
        busy, top, by_name = step_device_ms(step, device)
        in_turns(runs, "device_busy_ms",
                 lambda: step_device_ms(step, device)[0])
        det = {}
        for flag in (False, True):
            torch.backends.cudnn.deterministic = flag
            d = first_difference(fresh_step(), fresh_step())
            med = {k: float(np.median(v)) for k, v in runs[flag].items()}
            det[str(flag)] = dict(
                bit_equal=d is None,
                first_difference=None if d is None else list(d),
                median=med, turns=runs[flag])
            print(f"  cudnn.deterministic={flag}: the step twice from one "
                  f"state " + ("bit-equal" if d is None else
                               f"DIFFERS: first at {d[0]} by {d[1]:.3e} "
                               f"({d[2]} leaves)")
                  + f"; medians of {turns} turns (off and on alternating) "
                  f"{json.dumps(med)}; turns "
                  + json.dumps({k: [round(x, 4) for x in v]
                                for k, v in runs[flag].items()}))
    finally:
        torch.backends.cudnn.deterministic = True
    k1 = sum(v for k, v in by_name.items()
             if any(f in k for f in KERNEL_FUNCTIONS["elastic_dense"]))
    prof = {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": None if busy is None
            else max(0.0, 1.0 - busy / wall),
            "elastic_dense_ms": k1,
            "elastic_dense_share": k1 / busy if busy else None,
            "top_kernels_ms": top, "cudnn_deterministic": det}
    print(f"  kernel path local step ({G} clients x {CNN_BATCH} images, "
          f"cuDNN deterministic): "
          + json.dumps({k: v for k, v in prof.items()
                        if k != "cudnn_deterministic"}))
    return prof


# ---------------------------------------------------------------------------
# phase 15: CFLSession on the transformer zoo
# ---------------------------------------------------------------------------
# the zoo sessions: CFLSession.from_synthetic(kind="synthlm") at each
# parent's published width, with phase 7's / 9's / 12's depth and sequence
# length; 32 samples over 4 clients give 8 train and 8 test sequences a
# client, 2 local steps of 4 sequences
ZOO = dict(n_workers=4, n_samples=32, heterogeneity="both", batch=4,
           lr=0.05, seed=0)
# (arch, depth, sequence length, timed CFL rounds, FedAvg / IL and a
# warm-up session too)
ZOO_PARENTS = (("granite-3-8b", TRAIN["n_layers"], TRAIN["seq_len"], 3,
                True),
               ("granite-moe-1b-a400m", MOE_TRAIN["n_layers"],
                MOE_TRAIN["seq_len"], 1, False),
               ("mamba2-2.7b", SSM_TRAIN["n_layers"], SSM_TRAIN["seq_len"],
                1, False))
SEQ_FP64_TOL = 1e-5            # a client's first step, sequential against
                               # batched dense, both in fp64, over its
                               # movement (the attention, norm statistics
                               # and router still round to fp32)
SEQ_FP32_TOL = 1e-3            # a round (MoE: a client's local training),
                               # both engines in fp32, over its movement


class RouteLog:
    """Top-k routes of ``models.moe.route``, in call order: ``record``
    logs every call's expert ids (with ``margins``, also each decision's
    top-k margin: the k-th probability less the next one); ``replay``
    feeds the logged ids back, to every call or to those ``use(call
    index)`` selects (each gated with its own probabilities, renormalised,
    as ``route`` does), and counts the token decisions whose expert sets
    differ from the call's own."""

    def __init__(self, margins=False):
        self.ids, self.margins = [], [] if margins else None
        self.mode = self.use = None
        self.pos = self.calls = self.differ = self.decisions = 0

    def __call__(self, mode, use=None):
        self.mode, self.use = mode, use
        self.pos = self.calls = self.differ = self.decisions = 0
        if mode == "record":
            self.ids = []
            if self.margins is not None:
                self.margins = []
        return self

    def __enter__(self):
        import torch
        from repro_torch.models import moe as moe_mod
        self._mod, real = moe_mod, moe_mod.route

        def hooked(router, xt, moe_cfg, expert_mask=None):
            out = real(router, xt, moe_cfg, expert_mask)
            c = self.calls
            self.calls += 1
            if self.mode == "record":
                self.ids.append(out[3].detach())
                if self.margins is not None:
                    top = torch.topk(out[1].detach(), moe_cfg.top_k + 1,
                                     dim=-1).values
                    self.margins.append(top[..., -2] - top[..., -1])
            elif self.use is None or self.use(c):
                idx = self.ids[self.pos]
                self.pos += 1
                own = torch.sort(out[3], -1).values
                self.differ += int((own != torch.sort(idx, -1).values)
                                   .any(-1).sum())
                self.decisions += own.shape[0] * own.shape[1]
                g = torch.gather(out[1], -1, idx)
                out = out[:2] + ((g / g.sum(-1, keepdim=True)).to(
                    xt.dtype), idx)
            return out
        self._real = real
        moe_mod.route = hooked
        return self

    def __exit__(self, *exc):
        self._mod.route = self._real


def zoo_session(device, fam, algorithm="cfl", ek=True, batched=True,
                seed=ZOO["seed"], selection=None,
                n_workers=ZOO["n_workers"]):
    """``CFLSession.from_synthetic`` of the zoo setting on ``fam``
    (``selection``: the policy, full participation by default), with
    ``n_workers`` clients of the same 8 train / 8 test sequences each."""
    from repro_torch.fl.server import CFLConfig
    from repro_torch.fl.session import CFLSession
    return CFLSession.from_synthetic(
        fam, kind="synthlm", n_workers=n_workers,
        n_samples=ZOO["n_samples"] * n_workers // ZOO["n_workers"],
        heterogeneity=ZOO["heterogeneity"],
        algorithm=algorithm, seed=seed, device=device, selection=selection,
        fl_cfg=CFLConfig(n_workers=n_workers,
                         batch_size=ZOO["batch"], local_epochs=1,
                         lr=ZOO["lr"], elastic_kernels=ek,
                         batched_rounds=batched, seed=seed))


def sequential_holds(device, fam, sess, specs, routes=None):
    """Each client of ``sess``'s round 0 on the sequential trainer against
    a one-client batched dense engine (a MoE parent's family sizing its
    capacity by the client's experts, as the extracted submodel does): the
    first local step in fp64 (a one-batch dataset through ``client_update``
    and ``train_cohort``) and the whole local training in fp32 (with
    ``routes``, a MoE parent's batched run replays the sequential run's
    routes on the kept layers). Returns ({client: (fp64 ratio, fp32
    ratio)}, routing decisions that differ)."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.core.elastic import TransformerElasticFamily
    from repro_torch.core.submodel import transformer_experts
    from repro_torch.data.loader import index_batches
    from repro_torch.fl.engine import (BatchedRoundEngine,
                                       SequentialFamilyTrainer)
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    cfg = fam.cfg
    # the MoE layers in the order a forward routes them
    moe_layers = [(si, l) for si, seg in enumerate(cfg.segments)
                  if seg.use_moe for l in range(seg.n_layers)]
    L = max(1, len(moe_layers))
    fl = sess.fl
    out, differ = {}, 0
    for k, spec in enumerate(specs):
        fam_k = fam
        if cfg.moe is not None:
            fam_k = TransformerElasticFamily(dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_experts=transformer_experts(
                        cfg, spec.expert_frac))), seq_len=fam.seq_len)
        seed = fl.seed * 7 + k                  # round 0's client seed
        data = sess.client_data[k]
        idx = next(index_batches(len(data["y"]), fl.batch_size, seed=seed))
        one = {"x": data["x"][idx], "y": data["y"][idx]}
        keep = {i for i, (si, l) in enumerate(moe_layers)
                if l in spec.layers[si]}
        ratios = []
        for dtype, d, log in ((torch.float64, one, None),
                              (torch.float32, data, routes)):
            p0 = tree_map(lambda a: a.to(dtype), sess._init_params)
            seq = SequentialFamilyTrainer(fam_k, lr=fl.lr,
                                          momentum=fl.momentum)
            eng = BatchedRoundEngine(fam_k, lr=fl.lr, momentum=fl.momentum,
                                     backend=None, device=device)
            kw = dict(batch_size=fl.batch_size, epochs=1)
            with (log("record") if log else contextlib.nullcontext()):
                delta, _, _, _ = seq.client_update(p0, spec, d, seed=seed,
                                                   **kw)
            padded = fam_k.pad_delta(delta, p0, spec)
            del delta, seq
            # the batched run holds ~6 parent copies at its peak: where the
            # card has no room for them beside the padded delta (a gemma2
            # pair's fp64 copy is 10.5 GB), the delta waits on the host
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(padded))
            if device.type == "cuda" and \
                    torch.cuda.mem_get_info(device)[0] < 6 * nbytes:
                padded = tree_map(lambda t: t.cpu(), padded)
            theta = eng.broadcast_params(p0, 1)
            del p0
            with (log("replay", use=lambda c: c % L in keep) if log
                  else contextlib.nullcontext()):
                res = eng.train_cohort(theta, [spec], [d], seeds=[seed],
                                       **kw)
            del theta
            if log:
                differ += log.differ
                if log.pos != len(log.ids):
                    raise PhaseError(f"client {k}: replayed {log.pos} of "
                                     f"{len(log.ids)} routes")
            moved = max(float(t[0].abs().max())
                        for t in tree_leaves(res.deltas))
            diff = max(float((a.to(b.device) - b[0]).abs().max())
                       for a, b in zip(tree_leaves(padded),
                                       tree_leaves(res.deltas)))
            ratios.append(diff / moved)
            del padded, res, eng
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out[k] = tuple(ratios)
    return out, differ


def phase_zoo(device, parents=ZOO_PARENTS, cfg_of=None, phase="15"):
    """``CFLSession`` on the transformer zoo (the reference's main entry
    point for it): for each parent of ``parents`` (name, depth — layers,
    or (segment, layers) pairs for ``cut_depth`` — sequence length, timed
    CFL rounds, FedAvg / IL / warm-up, and optionally the clients,
    ``ZOO["n_workers"]`` by default) at its published width, sessions of
    ``CFLSession.from_synthetic(fam, kind="synthlm", ...)``:

    * CFL on the kernel path, timed free-running after an untimed warm-up
      round of another session (the dense parent; the others run warm
      after phases 9 / 12): the counts of every kernel of the path are set
      to 0 just before and read just after, and must equal the design
      (``design_launches``) through the expected variants;
    * the dense masked path's round 0 from the same state (a fresh session,
      same seeds): the same specs, round-0 parameters within 1e-3 of the
      round's movement beyond ``ULP_FLOOR`` ulps of their magnitude
      (``ulp_floored``; the raw ratio printed beside it), each client's
      test CE within ``TRAIN_LOSS_RTOL``
      (MoE: the dense path replaying the routes of an untimed kernel run
      of round 0, which repeats the timed run's parameters to the bit);
    * the dense parent also FedAvg (1 round) and IL (1 round's budget) on
      the kernels, timed and counted;
    * one timed round on the sequential trainer (``batched_rounds=False``:
      no kernel launches), its round-0 parameters against the dense
      path's (held within ``SEQ_FP32_TOL`` beyond the same floor on the
      dense and SSM parents;
      printed on the MoE parent, whose masked path sizes capacity by all
      experts and the extracted submodel by its own), and every client
      held per ``sequential_holds``: fp64 first step within
      ``SEQ_FP64_TOL``, fp32 local training within ``SEQ_FP32_TOL``.

    ``cfg_of`` maps an arch name to its config (``get_config`` by default;
    a ``reduced`` config rehearses the phase on the CPU, where the launch
    checks fail by design). Returns ({run: launches}, stats)."""
    import contextlib
    import functools
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.models import moe as moe_lib
    from repro_torch.core.submodel import TransformerSubSpec
    from repro_torch.optim.optimizers import tree_map

    cuda = device.type == "cuda"
    problems, launches_out, stats = [], {}, {}
    t_phase = time.perf_counter()

    def snapshot(params):
        return tree_map(lambda a: a.clone(), params)

    def counted(label, cfg, fn, want, k5="tile"):
        """Run ``fn`` with every kernel counter of the path at 0; check the
        counts against ``want`` (None: no launch at all) and the variants
        (K5's ``k5``); return (fn's result, seconds, launches, by
        variant)."""
        counters = path_counters(cfg)
        reset_launches(counters)
        sync(device)
        t = time.perf_counter()
        res = fn()
        sync(device)
        secs = time.perf_counter() - t
        got = {c.__name__: c.launches for c in counters}
        launches_out[label] = got
        by = {}
        if want is None:
            if any(got.values()):
                problems.append(f"{label}: kernels launched {got}, design "
                                "none")
            print(f"  {label}: launches {got} (design: none)")
        else:
            print(f"  {label}: launches {got} (design: {want})")
            for name, n in got.items():
                if n != want[name]:
                    problems.append(f"{label}: {name} launched {n} times, "
                                    f"design {want[name]}")
            by = check_variants(got, problems, k5, "mma")
        return res, secs, got, by

    for name, n_layers, seq_len, rounds, baselines, *workers in parents:
        session = functools.partial(
            zoo_session, n_workers=workers[0] if workers else
            ZOO["n_workers"])
        fam = train_family((cfg_of or get_config)(name), n_layers, seq_len)
        cfg = fam.cfg
        moe = cfg.moe is not None
        st = stats[name] = {}
        label = "granite-moe" if name.startswith("granite-moe") \
            else name.split("-")[0]
        t_parent = time.perf_counter()
        if baselines:                       # untimed warm-up session round
            warm = session(device, fam)
            warm.run(1)
            del warm
            gc.collect()
        sess = session(device, fam)
        st["lut_build_s"] = sess.server.lut_seconds
        per = design_launches_of(cfg, 2, 1)
        # K5's plan streams the weights past products of at most
        # STREAM_ROWS rows: a parent whose expert capacity is that small
        # (deepseek's top 6 of 64) takes both tensor-core variants
        k5 = "tile"
        if moe and moe_lib.capacity(ZOO["batch"] * seq_len, cfg.moe) \
                <= gmm.STREAM_ROWS:
            k5 = ("tile", "stream")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        kern, after0 = [], None
        for r in range(rounds):
            rec, secs, got, by = counted(
                f"{label} cfl round {r}", cfg, sess.server.run_round, per,
                k5)
            kern.append(dict(rec=rec, seconds=secs, by_variant=by))
            if r == 0:
                after0 = snapshot(sess.params)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        specs0 = kern[0]["rec"]["specs"]
        steps = kern[0]["rec"]["n_steps"]
        tokens = int(sum(steps)) * ZOO["batch"] * seq_len
        if any(n != 2 for n in steps):
            problems.append(f"{label}: steps {steps}, design 2 a client")
        glob = sess.global_accuracy(sess.test_data[0])
        for r, k in enumerate(kern):
            h = k["rec"]["host_seconds"]
            print(f"  {label} cfl round {r}: {k['seconds']:.3f} s "
                  f"({tokens / k['seconds']:.0f} train tok/s), host search "
                  f"{h['search']:.4f} s predictor {h['predictor']:.4f} s; "
                  f"specs {k['rec']['specs']}; accs "
                  f"{np.round(k['rec']['accs'], 5).tolist()}")
        print(f"  {label}: LUT built in {st['lut_build_s']:.4f} s, "
              f"{len(sess.server.latency)} entries after the rounds; peak "
              f"device memory {peak / 2**30:.2f} GiB; global accuracy "
              f"(evaluate, client 0's test set) {glob:.5f}")
        st.update(cfl_round_s=[k["seconds"] for k in kern],
                  cfl_tok_per_s=[tokens / k["seconds"] for k in kern],
                  host_s=[k["rec"]["host_seconds"] for k in kern],
                  specs=[k["rec"]["specs"] for k in kern],
                  accs=[k["rec"]["accs"] for k in kern],
                  fairness=kern[-1]["rec"]["fairness"], peak_gib=peak / 2**30,
                  global_accuracy=glob, tokens_per_round=tokens,
                  launches_by_variant=kern[0]["by_variant"])
        init = sess._init_params
        specs = [TransformerSubSpec(tuple(tuple(l) for l in g[0]),
                                    g[1] / 100, g[2] / 100, g[3] / 100,
                                    g[4] / 100) for g in specs0]
        test = sess.test_data
        del sess
        gc.collect()

        # ---- the dense path's round 0 from the same state --------------
        routes = RouteLog()
        if moe:
            rec_sess = session(device, fam)
            with routes("record"):
                rec_sess.run(1)
            d = first_difference(after0, rec_sess.params)
            print(f"  {label}: the routes' record run's round 0 "
                  + ("equals the timed run's to the bit" if d is None else
                     f"DIFFERS from the timed run's: first at {d[0]} by "
                     f"{d[1]:.3e}"))
            if d is not None:
                problems.append(f"{label}: the kernel path does not repeat "
                                f"to the bit (first at {d[0]})")
            del rec_sess
        dense = session(device, fam, ek=False)
        t = time.perf_counter()
        with (routes("replay") if moe else contextlib.nullcontext()):
            rec = dense.server.run_round()
        dense_s = time.perf_counter() - t
        round_routes = (routes.differ, routes.decisions)
        if moe and routes.pos != len(routes.ids):
            problems.append(f"{label}: replayed {routes.pos} of "
                            f"{len(routes.ids)} recorded routes")
        dense0 = snapshot(dense.params)
        if rec["specs"] != specs0:
            problems.append(f"{label}: the dense path's round-0 specs "
                            f"differ")
        ratio, diff, moved = move_ratio(after0, dense0, init)
        excess, _, diff_ulps = ulp_floored(after0, dense0)
        floored = excess / moved
        # each path's round-0 model scored by its own forward (MoE: the
        # dense forward on the kernel forward's routes)
        with (routes("record") if moe else contextlib.nullcontext()):
            ce_k = eval_losses(fam, specs, test, after0, "auto", device)
        with (routes("replay") if moe else contextlib.nullcontext()):
            ce_d = eval_losses(fam, specs, test, dense0, None, device)
        ce_rel = float(np.max(np.abs(ce_k - ce_d) / np.abs(ce_d)))
        print(f"  {label} dense path round 0"
              f"{' (kernel routes)' if moe else ''}: {dense_s:.3f} s; "
              f"parameters max|kernel - dense| "
              f"{diff:.3e} ({diff_ulps:.2f} ulp of |p|) over movement "
              f"{moved:.3e}: {ratio:.3e}; beyond {ULP_FLOOR} ulp of |p| "
              f"{excess:.3e}: {floored:.3e} (tol 1e-3)"
              f"; test CE kernel {np.round(ce_k, 6).tolist()} dense "
              f"{np.round(ce_d, 6).tolist()}: max relative {ce_rel:.3e} "
              f"(tol {TRAIN_LOSS_RTOL:g})")
        if moe:
            print(f"  {label}: token decisions whose expert set the dense "
                  f"path's own routing would change: round 0 "
                  f"{round_routes[0]} of {round_routes[1]}, eval "
                  f"{routes.differ} of {routes.decisions}")
        if not floored <= 1e-3:
            problems.append(f"{label}: round-0 parameters kernel vs dense "
                            f"beyond {ULP_FLOOR} ulp {floored:.3e} > 1e-3 "
                            "of the movement")
        if not ce_rel <= TRAIN_LOSS_RTOL:
            problems.append(f"{label}: round-0 test CE kernel vs dense "
                            f"{ce_rel:.3e} > {TRAIN_LOSS_RTOL:g}")
        st.update(dense_round0_s=dense_s, round0_param_ratio=ratio,
                  round0_param_floored=floored, round0_diff_ulps=diff_ulps,
                  round0_ce_rel=ce_rel, round0_move=moved,
                  route_decisions_differ={
                      "round0": round_routes, "eval": (routes.differ,
                                                       routes.decisions)}
                  if moe else None)
        del dense, after0
        routes.ids = []
        gc.collect()

        # ---- FedAvg and IL on the kernels (the dense parent) -----------
        if baselines:
            fed = session(device, fam, "fedavg")
            rec, secs, _, by = counted(f"{label} fedavg round 0", cfg,
                                       fed.server.run_round, per)
            print(f"  {label} fedavg round 0: {secs:.3f} s "
                  f"({tokens / secs:.0f} train tok/s); accs "
                  f"{np.round(rec['accs'], 5).tolist()}")
            st.update(fedavg_round_s=secs, fedavg_accs=rec["accs"],
                      fedavg_by_variant=by)
            del fed
            il = session(device, fam, "il")
            _, secs, _, by = counted(f"{label} il (1 round's budget)", cfg,
                                     lambda: il.run(1), per)
            print(f"  {label} il: {secs:.3f} s; accs "
                  f"{np.round(il.il_accs, 5).tolist()}")
            st.update(il_s=secs, il_accs=il.il_accs, il_by_variant=by)
            del il
            gc.collect()

        # ---- the sequential trainer ------------------------------------
        seq = session(device, fam, batched=False)
        rec, secs, _, _ = counted(f"{label} sequential round 0", cfg,
                                  seq.server.run_round, None)
        seq0 = seq.params
        ratio_s, diff_s, moved_s = move_ratio(seq0, dense0, init)
        excess_s, _, ulps_s = ulp_floored(seq0, dense0)
        floored_s = excess_s / moved_s
        held = not moe
        print(f"  {label} sequential round 0: {secs:.3f} s "
              f"({tokens / secs:.0f} train tok/s); accs "
              f"{np.round(rec['accs'], 5).tolist()}; parameters "
              f"max|sequential - dense| {diff_s:.3e} ({ulps_s:.2f} ulp of "
              f"|p|), ratio {ratio_s:.3e}; beyond {ULP_FLOOR} ulp of |p| "
              f"{excess_s:.3e}: {floored_s:.3e} "
              + (f"(tol {SEQ_FP32_TOL:g})" if held else
                 "(not held: capacity sized by each submodel's experts)"))
        if rec["specs"] != specs0:
            problems.append(f"{label}: the sequential round's specs differ")
        if held and not floored_s <= SEQ_FP32_TOL:
            problems.append(f"{label}: sequential round 0 vs dense beyond "
                            f"{ULP_FLOOR} ulp {floored_s:.3e} > "
                            f"{SEQ_FP32_TOL:g}")
        del dense0, seq0, init       # the fp64 holds need the room
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        per_client, differ = sequential_holds(device, fam, seq, specs,
                                              routes if moe else None)
        for k, (r64, r32) in per_client.items():
            print(f"  {label} client {k}: sequential vs batched dense, "
                  f"first step fp64 {r64:.3e} (tol {SEQ_FP64_TOL:g}), "
                  f"local training fp32 {r32:.3e} (tol {SEQ_FP32_TOL:g})")
            if not r64 <= SEQ_FP64_TOL:
                problems.append(f"{label} client {k}: fp64 first step "
                                f"{r64:.3e} > {SEQ_FP64_TOL:g}")
            if not r32 <= SEQ_FP32_TOL:
                problems.append(f"{label} client {k}: fp32 local training "
                                f"{r32:.3e} > {SEQ_FP32_TOL:g}")
        if moe:
            print(f"  {label}: the batched runs took the sequential runs' "
                  f"routes; {differ} token decisions differ from their own")
        st.update(seq_round_s=secs, seq_accs=rec["accs"],
                  seq_round0_ratio=ratio_s, seq_round0_floored=floored_s,
                  seq_round0_diff_ulps=ulps_s, seq_clients=per_client,
                  seq_route_decisions_differ=differ if moe else None)
        del seq
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        st["seconds"] = time.perf_counter() - t_parent
        print(f"  {label}: {st['seconds']:.1f} s in all")
    stats["phase_seconds"] = time.perf_counter() - t_phase
    print(f"  phase {phase}: {stats['phase_seconds']:.1f} s; "
          + (card_line() if cuda else "no card"))
    if problems:
        raise PhaseError("; ".join(problems))
    return launches_out, stats


# ---------------------------------------------------------------------------
# phase 16: partial participation, the selection policies, async buffered
# rounds with fault injection
# ---------------------------------------------------------------------------
# 16a: fraction 0.5 of the fleet a round (M = 4 of 8 on the CNN, 2 of 4 on
# the zoo); 16c's buffered async run: B = 2 deltas, FedBuff's discount,
# faults drawn from a fixed plan and the quarantine gate
SELECT_POLICIES = ("uniform", "fairness", "latency")
SELECT_ROUNDS = 2
BUFFERED_RUN = dict(selection="uniform", mode="async", async_buffer=2,
                    staleness_decay=0.5,
                    faults="drop=0.1,straggle=0.1,corrupt=0.1",
                    validate_deltas=True)
BUFFERED_AGGREGATES = 4
BUFFER_RTOL = 1e-6             # the buffered step against its fp64
                               # recomputation from the same group deltas:
                               # sums of ≤ 8 fp32 terms per entry
EVENT_COLUMNS = ("participants", "staleness", "sim_clock", "dropped",
                 "retried", "quarantined")
LAG_ULPS = 4                   # aggregate_lag, async at the sync point
                               # against sync: the same difference of
                               # simulated times, rounded on the absolute
                               # clock (each of its two terms one ulp)


class SelectLog:
    """While entered, keeps every ``Selection`` a server's tracker hands
    out and the host seconds of each ``select``."""

    def __init__(self, server):
        self._tracker, self.sels, self.seconds = server.tracker, [], []

    def __enter__(self):
        real, t = self._tracker.select, self._tracker

        def select(r):
            t0 = time.perf_counter()
            sel = real(r)
            self.seconds.append(time.perf_counter() - t0)
            self.sels.append(sel)
            return sel
        t.select = select
        return self

    def __exit__(self, *exc):
        del self._tracker.select            # the class's method again


class BufferedSteps:
    """While entered, records every ``cohort_reduce`` call of the async
    runtime (its inputs and its fp32 partial sums) and every
    ``buffer_apply`` (the parameters it was given), grouped per step."""

    def __init__(self):
        from repro_torch.fl import runtime
        self._mod = runtime
        self.steps, self._groups = [], []

    def __enter__(self):
        mod, real_reduce, real_apply = (self._mod, self._mod.cohort_reduce,
                                        self._mod.buffer_apply)

        def reduce(deltas, covs, weights, **kw):
            out = real_reduce(deltas, covs, weights, **kw)
            self._groups.append(dict(deltas=deltas, covs=covs,
                                     weights=weights, kw=kw, out=out))
            return out

        def apply(params, num, den, **kw):
            self.steps.append(dict(groups=self._groups, params=params,
                                   num=num, den=den, kw=kw))
            self._groups = []
            return real_apply(params, num, den, **kw)
        self._real = (real_reduce, real_apply)
        mod.cohort_reduce, mod.buffer_apply = reduce, apply
        return self

    def __exit__(self, *exc):
        self._mod.cohort_reduce, self._mod.buffer_apply = self._real


def buffered_step_error(step):
    """The relative error of one recorded buffered step against its fp64
    recomputation from the same group deltas (each group's weighted sums
    Σ_k w_k p_k s d_k and Σ_k w_k p_k s c_k — or the mass Σ_k w_k p_k s —
    written out in fp64, non-finite entries zeroed where the group was
    sanitised): max |Δ32 − Δ64| / max |Δ64| over the step Δ = num /
    max(den, eps), and the same for the partial sums num and den."""
    import torch
    from repro_torch.core.aggregate import EPS
    from repro_torch.optim.optimizers import tree_map
    cov = step["kw"].get("coverage_norm", False)

    def reduce64(g):
        kw = g["kw"]
        w = g["weights"].double()
        if kw.get("participation") is not None:
            w = w * kw["participation"].double()
        w = w * float(kw.get("scale", 1.0))

        def wsum(t, clean):
            t = t.double()
            if clean:
                t = torch.where(torch.isfinite(t), t,
                                torch.zeros((), dtype=t.dtype,
                                            device=t.device))
            return (t * w.reshape((-1,) + (1,) * (t.dim() - 1))).sum(0)
        num = tree_map(lambda d: wsum(d, kw.get("sanitize", False)),
                       g["deltas"])
        den = tree_map(lambda c: wsum(c, False), g["covs"]) if cov \
            else w.sum()
        return num, den
    num64 = den64 = None
    for g in step["groups"]:
        n, d = reduce64(g)
        num64 = n if num64 is None else tree_map(torch.add, num64, n)
        den64 = d if den64 is None else tree_map(torch.add, den64, d)

    def rel(got, want):
        got = [got] if torch.is_tensor(got) else list(_leaves(got))
        want = [want] if torch.is_tensor(want) else list(_leaves(want))
        diff = max(float((a.double() - b).abs().max())
                   for a, b in zip(got, want))
        return diff / max(max(float(b.abs().max()) for b in want), 1e-30)

    def step_of(num, den):
        if cov:
            return tree_map(lambda n, d: n / torch.clamp(d, min=EPS), num,
                            den)
        return tree_map(lambda n: n / torch.clamp(den, min=EPS), num)
    return {"step": rel(step_of(step["num"], step["den"]),
                        step_of(num64, den64)),
            "num": rel(step["num"], num64), "den": rel(step["den"], den64)}


def phase_selection(device, cfg=None, zoo=True, cfg_of=None):
    """Phase 16: partial participation, the selection policies and async
    buffered rounds with fault injection, through ``CFLSession`` on
    phase 14's population (``cfg``, ``PAPER_CNN`` by default: 8 clients,
    ``CFLConfig`` defaults) and, with ``zoo``, one granite-3-8b round at
    phase 15's settings. Every timed run is free-running after an untimed
    warm-up round of its own session, its launches counted from 0.

    * 16a: CFL sync under "uniform", "fairness" and "latency" (4 of 8
      clients a round), ``SELECT_ROUNDS`` timed rounds each on the
      kernels (the held round below their warm-up): K1 21 × (3·S + 1) a
      round, S the round's padded step
      count, all through tensor-core variants, ``F.conv2d`` only for the
      stem. Held on round 0: the dense path replaying the kernel path's
      ReLU decisions gives the same participants, weights and specs,
      parameters within 1e-3 of the round's movement beyond ``ULP_FLOOR``
      ulps, test CE within ``TRAIN_LOSS_RTOL``.
    * 16b: CFL async at the sync operating point (uniform, the buffer the
      cohort, ``staleness_decay=0``), ``SELECT_ROUNDS`` aggregates:
      parameters and history columns bit-equal to 16a's uniform run
      (``aggregate_lag`` within ``LAG_ULPS`` ulps of the clock).
    * 16c: CFL buffered async (``BUFFERED_RUN``), ``BUFFERED_AGGREGATES``
      aggregates on the kernels and on the dense path: identical event
      columns (participants, staleness, simulated clock, dropped,
      retried, quarantined), finite parameters; the kernel run's last
      buffered step against its fp64 recomputation (``cohort_reduce`` /
      ``buffer_add`` from the same group deltas) within ``BUFFER_RTOL``.
    * 16d: FedAvg under "fairness": one sync round and one async aggregate
      at the sync operating point, bit-equal as 16b.
    * 16e: a granite-3-8b CFL round (``zoo``) with "uniform" (2 of 4
      clients): K1 and K2–K4 as ``design_launches`` gives them, held as
      phase 15 holds (the dense path's round 0 from the same state: the
      same participants and specs, parameters within 1e-3 beyond
      ``ULP_FLOOR`` ulps, test CE within ``TRAIN_LOSS_RTOL``).

    Prints each run's round (aggregate) seconds, train images/s or tok/s,
    host seconds of selection, search and predictor, and Table II's
    columns (accuracy mean / min / std / Jain, the simulated clock).
    ``cfg_of`` maps the zoo parent's name to its config (``get_config`` by
    default; a ``reduced`` config and a small ``cfg`` rehearse the phase
    on the CPU, where nothing is counted). Returns ({run: launches},
    stats)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core.elastic import family_for
    from repro_torch.core.fairness import accuracy_fairness
    from repro_torch.core.submodel import TransformerSubSpec
    from repro_torch.fl.rounds import build_population
    from repro_torch.fl.server import CFLConfig
    from repro_torch.fl.session import CFLSession
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = PAPER_CNN if cfg is None else cfg
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    relus = relu_decisions()
    convs = 1 + sum(1 + 2 * n for _, n in cfg.stages)
    problems, launches, stats = [], {}, {"runs": {}}
    pop = {k: CNN_SLICE[k] for k in ("kind", "n_workers", "n_samples",
                                     "heterogeneity", "seed")}

    def snapshot(params):
        return tree_map(lambda a: a.clone(), params)

    # one population and one set of initial parameters for every session
    # (what ``CFLSession.from_synthetic`` builds, built once)
    family = family_for(cfg)
    fleet = build_population(
        family, kind=pop["kind"], n_workers=pop["n_workers"],
        n_samples=pop["n_samples"], heterogeneity=pop["heterogeneity"],
        seed=pop["seed"], latency_bound_frac=CFLConfig().latency_bound_frac)
    params0 = family.init_params(seed=pop["seed"], device=device)

    def make(algorithm="cfl", ek=True, **kw):
        return CFLSession(
            family, *fleet, CFLConfig(n_workers=pop["n_workers"],
                                      elastic_kernels=ek, seed=pop["seed"],
                                      **kw),
            params=snapshot(params0), algorithm=algorithm, device=device)

    def summary(accs):
        f = accuracy_fairness(accs if accs else [float("nan")])
        return {k: f[k] for k in ("mean", "min", "std", "jain_index")}

    def timed(label, n, algorithm="cfl", warm=True, **kw):
        """An untimed warm-up round of its own session, then ``n`` timed
        free-running rounds (aggregates) of a fresh one, counted."""
        if warm:
            w = make(algorithm, **kw)
            w.run(1)
            del w
        sess = make(algorithm, **kw)
        out = []
        with CnnCounters() as count, SelectLog(sess.server) as log:
            for _ in range(n):
                sync(device)
                t = time.perf_counter()
                rec = sess.server.run_round()
                sync(device)
                out.append(dict(rec=rec, seconds=time.perf_counter() - t))
        launches[label] = {"elastic_dense": count.launches}
        steps = [max(o["rec"]["n_steps"], default=0) for o in out]
        want = cnn_design_launches(steps, convs - 1)
        tc = sum(count.by_variant.get(v, 0) for v in ("tile", "skinny"))
        print(f"  {label}: elastic_dense {count.launches} launches (design "
              f"{want['elastic_dense']}: {convs - 1} x (3 S + 1) a round, S "
              f"{steps}), by variant {count.by_variant}; F.conv2d "
              f"{count.conv_calls} calls (design {want['F.conv2d']})")
        if cuda and (count.launches != want["elastic_dense"]
                     or tc != count.launches
                     or count.conv_calls != want["F.conv2d"]):
            problems.append(f"{label}: K1 launched {count.launches} times "
                            f"({count.by_variant}), F.conv2d "
                            f"{count.conv_calls}; design {want}")
        run = dict(round_s=[], images_per_s=[], host_s=[],
                   by_variant=count.by_variant, launches=count.launches,
                   launches_design=want["elastic_dense"])
        for i, o in enumerate(out):
            rec, secs = o["rec"], o["seconds"]
            images = sum(rec["n_steps"]) * CNN_BATCH
            host = dict(selection=log.seconds[i] if i < len(log.seconds)
                        else 0.0, **{k: v for k, v in
                                     rec["host_seconds"].items()
                                     if k != "round"})
            acc = summary(rec["accs"])
            print(f"  {label} {rec['mode']} {i}: {secs:.3f} s "
                  f"({images / secs:.0f} train images/s); host s "
                  f"{json.dumps({k: round(v, 4) for k, v in host.items()})}"
                  f"; participants {rec['participants']}; accuracy mean / "
                  f"min / std / Jain {acc['mean']:.4f} / {acc['min']:.4f} / "
                  f"{acc['std']:.4f} / {acc['jain_index']:.4f}; sim_clock "
                  f"{rec['sim_clock']:.4f} s; staleness {rec['staleness']}"
                  f", dropped / retried / quarantined {rec['dropped']} / "
                  f"{rec['retried']} / {rec['quarantined']}")
            run["round_s"].append(secs)
            run["images_per_s"].append(images / secs)
            run["host_s"].append(host)
            run.setdefault("table_ii", []).append(dict(
                acc, sim_clock=rec["sim_clock"]))
        stats["runs"][label] = run
        return sess, out, log

    def held_round0(label, policy):
        """Round 0 of ``policy`` on the kernel path recording its ReLU
        decisions, and on the dense path replaying them."""
        relus.masks.clear()
        kern = make(selection=policy)
        with relus("record"), SelectLog(kern.server) as klog:
            krec = kern.server.run_round()
        dense = make(ek=False, selection=policy)
        with relus("replay"), SelectLog(dense.server) as dlog:
            drec = dense.server.run_round()
        replayed, recorded = relus.pos, len(relus.masks)
        if replayed != recorded:
            problems.append(f"{label}: the replay took {replayed} of "
                            f"{recorded} recorded ReLU calls")
        ks, ds = klog.sels[0], dlog.sels[0]
        same_sel = all(np.array_equal(getattr(ks, f), getattr(ds, f))
                       for f in ("idx", "valid", "weights"))
        same = (same_sel and krec["participants"] == drec["participants"]
                and krec["specs"] == drec["specs"])
        init = kern._init_params
        ratio, diff, moved = move_ratio(dense.params, kern.params, init)
        excess, _, ulps = ulp_floored(dense.params, kern.params)
        floored = excess / moved
        ids = krec["participants"]
        specs = cnn_specs(krec["specs"])
        test = [kern.test_data[i] for i in ids]
        with relus("record"):
            relus.masks.clear()
            ce_k = cnn_eval_losses(kern.family, specs, test, kern.params,
                                   "auto", device)
        with relus("replay"):
            ce_d = cnn_eval_losses(kern.family, specs, test, dense.params,
                                   None, device)
        relus.masks.clear()
        ce = float(np.max(np.abs(ce_k - ce_d) / np.abs(ce_d)))
        print(f"  {label} round 0 held (dense path on the kernel path's "
              f"ReLUs): participants / weights / specs "
              f"{'identical' if same else 'DIFFER'} ({ids}, weights "
              f"{ks.weights.tolist()}, padding {int((ks.valid == 0).sum())}"
              f"); parameters max diff {diff:.3e} ({ulps:.2f} ulp of |p|) "
              f"over movement {moved:.3e}: {ratio:.3e}; beyond {ULP_FLOOR} "
              f"ulp {floored:.3e} (tol 1e-3); test CE max relative {ce:.3e} "
              f"(tol {TRAIN_LOSS_RTOL:g})")
        if not same:
            problems.append(f"{label}: the paths' round-0 selections or "
                            f"specs differ")
        if not floored <= 1e-3:
            problems.append(f"{label}: round-0 parameters beyond "
                            f"{ULP_FLOOR} ulp {floored:.3e} > 1e-3")
        if not (np.isfinite(ce_k).all() and ce <= TRAIN_LOSS_RTOL):
            problems.append(f"{label}: round-0 test CE {ce:.3e}")
        return dict(ratio=ratio, floored=floored, ulps=ulps, ce_rel=ce,
                    identical=same)

    def bit_equal(label, a, b):
        """Parameters and history columns equal to the bit; the one
        exception, ``aggregate_lag``, within ``LAG_ULPS``: async takes it
        on the absolute simulated clock, t − (D + t_k) for a dispatch at
        D, sync as max_j t_j − t_k, as the reference does."""
        d = first_difference(a.params, b.params)
        cols = [k for k in a.history[0] if k not in ("mode", "host_seconds",
                                                     "buffered")]
        bad = [k for ra, rb in zip(a.history, b.history) for k in cols
               if ra[k] != rb.get(k) and not (k == "aggregate_lag" and abs(
                   ra[k] - rb[k]) <= LAG_ULPS * math.ulp(ra["sim_clock"]))]
        print(f"  {label}: parameters "
              + ("equal to the bit" if d is None else
                 f"DIFFER (first at {d[0]} by {d[1]:.3e})")
              + f"; history columns "
              + ("equal" if not bad else f"DIFFER: {sorted(set(bad))}"))
        if d is not None or bad:
            problems.append(f"{label}: async at the sync operating point "
                            f"is not the sync run to the bit")
        return d is None and not bad

    # ---- 16a: the three policies, sync, partial ---------------------------
    t0 = time.perf_counter()
    held, sync_runs = {}, {}
    for policy in SELECT_POLICIES:
        label = f"cnn cfl {policy}"
        # the held kernel round (recording ReLUs) is the timed run's
        # untimed warm-up round
        held[policy] = held_round0(label, policy)
        sess, _, _ = timed(label, SELECT_ROUNDS, warm=False,
                           selection=policy)
        sync_runs[policy] = sess
    stats["held_round0"] = held
    stats["16a_s"] = time.perf_counter() - t0

    # ---- 16b: async at the sync operating point ---------------------------
    t0 = time.perf_counter()
    asess, _, _ = timed("cnn cfl uniform async (sync point)", SELECT_ROUNDS,
                        warm=False, selection="uniform", mode="async",
                        staleness_decay=0.0)
    stats["async_sync_point_bit_equal"] = bit_equal(
        "16b async at the sync point vs 16a uniform", sync_runs["uniform"],
        asess)
    del asess, sync_runs
    stats["16b_s"] = time.perf_counter() - t0

    # ---- 16c: buffered async with faults, both paths ----------------------
    t0 = time.perf_counter()
    with BufferedSteps() as steps:
        bk, _, _ = timed("cnn cfl buffered async", BUFFERED_AGGREGATES,
                         **BUFFERED_RUN)
    dense = make(ek=False, **BUFFERED_RUN)
    dense.run(BUFFERED_AGGREGATES)
    cols_k = [{c: r[c] for c in EVENT_COLUMNS} for r in bk.history]
    cols_d = [{c: r[c] for c in EVENT_COLUMNS} for r in dense.history]
    finite = all(bool(torch.isfinite(t).all()) for s in (bk, dense)
                 for t in tree_leaves(s.params))
    events = {c: sum(r[c] for r in bk.history)
              for c in ("dropped", "retried", "quarantined")}
    print(f"  16c event columns, kernel vs dense path: "
          + ("identical" if cols_k == cols_d else "DIFFER")
          + f"; over {BUFFERED_AGGREGATES} aggregates {json.dumps(events)}, "
          f"staleness {[r['staleness'] for r in bk.history]}; parameters "
          + ("finite" if finite else "NOT FINITE"))
    if cols_k != cols_d:
        problems.append(f"16c: event columns differ: {cols_k} / {cols_d}")
    if not finite:
        problems.append("16c: non-finite parameters")
    errs = None
    if not steps.steps:
        problems.append("16c: no buffered step ran")
    else:
        errs = buffered_step_error(steps.steps[-1])
        print(f"  16c last buffered step ({len(steps.steps[-1]['groups'])} "
              f"groups) against fp64: relative error step "
              f"{errs['step']:.3e}, num {errs['num']:.3e}, den "
              f"{errs['den']:.3e} (tol {BUFFER_RTOL:g}); "
              f"{len(steps.steps)} buffered steps in "
              f"{BUFFERED_AGGREGATES} aggregates")
        if not max(errs.values()) <= BUFFER_RTOL:
            problems.append(f"16c: the buffered step differs from fp64 by "
                            f"{errs}")
    stats["buffered"] = dict(event_columns=cols_k, identical=cols_k == cols_d,
                             fp64_rel=errs, events=events,
                             buffered_steps=len(steps.steps))
    del bk, dense, steps
    stats["16c_s"] = time.perf_counter() - t0

    # ---- 16d: FedAvg under the fairness policy ----------------------------
    t0 = time.perf_counter()
    fs, _, _ = timed("cnn fedavg fairness", 1, "fedavg", selection="fairness")
    fa, _, _ = timed("cnn fedavg fairness async (sync point)", 1, "fedavg",
                     warm=False, selection="fairness", mode="async",
                     staleness_decay=0.0)
    stats["fedavg_async_bit_equal"] = bit_equal(
        "16d FedAvg async at the sync point vs sync", fs, fa)
    del fs, fa
    stats["16d_s"] = time.perf_counter() - t0
    gc.collect()

    # ---- 16e: a zoo parent's partial round ---------------------------------
    if zoo:
        t0 = time.perf_counter()
        name, n_layers, seq_len = ZOO_PARENTS[0][:3]
        fam = train_family((cfg_of or get_config)(name), n_layers, seq_len)
        zcfg = fam.cfg
        warm = zoo_session(device, fam, selection="uniform")
        warm.run(1)
        del warm
        sess = zoo_session(device, fam, selection="uniform")
        counters = path_counters(zcfg)
        reset_launches(counters)
        with SelectLog(sess.server) as log:
            sync(device)
            t = time.perf_counter()
            rec = sess.server.run_round()
            sync(device)
            secs = time.perf_counter() - t
        got = {c.__name__: c.launches for c in counters}
        want = design_launches(n_layers, max(rec["n_steps"]), 1)
        label = "zoo granite cfl uniform"
        launches[label] = got
        by = check_variants(got, problems, "tile", "mma") if cuda else {}
        print(f"  {label}: launches {got} (design {want}, 2 slots), by "
              f"variant {by}")
        if cuda and got != want:
            problems.append(f"{label}: launches {got}, design {want}")
        tokens = sum(rec["n_steps"]) * ZOO["batch"] * seq_len
        acc = summary(rec["accs"])
        host = dict(selection=log.seconds[0],
                    **{k: v for k, v in rec["host_seconds"].items()
                       if k != "round"})
        print(f"  {label}: {secs:.3f} s ({tokens / secs:.0f} train tok/s);"
              f" host s {json.dumps({k: round(v, 4) for k, v in host.items()})}"
              f"; participants {rec['participants']}; accuracy mean / min /"
              f" std / Jain {acc['mean']:.5f} / {acc['min']:.5f} / "
              f"{acc['std']:.5f} / {acc['jain_index']:.5f}; sim_clock "
              f"{rec['sim_clock']:.4f} s")
        after0, init = snapshot(sess.params), sess._init_params
        specs = [TransformerSubSpec(tuple(tuple(l) for l in g[0]),
                                    g[1] / 100, g[2] / 100, g[3] / 100,
                                    g[4] / 100) for g in rec["specs"]]
        test = [sess.test_data[i] for i in rec["participants"]]
        del sess
        gc.collect()
        dense = zoo_session(device, fam, ek=False, selection="uniform")
        drec = dense.server.run_round()
        same = (drec["participants"] == rec["participants"]
                and drec["specs"] == rec["specs"])
        ratio, diff, moved = move_ratio(after0, dense.params, init)
        excess, _, ulps = ulp_floored(after0, dense.params)
        floored = excess / moved
        ce_k = eval_losses(fam, specs, test, after0, "auto", device)
        ce_d = eval_losses(fam, specs, test, dense.params, None, device)
        ce = float(np.max(np.abs(ce_k - ce_d) / np.abs(ce_d)))
        print(f"  {label} dense path round 0: participants / specs "
              f"{'identical' if same else 'DIFFER'}; parameters max diff "
              f"{diff:.3e} ({ulps:.2f} ulp of |p|) over movement "
              f"{moved:.3e}: {ratio:.3e}; beyond {ULP_FLOOR} ulp "
              f"{floored:.3e} (tol 1e-3); test CE max relative {ce:.3e} "
              f"(tol {TRAIN_LOSS_RTOL:g})")
        if not same:
            problems.append(f"{label}: the dense round's participants or "
                            f"specs differ")
        if not floored <= 1e-3:
            problems.append(f"{label}: round-0 parameters beyond "
                            f"{ULP_FLOOR} ulp {floored:.3e} > 1e-3")
        if not ce <= TRAIN_LOSS_RTOL:
            problems.append(f"{label}: round-0 test CE {ce:.3e}")
        stats["zoo"] = dict(round_s=secs, tok_per_s=tokens / secs,
                            host_s=host, launches=got, design=want,
                            by_variant=by, table_ii=dict(
                                acc, sim_clock=rec["sim_clock"]),
                            round0_ratio=ratio, round0_floored=floored,
                            round0_ce_rel=ce, identical=same)
        del dense, after0
        gc.collect()
        stats["16e_s"] = time.perf_counter() - t0
    stats["phase_seconds"] = time.perf_counter() - t_phase
    print(f"  phase 16: {stats['phase_seconds']:.1f} s (16a "
          f"{stats['16a_s']:.1f}, 16b {stats['16b_s']:.1f}, 16c "
          f"{stats['16c_s']:.1f}, 16d {stats['16d_s']:.1f}"
          + (f", 16e {stats['16e_s']:.1f}" if zoo else "") + "); "
          + (card_line() if cuda else "no card"))
    if problems:
        raise PhaseError("; ".join(problems))
    return launches, stats


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phases 3e and 17: the zoo's last three decoder parents
# ---------------------------------------------------------------------------
# phase 17's serving slices, depth cut to make room for phase 20 (widths
# kept): gemma2-9b 10 of its 21 (local, global) pairs, zamba2-1.2b its first
# two 6-layer segments with their shared blocks and its last segment (14 of
# 38 layers), deepseek-v2-lite-16b its dense first layer and 8 of its 26
# MoE layers — (arch, depth for cut_depth)
A11_SLICES = (("gemma2-9b", ((0, 10),)),
              ("zamba2-1.2b", ((0, 6), (1, 6), (6, 2))),
              ("deepseek-v2-lite-16b", ((0, 1), (1, 8))))
# phase 17's CFL sessions at published width, as phase 15's (name, depth,
# sequence length, timed CFL rounds, FedAvg / IL and a warm-up, clients):
# gemma2 one (local, global) pair and deepseek its dense layer and one MoE
# layer, 2 clients each (5.26 / 4.34 GB a copy: every client holds its
# parameters, momenta and gradients, the fp64 first-step holds twice that);
# zamba2 its first 6-layer segment with the shared block after it and its
# last segment, 4 clients, 512-token sequences (two of its 256-token chunks)
A11_PARENTS = (("gemma2-9b", ((0, 1),), TRAIN["seq_len"], 1, False, 2),
               ("deepseek-v2-lite-16b", ((0, 1), (1, 1)), TRAIN["seq_len"],
                1, False, 2),
               ("zamba2-1.2b", ((0, 6), (6, 2)), SSM_TRAIN["seq_len"], 1,
                False, 4))
# phase 3e's attention shapes at head_dim 256: the training rows of 2
# clients × 8 sequences of 128 tokens, each client its own head prefix
D256_ROWS, D256_SEQ, D256_HEADS = 16, 128, (16, 8)


def d256_cases(g2, g7):
    """(label, B, S, H, KV, D, h_active, causal, window, cap) of K2–K4 at
    head_dim 256: gemma2-9b's training attention (16 / 8 heads, softcap
    50) without a window and with a window of 64 that binds at 128 tokens,
    gemma-7b's (MHA 16 / 16, no softcap), and a 32-token prefill."""
    B, S = D256_ROWS, D256_SEQ
    has = [D256_HEADS[b * len(D256_HEADS) // B] for b in range(B)]
    H, KV, D, cap = g2.n_heads, g2.n_kv_heads, g2.head_dim, g2.attn_softcap
    return [("gemma2 train", B, S, H, KV, D, has, True, None, cap),
            ("gemma2 train window 64", B, S, H, KV, D, has, True, 64, cap),
            ("gemma-7b train MHA", B, S, g7.n_heads, g7.n_kv_heads,
             g7.head_dim, None, True, None, None),
            ("prefill 32", 1, 32, H, KV, D, None, True, None, cap)]


def phase_a11_kernels(device, g2, g7, ds, zb, iters=5):
    """Phase 3e: the kernels at the shapes the last three decoder parents
    give them, against their plain versions and timed.

    * K2, K3 and K4 at head_dim 256 (``d256_cases``: K3 / K4 in both
      variants, each twice and bit-equal, and on an offset view), then
      times at gemma2's and gemma-7b's training attention (``flash_times``:
      K3, K4 and SDPA's all-grads backward in turns) and of K2 at the
      prefill;
    * K6 (its copy, scaled gather and gather-dot) and K7 at deepseek's top
      6 of 64 experts, d 2048 (``check_gathers`` at a training layer of 2
      clients × 512 tokens with expert prefixes 64 / 32, and a decode
      step), then the combine (K7) and the gather-dot timed against their
      library calls;
    * K8 and K9 at zamba2's SSD (64 heads of 64, d_state 64, chunk 256:
      ``phase_ssd_kernels`` at its training and prefill shapes,
      ``phase_ssd_times``).

    Returns (worst error of each kernel, {kernel: [timing row]})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd_plain)
    from repro_torch.kernels.moe_dispatch import (
        gather_dot, gather_dot_plain, gather_reduce, gather_reduce_plain)
    from repro_torch.models.moe import capacity
    gen = torch.Generator(device=device).manual_seed(9)
    worst = {n: 0.0 for n in ("flash_attention", "flash_attention_dq",
                              "flash_attention_dkv")}
    failed = []
    cases = d256_cases(g2, g7)
    check_flash(device, cases, gen, worst, failed)
    times = {}
    for label, B, S, H, KV, D, *_ in cases[::2][:2]:    # gemma2, gemma-7b
        for name, rows in flash_times(device, B, S, H, KV, D, gen,
                                      iters).items():
            for r in rows:
                r["shape"] = f"{label}: {r['shape']}"
            times.setdefault(name, []).extend(rows)
    _, B, S, H, KV, D, _, _, _, cap = cases[-1]
    q, k, v, _ = _k2_inputs(B, S, H, KV, D, None, device, gen)
    kw = dict(causal=True, cap=cap)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (
        q, k.repeat_interleave(H // KV, 2), v.repeat_interleave(H // KV, 2)))
    nbytes, ops = 4.0 * (2 * B * S * H * D + 2 * B * S * KV * D
                         + B * H * S), 4.0 * D * attn_pairs(B, S, H)
    row = dict(shape=f"prefill q({B},{S},{H},{D}) kv({B},{S},{KV},{D}) "
                     f"causal cap {cap} (library: no softcap)",
               ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), device,
                          20),
               plain_ms=cuda_ms(lambda: flash_attention_fwd_plain(
                   q, k, v, **kw), device, 20),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True), device, 20),
               device_ms=device_ms(lambda: flash_attention(q, k, v, **kw),
                                   device),
               library_device_ms=device_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True), device))
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
    add_tc_bound(row, nbytes, ops)
    times["flash_attention"].append(row)
    del q, k, v, qt, kt, vt
    print_rows(times)

    # K6 / K7 at deepseek's top 6 of 64 experts
    E, top_k, d = ds.moe.n_experts, ds.moe.top_k, ds.d_model
    tokens = ZOO["batch"] * TRAIN["seq_len"]
    cap_t = capacity(tokens, MoEConfig(E, top_k, ds.moe.d_ff_expert))
    for label, G, T, cp, pre in (("deepseek", 2, tokens, cap_t, [E, E // 2]),
                                 ("deepseek dec", 2, 1, 8, [E, E // 4])):
        t = moe_tables(device, G, T, E, top_k, cp, pre, d, gen)
        for n in ("gather_rows", "gather_dot", "gather_reduce"):
            worst.setdefault(n, 0.0)
        failed += check_gathers(device, t, top_k, label, d, worst)
        if label != "deepseek":
            continue
        y, dest = t["y"], t["dest"]
        T_all, gates = G * T, t["gate_eff"]
        nnz = int((gates != 0).sum())
        live = (gates.reshape(-1) != 0).to(torch.int32)
        dest_c = dest.long().clamp(max=y.shape[0] - 1)
        dtk = dest.reshape(T_all, top_k)
        dout = torch.randn((T_all, d), generator=gen, device=device)
        times["gather_reduce"] = [design_row(
            device, f"deepseek train combine T={T_all} k={top_k} from "
            f"{y.shape[0]} slots, d={d}, {nnz} gathered",
            {"split": lambda: gather_reduce(y, dtk, gates),
             "first": lambda: gather_reduce(y, dtk, gates, variant="first")},
            iters, lambda: gather_reduce_plain(y, dtk, gates),
            lambda: torch.einsum("tj,tjd->td", gates, torch.index_select(
                y, 0, dest_c).view(T_all, top_k, d)),
            4.0 * d * (nnz + T_all) + 8.0 * T_all * top_k, 2.0 * nnz * d,
            False)]
        live_f = live.float().view(T_all, top_k)
        times["gather_dot"] = [design_row(
            device, f"deepseek train combine vjp dgate T={T_all} "
            f"k={top_k} from {y.shape[0]} slots, d={d}, {nnz} gathered",
            {"dot": lambda: gather_dot(y, dest, live, dout, top_k)},
            iters, lambda: gather_dot_plain(y, dest, live, dout, top_k),
            lambda: torch.einsum("td,tjd->tj", dout, torch.index_select(
                y, 0, dest_c).view(T_all, top_k, d)) * live_f,
            4.0 * d * (nnz + T_all) + 12.0 * T_all * top_k, 2.0 * nnz * d,
            False)]
        del t, y, dout
    print_rows({n: times[n] for n in ("gather_reduce", "gather_dot")})
    print("  (library for K7: torch.index_select then torch.einsum; for the "
          "gather-dot: torch.index_select, torch.einsum, the validity mask)")
    if failed:
        raise PhaseError(f"kernels at the last three parents' shapes "
                         f"disagree with their plain versions: {failed}")

    # K8 / K9 at zamba2's SSD
    zdims = dict(d_model=zb.d_model, head_dim=zb.ssm.head_dim,
                 d_state=zb.ssm.d_state, clients=4, rows=ZOO["batch"],
                 seq=SSM_TRAIN["seq_len"], chunk=zb.ssm.chunk,
                 prompt_len=SLICE["prompt_len"])
    H = zb.ssm.n_heads(zb.d_model)
    zdims["heads"] = [H, H // 2, 3 * H // 4, H // 4]
    for n, e in phase_ssd_kernels(device, **zdims, edges=False).items():
        worst[n] = max(worst.get(n, 0.0), e)
    for n, rows in phase_ssd_times(device, **zdims).items():
        for r in rows:
            r["shape"] = f"zamba2 {r['shape']}"
        times.setdefault(n, []).extend(rows)
    return worst, times


# ---------------------------------------------------------------------------
# phase 3f: K2–K4 at head_dim 80 (hubert-xlarge)
# ---------------------------------------------------------------------------
D80_ROWS, D80_SEQ, D80_HEADS = 4, 512, (16, 8)   # 4 × 512 frames (19c)


def d80_cases(hb):
    """(label, B, S, H, KV, D, h_active, causal, window, cap) of K2–K4 at
    head_dim 80: hubert-xlarge's training attention (MHA 16 / 16, non-
    causal) with all heads and with head prefixes 16 and 8, then rows that
    are not tile multiples (non-causal, causal GQA, window and softcap) and
    a short non-causal sequence."""
    B, S, H, D = D80_ROWS, D80_SEQ, hb.n_heads, hb.head_dim
    has = [D80_HEADS[b * len(D80_HEADS) // B] for b in range(B)]
    return [("hubert train", B, S, H, hb.n_kv_heads, D, None, False, None,
             None),
            ("hubert heads 16 / 8", B, S, H, hb.n_kv_heads, D, has, False,
             None, None),
            ("S 77 non-causal", 2, 77, H, hb.n_kv_heads, D, [H, 5], False,
             None, None),
            ("S 130 causal GQA", 2, 130, 8, 2, D, [8, 3], True, None, None),
            ("S 65 window + softcap", 2, 65, 4, 2, D, [4, 1], True, 17,
             30.0),
            ("S 33 non-causal", 1, 33, H, hb.n_kv_heads, D, [H], False,
             None, None)]


def phase_d80_kernels(device, hb, iters=5):
    """Phase 3f: K2, K3 and K4 at head_dim 80 (``d80_cases``: K3 / K4 in
    both variants, each twice and bit-equal, and on an offset view) against
    their plain versions, then timed at hubert's training attention, non-
    causal (``flash_times``: K3, K4 and SDPA's all-grads backward in
    turns). Returns (worst error of each kernel, {kernel: [timing row]})."""
    import torch
    gen = torch.Generator(device=device).manual_seed(80)
    worst = {n: 0.0 for n in ("flash_attention", "flash_attention_dq",
                              "flash_attention_dkv")}
    failed = []
    cases = d80_cases(hb)
    check_flash(device, cases, gen, worst, failed)
    if failed:
        raise PhaseError(f"K2-K4 at head_dim 80 disagree with their plain "
                         f"versions: {failed}")
    label, B, S, H, KV, D, *_ = cases[0]
    times = flash_times(device, B, S, H, KV, D, gen, iters, causal=False)
    for rows in times.values():
        for r in rows:
            r["shape"] = f"{label}: {r['shape']}"
    print_rows(times)
    return worst, times


# ---------------------------------------------------------------------------
# phase 18: fleet checkpoints, the overlap ring, the hand-off to serving
# ---------------------------------------------------------------------------
FLEET_ROUNDS = 2               # 18a: one round, kill, restore, one more
FLEET_KILL_AT = 2              # 18b: aggregates before the kill
DISTILL_STEPS = 5
EXPORT_CLIENTS = 1             # 18c's export -> load round trips: one
                               # client (each is 1-2 GB of file I/O)
DISTILL_RTOL = 1e-4            # the KL history, kernel teacher against the
                               # dense one: 2 layers of d 4096 summed in
                               # another order, then a softmax over 49155
PREFILL_TOL = 1e-5             # fused prefill against stepwise decode:
                               # absolute on the fp64 parent (the
                               # reference's check); on the fp32 parent
                               # relative to the largest |value| (at d
                               # 4096 both fp32 paths sit ~9e-6 from fp64,
                               # 3–25 ulps: rounding, not a path fault)


def history_difference(a, b):
    """The history columns in which two runs differ (NaN equal to NaN;
    ``host_seconds`` is wall time and not compared)."""
    def same(x, y):
        if isinstance(x, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, float) and isinstance(y, float):
            return (math.isnan(x) and math.isnan(y)) or x == y
        return x == y
    if len(a) != len(b):
        return ["length"]
    return sorted({k for ra, rb in zip(a, b) for k in ra
                   if k != "host_seconds" and not same(ra[k], rb.get(k))})


def phase_fleet(device, cfg=None, zoo=True, cfg_of=None):
    """Phase 18: fleet checkpoints with bit-exact kill-and-resume, the
    overlap ring on its side stream, and the session's hand-off to
    serving, through ``CFLSession`` on phase 14's population (``cfg``,
    ``PAPER_CNN`` by default, 8 clients) and, with ``zoo``, a granite-3-8b
    session at phase 15's settings.

    * 18a: CFL sync, full participation, ``FLEET_ROUNDS`` rounds on the
      kernels three ways: uninterrupted; with ``checkpoint_every=1`` for
      one round, restored into a fresh session, one more round; and with
      ``overlap=True``. The resumed and the ring-on runs must equal the
      uninterrupted one to the bit (parameters and history); the ring
      counts hits ≥ 1 and no miss, and K1 launches as often as without
      it, all ``tile``. The ring-off and ring-on rounds run in turns and
      their walls are printed (a reading, not a claim); a staging behind
      ~0.1 s of the default stream's spinning must end before it (the
      side stream does not queue behind the round).
    * 18b: phase 16c's ``BUFFERED_RUN`` killed after ``FLEET_KILL_AT``
      aggregates with groups in flight, restored, run to
      ``BUFFERED_AGGREGATES``: bit-equal to the uninterrupted run.
    * 18c (``zoo``): one CFL round of granite-3-8b (phase 15's settings),
      then ``session.serving()`` serves each client's spec on the kernel
      path against the dense path (greedy tokens equal, logits within
      ``SLICE_LOGIT_RTOL``, K1 / K2 launched); ``export_submodel`` →
      ``load_submodel`` of the last ``EXPORT_CLIENTS`` clients' specs
      equals ``extract`` to the bit; ``distill_to_spec`` ``DISTILL_STEPS`` steps with the kernel
      teacher against the dense one (KL within ``DISTILL_RTOL``, K1 and
      K2 as ``design_launches`` gives a forward a step, no K3 / K4);
      ``check_prefill_parity`` within ``PREFILL_TOL`` on the fp64 parent,
      and relative to the largest value on the fp32 one.

    ``cfg_of`` maps the zoo parent's name to its config (a ``reduced``
    config and a small ``cfg`` rehearse the phase on the CPU, where
    nothing is counted). Returns ({run: launches}, stats)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core.elastic import family_for
    from repro_torch.core.submodel import TransformerSubSpec
    from repro_torch.fl.rounds import build_population
    from repro_torch.fl.server import CFLConfig
    from repro_torch.fl.session import CFLSession
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.launch.serve import check_prefill_parity
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.serving import (Request, distill_to_spec,
                                     export_submodel, load_submodel)

    cfg = PAPER_CNN if cfg is None else cfg
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    convs = 1 + sum(1 + 2 * n for _, n in cfg.stages)
    problems, launches, stats = [], {}, {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    pop = {k: CNN_SLICE[k] for k in ("kind", "n_workers", "n_samples",
                                     "heterogeneity", "seed")}
    family = family_for(cfg)
    fleet = build_population(
        family, kind=pop["kind"], n_workers=pop["n_workers"],
        n_samples=pop["n_samples"], heterogeneity=pop["heterogeneity"],
        seed=pop["seed"], latency_bound_frac=CFLConfig().latency_bound_frac)
    params0 = family.init_params(seed=pop["seed"], device=device)

    def make(**kw):
        return CFLSession(
            family, *fleet, CFLConfig(n_workers=pop["n_workers"],
                                      elastic_kernels=True, seed=pop["seed"],
                                      **kw),
            params=tree_map(lambda a: a.clone(), params0), device=device)

    def held(label, want, got):
        d = first_difference(want.params, got.params)
        cols = history_difference(want.history, got.history)
        print(f"  {label}: parameters "
              + ("equal to the bit" if d is None else
                 f"DIFFER (first at {d[0]} by {d[1]:.3e})")
              + "; history " + ("equal" if not cols else f"DIFFERS: {cols}"))
        if d is not None or cols:
            problems.append(f"{label}: not the uninterrupted run to the bit")
        return d is None and not cols

    def round_of(sess):
        """One counted, timed round (aggregate)."""
        with CnnCounters() as count:
            sync(device)
            t = time.perf_counter()
            sess.server.run_round()
            sync(device)
            secs = time.perf_counter() - t
        return secs, count

    # ---- 18a: sync CFL — kill and resume; the ring on and off ---------------
    t0 = time.perf_counter()
    plain, ring = make(), make(overlap=True)
    walls = {"off": [], "on": []}
    k1 = {"off": 0, "on": 0}
    by_variant = {"off": {}, "on": {}}
    for _ in range(FLEET_ROUNDS):             # in turns: off, on, off, on
        for key, sess in (("off", plain), ("on", ring)):
            secs, count = round_of(sess)
            walls[key].append(secs)
            k1[key] += count.launches
            for v, n in count.by_variant.items():
                by_variant[key][v] = by_variant[key].get(v, 0) + n
    ring_stats = ring.server.engine.prefetch_stats()
    launches["fleet cnn cfl ring off"] = {"elastic_dense": k1["off"]}
    launches["fleet cnn cfl ring on"] = {"elastic_dense": k1["on"]}
    print(f"  18a round walls in turns, ring off / on: "
          f"{[round(w, 4) for w in walls['off']]} / "
          f"{[round(w, 4) for w in walls['on']]} s; ring {ring_stats}; "
          f"K1 launches off / on {k1['off']} / {k1['on']}, by variant "
          f"{by_variant['on']}")
    if cuda and (k1["on"] != k1["off"] or k1["on"] == 0
                 or by_variant["on"].get("tile", 0) != k1["on"]):
        problems.append(f"18a: K1 launches ring off / on {k1}, by variant "
                        f"{by_variant['on']}: not equal, or not all tile")
    if ring_stats["hits"] < 1 or ring_stats["misses"] != 0:
        problems.append(f"18a: the ring counted {ring_stats}")
    ring_exact = held("18a ring on vs off", plain, ring)
    lead = None
    if cuda:
        # the staging stream must not queue behind the default one: stage
        # again behind ~0.1 s of the default stream's spinning; the side
        # stream's copies must end before it does
        side = ring.server.engine
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda._sleep(int(2e8))
        start.record()
        ring.server._stage_next_round()
        end.record(side._side)
        sync(device)
        lead = end.elapsed_time(start)
        print(f"  18a staged copies behind a busy default stream: done "
              f"{lead:.3f} ms before it")
        if not lead > 0:
            problems.append(f"18a: the staged copies waited for the default "
                            f"stream (lead {lead:.3f} ms)")
    del ring
    killed = make(checkpoint_every=1, checkpoint_dir=tmp.name)
    killed.run(1)
    path = os.path.join(tmp.name, "round_000001.ckpt")
    size = os.path.getsize(path)
    del killed
    resumed = make()
    t = time.perf_counter()
    info = resumed.restore_checkpoint(path)
    restore_s = time.perf_counter() - t
    resumed.run(FLEET_ROUNDS - 1)
    print(f"  18a checkpoint {size / 1e6:.1f} MB, restored in "
          f"{restore_s:.3f} s: {info}")
    if info["resharded"]:
        problems.append("18a: the restore took the reshard path")
    resume_exact = held("18a killed after round 1 and resumed", plain,
                        resumed)
    stats["sync"] = dict(ring_off_s=walls["off"], ring_on_s=walls["on"],
                         ring=ring_stats, k1=k1, by_variant=by_variant,
                         ring_bit_equal=ring_exact, staged_lead_ms=lead,
                         resume_bit_equal=resume_exact,
                         checkpoint_mb=size / 1e6, restore_s=restore_s)
    del plain, resumed
    stats["18a_s"] = time.perf_counter() - t0

    # ---- 18b: buffered async with faults, killed with groups in flight -----
    t0 = time.perf_counter()
    whole = make(**BUFFERED_RUN)
    whole.run(BUFFERED_AGGREGATES)
    killed = make(**BUFFERED_RUN)
    killed.run(FLEET_KILL_AT)
    groups = {gid: int((g.sel.valid > 0).sum() - g.consumed.sum())
              for gid, g in killed.server.runtime.groups.items()}
    path = killed.save_checkpoint(os.path.join(tmp.name, "buffered.ckpt"))
    del killed
    resumed = make(**BUFFERED_RUN)
    info = resumed.restore_checkpoint(path)
    resumed.run(BUFFERED_AGGREGATES - FLEET_KILL_AT)
    events = {c: sum(r[c] for r in whole.history)
              for c in ("dropped", "retried", "quarantined")}
    print(f"  18b killed after {FLEET_KILL_AT} aggregates with groups in "
          f"flight {groups} (unconsumed slots by group id); {info}; "
          f"events over {BUFFERED_AGGREGATES} aggregates {events}")
    if not groups:
        problems.append("18b: no group in flight at the kill")
    buffered_exact = held("18b buffered async resumed", whole, resumed)
    stats["buffered"] = dict(in_flight=groups, events=events,
                             bit_equal=buffered_exact)
    del whole, resumed
    gc.collect()
    stats["18b_s"] = time.perf_counter() - t0

    # ---- 18c: the hand-off to serving --------------------------------------
    if zoo:
        t0 = time.perf_counter()
        name, n_layers, seq_len = ZOO_PARENTS[0][:3]
        fam = train_family((cfg_of or get_config)(name), n_layers, seq_len)
        zcfg = fam.cfg
        sess = zoo_session(device, fam)
        rec = sess.run(1)[-1]
        specs = [TransformerSubSpec(tuple(tuple(l) for l in g[0]),
                                    g[1] / 100, g[2] / 100, g[3] / 100,
                                    g[4] / 100) for g in rec["specs"]]
        # serving: each client's spec, kernel path against dense path
        prompts = np.random.default_rng(SLICE["seed"]).integers(
            0, zcfg.vocab_size, (len(specs), SLICE["prompt_len"]))
        reqs = [Request(uid=i, spec=s, prompt=prompts[i],
                        max_new_tokens=SLICE["gen"])
                for i, s in enumerate(specs)]
        counters = path_counters(zcfg, serving=True)
        served = {}
        for backend in ("auto", None):
            server = sess.serving(slots=SLICE["slots"],
                                  prompt_len=SLICE["prompt_len"],
                                  max_new_tokens=SLICE["gen"],
                                  backend=backend, trace_logits=True)
            reset_launches(counters)
            sync(device)
            t = time.perf_counter()
            served[backend] = server.run(reqs)
            sync(device)
            secs = time.perf_counter() - t
            if backend == "auto":
                got = {c.__name__: c.launches for c in counters}
                by = check_variants(got, problems, "stream", "mma") \
                    if cuda else {}
                serve_s = secs
            del server
        launches["fleet zoo granite serving"] = got
        worst, same = 0.0, True
        for c, r in zip(served["auto"], served[None]):
            same = same and c.tokens == r.tokens
            for a, b in zip(c.logits, r.logits):
                worst = max(worst, float(np.max(np.abs(a - b)) /
                                         max(1.0, float(np.max(np.abs(b))))))
        print(f"  18c session.serving(): {len(reqs)} requests "
              f"({SLICE['gen']} tokens each) in {serve_s:.3f} s on the "
              f"kernels, launches {got}; kernel vs dense greedy tokens "
              f"{'identical' if same else 'DIFFER'}, max relative logit "
              f"err {worst:.3e} (tol {SLICE_LOGIT_RTOL:g})")
        if not same or not worst <= SLICE_LOGIT_RTOL:
            problems.append(f"18c serving: tokens identical {same}, logits "
                            f"{worst:.3e}")
        if cuda and not all(n > 0 for n in got.values()):
            problems.append(f"18c serving: launches {got}")
        # export -> load of the last EXPORT_CLIENTS clients' specs against
        # extract
        t = time.perf_counter()
        exported = []
        for i, spec in list(enumerate(specs))[-EXPORT_CLIENTS:]:
            p = os.path.join(tmp.name, f"client{i}.npz")
            meta = export_submodel(fam, sess.params, spec, p)
            sub, ctx, _ = load_submodel(fam, p, device=device)
            want, want_ctx = fam.extract(sess.params, spec)
            loaded = dict(named_leaves(sub))      # by path: the template
            d = [n for n, w in named_leaves(want)  # has its own key order
                 if not torch.equal(loaded[n], w)]
            exported.append(dict(mb=os.path.getsize(p) / 1e6,
                                 flops_fraction=meta["flops_fraction"],
                                 bit_equal=not d and ctx == want_ctx))
            if not exported[-1]["bit_equal"]:
                problems.append(f"18c export: client {i}'s submodel is not "
                                f"extract's ({d})")
            os.remove(p)
            os.remove(p + ".meta.json")
            del sub, want
        export_s = time.perf_counter() - t
        print(f"  18c export -> load of {len(exported)} submodel(s) in "
              f"{export_s:.1f} s: "
              + "; ".join(f"{e['mb']:.0f} MB flops {e['flops_fraction']:.3f}"
                          f" {'bit-equal' if e['bit_equal'] else 'DIFFER'}"
                          for e in exported))
        # distillation: the kernel teacher against the dense one
        spec = specs[-1]
        data = {"x": sess.client_data[0]["x"]}
        hists = {}
        dist = path_counters(zcfg)
        for backend in ("auto", None):
            reset_launches(dist)
            sync(device)
            t = time.perf_counter()
            _, _, hists[backend] = distill_to_spec(
                fam, sess.params, spec, data, steps=DISTILL_STEPS,
                kernels=kernel_dispatch(backend).table(fam.name))
            sync(device)
            if backend == "auto":
                dl = {c.__name__: c.launches for c in dist}
                distill_s = time.perf_counter() - t
        want = design_launches(n_layers, 0, DISTILL_STEPS)
        launches["fleet zoo granite distill"] = dl
        rel = max(abs(a - b) / abs(b) for a, b in zip(hists["auto"],
                                                       hists[None]))
        print(f"  18c distill_to_spec {DISTILL_STEPS} steps in "
              f"{distill_s:.3f} s: KL kernel teacher "
              f"{[round(h, 6) for h in hists['auto']]}, dense "
              f"{[round(h, 6) for h in hists[None]]}, max relative "
              f"{rel:.3e} (tol {DISTILL_RTOL:g}); launches {dl} (design "
              f"{want})")
        if not rel <= DISTILL_RTOL:
            problems.append(f"18c distill: KL relative {rel:.3e}")
        if cuda and dl != want:
            problems.append(f"18c distill: launches {dl}, design {want}")
        # the fused prefill against the stepwise decode (the dense path):
        # on the fp64 parent absolute, on the fp32 one relative
        toks = torch.as_tensor(prompts[:SLICE["slots"]], device=device)
        max_len = SLICE["prompt_len"] + SLICE["gen"]
        worst_prefill = check_prefill_parity(sess.params, zcfg, toks,
                                             max_len, tol=float("inf"))
        with torch.no_grad():
            logits, caches = T.prefill(sess.params, zcfg, toks, max_len)
            scale = max([1.0] + [float(t.abs().max()) for t in
                                 _leaves((logits, caches))])
            del logits, caches
            p64 = tree_map(lambda t: t.double(), sess.params)
        worst64 = check_prefill_parity(p64, zcfg, toks, max_len,
                                       tol=float("inf"))
        del p64
        rel_prefill = worst_prefill / scale
        print(f"  18c fused prefill vs stepwise decode: fp64 parent max|Δ| "
              f"{worst64:.3e} (tol {PREFILL_TOL:g}); fp32 parent max|Δ| "
              f"{worst_prefill:.3e} over max|value| {scale:.4f}: "
              f"{rel_prefill:.3e} (tol {PREFILL_TOL:g})")
        if not (worst64 <= PREFILL_TOL and rel_prefill <= PREFILL_TOL):
            problems.append(f"18c prefill parity: fp64 {worst64:.3e}, "
                            f"fp32 relative {rel_prefill:.3e}")
        stats["handoff"] = dict(
            serve_s=serve_s, tokens_identical=same, max_rel_logit=worst,
            serving_by_variant=by, export=exported, export_s=export_s,
            distill_s=distill_s, distill_rel=rel, distill_kl=hists["auto"],
            distill_launches=dl, prefill_max_abs=worst_prefill,
            prefill_rel=rel_prefill, prefill_fp64_max_abs=worst64)
        del sess
        gc.collect()
        stats["18c_s"] = time.perf_counter() - t0
    tmp.cleanup()
    stats["phase_seconds"] = time.perf_counter() - t_phase
    print(f"  phase 18: {stats['phase_seconds']:.1f} s (18a "
          f"{stats['18a_s']:.1f}, 18b {stats['18b_s']:.1f}"
          + (f", 18c {stats['18c_s']:.1f}" if zoo else "") + "); "
          + (card_line() if cuda else "no card"))
    if problems:
        raise PhaseError("; ".join(problems))
    return launches, stats


# ---------------------------------------------------------------------------
# phase 19: the CNN's RL gates and the zoo's LM training
# ---------------------------------------------------------------------------
# 19a, as benchmarks/fig7_gates.py runs the gates on the paper's CNN: a
# warm-up of soft steps at the worst quality, then sampled (REINFORCE) steps
# on the mixed-quality set
GATES = dict(n_images=4096, batch=64, lr=2e-3, penalty=0.15, warmup=50,
             rl=80, eval_images=256, qualities=(3, 0, 4), seed=0)
GATE_STEP_RTOL = 1e-5          # one gate step's update, card against the
                               # CPU, over its largest entry
# 19b: the reference's own example (launch/train.py) and gemma-7b, each cut
# to 2 layers; 3 steps of synthetic_lm_batches(cfg, 4, 256), adamw 3e-4
LM_MODELS = (("qwen3-4b", 2), ("gemma-7b", 2))
LM = dict(batch=4, seq=256, steps=3, lr=3e-4, weight_decay=0.01, seed=0)
LM_LOSS_RTOL = 1e-4            # each step's loss, kernel against dense path
LM_GRAD_RTOL = 1e-4            # step-1 gradients over each leaf's max |g|
REMAT_RTOL = 1e-6              # remat on against off, kernel path
MICRO_RTOL = 1e-5              # microbatch 2 against 1
BF16_LOSS_TOL = 2e-2           # a bf16 dense step's loss against fp32
# 19c: the two frontends, each cut to 2 layers: llava with 2880 image
# embeddings and 1216 tokens in one 4096-position sequence, hubert on 4 ×
# 512 frames (non-causal, head_dim 80)
FRONTENDS = (("llava-next-mistral-7b", 2, 1, 4096),
             ("hubert-xlarge", 2, 4, 512))
PREFILL_RTOL = 1e-3            # llava's last-position logits, kernel vs dense


def lm_design_launches(cfg, *, remat=False, microbatch=1,
                       forward_only=False):
    """K1–K4 launches of one ``loss_fn`` forward (and backward) of a dense
    parent with GQA attention and an MLP per block, as the code gives
    them: per layer K2 1 forward, K3 and K4 1 each backward; K1 3 forward
    (2 ungated) and 7 backward (5 ungated: dx and dw of each projection
    and the activated one's pre-activation recomputed). With ``remat``
    (``_cohort_stack``) every block's attention and FFN rerun once more in
    the backward (their inner checkpoint), and each layer group's forward
    once more — but torch's non-reentrant checkpoint stops a recompute at
    its last saved tensor, so the group's rerun leaves out the FFN of its
    last layer (its input is the group's last saved tensor). Times
    ``microbatch``."""
    from repro_torch.models.transformer import _remat_group
    n = sum(s.n_layers for s in cfg.segments)
    f, b = (3, 7) if cfg.mlp_gated else (2, 5)
    out = {"elastic_dense": n * f, "flash_attention": n}
    bwd = 0 if forward_only else n
    out["elastic_dense"] += b * bwd
    out.update(flash_attention_dq=bwd, flash_attention_dkv=bwd)
    if remat:
        g = _remat_group(n)
        out["elastic_dense"] += n * f + (n - n // g) * f
        out["flash_attention"] += 2 * n
    return {k: v * microbatch for k, v in out.items()}


def leaf_rel(got, want):
    """max over the leaves of max |got − want| / max |want| (a leaf that is
    0 in both counts 0)."""
    worst = 0.0
    for a, b in zip(_leaves(got), _leaves(want)):
        scale = float(b.abs().max())
        d = float((a.float() - b.float()).abs().max())
        worst = max(worst, d / scale if scale else (0.0 if d == 0 else
                                                    math.inf))
    return worst


def _to(tree, device):
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda t: t.detach().to(device), tree)


def phase_gates(device, cfg=None, settings=GATES):
    """19a: the paper's RL gates on ``PAPER_CNN`` (``cfg``) at full width
    and depth, as ``benchmarks/fig7_gates.py`` runs them on the
    reference. Holds, from the same initial state: one ``soft`` and one
    ``sample`` step (``make_gate_train_step`` with adamw, the sample step's
    uniforms given to both) on the card and on the CPU, the CPU replaying
    the card's ReLU decisions (``relu_decisions``): the step's update —
    adamw's first moment, 0.1 × the clipped gradient, which is an sgd
    step's movement over lr — within ``GATE_STEP_RTOL`` of its largest
    entry. (Adam's first update is ±lr wherever a gradient sits at
    rounding noise, and a parameter of magnitude ~0.3 rounds by ~1e-4 of
    this step's movement, so the parameters themselves are not the thing
    to hold.) Then ``train_gates``: the
    warm-up of soft steps at quality 3, the sampled steps on
    ``mixed_quality_dataset``, wall ms a step; with hard gates at each
    quality of ``qualities``: compute share, gated and ungated accuracy;
    ``gate_depth_policy``'s depth and rates; the hard gates' decisions on
    the trained state identical on the card and the CPU. Returns stats."""
    import torch
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core import (GateTrainConfig, gate_depth_policy,
                                  make_gate_train_step, train_gates)
    from repro_torch.data.loader import batches
    from repro_torch.data.quality import apply_quality, mixed_quality_dataset
    from repro_torch.data.synth import make_dataset
    from repro_torch.models import cnn
    from repro_torch.optim import adamw
    cfg = cfg or PAPER_CNN
    s = settings
    cpu = torch.device("cpu")
    problems, stats = [], {}
    data = make_dataset("synthcifar" if cfg.in_channels == 3
                        else "synthmnist", s["n_images"], seed=s["seed"])
    worst = dict(data, x=apply_quality(data["x"], 3))
    mixed = mixed_quality_dataset(data, seed=s["seed"])
    params0 = cnn.init_params(cfg, seed=s["seed"], device=device)

    # the held steps: card against CPU, from the same state
    batch = next(batches(worst, s["batch"], seed=s["seed"]))
    gen = torch.Generator().manual_seed(s["seed"] + 7)
    uniforms = [torch.rand((s["batch"],), generator=gen)
                for _ in range(cfg.n_blocks)]
    holds = {}
    for mode in ("soft", "sample"):
        out, flips = {}, 0
        for dev in dict.fromkeys((device, cpu)):
            opt = adamw(s["lr"])
            step = make_gate_train_step(cfg, opt, mode, s["penalty"])
            p = _to(params0, dev)
            draws = [u.to(dev) for u in uniforms] if mode == "sample" \
                else None
            if dev.type == "cuda":
                relus = relu_decisions()
                with relus("record"):
                    _, st, loss, _ = step(p, opt.init(p), batch, draws)
                relus.masks = [t.cpu() for t in relus.masks]
            elif device.type == "cuda":
                with relus("count"):
                    step(p, opt.init(p), batch, draws)
                flips = relus.flips()
                with relus("replay"):
                    _, st, loss, _ = step(p, opt.init(p), batch, draws)
            else:
                _, st, loss, _ = step(p, opt.init(p), batch, draws)
            out[dev.type] = (_to(st["m"], cpu), float(loss))
        got, want = out[device.type][0], out["cpu"][0]
        moved = max(float(t.abs().max()) for t in _leaves(want))
        ratio = max(float((a - b).abs().max()) for a, b in
                    zip(_leaves(got), _leaves(want))) / moved
        holds[mode] = dict(update_ratio=ratio, flips=flips,
                           loss=out["cpu"][1],
                           loss_diff=abs(out[device.type][1]
                                         - out["cpu"][1]))
        print(f"  19a {mode} step, card vs CPU (the CPU replaying the "
              f"card's ReLU decisions; {flips} taken the other way "
              f"free-running): the update (adamw's first moment, 0.1 x the "
              f"clipped gradient) {ratio:.3e} of its largest (tol "
              f"{GATE_STEP_RTOL:g}); loss {out['cpu'][1]:.6f}, "
              f"{holds[mode]['loss_diff']:.3e} apart")
        if not ratio <= GATE_STEP_RTOL:
            problems.append(f"19a {mode} step: {ratio:.3e} of the update")
    stats["held_steps"] = holds

    # Fig. 7: warm-up, then the hybrid RL phase on the mixed-quality set
    t = time.perf_counter()
    params, hist = train_gates(
        params0, cfg, batches(worst, s["batch"], seed=s["seed"]),
        GateTrainConfig(warmup_steps=s["warmup"], rl_steps=0, lr=s["lr"],
                        compute_penalty=s["penalty"]), seed=s["seed"])
    sync(device)
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    params, hist2 = train_gates(
        params, cfg, batches(mixed, s["batch"], seed=s["seed"] + 1),
        GateTrainConfig(warmup_steps=0, rl_steps=s["rl"], lr=s["lr"],
                        compute_penalty=s["penalty"]), seed=s["seed"])
    sync(device)
    rl_s = time.perf_counter() - t
    stats.update(warmup_ms_per_step=warm_s * 1e3 / max(s["warmup"], 1),
                 rl_ms_per_step=rl_s * 1e3 / max(s["rl"], 1),
                 warmup_final_acc=hist[-1]["acc"],
                 final_acc=hist2[-1]["acc"],
                 rl_compute_pct=hist2[-1]["compute_pct"])
    print(f"  19a train_gates: {s['warmup']} soft steps at quality 3 "
          f"{stats['warmup_ms_per_step']:.2f} ms a step (acc "
          f"{hist[-1]['acc']:.3f}), {s['rl']} sampled steps on the mixed "
          f"set {stats['rl_ms_per_step']:.2f} ms a step (acc "
          f"{hist2[-1]['acc']:.3f}, compute {hist2[-1]['compute_pct']:.3f})")
    n = s["eval_images"]
    per_q = {}
    with torch.no_grad():
        for q in s["qualities"]:
            x = torch.as_tensor(apply_quality(data["x"][:n], q)).to(device)
            y = torch.as_tensor(data["y"][:n]).to(device).long()
            logits, info = cnn.forward(params, cfg, x, gate_mode="hard")
            logits_u, _ = cnn.forward(params, cfg, x, gate_mode="off")
            per_q[q] = dict(
                compute_pct=float(info["compute_pct"]),
                gated_acc=float((logits.argmax(-1) == y).float().mean()),
                ungated_acc=float((logits_u.argmax(-1) == y).float().mean()))
            print(f"  19a quality {q}: compute {per_q[q]['compute_pct']:.3f}"
                  f", gated acc {per_q[q]['gated_acc']:.3f}, ungated acc "
                  f"{per_q[q]['ungated_acc']:.3f}")
            if q == 0:          # the hard decisions, card against CPU
                _, info_c = cnn.forward(_to(params, cpu), cfg, x.cpu(),
                                        gate_mode="hard")
                same = torch.equal(info["per_example_compute"].cpu(),
                                   info_c["per_example_compute"])
                print(f"  19a hard-gate decisions card vs CPU at quality 0: "
                      f"{'identical' if same else 'DIFFER'}")
                stats["hard_decisions_identical"] = same
                if not same:
                    problems.append("19a hard-gate decisions differ")
        depth, rates = gate_depth_policy(params, cfg,
                                         {"x": mixed["x"][:n]})
    print(f"  19a gate_depth_policy on {n} mixed images: depth {depth}, "
          f"rates {[round(r, 3) for r in rates]}")
    stats.update(per_quality=per_q, depth=list(depth), rates=rates)
    if problems:
        raise PhaseError("; ".join(problems))
    return stats


def _lm_batch(cfg, batch, seq, seed, device):
    """19c's batch of a frontend model: llava's image embeddings over the
    first ``frontend_tokens`` positions and tokens after them, hubert's
    frames and labels (loss mask all ones), from a numpy seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": torch.from_numpy(rng.standard_normal(
                    (batch, seq, cfg.d_model)).astype(np.float32)).to(device),
                "labels": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (batch, seq)).astype(np.int32))
                .to(device)}
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(device),
            "image_embeds": torch.from_numpy(rng.standard_normal(
                (batch, cfg.frontend_tokens, cfg.d_model))
                .astype(np.float32)).to(device)}


def _run_counted(fn, counters):
    """(fn's result, {kernel: launches of that call})."""
    reset_launches(counters)
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def _check_launches(label, got, want, problems):
    print(f"  {label} launches {got} (design {want})")
    if got != want:
        problems.append(f"{label}: launches {got}, design {want}")


def _step_timing(step_fn, device, tokens):
    """(wall ms, device ms) of one call of ``step_fn`` and tokens/s."""
    cuda = device.type == "cuda"
    sync(device)
    t = time.perf_counter()
    step_fn()
    sync(device)
    wall = (time.perf_counter() - t) * 1e3
    busy = step_device_ms(step_fn, device, steps=1)[0] if cuda else None
    return dict(wall_ms=wall, device_ms=busy,
                tokens_per_s=tokens / wall * 1e3)


def phase_lm_train(device, models=LM_MODELS, cfg_of=None, settings=LM):
    """19b: the LM train driver (``launch.train.synthetic_lm_batches``,
    ``launch.steps.make_train_step``) on each of ``models`` at published
    width, depth cut (``cut_depth``), fp32, the kernel path and the dense
    path (``kernels=None``) from the same torch-seeded parameters,
    ``steps`` steps each. Holds: each step's loss, kernel vs dense, within
    ``LM_LOSS_RTOL``; the step-1 gradients (adamw's first moments, 0.1 ×
    g) within ``LM_GRAD_RTOL`` of each leaf's max; remat on against off on
    the kernel path within ``REMAT_RTOL`` (bit-equal or not, printed) with
    the peak GiB of each; microbatch 2 against 1 within ``MICRO_RTOL``;
    one bf16 dense step's loss within ``BF16_LOSS_TOL`` of the fp32 loss.
    K1–K4 launch as ``lm_design_launches`` says (remat on in the main
    runs, the reference's default). Prints step wall and device ms,
    tokens/s and peak GiB. Returns ({run: launches}, stats)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import transformer as T
    cuda = device.type == "cuda"
    s = settings
    problems, launches, stats = [], {}, {}
    table = kernel_dispatch("auto").table("transformer")
    for name, n_layers in models:
        cfg = cfg_of(name) if cfg_of else cut_depth(get_config(name),
                                                    n_layers)
        label = name.split("-")[0]
        counters = path_counters(cfg)
        p0 = T.init_params(cfg, seed=s["seed"], device=device)
        data = synthetic_lm_batches(cfg, s["batch"], s["seq"], s["seed"],
                                    device=device)
        batches = [next(data) for _ in range(s["steps"])]
        tokens = s["batch"] * s["seq"]
        run = {}

        def steps(kernels, remat=True, microbatch=1, dtype=torch.float32,
                  n=s["steps"]):
            """(losses, step-1 first moments, peak GiB, launches of the
            steps) of ``n`` steps from p0."""
            step, opt = make_train_step(
                cfg, lr=s["lr"], weight_decay=s["weight_decay"],
                remat=remat, kernels=kernels, microbatch=microbatch,
                activation_dtype=dtype)
            p, st = p0, opt.init(p0)
            losses, m1 = [], None
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            reset_launches(counters)
            for i in range(n):
                p, st, m = step(p, st, batches[i])
                losses.append(float(m["loss"]))
                if i == 0:
                    m1 = st["m"]
            got = {c.__name__: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated(device) / 2**30 \
                if cuda else 0.0
            return losses, m1, peak, got, (step, opt)

        k_loss, k_m1, k_peak, k_launch, (k_step, k_opt) = steps(table)
        launches[f"lm {label} kernel"] = k_launch
        _check_launches(f"19b {label} kernel path, {s['steps']} steps "
                        "(remat)", k_launch, {n: v * s["steps"] for n, v in
                                              lm_design_launches(
                                                  cfg, remat=True).items()},
                        problems)
        run["kernel"] = dict(losses=k_loss, peak_gib=k_peak,
                             by_variant=check_variants(k_launch, problems,
                                                       "tile", "mma"))
        d_loss, d_m1, d_peak, _, (d_step, d_opt) = steps(None)
        run["dense"] = dict(losses=d_loss, peak_gib=d_peak)
        rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, d_loss))
        g_rel = leaf_rel(k_m1, d_m1)
        del d_m1
        print(f"  19b {label}: losses kernel {k_loss} dense {d_loss}: max "
              f"rel {rel:.3e} (tol {LM_LOSS_RTOL:g}); step-1 gradients "
              f"{g_rel:.3e} of each leaf's max (tol {LM_GRAD_RTOL:g})")
        if not (rel <= LM_LOSS_RTOL and g_rel <= LM_GRAD_RTOL):
            problems.append(f"19b {label}: loss {rel:.3e}, grads {g_rel:.3e}")
        # remat off (kernel path), microbatch 2, one bf16 dense step
        r_loss, r_m1, r_peak, r_launch, _ = steps(table, remat=False, n=1)
        launches[f"lm {label} kernel no remat"] = r_launch
        _check_launches(f"19b {label} kernel path, 1 step, remat off",
                        r_launch, lm_design_launches(cfg), problems)
        r_rel = leaf_rel(r_m1, k_m1)
        bit = all(torch.equal(a, b) for a, b in zip(_leaves(r_m1),
                                                    _leaves(k_m1)))
        del r_m1
        mb_loss, mb_m1, mb_peak, mb_launch, _ = steps(table, microbatch=2,
                                                      n=1)
        launches[f"lm {label} kernel microbatch 2"] = mb_launch
        _check_launches(f"19b {label} kernel path, 1 step, microbatch 2",
                        mb_launch, lm_design_launches(cfg, remat=True,
                                                      microbatch=2),
                        problems)
        mb_rel = leaf_rel(mb_m1, k_m1)
        del mb_m1, k_m1
        bf_loss, _, bf_peak, _, _ = steps(None, dtype=torch.bfloat16, n=1)
        bf_diff = abs(bf_loss[0] - d_loss[0])
        print(f"  19b {label}: remat on vs off step-1 gradients {r_rel:.3e} "
              f"(tol {REMAT_RTOL:g}; {'bit-equal' if bit else 'not bit-equal'}"
              f"), peak {k_peak:.2f} GiB on / {r_peak:.2f} off; microbatch 2 "
              f"vs 1 {mb_rel:.3e} (tol {MICRO_RTOL:g}), peak {mb_peak:.2f} "
              f"GiB; bf16 dense loss {bf_loss[0]:.5f} vs fp32 "
              f"{d_loss[0]:.5f}: {bf_diff:.3e} (tol {BF16_LOSS_TOL:g})")
        if not (r_rel <= REMAT_RTOL and mb_rel <= MICRO_RTOL
                and bf_diff <= BF16_LOSS_TOL):
            problems.append(f"19b {label}: remat {r_rel:.3e}, microbatch "
                            f"{mb_rel:.3e}, bf16 {bf_diff:.3e}")
        run.update(remat_off=dict(rel=r_rel, bit_equal=bit, peak_gib=r_peak),
                   microbatch2=dict(rel=mb_rel, peak_gib=mb_peak),
                   bf16=dict(loss=bf_loss[0], diff=bf_diff,
                             peak_gib=bf_peak))
        # timings: a kernel-path and a dense-path step (remat on)
        for path, (step, opt) in (("kernel", (k_step, k_opt)),
                                  ("dense", (d_step, d_opt))):
            st = opt.init(p0)
            t = _step_timing(lambda: step(p0, st, batches[0]), device,
                             tokens)
            run[path].update(t)
            print(f"  19b {label} {path} step: wall {t['wall_ms']:.1f} ms, "
                  f"device "
                  + ("-" if t["device_ms"] is None else
                     f"{t['device_ms']:.1f}") + f" ms, "
                  f"{t['tokens_per_s']:.0f} tok/s, peak "
                  f"{run[path]['peak_gib']:.2f} GiB")
            del st
        stats[label] = run
        del p0, batches, k_step, d_step
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return launches, stats


def phase_frontends(device, models=FRONTENDS, cfg_of=None):
    """19c: the input frontends at published width, depth cut: llava's
    image embeddings spliced over the first ``frontend_tokens`` positions,
    hubert's frames (encoder-only labels, non-causal, head_dim 80). For
    each: ``loss_fn`` kernel vs dense path (fp32) within ``LM_LOSS_RTOL``,
    the gradients within ``LM_GRAD_RTOL`` of each leaf's max, one
    ``make_train_step`` step on the kernel path; for llava also
    ``make_prefill_step``'s last-position logits kernel vs dense within
    ``PREFILL_RTOL`` of the largest. Launches as ``lm_design_launches``
    says. Returns ({run: launches}, stats)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import value_and_grad
    cuda = device.type == "cuda"
    problems, launches, stats = [], {}, {}
    table = kernel_dispatch("auto").table("transformer")
    for name, n_layers, B, S in models:
        cfg = cfg_of(name) if cfg_of else cut_depth(get_config(name),
                                                    n_layers)
        label = name.split("-")[0]
        counters = path_counters(cfg)
        params = T.init_params(cfg, seed=1, device=device)
        batch = _lm_batch(cfg, B, S, 2, device)
        res = {}
        for path, kernels in (("kernel", table), ("dense", None)):
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            sync(device)
            t = time.perf_counter()
            (loss, _, grads), got = _run_counted(
                lambda: value_and_grad(lambda p: T.loss_fn(
                    p, cfg, batch, kernels=kernels), params), counters)
            sync(device)
            ms = (time.perf_counter() - t) * 1e3
            res[path] = dict(loss=float(loss), grads=grads, ms=ms,
                             peak_gib=(torch.cuda.max_memory_allocated(
                                 device) / 2**30 if cuda else 0.0))
            if kernels is not None:
                launches[f"frontend {label} loss"] = got
                _check_launches(f"19c {label} loss_fn + grads (kernel path)",
                                got, lm_design_launches(cfg), problems)
            del loss, grads
        rel = abs(res["kernel"]["loss"] - res["dense"]["loss"]) \
            / abs(res["dense"]["loss"])
        g_rel = leaf_rel(res["kernel"]["grads"], res["dense"]["grads"])
        print(f"  19c {label} B={B} S={S}: loss kernel "
              f"{res['kernel']['loss']:.6f} dense {res['dense']['loss']:.6f}"
              f" rel {rel:.3e} (tol {LM_LOSS_RTOL:g}); gradients {g_rel:.3e}"
              f" of each leaf's max (tol {LM_GRAD_RTOL:g}); loss + grads "
              f"{res['kernel']['ms']:.1f} ms kernel / "
              f"{res['dense']['ms']:.1f} dense, peak "
              f"{res['kernel']['peak_gib']:.2f} / "
              f"{res['dense']['peak_gib']:.2f} GiB")
        if not (rel <= LM_LOSS_RTOL and g_rel <= LM_GRAD_RTOL):
            problems.append(f"19c {label}: loss {rel:.3e}, grads "
                            f"{g_rel:.3e}")
        for r in res.values():
            del r["grads"]
        # one train step on the kernel path (remat on, the default)
        step, opt = make_train_step(cfg, kernels=table,
                                    activation_dtype=torch.float32)
        st = opt.init(params)
        (p1, st, m), got = _run_counted(lambda: step(params, st, batch),
                                        counters)
        launches[f"frontend {label} step"] = got
        _check_launches(f"19c {label} make_train_step (kernel path, remat)",
                        got, lm_design_launches(cfg, remat=True), problems)
        finite = all(bool(torch.isfinite(t).all()) for t in _leaves(p1))
        res["step"] = dict(loss=float(m["loss"]), finite=finite,
                           **_step_timing(lambda: step(params, st, batch),
                                          device, B * S))
        print(f"  19c {label} train step: loss {res['step']['loss']:.6f}, "
              f"params finite {finite}, wall {res['step']['wall_ms']:.1f} ms"
              f", {res['step']['tokens_per_s']:.0f} tok/s")
        if not finite:
            problems.append(f"19c {label}: non-finite parameters")
        del p1, st, step, opt
        if cfg.frontend == "vision":
            out = {}
            for path, kernels in (("kernel", table), ("dense", None)):
                pre = make_prefill_step(cfg, kernels=kernels,
                                        activation_dtype=torch.float32)
                (out[path], got) = _run_counted(lambda: pre(params, batch),
                                                counters)
                if kernels is not None:
                    launches[f"frontend {label} prefill"] = got
                    _check_launches(f"19c {label} prefill (kernel path)",
                                    got, lm_design_launches(
                                        cfg, forward_only=True), problems)
            p_rel = float((out["kernel"] - out["dense"]).abs().max()
                          / out["dense"].abs().max())
            res["prefill_rel"] = p_rel
            print(f"  19c {label} make_prefill_step last-position logits "
                  f"kernel vs dense: {p_rel:.3e} of the largest (tol "
                  f"{PREFILL_RTOL:g})")
            if not p_rel <= PREFILL_RTOL:
                problems.append(f"19c {label} prefill: {p_rel:.3e}")
            del out
        stats[label] = res
        del params, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return launches, stats


def phase_lm(device, cnn_cfg=None, cfg_of=None, gates=GATES):
    """Phase 19: 19a ``phase_gates``, 19b ``phase_lm_train``, 19c
    ``phase_frontends``. Returns ({run: launches}, stats)."""
    import torch
    t0 = time.perf_counter()
    stats = {"gates": phase_gates(device, cnn_cfg, gates)}
    stats["19a_s"] = time.perf_counter() - t0
    launches, stats["lm"] = phase_lm_train(device, cfg_of=cfg_of)
    stats["19b_s"] = time.perf_counter() - t0 - stats["19a_s"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fl, stats["frontends"] = phase_frontends(device, cfg_of=cfg_of)
    launches.update(fl)
    stats["phase_seconds"] = time.perf_counter() - t0
    stats["19c_s"] = stats["phase_seconds"] - stats["19a_s"] \
        - stats["19b_s"]
    print(f"  phase 19: {stats['phase_seconds']:.1f} s (19a "
          f"{stats['19a_s']:.1f}, 19b {stats['19b_s']:.1f}, 19c "
          f"{stats['19c_s']:.1f}); "
          + (card_line() if device.type == "cuda" else "no card"))
    return launches, stats


def without_arch(settings):
    return {k: v for k, v in settings.items() if k != "arch"}


# ---------------------------------------------------------------------------
# phase 20: the tile-accounting gate
# ---------------------------------------------------------------------------
def phase_gate(device):
    """The tile-accounting gate (``repro_torch.launch.elastic_kernels``) on
    the card: for every row set (the reference's bench shapes, the main
    widths, the dispatch at the main path's capacity) and fraction, the
    counted kernels' tiles and DMA blocks against the host model, parity
    against the plain version in fp64, fast and dense-masked times and
    their shares; counters against the model at the edges (prefix 0,
    ragged per-group prefixes that differ, shapes that are not tile
    multiples, every variant); then ``gate_elastic_rows`` on the bench and
    main sets. Any mismatch or gate failure raises. Returns the stats."""
    from repro_torch.kernels import build
    from repro_torch.launch import elastic_kernels as ek
    t0 = time.perf_counter()
    rows, fails = ek.run_card(device)
    seconds = time.perf_counter() - t0
    counted = {k: round(v, 1) for k, v in build.build_seconds.items()
               if k.endswith("_counted")}
    gated = [r for r in rows if r["set"] in ek.GATED
             and r["kernel_path"] == "tile-skipping"]
    shares = {f"{r['set']} {r['op']}/{r['pass']}@{r['frac']:g}":
              round(r["share"], 3) for r in rows
              if r["kernel_path"] == "tile-skipping" and r["frac"] < 1}
    stats = dict(seconds=seconds, rows=len(rows), gated_rows=len(gated),
                 worst_err=max(r["max_err"] for r in gated),
                 counted_build_s=counted, failures=fails, shares=shares)
    print(f"  counted builds, seconds from their start: {counted}")
    print(f"  gate {'FAIL' if fails else 'PASS'}: {len(gated)} gated "
          f"tile-skipping rows of {ek.GATED}, counters == model at every "
          f"row and edge: {not any('counted' in f for f in fails)}, worst "
          f"max_err {stats['worst_err']:.2e}; {seconds:.1f} s")
    if fails:
        raise PhaseError("tile-accounting gate: " + "; ".join(fails))
    return stats


# ---------------------------------------------------------------------------
# phase 21: cohort sharding over a process group (A17)
# ---------------------------------------------------------------------------
# (case, parent, layers, clients, tokens a sequence): the paper's CNN at
# full width and depth (K1 through B2), granite-moe at 2 layers (K2–K7)
# and mamba2 at 2 layers on 512-token sequences (K8, K9), full width
COHORT_CASES = (("cnn", "paper-elastic-cnn", None, 8, None),
                ("moe", "granite-moe-1b-a400m", 2, 4, 128),
                ("ssm", "mamba2-2.7b", 2, 4, 512))
COHORT_RTOL = 1e-5             # the sharded aggregate against the flat one
                               # on the same deltas, over the movement


def cohort_case(case, device, cfg_of=None):
    """The inputs of one phase-21 round, the same in every process: (family,
    parameters, train sets, test sets, specs, seeds, sizes, batch). The CNN
    takes ``CNN_SLICE``'s synthetic CIFAR population (100 samples a
    client) and random specs of its elastic grid; a zoo parent the
    training slice's data and specs (``train_specs``) at its depth."""
    import random
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core.elastic import family_for
    from repro_torch.data.synth import make_lm_dataset
    from repro_torch.fl.rounds import build_population
    label, arch, layers, clients, seq = case
    cfg = cfg_of(arch) if cfg_of is not None else (
        PAPER_CNN if label == "cnn" else get_config(arch))
    if label == "cnn":
        fam = family_for(cfg)
        _, train, test = build_population(
            fam, kind=CNN_SLICE["kind"], n_workers=clients,
            n_samples=100 * clients, heterogeneity="quality", seed=0)
        specs = [fam.random_spec(random.Random(k)) for k in range(clients)]
        batch = CNN_BATCH
    else:
        fam = train_family(cfg, layers, seq_len=seq)
        cfg = fam.cfg
        train = [make_lm_dataset(TRAIN["train_seqs"], seq, cfg.vocab_size,
                                 seed=k, chain_seed=1000 + k)
                 for k in range(clients)]
        test = [make_lm_dataset(TRAIN["test_seqs"], seq, cfg.vocab_size,
                                seed=50 + k, chain_seed=1000 + k)
                for k in range(clients)]
        specs = train_specs(fam)[:clients]
        batch = TRAIN["batch"]
    params = fam.init_params(seed=0, device=device)
    return (fam, params, train, test, specs, list(range(7, 7 + clients)),
            [float(len(d["y"])) for d in train], batch)


def tree_digest(tree):
    """sha256 of a tree's tensors' bytes, leaf by leaf (host copies)."""
    import hashlib
    from repro_torch.optim.optimizers import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


class ReduceClock:
    """Wraps ``torch.distributed.all_reduce`` while entered: each call's
    bytes and ms (the card synchronised around it)."""

    def __init__(self, device):
        self.device, self.calls = device, []

    def __enter__(self):
        import torch.distributed as dist
        self._real = dist.all_reduce

        def timed(tensor, *a, **kw):
            sync(self.device)
            t = time.perf_counter()
            out = self._real(tensor, *a, **kw)
            sync(self.device)
            self.calls.append((tensor.numel() * tensor.element_size(),
                               (time.perf_counter() - t) * 1e3))
            return out
        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce = self._real


def cohort_rank(rank, cases, out_dir, device, threads, cfg_of=None):
    """One rank of phase 21: for each case a warm-up round, then one timed
    sharded round through ``run_fl_round`` with the launches counted from
    0 just before it and the all-reduce timed; then the sharded
    ``train_cohort`` again for the digests of this rank's block. Rank 0
    saves each round's new parameters under ``out_dir``."""
    import torch
    from repro_torch.fl.engine import BatchedRoundEngine
    from repro_torch.kernels.backend import resolve_device
    if device == "cpu":         # a CPU rehearsal: the caller's threads
        torch.set_num_threads(threads)
    device = resolve_device("cpu" if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device()))
    out = {}
    for case in cases:
        fam, params, train, test, specs, seeds, sizes, batch = \
            cohort_case(case, device, cfg_of)
        eng = BatchedRoundEngine(fam, lr=0.05, momentum=0.9,
                                 cohort_shards=2, device=device)
        kw = dict(batch_size=batch, epochs=1, seeds=seeds)
        eng.run_fl_round(params, specs, train, test, sizes, **kw)  # warm-up
        counters = cohort_counters(case, fam)
        reset_launches(counters)
        sync(device)
        t = time.perf_counter()
        with ReduceClock(device) as clock:
            new, accs, steps = eng.run_fl_round(params, specs, train, test,
                                                sizes, **kw)
        sync(device)
        wall = time.perf_counter() - t
        launches = {c.__name__: c.launches for c in counters}
        res = eng.train_cohort(eng.broadcast_params(params, len(specs)),
                               specs, train, eval_datasets=test, **kw)
        if rank == 0:
            torch.save([t.cpu() for t in _leaves(new)],
                       os.path.join(out_dir, f"{case[0]}.pt"))
        out[case[0]] = dict(
            wall_s=wall, launches=launches, block=list(res.block),
            shards=eng.cohort_sharding(len(specs)).mesh.n_shards,
            all_reduce=[dict(bytes=b, ms=ms) for b, ms in clock.calls],
            deltas=tree_digest(res.deltas), trained=tree_digest(res.trained),
            accs_block=[float(a) for a in res.accs],
            accs=[float(a) for a in accs], n_steps=[int(n) for n in steps],
            params=tree_digest(new))
        del eng, new, res
        gc.collect()
    return out


def cohort_counters(case, fam):
    """The kernel wrappers a phase-21 case's path must launch."""
    from repro_torch.kernels.elastic_matmul import elastic_dense
    return (elastic_dense,) if case[0] == "cnn" else path_counters(fam.cfg)


def cohort_rank_unsharded_twin(rank, case, shards, device="cuda",
                               cfg_of=None):
    """One rank of an NCCL group (a card a rank): the round sharded
    ``shards`` ways (the hierarchical aggregate over the group; ranks past
    the effective shard count idle) and the unsharded engine's round on
    the same inputs. Returns both parameters' digests, whether the
    accuracies agree, the sharded round's distance from the unsharded one
    over the movement, and the mesh."""
    import torch
    from repro_torch.fl.engine import BatchedRoundEngine
    from repro_torch.kernels.backend import resolve_device
    device = resolve_device("cpu" if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device()))
    fam, params, train, test, specs, seeds, sizes, batch = \
        cohort_case(case, device, cfg_of)
    kw = dict(batch_size=batch, epochs=1, seeds=seeds)
    runs, timing = {}, {}
    for n in (shards, 1):
        eng = BatchedRoundEngine(fam, lr=0.05, momentum=0.9,
                                 cohort_shards=n, device=device)
        eng.run_fl_round(params, specs, train, test, sizes, **kw)  # warm
        sync(device)
        t = time.perf_counter()
        with ReduceClock(device) as clock:
            runs[n] = eng.run_fl_round(params, specs, train, test, sizes,
                                       **kw)
        sync(device)
        timing[n] = dict(wall_s=time.perf_counter() - t,
                         all_reduce=[dict(bytes=b, ms=ms)
                                     for b, ms in clock.calls])
        sh = eng.cohort_sharding(len(specs))
        if n == shards:
            mesh = None if sh is None else dict(
                shards=sh.mesh.n_shards, world=sh.mesh.world,
                backend=sh.mesh.backend, block=list(eng.block(len(specs))))
    ratio, _, moved = move_ratio(runs[shards][0], runs[1][0], params)
    return dict(sharded=tree_digest(runs[shards][0]),
                unsharded=tree_digest(runs[1][0]),
                accs_equal=runs[shards][1] == runs[1][1], ratio=ratio,
                moved=moved, mesh=mesh, timing=timing)


def nccl_checks(case, cfg_of, problems, n_cards=None):
    """``case``'s round over NCCL, a card a rank: at world size 1 the
    sharded engine must give the unsharded engine's round to the bit; on
    two cards (and on four: sharded 4 ways, and 2 ways with two ranks
    idle) every rank's parameters must be bit-equal, their distance from
    the unsharded round printed. Groups past the card count are printed as
    not run. Returns the readings."""
    import torch
    from repro_torch.sharding.cohort import spawn_cohort
    n_cards = torch.cuda.device_count() if n_cards is None else n_cards
    out = {}
    for world, shards in ((1, 2), (2, 2), (4, 4), (4, 2)):
        label = f"world {world}, {shards} shards requested"
        if world > n_cards:
            print(f"  NCCL {label}: not run ({n_cards} card"
                  f"{'' if n_cards == 1 else 's'})")
            out[label] = f"not run: {n_cards} card(s)"
            continue
        ranks = spawn_cohort(cohort_rank_unsharded_twin, world,
                             backend="nccl", device="cuda",
                             args=(case, shards, "cuda", cfg_of),
                             timeout=600)
        r0 = ranks[0]
        same_ranks = all(r["sharded"] == r0["sharded"] for r in ranks)
        exact = r0["sharded"] == r0["unsharded"] and r0["accs_equal"]
        walls = [round(r["timing"][shards]["wall_s"], 4) for r in ranks]
        reduce_ms = [[round(c["ms"], 3) for c in
                      r["timing"][shards]["all_reduce"]] for r in ranks]
        print(f"  NCCL {label} ({case[0]}): mesh {r0['mesh']}; ranks' "
              f"parameters bit-equal {same_ranks}; against the unsharded "
              f"round: bit-equal {exact}, {r0['ratio']:.3e} of the "
              f"movement {r0['moved']:.3e}"
              + (" (world 1: must be bit-equal)" if world == 1 else
                 " (not held: another G)")
              + f"; round walls {walls} s (unsharded "
              f"{r0['timing'][1]['wall_s']:.4f}), all-reduce ms {reduce_ms}"
              f" of {[c['bytes'] for c in r0['timing'][shards]['all_reduce']]}"
              f" bytes")
        out[label] = dict(ranks_bit_equal=same_ranks, bit_equal=exact,
                          ratio=r0["ratio"], mesh=r0["mesh"],
                          blocks=[r["mesh"]["block"] for r in ranks],
                          timing=[r["timing"] for r in ranks])
        if not same_ranks or r0["mesh"] is None:
            problems.append(f"NCCL {label}: the ranks differ or no mesh")
        if world == 1 and not exact:
            problems.append("NCCL world size 1: not the unsharded round "
                            "to the bit")
    return out


def phase_cohort(device, cases=COHORT_CASES, cfg_of=None):
    """Phase 21: cohort sharding (``repro_torch.sharding.cohort``) through
    ``BatchedRoundEngine.run_fl_round`` on 2 ranks started by
    ``spawn_cohort``, both on the one card over an explicit gloo group
    (NCCL puts one rank a card), for each case of ``cases``. Held against
    this process's unsharded engine on the same inputs: each rank's block
    (its deltas, trained parameters and accuracies) bit-equal to an
    unsharded run of that block alone (the same G, the same kernel plans);
    the sharded round's new parameters (the hierarchical aggregate: one
    all-reduce) within ``COHORT_RTOL`` of the round's movement of the flat
    ``aggregate_apply`` of the same blocks; both ranks' parameters
    bit-equal; every kernel of the case's path launched on each rank. The
    unsharded round of the whole cohort is run and its distance printed
    (another G: another plan and order of summation; a ReLU or a route can
    take the other side). Then ``nccl_checks``: a 1-rank NCCL group's
    sharded round bit-equal to the unsharded engine's; the CNN round over
    NCCL on two and four cards where there are that many, else printed as
    not run. Returns ({run: launches}, stats)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.aggregate import aggregate_apply
    from repro_torch.fl.engine import BatchedRoundEngine
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.sharding.cohort import spawn_cohort
    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="cohort_")
    problems, launches, stats = [], {}, {"cases": {}}
    try:
        ranks = spawn_cohort(cohort_rank, 2, backend="gloo",
                             device="cuda" if cuda else "cpu",
                             args=(cases, tmp, device.type,
                                   torch.get_num_threads(), cfg_of),
                             timeout=900)
        stats["spawn_s"] = time.perf_counter() - t0
        for case in cases:
            label = case[0]
            r0, r1 = (r[label] for r in ranks)
            fam, params, train, test, specs, seeds, sizes, batch = \
                cohort_case(case, device, cfg_of)
            kw = dict(batch_size=batch, epochs=1)
            eng = BatchedRoundEngine(fam, lr=0.05, momentum=0.9,
                                     device=device)
            blocks = []
            for r in (r0, r1):
                lo, hi = r["block"]
                blocks.append(eng.train_cohort(
                    eng.broadcast_params(params, hi - lo), specs[lo:hi],
                    train[lo:hi], eval_datasets=test[lo:hi],
                    seeds=seeds[lo:hi], **kw))
            alone = [dict(deltas=tree_digest(b.deltas),
                          trained=tree_digest(b.trained),
                          accs=[float(a) for a in b.accs]) for b in blocks]
            same_blocks = all(
                r["deltas"] == a["deltas"] and r["trained"] == a["trained"]
                and r["accs_block"] == a["accs"]
                for r, a in zip((r0, r1), alone))
            with torch.no_grad():
                flat = aggregate_apply(
                    params, tree_map(lambda a, b: torch.cat([a, b]),
                                     blocks[0].deltas, blocks[1].deltas),
                    None, torch.as_tensor(sizes, device=device))
            got = [t.to(device) for t in torch.load(
                os.path.join(tmp, f"{label}.pt"))]
            ratio, _, moved = move_ratio(got, flat, params)
            del flat, blocks
            full, full_accs, _ = eng.run_fl_round(
                params, specs, train, test, sizes, seeds=seeds, **kw)
            free = move_ratio(got, full, params)[0]
            del full, got
            bytes_ = [c["bytes"] for c in r0["all_reduce"]]
            print(f"  {label} ({fam.cfg.name}, {len(specs)} clients, "
                  f"blocks {r0['block']} / {r1['block']}): rank walls "
                  f"{r0['wall_s']:.3f} / {r1['wall_s']:.3f} s; all-reduce "
                  f"{len(bytes_)} call(s), {sum(bytes_) / 2**20:.2f} MiB, "
                  f"ms rank 0 {[round(c['ms'], 3) for c in r0['all_reduce']]}"
                  f" / rank 1 {[round(c['ms'], 3) for c in r1['all_reduce']]}"
                  f"; launches rank 0 {r0['launches']}, rank 1 "
                  f"{r1['launches']}")
            print(f"  {label}: blocks bit-equal to each block run alone "
                  f"{same_blocks}; ranks' parameters bit-equal "
                  f"{r0['params'] == r1['params']}; aggregate against the "
                  f"flat aggregate of the same blocks {ratio:.3e} of the "
                  f"movement {moved:.3e} (tol {COHORT_RTOL:g}); against the "
                  f"unsharded round of the whole cohort {free:.3e} (not "
                  f"held: another G); accuracies {r0['accs']} (unsharded "
                  f"{[round(a, 6) for a in full_accs]})")
            if not same_blocks:
                problems.append(f"{label}: a block differs from its block "
                                f"run alone")
            if r0["params"] != r1["params"]:
                problems.append(f"{label}: the ranks' parameters differ")
            if not (ratio <= COHORT_RTOL and math.isfinite(ratio)):
                problems.append(f"{label}: the sharded aggregate is "
                                f"{ratio:.3e} of the movement from the "
                                f"flat one")
            if len(bytes_) != 1:
                problems.append(f"{label}: {len(bytes_)} all-reduces in a "
                                f"round")
            if r0["shards"] != 2 or r1["shards"] != 2:
                problems.append(f"{label}: not 2 shards")
            for r, rk in enumerate((r0, r1)):
                launches[f"cohort {label} rank {r}"] = rk["launches"]
                if cuda:
                    missing = [k for k, v in rk["launches"].items() if v == 0]
                    if missing:
                        problems.append(f"{label} rank {r}: no launch of "
                                        f"{missing}")
            stats["cases"][label] = dict(
                ranks=[dict(wall_s=rk["wall_s"], launches=rk["launches"],
                            all_reduce=rk["all_reduce"], block=rk["block"])
                       for rk in (r0, r1)],
                blocks_bit_equal=same_blocks,
                ranks_bit_equal=r0["params"] == r1["params"],
                aggregate_ratio=ratio, unsharded_ratio=free, moved=moved)
            del eng
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        if cuda:
            stats["nccl"] = nccl_checks(cases[0], cfg_of, problems)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats["phase_seconds"] = time.perf_counter() - t0
    print(f"  phase 21: {stats['phase_seconds']:.1f} s (the 2-rank spawn "
          f"{stats.get('spawn_s', 0.0):.1f}); "
          + (card_line() if cuda else "no card"))
    if problems:
        raise PhaseError("cohort sharding: " + "; ".join(problems))
    return launches, stats


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a kill
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import resolve_device

    t_start = time.perf_counter()
    phase_s, mark = {}, [t_start]

    def done(name):
        """Print and keep the seconds since the last phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print(f"  phase {name}: {phase_s[name]:.1f} s")

    device = resolve_device("cuda")
    card = card_line()
    print("== 1. device")
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} sm_"
          f"{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        print("chip_smoke: the kernels are built for sm_90a", file=sys.stderr)
        return 1

    print("== 2. build")
    done("1")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built in {time.perf_counter() - t0:.1f} s "
          f"(per source: {build.build_seconds})")
    for name in build.SOURCES:
        for line in ptxas_summary(build.build_log(name)):
            print(f"  {name}: {line}")
    done("2")

    cfg = get_config(SLICE["arch"])
    dims = dict(d_model=cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                slots=SLICE["slots"], prompt_len=SLICE["prompt_len"])
    tdims = dict(clients=TRAIN["clients"], rows=TRAIN["batch"],
                 seq=TRAIN["seq_len"])
    tpre = train_prefixes(train_family(cfg, TRAIN["n_layers"]))
    mcfg = get_config(MOE_SLICE["arch"])
    mpre = train_prefixes(train_family(mcfg, MOE_TRAIN["n_layers"]))
    mdims = dict(d_model=mcfg.d_model, d_ff=mcfg.moe.d_ff_expert,
                 n_experts=mcfg.moe.n_experts, top_k=mcfg.moe.top_k,
                 n_heads=mcfg.n_heads, n_kv=mcfg.n_kv_heads,
                 head_dim=mcfg.head_dim, clients=MOE_TRAIN["clients"],
                 rows=MOE_TRAIN["batch"], seq=MOE_TRAIN["seq_len"],
                 slots=MOE_SLICE["slots"], experts=mpre["experts"])
    scfg = get_config(SSM_SLICE["arch"])
    spre = train_prefixes(train_family(scfg, SSM_TRAIN["n_layers"]))
    sdims = dict(d_model=scfg.d_model, head_dim=scfg.ssm.head_dim,
                 d_state=scfg.ssm.d_state, clients=SSM_TRAIN["clients"],
                 rows=SSM_TRAIN["batch"], seq=SSM_TRAIN["seq_len"],
                 chunk=scfg.ssm.chunk, heads=spre["heads"],
                 prompt_len=SSM_SLICE["prompt_len"])

    def release():                   # the last phase's models leave the card
        gc.collect()
        torch.cuda.empty_cache()
    try:
        print("== 3. kernels against their plain versions")
        worst = phase_kernels(device, **dims, **tdims, **tpre)
        done("3")
        print("== 3b. MoE kernels against their plain versions (K5, K6, K7; "
              "K2-K4 at head_dim 64)")
        mworst = phase_moe_kernels(device, tokens=mdims["rows"] *
                                   mdims["seq"], heads=mpre["heads"],
                                   **mdims)
        done("3b")
        print("== 3c. SSD kernels against their plain versions (K8, K9)")
        sworst = phase_ssd_kernels(device, **sdims)
        done("3c")
        print("== 3d. CNN convolutions against their plain versions (K1 "
              "through elastic_conv2d)")
        cworst = phase_cnn_kernels(device, PAPER_CNN, CNN_SLICE["n_workers"],
                                   CNN_BATCH)
        release()
        done("3d")
        print("== 3e. the last three decoder parents' kernel shapes: K2-K4 "
              "at head_dim 256 (gemma2-9b, gemma-7b), K6 / K7 at top 6 "
              "(deepseek-v2-lite-16b), K8 / K9 at d_state 64 (zamba2-1.2b), "
              "against their plain versions and timed")
        a11_worst, a11_times = phase_a11_kernels(
            device, get_config("gemma2-9b"), get_config("gemma-7b"),
            get_config("deepseek-v2-lite-16b"), get_config("zamba2-1.2b"))
        release()
        done("3e")
        print("== 3f. K2-K4 at head_dim 80 (hubert-xlarge's training "
              "attention, non-causal), against their plain versions and "
              "timed")
        d80_worst, d80_times = phase_d80_kernels(
            device, get_config("hubert-xlarge"))
        release()
        done("3f")
        print("== 4. times: serving shapes")
        times = phase_times(device, **dims)
        done("4")
        print("== 5. slice: granite-3-8b serving, full width and depth, "
              "fp32")
        launches, stats = phase_slice(device, cfg, **without_arch(SLICE))
        release()
        done("5")
        print("== 6. times: training shapes")
        train_times = phase_train_times(
            device, **{k: v for k, v in dims.items()
                       if k not in ("slots", "prompt_len")}, **tdims)
        done("6")
        print(f"== 7. slice: granite-3-8b training, full width, "
              f"{TRAIN['n_layers']} layers, {TRAIN['clients']} clients, "
              f"{TRAIN['rounds']} CFL rounds, fp32")
        train_launches, train_stats = phase_train(device, cfg, **TRAIN)
        release()
        done("7")
        print("== 8. times: MoE shapes")
        moe_times = phase_moe_times(device, **mdims)
        release()
        done("8")
        print(f"== 9. slice: granite-moe-1b-a400m training, full width, "
              f"{MOE_TRAIN['n_layers']} layers, {MOE_TRAIN['clients']} "
              f"clients, {MOE_TRAIN['rounds']} CFL rounds, fp32")
        moe_train_launches, moe_train_stats = phase_train(device, mcfg,
                                                          **MOE_TRAIN)
        release()
        done("9")
        print("== 10. slice: granite-moe-1b-a400m serving, full width and "
              "depth, fp32")
        moe_launches, moe_stats = phase_slice(device, mcfg,
                                              **without_arch(MOE_SLICE))
        release()
        done("10")
        print("== 11. times: SSM shapes")
        ssm_times = phase_ssd_times(device, **sdims)
        release()
        done("11")
        print(f"== 12. slice: mamba2-2.7b training, full width, "
              f"{SSM_TRAIN['n_layers']} layers, {SSM_TRAIN['clients']} "
              f"clients, {SSM_TRAIN['rounds']} CFL rounds, fp32")
        ssm_train_launches, ssm_train_stats = phase_train(device, scfg,
                                                          **SSM_TRAIN)
        release()
        done("12")
        print(f"== 13. slice: mamba2-2.7b serving, full width, "
              f"{SSM_SERVE_LAYERS} of its 64 layers, fp32")
        ssm_launches, ssm_stats = phase_slice(
            device, cut_depth(scfg, SSM_SERVE_LAYERS),
            **without_arch(SSM_SLICE))
        release()
        done("13")
        print(f"== 14. slice: {PAPER_CNN.name} sessions of CFL, FedAvg and "
              f"IL (and CFL on the sequential trainer), full width and "
              f"depth, {CNN_SLICE['n_workers']} clients, "
              f"{CNN_SLICE['rounds']} sync rounds, fp32")
        cnn_launches, cnn_stats = phase_cnn(device, **CNN_SLICE)
        release()
        done("14")
        print("== 14a. times: CNN shapes")
        cnn_times = phase_cnn_times(
            device, PAPER_CNN, CNN_SLICE["n_workers"], CNN_BATCH,
            cnn_stats["steps_per_round"][0])
        release()
        done("14a")
        print(f"== 15. CFLSession on the transformer zoo: granite-3-8b "
              f"(CFL {ZOO_PARENTS[0][3]} rounds, FedAvg, IL, the sequential "
              f"trainer), granite-moe-1b-a400m and mamba2-2.7b (CFL and the "
              f"sequential trainer), full width, {ZOO['n_workers']} "
              f"clients, fp32")
        zoo_launches, zoo_stats = phase_zoo(device)
        release()
        done("15")
        print(f"== 16. partial participation, the selection policies and "
              f"async buffered rounds with faults: {PAPER_CNN.name} CFL "
              f"({', '.join(SELECT_POLICIES)}; async at the sync point; "
              f"buffered async), FedAvg (fairness), granite-3-8b CFL "
              f"(uniform), fp32")
        sel_launches, sel_stats = phase_selection(device)
        release()
        done("16")
        print("== 17. the last three decoder parents: EdgeServer on "
              "gemma2-9b (10 pairs), zamba2-1.2b (14 layers) and "
              "deepseek-v2-lite-16b (its dense layer and 8 MoE layers), "
              "then CFLSession on each at published width (gemma2 one "
              "pair, deepseek its dense and one MoE layer, 2 clients; "
              "zamba2 two segments and the shared block, 4 clients), fp32")
        a11_launches, a11_stats = {}, {}
        for name, depth in A11_SLICES:
            pcfg = get_config(name) if depth is None else \
                cut_depth(get_config(name), depth)
            label = name.split("-")[0]
            print(f"  -- {label} serving: {pcfg.n_layers} layers")
            a11_launches[f"{label} serving"], a11_stats[f"{label} serving"] \
                = phase_slice(device, pcfg, **without_arch(SLICE),
                              profiled=("kernel",))
            release()
        zl, zs = phase_zoo(device, A11_PARENTS, phase="17")
        a11_launches.update({f"{run}": c for run, c in zl.items()})
        a11_stats["zoo"] = zs
        release()
        done("17")
        print(f"== 18. fleet checkpoints and the overlap ring: "
              f"{PAPER_CNN.name} CFL sync killed after round 1 and resumed, "
              f"and with the prefetch ring on, against {FLEET_ROUNDS} "
              f"uninterrupted rounds; buffered async with faults killed "
              f"with groups in flight; then granite-3-8b's hand-off to "
              f"serving: session.serving(), export / load, distillation "
              f"and the prefill parity, fp32")
        fleet_launches, fleet_stats = phase_fleet(device)
        release()
        done("18")
        print(f"== 19. the CNN's RL gates and the zoo's LM training: "
              f"train_gates on {PAPER_CNN.name} (Fig. 7); the train driver "
              f"on {', '.join(n for n, _ in LM_MODELS)} "
              f"({LM_MODELS[0][1]} layers, kernel and dense paths); the "
              f"llava and hubert frontends, fp32")
        lm_launches, lm_stats = phase_lm(device)
        release()
        done("19")
        print("== 20. the tile-accounting gate: the counted kernels' tiles "
              "and DMA blocks against the host model, parity, times and "
              "shares over the width (bench shapes, main widths), the "
              "edges, gate_elastic_rows")
        gate_stats = phase_gate(device)
        release()
        done("20")
        print("== 21. cohort sharding: run_fl_round on 2 ranks (one card, "
              "gloo) for the paper's CNN (8 clients), granite-moe-1b-a400m "
              "and mamba2-2.7b (2 layers, 4 clients), full width, against "
              "the unsharded engine; NCCL at world size 1")
        cohort_launches, cohort_stats = phase_cohort(device)
        release()
        done("21")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "elastic_dense": dict(
            source="src/repro_torch/csrc/elastic_dense.cu",
            replaces="src/repro/kernels/elastic_matmul.py:103"),
        "flash_attention": dict(
            source="src/repro_torch/csrc/flash_attention_fwd.cu",
            replaces="src/repro/kernels/flash_attention.py:107"),
        "flash_attention_dq": dict(
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention.py:273"),
        "flash_attention_dkv": dict(
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention.py:309"),
        "grouped_matmul": dict(
            source="src/repro_torch/csrc/grouped_matmul.cu",
            replaces="src/repro/kernels/grouped_matmul.py:35"),
        "gather_rows": dict(
            source="src/repro_torch/csrc/moe_dispatch.cu",
            replaces="src/repro/kernels/moe_dispatch.py:47"),
        "gather_dot": dict(       # K6's gather fused with the VJP's einsum
            source="src/repro_torch/csrc/moe_dispatch.cu",
            replaces="src/repro/kernels/moe_dispatch.py:47"),
        "gather_reduce": dict(
            source="src/repro_torch/csrc/moe_dispatch.cu",
            replaces="src/repro/kernels/moe_dispatch.py:94"),
        "ssd_scan": dict(
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:48"),
        "ssd_scan_bwd": dict(
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:208"),
    }
    # the headline row of each kernel is its first training-path shape (the
    # dense slice's for K1–K4, the MoE slice's for K5–K7, the SSM slice's
    # for K8–K9), and ``launches`` counts that path's run;
    # ``launches_by_path`` every path's run (each counted from 0 just before
    # it)
    by_path = {"serving": launches, "training": train_launches,
               "moe_training": moe_train_launches, "moe_serving": moe_launches,
               "ssm_training": ssm_train_launches, "ssm_serving": ssm_launches,
               **cnn_launches,
               **{f"zoo {run}": c for run, c in zoo_launches.items()},
               **{f"selection {run}": c for run, c in sel_launches.items()},
               **{f"a11 {run}": c for run, c in a11_launches.items()},
               **fleet_launches, **lm_launches, **cohort_launches}
    for name, err in (list(mworst.items()) + list(sworst.items())
                      + list(cworst.items()) + list(a11_worst.items())
                      + list(d80_worst.items())):
        worst[name] = max(worst.get(name, 0.0), err)
    home = {n: ("moe_training", moe_times) for n in
            ("grouped_matmul", "gather_rows", "gather_dot", "gather_reduce")}
    home.update({n: ("ssm_training", ssm_times)
                 for n in ("ssd_scan", "ssd_scan_bwd")})
    entries = []
    for name in meta:
        path, table = home.get(name, ("training", train_times))
        rows = table[name]
        head, serving = rows[0], times.get(name, [])
        extra = moe_times.get(name, []) if path == "training" else []
        extra = extra + cnn_times.get(name, []) + a11_times.get(name, []) \
            + d80_times.get(name, [])
        entries.append(dict(
            name=name, route="cuda", source=meta[name]["source"],
            replaces=meta[name]["replaces"],
            launches=by_path[path].get(name, 0),
            launches_by_path={p: c.get(name, 0) for p, c in by_path.items()},
            max_abs_err=worst[name], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            tc_bound_ms=head.get("tc_bound_ms"),
            first_design_ms=head.get("first_ms"),
            shape=head["shape"],
            host_us=serving[0].get("host_us") if serving else next(
                (r["host_us"] for r in rows if "host_us" in r), None),
            library_host_us=(serving[0].get("library_host_us")
                             if serving else None),
            other_shapes=rows[1:] + serving + extra))
        if name in ("flash_attention_dq", "flash_attention_dkv"):
            entries[-1]["pair"] = {   # the backward pair, timed in turns
                "training": train_times["flash_attention_bwd"][0],
                "moe_training": moe_times["flash_attention_bwd"][0],
                "hubert_d80": d80_times["flash_attention_bwd"][0]}
        if name in ("gather_rows", "gather_dot"):  # the combine's VJP
            entries[-1]["combine_vjp"] = moe_times["combine_vjp"][0]
        if name in variant_counters():   # launches by plan variant
            entries[-1]["launches_by_variant"] = {
                p: st.get("launches_by_variant", {}).get(name)
                for p, st in (("serving", stats), ("training", train_stats),
                              ("moe_serving", moe_stats),
                              ("moe_training", moe_train_stats),
                              ("ssm_serving", ssm_stats),
                              ("ssm_training", ssm_train_stats),
                              ("cnn_training", cnn_stats))
                + tuple((f"zoo {a} cfl", zoo_stats[a])
                        for a, *_ in ZOO_PARENTS)
                + tuple((f"selection {run}", {"launches_by_variant": {
                    "elastic_dense": st["by_variant"]}})
                        for run, st in sel_stats["runs"].items())
                + (("selection zoo granite cfl uniform", {
                    "launches_by_variant": sel_stats["zoo"]["by_variant"]}),)
                + tuple((f"a11 {run}", st) for run, st in a11_stats.items()
                        if run != "zoo")
                + tuple((f"a11 {a.split('-')[0]} cfl", a11_stats["zoo"][a])
                        for a, *_ in A11_PARENTS)
                + (("fleet cnn cfl ring on", {"launches_by_variant": {
                    "elastic_dense": fleet_stats["sync"]["by_variant"]["on"]}}),
                   ("fleet zoo granite serving", {"launches_by_variant":
                    fleet_stats["handoff"]["serving_by_variant"]}))
                + tuple((f"lm {label} kernel", {"launches_by_variant":
                                                run["kernel"]["by_variant"]})
                        for label, run in lm_stats["lm"].items())
                if name in st.get("launches_by_variant", {})}
    print("kernels: " + "; ".join(
        f"{p} " + " ".join(f"{n}={c}" for n, c in counts.items())
        for p, counts in by_path.items()))
    print(f"slice: {json.dumps(stats)}")
    print(f"training: {json.dumps(train_stats)}")
    print(f"moe training: {json.dumps(moe_train_stats)}")
    print(f"moe slice: {json.dumps(moe_stats)}")
    print(f"ssm training: {json.dumps(ssm_train_stats)}")
    print(f"ssm slice: {json.dumps(ssm_stats)}")
    print(f"cnn training: {json.dumps(cnn_stats)}")
    print(f"zoo sessions: {json.dumps(zoo_stats)}")
    print(f"selection: {json.dumps(sel_stats)}")
    print(f"last three decoder parents: {json.dumps(a11_stats)}")
    print(f"fleet: {json.dumps(fleet_stats)}")
    print(f"gates and lm training: {json.dumps(lm_stats)}")
    print(f"tile-accounting gate: {json.dumps(gate_stats)}")
    print(f"cohort sharding: {json.dumps(cohort_stats)}")
    print(f"phase seconds: {json.dumps(phase_s)}; "
          f"{time.perf_counter() - t_start:.1f} s in all")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
