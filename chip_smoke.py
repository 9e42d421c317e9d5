#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (CUDA
toolkit with ``nvcc`` under ``/usr/local/cuda``). Phases, in order; any
failure raises, exits non-zero and prints no ``ok`` line:

  1. device and build: the card's name, count and power limit; builds every
     CUDA kernel of the path from ``src/repro_torch/kernels/csrc``, and the
     two-pass body ``frontier_crit_lanes_batch`` ran on before (from
     ``tools/crit_variants.py``), to time the two in turns;
  2. kernel parity at full width: the paper's G(n=10^6, p=10^-4) graph
     (~10^8 arcs) and its incoming and outgoing ELL on the card; each kernel
     against its plain PyTorch twin on seeded inputs, compared bit for bit
     (every NaN counts as one value: IEEE leaves NaN payloads open); the
     push relax also against the pull (B = 1, 8, 13, 40, NaN lanes, a dense
     dmask, grid_road); the frontier reduction also on rows of n % 4 = 3
     and 1 and for 50 calls in a row;
  3. the main path, serving: a StaticBackend with 8 lanes answers 16
     requests (reset_lanes -> step -> peek -> take_row), with every
     kernel's launch count set to 0 just before and read just after: the
     relax is the push, no pull relax runs;
  4. end-to-end parity: run_phased_static_batch with the kernels and with
     use_kernels=False give bit-equal results;
  5. an independent check of one row against scipy's Dijkstra (f64, host);
  6. kernel times at the main shape, on the inputs of one real phase of
     the B = 8 solve (CUDA events, median per launch), beside the twin's
     time and the least time the card could take for that input (the
     relax's bound counts the settled vertices' out-rows, dmask and upd);
     push and pull on the same inputs in turns, the push's candidates and
     atomics; then every phase of the default solve: active rows, push and
     pull times, and the densest phase timed in turns; the frontier
     reduction in turns with its two-pass body;
  7. the dynamic-key kernels at full width: each key kernel against its
     twin on dense seeded key gates, bit for bit, and the status-gate table
     (``ell_key_min_status_batch``) against its twin and the f32 path;
  8. the paper's strengthened ``in|out`` criterion, serving: a StaticBackend
     with 8 lanes answers 16 requests, counts set to 0 just before;
  9. ``in|out`` end to end: the B = 8 solve with the kernels and with
     use_kernels=False bit-equal, the served rows equal to it, one row
     against scipy's Dijkstra;
 10. ``insimple|outsimple`` at full width, 64 trips, kernels against twins
     on every state field (the path of the status-gate table), with its
     device split a trip;
 11. the key kernels' times on the inputs of one real phase of the ``in|out``
     solve; the two fused scans (on the pipelined scan body) split by kernel
     with ``torch.profiler``, and their sweeps each timed alone on the
     single-sweep kernels (the body the fused scans ran on before the
     pipelined one): the stream floor, the sparse relax sweep, the dense
     gate sweeps; ``ell_key_min_batch`` and ``ell_gather_min_batch`` in turns
     with the single-sweep body, the status-gate table against the f32
     path, and the frontier reduction with per-lane keys in turns with its
     two-pass body, each bit-checked on these inputs first;
 12. the skewed graph: ``kronecker(20)`` (Graph500 initiator, ~9.1e7 arcs,
     drawn on the host in a thread beside the build and phase 29, whose
     times back no claim, and joined before phase 2; copied over here,
     largest in-degree ~3.8e5, so no padded layout fits) and its degree-sliced
     in- and out-views on the card, with their sizes;
 13. the sliced kernels against their twins at full width, bit for bit
     (sparse dmask with the skip on, dense V = 2 gates, K = 1 and 2,
     dep_idx 0 and 1, NaN cases; the fused in-scan with and without the
     out-view, B = 1, 8, 13); the sliced push along the out-view against
     its twin and the sliced pull (B = 1, 8, 13, 40, NaN lanes); then
     signed zeros: every kernel against its twin on both graphs with their
     weights mapped onto {+0, -0, 0.5, 1} and vectors from the same set
     (ties of -0 and +0 in every order, NaN lanes), the pushes also against
     the pulls;
 14. sliced serving: a StaticBackend(layout="sliced") with 8 lanes answers 16
     requests under ``instatic|outstatic``, then ``in|out``, counts set to 0
     just before: the sliced kernels run (the sliced push on the default
     plan, the fused in-scan in its push form on ``in|out``), the padded
     ones do not;
 15. sliced end to end: on kronecker(20) the B = 8 kernel and plain solves
     bit-equal for both plans, the served rows equal, one row against
     scipy's Dijkstra, the ``in|out`` kernel and plain states a quarter of
     the way bit-equal with their carried keys; on G(10^6, 10^-4)
     layout="sliced" bit-equal to the padded solves of phases 4 and 9;
 16. the sliced kernels' times on the inputs of one real phase (the sliced
     push and pull in turns; the fused scans on the pipelined body in turns
     with the single-sweep body they ran on before, each split by kernel),
     every phase of the sliced default solve as in phase 6, and ms/phase,
     phases per query and queries/s of the sliced solves and serving;
 17. more buckets than one launch takes: G(10^5, 10^-3) sliced into 19
     buckets with rows (each pass runs in two groups): every sliced kernel
     and the sliced push against its twin, and the sliced default and
     ``in|out`` solves against the padded ones, bit for bit; then an
     out-view sliced at every width 50..150 (more buckets with rows than
     the settle mark aggregates in shared memory): the pair against its
     twins and the default solve through it against the padded one;
 18. ``ContinuousBatcher`` on G(10^6, 10^-4), padded: (a) the default plan,
     8 lanes, 32 phases a step, a 64-row ``DistCache``: 40 requests from
     seed 3 (32 distinct sources, 8 repeats that coalesce) in 4 bursts of
     10 before the first 4 steps, then ``drain()``; every row bit-equal to
     B = 8 kernel solves of the same sources, one against scipy; 4 repeats
     after the drain are cache hits with no engine trip; prints the
     outcomes, steps, trips, queries/s, admission-to-row latency p50 / p99,
     the device's busy share over a steady window and the launches beside
     phase 3's queries/s; (b) ``in|out`` with ``point_queries=True``: 8 s->t
     and 8 full requests of phase 9's sources, every ``dist[target]`` and
     full row equal to phase 9's solve, no point row in the cache, the
     point lanes' ``relax_edges`` against the full lanes' and the re-primes
     admissions caused;
 19. ``run_point_to_point``: on G(10^6, 10^-4), padded, default plan, 4
     (s, t) pairs bidirectional and forward-only, ``distance`` equal to
     phase 18's full rows and ``mu >= distance``; the backward views must
     be the forward graph's own, swapped (their bytes and fetch time are
     printed); on kronecker(20), sliced, under both plans, 2 pairs each,
     bidirectional and forward-only (one target of in-degree 0, certified
     unreachable by the backward lane), against phase 14's rows;
 20. delta-stepping at full width, ``delta = default_delta(g)``: on the
     inputs of one real delta phase (a trip where some lane runs a light
     round and another its heavy turn), #2 on bucket ids, the push of both
     turns along the out-view (#5c padded, #9c sliced on the out-view's
     buckets) and the parent's two gathers of the light and heavy gates
     over the weight-gated in-views (#5 padded, #9 sliced) against their
     twins and #5c / #9c against the gathers, bit for bit, all timed, and
     delta's committed phase (the threshold, the mark, the push, the tail)
     against its twins and the parent's phase body (#2, #5c / #9c and the
     glue), timed by kernel in turns with it beside each kernel's bound
     (``delta_pair_times``); the views delta holds beside the parent's;
     then on G(10^6, 10^-4), padded, the B = 8 solve with the kernels
     against the plain twins on every field, timed in turns with the
     parent's phase, row 0 against scipy, two lanes equal to
     ``run_delta_stepping`` (the COO loop) on the card (a lane that loop
     stalls on at a bucket edge is shown stalled there and the next lane
     taken), and ``StaticBackend(policy="delta")`` answering 16 requests:
     delta's four run, no other relax kernel (no #2, no gather, no
     #5c / #9c, no pull); the same on sliced ``kronecker(20)`` with the
     sliced push; ms/phase, phases per query, queries/s and the device
     split beside the default plan's (phases 3, 4, 14, 15);
 21. oracle plans on G(10^6, 10^-4), padded and sliced: ``oracle``,
     ``instatic|outstatic|oracle`` and ``in|out|oracle`` with phase 4's
     rows as ``dist_true``, kernels against plain twins on every field,
     every row within the oracle's tolerance of its ``dist_true`` (the
     count above it printed), phases per row beside the plan without the
     oracle, and ``run_phased(..., "oracle")`` (the COO loop) for one
     source equal to its lane;
 22. telemetry rings: the default plan, ``in|out`` and delta at B = 8 with
     ``telemetry=True`` and a ring longer than the trips: every other
     field equal to the runs without rings (phases 4, 9, 20), per lane the
     fringe ring summing to ``sum_fringe``, the relax ring to
     ``relax_edges`` and the attribution's settle slots to the settled
     ring; ``phase_telemetry`` decodes every lane, and the tracer's events
     pass ``validate_events``; the default plan's run commits through the
     pair (the attribution ring's counts from the mark) and launches no
     PR 15 push.

 23. the engine portfolio on both graphs: ``measure_portfolio`` over the
     eight default candidates on G(10^6, 10^-4) (the five sliced ones and
     the sliced default plan on ``kronecker(20)``, where no padded view
     fits) into a fresh ``TuningLedger``, each candidate's qps, phases,
     ms/phase, delta and attribution shares printed, its solves' launches
     checked (#2 and its plan's kernels, no pull relax, none of the other
     layout's kernels), its probe rows (telemetry on) bit-equal to its
     timed solve's; the ledger saved and reloaded, a ``PortfolioBackend``
     built from it with no launch and routed to the recorded qps argmax;
     phase 18's 40 requests (8 on ``kronecker(20)``) served through it,
     every row bit-equal to a B = 8 solve of the routed candidate, whose
     first B = 8 solve equals its plain twins on every field, one row
     within rtol 1e-5 of scipy's Dijkstra and, on G(10^6, 10^-4), every
     row equal in value to phase 18's default-plan rows;
     ``graph_family``'s host seconds; ``python -m repro_torch.obs
     dashboard`` on the saved ledger;
 24. chaos and recovery on G(10^6, 10^-4), padded, default plan:
     ``ResilientBatcher`` under a hand-written ``FaultPlan`` with one fault
     of each of the six kinds (virtual clock, ``FaultyDistCache``,
     observability on) serves phase 18's 40 requests all ``ok`` and equal
     to phase 18's rows; the faults fired are the plan's, one quarantine a
     row fault, one engine failure (an injected one), the poisoned cache
     entry dropped, the trace valid (``validate_events`` and ``python -m
     repro_torch.obs validate``); with no faults, verify on and off, the
     completions, rows and steps of phase 18's batcher and their
     queries/s; ``verify_row`` on the card (#5 over the resident padded
     in-view; #9 over the sliced one on ``kronecker(20)``) timed a row
     beside the solve's
     time a row and a host numpy form of the same check; each single-entry
     corruption (NaN, negative, raised, lowered, inf made finite) of a
     real row rejected on the card with the host form's reason.
 25. the execution config and the analysis gate: ``python -m
     repro_torch.analysis --require-card`` in a subprocess (lint, the CPU
     audit, each kernel's ptxas registers, shared memory and spills against
     the card's limits, every contract case three times on a poisoned
     caching allocator: 0 poisoned cells); ``in|out`` at B = 8 on padded
     G(10^6, 10^-4) and sliced ``kronecker(20)`` with the scans in the
     reference's split form (``tools/scan_variants.py``: #1 / #6 or #9 and
     a torch gate, no fused scan launched) and fused, in turns, bit-equal
     on every ``BatchedResult`` field, ms/phase of each; ``measure_launch``
     on #2 and #1b at phase 6's inputs, CUDA events beside the host clock;
     a ledger tagged ``cpu`` routes the card to the first candidate;
     ``TraceGuard`` counts 0 compiles and 0 graph captures over 16
     warmed ``StaticBackend`` requests (one step warms the key first),
     and a ``ContinuousBatcher`` captures nothing after its first step.
     The script stops at its start unless ``REPRO_TORCH_KERNEL_MODE``
     resolves to ``auto``.
 26. the sharded stepper over ``torch.distributed``: (a) the rectangular
     push (#1b, ``ell_push_rect_batch``) on each block of G(10^6, 10^-4)
     at P = 2 against its twin, bit for bit (sparse and dense dmask, B =
     1, 8, 13, 40, NaN lanes, a dense key gate, values and weights on
     {+0, -0, 0.5, 1}; the dense case also against the square push over
     the whole graph with only the block live), and timed on rank 0's block
     of phase 6's input beside its twin, its bound and the square push;
     (b) 2 ranks sharing cuda:0 under gloo (``torch.multiprocessing``
     spawn; every collective staged through host memory; the kernels built
     by phase 1 before the spawn): phase 4's B = 8 solve under the default
     plan on both schedules and ``in|out`` on ``reduce_scatter``, each
     bit-equal to phases 4 and 9's kernel solves (``dist``, ``status``,
     ``phases``, ``sum_fringe``, ``relax_edges``, trips), #2 and the
     rectangular push launched on every rank and no pull; then
     ``ShardedBackend`` under ``ContinuousBatcher`` on rank 0 (rank 1 in
     ``follow()``) answers phase 3's 16 requests with phase 3's rows; ms a
     phase, the exchange's ms a phase (host clock around the collectives),
     queries/s, labelled as 2 ranks sharing one H100 (a correctness check,
     not a sharded speed); (c) a world of one rank on NCCL, in this
     process: the default B = 8 solve equal to phase 4's on every field,
     and ``ShardedBackend`` (rank 0 alone) serving phase 3's 16 requests
     with its rows. Any rank's failure fails the run.
 27. LM serving (the LM substrate's ``prefill``, ``decode_step`` and
     ``forward_logits``; no kernel of ours, TF32 off): (a) every smoke
     config on the card against the same weights on the CPU, f32,
     ``forward_logits`` (S = 32), ``prefill`` with every cache leaf and 4
     decode steps within rtol = atol = 1e-4; (b) ``internlm2-1.8b`` and (c)
     ``mamba2-1.3b`` at full width: the parameter count; f32 prefill of a
     512-token prompt (B = 2) and one decode step against ``forward_logits``
     over 513 tokens (rtol 1e-3, atol 2e-3; the SSD's forward in chunks
     that divide 513, its one-chunk fallback reported beside it); the card
     against the CPU on one 64-token request (rtol = atol = 1e-3); the bf16
     served run, B = 4 prompts of 2048 tokens, ``prefill`` and 32 greedy
     ``decode_step``s, every tensor on the card: prefill ms, decode ms a
     step, generated tokens/s and peak memory beside their bounds; a
     ``torch.profiler`` split of one prefill and one decode step (by kind
     of kernel, the top ops, the device's busy share of a step). No SSSP
     kernel may launch on this path.
 28. LM training (``train_loss`` with remat and the chunked cross-entropy,
     AdamW, the data stream, checkpoints, ``train()`` and its launcher; no
     kernel of ours, f32 with TF32 off): (a) every smoke config on the card
     against the same weights and batch on the CPU (B = 2, S = 32):
     ``train_loss`` under remat none, "full" and "dots" and every gradient
     leaf, and one ``apply_updates`` step in both ``v_mode``s with ``m``
     in f32 and bf16 on the same gradients, at the CPU tests' tolerances;
     (b) ``internlm2-1.8b`` at every published width on 2 layers: the
     chunked cross-entropy against ``forward_logits``'s, the three remat
     choices against each other (B = 2 x 1024), the card's gradients
     against the CPU's by relative L2 error (B = 1 x 128); (c) the timed
     run, ``internlm2-1.8b`` at full width on LM_TRAIN_UNITS of its 24
     units (all 24 until the tensor-parallel mesh came, 12 until phase 31
     came; the script's time limit): ``train()`` for 4 steps (6 until
     phase 29 came), B = 4 x 2048, f32 parameters, m bf16, v factored,
     full remat, a checkpoint every 2 steps (two kept: the disk must hold
     two, ~4.5 GB each at 6 units, ~11.3 GB at 24, or the phase fails),
     then a second ``train()`` resumed from step 2 after step 4's
     checkpoint is removed, its losses within rtol 1e-4 of the first
     run's; ms a step (median of steps 2-4), tokens/s and
     peak memory beside their bounds, a ``torch.profiler`` split of one
     step by kind of kernel with the device's busy share, and one
     checkpoint's snapshot, write and restore (restored bit for bit); (d)
     ``python -m repro_torch.launch.train --arch internlm2_1_8b --smoke
     --steps 3`` in a subprocess on the card. No SSSP kernel may launch on
     this path.
 29. The LM substrate on a mesh (``sharding/``: tensor, sequence and
     expert parallel compute on the weights' own blocks, the sharded train
     and serve steps, elastic re-planning; f32 with TF32 off; #12's block
     form is its kernel). It runs right after phase 1, before any graph is
     on the card: its ranks need the card's memory.
     The one-card twins of (b) and (c) run first and are freed; then 4
     gloo ranks share this card as a 2 x 2 (data, model) mesh
     (``torch.multiprocessing``, a ``file://`` store; a failed rank fails
     the run): (a) every smoke config, FSDP over "data": the sharded loss
     and every gathered gradient against the one-card step (MoE layers
     as ``apply_moe_ep_plain(2, 2)`` wherever the gate is on), one AdamW
     step (bf16 m, factored v) of the placed model and of the one-card
     model on the same gradients, ``build_step``'s whole train step
     (timed, its gloo bytes by kind), run twice and bit-equal in every
     leaf, then the sharded prefill and 4 decode steps (each rank's slots
     of the cache) against one card's, all within ``train_tol``; (b) ``qwen3-moe-235b``
     at published widths cut to 1 of 94 units, B = 2 x 1024, expert
     parallel, FSDP: the loss, the router's gradient and one expert's
     against the one-card plain twin, the step's ms, the all-to-alls'
     ms, gloo bytes and peak memory by rank; (c) ``internlm2-1.8b`` at
     published width cut to 4 units, B = 4 x 2048, FSDP: two train steps
     against one card's ``make_train_step``; (e) ``qwen3-moe`` smoke
     trained 2 steps with checkpoints, then 3 ranks re-planned by
     ``plan_mesh(3, want_tp=2, global_batch=4)`` to (2, 1), one idle:
     every restored leaf gathered bit-equal to the file, step 3 against
     one card's plain (2, 1) step from the same checkpoint; (d) an NCCL
     world of one in this process: (c)'s model through the sharded code,
     loss and every gradient leaf bit-equal to the one-card step, and every
     leaf bit-equal between two one-card runs (the embedding's gradient is
     ``embed_grad``'s fixed-order sum), and ``qwen3-moe`` smoke against
     ``apply_moe_ep_plain(1, 1)``. One card runs these for correctness
     only: no number here is a sharded speed. No SSSP kernel may launch on
     any rank; ``embed_grad``'s block form must launch on every rank of
     the 2 x 2 world (the vocabulary-parallel lookup's gradient).
     After phase 28: ``embed_grad`` (#12, the lookup's gradient in a fixed
     order, the training path's one kernel: phase 28 must launch it and no
     SSSP kernel) at phase 28's shapes, against its twin and itself bit for
     bit, timed beside the twin, ``index_add_`` and its bound.
 30. The dry run on the card (``launch.dryrun``), as rank 0 of a fake
     16 x 16 world (``make_production_mesh``): (a) ``run_sssp``'s cell at
     its defaults (n = 2^24, degree 16: rank 0's block, n_loc 65,536, E_loc
     1,048,576) on real tensors, one phase of the legacy program under
     each schedule, the counts set to 0 just before and read just after
     (#1b rect and #2 must launch), their inputs held kernel against twin
     bit for bit, the predicted peak (arguments + temporaries from the
     storages' lifetimes) within 15 % of ``max_memory_allocated`` around
     the phase; (b) ``internlm2-1.8b`` ``decode_32k`` traced over fake
     tensors, then run for real with seeded blocks (never the whole
     model): the predicted peak within 15 % of the measured one, the traced
     FLOPs equal to a ``FlopCounterMode`` count of the real run, the logits'
     shape (a fake world returns no data: sizes, not values); (c) #12's
     block form (a rank's rows [5 V / 16, 6 V / 16) of the table, one data
     rank's 16 x 4096 ids of the pod's ``train_4k``) against its twin and
     itself bit for bit, timed beside the twin, ``index_add_`` of the
     block's rows and its bound.
 31. The entry points (``repro_torch.examples``, the twins of the
     reference's ``examples/``), each called in this process as ``python
     -m`` runs it (``EXAMPLE_RUNS``): quickstart; sssp_pipeline at n =
     2^18 (the 512 x 512 road grid, DIMACS USA-road-d.NY's size; the web
     graph and ``kronecker(18)`` on degree-sliced views, G(2^18, 10/n)),
     every engine against Dijkstra; batch_serving on the 512 x 512 grid
     (B = 16, 2 requests); continuous_serving on the 128 x 128 grid with
     ``--trace`` / ``--report`` and under ``--chaos 0``; distributed_serving
     in a gloo world of 2 sharing the card; serve_lm and train_lm (3
     steps, a checkpoint in a temporary directory) on ``internlm2-1.8b``
     at full width. Every printed verdict must hold, and each run's
     launches are read around it: #1b (or #9b on sliced views) and #2 on
     every static solve and no pull, #5 under ``--chaos``
     (``verify_row``), the rectangular push on the sharded path, no SSSP
     kernel on the LM paths.
 32. The chunk loop (``chunk_loop_phase``): ``step_batch`` replays a
     captured CUDA graph of ``PHASES_PER_REPLAY`` gated phases; on the
     default plan on G(10^6, 10^-4) (B = 8) and on sliced
     ``kronecker(20)``, ``delta@x4:sliced`` on both graphs, ``in|out``
     padded and the 512 x 512 road grid at B = 16 (also with target lanes
     under ``stop_on_lane_finish``), the replayed graph against the same
     chunk run eagerly, every state field bit for bit over two calls of 3
     j + 2 phases, and the launch counts of a replayed solve against its
     ``torch.profiler`` trace (#2, #1b / #9b's push, the pair and Δ's
     four, one kernel of each a launch: ``TRACE_SIGNATURES``), a replayed
     default phase on the padded layout held to #2 and the pair, and a
     replayed Δ phase to its four kernels; where timed, ms a phase of the
     graph and the eager chunk loop in turns over ``CHUNK_TIMED_PHASES``
     phases, each one's busy share (``torch.profiler``), host reads a
     solve, a dead phase's device ms, the captures' seconds and their
     pool's size (a key's own where no other capture lives), and the chunk
     lengths of ``CHUNK_J_SWEEP`` in turns.

Every phase's end is logged with its seconds and the run's so far.

Every path (phases 3, 8, 14, 18, 19, the solves and serving of 20–22, of
23–24, of 25 and of 26, on every rank, 28, 29, 30, 31 and 32) runs with
the launch counts set to 0 just before and read just after, and fails if
one of its kernels never ran. A replayed chunk makes no Python call: each
replay adds the launches its capture recorded, those of the phases a
chunk ran past its loop's end included; the served paths (phases 3, 8,
14, 25, 31, 32) also log these dead phases' launches apart.

The seventh line from the end is phase 27's ``lm_serving`` JSON line; the
sixth is phase 28's ``lm_training``; the fifth is phase 29's
``lm_mesh``; the fourth is phase 30's ``dry_run``; the third is phase
31's ``examples`` (each run's seconds, launches and figures: phases,
queries/s, the views chosen and their bytes); the second is the
``kernels`` JSON line (each row's ``launches_by_path`` with
``examples``, phase 31's sum; each row with its ``__global__`` kernels' ptxas
``registers``, ``smem_bytes`` and ``spills``; #1b rect and #2 with
``launches_phase30``; ``embed_grad[block]``, #12's block form, its
launches rank 0's of phase 29's 2 x 2 world); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RUN_T0 = time.perf_counter()  # the run's start: every phase's end is logged

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

N, P, SEED = 1_000_000, 1e-4, 0  # the paper's Sec. 6 benchmark graph
LANES = 8
REQUESTS = 16
CHUNK = 64  # phases per step call in the serving loop
MID_PHASE = 200  # the phase whose kernel inputs phase 6 times
DYN_TRIPS = 64  # trips of the insimple|outsimple check (phase 10)
KRON_K = 20  # kronecker(20): the skewed graph of phases 12-16
DELTA_MAX_TRIPS = 3000  # phase 20 fails a delta solve still live after these
INF = float("inf")
PUSH_IN_SCAN = "ell_sliced_relax_keys_batch[out_view]"  # #10b's name here
SIGNED = (0.0, -0.0, 0.5, 1.0)  # the values of the signed-zero cases
# LM serving (phase 27): the widths of the two served configs' runs
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_STEPS = 2, 32, 4
LM_SMOKE_TOL = 1e-4  # rtol and atol, card against CPU in f32 (TF32 off)
LM_PROMPT_B, LM_PROMPT_S, LM_GEN = 4, 2048, 32  # the bf16 served run
BF16_OPS_PER_S = 989e12  # bf16 dense, tensor cores
# LM training (phase 28): the timed run, internlm2-1.8b at full width
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS, LM_TRAIN_EVERY = 4, 2048, 4, 2
LM_TRAIN_UNITS = 6  # (c) of internlm2-1.8b's 24: the script's time limit
LM_TRAIN_CUT = 2  # layers of the full-width parity checks (b)
LM_CUT_B, LM_CUT_S = 2, 1024  # (b) on the card: two cross-entropy chunks
LM_HOST_B, LM_HOST_S = 1, 128  # (b) card against CPU
LM_RESUME_RTOL = 1e-4  # (c) the resumed run's losses against the first's
LM_CUT_GRAD_RL2 = 1e-5  # (b) relative L2 error of a gradient leaf
PCIE_BYTES_PER_S = 64e9  # PCIe 5.0 x16, one direction: the host link


def log(msg: str):
    print(msg, flush=True)


def load_tool(name: str):
    """A script of ``tools/`` as a module (its kernel variants)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def result_diff(a, b) -> str | None:
    """The first field in which two results (dataclasses) differ, bit for
    bit (None where both are equal): tensors by :func:`same_bits`, host
    arrays by value, a None only against a None."""
    import dataclasses

    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            same = x is None and y is None
        elif torch.is_tensor(x):
            same = torch.is_tensor(y) and same_bits(x, y)
        else:
            same = np.array_equal(np.asarray(x), np.asarray(y))
        if not same:
            return f.name
    return None


def same_bits(a, b) -> bool:
    """Bit equality of two tensors, with every NaN taken as one value."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        canon = torch.tensor(float("nan"), device=a.device)
        a = torch.where(torch.isnan(a), canon, a).view(torch.int32)
        b = torch.where(torch.isnan(b), canon, b).view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds per call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(out: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, S bytes smem; stack frame and spills") for
    each entry function in ``nvcc -Xptxas -v`` output, names demangled by
    ``c++filt`` where the host has it."""
    rows, fn, spill = [], None, ""
    for line in out.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], ""
        elif "spill stores" in line and fn is not None:
            spill = line  # "N bytes stack frame, M bytes spill stores, ..."
        elif line.startswith("ptxas info") and "Used" in line and fn:
            rows.append((fn, line.split("Used", 1)[1].strip() + "; " + spill))
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]  # mangled names say the same, less kindly
    return [(nm.split("(")[0], info) for nm, (_, info) in zip(names, rows)]


def device_split(fn, calls: int = 5) -> list[tuple[str, float]]:
    """Device milliseconds a call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls."""
    return [(k, t * c) for k, t, c in device_split_counted(fn, calls)]


def device_split_counted(fn, calls: int = 5) -> list[tuple[str, float, float]]:
    """``(kernel, device ms a launch, launches seen a call)`` of ``fn``
    from ``torch.profiler``. The profiler drops the records of the first
    milliseconds it traces, so one warm-up step goes first; late in a long
    run it still drops some (a kernel launched once a call then shows
    fewer launches), which leaves the time a launch true and makes the
    time a call short."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls),
                 acc_events=True) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [(e.key.split("(")[0], e.device_time_total / e.count / 1e3,
             e.count / calls)
            for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith("ProfilerStep")]


def repeat_wall(fn, first: float, runs: int = 3) -> list:
    """Wall seconds of ``runs`` calls of ``fn``, each ended by a
    synchronize: ``first`` (a call already made) and ``runs - 1`` more."""
    import torch

    walls = [first]
    for _ in range(runs - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def busy_line(fn, wall_s: float, phases: int) -> str:
    """The device time of one call of ``fn`` (its kernels summed, from
    ``torch.profiler``) against a wall time: the device's busy share, and
    the time a phase by kernel, PyTorch's own kernels (the phase glue)
    summed apart (with the copies and memsets)."""
    parts = device_split(fn, calls=1)
    dev_ms = sum(t for _, t in parts)
    ours = ("push_kernel", "push_mark_kernel", "delta_mark_kernel", "crit_",
            "gather_min_kernel", "scan_kernel", "pack_kernel", "merge_kernel",
            "short_merge_kernel", "settle_mark_kernel", "settle_push_kernel",
            "settle_tail_kernel")
    glue = [(k, t) for k, t in parts if not any(o in k for o in ours)]
    ours = sorted((p for p in parts if p not in glue), key=lambda p: -p[1])
    split = "; ".join(f"{k} {t / phases:.4f}" for k, t in ours)
    return (f"device busy {dev_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
            f"({dev_ms / (wall_s * 1e3):.1%}; {dev_ms / phases:.3f} ms a "
            f"phase on the device: {split}; PyTorch's kernels (the glue, "
            f"{len(glue)} kinds) {sum(t for _, t in glue) / phases:.4f})")


# kernel -> the wrappers each of whose launches puts it in the trace once:
# the SSSP kernels whose count in a torch.profiler trace checks the
# wrappers' launch counts (the scans' kernels are shared by several
# wrappers, some a variable number of times a call, and are not checked)
TRACE_SIGNATURES = {
    "crit_kernel": ("frontier_crit_lanes_batch",),
    "push_mark_kernel": ("ell_push_relax_batch", "ell_sliced_push_relax_batch",
                         "ell_push_rect_batch", PUSH_IN_SCAN),
    "delta_mark_kernel": ("ell_delta_push_batch",
                          "ell_sliced_delta_push_batch"),
    # the push plans' phase-committing pair (one launch of each a phase; a
    # sliced view of more than 16 buckets would launch its push per group)
    "settle_mark_kernel": ("ell_settle_mark_batch",),
    "settle_push_kernel": ("ell_settle_push_batch",
                           "ell_sliced_settle_push_batch"),
    "settle_tail_kernel": ("ell_settle_tail_batch",
                           "ell_delta_settle_tail_batch"),
    # delta's committed phase: its threshold, mark and push (the tail is
    # the pair's kernel, above)
    "delta_crit_kernel": ("delta_thresholds_batch",),
    "delta_settle_mark_kernel": ("ell_delta_settle_mark_batch",),
    "delta_settle_push_kernel": ("ell_delta_settle_push_batch",
                                 "ell_sliced_delta_settle_push_batch"),
}
# the wrappers of the pair's three launches on each layout
PAIR = {"padded": ("ell_settle_mark_batch", "ell_settle_push_batch",
                   "ell_settle_tail_batch"),
        "sliced": ("ell_settle_mark_batch", "ell_sliced_settle_push_batch",
                   "ell_settle_tail_batch")}
# the wrappers of a delta phase's four launches on each layout
DELTA_PAIR = {
    layout: ("delta_thresholds_batch", "ell_delta_settle_mark_batch", push,
             "ell_delta_settle_tail_batch")
    for layout, push in (("padded", "ell_delta_settle_push_batch"),
                         ("sliced", "ell_sliced_delta_settle_push_batch"))}
# the kernels of a replayed default phase on the padded layout: #2 and the
# pair, nothing else (phase 32 holds the trace to it); of a replayed delta
# phase, on either layout: its four
PHASE_KERNELS = ("crit_kernel", "settle_mark_kernel", "settle_push_kernel",
                 "settle_tail_kernel")
DELTA_PHASE_KERNELS = ("delta_crit_kernel", "delta_settle_mark_kernel",
                       "delta_settle_push_kernel", "settle_tail_kernel")


def traced_launches(fn, zero_counts, read_counts,
                    kinds: dict | None = None) -> tuple[dict, dict]:
    """One call of ``fn`` under ``torch.profiler``, after an untraced one
    and a warm-up step: ``(kernel -> its instances in the trace, kernel ->
    the launches its wrappers counted in that call)`` for each kernel of
    :data:`TRACE_SIGNATURES` (the counts set to 0 just before the traced
    call and read just after it). ``kinds``, a dict, gets every device
    kernel of the trace (copies and fills apart) with its instances."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        zero_counts()
        fn()
        torch.cuda.synchronize()
        counts = read_counts()
        prof.step()
    seen = dict.fromkeys(TRACE_SIGNATURES, 0)
    for e in prof.key_averages():
        for kernel in seen:
            if re.search(rf"\b{kernel}\b", e.key):
                seen[kernel] += e.count
        if kinds is not None and e.device_time_total > 0 and not \
                e.key.startswith(("Memcpy", "Memset", "ProfilerStep")):
            kinds[e.key] = kinds.get(e.key, 0) + e.count
    return seen, {kernel: sum(counts.get(w, 0) for w in wrappers)
                  for kernel, wrappers in TRACE_SIGNATURES.items()}


def finite_slots(rows, cols_long) -> int:
    """Lane-slots ``rows[l, cols[r, j]]`` that are finite, over every lane:
    the adds and mins the data needs (a NaN or +inf slot needs none)."""
    import torch

    return int(sum(torch.isfinite(rows[i][cols_long]).sum()
                   for i in range(rows.shape[0])))


def push_load(dmask, out_deg) -> tuple[int, int, int]:
    """(active rows, candidates, bytes of their out-rows) of one relax
    input: the vertices u whose dmask is not +inf in some lane, their
    out-edges times those lanes, and 8 bytes a real out-slot of theirs
    (rows are left-packed, so a row's real slots are its out-degree)."""
    lanes = (dmask != float("inf")).sum(dim=0)
    deg = out_deg.long()
    return (int((lanes > 0).sum()), int((lanes * deg).sum()),
            int(8 * deg[lanes > 0].sum()))


def relax_bound(dmask, out_deg) -> tuple[float, str]:
    """The least time of the relax on this input, push or pull (the same
    function): the settled vertices' out-rows, dmask read and upd written
    once, an add and a min a candidate."""
    _, cand, row_bytes = push_load(dmask, out_deg)
    return bound(row_bytes + 2 * dmask.numel() * 4, 2.0 * cand)


def pair_check(args, kw, label: str) -> float:
    """The phase-committing pair (``settle_phase_batch``: the settle mark,
    the worklist push and the tail) on one phase's inputs ``args`` /
    ``kw`` against its twins, every field it writes bit for bit; returns
    the max abs error of its distances."""
    import torch

    from repro_torch.kernels.settle_push import settle_phase_batch

    got = settle_phase_batch(*args, **kw)
    want = settle_phase_batch(*args, **kw, use_kernels=False)
    torch.cuda.synchronize()
    bad = [f for f in got._fields
           if (getattr(got, f) is None) != (getattr(want, f) is None)
           or (getattr(got, f) is not None
               and not same_bits(getattr(got, f), getattr(want, f)))]
    moved = int((got.dist.view(torch.int32)
                 != args[0].view(torch.int32)).sum())
    log(f"parity settle pair [{label}]: "
        + ("bits equal" if not bad else f"DIFFER in {bad}")
        + f" on every field it writes ({int(got.settled_trace[:, 0].sum())} "
        f"settled, {moved} distances lowered, trips {int(got.trips)})")
    if bad:
        raise SystemExit(f"the settle pair disagrees with its twins: {label}")
    return max_abs_err(got.dist, want.dist)


PAIR_KERNELS = ("settle_mark_kernel", "settle_push_kernel",
                "settle_tail_kernel")


def pair_times(args, kw, old_push, label: str, smi: str) -> dict:
    """The pair on one real phase's entry state (``settle_phase_batch``'s
    ``args`` / ``kw``): each kernel's device ms a call (``torch.profiler``)
    in turns with the PR 15 push ``old_push`` on the same phase (its mark
    and push passes; pair, old, old, pair), each twin's ms, and each
    kernel's bound from this input: the mark reads status whole, d only in
    the 32-byte sectors that hold a fringe slot (it reads a lane's d where
    its status is 1), the static key, the out-degrees of the settled and
    (sliced) the row table of the sources, and writes status and d_src at
    the settled and the sources and the worklist's entries; the push reads the entries, the sources'
    out-rows and d_src and writes each touched target's d and status once
    (an add and a min a candidate); the tail its B-sized counters."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.settle_push import settle_phase_batch

    d, st, mins, nf, live0, view, deg, in_key = args
    b, n = d.shape
    target = kw.get("target")

    def pair():
        return settle_phase_batch(*args, **kw)

    def kernel_ms(split, name):
        return sum(t for k, t in split if name in k)

    splits = [device_split(f, calls=5)
              for f in (pair, old_push, old_push, pair)]
    ms = {nm: (kernel_ms(splits[0], nm) + kernel_ms(splits[3], nm)) / 2
          for nm in PAIR_KERNELS}
    old = [kernel_ms(s, "push_mark_kernel") + kernel_ms(s, "push_kernel")
           - kernel_ms(s, "settle_push_kernel") for s in splits[1:3]]
    # the twins, timed alone, and the counts the bounds read
    one = torch.ones((), dtype=torch.int32, device=d.device)
    mark_args = (d, st, mins, nf, live0, one)
    mark_kw = dict(zero=kw.get("zero", True), in_key=in_key,
                   stop=kw.get("stop", False), target=target, out_deg=deg)
    mk = ref.settle_mark_ref(*mark_args, **mark_kw)
    st2 = torch.where(mk.settle, 2, st).to(torch.int32)
    zeros = [torch.zeros(s, dtype=t, device=d.device) for s, t in (
        ((), torch.int32), ((b,), torch.int32), ((b,), torch.int64),
        ((b,), torch.int64), ((b, 3), torch.int32))]
    plain = {
        "settle_mark_kernel": time_ms(
            lambda: ref.settle_mark_ref(*mark_args, **mark_kw), reps=5,
            warmup=1),
        "settle_push_kernel": time_ms(
            lambda: ref.settle_push_ref(d, st2, mk.sources, view), reps=3,
            warmup=1),
        "settle_tail_kernel": time_ms(
            lambda: ref.settle_tail_ref(st2, nf, mk, target, *zeros, one),
            reps=5, warmup=1)}
    new_d, new_st = ref.settle_push_ref(d, st2, mk.sources, view)
    touched = int(((new_d.view(torch.int32) != d.view(torch.int32))
                   | (new_st != st2)).sum())
    dm = torch.where(mk.sources, d, INF)
    active, cand, row_bytes = push_load(dm, deg)
    vrows = kw.get("vrows")
    act = mk.sources.any(dim=0)
    entries = (-(-b // 32)) * (int(vrows[act, 2].sum()) if vrows is not None
                               else active)
    settled, src_lanes = int(mk.settle.sum()), int(mk.sources.sum())
    relax_v = int((mk.settle.any(dim=0)).sum())
    fringe = (st == 1).reshape(-1)
    n_fringe = int(fringe.sum())
    fringe = torch.cat([fringe, fringe.new_zeros((-fringe.numel()) % 8)])
    sectors = int(fringe.view(-1, 8).any(dim=1).sum())
    terms = (int(kw.get("zero", True)) + (in_key is not None)
             + mins.shape[0] - 1)
    bounds = {
        "settle_mark_kernel": bound(
            4 * d.numel() + 32 * sectors
            + (4 * n if in_key is not None else 0) + 4 * relax_v
            + (16 * int(act.sum()) if vrows is not None else 0)
            + 4 * settled + 4 * src_lanes + 8 * entries,
            float(d.numel() + terms * n_fringe)),
        "settle_push_kernel": bound(
            row_bytes + 8 * entries + 4 * src_lanes + 8 * touched,
            2.0 * cand),
        "settle_tail_kernel": bound(40 * b, 0.0)}
    log(f"settle pair [{label}] [{smi}]: {n_fringe} fringe lane-slots in "
        f"{sectors} of {-(-d.numel() // 8)} 32-byte sectors of d, {settled} "
        f"settled, {active} source "
        f"vertices ({src_lanes} lane-sources, {entries} worklist entries), "
        f"{cand} candidates, {touched} targets touched; device ms a call "
        f"(pair, PR 15 push, PR 15 push, pair): mark "
        f"{kernel_ms(splits[0], PAIR_KERNELS[0]):.4f} / "
        f"{kernel_ms(splits[3], PAIR_KERNELS[0]):.4f}, push "
        f"{kernel_ms(splits[0], PAIR_KERNELS[1]):.4f} / "
        f"{kernel_ms(splits[3], PAIR_KERNELS[1]):.4f}, tail "
        f"{kernel_ms(splits[0], PAIR_KERNELS[2]):.4f} / "
        f"{kernel_ms(splits[3], PAIR_KERNELS[2]):.4f}; the pair "
        f"{sum(ms.values()):.4f} against the PR 15 push's mark + push "
        + ", ".join(f"{x:.4f}" for x in old) + "; bounds "
        + ", ".join(f"{nm.split('_')[1]} {bounds[nm][0]:.4f} "
                    f"({bounds[nm][1]})" for nm in PAIR_KERNELS)
        + "; twins " + ", ".join(f"{nm.split('_')[1]} {plain[nm]:.4f}"
                                 for nm in PAIR_KERNELS) + " ms")
    return {"ms": ms, "plain_ms": plain, "bounds": bounds,
            "old_push_ms": float(np.mean(old)), "settled": settled,
            "fringe": n_fringe, "sectors": sectors,
            "entries": entries, "candidates": cand, "touched": touched}


def parent_delta_phase(s, aux, go_of, use_kernels: bool = True):
    """The parent's delta phase (the tree before delta committed its
    phase): ``DeltaPolicy.gates`` (the bucket ids and #2 on them), the
    push #5c / #9c (``ops.delta_push_relax_batch``) and the PyTorch passes
    over B x n around them, as a policy phase's ``PhaseOutcome`` (not
    committed) on state ``s`` and ``prepare``'s ``aux``. Phase 20 times it
    in turns with the committed phase and holds the two to each other."""
    import torch

    from repro_torch.core.policies import DeltaPolicy, PhaseOutcome
    from repro_torch.kernels import ops

    ell_out, delta, deg_light, deg_heavy = aux[:4]
    d, status = s.dist, s.status
    last_proc, removed = s.crit_keys[0], s.crit_keys[1] > 0.5
    _, b_lane, n_f, cur, heavy_turn, _ = DeltaPolicy.gates(s, use_kernels)
    go = go_of(n_f)
    cur = cur & go
    heavy_turn = heavy_turn & go
    heavy_from = heavy_turn[:, None] & removed
    upd = ops.delta_push_relax_batch(d, cur, heavy_from, ell_out, delta,
                                     use_kernels=use_kernels)
    new_d = torch.minimum(d, upd)
    new_status = torch.where(
        heavy_from, 2, torch.where((status == 0) & (upd < INF), 1, status)
    ).to(torch.int32)
    new_last = torch.where(heavy_turn[:, None], INF,
                           torch.where(cur, d, last_proc))
    new_removed = ~heavy_turn[:, None] & (removed | cur)
    n_settled = heavy_from.sum(dim=1, dtype=torch.int32)
    relax_inc = (torch.where(cur, deg_light[None], 0).sum(
        dim=1, dtype=torch.int64)
        + torch.where(heavy_from, deg_heavy[None], 0).sum(
            dim=1, dtype=torch.int64))
    attr = None
    if s.attr_trace is not None:
        bucket_id = torch.where(n_f > 0, b_lane, 0.0).to(torch.int32)
        attr = torch.stack([cur.sum(dim=1, dtype=torch.int32), n_settled,
                            bucket_id], dim=1)
    return PhaseOutcome(
        dist=new_d, status=new_status,
        crit_keys=torch.stack([new_last, new_removed.to(torch.float32)]),
        n_fringe=n_f, n_settled=n_settled, relax_inc=relax_inc, go=go,
        attr_counts=attr)


def kernel_named(split, name: str) -> float:
    """The device ms of kernel ``name`` in a ``device_split``, by whole
    name (``settle_push_kernel`` is not ``delta_settle_push_kernel``)."""
    return sum(t for k, t in split if re.search(rf"\b{name}\b", k))


def delta_pair_times(st, aux, label: str, smi: str) -> dict:
    """Delta's committed phase on one real phase's entry state ``st``
    (``prepare``'s ``aux``): the four kernels (``delta_phase_batch``)
    against their twins and against the parent's phase body
    (:func:`parent_delta_phase`, #5c / #9c and its glue) on every field
    they write, bit for bit (every NaN one value); each kernel's device ms
    a call (``torch.profiler``) in turns with the parent's phase (pair,
    parent, parent, pair), the parent's split into #2, #5c / #9c and the
    PyTorch glue; each twin's ms; and each kernel's bound from this input:
    the threshold reads d, status and last_proc whole; the mark reads
    status whole, on a lane of a light round d in the 32-byte sectors that
    hold a fringe slot and last_proc in those that hold a fringe slot of
    the lane's bucket, on a lane of the heavy turn removed in the sectors
    that hold a fringe slot and d in those that hold a removed one, the
    sources' degrees and (sliced) row-table entries, and writes status at the settled, last_proc and removed where they change,
    d_src at the sources and the worklist's entries; the push reads the
    entries, the sources' out-rows and d_src and writes each touched
    target's d and status once (an add and a min a candidate of its
    source's turn, as ``delta_bound`` counts them); the tail its B-sized
    counters."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.settle_push import delta_phase_batch

    out, delta, dl, dh, vrows = aux
    d, status, keys = st.dist, st.status, st.crit_keys
    b, n = d.shape
    mins, counts = ref.delta_thresholds_ref(d, status, keys[0], delta)
    live0 = counts[0] > 0
    kw = dict(vrows=vrows, telemetry=True)
    args = (d, status, keys, live0, out, st.out_deg, dl, dh, delta)
    got = delta_phase_batch(*args, **kw)
    want = delta_phase_batch(*args, **kw, use_kernels=False)
    torch.cuda.synchronize()
    bad = [f for f in got._fields
           if (getattr(got, f) is None) != (getattr(want, f) is None)
           or (getattr(got, f) is not None
               and not same_bits(getattr(got, f), getattr(want, f)))]

    def always(n_f):
        return torch.ones((), dtype=torch.bool, device=d.device)

    # the parent's attribution slots are formed where the state has rings
    par = parent_delta_phase(dataclasses.replace(
        st, attr_trace=torch.zeros((b, 1, 3), dtype=torch.int32,
                                   device=d.device)), aux, always)
    attr = torch.where(live0[:, None], par.attr_counts, 0)
    par_bad = [nm for nm, x, y in (
        ("dist", got.dist, par.dist), ("status", got.status, par.status),
        ("crit_keys", got.crit_keys, par.crit_keys),
        ("settled", got.settled_trace[:, 0],
         torch.where(live0, par.n_settled, 0)),
        ("relax_edges", got.relax_edges, par.relax_inc),
        ("attribution", got.attr_trace[:, 0], attr))
        if not same_bits(x, y)]
    mark = ref.delta_mark_ref(d, status, keys, mins, counts, live0,
                              torch.ones((), dtype=torch.int32,
                                         device=d.device), delta,
                              stop=False, deg_light=dl, deg_heavy=dh)
    n_light, n_heavy = int(mark.cur.sum()), int(mark.heavy_from.sum())
    log(f"parity delta pair [{label}]: "
        + ("bits equal" if not bad else f"DIFFER in {bad}")
        + " to its twins on every field it writes, and "
        + ("equal" if not par_bad else f"DIFFERENT in {par_bad}")
        + f" to the parent's phase body ({n_light} light and {n_heavy} "
        f"heavy lane-vertices, lanes on a light round "
        f"{int(ref.delta_light_lanes(mins, counts).sum())} of {b})")
    if bad or par_bad:
        raise SystemExit(f"the delta pair disagrees with its twins or the "
                         f"parent's phase: {label}")

    def pair():
        return delta_phase_batch(*args, vrows=vrows)

    def parent():
        return parent_delta_phase(st, aux, always)

    splits = [device_split(f, calls=5) for f in (pair, parent, parent, pair)]
    ms = {nm: (kernel_named(splits[0], nm) + kernel_named(splits[3], nm)) / 2
          for nm in DELTA_PHASE_KERNELS}
    parent_parts = []
    for sp in splits[1:3]:
        total = sum(t for _, t in sp)
        crit = kernel_named(sp, "crit_kernel")
        push = (kernel_named(sp, "delta_mark_kernel")
                + kernel_named(sp, "delta_push_kernel"))
        parent_parts.append((total, crit, push, total - crit - push))
    parent_ms = [float(np.mean([p[i] for p in parent_parts]))
                 for i in range(4)]
    # the twins, timed alone, and the counts the bounds read
    one = torch.ones((), dtype=torch.int32, device=d.device)
    st2 = torch.where(mark.heavy_from, 2, status).to(torch.int32)
    zeros = [torch.zeros(sh, dtype=t, device=d.device) for sh, t in (
        ((), torch.int32), ((b,), torch.int32), ((b,), torch.int64),
        ((b,), torch.int64), ((b, 3), torch.int32))]
    plain = {
        "delta_crit_kernel": time_ms(
            lambda: ref.delta_thresholds_ref(d, status, keys[0], delta),
            reps=3, warmup=1),
        "delta_settle_mark_kernel": time_ms(
            lambda: ref.delta_mark_ref(d, status, keys, mins, counts, live0,
                                       one, delta, stop=False, deg_light=dl,
                                       deg_heavy=dh), reps=3, warmup=1),
        "delta_settle_push_kernel": time_ms(
            lambda: ref.delta_settle_push_ref(d, st2, mark.light_src,
                                              mark.heavy_src, out, delta),
            reps=3, warmup=1),
        "settle_tail_kernel": time_ms(
            lambda: ref.settle_tail_ref(st2, counts[0], mark, None, *zeros,
                                        one), reps=5, warmup=1)}
    new_d, new_st = ref.delta_settle_push_ref(d, st2, mark.light_src,
                                              mark.heavy_src, out, delta)
    touched = int(((new_d.view(torch.int32) != d.view(torch.int32))
                   | (new_st != st2)).sum())
    src = mark.light_src | mark.heavy_src
    act = src.any(dim=0)
    deg = st.out_deg.long()
    row_bytes = 8 * int(deg[act].sum())
    entries = (-(-b // 32)) * (int(vrows[act, 2].sum()) if vrows is not None
                               else int(act.sum()))
    cand = (int(torch.where(mark.light_src, dl.long()[None], 0).sum())
            + int(torch.where(mark.heavy_src, dh.long()[None], 0).sum()))
    src_lanes = int(src.sum())
    relax_v = int((mark.cur | mark.heavy_from).any(dim=0).sum())

    def sectors_of(mask):
        m = mask.reshape(-1)
        m = torch.cat([m, m.new_zeros((-m.numel()) % 8)])
        return int(m.view(-1, 8).any(dim=1).sum())

    fringe = status == 1
    n_fringe = int(fringe.sum())
    sectors = sectors_of(fringe)
    # the mark's reads by each lane's turn: d and (in the lane's bucket)
    # last_proc on a light round, removed and (at removed) d on the heavy
    light = ref.delta_light_lanes(mins, counts)[:, None]
    sec = {"light d": sectors_of(fringe & light),
           "light last_proc": sectors_of(
               fringe & light
               & (ref.delta_bucket_ids(d, delta) == mins[0][:, None])),
           "heavy removed": sectors_of(fringe & ~light),
           "heavy d": sectors_of(fringe & ~light & (keys[1] > 0.5))}
    bounds = {
        "delta_crit_kernel": bound(12 * d.numel(), 2.0 * d.numel()),
        "delta_settle_mark_kernel": bound(
            4 * d.numel() + 32 * sum(sec.values()) + 4 * relax_v
            + (16 * int(act.sum()) if vrows is not None else 0)
            + 4 * n_heavy + 8 * (n_light + n_heavy) + 4 * src_lanes
            + 8 * entries, float(d.numel() + 2 * n_fringe)),
        "delta_settle_push_kernel": bound(
            row_bytes + 8 * entries + 4 * src_lanes + 8 * touched,
            2.0 * cand),
        "settle_tail_kernel": bound(40 * b, 0.0)}
    log(f"delta pair [{label}] [{smi}]: {n_fringe} fringe lane-slots in "
        f"{sectors} of {-(-d.numel() // 8)} 32-byte sectors (the mark "
        f"reads " + ", ".join(f"{k} in {v}" for k, v in sec.items())
        + f"), {n_light} "
        f"light and {n_heavy} heavy lane-vertices, {int(act.sum())} source "
        f"vertices ({src_lanes} lane-sources, {entries} worklist entries), "
        f"{cand} candidates of their turn, {touched} targets touched; "
        f"device ms a call (pair, parent, parent, pair): "
        + ", ".join(f"{nm.replace('_kernel', '')} "
                    f"{kernel_named(splits[0], nm):.4f} / "
                    f"{kernel_named(splits[3], nm):.4f}"
                    for nm in DELTA_PHASE_KERNELS)
        + f"; the pair {sum(ms.values()):.4f} against the parent's phase "
        + ", ".join(f"{p[0]:.4f} (#2 {p[1]:.4f}, #5c/#9c {p[2]:.4f}, glue "
                    f"{p[3]:.4f})" for p in parent_parts)
        + "; bounds " + ", ".join(
            f"{nm.replace('_kernel', '')} {bounds[nm][0]:.4f} "
            f"({bounds[nm][1]})" for nm in DELTA_PHASE_KERNELS)
        + "; twins " + ", ".join(f"{nm.replace('_kernel', '')} "
                                 f"{plain[nm]:.4f}"
                                 for nm in DELTA_PHASE_KERNELS) + " ms")
    return {"ms": ms, "plain_ms": plain, "bounds": bounds,
            "parent_ms": parent_ms[0], "parent_crit_ms": parent_ms[1],
            "parent_push_ms": parent_ms[2], "parent_glue_ms": parent_ms[3],
            "max_abs_err": max_abs_err(got.dist, want.dist),
            "light": n_light, "heavy": n_heavy, "entries": entries,
            "candidates": cand, "touched": touched, "sectors": sectors,
            "mark_sectors": sec}


def seeded_push_dmask(rng, b: int, n: int, live: float, dev):
    """(B, n) relax input: d on a share ``live`` of the slots, +inf
    elsewhere, and a NaN in every lane."""
    import torch

    dm = np.full((b, n), np.inf, np.float32)
    on = rng.random((b, n)) < live
    dm[on] = rng.uniform(0.0, 10.0, on.sum()).astype(np.float32)
    dm[np.arange(b), rng.integers(0, n, b)] = np.nan
    return torch.from_numpy(dm).to(dev)


def seeded_state(rng, b: int, n: int, dev):
    """(d, status) with a U/F/S mix and +inf holes, made on the host."""
    import torch

    d = rng.uniform(0.0, 10.0, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.3] = np.inf
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(status).to(dev)


def signed_weights(ws):
    """A view's weights mapped onto {+0, -0, 0.5, 1} by value (w in [0, 1)
    goes to SIGNED[int(4 w)]; +inf stays): an edge keeps one weight in its
    in- and out-view, and ties of -0 and +0 arise in every fold."""
    import torch

    table = torch.tensor(SIGNED, dtype=torch.float32, device=ws.device)
    q = (ws.clamp(0.0, 0.999) * 4).long()
    return torch.where(torch.isfinite(ws), table[q], ws).contiguous()


def signed_vec(rng, shape, dev, inf_frac=0.2, nan=True):
    """Values from {+0, -0, 0.5, 1}, +inf on ``inf_frac`` of the slots, and
    (``nan``) a NaN at three slots of lane 1; made on the host."""
    import torch

    x = np.array(SIGNED, np.float32)[rng.integers(0, len(SIGNED), shape)]
    x[rng.random(shape) < inf_frac] = np.inf
    if nan:
        lane = (slice(None),) * (len(shape) - 2) + (1,)
        x[lane + (rng.integers(0, shape[-1], 3),)] = np.nan
    return torch.from_numpy(x).to(dev)


def kernel_counters() -> dict:
    """name -> (wrapper, its launch-count attribute) of every kernel the
    script counts: the SSSP wrappers' (``kernels.launch_counters``) and
    #12's."""
    from repro_torch.kernels import launch_counters
    from repro_torch.kernels.embed_grad import embed_grad

    counted = launch_counters()
    counted["embed_grad"] = (embed_grad, "launches")
    # #12's block form: a rank's rows of the vocabulary-parallel embedding
    counted[EMBED_BLOCK] = (embed_grad, "block_launches")
    return counted


EMBED_BLOCK = "embed_grad[block]"  # #12 on a rank's block of the table
# the LM's own kernels; the rest are SSSP's
LM_KERNELS = ("embed_grad", EMBED_BLOCK)


def sssp_launched(counts: dict) -> dict:
    """The SSSP kernels that ``counts`` shows launched."""
    return {k: v for k, v in counts.items() if v and k not in LM_KERNELS}


SHARDED_LABEL = "2 ranks sharing one H100, gloo through host memory"
SHARDED_RELAX = ("ell_push_rect_batch", "frontier_crit_lanes_batch")
SHARDED_NEVER = ("ell_relax_batch", "ell_push_relax_batch",
                 "ell_sliced_gather_min_batch", "ell_sliced_push_relax_batch",
                 "ell_gather_min_batch", "ell_key_min_batch",
                 "ell_relax_keys_batch", "ell_keys_dep_batch")


def sharded_rank(rank: int, world: int, store: str, job: str):
    """One rank of phase 26's gloo world (the ranks share cuda:0): the B = 8
    solve of phase 4's sources under the default plan on both schedules
    and ``in|out`` on one, each held by rank 0 against phases 4 and 9's
    kernel solves, every rank's launches checked (#2 and the rectangular
    push run, no pull, no square push); then ``ShardedBackend`` under
    ``ContinuousBatcher`` on rank 0 answering phase 3's 16 requests (the
    other ranks follow), rows against phase 3's. Writes
    ``<job>/rank<r>.json``; any failure raises, and the parent's join
    fails."""
    import torch
    import torch.distributed as tdist

    from repro_torch.core import distributed as D
    from repro_torch.graphs import uniform_gnp
    from repro_torch.launch.mesh import init_group
    from repro_torch.serving import ContinuousBatcher, ShardedBackend

    rank, world, dev = init_group(rank, world, backend="gloo",
                                  init_method=store, device="cuda:0")
    counted = kernel_counters()
    want = np.load(Path(job) / "ref.npz")
    report = {"rank": rank, "paths": {}}
    try:
        t0 = time.perf_counter()
        g = uniform_gnp(N, P, seed=SEED, device=dev)
        torch.cuda.synchronize()
        report["graph_s"] = time.perf_counter() - t0
        src8 = want["src8"]

        def run(label, tag, **kw):
            for f, attr in counted.values():
                setattr(f, attr, 0)
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = D.run_sharded_batch(g, None, src8, device=dev, stats=stats,
                                      **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {nm: getattr(f, a) for nm, (f, a) in counted.items()}
            for nm in SHARDED_RELAX:
                if counts[nm] <= 0:
                    raise SystemExit(f"rank {rank} {label}: {nm} never ran")
            ran = {nm: counts[nm] for nm in SHARDED_NEVER if counts[nm]}
            if ran:
                raise SystemExit(f"rank {rank} {label}: another relax or "
                                 f"scan ran: {ran}")
            if rank == 0:
                for f in ("dist", "status", "phases"):
                    got = getattr(res, f).cpu().numpy()
                    if not np.array_equal(got.view(np.uint8),
                                          want[f"{tag}_{f}"].view(np.uint8)):
                        raise SystemExit(f"sharded {label}: {f} differs from "
                                         "the single-card kernel solve")
                for f in ("sum_fringe", "relax_edges"):
                    if not np.array_equal(getattr(res, f), want[f"{tag}_{f}"]):
                        raise SystemExit(f"sharded {label}: {f} differs")
                if int(res.total_phases) != int(want[f"{tag}_trips"]):
                    raise SystemExit(f"sharded {label}: trips differ")
            report["paths"][label] = {
                "wall_s": wall, "trips": int(res.total_phases),
                "exchange_s": stats.get("exchange_s", 0.0),
                "collectives": stats.get("collectives", 0),
                "launches": counts}

        for sched in D.SCHEDULES:
            run(f"default {sched}", "k", schedule=sched)
        run("in|out reduce_scatter", "io", schedule="reduce_scatter",
            criterion="in|out")

        for f, attr in counted.values():
            setattr(f, attr, 0)
        backend = ShardedBackend(g, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rank == 0:
            server = ContinuousBatcher(g, lanes=LANES, phases_per_step=CHUNK,
                                       backend=backend)
            for s in want["sources"]:
                server.submit(int(s))
            done = sorted(server.drain(max_steps=100_000),
                          key=lambda r: r.req_id)
            backend.close()
            if len(done) != REQUESTS or any(r.outcome != "ok" for r in done):
                raise SystemExit("ShardedBackend did not answer every request")
            for r in done:
                if not np.array_equal(r.dist.view(np.int32),
                                      want["rows"][r.req_id].view(np.int32)):
                    raise SystemExit(f"ShardedBackend row {r.req_id} differs "
                                     "from phase 3's")
            served = {"requests": len(done), "steps": server.metrics.steps,
                      "trips": int(server.metrics.engine_trips)}
        else:
            served = {"commands": backend.follow()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {nm: getattr(f, a) for nm, (f, a) in counted.items()}
        for nm in SHARDED_RELAX:
            if counts[nm] <= 0:
                raise SystemExit(f"rank {rank} serving: {nm} never ran")
        report["paths"]["serving"] = dict(served, wall_s=wall,
                                          launches=counts)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    with open(Path(job) / f"rank{rank}.json", "w") as f:
        json.dump(report, f)


def lm_inputs(cfg, b: int, s: int, extra: int, seed: int) -> tuple:
    """numpy inputs from a seed: the batch over s positions (tokens or
    embeddings, and the vision stub) and ``extra`` more tokens to decode."""
    rng = np.random.default_rng(seed)
    batch = {}
    toks = rng.integers(0, cfg.vocab, (b, s + extra)).astype(np.int64)
    if cfg.embeddings_in:
        batch["embeds"] = (0.1 * rng.standard_normal((b, s, cfg.d_model))
                           ).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :s]
    if cfg.n_vision_tokens:
        batch["vision"] = (0.02 * rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    return batch, toks[:, s:]


def torch_from(arr, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def lm_on(batch: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def lm_close(what: str, got, want, rtol: float, atol: float) -> float:
    """The largest absolute difference of two tensors (moved to the host);
    raises unless every element is within ``atol + rtol * |want|``."""
    import torch

    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    if got.shape != want.shape:
        raise SystemExit(f"{what}: shape {tuple(got.shape)} against "
                         f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SystemExit(f"{what}: non-finite values")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise SystemExit(f"{what}: differ by up to {err:.3e} (rtol {rtol}, "
                         f"atol {atol})")
    return float((got.double() - want.double()).abs().max())


def lm_cache_close(what: str, got: list, want: list, rtol, atol) -> float:
    worst = 0.0
    if len(got) != len(want):
        raise SystemExit(f"{what}: {len(got)} units against {len(want)}")
    for u, (gu, wu) in enumerate(zip(got, want)):
        if gu.keys() != wu.keys():
            raise SystemExit(f"{what}: unit {u} layers differ")
        for lname, entry in wu.items():
            for leaf, w in entry.items():
                worst = max(worst, lm_close(f"{what} unit {u} {lname}.{leaf}",
                                            gu[lname][leaf], w, rtol, atol))
    return worst


def lm_smoke_pair(arch: str, dev) -> dict:
    """One smoke config on the card against the same weights on the CPU:
    forward_logits, prefill (logits and every cache leaf) and
    LM_SMOKE_STEPS decode steps (logits, cache, pos); the largest
    difference of each."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import (decode_step, forward_logits, init_params,
                                    prefill)

    cfg = get_smoke(arch)
    card = init_params(cfg, seed=0, device=dev)
    host = copy.deepcopy(card).cpu()
    batch, nxt = lm_inputs(cfg, LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_STEPS, 0)
    tol = (LM_SMOKE_TOL, LM_SMOKE_TOL)
    errs = {"forward": lm_close(
        f"{arch} forward_logits", forward_logits(cfg, card, lm_on(batch, dev)),
        forward_logits(cfg, host, lm_on(batch, "cpu")), *tol)}
    if cfg.encoder_only:
        return errs
    lg_d, c_d, pos_d = prefill(cfg, card, lm_on(batch, dev))
    lg_h, c_h, pos_h = prefill(cfg, host, lm_on(batch, "cpu"))
    errs["prefill"] = max(lm_close(f"{arch} prefill logits", lg_d, lg_h, *tol),
                          lm_cache_close(f"{arch} prefill", c_d, c_h, *tol))
    errs["decode"] = 0.0
    for i in range(LM_SMOKE_STEPS):
        tok = nxt[:, i:i + 1]
        lg_d, c_d, pos_d = decode_step(cfg, card, torch_from(tok, dev), c_d,
                                       pos_d)
        lg_h, c_h, pos_h = decode_step(cfg, host, torch_from(tok, "cpu"), c_h,
                                       pos_h)
        if pos_d != pos_h or pos_d != LM_SMOKE_S + i + 1:
            raise SystemExit(f"{arch} decode step {i}: pos {pos_d} / {pos_h}")
        errs["decode"] = max(
            errs["decode"],
            lm_close(f"{arch} decode {i} logits", lg_d, lg_h, *tol),
            lm_cache_close(f"{arch} decode {i}", c_d, c_h, *tol))
    return errs


def lm_kinds(split) -> dict:
    """Device ms a call by kind of kernel: matrix products (cuBLAS),
    copies (casts and the permutes before a product), softmax, reductions,
    other elementwise; with the launches of each."""
    kinds = {}
    for name, ms, calls in split:
        low = name.lower()
        kind = ("gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                                  "cutlass", "cublas"))
                else "copy" if "copy" in low
                else "softmax" if "softmax" in low
                else "reduce" if "reduce" in low
                else "elementwise" if "elementwise" in low else "other")
        ms_sum, n = kinds.get(kind, (0.0, 0.0))
        kinds[kind] = (ms_sum + ms * calls, n + calls)
    return {k: [round(v[0], 4), round(v[1], 2)]
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1][0])}


def lm_bounds(cfg, n_params: int, b: int, s: int, pos: int) -> dict:
    """The least time the card could take (ms) for one bf16 prefill of b x s
    tokens and one decode step at slot ``pos``, from the shapes: decode
    moves every weight but the embedding table once (b of its rows), the
    attention caches' first pos + 1 slots and the SSM states (f32, read and
    written); prefill does 2 x the weights' products a token (the LM head
    for the last token only), causal attention's QK and AV over half of
    the S x S pairs in bf16, and the SSD's chunk products in f32 (its
    einsums run on f32 inputs: 67 TFLOP/s, TF32 off)."""
    D, V = cfg.d_model, cfg.vocab_pad
    embed = V * D if not cfg.embeddings_in else 0
    head = D * V
    body = n_params - embed - head
    n_attn = sum(m == "attn" for m, _ in cfg.pattern) * cfg.n_units
    n_mamba = sum(m == "mamba" for m, _ in cfg.pattern) * cfg.n_units
    H, dh, K = cfg.n_heads, cfg.d_head, cfg.n_kv
    Hs, N, Pd, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups
    k = cfg.ssm_conv - 1
    # decode
    w_bytes = 2 * (n_params - embed + b * D)
    kv_bytes = n_attn * 2 * 2 * b * K * dh * (pos + 1)  # read, incl. the new
    ssm_bytes = n_mamba * (2 * 4 * b * Hs * N * Pd
                           + 2 * 2 * b * k * (cfg.d_inner + 2 * G * N))
    dec_bytes = w_bytes + kv_bytes + ssm_bytes
    dec_ops = 2 * (n_params - embed) * b
    dec_ms = max(dec_bytes / HBM_BYTES_PER_S, dec_ops / BF16_OPS_PER_S) * 1e3
    # prefill
    tokens = b * s
    mm_ops = 2 * body * tokens + 2 * head * b
    attn_ops = n_attn * 2 * b * H * dh * s * s  # 2 products x 2 flops x 1/2
    Q = min(cfg.ssm_chunk, s) if s % min(cfg.ssm_chunk, s) == 0 else s
    ssd_ops = n_mamba * b * (s // Q) * (2 * Q * Q * Hs * (N + Pd)
                                        + 4 * Q * Hs * N * Pd)
    pre_ms = ((mm_ops + attn_ops) / BF16_OPS_PER_S
              + ssd_ops / F32_OPS_PER_S) * 1e3
    pre_bytes_ms = 2 * n_params / HBM_BYTES_PER_S * 1e3
    return {"decode_ms": dec_ms, "decode_bytes": dec_bytes,
            "decode_weight_bytes": w_bytes, "decode_cache_bytes": kv_bytes,
            "decode_ssm_bytes": ssm_bytes,
            "decode_by": "bytes" if dec_bytes / HBM_BYTES_PER_S
            >= dec_ops / BF16_OPS_PER_S else "operations",
            "prefill_ms": max(pre_ms, pre_bytes_ms),
            "prefill_ops": mm_ops + attn_ops + ssd_ops,
            "prefill_by": "operations" if pre_ms >= pre_bytes_ms else "bytes"}


def lm_full_width(name: str, want_params: int, dev, run_peak: list) -> dict:
    """One published config at full width on the card: the parameter
    count; the reference's decode-vs-forward check in f32 (B = 2, a 512-token
    prompt, one decode step, against forward_logits over 513 tokens); the
    card against the CPU in f32 on one 64-token request; then the bf16
    served run (LM_PROMPT_B prompts of LM_PROMPT_S tokens, prefill, LM_GEN
    greedy decode steps) timed beside its bounds, with a torch.profiler
    split of one prefill and one decode step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward_logits, init_params,
                                    param_count, prefill)

    cfg = get_config(name)
    out = {"config": name}
    n_params = param_count(init_params(cfg, device="meta"))
    if n_params != want_params:
        raise SystemExit(f"{name}: {n_params} parameters, want {want_params}")
    out["params"] = n_params
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)  # f32
    torch.cuda.synchronize()
    out["init_f32_s"] = time.perf_counter() - t0

    # (1) decode against forward, f32 (tests/test_archs_smoke.py's check).
    # 513 positions are no multiple of the SSD chunk (128), so the SSD
    # would fall back to one chunk of 513, whose f32 decays exp(cum_i -
    # cum_j) lose ~1e-2 of the logits at full width (the reference's
    # fallback: PERF.md §6, PR 23); the forward here runs the same
    # arithmetic in chunks that divide 513, and the fallback's own
    # difference is reported beside it
    batch, nxt = lm_inputs(cfg, 2, 512, 1, seed=1)
    full_b = lm_on({"tokens": np.concatenate([batch["tokens"], nxt], axis=1)},
                   dev)
    fcfg = cfg
    if cfg.has("mamba") and 513 % min(cfg.ssm_chunk, 513):
        fcfg = dataclasses.replace(cfg, ssm_chunk=max(
            q for q in range(1, cfg.ssm_chunk + 1) if 513 % q == 0))
    full = forward_logits(fcfg, model, full_b)
    lg, cache, pos = prefill(cfg, model, lm_on(batch, dev))
    lg_pre = lg
    e_pre = lm_close(f"{name} prefill vs forward", lg, full[:, 511], 1e-3, 2e-3)
    lg, cache, pos = decode_step(cfg, model, torch_from(nxt, dev), cache, pos)
    e_dec = lm_close(f"{name} decode vs forward", lg, full[:, 512], 1e-3, 2e-3)
    if pos != 513:
        raise SystemExit(f"{name}: decode returned pos {pos}, want 513")
    out["decode_vs_forward_f32"] = {"prefill_err": e_pre, "decode_err": e_dec,
                                    "forward_ssm_chunk": fcfg.ssm_chunk}
    if fcfg is not cfg:  # the one-chunk fallback, measured, not gated
        one = forward_logits(cfg, model, full_b)
        out["decode_vs_forward_f32"]["one_chunk_fallback"] = {
            "prefill_err": max_abs_err(one[:, 511], lg_pre),
            "decode_err": max_abs_err(one[:, 512], lg),
            "vs_chunked_forward_err": max_abs_err(one, full)}
        del one
    del full, cache, lg, lg_pre

    # (2) the card against the CPU, f32, one 64-token request
    batch64, _ = lm_inputs(cfg, 1, 64, 0, seed=2)
    t0 = time.perf_counter()
    host = copy.deepcopy(model).cpu()
    want = forward_logits(cfg, host, lm_on(batch64, "cpu"))
    out["card_vs_cpu_f32"] = {
        "err": lm_close(f"{name} card vs cpu", forward_logits(
            cfg, model, lm_on(batch64, dev)), want, 1e-3, 1e-3),
        "host_s": time.perf_counter() - t0}
    del host, want, model
    torch.cuda.empty_cache()

    # (3) the bf16 served run; its peak is counted above what was resident
    # before its weights were drawn (earlier phases' graphs stay resident)
    torch.cuda.synchronize()
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    on = torch.device(dev).type  # cuda; a rehearsal on the host passes cpu
    off = [n for n, p in model.named_parameters() if p.device.type != on]
    if off:
        raise SystemExit(f"{name}: parameters off the card: {off[:3]}")
    prompts, _ = lm_inputs(cfg, LM_PROMPT_B, LM_PROMPT_S, 0, seed=3)
    prompts = lm_on(prompts, dev)

    def serve(gen: int):
        lg, cache, pos = prefill(cfg, model, prompts)
        tok = lg.argmax(-1, keepdim=True)
        toks = [tok]
        for _ in range(gen):
            lg, cache, pos = decode_step(cfg, model, tok, cache, pos)
            tok = lg.argmax(-1, keepdim=True)
            toks.append(tok)
        return torch.cat(toks, dim=1), cache, pos, lg

    serve(2)  # warm-up: the first calls pick their cuBLAS kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache, pos = prefill(cfg, model, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = lg.argmax(-1, keepdim=True)
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(LM_GEN):
        lg, cache, pos = decode_step(cfg, model, tok, cache, pos)
        tok = lg.argmax(-1, keepdim=True)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated() - resident
    gen = torch.cat(toks, dim=1)
    leaves = [t for unit in cache for entry in unit.values()
              for t in entry.values()]
    if any(t.device.type != on for t in leaves + [gen, lg]):
        raise SystemExit(f"{name}: a cache leaf or output left the card")
    if not bool(torch.isfinite(lg.float()).all()):
        raise SystemExit(f"{name}: non-finite bf16 logits")
    if gen.shape != (LM_PROMPT_B, LM_GEN + 1) or pos != LM_PROMPT_S + LM_GEN:
        raise SystemExit(f"{name}: generated {tuple(gen.shape)}, pos {pos}")
    if int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab:
        raise SystemExit(f"{name}: a generated id outside the vocabulary")
    b = lm_bounds(cfg, n_params, LM_PROMPT_B, LM_PROMPT_S,
                  LM_PROMPT_S + LM_GEN // 2)
    step_ms = decode_s / LM_GEN * 1e3
    out["served_bf16"] = {
        "batch": LM_PROMPT_B, "prompt": LM_PROMPT_S, "decode_steps": LM_GEN,
        "prefill_ms": prefill_s * 1e3, "prefill_bound_ms": b["prefill_ms"],
        "prefill_bound_by": b["prefill_by"],
        "prefill_tokens_per_s": LM_PROMPT_B * LM_PROMPT_S / prefill_s,
        "decode_ms_per_step": step_ms, "decode_bound_ms": b["decode_ms"],
        "decode_bound_by": b["decode_by"],
        "decode_bytes_per_step": b["decode_bytes"],
        "decode_weight_bytes": b["decode_weight_bytes"],
        "decode_cache_bytes": b["decode_cache_bytes"],
        "decode_ssm_bytes": b["decode_ssm_bytes"],
        "generated_tokens_per_s": LM_PROMPT_B * LM_GEN / decode_s,
        "peak_gib": peak / 2**30, "resident_before_gib": resident / 2**30,
        "first_ids": gen[0, :8].tolist()}

    # (4) where the time goes: one prefill, one decode step (torch.profiler,
    # after a warm-up call each); the device's busy share of a decode step
    pre_split = device_split_counted(
        lambda: prefill(cfg, model, prompts), calls=1)
    dec_split = device_split_counted(
        lambda: decode_step(cfg, model, tok, cache, pos - 1), calls=3)
    dev_ms = sum(t * c for _, t, c in dec_split)

    def top(split, n=6):
        rows = sorted(split, key=lambda r: -r[1] * r[2])[:n]
        return [[k, round(t * c, 4), round(c, 2)] for k, t, c in rows]

    out["profile"] = {
        "prefill_device_ms": sum(t * c for _, t, c in pre_split),
        "prefill_by_kind": lm_kinds(pre_split),
        "prefill_top": top(pre_split),
        "decode_device_ms_per_step": dev_ms,
        "decode_kernels_per_step": sum(c for _, _, c in dec_split),
        "decode_busy_share": dev_ms / step_ms,
        "decode_by_kind": lm_kinds(dec_split),
        "decode_top": top(dec_split)}
    del model, cache, prompts
    torch.cuda.empty_cache()
    return out


def lm_serving_phase(dev, smi: str, run_peak: list) -> dict:
    """Phase 27: LM serving. (a) every smoke config, card against CPU in f32
    with TF32 off; (b) internlm2-1.8b and (c) mamba2-1.3b at full width."""
    import torch

    from repro_torch.configs import ARCHS

    t27 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise SystemExit("phase 27 compares f32 with TF32 off; it is on")
    log("lm: TF32 off (torch.backends.cuda.matmul.allow_tf32 and "
        "torch.backends.cudnn.allow_tf32 False): f32 products in full f32")
    result = {"tf32": False, "smoke": {}}
    t0 = time.perf_counter()
    for arch in ARCHS:
        errs = lm_smoke_pair(arch, dev)
        result["smoke"][arch] = errs
        log(f"lm smoke {arch}: card against CPU (f32, same weights), largest "
            f"difference " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (rtol = atol = {LM_SMOKE_TOL})")
    result["smoke_s"] = time.perf_counter() - t0
    for key, name, want in (("internlm2", "internlm2-1.8b", 1_889_634_304),
                            ("mamba2", "mamba2-1.3b", 1_447_336_960)):
        t0 = time.perf_counter()
        r = lm_full_width(name, want, dev, run_peak)
        r["seconds"] = time.perf_counter() - t0
        result[key] = r
        s, p = r["served_bf16"], r["profile"]
        dvf = r["decode_vs_forward_f32"]
        log(f"lm {name}: {r['params']:,} parameters; f32 prefill / decode "
            f"against forward_logits over 513 tokens (ssm_chunk "
            f"{dvf['forward_ssm_chunk']}): {dvf['prefill_err']:.3e} / "
            f"{dvf['decode_err']:.3e} (rtol 1e-3, atol 2e-3); card against "
            f"CPU, 64 tokens: {r['card_vs_cpu_f32']['err']:.3e} (rtol = atol"
            " = 1e-3)")
        if "one_chunk_fallback" in dvf:
            fb = dvf["one_chunk_fallback"]
            log(f"lm {name}: the forward's one-chunk fallback (513 positions "
                f"in one SSD chunk) differs from prefill / decode by "
                f"{fb['prefill_err']:.3e} / {fb['decode_err']:.3e} and from "
                f"the chunked forward by {fb['vs_chunked_forward_err']:.3e}")
        log(f"lm {name} [{smi}] bf16, B={s['batch']} x {s['prompt']} tokens: "
            f"prefill {s['prefill_ms']:.2f} ms (bound {s['prefill_bound_ms']:.2f}"
            f", {s['prefill_bound_by']}); decode {s['decode_ms_per_step']:.3f} "
            f"ms/step (bound {s['decode_bound_ms']:.3f}, {s['decode_bound_by']}"
            f": {s['decode_bytes_per_step'] / 1e9:.3f} GB a step); "
            f"{s['generated_tokens_per_s']:.1f} generated tokens/s; peak "
            f"{s['peak_gib']:.2f} GiB above the {s['resident_before_gib']:.2f}"
            " GiB earlier phases left resident")
        log(f"lm {name} profile: prefill {p['prefill_device_ms']:.2f} device "
            f"ms, by kind [ms, launches] {p['prefill_by_kind']}; decode "
            f"{p['decode_device_ms_per_step']:.3f} device ms a step in "
            f"{p['decode_kernels_per_step']:.0f} kernels, busy "
            f"{p['decode_busy_share']:.1%}, by kind {p['decode_by_kind']}")
        log(f"lm {name} top device ops: prefill {p['prefill_top']}; decode "
            f"{p['decode_top']}")
    result["seconds"] = time.perf_counter() - t27
    log(f"phase 27: {result['seconds']:.1f} s")
    return result


def lm_train_tol(cfg) -> tuple:
    """The tests' tolerances, read from their one definition
    (``tests/test_torch_lm_train_tol.py``, which imports no JAX): (loss
    rtol, gradient rtol, gradient atol as a share of the leaf's largest
    magnitude); Mamba models wider."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    from test_torch_lm_train_tol import train_tol

    return train_tol(cfg)


def lm_loss_grads(cfg, model, batch, remat: bool, policy: str = "full"):
    import torch

    from repro_torch.models import train_loss

    loss = train_loss(cfg, model, batch, remat=remat, remat_policy=policy)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def lm_grads_close(what: str, names, got, want, rtol, share) -> float:
    """Raises unless each gradient leaf is within rtol and an atol of
    ``share`` times the leaf's largest magnitude; the largest difference
    as a share of its leaf's largest magnitude."""
    import torch

    worst = 0.0
    for name, g, w in zip(names, got, want):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        scale = float(w.abs().max())
        if not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{what} {name}: non-finite gradient")
        if not torch.allclose(g, w, rtol=rtol, atol=share * scale):
            raise SystemExit(f"{what} {name}: gradients differ by up to "
                             f"{float((g - w).abs().max()):.3e} (rtol {rtol}, "
                             f"atol {share} x {scale:.3e})")
        if scale > 0:
            worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def lm_train_smoke_pair(arch: str, dev) -> dict:
    """Phase 28 (a): one smoke config on the card against the same weights
    and batch on the CPU: ``train_loss`` under remat none, "full" and
    "dots" and every gradient leaf; then one ``apply_updates`` step on each
    side from the same weights and the same (the host's) gradients, in
    both ``v_mode``s with ``m`` in f32 and bf16."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state

    cfg = get_smoke(arch)
    loss_rtol, g_rtol, g_share = lm_train_tol(cfg)
    card = init_params(cfg, seed=0, device=dev).requires_grad_()
    host = copy.deepcopy(card).cpu()
    names = [n for n, _ in card.named_parameters()]
    b_h = batch_for(cfg, DataConfig(batch=LM_SMOKE_B, seq_len=LM_SMOKE_S), 0,
                    device="cpu")
    b_d = {k: v.to(dev) for k, v in b_h.items()}
    out = {"loss_rel": 0.0, "grad_share": 0.0}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        loss_d, g_d = lm_loss_grads(cfg, card, b_d, remat, policy)
        loss_h, g_h = lm_loss_grads(cfg, host, b_h, remat, policy)
        rel = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
        if not np.isfinite(float(loss_d)) or rel > loss_rtol:
            raise SystemExit(f"{arch} train_loss remat={remat} {policy}: "
                             f"{float(loss_d)!r} on the card, "
                             f"{float(loss_h)!r} on the host")
        out["loss_rel"] = max(out["loss_rel"], rel)
        out["grad_share"] = max(out["grad_share"], lm_grads_close(
            f"{arch} remat={remat} {policy}", names, g_d, g_h, g_rtol,
            g_share))
    grads_h = dict(zip(names, g_h))
    grads_d = {n: g.to(dev) for n, g in grads_h.items()}
    out["adamw_share"] = 0.0
    for m_dtype in ("float32", "bfloat16"):
        for v_mode in ("full", "factored"):
            ocfg = OptConfig(lr=1e-2, warmup_steps=1, m_dtype=m_dtype,
                             v_mode=v_mode)
            sides = []
            for model, grads, where in ((card, grads_d, dev),
                                        (host, grads_h, "cpu")):
                stepped = copy.deepcopy(model)
                st = init_opt_state(stepped, ocfg, device=where)
                stats = apply_updates(stepped, grads, st, ocfg)
                sides.append((stepped, st, stats))
            (m_d, st_d, s_d), (m_h, st_h, s_h) = sides
            what = f"{arch} apply_updates {m_dtype} {v_mode}"
            if not (bool(s_d["finite"]) and bool(s_h["finite"])):
                raise SystemExit(f"{what}: not finite")
            bf16 = m_dtype == "bfloat16"
            # the CPU tests' tolerances (tests/test_torch_lm_train_optim.py)
            moved = [p1 - p0 for p1, p0 in zip(m_h.parameters(),
                                               host.parameters())]
            share = 2.0 ** -7 if bf16 else 1e-6
            for (name, pd), ph, dp in zip(m_d.named_parameters(),
                                          m_h.parameters(), moved):
                scale = float(dp.detach().abs().max())
                if not torch.allclose(pd.detach().cpu(), ph.detach(),
                                      rtol=2e-6, atol=share * scale):
                    raise SystemExit(f"{what} {name}: parameters differ")
                if scale > 0:
                    out["adamw_share"] = max(out["adamw_share"], float(
                        (pd.detach().cpu() - ph.detach()).abs().max()) / scale)
            for part in ("m", "v"):
                for path, want in st_h[part].items():
                    got = st_d[part][path]
                    pairs = ([(got, want)] if part == "m" else
                             [(got[k], want[k]) for k in want])
                    for g, w in pairs:
                        g, w = g.float().cpu(), w.float()
                        rtol = 2.0 ** -7 if bf16 and part == "m" else 2e-6
                        atol = (2.0 ** -8 if bf16 and part == "m" else 1e-6
                                ) * float(w.abs().max())
                        if not torch.allclose(g, w, rtol=rtol, atol=atol):
                            raise SystemExit(f"{what} {part}/{path} differs")
            if int(st_d["step"]) != 1:
                raise SystemExit(f"{what}: step {int(st_d['step'])}")
    return out


def lm_train_bounds(cfg, n_params: int, b: int, s: int) -> dict:
    """The least time (ms) of one training step of b x s tokens, from the
    code: the forward's products are 2 x (every weight but the embedding
    table, which is a lookup) a token, the LM head over every position
    included, and causal attention's QK and AV over half of the S x S
    pairs; the backward is twice a forward, so a step is 3 forwards, in
    f32 on CUDA cores (67 TFLOP/s, TF32 off). Full remat, the run's
    choice, runs each unit's forward and each cross-entropy chunk's once
    more in the backward: a cost of that choice (``recompute_ms``, one
    forward), not part of the bound. Bytes: the f32 parameters read twice
    (forward, backward) and written once, the f32 gradients written and
    read, the bf16 momentum read and written, over 3.35 TB/s."""
    D, V = cfg.d_model, cfg.vocab_pad
    n_attn = sum(m == "attn" for m, _ in cfg.pattern) * cfg.n_units
    tokens = b * s
    fwd = 2 * tokens * (n_params - V * D) + n_attn * 2 * b * cfg.n_heads \
        * cfg.d_head * s * s
    ops = 3 * fwd
    nbytes = 3 * 4 * n_params + 2 * 4 * n_params + 2 * 2 * n_params
    ops_ms, bytes_ms = ops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"forward_ops": fwd, "step_ops": ops, "step_bytes": nbytes,
            "step_ms": max(ops_ms, bytes_ms),
            "step_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "recompute_ms": fwd / F32_OPS_PER_S * 1e3}


def lm_ckpt_bytes(state_shapes: dict, n_params: int) -> int:
    """A checkpoint's array bytes: f32 parameters, the optimizer's leaves."""
    leaves = [state_shapes["step"]] + list(state_shapes["m"].values()) + [
        t for e in state_shapes["v"].values() for t in e.values()]
    return 4 * n_params + sum(t.numel() * t.element_size() for t in leaves)


def lm_full_width_cut(dev) -> dict:
    """Phase 28 (b): internlm2-1.8b at every published width, cut to
    LM_TRAIN_CUT layers. On the card: ``chunked_ce_loss`` (two chunks of
    512) against the cross-entropy of ``forward_logits``; the three remat
    choices' losses and gradients. Then the card's gradients against the
    CPU's on a shorter batch, leaf by leaf, by relative L2 error."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.models import forward_logits, init_params, train_loss

    cfg = dataclasses.replace(get_config("internlm2-1.8b"),
                              n_layers=LM_TRAIN_CUT)
    model = init_params(cfg, seed=0, device=dev).requires_grad_()
    names = [n for n, _ in model.named_parameters()]
    batch = batch_for(cfg, DataConfig(batch=LM_CUT_B, seq_len=LM_CUT_S), 0,
                      device=dev)
    out = {"layers": cfg.n_layers, "batch": LM_CUT_B, "seq": LM_CUT_S}
    with torch.no_grad():
        logits = forward_logits(cfg, model, batch).double()
        labels = batch["labels"].long()
        want = float((torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[..., None])[..., 0]).mean())
        del logits
        got = float(train_loss(cfg, model, batch, remat=True))
    out["ce_vs_forward_rel"] = abs(got - want) / abs(want)
    if out["ce_vs_forward_rel"] > 1e-5:
        raise SystemExit(f"internlm2 cut: chunked CE {got!r} against the "
                         f"forward's {want!r}")
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        runs[(remat, policy)] = lm_loss_grads(cfg, model, batch, remat, policy)
    loss0, g0 = runs[(False, "full")]
    out["remat"] = {}
    for key in ((True, "full"), (True, "dots")):
        loss, g = runs[key]
        rel = abs(float(loss) - float(loss0)) / abs(float(loss0))
        rl2 = max(float((a - b).double().norm() / b.double().norm())
                  for a, b in zip(g, g0))
        out["remat"][key[1]] = {"loss_rel": rel, "grad_rel_l2": rl2,
                                "loss_bit_equal": bool(torch.equal(loss,
                                                                   loss0))}
        if rel > 1e-6 or rl2 > 1e-6:
            raise SystemExit(f"internlm2 cut remat {key}: loss {rel:.3e}, "
                             f"gradients {rl2:.3e} from no remat")
    del runs, g0
    small = batch_for(cfg, DataConfig(batch=LM_HOST_B, seq_len=LM_HOST_S), 1,
                      device=dev)
    _, g_d = lm_loss_grads(cfg, model, small, True)
    host = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    _, g_h = lm_loss_grads(cfg, host, {k: v.cpu() for k, v in small.items()},
                           True)
    out["host_s"] = time.perf_counter() - t0
    worst = ("", 0.0)
    for name, a, b in zip(names, g_d, g_h):
        rl2 = float((a.cpu().double() - b.double()).norm()
                    / b.double().norm())
        if not rl2 <= LM_CUT_GRAD_RL2:
            raise SystemExit(f"internlm2 cut card vs cpu {name}: relative "
                             f"L2 error {rl2:.3e} > {LM_CUT_GRAD_RL2}")
        worst = max(worst, (name, rl2), key=lambda w: w[1])
    out["card_vs_cpu_grad_rel_l2"] = {"worst_leaf": worst[0],
                                      "worst": worst[1]}
    del model, host, g_d, g_h
    torch.cuda.empty_cache()
    return out


def lm_training_phase(dev, run_peak: list) -> dict:
    """Phase 28: LM training. (a) every smoke config, card against CPU;
    (b) internlm2-1.8b at full width on LM_TRAIN_CUT layers; (c) the timed
    run at full width on LM_TRAIN_UNITS units, its resume, a profiled
    step and the
    checkpoint's cost; (d) the launcher in a subprocess."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import ARCHS, get_config, get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import init_params, param_count
    from repro_torch.optim.adamw import OptConfig, init_opt_state

    t28 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise SystemExit("phase 28 compares f32 with TF32 off; it is on")
    result = {"tf32": False, "smoke": {}}

    # (a) every smoke config, card against CPU
    t0 = time.perf_counter()
    for arch in ARCHS:
        errs = lm_train_smoke_pair(arch, dev)
        result["smoke"][arch] = errs
        log(f"lm train smoke {arch}: card against CPU (f32, same weights and "
            f"batch): loss {errs['loss_rel']:.2e} relative over 3 remat "
            f"choices, gradients {errs['grad_share']:.2e} of each leaf's "
            f"largest, one AdamW step in 4 modes {errs['adamw_share']:.2e} "
            f"of each leaf's largest change (tolerances: "
            f"{lm_train_tol(get_smoke(arch))})")
    result["smoke_s"] = time.perf_counter() - t0

    # (b) full width, LM_TRAIN_CUT layers
    t0 = time.perf_counter()
    cut = lm_full_width_cut(dev)
    cut["seconds"] = time.perf_counter() - t0
    result["internlm2_cut"] = cut
    log(f"lm train internlm2-1.8b cut to {cut['layers']} layers (full "
        f"width), B={cut['batch']} x {cut['seq']}: chunked CE against the "
        f"forward's {cut['ce_vs_forward_rel']:.2e} relative; remat against "
        f"none {cut['remat']}; card against CPU (B={LM_HOST_B} x "
        f"{LM_HOST_S}) worst gradient relative L2 "
        f"{cut['card_vs_cpu_grad_rel_l2']} (limit {LM_CUT_GRAD_RL2})")

    # (c) the timed run at full width, LM_TRAIN_UNITS of the 24 units
    cfg = lm_cut("internlm2-1.8b", LM_TRAIN_UNITS)
    n_params = param_count(init_params(cfg, device="meta"))
    ocfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=LM_TRAIN_STEPS,
                     m_dtype="bfloat16", v_mode="factored")
    dcfg = DataConfig(seed=0, batch=LM_TRAIN_B, seq_len=LM_TRAIN_S)
    shapes = init_params(cfg, device="meta")
    ckpt_bytes = lm_ckpt_bytes(init_opt_state(shapes, ocfg, device="meta"),
                               n_params)
    work = tempfile.mkdtemp(prefix="lm_train_")
    try:
        disk = shutil.disk_usage(work)
        log(f"lm train: checkpoints in {work}: {disk.free / 1e9:.1f} GB free "
            f"of {disk.total / 1e9:.1f} GB; a checkpoint is "
            f"{ckpt_bytes / 1e9:.2f} GB, two at once are needed")
        if disk.free < 2.2 * ckpt_bytes:
            raise SystemExit(f"lm train: {disk.free / 1e9:.1f} GB free, two "
                             f"checkpoints need {2 * ckpt_bytes / 1e9:.1f}")
        run = lm_timed_run(cfg, dcfg, ocfg, n_params, ckpt_bytes, work, dev,
                           run_peak)
        run["disk_free_gb"] = disk.free / 1e9
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["timed"] = run

    # (d) the launcher, on the card, in its own process
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "internlm2_1_8b", "--smoke", "--steps", "3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600, check=False)
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    if proc.returncode != 0 or not (
            last[0].startswith("done: final loss ")
            and last[0].endswith("(skipped 0 poisoned steps)")):
        raise SystemExit(f"launcher: rc {proc.returncode}, {last[0]!r}; "
                         f"{proc.stderr[-2000:]}")
    result["launcher"] = {"line": last[0], "seconds": time.perf_counter() - t0}
    log(f"lm train launcher ({' '.join(cmd[1:])}): {last[0]}")
    result["seconds"] = time.perf_counter() - t28
    log(f"phase 28: {result['seconds']:.1f} s")
    return result


def lm_timed_run(cfg, dcfg, ocfg, n_params: int, ckpt_bytes: int, work: str,
                 dev, run_peak: list) -> dict:
    """Phase 28 (c): ``train()`` for LM_TRAIN_STEPS steps with a checkpoint
    every LM_TRAIN_EVERY (the watchdog at 0 s reads each step's wall time);
    a second ``train()`` resumed from the middle checkpoint, whose losses
    must follow the first's; a ``torch.profiler`` split of one step; a
    checkpoint's snapshot, write and restore, restored bit for bit."""
    import shutil

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import batch_for
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.train_loop import make_train_step, train

    out = {"config": "internlm2-1.8b", "params": n_params,
           "batch": dcfg.batch, "seq": dcfg.seq_len,
           "steps": LM_TRAIN_STEPS, "ckpt_every": LM_TRAIN_EVERY,
           "optimizer": "AdamW, m bf16, v factored, f32 parameters",
           "remat": "full"}
    ckdir = os.path.join(work, "run")
    torch.cuda.synchronize()
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step_s = {}
    t0 = time.perf_counter()
    first = train(cfg, LM_TRAIN_STEPS, dcfg, ocfg, ckpt_dir=ckdir,
                  ckpt_every=LM_TRAIN_EVERY,
                  watchdog=lambda s, dt: step_s.__setitem__(s, dt),
                  step_timeout_s=0.0, device=dev)
    out["run_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - resident) / 2**30
    out["resident_before_gib"] = resident / 2**30
    losses = first.losses
    if (first.skipped_steps or len(losses) != LM_TRAIN_STEPS
            or not all(np.isfinite(losses))):
        raise SystemExit(f"lm train: losses {losses}, skipped "
                         f"{first.skipped_steps}")
    out["losses"] = losses
    out["step_s"] = [step_s[i] for i in range(LM_TRAIN_STEPS)]
    med = float(np.median(out["step_s"][1:]))
    out["ms_per_step"] = med * 1e3
    out["tokens_per_s"] = dcfg.batch * dcfg.seq_len / med
    mgr = CheckpointManager(ckdir)
    if mgr.all_steps() != [LM_TRAIN_EVERY, LM_TRAIN_STEPS]:
        raise SystemExit(f"lm train: checkpoints {mgr.all_steps()}")
    out["ckpt_file_bytes"] = os.path.getsize(
        os.path.join(ckdir, f"ckpt_{LM_TRAIN_STEPS:08d}.npz"))
    # a crash before the last checkpoint was written: drop it and resume
    for ext in ("npz", "json"):
        os.remove(os.path.join(ckdir, f"ckpt_{LM_TRAIN_STEPS:08d}.{ext}"))
    t0 = time.perf_counter()
    again = train(cfg, LM_TRAIN_STEPS, dcfg, ocfg, ckpt_dir=ckdir,
                  ckpt_every=LM_TRAIN_EVERY, device=dev)
    out["resume_run_s"] = time.perf_counter() - t0
    want = losses[LM_TRAIN_EVERY:]
    if again.restored_from != LM_TRAIN_EVERY or not np.allclose(
            again.losses, want, rtol=LM_RESUME_RTOL, atol=0):
        raise SystemExit(f"lm train resume: from {again.restored_from}, "
                         f"losses {again.losses} against {want}")
    out["resumed_losses"] = again.losses
    out["resume_max_rel"] = max(abs(a - b) / abs(b)
                                for a, b in zip(again.losses, want))
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # one profiled step, then the checkpoint's cost, on a fresh model
    model = init_params(cfg, seed=0, device=dev)
    state = init_opt_state(model, ocfg, device=dev)
    step = make_train_step(cfg, ocfg, remat=True)
    batch = batch_for(cfg, dcfg, 0, device=dev)
    split = device_split_counted(lambda: step(model, state, batch), calls=1)
    dev_ms = sum(t * c for _, t, c in split)
    out["profile"] = {
        "device_ms": dev_ms, "kernels": sum(c for _, _, c in split),
        "busy_share": dev_ms / out["ms_per_step"],
        "by_kind": lm_kinds(split),
        "top": [[k, round(t * c, 3), round(c, 2)] for k, t, c in
                sorted(split, key=lambda r: -r[1] * r[2])[:6]]}
    del batch
    ck2 = os.path.join(work, "timing")
    mgr = CheckpointManager(ck2, keep=1)
    tree = {"params": model, "opt": state}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save_async(1, tree)
    snap_s = time.perf_counter() - t0
    mgr.wait()
    write_s = time.perf_counter() - t0 - snap_s
    t0 = time.perf_counter()
    back = mgr.restore(1, tree, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 back["params"].named_parameters()):
        if not torch.equal(p, q):
            raise SystemExit(f"lm checkpoint: {name} not restored bit for "
                             "bit")
    for part in ("m", "v"):
        for path, t in state[part].items():
            pairs = ([(t, back["opt"][part][path])] if part == "m" else
                     [(t[k], back["opt"][part][path][k]) for k in t])
            if not all(torch.equal(a, b) for a, b in pairs):
                raise SystemExit(f"lm checkpoint: opt/{part}/{path} not "
                                 "restored bit for bit")
    nbytes = os.path.getsize(os.path.join(ck2, "ckpt_00000001.npz"))
    out["checkpoint"] = {
        "bytes": nbytes, "array_bytes": ckpt_bytes,
        "snapshot_s": snap_s, "write_s": write_s, "restore_s": restore_s,
        "snapshot_bound_s": ckpt_bytes / PCIE_BYTES_PER_S,
        "write_gb_per_s": nbytes / write_s / 1e9}
    del model, state, back, tree
    shutil.rmtree(ck2, ignore_errors=True)
    torch.cuda.empty_cache()
    out["bound"] = lm_train_bounds(cfg, n_params, dcfg.batch, dcfg.seq_len)
    out["tokens_per_s_bound"] = (dcfg.batch * dcfg.seq_len
                                 / (out["bound"]["step_ms"] / 1e3))
    out["state_gib"] = (4 + 4 + 2) * n_params / 2**30  # p, g, m
    return out


# ---------------------------------------------------------------------------
# phase 29: the LM substrate on a mesh
# ---------------------------------------------------------------------------

MESH_LABEL = ("4 gloo ranks sharing one H100 as a 2 x 2 (data, model) mesh, "
              "every collective staged through host memory")
LM_MESH_B, LM_MESH_S, LM_MESH_GEN = 4, 64, 4  # (a): batch, prompt, decode
LM_EP_UNITS, LM_EP_B, LM_EP_S = 1, 2, 1024  # (b) qwen3-moe-235b, 94 -> 1
LM_EP_EXPERT = 77  # (b) the expert whose gradient is checked
LM_DENSE_UNITS, LM_DENSE_B, LM_DENSE_S = 4, 4, 2048  # (c) internlm2-1.8b
LM_MESH_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4,
                   m_dtype="bfloat16", v_mode="factored")


@contextlib.contextmanager
def lm_plain_moe(dp: int, tp: int):
    """Every MoE layer of the one-device path as the (dp, tp) mesh runs
    it: ``apply_moe_ep_plain`` where the reference's gate is on, the
    global view elsewhere (the one-card step the sharded one is held
    against)."""
    from repro_torch.models import layers as L

    def plain(cfg, p, x, shd=None):
        if L.ep_gate(cfg, x.shape[0], x.shape[1], dp, tp):
            return L.apply_moe_ep_plain(cfg, p, x, dp, tp)
        return saved(cfg, p, x)

    saved, L.apply_moe = L.apply_moe, plain
    try:
        yield
    finally:
        L.apply_moe = saved


def lm_cut(name: str, units: int):
    """A published config at full width, its depth cut to ``units`` units."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=units * len(cfg.pattern))


def lm_share(got, want) -> float:
    """The largest difference as a share of ``want``'s largest magnitude."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else float(
        (got - want).abs().max())


def lm_tree_share(got: dict, want: dict, what: str, rtol, share) -> float:
    """Each array of ``got`` (numpy, bf16 as records) against ``want``'s
    within rtol and ``share`` of its largest magnitude; the worst share."""
    import torch

    from repro_torch.interop import leaf_tensor

    worst = 0.0
    for key, w in want.items():
        g_t = leaf_tensor(got[key], "cpu").double()
        w_t = leaf_tensor(w, "cpu").double()
        scale = float(w_t.abs().max()) if w_t.numel() else 0.0
        if not torch.allclose(g_t, w_t, rtol=rtol, atol=share * scale):
            raise SystemExit(f"{what} {key}: differs by up to "
                             f"{float((g_t - w_t).abs().max()):.3e}")
        if scale > 0:
            worst = max(worst, float((g_t - w_t).abs().max()) / scale)
    return worst


def lm_mesh_smoke(arch: str, mesh, dev) -> dict:
    """Phase 29 (a), one smoke config on every rank of the 2 x 2 mesh (the
    one-card side on rank 0, which reports): the sharded loss and every
    gradient (FSDP over "data"; the step timed and its gloo bytes counted)
    against the one-card step (the plain expert-parallel twin for MoE
    layers); one AdamW step (bf16 m, factored v) of the placed model and
    of the one-card model on the same (the one card's, sent from rank 0)
    gradients; then the sharded prefill and 4 decode steps of
    ``build_step``'s cells (an encoder's forward) against one card's."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.interop import lm_params_to_numpy, opt_state_to_numpy
    from repro_torch.launch.steps import build_step
    from repro_torch.models import (
        decode_step,
        forward_logits,
        init_params,
        prefill,
    )
    from repro_torch.models.layers import ShardingCtx
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.sharding import comm
    from repro_torch.sharding.partition import (
        gather_param,
        place_like,
        place_params,
    )

    cfg = get_smoke(arch)
    loss_rtol, g_rtol, g_share = lm_train_tol(cfg)
    ocfg = OptConfig(**LM_MESH_OPT)
    shd = ShardingCtx(dp=("data",), tp="model", mesh=mesh)
    lead = mesh.rank == 0
    whole = init_params(cfg, seed=0, device="cpu")  # the same on each rank
    step = build_step(cfg, "train_4k", mesh, opt_cfg=ocfg, fsdp=True,
                      microbatches=1)
    batch = batch_for(cfg, DataConfig(batch=LM_MESH_B, seq_len=LM_MESH_S), 0,
                      device=dev)
    out = {}
    model = place_params(copy.deepcopy(whole), mesh, step.param_specs)
    names = [n for n, _ in model.named_parameters()]
    # the sharded step: loss and gradients, then AdamW (timed, counted)
    torch.cuda.synchronize()
    mesh.stats = {}
    t0 = time.perf_counter()
    loss, grads = value_and_grad(cfg, model, batch, shd)
    torch.cuda.synchronize()
    out["grad_ms"] = (time.perf_counter() - t0) * 1e3
    step_stats, mesh.stats = mesh.stats, None
    # the tensor-parallel step's bits repeat (every sum over gloo in rank
    # order, the embedding's gradient in a fixed order): a second run
    loss2, grads2 = value_and_grad(cfg, model, batch, shd)
    moved = [n for n in names if not torch.equal(grads[n], grads2[n])]
    if moved or not torch.equal(loss, loss2):
        raise SystemExit(f"lm mesh {arch}: a second run of the sharded step "
                         f"differs in the loss or the leaves {moved}")
    out["bit_stable"] = True
    out["step_by_kind"] = dict(step_stats.get("by_kind", {}))
    out["step_moved"] = dict(step_stats.get("moved", {}))
    del loss2, grads2
    got = [gather_param(model, n, grads[n]) for n in names]
    one = copy.deepcopy(whole).to(dev)
    if lead:
        with lm_plain_moe(2, 2):
            want_loss, want = value_and_grad(cfg, one, batch)
        out["loss"], out["loss_one_card"] = float(loss), float(want_loss)
        out["loss_rel"] = abs(float(loss) - float(want_loss)) / abs(
            float(want_loss))
        if not out["loss_rel"] <= loss_rtol:
            raise SystemExit(f"lm mesh {arch}: loss {float(loss)!r} against "
                             f"one card's {float(want_loss)!r}")
        out["grad_share"] = lm_grads_close(
            f"lm mesh {arch}", names, got, [want[n] for n in names], g_rtol,
            g_share)
    else:
        want = {n: torch.empty_like(g) for n, g in zip(names, got)}
    # one AdamW step on the same (the one card's, sent from rank 0)
    # gradients
    for n in names:
        want[n] = comm.broadcast(mesh, "data", comm.broadcast(
            mesh, "model", want[n], 0, want[n].shape, want[n].dtype), 0,
            want[n].shape, want[n].dtype)
    state = init_opt_state(model, ocfg)
    torch.cuda.synchronize()
    mesh.stats = step_stats
    t0 = time.perf_counter()
    apply_updates(model, {n: place_like(model, n, want[n]) for n in names},
                  state, ocfg)
    torch.cuda.synchronize()
    out["adamw_ms"] = (time.perf_counter() - t0) * 1e3
    out["step_ms"] = out["grad_ms"] + out["adamw_ms"]
    out["step_bytes"] = mesh.stats.get("bytes", 0)
    out["step_collectives"] = mesh.stats.get("collectives", 0)
    mesh.stats = None
    got_p = lm_params_to_numpy(model)
    got_s = opt_state_to_numpy(state, model)
    if lead:
        one_state = init_opt_state(one, ocfg, device=dev)
        apply_updates(one, want, one_state, ocfg)
        flat, want_flat = {}, {}

        def walk(tree, prefix, into):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/", into)
                else:
                    into[prefix + k] = v
        walk(got_p, "", flat)
        walk(lm_params_to_numpy(one), "", want_flat)
        out["adamw_params_share"] = lm_tree_share(
            flat, want_flat, f"lm mesh {arch} adamw", 1e-5, 1e-6)
        flat, want_flat = {}, {}
        walk(got_s, "", flat)
        walk(opt_state_to_numpy(one_state), "", want_flat)
        out["adamw_state_share"] = lm_tree_share(
            flat, want_flat, f"lm mesh {arch} adamw state", 2.0 ** -7,
            2.0 ** -8)
    del model, state, grads, want, got
    # serving: the prefill and decode cells of build_step
    pre = build_step(cfg, "prefill_32k", mesh)
    dec = build_step(cfg, "decode_32k", mesh)
    served = place_params(copy.deepcopy(whole), mesh, pre.param_specs)
    one = copy.deepcopy(whole).to(dev)  # the AdamW step above moved it
    rng = np.random.default_rng(29)
    prompts = {}
    if cfg.embeddings_in:
        prompts["embeds"] = torch.from_numpy((0.1 * rng.standard_normal(
            (LM_MESH_B, LM_MESH_S, cfg.d_model))).astype(np.float32)).to(dev)
    else:
        prompts["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab, (LM_MESH_B, LM_MESH_S))).to(dev)
    if cfg.n_vision_tokens:
        prompts["vision"] = torch.from_numpy((0.02 * rng.standard_normal(
            (LM_MESH_B, cfg.n_vision_tokens, cfg.d_model))).astype(
                np.float32)).to(dev)

    def close(got, want, what):
        share = lm_share(got, want)
        if not torch.allclose(got.double(), want.double(), rtol=g_rtol,
                              atol=g_share * float(want.abs().max())):
            raise SystemExit(f"lm mesh {arch} serving: {what} differ "
                             f"({share:.3e})")
        return share

    if cfg.encoder_only:
        got = pre.fn(served, prompts)
        if lead:
            out["serve_share"] = close(got, forward_logits(cfg, one, prompts),
                                       "logits")
        return out
    lg, cache, pos = pre.fn(served, prompts)
    if lead:
        with lm_plain_moe(2, 2):
            lg1, cache1, pos1 = prefill(cfg, one, prompts)
        out["serve_share"] = close(lg, lg1, "prefill logits")
    for i in range(LM_MESH_GEN):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (LM_MESH_B, 1))).to(dev)
        lg, cache, pos = dec.fn(served, tok, cache, pos)
        if lead:
            lg1, cache1, pos1 = decode_step(cfg, one, tok, cache1, pos1)
            out["serve_share"] = max(out["serve_share"], close(
                lg, lg1, f"logits of decode step {i}"))
    return out


def lm_mesh_rank(rank: int, world: int, store: str, job: str):
    """One rank of phase 29's 2 x 2 gloo world on cuda:0: (a) every smoke
    config; (b) qwen3-moe-235b at published widths cut to LM_EP_UNITS
    unit(s), the expert-parallel step against the one-card twin's numbers
    in ``<job>/ep_twin.pt``; (c) internlm2-1.8b at full width on
    LM_DENSE_UNITS units, two train steps; (e) qwen3-moe smoke trained 2
    steps with a checkpoint after each. Every SSSP kernel's launches are
    counted and must stay 0. Writes ``<job>/rank<r>.json``."""
    import torch
    import torch.distributed as tdist

    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import init_params
    from repro_torch.models.layers import ShardingCtx
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
    from repro_torch.runtime.train_loop import train, value_and_grad
    from repro_torch.sharding import comm
    from repro_torch.sharding.partition import gather_param, place_params

    torch.set_num_threads(2)  # 4 ranks on the host's 8 cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, dev = init_group(rank, world, backend="gloo",
                                  init_method=store, device="cuda:0")
    counted = kernel_counters()
    for f, attr in counted.values():
        setattr(f, attr, 0)
    job = Path(job)
    report = {"rank": rank, "smoke": {}}
    try:
        mesh = make_mesh(2, 2, dev)
        shd = ShardingCtx(dp=("data",), tp="model", mesh=mesh)
        # (a) the ten smoke configs
        t0 = time.perf_counter()
        for arch in ARCHS:
            report["smoke"][arch] = lm_mesh_smoke(arch, mesh, dev)
        report["smoke_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        # (b) qwen3-moe-235b at published widths, expert parallel
        cfg = lm_cut("qwen3-moe-235b", LM_EP_UNITS)
        ocfg = OptConfig(**LM_MESH_OPT)
        step = build_step(cfg, "train_4k", mesh, opt_cfg=ocfg, fsdp=True,
                          microbatches=1)
        t0 = time.perf_counter()
        for r in range(world):  # one whole model on the card at a time
            if rank == r:
                model = place_params(init_params(cfg, seed=0, device=dev),
                                     mesh, step.param_specs)
                torch.cuda.empty_cache()
            tdist.barrier()
        ep = {"init_s": time.perf_counter() - t0,
              "params_gib": sum(p.numel() * 4 for p in model.parameters())
              / 2**30}
        batch = batch_for(cfg, DataConfig(batch=LM_EP_B, seq_len=LM_EP_S), 0,
                          device=dev)
        twin = torch.load(job / "ep_twin.pt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.stats = {}
        t0 = time.perf_counter()
        # remat as the train step runs it: without, the four ranks' peaks
        # fill the card (80,034 MiB in use at the backward's end, chip run
        # 3, PR 25)
        loss, grads = value_and_grad(cfg, model, batch, shd)
        torch.cuda.synchronize()
        ep["grad_ms"] = (time.perf_counter() - t0) * 1e3
        ep["grad_stats"] = dict(mesh.stats)
        if rank == 0:
            ep["card_used_mib"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=False).stdout.strip()
        tdist.barrier()
        mesh.stats = {}
        t0 = time.perf_counter()
        state = init_opt_state(model, ocfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = apply_updates(model, grads, state, ocfg)
        torch.cuda.synchronize()
        ep["adamw_ms"] = (time.perf_counter() - t1) * 1e3
        ep["state_init_ms"] = (t1 - t0) * 1e3
        ep["adamw_bytes"] = mesh.stats.get("bytes", 0)
        mesh.stats = None
        ep["step_ms"] = ep["grad_ms"] + ep["adamw_ms"]
        ep["step_bytes"] = ep["grad_stats"].get("bytes", 0) + ep["adamw_bytes"]
        ep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        ep["loss"], ep["loss_twin"] = float(loss), float(twin["loss"])
        loss_rtol, g_rtol, g_share = lm_train_tol(cfg)
        ep["loss_rel"] = abs(ep["loss"] - ep["loss_twin"]) / abs(
            ep["loss_twin"])
        ep["gnorm"] = float(stats["gnorm"])
        router = gather_param(model, "units.0.l0.moe.router",
                              grads["units.0.l0.moe.router"])
        ep["router_share"] = lm_grads_close(
            "lm mesh qwen3-moe-235b router", ["router"], [router],
            [twin["router"].to(dev)], g_rtol, g_share)
        # one expert's gradient: its block's data rows joined, in the
        # model column that holds it
        e_loc = cfg.n_experts // mesh.shape["model"]
        ep["expert"] = LM_EP_EXPERT
        ep["expert_share"] = None
        if mesh.coords["model"] == LM_EP_EXPERT // e_loc:
            module = model.get_submodule("units.0.l0.moe")
            shares = []
            for nm in ("wi", "wg", "wo"):
                dims = module.placed[nm].dims[1:]
                g = grads[f"units.0.l0.moe.{nm}"][LM_EP_EXPERT % e_loc]
                shares.append(lm_grads_close(
                    f"lm mesh qwen3-moe-235b expert {LM_EP_EXPERT} {nm}",
                    [nm], [comm.gather_whole(mesh, g, dims)],
                    [twin[nm].to(dev)], g_rtol, g_share))
            ep["expert_share"] = max(shares)
        if not ep["loss_rel"] <= loss_rtol:
            raise SystemExit(f"lm mesh qwen3-moe-235b: loss {ep['loss']!r} "
                             f"against the twin's {ep['loss_twin']!r}")
        report["ep"] = ep
        del model, grads, state, router, batch, twin
        torch.cuda.empty_cache()
        tdist.barrier()

        # (c) internlm2-1.8b at full width, LM_DENSE_UNITS units, FSDP
        cfg = lm_cut("internlm2-1.8b", LM_DENSE_UNITS)
        step = build_step(cfg, "train_4k", mesh, opt_cfg=ocfg, fsdp=True,
                          microbatches=1)
        model = place_params(init_params(cfg, seed=0, device=dev), mesh,
                             step.param_specs)
        state = init_opt_state(model, ocfg)
        dense = {"losses": [], "step_ms": [], "step_bytes": []}
        torch.cuda.reset_peak_memory_stats()
        for s in range(2):
            batch = batch_for(cfg, DataConfig(batch=LM_DENSE_B,
                                              seq_len=LM_DENSE_S), s,
                              device=dev)
            mesh.stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = step.fn(model, state, batch)
            torch.cuda.synchronize()
            dense["step_ms"].append((time.perf_counter() - t0) * 1e3)
            dense["step_bytes"].append(mesh.stats.get("bytes", 0))
            dense["losses"].append(float(loss))
        mesh.stats = None
        dense["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        report["dense"] = dense
        del model, state, batch
        torch.cuda.empty_cache()

        # (e) qwen3-moe smoke, 2 steps on 2 x 2 with checkpoints
        cfg = get_smoke("qwen3_moe_235b")
        res = train(cfg, 2, DataConfig(batch=LM_MESH_B, seq_len=LM_MESH_S),
                    ocfg, ckpt_dir=str(job / "elastic"), ckpt_every=1,
                    mesh=mesh)
        report["elastic_first"] = {"losses": res.losses,
                                   "skipped": res.skipped_steps}
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    report["launches"] = {nm: getattr(f, a) for nm, (f, a) in counted.items()}
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(job / f"rank{rank}.json", "w") as f:
        json.dump(report, f)


def lm_resume_rank(rank: int, world: int, store: str, job: str):
    """One rank of phase 29 (e)'s world of 3: ``plan_mesh(3, want_tp=2,
    global_batch=4)`` = (2, 1), one rank idle; restore the 2 x 2 run's
    step-2 checkpoint onto it (each gathered leaf against the file, bit
    for bit) and train step 3. Writes ``<job>/resume<r>.json``."""
    import torch
    import torch.distributed as tdist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.interop import lm_params_to_numpy, opt_state_to_numpy
    from repro_torch.launch.mesh import init_group
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state, state_specs_for
    from repro_torch.runtime.elastic import build_mesh, plan_mesh
    from repro_torch.runtime.train_loop import train
    from repro_torch.sharding.partition import param_specs, to_shardings

    torch.set_num_threads(2)  # 4 ranks on the host's 8 cores
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world, dev = init_group(rank, world, backend="gloo",
                                  init_method=store, device="cuda:0")
    job = Path(job)
    report = {"rank": rank}
    try:
        plan = plan_mesh(world, want_tp=2, global_batch=LM_MESH_B)
        mesh = build_mesh(plan, dev)
        report["plan"] = dataclasses.asdict(plan)
        if mesh is not None:
            cfg, ocfg = get_smoke("qwen3_moe_235b"), OptConfig(**LM_MESH_OPT)
            shapes = init_params(cfg, device="meta")
            ostate = init_opt_state(shapes, ocfg, device="meta")
            pspecs = param_specs(cfg, shapes)
            ckdir = str(job / "elastic")
            back = CheckpointManager(ckdir).restore(
                2, {"params": shapes, "opt": ostate},
                shardings={"params": to_shardings(mesh, pspecs),
                           "opt": to_shardings(mesh, state_specs_for(
                               ostate, pspecs))})
            whole = {"params": lm_params_to_numpy(back["params"]),
                     "opt": opt_state_to_numpy(back["opt"], back["params"])}
            with np.load(job / "elastic" / "ckpt_00000002.npz") as z:
                file = {k: z[k] for k in z.files}
            flat = {}

            def walk(tree, prefix):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        walk(v, f"{prefix}{k}/")
                    else:
                        flat[prefix + k] = np.asarray(v)
            walk(whole, "")
            if set(flat) != set(file) or not all(
                    np.array_equal(np.ravel(flat[k]).view(np.uint8),
                                   np.ravel(file[k]).view(np.uint8))
                    for k in file):
                raise SystemExit(f"rank {rank}: the restore onto (2, 1) is "
                                 "not the checkpoint bit for bit")
            report["restored_leaves"] = len(file)
            res = train(cfg, 3, DataConfig(batch=LM_MESH_B,
                                           seq_len=LM_MESH_S), ocfg,
                        ckpt_dir=ckdir, ckpt_every=1, mesh=mesh)
            report.update(losses=res.losses, restored=res.restored_from)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    with open(job / f"resume{rank}.json", "w") as f:
        json.dump(report, f)


def lm_spawn(fn, nprocs: int, job: Path, name: str, limit_s: float) -> float:
    """``fn`` in ``nprocs`` ranks under torch.multiprocessing (a ``file://``
    store in ``job``); a rank that fails or a world that outlives
    ``limit_s`` fails the phase. Returns the world's seconds."""
    import torch.multiprocessing as tmp_mp

    t0 = time.perf_counter()
    # the ranks share one card: growable segments keep each rank's cached
    # blocks near what it holds (read by each rank's allocator at its start)
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ctx = tmp_mp.spawn(fn, args=(nprocs, f"file://{job}/{name}",
                                     str(job)), nprocs=nprocs, join=False)
    finally:
        if saved is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    deadline = time.monotonic() + limit_s
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise SystemExit(f"phase 29's {name} world outlived {limit_s} s")
    return time.perf_counter() - t0


def lm_mesh_phase(dev, smi: str, run_peak: list) -> dict:
    """Phase 29: the LM substrate on a mesh. The one-card twins of (b) and
    (c) first (then freed); a 2 x 2 gloo world of 4 ranks on this card for
    (a), (b), (c) and (e)'s first run; a world of 3 for (e)'s resume,
    against the one-card step from the same checkpoint; (d) an NCCL world
    of one in this process. Correctness on one card: two ranks on one card
    share its SMs and gloo stages every collective through host memory, so
    no number here is a sharded speed."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as tdist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.layers import ShardingCtx
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.runtime.train_loop import make_train_step, value_and_grad
    from repro_torch.sharding.partition import (
        gather_param,
        param_specs,
        place_params,
    )

    t29 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise SystemExit("phase 29 compares f32 with TF32 off; it is on")
    job = Path(tempfile.mkdtemp(prefix="smoke29-"))
    ocfg = OptConfig(**LM_MESH_OPT)
    result = {"label": MESH_LABEL, "card": smi,
              "resident_before_gib": torch.cuda.memory_allocated() / 2**30}
    try:
        # (b)'s twin: qwen3-moe-235b at published widths, the plain (2, 2)
        # expert-parallel step on one card; freed before the world starts
        cfg = lm_cut("qwen3-moe-235b", LM_EP_UNITS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cfg, seed=0, device=dev)
        batch = batch_for(cfg, DataConfig(batch=LM_EP_B, seq_len=LM_EP_S), 0,
                          device=dev)
        with lm_plain_moe(2, 2):
            loss, grads = value_and_grad(cfg, model, batch)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        pre = "units.0.l0.moe."
        torch.save({"loss": loss.cpu(),
                    "router": grads[pre + "router"].cpu(),
                    **{nm: grads[pre + nm][LM_EP_EXPERT].cpu()
                       for nm in ("wi", "wg", "wo")}}, job / "ep_twin.pt")
        result["ep_twin"] = {
            "seconds": twin_s, "loss": float(loss),
            "params": sum(p.numel() for p in model.parameters()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
        del model, batch, loss, grads
        # (c)'s twin: internlm2-1.8b on LM_DENSE_UNITS units, two steps of
        # make_train_step on one card
        cfg_c = lm_cut("internlm2-1.8b", LM_DENSE_UNITS)
        model = init_params(cfg_c, seed=0, device=dev)
        state = init_opt_state(model, ocfg, device=dev)
        step = make_train_step(cfg_c, ocfg)
        dense_twin = []
        for s in range(2):
            batch = batch_for(cfg_c, DataConfig(batch=LM_DENSE_B,
                                                seq_len=LM_DENSE_S), s,
                              device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = step(model, state, batch)
            torch.cuda.synchronize()
            dense_twin.append((float(loss), (time.perf_counter() - t0) * 1e3))
        del model, state, batch
        torch.cuda.empty_cache()
        run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())

        # the 2 x 2 world: (a), (b), (c), (e)'s first run
        world_s = lm_spawn(lm_mesh_rank, 4, job, "store", 900)
        reports = []
        for r in range(4):
            with open(job / f"rank{r}.json") as f:
                reports.append(json.load(f))
        result["world_s"] = world_s
        for rep in reports:
            ran = sssp_launched(rep["launches"])
            if ran:
                raise SystemExit(f"phase 29 rank {rep['rank']} launched SSSP "
                                 f"kernels: {ran}")
            if rep["launches"][EMBED_BLOCK] <= 0:
                raise SystemExit(f"phase 29 rank {rep['rank']} never "
                                 "launched embed_grad's block form")
        result["launches"] = reports[0]["launches"]
        result["rank_peak_gib"] = [rep["peak_gib"] for rep in reports]
        result["smoke"] = {arch: reports[0]["smoke"][arch] for arch in ARCHS}
        result["smoke_s"] = reports[0]["smoke_s"]
        for arch in ARCHS:
            a = result["smoke"][arch]
            log(f"lm mesh smoke {arch} [{MESH_LABEL}; {smi}]: loss "
                f"{a['loss_rel']:.2e} relative to one card's, gradients "
                f"{a['grad_share']:.2e} of each leaf's largest, AdamW on the "
                f"same gradients: parameters {a['adamw_params_share']:.2e}, "
                f"state {a['adamw_state_share']:.2e}; prefill + "
                f"{LM_MESH_GEN} decode steps {a['serve_share']:.2e} (tol "
                f"{lm_train_tol(get_smoke(arch))}); the train step "
                f"{a['step_ms']:.1f} ms, {a['step_bytes'] / 1e6:.3f} MB "
                f"through gloo in {a['step_collectives']} collectives "
                "(rank 0)")
        ep = [rep["ep"] for rep in reports]
        result["ep"] = {
            "config": f"qwen3-moe-235b, published widths, {LM_EP_UNITS} of "
                      "94 units", "batch": LM_EP_B, "seq": LM_EP_S,
            "loss": ep[0]["loss"], "loss_twin": ep[0]["loss_twin"],
            "loss_rel": ep[0]["loss_rel"],
            "router_share": max(e["router_share"] for e in ep),
            "expert_share": max(e["expert_share"] for e in ep
                                if e["expert_share"] is not None),
            "expert": LM_EP_EXPERT,
            "step_ms": [e["step_ms"] for e in ep],
            "grad_ms": [e["grad_ms"] for e in ep],
            "adamw_ms": [e["adamw_ms"] for e in ep],
            "step_bytes": [e["step_bytes"] for e in ep],
            "all_to_all_ms": [1e3 * e["grad_stats"].get("all_to_all_s", 0.0)
                              for e in ep],
            "all_to_alls": ep[0]["grad_stats"].get("all_to_alls", 0),
            "peak_gib": [e["peak_gib"] for e in ep],
            "peak_gib_card": sum(e["peak_gib"] for e in ep),
            "card_used_mib": ep[0].get("card_used_mib"),
            "params_gib": [e["params_gib"] for e in ep],
            "init_s": ep[0]["init_s"], "twin": result.pop("ep_twin")}
        e = result["ep"]
        # each layer's forward runs its 2 all-to-alls twice (the forward and
        # remat's recompute) and their 2 reverses in the backward
        per_layer = [ms / LM_EP_UNITS / 3 for ms in e["all_to_all_ms"]]
        e["all_to_all_ms_per_layer_pass"] = per_layer
        log(f"lm mesh qwen3-moe-235b ({e['config']}) B={LM_EP_B} x "
            f"{LM_EP_S}, f32, (2, 2), expert parallel [{MESH_LABEL}; {smi}]:"
            f" loss {e['loss']!r} against the one-card twin's "
            f"{e['loss_twin']!r} ({e['loss_rel']:.2e}); router gradient "
            f"{e['router_share']:.2e}, expert {LM_EP_EXPERT}'s "
            f"{e['expert_share']:.2e} of the largest; a step (loss, "
            f"gradients, AdamW) {[round(x, 1) for x in e['step_ms']]} ms by "
            f"rank; the all-to-alls {[round(x, 1) for x in e['all_to_all_ms']]}"
            f" ms a step ({e['all_to_alls']} calls; "
            f"{[round(x, 2) for x in per_layer]} ms a layer's pair); gloo "
            f"{[round(b / 1e9, 3) for b in e['step_bytes']]} GB a step by "
            f"rank; peak {[round(x, 2) for x in e['peak_gib']]} GiB by rank, "
            f"{e['peak_gib_card']:.2f} summed, nvidia-smi "
            f"{e['card_used_mib']} MiB used at the backward's end; twin "
            f"{e['twin']['seconds']:.1f} s, peak {e['twin']['peak_gib']:.2f} "
            "GiB")
        dense = [rep["dense"] for rep in reports]
        losses = dense[0]["losses"]
        want = [x[0] for x in dense_twin]
        loss_rtol = lm_train_tol(cfg_c)[0]
        if not np.allclose(losses, want, rtol=loss_rtol, atol=0):
            raise SystemExit(f"lm mesh internlm2 cut: losses {losses} against "
                             f"one card's {want}")
        result["dense"] = {
            "config": f"internlm2-1.8b, published width, {LM_DENSE_UNITS} of "
                      "24 units", "batch": LM_DENSE_B, "seq": LM_DENSE_S,
            "losses": losses, "losses_one_card": want,
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, want)),
            "step_ms": [d["step_ms"] for d in dense],
            "step_bytes": [d["step_bytes"] for d in dense],
            "peak_gib": [d["peak_gib"] for d in dense],
            "one_card_step_ms": [x[1] for x in dense_twin]}
        d = result["dense"]
        log(f"lm mesh internlm2-1.8b ({d['config']}) B={LM_DENSE_B} x "
            f"{LM_DENSE_S}, f32, (2, 2), FSDP [{MESH_LABEL}; {smi}]: losses "
            f"{losses} against one card's make_train_step {want} "
            f"({d['loss_rel']:.2e}, rtol {loss_rtol}); steps "
            f"{[[round(x, 1) for x in s] for s in d['step_ms']]} ms by rank "
            f"(one card: {[round(x, 1) for x in d['one_card_step_ms']]}); "
            f"gloo {[[round(b / 1e9, 3) for b in s] for s in d['step_bytes']]}"
            f" GB a step by rank; peak {[round(x, 2) for x in d['peak_gib']]}"
            " GiB by rank")

        # (e) the resume on 3 ranks re-planned to (2, 1)
        first = reports[0]["elastic_first"]
        resume_s = lm_spawn(lm_resume_rank, 3, job, "resume", 300)
        resumed = []
        for r in range(3):
            with open(job / f"resume{r}.json") as f:
                resumed.append(json.load(f))
        active = [rep for rep in resumed if "losses" in rep]
        if len(active) != 2 or resumed[0]["plan"]["mesh_shape"] != [2, 1]:
            raise SystemExit(f"phase 29 (e): plan {resumed[0]['plan']}")
        # the one-card step 3 from the same checkpoint, the (2, 1) twin
        cfg = get_smoke("qwen3_moe_235b")
        shapes = init_params(cfg, device="meta")
        back = CheckpointManager(str(job / "elastic")).restore(
            2, {"params": shapes,
                "opt": init_opt_state(shapes, ocfg, device="meta")},
            device=dev)
        batch = batch_for(cfg, DataConfig(batch=LM_MESH_B, seq_len=LM_MESH_S),
                          2, device=dev)
        with lm_plain_moe(2, 1):
            want3, _ = make_train_step(cfg, ocfg)(back["params"], back["opt"],
                                                  batch)
        got3 = active[0]["losses"][0]
        rel = abs(got3 - float(want3)) / abs(float(want3))
        if not rel <= lm_train_tol(cfg)[0]:
            raise SystemExit(f"phase 29 (e): resumed step 3 loss {got3!r} "
                             f"against one card's {float(want3)!r}")
        result["elastic"] = {
            "first_losses": first["losses"], "plan": resumed[0]["plan"],
            "restored_leaves": active[0]["restored_leaves"],
            "resumed_loss": got3, "one_card_loss": float(want3),
            "loss_rel": rel, "world_s": resume_s}
        log(f"lm mesh elastic [{smi}]: qwen3-moe smoke 2 steps on (2, 2) "
            f"{first['losses']}, a checkpoint; 3 ranks re-planned to "
            f"{tuple(resumed[0]['plan']['mesh_shape'])} (1 idle): every one "
            f"of {active[0]['restored_leaves']} leaves restored bit for bit; "
            f"step 3 {got3!r} against one card's plain (2, 1) step "
            f"{float(want3)!r} ({rel:.2e})")
        del back, batch

        # (d) an NCCL world of one in this process
        init_group(0, 1, backend="nccl", init_method=f"file://{job}/nccl",
                   device=dev)
        try:
            mesh = make_mesh(1, 1, dev)
            shd = ShardingCtx(dp=("data",), tp="model", mesh=mesh)
            cfg_c = lm_cut("internlm2-1.8b", LM_DENSE_UNITS)
            one = init_params(cfg_c, seed=0, device=dev)
            placed = place_params(copy.deepcopy(one), mesh,
                                  param_specs(cfg_c, one))
            batch = batch_for(cfg_c, DataConfig(batch=LM_DENSE_B,
                                                seq_len=LM_DENSE_S), 0,
                              device=dev)
            got_l, got_g = value_and_grad(cfg_c, placed, batch, shd)
            want_l, want_g = value_and_grad(cfg_c, one, batch)
            # one card twice: the leaves whose gradient is not bit-stable
            # there come from an op that is not order-fixed on the card
            again_l, again_g = value_and_grad(cfg_c, one, batch)
            unstable = [n for n in want_g
                        if not torch.equal(want_g[n], again_g[n])]
            differ = [n for n in want_g
                      if not torch.equal(gather_param(placed, n, got_g[n]),
                                         want_g[n])]
            nccl = {"loss_bit_equal": bool(torch.equal(got_l, want_l)),
                    "grads_differ": differ, "one_card_unstable": unstable}
            if not nccl["loss_bit_equal"] or differ or unstable:
                raise SystemExit(f"phase 29 (d): the NCCL world of one is not "
                                 f"bit-equal to one card: loss "
                                 f"{nccl['loss_bit_equal']}, leaves {differ} "
                                 f"(not bit-stable on one card: {unstable})")
            del one, placed, got_g, want_g, again_g, batch
            cfg = get_smoke("qwen3_moe_235b")
            one = init_params(cfg, seed=0, device="cpu")
            placed = place_params(copy.deepcopy(one), mesh,
                                  param_specs(cfg, one))
            one = one.to(dev)
            batch = batch_for(cfg, DataConfig(batch=LM_MESH_B,
                                              seq_len=LM_MESH_S), 0,
                              device=dev)
            got_l, got_g = value_and_grad(cfg, placed, batch, shd)
            with lm_plain_moe(1, 1):
                want_l, want_g = value_and_grad(cfg, one, batch)
            loss_rtol, g_rtol, g_share = lm_train_tol(cfg)
            nccl["moe_loss_rel"] = abs(float(got_l) - float(want_l)) / abs(
                float(want_l))
            nccl["moe_grad_share"] = lm_grads_close(
                "phase 29 (d) qwen3-moe smoke", list(want_g),
                [gather_param(placed, n, got_g[n]) for n in want_g],
                list(want_g.values()), g_rtol, g_share)
            nccl["moe_bit_equal"] = bool(torch.equal(got_l, want_l))
            if not nccl["moe_loss_rel"] <= loss_rtol:
                raise SystemExit("phase 29 (d): the qwen3-moe step differs")
        finally:
            tdist.destroy_process_group()
        result["nccl"] = nccl
        log(f"lm mesh NCCL world of one (1, 1) [{smi}]: internlm2-1.8b "
            f"({LM_DENSE_UNITS} units, full width): loss bit-equal to the "
            f"one-card step: {nccl['loss_bit_equal']}; gradient leaves not "
            f"bit-equal: {nccl['grads_differ']}, not bit-stable between two "
            f"one-card runs: {nccl['one_card_unstable']}; qwen3-moe smoke "
            "(expert "
            f"parallel at tp 1) against apply_moe_ep_plain(1, 1): loss "
            f"{nccl['moe_loss_rel']:.2e}, gradients "
            f"{nccl['moe_grad_share']:.2e} (bit-equal loss: "
            f"{nccl['moe_bit_equal']})")
    finally:
        shutil.rmtree(job, ignore_errors=True)
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    result["seconds"] = time.perf_counter() - t29
    log(f"phase 29: {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# the embedding's gradient and phase 30: the dry run on the card
# ---------------------------------------------------------------------------

EMBED_ARCH = "internlm2-1.8b"  # the training path's lookup (phase 28)
DRY_CELL = ("internlm2-1.8b", "decode_32k")  # phase 30 (b)
DRY_SSSP = (1 << 24, 16)  # phase 30 (a): run_sssp's defaults, n and degree
DRY_PEAK_TOL = 0.15  # predicted against measured peak, either way


def embed_grad_times(dev) -> dict:
    """``embed_grad`` (#12) at the training step's shapes (phase 28's
    ``internlm2-1.8b``, B = LM_TRAIN_B x LM_TRAIN_S tokens of step 0, an
    f32 gradient seeded): against its twin bit for bit and twice against
    itself, then timed (CUDA events) beside the twin, ``index_add_`` (one
    PyTorch call, atomics) and the bound: each gradient row and id read
    once, the whole table's gradient written once."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.embed_grad import embed_grad

    cfg = get_config(EMBED_ARCH)
    ids = batch_for(cfg, DataConfig(batch=LM_TRAIN_B, seq_len=LM_TRAIN_S), 0,
                    device=dev)["tokens"]
    rows, d = cfg.vocab_pad, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(12)
    g = torch.randn(ids.shape + (d,), generator=gen, device=dev)
    g.view(-1, d)[::3, 0] = -0.0
    got = embed_grad(g, ids, rows)
    again = embed_grad(g, ids, rows)
    want = ref.embed_grad_ref(g, ids, rows)
    torch.cuda.synchronize()
    if not (same_bits(got, want) and same_bits(got, again)):
        raise SystemExit("embed_grad disagrees with its twin or itself")
    flat = ids.reshape(-1).long()

    def library():
        return torch.zeros((rows, d), device=dev).index_add_(
            0, flat, g.view(-1, d))

    n = flat.numel()
    nbytes = n * d * 4 + n * 4 + rows * d * 4
    b_ms, by = bound(nbytes, n * d)
    return {"ms": time_ms(lambda: embed_grad(g, ids, rows), 20),
            "plain_ms": time_ms(lambda: ref.embed_grad_ref(g, ids, rows), 3,
                                warmup=1),
            "library_ms": time_ms(library, 20), "bound_ms": b_ms,
            "bound_by": by, "max_abs_err": max_abs_err(got, want),
            "tokens": n, "rows": rows, "d": d,
            "longest_run": int(torch.bincount(flat).max())}


def embed_block_times(dev) -> dict:
    """``embed_grad``'s block form (#12 on a rank's rows of the
    vocabulary-parallel embedding) at the pod's ``train_4k`` shapes for
    ``EMBED_ARCH``: one data rank's batch block (256 / 16 sequences of
    4096 tokens of step 0) and model rank 5's block of the table (rows
    [5 V / 16, 6 V / 16)); an f32 gradient seeded. Against its twin bit
    for bit and twice against itself, then timed (CUDA events) beside the
    twin, ``index_add_`` of the block's rows (one PyTorch call, on the
    rows and ids already selected) and the bound: the block's gradient
    rows and every id read once, the block's table written once."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.embed_grad import embed_grad

    cfg = get_config(EMBED_ARCH)
    spec = SHAPES["train_4k"]
    ids = batch_for(cfg, DataConfig(batch=spec.global_batch // 16,
                                    seq_len=spec.seq_len), 0,
                    device=dev)["tokens"]
    rows, d = cfg.vocab_pad // 16, cfg.d_model
    row0 = 5 * rows
    gen = torch.Generator(device=dev).manual_seed(12)
    g = torch.randn(ids.shape + (d,), generator=gen, device=dev)
    g.view(-1, d)[::3, 0] = -0.0
    got = embed_grad(g, ids, rows, row0)
    again = embed_grad(g, ids, rows, row0)
    want = ref.embed_grad_ref(g, ids, rows, row0)
    torch.cuda.synchronize()
    if not (same_bits(got, want) and same_bits(got, again)):
        raise SystemExit("embed_grad's block form disagrees with its twin "
                         "or itself")
    flat = ids.reshape(-1).long() - row0
    inside = (flat >= 0) & (flat < rows)
    local, g_in = flat[inside], g.view(-1, d)[inside]

    def library():
        return torch.zeros((rows, d), device=dev).index_add_(0, local, g_in)

    if not torch.allclose(library(), want, rtol=1e-5, atol=1e-5):
        raise SystemExit("index_add_ of the block differs from the twin")
    n, n_in = flat.numel(), int(inside.sum())
    nbytes = n_in * d * 4 + n * 4 + rows * d * 4
    b_ms, by = bound(nbytes, n_in * d)
    return {"ms": time_ms(lambda: embed_grad(g, ids, rows, row0), 20),
            "plain_ms": time_ms(lambda: ref.embed_grad_ref(g, ids, rows,
                                                           row0), 3,
                                warmup=1),
            "library_ms": time_ms(library, 20), "bound_ms": b_ms,
            "bound_by": by, "max_abs_err": max_abs_err(got, want),
            "tokens": n, "tokens_in_block": n_in, "rows": rows,
            "row0": row0, "d": d,
            "longest_run": int(torch.bincount(local).max())}


def dry_run_phase(dev, smi: str, run_peak: list, counted: dict) -> dict:
    """Phase 30: ``launch.dryrun`` as rank 0 of the fake pod (256 ranks) on
    the card. (a) ``run_sssp``'s cell at its defaults, both schedules: one
    phase of the legacy program on rank 0's block of real tensors, the
    launch counts set to 0 just before and read just after (#1b rect and
    #2 must run), their inputs then held kernel against twin bit for bit,
    and the predicted peak (arguments + temporaries, from the storages'
    lifetimes) against ``torch.cuda.max_memory_allocated()`` around the
    phase; (b) ``DRY_CELL`` traced over fake tensors, then run for real
    with seeded blocks (the blocks only), its predicted peak and FLOPs
    against the measured ones. A fake world returns no data: (b) checks
    sizes, not values."""
    import torch
    import torch.distributed as tdist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step

    t30 = time.perf_counter()
    result = {"label": f"rank 0 of a fake 16 x 16 world on one H100 [{smi}]"}

    def zero():
        for f, attr in counted.values():
            setattr(f, attr, 0)

    def peak_window():
        torch.cuda.synchronize()
        run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    mesh = make_production_mesh(rank=0, device=dev)
    try:
        # (a) the SSSP cell, both schedules
        n, deg = DRY_SSSP
        result["sssp"] = {}
        for schedule in ("reduce_scatter", "allreduce"):
            sg = dryrun.sssp_block(n, deg, 256, mesh.rank, dev)
            seen = {"push": [], "crit": []}
            push0 = D.ell_push_rect_batch
            crit0 = kops.frontier_crit_lanes_batch

            def push(*a, **k):
                seen["push"].append((a, k))
                return push0(*a, **k)

            def crit(*a, **k):
                seen["crit"].append((a, k))
                return crit0(*a, **k)

            base = peak_window()
            zero()
            D.ell_push_rect_batch, kops.frontier_crit_lanes_batch = push, crit
            try:
                got = dryrun.sssp_phase(sg, schedule)
            finally:
                D.ell_push_rect_batch = push0
                kops.frontier_crit_lanes_batch = crit0
            torch.cuda.synchronize()
            counts = {k: getattr(f, a) for k, (f, a) in counted.items()}
            measured = torch.cuda.max_memory_allocated() - base
            for name in ("ell_push_rect_batch", "frontier_crit_lanes_batch"):
                if counts[name] <= 0:
                    raise SystemExit(f"phase 30 (a) {schedule} never "
                                     f"launched {name}")
            for (a, k) in seen["push"]:
                if not same_bits(push0(*a, **k),
                                 ref.ell_push_rect_batch_ref(*a)):
                    raise SystemExit("phase 30 (a): #1b rect disagrees "
                                     "with its twin")
            for (a, k) in seen["crit"]:
                kernel, twin = crit0(*a), ref.frontier_crit_lanes_batch_ref(*a)
                if not all(same_bits(x, y) for x, y in zip(kernel, twin)):
                    raise SystemExit("phase 30 (a): #2 disagrees with its "
                                     "twin")
            mem = got["memory"]
            predicted = mem["argument_bytes"] + mem["temp_bytes"]
            measured_total = mem["argument_bytes"] + measured
            rel = abs(predicted - measured_total) / measured_total
            result["sssp"][schedule] = {
                "n_loc": sg.n_loc, "e_loc": int(sg.w.shape[0]),
                "phases": got["phases"], "collectives": got["collectives"],
                "memory": mem, "measured_temp_bytes": measured,
                "predicted_peak_bytes": predicted,
                "measured_peak_bytes": measured_total, "peak_rel": rel,
                "launches": {k: v for k, v in counts.items() if v},
                "bytes_accessed": got["bytes_accessed"],
                "seconds": got["seconds"]}
            log(f"dry run sssp n={n} d={deg} {schedule} "
                f"[{result['label']}]: one phase on rank 0's block (n_loc "
                f"{sg.n_loc}, E_loc {sg.w.shape[0]}); launches "
                f"{result['sssp'][schedule]['launches']}, #1b rect and #2 "
                f"bit-equal to their twins on its inputs; collectives "
                f"{got['collectives']}; peak predicted {predicted} bytes "
                f"(arguments {mem['argument_bytes']} + temporaries "
                f"{mem['temp_bytes']}), measured {measured_total} "
                f"({rel:.2%})")
            if not rel <= DRY_PEAK_TOL:
                raise SystemExit(f"phase 30 (a) {schedule}: the predicted "
                                 f"peak {predicted} misses the measured "
                                 f"{measured_total} by {rel:.1%}")
            del sg, seen

        # (b) one LM cell: the fake trace, then the real run
        arch, shape = DRY_CELL
        cfg = get_config(arch)
        step = build_step(cfg, shape, mesh)
        zero()
        pred = dryrun.trace_step(cfg, shape, mesh, step, dev)
        if any(getattr(f, a) for f, a in counted.values()):
            raise SystemExit("phase 30 (b): the fake trace launched a kernel")
        base = peak_window()
        gen = torch.Generator(device=dev).manual_seed(30)
        args, parts = dryrun.step_args(cfg, shape, mesh, step, dev, gen)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            logits, _, pos = step.fn(*args)
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t0
        measured = torch.cuda.max_memory_allocated() - base
        mem = pred["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        rel = abs(predicted - measured) / measured
        spec = SHAPES[shape]
        want_shape = (spec.global_batch, cfg.vocab)
        cell = {"arch": cfg.name, "shape": shape, "memory": mem,
                "arguments": pred["arguments"],
                "predicted_peak_bytes": predicted,
                "measured_peak_bytes": measured, "peak_rel": rel,
                "flops": pred["flops"], "measured_flops":
                    float(fc.get_total_flops()),
                "collectives": pred["collectives"],
                "trace_s": pred["seconds"], "real_s": real_s,
                "logits_shape": list(logits.shape), "pos": pos}
        result["lm"] = cell
        log(f"dry run {cfg.name} {shape} [{result['label']}]: predicted peak "
            f"{predicted / 2**30:.3f} GiB (arguments "
            f"{mem['argument_bytes'] / 2**30:.3f} + temporaries "
            f"{mem['temp_bytes'] / 2**30:.3f}), measured "
            f"{measured / 2**30:.3f} GiB ({rel:.2%}); FLOPs traced "
            f"{pred['flops']:.6e}, counted on the real run "
            f"{cell['measured_flops']:.6e}; trace {pred['seconds']:.1f} s, "
            f"real step {real_s:.2f} s; logits {tuple(logits.shape)}")
        if tuple(logits.shape) != want_shape or pos != spec.seq_len + 1:
            raise SystemExit(f"phase 30 (b): logits {tuple(logits.shape)}, "
                             f"pos {pos}")
        if cell["measured_flops"] != pred["flops"]:
            raise SystemExit("phase 30 (b): the traced FLOPs differ from the "
                             "real run's")
        if not rel <= DRY_PEAK_TOL:
            raise SystemExit(f"phase 30 (b): the predicted peak {predicted} "
                             f"misses the measured {measured} by {rel:.1%}")
        del args, parts, logits
    finally:
        tdist.destroy_process_group()
    torch.cuda.synchronize()
    # (c) #12's block form at the pod's train_4k shapes
    zero()
    result["embed_block"] = embed_block_times(dev)
    eb = result["embed_block"]
    log(f"embed_grad block form [{smi}] {EMBED_ARCH} train_4k on the pod: "
        f"{eb['tokens']} ids of a data rank ({eb['tokens_in_block']} in the "
        f"block, longest run {eb['longest_run']}), rows [{eb['row0']}, "
        f"{eb['row0'] + eb['rows']}) x {eb['d']} f32: {eb['ms']:.4f} ms (twin "
        f"{eb['plain_ms']:.3f}, index_add_ of the block's rows "
        f"{eb['library_ms']:.4f}, bound {eb['bound_ms']:.4f} "
        f"{eb['bound_by']}); bit-equal to its twin and to itself")
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t30
    log(f"phase 30: {result['seconds']:.1f} s")
    return result


# phase 31: each entry point of repro_torch.examples and its arguments on
# the card (``{tmp}`` is a temporary directory, removed after the phase):
# the 512 x 512 road grid (DIMACS USA-road-d.NY's size) and the web graph,
# G and kronecker at 2^18 vertices; continuous_serving on the 128 x 128
# grid (each completion also costs a solo solve: 256 x 256 took 80 s for
# the two runs, the script's time limit)
EXAMPLE_RUNS = (
    ("quickstart", []),
    ("sssp_pipeline", ["--n", "262144"]),
    ("batch_serving", ["--n", "262144", "--batch", "16", "--requests", "2"]),
    ("continuous_serving", ["--n", "16384", "--lanes", "8", "--queries",
                            "16", "--trace", "{tmp}/trace.json", "--report",
                            "{tmp}/report.json"]),
    ("continuous_serving", ["--n", "16384", "--lanes", "8", "--queries",
                            "16", "--chaos", "0"]),
    ("distributed_serving", ["--ranks", "2", "--n", "4096", "--queries",
                             "16", "--lanes", "4"]),
    ("serve_lm", ["--arch", "internlm2-1.8b"]),
    ("train_lm", ["--arch", "internlm2-1.8b", "--steps", "3", "--ckpt-dir",
                  "{tmp}/ckpt"]),
)
# a static solve of the default plan: #2 and the pair's mark and tail (its
# push by the layout, PAIR), and no PR 15 push
STATIC_SOLVE = ("frontier_crit_lanes_batch", "ell_settle_mark_batch",
                "ell_settle_tail_batch")


def examples_phase(dev, smi: str, counted: dict) -> tuple[dict, dict]:
    """Phase 31: every entry point of ``repro_torch.examples`` on the card
    (:data:`EXAMPLE_RUNS`), called in this process as a user's
    ``python -m`` would run it, its printed verdicts checked and each
    kernel's launches read around it. Returns the ``examples`` JSON line's
    dict and the launches of each run."""
    import importlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.core import static_engine as TS

    t31 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    summary, launches = {}, {}
    try:
        for name, args in EXAMPLE_RUNS:
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            argv = [a.format(tmp=tmp) for a in args] + ["--device", str(dev)]
            label = name + (" --chaos" if "--chaos" in args else
                            " --trace" if "--trace" in args else "")
            for f, attr in counted.values():
                setattr(f, attr, 0)
            TS.reset_chunk_stats()
            torch.cuda.synchronize(dev)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rec = mod.main(argv)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            counts = {k: getattr(f, attr) for k, (f, attr) in counted.items()}
            launches[label] = counts
            for line in rec.lines:
                log(f"  [{label}] {line}")
            if rec.lines != buf.getvalue().splitlines():
                raise SystemExit(f"{label}: its record differs from what "
                                 "it printed")
            row = examples_checks(name, rec, counts, label)
            st = TS.chunk_stats()
            row.update(seconds=wall, argv=argv[:-2],
                       launches={k: v for k, v in counts.items() if v},
                       chunks={"chunks": st.chunks, "replays": st.replays,
                               "captures": st.captures,
                               "host_reads": st.host_reads,
                               "live_phases": st.live_phases,
                               "dead_phases": st.dead_phases,
                               "dead_launches": dict(st.dead_launches)})
            summary[label] = row
            log(f"phase 31 {label} [{smi}]: {wall:.1f} s; launches "
                f"{row['launches']} (of them by the chunks' dead phases: "
                f"{row['chunks']['dead_launches']}); chunk loop "
                f"{row['chunks']}")
            if name == "sssp_pipeline":
                torch.cuda.empty_cache()  # its graphs are gone
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t31
    log(f"phase 31: {summary['seconds']:.1f} s")
    return summary, launches


def examples_checks(name: str, rec, counts: dict, label: str) -> dict:
    """Phase 31's checks of one entry point's run (its printed verdicts
    and its launches) and the figures the ``examples`` line keeps."""
    f = rec.fields

    def fail(why):
        raise SystemExit(f"phase 31 {label}: {why}")

    def static_path(*also):
        for k in STATIC_SOLVE + also:
            if counts[k] <= 0:
                fail(f"never launched {k}")
        for k in ("ell_relax_batch", "ell_push_relax_batch",
                  "ell_sliced_push_relax_batch"):
            if counts[k]:
                fail(f"launched {k} (the pull, or the PR 15 push the pair "
                     "replaces)")

    if name == "quickstart":
        verdicts = [line.split()[-1] for line in rec.lines[2:8]]
        if verdicts != ["True"] * 6:
            fail(f"a criterion's distances are wrong: {rec.lines}")
        if sssp_launched(counts):  # the COO reference loops run no kernel
            fail(f"launched {sssp_launched(counts)}")
        return {"phases": f["phases"]}
    if name == "sssp_pipeline":
        row = {}
        for fam, r in f["families"].items():
            if not all(e["correct"] for e in r["engines"].values()):
                fail(f"{fam}: an engine's distances are wrong")
            row[fam] = {k: r[k] for k in ("n", "m", "view", "view_bytes",
                                          "graph_s", "view_s",
                                          "dijkstra_s")}
            row[fam]["engines"] = r["engines"]
        views = {r["view"] for r in f["families"].values()}
        static_path(*(PAIR["padded"][1:2] if "padded" in views else ()),
                    *(PAIR["sliced"][1:2] if "sliced" in views else ()))
        return {"families": row}
    if name == "batch_serving":
        static_path(PAIR["padded"][1])
        phases = f["phases"]
        return {"n": f["n"], "m": f["m"], "phases": phases,
                "queries_per_s": f["queries_per_s"],
                "ms_per_phase": 1e3 * f["seconds"] / sum(phases),
                "view": "padded", "view_bytes": f["view_bytes"]}
    if name in ("continuous_serving", "distributed_serving"):
        m = f["metrics"]
        if len(f["completions"]) != m["queries_completed"]:
            fail("not every completion was checked")
        if name == "distributed_serving":
            if counts["ell_push_rect_batch"] <= 0:
                fail("never launched ell_push_rect_batch")
        elif "--chaos" in label:
            if counts["ell_key_min_batch"] <= 0:  # verify_row's gather
                fail("never launched ell_key_min_batch")
        else:
            static_path(PAIR["padded"][1])
        return {"n": f["n"], "m": f["m"],
                "queries": m["queries_completed"],
                "queries_per_s": m["throughput_qps"],
                "latency_p50_s": m["latency_p50_s"],
                "latency_p99_s": m["latency_p99_s"],
                "phases_per_query_mean": m["phases_per_query_mean"],
                "engine_trips": m["engine_trips"],
                **({"ranks": f["ranks"]} if "ranks" in f else {})}
    if sssp_launched(counts):  # the LM paths launch no SSSP kernel
        fail(f"launched {sssp_launched(counts)}")
    if name == "serve_lm":
        return {k: f[k] for k in ("prefill_s", "decode_s", "tokens_per_s")}
    if not np.isfinite(f["losses"]).all():
        fail(f"losses {f['losses']}")
    return {"losses": f["losses"], "mesh": f["mesh"]}


CHUNK_TIMED_PHASES = 256  # phases of each timed solve of phase 32
CHUNK_J_SWEEP = (4, 8, 16)  # the chunk lengths phase 32 times in turns


def chunk_loop_phase(dev, smi: str, views: dict, zero_counts, read_counts,
                     must_run, chunk_line, run_peak: list) -> dict:
    """Phase 32: ``step_batch``'s replayed CUDA graph against the same
    chunk run eagerly (``static_engine._step(capture=False)``), bit for bit
    on every state field over two calls of 3 j + 2 phases, on each case of
    ``cases`` below, and the wrappers' launch counts of a replayed solve
    against the kernels in its ``torch.profiler`` trace
    (:func:`traced_launches`); then, where timed, ms a phase of the graph
    and the eager chunk loop in turns (graph, eager, eager, graph) over
    :data:`CHUNK_TIMED_PHASES` phases from the sources, the device's busy
    share from ``torch.profiler`` (the graph's, and the eager loop's on
    the default plan's two padded cases), host reads a solve, a dead
    phase's device ms (a replay on a state of empty lanes, CUDA events),
    each capture's seconds and its pool's size, and the chunk lengths of
    :data:`CHUNK_J_SWEEP` in turns on the road grid and G(10^6, 10^-4).
    Returns each graph run's launches by path."""
    import torch

    from repro_torch.core import static_engine as TS
    from repro_torch.core.delta_stepping import default_delta
    from repro_torch.core.graph import to_ell_out_buckets
    from repro_torch.core.static_engine import init_batch_state
    from repro_torch.graphs import grid_road

    t32 = time.perf_counter()
    g, gk = views["g"], views["gk"]
    road = grid_road(512, 512, seed=SEED, device=dev)
    rng = np.random.default_rng(32)
    road_src = rng.integers(0, road.n, 16)
    road_tgt = np.where(np.arange(16) % 2 == 0, rng.integers(0, road.n, 16),
                        -1)
    crit = "frontier_crit_lanes_batch"
    default = "instatic|outstatic"
    # name -> (graph, sources, criterion, init kwargs, step kwargs, stop,
    #   the kernels its path must launch, timed: None, "graph" or
    #   "graph+eager", the loops whose busy share is profiled)
    cases = {
        "default G(10^6, 10^-4) B=8": (
            g, views["src8"], default, {}, views["padded"], False,
            (crit, *PAIR["padded"]), "graph+eager"),
        "default kronecker(20) sliced B=8": (
            gk, views["src8_k"], default, {}, views["sliced"], False,
            (crit, *PAIR["sliced"]), "graph"),
        "delta@x4:sliced G(10^6, 10^-4) B=8": (
            g, views["src8"], "delta", {"delta": 4 * default_delta(g)},
            {"ell_out": to_ell_out_buckets(g)}, False,
            DELTA_PAIR["sliced"], "graph"),
        "delta@x4:sliced kronecker(20) B=8": (
            gk, views["src8_k"], "delta", {"delta": 4 * default_delta(gk)},
            {"ell_out": to_ell_out_buckets(gk)}, False,
            DELTA_PAIR["sliced"], "graph"),
        "in|out G(10^6, 10^-4) padded B=8": (
            g, views["src8"], "in|out", {}, views["padded"], False,
            (crit, "ell_relax_keys_batch", "ell_keys_dep_batch"), None),
        "default grid_road(512, 512) B=16": (
            road, road_src, default, {}, {}, False,
            (crit, *PAIR["padded"]), "graph+eager"),
        "grid_road(512, 512) B=16 targets, stop_on_lane_finish": (
            road, road_src, default, {"targets": road_tgt}, {}, True,
            (crit, *PAIR["padded"]), None),
    }
    j = TS.PHASES_PER_REPLAY
    by_path = {}

    def differs(a, b) -> list:
        return [f.name for f in dataclasses.fields(a)
                if not (getattr(a, f.name) is None is getattr(b, f.name)
                        or (torch.is_tensor(getattr(a, f.name))
                            and same_bits(getattr(a, f.name),
                                          getattr(b, f.name)))
                        or getattr(a, f.name) == getattr(b, f.name))]

    def runner(graph, st0, kw, stop, k, mode):
        if mode == "graph":
            return lambda: TS.step_batch(graph, st0, k,
                                         stop_on_lane_finish=stop, **kw)
        return lambda: TS._step(graph, st0, k, kw.get("ell"), True, stop,
                                kw.get("ell_out"), capture=False)

    def pool_now() -> tuple:
        """The id of the memory pool the card's captures go to now (None
        before the first) and the MiB of its segments."""
        entry = TS._POOLS.get(torch.cuda.current_device())
        if entry is None:
            return None, 0.0
        pool = tuple(entry[0])
        return pool, sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool) / 2**20

    def timed(fn) -> tuple[float, object]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    # (case, captures, their seconds, the pool's MiB, whether the pool is
    # the key's own). A capture shares the pool of the graphs captured
    # before it while one of them lives; every case frees its chunks at
    # its end, so where no other capture lives on the card a case's key
    # gets a pool of its own, whose size is then the key's
    captures = []
    for graph in (g, gk):
        TS.forget_chunks(graph)
    for name, (graph, srcs, crit_spec, ikw, skw, stop, must, timed_as) in \
            cases.items():
        TS.forget_chunks(graph)
        pool0, _ = pool_now()
        st0 = init_batch_state(graph, srcs, criterion=crit_spec, device=dev,
                               **ikw)
        # (a) the bits: two calls of 3 j + 2 phases, graph against eager
        TS.reset_chunk_stats()
        sg = se = st0
        for call in range(2):
            sg = runner(graph, sg, skw, stop, 3 * j + 2, "graph")()
            se = runner(graph, se, skw, stop, 3 * j + 2, "eager")()
            bad = differs(sg, se)
            if bad:
                raise SystemExit(f"phase 32 {name}: the replayed graph "
                                 f"differs from the eager chunk in {bad} "
                                 f"(call {call + 1})")
        st = TS.chunk_stats()
        pool1, pool_mib = pool_now()
        captures.append((name, st.captures, st.capture_s, pool_mib,
                         pool1 != pool0))
        chunk = next(reversed(graph.__dict__["_chunk_memo"].values()))
        bufs = [getattr(chunk.buf, f.name)
                for f in dataclasses.fields(chunk.buf)]
        buf_mib = sum(t.numel() * t.element_size() for t in bufs
                      if torch.is_tensor(t)) / 2**20
        log(f"phase 32 {name}: the replayed graph bit-equal to the eager "
            f"chunk on every state field over two calls of {3 * j + 2} "
            f"phases ({int(sg.trips)} trips); the chunk's state buffers "
            f"{buf_mib:.1f} MiB, the capture pool {pool_mib:.1f} MiB ("
            + ("its own" if pool1 != pool0 else "shared with earlier "
               "captures") + ")")
        # the launch counts against the trace: a replayed solve of 3 j + 2
        # phases from the sources under torch.profiler, each kernel of
        # TRACE_SIGNATURES as often in the trace as its wrappers counted (a
        # replay adds its capture's counts). The profiler may drop records,
        # never add them, and the solve is the same each time: one of up to
        # three traces must match, none may show fewer counts than kernels
        traced = runner(graph, st0, skw, stop, 3 * j + 2, "graph")
        for attempt in range(1, 4):
            kinds = {}
            seen, said = traced_launches(traced, zero_counts, read_counts,
                                         kinds)
            if any(seen[kk] > said[kk] for kk in seen):
                raise SystemExit(f"phase 32 {name}: the trace holds more "
                                 f"kernels than the wrappers counted: trace "
                                 f"{seen}, counts {said}")
            if seen == said:
                break
        else:
            raise SystemExit(f"phase 32 {name}: no trace of three matches "
                             f"the wrappers' counts: last trace {seen}, "
                             f"counts {said}")
        st = TS.chunk_stats()
        first = DELTA_PHASE_KERNELS[0] if crit_spec == "delta" else \
            PHASE_KERNELS[0]
        if st.replays == 0 or st.captures or seen[first] == 0:
            raise SystemExit(f"phase 32 {name}: the traced solve replayed "
                             f"no graph ({st.replays} replays, "
                             f"{st.captures} captures, trace {seen})")
        log(f"phase 32 {name}: a traced replayed solve ({st.chunks} chunks, "
            f"{st.replays} replayed, {st.dead_phases} dead phases): "
            + ", ".join(f"{kk} {seen[kk]} in the trace = {said[kk]} counted"
                        for kk in seen if said[kk])
            + f" (trace {attempt})")
        phase_kernels = (DELTA_PHASE_KERNELS if crit_spec == "delta" else
                         PHASE_KERNELS if name.startswith("default")
                         and "sliced" not in name else None)
        if phase_kernels is not None:
            # a replayed phase of the default plan on the padded layout is
            # #2 and the pair, one of delta on either layout its threshold,
            # mark, push and tail: the kernels the trace holds once a phase
            # or more are those four; the rest are the chunk's own (its flag
            # and the copies), fewer than one a phase
            phases = st.chunks * j
            per_phase = sorted(kk for kk, c in kinds.items() if c >= phases)
            if len(per_phase) != len(phase_kernels) or any(
                    sum(re.search(rf"\b{kern}\b", kk) is not None
                        for kk in per_phase) != 1
                    for kern in phase_kernels) or any(
                    seen[kern] != phases for kern in phase_kernels[1:]):
                raise SystemExit(
                    f"phase 32 {name}: a replayed phase launched other "
                    f"kernels than its four: {per_phase} at least "
                    f"{phases} times in {phases} phases (trace {kinds})")
            log(f"phase 32 {name}: {len(per_phase)} kernels a replayed "
                f"phase ({', '.join(per_phase)}), each {phases} times in "
                f"{phases} phases; the chunk's own: " + ", ".join(
                    f"{kk} {c}" for kk, c in sorted(kinds.items())
                    if kk not in per_phase))
        if timed_as is None:
            zero_counts()
            runner(graph, st0, skw, stop, 3 * j + 2, "graph")()
            torch.cuda.synchronize()
            counts = read_counts()
            must_run(counts, must, f"phase 32 {name}")
            by_path[f"chunk loop {name}"] = counts
            log(chunk_line(f"phase 32 {name}, graph"))
            TS.forget_chunks(graph)
            continue
        # (b) ms a phase in turns: graph, eager, eager, graph
        k = CHUNK_TIMED_PHASES
        turns = []
        for mode in ("graph", "eager", "eager", "graph"):
            zero_counts()
            wall, res = timed(runner(graph, st0, skw, False, k, mode))
            counts = read_counts()
            trips = int(res.trips)
            turns.append((mode, wall / trips * 1e3, TS.chunk_stats().host_reads,
                          trips))
            if mode == "graph" and len(turns) == 1:
                must_run(counts, must, f"phase 32 {name}")
                by_path[f"chunk loop {name}"] = counts
                log(chunk_line(f"phase 32 {name}, graph"))
        trips = turns[0][3]
        busy = {mode: busy_line(runner(graph, st0, skw, False, k, mode),
                                float(np.mean([t[1] for t in turns
                                               if t[0] == mode]))
                                * trips / 1e3, trips)
                for mode in timed_as.split("+")}
        log(f"phase 32 {name} [{smi}]: {trips} phases from the sources, ms a "
            f"phase in turns (graph, eager, eager, graph): "
            + ", ".join(f"{t[1]:.4f}" for t in turns)
            + f"; host reads: graph {turns[0][2]}, eager {turns[1][2]}")
        for mode, line in busy.items():
            log(f"phase 32 {name} {mode}: {line}")
        # (c) a dead phase: replays on a state of empty lanes
        empty = init_batch_state(graph, [-1] * len(srcs),
                                 criterion=crit_spec, device=dev, **{
                                     kk: v for kk, v in ikw.items()
                                     if kk == "delta"})
        TS.step_batch(graph, empty, j, **skw)
        chunk = next(reversed(graph.__dict__["_chunk_memo"].values()))
        dead_ms = time_ms(chunk.graph.replay, reps=20) / j
        log(f"phase 32 {name} [{smi}]: a dead phase {dead_ms:.4f} ms on the "
            f"device (a replay of {j} on empty lanes, CUDA events, median "
            f"of 20); the tail of a chunk costs at most {j - 1} of them")
        TS.forget_chunks(graph)
    log(f"phase 32: {sum(c[1] for c in captures)} captures (one a key), "
        f"their seconds, and the segments of the pool each went to after "
        f"it: " + "; ".join(
            f"{case} {n} in {sec:.3f} s, pool {mib:.1f} MiB ("
            + ("its own" if own else "shared") + ")"
            for case, n, sec, mib, own in captures))
    # (d) the chunk length: each of CHUNK_J_SWEEP in turns, forwards then
    # backwards, on the road grid and G(10^6, 10^-4), default plan
    sweep = {}
    for name in ("default grid_road(512, 512) B=16",
                 "default G(10^6, 10^-4) B=8"):
        graph, srcs, crit_spec, ikw, skw, _, _, _ = cases[name]
        st0 = init_batch_state(graph, srcs, criterion=crit_spec, device=dev)
        for jj in CHUNK_J_SWEEP + CHUNK_J_SWEEP[::-1]:
            TS.PHASES_PER_REPLAY = jj
            try:
                TS.forget_chunks(graph)
                run = runner(graph, st0, skw, False, CHUNK_TIMED_PHASES,
                             "graph")
                run()  # the capture
                wall, res = timed(run)
            finally:
                TS.PHASES_PER_REPLAY = j
            sweep.setdefault(name, {}).setdefault(jj, []).append(
                wall / int(res.trips) * 1e3)
        TS.forget_chunks(graph)
        log(f"phase 32 j sweep {name} [{smi}]: ms a phase "
            + "; ".join(f"j={jj} " + ", ".join(f"{x:.4f}" for x in v)
                        for jj, v in sweep[name].items()))
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    log(f"phase 32: {time.perf_counter() - t32:.1f} s")
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (
        KEEP_LANE,
        EllSlice,
        out_degrees,
        sliced_ell,
        to_ell_in,
        to_ell_in_sliced,
        to_ell_out,
        to_ell_out_buckets,
        to_ell_out_sliced,
    )
    from repro_torch.core import criteria as C
    from repro_torch.core import default_delta, run_delta_stepping, run_phased
    from repro_torch.core.graph import from_coo, vertex_row_table
    from repro_torch.core.policies import DeltaPolicy, policy_for
    from repro_torch.core import static_engine as TS
    from repro_torch.core.static_engine import (
        harvest,
        init_batch_state,
        run_phased_static_batch,
        step_batch,
    )
    from repro_torch.graphs import grid_road, uniform_gnp
    from repro_torch.graphs.generators import kronecker_coo
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ell_key_min import (
        ell_key_min,
        ell_key_min_batch,
        ell_key_min_status_batch,
    )
    from repro_torch.kernels.ell_relax import (
        ell_delta_push_batch,
        ell_push_relax_batch,
        ell_relax,
        ell_relax_batch,
    )
    from repro_torch.kernels import ell_relax_keys as erk
    from repro_torch.kernels.config import RELAX_THREADS, relax_threads_per_row
    from repro_torch.kernels.ell_relax_keys import (
        ell_gather_min_batch,
        ell_keys_dep_batch,
        ell_relax_keys_batch,
    )
    from repro_torch.kernels.ell_sliced import (
        ell_sliced_delta_push_batch,
        ell_sliced_gather_min_batch,
        ell_sliced_keys_dep_batch,
        ell_sliced_push_relax_batch,
        ell_sliced_relax_keys_batch,
    )
    from repro_torch.kernels.frontier_crit import frontier_crit_lanes_batch
    from repro_torch.kernels.settle_push import settle_phase_batch
    from repro_torch.obs import (
        Observability,
        attribution_terms,
        phase_telemetry,
        publish_phase_telemetry,
        trace_phase_telemetry,
        validate_events,
    )
    from repro_torch.analysis import TraceGuard, capture_count, compile_count
    from repro_torch.kernels import config as kcfg
    from repro_torch.kernels.config import TuningLedger
    from repro_torch.kernels.registry import collect as collect_contracts
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import (
        DEFAULT_CANDIDATES,
        ContinuousBatcher,
        DistCache,
        EngineCandidate,
        Fault,
        FaultPlan,
        FaultyBackend,
        FaultyDistCache,
        PortfolioBackend,
        ResilientBatcher,
        StaticBackend,
        VirtualClock,
        graph_family,
        graph_key,
        measure_portfolio,
        pick_engine,
        run_point_to_point,
        transpose_memo,
        verify_row,
    )

    counted = kernel_counters()

    def zero_counts():
        for f, attr in counted.values():
            setattr(f, attr, 0)
        TS.reset_chunk_stats()  # the chunk loop's counts go with them

    def chunk_line(what: str) -> str:
        """The chunk loop's counts since the last zero_counts(): chunks,
        replays and captures, host reads, live and dead phases, and the
        launches of the dead phases (counted in the launches too)."""
        st = TS.chunk_stats()
        return (f"{what}: {st.chunks} chunks of {TS.PHASES_PER_REPLAY} "
                f"phases ({st.replays} replayed, {st.captures} captured in "
                f"{st.capture_s:.3f} s), {st.host_reads} host reads, "
                f"{st.live_phases} live and {st.dead_phases} dead phases; "
                f"the dead phases' launches {st.dead_launches}")

    def read_counts() -> dict:
        return {name: getattr(f, attr) for name, (f, attr) in counted.items()}

    def must_run(counts: dict, names, what: str):
        for name in names:
            if counts[name] <= 0:
                raise SystemExit(f"{what} never launched {name}")

    def serve(backend, sources) -> tuple:
        """16 requests through 8 lanes: reset_lanes -> step -> peek ->
        take_row, counts set to 0 just before and read just after."""
        state = backend.init(LANES)
        lane_req = [None] * LANES
        pending = list(range(REQUESTS))
        rows, req_phases = {}, {}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        steps = 0
        while pending or any(r is not None for r in lane_req):
            admit = np.full(LANES, KEEP_LANE, np.int64)
            for lane in range(LANES):
                if lane_req[lane] is None and pending:
                    lane_req[lane] = pending.pop(0)
                    admit[lane] = sources[lane_req[lane]]
            if (admit != KEEP_LANE).any():
                state = backend.reset_lanes(state, admit)
            state = backend.step(state, CHUNK, stop_on_lane_finish=True)
            steps += 1
            if steps > 4 * REQUESTS * 64:  # a lane that never finishes
                raise SystemExit(f"{backend.criterion} serving made no "
                                 f"progress in {steps} steps")
            _, active, phases = backend.peek(state)
            for lane in range(LANES):
                r = lane_req[lane]
                if r is not None and not active[lane]:
                    rows[r] = backend.take_row(state, lane)
                    req_phases[r] = int(phases[lane])
                    lane_req[lane] = None
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        log(chunk_line(f"{backend.criterion} serving"))
        trips = int(state.trips)
        if len(rows) != REQUESTS:
            raise SystemExit(f"{backend.criterion} serving did not answer "
                             "every request")
        return rows, req_phases, counts, serve_s, steps, trips

    if kcfg.kernel_mode() != "auto":
        raise SystemExit(
            f"chip_smoke runs the kernels as shipped: REPRO_TORCH_KERNEL_MODE "
            f"resolves to {kcfg.kernel_mode()!r}; unset it")
    dev = torch.device("cuda", 0)
    # the whole run's peak: a phase that resets the allocator's peak to read
    # its own folds the peak so far in here first
    run_peak = [0]
    torch.backends.cuda.matmul.allow_tf32 = False  # nothing here multiplies;
    torch.backends.cudnn.allow_tf32 = False  # set so no reader has to ask

    marks = [("1", RUN_T0)]

    def phase_mark(label):
        """Log the seconds of the phase that ends here (and of the run so
        far); ``label`` is the next phase's (None: the last ended)."""
        prev, since = marks[-1]
        t = time.perf_counter()
        log(f"phase {prev} ended: {t - since:.1f} s, {t - RUN_T0:.1f} s into "
            "the run")
        marks.append((label, t))

    # ---- 1. device and build -------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # phase 12's skewed graph, drawn on the host (numpy, ~100 s) in a thread
    # beside the build and phase 29, which time nothing that a claim reads;
    # it is joined before phase 2, so no timed phase shares the host with it
    kron_pool = ThreadPoolExecutor(1)
    kron_job = kron_pool.submit(kronecker_coo, KRON_K, seed=SEED)
    t0 = time.perf_counter()
    # the two-pass body #2 ran on before (tools/crit_variants.py holds it),
    # built beside the shipped sources to be timed in turns with its
    # redesign
    crit_tool = load_tool("crit_variants")
    with ThreadPoolExecutor(1) as pool:
        two_pass = pool.submit(crit_tool.build, [crit_tool.TWO_PASS],
                               ROOT / "build" / "variants")
        _build.build()
        two_pass_lib = two_pass.result()[crit_tool.TWO_PASS]
    log(f"build: {sorted(_build.SOURCES)} and #2's two-pass body in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    resources = {nm: _build.kernel_resources(nm) for nm in _build.SOURCES}
    for name, kernels_of in sorted(resources.items()):
        for fn, r in sorted(kernels_of.items()):
            log(f"  ptxas {name}.cu {fn}: {r['registers']} registers, "
                f"{r['smem_bytes']} bytes smem, spills {r['spill_stores']} / "
                f"{r['spill_loads']} bytes ({len(r['instances'])} instances)")

    phase_mark("29")
    # ---- 29. the LM substrate on a mesh, run here: its four ranks share
    # the card's memory, which no graph holds yet ---------------------------
    zero_counts()
    lm29 = lm_mesh_phase(dev, smi, run_peak)
    lm29_counts = read_counts()
    if sssp_launched(lm29_counts):  # the mesh path runs no SSSP kernel
        raise SystemExit(f"phase 29 launched SSSP kernels: {lm29_counts}")
    t0 = time.perf_counter()
    coo_k = kron_job.result()
    kron_pool.shutdown()
    kron_wait_s = time.perf_counter() - t0

    def crit_turns(d, st, keys, reps=50):
        """#2 in turns with its two-pass body (old, new, new, old) on one
        input, both bit-checked against the twin first: the CUDA-event
        medians, and each form's device ms a call (torch.profiler)."""
        old, got_old = crit_tool.caller(crit_tool.TWO_PASS, two_pass_lib, d,
                                        st, keys)

        def new():
            return frontier_crit_lanes_batch(d, st, keys)

        want = ref.frontier_crit_lanes_batch_ref(d, st, keys)
        old()
        got_new = new()
        torch.cuda.synchronize()
        for label, got in (("two-pass body", got_old), ("kernel", got_new)):
            if not all(same_bits(a, w) for a, w in zip(got, want)):
                raise SystemExit(f"frontier_crit_lanes_batch ({label}) "
                                 "disagrees with its twin")
        turns = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps),
                 time_ms(old, reps)]
        dev_ms = [sum(t for _, t in device_split(f, calls=10))
                  for f in (old, new)]
        return turns, dev_ms

    phase_mark("2")
    # ---- 2. kernel parity at full width ----------------------------------
    t0 = time.perf_counter()
    g = uniform_gnp(N, P, seed=SEED, device=dev)
    cols, ws = to_ell_in(g)
    torch.cuda.synchronize()
    n, d_pad = cols.shape
    ell_bytes = cols.numel() * 4 + ws.numel() * 4
    log(f"graph: G(n={N}, p={P}) seed {SEED}: n={g.n}, m={g.m}, D={d_pad}, "
        f"ELL {ell_bytes / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cols_o, ws_o = to_ell_out(g)  # the default plan's relax pushes along it
    torch.cuda.synchronize()
    ell_out_bytes = cols_o.numel() * 4 + ws_o.numel() * 4
    log(f"out-ELL: D_out={cols_o.shape[1]}, {ell_out_bytes / 1e9:.3f} GB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    out_deg = out_degrees(g)
    gr = grid_road(1024, 1024, seed=0, device=dev)
    cols_r, ws_r = to_ell_in(gr)
    log(f"graph: grid_road seed 0: n={gr.n}, D={cols_r.shape[1]}")

    rng = np.random.default_rng(7)
    d8, st8 = seeded_state(rng, LANES, n, dev)
    dmask8 = kops.pad_lane_batch(torch.where(st8 == 1, d8, float("inf")))
    dmask_nan = dmask8.clone()
    dmask_nan[3, int(cols[5, 0])] = float("nan")  # reaches row 5 of lane 3
    d_nan = d8.clone()
    fringe_cols = torch.nonzero(st8[2] == 1)[:1, 0]
    d_nan[2, fringe_cols] = float("nan")  # a NaN on lane 2's fringe
    d13, st13 = seeded_state(rng, 13, gr.n, dev)
    dmask13 = kops.pad_lane_batch(torch.where(st13 == 1, d13, float("inf")))
    keys_shared = g.out_min_static[None].contiguous()
    keys_lane = torch.from_numpy(
        rng.uniform(0.0, 1.0, (2, LANES, n)).astype(np.float32)).to(dev)
    d1, st1 = d8[:1].contiguous(), st8[:1].contiguous()

    relax_cases = {
        "gnp B=8": (dmask8, cols, ws),
        "gnp B=1": (dmask8[:1].contiguous(), cols, ws),
        "gnp B=3": (dmask8[:3].contiguous(), cols, ws),
        "gnp B=8 NaN": (dmask_nan, cols, ws),
        "grid_road D=8 B=13": (dmask13, cols_r, ws_r),
    }
    crit_cases = {
        "gnp K=0": (d8, st8, None),
        "gnp K=1 shared": (d8, st8, keys_shared),
        "gnp K=2 per-lane": (d8, st8, keys_lane),
        "gnp B=1 K=1 shared": (d1, st1, keys_shared),
        "gnp K=1 shared NaN": (d_nan, st8, keys_shared),
        "grid_road B=13 K=1 shared": (d13, st13, gr.out_min_static[None]),
    }
    for cut in (1, 3):  # rows of n - 1 and n - 3 vertices: n % 4 = 3, 1
        m_ = n - cut
        crit_cases[f"gnp n % 4 = {m_ % 4} K=1 shared"] = (
            d8[:, :m_].contiguous(), st8[:, :m_].contiguous(),
            keys_shared[:, :m_].contiguous())
        crit_cases[f"gnp n % 4 = {m_ % 4} K=2 per-lane"] = (
            d8[:, :m_].contiguous(), st8[:, :m_].contiguous(),
            keys_lane[:, :, :m_].contiguous())
    errs = {"ell_relax_batch": 0.0, "frontier_crit_lanes_batch": 0.0}
    for label, (dm, c, w) in relax_cases.items():
        got = ell_relax_batch(dm, c, w)
        want = ref.ell_relax_batch_ref(dm, c, w)
        torch.cuda.synchronize()
        ok = same_bits(got, want)
        errs["ell_relax_batch"] = max(errs["ell_relax_batch"],
                                      max_abs_err(got, want))
        log(f"parity ell_relax_batch [{label}]: {'bits equal' if ok else 'DIFFER'}"
            f" (NaN out: {int(torch.isnan(got).sum())})")
        if not ok:
            raise SystemExit(f"ell_relax_batch disagrees with its twin: {label}")
    got = ell_relax(dmask8[4], cols, ws)
    want = ref.ell_relax_ref(dmask8[4], cols, ws)
    if not same_bits(got, want):
        raise SystemExit("ell_relax (the B = 1 view) disagrees with its twin")
    log("parity ell_relax [gnp 1-D view]: bits equal")

    def check_push(name, label, dm, out_view, pull, deg):
        """The push against its twin and against the pull on one input;
        ``deg`` is the graph's out-degrees."""
        push = (ell_push_relax_batch(dm, *out_view) if name ==
                "ell_push_relax_batch"
                else ell_sliced_push_relax_batch(dm, out_view))
        twin = ref.ell_push_relax_batch_ref(dm, out_view)
        torch.cuda.synchronize()
        ok_twin, ok_pull = same_bits(push, twin), same_bits(push, pull)
        errs[name] = max(errs.get(name, 0.0), max_abs_err(push, twin))
        active, cand, _ = push_load(dm, deg)
        log(f"parity {name} [{label}]: twin "
            f"{'bits equal' if ok_twin else 'DIFFER'}, pull "
            f"{'bits equal' if ok_pull else 'DIFFER'} ({active} active rows, "
            f"{cand} candidates, NaN out: {int(torch.isnan(push).sum())})")
        if not (ok_twin and ok_pull):
            raise SystemExit(f"{name} disagrees with its twin or the pull: "
                             f"{label}")

    pad = kops.pad_lane_batch
    prng = np.random.default_rng(15)
    dm8u = torch.where(st8 == 1, d8, INF)  # a third of the slots finite
    push_cases = {
        "gnp B=8, a third of dmask finite (dense)": dm8u,
        "gnp B=1": dm8u[:1].contiguous(),
        "gnp B=13 NaN lanes": seeded_push_dmask(prng, 13, n, 0.003, dev),
        "gnp B=40 NaN lanes": seeded_push_dmask(prng, 40, n, 0.001, dev),
    }
    for label, dm in push_cases.items():
        check_push("ell_push_relax_batch", label, dm, (cols_o, ws_o),
                   ell_relax_batch(pad(dm), cols, ws), out_deg)
    dm13u = torch.where(st13 == 1, d13, INF)
    check_push("ell_push_relax_batch", "grid_road B=13", dm13u,
               to_ell_out(gr), ell_relax_batch(pad(dm13u), cols_r, ws_r),
               out_degrees(gr))
    del push_cases, dm13u
    # the phase-committing pair (#1b redesigned): the settle mark, the
    # worklist push and the tail on seeded states at full width, #2's
    # thresholds for the default plan (one with its OUT lane at +inf, so a
    # third of the slots settle), a NaN on a lane's fringe, target lanes,
    # the three terms with the attribution ring, the road grid at B = 13
    mins8, nf8 = frontier_crit_lanes_batch(d8, st8, keys_shared)
    mins_all = mins8.clone()
    mins_all[1] = INF
    tg8 = torch.from_numpy(np.where(np.arange(LANES) % 2 == 0,
                                    rng.integers(0, n, LANES), -1).astype(
                                        np.int32)).to(dev)
    mins_nan, nf_nan = frontier_crit_lanes_batch(d_nan, st8, keys_shared)
    mins13, nf13 = frontier_crit_lanes_batch(d13, st13,
                                             gr.out_min_static[None])
    pair_cases = {
        "gnp B=8, #2's thresholds": (
            (d8, st8, mins8, nf8, nf8 > 0, (cols_o, ws_o), out_deg,
             g.in_min_static), {"zero": False}),
        "gnp B=8, the OUT lane +inf (a third settle)": (
            (d8, st8, mins_all, nf8, nf8 > 0, (cols_o, ws_o), out_deg,
             g.in_min_static), {"zero": False}),
        "gnp B=8, a NaN on lane 2's fringe, targets": (
            (d_nan, st8, mins_nan, nf_nan, nf_nan > 0, (cols_o, ws_o),
             out_deg, g.in_min_static), {"zero": False, "target": tg8}),
        "gnp B=8, DIJK, INSTATIC and OUTSTATIC, telemetry": (
            (d8, st8, mins8, nf8, nf8 > 0, (cols_o, ws_o), out_deg,
             g.in_min_static), {"zero": True, "telemetry": True}),
        "gnp B=1, stop": (
            (d1, st1, mins8[:, :1].contiguous(), nf8[:1], nf8[:1] > 0,
             (cols_o, ws_o), out_deg, g.in_min_static),
            {"zero": False, "stop": True}),
        "grid_road B=13": (
            (d13, st13, mins13, nf13, nf13 > 0, to_ell_out(gr),
             out_degrees(gr), gr.in_min_static), {"zero": False}),
    }
    for label, (pargs, pkw) in pair_cases.items():
        errs["ell_settle_commit_batch"] = max(
            errs.get("ell_settle_commit_batch", 0.0),
            pair_check(pargs, pkw, label))
    del pair_cases, mins_all, tg8, mins_nan, nf_nan, mins13, nf13
    for label, (d, st, k) in crit_cases.items():
        mins, cnt = frontier_crit_lanes_batch(d, st, k)
        w_mins, w_cnt = ref.frontier_crit_lanes_batch_ref(d, st, k)
        torch.cuda.synchronize()
        ok = same_bits(mins, w_mins) and same_bits(cnt, w_cnt)
        errs["frontier_crit_lanes_batch"] = max(
            errs["frontier_crit_lanes_batch"], max_abs_err(mins, w_mins))
        log(f"parity frontier_crit_lanes_batch [{label}]: "
            f"{'bits equal' if ok else 'DIFFER'} (NaN out: "
            f"{int(torch.isnan(mins).sum())})")
        if not ok:
            raise SystemExit(
                f"frontier_crit_lanes_batch disagrees with its twin: {label}")
    # 50 calls in a row on alternating inputs, every result held: each call
    # finds the ticket its predecessor put back to 0
    rounds = [crit_cases["gnp K=1 shared"], crit_cases["gnp K=2 per-lane"]]
    wants = [ref.frontier_crit_lanes_batch_ref(*x) for x in rounds]
    outs = [frontier_crit_lanes_batch(*rounds[i % 2]) for i in range(50)]
    torch.cuda.synchronize()
    if not all(same_bits(o[0], wants[i % 2][0])
               and same_bits(o[1], wants[i % 2][1])
               for i, o in enumerate(outs)):
        raise SystemExit("frontier_crit_lanes_batch differs in 50 calls in "
                         "a row")
    log("parity frontier_crit_lanes_batch [50 calls in a row, alternating "
        "shared and per-lane keys]: bits equal")
    del rounds, wants, outs, crit_cases, d, st, k

    phase_mark("3")
    # ---- 3. the main path, serving ---------------------------------------
    sources = np.random.default_rng(1).integers(0, g.n, REQUESTS)
    rows, req_phases, launches, serve_s, steps, trips = serve(
        StaticBackend(g, device=dev), sources)
    log(f"serving: {len(rows)} requests answered in {serve_s:.3f} s "
        f"({len(rows) / serve_s:.2f} queries/s), {steps} step calls, "
        f"{trips} trips; phases per request "
        f"{[req_phases[r] for r in range(REQUESTS)]}")
    log(f"serving launches: {launches}")
    for name in ("frontier_crit_lanes_batch", *PAIR["padded"]):
        if launches[name] <= 0:
            raise SystemExit(f"the main path never launched {name}")
    pulled = {nm: launches[nm] for nm in ("ell_relax_batch",
                                          "ell_sliced_gather_min_batch",
                                          "ell_push_relax_batch",
                                          "ell_sliced_push_relax_batch",
                                          "ell_sliced_settle_push_batch")}
    if any(pulled.values()):
        raise SystemExit(f"the main path launched another relax: {pulled}")

    phase_mark("4")
    # ---- 4. end-to-end parity on the card --------------------------------
    src8 = sources[:LANES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_k = run_phased_static_batch(g, src8, ell=(cols, ws), device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_p = run_phased_static_batch(g, src8, ell=(cols, ws), device=dev,
                                    use_kernels=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for field in ("dist", "status", "phases", "total_phases"):
        if not same_bits(getattr(res_k, field), getattr(res_p, field)):
            raise SystemExit(f"kernel and plain solves differ in {field}")
    for field in ("sum_fringe", "relax_edges"):
        if not np.array_equal(getattr(res_k, field), getattr(res_p, field)):
            raise SystemExit(f"kernel and plain solves differ in {field}")
    total = int(res_k.total_phases)

    def solve_default():
        return run_phased_static_batch(g, src8, ell=(cols, ws), device=dev)

    walls = repeat_wall(solve_default, solve_s)
    solve_s = float(np.median(walls))
    default_ms_phase = solve_s / total * 1e3  # phase 20 prints it beside delta
    log(f"e2e: B={LANES} solve with kernels, 3 runs "
        + ", ".join(f"{w:.3f}" for w in walls) + f" s, median {solve_s:.3f} s "
        f"({LANES / solve_s:.2f} queries/s, {total} phases, "
        f"{solve_s / total * 1e3:.3f} ms/phase); plain twins {plain_s:.3f} s; "
        f"every BatchedResult field bit-equal")
    log(f"e2e: {busy_line(solve_default, solve_s, total)}")
    log(f"e2e: phases per row {res_k.phases.tolist()}, sum_fringe "
        f"{res_k.sum_fringe.tolist()}, relax_edges {res_k.relax_edges.tolist()}")
    dist_k = res_k.dist.cpu().numpy()
    for i in range(LANES):
        if not np.array_equal(rows[i].view(np.int32), dist_k[i].view(np.int32)):
            raise SystemExit(f"served row {i} differs from the batch solve")
    log("e2e: the 8 served rows equal the batch solve's rows bit for bit")
    del res_p

    phase_mark("5")
    # ---- 5. independent check against scipy ------------------------------
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    t0 = time.perf_counter()
    real = torch.isfinite(g.w)
    e_src, e_dst, e_w = g.src[real], g.dst[real], g.w[real]
    order = torch.sort(e_src.long(), stable=True).indices
    indptr = torch.zeros(g.n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(e_src.long(), minlength=g.n), 0)
    csr = sp.csr_matrix(
        (e_w[order].double().cpu().numpy(), e_dst[order].cpu().numpy(),
         indptr.cpu().numpy()), shape=(g.n, g.n))
    want = dijkstra(csr, directed=True, indices=int(src8[0]))
    got = dist_k[0]
    fin = np.isfinite(want)
    same_set = bool((np.isfinite(got) == fin).all())
    close = bool(np.allclose(got[fin], want[fin], rtol=1e-5))
    rel = np.abs(got[fin] - want[fin]) / np.maximum(want[fin], 1e-30)
    log(f"scipy: row 0 (source {int(src8[0])}) reachable {int(fin.sum())}; "
        f"same reachable set {same_set}, rtol 1e-5 {close}, max rel err "
        f"{float(rel.max()):.3e} ({time.perf_counter() - t0:.1f} s)")
    if not (same_set and close):
        raise SystemExit("row 0 disagrees with scipy's Dijkstra")

    phase_mark("6")
    # ---- 6. kernel times at the main shape --------------------------------
    # The kernels' inputs of one real phase: phase MID_PHASE of the B = 8
    # solve above, built with the policy's own ops (crit thresholds, the
    # plan's settle mask, the ops layer's padding).
    st_mid = init_batch_state(g, src8, device=dev)
    st_mid = step_batch(g, st_mid, MID_PHASE, ell=(cols, ws))
    d_mid, s_mid = st_mid.dist, st_mid.status
    mins_mid, nf_mid = kops.crit_thresholds_batch(d_mid, s_mid, keys_shared)
    settle_mid = C.plan_union_mask(st_mid.plan, d_mid, s_mid == 1, mins_mid,
                                   {}, g.in_min_static, None)
    dmask_mid = kops.pad_lane_batch(
        torch.where(settle_mid, d_mid, float("inf")))
    fringe_mid = int(nf_mid.sum())
    cols_long = cols.long()
    live_slots = int(sum(torch.isfinite(dmask_mid[b][cols_long]).sum()
                         for b in range(LANES)))
    del cols_long
    log(f"timing inputs: phase {int(st_mid.trips)} of the B={LANES} solve: "
        f"{int(settle_mid.sum())} settled, {fringe_mid} on the fringe, "
        f"{live_slots} of {LANES * n * d_pad} lane-slots finite")
    # the relax, push and pull, on the same input in turns
    dm_mid = torch.where(settle_mid, d_mid, INF)  # the push's (B, n) input
    check_push("ell_push_relax_batch", f"phase {MID_PHASE} input", dm_mid,
               (cols_o, ws_o), ell_relax_batch(dmask_mid, cols, ws), out_deg)
    push_stats = torch.zeros(2, dtype=torch.int64, device=dev)
    ell_push_relax_batch(dm_mid, cols_o, ws_o, stats=push_stats)
    active_mid, cand_mid, rows_mid = push_load(dm_mid, out_deg)
    relax_turns = [
        time_ms(lambda: ell_relax_batch(dmask_mid, cols, ws), reps=20),
        time_ms(lambda: ell_push_relax_batch(dm_mid, cols_o, ws_o), reps=20),
        time_ms(lambda: ell_push_relax_batch(dm_mid, cols_o, ws_o), reps=20),
        time_ms(lambda: ell_relax_batch(dmask_mid, cols, ws), reps=20),
    ]
    out_ms_r = (relax_turns[0] + relax_turns[3]) / 2
    push_ms = (relax_turns[1] + relax_turns[2]) / 2
    plain_ms_r = time_ms(
        lambda: ref.ell_relax_batch_ref(dmask_mid, cols, ws), reps=5,
        warmup=1)
    push_plain_ms = time_ms(
        lambda: ref.ell_push_relax_batch_ref(dm_mid, (cols_o, ws_o)), reps=5,
        warmup=1)
    b_r, by_r = relax_bound(dm_mid, out_deg)
    stream_b_r, _ = bound(ell_bytes + dmask_mid.numel() * 4 + LANES * n * 4,
                          2.0 * live_slots)
    log(f"relax at phase {MID_PHASE}: {active_mid} active rows "
        f"({active_mid / n:.2%} of the vertices), {cand_mid} candidates, "
        f"{push_stats[1].item()} atomics issued (the kernel's count of "
        f"candidates: {push_stats[0].item()}), out-rows "
        f"{rows_mid / 1e6:.1f} MB")
    log(f"relax at phase {MID_PHASE}, in turns (pull, push, push, pull): "
        + ", ".join(f"{t:.4f}" for t in relax_turns) + f" ms; push "
        f"{push_ms:.4f} ms, pull {out_ms_r:.4f} ms; bound (settled out-rows "
        f"+ dmask + upd) {b_r:.4f} ms ({by_r}), the pull's stream of the "
        f"whole in-ELL {stream_b_r:.4f} ms; plain push twin "
        f"{push_plain_ms:.4f} ms, plain pull twin {plain_ms_r:.4f} ms")
    # the pair that commits this phase on the main path (#1b redesigned),
    # from the phase's entry state and #2's thresholds, in turns with the
    # PR 15 push on the same phase's settle mask
    pair_args = (d_mid, s_mid, mins_mid, nf_mid, nf_mid > 0, (cols_o, ws_o),
                 out_deg, g.in_min_static)
    errs["ell_settle_commit_batch"] = max(
        errs["ell_settle_commit_batch"],
        pair_check(pair_args, {"zero": False}, f"phase {MID_PHASE}"))
    pair6 = pair_times(pair_args, {"zero": False},
                       lambda: ell_push_relax_batch(dm_mid, cols_o, ws_o),
                       f"phase {MID_PHASE}, G(10^6, 10^-4) padded B=8", smi)

    def phase_profile(graph, srcs, ell_in, ell_out, push, pull, pull_prep,
                      deg, label):
        """Every phase of the B = 8 default solve on ``graph``: its relax
        input rebuilt from two consecutive states (d before the phase where
        the phase settled: a phase sets status 2 exactly on its settle
        mask), its active rows and candidates, and one launch of the push
        and of the pull on it, timed by CUDA events in alternating order.
        Returns the densest phase's input and trip."""
        st = init_batch_state(graph, srcs, device=dev)
        act_rows, push_t, pull_t, lost = [], [], [], []
        densest, dense_cand, dense_trip = None, -1, 0
        while True:
            nxt = step_batch(graph, st, 1, ell=ell_in, ell_out=ell_out)
            if int(nxt.trips) == int(st.trips):
                break
            dm = torch.where((nxt.status == 2) & (st.status != 2), st.dist,
                             INF)
            active, cand, _ = push_load(dm, deg)
            prepped = pull_prep(dm)
            order = [("push", push, dm), ("pull", pull, prepped)]
            if len(act_rows) % 2:
                order.reverse()
            t = {}
            for nm, fn, arg in order:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(arg)
                e1.record()
                e1.synchronize()
                t[nm] = e0.elapsed_time(e1)
            act_rows.append(active)
            push_t.append(t["push"])
            pull_t.append(t["pull"])
            if t["push"] >= t["pull"]:
                lost.append((int(nxt.trips), active, t["push"], t["pull"]))
            if cand > dense_cand:
                densest, dense_cand, dense_trip = dm, cand, int(nxt.trips)
            st = nxt
        rows = np.array(act_rows)
        log(f"{label}: {len(rows)} phases; active rows per phase median "
            f"{int(np.median(rows))}, max {int(rows.max())} (phase "
            f"{int(rows.argmax()) + 1}), mean {rows.mean():.1f}; one launch "
            f"a phase: push {np.sum(push_t):.3f} ms in all (max "
            f"{np.max(push_t):.4f}), pull {np.sum(pull_t):.3f} ms in all; the "
            f"push was no faster than the pull in {len(lost)} phases"
            + (": " + "; ".join(f"phase {p} ({a} rows) {x:.4f} vs {y:.4f} ms"
                                for p, a, x, y in lost[:8]) if lost else ""))
        log(f"{label}: densest phase {dense_trip} ({dense_cand} candidates)")
        return densest, dense_trip, rows

    dense_dm, dense_trip, act_rows_g = phase_profile(
        g, src8, (cols, ws), (cols_o, ws_o),
        lambda dm: ell_push_relax_batch(dm, cols_o, ws_o),
        lambda dm: ell_relax_batch(dm, cols, ws), pad, out_deg,
        f"relax profile G(n={N}, p={P}), instatic|outstatic")
    dense_pad = pad(dense_dm)
    dense_turns = [
        time_ms(lambda: ell_relax_batch(dense_pad, cols, ws), reps=10),
        time_ms(lambda: ell_push_relax_batch(dense_dm, cols_o, ws_o), reps=10),
        time_ms(lambda: ell_push_relax_batch(dense_dm, cols_o, ws_o), reps=10),
        time_ms(lambda: ell_relax_batch(dense_pad, cols, ws), reps=10),
    ]
    d_act, d_cand, _ = push_load(dense_dm, out_deg)
    log(f"relax at the densest phase {dense_trip} ({d_act} active rows, "
        f"{d_cand} candidates), in turns (pull, push, push, pull): "
        + ", ".join(f"{t:.4f}" for t in dense_turns) + f" ms; bound "
        f"{relax_bound(dense_dm, out_deg)[0]:.4f} ms")
    del dense_dm, dense_pad
    crit_turns_mid, crit_dev_mid = crit_turns(d_mid, s_mid, keys_shared)
    out_ms_c = (crit_turns_mid[1] + crit_turns_mid[2]) / 2
    old_ms_c = (crit_turns_mid[0] + crit_turns_mid[3]) / 2
    plain_ms_c = time_ms(
        lambda: ref.frontier_crit_lanes_batch_ref(d_mid, s_mid, keys_shared),
        reps=20)
    view = dmask_mid[0].contiguous()
    view_ms = time_ms(lambda: ell_relax(view, cols, ws), reps=20)
    view_plain_ms = time_ms(lambda: ref.ell_relax_ref(view, cols, ws),
                            reps=5, warmup=1)
    dense_ms = time_ms(lambda: ell_relax_batch(dmask8, cols, ws), reps=20)
    dense_push_ms = time_ms(lambda: ell_push_relax_batch(dm8u, cols_o, ws_o),
                            reps=10)
    b_c, by_c = bound(
        d_mid.numel() * 4 + s_mid.numel() * 4 + keys_shared.numel() * 4
        + 2 * LANES * 4 + LANES * 4,
        3.0 * fringe_mid)
    b_v, _ = bound(ell_bytes + view.numel() * 4 + n * 4, 2.0 * n * d_pad)
    log(f"frontier_crit_lanes_batch at phase {MID_PHASE} (shared keys), bits "
        f"equal to the twin, in turns (two-pass body, kernel, kernel, "
        f"two-pass body): " + ", ".join(f"{t:.4f}" for t in crit_turns_mid)
        + f" ms: {out_ms_c:.4f} against {old_ms_c:.4f}; device ms a call "
        f"{crit_dev_mid[1]:.4f} against {crit_dev_mid[0]:.4f}; bound "
        f"{b_c:.4f} ms ({by_c}); plain {plain_ms_c:.4f} ms")
    log(f"ell_relax (B = 1 view, lane 0 of the timing inputs, not on the "
        f"main path): {view_ms:.4f} ms, plain {view_plain_ms:.4f} ms, bound "
        f"{b_v:.4f} ms")
    log(f"relax on the seeded parity input (a third of dmask finite, "
        f"{push_load(dm8u, out_deg)[0]} active rows): pull {dense_ms:.4f} ms, "
        f"push {dense_push_ms:.4f} ms")
    del st_mid, dmask_mid, settle_mid, d_mid, s_mid, dm8u, dm_mid, pair_args

    phase_mark("7")
    # ---- 7. the dynamic-key kernels at full width ------------------------
    spec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def gate(name, status, graph=g):
        return C.key_gate(spec[name], status, graph.in_min_static,
                          graph.out_min_static, {})

    def check(name, label, got, twin):
        got = got if isinstance(got, tuple) else (got,)
        twin = twin if isinstance(twin, tuple) else (twin,)
        torch.cuda.synchronize()
        ok = all(same_bits(a, b) for a, b in zip(got, twin))
        errs[name] = max([errs.get(name, 0.0)]
                         + [max_abs_err(a, b) for a, b in zip(got, twin)])
        log(f"parity {name} [{label}]: {'bits equal' if ok else 'DIFFER'} "
            f"(NaN out: {sum(int(torch.isnan(a).sum()) for a in got)})")
        if not ok:
            raise SystemExit(f"{name} disagrees with its twin: {label}")

    # dense seeded gates, as real key gates are: 0 on F, a slack on U
    gate8 = kops.pad_lane_batch(gate("in_full", st8))
    gate_nan = gate8.clone()
    gate_nan[3, int(cols[5, 0])] = float("nan")  # reaches row 5 of lane 3
    gate13 = kops.pad_lane_batch(gate("in_full", st13, gr))
    for label, (gt_, c, w) in {
        "gnp B=8": (gate8, cols, ws),
        "gnp B=1": (gate8[:1].contiguous(), cols, ws),
        "gnp B=3": (gate8[:3].contiguous(), cols, ws),
        "gnp B=8 NaN": (gate_nan, cols, ws),
        "grid_road D=8 B=13": (gate13, cols_r, ws_r),
    }.items():
        check("ell_key_min_batch", label, ell_key_min_batch(gt_, c, w),
              ref.ell_key_min_batch_ref(gt_, c, w))
    row4 = gate8[4].contiguous()
    check("ell_key_min_batch", "gnp 1-D view ell_key_min",
          ell_key_min(row4, cols, ws), ref.ell_key_min_ref(row4, cols, ws))
    # the status-gate table path: the "unsettled" gate read from status,
    # against its twin and against the f32 path on the same gate
    for label, (st_, c, w) in {
        "in-ELL B=8": (st8, cols, ws),
        "out-ELL B=8": (st8, cols_o, ws_o),
        "in-ELL B=1": (st1, cols, ws),
        "grid_road D=8 B=13": (st13, cols_r, ws_r),
    }.items():
        got_ = ell_key_min_status_batch(st_, c, w)
        check("ell_key_min_status_batch", label, got_,
              ref.ell_key_min_status_batch_ref(st_, c, w))
        check("ell_key_min_status_batch", label + ", against the f32 path",
              got_, ell_key_min_batch(kops.pad_lane_batch(
                  torch.where(st_ < 2, 0.0, INF)), c, w))
    del got_
    del gate_nan, gate13, row4
    g_dyn, g_weak = gate("out_dyn", st8), gate("out_weak", st8)
    for label, vecs in {"out-ELL V=1": g_dyn[None],
                        "out-ELL V=2": torch.stack([g_dyn, g_weak])}.items():
        check("ell_gather_min_batch", label,
              ell_gather_min_batch(vecs, cols_o, ws_o),
              ref.ell_gather_min_batch_ref(vecs, cols_o, ws_o))
    settle8 = (st8 == 1) & torch.from_numpy(
        rng.random((LANES, n)) < 0.3).to(dev)
    dm8 = torch.where(settle8, d8, INF)
    parts = [C.in_scan_gate_parts(spec[nm], st8, settle8, g.in_min_static[None])
             for nm in ("in_full", "in_dyn")]
    for k in (1, 2):
        ga, gb, gc = (torch.stack([p[i] for p in parts[:k]]) for i in range(3))
        label = f"in-ELL K={k}"
        if k == 2:
            ga[1, 2, min(int(cols[11, 0]), n - 1)] = float("nan")
            label += " NaN in ga"
        check("ell_relax_keys_batch", label,
              ell_relax_keys_batch(dm8, ga, gb, gc, cols, ws),
              ref.ell_relax_keys_batch_ref(dm8, ga, gb, gc, cols, ws))
    del parts, ga, gb, gc, dm8, settle8
    dga8, dgb8 = C.dep_gate_parts(spec["out_full"], st8)
    for label, (gates, dep) in {
        "out-ELL K0=1 dep_idx=0": (g_dyn[None], 0),
        "out-ELL K0=2 dep_idx=1": (torch.stack([g_weak, g_dyn]), 1),
    }.items():
        check("ell_keys_dep_batch", label,
              ell_keys_dep_batch(gates, dga8, dgb8, cols_o, ws_o, dep_idx=dep),
              ref.ell_keys_dep_batch_ref(gates, dga8, dgb8, dep, cols_o, ws_o))
    del g_dyn, g_weak, gates, dga8, dgb8

    phase_mark("8")
    # ---- 8. in|out, serving ---------------------------------------------
    rows_io, req_phases_io, launches_io, serve_io_s, steps_io, trips_io = \
        serve(StaticBackend(g, criterion="in|out", device=dev), sources)
    log(f"in|out serving: {len(rows_io)} requests answered in "
        f"{serve_io_s:.3f} s ({len(rows_io) / serve_io_s:.2f} queries/s), "
        f"{steps_io} step calls, {trips_io} trips; phases per request "
        f"{[req_phases_io[r] for r in range(REQUESTS)]}")
    log(f"in|out serving launches: {launches_io}")
    for name in ("ell_keys_dep_batch", "ell_relax_keys_batch",
                 "ell_key_min_batch", "frontier_crit_lanes_batch"):
        if launches_io[name] <= 0:
            raise SystemExit(f"the in|out path never launched {name}")
    if launches_io["ell_relax_batch"] != 0:
        raise SystemExit("the in|out path launched ell_relax_batch")

    phase_mark("9")
    # ---- 9. in|out end to end ---------------------------------------------
    io_kw = dict(ell=(cols, ws), ell_out=(cols_o, ws_o), criterion="in|out",
                 device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_io = run_phased_static_batch(g, src8, **io_kw)
    torch.cuda.synchronize()
    solve_io_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_io_p = run_phased_static_batch(g, src8, use_kernels=False, **io_kw)
    torch.cuda.synchronize()
    plain_io_s = time.perf_counter() - t0
    for field in ("dist", "status", "phases", "total_phases"):
        if not same_bits(getattr(res_io, field), getattr(res_io_p, field)):
            raise SystemExit(f"in|out kernel and plain solves differ in {field}")
    for field in ("sum_fringe", "relax_edges"):
        if not np.array_equal(getattr(res_io, field), getattr(res_io_p, field)):
            raise SystemExit(f"in|out kernel and plain solves differ in {field}")
    del res_io_p
    total_io = int(res_io.total_phases)

    def solve_io():
        return run_phased_static_batch(g, src8, **io_kw)

    walls_io = repeat_wall(solve_io, solve_io_s)
    solve_io_s = float(np.median(walls_io))
    log(f"in|out e2e: {busy_line(solve_io, solve_io_s, total_io)}")
    log(f"in|out e2e: B={LANES} solve with kernels, 3 runs "
        + ", ".join(f"{w:.3f}" for w in walls_io) + f" s, median "
        f"{solve_io_s:.3f} s "
        f"({LANES / solve_io_s:.2f} queries/s, {total_io} phases, "
        f"{solve_io_s / total_io * 1e3:.3f} ms/phase); plain twins "
        f"{plain_io_s:.3f} s; every BatchedResult field bit-equal")
    log(f"in|out e2e: phases per row {res_io.phases.tolist()} (instatic|"
        f"outstatic: {res_k.phases.tolist()}), sum_fringe "
        f"{res_io.sum_fringe.tolist()}")
    dist_io = res_io.dist.cpu().numpy()
    for i in range(LANES):
        if not np.array_equal(rows_io[i].view(np.int32),
                              dist_io[i].view(np.int32)):
            raise SystemExit(f"in|out served row {i} differs from the solve")
    log("in|out e2e: the 8 served rows equal the batch solve's rows bit for "
        "bit")
    got = dist_io[0]
    same_set = bool((np.isfinite(got) == fin).all())
    close = bool(np.allclose(got[fin], want[fin], rtol=1e-5))
    rel = np.abs(got[fin] - want[fin]) / np.maximum(want[fin], 1e-30)
    log(f"in|out scipy: row 0 same reachable set {same_set}, rtol 1e-5 "
        f"{close}, max rel err {float(rel.max()):.3e}")
    if not (same_set and close):
        raise SystemExit("in|out row 0 disagrees with scipy's Dijkstra")
    log(f"finding: in|out and instatic|outstatic dist rows bit-equal: "
        f"{np.array_equal(dist_io.view(np.int32), dist_k.view(np.int32))}")

    phase_mark("10")
    # ---- 10. insimple|outsimple at full width, DYN_TRIPS trips ------------
    st0 = init_batch_state(g, src8, criterion="insimple|outsimple", device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    st_k = step_batch(g, st0, DYN_TRIPS, ell=(cols, ws), ell_out=(cols_o, ws_o))
    torch.cuda.synchronize()
    simple_s = time.perf_counter() - t0
    launches_ss = read_counts()
    st_p = step_batch(g, st0, DYN_TRIPS, ell=(cols, ws), ell_out=(cols_o, ws_o),
                      use_kernels=False)
    for field in ("dist", "status", "trips", "phases", "sum_fringe",
                  "relax_edges", "settled_trace", "crit_keys"):
        if not same_bits(getattr(st_k, field), getattr(st_p, field)):
            raise SystemExit(f"insimple|outsimple kernel and plain states "
                             f"differ in {field}")
    if st_k.keys_valid is not st_p.keys_valid:
        raise SystemExit("insimple|outsimple keys_valid differs")
    log(f"insimple|outsimple: {int(st_k.trips)} trips in {simple_s:.3f} s "
        f"({simple_s / int(st_k.trips) * 1e3:.3f} ms/phase); every state "
        f"field bit-equal to the plain twins; launches {launches_ss}")

    def steps_simple():
        return step_batch(g, st0, DYN_TRIPS, ell=(cols, ws),
                          ell_out=(cols_o, ws_o))

    walls_ss = repeat_wall(steps_simple, simple_s)
    simple_s = float(np.median(walls_ss))
    log(f"insimple|outsimple: {DYN_TRIPS} trips, 3 runs "
        + ", ".join(f"{w:.3f}" for w in walls_ss) + f" s, median "
        f"{simple_s / DYN_TRIPS * 1e3:.3f} ms/phase; "
        f"{busy_line(steps_simple, simple_s, DYN_TRIPS)}")
    if launches_ss["ell_key_min_status_batch"] <= 0:
        raise SystemExit("insimple|outsimple never launched "
                         "ell_key_min_status_batch (its out-scan and "
                         "priming read the unsettled gate from status)")
    del st0, st_k, st_p

    phase_mark("11")
    # ---- 11. key kernels' times on one real phase of the in|out solve -----
    st_io = init_batch_state(g, src8, criterion="in|out", device=dev)
    st_io = step_batch(g, st_io, total_io // 2, ell=(cols, ws),
                       ell_out=(cols_o, ws_o))
    d_io, s_io = st_io.dist, st_io.status
    g_od = gate("out_dyn", s_io)[None]  # the out-scan's independent gate
    dga_io, dgb_io = C.dep_gate_parts(spec["out_full"], s_io)
    keys_io = ell_keys_dep_batch(g_od, dga_io, dgb_io, cols_o, ws_o)
    thr_keys = keys_io[1][None].contiguous()  # per-lane out_full lanes
    mins_io, nf_io = frontier_crit_lanes_batch(d_io, s_io, thr_keys)
    settle_io = C.plan_union_mask(
        st_io.plan, d_io, s_io == 1, mins_io,
        {"in_full": st_io.crit_keys[0], "out_dyn": keys_io[0],
         "out_full": keys_io[1]}, g.in_min_static, None)
    dmask_io = torch.where(settle_io, d_io, INF)
    ga_io, gb_io, gc_io = (p[None].contiguous() for p in C.in_scan_gate_parts(
        spec["in_full"], s_io, settle_io, g.in_min_static[None]))
    gate_io = kops.pad_lane_batch(gate("in_full", s_io))
    upd_io, _ = ell_relax_keys_batch(dmask_io, ga_io, gb_io, gc_io, cols, ws)
    fin_io = torch.where(upd_io < INF, 0.0, INF)
    gate1_io = torch.minimum(ga_io[0], torch.minimum(gb_io[0], gc_io[0] + fin_io))
    cl_in, cl_out = cols.long(), cols_o.long()
    pad = kops.pad_lane_batch
    fs_km = finite_slots(gate_io, cl_in)
    fs_ga = finite_slots(pad(g_od[0]), cl_out)
    fs_rk = finite_slots(pad(dmask_io), cl_in) + finite_slots(pad(gate1_io),
                                                              cl_in)
    dep_gate = torch.minimum(dga_io, dgb_io + keys_io[0])
    fs_kd = fs_ga + finite_slots(pad(dep_gate), cl_out)
    del cl_in, cl_out, fin_io, upd_io
    log(f"key timing inputs: phase {int(st_io.trips)} of the in|out B="
        f"{LANES} solve: {int(settle_io.sum())} settled, {int(nf_io.sum())} "
        f"on the fringe; finite lane-slots: key_min {fs_km}, gather "
        f"{fs_ga}, relax_keys {fs_rk}, keys_dep {fs_kd}")
    bn = LANES * n * 4  # bytes of one (B, n) f32 vector
    timed = {
        "ell_key_min_batch": (
            lambda: ell_key_min_batch(gate_io, cols, ws),
            lambda: ref.ell_key_min_batch_ref(gate_io, cols, ws),
            bound(ell_bytes + gate_io.numel() * 4 + bn, 2.0 * fs_km)),
        "ell_gather_min_batch": (
            lambda: ell_gather_min_batch(g_od, cols_o, ws_o),
            lambda: ref.ell_gather_min_batch_ref(g_od, cols_o, ws_o),
            bound(ell_out_bytes + 2 * bn, 2.0 * fs_ga)),
        "ell_relax_keys_batch": (
            lambda: ell_relax_keys_batch(dmask_io, ga_io, gb_io, gc_io, cols,
                                         ws),
            lambda: ref.ell_relax_keys_batch_ref(dmask_io, ga_io, gb_io,
                                                 gc_io, cols, ws),
            bound(ell_bytes + 6 * bn, 2.0 * fs_rk)),
        "ell_keys_dep_batch": (
            lambda: ell_keys_dep_batch(g_od, dga_io, dgb_io, cols_o, ws_o),
            lambda: ref.ell_keys_dep_batch_ref(g_od, dga_io, dgb_io, 0,
                                               cols_o, ws_o),
            bound(ell_out_bytes + 5 * bn, 2.0 * fs_kd)),
    }
    # #5 and #6 on the pipelined body, in turns with the single-sweep body
    # they ran on before (the same C entry point, asked for that body), both
    # bit-checked against the twin on these inputs first
    lib_g = erk.library()

    def single_sweep(vecs, n_src, c, w, out):
        lanes = vecs.numel() // n_src
        packed = erk.packed_scratch(lanes, n + 1, dev)
        erk.launch("single sweep", "ell_gather_min_launch", dev,
                   vecs.data_ptr(), n_src, n + 1, lanes, c.data_ptr(),
                   w.data_ptr(), c.shape[0], c.shape[1],
                   relax_threads_per_row(c.shape[1]), RELAX_THREADS,
                   packed.data_ptr(), None, out.data_ptr(), lib=lib_g)
        return out

    old_out = {"ell_key_min_batch": torch.empty((LANES, n), device=dev),
               "ell_gather_min_batch": torch.empty((1, LANES, n), device=dev)}
    single = {
        "ell_key_min_batch": lambda: single_sweep(
            gate_io, n + 1, cols, ws, old_out["ell_key_min_batch"]),
        "ell_gather_min_batch": lambda: single_sweep(
            g_od, n, cols_o, ws_o, old_out["ell_gather_min_batch"]),
    }
    times, single_ms = {}, {}
    for name, (kern, plain, (b_ms, b_by)) in timed.items():
        if name in single:
            want_ = plain()
            check(name, f"in|out phase {int(st_io.trips)} inputs", kern(),
                  want_)
            check(name, f"in|out phase {int(st_io.trips)} inputs, the "
                  "single-sweep body", single[name](), want_)
            del want_
            turns = [time_ms(single[name], reps=20), time_ms(kern, reps=20),
                     time_ms(kern, reps=20), time_ms(single[name], reps=20)]
            single_ms[name] = (turns[0] + turns[3]) / 2
            times[name] = ((turns[1] + turns[2]) / 2,
                           time_ms(plain, reps=3, warmup=1), b_ms, b_by)
            log(f"{name}: in turns (single-sweep body, pipelined, "
                f"pipelined, single-sweep body) "
                + ", ".join(f"{t:.4f}" for t in turns) + f" ms: "
                f"{times[name][0]:.4f} against {single_ms[name]:.4f} "
                f"({times[name][0] / single_ms[name]:.2f}x); plain "
                f"{times[name][1]:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
                f"device ms a call by kernel: " + "; ".join(
                    f"{k} {t:.4f}" for k, t in device_split(kern)))
            continue
        times[name] = (time_ms(kern, reps=20), time_ms(plain, reps=3, warmup=1),
                       b_ms, b_by)
        log(f"{name}: {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    # (b), the status-gate table, against (a), the f32 path, on the
    # "unsettled" gates of the same phase (out_dyn over the out-ELL: the
    # insimple|outsimple out-scan, #6's role; in_dyn over the in-ELL: its
    # priming, #5's role), in turns with the single-sweep body too
    g_in_dyn = pad(gate("in_dyn", s_io))
    status_turns = {}
    for label, c, w, f32, old in (
            ("out-ELL", cols_o, ws_o,
             lambda: ell_gather_min_batch(g_od, cols_o, ws_o)[0],
             lambda: single[
                 "ell_gather_min_batch"]()[0]),
            ("in-ELL", cols, ws,
             lambda: ell_key_min_batch(g_in_dyn, cols, ws),
             lambda: single_sweep(g_in_dyn, n + 1, cols, ws,
                                  old_out["ell_key_min_batch"]))):
        def bits(c=c, w=w):
            return ell_key_min_status_batch(s_io, c, w)

        want_ = ref.ell_key_min_status_batch_ref(s_io, c, w)
        for tag, fn in (("", bits), (", the f32 path", f32),
                        (", the single-sweep body", old)):
            check("ell_key_min_status_batch",
                  f"in|out phase {int(st_io.trips)} {label}{tag}", fn(),
                  want_)
        del want_
        turns = [time_ms(fn, reps=20) for fn in (old, f32, bits, bits, f32,
                                                 old)]
        status_turns[label] = ((turns[2] + turns[3]) / 2,
                               (turns[1] + turns[4]) / 2,
                               (turns[0] + turns[5]) / 2)
        log(f"ell_key_min_status_batch {label}: in turns (single-sweep "
            f"body, f32 pipelined, status table, status table, f32 "
            f"pipelined, single-sweep body) " + ", ".join(
                f"{t:.4f}" for t in turns) + " ms: status table "
            f"{status_turns[label][0]:.4f} against f32 "
            f"{status_turns[label][1]:.4f} and the single-sweep body "
            f"{status_turns[label][2]:.4f}; device ms a call by kernel: "
            + "; ".join(f"{k} {t:.4f}" for k, t in device_split(bits)))
    status_plain_ms = time_ms(
        lambda: ref.ell_key_min_status_batch_ref(s_io, cols_o, ws_o), reps=3,
        warmup=1)
    del old_out, single, g_in_dyn
    # The split of the two fused scans into their sweeps, each timed alone
    # on the single-sweep kernels (the fused scans' earlier body): the
    # stream floor (an all-+inf dmask, every gather skipped), #7's sparse
    # relax sweep and dense gate sweep, #8's two dense gate sweeps.
    inf_mask = torch.full_like(pad(dmask_io), INF)
    split = {
        "stream floor (in-ELL, every gather skipped)":
            lambda: ell_relax_batch(inf_mask, cols, ws),
        "sparse sweep (#7 sweep 0, the relax dmask)":
            lambda: ell_relax_batch(pad(dmask_io), cols, ws),
        "dense sweep (#7 sweep 1, the in_full gate)":
            lambda: ell_gather_min_batch(gate1_io[None], cols, ws),
        "dense sweep (#8 sweep 0, the out_dyn gate)":
            lambda: ell_gather_min_batch(g_od, cols_o, ws_o),
        "dense sweep (#8 sweep 1, the out_full gate)":
            lambda: ell_gather_min_batch(dep_gate[None], cols_o, ws_o),
    }
    split_ms = {label: time_ms(fn, reps=20) for label, fn in split.items()}
    for label, ms in split_ms.items():
        log(f"split: {label}: {ms:.4f} ms (single-sweep kernel)")
    sweeps = list(split_ms.values())
    single_sweeps = {"ell_relax_keys_batch": sweeps[1] + sweeps[2],
                   "ell_keys_dep_batch": sweeps[3] + sweeps[4]}
    for name, ms in single_sweeps.items():
        log(f"split: {name} {times[name][0]:.4f} ms against its two sweeps "
            f"alone on the single-sweep body {ms:.4f} ms; two reads of the "
            f"adjacency bound it at {2 * times[name][2]:.4f} ms")
        log(f"split: {name} device ms a call by kernel: "
            + "; ".join(f"{k} {t:.4f}" for k, t in
                        device_split(timed[name][0])))
    del inf_mask, gate1_io, dep_gate
    row_io = gate_io[0].contiguous()
    km_view_ms = time_ms(lambda: ell_key_min(row_io, cols, ws), reps=20)
    km_view_plain_ms = time_ms(lambda: ref.ell_key_min_ref(row_io, cols, ws),
                               reps=3, warmup=1)
    b_kv, by_kv = bound(ell_bytes + row_io.numel() * 4 + n * 4,
                        2.0 * finite_slots(row_io[None], cols.long()))
    log(f"ell_key_min (B = 1 view, lane 0 of the key timing inputs, not on "
        f"the main path): {km_view_ms:.4f} ms, plain {km_view_plain_ms:.4f} "
        f"ms, bound {b_kv:.4f} ms ({by_kv})")
    crit_turns_io, crit_dev_io = crit_turns(d_io, s_io, thr_keys)
    pl_ms = (crit_turns_io[1] + crit_turns_io[2]) / 2
    pl_old_ms = (crit_turns_io[0] + crit_turns_io[3]) / 2
    b_pl, by_pl = bound(d_io.numel() * 4 + s_io.numel() * 4
                        + thr_keys.numel() * 4 + 3 * LANES * 4,
                        3.0 * int(nf_io.sum()))
    log(f"frontier_crit_lanes_batch with per-lane (1, B, n) keys on the same "
        f"inputs, bits equal to the twin, in turns (two-pass body, kernel, "
        f"kernel, two-pass body): " + ", ".join(f"{t:.4f}" for t in
                                               crit_turns_io)
        + f" ms: {pl_ms:.4f} against {pl_old_ms:.4f}; device ms a call "
        f"{crit_dev_io[1]:.4f} against {crit_dev_io[0]:.4f}; bound "
        f"{b_pl:.4f} ms ({by_pl})")
    del st_io, d_io, s_io, g_od, dga_io, dgb_io, keys_io, thr_keys, mins_io
    del settle_io, dmask_io, ga_io, gb_io, gc_io, gate_io, row_io

    phase_mark("12")
    # ---- 12. the skewed graph and its sliced views -------------------------
    t0 = time.perf_counter()
    gk = from_coo(*coo_k, device=dev)  # kronecker(KRON_K, device=dev)
    del coo_k
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sl_in, sl_out = to_ell_in_sliced(gk), to_ell_out_sliced(gk)
    torch.cuda.synchronize()
    log(f"kronecker({KRON_K}) seed {SEED}: n={gk.n}, m={gk.num_real_edges} "
        f"arcs, drawn on the host beside the build and phase 29 (waited "
        f"{kron_wait_s:.1f} s for it before phase 2), on the card in "
        f"{gen_s:.1f} s, views built in "
        f"{time.perf_counter() - t0:.1f} s")
    for side, view, real_to in (("in", sl_in, gk.dst), ("out", sl_out, gk.src)):
        deg = torch.bincount(real_to[torch.isfinite(gk.w)].long(),
                             minlength=gk.n)
        d_max = int(deg.max())
        padded_bytes = gk.n * (-(-d_max // 8) * 8) * 8
        log(f"  {side}-view: widths {view.widths}, rows per bucket "
            f"{[int(s.rows.shape[0]) for s in view.slices]}, padded slots "
            f"{view.padded_slots} ({view.padded_slots * 8 / 1e9:.3f} GB), "
            f"C={view.merge_idx.shape[1]} (merge_idx "
            f"{view.merge_idx.numel() * 4 / 1e9:.3f} GB, compact form "
            f"{(view.merge_ptr.numel() * 8 + view.merge_pos.numel() * 4) / 1e9:.3f}"
            f" GB); {int((deg == 0).sum())} vertices of degree 0, max degree "
            f"{d_max}: the padded layout would need {padded_bytes:.3e} bytes")
    sl_bytes = sl_in.padded_slots * 8
    sl_out_bytes = sl_out.padded_slots * 8

    def merge_bytes(view):
        return view.merge_ptr.numel() * 8 + view.merge_pos.numel() * 4

    def sliced_finite(vecs, view):
        """Finite lane-slots of a (lanes, n) vector over every bucket."""
        padded = kops.pad_lane_batch(vecs.reshape(-1, vecs.shape[-1]))
        return sum(finite_slots(padded, s.cols.long()) for s in view.slices)

    phase_mark("13")
    # ---- 13. sliced kernel parity at full width -----------------------------
    nk = gk.n
    rng = np.random.default_rng(13)
    dk, stk = seeded_state(rng, LANES, nk, dev)
    settle_k = (stk == 1) & torch.from_numpy(rng.random((LANES, nk)) < 0.01).to(dev)
    dmask_k = torch.where(settle_k, dk, INF)[None].contiguous()
    dmask_k_nan = dmask_k.clone()
    dmask_k_nan[0, 3, min(int(sl_in.slices[-1].cols[0, 0]), nk - 1)] = \
        float("nan")
    kspec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def kgate(name, status):
        return C.key_gate(kspec[name], status, gk.in_min_static,
                          gk.out_min_static, {})

    k_dyn, k_weak = kgate("out_dyn", stk), kgate("out_weak", stk)
    for label, (vecs, view, sparse) in {
        "in-view sparse dmask (skip on)": (dmask_k, sl_in, True),
        "in-view sparse dmask NaN (skip on)": (dmask_k_nan, sl_in, True),
        "out-view dense V=2 gates": (torch.stack([k_dyn, k_weak]), sl_out,
                                     False),
    }.items():
        check("ell_sliced_gather_min_batch", label,
              ell_sliced_gather_min_batch(vecs, view, sparse=sparse),
              ref.ell_sliced_gather_min_batch_ref(vecs, view))
    del dmask_k_nan
    out_deg_k = out_degrees(gk)
    for label, dm in {
        "out-view B=8 sparse dmask": dmask_k[0],
        "out-view B=1 NaN lane": seeded_push_dmask(prng, 1, nk, 0.01, dev),
        "out-view B=8 NaN lanes": seeded_push_dmask(prng, 8, nk, 0.01, dev),
        "out-view B=13 NaN lanes": seeded_push_dmask(prng, 13, nk, 0.003,
                                                     dev),
        "out-view B=40 NaN lanes": seeded_push_dmask(prng, 40, nk, 0.001,
                                                     dev),
    }.items():
        check_push("ell_sliced_push_relax_batch", label, dm, sl_out,
                   ell_sliced_gather_min_batch(dm[None], sl_in,
                                               sparse=True)[0], out_deg_k)
    # the pair (#9b redesigned) along the sliced out-view: #2's thresholds
    # for the default plan on the seeded state, and with the OUT lane at
    # +inf (a third of the slots settle, the hubs' rows among them), B = 8
    # and B = 40 (two lane tiles) with target lanes
    vrows_k = vertex_row_table(gk, sl_out)
    mins_k, nf_k = frontier_crit_lanes_batch(dk, stk,
                                             gk.out_min_static[None])
    mins_k_all = mins_k.clone()
    mins_k_all[1] = INF
    d40, st40 = seeded_state(rng, 40, nk, dev)
    mins40, nf40 = frontier_crit_lanes_batch(d40, st40,
                                             gk.out_min_static[None])
    tg40 = torch.from_numpy(np.where(np.arange(40) % 3 == 0,
                                     rng.integers(0, nk, 40), -1).astype(
                                         np.int32)).to(dev)
    for label, (pargs, pkw) in {
        "out-view B=8, #2's thresholds": (
            (dk, stk, mins_k, nf_k, nf_k > 0, sl_out, out_deg_k,
             gk.in_min_static), {"zero": False, "vrows": vrows_k}),
        "out-view B=8, the OUT lane +inf (a third settle)": (
            (dk, stk, mins_k_all, nf_k, nf_k > 0, sl_out, out_deg_k,
             gk.in_min_static), {"zero": False, "vrows": vrows_k}),
        "out-view B=40, targets, telemetry": (
            (d40, st40, mins40, nf40, nf40 > 0, sl_out, out_deg_k,
             gk.in_min_static),
            {"zero": False, "vrows": vrows_k, "target": tg40,
             "telemetry": True}),
    }.items():
        errs["ell_sliced_settle_commit_batch"] = max(
            errs.get("ell_sliced_settle_commit_batch", 0.0),
            pair_check(pargs, pkw, label))
    del mins_k_all, d40, st40, mins40, nf40, tg40
    kparts = [C.in_scan_gate_parts(kspec[nm], stk, settle_k,
                                   gk.in_min_static[None])
              for nm in ("in_full", "in_dyn")]
    for k in (1, 2):
        ga, gb, gc = (torch.stack([p[i] for p in kparts[:k]]) for i in range(3))
        label = f"in-view K={k}"
        if k == 2:
            ga[1, 2, min(int(sl_in.slices[0].cols[0, 0]), nk - 1)] = \
                float("nan")
            label += " NaN in ga"
        twin = ref.ell_sliced_relax_keys_batch_ref(dmask_k[0], ga, gb, gc,
                                                   sl_in)
        check("ell_sliced_relax_keys_batch", label,
              ell_sliced_relax_keys_batch(dmask_k[0], ga, gb, gc, sl_in),
              twin)
        check(PUSH_IN_SCAN, label + ", push sweep",
              ell_sliced_relax_keys_batch(dmask_k[0], ga, gb, gc, sl_in,
                                          out_view=sl_out), twin)
    for b_ in (1, 13):  # other lane tiles: one lane, and 8 + 5
        dm_ = seeded_push_dmask(prng, b_, nk, 0.01, dev)
        st_ = stk[:1].expand(b_, -1).contiguous()
        parts_ = [p[None].contiguous() for p in C.in_scan_gate_parts(
            kspec["in_full"], st_, (dm_ != INF) & (st_ == 1),
            gk.in_min_static[None])]
        twin = ref.ell_sliced_relax_keys_batch_ref(dm_, *parts_, sl_in)
        for name, ov in (("ell_sliced_relax_keys_batch", None),
                         (PUSH_IN_SCAN, sl_out)):
            check(name, f"in-view B={b_} K=1 NaN lanes",
                  ell_sliced_relax_keys_batch(dm_, *parts_, sl_in,
                                              out_view=ov), twin)
    del kparts, ga, gb, gc, dm_, st_, parts_, twin
    kdga, kdgb = C.dep_gate_parts(kspec["out_full"], stk)
    kdga_nan = kdga.clone()
    kdga_nan[4, min(int(sl_out.slices[0].cols[0, 0]), nk - 1)] = float("nan")
    for label, (gates, dep, dga_) in {
        "out-view K0=1 dep_idx=0": (k_dyn[None], 0, kdga),
        "out-view K0=2 dep_idx=1": (torch.stack([k_weak, k_dyn]), 1, kdga),
        "out-view K0=2 dep_idx=0 NaN in dga": (torch.stack([k_dyn, k_weak]), 0,
                                               kdga_nan),
    }.items():
        check("ell_sliced_keys_dep_batch", label,
              ell_sliced_keys_dep_batch(gates, dga_, kdgb, sl_out, dep_idx=dep),
              ref.ell_sliced_keys_dep_batch_ref(gates, dga_, kdgb, dep, sl_out))
    del dk, stk, settle_k, dmask_k, k_dyn, k_weak, kdga, kdgb, kdga_nan, gates

    # signed zeros at full width: every kernel against its twin where -0 and
    # +0 tie (XLA's min, and so the reference, takes -0 in either order).
    # Both graphs' views with their weights mapped onto {+0, -0, 0.5, 1} by
    # value, vectors drawn from the same set with +inf and NaN lanes; the
    # pushes also against the pulls over the same edges. A case whose twin
    # holds no zero of either sign tests nothing and fails.
    zrng = np.random.default_rng(16)

    def zcheck(name, label, got, twin):
        zeros = [(t == 0) & torch.signbit(t) for t in
                 (twin if isinstance(twin, tuple) else (twin,))]
        if not (any(bool(z.any()) for z in zeros) and any(
                bool(((t == 0) & ~torch.signbit(t)).any()) for t in
                (twin if isinstance(twin, tuple) else (twin,)))):
            raise SystemExit(f"signed-zero case {name} [{label}] met no tie")
        check(name, f"signed zeros, {label}", got, twin)

    def zsliced(view):
        return sliced_ell([EllSlice(sl.rows, sl.cols, signed_weights(sl.ws))
                           for sl in view.slices], view.merge_idx)

    zin, zout = (cols, signed_weights(ws)), (cols_o, signed_weights(ws_o))
    zb = LANES // 2  # the twins of the K = 2 scans gather (2, B, n, D)
    zd = signed_vec(zrng, (zb, n), dev, inf_frac=0.6)
    zst = torch.from_numpy(zrng.integers(0, 3, (zb, n)).astype(
        np.int32)).to(dev)
    zv = signed_vec(zrng, (2, zb, n), dev)
    zp = [signed_vec(zrng, (2, zb, n), dev, nan=i == 0) for i in range(3)]
    zpull = ell_relax_batch(pad(zd), *zin)
    zcheck("ell_relax_batch", "G(1e6) in-ELL", zpull,
           ref.ell_relax_batch_ref(pad(zd), *zin))
    zcheck("ell_push_relax_batch", "G(1e6) out-ELL",
           ell_push_relax_batch(zd, *zout),
           ref.ell_push_relax_batch_ref(zd, zout))
    if not same_bits(ell_push_relax_batch(zd, *zout), zpull):
        raise SystemExit("the push and the pull differ on signed zeros")
    # lane 0 keeps its -0s, the others hold only +0s: both are some min
    zdc = torch.cat([zd[:1], zd[1:].abs()])
    zkc = torch.cat([zv[:, :1], zv[:, 1:].abs()], dim=1)
    zcheck("frontier_crit_lanes_batch", "per-lane K=2 keys",
           frontier_crit_lanes_batch(zdc, zst, zkc),
           ref.frontier_crit_lanes_batch_ref(zdc, zst, zkc))
    zcheck("ell_key_min_batch", "G(1e6) in-ELL",
           ell_key_min_batch(pad(zv[0]), *zin),
           ref.ell_key_min_batch_ref(pad(zv[0]), *zin))
    zcheck("ell_gather_min_batch", "G(1e6) out-ELL V=2",
           ell_gather_min_batch(zv, *zout),
           ref.ell_gather_min_batch_ref(zv, *zout))
    # an unsettled gate is +0 or +inf, and +0 + -0 is +0: these keys hold
    # no -0, so no tie to meet; the -0 weights still go through the add
    for label, view in (("in-ELL", zin), ("out-ELL", zout)):
        check("ell_key_min_status_batch", f"signed-zero weights, G(1e6) "
              f"{label}", ell_key_min_status_batch(zst, *view),
              ref.ell_key_min_status_batch_ref(zst, *view))
    zcheck("ell_relax_keys_batch", "G(1e6) in-ELL K=2",
           ell_relax_keys_batch(zd, *zp, *zin),
           ref.ell_relax_keys_batch_ref(zd, *zp, *zin))
    zcheck("ell_keys_dep_batch", "G(1e6) out-ELL K0=2 dep_idx=1",
           ell_keys_dep_batch(zv, zp[0][0], zp[1][0], *zout, dep_idx=1),
           ref.ell_keys_dep_batch_ref(zv, zp[0][0], zp[1][0], 1, *zout))
    del zin, zout, zd, zst, zv, zp, zpull, zdc, zkc
    zs_in, zs_out = zsliced(sl_in), zsliced(sl_out)
    zd = signed_vec(zrng, (zb, nk), dev, inf_frac=0.9)
    zv = signed_vec(zrng, (2, zb, nk), dev)
    zp = [signed_vec(zrng, (2, zb, nk), dev, nan=i == 0) for i in range(3)]
    zpull = ell_sliced_gather_min_batch(zd[None], zs_in, sparse=True)[0]
    zcheck("ell_sliced_gather_min_batch", "kronecker in-view sparse",
           zpull, ref.ell_sliced_gather_min_batch_ref(zd[None], zs_in)[0])
    zcheck("ell_sliced_gather_min_batch", "kronecker out-view V=2",
           ell_sliced_gather_min_batch(zv, zs_out),
           ref.ell_sliced_gather_min_batch_ref(zv, zs_out))
    zpush = ell_sliced_push_relax_batch(zd, zs_out)
    zcheck("ell_sliced_push_relax_batch", "kronecker out-view", zpush,
           ref.ell_push_relax_batch_ref(zd, zs_out))
    if not same_bits(zpush, zpull):
        raise SystemExit("the sliced push and pull differ on signed zeros")
    ztwin = ref.ell_sliced_relax_keys_batch_ref(zd, *zp, zs_in)
    zcheck("ell_sliced_relax_keys_batch", "kronecker in-view K=2",
           ell_sliced_relax_keys_batch(zd, *zp, zs_in), ztwin)
    zcheck(PUSH_IN_SCAN, "kronecker in-view K=2, push sweep",
           ell_sliced_relax_keys_batch(zd, *zp, zs_in, out_view=zs_out),
           ztwin)
    zcheck("ell_sliced_keys_dep_batch", "kronecker out-view K0=2 dep_idx=1",
           ell_sliced_keys_dep_batch(zv, zp[0][0], zp[1][0], zs_out,
                                     dep_idx=1),
           ref.ell_sliced_keys_dep_batch_ref(zv, zp[0][0], zp[1][0], 1,
                                             zs_out))
    del zs_in, zs_out, zd, zv, zp, zpull, zpush, ztwin

    phase_mark("14")
    # ---- 14. sliced serving on the skewed graph ----------------------------
    has_out = torch.nonzero(out_degrees(gk) >= 1).squeeze(1).cpu().numpy()
    src_k = np.random.default_rng(2).choice(has_out, REQUESTS)
    padded_gathers = ("ell_relax_batch", "ell_key_min_batch",
                      "ell_key_min_status_batch", "ell_gather_min_batch", "ell_relax_keys_batch",
                      "ell_keys_dep_batch", "ell_push_relax_batch",
                      "ell_delta_push_batch", "ell_settle_push_batch",
                      "ell_delta_settle_push_batch")
    served_k, sliced_serve = {}, {}
    # the default plan commits through the pair along the sliced out-view
    # and runs no sliced gather and no PR 15 push; in|out relaxes in the
    # fused in-scan, whose relax sweep is the push along the out-view it
    # holds (#10b), and runs no other push
    for crit, must, never in (
            ("instatic|outstatic", PAIR["sliced"],
             ("ell_sliced_gather_min_batch", "ell_sliced_relax_keys_batch",
              PUSH_IN_SCAN, "ell_sliced_keys_dep_batch",
              "ell_sliced_push_relax_batch")),
            ("in|out", ("ell_sliced_gather_min_batch", PUSH_IN_SCAN,
                        "ell_sliced_keys_dep_batch"),
             ("ell_sliced_push_relax_batch", "ell_sliced_relax_keys_batch",
              *PAIR["sliced"]))):
        rows_s, ph_s, l_s, s_s, steps_s, trips_s = serve(
            StaticBackend(gk, criterion=crit, layout="sliced", device=dev),
            src_k)
        served_k[crit] = rows_s
        sliced_serve[crit] = (l_s, s_s, ph_s)
        log(f"sliced serving {crit} on kronecker({KRON_K}): {REQUESTS} "
            f"requests in {s_s:.3f} s ({REQUESTS / s_s:.2f} queries/s), "
            f"{steps_s} step calls, {trips_s} trips; phases per request "
            f"{[ph_s[r] for r in range(REQUESTS)]}")
        log(f"sliced serving {crit} launches: {l_s}")
        for name in must + ("frontier_crit_lanes_batch",):
            if l_s[name] <= 0:
                raise SystemExit(f"sliced {crit} serving never launched {name}")
        if any(l_s[name] for name in padded_gathers):
            raise SystemExit(f"sliced {crit} serving launched a padded kernel")
        if any(l_s[name] for name in never):
            raise SystemExit(f"sliced {crit} serving launched one of {never}")

    phase_mark("15")
    # ---- 15. end-to-end parity on the sliced layout -------------------------
    src8_k = src_k[:LANES]
    real_k = torch.isfinite(gk.w)
    ek_src, ek_dst, ek_w = gk.src[real_k], gk.dst[real_k], gk.w[real_k]
    order_k = torch.sort(ek_src.long(), stable=True).indices
    indptr_k = torch.zeros(gk.n + 1, dtype=torch.int64, device=dev)
    indptr_k[1:] = torch.cumsum(torch.bincount(ek_src.long(), minlength=gk.n), 0)
    csr_k = sp.csr_matrix(
        (ek_w[order_k].double().cpu().numpy(), ek_dst[order_k].cpu().numpy(),
         indptr_k.cpu().numpy()), shape=(gk.n, gk.n))
    del real_k, ek_src, ek_dst, ek_w, order_k, indptr_k
    t0 = time.perf_counter()
    want_k = dijkstra(csr_k, directed=True, indices=int(src8_k[0]))
    scipy_k_s = time.perf_counter() - t0
    del csr_k
    fin_k = np.isfinite(want_k)
    sliced_solve = {}
    for crit in ("instatic|outstatic", "in|out"):
        kw = dict(criterion=crit, layout="sliced", device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_s = run_phased_static_batch(gk, src8_k, **kw)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_sp = run_phased_static_batch(gk, src8_k, use_kernels=False, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_s, field), getattr(res_sp, field)):
                raise SystemExit(f"sliced {crit} kernel and plain solves "
                                 f"differ in {field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_s, field), getattr(res_sp, field)):
                raise SystemExit(f"sliced {crit} kernel and plain solves "
                                 f"differ in {field}")
        del res_sp
        dist_s = res_s.dist.cpu().numpy()
        for i in range(LANES):
            if not np.array_equal(served_k[crit][i].view(np.int32),
                                  dist_s[i].view(np.int32)):
                raise SystemExit(f"sliced {crit} served row {i} differs from "
                                 "the solve")
        got = dist_s[0]
        same_set = bool((np.isfinite(got) == fin_k).all())
        close = bool(np.allclose(got[fin_k], want_k[fin_k], rtol=1e-5))
        rel = np.abs(got[fin_k] - want_k[fin_k]) / np.maximum(want_k[fin_k],
                                                              1e-30)
        total_s = int(res_s.total_phases)

        def solve_sliced(kw=kw):
            return run_phased_static_batch(gk, src8_k, **kw)

        walls_s = repeat_wall(solve_sliced, solve_s)
        solve_s = float(np.median(walls_s))
        sliced_solve[crit] = (solve_s, total_s, res_s.phases.tolist())
        log(f"sliced e2e {crit}: "
            f"{busy_line(solve_sliced, solve_s, total_s)}")
        log(f"sliced e2e {crit} on kronecker({KRON_K}): B={LANES} solve with "
            f"kernels, 3 runs " + ", ".join(f"{w:.3f}" for w in walls_s)
            + f" s, median {solve_s:.3f} s ({LANES / solve_s:.2f} queries/s, "
            f"{total_s} phases, {solve_s / total_s * 1e3:.3f} ms/phase; phases "
            f"per row {res_s.phases.tolist()}); plain twins {plain_s:.3f} s; "
            f"every BatchedResult field bit-equal; the 8 served rows equal")
        log(f"sliced e2e {crit} scipy: row 0 (source {int(src8_k[0])}) "
            f"reachable {int(fin_k.sum())}, same reachable set {same_set}, "
            f"rtol 1e-5 {close}, max rel err {float(rel.max()):.3e} (scipy "
            f"{scipy_k_s:.1f} s)")
        if not (same_set and close):
            raise SystemExit(f"sliced {crit} row 0 disagrees with scipy")
        if crit == "instatic|outstatic":
            st_k16 = init_batch_state(gk, src8_k, device=dev)
            st_k16 = step_batch(gk, st_k16, total_s // 2, ell=sl_in)
        del res_s
    for crit, padded_res in (("instatic|outstatic", res_k), ("in|out", res_io)):
        res_g = run_phased_static_batch(g, src8, criterion=crit,
                                        layout="sliced", device=dev)
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_g, field), getattr(padded_res, field)):
                raise SystemExit(f"gnp sliced {crit} differs from padded in "
                                 f"{field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_g, field),
                                  getattr(padded_res, field)):
                raise SystemExit(f"gnp sliced {crit} differs from padded in "
                                 f"{field}")
        del res_g
    # the carried keys too: the in|out kernel and plain states a quarter of
    # the way (the plain steps are the slow part), then the kernel state on
    # to half way, phase 16's timing inputs (a resumed stepper is the same
    # state as one call)
    st0 = init_batch_state(gk, src8_k, criterion="in|out", device=dev)
    half_io = sliced_solve["in|out"][1] // 2
    quarter_io = half_io // 2
    t0 = time.perf_counter()
    st_kio = step_batch(gk, st0, quarter_io, ell=sl_in, ell_out=sl_out)
    st_pio = step_batch(gk, st0, quarter_io, ell=sl_in, ell_out=sl_out,
                        use_kernels=False)
    for field in ("dist", "status", "trips", "phases", "sum_fringe",
                  "relax_edges", "crit_keys"):
        if not same_bits(getattr(st_kio, field), getattr(st_pio, field)):
            raise SystemExit(f"sliced in|out kernel and plain states differ "
                             f"in {field} after {quarter_io} phases")
    if st_kio.keys_valid is not st_pio.keys_valid:
        raise SystemExit("sliced in|out keys_valid differs")
    log(f"sliced e2e in|out: after {quarter_io} phases the kernel and plain "
        f"states are bit-equal on every field, crit_keys included "
        f"({time.perf_counter() - t0:.1f} s)")
    st_kio = step_batch(gk, st_kio, half_io - quarter_io, ell=sl_in,
                        ell_out=sl_out)
    del st0, st_pio
    sl_g = to_ell_in_sliced(g)
    log(f"sliced e2e on G(n={N}, p={P}): in-view widths {sl_g.widths}, "
        f"C={sl_g.merge_idx.shape[1]}, {sl_g.padded_slots * 8 / 1e9:.3f} GB "
        f"of slots; layout='sliced' bit-equal to the padded solve on every "
        f"field, instatic|outstatic and in|out")
    del sl_g

    phase_mark("16")
    # ---- 16. sliced kernel times on one real phase --------------------------
    # relax sweep: the settle mask of phase total // 2 of the B = 8
    # instatic|outstatic solve; fused scans: phase total // 2 of in|out
    dm16, st16 = st_k16.dist, st_k16.status
    mins16, nf16 = kops.crit_thresholds_batch(dm16, st16,
                                              gk.out_min_static[None])
    settle16 = C.plan_union_mask(st_k16.plan, dm16, st16 == 1, mins16, {},
                                 gk.in_min_static, None)
    relax16 = torch.where(settle16, dm16, INF)[None].contiguous()
    d_kio, s_kio = st_kio.dist, st_kio.status
    god16 = kgate("out_dyn", s_kio)[None].contiguous()
    dga16, dgb16 = C.dep_gate_parts(kspec["out_full"], s_kio)
    keys16 = ell_sliced_keys_dep_batch(god16, dga16, dgb16, sl_out)
    mins_io16, nf_io16 = frontier_crit_lanes_batch(
        d_kio, s_kio, keys16[1][None].contiguous())
    settle_io16 = C.plan_union_mask(
        st_kio.plan, d_kio, s_kio == 1, mins_io16,
        {"in_full": st_kio.crit_keys[0], "out_dyn": keys16[0],
         "out_full": keys16[1]}, gk.in_min_static, None)
    dmask_io16 = torch.where(settle_io16, d_kio, INF)
    ga16, gb16, gc16 = (p[None].contiguous() for p in C.in_scan_gate_parts(
        kspec["in_full"], s_kio, settle_io16, gk.in_min_static[None]))
    upd16, _ = ell_sliced_relax_keys_batch(dmask_io16, ga16, gb16, gc16, sl_in)
    gate1_16 = torch.minimum(ga16[0], torch.minimum(
        gb16[0], gc16[0] + torch.where(upd16 < INF, 0.0, INF)))
    dep16 = torch.minimum(dga16, dgb16 + keys16[0])
    fs_r = sliced_finite(relax16, sl_in)
    fs_gate = sliced_finite(gate1_16, sl_in)
    fs_rk = sliced_finite(dmask_io16, sl_in) + fs_gate
    fs_kd = sliced_finite(god16, sl_out) + sliced_finite(dep16, sl_out)
    del gate1_16, dep16, upd16
    log(f"sliced timing inputs: phase {int(st_k16.trips)} of the "
        f"instatic|outstatic B={LANES} solve ({int(settle16.sum())} settled, "
        f"{int(nf16.sum())} on the fringe), phase {int(st_kio.trips)} of the "
        f"in|out solve ({int(settle_io16.sum())} settled); finite lane-slots: "
        f"relax {fs_r}, relax_keys {fs_rk} (gate sweep {fs_gate}), keys_dep "
        f"{fs_kd}")
    bk = LANES * nk * 4  # bytes of one (B, n) f32 vector
    # the relax, sliced push and sliced pull, on the same input in turns
    dm16 = relax16[0]
    check_push("ell_sliced_push_relax_batch", f"phase {int(st_k16.trips)} "
               "input", dm16, sl_out,
               ell_sliced_gather_min_batch(relax16, sl_in, sparse=True)[0],
               out_deg_k)
    push_stats.zero_()
    ell_sliced_push_relax_batch(dm16, sl_out, stats=push_stats)
    active16, cand16, rows16 = push_load(dm16, out_deg_k)
    relax_turns_k = [
        time_ms(lambda: ell_sliced_gather_min_batch(relax16, sl_in,
                                                    sparse=True), reps=20),
        time_ms(lambda: ell_sliced_push_relax_batch(dm16, sl_out), reps=20),
        time_ms(lambda: ell_sliced_push_relax_batch(dm16, sl_out), reps=20),
        time_ms(lambda: ell_sliced_gather_min_batch(relax16, sl_in,
                                                    sparse=True), reps=20),
    ]
    pull_ms_k = (relax_turns_k[0] + relax_turns_k[3]) / 2
    push_ms_k = (relax_turns_k[1] + relax_turns_k[2]) / 2
    push_plain_ms_k = time_ms(
        lambda: ref.ell_push_relax_batch_ref(dm16, sl_out), reps=3, warmup=1)
    # the pair along the sliced out-view (#9b redesigned) from the same
    # phase's entry state, in turns with the PR 15 sliced push
    pair_args16 = (st_k16.dist, st_k16.status, mins16, nf16, nf16 > 0,
                   sl_out, out_deg_k, gk.in_min_static)
    pair_kw16 = {"zero": False, "vrows": vrows_k}
    errs["ell_sliced_settle_commit_batch"] = max(
        errs["ell_sliced_settle_commit_batch"],
        pair_check(pair_args16, pair_kw16, f"phase {int(st_k16.trips)}, "
                   "kronecker(20) sliced"))
    pair16 = pair_times(pair_args16, pair_kw16,
                        lambda: ell_sliced_push_relax_batch(dm16, sl_out),
                        f"phase {int(st_k16.trips)}, kronecker(20) sliced B=8",
                        smi)
    b_rk, by_rk = relax_bound(dm16, out_deg_k)
    stream_b_rk, _ = bound(sl_bytes + merge_bytes(sl_in) + 2 * bk, 2.0 * fs_r)
    log(f"sliced relax at phase {int(st_k16.trips)}: {active16} active rows "
        f"({active16 / nk:.2%} of the vertices), {cand16} candidates, "
        f"{push_stats[1].item()} atomics issued (the kernel's count of "
        f"candidates: {push_stats[0].item()}), out-rows "
        f"{rows16 / 1e6:.1f} MB")
    log(f"sliced relax at phase {int(st_k16.trips)}, in turns (pull, push, "
        f"push, pull): " + ", ".join(f"{t:.4f}" for t in relax_turns_k)
        + f" ms; push {push_ms_k:.4f} ms, pull {pull_ms_k:.4f} ms; bound "
        f"(settled out-rows + dmask + upd) {b_rk:.4f} ms ({by_rk}), the "
        f"pull's stream of the whole sliced in-view {stream_b_rk:.4f} ms; "
        f"plain push twin {push_plain_ms_k:.4f} ms")
    dense_k, dense_trip_k, act_rows_k = phase_profile(
        gk, src8_k, sl_in, sl_out,
        lambda dm: ell_sliced_push_relax_batch(dm, sl_out),
        lambda dm: ell_sliced_gather_min_batch(dm, sl_in, sparse=True),
        lambda dm: dm[None], out_deg_k,
        f"relax profile kronecker({KRON_K}) sliced, instatic|outstatic")
    dense_k3 = dense_k[None]
    dense_turns_k = [
        time_ms(lambda: ell_sliced_gather_min_batch(dense_k3, sl_in,
                                                    sparse=True), reps=10),
        time_ms(lambda: ell_sliced_push_relax_batch(dense_k, sl_out), reps=10),
        time_ms(lambda: ell_sliced_push_relax_batch(dense_k, sl_out), reps=10),
        time_ms(lambda: ell_sliced_gather_min_batch(dense_k3, sl_in,
                                                    sparse=True), reps=10),
    ]
    dk_act, dk_cand, _ = push_load(dense_k, out_deg_k)
    log(f"sliced relax at the densest phase {dense_trip_k} ({dk_act} active "
        f"rows, {dk_cand} candidates), in turns (pull, push, push, pull): "
        + ", ".join(f"{t:.4f}" for t in dense_turns_k) + f" ms; bound "
        f"{relax_bound(dense_k, out_deg_k)[0]:.4f} ms")
    del dense_k, dense_k3
    # #10 (pull sweep), #10b (push sweep) and #11 on the pipelined body,
    # each in turns with the single-sweep body they ran on before (today's
    # body: per sweep a pack, the bucket-table gather and a merge over every
    # vertex, through #9's entry, which still runs it, with the gate between
    # the sweeps built by PyTorch instead of in the pack), then split by
    # kernel with torch.profiler
    def old_relax_keys():
        upd = ell_sliced_gather_min_batch(dmask_io16[None], sl_in,
                                          sparse=True)[0]
        fin = torch.where(upd < INF, 0.0, INF)
        gate = torch.minimum(ga16, torch.minimum(gb16, gc16 + fin[None]))
        return upd, ell_sliced_gather_min_batch(gate, sl_in)

    def old_keys_dep():
        keys0 = ell_sliced_gather_min_batch(god16, sl_out)
        gate = torch.minimum(dga16, dgb16 + keys0[0])
        return torch.cat([keys0, ell_sliced_gather_min_batch(gate[None],
                                                             sl_out)])

    relax_b, relax_by = relax_bound(dmask_io16, out_deg_k)
    _, cand_io16, rows_io16 = push_load(dmask_io16, out_deg_k)
    gate_bytes = (sl_bytes + 5 * bk + sl_in.row_owner.numel() * 4
                  + sl_in.merge_short.numel() * 4)
    gate_b, gate_by = bound(gate_bytes, 2.0 * fs_gate)
    rk_bound = bound(rows_io16 + 2 * bk + gate_bytes,
                     2.0 * (cand_io16 + fs_gate))
    sliced_timed = {
        "ell_sliced_relax_keys_batch": (
            lambda: ell_sliced_relax_keys_batch(dmask_io16, ga16, gb16, gc16,
                                                sl_in),
            lambda: ref.ell_sliced_relax_keys_batch_ref(dmask_io16, ga16,
                                                        gb16, gc16, sl_in),
            old_relax_keys, rk_bound),
        PUSH_IN_SCAN: (
            lambda: ell_sliced_relax_keys_batch(dmask_io16, ga16, gb16, gc16,
                                                sl_in, out_view=sl_out),
            lambda: ref.ell_sliced_relax_keys_batch_ref(
                dmask_io16, ga16, gb16, gc16, sl_in, out_view=sl_out),
            old_relax_keys, rk_bound),
        "ell_sliced_keys_dep_batch": (
            lambda: ell_sliced_keys_dep_batch(god16, dga16, dgb16, sl_out),
            lambda: ref.ell_sliced_keys_dep_batch_ref(god16, dga16, dgb16, 0,
                                                      sl_out),
            old_keys_dep,
            bound(sl_out_bytes + merge_bytes(sl_out) + 5 * bk, 2.0 * fs_kd)),
    }
    old_ms = {}
    for name, (kern, plain, old, (b_ms, b_by)) in sliced_timed.items():
        turns = [time_ms(old, reps=20), time_ms(kern, reps=20),
                 time_ms(kern, reps=20), time_ms(old, reps=20)]
        times[name] = ((turns[1] + turns[2]) / 2,
                       time_ms(plain, reps=3, warmup=1), b_ms, b_by)
        old_ms[name] = (turns[0] + turns[3]) / 2
        log(f"{name}: in turns (today's body, pipelined, pipelined, today's "
            f"body) " + ", ".join(f"{t:.4f}" for t in turns) + f" ms: "
            f"{times[name][0]:.4f} against {old_ms[name]:.4f} "
            f"({times[name][0] / old_ms[name]:.2f}x); plain "
            f"{times[name][1]:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        for label, fn in (("pipelined", kern), ("today's body", old)):
            log(f"{name} device ms a launch by kernel (launches seen a "
                f"call), {label}: " + "; ".join(
                    f"{k} {t:.4f} ({c:g})"
                    for k, t, c in device_split_counted(fn, calls=10)))
    log(f"sliced relax_keys bound, in two parts: the relax sweep (settled "
        f"out-rows {rows_io16 / 1e6:.1f} MB + dmask + upd) {relax_b:.4f} ms "
        f"({relax_by}), the gate sweep (the whole sliced in-view stream, "
        f"ga/gb/gc/upd read, keys written, the write-through plan) "
        f"{gate_b:.4f} ms ({gate_by})")
    times["ell_sliced_gather_min_batch"] = (
        pull_ms_k,
        time_ms(lambda: ref.ell_sliced_gather_min_batch_ref(relax16, sl_in),
                reps=3, warmup=1),
        b_rk, by_rk)
    gdense = torch.stack([kgate("out_dyn", s_kio), kgate("out_weak", s_kio)])
    dense_ms_s = time_ms(lambda: ell_sliced_gather_min_batch(gdense, sl_out),
                         reps=20)
    log(f"ell_sliced_gather_min_batch on dense V=2 out-view gates of the same "
        f"in|out phase: {dense_ms_s:.4f} ms; the partials add "
        f"{2 * LANES * sl_in.total_rows * 4 / 1e9:.4f} GB of traffic per "
        f"8-lane sweep beyond the bound")
    for crit in ("instatic|outstatic", "in|out"):
        solve_s, total_s, ph = sliced_solve[crit]
        l_s, s_s, ph_s = sliced_serve[crit]
        log(f"sliced {crit} on kronecker({KRON_K}): solve "
            f"{solve_s / total_s * 1e3:.3f} ms/phase, {np.mean(ph):.1f} "
            f"phases per query, {LANES / solve_s:.2f} queries/s; serving "
            f"{REQUESTS / s_s:.2f} queries/s, {np.mean(list(ph_s.values())):.1f}"
            f" phases per request")
    del st_k16, st_kio, relax16, dm16, dmask_io16, ga16, gb16, gc16, gdense
    phase_mark("17")
    # ---- 17. a sliced view with more buckets than one launch takes --------
    # G(10^5, 10^-3) (in-degrees ~ 100 +- 10) sliced at widths 64, 68, ...,
    # 136: every width has rows, so a pass runs in groups of 16 buckets
    t0 = time.perf_counter()
    gm = uniform_gnp(100_000, 1e-3, seed=SEED, device=dev)
    many = dict(pad_multiple=4, boundaries=tuple(range(64, 137, 4)))
    mv_in, mv_out = to_ell_in_sliced(gm, **many), to_ell_out_sliced(gm, **many)
    nm_ = gm.n
    live_in = sum(1 for s_ in mv_in.slices if s_.rows.shape[0])
    live_out = sum(1 for s_ in mv_out.slices if s_.rows.shape[0])
    if min(live_in, live_out) <= 16:
        raise SystemExit(f"the many-bucket views have {live_in} / {live_out} "
                         "buckets with rows, not more than 16")
    mrng = np.random.default_rng(17)
    md, mst = seeded_state(mrng, LANES, nm_, dev)
    msettle = (mst == 1) & torch.from_numpy(
        mrng.random((LANES, nm_)) < 0.05).to(dev)
    mdm = torch.where(msettle, md, INF)
    mdm[3, 11] = float("nan")
    mspec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def mgate(name_):
        return C.key_gate(mspec[name_], mst, gm.in_min_static,
                          gm.out_min_static, {})

    mlabel = f"G(1e5, 1e-3), {live_in} / {live_out} buckets with rows"
    check("ell_sliced_gather_min_batch", f"{mlabel}, in-view sparse dmask",
          ell_sliced_gather_min_batch(mdm[None], mv_in, sparse=True),
          ref.ell_sliced_gather_min_batch_ref(mdm[None], mv_in))
    mdense = torch.stack([mgate("out_dyn"), mgate("out_weak")])
    check("ell_sliced_gather_min_batch", f"{mlabel}, out-view dense V=2",
          ell_sliced_gather_min_batch(mdense, mv_out),
          ref.ell_sliced_gather_min_batch_ref(mdense, mv_out))
    check_push("ell_sliced_push_relax_batch", mlabel, mdm, mv_out,
               ell_sliced_gather_min_batch(mdm[None], mv_in,
                                           sparse=True)[0], out_degrees(gm))
    mparts = [p_[None].contiguous() for p_ in C.in_scan_gate_parts(
        mspec["in_full"], mst, msettle, gm.in_min_static[None])]
    mtwin = ref.ell_sliced_relax_keys_batch_ref(mdm, *mparts, mv_in)
    check("ell_sliced_relax_keys_batch", mlabel,
          ell_sliced_relax_keys_batch(mdm, *mparts, mv_in), mtwin)
    check(PUSH_IN_SCAN, f"{mlabel}, push sweep",
          ell_sliced_relax_keys_batch(mdm, *mparts, mv_in, out_view=mv_out),
          mtwin)
    mdga, mdgb = C.dep_gate_parts(mspec["out_full"], mst)
    check("ell_sliced_keys_dep_batch", mlabel,
          ell_sliced_keys_dep_batch(mdense, mdga, mdgb, mv_out, dep_idx=1),
          ref.ell_sliced_keys_dep_batch_ref(mdense, mdga, mdgb, 1, mv_out))
    del md, mst, msettle, mdm, mdense, mparts, mtwin, mdga, mdgb
    msrc = np.random.default_rng(3).integers(0, nm_, LANES)
    for crit in ("instatic|outstatic", "in|out"):
        res_m = run_phased_static_batch(gm, msrc, criterion=crit, ell=mv_in,
                                        ell_out=mv_out, device=dev)
        res_pad = run_phased_static_batch(gm, msrc, criterion=crit,
                                          device=dev)
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_m, field), getattr(res_pad, field)):
                raise SystemExit(f"many-bucket sliced {crit} differs from "
                                 f"the padded solve in {field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_m, field),
                                  getattr(res_pad, field)):
                raise SystemExit(f"many-bucket sliced {crit} differs from "
                                 f"the padded solve in {field}")
        log(f"many-bucket sliced {crit} on {mlabel}: B={LANES} solve "
            f"({int(res_m.total_phases)} phases) bit-equal to the padded "
            "solve on every BatchedResult field")
        if crit == "instatic|outstatic":
            res_default = res_pad
    # the pair over more buckets than its mark aggregates in shared memory
    # (SETTLE_SHARED_BUCKETS = 64 in csrc/ell_push.cu)
    mv_w = to_ell_out_sliced(gm, pad_multiple=1,
                             boundaries=tuple(range(50, 151)))
    live_w = sum(1 for s_ in mv_w.slices if s_.rows.shape[0])
    if live_w <= 64:
        raise SystemExit(f"the width-by-width out-view has {live_w} buckets "
                         "with rows, not more than 64")
    wd, wst = seeded_state(mrng, LANES, nm_, dev)
    wmins, wnf = frontier_crit_lanes_batch(wd, wst, gm.out_min_static[None])
    wlabel = f"G(1e5, 1e-3), {live_w} buckets with rows"
    errs["ell_sliced_settle_commit_batch"] = max(
        errs.get("ell_sliced_settle_commit_batch", 0.0),
        pair_check((wd, wst, wmins, wnf, wnf > 0, mv_w, out_degrees(gm),
                    gm.in_min_static),
                   {"zero": False, "vrows": vertex_row_table(gm, mv_w)},
                   wlabel))
    res_w = run_phased_static_batch(gm, msrc, ell=mv_in, ell_out=mv_w,
                                    device=dev)
    for field in ("dist", "status", "phases", "total_phases", "sum_fringe",
                  "relax_edges"):
        a_, b_ = getattr(res_w, field), getattr(res_default, field)
        if not (same_bits(a_, b_) if torch.is_tensor(a_)
                else np.array_equal(a_, b_)):
            raise SystemExit(f"the default solve on {wlabel} differs from "
                             f"the padded solve in {field}")
    log(f"many-bucket default solve on {wlabel}: B={LANES} "
        f"({int(res_w.total_phases)} phases) bit-equal to the padded solve "
        "on every BatchedResult field")
    del gm, mv_in, mv_out, res_m, res_pad, mv_w, wd, wst, res_w, res_default
    log(f"many-bucket phase: {time.perf_counter() - t0:.1f} s")

    phase_mark("18")
    # ---- 18. ContinuousBatcher on G(10^6, 10^-4), padded --------------------
    # (a) the default plan: 40 requests from seed 3, 32 distinct sources and
    # 8 repeats, in 4 bursts of 10 (one before each of the first 4 step()
    # calls), then drain(). The repeats: 2 a burst; those of bursts 1 and 2
    # arrive while their source (of burst 0) is in flight, those of bursts 0
    # and 3 while it still waits for a lane; all 8 coalesce.
    t18 = time.perf_counter()
    rng18 = np.random.default_rng(3)
    distinct = rng18.choice(g.n, 32, replace=False)
    repeats = ([distinct[0], distinct[1]], [distinct[2], distinct[3]],
               [distinct[4], distinct[5]], [distinct[16], distinct[17]])
    bursts = [[int(s) for s in rng18.permutation(
        np.concatenate([distinct[8 * k:8 * k + 8], repeats[k]]))]
        for k in range(4)]
    be18 = StaticBackend(g, ell=(cols, ws), device=dev)
    t0 = time.perf_counter()
    gkey = graph_key(g)
    key_s = time.perf_counter() - t0
    cache18 = DistCache(capacity=64)
    srv = ContinuousBatcher(g, lanes=LANES, phases_per_step=32, backend=be18,
                            cache=cache18)
    served = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for burst in bursts:
        for s in burst:
            srv.submit(s)
        served += srv.step()
    served += srv.drain()
    torch.cuda.synchronize()
    batcher_s = time.perf_counter() - t0
    launches_b = read_counts()
    rep = srv.metrics.report()
    # 4 more after the drain: each a cache hit, no engine trip
    trips_before = srv.metrics.engine_trips
    late = [srv.submit(int(s)) for s in distinct[[0, 9, 18, 27]]]
    srv.drain()
    if not all(r.cache_hit for r in late) or \
            srv.metrics.engine_trips != trips_before:
        raise SystemExit("a repeat after the drain was not a cache hit")
    outcomes = {}
    for r in served:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
    if len(served) != 40 or outcomes != {"ok": 40}:
        raise SystemExit(f"the batcher answered {outcomes}, not 40 ok")
    if (rep["coalesced"], rep["cache_hits"], rep["engine_served"]) != (8, 0, 32):
        raise SystemExit(f"batcher classification {rep['coalesced']} "
                         f"coalesced / {rep['cache_hits']} hits / "
                         f"{rep['engine_served']} on lanes, not 8 / 0 / 32")
    for name in ("frontier_crit_lanes_batch", *PAIR["padded"]):
        if launches_b[name] <= 0:
            raise SystemExit(f"the batcher never launched {name}")
    if any(launches_b[nm] for nm in ("ell_relax_batch", "ell_relax_keys_batch",
                                     "ell_push_relax_batch",
                                     "ell_sliced_push_relax_batch")):
        raise SystemExit(f"the batcher launched another relax: {launches_b}")
    # the rows against B = 8 kernel solves of the same sources (4 batches;
    # phase 4 holds that solve against the plain one)
    t0 = time.perf_counter()
    full = {}
    for k in range(4):
        res = run_phased_static_batch(g, distinct[8 * k:8 * k + 8],
                                      ell=(cols, ws), ell_out=(cols_o, ws_o),
                                      device=dev)
        for i, s in enumerate(distinct[8 * k:8 * k + 8]):
            full[int(s)] = res.dist[i].cpu().numpy()
    del res
    ref_s = time.perf_counter() - t0
    for r in served + late:
        if not np.array_equal(r.dist.view(np.int32),
                              full[r.source].view(np.int32)):
            raise SystemExit(f"batcher row of source {r.source} differs from "
                             "the batch solve")
    want18 = dijkstra(csr, directed=True, indices=int(distinct[0]))
    fin18 = np.isfinite(want18)
    got18 = full[int(distinct[0])]
    if not ((np.isfinite(got18) == fin18).all()
            and np.allclose(got18[fin18], want18[fin18], rtol=1e-5)):
        raise SystemExit("batcher row of distinct[0] disagrees with scipy")
    # the device's busy share over a steady window: 6 rounds of the first
    # two bursts on a fresh batcher (all 8 lanes busy)
    def batcher_window():
        w = ContinuousBatcher(g, lanes=LANES, phases_per_step=32,
                              backend=be18)
        for burst in bursts[:2]:
            for s in burst:
                w.submit(s)
            w.step()
        for _ in range(4):
            w.step()
        return w

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    win_trips = int(batcher_window().state.trips)
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    qps_static = len(rows) / serve_s
    log(f"batcher: 40 requests ({outcomes}; {rep['coalesced']} coalesced, "
        f"{rep['cache_hits']} cache hits, {rep['engine_served']} on lanes) in "
        f"{batcher_s:.3f} s, {rep['steps']} steps, {rep['engine_trips']} trips; "
        f"{rep['throughput_qps']:.2f} queries/s (report), "
        f"{40 / batcher_s:.2f} by the wall; admission-to-row latency p50 "
        f"{rep['latency_p50_s']:.3f} s, p99 {rep['latency_p99_s']:.3f} s, "
        f"lane occupancy {rep['lane_occupancy']:.3f}; phase 3's StaticBackend "
        f"loop {qps_static:.2f} queries/s [{smi}]")
    log(f"batcher window (6 rounds, {win_trips} trips, {win_s:.3f} s): "
        f"{busy_line(batcher_window, win_s, win_trips)} [{smi}]")
    log(f"batcher launches: {launches_b}")
    log(f"batcher: the 40 rows and 4 cache hits equal the B={LANES} kernel "
        f"solves ({ref_s:.1f} s) bit for bit; row of source "
        f"{int(distinct[0])} within rtol 1e-5 of scipy; graph_key "
        f"{gkey[:12]} in {key_s:.1f} s")

    # (b) in|out with point queries: 8 s->t requests from src8 (targets from
    # seed 4), then the 8 full requests of the same sources
    class RecordingBatcher(ContinuousBatcher):
        """Records each harvested lane's relax_edges through the harvest
        hook."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.relax = {}

        def _accept_row(self, req, lane, row, now):
            self.relax[req.req_id] = int(self.state.relax_edges[lane])
            return True

    tgt18 = np.random.default_rng(4).integers(0, g.n, LANES)
    be_io = StaticBackend(g, criterion="in|out", ell=(cols, ws),
                          point_queries=True, device=dev)
    cache_io = DistCache(capacity=64)
    srv_io = RecordingBatcher(g, lanes=LANES, phases_per_step=32,
                              backend=be_io, cache=cache_io,
                              point_queries=True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    pts = [srv_io.submit(int(s), target=int(t)) for s, t in zip(src8, tgt18)]
    fulls = [srv_io.submit(int(s)) for s in src8]
    srv_io.drain()
    torch.cuda.synchronize()
    io_s = time.perf_counter() - t0
    launches_p = read_counts()
    for i, (p_, f_) in enumerate(zip(pts, fulls)):
        if p_.cache_hit or p_.coalesced or f_.cache_hit or f_.coalesced:
            raise SystemExit("an in|out request did not run on its own lane")
        if not np.array_equal(np.float32(p_.distance).view(np.int32),
                              dist_io[i][int(tgt18[i])].view(np.int32)):
            raise SystemExit(f"point query {i}: dist[target] differs from "
                             "the full solve")
        if not np.array_equal(f_.dist.view(np.int32),
                              dist_io[i].view(np.int32)):
            raise SystemExit(f"in|out full row {i} differs from phase 9's")
    if len(cache_io) != len(set(int(s) for s in src8)) or not all(
            np.array_equal(cache_io.get(gkey, "in|out", int(s)).view(np.int32),
                           dist_io[i].view(np.int32))
            for i, s in enumerate(src8)):
        raise SystemExit("the cache holds a point row")
    for name in ("ell_relax_keys_batch", "ell_keys_dep_batch",
                 "frontier_crit_lanes_batch"):
        if launches_p[name] <= 0:
            raise SystemExit(f"in|out point serving never launched {name}")
    reprimes = (launches_p["ell_key_min_batch"]
                + launches_p["ell_key_min_status_batch"])
    if reprimes <= 0:
        raise SystemExit("in|out point serving never re-primed its keys")
    relax_pt = [srv_io.relax[r.req_id] for r in pts]
    relax_full = [srv_io.relax[r.req_id] for r in fulls]
    log(f"in|out points: 16 requests (8 s->t) in {io_s:.3f} s, "
        f"{srv_io.metrics.steps} steps, {srv_io.metrics.engine_trips} trips "
        f"[{smi}]; phases point {[r.phases for r in pts]} vs full "
        f"{[r.phases for r in fulls]}; relax_edges point {relax_pt} vs full "
        f"{relax_full} ({sum(relax_pt) / sum(relax_full):.3f} of the full "
        f"lanes' work); re-primes after admissions {reprimes}; every "
        "dist[target] and full row equal to phase 9's solve; the cache holds "
        "the 8 full rows only")
    log(f"in|out points launches: {launches_p}")
    log(f"phase 18: {time.perf_counter() - t18:.1f} s")

    phase_mark("19")
    # ---- 19. run_point_to_point --------------------------------------------
    t19 = time.perf_counter()

    def view_bytes(view) -> int:
        """Bytes of every tensor in a padded pair or a SlicedEll."""
        if isinstance(view, torch.Tensor):
            return view.numel() * view.element_size()
        if isinstance(view, tuple):
            return sum(view_bytes(v) for v in view)
        return 0

    def backward_views(graph, fwd_in, fwd_out, bwd_in, bwd_out):
        """The transpose's views, which must be ``graph``'s own swapped
        (``core.graph.transpose`` shares the memos): (seconds, bytes)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gt_ = transpose_memo(graph)
        views = (bwd_in(gt_), bwd_out(gt_))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if views[0] is not fwd_out(graph) or views[1] is not fwd_in(graph):
            raise SystemExit("the transpose's views are not the forward "
                             "graph's own, swapped")
        return secs, view_bytes(views)

    def held_shared(graph):
        """Every memoised bidirectional backend of ``graph`` ran its
        backward lane on the forward views."""
        backends = graph.__dict__.get("_point_backends", {}).values()
        bid = [pb for pb in backends if pb.bidirectional]
        if not bid or any(pb._bwd_views is None
                          or pb._bwd_views[0] is not transpose_memo(graph)
                          for pb in bid):
            raise SystemExit("run_point_to_point kept no bidirectional "
                             "backend on the memoised transpose")

    bwd_s, bwd_bytes = backward_views(g, to_ell_in, to_ell_out,
                                      to_ell_in, to_ell_out)
    pairs19 = [(int(s), int(t)) for s, t in zip(
        distinct[:4], np.random.default_rng(5).integers(0, g.n, 4))]

    def point_pair(graph, s, t, want_t, what, **kw):
        """One (s, t) pair bidirectional, then forward-only, through
        run_point_to_point: distance bit-equal to ``want_t``, mu >= it, and
        the forward lane's phases the same in both modes."""
        out = []
        for bidi in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_point_to_point(graph, s, t, bidirectional=bidi,
                                     device=dev, **kw)
            q_ms = (time.perf_counter() - t0) * 1e3
            mode = "bidirectional" if bidi else "forward"
            if not np.array_equal(np.float32(res.distance).view(np.int32),
                                  np.float32(want_t).view(np.int32)):
                raise SystemExit(f"run_point_to_point {what} {mode} ({s}, "
                                 f"{t}) differs from the full row")
            # mu sums a path in another order than the forward lane, so in
            # f32 it may round below distance: the reference's own test
            # allows that slack (rtol 1e-6), and so does this check
            if not (res.mu >= res.distance
                    or np.isclose(res.mu, res.distance, rtol=1e-6)):
                raise SystemExit(f"mu {res.mu} below distance {res.distance}")
            out.append((mode, s, t, res, q_ms))
        rb, rf = out[0][3], out[1][3]
        # a certified-unreachable query stops the forward lane early
        if (not rb.unreachable_certified
                and rb.phases_forward != rf.phases_forward):
            raise SystemExit(f"{what} ({s}, {t}): the forward lane ran "
                             f"{rb.phases_forward} phases bidirectional, "
                             f"{rf.phases_forward} alone")
        return out

    zero_counts()
    p19 = []
    for s, t in pairs19:
        p19 += point_pair(g, s, t, full[s][t], "padded")
    launches_q = read_counts()
    for name in ("frontier_crit_lanes_batch", *PAIR["padded"]):
        if launches_q[name] <= 0:
            raise SystemExit(f"point queries never launched {name}")
    held_shared(g)
    log(f"point: backward views (transpose_memo) {bwd_bytes / 1e9:.3f} GB, "
        f"all of them the forward views swapped (0 bytes new), fetched in "
        f"{bwd_s * 1e3:.3f} ms [{smi}]")
    for mode, s, t, res, q_ms in p19:
        log(f"point {mode} ({s}, {t}): distance {res.distance!r} (the full "
            f"row's), mu {res.mu!r}, phases forward {res.phases_forward} / "
            f"backward {res.phases_backward}, meeting vertex "
            f"{res.meeting_vertex}, {q_ms:.1f} ms [{smi}]")
    log(f"point launches: {launches_q}")
    # kronecker(20), sliced: 2 pairs a plan, bidirectional and forward-only,
    # one target with in-degree 0 (the unreachable path, certified by the
    # backward lane), against phase 14's sliced rows
    kbwd_s, kbwd_bytes = backward_views(gk, to_ell_in_sliced,
                                        to_ell_out_sliced, to_ell_in_sliced,
                                        to_ell_out_sliced)
    log(f"point sliced: backward views {kbwd_bytes / 1e9:.3f} GB, all of "
        f"them kronecker(20)'s sliced views swapped (0 bytes new), fetched "
        f"in {kbwd_s * 1e3:.3f} ms [{smi}]")
    real_k = torch.isfinite(gk.w)
    indeg_k = torch.bincount(gk.dst[real_k].long(), minlength=gk.n)
    no_in = int(torch.nonzero(indeg_k == 0)[0])
    del real_k, indeg_k
    launches_qs = {}
    for crit in ("instatic|outstatic", "in|out"):
        row0 = served_k[crit][0]
        reach = np.flatnonzero(np.isfinite(row0))
        t_reach = int(reach[np.random.default_rng(6).integers(len(reach))])
        zero_counts()
        for i, t in ((0, t_reach), (1, no_in)):
            s = int(src_k[i])
            for mode, _, _, res, q_ms in point_pair(
                    gk, s, t, served_k[crit][i][t], f"sliced {crit}",
                    criterion=crit, layout="sliced"):
                if (mode == "bidirectional" and t == no_in and s != no_in
                        and not res.unreachable_certified):
                    raise SystemExit(f"sliced {crit} ({s}, {t}): a target "
                                     "of in-degree 0 was not certified "
                                     "unreachable")
                log(f"point sliced {crit} {mode} ({s}, {t}): distance "
                    f"{res.distance!r}, mu {res.mu!r}, phases forward "
                    f"{res.phases_forward} / backward "
                    f"{res.phases_backward} (phase 14's full row: "
                    f"{sliced_serve[crit][2][i]}), certified unreachable "
                    f"{res.unreachable_certified}, {q_ms:.1f} ms [{smi}]")
        launches_qs[crit] = read_counts()
        must = (PAIR["sliced"]
                if crit == "instatic|outstatic"
                else (PUSH_IN_SCAN, "ell_sliced_keys_dep_batch",
                      "ell_sliced_gather_min_batch"))
        for name in must + ("frontier_crit_lanes_batch",):
            if launches_qs[crit][name] <= 0:
                raise SystemExit(f"sliced {crit} point queries never "
                                 f"launched {name}")
        log(f"point sliced {crit} launches: {launches_qs[crit]}")
    held_shared(gk)
    log(f"phase 19: {time.perf_counter() - t19:.1f} s")
    by_path = {"batcher": launches_b, "batcher_in_out_points": launches_p,
               "point_to_point": launches_q,
               "point_to_point_sliced": launches_qs["instatic|outstatic"],
               "point_to_point_sliced_in_out": launches_qs["in|out"]}

    phase_mark("20")
    # ---- 20. delta-stepping at full width -----------------------------------
    t20 = time.perf_counter()
    delta_g, delta_k = default_delta(g), default_delta(gk)
    log(f"delta: default_delta = {delta_g!r} on G(n={N}, p={P}), "
        f"{delta_k!r} on kronecker({KRON_K}) (Python floats; a state holds "
        f"each rounded to f32 once)")

    delta_policy = policy_for("delta")

    def delta_phase(graph, ell, srcs, delta, trips):
        """The inputs of one real delta phase, from the policy's own
        ``gates`` and ``prepare``: the first trip from ``trips`` on where
        some lane runs a light round and another its heavy turn. Returns
        the state, the bucket ids, the light and heavy gates (B, n) bool,
        the out-view the push reads, the light and heavy out-degrees and
        ``prepare``'s whole aux."""
        st = init_batch_state(graph, srcs, criterion="delta", delta=delta,
                              device=dev)
        st = step_batch(graph, st, trips, ell=ell)
        for _ in range(64):
            gt_ = delta_policy.gates(st)
            if bool(gt_.cur.any()) and bool(gt_.heavy_from.any()):
                break
            st = step_batch(graph, st, 1, ell=ell)
        out = delta_policy.out_view(graph, kops._is_sliced(ell))
        aux_ = delta_policy.prepare(graph, ell, out, st, True)
        return (st, gt_.bidx, gt_.cur, gt_.heavy_from, out, aux_[2], aux_[3],
                aux_)

    def gated_slots(gate_rows, view) -> int:
        """Lane-slots whose gate and gated weight are both finite: the adds
        and mins the data needs, over a padded pair or every bucket."""
        padded = kops.pad_lane_batch(gate_rows)
        buckets = ([(s.cols, s.ws) for s in view.slices]
                   if kops._is_sliced(view) else [view])
        total_slots = 0
        for c, w in buckets:
            c_l, w_fin = c.long(), torch.isfinite(w)
            for i in range(padded.shape[0]):
                total_slots += int((torch.isfinite(padded[i][c_l])
                                    & w_fin).sum())
        return total_slots

    def delta_bound(graph, d, light, heavy, deg_l,
                    deg_h) -> tuple[float, str, int]:
        """The least time of delta's relax on this input: the two bool
        gates read whole, d read only at the lane-vertices they mark (4
        bytes each: the gates say where a source may push, so no other d
        is needed), the out-rows of the live sources (8 bytes a real slot)
        and upd written once; an add and a min a candidate of a source's
        turn (its light arcs on a light round, its heavy arcs on the heavy
        turn). Also returns that count of candidates."""
        gated = light | heavy
        live = gated & (d != INF)
        deg = out_degrees(graph).long()
        row_bytes = 8 * int(deg[live.any(dim=0)].sum())
        cand = (int(torch.where(light & live, deg_l.long()[None], 0).sum())
                + int(torch.where(heavy & live, deg_h.long()[None], 0).sum()))
        return bound(row_bytes + 4 * int(gated.sum()) + 2 * d.numel()
                     + 4 * d.numel(), 2.0 * cand) + (cand,)

    def view_bytes(*views) -> int:
        """Bytes of every tensor the views hold, each storage once."""
        seen = {}

        def walk(x):
            if torch.is_tensor(x):
                seen[x.data_ptr()] = x.numel() * x.element_size()
            elif isinstance(x, (tuple, list)):
                for y in x:
                    walk(y)

        for v in views:
            walk(v)
        return sum(seen.values())

    delta_rows, delta_push, delta_bytes, dpair = {}, {}, {}, {}
    for what, graph, ell, srcs, delta, trips0 in (
            ("padded", g, (cols, ws), src8, delta_g, 24),
            ("sliced", gk, sl_in, src8_k, delta_k, 24)):
        st_d, bidx_d, light_d, heavy_d, out_d, dl_d, dh_d, aux_d = \
            delta_phase(graph, ell, srcs, delta, trips0)
        d_d = st_d.dist
        delta_f = float(st_d.delta)  # the f32 width, as prepare holds it
        lg_d = torch.where(light_d, d_d, INF)
        hg_d = torch.where(heavy_d, d_d, INF)
        n_light = int((lg_d != INF).sum())
        n_heavy = int((hg_d != INF).sum())
        # #2 on bucket ids: small integers in f32 on the fringe, +inf off it
        want_b = ref.frontier_crit_lanes_batch_ref(bidx_d, st_d.status, None)
        got_b = frontier_crit_lanes_batch(bidx_d, st_d.status, None)
        if not all(same_bits(a, b) for a, b in zip(got_b, want_b)):
            raise SystemExit(f"frontier_crit_lanes_batch on {what} bucket ids "
                             "disagrees with its twin")
        errs["frontier_crit_lanes_batch"] = max(
            errs["frontier_crit_lanes_batch"],
            max_abs_err(got_b[0], want_b[0]))
        # the parent's relax: #5 / #9 over the weight-gated in-views, built
        # here as its prepare built them and dropped after this phase
        lv_d, hv_d = kops.weight_gated_ell(ell, st_d.delta)
        rows_d, gathered = {}, []
        for side, gate_d, view, deg_d in (("light", lg_d, lv_d, dl_d),
                                          ("heavy", hg_d, hv_d, dh_d)):
            if what == "padded":
                padded_gate = kops.pad_lane_batch(gate_d)
                name = "ell_key_min_batch"

                def kern(pg=padded_gate, v=view):
                    return ell_key_min_batch(pg, v[0], v[1])

                def plain(pg=padded_gate, v=view):
                    return ref.ell_key_min_batch_ref(pg, v[0], v[1])
                nbytes = ell_bytes + padded_gate.numel() * 4 + gate_d.numel() * 4
            else:
                name = "ell_sliced_gather_min_batch"

                def kern(gt_=gate_d, v=view):
                    return ell_sliced_gather_min_batch(gt_[None], v)[0]

                def plain(gt_=gate_d, v=view):
                    return ref.ell_sliced_gather_min_batch_ref(gt_[None], v)[0]
                nbytes = sl_bytes + merge_bytes(view) + 2 * gate_d.numel() * 4
            got_d, want_d = kern(), plain()
            if not same_bits(got_d, want_d):
                raise SystemExit(f"{name} on the {what} {side}-gated view "
                                 "disagrees with its twin")
            gathered.append(got_d)
            errs[name] = max(errs.get(name, 0.0), max_abs_err(got_d, want_d))
            # the function is the relax of the gated vertices' light (heavy)
            # out-arcs, bounded as #1/#9 are (relax_bound); the bound of the
            # dense in-view stream, which the kernel reads, is kept beside
            b_d, by_d = relax_bound(gate_d, deg_d)
            stream_d, _ = bound(nbytes, 2.0 * gated_slots(gate_d, view))
            rows_d[side] = (time_ms(kern, 20), time_ms(plain, 2), b_d, by_d,
                            stream_d)
        delta_rows[what] = rows_d
        pulled = ref.nan_min(*gathered)
        del lv_d, hv_d, gathered
        # #5c / #9c: one push of both turns along the out-view
        if what == "padded":
            pname = "ell_delta_push_batch"

            def push_d(stats=None):
                return ell_delta_push_batch(d_d, light_d, heavy_d, *out_d,
                                            delta_f, stats=stats)
        else:
            pname = "ell_sliced_delta_push_batch"

            def push_d(stats=None):
                return ell_sliced_delta_push_batch(d_d, light_d, heavy_d,
                                                   out_d, delta_f,
                                                   stats=stats)

        def push_plain():
            return ref.ell_delta_push_batch_ref(d_d, light_d, heavy_d, out_d,
                                                delta_f)
        stats_d = torch.zeros(2, dtype=torch.int64, device=dev)
        got_p, want_p = push_d(stats_d), push_plain()
        if not same_bits(got_p, want_p):
            raise SystemExit(f"{pname} on the {what} delta phase disagrees "
                             "with its twin")
        if not same_bits(got_p, pulled):
            raise SystemExit(f"{pname} on the {what} delta phase disagrees "
                             "with the two gathers over the weight-gated "
                             "in-views")
        errs[pname] = max_abs_err(got_p, want_p)
        del got_p, want_p, pulled
        # delta's committed phase on the same entry state: the threshold,
        # the mark, the push and the tail against their twins and the
        # parent's phase body (#2 on the bucket ids, #5c / #9c and the glue
        # around them), and timed in turns with it
        dpair[what] = delta_pair_times(st_d, aux_d, what, smi)
        for name in DELTA_PAIR[what]:
            errs[name] = max(errs.get(name, 0.0), dpair[what]["max_abs_err"])
        b_p, by_p, turn_p = delta_bound(graph, d_d, light_d, heavy_d, dl_d,
                                        dh_d)
        cand_p, atom_p = stats_d.tolist()
        delta_push[what] = {
            "ms": time_ms(push_d, 20), "plain_ms": time_ms(push_plain, 2),
            "bound_ms": b_p, "bound_by": by_p,
            "gathers_ms": rows_d["light"][0] + rows_d["heavy"][0],
            "candidates": cand_p, "atomics": atom_p,
            # the candidates of a source's own turn; the rest are gated out
            # (d + inf), formed and filtered
            "turn_candidates": turn_p,
            "active_rows": int(((light_d | heavy_d) & (d_d != INF))
                               .any(dim=0).sum())}
        # the views delta holds while it serves: the out-view (the sliced
        # one's buckets) and no in-view, against the parent's in-view and
        # its two weight-gated copies' weights
        twin_ws = 2 * sum(s.ws.numel() * 4 for s in (
            ell.slices if kops._is_sliced(ell) else [EllSlice(None, *ell)]))
        delta_bytes[what] = {"out_view": view_bytes(out_d),
                             "parent_in_view": view_bytes(ell),
                             "parent_gated_weights": twin_ws}
        dp = delta_push[what]
        log(f"delta kernels, {what}, trip {int(st_d.trips)} of the B={LANES} "
            f"solve: {n_light} light-gate and {n_heavy} heavy-gate lane-"
            f"vertices, lanes on a light round "
            f"{int((lg_d != INF).any(dim=1).sum())}; #2 on bucket ids, both "
            f"gated gathers and {pname} bit-equal to their twins, and "
            f"{pname} to the two gathers; {pname} {dp['ms']:.4f} ms (plain "
            f"{dp['plain_ms']:.2f}, bound {b_p:.4f} {by_p}; {dp['active_rows']}"
            f" active rows, {cand_p} candidates, {turn_p} of them of their "
            f"source's turn, {atom_p} atomics) against "
            f"the parent's two gathers {dp['gathers_ms']:.3f} ms: " + "; ".join(
                f"{side} {t[0]:.3f} ms (plain {t[1]:.2f}, bound {t[2]:.4f} "
                f"{t[3]} [in-view stream {t[4]:.4f}])"
                for side, t in rows_d.items()) + f" [{smi}]")
        vb = delta_bytes[what]
        vb["vertex_row_table"] = (0 if aux_d[4] is None
                                  else view_bytes(aux_d[4]))
        parent_b = vb["parent_in_view"] + vb["parent_gated_weights"]
        log(f"delta resident views, {what}: the out-view "
            f"{vb['out_view'] / 1e9:.4f} GB (the worklist push's vertex row "
            f"table beside it {vb['vertex_row_table'] / 1e9:.4f} GB) and no "
            f"in-view; the parent's "
            f"in-view {vb['parent_in_view'] / 1e9:.4f} GB + gated weights "
            f"{vb['parent_gated_weights'] / 1e9:.4f} GB = "
            f"{parent_b / 1e9:.4f} GB")
        if vb["out_view"] > parent_b:
            raise SystemExit(f"delta's {what} views grew")
        del st_d, bidx_d, lg_d, hg_d, light_d, heavy_d, d_d, dl_d, dh_d, aux_d

    def legacy_lane(graph, source, delta, row, phases):
        """``run_delta_stepping`` against one stepper lane: (source, phases,
        buckets, seconds, verdict), the verdict "equal" (dist bit-equal,
        phases equal) or the vertex the loop stalls on. The legacy loop
        keeps a tentative t in bucket b only while
        fl(b delta) <= t < fl((b + 1) delta), so a t equal to fl(k delta)
        whose f32 quotient t / delta floors to k - 1 makes bucket k - 1 the
        lowest while the interval compare leaves t out of it; every later
        phase is then an empty heavy round up to the cap (the reference's
        loop does the same; the stepper compares bucket ids). A stalled
        lane must make no progress in 8 more phases and hold such a t at
        or below every distance it got wrong; anything else fails."""
        cap = phases + 1
        t0 = time.perf_counter()
        leg = run_delta_stepping(graph, source, delta=delta, max_phases=cap,
                                 device=dev)
        secs = time.perf_counter() - t0
        out = (source, int(leg.phases), int(leg.buckets_processed), secs)
        if same_bits(leg.dist, row) and int(leg.phases) == phases:
            return out + ("equal",)
        more = run_delta_stepping(graph, source, delta=delta,
                                  max_phases=cap + 8, device=dev)
        dl = torch.tensor(delta, dtype=torch.float32, device=dev)
        t = leg.dist
        k = torch.floor(t / dl) + 1.0
        wrong = t.view(torch.int32) != row.view(torch.int32)
        first_wrong = (ref.amin(row[wrong]) if bool(wrong.any())
                       else torch.tensor(INF, device=dev))
        stall = torch.isfinite(t) & (t == k * dl) & (t <= first_wrong)
        stuck = (int(leg.phases) == cap and int(more.phases) == cap + 8
                 and same_bits(leg.dist, more.dist))
        if not (stuck and bool(stall.any())):
            raise SystemExit(f"run_delta_stepping from {source} differs from "
                             "the stepper's lane")
        v = int(torch.nonzero(stall)[0])
        return out + (f"stalls at vertex {v}: t = {float(t[v])!r} = "
                      f"fl({int(k[v])} delta), t / delta = "
                      f"{float(t[v] / dl)!r}; {int(wrong.sum())} distances "
                      f"differ, none below t",)

    def no_relax_but(counts: dict, layout: str, what: str):
        """Delta's path launches its four (``DELTA_PAIR[layout]``): no #2,
        no gather (#5, #9), no #5c / #9c, no other push, no pull, no fused
        scan, not the criterion plans' pair."""
        relax = ("frontier_crit_lanes_batch", "ell_relax_batch",
                 "ell_push_relax_batch", "ell_sliced_push_relax_batch",
                 "ell_key_min_batch", "ell_key_min_status_batch",
                 "ell_gather_min_batch", "ell_sliced_gather_min_batch",
                 PUSH_IN_SCAN, "ell_relax_keys_batch",
                 "ell_sliced_relax_keys_batch", "ell_keys_dep_batch",
                 "ell_sliced_keys_dep_batch", "ell_delta_push_batch",
                 "ell_sliced_delta_push_batch", "ell_settle_mark_batch",
                 "ell_settle_push_batch", "ell_sliced_settle_push_batch",
                 "ell_settle_tail_batch") + DELTA_PAIR[
                     "sliced" if layout == "padded" else "padded"][2:3]
        if any(counts[name] for name in relax):
            raise SystemExit(f"{what} launched another kernel than delta's "
                             f"four: {[nm for nm in relax if counts[nm]]}")

    delta_phase_of = DeltaPolicy.phase

    def parent_method(self, graph, aux, s, use_kernels, go_of):
        return parent_delta_phase(s, aux, go_of, use_kernels)

    delta_e2e, delta_serve, delta_turns = {}, {}, {}
    for what, graph, ell, srcs8, srcs16, delta, want_row, fin_row in (
            ("padded", g, (cols, ws), src8, sources, delta_g, want, fin),
            ("sliced", gk, sl_in, src8_k, src_k, delta_k, want_k, fin_k)):
        kw = dict(ell=ell, criterion="delta", delta=delta, device=dev,
                  max_phases=DELTA_MAX_TRIPS)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res_d = run_phased_static_batch(graph, srcs8, **kw)
        torch.cuda.synchronize()
        solve_d_s = time.perf_counter() - t0
        if bool((res_d.status == 1).any()):
            raise SystemExit(f"the {what} delta solve is still live after "
                             f"{DELTA_MAX_TRIPS} trips")
        log(f"delta e2e {what}: the B={LANES} kernel solve ran "
            f"{int(res_d.total_phases)} trips in {solve_d_s:.3f} s")
        by_path[f"delta_solve_{what}"] = read_counts()
        must_run(by_path[f"delta_solve_{what}"], DELTA_PAIR[what],
                 f"the {what} delta solve")
        total_d = int(res_d.total_phases)
        no_relax_but(by_path[f"delta_solve_{what}"], what,
                     f"the {what} delta solve")
        t0 = time.perf_counter()
        res_dp = run_phased_static_batch(graph, srcs8, use_kernels=False, **kw)
        torch.cuda.synchronize()
        field = result_diff(res_d, res_dp)
        if field is not None:
            raise SystemExit(f"{what} delta kernel and plain solves differ "
                             f"in {field}")
        del res_dp
        plain_what = "plain twins, the whole solve"
        plain_d_s = time.perf_counter() - t0
        log(f"delta e2e {what}: {plain_what} {plain_d_s:.3f} s, bit-equal")

        def solve_d(graph=graph, srcs8=srcs8, kw=kw):
            return run_phased_static_batch(graph, srcs8, **kw)

        walls_d = repeat_wall(solve_d, solve_d_s)
        solve_d_s = float(np.median(walls_d))
        # the parent's phase (#2 on the bucket ids, #5c / #9c and the
        # PyTorch glue) and the committed pair in turns: parent, pair, pair,
        # parent, the same solve, wall ms a phase (the memoised captures
        # replay the phase they were captured with: they are freed on each
        # side of a swap, and a warm-up solve captures before the timed one)
        turns = []
        for label in ("parent", "pair", "pair", "parent"):
            if label == "parent":
                DeltaPolicy.phase = parent_method
            try:
                TS.forget_chunks(graph)
                solve_d()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res_t = solve_d()
                torch.cuda.synchronize()
                turns.append((label, (time.perf_counter() - t0) / total_d
                              * 1e3))
            finally:
                DeltaPolicy.phase = delta_phase_of
                TS.forget_chunks(graph)
            if not same_bits(res_t.dist, res_d.dist) or \
                    int(res_t.total_phases) != total_d:
                raise SystemExit(f"{what} delta solve with the {label} "
                                 "relax differs")
            del res_t
        delta_turns[what] = turns
        log(f"delta e2e {what}: ms/phase in turns (wall, B={LANES}): "
            + ", ".join(f"{lab} {ms:.3f}" for lab, ms in turns)
            + f" [{smi}]")
        dist_d = res_d.dist.cpu().numpy()
        got = dist_d[0]
        same_set = bool((np.isfinite(got) == fin_row).all())
        close = bool(np.allclose(got[fin_row], want_row[fin_row], rtol=1e-5))
        if not (same_set and close):
            raise SystemExit(f"{what} delta row 0 disagrees with scipy")
        # the legacy loop (COO segment-mins) on the card: two lanes equal,
        # every lane tried on the way holds its stall
        legacy = []
        for i in [0, LANES - 1] + list(range(1, LANES - 1)):
            legacy.append(legacy_lane(graph, int(srcs8[i]), delta,
                                      res_d.dist[i], int(res_d.phases[i])))
            if sum(v[-1] == "equal" for v in legacy) == 2:
                break
        else:
            raise SystemExit(f"{what}: fewer than two lanes of "
                             "run_delta_stepping equal the stepper's")
        log(f"delta e2e {what}: {busy_line(solve_d, solve_d_s, total_d)}")
        log(f"delta e2e {what}: B={LANES} solve with kernels, 3 runs "
            + ", ".join(f"{w:.3f}" for w in walls_d) + f" s, median "
            f"{solve_d_s:.3f} s ({LANES / solve_d_s:.2f} queries/s, {total_d} "
            f"phases, {solve_d_s / total_d * 1e3:.3f} ms/phase; phases per "
            f"row {res_d.phases.tolist()}); {plain_what} {plain_d_s:.3f} s, "
            f"bit-equal on every field; row 0 against scipy: same "
            f"reachable set, rtol 1e-5; run_delta_stepping lanes (source, "
            f"phases, buckets, s, verdict) {legacy} [{smi}]")
        # serving: #2 and the layout's delta push run, no other relax
        # kernel and neither gather
        backend_d = StaticBackend(graph, policy="delta", layout=what,
                                  device=dev)
        if backend_d.ell is not None or backend_d.ell_out is not (
                to_ell_out(graph) if what == "padded"
                else to_ell_out_buckets(graph)):
            raise SystemExit(f"the {what} delta server holds other views "
                             "than the out-view")
        rows_ds, ph_ds, l_ds, s_ds, steps_ds, trips_ds = serve(backend_d,
                                                               srcs16)
        del backend_d
        must_run(l_ds, DELTA_PAIR[what], f"{what} delta serving")
        no_relax_but(l_ds, what, f"{what} delta serving")
        for i in range(LANES):
            if not np.array_equal(rows_ds[i].view(np.int32),
                                  dist_d[i].view(np.int32)):
                raise SystemExit(f"{what} delta served row {i} differs from "
                                 "the solve")
        by_path[f"delta_serving_{what}"] = l_ds
        delta_e2e[what] = (solve_d_s, total_d, res_d.phases.tolist())
        delta_serve[what] = (s_ds, trips_ds, [ph_ds[r]
                                              for r in range(REQUESTS)])
        base_s, base_ph = ((serve_s, [req_phases[r] for r in range(REQUESTS)])
                           if what == "padded" else
                           (sliced_serve["instatic|outstatic"][1],
                            [sliced_serve["instatic|outstatic"][2][r]
                             for r in range(REQUESTS)]))
        log(f"delta serving {what}: {REQUESTS} requests in {s_ds:.3f} s "
            f"({REQUESTS / s_ds:.2f} queries/s; the default plan "
            f"{REQUESTS / base_s:.2f} in phase {3 if what == 'padded' else 14}"
            f"), {steps_ds} step calls, {trips_ds} trips; phases per request "
            f"{delta_serve[what][2]} (default plan {base_ph}); the 8 served "
            f"rows equal the solve's [{smi}]")
        log(f"delta serving {what} launches: {l_ds}")
        if what == "padded":
            res_delta = res_d  # phase 22 holds the telemetry run against it
        del res_d
    log(f"delta beside the default plan, ms/phase: padded "
        f"{delta_e2e['padded'][0] / delta_e2e['padded'][1] * 1e3:.3f} (default "
        f"{default_ms_phase:.3f}, phase 4), sliced kronecker("
        f"{KRON_K}) {delta_e2e['sliced'][0] / delta_e2e['sliced'][1] * 1e3:.3f}"
        f" (default {sliced_solve['instatic|outstatic'][0] / sliced_solve['instatic|outstatic'][1] * 1e3:.3f}, phase 15)")
    log("delta against the parent's phase (#2, #5c / #9c and the glue), "
        "ms/phase in turns, medians: " + "; ".join(
            f"{what} pair {np.median([t for lab, t in tr if lab == 'pair']):.3f}"
            f" parent {np.median([t for lab, t in tr if lab == 'parent']):.3f}"
            for what, tr in delta_turns.items()))
    log(f"phase 20: {time.perf_counter() - t20:.1f} s")

    phase_mark("21")
    # ---- 21. oracle plans ---------------------------------------------------
    # dist_true: phase 4's kernel solve (the f32 fixed point of these
    # sources); an oracle settle takes d <= dist_true + 1e-6 (1 + |dist_true|)
    t21 = time.perf_counter()
    truth = res_k.dist
    tol_hi = truth + C.oracle_tolerance(truth)
    oracle_rows = {}
    base_phases = {"oracle": None, "instatic|outstatic|oracle": res_k.phases,
                   "in|out|oracle": res_io.phases}
    for layout in ("padded", "sliced"):
        for plan in ("oracle", "instatic|outstatic|oracle", "in|out|oracle"):
            kw = dict(criterion=plan, dist_true=truth, layout=layout,
                      device=dev)
            if layout == "padded":
                kw.update(ell=(cols, ws), ell_out=(cols_o, ws_o))
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res_o = run_phased_static_batch(g, src8, **kw)
            torch.cuda.synchronize()
            solve_o_s = time.perf_counter() - t0
            l_o = read_counts()
            by_path[f"oracle_{layout}[{plan}]"] = l_o
            t0 = time.perf_counter()
            res_op = run_phased_static_batch(g, src8, use_kernels=False, **kw)
            torch.cuda.synchronize()
            plain_o_s = time.perf_counter() - t0
            field = result_diff(res_o, res_op)
            if field is not None:
                raise SystemExit(f"{layout} {plan} kernel and plain solves "
                                 f"differ in {field}")
            del res_op
            exact = same_bits(res_o.dist, truth)
            off = int((res_o.dist != truth).sum())
            inside = bool(((res_o.dist >= truth) & (res_o.dist <= tol_hi)
                           | (res_o.dist == truth)).all())
            if not inside:
                raise SystemExit(f"{layout} {plan}: a row left dist_true's "
                                 "tolerance")
            oracle_rows[(layout, plan)] = (res_o.phases.tolist(), exact, off)
            base = base_phases[plan]
            log(f"oracle {layout} {plan}: phases per row "
                f"{res_o.phases.tolist()}"
                + ("" if base is None else f" (without the oracle "
                   f"{base.tolist()})")
                + f", {int(res_o.total_phases)} trips in {solve_o_s:.3f} s "
                f"({solve_o_s / int(res_o.total_phases) * 1e3:.3f} ms/phase); "
                f"plain twins {plain_o_s:.3f} s, every field bit-equal; rows "
                f"equal to dist_true {exact} ({off} vertices above it, within "
                f"its tolerance) [{smi}]")
            log(f"oracle {layout} {plan} launches: {l_o}")
            if layout == "padded" and plan == "oracle":
                lane0 = (res_o.dist[0].clone(), int(res_o.phases[0]))
            del res_o
    for layout, push, in_scan in (
            ("padded", "ell_push_relax_batch", "ell_relax_keys_batch"),
            ("sliced", "ell_sliced_push_relax_batch", PUSH_IN_SCAN)):
        for plan, relax in (("oracle", push),
                            ("instatic|outstatic|oracle", push),
                            ("in|out|oracle", in_scan)):
            must_run(by_path[f"oracle_{layout}[{plan}]"],
                     ("frontier_crit_lanes_batch", relax),
                     f"the {layout} {plan} solve")
    t0 = time.perf_counter()
    rp = run_phased(g, int(src8[0]), "oracle", dist_true=truth[0], device=dev)
    rp_s = time.perf_counter() - t0
    if not same_bits(rp.dist, lane0[0]) or int(rp.phases) != lane0[1]:
        raise SystemExit("run_phased's oracle differs from the stepper's lane")
    log(f"oracle run_phased (COO segment-mins) on the card, source "
        f"{int(src8[0])}: {int(rp.phases)} phases in {rp_s:.3f} s, dist and "
        f"phases equal to the stepper's lane 0")
    del rp, lane0, tol_hi
    log(f"phase 21: {time.perf_counter() - t21:.1f} s")

    phase_mark("22")
    # ---- 22. telemetry rings ------------------------------------------------
    t22 = time.perf_counter()
    for plan, base_res, delta in (("instatic|outstatic", res_k, None),
                                  ("in|out", res_io, None),
                                  ("delta", res_delta, delta_g)):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        st_t = init_batch_state(g, src8, criterion=plan, delta=delta,
                                trace_len=int(base_res.total_phases) + 1,
                                telemetry=True, device=dev)
        st_t = step_batch(g, st_t, 4 * g.n + 16, ell=(cols, ws),
                          ell_out=(cols_o, ws_o))
        torch.cuda.synchronize()
        tel_s = time.perf_counter() - t0
        by_path[f"telemetry[{plan}]"] = read_counts()
        must_run(by_path[f"telemetry[{plan}]"], {
            "delta": DELTA_PAIR["padded"],
            "in|out": ("frontier_crit_lanes_batch", "ell_relax_keys_batch")}
            .get(plan, ("frontier_crit_lanes_batch", *PAIR["padded"])),
            f"the {plan} telemetry run")
        if plan == "instatic|outstatic" and \
                by_path[f"telemetry[{plan}]"]["ell_push_relax_batch"]:
            raise SystemExit("the default plan's telemetry run launched the "
                             "PR 15 push")
        res_t = harvest(st_t)
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_t, field), getattr(base_res, field)):
                raise SystemExit(f"{plan} with telemetry differs in {field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_t, field),
                                  getattr(base_res, field)):
                raise SystemExit(f"{plan} with telemetry differs in {field}")
        terms = attribution_terms(plan)
        settle_slots = [k for k, t in enumerate(terms) if t not in ("light",
                                                               "bucket")]
        fr_sum = res_t.fringe_per_phase.sum(dim=1, dtype=torch.int64)
        rx_sum = res_t.relax_per_phase.sum(dim=1, dtype=torch.int64)
        at_sum = res_t.settle_attribution[:, :, settle_slots].sum(
            dim=2, dtype=torch.int32)
        if not (np.array_equal(fr_sum.cpu().numpy(), res_t.sum_fringe)
                and np.array_equal(rx_sum.cpu().numpy(), res_t.relax_edges)
                and torch.equal(at_sum, res_t.settled_per_phase)):
            raise SystemExit(f"{plan}: the rings do not reconcile with the "
                             "counters")
        records = phase_telemetry(st_t)
        if len(records) != int(res_t.phases.sum()):
            raise SystemExit(f"{plan}: phase_telemetry decoded "
                             f"{len(records)} records")
        obs22 = Observability.enabled()
        publish_phase_telemetry(records, obs22.registry)
        trace_phase_telemetry(records, obs22.tracer)
        problems = validate_events(obs22.tracer.events())
        if problems:
            raise SystemExit(f"{plan}: telemetry events fail validation: "
                             f"{problems[:3]}")
        shares = {t: int(res_t.settle_attribution[:, :, k].sum())
                  for k, t in enumerate(terms) if t != "bucket"}
        log(f"telemetry {plan}: B={LANES}, trace_len "
            f"{st_t.settled_trace.shape[1]}, {int(res_t.total_phases)} trips "
            f"in {tel_s:.3f} s; every other field equal to the run without "
            f"rings; per lane the fringe ring sums to sum_fringe, the relax "
            f"ring to relax_edges, the attribution's settles to the settled "
            f"ring; {len(records)} records decoded, "
            f"{len(obs22.tracer.events())} trace events valid; attribution "
            f"totals {shares}")
        if plan == "instatic|outstatic":
            # what the rings cost a phase on the pair: solves with and
            # without them in turns (on, off, off, on), each key captured
            def ms_a_phase(telemetry: bool) -> float:
                st_x = init_batch_state(g, src8, criterion=plan,
                                        trace_len=st_t.settled_trace.shape[1],
                                        telemetry=telemetry, device=dev)
                torch.cuda.synchronize()
                t0_ = time.perf_counter()
                st_x = step_batch(g, st_x, 4 * g.n + 16, ell=(cols, ws),
                                  ell_out=(cols_o, ws_o))
                torch.cuda.synchronize()
                return (time.perf_counter() - t0_) * 1e3 / int(st_x.trips)

            ms_a_phase(False)  # the key's capture
            turns = [ms_a_phase(t_) for t_ in (True, False, False, True)]
            log(f"telemetry {plan}: ms a phase with the rings / without, in "
                f"turns (on, off, off, on): "
                + ", ".join(f"{x:.4f}" for x in turns)
                + f"; on {(turns[0] + turns[3]) / 2:.4f}, off "
                f"{(turns[1] + turns[2]) / 2:.4f} [{smi}]")
        del st_t, res_t, records, obs22
    log(f"phase 22: {time.perf_counter() - t22:.1f} s")

    phase_mark("23")
    # ---- 23. the engine portfolio -------------------------------------------
    t23 = time.perf_counter()
    import repro_torch.serving.backends as backends_mod

    def cand_kernels(spec, layout):
        """(kernels a candidate's solves must launch, kernels they must
        not): every criterion candidate runs #2 and no pull relax (#1); a
        layout runs none of the other layout's kernels; delta commits its
        phase through its four (the threshold, the mark, the push, the
        tail) and runs neither #2, the gathers (#5 / #9) nor #5c / #9c; a
        push plan commits through the pair, its probe (telemetry on) too,
        and launches neither #1b's nor #9b's push."""
        padded = layout == "padded"
        must = {"in|out": ("ell_relax_keys_batch", "ell_keys_dep_batch")
                if padded else (PUSH_IN_SCAN, "ell_sliced_keys_dep_batch"),
                }.get(spec, ("ell_push_relax_batch",) if padded
                      else ("ell_sliced_push_relax_batch",))
        commits = getattr(policy_for(spec), "commits", False)
        if commits:
            must = PAIR[layout]
        # sliced: #10 runs only in its push form (#10b)
        never = ("ell_relax_batch", "ell_sliced_relax_keys_batch") + (
            ("ell_sliced_gather_min_batch", PUSH_IN_SCAN,
             "ell_sliced_keys_dep_batch", "ell_sliced_push_relax_batch",
             "ell_sliced_delta_push_batch", "ell_sliced_settle_push_batch",
             "ell_sliced_delta_settle_push_batch")
            if padded else padded_gathers)
        if spec == "delta":
            return DELTA_PAIR[layout], never + (
                "frontier_crit_lanes_batch", "ell_key_min_batch",
                "ell_sliced_gather_min_batch", "ell_delta_push_batch",
                "ell_sliced_delta_push_batch")
        if commits:
            never += ("ell_push_relax_batch", "ell_sliced_push_relax_batch")
        return ("frontier_crit_lanes_batch",) + must, never

    def check_launches(counts, spec, layout, what):
        must, never = cand_kernels(spec, layout)
        must_run(counts, must, what)
        if any(counts[name] for name in never):
            raise SystemExit(f"{what} launched one of {never}: {counts}")

    # every solve measure_portfolio makes, recorded: its launches (counts set
    # to 0 just before each call and read just after) and its rows, the
    # probe's (telemetry on) and the last timed one's (telemetry off)
    probe_log = {}
    real_batch_solve = backends_mod.run_phased_static_batch

    def recording_solve(graph, srcs, **kw):
        rec = probe_log.setdefault(
            (id(graph), kw["criterion"], kw["layout"], kw.get("delta")),
            {"counts": dict.fromkeys(counted, 0), "calls": 0})
        zero_counts()
        res = real_batch_solve(graph, srcs, **kw)
        for name, c in read_counts().items():
            rec["counts"][name] += c
        rec["calls"] += 1
        rec["probe" if kw.get("telemetry") else "timed"] = (
            res.dist, res.status, res.phases)
        return res

    def probe_and_route(graph, cands, label, script, want_rows, scipy_row):
        """measure_portfolio over ``cands`` into a fresh ledger, per-candidate
        checks, save and reload, a PortfolioBackend built from the reloaded
        ledger (no launch, the recorded argmax), then ``script`` served
        through a ContinuousBatcher on it, every row against a B = 8 solve
        of the routed candidate. That candidate's first B = 8 solve is held
        against its plain twins on every field, the row of
        ``scipy_row[0]`` against scipy's ``scipy_row[1]`` (rtol 1e-5), and
        with ``want_rows`` every row against another plan's in value.
        Returns (ledger path, serving seconds, the batcher's report, the
        routed candidate's rows by source)."""
        t0 = time.perf_counter()
        fam = graph_family(graph)
        fam_s = time.perf_counter() - t0
        log(f"portfolio {label}: graph_family {fam!r} in {fam_s:.1f} s "
            "(host f64 buckets and a host BFS over the CSR)")
        ledger = TuningLedger()
        reg23 = MetricsRegistry()
        probe_log.clear()
        backends_mod.run_phased_static_batch = recording_solve
        torch.cuda.synchronize()
        run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            entries = measure_portfolio(graph, lanes=LANES, candidates=cands,
                                        ledger=ledger, registry=reg23)
        finally:
            backends_mod.run_phased_static_batch = real_batch_solve
        probe_s = time.perf_counter() - t0
        log(f"portfolio {label}: {len(cands)} candidates probed in "
            f"{probe_s:.1f} s, peak device memory during the probe "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
        for cand in cands:
            e = entries[(cand.ledger_policy, cand.layout)]
            delta = cand.resolve_delta(graph)
            rec = probe_log[(id(graph), cand.spec, cand.layout, delta)]
            what = f"portfolio {label} {cand.ledger_policy}:{cand.layout}"
            check_launches(rec["counts"], cand.spec, cand.layout, what)
            by_path[f"portfolio[{label}:{cand.ledger_policy}:"
                    f"{cand.layout}]"] = rec["counts"]
            for a, b in zip(rec["probe"], rec["timed"]):
                if not same_bits(a, b):
                    raise SystemExit(f"{what}: the probe's rows (telemetry "
                                     "on) differ from its timed solve's")
            if reg23.snapshot()[f"portfolio.qps.{cand.ledger_policy}."
                                f"{cand.layout}"]["value"] != e["qps"]:
                raise SystemExit(f"{what}: the registry's qps gauge differs")
            attr = e.get("settle_attribution", {})
            tot = sum(attr.values()) or 1
            log(f"  {cand.ledger_policy}:{cand.layout}: {e['qps']:.2f} "
                f"queries/s, {e['phases']} phases ({e['wall_s']:.3f} s, "
                f"{e['per_phase_s'] * 1e3:.3f} ms/phase), delta "
                f"{e.get('delta')}, shares "
                + " ".join(f"{t}={v / tot:.3f}" for t, v in attr.items())
                + f"; {rec['calls']} solves, launches "
                + str({k: v for k, v in rec["counts"].items() if v}))
        path = ledger.save(str(Path(tmp23) / f"ledger_{label}.json"))
        reloaded = TuningLedger(path)
        if reloaded.entries != ledger.entries:
            raise SystemExit(f"portfolio {label}: the reloaded ledger differs")
        torch.cuda.synchronize()
        zero_counts()
        pb = PortfolioBackend(graph, lanes_hint=LANES, candidates=cands,
                              ledger=reloaded)
        built = read_counts()
        if any(built.values()):
            raise SystemExit(f"portfolio {label}: building the backend "
                             f"launched kernels (a re-probe): {built}")
        best = max(entries, key=lambda k: entries[k]["qps"])
        if (pb.choice.ledger_policy, pb.choice.layout) != best:
            raise SystemExit(f"portfolio {label}: routed to {pb.choice}, "
                             f"not the recorded argmax {best}")
        log(f"portfolio {label}: reloaded {len(reloaded.entries)} entries "
            f"from {Path(path).name}; PortfolioBackend routed to "
            f"{pb.choice.ledger_policy}:{pb.choice.layout} (criterion "
            f"{pb.criterion!r}) with no launch")
        srv23 = ContinuousBatcher(graph, lanes=LANES, phases_per_step=32,
                                  backend=pb,
                                  cache=DistCache(capacity=64))
        done = []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for burst in script:
            for s in burst:
                srv23.submit(int(s))
            done += srv23.step()
        done += srv23.drain()
        torch.cuda.synchronize()
        serve23_s = time.perf_counter() - t0
        launches23 = read_counts()
        by_path[f"portfolio[{label}] serving"] = launches23
        check_launches(launches23, pb.choice.spec, pb.choice.layout,
                       f"portfolio {label} serving")
        n_req = sum(len(b) for b in script)
        if len(done) != n_req or any(r.outcome != "ok" for r in done):
            raise SystemExit(f"portfolio {label}: not every request ok")
        distinct_src = sorted({int(s) for b in script for s in b})
        routed = {}
        kw = dict(criterion=pb.choice.spec, layout=pb.choice.layout,
                  delta=pb.choice.resolve_delta(graph), device=dev)
        for k in range(0, len(distinct_src), LANES):
            chunk = distinct_src[k:k + LANES]
            res = run_phased_static_batch(graph, chunk, **kw)
            for i, s in enumerate(chunk):
                routed[s] = res.dist[i].cpu().numpy()
            if k == 0:  # the routed path's kernels against their twins
                t0 = time.perf_counter()
                field = result_diff(res, run_phased_static_batch(
                    graph, chunk, use_kernels=False, **kw))
                if field is not None:
                    raise SystemExit(f"portfolio {label}: the routed "
                                     f"candidate's kernel and plain solves "
                                     f"differ in {field}")
                log(f"portfolio {label}: the routed candidate's B={LANES} "
                    f"kernel solve bit-equal to its plain twins on every "
                    f"field ({time.perf_counter() - t0:.1f} s)")
            del res
        s_sp, want_sp = scipy_row
        got, fin = routed[s_sp], np.isfinite(want_sp)
        if not ((np.isfinite(got) == fin).all()
                and np.allclose(got[fin], want_sp[fin], rtol=1e-5)):
            raise SystemExit(f"portfolio {label}: the routed row of {s_sp} "
                             "disagrees with scipy's Dijkstra")
        for r in done:
            if not np.array_equal(r.dist.view(np.int32),
                                  routed[r.source].view(np.int32)):
                raise SystemExit(f"portfolio {label}: the row of source "
                                 f"{r.source} differs from a B={LANES} solve "
                                 "of the routed candidate")
        rep23 = srv23.metrics.report()
        if want_rows is not None:  # another plan's rows, equal as values
            differ = [r.source for r in done
                      if not np.array_equal(r.dist, want_rows[r.source])]
            if differ:
                raise SystemExit(f"portfolio {label}: the rows of {differ} "
                                 "differ in value from phase 18's "
                                 "default-plan rows")
        log(f"portfolio {label}: the row of {s_sp} within rtol 1e-5 of "
            "scipy's Dijkstra" + ("" if want_rows is None else
                                  f"; all {len(done)} rows equal in value "
                                  "to phase 18's default-plan rows"))
        return path, serve23_s, rep23, routed

    import tempfile
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp23 = tmp_ctx.name
    path_g, serve_g_s, rep_g, _ = probe_and_route(
        g, DEFAULT_CANDIDATES, "gnp", bursts, full,
        (int(distinct[0]), want18))
    # the host-bound default plan read against phase 4's solve, now
    walls_again = repeat_wall(solve_default, 0.0, runs=4)[1:]
    log(f"portfolio gnp: phase 4's default solve again "
        + ", ".join(f"{w:.3f}" for w in walls_again) + " s (phase 4: median "
        f"{default_ms_phase * int(res_k.total_phases) / 1e3:.3f} s) [{smi}]")
    log(f"portfolio gnp: phase 18's 40 requests through the routed backend "
        f"in {serve_g_s:.3f} s, {rep_g['throughput_qps']:.2f} queries/s "
        f"(report), {40 / serve_g_s:.2f} by the wall, {rep_g['steps']} steps; "
        f"phase 18's default plan {rep['throughput_qps']:.2f} / "
        f"{40 / batcher_s:.2f}; every row equal to a B={LANES} solve of the "
        f"routed candidate [{smi}]")
    sliced_cands = tuple(c for c in DEFAULT_CANDIDATES
                         if c.layout == "sliced") + (
        EngineCandidate("instatic|outstatic", "sliced"),)
    path_k, serve_k_s, rep_k23, rows_k23 = probe_and_route(
        gk, sliced_cands, "kronecker", [list(src8_k)], None,
        (int(src8_k[0]), want_k))
    log(f"portfolio kronecker: 8 requests through the routed backend in "
        f"{serve_k_s:.3f} s ({8 / serve_k_s:.2f} queries/s), "
        f"{rep_k23['steps']} steps; every row equal to a B={LANES} solve of "
        f"the routed candidate [{smi}]")
    merged = TuningLedger(path_g)
    merged.load(path_k)
    path_all = merged.save(str(Path(tmp23) / "ledger.json"))
    dash = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "dashboard", path_all],
        capture_output=True, text=True, timeout=120, check=False,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if dash.returncode != 0 or "== portfolio" not in dash.stdout:
        raise SystemExit(f"python -m repro_torch.obs dashboard failed "
                         f"({dash.returncode}): {dash.stderr[-2000:]}")
    log("portfolio dashboard (python -m repro_torch.obs dashboard):")
    for line in dash.stdout.rstrip().splitlines():
        log(f"  | {line}")
    log(f"phase 23: {time.perf_counter() - t23:.1f} s")

    phase_mark("24")
    # ---- 24. chaos and recovery -----------------------------------------------
    t24 = time.perf_counter()
    from repro_torch.serving.resilience import _verify_edges
    clock24 = VirtualClock()
    plan24 = FaultPlan([
        Fault("row_nan", at=2), Fault("step_error", at=4),
        Fault("cache_poison", at=5), Fault("row_neg", at=6),
        Fault("stall", at=8, magnitude=0.5),
        Fault("row_perturb", at=10, magnitude=2.0)], seed=24)
    be24 = FaultyBackend(StaticBackend(g, ell=(cols, ws), device=dev), plan24,
                         clock=clock24)
    cache24 = FaultyDistCache(DistCache(capacity=64), plan24)
    obs24 = Observability.enabled(clock=clock24.now)
    srv24 = ResilientBatcher(g, lanes=LANES, phases_per_step=32,
                             backend=be24, cache=cache24, clock=clock24.now,
                             obs=obs24)
    served24 = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for burst in bursts:
        for s in burst:
            srv24.submit(s)
        served24 += srv24.step()
    served24 += srv24.drain()
    torch.cuda.synchronize()
    chaos_s = time.perf_counter() - t0
    by_path["resilient (6 faults)"] = read_counts()
    must_run(by_path["resilient (6 faults)"],
             ("frontier_crit_lanes_batch", *PAIR["padded"]),
             "the resilient batcher")
    m24 = srv24.metrics
    fired = sorted(f.kind for f in be24.fired)
    want_fired = sorted(f.kind for f in plan24.faults
                        if f.kind != "cache_poison")
    row_faults = sum(f.kind.startswith("row_") for f in be24.fired)
    if fired != want_fired or len(cache24.poisoned) != 1:
        raise SystemExit(f"phase 24 fired {fired} and poisoned "
                         f"{cache24.poisoned}, not the plan's faults")
    if len(served24) != 40 or any(r.outcome != "ok" for r in served24):
        raise SystemExit("the resilient batcher did not answer every request "
                         f"ok: {[(r.source, r.outcome, r.fail_reason) for r in served24 if r.outcome != 'ok']}")
    if (m24.quarantines, m24.engine_failures) != (row_faults, 1):
        raise SystemExit(f"phase 24: {m24.quarantines} quarantines and "
                         f"{m24.engine_failures} engine failures, not "
                         f"{row_faults} and 1")
    snap24 = obs24.registry.snapshot()
    if (snap24["serving.quarantines"]["value"],
            snap24["serving.engine_failures"]["value"]) != (row_faults, 1):
        raise SystemExit("phase 24: the registry's counters disagree")
    poisoned_src = cache24.poisoned[0][2]
    late24 = srv24.submit(poisoned_src)
    srv24.drain()
    if cache24.corrupt_dropped != 1:
        raise SystemExit("the poisoned cache entry was not dropped")
    for r in served24 + [late24]:
        if not np.array_equal(r.dist.view(np.int32),
                              full[r.source].view(np.int32)):
            raise SystemExit(f"resilient row of source {r.source} differs "
                             "from phase 18's")
    events24 = obs24.tracer.events()
    failures = [e["name"] for e in events24
                if e["name"].startswith("engine failure")]
    if len(failures) != 1 or "injected engine failure" not in failures[0]:
        raise SystemExit(f"phase 24 recovered from another failure: "
                         f"{failures}")
    problems = validate_events(events24)
    trace24 = obs24.tracer.export(str(Path(tmp23) / "trace24.json"))
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", trace24],
        capture_output=True, text=True, timeout=120, check=False,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if problems or val.returncode != 0:
        raise SystemExit(f"phase 24's trace fails validation: {problems[:3]} "
                         f"{val.stdout[-500:]}")
    log(f"chaos: 40 requests under one fault of each kind ({fired} on the "
        f"backend, cache_poison at put {plan24.faults[2].at}) in "
        f"{chaos_s:.3f} s: all ok and equal to phase 18's rows; "
        f"{m24.quarantines} quarantines, {m24.retries} retries, "
        f"{m24.engine_failures} engine failure, {m24.steps} steps, virtual "
        f"clock {clock24.now()}; the poisoned entry (source {poisoned_src}) "
        f"dropped on lookup and re-solved; {len(events24)} trace events "
        f"valid ({val.stdout.strip()})")

    # (2) no faults: verify on and off against the plain batcher of phase 18
    def resilient_run(verify: bool):
        plan0 = FaultPlan([])
        s24 = ResilientBatcher(
            g, lanes=LANES, phases_per_step=32, verify=verify,
            backend=FaultyBackend(StaticBackend(g, ell=(cols, ws),
                                                device=dev), plan0),
            cache=FaultyDistCache(DistCache(capacity=64), plan0))
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for burst in bursts:
            for s in burst:
                s24.submit(s)
            out += s24.step()
        out += s24.drain()
        torch.cuda.synchronize()
        return s24, out, time.perf_counter() - t0

    def completions(reqs):
        return [(r.req_id, r.source, r.lane, r.phases, r.cache_hit,
                 r.coalesced, r.outcome) for r in reqs]

    qps24 = {True: [], False: []}
    for verify in (True, False, False, True):  # in turns
        s24, out24, s24_s = resilient_run(verify)
        if completions(out24) != completions(served) or \
                s24.metrics.steps != rep["steps"] or not all(
                    np.array_equal(a.dist.view(np.int32),
                                   b.dist.view(np.int32))
                    for a, b in zip(out24, served)):
            raise SystemExit(f"the resilient batcher (verify={verify}) with "
                             "no faults differs from phase 18's batcher")
        qps24[verify].append(40 / s24_s)
    log(f"no faults: completions, rows and steps ({rep['steps']}) equal to "
        f"phase 18's batcher; queries/s by the wall in turns (on, off, off, "
        f"on): {qps24[True][0]:.2f}, {qps24[False][0]:.2f}, "
        f"{qps24[False][1]:.2f}, {qps24[True][1]:.2f}: verify=True "
        f"{np.mean(qps24[True]):.2f} against verify=False "
        f"{np.mean(qps24[False]):.2f}; phase 18 {40 / batcher_s:.2f} [{smi}]")

    # (3) verify_row on the card against a host numpy form of the same check
    def host_verify(coo, n, d, source):
        """The reference's check in host numpy (``np.minimum.at``)."""
        h_src, h_dst, h_w = coo
        if np.isnan(d).any():
            return "NaN distance"
        if (d < 0).any():
            return "negative distance"
        if d[source] != np.float32(0.0):
            return f"dist[source] = {d[source]!r}, expected 0.0"
        best = np.full(n, np.inf, np.float32)
        np.minimum.at(best, h_dst, d[h_src] + h_w)
        best[source] = np.float32(0.0)
        bad = np.flatnonzero(d != best)
        if bad.size:
            v = int(bad[0])
            return (f"fixed-point violation at vertex {v}: dist={d[v]!r} vs "
                    f"min-in-edge {best[v]!r} ({bad.size} vertices total)")
        return None

    def host_coo(graph):
        keep = torch.isfinite(graph.w) & (graph.src != graph.dst)
        return (graph.src[keep].cpu().numpy(), graph.dst[keep].cpu().numpy(),
                graph.w[keep].cpu().numpy())

    s0 = int(distinct[0])
    row0 = full[s0]
    t0 = time.perf_counter()
    if verify_row(g, row0, s0) is not None:
        raise SystemExit("verify_row rejected an engine row")
    first_ms = (time.perf_counter() - t0) * 1e3
    walls24 = []
    for s in distinct[:20]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdict = verify_row(g, full[int(s)], int(s))
        walls24.append(time.perf_counter() - t0)
        if verdict is not None:
            raise SystemExit(f"verify_row rejected the row of {int(s)}")
    verify_ms = float(np.median(walls24)) * 1e3
    # the part of it that is the key-min sweep (#5 over the in-view)
    gate0 = torch.from_numpy(row0).to(dev)[None]
    sweep_ms = time_ms(
        lambda: kops.key_min_batch_any(gate0, _verify_edges(g)), reps=20)
    del gate0
    t0 = time.perf_counter()
    coo_g = host_coo(g)
    coo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if host_verify(coo_g, g.n, row0, s0) is not None:
        raise SystemExit("the host check rejected an engine row")
    host_ms = (time.perf_counter() - t0) * 1e3
    row_solve_ms = default_ms_phase * int(res_k.total_phases) / LANES
    log(f"verify_row on the card: {verify_ms:.3f} ms a row (median of 20 "
        f"rows; the first call {first_ms:.1f} ms memoises its view), of "
        f"which the one-lane #5 sweep {sweep_ms:.3f} ms by events; the "
        f"B={LANES} default solve {row_solve_ms:.3f} ms a row (phase 4), the "
        f"batcher {batcher_s / 40 * 1e3:.3f} ms a row (phase 18); the host "
        f"numpy form {host_ms:.1f} ms a row (one row; its COO copied in "
        f"{coo_s:.1f} s) [{smi}]")

    # (4) each single-entry corruption, rejected alike on the card and host
    s_k = int(src8_k[0])
    row_k = rows_k23[s_k]
    coo_k = host_coo(gk)
    for graph, coo, row, s, label in ((g, coo_g, row0, s0, "gnp"),
                                      (gk, coo_k, row_k, s_k, "kronecker")):
        fin_v = np.flatnonzero(np.isfinite(row) & (np.arange(graph.n) != s))
        v = int(fin_v[len(fin_v) // 3])
        cases = [("NaN", v, np.nan), ("negative", v, -1.0),
                 ("raised", v, row[v] + np.float32(0.5)),
                 ("lowered", v, row[v] * np.float32(0.5))]
        inf_v = np.flatnonzero(np.isinf(row))
        if inf_v.size:
            cases.append(("inf made finite", int(inf_v[0]), 7.0))
        elif label == "kronecker":
            raise SystemExit("the kronecker row has no unreachable vertex")
        for what, u, val in cases:
            bad = row.copy()
            bad[u] = val
            on_card = verify_row(graph, bad, s)
            on_host = host_verify(coo, graph.n, bad, s)
            if on_card is None or on_card != on_host:
                raise SystemExit(f"{label} {what}: verify_row {on_card!r}, "
                                 f"host {on_host!r}")
            log(f"  {label} row of {s}, {what} at {u}: {on_card}")
    del coo_g, coo_k
    tmp_ctx.cleanup()
    log(f"phase 24: {time.perf_counter() - t24:.1f} s")

    phase_mark("25")
    # ---- 25. the execution config and the analysis gate ---------------------
    t25 = time.perf_counter()
    # (a) the gate in a subprocess: lint, the CPU audit, and the card checks
    # (each kernel's ptxas resources, every contract case on a poisoned
    # allocator, 3 runs)
    t0 = time.perf_counter()
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--require-card"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    for line in gate.stdout.splitlines():
        if line.startswith(("resources:", "audit", "lint")):
            log(f"gate: {line}")
    if gate.returncode != 0:
        raise SystemExit(f"python -m repro_torch.analysis --require-card "
                         f"exited {gate.returncode}:\n{gate.stdout[-4000:]}\n"
                         f"{gate.stderr[-4000:]}")
    log(f"gate: exit 0 in {time.perf_counter() - t0:.1f} s")

    # (b) the scans' split form (tools/scan_variants.py) against the fused
    # scans: in|out, B = 8, on padded G(10^6, 10^-4) and sliced
    # kronecker(20), in turns (fused, split, split, fused); every
    # BatchedResult field bit-equal, the split runs launch #1 / #6 or #9 and
    # none of the fused scans
    split_tool = load_tool("scan_variants")
    fusion = {}
    io_views = {"padded": (g, src8, dict(ell=(cols, ws),
                                         ell_out=(cols_o, ws_o))),
                "sliced": (gk, src8_k, dict(layout="sliced"))}
    split_runs = {"padded": ("ell_relax_batch", "ell_gather_min_batch"),
                  "sliced": ("ell_sliced_gather_min_batch",)}
    fused_kernels = ("ell_relax_keys_batch", "ell_keys_dep_batch",
                     "ell_sliced_relax_keys_batch", PUSH_IN_SCAN,
                     "ell_sliced_keys_dep_batch")
    for layout, (graph, srcs, kw) in io_views.items():
        runs = []
        for mode in ("fused", "split", "split", "fused"):
            # the memoised captures replay the scans they were captured
            # with: freed on each side of the swap, and a warm-up solve
            # captures before the timed one
            TS.forget_chunks(graph)
            with (split_tool.split_scans() if mode == "split"
                  else contextlib.nullcontext()):
                run_phased_static_batch(graph, srcs, criterion="in|out",
                                        device=dev, **kw)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                res = run_phased_static_batch(graph, srcs, criterion="in|out",
                                              device=dev, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
            TS.forget_chunks(graph)
            if mode == "split":
                must_run(counts, split_runs[layout], f"split in|out {layout}")
                if any(counts[nm] for nm in fused_kernels):
                    raise SystemExit(f"split in|out {layout} launched a fused"
                                     f" scan: {counts}")
                by_path[f"split in|out {layout}"] = counts
            runs.append((mode, res, wall))
        for mode, res, _ in runs[1:]:
            bad = result_diff(runs[0][1], res)
            if bad is not None:
                raise SystemExit(f"in|out {layout}: {mode} differs from fused "
                                 f"in {bad}")
        total = int(runs[0][1].total_phases)
        ms = {m: [w / total * 1e3 for mm, _, w in runs if mm == m]
              for m in ("fused", "split")}
        fusion[layout] = (ms, total)
        log(f"scan fusion, in|out {layout} B={LANES} ({total} phases), in "
            f"turns (fused, split, split, fused): "
            + ", ".join(f"{w / total * 1e3:.3f}" for _, _, w in runs)
            + " ms/phase; split / fused "
            f"{np.mean(ms['split']) / np.mean(ms['fused']):.3f}; every "
            "BatchedResult field bit-equal")
        del runs

    # (c) the timer: #2 and #1b on phase 6's inputs (phase MID_PHASE of the
    # default B = 8 solve), CUDA events beside the host clock
    st25 = step_batch(g, init_batch_state(g, src8, device=dev), MID_PHASE,
                      ell=(cols, ws))
    d25, s25 = st25.dist, st25.status
    mins25, _ = kops.crit_thresholds_batch(d25, s25, keys_shared)
    settle25 = C.plan_union_mask(st25.plan, d25, s25 == 1, mins25, {},
                                 g.in_min_static, None)
    dm25 = torch.where(settle25, d25, INF)
    nf25 = (s25 == 1).sum(dim=1, dtype=torch.int32)
    timer_rows = {}
    for name, fn in (
            ("frontier_crit_lanes_batch",
             lambda: frontier_crit_lanes_batch(d25, s25, keys_shared)),
            ("ell_push_relax_batch",
             lambda: ell_push_relax_batch(dm25, cols_o, ws_o)),
            # the pair's three launches, with settle_phase_batch's copies
            ("ell_settle_commit_batch",
             lambda: settle_phase_batch(d25, s25, mins25, nf25, nf25 > 0,
                                        (cols_o, ws_o), out_deg,
                                        g.in_min_static, zero=False))):
        ev = kcfg.measure_launch(f"smoke.{name}", fn, reps=50) * 1e3
        host = kcfg.measure_launch(f"smoke.{name}.host", fn, reps=50,
                                   clock="host") * 1e3
        timer_rows[name] = (ev, host)
        log(f"measure_launch {name} at phase {MID_PHASE}: CUDA events "
            f"{ev:.4f} ms, host clock {host:.4f} ms (median of 50; host / "
            f"events {host / ev:.2f})")
    del st25, d25, s25, mins25, settle25, dm25, nf25

    # (d) a ledger probed on the CPU twins never routes the card
    fam = graph_family(g)
    led_cpu = TuningLedger()
    for i, cand in enumerate(DEFAULT_CANDIDATES):
        kcfg.record_portfolio(led_cpu, fam, LANES, cand.ledger_policy,
                              cand.layout, wall_s=1.0, phases=100,
                              queries=LANES * (1 + i), device="cpu")
    on_card = pick_engine(fam, LANES, DEFAULT_CANDIDATES, led_cpu, device=dev)
    on_cpu = pick_engine(fam, LANES, DEFAULT_CANDIDATES, led_cpu,
                         device="cpu")
    if on_card != DEFAULT_CANDIDATES[0] or on_cpu != DEFAULT_CANDIDATES[-1]:
        raise SystemExit(f"a cpu-tagged ledger routed the card to {on_card} "
                         f"(the cpu to {on_cpu})")
    log(f"routing: a ledger tagged cpu routes the card to the first "
        f"candidate ({on_card.ledger_policy}:{on_card.layout}), the cpu to "
        f"its argmax ({on_cpu.ledger_policy}:{on_cpu.layout})")

    # (e) the build sentinel over 16 warmed StaticBackend requests: one
    # step warms the backend's key (its capture, where the memo freed it)
    backend25 = StaticBackend(g, device=dev)
    backend25.step(backend25.reset_lanes(backend25.init(LANES), src8),
                   CHUNK, stop_on_lane_finish=True)
    with TraceGuard(label="warmed StaticBackend") as guard:
        rows25, _, launches25, serve25, _, _ = serve(backend25, sources)
    must_run(launches25, ("frontier_crit_lanes_batch", *PAIR["padded"]),
             "guarded serving")
    by_path["guarded serving"] = launches25
    for r in range(REQUESTS):
        if not np.array_equal(rows25[r].view(np.int32),
                              rows[r].view(np.int32)):
            raise SystemExit(f"guarded serving row {r} differs from phase 3")
    log(f"TraceGuard: {guard.compiles} compiles and {guard.captures} "
        f"captures over 16 warmed StaticBackend requests ({serve25:.3f} s; "
        f"rows equal to phase 3's); compile_count {compile_count()}, "
        f"capture_count {capture_count()} in the run")
    # a ContinuousBatcher captures at its first step at most, and nothing
    # after it: 16 requests of phase 3, the steps after the first guarded
    cb25 = ContinuousBatcher(g, lanes=LANES, phases_per_step=CHUNK)
    for src in sources[:REQUESTS]:
        cb25.submit(int(src))
    before25 = capture_count()
    done25 = list(cb25.step())
    first25 = capture_count() - before25
    with TraceGuard(label="warmed ContinuousBatcher") as guard_cb:
        done25 += cb25.drain()
    if len(done25) != REQUESTS:
        raise SystemExit(f"the guarded ContinuousBatcher answered "
                         f"{len(done25)} of {REQUESTS} requests")
    log(f"TraceGuard: a ContinuousBatcher captured {first25} chunk(s) at "
        f"its first step and {guard_cb.captures} (with {guard_cb.compiles} "
        f"compiles) over its other steps, {REQUESTS} requests")
    log(f"phase 25: {time.perf_counter() - t25:.1f} s")

    phase_mark("26")
    # ---- 26. the sharded stepper over torch.distributed ---------------------
    import tempfile

    import torch.distributed as tdist
    import torch.multiprocessing as tmp_mp

    from repro_torch.core import distributed as D
    from repro_torch.kernels.ell_relax import ell_push_rect_batch
    from repro_torch.launch.mesh import init_group
    from repro_torch.serving import ShardedBackend

    t26 = time.perf_counter()
    n = g.n

    def block(x, rank, n_loc):
        """Rank ``rank``'s (B, n_loc) block of (B, n) rows, +inf past n."""
        out = torch.full((x.shape[0], n_loc), INF, device=dev)
        lo, hi = rank * n_loc, min((rank + 1) * n_loc, n)
        out[:, : hi - lo] = x[:, lo:hi]
        return out

    # (a) the rectangular push (#1b) at full width, each block of P = 2
    # against its twin; the dense B = 8 case also against the square push
    # over the whole graph with only the block's rows live
    errs["ell_push_rect_batch"] = 0.0
    prng26 = np.random.default_rng(26)
    dm8u = torch.where(st8 == 1, d8, INF)  # phase 2's dense dmask
    gate8 = torch.where(st8 < 2, 0.0, INF)  # an "unsettled" key gate
    for r in range(2):
        sg = D.shard_graph_batch(g, 2, rank=r, with_transpose=False)
        view = sg.ell_out
        cases = {
            "B=1 sparse, NaN lane": (seeded_push_dmask(
                prng26, 1, sg.n_loc, 0.01, dev), view),
            "B=8 dense (a third finite)": (block(dm8u, r, sg.n_loc), view),
            "B=13 NaN lanes": (seeded_push_dmask(
                prng26, 13, sg.n_loc, 0.003, dev), view),
            "B=40 NaN lanes": (seeded_push_dmask(
                prng26, 40, sg.n_loc, 0.001, dev), view),
            "B=8 dense key gate": (block(gate8, r, sg.n_loc), view),
            "B=8 on {+0, -0, 0.5, 1}": (
                signed_vec(prng26, (LANES, sg.n_loc), dev, inf_frac=0.6),
                (view[0], signed_weights(view[1]))),
        }
        for label, (dm, vw) in cases.items():
            got = ell_push_rect_batch(dm, *vw, sg.n_pad)
            want = ref.ell_push_rect_batch_ref(dm, *vw, sg.n_pad)
            torch.cuda.synchronize()
            ok = same_bits(got, want)
            errs["ell_push_rect_batch"] = max(errs["ell_push_rect_batch"],
                                              max_abs_err(got, want))
            square = ""
            if label.startswith("B=8 dense (a"):
                full = torch.full((LANES, n), INF, device=dev)
                lo = r * sg.n_loc
                full[:, lo:lo + sg.n_loc] = dm[:, : n - lo]
                ok_sq = same_bits(got[:, :n],
                                  ell_push_relax_batch(full, cols_o, ws_o))
                square = (", the square push over the whole graph "
                          f"{'bits equal' if ok_sq else 'DIFFER'}")
                ok = ok and ok_sq
            log(f"parity ell_push_rect_batch [rank {r} of 2, {label}]: twin "
                f"{'bits equal' if ok else 'DIFFER'}{square} (n_loc "
                f"{sg.n_loc}, n_pad {sg.n_pad}, NaN out: "
                f"{int(torch.isnan(got).sum())})")
            if not ok:
                raise SystemExit(f"ell_push_rect_batch disagrees: rank {r}, "
                                 f"{label}")
        del sg, view, cases, got, want
    # its time on rank 0's block of phase MID_PHASE's input, beside the
    # twin, the bound, and the square push on the whole-graph input with
    # only that block live
    st26 = step_batch(g, init_batch_state(g, src8, device=dev), MID_PHASE,
                      ell=(cols, ws))
    mins26, _ = kops.crit_thresholds_batch(st26.dist, st26.status,
                                           keys_shared)
    settle26 = C.plan_union_mask(st26.plan, st26.dist, st26.status == 1,
                                 mins26, {}, g.in_min_static, None)
    dm_full26 = torch.where(settle26, st26.dist, INF)
    sg0 = D.shard_graph_batch(g, 2, rank=0, with_transpose=False)
    dm26 = block(dm_full26, 0, sg0.n_loc)
    only0 = torch.full_like(dm_full26, INF)
    only0[:, : sg0.n_loc] = dm26[:, : min(sg0.n_loc, n)]
    rect26 = ell_push_rect_batch(dm26, *sg0.ell_out, sg0.n_pad)
    if not (same_bits(rect26, ref.ell_push_rect_batch_ref(
            dm26, *sg0.ell_out, sg0.n_pad)) and same_bits(
            rect26[:, :n], ell_push_relax_batch(only0, cols_o, ws_o))):
        raise SystemExit(f"ell_push_rect_batch disagrees at phase {MID_PHASE}")
    rect_ms = time_ms(lambda: ell_push_rect_batch(dm26, *sg0.ell_out,
                                                  sg0.n_pad), reps=20)
    rect_sq_ms = time_ms(lambda: ell_push_relax_batch(only0, cols_o, ws_o),
                         reps=20)
    rect_plain_ms = time_ms(lambda: ref.ell_push_rect_batch_ref(
        dm26, *sg0.ell_out, sg0.n_pad), reps=5)
    active26, cand26, rows26 = push_load(dm26, sg0.out_deg)
    b26, by26 = bound(rows26 + dm26.numel() * 4 + LANES * sg0.n_pad * 4,
                      2.0 * cand26)
    log(f"ell_push_rect_batch at phase {MID_PHASE}, rank 0's block: "
        f"{rect_ms:.4f} ms ({active26} active rows, {cand26} candidates); "
        f"bound {b26:.4f} ms ({by26}); the square push on the same rows "
        f"{rect_sq_ms:.4f} ms; plain twin {rect_plain_ms:.4f} ms")
    del st26, mins26, settle26, dm_full26, only0, rect26, gate8, dm8u

    # (b) 2 ranks sharing cuda:0 under gloo (every collective staged through
    # host memory by Comm; NCCL refuses two ranks on one card)
    job26 = Path(tempfile.mkdtemp(prefix="smoke26-"))
    np.savez(job26 / "ref.npz", src8=np.asarray(src8),
             sources=np.asarray(sources),
             rows=np.stack([rows[r] for r in range(REQUESTS)]),
             **{f"{tag}_{f}": (getattr(res, f).cpu().numpy()
                               if torch.is_tensor(getattr(res, f))
                               else np.asarray(getattr(res, f)))
                for tag, res in (("k", res_k), ("io", res_io))
                for f in ("dist", "status", "phases", "sum_fringe",
                          "relax_edges")},
             k_trips=int(res_k.total_phases),
             io_trips=int(res_io.total_phases))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = tmp_mp.spawn(sharded_rank, args=(2, f"file://{job26}/store",
                                           str(job26)),
                       nprocs=2, join=False)
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise SystemExit("phase 26's ranks outlived 600 s")
    world_s = time.perf_counter() - t0
    reports = []
    for r in range(2):
        with open(job26 / f"rank{r}.json") as f:
            reports.append(json.load(f))
    log(f"sharded [{SHARDED_LABEL}; {smi}]: the ranks took {world_s:.1f} s "
        f"(graph generation {reports[0]['graph_s']:.1f} / "
        f"{reports[1]['graph_s']:.1f} s); gloo through host memory: every "
        f"collective staged explicitly (Comm.staged)")
    for rep26 in reports:
        r = rep26["rank"]
        for label, path in rep26["paths"].items():
            by_path[f"sharded {label} rank {r}"] = path["launches"]
            if label == "serving":
                what = (f"{path['requests']} requests, {path['steps']} steps, "
                        f"{path['trips']} trips, "
                        f"{REQUESTS / path['wall_s']:.2f} queries/s"
                        if r == 0 else
                        f"{path['commands']} commands followed")
                log(f"sharded [{SHARDED_LABEL}; {smi}] ShardedBackend "
                    f"serving rank {r}: {what}, {path['wall_s']:.3f} s; "
                    f"launches #1b rect {path['launches']['ell_push_rect_batch']}"
                    f", #2 {path['launches']['frontier_crit_lanes_batch']}")
                continue
            trips = max(path["trips"], 1)
            log(f"sharded [{SHARDED_LABEL}; {smi}] {label} B={LANES} rank "
                f"{r}: {path['trips']} trips, "
                f"{path['wall_s'] / trips * 1e3:.3f} ms/phase, exchange "
                f"{path['exchange_s'] / trips * 1e3:.3f} ms/phase (host clock"
                f", {path['collectives']} collectives), "
                f"{LANES / path['wall_s']:.2f} queries/s, "
                f"{path['wall_s']:.3f} s; launches #1b rect "
                f"{path['launches']['ell_push_rect_batch']}, #2 "
                f"{path['launches']['frontier_crit_lanes_batch']}")
    log("sharded: both schedules of the default plan equal phase 4's kernel "
        "solve and in|out phase 9's (dist, status, phases, sum_fringe, "
        "relax_edges, trips); ShardedBackend's 16 rows equal phase 3's; every "
        "rank ran #2 and the rectangular push and no pull")

    # (c) a world of one rank on NCCL, in this process
    init_group(0, 1, backend="nccl", init_method=f"file://{job26}/nccl",
               device=dev)
    try:
        stats26 = {}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res_n = D.run_sharded_batch(g, None, src8, device=dev, stats=stats26)
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0
        counts = read_counts()
        # ShardedBackend on NCCL: rank 0 alone, its commands broadcast to
        # no follower, phase 3's requests and rows
        zero_counts()
        server = ContinuousBatcher(g, lanes=LANES, phases_per_step=CHUNK,
                                   backend=ShardedBackend(g, device=dev))
        for s26 in sources:
            server.submit(int(s26))
        done26 = sorted(server.drain(max_steps=100_000),
                        key=lambda r: r.req_id)
        server.backend.close()
        counts_serve = read_counts()
    finally:
        tdist.destroy_process_group()
    must_run(counts, SHARDED_RELAX, "the NCCL world of one")
    must_run(counts_serve, SHARDED_RELAX, "ShardedBackend on NCCL")
    by_path["sharded default nccl world of one"] = counts
    by_path["sharded serving nccl world of one"] = counts_serve
    if len(done26) != REQUESTS or any(
            not np.array_equal(r.dist.view(np.int32),
                               rows[r.req_id].view(np.int32))
            for r in done26):
        raise SystemExit("ShardedBackend on NCCL: rows differ from phase 3's")
    bad = result_diff(res_k, res_n)
    if bad is not None:
        raise SystemExit(f"the NCCL world of one differs from phase 4 in {bad}")
    trips_n = int(res_n.total_phases)
    log(f"sharded [NCCL, a world of one on {kind}; {smi}] default B={LANES}:"
        f" {trips_n} trips, {nccl_s / trips_n * 1e3:.3f} ms/phase, exchange "
        f"{stats26.get('exchange_s', 0.0) / trips_n * 1e3:.3f} ms/phase "
        f"({stats26.get('collectives', 0)} collectives), "
        f"{LANES / nccl_s:.2f} queries/s, {nccl_s:.3f} s; every "
        "BatchedResult field equal to phase 4's; ShardedBackend served "
        f"phase 3's {REQUESTS} requests with its rows")
    del res_n, sg0, dm26
    import shutil

    shutil.rmtree(job26, ignore_errors=True)
    log(f"phase 26: {time.perf_counter() - t26:.1f} s")

    phase_mark("27")
    # ---- 27. LM serving ----------------------------------------------------
    zero_counts()
    lm27 = lm_serving_phase(dev, smi, run_peak)
    lm_counts = read_counts()
    if any(lm_counts.values()):  # the LM path has no kernel of its own
        raise SystemExit(f"phase 27 launched SSSP kernels: {lm_counts}")
    by_path["lm serving"] = lm_counts

    phase_mark("28")
    # ---- 28. LM training ---------------------------------------------------
    zero_counts()
    lm28 = lm_training_phase(dev, run_peak)
    lm_counts = read_counts()
    if sssp_launched(lm_counts):  # its one kernel is the lookup's gradient
        raise SystemExit(f"phase 28 launched SSSP kernels: {lm_counts}")
    must_run(lm_counts, ("embed_grad",), "phase 28")
    by_path["lm training"] = lm_counts
    embed_row = embed_grad_times(dev)
    log(f"embed_grad [{smi}] {EMBED_ARCH} B={LM_TRAIN_B} x {LM_TRAIN_S} "
        f"tokens (longest run {embed_row['longest_run']}), table "
        f"{embed_row['rows']} x {embed_row['d']} f32: "
        f"{embed_row['ms']:.4f} ms (twin {embed_row['plain_ms']:.3f}, "
        f"index_add_ {embed_row['library_ms']:.4f}, bound "
        f"{embed_row['bound_ms']:.4f} {embed_row['bound_by']}); bit-equal "
        f"to its twin and to itself; {lm_counts['embed_grad']} launches in "
        f"phase 28")

    phase_mark("30")
    # ---- 30. the dry run on the card -----------------------------------
    dry30 = dry_run_phase(dev, smi, run_peak, counted)
    by_path["dry run sssp (rank 0 of the fake pod)"] = {
        k: sum(r["launches"].get(k, 0) for r in dry30["sssp"].values())
        for k in counted}
    tr = lm28["timed"]
    bd = tr["bound"]
    log(f"lm train internlm2-1.8b ({LM_TRAIN_UNITS} of 24 units) [{smi}] "
        f"f32, B={tr['batch']} x {tr['seq']}, "
        f"full remat, AdamW (m bf16, v factored): {tr['ms_per_step']:.1f} ms "
        f"a step (median of steps 2-{LM_TRAIN_STEPS}; bound "
        f"{bd['step_ms']:.1f}, {bd['step_by']}: {bd['step_ops']:.3e} f32 "
        f"operations, 3 forwards; full remat's recompute adds "
        f"{bd['recompute_ms']:.1f} to it), "
        f"{tr['tokens_per_s']:.1f} tokens/s (bound "
        f"{tr['tokens_per_s_bound']:.1f}); peak {tr['peak_gib']:.2f} GiB above "
        f"the {tr['resident_before_gib']:.2f} GiB resident (parameters, "
        f"gradients and m alone {tr['state_gib']:.2f}); losses {tr['losses']}; "
        f"resumed from step {LM_TRAIN_EVERY}: {tr['resumed_losses']} (largest "
        f"relative difference {tr['resume_max_rel']:.2e}, limit "
        f"{LM_RESUME_RTOL}); step wall seconds {tr['step_s']}")
    pr, ck = tr["profile"], tr["checkpoint"]
    log(f"lm train profile: {pr['device_ms']:.1f} device ms a step in "
        f"{pr['kernels']:.0f} kernels, busy {pr['busy_share']:.1%}; by kind "
        f"[ms, launches] {pr['by_kind']}; top {pr['top']}")
    log(f"lm train checkpoint: {ck['bytes'] / 1e9:.3f} GB on disk; snapshot "
        f"to the host {ck['snapshot_s']:.2f} s (bound "
        f"{ck['snapshot_bound_s']:.2f} s over PCIe 5.0 x16), write "
        f"{ck['write_s']:.2f} s ({ck['write_gb_per_s']:.2f} GB/s), restore "
        f"onto the card {ck['restore_s']:.2f} s; restored bit for bit")

    # phase 29 ran after phase 1
    by_path["lm mesh (this process)"] = lm29_counts
    lm29_rank0 = lm29.pop("launches")
    by_path["lm mesh (rank 0 of the 2 x 2 world)"] = lm29_rank0
    eblock = dry30["embed_block"]

    phase_mark("31")
    # ---- 31. the entry points (repro_torch.examples) --------------------
    ex31, ex31_launches = examples_phase(dev, smi, counted)
    by_path["examples"] = {k: sum(c[k] for c in ex31_launches.values())
                           for k in counted}

    phase_mark("32")
    # ---- 32. the replayed chunk loop against the eager chunk ----------------
    chunk32 = chunk_loop_phase(dev, smi, {
        "g": g, "gk": gk, "src8": src8, "src8_k": src8_k,
        "padded": dict(ell=(cols, ws), ell_out=(cols_o, ws_o)),
        "sliced": dict(ell=sl_in, ell_out=sl_out)},
        zero_counts, read_counts, must_run, chunk_line, run_peak)
    by_path.update(chunk32)

    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
    log(f"peak device memory: {run_peak[0] / 2**30:.2f} GiB for the run")
    log(f"card: {smi}")
    sliced_kernels = {
        "ell_sliced_gather_min_batch": "src/repro/kernels/ell_relax_keys.py:311",
        "ell_sliced_relax_keys_batch": "src/repro/kernels/ell_relax_keys.py:345",
        PUSH_IN_SCAN: "src/repro/kernels/ell_relax_keys.py:345",
        "ell_sliced_keys_dep_batch": "src/repro/kernels/ell_relax_keys.py:394",
    }
    new_kernels = {
        "ell_key_min_batch": "src/repro/kernels/ell_key_min.py:86",
        "ell_gather_min_batch": "src/repro/kernels/ell_relax_keys.py:93",
        "ell_relax_keys_batch": "src/repro/kernels/ell_relax_keys.py:182",
        "ell_keys_dep_batch": "src/repro/kernels/ell_relax_keys.py:482",
    }
    sharded_launches = reports[0]["paths"]["default reduce_scatter"][
        "launches"]
    kernels = [
        # the pull relax: no serving path launches it since the push took
        # over the relax of every plan without in-side keys (0 launches on
        # the main path); its bound is the function's, the push's
        {"name": "ell_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": "src/repro/kernels/ell_relax.py:97",
         "launches": launches["ell_relax_batch"],
         "max_abs_err": errs["ell_relax_batch"], "ms": out_ms_r,
         "plain_ms": plain_ms_r, "bound_ms": b_r, "bound_by": by_r,
         "library_ms": None, "stream_bound_ms": stream_b_r},
        {"name": "ell_push_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": "src/repro/kernels/ell_relax.py:97",
         "launches": launches["ell_push_relax_batch"],
         "max_abs_err": errs["ell_push_relax_batch"], "ms": push_ms,
         "plain_ms": push_plain_ms, "bound_ms": b_r, "bound_by": by_r,
         "library_ms": None, "pull_ms": out_ms_r, "active_rows": active_mid,
         "candidates": cand_mid, "densest_phase_ms": dense_turns[1:3],
         "active_rows_median": int(np.median(act_rows_g)),
         "active_rows_max": int(act_rows_g.max())},
        {"name": "frontier_crit_lanes_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/frontier_crit.cu",
         "replaces": "src/repro/kernels/frontier_crit.py:94",
         "launches": launches["frontier_crit_lanes_batch"],
         "max_abs_err": errs["frontier_crit_lanes_batch"], "ms": out_ms_c,
         "plain_ms": plain_ms_c, "bound_ms": b_c, "bound_by": by_c,
         "library_ms": None, "two_pass_body_ms": old_ms_c,
         "device_ms": crit_dev_mid[1], "two_pass_device_ms": crit_dev_mid[0],
         "per_lane_keys_ms": pl_ms, "per_lane_keys_two_pass_ms": pl_old_ms,
         "per_lane_keys_bound_ms": b_pl,
         "launches_in_out": launches_io["frontier_crit_lanes_batch"]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": replaces,
         # the gather runs on the insimple|outsimple path, the rest on in|out
         "launches": (launches_ss if name == "ell_gather_min_batch"
                      else launches_io)[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None,
         # the fused scans: the adjacency read twice, and their two sweeps
         # each timed alone on the single-sweep body (their earlier design);
         # #5 and #6: the single-sweep body in turns with the pipelined one
         **({"two_read_bound_ms": 2 * times[name][2],
             "single_sweeps_ms": single_sweeps[name]}
            if name in single_sweeps else {}),
         **({"single_sweep_body_ms": single_ms[name]}
            if name in single_ms else {})}
        for name, replaces in new_kernels.items()
    ] + [
        # #6 (and #5) on "unsettled" gates read from status: the path of
        # insimple|outsimple's out-scan and priming; timed on the out-ELL
        {"name": "ell_key_min_status_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": "src/repro/kernels/ell_relax_keys.py:93",
         "also_replaces": "src/repro/kernels/ell_key_min.py:86",
         "launches": launches_ss["ell_key_min_status_batch"],
         "max_abs_err": errs["ell_key_min_status_batch"],
         "ms": status_turns["out-ELL"][0], "plain_ms": status_plain_ms,
         "bound_ms": times["ell_gather_min_batch"][2],
         "bound_by": times["ell_gather_min_batch"][3], "library_ms": None,
         "f32_path_ms": status_turns["out-ELL"][1],
         "single_sweep_body_ms": status_turns["out-ELL"][2],
         "in_ell_ms": status_turns["in-ELL"][0],
         "in_ell_f32_path_ms": status_turns["in-ELL"][1]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": replaces,
         # the sliced in|out serving run's launches: the gather runs there
         # to re-prime keys; the default plan's relax is the sliced push,
         # and in|out's fused in-scan runs its push form (#10b)
         "launches": sliced_serve["in|out"][0][name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None,
         **({"stream_bound_ms": stream_b_rk}
            if name == "ell_sliced_gather_min_batch" else
            {"single_sweep_body_ms": old_ms[name]}),
         **({"bound_relax_ms": relax_b, "bound_gate_ms": gate_b,
             "push_source": "src/repro_torch/kernels/csrc/ell_push.cu"}
            if name != "ell_sliced_keys_dep_batch"
            and name != "ell_sliced_gather_min_batch" else {})}
        for name, replaces in sliced_kernels.items()
    ] + [
        {"name": "ell_sliced_push_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": "src/repro/kernels/ell_relax_keys.py:311",
         "launches": sliced_serve["instatic|outstatic"][0][
             "ell_sliced_push_relax_batch"],
         "max_abs_err": errs["ell_sliced_push_relax_batch"],
         "ms": push_ms_k, "plain_ms": push_plain_ms_k, "bound_ms": b_rk,
         "bound_by": by_rk, "library_ms": None, "pull_ms": pull_ms_k,
         "active_rows": active16, "candidates": cand16,
         "densest_phase_ms": dense_turns_k[1:3],
         "active_rows_median": int(np.median(act_rows_k)),
         "active_rows_max": int(act_rows_k.max())},
    ] + [
        # the pair that redesigns #1b / #9b on the push plans' path (the
        # main path): each of its three launches timed by kernel on phase
        # 6's real phase (padded) or phase 16's (sliced), in turns with the
        # PR 15 push's two passes; launches: phase 3's serving (padded),
        # phase 14's (sliced). The mark and the tail serve both layouts:
        # their sliced phase's times ride beside
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": replaces, "kernel": kern,
         "launches": counts_of[name], "max_abs_err": errs[contract],
         "ms": pt["ms"][kern], "plain_ms": pt["plain_ms"][kern],
         "bound_ms": pt["bounds"][kern][0], "bound_by": pt["bounds"][kern][1],
         "library_ms": None, "pair_ms": sum(pt["ms"].values()),
         "pr15_push_ms": pt["old_push_ms"], "settled": pt["settled"],
         "worklist_entries": pt["entries"], "candidates": pt["candidates"],
         **({"sliced_phase_ms": pair16["ms"][kern],
             "sliced_phase_bound_ms": pair16["bounds"][kern][0]}
            if kern != "settle_push_kernel" else {})}
        for name, kern, pt, contract, replaces, counts_of in (
            ("ell_settle_mark_batch", "settle_mark_kernel", pair6,
             "ell_settle_commit_batch", "src/repro/kernels/ell_relax.py:97",
             launches),
            ("ell_settle_push_batch", "settle_push_kernel", pair6,
             "ell_settle_commit_batch", "src/repro/kernels/ell_relax.py:97",
             launches),
            ("ell_sliced_settle_push_batch", "settle_push_kernel", pair16,
             "ell_sliced_settle_commit_batch",
             "src/repro/kernels/ell_relax_keys.py:311",
             sliced_serve["instatic|outstatic"][0]),
            ("ell_settle_tail_batch", "settle_tail_kernel", pair6,
             "ell_settle_commit_batch", "src/repro/kernels/ell_relax.py:97",
             launches))
    ] + [
        # #5c / #9c: delta's relax, both turns in one push along the
        # out-view, on phase 20's delta phase; launches: delta serving's.
        # Each replaces the two gathers of #5 / #9 a delta phase ran
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": replaces, "launches": by_path[f"delta_serving_{what}"][
             name],
         "max_abs_err": errs[name], "ms": delta_push[what]["ms"],
         "plain_ms": delta_push[what]["plain_ms"],
         "bound_ms": delta_push[what]["bound_ms"],
         "bound_by": delta_push[what]["bound_by"], "library_ms": None,
         "gathers_ms": delta_push[what]["gathers_ms"],
         "active_rows": delta_push[what]["active_rows"],
         "candidates": delta_push[what]["candidates"],
         "atomics": delta_push[what]["atomics"],
         "turn_candidates": delta_push[what]["turn_candidates"],
         "delta_ms_phase_turns": delta_turns[what],
         "resident_view_bytes": delta_bytes[what]}
        for name, replaces, what in (
            ("ell_delta_push_batch", "src/repro/kernels/ell_key_min.py:86",
             "padded"),
            ("ell_sliced_delta_push_batch",
             "src/repro/kernels/ell_relax_keys.py:311", "sliced"))
    ] + [
        # delta's committed phase, which redesigns #5c / #9c and #2 on
        # delta's path: each of its four launches timed by kernel on phase
        # 20's real delta phase, in turns with the parent's phase (#2 on the
        # bucket ids, #5c / #9c and the PyTorch glue); launches: phase 20's
        # delta serving, padded (the sliced serving's beside the layouts'
        # shared threshold, mark and tail)
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "kernel": kern,
         "launches": by_path[f"delta_serving_{what}"][name],
         "max_abs_err": errs[name], "ms": dpair[what]["ms"][kern],
         "plain_ms": dpair[what]["plain_ms"][kern],
         "bound_ms": dpair[what]["bounds"][kern][0],
         "bound_by": dpair[what]["bounds"][kern][1], "library_ms": None,
         "pair_ms": sum(dpair[what]["ms"].values()),
         "parent_phase_ms": dpair[what]["parent_ms"],
         "parent_crit_ms": dpair[what]["parent_crit_ms"],
         "parent_push_ms": dpair[what]["parent_push_ms"],
         "parent_glue_ms": dpair[what]["parent_glue_ms"],
         "light": dpair[what]["light"], "heavy": dpair[what]["heavy"],
         "worklist_entries": dpair[what]["entries"],
         "candidates": dpair[what]["candidates"],
         "delta_ms_phase_turns": delta_turns[what],
         **({"sliced_launches": by_path["delta_serving_sliced"][name],
             "sliced_phase_ms": dpair["sliced"]["ms"][kern],
             "sliced_phase_bound_ms": dpair["sliced"]["bounds"][kern][0]}
            if what == "padded" else {})}
        for name, kern, what, source, replaces in (
            ("delta_thresholds_batch", "delta_crit_kernel", "padded",
             "src/repro_torch/kernels/csrc/frontier_crit.cu",
             "src/repro/kernels/frontier_crit.py:94"),
            ("ell_delta_settle_mark_batch", "delta_settle_mark_kernel",
             "padded", "src/repro_torch/kernels/csrc/ell_push.cu",
             "src/repro/kernels/ell_key_min.py:86"),
            ("ell_delta_settle_push_batch", "delta_settle_push_kernel",
             "padded", "src/repro_torch/kernels/csrc/ell_push.cu",
             "src/repro/kernels/ell_key_min.py:86"),
            ("ell_sliced_delta_settle_push_batch",
             "delta_settle_push_kernel", "sliced",
             "src/repro_torch/kernels/csrc/ell_push.cu",
             "src/repro/kernels/ell_relax_keys.py:311"),
            ("ell_delta_settle_tail_batch", "settle_tail_kernel", "padded",
             "src/repro_torch/kernels/csrc/ell_push.cu",
             "src/repro/kernels/ell_key_min.py:86"))
    ] + [
        # #1b in its rectangular form, the sharded stepper's relax and key
        # scans; it stands for the reference's shard-local XLA segment_min
        # (no pallas_call). Launches: rank 0's, the default reduce_scatter
        # solve of phase 26's gloo world
        {"name": "ell_push_rect_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": "src/repro/core/distributed.py:590",
         "launches": sharded_launches["ell_push_rect_batch"],
         "max_abs_err": errs["ell_push_rect_batch"], "ms": rect_ms,
         "plain_ms": rect_plain_ms, "bound_ms": b26, "bound_by": by26,
         "library_ms": None, "square_push_ms": rect_sq_ms,
         "active_rows": active26, "candidates": cand26},
        # the lookup's gradient of the LM's training step (#12): no
        # pallas_call; it replaces the order XLA gives jnp.take's gradient.
        # Launches: phase 28's (the timed run, its resume, the profiled
        # step); timed at phase 28's shapes; index_add_ is PyTorch's one
        # call for it (atomics: its order changes from run to run)
        {"name": "embed_grad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/embed_grad.cu",
         "replaces": "src/repro/models/transformer.py:211",
         "launches": lm_counts["embed_grad"],
         "max_abs_err": embed_row["max_abs_err"], "ms": embed_row["ms"],
         "plain_ms": embed_row["plain_ms"], "bound_ms": embed_row["bound_ms"],
         "bound_by": embed_row["bound_by"],
         "library_ms": embed_row["library_ms"],
         "shape": [embed_row["tokens"], embed_row["rows"], embed_row["d"]],
         "longest_run": embed_row["longest_run"]},
        # #12's block form: a rank's rows of the vocabulary-parallel
        # embedding (phase 29's tensor-parallel steps launch it; its
        # launches are rank 0's of the 2 x 2 world); timed in phase 30 at
        # the pod's train_4k shapes
        {"name": EMBED_BLOCK, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/embed_grad.cu",
         "replaces": "src/repro/models/transformer.py:211",
         "launches": lm29_rank0[EMBED_BLOCK],
         "max_abs_err": eblock["max_abs_err"], "ms": eblock["ms"],
         "plain_ms": eblock["plain_ms"], "bound_ms": eblock["bound_ms"],
         "bound_by": eblock["bound_by"], "library_ms": eblock["library_ms"],
         "shape": [eblock["tokens"], eblock["rows"], eblock["d"]],
         "row0": eblock["row0"], "tokens_in_block": eblock["tokens_in_block"],
         "longest_run": eblock["longest_run"]},
    ]
    # phase 30: the dry run's SSSP phase on rank 0 of the fake pod
    for row in kernels:
        if row["name"] in ("ell_push_rect_batch", "frontier_crit_lanes_batch"):
            row["launches_phase30"] = {
                sch: r["launches"].get(row["name"], 0)
                for sch, r in dry30["sssp"].items()}
    # #5 and #9 on delta's weight-gated views, light and heavy gates of one
    # real delta phase (phase 20)
    for row in kernels:
        layout = {"ell_key_min_batch": "padded",
                  "ell_sliced_gather_min_batch": "sliced"}.get(row["name"])
        if layout is not None:
            row["delta_gated"] = {
                side: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                       "bound_by": t[3], "stream_bound_ms": t[4]}
                for side, t in delta_rows[layout].items()}
    for row in kernels:  # each kernel's launches on this slice's paths
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
    # each row's __global__ kernels (its contract's) with their ptxas
    # resources: the most registers and static shared bytes among them and
    # their spilled bytes (stores + loads)
    contracts = collect_contracts()
    pair_contract = {
        "ell_sliced_settle_push_batch": "ell_sliced_settle_commit_batch",
        "delta_thresholds_batch": "delta_thresholds_batch",
        "ell_delta_settle_mark_batch": "ell_delta_commit_batch",
        "ell_delta_settle_push_batch": "ell_delta_commit_batch",
        "ell_sliced_delta_settle_push_batch": "ell_sliced_delta_commit_batch",
        "ell_delta_settle_tail_batch": "ell_delta_commit_batch"}
    for row in kernels:
        name = row["name"].replace("[out_view]", "_push").replace(
            "[block]", "")
        if "kernel" in row:  # one launch of the pair: its contract's kernel
            name = pair_contract.get(name, "ell_settle_commit_batch")
        used = {f"{src}.cu:{k}": resources[src][k]
                for src, k in contracts.get(name).kernels
                if row.get("kernel", k) == k}
        row["registers"] = max(r["registers"] for r in used.values())
        row["smem_bytes"] = max(r["smem_bytes"] for r in used.values())
        row["spills"] = sum(r["spill_stores"] + r["spill_loads"]
                            for r in used.values())
        row["global_kernels"] = sorted(used)
    # phase 25: the split / fused ms a phase, events beside the host clock
    for row in kernels:
        if row["name"] in timer_rows:
            row["measure_launch_ms"] = dict(zip(("events", "host"),
                                                timer_rows[row["name"]]))
        fused_of = {"ell_relax_keys_batch": "padded",
                    PUSH_IN_SCAN: "sliced"}.get(row["name"])
        if fused_of is not None:  # in|out ms/phase, split against fused
            row["in_out_ms_phase"] = fusion[fused_of][0]
    phase_mark(None)
    print(json.dumps({"lm_serving": lm27}), flush=True)
    print(json.dumps({"lm_training": lm28}), flush=True)
    print(json.dumps({"lm_mesh": lm29}), flush=True)
    print(json.dumps({"dry_run": dry30}), flush=True)
    print(json.dumps({"examples": ex31}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
