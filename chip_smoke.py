#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of PilotDB (``src/repro_torch``) on one NVIDIA
card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
2. build   — ``nvcc`` builds every kernel from the checkout's sources, all
             started together; build seconds and, per kernel, the registers,
             spills and static shared memory that ptxas reports; and, from
             ``cuobjdump -sass``, the column kernels' load rounds
             (``repro_torch.kernels.sass``: the LDGs issued before each first
             use of a loaded register).  Each op has one kernel, instantiated
             for k = 1, 2, 4 blocks per warp and for bool columns or none,
             that serves solo and batched calls; the script fails if a
             library holds another column kernel or an instantiation waits
             more than two rounds.
3. kernels — each hand-written kernel against its plain PyTorch version on
             the card (block_rows 32 / 100 / 256; empty blocks, padding ids,
             an int32 filter column, rows on a bound): counts exact, sums
             within rtol 1e-5, two launches bitwise equal.  The solo column
             kernels at every blocks-per-warp k they can take must give
             bitwise the same output (Q6's aliased columns, y absent, a bool
             x, COUNT-only; 1,027 ids with zero padding, a multiple of no
             k x 8).  The batched
             calls run B = 3 lanes (own ids and bounds per lane): bitwise one
             output at every k, and each lane bitwise a solo launch on that
             lane's ids and bounds.  The launch floor: an empty kernel on grids of 1 to
             8,192 CTAs of 256 threads, timed like the kernels.
4. main    — the port's main path at TPC-H SF10 lineitem cardinality
             (60M rows, block_rows 32, 1.875M blocks, ~2.2 GB on the card):
             Session.sql for the quickstart Q6 query and a filterless
             SUM/COUNT query, each with and without ERROR 5% CONFIDENCE 95%.
             The launch counters are zeroed just before and read just after;
             both kernels must have launched, every query must finish, and
             each approximate answer must lie within 5% of the exact one
             (or carry a fallback).  The exact Q6 answer is checked against
             an f64 numpy sum of the same data.  Every sampled scan draws
             its blocks on the card: one block_draw launch a pilot draw and
             a final, and each final's ids bitwise draw_block_ids; then
             the draw at 1,875,000 and 9,375,000 blocks and those runs'
             rates, bitwise the host draw at three seeds, one graph node a
             call, timed beside its issue bound, its launch floor, its
             plain version, the host draw and the whole device draw (the
             kernels line's block_draw row).  Prints the pilot, rate-solve,
             final and exact wall times (median of 5 warm runs), the scanned
             fraction, and the exact/approx wall ratio.  The session's result
             cache is off (seeds derive from query content, so every warm
             re-run would otherwise be a cache hit and time nothing).
             Every solo kernel call of that first run is recorded (its
             inputs, first call per shape) and replayed: the kernel against
             its plain version (counts exact, sums rtol 1e-5), then timed
             with CUDA events, L2 flushed before every launch, beside its
             plain version, its bytes bound computed from those inputs and
             the launch floor of its grid; and once more at n_phys = 65,536
             as a scaling point.  Then each solo kernel at every k on 1,024
             to 262,144 sampled blocks of the SF10 table (the k sweep that
             kernels/column_launch.py's choice rests on).
5. devices — at 200k rows a CUDA session and a ``device="cpu"`` session of
             the port, equal seeds, result cache off: equal pilot draws,
             final block ids and fallback; rates within rtol 1e-6; answers
             within rtol 1e-5.
6. drain   — the serving path, run right after phase 4 on its SF10
             catalog: a herd of 8 constant-varied Q6 windows and SUM/COUNT
             at ERROR 5/6/7/8 %,
             Session.submit then one drain() on the default config (worker
             threads, shared pilots, batched finals, result cache).  Counters
             zeroed just before, read just after: both batched kernels must
             have launched; 9 pilot stages, the 8 Q6 windows' as ONE stacked
             call (one filtered_agg_batched launch of 8 lanes, no solo
             filtered_agg launch: filtered_agg_batched 2 a drain) and the
             SUM/COUNT pilot solo, so 2 pilot host copies a drain (lanes per
             stacked launch and copies printed); every answer bitwise equal to an
             equal-seed serial session's Session.sql on the card, and within
             5% of the exact answer (or carrying a fallback); a second drain
             serves all 12 from the result cache with no kernel launch.
             Every batched kernel call of the first drain is recorded and
             replayed as in phase 4: against its plain version, each lane
             bitwise a solo launch on that lane's ids and bounds, timed
             beside B solo launches, its plain version and its bytes bound;
             and once more at B = 8 lanes of n_phys = 512 and of 65,536; then
             each batched kernel at every k on 8 lanes of 512, 4,096 and
             65,536 blocks (the batched k sweep).  Then the
             herd's wall four ways, in turns, 5 times each, cache off: the
             default drain (group worker threads), the same with a 4-thread
             pilot pool, the drain inline (no worker threads), and the
             serial Session.sql loop; and the device idle share of one drain
             under torch.profiler.
8. gather  — the gather route (run right after phase 6 on its SF10
             catalog, lineitem 60M rows and orders 15M): Session.sql with
             the result cache off for the grouped Q1, the join with orders
             and the Q14 ratio of examples/aqp_analytics.py, exact and at
             ERROR 5% CONFIDENCE 95% (and, where 5% falls back, at the
             smallest of 10 / 15 % that reaches a sampled final).  The
             segment_sum counter is zeroed just before and read just
             after: each of the three paths must have launched it, and
             every approximate answer must lie within its error of the
             exact one for every group present, or carry a fallback.
             Prints plan or fallback, pilot / rate-solve / final and exact
             walls (median of 5 warm runs, 3 for the join), the scanned
             fraction, the device idle share of each query under
             torch.profiler (not of the approximate join), and for the join
             the pair tensor's bytes on the card and the host's peak RSS.  A grouped drain herd (4
             constant-varied WHERE l_shipdate < X GROUP BY l_returnflag):
             its 4 pilots stacked into ONE segment_sum launch (slab route;
             its input recorded and replayed with the others), its finals
             take gather_batched, and each answer is bitwise an equal-seed
             serial session's Session.sql.  Each query prints its exact
             and approximate walls beside their device idle share.  Every
             segment_sum input of the first pass (first call per shape,
             with its slab claim) is replayed: its route printed (slab for
             the pilots, few for the finals and exact scans; the script
             fails if one takes the sorted route), bitwise equal across two
             launches, empty segments exactly 0, within rtol 1e-5 of an f64
             sum, and held to its plain version (index_add_, which also
             checks the slab claim) and to the sorted route's sums on the
             same input within the f32 summation bound of both; then timed
             (CUDA events, L2 flushed) beside its bytes bound, the launch
             floor of its route's grids, the sorted route, the stable sort
             alone, the plain version and index_add_ alone.  The sorted
             route is also held and timed at a fixed input of its own
             (SORTED_POINT), so all three routes run on the card.
9. staged + shards — the sample catalog and the shard executor (run right
             after phase 8 on its SF10 lineitem): equal-seed sessions (seed
             42, result cache off) with lineitem registered plain, with
             ``staged_rates=True`` (1 / 4 / 16 %), with ``shards=4``, with
             both, and with 1, 2 and 7 shards for invariance; each answers
             Q6, SUM/COUNT and the grouped Q1 at ERROR 5% CONFIDENCE 95%
             through Session.sql, and the phase-6 herd drains on the staged
             session.  Counters zeroed before and read after each session:
             filtered_agg, block_agg and segment_sum must launch in the
             staged and the sharded sessions; every staged query must hit
             its ladder; each staged pilot's and final's route must be the
             fresh plan's (Q6 filtered_agg, SUM/COUNT block_agg, Q1
             gather).  Staged answers must be bitwise the same session's
             after its rungs are dropped (mono and 4 shards); 1 / 2 / 4 / 7
             shards bitwise one answer, within rtol 1e-5 of the monolithic
             session's; every answer within 5% of exact or a fallback; the
             herd's answers bitwise their Session.sql.  Shards go
             round-robin over every visible card (shard i on cuda:{i % k});
             each registration's bytes are accounted per card: the views on
             lineitem's card allocate nothing, every other card exactly its
             shard copies.  Prints the ladder's
             build seconds and bytes, each sharded registration's seconds and
             device bytes per card, the host draw a staged pilot no longer pays beside
             the memo hit, the walls of plain, staged and 4-shard sessions
             (median of 5 warm runs, in turns) beside their device idle
             share, and the card's peak memory.  Every kernel input of the
             phase (first call per shape) is replayed against its plain
             version and timed, and joins the ``kernels`` line.  The sharded
             join is left out at SF10 (a dense pair tensor per shard); the
             card tests hold it at a small size.
10. fused + quickr + eager — (run right after phase 9 on its SF10
             lineitem) equal-seed sessions (seed 42, result cache off) with
             and without ``SessionConfig(fused_taqa=True)`` answer Q6 and
             SUM/COUNT at ERROR 5% CONFIDENCE 95% through Session.sql.  The
             counters are zeroed just before and read just after the fused
             session's first pass: taqa_solve_rate and taqa_draw_compact must
             have launched, each query must have taken the fused program,
             and every fused answer must be bitwise the two-stage one and
             within 5% of exact (or carry a fallback).  Prints the launches
             and dispatches per query, the walls (median of 5 warm runs, in
             turns) split into pilot / rate solve / final, how often the
             verified solo re-run fired, each mode's device idle share, and
             the host draws the fused path makes.  Each taqa kernel input of
             the first pass (first call per shape) is replayed, then
             scaling points (the solve at 8 and 64 channels over 1,024
             blocks; the draw at 18,750,000 uniforms, more tiles than
             resident CTAs, and at theta 0.3): the solve's theta and flags
             and the draw's nsel and ids bitwise their plain versions and
             a second launch, each call one kernel node in a CUDA graph
             (``kernels/graph_nodes.py``); then timed (CUDA events, L2
             flushed) beside its plain version, its bound, the launch
             floor of its one grid and, for the draw, torch.nonzero(u <
             theta) plus the zero fill.  Then Quickr
             (core/quickr.RowSamplingAQP, row sampling on the gather route)
             against PilotDB on Q6 at ERROR 10% CONFIDENCE 95%
             (benchmarks/bench_quickr.py's setting), 2 runs each in turns:
             walls, scanned fraction, achieved error (within 10% or a
             fallback).  Last, one 1%-block-sampled Q6 through
             ``Executor(use_compiled=False)`` against the compiled route:
             the same draw, counts equal, sums within rtol 1e-5.
11. obs     — streaming, tracing, audit and telemetry (run right after phase
             10 on its SF10 lineitem): equal-seed sessions (seed 42, result
             cache off, async_workers=2) with every hook off and with every
             hook on (tracing, audit, telemetry, trace_sample 1.0, a flight
             recorder under build/obs/, one SLO target).  The hooks-on
             session answers Q6 and SUM/COUNT at ERROR 5% CONFIDENCE 95%
             through Session.sql(stream=True), and phase 6's herd plus the
             grouped Q1 through submit(stream=True) + drain(); a fused
             session answers Q6 and a cache-on session re-issues it.
             Counters zeroed just before and read just after: filtered_agg,
             block_agg, both batched kernels, segment_sum and both taqa
             kernels must have launched.  The script fails on an answer that
             is not bitwise the hooks-off session's, a final frame that is
             not the handle's answer bitwise, a pilot frame after its final,
             an audited answer whose observed error exceeds the promise, a
             span shorter than the stage time its TaqaReport records, or a
             flight-recorder log that, replayed, does not rebuild the live
             time-series.  Prints the walls of off, stream-only, all hooks
             but the audit, and all hooks (median of 15 in turns after an
             untimed round, the median paired difference from off, and the
             least wall; the sql queries and the herd's drain), the time
             from submission to the
             pilot frame and to the final frame, each span against
             TaqaReport's pilot / rate-solve / final times, the audit's
             exact-scan wall, the recorder's events and bytes, and the
             device idle share of one traced query.
12. serve   — serving, both users' fronts.  (a) The SQL gateway (run right
             after phase 11 on its SF10 lineitem): ``SqlGateway`` over a
             session (seed 42, telemetry on); 4 clients post phase 6's herd
             through submit and a fifth streams it through submit_streaming,
             one run().  Counters zeroed just before and read just after:
             block_agg and both batched kernels must launch and solo
             filtered_agg must not (the Q6 pilots stack); every answer bitwise an
             equal-seed Session.sql's with the result cache off; each
             streamed ticket one pilot frame, then a final frame bitwise its
             answer; 9 pilots.  Then warm rounds (every ticket a result-cache
             hit, counted; no launch), one client's herd through the gateway
             against the session's own drain of it (cache cleared, 5 each in
             turns), the device idle share of one round, a gateway of
             max_pending 4 refusing the fifth submission with
             BackpressureError, stats_payload() and metrics_text() carrying
             the gateway's counters, and write_dashboard's page under
             build/serve/ (sparklines, one row per template).  Each column
             kernel input of the cold round is replayed as in phases 4 and 6.
             (b)-(d) LM serving (run before phase 7): hymba-1.5b at full
             width in bf16 (phase 7's weights): prefill over 1,536 tokens
             (past the 1,024 window: the ring rolls), 32 decode steps against
             the forward over 1,568 tokens, in bf16 and on the same weights in
             f32 (f32: mean |diff| / mean |logit| <= 1e-3, argmax all but one;
             bf16: max |diff| <= 3x the bf16 forward's own distance from the
             f32 forward, argmax agreement >= n (2a - 1) - 3); flash and GLA
             launch 32 times each in the prefill; ServeEngine(batch_slots=8,
             cache_len=2048) over 16 requests (prompts 8-128, 32-64 new
             tokens), every request served, request 0 re-served alone in a
             fresh 8-slot engine gives the same tokens; tokens/s, the median
             decode step beside its bytes bound, one step's idle share.
             granite-moe-1b-a400m at full width in bf16: a forward over 2,048
             tokens through moe_ffn (capacity 640; the aux loss), prefill
             1,024 and 16 decode steps against the forward at a dropless
             capacity, checked as above; ServeEngine(batch_slots=4) over 8
             requests.  Small f32 hymba and granite-moe at head_dim 64 on the
             card against the CPU port: prefill 24 and 16 decode steps,
             logits within 1e-4.  Each flash and GLA input of the bf16
             prefills is replayed like phase 3b.
3b. model kernels — flash_attention and gla_chunked (run right after phase
             3) at fixed scaling points in bf16: flash at hymba's width (2 x 25
             q heads over 5 kv heads, 2048 tokens, d 64) causal without a
             window and non-causal, and at internlm2's d 128; GLA at an rwkv6
             point (64 heads, dk = dv = 64).  Each against its plain version
             (bf16 flash rtol 1e-2 atol 1e-4, one bf16 step; GLA o 2e-2 and
             state 3e-3), a second launch
             bitwise equal, then timed beside its plain version, the library
             call (flash: scaled_dot_product_attention with the same mask)
             and its bound (flops at the type's dense peak or bytes at 3.35
             TB/s, whichever is larger, from the work these inputs need) and
             the launch floor of its grids (``model_grids``), as every
             model-kernel input of phases 7, 12, 14 and 15 is.
7. eval    — the eval path (after phase 12): hymba-1.5b at full width in bf16,
             random weights from a seeded torch.Generator, 128 token shards of
             2 x 2048 (examples/torch_approx_eval.py's metric: summed NLL),
             GuaranteedEvaluator(seed=3).evaluate(error=0.05,
             confidence=0.9, pilot_blocks=16), counters zeroed just before
             and read just after (32 launches of each kernel per shard
             forward), then the exact mean over all shards as the yardstick:
             the achieved error must be <= 5 % or carry the exact fallback.
             Prints pilot / plan / final / exact walls, ms per shard forward,
             tokens/s and the device idle share of one forward; checks one
             full-width forward against the same forward through the plain
             versions, and a small f32 hymba on the card against the CPU.
             The first call per shape of each model kernel is recorded and
             replayed like phase 3b.

13. train   — training (after phase 7): (a) per kernel of the two backward
             libraries, from ``cuobjdump -sass`` and ptxas: HGMMA and UTMALDG
             counts (both > 0 in the bf16 flash kernels), RED / ATOM (none
             anywhere), registers and spills (none in a bf16 kernel); the
             flash and GLA backward kernels
             against their plain backward versions on the same inputs
             (flash at internlm2's (1, 16, 4096, 128) causal and hymba's
             (1, 25, 2048, 64) window 1024, and Sq 1 / 65 / 127 / 129 / 200
             with GQA 1, 2, 5, windows across a 128-row tile, d 64 and 128;
             GLA at (1, 25, 2048, 16 / 64) and (1, 64, 2048,
             64 / 64), T 130 and 200, decays below -8 and on both bounds,
             with and without a final-state gradient), bf16 and f32: f32
             within 1e-4 of the call's largest plain gradient, bf16 within 3x
             the plain bf16 backward's own distance from the plain f32 one;
             two launches bitwise equal; the forward's lse within 1e-5 and o
             bitwise unchanged by asking for it.  (b) internlm2-1.8b at full
             width (24 layers, d 2048, 1,889,110,016 parameters, bf16) through
             ``launch.train.main`` for 10 steps of 2 x 4096 tokens with
             ``--lr 3e-4 --aqp-mixture --approx-eval`` (the default 3e-3
             overshoots at full width; every phase-13 run takes 3e-4): losses finite and falling, 24
             backward and 48 forward flash launches a step (remat), the
             mixture weights from a sampled plan and the eval estimate
             printed, segment_sum launched; median step ms (p10, p90),
             tokens/s, MFU against 989 TFLOP/s, one step's device idle share
             and top kernels under torch.profiler, peak device memory.  (c)
             one step's gradients at full width with depth cut to 2 layers:
             per leaf, ||kernels - plain|| / ||plain|| within 3x the plain
             bf16 step's own distance from a plain f32 step.  (d) hymba-1.5b
             at full width, 5 steps of 2 x 2048 through make_train_step: the
             same checks on one batch stepped on 5 times (fresh batches'
             spread hides the fall at this lr), GLA's backward launched 32
             times a step.  (e)
             internlm2 at full width, 2 layers: 4 steps with a checkpoint at
             step 2 (the reference's layout, under build/train_ckpt, removed
             after), restored into a fresh state: steps 3-4 bitwise the
             uninterrupted run's, losses and parameters; microbatches 2 vs 1
             within 2^-7; 3 compressed steps falling.  Each backward
             kernel's recorded training input (first call per shape) is then
             timed beside its plain version, SDPA's backward (flash), its
             bound and the launch floor of its grids; and GLA's backward at
             the rwkv6 point (1, 64, 2048, 64 / 64) bf16.
14. families — (run after phase 13) whisper-large-v3 (encoder-decoder:
             2 encoder layers over 1,500 frames, 448 text tokens),
             llava-next-34b (VLM: 576 patches before 512 text tokens) and
             gemma-7b (head_dim 256, 2,048 tokens), each at full width in
             bf16 with 2 decoder layers, seeded random weights, batches
             from ``launch.specs.batch_specs``: prefill + 32 decode steps
             against the teacher-forced forward at batch 1 (the phase-12
             check; gemma's f32 pass attends through the plain version,
             since f32 has no d 256 kernel); 3 make_train_step steps at
             batch 2 on one batch, losses finite, the flash launches 2 x and
             its backward 1 x the attention calls of a forward a step
             (encoder, decoder and cross attention), step wall, tokens/s
             and peak memory; then every flash input of the first step
             (first per q and k shape: whisper's encoder, causal decoder
             and Sq != Skv cross attention) against its plain version and
             timed beside SDPA, its bound and its launch floor, forward and
             backward (the backward held as phase 13 (a) holds it).
15. reduced — (after phase 14) every text config's ``.reduced()`` (head_dim
             16, GLA (8, 16), f32) on the card through ``launch.serve
             --reduced`` (8 requests served) and ``launch.train --reduced
             --steps 3`` (losses finite; flash and GLA forward twice and
             backward once a layer a step); then each reduced-width kernel
             input (first per q and k shape), forward and backward, held to
             its plain version and timed beside its bound and launch floor.
16. remat  — (last) internlm2-1.8b at full depth (24 layers), 2 x 4,096
             tokens, ``remat_groups`` 4 against per-block remat from the
             same weights and batches: the parameters after one step bitwise
             equal and both steps' losses equal; each run's second-step wall
             and peak device memory.
17. mesh   — (last) the device mesh, on a one-rank NCCL group (a
             ``HashStore``, no network) and ``launch.mesh.make_host_mesh``:
             (a) internlm2-1.8b at full width cut to 2 layers, bf16, 2 x 4,096
             tokens in 2 microbatches, 3 steps with the state sharded by
             ``train.sharding`` (DTensor parameters and moments, the dry run's
             hints) against 3 unsharded steps from the same weights and
             batches: losses and parameters bitwise, flash launches equal and
             > 0, each run's median step and peak memory; (b) the sharded
             state checkpointed at step 2 (``build/mesh_ckpt``, removed) and
             restored with ``shardings`` into a fresh sharded state and into an
             unsharded one: step 3 bitwise the uninterrupted run's; (c)
             ``launch.dryrun.lower_cell`` of (a)'s configuration on a fake
             (1, 1) mesh: FLOPs equal to ``TraceAnalysis`` over the card's
             step, peak within 15 % of the card's; (d) the dry run of
             internlm2-1.8b x train_4k and x decode_32k and mistral-large-123b
             x train_4k on the fake (16, 16) production mesh (one process
             each, started with (a), on the host: fake tensors): status ok,
             each roofline row at the H100's peaks and the dry run's wall.

Then one JSON line of per-kernel numbers, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; so it does, printing no result, when there is no CUDA
device or no ``src/repro_torch`` beside it.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
SF10_ROWS = 60_000_000           # TPC-H SF10 lineitem cardinality
BLOCK_ROWS = 32
SCALE_N_PHYS = 65_536            # a large final: the kernels' scaling point
SCALE_BATCH = 8                  # lanes of the batched scaling points
SCALE_BATCH_N_PHYS = (512, SCALE_N_PHYS)  # a herd-sized final bucket; a large one
# the batched kernels at every k, SCALE_BATCH lanes of this many sampled blocks
K_SWEEP_BATCH_N_PHYS = (512, 4_096, SCALE_N_PHYS)
# the solo kernels at every blocks-per-warp k, on this many sampled blocks
K_SWEEP_N_PHYS = (1_024, 2_048, 4_096, 8_192, 16_384, 32_768, SCALE_N_PHYS, 262_144)
WARM_RUNS = 5
# the block draw at the benchmark's block counts (SF10, and the SF100 cell's
# half table), at seeds above 2**31 as the benchmark's are
SF100_BLOCKS = 9_375_000
DRAW_SEEDS = (3_500_000_001, 2 ** 31 + 7, 4_100_000_019)
# block_draw's issue bound (csrc/block_draw.cu): a step of its chunk loop is
# 36 SASS instructions, issued at 4 warp-instructions a clock an SM
DRAW_STEP_INSTRUCTIONS = 36
SM_CLOCK_HZ = 1.98e9             # H100 SXM boost clock

Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
      "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08")
SUM_COUNT = "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem"
GUARANTEE = " ERROR 5% CONFIDENCE 95%"
# phase 6: a dashboard herd — constant-varied Q6 windows and SUM/COUNT at
# several error targets
HERD = ([f"SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
         f"WHERE l_shipdate BETWEEN {100 + 50 * i} AND {1500 + 30 * i} AND "
         f"l_discount BETWEEN 0.02 AND 0.08" + GUARANTEE for i in range(8)]
        + [SUM_COUNT + f" ERROR {e}% CONFIDENCE 95%" for e in (5, 6, 7, 8)])
HERD_PILOTS = 9                  # 8 Q6 constants + 1 shared SUM/COUNT pilot
HERD_Q6 = 8                      # the Q6 windows, whose pilots stack into one call
REPS = 5                         # timed repetitions of each drain mode
# phase 8: the three gather-route queries of examples/aqp_analytics.py
GATHER_QUERIES = {
    "q1": ("SELECT SUM(l_quantity) AS qty, AVG(l_extendedprice) AS avg_price, "
           "COUNT(*) AS orders FROM lineitem GROUP BY l_returnflag"),
    "join": ("SELECT SUM(l_extendedprice) AS rev FROM lineitem "
             "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate < 1200"),
    "q14": ("SELECT SUM(l_extendedprice * l_discount * l_linestatus) / "
            "SUM(l_extendedprice * l_discount) AS promo_share FROM lineitem "
            "WHERE l_shipdate BETWEEN 400 AND 2200"),
}
GATHER_ERRORS = (5, 10, 15)      # ERROR e% tried in turn until a sampled final
GATHER_WARM = {"q1": 5, "join": 3, "q14": 5}
# segment_sum at a fixed input that only its sorted route takes (S * C
# above the few route's 4,096 sums): 3 channels of 1M rows over 100,000 keys
SORTED_POINT, SORTED_SEED = (3, 1_000_000, 100_000), 5
GATHER_HERD = [f"SELECT SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
               f"WHERE l_shipdate < {x} GROUP BY l_returnflag" for x in (1800, 2000, 2200, 2400)]
# phase 9: the queries each staged / sharded session answers, and the route
# each must take on a rung as on a fresh draw
STAGED_QUERIES = {"q6": Q6, "sum_count": SUM_COUNT, "q1": GATHER_QUERIES["q1"]}
STAGED_ROUTES = {"q6": "filtered_agg", "sum_count": "block_agg", "q1": "gather"}
SHARDS = 4                       # the timed sharded session; 1, 2, 7 for invariance
# dense peaks of one H100 SXM at 700 W (data sheet): bf16 tensor cores, f32
# without them
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# phase 10: the fused path's queries; Quickr's error target is
# benchmarks/bench_quickr.py's (the Quickr paper's setting)
FUSED_QUERIES = {"q6": Q6, "sum_count": SUM_COUNT}
QUICKR_ERROR = 0.10
QUICKR_RUNS = 2                  # timed runs each of Quickr and PilotDB, in turns
# phase 11: the sql queries and the herd (phase 6's, plus the grouped Q1,
# whose pilot and final take segment_sum) that the hooks-off and hooks-on
# sessions answer; an SLO target no query should breach
OBS_QUERIES = {"q6": Q6, "sum_count": SUM_COUNT}
OBS_HERD = HERD + [GATHER_QUERIES["q1"] + GUARANTEE]
OBS_SLO_P95_S = 10.0
# timed rounds of phase 11, after one untimed round: single walls on the
# host are bimodal (~21 / ~31 ms for Q6 on an H100 host), so 5 cannot
# resolve a hook's ~1 ms
OBS_RUNS = 15
# phase 7: guaranteed-error evaluation of hymba-1.5b at full width
EVAL_ARCH = "hymba-1.5b"
EVAL_SHARDS = 128                # eval corpus: shards of EVAL_BSZ x EVAL_SEQ tokens
EVAL_BSZ, EVAL_SEQ = 2, 2048     # at 2048 tokens the 1024 window binds
EVAL_SEED = 0                    # the random weights
EVAL_EVAL_SEED = 3               # the evaluator's host draws
EVAL_ERROR, EVAL_CONFIDENCE, EVAL_PILOT_BLOCKS = 0.05, 0.9, 16
# phase 12: serving.  (a) the gateway: 4 clients post phase 6's herd and a
# fifth streams it; the backpressure check's max_pending; rounds of one
# client's herd against the session's drain of it, in turns
GATEWAY_CLIENTS, GATEWAY_PENDING, GATEWAY_RUNS = 4, 4, 5
# (b) hymba-1.5b: a prompt longer than the 1024 window, so the prefill rolls
# the ring; 16 requests of 8-128 prompt and 32-64 new tokens on 8 slots
SERVE_ARCH, SERVE_PREFILL, SERVE_DECODE = "hymba-1.5b", 1536, 32
SERVE_SLOTS, SERVE_CACHE_LEN, SERVE_REQUESTS = 8, 2048, 16
SERVE_PROMPT, SERVE_NEW = (8, 128), (32, 64)
# (c) granite-moe-1b-a400m: moe_ffn over 2048 tokens (capacity 640), a
# prefill of 1024 and 16 decode steps, 8 requests on 4 slots
SERVE_MOE_ARCH, MOE_FORWARD, MOE_PREFILL, MOE_DECODE = "granite-moe-1b-a400m", 2048, 1024, 16
MOE_SLOTS, MOE_REQUESTS, MOE_CACHE_LEN = 4, 8, 256
# (d) small f32 configs at the widths the kernels take, card against CPU:
# f32 on both sides, sums in other orders (phase 7's small forward: 1.4e-5)
SERVE_SMALL = {"hymba-1.5b": dict(head_dim=64, ssm_state=16, sliding_window=16),
               "granite-moe-1b-a400m": dict(head_dim=64)}
SMALL_TOL = 1e-4


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_clocks():
    """The card's SM clock, power draw and temperature now, as nvidia-smi
    reads them (a sustained run may sit below the boost clock)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log):
    """One line per kernel of nvcc's ``-Xptxas=-v`` output: registers per
    thread, stack and spill stores / loads and static shared memory (the
    kernels' tiles are dynamic shared memory, sized in their sources)."""
    from repro_torch.kernels import sass
    return [f"{name}: {u['registers']} registers, stack/spill stores/loads {u['stack']}/"
            f"{u['spill_stores']}/{u['spill_loads']} B, static smem {u['smem']} B"
            for name, u in sass.ptxas_usage(log).items()]


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def random_columns(torch, np, block_rows, n_blocks, seed):
    """Q6-shaped columns with an empty block, rows on the discount bounds, an
    int32 filter column, and ids with repeats and zero padding."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block_rows
    cols = {
        "price": rng.uniform(900.0, 1100.0, n).astype(np.float32),
        "discount": rng.integers(0, 11, n).astype(np.float32) / 100.0,
        "shipdate": rng.integers(0, 2526, n).astype(np.int32),
        "quantity": rng.integers(1, 51, n).astype(np.float32),
    }
    valid = rng.random(n) < 0.9
    valid[5 * block_rows:6 * block_rows] = False
    real = np.concatenate([rng.integers(0, n_blocks, 900), [5, 5, 0]])
    ids = np.concatenate([real, np.zeros(124)]).astype(np.int32)
    dev = torch.device("cuda")
    out = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    out["valid"] = torch.from_numpy(valid).to(dev)
    out["ids"] = torch.from_numpy(ids).to(dev)
    return out


def bitwise_equal(torch, a, b):
    """Equal bit patterns (torch.equal treats the NaN sentinel as unequal)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def compare(torch, name, got, want, count_cols):
    """Counts exact, sums within rtol 1e-5, min/max exact (NaN sentinel
    included).  Returns the max absolute difference."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(torch.equal(got[:, :count_cols], want[:, :count_cols]),
          f"{name}: counts differ from the plain version")
    torch.testing.assert_close(got[:, count_cols:3], want[:, count_cols:3],
                               rtol=1e-5, atol=0, msg=f"{name}: sums differ")
    if got.shape[1] > 3:
        torch.testing.assert_close(got[:, 3:], want[:, 3:], rtol=0, atol=0,
                                   equal_nan=True, msg=f"{name}: min/max differ")
    diff = (got - want).abs()
    return float(torch.nan_to_num(diff, nan=0.0).max())


def lane_ids(np, rng, num_blocks, n_phys, batch, pad=0):
    """(batch, n_phys) int32: per lane sorted distinct ids, the last ``pad``
    entries zero (the padding of pad_block_ids)."""
    rows = []
    for _ in range(batch):
        ids = np.sort(rng.choice(num_blocks, n_phys - pad, replace=False))
        rows.append(np.concatenate([ids, np.zeros(pad, ids.dtype)]))
    return np.asarray(rows, np.int32)


def time_cold(torch, fn, iters=30):
    """Median device ms of ``fn`` with the 50 MB L2 flushed before every
    launch (a sampled scan finds its blocks cold), each launch timed by CUDA
    events.  A device-side sleep queued ahead of the start event keeps the
    card busy while the host enqueues ``fn``, so the events bracket device
    work only, not the wrapper's host overhead."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)   # ~0.5 ms at H100 clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def device_profile(torch, fn, top=12):
    """``device_busy_ms`` plus the ``top`` device kernels by total time:
    [(name, ms, count), ...]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)]
    busy = sum(ev.self_device_time_total for ev in evs)
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in evs),
                  key=lambda r: -r[1])[:top]
    return (busy / 1e3 if busy > 0 else None), wall, rows


def device_busy_ms(torch, fn):
    """(device kernel ms, host wall ms) of one call of ``fn`` under
    torch.profiler, summed like the profiler table's "Self CUDA time total"
    (device-side events only, never the CPU ops that launched them); the
    kernel ms is None when the profiler saw no device time."""
    return device_profile(torch, fn)[:2]


# position of the ids argument in each wrapper's signature
IDS_AT = {"filtered_agg": 7, "filtered_agg_batched": 7,
          "block_agg": 3, "block_agg_batched": 3}


def ids_shape(name):
    """Recording key of a column kernel: the shape of its ids."""
    return lambda args: tuple(args[IDS_AT[name]].shape)


def q_shape(args):
    """Recording key of a model kernel: the shape of its q."""
    return tuple(args[0].shape)


def qk_shapes(args):
    """Recording key of a model kernel whose q may meet keys of another
    length (cross-attention): the shapes of its q and its k."""
    return tuple(args[0].shape), tuple(args[1].shape)


class CallRecorder:
    """Stands in for kernel wrappers where their callers look them up
    (``targets``: (module, attribute, key) triples; install it before
    anything compiles or binds the calls) and, while a wrapper's name is in
    ``active``, keeps every key its calls were made at (``key(args)``, a
    shape) and the inputs ``(args, kwargs)`` of its first call at each key:
    the main path's own kernel inputs, replayed by ``time_kernel`` and
    ``time_model_kernel``.  Every call passes through to the wrapper, whose
    launch counter counts it as before."""

    def __init__(self, targets):
        self.active = set()
        self.shapes, self.calls = {}, {}
        for module, attr, key in targets:
            fn = getattr(module, attr)
            self.shapes[fn.__name__], self.calls[fn.__name__] = [], {}
            setattr(module, attr, self._wrap(fn, key))

    def _wrap(self, fn, key):
        name = fn.__name__

        def recorded(*args, **kwargs):
            if name in self.active:
                shape = key(args)
                self.shapes[name].append(shape)
                self.calls[name].setdefault(shape, (args, kwargs))
            return fn(*args, **kwargs)

        recorded.__name__ = name
        return recorded


def moved_bytes(np, name, args, out):
    """Bytes a wrapper call must move: each distinct column it reads, once
    per distinct sampled row (padding ids repeat block 0), plus the ids, the
    bounds and the output."""
    at = IDS_AT[name]
    ids, block_rows = args[at], args[at - 1]
    cols = {c.data_ptr(): c.element_size() for c in args[:at - 1] if c is not None}
    rows = np.unique(ids.cpu().numpy()).size * block_rows
    small = [ids, *args[at + 1:], out]
    return rows * sum(cols.values()) + sum(t.numel() * t.element_size() for t in small)


def time_kernel(torch, np, name, fn, ref, solo, args, smi, floor):
    """Hold one kernel call against its plain version (and, batched, each
    lane against a solo launch, bitwise), then time the kernel, its plain
    version and (batched) B solo launches with L2 flushed, and the launch
    floor of its grid (``floor(name, args)``).  Returns the row of the
    ``kernels`` line for these inputs."""
    at = IDS_AT[name]
    ids = args[at]
    shape = "x".join(str(d) for d in ids.shape)
    got = fn(*args)
    check(bitwise_equal(torch, got, fn(*args)), f"{name} {shape}: launches differ bitwise")
    k = got.shape[-1]
    err = compare(torch, f"{name} {shape}", got.reshape(-1, k),
                  ref(*args).reshape(-1, k), 1)
    row = {}
    if solo is not None:
        lanes = [(*args[:at], ids[b].contiguous(),
                  *(a[b].contiguous() for a in args[at + 1:]))
                 for b in range(ids.shape[0])]
        for b, lane in enumerate(lanes):
            check(bitwise_equal(torch, got[b], solo(*lane)),
                  f"{name} {shape} lane {b}: not bitwise the solo kernel")
        row["solo_ms"] = time_cold(torch, lambda: [solo(*lane) for lane in lanes])
    ms = time_cold(torch, lambda: fn(*args))
    plain_ms = time_cold(torch, lambda: ref(*args))
    floor_ms, grid, per_warp = floor(name, args)
    nbytes = moved_bytes(np, name, args, got)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    solo_txt = (f"{ids.shape[0]} solo launches {row['solo_ms'] * 1e3:.2f} us, "
                if solo is not None else "")
    print(f"[kernels] {name} ids {shape}: {ms * 1e3:.2f} us ({solo_txt}plain "
          f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us = {nbytes:,} B "
          f"/ 3.35 TB/s, {bound_ms / ms:.1%} of bound; launch floor "
          f"{floor_ms * 1e3:.2f} us on grid {grid}, {per_warp} block(s) per warp); "
          f"max |kernel - plain| {err:.3g}  [{smi}]")
    return {"ids_shape": list(ids.shape), "ms": ms, **row, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bytes": nbytes, "floor_ms": floor_ms,
            "grid": list(grid), "blocks_per_warp": per_warp, "max_abs_err": err}


def time_recorded(torch, np, recorder, kernels, scale_args, smi, floor):
    """``time_kernel`` of every recorded call of ``kernels`` (name -> (fn,
    ref, solo)), then of each scaling point in ``scale_args[name]``.  The
    headline is the recorded call with the most blocks."""
    timed = {}
    for name, (fn, ref, solo) in kernels.items():
        calls = recorder.calls[name]
        check(bool(calls), f"{name}: no call of the main path was recorded")
        rows = [time_kernel(torch, np, name, fn, ref, solo, args, smi, floor)
                for args, _ in calls.values()]
        head = max(rows, key=lambda r: (np.prod(r["ids_shape"]), r["ids_shape"]))
        scale = [time_kernel(torch, np, name, fn, ref, solo, args, smi, floor)
                 for args in scale_args[name]]
        timed[name] = {"headline": head, "main_path": rows, "scaling_points": scale}
    return timed


def every_k_agrees(torch, name, launch, args, ks):
    """The solo launch at each blocks-per-warp k in ``ks``: all bitwise the
    output at the first k.  Returns that output."""
    outs = [launch(*args, k) for k in ks]
    for k, out in zip(ks[1:], outs[1:]):
        check(bitwise_equal(torch, out, outs[0]),
              f"{name}: {k} blocks per warp differ bitwise from {ks[0]}")
    return outs[0]


def k_sweep(torch, name, launch, args_at, sizes, ks, choose, smi, lanes=None):
    """Each launch at every k in ``ks`` on ``args_at(n)`` for n in ``sizes``
    (n_phys; of each of ``lanes`` id rows for a batched launch): {n: {k:
    ms}}, one printed line per n with the wrapper's own choice
    ``choose(n)``."""
    table = {}
    for n in sizes:
        args = args_at(n)
        table[n] = {k: time_cold(torch, lambda: launch(*args, k)) for k in ks}
        best = min(table[n], key=table[n].get)
        size = f"n_phys {n:,}" if lanes is None else f"{lanes} x {n:,}"
        print(f"[main] k sweep {name} {size}: "
              + ", ".join(f"k={k} {ms * 1e3:.2f} us" for k, ms in table[n].items())
              + f"; fastest k={best}, chosen k={choose(n)}  [{smi}]")
    return table


# ---------------------------------------------------------------------------
# phase 4/5 helpers
# ---------------------------------------------------------------------------

def spy(session):
    """Record the pilot draws, the final block ids and the block-sampled
    finals' SampleInfos a session's executor runs."""
    seen = {"pilots": [], "final_ids": [], "finals": []}
    ex = session.executor
    execute, execute_pilot = ex.execute, ex.execute_pilot

    def spy_pilot(plan, table, theta_p, seed, pair_tables=()):
        seen["pilots"].append((table, theta_p, seed))
        return execute_pilot(plan, table, theta_p, seed, pair_tables=pair_tables)

    def spy_execute(plan):
        res = execute(plan)
        seen["final_ids"].append({t: i.sampled_block_ids
                                  for t, i in res.sample_infos.items()})
        seen["finals"] += [i for i in res.sample_infos.values() if i.method == "block"]
        return res

    ex.execute_pilot, ex.execute = spy_pilot, spy_execute
    return seen


def run_sql(torch, session, sql):
    t0 = time.perf_counter()
    h = session.sql(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(h.status == "done", f"query failed: {h.error}\n{sql}")
    return h, wall


def check_block_draw(torch, np, rates, dev, launch_floor, smi):
    """The block draw on the card at SF10's and SF100's block counts, at the
    main path's own pilot and final ``rates``: the main path's entry
    (``draw_block_ids_device``) bitwise ``pad_block_ids(draw_block_ids(...))``
    at every seed of DRAW_SEEDS, ids, count and padded length; the kernel a
    single node in a CUDA graph of a call.  Then, at the first seed, the
    kernel timed (CUDA events, L2 flushed) beside its issue bound, the launch
    floor of its grid, its plain version and the host draw it replaces, and
    the entry's whole wall (state, launch, count read, copy).  Returns the
    rows of the ``kernels`` line."""
    from repro_torch.engine.sampling import (draw_block_ids, draw_block_ids_device,
                                             pad_block_ids)
    from repro_torch.kernels.block_draw import block_draw, block_draw_ref, pcg64_state
    from repro_torch.kernels.block_draw import ops as draw_ops
    from repro_torch.kernels.graph_nodes import captured_node_types
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for n in (SF10_ROWS // BLOCK_ROWS, SF100_BLOCKS):
        for rate in rates:
            for seed in DRAW_SEEDS:
                phys, n_real, n_phys = pad_block_ids(draw_block_ids(n, rate, seed), n)
                d = draw_block_ids_device(n, rate, seed, dev)
                check((d.n_real, d.n_phys) == (n_real, n_phys)
                      and np.array_equal(d.ids_dev.cpu().numpy(), phys),
                      f"block_draw {n:,} blocks at rate {rate} seed {seed}: count "
                      f"{d.n_real} / {n_real} or ids differ from the host draw")
            state, inc = pcg64_state(DRAW_SEEDS[0])
            launch = lambda: block_draw(n, rate, state, inc, dev)
            nodes = captured_node_types(launch)
            check(nodes == ["kernel"], f"block_draw: a call enqueues {nodes}")
            tiles = -(-n // draw_ops.TILE)
            t0 = time.perf_counter()
            ref_count, _ = block_draw_ref(n, rate, state, inc)
            plain_ms = (time.perf_counter() - t0) * 1e3
            host, entry = [], []
            for _ in range(WARM_RUNS):
                t0 = time.perf_counter()
                draw_block_ids(n, rate, DRAW_SEEDS[0])
                host.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                draw_block_ids_device(n, rate, DRAW_SEEDS[0], dev)
                entry.append((time.perf_counter() - t0) * 1e3)
            bound_ms = (n / 32 * DRAW_STEP_INSTRUCTIONS / (4 * sms * SM_CLOCK_HZ)) * 1e3
            row = {"n_blocks": n, "rate": rate, "n_real": int(ref_count),
                   "seeds": list(DRAW_SEEDS), "bitwise": True, "max_abs_err": 0.0,
                   "graph_nodes": nodes, "ms": time_cold(torch, launch),
                   "bound_ms": bound_ms, "bound_by": "instruction issue",
                   "floor_ms": time_cold(torch, lambda: launch_floor(tiles, 1)),
                   "plain_ms": plain_ms, "library_ms": None,
                   "host_draw_ms": statistics.median(host),
                   "entry_wall_ms": statistics.median(entry)}
            rows.append(row)
            print(f"[kernels] block_draw {n:,} blocks at rate {rate:.6g} (n_real "
                  f"{row['n_real']:,}): bitwise the host draw at {len(DRAW_SEEDS)} seeds, "
                  f"one kernel node; kernel {row['ms'] * 1e3:.2f} us, issue bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_ms / row['ms']:.1%} reached), launch "
                  f"floor (1 x {tiles:,} CTAs) {row['floor_ms'] * 1e3:.2f} us; the entry's "
                  f"wall {row['entry_wall_ms']:.3f} ms; host draw_block_ids "
                  f"{row['host_draw_ms']:.2f} ms; plain version (CPU) {plain_ms:.1f} ms  "
                  f"[{smi}]")
    return rows


def zero_counters(wrappers):
    for fn in wrappers:
        fn.launches = 0


def read_counters(wrappers):
    return {fn.__name__: fn.launches for fn in wrappers}


def spy_pilots(ex):
    """Record an executor's pilot dispatches: the solo ones (``execute_pilot``,
    each a host crossing of its block sums and presence) and the stacked
    ones (``execute_pilots_batched``: their lanes, one host copy each)."""
    seen = {"solo": 0, "stacked": []}
    solo, stacked = ex.execute_pilot, ex.execute_pilots_batched

    def spy_solo(*a, **kw):
        seen["solo"] += 1
        return solo(*a, **kw)

    def spy_stacked(plans, *a):
        seen["stacked"].append(len(plans))
        return stacked(plans, *a)

    ex.execute_pilot, ex.execute_pilots_batched = spy_solo, spy_stacked
    return seen


def run_drain(torch, np, catalog, Session, SessionConfig, wrappers, recorder,
              smi):
    """Phase 6: the herd through submit + drain on the default config,
    against an equal-seed serial session on the card."""
    session = Session(catalog, seed=42)
    pilots = spy_pilots(session.executor)
    batched = ("filtered_agg_batched", "block_agg_batched")
    zero_counters(wrappers)
    recorder.active = set(batched)
    t0 = time.perf_counter()
    handles = [session.submit(q) for q in HERD]
    session.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recorder.active = set()
    launches = read_counters(wrappers)
    stats = session.scheduler.last_drain
    buckets = {k: recorder.shapes[k] for k in batched}
    print(f"[drain] {len(HERD)} queries: drain wall {wall * 1e3:.2f} ms; "
          f"launches {launches}; batched launches' ids (B, n_phys) {buckets}  [{smi}]")
    print(f"[drain] {stats}")
    for h in handles:
        check(h.status == "done", f"drain: query failed: {h.error}\n{h.sql}")
    check(launches["filtered_agg_batched"] >= 1,
          "the drain never launched filtered_agg_batched")
    check(launches["block_agg_batched"] >= 1,
          "the drain never launched block_agg_batched")
    check(stats.pilots_run == HERD_PILOTS,
          f"drain ran {stats.pilots_run} pilot stages, expected {HERD_PILOTS}")
    # the 8 Q6 windows' pilot draws share one n_phys bucket at seed 42: ONE
    # stacked call (one filtered_agg_batched launch), no solo filtered_agg
    # launch; the SUM/COUNT pilot runs solo (its drain group has one pilot)
    copies = pilots["solo"] + len(pilots["stacked"])
    print(f"[drain] pilot dispatches: lanes per stacked launch {pilots['stacked']}, "
          f"solo pilots {pilots['solo']}; pilot host copies per drain {copies} "
          f"(one per dispatch)")
    check(pilots["stacked"] == [HERD_Q6] and pilots["solo"] == 1,
          f"drain pilots: stacked {pilots['stacked']}, solo {pilots['solo']}; expected "
          f"[{HERD_Q6}] and 1")
    check(launches["filtered_agg"] == 0 and launches["filtered_agg_batched"] == 2,
          f"drain launches {launches}: expected no solo filtered_agg and two "
          f"filtered_agg_batched (the stacked pilots, the batched finals)")
    check(copies == 2, f"{copies} pilot host copies in a drain, expected 2")

    serial = Session(catalog, seed=42, config=SessionConfig(
        async_workers=0, share_pilots=False,
        result_cache_size=0))
    serial_walls = []
    for h in handles:
        r, w = run_sql(torch, serial, h.sql)
        serial_walls.append(w)
        check(np.array_equal(h.answer.values, r.answer.values),
              f"drain answer {h.answer.values.ravel()} is not bitwise the serial "
              f"session's {r.answer.values.ravel()}\n{h.sql}")
        exact, _ = run_sql(torch, serial, h.sql.split(" ERROR ")[0])
        rel = np.abs(h.answer.values - exact.answer.values) / np.abs(exact.answer.values)
        check(bool(np.all(rel <= 0.05)) or h.fallback is not None,
              f"drain: error {rel.ravel()} above 5% without a fallback\n{h.sql}")
    serial_ms = sum(serial_walls) * 1e3
    # where the drain's time went, from its own reports: the pilot stages
    # (the owners' reports), the rate solves, and each member's final (the
    # time until its bucket or solo final completed)
    reps = [h.report for h in handles]
    split = {"pilot_stages_ms": sum(r.pilot_time_s for r in reps
                                    if not r.pilot_shared) * 1e3,
             "rate_solves_ms": sum(r.plan_time_s for r in reps) * 1e3,
             "finals_max_ms": max(r.final_time_s for r in reps) * 1e3}
    print(f"[drain] stage sums: {split}")
    print(f"[drain] every answer bitwise equal to the serial session's "
          f"Session.sql and within 5% of exact (or a fallback); serial walls sum "
          f"{serial_ms:.2f} ms vs drain {wall * 1e3:.2f} ms; rates "
          f"{[round(h.report.plan.rates['lineitem'], 8) if h.report.plan else None for h in handles]}; "
          f"fallbacks {[h.fallback for h in handles]}")

    # the herd's wall four ways, in turns, result cache off: the default
    # drain (group worker threads), the same with a pilot-subgroup pool, the
    # drain inline on the draining thread, and the serial Session.sql loop —
    # walls on a shared host spread, so each is run REPS times and every run
    # is kept
    modes = {"threaded": {}, "pilot_pool": {"pilot_workers": 4},
             "inline": {"async_workers": 0}}
    runs = {m: {"wall_ms": [], "rate_solves_ms": [], "pilot_stages_ms": []}
            for m in (*modes, "serial_sql")}
    for _ in range(REPS):
        for mode, kw in modes.items():
            s = Session(catalog, seed=42,
                        config=SessionConfig(result_cache_size=0, **kw))
            t0 = time.perf_counter()
            hs = [s.submit(q) for q in HERD]
            s.drain()
            torch.cuda.synchronize()
            runs[mode]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            runs[mode]["rate_solves_ms"].append(
                sum(h.report.plan_time_s for h in hs) * 1e3)
            runs[mode]["pilot_stages_ms"].append(
                sum(h.report.pilot_time_s for h in hs
                    if not h.report.pilot_shared) * 1e3)
            s.close()
        t0 = time.perf_counter()
        hs = [run_sql(torch, serial, q)[0] for q in HERD]
        runs["serial_sql"]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        runs["serial_sql"]["rate_solves_ms"].append(
            sum(h.report.plan_time_s for h in hs) * 1e3)
        runs["serial_sql"]["pilot_stages_ms"].append(
            sum(h.report.pilot_time_s for h in hs) * 1e3)
    for mode, r in runs.items():
        print(f"[drain] {mode}: wall ms {[round(v, 2) for v in r['wall_ms']]} "
              f"(median {statistics.median(r['wall_ms']):.2f}); rate solves "
              f"summed {[round(v, 2) for v in r['rate_solves_ms']]}; pilot "
              f"stages summed {[round(v, 2) for v in r['pilot_stages_ms']]}  [{smi}]")

    zero_counters(wrappers)
    again = [session.submit(q) for q in HERD]
    session.drain()
    cached_launches = read_counters(wrappers)
    check(all(h.cached and h.status == "done" for h in again),
          "the second drain was not served from the result cache")
    check(session.scheduler.last_drain.result_hits == len(HERD),
          f"second drain: {session.scheduler.last_drain.result_hits} cache hits")
    check(not any(cached_launches.values()),
          f"the cached drain launched kernels: {cached_launches}")
    print(f"[drain] a second drain of the herd: {len(HERD)} result-cache hits, "
          f"launches {cached_launches}")
    session.close()
    serial.close()

    # device busy share of an uncached drain of the herd, under the profiler
    prof = Session(catalog, seed=42, config=SessionConfig(result_cache_size=0))
    for q in HERD:
        prof.submit(q)
    busy, pwall = device_busy_ms(torch, prof.drain)
    prof.close()
    share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
    print(f"[drain] uncached drain under torch.profiler: device kernels "
          f"{busy if busy is None else round(busy, 4)} ms of {pwall:.2f} ms wall; "
          f"device idle share {share}  [{smi}]")
    return {"wall_ms": wall * 1e3, "serial_ms": serial_ms, "launches": launches,
            "stacked_lanes": pilots["stacked"], "solo_pilots": pilots["solo"],
            "pilot_host_copies": copies,
            "buckets": buckets, "stats": dataclasses.asdict(stats), **split,
            "device_busy_ms": busy, "profiled_wall_ms": pwall, "runs": runs}


# ---------------------------------------------------------------------------
# phase 8 helpers: the gather route and segment_sum
# ---------------------------------------------------------------------------

def segment_key(args):
    """Recording key of a segment_sum call: (channels, rows, segments)."""
    return (*args[0].shape, args[2])


def peak_rss_gb():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # KiB -> GB


def relative_errors(np, approx, exact):
    """|approx - exact| / |exact| over the groups present in the exact
    answer (every composite), as one flat array."""
    present = exact.answer.group_present
    e = exact.answer.values[:, present]
    a = approx.answer.values[:, present]
    return (np.abs(a - e) / np.abs(e)).ravel()


def check_segment_sum(torch, fn, ref, args, kwargs, sorted_route, slice_cols=1 << 26):
    """Hold one segment_sum call to an f64 sum of the same values (rtol
    1e-5 of the segment's absolute sum) and, within the f32 summation bound
    of both (2 n u sum|x| for a segment of n rows, u = 2^-24), to its plain
    version (which also checks a slab claim) and to the sorted route's sums
    (``sorted_route``, the route the new ones are held against); empty
    segments exactly 0; two launches bitwise equal.  Segments are checked in
    slices of ``slice_cols`` so the f64 sums of a join pilot's 480M-segment
    output fit beside the catalog.  Returns (output, max |kernel - plain|)."""
    vals, seg, nseg = args
    got = fn(*args, **kwargs)
    check(bitwise_equal(torch, got, fn(*args, **kwargs)),
          "segment_sum: launches differ bitwise")
    plain = ref(*args, **kwargs)
    yardstick = sorted_route(*args)
    err = float((got - plain).abs().max()) if got.numel() else 0.0
    for a in range(0, nseg, slice_cols):
        b = min(a + slice_cols, nseg)
        m = (seg >= a) & (seg < b)
        sub, vs = seg[m] - a, vals[:, m].double()
        f64 = lambda v, n=b - a: torch.zeros((v.shape[0], n), dtype=torch.float64,
                                             device=v.device).index_add_(1, sub, v)
        want, absum = f64(vs), f64(vs.abs())
        rows = f64(torch.ones((1, vs.shape[1]), dtype=torch.float64, device=vs.device))
        g = got[:, a:b].double()
        check(bool(((g - want).abs() <= 1e-5 * absum).all()),
              f"segment_sum {segment_key(args)}: beyond rtol 1e-5 of the f64 sum")
        bound = 2.0 * rows * 2.0 ** -24 * absum
        check(bool(((g - plain[:, a:b].double()).abs() <= bound).all()),
              f"segment_sum {segment_key(args)}: beyond the f32 bound of its plain version")
        check(bool(((g - yardstick[:, a:b].double()).abs() <= bound).all()),
              f"segment_sum {segment_key(args)}: beyond the f32 bound of the sorted route")
        check(not bool(torch.where(rows == 0, g, 0.0).any()),
              f"segment_sum {segment_key(args)}: an empty segment is not 0")
        del want, absum, rows, g, bound
    del plain, yardstick
    return got, err


def time_segment_sum(torch, ops, ref, args, kwargs, smi, launch_floor, iters=10):
    """Check one segment_sum input, then time it with CUDA events and L2
    flushed beside its bytes bound, the launch floor of its route's grids,
    the sorted route on the same input (the first design, where the call
    takes another route), the stable sort of its keys alone, its plain
    version and index_add_ alone.  Returns its row of the ``kernels``
    line."""
    vals, seg, nseg = args
    channels, rows = vals.shape
    plan = ops.launch_plan(channels, rows, nseg, kwargs.get("slab_rows"),
                           kwargs.get("slab_keys"))
    sorted_route = lambda *a: ops.launch(*a, force="sorted")
    _, err = check_segment_sum(torch, ops.segment_sum, ref, args, kwargs, sorted_route)
    ms = time_cold(torch, lambda: ops.segment_sum(*args, **kwargs), iters)
    sorted_ms = (ms if plan.route == "sorted"
                 else time_cold(torch, lambda: sorted_route(*args), iters))
    plain_ms = time_cold(torch, lambda: ref(*args, **kwargs), iters)
    out = torch.zeros((channels, nseg), dtype=torch.float32, device=vals.device)
    library_ms = time_cold(torch, lambda: out.index_add_(1, seg, vals), iters)
    del out
    keys = seg.to(torch.int32)
    sort_ms = time_cold(torch, lambda: torch.sort(keys, stable=True), iters)
    del keys
    floor_ms = time_cold(torch, lambda: [launch_floor(g, 1) for g in plan.grids], iters)
    # where one call's device time goes (the profiler now and then returns
    # no events: ask again)
    top = []
    for _ in range(3):
        top = top or device_profile(torch, lambda: ops.segment_sum(*args, **kwargs),
                                    top=10)[2]
    parts = [(name.split("(")[0].split("<")[0].split("::")[-1][:48], t, n)
             for name, t, n in top]
    nbytes = rows * channels * 4 + rows * 8 + nseg * channels * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    claim = (f", slab claim {kwargs['slab_rows']} rows / {kwargs['slab_keys']} keys"
             if kwargs else "")
    print(f"[gather] segment_sum (C, R, S) {segment_key(args)}: route {plan.route} "
          f"({plan.variant}{claim}) {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.3f} us = "
          f"{nbytes:,} B / 3.35 TB/s, {bound_ms / ms:.1%} of bound; launch floor of its "
          f"{len(plan.grids)} grid(s) {list(plan.grids)} {floor_ms * 1e3:.2f} us; sorted "
          f"route {sorted_ms * 1e3:.2f} us; stable sort alone {sort_ms * 1e3:.2f} us; "
          f"plain {plain_ms * 1e3:.2f} us; index_add_ {library_ms * 1e3:.2f} us); "
          f"max |kernel - plain| {err:.3g}  [{smi}]")
    print("[gather]   its device kernels under torch.profiler (L2 warm): "
          + "; ".join(f"{name} {t * 1e3:.2f} us x{n}" for name, t, n in parts))
    return {"shape": list(segment_key(args)), "route": plan.route,
            "variant": plan.variant, "slab": kwargs or None, "ms": ms,
            "sorted_route_ms": sorted_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "sort_ms": sort_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "floor_ms": floor_ms, "grids": list(plan.grids),
            "max_abs_err": err, "device_kernels": parts}


def sorted_route_point(torch, np, ops, ref, smi, launch_floor):
    """segment_sum at a fixed input only the sorted route takes (S * C
    above the few route's budget, no slab claim): checked and timed as a
    recorded input is."""
    c, rows, nseg = SORTED_POINT
    rng = np.random.default_rng(SORTED_SEED)
    dev = torch.device("cuda")
    vals = torch.from_numpy(rng.uniform(900.0, 1100.0, (c, rows)).astype(np.float32)).to(dev)
    seg = torch.from_numpy(rng.integers(0, nseg, rows)).to(dev)
    check(ops.launch_plan(c, rows, nseg).route == "sorted",
          f"{SORTED_POINT} does not take the sorted route")
    before = ops.segment_sum.launches
    row = time_segment_sum(torch, ops, ref, (vals, seg, nseg), {}, smi, launch_floor)
    check(ops.segment_sum.launches > before, "the sorted route was never launched")
    return row


def run_gather(torch, np, catalog, Session, SessionConfig, segment_sum, recorder,
               smi):
    """Phase 8: the three analytics queries through Session.sql on the SF10
    catalog, then the grouped drain herd."""
    t_phase = time.perf_counter()
    session = Session(catalog, seed=42, config=SessionConfig(result_cache_size=0))
    zero_counters([segment_sum])
    recorder.active = {"segment_sum"}
    first, per_query, chosen = {}, {}, {}
    for qn, sql in GATHER_QUERIES.items():
        before = segment_sum.launches
        exact, _ = run_sql(torch, session, sql)
        for err_pct in GATHER_ERRORS:
            approx, _ = run_sql(torch, session, sql + f" ERROR {err_pct}% CONFIDENCE 95%")
            r = approx.report
            rel = relative_errors(np, approx, exact)
            check(np.all(np.isfinite(exact.answer.values[:, exact.answer.group_present])),
                  f"{qn}: non-finite exact answer")
            check(bool(np.all(rel <= err_pct / 100)) or r.fallback is not None,
                  f"{qn} at {err_pct}%: error {rel} above the bound without a fallback")
            print(f"[gather] {qn} at ERROR {err_pct}%: plan "
                  f"{r.plan.rates if r.plan else None}, fallback {r.fallback}, "
                  f"pilot {r.pilot_table} {r.n_pilot_blocks} blocks (theta "
                  f"{r.theta_pilot:.6g}), max error {rel.max():.4%} "
                  f"(exact {exact.answer.values.ravel().tolist()}, approx "
                  f"{approx.answer.values.ravel().tolist()})")
            if r.plan is not None:
                break
        chosen[qn] = err_pct
        first[qn] = (exact, approx)
        per_query[qn] = segment_sum.launches - before
    recorder.active = set()
    launches = segment_sum.launches
    print(f"[gather] segment_sum launches: {per_query} (total {launches}); "
          f"recorded inputs (C, R, S): {sorted(recorder.calls['segment_sum'])}")
    for qn, n in per_query.items():
        check(n > 0, f"the {qn} path never launched segment_sum")
    for qn, (_, approx) in first.items():
        check(approx.report.plan is not None,
              f"{qn}: no error of {GATHER_ERRORS} reached a sampled final")

    summary = {"launches": launches, "launches_by_query": per_query,
               "error_pct": chosen}
    for qn, sql in GATHER_QUERIES.items():
        text = sql + f" ERROR {chosen[qn]}% CONFIDENCE 95%"
        walls, exact_walls = [], []
        stage = {"pilot": [], "rate_solve": [], "final": []}
        rss0 = peak_rss_gb()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(GATHER_WARM[qn]):
            eh, ew = run_sql(torch, session, sql)
            ah, aw = run_sql(torch, session, text)
            exact_walls.append(ew)
            walls.append(aw)
            stage["pilot"].append(ah.report.pilot_time_s)
            stage["rate_solve"].append(ah.report.plan_time_s)
            stage["final"].append(ah.report.final_time_s)
        r = ah.report
        scanned = (r.pilot_scanned_bytes + r.final_scanned_bytes) / r.exact_scanned_bytes
        med = {k: statistics.median(v) * 1e3 for k, v in stage.items()}
        row = dict(approx_ms=statistics.median(walls) * 1e3,
                   exact_ms=statistics.median(exact_walls) * 1e3,
                   scanned_fraction=scanned, plan=r.plan.rates if r.plan else None,
                   fallback=r.fallback, error_pct=chosen[qn],
                   **{f"{k}_ms": v for k, v in med.items()},
                   device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   host_peak_rss_gb=peak_rss_gb())
        extra = ""
        if qn == "join":
            pair = [k for k in recorder.calls["segment_sum"] if k[2] > 10 ** 8]
            row["pair_tensor_bytes"] = [c * sgm * 4 for c, _, sgm in pair]
            extra = (f"; pair tensor {row['pair_tensor_bytes']} B on the card, "
                     f"device peak {row['device_peak_gb']:.2f} GB, host peak RSS "
                     f"{rss0:.2f} -> {row['host_peak_rss_gb']:.2f} GB")
        # device busy share under the profiler (the approximate join's
        # seconds of host work are left out: its card idles through them)
        for kind, q in (("exact", sql), ("approx", text)):
            if qn == "join" and kind == "approx":
                continue
            busy, pwall = device_busy_ms(torch, lambda: session.sql(q))
            row[f"{kind}_device_busy_ms"], row[f"{kind}_profiled_wall_ms"] = busy, pwall
            share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
            print(f"[gather] {qn} {kind}: wall {row[f'{kind}_ms']:.2f} ms (median of "
                  f"{GATHER_WARM[qn]} warm runs); under torch.profiler device kernels "
                  f"{busy if busy is None else round(busy, 4)} ms of {pwall:.2f} ms "
                  f"wall; device idle share {share}  [{smi}]")
        summary[qn] = row
        print(f"[gather] {qn} at ERROR {chosen[qn]}% (median of {GATHER_WARM[qn]} warm "
              f"runs): approx {row['approx_ms']:.2f} ms = pilot {med['pilot']:.2f} + rate "
              f"solve {med['rate_solve']:.2f} + final {med['final']:.2f} ms; exact "
              f"{row['exact_ms']:.2f} ms; scanned {scanned:.4%} of the exact bytes; plan "
              f"{row['plan']}{extra}  [{smi}]")
    session.close()

    # the grouped drain herd: the members' pilots stacked into ONE
    # segment_sum launch (its input recorded, and replayed with the others),
    # gather_batched finals, each answer bitwise the serial session's
    herd_err = chosen["q1"]
    herd = [q + f" ERROR {herd_err}% CONFIDENCE 95%" for q in GATHER_HERD]
    drain = Session(catalog, seed=42, config=SessionConfig(result_cache_size=0))
    routes, stacked_launches, stacked_inputs = [], [], []
    ex = drain.executor
    pilot_spy = spy_pilots(ex)
    compile_batched, stacked = ex.physical.compile_batched_query, ex.execute_pilots_batched

    def spy_compile(*a, **kw):
        c = compile_batched(*a, **kw)
        routes.append(c.route)
        return c

    def spy_stacked(*a):
        before, known = segment_sum.launches, set(recorder.calls["segment_sum"])
        recorder.active = {"segment_sum"}
        try:
            return stacked(*a)
        finally:
            recorder.active = set()
            stacked_launches.append(segment_sum.launches - before)
            stacked_inputs.extend(set(recorder.calls["segment_sum"]) - known)

    ex.physical.compile_batched_query = spy_compile
    ex.execute_pilots_batched = spy_stacked
    herd_launches = segment_sum.launches
    t0 = time.perf_counter()
    hs = [drain.submit(q) for q in herd]
    drain.drain()
    torch.cuda.synchronize()
    herd_ms = (time.perf_counter() - t0) * 1e3
    herd_launches = segment_sum.launches - herd_launches
    serial = Session(catalog, seed=42, config=SessionConfig(
        async_workers=0, share_pilots=False, result_cache_size=0))
    for h in hs:
        check(h.status == "done", f"herd: {h.error}\n{h.sql}")
        r, _ = run_sql(torch, serial, h.sql)
        check(np.array_equal(h.answer.values, r.answer.values),
              f"herd answer {h.answer.values.ravel()} is not bitwise the serial "
              f"session's {r.answer.values.ravel()}\n{h.sql}")
    check("gather_batched" in routes, f"the herd's finals took {routes}, not gather_batched")
    pilots = drain.scheduler.last_drain.pilots_run
    check(pilots == len(herd), f"the herd ran {pilots} pilots, not {len(herd)}")
    check(pilot_spy["stacked"] == [len(herd)] and pilot_spy["solo"] == 0
          and stacked_launches == [1],
          f"the herd's pilots: stacked lanes {pilot_spy['stacked']}, solo "
          f"{pilot_spy['solo']}, segment_sum launches of the stack {stacked_launches}; "
          f"expected one stack of {len(herd)} in one launch")
    print(f"[gather] grouped herd of {len(herd)} at ERROR {herd_err}%: drain "
          f"{herd_ms:.2f} ms; pilots {pilots} (one stacked call of "
          f"{pilot_spy['stacked']} lanes, {stacked_launches} segment_sum launch; "
          f"segment_sum launches in the drain {herd_launches}); final routes "
          f"{routes}; plans "
          f"{[h.report.plan.rates if h.report.plan else h.fallback for h in hs]}; "
          f"every answer bitwise the serial session's Session.sql  [{smi}]")
    drain.close()
    serial.close()
    summary["herd"] = {"wall_ms": herd_ms, "pilots": pilots, "routes": routes,
                       "error_pct": herd_err, "stacked_lanes": pilot_spy["stacked"],
                       "stacked_pilot_launches": stacked_launches[0],
                       "stacked_input": stacked_inputs,
                       "segment_sum_launches": herd_launches}
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[gather] phase 8 queries and herd in {summary['phase_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# phase 9 helpers: staged ladders and shards
# ---------------------------------------------------------------------------

def same_bits(np, a, b):
    """Equal f64 bit patterns (NaN-safe), for answers."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def evict_rungs(ex):
    """Drop every ladder's rung tensors, as a byte budget of 0 does; the
    ladders' pinned seeds stay, so later draws replay the same blocks."""
    ex.staged.max_bytes = 0
    with ex.staged._lock:
        ex.staged._enforce_budget()


def staged_routes(staged, plain, handle, num_blocks):
    """The route of the staged pilot and final of ``handle`` (a query the
    staged session answered) beside the route the plain session's compiler
    gives the same plan on the fresh draw: {stage: (staged, fresh)}."""
    from repro_torch.engine import logical as L
    from repro_torch.engine.physical import ScanRuntime
    from repro_torch.engine.sampling import draw_block_ids, pad_block_ids
    from repro_torch.engine.staged import prepare_mono_subdraw
    ex = staged.executor
    plan, _ = staged.db._engine_plan(handle.query)
    lad = ex.staged.ladder("lineitem")
    r = handle.report
    stages = [("pilot", r.theta_pilot)]
    if r.plan is not None:
        stages.append(("final", r.plan.rates["lineitem"]))
    out = {}
    for stage, rate in stages:
        rung = lad.rung_for(rate)
        check(rung is not None, f"no rung covers the {stage} rate {rate}")
        sub = prepare_mono_subdraw(lad, rung, rate)
        rt = ScanRuntime("block", sub.n_real, sub.n_phys, sub.phys,
                         ids_dev=sub.phys_dev, nreal_dev=sub.nreal_dev)
        phys, n_real, n_phys = pad_block_ids(
            draw_block_ids(num_blocks, rate, lad.seed), num_blocks)
        fresh = ScanRuntime("block", n_real, n_phys, phys)
        if stage == "pilot":
            out[stage] = (rung.compiler.compile_pilot(plan, "lineitem", rt).route,
                          plain.executor.physical.compile_pilot(plan, "lineitem", fresh).route)
        else:
            fp = L.rewrite_scans(plan, {"lineitem": L.SampleClause("block", rate, 0)})
            out[stage] = (rung.compiler.compile_query(fp, {"lineitem": rt}).route,
                          plain.executor.physical.compile_query(fp, {"lineitem": fresh}).route)
    return out


def run_staged_shards(torch, np, li, Session, SessionConfig, kernels, recorder, smi):
    """Phase 9: SF10 lineitem registered plain, staged, sharded and both;
    Q6, SUM/COUNT and the grouped Q1 at ERROR 5% through Session.sql in
    each, the phase-6 herd drained on the staged session; staged against
    evicted, shard counts against each other, every answer against the
    exact one; walls in turns beside their device idle share.  Returns the
    summary, whose ``calls`` hold each session's recorded kernel inputs
    (first call per shape), for the caller to replay."""
    from repro_torch.engine.sampling import draw_block_ids
    from repro_torch.engine.staged import prepare_mono_subdraw
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = SessionConfig(result_cache_size=0)
    names = {fn.__name__ for fn in kernels}
    summary = {"sessions": {}, "calls": {}}

    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if li.device.type == "cuda" else [li.device])

    def register(**kw):
        """(session, seconds, bytes allocated on lineitem's card, bytes
        allocated on each card)."""
        for c in cards:
            torch.cuda.synchronize(c)
        mem0, t0 = [torch.cuda.memory_allocated(c) for c in cards], time.perf_counter()
        s = Session(seed=42, config=cfg)
        s.register_table("lineitem", li, **kw)
        for c in cards:
            torch.cuda.synchronize(c)
        per_card = {c: torch.cuda.memory_allocated(c) - m for c, m in zip(cards, mem0)}
        return s, time.perf_counter() - t0, per_card[li.device], per_card

    def evicted_answers(s):
        """The queries again after the session's rungs are dropped (all
        misses, under the same pinned seed)."""
        evict_rungs(s.executor)
        misses0 = s.executor.staged.misses
        out = {qn: run_sql(torch, s, sql + GUARANTEE)[0]
               for qn, sql in STAGED_QUERIES.items()}
        check(s.executor.staged.misses > misses0, "an evicted ladder still served")
        check(s.executor.staged_info()["resident_bytes"] == 0, "rungs left resident")
        return out

    def first_pass(tag, s):
        """Each query once, counters zeroed before and read after, every
        kernel call recorded; staged hits per query."""
        zero_counters(kernels)
        recorder.active = set(names)
        out, hits = {}, {}
        for qn, sql in STAGED_QUERIES.items():
            h0 = s.executor.staged.hits
            out[qn], _ = run_sql(torch, s, sql + GUARANTEE)
            hits[qn] = s.executor.staged.hits - h0
        recorder.active = set()
        launches = read_counters(kernels)
        summary["calls"][tag] = {name: dict(recorder.calls[name]) for name in names}
        for name in names:
            recorder.calls[name].clear()
        summary["sessions"][tag] = {
            "launches": launches, "staged_hits": hits,
            "staged_misses": s.executor.staged.misses,
            "fallbacks": {qn: h.fallback for qn, h in out.items()},
            "plans": {qn: h.report.plan.rates if h.report.plan else None
                      for qn, h in out.items()}}
        print(f"[staged] {tag}: launches {launches}; staged hits per query {hits}, "
              f"misses {s.executor.staged.misses}; plans "
              f"{summary['sessions'][tag]['plans']}; fallbacks "
              f"{summary['sessions'][tag]['fallbacks']}")
        return out

    plain, _, _, _ = register()
    exact = {qn: run_sql(torch, plain, sql)[0] for qn, sql in STAGED_QUERIES.items()}
    answers = {"plain": first_pass("plain", plain)}

    staged, secs, nbytes, _ = register(staged_rates=True)
    info = staged.executor.staged_info()
    summary["ladder"] = {"seconds": secs, "device_bytes": nbytes,
                         "resident_bytes": info["resident_bytes"],
                         "rates": info["tables"]["lineitem"]["rates"]}
    print(f"[staged] ladder 1/4/16 % of {li.num_blocks:,} blocks: built in {secs:.3f} s; "
          f"{info['resident_bytes']:,} B of rungs ({info['resident_bytes'] / li.total_bytes():.1%} "
          f"of lineitem's {li.total_bytes():,} B); device allocation +{nbytes:,} B  [{smi}]")
    answers["staged"] = first_pass("staged", staged)
    routes = {}
    for qn, h in answers["staged"].items():
        routes[qn] = staged_routes(staged, plain, h, li.num_blocks)
        for stage, (a, b) in routes[qn].items():
            check(a == b, f"staged {qn} {stage} takes route {a}, the fresh plan {b}")
        check(routes[qn]["pilot"][0] == STAGED_ROUTES[qn]
              and routes[qn].get("final", (STAGED_ROUTES[qn],))[0] == STAGED_ROUTES[qn],
              f"staged {qn} left its route {STAGED_ROUTES[qn]}: {routes[qn]}")
    print(f"[staged] routes (staged, fresh) per stage: {routes}")
    summary["routes"] = routes

    shard_runs = {}
    for n in (1, 2, 7, SHARDS):
        s, secs, nbytes, per_card = register(shards=n)
        shard_runs[n] = first_pass(f"shards={n}", s)
        # shards go round-robin over every card (shard i on cuda:{i % k}):
        # those on lineitem's own card are views of its tensors, each other
        # card holds copies of its own shards and nothing else
        placed = s.executor._sharded["lineitem"].shards
        check([sh.table.device for sh in placed] == [cards[i % len(cards)] for i in range(n)],
              f"shards={n}: placed on {[str(sh.table.device) for sh in placed]}")
        want = {c: sum(sh.table.padded_rows * (sh.table.row_bytes() + 5)
                       for sh in placed if sh.table.device == c and c != li.device)
                for c in cards}
        summary.setdefault("shard_registration", {})[n] = {
            "seconds": secs, "device_bytes": nbytes,
            "per_card": {str(c): (per_card[c], want[c]) for c in cards}}
        print(f"[staged] shards={n}: registered in {secs:.3f} s; device allocation "
              f"+{nbytes:,} B on lineitem's card (lineitem {li.total_bytes():,} B); per card "
              f"(allocated, shard copies) {summary['shard_registration'][n]['per_card']}  [{smi}]")
        for c in cards:
            check(abs(per_card[c] - want[c]) < li.total_bytes() // 100,
                  f"shards={n} allocated {per_card[c]:,} B on {c}, its shard copies "
                  f"hold {want[c]:,} B")
        if n == SHARDS:
            sharded = s
        else:
            s.close()
    both, secs, nbytes, _ = register(shards=SHARDS, staged_rates=True)
    print(f"[staged] shards={SHARDS} + ladder: registered in {secs:.3f} s; device "
          f"allocation +{nbytes:,} B  [{smi}]")
    answers["shards+staged"] = first_pass(f"shards={SHARDS}+staged", both)
    both_evicted = evicted_answers(both)
    both.close()

    # the checks
    for tag in ("staged", f"shards={SHARDS}+staged"):
        for qn, n in summary["sessions"][tag]["staged_hits"].items():
            check(n >= 1, f"{tag} {qn}: {n} staged hits")
    for tag in ("staged", f"shards={SHARDS}", f"shards={SHARDS}+staged"):
        launched = summary["sessions"][tag]["launches"]
        for name in names:
            check(launched[name] > 0, f"{tag}: {name} never launched")
    for qn in STAGED_QUERIES:
        check(same_bits(np, answers["shards+staged"][qn].answer.values,
                        both_evicted[qn].answer.values),
              f"shards+staged {qn}: the hit is not bitwise the miss after eviction")
        for n in (2, 7, SHARDS):
            check(same_bits(np, shard_runs[n][qn].answer.values,
                            shard_runs[1][qn].answer.values),
                  f"{qn}: {n} shards differ from 1 shard")
        for got, want in ((shard_runs[1][qn], answers["plain"][qn]),
                          (answers["shards+staged"][qn], answers["staged"][qn])):
            check(got.fallback == want.fallback, f"{qn}: fallbacks differ across routes")
            np.testing.assert_allclose(got.answer.values, want.answer.values, rtol=1e-5,
                                       err_msg=f"{qn}: sharded vs monolithic")
        for tag, hs in (*answers.items(), *((f"shards={n}", r) for n, r in shard_runs.items())):
            rel = relative_errors(np, hs[qn], exact[qn])
            check(bool(np.all(rel <= 0.05)) or hs[qn].fallback is not None,
                  f"{tag} {qn}: error {rel} above 5% without a fallback")
    print(f"[staged] {SHARDS}-shard staged answers bitwise the same session's after "
          f"eviction; 1 / 2 / 7 / {SHARDS} shards bitwise one answer, within rtol "
          "1e-5 of the monolithic session; every answer within 5% of exact or a fallback")

    # the phase-6 herd drained on the staged session, against its own sql
    hits0 = staged.executor.staged.hits
    zero_counters(kernels)
    t0 = time.perf_counter()
    hs = [staged.submit(q) for q in HERD]
    staged.drain()
    torch.cuda.synchronize()
    herd_ms = (time.perf_counter() - t0) * 1e3
    herd_hits = staged.executor.staged.hits - hits0
    herd_launches = read_counters(kernels)
    for h in hs:
        check(h.status == "done", f"staged drain: {h.error}\n{h.sql}")
        r, _ = run_sql(torch, staged, h.sql)
        check(same_bits(np, h.answer.values, r.answer.values),
              f"staged drain answer is not bitwise its Session.sql\n{h.sql}")
        e, _ = run_sql(torch, plain, h.sql.split(" ERROR ")[0])
        rel = relative_errors(np, h, e)
        check(bool(np.all(rel <= 0.05)) or h.fallback is not None,
              f"staged drain: error {rel} above 5% without a fallback\n{h.sql}")
    print(f"[staged] the phase-6 herd drained on the staged session: {herd_ms:.2f} ms, "
          f"staged hits {herd_hits}, launches {herd_launches}, pilots "
          f"{staged.scheduler.last_drain.pilots_run}; every answer bitwise its "
          f"Session.sql and within 5% of exact or a fallback  [{smi}]")
    summary["drain"] = {"wall_ms": herd_ms, "staged_hits": herd_hits,
                        "launches": herd_launches,
                        "pilots": staged.scheduler.last_drain.pilots_run}

    # the host draw a staged pilot no longer pays, beside the memo hit
    lad = staged.executor.staged.ladder("lineitem")
    theta = answers["staged"]["q6"].report.theta_pilot
    rung = lad.rung_for(theta)
    draws, memo = [], []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        draw_block_ids(li.num_blocks, theta, lad.seed)
        draws.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        prepare_mono_subdraw(lad, rung, theta)
        memo.append((time.perf_counter() - t0) * 1e3)
    summary["draw"] = {"theta": theta, "draw_ms": statistics.median(draws),
                       "memo_ms": statistics.median(memo)}
    print(f"[staged] the pilot draw at theta {theta:.6g} over {li.num_blocks:,} blocks: "
          f"{summary['draw']['draw_ms']:.3f} ms on the host (median of {WARM_RUNS}); the "
          f"staged pilot's memo hit {summary['draw']['memo_ms'] * 1e3:.2f} us")

    # walls in turns: plain, staged, sharded, WARM_RUNS times each query
    sessions = {"plain": plain, "staged": staged, f"shards={SHARDS}": sharded}
    runs = {(tag, qn): {"wall": [], "pilot": [], "rate_solve": [], "final": []}
            for tag in sessions for qn in STAGED_QUERIES}
    for _ in range(WARM_RUNS):
        for qn, sql in STAGED_QUERIES.items():
            for tag, s in sessions.items():
                h, w = run_sql(torch, s, sql + GUARANTEE)
                r = runs[(tag, qn)]
                r["wall"].append(w)
                r["pilot"].append(h.report.pilot_time_s)
                r["rate_solve"].append(h.report.plan_time_s)
                r["final"].append(h.report.final_time_s)
    walls = {}
    for (tag, qn), r in runs.items():
        med = {k: statistics.median(v) * 1e3 for k, v in r.items()}
        busy, pwall = device_busy_ms(torch, lambda: sessions[tag].sql(STAGED_QUERIES[qn] + GUARANTEE))
        med.update(device_busy_ms=busy, profiled_wall_ms=pwall,
                   walls_ms=[v * 1e3 for v in r["wall"]])
        walls[f"{tag} {qn}"] = med
        share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
        print(f"[staged] {tag} {qn} at ERROR 5% (median of {WARM_RUNS} warm runs, in "
              f"turns): {med['wall']:.2f} ms = pilot {med['pilot']:.2f} + rate solve "
              f"{med['rate_solve']:.2f} + final {med['final']:.2f} ms; walls "
              f"{[round(v, 2) for v in med['walls_ms']]}; device idle share {share} "
              f"({busy if busy is None else round(busy, 4)} ms of {pwall:.2f} ms under "
              f"torch.profiler)  [{smi}]")
    summary["walls"] = walls
    # last, the monolithic staged session's rungs dropped: each miss under
    # the one pinned seed must give its hit's bits
    evicted = evicted_answers(staged)
    for qn in STAGED_QUERIES:
        check(same_bits(np, answers["staged"][qn].answer.values, evicted[qn].answer.values),
              f"staged {qn}: the hit is not bitwise the miss after eviction")
    print("[staged] staged answers bitwise the same session's after its rungs were "
          "dropped")
    for s in sessions.values():
        s.close()
    summary["device_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[staged] phase 9 in {summary['phase_s']:.1f} s; device peak "
          f"{summary['device_peak_gb']:.2f} GB  [{smi}]")
    return summary


# ---------------------------------------------------------------------------
# phase 10 helpers: the fused path, Quickr and the eager oracle
# ---------------------------------------------------------------------------

def solve_key(args):
    """Recording key of taqa_solve_rate: the pilot block sums' shape."""
    return tuple(args[0].shape)


def draw_key(args):
    """Recording key of taqa_draw_compact: the uniforms' shape."""
    return tuple(args[0].shape)


SOLVE_SCALE_N_SOLVE = (8, 64)    # solve channels of the solve's scaling points
SOLVE_SCALE_N_PHYS = 1_024       # the fused pilot's block count
DRAW_SCALE_N = 18_750_000        # uniforms: 1,145 tiles, more than the resident CTAs
DRAW_SCALE_THETA = 0.3


def solve_point(torch, np, n_phys, n_solve, dev):
    """Pilot-shaped taqa_solve_rate inputs with n_solve channels (revenue-
    and price-like in turn, then a row count), Q6-like quantile rows and
    the SF10 cost line."""
    rng = np.random.default_rng(n_solve)
    bs = np.zeros((n_phys, n_solve + 1), np.float32)
    for c in range(n_solve):
        bs[:, c] = (rng.gamma(2.0, 5_000.0, n_phys) if c % 2 == 0
                    else rng.normal(1.2e6, 1e5, n_phys))
    bs[:, n_solve] = 32.0
    solve = np.tile(np.array([2.6, 0.9 * (n_phys - 1), 2.2, 2.8, 0.05], np.float32),
                    (n_solve, 1))
    scal = np.array([1_875_000, 1.0, 1e-6, 1.5e9, 2e5, 1.6e9], np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(bs), t(np.array([True])), n_phys, t(np.arange(n_solve, dtype=np.int32)),
            t(solve), t(scal))


def time_taqa_kernels(torch, np, calls, wrappers, refs, launch_floor, smi):
    """Each recorded taqa_solve input, then the scaling points (the solve at
    8 and 64 channels; the draw at 18,750,000 uniforms and at theta 0.3):
    against its plain version bitwise (theta, flags, nsel, ids), the same
    bits on a second launch, one kernel node in a CUDA graph of the call;
    then timed (CUDA events, L2 flushed) beside its plain version, its
    bound, the launch floor of its grid and, for the draw, the library
    yardstick torch.nonzero(u < theta) plus the zero fill.  Returns {name:
    [row, ...]}, the recorded inputs' rows first."""
    from repro_torch.kernels.graph_nodes import captured_node_types
    from repro_torch.kernels.taqa_solve import ops as taqa_ops
    out = {}
    solve, draw = wrappers
    solve_ref, draw_ref = refs

    def solve_row(args, tag):
        bs, _, n_real, channels, solve_rows, _ = args
        theta, flags = solve(*args)
        again, again_flags = solve(*args)
        ref_theta, ref_flags = solve_ref(*args)
        bits = lambda x: x.view(torch.int32)
        check(torch.equal(bits(theta), bits(again)) and torch.equal(flags, again_flags),
              "taqa_solve_rate: launches differ bitwise")
        check(torch.equal(flags, ref_flags), f"taqa_solve_rate: flags {flags} vs {ref_flags}")
        check(torch.equal(bits(theta), bits(ref_theta)),
              f"taqa_solve_rate: theta {theta.tolist()} is not bitwise its plain version's "
              f"{ref_theta.tolist()}")
        nodes = captured_node_types(lambda: solve(*args))
        check(nodes == ["kernel"], f"taqa_solve_rate: a call enqueues {nodes}")
        n_phys, n_solve = bs.shape[0], channels.shape[0]
        # bytes: the solve channels' block sums, the quantile rows, the
        # scalars, channels and present, the three outputs
        nbytes = n_phys * n_solve * 4 + n_solve * 24 + 24 + 1 + 12
        # operations: y and y*y added per row and channel, then 49
        # feasibility tests of ~16 f32 operations per channel
        flops = 3 * n_phys * n_solve + (1 + 48) * n_solve * 16
        byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["torch.float32"] * 1e3
        row = {"input": tag, "shape": "x".join(map(str, bs.shape)), "n_real": n_real,
               "n_solve": n_solve, "max_abs_err": 0.0, "bitwise": True,
               "theta": ref_theta.tolist(), "flags": int(flags[0]), "graph_nodes": nodes,
               "ms": time_cold(torch, lambda: solve(*args)),
               "plain_ms": time_cold(torch, lambda: solve_ref(*args), 5),
               "bound_ms": max(byte_ms, op_ms),
               "bound_by": "bytes" if byte_ms >= op_ms else "operations",
               "library_ms": None,
               "floor_ms": time_cold(torch, lambda: launch_floor(1, 1))}
        out.setdefault("taqa_solve_rate", []).append(row)
        print(f"[fused] taqa_solve_rate ({tag}) block sums {row['shape']} (n_real {n_real}, "
              f"{n_solve} solve channels): theta and flags bitwise its plain version, "
              f"one kernel node; kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms']:.2f} ms, bound {row['bound_ms'] * 1e3:.4f} us "
              f"({row['bound_by']}), launch floor (1 CTA) {row['floor_ms'] * 1e3:.2f} us  "
              f"[{smi}]")

    def draw_row(args, tag):
        u, theta_eff = args
        nsel, padded = draw(*args)
        ref_nsel, ref_padded = draw_ref(*args)
        check(torch.equal(nsel, ref_nsel) and torch.equal(padded, ref_padded),
              f"taqa_draw_compact: nsel {int(nsel[0])} / {int(ref_nsel[0])} or ids differ "
              "from its plain version")
        again = draw(*args)
        check(torch.equal(again[0], nsel) and torch.equal(again[1], padded),
              "taqa_draw_compact: launches differ")
        nodes = captured_node_types(lambda: draw(*args))
        check(nodes == ["kernel"], f"taqa_draw_compact: a call enqueues {nodes}")
        n = u.shape[0]
        tiles = -(-n // taqa_ops.TILE)

        def library():
            ids = torch.nonzero(u < theta_eff)
            zeros = torch.zeros(n, dtype=torch.int32, device=u.device)
            return ids, zeros

        nbytes = 4 * n + 4 * n + 8   # read u, write padded; theta_eff and nsel
        row = {"input": tag, "shape": str(n), "nsel": int(nsel[0]),
               "theta_eff": float(theta_eff[0]), "max_abs_err": 0.0, "graph_nodes": nodes,
               "ms": time_cold(torch, lambda: draw(*args)),
               "plain_ms": time_cold(torch, lambda: draw_ref(*args)),
               "library_ms": time_cold(torch, library),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "floor_ms": time_cold(torch, lambda: launch_floor(tiles, 1))}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out.setdefault("taqa_draw_compact", []).append(row)
        print(f"[fused] taqa_draw_compact ({tag}) over {n:,} uniforms (theta "
              f"{row['theta_eff']:.6g}, nsel {row['nsel']:,}): bitwise its plain version, "
              f"one kernel node; kernel {row['ms'] * 1e3:.2f} us "
              f"({row['bound_share']:.1%} of the bound), plain {row['plain_ms'] * 1e3:.2f} "
              f"us, torch.nonzero + zero fill {row['library_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us (bytes), launch floor (1 x {tiles:,} CTAs) "
              f"{row['floor_ms'] * 1e3:.2f} us  [{smi}]")

    for args, _ in calls["taqa_solve_rate"].values():
        solve_row(args, "main path")
    dev = next(iter(calls["taqa_draw_compact"].values()))[0][0].device
    for n_solve in SOLVE_SCALE_N_SOLVE:
        solve_row(solve_point(torch, np, SOLVE_SCALE_N_PHYS, n_solve, dev), "scaling point")
    for args, _ in calls["taqa_draw_compact"].values():
        draw_row(args, "main path")
    recorded_u, recorded_theta = next(iter(calls["taqa_draw_compact"].values()))[0]
    big = torch.rand(DRAW_SCALE_N, generator=torch.Generator(device=dev).manual_seed(5),
                     device=dev)
    point = torch.tensor([DRAW_SCALE_THETA], dtype=torch.float32, device=dev)
    for args in ((big, recorded_theta), (recorded_u, point), (big, point)):
        draw_row(args, "scaling point")
    del big
    return out


def run_fused_quickr_eager(torch, np, li, Session, SessionConfig, kernels, recorder, smi):
    """Phase 10 on SF10 lineitem: the fused path against two stages in
    equal-seed sessions, Quickr against PilotDB at ERROR 10%, and one eager
    query against the compiled route.  Returns the summary, whose ``calls``
    hold the taqa kernels' recorded inputs for the caller to replay."""
    from repro_torch.core import CompositeAgg, ErrorSpec, PilotDB, Query, RowSamplingAQP
    from repro_torch.engine import logical as L
    from repro_torch.engine.executor import Executor
    from repro_torch.engine.expr import And, Col
    from repro_torch.engine.sampling import draw_block_ids
    from repro_torch.kernels.segment_sum import segment_sum
    t_phase = time.perf_counter()
    summary = {}
    taqa = ("taqa_solve_rate", "taqa_draw_compact")
    sessions = {}
    for mode in ("two_stage", "fused"):
        s = Session(seed=42, config=SessionConfig(result_cache_size=0,
                                                  fused_taqa=mode == "fused"))
        s.register_table("lineitem", li)
        sessions[mode] = s
    two, one = sessions["two_stage"], sessions["fused"]

    # the fused path, counters zeroed just before and read just after
    zero_counters(kernels)
    recorder.active = set(taqa)
    first, per_query = {}, {}
    for qn, sql in FUSED_QUERIES.items():
        c0, d0 = read_counters(kernels), one.executor.device_dispatches
        first[qn], _ = run_sql(torch, one, sql + GUARANTEE)
        c1 = read_counters(kernels)
        h = first[qn]
        dispatches = one.executor.device_dispatches - d0
        per_query[qn] = {
            "launches": {k: c1[k] - c0[k] for k in c1}, "dispatches": dispatches,
            "fused": h._fused, "fallback": h.fallback,
            "solo_rerun": h._fused and h.fallback is None and dispatches == 2,
            "plan": h.report.plan.rates if h.report.plan else None}
    recorder.active = set()
    launches = read_counters(kernels)
    summary["calls"] = {k: dict(recorder.calls[k]) for k in taqa}
    for k in taqa:
        recorder.calls[k].clear()
    print(f"[fused] kernel launches on the fused path: {launches}; per query {per_query}")
    for k in taqa:
        check(launches[k] > 0, f"the fused path never launched {k}")
    for qn, r in per_query.items():
        check(r["fused"], f"fused {qn}: the fused program did not engage")
    # bitwise the two-stage answers; within 5% of exact or a fallback
    for qn, sql in FUSED_QUERIES.items():
        h2, _ = run_sql(torch, two, sql + GUARANTEE)
        check(same_bits(np, first[qn].answer.values, h2.answer.values),
              f"fused {qn}: {first[qn].answer.values} is not bitwise the two-stage "
              f"{h2.answer.values}")
        check(first[qn].fallback == h2.fallback, f"fused {qn}: fallback differs")
        e, _ = run_sql(torch, two, sql)
        rel = relative_errors(np, first[qn], e)
        check(bool(np.all(rel <= 0.05)) or first[qn].fallback is not None,
              f"fused {qn}: error {rel} above 5% without a fallback")
        per_query[qn]["error"] = rel.tolist()
    print("[fused] fused answers bitwise the two-stage answers of an equal-seed session; "
          "within 5% of exact or a fallback")
    summary["per_query"] = per_query

    # walls in turns, WARM_RUNS each; the solo re-runs counted
    runs = {(m, qn): {"wall": [], "pilot": [], "rate_solve": [], "final": [], "reruns": 0}
            for m in sessions for qn in FUSED_QUERIES}
    for i in range(WARM_RUNS):
        order = list(sessions.items()) if i % 2 == 0 else list(sessions.items())[::-1]
        for qn, sql in FUSED_QUERIES.items():
            for m, s in order:
                d0 = s.executor.device_dispatches
                h, w = run_sql(torch, s, sql + GUARANTEE)
                r = runs[(m, qn)]
                r["wall"].append(w)
                r["pilot"].append(h.report.pilot_time_s)
                r["rate_solve"].append(h.report.plan_time_s)
                r["final"].append(h.report.final_time_s)
                r["reruns"] += int(m == "fused" and h.fallback is None
                                   and s.executor.device_dispatches - d0 == 2)
    walls = {}
    for (m, qn), r in runs.items():
        med = {k: statistics.median(v) * 1e3 for k, v in r.items() if k != "reruns"}
        busy, pwall = device_busy_ms(torch, lambda: sessions[m].sql(FUSED_QUERIES[qn] + GUARANTEE))
        med.update(device_busy_ms=busy, profiled_wall_ms=pwall, reruns=r["reruns"],
                   walls_ms=[v * 1e3 for v in r["wall"]])
        walls[f"{m} {qn}"] = med
        share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
        print(f"[fused] {m} {qn} at ERROR 5% (median of {WARM_RUNS} warm runs, in turns): "
              f"{med['wall']:.2f} ms = pilot {med['pilot']:.2f} + rate solve "
              f"{med['rate_solve']:.2f} + final {med['final']:.2f} ms (fused: pilot = the "
              f"whole program's launch wall, rate solve = the f64 re-solve, final = the "
              f"verification and compose); walls {[round(v, 2) for v in med['walls_ms']]}; "
              f"solo re-runs {r['reruns']} of {WARM_RUNS}; device idle share {share} "
              f"({busy if busy is None else round(busy, 4)} ms of {pwall:.2f} ms under "
              f"torch.profiler)  [{smi}]")
    summary["walls"] = walls
    draws, uniforms = [], []
    for i in range(WARM_RUNS):
        t0 = time.perf_counter()
        draw_block_ids(li.num_blocks, 0.01, i)
        draws.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        np.random.default_rng(i).random(li.num_blocks).astype(np.float32)
        uniforms.append((time.perf_counter() - t0) * 1e3)
    summary["host_draw_ms"] = statistics.median(draws)
    summary["host_uniforms_ms"] = statistics.median(uniforms)
    print(f"[fused] host draws over {li.num_blocks:,} blocks (median of {WARM_RUNS}): "
          f"draw_block_ids {summary['host_draw_ms']:.2f} ms; the fused path's f32 "
          f"uniforms {summary['host_uniforms_ms']:.2f} ms")
    for s in sessions.values():
        s.close()

    # Quickr (row sampling, a full scan) against PilotDB (block sampling)
    ex = Executor({"lineitem": li}, device=li.device)
    pred = And(Col("l_shipdate").between(100, 1500), Col("l_discount").between(0.02, 0.08))
    q6 = Query(child=L.Filter(L.Scan("lineitem"), pred),
               aggs=(CompositeAgg("revenue", "sum",
                                  Col("l_extendedprice") * Col("l_discount")),))
    spec = ErrorSpec(error=QUICKR_ERROR, confidence=0.95)
    dbs = {"pilotdb": PilotDB(ex), "quickr": RowSamplingAQP(ex)}
    exact = dbs["pilotdb"].exact(q6).scalar("revenue")
    for db in dbs.values():  # warm: compile every shape once
        db.query(q6, spec, seed=0)
    quickr = {name: {"wall_ms": [], "scanned_fraction": [], "error": [], "fallback": []}
              for name in dbs}
    segment_sum.launches = 0
    for i in range(QUICKR_RUNS):
        for name, db in (dbs.items() if i % 2 == 0 else list(dbs.items())[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = db.query(q6, spec, seed=77 * i + 1)
            torch.cuda.synchronize()
            r = quickr[name]
            r["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            r["scanned_fraction"].append(
                (a.report.pilot_scanned_bytes + a.report.final_scanned_bytes)
                / li.total_bytes())
            r["error"].append(abs(a.scalar("revenue") - exact) / abs(exact))
            r["fallback"].append(a.report.fallback)
            check(r["error"][-1] <= QUICKR_ERROR or a.report.fallback is not None,
                  f"{name}: error {r['error'][-1]} above {QUICKR_ERROR} without a fallback")
    check(segment_sum.launches > 0, "Quickr's row-sampled plans never launched segment_sum")
    for name, r in quickr.items():
        print(f"[quickr] {name} Q6 at ERROR {QUICKR_ERROR:.0%} CONFIDENCE 95% ({QUICKR_RUNS} "
              f"runs in turns): walls {[round(v, 2) for v in r['wall_ms']]} ms; scanned "
              f"{[round(v, 6) for v in r['scanned_fraction']]} of lineitem's bytes; errors "
              f"{[round(v, 6) for v in r['error']]}; fallbacks {r['fallback']}  [{smi}]")
    speedup = statistics.median(quickr["quickr"]["wall_ms"]) / statistics.median(
        quickr["pilotdb"]["wall_ms"])
    print(f"[quickr] Quickr / PilotDB wall: {speedup:.2f}x (segment_sum launches "
          f"{segment_sum.launches})")
    summary["quickr"] = quickr
    summary["quickr_over_pilotdb_wall"] = speedup

    # one eager query against the compiled route
    plan = L.Aggregate(
        L.Filter(L.Scan("lineitem", L.SampleClause("block", 0.01, 5)), pred),
        (L.AggSpec("sum", Col("l_extendedprice") * Col("l_discount"), "revenue"),
         L.AggSpec("count", None, "n")))
    eager = Executor({"lineitem": li}, device=li.device, use_compiled=False)
    ex.execute(plan)
    res = {}
    for name, e in (("compiled", ex), ("eager", eager), ("compiled", ex), ("eager", eager)):
        torch.cuda.synchronize()
        ss0 = segment_sum.launches
        t0 = time.perf_counter()
        r = e.execute(plan)
        torch.cuda.synchronize()
        res[name] = (r, (time.perf_counter() - t0) * 1e3, segment_sum.launches - ss0)
    (rc, wc, _), (re_, we, se) = res["compiled"], res["eager"]
    check(se > 0, "the eager query never launched segment_sum")
    check(np.array_equal(rc.sample_infos["lineitem"].sampled_block_ids,
                         re_.sample_infos["lineitem"].sampled_block_ids),
          "eager and compiled draws differ")
    check(np.array_equal(rc.group_counts, re_.group_counts), "eager counts differ")
    np.testing.assert_allclose(re_.raw_sums, rc.raw_sums, rtol=1e-5,
                               err_msg="eager vs compiled sums")
    summary["eager"] = {"eager_ms": we, "compiled_ms": wc, "segment_sum_launches": se,
                        "values": re_.values.ravel().tolist()}
    print(f"[eager] 1% block-sampled Q6 (SUM, COUNT): eager {we:.2f} ms ({se} segment_sum "
          f"launches) vs compiled {wc:.2f} ms; same draw, counts equal, sums within rtol "
          f"1e-5: {re_.values.ravel().tolist()}  [{smi}]")
    summary["launches"] = launches
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[fused] phase 10 in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


# ---------------------------------------------------------------------------
# phase 11 helpers: streaming, tracing, audit and continuous telemetry
# ---------------------------------------------------------------------------

def check_stream(np, h, what):
    """A streamed handle's frames: at most one advisory pilot frame, before
    exactly one terminal frame whose answer is the handle's, bitwise."""
    frames = h.frames()
    kinds = [f.kind for f in frames]
    check(bool(frames) and frames[-1].terminal and kinds.count("pilot") <= 1
          and all(not f.terminal for f in frames[:-1]),
          f"{what}: frames {kinds}")
    final = frames[-1]
    check(final.answer is h.answer and same_bits(np, final.answer.values,
                                                  h.answer.values),
          f"{what}: the final frame is not the handle's answer, bitwise")
    for f in frames[:-1]:
        check(f.seq < final.seq and f.t_emit <= final.t_emit,
              f"{what}: a pilot frame arrived after its final frame")
    return kinds


def span_vs_report(h):
    """(span s, report s) of the pilot, rate-solve and final stages of one
    traced query (first span of each name)."""
    rep = h.report
    out = {}
    for name, rt in (("pilot", rep.pilot_time_s), ("rate_solve", rep.plan_time_s),
                     ("final", rep.final_time_s)):
        spans = h._trace.find(name)
        out[name] = (spans[0].duration_s if spans else None, rt)
    return out


def run_obs(torch, np, li, Session, SessionConfig, kernels, smi):
    """Phase 11 on SF10 lineitem: equal-seed sessions with every hook off
    and every hook on answer the same queries bitwise; the streams, the
    audit, the spans and the flight recorder are checked, then timed."""
    import shutil
    from repro_torch.obs.events import rebuild_timeseries, replay
    from repro_torch.obs.slo import SloTarget
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "obs")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    summary = {}

    def hooks(tag, **kw):
        return dict(tracing=True, audit=True, telemetry=True, trace_sample=1.0,
                    flight_recorder=os.path.join(out_dir, f"{tag}.jsonl"),
                    flight_recorder_max_bytes=1 << 26,
                    slo_targets=(SloTarget(p95_latency_s=OBS_SLO_P95_S),), **kw)

    base = dict(result_cache_size=0, async_workers=2)
    configs = {"off": base, "on": {**base, **hooks("on")},
               "fused_off": {**base, "fused_taqa": True},
               "fused_on": {**base, **hooks("fused_on"), "fused_taqa": True},
               "cached_on": {**hooks("cached_on"), "async_workers": 2}}
    sessions = {}
    for tag, kw in configs.items():
        sessions[tag] = Session(seed=42, config=SessionConfig(**kw))
        sessions[tag].register_table("lineitem", li)
    off, on = sessions["off"], sessions["on"]
    herd = OBS_HERD

    # the hooks-on path, counters zeroed just before and read just after
    zero_counters(kernels)
    t0 = time.perf_counter()
    solo = {qn: on.sql(sql + GUARANTEE, stream=True) for qn, sql in OBS_QUERIES.items()}
    hs = [on.submit(q, stream=True) for q in herd]
    on.drain()
    fused = sessions["fused_on"].sql(Q6 + GUARANTEE, stream=True)
    cached_first = sessions["cached_on"].sql(Q6 + GUARANTEE, stream=True)
    cached = sessions["cached_on"].sql(Q6 + GUARANTEE, stream=True)
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = read_counters(kernels)
    drain_stats = on.scheduler.last_drain
    print(f"[obs] the hooks-on pass ({len(solo)} sql, a {len(herd)}-query drain, a "
          f"fused Q6, a cached re-issue) in {first_pass_s:.2f} s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"phase 11 never launched {name}")

    # every answer bitwise the hooks-off session's; every stream well formed
    kinds = {}
    for qn, h in solo.items():
        check(h.status == "done", f"obs {qn}: {h.error}")
        ref = off.sql(OBS_QUERIES[qn] + GUARANTEE)
        check(same_bits(np, h.answer.values, ref.answer.values),
              f"obs {qn}: {h.answer.values} is not bitwise the hooks-off "
              f"{ref.answer.values}")
        kinds[qn] = check_stream(np, h, f"obs {qn}")
        check(h._trace is not None and h._trace.open_spans() == [],
              f"obs {qn}: open spans {h._trace and h._trace.open_spans()}")
    offs = [off.submit(q) for q in herd]
    off.drain()
    for h, r in zip(hs, offs):
        check(h.status == "done" and r.status == "done",
              f"obs herd: {h.error or r.error}\n{h.sql}")
        check(same_bits(np, h.answer.values, r.answer.values),
              f"obs herd: {h.answer.values} is not bitwise the hooks-off "
              f"{r.answer.values}\n{h.sql}")
        check_stream(np, h, f"obs herd {h.sql}")
        check(h._trace.open_spans() == [], f"obs herd: open spans\n{h.sql}")
    check(drain_stats.frames_emitted >= len(herd), f"obs drain: {drain_stats}")
    kinds["herd"] = [f.kind for f in hs[0].frames()]
    f_off = sessions["fused_off"].sql(Q6 + GUARANTEE)
    check(fused._fused and f_off._fused, "obs: the fused Q6 did not take the fused program")
    check(same_bits(np, fused.answer.values, f_off.answer.values),
          "obs fused: not bitwise the hooks-off fused answer")
    check(same_bits(np, fused.answer.values, solo["q6"].answer.values),
          "obs fused: not bitwise the two-stage answer")
    check(bool(fused._trace.find("fused")) and fused._trace.find("fused")[0].attrs["engaged"],
          "obs fused: no engaged fused span")
    kinds["fused"] = check_stream(np, fused, "obs fused")
    check(cached.cached and not cached_first.cached, "obs: the re-issue was not cached")
    kinds["cached"] = check_stream(np, cached, "obs cached")
    check(kinds["cached"] == ["pilot", "final"] and cached.frames()[0].from_cache,
          f"obs cached: frames {kinds['cached']}")
    check(same_bits(np, cached.answer.values, solo["q6"].answer.values),
          "obs cached: not bitwise the fresh answer")
    print(f"[obs] hooks on: every answer bitwise the hooks-off session's (sql, "
          f"{len(herd)}-query drain, fused, cached); frames {kinds}; drain "
          f"frames_emitted {drain_stats.frames_emitted}, time to first frame "
          f"{drain_stats.time_to_first_frame_s * 1e3:.2f} ms, to the last final "
          f"{drain_stats.time_to_final_s * 1e3:.2f} ms")

    # the audit: observed error within the promise on every audited answer
    records = []
    for tag in ("on", "fused_on", "cached_on"):
        s = sessions[tag]
        records += s.auditor.records()
        summ = s.auditor.summary()
        check(summ["errors"] == 0, f"obs {tag}: audit errors {summ}")
    audited = [r for r in records if r.skipped is None]
    for r in audited:
        check(r.observed_error <= r.promised_error,
              f"obs audit: query {r.query_id} observed {r.observed_error} above "
              f"the promised {r.promised_error} ({r.provenance})")
    exact_ms = [r.exact_wall_s * 1e3 for r in audited]
    summary["audit"] = {"records": len(records), "audited": len(audited),
                        "max_error_ratio": max(r.error_ratio for r in audited),
                        "exact_wall_ms": exact_ms,
                        "provenance": sorted({r.provenance for r in records})}
    print(f"[obs] audit: {len(audited)} audited of {len(records)} records, every "
          f"observed error within its promise (max ratio "
          f"{summary['audit']['max_error_ratio']:.4f}); provenance "
          f"{summary['audit']['provenance']}; the exact scan's wall median "
          f"{statistics.median(exact_ms):.2f} ms (min {min(exact_ms):.2f}, max "
          f"{max(exact_ms):.2f})  [{smi}]")

    # each span against TaqaReport's stage times: a span encloses the stage
    # its report times, and every stage ends in a host read
    spans = {}
    for qn, h in solo.items():
        spans[qn] = span_vs_report(h)
        for name, (sp, rt) in spans[qn].items():
            check(sp is not None and sp >= rt,
                  f"obs {qn}: span {name} {sp} s shorter than the report's {rt} s")
        print(f"[obs] {qn} spans against TaqaReport (ms): " + "; ".join(
            f"{n} {sp * 1e3:.3f} vs {rt * 1e3:.3f}" for n, (sp, rt) in spans[qn].items())
            + f"  [{smi}]")
    summary["spans_ms"] = {qn: {n: [v * 1e3 for v in pair] for n, pair in d.items()}
                           for qn, d in spans.items()}

    # the flight recorder: replayed offline, it rebuilds the live time-series
    on.close()
    path = os.path.join(out_dir, "on.jsonl")
    events = list(replay(path))
    rebuilt, live = rebuild_timeseries(replay(path)), on.timeseries
    check(set(rebuilt.keys()) == set(live.keys()), "obs: rebuilt templates differ")
    for key in live.keys():
        a, b = live.series(key), rebuilt.series(key)
        fields = ("deliveries", "cached", "shared", "fused", "staged", "fallbacks",
                  "failures", "audited", "audit_violations")
        check([getattr(a, f) for f in fields] == [getattr(b, f) for f in fields],
              f"obs: rebuilt counters of {key} differ: live "
              f"{[getattr(a, f) for f in fields]}, rebuilt "
              f"{[getattr(b, f) for f in fields]} ({fields})")
        check(len(a.latency_s.values()) == len(b.latency_s.values()) and all(
            abs(x - y) <= 1e-6 for x, y in zip(a.latency_s.values(), b.latency_s.values())),
            f"obs: rebuilt latencies of {key} differ")
    rec = on.recorder.stats()
    ev_types = {}
    for e in events:
        ev_types[e["ev"]] = ev_types.get(e["ev"], 0) + 1
    summary["recorder"] = {**rec, "bytes": os.path.getsize(path), "events": ev_types,
                           "templates": len(live.keys())}
    check(rec["dropped"] == 0 and rec["emitted"] == len(events),
          f"obs: recorder {rec}, {len(events)} replayed")
    print(f"[obs] flight recorder: {rec['emitted']} events, "
          f"{summary['recorder']['bytes']:,} bytes ({ev_types}); replayed, it "
          f"rebuilds the live time-series of {len(live.keys())} templates")
    print(f"[obs] SLO (p95 <= {OBS_SLO_P95_S} s): {on.slo.summary()['targets']} "
          f"targets, breaches {on.slo.summary()['breaches_total']}")

    # walls off against on, in turns: the sql queries and the herd's drain
    timing = {"off": {}, "stream": {}, "on_no_audit": {**hooks("t_noaudit"), "audit": False},
              "on": hooks("t_on")}
    tsess = {}
    for tag, kw in timing.items():
        tsess[tag] = Session(seed=42, config=SessionConfig(**base, **kw))
        tsess[tag].register_table("lineitem", li)
    runs = {(tag, qn): {"wall": [], "pilot_frame": [], "final_frame": []}
            for tag in tsess for qn in (*OBS_QUERIES, "herd")}
    for i in range(-1, OBS_RUNS):  # round -1 warms each session, untimed
        order = list(tsess.items()) if i % 2 == 0 else list(tsess.items())[::-1]
        for qn, sql in OBS_QUERIES.items():
            for tag, s in order:
                t0 = time.perf_counter()
                h = s.sql(sql + GUARANTEE, stream=tag != "off")
                torch.cuda.synchronize()
                check(h.status == "done", f"obs timing {tag} {qn}: {h.error}")
                if i < 0:
                    continue
                r = runs[(tag, qn)]
                r["wall"].append(time.perf_counter() - t0)
                for f in h.frames():
                    r["pilot_frame" if f.kind == "pilot" else "final_frame"].append(
                        f.emitted_at)
        for tag, s in order:
            t0 = time.perf_counter()
            batch = [s.submit(q, stream=tag != "off") for q in herd]
            s.drain()
            torch.cuda.synchronize()
            check(all(h.status == "done" for h in batch), f"obs timing {tag} herd")
            if i < 0:
                continue
            runs[(tag, "herd")]["wall"].append(time.perf_counter() - t0)
            st = s.scheduler.last_drain
            if tag != "off":
                runs[(tag, "herd")]["pilot_frame"].append(st.time_to_first_frame_s)
                runs[(tag, "herd")]["final_frame"].append(st.time_to_final_s)
    walls = {}
    for (tag, qn), r in runs.items():
        med = {k: (statistics.median(v) * 1e3 if v else None) for k, v in r.items()}
        med["walls_ms"] = [v * 1e3 for v in r["wall"]]
        med["min_wall"] = min(r["wall"]) * 1e3
        # the median of the round-by-round differences from the hooks-off
        # wall of the same round (the two ran next to each other)
        med["paired_diff"] = statistics.median(
            (a - b) * 1e3 for a, b in zip(r["wall"], runs[("off", qn)]["wall"]))
        walls[f"{tag} {qn}"] = med
    for qn in (*OBS_QUERIES, "herd"):
        w_off = walls[f"off {qn}"]["wall"]
        line = "; ".join(
            f"{tag} {walls[f'{tag} {qn}']['wall']:.2f} ({walls[f'{tag} {qn}']['wall'] - w_off:+.2f}; "
            f"paired {walls[f'{tag} {qn}']['paired_diff']:+.2f}; min "
            f"{walls[f'{tag} {qn}']['min_wall']:.2f})"
            for tag in tsess)
        frames = "; ".join(
            f"{tag} pilot {walls[f'{tag} {qn}']['pilot_frame']:.2f} / final "
            f"{walls[f'{tag} {qn}']['final_frame']:.2f}"
            for tag in tsess if tag != "off" and walls[f"{tag} {qn}"]["final_frame"] is not None)
        since = "the drain's start" if qn == "herd" else "submission"
        print(f"[obs] {qn} walls, median of {OBS_RUNS} in turns (ms, against off): "
              f"{line}; frames from {since} (ms): {frames}  [{smi}]")
    summary["walls"] = walls

    # the device idle share of one traced query (hooks on but the audit, so
    # the profiled call is the query alone), and of one with every hook on
    idle = {}
    for tag in ("on_no_audit", "on"):
        busy, pwall = device_busy_ms(
            torch, lambda: tsess[tag].sql(Q6 + GUARANTEE, stream=True))
        idle[tag] = {"device_busy_ms": busy, "profiled_wall_ms": pwall,
                     "idle_share": None if busy is None else 1 - busy / pwall}
        share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
        print(f"[obs] traced Q6 ({tag}) under torch.profiler: device kernels "
              f"{busy if busy is None else round(busy, 4)} ms of {pwall:.2f} ms; "
              f"device idle share {share}  [{smi}]")
    summary["idle"] = idle
    for s in (*sessions.values(), *tsess.values()):
        s.close()
    shutil.rmtree(out_dir, ignore_errors=True)
    summary["launches"] = launches
    summary["frames"] = kinds
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[obs] phase 11 in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


# ---------------------------------------------------------------------------
# phase 12 helpers: serving — the SQL gateway, and LM serving
# ---------------------------------------------------------------------------

def gateway_round(torch, gw, clients, streaming):
    """One gateway round: ``streaming`` (a client name or None) posts the
    herd through submit_streaming first, then every client in ``clients``
    posts it through submit; one run().  Returns (ticket -> sql, streaming
    tickets, results, wall s from the first submission, start time)."""
    t0 = time.perf_counter()
    tickets, streamed = {}, []
    if streaming:
        for sql in HERD:
            t = gw.submit_streaming(streaming, sql)
            tickets[t] = sql
            streamed.append(t)
    for c in clients:
        for sql in HERD:
            tickets[gw.submit(c, sql)] = sql
    results = gw.run()
    torch.cuda.synchronize()
    return tickets, streamed, results, time.perf_counter() - t0, t0


def check_round(np, tickets, results, want, what):
    check(set(results) == set(tickets),
          f"{what}: {len(results)} of {len(tickets)} tickets delivered")
    for t, sql in tickets.items():
        h = results[t]
        check(h.status == "done", f"{what}: {h.error}\n{sql}")
        check(same_bits(np, h.answer.values, want[sql]),
              f"{what}: {h.answer.values} is not bitwise Session.sql's "
              f"{want[sql]}\n{sql}")


def run_gateway(torch, np, li, Session, SessionConfig, kernels, recorder, smi):
    """Phase 12 (a) on SF10 lineitem: ``SqlGateway`` over a session (seed
    42, telemetry on), four clients posting phase 6's herd and a fifth
    streaming it; every answer bitwise an equal-seed ``Session.sql``'s with
    the result cache off; the streams, the result cache, backpressure, the
    payload and the dashboard checked."""
    from repro_torch.api import BackpressureError
    from repro_torch.serve import SqlGateway, write_dashboard
    t_phase = time.perf_counter()
    for fn in kernels:
        recorder.calls[fn.__name__].clear()
    ref = Session(seed=42, config=SessionConfig(result_cache_size=0))
    ref.register_table("lineitem", li)
    want = {}
    for sql in HERD:
        h = ref.sql(sql)
        check(h.status == "done", f"gateway reference: {h.error}\n{sql}")
        want[sql] = h.answer.values
    ref.close()

    session = Session(seed=42, config=SessionConfig(telemetry=True))
    session.register_table("lineitem", li)
    gw = SqlGateway(session)
    clients = [f"client{i}" for i in range(GATEWAY_CLIENTS)]

    # the cold round, counters zeroed just before and read just after
    zero_counters(kernels)
    recorder.active = {fn.__name__ for fn in kernels}
    tickets, streamed, results, cold_s, t0 = gateway_round(torch, gw, clients, "stream")
    recorder.active = set()
    launches = read_counters(kernels)
    drain = gw.scheduler.last_drain
    check_round(np, tickets, results, want, "gateway cold round")
    # the Q6 windows' pilots stack (one filtered_agg_batched launch beside
    # the batched finals'): no solo filtered_agg launch; every other kernel
    for name, n in launches.items():
        check(n == 0 if name == "filtered_agg" else n > 0,
              f"the gateway round launched {name} {n} times")
    frames = gw.frames_for("stream")
    by_ticket = {}
    for f in frames:
        by_ticket.setdefault(f.query_id, []).append(f)
    kinds = set()
    for t in streamed:
        fs = by_ticket.get(t, [])
        k = tuple(f.kind for f in fs)
        kinds.add(k)
        check(len(fs) == 2 and k[0] == "pilot" and fs[1].terminal,
              f"gateway stream {tickets[t]}: frames {k}")
        check(fs[1].answer is results[t].answer
              and same_bits(np, fs[1].answer.values, results[t].answer.values),
              f"gateway stream {tickets[t]}: the final frame is not the answer")
        check(fs[0].t_emit <= fs[1].t_emit, "a pilot frame after its final")
    first_pilot_ms = (min(f.t_emit for f in frames if f.kind == "pilot") - t0) * 1e3
    cold = gw.stats.as_dict()
    print(f"[gateway] cold round: {len(tickets)} tickets ({GATEWAY_CLIENTS} clients x "
          f"{len(HERD)} + {len(streamed)} streamed) in {cold_s * 1e3:.2f} ms; pilots "
          f"{cold['pilots_run']}, result hits {cold['result_hits']}, drains "
          f"{cold['drains']}; first pilot frame {first_pilot_ms:.2f} ms after the first "
          f"submission (drain: first frame {drain.time_to_first_frame_s * 1e3:.2f} ms, "
          f"last final {drain.time_to_final_s * 1e3:.2f} ms); stream frames "
          f"{sorted(kinds)}; launches {launches}  [{smi}]")
    check(cold["pilots_run"] == HERD_PILOTS,
          f"gateway cold round: {cold['pilots_run']} pilots, expected {HERD_PILOTS}")

    # warm rounds: every ticket from the result cache, no launch
    warm_walls = []
    for _ in range(3):
        hits = gw.stats.result_hits
        zero_counters(kernels)
        tickets, _, results, wall, _ = gateway_round(torch, gw, clients, "stream")
        warm_walls.append(wall * 1e3)
        check_round(np, tickets, results, want, "gateway warm round")
        check(all(h.cached for h in results.values()), "gateway warm round: a ticket ran")
        check(gw.stats.result_hits - hits == len(tickets),
              f"gateway warm round: {gw.stats.result_hits - hits} result hits")
        check(not any(read_counters(kernels).values()),
              f"gateway warm round launched {read_counters(kernels)}")
        gw.frames_for("stream")
    warm_ms = statistics.median(warm_walls)
    print(f"[gateway] warm rounds (result cache): {len(tickets)} tickets each, all "
          f"cached, {gw.stats.result_hits} result hits so far, no launch; wall median "
          f"{warm_ms:.2f} ms of {[round(w, 2) for w in warm_walls]}  [{smi}]")

    # one client's herd through the gateway against the session's own drain
    # of it, the result cache cleared before each, in turns
    one = SqlGateway(session)
    walls = {"gateway": [], "drain": []}
    for i in range(GATEWAY_RUNS):
        for mode in (("gateway", "drain") if i % 2 == 0 else ("drain", "gateway")):
            session.result_cache.clear()
            if mode == "gateway":
                _, _, results, wall, _ = gateway_round(torch, one, ["solo"], None)
                answers = {h.sql: h.answer.values for h in results.values()}
            else:
                t0 = time.perf_counter()
                hs = [session.submit(sql) for sql in HERD]
                session.drain()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                answers = {h.sql: h.answer.values for h in hs}
            walls[mode].append(wall * 1e3)
            check(all(same_bits(np, answers[sql], want[sql]) for sql in HERD),
                  f"gateway vs drain ({mode}): an answer is not bitwise Session.sql's")
    med = {k: statistics.median(v) for k, v in walls.items()}
    paired = statistics.median(a - b for a, b in zip(walls["gateway"], walls["drain"]))
    print(f"[gateway] one client's {len(HERD)}-query herd, result cache cleared, "
          f"{GATEWAY_RUNS} each in turns: gateway round median {med['gateway']:.2f} ms "
          f"{[round(w, 2) for w in walls['gateway']]}; session drain median "
          f"{med['drain']:.2f} ms {[round(w, 2) for w in walls['drain']]}; paired "
          f"difference median {paired:+.2f} ms  [{smi}]")

    # the device idle share of one full round, the result cache cleared
    session.result_cache.clear()
    busy, pwall = device_busy_ms(torch, lambda: gateway_round(torch, gw, clients, "stream"))
    gw.frames_for("stream")
    share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
    print(f"[gateway] one round (result cache cleared) under torch.profiler: device "
          f"kernels {busy if busy is None else round(busy, 4)} ms of {pwall:.2f} ms wall; "
          f"device idle share {share}  [{smi}]")

    # backpressure: the fifth submission to a gateway of max_pending 4
    small = SqlGateway(session, max_pending=GATEWAY_PENDING)
    for sql in HERD[:GATEWAY_PENDING]:
        small.submit("c", sql)
    try:
        small.submit("c", HERD[GATEWAY_PENDING])
        refused = False
    except BackpressureError:
        refused = True
    check(refused and small.stats.throttled == 1 and small.stats.requests == GATEWAY_PENDING,
          f"max_pending={GATEWAY_PENDING}: the fifth submission was not refused")
    check(len(small.run()) == GATEWAY_PENDING, "the admitted four did not drain")

    # the payload, the Prometheus text and the dashboard
    payload, text = gw.stats_payload(), gw.metrics_text()
    json.dumps(payload)
    g = payload["gateway"]
    for key in ("requests", "served", "drains", "pilots_run", "result_hits", "streams",
                "frames_pushed"):
        check(g[key] == getattr(gw.stats, key) > 0, f"payload gateway.{key}: {g[key]}")
        check(f"{gw._collector_name}_{key} {getattr(gw.stats, key)}\n" in text,
              f"metrics_text lacks {gw._collector_name}_{key}")
    check(payload["result_cache"]["hits"] >= gw.stats.result_hits,
          f"payload result_cache {payload['result_cache']}")
    path = os.path.join(ROOT, "build", "serve", "dashboard.html")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    check(write_dashboard(path, session) == path, "write_dashboard failed")
    with open(path, encoding="utf-8") as fh:
        doc = fh.read()
    templates = session.timeseries.snapshot()["templates"]
    table = doc.split("<h2>Per-template time-series</h2>")[1].split("<h2>")[0]
    rows = table.count("<tr><td class='k'>")
    check("<svg" in doc and rows == len(templates) >= 1,
          f"dashboard: {rows} template rows for {len(templates)} templates")
    print(f"[gateway] stats_payload: gateway {g}; metrics_text {len(text.splitlines())} "
          f"lines; dashboard {path} ({len(doc):,} B, {rows} template rows, sparklines); "
          f"max_pending={GATEWAY_PENDING} refused the fifth submission  [{smi}]")
    session.close()
    calls = {}
    for fn in kernels:
        calls[fn.__name__] = dict(recorder.calls[fn.__name__])
        recorder.calls[fn.__name__].clear()
    summary = {"tickets": len(tickets), "cold_ms": cold_s * 1e3, "warm_ms": warm_ms,
               "warm_walls_ms": warm_walls, "first_pilot_frame_ms": first_pilot_ms,
               "drain_ttff_ms": drain.time_to_first_frame_s * 1e3,
               "drain_ttf_ms": drain.time_to_final_s * 1e3,
               "one_client_gateway_ms": med["gateway"], "one_client_drain_ms": med["drain"],
               "one_client_paired_ms": paired, "one_client_walls_ms": walls,
               "device_busy_ms": busy, "profiled_wall_ms": pwall, "launches": launches,
               "gateway": g, "calls": calls, "phase_s": time.perf_counter() - t_phase}
    print(f"[gateway] phase 12 (a) in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


def logit_gap(torch, got, want, vocab):
    """Gaps between two (positions, Vp) logit stacks: max |diff|, mean |diff|
    over mean |logit|, and argmax agreement over the real vocab."""
    d = (got - want).abs()
    return {"max_abs": float(d.max()), "mean_rel": float(d.mean() / want.abs().mean()),
            "argmax_agree": int((got[:, :vocab].argmax(-1) == want[:, :vocab].argmax(-1)).sum()),
            "positions": int(got.shape[0])}


def teacher_forcing(torch, model, tokens, n_prompt, cache_len, kernels, recorder=None,
                    extra=None):
    """The forward's logits over ``tokens`` (1, N) at positions n_prompt - 1
    .. N - 1, and prefill(tokens[:, :n_prompt]) then N - n_prompt decode
    steps at the same positions; the kernels' launches counted (and, with a
    ``recorder``, their inputs recorded) over the prefill alone.  ``extra``:
    the family's other inputs (``frames``, ``patch_embeds``), given to the
    forward and the prefill; a VLM's text positions follow its patches.
    Returns (decode logits, forward logits, launches)."""
    extra = extra or {}
    skip = model.cfg.num_patches if model.cfg.family == "vlm" else 0
    with torch.inference_mode():
        full, _ = model({"tokens": tokens, **extra})
        want = full[0, skip + n_prompt - 1:].float()
        del full
        zero_counters(kernels)
        if recorder is not None:
            recorder.active = {fn.__name__ for fn in kernels}
        lg, cache = model.prefill({"tokens": tokens[:, :n_prompt], **extra},
                                  cache_len=cache_len)
        torch.cuda.synchronize()
        if recorder is not None:
            recorder.active = set()
        launches = read_counters(kernels)
        got = [lg[0].float()]
        for t in range(n_prompt, tokens.shape[1]):
            lg, cache = model.decode_step(cache, tokens[:, t])
            got.append(lg[0].float())
    return torch.stack(got), want, launches


def check_teacher_forcing(torch, np, model, tokens, n_prompt, cache_len, kernels, recorder,
                          what, smi, extra=None, plain_f32=False):
    """Decode against the forward in the model's bf16 and, on the same
    weights, in f32.  f32: mean |diff| / mean |logit| <= 1e-3 and every
    argmax but one equal (only summation orders differ).  bf16: each side
    rounds differently, so the bound is the bf16 forward's own distance
    from the f32 forward at the same positions: max |diff| at most 3x it,
    and the argmax agreement at least n (2a - 1) - 3, a the fraction of
    positions where the bf16 and f32 forwards agree.  ``plain_f32``: the f32
    pass attends through the plain version (a head dim with no f32
    kernel); the bf16 pass always through the kernels."""
    from repro_torch.kernels.flash_attn import flash_attention_ref
    from repro_torch.models import Model, layers
    vocab = model.cfg.vocab_size
    got, want, launches = teacher_forcing(torch, model, tokens, n_prompt, cache_len, kernels,
                                          recorder, extra)
    m32 = Model(dataclasses.replace(model.cfg, dtype="float32"))
    m32.load_state_dict(model.state_dict())
    saved = layers.flash_attention
    if plain_f32:
        layers.flash_attention = lambda *a, q_offset=0, **kw: flash_attention_ref(*a, **kw)
    try:
        got32, want32, _ = teacher_forcing(torch, m32, tokens, n_prompt, cache_len, kernels,
                                           extra=extra)
    finally:
        layers.flash_attention = saved
    del m32
    torch.cuda.empty_cache()
    bf16 = logit_gap(torch, got, want, vocab)
    f32 = logit_gap(torch, got32, want32, vocab)
    noise = logit_gap(torch, want, want32, vocab)
    n = bf16["positions"]
    a = noise["argmax_agree"] / n
    print(f"[serve] {what}: decode vs forward at {n} positions: bf16 max |diff| "
          f"{bf16['max_abs']:.4g} (mean rel {bf16['mean_rel']:.3g}), argmax "
          f"{bf16['argmax_agree']}/{n}; f32 max |diff| {f32['max_abs']:.4g} (mean rel "
          f"{f32['mean_rel']:.3g}), argmax {f32['argmax_agree']}/{n}; the bf16 forward vs "
          f"the f32 forward: max |diff| {noise['max_abs']:.4g} (mean rel "
          f"{noise['mean_rel']:.3g}), argmax {noise['argmax_agree']}/{n}  [{smi}]")
    check(f32["mean_rel"] <= 1e-3 and f32["argmax_agree"] >= n - 1,
          f"{what}: f32 decode disagrees with the f32 forward: {f32}")
    check(bf16["max_abs"] <= 3 * noise["max_abs"],
          f"{what}: bf16 decode max |diff| {bf16['max_abs']} above 3x the bf16 "
          f"forward's own {noise['max_abs']}")
    check(bf16["argmax_agree"] >= n * (2 * a - 1) - 3,
          f"{what}: bf16 argmax agreement {bf16['argmax_agree']}/{n} (bf16 vs f32 "
          f"forward {noise['argmax_agree']}/{n})")
    return {"bf16": bf16, "f32": f32, "bf16_forward_vs_f32": noise,
            "prefill_launches": launches}


def serve_requests(np, vocab, n, prompt, new, seed):
    """``n`` (prompt, max_new_tokens) pairs from ``seed``: prompt lengths in
    ``prompt`` and budgets in ``new``, both inclusive ranges."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(prompt[0], prompt[1] + 1))).tolist(),
             int(rng.integers(new[0], new[1] + 1))) for _ in range(n)]


def run_engine(torch, np, model, slots, cache_len, requests, what, smi):
    """``ServeEngine`` over ``requests`` on ``model``: every request served
    with its count of tokens in [0, vocab), the cache in place; each decode
    step timed (host clock to a synchronize) beside the step's bytes bound
    (weights and cache read once at 3.35 TB/s); one step under the
    profiler.  Returns (engine, outputs, summary)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, batch_slots=slots, cache_len=cache_len)
    step, step_ms = model.decode_step, []

    def timed_step(cache, token):
        t0 = time.perf_counter()
        out = step(cache, token)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    layout = {k: (v.data_ptr(), tuple(v.shape)) for k, v in eng.cache.items()}
    for prompt, budget in requests:
        eng.submit(prompt, budget)
    model.decode_step = timed_step
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = eng.run()
            wall = time.perf_counter() - t0
    finally:
        del model.decode_step
    vocab = model.cfg.vocab_size
    check(sorted(out) == list(range(len(requests))), f"{what}: served {sorted(out)}")
    for i, (_, budget) in enumerate(requests):
        check(len(out[i]) == budget and all(0 <= t < vocab for t in out[i]),
              f"{what}: request {i} gave {len(out[i])} of {budget} tokens")
    check({k: (v.data_ptr(), tuple(v.shape)) for k, v in eng.cache.items()} == layout,
          f"{what}: the cache moved")
    tokens = sum(len(v) for v in out.values())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_bytes = {k: v.numel() * v.element_size() for k, v in eng.cache.items()}
    bound_ms = (weights + sum(cache_bytes.values())) / HBM_BYTES_PER_S * 1e3
    med = statistics.median(step_ms)
    tok = torch.zeros(slots, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        busy, pwall, top = device_profile(torch, lambda: model.decode_step(eng.cache, tok), top=6)
    share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
    print(f"[serve] {what}: ServeEngine(batch_slots={slots}, cache_len={cache_len}) "
          f"served {len(out)} requests, {tokens} tokens in {wall:.2f} s = "
          f"{tokens / wall:,.1f} tokens/s over {eng.steps} engine steps; decode step "
          f"median {med:.2f} ms (p10 {np.percentile(step_ms, 10):.2f}, p90 "
          f"{np.percentile(step_ms, 90):.2f}) against a bound of {bound_ms:.3f} ms "
          f"(weights {weights / 1e9:.3f} GB + cache {sum(cache_bytes.values()) / 1e6:.1f} MB "
          f"{ {k: round(v / 1e6, 1) for k, v in cache_bytes.items()} } at 3.35 TB/s); one "
          f"step under torch.profiler: device {busy if busy is None else round(busy, 3)} ms "
          f"of {pwall:.2f} ms wall, device idle share {share}  [{smi}]")
    for kname, kms, count in top:
        print(f"[serve]   device {kms:8.3f} ms  x{count:<4d} {kname[:110]}")
    return eng, out, {"requests": len(out), "tokens": tokens, "wall_s": wall,
                      "tokens_per_s": tokens / wall, "steps": eng.steps,
                      "step_ms_median": med, "step_ms_p10": float(np.percentile(step_ms, 10)),
                      "step_ms_p90": float(np.percentile(step_ms, 90)),
                      "bound_ms": bound_ms, "weights_bytes": weights,
                      "cache_bytes": cache_bytes, "device_busy_ms": busy,
                      "profiled_wall_ms": pwall, "device_top": top}


def run_lm_serving(torch, np, smi, recorder, model_wrappers):
    """Phase 12 (b)-(d): hymba-1.5b and granite-moe-1b-a400m at full width in
    bf16 — prefill and decode against teacher forcing, ServeEngine — and
    small f32 configs on the card against the CPU port."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    summary = {}

    # (b) hymba-1.5b: the ring rolls in the prefill; the SSM state seeds decode
    cfg = get_config(SERVE_ARCH)
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(EVAL_SEED))
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, SERVE_PREFILL + SERVE_DECODE))).cuda()
    tf = check_teacher_forcing(torch, np, model, tokens, SERVE_PREFILL, SERVE_CACHE_LEN,
                               model_wrappers, recorder, f"{cfg.name} prefill "
                               f"{SERVE_PREFILL} + {SERVE_DECODE} decode steps", smi)
    launches = tf["prefill_launches"]
    check(all(n == cfg.num_layers for n in launches.values()),
          f"{cfg.name} prefill launches {launches}, expected {cfg.num_layers} each")
    requests = serve_requests(np, cfg.vocab_size, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, 22)
    eng, out, engine = run_engine(torch, np, model, SERVE_SLOTS, SERVE_CACHE_LEN,
                                  requests, cfg.name, smi)
    again = ServeEngine(model, batch_slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN)
    again.submit(*requests[0])
    with torch.inference_mode():
        check(again.run()[0] == out[0],
              f"{cfg.name}: request 0 re-served in a fresh engine gave other tokens")
    print(f"[serve] {cfg.name}: prefill launches {launches}; request 0 re-served alone "
          f"in a fresh {SERVE_SLOTS}-slot engine: the same {len(out[0])} tokens  [{smi}]")
    summary[cfg.name] = {"teacher_forcing": tf, "engine": engine}
    del model, eng, again
    torch.cuda.empty_cache()

    # (c) granite-moe-1b-a400m: the forward through moe_ffn, then serving
    cfg = get_config(SERVE_MOE_ARCH)
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(EVAL_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, MOE_FORWARD))).cuda()
    capacity = max(int(MOE_FORWARD * cfg.top_k * cfg.capacity_factor / cfg.num_experts),
                   cfg.top_k)
    zero_counters(model_wrappers)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, aux = model({"tokens": tokens})
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = read_counters(model_wrappers)
    check(bool(torch.isfinite(logits).all()) and np.isfinite(float(aux)) and float(aux) > 0,
          f"{cfg.name}: forward logits or aux loss not finite ({float(aux)})")
    print(f"[serve] {cfg.name} at full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}), "
          f"{cfg.dtype}: {n_params:,} parameters, {n_params * 2 / 1e9:.3f} GB; forward over "
          f"1 x {MOE_FORWARD} tokens through moe_ffn (capacity {capacity}) {fwd_ms:.1f} ms, "
          f"aux loss {float(aux):.6f}, launches {fwd_launches}  [{smi}]")
    del logits
    # teacher forcing at a dropless capacity (E / K): the forward's dispatch
    # then routes every pair, as the decode's dense route does (the
    # reference's teacher-forcing test raises capacity_factor for the same
    # reason)
    model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    tokens = tokens[:, :MOE_PREFILL + MOE_DECODE]
    tf = check_teacher_forcing(torch, np, model, tokens, MOE_PREFILL,
                               MOE_PREFILL + MOE_DECODE, model_wrappers, recorder,
                               f"{cfg.name} prefill {MOE_PREFILL} + {MOE_DECODE} "
                               "decode steps", smi)
    check(tf["prefill_launches"]["flash_attention"] == cfg.num_layers,
          f"{cfg.name} prefill launches {tf['prefill_launches']}")
    model.cfg = cfg
    requests = serve_requests(np, cfg.vocab_size, MOE_REQUESTS, SERVE_PROMPT, SERVE_NEW, 23)
    _, _, engine = run_engine(torch, np, model, MOE_SLOTS, MOE_CACHE_LEN, requests,
                              cfg.name, smi)
    summary[cfg.name] = {"teacher_forcing": tf, "engine": engine, "forward_ms": fwd_ms,
                         "aux_loss": float(aux), "capacity": capacity,
                         "forward_launches": fwd_launches}
    del model
    torch.cuda.empty_cache()

    # (d) small f32 configs whose widths the kernels take: the card against
    # the CPU port, prefill and 16 decode steps
    small_err = {}
    for arch, kw in SERVE_SMALL.items():
        small = get_config(arch).reduced(**kw)
        cpu = Model(small, device="cpu").init(torch.Generator().manual_seed(5))
        gpu = Model(small)
        gpu.load_state_dict(cpu.state_dict())
        toks = torch.from_numpy(np.random.default_rng(6).integers(0, small.vocab_size, (2, 40)))
        errs = []
        with torch.inference_mode():
            lc, cc = cpu.prefill({"tokens": toks[:, :24]}, cache_len=48)
            lg, cg = gpu.prefill({"tokens": toks[:, :24].cuda()}, cache_len=48)
            errs.append(float((lg.cpu() - lc).abs().max()))
            for t in range(24, 40):
                lc, cc = cpu.decode_step(cc, toks[:, t])
                lg, cg = gpu.decode_step(cg, toks[:, t].cuda())
                errs.append(float((lg.cpu() - lc).abs().max()))
        small_err[arch] = max(errs)
        check(small_err[arch] <= SMALL_TOL,
              f"small f32 {arch}: card vs CPU logits max |diff| {small_err[arch]}")
        print(f"[serve] small f32 {arch} ({small.num_layers} layers, d_model "
              f"{small.d_model}, head_dim {small.head_dim}"
              f"{', window %d' % small.sliding_window if small.sliding_window else ''}): "
              f"prefill 24 + 16 decode steps, card vs the CPU port, max |diff| "
              f"{small_err[arch]:.3g} (tolerance {SMALL_TOL:g})  [{smi}]")
    summary["small_max_abs_err"] = small_err
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[serve] phase 12 (b)-(d) in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


# ---------------------------------------------------------------------------
# phase 3b / 7 helpers: the model kernels and the eval slice
# ---------------------------------------------------------------------------

def attention_pairs(np, sq, skv, causal, window):
    """(query, key) pairs the masks keep: the work attention needs."""
    r = np.arange(sq)
    hi = np.minimum(r, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, r - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(np, q, k, kw):
    """(flops, bytes) one flash call needs: 4 d flops per kept (q, k) pair
    (QK^T and PV), q, k, v read once and o written once."""
    b, hq, sq, d = q.shape
    pairs = attention_pairs(np, sq, k.shape[2], kw.get("causal", True),
                            kw.get("window", 0))
    return 4 * d * pairs * b * hq, (2 * q.numel() + 2 * k.numel()) * q.element_size()


def gla_work(q, v):
    """(flops, bytes) one gla_chunked call needs at the kernel's chunk of
    64: per chunk the inter term and the state update (2 C dk dv each), the
    lower-triangular A (2 dk per pair) and A v (2 dv per pair); q, k, g, v
    read once, o and the f32 state written once."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = 64
    tri = c * (c + 1) // 2
    flops = b * h * -(-t // c) * (4 * c * dk * dv + 2 * tri * (dk + dv))
    nbytes = (3 * q.numel() + 2 * v.numel()) * q.element_size() + b * h * dk * dv * 4
    return flops, nbytes


def least_ms(flops, nbytes, dtype):
    """The card's least time for the work: the larger of the bytes over the
    memory rate and the flops over the dense peak of the inputs' type."""
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa(torch, q, k, v, causal, window):
    """One PyTorch call for flash_attention's function (the library
    yardstick, timed only): ``scaled_dot_product_attention`` with GQA and
    the same mask."""
    F = torch.nn.functional
    if not window:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True)
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = cols > rows - window
    if causal:
        mask = mask & (cols <= rows)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


# (rtol, atol) of each model kernel's outputs against its plain version, by
# input dtype.  f32: the reference's own tests' (flash 2e-3, GLA 3e-3).  bf16
# flash: both compute in f32 and round once to bf16, so they may differ by one
# bf16 step, at most 2^-7 |o| (7.8e-3 |o|); rtol 1e-2 holds that and atol
# 1e-4 the f32 noise, while a window one key short or long fails it at
# |o| ~ 0.04 (tests/test_torch_models.py).  bf16 GLA: o 2e-2, the f32 state
# 3e-3.
MODEL_TOL = {
    ("flash_attention", "torch.float32"): [(2e-3, 2e-3)],
    ("flash_attention", "torch.bfloat16"): [(1e-2, 1e-4)],
    ("gla_chunked", "torch.float32"): [(3e-3, 3e-3), (3e-3, 3e-3)],
    ("gla_chunked", "torch.bfloat16"): [(2e-2, 2e-2), (3e-3, 3e-3)],
}


def model_grids(name, q, other):
    """The (x, y) CTA grids of one model-kernel call on the card, the batch
    folded into x (the launch floor's shape; ``other``: k for flash, v for
    GLA).  Flash forward: one grid of q tiles (128 rows in bf16, 64 in f32)
    by q heads.  GLA, forward and backward alike: its three passes, (chunks,
    B H), the scan's 256-thread blocks over (B H, dk, dv), (chunks, B H)."""
    b, h, s, d = q.shape
    if name.startswith("flash"):
        rows = 128 if str(q.dtype) == "torch.bfloat16" else 64
        return [(-(-s // rows) * b, h)]
    chunks = -(-s // 64)
    return [(chunks, b * h), (-(-b * h * d * other.shape[-1] // 256), 1), (chunks, b * h)]


def time_model_kernel(torch, np, name, fn, ref, args, kw, smi, launch_floor=None):
    """Hold one model-kernel call against its plain version (``MODEL_TOL``),
    check a second launch bitwise equal, then time the kernel, its plain
    version and (flash) the library call with L2 flushed; with a
    ``launch_floor``, an empty kernel on the call's grids (``model_grids``)
    too.  Returns the row of the ``kernels`` line for these inputs."""
    q = args[0]
    ref_kw = {k: v for k, v in kw.items() if k != "q_offset"}
    got, again = fn(*args, **kw), fn(*args, **kw)
    outs = got if isinstance(got, tuple) else (got,)
    agains = again if isinstance(again, tuple) else (again,)
    want = ref(*args, **ref_kw)
    wants = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for a, b, w, (rtol, atol) in zip(outs, agains, wants,
                                     MODEL_TOL[name, str(q.dtype)]):
        check(torch.equal(a, b), f"{name} {tuple(q.shape)}: launches differ bitwise")
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol, atol=atol,
                                   msg=f"{name} {tuple(q.shape)}: kernel vs plain")
        err = max(err, float((a.float() - w.float()).abs().max()))
    if name == "flash_attention":
        flops, nbytes = flash_work(np, q, args[1], kw)
        lib = sdpa(torch, *args[:3], kw.get("causal", True), kw.get("window", 0))
        lib_err = float((lib().float() - wants[0].float()).abs().max())
        library_ms = time_cold(torch, lib, iters=10)
    else:
        flops, nbytes = gla_work(q, args[2])
        library_ms = lib_err = None
    ms = time_cold(torch, lambda: fn(*args, **kw))
    plain_ms = time_cold(torch, lambda: ref(*args, **ref_kw), iters=10)
    bound_ms, by = least_ms(flops, nbytes, q.dtype)
    other = args[1] if name == "flash_attention" else args[2]  # k, or v
    grids = model_grids(name, q, other)
    floor_ms = (None if launch_floor is None else
                sum(time_cold(torch, lambda g=g: launch_floor(*g), iters=10) for g in grids))
    # the device kernels of one call (GLA's three passes), L2 warm
    _, _, parts = device_profile(torch, lambda: fn(*args, **kw), top=4)
    where = ", ".join(f"{k}={v}" for k, v in ref_kw.items())
    lib_txt = (f", SDPA {library_ms * 1e3:.2f} us (|SDPA - plain| {lib_err:.3g})"
               if library_ms is not None else "")
    floor_txt = ("" if floor_ms is None else
                 f"; launch floor of its {len(grids)} grid(s) {floor_ms * 1e3:.2f} us")
    print(f"[kernels] {name} {tuple(q.shape)} x {tuple(other.shape)} {str(q.dtype)[6:]} "
          f"{where}: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us{lib_txt}; bound "
          f"{bound_ms * 1e3:.3f} us by {by}: {flops / 1e9:.3f} GFLOP / "
          f"{PEAK_FLOPS[str(q.dtype)] / 1e12:.0f} TFLOP/s vs {nbytes:,} B / 3.35 TB/s; "
          f"{bound_ms / ms:.1%} of bound{floor_txt}); max |kernel - plain| {err:.3g}  [{smi}]")
    for kname, kms, count in parts:
        print(f"[kernels]   one call's device kernel {kms * 1e3:9.2f} us x{count} "
              f"{kname.split('(')[0][:90]}")
    return {"shape": list(q.shape), "other_shape": list(other.shape),
            "dtype": str(q.dtype), **{k: v for k, v in ref_kw.items()},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": by, "flops": flops,
            "bytes": nbytes, "floor_ms": floor_ms, "grids": grids, "max_abs_err": err,
            "device_kernels": [[kname.split("(")[0], kms, count] for kname, kms, count in parts]}


def model_kernel_scaling_points(torch, np, dev):
    """Fixed inputs beside the eval forward's own: flash at the forward's
    width without the window (causal, the Pallas mask; and non-causal) and
    at internlm2's head_dim 128; GLA at an rwkv6 point (64 heads, dk = dv =
    64).  Returns {name: [(args, kwargs), ...]}."""
    rng = np.random.default_rng(13)

    def normal(shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(torch.bfloat16)

    b, s = EVAL_BSZ, EVAL_SEQ
    hymba = (normal((b, 25, s, 64)), normal((b, 5, s, 64)), normal((b, 5, s, 64)))
    intern = (normal((1, 16, s, 128)), normal((1, 8, s, 128)), normal((1, 8, s, 128)))
    g = -torch.nn.functional.softplus(normal((1, 64, s, 64)).float() - 1.0)
    rwkv = (normal((1, 64, s, 64), 0.5), normal((1, 64, s, 64), 0.5),
            normal((1, 64, s, 64)), g.to(torch.bfloat16).contiguous())
    return {"flash_attention": [(hymba, {"causal": True, "window": 0}),
                                (hymba, {"causal": False, "window": 0}),
                                (intern, {"causal": True, "window": 0})],
            "gla_chunked": [(rwkv, {})]}


def run_eval(torch, np, smi, recorder, model_wrappers):
    """Phase 7: hymba-1.5b at full width through GuaranteedEvaluator on the
    card, the exact mean over every shard as the yardstick."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_approx_eval as example
    from repro_torch.aqpeval import GuaranteedEvaluator
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention_ref
    from repro_torch.kernels.gla_chunk import gla_chunked_ref
    from repro_torch.models import Model, layers, linear_attn

    cfg = get_config(EVAL_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(EVAL_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[eval] {cfg.name} at full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim}, window {cfg.sliding_window}, {cfg.num_ssm_heads} SSM "
          f"heads dk {cfg.ssm_state} dv {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} padded to {model.embed.shape[0]}), {cfg.dtype}: "
          f"{n_params:,} parameters, {n_params * 2 / 1e9:.3f} GB; random init "
          f"(seed {EVAL_SEED}) in {time.perf_counter() - t0:.2f} s")
    shards = example.eval_corpus(cfg.vocab_size, EVAL_SHARDS, EVAL_BSZ, EVAL_SEQ)
    block_metric, calls = example.make_block_metric(model, shards)
    block_metric(np.arange(1))  # warm-up: cuBLAS handles, first kernel loads
    torch.cuda.synchronize()

    # the main path, counters zeroed just before it and read just after
    stages = []

    def staged_metric(ids):
        t = time.perf_counter()
        out = block_metric(ids)
        stages.append((len(ids), time.perf_counter() - t))
        return out

    zero_counters(model_wrappers)
    recorder.active = {fn.__name__ for fn in model_wrappers}
    t0 = time.perf_counter()
    res = GuaranteedEvaluator(EVAL_SHARDS, staged_metric, seed=EVAL_EVAL_SEED).evaluate(
        error=EVAL_ERROR, confidence=EVAL_CONFIDENCE, pilot_blocks=EVAL_PILOT_BLOCKS)
    approx_wall = time.perf_counter() - t0
    recorder.active = set()
    launches = read_counters(model_wrappers)
    forwards = res.pilot_blocks + res.final_blocks
    check(len(stages) == 2, f"the evaluator ran {len(stages)} metric stages")
    pilot_s, final_s = stages[0][1], stages[1][1]
    for k, n in launches.items():
        check(n == cfg.num_layers * forwards,
              f"{k}: {n} launches for {forwards} shard forwards of {cfg.num_layers} layers")

    t0 = time.perf_counter()
    s, c = block_metric(np.arange(EVAL_SHARDS))
    exact_wall = time.perf_counter() - t0
    truth = float(s.sum() / c.sum())
    check(bool(np.all(np.isfinite(s))) and np.isfinite(res.estimate),
          "non-finite eval loss")
    rel = abs(res.estimate - truth) / truth
    check(rel <= EVAL_ERROR or res.exact,
          f"eval: error {rel:.4%} above {EVAL_ERROR:.0%} without the exact fallback")
    tokens = EVAL_SHARDS * EVAL_BSZ * EVAL_SEQ
    ms_per_shard = exact_wall / EVAL_SHARDS * 1e3
    print(f"[eval] {EVAL_SHARDS} shards of {EVAL_BSZ} x {EVAL_SEQ} tokens, ERROR "
          f"{EVAL_ERROR:.0%} CONFIDENCE {EVAL_CONFIDENCE:.0%}: estimate "
          f"{res.estimate:.6f}, exact {truth:.6f}, achieved error {rel:.4%}, exact "
          f"fallback {res.exact}; pilot {res.pilot_blocks} shards, final "
          f"{res.final_blocks}, theta {res.theta:.6g}  [{smi}]")
    print(f"[eval] walls: pilot {pilot_s * 1e3:.1f} ms, plan "
          f"{(approx_wall - pilot_s - final_s) * 1e3:.2f} ms, final {final_s * 1e3:.1f} "
          f"ms, approximate total {approx_wall * 1e3:.1f} ms; exact pass over "
          f"{EVAL_SHARDS} shards {exact_wall * 1e3:.1f} ms = {ms_per_shard:.2f} ms per "
          f"shard forward, {tokens / exact_wall:,.0f} tokens/s; approx/exact wall "
          f"{approx_wall / exact_wall:.3f}  [{smi}]")
    check(exact_wall <= 60.0 or EVAL_SHARDS < 128,
          f"the exact pass took {exact_wall:.1f} s (> 60 s): cut EVAL_SHARDS")

    zero_counters(model_wrappers)
    block_metric(np.arange(1, 2))
    per_forward = read_counters(model_wrappers)
    check(all(n == cfg.num_layers for n in per_forward.values()),
          f"launches per shard forward {per_forward}, expected {cfg.num_layers} each")
    walls = []
    for i in range(3, 3 + WARM_RUNS):
        t0 = time.perf_counter()
        block_metric(np.arange(i, i + 1))
        walls.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(walls)
    busy, pwall, top = device_profile(torch, lambda: block_metric(np.arange(2, 3)), top=20)
    share = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
    print(f"[eval] main path launches {launches} over {forwards} shard forwards; per "
          f"forward {per_forward}; one shard forward unprofiled: {fwd_ms:.2f} ms "
          f"(median of {WARM_RUNS}); under torch.profiler: device "
          f"{busy if busy is None else round(busy, 3)} ms of {pwall:.2f} ms wall, "
          f"device idle share {share}; device busy / unprofiled wall "
          f"{'not measured' if busy is None else f'{busy / fwd_ms:.1%}'}  [{smi}]")
    for kname, ms, count in top:
        print(f"[eval]   device {ms:8.3f} ms  x{count:<4d} {kname[:110]}")

    # the forward at full width with the plain versions in place of the
    # kernels, on the same card and weights: in f32 the two routes differ only
    # by summation order, and must agree; in bf16 each kernel's last-bit
    # rounding differences are carried through 32 random layers (printed)
    tok = torch.from_numpy(shards[0]).cuda()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = Model(cfg32)
    model32.load_state_dict(model.state_dict())
    full = {}
    for label, m in (("bf16", model), ("f32", model32)):
        routes = []
        for plain in (False, True):
            saved = layers.flash_attention, linear_attn._gla_kernel
            if plain:
                layers.flash_attention = (
                    lambda *a, q_offset=0, **kw: flash_attention_ref(*a, **kw))
                linear_attn._gla_kernel = gla_chunked_ref
            try:
                with torch.inference_mode():
                    logits, _ = m({"tokens": tok[:, :-1]})
                    routes.append((logits.float(), float(example.shard_loss(m, tok))))
            finally:
                layers.flash_attention, linear_attn._gla_kernel = saved
        (kl, kloss), (pl, ploss) = routes
        d = (kl - pl).abs()
        full[label] = {"loss_rel": abs(kloss - ploss) / ploss,
                       "logits_rel": float(d.mean() / pl.abs().mean()),
                       "logits_max_abs": float(d.max())}
        print(f"[eval] shard 0 in {label} at full width, kernels vs plain versions: "
              f"loss {kloss:.4f} vs {ploss:.4f} (rel {full[label]['loss_rel']:.3g}); "
              f"logits mean |diff| / mean |logit| {full[label]['logits_rel']:.3g}, "
              f"max |diff| {full[label]['logits_max_abs']:.3g}")
        del routes, kl, pl, d
    check(full["f32"]["logits_rel"] <= 1e-3 and full["f32"]["loss_rel"] <= 1e-5,
          "full-width f32 forward: kernels and plain versions disagree")
    check(full["bf16"]["loss_rel"] <= 1e-3,
          "full-width bf16 forward: kernels and plain versions disagree on the loss")
    del model32
    torch.cuda.empty_cache()

    # a small f32 hymba (widths the kernels take, window 64 binding at 200
    # tokens): the card's forward against the CPU's plain versions
    small = get_config(EVAL_ARCH).reduced(d_model=256, num_heads=4, num_kv_heads=2,
                                          head_dim=64, ssm_state=16, d_ff=512,
                                          sliding_window=64)
    cpu_model = Model(small, device="cpu").init(torch.Generator().manual_seed(5))
    gpu_model = Model(small)
    gpu_model.load_state_dict(cpu_model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, small.vocab_size, (2, 200)))
    with torch.inference_mode():
        want, _ = cpu_model({"tokens": toks})
        got, _ = gpu_model({"tokens": toks.cuda()})
    small_err = float((got.cpu() - want).abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3,
                               msg="small f32 hymba: card vs CPU logits")
    print(f"[eval] small f32 hymba (2 layers, d_model 256, head_dim 64, window 64, "
          f"200 tokens): card logits vs the CPU's plain versions, max |diff| "
          f"{small_err:.3g} (tolerance 1e-3)")
    del model, gpu_model
    torch.cuda.empty_cache()
    return {"estimate": res.estimate, "exact_loss": truth, "achieved_error": rel,
            "exact_fallback": res.exact, "pilot_shards": res.pilot_blocks,
            "final_shards": res.final_blocks, "theta": res.theta,
            "pilot_ms": pilot_s * 1e3, "plan_ms": (approx_wall - pilot_s - final_s) * 1e3,
            "final_ms": final_s * 1e3, "approx_ms": approx_wall * 1e3,
            "exact_ms": exact_wall * 1e3, "ms_per_shard_forward": ms_per_shard,
            "tokens_per_s": tokens / exact_wall, "launches": launches,
            "launches_per_forward": per_forward, "forward_ms": fwd_ms,
            "forward_walls_ms": walls, "device_busy_ms": busy,
            "profiled_wall_ms": pwall, "device_top": top, "full_width": full,
            "small_max_abs_err": small_err, "parameters": n_params}


# ---------------------------------------------------------------------------
# phase 13 helpers: training — train/ and launch/train.py with the backward
# kernels
# ---------------------------------------------------------------------------

# (b) internlm2-1.8b at full width through the launcher; (d) hymba-1.5b at
# full width through make_train_step; (c) and (e) internlm2 at full width
# with depth cut to 2 layers (the plain attention's (B, H, S, S) scores must
# fit; a full-depth checkpoint is 22.7 GB of disk)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "internlm2-1.8b", 10, 2, 4096
TRAIN_HYMBA_STEPS, TRAIN_HYMBA_SEQ = 5, 2048
TRAIN_CUT_LAYERS, TRAIN_RESUME_STEPS, TRAIN_RESUME_AT = 2, 4, 2
TRAIN_PROFILED_STEP = 3          # the step whose device idle share is printed
# the learning rate of every phase-13 run.  The launcher's default, 3e-3
# (the reference's, sized for its reduced CPU configs), overshoots at full
# width: one H100 run took internlm2-1.8b from 11.93 up to 12.77 and back
# to 12.09 in 10 steps (PERF.md, PR 24).  Adam's first steps move every
# weight by ~lr, 14 % of the 0.022 scale of a d-2048 matrix at 3e-3
TRAIN_LR = 3e-4
# (a) the backward kernels at the paths' shapes (B 1), bf16 and f32, and
# small odd shapes: S 65, 127, 129, 200 (off the 64- and 128-row tiles), GQA
# 1, 2, 5, windows whose edge crosses a 128-row tile, d 64 and 128:
# (B, Hq, Hkv, S, d, causal, window)
FLASH_BWD_POINTS = [(1, 16, 8, 4096, 128, True, 0), (1, 25, 5, 2048, 64, True, 1024),
                    (1, 2, 2, 1, 64, True, 0), (1, 4, 2, 65, 64, True, 0),
                    (2, 5, 1, 127, 128, True, 16), (1, 5, 5, 200, 64, False, 0),
                    (1, 4, 2, 129, 128, True, 0), (1, 6, 3, 200, 128, True, 100),
                    (1, 5, 1, 129, 64, False, 70), (1, 2, 1, 200, 64, True, 150)]
# (B, H, T, dk, with a final-state gradient): hymba's (16, 64) and rwkv6's
# (64, 64) at T 2048, T 130 and 200 off the chunk, decays below -8 and on
# both bounds
GLA_BWD_POINTS = [(1, 25, 2048, 16, False), (1, 64, 2048, 64, False),
                  (1, 3, 130, 16, True), (2, 2, 200, 64, False),
                  (1, 2, 200, 16, True), (1, 3, 130, 64, True)]
# f32: each gradient within this share of the call's largest plain gradient
# (dq of one query is 0 up to rounding and has no scale of its own); bf16:
# within 3x the plain bf16 backward's own distance from the plain f32 one,
# or within the f32 share where that distance is 0 (the same one-query dq)
BWD_F32_REL, BWD_BF16_FACTOR = 1e-4, 3.0


def backward_sass_checks():
    """Phase 13: what the backward libraries hold, per kernel, from
    ``cuobjdump -sass`` (``repro_torch.kernels.sass``) and nvcc's
    ``-Xptxas=-v``: the bf16 flash kernels must issue HGMMA from
    UTMALDG-fed tiles, no kernel of either library may hold a RED or ATOM,
    and no bf16 kernel may spill.  Returns one row per kernel."""
    from repro_torch.kernels import _build, sass
    rows = []
    for lib in ("flash_attn_bwd", "gla_chunk_bwd"):
        usage = sass.ptxas_usage(_build.build_log(lib))
        funcs = sass.functions(_build.library_path(lib))
        check(bool(funcs) and set(usage) == set(funcs),
              f"{lib}: kernels in the SASS {sorted(funcs)} and in ptxas's log {sorted(usage)}")
        for name, text in sorted(funcs.items()):
            counts = sass.opcode_counts(text)
            u = usage[name]
            bf16 = "wgmma" in name or "__nv_bfloat16" in name or name.startswith("gla_bwd_scan")
            row = {"library": lib, "kernel": name, "bf16_route": bf16,
                   "HGMMA": counts.get("HGMMA", 0), "UTMALDG": counts.get("UTMALDG", 0),
                   "RED_ATOM": sass.atomics(counts), **u}
            rows.append(row)
            print(f"[train] (sass) {lib} {name}: HGMMA {row['HGMMA']}, UTMALDG "
                  f"{row['UTMALDG']}, RED/ATOM {row['RED_ATOM']}; {u['registers']} registers, "
                  f"spill stores / loads {u['spill_stores']} / {u['spill_loads']} B")
            check(row["RED_ATOM"] == 0, f"{name}: {row['RED_ATOM']} RED / ATOM instructions")
            if "wgmma" in name:
                check(row["HGMMA"] > 0 and row["UTMALDG"] > 0,
                      f"{name}: HGMMA {row['HGMMA']}, UTMALDG {row['UTMALDG']}")
            if bf16:
                check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
                      f"{name}: spills {u['spill_stores']} / {u['spill_loads']} B")
    check(any("wgmma" in r["kernel"] for r in rows), "flash_attn_bwd has no wgmma kernel")
    return rows


def flash_bwd_work(np, q, k, causal, window):
    """(flops, bytes) a flash backward needs: per kept (q, k) pair five
    2 d-flop products (S recomputed, dO V^T, dV, dK, dQ); q, k, v, o, dO read
    and lse read once, dq, dk, dv written once."""
    b, hq, sq, d = q.shape
    pairs = attention_pairs(np, sq, k.shape[2], causal, window)
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() + b * hq * sq * 4
    return 10 * d * pairs * b * hq, nbytes


def gla_bwd_work(q, v):
    """(flops, bytes) a GLA backward needs at chunk 64: per chunk the
    state-gradient contribution, the inter terms of dq, dk and dv (2 C dk dv
    each), B and dv's intra term (2 dv per pair), A and the intra terms of
    dq and dk (2 dk per pair); q, k, g, v, dO and the chunk-start states
    read once, dq, dk, dv, dg written once."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = 64
    chunks = -(-t // c)
    tri = c * (c + 1) // 2
    flops = b * h * chunks * (8 * c * dk * dv + 2 * tri * (2 * dv + 3 * dk))
    nbytes = (5 * q.numel() + 3 * v.numel()) * q.element_size() + b * h * chunks * dk * dv * 4
    return flops, nbytes


def sdpa_backward(torch, q, k, v, do, causal, window):
    """scaled_dot_product_attention's backward with GQA and the same mask
    (the library yardstick, timed only): a closure running autograd.grad
    over one recorded forward."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(torch, *leaves, causal, window)()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def check_backward(torch, name, got, again, plain, plain32, dtype):
    """Hold one backward's gradients to the plain backward's (``BWD_*``);
    two launches bitwise equal.  Returns (max |kernel - plain|, the
    tolerance's measure: the f32 share or the bf16 ratio)."""
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two launches differ bitwise")
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, plain))
    if dtype == torch.float32:
        scale = max(float(w.abs().max()) for w in plain)
        check(err <= BWD_F32_REL * scale,
              f"{name}: max |kernel - plain| {err:.3g} above {BWD_F32_REL} x {scale:.3g}")
        return err, err / scale
    ratio = 0.0
    noise = BWD_F32_REL * max(float(w.float().abs().max()) for w in plain32)
    for i, (g, w, w32) in enumerate(zip(got, plain, plain32)):
        own = float((w.float() - w32.float()).abs().max())
        mine = float((g.float() - w32.float()).abs().max())
        check(mine <= max(BWD_BF16_FACTOR * own, noise),
              f"{name} gradient {i}: |kernel - f32 plain| {mine:.3g} above "
              f"{BWD_BF16_FACTOR} x the bf16 plain's {own:.3g} and the f32 noise {noise:.3g}")
        ratio = max(ratio, mine / max(own, noise))
    return err, ratio


def backward_kernel_checks(torch, np, dev):
    """Phase 13 (a): both backward kernels against their plain versions at
    the paths' shapes and at small odd ones, in bf16 and f32; the flash
    forward's lse against the plain one's."""
    from repro_torch.kernels.flash_attn import flash_attention_bwd_ref, flash_attention_lse_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import gla_chunked_bwd_ref, gla_chunked_fwd_ref
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    rows = []

    def normal(rng, shape, dtype, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        for b, hq, hkv, s, d, causal, window in FLASH_BWD_POINTS:
            rng = np.random.default_rng(s + d + hq)
            q, k, v, do = (normal(rng, (b, h, s, d), dtype) for h in (hq, hkv, hkv, hq))
            scale = 1.0 / d ** 0.5
            o, lse = flash_ops._forward(q, k, v, causal, window, scale, True)
            o_plain, _ = flash_ops._forward(q, k, v, causal, window, scale, False)
            check(torch.equal(o, o_plain), "flash forward: asking for lse changed o")
            _, want_lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
            lse_err = float((lse - want_lse).abs().max())
            check(lse_err <= 1e-5 * max(1.0, float(want_lse.abs().max())),
                  f"flash lse off by {lse_err:.3g}")
            got = flash_ops._backward(q, k, v, o, lse, do, causal, window, scale)
            again = flash_ops._backward(q, k, v, o, lse, do, causal, window, scale)
            plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
            plain32 = (plain if dtype == torch.float32 else flash_attention_bwd_ref(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal=causal,
                window=window))
            what = f"flash_attention_bwd {(b, hq, hkv, s, d)} {str(dtype)[6:]} causal={causal} window={window}"
            err, measure = check_backward(torch, what, got, again, plain, plain32, dtype)
            rows.append({"name": "flash_attention_bwd", "shape": [b, hq, s, d], "kv_heads": hkv,
                         "dtype": str(dtype), "causal": causal, "window": window,
                         "max_abs_err": err, "lse_max_abs_err": lse_err,
                         ("rel_to_scale" if dtype == torch.float32 else "bf16_ratio"): measure})
            print(f"[train] (a) {what}: max |kernel - plain| {err:.3g} "
                  f"({'share of scale' if dtype == torch.float32 else 'ratio to the bf16 plain'} "
                  f"{measure:.3g}); lse {lse_err:.3g}; bitwise stable")
            del q, k, v, do, o, lse, got, again, plain, plain32
        for b, h, t, dk, with_ds in GLA_BWD_POINTS:
            rng = np.random.default_rng(t + dk)
            q, k = normal(rng, (b, h, t, dk), dtype, 0.5), normal(rng, (b, h, t, dk), dtype, 0.5)
            v, do = normal(rng, (b, h, t, 64), dtype), normal(rng, (b, h, t, 64), dtype)
            g = torch.from_numpy(-rng.uniform(0.0, 0.3, (b, h, t, dk)).astype(np.float32))
            g[..., :3, :] = -9.0
            g[..., 3, :] = -8.0
            g[..., 4, :] = 0.0
            g = g.to(dev).to(dtype)
            ds = (torch.from_numpy(rng.standard_normal((b, h, dk, 64)).astype(np.float32)).to(dev)
                  if with_ds else None)
            o, st, states = gla_ops._forward(q, k, v, g)
            got = gla_ops._backward(q, k, v, g, states, st, do, ds)
            again = gla_ops._backward(q, k, v, g, states, st, do, ds)
            plain = gla_chunked_bwd_ref(q, k, v, g, gla_chunked_fwd_ref(q, k, v, g)[2], do, ds)
            wide = [x.float() for x in (q, k, v, g)]
            plain32 = (plain if dtype == torch.float32 else gla_chunked_bwd_ref(
                *wide, gla_chunked_fwd_ref(*wide)[2], do.float(), ds))
            what = f"gla_chunked_bwd {(b, h, t, dk, 64)} {str(dtype)[6:]} dstate={with_ds}"
            err, measure = check_backward(torch, what, got, again, plain, plain32, dtype)
            rows.append({"name": "gla_chunked_bwd", "shape": [b, h, t, dk, 64],
                         "dtype": str(dtype), "dstate": with_ds, "max_abs_err": err,
                         ("rel_to_scale" if dtype == torch.float32 else "bf16_ratio"): measure})
            print(f"[train] (a) {what}: max |kernel - plain| {err:.3g} "
                  f"({'share of scale' if dtype == torch.float32 else 'ratio to the bf16 plain'} "
                  f"{measure:.3g}); bitwise stable")
            del q, k, v, g, do, o, st, states, got, again, plain, plain32
        torch.cuda.empty_cache()
    return rows


def time_backward_kernel(torch, np, name, args, smi, launch_floor):
    """A recorded backward input of the main path: the kernel (L2 flushed,
    CUDA events) beside its plain version, the library call (flash: SDPA's
    backward), its bound and the launch floor of its grids."""
    from repro_torch.kernels.flash_attn import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import gla_chunked_bwd_ref
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    q = args[0]
    if name == "flash_attention_bwd":
        q, k, v, o, lse, do, causal, window, scale = args
        b, hq, sq, d = q.shape
        kernel = lambda: flash_ops._backward(*args)
        plain = lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                                window=window, scale=scale)
        flops, nbytes = flash_bwd_work(np, q, k, causal, window)
        library_ms = time_cold(torch, sdpa_backward(torch, q, k, v, do, causal, window), iters=10)
        grids = flash_ops.backward_grids(q, k)
        where = f"{tuple(q.shape)} x {tuple(k.shape)} causal={causal} window={window}"
    else:
        q, k, v, g, states, state, do, dstate = args
        b, h, t, dk = q.shape
        kernel = lambda: gla_ops._backward(*args)
        plain = lambda: gla_chunked_bwd_ref(q, k, v, g, states, do, dstate)
        flops, nbytes = gla_bwd_work(q, v)
        library_ms = None
        grids = model_grids(name, q, v)
        where = f"{tuple(q.shape)} x {tuple(v.shape)}"
    got, want = kernel(), plain()
    err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
    ms = time_cold(torch, kernel, iters=10)
    plain_ms = time_cold(torch, plain, iters=5)
    floor_ms = sum(time_cold(torch, lambda g=g: launch_floor(*g), iters=10) for g in grids)
    bound_ms, by = least_ms(flops, nbytes, q.dtype)
    lib = "" if library_ms is None else f", SDPA backward {library_ms * 1e3:.2f} us"
    print(f"[train] {name} {where} {str(q.dtype)[6:]}: {ms * 1e3:.2f} us (plain "
          f"{plain_ms * 1e3:.2f} us{lib}; bound {bound_ms * 1e3:.3f} us by {by}: "
          f"{flops / 1e9:.3f} GFLOP / {PEAK_FLOPS[str(q.dtype)] / 1e12:.0f} TFLOP/s vs "
          f"{nbytes:,} B / 3.35 TB/s; {bound_ms / ms:.1%} of bound; launch floor of its "
          f"{len(grids)} grids {floor_ms * 1e3:.2f} us); max |kernel - plain| {err:.3g}  [{smi}]")
    return {"shape": list(q.shape), "dtype": str(q.dtype), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by, "flops": flops,
            "bytes": nbytes, "floor_ms": floor_ms, "max_abs_err": err}


class BackwardRecorder:
    """Stands in for the two wrappers' backward launchers (``ops._backward``,
    looked up at call time) and keeps the first call per (q shape, k shape)
    while active: the training path's own backward inputs, replayed by
    ``time_backward_kernel``."""

    def __init__(self, targets):
        self.active = False
        self.calls = {}
        for name, module in targets.items():
            self.calls[name] = {}
            setattr(module, "_backward", self._wrap(name, module._backward))

    def _wrap(self, name, fn):
        def recorded(*args):
            if self.active:
                self.calls[name].setdefault(
                    qk_shapes(args),
                    tuple(a.detach() if hasattr(a, "detach") else a for a in args))
            return fn(*args)
        return recorded


def train_flops(np, cfg, n_params, batch, seq):
    """Model FLOPs of one step: 6 N per token, plus attention's own (4 d per
    kept pair forward, twice that backward, per q head and layer); the
    remat forward not counted."""
    tokens = batch * seq
    pairs = attention_pairs(np, seq, seq, True, cfg.sliding_window) if cfg.has_attention else 0
    attn = 12 * cfg.head_dim * pairs * batch * cfg.num_heads * cfg.num_layers
    return 6 * n_params * tokens + attn


class TimedSteps:
    """Stands in for ``make_train_step``: each step of the function it
    builds is timed host clock to a ``cuda.synchronize``, and step
    ``TRAIN_PROFILED_STEP`` also runs under torch.profiler (its device busy
    time and top kernels)."""

    def __init__(self, torch, make):
        self.torch, self.make = torch, make
        self.walls, self.profile = [], None   # the profiled step's wall is None

    def __call__(self, model, opt_cfg, **kw):
        fn = self.make(model, opt_cfg, **kw)
        self.model = model

        def step(state, batch):
            out = []
            if len(self.walls) == TRAIN_PROFILED_STEP:
                self.profile = device_profile(self.torch, lambda: out.append(fn(state, batch)),
                                              top=8)
                self.walls.append(None)
            else:
                t0 = time.perf_counter()
                out.append(fn(state, batch))
                self.torch.cuda.synchronize()
                self.walls.append(time.perf_counter() - t0)
            return out[0]
        return step


def step_summary(np, walls, flops, tokens, profile, what, smi):
    """Median, p10 and p90 step ms over the steps after the first (which
    builds the kernels and cuBLAS's state) but the profiled one; tokens/s,
    MFU against the bf16 peak, and the profiled step's idle share."""
    ms = np.asarray([w for w in walls[1:] if w is not None]) * 1e3
    med, p10, p90 = (float(np.percentile(ms, p)) for p in (50, 10, 90))
    mfu = flops / (med / 1e3) / PEAK_FLOPS["torch.bfloat16"]
    busy, wall, top = profile if profile else (None, None, [])
    idle = "not measured" if busy is None else f"{1 - busy / wall:.1%}"
    print(f"[train] {what}: step median {med:.2f} ms (p10 {p10:.2f}, p90 {p90:.2f}; "
          f"first {walls[0] * 1e3:.2f}); {tokens / (med / 1e3):,.0f} tokens/s; MFU "
          f"{mfu:.2%} of 989 TFLOP/s ({flops / 1e12:.2f} TFLOP a step); step "
          f"{TRAIN_PROFILED_STEP} under torch.profiler: device kernels "
          f"{busy if busy is None else round(busy, 2)} ms of {wall:.2f} ms wall, idle {idle}  [{smi}]")
    for kname, kms, count in top:
        print(f"[train]   device {kms:9.3f} ms x{count:<5d} {kname[:100]}")
    return {"step_ms": med, "step_ms_p10": p10, "step_ms_p90": p90,
            "first_step_ms": walls[0] * 1e3, "tokens_per_s": tokens / (med / 1e3),
            "mfu": mfu, "model_tflop_per_step": flops / 1e12, "device_busy_ms": busy,
            "profiled_wall_ms": wall, "device_top": top}


def run_train(torch, np, smi, launch_floor):
    """Phase 13: training on the card — the backward kernels against their
    plain versions, internlm2-1.8b and hymba-1.5b at full width, one step's
    gradients against the plain versions, and the bitwise resume."""
    import contextlib
    import io
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import gla_chunked
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.launch import train as launch
    from repro_torch.models import Model, layers
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import cross_entropy, init_train_state, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    summary = {}

    # -- (a) the backward kernels against their plain versions --------------
    summary["sass"] = backward_sass_checks()
    summary["checks"] = backward_kernel_checks(torch, np, dev)

    # -- (b) internlm2-1.8b at full width through the launcher ---------------
    recorder = BackwardRecorder({"flash_attention_bwd": flash_ops, "gla_chunked_bwd": gla_ops})
    timed = TimedSteps(torch, make_train_step)
    saved_make = launch.make_train_step
    launch.make_train_step = timed
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--aqp-mixture", "--approx-eval"]
    wrappers = (flash_attention, segment_sum)
    zero_counters(wrappers)
    flash_attention.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    recorder.active = True
    clocks = [gpu_clocks()]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            losses = launch.main(argv)
    finally:
        launch.make_train_step = saved_make
        recorder.active = False
    wall = time.perf_counter() - t0
    clocks.append(gpu_clocks())
    print(f"[train] (b) SM clock, max clock, power draw, temperature before / after: "
          f"{clocks[0]} / {clocks[1]}")
    launches = {**read_counters(wrappers), "flash_attention_bwd": flash_attention.bwd_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[train] (b) {line}")
    cfg = get_config(TRAIN_ARCH)
    model = timed.model
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 1_889_110_016, f"{TRAIN_ARCH}: {n_params:,} parameters")
    check(np.all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{TRAIN_ARCH}: losses {losses} not finite and falling")
    check(launches["flash_attention_bwd"] == TRAIN_STEPS * cfg.num_layers,
          f"flash backward launched {launches['flash_attention_bwd']} times, not "
          f"{cfg.num_layers} a step")
    # remat runs each layer's forward twice a step; the eval's forwards once
    evaluated = int(text.split("(evaluated ")[1].split("/")[0]) if "(evaluated " in text else -1
    check(launches["flash_attention"] == cfg.num_layers * (2 * TRAIN_STEPS + evaluated),
          f"flash forward launched {launches['flash_attention']} times for {TRAIN_STEPS} "
          f"remat steps and {evaluated} eval forwards of {cfg.num_layers} layers")
    check(launches["segment_sum"] > 0, "--aqp-mixture never launched segment_sum")
    check("[aqp-mixture] weights=" in text and "fallback=None" in text,
          "the mixture weights did not print from a sampled plan")
    check("[approx-eval] loss≈" in text, "the approximate eval did not print")
    intern = step_summary(np, timed.walls, train_flops(np, cfg, n_params, TRAIN_BATCH, TRAIN_SEQ),
                          TRAIN_BATCH * TRAIN_SEQ, timed.profile,
                          f"(b) {TRAIN_ARCH} full width, batch {TRAIN_BATCH} x {TRAIN_SEQ}", smi)
    print(f"[train] (b) {TRAIN_ARCH}: {n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB "
          f"bf16; gradients {n_params * 2 / 1e9:.2f} GB; AdamW moments "
          f"{n_params * 8 / 1e9:.2f} GB); losses {[round(l, 4) for l in losses]}; launches "
          f"{launches} (24 backward a step); peak device memory {peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated); main() {wall:.1f} s  [{smi}]")
    summary["internlm2"] = {**intern, "losses": losses, "launches": launches, "clocks": clocks,
                            "eval_forwards": evaluated, "peak_memory_gb": peak_gb,
                            "parameters": n_params, "main_s": wall}
    del model, timed
    torch.cuda.empty_cache()

    # -- (c) one step's gradients at full width, kernels against plain ---------
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}

    def grads_of(model, plain):
        saved = layers.flash_attention
        if plain:
            layers.flash_attention = (
                lambda *a, q_offset=0, **kw: flash_attention_ref(*a, **kw))
        try:
            logits, aux = model(batch)
            loss = cross_entropy(logits, batch["labels"], cfg.vocab_size) + 0.01 * aux
            del logits
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, list(model.parameters()))
            return float(loss.detach()), dict(zip(names, grads))
        finally:
            layers.flash_attention = saved

    kernel_model = Model(dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS)).init(
        torch.Generator(device="cuda").manual_seed(11)).requires_grad_(True)
    bwd_before = flash_attention.bwd_launches
    loss_k, g_kernel = grads_of(kernel_model, plain=False)
    check(flash_attention.bwd_launches - bwd_before == TRAIN_CUT_LAYERS,
          "the 2-layer step did not launch the flash backward once a layer")
    loss_p, g_plain = grads_of(kernel_model, plain=True)
    f32_model = Model(dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS, dtype="float32"))
    f32_model.load_state_dict(kernel_model.state_dict())   # the same weights, widened
    del kernel_model
    loss_32, g_32 = grads_of(f32_model.requires_grad_(True), plain=True)
    del f32_model
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    grad_rows = {}
    for n in g_kernel:
        mine, own = rel(g_kernel[n], g_plain[n]), rel(g_plain[n], g_32[n])
        grad_rows[n] = {"kernel_vs_plain": mine, "plain_bf16_vs_f32": own}
        check(mine <= 3 * own, f"{n}: kernels vs plain {mine:.3g} above 3x the bf16 "
                               f"plain's distance from f32 {own:.3g}")
    worst = max(grad_rows.items(), key=lambda kv: kv[1]["kernel_vs_plain"] / kv[1]["plain_bf16_vs_f32"])
    print(f"[train] (c) {TRAIN_ARCH} full width, {TRAIN_CUT_LAYERS} layers, one step's "
          f"gradients (bf16): loss kernels {loss_k:.6f}, plain {loss_p:.6f}, f32 plain "
          f"{loss_32:.6f}; per-leaf ||kernels - plain|| / ||plain|| against the bf16 plain's "
          f"own distance from f32 (limit 3x): "
          + ", ".join(f"{n} {r['kernel_vs_plain']:.3g}/{r['plain_bf16_vs_f32']:.3g}"
                      for n, r in grad_rows.items())
          + f"; worst ratio {worst[0]} {worst[1]['kernel_vs_plain'] / worst[1]['plain_bf16_vs_f32']:.2f}")
    summary["gradients"] = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_f32": loss_32,
                            "leaves": grad_rows}
    del g_kernel, g_plain, g_32
    torch.cuda.empty_cache()

    # -- (d) hymba-1.5b at full width through make_train_step ----------------
    hcfg = get_config("hymba-1.5b")
    hmodel = Model(hcfg)
    state = init_train_state(hmodel, torch.Generator(device="cuda").manual_seed(0))
    htimed = TimedSteps(torch, make_train_step)
    fn = htimed(hmodel, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                    total_steps=TRAIN_HYMBA_STEPS, weight_decay=0.0))
    hpipe = TokenPipeline(hcfg.vocab_size, TRAIN_BATCH, TRAIN_HYMBA_SEQ, seed=0)
    zero_counters((flash_attention, gla_chunked))
    flash_attention.bwd_launches = gla_chunked.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    hlosses = []
    recorder.active = True
    # one batch, stepped on 5 times (the reference's loss-decrease test
    # memorizes a fixed batch): over 5 fresh random batches at lr 3e-4 the
    # batch-to-batch spread of the loss (~5e-3) hides the fall
    b = {k: torch.from_numpy(v).to(dev) for k, v in hpipe.next_batch().items()}
    for _ in range(TRAIN_HYMBA_STEPS):
        state, m = fn(state, b)
        hlosses.append(float(m["loss"]))
    recorder.active = False
    print(f"[train] (d) SM clock, max clock, power draw, temperature after: {gpu_clocks()}")
    hlaunch = {"flash_attention": flash_attention.launches,
               "flash_attention_bwd": flash_attention.bwd_launches,
               "gla_chunked": gla_chunked.launches, "gla_chunked_bwd": gla_chunked.bwd_launches}
    hpeak = torch.cuda.max_memory_allocated() / 1e9
    hn = sum(p.numel() for p in hmodel.parameters())
    check(np.all(np.isfinite(hlosses)) and hlosses[-1] < hlosses[0],
          f"hymba-1.5b: losses {hlosses} not finite and falling")
    for k in ("flash_attention_bwd", "gla_chunked_bwd"):
        check(hlaunch[k] == TRAIN_HYMBA_STEPS * hcfg.num_layers,
              f"hymba-1.5b: {k} launched {hlaunch[k]} times")
    for k in ("flash_attention", "gla_chunked"):
        check(hlaunch[k] == 2 * TRAIN_HYMBA_STEPS * hcfg.num_layers,
              f"hymba-1.5b: {k} launched {hlaunch[k]} times (remat: twice a layer a step)")
    hymba = step_summary(np, htimed.walls,
                         train_flops(np, hcfg, hn, TRAIN_BATCH, TRAIN_HYMBA_SEQ),
                         TRAIN_BATCH * TRAIN_HYMBA_SEQ, htimed.profile,
                         f"(d) hymba-1.5b full width, batch {TRAIN_BATCH} x {TRAIN_HYMBA_SEQ}",
                         smi)
    print(f"[train] (d) hymba-1.5b: {hn:,} parameters; losses {[round(l, 4) for l in hlosses]}; "
          f"launches {hlaunch}; peak device memory {hpeak:.2f} GB  [{smi}]")
    summary["hymba"] = {**hymba, "losses": hlosses, "launches": hlaunch,
                        "peak_memory_gb": hpeak, "parameters": hn}
    del hmodel, state, htimed, fn
    torch.cuda.empty_cache()

    # -- (e) resume bitwise; microbatches; compression -----------------------
    ck_dir = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_RESUME_STEPS,
                          weight_decay=0.0)

    def fresh(**kw):
        model = Model(dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS))
        return model, init_train_state(model, torch.Generator(device="cuda").manual_seed(21),
                                       **kw)

    def run(steps, model, state, pipe, **kw):
        fn = make_train_step(model, opt_cfg, **kw)
        out = []
        for _ in steps:
            b = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
            state, m = fn(state, b)
            out.append(float(m["loss"]))
        return state, out

    t_res = time.perf_counter()
    model, state = fresh()
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=3)
    state, first = run(range(TRAIN_RESUME_AT), model, state, pipe)
    ckpt.save(ck_dir, TRAIN_RESUME_AT, state,
              extra={"step": TRAIN_RESUME_AT, "data_step": pipe.state.step})
    state, rest = run(range(TRAIN_RESUME_AT, TRAIN_RESUME_STEPS), model, state, pipe)
    straight = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, state
    model, state = fresh()
    state, extra = ckpt.restore(ck_dir, TRAIN_RESUME_AT, state)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=3)
    pipe.state.step = extra["data_step"]
    state, resumed = run(range(TRAIN_RESUME_AT, TRAIN_RESUME_STEPS), model, state, pipe)
    ck_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ck_dir) for f in fs)
    check(resumed == rest, f"resumed losses {resumed} differ from {rest}")
    check(all(torch.equal(p, straight[n]) for n, p in model.named_parameters()),
          "resumed parameters differ bitwise from the uninterrupted run")
    shutil.rmtree(ck_dir, ignore_errors=True)
    del model, state, straight
    print(f"[train] (e) {TRAIN_ARCH} full width, {TRAIN_CUT_LAYERS} layers: {TRAIN_RESUME_STEPS} "
          f"steps {first + rest}; checkpoint at step {TRAIN_RESUME_AT} ({ck_bytes / 1e9:.2f} GB "
          f"on disk), restored into a fresh state: steps {TRAIN_RESUME_AT + 1}-"
          f"{TRAIN_RESUME_STEPS} {resumed}, losses and parameters bitwise the uninterrupted "
          f"run's; {time.perf_counter() - t_res:.1f} s")

    # --microbatches 2 against one batch, one step from one state
    steps1 = []
    for mb in (1, 2):
        model, state = fresh()
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=5)
        _, loss = run(range(1), model, state, pipe, microbatches=mb)
        steps1.append(loss[0])
        del model, state
    check(abs(steps1[1] - steps1[0]) <= 2 ** -7 * abs(steps1[0]),
          f"microbatches 2 vs 1: losses {steps1}")
    # --compress-grads: the loss still falls
    model, state = fresh(compress=True)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=5)
    _, closses = run(range(3), model, state, pipe, compress=True)
    check(np.all(np.isfinite(closses)) and closses[-1] < closses[0],
          f"--compress-grads: losses {closses} not falling")
    del model, state
    torch.cuda.empty_cache()
    print(f"[train] (e) microbatches 1 / 2, one step: loss {steps1[0]:.6f} / {steps1[1]:.6f} "
          f"(within 2^-7); with compression, 3 steps: {[round(l, 4) for l in closses]}")
    summary["resume"] = {"losses": first + rest, "resumed": resumed,
                         "checkpoint_gb": ck_bytes / 1e9, "microbatch_losses": steps1,
                         "compressed_losses": closses}

    # -- the backward kernels at the training paths' own inputs -----------------
    summary["kernels"] = {}
    for name, calls in recorder.calls.items():
        check(bool(calls), f"{name}: no call of the training paths was recorded")
        summary["kernels"][name] = [time_backward_kernel(torch, np, name, args, smi, launch_floor)
                                    for args in calls.values()]
    recorder.calls.clear()
    # and GLA's backward at the rwkv6 point (64 heads, dk = dv = 64, bf16),
    # which no phase trains at full width
    rng = np.random.default_rng(17)
    q, k = (torch.from_numpy((rng.standard_normal((1, 64, TRAIN_HYMBA_SEQ, 64)) * 0.5)
                             .astype(np.float32)).to(dev).to(torch.bfloat16) for _ in range(2))
    v, do = (torch.from_numpy(rng.standard_normal((1, 64, TRAIN_HYMBA_SEQ, 64))
                              .astype(np.float32)).to(dev).to(torch.bfloat16) for _ in range(2))
    g = (-torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((1, 64, TRAIN_HYMBA_SEQ, 64)).astype(np.float32)).to(dev) - 1.0)
         ).to(torch.bfloat16)
    _, st, states = gla_ops._forward(q, k, v, g)
    summary["kernels"]["gla_chunked_bwd"].append(time_backward_kernel(
        torch, np, "gla_chunked_bwd", (q, k, v, g, states, st, do, None), smi, launch_floor))
    del q, k, v, g, do, st, states
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[train] phase 13 in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


# ---------------------------------------------------------------------------
# phases 14-16 helpers: every family at full width, the reduced configs on
# the card, two-level remat at full depth
# ---------------------------------------------------------------------------

# (14) each family the earlier phases do not run, at full width in bf16 with
# depth cut to 2 decoder layers (and 2 encoder layers): text tokens of the
# train and teacher-forcing batches (a VLM's follow its 576 patches, an
# encoder-decoder's attend to its 1,500 frames)
FAMILY_TEXT = {"whisper-large-v3": 448, "llava-next-34b": 512, "gemma-7b": 2048}
FAMILY_LAYERS, FAMILY_STEPS, FAMILY_BATCH, FAMILY_DECODE, FAMILY_SEED = 2, 3, 2, 32, 4
# (15) the text configs whose launchers the reference runs, reduced (head_dim
# 16, GLA (8, 16), f32): launch.serve and launch.train at their defaults
REDUCED_ARCHS = ("gemma-7b", "granite-20b", "granite-moe-1b-a400m", "hymba-1.5b",
                 "internlm2-1.8b", "mistral-large-123b", "olmoe-1b-7b", "rwkv6-7b")
REDUCED_STEPS = 3
# (16) two-level remat at full depth: phase 13's internlm2 cell, remat_groups
# 4 (6 layers a group) against per-block remat
REMAT_GROUPS = 4


def family_batch(torch, np, cfg, kind, batch, seq, seed, dev):
    """A batch of ``launch.specs.batch_specs(cfg, ShapeSpec(kind, batch,
    seq))`` on ``dev``: tokens and labels uniform over the vocabulary,
    frames and patch embeddings standard normal, in the specs' dtypes."""
    from repro_torch.launch.specs import ShapeSpec, batch_specs
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in batch_specs(cfg, ShapeSpec(kind, kind, seq, batch)).items():
        a = (rng.integers(0, cfg.vocab_size, shape).astype(np.int32) if dtype == torch.int32
             else rng.standard_normal(shape).astype(np.float32))
        out[name] = torch.from_numpy(a).to(dev)
    return out


def flash_calls(cfg):
    """flash_attention calls of one forward: each decoder layer's
    self-attention, and an encoder-decoder's encoder layers and cross
    attention."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers if cfg.has_attention else 0


def check_recorded(torch, np, fwd_calls, bwd_calls, smi, launch_floor, what):
    """Every recorded forward input of flash / GLA held to its plain
    version and timed (``time_model_kernel``, with its launch floor), and
    every recorded backward input held to the plain backward
    (``check_backward``) and timed (``time_backward_kernel``).  Returns
    {kernel name: rows}."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attn import flash_attention_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import (gla_chunked, gla_chunked_bwd_ref,
                                               gla_chunked_fwd_ref, gla_chunked_ref)
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    fwd = {"flash_attention": (flash_attention, flash_attention_ref),
           "gla_chunked": (gla_chunked, gla_chunked_ref)}
    rows = {}
    for name, calls in fwd_calls.items():
        fn, ref = fwd[name]
        for args, kw in calls.values():
            args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
            rows.setdefault(name, []).append(
                time_model_kernel(torch, np, name, fn, ref, args, kw, smi, launch_floor))
    for name, calls in bwd_calls.items():
        for args in calls.values():
            if name == "flash_attention_bwd":
                q, k, v, o, lse, do, causal, window, scale = args
                got, again = flash_ops._backward(*args), flash_ops._backward(*args)
                plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                                window=window, scale=scale)
                plain32 = (plain if q.dtype == torch.float32 else flash_attention_bwd_ref(
                    q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                    causal=causal, window=window, scale=scale))
            else:
                q, k, v, g, states, state, do, dstate = args
                got, again = gla_ops._backward(*args), gla_ops._backward(*args)
                plain = gla_chunked_bwd_ref(q, k, v, g, states, do, dstate)
                wide = [x.float() for x in (q, k, v, g)]
                plain32 = (plain if q.dtype == torch.float32 else gla_chunked_bwd_ref(
                    *wide, gla_chunked_fwd_ref(*wide)[2], do.float(), dstate))
            label = f"{what} {name} {tuple(q.shape)} x {tuple(args[1].shape)} {str(q.dtype)[6:]}"
            err, measure = check_backward(torch, label, got, again, plain, plain32, q.dtype)
            print(f"[{what}] {label}: max |kernel - plain| {err:.3g} "
                  f"({'share of scale' if q.dtype == torch.float32 else 'ratio to the bf16 plain'}"
                  f" {measure:.3g}); bitwise stable")
            del got, again, plain, plain32
            row = time_backward_kernel(torch, np, name, args, smi, launch_floor)
            rows.setdefault(name, []).append({**row, "check": measure})
    torch.cuda.empty_cache()
    return rows


def run_families(torch, np, smi, launch_floor):
    """Phase 14: whisper-large-v3 (encoder-decoder), llava-next-34b (VLM) and
    gemma-7b (head_dim 256) at full width in bf16, 2 decoder layers (2
    encoder layers), seeded random weights: prefill + decode against the
    teacher-forced forward, 3 make_train_step steps, and the flash kernels,
    forward and backward, at the models' own attention inputs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import Model, layers
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainState, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    summary = {}
    fwd = CallRecorder([(layers, "flash_attention", qk_shapes)])
    bwd = BackwardRecorder({"flash_attention_bwd": flash_ops})
    for arch, text in FAMILY_TEXT.items():
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=FAMILY_LAYERS,
                                  encoder_layers=FAMILY_LAYERS if full.encoder_layers else 0)
        model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(FAMILY_SEED))
        n_params = sum(p.numel() for p in model.parameters())
        seq = text + (cfg.num_patches if cfg.family == "vlm" else 0)
        n_flash = flash_calls(cfg)
        print(f"[families] {arch} at full width, {cfg.num_layers} decoder layers"
              f"{f' and {cfg.encoder_layers} encoder layers over {cfg.enc_seq} frames' if cfg.encoder_layers else ''}"
              f"{f' after {cfg.num_patches} patches' if cfg.num_patches else ''} (d {cfg.d_model}, "
              f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size}), bf16: {n_params:,} parameters")

        # prefill + decode against the teacher-forced forward (batch 1)
        tf_batch = family_batch(torch, np, cfg, "prefill", 1, seq, 1, dev)
        tokens = tf_batch.pop("tokens")
        tf = check_teacher_forcing(
            torch, np, model, tokens, text - FAMILY_DECODE, seq, (flash_attention,), None,
            f"families {arch}", smi, extra=tf_batch,
            plain_f32=cfg.head_dim not in flash_ops.HEAD_DIMS[torch.float32])
        check(tf["prefill_launches"]["flash_attention"] == n_flash,
              f"{arch}: the prefill launched flash {tf['prefill_launches']} times, not {n_flash}")
        del tf_batch, tokens
        torch.cuda.empty_cache()

        # 3 training steps on one batch, the first one's kernel inputs recorded
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = TrainState(params, init_opt_state(params), None)
        fn = make_train_step(model, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                                total_steps=FAMILY_STEPS, weight_decay=0.0))
        batch = family_batch(torch, np, cfg, "train", FAMILY_BATCH, seq, 2, dev)
        zero_counters((flash_attention,))
        flash_attention.bwd_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for i in range(FAMILY_STEPS):
            fwd.active, bwd.active = ({"flash_attention"}, True) if i == 0 else (set(), False)
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fwd.active, bwd.active = set(), False
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {"flash_attention": flash_attention.launches,
                    "flash_attention_bwd": flash_attention.bwd_launches}
        check(np.all(np.isfinite(losses)), f"{arch}: losses {losses}")
        # remat runs each block's forward twice a step
        check(launches == {"flash_attention": 2 * FAMILY_STEPS * n_flash,
                           "flash_attention_bwd": FAMILY_STEPS * n_flash},
              f"{arch}: launches {launches} for {FAMILY_STEPS} steps of {n_flash} attention "
              "calls a forward")
        step_ms = statistics.median(walls[1:]) * 1e3
        tokens_s = FAMILY_BATCH * seq / (step_ms / 1e3)
        print(f"[families] {arch}: {FAMILY_STEPS} make_train_step steps of {FAMILY_BATCH} x "
              f"{seq} positions: losses {[round(l, 4) for l in losses]}; step median "
              f"{step_ms:.2f} ms of {[round(w * 1e3, 2) for w in walls]} (first excluded); "
              f"{tokens_s:,.0f} tokens/s; peak device memory {peak_gb:.2f} GB; launches "
              f"{launches} ({n_flash} attention calls a forward)  [{smi}]")
        del model, state, fn, params, batch
        torch.cuda.empty_cache()
        kernels = check_recorded(torch, np, {"flash_attention": dict(fwd.calls["flash_attention"])},
                                 {"flash_attention_bwd": dict(bwd.calls["flash_attention_bwd"])},
                                 smi, launch_floor, "families")
        check(bool(kernels.get("flash_attention")) and bool(kernels.get("flash_attention_bwd")),
              f"{arch}: no flash input was recorded")
        fwd.calls["flash_attention"].clear()
        bwd.calls["flash_attention_bwd"].clear()
        torch.cuda.empty_cache()
        summary[arch] = {"parameters": n_params, "layers": cfg.num_layers,
                         "encoder_layers": cfg.encoder_layers, "positions": seq,
                         "teacher_forcing": tf, "losses": losses, "step_ms": step_ms,
                         "step_walls_ms": [w * 1e3 for w in walls], "tokens_per_s": tokens_s,
                         "peak_memory_gb": peak_gb, "launches": launches,
                         "kernels": kernels, "seconds": time.perf_counter() - t_arch}
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[families] phase 14 in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


def run_reduced(torch, np, smi, launch_floor):
    """Phase 15: every text config's ``.reduced()`` on the card through its
    launchers, ``launch.serve --reduced`` and ``launch.train --reduced``:
    the reduced widths' kernels (flash f32 d 16, GLA f32 (8, 16)) forward
    and backward; then each kernel at the first recorded input of each
    shape, held to its plain version and timed."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import gla_chunked
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    from repro_torch.launch import serve, train
    from repro_torch.models import layers, linear_attn
    from repro_torch.models.model import _ssm_dv

    t_phase = time.perf_counter()
    summary = {}
    wrappers = (flash_attention, gla_chunked)
    fwd = CallRecorder([(layers, "flash_attention", qk_shapes),
                        (linear_attn, "_gla_kernel", qk_shapes)])
    bwd = BackwardRecorder({"flash_attention_bwd": flash_ops, "gla_chunked_bwd": gla_ops})
    for arch in REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        zero_counters(wrappers)
        flash_attention.bwd_launches = gla_chunked.bwd_launches = 0
        out = io.StringIO()
        fwd.active, bwd.active = {"flash_attention", "gla_chunked"}, True
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            served = serve.main(["--arch", arch, "--reduced"])
            t1 = time.perf_counter()
            losses = train.main(["--arch", arch, "--reduced", "--steps", str(REDUCED_STEPS)])
        t2 = time.perf_counter()
        fwd.active, bwd.active = set(), False
        launches = {**read_counters(wrappers), "flash_attention_bwd": flash_attention.bwd_launches,
                    "gla_chunked_bwd": gla_chunked.bwd_launches}
        n_flash, n_gla = flash_calls(cfg), cfg.num_layers if cfg.has_ssm else 0
        want = {"flash_attention": 2 * REDUCED_STEPS * n_flash,
                "gla_chunked": 2 * REDUCED_STEPS * n_gla,
                "flash_attention_bwd": REDUCED_STEPS * n_flash,
                "gla_chunked_bwd": REDUCED_STEPS * n_gla}
        check(len(served) == 8 and all(len(t) > 0 for t in served.values()),
              f"{arch}: served {len(served)} of 8 requests")
        check(np.all(np.isfinite(losses)) and len(losses) == REDUCED_STEPS,
              f"{arch}: losses {losses}")
        check(launches == want, f"{arch}: launches {launches}, expected {want} (remat: the "
                                f"forward twice a step)")
        lines = out.getvalue().splitlines()
        widths = ", ".join(([f"heads of {cfg.head_dim}"] if cfg.has_attention else [])
                           + ([f"GLA ({cfg.ssm_state}, {_ssm_dv(cfg)})"] if cfg.has_ssm else []))
        print(f"[reduced] {arch} (d {cfg.d_model}, {widths}, f32) on cuda: "
              f"{lines[0] if lines else ''}; serve {t1 - t0:.2f} s; "
              f"train {REDUCED_STEPS} steps {t2 - t1:.2f} s, losses "
              f"{[round(l, 4) for l in losses]}; launches {launches}  [{smi}]")
        summary[arch] = {"serve_s": t1 - t0, "train_s": t2 - t1, "losses": losses,
                         "launches": launches, "served": len(served)}
    summary["kernels"] = check_recorded(
        torch, np, {k: dict(v) for k, v in fwd.calls.items()},
        {k: dict(v) for k, v in bwd.calls.items()}, smi, launch_floor, "reduced")
    for name in ("flash_attention", "gla_chunked", "flash_attention_bwd", "gla_chunked_bwd"):
        check(bool(summary["kernels"].get(name)), f"{name}: no reduced input was recorded")
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[reduced] phase 15 in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


def run_remat_groups(torch, np, smi):
    """Phase 16: internlm2-1.8b at full depth (24 layers), 2 x 4,096 tokens,
    ``remat_groups`` 4 against per-block remat from the same weights and
    batches: the parameters after one step bitwise equal, both losses equal;
    each run's second-step wall and peak device memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=9)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
               for _ in range(2)]
    runs, first = {}, None
    for groups in (0, REMAT_GROUPS):
        model = Model(dataclasses.replace(cfg, remat_groups=groups))
        state = init_train_state(model, torch.Generator(device="cuda").manual_seed(7))
        fn = make_train_step(model, AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=2,
                                                weight_decay=0.0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                # a copy on the host: the next step writes the parameters in place
                after = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
                if first is None:
                    first = after
                else:
                    same = all(torch.equal(after[n], first[n]) for n in first)
                    check(same, f"remat_groups {groups}: the parameters after one step differ "
                                "bitwise from per-block remat's")
                del after
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        runs[groups] = {"losses": losses, "step_ms": walls[1] * 1e3, "first_step_ms": walls[0] * 1e3,
                        "peak_memory_gb": peak_gb}
        print(f"[remat] {TRAIN_ARCH} full depth ({cfg.num_layers} layers), {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens, {'per-block remat' if not groups else f'remat_groups {groups} ({cfg.num_layers // groups} layers a group) over per-block remat'}: "
              f"losses {losses}; second step {walls[1] * 1e3:.2f} ms (first {walls[0] * 1e3:.2f}); "
              f"peak device memory {peak_gb:.2f} GB  [{smi}]")
        del model, state, fn
        torch.cuda.empty_cache()
    check(runs[0]["losses"] == runs[REMAT_GROUPS]["losses"],
          f"remat_groups: losses {runs[REMAT_GROUPS]['losses']} against {runs[0]['losses']}")
    print(f"[remat] the parameters after one step are bitwise equal and both steps' losses "
          f"equal; remat_groups {REMAT_GROUPS} against per-block: step "
          f"{runs[REMAT_GROUPS]['step_ms'] / runs[0]['step_ms']:.3f}x, peak memory "
          f"{runs[REMAT_GROUPS]['peak_memory_gb'] - runs[0]['peak_memory_gb']:+.2f} GB  [{smi}]")
    del first
    return {"runs": {str(k): v for k, v in runs.items()},
            "phase_s": time.perf_counter() - t_phase}


# phase 17: the device mesh.  (a)-(c) internlm2-1.8b at full width cut to 2
# layers on a one-rank NCCL (1, 1) host mesh, TRAIN_BATCH x TRAIN_SEQ tokens
# in the dry run's microbatches; (d) production cells of the dry run on the
# fake (16, 16) mesh, one process each, started with (a) (they trace on the
# host: fake tensors, no kernel); (e) olmoe-1b-7b at full width cut to 2
# layers on the host mesh, its MoE FFN on the expert-parallel route
MESH_LAYERS, MESH_STEPS, MESH_CKPT_AT = 2, 3, 2
MESH_PEAK_TOL = 0.15             # the dry run's peak against the card's
MESH_CELLS = (("internlm2-1.8b", "train_4k"), ("internlm2-1.8b", "decode_32k"),
              ("mistral-large-123b", "train_4k"), ("olmoe-1b-7b", "train_4k"),
              ("granite-moe-1b-a400m", "decode_32k"))
MESH_CELL_TIMEOUT = 900
MESH_MOE_ARCH = "olmoe-1b-7b"


def start_mesh_cells(out_dir):
    """Phase 17 (d)'s dry-run cells, each ``python -m repro_torch.launch.dryrun
    --mesh single --device cuda`` in a process of its own, all started now."""
    cells = []
    for arch, shape in MESH_CELLS:
        out = os.path.join(out_dir, f"{arch}_{shape}.json")
        log = open(out + ".log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single",
             "--arch", arch, "--shape", shape, "--device", "cuda", "--out", out],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
            stdout=log, stderr=subprocess.STDOUT)
        cells.append({"arch": arch, "shape": shape, "out": out, "proc": proc, "log": log,
                      "t0": time.perf_counter()})
    return cells


def finish_mesh_cells(cells, smi):
    """Waits for phase 17 (d)'s cells; each must be ``ok``.  Their roofline
    rows at the H100's peaks, and each cell's wall."""
    from repro_torch.launch import roofline

    merged, walls = {}, {}
    for c in cells:
        try:
            rc = c["proc"].wait(timeout=max(MESH_CELL_TIMEOUT - (time.perf_counter() - c["t0"]), 1))
        except subprocess.TimeoutExpired:
            c["proc"].kill()
            c["proc"].wait()
            rc = "timeout"
        c["log"].close()
        key = f"{c['arch']}|{c['shape']}"
        walls[key] = time.perf_counter() - c["t0"]
        with open(c["out"] + ".log") as f:
            tail = f.read()[-1500:]
        check(rc == 0 and os.path.exists(c["out"]), f"dry run {key}: exit {rc}; {tail}")
        with open(c["out"]) as f:
            row = json.load(f)[key]
        check(row["status"] == "ok", f"dry run {key}: {row.get('status')} {row.get('error')}")
        merged[key] = row
    path = os.path.join(os.path.dirname(cells[0]["out"]), "dryrun_single.json")
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    table = roofline.analyze(path, chips=256)
    lines = roofline.to_markdown(table).splitlines()
    for line in lines[:2]:
        print(f"[mesh] (d) {line}")
    for key, line in zip(table, lines[2:]):
        m, prof = merged[key]["memory"], merged[key]["hlo_profile"]
        by_kind = ", ".join(f"{k} {v / 2**30:.3f} GiB ({prof['collective_counts'].get(k, 0)})"
                            for k, v in sorted(prof.get("collective_bytes_by_kind", {}).items()))
        print(f"[mesh] (d) {line} dry run wall {walls[key]:.1f} s (trace {merged[key]['trace_s']:.1f} s, "
              f"{len(merged[key]['traced'])} traces); per device: args "
              f"{m['argument_bytes'] / 2**30:.3f} GiB, peak {m['peak_bytes'] / 2**30:.2f} GiB, "
              f"FLOPs {prof['flops_per_device']:.4e}, HBM bytes {prof['hbm_bytes_per_device']:.4e}, "
              f"collective {prof['collective_bytes_per_device'] / 2**30:.3f} GiB [{by_kind}], "
              f"MODEL/traced {table[key]['useful_ratio']:.4f}  [{smi}]")
    return {"cells": merged, "roofline": table, "wall_s": walls}


def host_mesh_runs(torch, cfg, shape, batches, opt, mesh, seed, after_step=None):
    """The same MESH_STEPS training steps of ``cfg`` twice, from the same
    weights (``seed``) and batches: unsharded, then with the state sharded
    on ``mesh`` by ``params_shardings`` with the dry run's hints.  For
    each: losses, step walls, peak memory over the state's start, flash
    launches forward and backward, MoE calls by route (the counts set to
    0 before each run and read after it), and the full parameters on the
    host.  ``after_step(i, state)`` runs after each sharded step."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, moe
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import TrainState, init_train_state, make_train_step

    mbs = dryrun.microbatches(shape, mesh)
    runs = {}
    for sharded in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = Model(cfg)
        state = init_train_state(model, torch.Generator(device="cuda").manual_seed(seed))
        if sharded:
            sharding.shard_model(model, mesh)
            model.shard_hints = dryrun.shard_hints(cfg, shape, mesh, "baseline")
            params = dict(model.named_parameters())
            state = TrainState(params, init_opt_state(params), None)
        fn = make_train_step(model, opt, microbatches=mbs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention.bwd_launches = 0
        moe.routes.clear()
        losses, walls = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            state, m = fn(state, b)
            losses.append(float(full_tensor(m["loss"])))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if sharded and after_step is not None:
                after_step(i, state)
        peak = torch.cuda.max_memory_allocated() - base
        launches = flash_attention.launches, flash_attention.bwd_launches
        routes = {k: moe.routes[k] for k in ("local", "expert_parallel")}
        params = {n: full_tensor(p).detach().to("cpu", copy=True)
                  for n, p in model.named_parameters()}
        runs[sharded] = {"losses": losses, "walls": walls, "peak": peak, "launches": launches,
                         "moe_routes": routes, "params": params, "microbatches": mbs}
        del model, state, fn
    return runs


def full_tensor(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def report_host_mesh_runs(torch, runs, cfg, what, smi):
    """Prints both runs of ``host_mesh_runs``; fails unless losses and
    parameters are bitwise equal and flash launched alike (and at all)."""
    for sharded, r in runs.items():
        where = "sharded, (1, 1) host mesh" if sharded else "unsharded"
        print(f"[mesh] {what} {cfg.name} full width, {cfg.num_layers} layers, {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens, {r['microbatches']} microbatches, {where}: losses "
              f"{r['losses']}; step {statistics.median(r['walls']) * 1e3:.2f} ms median of "
              f"{len(r['walls'])} ({', '.join(f'{w * 1e3:.2f}' for w in r['walls'])}); peak "
              f"device memory {r['peak'] / 1e9:.3f} GB over the state's start; flash launches "
              f"{r['launches'][0]} forward, {r['launches'][1]} backward; MoE calls by route "
              f"{r['moe_routes']}  [{smi}]")
    a, b = runs[False], runs[True]
    check(b["losses"] == a["losses"], f"{what} sharded losses {b['losses']} != {a['losses']}")
    same = [n for n in a["params"] if torch.equal(a["params"][n], b["params"][n])]
    check(len(same) == len(a["params"]),
          f"{what} sharded parameters differ bitwise: {sorted(set(a['params']) - set(same))}")
    check(b["launches"] == a["launches"] and min(a["launches"]) > 0,
          f"{what} flash launches sharded {b['launches']} against unsharded {a['launches']}")
    print(f"[mesh] {what} losses and parameters bitwise equal; flash launches equal; "
          f"sharded / unsharded step {statistics.median(b['walls']) / statistics.median(a['walls']):.3f}x, "
          f"peak {b['peak'] / 1e9:.3f} / {a['peak'] / 1e9:.3f} GB  [{smi}]")



def run_mesh(torch, np, smi):
    """Phase 17: the device mesh.  (a) one-rank NCCL (1, 1) host mesh:
    internlm2-1.8b at full width, 2 layers, 3 steps with the state sharded
    by ``params_shardings`` and the dry run's hints, against 3 unsharded
    steps from the same weights and batches: losses and parameters bitwise,
    flash forward and backward launches equal and > 0; each run's median
    step and peak memory.  (b) the sharded state checkpointed at step 2 and
    restored (with ``shardings``) into a fresh sharded state and into an
    unsharded one: step 3 bitwise the uninterrupted run's.  (c) the dry
    run's host-mesh cell of (a)'s configuration: its FLOPs equal to
    ``TraceAnalysis`` over the card's restored step 3, its peak within
    MESH_PEAK_TOL of (a)'s.  (d) the production cells (started first).
    (e) as (a) for olmoe-1b-7b (64 experts top-8, bf16) cut to 2 layers:
    bitwise, and every MoE call of the sharded run on the expert-parallel
    route (``moe.routes``), every one of the unsharded run on the local
    one."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.launch.trace_analysis import TraceAnalysis
    from repro_torch.models import Model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import sharding
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import (TrainState, init_train_state, make_train_step,
                                        state_shardings)

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "mesh_phase")
    ck_dir = os.path.join(ROOT, "build", "mesh_ckpt")
    for d in (out_dir, ck_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(out_dir)
    cells = start_mesh_cells(out_dir)
    try:
        dev = torch.device("cuda")
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=MESH_LAYERS)
        shape = ShapeSpec("host", "train", TRAIN_SEQ, TRAIN_BATCH)
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=17)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
                   for _ in range(MESH_STEPS)]
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=MESH_STEPS, weight_decay=0.0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        mesh = make_host_mesh()
        mbs = dryrun.microbatches(shape, mesh)

        def fresh(sharded):
            model = Model(cfg)
            state = init_train_state(model, torch.Generator(device="cuda").manual_seed(7))
            if sharded:
                sharding.shard_model(model, mesh)
                model.shard_hints = dryrun.shard_hints(cfg, shape, mesh, "baseline")
                params = dict(model.named_parameters())
                state = TrainState(params, init_opt_state(params), None)
            return model, state

        full = full_tensor

        def step(fn, state, b):
            state, m = fn(state, b)
            loss = float(full(m["loss"]))
            torch.cuda.synchronize()
            return state, loss

        # -- (a) sharded against unsharded, same weights and batches ----------
        def checkpoint_at(i, state):
            if i + 1 == MESH_CKPT_AT:
                ckpt.save(ck_dir, MESH_CKPT_AT, state, extra={"step": MESH_CKPT_AT})

        runs = host_mesh_runs(torch, cfg, shape, batches, opt, mesh, 7, checkpoint_at)
        report_host_mesh_runs(torch, runs, cfg, "(a)", smi)
        b_ = runs[True]

        # -- (b) the elastic restore, onto the mesh and onto no mesh ----------
        restored = {}
        for sharded in (True, False):
            torch.cuda.empty_cache()
            model, state = fresh(sharded)
            shardings = state_shardings(model, mesh) if sharded else None
            state, extra = ckpt.restore(ck_dir, MESH_CKPT_AT, state, shardings=shardings)
            check(extra == {"step": MESH_CKPT_AT}, f"restore extra {extra}")
            fn = make_train_step(model, opt, microbatches=mbs)
            if sharded:
                with TraceAnalysis(mesh.size()) as trace:
                    state, loss = step(fn, state, batches[MESH_CKPT_AT])
            else:
                state, loss = step(fn, state, batches[MESH_CKPT_AT])
            same = all(torch.equal(full(p).detach().cpu(), b_["params"][n])
                       for n, p in model.named_parameters())
            check(loss == b_["losses"][MESH_CKPT_AT] and same,
                  f"restored {'sharded' if sharded else 'unsharded'} step {MESH_CKPT_AT + 1}: "
                  f"loss {loss} against {b_['losses'][MESH_CKPT_AT]}, parameters bitwise {same}")
            restored["sharded" if sharded else "unsharded"] = loss
            del model, state, fn
        ck_gb = sum(os.path.getsize(os.path.join(dp, f))
                    for dp, _, fs in os.walk(ck_dir) for f in fs) / 1e9
        shutil.rmtree(ck_dir, ignore_errors=True)
        real_flops = trace.result()["flops_per_device"]
        print(f"[mesh] (b) the sharded state's checkpoint at step {MESH_CKPT_AT} ({ck_gb:.2f} GB "
              f"on disk, the single-process layout) restored into a fresh sharded state (with "
              f"shardings) and into an unsharded one: step {MESH_CKPT_AT + 1} bitwise the "
              f"uninterrupted run's (loss {restored['sharded']})  [{smi}]")

        # -- (e) olmoe on the host mesh: the MoE FFN expert-parallel ----------
        moe_cfg = dataclasses.replace(get_config(MESH_MOE_ARCH), num_layers=MESH_LAYERS)
        moe_pipe = TokenPipeline(moe_cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=29)
        moe_batches = [{k: torch.from_numpy(v).to(dev) for k, v in moe_pipe.next_batch().items()}
                       for _ in range(MESH_STEPS)]
        moe_runs = host_mesh_runs(torch, moe_cfg, shape, moe_batches, opt, mesh, 11)
        report_host_mesh_runs(torch, moe_runs, moe_cfg, "(e)", smi)
        # each layer's MoE FFN once a microbatch, and again in the remat backward
        calls = MESH_LAYERS * mbs * MESH_STEPS * (2 if moe_cfg.remat else 1)
        check(moe_runs[True]["moe_routes"] == {"local": 0, "expert_parallel": calls}
              and moe_runs[False]["moe_routes"] == {"local": calls, "expert_parallel": 0},
              f"(e) MoE calls by route: sharded {moe_runs[True]['moe_routes']}, unsharded "
              f"{moe_runs[False]['moe_routes']}; {calls} expected on each run's own route")
        print(f"[mesh] (e) every MoE call of the sharded run took the expert-parallel route "
              f"({calls}), every one of the unsharded run the local route  [{smi}]")
        del moe_batches
        dist.destroy_process_group()

        # -- (c) the dry run's host-mesh cell against the card -----------------
        with fake_world(1):
            cell = dryrun.lower_cell(TRAIN_ARCH, "host", make_host_mesh(), device="cuda",
                                     cfg=cfg, shape=shape)
        check(cell["status"] == "ok", f"host-mesh dry run: {cell}")
        fake_flops = cell["hlo_profile"]["flops_per_device"]
        fake_peak = cell["memory"]["peak_bytes"]
        gap = abs(fake_peak - b_["peak"]) / b_["peak"]
        print(f"[mesh] (c) host-mesh dry run (fake tensors, {cell['trace_s']:.1f} s): FLOPs "
              f"{fake_flops:.6e} against TraceAnalysis over the card's step {real_flops:.6e}; "
              f"peak {fake_peak / 1e9:.3f} GB against the card's {b_['peak'] / 1e9:.3f} GB "
              f"({gap:+.1%})  [{smi}]")
        check(fake_flops == real_flops > 0, f"dry-run FLOPs {fake_flops} != the card step's {real_flops}")
        check(gap <= MESH_PEAK_TOL, f"dry-run peak {fake_peak} vs the card's {b_['peak']}: {gap:.1%}")

        # -- (d) the production cells ------------------------------------------
        cells_out = finish_mesh_cells(cells, smi)
    finally:
        for c in cells:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    summary = {"runs": {("sharded" if k else "unsharded"): {kk: vv for kk, vv in v.items()
                                                           if kk != "params"}
                        for k, v in runs.items()},
               "moe_runs": {("sharded" if k else "unsharded"): {kk: vv for kk, vv in v.items()
                                                               if kk != "params"}
                            for k, v in moe_runs.items()},
               "restored": restored, "checkpoint_gb": ck_gb,
               "host_cell": {"flops": fake_flops, "card_flops": real_flops,
                             "peak_bytes": fake_peak, "card_peak_bytes": b_["peak"]},
               **cells_out, "phase_s": time.perf_counter() - t_phase}
    print(f"[mesh] phase 17 in {summary['phase_s']:.1f} s  [{smi}]")
    return summary


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.api import Session, SessionConfig
    from repro_torch.engine import physical
    from repro_torch.engine.datagen import tpch_catalog
    from repro_torch.kernels import _build, column_launch, sass
    from repro_torch.engine.sampling import draw_block_ids
    from repro_torch.kernels.block_agg import ops as block_agg_ops
    from repro_torch.kernels.block_draw import block_draw
    from repro_torch.kernels.block_agg import (block_agg, block_agg_batched,
                                               block_agg_batched_ref,
                                               block_agg_ref)
    from repro_torch.kernels.filtered_agg import ops as filtered_agg_ops
    from repro_torch.kernels.filtered_agg import (filtered_agg,
                                                  filtered_agg_batched,
                                                  filtered_agg_batched_ref,
                                                  filtered_agg_ref)
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
    from repro_torch.kernels.gla_chunk import gla_chunked, gla_chunked_ref
    from repro_torch.kernels.segment_sum import ops as segment_ops
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
    from repro_torch.kernels.taqa_solve import (taqa_draw_compact, taqa_draw_compact_ref,
                                                taqa_solve_rate, taqa_solve_rate_ref)
    from repro_torch.models import layers, linear_attn
    wrappers = (filtered_agg, block_agg, filtered_agg_batched, block_agg_batched)
    model_wrappers = (flash_attention, gla_chunked)
    recorder = CallRecorder(
        [(physical, fn.__name__, ids_shape(fn.__name__)) for fn in wrappers]
        + [(physical, "segment_sum", segment_key)]
        + [(physical, "taqa_solve_rate", solve_key), (physical, "taqa_draw_compact", draw_key)]
        + [(layers, "flash_attention", q_shape), (linear_attn, "_gla_kernel", q_shape)])
    model_kernels = {"flash_attention": (flash_attention, flash_attention_ref),
                     "gla_chunked": (gla_chunked, gla_chunked_ref)}
    no_cache = SessionConfig(result_cache_size=0)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device -----------------------------------------------------------
    smi = nvidia_smi_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {device_name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for k, log in _build.build_logs.items():
        print(f"[build] {k}: {_build.build_seconds[k]:.2f} s")
        for line in ptxas_lines(log):
            print(f"[build]   {line}")
    # every column-kernel instantiation (solo and batched calls share them)
    # waits at most two memory rounds: ids and bounds, then every column
    ks = column_launch.BLOCKS_PER_WARP
    for op in ("filtered_agg", "block_agg"):
        want = {f"{op}_kernel<{k}, {b}>" for k in ks for b in ("false", "true")}
        rounds = sass.kernel_rounds(paths[op])
        for name, r in rounds.items():
            print(f"[build] load rounds (cuobjdump -sass) {name}: {sum(r)} LDG in "
                  f"{len(r)} rounds {r}")
        check(want <= set(rounds) <= want | {"column_floor_kernel"},
              f"{op}: kernels {sorted(rounds)}, expected {sorted(want)}")
        for name in sorted(want):
            check(len(rounds[name]) <= 2,
                  f"{name}: {len(rounds[name])} load rounds {rounds[name]}, at most 2")

    # the launch floor: an empty kernel on a column kernel's grid
    floor_lib = _build.load("filtered_agg")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch_floor(gx, gy):
        rc = floor_lib.column_floor_launch(gx, gy, torch.cuda.current_stream().cuda_stream)
        _build.check(floor_lib, "filtered_agg", rc)

    def floor(name, args):
        """(launch floor ms, grid, blocks per warp) of a column kernel call."""
        ids = args[IDS_AT[name]]
        batch, n_phys = (1, ids.shape[0]) if ids.dim() == 1 else tuple(ids.shape)
        per_warp = column_launch.blocks_per_warp(n_phys, sms, batch)
        grid = (column_launch.grid(n_phys, per_warp), batch)
        return time_cold(torch, lambda: launch_floor(*grid)), grid, per_warp

    # -- 3. kernels against their plain versions -------------------------------
    bounds = torch.tensor([100.0, 1500.0, 0.02, 0.08, 24.0],
                          dtype=torch.float32, device=dev)
    for br in (32, 100, 256):
        c = random_columns(torch, np, br, 4096, seed=br)
        fa_args = (c["price"], c["discount"], c["shipdate"], c["discount"],
                   c["quantity"], c["valid"], br, c["ids"], bounds)
        a, b = filtered_agg(*fa_args), filtered_agg(*fa_args)
        check(bitwise_equal(torch, a, b), f"filtered_agg br={br}: launches differ bitwise")
        compare(torch, f"filtered_agg br={br}", a, filtered_agg_ref(*fa_args), 1)
        on_bound = (c["discount"] == torch.tensor(0.02, device=dev)).any()
        check(bool(on_bound), "no row on the 0.02 bound")
        for vname in ("price", "shipdate", "valid"):
            ba_args = (c[vname], c["valid"], br, c["ids"])
            a, b = block_agg(*ba_args), block_agg(*ba_args)
            check(bitwise_equal(torch, a, b), f"block_agg br={br} {vname}: launches differ")
            compare(torch, f"block_agg br={br} {vname}", a, block_agg_ref(*ba_args), 1)
            check(bool(torch.isnan(a[900, 3])), "empty block lacks the NaN sentinel")
        print(f"[kernels] block_rows={br}: filtered_agg and block_agg (f32, "
              "int32, bool values) match their plain versions; bitwise stable")

        # every blocks-per-warp k of the solo kernels: bitwise one output
        # (Q6's aliased columns, y absent, COUNT-only; 1,027 ids, zero padded)
        check(c["ids"].shape[0] % (column_launch.WARPS_PER_CTA * 2) != 0,
              "the ids fill whole CTAs at some k")
        q6_cols = (c["price"], c["discount"], c["shipdate"], c["discount"],
                   c["shipdate"], c["valid"], br, c["ids"], bounds)
        sum_cols = (c["price"], None, *q6_cols[2:])
        bool_cols = (c["valid"], c["price"], *q6_cols[2:])
        for what, args in (("q6", q6_cols), ("sum", sum_cols), ("phase 3", fa_args),
                           ("bool x", bool_cols)):
            got = every_k_agrees(torch, f"filtered_agg br={br} {what}",
                                 filtered_agg_ops.launch, args, ks)
            check(bitwise_equal(torch, got, filtered_agg(*args)),
                  f"filtered_agg br={br} {what}: the wrapper's k differs")
            compare(torch, f"filtered_agg br={br} {what}", got, filtered_agg_ref(*args), 1)
        for vname in ("price", "shipdate", "valid"):
            args = (c[vname], c["valid"], br, c["ids"])
            got = every_k_agrees(torch, f"block_agg br={br} {vname}",
                                 block_agg_ops.launch, args, ks)
            check(bitwise_equal(torch, got, block_agg(*args)),
                  f"block_agg br={br} {vname}: the wrapper's k differs")
        print(f"[kernels] block_rows={br}: filtered_agg (Q6 aliasing, y absent, bool x) "
              f"and block_agg (f32, int32, COUNT-only) bitwise equal at every "
              f"blocks-per-warp k {list(ks)} on {c['ids'].shape[0]:,} ids")

        # the batched kernels: 3 lanes, each with its own ids and bounds
        lanes = torch.stack([
            c["ids"], c["ids"].flip(0),
            torch.from_numpy(lane_ids(np, np.random.default_rng(br), 4096,
                                      c["ids"].shape[0], 1, pad=100)[0]).to(dev)])
        lane_bounds = torch.tensor([[100.0, 1500.0, 0.02, 0.08, 24.0],
                                    [0.0, 2525.0, 0.05, 0.07, 40.0],
                                    [-3.0e38, 3.0e38, 0.0, 0.02, 3.0e38]],
                                   dtype=torch.float32, device=dev)
        fb = (c["price"], c["discount"], c["shipdate"], c["discount"],
              c["quantity"], c["valid"], br)
        a = filtered_agg_batched(*fb, lanes, lane_bounds)
        check(bitwise_equal(torch, a, filtered_agg_batched(*fb, lanes, lane_bounds)),
              f"filtered_agg_batched br={br}: launches differ bitwise")
        for what, args in (("phase 3", (*fb, lanes, lane_bounds)),
                           ("q6", (*q6_cols[:7], lanes, lane_bounds)),
                           ("sum", (*sum_cols[:7], lanes, lane_bounds)),
                           ("bool x", (*bool_cols[:7], lanes, lane_bounds))):
            got = every_k_agrees(torch, f"filtered_agg_batched br={br} {what}",
                                 filtered_agg_ops.launch, args, ks)
            check(bitwise_equal(torch, got, filtered_agg_batched(*args)),
                  f"filtered_agg_batched br={br} {what}: the wrapper's k differs")
        want = filtered_agg_batched_ref(*fb, lanes, lane_bounds)
        compare(torch, f"filtered_agg_batched br={br}", a.reshape(-1, 3),
                want.reshape(-1, 3), 1)
        for b in range(lanes.shape[0]):
            solo = filtered_agg(*fb, lanes[b].contiguous(), lane_bounds[b].contiguous())
            check(bitwise_equal(torch, a[b], solo),
                  f"filtered_agg_batched br={br} lane {b}: not bitwise the solo kernel")
        for vname in ("price", "shipdate", "valid"):
            bb = (c[vname], c["valid"], br, lanes)
            a = block_agg_batched(*bb)
            check(bitwise_equal(torch, a, block_agg_batched(*bb)),
                  f"block_agg_batched br={br} {vname}: launches differ")
            check(bitwise_equal(torch, a, every_k_agrees(
                torch, f"block_agg_batched br={br} {vname}", block_agg_ops.launch, bb, ks)),
                f"block_agg_batched br={br} {vname}: the wrapper's k differs")
            compare(torch, f"block_agg_batched br={br} {vname}", a.reshape(-1, 5),
                    block_agg_batched_ref(*bb).reshape(-1, 5), 1)
            for b in range(lanes.shape[0]):
                solo = block_agg(c[vname], c["valid"], br, lanes[b].contiguous())
                check(bitwise_equal(torch, a[b], solo),
                      f"block_agg_batched br={br} {vname} lane {b}: not bitwise solo")
        print(f"[kernels] block_rows={br}: filtered_agg_batched and "
              "block_agg_batched (3 lanes, per-lane bounds) match their plain "
              "versions; every lane bitwise the solo kernel; bitwise equal at "
              f"every blocks-per-warp k {list(ks)}; bitwise stable")
    torch.cuda.synchronize()
    floors = {g: time_cold(torch, lambda: launch_floor(g, 1))
              for g in (1, 64, 128, 1_024, 8_192)}
    print("[kernels] launch floor (empty kernel, 256 threads per CTA, L2 flushed): "
          + ", ".join(f"{g:,} CTAs {ms * 1e3:.2f} us" for g, ms in floors.items())
          + f"  [{smi}]")

    # -- 3b. the model kernels at fixed scaling points ---------------------------
    model_scale = {k: [time_model_kernel(torch, np, k, *model_kernels[k], args, kw, smi,
                                         launch_floor)
                       for args, kw in points]
                   for k, points in model_kernel_scaling_points(torch, np, dev).items()}
    torch.cuda.empty_cache()

    # -- 4. main path at SF10 --------------------------------------------------
    t0 = time.perf_counter()
    catalog = tpch_catalog(scale_rows=SF10_ROWS, block_rows=BLOCK_ROWS, seed=0)
    torch.cuda.synchronize()
    li = catalog["lineitem"]
    print(f"[main] tpch_catalog(scale_rows={SF10_ROWS:,}, block_rows={BLOCK_ROWS}): "
          f"{li.num_blocks:,} lineitem blocks, "
          f"{sum(t.total_bytes() for t in catalog.values()) / 1e9:.3f} GB of columns "
          f"on the card, built in {time.perf_counter() - t0:.1f} s")

    session = Session(catalog, seed=42, config=no_cache)
    queries = {"q6": Q6, "sum_count": SUM_COUNT}
    drawn = spy(session)
    zero_counters(wrappers + (block_draw,))
    recorder.active = {"filtered_agg", "block_agg"}
    first = {}
    for qn, sql in queries.items():
        first[qn] = (run_sql(torch, session, sql),
                     run_sql(torch, session, sql + GUARANTEE))
    recorder.active = set()
    launches = read_counters(wrappers + (block_draw,))
    print(f"[main] kernel launches on the main path: {launches}")
    # every sampled scan draws on the card: one block_draw a pilot draw
    # (retries included) and a final, two or more a solo approximate query
    # (one where it fell back to exact)
    n_draws = len(drawn["pilots"]) + len(drawn["finals"])
    least = sum(1 if ah.report.fallback else 2 for _, (ah, _) in first.values())
    check(launches["block_draw"] == n_draws >= least,
          f"block_draw launched {launches['block_draw']} times for {len(drawn['pilots'])} "
          f"pilot draws and {len(drawn['finals'])} sampled finals; at least {least} "
          f"for {len(queries)} approximate queries")
    for info in drawn["finals"]:
        check(np.array_equal(info.sampled_block_ids,
                             draw_block_ids(info.n_total_blocks, info.rate, info.seed)),
              f"a final's ids at rate {info.rate} seed {info.seed} are not the host draw's")
    draw_rates = sorted({theta for _, theta, _ in drawn["pilots"]}
                        | {info.rate for info in drawn["finals"]})
    print(f"[main] block draws on the card: {launches['block_draw']} launches for "
          f"{len(drawn['pilots'])} pilots and {len(drawn['finals'])} finals; the finals' "
          f"ids bitwise draw_block_ids; rates {draw_rates}")
    draw_rows = check_block_draw(torch, np, draw_rates, dev, launch_floor, smi)
    check(launches["filtered_agg"] > 0, "the Q6 path never launched filtered_agg")
    check(launches["block_agg"] > 0, "the SUM/COUNT path never launched block_agg")
    print(f"[main] solo launches' ids (n_phys,): "
          f"{ {k: recorder.shapes[k] for k in ('filtered_agg', 'block_agg')} }")

    # the solo kernels at the main path's own inputs, and at a large final
    cols = li.columns
    q6_bounds = torch.tensor([100.0, 1500.0, 0.02, 0.08, 3.0e38],
                             dtype=torch.float32, device=dev)
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(np.sort(rng.choice(li.num_blocks, SCALE_N_PHYS, replace=False))
                           .astype(np.int32)).to(dev)
    q6_cols = (cols["l_extendedprice"], cols["l_discount"], cols["l_shipdate"],
               cols["l_discount"], cols["l_shipdate"], li.valid, BLOCK_ROWS)
    timed = time_recorded(torch, np, recorder, {
        "filtered_agg": (filtered_agg, filtered_agg_ref, None),
        "block_agg": (block_agg, block_agg_ref, None)}, {
        "filtered_agg": [(*q6_cols, ids, q6_bounds)],
        "block_agg": [(cols["l_extendedprice"], li.valid, BLOCK_ROWS, ids)]}, smi, floor)

    # each solo kernel at every k, sorted distinct ids of the SF10 table
    sweep_rng = np.random.default_rng(11)

    def sweep_ids(n):
        return torch.from_numpy(np.sort(sweep_rng.choice(li.num_blocks, n, replace=False))
                                .astype(np.int32)).to(dev)
    choose = lambda n: column_launch.blocks_per_warp(n, sms)
    sweep_args = {n: sweep_ids(n) for n in K_SWEEP_N_PHYS}
    sweep = {
        "filtered_agg": k_sweep(torch, "filtered_agg", filtered_agg_ops.launch,
                                lambda n: (*q6_cols, sweep_args[n], q6_bounds),
                                K_SWEEP_N_PHYS, ks, choose, smi),
        "block_agg": k_sweep(torch, "block_agg", block_agg_ops.launch,
                             lambda n: (cols["l_extendedprice"], li.valid, BLOCK_ROWS,
                                        sweep_args[n]),
                             K_SWEEP_N_PHYS, ks, choose, smi)}
    del sweep_args

    # correctness of the exact route at full size: f64 numpy over the same data
    price = cols["l_extendedprice"].cpu().numpy().astype(np.float64)
    disc32 = cols["l_discount"].cpu().numpy()
    ship32 = cols["l_shipdate"].cpu().numpy().astype(np.float32)
    keep = ((ship32 >= np.float32(100)) & (ship32 <= np.float32(1500))
            & (disc32 >= np.float32(0.02)) & (disc32 <= np.float32(0.08)))
    truth = {"q6": [float((price * disc32.astype(np.float64))[keep].sum())],
             "sum_count": [float(price.sum()), float(SF10_ROWS)]}
    del price, disc32, ship32, keep

    for qn, ((eh, _), (ah, _)) in first.items():
        exact = eh.answer.values[:, 0]
        approx = ah.answer.values[:, 0]
        check(np.all(np.isfinite(exact)) and np.all(np.isfinite(approx)),
              f"{qn}: non-finite answer")
        np.testing.assert_allclose(exact, truth[qn], rtol=1e-5,
                                   err_msg=f"{qn}: exact answer vs f64 numpy")
        rel = np.abs(approx - exact) / np.abs(exact)
        r = ah.report
        check(bool(np.all(rel <= 0.05)) or r.fallback is not None,
              f"{qn}: error {rel} above 5% without a fallback")
        print(f"[main] {qn}: exact {exact.tolist()} (f64 numpy {truth[qn]}); "
              f"approx {approx.tolist()}, error {rel.max():.4%}, "
              f"fallback {r.fallback}, plan {r.plan.rates if r.plan else None}, "
              f"pilot blocks {r.n_pilot_blocks}")

    summary = {}
    for qn, sql in queries.items():
        walls, exact_walls = [], []
        stage = {"pilot": [], "rate_solve": [], "final": []}
        for _ in range(WARM_RUNS):
            eh, ew = run_sql(torch, session, sql)
            ah, aw = run_sql(torch, session, sql + GUARANTEE)
            exact_walls.append(ew)
            walls.append(aw)
            stage["pilot"].append(ah.report.pilot_time_s)
            stage["rate_solve"].append(ah.report.plan_time_s)
            stage["final"].append(ah.report.final_time_s)
        r = ah.report
        scanned = (r.pilot_scanned_bytes + r.final_scanned_bytes) / r.exact_scanned_bytes
        med = {k: statistics.median(v) * 1e3 for k, v in stage.items()}
        approx_ms = statistics.median(walls) * 1e3
        exact_ms = statistics.median(exact_walls) * 1e3
        summary[qn] = dict(approx_ms=approx_ms, exact_ms=exact_ms,
                           scanned_fraction=scanned, **{f"{k}_ms": v for k, v in med.items()})
        print(f"[main] {qn} (median of {WARM_RUNS} warm runs): approx {approx_ms:.2f} ms "
              f"= pilot {med['pilot']:.2f} + rate solve {med['rate_solve']:.2f} + final "
              f"{med['final']:.2f} ms (+ parse/plan); exact {exact_ms:.2f} ms; "
              f"scanned {scanned:.4%} of the exact bytes; exact/approx wall "
              f"{exact_ms / approx_ms:.3f}x  [{smi}]")
    # where an approximate query's time goes: device busy share under the
    # profiler, and the main path's block draw over every block (done twice
    # per query, pilot and final): the entry's wall, the kernel its part
    sf10_draw = [r for r in draw_rows if r["n_blocks"] == li.num_blocks]
    draw_ms = statistics.median(r["entry_wall_ms"] for r in sf10_draw)
    print(f"[main] the card's block draw over {li.num_blocks:,} blocks: "
          f"{draw_ms:.3f} ms a draw (median over rates {draw_rates}; the kernel "
          f"{statistics.median(r['ms'] for r in sf10_draw) * 1e3:.2f} us; the host "
          f"draw_block_ids it replaced "
          f"{statistics.median(r['host_draw_ms'] for r in sf10_draw):.2f} ms)")
    for qn, sql in queries.items():
        for kind, text in (("approx", sql + GUARANTEE), ("exact", sql)):
            busy, wall = device_busy_ms(torch, lambda: session.sql(text))
            summary[qn][f"{kind}_device_busy_ms"] = busy
            summary[qn][f"{kind}_profiled_wall_ms"] = wall
            share = "not measured" if busy is None else f"{1 - busy / wall:.1%}"
            print(f"[main] {qn} {kind} under torch.profiler: device kernels "
                  f"{busy if busy is None else round(busy, 4)} ms of {wall:.2f} ms "
                  f"wall; device idle share {share}  [{smi}]")
    summary["block_draw_ms"] = draw_ms
    session.close()

    # -- 6. the serving path: submit + drain -----------------------------------
    drain = run_drain(torch, np, catalog, Session, SessionConfig, wrappers,
                      recorder, smi)
    # the batched kernels at the drain's own inputs, beside B solo launches,
    # and at B lanes of a herd-sized and of a large final
    lane_bounds = q6_bounds.repeat(SCALE_BATCH, 1).contiguous()
    lanes = [torch.from_numpy(lane_ids(np, rng, li.num_blocks, n, SCALE_BATCH)).to(dev)
             for n in SCALE_BATCH_N_PHYS]
    timed.update(time_recorded(torch, np, recorder, {
        "filtered_agg_batched": (filtered_agg_batched, filtered_agg_batched_ref,
                                 filtered_agg),
        "block_agg_batched": (block_agg_batched, block_agg_batched_ref, block_agg)}, {
        "filtered_agg_batched": [(*q6_cols, ids, lane_bounds) for ids in lanes],
        "block_agg_batched": [(cols["l_extendedprice"], li.valid, BLOCK_ROWS, ids)
                              for ids in lanes]},
        smi, floor))
    # each batched kernel at every k, SCALE_BATCH lanes of sorted distinct ids
    sweep_lanes = {n: torch.from_numpy(lane_ids(np, sweep_rng, li.num_blocks, n,
                                                SCALE_BATCH)).to(dev)
                   for n in K_SWEEP_BATCH_N_PHYS}
    choose = lambda n: column_launch.blocks_per_warp(n, sms, SCALE_BATCH)
    sweep["filtered_agg_batched"] = k_sweep(
        torch, "filtered_agg_batched", filtered_agg_ops.launch,
        lambda n: (*q6_cols, sweep_lanes[n], lane_bounds), K_SWEEP_BATCH_N_PHYS,
        ks, choose, smi, lanes=SCALE_BATCH)
    sweep["block_agg_batched"] = k_sweep(
        torch, "block_agg_batched", block_agg_ops.launch,
        lambda n: (cols["l_extendedprice"], li.valid, BLOCK_ROWS, sweep_lanes[n]),
        K_SWEEP_BATCH_N_PHYS, ks, choose, smi, lanes=SCALE_BATCH)
    del sweep_lanes

    # -- 8. the gather route: grouped, join and Q14 queries, a grouped herd ------
    gather = run_gather(torch, np, catalog, Session, SessionConfig, segment_sum,
                        recorder, smi)
    ss_calls = recorder.calls["segment_sum"]
    check(bool(ss_calls), "segment_sum: no call of the gather route was recorded")
    gather["segment_sum"] = [
        time_segment_sum(torch, segment_ops, segment_sum_ref, args, kwargs, smi,
                         launch_floor)
        for args, kwargs in ss_calls.values()]
    ss_calls.clear()
    # no recorded pilot, final or exact scan reaches the stable sort; the
    # sorted route is held and timed at a fixed input of its own
    for r in gather["segment_sum"]:
        check(r["route"] != "sorted", f"segment_sum {r['shape']} took the sorted route")
    # the grouped herd's stacked pilot: replayed above on the slab route
    stacked_rows = [r for r in gather["segment_sum"]
                    if tuple(r["shape"]) in gather["herd"]["stacked_input"]]
    check(len(stacked_rows) == 1 and stacked_rows[0]["route"] == "slab",
          f"the herd's stacked pilot input {gather['herd']['stacked_input']}: "
          f"replayed {[(r['shape'], r['route']) for r in stacked_rows]}")
    gather["segment_sum_sorted_point"] = sorted_route_point(
        torch, np, segment_ops, segment_sum_ref, smi, launch_floor)
    routes = {r["route"] for r in gather["segment_sum"]}
    routes.add(gather["segment_sum_sorted_point"]["route"])
    check(routes == {"slab", "few", "sorted"}, f"segment_sum routes launched: {routes}")
    torch.cuda.synchronize()
    for fn in wrappers:
        recorder.calls[fn.__name__].clear()

    # -- 9. staged ladders and shards on the same SF10 lineitem ----------------
    staged = run_staged_shards(torch, np, li, Session, SessionConfig,
                               (filtered_agg, block_agg, segment_sum), recorder, smi)
    # every kernel input of phase 9's staged and sharded sessions (first call
    # per shape and session; the plain session's are phase 4's and 8's):
    # against its plain version, then timed, as phases 4 and 8 do
    staged["kernels"] = {"filtered_agg": [], "block_agg": [], "segment_sum": []}
    for tag, calls in staged.pop("calls").items():
        if tag == "plain":
            continue
        print(f"[staged] kernel inputs of the {tag} session:")
        for name, (fn, ref) in (("filtered_agg", (filtered_agg, filtered_agg_ref)),
                                ("block_agg", (block_agg, block_agg_ref))):
            for args, _ in calls[name].values():
                row = time_kernel(torch, np, name, fn, ref, None, args, smi, floor)
                staged["kernels"][name].append({"session": tag, **row})
        for args, kwargs in calls["segment_sum"].values():
            row = time_segment_sum(torch, segment_ops, segment_sum_ref, args, kwargs,
                                   smi, launch_floor)
            staged["kernels"]["segment_sum"].append({"session": tag, **row})
    for name, rows in staged["kernels"].items():
        check(bool(rows), f"{name}: no call of phase 9 was recorded")
    for r in staged["kernels"]["segment_sum"]:
        check(r["route"] != "sorted", f"segment_sum {r['shape']} took the sorted route")
    staged_launches = {
        name: sum(sess["launches"][name] for sess in staged["sessions"].values())
        + staged["drain"]["launches"][name]
        for name in ("filtered_agg", "block_agg", "segment_sum")}
    print(f"[staged] phase 9 launches, every session and the drain: {staged_launches}")
    torch.cuda.synchronize()

    # -- 10. the fused path, Quickr and the eager oracle on the same lineitem ----
    taqa_wrappers = (taqa_solve_rate, taqa_draw_compact)
    fused = run_fused_quickr_eager(
        torch, np, li, Session, SessionConfig,
        (filtered_agg, block_agg, segment_sum, *taqa_wrappers), recorder, smi)
    fused["kernels"] = time_taqa_kernels(
        torch, np, fused.pop("calls"), taqa_wrappers,
        (taqa_solve_rate_ref, taqa_draw_compact_ref), launch_floor, smi)
    for name in ("taqa_solve_rate", "taqa_draw_compact"):
        check(bool(fused["kernels"].get(name)), f"{name}: no call of phase 10 was recorded")
    torch.cuda.synchronize()

    # -- 11. streaming, tracing, audit and telemetry on the same lineitem ------
    obs = run_obs(torch, np, li, Session, SessionConfig,
                  (*wrappers, segment_sum, *taqa_wrappers), smi)
    torch.cuda.synchronize()

    # -- 12 (a). the SQL gateway over phase 6's herd on the same lineitem -------
    gateway = run_gateway(torch, np, li, Session, SessionConfig, wrappers, recorder, smi)
    # every column-kernel input of the gateway's cold round (first call per
    # shape): against its plain version (batched: each lane bitwise a solo
    # launch), then timed, as phases 4 and 6 do
    solo_of = {"filtered_agg_batched": filtered_agg, "block_agg_batched": block_agg}
    refs = {"filtered_agg": filtered_agg_ref, "block_agg": block_agg_ref,
            "filtered_agg_batched": filtered_agg_batched_ref,
            "block_agg_batched": block_agg_batched_ref}
    gateway_calls = gateway.pop("calls")
    gateway["kernels"] = {
        fn.__name__: [time_kernel(torch, np, fn.__name__, fn, refs[fn.__name__],
                                  solo_of.get(fn.__name__), args, smi, floor)
                      for args, _ in gateway_calls[fn.__name__].values()]
        for fn in wrappers}
    del gateway_calls
    torch.cuda.synchronize()
    del session, catalog, cols, li, ids, lanes, q6_cols
    torch.cuda.empty_cache()

    # -- 5. the same route on both devices -------------------------------------
    answers = {}
    for devname in ("cuda", "cpu"):
        cat = tpch_catalog(scale_rows=200_000, block_rows=BLOCK_ROWS, seed=0,
                           device=devname)
        s = Session(cat, seed=42, device=devname, config=no_cache)
        seen = spy(s)
        hs = [s.sql(sql + GUARANTEE) for sql in (Q6, SUM_COUNT)]
        for h in hs:
            check(h.status == "done", f"{devname}: {h.error}")
        answers[devname] = (hs, seen)
        s.close()
    (gh, gseen), (ch, cseen) = answers["cuda"], answers["cpu"]
    check(gseen["pilots"] == cseen["pilots"], "pilot draws differ between devices")
    check(len(gseen["final_ids"]) == len(cseen["final_ids"]), "final count differs")
    for a, b in zip(gseen["final_ids"], cseen["final_ids"]):
        check(a.keys() == b.keys() and all(np.array_equal(a[t], b[t]) for t in a),
              "final block ids differ between devices")
    for g, c in zip(gh, ch):
        check(g.fallback == c.fallback, "fallback differs between devices")
        check((g.report.plan is None) == (c.report.plan is None), "plans differ")
        if g.report.plan is not None:
            for t, rate in g.report.plan.rates.items():
                rc = c.report.plan.rates[t]
                check(abs(rate - rc) <= 1e-6 * abs(rc), f"rates differ: {rate} vs {rc}")
        np.testing.assert_allclose(g.answer.values, c.answer.values, rtol=1e-5)
    print(f"[devices] 200k rows: CUDA and CPU sessions agree (pilot draws and final "
          f"ids equal; rates within 1e-6; answers within 1e-5): "
          f"{[h.answer.values.ravel().tolist() for h in gh]}")

    # -- 12 (b)-(d). LM serving: prefill, decode_step and ServeEngine ----------
    serving = run_lm_serving(torch, np, smi, recorder, model_wrappers)
    # the model kernels at the serving prefills' own inputs (first call per
    # q shape), held and timed like phase 7's; then the recorder starts afresh
    serving["kernels"] = {}
    for kname, (fn, ref) in model_kernels.items():
        calls = recorder.calls[kname]
        check(bool(calls), f"{kname}: no call of the serving prefills was recorded")
        serving["kernels"][kname] = [time_model_kernel(torch, np, kname, fn, ref, args, kw, smi,
                                                       launch_floor)
                                     for args, kw in calls.values()]
        calls.clear()
        recorder.shapes[kname].clear()
    torch.cuda.empty_cache()

    # -- 7. the eval path: hymba-1.5b through GuaranteedEvaluator ---------------
    evaluation = run_eval(torch, np, smi, recorder, model_wrappers)
    # the model kernels at the eval forward's own inputs (first call per shape)
    model_timed = {}
    for kname, (fn, ref) in model_kernels.items():
        calls = recorder.calls[kname]
        check(bool(calls), f"{kname}: no call of the eval forward was recorded")
        rows = [time_model_kernel(torch, np, kname, fn, ref, args, kw, smi, launch_floor)
                for args, kw in calls.values()]
        model_timed[kname] = {"headline": rows[0], "main_path": rows,
                              "scaling_points": model_scale[kname]}
    recorder.calls.clear()
    torch.cuda.empty_cache()

    # -- 13. training: the backward kernels, internlm2 and hymba at full width ---
    training = run_train(torch, np, smi, launch_floor)

    # -- 14. the encoder-decoder, the VLM and gemma's head_dim 256 at full width -
    families = run_families(torch, np, smi, launch_floor)

    # -- 15. every text config reduced, through launch.serve and launch.train ---
    reduced = run_reduced(torch, np, smi, launch_floor)

    # -- 16. two-level remat at full depth ---------------------------------------
    remat = run_remat_groups(torch, np, smi)

    # -- 17. the device mesh: DTensor training, the elastic restore, the dry run -
    mesh = run_mesh(torch, np, smi)

    # -- results ---------------------------------------------------------------
    sources = {
        "filtered_agg": "src/repro_torch/kernels/filtered_agg/csrc/filtered_agg.cu",
        "block_agg": "src/repro_torch/kernels/block_agg/csrc/block_agg.cu",
        "filtered_agg_batched": "src/repro_torch/kernels/filtered_agg/csrc/filtered_agg.cu",
        "block_agg_batched": "src/repro_torch/kernels/block_agg/csrc/block_agg.cu"}
    replaces = {
        "filtered_agg": "src/repro/kernels/filtered_agg/kernel.py:114",
        "block_agg": "src/repro/kernels/block_agg/kernel.py:92",
        "filtered_agg_batched": "src/repro/kernels/filtered_agg/kernel.py:85",
        "block_agg_batched": "src/repro/kernels/block_agg/kernel.py:63"}
    # each kernel's headline: the main path's own call with the most blocks
    # (the sql path's for the solo kernels, the drain's for the batched ones)
    kernels = []
    for k in sources:
        t = timed[k]["headline"]
        path = "drain" if k.endswith("_batched") else "sql"
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k],
            "replaces": replaces[k],
            "launches": (drain["launches"] if path == "drain" else launches)[k],
            "launches_by_path": {"sql": launches[k], "drain": drain["launches"][k],
                                 **({"staged_shards": staged_launches[k]}
                                    if k in staged_launches else {}),
                                 "obs": obs["launches"][k],
                                 "serve_gateway": gateway["launches"][k]},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "floor_ms": t["floor_ms"],
            "blocks_per_warp": t["blocks_per_warp"], "grid": t["grid"],
            "ids_shape": t["ids_shape"], "solo_ms": t.get("solo_ms"),
            "main_path": timed[k]["main_path"],
            "scaling_points": timed[k]["scaling_points"], "k_sweep": sweep[k],
            "staged_shards": staged["kernels"].get(k),
            "serve_gateway": gateway["kernels"][k],
        })
    # segment_sum's headline: its recorded input with the most work (the
    # largest bytes bound)
    head = max(gather["segment_sum"], key=lambda r: r["bound_ms"])
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        "replaces": "src/repro/engine/physical.py:877",
        "replaces_note": "the gather route's XLA scatter-add (.at[:, seg].add, "
                         "physical.py:256, :276, :877-878, :1072-1082); no Pallas original",
        "launches": gather["launches"],
        "launches_by_path": {"gather": gather["launches_by_query"],
                             "gather_herd": gather["herd"]["segment_sum_launches"],
                             "gather_herd_stacked_pilot":
                                 gather["herd"]["stacked_pilot_launches"],
                             "staged_shards": staged_launches["segment_sum"],
                             "obs": obs["launches"]["segment_sum"]},
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "floor_ms": head["floor_ms"], "sort_ms": head["sort_ms"],
        "shape": head["shape"], "route_taken": head["route"],
        "main_path": gather["segment_sum"],
        "sorted_route_point": gather["segment_sum_sorted_point"],
        "staged_shards": staged["kernels"]["segment_sum"],
    })
    # the block draw: no Pallas original (the reference draws on the host
    # with numpy); its headline is SF10 at the main path's smallest rate
    head = min(sf10_draw, key=lambda r: r["rate"])
    kernels.append({
        "name": "block_draw", "route": "cuda",
        "source": "src/repro_torch/kernels/block_draw/csrc/block_draw.cu",
        "replaces": "src/repro/engine/sampling.py:55",
        "replaces_note": "the reference's host numpy block draw "
                         "(default_rng(seed).random(N) < rate, nonzero); no Pallas original",
        "launches": launches["block_draw"],
        "launches_by_path": {"sql": launches["block_draw"]},
        "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "floor_ms": head["floor_ms"],
        "host_draw_ms": head["host_draw_ms"], "n_blocks": head["n_blocks"],
        "rate": head["rate"], "main_path": draw_rows,
    })
    model_sources = {
        "flash_attention": ("src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                            "src/repro/kernels/flash_attn/kernel.py:76"),
        "gla_chunked": ("src/repro_torch/kernels/gla_chunk/csrc/gla_chunk.cu",
                        "src/repro/kernels/gla_chunk/kernel.py:103")}
    for k, (source, replaced) in model_sources.items():
        t = model_timed[k]["headline"]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaced,
            "launches": evaluation["launches"][k],
            "launches_by_path": {
                "eval": evaluation["launches"][k],
                "serve_prefill": {arch: serving[arch]["teacher_forcing"]["prefill_launches"][k]
                                  for arch in (SERVE_ARCH, SERVE_MOE_ARCH)},
                "train": {"internlm2-1.8b": training["internlm2"]["launches"].get(k, 0),
                          "hymba-1.5b": training["hymba"]["launches"][k]},
                "families_train": {arch: families[arch]["launches"].get(k, 0)
                                   for arch in FAMILY_TEXT},
                "reduced": {arch: reduced[arch]["launches"][k] for arch in REDUCED_ARCHS},
                **({"mesh_sharded": {TRAIN_ARCH: mesh["runs"]["sharded"]["launches"][0],
                                     MESH_MOE_ARCH: mesh["moe_runs"]["sharded"]["launches"][0]}}
                   if k == "flash_attention" else {})},
            "launches_per_forward": evaluation["launches_per_forward"][k],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "main_path": model_timed[k]["main_path"],
            "scaling_points": model_timed[k]["scaling_points"],
            "serve_prefill": serving["kernels"][k],
            "families": {arch: families[arch]["kernels"].get(k, []) for arch in FAMILY_TEXT},
            "reduced": reduced["kernels"][k],
        })
    # the fused path's two kernels: no Pallas original (the reference's fused
    # program computes the solve and the draw in XLA); each headline is the
    # fused Q6's own call
    taqa_sources = {
        "taqa_solve_rate": "src/repro/engine/physical.py:1163",
        "taqa_draw_compact": "src/repro/engine/physical.py:1211"}
    for k, replaced in taqa_sources.items():
        t = fused["kernels"][k][0]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/taqa_solve/csrc/taqa_solve.cu",
            "replaces": replaced,
            "replaces_note": "the reference's fused XLA program (physical.py:1163-1218); "
                             "no Pallas original",
            "launches": fused["launches"][k],
            "launches_per_query": {qn: r["launches"][k]
                                   for qn, r in fused["per_query"].items()},
            "launches_by_path": {"fused": fused["launches"][k],
                                 "obs": obs["launches"][k]},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "floor_ms": t["floor_ms"],
            "shape": t["shape"],
            "main_path": [r for r in fused["kernels"][k] if r["input"] == "main path"],
            "scaling_points": [r for r in fused["kernels"][k]
                               if r["input"] == "scaling point"]})
    # the backward kernels: no Pallas original (the reference differentiates
    # its XLA attention with jax.value_and_grad); each headline is the
    # training path's first recorded call (internlm2's for flash, hymba's
    # for GLA)
    bwd_sources = {
        "flash_attention_bwd": (
            "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu",
            "src/repro/kernels/flash_attn/kernel.py:76",
            "the gradient of that kernel's function: the reference trains through its XLA "
            "mea_attention (src/repro/models/layers.py:54) under jax.value_and_grad "
            "(src/repro/train/step.py:68); no Pallas backward", "internlm2"),
        "gla_chunked_bwd": (
            "src/repro_torch/kernels/gla_chunk/csrc/gla_chunk_bwd.cu",
            "src/repro/kernels/gla_chunk/kernel.py:103",
            "the gradient of that kernel's function: the reference trains through its XLA "
            "gla_chunked_xla (src/repro/models/linear_attn.py:25) under jax.value_and_grad "
            "(src/repro/train/step.py:68); no Pallas backward", "hymba")}
    for k, (source, replaced, note, path) in bwd_sources.items():
        t = training["kernels"][k][0]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaced,
            "replaces_note": note,
            "launches": training[path]["launches"][k],
            "launches_by_path": {"train_internlm2": training["internlm2"]["launches"].get(k, 0),
                                 "train_hymba": training["hymba"]["launches"][k],
                                 "families_train": {arch: families[arch]["launches"].get(k, 0)
                                                    for arch in FAMILY_TEXT},
                                 "reduced": {arch: reduced[arch]["launches"][k]
                                             for arch in REDUCED_ARCHS},
                                 **({"mesh_sharded": {
                                     TRAIN_ARCH: mesh["runs"]["sharded"]["launches"][1],
                                     MESH_MOE_ARCH: mesh["moe_runs"]["sharded"]["launches"][1]}}
                                    if k == "flash_attention_bwd" else {})},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "floor_ms": t["floor_ms"], "shape": t["shape"],
            "main_path": training["kernels"][k],
            "families": {arch: families[arch]["kernels"].get(k, []) for arch in FAMILY_TEXT},
            "reduced": reduced["kernels"][k], "checks": [
                r for r in training["checks"] if r["name"] == k],
            "sass": [r for r in training["sass"]
                     if r["library"] == os.path.basename(source)[:-3]]})
    summary["train"] = {k: v for k, v in training.items() if k not in ("kernels", "checks")}
    summary["families"] = {arch: {k: v for k, v in r.items() if k != "kernels"}
                           if isinstance(r, dict) else r for arch, r in families.items()}
    summary["reduced"] = {k: v for k, v in reduced.items() if k != "kernels"}
    summary["remat_groups"] = remat
    summary["mesh"] = mesh
    summary["drain"] = drain
    summary["fused"] = {k: v for k, v in fused.items() if k != "kernels"}
    summary["gather"] = gather
    summary["staged_shards"] = {k: v for k, v in staged.items() if k != "kernels"}
    summary["eval"] = evaluation
    summary["obs"] = obs
    summary["serve"] = {"gateway": {k: v for k, v in gateway.items() if k != "kernels"},
                        "lm": {k: v for k, v in serving.items() if k != "kernels"}}
    print(f"[done] {time.perf_counter() - t_start:.1f} s; main path {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
