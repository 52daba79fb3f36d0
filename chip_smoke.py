#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line). After
2, phases 4-6, 13, 14, 17 (c) and 18 run in worker processes (a lower
scheduling priority than this process, save fig12's run in 18) beside
3, 8-12, 15, 16 and 17 (a)-(b) here; once every worker is joined, the
shapes they launched are checked and every kernel is timed (7, 12 and
15's timings), with no other process on the card:
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit;
  2. build the CUDA kernels from the sources in the checkout (one nvcc per
     source, all at once) and print the build time and ptxas report, and
     count K4's wgmma (HGMMA) and TMA instructions and K6's tensor-core
     (HMMA) and TMA instructions in their machine code, and the HMMA of
     each bf16 backward kernel function on its own (failing where one has
     none), with its registers, spills and dynamic shared memory;
  3. hold each kernel against its plain PyTorch version on the card (the
     segment-DP and k-NN kernels bit for bit, over profile kinds, M, G and
     k, with the segment DP also at the edges of its tiling plan, and over
     ties, k and warps a query; the fused MLP predict also bit for bit
     against the five launches it replaces);
  4. replay the ``methylseq`` workflow at scale 1.0 through
     ``SizeyMethod(device="cuda")`` (the peak path) with the launch
     counters zeroed just before; every kernel of the path must have
     launched, once per predictor dispatch, and the wastage and failures
     must lie within the JAX reference's own spread;
  5. replay it through ``make_method("sizey_temporal", device="cuda")``
     (the temporal path), counters zeroed again: the segment-DP kernel
     must have launched once per boundary fit, every decision's boundaries
     must be the reference oracle's on the pool's profiles, and the
     time-integrated wastage and failures must lie within the reference's
     spread; then through ``make_method("ks_plus", device="cuda")``, which
     must give the reference's totals exactly; every shape the kernels
     were given in 4 and 5 is then checked as in 3, with every k;
  6. replay a small scale of both Sizey paths on the card and on the CPU
     through the port and compare the decisions;
  7. (after every worker is joined) time each
     kernel, its plain version and a library yardstick with CUDA events,
     beside the least time the card could take; K1 and K2 at every
     shape the replays launched and K3 at four M and at every M the
     temporal path launched, each also split into its device time
     (torch.profiler) and the host's time to issue it, with each replay's
     launch-weighted total, and mlp.predict_batch beside the five launches
     it replaces;
  8. hold K4 flash_attention, K5 flash_decode and K6 ssd_scan against their
     plain versions on the card at the reference's test shapes, fp32 and
     bf16; K6 in bf16 also no farther from its plain version, relative to
     the largest |y|, than twice the fp32 kernel fed the same values; K5
     also on e4m3 caches (P rounded to e4m3 and to the query's type) and
     its log-sum-exp variant over 1, 2 and 4 slices of the cache;
  9. serve zamba2-7b at full width (bf16, random weights from a seed) on the
     card through ``ServeEngine`` with ``KVCacheSizer``: 32 requests in 4
     batches of 8, prompts of 256..2048 tokens, 32 new tokens each at
     temperature 0.8, counters zeroed just before: K4 and K6 must launch
     once per attention and Mamba2 layer per batch, K5 once per attention
     layer per decode step, K1 and K2 from the sizer; every logit finite and
     each batch's cache bytes the reference layout's; then K4-K6 are
     checked as in 8 at every shape the run launched; (b) the same model on
     an e4m3 cache, phase 10's 8 x 1,024 tokens and 8 decode steps fed
     its greedy tokens (run after 10), counters zeroed just before: K5 on
     e4m3 once per attention layer a step, each call held to its plain
     version on the inputs the path gave it, the logits' distance from
     phase 10's bf16-cache run printed and held to phase 10's limit;
 10. feed the same tokens to the kernel path and the plain path at full
     width in bf16 (prefill and 8 decode steps) and compare the logits;
 11. serve zamba2-7b at full width cut to 6 layer positions in fp32 on the
     card and on the CPU: equal greedy tokens, logits within a tolerance;
 12. (after every worker is joined) time K4-K6 at their most launched
     full-width shapes beside their plain
     versions, PyTorch's scaled_dot_product_attention (K4, K5) and bounds
     (K5 also on the cache cast to e4m3, beside the library call on it
     widened to bf16, and its log-sum-exp variant, beside the
     memory-efficient attention that returns one),
     with K4's achieved TFLOP/s, K5's and K6's GB/s and K6's largest
     difference from its plain version there, in bf16 and from the fp32
     kernel fed the same values (the bf16 one at most twice the fp32).
 13. the cluster engine:
     (a) ``SizeyMethod`` and (b) ``sizey_temporal`` on
     ``simulate_cluster`` (methylseq at scales 0.35 and 1.0 on 8 nodes,
     Poisson root arrivals, (b) with node crashes), the counters zeroed
     before each: wastage and failures within twice the reference's
     spread, K1 and K2 once per predictor dispatch, K3 once per boundary
     fit, predict dispatches at most waves x pools and fewer than phase
     4's (held once 4 is joined), RESIZE waves counted; (c) (in a worker
     process beside the
     others) a journaled peak run with node crashes, bitwise its
     unjournaled twin, killed at 4 seeded bytes of its journal before its
     last model-sized wave, repaired and resumed, each resumed run bitwise
     the uninterrupted one and deciding with the models again; (d) both
     paths on the engine at 0.05 on the
     card and on the CPU, with equal integer choices, waves, events and
     dispatches; every K1, K2 and K3 shape launched that 3-5 did not
     check is checked as in 3, and K1 and K2 are timed at them.
 14. the risk-priced path: (a) ``SizeyMethod(risk=True,
     failure_strategy="auto", quality=True)`` and (b)
     ``sizey_risk_temporal`` (auto) on phase 13's traffic with node
     crashes, counters zeroed before each: K1 and K2 once per dispatch, K3
     once per boundary fit, predict dispatches at most waves x pools, risk
     rows written and strategies other than retry_same picked, one quality
     row per task in (a), wastage and failures within twice the
     reference's spread; the risk rows, strategies, residual-log reads and
     wall printed; (c) the reference's risk chaos cell journaled under
     risk and risk_auto, killed at 4 seeded bytes, repaired and resumed,
     each resumed run bitwise the uninterrupted one with its risk and
     quality rows; (d) the multi-tenant ``SchedulerService`` with two
     tenants (methylseq, and the sample scheduler log on its own node
     table), each result bitwise its engine run outside the service, then
     a crashed service's journal found and resumed bitwise; (e) each risk
     method on the card and on the CPU at an input where the reference's
     own 1-ulp spread moves no integer choice (the chaos cell for
     sizey_risk), integer choices, strategies and row counts equal; (c)-(e)
     run in worker processes beside (a) and (b); every K1, K2 and K3 shape
     launched that no earlier phase checked is checked as in 3.
 15. (after 12) training: K4's and K6's backward (autograd Functions) held
     to their plain backward, repeats bitwise; the OOM ladder and a killed
     run's restart at e2e-100m; granite-3-2b at full width and depth sized
     by Sizey; mamba2-780m at full width and depth and zamba2-7b at full
     width cut in depth, K6's forward and backward counted; card vs CPU at
     the reduced configs; phi3.5-moe and internvl2-26b cut in depth; both
     backward kernels timed at every training shape, and the two models'
     step wall and tokens/s (beside the workers: a card shared with the
     replays).
 16. the distributed layer on a 1-device nccl mesh: the sharded train
     step bitwise the unsharded one, compressed_psum over the group
     bitwise the one-device round trip, the elastic controller unchanged;
     (b) two processes on the card, a (1, 2) gloo mesh: the reduced
     granite-3-2b and mamba2-780m steps tensor-parallel over "model"
     within the CPU tests' limits of the one-device step, then at full
     width (2 layers, bf16) without and with ``seq_shard`` (the residual
     stream each rank's half of the sequence), each rank's
     ``max_memory_allocated`` printed for both, K4's and K6's launches per
     rank the one-device step's; then the serve through
     ``launch.dryrun.serve_step`` (the cache as ``cache_specs`` lays it
     out, K5's log-sum-exp variant on each rank's slice), reduced
     granite-3-2b and zamba2-7b at the CPU tests' limits and zamba2-7b at
     full width, 3 layer positions, bf16, against one device; K5's
     variants checked at a rank's slice of the production meshes' decode.
 17. (after 15, beside 16) the dry run (``repro_torch.launch.dryrun``) in
     a process of its own: (a) phase 15's granite-3-2b and mamba2-780m
     steps traced on fake CUDA tensors over a (1, 1) fake mesh, through
     K4-K6's fake kernels, the predicted peak per card within 25 % of
     phase 15's ``max_memory_allocated`` and the traced FLOPs over the
     measured step wall printed as a share of the bf16 tensor rate; (b) in
     processes beside it, every train cell (each architecture at train_4k)
     and the reference test's decode cells (granite-3-2b, decode_32k) on
     256 and 512 fake ranks, every row ok, each train cell's peak per
     card, FLOPs and collective bytes printed beside those before the step
     became tensor-parallel (``results/dryrun_train_zero3.jsonl``),
     grok-1-314b's peak on 256 ranks more than 10 times lower, and lower
     again traced with ``--seq-shard``; (c) methylseq 0.05 serially
     through ``SizeyPredictor(fused=False)`` (the per-model loop) and the
     fused path on the card: integer choices equal, allocations within
     phase 6's tolerance, K1 and K2 once per model call of the loop.
 18. the paper's evaluation
     through the port (``repro_torch.workflow.paper``, the figures built
     by ``tools/port_paper.py``) at the reference's ``--smoke`` settings,
     scale 0.05 and ttf 1.0: the six workflows through
     ``benchmarks/run.py``'s methods, fig9's incremental run,
     fig10's alpha sweep, fig11's argmax runs and fig12's mag run at 0.3,
     in worker processes (two workflows each, fig12's run on its own);
     every figure
     held to ``tools/port_paper_reference.json`` (the numpy baselines
     equal, Sizey within twice the reference's spread), and so is each
     job's wastage, time-integrated wastage, failures and runtime (the
     incremental and argmax replays among them), K1 and K2 once per
     predictor dispatch in every Sizey run, every K1/K2 shape launched
     that 3-5 did not check checked as in 3, fig9's milliseconds printed
     with the card's name and power limit, and the phase's wall.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and fp32 rate
# outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MAIN_SCALE = 1.0      # phase 4: the whole methylseq trace (953 tasks)
# phase 4 against the JAX reference, which this script cannot import: its
# replay of the same trace on a CPU and the spread of that replay under
# 1-ulp moves of the MLP's initial weights (tools/port_tolerance.py
# --scale 1.0: wastage 5738.82..5826.43 GB.h, 1.011e-2 relative at most;
# failures 71..73, 2 at most). At this scale one rounding difference in a
# 300-step Adam fit moves tens of integer choices, so the port is held to
# twice that spread, not to the reference's decisions.
REF_WASTAGE_GBH = 5768.136342526117
REF_FAILURES = 71
REF_WASTAGE_RTOL = 2e-2
REF_FAILURES_TOL = 4
# phase 6, card vs CPU on the peak path: the scale at which the reference's
# own replay keeps every integer choice under 1-ulp moves of the MLP's
# initial weights (tools/port_tolerance.py: none moves at 0.05; at 0.1 two
# to four move and one allocation moves by 1.5e-2, so equal integer
# choices cannot be asked of two devices there)
SMALL_SCALE = 0.05
# the same tolerances as the port-vs-reference test (tests/test_torch_slice.py):
# twice the reference's own spread at SMALL_SCALE (5.3e-3 on an
# allocation, 9.2e-5 on the wastage)
ALLOC_RTOL = 1e-2
WASTAGE_RTOL = 2e-4
K1_TOL = 1e-5         # |kernel - plain| <= K1_TOL * (1 + |plain|)

# phase 5, the temporal path against the JAX reference: its replay of the
# same trace on a CPU and that replay's boundary fits, and the spread of
# the replay under 16 1-ulp moves of the MLP's initial weights
# (tools/port_tolerance.py --method sizey_temporal --scale 1.0 --samples
# 16: time-integrated wastage 10495.04..10657.68 GB.h, 9.418e-3 relative
# at most; failures 243..250, 4 at most; 388 to 684 integer choices moved,
# no boundary). The port is held to twice that spread.
REF_TW_GBH = 10558.23942791997
REF_T_FAILURES = 246
REF_TW_RTOL = 1.9e-2
REF_T_FAILURES_TOL = 8
REF_FITS = 926
# KS+ is numpy apart from its boundary fits, which K3 computes bit for bit:
# the reference's totals exactly (the same replay of the JAX package)
REF_KSP_TW_GBH = 15197.024585115007
REF_KSP_FAILURES = 537
# phase 6, the temporal path card vs CPU at SMALL_SCALE: boundaries, every
# integer choice and failures equal, and allocations and time-integrated
# wastage within twice the reference's own spread there
# (tools/port_tolerance.py --method sizey_temporal --samples 16 --apart
# methylation_extract: allocations 1.255e-3 outside that pool and 1.615e-1
# in it, time-integrated wastage 2.991e-4). The 3-task pool
# methylation_extract is held to twice its own spread: a 1-ulp move there
# flips the HPO learning rate and its MLP then extrapolates to five times
# its largest input (tests/test_torch_temporal.py)
T_ALLOC_RTOL = 2.6e-3
T_APART = {"methylation_extract": 3.3e-1}
T_TW_RTOL = 6e-4

# (M, T, d, h) and (Q, T, d). The main path gives K1 (1, K, 1, 32) on a
# predict of K tasks and (1, CAP, 1, 32) on an observe or refresh, and K2
# (K, CAP, 1) and (CAP, CAP, 1): the in-sample refresh queries every row of
# the pool's buffer, CAP = 128 rows, doubled to 256 by methylseq's largest
# pool at scale 1.0. The temporal path gives both d = 2 (the segment
# centre is a feature) and four rows per task, so buffers of up to 1024
# rows. Phases 4 and 5 record the shapes they launched, and any launched
# that is not listed here is checked after them.
K1_SHAPES = [(1, 1, 1, 32), (1, 7, 1, 32), (1, 128, 1, 32), (1, 256, 1, 32),
             (1, 1024, 1, 32), (3, 300, 4, 32)]
K2_SHAPES = [(1, 128, 1), (64, 128, 1), (128, 128, 1), (256, 256, 1),
             (1024, 1024, 1), (37, 300, 4), (4, 500, 2), (3, 77, 1)]
# K2 keeps its k nearest in a register list of 5 for k <= 5 (the main
# path's k = 5) and of 32 above: both are checked, at every number of warps
# a query
K2_KS = (5, 1, 8, 32)
# K3: the profile kinds, M (a young pool to PROFILE_WINDOW = 512), G (the
# main path's 32 and edges) and k in {1, 2, 4, G} it is held to, bitwise;
# the temporal path gives it (M, 32, 4) with M = 3..129 at scale 1.0
K3_KINDS = ("random", "ties", "step", "constant", "zero")
K3_MS = (1, 3, 5, 64, 128, 512)
K3_GS = (4, 32, 33)
K3_TIMED = (8, 32, 128, 512)
K3_KERNEL = "segment_dp_fit_kernel"   # its name in torch.profiler
# K3 at the edges of its plan (repro_torch.kernels.segment_dp.ops.plan),
# checked on the card only: no profile, and M = Mt - 1, Mt, Mt + 1 and
# 2 Mt + 1 at G = 32 (Mt = 101 profiles a tile); G = 169 and 170 (the last
# with the cost matrix in shared memory and the first in device scratch),
# 337 and 338 (the last with one band of start columns and the first with
# two) and 1024, at M = 1..3; every k of {1, 2, 4, G}, every profile kind
K3_EDGE_MG = ([(0, 32), (100, 32), (101, 32), (102, 32), (203, 32)]
              + [(m, g) for g in (169, 170, 337, 338, 1024)
                 for m in (1, 2, 3)])
K3_EDGES = [(m, g, k) for m, g in K3_EDGE_MG for k in sorted({1, 2, 4, g})]
# phase 7 times K1 and K2 at every shape the replays launched and at these
K1_TIMED = [(1, 1024, 1, 32)]
K2_TIMED = [(1024, 1024, 1)]
# mlp.predict_batch beside the five launches it replaces, (M, T, d, h)
PREDICT_TIMED = [(1, 1, 1, 32), (1, 128, 1, 32), (1, 4, 2, 32),
                 (1, 512, 2, 32)]

# phase 13, the cluster engine: methylseq on 8 homogeneous nodes at the
# trace's machine cap, the default backfill policy, ttf 1.0,
# with Poisson root arrivals at 30 an hour, the rate the reference's own
# cluster benchmark staggers its roots at for this reason
# (benchmarks/temporal_bench.py, "cluster + overhead"): with every root
# at t = 0 each pool's instances become ready in one wave, all sized by
# the preset before any of them completes. The port's CPU runs of (a) at
# other rates: none 0, 200 an hour (README's grid) 0, 30 an hour 333, 20
# an hour 641 of 953 decisions by the models; the faster the roots come,
# the more of each pool is ready (and sized by its preset) before the
# pool's first completion. (b) adds node crashes (README's temporal
# cluster example). (b) and phase 14 run the whole trace (scale 1.0); (a)
# runs 0.35 of it (332 tasks), so that the smoke with phase 14 stays well
# inside its time limit (1,029.0 s with (a) at 1.0 on one host; phase 4
# already replays the peak path's observes at 1.0). The reference's runs
# of these on a CPU and their spread under 16 1-ulp moves of the MLP's
# initial weights (tools/port_tolerance.py --cluster 8 --scale 0.35
# --arrival-rate 30 --samples 16, and with --scale 1.0 --method
# sizey_temporal --fail-rate 0.01 --fail-seed 7): (a) wastage
# 32352.21..32379.61 GB.h, 8.444e-4 relative at most, failures 20..21;
# (b) time-integrated wastage 76832.84..79759.64 GB.h, 2.987e-2 at most,
# failures 142..165. On the engine one moved OOM kill moves the schedule
# of every later task, so the spread is wider than the serial replay's;
# the port is held to twice it here, and to the CPU's integer choices in
# (d)
CLUSTER_A_SCALE = 0.35
CLUSTER_SCALE = 1.0
CLUSTER_NODES = 8
CLUSTER_ARRIVALS = 30.0
CLUSTER_FAILS = {"fail_rate_per_node_h": 0.01, "fail_seed": 7}
REF_C_WASTAGE_GBH = 32379.55217153149
REF_C_FAILURES = 21
REF_C_WASTAGE_RTOL = 1.69e-3
REF_C_FAILURES_TOL = 2
REF_CT_TW_GBH = 77446.03849425906
REF_CT_FAILURES = 157
REF_CT_TW_RTOL = 5.98e-2
REF_CT_FAILURES_TOL = 30
# (c): a journaled peak run at methylseq 0.1 on 4 nodes with node crashes
# and stragglers (as tests/test_torch_durability.py) and roots an hour
# apart, so that model-sized waves run from the first tenth of its journal
# to the last (52 model decisions in 37 predicts on a CPU); killed at 4
# seeded bytes between its first tenth and its last model-sized wave, so
# that each resumed run decides with the models again
DUR_SCALE = 0.1
DUR_ARRIVALS = 1.0
DUR_ENGINE = {"n_nodes": 4, "fail_rate_per_node_h": 0.2, "fail_seed": 7,
              "straggler_rate": 0.1}
DUR_SNAPSHOT = 8
DUR_KILLS = 4
DUR_SEED = 11
# (d): card vs CPU on the engine at SMALL_SCALE, 4 nodes, 5 root arrivals
# an hour (the temporal path with crashes at 0.2 a node-hour, seed 7), as
# tests/test_torch_cluster.py holds the port to the reference there
PARITY_ENGINE = {"n_nodes": 4, "arrival_rate_per_h": 5.0}
T_PARITY_FAILS = {"fail_rate_per_node_h": 0.2, "fail_seed": 7}
ENGINE_INT_FIELDS = ("n_waves", "n_size_calls", "n_node_failures",
                     "n_resizes", "n_resize_waves", "n_grow_failures",
                     "n_preemptions")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _fail(msg: str) -> None:
    raise AssertionError(msg)


# ----------------------------------------------------------- phase 2
def build_kernels():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    times = _build.build()
    wall = time.perf_counter() - t0
    print(f"[build] {wall:.2f} s wall; per kernel "
          + ", ".join(f"{k}={v:.2f}s" for k, v in times.items()))
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")
    # K4's bf16 path must run on Hopper's warpgroup products and K6's on
    # the tensor cores, both fed by TMA: count the instructions in the
    # built libraries' machine code
    sass = {}
    for name, mma, what in (("flash_attention", "HGMMA", "wgmma"),
                            ("ssd_scan", "HMMA", "mma.sync")):
        sass[name] = subprocess.run(
            [str(pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"),
             "-sass", str(_build.lib_path(name))], capture_output=True,
            text=True, timeout=120).stdout
        counts = {op: sass[name].count(op)
                  for op in (mma, "UTMALDG", "SYNCS")}
        print(f"[build] {name} SASS: {counts[mma]} {mma} ({what}), "
              f"{counts['UTMALDG']} UTMALDG (TMA loads), {counts['SYNCS']} "
              f"SYNCS (mbarrier) instructions")
        if not counts[mma] or not counts["UTMALDG"]:
            _fail(f"{name}'s library issues no {what} or no TMA load")
    check_backward_route(sass, _build)


# The bf16 backward kernels that run products, each of which must issue
# tensor-core instructions in its own machine code; the elementwise K6
# kernels (the passing, the sum over heads) are listed with their counts
BWD_MMA_KERNELS = {
    "flash_attention": ("attention_bwd_dq_mma_kernel",
                        "attention_bwd_dkdv_mma_kernel"),
    "ssd_scan": ("ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel"),
}
BWD_PLAIN_KERNELS = {"ssd_scan": ("ssd_bwd_pass_kernel",
                                  "ssd_scan_bwd_sum_kernel")}


def _by_function(text: str, head: str) -> dict:
    """Split cuobjdump's SASS (head "Function : ") or ptxas's report (head
    "Compiling entry function '") into {mangled name: its lines}."""
    out, cur = {}, None
    for line in text.splitlines():
        if head in line:
            cur = line.split(head, 1)[1].split("'")[0].strip()
            out[cur] = []
        elif cur is not None:
            out[cur].append(line)
    return out


def check_backward_route(sass: dict, build) -> None:
    """Phase 2 for the backward kernels: HMMA and HGMMA counted in each
    bf16 backward kernel function's own machine code (every template
    instance), failing if one has none; each one's registers, spills and
    dynamic shared memory (ptxas, the kernel's own plan) printed."""
    for lib_name, kernels in BWD_MMA_KERNELS.items():
        funcs = _by_function(sass[lib_name], "Function : ")
        ptx = _by_function(build.BUILD_LOG.get(lib_name, ""),
                           "Compiling entry function '")
        for kern in kernels + BWD_PLAIN_KERNELS.get(lib_name, ()):
            found = {f: body for f, body in funcs.items() if kern in f}
            if not found:
                _fail(f"{kern}: no such function in {lib_name}'s SASS")
            mma = sorted(sum(ln.count("HMMA") + ln.count("HGMMA")
                             for ln in body) for body in found.values())
            print(f"[build] {kern}: {len(found)} instance(s), HMMA + HGMMA "
                  f"per instance {mma[0]}..{mma[-1]}")
            if kern in kernels and mma[0] == 0:
                _fail(f"{kern}: a bf16 backward kernel with no tensor-core "
                      f"instruction")
            for f, lines in sorted(ptx.items()):
                if kern not in f:
                    continue
                regs = [ln.split(":", 1)[1].strip() for ln in lines
                        if "Used" in ln and "registers" in ln]
                spill = [ln.strip() for ln in lines if "spill" in ln]
                print(f"[build]   {f}: {regs[0] if regs else '?'}; "
                      f"{spill[0] if spill else '?'}")
    lib = build.load("flash_attention")
    fn = lib.flash_attention_bwd_smem
    print("[build] K4 bf16 backward dynamic shared memory (bytes), dQ / "
          "dK-dV at D = 16..128: " + ", ".join(
              f"{16 * nk}: {fn(16 * nk, 0)}/{fn(16 * nk, 1)}"
              for nk in range(1, 9)))
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_bwd_smem
    print("[build] K6 bf16 backward dynamic shared memory (bytes), state / "
          "chunk kernel at N <= 64 and N <= 128: "
          f"{fn(64, 0)}/{fn(64, 1)} and {fn(128, 0)}/{fn(128, 1)}")


# ----------------------------------------------------------- phase 3
def _k1_inputs(m, t, d, h, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    return (f(m, t, d), f(m, d, h, sc=0.5), f(m, h, sc=0.1),
            f(m, h, 1, sc=0.5), f(m, 1, sc=0.1))


def _mlp_predict_inputs(t, d, h, seed, dev):
    """One model's features, weights and normalisation statistics, as
    ``mlp.predict_batch`` hands them to the fused entry: x (T, d), w1 (d,
    h), b1 (h,), w2 (h, 1), b2 (1,), mu_x, sd_x (d,), mu_y, sd_y ()."""
    import numpy as np
    import torch
    x, w1, b1, w2, b2 = _k1_inputs(1, t, d, h, seed, dev)
    rng = np.random.default_rng(seed + 1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (x[0] * 5.0 + 20.0, w1[0], b1[0], w2[0], b2[0],
            f(rng.uniform(10.0, 30.0, d)), f(rng.uniform(1.0, 8.0, d)),
            f(rng.uniform(1.0, 50.0)), f(rng.uniform(0.5, 20.0)))


def _composed_predict(x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y):
    """The MLP model's predict as five launches: the eager normalisation,
    ``ensemble_mlp_forward`` and the eager de-normalisation."""
    from repro_torch.kernels.ensemble_mlp.ops import ensemble_mlp_forward
    xn = ((x - mu_x) / sd_x).contiguous()
    yn = ensemble_mlp_forward(xn[None], w1[None], b1[None], w2[None],
                              b2[None])[0]
    return yn * sd_y + mu_y


def _k2_inputs(q, t, d, seed, dev, ties: bool):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if ties:   # integer-valued features: many equal distances
        qs = rng.integers(0, 6, (q, d)).astype(np.float32)
        hist = rng.integers(0, 6, (t, d)).astype(np.float32)
    else:
        qs = rng.standard_normal((q, d)).astype(np.float32)
        hist = rng.standard_normal((t, d)).astype(np.float32)
    ys = (rng.standard_normal(t) * 10).astype(np.float32)
    mask = np.ones(t, np.float32)
    mask[int(t * 0.7):] = 0.0          # masked tail, as a history buffer
    mask[rng.random(t) < 0.1] = 0.0    # and scattered holes
    scale = rng.uniform(0.5, 2.0, d).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(qs), to(hist), to(ys), to(mask), to(scale)


def check_kernels(k1_shapes=K1_SHAPES, k2_shapes=K2_SHAPES,
                  ks=K2_KS) -> dict:
    """Every kernel against its plain version on the card: K1's forward,
    and for one model (M = 1) its fused prediction, also bitwise against
    the five launches it replaces; K2 with and without ties, at each k of
    ``ks`` and each number of warps a query, then with no valid row and
    with fewer valid rows than k. Returns the largest absolute difference
    per kernel."""
    import torch
    from repro_torch.kernels.ensemble_mlp.ops import (ensemble_mlp_forward,
                                                      mlp_predict)
    from repro_torch.kernels.ensemble_mlp.ref import (ensemble_mlp_ref,
                                                      mlp_predict_ref)
    from repro_torch.kernels.knn.ops import (SPLITS, knn_predict,
                                             pairwise_sq_dists)
    from repro_torch.kernels.knn.ref import (knn_predict_ref,
                                             pairwise_sq_dists_ref)
    dev = torch.device("cuda")
    err = {"ensemble_mlp": 0.0, "knn_predict": 0.0}

    def k1_close(got, want, what):
        torch.cuda.synchronize()
        diff = (got - want).abs()
        e = float(diff.max()) if diff.numel() else 0.0
        ok = bool((diff <= K1_TOL * (1 + want.abs())).all())
        print(f"[check] {what}: max abs err {e:.3e} (tol {K1_TOL:g} x "
              f"(1+|plain|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{what} disagrees with its plain version")
        err["ensemble_mlp"] = max(err["ensemble_mlp"], e)

    for i, (m, t, d, h) in enumerate(k1_shapes):
        args = _k1_inputs(m, t, d, h, i, dev)
        k1_close(ensemble_mlp_forward(*args), ensemble_mlp_ref(*args),
                 f"ensemble_mlp M={m} T={t} d={d} h={h}")
        if m != 1:
            continue
        args = _mlp_predict_inputs(t, d, h, i, dev)
        got = mlp_predict(*args)
        k1_close(got, mlp_predict_ref(*args),
                 f"ensemble_mlp fused predict T={t} d={d} h={h}")
        if not torch.equal(got, _composed_predict(*args)):
            _fail(f"the fused predict at T={t} d={d} rounds otherwise "
                  f"than the five launches it replaces")
    if any(m == 1 for m, *_ in k1_shapes):
        print("[check] ensemble_mlp fused predict: bitwise equal to the "
              "eager normalisation, ensemble_mlp_forward and the eager "
              "de-normalisation on the card at these shapes")

    def k2_equal(qs, hist, ys, mask, scale, k, what):
        want = knn_predict_ref(qs, hist, ys, mask, scale, k)
        for s in SPLITS:
            got = knn_predict(qs, hist, ys, mask, scale, k, splits=s)
            torch.cuda.synchronize()
            err["knn_predict"] = max(err["knn_predict"],
                                     float((got - want).abs().max()))
            if not torch.equal(got, want):
                _fail(f"knn_predict disagrees at {what}, k={k}, {s} warps "
                      f"a query")

    for i, (q, t, d) in enumerate(k2_shapes):
        for ties in (False, True):
            qs, hist, ys, mask, scale = _k2_inputs(q, t, d, 100 + i, dev,
                                                   ties)
            for k in ks:
                k2_equal(qs, hist, ys, mask, scale, k, (q, t, d, ties))
            print(f"[check] knn_predict Q={q} T={t} d={d} ties={ties} "
                  f"k={','.join(map(str, ks))}, {'/'.join(map(str, SPLITS))}"
                  f" warps a query: max abs err {err['knn_predict']:.3e} "
                  f"(tol: bitwise equal) ok")
            one = torch.ones_like(scale)
            got = pairwise_sq_dists(qs, hist, mask)
            want = pairwise_sq_dists_ref(qs, hist, mask)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                _fail(f"pairwise_sq_dists disagrees at {(q, t, d, ties)}")
            # with scale = 1 the fused kernel's distances are these
            k2_equal(qs, hist, ys, mask, one, 5, (q, t, d, "scale 1"))
            if ties:   # no valid row; fewer valid rows than k
                none = torch.zeros_like(mask)
                few = torch.zeros_like(mask)
                few[torch.arange(0, t, max(t // 3, 1), device=dev)[:3]] = 1.0
                for mk, what in ((none, "no valid row"),
                                 (few, "3 valid rows")):
                    for k in ks:
                        k2_equal(qs, hist, ys, mk, scale, k, (q, t, d, what))
    if k2_shapes:
        print("[check] knn_predict with no valid row and with 3 valid rows, "
              "and pairwise_sq_dists (the TPU kernel's own function): "
              "bitwise equal to their plain versions at these K2 shapes")
    return err


# ----------------------------------------------------------- phase 3, K3
def k3_profiles(kind: str, m: int, g: int, seed: int):
    """(m, g) float32 profiles of one kind, made with numpy from ``seed``
    (tests/test_torch_segment_dp.py and tests/test_torch_cuda.py use this
    maker, its kinds and its grid too)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(0.0, 10.0, (m, g)).astype(np.float32)
    if kind == "ties":          # small integers: many equal costs
        return rng.integers(0, 4, (m, g)).astype(np.float32)
    if kind == "step":          # one change point per profile
        cut = rng.integers(1, max(g, 2), m)
        lo = rng.uniform(1.0, 2.0, m)
        hi = rng.uniform(3.0, 9.0, m)
        cols = np.arange(g)[None, :]
        return np.where(cols < cut[:, None], lo[:, None],
                        hi[:, None]).astype(np.float32)
    if kind == "constant":
        return np.full((m, g), 2.5, np.float32)
    return np.zeros((m, g), np.float32)


def check_segment_dp(shapes=None) -> float:
    """K3 against its plain version on the card, bit for bit: the cut
    indices of ``fit_cuts`` and the whole (G+1)^2 cost matrix of
    ``segment_cost``, both also against the reference's numpy oracle
    (copied in ``ref.py``). ``shapes`` are (M, G, k); by default the listed
    ones. Every profile kind is checked at each. Returns the largest
    absolute difference of a finite cost entry (0.0: bitwise)."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_dp.ops import fit_cuts, segment_cost
    from repro_torch.kernels.segment_dp.ref import (cost_matrix_plain,
                                                    cost_matrix_ref,
                                                    fit_cuts_plain,
                                                    fit_cuts_ref)
    dev = torch.device("cuda")
    if shapes is None:
        shapes = [(m, g, k) for m in K3_MS for g in K3_GS
                  for k in sorted({1, 2, 4, g})]
    by_mg: dict = {}
    for m, g, k in shapes:
        by_mg.setdefault((m, g), set()).add(k)
    err, fits = 0.0, 0
    for (m, g), ks in sorted(by_mg.items()):
        for kind in K3_KINDS:
            P = k3_profiles(kind, m, g, seed=m * 100 + g)
            tP = torch.from_numpy(P).to(dev)
            cost, plain = segment_cost(tP), cost_matrix_plain(tP)
            torch.cuda.synchronize()
            fin = torch.isfinite(plain)
            if not torch.equal(torch.isfinite(cost), fin):
                _fail(f"segment_cost: inf pattern differs at {kind} M={m} "
                      f"G={g}")
            err = max(err, float((cost - plain)[fin].abs().max()))
            if not (torch.equal(cost, plain) and np.array_equal(
                    cost.cpu().numpy(), cost_matrix_ref(P))):
                _fail(f"segment_cost disagrees at {kind} M={m} G={g}")
            for k in sorted(ks):
                got, want = fit_cuts(tP, k), fit_cuts_plain(tP, k)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and np.array_equal(
                        got.cpu().numpy(), fit_cuts_ref(P, k))):
                    _fail(f"segment_dp disagrees at {kind} M={m} G={g} "
                          f"k={k}: {got.tolist()} vs {want.tolist()}")
                fits += 1
    print(f"[check] segment_dp: {len(by_mg)} (M, G) x {len(K3_KINDS)} "
          f"profile kinds ({', '.join(K3_KINDS)}), {fits} fits, M in "
          f"{sorted({m for m, _ in by_mg})}, G in "
          f"{sorted({g for _, g in by_mg})}: cut indices and cost matrices "
          f"bitwise equal to the plain version and the reference oracle "
          f"(max abs err {err:.3e}; tol: equal) ok")
    return err


# ----------------------------------------------------------- phase 4-6
def _replay(scale: float, device: str, name: str = "sizey", on_method=None,
            engine: dict | None = None):
    """Replay methylseq through ``make_method(name, device=device)``; the
    decisions come back one per segment on the temporal path, each with
    its boundaries ((1.0,) on the peak path). ``on_method`` may wrap more
    of the method before the replay. With ``engine`` (the trace's
    ``arrival_rate_per_h`` and ``simulate_cluster``'s options) the replay
    runs on the cluster engine, and every decision comes from a ready
    wave's batched predict."""
    import numpy as np
    from repro_torch.baselines import make_method
    from repro_torch.workflow import (generate_workflow, simulate,
                                      simulate_cluster)
    method = make_method(name, device=device)
    decisions = []
    if name == "sizey_temporal":
        predict_batch = method.predictor.predict_batch

        def recording(tasks):
            out = predict_batch(tasks)
            decisions.extend((s, d.boundaries) for d in out
                             for s in d.seg_decisions)
            return out

        method.predictor.predict_batch = recording
    elif name != "ks_plus":
        attr = "predict" if engine is None else "predict_batch"
        predict = getattr(method.predictor, attr)

        def recording(*a, **k):
            out = predict(*a, **k)
            decisions.extend((d, (1.0,)) for d in (
                [out] if engine is None else out))
            return out

        setattr(method.predictor, attr, recording)
    if on_method is not None:
        on_method(method)
    t0 = time.perf_counter()
    if engine is None:
        trace = generate_workflow("methylseq", scale=scale)
        res = simulate(trace, method)
    else:
        kw = dict(engine)
        trace = generate_workflow(
            "methylseq", scale=scale,
            arrival_rate_per_h=kw.pop("arrival_rate_per_h"))
        res = simulate_cluster(trace, method, **kw)
    wall = time.perf_counter() - t0
    if len(res.outcomes) != len(trace.tasks):
        _fail("replay lost tasks")
    allocs = np.asarray([d.allocation_gb for d, _b in decisions])
    if not (np.all(np.isfinite(allocs)) and np.all(allocs > 0)
            and np.isfinite(res.temporal_wastage_gbh)):
        _fail("replay produced non-finite or non-positive allocations")
    return res, decisions, wall, method


def _recording_shapes():
    """Wrap the kernels' callers to count the shapes they pass: K1 as
    (M, T, d, h), K2 as (Q, T, d), K3 as (M, G, k). The wrappers' own
    counters are left to count the launches."""
    from collections import Counter

    from repro_torch.core.models import knn, mlp
    from repro_torch.core.temporal import segments
    shapes = {"ensemble_mlp": Counter(), "knn_predict": Counter(),
              "segment_dp": Counter()}
    k1, k2, k3 = mlp.mlp_predict, knn.knn_predict, segments.fit_cuts

    def rec_k1(x, w1, *a):
        shapes["ensemble_mlp"][(1, *x.shape, w1.shape[1])] += 1
        return k1(x, w1, *a)

    def rec_k2(queries, hist, *a):
        shapes["knn_predict"][(*queries.shape[:1], *hist.shape)] += 1
        return k2(queries, hist, *a)

    def rec_k3(P, k):
        shapes["segment_dp"][(*P.shape, k)] += 1
        return k3(P, k)

    mlp.mlp_predict, knn.knn_predict = rec_k1, rec_k2
    segments.fit_cuts = rec_k3

    def restore():
        mlp.mlp_predict, knn.knn_predict = k1, k2
        segments.fit_cuts = k3
    return shapes, restore


def _drive(label: str, scale: float, name: str, on_method=None):
    """One replay on the card with every launch counter zeroed just before
    and read just after; returns the result, decisions, wall, method,
    launches, predictor dispatches and kernel shapes of that run."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    before = dict(P.DISPATCH_COUNTS)
    shapes, restore = _recording_shapes()
    reset_launch_counts()
    try:
        res, decs, wall, method = _replay(scale, "cuda", name, on_method)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(KERNEL_LAUNCHES)
    disp = {k: P.DISPATCH_COUNTS[k] - before.get(k, 0)
            for k in ("predict_pool", "observe_pool", "refresh_pool")}
    n = len(res.outcomes)
    print(f"[{label}] {name} methylseq scale={scale}: tasks={n} "
          f"wastage_gbh={res.wastage_gbh!r} "
          f"temporal_wastage_gbh={res.temporal_wastage_gbh!r} "
          f"n_failures={res.n_failures} wall_s={wall:.3f} "
          f"tasks_per_s={n / wall:.3f}")
    print(f"[{label}] dispatches {disp}; kernel launches {launches}")
    for kname, counts in shapes.items():
        if counts:
            print(f"[{label}] {kname} shapes, most launched first: "
                  + ", ".join(f"{s}x{c}" for s, c in counts.most_common()))
    return res, decs, wall, method, launches, disp, shapes


def _check_sizey_launches(label, launches, disp):
    expect = sum(disp.values())
    for name in ("ensemble_mlp", "knn_predict"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was never launched on the {label} path")
        if launches[name] != expect:
            _fail(f"{name}: {launches[name]} launches on the {label} path, "
                  f"expected one per dispatch ({expect})")


def _within_spread(label, got_w, ref_w, rtol, got_f, ref_f, ftol, what):
    wrel = abs(got_w - ref_w) / ref_w
    print(f"[{label}] against the reference's replay ({what} {ref_w!r}, "
          f"n_failures {ref_f}): {what} rel diff {wrel:.3e} (tol "
          f"{rtol:g}), failures diff {got_f - ref_f} (tol {ftol})")
    if wrel > rtol or abs(got_f - ref_f) > ftol:
        _fail(f"the card's {label} replay is outside the reference's "
              f"spread")


def main_path() -> dict:
    """Phase 4: the peak path at full scale."""
    res, _decs, wall, _m, launches, disp, shapes = _drive(
        "main", MAIN_SCALE, "sizey")
    _within_spread("main", res.wastage_gbh, REF_WASTAGE_GBH,
                   REF_WASTAGE_RTOL, res.n_failures, REF_FAILURES,
                   REF_FAILURES_TOL, "wastage_gbh")
    _check_sizey_launches("peak", launches, disp)
    return {"launches": launches, "tasks": len(res.outcomes),
            "wall_s": wall, "shapes": shapes, "disp": disp}


def temporal_path() -> dict:
    """Phase 5: the temporal path at full scale. Every decision's
    boundaries are held to the reference oracle's fit over the pool's
    profiles at that point, rebuilt on the host: profiles are only
    appended (the pools stay below PROFILE_WINDOW), so the first n of the
    final list are those a decision saw."""
    import numpy as np
    from repro_torch.core.temporal.predictor import BOUNDARY_COUNTS
    from repro_torch.core.temporal.segments import (PROFILE_WINDOW,
                                                    fit_boundaries,
                                                    uniform_boundaries)
    BOUNDARY_COUNTS.clear()
    seen = []      # (pool, profiles seen, boundaries) per decision

    def snapshotting(method):
        tp = method.predictor
        predict_batch = tp.predict_batch

        def rec(tasks):
            out = predict_batch(tasks)
            for d in out:
                key = (d.task_type, d.machine)
                seen.append((key, len(tp._profiles.get(key, ())),
                             d.boundaries))
            return out

        tp.predict_batch = rec

    res, _decs, wall, method, launches, disp, shapes = _drive(
        "temporal", MAIN_SCALE, "sizey_temporal", snapshotting)
    counts = dict(BOUNDARY_COUNTS)
    tp = method.predictor
    print(f"[temporal] boundary fits {counts}; decisions {len(seen)}")
    if launches.get("segment_dp", 0) != counts.get("fit", -1):
        _fail(f"segment_dp launched {launches.get('segment_dp', 0)} times, "
              f"expected one per boundary fit ({counts.get('fit')})")
    if counts.get("fit", 0) != REF_FITS:
        _fail(f"{counts.get('fit')} boundary fits, the reference ran "
              f"{REF_FITS}")
    _check_sizey_launches("temporal", launches, disp)
    want: dict = {}
    for key, n, bounds in seen:
        profs = tp._profiles.get(key, [])
        if len(profs) >= PROFILE_WINDOW:
            _fail("a pool filled its profile window: rebuild unsound")
        if (key, n) not in want:
            want[key, n] = (uniform_boundaries(tp.k) if n < 3 else
                            fit_boundaries(np.stack(profs[:n]), tp.k,
                                           backend="numpy"))
        if bounds != want[key, n]:
            _fail(f"decision boundaries {bounds} differ from the oracle's "
                  f"{want[key, n]} for pool {key} at {n} profiles")
    print(f"[temporal] every decision's boundaries equal the reference "
          f"oracle's ({len(want)} distinct (pool, history length) pairs)")
    _within_spread("temporal", res.temporal_wastage_gbh, REF_TW_GBH,
                   REF_TW_RTOL, res.n_failures, REF_T_FAILURES,
                   REF_T_FAILURES_TOL, "temporal_wastage_gbh")
    return {"launches": launches, "tasks": len(res.outcomes),
            "wall_s": wall, "shapes": shapes}


def ks_plus_path() -> dict:
    """Phase 5, KS+: numpy apart from its boundary fits on K3, so it must
    give the reference's totals exactly."""
    res, _decs, wall, _m, launches, _disp, shapes = _drive(
        "ks_plus", MAIN_SCALE, "ks_plus")
    ok = (res.temporal_wastage_gbh == REF_KSP_TW_GBH
          and res.n_failures == REF_KSP_FAILURES)
    print(f"[ks_plus] against the reference's replay (temporal_wastage_gbh "
          f"{REF_KSP_TW_GBH!r}, n_failures {REF_KSP_FAILURES}; tol: equal) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail("KS+ on the card differs from the reference")
    if launches.get("segment_dp", 0) <= 0:
        _fail("segment_dp was never launched by KS+")
    return {"launches": launches, "wall_s": wall, "shapes": shapes}


def _engine_ints(res, disp) -> tuple:
    """What must be equal of two engine runs: each task's attempts,
    failures, interruptions and abort, the engine's event counts and the
    predictor's dispatches."""
    return ([(o.task.key, o.attempts, o.failures, o.interruptions,
              o.aborted) for o in res.outcomes],
            [getattr(res.cluster, f) for f in ENGINE_INT_FIELDS], disp)


def card_vs_cpu(name: str, alloc_rtol: float, w_rtol: float,
                apart: dict | None = None, engine: dict | None = None,
                label: str = "parity") -> None:
    """Phase 6: the port at SMALL_SCALE on the card and on the CPU, with
    every integer choice equal; ``apart`` maps a pool (task type) to its
    own allocation tolerance. With ``engine`` (phase 13 (d)) both run on
    the cluster engine, and each task's attempts and failures, the
    engine's waves and events and the predictor's dispatches must be
    equal too."""
    import numpy as np
    import torch
    from repro_torch.core import predictor as P
    runs = []
    threads = torch.get_num_threads()
    for dev in (DEV, "cpu"):
        before = dict(P.DISPATCH_COUNTS)
        if dev == "cpu":
            # thousands of tiny ops: one thread is faster
            torch.set_num_threads(1)
        try:
            res, decs, _, _ = _replay(SMALL_SCALE, dev, name, engine=engine)
        finally:
            torch.set_num_threads(threads)
        disp = {k: n - before.get(k, 0) for k, n in P.DISPATCH_COUNTS.items()}
        runs.append((res, decs, {k: n for k, n in disp.items() if n}))
    (rg, dg, pg), (rc, dc, pc) = runs
    if len(dg) != len(dc):
        _fail(f"{name}: card and CPU took different numbers of decisions")
    apart = apart or {}
    mism, worst = 0, {}
    for (a, ba), (b, bb) in zip(dg, dc):
        if a.source != b.source or ba != bb:
            _fail(f"{name}: card and CPU disagree on preset vs model or on "
                  f"boundaries")
        if a.source == "model":
            if (a.offset_idx != b.offset_idx
                    or int(np.argmax(a.raq)) != int(np.argmax(b.raq))):
                mism += 1
            pool = a.task_type if a.task_type in apart else None
            worst[pool] = max(worst.get(pool, 0.0), abs(
                a.allocation_gb - b.allocation_gb) / abs(b.allocation_gb))
    w = "temporal_wastage_gbh" if name == "sizey_temporal" else "wastage_gbh"
    wrel = abs(getattr(rg, w) - getattr(rc, w)) / abs(getattr(rc, w))
    tols = {None: alloc_rtol, **apart}
    allocs = "; ".join(
        f"max alloc rel diff{'' if p is None else ' in ' + p} "
        f"{worst.get(p, 0.0):.3e} (tol {t:g})" for p, t in tols.items())
    where = "" if engine is None else f" on the engine {engine}"
    print(f"[{label}] {name} methylseq scale={SMALL_SCALE}{where}: "
          f"{len(dg)} decisions, boundaries equal; integer mismatches "
          f"{mism} (tol 0); {allocs}; failures card={rg.n_failures} "
          f"cpu={rc.n_failures}; {w} rel diff {wrel:.3e} (tol {w_rtol:g})")
    if mism or rg.n_failures != rc.n_failures:
        _fail(f"{name}: card and CPU disagree on integer choices")
    if engine is not None:
        same = _engine_ints(rg, pg) == _engine_ints(rc, pc)
        print(f"[{label}] {name} on the engine: attempts, failures, "
              f"interruptions and aborts a task, waves {rg.cluster.n_waves}"
              f", sizing calls, node failures, resizes and dispatches "
              f"{pg} {'equal' if same else 'DIFFER'} on card and CPU")
        if not same:
            _fail(f"{name}: card and CPU disagree on the engine's waves, "
                  f"events or dispatches")
    if any(worst.get(p, 0.0) > t for p, t in tols.items()) or wrel > w_rtol:
        _fail(f"{name}: card and CPU disagree beyond the stated tolerance")


def peak_phases() -> dict:
    """Phases 4 and 6 of the peak path, in a worker from the build on:
    the replay at MAIN_SCALE, then card vs CPU at SMALL_SCALE."""
    main = main_path()
    card_vs_cpu("sizey", ALLOC_RTOL, WASTAGE_RTOL)
    return {"main": {**main, "shapes": _shapes_json(main["shapes"])}}


def temporal_phases() -> dict:
    """Phases 5 and 6 of the temporal path and KS+, in a worker from the
    build on."""
    temporal = temporal_path()
    ks_plus = ks_plus_path()
    card_vs_cpu("sizey_temporal", T_ALLOC_RTOL, T_TW_RTOL, T_APART)
    return {name: {**run, "shapes": _shapes_json(run["shapes"])}
            for name, run in (("temporal", temporal), ("ks_plus", ks_plus))}


# ----------------------------------------------------------- phase 7
def _time_ms(fn, reps: int = 60, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call."""
    import statistics
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _device_ms(fn, match=None, n: int = 50):
    """Device time per call from torch.profiler: the kernels (and copies)
    that ``n`` calls of ``fn`` ran on the card, only those whose name
    holds ``match`` where given; None when the profiler shows no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and (match is None or match in e.name))
    return total / n / 1e3 if total > 0 else None


def _host_ms(fn, n: int = 300) -> float:
    """Host time per call: ``time.perf_counter`` over ``n`` calls issued
    without a synchronise, so what the host spends to issue one call."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / n


def _fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f} ms"


def _bound(nbytes: int, flops: int):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the fp32 operations over the fp32 rate."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / FP32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _k1_bound(m, t, d, h, norm: bool = False):
    # each input read once, the output written once; per row: the d-long
    # dot, the bias, tanh and the multiply-add into the output, per unit;
    # with ``norm`` (the fused predict) also the four statistics, and per
    # row a subtract and a divide per feature and the output's multiply-add
    nbytes = 4 * (m * t * d + m * d * h + 2 * m * h + m + m * t)
    flops = m * t * h * (2 * d + 4)
    if norm:
        nbytes += 4 * (2 * d + 2)
        flops += m * t * (2 * d + 2)
    return _bound(nbytes, flops)


def _k2_bound(q, t, d, n_valid):
    # per (query, valid row): subtract, divide, multiply-add per feature and
    # one comparison against the k-th best (masked rows are skipped)
    return _bound(4 * (q * d + t * d + 2 * t + d + q),
                  q * n_valid * (3 * d + 1))


def _k3_bound(m, g, k):
    # the profiles read once and the k cuts written once; per (m, i, j > i)
    # one running-max and one running-sum step and the cost's multiply,
    # subtract and add. The DP needs only the finite candidates: step 1 is
    # row 0 of the cost (no operation); step s in 2..k-1 has, for each
    # j >= s, the j - s + 1 candidates i in [s-1, j) (an add each and one
    # compare fewer), (G-s+1)^2 operations in all; step k needs only j = G
    dp = sum((g - s + 1) ** 2 for s in range(2, k)) \
        + (2 * (g - k + 1) - 1 if k >= 2 else 0)
    return _bound(4 * m * g + 8 * k, 5 * m * g * (g + 1) // 2 + dp)


def time_segment_dp(ms, g: int = 32, k: int = 4, quick: bool = False
                    ) -> dict:
    """K3 and its plain version at (M, G, k) for each M of ``ms``: the loop
    time a call, the kernel's device time (torch.profiler) and the host's
    time to issue a call, beside the bound; with ``quick``, fewer windows
    and no line printed per M. No single PyTorch call computes this
    function, so no library yardstick."""
    import torch
    from repro_torch.kernels.segment_dp.ops import fit_cuts
    from repro_torch.kernels.segment_dp.ref import fit_cuts_plain
    dev = torch.device("cuda")
    # ~M + G eager launches a plain call: fewer windows for it
    reps, plain_reps, host_n, dev_n = (((10, 5), (3, 2), 100, 10) if quick
                                       else ((60, 10), (15, 3), 300, 50))
    rows = {}
    for m in ms:
        P = torch.from_numpy(k3_profiles("random", m, g, seed=m)).to(dev)
        bound, by = _k3_bound(m, g, k)

        def fit():
            return fit_cuts(P, k)

        rows[m] = r = {
            "ms": _time_ms(fit, *reps),
            "device_ms": _device_ms(fit, K3_KERNEL, dev_n),
            "host_ms": _host_ms(fit, host_n),
            "plain_ms": _time_ms(lambda: fit_cuts_plain(P, k), *plain_reps),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        if not quick:
            print(_row_line(f"segment_dp (M,G,k)={(m, g, k)}", r))
    return rows


def segment_dp_row(launched) -> dict:
    """K3's JSON row: the kernel's, the plain version's and the bound's
    time at every (M, 32, 4) the temporal path launched, averaged with the
    launches at each as weights, so that it stands for one fit of that
    path (the launches are spread flat over M = 3 to 129); the device and
    host times a call are averaged the same way and printed."""
    from collections import Counter
    times = time_segment_dp(sorted({m for m, _g, _k in launched}),
                            quick=True)
    n = sum(launched.values())
    keys = ("ms", "plain_ms", "bound_ms", "host_ms") + (
        ("device_ms",) if all(t["device_ms"] is not None
                              for t in times.values()) else ())
    mean = {key: sum(c * times[m][key] for (m, _g, _k), c in launched.items())
            / n for key in keys}
    by = Counter()
    for (m, _g, _k), c in launched.items():
        by[times[m]["bound_by"]] += c
    row = {key: mean[key] for key in ("ms", "plain_ms", "bound_ms")}
    row.update(bound_by=by.most_common(1)[0][0], library_ms=None)
    print(f"[time] segment_dp JSON row, the launch-weighted mean over the "
          f"{len(times)} shapes (M, 32, 4) of the temporal path's {n} "
          f"launches: loop {row['ms']:.5f} ms, device "
          f"{_fmt_ms(mean.get('device_ms'))}, host {mean['host_ms']:.5f} ms, "
          f"plain {row['plain_ms']:.5f} ms, library none, bound "
          f"{row['bound_ms']:.3e} ms ({row['bound_by']})")
    return row


def _row_line(what, r):
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.5f} ms")
    return (f"[time] {what}: loop {r['ms']:.5f} ms, device "
            f"{_fmt_ms(r['device_ms'])}, host {r['host_ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {lib}, "
            f"bound {r['bound_ms']:.3e} ms ({r['bound_by']})")


def time_k1(shapes) -> dict:
    """K1 as the main path launches it, the fused predict of one model, at
    each (1, T, d, h) of ``shapes``: the loop time per call (CUDA events
    over back-to-back calls), the kernel's device time (torch.profiler),
    the host's time to issue a call (no synchronise), the plain version,
    the library yardstick (addmm and tanh with the eager normalisation)
    and the bound."""
    import torch
    from repro_torch.kernels.ensemble_mlp.ops import mlp_predict
    from repro_torch.kernels.ensemble_mlp.ref import mlp_predict_ref
    dev = torch.device("cuda")
    rows = {}
    for shape in shapes:
        _m, t, d, h = shape
        args = _mlp_predict_inputs(t, d, h, 7, dev)
        x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y = args

        def library():
            xn = (x - mu_x) / sd_x
            hid = torch.addmm(b1, xn, w1).tanh_()
            return torch.addmm(b2, hid, w2)[:, 0].mul_(sd_y).add_(mu_y)

        def kernel():
            return mlp_predict(*args)

        bound, by = _k1_bound(1, t, d, h, norm=True)
        rows[shape] = r = {
            "ms": _time_ms(kernel),
            "device_ms": _device_ms(kernel, "ensemble_mlp_kernel"),
            "host_ms": _host_ms(kernel),
            "plain_ms": _time_ms(lambda: mlp_predict_ref(*args)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _time_ms(library)}
        print(_row_line(f"ensemble_mlp fused predict (M,T,d,h)={shape}",
                           r))
    return rows


def time_k2(shapes) -> dict:
    """K2 (k = 5) at each (Q, T, d) of ``shapes``, with the same columns as
    :func:`time_k1` (library: cdist and topk)."""
    import torch
    from repro_torch.kernels.knn.ops import knn_predict, plan_splits
    from repro_torch.kernels.knn.ref import knn_predict_ref
    dev = torch.device("cuda")
    rows = {}
    for shape in shapes:
        q, t, d = shape
        qs, hist, ys, mask, scale = _k2_inputs(q, t, d, 11, dev, False)
        n_valid = int((mask > 0).sum())

        def library():
            d2 = torch.cdist(qs / scale, hist / scale)
            d2 = d2.masked_fill(mask[None, :] <= 0, float("inf"))
            _v, idx = torch.topk(d2, 5, largest=False)
            return ys[idx].mean(-1)

        def kernel():
            return knn_predict(qs, hist, ys, mask, scale, 5)

        bound, by = _k2_bound(q, t, d, n_valid)
        rows[shape] = r = {
            "ms": _time_ms(kernel),
            "device_ms": _device_ms(kernel, "knn_predict_kernel"),
            "host_ms": _host_ms(kernel),
            "plain_ms": _time_ms(lambda: knn_predict_ref(qs, hist, ys, mask,
                                                         scale, 5)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _time_ms(library)}
        print(_row_line(f"knn_predict (Q,T,d)={shape} k=5, "
                           f"{plan_splits(q, t)} warps a query", r))
    return rows


def time_k2_splits(shapes) -> None:
    """K2's device time at each (Q, T, d) of ``shapes`` and each number of
    warps a query (what ``plan_splits`` is set from)."""
    import torch
    from repro_torch.kernels.knn.ops import SPLITS, knn_predict
    for shape in shapes:
        qs, hist, ys, mask, scale = _k2_inputs(*shape, 11,
                                               torch.device("cuda"), False)
        dev_s = {s: _device_ms(lambda s=s: knn_predict(
            qs, hist, ys, mask, scale, 5, splits=s), "knn_predict_kernel")
            for s in SPLITS}
        print(f"[time] knn_predict (Q,T,d)={shape} device time by warps a "
              f"query: " + ", ".join(f"{s}: {_fmt_ms(v)}"
                                     for s, v in dev_s.items()))


def time_mlp_predict(shapes) -> None:
    """``mlp.predict_batch`` as a whole (one launch of the fused predict)
    beside the five launches it replaces (the eager normalisation,
    ``ensemble_mlp_forward``, the eager de-normalisation), in turns, at
    each (1, T, d, h) of ``shapes``: the loop time, the device time of all
    their kernels and the host's time to issue a call."""
    import torch
    from repro_torch.core.models import mlp
    dev = torch.device("cuda")
    for shape in shapes:
        _m, t, d, h = shape
        args = _mlp_predict_inputs(t, d, h, 7, dev)
        x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y = args
        state = mlp.MLPState(w1, b1, w2, b2, (), (), None, mu_x, sd_x, mu_y,
                             sd_y, None)
        fns = {"predict_batch": lambda: mlp.predict_batch(state, x),
               "composed": lambda: _composed_predict(*args)}
        res = {k: {"ms": [], "device_ms": [], "host_ms": []} for k in fns}
        for k in ("predict_batch", "composed", "composed", "predict_batch"):
            res[k]["ms"].append(_time_ms(fns[k]))
            res[k]["device_ms"].append(_device_ms(fns[k]))
            res[k]["host_ms"].append(_host_ms(fns[k]))
        mean = {k: {c: (None if None in v else sum(v) / len(v))
                    for c, v in r.items()} for k, r in res.items()}
        f, c = mean["predict_batch"], mean["composed"]
        print(f"[time] mlp.predict_batch (M,T,d,h)={shape}: fused (1 "
              f"launch) loop {f['ms']:.5f} ms, device {_fmt_ms(f['device_ms'])}"
              f", host {f['host_ms']:.5f} ms; composed (5 launches) loop "
              f"{c['ms']:.5f} ms, device {_fmt_ms(c['device_ms'])}, host "
              f"{c['host_ms']:.5f} ms; fused/composed loop "
              f"{f['ms'] / c['ms']:.3f} (mean of 2 turns each)")


def replay_totals(label: str, shapes: dict, k1: dict, k2: dict) -> None:
    """A replay's K1 and K2 time: each recorded shape's launches times its
    per-call loop and device times, summed."""
    for name, rows in (("ensemble_mlp", k1), ("knn_predict", k2)):
        counts = shapes[name]
        n = sum(counts.values())
        loop = sum(c * rows[s]["ms"] for s, c in counts.items())
        devs = [rows[s]["device_ms"] for s in counts]
        dev = None if None in devs else sum(
            c * rows[s]["device_ms"] for s, c in counts.items())
        print(f"[time] {label} replay {name}: {n} launches over "
              f"{len(counts)} shapes, launch-weighted total loop "
              f"{loop:.3f} ms, device {_fmt_ms(dev)}")


# ----------------------------------------------------------- phase 13
def _sim_equal(a, b, allow=()) -> bool:
    """Two SimResults bitwise equal: every outcome field and every cluster
    metric but those in ``allow``."""
    import dataclasses
    if len(a.outcomes) != len(b.outcomes) or a.method != b.method:
        return False
    for x, y in zip(a.outcomes, b.outcomes):
        if dataclasses.asdict(x) != dataclasses.asdict(y):
            return False
    ca, cb = dataclasses.asdict(a.cluster), dataclasses.asdict(b.cluster)
    return all(ca[k] == cb[k] for k in ca if k not in allow)


def _record_sources(method, sources: list, waves=None,
                    at=lambda: None) -> None:
    """Wrap ``method``'s batched predict to append each decision's source
    to ``sources`` and, for each predict with a model decision, its count
    of tasks and ``at()`` to ``waves``."""
    predict_batch = method.predictor.predict_batch

    def recording(tasks):
        out = predict_batch(tasks)
        sources.extend(d.source for d in out)
        if waves is not None and any(d.source == "model" for d in out):
            waves.append((len(tasks), at()))
        return out

    method.predictor.predict_batch = recording


def _cluster_drive(label: str, name: str, scale: float, arrivals, engine,
                   journal_path=None, method=None):
    """One ``simulate_cluster`` run of methylseq on the card (``name``
    through ``make_method``, a journaled Sizey method writing
    ``journal_path``, or the given ``method``), with every launch counter
    zeroed just before and read just after; returns the result, wall,
    launches, predictor dispatches, boundary fits and kernel shapes, and
    prints the share of decisions the models took and the model-sized
    waves by their tasks. A journaled run also returns the journal's
    length at each model-sized wave (``model_at``)."""
    import os
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.baselines import SizeyMethod, make_method
    from repro_torch.core import predictor as P
    from repro_torch.core.temporal.predictor import BOUNDARY_COUNTS
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.workflow import generate_workflow
    from repro_torch.workflow.cluster import ClusterEngine
    from repro_torch.workflow.journal import Journal
    trace = generate_workflow("methylseq", scale=scale,
                              arrival_rate_per_h=arrivals)
    if method is not None:
        journal = None
    elif journal_path is None:
        method, journal = make_method(name, device=DEV), None
    else:
        method = SizeyMethod(persist_path=journal_path, device=DEV)
        journal = Journal.attach(method, snapshot_every=DUR_SNAPSHOT)
    sized, waves = [], []
    _record_sources(method, sized, waves, lambda: (
        None if journal_path is None else os.path.getsize(journal_path)))
    before = dict(P.DISPATCH_COUNTS)
    shapes, restore = _recording_shapes()
    BOUNDARY_COUNTS.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = ClusterEngine(trace, method, node_cap_gb=trace.machine_cap_gb,
                            journal=journal, **engine).run()
        if DEV != "cpu":
            torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    disp = {k: P.DISPATCH_COUNTS[k] - before.get(k, 0)
            for k in ("predict_pool", "observe_pool", "refresh_pool")}
    fits = dict(BOUNDARY_COUNTS).get("fit", 0)
    if len(res.outcomes) != len(trace.tasks):
        _fail(f"{label}: the engine lost tasks")
    w = res.temporal_wastage_gbh
    if not (np.isfinite(res.wastage_gbh) and np.isfinite(w) and w > 0):
        _fail(f"{label}: non-finite or non-positive wastage")
    c = res.cluster
    n = len(res.outcomes)
    print(f"[{label}] {name} methylseq scale={scale} on {c.n_nodes} nodes "
          f"of {c.node_cap_gb:g} GB ({c.policy}, root arrivals "
          f"{arrivals}/h): tasks={n} wastage_gbh={res.wastage_gbh!r} "
          f"temporal_wastage_gbh={w!r} n_failures={res.n_failures} "
          f"wall_s={wall:.3f} tasks_per_s={n / wall:.3f} "
          f"makespan_h={c.makespan_h!r} waves={c.n_waves} "
          f"n_size_calls={c.n_size_calls} resizes={c.n_resizes} "
          f"resize_waves={c.n_resize_waves} node_failures="
          f"{c.n_node_failures}")
    print(f"[{label}] model decisions {sized.count('model')} of "
          f"{len(sized)} ({sized.count('model') / max(len(sized), 1):.3f});"
          f" model-sized waves by their tasks: "
          + ", ".join(f"{q}: {k}" for q, k in sorted(
              Counter(q for q, _at in waves).items())))
    print(f"[{label}] dispatches {disp}; boundary fits {fits}; kernel "
          f"launches {launches}")
    for kname, counts in shapes.items():
        if counts:
            print(f"[{label}] {kname} shapes, most launched first: "
                  + ", ".join(f"{s}x{c}" for s, c in counts.most_common()))
    return {"res": res, "wall_s": wall, "launches": launches, "disp": disp,
            "fits": fits, "shapes": shapes, "trace": trace,
            "model_at": [at for _q, at in waves]}


def _check_waves(label: str, run: dict, refresh: bool = False) -> None:
    """The dispatch-count bound: at most one predict dispatch per pool per
    ready wave (fewer than the serial replay's one per model-sized task is
    :func:`check_serial`'s, once phase 4 is joined). One sizing call a
    wave, and with ``refresh`` (a method that re-sizes crash-interrupted
    tasks under ``retry_scaled``) those re-sizing calls besides."""
    res, disp = run["res"], run["disp"]
    pools = len({(t.task_type, t.machine) for t in run["trace"].tasks})
    bound = res.cluster.n_waves * pools
    n = disp["predict_pool"]
    print(f"[{label}] predict dispatches {n} (bound: {res.cluster.n_waves} "
          f"waves x {pools} pools = {bound})")
    if not 0 < n <= bound:
        _fail(f"{label}: {n} predict dispatches break the bound")
    extra = res.cluster.n_size_calls - res.cluster.n_waves
    if refresh:
        print(f"[{label}] {res.cluster.n_size_calls} sizing calls: one a "
              f"wave and {extra} re-sizing crash-interrupted tasks")
    if extra < 0 or (extra and not refresh):
        _fail(f"{label}: more than one sizing call a wave")


def check_serial(waves, serial_predicts: int) -> None:
    """Each engine run's predict dispatches below the serial replay's."""
    for label, n in waves:
        print(f"[{label}] predict dispatches {n}; the serial replay of "
              f"phase 4: {serial_predicts}, "
              f"{serial_predicts / max(n, 1):.3f}x as many")
        if n >= serial_predicts:
            _fail(f"{label}: {n} predict dispatches, not fewer than the "
                  f"serial replay's {serial_predicts}")


def cluster_durability(build) -> None:
    """Phase 13 (c), in a worker process beside (a), (b) and (d): a
    journaled peak run at DUR_SCALE with node crashes, bitwise its
    unjournaled twin, killed at DUR_KILLS seeded bytes of its journal
    before its last model-sized wave, repaired and resumed, each resumed
    run bitwise the uninterrupted one and deciding with the models
    again."""
    import bisect
    import os
    import tempfile

    import numpy as np
    from repro_torch.baselines import SizeyMethod
    from repro_torch.workflow.journal import recover_run
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "run.jsonl")
        plain = _cluster_drive("cluster c", "sizey", DUR_SCALE,
                               DUR_ARRIVALS, DUR_ENGINE)
        journaled = _cluster_drive("cluster c", "sizey", DUR_SCALE,
                                   DUR_ARRIVALS, DUR_ENGINE,
                                   journal_path=path)
        base = journaled["res"]
        if not _sim_equal(plain["res"], base):
            _fail("the journaled run differs from the unjournaled one")
        if not base.cluster.n_node_failures:
            _fail("the durability run saw no node crash")
        with open(path, "rb") as f:
            data = f.read()
        ends = [i + 1 for i, ch in enumerate(data) if ch == 0x0A]
        # the kills fall between the journal's first tenth and the length
        # it had at its last model-sized wave, which each resumed run must
        # then decide again, live
        lo, hi = len(ends) // 10, max(journaled["model_at"], default=0)
        n_lo = bisect.bisect_left(ends, hi)
        if n_lo <= lo:
            _fail("no model-sized wave after the journal's first tenth")
        rng = np.random.default_rng(DUR_SEED)
        cuts = sorted({int(ends[rng.integers(lo, n_lo)])}
                      | {int(x) for x in rng.integers(ends[lo], hi,
                                                      DUR_KILLS - 1)})
        trace = journaled["trace"]
        for i, cut in enumerate(cuts):
            scratch = os.path.join(d, f"cut{i}.jsonl")
            with open(scratch, "wb") as f:
                f.write(data[:cut])
            live = []

            def method_at(p, live=live):
                m = SizeyMethod(persist_path=p, device=DEV)
                _record_sources(m, live)
                return m

            t0 = time.perf_counter()
            eng = recover_run(scratch, trace, method_at,
                              snapshot_every=DUR_SNAPSHOT)
            res = eng.run()
            ok = (_sim_equal(base, res, ("n_recoveries", "n_replayed_steps"))
                  and res.cluster.n_recoveries == 1)
            print(f"[cluster c] killed at byte {cut} of {len(data)} "
                  f"({'a line end' if cut in ends else 'mid-line'}), "
                  f"repaired and resumed warm: replayed "
                  f"{res.cluster.n_replayed_steps} steps in "
                  f"{time.perf_counter() - t0:.3f} s, then "
                  f"{live.count('model')} model decisions of {len(live)} "
                  f"live; SimResult "
                  f"{'bitwise the uninterrupted run' if ok else 'DIFFERS'}")
            if not ok:
                _fail(f"resume after a kill at byte {cut} is not bitwise "
                      f"the uninterrupted run")
            if "model" not in live:
                _fail(f"no model decision after the resume at byte {cut}")
    print(f"[cluster c] {len(cuts)} kill points resumed bitwise on {DEV} "
          f"({base.cluster.n_node_failures} node crashes and "
          f"{base.n_failures} OOM kills in the run)")


def cluster_phase() -> dict:
    """Phase 13: the cluster engine on the card. (a) the peak path at
    CLUSTER_A_SCALE and (b) the temporal path at CLUSTER_SCALE on
    CLUSTER_NODES nodes, each held to twice the reference's spread; (c) a
    journaled peak run at DUR_SCALE with node crashes, bitwise its
    unjournaled twin, killed at DUR_KILLS seeded bytes of its journal
    before its last model-sized wave, repaired and resumed, each resumed
    run bitwise the uninterrupted one and deciding with the models again;
    (d) both paths card vs CPU on the engine; (c) runs in a worker
    process (``cluster_durability``) beside the others."""
    from collections import Counter
    t_start = time.perf_counter()
    shapes = {"ensemble_mlp": Counter(), "knn_predict": Counter(),
              "segment_dp": Counter()}
    worker = _start_worker("cluster_durability")
    try:
        a, b = _cluster_ab()
        # (d) card vs CPU on the engine
        card_vs_cpu("sizey", ALLOC_RTOL, WASTAGE_RTOL, engine=PARITY_ENGINE,
                    label="cluster d")
        card_vs_cpu("sizey_temporal", T_ALLOC_RTOL, T_TW_RTOL, T_APART,
                    engine=dict(PARITY_ENGINE, **T_PARITY_FAILS),
                    label="cluster d")
        _join_worker("cluster_durability", worker, shapes, timeout=900,
                     phase=13)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    for run in (a, b):
        for k in shapes:
            shapes[k] += run["shapes"][k]
    wall = time.perf_counter() - t_start
    print(f"[cluster] phase 13 wall {wall:.1f} s")
    return {"a": a, "b": b, "shapes": shapes, "wall_s": wall}


def _cluster_ab() -> tuple:
    """Phase 13 (a) and (b)."""
    engine = {"n_nodes": CLUSTER_NODES, "policy": "backfill"}
    a = _cluster_drive("cluster a", "sizey", CLUSTER_A_SCALE,
                       CLUSTER_ARRIVALS, engine)
    _within_spread("cluster a", a["res"].wastage_gbh, REF_C_WASTAGE_GBH,
                   REF_C_WASTAGE_RTOL, a["res"].n_failures, REF_C_FAILURES,
                   REF_C_FAILURES_TOL, "wastage_gbh")
    _check_sizey_launches("cluster peak", a["launches"], a["disp"])
    _check_waves("cluster a", a)
    b = _cluster_drive("cluster b", "sizey_temporal", CLUSTER_SCALE,
                       CLUSTER_ARRIVALS, dict(engine, **CLUSTER_FAILS))
    _within_spread("cluster b", b["res"].temporal_wastage_gbh,
                   REF_CT_TW_GBH, REF_CT_TW_RTOL, b["res"].n_failures,
                   REF_CT_FAILURES, REF_CT_FAILURES_TOL,
                   "temporal_wastage_gbh")
    _check_sizey_launches("cluster temporal", b["launches"], b["disp"])
    _check_waves("cluster b", b)
    if b["launches"].get("segment_dp", 0) != b["fits"] or not b["fits"]:
        _fail(f"segment_dp launched {b['launches'].get('segment_dp', 0)} "
              f"times on the engine, expected one per boundary fit "
              f"({b['fits']})")
    c = b["res"].cluster
    print(f"[cluster b] segment_dp once per boundary fit ({b['fits']}); "
          f"{c.n_resizes} RESIZE events in {c.n_resize_waves} waves, "
          f"{c.n_grow_failures} grow failures")
    if not c.n_resizes:
        _fail("the temporal path ran no RESIZE on the engine")
    return a, b


# ----------------------------------------------------------- phase 14
# phase 14, the risk-priced path: phase 13's traffic (methylseq at
# CLUSTER_SCALE on CLUSTER_NODES nodes of the trace's cap, backfill, 30 root
# arrivals an hour) with node crashes (CLUSTER_FAILS), through
# SizeyMethod(risk=True, failure_strategy="auto", quality=True) in (a) and
# make_method("sizey_risk_temporal", failure_strategy="auto") in (b). Risk
# reprices a decision only once its pool's prequential log holds
# RiskConfig().min_samples = 5 rows: with every root at t = 0, or at this
# rate at scales 0.2 and 0.5, no decision reaches a warm log and the path is
# the paper's offset. The reference's runs of these on a CPU and their
# spread under 16 1-ulp moves of the MLP's initial weights
# (tools/port_tolerance.py --cluster 8 --scale 1.0 --arrival-rate 30
# --fail-rate 0.01 --fail-seed 7 --failure-strategy auto --samples 16,
# --method sizey_risk and sizey_risk_temporal): (a) wastage
# 73945.21..75532.94 GB.h, 2.102e-2 relative at most, failures 83..87
# (three modes: 83, 84 and 87, the port's CPU run in the last), 83 risk
# rows in every move, strategies retry_same 734..743 and retry_scaled
# 210..219; (b) time-integrated wastage 80380.25..83742.71 GB.h, 3.650e-2
# relative at most, failures 109..129, 94 risk rows with one plan
# collapsed. The port is held to twice that spread
REF_R_WASTAGE_GBH = 75532.69477768053
REF_R_FAILURES = 83
REF_R_WASTAGE_RTOL = 4.21e-2
REF_R_FAILURES_TOL = 8
REF_RT_TW_GBH = 80793.79673797476
REF_RT_FAILURES = 129
REF_RT_TW_RTOL = 7.3e-2
REF_RT_FAILURES_TOL = 40
# (c) and (e): the reference's risk chaos cell (tests/test_risk.py): eager
# seed 5 at 0.15 on 4 nodes of 64 GB, node crashes at 0.1 a node-hour, seed
# 5, with min_samples low enough that a small trace's logs warm up
RISK_CHAOS_TRACE = {"name": "eager", "seed": 5, "scale": 0.15,
                    "machine_cap_gb": 64.0}
RISK_CHAOS_ENGINE = {"n_nodes": 4, "fail_rate_per_node_h": 0.1,
                     "fail_seed": 5}
RISK_CHAOS_CFG = {"min_samples": 2, "window": 64}
RISK_KILLS = 4
RISK_SNAPSHOT = 16
# (e): card vs CPU, each risk method on an input where the reference's own
# 16 1-ulp moves of the MLP's initial weights move no integer choice
# (tools/port_tolerance.py --workflow eager --seed S --machine-cap 64
# --scale 0.15 --cluster 4 --fail-rate 0.1 --fail-seed 5
# --risk-min-samples 2 --risk-window 64 --failure-strategy auto --samples
# 16), held to twice that spread in allocations, the risk rows' included:
# sizey_risk at the chaos cell (seed 5: allocations 1.242e-3, the rows'
# 1.258e-3, 8 risk rows in every move); sizey_risk_temporal at seed 4
# (allocations 9.203e-4, the rows' 1.787e-3, 3 rows, one plan collapsed).
# At the chaos cell itself the temporal method is not stable: a
# learning-rate flip in one pool moves 8 segment decisions in most of the
# reference's moves, and a failure in one, as card and CPU differ there
R_E_INPUTS = {
    "sizey_risk": {"trace": RISK_CHAOS_TRACE, "engine": RISK_CHAOS_ENGINE,
                   "rtol": 2.6e-3},
    "sizey_risk_temporal": {"trace": dict(RISK_CHAOS_TRACE, seed=4),
                            "engine": RISK_CHAOS_ENGINE, "rtol": 3.6e-3},
}
# (d): the service's two tenants, weights 2 and 1: methylseq at
# SERVICE_SCALE with phase 13's arrivals, and the sample scheduler log
# (repro_torch/data/sample_traces) with its arrivals compressed tenfold on
# its own node table
SERVICE_SCALE = 0.1
SERVICE_TENANTS = {"genomics": 2.0, "hpc_log": 1.0}
SERVICE_COMPRESS = 10.0
# (a), (b) and (d): the risk layer's configuration, the defaults
RISK_CFG = {}
# (c)-(e) are host-bound and touch the card lightly: they run in worker
# processes beside (a) and (b), each with the settings of this process
# named here (run one after another, phase 14 would take the smoke to
# ~1,300 s of its 1,200 s limit)
RISK_WORKERS = ("risk_durability:risk", "risk_durability:risk_auto",
                "service_phase",
                "risk_card_vs_cpu:sizey_risk,sizey_risk_temporal")
# the workers' scheduling priority (nice): below the main process, whose
# LM, training and distributed phases run beside them, and below the
# longest job of phase 18
WORKER_NICE = 10
# the workers this process starts after the build, each with its phase
HOST_WORKERS = (("peak", 4), ("temporal", 5), ("cluster_phase", 13),
                ("risk_phase", 14), ("loop", 17))
HOST_TIMEOUT = 900
WORKER_SETTINGS = ("DEV", "CLUSTER_NODES", "CLUSTER_ARRIVALS",
                   "CLUSTER_FAILS", "RISK_CFG", "RISK_CHAOS_TRACE",
                   "RISK_CHAOS_ENGINE", "RISK_CHAOS_CFG", "RISK_KILLS",
                   "RISK_SNAPSHOT", "R_E_INPUTS", "SERVICE_SCALE",
                   "SERVICE_TENANTS", "SERVICE_COMPRESS", "PAPER_SCALE",
                   "PAPER_TTFS", "DUR_SCALE", "DUR_ARRIVALS", "DUR_ENGINE",
                   "DUR_SNAPSHOT", "DUR_KILLS", "DUR_SEED")


def _risk_rows(db_or_path) -> tuple[list, list]:
    """The risk and quality rows of a live provenance db or a journal."""
    from repro_torch.obs.quality import read_quality_rows
    from repro_torch.obs.risk import read_risk_rows
    return read_risk_rows(db_or_path), read_quality_rows(db_or_path)


def _risk_summary(rows) -> str:
    """The digest of a run's risk rows (``obs.risk.summarize_risk``)."""
    from repro_torch.obs.risk import summarize_risk
    d = summarize_risk(rows)
    if not d["n"]:
        return "0 risk rows"
    return (f"{d['n']} risk rows, tau {d['tau_min']!r}..{d['tau_max']!r}, "
            f"{d['n_collapsed']} collapsed")


def _counting_strategies(method, picks: list) -> None:
    """Append each of ``method``'s ``strategy_for`` picks to ``picks``."""
    pick = method.strategy_for

    def counting(task):
        s = pick(task)
        picks.append(s)
        return s

    method.strategy_for = counting


def _timed_residual_reads():
    """Time each read of a pool's residual log (its device-to-host copy and
    the wait for the device's queue): returns the list of host seconds and
    an undo."""
    import repro_torch.core.risk as risk
    read = risk.pool_residuals
    times = []

    def timed(pool):
        t0 = time.perf_counter()
        out = read(pool)
        times.append(time.perf_counter() - t0)
        return out

    risk.pool_residuals = timed

    def restore():
        risk.pool_residuals = read
    return times, restore


def _risk_drive(label: str, method) -> dict:
    """One run of phase 13's traffic with crashes through a risk method on
    the card, counters zeroed just before: K1 and K2 once per dispatch,
    predict dispatches at most waves x pools, at least one risk row and
    a strategy other than retry_same. Prints the rows, strategies,
    residual reads and the wall."""
    from collections import Counter

    from repro_torch.core.risk import RESIDUAL_READS
    picks = []
    _counting_strategies(method, picks)
    times, restore = _timed_residual_reads()
    RESIDUAL_READS.clear()
    try:
        run = _cluster_drive(label, method.name, CLUSTER_SCALE,
                             CLUSTER_ARRIVALS,
                             {"n_nodes": CLUSTER_NODES, "policy": "backfill",
                              **CLUSTER_FAILS}, method=method)
    finally:
        restore()
    reads = dict(RESIDUAL_READS)
    rows, quality = _risk_rows(method.predictor.db)
    strategies = Counter(picks)
    n = len(run["res"].outcomes)
    print(f"[{label}] {_risk_summary(rows)}; strategies "
          f"{dict(sorted(strategies.items()))}; quality rows {len(quality)}")
    print(f"[{label}] residual reads {reads.get('reads', 0)} ({len(times)} "
          f"timed, {reads.get('rows', 0)} rows) in {sum(times) * 1e3:.3f} ms "
          f"of host time")
    print(f"[{label}] wall {run['wall_s']:.3f} s, {n / run['wall_s']:.3f} "
          f"tasks/s")
    _check_sizey_launches(label, run["launches"], run["disp"])
    _check_waves(label, run, refresh=True)
    if not rows:
        _fail(f"{label}: the risk path repriced nothing")
    if not set(strategies) - {"retry_same"}:
        _fail(f"{label}: auto picked no strategy but retry_same")
    if reads.get("reads", 0) != len(times):
        _fail(f"{label}: residual reads miscounted")
    return {**run, "rows": rows, "quality": quality,
            "strategies": strategies, "reads": reads,
            "read_s": sum(times)}


def _kill_points(path: str, n: int, seed: int) -> list[int]:
    """``n`` seeded byte offsets of the journal at ``path`` (those of the
    reference's chaos harness): a third clean line ends, the rest mid-line
    bytes, always with an early and a nearly-done cut."""
    import os

    import numpy as np
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    bounds = [i + 1 for i, b in enumerate(data) if b == 0x0A]
    rng = np.random.default_rng([seed, size])
    pts = set()
    lo = max(1, len(bounds) // 10)
    for i in rng.choice(len(bounds), size=min(max(1, n // 3), len(bounds)),
                        replace=False):
        pts.add(bounds[int(i)])
    while len(pts) < n:
        pts.add(int(rng.integers(bounds[lo], size)))
    pts.add(bounds[lo])
    pts.add(bounds[-2] if len(bounds) > 1 else bounds[-1])
    return sorted(pts)[:max(n, 2)]


def _chaos_factory(auto: bool, device: str = None):
    """The chaos cell's risk method (with quality rows) for a journal."""
    from repro_torch.baselines import SizeyMethod
    from repro_torch.core.risk import RiskConfig
    strat = {"failure_strategy": "auto"} if auto else {}
    return lambda path: SizeyMethod(
        machine_cap_gb=RISK_CHAOS_TRACE["machine_cap_gb"],
        persist_path=path, risk=RiskConfig(**RISK_CHAOS_CFG), quality=True,
        device=device or DEV, **strat)


def risk_durability(build, variant: str) -> None:
    """Phase 14 (c): the chaos cell journaled under ``variant`` (risk or
    risk_auto), killed at RISK_KILLS seeded bytes, repaired and resumed:
    each resumed run bitwise the uninterrupted one, its risk and quality
    rows too."""
    import os
    import tempfile

    from repro_torch.workflow import generate_workflow
    from repro_torch.workflow.cluster import ClusterEngine
    from repro_torch.workflow.journal import Journal, recover_run
    trace = generate_workflow(**RISK_CHAOS_TRACE)
    factory = _chaos_factory(variant == "risk_auto")
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "run.jsonl")
        method = factory(path)
        t0 = time.perf_counter()
        base = ClusterEngine(
            trace, method, journal=Journal.attach(
                method, snapshot_every=RISK_SNAPSHOT),
            **RISK_CHAOS_ENGINE).run()
        rows, quality = _risk_rows(path)
        print(f"[risk c] {variant}: the chaos cell journaled in "
              f"{time.perf_counter() - t0:.3f} s, {_risk_summary(rows)}, "
              f"{len(quality)} quality rows, "
              f"{base.cluster.n_node_failures} node crashes")
        if not rows or len(quality) != len(trace.tasks):
            _fail(f"risk c {variant}: no risk row, or not one quality row "
                  f"per task")
        with open(path, "rb") as f:
            data = f.read()
        for cut in _kill_points(path, RISK_KILLS, seed=5):
            scratch = os.path.join(d, f"cut{cut}.jsonl")
            with open(scratch, "wb") as f:
                f.write(data[:cut])
            t0 = time.perf_counter()
            res = recover_run(scratch, trace, factory,
                              snapshot_every=RISK_SNAPSHOT).run()
            got = _risk_rows(scratch)
            ok = (_sim_equal(base, res, ("n_recoveries", "n_replayed_steps"))
                  and got == (rows, quality))
            print(f"[risk c] {variant}: killed at byte {cut} of "
                  f"{len(data)}, resumed in {time.perf_counter() - t0:.3f} "
                  f"s: SimResult, {len(got[0])} risk rows and "
                  f"{len(got[1])} quality rows "
                  f"{'bitwise the uninterrupted run' if ok else 'DIFFER'}")
            if not ok:
                _fail(f"risk c {variant}: the resume at byte {cut} is not "
                      f"bitwise the uninterrupted run")


def service_phase(build) -> None:
    """Phase 14 (d): the multi-tenant service on the card, each workflow's
    result bitwise its engine run outside the service; then a crashed
    service's journal found and resumed bitwise."""
    import asyncio
    import os
    import re
    import tempfile

    from repro_torch.baselines import SizeyMethod, make_method
    from repro_torch.core.risk import RiskConfig
    from repro_torch.data import (SAMPLE_TRACES, read_jobs_info,
                                  read_nodes_info)
    from repro_torch.serving import SchedulerService
    from repro_torch.workflow import generate_workflow
    from repro_torch.workflow.cluster import ClusterEngine
    from repro_torch.workflow.journal import Journal
    genomics = generate_workflow("methylseq", scale=SERVICE_SCALE,
                                 arrival_rate_per_h=CLUSTER_ARRIVALS)
    g_engine = {"n_nodes": CLUSTER_NODES, "policy": "backfill",
                "node_cap_gb": genomics.machine_cap_gb, **CLUSTER_FAILS}
    log = read_jobs_info(SAMPLE_TRACES / "sample_jobs_info.txt",
                         time_compress=SERVICE_COMPRESS)
    l_engine = {"node_specs": read_nodes_info(
        SAMPLE_TRACES / "sample_nodes_info.txt")}

    def genomics_method(path):
        return SizeyMethod(risk=RiskConfig(**RISK_CFG),
                           failure_strategy="auto", quality=True,
                           name="sizey_risk", persist_path=path, device=DEV)

    def log_method():
        return make_method("sizey_risk", machine_cap_gb=log.machine_cap_gb,
                           risk=RiskConfig(**RISK_CFG), device=DEV)

    with tempfile.TemporaryDirectory(dir=build) as d:
        jd = os.path.join(d, "journals")

        async def serve():
            svc = SchedulerService(max_concurrent=4, journal_dir=jd)
            for tenant, weight in SERVICE_TENANTS.items():
                svc.add_tenant(tenant, weight=weight)
            async with svc:
                hg = await svc.submit("genomics", genomics,
                                      method_factory=genomics_method,
                                      engine_kwargs=g_engine)
                hl = await svc.submit("hpc_log", log, log_method(),
                                      engine_kwargs=l_engine)
                out = await asyncio.gather(hg, hl)
            return svc, out

        t0 = time.perf_counter()
        svc, (rg, rl) = asyncio.run(serve())
        wall = time.perf_counter() - t0
        stats = svc.stats()
        print(f"[risk d] service: {len(rg.outcomes)} + {len(rl.outcomes)} "
              f"tasks of two tenants in {wall:.3f} s; stats {stats}")
        gauges = [ln for ln in svc.scrape().splitlines()
                  if re.match(r"scheduler_\w+\{tenant=", ln)]
        print("[risk d] scrape: " + "; ".join(gauges))
        [journal] = [os.path.join(jd, f) for f in os.listdir(jd)]
        outside = os.path.join(d, "outside.jsonl")
        m = genomics_method(outside)
        og = ClusterEngine(genomics, m, journal=Journal.attach(
            m, snapshot_every=svc.snapshot_every), **g_engine).run()
        ol = ClusterEngine(log, log_method(), **l_engine).run()
        same = (_sim_equal(og, rg) and _sim_equal(ol, rl)
                and _risk_rows(outside) == _risk_rows(journal))
        rows, quality = _risk_rows(journal)
        print(f"[risk d] genomics: {_risk_summary(rows)}, {len(quality)} "
              f"quality rows, {rg.n_failures} failures; hpc_log: "
              f"{len(rl.outcomes)} tasks on {len(l_engine['node_specs'])} "
              f"nodes, {rl.n_failures} failures; each SimResult (and the "
              f"journal's rows) {'bitwise' if same else 'DIFFERS from'} "
              f"the engine run outside the service")
        if not same:
            _fail("a workflow's result depends on the service")
        if len(quality) != len(genomics.tasks) or \
                stats["genomics"]["n_completed"] != 1 or \
                stats["hpc_log"]["n_completed"] != 1:
            _fail("the service lost a workflow or a quality row")
        # the reference's test_service_crash_scan_and_resume, on the card
        trace = generate_workflow("eager", seed=4, scale=0.03,
                                  machine_cap_gb=64.0)
        cd = os.path.join(d, "crashed")
        os.makedirs(cd)
        path = os.path.join(cd, "t-eager-0001.jsonl")

        def peak(p):
            return SizeyMethod(machine_cap_gb=64.0, persist_path=p,
                               device=DEV)

        m = peak(path)
        base = ClusterEngine(trace, m, journal=Journal.attach(
            m, snapshot_every=8), n_nodes=2).run()
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2 + 9])
        found = SchedulerService.scan_unfinished(cd)

        async def resume():
            svc = SchedulerService(max_concurrent=2, journal_dir=cd,
                                   snapshot_every=8)
            svc.add_tenant("t")
            async with svc:
                h = await svc.resume("t", trace, peak, path)
                return await h

        res = asyncio.run(resume())
        ok = (found == [path] and _sim_equal(
            base, res, ("n_recoveries", "n_replayed_steps"))
            and SchedulerService.scan_unfinished(cd) == [])
        print(f"[risk d] crash scan found {len(found)} unfinished journal, "
              f"resumed through the service: "
              f"{'bitwise the uninterrupted run' if ok else 'DIFFERS'}")
        if not ok:
            _fail("the service's crash scan and resume is not bitwise")


def risk_card_vs_cpu(name: str) -> None:
    """Phase 14 (e): the risk method ``name`` at its input of R_E_INPUTS
    on the card and on the CPU: integer choices, strategies, row counts,
    seq and collapsed equal; allocations and the rows' floats within the
    input's tolerance."""
    import numpy as np
    import torch
    from repro_torch.baselines import make_method
    from repro_torch.core.risk import RiskConfig
    from repro_torch.workflow import generate_workflow
    from repro_torch.workflow.cluster import ClusterEngine
    spec = R_E_INPUTS[name]
    trace = generate_workflow(**spec["trace"])
    threads = torch.get_num_threads()
    runs = []
    for dev in (DEV, "cpu"):
        if dev == "cpu":
            torch.set_num_threads(1)
        try:
            m = make_method(name, failure_strategy="auto",
                            machine_cap_gb=trace.machine_cap_gb,
                            risk=RiskConfig(**RISK_CHAOS_CFG), device=dev)
            picks, decs = [], []
            _counting_strategies(m, picks)
            predict_batch = m.predictor.predict_batch

            def recording(tasks, predict_batch=predict_batch,
                          decs=decs):
                out = predict_batch(tasks)
                for d in out:
                    for s in getattr(d, "seg_decisions", [d]):
                        decs.append(s)
                return out

            m.predictor.predict_batch = recording
            res = ClusterEngine(trace, m, **spec["engine"]).run()
        finally:
            torch.set_num_threads(threads)
        runs.append((res, picks, decs, _risk_rows(m.predictor.db)[0]))
    (rg, pg, dg, wg), (rc, pc, dc, wc) = runs
    ints = ([(o.task.key, o.attempts, o.failures, o.interruptions)
             for o in rg.outcomes] ==
            [(o.task.key, o.attempts, o.failures, o.interruptions)
             for o in rc.outcomes])
    same_decs = len(dg) == len(dc) and all(
        a.source == b.source and (a.source != "model" or (
            a.offset_idx == b.offset_idx
            and int(np.argmax(a.raq)) == int(np.argmax(b.raq))))
        for a, b in zip(dg, dc))
    same_rows = len(wg) == len(wc) and all(
        (a["seq"], a["collapsed"], a["task_type"]) ==
        (b["seq"], b["collapsed"], b["task_type"])
        for a, b in zip(wg, wc))
    worst = max([abs(a.first_alloc_gb - b.first_alloc_gb)
                 / b.first_alloc_gb
                 for a, b in zip(rg.outcomes, rc.outcomes)]
                + [abs(a[k] - b[k]) / b["alloc_gb"]
                   for a, b in zip(wg, wc)
                   for k in ("band_gb", "agg_pred_gb",
                             "offset_alloc_gb", "alloc_gb")]
                + [abs(a[k] - b[k]) for a, b in zip(wg, wc)
                   for k in ("tau", "pressure", "crash_p")],
                default=0.0)
    print(f"[risk e] {name} at {spec['trace']} on {spec['engine']}, card "
          f"vs CPU: "
          f"{len(dg)} decisions ({sum(d.source == 'model' for d in dg)} "
          f"by the models), integer choices "
          f"{'equal' if ints and same_decs else 'DIFFER'}; strategies "
          f"{'equal' if pg == pc else 'DIFFER'} "
          f"({dict((s, pg.count(s)) for s in sorted(set(pg)))}); "
          f"{len(wg)} vs {len(wc)} risk rows, seq and collapsed "
          f"{'equal' if same_rows else 'DIFFER'}; allocations and row "
          f"floats {worst:.3e} apart (tol {spec['rtol']:g}); failures "
          f"{rg.n_failures} and {rc.n_failures}")
    if not (ints and same_decs and pg == pc and same_rows) or not wg:
        _fail(f"{name}: card and CPU disagree on integer choices")
    if worst > spec["rtol"]:
        _fail(f"{name}: card and CPU allocations beyond the tolerance")


def _start_worker(task: str, nice: int = None) -> subprocess.Popen:
    """Run a check (a phase or one of its parts, a group of phase 18's
    jobs) in a process of its own, with this process's settings of it, at
    the scheduling priority ``nice`` (WORKER_NICE unless given: the host
    has fewer cores than the smoke has processes, and the main process
    and the longest worker go first); the process is stopped when this
    one exits, whatever ends it."""
    import atexit
    settings = {k: globals()[k] for k in WORKER_SETTINGS}
    nice = WORKER_NICE if nice is None else nice
    # its output goes to a file, read when it is joined: a pipe would
    # stall it once full
    log = REPO / "build" / "workers" / f"{task.replace(':', '_')}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--worker", task,
             json.dumps(settings)], stdout=out, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.setpriority(
                os.PRIO_PROCESS, 0, max(nice, os.getpriority(
                    os.PRIO_PROCESS, 0))))
    proc.log = log
    atexit.register(_stop_worker, proc)
    return proc


def _stop_worker(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _shapes_json(shapes: dict) -> dict:
    return {k: [[list(sh), n] for sh, n in c.items()]
            for k, c in shapes.items()}


def _shapes_load(obj: dict) -> dict:
    from collections import Counter
    return {k: Counter({tuple(sh): n for sh, n in pairs})
            for k, pairs in obj.items()}


def _worker_main(task: str, settings: str) -> int:
    """A worker: run ``task`` (``check:argument``) with the parent's
    settings, then print what the parent needs of it (``RESULT`` and
    JSON) and the kernel shapes it launched as the last line (``SHAPES``
    and JSON; for phases 13 and 14, those the phase returns)."""
    import torch
    globals().update(json.loads(settings))
    torch.set_num_threads(1)       # one core each: the host runs several
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    check, _, arg = task.partition(":")
    t0 = time.perf_counter()
    shapes, restore = _recording_shapes()
    result: dict = {}
    try:
        if check == "paper":
            paper_worker(int(arg))
        elif check == "peak":
            result = peak_phases()
        elif check == "temporal":
            result = temporal_phases()
        elif check in ("cluster_phase", "risk_phase"):
            phase, label = {"cluster_phase": (cluster_phase, "cluster"),
                            "risk_phase": (risk_phase, "risk")}[check]
            out = phase()
            shapes = out["shapes"]
            result = {"waves": [(f"{label} {k}",
                                 out[k]["disp"]["predict_pool"])
                                for k in ("a", "b")],
                      **{f"shapes_{k}": _shapes_json(out[k]["shapes"])
                         for k in ("a", "b")}}
        elif check == "loop":
            shapes = loop_vs_fused()
        elif check == "cluster_durability":
            cluster_durability(build)
        elif check == "risk_durability":
            risk_durability(build, arg)
        elif check == "service_phase":
            service_phase(build)
        else:
            for name in arg.split(","):
                risk_card_vs_cpu(name)
    finally:
        restore()
    print(f"[worker] {task} wall {time.perf_counter() - t0:.1f} s")
    print("RESULT " + json.dumps(result))
    print("SHAPES " + json.dumps(_shapes_json(shapes)))
    return 0


def _join_worker(task: str, proc: subprocess.Popen, shapes: dict,
                 timeout: float, records: dict | None = None,
                 phase: int = 14, results: dict | None = None) -> None:
    """Wait for a worker, print its lines, add the kernel shapes it
    launched to ``shapes`` (the job records of a phase 18 worker to
    ``records``, and its RESULT to ``results``) and fail if it failed."""
    proc.wait(timeout=timeout)
    lines = proc.log.read_text().splitlines()
    for line in lines:
        if line.startswith("SHAPES "):
            for k, c in _shapes_load(json.loads(line[7:])).items():
                shapes[k].update(c)
        elif line.startswith("PAPER ") and records is not None:
            records.update(json.loads(line[6:]))
        elif line.startswith("RESULT "):
            if results is not None:
                results.update(json.loads(line[7:]))
        else:
            print(line)
    if proc.returncode != 0:
        _fail(f"phase {phase} {task} failed (exit {proc.returncode})")


def risk_phase() -> dict:
    """Phase 14: the risk-priced path on the card. (a) SizeyMethod(risk,
    auto, quality) and (b) sizey_risk_temporal on phase 13's traffic with
    crashes, each held to twice the reference's spread; meanwhile, in
    worker processes (each host-bound, touching the card lightly), (c)
    the chaos cell killed and resumed bitwise with its risk and quality
    rows, (d) the multi-tenant service, (e) card vs CPU. Returns the
    kernel shapes the phase launched."""
    from repro_torch.baselines import SizeyMethod, make_method
    from repro_torch.core.risk import RiskConfig
    t_start = time.perf_counter()
    shapes, restore = _recording_shapes()
    workers = {task: _start_worker(task) for task in RISK_WORKERS}
    try:
        a = _risk_drive("risk a", SizeyMethod(
            risk=RiskConfig(**RISK_CFG), failure_strategy="auto",
            quality=True, name="sizey_risk", device=DEV))
        _within_spread("risk a", a["res"].wastage_gbh, REF_R_WASTAGE_GBH,
                       REF_R_WASTAGE_RTOL, a["res"].n_failures,
                       REF_R_FAILURES, REF_R_FAILURES_TOL, "wastage_gbh")
        if len(a["quality"]) != len(a["trace"].tasks):
            _fail("risk a: not one quality row per task")
        b = _risk_drive("risk b", make_method(
            "sizey_risk_temporal", failure_strategy="auto",
            risk=RiskConfig(**RISK_CFG), device=DEV))
        _within_spread("risk b", b["res"].temporal_wastage_gbh,
                       REF_RT_TW_GBH, REF_RT_TW_RTOL, b["res"].n_failures,
                       REF_RT_FAILURES, REF_RT_FAILURES_TOL,
                       "temporal_wastage_gbh")
        c = b["res"].cluster
        if b["launches"].get("segment_dp", 0) != b["fits"] or not b["fits"]:
            _fail(f"risk b: segment_dp launched "
                  f"{b['launches'].get('segment_dp', 0)} times, expected "
                  f"one per boundary fit ({b['fits']})")
        print(f"[risk b] segment_dp once per boundary fit ({b['fits']}); "
              f"{c.n_resizes} RESIZE events in {c.n_resize_waves} waves")
        if not c.n_resizes:
            _fail("the risk-priced temporal path ran no RESIZE")
        for task, proc in workers.items():
            _join_worker(task, proc, shapes, timeout=HOST_TIMEOUT)
        print(f"[risk] (c)-(e) in {len(workers)} worker processes, done "
              f"{time.perf_counter() - t_start:.1f} s into the phase")
    finally:
        restore()
        for proc in workers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t_start
    print(f"[risk] phase 14 wall {wall:.1f} s")
    return {"a": a, "b": b, "shapes": shapes, "wall_s": wall}


# ----------------------------------------------------------- phase 18
# The paper's evaluation through the port at the reference's --smoke
# settings, held to the reference's figures at that scale and ttf
PAPER_SCALE = 0.05
PAPER_TTFS = (1.0,)
PAPER_REFERENCE = REPO / "tools" / "port_paper_reference.json"
PAPER_TIMEOUT = 900


def paper_groups() -> list:
    """The jobs of phase 18 in worker groups: two workflows a group (the
    i-th with the i-th from the end), and fig12's mag run at 0.3 (~1,500
    tasks, the longest) on its own. Every process on the card slows the
    others' launches, so the short groups share processes."""
    from repro_torch.workflow import paper
    jobs = paper.jobs(PAPER_SCALE, tuple(PAPER_TTFS))
    big = [j for j in jobs if j[1] != PAPER_SCALE]
    wfs = list(dict.fromkeys(j[0] for j in jobs))
    by_wf = [[j for j in jobs if j[0] == wf and j not in big] for wf in wfs]
    n = len(by_wf)
    return [by_wf[i] + (by_wf[n - 1 - i] if n - 1 - i != i else [])
            for i in range((n + 1) // 2)] + [big]


def paper_worker(group: int) -> None:
    """A worker of phase 18: replay one group of jobs on the card, then
    print their records (``PAPER`` and JSON)."""
    from repro_torch.workflow import paper
    records = {paper.job_key(*job): paper.run_job(job, DEV)
               for job in paper_groups()[group]}
    print("PAPER " + json.dumps(records))


def paper_start() -> dict:
    """Start phase 18's workers; they run beside every phase up to 17.
    The last group, fig12's mag run and the smoke's longest job, keeps
    this process's priority."""
    n = len(paper_groups())
    return {"t0": time.perf_counter(),
            "procs": {f"paper:{i}": _start_worker(
                f"paper:{i}", nice=0 if i == n - 1 else None)
                for i in range(n)}}


def paper_phase(started: dict) -> dict:
    """Phase 18: join the workers, build the figures and hold them and
    each job's record to the reference file's at PAPER_SCALE; K1 and K2
    once per dispatch in every Sizey run. Returns the kernel shapes the
    phase launched."""
    from collections import Counter

    from repro_torch.workflow import paper
    shapes = {"ensemble_mlp": Counter(), "knn_predict": Counter(),
              "segment_dp": Counter()}
    records: dict = {}
    t_wait = time.perf_counter()
    try:
        for task, proc in started["procs"].items():
            _join_worker(task, proc, shapes, PAPER_TIMEOUT, records, 18)
    finally:
        for proc in started["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    waited = time.perf_counter() - t_wait

    def tagged(*a):
        print("[paper]", *a)

    tool = _port_paper()
    out = tool.figures(records, PAPER_SCALE, tuple(PAPER_TTFS))
    tool.print_figures(out, print=tagged)
    ref = json.loads(PAPER_REFERENCE.read_text())["scales"][str(PAPER_SCALE)]
    breaches = tool.compare(out, ref, print=tagged)
    job_breaches = tool.compare_jobs(records, ref)
    print(f"[paper] each job's {', '.join(tool.JOB_FIGURES)} held to the "
          f"reference's replay: {len(records)} jobs, "
          f"{len(job_breaches)} outside their limits {job_breaches}")
    sizey = {k: r for k, r in records.items()
             if k.split("/")[1] in paper.SIZEY}
    for key, rec in sizey.items():
        _check_sizey_launches(f"paper {key}", rec["launches"],
                              rec["dispatches"])
    print(f"[paper] K1 and K2 once per predictor dispatch in all "
          f"{len(sizey)} Sizey runs "
          f"({sum(r['n_tasks'] for r in sizey.values())} tasks)")
    f9 = out["fig9"]
    print(f"[paper] fig9 median train ms: full {f9['full_ms']:.3f}, "
          f"incremental {f9['incremental_ms']:.3f}, reduction "
          f"{f9['reduction_pct']:.2f} % (paper: 1090 -> 17.5 ms, 98.39 %); "
          f"{gpu_line()}")
    print(f"[paper] phase 18 wall {time.perf_counter() - started['t0']:.1f} "
          f"s ({len(records)} jobs in {len(started['procs'])} workers; "
          f"{waited:.1f} s waited for them after phase 13)")
    if breaches or job_breaches:
        _fail(f"phase 18: {len(breaches) + len(job_breaches)} figures "
              f"outside the reference's limits: {breaches + job_breaches}")
    return shapes


def _port_paper():
    """``tools/port_paper.py``: the figures, their printing and limits."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "port_paper", REPO / "tools" / "port_paper.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------- phases 8-12
# The LM serving slice: zamba2-7b at full width through the port's
# ServeEngine and KVCacheSizer, with K4 flash_attention, K5 flash_decode and
# K6 ssd_scan; their bounds count the work of analysis/kernel_costs.py.
LM_SEED = 0
SERVE_ARCH = "zamba2-7b"
SERVE_REQUESTS = 32
SERVE_BATCH = 8
SERVE_NEW = 32
SERVE_TEMPERATURE = 0.8
SERVE_MAX_SEQ = 4096
# prompt lengths: the multiples of 128 in 256..2048 (the SSD's chunk of 128
# must divide a batch's longest prompt, as in the reference)
SERVE_LENS = tuple(range(256, 2049, 128))
# K4, K5 and K6 at the shapes of tests/test_kernels.py: (B, S, H, Hkv, D),
# (B, S_max, H, Hkv, D, pos) and (B, H, S, P, N, Q); the serve phase adds
# every shape it launched
K4_SHAPES = [(2, 256, 8, 8, 64), (2, 256, 8, 2, 64), (1, 384, 4, 1, 128),
             (1, 128, 4, 4, 112), (2, 200, 4, 2, 64)]
K5_SHAPES = [(2, 1024, 8, 8, 64, 700), (2, 1024, 8, 2, 64, 1023),
             (1, 500, 4, 1, 112, 250), (2, 256, 4, 4, 128, 0)]
K6_SHAPES = [(2, 4, 128, 32, 16, 64), (1, 2, 200, 16, 8, 64),
             (2, 3, 256, 64, 128, 128), (1, 7, 128, 64, 64, 128)]
# the reference's tolerances (tests/test_kernels.py): K4 and K5 elementwise
# |kernel - plain| <= tol * (1 + |plain|), K6 relative to the largest |y|
# and |state|. K6 in fp32 is held to 1e-5 of the plain version and of the
# plain version computed in fp64, not to the reference's 2e-6: a chunked
# scan in fp32 carries the rounding of the within-chunk cumulative decay
# (|cum| reaches ~60, so exp(cum_q - cum_t) carries ~60 ulp) and of the
# state over the chunks, and two fp32 evaluations differ by up to twice
# their own distance from fp64, which reached 3.590e-6 on the card at the
# serve shapes (PERF.md; ROADMAP Queue 3)
LM_TOL = {"flash_attention": (2e-5, 2e-2), "flash_decode": (2e-5, 3e-2),
          "ssd_scan": (1e-5, 3e-2)}
# teacher-forced kernel path vs plain path at full width in bf16: the
# largest logit difference over the largest logit, at most 5.478e-2 on an
# H100 (bf16 rounding at other places, compounded over 81 layer positions
# of random weights), held to 0.1; the card vs the CPU in fp32 at 6 layer
# positions: at most 3.019e-6 on an H100, held to 1e-5 (PERF.md)
TF_BATCH, TF_LEN, TF_STEPS = 8, 1024, 8
TF_RTOL = 0.1
# K5 with a bf16 query on an e4m3 cache (P in bf16) and K5's log-sum-exp
# variant in bf16, against their plain versions: |kernel - plain| <=
# tol * (1 + |plain|). At most 3.906e-3 and 2.065e-3 on an H100 at the
# shapes of phases 8, 9 and 16 (b), against q, k, v ~ N(0, 1) outputs of
# 0.03-0.05; held to 1e-2 (K5's own bf16 limit, 3e-2, is the size of a
# typical output there). With P rounded to e4m3 the plain version's own
# rounding flips reach 1.534e-2: those rows keep 3e-2.
K5_BF16_TOL = 1e-2
CVC_LAYERS, CVC_BATCH, CVC_LEN, CVC_NEW = 6, 2, 256, 8
CVC_RTOL = 1e-5
DEV = "cuda"


def serve_config():
    from repro_torch.configs import get_config
    return get_config(SERVE_ARCH)


def cvc_config():
    """zamba2-7b at full width cut to CVC_LAYERS positions, compute fp32."""
    import dataclasses
    return dataclasses.replace(serve_config().with_layers(CVC_LAYERS),
                               compute_dtype="float32")


def _gen_inputs(seed, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=None, scale=1.0):
        t = torch.randn(shape, generator=g, device=dev) * scale
        return t if dtype is None else t.to(dtype)
    return randn


def lm_kernel_inputs(kind, shape, dtype, seed, dev):
    """Seeded inputs of K4 (q, k, v), K5 (q, k_cache, v_cache, pos) or K6
    (x, dt, B, C, a) at ``shape`` (tests/test_torch_cuda.py uses these
    too)."""
    import torch
    randn = _gen_inputs(seed, dev)
    if kind == "flash_attention":
        b, s, h, hkv, d = shape
        return (randn(b, s, h, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype),
                randn(b, s, hkv, d, dtype=dtype))
    if kind == "flash_decode":
        b, smax, h, hkv, d, pos = shape
        return (randn(b, 1, h, d, dtype=dtype),
                randn(b, smax, hkv, d, dtype=dtype),
                randn(b, smax, hkv, d, dtype=dtype),
                torch.tensor(pos, dtype=torch.int32, device=dev))
    b, h, s, p, n, _q = shape
    dt = torch.nn.functional.softplus(randn(b, s, h) - 1.0)
    a = -torch.exp(torch.linspace(-1.0, 0.5, h, device=dev))
    return (randn(b, s, h, p, dtype=dtype), dt,
            randn(b, s, n, dtype=dtype, scale=0.5),
            randn(b, s, n, dtype=dtype, scale=0.5), a)


def check_lm_kernels(k4_shapes, k5_shapes, k6_shapes, label="check") -> dict:
    """K4, K5 and K6 against their plain versions on the card, in fp32 and
    bf16 (K4 causal and not). Returns the largest absolute difference per
    kernel."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_plain
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain
    dev = torch.device(DEV)
    err = {"flash_attention": 0.0, "flash_decode": 0.0, "ssd_scan": 0.0}
    f32, bf16 = torch.float32, torch.bfloat16

    def close(name, got, want, dtype, what):
        tol = LM_TOL[name][dtype == bf16]
        diff = (got.float() - want.float()).abs()
        e = float(diff.max())
        ok = bool((diff <= tol * (1 + want.float().abs())).all())
        print(f"[{label}] {name} {what} {str(dtype)[6:]}: max abs err "
              f"{e:.3e} (tol {tol:g} x (1+|plain|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{name} disagrees with its plain version at {what}")
        err[name] = max(err[name], e)

    for i, shape in enumerate(k4_shapes):
        for dtype in (f32, bf16):
            q, k, v = lm_kernel_inputs("flash_attention", shape, dtype, i, dev)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = flash_attention_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                close("flash_attention", got, want, dtype,
                      f"(B,S,H,Hkv,D)={shape} causal={causal}")
            del q, k, v, got, want
    for i, shape in enumerate(k5_shapes):
        for dtype in (f32, bf16):
            q, kc, vc, pos = lm_kernel_inputs("flash_decode", shape, dtype,
                                              100 + i, dev)
            got = flash_decode(q, kc, vc, pos)
            want = flash_decode_plain(q, kc, vc, pos)
            torch.cuda.synchronize()
            close("flash_decode", got, want, dtype,
                  f"(B,S_max,H,Hkv,D,pos)={shape}")
            del q, kc, vc
    for i, shape in enumerate(k6_shapes):
        for dtype in (f32, bf16):
            x, dt, bm, cm, a = lm_kernel_inputs("ssd_scan", shape, dtype,
                                                200 + i, dev)
            qc = shape[5]
            y, st = ssd_scan(x, dt, bm, cm, a, q_chunk=qc)
            wy, wst = ssd_scan_plain(x, dt, bm, cm, a, q_chunk=qc)
            torch.cuda.synchronize()
            tol = LM_TOL["ssd_scan"][dtype == bf16]
            ry = float((y - wy).abs().max() / wy.abs().max())
            rs = float((st - wst).abs().max() / wst.abs().max())
            extra, r64 = "", 0.0
            if dtype == f32:
                ty, ts = ssd_scan_plain(x, dt, bm, cm, a, q_chunk=qc,
                                        dtype=torch.float64)
                ry64 = float((y - ty).abs().max() / ty.abs().max())
                rs64 = float((st - ts).abs().max() / ts.abs().max())
                r64 = max(ry64, rs64)
                extra = (f"; from the fp64 plain version y {ry64:.3e} "
                         f"state {rs64:.3e}")
                del ty, ts
            else:
                ry32, rs32 = k6_fp32_distance(x, dt, bm, cm, a, qc, wy, wst)
                extra = (f"; the fp32 kernel fed the same values y "
                         f"{ry32:.3e} state {rs32:.3e} (bf16 y tol twice "
                         f"that)")
            ok = max(ry, rs, r64) <= tol
            print(f"[{label}] ssd_scan (B,H,S,P,N,Q)={shape} "
                  f"{str(dtype)[6:]}: y rel err {ry:.3e}, final state rel "
                  f"err {rs:.3e}{extra} (tol {tol:g} of the largest) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"ssd_scan disagrees with its plain version at {shape}")
            if dtype == bf16 and ry > 2 * ry32:
                _fail(f"ssd_scan in bf16 at {shape} lies {ry:.3e} of the "
                      f"largest |y| from its plain version, more than twice "
                      f"the fp32 kernel's {ry32:.3e}: not fp32 math")
            err["ssd_scan"] = max(err["ssd_scan"],
                                  float((y - wy).abs().max()),
                                  float((st - wst).abs().max()))
            del x, dt, bm, cm, y, st, wy, wst
    torch.cuda.empty_cache()
    return err


def check_k5_variants(k5_shapes, label="check") -> dict:
    """K5 on an e4m3 cache (P rounded to e4m3, the TPU kernel's function,
    and to the query's type, the model's) and K5's log-sum-exp variant
    over 1, 2 and 4 slices of the cache (each slice's offset; a slice past
    pos must give o = 0 and lse = -inf exactly), against their plain
    versions on the card, fp32 and bf16 queries: with P in e4m3 within
    K5's bf16 limit (P keeps 4 significant bits; a score one ulp apart
    may round P to a neighbour), with P in the query's type within K5's
    fp32 limit or K5_BF16_TOL; the log-sum-exp variant's output and
    log-sum-exp within K5's fp32 limit or K5_BF16_TOL. Returns the
    largest absolute difference of each."""
    import torch
    from repro_torch.kernels.flash_decode.ops import (FP8, flash_decode,
                                                      flash_decode_lse)
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_lse_plain, flash_decode_plain)
    dev = torch.device(DEV)
    err = {"flash_decode_fp8": 0.0, "flash_decode_lse": 0.0}
    f32, bf16 = torch.float32, torch.bfloat16

    def close(name, pairs, tol, what):
        """Hold each (kernel, plain) pair; -inf only where the plain
        version has it."""
        e, ok = 0.0, True
        for got, want in pairs:
            fin = torch.isfinite(want)
            ok &= bool(torch.equal(fin, torch.isfinite(got))) and bool(
                (got[~fin] == want[~fin]).all())
            diff = (got.float() - want.float())[fin].abs()
            if diff.numel():
                e = max(e, float(diff.max()))
                ok &= bool((diff <= tol * (1 + want.float()[fin].abs()))
                           .all())
        print(f"[{label}] {name} {what}: max abs err {e:.3e} (tol {tol:g} "
              f"x (1+|plain|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{name} disagrees with its plain version at {what}")
        err[name] = max(err[name], e)

    for i, shape in enumerate(k5_shapes):
        for dtype in (f32, bf16):
            q, kc, vc, pos = lm_kernel_inputs("flash_decode", shape, dtype,
                                              300 + i, dev)
            if shape[4] % 16 == 0:
                k8, v8 = kc.to(FP8), vc.to(FP8)
                for p_dtype in (FP8, dtype):
                    got = flash_decode(q, k8, v8, pos, p_dtype=p_dtype)
                    want = flash_decode_plain(q, k8, v8, pos, p_dtype=p_dtype)
                    torch.cuda.synchronize()
                    tol = (LM_TOL["flash_decode"][1] if p_dtype == FP8
                           else K5_BF16_TOL if dtype == bf16
                           else LM_TOL["flash_decode"][0])
                    close("flash_decode_fp8", [(got, want)], tol,
                          f"(B,S_max,H,Hkv,D,pos)={shape} "
                          f"{str(dtype)[6:]} P {str(p_dtype)[6:]}")
                del k8, v8
            pairs = []
            for n in (1, 2, 4):
                sl = -(-shape[1] // n)
                for r in range(n):
                    ks, vs = kc[:, r * sl:(r + 1) * sl], vc[:, r * sl:
                                                            (r + 1) * sl]
                    got = flash_decode_lse(q, ks, vs, pos, offset=r * sl,
                                           p_dtype=dtype)
                    want = flash_decode_lse_plain(q, ks, vs, pos,
                                                  offset=r * sl,
                                                  p_dtype=dtype)
                    pairs += list(zip(got, want))
            torch.cuda.synchronize()
            close("flash_decode_lse", pairs, K5_BF16_TOL if dtype == bf16
                  else LM_TOL["flash_decode"][0],
                  f"(B,S_max,H,Hkv,D,pos)={shape} "
                f"{str(dtype)[6:]}, out and lse over 1, 2 and 4 slices")
            del q, kc, vc, pairs
    torch.cuda.empty_cache()
    return err


def k6_fp32_distance(x, dt, bm, cm, a, qc, wy, wst):
    """The fp32 kernel fed bf16 inputs' values cast up: its largest
    distance from the plain version (``wy``, ``wst``, which computes in fp32
    from the same values) relative to the largest |y| and |state|. The bf16
    kernel does fp32 math when it lies no farther than about this."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    f32 = torch.float32
    y, st = ssd_scan(x.to(f32), dt, bm.to(f32), cm.to(f32), a, q_chunk=qc)
    torch.cuda.synchronize()
    return (float((y - wy).abs().max() / wy.abs().max()),
            float((st - wst).abs().max() / wst.abs().max()))


def reference_kv_bytes(cfg, batch: int, max_seq: int) -> int:
    """Bytes of the reference's decode cache (``repro/models/model.py::
    init_cache``) for ``cfg``: pos (int32), K and V per attention layer (in
    ``cfg.kv_dtype``), and per SSM layer the fp32 state and the convolution
    tail."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    kvd = 1 if cfg.kv_dtype == "float8_e4m3fn" else cd
    kv = 2 * cfg.n_attn_layers() * batch * max_seq * cfg.n_kv * cfg.head_dim
    state = cfg.n_ssm_layers() * batch * cfg.ssm_heads * cfg.ssm_head_dim \
        * cfg.ssm_state
    conv = cfg.n_ssm_layers() * batch * (cfg.ssm_conv - 1) \
        * (cfg.d_inner + 2 * cfg.ssm_state)
    return 4 + kvd * kv + 4 * state + cd * conv


def _lm_shape_recorder():
    """Wrap the model's kernel calls to count the shapes they pass: K4 as
    (B, S, H, Hkv, D), K5 as (B, S_max, H, Hkv, D) with the positions, K6
    as (B, H, S, P, N, Q). Reading ``pos`` costs a host sync per call, so
    this runs only where a step syncs anyway."""
    from collections import Counter
    from repro_torch.models import attention, ssm
    shapes = {"flash_attention": Counter(), "flash_decode": Counter(),
              "ssd_scan": Counter()}
    positions: dict = {}
    k4, k5, k6 = attention.flash_attention, attention.flash_decode, \
        ssm.ssd_scan

    def rec_k4(q, k, v, **kw):
        shapes["flash_attention"][(*q.shape[:3], k.shape[2], q.shape[3])] += 1
        return k4(q, k, v, **kw)

    def rec_k5(q, kc, vc, pos, **kw):
        key = (q.shape[0], kc.shape[1], q.shape[2], kc.shape[2], q.shape[3])
        shapes["flash_decode"][key] += 1
        positions.setdefault(key, set()).add(int(pos))
        return k5(q, kc, vc, pos, **kw)

    def rec_k6(x, dt, bm, cm, a, q_chunk):
        b, s, h, p = x.shape
        shapes["ssd_scan"][(b, h, s, p, bm.shape[2], q_chunk)] += 1
        return k6(x, dt, bm, cm, a, q_chunk=q_chunk)

    attention.flash_attention, attention.flash_decode = rec_k4, rec_k5
    ssm.ssd_scan = rec_k6

    def restore():
        attention.flash_attention, attention.flash_decode = k4, k5
        ssm.ssd_scan = k6
    return shapes, positions, restore


LM_KERNELS = ("flash_attention", "flash_decode", "ssd_scan")


class plain_kernels:
    """Within this block the model's K4, K5 and K6 calls take the plain
    versions on the card (the teacher-forced comparison's plain path); it
    fails if a kernel was launched inside it all the same."""

    def __enter__(self):
        from repro_torch.kernels import KERNEL_LAUNCHES
        self.before = [KERNEL_LAUNCHES[k] for k in LM_KERNELS]
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_plain
        from repro_torch.kernels.flash_decode.ref import flash_decode_plain
        from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain
        from repro_torch.models import attention, ssm
        self.saved = (attention.flash_attention, attention.flash_decode,
                      ssm.ssd_scan)
        attention.flash_attention = flash_attention_plain
        attention.flash_decode = flash_decode_plain
        ssm.ssd_scan = ssd_scan_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import KERNEL_LAUNCHES
        from repro_torch.models import attention, ssm
        (attention.flash_attention, attention.flash_decode,
         ssm.ssd_scan) = self.saved
        if exc[0] is None and \
                [KERNEL_LAUNCHES[k] for k in LM_KERNELS] != self.before:
            _fail("the plain path launched a kernel")
        return False


def serve_full_width() -> dict:
    """Phase 9: zamba2-7b at full width served on the card, 32 requests in
    4 batches of 8, with every launch counter zeroed just before."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import SizeyConfig
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.launch.sizing import KVCacheSizer
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.utils.misc import tree_bytes
    dev = torch.device(DEV)
    cfg = serve_config()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(LM_SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {SERVE_ARCH}: {cfg.param_count():,} parameters "
          f"({cfg.param_dtype}) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; compute {cfg.compute_dtype}")
    sizer = KVCacheSizer(SizeyConfig(min_history=2), device=dev)
    engine = ServeEngine(model, params, max_batch=SERVE_BATCH,
                         max_seq=SERVE_MAX_SEQ, temperature=SERVE_TEMPERATURE,
                         sizer=sizer, seed=LM_SEED, device=dev)
    del params
    rng = np.random.default_rng(LM_SEED)
    lens = rng.choice(SERVE_LENS, SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for i, n in enumerate(lens)]
    batches: list = []
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def prefill(p, batch, max_seq):
        nonlocal finite
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.prefill(p, batch, max_seq=max_seq)
        torch.cuda.synchronize()
        b, s = batch["tokens"].shape
        batches.append({"b": b, "s": s, "max_seq": max_seq,
                        "prefill_s": time.perf_counter() - t, "decode_s": 0.0,
                        "steps": 0, "kv_bytes": tree_bytes(cache)})
        finite = finite & torch.isfinite(logits).all()
        return logits, cache

    def decode_step(p, cache, tokens):
        nonlocal finite
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.decode_step(p, cache, tokens)
        torch.cuda.synchronize()
        batches[-1]["decode_s"] += time.perf_counter() - t
        batches[-1]["steps"] += 1
        finite = finite & torch.isfinite(logits).all()
        return logits, cache

    engine.model = dataclasses.replace(model, prefill=prefill,
                                       decode_step=decode_step)
    host = {"sample_s": 0.0, "sizer_s": 0.0}

    def timed(key, fn):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            host[key] += time.perf_counter() - t
            return out
        return run
    # the sampler's Gumbel draws run on the host (JAX's threefry bits); the
    # sizer predicts before and retrains after each batch
    engine._sample = timed("sample_s", engine._sample)
    sizer.before_batch = timed("sizer_s", sizer.before_batch)
    sizer.after_batch = timed("sizer_s", sizer.after_batch)
    shapes, positions, restore = _lm_shape_recorder()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        comps = engine.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_tok = sum(len(c.tokens) for c in comps)
    steps = sum(bt["steps"] for bt in batches)
    nb = len(batches)
    for i, bt in enumerate(batches):
        want = reference_kv_bytes(cfg, bt["b"], bt["max_seq"])
        dec = sizer.decisions[i]
        print(f"[serve] batch {i}: B={bt['b']} prompt {bt['s']} max_seq "
              f"{bt['max_seq']}: prefill {bt['prefill_s']:.3f} s, "
              f"{bt['steps']} decode steps {bt['decode_s']:.3f} s "
              f"({1e3 * bt['decode_s'] / max(bt['steps'], 1):.2f} ms/step); "
              f"kv_bytes {bt['kv_bytes']} ({bt['kv_bytes'] / 1024**3:.4f} "
              f"GiB; reference layout {want}); sizer {dec.source} "
              f"allocation {dec.allocation_gb:.4f} GB vs observed "
              f"{bt['kv_bytes'] / 1024**3:.4f} GB")
        if bt["kv_bytes"] != want:
            _fail(f"batch {i}: kv_bytes {bt['kv_bytes']} differs from the "
                  f"reference's cache layout ({want})")
    print(f"[serve] {len(comps)} requests, {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.3f} tokens/s; prefill "
          f"{sum(b['prefill_s'] for b in batches):.3f} s, decode "
          f"{sum(b['decode_s'] for b in batches):.3f} s over {steps} steps, "
          f"sampling {host['sample_s']:.3f} s over {steps + nb} draws, "
          f"sizer {host['sizer_s']:.3f} s); max_memory_allocated "
          f"{peak / 1024**3:.3f} GiB")
    print(f"[serve] kernel launches {launches}")
    for name, counts in shapes.items():
        print(f"[serve] {name} shapes: " + ", ".join(
            f"{s}x{c}" for s, c in counts.most_common()))
    n_attn, n_ssm = cfg.n_attn_layers(), cfg.n_ssm_layers()
    want = {"flash_attention": n_attn * nb, "ssd_scan": n_ssm * nb,
            "flash_decode": n_attn * steps}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            _fail(f"{name}: {launches.get(name, 0)} launches, expected {n}")
    for name in ("ensemble_mlp", "knn_predict"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was never launched by the KV-cache sizer")
    if not bool(finite):
        _fail("a logit of the serve run is not finite")
    if nb != SERVE_REQUESTS // SERVE_BATCH or n_tok != SERVE_REQUESTS \
            * SERVE_NEW:
        _fail(f"served {nb} batches and {n_tok} tokens")
    print(f"[serve] launches as expected: flash_attention {n_attn} x {nb} "
          f"batches, ssd_scan {n_ssm} x {nb}, flash_decode {n_attn} x "
          f"{steps} steps; every logit finite; every batch's kv_bytes the "
          f"reference layout's")
    return {"launches": launches, "shapes": shapes, "positions": positions,
            "run_params": engine._params, "model": model, "cfg": cfg,
            "wall_s": wall, "tokens": n_tok}


def teacher_forced(model, run_params) -> dict:
    """Phase 10: the kernel path against the plain path on the card, full
    width in bf16, fed the same tokens: prefill logits and TF_STEPS decode
    steps (the kernel path's greedy tokens fed to both). Returns the
    prompt, the tokens fed and the kernel path's last logits."""
    import numpy as np
    import torch
    dev = torch.device(DEV)
    cfg = model.cfg
    rng = np.random.default_rng(LM_SEED + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (TF_BATCH, TF_LEN))
                            .astype(np.int32)).to(dev)
    max_seq = TF_LEN + TF_STEPS
    lk, ck = model.prefill(run_params, {"tokens": toks}, max_seq=max_seq)
    with plain_kernels():
        lp, cp = model.prefill(run_params, {"tokens": toks}, max_seq=max_seq)
    rel, agree, n = [], 0, 0

    def compare(a, b):
        nonlocal agree, n
        a, b = a[..., :cfg.vocab], b[..., :cfg.vocab]
        rel.append(float((a - b).abs().max() / b.abs().max()))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        n += a.shape[0]
    compare(lk[:, -1], lp[:, -1])
    feed = []
    for _ in range(TF_STEPS):
        tok = lk[:, -1].argmax(-1)[:, None]
        feed.append(tok)
        lk, ck = model.decode_step(run_params, ck, tok)
        with plain_kernels():
            lp, cp = model.decode_step(run_params, cp, tok)
        compare(lk[:, -1], lp[:, -1])
    torch.cuda.synchronize()
    print(f"[forced] {SERVE_ARCH} full width bf16, B={TF_BATCH} prompt "
          f"{TF_LEN}, prefill + {TF_STEPS} decode steps, kernel path vs "
          f"plain path fed the same tokens: largest |logit diff| / largest "
          f"|logit| per step {', '.join(f'{r:.3e}' for r in rel)} (tol "
          f"{TF_RTOL:g}); argmax agreement {agree}/{n} "
          f"({agree / n:.4f})")
    if max(rel) > TF_RTOL:
        _fail("the kernel path's logits differ from the plain path's")
    del ck, cp
    torch.cuda.empty_cache()
    return {"tokens": toks, "feed": feed, "logits": lk[:, -1, :cfg.vocab]}


def serve_fp8(model, run_params, forced) -> dict:
    """Phase 9 (b): the serve cell's model on an e4m3 KV cache
    (``kv_dtype="float8_e4m3fn"``), full width, its bf16 weights: phase
    10's prefill of TF_BATCH x TF_LEN tokens and its TF_STEPS decode
    steps, fed its greedy tokens (``forced``, ``teacher_forced``'s), with
    every launch counter zeroed just before and read just after (K5 on the
    e4m3 cache once per attention layer a step). Each of those K5 calls
    is held, on the inputs the path gave it, to its plain version with P
    in the query's type (the model's function) within K5_BF16_TOL x (1 +
    |plain|), and must lie nearer it, in mean |difference| over every
    call's output, than the plain version with P in the cache's type (the
    TPU kernel's function). The logits' distance from phase 10's
    kernel-path run on the bf16 cache is printed and held to TF_RTOL (the
    cache rounds K and V to 4 significant bits), every logit finite, and
    the cache's bytes the reference layout's."""
    import dataclasses
    import torch
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.kernels.flash_decode.ref import flash_decode_plain
    from repro_torch.models import attention, build_model
    from repro_torch.utils.misc import tree_bytes
    dev = torch.device(DEV)
    cfg = model.cfg
    fp8 = build_model(dataclasses.replace(cfg, kv_dtype="float8_e4m3fn"))
    toks, feed = forced["tokens"], forced["feed"]
    max_seq = TF_LEN + TF_STEPS
    k5, held = attention.flash_decode, []

    def checked(q, kc, vc, pos, **kw):
        """The path's K5 launch, then its plain versions on its inputs:
        (largest |difference|, elements beyond the limit, mean
        |difference|, mean |difference| from P in the cache's type)."""
        o = k5(q, kc, vc, pos, **kw)
        want = flash_decode_plain(q, kc, vc, pos, **kw).float()
        other = flash_decode_plain(q, kc, vc, pos,
                                   **{**kw, "p_dtype": kc.dtype}).float()
        d = (o.float() - want).abs()
        held.append(torch.stack([
            d.max(), (d > K5_BF16_TOL * (1 + want.abs())).sum().float(),
            d.mean(), (o.float() - other).abs().mean()]))
        return o
    torch.cuda.synchronize()
    reset_launch_counts()
    attention.flash_decode = checked
    try:
        t0 = time.perf_counter()
        l8, c8 = fp8.prefill(run_params, {"tokens": toks}, max_seq=max_seq)
        finite = bool(torch.isfinite(l8).all())
        for tok in feed:
            l8, c8 = fp8.decode_step(run_params, c8, tok)
            finite &= bool(torch.isfinite(l8).all())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attention.flash_decode = k5
    launches = dict(KERNEL_LAUNCHES)
    k5_err, k5_over, k5_same, k5_other = torch.stack(held).cpu().T.tolist()
    k5_err, k5_over = max(k5_err), int(sum(k5_over))
    nearer = sum(k5_same) / max(sum(k5_other), 1e-30)
    a, b = l8[:, -1, :cfg.vocab].float(), forced["logits"].float()
    rel = float((a - b).abs().max() / b.abs().max())
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    kv_bytes = tree_bytes(c8)
    want_bytes = reference_kv_bytes(fp8.cfg, TF_BATCH, max_seq)
    try:
        probe = torch.zeros((1, 4, 1, 16), dtype=c8["k"].dtype, device=dev)
        probe.index_copy_(1, torch.tensor([1], device=dev),
                          probe[:, :1].clone())
        copy_note = "takes e4m3"
    except (NotImplementedError, RuntimeError) as e:
        copy_note = f"refuses e4m3 ({type(e).__name__}): written as bytes"
    want = {"flash_decode_fp8": cfg.n_attn_layers() * TF_STEPS,
            "flash_attention": cfg.n_attn_layers(),
            "ssd_scan": cfg.n_ssm_layers()}
    print(f"[serve fp8] {SERVE_ARCH} full width bf16 on an e4m3 cache: B="
          f"{TF_BATCH} prompt {TF_LEN}, prefill + {TF_STEPS} decode "
          f"steps fed phase 10's greedy tokens in {wall:.3f} s (its K5 "
          f"calls held to their plain versions inside); last step's "
          f"largest |logit diff| / largest |logit| against phase 10's "
          f"bf16-cache run {rel:.3e} (tol {TF_RTOL:g}); argmax agreement "
          f"{agree}/{TF_BATCH}; cache {kv_bytes} bytes (reference layout "
          f"{want_bytes}); launches {launches}; the card's index_copy_ "
          f"{copy_note}")
    print(f"[serve fp8] K5 on the e4m3 cache, {len(held)} calls on the "
          f"path's own inputs: max abs err {k5_err:.3e} against the plain "
          f"version with P in the query's type ({k5_over} elements beyond "
          f"{K5_BF16_TOL:g} x (1+|plain|)); mean |diff| {sum(k5_same) / len(held):.3e} "
          f"against it, {sum(k5_other) / len(held):.3e} against P in the "
          f"cache's type (ratio {nearer:.3f}, must be < 1)")
    if not finite or rel > TF_RTOL:
        _fail("the e4m3-cache serve's logits are not finite or too far")
    if k5_over or nearer >= 1:
        _fail("K5 on the e4m3 cache disagrees with its plain version on "
              "the serve's inputs")
    if kv_bytes != want_bytes:
        _fail(f"the e4m3 cache holds {kv_bytes} bytes, not {want_bytes}")
    for name, n in want.items():
        if launches.get(name, 0) != n:
            _fail(f"{name}: {launches.get(name, 0)} launches on the e4m3 "
                  f"serve, expected {n}")
    if launches.get("flash_decode", 0) or launches.get("flash_decode_lse", 0):
        _fail("the e4m3 serve launched K5 on a bf16 cache")
    del c8
    torch.cuda.empty_cache()
    return {"launches": launches, "rel": rel, "max_abs_err": k5_err}


def to_cpu(tree):
    """A parameter tree's tensors copied to the CPU."""
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def lm_card_vs_cpu() -> None:
    """Phase 11: the same port on the card and on the CPU, zamba2-7b at
    full width cut to CVC_LAYERS layer positions, compute fp32: greedy
    tokens through the ServeEngine equal, and teacher-forced logits within
    CVC_RTOL of the largest."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = cvc_config()
    model = build_model(cfg)
    pg = model.init(LM_SEED, device=DEV)
    pc = to_cpu(pg)
    rng = np.random.default_rng(LM_SEED + 2)
    prompts = [rng.integers(0, cfg.vocab, CVC_LEN).astype(np.int32)
               for _ in range(CVC_BATCH)]
    out = {}
    for dev, p in ((DEV, pg), ("cpu", pc)):
        eng = ServeEngine(model, p, max_batch=CVC_BATCH, max_seq=SERVE_MAX_SEQ,
                          temperature=0.0, device=dev)
        t = time.perf_counter()
        out[dev] = [c.tokens.tolist() for c in eng.serve(
            [Request(i, pr, max_new_tokens=CVC_NEW)
             for i, pr in enumerate(prompts)])]
        out[dev + "_s"] = time.perf_counter() - t
    toks = torch.from_numpy(np.stack(prompts))
    rel = []
    lg, cg = model.prefill(pg, {"tokens": toks.to(DEV)},
                           max_seq=CVC_LEN + CVC_NEW)
    lc, cc = model.prefill(pc, {"tokens": toks}, max_seq=CVC_LEN + CVC_NEW)
    for step in range(CVC_NEW):
        a, b = lg[:, -1, :cfg.vocab].cpu(), lc[:, -1, :cfg.vocab]
        rel.append(float((a - b).abs().max() / b.abs().max()))
        if step + 1 < CVC_NEW:
            tok = torch.tensor([[out[DEV][i][step]]
                                for i in range(CVC_BATCH)], dtype=torch.int32)
            lg, cg = model.decode_step(pg, cg, tok.to(DEV))
            lc, cc = model.decode_step(pc, cc, tok)
    same = out[DEV] == out["cpu"]
    print(f"[cpu] {SERVE_ARCH} full width, {cfg.n_layers} layer positions "
          f"({cfg.n_ssm_layers()} Mamba2 + {cfg.n_attn_layers()} shared), "
          f"fp32, B={CVC_BATCH} prompt {CVC_LEN}, {CVC_NEW} greedy tokens: "
          f"card {out[DEV + '_s']:.2f} s, CPU {out['cpu_s']:.2f} s; tokens "
          f"{'equal' if same else 'DIFFER'}; largest |logit diff| / largest "
          f"|logit| per step {', '.join(f'{r:.3e}' for r in rel)} (tol "
          f"{CVC_RTOL:g})")
    if not same or max(rel) > CVC_RTOL:
        _fail("the card and the CPU disagree on the LM path")


def time_lm_kernels(k4_shape, k5_shape, k6_shape) -> dict:
    """K4, K5 (on the bf16 cache, on it cast to e4m3, and its log-sum-exp
    variant) and K6 at the given full-width bf16 shapes beside their plain
    versions and, for K4 and K5, one call of PyTorch's
    scaled_dot_product_attention (causal; one query over a masked cache)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.flash_decode.ops import (FP8, flash_decode,
                                                      flash_decode_lse)
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_lse_plain, flash_decode_plain)
    from repro_torch.analysis import kernel_costs as costs
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain
    dev = torch.device(DEV)
    bf16 = torch.bfloat16
    rows = {}

    def gqa(h, hkv):
        return {"enable_gqa": True} if h != hkv else {}
    q, k, v = lm_kernel_inputs("flash_attention", k4_shape, bf16, 7, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, by = costs.k4_bound(*k4_shape, 2)
    rows["flash_attention"] = {
        "ms": _time_ms(lambda: flash_attention(q, k, v), 10, 3),
        "plain_ms": _time_ms(lambda: flash_attention_plain(q, k, v), 5, 2),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa(k4_shape[2], k4_shape[3])),
            10, 3)}
    del q, k, v, qt, kt, vt
    q, kc, vc, pos = lm_kernel_inputs("flash_decode", k5_shape, bf16, 8, dev)
    mask = (torch.arange(k5_shape[1], device=dev) <= pos)[None, None, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
    bound, by = costs.k5_bound(k5_shape[0], k5_shape[2], k5_shape[3],
                          k5_shape[4], k5_shape[5], 2)
    rows["flash_decode"] = {
        "ms": _time_ms(lambda: flash_decode(q, kc, vc, pos), 30, 10),
        "plain_ms": _time_ms(lambda: flash_decode_plain(q, kc, vc, pos),
                             10, 5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, **gqa(k5_shape[2], k5_shape[3])),
            30, 10)}
    # K5 on an e4m3 cache as the model calls it (P rounded to bf16), its
    # library yardstick the same call on the cache widened to bf16 first
    # (the widening timed with it); K5's log-sum-exp variant on the bf16
    # cache (the fp32 output and each row's log-sum-exp), beside the one
    # PyTorch call that returns both, the memory-efficient attention
    b, _smax, h, hkv, d, pos5 = k5_shape
    k8, v8 = kc.to(FP8), vc.to(FP8)
    rows["flash_decode_fp8"] = {
        "ms": _time_ms(lambda: flash_decode(q, k8, v8, pos, p_dtype=bf16),
                       30, 10),
        "plain_ms": _time_ms(lambda: flash_decode_plain(
            q, k8, v8, pos, p_dtype=bf16), 10, 5),
        **dict(zip(("bound_ms", "bound_by"), costs.bound_at(
            *costs.k5_work(b, h, hkv, d, pos5 + 1, 2, 1),
            costs.PEAK_FLOPS_BF16))),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, k8.to(bf16).transpose(1, 2), v8.to(bf16).transpose(1, 2),
            attn_mask=mask, **gqa(h, hkv)), 30, 10)}
    # a call's device time apart (the profiler's kernel time): a host that
    # launches slower than the kernel runs makes the per-call time the
    # host's
    dev_ms = {
        "flash_decode": _device_ms(lambda: flash_decode(q, kc, vc, pos),
                                   "flash_decode_split_kernel"),
        "flash_decode_fp8": _device_ms(lambda: flash_decode(
            q, k8, v8, pos, p_dtype=bf16), "flash_decode_split_kernel"),
        "flash_decode_lse": _device_ms(lambda: flash_decode_lse(
            q, kc, vc, pos, p_dtype=bf16), "flash_decode_split_kernel")}
    print("[time] K5's device time a call (torch.profiler): " + ", ".join(
        f"{k} {_fmt_ms(v)}" for k, v in dev_ms.items()))
    del k8, v8
    rows["flash_decode_lse"] = {
        "ms": _time_ms(lambda: flash_decode_lse(q, kc, vc, pos,
                                                p_dtype=bf16), 30, 10),
        "plain_ms": _time_ms(lambda: flash_decode_lse_plain(
            q, kc, vc, pos, p_dtype=bf16), 10, 5),
        **dict(zip(("bound_ms", "bound_by"), costs.bound_at(
            *costs.k5_work(b, h, hkv, d, pos5 + 1, 2, lse=True),
            costs.PEAK_FLOPS_BF16))),
        "library_ms": None}
    if h == hkv:
        bias = torch.zeros((b, h, 1, k5_shape[1]), dtype=bf16, device=dev) \
            .masked_fill(~mask, float("-inf"))
        try:
            rows["flash_decode_lse"]["library_ms"] = _time_ms(
                lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                    qt, kt, vt, bias, True), 30, 10)
        except RuntimeError as e:      # a yardstick only: none is recorded
            print(f"[time] the memory-efficient attention refused the "
                  f"shape: {str(e)[:200]}")
    del q, kc, vc, qt, kt, vt
    x, dt, bm, cm, a = lm_kernel_inputs("ssd_scan", k6_shape, bf16, 9, dev)
    qc = k6_shape[5]
    bound, by = costs.k6_bound(*k6_shape, 2)
    rows["ssd_scan"] = {
        "ms": _time_ms(lambda: ssd_scan(x, dt, bm, cm, a, q_chunk=qc), 10, 3),
        "plain_ms": _time_ms(lambda: ssd_scan_plain(x, dt, bm, cm, a,
                                                    q_chunk=qc), 5, 2),
        "bound_ms": bound, "bound_by": by, "library_ms": None}
    (y, st), (wy, wst) = (ssd_scan(x, dt, bm, cm, a, q_chunk=qc),
                          ssd_scan_plain(x, dt, bm, cm, a, q_chunk=qc))
    k6_err = max(float((y - wy).abs().max()), float((st - wst).abs().max()))
    k6_rel = float((y - wy).abs().max() / wy.abs().max())
    k6_rel32, _ = k6_fp32_distance(x, dt, bm, cm, a, qc, wy, wst)
    del x, dt, bm, cm, a, y, st, wy, wst
    torch.cuda.empty_cache()
    for name, shape in (("flash_attention", k4_shape),
                        ("flash_decode", k5_shape),
                        ("flash_decode_fp8", k5_shape),
                        ("flash_decode_lse", k5_shape), ("ssd_scan", k6_shape)):
        r = rows[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        print(f"[time] {name} {shape} bf16: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib}, bound "
              f"{r['bound_ms']:.3e} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of the bound")
    r = rows["ssd_scan"]
    k6_bytes = costs.k6_work(*k6_shape, 2)[0]
    fp32_bound, _ = costs.k6_bound_fp32_rate(*k6_shape, 2)
    print(f"[time] ssd_scan {k6_shape} bf16: {k6_bytes / r['ms'] / 1e6:.1f} "
          f"GB/s of its {k6_bytes / 1e6:.1f} MB; bound {r['bound_ms']:.4f} "
          f"ms at the tensor-core and HBM rates, {fp32_bound:.4f} ms with "
          f"the products at the fp32 CUDA-core rate; largest |kernel - "
          f"plain| {k6_err:.3e} ({k6_rel:.3e} of the largest |y|; the fp32 "
          f"kernel fed the same values {k6_rel32:.3e}, tol for bf16 twice "
          f"that)")
    if k6_rel > 2 * k6_rel32:
        _fail(f"ssd_scan in bf16 at {k6_shape} lies {k6_rel:.3e} of the "
              f"largest |y| from its plain version, more than twice the fp32 "
              f"kernel's {k6_rel32:.3e}: not fp32 math")
    # the achieved rates of K4 (operations) and K5 (bytes), as the bounds
    # count them
    b, s, h, hkv, d = k4_shape
    k4_flops = 4 * b * h * (s * (s + 1) // 2) * d
    b, _smax, h, hkv, d, pos = k5_shape
    k5_bytes = 2 * (2 * b * (pos + 1) * hkv * d + 2 * b * h * d)
    for name, what, amount, unit in (
            ("flash_attention", "causal products", k4_flops, "TFLOP/s"),
            ("flash_decode", "live cache and query bytes", k5_bytes, "GB/s")):
        r = rows[name]
        scale = 1e9 if unit == "TFLOP/s" else 1e6
        print(f"[time] {name}: {amount / r['ms'] / scale:.1f} {unit} of "
              f"{what} (kernel), {amount / r['library_ms'] / scale:.1f} "
              f"(library); {r['library_ms'] / r['ms']:.3f}x the library's "
              f"speed")
    return rows


def lm_phases() -> tuple[list, object]:
    """Phases 8-12 of the LM serving slice; returns its JSON rows (K5's
    log-sum-exp variant's launches are phase 16 (b)'s, filled in there)
    and phase 12, the kernels' timing, as a function that completes the
    rows, to be called once nothing else runs on the card."""
    import torch
    errors = check_lm_kernels(K4_SHAPES, K5_SHAPES, K6_SHAPES)
    errors.update(check_k5_variants(K5_SHAPES))
    serve = serve_full_width()
    model, run_params = serve.pop("model"), serve.pop("run_params")
    fp8 = serve_fp8(model, run_params, teacher_forced(model, run_params))
    del model, run_params
    torch.cuda.empty_cache()
    # every shape the serve phase launched, K5 at its first and last pos
    shapes, positions = serve["shapes"], serve["positions"]
    k5 = [(*s, p) for s in shapes["flash_decode"]
          for p in sorted({min(positions[s]), max(positions[s])})]
    more = check_lm_kernels(sorted(shapes["flash_attention"]), sorted(k5),
                            sorted(shapes["ssd_scan"]), label="check serve")
    more.update(check_k5_variants(sorted(k5), label="check serve"))
    errors = {k: max(v, more[k]) for k, v in errors.items()}
    errors["flash_decode_fp8"] = max(errors["flash_decode_fp8"],
                                     fp8["max_abs_err"])
    lm_card_vs_cpu()

    def heaviest(name):   # the most launched shape; on a tie the largest
        return max(shapes[name].items(), key=lambda kv: (kv[1], kv[0]))[0]
    k4s, k5key, k6s = (heaviest("flash_attention"), heaviest("flash_decode"),
                       heaviest("ssd_scan"))
    pos = sorted(positions[k5key])[len(positions[k5key]) // 2]
    src = {"flash_attention": ("flash_attention", 70),
           "flash_decode": ("flash_decode", 61),
           "flash_decode_fp8": ("flash_decode", 61),
           "flash_decode_lse": ("flash_decode", 61),
           "ssd_scan": ("ssd_scan", 71)}
    launches = {**serve["launches"], "flash_decode_fp8":
                fp8["launches"]["flash_decode_fp8"], "flash_decode_lse": 0}
    rows = [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/{pkg}/kernel.cu",
             "replaces": f"src/repro/kernels/{pkg}/kernel.py:{line}",
             "launches": launches[name], "max_abs_err": errors[name]}
            for name, (pkg, line) in src.items()]

    def time_rows():
        timings = time_lm_kernels(k4s, (*k5key, pos), k6s)
        print(f"[time] LM JSON rows at the most launched full-width shapes "
              f"(ties to the largest): flash_attention {k4s}, flash_decode "
              f"{k5key} at the median launched pos {pos}, ssd_scan {k6s}")
        for row in rows:
            row.update(timings[row["name"]])
    return rows, time_rows


# ----------------------------------------------------------- phase 15
# Training on the card (after 14 and the LM phases): K4's and K6's backward
# against the plain backward; the OOM ladder and a killed run's restart at
# e2e-100m; granite-3-2b at full width and depth through launch.train
# --sizey, sized by the models that (c)'s jobs trained; mamba2-780m at full
# width and depth and zamba2-7b at full width cut in depth (f); card vs CPU
# at the reduced configs; phi3.5-moe and internvl2-26b at full width cut in
# depth.
TRAIN_ARCH = "granite-3-2b"
TRAIN_FULL_STEPS = 6
TRAIN_FULL_ARGV = ["--arch", TRAIN_ARCH, "--scale", "full", "--steps",
                   str(TRAIN_FULL_STEPS), "--batch", "8", "--seq", "256",
                   "--sizey"]
# (c): two e2e-100m jobs through launch.train --sizey with a sizer whose
# preset (0.5 GB) is below their footprint (1.32 GiB): the first is killed
# by SimulatedOOM and climbs the ladder (max observed, then doubling), the
# second retries at the first's footprint; both are observed, so the
# granite-3-2b/train pool has the 2 jobs of history (min_history) that
# size (b) with the models
LADDER_PRESET_GB = 0.5
LADDER_ARGV = ["--arch", TRAIN_ARCH, "--scale", "e2e-100m", "--steps", "2",
               "--batch", "8", "--seq", "256", "--sizey"]
RESTART_STEPS, RESTART_EVERY, RESTART_KILL = 6, 3, 4
# K4's backward at the reference's attention test shapes (K4_SHAPES) and at
# groups of 6 and 8 query heads a KV head, each fp32 and bf16, causal and
# not, all keys and kv_len = S - 37; then at every shape (b)-(e) launched.
# Tolerance: the largest |kernel - plain| over the largest |plain| of each
# gradient. fp32 2e-5 (summation order: at most ~1e-6 on a CPU rehearsal of
# the kernels); bf16 3e-2 (the gradients are rounded to bf16, 3.9e-3, and
# the kernel's forward rounds P at its running maximum and the plain
# version at the row's: ~7e-3 on the CPU rehearsal)
K4_BWD_SHAPES = K4_SHAPES + [(1, 256, 12, 2, 64), (1, 256, 8, 1, 128)]
K4_BWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# K6's backward at the reference's scan test shapes (K6_SHAPES, (B, H, S,
# P, N, Q): a ragged last chunk at S = 200, N = 128) and at the two
# training shapes of (f), mamba2-780m's and zamba2-7b's, fp32 and bf16,
# with and without a gradient of the final state; x, B and C are strided
# slices of one tensor, as the convolution gives them. Tolerance: the
# largest |kernel - plain| over the largest |plain| of each gradient, the
# plain backward computed in fp64, so that the measure is the kernel's own
# rounding. fp32 2e-5 (summation order: at most 6.6e-6 on a CPU rehearsal
# of the kernel and 8.11e-6 on an H100, where the fp32 plain backward
# itself lies up to 1.1e-5 from fp64 in da, a sum over every position);
# bf16 3e-2 (dx, dB and dC are rounded to bf16, 3.9e-3, as K4's; 3.77e-3
# on an H100)
K6_TRAIN_SHAPES = [(8, 48, 1024, 64, 128, 128), (2, 112, 1024, 64, 64, 128)]
K6_BWD_SHAPES = K6_SHAPES + K6_TRAIN_SHAPES
K6_BWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# (f): mamba2-780m at full width and depth through launch.train, batch 8 x
# 1,024 (8 chunks of 128, so the inter-chunk recurrence and its reverse
# run), 6 steps; zamba2-7b at full width cut to 6 layer positions (4 Mamba2
# layers and 2 applications of the shared attention block: its 81
# positions' fp32 parameters, gradients and AdamW state pass 74 GB), batch
# 2 x 1,024, 3 steps
SSM_ARGV = ["--arch", "mamba2-780m", "--scale", "full", "--steps", "6",
            "--batch", "8", "--seq", "1024"]
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_BATCH, HYBRID_STEPS = "zamba2-7b", 6, 2, 3
# (d): the reduced configs in fp32, 3 steps on the card and on the CPU from
# the same parameters: losses and gradient norms within 1e-3 relative
# (AdamW's first update g / (|g| + eps) turns the 1e-7 differences of tiny
# gradients into visible ones, 1.3e-2 x lr in a weight between the
# packages on a CPU, tests/test_torch_train.py), 1e-2 with int8 gradients
# (an element that rounds to another int8 step flips its update)
CVC_TRAIN_ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                   "zamba2-7b")
CVC_TRAIN_RTOL = {False: 1e-3, True: 1e-2}
MOE_ARCH, MOE_TRAIN_LAYERS, MOE_SERVE_LAYERS = "phi3.5-moe-42b-a6.6b", 2, 16
MOE_TRAIN_BATCH, MOE_SERVE_NEW = 2, 16
MOE_SERVE_LENS = (256, 512)
VLM_ARCH, VLM_LAYERS, VLM_BATCH, VLM_TEXT = "internvl2-26b", 2, 2, 256
K4_TRAIN_KERNELS = ("flash_attention", "flash_attention_lse",
                    "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
TRAIN_KERNELS = K4_TRAIN_KERNELS + ("ssd_scan", "ssd_scan_bwd")


def _grad_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def check_k4_backward(shapes, label="bwd") -> float:
    """K4's backward (through the autograd Function, as training calls it)
    against the plain backward on the card: fp32 and bf16, causal and not,
    kv_len = S and S - 37; a repeat on the same inputs bitwise equal; the
    training forward's output bitwise the serving kernel's; and the
    serving call (no gradient) launching the original kernel, not the LSE
    variant. Returns the largest absolute difference."""
    import torch
    from repro_torch.kernels import KERNEL_LAUNCHES
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_backward_plain
    dev = torch.device(DEV)
    worst = 0.0
    for i, shape in enumerate(shapes):
        b, s, h, hkv, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = lm_kernel_inputs("flash_attention", shape, dtype,
                                       100 + i, dev)
            dout = _gen_inputs(200 + i, dev)(b, s, h, d, dtype=dtype)
            tol = K4_BWD_TOL[str(dtype)[6:]]
            for causal in (True, False):
                for kv_len in sorted({s, max(1, s - 37)}):
                    before = {n: KERNEL_LAUNCHES[n]
                              for n in K4_TRAIN_KERNELS}
                    runs = []
                    for _ in range(2):
                        leaves = [t.clone().requires_grad_()
                                  for t in (q, k, v)]
                        out = flash_attention(*leaves, causal=causal,
                                              kv_len=kv_len)
                        runs.append((out.detach(), *torch.autograd.grad(
                            out, leaves, dout)))
                    with torch.no_grad():
                        served = flash_attention(q, k, v, causal=causal,
                                                 kv_len=kv_len)
                    want = flash_attention_backward_plain(
                        q, k, v, dout, causal=causal, kv_len=kv_len)
                    torch.cuda.synchronize()
                    moved = {n: KERNEL_LAUNCHES[n] - before[n]
                             for n in K4_TRAIN_KERNELS}
                    what = (f"(B,S,H,Hkv,D)={shape} {str(dtype)[6:]} "
                            f"causal={causal} kv_len={kv_len}")
                    if moved != {"flash_attention": 1,
                                 "flash_attention_lse": 2,
                                 "flash_attention_bwd_dq": 2,
                                 "flash_attention_bwd_dkdv": 2}:
                        _fail(f"K4 backward {what}: launches {moved}")
                    if not all(torch.equal(x, y)
                               for x, y in zip(runs[0], runs[1])):
                        _fail(f"K4 backward {what}: a repeat differs")
                    if not torch.equal(runs[0][0], served):
                        _fail(f"K4 {what}: the training forward's output "
                              f"is not the serving kernel's")
                    errs = [_grad_err(g, w) for g, w in zip(runs[0][1:],
                                                            want)]
                    if any(g.dtype != dtype for g in runs[0][1:]):
                        _fail(f"K4 backward {what}: gradients not in "
                              f"{dtype}")
                    worst = max(worst, *(float((g.float() - w.float())
                                               .abs().max())
                                         for g, w in zip(runs[0][1:], want)))
                    ok = max(errs) <= tol
                    print(f"[{label}] flash_attention_bwd {what}: dq dk dv "
                          f"{errs[0]:.2e} {errs[1]:.2e} {errs[2]:.2e} of "
                          f"the largest (tol {tol:g}), repeat bitwise "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        _fail(f"K4 backward disagrees with the plain "
                              f"backward at {what}")
    return worst


def _k6_grad_inputs(shape, dtype, seed, dev):
    """K6's inputs as the model gives them: x, B and C strided slices of
    one (B, S, H P + 2 N) tensor ``xbc``; dt, a; and dy, dfinal fp32."""
    import torch
    b, h, s, p, n, _q = shape
    randn = _gen_inputs(seed, dev)
    xbc = torch.cat([randn(b, s, h * p), randn(b, s, 2 * n, scale=0.5)],
                    -1).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h) - 1.0)
    a = -torch.exp(torch.linspace(-1.0, 0.5, h, device=dev))
    return xbc, dt, a, randn(b, s, h, p), randn(b, h, p, n)


def _k6_split(xbc, shape):
    b, h, s, p, n, _q = shape
    return (xbc[..., :h * p].view(b, s, h, p), xbc[..., h * p:h * p + n],
            xbc[..., h * p + n:])


def check_k6_backward(shapes, label="bwd") -> float:
    """K6's backward (through the autograd Function, as training calls it,
    the gradients flowing into the strided slices of one tensor) against
    the plain backward in fp64 on the card: fp32 and bf16, with and without
    a gradient of the final state; a repeat bitwise; the kernel's own
    outputs in the promised types and bitwise what autograd received; the
    training forward's output bitwise the serving call's, which launches
    the serving kernel once. Returns the largest absolute difference."""
    import torch
    from repro_torch.kernels import KERNEL_LAUNCHES
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_backward_plain
    dev = torch.device(DEV)
    names = ("dx", "ddt", "dB", "dC", "da")
    worst = 0.0
    for i, shape in enumerate(shapes):
        b, h, s, p, n, q = shape
        for dtype in (torch.float32, torch.bfloat16):
            xbc, dt, a, dy, dfin = _k6_grad_inputs(shape, dtype, 300 + i, dev)
            tol = K6_BWD_TOL[str(dtype)[6:]]
            for fin in (False, True):
                df = dfin if fin else None
                before = {k: KERNEL_LAUNCHES[k] for k in ("ssd_scan",
                                                          "ssd_scan_bwd")}
                runs = []
                for _ in range(2):
                    leaves = [t.clone().requires_grad_() for t in (xbc, dt, a)]
                    x, bm, cm = _k6_split(leaves[0], shape)
                    y, st = ops.ssd_scan(x, leaves[1], bm, cm, leaves[2],
                                         q_chunk=q)
                    outs, gouts = ([y, st], [dy, df]) if fin else ([y], [dy])
                    gx, gdt, ga = torch.autograd.grad(outs, leaves, gouts)
                    gxh, gb, gc = _k6_split(gx, shape)
                    runs.append((y.detach(), gxh, gdt, gb, gc, ga))
                x, bm, cm = _k6_split(xbc, shape)
                with torch.no_grad():
                    served, _ = ops.ssd_scan(x, dt, bm, cm, a, q_chunk=q)
                direct = ops._launch_backward(x, dt, bm, cm, a, dy, df, q)
                want = ssd_scan_backward_plain(x, dt, bm, cm, a, dy, df,
                                               q_chunk=q, dtype=torch.float64)
                torch.cuda.synchronize()
                moved = {k: KERNEL_LAUNCHES[k] - v for k, v in before.items()}
                what = (f"(B,H,S,P,N,Q)={shape} {str(dtype)[6:]} "
                        f"dfinal={'yes' if fin else 'none'}")
                if moved != {"ssd_scan": 3, "ssd_scan_bwd": 3}:
                    _fail(f"K6 backward {what}: launches {moved}")
                if not all(torch.equal(u, v) for u, v in zip(runs[0],
                                                             runs[1])):
                    _fail(f"K6 backward {what}: a repeat differs")
                # dB and dC reach xbc's gradient through autograd's sum of
                # the slices' gradients: bitwise the kernel's own outputs
                got = runs[0][1:]
                if not all(torch.equal(u, v.reshape(u.shape))
                           for u, v in zip(got, direct)):
                    _fail(f"K6 backward {what}: autograd's gradients are not "
                          f"the kernel's outputs")
                kinds = [t.dtype for t in direct]
                if kinds != [dtype, torch.float32, dtype, dtype,
                             torch.float32]:
                    _fail(f"K6 backward {what}: gradients in {kinds}")
                if not torch.equal(runs[0][0], served):
                    _fail(f"K6 {what}: the training forward's output is not "
                          f"the serving kernel's")
                errs = [_grad_err(g, w) for g, w in zip(got, want)]
                worst = max(worst, *(float((g.double() - w).abs().max())
                                     for g, w in zip(got, want)))
                ok = max(errs) <= tol
                print(f"[{label}] ssd_scan_bwd {what}: "
                      + " ".join(f"{nm} {e:.2e}" for nm, e in zip(names,
                                                                  errs))
                      + f" of the largest (tol {tol:g}), repeat bitwise "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    _fail(f"K6 backward disagrees with the plain backward "
                          f"at {what}")
                del runs, direct, want
        torch.cuda.empty_cache()
    return worst


class _LaunchWatch:
    """Counts K1/K2/K4 launches and train steps inside a ``with`` block:
    zeroes every counter on entry, wraps ``make_train_step`` in the loop
    so each step is counted and each trainer's first parameters are kept
    (a few values), and records K4's shapes."""

    def __enter__(self):
        from repro_torch.kernels import reset_launch_counts
        from repro_torch.train import loop
        self.loop, self.real = loop, loop.make_train_step
        self.steps, self.first = 0, []
        watch = self

        def counted(*a, **kw):
            fn = watch.real(*a, **kw)
            seen = []

            def step(params, opt_state, batch):
                if not seen:
                    seen.append(1)
                    watch.first.append(_param_probe(params).clone())
                watch.steps += 1
                return fn(params, opt_state, batch)
            return step
        loop.make_train_step = counted
        self.shapes, _, self.restore = _lm_shape_recorder()
        reset_launch_counts()
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import KERNEL_LAUNCHES
        self.loop.make_train_step = self.real
        self.restore()
        self.launches = dict(KERNEL_LAUNCHES)
        return False


PROBED = (("blocks", "attn", "wq"), ("blocks", "ssm", "in_proj"),
          ("mamba", "ssm", "in_proj"), ("shared", "attn", "wq"),
          ("blocks", "moe", "we_gate"))


def _param_probe(params):
    """A few parameter values from the first layer's query projection (or
    Mamba2 input projection), the first expert's gate and the final norm:
    enough to see them move."""
    import torch
    parts = [params["ln_f"][:64].float()]
    for path in PROBED:
        t = params
        for k in path:
            t = t.get(k) if isinstance(t, dict) else None
        if t is not None:
            parts.append(t.reshape(-1)[:64].float())
    return torch.cat(parts)


def _launches_want(n_layers, remat_factor, n_ssm, steps) -> dict:
    """K4's training forward once per attention layer per step
    (remat_factor times: 2 under remat "block"), each backward kernel
    once; the serving forward never. K6's forward (the same launch with a
    gradient or without) remat_factor times per Mamba2 layer per step, its
    backward once."""
    return {"flash_attention": 0,
            "flash_attention_lse": remat_factor * n_layers * steps,
            "flash_attention_bwd_dq": n_layers * steps,
            "flash_attention_bwd_dkdv": n_layers * steps,
            "ssd_scan": remat_factor * n_ssm * steps,
            "ssd_scan_bwd": n_ssm * steps}


def _train_launches(cfg) -> dict:
    """``_launches_want`` of one loss-and-gradient call of ``cfg``."""
    return _launches_want(cfg.n_attn_layers(),
                          2 if cfg.remat in ("block", "dots") else 1,
                          cfg.n_ssm_layers(), 1)


def _check_train_launches(label, watch, n_layers, remat_factor,
                          n_ssm: int = 0):
    """The launches of ``watch``'s steps: ``_launches_want``."""
    steps = watch.steps
    got = {n: watch.launches.get(n, 0) for n in TRAIN_KERNELS}
    want = _launches_want(n_layers, remat_factor, n_ssm, steps)
    print(f"[train {label}] {steps} steps x {n_layers} attention layers "
          f"and {n_ssm} Mamba2 layers: launches {got}")
    if got != want or not steps:
        _fail(f"train {label}: launches {got}, expected {want}")


def _recording_sizer(sizer, calls: list):
    """Record every sizing call (and its result) on ``sizer``."""
    size, retry, observe = (sizer.size_job, sizer.retry_allocation,
                            sizer.observe_job)

    def size_job(arch, cfg, shape, mesh, chips):
        job = size(arch, cfg, shape, mesh, chips)
        calls.append(("size", (arch, cfg, shape, mesh, chips),
                      job.sizing.allocation_gb, job.sizing.source))
        return job

    def retry_allocation(job, attempt, last):
        alloc = retry(job, attempt, last)
        calls.append(("retry", attempt, alloc))
        return alloc

    def observe_job(job, peak_gb, runtime_h=1.0, attempts=1):
        calls.append(("observe", peak_gb, attempts))
        return observe(job, peak_gb, runtime_h, attempts)
    sizer.size_job, sizer.retry_allocation = size_job, retry_allocation
    sizer.observe_job = observe_job
    return sizer


def _replay_sizer_on_cpu(calls) -> None:
    """The card sizer's calls replayed on a CPU sizer, the ladder from the
    CPU's own allocations: preset and ladder allocations equal, model
    allocations within ALLOC_RTOL (phase 6's card-vs-CPU tolerance)."""
    from repro_torch.launch.sizing import SizeyJobSizer
    cpu = SizeyJobSizer(hbm_cap_gb=1024.0, preset_gb=LADDER_PRESET_GB,
                        device="cpu")
    job = last = None
    worst = 0.0
    for call in calls:
        if call[0] == "size":
            job = cpu.size_job(*call[1])
            last, want, source = job.sizing.allocation_gb, call[2], call[3]
            if job.sizing.source != source:
                _fail(f"sizer on the CPU: source {job.sizing.source}, card "
                      f"{source}")
        elif call[0] == "retry":
            last, want = cpu.retry_allocation(job, call[1], last), call[2]
        else:
            cpu.observe_job(job, call[1], attempts=call[2])
            continue
        exact = job.sizing.source != "model"
        rel = abs(last - want) / max(abs(want), 1e-12)
        worst = max(worst, rel)
        if (exact and last != want) or rel > ALLOC_RTOL:
            _fail(f"sizer {call[0]}: CPU {last!r} GB, card {want!r} GB")
    print(f"[train c] the sizer's {len(calls)} calls replayed on the CPU: "
          f"allocations equal (preset and ladder), model allocations "
          f"{worst:.3e} apart at most (tol {ALLOC_RTOL:g})")


def train_ladder_and_restart(sizer, tmp) -> None:
    """(c) the OOM ladder through launch.train --sizey and a killed run's
    restart from its checkpoint, at e2e-100m on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import Trainer, TrainerConfig
    t0 = time.perf_counter()
    calls = sizer._calls
    for job in range(2):
        n0 = len(calls)
        trainer = launch.main(LADDER_ARGV + ["--device", DEV], sizer=sizer)
        retries = [c for c in calls[n0:] if c[0] == "retry"]
        allocs = [c[2] for c in calls[n0:] if c[0] != "observe"]
        print(f"[train c] ladder job {job}: {len(retries)} OOM kills, "
              f"allocations {allocs} GB, footprint "
              f"{trainer.footprint_gb()!r} GB")
        if not retries:
            _fail(f"ladder job {job}: the preset did not OOM-kill it")
        del trainer
    cfg = launch.scaled_config(get_config(TRAIN_ARCH), LADDER_ARGV[3])
    kw = dict(steps=RESTART_STEPS, global_batch=8, seq_len=256,
              ckpt_every=RESTART_EVERY, log_every=0)
    full = Trainer(cfg, TrainerConfig(**kw), device=DEV).train()

    class Kill(Exception):
        pass

    def kill(trainer, row):
        if row["step"] == RESTART_KILL:
            raise Kill()
    d = str(tmp / "restart")
    killed = Trainer(cfg, TrainerConfig(ckpt_dir=d, **kw), hooks=[kill],
                     device=DEV)
    try:
        killed.train()
        _fail("the kill hook did not stop the run")
    except Kill:
        pass
    if killed._pending_ckpt is not None:
        killed._pending_ckpt.join()
    del killed
    again = Trainer(cfg, TrainerConfig(ckpt_dir=d, **kw), device=DEV)
    if again.start_step != RESTART_EVERY or ckpt.latest_step(d) != \
            RESTART_EVERY:
        _fail(f"restart restored step {again.start_step}, expected "
              f"{RESTART_EVERY}")
    rest = again.train()
    del again
    pairs = list(zip(rest, full[RESTART_EVERY:]))
    same = all(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
               for a, b in pairs)
    spread = max(max(abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                     abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"])
                 for a, b in pairs)
    print(f"[train c] killed after step {RESTART_KILL}, restored step "
          f"{RESTART_EVERY}: steps {[a['step'] for a, _ in pairs]} losses "
          f"{[a['loss'] for a, _ in pairs]} and grad norms "
          f"{'bitwise' if same else f'NOT bitwise ({spread:.3e} apart)'} "
          f"the uninterrupted run's")
    if not same:
        _fail("the restart is not bitwise the uninterrupted run")
    torch.cuda.empty_cache()
    print(f"[train c] wall {time.perf_counter() - t0:.1f} s")


def train_full_width(sizer) -> dict:
    """(b) granite-3-2b at full width and depth through launch.train
    --sizey, counters zeroed just before."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    n0 = len(sizer._calls)
    t0 = time.perf_counter()
    with _LaunchWatch() as watch:
        trainer = launch.main(TRAIN_FULL_ARGV, sizer=sizer)
        torch.cuda.synchronize()
        moved = float((_param_probe(trainer.params)
                       - watch.first[-1]).abs().max())
    wall = time.perf_counter() - t0
    _check_train_launches("b", watch, cfg.n_attn_layers(),
                          2 if cfg.remat in ("block", "dots") else 1)
    sized = [c for c in sizer._calls[n0:] if c[0] == "size"]
    if sized[0][3] != "model":
        _fail(f"train b: sized by {sized[0][3]}, not by the models")
    k12 = (watch.launches.get("ensemble_mlp", 0),
           watch.launches.get("knn_predict", 0))
    if not all(k12):
        _fail(f"train b: the sizer launched K1, K2 {k12} times")
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    if not all(np.isfinite(losses)) or not moved > 0:
        _fail(f"train b: losses {losses}, parameters moved {moved}")
    walls = sorted(r["step_s"] for r in hist[1:])
    step_s = walls[len(walls) // 2]
    tokens = 8 * 256
    retries = sum(c[0] == "retry" for c in sizer._calls[n0:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[train b] {cfg.name}: {cfg.param_count():,} parameters, "
          f"{len(hist)} steps (+{watch.steps - len(hist)} killed by the "
          f"ladder, {retries} retries), losses {[round(x, 4) for x in losses]}; "
          f"step wall median {step_s:.3f} s ({tokens / step_s:.1f} tokens/s), "
          f"first {hist[0]['step_s']:.3f} s; Sizey allocation "
          f"{trainer.tc.memory_budget_gb:.2f} GB (first {sized[0][2]:.2f} GB "
          f"from the models), footprint {trainer.footprint_gb():.2f} GB, card "
          f"peak {peak / 1024**3:.2f} GB; "
          f"K1 {k12[0]}, K2 {k12[1]} launches; wall {wall:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": watch.launches, "shapes": watch.shapes,
            "steps": watch.steps, "step_s": step_s, "peak": peak}


def train_ssm_hybrid() -> dict:
    """(f) mamba2-780m at full width and depth through launch.train, and
    zamba2-7b at full width cut to HYBRID_LAYERS positions through the
    trainer: K6's forward and backward (and zamba2's K4) on every step,
    counters zeroed just before each."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.train.loop import Trainer, TrainerConfig
    out = {}
    runs = (("ssm", launch.scaled_config(get_config(SSM_ARGV[1]),
                                         SSM_ARGV[3]),
             int(SSM_ARGV[7]), int(SSM_ARGV[9])),
            ("hybrid", get_config(HYBRID_ARCH).with_layers(HYBRID_LAYERS),
             HYBRID_BATCH, 1024))
    for kind, cfg, batch, seq in runs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _LaunchWatch() as watch:
            if kind == "ssm":
                trainer = launch.main(SSM_ARGV + ["--device", DEV])
            else:
                trainer = Trainer(cfg, TrainerConfig(
                    steps=HYBRID_STEPS, global_batch=batch, seq_len=seq,
                    log_every=1), device=DEV)
                trainer.train()
            torch.cuda.synchronize()
            moved = float((_param_probe(trainer.params)
                           - watch.first[-1]).abs().max())
        wall = time.perf_counter() - t0
        _check_train_launches(f"f {kind}", watch, cfg.n_attn_layers(),
                              2 if cfg.remat in ("block", "dots") else 1,
                              cfg.n_ssm_layers())
        hist = trainer.history
        losses = [r["loss"] for r in hist]
        if not all(np.isfinite(losses)) or not moved > 0:
            _fail(f"train f: {cfg.name} losses {losses}, parameters moved "
                  f"{moved}")
        walls = sorted(r["step_s"] for r in hist[1:])
        step_s = walls[len(walls) // 2]
        peak = torch.cuda.max_memory_allocated()
        print(f"[train f] {cfg.name}: {cfg.n_layers} layer positions "
              f"({cfg.n_ssm_layers()} Mamba2), {cfg.param_count():,} "
              f"parameters, batch {batch} x {seq}, {len(hist)} steps, losses "
              f"{[round(x, 4) for x in losses]}; step wall median "
              f"{step_s:.3f} s ({batch * seq / step_s:.1f} tokens/s), first "
              f"{hist[0]['step_s']:.3f} s; footprint "
              f"{trainer.footprint_gb():.2f} GB, card peak "
              f"{peak / 1024**3:.2f} GB; "
              f"K6 forward {watch.launches.get('ssd_scan', 0)}, backward "
              f"{watch.launches.get('ssd_scan_bwd', 0)} launches; wall "
              f"{wall:.1f} s")
        out[kind] = {"launches": watch.launches, "shapes": watch.shapes,
                     "step_s": step_s, "peak": peak}
        del trainer
        torch.cuda.empty_cache()
    launched = set(out["ssm"]["shapes"]["ssd_scan"]) | set(
        out["hybrid"]["shapes"]["ssd_scan"])
    if launched != set(K6_TRAIN_SHAPES):
        _fail(f"train f: K6 shapes {sorted(launched)}, expected "
              f"{K6_TRAIN_SHAPES} (held to the plain backward in (a))")
    return out


def train_card_vs_cpu() -> None:
    """(d) the reduced granite-3-2b and phi3.5-moe in fp32, 3 steps on the
    card and on the CPU from the same parameters, with and without int8
    gradients; and the int8 gradients of step 0 on both devices from the
    same gradients, bitwise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import compression, step as step_mod
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    for arch in CVC_TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        base = build_model(cfg).init(LM_SEED, device="cpu")
        for compress in (False, True):
            hist, final = {}, {}
            for dev in ("cpu", DEV, "again"):
                on = DEV if dev == "again" else dev
                params = tree_map(lambda t: t.clone().to(on), base)
                tc = TrainerConfig(steps=3, global_batch=2, seq_len=64,
                                   log_every=0, compress_grads=compress)
                tr = Trainer(cfg, tc, device=on, params=params)
                hist[dev] = tr.train()
                final[dev] = tree_flatten_with_path(tr.params)[1]
            # the card's run repeated: bitwise (the MoE's capacity scatter
            # and the embedding's backward add in no order that matters)
            def metrics(rows):
                return [(r["loss"], r["grad_norm"]) for r in rows]
            if metrics(hist["again"]) != metrics(hist[DEV]) or not all(
                    torch.equal(a, b) for a, b in zip(final[DEV],
                                                      final["again"])):
                _fail(f"train d: {arch} on the card is not bitwise run to "
                      f"run (compress={compress})")
            rel = max(max(abs(a[m] - b[m]) / abs(b[m])
                          for m in ("loss", "grad_norm"))
                      for a, b in zip(hist[DEV], hist["cpu"]))
            tol = CVC_TRAIN_RTOL[compress]
            print(f"[train d] {arch} reduced, compress={compress}: losses "
                  f"card {[r['loss'] for r in hist[DEV]]} cpu "
                  f"{[r['loss'] for r in hist['cpu']]}; losses and grad "
                  f"norms {rel:.3e} apart (tol {tol:g}); a second card run "
                  f"bitwise, parameters included")
            if rel > tol:
                _fail(f"train d: {arch} card and CPU {rel:.3e} apart")
        tokens = torch.from_numpy(SyntheticTokenPipeline(
            cfg.vocab, 64, 2, name=cfg.name).batch_at(0))
        loss = build_model(cfg).loss
        _, g_cpu = step_mod._value_and_grad(loss, base, {"tokens": tokens})
        card = tree_map(lambda t: t.to(DEV), base)
        _, g_card = step_mod._value_and_grad(loss, card,
                                             {"tokens": tokens.to(DEV)})
        key = prng.prng_key(LM_SEED)
        q_cpu, s_cpu = compression.quantize_int8(g_cpu, key)
        q_same, s_same = compression.quantize_int8(
            tree_map(lambda t: t.to(DEV), g_cpu), key)
        q_own, _ = compression.quantize_int8(g_card, key)
        flat = [tree_flatten_with_path(t)[1]
                for t in (q_cpu, q_same, q_own, s_cpu, s_same)]
        same = all(torch.equal(a, b.cpu()) for a, b in zip(flat[0], flat[1])) \
            and all(torch.equal(a, b.cpu()) for a, b in zip(flat[3], flat[4]))
        moved = sum(int((a != b.cpu()).sum()) for a, b in zip(flat[0],
                                                               flat[2]))
        n = sum(a.numel() for a in flat[0])
        print(f"[train d] {arch} step-0 int8 gradients: the CPU's gradients "
              f"quantized on the card {'bitwise' if same else 'NOT bitwise'} "
              f"the CPU's; each device's own gradients: {moved} of {n} int8 "
              f"values one step apart")
        if not same:
            _fail(f"train d: {arch} int8 gradients differ on the card")


def train_moe_vlm() -> dict:
    """(e) phi3.5-moe at full width, a train step cut to MOE_TRAIN_LAYERS
    layers and a serve cut to MOE_SERVE_LAYERS in bf16; internvl2-26b at
    full width cut to VLM_LAYERS, one train step with its patches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SizeyConfig
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.sizing import KVCacheSizer
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    dev = torch.device(DEV)
    shapes = {}
    # phi3.5-moe, one train step
    cfg = get_config(MOE_ARCH).with_layers(MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with _LaunchWatch() as watch:
        tr = Trainer(cfg, TrainerConfig(steps=1, global_batch=MOE_TRAIN_BATCH,
                                        seq_len=256, log_every=1), device=dev)
        fp = tr.footprint_gb()
        hist = tr.train()
        moved = float((_param_probe(tr.params) - watch.first[-1]).abs().max())
        del tr
    _check_train_launches("e moe", watch, MOE_TRAIN_LAYERS, 2)
    if not np.isfinite(hist[0]["loss"]) or not moved > 0:
        _fail(f"train e: phi3.5-moe loss {hist[0]['loss']}, moved {moved}")
    print(f"[train e] {cfg.name} at full width, {MOE_TRAIN_LAYERS} of 32 "
          f"layers ({cfg.param_count():,} parameters, footprint {fp:.2f} "
          f"GB): loss {hist[0]['loss']:.4f}, step {hist[0]['step_s']:.3f} s, "
          f"card peak {torch.cuda.max_memory_allocated() / 1024**3:.2f} GB, "
          f"{time.perf_counter() - t0:.1f} s")
    shapes["moe"] = watch.shapes
    torch.cuda.empty_cache()
    # phi3.5-moe, a serve in bf16
    cfg = dataclasses.replace(get_config(MOE_ARCH).with_layers(
        MOE_SERVE_LAYERS), param_dtype="bfloat16")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with _LaunchWatch() as watch:
        model = build_model(cfg)
        params = model.init(LM_SEED, device=dev)
        engine = ServeEngine(model, params, max_batch=4, max_seq=1024,
                             temperature=SERVE_TEMPERATURE,
                             sizer=KVCacheSizer(SizeyConfig(min_history=2),
                                                device=dev),
                             seed=LM_SEED, device=dev)
        del params
        finite = []
        prefill, decode = model.prefill, model.decode_step

        def checked(fn):
            def run(*a, **kw):
                logits, cache = fn(*a, **kw)
                finite.append(torch.isfinite(logits).all())
                return logits, cache
            return run
        engine.model = dataclasses.replace(model, prefill=checked(prefill),
                                           decode_step=checked(decode))
        rng = np.random.default_rng(LM_SEED)
        reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).astype(
            np.int32), max_new_tokens=MOE_SERVE_NEW)
            for i, n in enumerate(rng.integers(*MOE_SERVE_LENS, 4))]
        comps = engine.serve(reqs)
        torch.cuda.synchronize()
        del engine, model
    n_tok = sum(len(c.tokens) for c in comps)
    k4, k5 = (watch.launches.get("flash_attention", 0),
              watch.launches.get("flash_decode", 0))
    if not all(bool(f) for f in finite) or n_tok != 4 * MOE_SERVE_NEW \
            or k4 != MOE_SERVE_LAYERS or \
            k5 != MOE_SERVE_LAYERS * (MOE_SERVE_NEW - 1):
        _fail(f"train e: phi3.5-moe serve: finite {all(map(bool, finite))}, "
              f"{n_tok} tokens, K4 {k4}, K5 {k5}")
    print(f"[train e] {cfg.name} served in bf16 at full width, "
          f"{MOE_SERVE_LAYERS} of 32 layers ({cfg.param_count():,} "
          f"parameters): 4 requests, {n_tok} tokens in "
          f"{time.perf_counter() - t0:.1f} s with the init; K4 {k4}, K5 "
          f"{k5} launches (G = 4); card peak "
          f"{torch.cuda.max_memory_allocated() / 1024**3:.2f} GB")
    shapes["moe serve"] = watch.shapes
    torch.cuda.empty_cache()
    # internvl2-26b, one train step with its 256 patch embeddings
    cfg = get_config(VLM_ARCH).with_layers(VLM_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with _LaunchWatch() as watch:
        model = build_model(cfg)
        params = model.init(LM_SEED, device=dev)
        opt = make_optimizer("adamw")
        state = opt.init(params)
        tokens = SyntheticTokenPipeline(cfg.vocab, VLM_TEXT, VLM_BATCH,
                                        name=cfg.name).batch_at(0)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "patch_embeds": _gen_inputs(LM_SEED, dev)(
                     VLM_BATCH, cfg.n_patches, cfg.d_model)}
        probe = _param_probe(params).clone()
        step = make_train_step(cfg, opt)
        watch.steps = 1
        metrics, params, state = step(params, state, batch)
        loss = float(metrics["loss"])
        moved = float((_param_probe(params) - probe).abs().max())
        del params, state
    _check_train_launches("e vlm", watch, VLM_LAYERS, 2)
    if not np.isfinite(loss) or not moved > 0:
        _fail(f"train e: internvl2 loss {loss}, moved {moved}")
    print(f"[train e] {cfg.name} at full width, {VLM_LAYERS} of 48 layers: "
          f"one step over {cfg.n_patches} patches + {VLM_TEXT} tokens, loss "
          f"{loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, "
          f"{time.perf_counter() - t0:.1f} s with the init; card peak "
          f"{torch.cuda.max_memory_allocated() / 1024**3:.2f} GB")
    shapes["vlm"] = watch.shapes
    torch.cuda.empty_cache()
    return shapes


def time_k4_backward(shape) -> dict:
    """K4's backward (two kernel launches) at a training shape in bf16, causal,
    beside the plain backward and scaled_dot_product_attention's backward:
    the device time (torch.profiler) of the kernels its backward runs,
    the autograd graph of one forward kept and walked again each call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.analysis import kernel_costs as costs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_backward_plain
    dev = torch.device(DEV)
    b, s, h, hkv, d = shape
    bf16 = torch.bfloat16
    q, k, v = lm_kernel_inputs("flash_attention", shape, bf16, 11, dev)
    dout = _gen_inputs(12, dev)(b, s, h, d, dtype=bf16)
    scale = d ** -0.5
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    out = ops._launch_forward(q, k, v, True, scale, s, lse)
    ms = _time_ms(lambda: ops._launch_backward(q, k, v, out, dout, lse, True,
                                               scale, s), 20, 5)
    plain = _time_ms(lambda: flash_attention_backward_plain(q, k, v, dout),
                     5, 2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)
    gqa = {"enable_gqa": True} if h != hkv else {}

    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             **gqa)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dt,
                                   retain_graph=True)
    lib = _device_ms(lib_bwd, n=20)
    how = "device time of its kernels (torch.profiler)"
    if lib is None:
        lib = _time_ms(lib_bwd, 20, 5)
        how = "CUDA events (the profiler showed no device time)"
    bound, by = costs.k4_bwd_bound(*shape, 2)
    flops = costs.k4_bwd_work(*shape, 2)[1]
    print(f"[time] flash_attention_bwd (B,S,H,Hkv,D)={shape} bf16 causal: "
          f"{ms:.5f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain:.5f} ms, scaled_dot_product_attention backward "
          f"{lib:.5f} ms ({how}), bound {bound:.5f} ms ({by})")
    del lib_out
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def time_k6_backward(shape) -> dict:
    """K6's backward (four kernel launches in bf16) at a training shape on the
    model's strided slices, beside the plain backward (fp32) and the
    forward at the same shape; no PyTorch call computes an SSD scan's
    gradient, so no library time. Bound: the bytes, or the products at
    the bf16 tensor rate with each fp32 operand in three passes (the
    forward's convention); the fp32 CUDA-core rate's bound printed
    beside."""
    import torch
    from repro_torch.analysis import kernel_costs as costs
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_backward_plain
    dev = torch.device(DEV)
    b, h, s, p, n, q = shape
    xbc, dt, a, dy, _ = _k6_grad_inputs(shape, torch.bfloat16, 13, dev)
    x, bm, cm = _k6_split(xbc, shape)
    ms = _time_ms(lambda: ops._launch_backward(x, dt, bm, cm, a, dy, None, q),
                  10, 3)
    fwd = _time_ms(lambda: ops._launch_forward(x, dt, bm, cm, a, q), 20, 5)
    plain = _time_ms(lambda: ssd_scan_backward_plain(x, dt, bm, cm, a, dy,
                                                     q_chunk=q), 3, 1)
    nbytes, flops, fp32_op = costs.k6_bwd_work(*shape, 2)
    bound, by = costs.bound_at(nbytes, flops + 2 * fp32_op,
                               costs.PEAK_FLOPS_BF16)
    b32, by32 = costs.bound_at(nbytes, flops, costs.PEAK_FLOPS_FP32)
    print(f"[time] ssd_scan_bwd (B,H,S,P,N,Q)={shape} bf16: {ms:.5f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s of the products it needs), "
          f"plain {plain:.5f} "
          f"ms, the forward {fwd:.5f} ms; bound {bound:.5f} ms ({by}, bf16 "
          f"tensor rate in three passes), {b32:.5f} ms ({by32}) at the fp32 "
          f"rate; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; library: "
          f"none (no PyTorch call computes an SSD scan's gradient)")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def train_phase() -> tuple[list, dict, object]:
    """Phase 15: training on the card. Returns the JSON rows of K4's and
    K6's backward, the card's peak and median step wall of (b)'s
    granite-3-2b and (f)'s mamba2-780m for phase 17, and the backward
    kernels' timing as a function that completes the rows, as
    :func:`lm_phases` does."""
    import gc
    import shutil
    import torch
    from repro_torch.launch.sizing import SizeyJobSizer
    t_start = time.perf_counter()
    # the serve phase's engine sits in a reference cycle (its wrapped
    # sampler) with zamba2-7b's weights: free it before the 42 GB of (b)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] {torch.cuda.memory_allocated() / 1024**3:.2f} GB "
          f"allocated on the card at the start of phase 15")
    err = check_k4_backward(K4_BWD_SHAPES)
    err6 = check_k6_backward(K6_BWD_SHAPES)
    tmp = REPO / "build" / "phase15"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    sizer = SizeyJobSizer(hbm_cap_gb=1024.0, preset_gb=LADDER_PRESET_GB,
                          device=DEV)
    sizer._calls = []
    _recording_sizer(sizer, sizer._calls)
    try:
        train_ladder_and_restart(sizer, tmp)
        full = train_full_width(sizer)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _replay_sizer_on_cpu(sizer._calls)
    del sizer
    ssm = train_ssm_hybrid()
    train_card_vs_cpu()
    more = train_moe_vlm()
    launched = set(full["shapes"]["flash_attention"])
    for s in more.values():
        launched |= set(s["flash_attention"])
    print(f"[train] K4 shapes launched in (b)-(e): {sorted(launched)}")
    err = max(err, check_k4_backward(sorted(launched - set(K4_BWD_SHAPES)),
                                     label="bwd launched"))
    k4s = max(full["shapes"]["flash_attention"].items(),
              key=lambda kv: (kv[1], kv[0]))[0]
    wall = time.perf_counter() - t_start
    print(f"[train] step wall (median): granite-3-2b {full['step_s']:.4f} s "
          f"({8 * 256 / full['step_s']:.1f} tokens/s), mamba2-780m "
          f"{ssm['ssm']['step_s']:.4f} s "
          f"({8 * 1024 / ssm['ssm']['step_s']:.1f} tokens/s)")
    print(f"[train] phase 15 wall {wall:.1f} s")
    torch.cuda.empty_cache()
    measured = {"granite": {k: full[k] for k in ("peak", "step_s")},
                "mamba2": {k: ssm["ssm"][k] for k in ("peak", "step_s")}}
    rows = [{"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/kernel.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
             "launches": full["launches"].get("flash_attention_bwd_dq", 0),
             "max_abs_err": err},
            {"name": "ssd_scan_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/ssd_scan/kernel.cu",
             "replaces": "src/repro/kernels/ssd_scan/kernel.py:71",
             "launches": ssm["ssm"]["launches"].get("ssd_scan_bwd", 0),
             "max_abs_err": err6},
            {"name": "ssd_scan_bwd_zamba2", "route": "cuda",
             "source": "src/repro_torch/kernels/ssd_scan/kernel.cu",
             "replaces": "src/repro/kernels/ssd_scan/kernel.py:71",
             "launches": ssm["hybrid"]["launches"].get("ssd_scan_bwd", 0),
             "max_abs_err": err6}]

    def time_rows():
        rows[0].update(time_k4_backward(k4s))
        for shape in sorted(launched - {k4s}):
            time_k4_backward(shape)
        rows[1].update(time_k6_backward(K6_TRAIN_SHAPES[0]))
        rows[2].update(time_k6_backward(K6_TRAIN_SHAPES[1]))
        torch.cuda.empty_cache()
    return rows, measured, time_rows


# ----------------------------------------------------------- phase 16
# The distributed layer on the card (after 15). The card is one H100, so
# the mesh has one device: a 1-rank nccl group (rendezvous through a file
# in the git-ignored build directory) and a (1, 1) ("data", "model") mesh.
# The reduced granite-3-2b train step sharded by param_specs under
# axis_rules (ZeRO-3 over DTensors, the loss and gradients through
# local_map, so K4 and its backward run on the local tensors) against the
# unsharded step; compressed_psum over the group against the one-device
# round trip; ElasticController over the one-device fleet. (b) tensor
# parallelism on the one card: two processes, a (1, 2) ("data", "model")
# mesh over a gloo group (NCCL refuses two ranks on one device; the
# installed torch's gloo carries all-reduce, reduce-scatter and all-to-all
# of CUDA tensors but crashed in all-gather into a tensor, and a (1, 2)
# mesh gathers nothing), each rank running granite-3-2b's and
# mamba2-780m's train steps tensor-parallel over "model" (K4 and K6 on the
# rank's heads) against the one-device step on the card from the same
# parameters and tokens: first reduced, in fp32, from the inputs of
# tests/test_torch_tp.py and at its limits (torch_dist_worker.tp_limits
# and adamw_moves: gradients 1e-6 and parameters 0.05 lr, or twice the
# JAX reference's own spread where larger, for the parameters only near
# AdamW's eps); then at full width and their configured bf16 compute and
# remat, cut in depth to DIST_TP_LAYERS, batch 8 x 256 as phase 15 (b).
# Limits there, phase 15's bf16 policy: the loss, the
# gradient norm and every gradient within DIST_TP_TOL of the largest
# (K4_BWD_TOL's bf16 limit: the gradients are rounded to bf16, and a row-
# parallel product rounds each rank's partial sum where one device rounds
# the whole); the parameters after AdamW within 0.05 lr where both
# steps' gradients exceed AdamW's eps x 1e3 and agree in sign (the first
# update g / (|g| + eps) is then the sign within 1e-3, so a rank that
# updates the wrong shard or the wrong way shows) or are both 0 (the
# embedding's rows of tokens not in the batch); the others, whose update
# a gradient's bf16 rounding may flip, counted and reported. Launches
# per rank, both runs: phase 15's count (_train_launches) for the loss
# and gradients, equal to the one-device call's. The full-width steps run
# again with cfg.seq_shard (sequence parallelism: the residual stream each
# rank's half of the sequence, gathered into each block and reduce-
# scattered out of it, each an all-to-all of CUDA tensors), at the same
# limits and launches; each rank prints torch.cuda.max_memory_allocated
# over its sharded loss and gradients with and without it. No multi-GPU
# number is measured here.
DIST_BATCH, DIST_SEQ = 4, 64
DIST_TP_ARCHS = ("granite-3-2b", "mamba2-780m")
DIST_TP_LAYERS, DIST_TP_BATCH, DIST_TP_SEQ, DIST_TP_LR = 2, 8, 256, 3e-4
DIST_TP_TOL = K4_BWD_TOL["bfloat16"]
ADAMW_NEAR_EPS = 1e3 * 1e-8
DIST_TP_TIMEOUT = 300
# (b)'s serve: the reduced configs at the CPU tests' shapes and limits, then
# zamba2-7b at full width cut to 3 layer positions (2 Mamba2 and the shared
# attention block: at 2 it would have no attention layer), bf16
DIST_SERVE_ARCHS = ("granite-3-2b", "zamba2-7b")
DIST_SERVE_LAYERS, DIST_SERVE_BATCH, DIST_SERVE_SEQ = 3, 8, 256
# (b) then holds K4 (B, S, H, Hkv, D) and K6 (B, H, S, P, N, Q), forward and
# backward, to their plain versions at the per-rank head counts that the
# production meshes' 16 "model" ranks give the train cells
# (distributed.tp.head_split): 2 query heads on 1 KV head (granite-3-2b at
# D 64; minitron-8b, phi3.5-moe, yi-9b at 128), 3 on 1 (internvl2-26b,
# grok-1-314b), 2 and 3 on as many (qwen1.5-32b), 2 on 2 (zamba2-7b at
# 112, musicgen-large at 64); Mamba2's 3 (mamba2-780m) and 7 (zamba2-7b)
# heads, at their P and N; and at the shapes of (b)'s own steps on each of
# its 2 ranks: granite-3-2b's 16 query heads on 4 KV heads, mamba2-780m's
# 24 heads
TP_K4_SHAPES = [(1, 512, 2, 1, 64), (1, 512, 2, 1, 128), (1, 512, 3, 1, 128),
                (1, 512, 2, 2, 128), (1, 512, 3, 3, 128), (1, 512, 2, 2, 112),
                (1, 512, 2, 2, 64), (DIST_TP_BATCH, DIST_TP_SEQ, 16, 4, 64)]
TP_K6_SHAPES = [(1, 3, 512, 64, 128, 128), (1, 7, 512, 64, 64, 128),
                (DIST_TP_BATCH, 24, DIST_TP_SEQ, 64, 128, 128)]
# and K5's e4m3 and log-sum-exp variants (B, S_loc, H, Hkv, D, pos) at a
# rank's slice of decode_32k's cache on 16 "model" ranks (8 sequences a
# rank, 2,048 positions, every query head: granite-3-2b 32 on 8 KV heads,
# grok-1-314b and internvl2-26b 48 on 8, zamba2-7b 32 on 32) and at (b)'s
# full-width serve (264 positions over 2 ranks)
TP_K5_SHAPES = [(8, 2048, 32, 8, 64, 2047), (8, 2048, 48, 8, 128, 1000),
                (8, 2048, 32, 32, 112, 1500),
                (DIST_SERVE_BATCH, 132, 32, 32, 112, 131)]


def distributed_phase() -> tuple[dict, dict]:
    """Phase 16: the sharded step, compressed_psum and the elastic
    controller on a 1-device nccl mesh, each bitwise its one-device
    counterpart; then (b) (``tp_phase``, whose errors and serve launches
    it returns)."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs)
    from repro_torch.kernels import KERNEL_LAUNCHES
    from repro_torch.launch.elastic import ElasticController
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.train.compression import compressed_psum
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    t0 = time.perf_counter()
    tmp = REPO / "build" / "phase16"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'store'}",
                            rank=0, world_size=1,
                            device_id=torch.device(DEV, 0))
    try:
        mesh = make_test_mesh(1, 1, device_type=DEV)
        cfg = get_config("granite-3-2b").reduced()
        model = build_model(cfg)
        base = model.init(LM_SEED, device=DEV)
        tokens = np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab, (DIST_BATCH, DIST_SEQ)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tokens).to(DEV)}
        opt = make_optimizer("adamw")
        runs = {}
        for kind in ("unsharded", "sharded"):
            params = tree_map(torch.clone, base)
            before = {n: KERNEL_LAUNCHES[n] for n in K4_TRAIN_KERNELS}
            if kind == "unsharded":
                m, params, _ = step_mod.make_train_step(cfg, opt)(
                    params, opt.init(params), batch)
            else:
                with axis_rules(mesh):
                    params = distribute(params, mesh,
                                        param_specs(params, mesh))
                    state = opt.init(local_tree(params))
                    db = distribute(batch, mesh, batch_specs(batch, mesh))
                    m, params, _ = step_mod.make_train_step(
                        cfg, opt, mesh=mesh)(params, state, db)
                params = tree_map(lambda t: t.full_tensor(), params)
            torch.cuda.synchronize()
            moved = {n: KERNEL_LAUNCHES[n] - before[n]
                     for n in K4_TRAIN_KERNELS}
            runs[kind] = (m, tree_flatten_with_path(params)[1], moved)
        (mu, pu, ku), (ms, ps, ks) = runs["unsharded"], runs["sharded"]
        same = torch.equal(mu["loss"], ms["loss"]) and torch.equal(
            mu["grad_norm"], ms["grad_norm"]) and all(
            torch.equal(a, b) for a, b in zip(pu, ps))
        print(f"[dist] {cfg.name} reduced, batch {DIST_BATCH} x {DIST_SEQ}, "
              f"on a (1, 1) nccl mesh: loss {float(ms['loss'])!r} (unsharded "
              f"{float(mu['loss'])!r}), grad norm {float(ms['grad_norm'])!r}; "
              f"loss, grad norm and {len(ps)} updated parameters "
              f"{'bitwise' if same else 'NOT bitwise'} the unsharded step's; "
              f"K4 launches sharded {ks}, unsharded {ku}")
        if not same:
            _fail("phase 16: the sharded step is not the unsharded step")
        if ks != ku or not ks["flash_attention_bwd_dq"]:
            _fail(f"phase 16: K4 launches {ks}, the unsharded step's {ku}")
        # compressed_psum over the 1-rank "data" group against the round
        # trip with no group
        _, grads = step_mod._value_and_grad(model.loss, base, batch)
        key = prng.prng_key(LM_SEED)
        alone = compressed_psum(grads, "data", key)
        with axis_rules(mesh):
            grouped = compressed_psum(grads, "data", key)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_flatten_with_path(alone)[1],
            tree_flatten_with_path(grouped)[1]))
        print(f"[dist] compressed_psum over the 1-rank group: "
              f"{'bitwise' if same else 'NOT bitwise'} the one-device round "
              f"trip ({len(tree_flatten_with_path(grads)[1])} leaves)")
        if not same:
            _fail("phase 16: compressed_psum over the group differs")
        ctl = ElasticController(tree_map(torch.clone, base), device_type=DEV)
        changed = ctl.maybe_rescale()
        print(f"[dist] ElasticController over the 1-device fleet: mesh "
              f"{tuple(ctl.mesh.shape)}, rescaled {changed}, events "
              f"{ctl.events}")
        if changed or ctl.events or ctl.mesh.size() != 1:
            _fail("phase 16: the elastic controller saw a change")
        del ctl, runs, grads, alone, grouped
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    err, launches = tp_phase()
    print(f"[dist] phase 16 wall {time.perf_counter() - t0:.1f} s")
    return err, launches


def tp_phase() -> tuple[dict, dict]:
    """Phase 16 (b): the two ranks of the (1, 2) gloo mesh, each a process
    on the card, then K4, K5's variants and K6 at the per-rank shapes of
    the production meshes; fails if any does. Returns the largest absolute
    difference per kernel row and rank 0's launches in the full-width
    serve."""
    import atexit
    import shutil
    t0 = time.perf_counter()
    tmp = REPO / "build" / "phase16b"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--tp-rank", str(r),
         str(tmp / "store")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for proc in procs:
        atexit.register(_stop_worker, proc)
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=DIST_TP_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                _stop_worker(p)
            _fail("phase 16 (b): a rank did not finish in time")
    shutil.rmtree(tmp, ignore_errors=True)
    launches = None
    for r, (proc, out) in enumerate(zip(procs, outs)):
        print("".join(f"[dist b] rank {r}: {line}\n"
                      for line in out.splitlines()
                      if line.strip() and not line.startswith(" ")
                      and "Warning" not in line),
              end="")
        if proc.returncode != 0:
            _fail(f"phase 16 (b): rank {r} failed (exit {proc.returncode})")
        for line in out.splitlines():
            if line.startswith("SERVE LAUNCHES ") and r == 0:
                launches = json.loads(line[len("SERVE LAUNCHES "):])
    if launches is None:
        _fail("phase 16 (b): rank 0 printed no serve launches")
    err = check_lm_kernels(TP_K4_SHAPES, [], TP_K6_SHAPES, label="dist b")
    err.update(check_k5_variants(TP_K5_SHAPES, label="dist b"))
    err["flash_attention_bwd"] = check_k4_backward(TP_K4_SHAPES,
                                                   label="dist b bwd")
    err["ssd_scan_bwd"] = check_k6_backward(TP_K6_SHAPES, label="dist b bwd")
    print(f"[dist b] wall {time.perf_counter() - t0:.1f} s")
    return err, launches


def _tp_config(arch):
    """Phase 16 (b)'s full-width config: cut in depth only."""
    from repro_torch.configs import get_config
    return get_config(arch).with_layers(DIST_TP_LAYERS)


def tp_rank(rank: int, store: str) -> int:
    """One rank of phase 16 (b): each of DIST_TP_ARCHS' steps on the card,
    reduced (fp32, the CPU tests' inputs and limits) and at full width
    (DIST_TP_LAYERS deep, bf16), one device then tensor-parallel over the
    (1, 2) mesh, held shard by shard; exit 1 on a fault."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs)
    from repro_torch.kernels import KERNEL_LAUNCHES
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    import logging
    sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_worker as cpu_tests
    torch.set_num_threads(1)
    # DTensor warns at every two-axis redistribution
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    short = {v: k for k, v in cpu_tests.TP_ARCHS.items()}
    ok = True
    try:
        mesh = make_test_mesh(1, 2, device_type=DEV)

        def counted(fn):
            before = {n: KERNEL_LAUNCHES[n] for n in TRAIN_KERNELS}
            out = fn()
            if DEV != "cpu":
                torch.cuda.synchronize()
            return out, {n: KERNEL_LAUNCHES[n] - before[n]
                         for n in TRAIN_KERNELS}

        def shards(tree):
            """Each leaf's shard on this rank, as param_specs places it."""
            return tree_flatten_with_path(local_tree(distribute(
                tree, mesh, param_specs(tree, mesh))))[1]
        for full, seq in ((False, False), (True, False), (True, True)):
            for arch in DIST_TP_ARCHS:
                t0 = time.perf_counter()
                if full:
                    cfg = dataclasses.replace(_tp_config(arch),
                                              seq_shard=seq)
                    shape, lr = (DIST_TP_BATCH, DIST_TP_SEQ), DIST_TP_LR
                    params = build_model(cfg).init(LM_SEED, device=DEV)
                else:
                    cfg = get_config(arch).reduced()
                    shape = (cpu_tests.TP_BATCH, cpu_tests.TP_SEQ)
                    lr = cpu_tests.TP_LR
                    params = tree_map(lambda t: t.to(DEV), build_model(
                        cfg).init(0, device="cpu"))
                model = build_model(cfg)
                tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                                           shape)
                batch = {"tokens": torch.from_numpy(
                    tokens.astype(np.int32)).to(DEV)}
                opt = make_optimizer("adamw", lr=lr)

                def grads_of(p, b):
                    return step_mod._value_and_grad(model.loss, p, b)
                (_, g_ref), k_ref = counted(lambda: grads_of(params, batch))
                ref = tree_map(torch.clone, params)
                m_ref, ref, _ = step_mod.make_train_step(cfg, opt)(
                    ref, opt.init(ref), batch)
                with axis_rules(mesh):
                    dp = distribute(params, mesh, param_specs(params, mesh))
                    db = distribute(batch, mesh, batch_specs(batch, mesh))
                    if DEV != "cpu":
                        # the one-device step's garbage, collected now, not
                        # inside the step measured
                        gc.collect()
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        held = torch.cuda.memory_allocated()
                    (_, g_tp), k_tp = counted(
                        lambda: step_mod._sharded(grads_of, mesh)(dp, db))
                    peak = ""
                    if DEV != "cpu":
                        top = torch.cuda.max_memory_allocated()
                        peak = (f"; max_memory_allocated over the sharded "
                                f"loss and gradients {top / 2**30:.3f} GiB, "
                                f"{(top - held) / 2**30:.3f} GiB over the "
                                f"{held / 2**30:.3f} GiB held before")
                    m, dp, _ = step_mod.make_train_step(cfg, opt, mesh=mesh)(
                        dp, opt.init(local_tree(dp)), db)
                    want_g, want_p = shards(g_ref), shards(ref)
                got_g = tree_flatten_with_path(local_tree(g_tp))[1]
                got_p = tree_flatten_with_path(local_tree(dp))[1]
                worst = {k: float(abs(m[k] - m_ref[k]) / abs(m_ref[k]))
                         for k in ("loss", "grad_norm")}
                for g, w in zip(got_g, want_g):
                    worst["grads"] = max(worst.get("grads", 0.0), float(
                        (g.float() - w.float()).abs().max()
                        / w.float().abs().max().clamp_min(1e-30)))
                if full:
                    grad_tol, (far, near, n_near, n_all) = DIST_TP_TOL, \
                        _bf16_moves(got_p, want_p, got_g, want_g, lr)
                    what = (f"{near:.3e} lr in the {n_near} of {n_all} "
                            f"where they may not")
                    fault = False
                else:
                    grad_tol, near_tol = cpu_tests.tp_limits(short[arch])
                    far, near = cpu_tests.adamw_moves(got_p, want_p, want_g,
                                                      lr)
                    what = f"{near:.3e} lr near eps (tol {near_tol:.3e})"
                    fault = near > near_tol
                want_k = _train_launches(cfg)
                path = {n: k for n, k in k_tp.items() if k}
                kind = ("at full width" if full else "reduced") \
                    + (", seq_shard" if seq else "")
                print(f"{cfg.name} {kind}, "
                      f"{cfg.n_layers} layers, {cfg.compute_dtype}, remat "
                      f"{cfg.remat}, {shape[0]} x {shape[1]} tokens, tensor-"
                      f"parallel on a (1, 2) gloo mesh on the card: loss "
                      f"{float(m['loss'])!r} (one device "
                      f"{float(m_ref['loss'])!r}); loss, grad norm and this "
                      f"rank's gradients {max(worst.values()):.3e} apart at "
                      f"most (tol {grad_tol:.3e}; {worst}); its parameters "
                      f"{far:.3e} lr apart where the gradients fix the update "
                      f"(tol 0.05), {what}; launches per rank {path}, one "
                      f"device {dict((n, k) for n, k in k_ref.items() if k)}"
                      f", phase 15's count {want_k}{peak}; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                if max(worst.values()) > grad_tol or far > 0.05 or fault \
                        or k_tp != k_ref or k_tp != want_k:
                    print(f"FAULT: {arch} beyond its limits or launches "
                          f"differ", flush=True)
                    ok = False
                del params, ref, dp, g_ref, g_tp, want_g, want_p, got_g, got_p
                if DEV != "cpu":
                    torch.cuda.empty_cache()
        ok &= tp_serve_rank(mesh, cpu_tests)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def tp_serve_rank(mesh, cpu_tests) -> bool:
    """Phase 16 (b)'s serve, on this rank of the (1, 2) mesh: prefill and
    8 greedy decode steps through ``dryrun.serve_step``, tensor-parallel
    over "model" with the cache as ``cache_specs`` lays it out, against
    the unsharded steps on the card from the same parameters and tokens,
    shard by shard (no collective reads them back): the reduced
    DIST_SERVE_ARCHS in fp32 at the CPU tests' limits (every step's logits
    and every cache leaf within ``torch_dist_worker.serve_limits`` of the
    largest, greedy tokens equal); then zamba2-7b at full width cut to
    DIST_SERVE_LAYERS positions, bf16, DIST_SERVE_BATCH x DIST_SERVE_SEQ
    tokens, the logits within DIST_TP_TOL of the largest, the argmax
    agreement printed. K4 once per attention layer and K6 once per Mamba2
    layer a prefill on each rank, K5's log-sum-exp variant once per
    attention layer a step (one device: K5 itself). Prints a rank's
    launches at full width as a JSON line for the smoke's row."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNEL_LAUNCHES
    from repro_torch.models import build_model
    from repro_torch.utils.misc import tree_map
    serve = ("flash_attention", "flash_decode", "flash_decode_lse",
             "ssd_scan")
    ok = True

    def counted(fn):
        before = {n: KERNEL_LAUNCHES[n] for n in serve}
        out = fn()
        if DEV != "cpu":
            torch.cuda.synchronize()
        return out, {n: KERNEL_LAUNCHES[n] - before[n] for n in serve
                     if KERNEL_LAUNCHES[n] - before[n]}
    runs = [(arch, True) for arch in DIST_SERVE_ARCHS] + [("zamba2-7b",
                                                            False)]
    for arch, reduced in runs:
        t0 = time.perf_counter()
        if reduced:
            cfg = get_config(arch).reduced()
            params = tree_map(lambda t: t.to(DEV), build_model(cfg).init(
                0, device="cpu"))
            shape, steps = (cpu_tests.SERVE_BATCH, cpu_tests.SERVE_PROMPT), \
                cpu_tests.SERVE_STEPS
        else:
            cfg = get_config(arch).with_layers(DIST_SERVE_LAYERS)
            params = build_model(cfg).init(LM_SEED, device=DEV)
            shape, steps = (DIST_SERVE_BATCH, DIST_SERVE_SEQ), \
                cpu_tests.SERVE_STEPS
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, shape).astype(np.int32)).to(DEV)
        old = (cpu_tests.SERVE_PROMPT, cpu_tests.SERVE_STEPS)
        cpu_tests.SERVE_PROMPT, cpu_tests.SERVE_STEPS = shape[1], steps
        try:
            want, k_one = counted(lambda: cpu_tests._serve_one_device(
                cfg, params, prompt))
            got, k_tp = counted(lambda: cpu_tests._serve_sharded(
                cfg, params, prompt, want[1], mesh, "train"))
        finally:
            cpu_tests.SERVE_PROMPT, cpu_tests.SERVE_STEPS = old
        worst, greedy = cpu_tests.serve_distance(cfg, got, want)
        logits = max(v for k, v in worst.items() if k.startswith("logits"))
        agree = sum(int((g[:, -1, :cfg.vocab].argmax(-1) == w[sl][
            :, -1, :cfg.vocab].argmax(-1)).sum())
            for (g, sl), w in zip(got[0], want[0]))
        n = sum(g.shape[0] for g, _ in got[0])
        n_attn, n_ssm = cfg.n_attn_layers(), cfg.n_ssm_layers()
        want_k = {n: c for n, c in (("flash_attention", n_attn),
                                    ("flash_decode_lse", n_attn * steps),
                                    ("ssd_scan", n_ssm)) if c}
        if reduced:
            short = {v: k for k, v in cpu_tests.TP_ARCHS.items()}[arch]
            tol = cpu_tests.serve_limits(short)
            fault = bool(cpu_tests.serve_faults(worst, tol)) or not greedy
            what = (f"logits and {len(got[2])} cache leaves "
                    f"{max(worst.values()):.3e} apart at most (tol "
                    f"{tol[0]:.3e} and {tol[1]:.3e}); greedy tokens "
                    f"{'equal' if greedy else 'DIFFER'}")
        else:
            tol = DIST_TP_TOL
            fault = logits > tol
            what = (f"logits {logits:.3e} apart at most (tol {tol}); argmax "
                    f"agreement {agree}/{n}; cache leaves "
                    f"{max(v for k, v in worst.items() if 'logits' not in k):.3e}")
            print("SERVE LAUNCHES " + json.dumps(k_tp), flush=True)
        print(f"serve {cfg.name} {'reduced' if reduced else 'at full width'}"
              f", {cfg.n_layers} layer positions, {cfg.compute_dtype}, "
              f"{shape[0]} x {shape[1]} tokens and {steps} decode steps, "
              f"tensor-parallel on a (1, 2) gloo mesh on the card against "
              f"one device: {what}; launches per rank {k_tp} (want "
              f"{want_k}), one device {k_one}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if fault or k_tp != want_k:
            print(f"FAULT: the {arch} serve beyond its limits or launches "
                  f"differ", flush=True)
            ok = False
        del params, want, got
        if DEV != "cpu":
            torch.cuda.empty_cache()
    return ok


def _bf16_moves(got_p, want_p, got_g, want_g, lr):
    """(the largest parameter move in lr where both steps' gradients
    exceed ADAMW_NEAR_EPS with one sign or are both 0, the largest
    elsewhere, the count elsewhere, the count of all)."""
    import torch
    far = near = 0.0
    n_near = n_all = 0
    for p, q, g, w in zip(got_p, want_p, got_g, want_g):
        g, w = g.float(), w.float()
        moved = (p - q).abs() / lr
        small = (g.sign() != w.sign()) | (w != 0) & (
            (w.abs() <= ADAMW_NEAR_EPS) | (g.abs() <= ADAMW_NEAR_EPS))
        far = max(far, float(torch.where(small, 0.0, moved).max()))
        near = max(near, float(torch.where(small, moved, 0.0).max()))
        n_near += int(small.sum())
        n_all += small.numel()
    return far, near, n_near, n_all


# ----------------------------------------------------------- phase 17
# The dry run (repro_torch.launch.dryrun) on the card's machine, in a
# process of its own (a process has one default group: a fake group of 1,
# 256 or 512 ranks takes its place there), started after phase 15 so
# that it traces beside phase 16, then beside (c) in this process:
# (a) granite-3-2b's phase 15 step (b) and mamba2-780m's (f) traced on
# fake CUDA tensors over a (1, 1) fake mesh, through K4-K6's fake kernels:
# the predicted peak per card within DRY_PEAK_RTOL of what phase 15
# allocated at most, and the traced FLOPs over phase 15's median step wall
# as a share of the bf16 tensor rate; (b) every train cell (each
# architecture at train_4k) and the reference test's decode cells
# (tests/test_distributed.py:130: granite-3-2b at decode_32k) on the
# production meshes, 256 and 512 fake ranks, in DRY_GROUPS processes beside
# each other and (a), every row ok; each train cell's peak per card, FLOPs
# and collective bytes printed beside the same cell's before the step
# became tensor-parallel (DRY_BEFORE: the ZeRO-3 step that gathered every
# weight whole, traced by the dry run of the commit before it on an H100's
# machine), and grok-1-314b's peak on 256 ranks at least DRY_GROK_FALL
# times lower; and grok-1-314b's train cell on 256 ranks again with
# --seq-shard (sequence parallelism), in a process of its own, its peak
# below the same run's row without it;
# (c) methylseq at SMALL_SCALE serially through the per-model loop
# (fused=False) and the fused path on the card, counters zeroed before
# each: integer choices and failures equal, allocations within ALLOC_RTOL,
# K1 and K2 once per model call of the loop.
DRY_PEAK_RTOL = 0.25
# (b)'s groups, each a process for each mesh, of about equal trace time
# (a train cell traced in 11-30 s on the card's machine, grok-1-314b the
# longest): granite-3-2b's decode cell rides with its train cell
DRY_GROUPS = [("granite-3-2b", "train_4k,decode_32k"),
              ("grok-1-314b,musicgen-large", "train_4k"),
              ("qwen1.5-32b,zamba2-7b,minitron-8b", "train_4k"),
              ("internvl2-26b,phi3.5-moe-42b-a6.6b,mamba2-780m,yi-9b",
               "train_4k")]
DRY_BEFORE = "results/dryrun_train_zero3.jsonl"
DRY_GROK_FALL = 10.0
DRY_TIMEOUT = 900


def _dry_worker(arg: str) -> int:
    """Phase 17 (a) and (b), in the dry-run process; exit 1 on a fault."""
    import logging

    from repro_torch.analysis.kernel_costs import PEAK_FLOPS_BF16
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import scaled_config
    # DTensor warns at every two-axis redistribution
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    measured = json.loads(arg)
    t_start = time.perf_counter()
    ok = True
    # (b) in processes of their own (each its fake group), beside (a)
    import atexit
    outs = REPO / "build" / "phase17"
    outs.mkdir(parents=True, exist_ok=True)
    procs = []
    for mesh in ("single", "multi"):
        for i, (archs, shapes) in enumerate(DRY_GROUPS):
            out = outs / f"dry_{mesh}_{i}.jsonl"
            out.unlink(missing_ok=True)
            procs.append((out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", archs, "--shape", shapes, "--mesh", mesh,
                 "--device", DEV, "--out", str(out)],
                env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            atexit.register(_stop_worker, procs[-1][1])
    seq_out = outs / "dry_single_seq.jsonl"
    seq_out.unlink(missing_ok=True)
    procs.append((seq_out, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "grok-1-314b", "--shape", "train_4k", "--mesh", "single",
         "--seq-shard", "--device", DEV, "--out", str(seq_out)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    atexit.register(_stop_worker, procs[-1][1])
    steps = {"granite": (get_config(TRAIN_ARCH), 8, 256),
             "mamba2": (scaled_config(get_config(SSM_ARGV[1]), SSM_ARGV[3]),
                        int(SSM_ARGV[7]), int(SSM_ARGV[9]))}
    for name, (cfg, batch, seq) in steps.items():
        t0 = time.perf_counter()
        with dryrun.fake_world(1):
            mesh = make_test_mesh(1, 1, device_type=DEV)
            got = dryrun.trace_cell(cfg, ShapeConfig("phase15", seq, batch,
                                                     "train"), mesh,
                                    device=DEV)
        mem, m = got["memory"], measured[name]
        meas = m["peak"] / 1024**3
        rel = abs(mem["peak_gb"] - meas) / meas
        rate = got["flops"] / m["step_s"]
        print(f"[dry a] {cfg.name} {batch} x {seq}, remat {cfg.remat}, "
              f"AdamW, {cfg.compute_dtype} on a (1, 1) fake {DEV} mesh: "
              f"predicted peak {mem['peak_gb']:.3f} GiB (arguments "
              f"{mem['argument_gb']:.3f}, temporaries {mem['temp_gb']:.3f}), "
              f"phase 15's card peak {meas:.3f} GiB: {rel:.3f} apart (tol "
              f"{DRY_PEAK_RTOL}); {got['flops']:.4e} FLOP a step over the "
              f"median wall {m['step_s']:.4f} s = {rate / 1e12:.1f} TFLOP/s, "
              f"{rate / PEAK_FLOPS_BF16:.4f} of {PEAK_FLOPS_BF16 / 1e12:.0f}"
              f" TFLOP/s; collectives "
              f"{got['collectives']['total_bytes']} B; traced in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok = ok and rel <= DRY_PEAK_RTOL
    t0 = time.perf_counter()
    rows, seq_rows = [], []
    for out, proc in procs:
        try:
            log, _ = proc.communicate(timeout=DRY_TIMEOUT)
        except subprocess.TimeoutExpired:
            _stop_worker(proc)
            log, ok = "timed out", False
        if proc.returncode != 0:
            print(log)
            ok = False
        got = [json.loads(line) for line in open(out)] \
            if out.exists() else []
        (seq_rows if out == seq_out else rows).extend(got)
    before = {(r["arch"], r["mesh"]): r for r in map(
        json.loads, open(REPO / DRY_BEFORE))}
    for r in rows:
        if r["status"] != "ok":
            print(f"[dry b] {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r['status']} {r.get('error', '')}\n"
                  f"{r.get('traceback', '')}")
            continue
        rt, c, mem = r["roofline"], r["cost"], r["memory"]
        head = (f"[dry b] {r['arch']} {r['shape']} on {r['chips']} ranks "
                f"({r['mesh']}): ok, bottleneck {rt['bottleneck']} (compute "
                f"{rt['compute_s']:.4e} s, memory {rt['memory_s']:.4e} s, "
                f"collective {rt['collective_s']:.4e} s), traced in "
                f"{r['trace_s']} s; ")
        if r["kind"] != "train":
            print(head + f"peak {mem['peak_gb']:.2f} GiB a card, "
                  f"{c['flops']:.4e} FLOP, {c['collective_bytes']:.4e} "
                  f"collective bytes")
            continue
        was = before[(r["arch"], r["mesh"])]
        kinds = ", ".join(f"{k} {v:.4e}" for k, v in
                          r["collectives"]["bytes_by_kind"].items() if v)
        print(head + f"a card, before -> after tensor parallelism: peak "
              f"{was['peak_gb']:.2f} -> {mem['peak_gb']:.2f} GiB "
              f"(arguments {was['argument_gb']:.2f} -> "
              f"{mem['argument_gb']:.2f}, temporaries "
              f"{mem['temp_gb']:.2f}), {was['flops']:.4e} -> "
              f"{c['flops']:.4e} FLOP, {was['collective_bytes']:.4e} -> "
              f"{c['collective_bytes']:.4e} collective bytes ({kinds})")
        if (r["arch"], r["mesh"]) == ("grok-1-314b", "single") \
                and was["peak_gb"] < DRY_GROK_FALL * mem["peak_gb"]:
            print(f"[dry b] grok-1-314b's peak fell less than "
                  f"{DRY_GROK_FALL:g} times")
            ok = False
    tp_row = [r for r in rows if (r["arch"], r["mesh"], r["shape"]) == (
        "grok-1-314b", "single", "train_4k") and r["status"] == "ok"]
    if len(seq_rows) != 1 or seq_rows[0]["status"] != "ok" or not tp_row:
        print(f"[dry b] grok-1-314b train_4k with --seq-shard: {seq_rows}")
        ok = False
    else:
        r, t = seq_rows[0], tp_row[0]
        m, mt = r["memory"], t["memory"]
        kinds = ", ".join(f"{k} {v:.4e}" for k, v in
                          r["collectives"]["bytes_by_kind"].items() if v)
        print(f"[dry b] grok-1-314b train_4k on {r['chips']} ranks with "
              f"--seq-shard, traced in {r['trace_s']} s: a card, without -> "
              f"with: peak {mt['peak_gb']:.2f} -> {m['peak_gb']:.2f} GiB "
              f"(arguments {mt['argument_gb']:.2f} -> {m['argument_gb']:.2f}"
              f", temporaries {mt['temp_gb']:.2f} -> {m['temp_gb']:.2f}), "
              f"{t['cost']['flops']:.4e} -> {r['cost']['flops']:.4e} FLOP, "
              f"{t['cost']['collective_bytes']:.4e} -> "
              f"{r['cost']['collective_bytes']:.4e} collective bytes "
              f"({kinds})")
        if m["peak_gb"] >= mt["peak_gb"]:
            print("[dry b] grok-1-314b's peak did not fall with --seq-shard")
            ok = False
    n_cells = 2 * (len(",".join(a for a, _ in DRY_GROUPS).split(",")) + 1)
    ok = ok and len(rows) == n_cells \
        and all(r["status"] == "ok" for r in rows)
    print(f"[dry] (a) and (b) wall {time.perf_counter() - t_start:.1f} s "
          f"((b) waited for {time.perf_counter() - t0:.1f} s after (a))")
    return 0 if ok else 1


def loop_vs_fused() -> dict:
    """Phase 17 (c): the per-model loop against the fused path on the
    card. Returns the K1 and K2 shapes the loop launched."""
    import numpy as np
    import torch
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    runs = {}
    for fused in (True, False):
        calls = {"_predict_loop": 0, "_observe_loop": 0}

        def on_method(m, fused=fused, calls=calls):
            # the predictor reads its flag at each call and holds no
            # state yet: the loop from the first task on
            m.predictor.fused = fused
            for name in calls:
                f = getattr(m.predictor, name)

                def counted(*a, f=f, name=name):
                    calls[name] += 1
                    return f(*a)
                setattr(m.predictor, name, counted)
        shapes, restore = _recording_shapes()
        reset_launch_counts()
        try:
            res, decs, wall, _ = _replay(SMALL_SCALE, DEV, "sizey",
                                         on_method)
            torch.cuda.synchronize()
        finally:
            restore()
        launches = dict(KERNEL_LAUNCHES)
        runs[fused] = (res, decs, wall, launches, calls, shapes)
        n = len(res.outcomes)
        print(f"[loop c] fused={fused}: methylseq scale={SMALL_SCALE}, "
              f"{n} tasks, wastage_gbh {res.wastage_gbh!r}, failures "
              f"{res.n_failures}, wall {wall:.3f} s ({n / wall:.2f} "
              f"tasks/s); launches K1 {launches.get('ensemble_mlp', 0)}, "
              f"K2 {launches.get('knn_predict', 0)}; loop calls {calls}")
    (rf, df, *_), (rl, dl, _w, launches, calls, shapes) = runs[True], \
        runs[False]
    if len(df) != len(dl):
        _fail("phase 17 (c): the loop and the fused path took different "
              "numbers of decisions")
    mism, worst = 0, 0.0
    for (a, _), (b, _) in zip(df, dl):
        if a.source != b.source:
            _fail("phase 17 (c): the loop and the fused path disagree on "
                  "preset vs model")
        if a.source == "model":
            mism += (a.offset_idx != b.offset_idx
                     or int(np.argmax(a.raq)) != int(np.argmax(b.raq)))
            worst = max(worst, abs(a.allocation_gb - b.allocation_gb)
                        / abs(a.allocation_gb))
    model_calls = sum(calls.values())
    print(f"[loop c] {len(dl)} decisions: integer mismatches {mism} (tol 0), "
          f"failures fused {rf.n_failures} loop {rl.n_failures}, max alloc "
          f"rel diff {worst:.3e} (tol {ALLOC_RTOL:g}); K1 and K2 launches "
          f"{launches.get('ensemble_mlp', 0)} and "
          f"{launches.get('knn_predict', 0)}, model calls of the loop "
          f"{model_calls} ({calls['_predict_loop']} predicts, "
          f"{calls['_observe_loop']} observes)")
    if mism or rf.n_failures != rl.n_failures or worst > ALLOC_RTOL:
        _fail("phase 17 (c): the loop and the fused path disagree")
    if not calls["_predict_loop"] or any(
            launches.get(k, 0) != model_calls
            for k in ("ensemble_mlp", "knn_predict")):
        _fail("phase 17 (c): K1 and K2 did not launch once per model call "
              "of the loop")
    return shapes


def check_loop_shapes(shapes) -> dict:
    """K1 and K2 at every shape phase 17 (c) launched that phase 3 did not
    check, held to their plain versions as in phase 3. Returns the
    largest differences per kernel."""
    k1 = sorted(sh for sh in shapes["ensemble_mlp"] if sh not in K1_SHAPES)
    k2 = sorted(sh for sh in shapes["knn_predict"] if sh not in K2_SHAPES)
    print(f"[loop c] shapes launched: K1 {sorted(shapes['ensemble_mlp'])}, "
          f"K2 {sorted(shapes['knn_predict'])}; not checked before, checked "
          f"now: K1 {k1}, K2 {k2}")
    return check_kernels(k1, k2) if k1 or k2 else {}


def dryrun_start(measured: dict):
    """Start phase 17's dry-run process ((a) and (b)), which needs only
    phase 15's measurements and launches nothing on the card, so that it
    traces beside phase 16. Its output goes to a file until
    ``dryrun_phase`` joins it."""
    import atexit
    log = REPO / "build" / "phase17_dry.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--dry",
             json.dumps(measured)], stdout=out, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.setpriority(os.PRIO_PROCESS, 0, max(
                WORKER_NICE, os.getpriority(os.PRIO_PROCESS, 0))))
    atexit.register(_stop_worker, proc)
    return proc, log, time.perf_counter()


def dryrun_phase(started) -> None:
    """Phase 17: wait for the dry-run process that ``dryrun_start``
    started ((a) and (b)); (c) runs in a worker of its own."""
    proc, log, t0 = started
    t_here = time.perf_counter()
    try:
        proc.wait(timeout=DRY_TIMEOUT)
    except subprocess.TimeoutExpired:
        _stop_worker(proc)
    print(log.read_text(), end="")
    print(f"[dry] phase 17 wall {time.perf_counter() - t0:.1f} s since its "
          f"process started, {time.perf_counter() - t_here:.1f} s after "
          f"phase 16")
    if proc.returncode != 0:
        _fail(f"phase 17: the dry run failed (exit {proc.returncode})")


def _stamp(t_start: float, what: str) -> None:
    print(f"[t] {time.perf_counter() - t_start:.1f} s: {what}")


def main() -> int:
    from collections import Counter

    import torch
    if sys.argv[1:2] == ["--worker"]:
        return _worker_main(*sys.argv[2:4])
    if sys.argv[1:2] == ["--dry"]:
        return _dry_worker(sys.argv[2])
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(f"[gpu] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    build_kernels()
    if sys.argv[1:2] == ["--train-only"]:
        # phases 1, 2, 15, 16 and 17 alone, for work on the training slice
        rows, measured, time_rows = train_phase()
        time_rows()
        dry = dryrun_start(measured)
        errors, _ = distributed_phase()
        errors.update(check_loop_shapes(loop_vs_fused()))
        dryrun_phase(dry)
        for row in rows:
            if row["name"] in errors:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         errors[row["name"]])
        print(json.dumps({"kernels": rows}))
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    # the replays (phases 4-6, 13, 14, 17 (c) and 18) are bound by the
    # host: each runs in a worker from here on, beside phase 3 and the
    # LM, training and distributed phases in this process; every worker
    # is joined before any kernel is timed
    paper_started = paper_start()
    workers = {task: _start_worker(task) for task, _ in HOST_WORKERS}
    _stamp(t_start, f"{len(workers) + len(paper_started['procs'])} "
                    f"workers started")
    errors = check_kernels()
    errors["segment_dp"] = max(check_segment_dp(),
                               check_segment_dp(K3_EDGES))
    _stamp(t_start, "phase 3 done")
    kernels_lm, time_lm = lm_phases()
    _stamp(t_start, "phases 8-12 done")
    # phase 15: training on the card, K4's and K6's backward
    train_rows, measured, time_train = train_phase()
    _stamp(t_start, "phase 15 done")
    # phase 17's dry run (a)-(b) traces from here on, beside phase 16
    dry = dryrun_start(measured)
    # phase 16: the distributed layer on a 1-device mesh, and (b) tensor
    # parallelism on a (1, 2) gloo mesh with K4 and K6 at per-rank shapes
    # (K5's log-sum-exp variant runs on its tensor-parallel decode)
    errors16, serve_launches = distributed_phase()
    dryrun_phase(dry)
    _stamp(t_start, "phases 16 and 17 done")
    kinds = ("ensemble_mlp", "knn_predict", "segment_dp")
    results, w_shapes = {}, {}
    for task, phase in HOST_WORKERS:
        results[task] = {}
        w_shapes[task] = {k: Counter() for k in kinds}
        try:
            _join_worker(task, workers[task], w_shapes[task], HOST_TIMEOUT,
                         phase=phase, results=results[task])
        finally:
            _stop_worker(workers[task])
    _stamp(t_start, "phases 4-6, 13, 14 and 17 (c) joined")
    main = dict(results["peak"]["main"])
    main["shapes"] = _shapes_load(main["shapes"])
    temporal = dict(results["temporal"]["temporal"])
    temporal["shapes"] = _shapes_load(temporal["shapes"])
    ks_plus = {"shapes": _shapes_load(
        results["temporal"]["ks_plus"]["shapes"])}
    cluster = {"shapes": w_shapes["cluster_phase"],
               **{k: {"shapes": _shapes_load(
                   results["cluster_phase"][f"shapes_{k}"])}
                  for k in ("a", "b")}}
    r_shapes = w_shapes["risk_phase"]
    # phases 13 and 14: each engine run's predict dispatches below the
    # serial replay's of phase 4
    check_serial(results["cluster_phase"]["waves"]
                 + results["risk_phase"]["waves"],
                 main["disp"]["predict_pool"])
    # every shape the two paths launched is held against the plain version
    seen = {k: set(main["shapes"][k]) | set(temporal["shapes"][k])
            for k in ("ensemble_mlp", "knn_predict")}
    k1_seen = sorted(s for s in seen["ensemble_mlp"] if s not in K1_SHAPES)
    k2_seen = sorted(s for s in seen["knn_predict"] if s not in K2_SHAPES)
    if k1_seen or k2_seen:
        more = check_kernels(k1_seen, k2_seen)
        errors = {k: max(v, more.get(k, 0.0)) for k, v in errors.items()}
    listed = {(m, g, k) for m in K3_MS for g in K3_GS
              for k in (1, 2, 4, g)} | set(K3_EDGES)
    k3_seen = sorted((set(temporal["shapes"]["segment_dp"])
                      | set(ks_plus["shapes"]["segment_dp"])) - listed)
    if k3_seen:
        errors["segment_dp"] = max(errors["segment_dp"],
                                   check_segment_dp(k3_seen))
    c_shapes = cluster["shapes"]
    # phase 18 (the paper's grid, in workers since the build) is joined
    # here, before any kernel is timed; every K1 and K2 shape it launched
    # that phases 3-5 did not check is held to its plain version as in 3
    p_shapes = paper_phase(paper_started)
    _stamp(t_start, "phase 18 joined")
    k1_paper = sorted(s for s in p_shapes["ensemble_mlp"]
                      if s not in K1_SHAPES and s not in seen["ensemble_mlp"])
    k2_paper = sorted(s for s in p_shapes["knn_predict"]
                      if s not in K2_SHAPES and s not in seen["knn_predict"])
    print(f"[paper] shapes launched in phase 18 that phases 3-5 did not "
          f"check, checked now: K1 {k1_paper}, K2 {k2_paper}")
    if k1_paper or k2_paper:
        more = check_kernels(k1_paper, k2_paper)
        errors = {k: max(v, more.get(k, 0.0)) for k, v in errors.items()}
    # phase 17 (c): every K1 and K2 shape the per-model loop launched that
    # phase 3 did not check
    errors16.update(check_loop_shapes(w_shapes["loop"]))
    # phase 7
    # K1 and K2 at every shape the replays launched; their JSON rows at the
    # shape the peak path launched most; K3's is the launch-weighted mean
    # over the temporal path's shapes
    k1_row = main["shapes"]["ensemble_mlp"].most_common(1)[0][0]
    k2_row = main["shapes"]["knn_predict"].most_common(1)[0][0]
    k3_launched = temporal["shapes"]["segment_dp"]
    if any(s[1:] != (32, 4) for s in k3_launched):
        _fail(f"the temporal path launched unexpected K3 shapes "
              f"{sorted(k3_launched)}")
    k1_times = time_k1(sorted(seen["ensemble_mlp"] | set(K1_TIMED)))
    k2_times = time_k2(sorted(seen["knn_predict"] | set(K2_TIMED)))
    time_k2_splits(sorted(seen["knn_predict"] | set(K2_TIMED)))
    time_mlp_predict(PREDICT_TIMED)
    for label, run in (("peak", main), ("temporal", temporal)):
        replay_totals(label, run["shapes"], k1_times, k2_times)
    k3_times = time_segment_dp(K3_TIMED)
    json_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k1 = {c: k1_times[k1_row][c] for c in json_keys}
    k2 = {c: k2_times[k2_row][c] for c in json_keys}
    k3 = segment_dp_row(k3_launched)
    k3_by_m = {}
    for (m, _g, _k), c in temporal["shapes"]["segment_dp"].items():
        k3_by_m[m] = k3_by_m.get(m, 0) + c
    print("[time] segment_dp launches on the temporal path at the timed M: "
          + ", ".join(f"M={m}: {k3_by_m.get(m, 0)}" for m in k3_times))
    print(f"[time] JSON rows at the most launched shapes: ensemble_mlp "
          f"(M,T,d,h)={k1_row} (the fused predict), knn_predict "
          f"(Q,T,d)={k2_row} (peak path); segment_dp at the temporal path's "
          f"launch-weighted mean")
    k1_new = sorted(s for s in c_shapes["ensemble_mlp"]
                    if s not in K1_SHAPES and s not in seen["ensemble_mlp"])
    k2_new = sorted(s for s in c_shapes["knn_predict"]
                    if s not in K2_SHAPES and s not in seen["knn_predict"])
    if k1_new or k2_new:
        more = check_kernels(k1_new, k2_new)
        errors = {k: max(v, more.get(k, 0.0)) for k, v in errors.items()}
    k3_new = sorted(set(c_shapes["segment_dp"]) - listed - set(k3_seen))
    if k3_new:
        errors["segment_dp"] = max(errors["segment_dp"],
                                   check_segment_dp(k3_new))
    k1_times.update(time_k1(sorted(set(c_shapes["ensemble_mlp"])
                                   - set(k1_times))))
    k2_times.update(time_k2(sorted(set(c_shapes["knn_predict"])
                                   - set(k2_times))))
    for label in ("a", "b"):
        replay_totals(f"cluster {label}", cluster[label]["shapes"], k1_times,
                      k2_times)
    # phase 14 (joined above): every K1, K2 and K3 shape it launched that
    # no earlier phase checked is held to its plain version as in phase 3
    k1_more = sorted(s for s in r_shapes["ensemble_mlp"]
                     if s not in K1_SHAPES and s not in seen["ensemble_mlp"]
                     and s not in c_shapes["ensemble_mlp"])
    k2_more = sorted(s for s in r_shapes["knn_predict"]
                     if s not in K2_SHAPES and s not in seen["knn_predict"]
                     and s not in c_shapes["knn_predict"])
    k3_more = sorted(set(r_shapes["segment_dp"]) - listed - set(k3_seen)
                     - set(c_shapes["segment_dp"]))
    print(f"[risk] shapes launched in phase 14 that no earlier phase "
          f"checked, checked now: K1 {k1_more}, K2 {k2_more}, K3 {k3_more}")
    if k1_more or k2_more:
        more = check_kernels(k1_more, k2_more)
        errors = {k: max(v, more.get(k, 0.0)) for k, v in errors.items()}
    if k3_more:
        errors["segment_dp"] = max(errors["segment_dp"],
                                   check_segment_dp(k3_more))
    kernels = [
        {"name": "ensemble_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/ensemble_mlp/kernel.cu",
         "replaces": "src/repro/kernels/ensemble_mlp/kernel.py:29",
         "launches": main["launches"]["ensemble_mlp"],
         "max_abs_err": errors["ensemble_mlp"], **k1},
        {"name": "knn_predict", "route": "cuda",
         "source": "src/repro_torch/kernels/knn/kernel.cu",
         "replaces": "src/repro/kernels/knn/kernel.py:40",
         "launches": main["launches"]["knn_predict"],
         "max_abs_err": errors["knn_predict"], **k2},
        {"name": "segment_dp", "route": "cuda",
         "source": "src/repro_torch/kernels/segment_dp/kernel.cu",
         "replaces": "src/repro/kernels/segment_dp/kernel.py:45",
         "launches": temporal["launches"]["segment_dp"],
         "max_abs_err": errors["segment_dp"], **k3},
    ]
    # phases 8-12 and 15: the LM and backward kernels timed now that the
    # card runs nothing else
    time_lm()
    time_train()
    kernels += kernels_lm + train_rows
    errors = errors16
    for row in kernels:
        if row["name"] in errors:
            row["max_abs_err"] = max(row["max_abs_err"], errors[row["name"]])
        if row["name"] == "flash_decode_lse":
            row["launches"] = serve_launches["flash_decode_lse"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
