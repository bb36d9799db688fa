#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GredoDB (``src/repro_torch``) on one
NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each raises on failure; the script then exits non-zero):
  1. device facts: card name and power limit (nvidia-smi), torch and CUDA
     versions, and the build of the six CUDA kernels from ``csrc/``;
  2. every kernel against its plain PyTorch version on the card at the
     reference sweep shapes (fp32 matmul 2e-4, bf16 2e-2; cosine, logreg,
     flash attention and embedding bag rtol 3e-4 / atol 3e-5, bf16 flash
     attention 2e-2; traversal exact, fused and batched), plus matmul at
     1000x200x1000 and 129x17x257, flash attention at Qwen2's bf16 GQA
     shapes (prefill 512 x 512 and decode against a 1024-position cache,
     ragged lengths), its split-KV decode (a 4096-position cache, bf16 and
     fp32), 77-query prefill, dh 80, 8 and 16 in bf16 and the strided
     whole-cache views in both dtypes, the embedding bag at 4096 bags
     x 16 over a 100k x 64 table and along each path of its launch plan
     (D = 3, 32, 33, 128, 200; bf16 and fp16 tables with fp32 and
     table-typed weights; 8 bags x 4096, split over warps; 262,144 bags
     x 1; a table 4 bytes off 16-byte alignment), logreg at 60000 x 4 (the
     shard regression's width) and a hop whose candidates overflow its
     capacity;
  3. the GCDIA main path on ``m2bench.generate(sf=10, seed=0)``: a warm-up
     engine, then a fresh ``GredoEngine`` runs G1-G5 and q_opt_skew,
     ``analyze`` of A2, A3 and a_shard_reg, and A1 through
     ``analytics.regression``, with every launch counter set to 0 just
     before and read just after. Checks: G3 and G5 lowered to
     device-pallas, all four counters moved, GCDI fingerprints equal to
     the port's own host matcher's, GCDA outputs equal to the plain
     versions within the tolerances above. Then each kernel is compared
     with its plain version and timed (CUDA events) on the very inputs
     the main path gave it;
  3b. the declarative surface on the same sf=10 database: seven SQL/PGQ
     texts (G1-G5, q_opt_skew, q_edge_scan) parsed by ``core.sqlpgq``,
     each equal to its ``m2bench`` builder's Query, run on the card engine
     beside the builder's query with the counters set to 0 just before
     and read just after. Checks: equal fingerprints, equal ``explain``
     text, as many hop launches as the builder's query (G3 and G5 must
     lower to device-pallas and launch the hop). Then the plan sweep
     (``analysis.verify_sweep.run_sweep(sf=1)`` on the card): 192
     combinations, none failed;
  4. the LM serving path: Qwen2-1.5B at full width and depth, bf16,
     ``attn_impl="flash"``, random weights from ``torch.Generator(seed
     0)`` on the card, driven through ``launch.serve`` (batch 8, prompt
     512, 32 new tokens) and through ``ContinuousBatcher`` (4 slots,
     max_len 1024, 12 requests of 32-512 prompt tokens and 8-32 new ones,
     so slots refill mid-flight), each once with the counters set to 0
     just before (the flash counter must move) and once more, timed.
     Checks: the kernel against its plain version at every captured
     prefill and decode call of the largest shape; the logits of a prefill
     and 4 decode steps against the same weights through the plain
     ``attn_impl="dense"`` path (max |flash - dense| <= 2e-2 * max
     |dense|); and, in fp32 with 2 layers, the batcher's greedy tokens
     against each request served alone (the prefill token must agree
     exactly; the agreement rate of the decoded tokens is printed);
  5. the MoE serving path: OLMoE-1B-7B at full width and depth (16
     layers, 64 experts top-8), bf16, flash, the router fp32, through the
     same (a) and (b) traffic as phase 4, each once with the counters set
     to 0 (flash launches must be n_layers per forward) and once more,
     timed (the tokens must repeat). Prints the decode step against the
     time to read every weight once, the share of top-k assignments
     dropped at capacity in a prefill and a decode step (recorded through
     the routing helper ``_moe_block`` calls), a profiler window of each,
     and flash against dense logits (a prefill and 4 decode steps). A
     router logit within bf16 rounding of the k-th best picks another
     expert, and the flip reaches every later token through attention and
     the capacity queues, so the dense run routes itself once (printed:
     top-k assignments that differ, tokens routed alike) and once pinned
     to the flash run's experts, which is checked: max |flash - dense| <=
     2e-2 * max |dense| in bf16, and on the same weights in fp32 <= 1e-4.
     No batched vs alone check: capacity couples the rows of a batch (as
     in the reference);
  6. the training path: Granite-MoE-1B-A400M at full width and depth, 5
     ``Trainer`` steps (bf16 activations, fp32 masters and AdamW, chunked
     attention) on ``TokenStream(batch=4, seq=512)``: finite losses, ms per
     step, peak memory; then its widths at 2 layers in fp32: one step on
     the card against one on the CPU from the same weights (loss,
     gradients, updated weights), and a run failed at step 3 (checkpoints
     every 2 steps) and restarted against an uninterrupted one
     (``TRAIN_TOL``);
  7. the recommender: Wide & Deep at its published widths (40 fields x
     1M rows x 32, wide hash 1M, MLP 1293-1024-512-256, tower 256;
     1,283,046,976 fp32 parameters from ``torch.Generator(seed 0)`` on the
     card) through its four SHAPES: ``serve_p99`` (batch 512, ms per
     call; scores against the CPU from the same weights within rtol 1e-5
     / atol 1e-6), ``serve_bulk`` (batch 262144, rows/s; ``_hash_cross``
     on the card equal bit for bit to numpy uint32), ``retrieval_cand`` (1
     query against 1M candidates of 256, top-100; the ids equal to the
     CPU's as sets except for scores within 1e-6 of the 100th) and
     ``train_batch`` (batch 65536, 5 AdamW steps, dense table gradients:
     ms per step, losses), each with its peak memory; then one AdamW step
     at full widths with vocab_per_field and wide_hash cut to 100k, batch
     4096, card against CPU (``TRAIN_TOL``);
  8. the GNNs at their published widths: (a) GatedGCN (16 layers, d 70)
     and PNA (4 layers, d 75) on ``minibatch_lg`` (a synthetic graph at
     Reddit's size on the host, 232,965 nodes and 114,615,892 edges, 602
     features, 41 classes; ``NeighborSampler`` fanout (15, 10) over 1024
     seeds), 5 AdamW steps each (sampler ms apart from step ms, peak
     memory), and the first batch card vs CPU (``GNN_TOL``); (b) GatedGCN,
     PNA and GAT (v2, its defaults) on ``full_graph_sm``, one AdamW step
     each, card vs CPU (``TRAIN_TOL``); (c) MACE (2 layers, 128 channels,
     l_max 2, correlation 3) and EquiformerV2 (12 layers, 128 channels,
     l_max 6, m_max 2, 8 heads) on ``molecule`` (128 graphs of 30 nodes
     and 64 edges), 5 AdamW steps each, rotation invariance on the card
     (MACE also translation), and card vs CPU on the first 8 graphs; (d)
     DCN-v2 at its defaults, batch 4096, one AdamW step card vs CPU. PNA's
     card vs CPU checks are held in float64 (its std aggregator is
     ill-conditioned in fp32 where a node's messages are all equal) and
     printed in fp32, and every cell's gradients and updated weights are
     held in float64 (a ReLU kink flips on rounding in fp32), its loss in
     fp32. A profiler window follows serve_bulk and each cell's AdamW
     steps. Phases 7 and 8 print the launch counters before and after: no
     kernel of the repo is on these paths;
  9. the mesh layer on a world of one: an NCCL process group of this
     process alone and a 1x1 ('data', 'model') mesh on the card. (a) The
     GCDA mesh forms (``analytics.multiply``/``similarity`` with a mesh,
     ``regression_distributed``) on phase 3's A3, A2, A1 and a_shard_reg
     inputs against their local forms (matmul 2e-4; cosine and logreg
     rtol 3e-4 / atol 3e-5), the matmul, cosine_sim and logreg counters
     set to 0 just before and required to move; (b) the three ``gredo``
     cells (``launch.specs.build_cell``) at one rank's block of the
     production 16x16 mesh (regression 262,144 x 512; similarity and
     multiply 16,384 x 256 and 4,096 x 4,096 tiles), each step against its
     plain version and timed beside its bound, plus a kernel row of each;
     (c) OLMoE-1B-7B at full width and depth on the mesh forms (the
     shard_map MoE over 'model', the sequence-sharded decode attention): a
     prefill of 8 x 512 and 4 decode steps against the unsharded dense
     path pinned to the mesh run's experts (max |diff| <= 2e-2 * max
     |dense|; the flash counter must stay at 0: with a sequence-sharded
     cache every attention call is the sharded one); (d) the dry-run
     (``launch.dryrun``) of the three gredo cells and one LM train,
     prefill and decode cell, one recsys and one GNN cell on both
     production meshes, in two child processes on the CPU started before
     phase 7 (the fake backend must not share a process with NCCL): every
     cell must be ok; per cell its FLOPs and argument bytes per device and
     its collective bytes are printed;
  10. one JSON line listing the kernels, logreg_grad once at A1's shape
     and once at a_shard_reg's, flash at phase 4's and phase 5's calls,
     and the three GCDA kernels at phase 9's per-rank blocks (launches,
     max error, times: CUDA events over back-to-back calls, the host's
     issue time, and the device time and the number of device operations
     per call from the profiler; bound), and the embedding bag (on no
     path) at the kernels_bench shape and at MLPerf DLRM-DCNv2's
     multi-hot bag (65,536 x 100 over a 40M x 128 fp32 table made on the
     card), each also timed in a CUDA graph, warm (one copy of the inputs)
     and cold (copies enough that each launch misses the L2):
     ``graph_warm_ms``, ``graph_cold_ms``; then few long bags timed in
     CUDA graphs with the plan's j split and without it;
  11. the result line ``{"ok": true, "device": {...}}``.

Nothing of JAX or of the JAX package is imported. Without a CUDA device,
or without the rest of the repository beside it, the script fails before
it prints a result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# M2Bench scale of the main path: the largest of the scales checked (1, 10,
# 20) at which the optimizer still lowers G3 and G5 to the traversal kernel,
# so the path runs all four kernels (at 20 their estimated peak frontiers
# exceed DEVICE_MAX_FRONTIER and they stay on the host matcher).
SF = 10
TOL = {"matmul": (2e-4, 2e-4), "matmul_bf16": (2e-2, 2e-2),
       "cosine_sim": (3e-4, 3e-5), "logreg_grad": (3e-4, 3e-5),
       "flash": (3e-4, 3e-5), "flash_bf16": (2e-2, 2e-2),
       "embedding_bag": (3e-4, 3e-5)}
# Serving-path checks of the bf16 model: flash against dense logits, as a
# share of the logits' scale (bf16 rounds the residual stream differently
# along the two paths over 28 layers).
LOGIT_SCALE_TOL = 2e-2
SERVE_ARCH = "qwen2-1.5b"
MOE_ARCH = "olmoe-1b-7b"
# The MoE model's flash vs dense logits in fp32 (TF32 off), the dense run
# pinned to the flash run's experts: as a share of the logits' scale, the
# MoE twins' fp32 logit tolerance.
MOE_FP32_TOL = 1e-4
TRAIN_ARCH = "granite-moe-1b-a400m"
# Training checks in fp32 with TF32 off, card against CPU and a restarted
# run against an uninterrupted one: the loss within 1e-5 (relative); each
# gradient within 1e-4 of its tensor's largest (fp32 sums in another
# order differ in their last bits); and the weights within 1e-4, a third
# of one AdamW step at lr 3e-4, wherever the clipped gradient is at least
# 100 x AdamW's eps. A first AdamW step moves a weight by lr * g / (|g| +
# eps): near eps the last-bit gradient difference is multiplied by
# lr / eps, so those weights are printed but not held; elsewhere a
# gradient of the wrong sign moves a weight by two steps.
TRAIN_TOL = {"loss": 1e-5, "grads": 1e-4, "weights": 1e-4}
CONDITIONED = 100.0      # x AdamW's eps: the weights held to TRAIN_TOL
# Wide & Deep at its published widths (configs/wide_deep.config()): 40 x
# 1M x 32 tables, a 1M wide table, MLP 1293-1024-512-256, tower 256.
WIDE_DEEP_PARAMS = 1_283_046_976
# serve_step's scores, card vs CPU from the same fp32 weights (TF32 off)
RECSYS_SERVE_TOL = (1e-5, 1e-6)
# The training check runs one AdamW step on the CPU too: at full widths
# but with vocab_per_field and wide_hash cut to 100k rows (the CPU step at
# 1M rows x 40 tables takes minutes), batch 4096.
RECSYS_CUT, RECSYS_CUT_BATCH = 100_000, 4096
# GNNs, card vs CPU (fp32, TF32 off; scatter-adds on the card sum in no
# fixed order) and invariance on the card: outputs (logits, energies)
# within 1e-4 of their scale, the loss within 1e-4 (relative), each
# gradient within 1e-4 of its tensor's largest.
GNN_TOL = {"out": 1e-4, "loss": 1e-4, "grads": 1e-4}
# EquiformerV2's backward on the CPU at 128 graphs takes minutes: the card
# vs CPU check of the molecule cell runs on the batch's first 8 graphs.
MOLECULE_CHECK_GRAPHS = 8
DCN_BATCH = 4096
GCDIA_KERNELS = ("matmul", "cosine_sim", "logreg_grad", "batched_hop",
                 "matgen")
# a_shard_reg regresses on four feature columns (m2bench.a_shard_reg)
SHARD_FEATURES = 4
DEVICE = "cuda"
# The DLRM-DCNv2 multi-hot bag (MLPerf Training, Criteo 1TB): rows of its
# largest tables, embedding dim, global batch, largest multi-hot size.
DLRM_BAG = (40_000_000, 128, 65_536, 100)
DLRM_SEED = 7
# Few long bags, where the bag's plan splits j over warps: (bags, slots, V,
# D, table dtype, weighted). The first is 8 users' 4096-long histories over
# the kernels_bench table; the last has just few enough bags to be split.
LONG_BAGS = ((8, 4096, 100_000, 64, "float32", True),
             (8, 4096, 100_000, 128, "bfloat16", False),
             (512, 1024, 1_000_000, 64, "float32", True),
             (2048, 256, 1_000_000, 64, "float32", True))


def say(*parts) -> None:
    print(*parts, flush=True)


def wrapper(name: str):
    """The kernel wrapper function of ``name`` (launches, never dispatches)."""
    from repro_torch.kernels import wrapper_module
    return getattr(wrapper_module(name), name)


def max_err(a, b) -> float:
    import torch
    if a.dtype in (torch.bool, torch.int32, torch.int64):
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def assert_close(name, got, want, rtol, atol) -> float:
    import torch
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{name}: {m}")
    return max_err(got, want)


def assert_equal(name, got, want) -> float:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(max |diff| {max_err(got, want)})")
    return 0.0


def time_ms(fn) -> tuple[float, float]:
    """Mean time per call of ``fn`` over warm back-to-back calls, by CUDA
    events; and the host's time to issue one call, over the first few of
    them (few enough that the launch queue does not fill and stall the
    host). Where the two are close, issuing the calls is what bounds the
    device time: the card waits for the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = int(min(200, max(3, 0.2 / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_host = min(reps, 10)
    start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        fn()
        if i + 1 == n_host:
            host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3 / n_host


def device_ms(fn, calls=10) -> tuple[float | None, float | None]:
    """Device time per call of ``fn``: the summed durations of the device
    operations it runs, under ``torch.profiler``, over ``calls`` warm
    calls; and the number of those operations (kernels, copies, sets) per
    call. Where the host's issue bounds back-to-back calls (``time_ms``'s
    host time near its event time), the time is the kernel's own. None and
    None when the profiler sees no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        return None, None
    return sum(spans) / calls / 1e3, len(spans) / calls


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1: device facts and the kernel build
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    from repro_torch.kernels import _lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    _lib.lib()
    say(f"kernel build: {_lib.build_seconds:.2f} s "
        f"({sorted(p.name for p in _lib.CSRC.glob('*.cu'))})")
    return card


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions at the reference sweep shapes
# ---------------------------------------------------------------------------


def random_hop_inputs(seed, n=12, chunk=8):
    """The traversal sweep's random CSR + predicate tables (numpy)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, n)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    m = int(row_ptr[-1])
    col_idx = rng.integers(0, n, m).astype(np.int32)
    edge_id = rng.permutation(m).astype(np.int32)
    member = rng.random(n) < 0.7
    edge_pred = rng.random(max(m, 1)) < 0.6
    nch = max(-(-max(m, 1) // chunk), 1)
    chunk_alive = np.ones(nch, bool)
    for c in range(nch):
        if not edge_pred[c * chunk:(c + 1) * chunk].any():
            chunk_alive[c] = False
    return row_ptr, col_idx, edge_id, member, edge_pred, chunk_alive


def phase_sweep():
    import numpy as np
    import torch
    from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
    from repro_torch.kernels.logreg.ref import logreg_grad_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.traversal import ref as tref
    from repro_torch.kernels.traversal.traversal import fused_hop

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(42)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    n_checks = 0
    for m, k, n in [(32, 32, 32), (128, 128, 128), (100, 60, 130),
                    (257, 129, 65), (1000, 200, 1000), (129, 17, 257)]:
        for dtype, tol in ((torch.float32, TOL["matmul"]),
                           (torch.bfloat16, TOL["matmul_bf16"])):
            x = t(rng.standard_normal((m, k)), dtype)
            y = t(rng.standard_normal((k, n)), dtype)
            yt = t(rng.standard_normal((n, k)), dtype).T     # transposed B
            for rhs in (y, yt):
                assert_close(f"matmul {m}x{k}x{n} {dtype}",
                             wrapper("matmul")(x, rhs), matmul_ref(x, rhs), *tol)
                n_checks += 1
    for m, n, d in [(64, 64, 32), (100, 50, 96), (33, 65, 17)]:
        x = t(rng.standard_normal((m, d)))
        y = t(rng.standard_normal((n, d)))
        assert_close(f"cosine {m}x{n}x{d}", wrapper("cosine_sim")(x, y),
                     cosine_sim_ref(x, y), *TOL["cosine_sim"])
        n_checks += 1
    # the reference sweep, plus the shard regression's d = 4 at n >= 50000
    for n, d in [(100, 16), (512, 64), (65, 7), (60000, 4)]:
        x = t(rng.standard_normal((n, d)))
        y = t(rng.integers(0, 2, n))
        w = t(rng.standard_normal(d) * 0.3)
        g1, l1 = wrapper("logreg_grad")(x, y, w)
        g2, l2 = logreg_grad_ref(x, y, w)
        assert_close(f"logreg {n}x{d} grad", g1, g2, *TOL["logreg_grad"])
        assert_close(f"logreg {n}x{d} loss", l1, l2, *TOL["logreg_grad"])
        n_checks += 1

    def hop_tables(seed, n):
        rp, ci, ei, mem, ep, ca = random_hop_inputs(seed, n=n)
        return (t(rp, torch.int32), t(ci, torch.int32), t(ei, torch.int32),
                t(mem, torch.bool), t(ep, torch.bool), t(ca, torch.bool))

    # fused: the reference sweep, plus a multi-block capacity and a
    # frontier whose candidates overflow the capacity
    for seed, capacity, n, c0 in [(0, 128, 12, 6), (1, 128, 12, 6),
                                  (2, 256, 12, 6), (3, 2048, 400, 300),
                                  (4, 128, 12, 60)]:
        rp, ci, ei, mem, ep, ca = hop_tables(seed, n)
        r = np.random.default_rng(seed + 100)
        frontier = np.zeros(capacity, np.int32)
        frontier[:c0] = r.integers(0, n, c0)
        fmask = np.zeros(capacity, bool)
        fmask[:c0] = True
        args = (rp, ci, ei, t(frontier, torch.int32), t(fmask, torch.bool),
                mem, ep, ca)
        kw = dict(capacity=capacity, chunk=8)
        got = fused_hop(*args, **kw)
        for a, b in zip(got, tref.fused_hop_ref(*args, **kw)):
            assert_equal(f"fused_hop seed={seed} cap={capacity}", a, b)
        if bool(got[4]) != (c0 == 60):
            raise AssertionError(f"fused_hop seed={seed}: overflowed "
                                 f"{bool(got[4])}")
        n_checks += 1
    # batched
    for seed, capacity, n, B in [(7, 128, 12, 5), (8, 1024, 300, 4)]:
        rp, ci, ei, mem, ep, ca = hop_tables(seed, n)
        r = np.random.default_rng(seed)
        frontiers = np.zeros((B, capacity), np.int32)
        fmasks = np.zeros((B, capacity), bool)
        for q in range(B):
            c0 = int(r.integers(1, min(capacity // 8, 8 * n) + 1))
            frontiers[q, :c0] = r.integers(0, n, c0)
            fmasks[q, :c0] = True
        args = (rp, ci, ei, t(frontiers, torch.int32), t(fmasks, torch.bool),
                mem, ep, ca)
        kw = dict(capacity=capacity, chunk=8)
        for a, b in zip(wrapper("batched_hop")(*args, **kw),
                        tref.batched_hop_ref(*args, **kw)):
            assert_equal(f"batched_hop seed={seed} B={B}", a, b)
        n_checks += 1
    n_checks += sweep_flash(rng, t) + sweep_embedding_bag(rng, t)
    torch.cuda.synchronize()
    say(f"phase 2: {n_checks} sweep cases, every kernel matches its plain "
        "version")


def sweep_flash(rng, t) -> int:
    import torch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.transformer import _dense_attention
    cases = [  # b, h, hk, sq, skv, causal, dh, dtype, lengths
        (2, 4, 4, 64, 64, True, 64, torch.float32, None),
        (2, 8, 2, 100, 100, True, 64, torch.float32, None),
        (3, 8, 2, 1, 256, True, 64, torch.float32, None),
        (2, 4, 2, 48, 96, False, 64, torch.float32, None),
        (2, 4, 2, 32, 32, True, 16, torch.float32, [32, 32]),
        (4, 12, 2, 512, 512, True, 128, torch.bfloat16, [512, 300, 511, 77]),
        (8, 12, 2, 1, 1024, True, 128, torch.bfloat16, None),
        # the tensor-core kernel and the split-KV path: decode over 32
        # splits (row 1 leaves all but one wholly past its length); packed
        # rows not a multiple of 64 with a length below sq; StableLM's dh 80
        # (prefill and split decode); dh 8 and 16, zero-padded; fp32 split
        # decode
        (2, 12, 2, 1, 4096, True, 128, torch.bfloat16, [4000, 37]),
        (3, 12, 2, 77, 200, True, 128, torch.bfloat16, [60, 150, 200]),
        (2, 8, 8, 70, 70, True, 80, torch.bfloat16, None),
        (1, 32, 32, 1, 500, True, 80, torch.bfloat16, [433]),
        (2, 4, 2, 33, 40, True, 8, torch.bfloat16, [33, 40]),
        (2, 4, 2, 32, 32, True, 16, torch.bfloat16, [32, 32]),
        (2, 8, 2, 1, 1024, True, 64, torch.float32, [1000, 5])]
    for b, h, hk, sq, skv, causal, dh, dtype, lens in cases:
        q = t(rng.standard_normal((b, h, sq, dh)), dtype)
        k = t(rng.standard_normal((b, hk, skv, dh)), dtype)
        v = t(rng.standard_normal((b, hk, skv, dh)), dtype)
        lens = t(rng.integers(max(sq, 1), skv + 1, b) if lens is None
                 else lens, torch.int32)
        tol = TOL["flash_bf16" if dtype == torch.bfloat16 else "flash"]
        got = wrapper("flash_attention")(q, k, v, lens, causal=causal)
        name = f"flash b={b} h={h}/{hk} sq={sq} skv={skv} dh={dh} {dtype}"
        assert_close(name, got,
                     flash_attention_ref(q, k, v, lens, causal=causal), *tol)
        if dh == 16:       # the reference's check against the model's oracle
            assert_close(name + " vs dense", got,
                         _dense_attention(q, k, v, lens, True), *tol)
    # the transformer's inputs: q a transposed (b, s, h, dh) view, k/v
    # per-layer views of the whole cache, one length below sq
    for dtype in (torch.float32, torch.bfloat16):
        q = t(rng.standard_normal((2, 5, 6, 128)), dtype).transpose(1, 2)
        cache = t(rng.standard_normal((3, 2, 2, 40, 128)), dtype)
        lens = t([17, 3], torch.int32)
        got = wrapper("flash_attention")(q, cache[1], cache[2], lens)
        name = f"flash strided whole cache {dtype}"
        if got.stride() != q.stride() or bool(got[1, :, :2].any()):
            raise AssertionError(f"{name}: layout or zero rows")
        assert_close(name, got, flash_attention_ref(q, cache[1], cache[2],
                                                    lens),
                     *TOL["flash_bf16" if dtype == torch.bfloat16
                          else "flash"])
    return len(cases) + 2


def embedding_bag_inputs(rng, t, nbags, bag, V, D, weighted=True,
                         dtype=None, wdtype=None, offset=0, exact=None):
    """Table, indices (bag 0 padded past its first slot) and weights from
    ``rng``; the table cast to ``dtype`` and the weights to ``wdtype``
    (float32 by default); ``offset`` > 0 makes the table a contiguous view
    that many elements into a flat tensor (off 16-byte alignment). Bags of
    more than 1000 slots take small integers as table values and quarters
    as weights, so that every order of summation is exact in fp32 (a sum
    of 4096 normal values that cancels differs between two orders by more
    than the tolerance of its small result); ``exact`` overrides that."""
    import torch
    exact = bag > 1000 if exact is None else exact
    idx = rng.integers(0, V, (nbags, bag)).astype("int32")
    idx[0, 1:] = -1
    flat = t(rng.integers(-8, 8, offset + V * D) if exact
             else rng.standard_normal(offset + V * D))
    if dtype is not None:
        flat = flat.to(dtype)
    table = flat[offset:offset + V * D].view(V, D)
    w = None
    if weighted:
        w = t(rng.integers(0, 5, (nbags, bag)) / 4 if exact
              else rng.random((nbags, bag)))
    if w is not None and wdtype is not None:
        w = w.to(wdtype)
    return table, t(idx, torch.int32), w


def sweep_embedding_bag(rng, t) -> int:
    """The reference sweep shapes, then each path of the kernel's plan:
    D = 32 and 128, bf16 and fp16 tables with fp32 and table-typed
    weights, few long bags (j split over warps), many one-slot bags, odd
    widths and a table 4 bytes off 16-byte alignment (scalar loads)."""
    import torch
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    bf16, f16 = torch.bfloat16, torch.float16
    cases = [(8, 4, 64, 16, True, {}), (16, 8, 500, 32, True, {}),
             (16, 8, 500, 32, False, {}), (4096, 16, 100_000, 64, True, {}),
             (1000, 20, 5000, 32, True, {}), (1000, 20, 5000, 128, False, {}),
             (4096, 16, 100_000, 64, True, dict(dtype=bf16)),
             (4096, 16, 100_000, 64, True, dict(dtype=bf16, wdtype=bf16)),
             (1000, 20, 5000, 128, False, dict(dtype=f16)),
             (1000, 20, 5000, 200, True, dict(dtype=f16, wdtype=f16)),
             (8, 4096, 100_000, 64, True, {}),
             (8, 4096, 100_000, 128, False, dict(dtype=bf16)),
             (262_144, 1, 100_000, 64, True, {}),
             (1000, 20, 5000, 64, True, dict(offset=1)),
             (1000, 20, 5000, 3, True, {}), (1000, 20, 5000, 33, False, {})]
    for nbags, bag, V, D, weighted, kw in cases:
        args = embedding_bag_inputs(rng, t, nbags, bag, V, D, weighted, **kw)
        assert_close(f"embedding_bag {nbags}x{bag} over {V}x{D} "
                     f"{args[0].dtype} weights "
                     f"{None if args[2] is None else args[2].dtype} "
                     f"offset {kw.get('offset', 0)}",
                     wrapper("embedding_bag")(*args),
                     embedding_bag_ref(*args), *TOL["embedding_bag"])
    for D, kw in ((64, dict(weighted=True)),
                  (128, dict(weighted=False, dtype=bf16))):
        args = embedding_bag_inputs(rng, t, 8, 4096, 100_000, D, exact=False,
                                    **kw)
        assert_within_sum_bound(f"embedding_bag 8x4096 over 100000x{D} "
                                f"{args[0].dtype}, normal values",
                                wrapper("embedding_bag")(*args), *args)
    return len(cases) + 2


def assert_within_sum_bound(name, got, table, idx, w) -> float:
    """The bag sums ``got`` against a float64 sum, within Higham and Mary's
    probabilistic bound for fp32 summation of n = bag exact terms (each
    w * row is exact inside an fma) in any order: gamma * sum_j |w * row|
    per element, gamma = exp(lam sqrt(n) u + n u^2 / (1 - u)) - 1 with
    u = 2**-24 and lam = 8, which holds with probability at least
    1 - 2n exp(-lam^2 (1 - u)^2 / 2) (1 - 1e-10 at n = 4096) when the
    rounding errors are independent. A dropped slot, a wrong row or sums
    kept in 16 bits exceed it; the deterministic bound (n - 1) u sum |w *
    row| would not see a dropped slot at n = 4096."""
    import torch
    valid = idx >= 0
    w64 = valid.double() if w is None else w.double() * valid
    terms = table[idx.clamp_min(0).long()].double() * w64[..., None]
    err = (got.double() - terms.sum(1)).abs()
    n, u, lam = idx.shape[1], 2.0 ** -24, 8.0
    gamma = math.expm1(lam * math.sqrt(n) * u + n * u * u / (1 - u))
    bound = gamma * terms.abs().sum(1)
    if not bool((err <= bound).all()):
        worst = float((err / bound.clamp_min(1e-300)).max())
        raise AssertionError(f"{name}: error {float(err.max()):.3e} exceeds "
                             f"the summation bound ({worst:.2f} of it)")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 3: the main path at sf=10
# ---------------------------------------------------------------------------


class Capture:
    """Records, per kernel, the last main-path call of those with the most
    work, so the kernels can later be compared and timed on exactly those
    inputs (for logreg_grad that is A1's last step, at trained weights).
    ``kind`` splits a kernel's calls (flash attention: prefill, decode);
    ``counts`` holds each kind's launches, read from the wrapper's own
    counter around every call; ``clone`` copies the recorded tensors (the
    KV cache that flash attention reads is written again later)."""

    def __init__(self):
        self.calls: dict = {}
        self.counts: dict = {}
        self._restore: list = []

    def wrap(self, name, work, kind=None, clone=False, entry=None):
        """Record the calls of kernel ``name``'s wrapper function ``entry``
        (the function named as the kernel by default)."""
        import torch
        from repro_torch.kernels import wrapper_module
        mod = wrapper_module(name)
        entry = entry or name
        orig = getattr(mod, entry)

        def recorder(*args, **kw):
            w = work(*args, **kw)
            key = name if kind is None else f"{name}/{kind(*args, **kw)}"
            if key not in self.calls or w >= self.calls[key][0]:
                kept = args if not clone else tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
                self.calls[key] = (w, kept, kw)
            before = mod.launches
            out = orig(*args, **kw)
            self.counts[key] = self.counts.get(key, 0) + mod.launches - before
            return out
        setattr(mod, entry, recorder)
        self._restore.append((mod, entry, orig))

    def close(self):
        for mod, fn_name, orig in self._restore:
            setattr(mod, fn_name, orig)
        self._restore.clear()


def run_main_path(eng, db, m2bench, analytics, times=None):
    """One pass of the slice's main path through the public entry points.
    Returns the results by name; fills per-query wall times (each ending in
    a device synchronise) when ``times`` is given."""
    import torch

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if times is not None:
            times[name] = (time.perf_counter() - t0) * 1e3
        return out

    out = {}
    for name, q in (("G1", m2bench.q_g1), ("G2", m2bench.q_g2),
                    ("G3", m2bench.q_g3), ("G4", m2bench.q_g4),
                    ("G5", m2bench.q_g5), ("q_opt_skew", m2bench.q_opt_skew)):
        out[name] = timed(name, lambda: eng.query(q()))
        out[name + ".rewrites"] = list(eng.last_stats.rewrites)
    for name, task in (("A2", m2bench.a2_similarity),
                       ("A3", m2bench.a3_multiply),
                       ("a_shard_reg", m2bench.a_shard_reg)):
        out[name] = timed(name, lambda: eng.analyze(task()))

    def a1():
        X, groups = analytics.random_access_matrix(
            out["G1"], "Customer.id", "t.tid", m2bench.N_TAGS,
            device=eng.device)
        y = torch.as_tensor(m2bench.purchase_labels(db)[groups],
                            device=eng.device)
        return X, y, analytics.regression(X, y, iters=100)
    out["A1"] = timed("A1", a1)
    return out


def phase_main():
    import torch
    from repro_torch.core import GredoEngine, analytics, optimizer
    from repro_torch.core.observe import result_fingerprint
    from repro_torch.data import m2bench
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    db = m2bench.generate(sf=SF, seed=0)
    say(f"phase 3: m2bench sf={SF} generated in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")

    run_main_path(GredoEngine(db), db, m2bench, analytics)     # warm-up
    torch.cuda.synchronize()

    cap = Capture()
    cap.wrap("matmul", lambda x, y: x.shape[0] * x.shape[1] * y.shape[1])
    cap.wrap("cosine_sim", lambda x, y: x.shape[0] * y.shape[0] * x.shape[1])
    cap.wrap("logreg_grad", lambda x, y, w: x.numel(), kind=logreg_kind)
    # the chain runner takes the single-query entry (frontier (C,))
    for entry in ("batched_hop", "fused_hop"):
        cap.wrap("batched_hop",
                 lambda *a, capacity, chunk: a[3].numel() // a[3].shape[-1]
                 * capacity, entry=entry)
    eng = GredoEngine(db)
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        res = run_main_path(eng, db, m2bench, analytics, times)
    finally:
        cap.close()
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    say("phase 3 launches on the main path: " + json.dumps(launches))
    missing = [k for k in GCDIA_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for q in ("G3", "G5"):
        notes = [n for n in res[q + ".rewrites"] if "device-pallas" in n]
        if not notes:
            raise AssertionError(f"{q} was not lowered to device-pallas: "
                                 f"{res[q + '.rewrites']}")
        say(f"{q}: {notes[0]}")

    # GCDI results against the port's own host matcher
    optimizer.DEVICE_MATCH = False
    try:
        host = GredoEngine(db)
        for q, qfn in (("G1", m2bench.q_g1), ("G2", m2bench.q_g2),
                       ("G3", m2bench.q_g3), ("G4", m2bench.q_g4),
                       ("G5", m2bench.q_g5),
                       ("q_opt_skew", m2bench.q_opt_skew)):
            ref = host.query(qfn())
            if any("device-pallas" in n for n in host.last_stats.rewrites):
                raise AssertionError(f"{q}: host engine chose a device path")
            a, b = result_fingerprint(res[q]), result_fingerprint(ref)
            if a != b:
                raise AssertionError(f"{q}: fingerprint {a} != host {b}")
            say(f"{q}: {res[q].nrows} rows, fingerprint {a} == host matcher")
    finally:
        optimizer.DEVICE_MATCH = True

    # GCDA outputs against the plain versions
    plain = GredoEngine(db)
    for name, task, tol in (("A2", m2bench.a2_similarity, TOL["cosine_sim"]),
                            ("A3", m2bench.a3_multiply, TOL["matmul"]),
                            ("a_shard_reg", m2bench.a_shard_reg,
                             TOL["logreg_grad"])):
        got = res[name]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite output")
        want = plain.analyze(task(), use_kernel=False)
        err = assert_close(name, got, want, *tol)
        say(f"{name}: shape {tuple(got.shape)} max |kernel - plain| {err:.3g}")
        del want
    diag = torch.diagonal(res["A2"])
    if float((diag - 1).abs().max()) > 1e-3:
        raise AssertionError("A2: cosine self-similarity diagonal is not 1")
    X, y, (w, loss) = res["A1"]
    w_p, loss_p = analytics.regression(X, y, iters=100, use_kernel=False)
    assert_close("A1 weights", w, w_p, *TOL["logreg_grad"])
    assert_close("A1 loss", loss, loss_p, *TOL["logreg_grad"])
    acc = float(((X @ w > 0) == (y > 0.5)).float().mean())
    say(f"A1: {tuple(X.shape)} loss {float(loss):.6f} train accuracy "
        f"{acc:.4f}; matches the plain version")
    say("phase 3 wall ms (after warm-up, synchronised): "
        + json.dumps({k: round(v, 3) for k, v in times.items()}))
    say(f"phase 3 peak device memory: {peak_gib:.3f} GiB")
    del res, plain
    torch.cuda.empty_cache()
    return launches, cap, db


# ---------------------------------------------------------------------------
# Phase 3b: declarative surface and plan sweep on the card
# ---------------------------------------------------------------------------

# The SQL/PGQ text of each workload query; parse() must give the builder's
# Query (same name in data/m2bench.py).
SQL_TEXTS = {
    "q_g1": "SELECT Customer.id, t.tid FROM Customer MATCH "
            "(p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in "
            "WHERE t.content = 'food' AND Customer.person_id = p.pid",
    "q_g2": "SELECT Orders.order_id, t.tid FROM Customer, Orders MATCH "
            "(p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in "
            "WHERE Customer.person_id = p.pid AND Orders.customer_id = "
            "Customer.id AND p.country = 'cn' AND Orders.shipping.days <= 3",
    "q_g3": "SELECT a.pid, c.pid MATCH (a:Persons)-[e0:Follows]->"
            "(b:Persons)-[e1:Follows]->(c:Persons) ON Follows "
            "WHERE a.country = 'au' AND c.country = 'uk'",
    "q_g4": "SELECT Customer.id, t.tid FROM Product, Orders, Customer MATCH "
            "(p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in "
            "WHERE Product.id = Orders.product_id AND Orders.customer_id = "
            "Customer.id AND Customer.person_id = p.pid AND "
            "Product.title = 'Yogurt'",
    "q_g5": "SELECT p.pid, t.tid MATCH (p:Persons)-[e0:Interested_in]->"
            "(t:Tags) ON Interested_in WHERE e0.weight > 0.9",
    "q_opt_skew": "SELECT Customer.id, t.tid FROM Orders, Customer, Product "
                  "MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON "
                  "Interested_in WHERE Customer.person_id = p.pid AND "
                  "Orders.customer_id = Customer.id AND Product.id = "
                  "Orders.product_id AND Product.title = 'Yogurt' AND "
                  "t.content = 'food'",
    "q_edge_scan": "SELECT e0.weight MATCH (p:Persons)-[e0:Interested_in]->"
                   "(t:Tags) ON Interested_in WHERE e0.weight > 0.5",
}
# the text forms that must lower to the traversal kernel
SQL_ON_DEVICE = ("q_g3", "q_g5")
SWEEP_COMBINATIONS = 192


def phase_declarative(db):
    """The SQL/PGQ texts of the workload on the card engine at sf=10, each
    against its builder query on the same engine, then the plan sweep on
    the card."""
    import torch
    from repro_torch.analysis.verify_sweep import run_sweep
    from repro_torch.core import GredoEngine
    from repro_torch.core.observe import result_fingerprint
    from repro_torch.core.sqlpgq import parse
    from repro_torch.data import m2bench
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    parsed = {name: parse(text) for name, text in SQL_TEXTS.items()}
    parse_ms = (time.perf_counter() - t0) * 1e3
    for name, q in parsed.items():
        if q != getattr(m2bench, name)():
            raise AssertionError(f"{name}: parse() differs from the builder")
    say(f"phase 3b: {len(parsed)} SQL/PGQ texts parsed in {parse_ms:.3f} ms, "
        f"each equal to its m2bench builder")

    eng = GredoEngine(db)

    def run(q):
        before = launch_counts()["batched_hop"]
        t = time.perf_counter()
        out = eng.query(q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        return out, launch_counts()["batched_hop"] - before, ms, \
            list(eng.last_stats.rewrites)

    for q in parsed.values():                   # warm-up
        eng.query(q)
    torch.cuda.synchronize()
    walls, built_walls = {}, {}
    reset_launch_counts()
    for name, q in parsed.items():
        built = getattr(m2bench, name)()
        r_b, hop_b, built_walls[name], _ = run(built)
        r_t, hop_t, walls[name], rewrites = run(q)
        a, b = result_fingerprint(r_t), result_fingerprint(r_b)
        if a != b:
            raise AssertionError(f"{name}: text fingerprint {a} != builder "
                                 f"{b}")
        if eng.explain(q) != eng.explain(built):
            raise AssertionError(f"{name}: explain differs from the builder")
        if hop_t != hop_b:
            raise AssertionError(f"{name}: {hop_t} hop launches from the "
                                 f"text, {hop_b} from the builder")
        on_device = any("device-pallas" in n for n in rewrites)
        if name in SQL_ON_DEVICE and not (on_device and hop_t > 0):
            raise AssertionError(f"{name}: the text form did not launch the "
                                 f"traversal kernel: {rewrites}")
        say(f"{name}: text == builder, {r_t.nrows} rows, fingerprint {a}, "
            f"{hop_t} hop launches")
    launches = launch_counts()
    say("phase 3b launches on the SQL/PGQ path: " + json.dumps(launches))
    say("phase 3b SQL/PGQ wall ms (after warm-up, synchronised): "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    say("phase 3b builder wall ms, same engine, just before each text: "
        + json.dumps({k: round(v, 3) for k, v in built_walls.items()}))

    t0 = time.perf_counter()
    doc = run_sweep(sf=1)
    sweep_s = time.perf_counter() - t0
    if doc["combinations"] != SWEEP_COMBINATIONS or doc["failed"]:
        raise AssertionError(f"plan sweep: {doc['combinations']} "
                             f"combinations, {doc['failed']} failed")
    say(f"phase 3b plan sweep on the card: {doc['combinations']} "
        f"combinations, {doc['failed']} failed, {doc['errors']} errors, "
        f"{doc['warnings']} warnings in {sweep_s:.3f} s")


# ---------------------------------------------------------------------------
# Kernels at the main path's inputs: agreement, times, bounds
# ---------------------------------------------------------------------------


def logreg_kind(x, y, w) -> str:
    """A1's regression, or a_shard_reg's over its four feature columns."""
    return "shard" if x.shape[1] == SHARD_FEATURES else "A1"


def kernel_report(launches: dict, cap) -> list:
    """Rows of the four GCDIA kernels (logreg_grad at its two shapes), at
    the main path's captured inputs."""
    import torch
    from repro_torch.kernels import wrapper_module
    from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
    from repro_torch.kernels.logreg.ref import logreg_grad_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.traversal.ref import (batched_hop_ref,
                                                   fused_hop_ref)

    rows = []
    for key in ("matmul", "cosine_sim", "logreg_grad/A1",
                "logreg_grad/shard", "batched_hop"):
        if key not in cap.calls:
            raise AssertionError(f"{key}: no main-path call was captured")
        _, args, kw = cap.calls[key]
        name = key.split("/")[0]
        n_launch = cap.counts[key] if "/" in key else launches[name]
        kernel = wrapper(name)
        library_ms = None
        if name == "matmul":
            x, y = args
            m, k = x.shape
            n = y.shape[1]
            dt = str(x.dtype).removeprefix("torch.")
            nbytes = (m * k + k * n + m * n) * x.element_size()
            b = bound_ms(nbytes, 2.0 * m * n * k, dt)
            err = assert_close("matmul (main path)", kernel(x, y),
                               matmul_ref(x, y),
                               *TOL["matmul" if dt == "float32"
                                    else "matmul_bf16"])
            plain = lambda: matmul_ref(x, y)                       # noqa: E731
            library_ms = time_ms(lambda: torch.matmul(x, y))[0]
            shape = f"{m}x{k} @ {k}x{n} {dt}"
        elif name == "cosine_sim":
            x, y = args
            m, d = x.shape
            n = y.shape[0]
            b = bound_ms((m + n) * d * 4 + m * n * 4,
                         2.0 * m * n * d + 2.0 * (m + n) * d, "float32")
            err = assert_close("cosine_sim (main path)", kernel(x, y),
                               cosine_sim_ref(x, y), *TOL["cosine_sim"])
            plain = lambda: cosine_sim_ref(x, y)                   # noqa: E731
            shape = f"{m}x{d} vs {n}x{d}"
        elif name == "logreg_grad":
            x, y, w = args
            n, d = x.shape
            b = bound_ms((n * d + n + 2 * d + 1) * 4, 4.0 * n * d, "float32")
            g1, l1 = kernel(x, y, w)
            g2, l2 = logreg_grad_ref(x, y, w)
            err = max(assert_close(f"{key} grad (main path)", g1, g2,
                                   *TOL["logreg_grad"]),
                      assert_close(f"{key} loss (main path)", l1, l2,
                                   *TOL["logreg_grad"]))
            plain = lambda: logreg_grad_ref(x, y, w)               # noqa: E731
            shape = f"{n}x{d}"
        else:
            rp, ci, ei, fr, fm, mem, ep, ca = args
            single = fr.dim() == 1          # the chain runner's fused_hop
            if single:
                kernel = getattr(wrapper_module(name), "fused_hop")
            capacity = kw["capacity"]
            B, C = (1, fr.shape[0]) if single else fr.shape
            frl = fr.reshape(B, C).long()
            fm2 = fm.reshape(B, C)
            deg = torch.where(fm2, rp[frl + 1] - rp[frl], 0)
            n_cand = int(torch.clamp(deg.sum(1), max=capacity).sum())
            n_front = int(fm2.sum())
            # outputs (slots, count, flag) + masks + live frontier entries
            # and their row_ptr pairs + per-candidate gathers
            nbytes = (12 * capacity * B + 5 * B + C * B + 12 * n_front
                      + 11 * n_cand)
            b = (nbytes / PEAK_BYTES_S * 1e3, "bytes")
            ref = fused_hop_ref if single else batched_hop_ref
            got, want = kernel(*args, **kw), ref(*args, **kw)
            err = max(assert_equal(f"batched_hop (main path) out{i}", a, w_)
                      for i, (a, w_) in enumerate(zip(got, want)))
            plain = lambda: ref(*args, **kw)                       # noqa: E731
            shape = (f"{'fused_hop, ' if single else ''}B={B} C={C} "
                     f"capacity={capacity} frontier={n_front} "
                     f"candidates={n_cand}")
        rows.append(report_row(key, name, n_launch, err,
                               lambda: kernel(*args, **kw), plain, b,
                               library_ms, shape))
    return rows


def g1_sf40_pairs(seed=40):
    """G1's (Customer.id, t.tid) pairs at M2Bench SF 40, drawn as the
    generator draws them: 80,000 customers, Poisson(8) interests clipped to
    [1, 40] over 200 tags, of which the 40 food tags qualify (about 128K
    pairs over about 63.9K customers)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.binomial(np.clip(rng.poisson(8, 80_000), 1, 40), 0.2)
    order = rng.permutation(int(lens.sum()))     # joins emit no id order
    return (np.repeat(np.arange(80_000, dtype=np.int64), lens)[order],
            rng.integers(0, 40, len(order)))


def matgen_rows(launches: dict) -> list:
    """The matgen row at A2's shape at SF 40 (``g1_sf40_pairs``, d = 200),
    beside the numpy path it replaced (host matrix, pageable copy), and the
    host's ranking of its ids beside ``np.unique``'s."""
    import numpy as np
    import torch
    from repro_torch.core import analytics
    from repro_torch.core.storage import Table
    from repro_torch.kernels.matgen.matgen import rank
    from repro_torch.kernels.matgen.ref import matgen_ref
    rows, vals = g1_sf40_pairs()
    d, dev = 200, torch.device(DEVICE)
    gen = wrapper("matgen")
    mat, groups = gen(rows, vals, d, device=dev)
    rows_t, vals_t = (torch.as_tensor(a, device=dev) for a in (rows, vals))
    want, want_groups = matgen_ref(rows_t, vals_t, d)
    err = max(assert_equal("matgen matrix", mat, want),
              assert_equal("matgen group ids", groups, want_groups.cpu()))
    table = Table("G1", {"g": rows, "v": vals})
    host, _ = analytics.random_access_matrix(table, "g", "v", d,
                                             device="cpu")
    assert_equal("matgen vs the numpy path", mat.cpu(), host)
    n_rows = mat.shape[0]
    b = bound_ms(4 * n_rows * d + 16 * len(rows), 0.0, "float32")
    row = report_row(
        "matgen", "matgen", launches["matgen"], err,
        lambda: gen(rows, vals, d, device=dev),
        lambda: matgen_ref(rows_t, vals_t, d), b, None,
        f"{len(rows)} pairs -> {n_rows}x{d}")
    row["numpy_path_ms"] = time_ms(lambda: analytics.random_access_matrix(
        table, "g", "v", d, device="cpu")[0].to(dev))[0]
    say(f"matgen: the numpy path it replaced {row['numpy_path_ms']:.4f} ms")
    # the host's ranking of these dense ids, and np.unique's in its place
    row["rank_ms"] = wall_ms(lambda: rank(rows), 50)
    row["np_unique_ms"] = wall_ms(
        lambda: np.unique(rows, return_inverse=True), 50)
    say(f"matgen: ids ranked by counting {row['rank_ms']:.4f} ms, by "
        f"np.unique {row['np_unique_ms']:.4f} ms")
    return [row]


def report_row(row_name, name, launches, err, run, plain, b, library_ms,
               shape) -> dict:
    """Time the kernel call ``run`` and its plain version; one JSON row."""
    from repro_torch.kernels import KERNELS
    ms, host_ms = time_ms(run)
    dev_ms, dev_ops = device_ms(run)
    plain_ms = time_ms(plain)[0]
    say(f"{row_name} at {shape}: kernel {ms:.4f} ms (host issue "
        f"{host_ms:.4f} ms, device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} in "
        f"{'not measured' if dev_ops is None else f'{dev_ops:g}'} device "
        "operations per call), "
        f"plain {plain_ms:.4f} ms, "
        f"bound {b[0]:.4f} ms ({b[1]}), library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
        f"max |err| {err:.3g}, launches {launches}")
    return {"name": row_name, "route": "cuda",
            "source": KERNELS[name].source,
            "replaces": KERNELS[name].replaces,
            "launches": launches,
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "device_ms": dev_ms, "device_ops": dev_ops,
            "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": library_ms, "shape": shape}


# ---------------------------------------------------------------------------
# Phase 4: the LM serving path (Qwen2-1.5B, full width and depth)
# ---------------------------------------------------------------------------


def serve_requests(vocab):
    """The batcher's traffic: 12 requests, prompts of 32-512 tokens and
    8-32 new tokens, from a numpy seed."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(32, 513)))
                    .astype(np.int32),
                    max_new=int(rng.integers(8, 33))) for i in range(12)]


def flash_kind(q, *a, **kw) -> str:
    return "decode" if q.shape[2] == 1 else "prefill"


def flash_work(q, k, *a, **kw) -> int:
    return q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]


class PhaseTimer:
    """Wraps a batcher's prefill and decode callables with synchronised
    host timers (the batcher reads each result on the host right after)."""

    def __init__(self, batcher):
        import torch
        self.s = {"prefill": 0.0, "decode": 0.0}
        self.n = {"prefill": 0, "decode": 0}
        for phase in ("prefill", "decode"):
            fn = getattr(batcher, "_" + phase)

            def timed(*a, _fn=fn, _phase=phase):
                t0 = time.perf_counter()
                out = _fn(*a)
                torch.cuda.synchronize()
                self.s[_phase] += time.perf_counter() - t0
                self.n[_phase] += 1
                return out
            setattr(batcher, "_" + phase, timed)


def run_serve(params, cfg, prompts):
    """(a) the ``launch.serve`` path: prefill + 31 decode steps."""
    import torch
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    toks, timing = serve.generate(params, cfg, prompts, 32)
    return toks, timing, torch.cuda.max_memory_allocated() / 2**30


def run_batcher(params, cfg, timed=False):
    """(b) continuous batching over ``serve_requests()``."""
    import torch
    from repro_torch.serving import ContinuousBatcher
    torch.cuda.reset_peak_memory_stats()
    b = ContinuousBatcher(params, cfg, n_slots=4, max_len=1024)
    timer = PhaseTimer(b) if timed else None
    t0 = time.perf_counter()
    done = b.serve(serve_requests(cfg.vocab))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return done, b.stats, timer, wall, \
        torch.cuda.max_memory_allocated() / 2**30


def logits_trace(params, cfg, prompts, tokens=None, steps=4):
    """Logits of one prefill and ``steps`` greedy decode steps; the decode
    feeds ``tokens`` when given (so two paths see the same inputs)."""
    import torch
    from repro_torch.models import transformer as tf
    B, P = prompts.shape
    cache = tf.init_cache(cfg, B, P + steps, prompts.device)
    lens = torch.zeros(B, dtype=torch.int32, device=prompts.device)
    logits, cache = tf.forward(params, prompts, cfg, cache=cache,
                               cache_lengths=lens)
    out, fed = [logits], []
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    for s in range(steps):
        nxt = nxt if tokens is None else tokens[s]
        fed.append(nxt)
        logits, cache = tf.serve_step(params, cache, nxt, lens + P + s, cfg)
        out.append(logits[:, None])
        nxt = torch.argmax(logits, -1)[:, None]
    return out, fed


def profile_window(label, fn, top=5):
    """One warm call of ``fn`` under ``torch.profiler``: host wall time (to
    a synchronise), the device's busy time (union of its kernel, copy and
    set intervals) and idle share, the number of device operations, and
    the ``top`` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        say(f"profile {label}: wall {wall_us / 1e3:.3f} ms; device time not "
            "measured (the profiler saw no device event)")
        return
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    say(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms (idle share {1 - busy / wall_us:.3f}), "
        f"{len(spans)} device operations; top by device time: "
        + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in tops))


def phase_serve():
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ContinuousBatcher

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    cfg, params = serve.build(SERVE_ARCH, "full", dev)
    torch.cuda.synchronize()
    if cfg.attn_impl != "flash" or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"serve.build gave {cfg.attn_impl} {cfg.dtype}")
    say(f"phase 4: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.param_count() / 1e9:.3f}"
        f" B params, weights in {time.perf_counter() - t0:.2f} s (set-up)")
    prompts = torch.randint(0, cfg.vocab, (8, 512), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))

    cap, launches, stats = Capture(), {}, {}
    cap.wrap("flash_attention", flash_work, kind=flash_kind, clone=True)
    try:
        for run, fn in (("serve", lambda: run_serve(params, cfg, prompts)),
                        ("batcher", lambda: run_batcher(params, cfg))):
            reset_launch_counts()
            out = fn()
            launches[run] = launch_counts()
            if launches[run]["flash_attention"] == 0:
                raise AssertionError(f"{run}: flash kernel never launched")
            say(f"phase 4 launches on the {run} path: "
                + json.dumps(launches[run]))
            stats[run] = out
    finally:
        cap.close()
    toks, _, _ = stats["serve"]
    done = stats["batcher"][0]
    for c in done:
        if len(c.tokens) < 1 or not all(0 <= x < cfg.vocab for x in c.tokens):
            raise AssertionError(f"batcher request {c.rid}: {c.tokens}")
    if toks.shape != (8, 32) or bool(((toks < 0) | (toks >= cfg.vocab)).any()):
        raise AssertionError(f"serve tokens {tuple(toks.shape)} out of range")

    # the same two paths again, timed, without the capture's clones
    toks2, timing, peak_a = run_serve(params, cfg, prompts)
    if not torch.equal(toks, toks2):
        raise AssertionError("serve: a second run gave other tokens")
    say(f"(a) serve batch 8 x prompt 512, 32 new: prefill "
        f"{timing['prefill_s'] * 1e3:.3f} ms, decode "
        f"{timing['decode_tok_s']:.1f} tokens/s ({timing['decode_s'] * 1e3:.3f}"
        f" ms for 31 steps), peak device memory {peak_a:.3f} GiB, flash "
        f"launches {launches['serve']['flash_attention']}")
    done2, bstats, timer, wall, peak_b = run_batcher(params, cfg, timed=True)
    if [c.tokens for c in done2] != [c.tokens for c in done]:
        raise AssertionError("batcher: a second run gave other tokens")
    dec_tokens = sum(bstats["slot_occupancy"])    # one per active slot
    say(f"(b) batcher 4 slots, 12 requests: {bstats['prefills']} prefills "
        f"{timer.s['prefill'] * 1e3 / timer.n['prefill']:.3f} ms mean, "
        f"{bstats['decode_steps']} decode steps "
        f"{dec_tokens / timer.s['decode']:.1f} tokens/s "
        f"({timer.s['decode'] * 1e3 / timer.n['decode']:.3f} ms per step, "
        f"mean occupancy {dec_tokens / bstats['decode_steps']:.2f}), wall "
        f"{wall * 1e3:.3f} ms, peak device memory {peak_b:.3f} GiB, flash "
        f"launches {launches['batcher']['flash_attention']}")
    cache = tf.init_cache(cfg, 8, 544, dev)
    zeros = torch.zeros(8, dtype=torch.int32, device=dev)
    profile_window("(a) prefill 8 x 512", lambda: tf.forward(
        params, prompts, cfg, cache=cache, cache_lengths=zeros))
    profile_window("(a) decode step at length 543", lambda: tf.serve_step(
        params, cache, prompts[:, :1], zeros + 543, cfg))
    del cache

    # flash against the plain dense attention, same weights and tokens
    flash_out, fed = logits_trace(params, cfg, prompts)
    dense_out, _ = logits_trace(
        params, dataclasses.replace(cfg, attn_impl="dense"), prompts, fed)
    worst, agree = 0.0, 0
    for i, (a, d) in enumerate(zip(flash_out, dense_out)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"flash logits step {i}: not finite")
        err = float((a.float() - d.float()).abs().max())
        scale = float(d.float().abs().max())
        worst = max(worst, err / scale)
        if err > LOGIT_SCALE_TOL * scale:
            raise AssertionError(f"logits step {i}: max |flash - dense| "
                                 f"{err} > {LOGIT_SCALE_TOL} * {scale}")
        agree += int((a[:, -1].argmax(-1) == d[:, -1].argmax(-1)).sum())
    say(f"flash vs dense logits (prefill + 4 decode steps, batch 8): max "
        f"|diff| / max |dense| {worst:.4g} (limit {LOGIT_SCALE_TOL}), greedy "
        f"agreement {agree}/{8 * len(flash_out)}")
    del flash_out, dense_out, params
    torch.cuda.empty_cache()

    # fp32, 2 layers: the batcher against each request served alone
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    p32 = tf.cast_params(tf.init_params(
        torch.Generator(dev).manual_seed(0), cfg32), cfg32)
    batched = ContinuousBatcher(p32, cfg32, n_slots=4, max_len=1024).serve(
        serve_requests(cfg.vocab))
    reqs = serve_requests(cfg.vocab)
    if [c.rid for c in batched] != [r.rid for r in reqs]:
        raise AssertionError("fp32 batcher: completions out of order")
    n_tok = 0
    for req, comp in zip(reqs, batched):
        alone = ContinuousBatcher(p32, cfg32, n_slots=1,
                                  max_len=1024).serve([req])[0]
        if comp.tokens != alone.tokens:
            raise AssertionError(f"request {req.rid}: batched {comp.tokens} "
                                 f"!= alone {alone.tokens}")
        n_tok += len(alone.tokens)
    say(f"fp32 2-layer batcher vs each request alone: {len(reqs)}/"
        f"{len(reqs)} requests and {n_tok}/{n_tok} tokens identical")
    del p32
    torch.cuda.empty_cache()
    return cap


# ---------------------------------------------------------------------------
# Phase 5: MoE serving (OLMoE-1B-7B, full width and depth)
# ---------------------------------------------------------------------------


class RouteRecorder:
    """Records every MoE routing of the forwards run inside it, through
    ``transformer._moe_route`` (the helper ``_moe_block`` calls): each
    layer's experts (G, T, k), capacity cut (G, T, k), and the experts the
    run's own router logits chose. With ``replay`` (another recorder's
    routes, call for call) each call routes to the replayed experts
    instead, with gates from its own logits (``transformer._route``)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.routes: list = []
        self._orig = tf._moe_route

        def recording(x, router_w, cfg):
            r = own = self._orig(x, router_w, cfg)
            if self.replay is not None:
                r = tf._route(own.logits, self.replay[len(self.routes)][0],
                              cfg)
            self.routes.append((r.idx, r.keep.reshape(r.idx.shape), own.idx))
            return r
        tf._moe_route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf._moe_route = self._orig

    def dropped(self) -> tuple[int, int]:
        """(assignments dropped at capacity, assignments) over all calls."""
        n = sum(keep.numel() for _, keep, _ in self.routes)
        return n - sum(int(keep.sum()) for _, keep, _ in self.routes), n


def differing(a, b) -> int:
    """Top-k assignments of ``a`` (G, T, k) absent from ``b``'s token."""
    return int((a[..., :, None] != b[..., None, :]).all(-1).sum())


def routing_agreement(a: list, b: list, shape):
    """(B, S) mask of the tokens whose experts and capacity drops agree
    between two runs' routings of one forward, in every layer."""
    agree = None
    for (ia, ka, _), (ib, kb, _) in zip(a, b):
        sa, pa = ia.sort(-1)
        sb, pb = ib.sort(-1)
        same = (sa == sb).all(-1) & (ka.gather(-1, pa) ==
                                     kb.gather(-1, pb)).all(-1)
        agree = same if agree is None else agree & same
    return agree.reshape(shape)


def moe_flash_vs_dense(params, cfg, prompts, tol, free_run=False) -> str:
    """Flash against the plain dense attention on one MoE model's weights
    and fed tokens (a prefill and 4 decode steps), the dense run pinned to
    the flash run's experts, so the two differ by attention and rounding
    alone: max |flash - dense| <= tol * max |dense| at every step. With
    ``free_run``, a dense run that routes itself first: the top-k
    assignments that differ, the tokens routed alike in every layer, and
    the logit gap over all tokens and over those."""
    import dataclasses
    import torch
    dense = dataclasses.replace(cfg, attn_impl="dense")
    L = cfg.n_layers
    with RouteRecorder() as rf:
        flash_out, fed = logits_trace(params, cfg, prompts)
    n_assign = sum(idx.numel() for idx, _, _ in rf.routes)
    out = []
    if free_run:
        with RouteRecorder() as rd:
            free_out, _ = logits_trace(params, dense, prompts, fed)
        worst_all = worst_alike = 0.0
        n_alike = n_tok = 0
        for i, (a, d) in enumerate(zip(flash_out, free_out)):
            alike = routing_agreement(rf.routes[i * L:(i + 1) * L],
                                      rd.routes[i * L:(i + 1) * L],
                                      a.shape[:2])
            n_alike, n_tok = n_alike + int(alike.sum()), n_tok + alike.numel()
            gap = (a.float() - d.float()).abs().amax(-1)
            scale = float(d.float().abs().max())
            worst_all = max(worst_all, float(gap.max()) / scale)
            if bool(alike.any()):
                worst_alike = max(worst_alike, float(gap[alike].max()) / scale)
        n_diff = sum(differing(a[0], b[0])
                     for a, b in zip(rf.routes, rd.routes))
        del free_out
        out.append(f"free-running dense: {n_diff}/{n_assign} top-k "
                   f"assignments differ, {n_alike}/{n_tok} tokens routed "
                   f"alike in every layer, max |diff| / max |dense| "
                   f"{worst_all:.4g} over all tokens, {worst_alike:.4g} over "
                   "those")
    with RouteRecorder(replay=rf.routes) as rp:
        dense_out, _ = logits_trace(params, dense, prompts, fed)
    n_own = sum(differing(own, idx) for idx, _, own in rp.routes)
    worst = 0.0
    for i, (a, d) in enumerate(zip(flash_out, dense_out)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"MoE flash logits step {i}: not finite")
        err = float((a.float() - d.float()).abs().max())
        scale = float(d.float().abs().max())
        worst = max(worst, err / scale)
        if err > tol * scale:
            raise AssertionError(
                f"MoE logits step {i}, {cfg.dtype}: max |flash - dense| "
                f"{err} > {tol} * {scale} with the dense run pinned to the "
                f"flash run's experts ({'; '.join(out)})")
    out.append(f"dense pinned to the flash run's experts ({n_own}/"
               f"{n_assign} differ from its own router's top-k): max |diff|"
               f" / max |dense| {worst:.4g} (limit {tol})")
    return "; ".join(out)


def decode_step_bytes(cfg, batch: int, length: int) -> int:
    """Bytes one decode step must read: every weight once (the (E, C)
    buffers run every expert's GEMM, however few tokens reach it; bf16,
    the router and norms fp32), the embedding rows of the new tokens, and
    the live KV cache."""
    d, h, kv, dh, f, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.n_experts)
    n_mats = 3 if cfg.mlp == "swiglu" else 2
    attn = (2 * d * h * dh + 2 * d * kv * dh) * 2
    mlp = E * n_mats * d * f * 2 + d * E * 4
    layers = cfg.n_layers * (attn + mlp + 2 * d * 4)
    head = 0 if cfg.tie_embeddings else d * cfg.vocab * 2
    kv_read = cfg.n_layers * 2 * batch * kv * length * dh * 2
    return layers + head + batch * d * 2 + d * 4 + kv_read


def phase_moe_serve():
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = serve.build(MOE_ARCH, "full", dev)
    torch.cuda.synchronize()
    want = dict(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
                head_dim=128, n_experts=64, top_k=8, d_ff=1024, vocab=50304,
                attn_impl="flash", dtype=torch.bfloat16)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"serve.build({MOE_ARCH!r}) gave {got}")
    if params["layers"]["router"].dtype != torch.float32:
        raise AssertionError("the router was cast off fp32")
    say(f"phase 5: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} d_ff {cfg.d_ff}, "
        f"{cfg.param_count() / 1e9:.3f} B params, weights in "
        f"{time.perf_counter() - t0:.2f} s (set-up), "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
    prompts = torch.randint(0, cfg.vocab, (8, 512), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))

    cap, launches, stats = Capture(), {}, {}
    cap.wrap("flash_attention", flash_work, kind=flash_kind, clone=True)
    try:
        for run, fn in (("serve", lambda: run_serve(params, cfg, prompts)),
                        ("batcher", lambda: run_batcher(params, cfg))):
            reset_launch_counts()
            out = fn()
            launches[run] = launch_counts()
            forwards = 32 if run == "serve" else \
                out[1]["prefills"] + out[1]["decode_steps"]
            if launches[run]["flash_attention"] != cfg.n_layers * forwards:
                raise AssertionError(
                    f"{run}: {launches[run]['flash_attention']} flash "
                    f"launches for {forwards} forwards of {cfg.n_layers} "
                    "layers")
            say(f"phase 5 launches on the {run} path ({forwards} forwards): "
                + json.dumps(launches[run]))
            stats[run] = out
    finally:
        cap.close()
    toks = stats["serve"][0]
    done = stats["batcher"][0]
    if toks.shape != (8, 32) or bool(((toks < 0) | (toks >= cfg.vocab)).any()):
        raise AssertionError(f"serve tokens {tuple(toks.shape)} out of range")
    for c in done:
        if len(c.tokens) < 1 or not all(0 <= x < cfg.vocab for x in c.tokens):
            raise AssertionError(f"batcher request {c.rid}: {c.tokens}")

    toks2, timing, peak_a = run_serve(params, cfg, prompts)
    if not torch.equal(toks, toks2):
        raise AssertionError("MoE serve: a second run gave other tokens")
    step_ms = timing["decode_s"] * 1e3 / 31
    bound = decode_step_bytes(cfg, 8, 543) / PEAK_BYTES_S * 1e3
    say(f"(a) serve batch 8 x prompt 512, 32 new: prefill "
        f"{timing['prefill_s'] * 1e3:.3f} ms, decode "
        f"{timing['decode_tok_s']:.1f} tokens/s ({step_ms:.3f} ms per step "
        f"against a bound of {bound:.3f} ms: every expert's weights read "
        f"once), peak device memory {peak_a:.3f} GiB, flash launches "
        f"{launches['serve']['flash_attention']}")
    done2, bstats, timer, wall, peak_b = run_batcher(params, cfg, timed=True)
    if [c.tokens for c in done2] != [c.tokens for c in done]:
        raise AssertionError("MoE batcher: a second run gave other tokens")
    dec_tokens = sum(bstats["slot_occupancy"])
    say(f"(b) batcher 4 slots, 12 requests: {bstats['prefills']} prefills "
        f"{timer.s['prefill'] * 1e3 / timer.n['prefill']:.3f} ms mean, "
        f"{bstats['decode_steps']} decode steps "
        f"{dec_tokens / timer.s['decode']:.1f} tokens/s "
        f"({timer.s['decode'] * 1e3 / timer.n['decode']:.3f} ms per step, "
        f"mean occupancy {dec_tokens / bstats['decode_steps']:.2f}), wall "
        f"{wall * 1e3:.3f} ms, peak device memory {peak_b:.3f} GiB, flash "
        f"launches {launches['batcher']['flash_attention']}")

    cache = tf.init_cache(cfg, 8, 544, dev)
    zeros = torch.zeros(8, dtype=torch.int32, device=dev)
    for label, fn in (
            ("prefill 8 x 512", lambda: tf.forward(
                params, prompts, cfg, cache=cache, cache_lengths=zeros)),
            ("decode step at length 543", lambda: tf.serve_step(
                params, cache, prompts[:, :1], zeros + 543, cfg))):
        with RouteRecorder() as rec:
            fn()
        n_drop, n = rec.dropped()
        say(f"(a) {label}: {n_drop}/{n} top-k assignments dropped at "
            f"capacity ({n_drop / n:.4f}) over {len(rec.routes)} MoE layers")
        profile_window(f"(a) {label}", fn)
    del cache

    # flash against the plain dense attention, same weights and tokens
    line = moe_flash_vs_dense(params, cfg, prompts, LOGIT_SCALE_TOL, True)
    say(f"MoE flash vs dense logits, bf16 (prefill + 4 decode steps, batch "
        f"8): {line}")
    del params
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tf.init_params(torch.Generator(dev).manual_seed(0), c32)
    say("MoE flash vs dense logits, the same weights in fp32: "
        f"{moe_flash_vs_dense(p32, c32, prompts, MOE_FP32_TOL)}")
    del p32
    torch.cuda.empty_cache()
    return cap


# ---------------------------------------------------------------------------
# Phase 6: the LM training path (Granite-MoE-1B-A400M)
# ---------------------------------------------------------------------------


def train_run(cfg, params, stream, dev, ckpt_dir, total_steps, **kw):
    """A ``Trainer`` of ``loss_fn`` over ``stream`` on ``dev``; returns it
    after ``run_with_restarts``, with the synchronised wall time of each
    step (from one batch request to the next)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train.loop import Trainer, TrainerConfig
    stamps = []

    def data_at(step):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())
        return {k: torch.as_tensor(v, device=dev)
                for k, v in stream.batch_at(step).items()}
    injector = kw.pop("injector", None)
    t = Trainer(lambda p, b: tf.loss_fn(p, b, cfg), params, data_at,
                TrainerConfig(total_steps=total_steps, ckpt_dir=ckpt_dir,
                              log_every=1, keep=1, **kw),
                failure_injector=injector)
    t.run_with_restarts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps.append(time.perf_counter())
    t.step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    return t


def param_gap(a, b, before) -> tuple[float, float]:
    """(max |a - b| over every weight, the same over the largest update
    |b - before|): two runs' weights after the same steps."""
    from repro_torch.train.optimizer import tree_leaves
    diff = max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    step = max(float((y.cpu() - z.cpu()).abs().max())
               for y, z in zip(tree_leaves(b), tree_leaves(before)))
    return diff, diff / step


def loss_grads(cfg, params, batch) -> list:
    """``loss_fn``'s gradients at ``params`` (``torch.autograd``), in
    ``tree_leaves`` order."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_leaves, tree_map
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = tf.loss_fn(tracked, batch, cfg)
    return list(torch.autograd.grad(loss, tree_leaves(tracked)))


def one_step_gaps(cfg, p0, stream, dev, card, host) -> dict:
    """The gaps between one optimizer step on ``dev`` (weights ``card``)
    and on the CPU (``host``) from the same weights ``p0`` (CPU tensors)
    and the stream's first batch: each gradient's
    max |card - cpu| over its largest |cpu|, and the updated weights'
    max |card - cpu|, over all and over those whose clipped gradient is at
    least ``CONDITIONED`` x eps (``TRAIN_TOL``)."""
    import torch
    from repro_torch.train.optimizer import (AdamWConfig, global_norm,
                                             tree_leaves, tree_map)
    opt = AdamWConfig()
    batch = {k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()}
    gc = loss_grads(cfg, tree_map(lambda x: x.to(dev), p0),
                    {k: v.to(dev) for k, v in batch.items()})
    gh = loss_grads(cfg, p0, batch)
    grads = max(float((x.cpu() - y).abs().max()
                      / y.abs().max().clamp_min(1e-30))
                for x, y in zip(gc, gh))
    clip = min(1.0, opt.grad_clip / (float(global_norm(gh)) + 1e-9))
    out = {"grads": grads, "weights": 0.0, "all": 0.0, "n_loose": 0}
    for x, y, g in zip(tree_leaves(card), tree_leaves(host), gh):
        gap = (x.cpu() - y).abs()
        held = g.abs() * clip >= CONDITIONED * opt.eps
        out["all"] = max(out["all"], float(gap.max()))
        if bool(held.any()):
            out["weights"] = max(out["weights"], float(gap[held].max()))
        out["n_loose"] += int((~held).sum())
    return out


def phase_train():
    import dataclasses
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.data.lm import TokenStream
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_leaves, tree_map

    dev = torch.device(DEVICE)
    cpu = torch.device("cpu")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(dir=work))
    try:
        # (i) full widths and depth: bf16 activations, fp32 masters
        cfg = configs.get(TRAIN_ARCH).config()
        want = dict(n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
                    n_experts=32, top_k=8, d_ff=512, vocab=49155,
                    tie_embeddings=True, attn_impl="chunked",
                    dtype=torch.bfloat16)
        got = {k: getattr(cfg, k) for k in want}
        if got != want:
            raise AssertionError(f"{TRAIN_ARCH}: {got}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(torch.Generator(dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        say(f"phase 6 (i): {cfg.name} {cfg.n_layers} layers d_model "
            f"{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads} heads, "
            f"{cfg.n_experts} experts top-{cfg.top_k} d_ff {cfg.d_ff}, "
            f"{cfg.param_count() / 1e9:.3f} B fp32 params in "
            f"{time.perf_counter() - t0:.2f} s (set-up)")
        stream = TokenStream(vocab=cfg.vocab, batch=4, seq=512)
        t = train_run(cfg, params, stream, dev, str(ckpt / "full"), 5,
                      ckpt_every=0)
        del params
        losses = [m["loss"] for m in t.metrics]
        if len(losses) != 5 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"Granite-MoE losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"(i) Trainer, TokenStream batch 4 x seq 512, 5 steps: losses "
            + ", ".join(f"{x:.6f}" for x in losses)
            + "; ms per step (synchronised) "
            + ", ".join(f"{s * 1e3:.3f}" for s in t.step_s)
            + f"; peak device memory {peak:.3f} GiB")
        del t
        torch.cuda.empty_cache()

        # (ii) Granite's widths at 2 layers, fp32: one step, card vs CPU
        small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
        p0 = tf.init_params(torch.Generator().manual_seed(0), small)
        stream = TokenStream(vocab=small.vocab, batch=2, seq=128)
        runs = []
        for d in (dev, cpu):
            t0 = time.perf_counter()
            runs.append(train_run(
                small, tree_map(lambda x, d=d: x.to(d), p0), stream, d,
                str(ckpt / f"one_{d.type}"), 1, ckpt_every=0))
            say(f"(ii) one step on the {d.type}: "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        a, b = runs
        la, lb = a.metrics[0]["loss"], b.metrics[0]["loss"]
        gaps = one_step_gaps(small, p0, stream, dev, a.params, b.params)
        n = sum(x.numel() for x in tree_leaves(p0))
        scale = max(float(x.abs().max()) for x in tree_leaves(b.params))
        say(f"(ii) 2 layers fp32, batch 2 x 128: loss card {la:.7f} cpu "
            f"{lb:.7f} (gap {abs(la - lb) / abs(lb):.3g} relative, limit "
            f"{TRAIN_TOL['loss']}); gradients max |card - cpu| "
            f"{gaps['grads']:.3g} of their tensor's largest (limit "
            f"{TRAIN_TOL['grads']}); updated weights max |card - cpu| "
            f"{gaps['weights']:.3g} where the clipped gradient is >= "
            f"{CONDITIONED:g} x eps (limit {TRAIN_TOL['weights']}), "
            f"{gaps['all']:.3g} over all {n} ({gaps['all'] / scale:.3g} of "
            f"the weights' scale; {gaps['n_loose']} weights have a smaller "
            "gradient)")
        if abs(la - lb) > TRAIN_TOL["loss"] * abs(lb) \
                or gaps["grads"] > TRAIN_TOL["grads"] \
                or gaps["weights"] > TRAIN_TOL["weights"]:
            raise AssertionError("(ii) card and CPU steps disagree")
        del runs, a, b

        # (iii) failure at step 3, checkpoints every 2 steps, restarted
        p_dev = tree_map(lambda x: x.to(dev), p0)
        plain = train_run(small, p_dev, stream, dev, str(ckpt / "plain"), 5,
                          ckpt_every=0)
        t0 = time.perf_counter()
        failed = train_run(small, p_dev, stream, dev, str(ckpt / "restart"),
                           5, ckpt_every=2,
                           injector=FailureInjector(fail_at=(3,)))
        steps = [m["step"] for m in failed.metrics]
        if steps != [0, 1, 2, 2, 3, 4] or failed.ckpt.latest_step() != 3:
            raise AssertionError(f"(iii) steps run {steps}, latest "
                                 f"checkpoint {failed.ckpt.latest_step()}")
        diff, rel = param_gap(failed.params, plain.params, p_dev)
        say(f"(iii) FailureInjector(fail_at=(3,)), ckpt_every 2, "
            f"run_with_restarts: steps run {steps} in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms (checkpoint writes "
            f"included); final weights max |restarted - uninterrupted| "
            f"{diff:.3g} ({rel:.3g} of the largest update; limit "
            f"{TRAIN_TOL['weights']})")
        if diff > TRAIN_TOL["weights"]:
            raise AssertionError("(iii) the restarted run ended elsewhere")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 7-8: the recommenders and the GNNs at their published widths
# ---------------------------------------------------------------------------


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def reset_peak() -> None:
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def moved(x, dev):
    """Tensors, dicts, lists and graph batches (``GraphBatch.to``) on
    ``dev``; anything else as it is."""
    import torch
    from repro_torch.models.gnn.common import GraphBatch
    if isinstance(x, GraphBatch) or torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: moved(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(moved(v, dev) for v in x)
    return x


def as_f64(x):
    """A tree's floating tensors in float64, integer ones as they are; a
    graph batch's features and positions in float64 (its masks fp32)."""
    import dataclasses
    import torch
    from repro_torch.models.gnn.common import GraphBatch
    if isinstance(x, GraphBatch):
        return dataclasses.replace(x, **{
            f: getattr(x, f).double() for f in ("x", "pos", "edge_attr")
            if getattr(x, f) is not None})
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: as_f64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(as_f64(v) for v in x)
    return x


def grad_gap(a, b) -> float:
    """max over the tensors of max |a - b| over the largest |b| of the
    tensor; a linear layer's bias (``b`` beside ``w``) over the largest of
    its own and its weight's: a bias whose gradient is zero in exact
    arithmetic (an attention MLP's last bias under the edge softmax, which
    is shift-invariant) has rounding alone, on either device."""
    import torch

    def walk(x, y):
        if torch.is_tensor(y):
            yield float((x.cpu() - y).abs().max()), float(y.abs().max())
        elif isinstance(y, dict):
            for k in sorted(y):
                for gap, scale in walk(x[k], y[k]):
                    if k == "b" and "w" in y:
                        scale = max(scale, float(y["w"].abs().max()))
                    yield gap, scale
        elif y is not None:
            for u, v in zip(x, y):
                yield from walk(u, v)
    return max((gap / max(scale, 1e-30) for gap, scale in walk(a, b)),
               default=0.0)


def out_gap(a, b) -> float:
    """max |a - b| over max |b| (b on the CPU)."""
    return float((a.detach().cpu() - b.detach()).abs().max()) / max(
        float(b.detach().abs().max()), 1e-30)


def card_vs_cpu(loss, p0, args, dev, step=True) -> dict:
    """``loss(params, *args)`` and its gradients (``train.loop.
    value_and_grad``) on ``dev`` and on the CPU from the same weights
    ``p0`` and inputs ``args`` (CPU); with ``step``, one AdamW step on
    each: the loss gap (relative), the gradients' gap (``grad_gap``) and
    the updated weights' max |card - cpu| over all and over those whose
    clipped gradient is at least ``CONDITIONED`` x eps (``TRAIN_TOL``)."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update, global_norm,
                                             tree_leaves)
    pd = moved(p0, dev)
    lc, gc = value_and_grad(loss, pd, *moved(args, dev))
    lh, gh = value_and_grad(loss, p0, *args)
    out = {"loss_card": float(lc), "loss_cpu": float(lh),
           "loss": abs(float(lc) - float(lh)) / max(abs(float(lh)), 1e-30),
           "grads": grad_gap(gc, gh), "weights": 0.0, "all": 0.0,
           "n_loose": 0}
    if not step:
        return out
    opt = AdamWConfig()
    pc, _ = adamw_update(gc, adamw_init(pd), pd, opt)
    ph, _ = adamw_update(gh, adamw_init(p0), p0, opt)
    clip = min(1.0, opt.grad_clip / (float(global_norm(gh)) + 1e-9))
    for x, y, g in zip(tree_leaves(pc), tree_leaves(ph), tree_leaves(gh)):
        gap = (x.cpu() - y).abs()
        held = g.abs() * clip >= CONDITIONED * opt.eps
        out["all"] = max(out["all"], float(gap.max()))
        if bool(held.any()):
            out["weights"] = max(out["weights"], float(gap[held].max()))
        out["n_loose"] += int((~held).sum())
    return out


def check_card_vs_cpu(label, loss, p0, args, dev, tol=TRAIN_TOL,
                      step=True, held32=True) -> None:
    """``card_vs_cpu`` in fp32 and in float64 (``as_f64`` of the weights
    and inputs), both printed. Held: the loss in fp32 (in float64 where
    ``held32`` is False: a model ill-conditioned in fp32), the gradients
    and, with ``step``, the updated weights in float64. In fp32 a
    pre-activation within rounding of a ReLU's kink takes the other
    branch on one device, and that sample's whole term of a gradient sum
    differs (at Wide & Deep's batch 4096, 7.58e-03 of a tensor's largest);
    float64 leaves no kink that close, and shows whether the two devices
    compute the same function."""
    runs = {"fp32": card_vs_cpu(loss, p0, args, dev, step),
            "float64": card_vs_cpu(loss, as_f64(p0), as_f64(args), dev,
                                   step)}
    for kind, g in runs.items():
        say(f"{label}, {kind}: loss card {g['loss_card']:.7f} cpu "
            f"{g['loss_cpu']:.7f} (gap {g['loss']:.3g} relative); gradients "
            f"{g['grads']:.3g} of their tensor's largest"
            + (f"; updated weights {g['weights']:.3g} where the clipped "
               f"gradient is >= {CONDITIONED:g} x eps, {g['all']:.3g} over "
               f"all ({g['n_loose']} weights have a smaller gradient)"
               if step else ""))
    held = runs["fp32" if held32 else "float64"]
    g64 = runs["float64"]
    say(f"{label}: held loss ({'fp32' if held32 else 'float64'}) "
        f"{held['loss']:.3g} (limit {tol['loss']}), gradients (float64) "
        f"{g64['grads']:.3g} (limit {tol['grads']})"
        + (f", weights (float64) {g64['weights']:.3g} (limit "
           f"{tol['weights']})" if step else ""))
    if held["loss"] > tol["loss"] or g64["grads"] > tol["grads"] \
            or (step and g64["weights"] > tol["weights"]):
        raise AssertionError(f"{label}: card and CPU disagree")


def adamw_steps(loss, params, batches, profile) -> tuple[list, list, object]:
    """AdamW steps of ``loss`` over ``batches`` (callables giving each
    step's arguments, timed apart): the losses, the synchronised ms per
    step, and the final weights. Then ``profile_window`` of one more step
    on the last arguments, its result dropped, printed as ``profile``."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update)
    opt_cfg, state = AdamWConfig(), adamw_init(params)
    losses, ms = [], []
    for args in batches:
        args = args()
        sync()
        t0 = time.perf_counter()
        lval, grads = value_and_grad(loss, params, *args)
        params, state = adamw_update(grads, state, params, opt_cfg)
        del grads
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lval))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    profile_window(profile, lambda: adamw_update(
        value_and_grad(loss, params, *args)[1], state, params, opt_cfg))
    return losses, ms, params


def timed_ms(fn, reps) -> float:
    """Mean synchronised wall ms of ``fn()`` over ``reps`` calls after
    one warm-up call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def hash_cross_np(sparse, wide_hash: int):
    """The Wide & Deep cross hash in numpy uint32 (wrapping) arithmetic:
    ``(a * 2654435761) ^ (b + 0x9E3779B9 + (a << 6) + (a >> 2))``
    modulo ``wide_hash``, as int32."""
    import numpy as np
    a = sparse[:, :-1].astype(np.uint32)
    b = sparse[:, 1:].astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (a * np.uint32(2654435761)) ^ (
            b + np.uint32(0x9E3779B9) + (a << np.uint32(6))
            + (a >> np.uint32(2)))
    return (h % np.uint32(wide_hash)).astype(np.int32)


def phase_recsys():
    """Phase 7: Wide & Deep at its published widths, its four SHAPES."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import launch_counts
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    cpu = torch.device("cpu")
    say(f"phase 7 launch counts before: {launch_counts()}")
    mod = configs.get("wide_deep")
    cfg, shapes = mod.config(), mod.SHAPES
    loss = lambda p, b: recsys.loss_fn(p, b, cfg)  # noqa: E731
    reset_peak()
    t0 = time.perf_counter()
    params = recsys.init_params(torch.Generator(dev).manual_seed(0), cfg)
    sync()
    n = sum(t.numel() for t in tree_leaves(params))
    say(f"phase 7: {cfg.name} {cfg.n_sparse} fields x "
        f"{cfg.vocab_per_field} rows x {cfg.embed_dim}, wide hash "
        f"{cfg.wide_hash}, MLP {cfg.n_sparse * cfg.embed_dim + cfg.n_dense}-"
        + "-".join(map(str, cfg.mlp)) + f", tower {cfg.tower_dim}: {n} fp32 "
        f"parameters ({n * 4 / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    if n != WIDE_DEEP_PARAMS:
        raise AssertionError(f"Wide & Deep has {n} parameters")
    t0 = time.perf_counter()
    host = moved(params, cpu)
    say(f"(copy of the weights to the host for the checks: "
        f"{time.perf_counter() - t0:.2f} s)")

    # serve_p99: batch 512, scores against the CPU
    B = shapes["serve_p99"]["batch"]
    b = recsys.random_batch(cfg, B, seed=1, device=dev)
    reset_peak()
    with torch.no_grad():
        run = lambda: recsys.serve_step(params, b["dense"], b["sparse"],  # noqa
                                        cfg)
        ms = timed_ms(run, 20)
        got = run().cpu()
        want = recsys.serve_step(host, b["dense"].cpu(), b["sparse"].cpu(),
                                 cfg)
    err = assert_close("serve_p99 scores (card vs cpu)", got, want,
                       *RECSYS_SERVE_TOL)
    say(f"(serve_p99) serve_step batch {B}: {ms:.3f} ms per call; max "
        f"|card - cpu| {err:.3g} (rtol {RECSYS_SERVE_TOL[0]}, atol "
        f"{RECSYS_SERVE_TOL[1]}); peak {peak_gib():.3f} GiB")

    # serve_bulk: batch 262144, rows/s; the cross hash bit for bit
    B = shapes["serve_bulk"]["batch"]
    b = recsys.random_batch(cfg, B, seed=2, device=dev)
    reset_peak()
    with torch.no_grad():
        run = lambda: recsys.serve_step(params, b["dense"],  # noqa: E731
                                        b["sparse"], cfg)
        ms = timed_ms(run, 5)
        say(f"(serve_bulk) serve_step batch {B}: {ms:.3f} ms per call, "
            f"{B / ms * 1e3:.1f} rows/s; peak {peak_gib():.3f} GiB")
        profile_window(f"(serve_bulk) serve_step batch {B}", run)
    sparse = b["sparse"].cpu().numpy()
    edge = np.array([[0, 2**31 - 1, -1, -2**31, 123456789, 2**31 - 2]
                     * (cfg.n_sparse // 6 + 1)], np.int64)[:, :cfg.n_sparse]
    sparse = np.concatenate([sparse, edge.astype(np.int32)])
    ids = recsys._hash_cross(torch.as_tensor(sparse, device=dev),
                             cfg.wide_hash).cpu().numpy()
    want = hash_cross_np(sparse, cfg.wide_hash)
    if ids.dtype != want.dtype or not np.array_equal(ids, want):
        raise AssertionError("_hash_cross on the card differs from numpy "
                             "uint32")
    say(f"(serve_bulk) _hash_cross of {sparse.shape[0]} x "
        f"{sparse.shape[1] - 1} crosses (the batch and ids near 2**31 and "
        "negative) equal bit for bit to numpy uint32")
    del b

    # retrieval_cand: 1 query against 1M candidates, top-100
    spec = shapes["retrieval_cand"]
    b = recsys.random_batch(cfg, spec["batch"], seed=3, device=dev)
    cands = torch.randn((spec["n_candidates"], cfg.tower_dim),
                        generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    reset_peak()
    k = 100
    with torch.no_grad():
        run = lambda: recsys.retrieval_step(  # noqa: E731
            params, b["dense"], b["sparse"], cands, cfg, top_k=k)
        ms = timed_ms(run, 10)
        vals, idx = run()
        hv, hi = recsys.retrieval_step(host, b["dense"].cpu(),
                                       b["sparse"].cpu(), cands.cpu(), cfg,
                                       top_k=spec["n_candidates"])
    kth = float(hv[0, k - 1])
    score = dict(zip(hi[0].tolist(), hv[0].tolist()))
    differ = set(idx[0].tolist()) ^ set(hi[0, :k].tolist())
    far = [i for i in differ if abs(score[i] - kth) > 1e-6]
    say(f"(retrieval_cand) retrieval_step 1 query x {spec['n_candidates']} "
        f"candidates x {cfg.tower_dim}, top-{k}: {ms:.3f} ms per call; top-"
        f"{k} ids card vs cpu: {len(differ)} differ, {len(far)} of them "
        f"farther than 1e-6 from the {k}th score {kth:.7f}; max |score "
        f"card - cpu| {float((vals.cpu() - hv[:, :k]).abs().max()):.3g}; "
        f"peak {peak_gib():.3f} GiB")
    if far:
        raise AssertionError(f"retrieval top-{k} differs: {sorted(far)}")
    del b, cands, host

    # train_batch: batch 65536, 5 AdamW steps from the same weights, drawn
    # anew so that only the steps hold a copy
    del params
    B = shapes["train_batch"]["batch"]
    reset_peak()
    batches = [lambda s=s: (recsys.random_batch(cfg, B, seed=10 + s,
                                                device=dev),)
               for s in range(5)]
    losses, ms, params = adamw_steps(
        loss, recsys.init_params(torch.Generator(dev).manual_seed(0), cfg),
        batches, f"(train_batch) one AdamW step at batch {B}")
    say(f"(train_batch) batch {B}, 5 AdamW steps (dense table gradients): "
        "losses " + ", ".join(f"{x:.6f}" for x in losses)
        + "; ms per step " + ", ".join(f"{x:.3f}" for x in ms)
        + f"; peak {peak_gib():.3f} GiB")
    del params
    reset_peak()

    # one step at full widths, vocab and hash cut, card vs CPU
    cut = dataclasses.replace(cfg, vocab_per_field=min(cfg.vocab_per_field,
                                                       RECSYS_CUT),
                              wide_hash=min(cfg.wide_hash, RECSYS_CUT))
    p0 = recsys.init_params(torch.Generator().manual_seed(0), cut)
    batch = recsys.random_batch(cut, RECSYS_CUT_BATCH, seed=4, device=cpu)
    t0 = time.perf_counter()
    check_card_vs_cpu(
        f"(train check) one AdamW step, vocab_per_field and wide_hash cut "
        f"to {cut.vocab_per_field} (from {cfg.vocab_per_field}), batch "
        f"{RECSYS_CUT_BATCH}", lambda p, b: recsys.loss_fn(p, b, cut), p0,
        (batch,), dev)
    say(f"(train check) {time.perf_counter() - t0:.2f} s")
    say(f"phase 7 launch counts after: {launch_counts()}; "
        f"{time.perf_counter() - t_phase:.1f} s")


def reddit_sampler():
    """``minibatch_lg``'s graph at Reddit's size, on the host, and its
    ``NeighborSampler``; prints the seconds of each."""
    import numpy as np
    from repro_torch.configs.gnn_shapes import GNN_SHAPES
    from repro_torch.data import graphs
    spec = GNN_SHAPES["minibatch_lg"]
    n, e = spec["global_nodes"], spec["global_edges"]
    t0 = time.perf_counter()
    g, labels = graphs.random_feature_graph(n, e, spec["d_feat"],
                                            spec["n_classes"], seed=0,
                                            device="cpu")
    t1 = time.perf_counter()
    sampler = graphs.NeighborSampler(n, g.src.numpy(), g.dst.numpy(),
                                     g.x.numpy(), labels.numpy(),
                                     fanouts=spec["fanout"], seed=0)
    say(f"phase 8 (a) minibatch_lg: synthetic graph of {n} nodes, {e} edges, "
        f"{spec['d_feat']} features, {spec['n_classes']} classes (numpy seed "
        f"0) in {t1 - t0:.2f} s; CSR in {time.perf_counter() - t1:.2f} s "
        "(set-up)")
    seeds = np.random.default_rng(1)
    return sampler, spec, [seeds.choice(n, spec["batch_nodes"], replace=False)
                           for _ in range(5)]


def phase_gnn_minibatch(dev):
    """Phase 8 (a): GatedGCN and PNA, 5 AdamW steps each on sampled
    Reddit-size batches; the first batch card vs CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.models.gnn import gatedgcn, pna
    sampler, spec, seeds = reddit_sampler()
    cpu = torch.device("cpu")
    for name, mod in (("gatedgcn", gatedgcn), ("pna", pna)):
        cfg = configs.get(name).config(d_in=spec["d_feat"],
                                       n_classes=spec["n_classes"])
        reset_peak()
        p0 = mod.init_params(torch.Generator(dev).manual_seed(0), cfg)
        sample_ms, first = [], []

        def batch_at(s):
            sync()
            t0 = time.perf_counter()
            g, labels = sampler.sample(seeds[s], device=dev)
            sync()
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            if not first:
                first.append((g, labels))
            return g, labels, cfg
        losses, ms, _ = adamw_steps(mod.loss_fn, p0,
                                    [lambda s=s: batch_at(s)
                                     for s in range(5)],
                                    f"(a) {cfg.name} one AdamW step")
        g, labels = first[0]
        say(f"(a) {cfg.name} {cfg.n_layers} layers d {cfg.d_hidden} on "
            f"{g.n_nodes} nodes / {g.n_edges} edges ({int(g.edge_mask.sum())} "
            f"valid, {int((labels >= 0).sum())} labelled), 5 AdamW steps: "
            "losses " + ", ".join(f"{x:.6f}" for x in losses)
            + "; sampler ms (host sampling + copy to the card) "
            + ", ".join(f"{x:.3f}" for x in sample_ms) + "; step ms "
            + ", ".join(f"{x:.3f}" for x in ms)
            + f"; peak {peak_gib():.3f} GiB")
        ph, gh = moved(p0, cpu), g.to(cpu)
        # PNA's std aggregator is ill-conditioned in fp32 where a node's
        # messages are all equal: its logits and loss are held in float64
        held32 = name != "pna"
        for cast, kind in ((lambda x: x, "fp32"), (as_f64, "float64")):
            with torch.no_grad():
                lg = out_gap(mod.forward(cast(p0), cast(g), cfg),
                             mod.forward(cast(ph), cast(gh), cfg))
            held = (kind == "fp32") == held32
            say(f"(a) {cfg.name} first batch, {kind}: logits max |card - "
                f"cpu| {lg:.3g} of scale"
                + (f" (limit {GNN_TOL['out']})" if held else " (printed)"))
            if held and lg > GNN_TOL["out"]:
                raise AssertionError(f"(a) {name} logits: card and CPU "
                                     "disagree")
        check_card_vs_cpu(f"(a) {cfg.name} first batch", mod.loss_fn, ph,
                          (gh, labels.cpu(), cfg), dev, tol=GNN_TOL,
                          step=False, held32=held32)
        del p0, ph, g, gh, first
    del sampler


def phase_gnn():
    """Phase 8: the GNNs at their published widths."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs.gnn_shapes import GNN_SHAPES
    from repro_torch.data import graphs
    from repro_torch.kernels import launch_counts
    from repro_torch.models import dcn_v2
    from repro_torch.models.gnn import (equiformer_v2, gat, gatedgcn, mace,
                                        pna, so3)
    from repro_torch.models.gnn.common import GraphBatch

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    cpu = torch.device("cpu")
    say(f"phase 8 launch counts before: {launch_counts()}")
    phase_gnn_minibatch(dev)
    say(f"(a) {time.perf_counter() - t_phase:.1f} s")

    # (b) full_graph_sm: one step each, card vs CPU
    t0 = time.perf_counter()
    spec = GNN_SHAPES["full_graph_sm"]
    gh, lh = graphs.random_feature_graph(spec["n_nodes"], spec["n_edges"],
                                         spec["d_feat"], spec["n_classes"],
                                         seed=0, device=cpu)
    for name, mod, cfg in (
            ("gatedgcn", gatedgcn, configs.get("gatedgcn").config()),
            ("pna", pna, configs.get("pna").config()),
            ("gat", gat, gat.GATConfig())):
        p0 = mod.init_params(torch.Generator().manual_seed(0), cfg)
        check_card_vs_cpu(
            f"(b) full_graph_sm {spec['n_nodes']} nodes / {spec['n_edges']} "
            f"edges, {cfg.name}, one AdamW step", mod.loss_fn, p0,
            (gh, lh, cfg), dev, held32=name != "pna")
    say(f"(b) {time.perf_counter() - t0:.1f} s")

    # (c) molecule: MACE and EquiformerV2
    t0 = time.perf_counter()
    spec = GNN_SHAPES["molecule"]
    g, energies = graphs.random_molecule_batch(
        spec["batch"], spec["n_nodes"], spec["n_edges"], seed=0, device=dev)
    rng = np.random.default_rng(5)
    a, b_, c = rng.uniform(0, 2 * np.pi, 3)
    R = torch.as_tensor(so3._rot_z(a) @ so3._rot_y(b_) @ so3._rot_z(c),
                        dtype=torch.float32, device=dev)
    k = MOLECULE_CHECK_GRAPHS
    nn_, ne = k * spec["n_nodes"], k * spec["n_edges"]
    small = GraphBatch(src=g.src[:ne].cpu(), dst=g.dst[:ne].cpu(),
                       pos=g.pos[:nn_].cpu(), species=g.species[:nn_].cpu(),
                       graph_id=g.graph_id[:nn_].cpu(), n_graphs=k)
    for name, mod in (("mace", mace), ("equiformer_v2", equiformer_v2)):
        cfg = configs.get(name).config()
        reset_peak()
        p0 = mod.init_params(torch.Generator(dev).manual_seed(0), cfg)
        losses, ms, _ = adamw_steps(mod.loss_fn, p0,
                                    [lambda: (g, energies, cfg)] * 5,
                                    f"(c) {cfg.name} one AdamW step")
        say(f"(c) {cfg.name} {cfg.n_layers} layers, {cfg.channels} "
            f"channels, l_max {cfg.l_max} on {spec['batch']} graphs "
            f"({g.n_nodes} nodes, {g.n_edges} edges), 5 AdamW steps: "
            "losses " + ", ".join(f"{x:.6f}" for x in losses)
            + "; ms per step " + ", ".join(f"{x:.3f}" for x in ms)
            + f"; peak {peak_gib():.3f} GiB")
        ph = moved(p0, cpu)
        # EquiformerV2 at init is ill-conditioned in fp32: _irrep_norm
        # scales its near-zero l >= 1 blocks up to unit rms, and with them
        # the rounding of the rotations and sums that made them; its checks
        # are printed in fp32 and held in float64 (the Wigner blocks stay
        # the reference's fp32, promoted)
        for f64 in (False, True) if name == "equiformer_v2" else (False,):
            cast = as_f64 if f64 else (lambda x: x)
            held = f64 or name != "equiformer_v2"
            kind = "float64" if f64 else "fp32"
            pd, gd = cast(p0), cast(g)
            Rd = R.to(gd.pos.dtype)
            with torch.no_grad():
                e0 = mod.forward(pd, gd, cfg)
                gaps = {"rotation": out_gap(mod.forward(
                    pd, dataclasses.replace(gd, pos=gd.pos @ Rd.T), cfg),
                    e0.cpu())}
                if name == "mace":
                    shift = torch.tensor([1.5, -2.0, 0.3], device=dev,
                                         dtype=gd.pos.dtype)
                    gaps["translation"] = out_gap(mod.forward(
                        pd, dataclasses.replace(gd, pos=gd.pos + shift),
                        cfg), e0.cpu())
                eg = out_gap(mod.forward(pd, cast(small).to(dev), cfg),
                             mod.forward(cast(ph), cast(small), cfg))
            say(f"(c) {cfg.name} invariance on the card, {kind}: max "
                f"|E(R x) - E(x)| {gaps['rotation']:.3g} of scale"
                + (f"; max |E(x + t) - E(x)| {gaps['translation']:.3g}"
                   if "translation" in gaps else "")
                + (f" (limit {GNN_TOL['out']})" if held else " (printed)"))
            say(f"(c) {cfg.name} card vs cpu on the first {k} of "
                f"{spec['batch']} graphs (the CPU backward at "
                f"{spec['batch']} takes minutes), {kind}: energies {eg:.3g} "
                "of scale")
            if held and max(max(gaps.values()), eg) > GNN_TOL["out"]:
                raise AssertionError(f"(c) {name}: not invariant, or card "
                                     "and CPU energies disagree")
        check_card_vs_cpu(f"(c) {cfg.name} first {k} graphs", mod.loss_fn,
                          ph, (small, energies[:k].cpu(), cfg), dev,
                          tol=GNN_TOL, step=False,
                          held32=name != "equiformer_v2")
        del p0, ph
    say(f"(c) {time.perf_counter() - t0:.1f} s")

    # (d) DCN-v2 at its defaults, batch 4096: one step card vs CPU
    t0 = time.perf_counter()
    cfg = dcn_v2.DCNv2Config()
    p0 = dcn_v2.init_params(torch.Generator().manual_seed(0), cfg)
    batch = dcn_v2.random_batch(cfg, DCN_BATCH, seed=0, device=cpu)
    check_card_vs_cpu(f"(d) {cfg.name} {cfg.n_sparse} x "
                      f"{cfg.vocab_per_field} x {cfg.embed_dim}, {cfg.n_cross} "
                      f"cross layers of rank {cfg.cross_rank}, MLP "
                      f"{'-'.join(map(str, cfg.mlp))}, batch {DCN_BATCH}, "
                      "one AdamW step",
                      lambda p, b: dcn_v2.loss_fn(p, b, cfg), p0, (batch,),
                      dev)
    say(f"(d) {time.perf_counter() - t0:.1f} s")
    say(f"phase 8 launch counts after: {launch_counts()}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    reset_peak()


# ---------------------------------------------------------------------------
# Phase 9: the mesh layer on a world of one
# ---------------------------------------------------------------------------

# The dry-run cells phase 9 requires on both production meshes: the three
# gredo cells and one cell of each family. Each mesh runs in a child
# process of its own (the fake backend must not share a process with
# NCCL), both started before phase 7 so they run beside it.
DRYRUN_CELLS = ("gredo/gcda_regression", "gredo/gcda_similarity",
                "gredo/gcda_multiply", "qwen2_1_5b/train_4k",
                "qwen2_1_5b/prefill_32k", "qwen2_1_5b/decode_32k",
                "olmoe_1b_7b/train_4k", "olmoe_1b_7b/decode_32k",
                "wide_deep/serve_p99", "gatedgcn/full_graph_sm",
                "pna/full_graph_sm", "mace/molecule",
                "equiformer_v2/molecule")
DRYRUN_GNN_CELLS = DRYRUN_CELLS[-4:]
DRYRUN_TIMEOUT_S = 900
# The JAX package's per-device (FLOPs, collective bytes) ratios, 2x16x16
# over 16x16, of the LM, recommender and GNN cells above: from its records
# of `JAX_PLATFORMS=cpu PYTHONPATH=src python -m repro.launch.dryrun --arch
# ARCH --shape SHAPE --both-meshes` (jax 0.9.0, CPU). The port cannot
# import the JAX package, so they are constants. The LM and recommender
# FLOPs are XLA's `flops_per_device`; a GNN's are its matrix products
# alone (`dot_flops_per_device`), since XLA's count of a GNN step also
# holds its elementwise work (MACE's whole count is twice its products)
# and the port counts products only. GatedGCN's FLOPs are not held (None):
# the reference's product count skips its layer scan. Such a cell must
# replicate no operation and keep its ratios within DRYRUN_RATIO_BAND of
# the reference's.
DRYRUN_REF_RATIOS = {"qwen2_1_5b/train_4k": (0.4999, 0.5179),
                     "qwen2_1_5b/prefill_32k": (0.5000, 0.5000),
                     "qwen2_1_5b/decode_32k": (0.5018, 0.5000),
                     "olmoe_1b_7b/train_4k": (0.5001, 0.5130),
                     "olmoe_1b_7b/decode_32k": (0.5083, 0.5213),
                     "wide_deep/serve_p99": (0.5000, 0.5000),
                     "gatedgcn/full_graph_sm": (None, 1.0000),
                     "pna/full_graph_sm": (0.9780, 1.0000),
                     "mace/molecule": (0.9246, 0.9222),
                     "equiformer_v2/molecule": (0.5203, 0.7473)}
DRYRUN_RATIO_BAND = 0.10
# Per-device matrix-product FLOPs at 16x16 a cell may not exceed: MACE's
# the reference's whole XLA count (9.5714e8, elementwise work included;
# its products alone 4.7551e8), EquiformerV2's 1.10 times the reference's
# products (1.5098e10), from the same records.
DRYRUN_FLOPS_BOUNDS = {"mace/molecule": 9.6e8,
                       "equiformer_v2/molecule": 1.66e10}
# The reference's collective bytes per device at 16x16 of the GNN cells,
# from the same records. A GNN cell's bytes may exceed them by at most
# DRYRUN_RATIO_BAND, and its collective ratio may exceed the reference's
# by at most DRYRUN_RATIO_BAND but fall below it by any amount: the port
# moves less per device than the reference on both meshes, and its MACE
# and EquiformerV2 run their node-wise work on each data rank's nodes on
# both, where GSPMD splits it so on two pods only.
DRYRUN_REF_GNN_BYTES = {"gatedgcn/full_graph_sm": 1.2195e8,
                        "pna/full_graph_sm": 5.2733e7,
                        "mace/molecule": 7.5993e7,
                        "equiformer_v2/molecule": 2.0757e9}
# One rank's block of the production 16x16 mesh (launch.specs placements)
MESH_BLOCKS = {"gcda_regression": (262_144, 512),       # X over data
               "gcda_similarity": (16_384, 256),        # X over data, Y model
               "gcda_multiply": (4_096, 4_096)}         # X rows, Y columns


def start_dryruns(out_dir: Path) -> list:
    """The two dry-run children (16x16 and 2x16x16), on the CPU."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    cells = [a for c in DRYRUN_CELLS for a in ("--cell", c)]
    procs = []
    for mesh, flag in (("16x16", []), ("2x16x16", ["--multi-pod"])):
        log = open(out_dir / f"dryrun_{mesh}.log", "w")
        procs.append((mesh, time.perf_counter(), log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *cells,
             *flag, "--out", str(out_dir / "records")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def world_of_one():
    """An NCCL process group of this process alone and a 1x1 mesh on the
    card over it."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore(),
                            device_id=torch.device("cuda", 0))
    return make_local_mesh(1, 1)


def mesh_gcda(cap, mesh) -> dict:
    """(a): the GCDA mesh forms on phase 3's A3, A2, A1 and a_shard_reg
    inputs against their local forms; the kernels' counters must move."""
    import torch
    from repro_torch.core import analytics
    from repro_torch.kernels import launch_counts, reset_launch_counts

    X3, Y3 = cap.calls["matmul"][1]
    X2, Y2 = cap.calls["cosine_sim"][1]
    X1, y1, _ = cap.calls["logreg_grad/A1"][1]
    Xs, ys, _ = cap.calls["logreg_grad/shard"][1]
    forms = (
        ("A3 multiply", "matmul",
         lambda: analytics.multiply(X3, Y3, mesh=mesh).to_local(),
         lambda: analytics.multiply(X3, Y3)),
        ("A2 similarity", "cosine_sim",
         lambda: analytics.similarity(X2, Y2, mesh=mesh).to_local(),
         lambda: analytics.similarity(X2, Y2)),
        ("A1 regression", "logreg_grad",
         lambda: analytics.regression_distributed(X1, y1, mesh, iters=100),
         lambda: analytics.regression(X1, y1, iters=100)),
        ("a_shard_reg regression", "logreg_grad",
         lambda: analytics.regression_distributed(Xs, ys, mesh, iters=50),
         lambda: analytics.regression(Xs, ys, iters=50)))
    reset_launch_counts()
    outs = {label: fn() for label, _, fn, _ in forms}
    torch.cuda.synchronize()
    launches = launch_counts()
    say("phase 9 (a) launches on the mesh forms: " + json.dumps(launches))
    for label, name, mesh_fn, local_fn in forms:
        if launches[name] == 0:
            raise AssertionError(f"(a) {label}: {name} never launched")
        got, want = outs[label], local_fn()
        tol = TOL["matmul" if name == "matmul" else "cosine_sim"]
        if isinstance(got, tuple):
            err = max(assert_close(f"(a) {label} weights", got[0], want[0],
                                   *tol),
                      assert_close(f"(a) {label} loss", got[1], want[1], *tol))
        else:
            err = assert_close(f"(a) {label}", got, want, *tol)
        ms_mesh = wall_ms(mesh_fn)
        ms_local = wall_ms(local_fn)
        say(f"(a) {label}: mesh form {ms_mesh:.3f} ms, local form "
            f"{ms_local:.3f} ms (wall, synchronised), max |mesh - local| "
            f"{err:.3g}")
    return launches


def wall_ms(fn, reps: int = 3) -> float:
    """Mean wall time of ``fn`` over ``reps`` synchronised calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def mesh_cells(mesh, card: str) -> list:
    """(b): the three gredo cells at one rank's block of the production
    16x16 mesh, each step against its plain version and timed; a kernel
    row of each at that block."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
    from repro_torch.kernels.logreg.ref import logreg_grad_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.launch.specs import build_cell

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n, d = MESH_BLOCKS["gcda_regression"]
    m, f = MESH_BLOCKS["gcda_similarity"]
    k = MESH_BLOCKS["gcda_multiply"][0]
    args = {"gcda_regression": (randn(n, d),
                                (randn(n) > 0).float(), randn(d) * 0.01),
            "gcda_similarity": (randn(m, f), randn(m, f)),
            "gcda_multiply": (randn(k, k), randn(k, k))}
    cells = {s: build_cell("gredo", s, mesh) for s in MESH_BLOCKS}
    reset_launch_counts()
    outs = {s: cells[s].fn(*args[s]) for s in MESH_BLOCKS}
    torch.cuda.synchronize()
    launches = launch_counts()
    say("phase 9 (b) launches on the gredo cells: " + json.dumps(launches))

    rows = []
    # regression: this rank's share of the mean gradient and loss, one step
    X, y, w = args["gcda_regression"]
    share = n / cells["gcda_regression"].meta["rows"]
    g, loss = logreg_grad_ref(X, y, w)
    w1, l1 = outs["gcda_regression"]
    err = max(assert_close("(b) gcda_regression weights", w1,
                           w - 0.5 * g * share, *TOL["logreg_grad"]),
              assert_close("(b) gcda_regression loss", l1, loss * share,
                           *TOL["logreg_grad"]))
    b = bound_ms((n * d + n + 2 * d + 1) * 4, 4.0 * n * d, "float32")
    step_report("gcda_regression", f"{n}x{d} fp32", cells, args, err, b,
                card)
    kernel = wrapper("logreg_grad")
    rows.append(report_row(
        "logreg_grad/mesh_gcda_regression", "logreg_grad",
        launches["logreg_grad"],
        max(assert_close("(b) logreg_grad block", a, b_, *TOL["logreg_grad"])
            for a, b_ in zip(kernel(X, y, w), (g, loss))),
        lambda: kernel(X, y, w), lambda: logreg_grad_ref(X, y, w), b, None,
        f"{n}x{d} (one rank's rows of the 16x16 mesh)"))
    # similarity: a (data i, model j) tile, cast to bf16 as the cell does
    X, Y = args["gcda_similarity"]
    want = cosine_sim_ref(X, Y)
    err = assert_close("(b) gcda_similarity", outs["gcda_similarity"]
                       .to_local(), want.to(torch.bfloat16),
                       *TOL["matmul_bf16"])
    b = bound_ms(2 * m * f * 4 + m * m * 2, 2.0 * m * m * f, "float32")
    step_report("gcda_similarity", f"{m}x{f} vs {m}x{f} fp32 -> bf16", cells,
                args, err, b, card)
    kernel = wrapper("cosine_sim")
    b = bound_ms(2 * m * f * 4 + m * m * 4, 2.0 * m * m * f + 4.0 * m * f,
                 "float32")
    rows.append(report_row(
        "cosine_sim/mesh_gcda_similarity", "cosine_sim",
        launches["cosine_sim"],
        assert_close("(b) cosine_sim block", kernel(X, Y), want,
                     *TOL["cosine_sim"]),
        lambda: kernel(X, Y), lambda: cosine_sim_ref(X, Y), b, None,
        f"{m}x{f} vs {m}x{f} (one rank's tile of the 16x16 mesh)"))
    del want
    # multiply: X's row block @ Y's column block, cast to bf16
    X, Y = args["gcda_multiply"]
    want = matmul_ref(X, Y)
    err = assert_close("(b) gcda_multiply", outs["gcda_multiply"].to_local(),
                       want.to(torch.bfloat16), *TOL["matmul_bf16"])
    b = bound_ms(2 * k * k * 4 + k * k * 2, 2.0 * k ** 3, "float32")
    step_report("gcda_multiply", f"{k}x{k} @ {k}x{k} fp32 -> bf16", cells,
                args, err, b, card)
    kernel = wrapper("matmul")
    b = bound_ms(3 * k * k * 4, 2.0 * k ** 3, "float32")
    rows.append(report_row(
        "matmul/mesh_gcda_multiply", "matmul", launches["matmul"],
        assert_close("(b) matmul block", kernel(X, Y), want, *TOL["matmul"]),
        lambda: kernel(X, Y), lambda: matmul_ref(X, Y), b,
        time_ms(lambda: torch.matmul(X, Y))[0],
        f"{k}x{k} @ {k}x{k} fp32 (one rank's tile of the 16x16 mesh)"))
    return rows


def step_report(shape, desc, cells, args, err, b, card) -> None:
    ms = time_ms(lambda: cells[shape].fn(*args[shape]))[0]
    say(f"(b) {shape} at {desc}: step {ms:.4f} ms (CUDA events), bound "
        f"{b[0]:.4f} ms ({b[1]}) on {card}; max |step - plain| {err:.3g}")


def mesh_moe(mesh) -> None:
    """(c): OLMoE-1B-7B at full width and depth on the mesh forms (the
    shard_map MoE over 'model', the sequence-sharded decode attention),
    a prefill of 8 x 512 and 4 decode steps, against the unsharded dense
    path pinned to the mesh run's experts."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    cfg, params = serve.build(MOE_ARCH, "full", dev)
    on_mesh = dataclasses.replace(
        cfg, mesh=mesh, mesh_dp=("data",), moe_ep_axis="model",
        moe_impl="shard_map", kv_seq_shard="model")
    dense = dataclasses.replace(cfg, attn_impl="dense")
    prompts = torch.randint(0, cfg.vocab, (8, 512), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    logits_trace(params, on_mesh, prompts, steps=1)          # warm-up
    torch.cuda.synchronize()
    reset_peak()
    reset_launch_counts()
    with RouteRecorder() as rm, StepTimer() as timer:
        mesh_out, fed = logits_trace(params, on_mesh, prompts)
    launches = launch_counts()
    peak = peak_gib()
    if launches["flash_attention"] != 0:
        raise AssertionError("(c) the mesh path launched flash attention; "
                             "with kv_seq_shard every attention call is the "
                             "sequence-sharded one")
    with RouteRecorder(replay=rm.routes):
        dense_out, _ = logits_trace(params, dense, prompts, fed)
    worst = 0.0
    for i, (a, b) in enumerate(zip(mesh_out, dense_out)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"(c) mesh logits step {i}: not finite")
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        worst = max(worst, err / scale)
        if err > LOGIT_SCALE_TOL * scale:
            raise AssertionError(
                f"(c) step {i}: max |mesh - dense| {err} > "
                f"{LOGIT_SCALE_TOL} * {scale}")
    say(f"(c) {cfg.name} on the 1x1 mesh (shard_map MoE over 'model', "
        f"sequence-sharded decode attention): prefill 8 x 512 "
        f"{timer.ms[0]:.3f} ms, decode steps "
        f"{', '.join(f'{t:.3f}' for t in timer.ms[1:])} ms (wall, "
        f"synchronised), peak device memory {peak:.3f} GiB, launches "
        f"{json.dumps(launches)}; logits (prefill + 4 decode steps) against "
        f"the unsharded dense path pinned to its experts: max |diff| / max "
        f"|dense| {worst:.4g} (limit {LOGIT_SCALE_TOL})")
    del params
    torch.cuda.empty_cache()


class StepTimer:
    """Wall time of each forward (prefill, then decode steps) run inside
    it, each ending in a device synchronise."""

    def __enter__(self):
        import torch
        from repro_torch.models import transformer as tf
        self.ms: list = []
        self._orig = tf.forward

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = self._orig(*a, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        tf.forward = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf.forward = self._orig


MESH_RANKS = 8            # (e): the 2x4 mesh as gloo ranks on the one card


def gloo_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """(e), one rank: the GCDA mesh forms on its CUDA blocks, each tile
    and the regression held against the plain versions of its block."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import analytics
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.launch.mesh import make_local_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    try:
        mesh = make_local_mesh(2, 4)
        dev = torch.device(DEVICE)
        g = torch.Generator(dev).manual_seed(3)        # the same on every rank
        X = torch.randn(4096, 200, device=dev, generator=g)
        Y = torch.randn(200, 4096, device=dev, generator=g)
        lab = (X[:, 0] > 0).float()
        i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        rows, cols = X[2048 * i:2048 * (i + 1)], slice(1024 * j, 1024 * (j + 1))
        reset_launch_counts()
        z = analytics.multiply(X, Y, mesh=mesh).to_local()
        s = analytics.similarity(X, X, mesh=mesh).to_local()
        w, loss = analytics.regression_distributed(X, lab, mesh, iters=20)
        torch.cuda.synchronize()
        counts = launch_counts()
        errs = {"multiply": assert_close(
                    f"(e) rank {rank} multiply tile", z,
                    matmul_ref(rows, Y[:, cols].contiguous()), *TOL["matmul"]),
                "similarity": assert_close(
                    f"(e) rank {rank} similarity tile", s,
                    cosine_sim_ref(rows, X[cols]), *TOL["cosine_sim"])}
        w_p, loss_p = analytics.regression(X, lab, iters=20, use_kernel=False)
        errs["regression"] = max(
            assert_close(f"(e) rank {rank} weights", w, w_p,
                         *TOL["logreg_grad"]),
            assert_close(f"(e) rank {rank} loss", loss, loss_p,
                         *TOL["logreg_grad"]))
        Path(out_dir, f"gloo_rank{rank}.json").write_text(json.dumps(
            {"launches": counts, "errs": errs}))
    finally:
        dist.destroy_process_group()


def mesh_gloo(out_dir: Path) -> None:
    """(e): the 2x4 mesh as 8 gloo processes on the one card, each running
    the kernels on its CUDA blocks; gloo carries the collectives."""
    import torch.multiprocessing as mp
    store = out_dir / "gloo_store"
    if store.exists():
        store.unlink()
    t0 = time.perf_counter()
    mp.start_processes(gloo_rank, args=(MESH_RANKS, str(store),
                                        str(out_dir)),
                       nprocs=MESH_RANKS, start_method="spawn")
    recs = [json.loads((out_dir / f"gloo_rank{r}.json").read_text())
            for r in range(MESH_RANKS)]
    for name in ("matmul", "cosine_sim", "logreg_grad"):
        if any(r["launches"][name] == 0 for r in recs):
            raise AssertionError(f"(e) a rank never launched {name}")
    worst = {k: max(r["errs"][k] for r in recs) for k in recs[0]["errs"]}
    say(f"(e) 2x4 mesh as {MESH_RANKS} gloo processes on the card: every "
        f"rank's multiply and similarity tile and the regression match the "
        f"plain versions (max |err| {json.dumps(worst)}); launches on rank "
        f"0 {json.dumps(recs[0]['launches'])}; "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")


def finish_dryruns(procs, out_dir: Path) -> None:
    """(d): wait for the dry-run children; every required cell must be ok
    on both meshes, an LM, recommender or GNN cell must replicate no
    operation, its per-device FLOPs and collective bytes must shrink from
    16x16 to 2x16x16 as the reference's do (DRYRUN_REF_RATIOS; a GNN's
    collective bytes may shrink more, within DRYRUN_REF_GNN_BYTES), and
    MACE's and EquiformerV2's FLOPs per device at 16x16 keep within
    DRYRUN_FLOPS_BOUNDS."""
    failed, n_ok, recs = [], 0, {}
    for mesh, t0, log, proc in procs:
        try:
            rc = proc.wait(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        secs = time.perf_counter() - t0
        tail = (out_dir / f"dryrun_{mesh}.log").read_text().splitlines()
        say(f"(d) dry-run on {mesh}: exit {rc}, {secs:.1f} s "
            f"(started before phase 7); {tail[-1] if tail else ''}")
        for cell in DRYRUN_CELLS:
            arch, shape = cell.split("/")
            path = out_dir / "records" / f"{arch}_{shape}_{mesh}.json"
            rec = json.loads(path.read_text()) if path.exists() else {
                "ok": False, "error": "no record"}
            if not rec.get("ok"):
                failed.append(f"{cell}/{mesh}: {rec.get('error')}")
                continue
            n_ok += 1
            recs[cell, mesh] = rec
            replicated = rec["replicated_ops"]
            say(f"(d) {cell}/{mesh}: flops/device "
                f"{rec['flops_per_device']:.4e}, argument GB/device "
                f"{rec['memory']['argument_bytes'] / 1e9:.4f}, collective "
                f"bytes {rec['collectives']['total_bytes']:.4e}, trace "
                f"{rec['trace_s']} s, replicated ops "
                f"{json.dumps(replicated, sort_keys=True)}, collectives by "
                f"mesh dims {json.dumps(rec.get('collective_groups'))}")
            if cell in DRYRUN_REF_RATIOS and replicated:
                failed.append(f"{cell}/{mesh}: replicated {replicated}")
    for cell, (ref_flops, ref_coll) in DRYRUN_REF_RATIOS.items():
        if (cell, "16x16") not in recs or (cell, "2x16x16") not in recs:
            continue
        one, two = recs[cell, "16x16"], recs[cell, "2x16x16"]
        flops = two["flops_per_device"] / one["flops_per_device"]
        coll = (two["collectives"]["total_bytes"]
                / max(one["collectives"]["total_bytes"], 1))
        held = "not held" if ref_flops is None else f"{ref_flops:.4f}"
        say(f"(d) {cell}: 2x16x16 / 16x16 flops/device {flops:.4f} "
            f"(reference {held}), collective bytes {coll:.4f} "
            f"(reference {ref_coll:.4f})")
        for what, got, ref in (("flops", flops, ref_flops),
                               ("collective bytes", coll, ref_coll)):
            off = got / ref - 1 if ref is not None else 0.0
            if what != "flops" and cell in DRYRUN_REF_GNN_BYTES:
                off = max(off, 0.0)
            if abs(off) > DRYRUN_RATIO_BAND:
                failed.append(f"{cell}: {what} ratio {got:.4f} against "
                              f"the reference's {ref:.4f}")
    for cell, ref in DRYRUN_REF_GNN_BYTES.items():
        if (cell, "16x16") in recs:
            got = recs[cell, "16x16"]["collectives"]["total_bytes"]
            say(f"(d) {cell}/16x16: collective bytes/device {got:.4e} "
                f"(reference {ref:.4e})")
            if got > (1 + DRYRUN_RATIO_BAND) * ref:
                failed.append(f"{cell}/16x16: collective bytes/device "
                              f"{got:.4e} above the reference's {ref:.4e}")
    for cell, bound in DRYRUN_FLOPS_BOUNDS.items():
        if (cell, "16x16") in recs:
            got = recs[cell, "16x16"]["dot_flops_per_device"]
            say(f"(d) {cell}/16x16: dot flops/device {got:.4e} "
                f"(bound {bound:.4e})")
            if got > bound:
                failed.append(f"{cell}/16x16: dot flops/device {got:.4e} "
                              f"above {bound:.4e}")
    for mesh in ("16x16", "2x16x16"):
        gnn = [recs[c, mesh]["trace_s"] for c in DRYRUN_GNN_CELLS
               if (c, mesh) in recs]
        say(f"(d) the GNN cells' traces on {mesh}: {sum(gnn):.1f} s "
            f"({len(gnn)} cells)")
    say(f"(d) dry-run: {n_ok} ok, {len(failed)} failed")
    if failed:
        raise AssertionError("dry-run cells failed: " + "; ".join(failed))


def phase_mesh(cap, procs, out_dir: Path) -> list:
    import torch.distributed as dist
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    mesh = world_of_one()
    try:
        say(f"phase 9: the mesh layer on a world of one (NCCL, 1x1 mesh "
            f"{mesh.mesh_dim_names}) on {card}")
        mesh_gcda(cap, mesh)
        rows = mesh_cells(mesh, card)
        mesh_moe(mesh)
    finally:
        dist.destroy_process_group()
    mesh_gloo(out_dir)
    say(f"phase 9 (a)-(c), (e): {time.perf_counter() - t0:.1f} s")
    finish_dryruns(procs, out_dir)
    return rows


def flash_rows(cap, arch=None) -> list:
    """The flash kernel's prefill and decode rows at a serving path's
    captured calls; ``arch`` names the rows of a path other than phase
    4's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import wrapper_module
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rows = []
    for kind in ("prefill", "decode"):
        key = f"flash_attention/{kind}"
        if key not in cap.calls:
            raise AssertionError(f"{key}: no serving call was captured")
        _, (q, k, v, lens), kw = cap.calls[key]
        b, h, sq, dh = q.shape
        hk, skv = k.shape[1], k.shape[2]
        kernel = wrapper("flash_attention")
        err = assert_close(f"{key} (serving path)", kernel(q, k, v, lens, **kw),
                           flash_attention_ref(q, k, v, lens, **kw),
                           *TOL["flash_bf16"])
        # work of these inputs: the keys each query sees
        lens_l = lens.long()
        qpos = (lens_l[:, None] - sq
                + torch.arange(sq, device=q.device)[None])
        seen = torch.minimum(qpos + 1, torch.clamp(lens_l, max=skv)[:, None])
        pairs = int(seen.clamp_min(0).sum()) * h
        kv_read = int(torch.clamp(lens_l, max=skv).sum()) * hk * dh * 2
        nbytes = (2 * q.numel() + kv_read) * q.element_size() + 4 * b
        dtype = str(q.dtype).removeprefix("torch.")
        bnd = bound_ms(nbytes, 4.0 * dh * pairs, dtype)
        kpos = torch.arange(skv, device=q.device)
        mask = ((kpos[None, None] < lens_l[:, None, None])
                & (kpos[None, None] <= qpos[:, :, None]))[:, None]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))[0]
        splits = wrapper_module("flash_attention").num_splits(b, h, hk, sq,
                                                             skv)
        rows.append(report_row(
            key if arch is None else f"{key}/{arch}", "flash_attention",
            cap.counts[key], err,
            lambda: kernel(q, k, v, lens, **kw),
            lambda: flash_attention_ref(q, k, v, lens, **kw), bnd, library_ms,
            f"q {b}x{h}x{sq}x{dh} kv {b}x{hk}x{skv}x{dh} {dtype} lengths "
            f"{lens.min().item()}-{lens.max().item()}, {splits} KV splits"))
    return rows


def graph_ms(make_call, copies: int, k: int, replays: int = 10) -> float:
    """Device time of one call with the host out of the way: ``k`` calls
    captured in one CUDA graph, call i made by ``make_call(i % copies)``,
    the graph replayed ``replays`` times after one warm replay, timed by
    CUDA events and divided by ``k * replays``. With one copy the inputs
    stay in L2 from call to call (warm); over ``cold_copies`` copies, each
    call finds its inputs in device memory (cold)."""
    import torch
    calls = [make_call(c) for c in range(copies)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()                      # outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for i in range(k):
                calls[i % copies]()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (k * replays)
    del graph
    return ms


def cold_copies(touched_bytes: float) -> int:
    """Copies of a call's inputs such that, rotating over them, the calls
    on the other copies between two uses of one copy touch at least twice
    the L2; one copy where a call alone touches that much (it then evicts
    its own rows before the next call reads them)."""
    if touched_bytes >= 2 * L2_BYTES:
        return 1
    return math.ceil(2 * L2_BYTES / touched_bytes) + 1


def bag_bytes(table, idx, w) -> tuple[int, int]:
    """The bytes a bag call must move (each distinct row of a valid slot,
    the indices, the weights and the fp32 output once) and the number of
    distinct rows."""
    import torch
    n_rows = int(torch.unique(idx[idx >= 0]).numel())
    D = table.shape[1]
    nbytes = (n_rows * D * table.element_size() + idx.numel() * 4
              + (0 if w is None else w.numel() * w.element_size())
              + idx.shape[0] * D * 4)
    return nbytes, n_rows


def bag_row(row_name, table, idx, w, k, shape) -> dict:
    """One embedding-bag row: the kernel against its plain version, the
    ``report_row`` columns, the byte bound (each distinct row of a valid
    slot, the indices, the weights and the output once; a warm reading may
    beat it, because it reads from L2) and the CUDA-graph times, warm and
    cold (``graph_ms`` over ``cold_copies`` copies of the table, indices
    and weights)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    kernel = wrapper("embedding_bag")
    err = assert_close(f"{row_name} ({shape})", kernel(table, idx, w),
                       embedding_bag_ref(table, idx, w),
                       *TOL["embedding_bag"])
    valid = idx >= 0
    nbytes, n_rows = bag_bytes(table, idx, w)
    lib_idx = idx.clamp_min(0)
    lib_w = None if w is None else w * valid
    library_ms = time_ms(lambda: F.embedding_bag(
        lib_idx, table, mode="sum", per_sample_weights=lib_w))[0]
    del lib_idx, lib_w
    shape = (f"{shape} ({int(valid.sum())} valid slots, {n_rows} distinct "
             "rows)")
    row = report_row(row_name, "embedding_bag", 0, err,
                     lambda: kernel(table, idx, w),
                     lambda: embedding_bag_ref(table, idx, w),
                     (nbytes / PEAK_BYTES_S * 1e3, "bytes"), library_ms,
                     shape)
    copies = cold_copies(nbytes)
    inputs = [(table, idx, w)] + [
        (table.clone(), idx.clone(), None if w is None else w.clone())
        for _ in range(copies - 1)]
    row["graph_warm_ms"] = graph_ms(lambda c: lambda: kernel(table, idx, w),
                                    1, k)
    row["graph_cold_ms"] = graph_ms(lambda c: lambda: kernel(*inputs[c]),
                                    copies, k)
    row["cold_copies"] = copies
    say(f"{row_name}: CUDA graph of {k} launches, warm "
        f"{row['graph_warm_ms']:.4f} ms, cold {row['graph_cold_ms']:.4f} ms "
        f"({copies} copies of {nbytes / 1e6:.1f} MB touched), bound "
        f"{row['bound_ms']:.4f} ms: cold at "
        f"{row['bound_ms'] / row['graph_cold_ms']:.1%} of the byte bound "
        f"({nbytes / row['graph_cold_ms'] / 1e9:.4f} TB/s), warm reads L2")
    return row


def embedding_bag_rows() -> list:
    """The embedding bag is on no path (the recommender gathers and
    segment-sums, as the reference does). Its rows: the kernels_bench
    shape, 4096 bags x 16 over a 100k x 64 fp32 table, weighted, seed 7;
    and MLPerf Training's DLRM-DCNv2 multi-hot bag (Criteo 1TB: embedding
    dim 128, its 40M-row tables, its largest multi-hot size 100, global
    batch 65,536), one 40M x 128 fp32 table (20.48 GB) made on the card,
    65,536 bags of 100 ids uniform from the seed (Criteo's skew is not
    modelled), unweighted."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    dev = torch.device(DEVICE)
    table, idx, w = embedding_bag_inputs(
        rng, lambda a, dt=torch.float32: torch.as_tensor(
            np.asarray(a), device=dev).to(dt), 4096, 16, 100_000, 64)
    rows = [bag_row("embedding_bag", table, idx, w, 64,
                    "4096 bags x 16 over 100000x64 fp32, weighted")]
    del table, idx, w
    torch.cuda.empty_cache()
    V, D, n_bags, bag = DLRM_BAG
    gen = torch.Generator(device=dev)
    gen.manual_seed(DLRM_SEED)
    say(f"embedding_bag/dlrm_dcnv2: {V}x{D} fp32 table and {n_bags}x{bag} "
        f"ids from torch.Generator(cuda) seed {DLRM_SEED}")
    table = torch.randn((V, D), generator=gen, device=dev)
    idx = torch.randint(0, V, (n_bags, bag), generator=gen, device=dev,
                        dtype=torch.int32)
    rows.append(bag_row(
        "embedding_bag/dlrm_dcnv2", table, idx, None, 8,
        f"{n_bags} bags x {bag} over {V}x{D} fp32, unweighted, uniform "
        "ids (Criteo's skew not modelled)"))
    del table, idx
    torch.cuda.empty_cache()
    return rows


def bag_split_lines() -> None:
    """The j split's gain: each of LONG_BAGS timed in a CUDA graph (64
    launches, warm and cold) at the plan's launch and unsplit (the plan of
    one-slot bags, which never splits j), each checked against the plain
    version first."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.kernels import wrapper_module
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    eb = wrapper_module("embedding_bag")
    kernel = eb.embedding_bag
    planned = eb._plan

    def unsplit(n_bags, bag, *rest):
        return planned(n_bags, 1, *rest)

    rng = np.random.default_rng(7)
    dev = torch.device(DEVICE)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    for nbags, bag, V, D, dtype, weighted in LONG_BAGS:
        table, idx, w = embedding_bag_inputs(rng, t, nbags, bag, V, D,
                                             weighted,
                                             dtype=getattr(torch, dtype))
        nbytes, _ = bag_bytes(table, idx, w)
        copies = cold_copies(nbytes)
        inputs = [(table, idx, w)] + [
            (table.clone(), idx.clone(), None if w is None else w.clone())
            for _ in range(copies - 1)]
        want = embedding_bag_ref(table, idx, w)
        shape = f"{nbags} x {bag} over {V}x{D} {dtype}"
        text = []
        for label, how in (("split", planned), ("unsplit", unsplit)):
            launch = how(nbags, bag, D, table.element_size(), True,
                         table.device.index)
            with mock.patch.object(eb, "_plan", how):
                assert_close(f"embedding_bag {shape} {label}",
                             kernel(table, idx, w), want,
                             *TOL["embedding_bag"])
                warm = graph_ms(lambda c: lambda: kernel(table, idx, w), 1,
                                64)
                cold = graph_ms(lambda c: lambda: kernel(*inputs[c]), copies,
                                64)
            text.append(f"{label} (vec, lanes, splits, blocks) {launch}: "
                        f"warm {warm:.4f} ms, cold {cold:.4f} ms")
        say(f"embedding_bag long bags {shape}: " + "; ".join(text)
            + f"; bound {nbytes / PEAK_BYTES_S * 1e3:.4f} ms ({copies} "
            f"copies of {nbytes / 1e6:.1f} MB)")
        del table, idx, w, inputs, want


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    phase_device()
    phase_sweep()
    launches, cap, db = phase_main()
    phase_declarative(db)
    del db
    rows = kernel_report(launches, cap) + matgen_rows(launches)
    rows += flash_rows(phase_serve())
    rows += flash_rows(phase_moe_serve(), MOE_ARCH)
    phase_train()
    out_dir = ROOT / "build" / "chip_smoke"
    (out_dir / "records").mkdir(parents=True, exist_ok=True)
    procs = start_dryruns(out_dir)
    try:
        phase_recsys()
        phase_gnn()
        rows += phase_mesh(cap, procs, out_dir)
    finally:
        for _, _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    rows += embedding_bag_rows()
    bag_split_lines()
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
