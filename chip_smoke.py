#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GredoDB (``src/repro_torch``) on one
NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each raises on failure; the script then exits non-zero):
  1. device facts: card name and power limit (nvidia-smi), torch and CUDA
     versions, and the build of the four CUDA kernels from ``csrc/``;
  2. every kernel against its plain PyTorch version on the card at the
     reference sweep shapes (fp32 matmul 2e-4, bf16 2e-2; cosine and
     logreg rtol 3e-4 / atol 3e-5; traversal exact, fused and batched);
  3. the main path on ``m2bench.generate(sf=10, seed=0)``: a warm-up
     engine, then a fresh ``GredoEngine`` runs G1-G5 and q_opt_skew,
     ``analyze`` of A2, A3 and a_shard_reg, and A1 through
     ``analytics.regression``, with every launch counter set to 0 just
     before and read just after. Checks: G3 and G5 lowered to
     device-pallas, all four counters moved, GCDI fingerprints equal to
     the port's own host matcher's, GCDA outputs equal to the plain
     versions within the tolerances above. Then each kernel is compared
     with its plain version and timed (CUDA events) on the very inputs
     the main path gave it;
  4. one JSON line listing the kernels (launches, max error, times, bound);
  5. the result line ``{"ok": true, "device": {...}}``.

Nothing of JAX or of the JAX package is imported. Without a CUDA device,
or without the rest of the repository beside it, the script fails before
it prints a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# M2Bench scale of the main path: the largest of the scales checked (1, 10,
# 20) at which the optimizer still lowers G3 and G5 to the traversal kernel,
# so the path runs all four kernels (at 20 their estimated peak frontiers
# exceed DEVICE_MAX_FRONTIER and they stay on the host matcher).
SF = 10
TOL = {"matmul": (2e-4, 2e-4), "matmul_bf16": (2e-2, 2e-2),
       "cosine_sim": (3e-4, 3e-5), "logreg_grad": (3e-4, 3e-5)}


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

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    n_checks = 0
    for m, k, n in [(32, 32, 32), (128, 128, 128), (100, 60, 130),
                    (257, 129, 65)]:
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
    for n, d in [(100, 16), (512, 64), (65, 7)]:
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

    # fused: the reference sweep, plus a multi-block capacity
    for seed, capacity, n, c0 in [(0, 128, 12, 6), (1, 128, 12, 6),
                                  (2, 256, 12, 6), (3, 2048, 400, 300)]:
        rp, ci, ei, mem, ep, ca = hop_tables(seed, n)
        r = np.random.default_rng(seed + 100)
        frontier = np.zeros(capacity, np.int32)
        frontier[:c0] = r.integers(0, n, c0)
        fmask = np.zeros(capacity, bool)
        fmask[:c0] = True
        args = (rp, ci, ei, t(frontier, torch.int32), t(fmask, torch.bool),
                mem, ep, ca)
        kw = dict(capacity=capacity, chunk=8)
        for a, b in zip(fused_hop(*args, **kw),
                        tref.fused_hop_ref(*args, **kw)):
            assert_equal(f"fused_hop seed={seed} cap={capacity}", a, b)
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
    torch.cuda.synchronize()
    say(f"phase 2: {n_checks} sweep cases, every kernel matches its plain "
        "version")


# ---------------------------------------------------------------------------
# Phase 3: the main path at sf=10
# ---------------------------------------------------------------------------


class Capture:
    """Records, per kernel, the last main-path call of those with the most
    work, so the kernels can later be compared and timed on exactly those
    inputs (for logreg_grad that is A1's last step, at trained weights)."""

    def __init__(self):
        self.calls: dict = {}
        self._restore: list = []

    def wrap(self, name, work):
        from repro_torch.kernels import wrapper_module
        mod = wrapper_module(name)
        orig = getattr(mod, name)

        def recorder(*args, **kw):
            w = work(*args, **kw)
            if name not in self.calls or w >= self.calls[name][0]:
                self.calls[name] = (w, args, kw)
            return orig(*args, **kw)
        setattr(mod, name, recorder)
        self._restore.append((mod, name, orig))

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
    cap.wrap("logreg_grad", lambda x, y, w: x.numel())
    cap.wrap("batched_hop",
             lambda *a, capacity, chunk: a[3].shape[0] * capacity)
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
    missing = [k for k, v in launches.items() if v == 0]
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
    return launches, cap.calls


# ---------------------------------------------------------------------------
# Kernels at the main path's inputs: agreement, times, bounds
# ---------------------------------------------------------------------------


def kernel_report(launches: dict, calls: dict) -> list:
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
    from repro_torch.kernels.logreg.ref import logreg_grad_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.traversal.ref import batched_hop_ref

    rows = []
    for name in KERNELS:
        if name not in calls:
            raise AssertionError(f"{name}: no main-path call was captured")
        _, args, kw = calls[name]
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
            err = max(assert_close("logreg grad (main path)", g1, g2,
                                   *TOL["logreg_grad"]),
                      assert_close("logreg loss (main path)", l1, l2,
                                   *TOL["logreg_grad"]))
            plain = lambda: logreg_grad_ref(x, y, w)               # noqa: E731
            shape = f"{n}x{d}"
        else:
            rp, ci, ei, fr, fm, mem, ep, ca = args
            capacity, B, C = kw["capacity"], fr.shape[0], fr.shape[1]
            frl = fr.long()
            deg = torch.where(fm, rp[frl + 1] - rp[frl], 0)
            n_cand = int(torch.clamp(deg.sum(1), max=capacity).sum())
            n_front = int(fm.sum())
            # outputs + frontier/mask + row_ptr pairs + per-candidate gathers
            nbytes = (12 * capacity * B + 4 * B + 5 * C * B + 8 * n_front
                      + 11 * n_cand)
            b = (nbytes / PEAK_BYTES_S * 1e3, "bytes")
            got, want = kernel(*args, **kw), batched_hop_ref(*args, **kw)
            err = max(assert_equal(f"batched_hop (main path) out{i}", a, w_)
                      for i, (a, w_) in enumerate(zip(got, want)))
            plain = lambda: batched_hop_ref(*args, **kw)           # noqa: E731
            shape = (f"B={B} C={C} capacity={capacity} frontier={n_front} "
                     f"candidates={n_cand}")
        ms, host_ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(plain)[0]
        say(f"{name} at {shape}: kernel {ms:.4f} ms (host issue "
            f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]}), library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"max |err| {err:.3g}")
        rows.append({"name": name, "route": "cuda",
                     "source": KERNELS[name].source,
                     "replaces": KERNELS[name].replaces,
                     "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "host_ms": host_ms,
                     "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": library_ms, "shape": shape})
    return rows


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
    launches, calls = phase_main()
    rows = kernel_report(launches, calls)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
