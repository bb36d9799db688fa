"""Plan-verification sweep: statically verify every m2bench query and GCDIA
task across {gredo, dual, single} × shards ∈ {1, 4} × device lowering
on/off — the gate that no plan-mutating layer (optimizer, shard rewriter,
device lowering) emits an ill-typed DAG.

Every combination runs ``GredoEngine.verify`` (naive build → optimizer →
shard rewrite, schema-checked at each stage plus cross-stage V-SIG/V-EQ
checks; see ``repro_torch.core.verify``). ERROR-severity violations fail the
sweep; WARNs (silent float32 promotions at the matrix boundary, runtime
fallbacks) are tallied in the report. Results land in
``build/repro_torch/verify_sweep.json``.

The engines run on the CUDA card unless ``device`` names another device
(``--device cpu``); without a card and without ``--device`` the sweep
raises, as ``GredoEngine`` does. Verification builds and checks plans only:
nothing is executed on the device.

Notes on coverage:

* ``cost.SHARD_MIN_ROWS`` is forced to 0 for the shards=4 leg — at sweep
  scale the cost gate would otherwise always choose serial plans and the
  shard invariants (V-SHARD) would never be exercised.
* ``a1_regression`` is excluded: its task spec has a single ``random``
  input and ``physical.build_gcdia`` rejects REGRESSION with fewer than two
  matrices at build time (A1 is driven through ``analytics.regression``
  with external labels) — there is no plan to verify.

CLI::

    python -m repro_torch.analysis.verify_sweep [--sf N] [--out FILE]
        [--device DEV]

Exit status 1 when any combination has ERROR-severity violations.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from ..core import cost, optimizer
from ..core.engine import GredoEngine
from ..data import m2bench

MODES = ("gredo", "dual", "single")
SHARD_COUNTS = (1, 4)
DEVICE = (True, False)
DEFAULT_OUT = Path("build/repro_torch/verify_sweep.json")


def _registry(sf: int):
    """(label, db, query-or-task) combinations of the sweep. Index-backed
    access paths are part of plan space, so the main db gets its secondary
    indexes before planning."""
    db = m2bench.generate(sf=sf)
    m2bench.build_indexes(db)
    pid, oid = m2bench.point_lookup_keys(db)
    skew = m2bench.generate_skew(sf=sf)
    entries = [
        ("q_g1", db, m2bench.q_g1()),
        ("q_g2", db, m2bench.q_g2()),
        ("q_g3", db, m2bench.q_g3()),
        ("q_g4", db, m2bench.q_g4()),
        ("q_g5", db, m2bench.q_g5()),
        ("q_edge_scan", db, m2bench.q_edge_scan()),
        ("q_vertex_scan", db, m2bench.q_vertex_scan()),
        ("q_opt_skew", db, m2bench.q_opt_skew()),
        ("q_point_lookup", db, m2bench.q_point_lookup(pid, oid)),
        ("q_range_narrow", db, m2bench.q_range_narrow()),
        ("q_shard_join", db, m2bench.q_shard_join()),
        ("q_skew_3join", skew, m2bench.q_skew_3join()),
        ("q_bushy_4src", skew, m2bench.q_bushy_4src()),
        # a1_regression excluded: single-input REGRESSION never builds a DAG
        ("a2_similarity", db, m2bench.a2_similarity()),
        ("a3_multiply", db, m2bench.a3_multiply()),
        ("a_shard_reg", db, m2bench.a_shard_reg()),
    ]
    return entries


def run_sweep(sf: int = 1, device=None) -> dict:
    rows = []
    n_err = n_warn = 0
    shard_floor = cost.SHARD_MIN_ROWS
    device_flag = optimizer.DEVICE_MATCH
    try:
        for label, db, q in _registry(sf):
            for mode in MODES:
                for k in SHARD_COUNTS:
                    # sweep scale is tiny; drop the serial-execution cost
                    # floor so k=4 actually exercises the shard rewriter
                    cost.SHARD_MIN_ROWS = 0 if k > 1 else shard_floor
                    for lower in DEVICE:
                        optimizer.DEVICE_MATCH = lower
                        eng = GredoEngine(db, mode=mode, n_shards=k,
                                          device=device)
                        report = eng.verify(q)
                        n_err += len(report.errors)
                        n_warn += len(report.warnings)
                        rows.append({
                            "query": label, "mode": mode, "shards": k,
                            "device": lower, "ok": report.ok,
                            "errors": [v.render() for v in report.errors],
                            "warnings": [v.render() for v in report.warnings],
                        })
    finally:
        cost.SHARD_MIN_ROWS = shard_floor
        optimizer.DEVICE_MATCH = device_flag
    failed = [r for r in rows if not r["ok"]]
    return {"combinations": len(rows), "failed": len(failed),
            "errors": n_err, "warnings": n_warn, "rows": rows}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    sf, out, device = 1, DEFAULT_OUT, None
    if "--sf" in args:
        i = args.index("--sf")
        sf = int(args[i + 1])
    if "--out" in args:
        i = args.index("--out")
        out = Path(args[i + 1])
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
    doc = run_sweep(sf=sf, device=device)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    for r in doc["rows"]:
        if not r["ok"]:
            head = f"{r['query']} mode={r['mode']} k={r['shards']} " \
                   f"device={r['device']}:"
            print(head)
            for line in r["errors"]:
                print(f"  {line}")
    print(f"verify sweep: {doc['combinations']} plan combinations, "
          f"{doc['failed']} failed, {doc['errors']} error(s), "
          f"{doc['warnings']} warning(s) -> {out}")
    return 1 if doc["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
