"""Twin of ``tests/test_verify.py`` and of the plan-verification sweep: every
golden broken DAG, pinning regression, engine integration and the
mutation-stream property run through both packages' verifiers
(``repro.core.verify`` and ``repro_torch.core.verify``) and must report the
same violations (rule, severity, node, message) — and the reference's own
expectation holds on the port. ``repro_torch.analysis.verify_sweep`` at
sf=1 on the CPU gives the reference sweep's rows one for one, and without
``device`` and without a card it raises."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch_twin import PKGS, PORT, REF, both

MODES = ("gredo", "dual", "single")


def mini_db(P):
    S = P.storage
    db = S.Database()
    db.add_table(S.Table("T", {
        "a": np.arange(8, dtype=np.int64),
        "f": np.linspace(0.0, 1.0, 8),
        "s": S.DictColumn(["x", "y"] * 4),
        "r": S.RaggedColumn([[1, 2], [3]] * 4),
    }))
    db.add_table(S.Table("U", {
        "k": np.arange(8, dtype=np.int64),
        "s": S.DictColumn(["x", "z"] * 4),
    }))
    return db


def scan(P, db, name):
    return P.physical.ScanTable(name, db.epoch_of(name))


def violations(report) -> list:
    return [(v.rule, v.severity, v.node, v.message) for v in report.violations]


def rules_of(report, severity=None) -> set:
    return {v.rule for v in report.violations
            if severity is None or v.severity == severity}


# ---------------------------------------------------------------------------
# golden broken-DAG fixtures: (P) -> (report, rule, severity, ok)
# ---------------------------------------------------------------------------


def _select_unresolved(P):
    db = mini_db(P)
    bad = P.physical.Select(scan(P, db, "T"),
                            [P.schema.Predicate("T.zzz", "==", 1)])
    return P.verify.verify_plan(bad, db), "V-COL", "ERROR", False


def _select_unqualified(P):
    db = mini_db(P)
    bad = P.physical.Select(scan(P, db, "T"),
                            [P.schema.Predicate("a", "==", 1)])
    return P.verify.verify_plan(bad, db), "V-COL", "ERROR", False


def _select_clean(P):
    db = mini_db(P)
    good = P.physical.Select(scan(P, db, "T"),
                             [P.schema.Predicate("T.a", "==", 1)])
    return P.verify.verify_plan(good, db), None, None, True


def _join_str_vs_int(P):
    db = mini_db(P)
    bad = P.physical.EquiJoin(P.schema.JoinPred("T.a", "U.s"),
                              scan(P, db, "T"), scan(P, db, "U"))
    return P.verify.verify_plan(bad, db), "V-TYPE", "ERROR", False


def _join_int_vs_float(P):
    db = mini_db(P)
    join = P.physical.EquiJoin(P.schema.JoinPred("T.f", "U.k"),
                               scan(P, db, "T"), scan(P, db, "U"))
    return P.verify.verify_plan(join, db), "V-TYPE", "WARN", True


def _ragged_feature(P):
    db = mini_db(P)
    bad = P.physical.Rel2Matrix(["r"], scan(P, db, "T"))
    return P.verify.verify_plan(bad, db), "V-GCDA", "ERROR", False


def _int_feature_promotion(P):
    db = mini_db(P)
    m = P.physical.Rel2Matrix(["a"], scan(P, db, "T"))
    return P.verify.verify_plan(m, db), "V-GCDA", "WARN", True


def _regression_label_width(P):
    x = P.physical.Const(np.ones((4, 3), dtype=np.float32))
    y = P.physical.Const(np.ones((4, 2), dtype=np.float32))
    bad = P.physical.Regression(3, False, x, y)
    return (P.verify.verify_plan(bad, P.storage.Database()), "V-GCDA",
            "ERROR", False)


def _similarity_width(P):
    a = P.physical.Const(np.ones((4, 3), dtype=np.float32))
    b = P.physical.Const(np.ones((4, 5), dtype=np.float32))
    return (P.verify.verify_plan(P.physical.Similarity(False, a, b),
                                 P.storage.Database()),
            "V-GCDA", "ERROR", False)


def _stale_scan_epoch(P):
    db = mini_db(P)
    node = scan(P, db, "T")
    db.touch_table("T")
    return P.verify.verify_plan(node, db), "V-EPOCH", "ERROR", False


def _project_vector_misses_source(P):
    db = mini_db(P)
    join = P.physical.EquiJoin(P.schema.JoinPred("T.a", "U.k"),
                               scan(P, db, "T"), scan(P, db, "U"))
    ok = P.physical.Project(["T.a"], (("T", db.epoch_of("T")),
                                      ("U", db.epoch_of("U"))), join)
    assert P.verify.verify_plan(ok, db).ok
    bad = P.physical.Project(["T.a"], (("T", db.epoch_of("T")),), join)
    return P.verify.verify_plan(bad, db), "V-EPOCH", "ERROR", False


def _project_vector_unknown(P):
    db = mini_db(P)
    bad = P.physical.Project(["T.a"], (("T", db.epoch_of("T")),
                                       ("Ghost", 0)), scan(P, db, "T"))
    return P.verify.verify_plan(bad, db), "V-EPOCH", "ERROR", False


def _two_label_graph_db(P):
    S = P.storage
    db = S.Database()
    ta = S.Table("A", {"v": np.arange(4, dtype=np.int64)})
    tb = S.Table("B", {"v": S.DictColumn(["x", "y", "z", "w"])})
    edges = S.Table("G_edges", {"svid": np.array([0, 1], dtype=np.int64),
                                "tvid": np.array([0, 1], dtype=np.int64)})
    db.add_table(S.Table("X", {"x": np.arange(3, dtype=np.int64)}))
    db.add_graph(S.Graph("G", {"A": ta, "B": tb}, edges, "A", "B"))
    return db


def _signature_collision(P):
    db = _two_label_graph_db(P)
    child = scan(P, db, "X")
    gep = db.epoch_of("G")
    pat_a = P.schema.Pattern("G", (P.schema.PatternVertex("x", "A"),), ())
    pat_b = P.schema.Pattern("G", (P.schema.PatternVertex("x", "B"),), ())
    gp_a = P.physical.GraphProject("G", gep, pat_a, ("x",), {"x": ["v"]},
                                   child)
    gp_b = P.physical.GraphProject("G", gep, pat_b, ("x",), {"x": ["v"]},
                                   child)
    assert gp_a.signature() == gp_b.signature()
    report, sigs = P.verify.VerifyReport(), {}
    P.verify.verify_plan(gp_a, db, report, sigs)
    assert report.ok
    P.verify.verify_plan(gp_b, db, report, sigs)
    return report, "V-SIG", "ERROR", False


def _inplace_column_swap(P):
    db = mini_db(P)
    report, sigs = P.verify.VerifyReport(), {}
    P.verify.verify_plan(scan(P, db, "T"), db, report, sigs)
    db.tables["T"].columns["a"] = np.linspace(0.0, 1.0, 8)
    P.verify.verify_plan(scan(P, db, "T"), db, report, sigs)
    return report, "V-SIG", "ERROR", False


def _sharded_join(P, exchange_key):
    db = mini_db(P)
    right = scan(P, db, "U")
    if exchange_key is not None:
        right = P.physical.Exchange(right, key=exchange_key, k=2)
    join = P.physical.EquiJoin(P.schema.JoinPred("T.a", "U.k"),
                               scan(P, db, "T"), right)
    join.shards = 2
    return P.verify.verify_plan(join, db)


def _join_without_exchange(P):
    return _sharded_join(P, None), "V-SHARD", "ERROR", False


def _misaligned_exchange(P):
    return _sharded_join(P, "U.s"), "V-SHARD", "ERROR", False


def _aligned_exchange(P):
    return _sharded_join(P, "U.k"), None, None, True


def _stamp_on_scan(P):
    db = mini_db(P)
    node = scan(P, db, "T")
    node.shards = 2
    return P.verify.verify_plan(node, db), "V-SHARD", "ERROR", False


def _exchange_outside_build(P):
    db = mini_db(P)
    ex = P.physical.Exchange(scan(P, db, "T"), key="T.a", k=2)
    return P.verify.verify_plan(ex, db), "V-SHARD", "ERROR", False


def _stale_annotation(P):
    db = mini_db(P)
    node = scan(P, db, "T")
    node.out_cols = frozenset({"a", "ghost"})
    return P.verify.verify_plan(node, db), "V-ANN", "WARN", True


def _retyped_root(P):
    db = mini_db(P)
    assert P.verify.verify_equivalence(scan(P, db, "T"), scan(P, db, "T"),
                                       db).ok
    rewritten = P.physical.PruneCols(scan(P, db, "T"), ["a", "f"])
    return (P.verify.verify_equivalence(scan(P, db, "T"), rewritten, db),
            "V-EQ", "ERROR", False)


GOLDEN = {f.__name__.lstrip("_"): f for f in (
    _select_unresolved, _select_unqualified, _select_clean,
    _join_str_vs_int, _join_int_vs_float, _ragged_feature,
    _int_feature_promotion, _regression_label_width, _similarity_width,
    _stale_scan_epoch, _project_vector_misses_source,
    _project_vector_unknown, _signature_collision, _inplace_column_swap,
    _join_without_exchange, _misaligned_exchange, _aligned_exchange,
    _stamp_on_scan, _exchange_outside_build, _stale_annotation,
    _retyped_root)}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_broken_dag(case):
    (r_rep, *_), (t_rep, rule, severity, ok) = both(GOLDEN[case])
    assert violations(t_rep) == violations(r_rep)
    assert t_rep.ok is ok
    if rule is None:
        assert not t_rep.violations
    else:
        assert rule in rules_of(t_rep, getattr(PORT.verify, severity))


# ---------------------------------------------------------------------------
# device-lowered nodes, pinning regressions, engine integration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def m2dbs():
    out = {}
    for P in PKGS:
        db = P.m2bench.generate(sf=1)
        P.m2bench.build_indexes(db)
        out[P.name] = db
    return out


def _device_node(P, db):
    """A DeviceMatchPattern as the optimizer lowers it (q_g3 at sf=1)."""
    flag = P.optimizer.DEVICE_MATCH
    P.optimizer.DEVICE_MATCH = True
    try:
        eng = P.Engine(db)
        naive = eng.physical_plan(P.m2bench.q_g3())
        dag, _ = P.optimizer.optimize(naive, db, cache=eng._opt_cache)
    finally:
        P.optimizer.DEVICE_MATCH = flag
    for n in P.verify._walk(dag):
        if n.kind == "DeviceMatchPattern":
            return n
    return None


def _device_cases(P, db):
    node = _device_node(P, db)
    assert node is not None, "q_g3 no longer device-lowers at sf=1"
    ph = P.physical
    starved = ph.DeviceMatchPattern(node.graph, node.epoch, node.pplan,
                                    access=node.access, capacity=8)
    masked = ph.DeviceMatchPattern(node.graph, node.epoch, node.pplan,
                                   access=node.access, capacity=node.capacity)
    masked.children = (ph.SemiJoinMask(node.graph, node.epoch, "Persons",
                                       "p", "Persons.id",
                                       scan(P, db, "Persons")),)
    g = db.graphs[node.graph]
    return {"node": (node.describe(), node.capacity),
            "lowered": violations(P.verify.verify_plan(node, db)),
            "starved": violations(P.verify.verify_plan(starved, db)),
            "masked": violations(P.verify.verify_plan(masked, db)),
            "capacity_bound": cost_capacity(P, g, node)}


def cost_capacity(P, g, node):
    return P.cost.padded_capacity(P.cost.device_frontier_peak(g, node.pplan))


def test_device_node_rules(m2dbs):
    """V-DEV: a capacity below the frontier bound and mask children are
    rejected; the lowered node itself passes; optimizer and verifier derive
    the same capacity."""
    ref, port = both(lambda P: _device_cases(P, m2dbs[P.name]))
    assert port == ref
    assert port["lowered"] == []
    assert any(v[0] == "V-DEV" and v[1] == "ERROR" for v in port["starved"])
    assert any(v[0] == "V-DEV" and v[1] == "ERROR" for v in port["masked"])
    assert port["node"][1] == port["capacity_bound"]


def test_device_lowering_embeds_catalog_epoch_after_graph_replacement():
    def scenario(P):
        db = P.m2bench.generate(sf=1)
        P.m2bench.build_indexes(db)
        node = _device_node(P, db)
        g = db.graphs[node.graph]
        db.add_graph(g)                     # re-register: lineage +1
        assert db.epoch_of(node.graph) != g.epoch
        node = _device_node(P, db)
        assert node.epoch == db.epoch_of(node.graph)
        stale = P.physical.DeviceMatchPattern(
            node.graph, db.graphs[node.graph].epoch, node.pplan,
            access=node.access, capacity=node.capacity)
        return (node.epoch, violations(P.verify.verify_plan(node, db)),
                violations(P.verify.verify_plan(stale, db)))
    ref, port = both(scenario)
    assert port == ref
    assert port[1] == []
    assert any(v[:2] == ("V-EPOCH", "ERROR") for v in port[2])


def test_prune_columns_refreshes_out_cols_annotation(m2dbs):
    def scenario(P):
        eng = P.Engine(m2dbs[P.name])
        out = []
        for q in (P.m2bench.q_g1(), P.m2bench.q_g3(), P.m2bench.q_opt_skew()):
            report = eng.verify(q)
            assert report.ok and not report.by_rule("V-ANN")
            out.append(violations(report))
        return out
    ref, port = both(scenario)
    assert port == ref


def test_engine_verify_all_modes_and_shards(m2dbs):
    def scenario(P):
        db = m2dbs[P.name]
        floor = P.cost.SHARD_MIN_ROWS
        out = []
        try:
            for q in (P.m2bench.q_g2(), P.m2bench.q_g3(),
                      P.m2bench.q_shard_join()):
                for mode in MODES:
                    for k in (1, 4):
                        P.cost.SHARD_MIN_ROWS = 0 if k > 1 else floor
                        report = P.Engine(db, mode=mode,
                                          n_shards=k).verify(q)
                        assert report.ok, report.render()
                        out.append(violations(report))
        finally:
            P.cost.SHARD_MIN_ROWS = floor
        return out
    ref, port = both(scenario)
    assert port == ref


def test_gcda_verify_flags_promotions_only(m2dbs):
    ref, port = both(lambda P: P.Engine(m2dbs[P.name]).verify(
        P.m2bench.a_shard_reg()))
    assert violations(port) == violations(ref)
    assert port.ok and rules_of(port) == {"V-GCDA"}


def test_debug_engine_verifies_and_matches_plain_results(m2dbs):
    def scenario(P):
        db = m2dbs[P.name]
        q = P.m2bench.q_g3()
        plain = P.Engine(db).query(q)
        eng = P.Engine(db, debug=True)
        dbg = eng.query(q)
        assert eng.last_verify is not None and eng.last_verify.ok
        assert "== verify ==" in eng.explain_last()
        return (P.fingerprint(plain), P.fingerprint(dbg),
                violations(eng.last_verify))
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == port[1]


def test_debug_engine_raises_on_broken_catalog():
    def scenario(P):
        db = P.m2bench.generate(sf=1)
        eng = P.Engine(db, debug=True)
        q = P.m2bench.q_shard_join()
        eng.query(q)
        t = db.tables["Orders"]
        t.columns["customer_id"] = P.storage.DictColumn(
            ["c"] * len(np.asarray(t.columns["quantity"])))
        with pytest.raises(P.verify.PlanVerificationError) as ei:
            eng.query(q)
        return [v.render() for v in ei.value.report.errors]
    ref, port = both(scenario)
    assert port == ref
    assert any(r.startswith(("verify:V-TYPE", "verify:V-SIG")) for r in port)


def test_explain_carries_verify_lines(m2dbs):
    ref, port = both(lambda P: P.Engine(m2dbs[P.name], debug=True).explain(
        P.m2bench.q_g3()))
    assert port == ref
    assert "== verify ==" in port and "verify:" in port


# ---------------------------------------------------------------------------
# property: rewrites preserve schemas under random mutation streams, alike
# in both packages
# ---------------------------------------------------------------------------

_PROP = {}


def _prop_dbs() -> dict:
    if not _PROP:
        _PROP.update({P.name: P.m2bench.generate(sf=1) for P in PKGS})
    return _PROP


def _mutate_and_verify(P, db, ops, seed, qname, mode, shards):
    rng = np.random.default_rng(seed)
    g = db.graphs["Interested_in"]
    for op in ops:
        if op == "edges":
            m = int(rng.integers(1, 30))
            g.insert_edges({
                "svid": rng.integers(0, 100, m).astype(np.int64),
                "tvid": rng.integers(0, P.m2bench.N_TAGS, m).astype(np.int64),
                "weight": rng.uniform(0.0, 1.0, m),
            })
        elif op == "tombstone":
            live = g.live_edge_ids()
            m = min(int(rng.integers(1, 20)), len(live))
            if m:
                g.delete_edges(rng.choice(live, m, replace=False))
        elif op == "compact":
            g.compact()
        elif op == "touch":
            db.touch_table("Orders")
    q = getattr(P.m2bench, qname)()
    floor = P.cost.SHARD_MIN_ROWS
    P.cost.SHARD_MIN_ROWS = 0 if shards > 1 else floor
    try:
        report = P.Engine(db, mode=mode, n_shards=shards).verify(q)
    finally:
        P.cost.SHARD_MIN_ROWS = floor
    assert report.ok, report.render()
    assert not report.by_rule("V-EQ") and not report.by_rule("V-SIG")
    return violations(report), db.epoch_of("Interested_in")


@st.composite
def _mutation_ops(draw):
    n = draw(st.integers(min_value=1, max_value=4))
    return [draw(st.sampled_from(["edges", "tombstone", "compact", "touch"]))
            for _ in range(n)]


@settings(max_examples=8, deadline=None)
@given(
    ops=_mutation_ops(),
    seed=st.integers(min_value=0, max_value=2**16),
    qname=st.sampled_from(["q_g2", "q_g3", "q_shard_join", "q_opt_skew"]),
    mode=st.sampled_from(MODES),
    shards=st.sampled_from([1, 4]),
)
def test_rewrites_preserve_schemas_under_mutation(ops, seed, qname, mode,
                                                 shards):
    dbs = _prop_dbs()
    ref, port = both(lambda P: _mutate_and_verify(
        P, dbs[P.name], ops, seed, qname, mode, shards))
    assert port == ref


# ---------------------------------------------------------------------------
# the plan-verification sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_sweep(tmp_path_factory):
    """The port's sweep CLI on the CPU: (exit status, output, JSON doc)."""
    import contextlib
    import io
    import json
    from repro_torch.analysis import verify_sweep
    out = tmp_path_factory.mktemp("sweep") / "sweep.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = verify_sweep.main(["--device", "cpu", "--sf", "1",
                                "--out", str(out)])
    return rc, buf.getvalue(), json.loads(out.read_text())


def test_sweep_matches_reference_row_for_row(port_sweep):
    from repro.analysis import verify_sweep as ref_sweep
    rc, _, port = port_sweep
    ref = ref_sweep.run_sweep(sf=1)
    assert rc == 0
    assert (port["combinations"], port["failed"], port["errors"]) == \
        (192, 0, 0)
    assert port["warnings"] == ref["warnings"]
    assert port["rows"] == ref["rows"]
    # the module flags it flips are restored
    assert PORT.optimizer.DEVICE_MATCH is True
    assert PORT.cost.SHARD_MIN_ROWS == REF.cost.SHARD_MIN_ROWS


def test_sweep_cli_reports_and_defaults_under_build(port_sweep):
    from repro_torch.analysis import verify_sweep
    assert verify_sweep.DEFAULT_OUT.as_posix() == \
        "build/repro_torch/verify_sweep.json"
    assert "verify sweep: 192 plan combinations, 0 failed, 0 error(s)" in \
        port_sweep[1]


def test_sweep_needs_a_card_or_an_explicit_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch.analysis import verify_sweep
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_sweep.main(["--out", str(tmp_path / "sweep.json")])
    assert not (tmp_path / "sweep.json").exists()
