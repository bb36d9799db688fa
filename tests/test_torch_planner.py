"""Twin of ``tests/test_planner.py``: the port's planner makes the same
plans as the JAX package's (the whole ``GCDIPlan``/``PatternPlan`` value:
direction, pushed and deferred predicates, trimming, replication notes,
join-pushdown candidates, estimated costs), and its optimizations preserve
semantics on the same random databases, with the same results as the
reference's."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from torch_twin import PKGS, PORT, both, rows_multiset


@st.composite
def random_db_and_query(draw):
    """The reference's strategy, drawn once and built in either package."""
    seed = draw(st.integers(0, 99_999))
    sizes = (draw(st.integers(3, 10)), draw(st.integers(2, 6)),
             draw(st.integers(2, 25)), draw(st.integers(2, 8)))
    preds = []
    if draw(st.booleans()):
        preds.append(("t.b", "==", draw(st.integers(0, 2))))
    if draw(st.booleans()):
        preds.append(("p.a", "!=", draw(st.integers(0, 2))))
    if draw(st.booleans()):
        preds.append(("e0.w", "range", 2, 8))
    if draw(st.booleans()):
        preds.append(("C.v", "==", draw(st.integers(0, 4))))
    return seed, sizes, preds


def build(P, seed, sizes, preds):
    S, Q = P.storage, P.schema
    rng = np.random.default_rng(seed)
    n_p, n_t, n_e, n_c = sizes
    db = S.Database()
    persons = S.Table("P", {"pid": np.arange(n_p), "a": rng.integers(0, 3, n_p)})
    tags = S.Table("T", {"tid": np.arange(n_t), "b": rng.integers(0, 3, n_t)})
    edges = S.Table("E", {"svid": rng.integers(0, n_p, n_e),
                          "tvid": rng.integers(0, n_t, n_e),
                          "w": rng.integers(0, 10, n_e)})
    db.add_graph(S.Graph("G", {"P": persons, "T": tags}, edges, "P", "T"))
    db.add_table(S.Table("C", {"id": np.arange(n_c),
                               "person_id": rng.integers(0, n_p, n_c),
                               "v": rng.integers(0, 5, n_c)}))
    pat = Q.chain_pattern("G", ("p", "P", "E", "t", "T"))
    q = Q.Query(select=("C.id", "t.tid"), froms=("C",), match=pat,
                joins=(Q.JoinPred("C.person_id", "p.pid"),),
                where=tuple(Q.Predicate(*p) for p in preds))
    return db, q


def _optimized_vs_raw(P, seed, sizes, preds):
    db, q = build(P, seed, sizes, preds)
    p_opt = P.planner.plan(db, q, enable_opt=True)
    p_raw = P.planner.plan(db, q, enable_opt=False,
                           enable_pattern_pushdown=False)
    opt = rows_multiset(P.planner.execute(db, p_opt))
    raw = rows_multiset(P.planner.execute(db, p_raw))
    assert opt == raw
    return repr(p_opt), repr(p_raw), opt


@given(random_db_and_query())
@settings(max_examples=30, deadline=None)
def test_optimizations_preserve_semantics(drawn):
    ref, port = both(_optimized_vs_raw, *drawn)
    assert port == ref


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1) for P in PKGS}


def _plan_pattern(P, db, phi):
    g = db.graphs["Interested_in"]
    pat = P.schema.chain_pattern("Interested_in",
                                 ("p", "Persons", "E", "t", "Tags"))
    phi = {v: [P.schema.Predicate(*p) for p in ps] for v, ps in phi.items()}
    return P.pattern.plan_pattern(g, pat, phi, projected={"p", "t"})


def test_direction_rule_fig6(dbs):
    """Fig. 6(a)/(b): traversal starts from the predicate side."""
    ref, port = both(lambda P: [repr(_plan_pattern(P, dbs[P.name], phi))
                                for phi in (
        {"t": [("t.content", "==", "food")]},
        {"p": [("p.country", "==", "cn")]})])
    assert port == ref
    rev = _plan_pattern(PORT, dbs[PORT.name],
                        {"t": [("t.content", "==", "food")]})
    assert rev.reverse and "t" in rev.pushed
    fwd = _plan_pattern(PORT, dbs[PORT.name],
                        {"p": [("p.country", "==", "cn")]})
    assert not fwd.reverse and "p" in fwd.pushed


def test_inequality_deferred(dbs):
    """Fig. 6 end-vertex rule: '!=' predicates are never pushed down."""
    phi = {"p": [("p.pid", "==", 5)], "t": [("t.content", "!=", "food")]}
    ref, port = both(lambda P: _plan_pattern(P, dbs[P.name], phi))
    assert repr(port) == repr(ref)
    assert not port.reverse
    assert port.deferred.get("t"), "end-vertex inequality must be deferred"


def _plans(P, db, qnames, **kw):
    return {q: P.planner.plan(db, getattr(P.m2bench, q)(), **kw)
            for q in qnames}


def test_match_trimming_cases(dbs):
    qs = ("q_vertex_scan", "q_edge_scan", "q_g1")
    ref, port = both(lambda P: _plans(P, dbs[P.name], qs))
    assert {q: repr(p) for q, p in port.items()} == \
        {q: repr(p) for q, p in ref.items()}
    assert port["q_vertex_scan"].match_trim == "vertex_scan"
    assert port["q_edge_scan"].match_trim == "edge_scan"
    assert port["q_g1"].match_trim is None


def test_projection_trimming(dbs):
    ref, port = both(lambda P: _plans(P, dbs[P.name], ("q_g1",))["q_g1"])
    assert port.explain() == ref.explain()
    assert port.graph_projection == {"p", "t"}


def test_predicate_replication_across_join():
    """Mechanism 1b: equality predicate on C.person_id replicates to p.pid."""
    def scenario(P):
        Q = P.schema
        db = P.m2bench.generate(sf=1)
        pat = Q.chain_pattern("Interested_in",
                              ("p", "Persons", "E", "t", "Tags"))
        q = Q.Query(select=("C.id", "t.tid"), froms=("C",), match=pat,
                    joins=(Q.JoinPred("C.person_id", "p.pid"),),
                    where=(Q.Predicate("C.person_id", "==", 5),))
        db.tables["C"] = db.tables["Customer"]
        return P.planner.plan(db, q)
    ref, port = both(scenario)
    assert repr(port) == repr(ref)
    assert any("replicated" in n for n in port.notes)
    assert any(pr.attr == "p.pid" for pr in
               port.pattern_plan.pushed.get("p", []) +
               port.pattern_plan.deferred.get("p", []))


def test_join_pushdown_candidates_detected(dbs):
    ref, port = both(lambda P: (
        _plans(P, dbs[P.name], ("q_g4",))["q_g4"],
        _plans(P, dbs[P.name], ("q_g4",), enable_opt=False)["q_g4"]))
    assert [repr(p) for p in port] == [repr(p) for p in ref]
    p, p_raw = port
    assert p.semi_join_idx == {2}
    assert any("join-pushdown candidate" in n for n in p.notes)
    assert p_raw.semi_join_idx == set()
