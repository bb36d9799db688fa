"""Twin of ``tests/test_sqlpgq.py``: the port's SQL/PGQ surface
(``repro_torch.core.sqlpgq``) parses the same texts to the same ASTs as the
JAX package's, the parsed queries run on both engines to identical results,
the workload's text forms equal the port's ``m2bench`` builders, and both
parsers refuse the same malformed inputs."""
import dataclasses

import numpy as np
import pytest
from torch_twin import PORT, REF, both

from repro_torch.core.schema import JoinPred, Predicate
from repro_torch.core.sqlpgq import parse
from repro_torch.data import m2bench

# The workload's text forms; each parses to the builder of the same name.
TEXTS = {
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

RUNNING_EXAMPLE = """
    SELECT Customer.id, t.tid
    FROM Customer
    MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in
    WHERE t.content = 'food' AND Customer.person_id = p.pid
"""
TWO_HOP = """
    SELECT a.pid, c.pid
    MATCH (a:Persons)-[e0:Follows]->(b:Persons)-[e1:Follows]->(c:Persons)
          ON Follows
    WHERE a.country = 'au' AND c.country = 'uk'
"""
BETWEEN_IN = """
    SELECT e0.weight
    MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in
    WHERE e0.weight BETWEEN 0.25 AND 0.75 AND t.tid IN (1, 2, 3)
"""

# every comparison operator and literal kind, for the field-by-field check
COMPARISONS = (
    "SELECT p.pid, t.tid, e0.weight FROM Customer "
    "MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) "
    "WHERE p.country = 'cn' AND p.country <> 'uk' AND p.country != 'au' "
    "AND e0.weight < 0.75 AND e0.weight <= 0.5 AND e0.weight > -0.5 "
    "AND t.tid >= -3 AND t.tid IN (1, 2.5, 'x') "
    "AND e0.weight BETWEEN 0 AND 1 AND Customer.person_id = p.pid")
ALIKE = {**TEXTS, "running_example": RUNNING_EXAMPLE, "two_hop": TWO_HOP,
         "between_in": BETWEEN_IN, "comparisons": COMPARISONS}

MALFORMED = {
    "bad_token": "SELECT x WHERE a.b ~ 3",
    "non_equality_join": "SELECT a.b WHERE a.b < c.d",
    "trailing_input": "SELECT a.b FROM T extra",
    "missing_select": "FROM Customer",
    "select_list_ends_in_comma": "SELECT a.b, FROM T",
    "unclosed_vertex": "SELECT p.pid MATCH (p:Persons",
    "edge_without_arrow": "SELECT p.pid MATCH (p:P)-[e:E]-(q:P)",
    "in_list_not_closed": "SELECT a.b WHERE a.b IN (1, 2",
    "between_without_and": "SELECT a.b WHERE a.b BETWEEN 1 2",
    "literal_expected": "SELECT a.b WHERE a.b = (",
}


@pytest.fixture(scope="module")
def engines():
    return {P.name: P.Engine(P.m2bench.generate(sf=1, seed=7))
            for P in (REF, PORT)}


def _as_tree(node):
    """An AST as nested plain values (type name and fields), so the two
    packages' dataclasses compare field for field."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                tuple((f.name, _as_tree(getattr(node, f.name)))
                      for f in dataclasses.fields(node)))
    if isinstance(node, (tuple, list)):
        return tuple(_as_tree(v) for v in node)
    return (type(node).__name__, node)


def _run(P, engines, text, builder=None):
    eng = engines[P.name]
    r = eng.query(P.sqlpgq.parse(text))
    out = {"fingerprint": P.fingerprint(r), "nrows": r.nrows,
           "rewrites": list(eng.last_stats.rewrites),
           "explain": eng.explain(P.sqlpgq.parse(text))}
    if builder is not None:
        rb = eng.query(getattr(P.m2bench, builder)())
        out["builder_fingerprint"] = P.fingerprint(rb)
    return out


def test_parse_running_example(engines):
    """The paper's Fig. 1(a) query, as text."""
    q = parse(RUNNING_EXAMPLE)
    assert q.select == ("Customer.id", "t.tid")
    assert q.froms == ("Customer",)
    assert q.match.graph == "Interested_in"
    assert q.joins == (JoinPred("Customer.person_id", "p.pid"),)
    assert q.where == (Predicate("t.content", "==", "food"),)
    ref, port = both(_run, engines, RUNNING_EXAMPLE, "q_g1")
    assert port == ref
    assert port["fingerprint"] == port["builder_fingerprint"]


def test_parse_two_hop_and_ranges(engines):
    assert len(parse(TWO_HOP).match.edges) == 2
    ref, port = both(_run, engines, TWO_HOP, "q_g3")
    assert port == ref
    assert port["fingerprint"] == port["builder_fingerprint"]


def test_parse_between_and_in(engines):
    preds = {p.attr: p for p in parse(BETWEEN_IN).where}
    assert preds["e0.weight"].op == "range"
    assert preds["t.tid"].op == "in"
    ref, port = both(_run, engines, BETWEEN_IN)
    assert port == ref
    r = engines[PORT.name].query(parse(BETWEEN_IN))
    w = np.asarray(r.col("e0.weight"))
    assert ((w >= 0.25) & (w <= 0.75)).all()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_workload_text_equals_builder(name):
    assert parse(TEXTS[name]) == getattr(m2bench, name)()


@pytest.mark.parametrize("name", sorted(ALIKE))
def test_text_parses_alike_in_both(name):
    ref, port = both(lambda P: P.sqlpgq.parse(ALIKE[name]))
    assert _as_tree(port) == _as_tree(ref)


def test_comparison_operators_normalise():
    q = parse(COMPARISONS)
    assert q.match.graph == "Interested_in"     # defaults to the edge label
    assert [(p.attr, p.op) for p in q.where] == [
        ("p.country", "=="), ("p.country", "!="), ("p.country", "!="),
        ("e0.weight", "<"), ("e0.weight", "<="), ("e0.weight", ">"),
        ("t.tid", ">="), ("t.tid", "in"), ("e0.weight", "range")]
    assert q.where[5].value == -0.5 and q.where[6].value == -3
    assert q.where[7].value == (1, 2.5, "x")
    assert q.joins == (JoinPred("Customer.person_id", "p.pid"),)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_workload_text_runs_alike_in_both(engines, name):
    ref, port = both(_run, engines, TEXTS[name], name)
    assert port == ref
    assert port["fingerprint"] == port["builder_fingerprint"]


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_parse_errors(name):
    for P in (REF, PORT):
        with pytest.raises(SyntaxError):
            P.sqlpgq.parse(MALFORMED[name])
