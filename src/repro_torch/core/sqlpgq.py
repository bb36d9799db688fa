"""SQL/PGQ-compatible query surface (paper §6.1: "user queries are expressed
in an SQL/PGQ-compatible language"). A small recursive-descent parser from
SFMW text to the core Query AST:

    SELECT Customer.id, t.tid
    FROM Customer
    MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in
    WHERE t.content = 'food' AND Customer.person_id = p.pid

Equality between two column references becomes a cross-model JoinPred;
column-op-literal becomes a Predicate (=, <>, !=, <, <=, >, >=,
BETWEEN..AND.., IN (...)). Patterns are vertex-edge chains with labels.
"""
from __future__ import annotations

import re

from .schema import (JoinPred, Pattern, PatternEdge, PatternVertex,
                     Predicate, Query)

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>-?\d+\.\d+|-?\d+)
    | (?P<str>'[^']*')
    | (?P<op><=|>=|<>|!=|=|<|>)
    | (?P<arrow>->)
    | (?P<punct>[(),\[\]:\-])
    | (?P<word>[A-Za-z_][\w.]*)
    )""", re.X)

KEYWORDS = frozenset(
    {"SELECT", "FROM", "MATCH", "WHERE", "ON", "AND", "BETWEEN", "IN"})


def _tokenize(text: str):
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise SyntaxError(f"bad token at: {text[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("num", "str", "op", "arrow", "punct", "word"):
            v = m.group(kind)
            if v is not None:
                if kind == "word" and v.upper() in KEYWORDS:
                    out.append(("kw", v.upper()))
                else:
                    out.append((kind, v))
                break
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None):
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise SyntaxError(f"expected {kind} {value or ''}, got {k} {v!r}")
        return v

    def accept(self, kind, value=None):
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.i += 1
            return True
        return False

    # ---------------- grammar ----------------
    def query(self) -> Query:
        self.expect("kw", "SELECT")
        select = [self.expect("word")]
        while self.accept("punct", ","):
            select.append(self.expect("word"))

        froms = []
        if self.accept("kw", "FROM"):
            froms.append(self.expect("word"))
            while self.accept("punct", ","):
                froms.append(self.expect("word"))

        match = None
        if self.accept("kw", "MATCH"):
            match = self.pattern()

        joins, where = [], []
        if self.accept("kw", "WHERE"):
            self.condition(joins, where)
            while self.accept("kw", "AND"):
                self.condition(joins, where)

        return Query(select=tuple(select), froms=tuple(froms), match=match,
                     joins=tuple(joins), where=tuple(where))

    def pattern(self) -> Pattern:
        vertices, edges = [], []
        seen = {}

        def vertex():
            self.expect("punct", "(")
            var = self.expect("word")
            self.expect("punct", ":")
            label = self.expect("word")
            self.expect("punct", ")")
            if var not in seen:
                seen[var] = PatternVertex(var, label)
                vertices.append(seen[var])
            return var

        src = vertex()
        while self.peek() == ("punct", "-"):
            self.expect("punct", "-")
            self.expect("punct", "[")
            evar = self.expect("word")
            self.expect("punct", ":")
            elabel = self.expect("word")
            self.expect("punct", "]")
            self.expect("arrow")
            dst = vertex()
            edges.append(PatternEdge(evar, elabel, src, dst))
            src = dst

        graph = edges[0].label if edges else vertices[0].label
        if self.accept("kw", "ON"):
            graph = self.expect("word")
        return Pattern(graph, tuple(vertices), tuple(edges))

    def condition(self, joins: list, where: list):
        lhs = self.expect("word")
        if self.accept("kw", "BETWEEN"):
            lo = self.value()
            self.expect("kw", "AND")
            hi = self.value()
            where.append(Predicate(lhs, "range", lo, hi))
            return
        if self.accept("kw", "IN"):
            self.expect("punct", "(")
            vals = [self.value()]
            while self.accept("punct", ","):
                vals.append(self.value())
            self.expect("punct", ")")
            where.append(Predicate(lhs, "in", tuple(vals)))
            return
        op = self.expect("op")
        op = {"=": "==", "<>": "!="}.get(op, op)
        kind, val = self.peek()
        if kind == "word":  # column = column  ->  cross-model join
            self.next()
            if op != "==":
                raise SyntaxError("only equality joins are supported")
            joins.append(JoinPred(lhs, val))
        else:
            where.append(Predicate(lhs, op, self.value()))

    def value(self):
        kind, v = self.next()
        if kind == "num":
            return float(v) if "." in v else int(v)
        if kind == "str":
            return v[1:-1]
        raise SyntaxError(f"expected literal, got {kind} {v!r}")


def parse(text: str) -> Query:
    """Parse an SFMW query string into the core Query AST."""
    p = _Parser(_tokenize(text))
    q = p.query()
    p.expect("eof")
    return q
