"""The plain reference: the same semantics as the program, worked out again
from the generated arrays and the write stream.

* GCDI: a small parser of the SQL/PGQ (SFMW) texts under ``queries/`` and a
  numpy evaluator: every source filtered by its own predicates, then joined
  on the pattern's edges and the WHERE equalities with sort-based
  many-to-many joins, projected to the SELECT list. Bag semantics: one row
  per match, duplicates kept.
* GCDA: matrix generation (multi-hot per group, or numeric columns) and the
  three analytical operators in plain torch, in float64 by default, in row
  blocks for the N x N products.
* Shortest paths: a breadth-first search per distinct source over the edge
  columns in their direction, with no bound on the depth.

Imports neither jax, the JAX package nor anything of the program.
"""
from __future__ import annotations

import re
from typing import Iterator

import numpy as np

from .datagen import decode

# ---------------------------------------------------------------------------
# SFMW text -> a plain description
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""\s*(?:
    (?P<num>-?\d+\.\d+|-?\d+)
  | (?P<str>'[^']*')
  | (?P<op><=|>=|<>|!=|=|<|>)
  | (?P<arrow>->)
  | (?P<punct>[(),\[\]:\-])
  | (?P<word>[A-Za-z_][\w.]*))""", re.X)
_KEYWORDS = {"SELECT", "FROM", "MATCH", "ON", "WHERE", "AND", "BETWEEN", "IN"}


def _tokens(text: str) -> list:
    out, pos = [], 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            raise SyntaxError(f"bad token at {text[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        v = m.group(kind)
        if kind == "word" and v.upper() in _KEYWORDS:
            out.append(("kw", v.upper()))
        elif kind == "num":
            out.append(("lit", float(v) if "." in v else int(v)))
        elif kind == "str":
            out.append(("lit", v[1:-1]))
        else:
            out.append((kind, v))
    out.append(("eof", ""))
    return out


class _Reader:
    def __init__(self, toks):
        self.toks, self.i = toks, 0

    def take(self, kind=None, value=None):
        tok = self.toks[self.i]
        if (kind and tok[0] != kind) or (value and tok[1] != value):
            raise SyntaxError(f"expected {kind} {value}, got {tok}")
        self.i += 1
        return tok[1]

    def at(self, kind, value=None):
        tok = self.toks[self.i]
        return tok[0] == kind and (value is None or tok[1] == value)


def parse(text: str) -> dict:
    """``{"select": [ref], "froms": [name], "vertices": [(var, label)],
    "edges": [(var, label, src_var, dst_var)], "graph": name,
    "joins": [(ref, ref)], "filters": [(ref, op, value)]}``."""
    r = _Reader(_tokens(text))
    r.take("kw", "SELECT")
    select = [r.take("word")]
    while r.at("punct", ","):
        r.take()
        select.append(r.take("word"))
    froms = []
    if r.at("kw", "FROM"):
        r.take()
        froms.append(r.take("word"))
        while r.at("punct", ","):
            r.take()
            froms.append(r.take("word"))
    vertices, edges, graph = [], [], None
    if r.at("kw", "MATCH"):
        r.take()

        def vertex():
            r.take("punct", "(")
            var = r.take("word")
            r.take("punct", ":")
            label = r.take("word")
            r.take("punct", ")")
            vertices.append((var, label))
            return var
        prev = vertex()
        while r.at("punct", "-"):
            r.take()
            r.take("punct", "[")
            evar = r.take("word")
            r.take("punct", ":")
            elabel = r.take("word")
            r.take("punct", "]")
            r.take("arrow")
            nxt = vertex()
            edges.append((evar, elabel, prev, nxt))
            prev = nxt
        r.take("kw", "ON")
        graph = r.take("word")
    joins, filters = [], []
    if r.at("kw", "WHERE"):
        r.take()
        while True:
            ref = r.take("word")
            if r.at("kw", "BETWEEN"):
                r.take()
                lo = r.take("lit")
                r.take("kw", "AND")
                filters.append((ref, "between", (lo, r.take("lit"))))
            elif r.at("kw", "IN"):
                r.take()
                r.take("punct", "(")
                vals = [r.take("lit")]
                while r.at("punct", ","):
                    r.take()
                    vals.append(r.take("lit"))
                r.take("punct", ")")
                filters.append((ref, "in", tuple(vals)))
            else:
                op = r.take("op")
                if r.at("word"):
                    if op != "=":
                        raise SyntaxError("only equality joins")
                    joins.append((ref, r.take("word")))
                else:
                    filters.append((ref, op, r.take("lit")))
            if not r.at("kw", "AND"):
                break
            r.take()
    r.take("eof")
    return {"select": select, "froms": froms, "vertices": vertices,
            "edges": edges, "graph": graph, "joins": joins,
            "filters": filters}


# ---------------------------------------------------------------------------
# Evaluation over the generated arrays
# ---------------------------------------------------------------------------


def edges_after(data: dict, graph: str, writes: list) -> dict:
    """The edge columns of ``graph``: the generated ones, then every batch
    in ``writes`` (``[(graph, rows)]``, in the order they were accepted)."""
    cols = data["graphs"][graph]["edges"][1]
    rows = [w for g, w in writes if g == graph]
    if not rows:
        return cols
    return {k: np.concatenate([np.asarray(cols[k])]
                              + [np.asarray(w[k]) for w in rows])
            for k in cols}


def _source_columns(spec: dict, data: dict, writes: list, name: str) -> dict:
    """Columns of one source of the query, named ``name.col``, plus the
    structural keys the joins need (``name.#vid``, ``name.#src``...)."""
    if name in spec["froms"]:
        cols = data["tables"][name]
        out = {f"{name}.{c}": decode(v) for c, v in cols.items()
               if not (isinstance(v, dict) and "offsets" in v)}
        return out
    g = data["graphs"][spec["graph"]]
    for var, label in spec["vertices"]:
        if var == name:
            cols = g["vertex_tables"][label][1]
            n = len(next(iter(cols.values())))
            out = {f"{name}.{c}": decode(v) for c, v in cols.items()}
            out[f"{name}.#vid"] = np.arange(n, dtype=np.int64)
            return out
    cols = edges_after(data, spec["graph"], writes)
    out = {f"{name}.{c}": decode(v) for c, v in cols.items()
           if c not in ("svid", "tvid")}
    out[f"{name}.#src"] = np.asarray(cols["svid"])
    out[f"{name}.#dst"] = np.asarray(cols["tvid"])
    return out


def _owner(ref: str, names: list) -> str:
    for n in sorted(names, key=len, reverse=True):
        if ref.startswith(n + "."):
            return n
    raise KeyError(f"{ref} names no source of the query")


def _mask(vals: np.ndarray, op: str, v) -> np.ndarray:
    if op == "=":
        return vals == v
    if op in ("!=", "<>"):
        return vals != v
    if op == "<":
        return vals < v
    if op == "<=":
        return vals <= v
    if op == ">":
        return vals > v
    if op == ">=":
        return vals >= v
    if op == "between":
        return (vals >= v[0]) & (vals <= v[1])
    if op == "in":
        return np.isin(vals, list(v))
    raise ValueError(op)


def _join_index(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every pair (i, j) with a[i] == b[j]: a sort-based many-to-many join."""
    order = np.argsort(b, kind="stable")
    sb = b[order]
    lo = np.searchsorted(sb, a, "left")
    hi = np.searchsorted(sb, a, "right")
    cnt = hi - lo
    left = np.repeat(np.arange(len(a)), cnt)
    start = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    right = order[start + np.arange(cnt.sum())]
    return left, right


def _take(rel: dict, idx: np.ndarray) -> dict:
    return {k: v[idx] for k, v in rel.items()}


def evaluate(spec: dict, data: dict, writes: list = (),
             bag: bool = True) -> list[np.ndarray]:
    """The SELECT columns of the query over ``data`` after ``writes``.
    ``bag=False`` collapses duplicate rows (set semantics: the control)."""
    names = list(spec["froms"]) + [v for v, _ in spec["vertices"]] \
        + [e[0] for e in spec["edges"]]
    rels = {n: _source_columns(spec, data, list(writes), n) for n in names}
    for ref, op, v in spec["filters"]:
        n = _owner(ref, names)
        keep = _mask(rels[n][ref], op, v)
        rels[n] = _take(rels[n], np.nonzero(keep)[0])
    links = [(a, b) for a, b in spec["joins"]]
    for evar, _, s, d in spec["edges"]:
        links.append((f"{evar}.#src", f"{s}.#vid"))
        links.append((f"{evar}.#dst", f"{d}.#vid"))
    # join in a connected order, smallest source first
    done = {min(names, key=lambda n: len(next(iter(rels[n].values()))))}
    rel = rels[next(iter(done))]
    pending = list(links)
    while len(done) < len(names):
        for a, b in pending:
            na, nb = _owner(a, names), _owner(b, names)
            if (na in done) != (nb in done):
                break
        else:
            raise ValueError("query sources are not connected")
        if nb in done:
            a, b, na, nb = b, a, nb, na
        li, ri = _join_index(rel[a], rels[nb][b])
        rel = {**_take(rel, li), **_take(rels[nb], ri)}
        done.add(nb)
        pending.remove((a, b) if (a, b) in pending else (b, a))
        for x, y in list(pending):
            if _owner(x, names) in done and _owner(y, names) in done:
                keep = rel[x] == rel[y]
                rel = _take(rel, np.nonzero(keep)[0])
                pending.remove((x, y))
    cols = [rel[ref] for ref in spec["select"]]
    if not bag and cols and len(cols[0]):
        _, first = np.unique(np.stack([_codes(c) for c in cols], axis=1),
                             axis=0, return_index=True)
        cols = [c[np.sort(first)] for c in cols]
    return cols


def _codes(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.unique(col, return_inverse=True)[1].astype(np.int64)
    return col


def _sorted_cols(cols: list) -> list[np.ndarray]:
    cols = [np.asarray(c).astype(str) if np.asarray(c).dtype == object
            else np.asarray(c) for c in cols]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


def table_rows(out, select: list) -> list:
    """The program's result relation as plain columns, in SELECT order (an
    answer already in that form passes as it is)."""
    if isinstance(out, list):
        return out
    cols = []
    for ref in select:
        c = out.col(ref)
        cols.append(c.decode(c.codes) if hasattr(c, "codes")
                    else np.asarray(c))
    return cols


def rows_mismatched(got: list[np.ndarray], want: list[np.ndarray]) -> int:
    """Size of the multiset difference between two row sets, both ways:
    0 when they hold the same rows, each as often."""
    if len(got) != len(want):
        return max(len(got[0]) if got else 0, len(want[0]) if want else 0)

    def counted(cols):
        if not cols or not len(cols[0]):
            return {}
        both = np.stack([np.asarray(c).astype(str) if np.asarray(c).dtype
                         == object else np.asarray(c, dtype=np.float64)
                         for c in cols], axis=1)
        u, n = np.unique(both, axis=0, return_counts=True)
        return {tuple(r): int(k) for r, k in zip(u.tolist(), n)}
    if len(got[0]) == len(want[0]) and all(
            np.array_equal(a, b)
            for a, b in zip(_sorted_cols(got), _sorted_cols(want))):
        return 0
    a, b = counted(got), counted(want)
    return sum(abs(a.get(k, 0) - b.get(k, 0)) for k in set(a) | set(b))


# ---------------------------------------------------------------------------
# GCDA: matrix generation and the analytical operators
# ---------------------------------------------------------------------------


def matrix(rel: dict, spec: list) -> np.ndarray:
    """One input matrix of a GCDIA from the integration's columns:
    ``["random", group, value, n]`` is the per-group multi-hot of ``value``
    over ``n`` features, rows in ascending group order;
    ``["rel2matrix", [cols]]`` the numeric columns side by side."""
    if spec[0] == "random":
        _, group, value, n = spec
        groups = np.asarray(rel[group])
        vals = np.asarray(rel[value]).astype(np.int64)
        uniq, row = np.unique(groups, return_inverse=True)
        out = np.zeros((len(uniq), int(n)), dtype=np.float32)
        ok = (vals >= 0) & (vals < int(n))
        out[row[ok], vals[ok]] = 1.0
        return out
    if spec[0] == "rel2matrix":
        return np.stack([np.asarray(rel[c], dtype=np.float32)
                         for c in spec[1]], axis=1)
    raise ValueError(spec[0])


def round_tf32(t):
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    import torch
    i = t.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """How the reference computes: float64 (the reference), or the control's
    TF32 (float32 with every product input rounded to TF32, float32 sums)."""

    def __init__(self, low: bool, device):
        import torch
        self.low = low
        self.device = device
        self.dtype = torch.float32 if low else torch.float64

    def tensor(self, a: np.ndarray):
        import torch
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    def mm(self, a, b):
        if self.low:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


def product_blocks(op: str, x: np.ndarray, prec: Precision,
                   block: int = 4096) -> Iterator[tuple[int, object]]:
    """Row blocks ``(start, rows)`` of the N x N output of MULTIPLY (the
    Gram product X X^T) or SIMILARITY (cosine of every pair of rows)."""
    import torch
    xt = prec.tensor(x)
    if op == "SIMILARITY":
        xt = xt / torch.sqrt((xt * xt).sum(-1, keepdim=True) + 1e-12)
    for lo in range(0, xt.shape[0], block):
        yield lo, prec.mm(xt[lo:lo + block], xt.T)


def regression(x: np.ndarray, y: np.ndarray, iters: int, lr: float,
               l2: float, prec: Precision):
    """Logistic regression by gradient descent from w = 0:
    w <- w - lr * (X^T (sigmoid(X w) - y) / n + l2 * w)."""
    import torch
    xt, yt = prec.tensor(x), prec.tensor(y.reshape(-1))
    w = torch.zeros(xt.shape[1], dtype=prec.dtype, device=prec.device)
    n = xt.shape[0]
    for _ in range(iters):
        p = torch.sigmoid(prec.mm(xt, w[:, None])[:, 0])
        g = prec.mm(xt.T, (p - yt)[:, None])[:, 0] / n
        w = w - lr * (g + l2 * w)
    return w


def gcda_inputs(task: dict, query: dict, data: dict, writes: list
                ) -> list[np.ndarray]:
    """The input matrices of GCDIA ``task`` after ``writes``."""
    cols = evaluate(query, data, writes)
    names = query["select"]
    rel = dict(zip(names, cols))
    return [matrix(rel, spec) for spec in task["inputs"]]


def _gap_max(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) \
        if want.numel() else 0.0


def compare_gcda(task: dict, got, mats: list, prec: Precision,
                 block: int = 4096) -> float:
    """The number that ``task["check"]["number"]`` names, between the
    program's output ``got`` and the reference worked out from ``mats``:
    ``entries_mismatched`` (entries not equal, exact), ``max_gap`` (largest
    absolute difference) or ``rel_gap`` (largest absolute difference over
    the reference's largest magnitude)."""
    import torch
    number = task["check"]["number"]
    op = task["op"]
    if op == "REGRESSION":
        want = regression(mats[0], mats[1], task["iters"], task["lr"],
                          task["l2"], prec)
        shape_ok = tuple(got.shape) == tuple(want.shape)
        if not shape_ok:
            return float("inf")
        got = got.to(want.device)
        if number == "rel_gap":
            return _gap_max(got, want) / max(float(want.abs().max()), 1e-30)
        return _gap_max(got, want)
    n = mats[0].shape[0]
    if tuple(got.shape) != (n, n):
        return float("inf")
    worst = 0.0
    for lo, want in product_blocks(op, mats[0], prec, block):
        part = got[lo:lo + want.shape[0]].to(want.device)
        if number == "entries_mismatched":
            worst += float((part.double() != want.double()).sum())
        else:
            worst = max(worst, _gap_max(part, want))
        del want, part
    if number == "entries_mismatched":
        return worst
    if number == "rel_gap":
        raise ValueError("rel_gap is for REGRESSION")
    return worst


def control_output(task: dict, mats: list, device) -> object:
    """The control's output of GCDIA ``task``: the reference in TF32, put in
    the program's place (an N x N product held whole)."""
    import torch
    prec = Precision(True, device)
    if task["op"] == "REGRESSION":
        return regression(mats[0], mats[1], task["iters"], task["lr"],
                          task["l2"], prec)
    n = mats[0].shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=device)
    for lo, rows in product_blocks(task["op"], mats[0], prec):
        out[lo:lo + rows.shape[0]] = rows
    return out


# ---------------------------------------------------------------------------
# Shortest paths
# ---------------------------------------------------------------------------


def node_ids(data: dict, graph: str) -> dict:
    """The reference's numbering of ``graph``'s vertices: each label's
    vertices in a block of their own, in the order the graph lists its
    labels. ``{label: first node id}`` and, under ``None``, the count."""
    first, n = {}, 0
    for label, (_, cols) in data["graphs"][graph]["vertex_tables"].items():
        first[label] = n
        n += len(next(iter(cols.values())))
    first[None] = n
    return first


def hop_distances(n: int, heads: np.ndarray, tails: np.ndarray,
                  sources: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """The hop count of a shortest path from ``sources[k]`` to
    ``targets[k]`` over the ``n`` nodes and the directed edges
    ``heads[j] -> tails[j]``; -1 where there is none."""
    heads = np.asarray(heads, dtype=np.int64)
    order = np.argsort(heads, kind="stable")
    nbr = np.asarray(tails, dtype=np.int64)[order]
    start = np.searchsorted(heads[order], np.arange(n + 1))
    sources = np.asarray(sources, dtype=np.int64)
    targets = np.asarray(targets, dtype=np.int64)
    out = np.full(len(sources), -1, dtype=np.int64)
    for s in np.unique(sources):
        dist = np.full(n, -1, dtype=np.int64)
        dist[s] = 0
        frontier = np.array([s])
        hop = 0
        while len(frontier):
            hop += 1
            lo, cnt = start[frontier], start[frontier + 1] - start[frontier]
            at = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) \
                + np.arange(cnt.sum())
            nxt = np.unique(nbr[at])
            nxt = nxt[dist[nxt] < 0]
            dist[nxt] = hop
            frontier = nxt
        mine = sources == s
        out[mine] = dist[targets[mine]]
    return out


def shortest_paths(data: dict, graph: str, writes: list, src_label: str,
                   src_vids, dst_label: str, dst_vids,
                   both_ways: bool = False) -> np.ndarray:
    """Hop distance of each (source, target) pair of vertex ids over
    ``graph``'s edges after ``writes``, followed from ``svid`` to
    ``tvid``; -1 where the target is unreachable. ``both_ways=True``
    follows every edge in either direction (the control)."""
    g = data["graphs"][graph]
    first = node_ids(data, graph)
    cols = edges_after(data, graph, writes)
    heads = first[g["src_label"]] + np.asarray(cols["svid"], dtype=np.int64)
    tails = first[g["dst_label"]] + np.asarray(cols["tvid"], dtype=np.int64)
    if both_ways:
        heads, tails = (np.concatenate([heads, tails]),
                        np.concatenate([tails, heads]))
    return hop_distances(first[None], heads, tails,
                         first[src_label] + np.asarray(src_vids),
                         first[dst_label] + np.asarray(dst_vids))
