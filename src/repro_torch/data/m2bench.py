"""Synthetic M2Bench-style multi-model scenario (paper §7, after [30]).

E-commerce scenario with the paper's running example:
  * relational: Product(id, title, price), Customer(id, person_id, name)
  * document:   Orders  {order_id, customer_id, product_id, quantity,
                          shipping: {city, days}, items: [tag ids]}
  * graphs:     Interested_in  (Persons -> Tags,   weight property)
                Follows        (Persons -> Persons)

Scale factor SF multiplies entity counts (the paper uses SF 1/2/5/10 over
M2Bench's 17k-84M records; this container scales the same shape down).

Queries exported mirror the paper's workload aliases:
  G1-G5: pattern-matching GCDI (Fig. 10/11); G6-G8 shortest-path;
  A1-A3: GCDA (regression / similarity / multiply).
"""
from __future__ import annotations

import numpy as np

from ..core.schema import (AnalyticsTask, GCDIATask, JoinPred, Pattern,
                           PatternVertex, Predicate, Query, chain_pattern)
from ..core.storage import Database, DictColumn, Graph, Table

N_TAGS = 200
FOOD_TAGS = 40          # tag ids [0, 40) are food-related
PRODUCT_TITLES = ("Yogurt", "Milk", "Bread", "Coffee", "Tea", "Chocolate",
                  "Laptop", "Phone", "Book", "Desk")


def generate(sf: int = 1, seed: int = 0) -> Database:
    rng = np.random.default_rng(seed)
    n_products = 1_000 * sf
    n_customers = 2_000 * sf
    n_orders = 10_000 * sf
    n_persons = n_customers + 500 * sf         # some persons aren't customers
    db = Database()

    # --- relational -------------------------------------------------------
    titles = [PRODUCT_TITLES[i % len(PRODUCT_TITLES)] + (f" v{i // len(PRODUCT_TITLES)}"
              if i >= len(PRODUCT_TITLES) else "") for i in range(n_products)]
    db.add_table(Table("Product", {
        "id": np.arange(n_products, dtype=np.int64),
        "title": DictColumn(values=titles),
        "price": rng.uniform(1, 500, n_products).round(2),
    }))
    db.add_table(Table("Customer", {
        "id": np.arange(n_customers, dtype=np.int64),
        "person_id": rng.permutation(n_persons)[:n_customers].astype(np.int64),
        "name": DictColumn(values=[f"cust_{i}" for i in range(n_customers)]),
        "age": rng.integers(18, 80, n_customers).astype(np.int64),
    }))

    # --- documents ----------------------------------------------------------
    cust_ids = rng.integers(0, n_customers, n_orders)
    prod_ids = rng.integers(0, n_products, n_orders)
    docs = []
    cities = ["wuhan", "beijing", "shanghai", "shenzhen", "chengdu"]
    for i in range(n_orders):
        docs.append({
            "order_id": int(i),
            "customer_id": int(cust_ids[i]),
            "product_id": int(prod_ids[i]),
            "quantity": int(rng.integers(1, 5)),
            "shipping": {"city": cities[int(rng.integers(0, len(cities)))],
                         "days": int(rng.integers(1, 10))},
            "items": rng.integers(0, N_TAGS, rng.integers(1, 4)).tolist(),
        })
    db.add_documents("Orders", docs)

    # --- Interested_in graph (Persons -> Tags) -----------------------------
    persons = Table("Persons", {
        "pid": np.arange(n_persons, dtype=np.int64),
        "country": DictColumn(values=[("cn", "us", "au", "uk")[i % 4]
                                      for i in range(n_persons)]),
    })
    tag_contents = ["food"] * FOOD_TAGS + [f"topic_{i}" for i in range(N_TAGS - FOOD_TAGS)]
    tags = Table("Tags", {
        "tid": np.arange(N_TAGS, dtype=np.int64),
        "content": DictColumn(values=tag_contents),
        "popularity": rng.uniform(0, 1, N_TAGS),
    })
    deg = rng.poisson(8, n_persons).clip(1, 40)
    src = np.repeat(np.arange(n_persons), deg)
    dst = rng.integers(0, N_TAGS, len(src))
    interest_edges = Table("Interested_in_edges", {
        "svid": src.astype(np.int64),
        "tvid": dst.astype(np.int64),
        "weight": rng.uniform(0, 1, len(src)),
    })
    db.add_graph(Graph("Interested_in", {"Persons": persons, "Tags": tags},
                       interest_edges, "Persons", "Tags"))

    # --- Follows graph (Persons -> Persons) --------------------------------
    fdeg = rng.poisson(5, n_persons).clip(0, 30)
    fsrc = np.repeat(np.arange(n_persons), fdeg)
    fdst = rng.integers(0, n_persons, len(fsrc))
    keep = fsrc != fdst
    follows_edges = Table("Follows_edges", {
        "svid": fsrc[keep].astype(np.int64),
        "tvid": fdst[keep].astype(np.int64),
        "since": rng.integers(2000, 2026, int(keep.sum())).astype(np.int64),
    })
    persons2 = Table("Persons", {k: v for k, v in persons.columns.items()})
    db.add_graph(Graph("Follows", {"Persons": persons2}, follows_edges,
                       "Persons", "Persons"))
    return db


# ---------------------------------------------------------------------------
# Skewed-key fixture: Zipfian join keys + the 4-source bushy exemplar
# ---------------------------------------------------------------------------

ZIPF_ALPHA = 0.9        # rank exponent of the Zipfian key draws
N_HUBS = 16             # distinct values of the low-NDV "hub" join key


def _zipf_weights(n: int, alpha: float = ZIPF_ALPHA) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    return w / w.sum()


def generate_skew(sf: int = 1, seed: int = 7) -> Database:
    """Zipfian-key workload (the MICRO/QUEST skew regime): the ``user_id``
    join keys of Clicks and Purchases follow a Zipf law over the same head,
    so the heavy keys match each other and the true join size is dominated
    by Σ_k c_k·p_k — which uniform-key NDV containment collapses to
    |L|·|R|/ndv, an order-of-magnitude underestimate. Histogram/MCV overlap
    (``ColumnStats.join_overlap``) recovers it.

    Also carries the 4-source bushy exemplar: two large fact tables
    (``SrcA``, ``DstB``) connected by a low-NDV ``hub`` key, each reducible
    by a small key list (``FiltA``, ``FiltD``) — the only cheap shape is
    bushy ``(FiltA⋈SrcA) ⋈ (DstB⋈FiltD)``; every left-deep order pays a
    huge hub-join intermediate on one side."""
    rng = np.random.default_rng(seed)
    db = Database()

    # --- Zipfian 3-join tables ---------------------------------------------
    n_users = 2_000 * sf
    n_clicks = 12_000 * sf
    n_purchases = 9_000 * sf
    n_pages, n_products = 500, 400
    w = _zipf_weights(n_users)
    db.add_table(Table("Clicks", {
        "click_id": np.arange(n_clicks, dtype=np.int64),
        "user_id": rng.choice(n_users, size=n_clicks, p=w).astype(np.int64),
        "page_id": rng.integers(0, n_pages, n_clicks).astype(np.int64),
    }))
    db.add_table(Table("Purchases", {
        "purchase_id": np.arange(n_purchases, dtype=np.int64),
        "user_id": rng.choice(n_users, size=n_purchases, p=w).astype(np.int64),
        "product_id": rng.integers(0, n_products, n_purchases).astype(np.int64),
    }))
    db.add_table(Table("Pages", {
        "id": np.arange(n_pages, dtype=np.int64),
        "kind": DictColumn(values=[("ad", "organic", "search", "social",
                                    "mail")[i % 5] for i in range(n_pages)]),
    }))
    db.add_table(Table("Products", {
        "id": np.arange(n_products, dtype=np.int64),
        "cat": DictColumn(values=[("gear", "food", "media", "home")[i % 4]
                                  for i in range(n_products)]),
    }))

    # --- 4-source bushy exemplar -------------------------------------------
    n_fact = 12_000 * sf
    n_keys = 60
    hubs = [f"h{i}" for i in range(N_HUBS)]
    db.add_table(Table("SrcA", {
        "id": np.arange(n_fact, dtype=np.int64),
        "akey": rng.integers(0, n_fact, n_fact).astype(np.int64),
        "hub": DictColumn(values=[hubs[i] for i in
                                  rng.integers(0, N_HUBS, n_fact)]),
    }))
    db.add_table(Table("DstB", {
        "id": np.arange(n_fact, dtype=np.int64),
        "bkey": rng.integers(0, n_fact, n_fact).astype(np.int64),
        "hub": DictColumn(values=[hubs[i] for i in
                                  rng.integers(0, N_HUBS, n_fact)]),
    }))
    db.add_table(Table("FiltA", {
        "akey": np.sort(rng.choice(n_fact, n_keys, replace=False)).astype(np.int64),
    }))
    db.add_table(Table("FiltD", {
        "bkey": np.sort(rng.choice(n_fact, n_keys, replace=False)).astype(np.int64),
    }))
    return db


def q_skew_3join() -> Query:
    """Skewed 3-join exemplar: the Clicks⋈Purchases key join is Zipf × Zipf
    (aligned heads), flanked by two uniform FK→PK joins with selective
    filters — the root cardinality hinges on the key-distribution overlap,
    exactly where NDV containment collapses."""
    return Query(
        select=("Clicks.click_id", "Purchases.purchase_id"),
        froms=("Clicks", "Purchases", "Pages", "Products"),
        joins=(JoinPred("Clicks.user_id", "Purchases.user_id"),
               JoinPred("Clicks.page_id", "Pages.id"),
               JoinPred("Purchases.product_id", "Products.id")),
        where=(Predicate("Pages.kind", "==", "ad"),
               Predicate("Products.cat", "==", "gear")),
    )


def q_bushy_4src() -> Query:
    """4-source chain FiltA—SrcA—DstB—FiltD whose only cheap plan is bushy:
    both fact tables must be reduced by their key lists *before* the
    many-many hub join; any left-deep order crosses the hub edge with one
    side unreduced and pays a ~1000x larger intermediate."""
    return Query(
        select=("SrcA.id", "DstB.id"),
        froms=("FiltA", "SrcA", "DstB", "FiltD"),
        joins=(JoinPred("FiltA.akey", "SrcA.akey"),
               JoinPred("SrcA.hub", "DstB.hub"),
               JoinPred("DstB.bkey", "FiltD.bkey")),
    )


# ---------------------------------------------------------------------------
# Workload: GCDI queries G1-G8 and GCDA tasks A1-A3 (paper aliases)
# ---------------------------------------------------------------------------


def q_g1() -> Query:
    """G1: single-hop pattern, equality predicate on target vertex +
    cross-model join with Customer (the paper's Fig. 1(a)/Eq. 2 query)."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("Customer.id", "t.tid"),
        froms=("Customer",),
        match=pat,
        joins=(JoinPred("Customer.person_id", "p.pid"),),
        where=(Predicate("t.content", "==", "food"),),
    )


def q_g2() -> Query:
    """G2: predicate on source side + document join (Orders docs)."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("Orders.order_id", "t.tid"),
        froms=("Customer", "Orders"),
        match=pat,
        joins=(JoinPred("Customer.person_id", "p.pid"),
               JoinPred("Orders.customer_id", "Customer.id")),
        where=(Predicate("p.country", "==", "cn"),
               Predicate("Orders.shipping.days", "<=", 3)),
    )


def q_g3() -> Query:
    """G3: two-hop pattern on the homogeneous Follows graph."""
    pat = chain_pattern("Follows",
                        ("a", "Persons", "Follows", "b", "Persons"),
                        ("b", "Persons", "Follows", "c", "Persons"))
    return Query(
        select=("a.pid", "c.pid"),
        froms=(),
        match=pat,
        where=(Predicate("a.country", "==", "au"),
               Predicate("c.country", "==", "uk")),
    )


def q_g4() -> Query:
    """G4: join-pushdown shape (Eq. 8): Product -> Orders -> Customer ->
    pattern; selective predicate on Product.title (the yogurt query)."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("Customer.id", "t.tid"),
        froms=("Product", "Orders", "Customer"),
        match=pat,
        joins=(JoinPred("Product.id", "Orders.product_id"),
               JoinPred("Orders.customer_id", "Customer.id"),
               JoinPred("Customer.person_id", "p.pid")),
        where=(Predicate("Product.title", "==", "Yogurt"),),
    )


def q_opt_skew() -> Query:
    """Skewed 3-join optimizer exemplar: the query order merges the two
    largest collections (graph relation, Orders) first and leaves the
    selective Product.title filter for last — smallest-intermediate-first
    reordering must flip it (Product ⋈ Orders ⋈ Customer ⋈ pattern)."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("Customer.id", "t.tid"),
        froms=("Orders", "Customer", "Product"),
        match=pat,
        joins=(JoinPred("Customer.person_id", "p.pid"),
               JoinPred("Orders.customer_id", "Customer.id"),
               JoinPred("Product.id", "Orders.product_id")),
        where=(Predicate("Product.title", "==", "Yogurt"),
               Predicate("t.content", "==", "food")),
    )


def build_indexes(db: Database):
    """Secondary indexes for the selective-access workload (the index
    benchmark suite and tests): table-side sorted/zone indexes on the join
    and lookup keys, plus the graph-side composite (label, attr) vertex
    indexes that seed pattern candidates. Returns the IndexManager."""
    im = db.indexes
    im.create("Customer", "person_id")                      # sorted (int key)
    im.create("Orders", "order_id", kind="zone")            # clustered: zones prune exactly
    im.create("Product", "price")                           # sorted (random float)
    im.create("Interested_in", "pid", label="Persons")      # composite (label, attr)
    im.create("Interested_in", "popularity", label="Tags")
    im.create("Interested_in", "content", label="Tags")     # hash over dict codes
    return im


def point_lookup_keys(db: Database) -> tuple[int, int]:
    """A consistent (person_id, order_id) pair for ``q_point_lookup``:
    order 0's customer and that customer's person, so the point query is
    non-empty at every scale factor."""
    orders = db.tables["Orders"]
    c0 = int(np.asarray(orders.col("customer_id"))[0])
    pid = int(np.asarray(db.tables["Customer"].col("person_id"))[c0])
    oid = int(np.asarray(orders.col("order_id"))[0])
    return pid, oid


def q_point_lookup(pid: int = 777, oid: int = 4242) -> Query:
    """Index exemplar 1: single-key equalities at ~1e-4 selectivity — the
    graph-side composite (Persons, pid) index seeds the match frontier
    from one vertex, the Customer.person_id sorted index replaces the
    table scan, and the clustered Orders.order_id zone maps skip-scan the
    document collection. Without indexes every predicate pays O(n) column
    scans. (Use ``point_lookup_keys`` for a non-empty result.)"""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("Customer.id", "t.tid"),
        froms=("Customer", "Orders"),
        match=pat,
        joins=(JoinPred("Orders.customer_id", "Customer.id"),
               JoinPred("Customer.person_id", "p.pid")),
        where=(Predicate("p.pid", "==", pid),
               Predicate("Customer.person_id", "==", pid),
               Predicate("Orders.order_id", "==", oid)),
    )


def q_range_narrow(lo: float = 100.0, hi: float = 100.5) -> Query:
    """Index exemplar 2: tight numeric ranges — Product.price in a 0.1%
    window (table-side sorted index) and t.popularity in a 2% window
    (graph-side composite (Tags, popularity) index), flowing through the
    q_g4-shaped Product -> Orders -> Customer -> pattern join chain."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("Customer.id", "t.tid"),
        froms=("Product", "Orders", "Customer"),
        match=pat,
        joins=(JoinPred("Product.id", "Orders.product_id"),
               JoinPred("Orders.customer_id", "Customer.id"),
               JoinPred("Customer.person_id", "p.pid")),
        where=(Predicate("Product.price", "range", lo, hi),
               Predicate("t.popularity", "range", 0.90, 0.92)),
    )


def q_shard_join() -> Query:
    """Scan/join-heavy sharded-execution exemplar: the full Orders document
    collection (the largest base table) filtered by two pushed predicates,
    then FK-joined to Customer and Product on the integer keys. No graph
    pattern and no expected indexes — execution is dominated by the scan
    and the two large equi-joins, which is exactly what hash-sharded
    morsel-parallel execution accelerates."""
    return Query(
        select=("Orders.order_id", "Orders.quantity", "Orders.shipping.days",
                "Customer.id", "Customer.age", "Product.price"),
        froms=("Orders", "Customer", "Product"),
        joins=(JoinPred("Orders.customer_id", "Customer.id"),
               JoinPred("Orders.product_id", "Product.id")),
        where=(Predicate("Orders.quantity", ">=", 2),
               Predicate("Orders.shipping.days", "<=", 7)),
    )


def a_shard_reg() -> GCDIATask:
    """GCDIA rider for the shard benchmark: Rel2Matrix feature/label
    matrices over the numeric GCDI columns feeding a logistic REGRESSION
    (output stays d-sized and device-resident), so the born-sharded
    GCDI -> GCDA matrix handoff sits on the critical path at any row
    count."""
    return GCDIATask(
        integration=q_shard_join(),
        analytics=AnalyticsTask("REGRESSION", [
            ("rel2matrix", ("Orders.quantity", "Orders.shipping.days",
                            "Customer.age", "Product.price")),
            ("rel2matrix", ("Orders.quantity",)),
        ]),
    )


def q_g5() -> Query:
    """G5: range predicate on edge property (match-trimming candidate:
    v-e-v with edge-only predicates, but projection references vertices)."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(
        select=("p.pid", "t.tid"),
        froms=(),
        match=pat,
        where=(Predicate("e0.weight", ">", 0.9),),
    )


def q_edge_scan() -> Query:
    """Match-trimming case 2 exemplar (paper §6.2 example 2)."""
    pat = chain_pattern("Interested_in", ("p", "Persons", "Interested_in", "t", "Tags"))
    return Query(select=("e0.weight",), froms=(), match=pat,
                 where=(Predicate("e0.weight", ">", 0.5),))


def q_vertex_scan() -> Query:
    """Match-trimming case 1 exemplar (paper §6.2 example 1)."""
    pat = Pattern("Interested_in", (PatternVertex("t", "Tags"),), ())
    return Query(select=("t.tid",), froms=(), match=pat,
                 where=(Predicate("t.content", "==", "food"),))


def a1_regression() -> GCDIATask:
    """A1: logistic regression — predict yogurt purchase from interest tags
    (the paper's running example)."""
    return GCDIATask(
        integration=q_g1(),
        analytics=AnalyticsTask("REGRESSION", [
            ("random", "Customer.id", "t.tid", N_TAGS),
        ]),
    )


def a2_similarity() -> GCDIATask:
    """A2: cosine similarity between customers' tag-interest vectors."""
    return GCDIATask(
        integration=q_g1(),
        analytics=AnalyticsTask("SIMILARITY", [
            ("random", "Customer.id", "t.tid", N_TAGS),
        ]),
    )


def a3_multiply() -> GCDIATask:
    """A3: matrix multiply — customer-tag incidence x tag co-occurrence."""
    return GCDIATask(
        integration=q_g1(),
        analytics=AnalyticsTask("MULTIPLY", [
            ("random", "Customer.id", "t.tid", N_TAGS),
        ]),
    )


def purchase_labels(db: Database, product_title: str = "Yogurt") -> np.ndarray:
    """Ground-truth labels for A1: 1 if the customer ever bought the
    product (computed across Product ⋈ Orders)."""
    prod = db.tables["Product"]
    orders = db.tables["Orders"]
    title_col = prod.col("title")
    pid = np.nonzero(title_col.codes == title_col.encode(product_title))[0]
    bought = np.isin(np.asarray(orders.col("product_id")), pid)
    labels = np.zeros(db.tables["Customer"].nrows, dtype=np.float32)
    labels[np.asarray(orders.col("customer_id"))[bought]] = 1.0
    return labels
