"""The M2Bench e-commerce data, drawn as plain numpy arrays from a seed.

A frozen copy of the arithmetic of the repository's generator (the same
entity counts per scale factor, value ranges and degree laws), drawn
vectorised: the same distributions, not the same draws. The arrays are
handed to the program through its public ``storage.database_from_arrays``
and, unchanged, to the plain reference (``reference.py``), so both sides
read one data set. Nothing here imports the program.

The layout is the one ``database_from_arrays`` reads: a string column is
``{"codes", "vocab"}`` (vocab sorted, as a dictionary column builds it), a
list column ``{"values", "offsets"}``, anything else a numpy array.
"""
from __future__ import annotations

import numpy as np

PRODUCT_TITLES = ("Yogurt", "Milk", "Bread", "Coffee", "Tea", "Chocolate",
                  "Laptop", "Phone", "Book", "Desk")
CITIES = ("wuhan", "beijing", "shanghai", "shenzhen", "chengdu")
COUNTRIES = ("cn", "us", "au", "uk")


def dict_column(strings: np.ndarray) -> dict:
    """A string column in dictionary form, vocab sorted."""
    vocab, codes = np.unique(np.asarray(strings, dtype=object),
                             return_inverse=True)
    return {"codes": codes.astype(np.int32), "vocab": vocab}


def decode(col) -> np.ndarray:
    """The values of a column in any of the three forms, as one array."""
    if isinstance(col, dict) and "codes" in col:
        return np.asarray(col["vocab"], dtype=object)[col["codes"]]
    return np.asarray(col)


def _labels(prefix: str, n: int) -> np.ndarray:
    return np.char.add(prefix, np.arange(n).astype(str)).astype(object)


def generate(cfg: dict, seed: int) -> dict:
    """The data set of configuration ``cfg`` (its ``scale`` block) drawn
    from ``seed``: ``{"tables": ..., "graphs": ...}``."""
    s = cfg["scale"]
    sf = int(s["sf"])
    rng = np.random.default_rng(seed)
    n_products = s["products_per_sf"] * sf
    n_customers = s["customers_per_sf"] * sf
    n_orders = s["orders_per_sf"] * sf
    n_persons = n_customers + s["extra_persons_per_sf"] * sf
    n_tags = s["tags"]
    n_food = s["food_tags"]

    i = np.arange(n_products)
    titles = np.asarray(PRODUCT_TITLES, dtype=object)[i % len(PRODUCT_TITLES)]
    suffix = np.where(i >= len(PRODUCT_TITLES),
                      np.char.add(" v", (i // len(PRODUCT_TITLES)).astype(str)),
                      "").astype(object)
    product = {"id": i.astype(np.int64),
               "title": dict_column(titles + suffix),
               "price": rng.uniform(1, 500, n_products).round(2)}
    customer = {
        "id": np.arange(n_customers, dtype=np.int64),
        "person_id": rng.permutation(n_persons)[:n_customers].astype(np.int64),
        "name": dict_column(_labels("cust_", n_customers)),
        "age": rng.integers(18, 80, n_customers).astype(np.int64),
    }

    n_items = rng.integers(1, 4, n_orders)
    offsets = np.zeros(n_orders + 1, dtype=np.int64)
    np.cumsum(n_items, out=offsets[1:])
    orders = {
        "order_id": np.arange(n_orders, dtype=np.int64),
        "customer_id": rng.integers(0, n_customers, n_orders).astype(np.int64),
        "product_id": rng.integers(0, n_products, n_orders).astype(np.int64),
        "quantity": rng.integers(1, 5, n_orders).astype(np.int64),
        "shipping.city": dict_column(np.asarray(CITIES, dtype=object)[
            rng.integers(0, len(CITIES), n_orders)]),
        "shipping.days": rng.integers(1, 10, n_orders).astype(np.int64),
        "items": {"values": rng.integers(0, n_tags, int(offsets[-1])
                                         ).astype(np.int64),
                  "offsets": offsets},
    }

    persons = {"pid": np.arange(n_persons, dtype=np.int64),
               "country": dict_column(np.asarray(COUNTRIES, dtype=object)[
                   np.arange(n_persons) % len(COUNTRIES)])}
    content = np.concatenate([np.full(n_food, "food", dtype=object),
                              _labels("topic_", n_tags - n_food)])
    tags = {"tid": np.arange(n_tags, dtype=np.int64),
            "content": dict_column(content),
            "popularity": rng.uniform(0, 1, n_tags)}
    lo, hi = s["interest_degree_clip"]
    deg = rng.poisson(s["interest_degree_mean"], n_persons).clip(lo, hi)
    src = np.repeat(np.arange(n_persons, dtype=np.int64), deg)
    interested = {"svid": src,
                  "tvid": rng.integers(0, n_tags, len(src)).astype(np.int64),
                  "weight": rng.uniform(0, 1, len(src))}

    lo, hi = s["follow_degree_clip"]
    fdeg = rng.poisson(s["follow_degree_mean"], n_persons).clip(lo, hi)
    fsrc = np.repeat(np.arange(n_persons, dtype=np.int64), fdeg)
    fdst = rng.integers(0, n_persons, len(fsrc)).astype(np.int64)
    keep = fsrc != fdst
    follows = {"svid": fsrc[keep], "tvid": fdst[keep],
               "since": rng.integers(2000, 2026, int(keep.sum())
                                     ).astype(np.int64)}

    return {
        "tables": {"Product": product, "Customer": customer,
                   "Orders": orders},
        "graphs": {
            "Interested_in": {
                "vertex_tables": {"Persons": ("Persons", persons),
                                  "Tags": ("Tags", tags)},
                "edges": ("Interested_in_edges", interested),
                "src_label": "Persons", "dst_label": "Tags"},
            "Follows": {
                "vertex_tables": {"Persons": ("Persons", dict(persons))},
                "edges": ("Follows_edges", follows),
                "src_label": "Persons", "dst_label": "Persons"},
        },
    }
