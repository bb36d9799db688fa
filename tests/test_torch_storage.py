"""Port storage parity: ``repro_torch.data.m2bench.generate`` builds
column-identical databases to the JAX package's, and
``repro_torch.core.storage.database_from_arrays`` carries a JAX-package
database across (after inserts, deletes and ``compact()``) and refuses one
with pending deltas."""
import numpy as np
import pytest

from repro.core import GredoEngine as JaxEngine
from repro.core.observe import result_fingerprint as jax_fingerprint
from repro.data import m2bench as jm
from repro_torch.core import GredoEngine as TorchEngine
from repro_torch.core.observe import result_fingerprint
from repro_torch.core.storage import database_from_arrays
from repro_torch.data import m2bench as tm


def _col_spec(c):
    if hasattr(c, "codes"):
        return {"codes": np.asarray(c.codes), "vocab": np.asarray(c.vocab)}
    if hasattr(c, "offsets"):
        return {"values": np.asarray(c.values),
                "offsets": np.asarray(c.offsets)}
    return np.asarray(c)


def _table_spec(t):
    return {k: _col_spec(v) for k, v in t.columns.items()}


def export(db) -> dict:
    """A JAX-package database as the plain-array spec of
    ``database_from_arrays`` (graph bases, epochs and pending-write
    counts)."""
    graphs = {}
    for name, g in db.graphs.items():
        st = g.delta.stats()
        graphs[name] = {
            "vertex_tables": {lbl: (t.name, _table_spec(t))
                              for lbl, t in g.vertex_tables.items()},
            "edges": (g.edges.name, _table_spec(g.edges)),
            "src_label": g.src_label, "dst_label": g.dst_label,
            "epoch": g.epoch, "compactions": g.compactions,
            "pending_writes": (st["delta_edges"] + st["delta_vertices"]
                               + st["tombstones"]),
        }
    return {"tables": {n: _table_spec(t) for n, t in db.tables.items()},
            "graphs": graphs, "epochs": dict(db._table_epochs)}


def _assert_col_equal(where, a, b):
    assert type(a).__name__ == type(b).__name__, where
    if hasattr(a, "codes"):
        np.testing.assert_array_equal(a.codes, b.codes, err_msg=where)
        assert a.codes.dtype == b.codes.dtype, where
        assert list(a.vocab) == list(b.vocab), where
    elif hasattr(a, "offsets"):
        np.testing.assert_array_equal(a.values, b.values, err_msg=where)
        np.testing.assert_array_equal(a.offsets, b.offsets, err_msg=where)
        assert np.asarray(a.values).dtype == np.asarray(b.values).dtype, where
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def _assert_table_equal(where, a, b):
    assert a.name == b.name and a.nrows == b.nrows, where
    assert list(a.columns) == list(b.columns), where
    for c in a.columns:
        _assert_col_equal(f"{where}.{c}", a.col(c), b.col(c))


def assert_db_equal(jdb, tdb):
    assert list(jdb.tables) == list(tdb.tables)
    for name in jdb.tables:
        _assert_table_equal(name, jdb.tables[name], tdb.tables[name])
    assert list(jdb.graphs) == list(tdb.graphs)
    for name in jdb.graphs:
        jg, tg = jdb.graphs[name], tdb.graphs[name]
        assert (jg.labels, jg.src_label, jg.dst_label) == \
            (tg.labels, tg.src_label, tg.dst_label)
        for lbl in jg.labels:
            _assert_table_equal(f"{name}:{lbl}", jg.vertex_tables[lbl],
                                tg.vertex_tables[lbl])
        _assert_table_equal(f"{name}:edges", jg.edges, tg.edges)
        for side in ("fwd", "rev"):
            for arr in ("row_ptr", "col_idx", "edge_id"):
                a = getattr(getattr(jg, side), arr)
                b = getattr(getattr(tg, side), arr)
                assert a.dtype == b.dtype, (name, side, arr)
                np.testing.assert_array_equal(a, b)
        assert jdb.epoch_of(name) == tdb.epoch_of(name)
    for name in jdb.tables:
        assert jdb.epoch_of(name) == tdb.epoch_of(name)


@pytest.mark.parametrize("seed", [7, 0])
def test_generate_is_column_identical(seed):
    assert_db_equal(jm.generate(sf=1, seed=seed), tm.generate(sf=1, seed=seed))


def test_generate_skew_is_column_identical():
    assert_db_equal(jm.generate_skew(sf=1, seed=7),
                    tm.generate_skew(sf=1, seed=7))


def _write_burst(db):
    """Inserts and deletes on both graphs, then compact (renumbers tids)."""
    f = db.graphs["Follows"]
    f.insert_edges({"svid": np.array([0, 1, 2]), "tvid": np.array([5, 6, 7]),
                    "since": np.array([2001, 2002, 2003])})
    f.delete_edges(np.array([0, 3, 10, 11]))
    f.insert_vertices("Persons", {"pid": np.array([90001, 90002]),
                                  "country": ["au", "uk"]})
    f.insert_edges({"svid": np.array([2500, 2501]),
                    "tvid": np.array([1, 2500]),
                    "since": np.array([2020, 2021])})
    i = db.graphs["Interested_in"]
    i.delete_edges(np.arange(0, 40, 3))
    i.insert_edges({"svid": np.array([4, 4]), "tvid": np.array([0, 1]),
                    "weight": np.array([0.95, 0.5])})


def test_database_from_arrays_round_trips_after_writes_and_compact():
    jdb = jm.generate(sf=1, seed=7)
    _write_burst(jdb)
    for g in jdb.graphs.values():
        g.compact()
    tdb = database_from_arrays(export(jdb))
    assert_db_equal(jdb, tdb)
    # the carried state answers queries exactly as the reference does,
    # which a fresh generate() (different tids and epochs) cannot
    jeng = JaxEngine(jdb)
    teng = TorchEngine(tdb, device="cpu")
    for q in (jm.q_g3(), jm.q_g5(), jm.q_g1()):
        assert jax_fingerprint(jeng.query(q)) == \
            result_fingerprint(teng.query(q))
    fresh = TorchEngine(tm.generate(sf=1, seed=7), device="cpu")
    assert result_fingerprint(fresh.query(tm.q_g3())) != \
        result_fingerprint(teng.query(tm.q_g3()))


def test_database_from_arrays_refuses_pending_deltas():
    jdb = jm.generate(sf=1, seed=7)
    _write_burst(jdb)
    spec = export(jdb)
    assert spec["graphs"]["Follows"]["pending_writes"] > 0
    with pytest.raises(ValueError, match="pending delta writes"):
        database_from_arrays(spec)


def test_database_from_arrays_plain_tables_and_epochs():
    spec = {"tables": {"T": {"a": np.arange(4, dtype=np.int64),
                             "s": {"codes": np.array([1, 0, 1, 1]),
                                   "vocab": np.array(["x", "y"], object)},
                             "r": {"values": np.array([1, 2, 3]),
                                   "offsets": np.array([0, 1, 1, 3, 3])}}},
            "epochs": {"T": 3}}
    db = database_from_arrays(spec)
    t = db.tables["T"]
    assert t.nrows == 4 and db.epoch_of("T") == 3
    assert list(t.col("s").decode(t.col("s").codes)) == ["y", "x", "y", "y"]
    assert t.col("r").row(2).tolist() == [2, 3]
