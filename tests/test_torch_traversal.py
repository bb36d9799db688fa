"""The port's device GCDI path (``core.pattern_jit`` + the traversal chain
runners) on the CPU, held against the JAX package on graphs built from the
same numpy arrays: host == per-hop == fused path, identical relations and
span payloads to the reference, overflow retry, epoch staleness and the
runtime fallback."""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import pattern as jax_pattern
from repro.core import pattern_jit as jax_pjit
from repro.core import schema as jax_schema
from repro.core import storage as jax_storage
from repro.core.observe import result_fingerprint as jax_fingerprint
from repro_torch.core import GredoEngine, physical
from repro_torch.core import pattern, pattern_jit, schema, storage
from repro_torch.core.observe import result_fingerprint
from repro_torch.data import m2bench

CPU = "cpu"


def _mk_graph(seed, st=storage, n_a=20, n_b=10, n_e=80):
    rng = np.random.default_rng(seed)
    A = st.Table("A", {"attr": rng.integers(0, 3, n_a)})
    B = st.Table("B", {"attr": rng.integers(0, 3, n_b)})
    E = st.Table("E", {"svid": rng.integers(0, n_a, n_e),
                       "tvid": rng.integers(0, n_b, n_e),
                       "w": rng.integers(0, 10, n_e)})
    return st.Graph("G", {"A": A, "B": B}, E, "A", "B")


def _plan(g, sch, pat_mod, vpred=None, wcut=None):
    pat = sch.chain_pattern("G", ("x", "A", "E", "y", "B"))
    phi = {}
    if vpred is not None:
        phi["y"] = [sch.Predicate("y.attr", "==", vpred)]
    if wcut is not None:
        phi["e0"] = [sch.Predicate("e0.w", "<=", wcut)]
    return pat_mod.plan_pattern(g, pat, phi, projected=set(),
                                force_reverse=False, enable_pushdown=True)


def _rows(t):
    cols = sorted(t.columns)
    return sorted(zip(*(np.asarray(t.col(c)).tolist() for c in cols)))


@pytest.mark.parametrize("seed,vpred,wcut,delete_some", [
    (0, None, None, False), (1, 0, None, False), (2, None, 3, False),
    (3, 1, 7, False), (4, 2, 3, True), (5, None, None, True),
    (6, 0, 7, True), (7, 1, None, True)])
def test_three_way_equivalence_and_reference_parity(seed, vpred, wcut,
                                                    delete_some):
    g, jg = _mk_graph(seed), _mk_graph(seed, jax_storage)
    if delete_some:
        dead = np.random.default_rng(seed + 1).choice(80, 9, replace=False)
        for gr in (g, jg):
            gr.delete_edges(dead)
            gr.compact()        # device snapshots read base CSRs only
    plan = _plan(g, schema, pattern, vpred, wcut)
    host = _rows(pattern.match(g, plan))
    jit_rel, _ = pattern_jit.device_match(g, plan, flavor="jit",
                                          initial_capacity=128, device=CPU)
    rel, kargs = pattern_jit.device_match(g, plan, flavor="pallas",
                                          initial_capacity=128, device=CPU)
    assert _rows(jit_rel) == host and _rows(rel) == host
    # the reference's fused path gives the same relation, row order and
    # dtypes included, and the same launch facts in its span payload
    jrel, jkargs = jax_pjit.device_match(
        jg, _plan(jg, jax_schema, jax_pattern, vpred, wcut), flavor="pallas",
        initial_capacity=128)
    assert result_fingerprint(rel) == jax_fingerprint(jrel)
    for evar in ("e0",):
        assert np.asarray(rel.col(evar)).dtype == np.int32
    kept = {k: v for k, v in kargs.items() if not k.startswith("zone")}
    assert set(kept) == {"hops", "capacity", "flavor"}
    assert kept == {k: jkargs[k] for k in kept}


def test_jit_overflow_retry_counts_recompiles():
    g = _mk_graph(3)
    m = pattern_jit.DevicePatternMatcher(g, initial_capacity=16, device=CPU)
    lo, hi = g.label_range("A")
    m.match_chain(np.arange(lo, hi), [None], [None])
    assert m.recompiles >= 1 and m.last_capacity > 16


def test_fused_overflow_retry_counts_capacities():
    g = _mk_graph(4, n_e=500)          # ~500 candidates >> capacity 128
    plan = _plan(g, schema, pattern)
    before = pattern_jit.COUNTERS.retries
    rel, kargs = pattern_jit.device_match(g, plan, flavor="pallas",
                                          initial_capacity=128, device=CPU)
    assert pattern_jit.COUNTERS.retries > before
    assert any(cap > 128 for cap in pattern_jit.COUNTERS.retry_caps)
    assert kargs["capacity"] > 128
    assert _rows(rel) == _rows(pattern.match(g, plan))


def test_stale_snapshot_refused_then_refreshed():
    g = _mk_graph(5)
    m = pattern_jit.get_matcher(g, device=CPU)
    lo, hi = g.label_range("A")
    epoch0 = m.epoch
    g.insert_edges({"svid": np.array([0, 1]), "tvid": np.array([0, 1]),
                    "w": np.array([1, 2])})
    with pytest.raises(pattern_jit.StaleSnapshotError):
        m.match_chain(np.arange(lo, hi), [None], [None])
    with pytest.raises(pattern_jit.StaleSnapshotError):
        pattern_jit.device_match(g, _plan(g, schema, pattern),
                                 flavor="pallas", device=CPU)
    g.compact()
    cols, _ = m.match_chain(np.arange(lo, hi), [None], [None])
    assert m.epoch == g.epoch > epoch0 and m.refreshes >= 1
    assert len(cols[0]) == g.n_live_edges     # unconstrained 1-hop == edges


def test_runtime_fallback_on_pending_delta():
    g = _mk_graph(6)
    plan = _plan(g, schema, pattern)
    node = physical.DeviceMatchPattern("G", g.epoch, plan, capacity=128)
    g.insert_edges({"svid": np.array([2]), "tvid": np.array([2]),
                    "w": np.array([5])})
    out = node.run(SimpleNamespace(db=SimpleNamespace(graphs={"G": g}),
                                   device=CPU))
    assert node.access == "host-fallback"
    assert _rows(out) == _rows(pattern.match(g, plan))


def test_device_query_registry_delta_and_explain():
    eng = GredoEngine(m2bench.generate(sf=1), telemetry=True, device=CPU)
    eng.query(m2bench.q_g3())
    d = eng.last_registry_delta
    assert d.get("traversal_kernels.matches", 0) >= 1
    assert d.get("traversal_kernels.kernel.launches", 0) >= 1
    txt = eng.explain_last()
    assert "traversal kernels (this query):" in txt
    assert "via device-pallas" in txt
    spans = [s for s in eng.telemetry.collector.last().spans
             if s.name == "DeviceMatchPattern"]
    args = spans[0].args
    assert args["hops"] >= 1 and args["capacity"] >= 128
    assert 0 <= args["zone_chunks_alive"] <= args["zone_chunks_total"]
    assert args["dispatch_s"] >= 0 and "sync_s" in args
    assert not {"flops", "bytes", "in_shapes"} & set(args)
