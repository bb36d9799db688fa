"""Rate, percentile and least-time arithmetic, the trace's interval
arithmetic, and the per-layer readers, on known inputs."""
from __future__ import annotations

import math

import numpy as np
import pytest

from gredo_bench import harness, readers, roofline, stats, trace, traffic


def test_percentile_is_nearest_rank_over_all_tasks():
    lat = list(range(1, 101))              # 1..100 ms
    assert stats.percentile(lat, 95) == 95
    assert stats.percentile(lat, 50) == 50
    assert stats.percentile([7], 95) == 7


def test_a_failed_task_misses_the_tail():
    lat = [1.0] * 95 + [math.inf] * 5
    assert stats.percentile(lat, 95) == 1.0
    assert stats.percentile(lat + [math.inf], 95) == math.inf


def test_rate_counts_all_work_over_all_time():
    assert stats.rate(300, 50.0) == 6.0


def test_product_least_time_at_sf10_is_bound_by_bytes():
    flops, nbytes = roofline.product_work(15910, 200)
    assert flops == 2 * 15910**2 * 200
    assert nbytes == 4 * (15910 * 200 + 15910**2)
    t = roofline.least_seconds(flops, nbytes)
    assert t == pytest.approx(nbytes / 3.35e12)
    assert t == pytest.approx(3.0595e-4, rel=1e-3)


def test_regression_least_time():
    flops, nbytes = roofline.regression_work(15910, 200, 100)
    assert flops == 100 * 4 * 15910 * 200
    assert nbytes == 4 * (15910 * 200 + 15910 + 200)
    assert roofline.least_seconds(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)


def test_compute_bound_shape():
    flops, nbytes = 1e15, 1.0
    assert roofline.least_seconds(flops, nbytes) == pytest.approx(1e15 / 495e12)


def _obs():
    gcdi = {"name": "G3", "kind": "gcdi", "wall_s": 0.010, "write_s": 0.0,
            "ops": [("EquiJoin", 0.004), ("DeviceMatchPattern", 0.002)],
            "hops": 2}
    gcdi2 = {"name": "G1", "kind": "gcdi", "wall_s": 0.020, "write_s": 0.0,
             "ops": [("EquiJoin", 0.012)], "hops": 0}
    gcda = {"name": "A2", "kind": "gcda", "wall_s": 0.050, "write_s": 0.001,
            "ops": [("EquiJoin", 0.010), ("RandomAccessMatrix", 0.005),
                    ("Similarity", 0.020)], "hops": 0,
            "n": 15910, "d": 200, "iters": 1}
    return {"tasks": [gcdi, gcdi2, gcda],
            "device": {"busy_s": 1.0, "window_s": 4.0}}


def test_readers_split_each_task():
    obs = _obs()
    assert readers.outside_ops_ms(obs, "gcdi") == pytest.approx(6.0)
    assert readers.host_ops_ms(obs, "gcdi") == pytest.approx(8.0)
    assert readers.ops_ms(obs, "gcdi", readers.DEVICE_GCDI) == \
        pytest.approx(1.0)
    assert readers.hop_launches(obs) == 1.0
    assert readers.outside_ops_ms(obs, "gcda") == pytest.approx(14.0)
    assert readers.ops_ms(obs, "gcda", readers.MATGEN) == pytest.approx(5.0)
    least = roofline.least_seconds(*roofline.product_work(15910, 200))
    assert readers.roofline_share(obs, readers.PRODUCTS) == \
        pytest.approx(100 * least / 0.020)
    assert readers.idle_share(obs, "gcda") == pytest.approx(75.0)


def test_readers_with_nothing_to_read_return_none():
    obs = {"tasks": [t for t in _obs()["tasks"] if t["kind"] == "gcdi"]}
    assert readers.roofline_share(obs, readers.REGRESSION) is None
    assert readers.ops_ms(obs, "gcda", readers.MATGEN) is None
    assert readers.idle_share(obs, "gcdi") is None


def test_every_seed_sends_the_same_mix():
    mix = {"tasks": {"G1": 1, "G2": 2}, "clients": 1}
    counts = set()
    for seed in (0, 2**31 + 5, 3 * 2**40, -7):
        t = traffic.Traffic(mix, seed, {})
        seq = [t.task(i) for i in range(30)]
        counts.add((seq.count("G1"), seq.count("G2")))
    assert counts == {(10, 20)}


def test_writes_are_drawn_from_the_seed():
    data = {"graphs": {"g": {"src_label": "A", "dst_label": "B",
                             "vertex_tables": {"A": ("A", {"x": np.arange(7)}),
                                               "B": ("B", {"y": np.arange(3)})},
                             "edges": ("E", {})}}}
    mix = {"tasks": {"T": 1}, "clients": 1,
           "write": {"graph": "g", "rows": 64,
                     "columns": {"weight": ["uniform", 0.0, 1.0]}}}
    a, b = traffic.Traffic(mix, 9, data), traffic.Traffic(mix, 9, data)
    wa, wb = a.write(3)[1], b.write(3)[1]
    assert all(np.array_equal(wa[k], wb[k]) for k in wa)
    assert wa["svid"].max() < 7 and wa["tvid"].max() < 3
    assert len(a.writes_upto(3)) == 4


@pytest.mark.parametrize("a, b, want", [
    ([[0, 10]], [[2, 3], [5, 12]], [[2, 3], [5, 10]]),
    ([[0, 4], [6, 9]], [[3, 7]], [[3, 4], [6, 7]]),
    ([[0, 4]], [[4, 6]], []),
    ([], [[0, 1]], []),
])
def test_intervals_intersect(a, b, want):
    assert trace.intersect(a, b) == want


def test_the_window_leaves_out_the_checks_copies():
    paused = [(20, 30, "c"), (25, 40, "c"), (90, 120, "c")]
    assert trace.window_segments(0, 100, paused) == [[0, 20], [40, 90]]
    assert trace.window_segments(0, 100, []) == [[0, 100]]


def test_a_kept_answer_on_the_host_is_kept_as_it_is():
    import torch
    x = torch.ones(3)
    assert harness.to_host(x) is x
    s = harness.Sample({"A": 1}, 5)
    for i in range(4):
        s.offer("A", i, torch.full((2,), float(i)))
    assert len(s.kept["A"]) == 1 and s.seen["A"] == 4
