"""The readers of the engine's phase spans: on known task records, and on a
traced run of each cell at SF 1 on the CPU, where the phases they read and
the telemetry's own spans fit inside the engine's remainder."""
from __future__ import annotations

import pytest

from gredo_bench import harness, readers

KINDS = {"ecom_sf10.gcdi": "gcdi", "ecom_sf40.gcda": "gcda"}
LAYERS = ("engine.compile_ms", "engine.executor_ms", "engine.record_ms")


def reader(metric: str):
    return harness.load_reader(harness.HERE, metric)


def task(kind, spans, ops=(), wall=1.0):
    return {"name": "T", "kind": kind, "t0": 0.0, "wall_s": wall,
            "write_s": 0.0, "ops": list(ops), "hops": 0, "spans": spans}


@pytest.mark.parametrize("kind", ["gcdi", "gcda"])
def test_readers_on_known_records(kind):
    spans = [(0.00, 0.01, "engine.telemetry"), (0.01, 0.02, "engine.record"),
             (0.02, 0.05, "engine.plan"), (0.05, 0.06, "engine.build"),
             (0.06, 0.10, "engine.optimize"), (0.10, 0.11, "engine.shard"),
             (0.11, 0.12, "engine.estimate"), (0.12, 0.32, "engine.execute"),
             (0.13, 0.20, "EquiJoin"), (0.21, 0.30, "MatchPattern"),
             (0.32, 0.34, "engine.record"), (0.34, 0.35, "engine.telemetry"),
             (0.35, 0.38, "engine.record")]
    ops = [("EquiJoin", 0.06), ("MatchPattern", 0.08)]
    other = "gcda" if kind == "gcdi" else "gcdi"
    obs = {"tasks": [task(kind, spans, ops), task(other, spans, ops),
                     task(kind, [], [], wall=0.0)],
           "device": None}
    # two tasks of the kind, the second (failed) with nothing: half of one
    assert reader(f"engine.compile_ms.{kind}")(obs) == pytest.approx(50.0)
    assert reader(f"engine.executor_ms.{kind}")(obs) == pytest.approx(30.0)
    assert reader(f"engine.record_ms.{kind}")(obs) == pytest.approx(30.0)


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("kind", ["gcdi", "gcda"])
def test_readers_find_nothing_without_phase_spans(kind, layer):
    """A program that records only operator spans (and a window with no
    task of the kind) reads None."""
    ops_only = {"tasks": [task(kind, [(0.1, 0.2, "EquiJoin")],
                               [("EquiJoin", 0.1)])], "device": None}
    assert reader(f"{layer}.{kind}")(ops_only) is None
    other = "gcda" if kind == "gcdi" else "gcdi"
    no_kind = {"tasks": [task(other, [(0.0, 0.1, "engine.plan"),
                                      (0.1, 0.2, "engine.execute"),
                                      (0.2, 0.3, "engine.record")])],
               "device": None}
    assert reader(f"{layer}.{kind}")(no_kind) is None


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_traced_run_reads_every_phase_metric(cell, monkeypatch):
    """A traced run at SF 1 on the CPU: the three metrics of the cell's kind
    read, and with the telemetry's own spans they add up to no more than
    the engine's remainder (``engine.outside_ops_ms``) of the same run."""
    seen = {}
    load = harness.load_reader

    def keeping(root, metric):
        read = load(root, metric)

        def kept(obs):
            seen["obs"] = obs
            return read(obs)
        return kept
    monkeypatch.setattr(harness, "load_reader", keeping)
    r = harness.run(cell, 2**31 + 91, 0.3, True, device="cpu",
                    scale={"sf": 1}, quiet=True)
    assert r["correct"], r["checks"]
    kind = KINDS[cell]
    got = {layer: r["metrics"][f"{layer}.{kind}"]["value"] for layer in LAYERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    tasks = readers.tasks_of(seen["obs"], kind)
    telemetry_ms = readers.mean_ms(
        [sum(e - s for s, e, name in t["spans"] if name == "engine.telemetry")
         for t in tasks])
    outside = r["metrics"][f"engine.outside_ops_ms.{kind}"]["value"]
    assert telemetry_ms > 0
    assert sum(got.values()) + telemetry_ms <= outside + 1e-9
