"""Shortest paths (M2Bench G6-G8, which the GredoDB paper counts as GCDI):
the hop distance between ``pairs`` (source, target) vertex pairs of one
graph, run through the program's ``GredoEngine.shortest_path``.

A task file (``queries/<task>.json``) reads::

    {"kind": "paths", "graph": "Follows", "src_label": "Persons",
     "dst_label": "Persons", "pairs": 8,
     "check": {"number": "pairs_mismatched", "limit": 0}}

The pairs of task ``i`` are drawn from the seed on a stream of their own,
before the task's clock starts: sources uniform over the source label's
vertices, targets uniform over the target label's. The check counts the
pairs whose distance differs from the reference's breadth-first search
over the edges after the accepted writes, followed in their direction,
with no bound on the depth (-1 where unreachable), summed over the kept
answers; an answer of another length counts every pair. The control reads
every edge both ways. A traced task's record gives the shapes a search's
least time is worked out from: ``pairs``, and the searched graph's
``vertices`` and ``edges`` as the program holds them, writes included.
"""
import numpy as np

from gredo_bench import reference, traffic

FAMILY = "gcdi"
STREAM = 4        # of the seed's streams: 1 task order, 2 write rows, 3 the sample
NUMBER = "pairs_mismatched"


def load(body: dict, find) -> dict:
    if body["check"]["number"] != NUMBER:
        raise ValueError(f"a paths task checks {NUMBER}, not "
                         f"{body['check']['number']}")
    return dict(body)


def args(task: dict, data: dict, seed: int, i: int) -> tuple:
    """``(source vids, target vids)`` of task ``i``."""
    g = data["graphs"][task["graph"]]["vertex_tables"]
    rng = traffic.rng(seed, STREAM, i)
    k = int(task["pairs"])
    return tuple(rng.integers(0, len(next(iter(g[label][1].values()))), k)
                 for label in (task["src_label"], task["dst_label"]))


def bind(api, task):
    eng = api.engine
    graph, src_label, dst_label = (task["graph"], task["src_label"],
                                   task["dst_label"])
    return lambda src, dst: eng.shortest_path(graph, src_label, src,
                                              dst_label, dst)


def pairs_mismatched(got, want: np.ndarray) -> int:
    got = np.asarray(got)
    if got.shape != want.shape:
        return max(got.size, want.size)
    return int((got != want).sum())


def check(task: dict, kept: list, run) -> tuple:
    worst = 0
    for i, got in kept:
        src, dst = args(task, run.data, run.seed, i)
        want = reference.shortest_paths(
            run.data, task["graph"], run.writes_upto(i), task["src_label"],
            src, task["dst_label"], dst)
        worst += pairs_mismatched(got, want)
    return NUMBER, worst, task["check"]["limit"]


def control(task: dict, data: dict, writes: list, args, device):
    src, dst = args
    return reference.shortest_paths(data, task["graph"], writes,
                                    task["src_label"], src,
                                    task["dst_label"], dst, both_ways=True)


def record(task: dict, prog) -> dict:
    """The shapes the search's roofline reader needs: the pair count and
    the graph's vertex and edge counts when the task ran."""
    vertices, edges = prog.graph_size(task["graph"])
    return {"pairs": int(task["pairs"]), "vertices": vertices,
            "edges": edges}
