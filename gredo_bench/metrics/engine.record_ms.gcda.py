"""Engine and plan layer of GCDA tasks: ms per task in the engine's
``engine.record`` spans (operator statistics, the inter-buffer delta, the
flight recorder and the workload recorder, which every user pays)."""
from gredo_bench import readers

PHASE = "engine.record"


def read(obs):
    per_task = [[e - s for s, e, name in t["spans"] if name == PHASE]
                for t in readers.tasks_of(obs, "gcda")]
    if not any(per_task):
        return None
    return readers.mean_ms([sum(d) for d in per_task])
