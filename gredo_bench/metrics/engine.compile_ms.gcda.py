"""Engine and plan layer of GCDA tasks: ms per task in the engine's compile
phases, the sum of its ``engine.plan``, ``engine.build``,
``engine.optimize``, ``engine.shard`` and ``engine.estimate`` spans (the
optimizer's join enumeration is in ``engine.optimize``)."""
from gredo_bench import readers

PHASES = ("engine.plan", "engine.build", "engine.optimize", "engine.shard",
          "engine.estimate")


def read(obs):
    per_task = [[e - s for s, e, name in t["spans"] if name in PHASES]
                for t in readers.tasks_of(obs, "gcda")]
    if not any(per_task):
        return None
    return readers.mean_ms([sum(d) for d in per_task])
