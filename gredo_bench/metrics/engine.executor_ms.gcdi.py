"""Engine and plan layer of GCDI tasks: ms per task of the executor's own
work, the ``engine.execute`` span less the seconds of the operators it ran
(signatures, fingerprints, result sizes, memo and inter-buffer lookups)."""
from gredo_bench import readers

PHASE = "engine.execute"


def read(obs):
    tasks = readers.tasks_of(obs, "gcdi")
    spans = [[e - s for s, e, name in t["spans"] if name == PHASE]
             for t in tasks]
    if not any(spans):
        return None
    return readers.mean_ms([sum(d) - readers.op_seconds(t) if d else 0.0
                            for d, t in zip(spans, tasks)])
