"""Host operators of GCDI tasks: ms per task in executed operators that run
on the host (joins, host matching, scans, projections)."""
from gredo_bench import readers


def read(obs):
    return readers.host_ops_ms(obs, "gcdi")
