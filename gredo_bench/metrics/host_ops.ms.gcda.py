"""Host operators of GCDA tasks: ms per task in executed operators that run
on the host (the integration's joins, matching, scans)."""
from gredo_bench import readers


def read(obs):
    return readers.host_ops_ms(obs, "gcda")
