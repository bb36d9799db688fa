"""Engine and plan layer of GCDI tasks: ms per task outside every executed
operator and the write (parse, plan, optimise, lower, the flight recorder)."""
from gredo_bench import readers


def read(obs):
    return readers.outside_ops_ms(obs, "gcdi")
