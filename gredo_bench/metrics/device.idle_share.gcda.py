"""Device: share of the traced window in which no operation ran on the
card, in a GCDA cell, %."""
from gredo_bench import readers


def read(obs):
    return readers.idle_share(obs, "gcda")
