"""Device GCDI: traversal-kernel launches per GCDI task (an exact count)."""
from gredo_bench import readers


def read(obs):
    return readers.hop_launches(obs)
