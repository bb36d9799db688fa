"""Device GCDI: ms per GCDI task in the traversal-kernel pattern operator."""
from gredo_bench import readers


def read(obs):
    return readers.ops_ms(obs, "gcdi", readers.DEVICE_GCDI)
