"""GCDA matrix generation: ms per GCDA task in RandomAccessMatrix and
Rel2Matrix."""
from gredo_bench import readers


def read(obs):
    return readers.ops_ms(obs, "gcda", readers.MATGEN)
