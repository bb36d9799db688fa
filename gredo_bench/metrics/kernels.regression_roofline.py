"""Kernels: the regression's least time over its fenced seconds, %."""
from gredo_bench import readers


def read(obs):
    return readers.roofline_share(obs, readers.REGRESSION)
