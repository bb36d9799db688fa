"""Kernels: the N x N products' least time over their fenced seconds, %."""
from gredo_bench import readers


def read(obs):
    return readers.roofline_share(obs, readers.PRODUCTS)
