"""The least time the card could take for an analytical operator or a
graph search, worked out from the task's shapes alone, and the peaks it
divides by.

Published NVIDIA H100 SXM peaks (data sheet, dense, 700 W): 495 TFLOP/s in
TF32, the fastest rate at which any product of float32 inputs can run, so
no implementation reads above 100%; 3.35 TB/s of HBM3. (Float32 outside the
tensor cores, FFMA, peaks at 67 TFLOP/s.) Each input is counted read once
and each output written once, in 4-byte floats (a search's ids and
distances in 4-byte integers).
"""
from __future__ import annotations

PEAK_FLOPS = 495e12
PEAK_FFMA_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def product_work(n: int, d: int) -> tuple[float, float]:
    """FLOPs and bytes of an N x N product of an N x d matrix with itself
    (MULTIPLY's Gram product, SIMILARITY's cosines)."""
    return 2.0 * n * n * d, 4.0 * (n * d + n * n)


def regression_work(n: int, d: int, iters: int) -> tuple[float, float]:
    """FLOPs and bytes of ``iters`` gradient steps of logistic regression
    over an N x d matrix: a forward and a gradient product per step; X, y
    and w read once."""
    return iters * 4.0 * n * d, 4.0 * (n * d + n + d)


def bfs_work(vertices: int, edges: int, pairs: int) -> tuple[float, float]:
    """FLOPs and bytes of a search for the hop distance of ``pairs``
    (source, target) pairs over a graph of ``vertices`` and ``edges``: no
    FLOPs; the forward CSR read once, 4 * (vertices + 1) bytes of row
    offsets and 4 * edges of neighbour ids, and each pair's two 4-byte ids
    read and its 4-byte distance written.

    The CSR is counted once, not once per source: a multi-source search
    that shares one pass over the CSR among all its sources is a sound
    implementation, and a bound multiplied by the sources would read above
    100% for it. So the share stays at or under 100% for every
    implementation, and a search per source reads low by up to the number
    of sources."""
    return 0.0, 4.0 * (vertices + 1) + 4.0 * edges + 12.0 * pairs


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
