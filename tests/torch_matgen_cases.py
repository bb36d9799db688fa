"""Inputs of random-access matrix generation, shared by the CPU test
(``test_torch_kernels.py``) and the card test (``test_torch_gpu.py``).

Each case is a Table with a group column ``g`` and a value column ``v``,
made from records (a group id and a list of values): the ragged layout
keeps the lists as a RaggedColumn, the plain one holds one row per pair.
Values include negatives, values at and past the widths tested (1 and 200)
and duplicate pairs."""
import numpy as np

from repro_torch.core.storage import RaggedColumn, Table

# dense ids, ids spread far apart (negative, up to 10^12 apart), one
# group, no pairs, float values (NaN, -0.5, fractions) over int32 ids
KINDS = ("dense", "sparse", "one_group", "empty", "float_values")
LAYOUTS = ("plain", "ragged")
MODES = ("multi_hot", "count")
WIDTHS = (1, 200)
# G1's shape at M2Bench SF 40: 80,000 customers, each with Poisson(8)
# interests clipped to [1, 40] over 200 tags, of which the 40 food tags
# qualify: about 128K pairs over about 63.9K customers
G1_SF40 = "g1_sf40"


def _records(kind: str, rng) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    if kind == G1_SF40:
        g = np.arange(80_000, dtype=np.int64)
        lens = rng.binomial(np.clip(rng.poisson(8, g.size), 1, 40), 0.2)
        return g, lens, rng.integers(0, 40, int(lens.sum()))
    n = {"empty": 0, "one_group": 30}.get(kind, 200)
    lens = rng.integers(1 if kind == "one_group" else 0, 6, n)
    k = int(lens.sum())
    if kind == "float_values":
        v = rng.uniform(-2.0, 210.0, k)
        v[::5] = 0.3
        v[::7] = np.nan
        v[::11] = -0.5
        return rng.integers(0, 120, n).astype(np.int32), lens, v
    v = np.where(rng.random(k) < 0.5, rng.integers(-3, 4, k),
                 rng.integers(0, 205, k))
    if kind == "sparse":
        g = rng.integers(0, 50, n) * 1_000_003 - 10**12
    elif kind == "one_group":
        g = np.full(n, 7, dtype=np.int64)
    else:
        g = rng.integers(-20, 100, n)
    return g, lens, v


def case_table(kind: str, layout: str, seed: int = 0) -> Table:
    g, lens, v = _records(kind, np.random.default_rng(seed))
    if layout == "ragged":
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        return Table("t", {"g": g, "v": RaggedColumn(values=v,
                                                     offsets=offsets)})
    return Table("t", {"g": np.repeat(g, lens), "v": v})
