"""The paper's own workload config: the GredoDB engine over the M2Bench-style
e-commerce scenario (not part of the assigned dry-run cells — the engine's
GCDA kernels are driven by ``chip_smoke.py`` and the tests; the GCDA cells
below are built by ``launch.specs._db_cell`` and traced by the dry-run)."""

FAMILY = "db"
# Bonus dry-run cells (beyond the assigned ones): the paper's GCDA operators
# at production scale, the same specs as the JAX package's.
SHAPES: dict = {
    "gcda_regression": {"kind": "gcda_regression", "rows": 4_194_304,
                        "features": 512},
    "gcda_similarity": {"kind": "gcda_similarity", "rows": 262_144,
                        "features": 256},
    "gcda_multiply": {"kind": "gcda_multiply", "m": 65_536, "k": 4_096,
                      "n": 65_536},
}


def config(sf: int = 1):
    from ..data import m2bench
    return {"sf": sf, "generator": m2bench.generate}


def smoke_config():
    return config(sf=1)
