"""The port's tuple-at-a-time GCDA baseline (``analytics.volcano``, the
paper's §7.2 ablation): pure numpy, so bit-identical to the JAX package's on
the same inputs, and within the GCDA tolerances of the port's batch
operators (their plain PyTorch versions on the CPU)."""
import numpy as np
import pytest
import torch

from repro.core import analytics as ref_analytics
from repro.data import m2bench as ref_m2bench
from repro_torch.core import analytics
from repro_torch.data import m2bench

# the kernel sweeps' tolerances: matmul 2e-4; cosine and logreg rtol 3e-4,
# atol 3e-5
TOL = {"multiply": (2e-4, 2e-4), "similarity": (3e-4, 3e-5),
       "regression": (3e-4, 3e-5)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 6)).astype(np.float32)
    y = rng.standard_normal((6, 10)).astype(np.float32)
    z = rng.standard_normal((9, 6)).astype(np.float32)
    labels = (x @ rng.standard_normal(6) > 0).astype(np.float32)
    return x, y, z, labels


def _assert_bit_identical(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_rel2matrix_matches_reference_and_batch():
    db, rdb = m2bench.generate(sf=1, seed=3), ref_m2bench.generate(sf=1, seed=3)
    cols = ("id", "person_id", "age")
    t = db.tables["Customer"]
    small = type(t)("Customer", {c: np.asarray(t.col(c))[:50] for c in cols})
    rt = rdb.tables["Customer"]
    rsmall = type(rt)("Customer", {c: np.asarray(rt.col(c))[:50]
                                   for c in cols})
    got = analytics.volcano.rel2matrix(small, cols)
    _assert_bit_identical(got, ref_analytics.volcano.rel2matrix(rsmall, cols))
    _assert_bit_identical(got, analytics.rel2matrix(small, cols,
                                                    device="cpu").numpy())


def test_multiply_matches_reference_and_batch(inputs):
    x, y, _, _ = inputs
    got = analytics.volcano.multiply(x, y)
    _assert_bit_identical(got, ref_analytics.volcano.multiply(x, y))
    batch = analytics.multiply(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got, batch.numpy(), *TOL["multiply"])


def test_similarity_matches_reference_and_batch(inputs):
    x, _, z, _ = inputs
    got = analytics.volcano.similarity(x, z)
    _assert_bit_identical(got, ref_analytics.volcano.similarity(x, z))
    batch = analytics.similarity(torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(got, batch.numpy(), *TOL["similarity"])


@pytest.mark.parametrize("iters", [1, 5])
def test_regression_matches_reference_and_batch(inputs, iters):
    x, _, _, labels = inputs
    w, loss = analytics.volcano.regression(x, labels, iters=iters)
    rw, rloss = ref_analytics.volcano.regression(x, labels, iters=iters)
    _assert_bit_identical(w, rw)
    assert loss == rloss
    bw, bloss = analytics.regression(torch.from_numpy(x),
                                     torch.from_numpy(labels), iters=iters)
    np.testing.assert_allclose(w, bw.numpy(), *TOL["regression"])
    np.testing.assert_allclose(loss, float(bloss), *TOL["regression"])


def test_mesh_forms_still_raise(inputs):
    """The GCDA mesh forms, which raised until the mesh layer was ported,
    run on a 1x1 gloo mesh of this process and give the local operators'
    values (tests/test_torch_mesh.py holds them on 8 ranks)."""
    from repro_torch.launch.mesh import make_local_mesh
    from torch_spawn import world_of_one

    x, y, z, labels = (torch.from_numpy(a) for a in inputs)
    with world_of_one():
        mesh = make_local_mesh(1, 1, device="cpu")
        np.testing.assert_allclose(
            analytics.multiply(x, y, mesh=mesh).full_tensor().numpy(),
            analytics.multiply(x, y).numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            analytics.similarity(x, z, mesh=mesh).full_tensor().numpy(),
            analytics.similarity(x, z).numpy(), rtol=3e-4, atol=3e-5)
        w_d, loss_d = analytics.regression_distributed(x, labels, mesh,
                                                       iters=20)
    w_l, loss_l = analytics.regression(x, labels, iters=20)
    np.testing.assert_allclose(w_d.numpy(), w_l.numpy(), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(float(loss_d), float(loss_l), rtol=3e-4)