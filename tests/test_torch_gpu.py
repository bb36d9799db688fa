"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the card at the reference sweep shapes, the wrappers' input
checks, and the engine on the card against the same engine on the CPU.
Skipped where there is no card; run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports neither JAX nor the JAX package (the card's machine runs the port
alone). Tolerances: fp32 matmul 2e-4, bf16 2e-2; cosine and logreg rtol
3e-4 / atol 3e-5 (different summation order); traversal exact."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, wrapper_module
from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
from repro_torch.kernels.logreg.ref import logreg_grad_ref
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.traversal import ref as tref

pytestmark = pytest.mark.gpu
RNG = np.random.default_rng(42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def kernel(name):
    """The kernel's wrapper (it launches; it never dispatches)."""
    return getattr(wrapper_module(name), name)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (128, 128, 128),
                                   (100, 60, 130), (257, 129, 65)])
def test_matmul_kernel_matches_plain(cuda, m, k, n, dtype, transposed):
    x = torch.as_tensor(RNG.standard_normal((m, k)), device=cuda).to(dtype)
    if transposed:
        y = torch.as_tensor(RNG.standard_normal((n, k)),
                            device=cuda).to(dtype).T
    else:
        y = torch.as_tensor(RNG.standard_normal((k, n)), device=cuda).to(dtype)
    before = launch_counts()["matmul"]
    got = kernel("matmul")(x, y)
    assert launch_counts()["matmul"] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), matmul_ref(x, y).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,n,d", [(64, 64, 32), (100, 50, 96), (33, 65, 17)])
def test_cosine_kernel_matches_plain(cuda, m, n, d):
    x = torch.as_tensor(RNG.standard_normal((m, d)), device=cuda).float()
    y = torch.as_tensor(RNG.standard_normal((n, d)), device=cuda).float()
    torch.testing.assert_close(kernel("cosine_sim")(x, y),
                               cosine_sim_ref(x, y), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("n,d", [(100, 16), (512, 64), (65, 7)])
def test_logreg_kernel_matches_plain(cuda, n, d):
    x = torch.as_tensor(RNG.standard_normal((n, d)), device=cuda).float()
    y = torch.as_tensor(RNG.integers(0, 2, n), device=cuda).float()
    w = torch.as_tensor(RNG.standard_normal(d) * 0.3, device=cuda).float()
    g1, l1 = kernel("logreg_grad")(x, y, w)
    g2, l2 = logreg_grad_ref(x, y, w)
    torch.testing.assert_close(g1, g2, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(l1, l2, rtol=3e-4, atol=3e-5)


def _hop_tables(seed, n, dev, chunk=8):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, n)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    m = int(row_ptr[-1])
    edge_pred = rng.random(max(m, 1)) < 0.6
    alive = np.array([edge_pred[c * chunk:(c + 1) * chunk].any()
                      for c in range(max(-(-max(m, 1) // chunk), 1))])
    arrays = (row_ptr, rng.integers(0, n, m).astype(np.int32),
              rng.permutation(m).astype(np.int32), rng.random(n) < 0.7,
              edge_pred, alive)
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def _assert_hops_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,capacity,n,c0", [(0, 128, 12, 6),
                                                (1, 128, 12, 6),
                                                (2, 256, 12, 6),
                                                (3, 2048, 400, 300)])
def test_fused_hop_kernel_matches_plain(cuda, seed, capacity, n, c0):
    from repro_torch.kernels.traversal.traversal import fused_hop
    rp, ci, ei, mem, ep, ca = _hop_tables(seed, n, cuda)
    rng = np.random.default_rng(seed + 100)
    fr = torch.zeros(capacity, dtype=torch.int32, device=cuda)
    fr[:c0] = torch.as_tensor(rng.integers(0, n, c0), device=cuda)
    fm = torch.zeros(capacity, dtype=torch.bool, device=cuda)
    fm[:c0] = True
    args = (rp, ci, ei, fr, fm, mem, ep, ca)
    kw = dict(capacity=capacity, chunk=8)
    _assert_hops_equal(fused_hop(*args, **kw), tref.fused_hop_ref(*args, **kw))


@pytest.mark.parametrize("seed,capacity,n,B", [(7, 128, 12, 5),
                                               (8, 1024, 300, 4)])
def test_batched_hop_kernel_matches_plain(cuda, seed, capacity, n, B):
    rp, ci, ei, mem, ep, ca = _hop_tables(seed, n, cuda)
    rng = np.random.default_rng(seed)
    fr = torch.zeros((B, capacity), dtype=torch.int32, device=cuda)
    fm = torch.zeros((B, capacity), dtype=torch.bool, device=cuda)
    for q in range(B):
        c0 = int(rng.integers(1, min(capacity // 8, 8 * n) + 1))
        fr[q, :c0] = torch.as_tensor(rng.integers(0, n, c0), device=cuda)
        fm[q, :c0] = True
    args = (rp, ci, ei, fr, fm, mem, ep, ca)
    kw = dict(capacity=capacity, chunk=8)
    _assert_hops_equal(kernel("batched_hop")(*args, **kw),
                       tref.batched_hop_ref(*args, **kw))


def test_wrappers_reject_inputs_they_do_not_take(cuda):
    x = torch.ones((4, 4), device=cuda)
    with pytest.raises(TypeError):
        kernel("matmul")(x.double(), x.double())
    with pytest.raises(ValueError):
        kernel("matmul")(x[:, ::2], x[::2])
    with pytest.raises(ValueError):
        kernel("cosine_sim")(x, torch.ones((4, 3), device=cuda))
    with pytest.raises(ValueError):
        kernel("logreg_grad")(x, torch.ones(3, device=cuda),
                              torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        kernel("matmul")(x.cpu(), x.cpu())


def test_engine_on_card_matches_cpu_and_launches_every_kernel(cuda):
    from repro_torch.core import GredoEngine, analytics
    from repro_torch.core.observe import result_fingerprint
    from repro_torch.data import m2bench
    db = m2bench.generate(sf=1, seed=0)
    gpu, cpu = GredoEngine(db), GredoEngine(db, device="cpu")
    assert gpu.device.type == "cuda"
    before = launch_counts()
    for q in (m2bench.q_g1, m2bench.q_g2, m2bench.q_g3, m2bench.q_g4,
              m2bench.q_g5, m2bench.q_opt_skew):
        assert result_fingerprint(gpu.query(q())) == \
            result_fingerprint(cpu.query(q()))
    for task, (rtol, atol) in ((m2bench.a2_similarity, (3e-4, 3e-5)),
                               (m2bench.a3_multiply, (2e-4, 2e-4)),
                               (m2bench.a_shard_reg, (3e-4, 3e-5))):
        got = gpu.analyze(task())
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), cpu.analyze(task()),
                                   rtol=rtol, atol=atol)
    X, _ = analytics.random_access_matrix(
        gpu.query(m2bench.q_g1()), "Customer.id", "t.tid", m2bench.N_TAGS,
        device=cuda)
    y = (X[:, 0] > 0).float()
    w, loss = analytics.regression(X, y, iters=20)
    w_p, loss_p = analytics.regression(X.cpu(), y.cpu(), iters=20)
    torch.testing.assert_close(w.cpu(), w_p, rtol=3e-4, atol=3e-5)
    after = launch_counts()
    assert all(after[k] > before[k] for k in after), (before, after)
