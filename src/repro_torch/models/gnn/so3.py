"""SO(3) machinery of the port for equivariant GNNs: real spherical
harmonics (l <= 8), Wigner-D rotations of real-SH irreps, and real
Clebsch-Gordan coefficients.

Mirrors ``repro.models.gnn.so3``:
  * The setup tables (the y-generator eigendecomposition by ``lstsq`` and
    ``eig``, the Wigner-D by least squares, the CG coefficients) are the
    reference's numpy code, copied as it is, so they are identical; each
    is cached per ``l_max`` (``functools.lru_cache``), and its torch copy
    per ``l_max`` and device (``_y_gen_tensors``, ``real_cg_tensor``), so
    no call copies a table to the device again.
  * The runtime (``real_sph_harm``, ``dz_blocks``, ``dy_batch``,
    ``wigner_from_rotation``, ``align_to_z_angles``, ``rotate_*``) is
    torch: ``D(R) = Dz(alpha) @ Dy(beta) @ Dz(gamma)``, Dz closed-form and
    ``Dy(beta) = Re[U diag(e^{i m beta}) U^H]`` in complex64, as in the
    reference.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Real spherical harmonics via associated Legendre recurrence
# ---------------------------------------------------------------------------


def sh_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def real_sph_harm(xyz: torch.Tensor, l_max: int, eps: float = 1e-12
                  ) -> torch.Tensor:
    """xyz: (..., 3) (need not be normalized). Returns (..., (l_max+1)^2)
    real SH stacked l=0..l_max, m=-l..l (sin components for m<0)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    ct = z / r                              # cos(theta)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, 0.0, 1.0))
    rho = torch.sqrt(x * x + y * y + eps)
    cp, sp = x / rho, y / rho               # cos/sin(phi)

    # associated Legendre P_l^m(ct) (no Condon-Shortley), stable recurrences
    P = {}
    P[(0, 0)] = torch.ones_like(ct)
    for l in range(1, l_max + 1):
        P[(l, l)] = (2 * l - 1) * st * P[(l - 1, l - 1)]
    for l in range(1, l_max + 1):
        P[(l, l - 1)] = (2 * l - 1) * ct * P[(l - 1, l - 1)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    # cos(m phi), sin(m phi) by recurrence
    cosm = [torch.ones_like(cp), cp]
    sinm = [torch.zeros_like(sp), sp]
    for m in range(2, l_max + 1):
        cosm.append(2 * cp * cosm[-1] - cosm[-2])
        sinm.append(2 * cp * sinm[-1] - sinm[-2])

    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = norm * P[(l, 0)]
            else:
                row[l + m] = math.sqrt(2) * norm * P[(l, m)] * cosm[m]
                row[l - m] = math.sqrt(2) * norm * P[(l, m)] * sinm[m]
        out.extend(row)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# numpy reference Wigner-D by least squares on sample directions (setup only)
# ---------------------------------------------------------------------------


def _np_sh(xyz: np.ndarray, l_max: int, eps: float = 1e-300) -> np.ndarray:
    """float64 numpy twin of real_sph_harm (setup-time accuracy)."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = np.sqrt(x * x + y * y + z * z + eps)
    ct = z / r
    st = np.sqrt(np.clip(1.0 - ct * ct, 0.0, 1.0))
    rho = np.sqrt(x * x + y * y) + eps
    cp, sp = x / rho, y / rho
    P = {(0, 0): np.ones_like(ct)}
    for l in range(1, l_max + 1):
        P[(l, l)] = (2 * l - 1) * st * P[(l - 1, l - 1)]
    for l in range(1, l_max + 1):
        P[(l, l - 1)] = (2 * l - 1) * ct * P[(l - 1, l - 1)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    cosm = [np.ones_like(cp), cp]
    sinm = [np.zeros_like(sp), sp]
    for m in range(2, l_max + 1):
        cosm.append(2 * cp * cosm[-1] - cosm[-2])
        sinm.append(2 * cp * sinm[-1] - sinm[-2])
    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = norm * P[(l, 0)]
            else:
                row[l + m] = math.sqrt(2) * norm * P[(l, m)] * cosm[m]
                row[l - m] = math.sqrt(2) * norm * P[(l, m)] * sinm[m]
        out.extend(row)
    return np.stack(out, axis=-1)


@functools.lru_cache(maxsize=None)
def _sample_dirs(l_max: int) -> np.ndarray:
    rng = np.random.default_rng(12345)
    n = 4 * sh_dim(l_max) + 8
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def wigner_np(l: int, R: np.ndarray) -> np.ndarray:
    """(2l+1)x(2l+1) real Wigner-D with Y_l(R x) = D Y_l(x), via lstsq."""
    dirs = _sample_dirs(max(l, 2))
    Y = _np_sh(dirs, l)[:, l * l:(l + 1) * (l + 1)]
    Yr = _np_sh(dirs @ R.T, l)[:, l * l:(l + 1) * (l + 1)]
    D, *_ = np.linalg.lstsq(Y, Yr, rcond=None)
    return D.T


def _rot_y(beta: float) -> np.ndarray:
    c, s = math.cos(beta), math.sin(beta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(alpha: float) -> np.ndarray:
    c, s = math.cos(alpha), math.sin(alpha)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


@functools.lru_cache(maxsize=None)
def y_generator_eig(l: int):
    """Eigendecomposition of the y-rotation generator K_y^l (antisymmetric):
    returns (U, m) complex eigenvectors and eigenvalue multipliers such that
    Dy(beta) = Re[U diag(exp(i m beta)) U^H]."""
    h = 1e-5
    Dp = wigner_np(l, _rot_y(h))
    Dm = wigner_np(l, _rot_y(-h))
    K = (Dp - Dm) / (2 * h)                  # antisymmetric generator
    K = 0.5 * (K - K.T)
    w, U = np.linalg.eig(K)                  # w = i*m
    m = np.round(w.imag).astype(np.float64)
    return U.astype(np.complex128), m


@functools.lru_cache(maxsize=None)
def _y_gen_stack(l_max: int):
    """Blocked (sh_dim, sh_dim) complex U and m arrays over l = 0..l_max."""
    dim = sh_dim(l_max)
    U = np.zeros((dim, dim), np.complex128)
    m = np.zeros((dim,), np.float64)
    for l in range(l_max + 1):
        Ul, ml = y_generator_eig(l)
        s = l * l
        U[s:s + 2 * l + 1, s:s + 2 * l + 1] = Ul
        m[s:s + 2 * l + 1] = ml
    return U, m


# ---------------------------------------------------------------------------
# Batched torch Wigner rotations (edge-aligned frames)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _y_gen_tensors(l_max: int, device: torch.device):
    """``_y_gen_stack(l_max)`` on ``device``: U as complex64, m as fp32."""
    U, m = _y_gen_stack(l_max)
    return (torch.as_tensor(U, dtype=torch.complex64, device=device),
            torch.as_tensor(m, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _dz_index(l_max: int, device: torch.device):
    """Rows, columns, the order m of each entry's angle (0: the constant 1)
    and whether it is a sine (with its sign) of the nonzero entries of
    Dz, in the reference's order."""
    rows, cols, ms, kind = [], [], [], []
    for l in range(l_max + 1):
        s = l * l
        rows.append(s + l), cols.append(s + l), ms.append(0), kind.append(0)
        for m in range(1, l + 1):
            # verified convention: column (+m) gains +sin on the (-m) row
            for r, c, k in ((s + l - m, s + l - m, 1), (s + l - m, s + l + m, 2),
                            (s + l + m, s + l - m, 3), (s + l + m, s + l + m, 1)):
                rows.append(r), cols.append(c), ms.append(m), kind.append(k)
    t = functools.partial(torch.tensor, device=device)
    return (t(rows), t(cols), t(ms, dtype=torch.float32), t(kind))


def dz_blocks(alpha: torch.Tensor, l_max: int) -> torch.Tensor:
    """Block-diagonal Dz(alpha): (..., dim, dim). In the real-SH basis the
    z-rotation mixes (l, -m) and (l, +m): the m-th pair rotates by m*alpha."""
    dim = sh_dim(l_max)
    rows, cols, ms, kind = _dz_index(l_max, alpha.device)
    ang = ms * alpha[..., None]                          # (..., K)
    c, sn = torch.cos(ang), torch.sin(ang)
    vals = torch.where(kind == 0, 1.0, torch.where(
        kind == 1, c, torch.where(kind == 2, sn, -sn)))
    D = torch.zeros(alpha.shape + (dim, dim), dtype=torch.float32,
                    device=alpha.device)
    D[..., rows, cols] = vals.to(torch.float32)
    return D


def dy_batch(beta: torch.Tensor, l_max: int) -> torch.Tensor:
    """Dy(beta): (..., dim, dim) via the precomputed generator eig."""
    U, m = _y_gen_tensors(l_max, beta.device)
    phase = torch.exp(1j * m * beta[..., None].to(torch.complex64))
    # D = U diag(phase) U^H
    D = torch.einsum("ij,...j,kj->...ik", U, phase, torch.conj(U))
    return torch.real(D).to(torch.float32)


def wigner_from_rotation(alpha, beta, gamma, l_max: int) -> torch.Tensor:
    """D(Rz(alpha) Ry(beta) Rz(gamma)) batched over leading dims."""
    Dz_a = dz_blocks(alpha, l_max)
    Dy_b = dy_batch(beta, l_max)
    Dz_g = dz_blocks(gamma, l_max)
    return torch.einsum("...ij,...jk,...kl->...il", Dz_a, Dy_b, Dz_g)


def align_to_z_angles(r_hat: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Angles (alpha, beta) with Ry(-beta) Rz(-alpha) r_hat = z_hat."""
    alpha = torch.atan2(r_hat[..., 1], r_hat[..., 0])
    beta = torch.arccos(torch.clamp(r_hat[..., 2], -1.0, 1.0))
    return alpha, beta


def edge_frame_wigner(r_hat: torch.Tensor, l_max: int) -> torch.Tensor:
    """D = Dy(-beta) @ Dz(-alpha): (E, dim, dim), the rotation taking each
    edge direction to +z (R_align = Ry(-beta) Rz(-alpha))."""
    alpha, beta = align_to_z_angles(r_hat)
    return torch.bmm(dy_batch(-beta, l_max), dz_blocks(-alpha, l_max))


def rotate_to_edge_frame(feats: torch.Tensor, r_hat: torch.Tensor,
                         l_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """feats: (E, dim, C) irrep features; returns (rotated feats, D_inv).
    Rotation takes the edge direction to +z (the eSCN trick: the subsequent
    per-m mixing is then SO(2)-block-diagonal)."""
    D = edge_frame_wigner(r_hat, l_max)
    return torch.bmm(D, feats), D  # D is orthogonal: D_inv = D^T


def rotate_from_edge_frame(feats: torch.Tensor, D: torch.Tensor
                           ) -> torch.Tensor:
    return torch.bmm(D.transpose(-1, -2), feats)  # D^T f


# ---------------------------------------------------------------------------
# Clebsch-Gordan coefficients in the real-SH basis (numpy setup, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """Complex-basis CG <l1 m1 l2 m2 | l3 m3> via the Racah formula."""
    f = math.factorial

    def cg(j1, m1, j2, m2, j3, m3):
        if m1 + m2 != m3:
            return 0.0
        if not (abs(j1 - j2) <= j3 <= j1 + j2):
            return 0.0
        pre = math.sqrt(
            (2 * j3 + 1) * f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
            / f(j1 + j2 + j3 + 1))
        pre *= math.sqrt(f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1)
                         * f(j2 - m2) * f(j2 + m2))
        s = 0.0
        for k in range(0, j1 + j2 - j3 + 1):
            d1 = j1 + j2 - j3 - k
            d2 = j1 - m1 - k
            d3 = j2 + m2 - k
            d4 = j3 - j2 + m1 + k
            d5 = j3 - j1 - m2 + k
            if min(d1, d2, d3, d4, d5) < 0:
                continue
            s += (-1) ** k / (f(k) * f(d1) * f(d2) * f(d3) * f(d4) * f(d5))
        return pre * s

    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i1, m1 in enumerate(range(-l1, l1 + 1)):
        for i2, m2 in enumerate(range(-l2, l2 + 1)):
            for i3, m3 in enumerate(range(-l3, l3 + 1)):
                out[i1, i2, i3] = cg(l1, m1, l2, m2, l3, m3)
    return out


@functools.lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """Unitary U with Y_complex = U @ Y_real (Condon-Shortley phase)."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), np.complex128)
    s2 = 1 / math.sqrt(2)
    for m in range(-l, l + 1):
        i = l + m  # row: complex m
        if m < 0:
            U[i, l + abs(m)] = s2                     # cos part
            U[i, l - abs(m)] = -1j * s2               # sin part
        elif m == 0:
            U[i, l] = 1.0
        else:
            U[i, l + m] = (-1) ** m * s2
            U[i, l - m] = 1j * (-1) ** m * s2
    return U


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C with: (a x b)_k = sum_ij C[i,j,k] a_i b_j
    transforming as irrep l3 when a ~ l1, b ~ l2."""
    Cc = _cg_complex(l1, l2, l3)
    U1 = _real_to_complex(l1)
    U2 = _real_to_complex(l2)
    U3 = _real_to_complex(l3)
    # C_real[a,b,c] = sum_{m1,m2,m3} conj(U1[m1,a]) conj(U2[m2,b]) Cc U3[m3,c]
    C = np.einsum("ma,nb,mnp,pc->abc", np.conj(U1), np.conj(U2), Cc, U3)
    assert np.abs(C.imag).max() < 1e-9 or np.abs(C.real).max() < 1e-9, \
        (l1, l2, l3, np.abs(C.imag).max(), np.abs(C.real).max())
    # depending on parity the real CG is purely real or purely imaginary
    if np.abs(C.real).max() >= np.abs(C.imag).max():
        return np.ascontiguousarray(C.real)
    return np.ascontiguousarray(C.imag)


@functools.lru_cache(maxsize=None)
def real_cg_tensor(l1: int, l2: int, l3: int, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``real_cg(l1, l2, l3)`` as an fp32 tensor on ``device``, promoted to
    ``dtype`` (where the reference's einsum promotes it)."""
    return torch.as_tensor(real_cg(l1, l2, l3), dtype=torch.float32,
                           device=device).to(dtype)
