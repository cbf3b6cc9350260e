"""Multiwavelet filter bank of the MWT baseline, built on the host.

Counterpart of ``realpdebench_tpu/ops/multiwavelet.py`` (the reference's
``MWT_libs/utils_MWT.py:22-190``, ``get_phi_psi`` and ``get_filter``):
the scaling functions are normalised shifted Legendre (or Chebyshev)
polynomials on [0, 1]; the mother wavelets come from Gram-Schmidt of φ(2x)
against the φ and the wavelets built before them; the two-scale relations
give the decomposition filters H0/H1, G0/G1 and the reconstruction
corrections PHI0/PHI1, and ``cz_matrices`` the six constant matrices of
the MWT CZ cell. Numpy, scipy and sympy on the host, once per (base, k),
cached; the model copies the matrices to its device. sympy is a
requirement of the torch wheel itself, so every host with PyTorch has it
(the card's host included).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np


def _poly_eval(coeffs_low_first, x, lb=None, ub=None):
    """Evaluate a polynomial given low-order-first coefficients; optionally
    zero outside [lb, ub] (reference `phi_`, utils_MWT.py:18-20)."""
    val = np.polynomial.polynomial.Polynomial(coeffs_low_first)(x)
    if lb is not None:
        mask = np.logical_or(x < lb, x > ub)
        val = np.where(mask, 0.0, val)
    return val


def _interval_integral(prod, weight_first_half=True):
    """∫ p(x) dx over [0, ½] (weight_first_half) or [½, 1] for a polynomial
    given by convolution coefficients ``prod`` (low-first)."""
    n = np.arange(len(prod))
    half_powers = np.power(0.5, 1 + n)
    if weight_first_half:
        return (prod / (n + 1) * half_powers).sum()
    return (prod / (n + 1) * (1 - half_powers)).sum()


def _zap(a, tol=1e-8):
    a = np.asarray(a, dtype=np.float64)
    a[np.abs(a) < tol] = 0
    return a


@lru_cache(maxsize=8)
def get_phi_psi(k: int, base: str):
    """Scaling/wavelet polynomial coefficient tables.

    Returns (phi, psi1, psi2): lists of k callables on [0,1]; psi1/psi2 are the
    left/right-half pieces of each mother wavelet.
    """
    from sympy import Poly, Symbol, chebyshevt, legendre

    x = Symbol("x")
    phi_coeff = np.zeros((k, k))
    phi_2x_coeff = np.zeros((k, k))

    if base == "legendre":
        for ki in range(k):
            c = Poly(legendre(ki, 2 * x - 1), x).all_coeffs()
            phi_coeff[ki, : ki + 1] = np.flip(
                np.sqrt(2 * ki + 1) * np.array(c, dtype=np.float64)
            )
            c = Poly(legendre(ki, 4 * x - 1), x).all_coeffs()
            phi_2x_coeff[ki, : ki + 1] = np.flip(
                np.sqrt(2) * np.sqrt(2 * ki + 1) * np.array(c, dtype=np.float64)
            )

        psi1_coeff = np.zeros((k, k))
        psi2_coeff = np.zeros((k, k))
        for ki in range(k):
            psi1_coeff[ki, :] = phi_2x_coeff[ki, :]
            # project out the scaling functions, then previously-built wavelets
            for i in range(k):
                prod = _zap(np.convolve(phi_2x_coeff[ki, : ki + 1],
                                        phi_coeff[i, : i + 1]))
                proj = _interval_integral(prod)
                psi1_coeff[ki, :] -= proj * phi_coeff[i, :]
                psi2_coeff[ki, :] -= proj * phi_coeff[i, :]
            for j in range(ki):
                prod = _zap(np.convolve(phi_2x_coeff[ki, : ki + 1],
                                        psi1_coeff[j, :]))
                proj = _interval_integral(prod)
                psi1_coeff[ki, :] -= proj * psi1_coeff[j, :]
                psi2_coeff[ki, :] -= proj * psi2_coeff[j, :]

            norm1 = _interval_integral(
                _zap(np.convolve(psi1_coeff[ki, :], psi1_coeff[ki, :]))
            )
            norm2 = _interval_integral(
                _zap(np.convolve(psi2_coeff[ki, :], psi2_coeff[ki, :])),
                weight_first_half=False,
            )
            norm = np.sqrt(norm1 + norm2)
            psi1_coeff[ki, :] /= norm
            psi2_coeff[ki, :] /= norm
            psi1_coeff = _zap(psi1_coeff)
            psi2_coeff = _zap(psi2_coeff)

        phi = [np.poly1d(np.flip(phi_coeff[i, :])) for i in range(k)]
        psi1 = [np.poly1d(np.flip(psi1_coeff[i, :])) for i in range(k)]
        psi2 = [np.poly1d(np.flip(psi2_coeff[i, :])) for i in range(k)]
        return phi, psi1, psi2

    if base == "chebyshev":
        for ki in range(k):
            if ki == 0:
                phi_coeff[ki, : ki + 1] = np.sqrt(2 / np.pi)
                phi_2x_coeff[ki, : ki + 1] = np.sqrt(2 / np.pi) * np.sqrt(2)
            else:
                c = Poly(chebyshevt(ki, 2 * x - 1), x).all_coeffs()
                phi_coeff[ki, : ki + 1] = np.flip(
                    2 / np.sqrt(np.pi) * np.array(c, dtype=np.float64)
                )
                c = Poly(chebyshevt(ki, 4 * x - 1), x).all_coeffs()
                phi_2x_coeff[ki, : ki + 1] = np.flip(
                    np.sqrt(2) * 2 / np.sqrt(np.pi)
                    * np.array(c, dtype=np.float64)
                )

        # chebyshev φ are masked to [0,1] (reference phi_ defaults lb=0, ub=1)
        phi = [partial(_poly_eval, phi_coeff[i, :], lb=0, ub=1)
               for i in range(k)]

        k_use = 2 * k
        from sympy import Poly as _Poly

        roots = _Poly(chebyshevt(k_use, 2 * x - 1)).all_roots()
        x_m = np.array([r.evalf(20) for r in roots], dtype=np.float64)
        wm = np.pi / k_use / 2

        psi1_coeff = np.zeros((k, k))
        psi2_coeff = np.zeros((k, k))
        psi1 = [None] * k
        psi2 = [None] * k
        for ki in range(k):
            psi1_coeff[ki, :] = phi_2x_coeff[ki, :]
            for i in range(k):
                proj = (wm * phi[i](x_m) * np.sqrt(2) * phi[ki](2 * x_m)).sum()
                psi1_coeff[ki, :] -= proj * phi_coeff[i, :]
                psi2_coeff[ki, :] -= proj * phi_coeff[i, :]
            for j in range(ki):
                proj = (wm * psi1[j](x_m) * np.sqrt(2) * phi[ki](2 * x_m)).sum()
                psi1_coeff[ki, :] -= proj * psi1_coeff[j, :]
                psi2_coeff[ki, :] -= proj * psi2_coeff[j, :]

            psi1[ki] = partial(_poly_eval, psi1_coeff[ki, :], lb=0, ub=0.5)
            psi2[ki] = partial(_poly_eval, psi2_coeff[ki, :], lb=0.5, ub=1)
            norm1 = (wm * psi1[ki](x_m) * psi1[ki](x_m)).sum()
            norm2 = (wm * psi2[ki](x_m) * psi2[ki](x_m)).sum()
            norm = np.sqrt(norm1 + norm2)
            psi1_coeff[ki, :] /= norm
            psi2_coeff[ki, :] /= norm
            psi1_coeff = _zap(psi1_coeff)
            psi2_coeff = _zap(psi2_coeff)
            psi1[ki] = partial(_poly_eval, psi1_coeff[ki, :], lb=0,
                               ub=0.5 + 1e-16)
            psi2[ki] = partial(_poly_eval, psi2_coeff[ki, :], lb=0.5 + 1e-16,
                               ub=1)
        return phi, psi1, psi2

    raise ValueError(f"Base {base} not supported")


def _legendre_weights(k, x_m):
    """Gauss-Legendre-style quadrature weights on the shifted roots
    (reference legendreDer usage, utils_MWT.py:10-16,151)."""
    from scipy.special import eval_legendre

    def der(kk, xx):
        out = 0.0
        for i in np.arange(kk - 1, -1, -2):
            out = out + (2 * i + 1) * eval_legendre(i, xx)
        return out

    return 1 / k / der(k, 2 * x_m - 1) / eval_legendre(k - 1, 2 * x_m - 1)


@lru_cache(maxsize=8)
def get_filter(base: str, k: int):
    """Two-scale filter matrices (H0, H1, G0, G1, PHI0, PHI1), each k×k."""
    from sympy import Poly, Symbol, chebyshevt, legendre

    if base not in ("legendre", "chebyshev"):
        raise ValueError("Base not supported")

    x = Symbol("x")
    phi, psi1, psi2 = get_phi_psi(k, base)

    def psi(i, inp):
        mask = (inp <= 0.5) * 1.0
        return psi1[i](inp) * mask + psi2[i](inp) * (1 - mask)

    H0 = np.zeros((k, k))
    H1 = np.zeros((k, k))
    G0 = np.zeros((k, k))
    G1 = np.zeros((k, k))
    PHI0 = np.eye(k)
    PHI1 = np.eye(k)

    if base == "legendre":
        roots = Poly(legendre(k, 2 * x - 1)).all_roots()
        x_m = np.array([r.evalf(20) for r in roots], dtype=np.float64)
        wm = _legendre_weights(k, x_m)
    else:
        k_use = 2 * k
        roots = Poly(chebyshevt(k_use, 2 * x - 1)).all_roots()
        x_m = np.array([r.evalf(20) for r in roots], dtype=np.float64)
        wm = np.pi / k_use / 2

    s = 1 / np.sqrt(2)
    for ki in range(k):
        for kpi in range(k):
            H0[ki, kpi] = s * (wm * phi[ki](x_m / 2) * phi[kpi](x_m)).sum()
            G0[ki, kpi] = s * (wm * psi(ki, x_m / 2) * phi[kpi](x_m)).sum()
            H1[ki, kpi] = s * (wm * phi[ki]((x_m + 1) / 2) * phi[kpi](x_m)).sum()
            G1[ki, kpi] = s * (wm * psi(ki, (x_m + 1) / 2) * phi[kpi](x_m)).sum()
            if base == "chebyshev":
                PHI0[ki, kpi] = (wm * phi[ki](2 * x_m) * phi[kpi](2 * x_m)).sum() * 2
                PHI1[ki, kpi] = (
                    wm * phi[ki](2 * x_m - 1) * phi[kpi](2 * x_m - 1)
                ).sum() * 2

    if base == "chebyshev":
        PHI0 = _zap(PHI0)
        PHI1 = _zap(PHI1)
    return _zap(H0), _zap(H1), _zap(G0), _zap(G1), PHI0, PHI1


@lru_cache(maxsize=8)
def cz_matrices(base: str, k: int):
    """The six constant matrices used by the MWT CZ cell
    (reference MWT_libs/models.py:600-649): decomposition kron filters
    (ec_s, ec_d) and even/odd reconstruction matrices (rc_ee, rc_eo, rc_oe,
    rc_oo)."""
    H0, H1, G0, G1, PHI0, PHI1 = get_filter(base, k)
    H0r = _zap(H0 @ PHI0)
    G0r = _zap(G0 @ PHI0)
    H1r = _zap(H1 @ PHI1)
    G1r = _zap(G1 @ PHI1)

    ec_s = np.concatenate(
        [np.kron(H0, H0).T, np.kron(H0, H1).T,
         np.kron(H1, H0).T, np.kron(H1, H1).T], axis=0
    )
    ec_d = np.concatenate(
        [np.kron(G0, G0).T, np.kron(G0, G1).T,
         np.kron(G1, G0).T, np.kron(G1, G1).T], axis=0
    )
    rc_ee = np.concatenate([np.kron(H0r, H0r), np.kron(G0r, G0r)], axis=0)
    rc_eo = np.concatenate([np.kron(H0r, H1r), np.kron(G0r, G1r)], axis=0)
    rc_oe = np.concatenate([np.kron(H1r, H0r), np.kron(G1r, G0r)], axis=0)
    rc_oo = np.concatenate([np.kron(H1r, H1r), np.kron(G1r, G1r)], axis=0)
    return (
        ec_s.astype(np.float32), ec_d.astype(np.float32),
        rc_ee.astype(np.float32), rc_eo.astype(np.float32),
        rc_oe.astype(np.float32), rc_oo.astype(np.float32),
    )
