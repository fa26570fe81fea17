"""Closed-form Gaussian moment oracles for linear SDEs (OU processes).

The reference integrates the moment ODEs with ``jax.experimental.ode.odeint``
*inside the traced sampling step* (kinetic_fokker_planck_example_OU.py:73-93,
147-156) — an adaptive host-unfriendly hot spot.  Here it is replaced with
exact matrix-exponential formulas:

For the linear SDE  dz = A z dt + sqrt(L) dW  (A any square matrix, L PSD),
the law stays Gaussian with
    m(t) = e^{At} m0
    P(t) = e^{At} P0 e^{A^T t} + G(t),   G(t) = int_0^t e^{Au} L e^{A^T u} du.

The covariance is propagated in vectorized (Kronecker) form: with
K = A (x) I + I (x) A  (row-major vec convention), the Lyapunov ODE
dP/dt = A P + P A^T + L becomes the affine ODE  d vec(P)/dt = K vec(P) +
vec(L), solved exactly by one augmented matrix exponential
    expm([[K, I], [0, 0]] t) = [[e^{Kt}, int_0^t e^{Ks} ds], [0, I]].
For a stable drift every eigenvalue of K = lambda_i + lambda_j decays, so
the float32 exponential is well-conditioned (measured ~7e-6 absolute error
vs float64, where the classic Van Loan block form — whose -A^T block has
*growing* modes — loses ~3e-3 to cancellation).  One expm per time stamp —
exact, jittable, vmappable over time grids, free of data-dependent control
flow.

For symmetric drift (the overdamped Fokker-Planck example, A = -F with F
symmetric PD, fokker_planck_example.py:48-55) a spectral form broadcasts over
arbitrary time arrays without any expm.

Moment time-derivatives follow the Lyapunov ODE analytically:
    dm/dt = A m,   dP/dt = A P + P A^T + L,
which also yields closed-form first/second time-derivatives of the Gaussian
log-density used as KMV loss weights (kinetic_mckean_vlasov_example_quadratic
.py:18-191) — re-derived here, gated by finite-difference tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Moment propagation
# ---------------------------------------------------------------------------


def _lyapunov_augmented(A: jnp.ndarray) -> jnp.ndarray:
    """[[K, I], [0, 0]] with K = A (x) I + I (x) A (row-major vec)."""
    D = A.shape[0]
    eye = jnp.eye(D)
    K = jnp.kron(A, eye) + jnp.kron(eye, A)
    n = D * D
    aug = jnp.zeros((2 * n, 2 * n), A.dtype)
    aug = aug.at[:n, :n].set(K).at[:n, n:].set(jnp.eye(n, dtype=A.dtype))
    return aug


def lti_moments(
    A: jnp.ndarray,
    L: jnp.ndarray,
    m0: jnp.ndarray,
    P0: jnp.ndarray,
    t: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact (mean, cov) at scalar time t for dz = A z dt + sqrt(L) dW."""
    # Full-f32 matmuls: a reduced default matmul precision (TF32 on the
    # GPU) would contaminate the oracle at ~1e-3 — these matrices are
    # tiny, so exactness is free.
    with jax.default_matmul_precision("float32"):
        D = A.shape[0]
        n = D * D
        mean = jax.scipy.linalg.expm(A * t) @ m0
        M = jax.scipy.linalg.expm(_lyapunov_augmented(A) * t)
        vecP = M[:n, :n] @ P0.reshape(-1) + M[:n, n:] @ L.reshape(-1)
        cov = vecP.reshape(D, D)
        # Symmetrize to kill expm round-off skew before Cholesky downstream.
        cov = 0.5 * (cov + cov.T)
        return mean, cov


def lti_moments_grid(
    A: jnp.ndarray,
    L: jnp.ndarray,
    m0: jnp.ndarray,
    P0: jnp.ndarray,
    ts: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(means [T, D], covs [T, D, D]) over a 1-D array of times."""
    return jax.vmap(lambda t: lti_moments(A, L, m0, P0, t))(ts)


def symmetric_ou_moments(
    F: jnp.ndarray,
    L: jnp.ndarray,
    m0: jnp.ndarray,
    P0: jnp.ndarray,
    ts: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Moments of dX = -F X dt + sqrt(L) dW for symmetric PD F.

    Broadcasts over ts of any shape [...]: returns means [..., d] and covs
    [..., d, d].  Uses one eigendecomposition of F (setup-time cost) and
    elementwise formulas in the eigenbasis:
        m(t)    = U e^{-ts} U^T m0
        Ptil(t) = e^{-ts} B0 e^{-ts} + B * (1 - e^{-t(s_i+s_j)}) / (s_i+s_j)
    with B = U^T L U, B0 = U^T P0 U.  (Parity with the reference's spectral
    oracle fokker_planck_example.py:48-55, elementwise instead of matmuls of
    diagonal exponentials.)
    """
    with jax.default_matmul_precision("float32"):
        s, U = jnp.linalg.eigh(F)
        B = U.T @ L @ U
        B0 = U.T @ P0 @ U
        ts = jnp.asarray(ts)
        e = jnp.exp(-ts[..., None] * s)  # [..., d]
        ssum = s[:, None] + s[None, :]  # [d, d]
        mean = jnp.einsum("ij,...j,kj,k->...i", U, e, U, m0)
        decay = e[..., :, None] * e[..., None, :]  # e^{-t(s_i+s_j)}
        P_tilde = decay * B0 + B / ssum * (1.0 - decay)
        cov = jnp.einsum("ij,...jk,lk->...il", U, P_tilde, U)
        return mean, cov


# ---------------------------------------------------------------------------
# Moment time-derivatives (Lyapunov ODE, analytic)
# ---------------------------------------------------------------------------


def lti_moment_derivatives(A, L, mean, cov):
    """(dm/dt, dP/dt) at a state (mean, cov):  A m,  A P + P A^T + L."""
    dm = A @ mean
    dP = A @ cov + cov @ A.T + L
    return dm, dP


def lti_moment_second_derivatives(A, L, mean, cov):
    """(d2m/dt2, d2P/dt2):  A (A m),  A dP + dP A^T  (L is constant)."""
    dm, dP = lti_moment_derivatives(A, L, mean, cov)
    d2m = A @ dm
    d2P = A @ dP + dP @ A.T
    return d2m, d2P


# ---------------------------------------------------------------------------
# Time-derivatives of a Gaussian marginal log-density
# ---------------------------------------------------------------------------


def gaussian_logdensity_time_derivative(
    x: jnp.ndarray,
    mean: jnp.ndarray,
    cov: jnp.ndarray,
    dmean: jnp.ndarray,
    dcov: jnp.ndarray,
) -> jnp.ndarray:
    """d/ds log N(x; m(s), P(s)) given the moment derivatives.

    With u = x - m, Ainv = P^{-1}:
        d/ds log rho = -1/2 tr(Ainv dP) + dm^T Ainv u + 1/2 u^T Ainv dP Ainv u
    x: [..., d] -> [...].
    """
    u = x - mean
    Ainv_u = jnp.linalg.solve(cov, u[..., None])[..., 0]  # [..., d]
    term_tr = -0.5 * jnp.trace(jnp.linalg.solve(cov, dcov))
    term_mean = Ainv_u @ dmean
    term_quad = 0.5 * jnp.einsum("...i,ij,...j->...", Ainv_u, dcov, Ainv_u)
    return term_tr + term_mean + term_quad


def gaussian_logdensity_time_second_derivative(
    x: jnp.ndarray,
    mean: jnp.ndarray,
    cov: jnp.ndarray,
    dmean: jnp.ndarray,
    dcov: jnp.ndarray,
    d2mean: jnp.ndarray,
    d2cov: jnp.ndarray,
) -> jnp.ndarray:
    """d2/ds2 log N(x; m(s), P(s)) given first/second moment derivatives.

    Derivation (u = x - m, Ainv = P^{-1}, K = Ainv dP Ainv):
        d2/ds2 log rho = 1/2 tr(Ainv dP Ainv dP) - 1/2 tr(Ainv d2P)
                       + d2m^T Ainv u - 2 dm^T K u - dm^T Ainv dm
                       + 1/2 u^T Ainv d2P Ainv u - u^T K dP Ainv u
    x: [..., d] -> [...].
    """
    u = x - mean
    Ainv = jnp.linalg.inv(cov)
    K = Ainv @ dcov @ Ainv
    Ainv_u = u @ Ainv  # [..., d] (Ainv symmetric)
    tr1 = 0.5 * jnp.trace(Ainv @ dcov @ Ainv @ dcov)
    tr2 = -0.5 * jnp.trace(Ainv @ d2cov)
    t_mean2 = Ainv_u @ d2mean
    t_cross = -2.0 * jnp.einsum("i,ij,...j->...", dmean, K, u)
    t_mm = -dmean @ Ainv @ dmean
    t_quad1 = 0.5 * jnp.einsum("...i,ij,...j->...", Ainv_u, d2cov, Ainv_u)
    t_quad2 = -jnp.einsum("...i,ij,...j->...", u @ K, dcov, Ainv_u)
    return tr1 + tr2 + t_mean2 + t_cross + t_mm + t_quad1 + t_quad2


# ---------------------------------------------------------------------------
# High-level oracle
# ---------------------------------------------------------------------------


def spectral_moment_data(A, L, m0, P0):
    """Host-side eigendecomposition data for the spectral moment oracle.

    With A = V diag(lam) V^-1 (complex, generic diagonalizable drift):
        m(t) = Re[ V (e^{lam t} * (V^-1 m0)) ]
        P(t) = Re[ V ( E(t) * (B0 + C) - C ) V^T ],
    where B0 = V^-1 P0 V^-T,  B = V^-1 L V^-T,  C_ij = B_ij/(lam_i+lam_j),
    E_ij(t) = e^{(lam_i+lam_j) t}.  Everything is elementwise in t — no
    matrix exponential per time stamp.

    jnp.linalg.eig is CPU-only, so this runs in numpy at problem-setup time
    on concrete arrays.
    """
    import numpy as np

    A = np.asarray(A, np.float64)
    lam, V = np.linalg.eig(A)
    Vinv = np.linalg.inv(V)
    if np.linalg.cond(V) > 1e8:
        raise ValueError(
            "drift matrix is too close to non-diagonalizable for the "
            "spectral oracle; use the expm path"
        )
    B0 = Vinv @ np.asarray(P0, np.float64) @ Vinv.T
    B = Vinv @ np.asarray(L, np.float64) @ Vinv.T
    lam_sum = lam[:, None] + lam[None, :]
    C = B / lam_sum
    m0t = Vinv @ np.asarray(m0, np.float64)

    # Complex arithmetic is stored as explicit (re, im) float32 pairs, so
    # the oracle needs no complex dtype on the device.
    def ri(z):
        z = np.asarray(z)
        return jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32)

    return {
        "lam": ri(lam),
        "V": ri(V),
        "m0_tilde": ri(m0t),
        "B0_plus_C": ri(B0 + C),
        "C": ri(C),
        "lam_sum": ri(lam_sum),
    }


def _cexp(t, lam_ri):
    """e^{t * lam} for real t[...] and complex lam (re, im): -> (re, im)."""
    lr, li = lam_ri
    mag = jnp.exp(t * lr)
    return mag * jnp.cos(t * li), mag * jnp.sin(t * li)


def _cmul(a, b):
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def spectral_moments(data, ts: jnp.ndarray):
    """(means [..., D], covs [..., D, D]) for any time array, elementwise
    in t — no matrix exponential, no complex dtype (real/imag pairs)."""
    ts = jnp.asarray(ts, jnp.float32)
    Vr, Vi = data["V"]

    # mean = Re[V (e^{lam t} * m0_tilde)]
    e = _cexp(ts[..., None], data["lam"])  # (re, im) [..., D]
    w = _cmul(e, data["m0_tilde"])
    mean = jnp.einsum("ij,...j->...i", Vr, w[0]) - jnp.einsum(
        "ij,...j->...i", Vi, w[1]
    )

    # inner = E(t) * (B0 + C) - C,  cov = Re[V inner V^T]
    E = _cexp(ts[..., None, None], data["lam_sum"])  # [..., D, D]
    inner = _cmul(E, data["B0_plus_C"])
    inner = (inner[0] - data["C"][0], inner[1] - data["C"][1])
    # N = V inner  (complex), cov = Re[N V^T] = Nr Vr^T - Ni Vi^T
    Nr = jnp.einsum("ij,...jk->...ik", Vr, inner[0]) - jnp.einsum(
        "ij,...jk->...ik", Vi, inner[1]
    )
    Ni = jnp.einsum("ij,...jk->...ik", Vr, inner[1]) + jnp.einsum(
        "ij,...jk->...ik", Vi, inner[0]
    )
    cov = jnp.einsum("...ik,jk->...ij", Nr, Vr) - jnp.einsum(
        "...ik,jk->...ij", Ni, Vi
    )
    # numerical symmetrization (P is symmetric by construction)
    cov = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    return mean, cov


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class GaussianPathOracle:
    """Exact Gaussian law of a linear SDE dz = A z dt + sqrt(L) dW.

    Closes over (A, L, m0, P0) as traced arrays, so it can live inside jitted
    train steps.  Constructed via ``create`` it carries spectral
    eigendecomposition data and evaluates moments elementwise in t; without
    it, it falls back to the Kronecker matrix-exponential path.
    """

    A: jnp.ndarray
    L: jnp.ndarray
    m0: jnp.ndarray
    P0: jnp.ndarray
    spectral: Optional[dict] = None

    @classmethod
    def create(cls, A, L, m0, P0, use_spectral: bool = True):
        spectral = None
        if use_spectral:
            try:
                spectral = spectral_moment_data(A, L, m0, P0)
            except ValueError:
                spectral = None
        return cls(A=A, L=L, m0=m0, P0=P0, spectral=spectral)

    def tree_flatten(self):
        return (self.A, self.L, self.m0, self.P0, self.spectral), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def moments(self, t: jnp.ndarray):
        """Scalar t -> (mean [D], cov [D, D])."""
        if self.spectral is not None:
            return spectral_moments(self.spectral, t)
        return lti_moments(self.A, self.L, self.m0, self.P0, t)

    def moments_grid(self, ts: jnp.ndarray):
        """ts [T] -> (means [T, D], covs [T, D, D])."""
        if self.spectral is not None:
            return spectral_moments(self.spectral, ts)
        return lti_moments_grid(self.A, self.L, self.m0, self.P0, ts)

    def _marginal_state(self, s: jnp.ndarray, dim: int):
        mean, cov = self.moments(s)
        dm, dP = lti_moment_derivatives(self.A, self.L, mean, cov)
        d2m, d2P = lti_moment_second_derivatives(self.A, self.L, mean, cov)
        sl = slice(0, dim)
        return (
            mean[sl], cov[sl, sl], dm[sl], dP[sl, sl], d2m[sl], d2P[sl, sl],
        )

    def partial_s_logdensity(self, s: jnp.ndarray, x: jnp.ndarray, dim: int):
        """d/ds log rho_s(x) of the leading dim-marginal; x: [..., dim]."""
        m, P, dm, dP, _, _ = self._marginal_state(s, dim)
        return gaussian_logdensity_time_derivative(x, m, P, dm, dP)

    def partial_s2_logdensity(self, s: jnp.ndarray, x: jnp.ndarray, dim: int):
        """d2/ds2 log rho_s(x) of the leading dim-marginal; x: [..., dim]."""
        m, P, dm, dP, d2m, d2P = self._marginal_state(s, dim)
        return gaussian_logdensity_time_second_derivative(x, m, P, dm, dP, d2m, d2P)
