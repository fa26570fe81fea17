"""Exact O((n+m)K) mean-field statistics for the Fourier kernel model.

For Phi in the random-Fourier-feature class (models/fourier_kernel.py),
every mean-field expectation factors through per-stamp sufficient
statistics of the refs via the angle-difference identities — the same
collapse `_quadratic_meanfield_stats` performs for quadratic kernels,
extended to a universal kernel class.  With C_t = E_r cos(w_k . r_t),
S_t = E_r sin(w_k . r_t), cx = cos(w_k . x), sx = sin(w_k . x):

    E_r cos(w_k . (x - r)) = cx C + sx S          (:= Ecos)
    E_r sin(w_k . (x - r)) = sx C - cx S          (:= Esin)

    E_r Phi(x - r)             =  Ecos . a + Esin . b
    E_r grad Phi(x - r)        =  sum_k [ -a_k Esin_k + b_k Ecos_k ] w_k
    E_r v^T Hess Phi(x - r) v  = -sum_k (w_k . v)^2 (a_k Ecos_k + b_k Esin_k)

No pairwise grid exists anywhere; everything is K-wide batched matmuls and
elementwise trig, so the computation is mesh-transparent — GSPMD shards the
point axis and inserts the ref-axis mean reductions on its own (no
shard_map needed, unlike the O(n^2) paths).

Equality against the generic pairwise reduction (same Phi, brute-force
O(n^2)) is gated by tests/test_fourier_kernel.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from pde_inverse.losses.pairwise_blockwise import _quad_head_stats, _unwrap


def supports(module) -> bool:
    from pde_inverse.models.fourier_kernel import FourierKernelModel

    return isinstance(module, FourierKernelModel)


def fourier_grad(module, params, y):
    """Gradient of the FOURIER COMPONENT of Phi only, grad_y [a.cos(yW^T)
    + b.sin(yW^T)] = sum_k (b_k cos(w_k.y) - a_k sin(w_k.y)) w_k, for
    y [P, d] -> [P, d].

    Used by the semiparametric variant of the field-space Tikhonov
    stabilizer (solver.train.kmv_field_reg_fourier_only): the penalty
    lambda*E||grad Phi||^2 exists to pin the bounded Fourier features'
    finite-sample noise-riding mode, but applied to the FULL field it
    also Tikhonov-shrinks the quadratic head's growing gradient
    A^T A y + c — a bias on exactly the parametric component the head
    exists to recover.  Regularize the non-parametric correction, leave
    the parametric base unpenalized (standard semiparametric practice).
    Equality vs autodiff of a head-free twin module is gated in
    tests/test_fourier_kernel.py."""
    import jax

    p = _unwrap(params)
    omega = p["omega"]
    if not module.trainable_frequencies:
        omega = jax.lax.stop_gradient(omega)
    a = p["amp_cos"]
    b = p["amp_sin"]
    py = y @ omega.T  # [P, K]
    return (b * jnp.cos(py) - a * jnp.sin(py)) @ omega


def meanfield_stats(module, params, x, v, refs, ref_weights=None):
    """x, v: [n, nt, d]; refs: [m, nt, d].  Returns the same pytree as the
    pairwise paths: {"nabla" [n, nt, d], "hess" [n, nt], "value" [n, nt]}
    (per-stamp means over the refs).

    ref_weights [m, nt] (optional): raw per-(ref, stamp) importance
    weights with E_q[w] = 1 — the tail-boost exact-law estimator
    (pde_instance.init_broaden > 1).  The per-stamp sufficient statistics
    become weighted means (1/m) sum_j w_{j,t} cos/sin(w_k . r_{j,t}),
    each an unbiased estimate of the true-law statistic while the refs
    themselves are drawn from the broadened law."""
    import jax

    p = _unwrap(params)
    omega = p["omega"]  # [K, d]
    if not module.trainable_frequencies:
        # consistent with the module's stop_gradient (see
        # models/fourier_kernel.py on the finite-sample failure mode)
        omega = jax.lax.stop_gradient(omega)
    a = p["amp_cos"]
    b = p["amp_sin"]
    m = refs.shape[0]

    px = jnp.einsum("ntd,kd->ntk", x, omega)
    pv = jnp.einsum("ntd,kd->ntk", v, omega)
    pr = jnp.einsum("mtd,kd->mtk", refs, omega)
    if ref_weights is None:
        C = jnp.mean(jnp.cos(pr), axis=0)  # [nt, K] sufficient statistics
        S = jnp.mean(jnp.sin(pr), axis=0)
    else:
        wr = ref_weights[..., None]  # [m, nt, 1]
        C = jnp.mean(wr * jnp.cos(pr), axis=0)
        S = jnp.mean(wr * jnp.sin(pr), axis=0)

    cx, sx = jnp.cos(px), jnp.sin(px)
    Ecos = cx * C[None] + sx * S[None]  # [n, nt, K]
    Esin = sx * C[None] - cx * S[None]

    value = Ecos @ a + Esin @ b  # [n, nt]
    nabla = jnp.einsum("ntk,kd->ntd", b * Ecos - a * Esin, omega)
    hess = -jnp.sum(pv * pv * (a * Ecos + b * Esin), axis=-1)

    if module.quadratic_head:
        qs = _quad_head_stats(
            p["quad_A"].astype(jnp.float32),
            p["quad_b"].astype(jnp.float32),
            x.astype(jnp.float32),
            v.astype(jnp.float32),
            refs.astype(jnp.float32),
            valid=(
                jnp.ones((m,), jnp.float32)
                if ref_weights is None
                else ref_weights.astype(jnp.float32)
            ),
        )
        value = value + qs["value"] / m
        nabla = nabla + qs["nabla_direct"] / m
        hess = hess + qs["hess"] / m
    return {"nabla": nabla, "hess": hess, "value": value}
