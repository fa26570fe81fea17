"""Consistency (weak-form) loss for the kinetic Fokker-Planck equation.

Integration-by-parts turns the kinetic FPE residual for the candidate
potential V into expectations over path samples z = [x | v]:

    loss = E_0T ||grad V||^2  -  2 E_0T [v^T Hess(V) v]
         + 2 gamma E_0T [grad V . v]  +  E_0T ||grad V_true||^2
         + (2 / T) ( E_term [grad V . v] - E_init [grad V . v] )

(the E||grad V_true||^2 term is a model-independent constant that completes
a square so the minimum value is interpretable).  Hessian quadratic forms
use forward-over-reverse HVPs (never materializing the Hessian), and every
expectation is a shard-local mean + cross-shard reduction inserted by GSPMD.

Parity: /root/reference/methods/consistency_instances/kinetic_fokker_planck.py:11-105.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pde_inverse.ops import autodiff as ad


def _split_xv(z: jnp.ndarray):
    return jnp.split(z, 2, axis=-1)


def make_loss_fn(
    forward_fn,
    data,
    pde_instance,
):
    """Returns (loss_fn(params), aux_fn(params)) closures over data."""
    x_init, v_init = _split_xv(data["initial"])
    x_term, v_term = _split_xv(data["terminal"])
    x_0T, v_0T = _split_xv(data["0T"])

    # Tail-boost importance weights (pde_instance.init_broaden): per-sample
    # w = p0/q0 with E_q[w] = 1, so mean(w * f) is an UNBIASED estimate of
    # the true-law expectation mean-under-p(f).  Absent keys mean the
    # batches were drawn from the true law (w identically 1).
    w_0T = data.get("w_0T")
    w_init = data.get("w_initial")
    w_term = data.get("w_terminal")

    def wmean(f, w):
        return jnp.mean(f if w is None else w * f)

    gamma = pde_instance.gamma_friction
    T = pde_instance.total_evolving_time
    nabla_V_true = ad.batched_grad(pde_instance.V_true_fn, x_0T)
    loss_nabla_true = wmean(jnp.sum(nabla_V_true**2, axis=-1), w_0T)

    def loss_fn(params):
        """Returns (loss, gap) where gap = E||grad V_true - grad V||^2 on
        the path batch — the de-facto accuracy diagnostic, computed from
        the same batched gradients as the loss (the reference pays a second
        full pass for it every step, kinetic_fokker_planck.py:52-58)."""
        V = lambda x: forward_fn(params, x)[0]
        # one forward-over-reverse pass yields BOTH the gradient (primal)
        # and the Hessian quadform (tangent) — a separate batched_grad
        # pass would redo the full reverse sweep over the 0T batch.
        nabla_0T, quad_0T = ad.batched_grad_and_hvp_quadform(V, x_0T, v_0T)
        loss_nabla = wmean(jnp.sum(nabla_0T**2, axis=-1), w_0T)
        loss_hessian = wmean(quad_0T, w_0T)
        loss_friction = gamma * wmean(jnp.sum(nabla_0T * v_0T, axis=-1), w_0T)

        def boundary(x, v, w):
            # mean of grad V . v, safe for empty boundary batches (the KMV
            # preset runs with batch_size_init = 0)
            if x.shape[0] == 0:
                return jnp.zeros([])
            return wmean(jnp.sum(ad.batched_grad(V, x) * v, axis=-1), w)

        loss_initial = boundary(x_init, v_init, w_init)
        loss_terminal = boundary(x_term, v_term, w_term)
        loss = (
            loss_nabla - 2.0 * loss_hessian + 2.0 * loss_friction + loss_nabla_true
        ) + (2.0 * loss_terminal - 2.0 * loss_initial) / T
        gap = wmean(jnp.sum((nabla_V_true - nabla_0T) ** 2, axis=-1), w_0T)
        return loss, gap

    return loss_fn


def value_and_grad_fn(
    forward_fn,
    params,
    data,
    rng,
    pde_instance,
    mesh_spec=None,
):
    loss_fn = make_loss_fn(forward_fn, data, pde_instance)
    (loss, gap), grad = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return {
        "loss": loss,
        "grad": grad,
        "grad_norm": ad.pytree_l2_norm(grad),
        "loss ground truth": gap,
    }


def test_fn(
    forward_fn,
    pde_instance,
    rng,
    batch_size: int = 10_000,
    sde_probe_trajectories: int = 1024,
):
    """Relative L2 error of grad V at initial/terminal samples, plus — for
    SDE instances without a closed-form terminal law — over fresh PATH
    samples.  The path-law metric matters for non-parametric recovery: the
    weak form only constrains grad V where the path measure rho_t has mass,
    so the broad initial-law metric mixes in model error from regions the
    data never visits.  (The reference's KFP test_fn is commented out and
    returns {}, …/kinetic_fokker_planck.py:72-92.)"""
    V = lambda x: forward_fn(x)[0]
    V_true = pde_instance.V_true_fn

    def rel_err(x):
        pred = ad.batched_grad(V, x)
        true = ad.batched_grad(V_true, x)
        return jnp.sqrt(
            jnp.mean(jnp.sum((pred - true) ** 2, -1))
            / jnp.mean(jnp.sum(true**2, -1))
        )

    rng_i, rng_t, rng_p = jax.random.split(rng, 3)
    metrics = {}
    z = pde_instance.distribution_initial.sample(batch_size, rng_i)
    metrics["relative error of gradient estimation initial"] = rel_err(
        _split_xv(z)[0]
    )
    if pde_instance.distribution_terminal is not None:
        z = pde_instance.distribution_terminal.sample(batch_size, rng_t)
        metrics["relative error of gradient estimation terminal"] = rel_err(
            _split_xv(z)[0]
        )
    elif getattr(pde_instance, "sample_scheme", "") == "SDE":
        # 1024 fresh trajectories (~400k path states at production
        # n_steps): the former 64-trajectory probe left the path metric's
        # seed-to-seed std comparable to the 1e-2 threshold it adjudicates;
        # 16x more independent trajectories cuts it ~4x.  Simulation cost is test-cadence-only.
        _, term, path = pde_instance.sample_ground_truth(
            rng_p, sde_probe_trajectories
        )
        metrics["relative error of gradient estimation path"] = rel_err(
            _split_xv(path)[0]
        )
        metrics["relative error of gradient estimation terminal"] = rel_err(
            _split_xv(term)[0]
        )
    return metrics
