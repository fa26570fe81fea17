"""Consistency loss for the kinetic McKean-Vlasov equation (mean-field).

The unknown is the interaction kernel Phi; the mean-field convolution
(Phi * rho_t)(x) = E_ref[Phi(x - ref)] is estimated with the empirical
measure of the path samples themselves.  With weights
    w(s, x) = d2/ds2 log rho + (d/ds log rho)^2 + gamma d/ds log rho
(from the analytic Gaussian-path oracle), the loss is

    loss = E_{n,t} || E_ref grad Phi(x - ref) ||^2
         - 2 E_{n,t} E_ref [ v^T Hess Phi(x - ref) v ]
         + 2 E_{n,t} [ E_ref Phi(x - ref) * w(t, x) ]
         + E_{n,t} || E_ref grad Phi_true(x - ref) ||^2

Memory design (the [m, n, n_time, d] pairwise-difference tensor is the
reference's memory cliff, kinetic_mckean_vlasov.py:22-48): the reference
axis is processed in fixed-size chunks under ``lax.scan`` with
rematerialization, so peak memory is O(chunk * n * n_time * d) while the
FLOPs stay identical; with a mesh whose `ref` axis is >1 the chunks are
further partitioned across devices under ``shard_map`` with an explicit
``psum`` over the `ref` axis (see ``_pairwise_stats``).

Also fixes the reference's time/weight alignment: its
``reshape(-1, n_time)`` of a [n_time, n] array scrambles sample and time
axes for n_time > 1 (kinetic_mckean_vlasov.py:57-72); here weights are
computed directly in [n, n_time] layout.

Parity: /root/reference/methods/consistency_instances/kinetic_mckean_vlasov.py.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from pde_inverse.ops import autodiff as ad

# Chunk of the mean-field reference axis processed per scan step.
REF_CHUNK = 512


def _chunked_ref_sums(fn_stats, refs: jnp.ndarray, chunk: int, valid=None):
    """Masked-summed per-chunk statistics over the reference axis.

    fn_stats(ref_chunk [c, nt, d], mask [c]) -> pytree of masked *sums* over
    the chunk axis.  refs: [m, nt, d]; valid: optional [m] bool marking real
    (non-padding) refs.  Returns pytree of sums over the valid refs.
    """
    m = refs.shape[0]
    chunk = min(chunk, m)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    refs_p = jnp.pad(refs, ((0, pad), (0, 0), (0, 0)))
    refs_p = refs_p.reshape(n_chunks, chunk, *refs.shape[1:])
    idx = jnp.arange(n_chunks * chunk).reshape(n_chunks, chunk)
    masks = idx < m
    if valid is not None:
        masks = masks & jnp.pad(valid, (0, pad)).reshape(n_chunks, chunk)

    def body(acc, inputs):
        ref_c, mask_c = inputs
        stats = jax.checkpoint(fn_stats)(ref_c, mask_c)
        acc = jax.tree_util.tree_map(jnp.add, acc, stats)
        return acc, None

    # Seed the accumulator with the first chunk's REAL stats instead of a
    # zeros pytree: a synthesized-constant init gets hoisted out of any
    # enclosing scan (the trainer's fused chunk) and, under shard_map,
    # re-enters the Manual mesh context with an Auto sharding — a context
    # mismatch XLA rejects.  Derived-from-input init cannot be hoisted.
    init = jax.checkpoint(fn_stats)(refs_p[0], masks[0])
    total, _ = jax.lax.scan(body, init, (refs_p[1:], masks[1:]))
    return total


def _pairwise_stats(stats_flat, x, v, refs, chunk, mesh_spec=None, params=None):
    """Mean over refs of flat per-pair statistics.

    stats_flat(params, diff_flat [C, d], v_flat [C, d]) -> dict of [C] or
    [C, d] arrays, where C = c * n * nt flattens (chunk, sample, time).
    `params` is threaded through ``shard_map`` as an explicit operand (not
    a closure capture): trainer-replicated params carry an Auto-mesh
    NamedSharding in their avals, and grad-of-scan inside the Manual mesh
    context would otherwise fail building their zero cotangents.  The
    network evaluations stay 2-D: one fused batched eval instead of
    triple-nested vmaps.

    With a mesh whose `ref` axis is >1, the reference axis is partitioned
    across devices under ``shard_map``: each (data, ref) mesh cell computes
    partial sums of its x-shard against its ref-shard, partial sums reduce
    with ``lax.psum`` over the `ref` axis (an NCCL all-reduce on GPUs), and the result
    stays sharded over `data`.  This is the framework's "sequence parallel"
    (SURVEY.md §5): the m x n pairwise interaction is tiled over the 2-D
    mesh without ever materializing it.
    """
    m = refs.shape[0]
    n, nt, d = x.shape

    def fn_stats_builder(params_l, x_l, v_l):
        n_l = x_l.shape[0]

        def fn_stats(ref_c, mask_c):
            c = ref_c.shape[0]
            diff = x_l[None] - ref_c[:, None]  # [c, n_l, nt, d]
            diff_flat = diff.reshape(-1, d)  # [C, d]
            v_flat = jnp.broadcast_to(v_l[None], (c, n_l, nt, d)).reshape(-1, d)
            flat = stats_flat(params_l, diff_flat, v_flat)
            w = mask_c.astype(x_l.dtype)
            out = {}
            for name, s in flat.items():
                s = s.reshape((c, n_l, nt) + s.shape[1:])
                out[name] = jnp.tensordot(w, s, axes=(0, 0))  # sum over c
            return out

        return fn_stats

    def local_stats(params_l, x_l, v_l, refs_l, m_total):
        sums = _chunked_ref_sums(
            fn_stats_builder(params_l, x_l, v_l), refs_l, chunk
        )
        return jax.tree_util.tree_map(lambda s: s / m_total, sums)

    if mesh_spec is None or mesh_spec.n_ref == 1:
        return local_stats(params, x, v, refs, m)

    from jax.sharding import PartitionSpec as P

    n_ref = mesh_spec.n_ref
    n_data = mesh_spec.n_data
    if x.shape[0] % n_data != 0:
        # n axis not divisible by the data axis: fall back to ref-only
        # sharding with replicated x
        n_data = 1

    pad_m = -(-m // n_ref) * n_ref - m
    refs_p = jnp.pad(refs, ((0, pad_m), (0, 0), (0, 0)))
    # mask out padded refs inside the masked chunk sums
    ref_valid = jnp.arange(refs_p.shape[0]) < m

    def sharded(params_l, x_l, v_l, refs_l, valid_l):
        sums = _chunked_ref_sums(
            fn_stats_builder(params_l, x_l, v_l), refs_l, chunk, valid=valid_l
        )
        sums = jax.lax.psum(sums, "ref")
        return jax.tree_util.tree_map(lambda s: s / m, sums)

    data_spec = P("data") if n_data > 1 else P()
    return jax.shard_map(
        sharded,
        mesh=mesh_spec.mesh,
        in_specs=(P(), data_spec, data_spec, P("ref"), P("ref")),
        out_specs=data_spec,
        # inputs vary over different manual axes by design (x over data,
        # refs over ref); the cross terms are intended outer products
        check_vma=False,
    )(params, x, v, refs_p, ref_valid)


def compute_weights(pde_instance, taus: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """w(t, x) = d2s log rho + (ds log rho)^2 + gamma ds log rho, [n, nt]."""
    gamma = pde_instance.gamma_friction

    def per_time(s, x_t):  # x_t: [n, d]
        d1 = pde_instance.partial_s_log_density_fn(s, x_t)
        d2 = pde_instance.partial_s2_log_density_fn(s, x_t)
        return d2 + d1**2 + gamma * d1  # [n]

    w = jax.vmap(per_time, in_axes=(0, 1), out_axes=1)(taus, x)  # [n, nt]
    return w


def compute_weights_per_sample(
    pde_instance, taus: jnp.ndarray, x: jnp.ndarray
) -> jnp.ndarray:
    """Per-sample-stamp weights: taus [n, nt] (each trajectory on its own
    shifted grid, the offline-dataset layout), x [n, nt, d] -> [n, nt].
    The oracle's spectral moments evaluate elementwise in t, so this is one
    flat vmap over n*nt (time, point) pairs, not an n*nt Python loop."""
    gamma = pde_instance.gamma_friction
    d = x.shape[-1]
    flat_t = taus.reshape(-1)
    flat_x = x.reshape(-1, d)

    def per_elem(s, xi):
        d1 = pde_instance.partial_s_log_density_fn(s, xi[None])[0]
        d2 = pde_instance.partial_s2_log_density_fn(s, xi[None])[0]
        return d2 + d1**2 + gamma * d1

    return jax.vmap(per_elem)(flat_t, flat_x).reshape(taus.shape)


def compute_weights_grouped(
    pde_instance, taus_g: jnp.ndarray, x: jnp.ndarray
) -> jnp.ndarray:
    """Grouped offline weights: taus_g [G, nt] distinct shift grids, x
    [G, k, nt, d] trajectories ordered group-major (trajectory rows i of
    group g all share grid g).  Evaluates the spectral moment oracle once
    per (group, stamp) with a k-point batched density call — G*nt oracle
    reconstructions instead of the per-element path's n*nt
    (compute_weights_per_sample), a k-fold cut at 20k-trajectory scale.
    Returns [G, k, nt]."""
    gamma = pde_instance.gamma_friction

    def per_stamp(s, x_k):  # scalar stamp, [k, d] points of one group
        d1 = pde_instance.partial_s_log_density_fn(s, x_k)
        d2 = pde_instance.partial_s2_log_density_fn(s, x_k)
        return d2 + d1**2 + gamma * d1  # [k]

    per_group = jax.vmap(per_stamp, in_axes=(0, 1), out_axes=1)  # [k, nt]
    return jax.vmap(per_group)(taus_g, x)


# Target element count for one chunk's flattened [chunk * n * nt, d] pass;
# keeps peak live memory through the autodiff tape bounded (~a few hundred
# MB) regardless of batch geometry.
_CHUNK_ELEMENT_BUDGET = 4_000_000


def _quadratic_meanfield_stats(phi, x, v, ref_weights=None):
    """Exact mean-field statistics for an exactly-quadratic kernel phi.

    For phi(y) = 1/2 y^T H y + g0.y + c, the empirical mean over refs r
    (the samples at the same stamp) collapses to per-stamp sufficient
    statistics — O(n) instead of the O(n^2) pairwise grid, with IDENTICAL
    values (gated by an equality test against the chunked path):

        E_r grad phi(x - r)   = H (x - mbar_t) + g0
        E_r v^T Hess phi v    = v^T H v                    (r-independent)
        E_r phi(x - r)        = 1/2 (x-mbar_t)^T H (x-mbar_t)
                                + 1/2 tr(H S_t) + g0.(x-mbar_t) + c

    with mbar_t / S_t the per-stamp mean/covariance of the refs.  (H, g0,
    c) are read off phi by three autodiff probes at 0, so this works for
    any exactly-quadratic model without peeking at its params; gradients
    w.r.t. the model parameters flow through the probes.

    ref_weights [n, nt] (optional): raw per-(ref, stamp) importance
    weights with E_q[w] = 1 (tail-boost exact-law sampling, see
    problems/kfp_ou.sample_ground_truth_weighted).  The collapse then
    uses the UNCENTERED weighted moments W_t = mean_j w, M_t = mean_j w r,
    Q_t = mean_j w r^T H r:

        E_w grad     = (H x + g0) W_t - H M_t
        E_w v^T H v  = v^T H v W_t
        E_w phi(x-r) = (1/2 x^T H x + g0.x + c) W_t - x^T H M_t
                       - g0.M_t + Q_t / 2

    each an unbiased estimate of the true-law statistic; with w = 1 this
    reduces algebraically to the centered form above.

    x, v: [n, nt, d].  Returns {"nabla" [n,nt,d], "hess" [n,nt],
    "value" [n,nt]} — the same pytree _pairwise_stats yields.
    """
    n, nt, d = x.shape
    zero = jnp.zeros((d,), x.dtype)
    c0 = phi(zero)
    g0 = jax.grad(phi)(zero)
    H = jax.jacfwd(jax.grad(phi))(zero)  # [d, d]

    if ref_weights is not None:
        w = ref_weights
        W = jnp.mean(w, axis=0)  # [nt]
        M = jnp.mean(w[..., None] * x, axis=0)  # [nt, d]
        Q = jnp.einsum("nt,ntd,de,nte->t", w, x, H, x) / n  # [nt]
        xH = x @ H  # [n, nt, d]
        nabla = (xH + g0) * W[None, :, None] - (M @ H)[None]
        hess = jnp.einsum("ntd,de,nte->nt", v, H, v) * W[None, :]
        value = (
            (0.5 * jnp.einsum("ntd,ntd->nt", xH, x) + x @ g0 + c0)
            * W[None, :]
            - jnp.einsum("ntd,td->nt", xH, M)
            - (M @ g0)[None, :]
            + 0.5 * Q[None, :]
        )
        return {"nabla": nabla, "hess": hess, "value": value}

    mbar = jnp.mean(x, axis=0)  # [nt, d]
    diffc = x - mbar  # [n, nt, d]
    # per-stamp ref covariance trace term: tr(H S_t), S_t = cov of refs
    trHS = jnp.einsum("ntd,de,nte->t", diffc, H, diffc) / n  # [nt]
    nabla = jnp.einsum("de,nte->ntd", H, diffc) + g0
    hess = jnp.einsum("ntd,de,nte->nt", v, H, v)
    value = (
        0.5 * jnp.einsum("ntd,de,nte->nt", diffc, H, diffc)
        + 0.5 * trHS[None, :]
        + diffc @ g0
        + c0
    )
    return {"nabla": nabla, "hess": hess, "value": value}


def make_loss_fn(
    forward_fn,
    data,
    pde_instance,
    ref_chunk: int = REF_CHUNK,
    mesh_spec=None,
    closed_form_quadratic: bool = False,
    element_budget: int = _CHUNK_ELEMENT_BUDGET,
    blockwise_module=None,
    blockwise_rows: int = 0,
    field_reg: float = 0.0,
    field_reg_probes: int = 4096,
    field_reg_fourier_only: bool = False,
    field_reg_correction_only: bool = False,
    field_reg_probe_scale: float = 1.0,
):
    x_0T, v_0T = jnp.split(data["0T"], 2, axis=-1)
    d = x_0T.shape[-1]
    if "tau_0T" in data:
        # online grid_time: one shared stamp grid [nt]
        taus = data["tau_0T"]
        n_time = taus.shape[0]
        x = x_0T.reshape(-1, n_time, d)  # [n, nt, d]
        v = v_0T.reshape(-1, n_time, d)
        weights = compute_weights(pde_instance, taus, x)  # [n, nt]
    elif "tau_0T_groups" in data:
        # offline, group-stratified: G distinct shift grids [G, nt], rows
        # ordered group-major by the data policy (methods.py) — the weight
        # oracle runs once per (group, stamp).
        taus_g = data["tau_0T_groups"]
        G, n_time = taus_g.shape
        x = x_0T.reshape(-1, n_time, d)
        v = v_0T.reshape(-1, n_time, d)
        k = x.shape[0] // G
        weights = compute_weights_grouped(
            pde_instance, taus_g, x.reshape(G, k, n_time, d)
        ).reshape(-1, n_time)
    elif "tau_0T_per_traj" in data:
        # offline: each trajectory carries its own (strided, shifted) stamps
        # [n, nt]; the reference's offline policy has no KMV-usable stamps
        # at all (methods/consistency.py:90-118) — this path is new.
        taus_nm = data["tau_0T_per_traj"]
        n_traj, n_time = taus_nm.shape
        x = x_0T.reshape(n_traj, n_time, d)
        v = v_0T.reshape(n_traj, n_time, d)
        weights = compute_weights_per_sample(pde_instance, taus_nm, x)
    else:
        raise ValueError(
            "KMV loss needs time stamps: online grid_time sampling provides "
            "'tau_0T'; offline datasets must carry per-trajectory stamps "
            "('tau_0T' in the stored dataset, surfaced as 'tau_0T_groups' "
            "(grid-grouped) or 'tau_0T_per_traj' by the offline data "
            "policy). Got keys: " + str(sorted(data))
        )
    refs = x  # empirical mean-field measure = the samples themselves

    # Tail-boost importance weights (pde_instance.init_broaden > 1): the
    # batch is drawn from the per-stamp s-broadened law with raw weights
    # w = p_t/q_t (E_q[w] = 1) attached.  Both expectation layers of the
    # weak form change: the OUTER E_{x~rho_t} means become weighted means,
    # and the INNER mean-field reductions over the refs (= the same
    # broadened samples) become weighted per-stamp sufficient statistics.
    # Only the collapse paths support this — the O(n^2) pairwise
    # reductions would need the weights threaded through every chunk and
    # kernel tile for an estimator cell that is collapse-shaped anyway.
    w_0T = data.get("w_0T")
    wq = None
    if w_0T is not None:
        wq = w_0T.reshape(x.shape[0], n_time)
        from pde_inverse.losses import fourier_meanfield as fmf

        model_collapses = closed_form_quadratic or (
            blockwise_module is not None and fmf.supports(blockwise_module)
        )
        if not model_collapses:
            raise ValueError(
                "pde_instance.init_broaden > 1 on a KMV instance requires "
                "a collapse-path hypothesis class: the quadratic "
                "parametric model (solver.train.kmv_closed_form) or the "
                "fourier-kernel model (solver.train.kmv_blockwise); the "
                "O(n^2) pairwise paths do not thread importance weights"
            )
        if not getattr(pde_instance, "phi_true_is_quadratic", False):
            raise ValueError(
                "tail-boost KMV needs a quadratic Phi_true (the true-side "
                "statistics must collapse to weighted per-stamp moments)"
            )

    probe_diffs = None
    # field_reg may arrive as a traced scalar (step-annealed lambda from
    # methods.value_and_grad_fn); only a static Python 0/negative disables.
    field_reg_on = not (
        isinstance(field_reg, (int, float)) and field_reg <= 0.0
    )
    if field_reg_on:
        # Fixed strided probe pairs from the batch itself: the penalty
        # lambda * mean ||grad Phi(x_i - x_j)||^2 measures the gradient
        # FIELD on the same difference cloud the mean-field convolution
        # integrates over.  The weak form's value/Hessian terms are linear
        # in Phi, so finite-sample cancellation failure leaves descent
        # directions along which the field grows without bound (CLAUDE.md
        # round-3: norm explodes ~500x under wd<=1e-3); this pins exactly
        # that quantity.  Strided (deterministic) partners keep the step
        # jit-stable; coverage refreshes every step with the batch.
        xf = x.reshape(-1, d)  # flattened index = sample * nt + stamp
        n_pts = xf.shape[0]
        n_probe = min(field_reg_probes, n_pts)
        ii = jnp.arange(n_probe) % n_pts
        # partner offset is a multiple of nt, so ii and jj share the SAME
        # stamp (index mod nt is preserved mod n*nt) — matching the
        # same-stamp differences the mean-field reduction actually forms.
        # Pre-reducing the Python-int offset keeps ii + off < 2*n_pts (no
        # int32 overflow at any probe count).
        off = (7919 * n_time) % n_pts or n_time % n_pts
        jj = (ii + off) % n_pts
        probe_diffs = xf[ii] - xf[jj]  # [P, d]
        if field_reg_probe_scale > 1.0:
            # Tail coverage: spread probe radii log-uniformly from 1x to
            # scale x the data cloud (deterministic per-probe ladder, no
            # RNG — jit-stable).  See TrainConfig.kmv_field_reg_probe_scale.
            ladder = field_reg_probe_scale ** (
                jnp.arange(n_probe, dtype=jnp.float32) / max(n_probe - 1, 1)
            )
            probe_diffs = probe_diffs * ladder[:, None]

    # auto-scale the ref chunk so chunk * n * nt stays within budget
    per_ref = max(1, x.shape[0] * n_time)
    ref_chunk = max(1, min(ref_chunk, element_budget // per_ref))

    Phi_true = pde_instance.Phi_true_fn
    if closed_form_quadratic or getattr(
        pde_instance, "phi_true_is_quadratic", False
    ):
        # The TRUE side goes through the exact per-stamp sufficient
        # statistics whenever the instance declares Phi_true quadratic —
        # even when the MODEL side runs the generic pairwise reduction
        # (non-parametric Phi), this halves the O(n^2) work per step.
        # The model side is gated by the caller (parametric
        # QuadraticFormModel only). Phi_true_fn is written with
        # "...i,ij,...j" einsums, so it accepts an unbatched [d] point.
        true_stats = _quadratic_meanfield_stats(Phi_true, x, v, ref_weights=wq)
        mean_nabla_true = true_stats["nabla"]
    else:
        true_stats = _pairwise_stats(
            lambda _p, diff_flat, v_flat: {
                "nabla_true": ad.batched_grad(Phi_true, diff_flat)
            },
            x,
            v,
            refs,
            ref_chunk,
            mesh_spec,
        )
        mean_nabla_true = true_stats["nabla_true"]  # [n, nt, d]

    def omean(arr):
        """Outer E_{x~rho_t} mean of a per-(sample, stamp) array: a plain
        mean, or the importance-weighted unbiased mean under tail-boost."""
        return jnp.mean(arr) if wq is None else jnp.mean(wq * arr)

    loss_nabla_true = omean(jnp.sum(mean_nabla_true**2, axis=-1))

    def model_stats(params):
        Phi = lambda xi: forward_fn(params, xi)[0]
        if closed_form_quadratic:
            return _quadratic_meanfield_stats(Phi, x, v, ref_weights=wq)
        if blockwise_module is not None:
            from pde_inverse.losses import fourier_meanfield as fmf

            if fmf.supports(blockwise_module):
                # Random-Fourier-feature kernel hypothesis: the mean-field
                # expectations collapse EXACTLY to per-stamp sufficient
                # statistics — O((n+m)K), no pairwise grid at all
                # (losses/fourier_meanfield.py; equality-gated against the
                # generic O(n^2) reduction).
                return fmf.meanfield_stats(
                    blockwise_module, params, x, v, refs, ref_weights=wq
                )
            # matmul-shaped blockwise reduction for MLP kernels: first-layer
            # decomposition + fused 2nd-order forward propagation (see
            # losses/pairwise_blockwise.py). Equality-gated against the
            # generic chunked path below.
            from pde_inverse.losses import pairwise_blockwise as bw

            kwargs = {
                "mesh_spec": mesh_spec,
            }
            if blockwise_rows > 0:
                kwargs["rows_per_chunk"] = blockwise_rows
            return bw.mlp_pairwise_stats(
                blockwise_module, params, x, v, refs, **kwargs
            )

        def stats_flat(params_l, diff_flat, v_flat):
            Phi_l = lambda xi: forward_fn(params_l, xi)[0]
            # one fused forward-over-reverse pass: value (primal of the
            # forward), gradient (primal of the reverse), and Hessian
            # quadform (tangent) — three separate batched sweeps before
            val, nabla, hess = ad.batched_value_grad_hvp_quadform(
                Phi_l, diff_flat, v_flat
            )
            return {"nabla": nabla, "hess": hess, "value": val}

        return _pairwise_stats(
            stats_flat, x, v, refs, ref_chunk, mesh_spec, params=params
        )

    def loss_fn(params):
        """Returns (loss, gap): the mean-field accuracy diagnostic is
        computed from the SAME pairwise pass as the loss — the reference
        pays a full second sweep over the [m, n, t] pair grid for it every
        step (kinetic_mckean_vlasov.py:99-109)."""
        stats = model_stats(params)
        loss_nabla = omean(jnp.sum(stats["nabla"] ** 2, axis=-1))
        loss_hessian = omean(stats["hess"])
        loss_value = omean(stats["value"] * weights)
        loss = loss_nabla - 2.0 * loss_hessian + 2.0 * loss_value + loss_nabla_true
        if probe_diffs is not None:
            if field_reg_fourier_only:
                # semiparametric: pin only the bounded Fourier correction,
                # leave the quadratic head's parametric gradient
                # unpenalized (see fourier_meanfield.fourier_grad).
                from pde_inverse.losses import fourier_meanfield as fmf

                if blockwise_module is None or not fmf.supports(
                    blockwise_module
                ):
                    raise ValueError(
                        "kmv_field_reg_fourier_only requires the "
                        "fourier-kernel hypothesis (neural_network.model="
                        "fourier-kernel with kmv_blockwise on)"
                    )
                grad_probe = fmf.fourier_grad(
                    blockwise_module, params, probe_diffs
                )
            else:
                Phi = lambda xi: forward_fn(params, xi)[0]
                grad_probe = ad.batched_grad(Phi, probe_diffs)  # [P, d]
                if field_reg_correction_only:
                    # Semiparametric analogue of fourier_only for ANY
                    # quad-head hypothesis (MLP or fourier-kernel): pin
                    # only the non-parametric correction, leaving the
                    # exact quadratic component unpenalized.  Both heads
                    # are V += 1/2||A y||^2 + b.y (models/mlp.py,
                    # models/fourier_kernel.py), so the excluded gradient
                    # is (A^T A) y + b.
                    p_tree = (
                        params.get("params", params)
                        if isinstance(params, dict)
                        else params
                    )
                    if "quad_A" not in p_tree:
                        raise ValueError(
                            "kmv_field_reg_correction_only requires the "
                            "quadratic head (neural_network.quadratic_head"
                            "=True)"
                        )
                    AtA = p_tree["quad_A"].T @ p_tree["quad_A"]
                    grad_probe = grad_probe - (
                        probe_diffs @ AtA + p_tree["quad_b"]
                    )
            loss = loss + field_reg * jnp.mean(
                jnp.sum(grad_probe**2, axis=-1)
            )
        gap = omean(jnp.sum((mean_nabla_true - stats["nabla"]) ** 2, axis=-1))
        return loss, gap

    return loss_fn


def value_and_grad_fn(
    forward_fn,
    params,
    data,
    rng,
    pde_instance,
    mesh_spec=None,
    closed_form_quadratic: bool = False,
    element_budget: int = _CHUNK_ELEMENT_BUDGET,
    blockwise_module=None,
    blockwise_rows: int = 0,
    field_reg: float = 0.0,
    field_reg_probes: int = 4096,
    field_reg_fourier_only: bool = False,
    field_reg_correction_only: bool = False,
    field_reg_probe_scale: float = 1.0,
):
    loss_fn = make_loss_fn(
        forward_fn,
        data,
        pde_instance,
        mesh_spec=mesh_spec,
        closed_form_quadratic=closed_form_quadratic,
        element_budget=element_budget,
        blockwise_module=blockwise_module,
        blockwise_rows=blockwise_rows,
        field_reg=field_reg,
        field_reg_probes=field_reg_probes,
        field_reg_fourier_only=field_reg_fourier_only,
        field_reg_correction_only=field_reg_correction_only,
        field_reg_probe_scale=field_reg_probe_scale,
    )
    (loss, gap), grad = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return {
        "loss": loss,
        "grad": grad,
        "grad_norm": ad.pytree_l2_norm(grad),
        "loss ground truth": gap,
    }


def test_fn(forward_fn, pde_instance, rng, batch_size: int = 10_000, n_times: int = 8):
    """Relative L2 error of grad Phi over pairwise differences of PATH
    samples across the whole time horizon (the reference's KMV test_fn
    returns {}).

    Probe set: for each of n_times stamps t ~ U(0, T], draw batch_size
    exact path samples, pair each with a random permutation of the batch,
    and evaluate on the differences — the same distribution of arguments
    the mean-field convolution integrates over, not just a t=0 slice."""
    Phi = lambda x: forward_fn(x)[0]
    rng_t, rng_z, rng_perm = jax.random.split(rng, 3)
    ts = pde_instance.distribution_time.sample(n_times, rng_t)
    means, covs = pde_instance.oracle.moments_grid(ts)  # [t, D], [t, D, D]
    chols = jnp.linalg.cholesky(covs)
    eps = jax.random.normal(rng_z, (batch_size, n_times, means.shape[-1]))
    z = jnp.einsum("tij,ntj->nti", chols, eps) + means  # [n, t, D]
    x = z[..., : pde_instance.dim].reshape(-1, pde_instance.dim)
    partner = jax.random.permutation(rng_perm, x.shape[0])
    diff = x - x[partner]
    pred = ad.batched_grad(Phi, diff)
    true = ad.batched_grad(pde_instance.Phi_true_fn, diff)
    rel = jnp.sqrt(
        jnp.mean(jnp.sum((pred - true) ** 2, -1)) / jnp.mean(jnp.sum(true**2, -1))
    )
    return {"relative error of interaction gradient": rel}
