"""Blockwise pairwise mean-field statistics for MLP kernels.

The generic KMV pairwise reduction (losses/kinetic_mckean_vlasov.py) drives
autodiff over ``[C, d]`` tensors whose trailing dim is the tiny physical
dimension (d=2..4): a long chain of skinny elementwise ops bound by memory
bandwidth.  This module is the matmul-shaped reformulation for the (only)
hypothesis class that needs the pairwise path, the non-parametric
``PotentialMLP``:

* **First-layer decomposition.**  The pairwise input at stamp t is
  y = x_{i,t} - r_{j,t}, and everything the network does to y in its first
  linear stage factors through per-point projections:
  (x - r) @ W = x @ W - r @ W, and the Fourier phases (x - r) @ B = px - pr.
  Per-point projections are computed ONCE (``[n*nt, w]`` matmuls) and the
  O(n*m) pairwise work starts directly in the network's width-128+ feature
  space — no ``[C, d]`` tensors exist anywhere.
* **One fused propagation.**  Per ref-chunk tile, a single hand-rolled
  second-order forward-mode pass propagates (z, d_v z, d_v^2 z) through the
  layers, yielding the pair value Phi and the exact quadratic form
  v^T Hess Phi v together; a manual backward pass produces the first-layer
  cotangent, whose masked ref-sums give E_ref grad Phi after ONE final
  ``[n*nt, w] @ [w, d]`` projection.  (The generic path pays three separate
  autodiff evaluations per pair.)  Everything is jnp primitives, so
  ``jax.grad`` w.r.t. the parameters flows through for training.
* **Exact quadratic head.**  The PSD-quadratic + linear skip term is handled
  in closed form via per-stamp sufficient statistics (the same collapse as
  ``_quadratic_meanfield_stats``), contributing O(n*nt) work.

The ref axis is processed in chunks under ``lax.scan`` (remat per chunk) and
partitions across the mesh's `ref` axis exactly like the generic path.

Parity: the reference materializes the full [m, n, n_time, d] pairwise
tensor with triple-nested vmaps
(/root/reference/methods/consistency_instances/kinetic_mckean_vlasov.py:22-48);
there is no analogue of this reformulation there.  Equality with the
generic autodiff path is gated by tests/test_kmv_blockwise.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# Pair rows (= ref_chunk * n * nt) of width-`hidden` work per scan step of
# the blockwise reduction.  Each live [rows, 128] f32 buffer is rows*512
# bytes; the remat'd chunk body keeps a handful live (~1 GB at 1<<20).
# Bigger chunks also mean FEWER scan steps, which bounds the backward's
# per-step carry snapshots (grad-of-scan saves the carry each step: at
# 7x5000 a 1<<18 chunk made ~715 steps x ~5 MB carry ≈ 3.4 GB of saves).
_ROWS_PER_CHUNK = 1 << 20

# Matmul precision of the whole pair reduction (see mlp_pairwise_stats).
PRECISION = "float32"


def supports(module) -> bool:
    """True iff `module` is a PotentialMLP-structured net this fast path can
    propagate exactly (plain MLP stack + optional Fourier front end +
    optional quadratic head)."""
    from pde_inverse.models.mlp import PotentialMLP

    return isinstance(module, PotentialMLP)


def _unwrap(params):
    return params["params"] if "params" in params else params


def _act_d012(act, z):
    """(act(z), act'(z), act''(z)) for an elementwise activation, via two
    nested jvps with a ones tangent — generic over any smooth activation and
    fuses to the same elementwise XLA ops as hand-written derivatives."""
    ones = jnp.ones_like(z)
    d1 = lambda t: jax.jvp(act, (t,), (jnp.ones_like(t),))[1]
    a, da = jax.jvp(act, (z,), (ones,))
    d2a = jax.jvp(d1, (z,), (ones,))[1]
    return a, da, d2a


def _quad_head_stats(A, b, x, v, refs, valid):
    """Exact per-stamp mean-field SUMS of q(y) = 1/2 ||A y||^2 + b.y.

    x, v: [n, nt, d]; refs: [m, nt, d] with per-ref validity `valid`,
    either [m] (padding rows / uniform ref weights) or [m, nt]
    (per-(ref, stamp) importance weights — the tail-boost exact-law
    estimator, see problems/kfp_ou.sample_ground_truth_weighted).  With
    H = A^T A and per-stamp weighted ref moments m_t = sum_j w_{j,t},
    rsum_t = sum_j w_{j,t} r_{j,t}, rsq_t = sum_j w_{j,t} r^T H r:

        sum_j w_j q(x - r_j)           = m_t/2 x^T H x - x^T H rsum_t
                                         + rsq_t/2 + m_t b.x - b.rsum_t
        sum_j w_j grad q(x - r_j)      = m_t H x - H rsum_t + m_t b
        sum_j w_j v^T Hess q v         = m_t v^T H v

    Returns dict of weighted SUMS over refs, shaped {value [n,nt],
    nabla_direct [n,nt,d], hess [n,nt]}.
    """
    H = A.T @ A
    w = valid.astype(x.dtype)
    if w.ndim == 1:
        m_t = jnp.sum(w)  # scalar — broadcasts everywhere below
        m_nd = m_t
        rsum = jnp.einsum("m,mtd->td", w, refs)
        rsq = jnp.einsum("m,mtd,de,mte->t", w, refs, H, refs)
    else:
        m_t = jnp.sum(w, axis=0)[None, :]  # [1, nt]
        m_nd = m_t[..., None]  # [1, nt, 1] against [n, nt, d]
        rsum = jnp.einsum("mt,mtd->td", w, refs)
        rsq = jnp.einsum("mt,mtd,de,mte->t", w, refs, H, refs)
    xHx = jnp.einsum("ntd,de,nte->nt", x, H, x)
    xHr = jnp.einsum("ntd,td->nt", x @ H, rsum)
    value = (
        0.5 * m_t * xHx
        - xHr
        + 0.5 * rsq[None, :]
        + m_t * (x @ b)
        - (rsum @ b)[None, :]
    )
    nabla = m_nd * (x @ H) - (rsum @ H)[None, :, :] + m_nd * b
    hess = m_t * jnp.einsum("ntd,de,nte->nt", v, H, v)
    return {"value": value, "nabla_direct": nabla, "hess": hess}


def _mlp_structure(module, params):
    p = _unwrap(params)
    n_hidden = len(module.hidden_dims)
    layers = [
        (p[f"Dense_{k}"]["kernel"], p[f"Dense_{k}"]["bias"])
        for k in range(n_hidden + 1)
    ]
    B = p.get("fourier_B") if module.fourier_features > 0 else None
    quad = (p["quad_A"], p["quad_b"]) if module.quadratic_head else None
    from pde_inverse.models.mlp import _ACTIVATIONS

    return layers, B, quad, _ACTIVATIONS[module.activation], module.dtype


def _tile_stats(layers, act, dtype, ax, ar_c, av, px, pr_c, pv, mask_c):
    """Pairwise stats for one ref chunk, summed (masked) over the chunk.

    ax/av: [n, nt, w0] first-layer linear projections of points/velocities
    (ax includes the bias); ar_c: [c, nt, w0] of the ref chunk; px/pv/pr_c:
    Fourier phases (or None); mask_c: [c] validity.  Returns per-point SUMS
    over the chunk, FLAT (scan-carry-safe layouts): {"value" [n*nt],
    "hess" [n*nt], "s_dz0" [n*nt, w0], "s_dproj" [n*nt, nf]?}.
    """
    (W0, b0), mids = layers[0], layers[1:]
    c = ar_c.shape[0]
    n, nt, w0 = ax.shape
    cd = lambda a: a.astype(dtype)

    # first-layer preact + 1st/2nd tangents in direction v_i, flattened to
    # [c*n*nt, w0] — scan bodies stay 2-D with a 128-wide trailing dim
    z = (ax[None] - ar_c[:, None]).reshape(-1, w0)
    dz = jnp.broadcast_to(av[None], (c, n, nt, w0)).reshape(-1, w0)
    d2z = jnp.zeros_like(z)
    trig = None
    if px is not None:
        nf = px.shape[-1]
        d = W0.shape[0] - 2 * nf  # W0 rows: [y; cos; sin]
        W0c, W0s = cd(W0[d : d + nf]), cd(W0[d + nf :])
        p = (px[None] - pr_c[:, None]).reshape(-1, nf)
        dp = jnp.broadcast_to(pv[None], (c, n, nt, nf)).reshape(-1, nf)
        cosp, sinp = jnp.cos(p), jnp.sin(p)
        dp2 = dp * dp
        z = z + cosp @ W0c + sinp @ W0s
        dz = dz + (-sinp * dp) @ W0c + (cosp * dp) @ W0s
        d2z = d2z + (-cosp * dp2) @ W0c + (-sinp * dp2) @ W0s
        trig = (cosp, sinp, W0c, W0s)

    # hidden stack: propagate (z, dz, d2z), saving preacts for the backprop
    preacts = []
    for W, b in mids:
        preacts.append(z)
        a, da, d2a = _act_d012(act, z)
        h, dh = a, da * dz
        d2h = d2a * dz * dz + da * d2z
        W = cd(W)
        z = h @ W + cd(b)
        dz = dh @ W
        d2z = d2h @ W

    # squared-feature head
    zf = z.astype(jnp.float32)
    dzf = dz.astype(jnp.float32)
    d2zf = d2z.astype(jnp.float32)
    f = jnp.sum(zf * zf, axis=-1)  # [c*n*nt]
    d2f = 2.0 * jnp.sum(dzf * dzf + zf * d2zf, axis=-1)

    # backward to the first-layer cotangent
    delta = (2.0 * zf).astype(dtype)
    for (W, b), zk in zip(reversed(mids), reversed(preacts)):
        _, da, _ = _act_d012(act, zk)
        delta = (delta @ cd(W).T) * da

    w_mask = mask_c.astype(jnp.float32)
    N = n * nt

    def msum(t):
        """Masked sum over the chunk axis, FLAT output ([N] / [N, w]).

        Kept 2-D throughout — `[c, N*w]` reshape + axis-0 sum instead of a
        `[c, n, nt, w]` tensordot — so the `lax.scan` carry of the blockwise
        reduction has a wide trailing dim."""
        t = t.astype(jnp.float32)
        if t.ndim == 1:  # [c*N]
            return jnp.tensordot(w_mask, t.reshape(c, N), axes=(0, 0))
        w = t.shape[-1]
        masked = t * jnp.repeat(w_mask, N)[:, None]
        return jnp.sum(masked.reshape(c, N * w), axis=0).reshape(N, w)

    out = {"value": msum(f), "hess": msum(d2f), "s_dz0": msum(delta)}
    if trig is not None:
        cosp, sinp, W0c, W0s = trig
        dproj = (delta @ W0c.T) * (-sinp) + (delta @ W0s.T) * cosp
        out["s_dproj"] = msum(dproj)
    return out


def mlp_pairwise_stats(
    module,
    params,
    x: jnp.ndarray,
    v: jnp.ndarray,
    refs: jnp.ndarray,
    rows_per_chunk: int = _ROWS_PER_CHUNK,
    mesh_spec=None,
):
    """Per-stamp mean over refs of {Phi, grad Phi, v^T Hess Phi v} at
    y = x_{i,t} - r_{j,t}.

    x, v: [n, nt, d]; refs: [m, nt, d] — the empirical mean-field measure at
    stamp t is the refs at the SAME stamp (matching the generic path's
    broadcast, losses/kinetic_mckean_vlasov._pairwise_stats).  Returns
    {"nabla" [n, nt, d], "hess" [n, nt], "value" [n, nt]} — the same pytree
    `_pairwise_stats` yields.

    Every matmul here runs at full float32 precision (``PRECISION``),
    whatever the caller's default: with TF32 products the per-stamp
    v^T Hess Phi v sums sat 1.07e-2 and the worst gradient leaf 5.5e-2
    (relative) from a float32 evaluation at the 7 x 2000 geometry on an
    H100 at its 700 W limit, past the 1e-2 / 2e-2 the loss is held to.
    """
    with jax.default_matmul_precision(PRECISION):
        return _mlp_pairwise_stats(module, params, x, v, refs, rows_per_chunk, mesh_spec)


def _mlp_pairwise_stats(module, params, x, v, refs, rows_per_chunk, mesh_spec):
    n, nt, d = x.shape
    m = refs.shape[0]
    N = n * nt

    from pde_inverse.models.mlp import _ACTIVATIONS

    act = _ACTIVATIONS[module.activation]
    dtype = module.dtype
    cd = lambda a: a.astype(dtype)
    chunk = max(1, min(m, rows_per_chunk // max(N, 1)))

    def local_sums(params_l, x_l, v_l, refs_l, valid_l):
        """Masked sums over this device's ref shard (scan over chunks).
        `params_l` enters as an explicit operand (not a closure capture):
        under the trainer the replicated params carry an Auto-mesh
        NamedSharding in their avals, and grad-of-scan inside the Manual
        shard_map context cannot build zero cotangents for captured
        values."""
        layers, B, quad, _, _ = _mlp_structure(module, params_l)
        (W0, b0) = layers[0]
        W0y = cd(W0[:d])
        ax = cd(x_l) @ W0y + cd(b0)
        av = cd(v_l) @ W0y
        ar = cd(refs_l) @ W0y
        px = pv = pr = None
        if B is not None:
            Bc = cd(B)
            px, pv, pr = cd(x_l) @ Bc, cd(v_l) @ Bc, cd(refs_l) @ Bc

        m_l = refs_l.shape[0]
        n_chunks = -(-m_l // chunk)
        pad = n_chunks * chunk - m_l
        pad3 = ((0, pad), (0, 0), (0, 0))
        ar_p = jnp.pad(ar, pad3).reshape(n_chunks, chunk, nt, -1)
        mask_p = jnp.pad(valid_l, (0, pad)).reshape(n_chunks, chunk)
        pr_p = (
            jnp.pad(pr, pad3).reshape(n_chunks, chunk, nt, -1)
            if pr is not None
            else None
        )

        def body(acc, inp):
            ar_c, mask_c, pr_c = inp if pr_p is not None else (*inp, None)
            stats = jax.checkpoint(
                lambda a_c, m_c, p_c: _tile_stats(
                    layers, act, dtype, ax, a_c, av, px, p_c, pv, m_c
                )
            )(ar_c, mask_c, pr_c)
            return jax.tree_util.tree_map(jnp.add, acc, stats), None

        # First chunk seeds the accumulator (a zeros-constant init would be
        # hoisted out of an enclosing trainer scan and re-enter the
        # shard_map Manual mesh with an Auto sharding — rejected by XLA;
        # see the same pattern in kinetic_mckean_vlasov._chunked_ref_sums).
        init = jax.checkpoint(
            lambda a_c, m_c, p_c: _tile_stats(
                layers, act, dtype, ax, a_c, av, px, p_c, pv, m_c
            )
        )(ar_p[0], mask_p[0], None if pr_p is None else pr_p[0])
        xs = (
            (ar_p[1:], mask_p[1:])
            if pr_p is None
            else (ar_p[1:], mask_p[1:], pr_p[1:])
        )
        sums, _ = jax.lax.scan(body, init, xs)
        # un-flatten the scan-safe carry to the public [n, nt(, w)] shapes
        # (n from the operand: inside shard_map the data axis is LOCAL)
        n_l = x_l.shape[0]
        return {
            k: v.reshape((n_l, nt) + v.shape[1:]) for k, v in sums.items()
        }

    def finalize(sums):
        # final [N, w] @ [w, d] projections and the exact quadratic-head
        # sufficient statistics run OUTSIDE shard_map / the custom-vjp
        # boundary, on the original (Auto-context) params — plain
        # differentiable jnp
        layers_f, B_f, quad_f, _, _ = _mlp_structure(module, params)
        W0y_f = layers_f[0][0][:d].astype(jnp.float32)
        s_dz0 = sums["s_dz0"].astype(jnp.float32)
        nabla = s_dz0 @ W0y_f.T
        if "s_dproj" in sums:
            nabla = nabla + sums["s_dproj"] @ B_f.astype(jnp.float32).T
        value, hess = sums["value"], sums["hess"]
        if quad_f is not None:
            qs = _quad_head_stats(
                quad_f[0].astype(jnp.float32),
                quad_f[1].astype(jnp.float32),
                x.astype(jnp.float32),
                v.astype(jnp.float32),
                refs.astype(jnp.float32),
                valid=jnp.ones((m,), jnp.float32),
            )
            value = value + qs["value"]
            hess = hess + qs["hess"]
            nabla = nabla + qs["nabla_direct"]
        return {
            "nabla": nabla / m,
            "hess": hess / m,
            "value": value / m,
        }

    if mesh_spec is None or mesh_spec.n_ref == 1:
        return finalize(
            local_sums(params, x, v, refs, jnp.ones((m,), bool))
        )

    from jax.sharding import PartitionSpec as P

    n_ref = mesh_spec.n_ref
    n_data = mesh_spec.n_data
    if n % n_data != 0:
        n_data = 1
    pad_m = -(-m // n_ref) * n_ref - m
    rf_p = jnp.pad(refs, ((0, pad_m), (0, 0), (0, 0)))
    ref_valid = jnp.arange(rf_p.shape[0]) < m

    def sharded(params_l, x_l, v_l, refs_l, valid_l):
        sums = local_sums(params_l, x_l, v_l, refs_l, valid_l)
        return jax.lax.psum(sums, "ref")

    data_spec = P("data") if n_data > 1 else P()
    sums = jax.shard_map(
        sharded,
        mesh=mesh_spec.mesh,
        in_specs=(P(), data_spec, data_spec, P("ref"), P("ref")),
        out_specs=data_spec,
        check_vma=False,
    )(params, x, v, rf_p, ref_valid)
    return finalize(sums)
