"""Post-hoc analysis of a non-parametric KGMM checkpoint: where does the
remaining gradient error live?

The weak-form consistency loss only constrains grad V where the path
measure rho_t has mass; the headline test metric draws from the BROAD
initial law N(0, 4I).  This script loads the latest Orbax checkpoint of a
non-parametric run, evaluates the gradient rel-L2 on (a) the initial law,
(b) fresh path samples, and (c) initial samples binned by distance to the
path support — evidence for whether the accuracy floor is estimator noise
or data coverage.

Usage: python scripts/analyze_np.py /tmp/np_ckpt_v4 [batch_size_0T=...]

Ensembling (round 3): pass a comma-separated list of checkpoint dirs
(`/tmp/a,/tmp/b,/tmp/c`) — runs differing only in train.data_seed share the
problem instance but carry independent estimator noise, so the AVERAGED
gradient field (mean over members of grad V_k) is evaluated; same-seed
error fields correlate ~0.5, predicting a ~30-40% error reduction.

Iterate stacking (round 4, mirrors analyze_kmv.py): `dir@step` selects a
specific saved step so the oscillating optimizer iterates of ONE run can
be stacked as members; `--fit-weights` solves the least-squares stacking
weights on the current probe (run with `--probe-seed=<held-out>` to
select, then report with `--weights-raw=<printed>` on the default probe
123 — never tune on the eval probe). On the KMV MLP cell this cut the
probe error 64% with zero extra training (artifacts/r4A/mlp_iter6_*).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pde_inverse.config import preset
from pde_inverse.methods import ConsistencyBased
from pde_inverse.ops import autodiff as ad
from pde_inverse.problems import KineticFokkerPlanckGMM
from pde_inverse.utils.cache import enable_compilation_cache


def _load_checkpoint_params(ckpt_dir: str, use_ema_state: bool):
    import orbax.checkpoint as ocp

    # "dir@step" loads a specific saved step (default: latest) — lets the
    # iterates of one run be stacked as ensemble members (--fit-weights).
    step = None
    if "@" in ckpt_dir:
        ckpt_dir, step_s = ckpt_dir.rsplit("@", 1)
        step = int(step_s)
    mgr = ocp.CheckpointManager(os.path.abspath(ckpt_dir))
    if step is None:
        step = mgr.latest_step()
    # Template-free restore: the trainer checkpoints {params, opt_state,
    # ema_state}; we only need params (already EMA'd past the switch step),
    # and a strict template would have to mirror the optimizer pytree.
    restored = mgr.restore(step)
    # --ema: evaluate the decoupled Polyak average saved in ema_state
    # (trainer ema_mode=track) instead of the live params.  Before the
    # switch step the EMA state is still its all-zeros init — evaluating
    # it would silently score a zero network.
    if use_ema_state:
        if int(restored["ema_state"]["count"]) == 0:
            raise SystemExit(
                "--ema requested but the checkpoint's EMA never engaged "
                "(count=0): evaluate without --ema or use a later checkpoint"
            )
        source = restored["ema_state"]["ema"]
    else:
        source = restored["params"]
    print(f"restored step {step} from {ckpt_dir} (ema={use_ema_state})")
    return jax.tree_util.tree_map(jnp.asarray, source)


def main(ckpt_dirs: str, overrides):
    enable_compilation_cache()
    use_ema_state = "--ema" in overrides
    probe_seed, weights, weights_raw = 123, None, False
    fit_weights = "--fit-weights" in overrides
    fit_ridge = 0.0
    rest = []
    for o in overrides:
        if o.startswith("--fit-ridge="):
            # Tikhonov on the stacking Gram matrix (fraction of its mean
            # diagonal) — near-duplicate iterate members make the raw LS
            # weights transfer imperfectly across probes (analyze_kmv.py)
            fit_ridge = float(o.split("=", 1)[1])
        elif o.startswith("--probe-seed="):
            # held-out weight selection: fit on one probe seed, report on
            # the default (123) — never tune on the eval probe
            probe_seed = int(o.split("=", 1)[1])
        elif o.startswith("--weights-raw="):
            # verbatim stacking weights (e.g. from a --fit-weights run):
            # no normalization, negatives allowed (LS absorbs the scale)
            weights = [float(w) for w in o.split("=", 1)[1].split(",")]
            weights_raw = True
        elif o.startswith("--weights="):
            weights = [float(w) for w in o.split("=", 1)[1].split(",")]
        elif o not in ("--ema", "--fit-weights"):
            rest.append(o)
    overrides = rest
    cfg = preset(
        "KGMM",
        [
            "estimation_mode=non-parametric",
            "neural_network.hidden_dim=64",
            "neural_network.layers=2",
            "neural_network.feature_dim=256",
            "neural_network.fourier_features=64",
            "neural_network.fourier_scale=1.0",
            "pde_instance.n_steps=200",
            "pde_instance.integrator=baoab",
        ]
        + list(overrides),
    )
    rng_problem = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[0]
    inst = KineticFokkerPlanckGMM(cfg, rng_problem)
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng_problem)
    net, _ = method.create_model_fn()

    dirs = [d for d in ckpt_dirs.split(",") if d]
    members = [_load_checkpoint_params(d, use_ema_state) for d in dirs]
    if len(members) > 1:
        print(f"ensemble of {len(members)} members: averaged gradient field")

    if weights is not None and len(weights) != len(members):
        raise SystemExit("--weights length must match the member count")
    w = np.asarray(weights if weights is not None else [1.0] * len(members))
    if weights_raw:
        if not np.isfinite(w).all():
            raise SystemExit(f"--weights-raw must be finite (got {w.tolist()})")
    else:
        # A zero sum would normalize to NaN and a negative sum silently
        # flips every weight's sign — reject both up front.
        if (w <= 0).any() or not np.isfinite(w.sum()) or w.sum() <= 0:
            raise SystemExit(f"--weights must be positive (got {w.tolist()})")
        w = w / w.sum()

    V_true = inst.V_true_fn

    @jax.jit
    def fields(x):
        """(per-member predicted gradients, true gradient) at x —
        computed once and reused by every metric below (the rescale block
        previously re-ran the 50k-point sweep unjitted, ADVICE round 2)."""
        preds = [
            ad.batched_grad(lambda xi: net.apply(p, xi)[0], x) for p in members
        ]
        return preds, ad.batched_grad(V_true, x)

    # Self-describing header: a --probe-seed run must be distinguishable
    # from a default-probe run in the log itself.
    print(f"probe: PRNGKey({probe_seed}), 50000 initial-law pts")
    key = jax.random.PRNGKey(probe_seed)
    k_init, k_path = jax.random.split(key)

    # (a) initial law
    z0 = inst.distribution_initial.sample(50_000, k_init)
    x0 = z0[:, : inst.dim]
    member_preds0, true0 = fields(x0)
    den0 = jnp.mean(jnp.sum(true0**2, -1))
    if fit_weights and len(members) > 1:
        # Least-squares stacking on the initial-law probe (the headline
        # metric): w* = argmin ||sum_i w_i p_i - true||^2.  Fit with
        # --probe-seed=<held-out>, report with --weights-raw=<printed>
        # on the default probe — the in-sample number printed below is a
        # selection diagnostic, not the headline.
        P = np.stack([np.asarray(p).reshape(-1) for p in member_preds0])
        t_flat = np.asarray(true0).reshape(-1)
        G = P @ P.T
        if fit_ridge > 0.0:
            G = G + fit_ridge * np.mean(np.diag(G)) * np.eye(G.shape[0])
            print(f"ridge: {fit_ridge} x mean-diag added to the Gram matrix")
        w = np.linalg.solve(G, P @ t_flat)
        print(
            "fitted stacking weights (LS on THIS probe; pass via "
            f"--weights-raw on the reporting probe): "
            f"{','.join(f'{x:.6f}' for x in w)}"
        )
    pred0 = sum(wi * p for wi, p in zip(w, member_preds0))
    num0 = jnp.sum((pred0 - true0) ** 2, -1)
    if len(members) > 1:
        if weights is not None:
            print(f"member weights: {np.round(w, 4).tolist()}")
        for d, mp in zip(dirs, member_preds0):
            r = float(jnp.sqrt(jnp.mean(jnp.sum((mp - true0) ** 2, -1)) / den0))
            print(f"  member {d}: initial-law rel-L2 {r:.4e}")
    print(f"initial-law rel-L2: {float(jnp.sqrt(jnp.mean(num0) / den0)):.4e}")

    # Scale-vs-distortion split: the best single scalar c for c*grad V_theta.
    # c far from 1 with a large error drop = coherent field shrinkage
    # (e.g. weight-decay pull); c ~ 1 with no drop = distributed distortion
    # (e.g. drift along the weak-form loss's near-null directions).
    c = float(jnp.sum(pred0 * true0) / jnp.sum(pred0 * pred0))
    resc = float(
        jnp.sqrt(jnp.mean(jnp.sum((c * pred0 - true0) ** 2, -1)) / den0)
    )
    print(f"best scalar rescale c={c:.4f}; rescaled initial-law rel-L2: {resc:.4e}")

    # (b) path law (fresh simulation, 2000 trajectories)
    _, _, path = jax.jit(lambda k: inst.sample_ground_truth(k, 2000))(k_path)
    xp = path[:, : inst.dim]
    member_predsp, truep = fields(xp)
    predp = sum(wi * p for wi, p in zip(w, member_predsp))
    nump = jnp.sum((predp - truep) ** 2, -1)
    denp = jnp.mean(jnp.sum(truep**2, -1))
    print(f"path-law    rel-L2: {float(jnp.sqrt(jnp.mean(nump) / denp)):.4e}")

    # (c) initial samples binned by distance to the path support.
    # Subsample the support set and chunk the test axis so the pairwise
    # distance block stays ~160 MB instead of the full n x m matrix.
    support = xp[
        jax.random.permutation(jax.random.PRNGKey(7), xp.shape[0])[:20_000]
    ]

    @jax.jit
    def min_dist(x, p):
        p2 = jnp.sum(p * p, -1)[None]

        def chunk_min(xc):
            x2 = jnp.sum(xc * xc, -1, keepdims=True)
            d2 = x2 + p2 - 2.0 * (xc @ p.T)
            return jnp.sqrt(jnp.maximum(jnp.min(d2, axis=1), 0.0))

        return jax.lax.map(chunk_min, x.reshape(-1, 2048, x.shape[-1])).reshape(-1)

    n_keep = (x0.shape[0] // 2048) * 2048
    x0, num0 = x0[:n_keep], num0[:n_keep]
    dist = np.asarray(min_dist(x0, support))
    num0 = np.asarray(num0)
    den0 = float(den0)
    qs = np.quantile(dist, [0.0, 0.5, 0.9, 0.99, 1.0])
    print(f"distance-to-path-support quantiles (0/50/90/99/100%): {np.round(qs, 3)}")
    for lo, hi, label in [
        (0.0, qs[1], "nearest 50%"),
        (qs[1], qs[2], "50-90%"),
        (qs[2], qs[3], "90-99%"),
        (qs[3], np.inf, "farthest 1%"),
    ]:
        m = (dist >= lo) & (dist < hi)
        if m.sum():
            r = float(np.sqrt(num0[m].mean() / den0))
            print(
                f"  initial-law rel-L2, {label:12s} (d in [{lo:.2f},"
                f" {min(hi, dist.max()):.2f})): {r:.4e}  [{m.sum()} pts]"
            )


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
