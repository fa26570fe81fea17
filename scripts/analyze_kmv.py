"""Post-hoc analysis of a non-parametric KMV interaction-kernel
checkpoint: where does the remaining gradient error live?

The KMV weak-form loss constrains grad Phi only through the mean-field
convolution over pairwise differences of path samples; the headline
metric (losses/kinetic_mckean_vlasov.py::test_fn) evaluates exactly that
argument distribution.  This script loads the latest Orbax checkpoint,
re-evaluates the interaction-gradient rel-L2 on a LARGE independent probe
(50k differences x 8 stamps by default), and bins the error by |y| (the
radius of the difference argument) — the direct test of the
bounded-feature tail-error mechanism documented in README (fixed random
cos features approximate a linearly growing gradient only on a bounded
region; trainable frequencies are the lever).

Usage:
  python scripts/analyze_kmv.py /tmp/r3_kmv_fk_trainable_ckpt
  python scripts/analyze_kmv.py /tmp/a,/tmp/b  preset=KMV \
      estimation_mode=non-parametric neural_network.hidden_dim=32 ...

The first positional is one checkpoint dir or a comma-separated list
(members are AVERAGED in gradient-field space, like analyze_np.py;
`--weights=a,b` for a weighted average, `--sweep` prints the full alpha
grid for a 2-member pair, `--probe-seed=N` draws an alternate probe so
weights can be selected held-out and reported on the default probe).
Member architectures are inferred PER MEMBER from each param tree, so
mixed-class stacks (fourier-kernel production members + MLP run
iterates via `dir@step`) are supported.  `--save-preds=f.npz` caches the
member fields + truth for the probe; `--load-preds=f.npz` replays them so
stacking experiments (ridge grids, weight sweeps) cost seconds.
Remaining args are config overrides; `preset=NAME` selects the base
preset (default KMV-nonparametric-fourier — the production FK recipe, so
FK checkpoints need no overrides).  Reference analogue: none (the
reference's KMV test_fn returns {},
/root/reference/methods/consistency_instances/kinetic_mckean_vlasov.py).
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
from pde_inverse.problems import KineticMcKeanVlasovQuadratic
from pde_inverse.utils.cache import enable_compilation_cache


def _load_checkpoint_params(ckpt_dir: str, use_ema_state: bool = False):
    import orbax.checkpoint as ocp

    # "dir@step" loads a specific saved step (default: latest) — lets the
    # oscillating iterates of one run be stacked as ensemble members
    # (--fit-weights), a post-hoc Polyak-style average in field space.
    step = None
    if "@" in ckpt_dir:
        ckpt_dir, step_s = ckpt_dir.rsplit("@", 1)
        step = int(step_s)
    mgr = ocp.CheckpointManager(os.path.abspath(ckpt_dir))
    if step is None:
        step = mgr.latest_step()
    restored = mgr.restore(step)
    # --ema: evaluate the decoupled Polyak average saved in ema_state
    # (trainer ema_mode=track) instead of the live iterate — mirrors
    # analyze_np.py; refuses un-engaged checkpoints (all-zeros init).
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
    preset_name = "KMV-nonparametric-fourier"
    use_ema_state = "--ema" in overrides
    probe_seed, weights, sweep = 123, None, "--sweep" in overrides
    fit_weights, weights_raw = "--fit-weights" in overrides, False
    fit_ridge = 0.0
    save_preds = load_preds = None
    rest = []
    for o in overrides:
        if o.startswith("preset="):
            preset_name = o.split("=", 1)[1]
        elif o.startswith("--fit-ridge="):
            # Tikhonov on the stacking Gram matrix, as a fraction of its
            # mean diagonal: near-duplicate members (iterates of one run)
            # make G ill-conditioned and the raw LS weights (~|w| 100+)
            # transfer imperfectly across probes; a small ridge trades a
            # little in-sample fit for held-out stability.
            fit_ridge = float(o.split("=", 1)[1])
        elif o.startswith("--save-preds="):
            save_preds = o.split("=", 1)[1]
        elif o.startswith("--load-preds="):
            load_preds = o.split("=", 1)[1]
        elif o.startswith("--probe-seed="):
            # held-out weight selection: pick --weights on one probe seed,
            # report on the default (123) — never tune on the eval probe
            probe_seed = int(o.split("=", 1)[1])
        elif o.startswith("--weights="):
            weights = [float(w) for w in o.split("=", 1)[1].split(",")]
        elif o.startswith("--weights-raw="):
            # verbatim stacking weights (e.g. from a --fit-weights run):
            # no normalization, negatives allowed — the LS solution
            # already absorbs the global scale
            weights = [float(w) for w in o.split("=", 1)[1].split(",")]
            weights_raw = True
        elif o not in ("--ema", "--sweep", "--fit-weights"):
            rest.append(o)

    if load_preds is not None:
        # Replay cached member fields: stacking experiments on a fixed
        # probe cost seconds instead of 400k-point field evals per member.
        data = np.load(load_preds)
        dirs = [str(s) for s in data["dirs"]]
        probe_seed = int(data["probe_seed"])
        batch, n_times = int(data["batch"]), int(data["n_times"])
        member_preds = [jnp.asarray(p) for p in data["P"]]
        true = jnp.asarray(data["true"])
        diff = jnp.asarray(data["diff"])
        print(f"replayed {len(member_preds)} member fields from {load_preds}")
        print(f"probe: PRNGKey({probe_seed}), {batch}x{n_times} diffs")
    else:
        dirs = [d for d in ckpt_dirs.split(",") if d]
        members = [_load_checkpoint_params(d, use_ema_state) for d in dirs]

        # The module must match the checkpoint's hypothesis: module.apply
        # SILENTLY ignores parameter entries the module never reads, so
        # rebuilding without the quadratic head while the checkpoint
        # carries quad_A/quad_b evaluates the Fourier component alone
        # (observed: a 0.06-trainer-metric quad-head member probing at
        # 0.48).  Infer the whole hypothesis class + architecture from
        # each parameter tree and append the matching overrides unless the
        # caller set them explicitly.
        p0 = members[0].get("params", members[0])

        def infer_overrides(p):
            out = []
            if "quad_A" in p:
                out.append("neural_network.quadratic_head=True")
                # quad_A is [d, d]: recover the problem dimension (a d=4
                # ckpt analyzed with the preset's d=2 otherwise fails
                # param reload)
                out.append(f"pde_instance.domain_dim={p['quad_A'].shape[0]}")
            if "omega" in p:  # fourier-kernel class (models/fourier_kernel.py)
                out.append("neural_network.model=fourier-kernel")
                out.append(
                    f"neural_network.fourier_features={p['omega'].shape[0]}"
                )
                if "quad_A" not in p:  # omega is [K, d]
                    out.append(f"pde_instance.domain_dim={p['omega'].shape[1]}")
            elif "Dense_0" in p:  # PotentialMLP stack (models/mlp.py)
                n_dense = sum(1 for k in p if k.startswith("Dense_"))
                hidden = p["Dense_0"]["kernel"].shape[1]
                feat = p[f"Dense_{n_dense - 1}"]["kernel"].shape[1]
                out.append("neural_network.model=mlp")
                out.append(f"neural_network.layers={n_dense - 1}")
                out.append(f"neural_network.hidden_dim={hidden}")
                out.append(f"neural_network.feature_dim={feat}")
                nf = p["fourier_B"].shape[1] if "fourier_B" in p else 0
                out.append(f"neural_network.fourier_features={nf}")
            return out

        def member_config(p, announce=False):
            ov = list(rest)
            for o in infer_overrides(p):
                key = o.split("=", 1)[0]
                if not any(r.startswith(key + "=") for r in ov):
                    if announce:
                        print(f"inferred from checkpoint: {o}")
                    ov.append(o)
            return preset(preset_name, ov)

        cfg = member_config(p0, announce=True)

        rng_problem = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[0]
        inst = KineticMcKeanVlasovQuadratic(cfg, rng_problem)
        # One module PER member: mixed-class stacks (e.g. fourier-kernel
        # production members + MLP run iterates) are the round-4
        # bias-diversity lever, and module.apply would silently ignore
        # params a mismatched module never reads (the quad-head pitfall
        # above, generalized).
        nets = []
        for mem in members:
            cfg_k = member_config(mem.get("params", mem))
            method_k = ConsistencyBased(
                pde_instance=inst, cfg=cfg_k, rng=rng_problem
            )
            net_k, _ = method_k.create_model_fn()
            nets.append(net_k)
        if len(members) > 1:
            print(f"ensemble of {len(members)} members: averaged gradient field")

        # Probe: same argument distribution as the headline test_fn
        # (pairwise differences of exact path samples across the horizon),
        # independent key, larger batch.
        batch, n_times = 50_000, 8
        rng_t, rng_z, rng_perm = jax.random.split(
            jax.random.PRNGKey(probe_seed), 3
        )
        ts = inst.distribution_time.sample(n_times, rng_t)
        means, covs = inst.oracle.moments_grid(ts)
        chols = jnp.linalg.cholesky(covs)
        eps = jax.random.normal(rng_z, (batch, n_times, means.shape[-1]))
        z = jnp.einsum("tij,ntj->nti", chols, eps) + means
        x = z[..., : inst.dim].reshape(-1, inst.dim)
        partner = jax.random.permutation(rng_perm, x.shape[0])
        diff = x - x[partner]

        @jax.jit
        def fields(y):
            preds = [
                ad.batched_grad(lambda yi, n=n, p=p: n.apply(p, yi)[0], y)
                for n, p in zip(nets, members)
            ]
            return preds, ad.batched_grad(inst.Phi_true_fn, y)

        # Self-describing header: a --probe-seed run must be
        # distinguishable from a default-probe run in the log itself
        # (held-out selection vs reporting numbers must never be mixed up
        # post hoc).
        print(f"probe: PRNGKey({probe_seed}), {batch}x{n_times} diffs")
        member_preds, true = fields(diff)
        if save_preds is not None:
            np.savez(
                save_preds,
                dirs=np.array(dirs),
                probe_seed=probe_seed,
                batch=batch,
                n_times=n_times,
                P=np.stack([np.asarray(p) for p in member_preds]),
                true=np.asarray(true),
                diff=np.asarray(diff),
            )
            print(f"saved member fields to {save_preds}")

    n_members = len(member_preds)
    if weights is not None and len(weights) != n_members:
        raise SystemExit("--weights length must match the member count")
    if sweep and n_members != 2:
        raise SystemExit(f"--sweep needs exactly 2 members, got {n_members}")
    w = np.asarray(weights if weights is not None else [1.0] * n_members)
    if weights_raw:
        if not np.isfinite(w).all():
            raise SystemExit(f"--weights-raw must be finite (got {w.tolist()})")
    else:
        # A zero sum would normalize to NaN and a negative sum silently
        # flips every weight's sign — reject both up front.
        if (w <= 0).any() or not np.isfinite(w.sum()) or w.sum() <= 0:
            raise SystemExit(f"--weights must be positive (got {w.tolist()})")
        w = w / w.sum()

    if fit_weights and n_members > 1:
        # Least-squares stacking: w* = argmin ||sum_i w_i p_i - true||^2
        # over the CURRENT probe (G w = r, G_ij = <p_i, p_j>).  Run with
        # --probe-seed=<held-out> to select, then report with
        # --weights-raw=<printed> on the default probe — the in-sample
        # stacked number printed here is a selection diagnostic, not the
        # headline.  Generalizes the 2-member --sweep alpha grid to N
        # members with the global rescale absorbed.
        P = np.stack([np.asarray(p).reshape(-1) for p in member_preds])
        t_flat = np.asarray(true).reshape(-1)
        G = P @ P.T
        r = P @ t_flat
        if fit_ridge > 0.0:
            G = G + fit_ridge * np.mean(np.diag(G)) * np.eye(G.shape[0])
            print(f"ridge: {fit_ridge} x mean-diag added to the Gram matrix")
        w = np.linalg.solve(G, r)
        print(
            "fitted stacking weights (LS on THIS probe; pass via "
            f"--weights-raw on the reporting probe): "
            f"{','.join(f'{x:.6f}' for x in w)}"
        )
    pred = sum(wi * p for wi, p in zip(w, member_preds))
    num = jnp.sum((pred - true) ** 2, -1)
    den = jnp.mean(jnp.sum(true**2, -1))
    if n_members > 1:
        if weights is not None:
            print(f"member weights: {np.round(w, 4).tolist()}")
        for d, p in zip(dirs, member_preds):
            r = float(jnp.sqrt(jnp.mean(jnp.sum((p - true) ** 2, -1)) / den))
            print(f"  member {d}: interaction-gradient rel-L2 {r:.4e}")
    if sweep and n_members == 2:
        # alpha grid over the 2-member convex combination, overall and
        # farthest-1% tail per alpha — the member fields are already in
        # hand, so the sweep is free numpy. Run with --probe-seed=N to
        # select alpha held-out, then report with --weights on the
        # default probe.
        p0, p1 = (np.asarray(p) for p in member_preds)
        t_np = np.asarray(true)
        r_all = np.linalg.norm(np.asarray(diff), axis=-1)
        tail = r_all >= np.quantile(r_all, 0.99)
        d_all = (t_np**2).sum(-1).mean()
        d_tail = (t_np[tail] ** 2).sum(-1).mean()
        print(f"alpha sweep (alpha = weight on first member, {dirs[0]}):")
        for a in np.round(np.arange(0.0, 1.01, 0.1), 2):
            pa = a * p0 + (1 - a) * p1
            e = ((pa - t_np) ** 2).sum(-1)
            print(
                f"  alpha={a:.1f}: rel-L2 {np.sqrt(e.mean() / d_all):.4e}"
                f"  far-1% {np.sqrt(e[tail].mean() / d_tail):.4e}"
            )
    print(
        "interaction-gradient rel-L2 "
        f"({batch*n_times} diffs, {n_times} stamps): "
        f"{float(jnp.sqrt(jnp.mean(num) / den)):.4e}"
    )

    # Scale-vs-distortion split (same diagnostic as analyze_np.py): best
    # scalar c for c*grad Phi — c<1 with a big drop = coherent shrinkage
    # (wd pull / field-reg bias), c~1 = distributed distortion.
    c = float(jnp.sum(pred * true) / jnp.sum(pred * pred))
    resc = float(jnp.sqrt(jnp.mean(jnp.sum((c * pred - true) ** 2, -1)) / den))
    print(f"best scalar rescale c={c:.4f}; rescaled rel-L2: {resc:.4e}")

    # Radius-binned error: |y| quantile bins.  For the quadratic truth
    # |grad Phi_true| grows linearly in |y|, so per-bin rel-L2 uses the
    # PER-BIN true norm — a flat profile means uniform relative accuracy;
    # rising outer bins = the bounded-feature tail mechanism.
    r_np = np.asarray(jnp.linalg.norm(diff, axis=-1))
    num_np, true_np = np.asarray(num), np.asarray(jnp.sum(true**2, -1))
    qs = np.quantile(r_np, [0.0, 0.5, 0.9, 0.99, 1.0])
    print(f"|y| quantiles (0/50/90/99/100%): {np.round(qs, 3)}")
    for lo, hi, label in [
        (0.0, qs[1], "nearest 50%"),
        (qs[1], qs[2], "50-90%"),
        (qs[2], qs[3], "90-99%"),
        (qs[3], np.inf, "farthest 1%"),
    ]:
        m = (r_np >= lo) & (r_np < hi)
        if m.sum():
            r = float(np.sqrt(num_np[m].mean() / true_np[m].mean()))
            print(
                f"  rel-L2 (per-bin norm), {label:12s} (|y| in [{lo:.2f},"
                f" {min(hi, r_np.max()):.2f})): {r:.4e}  [{m.sum()} pts]"
            )


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
