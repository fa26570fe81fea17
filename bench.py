"""Headline benchmark: residual-loss training-step throughput at 1M particles.

Measures the flagship kinetic-OU consistency objective (the reference's
scripts/run_KOU.sh scaled to a 1M-point path batch, per BASELINE.json's
north star) as FULL optimizer steps per second per chip, and compares
against a reference-faithful baseline implemented in the same process:

* baseline ("reference semantics"): one jit-dispatched value_and_grad per
  Python-loop step, moment oracle integrated with ``odeint`` inside the
  traced sampler (kinetic_fokker_planck_example_OU.py:73-93), a separate
  jitted optimizer step, and a host sync + NaN assert + metric fetch every
  step (core/trainer.py:85-113);
* ours: the fused lax.scan chunk (sampling via the matrix-exponential
  oracle, loss, grad, Adam update, all in one XLA program, one host sync
  per chunk).

Prints ONE JSON line:
  {"metric": ..., "value": steps/s, "unit": "steps/s", "vs_baseline": ratio,
   "device": {"platform", "kind", "count"}, ...}
It fails (non-zero exit) on a machine without a GPU, and on a GPU whose
``device_kind`` has no row in the peak table below.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax


N_TIME = 100
PER_TIME = 10_000  # 1M path points
BOUNDARY = 2_500
DIM = 4


def _cfg(per_time: int = PER_TIME):
    from pde_inverse.config import Config, apply_overrides

    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-Fokker-Planck",
            "pde_instance.domain_dim=%d" % DIM,
            "pde_instance.total_evolving_time=2",
            "solver.train.sample_mode=grid_time",
            f"solver.train.n_time_stamps={N_TIME}",
            f"solver.train.sample_per_time={per_time}",
            f"solver.train.batch_size_init={BOUNDARY}",
            f"solver.train.batch_size_terminal={BOUNDARY}",
            "train.optimizer.learning_rate.initial=1e-2",
            "train.optimizer.learning_rate.scheduling=cosine",
        ],
    )


def _build(per_time: int = PER_TIME):
    from pde_inverse.methods import ConsistencyBased
    from pde_inverse.problems import KineticFokkerPlanckOU
    from pde_inverse.training.optimizers import get_optimizer

    cfg = _cfg(per_time)
    rng = jax.random.PRNGKey(0)
    inst = KineticFokkerPlanckOU(cfg, rng)
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
    net, params = method.create_model_fn()
    opt = get_optimizer(cfg.train.optimizer)
    return cfg, inst, method, net, params, opt


def _program_cost(jitted, *args) -> dict:
    """{"flops", "transcendentals", "bytes_accessed"} of one execution of
    the compiled program, from XLA's own cost model (zeros if the backend
    doesn't expose it).  Pallas kernels are custom-calls the XLA cost
    model cannot see inside, so programs containing them are UNDERCOUNTED
    here."""
    try:
        cost = jitted.lower(*args).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):  # older jax returns [dict]
            cost = cost[0] if cost else {}
        return {
            "flops": float(cost.get("flops", 0.0) or 0.0),
            "transcendentals": float(cost.get("transcendentals", 0.0) or 0.0),
            "bytes_accessed": float(cost.get("bytes accessed", 0.0) or 0.0),
        }
    except Exception:
        return {"flops": 0.0, "transcendentals": 0.0, "bytes_accessed": 0.0}


def _program_flops(jitted, *args) -> float:
    return _program_cost(jitted, *args)["flops"]


def bench_ours(
    method, net, params, opt, n_steps=200, chunk=50, windows=1, boundary=None
):
    """Fused scan-chunk trainer: (steps/sec, FLOPs per step[, per-window
    rates]).

    windows > 1 repeats the measurement in the same process and reports
    the MEDIAN rate plus the per-window list."""

    def one_step(carry, rng, boundary=None):
        params, opt_state = carry
        kwargs = {} if boundary is None else {"boundary": boundary}
        out = method.value_and_grad_fn(net.apply, params, rng, **kwargs)
        updates, opt_state = opt.update(out["grad"], opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), out["loss"]

    @jax.jit
    def run_chunk(carry, rngs, boundary=None):
        # boundary (solver.train.boundary_reservoir): pre-sampled boundary
        # batch as a jit ARGUMENT, reused by every step — mirrors
        # training/trainer.py's reservoir plumbing
        step = lambda c, r: one_step(c, r, boundary)
        return jax.lax.scan(step, carry, rngs)

    carry = (params, opt.init(params))
    rngs = jax.random.split(jax.random.PRNGKey(1), chunk)
    cost = _program_cost(run_chunk, carry, rngs, boundary)
    flops_per_step = cost["flops"] / chunk
    bench_ours.last_cost_per_step = {k: v / chunk for k, v in cost.items()}
    carry, losses = run_chunk(carry, rngs, boundary)  # compile + warmup
    jax.block_until_ready(losses)

    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        done = 0
        while done < n_steps:
            carry, losses = run_chunk(carry, rngs, boundary)
            jax.block_until_ready(losses)
            assert np.isfinite(np.asarray(losses)).all()
            done += chunk
        rates.append(done / (time.perf_counter() - t0))
    rate = float(np.median(rates))
    if windows == 1:
        return rate, flops_per_step
    return rate, flops_per_step, rates


def bench_reference_semantics(inst, net, params, opt, n_steps=10):
    """Reference-faithful step: odeint oracle inside the traced sampler,
    one dispatch + host sync per step."""
    from jax.experimental.ode import odeint

    cfg_tr = inst.cfg.solver.train
    c = inst.configuration
    T = float(inst.total_evolving_time)
    gamma = inst.gamma_friction

    def odeint_moments(ts):
        # moment ODE integrated from 0 along the sorted grid, as the
        # reference does per step (…OU.py:73-93 via get_mean_cov)
        state0 = {"m": c["m_0"], "P": c["P_0"]}

        def ode(s, t):
            return {
                "m": c["F"] @ s["m"],
                "P": c["F"] @ s["P"] + s["P"] @ c["F"].T + c["L"],
            }

        full = odeint(ode, state0, jnp.concatenate([jnp.zeros([1]), ts]))
        return full["m"][1:], full["P"][1:]

    def sample_data(rng):
        rng_i, rng_t, rng_0T, rng_shift, rng_x = jax.random.split(rng, 5)
        n_time, per_time = cfg_tr.n_time_stamps, cfg_tr.sample_per_time
        shift = jax.random.uniform(rng_shift, (n_time,)) * (T / n_time)
        ts = jnp.linspace(0.0, T, n_time + 1)[:-1] + shift
        means, covs = odeint_moments(ts)
        # reference samples with an SVD sqrt per Gaussian
        def sqrtm(P):
            U, S, _ = jnp.linalg.svd(P)
            return U @ jnp.diag(jnp.sqrt(S)) @ U.T

        halves = jax.vmap(sqrtm)(covs)
        eps = jax.random.normal(rng_x, (per_time, n_time, 2 * DIM))
        z = jnp.einsum("tij,ntj->nti", halves, eps) + means
        return {
            "initial": inst.distribution_initial.sample(
                cfg_tr.batch_size_init, rng_i
            ),
            "terminal": inst.distribution_terminal.sample(
                cfg_tr.batch_size_terminal, rng_t
            ),
            "0T": z.reshape(-1, 2 * DIM),
        }

    from pde_inverse.losses import kinetic_fokker_planck as kfp_loss

    @jax.jit
    def value_and_grad(params, rng):
        data = sample_data(rng)
        return kfp_loss.value_and_grad_fn(net.apply, params, data, rng, inst)

    @jax.jit
    def step(params, opt_state, grad):
        updates, opt_state = opt.update(grad, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = opt.init(params)
    rngs = jax.random.split(jax.random.PRNGKey(1), n_steps + 1)

    # warmup/compile
    out = value_and_grad(params, rngs[0])
    params_w, opt_state_w = step(params, opt_state, out["grad"])
    jax.block_until_ready(params_w)

    t0 = time.perf_counter()
    p, s = params, opt_state
    for i in range(n_steps):
        out = value_and_grad(p, rngs[i + 1])
        p, s = step(p, s, out["grad"])
        # reference host-syncs every step: NaN assert + metric dict fetch
        out.pop("grad")
        host = jax.tree_util.tree_map(np.asarray, out)
        assert np.isfinite(host["loss"])
    jax.block_until_ready(p)
    dt = time.perf_counter() - t0
    return n_steps / dt


# Published peaks per device_kind (NVIDIA H100 SXM data sheet, dense, no
# sparsity; they assume the full 700 W power limit).  The loss path runs in
# f32, whose matmuls run in TF32 on the tensor cores by default, so the
# TF32 rate is the compute denominator.  A device not in the table is an
# error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "f32_flops": 67e12,
        "hbm_bytes": 3.35e12,
    },
}


def device_info() -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices; raises
    when there is no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX found {dev.platform!r} devices"
        )
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add a row to PEAKS")
    return PEAKS[kind]


def bench_np_step(
    n_steps=60, chunk=20, windows=3, reservoir=False, peak=None
):
    """Compute-bound production row: the online KGMM NON-PARAMETRIC step at
    the Run-E recipe geometry (400-step BAOAB SDE sampling through the
    scan simulator + Fourier-MLP weak-form loss on a 10k-trajectory
    batch).  This is the step that dominates real training wall-clock.
    Returns (median steps/s, per-window list, flops/step, mfu, cost)."""
    from pde_inverse.config import preset
    from pde_inverse.methods import ConsistencyBased
    from pde_inverse.problems import KineticFokkerPlanckGMM
    from pde_inverse.training.optimizers import get_optimizer

    cfg = preset(
        "KGMM-nonparametric-online",
        [
            "neural_network.quadratic_head=True",
            "solver.train.batch_size_0T=10000",
            "pde_instance.n_steps=400",
            "train.optimizer.weight_decay=0.0",
        ],
    )
    rng = jax.random.PRNGKey(0)
    inst = KineticFokkerPlanckGMM(cfg, jax.random.split(rng, 4)[0])
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
    net, params = method.create_model_fn()
    opt = get_optimizer(cfg.train.optimizer)
    # reservoir: the boundary batch pre-sampled once and fed per step as a
    # jit argument (solver.train.boundary_reservoir) — the step then has
    # no terminal SDE simulation in it
    boundary = (
        jax.jit(lambda k: method.sample_boundary(k))(jax.random.PRNGKey(40321))
        if reservoir
        else None
    )
    rate, flops_per_step, rates = bench_ours(
        method, net, params, opt, n_steps=n_steps, chunk=chunk,
        windows=windows, boundary=boundary,
    )
    mfu = flops_per_step * rate / peak if (flops_per_step and peak) else None
    return rate, rates, flops_per_step, mfu, bench_ours.last_cost_per_step


def bench_fk_step(n_steps=60, chunk=20, windows=3, collapse=True):
    """Non-parametric KMV interaction-kernel row: the Fourier-kernel
    hypothesis (preset KMV-nonparametric-fourier, trainable K=512 at
    7x2000) through its exact O((n+m)K) mean-field collapse
    (losses/fourier_meanfield.py) vs the same model driven through the
    generic O(n^2) pairwise reduction (collapse=False) — the measured
    price of the pairwise grid the collapse eliminates."""
    from pde_inverse.config import preset
    from pde_inverse.methods import ConsistencyBased
    from pde_inverse.problems import KineticMcKeanVlasovQuadratic
    from pde_inverse.training.optimizers import get_optimizer

    cfg = preset(
        "KMV-nonparametric-fourier",
        []
        if collapse
        else [
            "solver.train.kmv_blockwise=False",
            # the element budget counts PAIRS; the K=512 featurization
            # multiplies each pair's live footprint, so the generic-path
            # comparison needs a much smaller pair budget to fit memory
            "solver.train.kmv_element_budget=200000",
        ],
    )
    rng = jax.random.PRNGKey(0)
    inst = KineticMcKeanVlasovQuadratic(cfg, jax.random.split(rng, 4)[0])
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
    net, params = method.create_model_fn()
    opt = get_optimizer(cfg.train.optimizer)
    out = bench_ours(
        method, net, params, opt, n_steps=n_steps, chunk=chunk, windows=windows
    )
    # bench_ours returns (rate, flops) for windows==1, + per-window list otherwise
    rate, flops_per_step = out[0], out[1]
    rates = out[2] if len(out) > 2 else [rate]
    return rate, rates, flops_per_step


def bench_mlp_pairwise_step(n_steps=12, chunk=4, windows=3):
    """Non-parametric MLP KMV row: the production-architecture MLP
    hypothesis (hidden 20x8, feature 128) at the 7x2000 pair grid through
    the blockwise pairwise reduction.  This is the one hypothesis
    class that cannot collapse its mean-field expectations, i.e. the true
    O(n*m) path; the reference triple-vmaps the full [m, n, t, d] tensor
    for it (kinetic_mckean_vlasov.py:22-48)."""
    from pde_inverse.config import preset
    from pde_inverse.methods import ConsistencyBased
    from pde_inverse.problems import KineticMcKeanVlasovQuadratic
    from pde_inverse.training.optimizers import get_optimizer

    cfg = preset(
        "KMV-nonparametric-fourier",
        [
            "neural_network.model=mlp",
            "neural_network.fourier_features=0",
            "neural_network.fourier_trainable=False",
            "solver.train.kmv_field_reg=0.0",
            # the MLP cell's stabilizer (README): silences the
            # unstabilized-np warning and matches the production recipe
            "train.optimizer.weight_decay=1e-1",
            f"train.steps_per_chunk={chunk}",
        ],
    )
    rng = jax.random.PRNGKey(0)
    inst = KineticMcKeanVlasovQuadratic(cfg, jax.random.split(rng, 4)[0])
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
    net, params = method.create_model_fn()
    opt = get_optimizer(cfg.train.optimizer)
    out = bench_ours(
        method, net, params, opt, n_steps=n_steps, chunk=chunk, windows=windows
    )
    rate, flops_per_step = out[0], out[1]
    rates = out[2] if len(out) > 2 else [rate]
    return rate, rates, flops_per_step


def main():
    from pde_inverse.utils.cache import enable_compilation_cache

    device = device_info()
    peak = peaks(device["kind"])
    enable_compilation_cache()
    cfg, inst, method, net, params, opt = _build()
    ours, flops_per_step, windows = bench_ours(
        method, net, params, opt, windows=3
    )
    ref = bench_reference_semantics(inst, net, params, opt)
    result = {
        "metric": "KOU consistency train-step throughput @1M path points",
        "value": ours,
        "unit": "steps/s",
        "vs_baseline": ours / ref,
        "device": device,
        # absolute per-step wall times of both sides: the ratio's terms
        "ms_per_step_ours": 1e3 / ours,
        "ms_per_step_reference_semantics": 1e3 / ref,
        # model FLOP/s over the TF32 peak
        "mfu": flops_per_step * ours / peak["tf32_flops"] if flops_per_step else None,
        "flops_per_step": flops_per_step or None,
        "peak_flops_assumed": peak["tf32_flops"],
        "steps_per_sec_windows": windows,
    }

    # compute-bound production row: non-parametric KGMM online step, with
    # per-step boundary refresh (the recovery-grade cell) or, with
    # `--np-reservoir`, the boundary reservoir.
    np_res = "--np-reservoir" in sys.argv
    np_rate, np_windows, np_flops, np_mfu, np_cost = bench_np_step(
        reservoir=np_res, peak=peak["tf32_flops"]
    )
    result["np"] = {
        "metric": "KGMM non-parametric online step (Run-E geometry)",
        "boundary_reservoir": np_res,
        "steps_per_sec": np_rate,
        "steps_per_sec_windows": np_windows,
        "ms_per_step": 1e3 / np_rate,
        "flops_per_step": np_flops or None,
        "mfu": np_mfu,
        "transcendentals_per_step": np_cost["transcendentals"] or None,
        "bytes_accessed_per_step": np_cost["bytes_accessed"] or None,
        "hbm_bw_util": (
            np_cost["bytes_accessed"] * np_rate / peak["hbm_bytes"]
            if np_cost["bytes_accessed"]
            else None
        ),
    }

    # non-parametric KMV row: the Fourier-kernel mean-field collapse
    # (production trainable-frequency recipe).  `--fk-pairwise` adds the
    # same hypothesis through the generic pairwise reduction.
    fk_rate, fk_windows, _ = bench_fk_step()
    result["fk"] = {
        "metric": "KMV non-parametric fourier-kernel step (7x2000, K=512)",
        "steps_per_sec": fk_rate,
        "steps_per_sec_windows": fk_windows,
        "ms_per_step": 1e3 / fk_rate,
    }
    if "--fk-pairwise" in sys.argv:
        pw_rate, _, _ = bench_fk_step(n_steps=4, chunk=2, windows=1, collapse=False)
        result["fk"]["pairwise_steps_per_sec"] = pw_rate
        result["fk"]["collapse_speedup"] = fk_rate / pw_rate

    # non-parametric MLP KMV row: the genuine O(n*m) pairwise training step
    # at the production 7x2000 geometry.
    mp_rate, mp_windows, _ = bench_mlp_pairwise_step()
    result["mlp_pairwise"] = {
        "metric": "KMV non-parametric MLP pairwise step (7x2000, hidden 20x8)",
        "steps_per_sec": mp_rate,
        "steps_per_sec_windows": mp_windows,
        "ms_per_step": 1e3 / mp_rate,
    }

    # saturation probe: the large-batch end of the --scaling sweep
    _, _, m_sat, n_sat, p_sat, o_sat = _build(40_000)
    sat_rate, _ = bench_ours(m_sat, n_sat, p_sat, o_sat, n_steps=50, chunk=25)
    result["saturation"] = {
        "path_points": 40_000 * N_TIME,
        "steps_per_sec": sat_rate,
        "points_per_sec_M": sat_rate * 40_000 * N_TIME / 1e6,
    }
    print(json.dumps(result))


def scaling():
    """Batch-size scaling sweep of the fused step (one JSON line per size,
    human/diagnostic mode — the driver contract is the bare `python
    bench.py` single line).  Exposes the compute- vs dispatch-bound
    transition: below the knee, steps/s is flat (per-chunk dispatch +
    fixed program overhead dominate); above it, points/s is flat (the chip
    is saturated)."""
    from pde_inverse.utils.cache import enable_compilation_cache

    device = device_info()
    enable_compilation_cache()
    for per_time in (1_250, 2_500, 5_000, 10_000, 20_000, 40_000):
        cfg, inst, method, net, params, opt = _build(per_time)
        steps, _ = bench_ours(method, net, params, opt, n_steps=100, chunk=50)
        n_points = per_time * N_TIME
        print(
            json.dumps(
                {
                    "path_points": n_points,
                    "steps_per_sec": steps,
                    "ms_per_step": 1e3 / steps,
                    "points_per_sec": steps * n_points / 1e6,
                    "unit_points_per_sec": "M/s",
                    "device": device,
                }
            )
        )


if __name__ == "__main__":
    if "--scaling" in sys.argv:
        scaling()
    else:
        main()
