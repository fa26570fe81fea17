"""Smoke run of the trainer on one GPU: the quickest proof that the system
still starts and trains correctly on the card.

    python chip_smoke.py               # phases a-e on one GPU
    python chip_smoke.py --four-cards  # the mesh phase alone, on four GPUs

One process, one phase after another, through the user's entry points
(``pde_inverse.main.run`` on a parsed preset).  Each phase prints its
steps/s after warm-up (the trainer's own rate over its training chunks
from the second on), the seconds spent compiling, and the device's peak
bytes in use so far; each comparison prints its precision, its measured
deviation and its tolerance, and raises when the deviation exceeds it.

  a. KOU flagship at the bench geometry (100 stamps x 10k points, d=4,
     2.5k boundary): a few chunks; loss and gradients at the default matmul
     precision against a HIGHEST-precision evaluation of the same batch.
  b. KOU recovery (50 x 500, 3000 steps): recovered drift rel-L2 < 1e-2.
  c. KMV non-parametric MLP pair reduction at 7 x 2000, hidden 20 x 8: a
     few steps; its per-stamp statistics, the loss and the gradients
     against a HIGHEST-precision evaluation of the same batch.
  d. KGMM non-parametric online at the np geometry (10k trajectories x 400
     BAOAB steps): first the simulator against the exact OU moments of a
     quadratic potential, then a few steps.
  e. preset KMV-nonparametric-fourier: a few steps.

``--four-cards`` runs phase a on a data=4 mesh and phase c on a (data=2,
ref=2) mesh, each against the same global batch on one card, and nothing
else.  Without a GPU the script exits non-zero before printing any result.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from pde_inverse import main as entry
from pde_inverse.config import BackendConfig, preset
from pde_inverse.parallel.mesh import build_mesh

KOU_BENCH = [
    "solver.train.sample_per_time=10000",
    "solver.train.n_time_stamps=100",
    "solver.train.batch_size_init=2500",
    "solver.train.batch_size_terminal=2500",
]
KOU_RECOVERY = [
    "solver.train.sample_per_time=500",
    "solver.train.n_time_stamps=50",
    "train.number_of_iterations=3000",
    "train.steps_per_chunk=500",
]
MLP_PAIRWISE = [  # bench.py's mlp_pairwise cell
    "neural_network.model=mlp",
    "neural_network.fourier_features=0",
    "neural_network.fourier_trainable=False",
    "solver.train.kmv_field_reg=0.0",
    "train.optimizer.weight_decay=1e-1",
]
NP_ONLINE = [  # bench.py's np cell
    "neural_network.quadratic_head=True",
    "solver.train.batch_size_0T=10000",
    "pde_instance.n_steps=400",
    "train.optimizer.weight_decay=0.0",
]

_compile_s = [0.0]


def _on_compile_event(event: str, duration: float, **_) -> None:
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


def _peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(phase: str, what: str, dev: float, tol: float, precision: str) -> None:
    print(f"[{phase}] {what}: {precision}, deviation {dev:.3e}, tolerance {tol:.1e}")
    if not dev <= tol:
        raise AssertionError(f"[{phase}] {what}: deviation {dev:.3e} > {tol:.1e}")


def check_tree(phase, what, got, want, tol, precision):
    """Worst leaf-wise relative L2 deviation of a gradient pytree."""
    devs = [_rel(g, w) for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want))]
    check(phase, what, max(devs), tol, precision)


def train(phase: str, name: str, overrides, steps: int, chunk: int):
    """Train through pde_inverse.main.run; print the phase's line."""
    run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    cfg = preset(
        name,
        list(overrides)
        + [
            f"train.number_of_iterations={steps}",
            f"train.steps_per_chunk={chunk}",
            f"test.frequency={steps}",
            "logging.writer=jsonl",
            f"logging.run_dir={run_dir}",
        ],
    )
    c0, t0 = _compile_s[0], time.perf_counter()
    params = entry.run(cfg)
    wall = time.perf_counter() - t0
    rate = None
    for root, _, files in os.walk(run_dir):
        if "metrics.jsonl" in files:
            with open(os.path.join(root, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f if "steps_per_sec" in line]
            rate = rows[-1]["steps_per_sec"]
    print(
        f"[{phase}] {name}: {steps} steps, {rate:.3f} steps/s after warm-up, "
        f"compile {_compile_s[0] - c0:.1f} s, wall {wall:.1f} s, "
        f"peak bytes in use {_peak_bytes()}",
        flush=True,
    )
    return cfg, params


def value_and_grad(cfg, params, mesh_spec=None, precision=None):
    """loss and gradient of one batch (fixed key) through the method."""
    _, method, net, _ = entry.build(cfg)
    method.mesh_spec = mesh_spec
    fn = jax.jit(lambda p, k: method.value_and_grad_fn(net.apply, p, k))
    key = jax.random.PRNGKey(1234)
    if precision is None:
        out = fn(params, key)
    else:
        with jax.default_matmul_precision(precision):
            out = fn(params, key)
    return float(out["loss"]), jax.device_get(out["grad"])


def phase_a():
    cfg, params = train("a", "KOU", KOU_BENCH, steps=150, chunk=50)
    loss, grad = value_and_grad(cfg, params)
    loss_hi, grad_hi = value_and_grad(cfg, params, precision="highest")
    # TF32 keeps ~3 decimal digits per product; the loss and gradient are
    # means over 1M points, so their relative error stays near 1e-3.
    check("a", "loss vs HIGHEST", abs(loss - loss_hi) / abs(loss_hi), 1e-2, "default matmul precision")
    check_tree("a", "gradient leaves vs HIGHEST", grad, grad_hi, 1e-2, "default matmul precision")


def phase_b():
    cfg, params = train("b", "KOU", KOU_RECOVERY[:2], steps=3000, chunk=500)
    inst, _, _, _ = entry.build(cfg)
    rel = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
    check("b", "recovered drift rel-L2", rel, 1e-2, "default matmul precision")


def _mlp_batch(cfg):
    """The pair reduction's per-stamp statistics on one sampled batch."""
    from pde_inverse.losses import pairwise_blockwise as bw

    _, method, net, _ = entry.build(cfg)
    data = jax.jit(method.sample_data)(jax.random.PRNGKey(77))
    d = cfg.pde_instance.domain_dim
    nt = cfg.solver.train.n_time_stamps
    z = data["0T"].reshape(-1, nt, 2 * d)
    x, v = z[..., :d], z[..., d:]

    return lambda p: bw.mlp_pairwise_stats(net, p, x, v, x)


def phase_c():
    cfg, params = train("c", "KMV-nonparametric-fourier", MLP_PAIRWISE, steps=8, chunk=4)
    from pde_inverse.losses import pairwise_blockwise as bw

    print(f"[c] pair reduction: blockwise jnp scan, matmul precision {bw.PRECISION}")
    stats = _mlp_batch(cfg)
    got = jax.jit(stats)(params)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(stats)(params)
    # means over 2000 refs; TF32 layer chains measured 1.07e-2 on hess
    for key in ("value", "nabla", "hess"):
        check("c", f"per-stamp {key} vs HIGHEST", _rel(got[key], want[key]), 1e-2, "default matmul precision")
    loss, grad = value_and_grad(cfg, params)
    loss_hi, grad_hi = value_and_grad(cfg, params, precision="highest")
    check("c", "loss vs HIGHEST", abs(loss - loss_hi) / abs(loss_hi), 1e-2, "default matmul precision")
    check_tree("c", "gradient leaves vs HIGHEST", grad, grad_hi, 2e-2, "default matmul precision")


def phase_d():
    from pde_inverse.ops import ou
    from pde_inverse.ops.simulate import simulate
    from pde_inverse.potentials import QuadraticPotential

    # quadratic potential: the kinetic Langevin law is an exact OU process
    d, n, n_steps, dt, gamma = 2, 200_000, 200, 0.01, 1.0
    pot = QuadraticPotential.create(jnp.zeros(d), jnp.eye(d))
    m0 = jnp.concatenate([jnp.ones(d), jnp.zeros(d)])
    z0 = m0 + 0.5 * jax.random.normal(jax.random.PRNGKey(3), (n, 2 * d))
    final, _, _ = jax.jit(
        lambda k, z: simulate(k, z, n_steps, dt, pot, gamma, return_trajectory=False, integrator="baoab")
    )(jax.random.PRNGKey(4), z0)
    eye, zero = jnp.eye(d), jnp.zeros((d, d))
    F = jnp.block([[zero, eye], [-eye, -gamma * eye]])
    L = jnp.block([[zero, zero], [zero, 2.0 * eye]])
    mean, cov = ou.lti_moments(F, L, m0, 0.25 * jnp.eye(2 * d), jnp.float32(n_steps * dt))
    final = np.asarray(final, np.float64)
    check("d", "simulated mean vs exact OU mean", float(np.max(np.abs(final.mean(0) - mean))), 1e-2, "scan simulator, f32")
    check("d", "simulated cov vs exact OU cov", _rel(np.cov(final.T), cov), 2e-2, "scan simulator, f32")
    train("d", "KGMM-nonparametric-online", NP_ONLINE, steps=40, chunk=20)


def phase_e():
    train("e", "KMV-nonparametric-fourier", [], steps=200, chunk=100)


def four_cards():
    n = len(jax.devices())
    if n < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {n}")
    cfg_a = preset("KOU", KOU_BENCH + ["backend.data_axis_size=4"])
    _, _, _, params = entry.build(cfg_a)
    spec = build_mesh(BackendConfig(data_axis_size=4))
    # Same global batch at HIGHEST on both sides, so only the order of the
    # cross-card sums differs: at the default precision the two programs
    # round different products to TF32 (the one-card and mesh KMV losses
    # then differ by 1.6e-3, as much as TF32 moves either from float32).
    loss1, grad1 = value_and_grad(cfg_a, params, precision="highest")
    loss4, grad4 = value_and_grad(cfg_a, params, mesh_spec=spec, precision="highest")
    check("4a", "loss data=4 vs one card", abs(loss4 - loss1) / abs(loss1), 1e-4, "HIGHEST")
    check_tree("4a", "gradient leaves data=4 vs one card", grad4, grad1, 1e-3, "HIGHEST")
    train("4a", "KOU", KOU_BENCH + ["backend.data_axis_size=4"], steps=100, chunk=50)

    mlp = MLP_PAIRWISE + ["backend.data_axis_size=2", "backend.ref_axis_size=2"]
    cfg_c = preset("KMV-nonparametric-fourier", mlp)
    _, _, _, params = entry.build(cfg_c)
    spec = build_mesh(BackendConfig(data_axis_size=2, ref_axis_size=2))
    loss1, grad1 = value_and_grad(cfg_c, params, precision="highest")
    loss4, grad4 = value_and_grad(cfg_c, params, mesh_spec=spec, precision="highest")
    check("4c", "loss (data=2, ref=2) vs one card", abs(loss4 - loss1) / abs(loss1), 1e-4, "HIGHEST")
    check_tree("4c", "gradient leaves (data=2, ref=2) vs one card", grad4, grad1, 1e-3, "HIGHEST")
    train("4c", "KMV-nonparametric-fourier", mlp, steps=4, chunk=2)


def main(argv) -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_compile_event)
    from pde_inverse.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if "--four-cards" in argv:
        four_cards()
    else:
        phase_a()
        phase_b()
        phase_c()
        phase_d()
        phase_e()
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
