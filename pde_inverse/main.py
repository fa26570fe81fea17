"""CLI entry point.

Usage (Hydra-style overrides on a typed config, no Hydra dependency):

    python -m pde_inverse.main preset=KOU train.number_of_iterations=20000
    python -m pde_inverse.main config=configs/my.yaml seed=3 ...

Parity: /root/reference/main.py (wandb init -> 4-way seed split -> problem ->
method -> model -> optimizer -> trainer.fit), with the metric writer
pluggable (JSONL by default so runs work offline).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp

from pde_inverse import config as config_lib
from pde_inverse.config import Config
from pde_inverse.parallel.mesh import build_mesh
from pde_inverse.registry import get_method, get_pde_instance
from pde_inverse.training.metrics import make_writer
from pde_inverse.training.optimizers import get_optimizer
from pde_inverse.training.trainer import Trainer


def print_help() -> None:
    import dataclasses

    print(__doc__)
    print("presets (preset=<name>):")
    for name in sorted(config_lib.PRESETS):
        print(f"  {name}")
    print("\nconfig groups (override with dotted keys, e.g. "
          "train.optimizer.learning_rate.initial=1e-2):")
    for f in dataclasses.fields(Config):
        print(f"  {f.name}")
    print("\nfull schema: pde_inverse/config.py")


def parse_args(argv) -> Config:
    overrides = []
    cfg = None
    preset_name = None
    for arg in argv:
        if arg in ("-h", "--help", "help"):
            print_help()
            raise SystemExit(0)
        key, _, value = arg.partition("=")
        if key == "config":
            cfg = config_lib.load_yaml(value)
        elif key == "preset":
            preset_name = value
        else:
            overrides.append(arg)
    if preset_name is not None:
        return config_lib.preset(preset_name, overrides)
    cfg = cfg or Config()
    return config_lib.apply_overrides(cfg, overrides)


def maybe_init_distributed() -> None:
    """Multi-host initialization, opt-in via PDE_INVERSE_MULTIHOST=1.

    Each host runs the same program; jax.distributed.initialize wires the
    hosts so jax.devices() spans all of them and the mesh covers every
    card.  Set PDE_INVERSE_COORDINATOR (host:port) / _NUM_PROCESSES /
    _PROCESS_ID; without them JAX tries to detect a cluster.  No-op on a
    single host.  Exercised by the 2-process CPU smoke test
    (tests/test_multihost.py, Gloo collectives across processes).
    """
    import os

    if os.environ.get("PDE_INVERSE_MULTIHOST") != "1":
        return
    kwargs = {}
    if "PDE_INVERSE_COORDINATOR" in os.environ:
        kwargs = dict(
            coordinator_address=os.environ["PDE_INVERSE_COORDINATOR"],
            num_processes=int(os.environ["PDE_INVERSE_NUM_PROCESSES"]),
            process_id=int(os.environ["PDE_INVERSE_PROCESS_ID"]),
        )
    jax.distributed.initialize(**kwargs)


def build(cfg: Config):
    """(pde_instance, method, net, params) exactly as ``run`` trains them:
    the deterministic 4-way seed split (parity: main.py:43-44), the problem
    instance, the method (with a learned log-density first where the
    config asks for one) and the initialized hypothesis."""
    seed_names = ["rng_problem", "rng_method", "rng_trainer", "rng_log_density"]
    seeds = dict(
        zip(seed_names, jax.random.split(jax.random.PRNGKey(cfg.seed), len(seed_names)))
    )
    pde_instance = get_pde_instance(cfg)(cfg=cfg, rng=seeds["rng_problem"])
    method = get_method(cfg)(pde_instance=pde_instance, cfg=cfg, rng=seeds["rng_method"])

    if cfg.solver.name == "PINN" and cfg.log_density.source == "learned":
        # The reference's dormant design intent (main.py:50): estimate the
        # log-density by MLE on the offline trajectories, then hand the
        # learned flow to the solver.  Live end-to-end here.
        from pde_inverse.density.estimation import estimate_log_density

        if getattr(pde_instance, "dataset", None) is None:
            raise ValueError(
                "log_density.source='learned' requires an offline dataset "
                "(pde_instance.sample_mode=offline)"
            )
        print("[main] training RealNVP log-density on the offline dataset ...")
        method.log_density_fn = estimate_log_density(
            cfg, pde_instance, seeds["rng_log_density"], verbose=cfg.test.verbose
        )

    net, params = method.create_model_fn()
    return pde_instance, method, net, params


def trainer_rng(cfg: Config) -> jax.Array:
    """The trainer's key: the seed split's third key, or the data seed
    alone when ``train.data_seed >= 0``."""
    if cfg.train.data_seed >= 0:
        # Re-key the trainer RNG, keeping the problem instance (drawn from
        # rng_problem) fixed: runs that differ only in data_seed see the
        # same ground truth with independent estimator noise.  Note this
        # re-keys the trainer's test/plot sampling too (fold_in of the
        # trainer rng) — harmless for ensembling, where evaluation happens
        # post-hoc on a common key (scripts/analyze_np.py).  Same-`seed`
        # runs share sampling keys and their residual error fields
        # correlate; independent streams are the ingredient for
        # gradient-field ensembling.
        return jax.random.PRNGKey(cfg.train.data_seed)
    return jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[2]


def run(cfg: Config):
    from pde_inverse.utils.cache import enable_compilation_cache

    maybe_init_distributed()
    enable_compilation_cache()
    if cfg.backend.prng_impl != "threefry2x32":
        jax.config.update("jax_default_prng_impl", cfg.backend.prng_impl)
    pde_instance, method, net, params = build(cfg)
    optimizer = get_optimizer(cfg.train.optimizer)

    mesh_spec = build_mesh(cfg.backend) if cfg.backend.use_mesh else None

    run_name = (
        f"{cfg.pde_instance.domain_dim}D-{cfg.pde_instance.name}-"
        f"{cfg.pde_instance.potential}-{cfg.solver.name}-"
        f"{cfg.pde_instance.total_evolving_time}"
    )
    run_dir = f"{cfg.logging.run_dir}/{run_name}-seed{cfg.seed}"
    writer = make_writer(
        cfg.logging.writer,
        run_dir=run_dir,
        project=cfg.logging.project or run_name,
        config=config_lib.to_dict(cfg),
    )
    if cfg.logging.writer in ("jsonl", "csv"):
        from pde_inverse.utils.data import save_config

        save_config(cfg, run_dir)

    trainer = Trainer(
        cfg=cfg,
        method=method,
        rng=trainer_rng(cfg),
        forward_fn=net.apply,
        params=params,
        optimizer=optimizer,
        mesh_spec=mesh_spec,
        writer=writer,
        plot_dir=f"{run_dir}/plots" if cfg.plot.enable else None,
    )
    try:
        params_trained = trainer.fit()
    finally:
        writer.close()

    rel = pde_instance.recovered_parameter_rel_l2(jax.device_get(params_trained))
    if rel is not None:
        print(f"[result] recovered-parameter rel-L2: {float(rel):.4e}")
    else:
        # non-parametric model: report the test metrics instead
        metrics = method.test_fn(net.apply, params_trained, jax.random.PRNGKey(99))
        line = " ".join(f"{k}={float(v):.4e}" for k, v in metrics.items())
        print(f"[result] {line}" if metrics else "[result] done")
    return params_trained


def main():
    cfg = parse_args(sys.argv[1:])
    run(cfg)


if __name__ == "__main__":
    main()
