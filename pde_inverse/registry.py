"""Explicit string -> class registries.

Parity: /root/reference/registry.py — with the `return NotImplementedError`
bug (registry.py:26) fixed to raise a proper KeyError.
"""

from __future__ import annotations

from pde_inverse.config import Config
from pde_inverse.problems import (
    FokkerPlanck,
    KineticFokkerPlanckGMM,
    KineticFokkerPlanckOU,
    KineticMcKeanVlasovQuadratic,
)

PDE_INSTANCES = {
    ("Fokker-Planck", "Quadratic"): FokkerPlanck,
    ("Kinetic-Fokker-Planck", "Quadratic"): KineticFokkerPlanckOU,
    ("Kinetic-Fokker-Planck", "GMM"): KineticFokkerPlanckGMM,
    ("Kinetic-McKean-Vlasov", "Quadratic"): KineticMcKeanVlasovQuadratic,
}


def get_pde_instance(cfg: Config):
    key = (cfg.pde_instance.name, cfg.pde_instance.potential)
    if key not in PDE_INSTANCES:
        raise KeyError(
            f"no PDE instance for name={key[0]!r} potential={key[1]!r}; "
            f"available: {sorted(PDE_INSTANCES)}"
        )
    return PDE_INSTANCES[key]


def get_method(cfg: Config):
    from pde_inverse.methods import ConsistencyBased
    from pde_inverse.methods_pinn import PINN, PINNKinetic

    # The reference declares a PINN solver config but implements no code
    # for it (configurations/solver/PINN.yaml, registry.py:29-32 raises);
    # here it is functional for the overdamped AND kinetic FP instances.
    # PINN dispatch is guarded: the strong form needs pointwise density
    # knowledge, which only Gaussian-path (Quadratic) instances provide in
    # closed form; the overdamped PINN can alternatively consume a learned
    # flow (log_density.source="learned") trained on an offline dataset.
    if cfg.solver.name == "PINN":
        name, pot = cfg.pde_instance.name, cfg.pde_instance.potential
        if name == "Kinetic-McKean-Vlasov":
            raise ValueError(
                "PINN does not support Kinetic-McKean-Vlasov: the strong-form "
                "residual assumes a potential force, not a mean-field "
                "interaction. Use solver.name=ConsistencyBased."
            )
        if name.startswith("Kinetic"):
            if pot != "Quadratic":
                raise ValueError(
                    f"PINN on {name} requires a Gaussian-path instance "
                    f"(potential=Quadratic, closed-form phase-space law); got "
                    f"potential={pot!r}. Use solver.name=ConsistencyBased for "
                    "GMM instances."
                )
            if cfg.log_density.source == "learned":
                raise ValueError(
                    "log_density.source='learned' is only supported for the "
                    "overdamped PINN (the learned flow models the position "
                    "marginal, not the full phase-space law the kinetic "
                    "residual needs)."
                )
            return PINNKinetic
        if pot != "Quadratic" and cfg.log_density.source != "learned":
            raise ValueError(
                f"PINN on {name} with potential={pot!r} has no closed-form "
                "path law; set log_density.source=learned with an offline "
                "dataset, or use solver.name=ConsistencyBased."
            )
        if cfg.log_density.source == "learned" and cfg.pde_instance.sample_mode != "offline":
            raise ValueError(
                "log_density.source='learned' trains a flow on the offline "
                "dataset: set pde_instance.sample_mode=offline."
            )
        return PINN
    methods = {"ConsistencyBased": ConsistencyBased}
    if cfg.solver.name not in methods:
        raise KeyError(
            f"unknown solver {cfg.solver.name!r}; available: "
            f"{sorted(methods) + ['PINN']}"
        )
    return methods[cfg.solver.name]
