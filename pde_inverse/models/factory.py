"""Model factory (parity: get_model, reference core/model.py:109-131)."""

from __future__ import annotations

import jax.numpy as jnp

from pde_inverse.config import Config
from pde_inverse.models.mlp import PotentialMLP, ResNetPotential


def get_model(cfg: Config, pde_instance=None):
    """Dispatch on estimation_mode: parametric models come from the problem
    instance (their weights are the physical parameters); non-parametric is
    an MLP (or ResNet) potential."""
    if cfg.estimation_mode == "parametric":
        if pde_instance is None:
            raise ValueError("parametric mode requires a pde_instance")
        return pde_instance.create_parametric_model()
    if cfg.estimation_mode == "non-parametric":
        net = cfg.neural_network
        dtype = jnp.bfloat16 if net.dtype == "bfloat16" else jnp.float32
        if net.model == "fourier-kernel":
            from pde_inverse.models.fourier_kernel import FourierKernelModel

            if pde_instance is None:
                raise ValueError("fourier-kernel model requires a pde_instance")
            return FourierKernelModel(
                dim=pde_instance.dim,
                n_features=net.fourier_features or 256,
                freq_scale=net.fourier_scale,
                quadratic_head=net.quadratic_head,
                trainable_frequencies=net.fourier_trainable,
                freq_init=net.fourier_init,
            )
        if net.model == "bilinear-debug":
            from pde_inverse.models.mlp import BilinearDebugPotential

            return BilinearDebugPotential()
        if net.model != "mlp":
            raise ValueError(f"unknown neural_network.model {net.model!r}")
        if net.n_resblocks > 0:
            return ResNetPotential(
                hidden_dim=net.hidden_dim,
                n_blocks=net.n_resblocks,
                feature_dim=net.feature_dim,
                activation=net.activation,
                dtype=dtype,
            )
        return PotentialMLP(
            hidden_dims=[net.hidden_dim] * net.layers,
            feature_dim=net.feature_dim,
            activation=net.activation,
            dtype=dtype,
            fourier_features=net.fourier_features,
            fourier_scale=net.fourier_scale,
            quadratic_head=net.quadratic_head,
        )
    raise ValueError(f"unknown estimation_mode {cfg.estimation_mode!r}")
