"""Plotting / visualization helpers.

Capability parity with /root/reference/utils/plot_utils.py (2-D/3-D
velocity-quiver animations, scatter and density heatmaps) and the density-
contour trajectory plot of core/log_density_estimation.py:140-188.  Files
are written to a run directory (wandb upload optional via the metric
writer) so runs work offline.  All imports are lazy —
matplotlib is not needed on the training path.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np


def _ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def plot_velocity_animation(
    z_0T: np.ndarray,
    out_path: str,
    interval_ms: int = 100,
) -> str:
    """Animated quiver of phase-space states z_0T [n_frames, n, 2d] for
    d in {2, 3}: positions x with velocity arrows v.
    (Parity: plot_utils.plot_velocity_2d/3d, plot_utils.py:11-78.)"""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    z_0T = np.asarray(z_0T)
    n_frames = z_0T.shape[0]
    d = z_0T.shape[-1] // 2
    if d not in (2, 3):
        raise ValueError("velocity animation supports 2-D or 3-D positions")

    fig = plt.figure(figsize=(6, 6))
    lim = float(np.abs(z_0T[..., :d]).max()) * 1.1 + 1e-6

    if d == 2:
        ax = fig.add_subplot()
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)

        def draw(i):
            ax.clear()
            ax.set_xlim(-lim, lim)
            ax.set_ylim(-lim, lim)
            x, v = z_0T[i, :, :2], z_0T[i, :, 2:4]
            ax.quiver(x[:, 0], x[:, 1], v[:, 0], v[:, 1], angles="xy")
            ax.set_title(f"frame {i}/{n_frames}")
    else:
        ax = fig.add_subplot(projection="3d")

        def draw(i):
            ax.clear()
            ax.set_xlim(-lim, lim)
            ax.set_ylim(-lim, lim)
            ax.set_zlim(-lim, lim)
            x, v = z_0T[i, :, :3], z_0T[i, :, 3:6]
            ax.quiver(
                x[:, 0], x[:, 1], x[:, 2], v[:, 0], v[:, 1], v[:, 2],
                length=0.3, normalize=True,
            )
            ax.set_title(f"frame {i}/{n_frames}")

    anim = animation.FuncAnimation(fig, draw, frames=n_frames, interval=interval_ms)
    _ensure_dir(os.path.dirname(out_path) or ".")
    anim.save(out_path, writer=animation.PillowWriter(fps=max(1, 1000 // interval_ms)))
    plt.close(fig)
    return out_path


def plot_scatter(samples: np.ndarray, out_path: str, dims=(0, 1)) -> str:
    """2-D scatter of a sample cloud (parity: plot_utils.py:81-99)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = np.asarray(samples)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(samples[:, dims[0]], samples[:, dims[1]], s=2, alpha=0.4)
    ax.set_xlabel(f"dim {dims[0]}")
    ax.set_ylabel(f"dim {dims[1]}")
    _ensure_dir(os.path.dirname(out_path) or ".")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_density_heatmap(
    samples: np.ndarray, out_path: str, dims=(0, 1), bins: int = 100
) -> str:
    """2-D density histogram heatmap (parity: plot_utils.py:102-121)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = np.asarray(samples)
    fig, ax = plt.subplots(figsize=(6, 6))
    h = ax.hist2d(samples[:, dims[0]], samples[:, dims[1]], bins=bins, cmap="viridis")
    fig.colorbar(h[3], ax=ax)
    _ensure_dir(os.path.dirname(out_path) or ".")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_density_trajectory(
    log_density_fn: Callable,
    out_path: str,
    t_min: float = 0.0,
    t_max: float = 10.0,
    grid_size: int = 100,
    n_time_points: int = 11,
    extent: float = 8.0,
) -> str:
    """Contour panels of exp(log_density_fn(t, xy)) over a time grid
    (parity: log_density_estimation.plot_trajectory_of_distributions)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import jax.numpy as jnp

    xs = np.linspace(-extent, extent, grid_size)
    X, Y = np.meshgrid(xs, xs)
    xy = jnp.asarray(np.stack([X.ravel(), Y.ravel()], axis=-1), jnp.float32)
    times = np.linspace(t_min, t_max, n_time_points)

    fig, axes = plt.subplots(
        1, n_time_points, figsize=(1.6 * n_time_points, 2.4), constrained_layout=True
    )
    for i, t in enumerate(times):
        logd = np.asarray(log_density_fn(jnp.float32(t), xy))
        dens = np.exp(logd).reshape(grid_size, grid_size)
        ax = axes[i] if n_time_points > 1 else axes
        ax.contourf(X, Y, dens, levels=50, cmap="viridis")
        ax.set_title(f"t = {t:.1f}", fontsize=8)
        ax.axis("off")
    _ensure_dir(os.path.dirname(out_path) or ".")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
