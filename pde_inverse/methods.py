"""Method layer: the consistency-based estimator and its data policy.

Parity: /root/reference/methods/consistency.py (``ConsistencyBased``) and
/root/reference/api.py:67-103 (``Method``).  The per-PDE loss modules live
in ``pde_inverse.losses``; this class dispatches to them and implements
the three data-sampling policies:

* online + exact  — sample initial/terminal/path batches from the closed-
  form Gaussian law every step (inside jit, on device);
* online + SDE    — the problem simulates (initial, terminal, path) with the
  Langevin kernel every step (the reference's version of this path crashes,
  see problems/kfp_gmm.py);
* offline         — full initial/terminal sets plus a strided random
  subsample of the stored trajectories (stride 5 in both time and
  trajectory axes, matching consistency.py:90-118).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp

from pde_inverse.config import Config
from pde_inverse.losses import LOSS_MODULES
from pde_inverse.problems.base import ProblemInstance


@dataclass
class Method:
    pde_instance: ProblemInstance
    cfg: Config
    rng: jax.Array

    def value_and_grad_fn(
        self, forward_fn, params, rng, step=None
    ) -> Dict[str, Any]:
        raise NotImplementedError

    def test_fn(self, forward_fn, params, rng) -> Dict[str, Any]:
        return {}

    def plot_fn(self, forward_fn, params, rng) -> None:
        return None

    def create_model_fn(self):
        raise NotImplementedError


class ConsistencyBased(Method):
    """Weak-form consistency estimator over {FP, KFP, KMV}."""

    # Set by the trainer to shard per-step batches over the mesh's data axis
    # (parallel.mesh.MeshSpec); None = single-device.
    mesh_spec = None

    def _loss_module(self):
        name = self.cfg.pde_instance.name
        if name not in LOSS_MODULES:
            raise KeyError(f"no consistency loss for {name!r}")
        return LOSS_MODULES[name]

    def create_model_fn(self):
        from pde_inverse.models import get_model

        net = get_model(self.cfg, self.pde_instance)
        self._model = net
        tr = self.cfg.solver.train
        if (
            self.cfg.pde_instance.name == "Kinetic-McKean-Vlasov"
            and self.cfg.estimation_mode == "non-parametric"
            and self.cfg.train.optimizer.weight_decay < 1e-1
            and tr.kmv_field_reg <= 0.0
        ):
            print(
                "[warn] non-parametric KMV without a stabilizer: the "
                "weak-form loss's linear-in-Phi terms leave unbounded "
                "finite-sample descent directions (README: field norm "
                "explodes ~500x under wd<=1e-3 within ~1k steps). Set "
                "train.optimizer.weight_decay=1e-1 or "
                "solver.train.kmv_field_reg>0."
            )
        z = self.pde_instance.distribution_initial.sample(1, jax.random.PRNGKey(1))[0]
        if self.cfg.pde_instance.name.startswith("Kinetic"):
            x = jnp.split(z, 2, axis=-1)[0]
        else:
            x = z
        params = net.init(jax.random.PRNGKey(11), x)
        return net, params

    def _kmv_closed_form(self) -> bool:
        """Parametric KMV with an exactly-quadratic kernel: the pairwise
        mean-field reduction collapses to per-stamp sufficient statistics
        (losses/kinetic_mckean_vlasov._quadratic_meanfield_stats) — O(n)
        instead of O(n^2), identical loss values (tested)."""
        from pde_inverse.models.parametric import QuadraticFormModel

        return (
            self.cfg.pde_instance.name == "Kinetic-McKean-Vlasov"
            and self.cfg.solver.train.kmv_closed_form
            and isinstance(getattr(self, "_model", None), QuadraticFormModel)
        )

    def gather_stream_chunk(self, stream, rngs):
        """Host-side per-chunk gather for the streaming offline loader.

        stream: {"0T": memmap [n_traj, nt, 2d], "tau_0T": memmap} left on
        host by the problem instance (pde_instance.offline_streaming);
        rngs: the chunk's per-step keys [K].  For each step, draws
        solver.train.offline_traj_batch trajectories (sorted gather — the
        memmap reads stay near-sequential) and a strided, phase-shifted
        time subsample, mirroring the in-jit offline policy's semantics at
        a bounded per-step size.  Returns numpy arrays shaped [K, ...] that
        the trainer feeds through the chunk scan as per-step batches; the
        device only ever holds one chunk of batches, so the store may
        exceed device memory."""
        import numpy as np

        tr = self.cfg.solver.train
        traj_mm = stream["0T"]
        tau_mm = stream.get("tau_0T")
        n_traj, n_time = traj_mm.shape[:2]
        d2 = traj_mm.shape[-1]
        stride_t = 5
        t_len = max(1, n_time // stride_t)
        k_traj = min(tr.offline_traj_batch, n_traj)
        if jnp.issubdtype(rngs.dtype, jax.dtypes.prng_key):
            rngs = jax.random.key_data(rngs)
        key_data = np.asarray(rngs).reshape(len(rngs), -1)

        K = len(rngs)
        z = np.empty((K, k_traj * t_len, d2), np.float32)
        taus = (
            np.empty((K, k_traj, t_len), np.float32) if tau_mm is not None else None
        )
        for i in range(K):
            gen = np.random.Generator(
                np.random.Philox(key=key_data[i].astype(np.uint64))
            )
            shift = int(gen.integers(n_time - (t_len - 1) * stride_t))
            time_idx = np.arange(t_len) * stride_t + shift
            traj_idx = np.sort(gen.permutation(n_traj)[:k_traj])
            sub = traj_mm[traj_idx][:, time_idx]  # [k, t', 2d]
            z[i] = sub.reshape(-1, d2)
            if taus is not None:
                taus[i] = tau_mm[traj_idx][:, time_idx]
        out = {"0T": z}
        if taus is not None:
            out["tau_0T_per_traj"] = taus
        return out

    def value_and_grad_fn(
        self,
        forward_fn,
        params,
        rng,
        dataset=None,
        stream_batch=None,
        boundary=None,
        step=None,
    ):
        rng_sample, rng_vg = jax.random.split(rng)
        if stream_batch is not None:
            data = {
                "initial": dataset["initial"],
                "terminal": dataset["terminal"],
                **stream_batch,
            }
            if self.mesh_spec is not None:
                from pde_inverse.parallel.mesh import shard_tree_batches

                data = shard_tree_batches(data, self.mesh_spec)
        elif boundary is not None:
            # chunk-cadence boundary refresh: reuse the chunk's boundary
            # batch, resample only the path (solver.train.boundary_per_chunk)
            data = {
                **boundary,
                **self.sample_path(rng_sample, broaden_s=self._broaden_s(step)),
            }
        else:
            data = self.sample_data(
                rng_sample, dataset=dataset, broaden_s=self._broaden_s(step)
            )
        kwargs = {}
        if self.cfg.pde_instance.name == "Kinetic-McKean-Vlasov":
            if self._kmv_closed_form():
                kwargs["closed_form_quadratic"] = True
            kwargs["element_budget"] = self.cfg.solver.train.kmv_element_budget
            if self.cfg.solver.train.kmv_field_reg > 0.0:
                lam = self.cfg.solver.train.kmv_field_reg
                decay = self.cfg.solver.train.kmv_field_reg_decay_steps
                if decay > 0 and step is not None:
                    # cosine-anneal the stabilizer strength lam -> floor
                    # over `decay` steps (traced scalar; jit-stable)
                    floor = self.cfg.solver.train.kmv_field_reg_floor
                    frac = jnp.clip(
                        jnp.asarray(step, jnp.float32) / decay, 0.0, 1.0
                    )
                    lam = floor + (lam - floor) * 0.5 * (
                        1.0 + jnp.cos(jnp.pi * frac)
                    )
                kwargs["field_reg"] = lam
                kwargs["field_reg_probes"] = (
                    self.cfg.solver.train.kmv_field_reg_probes
                )
                if self.cfg.solver.train.kmv_field_reg_fourier_only:
                    kwargs["field_reg_fourier_only"] = True
                if self.cfg.solver.train.kmv_field_reg_correction_only:
                    kwargs["field_reg_correction_only"] = True
                if self.cfg.solver.train.kmv_field_reg_probe_scale > 1.0:
                    kwargs["field_reg_probe_scale"] = (
                        self.cfg.solver.train.kmv_field_reg_probe_scale
                    )
            if (
                "closed_form_quadratic" not in kwargs
                and self.cfg.solver.train.kmv_blockwise
            ):
                from pde_inverse.losses import fourier_meanfield as fmf
                from pde_inverse.losses import pairwise_blockwise as bw

                model = getattr(self, "_model", None)
                if model is not None and (
                    bw.supports(model) or fmf.supports(model)
                ):
                    kwargs["blockwise_module"] = model
                    kwargs["blockwise_rows"] = (
                        self.cfg.solver.train.kmv_blockwise_rows
                    )
        return self._loss_module().value_and_grad_fn(
            forward_fn=forward_fn,
            params=params,
            data=data,
            rng=rng_vg,
            pde_instance=self.pde_instance,
            mesh_spec=self.mesh_spec,
            **kwargs,
        )

    def test_fn(self, forward_fn, params, rng):
        from functools import partial

        return self._loss_module().test_fn(
            forward_fn=partial(forward_fn, params),
            pde_instance=self.pde_instance,
            rng=rng,
        )

    def plot_fn(self, forward_fn, params, rng, out_path: str = "potential.png"):
        """Quiver comparison of the learned vs true gradient field on the
        leading 2-D position plane, saved to out_path.  (The reference's
        plot_fn is dead code after an early return, api.py:81-100; this one
        is live and offline.)"""
        import numpy as np

        from pde_inverse.ops import autodiff as ad

        inst = self.pde_instance
        true_fn = getattr(inst, "Phi_true_fn", None) or inst.V_true_fn
        dim = inst.dim
        extent = 4.0
        g = np.linspace(-extent, extent, 20)
        X, Y = np.meshgrid(g, g)
        pts = jnp.zeros((X.size, dim))
        pts = pts.at[:, 0].set(jnp.asarray(X.ravel()))
        if dim > 1:
            pts = pts.at[:, 1].set(jnp.asarray(Y.ravel()))

        V = lambda x: forward_fn(params, x)[0]
        learned = np.asarray(ad.batched_grad(V, pts))
        true = np.asarray(ad.batched_grad(true_fn, pts))

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        for ax, field, title in [
            (axes[0], learned, "learned gradient field"),
            (axes[1], true, "true gradient field"),
        ]:
            ax.quiver(X, Y, field[:, 0].reshape(X.shape), field[:, 1].reshape(X.shape))
            ax.set_title(title)
        import os

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out_path

    # -- data policy -----------------------------------------------------------

    def sample_data(
        self, rng, dataset=None, broaden_s=None
    ) -> Dict[str, jnp.ndarray]:
        data = self._sample_data_unsharded(rng, dataset, broaden_s=broaden_s)
        if self.mesh_spec is not None:
            from pde_inverse.parallel.mesh import shard_tree_batches

            data = shard_tree_batches(data, self.mesh_spec)
        return data

    def sample_boundary(self, rng, batch_size=None) -> Dict[str, jnp.ndarray] | None:
        """Boundary-only batch ({initial, terminal}) for the chunk-cadence
        refresh (solver.train.boundary_per_chunk) and the run-level
        reservoir (solver.train.boundary_reservoir, which passes its own
        base batch_size).  The np production step's sampling is
        boundary-dominated: the 300k terminal particles are re-simulated
        through the full SDE every step, the path batch is far smaller.  Returns None when the data policy has no online
        boundary to split (offline datasets) — the trainer falls back to
        per-step sample_data."""
        data = self._boundary_unsharded(rng, batch_size=batch_size)
        if data is not None and self.mesh_spec is not None:
            from pde_inverse.parallel.mesh import shard_tree_batches

            data = shard_tree_batches(data, self.mesh_spec)
        return data

    def sample_path(self, rng, broaden_s=None) -> Dict[str, jnp.ndarray]:
        """Path-only per-step batch, complementing sample_boundary (the
        online key layout is shared with sample_data by construction —
        both compose the same _boundary/_path helpers)."""
        data = self._path_unsharded(rng, broaden_s=broaden_s)
        if self.mesh_spec is not None:
            from pde_inverse.parallel.mesh import shard_tree_batches

            data = shard_tree_batches(data, self.mesh_spec)
        return data

    def _boundary_unsharded(self, rng, batch_size=None):
        inst = self.pde_instance
        tr = self.cfg.solver.train
        if inst.sample_mode != "online":
            return None
        rng_init, rng_term, rng_0T = jax.random.split(rng, 3)
        if inst.sample_scheme == "exact":
            # Under tail-boost (init_broaden > 1) only the 0T batch is
            # broadened+weighted; boundary expectations stay under the true
            # laws — each loss term is a separately unbiased expectation.
            return {
                "initial": inst.distribution_initial.sample(
                    batch_size or tr.batch_size_init, rng_init
                ),
                "terminal": inst.distribution_terminal.sample(
                    batch_size or tr.batch_size_terminal, rng_term
                ),
            }
        if (
            inst.sample_scheme == "SDE"
            and hasattr(inst, "sample_boundary_only")
            and hasattr(inst, "sample_path_only")
        ):
            n = batch_size or tr.batch_size_0T
            if self._tail_boost():
                return inst.sample_boundary_only_weighted(rng_0T, n)
            initial, terminal = inst.sample_boundary_only(rng_0T, n)
            return {"initial": initial, "terminal": terminal}
        return None

    def _path_unsharded(self, rng, broaden_s=None):
        inst = self.pde_instance
        tr = self.cfg.solver.train
        _, _, rng_0T = jax.random.split(rng, 3)
        if inst.sample_scheme == "exact":
            spec = (
                tr.batch_size_0T
                if tr.sample_mode == "random_time"
                else (tr.n_time_stamps, tr.sample_per_time)
            )
            taus = inst.get_time_sample_ground_truth(rng_0T, spec)
            if self._tail_boost():
                out = inst.sample_ground_truth_weighted(
                    rng_0T, spec, s=broaden_s
                )
                return {**out, "tau_0T": taus}
            return {
                "0T": inst.sample_ground_truth(rng_0T, spec),
                "tau_0T": taus,
            }
        if self._tail_boost():
            return inst.sample_path_only_weighted(rng_0T, tr.batch_size_0T)
        return {"0T": inst.sample_path_only(rng_0T, tr.batch_size_0T)}

    def _tail_boost(self) -> bool:
        """Tail-boost importance sampling is on (pde_instance.init_broaden
        > 1) and the instance implements a weighted entry point — the SDE
        family's trajectory reweighting (sample_path_only_weighted,
        KFP-GMM) or the exact-law family's per-stamp reweighting
        (sample_ground_truth_weighted, KFP-OU / KMV)."""
        if self.cfg.pde_instance.init_broaden <= 1.0:
            return False
        inst = self.pde_instance
        inst_s = inst.cfg.pde_instance.init_broaden
        if inst_s != self.cfg.pde_instance.init_broaden:
            # The weighted samplers read s from the INSTANCE's config; a
            # method built with a different cfg would silently draw
            # weights at the wrong (or unit) broadening.
            raise ValueError(
                "pde_instance.init_broaden differs between the method's "
                f"config ({self.cfg.pde_instance.init_broaden}) and the "
                f"problem instance's ({inst_s}); rebuild the instance with "
                "the same config"
            )
        if not (
            hasattr(inst, "sample_path_only_weighted")
            or hasattr(inst, "sample_ground_truth_weighted")
        ):
            raise ValueError(
                "pde_instance.init_broaden > 1 needs an instance with "
                "weighted online sampling (Kinetic-Fokker-Planck GMM, "
                "Kinetic-Fokker-Planck OU, Kinetic-McKean-Vlasov)"
            )
        return True

    def _broaden_s(self, step):
        """Annealed tail-boost dose (pde_instance.init_broaden_decay_steps
        > 0): cosine-decay the broadening factor from init_broaden to 1.0
        as a traced per-step scalar, mirroring the kmv_field_reg anneal.
        Returns None (samplers fall back to the static config dose) when
        the schedule is off, tail-boost is off, or no step is threaded
        (eager sampling outside the trainer uses the step-0 dose)."""
        decay = self.cfg.pde_instance.init_broaden_decay_steps
        if decay <= 0 or step is None or not self._tail_boost():
            return None
        inst = self.pde_instance
        if not hasattr(inst, "sample_ground_truth_weighted"):
            raise ValueError(
                "pde_instance.init_broaden_decay_steps > 0 is supported "
                "only for exact-law instances (KFP-OU / KMV grid_time); "
                "the SDE family's trajectory reweighting has no per-step "
                "dose argument"
            )
        s0 = self.cfg.pde_instance.init_broaden
        frac = jnp.clip(jnp.asarray(step, jnp.float32) / decay, 0.0, 1.0)
        return 1.0 + (s0 - 1.0) * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))

    def _sample_data_unsharded(
        self, rng, dataset=None, broaden_s=None
    ) -> Dict[str, jnp.ndarray]:
        inst = self.pde_instance
        tr = self.cfg.solver.train
        if inst.sample_mode == "online":
            # one key layout for all online sampling: the boundary/path
            # helpers below are the single source of truth, so the
            # chunk-cadence composition ({**boundary, **path}) samples the
            # exact same law as the per-step policy (bitwise — see
            # tests/test_langevin.py::test_boundary_path_split_is_bitwise).
            boundary = self._boundary_unsharded(rng)
            if boundary is not None:
                return {
                    **boundary,
                    **self._path_unsharded(rng, broaden_s=broaden_s),
                }
            if inst.sample_scheme == "SDE":
                # SDE instance without split entry points: combined call
                _, _, rng_0T = jax.random.split(rng, 3)
                initial, terminal, path = inst.sample_ground_truth(
                    rng_0T, tr.batch_size_0T
                )
                return {"initial": initial, "terminal": terminal, "0T": path}
            raise ValueError(f"unknown sample scheme {inst.sample_scheme!r}")

        if inst.sample_mode == "offline":
            # The dataset should be passed as a jit ARGUMENT by the caller:
            # closing over hundreds of MB of trajectories bakes them into
            # the compiled program as literal constants (and overflows the
            # remote-compile relay). Falling back to the instance attribute
            # is only safe for small datasets / eager use.
            dataset = dataset if dataset is not None else inst.dataset
            rng_time, rng_sample = jax.random.split(rng)
            n_traj, n_time, _ = dataset["0T"].shape

            stride_t, stride_n = 5, 5
            shift = jax.random.randint(rng_time, [], 0, stride_t)
            time_idx = jnp.arange(n_time // stride_t) * stride_t + shift

            grouped = "tau_groups" in dataset
            if grouped:
                # Grids come in G groups with trajectory j on grid j % G
                # (problems/kfp_ou.py offline layout): subsample
                # group-stratified so the KMV weight oracle evaluates the
                # spectral moments once per (group, stamp) instead of per
                # element.  Requires equal group sizes; fall back to the
                # iid subsample otherwise.
                G = dataset["tau_groups"].shape[0]
                grouped = n_traj % G == 0 and (n_traj // G) >= stride_n
            if grouped:
                reps = n_traj // G
                k = reps // stride_n
                keys = jax.random.split(rng_sample, G)
                sel = jax.vmap(
                    lambda kk: jax.random.permutation(kk, reps)[:k]
                )(keys)  # [G, k] within-group picks
                traj_idx = (G * sel + jnp.arange(G)[:, None]).reshape(-1)
            else:
                traj_idx = jax.random.permutation(rng_sample, n_traj)[
                    : n_traj // stride_n
                ]

            sub = dataset["0T"][traj_idx][:, time_idx]  # [n', t', 2d]
            data = {
                "initial": dataset["initial"],
                "terminal": dataset["terminal"],
                "0T": sub.reshape(-1, sub.shape[-1]),
            }
            if grouped:
                data["tau_0T_groups"] = dataset["tau_groups"][:, time_idx]
            elif "tau_0T" in dataset:
                data["tau_0T_per_traj"] = dataset["tau_0T"][traj_idx][:, time_idx]
            return data

        raise ValueError(f"unknown sample mode {inst.sample_mode!r}")
