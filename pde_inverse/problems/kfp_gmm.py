"""Kinetic Fokker-Planck inverse problem with a Gaussian-mixture potential.

Ground truth: underdamped Langevin dynamics in the GMM potential
U(x) = -logsumexp_k(-||x - mu_k||^2 / 2) with friction gamma = 0.5; only the
initial law is closed-form, so path data comes from the Euler-Maruyama
simulator (sample_scheme = "SDE").

The reference's *online* SDE sampling path crashes on a tuple-arity bug
(kinetic_fokker_planck_example_GMM.py:115,133 unpack a 3-tuple into 2
names); here both online and offline modes are functional and tested.

Parity: /root/reference/example_problems/kinetic_fokker_planck_example_GMM.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pde_inverse.config import Config
from pde_inverse.distributions import Gaussian
from pde_inverse.models.parametric import GMMMeansModel, recovered_gmm_means
from pde_inverse.ops.simulate import simulate
from pde_inverse.potentials import GMMPotential
from pde_inverse.problems.base import ProblemInstance


def make_configuration(dim: int, rng: jax.Array):
    gamma = 0.5
    n_gaussian = 3
    mus = jax.random.uniform(rng, (n_gaussian, dim), minval=-4.0, maxval=4.0)
    zeros = jnp.zeros((dim, dim))
    P_0 = jnp.block([[4.0 * jnp.eye(dim), zeros], [zeros, 0.1 * jnp.eye(dim)]])
    return {
        "n_Gaussian": n_gaussian,
        "gamma_friction": gamma,
        "m_0": jnp.zeros(2 * dim),
        "P_0": P_0,
        "m_x_0": jnp.zeros(dim),
        "P_x_0": 4.0 * jnp.eye(dim),
        "mus": mus,
    }


class KineticFokkerPlanckGMM(ProblemInstance):
    sample_scheme = "SDE"

    # Oversampling multiples for the online initial/terminal batches
    # (parity: …GMM.py:106-107).
    multiple_init = 30
    multiple_terminal = 30

    def __init__(self, cfg: Config, rng: jax.Array):
        super().__init__(cfg, rng)
        rng_config, rng_dataset = jax.random.split(rng)
        c = make_configuration(self.dim, rng_config)
        self.configuration = c
        self.gamma_friction = c["gamma_friction"]
        self.potential = GMMPotential.create(c["mus"], jnp.ones([]))
        self.distribution_initial = Gaussian.create(c["m_0"], c["P_0"])
        self.distribution_initial_x = Gaussian.create(c["m_x_0"], c["P_x_0"])
        self.distribution_terminal = None  # only reachable by simulation
        self.dataset = None
        self.dataset_stream = None
        broaden = cfg.pde_instance.init_broaden
        if broaden < 1.0:
            raise ValueError("pde_instance.init_broaden must be >= 1.0")
        if broaden > 1.0 and cfg.pde_instance.antithetic:
            raise ValueError(
                "pde_instance.init_broaden and pde_instance.antithetic are "
                "mutually exclusive (mirror-pair weight bookkeeping is not "
                "implemented)"
            )
        if broaden > 1.0 and self.sample_mode != "online":
            raise ValueError(
                "pde_instance.init_broaden reweights ONLINE SDE sampling; "
                "offline datasets are drawn from the true initial law"
            )
        if self.sample_mode == "offline":
            self.dataset = self._load_or_generate_dataset(rng_dataset)

    def _load_or_generate_dataset(self, rng: jax.Array) -> dict:
        """Generate the offline dataset, optionally persisting it to (and
        reloading it from) cfg.pde_instance.dataset_path.

        A path WITHOUT an .npz suffix uses the raw memmap array-store
        format (utils/data.py): generation streams fixed-shape device
        shards straight to disk and reloading maps pages on demand, so
        stores larger than host RAM never hold a full in-memory copy
        (round-1 review: np.savez/np.load decompress whole arrays into
        anonymous host memory).  An .npz path keeps the legacy behavior.
        """
        import os

        import numpy as np

        path = self.cfg.pde_instance.dataset_path
        if self.cfg.pde_instance.offline_streaming and (
            not path or path.endswith(".npz")
        ):
            raise ValueError(
                "pde_instance.offline_streaming needs a raw array-store "
                "dataset_path (directory, not .npz): streaming gathers "
                "host-side from the memmap"
            )
        if path and path.endswith(".npz"):
            if os.path.exists(path):
                with np.load(path) as z:
                    return {k: jnp.asarray(z[k]) for k in z.files}
            dataset = jax.jit(self.generate_ground_truth_dataset)(rng)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, **{k: np.asarray(v) for k, v in dataset.items()})
            return dataset
        if path:
            from pde_inverse.utils.data import load_array_store

            if not os.path.exists(os.path.join(path, "manifest.json")):
                self._generate_dataset_to_store(path, rng)
            store = load_array_store(path)
            if self.cfg.pde_instance.offline_streaming:
                # Host-streaming mode: the trajectory store stays a host
                # memmap (self.dataset_stream); only the per-step-constant
                # initial/terminal sets go to the device.  The trainer
                # gathers per-chunk trajectory batches host-side
                # (methods.gather_stream_chunk) — device memory is bounded
                # by one chunk regardless of store size.
                self.dataset_stream = {
                    k: store[k] for k in ("0T", "tau_0T") if k in store
                }
                return {
                    k: jnp.asarray(v)
                    for k, v in store.items()
                    if k not in self.dataset_stream
                }
            return {k: jnp.asarray(v) for k, v in store.items()}
        return jax.jit(self.generate_ground_truth_dataset)(rng)

    # Max elements generated per device shard when streaming to disk
    # (~256 MB of f32); shards are fixed-shape so each stage compiles once.
    _STORE_SHARD_ELEMENTS = 64_000_000

    def _generate_dataset_to_store(self, path: str, rng: jax.Array) -> str:
        """Stream the offline dataset to a raw array store in fixed-shape
        device shards: exact initial draws, simulated terminal particles,
        and simulated 0T trajectories, each written into its memmap as it
        lands.  Peak device/host memory is one shard, independent of the
        total store size."""
        import numpy as np

        from pde_inverse.utils.data import ArrayStoreWriter

        p = self.cfg.pde_instance
        d2 = 2 * self.dim
        writer = ArrayStoreWriter(path)
        rng_init, rng_term, rng_0T = jax.random.split(rng, 3)

        def shard_loop(total, per_item_elems, gen_fn, out_mm, key):
            """gen_fn(key, start, size) -> [size, ...]; fixed shard size so
            the generation program compiles once; the final shard is
            generated full-size and sliced."""
            shard = max(1, min(total, self._STORE_SHARD_ELEMENTS // per_item_elems))
            gen = jax.jit(gen_fn, static_argnums=(2,))
            for start in range(0, total, shard):
                n = min(shard, total - start)
                out = gen(jax.random.fold_in(key, start), start, shard)
                out_mm[start : start + n] = np.asarray(out[:n])
            out_mm.flush()

        init_mm = writer.create("initial", (p.sample_initial_size, d2), np.float32)
        shard_loop(
            p.sample_initial_size,
            d2,
            lambda k, s, n: self.distribution_initial.sample(n, k),
            init_mm,
            rng_init,
        )

        dt_term = p.total_evolving_time / p.n_steps_terminal

        def gen_terminal(key, start, n):
            k0, k1 = jax.random.split(key)
            z0 = self.distribution_initial.sample(n, k0)
            term, _, _ = simulate(
                k1,
                z0,
                p.n_steps_terminal,
                dt_term,
                self.potential,
                self.gamma_friction,
                return_trajectory=False,
                integrator=self.cfg.pde_instance.integrator,
            )
            return term

        term_mm = writer.create("terminal", (p.sample_terminal_size, d2), np.float32)
        shard_loop(p.sample_terminal_size, d2, gen_terminal, term_mm, rng_term)

        dt_0T = p.total_evolving_time / p.n_steps_0T

        def gen_0T(key, start, n):
            k0, k1 = jax.random.split(key)
            z0 = self.distribution_initial.sample(n, k0)
            _, traj, tau = simulate(
                k1,
                z0,
                p.n_steps_0T,
                dt_0T,
                self.potential,
                self.gamma_friction,
                integrator=self.cfg.pde_instance.integrator,
            )
            return traj, tau

        traj_mm = writer.create(
            "0T", (p.sample_0T_size, p.n_steps_0T, d2), np.float32
        )
        tau_mm = writer.create("tau_0T", (p.sample_0T_size, p.n_steps_0T), np.float32)
        shard = max(
            1,
            min(
                p.sample_0T_size,
                self._STORE_SHARD_ELEMENTS // (p.n_steps_0T * d2),
            ),
        )
        gen = jax.jit(gen_0T, static_argnums=(2,))
        for start in range(0, p.sample_0T_size, shard):
            n = min(shard, p.sample_0T_size - start)
            traj, tau = gen(jax.random.fold_in(rng_0T, start), start, shard)
            traj_mm[start : start + n] = np.asarray(traj[:n])
            tau_mm[start : start + n] = np.asarray(tau[:n])
        traj_mm.flush()
        tau_mm.flush()
        return writer.finalize()

    def V_true_fn(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.potential.value(x)

    # -- online SDE sampling ---------------------------------------------------

    def sample_ground_truth(self, rng: jax.Array, batch_size: int):
        """Returns (initial, terminal, path) samples for one step:
        * initial: multiple_init x batch_size exact draws from the t=0 law,
        * terminal: multiple_terminal x batch_size particles simulated to T,
        * path: batch_size trajectories flattened over their n_steps states.

        The key layout (one 5-way split) is shared with the path-only /
        boundary-only entry points below so the combined call stays
        bitwise-identical to the pre-cadence implementation.
        """
        rng_traj, rng_term_sim, rng_i0, rng_i1, rng_i2 = jax.random.split(rng, 5)
        sample_0T = self._sample_path(rng_traj, rng_i0, batch_size)
        sample_initial, sample_terminal = self._sample_boundary(
            rng_term_sim, rng_i1, rng_i2, batch_size
        )
        return sample_initial, sample_terminal, sample_0T

    def sample_path_only(self, rng: jax.Array, batch_size: int):
        """Path trajectories only — the cheap per-step part when the
        boundary batches are refreshed on a chunk cadence
        (solver.train.boundary_per_chunk; sampling is boundary-dominated:
        the 300k-particle terminal simulation outweighs the 10k-trajectory
        path work)."""
        rng_traj, _, rng_i0, _, _ = jax.random.split(rng, 5)
        return self._sample_path(rng_traj, rng_i0, batch_size)

    def sample_boundary_only(self, rng: jax.Array, batch_size: int):
        """(initial, terminal) boundary batches only — the expensive part
        refreshed once per chunk under solver.train.boundary_per_chunk."""
        _, rng_term_sim, _, rng_i1, rng_i2 = jax.random.split(rng, 5)
        return self._sample_boundary(rng_term_sim, rng_i1, rng_i2, batch_size)

    # -- tail-boost importance sampling (pde_instance.init_broaden) -------------

    def _broadened_initial(self) -> Gaussian:
        """Sampling law q for init_broaden=s: the position marginal's
        covariance is scaled by s^2, the velocity marginal is unchanged
        (P_0 is block-diagonal, so the density ratio p0/q0 depends on x
        only and is bounded by s^dim at the mean — bounded importance
        weights by construction)."""
        s = self.cfg.pde_instance.init_broaden
        d = self.dim
        scale = jnp.concatenate([jnp.full((d,), s), jnp.ones((d,))])
        cov_q = scale[:, None] * self.distribution_initial.cov * scale[None, :]
        return Gaussian.create(self.distribution_initial.mean, cov_q)

    def _init_log_weight(self, q: Gaussian, z0: jnp.ndarray) -> jnp.ndarray:
        return self.distribution_initial.logdensity(z0) - q.logdensity(z0)

    def sample_path_only_weighted(self, rng: jax.Array, batch_size: int):
        """Like sample_path_only, drawing initial states from the broadened
        law q and returning {"0T", "w_0T"}: each trajectory's importance
        weight w = p0(z0)/q0(z0) repeats across all path states it
        contributes, so every E_0T[...] in the weak form stays an unbiased
        estimate of the true path-law expectation (the path law of a
        trajectory is a deterministic-in-law pushforward of its initial
        state, so the t=0 density ratio is the full trajectory's
        Radon-Nikodym weight)."""
        rng_traj, _, rng_i0, _, _ = jax.random.split(rng, 5)
        q = self._broadened_initial()
        n_steps = self.cfg.pde_instance.n_steps
        dt = self.cfg.pde_instance.total_evolving_time / n_steps
        z0 = q.sample(batch_size, rng_i0)
        _, traj, _ = simulate(
            rng_traj, z0, n_steps, dt, self.potential, self.gamma_friction,
            integrator=self.cfg.pde_instance.integrator,
        )
        stride = self.cfg.solver.train.path_stride
        if stride > 1:
            traj = traj[:, ::stride]
        w = jnp.exp(self._init_log_weight(q, z0))
        return {
            "0T": traj.reshape(-1, 2 * self.dim),
            "w_0T": jnp.repeat(w, traj.shape[1]),
        }

    def sample_boundary_only_weighted(self, rng: jax.Array, batch_size: int):
        """Like sample_boundary_only under the broadened law, returning
        {"initial", "terminal", "w_initial", "w_terminal"}; the terminal
        particles inherit the weight of the initial state they were
        simulated from."""
        _, rng_term_sim, _, rng_i1, rng_i2 = jax.random.split(rng, 5)
        q = self._broadened_initial()
        n_steps = self.cfg.pde_instance.n_steps
        dt = self.cfg.pde_instance.total_evolving_time / n_steps
        sample_initial = q.sample(batch_size * self.multiple_init, rng_i1)
        z0_term = q.sample(batch_size * self.multiple_terminal, rng_i2)
        sample_terminal, _, _ = simulate(
            rng_term_sim,
            z0_term,
            n_steps,
            dt,
            self.potential,
            self.gamma_friction,
            return_trajectory=False,
            integrator=self.cfg.pde_instance.integrator,
        )
        return {
            "initial": sample_initial,
            "terminal": sample_terminal,
            "w_initial": jnp.exp(self._init_log_weight(q, sample_initial)),
            "w_terminal": jnp.exp(self._init_log_weight(q, z0_term)),
        }

    def _sample_path(self, rng_traj, rng_i0, batch_size: int):
        n_steps = self.cfg.pde_instance.n_steps
        # static python float: dt is a trace-time constant of the simulator
        dt = self.cfg.pde_instance.total_evolving_time / n_steps
        antithetic = self.cfg.pde_instance.antithetic
        if antithetic and batch_size % 2:
            raise ValueError("pde_instance.antithetic needs an even batch size")
        n_draw = batch_size // 2 if antithetic else batch_size

        m0 = self.distribution_initial.mean
        z0 = self.distribution_initial.sample(n_draw, rng_i0)
        _, traj, _ = simulate(
            rng_traj, z0, n_steps, dt, self.potential, self.gamma_friction,
            integrator=self.cfg.pde_instance.integrator,
            antithetic=antithetic,
            z0_mirror=(2.0 * m0 - z0) if antithetic else None,
        )
        stride = self.cfg.solver.train.path_stride
        if stride > 1:
            # static stride keeps shapes static; time coverage is preserved
            # because every trajectory already carries its own random phase
            # tau0 ~ U[0, dt), so strided states still visit all of (0, T]
            traj = traj[:, ::stride]
        return traj.reshape(-1, 2 * self.dim)

    def _sample_boundary(self, rng_term_sim, rng_i1, rng_i2, batch_size: int):
        n_steps = self.cfg.pde_instance.n_steps
        dt = self.cfg.pde_instance.total_evolving_time / n_steps
        antithetic = self.cfg.pde_instance.antithetic
        if antithetic and batch_size % 2:
            raise ValueError("pde_instance.antithetic needs an even batch size")
        n_draw = batch_size // 2 if antithetic else batch_size
        m0 = self.distribution_initial.mean

        if antithetic:
            # exact-Gaussian antithetic pair: z and its reflection 2m - z
            half_init = self.distribution_initial.sample(
                n_draw * self.multiple_init, rng_i1
            )
            sample_initial = jnp.concatenate(
                [half_init, 2.0 * self.distribution_initial.mean - half_init]
            )
        else:
            sample_initial = self.distribution_initial.sample(
                batch_size * self.multiple_init, rng_i1
            )

        z0_term = self.distribution_initial.sample(
            n_draw * self.multiple_terminal, rng_i2
        )
        sample_terminal, _, _ = simulate(
            rng_term_sim,
            z0_term,
            n_steps,
            dt,
            self.potential,
            self.gamma_friction,
            return_trajectory=False,
            integrator=self.cfg.pde_instance.integrator,
            antithetic=antithetic,
            z0_mirror=(2.0 * m0 - z0_term) if antithetic else None,
        )
        return sample_initial, sample_terminal

    # -- offline dataset ---------------------------------------------------------

    def generate_ground_truth_dataset(self, rng: jax.Array) -> dict:
        """{initial [Ni, 2d], terminal [Nt, 2d], 0T [n_traj, n_steps, 2d],
        tau_0T [n_traj, n_steps]} (parity: …GMM.py:158-204)."""
        p = self.cfg.pde_instance
        rng_init, rng_term0, rng_term1, rng_0T0, rng_0T1 = jax.random.split(rng, 5)

        dataset = {
            "initial": self.distribution_initial.sample(p.sample_initial_size, rng_init)
        }

        dt_term = p.total_evolving_time / p.n_steps_terminal
        z0 = self.distribution_initial.sample(p.sample_terminal_size, rng_term0)
        dataset["terminal"], _, _ = simulate(
            rng_term1,
            z0,
            p.n_steps_terminal,
            dt_term,
            self.potential,
            self.gamma_friction,
            return_trajectory=False,
            integrator=self.cfg.pde_instance.integrator,
        )

        dt_0T = p.total_evolving_time / p.n_steps_0T
        z0 = self.distribution_initial.sample(p.sample_0T_size, rng_0T0)
        _, dataset["0T"], dataset["tau_0T"] = simulate(
            rng_0T1,
            z0,
            p.n_steps_0T,
            dt_0T,
            self.potential,
            self.gamma_friction,
            integrator=self.cfg.pde_instance.integrator,
        )
        return dataset

    # -- models -------------------------------------------------------------------

    def create_parametric_model(self):
        return GMMMeansModel(dim=self.dim, n_components=self.configuration["n_Gaussian"])

    def recovered_parameter_rel_l2(self, params):
        """Rel-L2 of recovered GMM means under the best permutation match
        (component labels are exchangeable)."""
        import itertools

        try:
            est = jnp.asarray(recovered_gmm_means(params))
        except KeyError:  # non-parametric model: no physical parameter
            return None
        true = self.configuration["mus"]
        k = true.shape[0]
        perms = jnp.array(list(itertools.permutations(range(k))))
        errs = jax.vmap(lambda p: jnp.linalg.norm(est[p] - true))(perms)
        return jnp.min(errs) / jnp.linalg.norm(true)
