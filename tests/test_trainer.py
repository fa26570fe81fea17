"""Trainer tests: chunked fit, EMA switch, NaN guard, checkpointing, and a
tiny end-to-end parametric recovery (the SURVEY §7 step-3 milestone at toy
scale)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import BackendConfig, Config, apply_overrides
from pde_inverse.methods import ConsistencyBased
from pde_inverse.models.parametric import recovered_quadratic_matrix
from pde_inverse.parallel.mesh import build_mesh
from pde_inverse.problems import KineticFokkerPlanckOU
from pde_inverse.training.metrics import JsonlWriter
from pde_inverse.training.trainer import Trainer, cadence_fires


class TestCadence:
    """Periodic events must fire on absolute-step interval crossings for any
    frequency/chunk combination (round 1: the old chunk-granular modulo
    silently changed meaning when frequency < chunk or was not a multiple
    of it)."""

    @pytest.mark.parametrize("freq,chunk", [(3, 10), (10, 3), (7, 5), (100, 100), (1, 4)])
    def test_matches_per_step_reference(self, freq, chunk):
        n = 50
        fire_steps = {s for s in range(1, n + 1) if s % freq == 0}
        covered = set()
        step = 0
        while step < n:
            prev, step = step, min(step + chunk, n)
            in_chunk = fire_steps & set(range(prev + 1, step + 1))
            # fires iff the chunk contains at least one per-step fire point
            assert cadence_fires(prev, step, freq) == bool(in_chunk)
            covered |= in_chunk
        assert covered == fire_steps

    def test_no_fire_without_crossing(self):
        assert not cadence_fires(10, 12, 20)
        assert cadence_fires(19, 21, 20)
        assert cadence_fires(0, 100, 20)
        assert not cadence_fires(5, 5, 5)  # empty interval
        assert not cadence_fires(0, 5, 0)  # disabled frequency


def _cfg(n_iters=200, chunk=50, extra=()):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-Fokker-Planck",
            "pde_instance.domain_dim=2",
            "solver.train.sample_mode=grid_time",
            "solver.train.n_time_stamps=4",
            "solver.train.sample_per_time=128",
            "solver.train.batch_size_init=128",
            "solver.train.batch_size_terminal=128",
            f"train.number_of_iterations={n_iters}",
            f"train.steps_per_chunk={chunk}",
            "train.optimizer.learning_rate.initial=3e-2",
            "train.optimizer.learning_rate.scheduling=cosine",
            "train.optimizer.learning_rate.cosine_decay_steps=200",
            "train.optimizer.weight_decay=0.0",
            "test.frequency=100",
        ]
        + list(extra),
    )


def _build(cfg, rng, mesh_spec=None, writer=None):
    inst = KineticFokkerPlanckOU(cfg, rng)
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
    net, params = method.create_model_fn()
    trainer = Trainer(
        cfg=cfg,
        method=method,
        rng=jax.random.fold_in(rng, 7),
        forward_fn=net.apply,
        params=params,
        mesh_spec=mesh_spec,
        writer=writer,
    )
    return inst, trainer


class TestTrainer:
    def test_parametric_recovery_tiny(self, rng, tmp_path):
        """200 steps on a 2-D kinetic OU must already pull the drift
        estimate well below its init error (full-accuracy runs are the
        bench's job)."""
        cfg = _cfg()
        writer = JsonlWriter(str(tmp_path))
        inst, trainer = _build(cfg, rng, writer=writer)
        init_err = float(
            inst.recovered_parameter_rel_l2(jax.device_get(trainer.params))
        )
        params = trainer.fit()
        final_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        assert final_err < 0.5 * init_err, (init_err, final_err)
        # metrics written
        writer.close()
        assert os.path.getsize(writer.path) > 0

    def test_boundary_per_chunk_recovery(self, rng):
        """solver.train.boundary_per_chunk=True (one boundary batch per
        fused chunk, fresh path batch per step) must train through the
        same recovery gate as the per-step policy."""
        cfg = _cfg(extra=("solver.train.boundary_per_chunk=True",))
        inst, trainer = _build(cfg, rng)
        init_err = float(
            inst.recovered_parameter_rel_l2(jax.device_get(trainer.params))
        )
        params = trainer.fit()
        final_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        assert final_err < 0.5 * init_err, (init_err, final_err)

    @pytest.mark.parametrize("boundary_per_chunk", [False, True])
    def test_sharded_fit_runs(self, rng, boundary_per_chunk):
        """Sharded fit, with and without the chunk-cadence boundary refresh
        (the cadence's boundary batch is sampled inside the jitted chunk
        and sharded by NamedSharding constraints — must not trip the
        constant-hoisting/Manual-context trap)."""
        cfg = _cfg(
            n_iters=20,
            chunk=10,
            extra=(
                f"solver.train.boundary_per_chunk={boundary_per_chunk}",
            ),
        )
        spec = build_mesh(BackendConfig())
        inst, trainer = _build(cfg, rng, mesh_spec=spec)
        params = trainer.fit()
        assert np.isfinite(
            float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        )

    def test_sharded_fit_traces_the_chunk_once(self, rng):
        """A second chunk reuses the first chunk's program: the carry's
        step counter starts placed as the chunk returns it."""
        from jax._src import monitoring

        traces = []

        def listen(event, duration, fun_name=None, **_):
            if event == "/jax/core/compile/jaxpr_trace_duration" and fun_name == "chunk":
                traces.append(event)

        spec = build_mesh(BackendConfig())
        counts = []
        monitoring.register_event_duration_secs_listener(listen)
        try:
            for n_chunks in (1, 3):
                cfg = _cfg(n_iters=2 * n_chunks, chunk=2)
                _, trainer = _build(cfg, rng, mesh_spec=spec)
                traces.clear()
                trainer.fit()
                counts.append(len(traces))
        finally:
            monitoring.unregister_event_duration_listener(listen)
        assert counts == [1, 1], counts

    def test_ema_switch(self, rng):
        cfg = _cfg(
            n_iters=40,
            chunk=10,
            extra=[
                "train.optimizer.use_ema=True",
                "train.optimizer.ema_switch_step=20",
            ],
        )
        inst, trainer = _build(cfg, rng)
        params = trainer.fit()
        assert np.isfinite(
            float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        )

    def test_ema_track_mode(self, rng, tmp_path):
        """Decoupled Polyak averaging (ema_mode=track): the optimization
        trajectory is bitwise-identical to a no-EMA run (the average never
        feeds back into the dynamics, unlike the reference's params<-ema
        replacement, core/trainer.py:88-103), while the RETURNED params are
        the tracked average, not the live iterate."""
        base = dict(n_iters=40, chunk=10)
        ckpt = str(tmp_path / "track_ckpt")
        cfg_track = _cfg(
            **base,
            extra=[
                "train.optimizer.use_ema=True",
                "train.optimizer.ema_mode=track",
                "train.optimizer.ema_switch_step=20",
                "save_and_load.save_model=True",
                f"save_and_load.model_directory={ckpt}",
                "save_and_load.save_frequency=40",
            ],
        )
        _, trainer_track = _build(cfg_track, rng)
        avg_params = jax.device_get(trainer_track.fit())

        cfg_plain = _cfg(**base)
        _, trainer_plain = _build(cfg_plain, rng)
        raw_params = jax.device_get(trainer_plain.fit())

        # live iterates unaffected by the tracked average: the checkpointed
        # `params` of the track run equal the no-EMA run's final params
        import orbax.checkpoint as ocp

        mgr = ocp.CheckpointManager(os.path.abspath(ckpt))
        restored = mgr.restore(mgr.latest_step())
        for a, b in zip(
            jax.tree_util.tree_leaves(restored["params"]),
            jax.tree_util.tree_leaves(raw_params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # returned params are the average, distinct from the live iterate
        same = all(
            np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(
                jax.tree_util.tree_leaves(avg_params),
                jax.tree_util.tree_leaves(raw_params),
            )
        )
        assert not same
        # and they equal the checkpointed ema_state average
        for a, b in zip(
            jax.tree_util.tree_leaves(restored["ema_state"]["ema"]),
            jax.tree_util.tree_leaves(avg_params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_track_mode_mid_run_resume_is_exact(self, rng, tmp_path):
        """Wedge-recovery scenario (CLAUDE.md operational lessons): kill a
        track-mode run mid-averaging and resume from the latest checkpoint
        — the final Polyak average must be BITWISE equal to the
        uninterrupted run (same per-step key stream, full carry restored:
        params + opt_state + ema_state)."""
        import shutil

        ckpt = str(tmp_path / "wedge_ckpt")
        extra = [
            "train.optimizer.use_ema=True",
            "train.optimizer.ema_mode=track",
            "train.optimizer.ema_switch_step=10",
            "save_and_load.save_model=True",
            f"save_and_load.model_directory={ckpt}",
            "save_and_load.save_frequency=10",
        ]
        cfg = _cfg(n_iters=40, chunk=10, extra=extra)
        _, trainer_full = _build(cfg, rng)
        avg_full = jax.device_get(trainer_full.fit())

        # simulate the wedge: drop the post-30 checkpoints, resume
        for step_dir in ("40",):
            shutil.rmtree(os.path.join(ckpt, step_dir))
        cfg_resume = _cfg(
            n_iters=40, chunk=10, extra=extra + ["save_and_load.load_model=True"]
        )
        _, trainer_resumed = _build(cfg_resume, rng)
        avg_resumed = jax.device_get(trainer_resumed.fit())
        assert trainer_resumed.resumed_step == 30
        for a, b in zip(
            jax.tree_util.tree_leaves(avg_full),
            jax.tree_util.tree_leaves(avg_resumed),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_checkpoint_save_and_resume(self, rng, tmp_path):
        ckpt_dir = str(tmp_path / "ckpt")
        cfg = _cfg(
            n_iters=20,
            chunk=10,
            extra=[
                "save_and_load.save_model=True",
                f"save_and_load.model_directory={ckpt_dir}",
                "save_and_load.save_frequency=10",
            ],
        )
        inst, trainer = _build(cfg, rng)
        params = trainer.fit()
        assert os.path.isdir(ckpt_dir) and len(os.listdir(ckpt_dir)) > 0
        saved = jax.device_get(params)

        # Resume with the SAME iteration budget: the trainer must restore at
        # step 20, run zero further steps, and hand back params that are
        # bitwise-equal to the checkpoint (a restore that silently
        # reinitialized would fail this).
        cfg_same = _cfg(
            n_iters=20,
            chunk=10,
            extra=[
                "save_and_load.load_model=True",
                f"save_and_load.model_directory={ckpt_dir}",
            ],
        )
        _, trainer_same = _build(cfg_same, rng)
        params_same = jax.device_get(trainer_same.fit())
        assert trainer_same.resumed_step == 20
        for a, b in zip(
            jax.tree_util.tree_leaves(saved), jax.tree_util.tree_leaves(params_same)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # Resume with a larger budget: training continues from step 20 and
        # the params move away from the checkpoint.
        cfg2 = _cfg(
            n_iters=30,
            chunk=10,
            extra=[
                "save_and_load.load_model=True",
                "save_and_load.save_model=True",
                f"save_and_load.model_directory={ckpt_dir}",
                "save_and_load.save_frequency=10",
            ],
        )
        inst2, trainer2 = _build(cfg2, rng)
        params2 = jax.device_get(trainer2.fit())
        assert trainer2.resumed_step == 20
        k_saved = np.asarray(recovered_quadratic_matrix(saved))
        k2 = np.asarray(recovered_quadratic_matrix(params2))
        assert np.isfinite(k2).all()
        assert not np.array_equal(k_saved, k2)
        # and the continued run checkpointed step 30
        mgr_steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        assert 30 in mgr_steps


class TestBoundaryReservoir:
    """Run-level boundary reservoir (solver.train.boundary_reservoir): the
    boundary batches are drawn once (or per refresh cadence) outside the
    compiled scan and fed to every step as a jit argument — the per-step
    terminal SDE simulation (the dominant sampling cost)
    disappears from the step."""

    def test_sample_boundary_size_override(self, rng):
        cfg = _cfg()
        _, trainer = _build(cfg, rng)
        b = trainer.method.sample_boundary(rng, 64)
        assert b["initial"].shape[0] == 64
        assert b["terminal"].shape[0] == 64

    def test_sde_family_reservoir_shapes(self, rng):
        from pde_inverse.problems import KineticFokkerPlanckGMM

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.potential=GMM",
                "pde_instance.domain_dim=2",
                "pde_instance.n_steps=10",
                "solver.train.batch_size_0T=16",
            ],
        )
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        method.create_model_fn()
        b = method.sample_boundary(rng, 8)
        # the instance's init/terminal multiples apply on top of the base
        assert b["initial"].shape[0] == 8 * inst.multiple_init
        assert b["terminal"].shape[0] == 8 * inst.multiple_terminal

    def test_reservoir_recovery(self, rng):
        """Training with a refreshed reservoir must pass the same tiny
        recovery gate as the per-step boundary policy."""
        cfg = _cfg(
            extra=(
                "solver.train.boundary_reservoir=256",
                "solver.train.boundary_refresh_chunks=2",
            )
        )
        inst, trainer = _build(cfg, rng)
        init_err = float(
            inst.recovered_parameter_rel_l2(jax.device_get(trainer.params))
        )
        params = trainer.fit()
        final_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        assert final_err < 0.5 * init_err, (init_err, final_err)


    def test_reservoir_rotation_recovery(self, rng):
        """Streaming rotation (solver.train.boundary_rotate) must pass the
        same tiny recovery gate — each slice is an iid draw of the same
        boundary law, so only the noise correlation structure changes."""
        cfg = _cfg(
            extra=(
                "solver.train.boundary_reservoir=256",
                "solver.train.boundary_refresh_chunks=2",
                "solver.train.boundary_rotate=True",
            )
        )
        inst, trainer = _build(cfg, rng)
        init_err = float(
            inst.recovered_parameter_rel_l2(jax.device_get(trainer.params))
        )
        params = trainer.fit()
        final_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        assert final_err < 0.5 * init_err, (init_err, final_err)

    def test_reservoir_rotation_rejects_ragged_slices(self, rng):
        cfg = _cfg(
            extra=(
                "solver.train.boundary_reservoir=255",
                "solver.train.boundary_refresh_chunks=2",
                "solver.train.boundary_rotate=True",
            )
        )
        _, trainer = _build(cfg, rng)
        with pytest.raises(ValueError, match="divisible"):
            trainer.fit()

    def test_reservoir_rotation_resume_is_exact(self, rng, tmp_path):
        """Rotation slice keys derive from the ABSOLUTE chunk index, so a
        resumed run reconstructs the identical slot contents (slices drawn
        at chunks [c-N+1, c]) and stays bitwise-equal to the full run."""
        ckpt = str(tmp_path / "ck")
        extra = (
            "solver.train.boundary_reservoir=256",
            "solver.train.boundary_refresh_chunks=2",
            "solver.train.boundary_rotate=True",
            "save_and_load.save_model=True",
            "save_and_load.save_frequency=10",
            f"save_and_load.model_directory={ckpt}",
        )
        cfg_full = _cfg(n_iters=20, chunk=5, extra=extra)
        _, tr_full = _build(cfg_full, rng)
        p_full = jax.device_get(tr_full.fit())

        ckpt2 = str(tmp_path / "ck2")
        extra2 = tuple(
            o.replace(ckpt, ckpt2) for o in extra
        ) + ("save_and_load.load_model=True",)
        cfg_a = _cfg(n_iters=10, chunk=5, extra=extra2)
        _, tr_a = _build(cfg_a, rng)
        tr_a.fit()
        cfg_b = _cfg(n_iters=20, chunk=5, extra=extra2)
        _, tr_b = _build(cfg_b, rng)
        p_resumed = jax.device_get(tr_b.fit())
        assert tr_b.resumed_step == 10
        for a, b in zip(
            jax.tree_util.tree_leaves(p_full),
            jax.tree_util.tree_leaves(p_resumed),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_reservoir_resume_is_exact(self, rng, tmp_path):
        """A run interrupted at a chunk boundary and resumed must re-draw
        the SAME reservoir sequence (epoch-keyed fold_in) and produce
        bitwise-identical params to the uninterrupted run."""
        ckpt = str(tmp_path / "ck")
        extra = (
            "solver.train.boundary_reservoir=256",
            "solver.train.boundary_refresh_chunks=2",
            "save_and_load.save_model=True",
            "save_and_load.save_frequency=10",
            f"save_and_load.model_directory={ckpt}",
        )
        cfg_full = _cfg(n_iters=20, chunk=5, extra=extra)
        _, tr_full = _build(cfg_full, rng)
        p_full = jax.device_get(tr_full.fit())

        # fresh run to step 10 only, then resume to 20
        ckpt2 = str(tmp_path / "ck2")
        extra2 = tuple(
            o.replace(ckpt, ckpt2) for o in extra
        ) + ("save_and_load.load_model=True",)
        cfg_a = _cfg(n_iters=10, chunk=5, extra=extra2)
        _, tr_a = _build(cfg_a, rng)
        tr_a.fit()
        cfg_b = _cfg(n_iters=20, chunk=5, extra=extra2)
        _, tr_b = _build(cfg_b, rng)
        p_resumed = jax.device_get(tr_b.fit())
        assert tr_b.resumed_step == 10
        for a, b in zip(
            jax.tree_util.tree_leaves(p_full),
            jax.tree_util.tree_leaves(p_resumed),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

class TestPlotMedia:
    def test_plot_fires_and_logs_media(self, rng, tmp_path):
        """plot.enable routes the rendered file to writer.log_media
        (wandb media parity, reference utils/plot_utils.py:46,77 —
        file writers no-op, WandbWriter uploads)."""
        media = []

        class SpyWriter(JsonlWriter):
            def log_media(self, path, step):
                media.append((path, step))

        cfg = _cfg(
            n_iters=20,
            chunk=10,
            extra=("plot.enable=True", "plot.frequency=10"),
        )
        writer = SpyWriter(str(tmp_path))
        inst, trainer = _build(cfg, rng, writer=writer)
        trainer.plot_dir = str(tmp_path / "plots")
        trainer.fit()
        writer.close()
        assert media, "plot cadence never logged media"
        for path, step in media:
            assert os.path.exists(path), path
