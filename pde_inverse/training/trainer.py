"""Scan-chunked, mesh-sharded training loop.

The reference trainer (core/trainer.py:31-132) dispatches one jitted grad
step per Python-loop iteration with two host syncs per step (a NaN assert
and a wandb log).  Here K optimizer steps are fused into ONE jitted
``lax.scan`` chunk with donated carry:

* data sampling, loss/grad, optimizer update, EMA — all inside the scan;
* per-step scalar metrics are stacked and returned once per chunk (one host
  sync per K steps; NaN checking happens on the stacked array);
* per-step batches are sharded over the mesh's data axis; gradients reduce
  across shards via GSPMD-inserted collectives — replacing the
  reference's pmap + host tree-mean (core/trainer.py:44-53);
* EMA engages at a configurable step with a state reset, matching the
  reference's hardcoded epoch-40000 switch (core/trainer.py:88-103), but
  implemented with ``lax.cond`` inside the compiled step;
* Orbax checkpointing honors the reference's dormant ``save_and_load``
  config block (configurations/config.yaml:9-14).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pde_inverse.config import Config
from pde_inverse.ops.autodiff import pytree_l2_norm
from pde_inverse.parallel.mesh import MeshSpec, replicate
from pde_inverse.training.metrics import MetricWriter, NullWriter
from pde_inverse.training.optimizers import get_optimizer


def cadence_fires(prev_step: int, step: int, frequency: int) -> bool:
    """True iff any absolute step s in (prev_step, step] is a multiple of
    ``frequency``.

    Chunked training advances ``steps_per_chunk`` optimizer steps per host
    iteration, so periodic events (test / plot / checkpoint) fire when the
    chunk *crosses* a multiple of the frequency — correct for any
    frequency/chunk combination, including frequency < chunk and frequencies
    that are not multiples of the chunk (the reference fires per-epoch,
    core/trainer.py:114-130, which chunking must reproduce without drift).
    """
    if frequency <= 0:
        return False
    return step // frequency > prev_step // frequency


class Trainer:
    def __init__(
        self,
        cfg: Config,
        method,
        rng: jax.Array,
        forward_fn: Callable,
        params,
        optimizer: Optional[optax.GradientTransformation] = None,
        mesh_spec: Optional[MeshSpec] = None,
        writer: Optional[MetricWriter] = None,
        plot_dir: Optional[str] = None,
    ):
        self.cfg = cfg
        self.method = method
        self.rng = rng
        self.forward_fn = forward_fn
        self.params = params
        self.optimizer = optimizer or get_optimizer(cfg.train.optimizer)
        self.mesh_spec = mesh_spec
        self.writer = writer or NullWriter()
        self.plot_dir = plot_dir
        if mesh_spec is not None and hasattr(method, "mesh_spec"):
            method.mesh_spec = mesh_spec

    # -- compiled chunk --------------------------------------------------------

    def _build_chunk_fn(self):
        opt = self.optimizer
        ocfg = self.cfg.train.optimizer
        use_ema = ocfg.use_ema
        ema = optax.ema(ocfg.ema_decay)
        switch = ocfg.ema_switch_step
        if ocfg.ema_mode not in ("switch", "track"):
            raise ValueError(
                f"train.optimizer.ema_mode must be 'switch' or 'track', "
                f"got {ocfg.ema_mode!r}"
            )
        track = ocfg.ema_mode == "track"

        def one_step_with_dataset(
            carry, rng, dataset, stream_batch=None, boundary=None
        ):
            params, opt_state, ema_state, step_idx = carry
            kwargs = {} if stream_batch is None else {"stream_batch": stream_batch}
            if boundary is not None:
                kwargs["boundary"] = boundary
            out = self.method.value_and_grad_fn(
                self.forward_fn,
                params,
                rng,
                dataset=dataset,
                step=step_idx,
                **kwargs,
            )
            grad = out.pop("grad")
            updates, opt_state = opt.update(grad, opt_state, params)
            params = optax.apply_updates(params, updates)

            if use_ema:
                # Reset the EMA state to the current params at the switch
                # step, then either replace the live params by their EMA
                # each step (reference semantics, core/trainer.py:88-103 --
                # NOTE this multiplies the post-switch effective lr by
                # (1 - decay), near-freezing training) or, in "track" mode,
                # keep full optimizer dynamics and maintain the EMA as a
                # decoupled Polyak average of the iterates.
                def engage(args):
                    p, es = args
                    es = jax.lax.cond(
                        step_idx == switch,
                        lambda s: optax.EmaState(
                            count=jnp.zeros([], jnp.int32), ema=p
                        ),
                        lambda s: s,
                        es,
                    )
                    _, es = ema.update(p, es)
                    return (p if track else es.ema), es

                def passthrough(args):
                    return args

                params, ema_state = jax.lax.cond(
                    step_idx >= switch, engage, passthrough, (params, ema_state)
                )

            metrics = {k: v for k, v in out.items()}
            metrics["params_norm"] = pytree_l2_norm(params)
            return (params, opt_state, ema_state, step_idx + 1), metrics

        def chunk(carry, rngs, dataset, stream=None, boundary_res=None):
            """stream: None (in-jit data policy) or a pytree of [K, ...]
            host-gathered per-step batches (streaming offline loader) fed
            through the scan as xs — the device holds one chunk of batches,
            never the trajectory store.  boundary_res: a pre-sampled
            device-resident boundary batch (solver.train.boundary_reservoir)
            reused by every step of the chunk — passed as a jit ARGUMENT so
            it is never baked into the program as a constant."""
            boundary = boundary_res
            if (
                boundary is None
                and stream is None
                and self.cfg.solver.train.boundary_per_chunk
            ):
                # One boundary batch per fused chunk (the scan below reuses
                # it every step; the per-step path batch stays fresh).  The
                # boundary key derives from the chunk's rng INPUT, not a
                # synthesized constant — constants created here would be
                # hoisted out of the scan and re-enter any shard_map body
                # with an Auto sharding (the documented trap).
                sample_boundary = getattr(self.method, "sample_boundary", None)
                if sample_boundary is not None:
                    boundary = sample_boundary(jax.random.fold_in(rngs[0], 977))
            if stream is None:
                one_step = lambda c, r: one_step_with_dataset(
                    c, r, dataset, boundary=boundary
                )
                return jax.lax.scan(one_step, carry, rngs)
            one_step = lambda c, xs: one_step_with_dataset(
                c, xs[0], dataset, stream_batch=xs[1]
            )
            return jax.lax.scan(one_step, carry, (rngs, stream))

        return jax.jit(chunk, donate_argnums=(0,))

    # -- checkpointing -----------------------------------------------------------

    def _checkpoint_manager(self):
        sl = self.cfg.save_and_load
        if not (sl.save_model or sl.load_model):
            return None
        import orbax.checkpoint as ocp

        path = os.path.abspath(sl.model_directory)
        os.makedirs(path, exist_ok=True)
        return ocp.CheckpointManager(path)

    # -- fit -------------------------------------------------------------------------

    def fit(self) -> Any:
        cfg = self.cfg
        n_iters = cfg.train.number_of_iterations
        k = min(cfg.train.steps_per_chunk, n_iters)
        chunk_fn = self._build_chunk_fn()

        params = self.params
        opt_state = self.optimizer.init(params)
        ema_state = optax.ema(cfg.train.optimizer.ema_decay).init(params)
        if self.mesh_spec is not None:
            params = replicate(params, self.mesh_spec)
            opt_state = replicate(opt_state, self.mesh_spec)
            ema_state = replicate(ema_state, self.mesh_spec)

        test_jit = jax.jit(
            lambda p, r: self.method.test_fn(self.forward_fn, p, r)
        )
        ocfg = cfg.train.optimizer

        def eval_params(carry, at_step):
            """Params to test / plot / return: the tracked Polyak average
            once engaged (ema_mode=track), the live params otherwise (in
            "switch" mode the live params ARE the EMA past the switch)."""
            if ocfg.use_ema and ocfg.ema_mode == "track" and at_step > ocfg.ema_switch_step:
                return carry[2].ema
            return carry[0]

        mgr = self._checkpoint_manager()
        start_step = 0
        if mgr is not None and cfg.save_and_load.load_model:
            latest = mgr.latest_step()
            if latest is not None:
                import orbax.checkpoint as ocp

                restored = mgr.restore(
                    latest,
                    args=ocp.args.StandardRestore(
                        {
                            "params": params,
                            "opt_state": opt_state,
                            "ema_state": ema_state,
                        }
                    ),
                )
                params = restored["params"]
                opt_state = restored["opt_state"]
                ema_state = restored["ema_state"]
                start_step = latest
                print(f"[trainer] resumed from checkpoint step {latest}")
        # Exposed for tests/inspection: the step training (re)started from.
        self.resumed_step = start_step

        step0 = jnp.asarray(start_step, jnp.int32)
        if self.mesh_spec is not None:
            # placed like the chunk's output step, so the second chunk
            # hits the first chunk's compiled program
            step0 = replicate(step0, self.mesh_spec)
        carry = (params, opt_state, ema_state, step0)
        rngs = jax.random.split(self.rng, n_iters)

        # Run-level boundary reservoir (solver.train.boundary_reservoir):
        # one jitted draw before the loop (the terminal SDE simulation runs
        # ONCE, not per step), optionally re-drawn every
        # boundary_refresh_chunks chunks to bound the frozen-MC-noise
        # window.  Resume-safe: the chunk counter derives from the ABSOLUTE
        # step, so a run resumed at a chunk boundary re-draws the same
        # reservoir sequence (same fold_in keys) as the uninterrupted run.
        res_size = cfg.solver.train.boundary_reservoir
        refresh_chunks = cfg.solver.train.boundary_refresh_chunks
        rotate = cfg.solver.train.boundary_rotate and refresh_chunks > 0
        boundary_res, draw_res = None, None
        rot_slices, draw_slice, concat_slices = None, None, None
        chunk_counter = start_step // max(k, 1)
        start_chunk = chunk_counter
        if (
            res_size > 0
            and getattr(self.method, "sample_boundary", None) is not None
            and getattr(self.method.pde_instance, "sample_mode", "") == "online"
        ):
            if rotate:
                # Streaming rotation (solver.train.boundary_rotate): the
                # reservoir is refresh_chunks slot-ordered slices; slice
                # drawn at absolute chunk d lives in slot d % N with key
                # fold_in(rng, 50321 + d).  At chunk c the reservoir holds
                # the slices of d in [c-N+1, c] — reconstructable from c
                # alone, so resume at any chunk boundary is bitwise-exact.
                if res_size % refresh_chunks:
                    raise ValueError(
                        "solver.train.boundary_rotate needs boundary_reservoir"
                        f" ({res_size}) divisible by boundary_refresh_chunks"
                        f" ({refresh_chunks})"
                    )
                slice_size = res_size // refresh_chunks
                draw_slice = jax.jit(
                    lambda key: self.method.sample_boundary(key, slice_size)
                )
                concat_slices = jax.jit(
                    lambda parts: jax.tree_util.tree_map(
                        lambda *xs: jnp.concatenate(xs, axis=0), *parts
                    )
                )
                rot_slices = [None] * refresh_chunks
                for d in range(
                    chunk_counter - refresh_chunks + 1, chunk_counter + 1
                ):
                    rot_slices[d % refresh_chunks] = draw_slice(
                        jax.random.fold_in(self.rng, 50321 + d)
                    )
                boundary_res = concat_slices(rot_slices)
            else:
                draw_res = jax.jit(
                    lambda key: self.method.sample_boundary(key, res_size)
                )
                epoch = (
                    (chunk_counter // refresh_chunks) * refresh_chunks
                    if refresh_chunks > 0
                    else 0
                )
                boundary_res = draw_res(
                    jax.random.fold_in(self.rng, 40321 + epoch)
                )

        step = start_step
        # steps/s counts the time of training chunks only (host gather,
        # dispatch, device, metric fetch), from the second chunk on: the
        # first chunk's compile, and the tests, plots and checkpoints
        # between chunks, never enter it.  Until a second chunk has run it
        # falls back to the first chunk's rate, compile included.
        first_rate, warm_steps, warm_secs = None, 0, 0.0
        while step < n_iters:
            t_chunk = time.perf_counter()
            this_k = min(k, n_iters - step)
            # A ragged final chunk just triggers one extra jit specialization.
            chunk_rngs = rngs[step : step + this_k]
            dataset = getattr(self.method.pde_instance, "dataset", None)
            stream = getattr(self.method.pde_instance, "dataset_stream", None)
            stream_batches = (
                self.method.gather_stream_chunk(stream, chunk_rngs)
                if stream is not None
                else None
            )
            profile_now = (
                cfg.backend.profile_dir and step == start_step + k
            )  # second chunk: compiled, steady-state
            if profile_now:
                jax.profiler.start_trace(cfg.backend.profile_dir)
            if (
                boundary_res is not None
                and refresh_chunks > 0
                and chunk_counter > start_chunk
            ):
                if rotate:
                    slot = chunk_counter % refresh_chunks
                    rot_slices[slot] = draw_slice(
                        jax.random.fold_in(self.rng, 50321 + chunk_counter)
                    )
                    boundary_res = concat_slices(rot_slices)
                elif chunk_counter % refresh_chunks == 0:
                    boundary_res = draw_res(
                        jax.random.fold_in(self.rng, 40321 + chunk_counter)
                    )
            chunk_counter += 1
            carry, metrics = chunk_fn(
                carry, chunk_rngs, dataset, stream_batches, boundary_res
            )
            if profile_now:
                jax.block_until_ready(metrics)
                jax.profiler.stop_trace()
                print(f"[trainer] profile trace -> {cfg.backend.profile_dir}")
            step += this_k

            host_metrics = jax.tree_util.tree_map(np.asarray, metrics)
            chunk_secs = time.perf_counter() - t_chunk
            if first_rate is None:
                first_rate = this_k / max(chunk_secs, 1e-9)
            else:
                warm_steps += this_k
                warm_secs += chunk_secs
            loss = host_metrics["loss"]
            if not np.isfinite(loss).all():
                bad = int(np.argmax(~np.isfinite(loss)))
                raise FloatingPointError(
                    f"non-finite loss at step {step - this_k + bad}"
                )
            self.writer.log_chunk(host_metrics, first_step=step - this_k)

            # test / plot / checkpoint cadences fire on absolute-step
            # interval crossings; the final chunk always tests/saves
            # (preserving the reference's end-of-run test guarantee,
            # core/trainer.py:114-116).
            prev_step = step - this_k
            if cadence_fires(prev_step, step, cfg.test.frequency) or step >= n_iters:
                test_metrics = test_jit(
                    eval_params(carry, step), jax.random.fold_in(self.rng, step)
                )
                test_metrics = {
                    key: float(v) for key, v in jax.tree_util.tree_map(
                        np.asarray, test_metrics
                    ).items()
                }
                test_metrics["steps_per_sec"] = (
                    warm_steps / warm_secs if warm_steps else first_rate
                )
                if test_metrics:
                    self.writer.log(test_metrics, step=step)
                if cfg.test.verbose:
                    rate = test_metrics["steps_per_sec"]
                    msg = f"[step {step:6d} | {rate:8.1f} steps/s] "
                    msg += f"loss {loss[-1]:.3e} "
                    msg += " ".join(f"{key}={v:.3e}" for key, v in test_metrics.items())
                    print(msg)

            if (
                cfg.plot.enable
                and self.plot_dir is not None
                and cadence_fires(prev_step, step, cfg.plot.frequency)
            ):
                try:
                    out = self.method.plot_fn(
                        self.forward_fn,
                        jax.device_get(eval_params(carry, step)),
                        jax.random.fold_in(self.rng, step + 1),
                        out_path=os.path.join(self.plot_dir, f"field_{step:06d}.png"),
                    )
                    if out:
                        self.writer.log_media(out, step)
                except Exception as e:  # plotting must never kill training
                    print(f"[trainer] plot at step {step} failed: {e}")

            if (
                mgr is not None
                and cfg.save_and_load.save_model
                and (
                    cadence_fires(prev_step, step, cfg.save_and_load.save_frequency)
                    or step >= n_iters
                )
            ):
                import orbax.checkpoint as ocp

                mgr.save(
                    step,
                    args=ocp.args.StandardSave(
                        {
                            "params": carry[0],
                            "opt_state": carry[1],
                            "ema_state": carry[2],
                        }
                    ),
                )

        if mgr is not None:
            mgr.wait_until_finished()
        self.params = eval_params(carry, step)
        return self.params
