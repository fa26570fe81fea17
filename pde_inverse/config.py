"""Typed configuration system.

Replaces the reference's untyped Hydra ``DictConfig`` threading
(``/root/reference/configurations/config.yaml:1-40``, ``api.py:27``) with
frozen dataclasses.  Configs compose the same four groups the reference uses
(pde_instance / solver / neural_network / log_density) plus train / test /
backend / checkpoint blocks, are YAML-loadable, and accept dotted-path CLI
overrides (``train.optimizer.learning_rate=1e-2``) like Hydra's CLI.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Config groups
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PDEInstanceConfig:
    """Which PDE and its physical setup.

    Mirrors the reference's ``configurations/pde_instance/*.yaml``.
    """

    name: str = "Fokker-Planck"  # Fokker-Planck | Kinetic-Fokker-Planck | Kinetic-McKean-Vlasov
    potential: str = "Quadratic"  # Quadratic | GMM
    domain_dim: int = 4
    domain_min: float = -10.0
    domain_max: float = 10.0
    diffusion_coefficient: float = 2.0
    total_evolving_time: float = 2.0
    # online | offline  (offline pre-generates a fixed dataset)
    sample_mode: str = "online"
    # Optional path for the offline dataset (the reference regenerates the
    # full 500k/200k/20k x 400 dataset every run).  A directory path uses
    # the raw memmap array-store format: generated in device shards
    # streamed to disk on first use, memory-mapped on reload (bounded host
    # RSS for >RAM stores).  A legacy .npz path loads whole arrays into
    # host memory.
    dataset_path: str = ""
    # Host-streaming offline mode (array-store paths only): the 0T
    # trajectory store stays a host memmap; each training chunk gathers its
    # per-step trajectory subsamples host-side and uploads them as a jit
    # argument — device memory is bounded by one chunk of batches, so
    # stores larger than HBM can be *trained on*, not just generated
    # Requires sample_mode=offline and a
    # non-.npz dataset_path.
    offline_streaming: bool = False
    # --- SDE (Langevin) sampling parameters (GMM instances) ---
    # "euler" (reference parity, O(dt) weak error) | "baoab"
    # (Leimkuhler-Matthews splitting, O(dt^2) weak error, same cost —
    # lowers the discretization-bias floor of SDE-sampled instances)
    integrator: str = "euler"
    # Antithetic Brownian pairing for the ONLINE SDE batches: each drawn
    # initial state is simulated twice with mirrored noise increments
    # (ops/simulate.py), halving the number of independent draws per batch
    # while anticorrelating the pair — a variance-reduction lever for the
    # weak-form estimator at unchanged batch size and simulation cost.
    antithetic: bool = False
    # Tail-boost importance sampling for the ONLINE SDE batches: draw the
    # initial POSITION marginal from the s-broadened law N(m, s^2 P_x0)
    # and attach exact per-trajectory importance weights w = p0/q0 (x-part
    # only; bounded by s^dim at the mean) to every state the trajectory
    # contributes — all weak-form expectations stay unbiased for the true
    # path law while the sampler visits the initial-law tail ~s^2 x more
    # often.  1.0 = off (the unweighted code path, bitwise).  Motivated by
    # the round-3 error profile: the np-KGMM ensemble residual is 4.9e-3
    # near-support vs 5.1e-2 on the farthest 1% of the initial law.
    # Exact-law instances (KFP-OU / KMV, grid_time sampling) broaden the
    # WHOLE per-stamp Gaussian law N(m_t, s^2 P_t) instead, with exact
    # per-(sample, stamp) weights w = p_t/q_t <= s^(2 dim); the KMV loss
    # threads the weights through both expectation layers of its
    # collapse paths (quadratic closed-form and fourier-kernel).
    init_broaden: float = 1.0
    # Anneal the tail-boost dose: cosine-decay the broadening factor from
    # init_broaden at step 0 to exactly 1.0 (unweighted sampling) at this
    # many steps, as a traced per-step scalar (jit-stable, like
    # kmv_field_reg_decay_steps).  The importance weights are exact at
    # every s, so the estimator stays unbiased at every step — the
    # schedule buys the measured early-phase tail-coverage gain of a high
    # dose without its late-phase weight-variance cost (the 7x2000/15k
    # dose inversion, README "tail-boost dose-response").  0 = constant
    # dose.  Exact-law instances (KFP-OU / KMV grid_time) only.
    init_broaden_decay_steps: int = 0
    n_steps: int = 100
    sample_initial_size: int = 500_000
    sample_terminal_size: int = 200_000
    sample_0T_size: int = 20_000
    n_steps_terminal: int = 400
    n_steps_0T: int = 400


@dataclass(frozen=True)
class SolverTrainConfig:
    """Per-step data-sampling sizes (reference ``solver/ConsistencyBased.yaml``)."""

    batch_size_init: int = 50_000
    batch_size_terminal: int = 50_000
    batch_size_0T: int = 50_000
    n_time_stamps: int = 200
    sample_per_time: int = 250
    # random_time | grid_time
    sample_mode: str = "random_time"
    # Time-stride over simulated online-SDE trajectories before they enter
    # the loss (1 = use every state).  Adjacent-time states of one
    # trajectory are highly correlated, so striding cuts the dominant
    # loss-evaluation cost ~stride-fold at minimal estimator-variance cost
    # (the offline policy already strides by 5, consistency.py:96-118).
    path_stride: int = 1
    # Parametric KMV fast path: when the hypothesis is the exactly-
    # quadratic QuadraticFormModel, compute the mean-field expectations
    # from per-stamp sufficient statistics (O(n), exact) instead of the
    # O(n^2) pairwise grid.  Identical loss values (tested); disable to
    # force the generic pairwise reduction.
    kmv_closed_form: bool = True
    # Element budget for one flattened [chunk * n * nt, d] pass of the
    # generic pairwise KMV reduction: bounds peak live memory through the
    # autodiff tape regardless of batch geometry.
    kmv_element_budget: int = 4_000_000
    # Non-parametric KMV fast path: when the hypothesis is a PotentialMLP,
    # run the pairwise mean-field reduction through the matmul-shaped
    # blockwise formulation (losses/pairwise_blockwise.py: first-layer decomposition,
    # fused 2nd-order forward propagation) instead of generic per-pair
    # autodiff.  Identical stats (tested); disable to force the generic
    # path.
    kmv_blockwise: bool = True
    # Pair rows (ref_chunk * n * nt) of width-`hidden` work per scan step of
    # the blockwise reduction; 0 = module default (1<<20).
    kmv_blockwise_rows: int = 0
    # Field-space Tikhonov stabilizer for non-parametric KMV: adds
    # lambda * mean ||grad Phi(y)||^2 over a fixed strided probe set of
    # pairwise sample differences y = x_i - x_j to the weak-form loss.
    # The loss's value/Hessian terms are LINEAR in Phi; their
    # finite-sample cancellation failure leaves unbounded descent
    # directions (observed: field norm explodes ~500x under wd<=1e-3).
    # This penalizes the exploding quantity itself — the gradient FIELD
    # on the data support — instead of all weights (weight decay needs
    # wd=1e-1 to stabilize, a far cruder bias). 0 disables.
    kmv_field_reg: float = 0.0
    # Probe pairs for the field regularizer (O(probes) extra evals/step).
    kmv_field_reg_probes: int = 4096
    # Cosine-anneal the field regularizer strength from kmv_field_reg down
    # to kmv_field_reg_floor over this many steps (then hold the floor).
    # Rationale: the stabilizer is needed early, while the weak form's
    # finite-sample descent directions dominate, but it Tikhonov-biases
    # the recovered field late (fourier-kernel CPU probes plateau at
    # rel 0.35-0.42 under constant lambda=1e-2 regardless of lr decay).
    # 0 keeps lambda constant.
    kmv_field_reg_decay_steps: int = 0
    kmv_field_reg_floor: float = 0.0
    # Semiparametric variant (fourier-kernel hypothesis only): apply the
    # field regularizer to the bounded Fourier correction's gradient
    # alone, leaving the quadratic head's parametric gradient A^T A y + c
    # unpenalized — the penalty exists to pin the Fourier features'
    # finite-sample noise-riding mode, and applied to the full field it
    # Tikhonov-shrinks the head toward zero on the probe cloud
    # (losses/fourier_meanfield.py::fourier_grad).
    kmv_field_reg_fourier_only: bool = False
    # Class-generic analogue of fourier_only: penalize only the
    # NON-PARAMETRIC correction's gradient, grad Phi - (A^T A y + b),
    # for ANY quadratic-head hypothesis (MLP stacks included — autodiff
    # minus the head's closed form, losses/kinetic_mckean_vlasov.py).
    # This is the principled stabilizer for the unbounded-MLP KMV cell,
    # where the full-field penalty diverged (round 3) and weight decay
    # is a crude crutch.
    kmv_field_reg_correction_only: bool = False
    # Tail-coverage lever: spread the probe radii log-uniformly from 1x up
    # to this factor times the data cloud (probe i scaled by
    # scale**(i/(P-1))).  The FK residual concentrates in the farthest-1%
    # of pairwise-difference radii (analyze_kmv tail bin 0.29 even with
    # the quadratic head) because nothing constrains the bounded Fourier
    # correction beyond the data support; widened probes pin its gradient
    # to zero out there, so extrapolation falls to the quadratic head —
    # which carries the truth's exact leading behavior.  Meant to be
    # combined with kmv_field_reg_fourier_only (scaling the FULL field's
    # penalty would Tikhonov-shrink the head exactly where it must act).
    # 1.0 = probes stay on the data cloud (previous behavior).
    kmv_field_reg_probe_scale: float = 1.0
    # Estimator lever: refresh the boundary batches (initial draws +
    # terminal SDE simulation — the dominant sampling cost at the np
    # production geometry) once per fused scan chunk
    # instead of every step.  The path batch stays fresh per step.  Trades
    # within-chunk correlation of the boundary MC terms for step time;
    # online data policies only (offline loaders ignore it).
    boundary_per_chunk: bool = False
    # Run-level boundary reservoir: draw
    # the boundary batches ONCE before the training loop with this base
    # batch size (the instance's init/terminal multiples apply on top;
    # 0 = off), keep them device-resident, and feed them to every step as
    # a jit argument — the per-step boundary sampling (including the
    # terminal SDE simulation) disappears from the step entirely.  The
    # boundary loss terms are still unbiased means; their MC noise is
    # frozen at O(1/sqrt(reservoir)) for the refresh interval, so size
    # the reservoir >= the per-step boundary batch it replaces.  Online
    # data policies only.
    boundary_reservoir: int = 0
    # Re-draw the reservoir every this many fused chunks (host-level,
    # outside the compiled scan; 0 = never).  Bounds how long the frozen
    # boundary-noise direction persists.
    boundary_refresh_chunks: int = 0
    # Streaming rotation (round-4 follow-up to the npE36k full-horizon
    # regression): instead of re-drawing the
    # WHOLE reservoir every boundary_refresh_chunks chunks, replace
    # 1/boundary_refresh_chunks of it EVERY chunk (requires
    # boundary_reservoir % boundary_refresh_chunks == 0).  Amortized
    # host sim cost is identical, but the frozen-MC-noise decorrelation
    # time drops by the same factor — the frozen perturbation SGD
    # integrates into null-space drift becomes chunk-local.  Slice keys
    # derive from the absolute chunk index, so resume is bitwise-exact.
    boundary_rotate: bool = False
    # Trajectories per step for the host-streaming offline loader
    # (pde_instance.offline_streaming=True).  The in-jit offline policy
    # takes a fixed 1/5 of ALL trajectories per step (reference parity,
    # consistency.py:96-118) — far too large to upload per step for >HBM
    # stores; the streaming loader draws this many instead.
    offline_traj_batch: int = 4096


@dataclass(frozen=True)
class SolverConfig:
    name: str = "ConsistencyBased"
    train: SolverTrainConfig = field(default_factory=SolverTrainConfig)


@dataclass(frozen=True)
class NetworkConfig:
    """Hypothesis-network hyperparameters (reference ``neural_network/MLP.yaml``)."""

    # Non-parametric hypothesis family: "mlp" (PotentialMLP, reference
    # parity), "fourier-kernel" (random-Fourier-feature kernel whose KMV
    # mean-field expectations collapse to O((n+m)K) sufficient statistics
    # — no pairwise grid; models/fourier_kernel.py), or "bilinear-debug"
    # (x.(Wx+c) sanity-check hypothesis, reference core/model.py:63-96).
    model: str = "mlp"
    hidden_dim: int = 20
    layers: int = 8
    n_resblocks: int = 0
    activation: str = "tanh"
    time_embedding_dim: int = 0
    # Width of the final squared-feature layer of the potential MLP.  The
    # reference hardcodes 40 (core/model.py:43).
    feature_dim: int = 128
    # Random-Fourier front end for the non-parametric MLP (0 = off): input
    # is augmented with [cos(xB), sin(xB)], B ~ N(0, fourier_scale^2).
    # Plain tanh MLPs plateau ~1e-1 gradient rel-error on the multi-basin
    # GMM potential (scripts/diag_capacity.py); Fourier features fix it.
    fourier_features: int = 0
    fourier_scale: float = 1.0
    # fourier-kernel frequency init: "normal" (one scale) or "multiscale"
    # (per-feature stddev log-uniform in [scale/4, 4*scale] — see
    # models/fourier_kernel.py)
    fourier_init: str = "normal"
    # Learnable PSD-quadratic + linear skip term on the potential MLP —
    # restores the confining-potential extrapolation class in the
    # low-density tails the weak-form loss barely constrains.
    quadratic_head: bool = False
    # Compute dtype for the MLP hidden path ("float32" | "bfloat16").
    dtype: str = "float32"
    # fourier-kernel model only: train the frequencies.  Measured lever
    # past the fixed-feature ~0.4 plateau when paired with
    # solver.train.kmv_field_reg (0.227 at K=512 vs 0.35-0.42 fixed;
    # see models/fourier_kernel.py for the failure mode field_reg pins).
    # Default keeps the classic fixed-random-features setting.
    fourier_trainable: bool = False


@dataclass(frozen=True)
class LearningRateConfig:
    initial: float = 0.001
    scheduling: str = "None"  # None | cosine
    # The reference hardcodes 20000 cosine decay steps regardless of run
    # length (main.py:16); we expose it.
    cosine_decay_steps: int = 20_000
    cosine_alpha: float = 0.001


@dataclass(frozen=True)
class OptimizerConfig:
    method: str = "SGD"  # reference name for its adam chain (main.py:12-26)
    momentum: float = 0.9
    weight_decay: float = 0.001
    # Global-norm gradient clipping (0 = off, reference parity).  The
    # weak-form objectives occasionally emit huge minibatch gradients that
    # can destroy a non-parametric run mid-training; clip at O(1-10) for
    # robust long runs.
    grad_clip_norm: float = 0.0
    use_ema: bool = False
    ema_decay: float = 0.999
    # Step at which the EMA engages with a state reset.  The reference
    # hardcodes 40000 (core/trainer.py:88-100).
    ema_switch_step: int = 40_000
    # "switch" reproduces the reference semantics: past the switch step the
    # live params are REPLACED by their EMA each step (core/trainer.py:
    # 88-103).  That multiplies the effective post-switch learning rate by
    # (1 - ema_decay) -- training essentially freezes at the switch.
    # "track" is decoupled Polyak averaging: params keep full optimizer
    # dynamics; a separate EMA of the iterates is what gets tested and
    # returned by fit().  Checkpoints keep the live iterate under `params`
    # and the average inside `ema_state` (scripts/analyze_np.py --ema
    # evaluates the latter).
    ema_mode: str = "switch"  # switch | track
    learning_rate: LearningRateConfig = field(default_factory=LearningRateConfig)


@dataclass(frozen=True)
class TrainConfig:
    number_of_iterations: int = 80_000
    batch_size: int = 64
    # Number of optimizer steps fused into one jitted lax.scan chunk.  The
    # reference syncs to host every step (core/trainer.py:112-113); we sync
    # once per chunk.
    steps_per_chunk: int = 100
    # >= 0: re-key ONLY the training data stream (same problem instance,
    # independent estimator noise) — runs differing only in data_seed are
    # ensemble members for gradient-field averaging.  -1 = derive from
    # the global seed split (reference parity, main.py:43-44).
    data_seed: int = -1
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


@dataclass(frozen=True)
class TestConfig:
    batch_size: int = 50_000
    frequency: int = 100
    verbose: bool = False


@dataclass(frozen=True)
class PlotConfig:
    batch_size: int = 50_000
    frequency: int = 2000
    enable: bool = False


@dataclass(frozen=True)
class BackendConfig:
    """Device-mesh layout (replaces reference backend.use_pmap_train)."""

    # Number of mesh devices along the data (particle/batch) axis;
    # 0 = use all available devices.
    data_axis_size: int = 0
    # Mean-field reference-axis shards for KMV (our "sequence parallel").
    ref_axis_size: int = 1
    use_mesh: bool = True
    donate_state: bool = True
    # If set, capture a jax.profiler device trace of one training chunk
    # into this directory (viewable with tensorboard/xprof).
    profile_dir: str = ""
    # PRNG implementation: "threefry2x32" (default; splittable, fully
    # reproducible across platforms) or "rbg" (statistically sound, a
    # different stream).
    prng_impl: str = "threefry2x32"


@dataclass(frozen=True)
class CheckpointConfig:
    """Orbax checkpointing. The reference declares this block but never
    reads it (configurations/config.yaml:9-14); here it is functional."""

    load_model: bool = False
    save_model: bool = False
    save_frequency: int = 2000
    model_directory: str = "./checkpoint"


@dataclass(frozen=True)
class LogDensityConfig:
    """Normalizing-flow density-estimation trainer (reference L6)."""

    # Where the PINN solver's log-density knowledge comes from:
    # "exact"   — the problem's closed-form Gaussian path law;
    # "learned" — train a time-conditioned RealNVP by MLE on the offline
    #             dataset first and differentiate it (the reference's
    #             dormant main.py:50 intent, live end-to-end here).
    source: str = "exact"
    num_epochs: int = 20_000
    batch_size_time: int = 50
    embed_time_dim: int = 10
    couple_mul: int = 4
    mask_type: str = "loop"
    activation: str = "celu"
    soft_init: float = 1.0
    learning_rate: float = 1e-3
    lr_constant_steps: int = 5000
    lr_decay_end_step: int = 15_000


@dataclass(frozen=True)
class LoggingConfig:
    # jsonl | csv | wandb | none
    writer: str = "jsonl"
    run_dir: str = "./runs"
    project: str = ""


@dataclass(frozen=True)
class Config:
    pde_instance: PDEInstanceConfig = field(default_factory=PDEInstanceConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    neural_network: NetworkConfig = field(default_factory=NetworkConfig)
    log_density: LogDensityConfig = field(default_factory=LogDensityConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    plot: PlotConfig = field(default_factory=PlotConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    save_and_load: CheckpointConfig = field(default_factory=CheckpointConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    seed: int = 1
    estimation_mode: str = "parametric"  # parametric | non-parametric
    ODE_tolerance: float = 1e-5


# ---------------------------------------------------------------------------
# Construction / override machinery
# ---------------------------------------------------------------------------


def _coerce(value: Any, target_type: Any) -> Any:
    """Coerce a string (from YAML/CLI) to the dataclass field type."""
    if target_type is bool and isinstance(value, str):
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if target_type in (int, float, str) and not isinstance(value, target_type):
        return target_type(value)
    return value


def _from_dict(cls: type, data: dict) -> Any:
    kwargs = {}
    field_map = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in field_map:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        f = field_map[key]
        if is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[key] = _from_dict(f.type, value)
        elif isinstance(value, dict):
            # dataclass fields whose type annotation is a string (from
            # __future__ annotations): resolve from the default factory.
            sub_default = field_map[key].default_factory()  # type: ignore[misc]
            kwargs[key] = _from_dict(type(sub_default), value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def from_dict(data: dict) -> Config:
    return _from_dict(Config, data)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return from_dict(data)


def apply_override(cfg: Any, dotted_key: str, value: Any) -> Any:
    """Return a copy of `cfg` with `dotted_key` (e.g. "train.batch_size")
    replaced by `value` (coerced to the field's type)."""
    head, _, rest = dotted_key.partition(".")
    field_map = {f.name: f for f in fields(cfg)}
    if head not in field_map:
        raise KeyError(f"unknown config key {head!r} on {type(cfg).__name__}")
    current = getattr(cfg, head)
    if rest:
        new_value = apply_override(current, rest, value)
    else:
        new_value = _coerce(value, type(current))
    return dataclasses.replace(cfg, **{head: new_value})


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply Hydra-style `key.path=value` overrides."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, _, value = item.partition("=")
        cfg = apply_override(cfg, key.strip(), value.strip())
    return cfg


# Canonical experiment presets, mirroring the reference's launch scripts
# (SURVEY.md §6, /root/reference/scripts/**).
PRESETS = {
    # scripts/run_OU.sh — overdamped OU, non-parametric default dims
    "OU": [
        "pde_instance.name=Fokker-Planck",
        "train.batch_size=50000",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "pde_instance.total_evolving_time=5",
        "train.optimizer.learning_rate.scheduling=cosine",
    ],
    # scripts/run_KOU.sh — kinetic OU, grid_time 100x2500
    "KOU": [
        "pde_instance.name=Kinetic-Fokker-Planck",
        "pde_instance.domain_dim=4",
        "train.batch_size=250000",
        "solver.train.sample_per_time=2500",
        "solver.train.n_time_stamps=100",
        "solver.train.batch_size_init=2500",
        "solver.train.batch_size_terminal=2500",
        "solver.train.batch_size_0T=250000",
        "solver.train.sample_mode=grid_time",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "pde_instance.total_evolving_time=2",
        "train.optimizer.learning_rate.scheduling=cosine",
    ],
    # scripts/run_KGMM.sh — kinetic GMM online SDE sampling
    "KGMM": [
        "pde_instance.name=Kinetic-Fokker-Planck",
        "pde_instance.potential=GMM",
        "pde_instance.domain_dim=4",
        "pde_instance.sample_mode=online",
        "pde_instance.n_steps=200",
        "solver.train.batch_size_0T=2500",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "pde_instance.total_evolving_time=2",
        "train.optimizer.learning_rate.scheduling=cosine",
        "seed=2",
    ],
    # scripts/parametric/KFP/run_KGMM_offline_parametric.sh
    "KGMM-offline": [
        "pde_instance.name=Kinetic-Fokker-Planck",
        "pde_instance.potential=GMM",
        "pde_instance.domain_dim=4",
        "pde_instance.sample_mode=offline",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "pde_instance.total_evolving_time=10",
        "train.optimizer.learning_rate.scheduling=cosine",
        "seed=2",
        "estimation_mode=parametric",
    ],
    # scripts/parametric/KMV/run_quadratic_online.sh
    "KMV": [
        "pde_instance.name=Kinetic-McKean-Vlasov",
        "pde_instance.potential=Quadratic",
        "pde_instance.domain_dim=2",
        "pde_instance.sample_mode=online",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "pde_instance.total_evolving_time=1",
        "train.optimizer.learning_rate.scheduling=cosine",
        "seed=2",
        "estimation_mode=parametric",
        "solver.train.sample_mode=grid_time",
        "solver.train.sample_per_time=5000",
        "solver.train.n_time_stamps=1",
        "solver.train.batch_size_init=0",
        "solver.train.batch_size_terminal=0",
    ],
    # Offline KMV: exact-law dataset with per-trajectory stamps feeding the
    # KMV loss's per-sample-weight path — a capability cell the reference
    # advertises axes for but cannot run (consistency.py:90-118 emits no
    # KMV-usable stamps).
    "KMV-offline": [
        "pde_instance.name=Kinetic-McKean-Vlasov",
        "pde_instance.potential=Quadratic",
        "pde_instance.domain_dim=2",
        "pde_instance.sample_mode=offline",
        "pde_instance.sample_initial_size=50000",
        "pde_instance.sample_terminal_size=50000",
        # divisible by the 64 shift-grid groups so the offline KMV weight
        # oracle takes the grouped path (one eval per (grid, stamp))
        "pde_instance.sample_0T_size=5120",
        "pde_instance.n_steps_0T=100",
        "pde_instance.total_evolving_time=1",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "train.optimizer.learning_rate.scheduling=cosine",
        "seed=2",
        "estimation_mode=parametric",
        "solver.train.batch_size_init=0",
        "solver.train.batch_size_terminal=0",
    ],
    # Best-known non-parametric KMV interaction-kernel recipe: the
    # random-Fourier-feature kernel with TRAINABLE frequencies through the
    # exact O((n+m)K) mean-field collapse (losses/fourier_meanfield.py) —
    # no pairwise grid anywhere.  Stabilized by the field-space Tikhonov
    # term (weight decay collapses this bounded-feature class to zero;
    # README "stabilizer scope" notes).  CPU probes: rel-L2 0.227 at
    # K=512/7x200 vs the 0.35-0.42 fixed-frequency plateau.
    "KMV-nonparametric-fourier": [
        "pde_instance.name=Kinetic-McKean-Vlasov",
        "pde_instance.potential=Quadratic",
        "pde_instance.domain_dim=2",
        "pde_instance.sample_mode=online",
        "pde_instance.total_evolving_time=1",
        "estimation_mode=non-parametric",
        "neural_network.model=fourier-kernel",
        "neural_network.fourier_trainable=True",
        "neural_network.fourier_features=512",
        "neural_network.fourier_scale=0.5",
        "solver.train.sample_mode=grid_time",
        "solver.train.n_time_stamps=7",
        "solver.train.sample_per_time=2000",
        "solver.train.batch_size_init=0",
        "solver.train.batch_size_terminal=0",
        "solver.train.kmv_field_reg=1e-2",
        "train.optimizer.grad_clip_norm=1.0",
        "train.optimizer.weight_decay=0.0",
        "train.optimizer.learning_rate.initial=3e-3",
        "train.optimizer.learning_rate.scheduling=cosine",
        "train.optimizer.learning_rate.cosine_decay_steps=15000",
        "train.number_of_iterations=15000",
        "train.steps_per_chunk=100",
        "seed=2",
    ],
    # Best-known ONLINE non-parametric KGMM recipe (round 2): Fourier MLP
    # (supervised capacity 4.9e-3, scripts/diag_capacity.py), BAOAB data,
    # EMA + gradient clipping, strided path batch.  Reaches ~2.4e-2
    # initial-law gradient rel-error at 40k steps;
    # the reference's offline recipe plateaus ~7e-2 here.
    "KGMM-nonparametric-online": [
        "pde_instance.name=Kinetic-Fokker-Planck",
        "pde_instance.potential=GMM",
        "pde_instance.domain_dim=4",
        "pde_instance.sample_mode=online",
        "pde_instance.n_steps=200",
        "pde_instance.integrator=baoab",
        "solver.train.batch_size_0T=2500",
        "solver.train.path_stride=2",
        "neural_network.hidden_dim=64",
        "neural_network.layers=2",
        "neural_network.feature_dim=256",
        "neural_network.fourier_features=64",
        "neural_network.fourier_scale=1.0",
        "train.number_of_iterations=40000",
        "train.optimizer.learning_rate.initial=1e-2",
        "train.optimizer.learning_rate.scheduling=cosine",
        "train.optimizer.learning_rate.cosine_decay_steps=40000",
        "train.optimizer.use_ema=True",
        "train.optimizer.ema_switch_step=20000",
        "train.optimizer.grad_clip_norm=1.0",
        "pde_instance.total_evolving_time=2",
        "estimation_mode=non-parametric",
        "seed=2",
    ],
    # scripts/non-parametric/run_KGMM.sh
    "KGMM-nonparametric": [
        "pde_instance.name=Kinetic-Fokker-Planck",
        "pde_instance.potential=GMM",
        "pde_instance.domain_dim=4",
        "pde_instance.sample_mode=offline",
        "neural_network.hidden_dim=32",
        "neural_network.layers=2",
        "train.optimizer.learning_rate.initial=1e-2",
        "pde_instance.total_evolving_time=4",
        "train.optimizer.learning_rate.scheduling=cosine",
        "seed=2",
        "estimation_mode=non-parametric",
    ],
    # Offline non-parametric at 10x the reference's trajectory count
    # (…GMM.py:158-204 regenerates 20k x 400 in memory every run; the
    # memmap array store streams 200k x 400 = ~5 GB to disk once),
    # attacking the offline dataset-bias floor with data rather than fresh
    # simulation.  offline_streaming keeps the store on the HOST end to
    # end: each training chunk gathers offline_traj_batch trajectories per
    # step from the memmap and uploads one chunk of batches — device
    # memory stays bounded however large the store grows (a non-streaming
    # run would land all ~5 GB in HBM at startup).  Same estimator recipe
    # as the online flagship: Fourier MLP + quadratic head, BAOAB data,
    # grad clip, decoupled Polyak averaging.
    "KGMM-nonparametric-offline-XL": [
        "pde_instance.name=Kinetic-Fokker-Planck",
        "pde_instance.potential=GMM",
        "pde_instance.domain_dim=4",
        "pde_instance.sample_mode=offline",
        "pde_instance.integrator=baoab",
        "pde_instance.sample_0T_size=200000",
        "pde_instance.dataset_path=/tmp/kgmm_offline_xl_store",
        "pde_instance.offline_streaming=True",
        "solver.train.offline_traj_batch=8192",
        "neural_network.hidden_dim=64",
        "neural_network.layers=2",
        "neural_network.feature_dim=256",
        "neural_network.fourier_features=64",
        "neural_network.fourier_scale=1.0",
        "neural_network.quadratic_head=True",
        "train.number_of_iterations=40000",
        "train.optimizer.learning_rate.initial=1e-2",
        "train.optimizer.learning_rate.scheduling=cosine",
        "train.optimizer.learning_rate.cosine_decay_steps=40000",
        "train.optimizer.use_ema=True",
        "train.optimizer.ema_mode=track",
        "train.optimizer.ema_decay=0.9999",
        "train.optimizer.ema_switch_step=20000",
        "train.optimizer.grad_clip_norm=1.0",
        "pde_instance.total_evolving_time=2",
        "estimation_mode=non-parametric",
        "seed=2",
    ],
}


def preset(name: str, extra_overrides: Optional[list[str]] = None) -> Config:
    """Build a Config from a named preset plus extra CLI-style overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    cfg = apply_overrides(Config(), PRESETS[name])
    if extra_overrides:
        cfg = apply_overrides(cfg, extra_overrides)
    return cfg
