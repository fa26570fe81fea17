"""Optimizer construction with reference-matching semantics.

The north star requires matching the reference's exact optimizer chain
(/root/reference/main.py:11-29): decoupled weight decay *added before* Adam
in the chain (note: NOT AdamW — the decay term passes through Adam's moment
normalization), Adam b1=0.9, eps=1e-4, and an optional cosine decay schedule
whose decay horizon is independent of the run length (default 20000 steps,
alpha=1e-3) — all exposed through the typed config instead of hardcoded.
"""

from __future__ import annotations

import optax

from pde_inverse.config import OptimizerConfig


def get_learning_rate(cfg: OptimizerConfig):
    lr = cfg.learning_rate
    if lr.scheduling == "None":
        return lr.initial
    if lr.scheduling == "cosine":
        return optax.cosine_decay_schedule(
            lr.initial, lr.cosine_decay_steps, lr.cosine_alpha
        )
    raise ValueError(f"unknown lr scheduling {lr.scheduling!r}")


def get_optimizer(cfg: OptimizerConfig) -> optax.GradientTransformation:
    if cfg.method != "SGD":
        # The reference names its (adam) chain "SGD" (main.py:12); accept
        # "adam" as an alias and reject the rest.
        if cfg.method.lower() != "adam":
            raise ValueError(f"unknown optimizer method {cfg.method!r}")
    schedule = get_learning_rate(cfg)
    steps = [optax.add_decayed_weights(cfg.weight_decay)]
    if cfg.grad_clip_norm > 0:
        # Global-norm clipping BEFORE the decay/Adam chain: the weak-form
        # losses are unbounded below and occasionally emit a huge minibatch
        # gradient that can blow up non-parametric training mid-run
        # (observed on online KGMM at lr 1e-2); clipping bounds the update
        # without touching steady-state dynamics.
        steps.insert(0, optax.clip_by_global_norm(cfg.grad_clip_norm))
    steps.append(optax.adam(learning_rate=schedule, b1=0.9, eps=1e-4))
    return optax.chain(*steps)
