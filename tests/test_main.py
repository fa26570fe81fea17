"""pde_inverse.main: build() is the seeded construction run() trains, and
trainer_rng() the trainer's key."""

import jax
import numpy as np
import pytest

from pde_inverse import main as entry
from pde_inverse.config import preset

_SMALL = ["solver.train.sample_per_time=16", "solver.train.n_time_stamps=2"]


def test_build_is_deterministic_in_the_seed():
    a = entry.build(preset("KOU", _SMALL))
    b = entry.build(preset("KOU", _SMALL))
    c = entry.build(preset("KOU", _SMALL + ["seed=5"]))
    for la, lb in zip(jax.tree_util.tree_leaves(a[3]), jax.tree_util.tree_leaves(b[3])):
        np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(a[0].configuration["F"], b[0].configuration["F"])
    assert a[0].recovered_parameter_rel_l2(a[3]) == b[0].recovered_parameter_rel_l2(b[3])
    assert type(c[1]) is type(a[1])


@pytest.mark.parametrize("data_seed", [-1, 0, 7])
def test_trainer_rng(data_seed):
    cfg = preset("KOU", _SMALL + [f"train.data_seed={data_seed}", "seed=3"])
    want = (
        jax.random.split(jax.random.PRNGKey(3), 4)[2]
        if data_seed < 0
        else jax.random.PRNGKey(data_seed)
    )
    np.testing.assert_array_equal(entry.trainer_rng(cfg), want)
