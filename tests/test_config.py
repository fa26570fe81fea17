"""Config system tests: overrides, YAML, presets, CLI parsing."""

import os

import pytest

from pde_inverse import config as config_lib
from pde_inverse.config import Config, apply_overrides, preset


class TestOverrides:
    def test_nested_override_and_coercion(self):
        cfg = apply_overrides(
            Config(),
            [
                "train.optimizer.learning_rate.initial=1e-2",
                "train.number_of_iterations=123",
                "backend.use_mesh=False",
                "pde_instance.name=Kinetic-Fokker-Planck",
            ],
        )
        assert cfg.train.optimizer.learning_rate.initial == 0.01
        assert cfg.train.number_of_iterations == 123
        assert cfg.backend.use_mesh is False
        assert cfg.pde_instance.name == "Kinetic-Fokker-Planck"
        # original untouched (frozen dataclasses)
        assert Config().train.number_of_iterations == 80000

    def test_unknown_key_raises(self):
        with pytest.raises(KeyError, match="bogus"):
            apply_overrides(Config(), ["bogus.key=1"])
        with pytest.raises(KeyError, match="nope"):
            apply_overrides(Config(), ["train.nope=1"])

    def test_malformed_override_raises(self):
        with pytest.raises(ValueError, match="key=value"):
            apply_overrides(Config(), ["no_equals_sign"])

    def test_bool_coercion_variants(self):
        for val, expected in [("true", True), ("False", False), ("1", True)]:
            cfg = apply_overrides(Config(), [f"backend.use_mesh={val}"])
            assert cfg.backend.use_mesh is expected
        with pytest.raises(ValueError):
            apply_overrides(Config(), ["backend.use_mesh=maybe"])


class TestPresets:
    @pytest.mark.parametrize(
        "name",
        [
            "OU",
            "KOU",
            "KGMM",
            "KGMM-offline",
            "KGMM-nonparametric",
            "KGMM-nonparametric-online",
            "KMV",
            "KMV-offline",
        ],
    )
    def test_all_presets_build(self, name):
        cfg = preset(name)
        assert cfg.pde_instance.name

    def test_unknown_preset(self):
        with pytest.raises(KeyError, match="available"):
            preset("NOPE")

    def test_preset_with_extra_overrides(self):
        cfg = preset("KOU", ["seed=42"])
        assert cfg.seed == 42
        assert cfg.solver.train.sample_mode == "grid_time"


class TestYaml:
    def test_yaml_roundtrip(self, tmp_path):
        path = str(tmp_path / "c.yaml")
        with open(path, "w") as f:
            f.write(
                "pde_instance:\n"
                "  name: Kinetic-Fokker-Planck\n"
                "  domain_dim: 3\n"
                "train:\n"
                "  number_of_iterations: 7\n"
                "  optimizer:\n"
                "    weight_decay: 0.5\n"
            )
        cfg = config_lib.load_yaml(path)
        assert cfg.pde_instance.domain_dim == 3
        assert cfg.train.number_of_iterations == 7
        assert cfg.train.optimizer.weight_decay == 0.5
        # defaults preserved for unset fields
        assert cfg.test.frequency == 100

    def test_repo_example_config_loads(self):
        repo_cfg = os.path.join(os.path.dirname(__file__), "..", "configs", "kou.yaml")
        cfg = config_lib.load_yaml(repo_cfg)
        assert cfg.solver.train.n_time_stamps == 100

    def test_yaml_unknown_key_raises(self, tmp_path):
        path = str(tmp_path / "bad.yaml")
        with open(path, "w") as f:
            f.write("not_a_field: 1\n")
        with pytest.raises(KeyError):
            config_lib.load_yaml(path)


class TestCLIParse:
    def test_parse_args_preset_and_overrides(self):
        from pde_inverse.main import parse_args

        cfg = parse_args(["preset=KOU", "seed=5", "train.steps_per_chunk=10"])
        assert cfg.seed == 5
        assert cfg.train.steps_per_chunk == 10
        assert cfg.solver.train.batch_size_0T == 250000

    def test_parse_args_config_file(self, tmp_path):
        from pde_inverse.main import parse_args

        path = str(tmp_path / "c.yaml")
        with open(path, "w") as f:
            f.write("seed: 9\n")
        cfg = parse_args([f"config={path}", "test.frequency=3"])
        assert cfg.seed == 9 and cfg.test.frequency == 3
