"""The port's config system against the JAX package's (CPU, no tolerance).

Every ``configs/*.yaml`` goes through both ``load_config``s and must give
the same ``to_dict()``; the port's own YAML reader (`parse_yaml`, the subset
the configs use) must give what ``yaml.safe_load`` gives on every file, and
refuse what lies outside the subset.
"""
from pathlib import Path

import pytest
import yaml

from dro_sfm_tpu.utils.config import load_config as jax_load_config
from dro_sfm_torch.utils.config import ConfigNode, load_config, parse_yaml, prepare_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
ids = [p.name for p in CONFIGS]


@pytest.mark.parametrize("path", CONFIGS, ids=ids)
def test_load_config_matches_jax(path):
    ours, ref = load_config(str(path)), jax_load_config(str(path))
    assert ours.to_dict() == ref.to_dict()
    assert repr(ours.to_dict()) == repr(ref.to_dict())     # types too (1 vs 1.0)


@pytest.mark.parametrize("path", CONFIGS, ids=ids)
def test_parse_yaml_matches_safe_load(path):
    text = path.read_text()
    assert repr(parse_yaml(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 0.5e-3\nb: .5\nc: +3\nd: ~\ne: yes\nf: 'it''s'\ng: \"x\\ty\"\n",
    "h: [[], ['a', 1, 2.0], True, '']\ni: 1_000\nk: -2\nl: -0.5\n",
    "m: 'a # b' # c\nn: 1e-4\no: (96, 128)\np:\nq:\n    r:\n        s: [4]\n",
    "# only a comment\n",
])
def test_parse_yaml_scalars_match_safe_load(text):
    assert repr(parse_yaml(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: b: c", "a:\n  - 1", "a: {b: 1}", "a: &x 1", "a: !!str 1", "a: 0x10",
    "a:\n    b: 1\n  c: 2", "a: [1, 2", "a: 'open", "---\na: 1", "a: |\n  x",
    "a: 1\na: 2",
])
def test_parse_yaml_refuses_outside_the_subset(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_merge_rejects_unknown_keys_and_type_changes(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("arch:\n    max_epoch: 2\n")
    with pytest.raises(KeyError, match="arch.max_epoch"):
        load_config(str(bad))
    with pytest.raises(TypeError, match="arch.max_epochs"):
        load_config(overrides={"arch": {"max_epochs": "two"}})
    with pytest.raises(TypeError, match="debug"):
        load_config(overrides={"debug": 1})
    cfg = load_config(overrides={"model": {"depth_net": {"remat": True}},
                                 "datasets": {"augmentation": {"image_shape": "(64, 96)"},
                                              "train": {"dataset": ["Synthetic", "Synthetic"],
                                                        "path": ["3"]}}})
    assert cfg.model.depth_net.remat is True
    assert cfg.datasets.augmentation.image_shape == (64, 96)
    assert cfg.datasets.train.path == ["3", "3"]
    assert cfg.datasets.train.repeat == [1, 1]
    again = prepare_config(ConfigNode(cfg.to_dict()))      # a checkpoint's sidecar
    assert again.to_dict() == cfg.to_dict()
