"""The port's config loader against the JAX one: every shipped recipe YAML
(read in place from metatransformer_tpu/configs/), with and without
overrides, and a _base_ chain with _delete_."""

import glob
import os

import pytest

import metatransformer_tpu.configs as jcfgs
from metatransformer_tpu.configs import config as jconfig
from metatransformer_tpu_torch.configs import CONFIG_DIR, Config, config, load_config

YAMLS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))


def test_config_dir_is_the_reference_configs():
    assert os.path.samefile(CONFIG_DIR, os.path.dirname(jcfgs.__file__))
    assert len(YAMLS) == 56 and "default.yaml" in YAMLS


@pytest.mark.parametrize("name", YAMLS)
def test_load_config_matches_jax(name):
    path = os.path.join(CONFIG_DIR, name)
    got = load_config(path)
    assert isinstance(got, Config)
    assert got.to_dict() == jconfig.load_config(path).to_dict()
    overrides = ["train.batch_size=2", "train.lr=3e-4", "encoder.frozen=false",
                 "model.new.deep=[1, 2]", "seed=7", "note=hello"]
    assert (load_config(path, overrides).to_dict()
            == jconfig.load_config(path, overrides).to_dict())


def test_base_chain_with_delete_and_attribute_access(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "seed: 1\nmodel:\n  tokenizer: {patch: 16, dim: 8}\n  heads: [a, b]\n"
        "train:\n  lr: 0.1\n  sched: {name: cosine, warm: 5}\n")
    (tmp_path / "mid.yaml").write_text(
        "_base_: base.yaml\nmodel:\n  tokenizer:\n    dim: 32\n"
        "train:\n  sched:\n    _delete_: true\n    name: poly\n")
    (tmp_path / "top.yaml").write_text(
        "_base_: [mid.yaml]\n# a comment\nmodel: {heads: [c]}\ntrain: {epochs: 3}\n")
    path = str(tmp_path / "top.yaml")
    got, want = load_config(path), jconfig.load_config(path)
    assert got.to_dict() == want.to_dict()
    assert got.train.sched == {"name": "poly"}
    assert got.model.tokenizer.patch == 16 and got.model.tokenizer.dim == 32
    assert got.model.heads == ["c"]
    with pytest.raises(AttributeError):
        got.nope
    got.extra = 5
    assert got["extra"] == 5
    assert config._merge({"a": {"b": 1}}, {"a": {"_delete_": True, "c": 2}}) == \
        jconfig._merge({"a": {"b": 1}}, {"a": {"_delete_": True, "c": 2}}) == {"a": {"c": 2}}


def test_override_needs_key_value():
    with pytest.raises(ValueError, match="is not key=value"):
        load_config(os.path.join(CONFIG_DIR, "default.yaml"), ["train.lr"])
