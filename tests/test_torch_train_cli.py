"""The port's training CLI (train_cli.py) on the CPU, mirroring
tests/test_cli_sweep.py, tests/test_eval_cli.py and the --data test of
tests/test_image_folder.py: every ported recipe YAML trains one step at
--smoke geometry, the evaluation modes restore checkpoints, --data trains
from a JPEG tree, --profile reports, and without --device the CLI asks for
the card."""

import os

import numpy as np
import pytest
import torch

from metatransformer_tpu_torch import train_cli
from metatransformer_tpu_torch.configs import CONFIG_DIR

from tests.test_torch_recipes import DET3D, DETECTION, POINT_SEG, POINT_ZOO, PORTED, UNPORTED

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _cfg(name):
    return os.path.join(CONFIG_DIR, name)


SWEEP = PORTED + list(DETECTION) + list(DET3D) + list(POINT_ZOO) + list(POINT_SEG)


def test_the_sweep_covers_every_ported_recipe():
    """Exact count, as test_no_orphan_yamls: a recipe newly ported (or a
    YAML added) must join the sweep."""
    assert len(SWEEP) == 54 and len(SWEEP) + len(UNPORTED) == 55


@pytest.mark.parametrize("name", SWEEP)
def test_recipe_executes(name, capsys):
    rc = train_cli.main(["--cfg", _cfg(name), "--smoke", "--epochs", "1",
                         "--steps-per-epoch", "1", "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final:" in out


def _train(wd, epochs=1, name="modelnet40_metatransformer.yaml"):
    rc = train_cli.main(["--cfg", _cfg(name), "--smoke", "--epochs", str(epochs),
                         "--steps-per-epoch", "2", "--work-dir", wd, "train.batch_size=2", *CPU])
    assert rc == 0


def test_eval_after_train_classification(tmp_path, capsys):
    wd = str(tmp_path / "run")
    _train(wd)
    rc = train_cli.main(["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke", "--eval",
                         "--steps-per-epoch", "2", "--work-dir", wd, "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eval:" in out and "acc" in out


def test_eval_all_checkpoints(tmp_path, capsys):
    wd = str(tmp_path / "run")
    _train(wd, epochs=2)
    rc = train_cli.main(["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke",
                         "--eval-all", "--steps-per-epoch", "2", "--work-dir", wd,
                         "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("eval epoch") == 2 and "best:" in out


def test_eval_structured_recipe(capsys):
    """Structured (loss-in-forward) recipe: the mean loss is reported."""
    rc = train_cli.main(["--cfg", _cfg("modelnet40_pointmae_pretrain.yaml"), "--smoke", "--eval",
                         "--steps-per-epoch", "2", "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eval:" in out and "loss" in out


def test_eval_structured_recipe_is_repeatable(capsys):
    """Each eval batch draws from a generator seeded 0 (the reference's
    PRNGKey(0)), so two evaluations print the same loss."""
    argv = ["--cfg", _cfg("kinetics400_videomae_pretrain.yaml"), "--smoke", "--eval",
            "--steps-per-epoch", "2", "train.batch_size=2", *CPU]
    assert train_cli.main(argv) == 0 and train_cli.main(argv) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("eval:")]
    assert len(lines) == 2 and lines[0] == lines[1]


def test_eval_shapenetpart_protocol(capsys):
    rc = train_cli.main(["--cfg", _cfg("shapenetpart_metatransformer.yaml"), "--smoke", "--eval",
                         "--steps-per-epoch", "2", "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ins_miou" in out and "cls_miou" in out


def test_profile_mode(capsys):
    rc = train_cli.main(["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke",
                         "--profile", "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "profile:" in out and "params_m" in out and "seq_per_s" in out
    assert "flops" not in out


def test_profile_of_a_dict_input_recipe(capsys):
    rc = train_cli.main(["--cfg", _cfg("adult_tabtransformer.yaml"), "--smoke", "--profile",
                         "train.batch_size=2", *CPU])
    assert rc == 0 and "seq_per_s" in capsys.readouterr().out


def test_eval_weight_averaging(tmp_path, capsys):
    wd = str(tmp_path / "run")
    _train(wd, epochs=2)
    rc = train_cli.main(["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke", "--eval",
                         "--wa", "0", "1", "--steps-per-epoch", "2", "--work-dir", wd,
                         "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eval:" in out and "acc" in out


def test_eval_ensemble(tmp_path, capsys):
    wd = str(tmp_path / "run")
    _train(wd, epochs=2)
    rc = train_cli.main(["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke", "--eval",
                         "--ensemble", "--steps-per-epoch", "2", "--work-dir", wd,
                         "train.batch_size=2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eval:" in out and "ensemble_size" in out


def test_eval_modes_need_a_work_dir():
    base = ["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke", "train.batch_size=2", *CPU]
    with pytest.raises(SystemExit, match="--eval-all needs --work-dir"):
        train_cli.main(base + ["--eval-all"])
    with pytest.raises(SystemExit, match="--ensemble needs --work-dir"):
        train_cli.main(base + ["--eval", "--ensemble"])
    with pytest.raises(SystemExit, match="--data is not supported"):
        train_cli.main(base + ["--data", "/nonexistent"])


def test_dict_input_recipe_with_gradient_accumulation(capsys):
    """A dict-input recipe at accum_steps=2 trains (the micro-batch split
    walks the nested batch)."""
    rc = train_cli.main(["--cfg", _cfg("multimodal_fusion_metatransformer.yaml"), "--smoke",
                         "--epochs", "1", "--steps-per-epoch", "1", "train.batch_size=4",
                         "train.accum_steps=2", *CPU])
    assert rc == 0 and "final:" in capsys.readouterr().out


def test_cli_data_flag(tmp_path, capsys):
    """--data trains from a JPEG tree (smoke geometry), as
    tests/test_image_folder.py drives the reference."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for i, (w, h) in enumerate([(64, 48), (48, 64), (80, 80)]):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                tmp_path / cls / f"{i}.jpg", quality=90)
    rc = train_cli.main(["--cfg", _cfg("imagenet_metatransformer.yaml"), "--smoke", "--epochs", "1",
                         "--data", str(tmp_path), "train.batch_size=2", "model.num_classes=2", *CPU])
    assert rc == 0
    assert "val_acc" in capsys.readouterr().out


def test_without_device_the_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA card and found none"):
        train_cli.main(["--cfg", _cfg("modelnet40_metatransformer.yaml"), "--smoke"])


def test_profiler_counts_params_as_jax_and_names_the_missing_flop_count():
    import jax

    from metatransformer_tpu.utils import profiler as jprofiler
    from metatransformer_tpu_torch.utils import profiler

    tree = {"a": np.zeros((3, 4), np.float32), "b": {"c": np.zeros(5), "d": None}}
    assert profiler.count_params(tree) == 17
    assert jprofiler.count_params(jax.tree.map(np.asarray, {"a": tree["a"], "b": {"c": tree["b"]["c"]}})) == 17
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 10"):
        profiler.cost_analysis(lambda x: x, np.zeros(3))
    seen = []

    def fn(p, x):
        seen.append(x["v"].clone())
        return x["v"] * p

    args = (torch.tensor(2.0), {"v": torch.ones(4), "i": torch.ones(2, dtype=torch.long)})
    stats = profiler.throughput(fn, args, 4, iters=3)
    assert stats["ms_per_batch"] > 0 and stats["seq_per_s"] > 0 and len(seen) == 6
    # each call's input depends on the last output's mean c
    seen.clear()
    profiler.throughput(fn, args, 4, iters=3,
                        perturb=lambda a, c: (a[0], {"v": a[1]["v"] + c}))
    assert [float(v[0]) for v in seen[:3]] == [1.0, 3.0, 7.0]
