"""The port's Trainer, checkpoints and EMA, on the CPU, beside the JAX ones."""

import glob
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import image_classifier as jic
from metatransformer_tpu.tokenizers import image as jtok
from metatransformer_tpu.train import ema as jema
from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu.train import trainer as jtrainer
from metatransformer_tpu.utils import checkpoint as jckpt
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models import image_classifier as ic
from metatransformer_tpu_torch.tokenizers import image as tok
from metatransformer_tpu_torch.train import ema, optim
from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig
from metatransformer_tpu_torch.utils import checkpoint as ckpt
from metatransformer_tpu_torch.utils import logger as port_logger

torch.set_num_threads(1)

CFG = ic.ImageClassifierConfig(
    tokenizer=tok.ImageTokenizerConfig(img_size=8, patch_size=4, dim=16),
    encoder=enc.EncoderConfig(dim=16, depth=1, num_heads=2),
    num_classes=2,
)


def _problem():
    """2-class separable images (tests/test_training.py's tiny problem)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8, 8, 3)).astype(np.float32)
    y = (x.mean((1, 2, 3)) > 0).astype(np.int64)
    x[y == 1] += 1.0

    def data():
        for i in range(0, 64, 16):
            yield {"input": x[i : i + 16], "label": y[i : i + 16]}  # numpy batches

    return data


def _forward(p, inputs, generator):
    return ic.forward(p, inputs, CFG, train=True, generator=generator)


def _trainer(tmp_path, seed=0, **cfg_kw):
    params = ic.init(CFG, torch.Generator().manual_seed(seed), device="cpu")
    cfg = TrainerConfig(**{"epochs": 8, "ckpt_dir": str(tmp_path), "log_every": 1000, **cfg_kw})
    return Trainer(_forward, optim.build("adamw", 5e-3, encoder_depth=1), params, cfg,
                   device="cpu")


def test_trainer_fits_tiny_problem_and_resumes(tmp_path):
    data = _problem()
    trainer = _trainer(tmp_path, use_ema=True, ema_decay=0.5)
    frozen_before = {k: v.clone() for k, v in trainer.frozen["encoder"].items()}
    log = trainer.fit(data, val_data=data)
    assert log["val_acc"] > 0.9, log
    assert log["steps"] == 4 and trainer.global_step == 32
    assert os.path.exists(os.path.join(str(tmp_path), "ckpt_latest.npz"))
    assert os.path.exists(os.path.join(str(tmp_path), "ckpt_best.npz"))
    for k, v in frozen_before.items():  # the frozen encoder never moves
        assert torch.equal(trainer.frozen["encoder"][k], v)

    # Full resume: a fresh trainer restores parameters, optimizer moments,
    # EMA and global_step.
    trainer2 = _trainer(tmp_path, seed=1, use_ema=True, ema_decay=0.5)
    log2 = trainer2.fit(data, val_data=data, resume=True)
    assert log2 == {}  # resume epoch >= epochs: the loop never runs
    assert trainer2.global_step == trainer.global_step
    assert trainer2.optimizer.count == trainer.optimizer.count == 32
    for a, b in zip(trainer.optimizer.state_leaves(), trainer2.optimizer.state_leaves()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for tree, tree2 in ((trainer.trainable, trainer2.trainable),
                        (trainer.ema_params, trainer2.ema_params)):
        for (_, a), (_, b) in zip(optim.flatten_with_paths(tree), optim.flatten_with_paths(tree2)):
            assert torch.equal(a.detach(), b.detach())


def test_trainer_without_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = ic.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        Trainer(_forward, optim.build("adamw", 5e-3), params, TrainerConfig())


def test_checkpoint_rotation_keeps_max_keep(tmp_path):
    trainer = _trainer(tmp_path, epochs=6, max_keep=2, async_ckpt=True)
    trainer.fit(_problem())
    kept = sorted(glob.glob(os.path.join(str(tmp_path), "ckpt_epoch_*.npz")))
    assert [os.path.basename(p) for p in kept] == ["ckpt_epoch_0004.npz", "ckpt_epoch_0005.npz"]
    state, epoch = ckpt.auto_resume(str(tmp_path), device="cpu")
    assert epoch == 5 and int(state["global_step"]) == 24


def test_preemption_saves_and_fit_returns_cleanly(tmp_path):
    data = _problem()
    trainer = _trainer(tmp_path, epochs=4, handle_preemption=True)

    def interrupted():
        for i, batch in enumerate(data()):
            if trainer.epoch == 1 and i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    trainer.fit(interrupted)
    assert signal.getsignal(signal.SIGTERM) == before  # handlers restored
    assert os.path.exists(os.path.join(str(tmp_path), "ckpt_preempt.npz"))
    assert trainer.epoch == 1 and 4 < trainer.global_step < 8
    # restart: redo the interrupted epoch with the step counter intact
    trainer2 = _trainer(tmp_path, seed=1, epochs=4)
    state, epoch = ckpt.auto_resume(str(tmp_path), device="cpu")
    assert epoch == 0 and int(state["resume_epoch"]) == 1
    trainer2.fit(data, resume=True)
    assert trainer2.global_step == trainer.global_step + 3 * 4


def test_early_stopping_stops_fit(tmp_path):
    trainer = _trainer(tmp_path, epochs=50, early_stop_patience=2, ckpt_dir=None)
    trainer.fit(_problem(), val_data=_problem())
    assert trainer.early.should_stop and trainer.epoch < 49
    es, jes = ckpt.EarlyStopping(patience=2, mode="min"), jckpt.EarlyStopping(patience=2, mode="min")
    for v in (1.0, 1.5, 1.4):
        assert es(v) == jes(v)
    assert es.should_stop and jes.should_stop


def test_accumulating_trainer_takes_steps(tmp_path):
    trainer = _trainer(tmp_path, epochs=1, accum_steps=4, ckpt_dir=None)
    log = trainer.fit(_problem())
    assert log["steps"] == 4 and np.isfinite(log["loss"])


STATE = {
    "trainable": {"w": np.arange(4, dtype=np.float32).reshape(2, 2),
                  "nested": {"b": np.zeros(3, np.float32)}},
    "opt_state": [np.int32(7), np.ones(2, np.float32), np.full(2, 2.0, np.float32)],
    "global_step": np.int64(7),
}


def test_jax_checkpoint_loads_in_port_and_back(tmp_path):
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save(jpath, jax.tree.map(jnp.asarray, STATE))
    got = ckpt.load(jpath, device="cpu")
    assert isinstance(got["opt_state"], list) and len(got["opt_state"]) == 3
    np.testing.assert_array_equal(got["trainable"]["w"].numpy(), STATE["trainable"]["w"])
    assert int(got["opt_state"][0]) == 7 and int(got["global_step"]) == 7
    ckpt.save(ppath, got)  # tensors out, the same layout
    back = jckpt.load(ppath)
    np.testing.assert_array_equal(np.asarray(back["trainable"]["nested"]["b"]), np.zeros(3))
    np.testing.assert_array_equal(np.asarray(back["opt_state"][2]), STATE["opt_state"][2])
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
    # bf16 leaves widen exactly
    ckpt.save(ppath, {"w": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)})
    assert ckpt.load(ppath, device="cpu")["w"].dtype == torch.float32


def test_port_resumes_from_a_jax_trainer_checkpoint(tmp_path):
    """The JAX Trainer saves ``opt_state`` as its list of leaves; the port's
    optimizer reads that list (count, mu leaves, nu leaves)."""
    params = ic.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    to_j = lambda t: jax.tree.map(lambda a: jnp.asarray(a.numpy()), t)
    jcfg = jic.ImageClassifierConfig(
        tokenizer=jtok.ImageTokenizerConfig(img_size=8, patch_size=4, dim=16),
        encoder=jenc.EncoderConfig(dim=16, depth=1, num_heads=2), num_classes=2,
    )
    data = _problem()
    jdata = lambda: ({k: jnp.asarray(v.astype(np.int32) if k == "label" else v)
                      for k, v in b.items()} for b in data())
    jt = jtrainer.Trainer(
        lambda p, x, r: jic.forward(p, x, jcfg), joptim.build("adamw", 5e-3, encoder_depth=1),
        to_j(params), jtrainer.TrainerConfig(epochs=2, ckpt_dir=str(tmp_path), log_every=1000),
    )
    jt.fit(jdata)
    trainer = _trainer(tmp_path, seed=3, epochs=2)
    trainer.fit(data, resume=True)  # nothing left to run: only the restore
    assert trainer.global_step == jt.global_step == 8
    assert trainer.optimizer.count == 8
    jleaves = jax.tree_util.tree_leaves(jt.opt_state)
    for a, b in zip(trainer.optimizer.state_leaves(), jleaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(
        trainer.trainable["head"]["w0"].detach().numpy(),
        np.asarray(jt.trainable["head"]["w0"]), rtol=1e-6,
    )


def test_save_rotating_and_average_match_jax(tmp_path):
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for epoch in range(4):
        state = {"trainable": {"w": np.full((2,), float(epoch), np.float32)},
                 "global_step": np.int64(epoch)}
        ckpt.save_rotating(d, state, epoch, is_best=(epoch == 1), max_keep=3)
        jckpt.save_rotating(jd, jax.tree.map(jnp.asarray, state), epoch, is_best=(epoch == 1),
                            max_keep=3)
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
    got = ckpt.average_epoch_range(d, 1, 3, device="cpu")
    want = jckpt.average_epoch_range(jd, 1, 3)
    np.testing.assert_allclose(got["trainable"]["w"].numpy(), np.asarray(want["trainable"]["w"]))
    assert int(got["epoch"]) == int(want["epoch"]) == 3
    with pytest.raises(FileNotFoundError):
        ckpt.average_epoch_range(d, 10, 12, device="cpu")
    with pytest.raises(ValueError):
        ckpt.average_checkpoints([], device="cpu")
    assert ckpt.auto_resume(str(tmp_path / "empty"), device="cpu") is None


def test_auto_resume_skips_a_truncated_file(tmp_path):
    d = str(tmp_path)
    ckpt.save_rotating(d, {"trainable": {"w": np.ones(2, np.float32)}}, 0)
    with open(os.path.join(d, "ckpt_latest.npz"), "wb") as f:
        f.write(b"not an npz")
    state, epoch = ckpt.auto_resume(d, device="cpu")
    assert epoch == 0 and state["trainable"]["w"].tolist() == [1.0, 1.0]


def test_ema_after_three_updates_matches_jax():
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((3, 2)).astype(np.float32),
          "head": {"b": rng.standard_normal(2).astype(np.float32)}}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.tensor(v) for k, v in t.items()}
    params = to_t(p0)
    e, je = ema.init(params), jema.init(jax.tree.map(jnp.asarray, p0))
    assert e["w"] is not params["w"]
    for i in range(3):
        step = jax.tree.map(lambda a: a + 0.1 * (i + 1), p0)
        with torch.no_grad():
            for _, v in optim.flatten_with_paths(params):
                v.add_(0.1)  # params = p0 + 0.1 * (i + 1)
        ema.update(e, params, decay=0.9)
        je = jema.update(je, jax.tree.map(jnp.asarray, step), decay=0.9)
    np.testing.assert_allclose(e["w"].numpy(), np.asarray(je["w"]), rtol=1e-6)
    np.testing.assert_allclose(e["head"]["b"].numpy(), np.asarray(je["head"]["b"]), rtol=1e-6)


def test_logger_and_exp_directory(tmp_path):
    log = port_logger.setup_logger("mt_torch_test", log_file=str(tmp_path / "log" / "a.log"))
    assert port_logger.setup_logger("mt_torch_test") is log
    log.info("hello")
    path = port_logger.generate_exp_directory(str(tmp_path), "exp", tags=("a", "b"))
    assert os.path.isdir(os.path.join(path, "checkpoint")) and "a-b-" in path
    port_logger.Wandb(enabled=False).log({"x": 1})
    port_logger.Tensorboard(None).scalar("x", 1.0, 0)


# ------------------------------------------- dict batches (tabular, FP32)

from metatransformer_tpu.models import tabular_classifier as jtab  # noqa: E402
from metatransformer_tpu.tokenizers import tabular as jtabtok  # noqa: E402
from metatransformer_tpu.train import step as jstep  # noqa: E402
from metatransformer_tpu_torch.core import convert  # noqa: E402
from metatransformer_tpu_torch.models import tabular_classifier as tab  # noqa: E402
from metatransformer_tpu_torch.tokenizers import tabular as tabtok  # noqa: E402
from metatransformer_tpu_torch.train import step as step_lib  # noqa: E402

_TAB = dict(vocab_sizes=(5, 7, 4), n_continuous=2, dim=16)
JTAB_CFG = jtab.TabularClassifierConfig(
    tokenizer=jtabtok.TabularTokenizerConfig(**_TAB),
    encoder=jenc.EncoderConfig(dim=16, depth=1, num_heads=2), num_classes=3)
TAB_CFG = tab.TabularClassifierConfig(
    tokenizer=tabtok.TabularTokenizerConfig(**_TAB),
    encoder=enc.EncoderConfig(dim=16, depth=1, num_heads=2), num_classes=3)


def _dict_batch():
    """A nested batch: the input is a dict (with a None leaf), as the
    tabular, time-series, segmentation and graph recipes give."""
    rng = np.random.default_rng(3)
    return {
        "input": {
            "tab": {
                "categorical": rng.integers(0, 4, (8, 3)).astype(np.int32),
                "continuous": rng.standard_normal((8, 2)).astype(np.float32),
            },
            "unused": None,
        },
        "label": rng.integers(0, 3, 8).astype(np.int64),
    }


def _tab_forward(p, x, generator):
    t = x["tab"]
    return tab.forward(p, t["categorical"], TAB_CFG, continuous=t["continuous"],
                       precision=enc.FP32)


def _jtab_forward(p, x, rng):
    t = x["tab"]
    return jtab.forward(p, t["categorical"], JTAB_CFG, continuous=t["continuous"],
                        precision=jenc.FP32)


def _tab_params():
    return jax.tree.map(np.asarray, jtab.init(JTAB_CFG, jax.random.PRNGKey(4)))


def _dict_trainer(np_params, accum_steps):
    return Trainer(
        # SGD: AdamW's first update, lr * g / |g|, would amplify the
        # rounding of a near-zero gradient into the step
        _tab_forward, optim.make_optimizer("sgd", lr=0.1),
        convert.from_numpy(np_params, "cpu"),
        TrainerConfig(epochs=1, log_every=1000, accum_steps=accum_steps),
        frozen_keys=(), device="cpu",
    )


def test_dict_batch_trainer_step_accumulates_and_matches_jax():
    """One Trainer step on a nested dict batch: at accum_steps=2 it equals
    the step at accum_steps=1 (FP32, 1e-6), and both equal JAX's
    make_train_step on the same batch and parameters (1e-5)."""
    np_params, batch = _tab_params(), _dict_batch()
    one, two = _dict_trainer(np_params, 1), _dict_trainer(np_params, 2)
    s1, s2 = one.train_epoch([batch]), two.train_epoch([batch])
    np.testing.assert_allclose(s2["loss"], s1["loss"], rtol=1e-6)
    flat1 = optim.flatten_with_paths(one.trainable)
    flat2 = optim.flatten_with_paths(two.trainable)
    for (path, a), (_, b) in zip(flat1, flat2):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg="/".join(path))
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg="/".join(path))

    tx = joptim.make_optimizer("sgd", lr=0.1)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    for accum, trainer in ((1, one), (2, two)):
        step = jax.jit(jstep.make_train_step(_jtab_forward, tx, accum_steps=accum))
        new, _, metrics = step(jparams, {}, tx.init(jparams), jbatch, jax.random.PRNGKey(0))
        np.testing.assert_allclose(s1["loss"], float(metrics["loss"]), rtol=1e-5)
        for (path, p), (_, want) in zip(optim.flatten_with_paths(trainer.trainable),
                                        optim.flatten_with_paths(jax.tree.map(np.asarray, new))):
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"accum {accum}: " + "/".join(path))
    # the validation pass takes the dict input too
    assert 0.0 <= one.validate([batch])["acc"] <= 1.0


def test_micro_batches_split_every_leaf_of_a_nested_batch():
    batch = {"input": {"a": torch.arange(8).reshape(4, 2), "b": {"c": torch.ones(4)},
                       "none": None}, "label": torch.arange(4)}
    micro = step_lib._to_micro(batch, 2)
    assert len(micro) == 2
    assert torch.equal(micro[1]["input"]["a"], torch.tensor([[4, 5], [6, 7]]))
    assert micro[0]["input"]["b"]["c"].shape == (2,) and micro[1]["input"]["none"] is None
    assert torch.equal(micro[0]["label"], torch.tensor([0, 1]))
    batch["input"]["b"]["c"] = torch.ones(3)
    with pytest.raises(ValueError, match=r"batch axis \(3,\) not divisible by accum_steps=2"):
        step_lib._to_micro(batch, 2)


def test_accuracy_of_absent_and_structured_labels_is_zero():
    """As the reference's step computes it (step.py:86): no label, or a
    dict label (the time-series reconstruction recipes), gives 0."""
    logits = torch.randn(4, 3)
    assert step_lib._accuracy(logits, None).item() == 0.0
    assert step_lib._accuracy(logits, {"y": torch.zeros(4), "observed": torch.ones(4)}).item() == 0.0
    assert float(jstep._accuracy(jnp.zeros((4, 3)), None)) == 0.0
    assert float(jstep._accuracy(jnp.zeros((4, 3)), {"y": jnp.zeros(4)})) == 0.0
