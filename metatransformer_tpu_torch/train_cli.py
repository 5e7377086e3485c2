"""Training entry point: ``python -m metatransformer_tpu_torch.train_cli
--cfg metatransformer_tpu/configs/modelnet40_metatransformer.yaml
[key=value overrides]``.

Port of ``metatransformer_tpu/train_cli.py``: one CLI for every recipe,
building model + optimizer + Trainer from the unified YAML config (the
recipe YAMLs are read in place from ``metatransformer_tpu/configs/``).
With no ``--data`` it trains on synthetic data, so every ported recipe runs
anywhere. It runs on the card unless ``--device cpu`` is given, and raises
where there is none.

Every flag of the reference is here except ``--compile-cache`` (XLA's
executable cache): the port's compiled kernels are cached by the keyed
``_build/`` directory of ``ops/_build.py``. ``--device`` is the port's own.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.train import optim, schedules
from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig, batch_to_device


def _encoder_cfg(cfg) -> enc.EncoderConfig:
    scale = cfg.encoder.scale
    if scale == "large":
        return enc.LARGE
    if scale == "tiny":  # smoke-train scale for tests / CPU dry runs
        return enc.EncoderConfig(dim=64, depth=2, num_heads=4)
    return enc.BASE


def build_point(cfg, generator: torch.Generator, device: _device.Device = None):
    """The point classifier recipe: (params, forward, synth)."""
    from metatransformer_tpu_torch.models import point_classifier
    from metatransformer_tpu_torch.tokenizers import point as point_tok

    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg)
    mcfg = point_classifier.PointClassifierConfig(
        tokenizer=point_tok.PointTokenizerConfig(
            sample_ratio=cfg.model.tokenizer.sample_ratio,
            group_size=cfg.model.tokenizer.group_size,
            subsample=cfg.model.tokenizer.subsample,
            group=cfg.model.tokenizer.group,
            feature_type=cfg.model.tokenizer.feature_type,
            embed_dim=ecfg.dim,
        ),
        encoder=ecfg,
        num_classes=cfg.model.num_classes,
        global_feat=cfg.model.global_feat,
    )
    params = point_classifier.init(mcfg, generator, device)

    def forward(p, x, gen):
        return point_classifier.forward(p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        n = cfg.train.get("num_points", 1024)
        for _ in range(n_batches):
            pts = rng.standard_normal((batch_size, n, 3)).astype(np.float32)
            labels = rng.integers(0, cfg.model.num_classes, batch_size).astype(np.int64)
            yield {"input": pts, "label": labels}

    return params, forward, synth


def build_audio(cfg, generator: torch.Generator, device: _device.Device = None):
    """The audio (spectrogram) classifier recipe: (params, forward, synth)."""
    from metatransformer_tpu_torch.models import audio_classifier
    from metatransformer_tpu_torch.tokenizers import audio as audio_tok

    device = _device.resolve(device)
    frames = cfg.train.get("audio_length", 98)
    ecfg = _encoder_cfg(cfg)
    mcfg = audio_classifier.AudioClassifierConfig(
        tokenizer=audio_tok.AudioTokenizerConfig(
            num_mel_bins=cfg.model.tokenizer.num_mel_bins,
            num_frames=frames,
            patch_size=cfg.model.tokenizer.patch_size,
            fstride=cfg.model.tokenizer.fstride,
            tstride=cfg.model.tokenizer.tstride,
            dim=ecfg.dim,
        ),
        encoder=ecfg,
        num_classes=cfg.model.num_classes,
    )
    params = audio_classifier.init(mcfg, generator, device)

    def forward(p, x, gen):
        return audio_classifier.forward_spectrogram(
            p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            spec = rng.standard_normal(
                (batch_size, frames, cfg.model.tokenizer.num_mel_bins)
            ).astype(np.float32)
            labels = rng.integers(0, cfg.model.num_classes, batch_size).astype(np.int64)
            yield {"input": spec, "label": labels}

    return params, forward, synth


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt", default=None, help="converted encoder .npz/.pth")
    p.add_argument(
        "--data", default=None, metavar="PATH",
        help="real dataset path (image recipes: ImageFolder tree of "
             "JPEG/PNG or a path\\tlabel manifest: raw bytes -> uint8 "
             "batches -> scaling on the device); omitted = synthetic data",
    )
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=8)
    p.add_argument("--work-dir", default=None)
    p.add_argument(
        "--smoke", action="store_true",
        help="tiny-geometry structurally-identical model + synthetic data "
             "(every recipe is executable on CPU in seconds)",
    )
    p.add_argument(
        "--eval", action="store_true",
        help="evaluation-only: restore the latest checkpoint from "
             "--work-dir (if given) and report metrics without training",
    )
    p.add_argument(
        "--profile", action="store_true",
        help="print params / throughput for the recipe's model and exit "
             "(PointCloud/examples/profile.py surface; no FLOP count)",
    )
    p.add_argument(
        "--wa", nargs=2, type=int, default=None, metavar=("START", "END"),
        help="with --eval: average the parameters of ckpt_epoch_{START..END} "
             "before evaluating (AST weight-averaging eval)",
    )
    p.add_argument(
        "--ensemble", action="store_true",
        help="with --eval (classification recipes): average the prediction "
             "logits of every ckpt_epoch_*.npz in --work-dir",
    )
    p.add_argument(
        "--eval-all", action="store_true",
        help="evaluate EVERY ckpt_epoch_*.npz in --work-dir and report the best",
    )
    p.add_argument(
        "--device", default=None,
        help="where to run: the card when omitted; 'cpu' runs on the CPU",
    )
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    return p


def _schedule(cfg, total_steps: int, steps_per_epoch: int):
    sched_name = cfg.train.get("schedule", "cosine")
    if sched_name == "cosine":
        return schedules.cosine_with_warmup(
            cfg.train.lr, total_steps,
            warmup_steps=cfg.train.get("warmup_epochs", 0) * steps_per_epoch,
        )
    if sched_name == "multistep":
        return schedules.multistep(cfg.train.lr, [total_steps // 2, 3 * total_steps // 4])
    if sched_name == "type1":
        return schedules.type1_halving(cfg.train.lr, steps_per_epoch)
    if sched_name == "one_cycle":
        return schedules.one_cycle(cfg.train.lr, total_steps)
    if sched_name == "poly":
        return schedules.poly(cfg.train.lr, total_steps)
    if sched_name == "step":
        return schedules.step_decay(cfg.train.lr, max(total_steps // 3, 1))
    if sched_name == "constant":
        return cfg.train.lr
    raise SystemExit(f"unknown schedule {sched_name!r}; valid: cosine, "
                     "multistep, type1, one_cycle, poly, step, constant")


class Session:
    """What ``main`` builds from its arguments before it trains or
    evaluates: the config, the recipe, the Trainer and the batch sources.
    ``setup(argv)`` gives it to callers that drive the steps themselves."""

    def __init__(self, args: argparse.Namespace):
        from metatransformer_tpu_torch import recipes

        self.args = args
        self.device = _device.resolve(args.device)
        cfg = self.cfg = load_config(args.cfg, args.overrides)
        self.recipe = recipe = recipes.build(
            cfg, torch.Generator().manual_seed(cfg.seed), smoke=args.smoke, device=self.device)
        if args.ckpt:
            loader = convert.convert_pth if args.ckpt.endswith(".pth") else convert.load_npz
            recipe.params["encoder"], _ = loader(args.ckpt, self.device)
        self.epochs = args.epochs or cfg.train.get("epochs", 1)
        self.batch_size = cfg.train.batch_size
        if args.data and recipe.data_loader is None:
            raise SystemExit(
                f"recipe for {cfg.get('modality', cfg.get('task'))!r} has "
                "no real-data loader; --data is not supported for it yet"
            )
        self.trainer: Optional[Trainer] = None
        if not args.profile:
            self.trainer = self._trainer()

    def _trainer(self) -> Trainer:
        args, cfg, recipe = self.args, self.cfg, self.recipe
        total_steps = self.epochs * args.steps_per_epoch
        lr = _schedule(cfg, total_steps, args.steps_per_epoch)
        tx = optim.build(
            cfg.train.get("optimizer", "adamw"), lr,
            weight_decay=cfg.train.get("weight_decay", 0.0),
            layer_decay=cfg.train.get("layer_decay"),
            encoder_depth=_encoder_cfg(cfg).depth,
        )
        # encoder.frozen: false -> full finetune
        frozen_keys = ("encoder",) if cfg.encoder.get("frozen", True) else ()
        trainer_kwargs = {}
        if recipe.loss_fn is not None:
            trainer_kwargs["loss_fn"] = recipe.loss_fn
        return Trainer(
            recipe.forward, tx, recipe.params,
            frozen_keys=frozen_keys,
            cfg=TrainerConfig(
                epochs=self.epochs,
                ckpt_dir=args.work_dir,
                log_every=max(args.steps_per_epoch // 2, 1),
                early_stop_patience=cfg.train.get("early_stop_patience"),
                best_mode=recipe.best_mode,
                accum_steps=cfg.train.get("accum_steps", 1),
                async_ckpt=cfg.train.get("async_ckpt", False),
                handle_preemption=cfg.train.get("handle_preemption", False),
            ),
            device=self.device,
            **trainer_kwargs,
        )

    def train_batches(self) -> Iterable:
        if self.args.data:
            return self.recipe.data_loader(self.args.data, self.batch_size, self.cfg.seed, True)
        return self.recipe.synth(self.batch_size, self.args.steps_per_epoch, self.cfg.seed)

    def val_batches(self) -> Iterable:
        if self.args.data:
            return self.recipe.data_loader(
                self.args.data, self.batch_size, self.cfg.seed + 1, False)
        return self.recipe.synth(self.batch_size, 2, self.cfg.seed + 1)

    def eval_batches(self) -> Iterable:
        if self.args.data:
            return self.val_batches()
        return self.recipe.synth(self.batch_size, self.args.steps_per_epoch, self.cfg.seed + 1)


def setup(argv=None) -> Session:
    """Parse ``argv`` as ``main`` does and build its Session."""
    return Session(_parser().parse_args(argv))


def _rounded(stats: Dict[str, Any]) -> Dict[str, Any]:
    return {k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()}


def _epoch_ckpts(work_dir: Optional[str], flag: str):
    if not work_dir:
        raise SystemExit(f"{flag} needs --work-dir")
    ckpts = sorted(glob.glob(os.path.join(work_dir, "ckpt_epoch_*.npz")))
    if not ckpts:
        raise SystemExit(f"no ckpt_epoch_*.npz under {work_dir}")
    return ckpts


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    s = Session(args)
    recipe = s.recipe

    if args.profile:
        from metatransformer_tpu_torch.utils import profiler

        batch = next(iter(recipe.synth(s.batch_size, 1, s.cfg.seed)))
        gen = torch.Generator(device=s.device).manual_seed(0)
        stats = profiler.profile_model(
            lambda p, x: recipe.forward(p, x, gen),
            recipe.params, batch_to_device(batch["input"], s.device), s.batch_size,
        )
        print("profile:", {k: round(v, 4) for k, v in stats.items()})
        return 0

    trainer = s.trainer
    if args.eval_all:
        from metatransformer_tpu_torch.utils import checkpoint as ckpt_lib

        ckpts = _epoch_ckpts(args.work_dir, "--eval-all")
        key = "acc" if recipe.classification else "loss"
        best = None
        for path in ckpts:
            state = ckpt_lib.load(path, s.device)
            trainer.trainable = state["trainable"]
            stats = _evaluate(recipe, trainer, s.eval_batches())
            epoch = int(state.get("epoch", -1))
            print(f"eval epoch {epoch}:", {k: round(v, 4) for k, v in stats.items()})
            better = best is None or (
                stats[key] > best[1][key] if recipe.best_mode == "max" else stats[key] < best[1][key]
            )
            if better:
                best = (epoch, stats)
        print("best:", {"epoch": best[0], **{k: round(v, 4) for k, v in best[1].items()}})
        return 0

    if args.eval:
        from metatransformer_tpu_torch.utils import checkpoint as ckpt_lib

        if args.ensemble:
            # AST ensemble validate: mean of per-checkpoint logits, then
            # argmax; classification recipes only
            ckpts = _epoch_ckpts(args.work_dir, "--ensemble")
            if not recipe.classification:
                raise SystemExit("--ensemble supports classification recipes")
            batches = list(s.eval_batches())
            summed = None
            with torch.no_grad():
                for path in ckpts:
                    trainer.trainable = ckpt_lib.load(path, s.device)["trainable"]
                    params_k = trainer.params
                    logits = [
                        recipe.forward(params_k, b["input"], None).float().cpu().numpy()
                        for b in batches
                    ]
                    summed = logits if summed is None else [a + b for a, b in zip(summed, logits)]
            labels = np.concatenate([np.asarray(b["label"]) for b in batches])
            preds = np.concatenate(summed).argmax(-1)
            acc = float((preds == labels).mean())
            print("eval:", {"acc": round(acc, 4), "ensemble_size": len(ckpts)})
            return 0
        if args.wa is not None:
            if not args.work_dir:
                raise SystemExit("--wa needs --work-dir")
            state = ckpt_lib.average_epoch_range(args.work_dir, args.wa[0], args.wa[1], s.device)
            trainer.trainable = state["trainable"]
        elif args.work_dir:
            resumed = ckpt_lib.auto_resume(args.work_dir, s.device)
            if resumed:
                trainer.trainable = resumed[0]["trainable"]
        stats = _evaluate(recipe, trainer, s.eval_batches())
        print("eval:", _rounded(stats))
        return 0

    log = trainer.fit(
        s.train_batches,
        # the generic val loop assumes class logits; structured tasks
        # (losses computed in forward) train only here
        val_data=s.val_batches if recipe.classification else None,
    )
    print("final:", _rounded(log))
    return 0


def _evaluate(recipe, trainer: Trainer, batches) -> Dict[str, float]:
    """Checkpoint -> task metric, no training. Classification recipes get
    accuracy (+ any val_metric via Trainer.validate); structured recipes
    (loss computed in forward) report the mean loss, each batch drawn with
    a generator seeded 0 (the reference's ``PRNGKey(0)``)."""
    from metatransformer_tpu_torch.train import step as step_lib

    if recipe.eval_metric is not None:
        return recipe.eval_metric(trainer.params, recipe.forward, batches)
    if recipe.classification:
        return trainer.validate(batches)
    loss_fn = recipe.loss_fn or step_lib.cross_entropy_loss
    params = trainer.params
    losses = []
    with torch.no_grad():
        for batch in batches:
            gen = torch.Generator(device=trainer.device).manual_seed(0)
            out = recipe.forward(params, batch["input"], gen)
            label = batch_to_device(batch.get("label"), trainer.device)
            losses.append(float(loss_fn(out, label)))
    return {"loss": float(np.mean(losses)), "batches": float(len(losses))}


if __name__ == "__main__":
    raise SystemExit(main())
