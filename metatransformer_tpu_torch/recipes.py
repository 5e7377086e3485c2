"""Recipes: every shipped config YAML -> (params, forward, synthetic data)
ready for the unified Trainer.

Port of ``metatransformer_tpu/recipes.py``: one registry keyed by
(modality, task, model NAME), with the same two geometry modes:

- full (default): the YAML's published recipe geometry;
- smoke (``--smoke``): tiny but structurally identical geometry, so any
  ported recipe trains a step on the CPU in seconds.

Each ``build_*`` function takes the config, a ``torch.Generator`` that
draws the weights (the reference takes a PRNG key) and the device the
parameters live on (None: the card). ``Recipe.forward(params, inputs, generator)`` accepts
numpy arrays or tensors (nested dicts for the structured inputs), moves
them to the parameters' device and returns what the reference's forward
returns; ``generator`` draws the training-time randomness (the MAE masks,
the graph tokenizer's sign flips) where the reference takes a key.
``synth`` draws the same numpy sequence from ``np.random.default_rng(seed)``
as the reference's, so each synthetic batch is bit-equal to the JAX one;
integer labels are int64.

The ``build_*`` functions of families the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item; an unknown modality or
3D detector NAME raises ``SystemExit``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.train.trainer import batch_to_device

_ITEM_8 = "ROADMAP.md queue 1, item 8 (parallelism and encoder variants: core/moe_encoder.py)"
_ITEM_9 = "ROADMAP.md queue 1, item 9 (the task-zoo tail)"


@dataclasses.dataclass
class Recipe:
    """What a ``build_*`` function hands the CLI.

    ``forward(params, batch_input, generator)`` returns class logits for
    classification recipes (loss_fn applies CE/BCE/...) or the scalar
    training loss directly for structured tasks (loss_fn is identity).
    """

    params: Dict[str, Any]
    forward: Callable
    synth: Callable  # (batch_size, n_batches, seed) -> iterable of batches
    loss_fn: Optional[Callable] = None  # None -> cross-entropy
    classification: bool = True  # drives val loop + accuracy metric
    # kept from the reference (False there: a loss with host-side stages);
    # the port's Trainer runs every step eagerly, so nothing reads it
    jit_step: bool = True
    best_mode: str = "max"
    # task-specific --eval protocol: (params, forward, batches) -> metrics
    # dict (e.g. ShapeNetPart ins/cls-mIoU); None -> accuracy/mean-loss.
    eval_metric: Optional[Callable] = None
    # real-data loader factory: (data_path, batch_size, seed, train) ->
    # iterable of batches (image: JPEG trees/manifests through
    # data/image_folder.py); the CLI's --data switches from synth to this.
    data_loader: Optional[Callable] = None


def _identity_loss(out, _label):
    return out


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: {item}")


def _encoder_cfg(cfg, smoke: bool, num_heads: Optional[int] = None) -> enc.EncoderConfig:
    if smoke:
        return enc.EncoderConfig(dim=64, depth=2, num_heads=num_heads or 4)
    if cfg.encoder.scale == "large":
        base = enc.LARGE
    elif cfg.encoder.scale == "tiny":
        base = enc.EncoderConfig(dim=64, depth=2, num_heads=4)
    else:
        base = enc.BASE
    if num_heads:
        base = dataclasses.replace(base, num_heads=num_heads)
    return base


def _labels(rng: np.random.Generator, n: int, num_classes: int) -> np.ndarray:
    return rng.integers(0, num_classes, n).astype(np.int64)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# Classification modalities (logits + integer labels)
# ---------------------------------------------------------------------------


def build_image(cfg, generator, smoke=False, device=None):
    """ImageNet-style classification (Image/README.md recipes; also the
    X-Ray classifier, SEViT's timm ViT with frozen Meta-T blocks,
    ``X-Ray/train.py:109-131``)."""
    from metatransformer_tpu_torch.models import image_classifier
    from metatransformer_tpu_torch.tokenizers import image as image_tok

    if cfg.model.get("moe"):
        return _build_image_moe(cfg, generator, smoke, device)
    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    tok = cfg.model.get("tokenizer", {})
    patch = tok.get("patch_size", 16)  # 14 on the L14 track
    img = 2 * patch if smoke else tok.get("img_size", 224)
    mcfg = image_classifier.ImageClassifierConfig(
        tokenizer=image_tok.ImageTokenizerConfig(img_size=img, patch_size=patch, dim=ecfg.dim),
        encoder=ecfg,
        num_classes=cfg.model.num_classes,
    )
    params = image_classifier.init(mcfg, generator, device)

    def forward(p, x, gen):
        return image_classifier.forward(p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": _f32(rng.standard_normal((batch_size, img, img, 3))),
                "label": _labels(rng, batch_size, cfg.model.num_classes),
            }

    def data_loader(data_path, batch_size, seed, train):
        # raw JPEG/PNG tree or manifest -> uint8 batches; the /255 scaling
        # happens on the device in the tokenizer
        from metatransformer_tpu_torch.data.image_folder import ImageFolderLoader

        return ImageFolderLoader(
            data_path, batch_size, img_size=img, train=train, seed=seed,
            workers=int(cfg.train.get("data_workers", 4)),
        )

    return Recipe(params, forward, synth, data_loader=data_loader)


def _build_image_moe(cfg, generator, smoke=False, device=None):
    """ImageNet classification over the Switch-MoE encoder variant."""
    _not_ported("the image MoE recipe (_build_image_moe, core/moe_encoder.py)", _ITEM_8)


def build_multimodal(cfg, generator, smoke=False, device=None):
    """Multimodal joint training: the README demo trio (video + audio +
    time-series tokens concatenated into the shared encoder) as a trainable
    recipe."""
    from metatransformer_tpu_torch.models import multimodal_classifier as mm
    from metatransformer_tpu_torch.tokenizers import audio as audio_tok
    from metatransformer_tpu_torch.tokenizers import time_series as ts_tok
    from metatransformer_tpu_torch.tokenizers import video as video_tok

    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    t = cfg.model.get("tokenizer", {})
    c_in = t.get("ts_channels", 7)
    if smoke:
        toks = (
            video_tok.VideoTokenizerConfig(num_frames=4, img_size=32, dim=ecfg.dim),
            audio_tok.AudioTokenizerConfig(num_mel_bins=64, num_frames=64, dim=ecfg.dim),
            ts_tok.TimeSeriesConfig(c_in=c_in, dim=ecfg.dim),
        )
        shapes = {"video": (4, 32, 32, 3), "audio": (64, 64), "time-series": (24, c_in)}
    else:
        toks = (
            video_tok.VideoTokenizerConfig(
                num_frames=t.get("num_frames", 16), img_size=t.get("img_size", 224),
                dim=ecfg.dim,
            ),
            audio_tok.AudioTokenizerConfig(dim=ecfg.dim),
            ts_tok.TimeSeriesConfig(c_in=c_in, dim=ecfg.dim),
        )
        shapes = {
            "video": (t.get("num_frames", 16), t.get("img_size", 224), t.get("img_size", 224), 3),
            "audio": (1024, 128),
            "time-series": (t.get("ts_len", 96), c_in),
        }
    mcfg = mm.MultimodalClassifierConfig(
        tokenizers=toks, encoder=ecfg, num_classes=cfg.model.num_classes
    )
    params = mm.init(mcfg, generator, device)

    def forward(p, x, gen):
        return mm.forward(p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": {
                    m: rng.standard_normal((batch_size,) + s, np.float32)
                    for m, s in shapes.items()
                },
                "label": _labels(rng, batch_size, cfg.model.num_classes),
            }

    return Recipe(params=params, forward=forward, synth=synth)


def build_video(cfg, generator, smoke=False, device=None):
    """Kinetics-400 finetune assembly (Video/run_class_finetuning.py:406)."""
    from metatransformer_tpu_torch.models import video_classifier
    from metatransformer_tpu_torch.tokenizers import video as video_tok

    if cfg.model.get("pretrain", False):
        return _build_video_mae(cfg, generator, smoke, device)
    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    t = cfg.model.tokenizer
    frames = 4 if smoke else t.num_frames
    img = 32 if smoke else t.img_size
    mcfg = video_classifier.VideoClassifierConfig(
        tokenizer=video_tok.VideoTokenizerConfig(
            num_frames=frames, img_size=img, patch_size=t.patch_size,
            tubelet_size=t.tubelet_size, dim=ecfg.dim,
        ),
        encoder=ecfg,
        num_classes=cfg.model.num_classes,
    )
    params = video_classifier.init(mcfg, generator, device)

    def forward(p, x, gen):
        return video_classifier.forward(p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": _f32(rng.standard_normal((batch_size, frames, img, img, 3))),
                "label": _labels(rng, batch_size, cfg.model.num_classes),
            }

    return Recipe(params, forward, synth)


def _build_video_mae(cfg, generator, smoke=False, device=None):
    """VideoMAE tube-masked pretraining (Video/models/modeling_pretrain.py
    + dataset/masking_generator.py; run_mae_pretraining entry). FP32, as the
    reference's loss."""
    from metatransformer_tpu_torch.models import video_pretrain
    from metatransformer_tpu_torch.tokenizers import video as video_tok

    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    t = cfg.model.tokenizer
    frames = 4 if smoke else t.num_frames
    img = 16 if smoke else t.img_size
    patch = 8 if smoke else t.patch_size
    d = cfg.model.get("decoder", {})
    mcfg = video_pretrain.VideoMAEConfig(
        tokenizer=video_tok.VideoTokenizerConfig(
            num_frames=frames, img_size=img, patch_size=patch,
            tubelet_size=t.tubelet_size, dim=ecfg.dim,
        ),
        encoder=ecfg,
        decoder=enc.EncoderConfig(
            dim=16 if smoke else d.get("dim", 384),
            depth=1 if smoke else d.get("depth", 4),
            num_heads=2 if smoke else d.get("num_heads", 6),
        ),
        mask_ratio=0.5 if smoke else cfg.model.get("mask_ratio", 0.9),
    )
    params = video_pretrain.init(mcfg, generator, device)

    def forward(p, x, gen):
        loss, _ = video_pretrain.forward_loss(p, batch_to_device(x, device), gen, mcfg)
        return loss

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": _f32(rng.standard_normal((batch_size, frames, img, img, 3))),
                "label": np.zeros((batch_size,), np.int64),  # unused
            }

    return Recipe(
        params, forward, synth, loss_fn=_identity_loss,
        classification=False, best_mode="min",
    )


def build_tabular(cfg, generator, smoke=False, device=None):
    """Adult/Bank-Marketing TabTransformer assembly
    (Tabular/run_experiments/adult/adult_meta-transformer.py:103-161);
    the synthetic schema mirrors Adult's 9 categorical + 6 continuous
    columns."""
    from metatransformer_tpu_torch.models import tabular_classifier
    from metatransformer_tpu_torch.tokenizers import tabular as tab_tok

    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    m = cfg.model
    if smoke:
        n_cat, vocab, n_cont = 3, 8, 2
    else:
        n_cat = m.get("n_categorical", 9)
        vocab = m.get("vocab_size", 42)
        n_cont = m.get("n_continuous", 6)
    mcfg = tabular_classifier.TabularClassifierConfig(
        tokenizer=tab_tok.TabularTokenizerConfig(
            vocab_sizes=(vocab,) * n_cat, n_continuous=n_cont, dim=ecfg.dim
        ),
        encoder=ecfg,
        num_classes=cfg.model.num_classes,
    )
    params = tabular_classifier.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return tabular_classifier.forward(
            p, x["categorical"], mcfg, continuous=x["continuous"], precision=enc.BF16,
        )

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": {
                    "categorical": rng.integers(0, vocab, (batch_size, n_cat)).astype(np.int32),
                    "continuous": _f32(rng.standard_normal((batch_size, n_cont))),
                },
                "label": _labels(rng, batch_size, cfg.model.num_classes),
            }

    loss_fn = None
    if cfg.train.get("loss") == "focal":
        # the Bank-Marketing focal option (bankm_meta-transformer.py)
        from metatransformer_tpu_torch.train import losses as tr_losses

        def loss_fn(logits, labels):
            return tr_losses.focal(logits, labels)

    return Recipe(params, forward, synth, loss_fn=loss_fn)


def build_hyper(cfg, generator, smoke=False, device=None):
    """Indian Pines band-patch classification
    (Hyper-spectrum/metatransformer.py:111-165 + train.py band patches).
    ``model.mode: caf`` selects the SpectralFormer CAF variant."""
    from metatransformer_tpu_torch.models import hyper_classifier
    from metatransformer_tpu_torch.tokenizers import hyper as hyper_tok

    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    t = cfg.model.get("tokenizer", {})
    patch = 3 if smoke else t.get("patch", 7)
    near_band = t.get("near_band", 3)
    n_tokens = 8 if smoke else t.get("num_tokens", 200)
    mcfg = hyper_classifier.HyperClassifierConfig(
        tokenizer=hyper_tok.HyperTokenizerConfig(
            img_size=patch, near_band=near_band, num_tokens=n_tokens, dim=ecfg.dim,
        ),
        encoder=ecfg,
        num_classes=cfg.model.num_classes,
        mode=cfg.model.get("mode", "vit").lower(),
    )
    params = hyper_classifier.init(mcfg, generator, device)
    patch_dim = mcfg.tokenizer.patch_dim

    def forward(p, x, gen):
        return hyper_classifier.forward(p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": _f32(rng.standard_normal((batch_size, n_tokens, patch_dim))),
                "label": _labels(rng, batch_size, cfg.model.num_classes),
            }

    return Recipe(params, forward, synth)


# ---------------------------------------------------------------------------
# Regression-style modalities
# ---------------------------------------------------------------------------


def _calendar_marks(marks: Optional[torch.Tensor], freq: str) -> Optional[torch.Tensor]:
    """The synthetic marks carry 4 calendar columns (month, day, weekday,
    hour) for every recipe; under ``freq: t`` the tokenizer also reads a
    fifth (minute), which the reference's clamped JAX gather takes from the
    hour column. The port repeats that column explicitly, so both packages
    compute the same function on the same batch (ROADMAP queue 3,
    reference caveats)."""
    if marks is None or freq != "t" or marks.shape[-1] != 4:
        return marks
    return torch.cat([marks, marks[..., 3:]], dim=-1)


def build_time_series(cfg, generator, smoke=False, device=None):
    """Time-series task dispatch (Time-Series/run.py:109-118 +
    models/MetaTransformer.py): long/short-term forecasting (ETT / M4,
    MSE / sMAPE loss), imputation / anomaly detection and UEA-style
    sequence classification."""
    from metatransformer_tpu_torch.models import time_series as ts_model

    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    m = cfg.model
    task = m.get("task", "long_term_forecast")
    seq_len = 8 if smoke else m.seq_len
    if task == "classification":
        return _build_ts_classification(cfg, generator, ecfg, seq_len, smoke, device)
    if task in ("imputation", "anomaly_detection"):
        return _build_ts_reconstruction(cfg, generator, ecfg, seq_len, task, smoke, device)
    pred_len = 4 if smoke else m.pred_len
    label_len = seq_len // 2
    mcfg = ts_model.TimeSeriesModelConfig(
        task=m.get("task", "long_term_forecast"),
        pred_len=pred_len,
        seq_len=seq_len,
        enc_in=m.enc_in,
        dec_in=m.dec_in,
        c_out=m.c_out,
        embed_type=m.get("embed", "fixed"),
        freq=m.get("freq", "h"),
        encoder=ecfg,
        decoder=ts_model.DecoderConfig(
            dim=ecfg.dim,
            d_ff=4 * ecfg.dim if smoke else 2048,
            num_heads=4 if smoke else 8,
            depth=m.get("d_layers", 1),
        ),
    )
    params = ts_model.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return ts_model.forward(
            p, x["x_enc"], mcfg, _calendar_marks(x["x_mark_enc"], mcfg.freq), x["x_dec"],
            _calendar_marks(x["x_mark_dec"], mcfg.freq), precision=enc.BF16,
        )

    if cfg.train.get("loss") == "smape":
        # the M4 metric-as-loss (Time-Series/utils/losses.py smape_loss)
        def loss(pred, label):
            return torch.mean(
                200.0 * (pred - label).abs() / (pred.abs() + label.abs() + 1e-8)
            )
    else:
        def loss(pred, label):
            return torch.mean((pred - label) ** 2)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        c = m.enc_in
        for _ in range(n_batches):
            series = rng.standard_normal((batch_size, seq_len + pred_len, c)).astype(np.float32)
            x_enc = series[:, :seq_len]
            y = series[:, seq_len:]
            # decoder input: label_len of history + zeroed future (the
            # Time-Series-Library convention)
            x_dec = np.concatenate([x_enc[:, -label_len:], np.zeros_like(y)], axis=1)
            marks = rng.integers(0, 4, (batch_size, seq_len + pred_len, 4)).astype(np.int32)
            yield {
                "input": {
                    "x_enc": x_enc,
                    "x_mark_enc": marks[:, :seq_len],
                    "x_dec": x_dec,
                    "x_mark_dec": np.concatenate(
                        [marks[:, seq_len - label_len : seq_len], marks[:, seq_len:]], axis=1
                    ),
                },
                "label": y,
            }

    return Recipe(
        params, forward, synth, loss_fn=loss, classification=False, best_mode="min",
    )


def _build_ts_reconstruction(cfg, generator, ecfg, seq_len, task, smoke, device):
    """Imputation / anomaly detection (Time-Series/exp/{exp_imputation,
    exp_anomaly_detection}.py): per-timestep projection of encoder features
    back to the input channels; imputation scores MSE on the *masked*
    positions only, anomaly detection on the full reconstruction."""
    from metatransformer_tpu_torch.models import time_series as ts_model

    m = cfg.model
    mcfg = ts_model.TimeSeriesModelConfig(
        task=task,
        seq_len=seq_len,
        pred_len=0,
        enc_in=m.enc_in,
        dec_in=m.enc_in,
        c_out=m.enc_in,
        embed_type=m.get("embed", "fixed"),
        freq=m.get("freq", "h"),
        encoder=ecfg,
        decoder=ts_model.DecoderConfig(dim=ecfg.dim, d_ff=4 * ecfg.dim, num_heads=4, depth=1),
    )
    params = ts_model.init(mcfg, generator, device)
    mask_rate = m.get("mask_rate", 0.375)  # TSLib imputation default

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return ts_model.forward(
            p, x["x_enc"], mcfg, _calendar_marks(x.get("x_mark_enc"), mcfg.freq),
            precision=enc.BF16)

    if task == "imputation":
        def loss(recon, label):
            miss = 1.0 - label["observed"]  # [B, T, C], 1 = to impute
            return torch.sum((recon - label["y"]) ** 2 * miss) / torch.clamp(
                torch.sum(miss), min=1.0
            )
    else:
        def loss(recon, label):
            return torch.mean((recon - label["y"]) ** 2)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            y = rng.standard_normal((batch_size, seq_len, m.enc_in)).astype(np.float32)
            marks = rng.integers(0, 4, (batch_size, seq_len, 4)).astype(np.int32)
            if task == "imputation":
                observed = (
                    rng.uniform(size=(batch_size, seq_len, m.enc_in)) > mask_rate
                ).astype(np.float32)
                x_enc = y * observed
            else:
                observed = np.ones_like(y)
                x_enc = y
            yield {
                "input": {"x_enc": x_enc, "x_mark_enc": marks},
                "label": {"y": y, "observed": observed},
            }

    return Recipe(
        params, forward, synth, loss_fn=loss, classification=False, best_mode="min",
    )


def _build_ts_classification(cfg, generator, ecfg, seq_len, smoke, device):
    """UEA sequence classification (Time-Series/exp/exp_classification.py:
    flattened encoder features + GELU -> linear over num_classes)."""
    from metatransformer_tpu_torch.models import time_series as ts_model

    m = cfg.model
    mcfg = ts_model.TimeSeriesModelConfig(
        task="classification",
        seq_len=seq_len,
        pred_len=0,
        enc_in=m.enc_in,
        dec_in=m.enc_in,
        c_out=m.enc_in,
        num_classes=m.num_classes,
        embed_type=m.get("embed", "fixed"),
        freq=m.get("freq", "h"),
        encoder=ecfg,
        decoder=ts_model.DecoderConfig(dim=ecfg.dim, d_ff=4 * ecfg.dim, num_heads=4, depth=1),
    )
    params = ts_model.init(mcfg, generator, device)

    def forward(p, x, gen):
        return ts_model.forward(p, batch_to_device(x, device), mcfg, precision=enc.BF16)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield {
                "input": _f32(rng.standard_normal((batch_size, seq_len, m.enc_in))),
                "label": _labels(rng, batch_size, m.num_classes),
            }

    return Recipe(params, forward, synth)


def build_graph(cfg, generator, smoke=False, device=None):
    """PCQM4Mv2 TokenGT regression (Graph/metatransformer/models/tokengt.py
    + scripts/pcqv2-metatransformer_fixed.sh recipe: heads=32, L1 loss).
    Training draws the Laplacian sign flips from the step's generator;
    evaluation (no generator) runs the tokenizer without them."""
    from metatransformer_tpu_torch.data import graph_collate
    from metatransformer_tpu_torch.models import graph_predictor
    from metatransformer_tpu_torch.tokenizers import graph as graph_tok

    device = _device.resolve(device)
    heads = cfg.model.get("encoder_heads", 32)
    ecfg = _encoder_cfg(cfg, smoke, num_heads=4 if smoke else heads)
    if cfg.model.get("performer", False):
        # the optional FAVOR+ path (tokengt_graph_encoder.py:223-245)
        ecfg = dataclasses.replace(ecfg, attn_impl="performer")
    t = cfg.model.tokenizer
    lap_k = 3 if smoke else t.get("lap_node_id_k", 16)
    mcfg = graph_predictor.GraphPredictorConfig(
        tokenizer=graph_tok.GraphTokenizerConfig(
            num_atoms=64 if smoke else 4608,
            num_edge_types=64 if smoke else 1536,
            dim=ecfg.dim,
            lap_node_id=t.get("lap_node_id", True),
            lap_node_id_k=lap_k,
            lap_node_id_sign_flip=t.get("lap_node_id_sign_flip", True),
            type_id=t.get("type_id", True),
        ),
        encoder=ecfg,
        num_targets=cfg.model.get("num_targets", 1),
    )
    params = graph_predictor.init(mcfg, generator, device)
    max_nodes, max_edges = (4, 4) if smoke else (64, 128)

    def forward(p, x, gen):
        return graph_predictor.forward(
            p, x, mcfg, generator=gen, train=gen is not None, precision=enc.BF16
        )[:, 0]

    def l1(pred, label):
        return torch.mean((pred - label).abs())

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            graphs = []
            for _b in range(batch_size):
                n = int(rng.integers(2, max_nodes + 1))
                e = int(rng.integers(1, max_edges + 1))
                graphs.append({
                    "node_data": rng.integers(1, 30, (n, 1)).astype(np.int32),
                    "edge_index": rng.integers(0, n, (e, 2)).astype(np.int32),
                    "edge_data": rng.integers(1, 30, (e, 1)).astype(np.int32),
                })
            yield {
                "input": graph_collate.collate(graphs, max_nodes, max_edges, lap_k=lap_k),
                "label": rng.standard_normal(batch_size).astype(np.float32),
            }

    return Recipe(
        params, forward, synth, loss_fn=l1, classification=False, best_mode="min",
    )


# ---------------------------------------------------------------------------
# Dense-prediction image tasks (loss computed inside forward)
# ---------------------------------------------------------------------------


def _adapter_cfg(cfg, smoke: bool):
    from metatransformer_tpu_torch.models import vit_adapter

    b = cfg.model.backbone
    if smoke:
        return vit_adapter.ViTAdapterConfig(
            encoder=enc.EncoderConfig(dim=32, depth=2, num_heads=4),
            img_size=64,
            patch_size=16,
            conv_inplane=8,
            deform_num_heads=4,
            interaction_indexes=((0, 0), (1, 1)),
        )
    return vit_adapter.ViTAdapterConfig(
        encoder=_encoder_cfg(cfg, False),
        img_size=b.img_size,
        patch_size=b.patch_size,
        deform_num_heads=b.deform_num_heads,
        interaction_indexes=tuple(tuple(p) for p in b.interaction_indexes),
    )


def build_segmentation(cfg, generator, smoke=False, device=None):
    """ADE20K UperNet over ViT-Adapter (``Image/segmentation/train.py:100-207``
    + the ade20k config). The parameters are ``{"backbone", "head"}``: the
    CLI freezes and layer-decays only a top-level ``"encoder"``, so the whole
    model trains at one rate, as in the reference."""
    from metatransformer_tpu_torch.models import segmentor

    device = _device.resolve(device)
    bcfg = _adapter_cfg(cfg, smoke)
    mcfg = segmentor.SegmentorConfig(backbone=bcfg, num_classes=cfg.model.num_classes)
    params = segmentor.init(mcfg, generator, device)
    img = bcfg.img_size

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        logits = segmentor.forward(p, x["image"], mcfg, precision=enc.BF16)
        return segmentor.seg_loss(logits, x["seg_label"])

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            labels = rng.integers(0, cfg.model.num_classes, (batch_size, img, img))
            labels[:, :4] = 255  # ignore region
            yield {
                "input": {
                    "image": _f32(rng.standard_normal((batch_size, img, img, 3))),
                    "seg_label": labels.astype(np.int32),
                },
            }

    return Recipe(
        params, forward, synth, loss_fn=_identity_loss, classification=False,
        best_mode="min",
    )


def build_point_seg(cfg, generator, smoke=False, device=None):
    """Point-cloud semantic / part segmentation (S3DIS 13-class rooms,
    ShapeNetPart 50 parts; ``PointCloud/examples/segmentation`` +
    ``openpoints/models/segmentation/base_seg.py:15``): the shared-encoder
    seg path with 3-NN feature propagation back to every point."""
    from metatransformer_tpu_torch.models import point_segmenter
    from metatransformer_tpu_torch.tokenizers import point as point_tok
    from metatransformer_tpu_torch.utils import seg_eval

    m = cfg.model
    if m.get("NAME") == "PointTransformerSeg":
        return _build_point_transformer_seg(cfg, generator, smoke, device)
    if m.get("NAME") in ("RandLANet", "BAAFNet", "StratifiedTransformer"):
        return _build_seg_baseline(cfg, generator, smoke, device)
    device = _device.resolve(device)
    ecfg = _encoder_cfg(cfg, smoke)
    t = m.get("tokenizer", {})
    in_channels = t.get("in_channels", 3)
    n_points = 64 if smoke else cfg.train.get("num_points", 2048)
    mcfg = point_segmenter.PointSegmenterConfig(
        tokenizer=point_tok.PointTokenizerConfig(
            sample_ratio=t.get("sample_ratio", 0.25),
            group_size=8 if smoke else t.get("group_size", 32),
            in_channels=in_channels,
            embed_dim=ecfg.dim,
            feature_type=t.get("feature_type", "dp_fj"),
        ),
        encoder=ecfg,
        num_classes=m.num_classes,
        head_hidden=32 if smoke else 256,
    )
    params = point_segmenter.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return point_segmenter.forward(
            p, x["points"], mcfg, features=x.get("features"), precision=enc.BF16,
        )

    def seg_ce(logits, labels):
        # softmax cross-entropy over the class axis, mean over every point
        return F.cross_entropy(logits.movedim(-1, 1), labels.long())

    shapenetpart = m.get("dataset") == "shapenetpart"

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            pts = rng.standard_normal((batch_size, n_points, 3)).astype(np.float32)
            batch = {"points": pts}
            if in_channels > 3:
                batch["features"] = rng.standard_normal(
                    (batch_size, n_points, in_channels)
                ).astype(np.float32)
            out = {"input": batch}
            if shapenetpart:
                # labels drawn within each shape's category parts, so the
                # ins-mIoU protocol sees realistic label structure
                cls = rng.integers(0, 16, batch_size)
                labels = np.stack([
                    rng.choice(seg_eval.SHAPENETPART_CLS2PARTS[c], n_points) for c in cls
                ])
                out["label"] = labels.astype(np.int64)
                out["cls"] = cls.astype(np.int64)
            else:
                out["label"] = rng.integers(0, m.num_classes, (batch_size, n_points)).astype(
                    np.int64)
            yield out

    eval_metric = None
    if shapenetpart:
        # ShapeNetPart --eval protocol: per-shape instance mIoU + per-
        # category mIoU (PointCloud/examples/shapenetpart/main.py:67-96).
        def eval_metric(params, fwd, batches):
            ious, cats = [], []
            # the reference's PRNGKey(0)
            gen = torch.Generator(device=device).manual_seed(0)
            with torch.no_grad():
                for batch in batches:
                    logits = fwd(params, batch["input"], gen)
                    preds = logits.argmax(-1).cpu().numpy()
                    cls = np.asarray(batch["cls"])
                    ious.append(seg_eval.instance_mious(preds, np.asarray(batch["label"]), cls))
                    cats.append(cls)
            agg = seg_eval.aggregate_part_mious(np.concatenate(ious), np.concatenate(cats))
            return {"ins_miou": 100.0 * agg["ins_miou"], "cls_miou": 100.0 * agg["cls_miou"]}

    return Recipe(
        params, forward, synth, loss_fn=seg_ce, classification=False,
        best_mode="min", eval_metric=eval_metric,
    )


def _build_seg_baseline(cfg, generator, smoke=False, device=None):
    """RandLA-Net / BAAF-Net / Stratified Transformer segmentation
    baselines."""
    _not_ported(f"the {cfg.model.NAME} segmentation recipe (_build_seg_baseline)", _ITEM_9)


def _build_point_transformer_seg(cfg, generator, smoke=False, device=None):
    """PointTransformer vector-attention segmentation baseline."""
    _not_ported("the PointTransformerSeg recipe (_build_point_transformer_seg)", _ITEM_9)


def build_mask2former(cfg, generator, smoke=False, device=None):
    """ADE20K / COCO Mask2Former (mask2former_head.py + the msdeformattn pixel
    decoder) over ViT-Adapter; each layer's Hungarian matching runs on the
    host. The random points come from the step's generator (a generator
    seeded 0 where the caller passes none, as the reference's key)."""
    from metatransformer_tpu_torch.heads import mask2former as m2f
    from metatransformer_tpu_torch.models import segmentor, vit_adapter

    device = _device.resolve(device)
    bcfg = _adapter_cfg(cfg, smoke)
    m = cfg.model
    if smoke:
        mcfg = segmentor.Mask2FormerSegmentorConfig(
            backbone=bcfg, num_classes=m.num_classes, head_channels=32, num_queries=8,
            num_decoder_layers=1, num_encoder_layers=1, num_heads=4,
        )
        num_points = 64
    else:
        mcfg = segmentor.Mask2FormerSegmentorConfig(
            backbone=bcfg, num_classes=m.num_classes, head_channels=m.head_channels,
            num_queries=m.num_queries, num_decoder_layers=m.num_decoder_layers,
            num_encoder_layers=m.num_encoder_layers, num_heads=m.num_heads,
        )
        num_points = cfg.train.get("num_points", 12544)
    params = segmentor.init_mask2former(mcfg, generator, device)
    img = bcfg.img_size
    hcfg = mcfg.head

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        feats = vit_adapter.apply(p["backbone"], x["image"], bcfg, enc.BF16)
        all_cls, all_masks = m2f.apply(p["head"], feats, hcfg, enc.BF16.mm)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        loss, _logs = m2f.loss(all_cls, all_masks, x["gt_labels"], x["gt_masks"],
                               x["gt_valid"], hcfg, gen, num_points=num_points)
        return loss

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        g, mh, mw = 3, img // 4, img // 4
        for _ in range(n_batches):
            masks = np.zeros((batch_size, g, mh, mw), np.float32)
            for b in range(batch_size):
                for gi in range(g):
                    y0, x0 = rng.integers(0, mh // 2, 2)
                    masks[b, gi, y0: y0 + mh // 2, x0: x0 + mw // 2] = 1.0
            yield {
                "input": {
                    "image": _f32(rng.standard_normal((batch_size, img, img, 3))),
                    "gt_labels": rng.integers(0, m.num_classes, (batch_size, g)).astype(np.int32),
                    "gt_masks": masks,
                    "gt_valid": np.ones((batch_size, g), bool),
                },
            }

    return Recipe(
        params, forward, synth, loss_fn=_identity_loss, classification=False,
        best_mode="min",
    )


def build_htc(cfg, generator, smoke=False, device=None):
    """COCO HTC++."""
    _not_ported("the HTC++ recipe (build_htc, models/htc.py)", _ITEM_9)


def build_detection2d(cfg, generator, smoke=False, device=None):
    """COCO Mask / Cascade R-CNN over ViT-Adapter FPN."""
    _not_ported("the 2D detection recipe (build_detection2d, models/mask_rcnn.py)", _ITEM_9)


def build_pointpillars(cfg, generator, smoke=False, device=None):
    """KITTI PointPillars."""
    _not_ported("the PointPillars recipe (build_pointpillars, models/detector3d.py)", _ITEM_9)


def _det3d_not_ported(name: str) -> Callable:
    def build_det3d(cfg, generator, smoke=False, device=None):
        _not_ported(f"the {name} 3D detection recipe", _ITEM_9)

    build_det3d.__name__ = f"build_{name.lower()}"
    return build_det3d


# ---------------------------------------------------------------------------
# Point clouds and audio
# ---------------------------------------------------------------------------


def _point_builder(cfg, generator, smoke=False, device=None):
    # lives in train_cli, as in the reference; imported here at call time
    from metatransformer_tpu_torch import train_cli

    if smoke:
        cfg = _smoked(cfg)
    params, forward, synth = train_cli.build_point(cfg, generator, device)
    return Recipe(params, forward, synth)


def _point_dispatch(cfg, generator, smoke=False, device=None):
    """MetaTransformer (default) vs baseline-zoo NAME dispatch."""
    if cfg.model.get("NAME") == "MaskedPointViT":
        return _build_point_mae(cfg, generator, smoke, device)
    if cfg.model.get("NAME") not in (None, "MetaTransformer", "BaseCls"):
        return build_point_baseline(cfg, generator, smoke, device)
    return _point_builder(cfg, generator, smoke, device)


def _build_point_mae(cfg, generator, smoke=False, device=None):
    """MAE-style point pretraining (openpoints/models/reconstruction/
    maskedpointvit.py; examples/reconstruction launcher surface). FP32, as
    the reference's loss."""
    from metatransformer_tpu_torch.models import point_mae

    device = _device.resolve(device)
    m = cfg.model
    if smoke:
        mcfg = point_mae.MaskedPointViTConfig(
            dim=16, depth=1, num_heads=2, decoder_dim=8, decoder_depth=1,
            decoder_heads=2, mask_ratio=0.5, sample_ratio=0.125, group_size=8,
        )
        n_pts = 64
    else:
        mcfg = point_mae.MaskedPointViTConfig(
            dim=m.get("dim", 384), depth=m.get("depth", 12),
            num_heads=m.get("num_heads", 6),
            decoder_dim=m.get("decoder_dim", 192),
            decoder_depth=m.get("decoder_depth", 4),
            decoder_heads=m.get("decoder_heads", 16),
            mask_ratio=m.get("mask_ratio", 0.75),
            sample_ratio=m.get("sample_ratio", 0.0625),
            group_size=m.get("group_size", 32),
        )
        n_pts = cfg.train.get("num_points", 1024)
    params = point_mae.init(mcfg, generator, device)

    def forward(p, x, gen):
        loss, _ = point_mae.forward(p, batch_to_device(x, device), gen, mcfg)
        return loss

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            pts = rng.standard_normal((batch_size, n_pts, 3))
            yield {
                "input": _f32(pts * 0.5),
                "label": np.zeros((batch_size,), np.int64),  # unused
            }

    return Recipe(
        params, forward, synth, loss_fn=_identity_loss,
        classification=False, best_mode="min",
    )


def build_point_baseline(cfg, generator, smoke=False, device=None):
    """Baseline-zoo classification recipes (cfg.model.NAME selects a
    registry backbone)."""
    _not_ported(f"the {cfg.model.NAME} point classification recipe (build_point_baseline)",
                _ITEM_9)


def _audio_builder(cfg, generator, smoke=False, device=None):
    from metatransformer_tpu_torch import train_cli

    if smoke:
        cfg = _smoked(cfg)
    params, forward, synth = train_cli.build_audio(cfg, generator, device)
    return Recipe(params, forward, synth)


def _smoked(cfg):
    from metatransformer_tpu_torch.configs.config import Config

    cfg = Config.wrap(cfg.to_dict())
    cfg.encoder.scale = "tiny"
    return cfg


# ---------------------------------------------------------------------------
# Registry + dispatch
# ---------------------------------------------------------------------------

DET3D_BUILDERS = {
    name: _det3d_not_ported(name)
    for name in ("SECONDNet", "CenterPoint", "CenterPointNusc", "VoxelRCNN", "PVRCNN",
                 "PVRCNNPP", "PartA2", "SECONDIoU", "PointRCNN", "IASSD", "CaDDN",
                 "MDFSECONDNet")
}


def build(cfg, generator: torch.Generator, smoke: bool = False,
          device: _device.Device = None) -> Recipe:
    """Dispatch on (task, modality, model NAME), as the reference's
    ``recipes.build``; the parameters land on ``device`` (None: the card)."""
    task = cfg.get("task")
    if task == "detection3d":
        name = cfg.model.get("NAME")
        if name is None:
            return build_pointpillars(cfg, generator, smoke, device)
        if name not in DET3D_BUILDERS:
            raise SystemExit(f"unknown 3D detector NAME {name!r}")
        return DET3D_BUILDERS[name](cfg, generator, smoke, device)
    if task == "segmentation":
        if cfg.get("modality") in ("point", "pointcloud"):
            return build_point_seg(cfg, generator, smoke, device)
        if cfg.model.get("NAME") == "Mask2FormerSegmentor":
            return build_mask2former(cfg, generator, smoke, device)
        return build_segmentation(cfg, generator, smoke, device)
    if task == "detection2d":
        if cfg.model.get("NAME") == "HTC":
            return build_htc(cfg, generator, smoke, device)
        return build_detection2d(cfg, generator, smoke, device)
    modality = cfg.modality
    builders = {
        "image": build_image,
        "xray": build_image,
        "infrared": build_image,
        "video": build_video,
        "time-series": build_time_series,
        "graph": build_graph,
        "tabular": build_tabular,
        "hyper": build_hyper,
        "point": _point_dispatch,
        "pointcloud": _point_dispatch,
        "audio": _audio_builder,
        "multimodal": build_multimodal,
    }
    if modality not in builders:
        raise SystemExit(f"no recipe builder for modality {modality!r}")
    return builders[modality](cfg, generator, smoke, device)
