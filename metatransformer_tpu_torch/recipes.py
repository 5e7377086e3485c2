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


def _seg_ce(logits, labels):
    """Softmax cross-entropy over the class axis, mean over every point."""
    return F.cross_entropy(logits.movedim(-1, 1), labels.long())


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
        params, forward, synth, loss_fn=_seg_ce, classification=False,
        best_mode="min", eval_metric=eval_metric,
    )


def _point_seg_synth(n_points: int, num_classes: int, in_channels: int = 3):
    """Standard-normal clouds [B, N, 3] (and features where the model
    takes more than the coordinates) with uniform labels, the reference's
    draws."""
    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            batch = {"points": rng.standard_normal((batch_size, n_points, 3)).astype(np.float32)}
            if in_channels > 3:
                batch["features"] = rng.standard_normal(
                    (batch_size, n_points, in_channels)).astype(np.float32)
            yield {"input": batch,
                   "label": rng.integers(0, num_classes, (batch_size, n_points)).astype(np.int64)}

    return synth


def seg_baseline_config(cfg, smoke: bool = False):
    """(model config, points a cloud) of a RandLA-Net / BAAF-Net /
    Stratified Transformer YAML, the reference's smoke geometry where
    ``smoke``."""
    from metatransformer_tpu_torch.utils.registry import MODELS

    m = cfg.model
    name, ncls = m.NAME, m.num_classes
    if smoke:
        from metatransformer_tpu_torch.models import baafnet, randlanet, stratified_transformer

        if name == "RandLANet":
            mcfg = randlanet.RandLANetConfig(num_classes=ncls, d_in=3, num_neighbors=8,
                                             enc_dims=(8, 16), head_dims=(16,))
        elif name == "StratifiedTransformer":
            mcfg = stratified_transformer.StratifiedConfig(
                num_classes=ncls, in_channels=3, channels=(8, 8, 16), depths=(1, 1, 2),
                num_heads=(1, 2, 2), k=8, n_kernel_pts=5)
        else:
            mcfg = baafnet.BAAFNetConfig(num_classes=ncls, d_in=3, k=8, dims=(4, 8, 16))
        return mcfg, 64
    mod = MODELS.get(name)
    if name == "StratifiedTransformer":
        mcfg = mod.Config(num_classes=ncls, in_channels=m.get("d_in", 3))
    else:
        mcfg = mod.Config(num_classes=ncls, d_in=m.get("d_in", 3))
    return mcfg, cfg.train.get("num_points", 4096)


def _build_seg_baseline(cfg, generator, smoke=False, device=None):
    """RandLA-Net / BAAF-Net / Stratified Transformer segmentation
    baselines (openpoints ``randlenet.py`` / ``baafnet.py`` /
    ``Stratified_transformer.py``), looked up in the model registry."""
    from metatransformer_tpu_torch.utils.registry import MODELS

    device = _device.resolve(device)
    mod = MODELS.get(cfg.model.NAME)
    mcfg, n_points = seg_baseline_config(cfg, smoke)
    params = mod.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return mod.forward(p, x["points"], mcfg, features=x.get("features"))

    return Recipe(params, forward, _point_seg_synth(n_points, cfg.model.num_classes),
                  loss_fn=_seg_ce, classification=False, best_mode="min")


def point_transformer_seg_config(cfg, smoke: bool = False):
    """(model config, points a cloud) of a PointTransformerSeg YAML."""
    from metatransformer_tpu_torch.models import point_transformer_seg as pts

    m = cfg.model
    if smoke:
        return pts.PointTransformerSegConfig(
            num_classes=m.num_classes, in_channels=3, width=8, blocks=(2, 2, 2),
            strides=(1, 4, 4), nsample=(8, 8, 8), share_planes=4), 64
    return pts.PointTransformerSegConfig(
        num_classes=m.num_classes, in_channels=m.get("tokenizer", {}).get("in_channels", 3),
        width=m.get("width", 32)), cfg.train.get("num_points", 2048)


def _build_point_transformer_seg(cfg, generator, smoke=False, device=None):
    """PointTransformer vector-attention segmentation baseline (openpoints
    ``pointtransformer.py`` PTSeg, the S3DIS launcher surface)."""
    from metatransformer_tpu_torch.utils.registry import MODELS

    device = _device.resolve(device)
    mod = MODELS.get("PointTransformerSeg")
    mcfg, n_points = point_transformer_seg_config(cfg, smoke)
    params = mod.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return mod.forward(p, x["points"], mcfg, features=x.get("features"))

    return Recipe(params, forward,
                  _point_seg_synth(n_points, cfg.model.num_classes, mcfg.in_channels),
                  loss_fn=_seg_ce, classification=False, best_mode="min")


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


def _detection_synth(img: int, num_classes: int, semantic_classes: Optional[int] = None):
    """The reference's synthetic COCO batches: 2 boxes an image with
    their box masks (and, for HTC, semantic labels inside the boxes, 255
    elsewhere), in the reference's draw order."""

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        g = 2
        for _ in range(n_batches):
            x0y0 = rng.uniform(0, img // 2, (batch_size, g, 2))
            wh = rng.uniform(img // 8, img // 2, (batch_size, g, 2))
            boxes = np.concatenate([x0y0, np.minimum(x0y0 + wh, img - 1)], axis=-1).astype(
                np.float32)
            masks = np.zeros((batch_size, g, img, img), np.float32)
            sem = np.full((batch_size, img, img), 255, np.int32)
            for b in range(batch_size):
                for gi in range(g):
                    x0, y0, x1, y1 = boxes[b, gi].astype(int)
                    masks[b, gi, y0:y1, x0:x1] = 1.0
                    if semantic_classes is not None:
                        sem[b, y0:y1, x0:x1] = (gi + 1) % semantic_classes
            batch = {
                "image": _f32(rng.standard_normal((batch_size, img, img, 3))),
                "gt_boxes": boxes,
                "gt_labels": rng.integers(0, num_classes, (batch_size, g)).astype(np.int32),
                "gt_valid": np.ones((batch_size, g), bool),
                "gt_masks": masks,
            }
            if semantic_classes is not None:
                batch["semantic_labels"] = sem
            yield {"input": batch}

    return synth


def htc_config(cfg, smoke: bool = False):
    """The HTCConfig of a COCO HTC++ YAML: its published geometry, or the
    smoke one."""
    from metatransformer_tpu_torch.heads import detection2d as d2
    from metatransformer_tpu_torch.models import htc

    bcfg = _adapter_cfg(cfg, smoke)
    if smoke:
        return htc.HTCConfig(
            backbone=bcfg,
            fpn=d2.FPNConfig(in_channels=(32,) * 4, out_channels=32),
            rpn=d2.RPNConfig(channels=32, nms_pre=64, max_proposals=8),
            rcnn=d2.RCNNConfig(num_classes=5, channels=32, fc_dim=64, num_stages=3,
                               with_mask=True, mask_size=7),
            img_size=bcfg.img_size, semantic_classes=12, semantic_convs=2,
        )
    d = bcfg.encoder.dim
    return htc.HTCConfig(
        backbone=bcfg,
        fpn=d2.FPNConfig(in_channels=(d,) * 4),
        rcnn=d2.RCNNConfig(num_classes=cfg.model.rcnn.get("num_classes", 80), num_stages=3,
                           with_mask=True),
        img_size=bcfg.img_size,
        semantic_classes=cfg.model.get("semantic_classes", 183),
    )


def build_htc(cfg, generator, smoke=False, device=None):
    """COCO HTC++ (interleaved cascade + mask info flow + semantic branch,
    ``Image/detection/configs/htc++/``). The parameters are
    ``{"backbone", "fpn", "rpn", "rcnn", "mask_stages", "sem_*"}``: the CLI
    freezes and layer-decays only a top-level ``"encoder"``, so the whole
    model trains at one rate, as in the reference."""
    from metatransformer_tpu_torch.models import htc

    device = _device.resolve(device)
    mcfg = htc_config(cfg, smoke)
    params = htc.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return htc.forward_train(
            p, x["image"], x["gt_boxes"], x["gt_labels"], x["gt_valid"], mcfg,
            gt_masks=x["gt_masks"], semantic_labels=x["semantic_labels"], precision=enc.BF16,
        )[0]

    synth = _detection_synth(mcfg.img_size, mcfg.rcnn.num_classes, mcfg.semantic_classes)
    return Recipe(
        params, forward, synth, loss_fn=_identity_loss, classification=False, best_mode="min",
    )


def detection2d_config(cfg, smoke: bool = False):
    """The MaskRCNNConfig of a COCO Mask / Cascade / upgraded Mask R-CNN
    YAML: its published geometry, or the smoke one."""
    from metatransformer_tpu_torch.heads import detection2d as d2
    from metatransformer_tpu_torch.models import mask_rcnn

    r = cfg.model.rcnn
    rcnn = dict(num_stages=r.get("num_stages", 1),
                stage_ious=tuple(r.get("stage_ious", (0.5, 0.6, 0.7))),
                with_mask=r.get("with_mask", True), bbox_head=r.get("bbox_head", "2fc"))
    bcfg = _adapter_cfg(cfg, smoke)
    if smoke:
        return mask_rcnn.MaskRCNNConfig(
            backbone=bcfg,
            fpn=d2.FPNConfig(in_channels=(32,) * 4, out_channels=32),
            rpn=d2.RPNConfig(channels=32, nms_pre=64, max_proposals=16),
            rcnn=d2.RCNNConfig(num_classes=5, channels=32, fc_dim=64, mask_size=7, **rcnn),
            img_size=bcfg.img_size,
        )
    d = bcfg.encoder.dim
    return mask_rcnn.MaskRCNNConfig(
        backbone=bcfg,
        fpn=d2.FPNConfig(in_channels=(d,) * 4),
        rpn=d2.RPNConfig(),
        rcnn=d2.RCNNConfig(num_classes=r.get("num_classes", 80), **rcnn),
        img_size=bcfg.img_size,
    )


def build_detection2d(cfg, generator, smoke=False, device=None):
    """COCO Mask / Cascade R-CNN over the ViT-Adapter FPN
    (``Image/detection/configs/{mask_rcnn,cascade_rcnn,upgraded_mask_rcnn}/``),
    with large-scale jitter in ``forward`` where ``train.lsj`` is set, its
    scale drawn from the step's generator (one seeded 0 where the caller
    passes none). As in the reference, LSJ scales the boxes and leaves
    ``gt_masks`` as they are. The whole model trains at one rate (see
    :func:`build_htc`)."""
    from metatransformer_tpu_torch.models import mask_rcnn
    from metatransformer_tpu_torch.train import augment

    device = _device.resolve(device)
    mcfg = detection2d_config(cfg, smoke)
    params = mask_rcnn.init(mcfg, generator, device)
    use_lsj = cfg.train.get("lsj", False)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        image, gt_boxes = x["image"], x["gt_boxes"]
        if use_lsj:
            if gen is None:  # the reference's key where the caller passes none
                gen = torch.Generator(device=device).manual_seed(0)
            image, gt_boxes, _ = augment.large_scale_jitter(gen, image, gt_boxes)
        return mask_rcnn.forward_train(
            p, image, gt_boxes, x["gt_labels"], x["gt_valid"], mcfg,
            gt_masks=x["gt_masks"] if mcfg.rcnn.with_mask else None, precision=enc.BF16,
        )[0]

    synth = _detection_synth(mcfg.img_size, mcfg.rcnn.num_classes)
    return Recipe(
        params, forward, synth, loss_fn=_identity_loss, classification=False, best_mode="min",
    )


# ---------------------------------------------------------------------------
# 3D detection (the KITTI detector zoo: AutonomousDriving/pcdet)
# ---------------------------------------------------------------------------

# The tiny but complete KITTI-like geometry every smoke detector shares
_SMOKE_RANGE = (0.0, -3.2, -3.0, 6.4, 3.2, 2.0)


def _smoke_second_cfg(num_classes=1):
    from metatransformer_tpu_torch.models import second

    return second.SECONDConfig(
        voxel_size=(0.1, 0.1, 0.2), pc_range=_SMOKE_RANGE, spatial_shape=(25, 64, 64),
        max_voxels=256, widths=(4, 4, 8, 8, 8, 8), bev_channels=(8, 16), up_channels=8,
        num_classes=num_classes,
    )


def _full_second_cfg(m, num_classes=None):
    from metatransformer_tpu_torch.models import second

    return second.SECONDConfig(
        voxel_size=tuple(m.get("voxel_size", (0.05, 0.05, 0.1))),
        pc_range=tuple(m.get("pc_range", (0.0, -40.0, -3.0, 70.4, 40.0, 1.0))),
        spatial_shape=tuple(m.get("spatial_shape", (41, 1600, 1408))),
        max_voxels=m.get("max_voxels", 16000),
        num_classes=num_classes or m.get("num_classes", 1),
    )


def _det3d_synth(pc_range, num_classes, n_points):
    """Points uniform in the range and two car-sized ground truths near the
    middle, the second one padding, in the reference's draw order."""
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    span = hi - lo

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            pts = (lo + rng.uniform(0, 1, (batch_size, n_points, 3)) * span).astype(np.float32)
            inten = rng.uniform(0, 1, (batch_size, n_points, 1)).astype(np.float32)
            ctr = (lo + span * rng.uniform(0.3, 0.7, (batch_size, 2, 3))).astype(np.float32)
            size = np.broadcast_to(np.asarray([min(3.2, span[0] / 2), 1.6, 1.5], np.float32),
                                   ctr.shape)
            yaw = rng.uniform(-0.4, 0.4, (batch_size, 2, 1)).astype(np.float32)
            yield {"input": {
                "points": np.concatenate([pts, inten], -1),
                "gt_boxes": np.concatenate([ctr, size, yaw], -1),
                "gt_labels": rng.integers(1, max(num_classes, 1) + 1, (batch_size, 2)).astype(
                    np.int32),
                "gt_valid": np.stack([np.ones(batch_size, bool), np.zeros(batch_size, bool)], 1),
            }}

    return synth


def _det3d_recipe(params, forward, pc_range, num_classes, smoke):
    return Recipe(params, forward, _det3d_synth(pc_range, num_classes, 128 if smoke else 1024),
                  loss_fn=_identity_loss, classification=False, best_mode="min")


def pointpillars_config(cfg, smoke: bool = False):
    """The Detector3DConfig of a KITTI PointPillars YAML: its published
    geometry, or the smoke one."""
    from metatransformer_tpu_torch.models import detector3d
    from metatransformer_tpu_torch.ops import voxelize

    m = cfg.model
    a = m.anchors
    acfg = detector3d.AnchorConfig(
        sizes=tuple(tuple(s) for s in a.sizes), rotations=tuple(a.rotations),
        z_centers=tuple(a.z_centers), matched_thrs=tuple(a.matched_thrs),
        unmatched_thrs=tuple(a.unmatched_thrs),
    )
    if smoke:
        vcfg = voxelize.VoxelConfig(pc_range=_SMOKE_RANGE, voxel_size=(0.4, 0.4, 5.0))
        return detector3d.Detector3DConfig(
            vfe=voxelize.PillarVFEConfig(voxel=vcfg, channels=8), bev_channels=(8, 16),
            bev_strides=(2, 2), up_channels=8, anchors=acfg, num_classes=m.num_classes,
        )
    vcfg = voxelize.VoxelConfig(pc_range=tuple(m.voxel.pc_range),
                                voxel_size=tuple(m.voxel.voxel_size))
    return detector3d.Detector3DConfig(
        vfe=voxelize.PillarVFEConfig(voxel=vcfg, channels=m.vfe_channels),
        bev_channels=tuple(m.bev_channels), anchors=acfg, num_classes=m.num_classes,
    )


def build_pointpillars(cfg, generator, smoke=False, device=None):
    """KITTI PointPillars (pcdet pointpillar.yaml; the dense BEV path)."""
    from metatransformer_tpu_torch.models import detector3d

    device = _device.resolve(device)
    mcfg = pointpillars_config(cfg, smoke)
    params = detector3d.init(mcfg, generator, device)
    anchors = torch.as_tensor(detector3d.generate_anchors(mcfg), device=device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        preds = detector3d.forward(p, x["points"], mcfg)
        return detector3d.detection_loss(preds, anchors, x["gt_boxes"], x["gt_valid"], mcfg,
                                         gt_labels=x["gt_labels"])[0]

    return _det3d_recipe(params, forward, mcfg.vfe.voxel.pc_range, cfg.model.num_classes, smoke)


def second_config(cfg, smoke: bool = False):
    """The SECONDConfig of a KITTI SECOND YAML (or the smoke one)."""
    m = cfg.model
    return _smoke_second_cfg(m.get("num_classes", 1)) if smoke else _full_second_cfg(m)


def build_second(cfg, generator, smoke=False, device=None):
    """KITTI SECOND (the sparse voxel backbone and the anchor head)."""
    from metatransformer_tpu_torch.models import second

    device = _device.resolve(device)
    scfg = second_config(cfg, smoke)
    params = second.init(scfg, generator, device)
    anchors = torch.as_tensor(second.generate_anchors(scfg), device=device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        preds = second.forward(p, x["points"], scfg)
        return second.detection_loss(preds, anchors, x["gt_boxes"], x["gt_valid"], scfg)[0]

    return _det3d_recipe(params, forward, scfg.pc_range, scfg.num_classes, smoke)


def centerpoint_config(cfg, smoke: bool = False):
    """The CenterPoint config of a KITTI / Waymo (``CenterPoint``) or
    nuScenes (``CenterPointNusc``: class-group heads and velocity) YAML, the
    reference's smoke geometry where ``smoke``."""
    from metatransformer_tpu_torch.models import centerpoint as cp

    m = cfg.model
    nusc = m.NAME == "CenterPointNusc"
    extra: Dict[str, Any] = {}
    if nusc:
        extra = dict(class_groups=tuple(tuple(g) for g in m.class_groups), velocity=True,
                     code_weights=tuple(m.code_weights), loc_weight=m.get("loc_weight", 0.25))
    if smoke:
        return dataclasses.replace(
            cp.CenterPointConfig(), spatial_shape=(25, 64, 64), pc_range=_SMOKE_RANGE,
            voxel_size=(0.1, 0.1, 0.2), max_voxels=256, widths=(4, 4, 8, 8, 8, 8),
            bev_channels=(8, 16), up_channels=8, bev_layer_num=2, shared_ch=8,
            post_center_range=(-10, -10, -10, 10, 10, 10),
            num_classes=m.num_classes if nusc else m.get("num_classes", 3), **extra)
    if nusc:
        extra.update(velocity=bool(m.get("velocity", True)),
                     score_thresh=m.get("score_thresh", 0.1), nms_thresh=m.get("nms_thresh", 0.2),
                     post_center_range=tuple(m.post_center_range))
    return dataclasses.replace(
        cp.CenterPointConfig(), voxel_size=tuple(m.voxel_size), pc_range=tuple(m.pc_range),
        spatial_shape=tuple(m.spatial_shape), max_voxels=m.max_voxels,
        point_features=m.get("point_features", 4), num_classes=m.num_classes,
        feature_map_stride=m.get("feature_map_stride", 8), max_objs=m.get("max_objs", 500),
        gaussian_overlap=m.get("gaussian_overlap", 0.1), min_radius=m.get("min_radius", 2),
        **extra)


def _padded_columns(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero columns appended up to ``n`` on its last axis."""
    if x.shape[-1] >= n:
        return x
    return torch.cat([x, x.new_zeros(*x.shape[:-1], n - x.shape[-1])], -1)


def build_centerpoint(cfg, generator, smoke=False, device=None):
    """CenterPoint (the residual sparse backbone and the centre head): KITTI
    and Waymo (``CenterPoint``), nuScenes (``CenterPointNusc``: its
    synthetic labels shifted to 0-based and its boxes given zero velocity,
    as the reference's)."""
    from metatransformer_tpu_torch.models import centerpoint as cp

    device = _device.resolve(device)
    mcfg = centerpoint_config(cfg, smoke)
    nusc = cfg.model.NAME == "CenterPointNusc"
    params = cp.init(mcfg, generator, device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        # the synthetic points are (x, y, z, intensity): the rest are zeros
        pts = _padded_columns(x["points"], mcfg.point_features)
        gt, labels = x["gt_boxes"], x["gt_labels"]
        if nusc:
            gt = _padded_columns(gt, 9) if mcfg.velocity else gt
            labels = torch.clamp(labels - 1, 0, mcfg.num_classes - 1)
        return cp.detection_loss(cp.forward(p, pts, mcfg), gt, labels, x["gt_valid"], mcfg)[0]

    return _det3d_recipe(params, forward, mcfg.pc_range, mcfg.num_classes, smoke)


# the two-stage detectors over a SECOND stage 1
_TWO_STAGE_CONFIGS = {"voxel_rcnn": "VoxelRCNNConfig", "pv_rcnn": "PVRCNNConfig",
                      "pv_rcnn_pp": "PVRCNNPPConfig", "part_a2": "PartA2Config",
                      "second_iou": "SECONDIoUConfig"}
# the --smoke geometry of each, as the reference's
_TWO_STAGE_SMOKE = {
    "voxel_rcnn": dict(num_rois=16, fg_per=8, grid_size=3, shared_fc=(16,), cls_fc=(16,),
                       reg_fc=(16,), proposal_pre=64),
    "pv_rcnn": dict(num_keypoints=32, out_features=16, point_cls_fc=(16,), num_rois=8, fg_per=4,
                    grid_size=3, roi_radii=(0.8,), roi_nsamples=(8,), roi_mlp=8,
                    shared_fc=(16,), cls_fc=(16,), reg_fc=(16,), proposal_pre=64),
    "pv_rcnn_pp": dict(num_keypoints=24, num_sectors=4, out_features=16, point_cls_fc=(16,),
                       num_rois=8, fg_per=4, grid_size=3, shared_fc=(16,), cls_fc=(16,),
                       reg_fc=(16,), proposal_pre=64),
    "part_a2": dict(num_rois=8, fg_per=4, grid_size=3, pool_mlp=8, shared_fc=(16,),
                    cls_fc=(16,), reg_fc=(16,), proposal_pre=64),
    "second_iou": dict(num_rois=8, fg_per=4, grid_size=3, shared_fc=(16,), iou_fc=(16,),
                       proposal_pre=64),
}


def two_stage_config(model_name: str, cfg, smoke: bool = False):
    """The config of a two-stage KITTI YAML (Voxel R-CNN, PV-RCNN,
    PV-RCNN++, Part-A2 or SECOND-IoU) over a SECOND stage 1: the published
    geometry, or the smoke one."""
    import importlib

    mod = importlib.import_module(f"metatransformer_tpu_torch.models.{model_name}")
    m = cfg.model
    stage1 = _smoke_second_cfg() if smoke else _full_second_cfg(m.get("stage1", {}))
    kwargs: Dict[str, Any] = {"stage1": stage1}
    if smoke:
        kwargs.update(_TWO_STAGE_SMOKE[model_name])
        if model_name == "voxel_rcnn":
            kwargs["pool_layers"] = (
                ("x_conv2", mod.PoolLayerConfig(2, 0.4, nsample=8, mlp=8)),
                ("x_conv3", mod.PoolLayerConfig(4, 0.8, nsample=8, mlp=8)))
        elif model_name == "pv_rcnn":
            kwargs["sa_layers"] = (
                ("raw_points", mod.SALayerConfig((0.4,), (8,), 8)),
                ("x_conv2", mod.SALayerConfig((0.8,), (8,), 8, stride=2)),
                ("x_conv4", mod.SALayerConfig((2.4,), (8,), 8, stride=8)))
        elif model_name == "pv_rcnn_pp":
            kwargs["vp_layers"] = (
                ("raw_points", mod.VectorPoolConfig(2, 0.4, 8, 8, 8)),
                ("x_conv4", mod.VectorPoolConfig(2, 2.4, 8, 8, 8, stride=8)))
            kwargs["roi_vp"] = mod.VectorPoolConfig(2, 0.8, 8, 8, 8)
    else:
        kwargs.update({k: m[k] for k in ("num_rois", "fg_per", "grid_size")
                       if m.get(k) is not None})
    return getattr(mod, _TWO_STAGE_CONFIGS[model_name])(**kwargs)


def _two_stage_builder(model_name: str) -> Callable:
    """voxel_rcnn / pv_rcnn / pv_rcnn_pp / part_a2 / second_iou share the
    (points, gt, anchors) training interface over a SECOND stage 1."""

    def build(cfg, generator, smoke=False, device=None):
        import importlib

        from metatransformer_tpu_torch.models import second

        device = _device.resolve(device)
        mod = importlib.import_module(f"metatransformer_tpu_torch.models.{model_name}")
        mcfg = two_stage_config(model_name, cfg, smoke)
        params = mod.init(mcfg, generator, device)
        anchors = torch.as_tensor(second.generate_anchors(mcfg.stage1), device=device)

        def forward(p, x, gen):
            x = batch_to_device(x, device)
            return mod.training_loss(p, x["points"], x["gt_boxes"], x["gt_valid"], anchors,
                                     mcfg)[0]

        return _det3d_recipe(params, forward, mcfg.stage1.pc_range, mcfg.stage1.num_classes,
                             smoke)

    build.__name__ = f"build_{model_name}"
    return build


_KITTI_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)


def point_rcnn_config(cfg, smoke: bool = False):
    """The PointRCNNConfig of the KITTI PointRCNN YAML (or the smoke one)."""
    from metatransformer_tpu_torch.models import point_rcnn as pr

    m = cfg.model
    if smoke:
        return pr.PointRCNNConfig(
            num_classes=3,
            sa_stages=(pr.SAStage(32, (0.5, 1.0), (8, 8), ((8, 8), (8, 8))),
                       pr.SAStage(8, (1.0, 2.0), (8, 8), ((8, 16), (8, 16)))),
            fp_mlps=((16, 16), (32, 32)), head_cls_fc=(16,), head_reg_fc=(16,), num_rois=8,
            fg_per=4, num_sampled_points=16, xyz_up=(8, 8),
            roi_sa_stages=(pr.SAStage(8, (0.5,), (8,), ((16, 16),)),
                           pr.SAStage(-1, (100.0,), (8,), ((16, 32),))),
            cls_fc=(16,), reg_fc=(16,), proposal_pre=64)
    return pr.PointRCNNConfig(num_classes=m.get("num_classes", 3),
                              num_rois=m.get("num_rois", 128), fg_per=m.get("fg_per", 64),
                              num_sampled_points=m.get("num_sampled_points", 512))


def iassd_config(cfg, smoke: bool = False):
    """The IASSDConfig of the KITTI IA-SSD YAML (or the smoke one)."""
    from metatransformer_tpu_torch.models import iassd

    m = cfg.model
    if smoke:
        st = iassd.IASSDStage
        return iassd.IASSDConfig(
            stages=(st("sa", 32, "d-fps", (0.5, 1.0), (8, 8), ((8, 8), (8, 8)), agg=8, conf=8,
                       layer_input=0),
                    st("sa", 16, "ctr-aware", (1.0, 2.0), (8, 8), ((8, 16), (8, 16)), agg=16,
                       conf=16, layer_input=1),
                    st("sa", 8, "ctr-aware", layer_input=2, agg=16),
                    st("vote", layer_input=3, vote_mlp=(8,)),
                    st("sa", -1, "d-fps", (2.0, 4.0), (8, 8), ((16, 16), (16, 32)), agg=32,
                       layer_input=2, ctr_input=4)),
            cls_fc=(16,), reg_fc=(16,))
    return iassd.IASSDConfig(num_classes=m.get("num_classes", 3),
                             angle_bins=m.get("angle_bins", 12))


def _point_det3d_build(module: str, config: Callable) -> Callable:
    """PointRCNN and IA-SSD: (points, gt boxes, labels, validity) training
    interface, no anchors."""

    def build(cfg, generator, smoke=False, device=None):
        import importlib

        mod = importlib.import_module(f"metatransformer_tpu_torch.models.{module}")
        device = _device.resolve(device)
        mcfg = config(cfg, smoke)
        params = mod.init(mcfg, generator, device)

        def forward(p, x, gen):
            x = batch_to_device(x, device)
            return mod.training_loss(p, x["points"], x["gt_boxes"], x["gt_labels"], x["gt_valid"],
                                     mcfg)[0]

        return _det3d_recipe(params, forward, _SMOKE_RANGE if smoke else _KITTI_RANGE,
                             mcfg.num_classes, smoke)

    build.__name__ = f"build_{module}"
    return build


build_point_rcnn = _point_det3d_build("point_rcnn", point_rcnn_config)
build_iassd = _point_det3d_build("iassd", iassd_config)


def mdf_second_config(cfg, smoke: bool = False):
    """The MDFSECONDConfig of the MDF Waymo + nuScenes YAML (one class, as
    the reference's; or the smoke one)."""
    from metatransformer_tpu_torch.models import mdf_detectors as md

    m = cfg.model
    return md.MDFSECONDConfig(
        base=_smoke_second_cfg(1) if smoke else _full_second_cfg(m, num_classes=1),
        num_datasets=m.get("num_datasets", 2), domain_attention=m.get("domain_attention", True),
        reduction=4 if smoke else 8)


def build_mdf_second(cfg, generator, smoke=False, device=None):
    """MDF SECOND: two synthetic datasets drawn from seeds 1000 apart, one
    merged loss ``weight_a * loss_a + weight_b * loss_b`` a step
    (train_multi_db_merge_loss.py over the UniNorm backbone)."""
    from metatransformer_tpu_torch.models import mdf_detectors as md
    from metatransformer_tpu_torch.models import second

    device = _device.resolve(device)
    mcfg = mdf_second_config(cfg, smoke)
    params = md.init(mcfg, generator, device)
    anchors = torch.as_tensor(second.generate_anchors(mcfg.base), device=device)
    wa, wb = cfg.train.get("weight_a", 1.0), cfg.train.get("weight_b", 1.0)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        la, lb = (md.training_loss(p, x[k]["points"], x[k]["gt_boxes"], x[k]["gt_valid"], anchors,
                                   mcfg, i)[0] for i, k in enumerate("ab"))
        return wa * la + wb * lb

    one = _det3d_synth(mcfg.base.pc_range, 1, 128 if smoke else 1024)

    def synth(batch_size, n_batches, seed):
        for a, b in zip(one(batch_size, n_batches, seed), one(batch_size, n_batches, seed + 1000)):
            yield {"input": {"a": a["input"], "b": b["input"]}}

    return Recipe(params, forward, synth, loss_fn=_identity_loss, classification=False,
                  best_mode="min")


def caddn_config(cfg, smoke: bool = False):
    """The CaDDNConfig of the KITTI CaDDN YAML (or the smoke one)."""
    from metatransformer_tpu_torch.models import caddn

    m = cfg.model
    if smoke:
        return caddn.CaDDNConfig(
            image_hw=(32, 64), depth_min=2.0, depth_max=10.0, num_bins=16, stem=(8, 16),
            frustum_ch=8, pc_range=(2.0, -4.0, -2.0, 10.0, 4.0, 1.0), grid_size=(16, 16, 6),
            bev_channels=(8, 16), up_channels=8, bev_layer_num=1)
    return caddn.CaDDNConfig(depth_min=m.get("depth_min", 2.0), depth_max=m.get("depth_max", 46.8),
                             num_bins=m.get("num_bins", 80))


def _caddn_synth(mcfg):
    """Images, a fixed front camera, uniform depth maps at the feature
    stride with a central foreground box, and two car-sized ground truths
    (the second padding), in the reference's draw order."""
    h, w = mcfg.image_hw
    hf, wf = mcfg.feat_hw
    # lidar (x forward, y left, z up) -> camera (z forward, x right, y down)
    l2c = np.zeros((4, 4), np.float32)
    l2c[0, 1] = l2c[1, 2] = -1.0
    l2c[2, 0] = l2c[3, 3] = 1.0
    c2i = np.asarray([[w, 0, w / 2, 0], [0, w, h / 2, 0], [0, 0, 1, 0]], np.float32)
    lo = np.asarray(mcfg.pc_range[:3])
    span = np.asarray(mcfg.pc_range[3:]) - lo

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            ctr = (lo + span * rng.uniform(0.3, 0.7, (batch_size, 2, 3))).astype(np.float32)
            size = np.broadcast_to(np.asarray([3.2, 1.6, 1.5], np.float32), ctr.shape)
            yaw = rng.uniform(-0.3, 0.3, (batch_size, 2, 1)).astype(np.float32)
            depth = rng.uniform(mcfg.depth_min, mcfg.depth_max, (batch_size, hf, wf)).astype(
                np.float32)
            fg = np.zeros((batch_size, hf, wf), bool)
            fg[:, hf // 4:3 * hf // 4, wf // 4:3 * wf // 4] = True
            yield {"input": {
                "image": rng.uniform(0, 1, (batch_size, h, w, 3)).astype(np.float32),
                "lidar_to_cam": np.broadcast_to(l2c, (batch_size, 4, 4)).copy(),
                "cam_to_img": np.broadcast_to(c2i, (batch_size, 3, 4)).copy(),
                "depth_maps": depth, "fg_mask": fg,
                "gt_boxes": np.concatenate([ctr, size, yaw], -1),
                "gt_valid": np.stack([np.ones(batch_size, bool), np.zeros(batch_size, bool)], 1),
            }}

    return synth


def build_caddn(cfg, generator, smoke=False, device=None):
    """KITTI CaDDN (the monocular camera detector: LID depth bins and the
    frustum-to-voxel sample)."""
    from metatransformer_tpu_torch.models import caddn

    device = _device.resolve(device)
    mcfg = caddn_config(cfg, smoke)
    params = caddn.init(mcfg, generator, device)
    anchors = torch.as_tensor(caddn.generate_anchors(mcfg), device=device)

    def forward(p, x, gen):
        x = batch_to_device(x, device)
        return caddn.training_loss(p, x["image"], x["lidar_to_cam"], x["cam_to_img"],
                                   x["depth_maps"], x["fg_mask"], x["gt_boxes"], x["gt_valid"],
                                   anchors, mcfg)[0]

    return Recipe(params, forward, _caddn_synth(mcfg), loss_fn=_identity_loss,
                  classification=False, best_mode="min")


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


def _point_zoo_smoke_cfg(name, num_classes):
    """Tiny structurally identical geometry a zoo entry (the small configs
    the reference's unit tests train with)."""
    from metatransformer_tpu_torch.models import curvenet as cn
    from metatransformer_tpu_torch.models import point_baselines as pb
    from metatransformer_tpu_torch.models import point_baselines2 as pb2
    from metatransformer_tpu_torch.models import point_baselines3 as pb3
    from metatransformer_tpu_torch.models import simpleview as sv

    table = {
        "BallDGCNN": lambda: pb3.BallDGCNNConfig(
            num_classes=num_classes, channels=8, embed_dim=32, n_blocks=4, k=8, radius=0.4,
            head_fcs=(16,)),
        "GroupPointNet": lambda: pb3.GroupPointNetConfig(
            num_classes=num_classes, channels=8, n_blocks=4, k=8, head_fcs=(16,)),
        "ViTGraph": lambda: pb3.ViTGraphConfig(
            num_classes=num_classes, encoder_dim=32, embed_dim=16, depth=2, num_heads=4,
            num_groups=128, group_size=8, head_fcs=(16,)),
        "PointNet2Encoder": lambda: pb.PointNet2Config(
            num_classes=num_classes,
            stages=(pb.SAMSGStage(32, (0.2, 0.4), (8, 16), ((8, 16), (8, 16))),
                    pb.SAMSGStage(8, (0.4, 0.8), (8, 16), ((16, 32), (16, 32)))),
            global_mlp=(32, 64), head_fcs=(32,)),
        "DGCNN": lambda: pb.DGCNNConfig(
            num_classes=num_classes, k=8, edge_channels=(8, 8, 16), emb_dim=32, head_fcs=(16,)),
        "PointMLP": lambda: pb.PointMLPConfig(
            num_classes=num_classes, embed_dim=8, k=8, stage_channels=(8, 16), head_fcs=(16,)),
        "PointNeXt": lambda: pb.PointNeXtConfig(
            num_classes=num_classes, stem_dim=8, stage_channels=(8, 16), base_radius=0.3, k=8,
            head_fcs=(16,)),
        "PointNetEncoder": lambda: pb2.PointNetConfig(num_classes=num_classes, head_fcs=(32,)),
        "PCT": lambda: pb2.PCTConfig(
            num_classes=num_classes, stem=(8, 8), stage_points=(16, 8), stage_channels=(16, 32),
            k=8, num_sa=2, fuse_dim=32, head_fcs=(16,)),
        "PointViT": lambda: pb2.PointViTConfig(
            num_classes=num_classes, dim=32, depth=2, num_heads=4, num_groups=128, group_size=8,
            head_fcs=(16,)),
        "DeepGCN": lambda: pb2.DeepGCNConfig(
            num_classes=num_classes, channels=8, emb_dim=32, n_blocks=3, k=4, head_fcs=(16,)),
        "CurveNet": lambda: cn.CurveNetConfig(
            num_classes=num_classes, embed_dim=8, k=8,
            stages=(cn.CICStage(64, 0.4, 8, 16, (8, 3)), cn.CICStage(16, 0.8, 8, 32, None)),
            head_fcs=(16,)),
        "SimpleView": lambda: sv.SimpleViewConfig(
            num_classes=num_classes, channels=4, resolution=32, blocks_per_stage=1),
    }
    return table[name]()


def build_point_baseline(cfg, generator, smoke=False, device=None):
    """Baseline-zoo classification recipes: cfg.model.NAME selects a
    registry backbone (the openpoints ``cfgs/modelnet40ply2048/*.yaml``
    launcher surface: one YAML a vendored baseline)."""
    from metatransformer_tpu_torch.utils.registry import MODELS

    device = _device.resolve(device)
    name = cfg.model.NAME
    mod = MODELS.get(name)
    ncls = cfg.model.num_classes
    mcfg = _point_zoo_smoke_cfg(name, ncls) if smoke else mod.Config(num_classes=ncls)
    params = mod.init(mcfg, generator, device)

    def forward(p, x, gen):
        return mod.forward(p, batch_to_device(x, device), mcfg)

    def synth(batch_size, n_batches, seed):
        rng = np.random.default_rng(seed)
        n = 64 if smoke else cfg.train.get("num_points", 1024)
        for _ in range(n_batches):
            pts = rng.standard_normal((batch_size, n, 3)).astype(np.float32)
            yield {"input": pts * 0.5, "label": _labels(rng, batch_size, ncls)}

    return Recipe(params, forward, synth)


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
    "SECONDNet": build_second,
    "VoxelRCNN": _two_stage_builder("voxel_rcnn"),
    "PVRCNN": _two_stage_builder("pv_rcnn"),
    "PVRCNNPP": _two_stage_builder("pv_rcnn_pp"),
    "PartA2": _two_stage_builder("part_a2"),
    "SECONDIoU": _two_stage_builder("second_iou"),
    "CenterPoint": build_centerpoint,
    "CenterPointNusc": build_centerpoint,
    "PointRCNN": build_point_rcnn,
    "IASSD": build_iassd,
    "CaDDN": build_caddn,
    "MDFSECONDNet": build_mdf_second,
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
