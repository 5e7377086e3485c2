"""Model / component registry and config-driven builder.

Port of ``metatransformer_tpu/utils/registry.py`` (openpoints'
``MODELS.register_module()`` / ``build_model_from_cfg`` and pcdet's
name-dispatched ``build_network``): components register under a name;
configs instantiate by NAME + kwargs.

The reference imports every shipped model family when the registry is
imported. Here the built-in families are a table of module names that
:meth:`Registry.get` imports on first use, so importing the registry
imports no model. Every name the reference registers resolves.
"""

from __future__ import annotations

import importlib
import types
from typing import Any, Callable, Dict, Optional, Tuple

_MODELS_PKG = "metatransformer_tpu_torch.models."


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}
        # name -> a callable that imports and returns the entry on first use
        self._lazy: Dict[str, Callable[[], Any]] = {}

    def register(self, name: Optional[str] = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._entries:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._entries[key] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._entries and name in self._lazy:
            entry = self._lazy[name]()
            # a module's own _register() hook may have put it there already
            self._entries.setdefault(name, entry)
        if name in self._entries:
            return self._entries[name]
        raise KeyError(f"{name!r} not in registry {self.name}; known: {sorted(self.known())}")

    def build(self, cfg: Dict[str, Any], **extra):
        """cfg: {"NAME": ..., **kwargs} (openpoints convention)."""
        cfg = dict(cfg)
        name = cfg.pop("NAME", None) or cfg.pop("name")
        return self.get(name)(**cfg, **extra)

    def known(self) -> Tuple[str, ...]:
        """Every name :meth:`get` resolves, imported or not yet."""
        return tuple(sorted(set(self._entries) | set(self._lazy)))

    def __contains__(self, name: str) -> bool:
        return name in self._entries or name in self._lazy


MODELS = Registry("models")
TOKENIZERS = Registry("tokenizers")
HEADS = Registry("heads")


def _module(name: str) -> Callable[[], Any]:
    return lambda: importlib.import_module(_MODELS_PKG + name)


def _entry(module: str, attr: str) -> Callable[[], Any]:
    """The entry a module registers itself (its ``_register()`` hook) under
    ``attr``; importing the module runs the hook."""

    def load():
        importlib.import_module(_MODELS_PKG + module)
        return MODELS._entries[attr]

    return load


def _namespace(module: str, **fields: str) -> Callable[[], Any]:
    """A SimpleNamespace of the module's functions, named as the reference's
    entry names them (``init``, ``forward``, ``Config``, ...)."""

    def load():
        mod = importlib.import_module(_MODELS_PKG + module)
        return types.SimpleNamespace(**{k: getattr(mod, v) for k, v in fields.items()})

    return load


def _register_builtins() -> None:
    """The shipped model families by name, as the reference registers them;
    each resolved when first looked up."""
    modules = {
        "ImageClassifier": "image_classifier",
        "AudioClassifier": "audio_classifier",
        "VideoClassifier": "video_classifier",
        "PointClassifier": "point_classifier",
        "PointSegmenter": "point_segmenter",
        "HyperClassifier": "hyper_classifier",
        "TabularClassifier": "tabular_classifier",
        "GraphPredictor": "graph_predictor",
        "TimeSeriesModel": "time_series",
        "Segmentor": "segmentor",  # ViT-Adapter + UperNet
        "SECONDNet": "second",  # sparse-voxel 3D detector
        "VoxelRCNN": "voxel_rcnn",  # two-stage sparse-voxel detector
        "PVRCNN": "pv_rcnn",  # point-voxel two-stage detector
        "SECONDNetIoU": "second_iou",  # SECOND + IoU confidence head (SSL workhorse)
        "PartA2Net": "part_a2",  # part-aware two-stage detector (sparse UNet)
        "PVRCNNPlusPlus": "pv_rcnn_pp",  # SPC keypoints + VectorPool aggregation
        "CenterPoint": "centerpoint",  # anchor-free centre-heatmap detector
        "PointRCNN": "point_rcnn",  # point-based two-stage detector
        "IASSD": "iassd",  # instance-aware single-stage point detector
        "CaDDN": "caddn",  # monocular camera detector (categorical depth)
        "MetaTransformerMultiView": "point_multiview",
    }
    MODELS._lazy.update({name: _module(mod) for name, mod in modules.items()})
    MODELS._lazy.update({
        "MaskRCNN": _namespace("mask_rcnn", init="init", forward="forward_test",
                               forward_train="forward_train", Config="MaskRCNNConfig"),
        "Mask2FormerSegmentor": _namespace("segmentor", init="init_mask2former",
                                           forward="forward_mask2former",
                                           Config="Mask2FormerSegmentorConfig"),
        "HTC": _namespace("htc", init="init", forward="forward_test",  # interleaved cascade
                          forward_train="forward_train", Config="HTCConfig"),
        "MDFSECONDNet": _namespace("mdf_detectors", init="init",  # multi-dataset fusion
                                   forward="forward", Config="MDFSECONDConfig"),
        "MDFCenterPoint": _namespace("mdf_detectors", init="init_centerpoint",
                                     forward="forward_centerpoint",
                                     Config="MDFCenterPointConfig"),
    })
    # the families that register themselves when their module is imported
    hooks = {
        "point_baselines": ("PointNet2Encoder", "DGCNN", "PointMLP", "PointNeXt"),
        "point_baselines2": ("PointNetEncoder", "PCT", "PointViT", "DeepGCN"),
        "point_baselines3": ("BallDGCNN", "GroupPointNet", "ViTGraph"),
        "curvenet": ("CurveNet",),
        "simpleview": ("SimpleView",),
        "point_mae": ("MaskedPointViT",),
        "randlanet": ("RandLANet",),
        "baafnet": ("BAAFNet",),
        "point_transformer_seg": ("PointTransformerSeg",),
        "stratified_transformer": ("StratifiedTransformer",),
    }
    MODELS._lazy.update({name: _entry(mod, name) for mod, names in hooks.items()
                         for name in names})


_register_builtins()
