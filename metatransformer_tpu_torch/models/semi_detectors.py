"""Named semi-supervised detector wrappers (SemiSECOND / SemiPVRCNN /
SemiCenterPoint).

Port of ``metatransformer_tpu/models/semi_detectors.py``.

Reference: ``AutonomousDriving/pcdet/models/detectors/semi_second.py``,
``pv_rcnn.py:SemiPVRCNN``, ``centerpoint``'s semi heads — each is the
base detector run in one of three roles (origin / teacher / student):
the teacher produces gated pseudo boxes, the student trains on them,
and the teacher tracks the student by EMA. The role machinery is
``train/detector_ssl.py``; these wrappers bind it to a concrete
detector so configs can name e.g. ``SemiSECOND`` directly. A wrapper's
tree is its base detector's tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.train import detector_ssl


@dataclasses.dataclass
class SemiDetector:
    """A detector module + the self-training loop bound together.

    ``base`` must expose init/forward(+predict) and a detection loss;
    ``loss_fn(params, points, gt_boxes, gt_valid)`` closes over the
    config/anchors like ``detector_ssl.make_self_training_step`` expects.
    """

    base: Any
    loss_fn: Callable
    predict_fn: Callable  # (params, points) -> List[dict] detections
    pseudo_cfg: detector_ssl.PseudoBoxConfig = dataclasses.field(
        default_factory=detector_ssl.PseudoBoxConfig
    )

    def init(self, cfg, generator: torch.Generator, device: _device.Device = None):
        """The base detector's seeded parameters on ``device`` (None: the
        card)."""
        return self.base.init(cfg, generator, device)

    def make_step(self, optimizer, ema_decay: float = 0.999):
        return detector_ssl.make_self_training_step(
            self.loss_fn, optimizer, ema_decay
        )

    def pseudo_labels(self, teacher_params, points):
        with torch.no_grad():
            dets = self.predict_fn(teacher_params, points)
        return detector_ssl.gate_pseudo_boxes(dets, self.pseudo_cfg)


def semi_second(cfg, anchors) -> SemiDetector:
    """SemiSECOND (detectors/semi_second.py); ``anchors`` a tensor on the
    parameters' device."""
    from metatransformer_tpu_torch.models import second

    def loss_fn(p, pts, gt, gv):
        preds = second.forward(p, pts, cfg)
        return second.detection_loss(preds, anchors, gt, gv, cfg)

    def predict_fn(p, pts):
        preds = second.forward(p, pts, cfg)
        return second.predict(preds, anchors, cfg, score_thr=0.0)

    return SemiDetector(second, loss_fn, predict_fn)


def semi_centerpoint(cfg) -> SemiDetector:
    """SemiCenterPoint (dense_heads/center_head_semi.py role split)."""
    from metatransformer_tpu_torch.models import centerpoint as cp

    def loss_fn(p, pts, gt, gv):
        preds = cp.forward(p, pts, cfg)
        labels = torch.zeros(gt.shape[:2], dtype=torch.int32, device=gt.device)
        return cp.detection_loss(preds, gt, labels, gv, cfg)

    def predict_fn(p, pts):
        preds = cp.forward(p, pts, cfg)
        return cp.decode(preds, cfg, k=64)

    return SemiDetector(cp, loss_fn, predict_fn)


def semi_pv_rcnn(cfg, anchors) -> SemiDetector:
    """SemiPVRCNN (detectors/pv_rcnn.py:SemiPVRCNN)."""
    from metatransformer_tpu_torch.models import pv_rcnn as pv

    def loss_fn(p, pts, gt, gv):
        return pv.training_loss(p, pts, gt, gv, anchors, cfg)

    def predict_fn(p, pts):
        return pv.predict(p, pts, anchors, cfg, score_thr=0.0)

    return SemiDetector(pv, loss_fn, predict_fn)
