"""Training augmentations.

Port of ``metatransformer_tpu/train/augment.py``, the reference's
per-modality augmentation stack:

* mixup: waveform-level (Audio dataloader.py:99-127) and batch
  feature / label level (the Video engine's timm-style mixup);
* SpecAugment frequency and time masking (Audio dataloader.py:72-74,140);
* point-cloud transforms: rotate, scale and translate, jitter
  (``PointCloud/openpoints/transforms/``);
* random erasing (the Video RandomErasing, one box a sample);
* large-scale jitter (the upgraded Mask R-CNN's LSJ).

Each function draws its random values from a ``torch.Generator`` where the
reference splits a key, on the generator's device; each also takes those
values ready drawn (the keyword arguments after the generator's draws),
which is how a caller replays another run's draws, the JAX package's
included. Drawn values keep the reference's shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _uniform(generator, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def _randint(generator, shape, lo, hi, device):
    """Integers in [lo, hi) with ``hi`` a tensor of the draw's shape."""
    u = torch.rand(shape, generator=generator, device=device)
    return lo + torch.floor(u * (hi - lo)).long()


def _beta(generator, alpha: float, device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw, seeded from ``generator``."""
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        lam = torch.distributions.Beta(alpha, alpha).sample()
    return lam.to(device)


def mixup_batch(generator, inputs, labels_onehot, alpha: float = 0.8,
                lam: Optional[torch.Tensor] = None):
    """timm-style batch mixup: each sample mixed with its flipped-batch
    peer at one ``lam`` ~ Beta(alpha, alpha)."""
    if lam is None:
        lam = _beta(generator, alpha, inputs.device)
    mixed = lam * inputs + (1 - lam) * inputs.flip(0)
    labels = lam * labels_onehot + (1 - lam) * labels_onehot.flip(0)
    return mixed, labels


def mixup_waveform(generator, wav, labels_onehot, alpha: float = 10.0,
                   lam: Optional[torch.Tensor] = None):
    """AST's waveform mixup (Beta(10, 10), dataloader.py:99-127)."""
    return mixup_batch(generator, wav, labels_onehot, alpha, lam)


def spec_augment(generator, spec: torch.Tensor, freq_mask: int = 48, time_mask: int = 48,
                 draws: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """SpecAugment on [B, T, F] log-mel spectrograms: one frequency band
    and one time band zeroed a sample. ``draws`` = (fw, f0, tw, t0), each
    [B, 1]: the band widths in [0, mask] and their starts in
    [0, max(size - width, 1))."""
    b, t, f = spec.shape
    dev = spec.device
    if draws is None:
        fw = _randint(generator, (b, 1), 0, torch.full((b, 1), freq_mask + 1, device=dev), dev)
        f0 = _randint(generator, (b, 1), 0, (f - fw).clamp_min(1), dev)
        tw = _randint(generator, (b, 1), 0, torch.full((b, 1), time_mask + 1, device=dev), dev)
        t0 = _randint(generator, (b, 1), 0, (t - tw).clamp_min(1), dev)
    else:
        fw, f0, tw, t0 = (d.to(dev) for d in draws)
    fidx = torch.arange(f, device=dev)[None, :]
    tidx = torch.arange(t, device=dev)[None, :]
    fmask = (fidx >= f0) & (fidx < f0 + fw)  # [B, F]
    tmask = (tidx >= t0) & (tidx < t0 + tw)  # [B, T]
    keep = ~(fmask[:, None, :] | tmask[:, :, None])
    return torch.where(keep, spec, 0.0)


def rotate_points_z(generator, points: torch.Tensor,
                    theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random rotation about z a sample, [B, N, 3]; ``theta`` [B] in
    [0, 2 pi)."""
    b = points.shape[0]
    if theta is None:
        theta = _uniform(generator, (b,), 0.0, 2 * torch.pi, points.device)
    c, s = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], -1).reshape(b, 3, 3)
    return torch.einsum("bnc,bcd->bnd", points, rot.to(points.dtype))


def scale_and_translate_points(
    generator, points: torch.Tensor,
    scale_range: Tuple[float, float] = (2.0 / 3.0, 3.0 / 2.0),
    shift: float = 0.2,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Anisotropic scale and shift a sample; ``scale`` and ``offset``
    [B, 1, 3]."""
    b, dev = points.shape[0], points.device
    if scale is None:
        scale = _uniform(generator, (b, 1, 3), scale_range[0], scale_range[1], dev)
    if offset is None:
        offset = _uniform(generator, (b, 1, 3), -shift, shift, dev)
    return points * scale.to(dev) + offset.to(dev)


def jitter_points(generator, points: torch.Tensor, sigma: float = 0.01, clip: float = 0.05,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clipped Gaussian jitter; ``noise`` is the unit normal draw of the
    points' shape."""
    if noise is None:
        noise = torch.randn(points.shape, generator=generator, device=points.device)
    return points + (noise.to(points.device) * sigma).clamp(-clip, clip)


def random_erase(generator, images: torch.Tensor, scale=(0.02, 0.33),
                 draws: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """A rectangle a sample of [B, H, W, C] replaced by unit normal noise
    (RandomErasing's intent). ``draws`` = (area [B, 1] in ``scale``, y0
    [B, 1], x0 [B, 1], noise of the images' shape): the square's side is
    sqrt(area) of each side, truncated, and its corner lies in
    [0, max(size - side, 1))."""
    b, h, w, _ = images.shape
    dev = images.device
    if draws is None:
        area = _uniform(generator, (b, 1), scale[0], scale[1], dev)
    else:
        area, y0, x0, noise = (d.to(dev) for d in draws)
    side = torch.sqrt(area)
    eh = (side * h).long()
    ew = (side * w).long()
    if draws is None:
        y0 = _randint(generator, (b, 1), 0, (h - eh).clamp_min(1), dev)
        x0 = _randint(generator, (b, 1), 0, (w - ew).clamp_min(1), dev)
        noise = torch.randn(images.shape, generator=generator, device=dev)
    yy = torch.arange(h, device=dev)[None, :]
    xx = torch.arange(w, device=dev)[None, :]
    ymask = (yy >= y0) & (yy < y0 + eh)  # [B, H]
    xmask = (xx >= x0) & (xx < x0 + ew)  # [B, W]
    box = ymask[:, :, None] & xmask[:, None, :]
    return torch.where(box[..., None], noise.to(images.dtype), images)


def _scale_weights(size: int, scale: torch.Tensor) -> torch.Tensor:
    """``jax.image.scale_and_translate``'s bilinear weights of one axis at
    zero translation, [in, out]: the triangle kernel at each output pixel
    centre's place in the input, widened by 1 / scale when it shrinks
    (antialiasing); each output's weights normalised over the input's
    pixels (none where they sum to about 0), and an output whose centre
    falls outside the input takes none."""
    dev = scale.device
    inv = 1.0 / scale
    sample = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(size, device=dev, dtype=torch.float32)[:, None]).abs()
    weights = (1.0 - x / torch.clamp(inv, min=1.0)).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def large_scale_jitter(generator, images: torch.Tensor, boxes: torch.Tensor,
                       ratio_range=(0.1, 2.0), scale: Optional[torch.Tensor] = None):
    """LSJ: the whole batch resized by one ``scale`` in ``ratio_range`` and
    cropped / zero-padded back to its size, the content at the canvas
    origin (the upgraded_mask_rcnn Resize + RandomCrop, static shapes);
    boxes scaled and clipped to the canvas, a box cropped away collapsing
    to zero area. -> (images', boxes', scale). The resize is
    ``jax.image.scale_and_translate`` (bilinear, antialiased when it
    shrinks): two fp32 products with its weight matrices."""
    b, h, w, c = images.shape
    if scale is None:
        scale = _uniform(generator, (), ratio_range[0], ratio_range[1], images.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=images.device)
    x = images.float()
    wy, wx = _scale_weights(h, scale), _scale_weights(w, scale)
    out = torch.einsum("bhwc,hy->bywc", x, wy)
    out = torch.einsum("bywc,wx->byxc", out, wx)
    scaled = boxes * scale
    new_boxes = torch.stack([scaled[..., i].clamp(0.0, float(lim))
                             for i, lim in enumerate((w - 1, h - 1, w - 1, h - 1))], -1)
    return out, new_boxes, scale
