"""The port's training augmentations (train/augment.py) against the JAX
package on the CPU: each of the eight functions with JAX's own draws passed
in (reproduced from its key by the reference's split sequence), at 1e-6
(large-scale jitter's resize at 1e-5, at drawn scales on both sides of 1),
and each drawing from a ``torch.Generator`` reproducibly and in range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.train import augment as jaug
from metatransformer_tpu_torch.train import augment

TOL = 1e-6
LSJ_TOL = 1e-5
KEY = jax.random.PRNGKey(3)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("fn,alpha", [("mixup_batch", 0.8), ("mixup_waveform", 10.0)])
def test_mixup_matches_jax(fn, alpha):
    x, y = _np(0, 4, 5, 3), np.eye(4, dtype=np.float32)[[0, 2, 1, 3]]
    mixed, labels = getattr(jaug, fn)(KEY, jnp.asarray(x), jnp.asarray(y), alpha)
    lam = jax.random.beta(KEY, alpha, alpha)
    got = getattr(augment, fn)(None, _t(x), _t(y), alpha, lam=_t(lam))
    _close(got[0], mixed)
    _close(got[1], labels)


@pytest.mark.parametrize("masks", [(48, 48), (3, 5), (0, 0)])
def test_spec_augment_matches_jax(masks):
    spec = _np(1, 3, 20, 16)
    want = jaug.spec_augment(KEY, jnp.asarray(spec), *masks)
    b, t, f = spec.shape
    k1, k2, k3, k4 = jax.random.split(KEY, 4)
    fw = jax.random.randint(k1, (b, 1), 0, masks[0] + 1)
    f0 = jax.random.randint(k2, (b, 1), 0, jnp.maximum(f - fw, 1))
    tw = jax.random.randint(k3, (b, 1), 0, masks[1] + 1)
    t0 = jax.random.randint(k4, (b, 1), 0, jnp.maximum(t - tw, 1))
    got = augment.spec_augment(None, _t(spec), *masks, draws=tuple(map(_t, (fw, f0, tw, t0))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rotate_points_z_matches_jax():
    pts = _np(2, 3, 10, 3)
    theta = jax.random.uniform(KEY, (3,), minval=0.0, maxval=2 * jnp.pi)
    _close(augment.rotate_points_z(None, _t(pts), theta=_t(theta)),
           jaug.rotate_points_z(KEY, jnp.asarray(pts)))


def test_scale_and_translate_points_matches_jax():
    pts = _np(3, 3, 10, 3)
    k1, k2 = jax.random.split(KEY)
    scale = jax.random.uniform(k1, (3, 1, 3), minval=2.0 / 3.0, maxval=1.5)
    offset = jax.random.uniform(k2, (3, 1, 3), minval=-0.2, maxval=0.2)
    _close(augment.scale_and_translate_points(None, _t(pts), scale=_t(scale), offset=_t(offset)),
           jaug.scale_and_translate_points(KEY, jnp.asarray(pts)))


@pytest.mark.parametrize("sigma,clip", [(0.01, 0.05), (0.1, 0.05)])
def test_jitter_points_matches_jax(sigma, clip):
    pts = _np(4, 3, 10, 3)
    noise = jax.random.normal(KEY, pts.shape)
    got = augment.jitter_points(None, _t(pts), sigma, clip, noise=_t(noise))
    _close(got, jaug.jitter_points(KEY, jnp.asarray(pts), sigma, clip))
    assert (got - _t(pts)).abs().max() <= clip + 1e-7


@pytest.mark.parametrize("scale", [(0.02, 0.33), (0.3, 0.6)])
def test_random_erase_matches_jax(scale):
    images = _np(5, 3, 16, 12, 3)
    b, h, w, _ = images.shape
    k1, k2, k3, k4 = jax.random.split(KEY, 4)
    area = jax.random.uniform(k1, (b, 1), minval=scale[0], maxval=scale[1])
    side = jnp.sqrt(area)
    eh, ew = (side * h).astype(jnp.int32), (side * w).astype(jnp.int32)
    y0 = jax.random.randint(k2, (b, 1), 0, jnp.maximum(h - eh, 1))
    x0 = jax.random.randint(k3, (b, 1), 0, jnp.maximum(w - ew, 1))
    noise = jax.random.normal(k4, images.shape)
    got = augment.random_erase(None, _t(images), scale, draws=tuple(map(_t, (area, y0, x0, noise))))
    want = jaug.random_erase(KEY, jnp.asarray(images), scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, _t(images))


def _lsj_inputs(h=24, w=20):
    images = _np(6, 2, h, w, 3)
    boxes = np.array([[[2.0, 3.0, 15.0, 20.0], [10.0, 1.0, 19.0, 9.0]],
                      [[0.0, 0.0, 0.0, 0.0], [5.0, 6.0, 18.5, 23.0]]], np.float32)
    return images, boxes


@pytest.mark.parametrize("scale", [0.3, 0.8, 1.0, 1.7, 0.1, 2.0])
def test_large_scale_jitter_matches_jax_at_a_pinned_scale(scale, monkeypatch):
    """The reference's own code with its draw pinned: the resize at 1e-5,
    the boxes and the scale exactly."""
    images, boxes = _lsj_inputs()
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.float32(scale))
    want = jaug.large_scale_jitter(KEY, jnp.asarray(images), jnp.asarray(boxes))
    got = augment.large_scale_jitter(None, _t(images), _t(boxes), scale=scale)
    _close(got[0], want[0], LSJ_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2].item() == float(want[2])


def test_large_scale_jitter_zeroes_what_the_scaled_image_does_not_cover():
    """An 8 x 8 image of ones at scale 0.5 keeps 4 columns; at 0.3 only 2:
    the partly covered third is 0, not a fraction, as jax.image does."""
    ones = torch.ones(1, 8, 8, 1)
    for scale, kept in ((0.5, 4), (0.3, 2)):
        out = augment.large_scale_jitter(None, ones, torch.zeros(1, 1, 4), scale=scale)[0]
        np.testing.assert_allclose(out[0, 0, :, 0].numpy(), [1.0] * kept + [0.0] * (8 - kept),
                                   atol=1e-6)


def test_large_scale_jitter_with_the_reference_draw():
    """JAX's scale from its key, passed in."""
    images, boxes = _lsj_inputs(16, 16)
    want = jaug.large_scale_jitter(KEY, jnp.asarray(images), jnp.asarray(boxes))
    got = augment.large_scale_jitter(None, _t(images), _t(boxes), scale=_t(want[2]))
    _close(got[0], want[0], LSJ_TOL)
    _close(got[1], want[1])


# --------------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------------

DRAWS = {
    "mixup_batch": lambda g, x: augment.mixup_batch(g, x, torch.eye(4), 0.8)[0],
    "mixup_waveform": lambda g, x: augment.mixup_waveform(g, x, torch.eye(4))[0],
    "spec_augment": lambda g, x: augment.spec_augment(g, x.reshape(4, 6, 10), 3, 2),
    "rotate_points_z": lambda g, x: augment.rotate_points_z(g, x.reshape(4, 20, 3)),
    "scale_and_translate_points": lambda g, x: augment.scale_and_translate_points(
        g, x.reshape(4, 20, 3)),
    "jitter_points": lambda g, x: augment.jitter_points(g, x.reshape(4, 20, 3)),
    "random_erase": lambda g, x: augment.random_erase(g, x.reshape(4, 5, 4, 3)),
    "large_scale_jitter": lambda g, x: augment.large_scale_jitter(
        g, x.reshape(4, 5, 4, 3), torch.ones(4, 1, 4))[0],
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_come_from_the_generator(name):
    """The same seed gives the same output, another seed another, and the
    input is left as it was."""
    x = torch.randn(4, 60, generator=torch.Generator().manual_seed(0)) + 3.0
    before = x.clone()
    runs = [DRAWS[name](torch.Generator().manual_seed(s), x) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(x, before) and torch.isfinite(runs[0]).all()


def test_drawn_values_fall_in_their_ranges():
    g = torch.Generator().manual_seed(4)
    spec = torch.ones(64, 30, 20)
    out = augment.spec_augment(g, spec, 5, 7)
    zero_f = (out == 0).all(1).sum(1)  # whole zeroed frequency columns a sample
    zero_t = (out == 0).all(2).sum(1)
    assert zero_f.max() <= 5 and zero_t.max() <= 7 and zero_f.float().mean() > 1
    scale = augment.large_scale_jitter(g, torch.ones(1, 4, 4, 1), torch.zeros(1, 1, 4))[2]
    assert 0.1 <= scale.item() < 2.0
    pts = torch.ones(256, 1, 3)
    moved = augment.scale_and_translate_points(g, pts)
    assert moved.min() >= 2.0 / 3.0 - 0.2 and moved.max() <= 1.5 + 0.2
