"""The port's self-training family (train/self_training.py,
train/detector_ssl.py, models/semi_detectors.py, train/multi_db.py,
train/point_contrast.py) against the JAX package on the CPU, FP32.

- ``self_training``'s functions at 1e-6 (their gradients too);
- ``gate_pseudo_boxes`` exact, the port taking tensors and the reference
  numpy, ties in the scores included (both order by numpy's argsort);
- one SemiSECOND round at the reference test's smoke geometry
  (``tests/test_semi_detectors.py``): the teacher's pseudo boxes equal,
  then two student steps under Adam (the port's ``train/optim`` state
  loaded from optax's by ``state_from_optax``): each loss at LOSS_RTOL, the
  student, the EMA teacher and Adam's moments within GRAD_TOL of each
  leaf's largest JAX value;
- ``multi_db``: the merged step on the MDF classifier and the
  teacher-student step, with JAX's key splits passed in, under SGD with
  Nesterov momentum (the classifier's bias ahead of UniNorm has a zero
  gradient but for rounding, which Adam would scale up to the rate), and the
  pseudo-label store's float32 memory ensemble, saved by one package and
  loaded by the other;
- ``point_contrast``: the views and the pretraining step with JAX's draws
  (angle, flip, scale, pair indices) passed in.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metatransformer_tpu.models import mdf as jmdf
from metatransformer_tpu.models import second as jsecond
from metatransformer_tpu.models import semi_detectors as jsd
from metatransformer_tpu.train import detector_ssl as jdssl
from metatransformer_tpu.train import multi_db as jmdb
from metatransformer_tpu.train import point_contrast as jpc
from metatransformer_tpu.train import self_training as jssl
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import mdf, second, semi_detectors as sd
from metatransformer_tpu_torch.train import detector_ssl, multi_db, optim, point_contrast
from metatransformer_tpu_torch.train import self_training as ssl
from tests.test_torch_det3d_recipes import LOSS_RTOL
from tests.test_torch_detector3d import GRAD_TOL

torch.set_num_threads(1)
FN_TOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(tree):
    return jax.tree.map(
        lambda a: a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a), tree)


def trees_close(got, want, what=""):
    """Each leaf of the port's tree within GRAD_TOL of the largest |value|
    of the same JAX leaf; a leaf JAX holds at zero but for rounding (below
    1e-6 of the tree's largest: the bias ahead of UniNorm after an SGD step)
    near zero in the port too, as ``check_train``."""
    flat, jflat = leaves_with_path(_np(got)), leaves_with_path(_np(want))
    assert [p for p, _ in flat] == [p for p, _ in jflat], what
    largest = max(np.abs(w).max() for _, w in jflat)
    for (path, g), (_, w) in zip(flat, jflat):
        if np.abs(w).max() < 1e-6 * largest:
            assert np.abs(g).max() < 1e-5 * largest, (what, path)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=f"{what} {path}")


# --------------------------------------------------------------------------
# self_training
# --------------------------------------------------------------------------


def test_self_training_functions_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((16, 5)) * 3).astype(np.float32)
    other = (rng.standard_normal((16, 5)) * 2).astype(np.float32)
    labels, keep = ssl.pseudo_labels(_t(logits), 0.6)
    jl, jk = jssl.pseudo_labels(jnp.asarray(logits), 0.6)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert 0 < int(keep.sum()) < 16
    np.testing.assert_allclose(ssl.memory_ensemble_update(_t(logits), _t(other), 0.7).numpy(),
                               jssl.memory_ensemble_update(jnp.asarray(logits),
                                                           jnp.asarray(other), 0.7),
                               rtol=FN_TOL, atol=FN_TOL)
    for fn, jfn in ((ssl.consistency_loss, jssl.consistency_loss),
                    (lambda a, b: ssl.info_nce(a, b, 0.1), lambda a, b: jssl.info_nce(a, b, 0.1))):
        a, b = _t(logits).requires_grad_(True), _t(other).requires_grad_(True)
        loss = fn(a, b)
        loss.backward()
        jloss, (ga, gb) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(logits),
                                                                 jnp.asarray(other))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=FN_TOL, atol=FN_TOL)
        np.testing.assert_allclose(a.grad.numpy(), ga, rtol=FN_TOL, atol=FN_TOL)
        # the teacher's side takes no gradient in consistency_loss (JAX: zeros)
        b_grad = torch.zeros_like(b) if b.grad is None else b.grad
        np.testing.assert_allclose(b_grad.numpy(), gb, rtol=FN_TOL, atol=FN_TOL)
    teacher = {"w": logits, "b": [other[0]]}
    student = {"w": other, "b": [logits[0]]}
    got = ssl.mean_teacher_update(convert.from_numpy(teacher, "cpu"),
                                  convert.from_numpy(student, "cpu"), 0.99)
    want = jssl.mean_teacher_update(teacher, student, 0.99)
    for (_, g), (_, w) in zip(leaves_with_path(convert.to_numpy(got)), leaves_with_path(want)):
        np.testing.assert_allclose(g, w, rtol=FN_TOL, atol=FN_TOL)


def test_gate_pseudo_boxes_equals_jax_on_tensors():
    rng = np.random.default_rng(1)
    cfg = detector_ssl.PseudoBoxConfig(score_thresh=0.3, max_boxes=6)
    dets = []
    for _ in range(3):
        scores = rng.choice([0.2, 0.5, 0.5, 0.7, 0.9], 12).astype(np.float32)  # ties
        dets.append({"boxes": rng.standard_normal((12, 7)).astype(np.float32),
                     "scores": scores, "labels": rng.integers(0, 3, 12),
                     "valid": rng.random(12) < 0.8})
    got = detector_ssl.gate_pseudo_boxes([{k: _t(v) for k, v in d.items()} for d in dets], cfg)
    want = jdssl.gate_pseudo_boxes(dets, jdssl.PseudoBoxConfig(0.3, 6))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = [{"boxes": torch.zeros(0, 7), "scores": torch.zeros(0),
              "valid": torch.zeros(0, dtype=torch.bool)}]
    assert not detector_ssl.gate_pseudo_boxes(empty, cfg)[2].any()


# --------------------------------------------------------------------------
# SemiSECOND: one round against JAX
# --------------------------------------------------------------------------

SMOKE = dict(voxel_size=(0.1, 0.1, 0.2), pc_range=(0.0, -3.2, -3.0, 6.4, 3.2, 2.0),
             spatial_shape=(25, 64, 64), max_voxels=256, widths=(4, 4, 8, 8, 8, 8),
             bev_channels=(8, 16), up_channels=8)
EMA = 0.9
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _semi_second():
    """The port's and the reference's SemiSECOND on the same weights (the
    port's seeded init) and scans, and the reference's round: pseudo boxes,
    then two steps of Adam with their states."""
    cfg, jcfg = second.SECONDConfig(**SMOKE), jsecond.SECONDConfig(**SMOKE)
    anchors = second.generate_anchors(cfg)
    weights = convert.to_numpy(second.init_cpu(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(5)
    pts = np.zeros((2, 128, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 6.4, (2, 128))
    pts[..., 1] = rng.uniform(-3.2, 3.2, (2, 128))
    pts[..., 2] = rng.uniform(-3, 2, (2, 128))
    pts[..., 3] = rng.uniform(0, 1, (2, 128))
    jsemi = jsd.semi_second(jcfg, jnp.asarray(anchors))
    jsemi.pseudo_cfg = jdssl.PseudoBoxConfig(score_thresh=0.0, max_boxes=4)
    boxes, labels, valid = jsemi.pseudo_labels(weights, jnp.asarray(pts))
    opt = optax.adam(LR)
    student, teacher = weights, weights
    state = opt.init(student)
    step = jsemi.make_step(opt, ema_decay=EMA)
    rounds = []
    for _ in range(2):
        student, teacher, state, loss, logs = step(student, teacher, state, jnp.asarray(pts),
                                                   jnp.asarray(boxes), jnp.asarray(valid))
        rounds.append((float(loss), jax.tree.map(np.asarray, (student, teacher, state[0]))))
    return cfg, anchors, weights, pts, (boxes, labels, valid), rounds


def test_semi_second_round_matches_jax():
    cfg, anchors, weights, pts, (jboxes, jlabels, jvalid), rounds = _semi_second()
    semi = sd.semi_second(cfg, _t(anchors))
    semi.pseudo_cfg = detector_ssl.PseudoBoxConfig(score_thresh=0.0, max_boxes=4)
    teacher = convert.from_numpy(weights, "cpu")
    boxes, labels, valid = semi.pseudo_labels(teacher, _t(pts))
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-4)
    assert valid.any()

    student = convert.from_numpy(weights, "cpu")
    spec = optim.make_optimizer("adam", LR)
    opt = spec.init(student)
    optim.state_from_optax(opt, 0, jax.tree.map(np.zeros_like, weights),
                           jax.tree.map(np.zeros_like, weights))
    step = semi.make_step(spec, ema_decay=EMA)
    for i, (jloss, (jstudent, jteacher, jadam)) in enumerate(rounds):
        student, teacher, opt, loss, logs = step(student, teacher, opt, _t(pts), _t(boxes),
                                                 _t(valid))
        np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL, atol=LOSS_RTOL)
        trees_close(student, jstudent, f"student after step {i + 1}")
        trees_close(teacher, jteacher, f"teacher after step {i + 1}")
        count, mu, nu = optim.state_to_optax(opt)
        assert count == int(jadam.count) == i + 1
        trees_close(mu, jadam.mu, f"Adam mu after step {i + 1}")
        trees_close(nu, jadam.nu, f"Adam nu after step {i + 1}")


def test_semi_wrappers_take_the_card_or_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    semi = sd.semi_second(second.SECONDConfig(**SMOKE), torch.zeros(1, 7))
    with pytest.raises(RuntimeError, match="CUDA"):
        semi.init(second.SECONDConfig(**SMOKE), torch.Generator().manual_seed(0))
    tree = semi.init(second.SECONDConfig(**SMOKE), torch.Generator().manual_seed(0), "cpu")
    assert leaves_with_path(tree)[0][1].device.type == "cpu"


# --------------------------------------------------------------------------
# multi_db
# --------------------------------------------------------------------------


def _mdf_weights(cfg, seed):
    return convert.to_numpy(mdf.mdf_classifier_init(cfg, torch.Generator().manual_seed(seed),
                                                    "cpu"))


def test_merged_step_matches_jax_with_its_key_splits():
    cfg = mdf.MDFClassifierConfig()
    jcfg = jmdf.MDFClassifierConfig()
    weights = _mdf_weights(cfg, 0)
    rng = np.random.default_rng(0)
    xa = (rng.standard_normal((32, 16)) * 0.5 + 2).astype(np.float32)
    xb = (rng.standard_normal((32, 16)) * 3 - 1).astype(np.float32)
    ya, yb = (xa[:, 0] > 2).astype(np.int32), 2 + (xb[:, 1] > -1).astype(np.int32)
    seen = []

    def jloss(p, batch, did, key):
        x, y = batch
        logits = jmdf.mdf_classifier_forward(p, x, did, jcfg)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    def loss(p, batch, did, key):
        seen.append(key)
        x, y = batch
        return torch.nn.functional.cross_entropy(mdf.mdf_classifier_forward(p, x, did, cfg),
                                                 y.long())

    opt = optax.sgd(5e-2, momentum=0.9, nesterov=True)
    jstep = jax.jit(jmdb.make_merged_step(jloss, opt, 1.0, 0.5))
    spec = optim.make_optimizer("sgd", 5e-2, momentum=0.9)
    params = convert.from_numpy(weights, "cpu")
    popt = spec.init(params)
    step = multi_db.make_merged_step(loss, spec, 1.0, 0.5)
    jparams, jstate = weights, opt.init(weights)
    key = jax.random.PRNGKey(1)
    batches = [(xa, ya), (xb, yb)]
    for (ba, bb) in multi_db.paired_batches([batches[0]], [batches[1]], 3):
        key, k = jax.random.split(key)
        jparams, jstate, jm = jstep(jparams, jstate, tuple(map(jnp.asarray, ba)),
                                    tuple(map(jnp.asarray, bb)), k)
        params, popt, m = step(params, popt, tuple(map(_t, ba)), tuple(map(_t, bb)),
                               tuple(jax.random.split(k)))
        for name in ("loss", "loss_a", "loss_b"):
            np.testing.assert_allclose(m[name].item(), float(jm[name]), rtol=LOSS_RTOL,
                                       atol=LOSS_RTOL)
        trees_close(params, jparams, "merged step")
    assert all(np.array_equal(a, b) for a, b in zip(seen[-2:], jax.random.split(k)))
    grads = params["norm1"]["scale"].grad
    assert grads[0].abs().max() > 0 and grads[1].abs().max() > 0


def test_pseudo_label_store_crosses_packages(tmp_path):
    rng = np.random.default_rng(2)
    ids = np.arange(6)
    first = (rng.standard_normal((6, 3)) * 4).astype(np.float32)
    second_round = (rng.standard_normal((6, 3)) * 4).astype(np.float32)
    store = multi_db.PseudoLabelStore(num_classes=3, threshold=0.7, momentum=0.7)
    jstore = jmdb.PseudoLabelStore(num_classes=3, threshold=0.7, momentum=0.7)
    for logits, ens in ((first, False), (second_round, True)):
        assert store.update_batch(ids, logits, ens) == jstore.update_batch(ids, logits, ens)
    for sid in ids:
        assert store.logits[sid].dtype == np.float32
        np.testing.assert_array_equal(store.logits[sid], jstore.logits[sid])
    np.testing.assert_array_equal(store.labels_for(ids), jstore.labels_for(ids))
    for saver, loader in ((store, jmdb.PseudoLabelStore), (jstore, multi_db.PseudoLabelStore)):
        path = os.path.join(tmp_path, f"{type(saver).__module__}.npz")
        saver.save(path)
        loaded = loader.load(path, 3)
        assert (loaded.threshold, loaded.momentum) == (0.7, 0.7)
        np.testing.assert_array_equal(loaded.labels_for(ids), store.labels_for(ids))
        for sid in ids:
            np.testing.assert_array_equal(loaded.logits[sid], store.logits[sid])


def test_fill_and_teacher_student_step_match_jax():
    cfg, jcfg = mdf.MDFClassifierConfig(num_datasets=1), jmdf.MDFClassifierConfig(num_datasets=1)
    weights = _mdf_weights(cfg, 2)
    x = np.random.default_rng(3).standard_normal((32, 16)).astype(np.float32)
    ids = np.arange(32)
    store = multi_db.PseudoLabelStore(num_classes=4, threshold=0.3)
    jstore = jmdb.PseudoLabelStore(num_classes=4, threshold=0.3)
    teacher = convert.from_numpy(weights, "cpu")
    got = multi_db.fill_pseudo_labels(
        store, lambda b: mdf.mdf_classifier_forward(teacher, _t(b), 0, cfg), [(ids, x)])
    want = jmdb.fill_pseudo_labels(
        jstore, lambda b: jmdf.mdf_classifier_forward(weights, jnp.asarray(b), jnp.int32(0),
                                                      jcfg), [(ids, x)])
    assert got == want and got[0] > 0
    labels = store.labels_for(ids)
    np.testing.assert_array_equal(labels, jstore.labels_for(ids))

    opt = optax.sgd(5e-2, momentum=0.9, nesterov=True)
    jstep = jax.jit(jmdb.make_teacher_student_step(
        lambda p, b, k: jmdf.mdf_classifier_forward(p, b, jnp.int32(0), jcfg), opt, 1.0, 0.9))
    spec = optim.make_optimizer("sgd", 5e-2, momentum=0.9)
    student = convert.from_numpy(weights, "cpu")
    popt = spec.init(student)
    step = multi_db.make_teacher_student_step(
        lambda p, b, k: mdf.mdf_classifier_forward(p, b, 0, cfg), spec, 1.0, 0.9)
    jstudent, jteacher, jstate = weights, weights, opt.init(weights)
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstudent, jteacher, jstate, jm = jstep(jstudent, jteacher, jstate, jnp.asarray(x),
                                               jnp.asarray(labels), key)
        student, teacher, popt, m = step(student, teacher, popt, _t(x), _t(labels),
                                         tuple(jax.random.split(key)))
        for name in ("loss", "supervised", "consistency"):
            np.testing.assert_allclose(m[name].item(), float(jm[name]), rtol=LOSS_RTOL,
                                       atol=LOSS_RTOL)
        trees_close(student, jstudent, "student")
        trees_close(teacher, jteacher, "teacher")


# --------------------------------------------------------------------------
# point_contrast
# --------------------------------------------------------------------------


def _jax_view(key, b):
    """The reference's draws of ``augment_view`` for ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    return point_contrast.View(
        angle=_t(jax.random.uniform(k1, (b,), minval=-0.785398, maxval=0.785398)),
        flip=_t(jax.random.bernoulli(k2, 0.5, (b,))),
        scale=_t(jax.random.uniform(k3, (b,), minval=0.95, maxval=1.05)))


def test_pretrain_step_matches_jax_on_its_draws():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2, 64, 4)).astype(np.float32)
    out = point_contrast.augment_view(_t(pts), _jax_view(jax.random.PRNGKey(3), 2))
    np.testing.assert_allclose(out.numpy(), jpc.augment_view(jnp.asarray(pts),
                                                             jax.random.PRNGKey(3)),
                               rtol=FN_TOL, atol=FN_TOL)
    drawn = point_contrast.augment_view(_t(pts), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(drawn[..., 3].numpy(), pts[..., 3])

    weights = {"w1": (rng.standard_normal((4, 32)) * 0.3).astype(np.float32),
               "w2": (rng.standard_normal((32, 16)) * 0.3).astype(np.float32)}
    opt = optax.adam(1e-2)
    jstep = jpc.make_pretrain_step(lambda p, x: jnp.tanh(x @ p["w1"]) @ p["w2"], opt, 24)
    spec = optim.make_optimizer("adam", 1e-2)
    params = convert.from_numpy(weights, "cpu")
    popt = spec.init(params)
    step = point_contrast.make_pretrain_step(lambda p, x: torch.tanh(x @ p["w1"]) @ p["w2"],
                                             spec, 24)
    jparams, jstate = weights, opt.init(weights)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, sub = jax.random.split(key)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(pts), sub)
        ka, kb, kp = jax.random.split(sub, 3)
        pairs = _t(jax.random.choice(kp, 64, (24,), replace=False))
        params, popt, loss = step(params, popt, _t(pts), _jax_view(ka, 2), _jax_view(kb, 2),
                                  pairs)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL, atol=LOSS_RTOL)
        trees_close(params, jparams, "pretrain step")
