"""The port's point dataset loaders (data/point_datasets.py and
data/point_seg_datasets.py) against the JAX package's on files the tests
write (no dataset is in the repo): every loader, sampler and transform
gives the same arrays for the same files and numpy seeds, and importing
the port's copies imports no JAX module.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from metatransformer_tpu.data import point_datasets as jpd
from metatransformer_tpu.data import point_seg_datasets as jps
from metatransformer_tpu_torch.data import point_datasets as pd
from metatransformer_tpu_torch.data import point_seg_datasets as ps


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _both(name, *args, seed=None, **kw):
    """The port's and the reference's ``name`` on the same arguments (a
    fresh ``default_rng(seed)`` each where ``seed`` is given)."""
    out = []
    for mod in ((pd, jpd) if hasattr(pd, name) else (ps, jps)):
        extra = (np.random.default_rng(seed),) if seed is not None else ()
        out.append(getattr(mod, name)(*args, *extra, **kw))
    return out


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("modelnet")
    rng = np.random.default_rng(0)
    for split, shards in (("train", 2), ("test", 1)):
        for i in range(shards):
            with h5py.File(root / f"ply_data_{split}{i}.h5", "w") as f:
                f["data"] = rng.standard_normal((5, 40, 3)).astype(np.float32)
                f["label"] = rng.integers(0, 40, (5, 1))
    sdir = root / "main_split"
    sdir.mkdir()
    for name in ("training", "test"):
        with h5py.File(sdir / f"{name}_objectdataset_augmentedrot_scale75.h5", "w") as f:
            f["data"] = rng.standard_normal((4, 30, 3)).astype(np.float32)
            f["label"] = rng.integers(0, 15, 4)
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_modelnet40_and_scanobjectnn_h5_equal_jax(h5_root, split):
    got, want = _both("load_modelnet40_h5", h5_root, split)
    _equal(got, want)
    assert got[0].shape == ((10 if split == "train" else 5), 40, 3)
    _equal(*_both("load_scanobjectnn_h5", h5_root, split))
    with pytest.raises(FileNotFoundError):
        pd.load_modelnet40_h5(os.path.join(h5_root, "nowhere"), split)


@pytest.mark.parametrize("train", [True, False])
def test_point_batches_and_transforms_equal_jax(h5_root, train):
    pts, labels = pd.load_modelnet40_h5(h5_root, "train")
    cfg, jcfg = pd.PointDatasetConfig(npoints=32), jpd.PointDatasetConfig(npoints=32)
    got = pd.make_batches(pts, labels, cfg, 3, np.random.default_rng(1), train)
    want = jpd.make_batches(pts, labels, jcfg, 3, np.random.default_rng(1), train)
    _equal(got, want)
    assert len(got) == 3 and got[0]["points"].shape == (3, 32, 3)
    for name in ("random_scale", "random_translate", "random_point_dropout"):
        _equal(*_both(name, pts[0], seed=2))
    _equal(*_both("subsample", pts[0], 64, seed=3))  # more than there are: with replacement


@pytest.fixture(scope="module")
def s3dis_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3dis")
    rng = np.random.default_rng(4)
    for area, room in (("Area_1", "office_1"), ("Area_5", "hallway_2")):
        ann = root / area / room / "Annotations"
        ann.mkdir(parents=True)
        for cls in ("chair_1", "wall_2", "stairs_1"):  # stairs: not a class, clutter
            rows = np.concatenate([rng.uniform(0, 3, (50, 3)), rng.integers(0, 256, (50, 3))], 1)
            np.savetxt(ann / f"{cls}.txt", rows, fmt="%.4f")
    return str(root)


def test_s3dis_rooms_blocks_and_splits_equal_jax(s3dis_root):
    for split in ("train", "test"):
        got, want = _both("list_s3dis_rooms", s3dis_root, 5, split)
        assert got == want and len(got) == 1
    room = os.path.join(s3dis_root, "Area_1", "office_1")
    (pts, labels), want = _both("load_s3dis_room", room)
    _equal((pts, labels), want)
    classes = {ps.S3DIS_CLASSES.index(c) for c in ("chair", "wall", "clutter")}
    assert set(np.unique(labels)) == classes
    for n in (16, 400):  # fewer and more points than the block holds
        _equal(*_both("s3dis_block_sample", pts, labels, n, seed=5))


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapenetpart")
    rng = np.random.default_rng(6)
    entries = []
    for synset, sid in (("02691156", "a1"), ("03001627", "c7")):
        os.makedirs(root / synset)
        rows = np.concatenate([rng.standard_normal((30, 6)), rng.integers(0, 4, (30, 1))], 1)
        np.savetxt(root / synset / f"{sid}.txt", rows, fmt="%.5f")
        entries.append(f"shape_data/{synset}/{sid}")
    os.makedirs(root / "train_test_split")
    with open(root / "train_test_split" / "shuffled_train_file_list.json", "w") as f:
        json.dump(entries, f)
    return str(root)


def test_shapenetpart_split_and_samples_equal_jax(shapenet_root):
    got, want = _both("load_shapenetpart_split", shapenet_root, "train")
    assert got == want and len(got) == 2
    for synset, path in got:
        _equal(*_both("load_shapenetpart_file", path))
        for n in (20, 50):
            _equal(*_both("shapenetpart_sample", path, synset, n, seed=7))


def test_semantickitti_frames_and_labels_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    for seq, labelled in (("00", True), ("08", True), ("11", False)):
        vdir = tmp_path / "sequences" / seq / "velodyne"
        vdir.mkdir(parents=True)
        rng.standard_normal((25, 4)).astype(np.float32).tofile(vdir / "000000.bin")
        if labelled:
            ldir = tmp_path / "sequences" / seq / "labels"
            ldir.mkdir()
            raw = rng.choice(list(ps.SEMANTICKITTI_LEARNING_MAP), 25).astype(np.uint32)
            (raw | (rng.integers(0, 9, 25).astype(np.uint32) << 16)).tofile(ldir / "000000.label")
    for split in ("train", "valid", "test"):
        got, want = _both("list_semantickitti_frames", str(tmp_path), split)
        assert got == want and len(got) == 1
        scan, label = got[0]
        _equal(*_both("read_semantickitti_scan", scan))
        if label:
            _equal(*_both("read_semantickitti_label", label))
        else:
            assert split == "test"


def test_scannet_scene_and_samples_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    path = str(tmp_path / "scene0000_00.npz")
    np.savez(path, coords=rng.standard_normal((40, 3)), colors=rng.integers(0, 256, (40, 3)),
             labels=rng.integers(-1, 42, 40))
    scene, want = _both("load_scannet_scene", path)
    _equal(scene, want)
    assert scene["labels"].min() == -1
    for n in (10, 80):
        _equal(*_both("scannet_block_sample", scene, n, seed=10))
    _equal(*_both("scannet_remap_labels", np.arange(-2, 44)))


def test_importing_the_port_loaders_imports_no_jax():
    code = ("import sys; import metatransformer_tpu_torch.data.point_datasets, "
            "metatransformer_tpu_torch.data.point_seg_datasets; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'metatransformer_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
