"""The port's image-folder loader (data/image_folder.py) against the JAX
package's on JPEG / PNG trees the tests write. The port decodes through
Pillow only; cv2 imports here, so the reference is switched onto its PIL
branch, as tests/test_torch_codecs.py does. Eval decode is byte-equal;
training crops and flips are equal for the same numpy seed."""

import os

import numpy as np
import pytest

from metatransformer_tpu.data import image_folder as jif
from metatransformer_tpu_torch.data import image_folder

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


@pytest.fixture(autouse=True)
def reference_on_pil(monkeypatch):
    monkeypatch.setattr(jif, "_CV2", None)
    monkeypatch.setattr(jif, "_CV2_TRIED", True)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """2 classes x 4 images of distinct sizes (JPEG, PNG, a grey JPEG, a
    nested directory) plus a file that is not an image."""
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(0)
    sizes = [(64, 48), (48, 64), (80, 80), (33, 97)]
    for cls in ("cat", "dog"):
        d = root / cls
        (d / "sub").mkdir(parents=True)
        for i, (w, h) in enumerate(sizes):
            arr = rng.integers(0, 256, (h, w, 3), np.uint8)
            if i == 1:
                Image.fromarray(arr).save(d / f"{i}.png")
            elif i == 2:
                Image.fromarray(arr[..., 0]).save(d / "sub" / f"{i}.jpg", quality=90)
            else:
                Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
        (d / "notes.txt").write_text("not an image")
    return str(root)


def test_scan_and_manifest_match_jax(image_tree, tmp_path):
    got, want = image_folder.scan_image_folder(image_tree), jif.scan_image_folder(image_tree)
    assert got == want and got[1] == ["cat", "dog"] and len(got[0]) == 8
    man = tmp_path / "train.tsv"
    rel = [(os.path.relpath(p, tmp_path), l) for p, l in got[0]]
    man.write_text("# header\n\n" + "".join(f"{p}\t{l}\n" for p, l in rel))
    assert image_folder.read_manifest(str(man)) == jif.read_manifest(str(man))
    empty = tmp_path / "empty.tsv"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="empty manifest"):
        image_folder.read_manifest(str(empty))
    (tmp_path / "bare").mkdir()
    with pytest.raises(FileNotFoundError, match="no class subdirectories"):
        image_folder.scan_image_folder(str(tmp_path / "bare"))


@pytest.mark.parametrize("seed", range(6))
def test_random_resized_crop_box_matches_jax(seed):
    for w, h in ((64, 48), (500, 20), (20, 500), (7, 7)):
        a = image_folder._random_resized_crop_box(w, h, np.random.default_rng(seed))
        b = jif._random_resized_crop_box(w, h, np.random.default_rng(seed))
        assert a == b


@pytest.mark.parametrize("train", [False, True])
def test_decode_matches_jax_pil_branch(image_tree, train):
    samples, _ = image_folder.scan_image_folder(image_tree)
    for i, (path, _) in enumerate(samples):
        for size in (32, 40):
            got = image_folder.decode_image(path, size, train, np.random.default_rng(i))
            want = jif.decode_image(path, size, train, np.random.default_rng(i), backend="pil")
            assert got.shape == (size, size, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {size}")


@pytest.mark.parametrize("train", [False, True])
def test_loader_batches_match_jax(image_tree, train):
    kw = dict(batch_size=3, img_size=32, train=train, seed=5, workers=2)
    loader, jloader = image_folder.ImageFolderLoader(image_tree, **kw), \
        jif.ImageFolderLoader(image_tree, **kw)
    assert len(loader) == len(jloader) == 2
    for epoch in range(2):  # the shuffle and crop seeds go on across epochs
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["input"], b["input"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["input"].dtype == np.uint8 and a["label"].dtype == np.int64
    keep = image_folder.ImageFolderLoader(image_tree, **{**kw, "batch_size": 5}, drop_last=False)
    assert len(keep) == 2 and [len(b["label"]) for b in keep] == [5, 3]
