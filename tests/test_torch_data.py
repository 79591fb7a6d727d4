"""The port's ``data/`` package against the JAX package's, on synthetic files.

Every dataset class, the readers, the augmentations, the loader and
``prefetch_to_device`` (on the CPU) of ``diffuvolume_tpu_torch.data`` read
the same files written here (PNG, PFM, KITTI 16-bit PNG, Sintel's split
channels, FallingThings' depth with its camera file, TartanAir's ``.npy``)
and must give arrays equal to the JAX package's, including seeded
training-mode samples through the augmentations.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import diffuvolume_tpu.data.augment as j_aug
import diffuvolume_tpu.data.kitti as j_kitti
import diffuvolume_tpu.data.loader as j_loader
import diffuvolume_tpu.data.readers as j_readers
import diffuvolume_tpu.data.sceneflow as j_sf
import diffuvolume_tpu.data.zoo as j_zoo
import diffuvolume_tpu_torch.data.augment as t_aug
import diffuvolume_tpu_torch.data.kitti as t_kitti
import diffuvolume_tpu_torch.data.loader as t_loader
import diffuvolume_tpu_torch.data.readers as t_readers
import diffuvolume_tpu_torch.data.sceneflow as t_sf
import diffuvolume_tpu_torch.data.zoo as t_zoo

RNG = np.random.default_rng(1111)


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _rgb(h, w):
    return RNG.integers(0, 255, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One directory per dataset, in each dataset's own layout."""
    root = tmp_path_factory.mktemp("zoo")
    # SceneFlow (the layout tests/test_integration_cli.py writes)
    sf = root / "sceneflow"
    for scene in ("A/0000", "A/0001"):
        for frame in ("0006", "0007"):
            img = _rgb(72, 112)
            _png(str(sf / "frames_finalpass/TEST" / scene / "left" / f"{frame}.png"), img)
            _png(str(sf / "frames_finalpass/TEST" / scene / "right" / f"{frame}.png"),
                 np.roll(img, -3, axis=1))
            os.makedirs(sf / "disparity/TEST" / scene / "left", exist_ok=True)
            j_readers.write_pfm(str(sf / "disparity/TEST" / scene / "left" / f"{frame}.pfm"),
                                RNG.uniform(0.0, 40.0, (72, 112)).astype(np.float32))
    # KITTI (list-file driven, uint16 disparity PNGs)
    kt = root / "kitti"
    lines = []
    for i in range(3):
        _png(str(kt / "image_2" / f"{i:06d}_10.png"), _rgb(40, 60))
        _png(str(kt / "image_3" / f"{i:06d}_10.png"), _rgb(40, 60))
        d = (RNG.uniform(0, 60, (40, 60)) * 256).astype(np.uint16)
        d[RNG.uniform(size=d.shape) < 0.3] = 0
        Image.fromarray(d).save(kt / f"disp_{i}.png")
        lines.append(f"image_2/{i:06d}_10.png image_3/{i:06d}_10.png disp_{i}.png")
    (kt / "list.txt").write_text("\n".join(lines) + "\n")
    (kt / "list_test.txt").write_text(
        "\n".join(" ".join(ln.split()[:2]) for ln in lines) + "\n")
    # ETH3D
    eth = root / "eth3d"
    _png(str(eth / "two_view_training/s1/im0.png"), _rgb(12, 16))
    _png(str(eth / "two_view_training/s1/im1.png"), _rgb(12, 16))
    os.makedirs(eth / "two_view_training_gt/s1")
    j_readers.write_pfm(str(eth / "two_view_training_gt/s1/disp0GT.pfm"),
                        RNG.uniform(1, 700, (12, 16)).astype(np.float32))
    nocc = np.full((12, 16), 255, np.uint8)
    nocc[3:6] = 0
    _png(str(eth / "two_view_training_gt/s1/mask0nocc.png"), nocc)
    # Middlebury (one scene with a nocc mask and an unknown pixel, one without)
    mid = root / "middlebury"
    for scene, with_mask in (("s1", True), ("s2", False)):
        _png(str(mid / "MidH" / scene / "im0.png"), _rgb(16, 20))
        _png(str(mid / "MidH" / scene / "im1.png"), _rgb(16, 20))
        disp = RNG.uniform(1, 30, (16, 20)).astype(np.float32)
        disp[0, 0] = np.inf
        j_readers.write_pfm(str(mid / "MidH" / scene / "disp0GT.pfm"), disp)
        if with_mask:
            m = np.full((16, 20), 255, np.uint8)
            m[:, :5] = 128
            _png(str(mid / "MidH" / scene / "mask0nocc.png"), m)
    # Sintel (clean and final passes, split-channel disparity, occlusions)
    sin = root / "sintel"
    for p in ("clean", "final"):
        _png(str(sin / f"training/{p}_left/alley/frame_0001.png"), _rgb(10, 14))
        _png(str(sin / f"training/{p}_right/alley/frame_0001.png"), _rgb(10, 14))
    _png(str(sin / "training/disparities/alley/frame_0001.png"), _rgb(10, 14))
    occ = np.where(RNG.uniform(size=(10, 14)) < 0.2, 255, 0).astype(np.uint8)
    _png(str(sin / "training/occlusions/alley/frame_0001.png"), occ)
    # FallingThings (manifest, JPEG images, depth PNG with the camera's fx)
    ft = root / "fallingthings"
    os.makedirs(ft / "mixed/kitchen")
    for eye in ("left", "right"):
        Image.fromarray(_rgb(10, 14)).save(ft / f"mixed/kitchen/0001.{eye}.jpg")
    depth = RNG.integers(0, 5000, (10, 14)).astype(np.uint16)
    Image.fromarray(depth).save(ft / "mixed/kitchen/0001.left.depth.png")
    (ft / "mixed/kitchen/_camera_settings.json").write_text(json.dumps(
        {"camera_settings": [{"intrinsic_settings": {"fx": 768.16}}]}))
    (ft / "filenames.txt").write_text("mixed/kitchen/0001.left.jpg\n")
    # TartanAir (manifest, .npy depth)
    ta = root / "tartanair"
    names = []
    for k, scene in enumerate(("abandonedfactory/Easy/P000", "ocean/Hard/P001")):
        _png(str(ta / scene / f"image_left/00000{k}_left.png"), _rgb(10, 14))
        _png(str(ta / scene / f"image_right/00000{k}_right.png"), _rgb(10, 14))
        os.makedirs(ta / scene / "depth_left", exist_ok=True)
        dep = RNG.uniform(0.5, 50, (10, 14)).astype(np.float32)
        dep[0, :3] = 0.0
        np.save(ta / scene / f"depth_left/00000{k}_left_depth.npy", dep)
        names.append(f"{scene}/image_left/00000{k}_left.png")
    (ta / "tartanair_filenames.txt").write_text("\n".join(names) + "\n")
    return root


def assert_same_sample(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.fixture
def small_crops(monkeypatch):
    for mod in (j_sf, t_sf):
        monkeypatch.setattr(mod.SceneFlowDataset, "TEST_CROP", (64, 96))
        monkeypatch.setattr(mod.SceneFlowDataset, "TRAIN_CROP", (32, 48))
    for mod in (j_kitti, t_kitti):
        monkeypatch.setattr(mod.KITTIDataset, "TEST_PAD", (48, 64))
        monkeypatch.setattr(mod.KITTIDataset, "TRAIN_CROP", (32, 48))


@pytest.mark.parametrize("training", [False, True])
def test_sceneflow_dataset_matches_jax(tree, small_crops, training):
    """Test mode: the bottom-right TEST_CROP; training mode: seeded random
    crops, the same draws."""
    kw = dict(training=training, seed=7)
    t = t_sf.SceneFlowDataset(str(tree / "sceneflow"), **kw)
    j = j_sf.SceneFlowDataset(str(tree / "sceneflow"), **kw)
    assert t.samples == j.samples and len(t) == 4
    for i in range(len(t)):
        assert_same_sample(t[i], j[i])
    for bt, bj in zip(t.batches(2), j.batches(2)):
        assert_same_sample(bt, bj)


@pytest.mark.parametrize("training", [False, True])
def test_kitti_dataset_matches_jax(tree, small_crops, training):
    """Test mode pads to TEST_PAD (top / right); training mode runs the
    photometric jitter, the random crop and the occlusion patch from the
    seeded generator: equal arrays, sample by sample."""
    path = str(tree / "kitti")
    t = t_kitti.KITTIDataset(path, str(tree / "kitti/list.txt"), training=training, seed=3)
    j = j_kitti.KITTIDataset(path, str(tree / "kitti/list.txt"), training=training, seed=3)
    for _ in range(2):  # the second epoch draws on from where the first stopped
        for i in range(len(t)):
            assert_same_sample(t[i], j[i])
    if not training:
        t = t_kitti.KITTIDataset(path, str(tree / "kitti/list_test.txt"))
        j = j_kitti.KITTIDataset(path, str(tree / "kitti/list_test.txt"))
        assert_same_sample(t[1], j[1])
        assert "disp_gt" not in t[1]


@pytest.mark.parametrize("name,sub,kw", [
    ("sceneflow", "sceneflow", {}),
    ("kitti15", "kitti", {"list_filename": "list.txt"}),
    ("eth3d", "eth3d", {}),
    ("middleburyH", "middlebury", {}),
    ("sintel", "sintel", {}),
    ("fallingthings", "fallingthings", {}),
    ("tartanair", "tartanair", {}),
    ("tartanair", "tartanair", {"keywords": ("ocean",)}),
])
def test_fetch_dataset_matches_jax(tree, small_crops, name, sub, kw):
    """Every dataset the zoo names: the same samples, in the same order."""
    if "list_filename" in kw:
        kw = {"list_filename": str(tree / sub / kw["list_filename"])}
    t = t_zoo.fetch_dataset(name, str(tree / sub), **kw)
    j = j_zoo.fetch_dataset(name, str(tree / sub), **kw)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        assert_same_sample(t[i], j[i])


def test_concat_dataset_matches_jax(tree, small_crops):
    parts = [(str(tree / "sintel"), 2), (str(tree / "tartanair"), 1)]
    t = t_zoo.ConcatDataset([(t_zoo.fetch_dataset(n, p), r)
                             for n, (p, r) in zip(("sintel", "tartanair"), parts)])
    j = j_zoo.ConcatDataset([(j_zoo.fetch_dataset(n, p), r)
                             for n, (p, r) in zip(("sintel", "tartanair"), parts)])
    assert len(t) == len(j) == 2 * 2 + 2
    for i in range(len(t)):
        assert_same_sample(t[i], j[i])
    with pytest.raises(IndexError):
        t[len(t)]


def test_readers_match_jax(tree, tmp_path):
    """PFM both ways (grey and colour), KITTI 16-bit PNG, images, .flo, and
    the generic reader."""
    grey = RNG.uniform(-5, 5, (7, 9)).astype(np.float32)
    colour = RNG.uniform(-5, 5, (7, 9, 3)).astype(np.float32)
    for k, arr in enumerate((grey, colour)):
        t_readers.write_pfm(str(tmp_path / f"t{k}.pfm"), arr, scale=2.0)
        j_readers.write_pfm(str(tmp_path / f"j{k}.pfm"), arr, scale=2.0)
        assert (tmp_path / f"t{k}.pfm").read_bytes() == (tmp_path / f"j{k}.pfm").read_bytes()
        got, scale = t_readers.read_pfm(str(tmp_path / f"t{k}.pfm"))
        np.testing.assert_array_equal(got, arr)
        assert scale == 2.0
    flow = RNG.uniform(-3, 3, (5, 6, 2)).astype(np.float32)
    t_readers.write_flo(str(tmp_path / "f.flo"), flow)
    for path in (tmp_path / "f.flo", tmp_path / "t0.pfm", tmp_path / "t1.pfm",
                 tree / "kitti/image_2/000000_10.png"):
        np.testing.assert_array_equal(t_readers.read_gen(str(path)),
                                      j_readers.read_gen(str(path)))
    np.testing.assert_array_equal(t_readers.read_kitti_disparity(str(tree / "kitti/disp_0.png")),
                                  j_readers.read_kitti_disparity(str(tree / "kitti/disp_0.png")))
    with pytest.raises(ValueError):
        t_readers.read_gen(str(tmp_path / "x.tif"))


def test_augmentors_match_jax():
    """The KITTI15 augmentors, dense and sparse, with every option on, draw
    for draw from one seed."""
    g = np.random.default_rng(5)
    img1 = g.uniform(0, 255, (48, 96, 3)).astype(np.float32)
    img2 = g.uniform(0, 255, (48, 96, 3)).astype(np.float32)
    disp = g.uniform(1, 20, (48, 96)).astype(np.float32)
    valid = (g.uniform(size=(48, 96)) < 0.3).astype(np.float32)
    sparse = disp * valid
    for flip in (False, "h", "hf", "v"):
        dense_kw = dict(do_flip=flip, yjitter=True, saturation_range=[0.6, 1.4], gamma=[1, 1, 1, 1])
        outs = [m.FlowAugmentor((32, 64), **dense_kw)(img1, img2, disp,
                                                      np.random.default_rng(9))
                for m in (t_aug, j_aug)]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        outs = [m.SparseFlowAugmentor((32, 64), do_flip=flip, yjitter=True)(
            img1, img2, sparse, valid, np.random.default_rng(9)) for m in (t_aug, j_aug)]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    outs = [m.scale_co_transform(img1, img2, disp, 0.7) for m in (t_aug, j_aug)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_aug.random_vdisp(img2, np.random.default_rng(2)),
                                  j_aug.random_vdisp(img2, np.random.default_rng(2)))


def test_loader_matches_jax_and_prefetch_on_the_cpu(tree, small_crops):
    """The parallel loader over a training-mode SceneFlow set gives the JAX
    loader's batches (reseeded replicas); ``prefetch_to_device`` on the CPU
    hands them over as equal tensors, file names as they are."""
    kw = dict(batch_size=2, shuffle=True, num_workers=2, seed=4)
    t = t_loader.DataLoader(t_sf.SceneFlowDataset(str(tree / "sceneflow"), training=True), **kw)
    j = j_loader.DataLoader(j_sf.SceneFlowDataset(str(tree / "sceneflow"), training=True), **kw)
    t_batches, j_batches = list(t), list(j)
    assert len(t_batches) == len(j_batches) == len(t) == 2
    for bt, bj in zip(t_batches, j_batches):
        assert_same_sample(bt, bj)
    moved = list(t_loader.prefetch_to_device(iter(t_batches), device="cpu", size=1))
    assert len(moved) == 2
    for m, b in zip(moved, t_batches):
        assert m["filename"] == b["filename"]
        for k in ("left", "right", "disp_gt"):
            assert isinstance(m[k], torch.Tensor) and m[k].device.type == "cpu"
            np.testing.assert_array_equal(m[k].numpy(), b[k])
    with pytest.raises(ValueError):
        t_loader.DataLoader(t_sf.SceneFlowDataset(str(tree / "sceneflow")), batch_size=0)
