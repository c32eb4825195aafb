"""The port's ``vision.transforms`` and ``vision.datasets`` against the
JAX package's, on the same seeded numpy inputs.

``Resize`` is held to ``jax.image.resize(..., "bilinear")`` (antialiased
when it downsamples) at 1e-5, both ways at ImageNet's 224 <-> 256 and at
odd sizes and layouts; the random transforms draw from numpy's global
state in both packages, so one seed gives equal outputs bit for bit;
the synthetic datasets are equal bit for bit.  The JAX package has no
tests of these modules: these are the first to run them."""
import numpy as np
import pytest

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as jtf

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.vision.datasets as tds
import paddle_tpu_torch.vision.transforms as ttf

tpaddle.set_device("cpu")


def img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


RESIZES = [((3, 224, 224), 256), ((3, 256, 256), 224),
           ((3, 31, 47), (20, 60)), ((1, 28, 28), 64), ((4, 50, 50), 7),
           ((40, 33), 17), ((17, 40, 3), (50, 9)), ((64, 64, 1), 32)]


@pytest.mark.parametrize("shape,size", RESIZES,
                         ids=[f"{s}->{z}" for s, z in RESIZES])
def test_resize_matches_jax_image_resize(shape, size):
    x = img(shape)
    want = np.asarray(jtf.Resize(size)(x))
    got = ttf.Resize(size)(x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_resize_is_exact_on_constant_and_identity():
    x = np.full((3, 40, 40), 0.25, np.float32)
    np.testing.assert_allclose(ttf.Resize(23)(x), 0.25, atol=1e-6)
    y = img((3, 16, 16))
    np.testing.assert_array_equal(ttf.Resize(16)(y), y)


@pytest.mark.parametrize("name,args,shape", [
    ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.25, 0.3]), (3, 8, 9)),
    ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.25, 0.3], "HWC"), (8, 9, 3)),
    ("ToTensor", (), (8, 9, 3)),
    ("ToTensor", (), (8, 9)),
    ("ToTensor", ("HWC",), (8, 9, 3)),
    ("CenterCrop", (5,), (3, 12, 10)),
    ("CenterCrop", ((4, 6),), (12, 10, 3)),
    ("Transpose", (), (8, 9, 3)),
    ("Transpose", ((1, 0, 2),), (8, 9, 3)),
])
def test_deterministic_transforms_match_jax(name, args, shape):
    x = img(shape, 1)
    want = np.asarray(getattr(jtf, name)(*args)(x))
    got = getattr(ttf, name)(*args)(x)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("name,args,shape", [
    ("RandomCrop", (5,), (3, 12, 10)),
    ("RandomCrop", (8, 2), (12, 10, 3)),
    ("RandomCrop", (6, 1), (9, 9)),
    ("RandomHorizontalFlip", (), (3, 6, 7)),
    ("RandomHorizontalFlip", (0.5,), (6, 7)),
])
def test_random_transforms_match_jax_under_one_seed(name, args, shape):
    x = img(shape, 2)
    for seed in range(6):
        np.random.seed(seed)
        want = np.asarray(getattr(jtf, name)(*args)(x))
        np.random.seed(seed)
        got = getattr(ttf, name)(*args)(x)
        np.testing.assert_array_equal(got, want)


def test_compose_imagenet_pipeline_matches_jax():
    """Resize(256) -> CenterCrop(224) -> flip -> Normalize, the chip
    smoke's phase 21 (a) pipeline, at 1e-5 (Resize's tolerance)."""
    def make(tf):
        return tf.Compose([tf.Resize(256), tf.CenterCrop(224),
                           tf.RandomHorizontalFlip(),
                           tf.Normalize([0.485, 0.456, 0.406],
                                        [0.229, 0.224, 0.225])])

    x = img((3, 224, 224), 3)
    for seed in (0, 1, 2):
        np.random.seed(seed)
        want = np.asarray(make(jtf)(x))
        np.random.seed(seed)
        got = make(ttf)(x)
        assert got.shape == (3, 224, 224)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "Cifar10",
                                  "Cifar100", "FakeImageNet"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_datasets_equal_bit_for_bit(name, mode):
    kw = dict(mode=mode, size=12, seed=4)
    j, t = getattr(jds, name)(**kw), getattr(tds, name)(**kw)
    assert len(t) == len(j) == 12
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    x, y = t[5]
    assert x.shape == getattr(tds, name).SHAPE and y.dtype == np.int64


def test_dataset_transform_and_default_sizes():
    tf = lambda a: a * 2  # noqa: E731
    t = tds.FakeImageNet(transform=tf, seed=1)
    j = jds.FakeImageNet(transform=tf, seed=1)
    assert len(t) == len(j) == 256
    np.testing.assert_array_equal(t[3][0], j[3][0])
    assert len(tds.MNIST()) == 1024


def test_image_folder_reads_npy_like_jax(tmp_path):
    for d, n in (("cat", 2), ("dog", 3)):
        (tmp_path / d).mkdir()
        for i in range(n):
            np.save(tmp_path / d / f"{i}.npy", img((3, 4, 4), 10 + i))
    (tmp_path / "notes.txt").write_text("skip me")
    t = tds.ImageFolder(str(tmp_path), transform=ttf.Resize(6))
    j = jds.ImageFolder(str(tmp_path), transform=jtf.Resize(6))
    assert len(t) == len(j) == 5
    assert t.samples == j.samples
    for i in range(5):
        np.testing.assert_allclose(t[i][0], np.asarray(j[i][0]),
                                   atol=1e-5, rtol=1e-5)
