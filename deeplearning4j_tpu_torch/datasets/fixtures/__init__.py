"""Loaders for the bundled real-data fixtures (see README.md here).

A copy of ``deeplearning4j_tpu/datasets/fixtures/__init__.py`` that
reads the fixture files where they lie, in that package's directory, by
path (nothing of that package is imported, and no file is copied).

Accuracy gates should run on REAL data when possible, synthetic
fallback otherwise. These loaders provide three
real datasets on a zero-egress machine:

- ``mnist200_datasets()`` — 200 real MNIST digits (reference fixture
  mnist_first_200.txt, converted to IDX; reference parses the same
  pixels via datasets/mnist/MnistImageFile.java).
- ``raw_sentences()`` — 97k real English sentences (reference fixture
  raw_sentences.txt, the Word2VecTests corpus).
- ``digits_dataset()`` — sklearn's 1,797 real 8x8 handwritten digits.

Real image pixels for the CNN/ingestion paths):

- ``lfw_fixture_dir()`` — a REAL LFW subset (4 photos, 2 people), the
  same fixture tree the reference bundles
  (dl4j-test-resources/src/main/resources/lfwtest).
- ``real_patches_cifar()`` — 200 real-photograph 32x32 patches in the
  exact CIFAR-10 binary on-disk format (see
  scripts/make_image_fixtures.py for provenance).
"""

from __future__ import annotations

import gzip
import os
from typing import List, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

#: the fixture files, in the JAX package's tree
_HERE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "deeplearning4j_tpu", "datasets", "fixtures")


def _split(feats, onehot, n_test, seed):
    """Seeded shuffle -> (train, test) DataSets (shared by every
    fixture loader so split semantics cannot diverge)."""
    order = np.random.default_rng(seed).permutation(feats.shape[0])
    tr, te = order[n_test:], order[:n_test]
    return (DataSet(feats[tr], onehot[tr]),
            DataSet(feats[te], onehot[te]))


def mnist200_datasets(n_test: int = 40, seed: int = 0
                      ) -> Tuple[DataSet, DataSet]:
    """(train, test) split of the 200 bundled REAL MNIST digits.

    Features are flat [N, 784] in [0, 1]; labels one-hot [N, 10]. The
    split is a seeded shuffle so train/test class mixes stay stable.
    """
    from deeplearning4j_tpu_torch.datasets.mnist import read_idx

    imgs = read_idx(os.path.join(_HERE, "mnist200-images-idx3-ubyte.gz"))
    labels = read_idx(os.path.join(_HERE, "mnist200-labels-idx1-ubyte.gz"))
    n = imgs.shape[0]
    feats = imgs.reshape(n, -1).astype(np.float32) / 255.0
    onehot = np.eye(10, dtype=np.float32)[labels]
    return _split(feats, onehot, n_test, seed)


def lfw_fixture_dir() -> str:
    """Root of the bundled real LFW subset (class-per-subdirectory jpg
    tree: 2 people, 4 images) — feed to ``load_lfw(root=...)``."""
    return os.path.join(_HERE, "lfw")


def real_patches_cifar(n_test: int = 40, seed: int = 0
                       ) -> Tuple[DataSet, DataSet]:
    """(train, test) split of 200 REAL 32x32 photograph patches stored
    in CIFAR-10 binary format (2 classes: which photo the patch came
    from). Decodes through the same native/numpy CIFAR parser as
    ``load_cifar``; features [N, 3, 32, 32] in [0, 1], labels one-hot
    [N, 2]."""
    from deeplearning4j_tpu_torch.native_rt import read_cifar_bin, u8_to_f32

    imgs, labels = read_cifar_bin(
        os.path.join(_HERE, "real_patches_batch.bin"))
    feats = u8_to_f32(imgs)
    onehot = np.eye(2, dtype=np.float32)[labels]
    return _split(feats, onehot, n_test, seed)


def raw_sentences(limit: int = None) -> List[str]:
    """The bundled real-English corpus, one sentence per string."""
    path = os.path.join(_HERE, "raw_sentences.txt.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln]
    return lines[:limit] if limit else lines


def digits_dataset(n_test: int = 360, seed: int = 0
                   ) -> Tuple[DataSet, DataSet]:
    """(train, test) split of sklearn's real 8x8 handwritten digits.

    Features [N, 64] scaled to [0, 1]; labels one-hot [N, 10]. 1,797
    real examples — large enough for a statistically meaningful
    held-out accuracy gate (360 test examples -> ~0.3% granularity).
    """
    from sklearn.datasets import load_digits

    d = load_digits()
    feats = (d.data / 16.0).astype(np.float32)
    onehot = np.eye(10, dtype=np.float32)[d.target]
    return _split(feats, onehot, n_test, seed)
