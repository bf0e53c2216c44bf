"""Built-in dataset fetchers: CIFAR-10, LFW, Curves.

Mirror of reference datasets/fetchers + iterator/impl
(CifarDataSetIterator, LFWDataSetIterator, CurvesDataSetIterator;
SURVEY.md §2.4). The reference downloads at fetch time; this environment
has no egress, so each fetcher reads local files from
``$DL4J_TPU_DATA_DIR`` when present and otherwise generates a
deterministic learnable synthetic stand-in with identical shapes/classes
(same pattern as datasets/mnist.py).

A copy of ``deeplearning4j_tpu/datasets/fetchers.py`` (numpy only), imports
rewritten to this package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import BaseDataSetIterator
from deeplearning4j_tpu_torch.datasets.mnist import _data_dir

CIFAR_CLASSES = 10
CIFAR_SHAPE = (3, 32, 32)
LFW_DEFAULT_SHAPE = (1, 28, 28)  # reference test subset uses small crops


# ---------------------------------------------------------------------------
# CIFAR-10
# ---------------------------------------------------------------------------

def _read_cifar_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary batch: rows of [label u8][3072 pixel u8].
    Decodes through the native runtime (dl4j_read_cifar_bin) with a
    numpy fallback — both live in native_rt.read_cifar_bin."""
    from deeplearning4j_tpu_torch.native_rt import read_cifar_bin

    return read_cifar_bin(path)


def _synthetic_images(n: int, shape, num_classes: int, seed: int,
                      train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional low-frequency color patterns + noise, learnable
    by a small CNN — same role as mnist._synthetic_mnist."""
    c, h, w = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / (h - 1), xx / (w - 1)
    glyphs = np.zeros((num_classes, c, h, w), np.float32)
    for cls in range(num_classes):
        for ch in range(c):
            coeff = rng.normal(size=(2, 2))
            g = np.zeros((h, w), np.float32)
            for i in range(2):
                for j in range(2):
                    g += coeff[i, j] * np.sin(
                        np.pi * (i + 1) * yy + 0.4 * cls
                    ) * np.sin(np.pi * (j + 1) * xx + 0.2 * ch)
            glyphs[cls, ch] = (g - g.min()) / (g.max() - g.min() + 1e-8)
    srng = np.random.default_rng(seed + (1 if train else 2))
    labels = srng.integers(0, num_classes, size=n)
    shifts = srng.integers(-2, 3, size=(n, 2))
    noise = srng.normal(0, 0.1, size=(n, c, h, w)).astype(np.float32)
    imgs = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        g = np.roll(glyphs[labels[i]], tuple(shifts[i]), axis=(1, 2))
        imgs[i] = np.clip(g + noise[i], 0.0, 1.0)
    return (imgs * 255).astype(np.uint8), labels.astype(np.uint8)


def load_cifar(train: bool = True,
               num_examples: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images u8 [N,3,32,32], labels u8 [N])."""
    root = os.path.join(_data_dir(), "cifar-10-batches-bin")
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [os.path.join(root, n) for n in names]
    present = [p for p in paths if os.path.exists(p)]
    if len(present) == len(paths):
        parts = [_read_cifar_bin(p) for p in paths]
        imgs = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
    else:
        if present:  # partial real data is indistinguishable from success
            raise FileNotFoundError(
                f"CIFAR dir {root} is missing "
                f"{sorted(set(paths) - set(present))} — refusing to "
                "silently substitute synthetic data; delete the dir to "
                "opt into the synthetic fallback")
        imgs, labels = _synthetic_images(
            num_examples or (50000 if train else 10000), CIFAR_SHAPE,
            CIFAR_CLASSES, seed=11, train=train)
    if num_examples is not None:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels


class CifarDataSetIterator(BaseDataSetIterator):
    """Reference datasets/iterator/impl/CifarDataSetIterator.java."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, flatten: bool = False):
        from deeplearning4j_tpu_torch.native_rt import one_hot, u8_to_f32

        imgs, labels = load_cifar(train, num_examples)
        x = u8_to_f32(imgs)
        if flatten:
            x = x.reshape(len(x), -1)
        y = one_hot(labels.astype(int), CIFAR_CLASSES)
        super().__init__(batch_size, DataSet(x, y))


# ---------------------------------------------------------------------------
# LFW (faces)
# ---------------------------------------------------------------------------

def _resize_nchw(imgs: np.ndarray, shape) -> np.ndarray:
    """Resize u8 [N,C,H,W] to (c,h,w), matching the PIL reader's
    semantics (convert('L'/'RGB') + default resize filter) so native
    and PIL load_lfw paths yield identical pixels for the same tree;
    numpy nearest-neighbor + ITU-R 601 luma fallback without PIL."""
    c, h, w = shape
    n, ic, ih, iw = imgs.shape
    if (ic, ih, iw) == (c, h, w):
        return imgs
    try:
        from PIL import Image
    except ImportError:
        ri = (np.arange(h) * ih // h)
        ci = (np.arange(w) * iw // w)
        out = imgs[:, :, ri[:, None], ci[None, :]]
        if ic != c:
            if c == 1:  # ITU-R 601 luma, like PIL convert("L")
                wts = (np.array([0.299, 0.587, 0.114], np.float32)
                       if ic == 3 else np.full(ic, 1.0 / ic, np.float32))
                out = (np.tensordot(out.astype(np.float32), wts,
                                    axes=([1], [0]))[:, None]
                       ).astype(np.uint8)
            else:
                out = np.repeat(out[:, :1], c, axis=1)
        return out
    mode = "L" if c == 1 else "RGB"
    res = np.empty((n, c, h, w), np.uint8)
    for i in range(n):
        img = Image.fromarray(
            imgs[i, 0] if ic == 1 else imgs[i].transpose(1, 2, 0))
        img = img.convert(mode).resize((w, h))
        arr = np.asarray(img, np.uint8)
        res[i] = arr[None] if c == 1 else arr.transpose(2, 0, 1)
    return res


def load_lfw(num_examples: Optional[int] = None, num_people: int = 5,
             image_shape=LFW_DEFAULT_SHAPE,
             root: Optional[str] = None
             ) -> Tuple[np.ndarray, np.ndarray, list]:
    """-> (images u8 [N,C,H,W], labels u8 [N], person_names). Reads a
    class-per-subdirectory image tree (the reference's unpacked LFW
    layout, datasets/fetchers/LFWDataFetcher.java) at ``root`` or
    $DL4J_TPU_DATA_DIR/lfw when present, else synthesizes. Netpbm trees
    decode through the native runtime (dl4j_read_image_dir); JPEG/PNG
    trees through PIL."""
    root = root or os.path.join(_data_dir(), "lfw")
    if os.path.isdir(root):
        from deeplearning4j_tpu_torch.native_rt import read_image_dir

        native = read_image_dir(root)
        if native is not None:
            imgs, labels = native
            # same enumeration rule as the native reader: sorted,
            # hidden ('.'-prefixed) directories skipped — labels and
            # names stay aligned
            names = sorted(d for d in os.listdir(root)
                           if not d.startswith(".")
                           and os.path.isdir(os.path.join(root, d)))
            keep = labels < num_people
            imgs, labels = imgs[keep], labels[keep]
            names = names[:num_people]
            imgs = _resize_nchw(imgs, image_shape)
            if num_examples is not None:
                imgs, labels = imgs[:num_examples], labels[:num_examples]
            return imgs, labels.astype(np.uint8), names

        from PIL import Image

        c, h, w = image_shape
        mode = "L" if c == 1 else "RGB"
        # same enumeration rule as the native reader (hidden dirs
        # skipped) so the two paths assign identical labels
        names = sorted(d for d in os.listdir(root)
                       if not d.startswith(".")
                       and os.path.isdir(os.path.join(root, d))
                       )[:num_people]
        img_list, lbl_list = [], []
        for li, name in enumerate(names):
            folder = os.path.join(root, name)
            for fn in sorted(os.listdir(folder)):
                if os.path.splitext(fn)[1].lower() not in (
                        ".png", ".jpg", ".jpeg", ".bmp",
                        ".ppm", ".pgm", ".pnm"):
                    continue
                img = Image.open(os.path.join(folder, fn)) \
                    .convert(mode).resize((w, h))
                arr = np.asarray(img, np.uint8)
                if c == 1:
                    arr = arr[None, :, :]
                else:
                    arr = arr.transpose(2, 0, 1)
                img_list.append(arr)
                lbl_list.append(li)
        if not img_list:
            raise FileNotFoundError(
                f"LFW dir {root} exists but holds no readable images "
                "(.png/.jpg/.jpeg/.bmp under class subdirectories); "
                "delete the dir to opt into the synthetic fallback")
        imgs = np.stack(img_list)
        labels = np.asarray(lbl_list, np.uint8)
    else:
        imgs, labels = _synthetic_images(
            num_examples or 400, image_shape, num_people, seed=23,
            train=True)
        names = [f"person_{i}" for i in range(num_people)]
    if num_examples is not None:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels, names


class LFWDataSetIterator(BaseDataSetIterator):
    """Reference datasets/iterator/impl/LFWDataSetIterator.java."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 num_people: int = 5, flatten: bool = True):
        from deeplearning4j_tpu_torch.native_rt import one_hot, u8_to_f32

        imgs, labels, self.names = load_lfw(num_examples, num_people)
        x = u8_to_f32(imgs)
        if flatten:
            x = x.reshape(len(x), -1)
        y = one_hot(labels.astype(int), len(self.names))
        super().__init__(batch_size, DataSet(x, y))


# ---------------------------------------------------------------------------
# Curves (the reference's pretraining benchmark dataset)
# ---------------------------------------------------------------------------

def curves_dataset(n: int = 1000, dim: int = 784,
                   seed: int = 17) -> DataSet:
    """Synthetic 'curves' images (random smooth 1-pixel curves rendered
    into dim=28x28 frames) — unsupervised reconstruction data, labels =
    features like the reference's CurvesDataFetcher."""
    side = int(np.sqrt(dim))
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, side, side), np.float32)
    t = np.linspace(0, 1, side * 4)
    for i in range(n):
        # random cubic Bezier control points
        pts = rng.uniform(0, side - 1, size=(4, 2))
        curve = ((1 - t)[:, None] ** 3 * pts[0]
                 + 3 * (1 - t)[:, None] ** 2 * t[:, None] * pts[1]
                 + 3 * (1 - t)[:, None] * t[:, None] ** 2 * pts[2]
                 + t[:, None] ** 3 * pts[3])
        xs = np.clip(curve[:, 0].round().astype(int), 0, side - 1)
        ys = np.clip(curve[:, 1].round().astype(int), 0, side - 1)
        imgs[i, ys, xs] = 1.0
    flat = imgs.reshape(n, -1)
    return DataSet(flat, flat.copy())


class CurvesDataSetIterator(BaseDataSetIterator):
    """Reference datasets/iterator/impl/CurvesDataSetIterator.java."""

    def __init__(self, batch_size: int, num_examples: int = 1000):
        super().__init__(batch_size, curves_dataset(num_examples))


class MovingWindowDataSetFetcher:
    """Slide a window over each image of a DataSet, every window becoming
    one example with its source image's label (reference
    datasets/iterator/impl/MovingWindowDataSetFetcher.java over
    MovingWindowMatrix).
    """

    def __init__(self, data, window_rows: int, window_cols: int,
                 rotate: int = 0):
        from deeplearning4j_tpu_torch.util.moving_window import (
            moving_window_matrices,
        )

        feats, labels = [], []
        x = np.asarray(data.features)
        y = np.asarray(data.labels)
        if x.ndim == 2:  # flat rows: assume square images
            side = int(np.sqrt(x.shape[1]))
            x = x.reshape(x.shape[0], side, side)
        elif x.ndim == 4:  # NCHW: first channel
            x = x[:, 0]
        for i in range(x.shape[0]):
            for w in moving_window_matrices(x[i], window_rows, window_cols,
                                            rotate):
                feats.append(w.ravel())
                labels.append(y[i])
        self.features = np.asarray(feats, dtype=np.float32)
        self.labels = np.asarray(labels, dtype=np.float32)

    def fetch(self):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        return DataSet(self.features, self.labels)

    def iterator(self, batch_size: int):
        return BaseDataSetIterator(batch_size, self.fetch())
