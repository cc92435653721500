"""CIFAR-10 splits as host numpy arrays, NHWC (counterpart of the JAX
package's `data/cifar10.py`).

Sources, in order: ``{root}/cifar-10-batches-py/`` (the python pickle
batches), ``{root}/cifar10.npz``, or ``synthetic`` - a seeded,
class-structured stand-in (10 fixed class templates + noise) with CIFAR-10's
shapes. Nothing is downloaded. `make_synthetic` gives byte-identical arrays to
the JAX package's for the same seed. uint8 pixels are normalized by the
native kernels (`native/`: the pickle rows decoded and normalized in one
pass), as in the JAX package; `load_split(normalize_images=False)` keeps
them uint8 for host streaming (`data/stream.py`).
"""

from __future__ import annotations

import os
import pickle
import tarfile
from dataclasses import dataclass

import numpy as np

from .. import native

CIFAR10_MEAN = 0.5
CIFAR10_STD = 0.5
NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)
TRAIN_SIZE = 50_000
TEST_SIZE = 10_000


@dataclass(frozen=True)
class Split:
    """One split: images (N, 32, 32, 3) float32 in [-1, 1] (or raw uint8),
    labels (N,) int32, and the source name."""

    images: np.ndarray
    labels: np.ndarray
    source: str  # "pickle", "npz", or "synthetic"

    def __len__(self) -> int:
        return int(self.images.shape[0])


def normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 in [-1,1]: (x/255 - 0.5)/0.5. uint8 input
    runs through the native kernel (one pass); another dtype keeps the plain
    numpy math."""
    images_u8 = np.asarray(images_u8)
    if images_u8.dtype == np.uint8:
        return native.normalize_u8(images_u8, CIFAR10_MEAN, CIFAR10_STD)
    x = images_u8.astype(np.float32) / 255.0
    return (x - CIFAR10_MEAN) / CIFAR10_STD


def _load_pickle_batches(batch_dir: str, train: bool, normalize_images: bool):
    """The python batches as NHWC: normalized float32 (the plane-major rows
    decoded and normalized in one native pass) or raw uint8."""
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    imgs, labels = [], []
    for name in names:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        if normalize_images:
            imgs.append(native.cifar_decode_normalize(d[b"data"], CIFAR10_MEAN, CIFAR10_STD))
        else:
            imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(d[b"labels"], dtype=np.int32))
    return np.ascontiguousarray(np.concatenate(imgs)), np.concatenate(labels)


def _maybe_extract_tarball(root: str) -> None:
    batch_dir = os.path.join(root, "cifar-10-batches-py")
    tar = os.path.join(root, "cifar-10-python.tar.gz")
    if not os.path.isdir(batch_dir) and os.path.isfile(tar):
        with tarfile.open(tar, "r:gz") as tf:
            tf.extractall(root)  # noqa: S202 - trusted local archive


def make_synthetic(
    n: int, *, seed: int = 0, num_classes: int = NUM_CLASSES, train: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured synthetic CIFAR stand-in (uint8).

    Each class has a fixed low-frequency template (8x8 upsampled to 32x32);
    samples are template + Gaussian noise. Train and test share templates
    and draw from disjoint streams.
    """
    rng = np.random.default_rng(seed + (0 if train else 1_000_003))
    tmpl_rng = np.random.default_rng(seed)
    small = tmpl_rng.uniform(40.0, 215.0, size=(num_classes, 8, 8, 3))
    templates = np.repeat(np.repeat(small, 4, axis=1), 4, axis=2)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    noise = rng.normal(0.0, 32.0, size=(n, *IMAGE_SHAPE))
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels


def default_root() -> str:
    return os.environ.get("CIFAR10_DIR", os.path.join(os.getcwd(), "data"))


def load_split(
    train: bool,
    *,
    root: str | None = None,
    source: str = "auto",
    synthetic_size: int | None = None,
    seed: int = 0,
    normalize_images: bool = True,
) -> Split:
    """Load one CIFAR-10 split, normalized float32 by default.

    source: "auto" (real data if present, else synthetic), "pickle", "npz",
    or "synthetic". `normalize_images=False` keeps uint8 pixels where the
    source has them (host streaming normalizes each batch natively, and
    uint8 is a quarter of the host memory); a float npz is normalized
    regardless.
    """
    root = root or default_root()
    if source in ("auto", "pickle"):
        if os.path.isdir(root):
            _maybe_extract_tarball(root)
        batch_dir = os.path.join(root, "cifar-10-batches-py")
        if os.path.isdir(batch_dir):
            x, y = _load_pickle_batches(batch_dir, train, normalize_images)
            return Split(x, y, "pickle")
        if source == "pickle":
            raise FileNotFoundError(f"no cifar-10-batches-py under {root}")
    if source in ("auto", "npz"):
        npz = os.path.join(root, "cifar10.npz")
        if os.path.isfile(npz):
            d = np.load(npz)
            x = d["x_train"] if train else d["x_test"]
            y = d["y_train"] if train else d["y_test"]
            if normalize_images or x.dtype != np.uint8:
                x = normalize(x)
            return Split(x, y.reshape(-1).astype(np.int32), "npz")
        if source == "npz":
            raise FileNotFoundError(f"no cifar10.npz under {root}")
    n = synthetic_size or (TRAIN_SIZE if train else TEST_SIZE)
    x, y = make_synthetic(n, seed=seed, train=train)
    return Split(normalize(x) if normalize_images else x, y, "synthetic")
