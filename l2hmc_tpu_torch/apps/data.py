"""MNIST data loading + binarization (the port's own copy of
``l2hmc_tpu/apps/data.py``: numpy only, and the numpy streams equal the JAX
package's for the same seed).

Nothing is downloaded; the loader resolves in order:
1. raw IDX files under ``$MNIST_DIR`` or common local paths,
2. ``mnist.npz`` (keras layout) under the same roots,
3. REAL handwritten digits from sklearn's bundled ``load_digits`` (the UCI
   optical-recognition set: 1,797 8x8 images shipped inside scikit-learn,
   no download), bilinearly upsampled to 28x28 — real data, but not MNIST;
   ``source`` records the provenance,
4. a deterministic synthetic stand-in ("blobs" of structured pixels) so the
   full VAE pipeline runs and tests stay hermetic. The synthetic set marks
   itself via ``is_synthetic`` so benchmarks can refuse to report on it.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct

import numpy as np

_SEARCH_ROOTS = (
    os.environ.get("MNIST_DIR", ""),
    "MNIST_data",
    os.path.expanduser("~/.keras/datasets"),
)


@dataclasses.dataclass(frozen=True)
class MnistData:
    train: np.ndarray  # (N, 784) float32 in [0, 1]
    test: np.ndarray  # (M, 784) float32 in [0, 1]
    is_synthetic: bool
    source: str = "mnist"  # data provenance for result artifacts


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx magic in {path}")
        data = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    return (data / 255.0).astype(np.float32)


def _try_idx(root: str):
    for train_name in ("train-images-idx3-ubyte", "train-images.idx3-ubyte"):
        for suffix in ("", ".gz"):
            tr = os.path.join(root, train_name + suffix)
            te = os.path.join(
                root, train_name.replace("train", "t10k") + suffix
            )
            if os.path.exists(tr) and os.path.exists(te):
                return _read_idx_images(tr), _read_idx_images(te)
    return None


def _try_npz(root: str):
    p = os.path.join(root, "mnist.npz")
    if os.path.exists(p):
        with np.load(p) as d:
            tr = d["x_train"].reshape(-1, 784) / 255.0
            te = d["x_test"].reshape(-1, 784) / 255.0
        return tr.astype(np.float32), te.astype(np.float32)
    return None


def synthetic_mnist(
    n_train: int = 4096, n_test: int = 1024, seed: int = 0
) -> MnistData:
    """Structured 28x28 'digit-like' blobs: a few gaussian strokes per image,
    giving the multi-modal, mostly-dark pixel statistics the VAE pipeline
    needs. Deterministic from seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)

    def batch(n):
        imgs = np.zeros((n, 28, 28), np.float32)
        n_strokes = rng.integers(2, 5, size=n)
        for i in range(n):
            for _ in range(n_strokes[i]):
                cx, cy = rng.uniform(6, 22, 2)
                sx, sy = rng.uniform(1.5, 4.0, 2)
                rho = rng.uniform(-0.6, 0.6)
                dx, dy = (xx - cx) / sx, (yy - cy) / sy
                blob = np.exp(-(dx**2 - 2 * rho * dx * dy + dy**2) / (2 * (1 - rho**2)))
                imgs[i] = np.maximum(imgs[i], blob)
        return imgs.reshape(n, 784).clip(0.0, 1.0)

    return MnistData(
        batch(n_train), batch(n_test), is_synthetic=True,
        source="synthetic-blobs",
    )


def real_digits(seed: int = 0) -> MnistData | None:
    """Real handwritten digits without network egress: sklearn's bundled
    UCI optical-recognition set (1,797 8x8 grayscale digits), bilinearly
    upsampled to the pipeline's 28x28 and split 80/20. Returns None when
    scikit-learn is unavailable. NOT MNIST — ``source`` says so — but real
    pen strokes, so VAE/sampler evidence on it exercises genuine
    multi-modal image statistics rather than synthetic blobs."""
    try:
        from scipy.ndimage import zoom
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    imgs = load_digits().images.astype(np.float32) / 16.0  # (1797, 8, 8)
    big = zoom(imgs, (1, 3.5, 3.5), order=1).clip(0.0, 1.0)  # (1797, 28, 28)
    flat = big.reshape(-1, 784)
    perm = np.random.default_rng(seed).permutation(flat.shape[0])
    n_train = int(flat.shape[0] * 0.8)
    return MnistData(
        flat[perm[:n_train]], flat[perm[n_train:]],
        is_synthetic=False, source="sklearn-digits-8x8-upsampled",
    )


def get_data(allow_synthetic: bool = True) -> MnistData:
    """Resolve MNIST from local files, else real digits, else synthetic."""
    for root in _SEARCH_ROOTS:
        if not root or not os.path.isdir(root):
            continue
        for loader in (_try_idx, _try_npz):
            got = loader(root)
            if got is not None:
                return MnistData(got[0], got[1], is_synthetic=False)
    digits = real_digits()
    if digits is not None:
        return digits
    if allow_synthetic:
        return synthetic_mnist()
    raise FileNotFoundError(
        "MNIST not found under MNIST_DIR or common paths, and synthetic "
        "fallback disabled"
    )


def binarize(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Stochastic binarization: pixel p becomes 1 with probability p."""
    if x.max() > 1.0:
        raise ValueError("binarize expects pixels in [0, 1]")
    return (rng.random(x.shape) < x).astype(np.float32)


def binarize_and_shuffle(
    rng: np.random.Generator, x: np.ndarray
) -> np.ndarray:
    """Shuffled stochastic binarization."""
    return binarize(rng, x[rng.permutation(x.shape[0])])
