"""The port's native host kernels (`distributed_neural_network_tpu_torch/native`)
against the JAX package's (`distributed_neural_network_tpu/native`): the two
sources are the same bytes, so on the same uint8 arrays the libraries give
the same bits (decode + normalize, normalize, gather + normalize, several
thread counts); each is held to its numpy version within the JAX parity
tests' 1e-6. The port builds into its own `_build/`, `DNN_TPU_NO_NATIVE=1`
selects the numpy versions, and a failed build says so on stderr. The
loaders' pickle branch decodes through the library."""

import os
import pickle

import numpy as np
import pytest

from distributed_neural_network_tpu import native as jnative
from distributed_neural_network_tpu_torch import native
from distributed_neural_network_tpu_torch.data import cifar10


def _np_norm(x_u8):
    return (x_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def test_port_keeps_its_own_copy_of_the_source_and_builds_into_its_build_dir():
    with open(native._SRC, "rb") as a, open(jnative._SRC, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(native._SRC) != os.path.dirname(jnative._SRC)
    assert native.available() and jnative.available()
    pkg = os.path.dirname(os.path.dirname(native.__file__))
    assert native.BUILD_DIR == os.path.join(pkg, "_build")
    assert [f for f in os.listdir(native.BUILD_DIR)
            if f.startswith("batcher-") and f.endswith(".so")]


@pytest.mark.parametrize("n", [1, 7, 256])
@pytest.mark.parametrize("threads", [0, 1, 3])
def test_cifar_decode_equals_jax_library(n, threads):
    rows = np.random.default_rng(n).integers(0, 256, size=(n, 3072), dtype=np.uint8)
    got = native.cifar_decode_normalize(rows, 0.5, 0.5, nthreads=threads)
    want = jnative.cifar_decode_normalize(rows, 0.5, 0.5, nthreads=threads)
    assert got.shape == (n, 32, 32, 3) and got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(
        got, _np_norm(rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 32, 32, 3), (3, 7), (11,)])
def test_normalize_equals_jax_library(shape):
    x = np.random.default_rng(1).integers(0, 256, size=shape, dtype=np.uint8)
    got = native.normalize_u8(x, 0.5, 0.5)
    assert got.tobytes() == jnative.normalize_u8(x, 0.5, 0.5).tobytes()
    np.testing.assert_allclose(got, native.fallback_normalize_u8(x, 0.5, 0.5),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("threads", [0, 2])
def test_gather_normalize_equals_jax_library(threads):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, size=(64, 32, 32, 3), dtype=np.uint8)
    idx = rng.integers(0, 64, size=37)
    got = native.gather_normalize_u8(x, idx, 0.5, 0.5, nthreads=threads)
    assert got.tobytes() == jnative.gather_normalize_u8(x, idx, 0.5, 0.5,
                                                        nthreads=threads).tobytes()
    np.testing.assert_allclose(got, native.fallback_gather_normalize_u8(x, idx, 0.5, 0.5),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(IndexError, match="out of range"):
        native.gather_normalize_u8(x[:4], np.array([0, 4]), 0.5, 0.5)
    with pytest.raises(TypeError, match="uint8"):
        native.normalize_u8(x.astype(np.int16), 0.5, 0.5)


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader as before its first use; the module state comes back after."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return native


def test_no_native_env_selects_the_numpy_versions(fresh_loader, monkeypatch):
    monkeypatch.setenv("DNN_TPU_NO_NATIVE", "1")
    assert not fresh_loader.available()
    x = np.random.default_rng(4).integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    got = fresh_loader.gather_normalize_u8(x, np.array([5, 0, 2]), 0.5, 0.5)
    assert np.array_equal(got, fresh_loader.fallback_gather_normalize_u8(
        x, np.array([5, 0, 2]), 0.5, 0.5))


def test_failed_build_says_so_and_runs_numpy(fresh_loader, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(fresh_loader, "BUILD_DIR", str(tmp_path))

    def no_compiler(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(fresh_loader.subprocess, "run", no_compiler)
    assert not fresh_loader.available()
    assert "[native] build failed, using the numpy versions" in capsys.readouterr().err
    x = np.arange(12, dtype=np.uint8)
    assert np.array_equal(fresh_loader.normalize_u8(x, 0.5, 0.5), _np_norm(x))


@pytest.mark.parametrize("normalize_images", [True, False])
def test_pickle_dir_loads_through_native(tmp_path, normalize_images):
    """A batch directory in the python format loads as the JAX loader
    loads it: normalized (bitwise, the same library) or kept uint8."""
    from distributed_neural_network_tpu.data import cifar10 as jcifar

    rng = np.random.default_rng(3)
    batch_dir = tmp_path / "cifar-10-batches-py"
    batch_dir.mkdir()
    for i in range(1, 6):
        with open(batch_dir / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, size=(8, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, size=8).tolist()}, f)
    got = cifar10.load_split(True, root=str(tmp_path), source="pickle",
                             normalize_images=normalize_images)
    want = jcifar.load_split(True, root=str(tmp_path), source="pickle",
                             normalize_images=normalize_images)
    assert got.source == "pickle" and len(got) == 40
    assert got.images.dtype == (np.float32 if normalize_images else np.uint8)
    assert got.images.tobytes() == want.images.tobytes()
    assert np.array_equal(got.labels, want.labels)


def test_synthetic_split_keeps_uint8_and_normalizes_as_jax():
    raw = cifar10.load_split(True, source="synthetic", synthetic_size=32, seed=5,
                             normalize_images=False)
    assert raw.images.dtype == np.uint8
    norm = cifar10.load_split(True, source="synthetic", synthetic_size=32, seed=5)
    assert norm.images.tobytes() == jnative.normalize_u8(raw.images, 0.5, 0.5).tobytes()
