"""distributed_neural_network_tpu_torch - the PyTorch/CUDA port of the trainer.

The JAX package `distributed_neural_network_tpu` is the reference; this
package mirrors its module names. It trains the paper's LeNet CNN on CIFAR-10
under three regimes (single, model replication, data parallelism with
epoch-edge parameter averaging and a seeded fault mask). On one GPU the N
workers are a replica group in one process. The classifier head can run as a
hand-written CUDA kernel (`kernels="cuda"`, `ops/fused_head.py`); nothing here
imports the kernel library until it is launched, so this package imports on a
CPU-only PyTorch.

The names below load on first use (PEP 562), so importing the package imports
no torch: the elastic supervisor's launcher (``python -m
distributed_neural_network_tpu_torch.launch``) runs without it.
"""

import importlib

__version__ = "0.1.0"

# name -> the module that defines it
_EXPORTS = {
    "Engine": ".train.engine",
    "EpochMetrics": ".train.engine",
    "Network": ".models.cnn",
    "Split": ".data.cifar10",
    "TrainConfig": ".train.engine",
    "create_mesh": ".parallel.mesh",
    "device_count": ".parallel.mesh",
    "load_split": ".data.cifar10",
    "make_synthetic": ".data.cifar10",
    "normalize": ".data.cifar10",
    "param_count": ".models.cnn",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    globals()[name] = value
    return value
