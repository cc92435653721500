"""distributed_neural_network_tpu_torch - the PyTorch/CUDA port of the trainer.

The JAX package `distributed_neural_network_tpu` is the reference; this
package mirrors its module names. It trains the paper's LeNet CNN on CIFAR-10
under three regimes (single, model replication, data parallelism with
epoch-edge parameter averaging and a seeded fault mask). On one GPU the N
workers are a replica group in one process. The classifier head can run as a
hand-written CUDA kernel (`kernels="cuda"`, `ops/fused_head.py`); nothing here
imports the kernel library until it is launched, so this package imports on a
CPU-only PyTorch.
"""

from .data.cifar10 import Split, load_split, make_synthetic, normalize
from .models.cnn import Network, param_count
from .parallel.mesh import create_mesh, device_count
from .train.engine import Engine, EpochMetrics, TrainConfig

__version__ = "0.1.0"

__all__ = [
    "Engine",
    "EpochMetrics",
    "Network",
    "Split",
    "TrainConfig",
    "create_mesh",
    "device_count",
    "load_split",
    "make_synthetic",
    "normalize",
    "param_count",
    "__version__",
]
