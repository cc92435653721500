"""`python -m distributed_neural_network_tpu_torch.serve` -> serve/http.py."""

import sys

from .http import main

if __name__ == "__main__":
    sys.exit(main())
