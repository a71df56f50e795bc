#!/usr/bin/env python3
"""The PyTorch/CUDA port's benchmark on one NVIDIA GPU, beside ``bench.py``
(the JAX package's): one JSON line per cell, BASELINE configs 2-4.

    python3 bench_torch.py [--cells a,b] [--seed S] [--runs N]
                           [--device cuda|cpu] [--frame HxW]

The cells, metrics and checks are described in
``computervisionimagestich2_tpu_torch/tools/bench.py``.
"""
import sys

from computervisionimagestich2_tpu_torch.tools.bench import main

if __name__ == "__main__":
    sys.exit(main())
