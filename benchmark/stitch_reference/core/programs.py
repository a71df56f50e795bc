"""What the frozen copy keeps of the port's ``core/programs.py``: nothing
runs as a CUDA graph here. ``program`` leaves a function as it is, and
``const`` builds the tensor of a host constant anew on every call, with
the bits the port's cached constants have (``torch.as_tensor`` on the
host, then the dtype, then the device)."""
from __future__ import annotations

import numpy as np
import torch


def program(name: str):
    """The port's program decorator, as a no-op."""
    return lambda fn: fn


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host constant ``values`` as ``dtype`` on ``device``."""
    arr = np.asarray(values)
    return torch.as_tensor(arr.copy()).to(dtype=dtype).to(torch.device(device))
