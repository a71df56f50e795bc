"""Device meshes (counterpart of
``computervisionimagestich2_tpu.parallel.mesh``).

A JAX mesh on one host is one process driving every local device:
``shard_map`` runs a body once per device and ``ppermute`` /
``all_gather`` move rows between them. The port keeps that shape with one
controller: a ``Mesh`` is a 2-D grid of ``torch.device`` s with axes
``("data", "sp")``, a row-sharded canvas is a list of per-stripe tensors,
each on its device along the ``sp`` axis, and the functions of
``parallel/spatial.py`` and ``parallel/blend.py`` loop over the stripes,
moving halo rows with ``.to(device)``. ``torch.distributed`` is not used:
NCCL refuses two ranks on one card, so it could not hold a mesh there.

A ``devices`` list may name one device several times: a *virtual mesh*,
the counterpart of the JAX tests' eight virtual CPU devices; its stripes
then all live on that device and a halo move is a no-op.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A (data, sp) grid of devices: ``devices`` [data, sp] (an object
    array of ``torch.device``), ``shape`` {"data": .., "sp": ..} as in JAX.
    Hashable, so the per-geometry caches of ``parallel/blend.py`` can key on
    it."""

    axis_names = ("data", "sp")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D (data, sp), got {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._key = (devices.shape, tuple(str(d) for d in devices.flat))

    def axis_devices(self, axis_name: str) -> tuple[torch.device, ...]:
        """The devices along ``axis_name`` at index 0 of the other axis:
        where a program sharded over that axis puts its pieces (the JAX
        body runs once more per index of the other axis, on replicas)."""
        if axis_name == "sp":
            return tuple(self.devices[0])
        if axis_name == "data":
            return tuple(self.devices[:, 0])
        raise ValueError(f"unknown mesh axis {axis_name!r}")

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)


def make_mesh(n_devices: int | None = None, sp: int = 1,
              devices=None) -> Mesh:
    """A (data, sp) mesh. sp divides n_devices; data = n_devices // sp.

    ``devices=None`` takes the visible CUDA devices and raises when there
    are fewer than ``n_devices`` (never the CPU). An explicit list (of
    ``torch.device`` s or names) may repeat a device: a virtual mesh."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0 or (n_devices is not None and count < n_devices):
            raise RuntimeError(
                f"make_mesh: {n_devices or 1} CUDA devices requested, "
                f"{count} visible; pass devices=[...] for a virtual mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"make_mesh: {n_devices} devices requested, "
                         f"{len(devices)} given")
    if n_devices % sp != 0:
        raise ValueError(f"sp={sp} must divide n_devices={n_devices}")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices[:n_devices]
    return Mesh(arr.reshape(n_devices // sp, sp))


def shard_rows(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """Split axis 0 of ``x`` into ``len(devices)`` equal stripes, stripe i
    on ``devices[i]`` (``device_put`` with a row sharding). Raises unless
    the rows split evenly."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} devices")
    return [to_device(s, d) for s, d in zip(torch.chunk(x, n), devices)]


def gather_rows(stripes, device: torch.device | str) -> torch.Tensor:
    """The stripes of a row-sharded array concatenated on ``device``
    (``all_gather(tiled=True)``)."""
    return torch.cat([to_device(s, device) for s in stripes])


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: itself where it already lies there (a virtual
    mesh's halo), else a copy, asynchronous only towards a card (a copy
    to the host must be complete when it returns)."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")
