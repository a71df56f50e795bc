"""Per-stage artifact dump / resume (counterpart of
``computervisionimagestich2_tpu.utils.artifacts``).

The npz layout is the JAX package's, byte for byte (``n``, then
``desc_i``, ``xy_i``, ``scale_i``, ``valid_i`` per image), so a
``features.npz`` written by either package resumes in the other.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.types import Features, features_from_numpy, features_to_numpy


def save_features(path: str, feats: list[Features]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {}
    for i, f in enumerate(feats):
        desc, xy, scale, valid = features_to_numpy(f)
        arrays[f"desc_{i}"] = desc
        arrays[f"xy_{i}"] = xy
        arrays[f"scale_{i}"] = scale
        arrays[f"valid_{i}"] = valid
    np.savez_compressed(path, n=len(feats), **arrays)


def load_features(path: str,
                  device: str | torch.device = "cpu") -> list[Features]:
    z = np.load(path)
    n = int(z["n"])
    return [features_from_numpy((z[f"desc_{i}"], z[f"xy_{i}"],
                                 z[f"scale_{i}"], z[f"valid_{i}"]), device)
            for i in range(n)]


def save_stage(run_dir: str, name: str, **arrays) -> str:
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"{name}.npz")
    np.savez_compressed(path, **{
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v) for k, v in arrays.items()})
    return path


def load_stage(run_dir: str, name: str) -> dict[str, np.ndarray]:
    path = os.path.join(run_dir, f"{name}.npz")
    return dict(np.load(path))


def save_manifest(run_dir: str, **meta) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_manifest(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "manifest.json")) as f:
        return json.load(f)
