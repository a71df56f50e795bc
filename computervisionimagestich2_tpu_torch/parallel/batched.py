"""Batched panoramas and registration pairs (counterpart of
``computervisionimagestich2_tpu.parallel.batched``, BASELINE.json config 3:
"Input/ and Input2/ sets stitched in one vmapped batch").

The JAX package vmaps one program over the batch and, since its Pallas
kernels do not vmap, pins them off there (``_nopallas``). Here the batch is
a loop over its members on one device: on the card every member runs the
kernels of its path (B1-B3 for the features, B4 and B6 for a panorama, B7
for a registration pair), a panorama as one CUDA graph
(``_stitch_one_fixed``) and a registration pair as one
(``_register_one``), on the CPU their plain versions, and a batch
equals its members run one at a time, bit for bit.

``shard_batch`` splits a batch's axis 0 over a mesh's ``data`` devices
(the JAX package's ``device_put`` with ``P("data")``); each function here
takes such a batch, runs every member on its chunk's device and returns
the results on the first one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, StitchConfig, check_supported
from ..core.programs import const, program
from ..core.types import Features
from ..device import resolve_device
from ..models import compose
from ..models.blender import apply_composite_gain, blend_edge
from ..models.matcher import match_features
from ..models.ransac import ransac_warp
from ..models.registration import plan_rows
from ..models.sift import sift_extract, sift_extract_stats
from ..models.stitcher import bfs_edge_seq
from ..ops import rng
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, trunc_u8
from ..utils import obs
from .mesh import Mesh, to_device


@dataclass(frozen=True)
class ShardedBatch:
    """A batch split along axis 0 over a mesh's ``data`` axis
    (``shard_batch``): ``chunks[i]`` lies on the axis's device i."""

    chunks: tuple[torch.Tensor, ...]


def shard_batch(mesh: Mesh, *arrays) -> tuple[ShardedBatch, ...]:
    """Place arrays (or tensors) with the batch axis sharded over the
    ``data`` axis: one equal chunk per device. Raises unless the batch
    splits evenly."""
    devices = mesh.axis_devices("data")
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % len(devices):
            raise ValueError(f"a batch of {t.shape[0]} does not split over "
                             f"{len(devices)} data devices")
        out.append(ShardedBatch(tuple(
            to_device(c, d) for c, d in zip(torch.chunk(t, len(devices)),
                                            devices))))
    return tuple(out)


def _members(batch, device) -> tuple[list[torch.Tensor], torch.device]:
    """The members of a batch, each on the device it runs on, and the
    device the results go to: a ``ShardedBatch``'s members on their
    chunk's device, results on the first; otherwise the whole batch on
    ``device``, uploaded in the span ``upload``."""
    if isinstance(batch, ShardedBatch):
        return ([m for c in batch.chunks for m in c],
                batch.chunks[0].device)
    dev = resolve_device(device)
    with obs.span("upload"):
        return list(torch.as_tensor(batch, device=dev)), dev


@program("register_one")
def _register_one(gray_a: torch.Tensor, gray_b: torch.Tensor,
                  cfg: StitchConfig):
    """Pairwise registration: features of a and b -> warp coeffs b -> a
    and the inlier count. The matcher's method stays "auto" (exact L1) and
    the model bilinear, as in the JAX package's ``_register_one``. The
    RANSAC key, ``PRNGKey(cfg.ransac.seed)``, is a device constant.

    A program (the member of the JAX package's vmapped
    ``batched_pairwise_register``, its ``parallel/batched.py:47``): on the
    card one CUDA graph per key, the frames' shape and ``cfg``, into which
    the SIFT program is inlined."""
    fa = sift_extract(gray_a, cfg.sift)
    fb = sift_extract(gray_b, cfg.sift)
    pairs = match_features(fb, fa, cfg.match.ratio_threshold,
                           cfg.match.distance, cfg.match.max_matches)
    rc = cfg.ransac
    coeffs, _, n_inliers = ransac_warp(
        pairs, rng.prng_key_on(rc.seed, gray_a.device), rc.n_hypotheses,
        rc.threshold, rc.n_sample, lo_iters=rc.lo_iters)
    return coeffs, n_inliers


def batched_pairwise_register(gray_a, gray_b,
                              cfg: StitchConfig = DEFAULT_CONFIG,
                              device: str | torch.device = "cuda"):
    """Registration of a batch of pairs: gray_a, gray_b [B, H, W] float32
    luma (arrays, tensors or ``shard_batch`` batches), one ``_register_one``
    program call per pair (on the card a replay per pair). Every pair
    draws from the same unsalted ``prng_key(cfg.ransac.seed)``, as in the
    JAX package. Returns (coeffs [B, 8], inliers [B]) on ``device`` (on the
    first data device for a sharded batch)."""
    check_supported(cfg)
    ga, dev = _members(gray_a, device)
    gb, _ = _members(gray_b, device)
    out = [_register_one(a.float(), to_device(b, a.device).float(), cfg)
           for a, b in zip(ga, gb)]
    return (torch.stack([to_device(c, dev) for c, _ in out]),
            torch.stack([to_device(n, dev) for _, n in out]))


@program("project_and_extract")
def _project_and_extract_one(image: torch.Tensor,
                             cfg: StitchConfig = DEFAULT_CONFIG):
    """The per-image features program (JAX ``parallel/batched.py:59``):
    cylindrical projection of ``image`` [H, W, 3] (u8 or float), its luma
    and ``sift_extract_stats``. Returns (Features, projection [H, W, 3]
    float32, stats [4]). A program (``core/programs.py``): on the card one
    CUDA graph per frame shape and ``cfg``, into which the SIFT program
    is inlined."""
    proj = cylindrical_project(image.float(), cfg.projection.angle_deg)
    feats, stats = sift_extract_stats(to_gray(proj), cfg.sift)
    return feats, proj, stats


def _project_and_extract(images, cfg: StitchConfig):
    """``_project_and_extract_one`` of each image [H, W, 3] of ``images``
    (a tensor [B, H, W, 3], or a list of images on their own devices):
    (stacked Features, projections [B, H, W, 3] float32, stats [B, 4]) on
    the first image's device."""
    feats, proj, stats = [], [], []
    for img in images:
        f, p, s = _project_and_extract_one(img, cfg)
        feats.append(f)
        proj.append(p)
        stats.append(s)
    dev = proj[0].device

    def stack(ts):
        return torch.stack([to_device(t, dev) for t in ts])
    return (Features(*(stack(parts) for parts in zip(*feats))),
            stack(proj), stack(stats))


def batched_project_and_extract(images, cfg: StitchConfig = DEFAULT_CONFIG,
                                device: str | torch.device = "cuda"):
    """Cylindrical projection + luma + SIFT over a batch of images
    [B, H, W, 3] (u8 or float; an array, a tensor or a ``shard_batch``
    batch): the batched form of readFile (ImageProcess.cpp:11-24). Returns
    (Features stacked [B, CAP, ...], projections [B, H, W, 3] float32) on
    ``device`` (on the first data device for a sharded batch). Capacity
    truncation is reported from a side thread
    (``obs.log_sift_overflow_async``), so the caller can queue more work
    before the readback."""
    check_supported(cfg)
    feats, proj, stats = _project_and_extract(_members(images, device)[0],
                                              cfg)
    obs.log_sift_overflow_async(stats)
    return feats, proj


@program("stitch_one_fixed")
def _stitch_one_fixed(images: torch.Tensor, cfg: StitchConfig,
                      canvas_hw: tuple[int, int],
                      edge_seq: tuple[tuple[int, int, int], ...]):
    """One whole panorama of pre-ordered images [K, H, W, 3] (a tensor on
    the device to run on) on a fixed ``canvas_hw``: every edge composites
    and blends on the full canvas, the content extent rides in the plan
    (its per-edge min_x, min_y, new_w, new_h feed the warp offsets and the
    blend's content rows). The plan of every edge is registered first
    (``plan_rows``: B4 per edge on the card, on the features' whole
    capacity, whose dead slots change nothing) and stays on the device:
    B6 reads each edge's model and offsets there, the shift and the seam
    row take them as tensors. Enhancement is the caller's step.

    A program (JAX ``parallel/batched.py:124``): on the card one CUDA
    graph per key (the frames' shape, ``cfg``, ``canvas_hw`` and
    ``edge_seq``), with the features program and the plan inlined into
    it. Returns (canvas [Hc, Wc, 3] u8-valued float32, plan [E, 23]
    float32 on the device)."""
    feats, proj, _ = _project_and_extract(images, cfg)
    img_hw = (int(proj.shape[1]), int(proj.shape[2]))
    edges = const(edge_seq, torch.int32, proj.device)
    plan = plan_rows(feats, edges, img_hw, img_hw, cfg)
    n_coef = 9 if cfg.warp_model == "projective" else 8
    hc, wc = canvas_hw
    start = edge_seq[0][0]
    result = proj.new_zeros((hc, wc, 3))
    result[:img_hw[0], :img_hw[1]] = proj[start]
    for e, (_src_i, dst_i, _pre_i) in enumerate(edge_seq):
        a, b = compose.composite(proj[dst_i], result, plan[e, 9:9 + n_coef],
                                 plan[e, 18], plan[e, 19], canvas_hw,
                                 cfg.warp_model)
        a = apply_composite_gain(a, b, cfg.blend, hc, wc)
        result = trunc_u8(blend_edge(a, b, cfg.blend, plan[e, 21]))
    return result, plan


def chain_edge_seq(k: int) -> tuple[tuple[int, int, int], ...]:
    """The stitch order of ``k`` pre-ordered images: chain adjacency
    (src/ex6/ImageProcess.cpp:150-159), breadth first from ``k // 2``."""
    adj = [[abs(i - j) == 1 for j in range(k)] for i in range(k)]
    return tuple(bfs_edge_seq(adj, k // 2))


def default_canvas(h: int, w: int, k: int,
                   cfg: StitchConfig) -> tuple[int, int]:
    """The generous chain bound (1.6 h, 0.85 k w), each rounded up to a
    multiple of max(canvas_bucket, 128)."""
    bucket = max(cfg.canvas_bucket, 128)
    return (-(-int(1.6 * h) // bucket) * bucket,
            -(-int(0.85 * k * w) // bucket) * bucket)


def batched_stitch_chain(images, cfg: StitchConfig = DEFAULT_CONFIG,
                         canvas_hw: tuple[int, int] | None = None,
                         device: str | torch.device = "cuda"):
    """Stitch a batch of panoramas: images [B, K, H, W, 3] (u8 or float;
    an array, a tensor or a ``shard_batch`` batch), B panoramas of K
    pre-ordered images each (ex6 chain ordering), all on one fixed canvas
    ``canvas_hw`` (default ``default_canvas``). Mixed resolutions batch by
    zero-padding to a common [H, W] first.

    Each panorama runs ``_stitch_one_fixed`` on ``device`` (a sharded
    batch's on its chunk's device). The content extents come back in the
    plans; when the largest passes the canvas, a
    ``batched_canvas_overflow`` warning is printed (rerun with a larger
    ``canvas_hw``).

    Returns (canvases [B, Hc, Wc, 3] u8-valued float32 on ``device``, or
    on the first data device for a sharded batch; plans [B, E, 23]
    numpy); plans[:, -1, 20:22] are the final (w, h) content extents.
    The call is the span ``batch_chain``, the plans' readback the span
    ``readback`` (``utils/obs.py::span``)."""
    with obs.span("batch_chain"):
        check_supported(cfg)
        batch, dev = _members(images, device)
        k, h, w = (int(d) for d in batch[0].shape[:3])
        if k < 2:
            raise ValueError(f"a panorama needs at least 2 images, got {k}")
        edge_seq = chain_edge_seq(k)
        if canvas_hw is None:
            canvas_hw = default_canvas(h, w, k, cfg)
        if canvas_hw[0] < h or canvas_hw[1] < w:
            raise ValueError(f"canvas {canvas_hw} is smaller than an image "
                             f"({h}, {w})")
        outs = [_stitch_one_fixed(pano, cfg, canvas_hw, edge_seq)
                for pano in batch]
        # one readback of every member's plan, after all of them are queued
        with obs.span("readback"):
            plans = torch.stack([to_device(p, dev)
                                 for _, p in outs]).cpu().numpy()
        final_w, final_h = plans[:, -1, 20].max(), plans[:, -1, 21].max()
        if final_w > canvas_hw[1] or final_h > canvas_hw[0]:
            obs.warn("batched_canvas_overflow",
                     needed=(int(final_h), int(final_w)), canvas=canvas_hw)
        return torch.stack([to_device(c, dev) for c, _ in outs]), plans
