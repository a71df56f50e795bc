"""Panorama stitching pipeline (counterpart of
``computervisionimagestich2_tpu.models.stitcher``).

Equivalent of class ImageProcess (ImageProcess.cpp) as a host orchestrator
of device stages:

  per image:  cylindrical projection -> u8 luma -> SIFT (images of one
              shape share one u8 upload; mixed shapes go one by one)
  ordering:   graph discovery (the default: all-pairs match counts from one
              launch of kernel B5 on uniform shapes, or one bidirectional
              match per i<j pair on mixed shapes; the reference's directed
              stichingMat rule, ImageProcess.cpp:101-137) or the
              pre-ordered chain (src/ex6/ImageProcess.cpp:150-159); both
              stitched breadth-first from the middle image
  edges:      planned mode (``planned=True`` on uniform shapes): every
              edge registered first (registration.plan_edges), one
              readback of the [E, 23] plan, then one composite + blend per
              edge. Incremental mode (``planned=False``, or mixed shapes)
              keeps the reference's per-edge loop: register, read the two
              models and the overflow back in one copy, plan the canvas on
              the host, composite, blend. Either way B6 gets the backward
              model as host floats, by value.
              ``exact_canvas=False`` composites and blends on a canvas
              padded up a geometric size grid and crops back.
              With a ``mesh`` (``parallel/mesh.py``) the planned loop
              composites and blends each qualifying edge row-sharded over
              the mesh (``parallel/blend.py``: B6 once per stripe), as
              the JAX package's mesh mode does.
  tail:       histogram equalization + YCbCr luma mix

``artifact_dir`` dumps the features, the canvas and a manifest;
``stitch(..., resume=True)`` reloads the features instead of running SIFT.
With ``PANORAMA_TPU_TRACE`` set, the features and stitching stages are
traced (``utils/obs.py::trace``, ``torch.profiler``).
Images are uploaded as u8 to ``device`` and the panorama comes back as a
u8 numpy array; a CUDA run synchronises before it returns.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, StitchConfig, check_supported
from ..core.types import Features
from ..device import resolve_device
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, trunc_u8
from ..parallel.blend import plan_shard_levels, sharded_composite_and_blend
from ..parallel.mesh import Mesh, gather_rows
from ..utils import artifacts, load_image, obs, save_image
from . import compose
from .blender import apply_composite_gain, blend_edge, n_levels
from .equalization import equalize_and_mix
from .matcher import match_features_bidir
from .registration import (all_pairs_match_counts, plan_edges, register_edge,
                           update_features_by_offset,
                           update_features_by_warp)
from .sift import sift_extract_stats
from .transfer import color_transfer


def _composite_and_blend(proj_dst: torch.Tensor, result: torch.Tensor,
                         bwd: np.ndarray, min_x: float, min_y: float,
                         comp_hw: tuple[int, int], out_hw: tuple[int, int],
                         cfg: StitchConfig) -> torch.Tensor:
    """One edge: inverse warp (kernel B6 on CUDA, the backward model
    ``bwd`` as host floats) + offset copy + (area-gated) gain + Laplacian
    blend + u8 truncation + crop."""
    a, b = compose.composite(proj_dst, result, bwd, min_x, min_y, comp_hw,
                             cfg.warp_model)
    a = apply_composite_gain(a, b, cfg.blend, comp_hw[0], comp_hw[1])
    blended = blend_edge(a, b, cfg.blend, out_hw[0])
    return trunc_u8(blended[:out_hw[0], :out_hw[1]])


def bfs_edge_seq(adj: list[list[bool]], start: int,
                 revisit: str = "skip") -> list[tuple[int, int, int]]:
    """BFS stitch order from ``start`` (ImageProcess.cpp:149-236): returns
    (src, dst, pre) edge triples, where pre is the previously stitched
    image whose features get the offset-only update (cpp:226-227).
    Consumes ``adj``. ``revisit="skip"`` stitches each image once;
    "faithful" keeps the reference's unguarded re-stitches."""
    n = len(adj)
    neighbors = [[j for j in range(n) if adj[i][j]] for i in range(n)]
    edge_seq = []
    pre = start
    visited = {start}
    queue = deque([start])
    while queue:
        src_i = queue.popleft()
        for dst_i in reversed(neighbors[src_i]):
            if not adj[src_i][dst_i]:
                continue
            adj[src_i][dst_i] = adj[dst_i][src_i] = False
            if revisit == "skip" and dst_i in visited:
                continue
            visited.add(dst_i)
            queue.append(dst_i)
            edge_seq.append((src_i, dst_i, pre))
            pre = dst_i
    return edge_seq


def directed_adjacency(counts, threshold: int) -> list[list[bool]]:
    """The reference's sequential stichingMat fill (ImageProcess.cpp:117-137).

    Visiting (i, j) in row-major order: if stichingMat[j][i] is already true
    the edge is mirrored without recomputation; otherwise the (i, j)
    direction's own count decides. The result is directional in the rare
    asymmetric case (count[i][j] < T but count[j][i] >= T yields only the
    j->i edge)."""
    n = len(counts)
    adj = [[False] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if adj[j][i]:
                adj[i][j] = True  # the mirror shortcut, cpp:125-128
            else:
                adj[i][j] = bool(counts[i][j] >= threshold)
    return adj


def live_prefix(fs: Features) -> Features:
    """Stacked features [N, CAP, ...] trimmed to the live prefix, rounded up
    to 512 slots: valid masks are prefix-compacted, so the dropped tail is
    dead slots only and results are unchanged. One readback of the live
    counts."""
    cap = fs.desc.shape[1]
    live = int(fs.valid.sum(dim=1).max())
    eff = -(-max(live, 512) // 512) * 512
    if eff >= cap:
        return fs
    return Features(*(t[:, :eff].contiguous() for t in fs))


class Stitcher:
    """Panorama stitcher with the reference's semantics, on ``device``
    ("cuda" runs the CUDA kernels, "cpu" their plain PyTorch versions).
    Configurations outside the ported ones raise NotImplementedError.
    ``artifact_dir``: where ``stitch`` dumps features.npz, canvas.npz and
    manifest.json, and where ``stitch(..., resume=True)`` looks for the
    features.

    ``mesh``: optional ``parallel.mesh.Mesh``. The planned loop then
    composites and blends each edge row-sharded over ``mesh[mesh_axis]``
    (``parallel.blend.sharded_composite_and_blend``) whenever the edge
    qualifies (``_mesh_edge_ok``: FIR blur, no gain compensation or
    explicit seam band, canvas rows shardable); other edges take the
    single-device program. As in the JAX package, the gate does not look
    at the area-gated seam band (``seam_auto_area``), so above that area a
    sharded edge blends the whole canvas with no implied gain, and the
    sharded blend resolves ``dtype="auto"`` against the default 1.5 Mpx.
    The incremental loop ignores the mesh. Every device of the mesh is of
    ``device``'s type (ValueError otherwise): a mesh spreads the work over
    cards of the Stitcher's own kind, never onto the host."""

    def __init__(self, config: StitchConfig = DEFAULT_CONFIG,
                 device: str | torch.device = "cuda",
                 artifact_dir: str | None = None,
                 mesh: Mesh | None = None, mesh_axis: str = "sp"):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        if mesh is not None:
            kinds = {d.type for d in mesh.devices.flat}
            if kinds != {self.device.type}:
                raise ValueError(f"mesh devices {sorted(kinds)} must be of "
                                 f"the Stitcher's device type "
                                 f"{self.device.type!r}")
        self.artifact_dir = artifact_dir
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._timer = obs.StageTimer()
        self._feats_stacked: Features | None = None

    @property
    def stage_times(self) -> dict[str, float]:
        return self._timer.times

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- mesh mode
    def _mesh_n(self) -> int:
        return int(self.mesh.shape[self.mesh_axis])

    def _mesh_edge_ok(self, comp_hw: tuple[int, int]) -> bool:
        """Host-side gate: can this edge run row-sharded? (FIR pyramid
        only, no gain or explicit seam band on the sharded path, and the
        rounded canvas must admit >= 1 truly sharded pyramid level.)"""
        cfg = self.config
        if (self.mesh is None or cfg.blend.gain_compensation
                or cfg.blend.seam_band > 0 or cfg.blend.blur_impl != "fir"):
            return False
        h, w = comp_hw
        levels = n_levels(h, w, cfg.blend.level_mode)
        return plan_shard_levels(h, levels, self._mesh_n(),
                                 cfg.blend.blur_sigma) >= 1

    def _mesh_comp_hw(self, comp_hw: tuple[int, int]) -> tuple[int, int]:
        """Round the working canvas's rows up so stripes shard evenly with
        at least one halved level (H % 2n == 0)."""
        n2 = 2 * self._mesh_n()
        return (-(-comp_hw[0] // n2) * n2, comp_hw[1])

    # ------------------------------------------------------------- features
    def _project(self, img: torch.Tensor) -> torch.Tensor:
        return cylindrical_project(img.float(),
                                   self.config.projection.angle_deg)

    def prepare(self, images: Sequence[np.ndarray]):
        """Project + SIFT for each input image (readFile,
        ImageProcess.cpp:11-24). Returns (projected [H, W, 3] float32
        tensors, Features per image). Images of one shape share one u8
        upload and their features are also kept stacked for the planned
        path; mixed shapes go one by one and leave nothing stacked."""
        cfg = self.config
        shapes = {np.asarray(img).shape for img in images}
        if len(shapes) == 1:
            batch = torch.as_tensor(np.stack([np.asarray(i) for i in images]),
                                    device=self.device)
        else:
            batch = [torch.as_tensor(np.asarray(i), device=self.device)
                     for i in images]
        projected, feats, stats = [], [], []
        for img in batch:
            proj = self._project(img)
            f, s = sift_extract_stats(to_gray(proj), cfg.sift)
            projected.append(proj)
            feats.append(f)
            stats.append(s)
        obs.log_sift_overflow(torch.stack(stats).cpu().numpy())
        self._feats_stacked = self._stack(shapes, feats)
        return projected, feats

    @staticmethod
    def _stack(shapes: set, feats: list[Features]) -> Features | None:
        """The features with a leading image axis when every image has one
        shape (and so one capacity), else None: the planned path runs on
        uniform shapes only, since its canvas bounds take one image
        size."""
        if len(shapes) != 1 or len({f.desc.shape for f in feats}) != 1:
            return None
        return Features(*(torch.stack(parts) for parts in zip(*feats)))

    def _matching_feats(self) -> Features:
        """The stacked features, ``live_prefix``."""
        return live_prefix(self._feats_stacked)

    # ------------------------------------------------------------- ordering
    def _match_graph(self, feats: list[Features]) -> list[list[bool]]:
        """All-pairs stitchability (ImageProcess.cpp:101-137). The
        reference's graph is directional in the asymmetric case: visiting
        (i, j) mirrors stichingMat[j][i] only if it is already true;
        otherwise getImgPair(i, j) decides in that direction. Stacked
        features take one B5 launch; mixed shapes take one bidirectional
        match (two B4 launches) per i<j pair, whose uncapped counts give
        counts[i][j] and counts[j][i]. One readback either way."""
        mcfg = self.config.match
        if self._feats_stacked is not None:
            mf = self._matching_feats()
            counts = all_pairs_match_counts(mf.desc, mf.valid, self.config)
        else:
            n = len(feats)
            counts = torch.zeros((n, n), dtype=torch.int32,
                                 device=self.device)
            for i in range(n):
                for j in range(i + 1, n):
                    ij, ji = match_features_bidir(
                        feats[i], feats[j], mcfg.ratio_threshold,
                        mcfg.distance, mcfg.max_matches, mcfg.method,
                        mcfg.l2pre_m_counts)
                    counts[i, j] = ij.n_raw
                    counts[j, i] = ji.n_raw
        return directed_adjacency(counts.cpu().tolist(), mcfg.pair_threshold)

    @staticmethod
    def _chain_adjacency(n: int) -> list[list[bool]]:
        """ex6: images are pre-ordered left-to-right
        (src/ex6/ImageProcess.cpp:150-159)."""
        adj = [[False] * n for _ in range(n)]
        for i in range(n - 1):
            adj[i][i + 1] = adj[i + 1][i] = True
        return adj

    @staticmethod
    def _middle_index(adj: list[list[bool]]) -> int:
        """Intended behavior of getMiddleIndex (ImageProcess.cpp:353-393):
        walk the chain from an endpoint, return the middle of the walk.
        (The reference's visited check is buggy; this implements the
        intent, as the JAX package does.)"""
        n = len(adj)
        degree = [sum(row) for row in adj]
        edge = next((i for i in range(n) if degree[i] == 1), 0)
        que, seen = [edge], {edge}
        cur = edge
        while True:
            nxt = next((j for j in range(n)
                        if adj[cur][j] and j not in seen), None)
            if nxt is None:
                break
            que.append(nxt)
            seen.add(nxt)
            cur = nxt
        return que[len(que) // 2]

    # ---------------------------------------------------------------- edges
    def _comp_hw(self, new_h: int, new_w: int) -> tuple[int, int]:
        """The working canvas of one edge: the exact size, or (with
        ``exact_canvas=False``) padded up the geometric size grid."""
        if self.config.exact_canvas:
            return new_h, new_w
        b = self.config.canvas_bucket
        return compose.bucket_size(new_h, b), compose.bucket_size(new_w, b)

    def _stitch_edge(self, result: torch.Tensor, feats: list[Features],
                     projected: list[torch.Tensor], src_i: int, dst_i: int,
                     pre_i: int):
        """One stitch step of the incremental loop (ImageProcess.cpp:
        176-233): register, one readback of both models and the overflow,
        canvas plan on the host, composite + blend, feature updates.
        ``feats`` and ``projected`` are updated in place. Returns the new
        canvas."""
        cfg = self.config
        forward, backward, _, ovf = register_edge(
            feats[src_i], feats[dst_i], cfg, src_i * 65536 + dst_i,
            tuple(projected[dst_i].shape[:2]))
        # [forward, backward, overflow]: 8 + 8 + 1 or 9 + 9 + 1 floats
        n_coef = forward.shape[0]
        host = torch.cat([forward, backward, ovf.float()[None]]).cpu().numpy()
        fwd_host, bwd_host = host[:n_coef], host[n_coef:2 * n_coef]
        dropped = int(host[2 * n_coef])
        if dropped > 0:
            obs.warn("match_overflow", src=src_i, dst=dst_i,
                     dropped=dropped, capacity=cfg.match.max_matches)
        if cfg.color_transfer:
            # the reference's disabled per-edge normalization
            # (ImageProcess.cpp:180), written back into the projected
            # image as the reference's in-place output argument does
            projected[dst_i] = color_transfer(projected[dst_i],
                                              projected[src_i])
        src_hw = tuple(projected[dst_i].shape[:2])
        new_h, new_w, min_x, min_y = compose.canvas_plan(
            fwd_host, src_hw, tuple(result.shape[:2]), cfg.warp_model)
        self._validate_canvas(new_h, new_w, src_hw,
                              f"edge ({src_i}, {dst_i})")
        result = _composite_and_blend(
            projected[dst_i], result, bwd_host, min_x, min_y,
            self._comp_hw(new_h, new_w), (new_h, new_w), cfg)
        feats[dst_i] = update_features_by_warp(feats[dst_i], forward,
                                               min_x, min_y, cfg.warp_model)
        feats[pre_i] = update_features_by_offset(feats[pre_i],
                                                 float(int(min_x)),
                                                 float(int(min_y)))
        return result

    @staticmethod
    def _validate_canvas(new_h, new_w, img_hw, where: str,
                         budget_edges: int = 1) -> None:
        """Single-edge form of ``_validate_plan`` for the incremental and
        streaming paths: refuse an unallocatable canvas."""
        h_img, w_img = img_hw
        bound = 64.0 * (budget_edges + 1) * float(h_img) * float(w_img) \
            + 16.0 * 4096 * 4096
        if (not np.isfinite([new_h, new_w]).all() or new_h < 1
                or new_w < 1 or float(new_h) * float(new_w) > bound):
            raise ValueError(
                f"degenerate registration at {where}: planned canvas "
                f"{new_w}x{new_h} exceeds the sanity bound. The match "
                "set likely admits only a near-singular warp — re-run "
                "with a different RansacConfig.seed, more n_hypotheses, "
                "or check that the images actually overlap.")

    @staticmethod
    def _validate_plan(plan: np.ndarray, img_hw, n_edges: int) -> None:
        """Refuse to composite a degenerate registration (a near-singular
        model can plan an unallocatable canvas): non-finite rows, canvases
        above 64x the total input area, or empty canvases raise."""
        h_img, w_img = img_hw
        dims = plan[:, 20:22]
        area_bound = 64.0 * (n_edges + 1) * h_img * w_img
        bad = (~np.isfinite(plan).all(axis=1)
               | (dims[:, 0] * dims[:, 1] > area_bound)
               | (dims < 1).any(axis=1))
        if bad.any():
            k = int(np.argmax(bad))
            raise ValueError(
                f"degenerate registration at edge {k}: planned canvas "
                f"{dims[k, 0]:.0f}x{dims[k, 1]:.0f} exceeds the sanity "
                f"bound ({area_bound:.0f} px total). The match set for "
                "this edge likely admits only a near-singular warp — "
                "re-run with a different RansacConfig.seed, more "
                "n_hypotheses, or check that the images actually "
                "overlap.")

    def _stitch_planned(self, result: torch.Tensor, projected,
                        edge_seq) -> torch.Tensor:
        """Register every edge (one plan readback), then composite and
        blend edge by edge."""
        cfg = self.config
        img_hw = tuple(projected[edge_seq[0][1]].shape[:2])
        start_hw = tuple(result.shape[:2])
        plan = plan_edges(self._matching_feats(), edge_seq, img_hw,
                          start_hw, cfg)
        self._validate_plan(plan, img_hw, len(edge_seq))
        n_coef = 9 if cfg.warp_model == "projective" else 8
        for k, (src_i, dst_i, _pre_i) in enumerate(edge_seq):
            if cfg.color_transfer:
                # as in _stitch_edge; the plan is untouched (the reference
                # transfers after getImgPair)
                projected[dst_i] = color_transfer(projected[dst_i],
                                                  projected[src_i])
            bwd = plan[k, 9:9 + n_coef]
            min_x, min_y = float(plan[k, 18]), float(plan[k, 19])
            new_w, new_h = int(plan[k, 20]), int(plan[k, 21])
            comp_hw = self._comp_hw(new_h, new_w)
            if self.mesh is not None and self._mesh_edge_ok(
                    self._mesh_comp_hw(comp_hw)):
                comp_hw = self._mesh_comp_hw(comp_hw)
                blended = sharded_composite_and_blend(
                    projected[dst_i], result, bwd, min_x, min_y, comp_hw,
                    self.mesh, self.mesh_axis, cfg.warp_model,
                    cfg.blend.level_mode, cfg.blend.blur_sigma,
                    content_h=new_h, dtype=cfg.blend.dtype)
                # the stripes gathered on self.device: the next edge reads
                # the result whole, and the enhance tail runs there
                result = trunc_u8(
                    gather_rows(blended, self.device)[:new_h, :new_w])
            else:
                result = _composite_and_blend(
                    projected[dst_i], result, bwd, min_x, min_y, comp_hw,
                    (new_h, new_w), cfg)
            obs.log("edge", src=src_i, dst=dst_i, canvas=(new_h, new_w))
            if plan[k, 22] > 0:
                obs.warn("match_overflow", src=src_i, dst=dst_i,
                         dropped=int(plan[k, 22]),
                         capacity=cfg.match.max_matches)
        return result

    # ---------------------------------------------------------------- resume
    def _resume_features(self, images: Sequence[np.ndarray]):
        """Reload the SIFT features from ``artifact_dir`` and recompute
        only the cylindrical projections. Returns (projected, feats) as
        ``prepare`` would. (The JAX package stacks resumed features
        whenever their capacities agree, which sends mixed image shapes of
        one capacity down the planned path with one image size; here they
        stack only when ``prepare`` would stack them.)"""
        feats = artifacts.load_features(f"{self.artifact_dir}/features.npz",
                                        self.device)
        if len(feats) != len(images):
            raise ValueError(
                f"resume artifact has {len(feats)} feature sets for "
                f"{len(images)} images — stale features.npz?")
        projected = [self._project(torch.as_tensor(np.asarray(img),
                                                   device=self.device))
                     for img in images]
        self._feats_stacked = self._stack(
            {np.asarray(img).shape for img in images}, feats)
        return projected, feats

    # ----------------------------------------------------------------- main
    def stitch(self, images: Sequence[np.ndarray],
               resume: bool = False) -> np.ndarray:
        """Full pipeline. Returns the u8 RGB panorama [H, W, 3]. With
        ``resume=True`` (and ``artifact_dir``), SIFT is skipped when
        ``features.npz`` exists there."""
        cfg = self.config
        resumed = bool(resume and self.artifact_dir and os.path.exists(
            f"{self.artifact_dir}/features.npz"))
        with self._timer.stage("features"), obs.trace("features"):
            if resumed:
                projected, feats = self._resume_features(images)
                obs.log("resume", source=f"{self.artifact_dir}/features.npz")
            else:
                projected, feats = self.prepare(images)
            self._sync()
        if self.artifact_dir and not resumed:
            artifacts.save_features(f"{self.artifact_dir}/features.npz",
                                    feats)

        with self._timer.stage("ordering"):
            n = len(images)
            if cfg.ordering == "chain":
                adj = self._chain_adjacency(n)
                start = n // 2  # src/ex6/ImageProcess.cpp:163
            else:
                adj = self._match_graph(feats)
                start = self._middle_index(adj)
            obs.log("ordering", start=start, edges=sum(map(sum, adj)) // 2)

        with self._timer.stage("stitching"), obs.trace("stitching"):
            edge_seq = bfs_edge_seq(adj, start, cfg.graph_revisit)
            result = projected[start]
            if cfg.planned and edge_seq and self._feats_stacked is not None:
                result = self._stitch_planned(result, projected, edge_seq)
            else:
                for src_i, dst_i, pre_i in edge_seq:
                    result = self._stitch_edge(result, feats, projected,
                                               src_i, dst_i, pre_i)
                    obs.log("edge", src=src_i, dst=dst_i,
                            canvas=tuple(result.shape[:2]))
            self._sync()

        with self._timer.stage("enhance"):
            final = result
            if cfg.enhance.enabled:
                final = equalize_and_mix(result, cfg.enhance.compat_luma,
                                         cfg.enhance.mix_weight)
            final = final.to(torch.uint8).cpu().numpy()
        if self.artifact_dir:
            artifacts.save_stage(self.artifact_dir, "canvas", canvas=final)
            artifacts.save_manifest(self.artifact_dir, n_images=n,
                                    ordering=cfg.ordering,
                                    canvas_hw=list(final.shape[:2]))
        return final


def stitch(images: Sequence[np.ndarray], config: StitchConfig = DEFAULT_CONFIG,
           device: str | torch.device = "cuda") -> np.ndarray:
    return Stitcher(config, device).stitch(images)


def stitch_files(paths: Sequence[str], config: StitchConfig = DEFAULT_CONFIG,
                 output: str | None = None,
                 device: str | torch.device = "cuda") -> np.ndarray:
    out = stitch([load_image(p) for p in paths], config, device)
    if output:
        save_image(output, out)
    return out
