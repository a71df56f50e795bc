"""Panorama stitching pipeline (counterpart of
``computervisionimagestich2_tpu.models.stitcher``), for the ported
configurations: graph or chain ordering, planned registration, exact
canvases.

Equivalent of class ImageProcess (ImageProcess.cpp) as a host orchestrator
of device stages:

  per image:  cylindrical projection -> u8 luma -> SIFT
  ordering:   graph discovery (the default: all-pairs match counts from one
              launch of kernel B5, one [N, N] readback, the reference's
              directed stichingMat rule, ImageProcess.cpp:101-137) or the
              pre-ordered chain (src/ex6/ImageProcess.cpp:150-159); both
              stitched breadth-first from the middle image
  edges:      every edge registered first (registration.plan_edges: matching
              x2, RANSAC x2, canvas bounds, feature updates), one readback
              of the [E, 23] plan, then one composite + blend per edge
  tail:       histogram equalization + YCbCr luma mix

Images are uploaded as u8 to ``device`` and the panorama comes back as a
u8 numpy array; a CUDA run synchronises before it returns.
"""
from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, StitchConfig, check_supported
from ..core.types import Features
from ..device import resolve_device
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, trunc_u8
from ..utils import obs
from . import compose
from .blender import apply_composite_gain, blend_edge
from .equalization import equalize_and_mix
from .registration import all_pairs_match_counts, plan_edges
from .sift import sift_extract_stats


def _composite_and_blend(proj_dst: torch.Tensor, result: torch.Tensor,
                         bwd: torch.Tensor, min_x: float, min_y: float,
                         comp_hw: tuple[int, int], out_hw: tuple[int, int],
                         cfg: StitchConfig) -> torch.Tensor:
    """One edge: inverse warp (kernel B6 on CUDA) + offset copy +
    (area-gated) gain + Laplacian blend + u8 truncation + crop."""
    a, b = compose.composite(proj_dst, result, bwd, min_x, min_y, comp_hw)
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


class Stitcher:
    """Panorama stitcher with the reference's semantics, on ``device``
    ("cuda" runs the CUDA kernels, "cpu" their plain PyTorch versions).
    Configurations outside the ported ones raise NotImplementedError."""

    def __init__(self, config: StitchConfig = DEFAULT_CONFIG,
                 device: str | torch.device = "cuda"):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self._timer = obs.StageTimer()
        self._feats_stacked: Features | None = None

    @property
    def stage_times(self) -> dict[str, float]:
        return self._timer.times

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- features
    def prepare(self, images: Sequence[np.ndarray]):
        """Project + SIFT for each input image (readFile,
        ImageProcess.cpp:11-24). Returns (projected [H, W, 3] float32
        tensors, Features per image); also keeps the stacked features for
        the edge plan. One u8 upload feeds every image."""
        cfg = self.config
        shapes = {np.asarray(img).shape for img in images}
        if len(shapes) != 1:
            raise NotImplementedError(
                "images of mixed shapes take the incremental stitch, which "
                "is outside the ported slice; see ROADMAP.md A12")
        batch = torch.as_tensor(np.stack([np.asarray(i) for i in images]),
                                device=self.device)
        projected, feats, stats = [], [], []
        for img in batch:
            proj = cylindrical_project(img.float(), cfg.projection.angle_deg)
            f, s = sift_extract_stats(to_gray(proj), cfg.sift)
            projected.append(proj)
            feats.append(f)
            stats.append(s)
        obs.log_sift_overflow(torch.stack(stats).cpu().numpy())
        self._feats_stacked = Features(*(torch.stack(parts)
                                         for parts in zip(*feats)))
        return projected, feats

    def _matching_feats(self) -> Features:
        """Stacked features trimmed to the live prefix, rounded up to 512
        slots: valid masks are prefix-compacted, so the dropped tail is
        dead slots only and results are unchanged."""
        fs = self._feats_stacked
        cap = fs.desc.shape[1]
        live = int(fs.valid.sum(dim=1).max())
        eff = -(-max(live, 512) // 512) * 512
        if eff >= cap:
            return fs
        return Features(*(t[:, :eff].contiguous() for t in fs))

    # ------------------------------------------------------------- ordering
    def _match_graph(self) -> list[list[bool]]:
        """All-pairs stitchability (ImageProcess.cpp:101-137). The
        reference's graph is directional in the asymmetric case: visiting
        (i, j) mirrors stichingMat[j][i] only if it is already true;
        otherwise getImgPair(i, j) decides in that direction. Every
        directed pair count comes from one device call and one readback."""
        mf = self._matching_feats()
        counts = all_pairs_match_counts(mf.desc, mf.valid, self.config)
        return directed_adjacency(counts.cpu().tolist(),
                                  self.config.match.pair_threshold)

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
        for k, (src_i, dst_i, _pre_i) in enumerate(edge_seq):
            bwd = torch.as_tensor(plan[k, 9:17], device=self.device)
            min_x, min_y = float(plan[k, 18]), float(plan[k, 19])
            new_w, new_h = int(plan[k, 20]), int(plan[k, 21])
            result = _composite_and_blend(
                projected[dst_i], result, bwd, min_x, min_y,
                (new_h, new_w), (new_h, new_w), cfg)
            obs.log("edge", src=src_i, dst=dst_i, canvas=(new_h, new_w))
            if plan[k, 22] > 0:
                obs.warn("match_overflow", src=src_i, dst=dst_i,
                         dropped=int(plan[k, 22]),
                         capacity=cfg.match.max_matches)
        return result

    # ----------------------------------------------------------------- main
    def stitch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Full pipeline. Returns the u8 RGB panorama [H, W, 3]."""
        cfg = self.config
        with self._timer.stage("features"):
            projected, _ = self.prepare(images)
            self._sync()

        with self._timer.stage("ordering"):
            n = len(images)
            if cfg.ordering == "chain":
                adj = self._chain_adjacency(n)
                start = n // 2  # src/ex6/ImageProcess.cpp:163
            else:
                adj = self._match_graph()
                start = self._middle_index(adj)
            obs.log("ordering", start=start, edges=sum(map(sum, adj)) // 2)

        with self._timer.stage("stitching"):
            edge_seq = bfs_edge_seq(adj, start, cfg.graph_revisit)
            result = projected[start]
            if edge_seq:
                result = self._stitch_planned(result, projected, edge_seq)
            self._sync()

        with self._timer.stage("enhance"):
            final = result
            if cfg.enhance.enabled:
                final = equalize_and_mix(result, cfg.enhance.compat_luma,
                                         cfg.enhance.mix_weight)
            final = final.to(torch.uint8).cpu().numpy()
        return final


def stitch(images: Sequence[np.ndarray], config: StitchConfig = DEFAULT_CONFIG,
           device: str | torch.device = "cuda") -> np.ndarray:
    return Stitcher(config, device).stitch(images)
