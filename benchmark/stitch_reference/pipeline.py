"""The plain reference of the two paths the benchmark times: a whole
panorama (``stitch``: the port's ``Stitcher.stitch`` on the planned path,
graph ordering and the enhance tail) and one member of a fixed-canvas
batch (``stitch_fixed``: the port's ``parallel/batched.py::
_stitch_one_fixed``).

Everything runs eagerly in plain PyTorch on the device the frames are
on: no CUDA kernel, no CUDA graph, nothing of the port. Each stage keeps
what the benchmark compares: the features, the ordering's match counts,
the edges, the plan and the canvas.
"""
from __future__ import annotations

from collections import deque

import torch

from .config import StitchConfig
from .core.types import Features
from .models import compose
from .models.blender import apply_composite_gain, blend_edge
from .models.equalization import equalize_and_mix
from .models.registration import all_pairs_match_counts, plan_rows
from .models.sift import sift_extract_stats
from .ops.color import to_gray
from .ops.warp import cylindrical_project, trunc_u8


def features(frames: torch.Tensor, cfg: StitchConfig):
    """Cylindrical projection, luma and SIFT of each frame of ``frames``
    [N, H, W, 3] u8: (stacked Features [N, CAP, ...], projections [N, H,
    W, 3] float32)."""
    feats, proj = [], []
    for img in frames:
        p = cylindrical_project(img.float(), cfg.projection.angle_deg)
        feats.append(sift_extract_stats(to_gray(p), cfg.sift)[0])
        proj.append(p)
    return (Features(*(torch.stack(parts) for parts in zip(*feats))),
            torch.stack(proj))


def live_prefix(fs: Features) -> Features:
    """Stacked features trimmed to the live prefix, rounded up to 512
    slots (valid slots form a prefix, so nothing live is dropped)."""
    cap = fs.desc.shape[1]
    live = int(fs.valid.sum(dim=1).max())
    eff = -(-max(live, 512) // 512) * 512
    if eff >= cap:
        return fs
    return Features(*(t[:, :eff].contiguous() for t in fs))


def directed_adjacency(counts, threshold: int) -> list[list[bool]]:
    """The reference app's sequential stichingMat fill
    (ImageProcess.cpp:117-137): (i, j) mirrors (j, i) when that is
    already set, else its own count decides."""
    n = len(counts)
    adj = [[False] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i != j:
                adj[i][j] = adj[j][i] or bool(counts[i][j] >= threshold)
    return adj


def middle_index(adj: list[list[bool]]) -> int:
    """The middle of the chain walked from an endpoint
    (ImageProcess.cpp:353-393, as intended)."""
    n = len(adj)
    degree = [sum(row) for row in adj]
    cur = next((i for i in range(n) if degree[i] == 1), 0)
    walk, seen = [cur], {cur}
    while True:
        nxt = next((j for j in range(n) if adj[cur][j] and j not in seen),
                   None)
        if nxt is None:
            break
        walk.append(nxt)
        seen.add(nxt)
        cur = nxt
    return walk[len(walk) // 2]


def bfs_edge_seq(adj: list[list[bool]], start: int,
                 revisit: str = "skip") -> list[tuple[int, int, int]]:
    """Breadth-first (src, dst, pre) stitch order from ``start``
    (ImageProcess.cpp:149-236). Consumes ``adj``."""
    n = len(adj)
    neighbors = [[j for j in range(n) if adj[i][j]] for i in range(n)]
    edge_seq, pre, visited, queue = [], start, {start}, deque([start])
    while queue:
        src = queue.popleft()
        for dst in reversed(neighbors[src]):
            if not adj[src][dst]:
                continue
            adj[src][dst] = adj[dst][src] = False
            if revisit == "skip" and dst in visited:
                continue
            visited.add(dst)
            queue.append(dst)
            edge_seq.append((src, dst, pre))
            pre = dst
    return edge_seq


def composite_and_blend(proj_dst, result, bwd, min_x, min_y, canvas_hw,
                        content_h, cfg: StitchConfig) -> torch.Tensor:
    """One edge on a ``canvas_hw`` canvas: inverse warp, offset copy,
    gain, Laplacian blend over ``content_h`` rows of content (an int or a
    device scalar), u8 truncation."""
    a, b = compose.composite(proj_dst, result, bwd, min_x, min_y, canvas_hw,
                             cfg.warp_model)
    a = apply_composite_gain(a, b, cfg.blend, canvas_hw[0], canvas_hw[1])
    return trunc_u8(blend_edge(a, b, cfg.blend, content_h))


def stitch(frames: torch.Tensor, cfg: StitchConfig) -> dict:
    """A whole panorama of ``frames`` [N, H, W, 3] u8 on the planned path
    with graph ordering and exact canvases: {"features", "counts" [N, N],
    "edges", "plan" [E, 23], "panorama" [h, w, 3] u8 numpy}, each on the
    host."""
    feats, proj = features(frames, cfg)
    mf = live_prefix(feats)
    counts = all_pairs_match_counts(mf.desc, mf.valid, cfg).cpu()
    adj = directed_adjacency(counts.tolist(), cfg.match.pair_threshold)
    start = middle_index(adj)
    edge_seq = bfs_edge_seq(adj, start, cfg.graph_revisit)
    img_hw = tuple(proj.shape[1:3])
    edges = torch.tensor(edge_seq, dtype=torch.int32,
                         device=frames.device).reshape(-1, 3)
    pairs: list = []
    rows = (plan_rows(mf, edges, img_hw, img_hw, cfg, pairs) if edge_seq
            else torch.zeros((0, 23), device=frames.device))
    plan = rows.cpu()
    n_coef = 9 if cfg.warp_model == "projective" else 8
    result = proj[start]
    for k, (_src, dst, _pre) in enumerate(edge_seq):
        new_w, new_h = int(plan[k, 20]), int(plan[k, 21])
        result = composite_and_blend(
            proj[dst], result, rows[k, 9:9 + n_coef], rows[k, 18],
            rows[k, 19], (new_h, new_w), new_h, cfg)
    if cfg.enhance.enabled:
        result = equalize_and_mix(result, cfg.enhance.compat_luma,
                                  cfg.enhance.mix_weight)
    return {"features": Features(*(t.cpu() for t in feats)),
            "counts": counts, "edges": edge_seq, "plan": plan,
            "pairs": pairs,
            "panorama": result.to(torch.uint8).cpu().numpy()}


def chain_edge_seq(k: int) -> list[tuple[int, int, int]]:
    """The stitch order of ``k`` pre-ordered frames: chain adjacency,
    breadth first from ``k // 2``."""
    adj = [[abs(i - j) == 1 for j in range(k)] for i in range(k)]
    return bfs_edge_seq(adj, k // 2)


def default_canvas(h: int, w: int, k: int,
                   cfg: StitchConfig) -> tuple[int, int]:
    """The batch's fixed canvas: (1.6 h, 0.85 k w), each rounded up to a
    multiple of max(canvas_bucket, 128)."""
    bucket = max(cfg.canvas_bucket, 128)
    return (-(-int(1.6 * h) // bucket) * bucket,
            -(-int(0.85 * k * w) // bucket) * bucket)


def stitch_fixed(frames: torch.Tensor, cfg: StitchConfig,
                 canvas_hw: tuple[int, int]) -> dict:
    """One panorama of pre-ordered ``frames`` [K, H, W, 3] u8 on the fixed
    ``canvas_hw``, as a batch member: every edge composites and blends on
    the whole canvas, its content extent from the plan; no enhancement.
    {"plan" [E, 23], "canvas" [Hc, Wc, 3] u8-valued float32}, on the
    host."""
    feats, proj = features(frames, cfg)
    edge_seq = chain_edge_seq(frames.shape[0])
    img_hw = tuple(proj.shape[1:3])
    edges = torch.tensor(edge_seq, dtype=torch.int32, device=frames.device)
    pairs: list = []
    plan = plan_rows(feats, edges, img_hw, img_hw, cfg, pairs)
    n_coef = 9 if cfg.warp_model == "projective" else 8
    result = proj.new_zeros((canvas_hw[0], canvas_hw[1], 3))
    result[:img_hw[0], :img_hw[1]] = proj[edge_seq[0][0]]
    for e, (_src, dst, _pre) in enumerate(edge_seq):
        result = composite_and_blend(
            proj[dst], result, plan[e, 9:9 + n_coef], plan[e, 18],
            plan[e, 19], canvas_hw, plan[e, 21], cfg)
    return {"plan": plan.cpu(), "pairs": pairs, "canvas": result.cpu()}
