"""The comparison that decides ``correct``: what the timed path produced
on the sampled calls against the plain reference (``stitch_reference``)
run on the same u8 frames, each compared number beside its limit from
``checks/<workload>.json``.

Numbers, each the largest over the sampled panoramas:
- ``keypoint_miss``: the share of live keypoints, the program's and the
  reference's together, that find no partner on the other side (same
  image, position within ``XY_TOL`` px, sigma within ``SIGMA_TOL`` of
  itself, every descriptor value within ``DESC_TOL``; partners paired
  greedily by the closest descriptor). ``descriptor_gap``, the largest
  |difference| of a descriptor value between partners, is reported
  beside it and not compared: under the lower-precision control no
  keypoint keeps a partner, so it has no reading there to sit below;
- ``pair_counts_gap``: the largest |difference| of an ordering match
  count, over the larger of the reference's count and the pair threshold;
- ``plan_gap_px``: per edge, the largest distance between the image
  corners mapped by the two forward models, or between the two canvas
  sizes (px); ``NO_MATCH`` when the edges differ;
- ``fit_gap_px``: per edge, the largest distance between the image
  corners mapped by the program's forward model and by a model fitted
  here, apart from both sides' RANSAC, to the reference's matches of
  that edge (``independent_fit``): a witness of the registration that
  does not share the reference's sampling, scoring or refit;
- ``panorama_mad`` (``canvas_mad`` for a batch member): the mean
  |difference| of the u8 results over the larger of the two shapes, the
  part that only one covers counted against zeros;
- ``failed_calls``: calls of the window that raised.
"""
from __future__ import annotations

import contextlib

import numpy as np

XY_TOL = 0.01
SIGMA_TOL = 1e-3
DESC_TOL = 1e-3  # descriptors are L2-normalised, their values 0..0.2
NO_MATCH = 1e9  # a plan of other edges, in place of a distance


def _live(desc, xy, scale, valid):
    v = np.asarray(valid, bool)
    return (np.asarray(desc)[v], np.asarray(xy)[v], np.asarray(scale)[v])


def keypoints(prog, ref) -> tuple[int, int, float]:
    """(keypoints without a partner, keypoints in all, largest descriptor
    gap between partners) of one image's features, each (desc, xy, scale,
    valid) on the host."""
    pd, pxy, ps = _live(*prog)
    rd, rxy, rs = _live(*ref)
    cells: dict = {}
    for j, (x, y) in enumerate(np.floor(rxy / XY_TOL).astype(np.int64)):
        cells.setdefault((x, y), []).append(j)
    used = np.zeros(len(rd), bool)
    missed, gap = 0, 0.0
    for i, (x, y) in enumerate(np.floor(pxy / XY_TOL).astype(np.int64)):
        cand = [j for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for j in cells.get((x + dx, y + dy), ())
                if not used[j]
                and abs(rxy[j, 0] - pxy[i, 0]) <= XY_TOL
                and abs(rxy[j, 1] - pxy[i, 1]) <= XY_TOL
                and abs(rs[j] - ps[i]) <= SIGMA_TOL * abs(rs[j])]
        if not cand:
            missed += 1
            continue
        gaps = [float(np.abs(rd[j] - pd[i]).max()) for j in cand]
        k = int(np.argmin(gaps))
        if gaps[k] > DESC_TOL:
            missed += 1
            continue
        used[cand[k]] = True
        gap = max(gap, gaps[k])
    missed += int((~used).sum())
    return missed, len(pd) + len(rd), gap


def plan_gap(prog_plan, prog_edges, ref_plan, ref_edges, img_hw,
             n_coef: int = 8) -> float:
    """``plan_gap_px`` of two [E, 23] plans of edges ``*_edges``."""
    if [tuple(e) for e in prog_edges] != [tuple(e) for e in ref_edges]:
        return NO_MATCH
    p = np.asarray(prog_plan, np.float64)
    r = np.asarray(ref_plan, np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return NO_MATCH
    h, w = img_hw
    xs = np.array([0.0, w - 1.0, 0.0, w - 1.0])
    ys = np.array([0.0, 0.0, h - 1.0, h - 1.0])
    gap = float(np.abs(p[:, 20:22] - r[:, 20:22]).max()) if len(p) else 0.0
    for a, b in zip(p, r):
        pa, pb = _warp(a[:n_coef], xs, ys), _warp(b[:n_coef], xs, ys)
        gap = max(gap, float(np.hypot(*(pa - pb)).max()))
    return gap


def independent_fit(src, dst, valid, threshold: float = 4.0,
                    rounds: int = 20):
    """The reference app's bilinear model (8 coefficients, ``_warp``'s
    order) of one edge's matches ``src`` -> ``dst`` ([N, 2] each, ``valid``
    [N]), fitted without sampling: start from the matches within 3
    ``threshold`` of their median shift, then least squares in float64 on
    the matches within ``threshold`` of the last fit, until that set stops
    changing. None with fewer than 4 matches to fit."""
    v = np.asarray(valid, bool)
    s = np.asarray(src, np.float64)[v]
    d = np.asarray(dst, np.float64)[v]
    shift = np.median(d - s, axis=0) if len(s) else np.zeros(2)
    keep = np.hypot(*(d - s - shift).T) < 3 * threshold
    coef = None
    for _ in range(rounds):
        if keep.sum() < 4:
            return None
        x, y = s[keep, 0], s[keep, 1]
        a = np.stack([x, y, x * y, np.ones_like(x)], axis=1)
        cx = np.linalg.lstsq(a, d[keep, 0], rcond=None)[0]
        cy = np.linalg.lstsq(a, d[keep, 1], rcond=None)[0]
        coef = np.concatenate([cx, cy])
        err = np.hypot(*(_warp(coef, s[:, 0], s[:, 1]) - d.T))
        now = err < threshold
        if np.array_equal(now, keep):
            break
        keep = now
    return coef


def fit_gap(prog_plan, prog_edges, ref_edges, ref_pairs, img_hw) -> float:
    """``fit_gap_px`` of a [E, 23] plan of edges ``prog_edges`` against
    the independent fits of the reference's matches of its edges."""
    if [tuple(e) for e in prog_edges] != [tuple(e) for e in ref_edges]:
        return NO_MATCH
    p = np.asarray(prog_plan, np.float64)
    h, w = img_hw
    xs = np.array([0.0, w - 1.0, 0.0, w - 1.0])
    ys = np.array([0.0, 0.0, h - 1.0, h - 1.0])
    gap = 0.0
    for row, pairs in zip(p, ref_pairs):
        coef = independent_fit(*pairs)
        if coef is None or not np.isfinite(row[:8]).all():
            return NO_MATCH
        gap = max(gap, float(np.hypot(*(_warp(row[:8], xs, ys)
                                        - _warp(coef, xs, ys))).max()))
    return gap


def _warp(c, x, y) -> np.ndarray:
    """The forward model at points (x, y): the reference app's bilinear
    warp (8 coefficients) or a homography (9)."""
    if len(c) == 8:
        return np.stack([c[0] * x + c[1] * y + c[2] * x * y + c[3],
                         c[4] * x + c[5] * y + c[6] * x * y + c[7]])
    d = c[6] * x + c[7] * y + c[8]
    return np.stack([(c[0] * x + c[1] * y + c[2]) / d,
                     (c[3] * x + c[4] * y + c[5]) / d])


def image_mad(a, b) -> float:
    """Mean |a - b| of two [h, w, 3] images over the larger of their
    shapes, each padded with zeros."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    h, w = max(a.shape[0], b.shape[0]), max(a.shape[1], b.shape[1])
    pa = np.zeros((h, w, 3))
    pb = np.zeros((h, w, 3))
    pa[:a.shape[0], :a.shape[1]] = a
    pb[:b.shape[0], :b.shape[1]] = b
    return float(np.abs(pa - pb).mean())


def compare_stitch(rec: dict, ref: dict, pair_threshold: int,
                   img_hw) -> dict:
    """The numbers of one sampled ``stitch`` call against the reference
    on its frames of ``img_hw`` (h, w)."""
    ref_feats = [tuple(t[i].numpy() for t in ref["features"])
                 for i in range(len(rec["features"]))]
    missed = total = 0
    gap = 0.0
    for prog, r in zip(rec["features"], ref_feats):
        m, n, g = keypoints([t.numpy() for t in prog], r)
        missed, total, gap = missed + m, total + n, max(gap, g)
    pc = np.asarray(rec["counts"], np.float64)
    rc = np.asarray(ref["counts"], np.float64)
    counts_gap = float((np.abs(pc - rc) / np.maximum(rc, pair_threshold))
                       .max()) if pc.shape == rc.shape else NO_MATCH
    return {"keypoint_miss": missed / max(total, 1),
            "descriptor_gap": gap,
            "pair_counts_gap": counts_gap,
            "plan_gap_px": plan_gap(rec["plan"], rec["edges"],
                                    ref["plan"].numpy(), ref["edges"],
                                    img_hw),
            "fit_gap_px": fit_gap(rec["plan"], rec["edges"], ref["edges"],
                                  ref["pairs"], img_hw),
            "panorama_mad": image_mad(rec["panorama"], ref["panorama"])}


def compare_member(rec: dict, ref: dict, img_hw, edges) -> dict:
    """The numbers of one sampled batch member against the reference on
    its frames."""
    return {"plan_gap_px": plan_gap(rec["plan"], edges, ref["plan"].numpy(),
                                    edges, img_hw),
            "fit_gap_px": fit_gap(rec["plan"], edges, edges, ref["pairs"],
                                  img_hw),
            "canvas_mad": image_mad(rec["canvas"], ref["canvas"].numpy())}


def reference_config(overrides: dict, lower: bool = False):
    """The reference's configuration: its own copy of the dataclasses with
    the configuration file's overrides; ``lower``: the lower-precision
    control (every Gaussian level of the SIFT scale space, and the blend,
    in bfloat16)."""
    from stitch_reference.config import StitchConfig

    from .entries import replace_config
    cfg = replace_config(StitchConfig(), overrides)
    if lower:
        cfg = replace_config(cfg, {"sift": {"scale_space_dtype": "bf16"},
                                   "blend": {"dtype": "bf16"}})
    return cfg


def reference(entry: str, frames: np.ndarray, cfg, device) -> dict:
    """The plain reference's result for one frame set [N, H, W, 3] u8 on
    ``device``, float32 matrix products in full precision, every sum in
    a fixed order: the whole panorama (``stitch``) or the batch member
    (``batch_chain``)."""
    import torch
    from stitch_reference import pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = torch.as_tensor(frames, device=device)
    k, h, w = frames.shape[:3]
    with deterministic():
        if entry == "stitch":
            return pipeline.stitch(t, cfg)
        return pipeline.stitch_fixed(t, cfg,
                                     pipeline.default_canvas(h, w, k, cfg))


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms while the reference runs: on the
    card its orientation histograms' ``scatter_add_`` otherwise sums in
    an order that changes from run to run."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def as_record(entry: str, ref: dict) -> dict:
    """A reference result in the form of a program's record (the control
    is judged in the program's place)."""
    if entry == "stitch":
        n = ref["features"].desc.shape[0]
        return {"features": [[t[i] for t in ref["features"]]
                             for i in range(n)],
                "counts": ref["counts"], "edges": ref["edges"],
                "plan": ref["plan"].numpy(), "panorama": ref["panorama"]}
    return {"canvas": ref["canvas"].numpy().astype(np.uint8),
            "plan": ref["plan"].numpy()}


def compare(entry: str, rec: dict, ref: dict, cfg, frames) -> dict:
    """The numbers of one sampled output against the reference on its
    frames."""
    img_hw = frames.shape[1:3]
    if entry == "stitch":
        return compare_stitch(rec, ref, cfg.match.pair_threshold, img_hw)
    from stitch_reference import pipeline
    return compare_member(rec, ref, img_hw,
                          pipeline.chain_edge_seq(frames.shape[0]))


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over ``readings``."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(values: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and no call failed. A number the run could not read fails."""
    checks = {k: {"value": values.get(k), "limit": lim}
              for k, lim in limits.items()}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks

