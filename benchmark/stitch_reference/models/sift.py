"""SIFT feature extraction (counterpart of
``computervisionimagestich2_tpu.models.sift``).

VLFeat's octave-at-a-time filter (vl/sift.c: vl_sift_process_first_octave
:322, vl_sift_process_next_octave :428) and the app wrapper
``siftAlgorithm`` (ImageProcess.cpp:44-99): the octave loop runs on the
host, and within an octave every level, candidate and keypoint is a batch
of tensor work with static capacities and validity masks.

The structure follows the JAX package's non-bucketed branch: one walk
radius per level, so keypoints keep the order of the JAX path on the CPU
(that order decides which pairs RANSAC samples). Detection is the dense
mask (``detect_impl="xla"``) or the fused detect of ``ops.detect``
(``"pallas"``, kernel B1 on a CUDA tensor: an octave's DoG stack depends on
its Gaussian levels only, so the extractor builds every octave first and
detects them all in one call); the orientation and descriptor
walks go through ``ops.sift_walks`` (kernels B2 and B3 on a CUDA
tensor). Live counts stay on the device: nothing here waits for the host.
``sift_extract_stats`` is a program (``core/programs.py``), as the JAX
package jits it on ``cfg``: on the card one CUDA graph per luma shape and
``cfg``, replayed for every image of that shape.
"""
from __future__ import annotations

import math

import torch

from ..config import SiftConfig
from ..core.programs import program
from ..core.types import Features
from ..ops import detect, sift_walks
from ..ops import sift_kernels as sk
from ..ops.compaction import compact_indices, select_strongest
from ..ops.gaussian import gaussian_blur
from ..ops.resize import vlfeat_downsample, vlfeat_upsample_rows


def scale_space_sigmas(cfg: SiftConfig):
    """Per-level incremental smoothing sigmas, identical for every octave
    (vl/sift.c:394-404). Returns (first-level sigma or None, [inc])."""
    first = None
    sa = cfg.sigma0 * cfg.sigma_k ** cfg.s_min
    # the nominal input smoothing scales with the first-octave sampling rate
    # (vl/sift.c:389-392: sb = sigma_n / pow(2, o_min))
    sb = cfg.sigma_n / (2.0 ** cfg.o_min)
    if sa > sb:
        first = math.sqrt(sa * sa - sb * sb)
    inc = [cfg.dsigma0 * cfg.sigma_k ** s
           for s in range(cfg.s_min + 1, cfg.s_max + 1)]
    return first, inc


def build_octave(base: torch.Tensor, cfg: SiftConfig,
                 first_sigma: float | None) -> torch.Tensor:
    """GSS levels [S+3, H, W] from a base image (level s_min)."""
    lvl = _store(gaussian_blur(base, first_sigma) if first_sigma else base,
                 cfg)
    levels = [lvl]
    _, inc = scale_space_sigmas(cfg)
    for sd in inc:
        lvl = _store(gaussian_blur(lvl, sd), cfg)
        levels.append(lvl)
    return torch.stack(levels)


def _store(level: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """A Gaussian level as the scale space keeps it: float32, or rounded
    to bfloat16 under ``scale_space_dtype="bf16"`` (the benchmark's
    lower-precision control; the port has no such option)."""
    if cfg.scale_space_dtype == "bf16":
        return level.to(torch.bfloat16).float()
    return level


def candidate_capacity(h: int, w: int) -> int:
    """Static candidate-list capacity per octave: area/128, at least 1024,
    at most 32768. Overflow drops trailing candidates in scan order and is
    reported (cand_dropped)."""
    return max(1024, min((h * w) // 128, 32768))


def keypoint_capacity(h: int, w: int, cap_max: int) -> int:
    """Static accepted-keypoint capacity per octave: area/128, at least
    128, at most ``cap_max`` (0 = auto, 8192)."""
    return max(128, min((h * w) // 128, cap_max or 8192))


def total_keypoint_capacity(h: int, w: int, cap_max: int) -> int:
    """Static final feature capacity for an h x w input: ``cap_max``, or
    (auto) 1 slot per 160 px between 2048 and 16384, rounded up to a
    multiple of 128."""
    if cap_max:
        return cap_max
    cap = max(2048, min((h * w) // 160, 16384))
    return -(-cap // 128) * 128


def detect_octaves(dogs: list[torch.Tensor], cfg: SiftConfig):
    """Candidates of every octave's DoG stack: per octave (coords [cap, 3],
    valid [cap], candidates dropped), cap = ``candidate_capacity``."""
    caps = [candidate_capacity(d.shape[1], d.shape[2]) for d in dogs]
    if cfg.detect_impl == "pallas":
        # fused detect (kernel B1 on CUDA tensors, one launch for all the
        # octaves): the dense path's coords / valid, plus a per-row cap of
        # 128 hits. dropped = uncapped hits minus kept slots: covers both
        # the capacity and the per-row cap, so no truncation goes unreported
        return [(coords, cvalid, torch.clamp(
            n_cand - cvalid.sum(dtype=torch.int32), min=0))
            for coords, cvalid, n_cand in detect.detect_compact_octaves(
                dogs, cfg.peak_thresh, caps)]
    out = []
    for dog, cap in zip(dogs, caps):
        mask = sk.extrema_mask(dog, cfg.peak_thresh)
        # telemetry: candidates dropped by the static capacity
        out.append((*sk.compact_mask(mask, cap), torch.clamp(
            mask.sum(dtype=torch.int32) - cap, min=0)))
    return out


def _process_octave(octave: torch.Tensor, cfg: SiftConfig,
                    octave_index: int, dog: torch.Tensor, candidates: tuple):
    """Refine + orient + describe all keypoints of one octave (``dog``,
    ``candidates``: its DoG stack and its entry of ``detect_octaves``).

    Returns fixed-capacity (desc, xy, sigma, ok, response, stats[3]) with
    xy / sigma in input-image coordinates."""
    _, h, w = octave.shape
    xper = float(2 ** octave_index)
    cap_kp = keypoint_capacity(h, w, cfg.max_keypoints_per_octave)

    coords, cvalid, cand_dropped = candidates
    ok, x, y, sigma, lvl, resp = sk.refine_keypoints(
        dog, coords, cvalid, w, h, cfg.peak_thresh, cfg.edge_thresh,
        cfg.s_min, cfg.s_max, xper, cfg.sigma0, cfg.n_levels)

    # gradient planes of levels s in [s_min+1, s_max-2]: [S, 2, H, W]
    grad = sk.polar_gradient(octave[1:1 + cfg.n_levels])

    # per-level batches: level-l keypoints have sn < l + 1.5, so their
    # windows are tighter; upper levels get half the slots
    def cap_level(l: int) -> int:
        return max(128, (2 * cap_kp) // ((cfg.n_levels + 1) * (2 if l else 1)))

    results = []
    zero = torch.zeros((), dtype=torch.int32, device=octave.device)
    kp_dropped, desc_dropped = zero, zero
    for l in range(cfg.n_levels):
        cap_l = cap_level(l)
        sel = ok & (lvl == l)
        kp_idx, kp_valid = compact_indices(sel, cap_l)
        kp_dropped = kp_dropped + torch.clamp(
            sel.sum(dtype=torch.int32) - cap_l, min=0)
        xl, yl, sl, rl = x[kp_idx], y[kp_idx], sigma[kp_idx], resp[kp_idx]
        mod, ang = grad[l, 0], grad[l, 1]

        r_ori = sk.ori_patch_radius(cfg.sigma0, cfg.n_levels, cfg.s_max, l)
        n_l = kp_valid.sum(dtype=torch.int32)[None]
        hist, o_ok = sift_walks.orientation_hist(
            mod, ang, xl / xper, yl / xper, sl / xper, n_l, r_ori,
            cfg.n_ori_bins)
        angles, a_valid = sk.orientation_peaks(
            hist, o_ok & kp_valid, cfg.n_ori_bins, cfg.max_angles)

        # expand keypoints x angles -> flat list, compact
        cap_d = cap_l + cap_l // 2
        ka_valid = a_valid.reshape(-1)
        ka_x, ka_y, ka_sigma, ka_resp = (
            a.repeat_interleave(cfg.max_angles) for a in (xl, yl, sl, rl))
        ka_angle = angles.reshape(-1)

        r_desc = sk.desc_patch_radius(cfg.sigma0, cfg.n_levels, cfg.s_max,
                                      cfg.magnif, cfg.n_spatial_bins, l)
        da_idx, d_valid = compact_indices(ka_valid, cap_d)
        desc_dropped = desc_dropped + torch.clamp(
            ka_valid.sum(dtype=torch.int32) - cap_d, min=0)
        d_x, d_y, d_sigma, d_angle, d_resp = (
            ka_x[da_idx], ka_y[da_idx], ka_sigma[da_idx], ka_angle[da_idx],
            ka_resp[da_idx])
        n_d = d_valid.sum(dtype=torch.int32)[None]
        desc, d_ok = sift_walks.descriptors(
            mod, ang, d_x / xper, d_y / xper, d_sigma / xper, d_angle, n_d,
            r_desc, cfg.magnif, cfg.n_spatial_bins / 2.0,
            cfg.n_spatial_bins, cfg.n_desc_ori_bins)
        results.append((desc, torch.stack([d_x, d_y], dim=-1), d_sigma,
                        d_ok, d_resp))

    desc, xy, sigmas, oks, resps = (torch.cat(parts)
                                    for parts in zip(*results))
    stats = torch.stack([cand_dropped, kp_dropped, desc_dropped])
    return desc, xy, sigmas, oks, resps, stats


@program("sift_extract_stats")
def sift_extract_stats(gray: torch.Tensor, cfg: SiftConfig = SiftConfig()):
    """SIFT features of a grayscale image [H, W] (0..255) plus
    capacity-overflow telemetry.

    Returns (Features, stats) where stats is int32 [4]: [candidates
    dropped, refined keypoints dropped, descriptors dropped,
    final-capacity keypoints dropped], all 0 on a healthy run. When the
    final capacity binds, the strongest keypoints by |DoG response| are
    kept, in scan order."""
    first_sigma, _ = scale_space_sigmas(cfg)
    base = gray.float()
    if cfg.o_min < 0:
        # upsampled first octave (vl_sift_process_first_octave,
        # vl/sift.c:322-409): each doubling is a pair of row upsamples, as
        # each transposes
        for _ in range(-cfg.o_min):
            base = vlfeat_upsample_rows(vlfeat_upsample_rows(base))
    elif cfg.o_min > 0:
        base = vlfeat_downsample(base, cfg.o_min)

    # the next octave's base depends on this octave's Gaussian levels only,
    # so the whole scale space is built before anything is detected
    octaves = []
    for o in range(cfg.n_octaves):
        if min(base.shape[-2:]) < 8:
            break
        octaves.append(build_octave(base, cfg, first_sigma if o == 0 else None))
        if o + 1 < cfg.n_octaves:
            # next octave base: decimate level s_min + S (octave index S)
            base = vlfeat_downsample(octaves[-1][cfg.n_levels], 1)
    dogs = [sk.dog_stack(octave) for octave in octaves]
    # xper = 2^(o_min + o) maps octave pixels back to input coordinates
    # (0.5 per octave pixel in an upsampled first octave)
    per_octave = [
        _process_octave(octave, cfg, cfg.o_min + o, dog, cand)
        for o, (octave, dog, cand) in enumerate(
            zip(octaves, dogs, detect_octaves(dogs, cfg)))]

    desc, xy, sigma, valid, resp = (torch.cat(parts) for parts in
                                    zip(*(p[:5] for p in per_octave)))
    stats3 = torch.stack([p[5] for p in per_octave]).sum(0)

    cap = total_keypoint_capacity(gray.shape[-2], gray.shape[-1],
                                  cfg.max_keypoints)
    final_dropped = torch.clamp(valid.sum(dtype=torch.int32) - cap, min=0)
    idx, out_valid = select_strongest(valid, resp, cap)
    feats = Features(desc=desc[idx], xy=xy[idx], scale=sigma[idx],
                     valid=out_valid)
    return feats, torch.cat([stats3, final_dropped[None]]).to(torch.int32)


