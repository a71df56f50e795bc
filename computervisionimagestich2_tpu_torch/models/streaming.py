"""Streaming panorama (counterpart of
``computervisionimagestich2_tpu.models.streaming``): incremental
registration and a rolling canvas, BASELINE.json config 5.

Frames arrive one at a time (e.g. 30 fps video). Each is projected, gets
its SIFT features, is registered against a keyframe's (or the previous
frame's) features, already in canvas coordinates, and is composited and
blended into the canvas:

- the canvas is padded up the geometric size grid of
  ``compose.bucket_size`` (the pre-padding extent stays the blend's seam
  row bound), and the padded canvas is kept;
- above ``max_width`` the oldest columns are dropped and both feature sets
  shift with them: a rolling window of bounded memory.

Per frame: one registration (the ``register_edge`` program: on the card
a CUDA graph replayed push after push, its RANSAC keys folded from a
device frame counter; one B4 launch), one readback of the two models and
the counts, then composite (B6, the backward model by value) and blend
on the device.

The composite + blend stays eager. The stream keeps its canvas padded up
the bucket grid, and that padded canvas runs away (ROADMAP.md §C, as in
the JAX package): nearly every push brings a new canvas shape
(``chip_smoke.py`` phase 11 counts them), so a graph per canvas shape
would be captured and hardly ever replayed.

``stage_times`` holds the last ``push``'s seconds for ``sift``,
``register`` and ``composite`` (composite + blend); on CUDA each stage ends
in a synchronise, so they add up to the frame's latency.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, StitchConfig, check_supported
from ..device import resolve_device
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, trunc_u8
from ..utils import obs
from . import compose
from .blender import apply_composite_gain, blend_edge
from .registration import (register_edge, update_features_by_offset,
                           update_features_by_warp)
from .sift import sift_extract
from .stitcher import Stitcher


class StreamingStitcher:
    """Builds a panorama one frame at a time.

    Usage::

        ss = StreamingStitcher(max_width=4096, device="cuda")
        for frame in frames:
            ss.push(frame)            # RGB uint8 [H, W, 3]
        pano = ss.canvas()            # RGB uint8
    """

    def __init__(self, config: StitchConfig = DEFAULT_CONFIG,
                 max_width: int | None = None, project: bool = True,
                 anchor: str = "keyframe",
                 device: str | torch.device = "cuda"):
        """``anchor`` picks the registration target for each new frame:

        - ``"keyframe"`` (default): a fixed keyframe's features, for as
          long as the keyframe still yields at least
          ``config.match.pair_threshold`` ratio matches (the reference's
          THRESHOLD, ImageProcess.h:18); then the previous frame becomes
          the keyframe. Registration error accumulates only across
          keyframe switches.
        - ``"previous"``: the immediately previous frame (error compounds
          per frame)."""
        if anchor not in ("keyframe", "previous"):
            raise ValueError(f"unknown anchor mode {anchor!r}")
        check_supported(config)
        self.config = config
        self.max_width = max_width
        self.project = project
        self.anchor = anchor
        self.device = resolve_device(device)
        self._result = None           # [H, W, 3] float32 on the device
        self._feats = None            # previous frame, canvas coordinates
        self._kf_feats = None         # keyframe, canvas coordinates
        self._n_frames = 0
        # the frame index on the device (the registration's edge id),
        # advanced there each push: no upload, no constant per frame
        self._frame_id: torch.Tensor | None = None
        self.n_keyframe_switches = 0
        self._timer = obs.StageTimer()

    @property
    def stage_times(self) -> dict[str, float]:
        return self._timer.times

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prepare(self, frame: np.ndarray):
        img = torch.as_tensor(np.asarray(frame), device=self.device).float()
        if self.project:
            img = cylindrical_project(img, self.config.projection.angle_deg)
        return img, sift_extract(to_gray(img), self.config.sift)

    def _register(self, target, feats, img_hw):
        """register_edge against ``target`` (edge id: the frame index, a
        device tensor), then one readback of forward, backward, n_matches
        and overflow. Returns (forward on the device, forward and backward
        on the host, n_matches, overflow)."""
        forward, backward, n_matches, ovf = register_edge(
            target, feats, self.config, self._frame_id, img_hw)
        n = forward.shape[0]
        host = torch.cat([forward, backward, n_matches.float()[None],
                          ovf.float()[None]]).cpu().numpy()
        return (forward, host[:n], host[n:2 * n], int(host[2 * n]),
                int(host[2 * n + 1]))

    def push(self, frame: np.ndarray) -> tuple[int, int]:
        """Ingest one frame; returns the current canvas (h, w)."""
        cfg = self.config
        with self._timer.stage("sift"):
            img, feats = self._prepare(frame)
            self._sync()
        if self._result is None:
            self._result = img
            self._feats = self._kf_feats = feats
            self._n_frames = 1
            self._frame_id = torch.ones((), dtype=torch.int64,
                                        device=self.device)
            return tuple(self._result.shape[:2])

        img_hw = tuple(img.shape[:2])
        with self._timer.stage("register"):
            # edge id = frame index -> distinct RANSAC draws per frame
            target = (self._kf_feats if self.anchor == "keyframe"
                      else self._feats)
            forward, fwd_host, bwd_host, n_matches, dropped = \
                self._register(target, feats, img_hw)
            if (self.anchor == "keyframe"
                    and n_matches < cfg.match.pair_threshold):
                # the keyframe fell out of view: promote the previous frame
                # and register against it (drift resets to this point)
                self._kf_feats = self._feats
                self.n_keyframe_switches += 1
                obs.log("stream_keyframe", frame=self._n_frames,
                        stale_matches=n_matches)
                forward, fwd_host, bwd_host, n_matches, dropped = \
                    self._register(self._kf_feats, feats, img_hw)
            if dropped > 0:
                obs.warn("match_overflow", frame=self._n_frames,
                         dropped=dropped, capacity=cfg.match.max_matches)

        with self._timer.stage("composite"):
            ext_h, ext_w, min_x, min_y = compose.canvas_plan(
                fwd_host, img_hw, tuple(self._result.shape[:2]),
                cfg.warp_model)
            Stitcher._validate_canvas(ext_h, ext_w, img_hw,
                                      f"stream frame {self._n_frames}")
            # the padded canvas is kept; the pre-padding height stays the
            # seam row bound (models.blender.half_plane_mask)
            new_hw = (compose.bucket_size(ext_h, cfg.canvas_bucket),
                      compose.bucket_size(ext_w, cfg.canvas_bucket))
            a, b = compose.composite(img, self._result, bwd_host, min_x,
                                     min_y, new_hw, cfg.warp_model)
            a = apply_composite_gain(a, b, cfg.blend, *new_hw)
            self._result = trunc_u8(blend_edge(a, b, cfg.blend, ext_h))

            # the new frame's features become the previous-frame anchor;
            # the keyframe's ride the canvas-origin shift (the old result
            # moved by the int-truncated minima, ImageProcess.cpp:227)
            self._feats = update_features_by_warp(feats, forward, min_x,
                                                  min_y, cfg.warp_model)
            self._kf_feats = update_features_by_offset(
                self._kf_feats, float(int(min_x)), float(int(min_y)))
            self._n_frames += 1
            self._frame_id += 1

            if self.max_width and self._result.shape[1] > self.max_width:
                drop = self._result.shape[1] - self.max_width
                self._result = self._result[:, drop:]
                self._feats = update_features_by_offset(self._feats,
                                                        float(drop), 0.0)
                self._kf_feats = update_features_by_offset(self._kf_feats,
                                                           float(drop), 0.0)
            self._sync()
        obs.log("stream", frame=self._n_frames,
                canvas=tuple(self._result.shape[:2]), matches=n_matches)
        return tuple(self._result.shape[:2])

    def canvas(self) -> np.ndarray:
        if self._result is None:
            raise ValueError("no frames pushed")
        return self._result.to(torch.uint8).cpu().numpy()
