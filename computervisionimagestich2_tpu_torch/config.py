"""Configuration: the stitcher's dataclasses, plus the chain slice.

The dataclasses and ``DEFAULT_CONFIG`` are the port's own copy of
``computervisionimagestich2_tpu.config``: the same classes, field names,
types, defaults and docstrings, so a configuration means the same in both
packages (``tests/test_torch_isolation.py`` holds them equal field for
field). The port imports nothing of the JAX package. Its functions read a
configuration by attribute and change it with ``dataclasses.replace``, so
a ``StitchConfig`` of the JAX package handed to the port works too.

Defaults mirror the reference application's compile-time constants
(ImageProcess.h:13-32, Projection.h:12-13, equalization.cpp:2,
transfer.cpp:2) and VLFeat's SIFT defaults (vl/sift.c:238-275). Several
fields choose between the JAX package's TPU backends (``pallas``,
``detect_impl``, ``walk_dtype``, ``method``); they are kept so that the two
packages' configurations stay equal, and ``check_supported`` says which
values the port runs.

The port runs ``DEFAULT_CONFIG`` (graph ordering, the fused detect, exact
L1 matching) and ``SLICE_CONFIG``, the chain-ordered path with the dense
(non-fused) detect that was ported first, each with the incremental stitch
(``planned=False``), bucketed canvases (``exact_canvas=False``), the
per-edge color transfer (``color_transfer=True``), projective warps
(``warp_model="projective"``), an upsampled first octave
(``sift.o_min=-1``), the scalar luma gain (``blend.gain_mode="luma"``),
the Van Vliet blend blur (``blend.blur_impl="vanvliet"``), the
L2-prefiltered matcher (``match.method="l2pre"``) and squared-L2 matching
(``match.distance="l2"``). ``check_supported`` raises
``NotImplementedError`` for the TPU-only switches it lists, naming the
ROADMAP entry that says why they are not ported.

``match.method="auto"`` resolves to exact L1 here. That is what the JAX
package itself picks on any backend other than a TPU
(``computervisionimagestich2_tpu/ops/distance.py::_l2pre_enabled``); on a
TPU its default is the MXU-prefiltered ``"l2pre"``, which the port runs
only when asked for by name. So the port's default follows the JAX
package's CPU and GPU decisions, not its TPU ones.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT scale-space / detector / descriptor parameters.

    Mirrors VlSiftFilt defaults (vl/sift.c:233-275) and the app's choices
    (ImageProcess.cpp:54-55: noctaves=4, nlevels=2, o_min=0).
    """

    n_octaves: int = 4            # NOTAVES_NUM, ImageProcess.h:15
    n_levels: int = 2             # LEVEL_NUM (S), ImageProcess.h:16
    o_min: int = 0                # first octave index (ImageProcess.cpp:55)
    sigma_n: float = 0.5          # nominal input smoothing, vl/sift.c:251
    sigma0_factor: float = 1.6    # sigma0 = 1.6 * 2^(1/S), vl/sift.c:253
    peak_thresh: float = 0.0      # vl/sift.c:267
    edge_thresh: float = 10.0     # vl/sift.c:268
    norm_thresh: float = 0.0      # vl/sift.c:269
    magnif: float = 3.0           # descriptor SBP = magnif * sigma, vl/sift.c:270
    n_ori_bins: int = 36          # orientation histogram bins, vl/sift.c:934
    n_spatial_bins: int = 4       # NBP, vl/sift.c:19
    n_desc_ori_bins: int = 8      # NBO, vl/sift.c:18
    max_angles: int = 4           # <=4 orientations per keypoint, sift.c:1018
    # Static capacities (dense masks instead of the reference's growing
    # keys buffer, vl/sift.c:580-590). 0 = auto: scale with the input's
    # pixel count, so large inputs keep every keypoint the reference's
    # dynamic buffers would.
    max_keypoints_per_octave: int = 0
    max_keypoints: int = 0        # total after orientation expansion
    # Keypoint-walk backend of the JAX package ("auto": its Pallas kernels
    # on a TPU, the dense batch elsewhere). The port always walks with
    # kernels B2/B3 on the card and their plain versions on the CPU.
    pallas: str = "auto"
    # DoG extrema detection: "pallas" (default) = the fused detect, kernel
    # B1 in the port; "xla" = the dense 26-neighbour mask + compaction.
    # Bit-identical results.
    detect_impl: str = "pallas"
    # Weight precision of the JAX package's Pallas descriptor walks: "f32"
    # (default) or "bf16", a TPU experiment the port does not run.
    walk_dtype: str = "f32"

    @property
    def sigma_k(self) -> float:
        return 2.0 ** (1.0 / self.n_levels)

    @property
    def sigma0(self) -> float:
        return self.sigma0_factor * self.sigma_k

    @property
    def dsigma0(self) -> float:
        return self.sigma0 * math.sqrt(1.0 - 1.0 / (self.sigma_k * self.sigma_k))

    @property
    def s_min(self) -> int:
        return -1                 # vl/sift.c:238

    @property
    def s_max(self) -> int:
        return self.n_levels + 1  # vl/sift.c:239


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching. The reference uses a 1-tree kd-forest with L1
    distance and Lowe ratio 0.5 (ImageProcess.cpp:280, ImageProcess.h:22).
    TPU-native: exact all-pairs distance on the MXU/VPU + top-2."""

    ratio_threshold: float = 0.5  # RATIO_THRESHOLD, ImageProcess.h:22
    distance: str = "l1"          # VlDistanceL1, ImageProcess.cpp:280
    pair_threshold: int = 20      # THRESHOLD (min matches to stitch), ImageProcess.h:18
    # Static capacity for match pairs; the reference keeps every match
    # (vector<ImgPair>), and overflow is reported (match_overflow).
    max_matches: int = 4096
    # 2-NN backend of the JAX package ("auto": its Pallas kernel on a
    # TPU). The port's exact L1 matches with kernel B4/B7 on the card.
    pallas: str = "auto"
    # L1 2-NN strategy: "exact" scores every descriptor pair; "l2pre"
    # (the JAX package's TPU default under "auto") keeps the l2pre_m
    # nearest by L2 and rescores those by exact L1. "auto" = exact off a
    # TPU, and always in the port, which runs "l2pre" when named.
    method: str = "auto"
    l2pre_m: int = 12             # l2pre candidates rescored per query
    l2pre_m_counts: int = 8       # the same for the ordering stage's counts


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC warp estimation (ImageProcess.cpp:395-529)."""

    n_sample: int = 4             # NUM_OF_PAIR, ImageProcess.h:29
    confidence: float = 0.99      # CONFIDENCE (hardcoded again at cpp:398)
    inlier_ratio: float = 0.5     # INLINER_RATIO
    threshold: float = 4.0        # RANSAC_THRESHOLD, ImageProcess.h:32
    seed: int = 666666            # srand(666666), ImageProcess.cpp:397
    # hypotheses scored in one batch; >= the reference's 72 sequential
    # iterations
    n_hypotheses: int = 128
    # Local-optimisation rounds after the refit (LO-RANSAC): re-score the
    # refit model and refit again when its consensus grew. 0 = the
    # reference's plain refit-and-stop (ImageProcess.cpp:500-529).
    lo_iters: int = 1

    @property
    def reference_iterations(self) -> int:
        return math.ceil(
            math.log(1 - self.confidence)
            / math.log(1 - self.inlier_ratio ** self.n_sample)
        )


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Cylindrical projection (Projection.h:12, Projection.cpp:20-73)."""

    angle_deg: float = 15.0       # ANGLE, Projection.h:12


@dataclasses.dataclass(frozen=True)
class BlendConfig:
    """Multi-band Laplacian blend (ImageProcess.cpp:648-773)."""

    blur_sigma: float = 2.0       # get_blur(2,...), ImageProcess.cpp:709
    # With "fir" on the card at most 16: the separable-blur kernel takes a
    # radius ceil(4 sigma) of at most 64 (``ops/_native.MAX_BLUR_RADIUS``)
    # and raises ValueError above it; the CPU's shift-and-add has no limit.
    # "fir": separable FIR Gaussian; "vanvliet": CImg's exact recursive
    # filter with Triggs boundaries (get_blur(2,true,true)), the parity
    # mode; "fir_fused": a TPU-only fused blur-and-shrink, not ported.
    blur_impl: str = "fir"
    # root variant: levels = floor(log2(max(w,h))) (ImageProcess.cpp:675-676)
    # ex6 variant:  levels = floor(log2(min(w,h))) (src/ex6/ImageProcess.cpp:662-665)
    level_mode: str = "max"       # "max" (root) | "min" (ex6)
    max_levels: int = 12
    # Extension beyond the reference: match the incoming image's overlap
    # mean to the canvas before blending.
    gain_compensation: bool = False
    # "luma" = one scalar gain; "rgb" = one gain per channel.
    gain_mode: str = "luma"
    # "f32" | "bf16" | "auto" (default): "auto" blends in bfloat16 when the
    # blend canvas exceeds ``bf16_auto_area`` pixels and in f32 below.
    dtype: str = "auto"
    bf16_auto_area: int = 1_500_000
    # 0 (parity default) = blend the full canvas like the reference;
    # > 0 = pyramid-blend only a 4*seam_band-wide window at the seam and
    # copy a/b elsewhere.
    seam_band: int = 0
    # Area-gated automatic seam band: when seam_band == 0 and the blend
    # canvas exceeds seam_auto_area pixels, blend a 4*seam_auto_band
    # window at the seam instead of the full canvas. 0 disables it.
    seam_auto_area: int = 2_000_000
    seam_auto_band: int = 256


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    """Histogram equalization + YCbCr luma mix (ImageProcess.cpp:237-270)."""

    # Run the equalization/luma-mix tail at all (CLI --no-enhance clears it).
    enabled: bool = True
    # Reference quirk: Y uses 0.857 for G instead of 0.587 at all three
    # conversion sites (ImageProcess.cpp:242,252; equalization.cpp:79).
    # compat=True reproduces it; compat=False uses the correct 0.587.
    compat_luma: bool = True
    # root mixes 19/20 : 1/20 (ImageProcess.cpp:261); ex6 uses 5/6 : 1/6
    # (src/ex6/ImageProcess.cpp:270).
    mix_weight: float = 19.0 / 20.0


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    sift: SiftConfig = dataclasses.field(default_factory=SiftConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    projection: ProjectionConfig = dataclasses.field(default_factory=ProjectionConfig)
    blend: BlendConfig = dataclasses.field(default_factory=BlendConfig)
    enhance: EnhanceConfig = dataclasses.field(default_factory=EnhanceConfig)
    # "bilinear" = the reference's 8-coefficient warp (ImageProcess.h:58-73);
    # "projective" = true DLT homography.
    warp_model: str = "bilinear"
    # "graph" = root variant's match-graph discovery over unordered images
    # (ImageProcess.cpp:101-147); "chain" = ex6's pre-ordered left-to-right
    # adjacency (src/ex6/ImageProcess.cpp:150-159).
    ordering: str = "graph"
    # Dense-graph BFS: "skip" (default) stitches each image exactly once
    # (a spanning tree); "faithful" reproduces the reference's unguarded
    # BFS, which re-stitches images on dense graphs.
    graph_revisit: str = "skip"
    # Per-edge Reinhard color transfer of the incoming image toward its
    # stitch partner, the call the reference has commented out in its
    # stitch loop (ImageProcess.cpp:180). Off by default, like the
    # reference.
    color_transfer: bool = False
    # Canvas sizes are rounded up to multiples of this in bucketed mode.
    canvas_bucket: int = 128
    # planned=True registers every stitch edge before compositing and
    # reads back one [E, 23] plan; False = the incremental per-edge loop.
    planned: bool = True
    # exact_canvas=True (default) composites/blends at the reference's
    # exact canvas size; False pads each canvas up to canvas_bucket
    # multiples for the blend and crops back (output differs only by
    # pyramid blur bleed near the padded borders).
    exact_canvas: bool = True
    # Compute dtype for image-space kernels.
    dtype: str = "float32"


DEFAULT_CONFIG = StitchConfig()

SLICE_CONFIG = dataclasses.replace(
    DEFAULT_CONFIG,
    ordering="chain",
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, detect_impl="xla"),
    match=dataclasses.replace(DEFAULT_CONFIG.match, method="exact"),
)


def check_supported(cfg: StitchConfig) -> None:
    """Raise NotImplementedError if ``cfg`` leaves the ported
    configurations."""
    unsupported = [
        (cfg.blend.blur_impl == "fir_fused", "blend.blur_impl='fir_fused'",
         "§A 'Do not port' (a TPU-only fused blur)"),
        (cfg.sift.walk_dtype != "f32", "sift.walk_dtype='bf16'",
         "§A 'Do not port' (a TPU-only experiment)"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is outside the ported configurations; see "
                f"ROADMAP.md {item}")
