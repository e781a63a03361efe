"""Frozen dataclass configs + the five acceptance presets.

The preset list mirrors BASELINE.json ``configs[0..4]`` verbatim (SURVEY.md
§5.6). All parameters the reference family exposes are here: Gabor bank
parameterization (scales, orientations, frequencies), color space, cluster
method (kmeans/gmm) and k, superpixel count, cut method (ncut/min-cut)
and batch size.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Gabor bank
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BankConfig:
    """Gabor filter-bank parameterization: scales x orientations x frequencies.

    * ``scales``      — Gaussian-envelope sigmas (pixels), one per scale.
    * ``orientations`` — number of evenly spaced orientations in [0, pi).
    * ``frequencies`` — absolute spatial frequencies (cycles/pixel). ``None``
      derives one frequency per scale from a 1-octave bandwidth:
      sigma/lambda = 0.56 (Jain-Farrokhnia convention), i.e. f = 0.56/sigma.
    * ``gamma``       — envelope aspect ratio (1.0 = isotropic).
    * ``psi``         — phase offset of the complex carrier. Irrelevant to the
      energy magnitude; kept for kernel-level parity with
      ``cv2.getGaborKernel`` (whose default is pi/2).
    * ``truncate``    — kernel half-size = ceil(truncate * sigma).
    * ``max_ksize``   — odd cap on kernel side length (FLOP budget).
    * ``smoothing``   — Gaussian-energy smoothing sigma = smoothing * sigma_s.
    * ``smooth_truncate`` — smoothing kernel radius = ceil(smooth_truncate*sigma).
    """

    scales: Tuple[float, ...] = (2.0, 4.0, 8.0)
    orientations: int = 4
    frequencies: Optional[Tuple[float, ...]] = None
    gamma: float = 1.0
    psi: float = 0.0
    truncate: float = 3.0
    max_ksize: int = 31
    smoothing: float = 1.0
    smooth_truncate: float = 3.0

    @property
    def n_frequencies(self) -> int:
        return 1 if self.frequencies is None else len(self.frequencies)

    @property
    def n_kernels(self) -> int:
        return len(self.scales) * self.orientations * self.n_frequencies

    def kernel_params(self) -> list[tuple[float, float, float, int]]:
        """Flat list of (sigma, theta, lambda, ksize), kernel-index order.

        Index order is scale-major, then orientation, then frequency:
        ``idx = (s * orientations + o) * n_freq + f`` — this order is part of
        the feature-layout contract shared with the golden path.
        """
        params = []
        for sigma in self.scales:
            for o in range(self.orientations):
                theta = math.pi * o / self.orientations
                if self.frequencies is None:
                    freqs = (0.56 / sigma,)
                else:
                    freqs = self.frequencies
                for f in freqs:
                    lam = 1.0 / f
                    ksize = self.ksize_for(sigma)
                    params.append((sigma, theta, lam, ksize))
        return params

    def ksize_for(self, sigma: float) -> int:
        k = 2 * int(math.ceil(self.truncate * float(sigma))) + 1
        k = min(k, self.max_ksize)
        return k | 1  # force odd

    def smooth_sigma_for(self, sigma: float) -> float:
        return self.smoothing * float(sigma)

    def smooth_radius_for(self, sigma: float) -> int:
        return int(math.ceil(self.smooth_truncate * self.smooth_sigma_for(sigma)))

    @property
    def max_halo(self) -> int:
        """Largest (conv radius + smoothing radius) over the bank — the halo a
        spatial tile needs (SURVEY.md §5.7)."""
        h = 0
        for sigma, _, _, ksize in self.kernel_params():
            h = max(h, ksize // 2 + self.smooth_radius_for(sigma))
        return h

    @property
    def max_conv_radius(self) -> int:
        """Largest conv (envelope) radius — the INPUT halo of the two-level
        tiled exchange (parallel/tiling.py exchanges input rows for the conv
        stage and magnitude rows for the smoothing stage separately, so the
        border contract — reflect the MAGNITUDE map — holds exactly)."""
        return max(ksize // 2 for _, _, _, ksize in self.kernel_params())

    @property
    def max_smooth_radius(self) -> int:
        """Largest smoothing radius — the MAGNITUDE halo of the two-level
        tiled exchange."""
        return max(
            self.smooth_radius_for(sigma)
            for sigma, _, _, _ in self.kernel_params()
        )


# ---------------------------------------------------------------------------
# Clustering
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterConfig:
    """Pixel-clustering stage (SURVEY.md C8/C9)."""

    method: str = "kmeans"  # "kmeans" | "gmm"
    k: int = 5
    n_iter: int = 25  # Lloyd iterations / EM iterations
    # Multigrid Lloyd schedule (k-means only): when coarse_iters > 0, the
    # solver seeds + runs ``coarse_iters`` Lloyd iterations on the 2x2
    # mean-pooled pixel grid (1/4 the memory traffic per pass; pooled features
    # are exact block means, computed in f32), then refines with up to
    # ``refine_iters`` full-resolution iterations (early exit at the Lloyd
    # fixed point) and assigns labels at full resolution. Deterministic
    # schedule, mirrored bit-for-bit by golden/cluster.py — PRI
    # equal-or-better vs 25 full iterations on the synthetic eval. 0 =
    # classic single-grid Lloyd (n_iter).
    # Premise: 2x2 neighbors have similar features (true for image
    # pipelines; a spatially-shuffled feature matrix would make the pooled
    # warmup useless — tests/test_kmeans.py documents the failure mode).
    coarse_iters: int = 0
    refine_iters: int = 10
    # Intermediate-level Lloyd passes of the multigrid schedule: with
    # coarse_levels >= 2, run ``mid_iters`` Lloyd iterations at EACH
    # intermediate pooled level (coarsest-1 .. level 1, ascending) between
    # the coarse warmup and the full-resolution refinement. A 2x2-level
    # pass streams 1/4 the bytes of a full-res pass, so a few mid passes
    # let ``refine_iters`` drop sharply: at config1 mid=3/refine=1 matches
    # mid=0/refine=5 PRI exactly (0.6994) at 0.999 label agreement.
    # Mirrored by golden. 0 = no intermediate passes (the coarse centers
    # feed the full-res refinement directly).
    mid_iters: int = 0
    # Coarse-grid depth of the multigrid schedule: the warmup grid is the
    # full grid 2x2-mean-pooled ``coarse_levels`` times (1 = 2x2 blocks,
    # 2 = 4x4 blocks = 1/16 the pixels). Deeper grids make the warmup
    # (seeding + coarse Lloyd + its layout glue) nearly free while the
    # final labels still come from the unchanged full-resolution
    # refinement; golden mirrors the identical pooling (pool2x2 applied
    # ``coarse_levels`` times, f32 sums, cast between levels).
    coarse_levels: int = 1
    subsample: int = 1  # fit Lloyd on every n-th pixel (1 = exact; speed knob)
    # maximin init seeds from every n-th pixel; the golden path mirrors the
    # identical subset, so parity is exact at any value. The farthest-point
    # scan costs ~k full passes over the pixels, but a strided seed can land
    # k-means in a different basin (a real PRI regression on a small
    # mosaic), so the default stays exact.
    init_stride: int = 1
    color_weight: float = 1.0  # relative weight of Lab dims vs energy dims
    normalize: bool = True  # per-image feature standardization
    # Feature-ablation knob (proves the Gabor bank earns its cost): "full" = energies ++ color (production), "color" =
    # color channels only (no Gabor energies), "texture" = energies only.
    # Implemented in the feature assembly + golden mirror.
    feature_set: str = "full"
    # Cue weighting of the standardized feature dims:
    #   "static"    — the classic equal-total-variance balance only.
    #   "coherence" — additionally weight each dim by its REGION-SCALE
    #     coherence: std(8x8 block means)/std (per image, per dim). Raw
    #     color channels on texture-dominated images carry the high-freq
    #     oscillation itself (high variance, locally uninformative); block
    #     means cancel it while region-level signal survives, so
    #     uninformative dims shrink instead of being standardized UP.
    #     On 12-image synthetic splits: texture-only split PRI 0.63 -> 0.89
    #     (the static balance drowned the Gabor energies in raw-oscillation
    #     color variance); standard split PRI -0.005 (noise), boundary-F
    #     0.21 -> 0.30. Feature assembly + golden mirror + tiled strips.
    cue_weight: str = "static"
    # Exponent on the coherence weights (cue_weight="coherence" only):
    # feats *= c^pow. Gaussian energy smoothing makes EVERY
    # energy dim spatially coherent (mean c ~= 0.94 on both ablation
    # splits), so p=1 cannot down-weight uninformative energies and the
    # 36-dim energy block dilutes the 3 color dims. Sharpening to p=2
    # dominates BOTH static and p=1 on BOTH splits (standard: PRI
    # 0.8600/F 0.2744 vs 0.8435/0.1919 static; texture-only: 0.9026/0.5750
    # vs 0.6304/0.3501 static). Presets keep cue_weight="static" for
    # reference-faithful semantics; coherence_pow=2.0 is the measured
    # recommendation when enabling coherence.
    coherence_pow: float = 1.0
    gmm_reg_covar: float = 1e-4
    # EM early exit: stop when the mean log-likelihood improves by < gmm_tol
    # (sklearn GaussianMixture.tol semantics, mirrored in golden). 0 = run
    # exactly n_iter iterations.
    gmm_tol: float = 0.0
    # GMM pooled-fit grid: > 0 fits the mixture on the pixel grid
    # 2x2-mean-pooled this many times (exact block means, the multigrid
    # Lloyd's pooling) and labels every full-resolution pixel with one
    # final E-step — each EM pass streams 1/4^p of the data. Mirrored in
    # golden and the XLA solver; mean PRI on the synthetic eval: 0.7129
    # (full-res fit) / 0.7178 (2x2) / 0.7226 (4x4) — block means DENOISE
    # the covariance estimates of smooth image features. 0 = classic
    # full-res fit.
    gmm_fit_pool: int = 0
    # Full-resolution EM iterations run AFTER the pooled fit, before the
    # final E-step. Block-mean fitting shrinks within-cluster covariances
    # (averaging removes variance), which moves the full-res log-prob
    # decision boundaries — a boundary-F drop on the synthetic eval; a
    # couple of full-res passes restore the covariance scale.
    gmm_refine_iters: int = 0
    seed: int = 0


# ---------------------------------------------------------------------------
# Graph partition (superpixels + cut)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GraphConfig:
    """Superpixel + graph-cut stage (SURVEY.md C10-C13)."""

    enabled: bool = False
    n_superpixels: int = 400  # target superpixel count (grid-seeded)
    slic_compactness: float = 10.0
    slic_iters: int = 10
    # Multirate graph stage: pool > 0 runs the WHOLE graph stage (SLIC +
    # connectivity + affinity + n-cut) on the pixel grid 2x2-mean-pooled
    # ``pool`` times (exact f32 block means of energies, color and Lab —
    # the multigrid Lloyd's pooling), then upsamples the final region map
    # back to full resolution. Superpixel cells keep their FULL-RES size
    # (n_superpixels is resolution-independent), so the only cost is region
    # boundaries quantized to 2^pool px — at 4K (config4, pool=2) that is
    # 4 px against a 33 px boundary-F matching tolerance, for 1/16 the
    # SLIC/connectivity/moments work. Requires H and W divisible by
    # 2^pool. Mirrored by golden (pool in f64 before the golden chain).
    pool: int = 0
    cut: str = "ncut"  # "ncut" | "mincut"
    n_regions: int = 5  # final region count for ncut
    affinity_sigma: Optional[float] = None  # None => median-heuristic
    # Multiplier on the median-heuristic bandwidth (sigma^2 = scale *
    # median(d2); ignored when affinity_sigma is explicit). The raw median
    # is ~4x too soft on the multi-GT eval: scale 0.1 moved config3's mean
    # F 0.24 -> 0.53 at 900/comp-5 superpixels with PRI equal-or-better.
    # 1.0 = the classic heuristic.
    affinity_sigma_scale: float = 1.0
    # "eigh" = exact dense solve ("auto" resolves to it); "subspace" =
    # matmul-only subspace iteration (label ARI >= 0.975 vs eigh on
    # structured inputs). Resolved in dispatch.py.
    eig_method: str = "auto"  # "auto" | "eigh" | "subspace"
    adjacency_only: bool = False  # restrict affinity to adjacent superpixels
    mincut_k: float = 300.0  # Felzenszwalb-style merge threshold
    mincut_min_size: int = 10  # minimum region size (in superpixels)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end run configuration (one of these == one experiment)."""

    name: str = "custom"
    bank: BankConfig = BankConfig()
    cluster: ClusterConfig = ClusterConfig()
    graph: GraphConfig = GraphConfig()
    color_space: str = "lab"  # "lab" | "rgb"
    image_hw: Tuple[int, int] = (321, 481)  # BSDS500 landscape; portrait is transposed on load
    batch_size: int = 1
    dtype: str = "float32"  # compute dtype for the feature stage: "float32" | "bfloat16"
    # feature-stage implementation, resolved in dispatch.py:
    #   "direct"    — depthwise 2-D convs (reference-shaped; any gamma)
    #   "modulated" — modulate + separable blur factorization (gamma=1; ~8x
    #                 fewer FLOPs, exactly equal values)
    #   "triton"    — fused Pallas kernel compiled through Triton (gamma=1,
    #                 GPU only; ops/gabor_triton.py)
    #   "auto"      — triton for bf16 on a GPU, else modulated, else direct
    feature_impl: str = "auto"
    tile_hw: Optional[Tuple[int, int]] = None  # spatial tiling for large images

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The five acceptance presets — BASELINE.json configs[0..4], verbatim mapping
# ---------------------------------------------------------------------------

_SMALL_BANK = BankConfig(scales=(2.0, 4.0, 8.0), orientations=4, frequencies=None)
_FULL_BANK = BankConfig(
    scales=(1.5, 2.5, 4.0, 6.0, 8.0),
    orientations=8,
    frequencies=(0.10, 0.20),
)

PRESETS: dict[str, PipelineConfig] = {
    # 0: "Single BSDS500 image (481x321), 4-orientation x 3-scale Gabor bank,
    #     k-means k=5 — CPU-runnable reference path"
    "config0": PipelineConfig(
        name="config0",
        bank=_SMALL_BANK,
        # cue_weight="coherence", pow=4: on the production 321x481 multi-GT
        # eval it is the PRI winner for BOTH kmeans presets (config0 0.7550
        # vs 0.7164 static, F -0.028; config1 0.7288 vs 0.6475, F +0.013),
        # and the 161x241 F-optimum (p=4: 0.3506 vs 0.1919 static). Static
        # remains one flag away (--cue-weight static).
        cluster=ClusterConfig(method="kmeans", k=5,
                              cue_weight="coherence", coherence_pow=4.0),
        graph=GraphConfig(enabled=False),
        batch_size=1,
        # "auto" resolves per backend and dtype (dispatch.py); the
        # reference-shaped "direct" impl stays one flag away
        feature_impl="auto",
    ),
    # 1: "Full Gabor bank (8 orientations x 5 scales x 2 frequencies) over
    #     CIELab channels, batch of 16 images"
    "config1": PipelineConfig(
        name="config1",
        bank=_FULL_BANK,
        # multigrid Lloyd (see ClusterConfig): 15 passes on the 4x4 grid,
        # 3 on the 2x2 grid, <=1 at full resolution — PRI equal-or-better
        # than 25 full iterations; golden mirrors the identical schedule.
        # The full-res pass still produces the labels — only the
        # center-polish work moved to cheaper grids.
        # cue_weight="coherence", pow=4: see the config0 note — the
        # dilution mechanism (smoothing makes all energy dims coherent,
        # diluting color) hits THIS preset hardest, and p=4 closes most of
        # the gap (PRI 0.6475 -> 0.7288; F 0.3588 -> 0.3713, both better).
        cluster=ClusterConfig(
            method="kmeans", k=5, coarse_iters=15, refine_iters=1,
            coarse_levels=2, mid_iters=3,
            cue_weight="coherence", coherence_pow=4.0,
        ),
        graph=GraphConfig(enabled=False),
        batch_size=16,
    ),
    # 2: "Gabor+color features -> GMM clustering with per-image EM, BSDS500 val split"
    "config2": PipelineConfig(
        name="config2",
        bank=_SMALL_BANK,
        # gmm_tol = sklearn's GaussianMixture default (1e-3): EM stops at
        # convergence instead of always burning 30 iterations; golden
        # mirrors the identical rule so parity is preserved.
        # gmm_fit_pool=2 + gmm_refine_iters=1: the mixture is fitted on the
        # 4x4 block-mean grid (1/16 the pixels per EM pass), then ONE
        # full-resolution EM pass restores the covariance scale the
        # block-mean fit shrinks, then full-resolution labels. On the
        # 20-image synthetic eval at production bf16:
        #   full-res fit:        PRI 0.7129  F 0.0659
        #   4x4 fit, no refine:  PRI 0.7273  F 0.0194
        #   4x4 fit + 1 refine:  PRI 0.7288  F 0.0653  <- this
        # Block means denoise the mixture (better PRI) but shrink
        # covariances (boundary-F collapse); the refine pass fixes the
        # latter. golden mirrors the identical schedule.
        cluster=ClusterConfig(method="gmm", k=5, n_iter=30, gmm_tol=1e-3,
                              gmm_fit_pool=2, gmm_refine_iters=1),
        graph=GraphConfig(enabled=False),
        batch_size=8,
    ),
    # 3: "Superpixel affinity graph + spectral normalized-cut segmentation,
    #     full BSDS500 test set (200 images)"
    "config3": PipelineConfig(
        name="config3",
        bank=_SMALL_BANK,
        cluster=ClusterConfig(method="kmeans", k=5),
        # Boundary-F remedy. The diagnosis decomposed the 0.245-vs-0.414
        # deficit into two stacked causes: (1) the 400-cell superpixel
        # stage CAPPED the chain — the ORACLE merge of those superpixels
        # reached only F 0.370 (900 cells at compactness 5 raise the
        # ceiling to 0.742, SLIC recall 0.96); (2) the median-heuristic
        # affinity bandwidth was ~4x too soft — scale 0.1 recovers the
        # merge's share. Operating point on the full 20-image multi-GT
        # eval: F 0.2453 -> 0.5517 (2.2x, now ABOVE config0's 0.41), PRI
        # 0.7121 vs 0.7147 (within 0.003), VoI 1.370 -> 1.146 and covering
        # 0.491 -> 0.505 both better.
        graph=GraphConfig(enabled=True, n_superpixels=900,
                          slic_compactness=5.0, cut="ncut", n_regions=8,
                          affinity_sigma_scale=0.1),
        batch_size=8,
    ),
    # 4: "Tiled 4K-image pipeline, data-parallel batch sharded across
    #     devices with fused filter->cluster->cut chain" (BASELINE.json
    #     configs[4], device name elided)
    "config4": PipelineConfig(
        name="config4",
        bank=_SMALL_BANK,
        cluster=ClusterConfig(method="kmeans", k=5),
        # The spec'd CUT chain (BASELINE.json config 4: "fused
        # filter->cluster->cut"): SLIC + connectivity + affinity + n-cut on
        # the 4x4-pooled grid (GraphConfig.pool — at 4K the 4 px boundary
        # quantization is far inside the 33 px boundary-F tolerance, for
        # 1/16 the graph-stage work).
        graph=GraphConfig(enabled=True, pool=2),
        image_hw=(2160, 3840),
        batch_size=8,
        # 432x768 windows bound the feature stage's device memory at 4K:
        # the XLA feature forms materialize several f32 planes per scale
        # group, each ~ window area (ops/tiled.py). Not yet tuned for the
        # GPU (ROADMAP S5).
        tile_hw=(432, 768),
    ),
}


def preset(name: str) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
