"""Global configuration (the port's own copy of the JAX package's ``Config``).

A plain dataclass: no singleton, explicitly passed where needed.  The
fixed-capacity paddings are kept because the batched kernels are sized by
them and use validity masks instead of dynamic lengths; field names and
defaults match the JAX package so both sides run the same configuration.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # ---- pipeline knobs ----
    # (the reference's grid_size / reproj_thresh / poseoptim_num_iter knobs
    # are decorative there too — cell size is derived, reprojThresh is never
    # read, and frame_handler_mono.cpp:242 hardcodes 12 pose iterations — so
    # they are not reproduced here.  Likewise NOT reproduced as knobs, being
    # compile-time structure in the static-shape build: the 3-level
    # feature pyramid (image/pyramid.py n_pyr_levels default), the 8×8
    # alignment patch (ops/align.py BORD), the epipolar sample count
    # (ops/epipolar.py), the 16-view seed refinement ring
    # (mapping/depth_filter.py N_OBS_RING), and the reference's
    # LIGHT_THRESHOLD exposure-compensation gate (matcher.cpp:40) — the
    # batched matcher always applies exposure compensation, which subsumes
    # the gate.)
    core_n_kfs: int = 7             #: size of covisibility core for local BA
    map_scale: float = 1.0          #: median scene depth after bootstrap
    init_min_disparity: float = 40.0
    init_min_tracked: int = 50
    init_min_inliers: int = 40
    klt_max_level: int = 4          #: coarse tracker top pyramid level
    klt_min_level: int = 0          #: coarse tracker bottom level (tracker uses min+1)
    poseoptim_thresh: float = 2.0
    loba_thresh: float = 2.0        #: BA corner outlier-strip threshold [px]
    loba_num_iter: int = 10
    loba_pose_writeback: bool = False  #: write BA-refined keyframe poses back
    #: into the registry/trajectory.  The reference does (bundle_adjustment
    #: .cpp:826-834) because its shared-memory tracker consumes them
    #: continuously; this framework's synchronous chain deliberately keeps
    #: the device pose cache pre-BA (ba_glue.py note), so recorded BA poses
    #: are epoch-inconsistent with the tracked chain around them.  Measured
    #: on boxseq-2200 (artifacts/boxseq_2200_ate.json): poses+idist 15.3 mm
    #: RMSE / 161 mm max excursion; idist-only (this default) 3.5 mm /
    #: 9.1 mm; no BA at all 3.2 mm / 7.7 mm.  Structure refinement and
    #: outlier stripping stay on either way.
    max_n_kfs: int = 2000           #: keyframe registry capacity
    max_fts: int = 200              #: feature budget per frame
    quality_min_fts: int = 5
    quality_max_drop_fts: int = 40
    edgelet_angle: float = 0.86     #: cos(angle) gate for edgelet normal agreement
    use_gradient_features: bool = True  #: third species: per-cell max-|∇I| fill
                                    #: (gradDetectST, feature_detection.cpp:609-664)

    # ---- coarse tracker ----
    coarse_n_iter: int = 30         #: LM iterations per level (ref uses <=50 w/ early stop)
    coarse_pattern_offset: int = 2  #: first pattern table used at the top level

    # ---- static-shape capacities ----
    n_fts_max: int = 320            #: feature-slot padding per frame (>= max_fts;
                                    #: obs tables are sized max(n_fts_max, grid
                                    #: cells) — FrameHandler._n_obs_pad)
    n_seeds_max: int = 1024         #: depth-filter seed slots (≥ n_fts_max ×
                                    #: max_seed_kf_batches: a batch allocates at
                                    #: most one seed per detection slot and lives
                                    #: 3 keyframe batches)
    n_kfs_window: int = 16          #: BA keyframe slots (free + fixed)
    n_points_ba_max: int = 2048     #: BA point slots
    align_max_iter: int = 10        #: feature-alignment LM iterations (matcher)
    pre_frames_max: int = 3         #: ring of recent non-KF frames for seed backfill

    # ---- depth filter ----
    seed_converge_sigma2_thresh: float = 200.0  #: σ-ratio convergence bar
                                    #: (halved on sparse frames, ref 100/200)
    max_seed_kf_batches: int = 3    #: seed lifetime in KF batches (ref options_.max_n_kfs)

    # ---- distributed BA (BASELINE.json config 5) ----
    distributed_ba: bool = False    #: route windowed BA through the
                                    #: point-block-sharded multi-device solver
    ba_n_devices: int = 0           #: mesh size for distributed BA (0 = all)

    # ---- matching ----
    patch_source: str = "recency"   #: reference-patch view per map point:
                                    #: "recency" keeps ONE memoized view
                                    #: refreshed at each observing keyframe;
                                    #: "closest" additionally keeps the host
                                    #: view and picks the smaller viewing
                                    #: angle per match (Point::getCloseViewObs
                                    #: analogue over the two stored views)

    # ---- photometric ----
    photometric_calib: bool = False      #: online response/vignette calibration
                                         #: (TUM MonoVO-class auto-exposure input)

    def __post_init__(self) -> None:
        assert self.n_fts_max >= self.max_fts
        # coarse tracking must reach down to the 3 matching-pyramid levels
        assert self.klt_max_level >= 2


DEFAULT_CONFIG = Config()
