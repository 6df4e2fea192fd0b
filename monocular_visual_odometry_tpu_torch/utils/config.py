"""Typed configuration for the VO engine.

A copy of the dataclass tree of ``monocular_visual_odometry_tpu.utils.config``
with the same field names and defaults, so a config built for the JAX
package carries over field by field (``convert.config_to_torch``). The YAML
loader is not part of this copy: it needs PyYAML, which the port does not
depend on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class OrbConfig:
    """Feature detection."""

    num_keypoints: int = 8000            # candidate pool (kept for API parity)
    max_keypoints: int = 1024            # keypoints kept per frame
    scale_factor: float = 1.2            # pyramid scale
    n_levels: int = 4                    # pyramid levels
    score_threshold: float = 20.0        # FAST threshold
    grid_size: int = 16                  # uniform-selection grid cell (px)
    max_pts_per_grid: int = 8            # keypoints kept per cell
    patch_size: int = 31                 # BRIEF sampling patch
    harris_k: float = 0.04


@dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching."""

    method_index: int = 3                # 1=threshold BF, 2=Lowe ratio, 3=radius BF
    xiang_gao_match_ratio: float = 2.0   # dist_th = max(min_dist * ratio, 30)
    lowe_dist_ratio: float = 0.8
    max_pixel_dist_init: float = 100.0
    max_pixel_dist_triang: float = 100.0
    max_pixel_dist_pnp: float = 50.0
    method3_ambiguity_ratio: float = 1.0  # best < ratio * second gate; 1.0 = off


@dataclass(frozen=True)
class RansacConfig:
    """Essential/homography/PnP RANSAC with a fixed hypothesis batch."""

    threshold_px: float = 1.0
    n_hypotheses: int = 256
    essential_minimal: str = "8pt"       # or "5pt": five-point minimal samples
    pnp_n_hypotheses: int = 256
    pnp_reproj_threshold_px: float = 2.0
    pnp_min_inliers: int = 5
    keyframe_use_ransac_filter: bool = False


@dataclass(frozen=True)
class TriangulationConfig:
    min_triang_angle_deg: float = 1.0
    max_ratio_angle_over_median: float = 20.0


@dataclass(frozen=True)
class InitConfig:
    """Initialization quality gates."""

    min_inlier_matches: int = 15
    min_pixel_dist: float = 50.0
    min_median_triang_angle_deg: float = 2.0
    assumed_mean_depth: float = 0.8
    use_reference_selection: bool = False


@dataclass(frozen=True)
class TrackingConfig:
    """Keyframe / PnP safety thresholds and the motion-model gate."""

    min_dist_between_keyframes: float = 0.03
    max_dist_to_prev_keyframe: float = 0.3
    use_motion_model: bool = True
    motion_gate_union: bool = True


@dataclass(frozen=True)
class BAConfig:
    """Windowed bundle adjustment (``models/ba.py``). ``deterministic``
    runs the LM's reductions in float64."""

    enabled: bool = True
    window: int = 5
    information_matrix: tuple = (1.0, 0.0, 0.0, 1.0)
    fix_map_points: bool = True
    iterations: int = 12
    huber_delta: float = 3.0
    obs_gate_px: float = 9.0
    init_lambda: float = 1e-3
    regate_px: float = 0.0
    regate_sigma_mult: float = 2.5
    max_pose_correction: float = 0.03
    deterministic: bool = False
    keyframe_window: bool = True


@dataclass(frozen=True)
class MapConfig:
    """Local-map capacities and culling."""

    max_map_points: int = 4096
    default_erase_ratio: float = 0.1
    max_view_angle_deg: float = 45.0
    frame_buffer: int = 20
    max_keyframes: int = 64
    track_candidates: int = 1536


@dataclass(frozen=True)
class DatasetConfig:
    dataset_dir: str = ""
    num_images: int = 150
    fx: float = 615.0
    fy: float = 615.0
    cx: float = 320.0
    cy: float = 240.0
    height: int = 480
    width: int = 640
    is_draw_true_traj: bool = False
    true_traj_filename: str = ""


@dataclass(frozen=True)
class VOConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    triang: TriangulationConfig = field(default_factory=TriangulationConfig)
    init: InitConfig = field(default_factory=InitConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    map: MapConfig = field(default_factory=MapConfig)
    max_num_imgs_to_proc: int = 300
    save_predicted_traj_to: str = "output/cam_traj.txt"
    output_folder: str = "output"

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)
