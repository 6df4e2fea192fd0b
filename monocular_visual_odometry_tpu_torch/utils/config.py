"""Typed configuration for the VO engine, and its YAML loader.

A copy of the dataclass tree of ``monocular_visual_odometry_tpu.utils.config``
with the same field names and defaults, so a config built for the JAX
package carries over field by field (``convert.config_to_torch``), and of
its :func:`load_config`, which reads both the nested layout and the
reference's flat layout.

The port does not depend on PyYAML: :func:`parse_yaml` reads the subset of
YAML these files use (block mappings two levels deep, comments, quoted
strings, plain scalars resolved as PyYAML resolves them) and raises
``ValueError`` naming the line on anything else, so no file is read
differently from PyYAML without saying so.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


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


# ---------------------------------------------------------------------------
# the YAML subset reader
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1), tried in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# resolved by PyYAML to a date, a merge key or a value key: not read here
_OTHER = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                    (?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?
                    |<<|=)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_INDICATORS = ",[]{}#&*!|>'\"%@`"  # cannot start a plain scalar
_SEP = re.compile(r":(?= |$)")


def _sexagesimal(value: str, num) -> Any:
    total = num(0)
    for part in value.split(":"):
        total = total * 60 + num(part)
    return total


def _resolve(s: str, where: str) -> Any:
    """A plain scalar as PyYAML's safe loader constructs it."""
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _NULL.match(s):
        return None
    if _OTHER.match(s):
        raise ValueError(f"{where}: {s!r} is a date, merge or value key")
    return s


def _quoted(s: str, where: str) -> tuple[str, str]:
    """(the quoted scalar at the start of ``s``, the rest of ``s``)."""
    q, out, i = s[0], [], 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), s[i + 1:]
        if q == '"' and c == '"':
            return "".join(out), s[i + 1:]
        if q == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            n = _HEX_ESCAPES.get(e)
            code = s[i + 2:i + 2 + n] if n else ""
            if not n or len(code) != n or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                raise ValueError(f"{where}: unknown escape \\{e} in a double-quoted string")
            out.append(chr(int(code, 16)))
            i += 2 + n
            continue
        out.append(c)
        i += 1
    raise ValueError(f"{where}: a quoted string that does not end on its line")


def _value(s: str, where: str) -> tuple[Any, bool]:
    """(the value after ``key:``, whether one was given)."""
    s = s.lstrip(" ")
    if not s or s[0] == "#":
        return None, False
    if s[0] in "'\"":
        v, rest = _quoted(s, where)
        tail = rest.lstrip(" \t")
        if rest[:1] not in ("", " ", "\t") or (tail and tail[0] != "#"):
            raise ValueError(f"{where}: text after a quoted string")
        return v, True
    if s[0] in _INDICATORS or (s[0] in "-?:" and s[1:2] in ("", " ")):
        raise ValueError(f"{where}: {s[0]!r} starts a flow collection, anchor, alias, tag, "
                         "block scalar or sequence")
    v = re.split(r"[ \t]#", s, maxsplit=1)[0].rstrip(" \t")
    if _SEP.search(v):
        raise ValueError(f"{where}: a plain value holding ': '")
    return _resolve(v, where), True


def parse_yaml(text: str, name: str = "<yaml>") -> dict:
    """Parse the YAML subset of the config files: block mappings by
    indentation, two levels deep; ``#`` comments; single- and double-quoted
    strings; plain scalars resolved as PyYAML resolves them (booleans,
    ints, floats, null, everything else a string); a key with no value is
    ``None``. One leading ``---`` is accepted. Anything else (flow
    collections, anchors, aliases, tags, block scalars, sequences,
    multi-line scalars, several documents, deeper nesting) raises
    ``ValueError`` naming the line."""
    out: dict = {}
    parent = None        # the top-level key whose mapping the next indented line joins
    child_indent = None
    started = False
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        body = line.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise ValueError(f"{where}: a tab in the indentation")
        if line.startswith(("---", "...")) and line[3:4] in ("", " ", "\t"):
            if line.startswith("---") and not started and not line[3:].split("#")[0].strip():
                started = True
                continue
            raise ValueError(f"{where}: a document marker (several documents or a document "
                             "end)")
        if line[0] == "%":
            raise ValueError(f"{where}: a directive")
        started = True
        indent = len(line) - len(body)
        m = _SEP.search(body)
        key = body[:m.start()] if m else ""
        if not m or re.search(r"[ \t]#", key) or not key.strip():
            raise ValueError(f"{where}: not a 'key: value' line")
        if key[0] in _INDICATORS or (key[0] in "-?:" and key[1:2] in ("", " ")):
            raise ValueError(f"{where}: {key[0]!r} starts a quoted key, flow collection, anchor, "
                             "alias, tag, complex key or sequence")
        key = _resolve(key.rstrip(" \t"), where)
        value, given = _value(body[m.end():], where)
        if indent == 0:
            out[key] = value
            parent, child_indent = (None if given else key), None
            continue
        if parent is None:
            raise ValueError(f"{where}: an indented line that is not in a mapping "
                             "(a multi-line scalar?)")
        if child_indent is None:
            child_indent = indent
            out[parent] = {}
        elif indent != child_indent:
            raise ValueError(f"{where}: nesting deeper than two levels, or uneven indentation")
        out[parent][key] = value
    return out


# ---------------------------------------------------------------------------
# load_config
# ---------------------------------------------------------------------------


def _b(v: Any) -> bool:
    """Accept real bools and the reference's string bools."""
    if isinstance(v, str):
        return v.strip().lower() == "true"
    return bool(v)


# Every flat key load_config consumes, plus the reference keys it accepts
# and deliberately ignores. Used for typo detection: an unknown key warns.
_KNOWN_FLAT_KEYS = {
    "dataset_name", "dataset",
    "max_num_imgs_to_proc", "save_predicted_traj_to", "output_folder",
    # display-loop keys with no offline analogue
    "is_pcl_wait_for_keypress", "cv_waitkey_time",
    "number_of_keypoints_to_extract", "max_number_of_keypoints",
    "scale_factor", "level_pyramid", "score_threshold",
    # per-stage matcher indices: accepted, the flat one is used
    "feature_match_method_index",
    "feature_match_method_index_initialization",
    "feature_match_method_index_triangulation",
    "feature_match_method_index_pnp",
    "xiang_gao_method_match_ratio", "lowe_method_dist_ratio",
    "method_3_feature_dist_threshold",  # dead in the reference too
    "max_matching_pixel_dist_in_initialization",
    "max_matching_pixel_dist_in_triangulation",
    "max_matching_pixel_dist_in_pnp",
    "kpts_uniform_selection_grid_size",
    "kpts_uniform_selection_max_pts_per_grid",
    "findEssentialMat_prob",  # adaptive termination -> fixed batch
    "findEssentialMat_threshold",
    "min_triang_angle", "max_ratio_between_max_angle_and_median_angle",
    "min_inlier_matches", "min_pixel_dist",
    "min_median_triangulation_angle",
    "assumed_mean_pts_depth_during_vo_init",
    "min_dist_between_two_keyframes", "max_possible_dist_to_prev_keyframe",
    "is_enable_ba", "num_prev_frames_to_opti_by_ba", "information_matrix",
    "is_ba_fix_map_points", "UPDATE_MAP_PTS",
}

_KNOWN_SECTION_KEYS = {
    "dataset_dir", "num_images", "camera_info.fx", "camera_info.fy",
    "camera_info.cx", "camera_info.cy", "height", "width",
    "is_draw_true_traj", "true_traj_filename",
}


def load_config(path: str | Path) -> VOConfig:
    """Load a YAML config. Accepts both the nested layout (a ``dataset:``
    mapping of :class:`DatasetConfig` fields) and the reference's flat
    layout (the same key names, with ``dataset_name`` selecting a section).

    Strictness, as in the JAX package: a ``dataset_name`` that selects a
    missing section raises ``KeyError``; unknown scalar keys raise a
    ``UserWarning``; a present but empty section loads with defaults.
    Mapping-valued top-level keys are dataset sections and may coexist
    unselected. A file outside the YAML subset of :func:`parse_yaml`
    raises ``ValueError``.
    """
    with open(path) as f:
        text = f.read()
    # the reference files start with the cv::FileStorage "%YAML:1.0" directive
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    raw = parse_yaml("\n".join(lines), str(path))

    for k, v in raw.items():
        if isinstance(v, dict):
            if k == "dataset":
                continue  # validated by the DatasetConfig ctor below
            unknown = set(v) - _KNOWN_SECTION_KEYS
            if unknown:
                warnings.warn(
                    f"config {path}: unknown key(s) in dataset section "
                    f"'{k}': {sorted(unknown)}", stacklevel=2)
        elif v is None:
            # a bare "name:" line is an (empty) dataset section
            pass
        elif k not in _KNOWN_FLAT_KEYS:
            warnings.warn(f"config {path}: unknown key '{k}' "
                          "(typo? it will have no effect)", stacklevel=2)

    ds = DatasetConfig()
    if "dataset_name" in raw:
        if raw["dataset_name"] not in raw:
            raise KeyError(
                f"config {path}: dataset_name={raw['dataset_name']!r} "
                "selects a section that does not exist "
                "(reference behavior: Yaml::get_ exits, yaml.cpp:58-71)")
        sec = raw[raw["dataset_name"]] or {}
        if not isinstance(sec, dict):
            raise KeyError(
                f"config {path}: dataset section "
                f"{raw['dataset_name']!r} is not a mapping")
        ds = DatasetConfig(
            dataset_dir=sec.get("dataset_dir", ""),
            num_images=int(sec.get("num_images", 150)),
            fx=float(sec.get("camera_info.fx", 615.0)),
            fy=float(sec.get("camera_info.fy", 615.0)),
            cx=float(sec.get("camera_info.cx", 320.0)),
            cy=float(sec.get("camera_info.cy", 240.0)),
            is_draw_true_traj=_b(sec.get("is_draw_true_traj", False)),
            true_traj_filename=sec.get("true_traj_filename", ""),
        )
    elif "dataset" in raw:
        ds = DatasetConfig(**raw["dataset"])

    g = raw.get  # flat reference keys
    return VOConfig(
        dataset=ds,
        orb=OrbConfig(
            num_keypoints=int(g("number_of_keypoints_to_extract", 8000)),
            max_keypoints=int(g("max_number_of_keypoints", 1024)),
            scale_factor=float(g("scale_factor", 1.2)),
            n_levels=int(g("level_pyramid", 4)),
            score_threshold=float(g("score_threshold", 20.0)),
            grid_size=int(g("kpts_uniform_selection_grid_size", 16)),
            max_pts_per_grid=int(g("kpts_uniform_selection_max_pts_per_grid", 8)),
        ),
        match=MatchConfig(
            method_index=int(g("feature_match_method_index", 3)),
            xiang_gao_match_ratio=float(g("xiang_gao_method_match_ratio", 2.0)),
            lowe_dist_ratio=float(g("lowe_method_dist_ratio", 0.8)),
            max_pixel_dist_init=float(g("max_matching_pixel_dist_in_initialization", 100.0)),
            max_pixel_dist_triang=float(g("max_matching_pixel_dist_in_triangulation", 100.0)),
            max_pixel_dist_pnp=float(g("max_matching_pixel_dist_in_pnp", 50.0)),
        ),
        ransac=RansacConfig(
            # findEssentialMat_prob is accepted but ignored (fixed-batch RANSAC)
            threshold_px=float(g("findEssentialMat_threshold", 1.0)),
        ),
        triang=TriangulationConfig(
            min_triang_angle_deg=float(g("min_triang_angle", 1.0)),
            max_ratio_angle_over_median=float(
                g("max_ratio_between_max_angle_and_median_angle", 20.0)),
        ),
        init=InitConfig(
            min_inlier_matches=int(g("min_inlier_matches", 15)),
            min_pixel_dist=float(g("min_pixel_dist", 50.0)),
            min_median_triang_angle_deg=float(g("min_median_triangulation_angle", 2.0)),
            assumed_mean_depth=float(g("assumed_mean_pts_depth_during_vo_init", 0.8)),
        ),
        tracking=TrackingConfig(
            min_dist_between_keyframes=float(g("min_dist_between_two_keyframes", 0.03)),
            max_dist_to_prev_keyframe=float(g("max_possible_dist_to_prev_keyframe", 0.3)),
        ),
        ba=BAConfig(
            enabled=_b(g("is_enable_ba", True)),
            window=int(g("num_prev_frames_to_opti_by_ba", 5)),
            information_matrix=tuple(
                float(x) for x in str(g("information_matrix", "1.0 0.0 0.0 1.0")).split()
            ),
            fix_map_points=_b(g("is_ba_fix_map_points", True)),
        ),
        max_num_imgs_to_proc=int(g("max_num_imgs_to_proc", 300)),
        save_predicted_traj_to=g("save_predicted_traj_to", "output/cam_traj.txt"),
        output_folder=g("output_folder", "output"),
    )
