"""Port parity for the host-side I/O: trajectory files, image paths and the
YAML config loader, the PyTorch package against the JAX package.

The port reads YAML with its own subset reader (no PyYAML): on every layout
here its ``load_config`` gives the config JAX's gives (compared as
``dataclasses.asdict`` through ``convert.config_to_torch``), with the same
warnings and errors; its reader gives what ``yaml.safe_load`` gives on the
scalars it accepts, and raises ``ValueError`` naming the line on what it
does not read.
"""

import dataclasses
import math
import warnings

import numpy as np
import pytest
import yaml

from monocular_visual_odometry_tpu.utils import io as jio
from monocular_visual_odometry_tpu.utils.config import load_config as jload
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch import load_config as tload_pkg
from monocular_visual_odometry_tpu_torch.utils import io as tio
from monocular_visual_odometry_tpu_torch.utils.config import load_config as tload
from monocular_visual_odometry_tpu_torch.utils.config import parse_yaml

# the reference's flat layout (tests/test_io_config.py::test_load_reference_config)
REFERENCE = """%YAML:1.0
dataset_name: "matlab"
matlab:
  dataset_dir: data/imgs
  num_images: 42
  camera_info.fx: 615
  camera_info.fy: 615
  camera_info.cx: 320
  camera_info.cy: 240
  is_draw_true_traj: "true"
max_num_imgs_to_proc: 300
number_of_keypoints_to_extract: 8000
max_number_of_keypoints: 1500
feature_match_method_index: 3
lowe_method_dist_ratio: 0.8
min_triang_angle: 1.0
is_enable_ba: "true"
is_ba_fix_map_points: "true"
information_matrix: "1.0 0.0 0.0 1.0"
num_prev_frames_to_opti_by_ba: 5
"""

NESTED = """# nested layout: a dataset mapping of DatasetConfig fields
dataset:
  dataset_dir: '/data/seq # not a comment'
  num_images: 12
  fx: 500.5
  fy: 501
  height: 240
  width: 320
  is_draw_true_traj: true
  true_traj_filename: "gt \\"truth\\".txt"   # a comment after a quoted string
max_num_imgs_to_proc: 10
level_pyramid: 3
score_threshold: 25.5
"""

# two sections, the unselected one empty; comments and string bools
SELECTED = """%YAML:1.0
---
dataset_name: fr1_desk   # the section below is selected
matlab:
fr1_desk:
  dataset_dir: "/somewhere"
  num_images: 150
  camera_info.fx: 517.3
  camera_info.fy: 516.5
  camera_info.cx: 325.1
  camera_info.cy: 249.7
  is_draw_true_traj: "false"
  true_traj_filename: 'a''b.txt'
is_enable_ba: "false"
is_ba_fix_map_points: False
information_matrix: 2.0 0.0 0.0 2.0
findEssentialMat_prob: 0.999
cv_waitkey_time: 1
save_predicted_traj_to: out/traj.txt
"""

EMPTY_SECTION = "dataset_name: matlab\nmatlab:\nmin_pixel_dist: 60\n"
EMPTY_FILE = "# nothing but a comment\n\n"

LAYOUTS = {"reference": REFERENCE, "nested": NESTED, "selected": SELECTED,
           "empty_section": EMPTY_SECTION, "empty_file": EMPTY_FILE}


def _write(tmp_path, text, name="c.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return p


def _load_both(path):
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        j = jload(path)
    with warnings.catch_warnings(record=True) as trec:
        warnings.simplefilter("always")
        t = tload(path)
    return j, t, [str(w.message) for w in jrec], [str(w.message) for w in trec]


def test_trajectory_files_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4), (7, 1, 1))
    q, _ = np.linalg.qr(rng.normal(size=(7, 3, 3)))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.normal(0, 3, (7, 3))
    jio.write_trajectory(tmp_path / "j.txt", poses)
    tio.write_trajectory(tmp_path / "t" / "t.txt", poses.astype(np.float32))
    jio.write_trajectory(tmp_path / "j32.txt", poses.astype(np.float32))
    assert (tmp_path / "t" / "t.txt").read_bytes() == (tmp_path / "j32.txt").read_bytes()
    tio.write_trajectory(tmp_path / "t64.txt", poses)
    assert (tmp_path / "t64.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(tio.read_trajectory(tmp_path / "j.txt"),
                                  jio.read_trajectory(tmp_path / "j.txt"))
    np.testing.assert_array_equal(tio.pose_to_row(poses[0]), jio.pose_to_row(poses[0]))
    np.testing.assert_array_equal(tio.row_to_pose(tio.pose_to_row(poses[0])),
                                  jio.row_to_pose(jio.pose_to_row(poses[0])))
    (tmp_path / "bad.txt").write_text("1 2 3\n")
    with pytest.raises(ValueError, match="multiple of 12"):
        tio.read_trajectory(tmp_path / "bad.txt")
    tio.write_trajectory(tmp_path / "none.txt", np.zeros((0, 4, 4)))
    assert tio.read_trajectory(tmp_path / "none.txt").shape == (0, 4, 4)


def test_image_paths_equal():
    assert tio.image_paths("/data/x", 5) == jio.image_paths("/data/x", 5)
    assert tio.image_paths("d", 3, pattern="f{:03d}.png", start=7) == \
        jio.image_paths("d", 3, pattern="f{:03d}.png", start=7)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_config_equals_jax(tmp_path, layout):
    j, t, jw, tw = _load_both(_write(tmp_path, LAYOUTS[layout]))
    assert t == convert.config_to_torch(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tw == jw == []
    assert tload_pkg is tload


def test_load_config_values():
    """Spot values of the layouts (beside the equality with JAX above)."""
    assert parse_yaml(NESTED)["dataset"]["dataset_dir"] == "/data/seq # not a comment"
    assert parse_yaml(NESTED)["dataset"]["true_traj_filename"] == 'gt "truth".txt'
    sel = parse_yaml(SELECTED.replace("%YAML:1.0\n", ""))
    assert sel["matlab"] is None and sel["fr1_desk"]["true_traj_filename"] == "a'b.txt"
    assert sel["is_ba_fix_map_points"] is False and sel["is_enable_ba"] == "false"


@pytest.mark.parametrize("text,needle", [
    ("min_triang_angel: 2.0\n", "min_triang_angel"),
    ("dataset_name: d\nd:\n  dataset_dir: x\n  camera_info.f: 600\n", "camera_info.f"),
])
def test_unknown_keys_warn_as_jax(tmp_path, text, needle):
    j, t, jw, tw = _load_both(_write(tmp_path, text))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tw == jw and any(needle in w for w in tw)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("text", [
    "dataset_name: nope\nmatlab:\n  dataset_dir: x\n",
    "dataset_name: matlab\nmatlab: 3\n",
])
def test_missing_or_scalar_section_raises_as_jax(tmp_path, text):
    p = _write(tmp_path, text)
    with pytest.raises(KeyError) as je:
        jload(p)
    with pytest.raises(KeyError) as te:
        tload(p)
    assert str(te.value) == str(je.value)


SCALARS = ["1.5e3", "1.5e+3", "010", "0o10", "08", "190:20:30", "190:20:30.5", "yes", "y",
           "Off", "~", "NULL", "''", '"\\x41\\u00e9\\t"', "b # c", "b#c", "-x", "x:y", "1_000",
           ".5", "1.", "+.inf", "-.Inf", ".NaN", "0b11", "0x_1F", "-1.5", "+12", "-0", "0",
           "C:\\x", "http://host/x", "'it''s'", '"x" # c', "a b  c", "1e5"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_pyyaml(scalar):
    text = f"k: {scalar}\nsec:\n  k2: {scalar}\n"
    want, got = yaml.safe_load(text), parse_yaml(text)
    for w, g in ((want["k"], got["k"]), (want["sec"]["k2"], got["sec"]["k2"])):
        assert type(g) is type(w), (scalar, w, g)
        assert (isinstance(w, float) and math.isnan(w) and math.isnan(g)) or g == w, (w, g)


@pytest.mark.parametrize("text,line", [
    ("a: [1, 2]\n", 1),                 # flow sequence
    ("a: 1\nb: {c: 1}\n", 2),           # flow mapping
    ("a: &x 1\n", 1),                   # anchor
    ("a: 1\nb: *x\n", 2),               # alias
    ("a: !!str 1\n", 1),                # tag
    ("a: |\n  text\n", 1),              # literal block scalar
    ("a: >\n  text\n", 1),              # folded block scalar
    ("a: 1\n---\nb: 2\n", 2),           # several documents
    ("a: 1\n...\n", 2),                 # document end
    ("a:\n  - 1\n", 2),                 # block sequence
    ("a:\n  b:\n    c: 1\n", 3),        # three levels
    ("a:\n  b: 1\n c: 2\n", 3),         # uneven indentation
    ("a: hello\n  world\n", 2),         # multi-line plain scalar
    ("a: 'open\n", 1),                  # quote not closed on its line
    ("a: 'x' y\n", 1),                  # text after a quoted string
    ("a: x: y\n", 1),                   # ': ' in a plain value
    ('a: "\\q"\n', 1),                  # unknown escape
    ("a: 2001-12-14\n", 1),             # a date
    ("<<: 1\n", 1),                     # merge key
    ("'a': 1\n", 1),                    # quoted key
    ("? a\n", 1),                       # complex key
    ("\ta: 1\n", 1),                    # tab indentation
    ("%TAG ! x\na: 1\n", 1),            # a directive other than %YAML
])
def test_unsupported_yaml_raises_naming_the_line(tmp_path, text, line):
    p = _write(tmp_path, text)
    with pytest.raises(ValueError, match=rf"c\.yaml:{line}: "):
        tload(p)
