"""Visualization: trajectory plots and annotated frames exported as image
files, and the standalone interactive HTML viewer (``viz.viewer``)."""

from monocular_visual_odometry_tpu_torch.viz.viewer import export_viewer  # noqa: F401
