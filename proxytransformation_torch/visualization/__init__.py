"""Scene and image visualization: the port's counterpart of
proxytransformation_tpu/visualization/ (the same names; the box geometry
runs in torch on an explicit device, box wireframes are drawn by
`raster.line` in place of cv2)."""
from .utils import nine_dof_to_corners, box_lines, line_mesh_segments
from .color_selector import ColorMap
from .base_visualizer import EmbodiedScanBaseVisualizer
from .img_drawer import ImgDrawer
from .line_mesh import LineMesh
from .continuous_drawer import ContinuousDrawer, ContinuousOccupancyDrawer

__all__ = ['nine_dof_to_corners', 'box_lines', 'line_mesh_segments',
           'ColorMap', 'EmbodiedScanBaseVisualizer', 'ImgDrawer',
           'LineMesh', 'ContinuousDrawer', 'ContinuousOccupancyDrawer']
