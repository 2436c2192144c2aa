"""Open3D visualization (the port's copy of
go_with_the_flows_tpu/viz/open3d_utils.py, itself a behavior port of the
reference's `lib/visualization/utils_open3d.py`): colored point-cloud
geometry and an off-screen capture. Gated on open3d being installed: it
is imported only when a function runs, and `have_open3d()` says whether
it can be."""

from __future__ import annotations

import numpy as np

_PALETTE = np.array([
    [0.5, 0.5, 0.5],
    [0.894, 0.102, 0.110],
    [0.216, 0.494, 0.722],
    [0.302, 0.686, 0.290],
    [0.596, 0.306, 0.639],
], dtype=np.float64)


def have_open3d() -> bool:
    try:
        import open3d  # noqa: F401

        return True
    except ImportError:
        return False


def cloud_to_geometry(points: np.ndarray, labels=None):
    """(3, N) or (N, 3) cloud -> colored open3d PointCloud, each point
    colored by _PALETTE[label % 5] when labels are given."""
    import open3d as o3d

    pts = np.asarray(points, np.float64)
    if pts.shape[0] == 3 and pts.shape[1] != 3:
        pts = pts.T
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts)
    if labels is not None:
        colors = _PALETTE[np.asarray(labels).astype(int) % len(_PALETTE)]
        pcd.colors = o3d.utility.Vector3dVector(colors)
    return pcd


def capture_cloud_image(points: np.ndarray, out_path: str, labels=None,
                        width: int = 800, height: int = 600):
    """Off-screen render of a cloud to the PNG `out_path`; returns the
    path."""
    import open3d as o3d

    geometry = cloud_to_geometry(points, labels)
    vis = o3d.visualization.Visualizer()
    vis.create_window(width=width, height=height, visible=False)
    vis.add_geometry(geometry)
    vis.poll_events()
    vis.update_renderer()
    vis.capture_screen_image(out_path)
    vis.destroy_window()
    return out_path
