"""2-D lattice visualiser (reference: utils/periodicity_visualizer.py:5-71).

A copy of `npp_tpu/utils/visualizer.py` with `import cv2` moved inside
`GridProgram.draw`: only drawing needs OpenCV (the search's save=True).
Draws the detected lattice (base point + two displacement vectors) over an
image by solving for the lattice extents that cover the canvas.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class GridProgram:
    def __init__(self, resolution, base_point, first_shift, second_shift):
        self.resolution = tuple(resolution)
        self.base_point = np.asarray(base_point, np.float64)   # (x, y)
        self.first_shift = np.asarray(first_shift, np.float64)  # (dx, dy)
        self.second_shift = np.asarray(second_shift, np.float64)

    def _fit_resolution(self, target_hw):
        old_h, old_w = self.resolution
        new_h, new_w = target_hw
        ratio = np.array([new_w / old_w, new_h / old_h])
        self.base_point = np.round(self.base_point * ratio).astype(np.int64)
        self.first_shift = self.first_shift * ratio
        self.second_shift = self.second_shift * ratio

    def _gen_ij(self, canvas_hw):
        corners = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float64)
        vecs = corners * np.array(canvas_hw[::-1]) - self.base_point
        m = np.stack([self.first_shift, self.second_shift], axis=1)
        coords = np.linalg.inv(m) @ vecs.T
        i_min, j_min = np.floor(coords.min(axis=1)).astype(int)
        i_max, j_max = np.ceil(coords.max(axis=1)).astype(int)
        return i_min, i_max, j_min, j_max

    def draw(self, image: np.ndarray, color=(255, 255, 0), thickness=2
             ) -> Tuple[np.ndarray, np.ndarray]:
        """image: (H, W, 3) uint8 RGB -> (drawn image, line mask)."""
        import cv2
        self._fit_resolution(image.shape[:2])
        canvas = image.copy()
        i_min, i_max, j_min, j_max = self._gen_ij(canvas.shape[:2])

        i_base = self.base_point + np.arange(i_min, i_max)[:, None] * self.first_shift
        i_lines = np.concatenate([i_base + j_min * self.second_shift,
                                  i_base + j_max * self.second_shift], axis=1)
        j_base = self.base_point + np.arange(j_min, j_max)[:, None] * self.second_shift
        j_lines = np.concatenate([j_base + i_min * self.first_shift,
                                  j_base + i_max * self.first_shift], axis=1)

        lines = np.round(np.concatenate([i_lines, j_lines])).astype(np.int32)
        line_mask = np.zeros(canvas.shape[:2], np.int32)
        for ln in lines:
            cv2.line(canvas, (int(ln[0]), int(ln[1])), (int(ln[2]), int(ln[3])),
                     color=color, thickness=thickness)
            one = np.zeros(canvas.shape[:2], np.uint8)
            cv2.line(one, (int(ln[0]), int(ln[1])), (int(ln[2]), int(ln[3])),
                     color=1, thickness=thickness)
            line_mask += one
        return canvas, line_mask


def mask2ltrb(mask: np.ndarray) -> np.ndarray:
    """(left, top, right, bottom) of the mask's bounding box
    (reference: utils/miscs.py:17-20)."""
    ys, xs = np.nonzero(np.asarray(mask).squeeze())
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()])
