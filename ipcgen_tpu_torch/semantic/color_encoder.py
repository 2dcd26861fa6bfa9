"""Bitwise semantic-label color codec.

API-parity rewrite of reference semantic_color_encoder.py:13-216 in pure
numpy/JAX (no torch): PASCAL-VOC-style bit-interleaved colormap with
vectorized encode/decode (the reference decodes with a Python double loop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SemanticColorEncoder:
    """Deterministic label -> RGB codec with a bit-interleaved colormap.

    Guarantees unique, well-spread colors per label id
    (reference: semantic_color_encoder.py:39-71).
    """

    def __init__(self, num_classes: int, rgb_order: bool = True):
        self.num_classes = num_classes
        self.rgb_order = rgb_order
        self.colormap = self._generate_colormap()

    @staticmethod
    def _bitget(val: np.ndarray, bit_idx: int) -> np.ndarray:
        return (val >> bit_idx) & 1

    def _generate_colormap(self) -> np.ndarray:
        """Vectorized bit-interleaved colormap over all class ids at once."""
        ids = np.arange(self.num_classes, dtype=np.int64)
        r = np.zeros_like(ids)
        g = np.zeros_like(ids)
        b = np.zeros_like(ids)
        v = ids.copy()
        for j in range(8):
            r |= self._bitget(v, 0) << (7 - j)
            g |= self._bitget(v, 1) << (7 - j)
            b |= self._bitget(v, 2) << (7 - j)
            v >>= 3
        cmap = np.stack([r, g, b], axis=1).astype(np.uint8)
        if not self.rgb_order:
            cmap = cmap[:, ::-1]
        return cmap

    def encode_labels_to_colors(self, labels: np.ndarray) -> np.ndarray:
        """Labels [N] or [H, W] -> float colors in [0, 1] of shape [..., 3]."""
        labels_np = np.asarray(labels)
        if labels_np.ndim not in (1, 2):
            raise ValueError(f"Unsupported label dimension: {labels_np.ndim}")
        labels_np = np.clip(labels_np, 0, self.num_classes - 1)
        return self.colormap[labels_np].astype(np.float32) / 255.0

    def decode_colors(
        self, colors: np.ndarray, threshold: float = 0.1
    ) -> np.ndarray:
        """Colors [..., 3] in [0, 1] -> nearest-colormap labels (vectorized)."""
        colors_np = np.asarray(colors)
        if colors_np.ndim not in (2, 3):
            raise ValueError(f"Unsupported color dimension: {colors_np.ndim}")
        c255 = (colors_np * 255).astype(np.int32)
        flat = c255.reshape(-1, 3)
        # (N, C) squared distances to the colormap; C is small (<=256).
        d = np.sum(
            (flat[:, None, :] - self.colormap[None, :, :].astype(np.int32)) ** 2, axis=2
        )
        labels = np.argmin(d, axis=1).astype(np.int32)
        return labels.reshape(colors_np.shape[:-1])

    def get_color(self, label_id: int) -> np.ndarray:
        if not 0 <= label_id < self.num_classes:
            raise ValueError(
                f"Label id {label_id} is out of range [0, {self.num_classes - 1}]."
            )
        return self.colormap[label_id] / 255.0

    def visualize_colormap(
        self, save_path: Optional[str] = None, figsize: tuple = (12, 8)
    ) -> None:
        """Render the colormap as a labeled gradient strip."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import ListedColormap

        fig, ax = plt.subplots(figsize=figsize)
        colors_normalized = self.colormap / 255.0
        cmap = ListedColormap(colors_normalized)
        gradient = np.linspace(0, 1, self.num_classes)
        gradient = np.vstack((gradient, gradient))
        ax.imshow(gradient, aspect="auto", cmap=cmap)
        ax.set_xlim(0, self.num_classes)
        ax.set_ylim(-0.5, 0.5)
        ax.set_yticks([])
        ax.set_xlabel("Label ID")
        ax.set_title(f"Semantic label colormap ({self.num_classes} classes)")
        for i in range(0, self.num_classes, max(1, self.num_classes // 20)):
            ax.text(
                i,
                0,
                str(i),
                ha="center",
                va="center",
                color="white" if np.mean(colors_normalized[i]) < 0.5 else "black",
                fontsize=8,
            )
        plt.tight_layout()
        if save_path:
            plt.savefig(save_path, dpi=300, bbox_inches="tight")
        plt.close(fig)

    def get_colormap_info(self) -> dict:
        return {
            "num_classes": self.num_classes,
            "rgb_order": self.rgb_order,
            "colormap_shape": self.colormap.shape,
            "color_range": (int(self.colormap.min()), int(self.colormap.max())),
            "unique_colors": len(np.unique(self.colormap.reshape(-1, 3), axis=0)),
        }


def create_s3dis_color_encoder() -> SemanticColorEncoder:
    """13-class S3DIS encoder: 0 ceiling, 1 floor, 2 wall, 3 beam, 4 column,
    5 window, 6 door, 7 table, 8 chair, 9 sofa, 10 bookcase, 11 board,
    12 clutter (reference: semantic_color_encoder.py:210-216)."""
    return SemanticColorEncoder(num_classes=13, rgb_order=True)
