"""matplotlib for the visualisers, imported at the first draw.

The GPU host has no matplotlib: the ``viz`` modules import there, and a draw
asked for there raises ``ImportError`` (nothing is skipped quietly).
"""

from __future__ import annotations


def pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend (the JAX package's
    viz modules select it at import)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(fig, out) -> None:
    """Write ``fig`` as the JAX package's visualisers do (150 dpi, tight
    box) and close it."""
    plt = pyplot()
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
