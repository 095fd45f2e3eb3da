"""Training-evolution plots and the evaluator's panel grids, port of
evaluation/viz.py: matplotlib, imported where a figure is drawn, headless
(figures returned or saved, never shown). Arrays come in as numpy.
"""

from typing import List, Optional, Tuple

Series = List[Tuple[int, float]]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _new_axes(figsize=(9.0, 4.5)):
    fig, ax = _pyplot().subplots(figsize=figsize, constrained_layout=True)
    ax.grid(True, alpha=0.25)
    ax.set_xlabel("step")
    return fig, ax


def _finish(fig, save_path: Optional[str]):
    if save_path is None:
        return fig
    fig.savefig(save_path, dpi=120)
    _pyplot().close(fig)
    return save_path


def render_panel_grid(rows, save_path: Optional[str] = None,
                      panel: float = 2.6, cmap: str = "magma",
                      suptitle: Optional[str] = None):
    """Render a grid of labeled panels; the one figure helper every
    evaluator visualization goes through.

    rows: list of rows, each a list of (title, array) pairs. 3-channel
    arrays are drawn as RGB images; 2-D arrays as heatmaps with their own
    colorbar (actual value range, not renormalized). Rows may have
    different lengths; shorter rows leave trailing cells blank.
    """
    plt = _pyplot()
    nrows = len(rows)
    ncols = max(len(r) for r in rows)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(panel * ncols, panel * nrows),
                             constrained_layout=True, squeeze=False)
    for r, row in enumerate(rows):
        for c in range(ncols):
            ax = axes[r][c]
            ax.set_axis_off()
            if c >= len(row):
                continue
            title, data = row[c]
            if data.ndim == 3:
                ax.imshow(data)
            else:
                im = ax.imshow(data, cmap=cmap)
                fig.colorbar(im, ax=ax, shrink=0.75)
            ax.set_title(title, fontsize=9)
    if suptitle:
        fig.suptitle(suptitle)
    return _finish(fig, save_path)


def plot_metric_evolution(metric_list: Series, y_label: str = "Metric",
                          save_path: Optional[str] = None):
    """One metric over training steps."""
    fig, ax = _new_axes()
    steps, values = zip(*metric_list)
    ax.plot(steps, values, color="#1f6f8b", linewidth=1.0)
    ax.set_ylabel(y_label)
    ax.set_title(y_label)
    return _finish(fig, save_path)


def plot_information_evolution(H_y: Series, H_y1: Series,
                               save_path: Optional[str] = None):
    """Total latent rate (bpp, left axis) and the share of it carried by the
    base/vision layer (%, right axis) over training. H_y / H_y1:
    [(step, bpp)] for total and base latents."""
    fig, ax = _new_axes()
    steps, total = zip(*H_y)
    base = [b for _, b in H_y1]
    share = [100.0 * b / t if t > 0 else 0.0 for b, t in zip(base, total)]

    ax.plot(steps, total, color="#1f6f8b", linewidth=1.0, label="total rate")
    ax.set_ylabel("total latent rate (bpp)", color="#1f6f8b")

    ax2 = ax.twinx()
    ax2.plot(steps, share, color="#b23a48", linewidth=1.0,
             label="vision-layer share")
    ax2.set_ylabel("vision-layer share of rate (%)", color="#b23a48")

    ax.set_title("rate and vision-layer information over training")
    handles = ax.get_lines() + ax2.get_lines()
    ax.legend(handles, [h.get_label() for h in handles], loc="upper right")
    return _finish(fig, save_path)
