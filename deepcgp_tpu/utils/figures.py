"""Render the reference notebooks' figures from a trained run.

The reference ships its analysis as notebooks (`notebooks/Inspect.ipynb`,
`notebooks/convgp MNIST.ipynb`, `notebooks/fm_experiment.ipynb`) whose cells
produce three figure families: the inducing-patch tilings, the patch-
embedding scatter, and the noise-robustness curve.  utils/inspect.py is the
library form of those computations; this module is the rendering half —
each function writes one PNG and returns its path, so a run dir ends up with
the same artifacts a notebook export would produce.

matplotlib only; no seaborn/umap dependencies.
"""

from __future__ import annotations

import os


# Two-series categorical pair (CVD-safe blue/orange); single-series charts
# use the first hue alone.  Text/axis ink stays neutral.
_C_PRIMARY = '#2f6fde'
_C_SECONDARY = '#e8913a'
_INK = '#333333'


def _fig_axes(figsize):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("figures need matplotlib, which is not "
                          "installed") from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=figsize, dpi=150)
    for spine in ('top', 'right'):
        ax.spines[spine].set_visible(False)
    for spine in ('left', 'bottom'):
        ax.spines[spine].set_color('#bbbbbb')
    ax.tick_params(colors=_INK, labelsize=8)
    return fig, ax


def render_inducing_grid(layer, path: str, cols: int = 16) -> str:
    """Inducing-patch tiling (the MNIST notebook's grids) -> PNG."""
    from deepcgp_tpu.utils import inspect as insp
    grid = insp.inducing_patch_grid(layer, cols=cols)
    fig, ax = _fig_axes((6, 6 * grid.shape[0] / max(1, grid.shape[1])))
    ax.imshow(grid, cmap='gray', interpolation='nearest')
    ax.set_axis_off()
    ax.set_title(f'Inducing patches (M={layer.Z.shape[0]})',
                 color=_INK, fontsize=10)
    fig.savefig(path, bbox_inches='tight')
    _close(fig)
    return path


def render_patch_embedding(layer, NHWC_X, path: str, seed: int = 0) -> str:
    """2-D embedding of inducing patches over data patches -> PNG scatter
    (Inspect.ipynb's embedding figure)."""
    from deepcgp_tpu.utils import inspect as insp
    emb_z, emb_d = insp.patch_embedding(layer, NHWC_X, seed=seed)
    fig, ax = _fig_axes((6, 5))
    ax.scatter(emb_d[:, 0], emb_d[:, 1], s=6, c=_C_PRIMARY, alpha=0.35,
               linewidths=0, label='data patches')
    ax.scatter(emb_z[:, 0], emb_z[:, 1], s=22, c=_C_SECONDARY,
               edgecolors='white', linewidths=0.5,
               label='inducing patches')
    ax.legend(frameon=False, fontsize=8, labelcolor=_INK)
    ax.set_title('Patch embedding: inducing vs data', color=_INK, fontsize=10)
    ax.grid(True, alpha=0.25, linewidth=0.5)
    fig.savefig(path, bbox_inches='tight')
    _close(fig)
    return path


def render_noise_robustness(accuracies: dict, path: str) -> str:
    """Accuracy-under-noise curve (Inspect.ipynb's robustness sweep) -> PNG.
    ``accuracies``: {sigma: accuracy} as returned by
    utils.inspect.noise_robustness."""
    sigmas = sorted(accuracies)
    accs = [accuracies[s] for s in sigmas]
    fig, ax = _fig_axes((5.5, 4))
    ax.plot(sigmas, accs, color=_C_PRIMARY, linewidth=2, marker='o',
            markersize=5)
    for s, a in zip(sigmas, accs):
        ax.annotate(f'{a:.3f}', (s, a), textcoords='offset points',
                    xytext=(0, 7), fontsize=7, color=_INK, ha='center')
    ax.set_xlabel('input noise sigma', color=_INK, fontsize=9)
    ax.set_ylabel('test accuracy', color=_INK, fontsize=9)
    ax.set_ylim(0.0, 1.05)
    ax.set_title('Noise robustness', color=_INK, fontsize=10)
    ax.grid(True, alpha=0.25, linewidth=0.5)
    fig.savefig(path, bbox_inches='tight')
    _close(fig)
    return path


def _close(fig):
    import matplotlib.pyplot as plt
    plt.close(fig)


def render_run_figures(run_dir: str, model, NHWC_X_train, X_test, Y_test,
                       key, noise_levels=(0.0, 0.25, 0.5, 1.0),
                       max_eval_points: int = 512,
                       accuracies: dict | None = None) -> list:
    """Render every applicable figure for a trained model into ``run_dir``;
    returns the list of written paths.  The plain-RBF last layer has no
    patch view, so patch figures cover the conv layers only.
    ``accuracies`` optionally supplies a precomputed noise-robustness sweep
    (callers that already ran it skip the duplicate evaluation)."""
    from deepcgp_tpu.utils import inspect as insp
    paths = []
    for i, layer in enumerate(model.layers):
        view = getattr(layer, 'view', None) or \
            getattr(getattr(layer, 'kernel', None), 'view', None)
        if view is None:
            continue
        paths.append(render_inducing_grid(
            layer, os.path.join(run_dir, f'inducing_grid_layer{i}.png')))
        if i == 0:
            paths.append(render_patch_embedding(
                layer, NHWC_X_train,
                os.path.join(run_dir, 'patch_embedding_layer0.png')))
    if accuracies is None:
        accuracies = insp.noise_robustness(model, X_test, Y_test, key,
                                           noise_levels=noise_levels,
                                           max_points=max_eval_points)
    paths.append(render_noise_robustness(
        accuracies, os.path.join(run_dir, 'noise_robustness.png')))
    return paths
