"""Plotting: triangle (corner), trace, profile, contour, comparison and
covariance plots in pure matplotlib.

Counterpart of ``desilike_tpu/samples/plotting.py`` (the reference's
samples/plotting.py wraps getdist and anesthetic): self-contained
weighted-KDE corner plots. matplotlib is imported inside each function, so
that nothing on the card's path imports it. The getdist triangle plot and
the anesthetic view wait for ROADMAP A17.
"""

import numpy as np


def _gaussian_kde_1d(x, w, grid, bw_factor=1.):
    x = np.asarray(x, dtype='f8')
    w = np.asarray(w, dtype='f8')
    w = w / w.sum()
    mu = np.sum(w * x)
    sig = np.sqrt(np.sum(w * (x - mu) ** 2))
    neff = 1. / np.sum(w ** 2)
    bw = bw_factor * sig * neff ** (-1. / 5.) + 1e-30
    return np.sum(w[None, :] * np.exp(-0.5 * ((grid[:, None] - x[None, :]) / bw) ** 2), axis=1) / (bw * np.sqrt(2 * np.pi))


def _contour_levels_2d(H, cls=(0.68, 0.95)):
    Hs = np.sort(H.reshape(-1))[::-1]
    c = np.cumsum(Hs)
    c /= c[-1]
    return sorted(Hs[np.searchsorted(c, cl)] for cl in cls)


def plot_triangle(chains, params=None, labels=None, colors=None, fn=None, show=False,
                  nbins2d=40, truths=None):
    """Corner plot of one or several chains.

    chains : Chain or list of Chain
    params : list of parameter names (default: all non-reserved)
    truths : dict name -> value, drawn as lines
    """
    from matplotlib import pyplot as plt
    if not isinstance(chains, (list, tuple)):
        chains = [chains]
    if params is None:
        params = [p.name for p in chains[0].params if p.name not in chains[0]._reserved]
    params = [getattr(p, 'name', p) for p in params]
    n = len(params)
    if colors is None:
        colors = ['C{:d}'.format(i) for i in range(len(chains))]
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n), squeeze=False)
    fig.subplots_adjust(hspace=0.08, wspace=0.08)

    lims = {}
    for name in params:
        los, his = [], []
        for chain in chains:
            x = np.asarray(chain[name]).reshape(-1)
            w = chain.weight.reshape(-1)
            mu = np.average(x, weights=w)
            sig = np.sqrt(np.average((x - mu) ** 2, weights=w))
            los.append(mu - 3.5 * sig)
            his.append(mu + 3.5 * sig)
        lims[name] = (min(los), max(his))

    for i, pi in enumerate(params):
        for j, pj in enumerate(params):
            ax = axes[i][j]
            if j > i:
                ax.axis('off')
                continue
            if i == j:
                grid = np.linspace(*lims[pi], 200)
                for chain, color in zip(chains, colors):
                    x = np.asarray(chain[pi]).reshape(-1)
                    w = chain.weight.reshape(-1)
                    ax.plot(grid, _gaussian_kde_1d(x, w, grid), color=color)
                if truths and pi in truths:
                    ax.axvline(truths[pi], color='k', linestyle=':', lw=1)
                ax.set_yticks([])
            else:
                for chain, color in zip(chains, colors):
                    x = np.asarray(chain[pj]).reshape(-1)
                    y = np.asarray(chain[pi]).reshape(-1)
                    w = chain.weight.reshape(-1)
                    H, xe, ye = np.histogram2d(x, y, bins=nbins2d,
                                               range=[lims[pj], lims[pi]], weights=w)
                    # light smoothing
                    from scipy.ndimage import gaussian_filter
                    H = gaussian_filter(H, 1.0)
                    levels = _contour_levels_2d(H)
                    xc = (xe[1:] + xe[:-1]) / 2
                    yc = (ye[1:] + ye[:-1]) / 2
                    ax.contour(xc, yc, H.T, levels=levels, colors=color)
                if truths:
                    if pj in truths:
                        ax.axvline(truths[pj], color='k', linestyle=':', lw=1)
                    if pi in truths:
                        ax.axhline(truths[pi], color='k', linestyle=':', lw=1)
            if i == n - 1:
                label = labels[j] if labels else (chains[0].params[pj].latex if pj in chains[0].params else pj)
                ax.set_xlabel('$' + label + '$' if not label.startswith('$') else label)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                label = labels[i] if labels else (chains[0].params[pi].latex if pi in chains[0].params else pi)
                ax.set_ylabel('$' + label + '$' if not label.startswith('$') else label)
            elif j > 0:
                ax.set_yticklabels([])
            ax.set_xlim(lims[pj])
            if i != j:
                ax.set_ylim(lims[pi])
    if fn:
        fig.savefig(fn, bbox_inches='tight', dpi=120)
    if show:
        from matplotlib import pyplot as plt
        plt.show()
    return fig


def plot_trace(chain, params=None, fn=None, show=False):
    """Per-chain trace plots."""
    from matplotlib import pyplot as plt
    if params is None:
        params = [p.name for p in chain.params if p.name not in chain._reserved]
    params = [getattr(p, 'name', p) for p in params]
    fig, axes = plt.subplots(len(params), 1, figsize=(8, 1.6 * len(params)),
                             sharex=True, squeeze=False)
    for ax, name in zip(axes[:, 0], params):
        arr = np.asarray(chain[name])
        if arr.ndim == 1:
            arr = arr[:, None]
        for c in range(arr.shape[1]):
            ax.plot(arr[:, c], lw=0.5, alpha=0.7)
        ax.set_ylabel(name)
    axes[-1, 0].set_xlabel('step')
    if fn:
        fig.savefig(fn, bbox_inches='tight', dpi=120)
    if show:
        plt.show()
    return fig


def plot_profile(profiles, params=None, fn=None, show=False):
    """1D profiled-chi2 curves from a Profiles container."""
    from matplotlib import pyplot as plt
    items = profiles.profile if params is None else {getattr(p, 'name', p): profiles.profile[getattr(p, 'name', p)] for p in params}
    n = len(items)
    fig, axes = plt.subplots(1, max(n, 1), figsize=(3.2 * max(n, 1), 3), squeeze=False)
    for ax, (name, (values, chi2)) in zip(axes[0], items.items()):
        ax.plot(values, chi2 - chi2.min())
        ax.axhline(1., color='k', linestyle=':', lw=1)
        ax.set_xlabel(name)
        ax.set_ylabel(r'$\Delta \chi^2$')
    if fn:
        fig.savefig(fn, bbox_inches='tight', dpi=120)
    if show:
        plt.show()
    return fig


def plot_triangle_getdist(chains, params=None, labels=None, fn=None, show=False, **kwargs):
    """Triangle plot through getdist: ROADMAP A17."""
    raise NotImplementedError('the getdist triangle plot is ROADMAP A17')


def to_anesthetic(chain, params=None):
    """anesthetic view of a Chain: ROADMAP A17."""
    raise NotImplementedError('the anesthetic view is ROADMAP A17')


def plot_covariance_matrix(covariance, names=None, corrcoef=True, fn=None, show=False):
    """Correlation/covariance heatmap (reference plotting.py
    plot_covariance_matrix)."""
    from matplotlib import pyplot as plt
    cov = getattr(covariance, 'view', lambda: covariance)()
    cov = np.atleast_2d(np.asarray(cov))
    if names is None and hasattr(covariance, 'names'):
        names = covariance.names()
    mat = cov
    if corrcoef:
        sig = np.sqrt(np.diag(cov))
        mat = cov / np.outer(sig, sig)
    fig, ax = plt.subplots(figsize=(1. + 0.5 * len(mat),) * 2)
    im = ax.imshow(mat, vmin=-1. if corrcoef else None, vmax=1. if corrcoef else None,
                   cmap='RdBu_r')
    fig.colorbar(im, ax=ax, shrink=0.8)
    if names is not None:
        ax.set_xticks(range(len(names)), [str(n) for n in names], rotation=90)
        ax.set_yticks(range(len(names)), [str(n) for n in names])
    if fn:
        fig.savefig(fn, bbox_inches='tight')
    if show:
        plt.show()
    return fig


def plot_contour(profiles, pair, labels=None, colors=None, truths=None,
                 fn=None, show=False):
    """2D confidence contours from one or several Profiles containers
    (reference samples/plotting.py contour plots).

    Reads the canonical contour form ({'paths': {cl: [(x, y), ...]}, 'grid':
    (g1, g2, chi2)}) through ``Profiles.contour_paths`` (all disjoint
    segments drawn); when only the grid is stored, contours are drawn at
    the 2D Delta-chi2 levels (2.30, 6.18).
    """
    from matplotlib import pyplot as plt
    if not isinstance(profiles, (list, tuple)):
        profiles = [profiles]
    pair = tuple(getattr(p, 'name', p) for p in pair)
    if colors is None:
        colors = ['C{:d}'.format(i) for i in range(len(profiles))]
    fig, ax = plt.subplots(figsize=(4.2, 4))
    for iprof, (prof, color) in enumerate(zip(profiles, colors)):
        label = labels[iprof] if labels else None
        paths = prof.contour_paths(pair) if pair in prof.contour else {}
        if paths:
            for icl, (cl, segs) in enumerate(sorted(paths.items())):
                for iseg, (x, y) in enumerate(segs):
                    ax.plot(np.asarray(x), np.asarray(y), color=color,
                            lw=1.5 - 0.5 * icl,
                            label=label if icl == 0 and iseg == 0 else None)
        else:
            entry = prof.contour.get(pair, {})
            grid = entry.get('grid') if isinstance(entry, dict) else None
            if grid is None:
                raise ValueError('no contour stored for pair {}'.format(pair))
            g1, g2, chi2 = (np.asarray(g) for g in grid)
            ax.contour(g1, g2, (chi2 - chi2.min()).T, levels=[2.30, 6.18],
                       colors=color)
            if label:
                ax.plot([], [], color=color, label=label)
        if prof.bestfit.names():
            best = prof.choice()
            if pair[0] in best and pair[1] in best:
                ax.plot(best[pair[0]], best[pair[1]], marker='+', color=color)
    if truths:
        if pair[0] in truths:
            ax.axvline(truths[pair[0]], color='k', linestyle=':', lw=1)
        if pair[1] in truths:
            ax.axhline(truths[pair[1]], color='k', linestyle=':', lw=1)
    ax.set_xlabel(pair[0])
    ax.set_ylabel(pair[1])
    if labels:
        ax.legend()
    if fn:
        fig.savefig(fn, bbox_inches='tight', dpi=120)
    if show:
        plt.show()
    return fig


def _mean_std_of(source, name):
    """(mean, std) of a parameter from a Chain / Profiles / LikelihoodFisher."""
    from .chain import Chain
    from .profiles import Profiles
    if isinstance(source, Chain):
        return float(source.mean(name)), float(source.std(name))
    if isinstance(source, Profiles):
        best = source.choice()
        err = source.error.get(name)
        if err is None and source.interval.get(name) is not None:
            lo, hi = source.interval[name]
            err = 0.5 * (hi - lo)
        return float(best[name]), float(err) if err is not None else np.nan
    # LikelihoodFisher-like: mean()/std() by name
    return float(source.mean(name)), float(source.std(name))


def plot_comparison(sources, params=None, labels=None, colors=None, truths=None,
                    fn=None, show=False):
    """Aligned per-parameter comparison across analyses (the reference's
    stacked comparison plots, samples/plotting.py): one panel per parameter,
    each source drawn as a mean +/- 1 sigma whisker on its own row.

    sources : list of Chain / Profiles / LikelihoodFisher
    """
    from matplotlib import pyplot as plt
    if not isinstance(sources, (list, tuple)):
        sources = [sources]
    if params is None:
        from .chain import Chain
        first = sources[0]
        params = ([p.name for p in first.params if p.name not in first._reserved]
                  if isinstance(first, Chain) else
                  [n for n in first.bestfit.names() if n != 'logposterior'])
    params = [getattr(p, 'name', p) for p in params]
    if labels is None:
        labels = ['#{:d}'.format(i) for i in range(len(sources))]
    if colors is None:
        colors = ['C{:d}'.format(i) for i in range(len(sources))]
    n = len(params)
    fig, axes = plt.subplots(1, n, figsize=(2.6 * n, 0.5 + 0.45 * len(sources)),
                             squeeze=False, sharey=True)
    ypos = np.arange(len(sources))[::-1]
    for ax, name in zip(axes[0], params):
        for y, source, color in zip(ypos, sources, colors):
            mean, std = _mean_std_of(source, name)
            ax.errorbar(mean, y, xerr=std if np.isfinite(std) else None,
                        marker='o', color=color, capsize=3)
        if truths and name in truths:
            ax.axvline(truths[name], color='k', linestyle=':', lw=1)
        ax.set_xlabel(name)
        ax.set_yticks(ypos)
    axes[0][0].set_yticklabels(labels)
    axes[0][0].set_ylim(-0.5, len(sources) - 0.5)
    if fn:
        fig.savefig(fn, bbox_inches='tight', dpi=120)
    if show:
        plt.show()
    return fig
