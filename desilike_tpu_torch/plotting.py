"""Top-level plotting helpers (counterpart of ``desilike_tpu/plotting.py``,
the reference's plotting.py): the ``plotter`` decorator and ``savefig``,
and the chain and profile plots of :mod:`.samples.plotting`. matplotlib is
imported inside the functions.
"""

from functools import wraps


def savefig(filename, fig=None, bbox_inches='tight', pad_inches=0.1, dpi=200, **kwargs):
    """Save the current (or given) matplotlib figure, creating directories
    (ref plotting.py:20)."""
    import os
    from matplotlib import pyplot as plt
    if os.path.dirname(str(filename)):
        os.makedirs(os.path.dirname(str(filename)), exist_ok=True)
    fig = fig if fig is not None else plt.gcf()
    fig.savefig(str(filename), bbox_inches=bbox_inches, pad_inches=pad_inches,
                dpi=dpi, **kwargs)
    return fig


def plotter(*args, **_ignored):
    """Decorator adding ``fn=`` (save path), ``kw_save=``, ``show=`` and
    ``fig=`` keywords to a plotting function (ref plotting.py:101). Usable
    bare (``@plotter``) or called (``@plotter(interactive=...)`` — the
    interactive options are accepted and ignored)."""

    def get_wrapper(func):
        @wraps(func)
        def wrapper(*fargs, fn=None, kw_save=None, show=False, **kwargs):
            fig = func(*fargs, **kwargs)
            if fn is not None:
                savefig(fn, fig=fig if hasattr(fig, 'savefig') else None,
                        **(kw_save or {}))
            if show:
                from matplotlib import pyplot as plt
                plt.show()
            return fig
        return wrapper

    if len(args) == 1 and callable(args[0]):
        return get_wrapper(args[0])
    return get_wrapper


from .samples.plotting import (plot_triangle, plot_trace, plot_profile, plot_triangle_getdist,  # noqa: E402,F401
                               to_anesthetic, plot_covariance_matrix, plot_contour, plot_comparison)
