"""Tracer correlation-function multipoles observable.

Counterpart of ``desilike_tpu/observables/correlation_function.py``: binned
theory xi_l(s) against a flat data vector, measured (an array, an
``ObservableArray``) or generated from the theory itself (``data={...}``, a
host-side float64 evaluation), with an optional covariance (a matrix, mock
vectors, or an ``ObservableCovariance``), fiber collisions and systematic
templates. ``plot`` draws data and theory (matplotlib, imported there).
"""

import numpy as np

from ..core import Calculator, Pipeline
from .power_spectrum import _flat_covariance, _split, _theory_row
from .window import WindowedCorrelationFunctionMultipoles


class TracerCorrelationFunctionMultipolesObservable(Calculator):
    """Observable: binned theory xi_l(s) vs flat data vector.

    Parameters
    ----------
    data : dict (generate from theory at these params), array, ObservableArray, or None
    covariance : matrix, list of mock vectors, or ObservableCovariance
    slim : dict ell -> (smin, smax, sstep)
    s, ells, theory, fiber_collisions, systematic_templates : see
        WindowedCorrelationFunctionMultipoles
    """

    _state_attrs = ['flattheory']

    def initialize(self, data=None, covariance=None, slim=None, s=None, ells=None, theory=None,
                   fiber_collisions=None, systematic_templates=None):
        from .types import ObservableArray, ObservableCovariance
        self._nobs_input = None
        if isinstance(covariance, ObservableCovariance):
            self._nobs_input = covariance.nobs
            covariance = covariance.value
        if isinstance(data, ObservableArray):
            s, ells, slim = list(data.x), tuple(data.projs), None
            data = data.flatvalue
        self.wmatrix = WindowedCorrelationFunctionMultipoles(slim=slim, s=s, ells=ells, theory=theory,
                                                             fiber_collisions=fiber_collisions,
                                                             systematic_templates=systematic_templates)
        self.wmatrix.runtime_info.initialize()
        self.mocks, self._covariance_input = _flat_covariance(covariance)
        if data is None:
            self.flatdata = None
        elif isinstance(data, dict):
            # self-generated mock: evaluate own sub-pipeline at the given params
            self.flatdata = Pipeline(self.wmatrix).host_evaluate(data)[0].numpy()
        else:
            self.flatdata = np.ravel(np.asarray(data, dtype='f8'))

    @property
    def s(self):
        return self.wmatrix.s

    @property
    def sedges(self):
        return self.wmatrix.sedges

    @property
    def ells(self):
        return self.wmatrix.ells

    @property
    def covariance(self):
        return self._covariance_input

    @property
    def nmocks(self):
        if self.mocks is not None:
            return len(self.mocks)
        return self._nobs_input or 0

    @property
    def data(self):
        return _split(self.flatdata, self.s)

    def to_array(self):
        """Data vector as an ObservableArray (projections = multipoles)."""
        from .types import ObservableArray
        return ObservableArray(x=self.s, value=self.data if self.flatdata is not None else None,
                               projs=list(self.ells), name='correlation')

    def calculate(self, **params):
        self.flattheory = self.wmatrix.flatcorr

    @property
    def flatdiff(self):
        return self.flattheory - self.const('flatdata')

    def get(self):
        return self.flattheory

    def plot(self, fn=None, show=False):
        """Plot data vs theory multipoles with residuals; the theory is the
        first chain of the last evaluation (the parameters' values on the
        host, if there was none)."""
        from matplotlib import pyplot as plt
        fig, lax = plt.subplots(2, sharex=True, figsize=(6, 6), gridspec_kw={'height_ratios': [3, 1]})
        flattheory, start = _theory_row(self), 0
        for ill, ss in enumerate(self.s):
            th = flattheory[start:start + len(ss)]
            color = 'C{:d}'.format(ill)
            lax[0].plot(ss, ss ** 2 * th, color=color, label=r'$\ell={:d}$'.format(self.ells[ill]))
            if self.flatdata is not None:
                dat = self.data[ill]
                std = None
                if self._covariance_input is not None:
                    std = np.sqrt(np.diag(self._covariance_input))[start:start + len(ss)]
                if std is not None:
                    lax[0].errorbar(ss, ss ** 2 * dat, ss ** 2 * std, color=color, linestyle='none', marker='.')
                    lax[1].plot(ss, (dat - th) / std, color=color)
            start += len(ss)
        lax[0].legend()
        lax[0].set_ylabel(r'$s^2 \xi_\ell(s)$')
        lax[1].set_xlabel(r'$s$ [$\mathrm{Mpc}/h$]')
        if fn:
            fig.savefig(fn, bbox_inches='tight')
        if show:
            plt.show()
        return fig
