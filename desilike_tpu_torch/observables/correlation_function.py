"""Tracer correlation-function multipoles observable.

Counterpart of ``desilike_tpu/observables/correlation_function.py``: binned
theory xi_l(s) against a flat data vector, measured (an array, an
``ObservableArray``) or generated from the theory itself (``data={...}``, a
host-side float64 evaluation), with an optional covariance (a matrix, mock
vectors, or an ``ObservableCovariance``), fiber collisions and systematic
templates. Plotting waits for ROADMAP A15.
"""

import numpy as np

from ..core import Calculator, Pipeline
from .power_spectrum import _flat_covariance, _split
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

    def plot(self, *args, **kwargs):
        raise NotImplementedError('plotting is ROADMAP A15')
