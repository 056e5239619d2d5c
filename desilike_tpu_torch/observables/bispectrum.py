"""Tracer bispectrum multipoles observable.

Counterpart of ``desilike_tpu/observables/bispectrum.py``: the theory
B_l(k1, k2, k3) on given triangles against a flat data vector, with an
explicit covariance or one estimated from mock vectors (the likelihood then
applies the Hartlap and Percival factors).
"""

import numpy as np

from ..core import Calculator, Pipeline
from .power_spectrum import _flat_covariance


class TracerBispectrumMultipolesObservable(Calculator):
    """Observable: theory B_l(k1, k2, k3) on given triangles vs flat data.

    data : dict (generated from the theory at these parameter values, a
        host-side float64 evaluation) or array.
    covariance : the explicit (ndata, ndata) matrix, a list of mock vectors
        (their sample covariance), or None (then the likelihood takes one).
    """

    _state_attrs = ['flattheory']

    def initialize(self, data=None, covariance=None, triangles=None, ells=(0,), theory=None):
        if theory is None:
            from ..theories.bispectrum import TreeLevelBispectrumMultipoles
            theory = TreeLevelBispectrumMultipoles(triangles=triangles, ells=ells)
        elif triangles is not None:
            theory.init.update(triangles=triangles, ells=ells)
        self.theory = theory
        self.theory.runtime_info.initialize()
        self.triangles = self.theory.triangles
        self.ells = tuple(self.theory.ells)
        self.mocks, self._covariance_input = _flat_covariance(covariance)
        if isinstance(data, dict):
            self.flatdata = Pipeline(self.theory).host_evaluate(data)[0].numpy().ravel()
        elif data is not None:
            self.flatdata = np.asarray(data, dtype='f8').ravel()
        else:
            self.flatdata = None

    @property
    def covariance(self):
        return self._covariance_input

    @property
    def nmocks(self):
        return len(self.mocks) if self.mocks is not None else 0

    def calculate(self, **params):
        self.flattheory = self.theory.bispectrum.reshape(self.theory.bispectrum.shape[0], -1)

    @property
    def flatdiff(self):
        return self.flattheory - self.const('flatdata')

    def get(self):
        return self.flattheory
