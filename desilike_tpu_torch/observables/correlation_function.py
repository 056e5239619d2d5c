"""Tracer correlation-function multipoles observable.

Counterpart of ``desilike_tpu/observables/correlation_function.py``: binned
theory xi_l(s) against a flat data vector, which ``data={...}`` generates
from the theory itself (a host-side float64 evaluation). Measured data
vectors (arrays, ``ObservableArray``), covariances attached to the
observable (matrices or mock vectors) and the plot wait for ROADMAP A12.
"""

from ..core import Calculator, Pipeline
from .window import WindowedCorrelationFunctionMultipoles


class TracerCorrelationFunctionMultipolesObservable(Calculator):
    """Observable: binned theory xi_l(s) vs flat data vector.

    Parameters
    ----------
    data : dict
        Generate the data vector from the theory at these parameter values.
    slim, s, ells, theory, fiber_collisions, systematic_templates : see
        WindowedCorrelationFunctionMultipoles

    The covariance is given to the likelihood.
    """

    def initialize(self, data=None, covariance=None, slim=None, s=None, ells=None, theory=None,
                   fiber_collisions=None, systematic_templates=None):
        if not isinstance(data, dict) or covariance is not None:
            raise NotImplementedError('measured data vectors and covariances attached to the observable are '
                                      'ROADMAP A12: pass data={parameter: value} to generate the data from the '
                                      'theory, and the covariance (or footprints) to the likelihood')
        self.wmatrix = WindowedCorrelationFunctionMultipoles(slim=slim, s=s, ells=ells, theory=theory,
                                                             fiber_collisions=fiber_collisions,
                                                             systematic_templates=systematic_templates)
        self.wmatrix.runtime_info.initialize()
        # self-generated mock: evaluate own sub-pipeline at the given params
        self.flatdata = Pipeline(self.wmatrix).host_evaluate(data)[0].numpy()

    def calculate(self, **params):
        self.flattheory = self.wmatrix.flatcorr

    def get(self):
        return self.flattheory
