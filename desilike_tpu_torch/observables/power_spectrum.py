"""Tracer power-spectrum multipoles observable.

Counterpart of ``desilike_tpu/observables/power_spectrum.py``: windowed
theory P_l(k) against a flat data vector, which ``data={...}`` generates from
the theory itself (a host-side float64 evaluation). Measured data vectors
and their loaders and covariances attached to the observable (from mocks,
with the Hartlap/Percival factors) wait for ROADMAP A12.
"""

from ..core import Calculator, Pipeline
from .window import WindowedPowerSpectrumMultipoles


class TracerPowerSpectrumMultipolesObservable(Calculator):
    """Observable: windowed theory P_l(k) vs flat data vector.

    Parameters
    ----------
    data : dict
        Generate the data vector from the theory at these parameter values.
    klim, wmatrix, theory : see WindowedPowerSpectrumMultipoles
    transform : None or 'cubic'
        'cubic': the Gaussianization of Wang et al. 2023 (arXiv:2302.07484,
        eq. 16), the theory compared as (3 (T / D)^(1/3) - 2) D. It makes the
        residual nonlinear in every parameter, so the likelihood solves the
        parameters of this observable by its linearize path.

    The covariance is given to the likelihood.
    """

    def initialize(self, data=None, klim=None, wmatrix=None, theory=None, transform=None, **kwargs):
        if transform not in (None, 'cubic'):
            raise ValueError("transform must be None or 'cubic' (got {!r})".format(transform))
        self.transform = transform
        if not isinstance(data, dict):
            raise NotImplementedError('measured data vectors are ROADMAP A12: pass data={parameter: value} '
                                      'to generate the data from the theory')
        self.wmatrix = WindowedPowerSpectrumMultipoles(klim=klim, wmatrix=wmatrix, theory=theory, **kwargs)
        self.wmatrix.runtime_info.initialize()
        # self-generated mock: evaluate own sub-pipeline at the given params
        self.flatdata = Pipeline(self.wmatrix).host_evaluate(data)[0].numpy()

    def calculate(self, **params):
        self.flattheory = self.wmatrix.flatpower
        if self.transform == 'cubic':
            data = self.const('flatdata')
            self.flattheory = (3. * (self.flattheory / data) ** (1. / 3.) - 2.) * data

    def get(self):
        return self.flattheory
