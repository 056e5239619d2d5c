"""Compression observables: Gaussian likelihoods on compressed parameters.

Counterpart of ``desilike_tpu/observables/compression.py``: the data vector
is a set of compressed measurements (DH/rd, DM/rd, df, dm, ...) from a BAO
or ShapeFit fit, given as values or read from a :class:`~..samples.Chain`
(its best fit and covariance); the theory is the corresponding extractor
(``theories/extractors.py``) evaluated per chain on the ``Cosmology`` node.
"""

import numpy as np
import torch

from ..core import Calculator
from ..theories.extractors import (BAOExtractor, ShapeFitPowerSpectrumExtractor, StandardPowerSpectrumExtractor,
                                   WiggleSplitPowerSpectrumExtractor, BandVelocityPowerSpectrumExtractor,
                                   TurnOverPowerSpectrumExtractor, BAOPhaseShiftExtractor)
from ..theories.lya import P1DPowerSpectrumExtractor
from ..interop import is_path, load_source


def _is_source(obj):
    """True for chains (or objects with a best fit: profiles), paths, or
    sequences thereof."""
    from ..samples import Chain
    if isinstance(obj, Chain) or hasattr(obj, 'bestfit') or is_path(obj):
        return True
    if isinstance(obj, (list, tuple)) and obj:
        return _is_source(obj[0])
    return False


class BaseCompressionObservable(Calculator):
    """Gaussian observable on compressed quantities.

    Parameters
    ----------
    data : dict name -> value, array matching ``quantities``, or a Chain
        source (instance, path, or a list of them: its best fit)
    covariance : matrix, standard deviations, or a Chain source (its
        covariance); by default that of a Chain ``data``
    quantities : list of extractor attribute names, e.g.
        ['DM_over_rd', 'DH_over_rd']
    z : effective redshift
    cosmo : optional shared Cosmology node
    """

    _extractor_cls = BAOExtractor
    _default_quantities = ['DM_over_rd', 'DH_over_rd']
    _state_attrs = ['flattheory']

    @classmethod
    def _quantities_default(cls, init_kwargs):
        return list(cls._default_quantities)

    def initialize(self, data=None, covariance=None, quantities=None, z=1., cosmo=None, fiducial=None, burnin=None,
                   **kwargs):
        if quantities is None:
            quantities = self._quantities_default(kwargs)
        self.quantities = list(quantities)
        kw = dict(z=z, cosmo=cosmo, **kwargs)
        if fiducial is not None:
            kw['fiducial'] = fiducial
        self.extractor = self._extractor_cls(**kw)
        if _is_source(data):
            source = data
            data = load_source(source, choice={'index': 'argmax'}, burnin=burnin, params=self.quantities)
            if covariance is None:
                _, covariance = load_source(source, cov=True, burnin=burnin, params=self.quantities)
        if _is_source(covariance):
            _, covariance = load_source(covariance, cov=True, burnin=burnin, params=self.quantities)
        if isinstance(data, dict):
            data = [data[q] for q in self.quantities]
        self.flatdata = np.ravel(np.asarray(data, dtype='f8'))
        if covariance is None:
            raise ValueError('provide covariance for compression observable')
        self._covariance_input = np.atleast_2d(np.asarray(covariance, dtype='f8'))
        if self._covariance_input.shape[0] == 1 and len(self.flatdata) > 1:
            self._covariance_input = np.diag(np.asarray(covariance, dtype='f8') ** 2)

    @property
    def covariance(self):
        return self._covariance_input

    @property
    def nmocks(self):
        return 0

    def calculate(self, **params):
        values = torch.broadcast_tensors(*[torch.as_tensor(getattr(self.extractor, q), dtype=self.dtype,
                                                           device=self.device) for q in self.quantities])
        self.flattheory = torch.stack(values, dim=-1)

    @property
    def flatdiff(self):
        return self.flattheory - self.const('flatdata')

    def get(self):
        return self.flattheory


class BAOCompressionObservable(BaseCompressionObservable):
    """BAO distance-ratio compression: (DM/rd, DH/rd)."""

    _extractor_cls = BAOExtractor


class ShapeFitCompressionObservable(BaseCompressionObservable):
    """ShapeFit compression: (DM/rd, DH/rd, df, dm)."""

    _extractor_cls = ShapeFitPowerSpectrumExtractor
    _default_quantities = ['DM_over_rd', 'DH_over_rd', 'df', 'dm']


class StandardCompressionObservable(BaseCompressionObservable):
    """Standard RSD compression: (DM/rd, DH/rd, df)."""

    _extractor_cls = StandardPowerSpectrumExtractor
    _default_quantities = ['DM_over_rd', 'DH_over_rd', 'df']


class WiggleSplitCompressionObservable(BaseCompressionObservable):
    """Wiggle-split compression: (qbao, qap, df, dm)."""

    _extractor_cls = WiggleSplitPowerSpectrumExtractor
    _default_quantities = ['qbao', 'qap', 'df', 'dm']


class BandVelocityCompressionObservable(BaseCompressionObservable):
    """Band velocity power compression: (dptt_i..., df, qap). Pass the band
    pivots as ``kp=``."""

    _extractor_cls = BandVelocityPowerSpectrumExtractor

    @classmethod
    def _quantities_default(cls, init_kwargs):
        kp = init_kwargs.get('kp', None)
        n = len(kp) if kp is not None else 0
        return ['dptt{:d}'.format(i) for i in range(n)] + ['df', 'qap']


class TurnOverCompressionObservable(BaseCompressionObservable):
    """Turn-over compression: (DV * kTO, DM/DH) (arXiv:2302.07484)."""

    _extractor_cls = TurnOverPowerSpectrumExtractor
    _default_quantities = ['DV_times_kTO', 'DM_over_DH']


class P1DCompressionObservable(BaseCompressionObservable):
    """Lya P1D compression: (delta2_star, n_star)."""

    _extractor_cls = P1DPowerSpectrumExtractor
    _default_quantities = ['delta2_star', 'n_star']


class BAOPhaseShiftCompressionObservable(BaseCompressionObservable):
    """BAO + neutrino phase shift compression: (DM/rd, DH/rd, baoshift)
    (arXiv:1803.10741)."""

    _extractor_cls = BAOPhaseShiftExtractor
    _default_quantities = ['DM_over_rd', 'DH_over_rd', 'baoshift']
