"""Galaxy-clustering forecast likelihood.

Counterpart of ``desilike_tpu/likelihoods/galaxy_clustering.py``
(``SNWeightedPowerSpectrumLikelihood``): the signal-to-noise-weighted
P(k, mu) likelihood of Fisher forecasts. The (k, mu) precision is diagonal
(a weight vector), and the multipoles -> P(k, mu) projection one static
(nell, nmu) Legendre product per theory and chain.
"""

import numpy as np
import torch

from .base import BaseGaussianLikelihood
from ..utils import is_sequence


class SNWeightedPowerSpectrumLikelihood(BaseGaussianLikelihood):
    r"""Fisher-forecast likelihood integrating anisotropic signal-to-noise
    over mu and k: precision = V/2 (2 pi)^-3 4 pi k^2 dk w_mu / (P + 1/nbar)^2
    per (k, mu) cell.

    Parameters
    ----------
    theories : list of theory multipole calculators (or one)
    data : dict
        Parameters generating the fiducial data vector.
    covariance : dict, optional
        Parameters generating the covariance P(k, mu); defaults to ``data``.
    footprints : list of BaseFootprint (or one)
    klim : (kmin, kmax), optional
        Wavenumber cut (500 linear points).
    mu : int, default=20
        Gauss-Legendre mu nodes on [0, 1].
    """

    def initialize(self, theories=None, data=None, covariance=None, footprints=None, klim=None, mu=20):
        from ..core import Pipeline
        from ..core.collection import CollectionCalculator
        from ..ops.legendre import weights_mu, trapz_weights

        if not is_sequence(theories):
            theories = [theories]
        theories = list(theories)
        if not is_sequence(footprints):
            footprints = [footprints] * len(theories)
        self.footprints = list(footprints)
        if klim is not None:
            k = np.linspace(klim[0], klim[1], 500)
            for theory in theories:
                theory.init.update(k=k)
        self.theories = CollectionCalculator(calculators=theories)
        self.theories.runtime_info.initialize()
        self.mu_nodes, wmu = weights_mu(mu)
        # static multipole -> P(k, mu) projection matrices
        self._legs = []
        for i, theory in enumerate(theories):
            theory.runtime_info.initialize()
            legs = np.stack([np.polynomial.legendre.Legendre.basis(ell)(self.mu_nodes) for ell in theory.ells])
            self._legs.append(legs)
            setattr(self, '_legs_{:d}'.format(i), legs)
        prefactor = 4. * np.pi / (2. * (2. * np.pi) ** 3) * wmu

        def host_power():
            return [theory.power[0].numpy().T for theory in theories]  # (nk, nell) each

        pipe = Pipeline(self.theories)
        pipe.host_evaluate(dict(covariance if covariance is not None else (data or {})))
        wdiag = []
        for power, theory, footprint, legs in zip(host_power(), theories, self.footprints, self._legs):
            k = np.asarray(theory.k)
            weights = prefactor[None, :] * float(footprint.volume) * (k ** 2 * trapz_weights(k))[:, None] \
                * (power @ legs + float(footprint.shotnoise)) ** -2
            wdiag.append(weights.ravel())
        pipe.host_evaluate(dict(data or {}))
        self.flatdata = np.concatenate([(power @ legs).ravel() for power, legs in zip(host_power(), self._legs)])
        self._wdiag = np.concatenate(wdiag)
        # diagonal whitening: flatdiff_white is an elementwise product, and the generic marginalization
        # (J @ diff_white) works unchanged
        self._whiten = self._whiten_base = np.sqrt(self._wdiag)
        self.precision = self._precision_base = self._wdiag
        self._mock_factor = 1.
        self._static_J = {}

    @property
    def nmocks(self):
        return 0

    def flattheory(self):
        return torch.cat([(theory.power.mT @ self.const('_legs_{:d}'.format(i))).flatten(-2)
                          for i, theory in enumerate(self.theories)], dim=-1)

    def calculate(self, **params):
        diff = self.flattheory() - self.const('flatdata')
        self.flatdiff = diff
        self.flatdiff_white = self.const('_whiten') * diff
        self.loglikelihood = -0.5 * (self.flatdiff_white ** 2).sum(-1)
