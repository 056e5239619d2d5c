"""Base theory classes: multipole grids, mu-wedge projection, AP effect.

Counterpart of ``desilike_tpu/theories/base.py`` in the direct-parameter AP
modes ('qiso', 'qap', 'qisoqap', 'qparqper'). The 'geometry' and 'bao'
modes, which read distances from a varied cosmology, and the
correlation-function bases wait for ``theories/cosmology.py`` and the xi
path (ROADMAP A10, A11).
"""

import numpy as np
import torch

from ..core import Calculator
from ..ops.legendre import weights_mu, multipole_weights, to_poles


def _col(value):
    """(B,) parameter -> (B, 1, 1), to broadcast against (B, nk, nmu) grids;
    a plain number stays as it is."""
    return value[..., None, None] if isinstance(value, torch.Tensor) else value


def ap_k_mu(k, mu, qpar=1., qper=1.):
    """Alcock-Paczynski remap of (k, mu), Beutler 2016 eqs. 44-45.

    k: (nk,) and mu: (nmu,) tensors; qpar, qper: scalars or (B,) tensors.
    Returns jac (B,), kap (B, nk, nmu) and muap (B, 1, nmu); without a batch
    dimension, jac is 0-d, kap (nk, nmu) and muap (1, nmu).
    """
    qpar = torch.as_tensor(qpar, dtype=k.dtype, device=k.device)
    qper = torch.as_tensor(qper, dtype=k.dtype, device=k.device)
    jac = 1. / (qpar * qper ** 2)
    qap = (qpar / qper)[..., None, None]
    factorap = torch.sqrt(1. + mu ** 2 * (1. / qap ** 2 - 1.))
    kap = k[:, None] / qper[..., None, None] * factorap
    muap = mu / qap / factorap
    return jac, kap, muap


class BaseTheoryPowerSpectrumMultipoles(Calculator):
    """Base for theory P_l(k); output attribute ``power`` of shape (B, nell, nk)."""

    def initialize(self, k=None, ells=(0, 2, 4), **kwargs):
        if k is None:
            k = np.linspace(0.01, 0.2, 101)
        self.k = np.asarray(k, dtype='f8')
        self.ells = tuple(ells)

    def get(self):
        return self.power


class WedgesMixin(object):
    """mu-wedge -> multipole projection."""

    def set_k_mu(self, k, mu=20, method='leggauss', ells=(0, 2, 4)):
        self.k = np.asarray(k, dtype='f8')
        self.mu, wmu = weights_mu(mu, method=method)
        self.wmu = multipole_weights(ells, self.mu, wmu)   # (nell, nmu)

    def to_poles(self, pkmu):
        """pkmu (..., nk, nmu) -> (..., nell, nk)."""
        return to_poles(pkmu, self.const('wmu'))


class APEffect(Calculator):
    """Alcock-Paczynski scaling in the direct-parameter modes 'qiso', 'qap',
    'qisoqap', 'qparqper'."""

    @staticmethod
    def _params(init):
        mode = init.get('mode', 'geometry')
        specs = {
            'qiso': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_{\rm iso}'),
            'qap': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_{\rm AP}'),
            'qpar': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_\parallel'),
            'qper': dict(value=1., prior=dict(limits=[0.8, 1.2]), ref=dict(dist='norm', loc=1., scale=0.02), delta=0.005, latex=r'q_\perp'),
        }
        varied = {'qiso': ['qiso'], 'qap': ['qap'], 'qisoqap': ['qiso', 'qap'],
                  'qparqper': ['qpar', 'qper'], 'geometry': [], 'bao': []}[mode]
        return {name: specs[name] for name in varied}

    def initialize(self, z=1., mode='geometry', eta=1. / 3.):
        self.z = float(np.asarray(z))
        self.mode = str(mode)
        if self.mode in ('geometry', 'bao'):
            raise NotImplementedError("APEffect mode {!r} reads a varied cosmology: it is ported with "
                                      "theories/cosmology.py (ROADMAP A11)".format(self.mode))
        self.eta = float(eta)

    def calculate(self, **params):
        if self.mode == 'qiso':
            qpar = qper = params['qiso']
        elif self.mode == 'qap':
            qap = params['qap']
            qpar, qper = qap ** (1. - self.eta), qap ** (-self.eta)
        elif self.mode == 'qisoqap':
            qiso, qap = params['qiso'], params['qap']
            qpar, qper = qiso * qap ** (1. - self.eta), qiso * qap ** (-self.eta)
        else:  # qparqper
            qpar, qper = params['qpar'], params['qper']
        self.qpar, self.qper = qpar, qper
        self.qap = qpar / qper
        self.qiso = qpar ** self.eta * qper ** (1. - self.eta)
