"""Lyman-alpha forest: the 1D flux power-spectrum shape extractor.

Counterpart of ``desilike_tpu/theories/lya.py``: the amplitude Delta^2_*
and the slope n_* of the linear power spectrum at the velocity-space pivot
k_* [s/km] at the effective redshift (z ~ 3), per chain of the cosmology
node's parameters.
"""

import numpy as np
import torch

from ..core import Calculator
from ..cosmology import background as bg
from ..cosmology import linear as lin
from .cosmology import Cosmology


class P1DPowerSpectrumExtractor(Calculator):

    _params = {name: dict(derived=True) for name in ('delta2_star', 'n_star')}

    def initialize(self, z=3., kp_vel=0.009, cosmo=None):
        """kp_vel: the pivot in s/km, k [h/Mpc] = kp_vel 100 E(z) / (1 + z) / h."""
        self.z = float(z)
        self.kp_vel = float(kp_vel)
        self.cosmo = cosmo if cosmo is not None else Cosmology()

    def calculate(self, **params):
        p = self.cosmo.p
        kp = self.kp_vel * 100. * bg.efunc(p, self.z) / (1. + self.z) / p['h']   # h/Mpc, (B,)
        dk = 1e-2
        kk = kp[..., None] * bg.as_grid(np.array([1. - dk, 1., 1. + dk]), p)     # (B, 3), one row a chain
        pk = bg.per_chain(lambda pp, row: lin.pk_lin(pp, row, self.z), p, kk)
        self.delta2_star = kk[..., 1] ** 3 * pk[..., 1] / (2. * np.pi ** 2)
        self.n_star = torch.log(pk[..., 2] / pk[..., 0]) / torch.log(kk[..., 2] / kk[..., 0])

    def get(self):
        return self
