"""Redshift-space galaxy bispectrum multipoles (tree level, with a linear
or 1-loop input pk).

Counterpart of ``desilike_tpu/theories/bispectrum.py``: the Scoccimarro
RSD kernels Z1/Z2 with quadratic biasing, averaged over orientations on
static Gauss-Legendre (theta) x uniform (phi) grids; ``(ell1, ell2, ell3)``
multipole labels (one nonzero ell: the Legendre polynomial in the LOS cosine
of that side); exact Alcock-Paczynski remapping of the sides per
orientation, with the 1/(qpar qper^2)^2 volume dilation; ``sigmav``
finger-of-god damping; ``pt='1loop'``: the input pk is the 1-loop SPT
matter pk from the FFTLog-matrix engine. Every geometric factor is a static
(ntri, ntheta, nphi) grid; per evaluation the chain batch leads, and the
template's pk is looked up at each chain's true sides.
"""

import numpy as np
import torch

from ..core import Calculator
from .power_template import ShapeFitPowerSpectrumTemplate


def _legendre(ell, x):
    if ell == 0:
        return torch.ones_like(x)
    if ell == 1:
        return x
    if ell == 2:
        return (3. * x ** 2 - 1.) / 2.
    if ell == 3:
        return (5. * x ** 3 - 3. * x) / 2.
    if ell == 4:
        return (35. * x ** 4 - 30. * x ** 2 + 3.) / 8.
    raise ValueError('bispectrum multipole ell={} not supported'.format(ell))


def _c3(value):
    """(B,) parameter -> (B, 1, 1, 1), against (B, ntri, ntheta, nphi) grids."""
    return value[..., None, None, None] if isinstance(value, torch.Tensor) else value


class TreeLevelBispectrumMultipoles(Calculator):
    r"""B_{l1 l2 l3} for a list of triangles (k1, k2, k3), (B, nell, ntri).

    B(k1, k2, k3; orientation) = 2 Z2(k1,k2) Z1(k1) Z1(k2) P(k1) P(k2) + cyc.
    with Z1 = b1 + f mu^2, Z2 the second-order RSD kernel with b2/bs2;
    multipoles from orientation averages of Legendre(mu_i) products.

    Parameters
    ----------
    triangles : (ntri, 3) array, optional
        Triangle side lengths; 6 equilateral triangles by default.
    ells : tuple, default=(0,)
        ints (Legendre in mu1, i.e. (ell, 0, 0)) or 3-tuples (ell1, ell2,
        ell3) with a single nonzero entry.
    template : the linear pk template; its qpar/qper drive the AP remapping.
    pt : None (linear input pk) or '1loop' (the 1-loop SPT matter pk).
    """

    _state_attrs = ['bispectrum']

    _params = {
        'b1': dict(value=2., prior=dict(limits=[0., 4.]), ref=dict(dist='norm', loc=2., scale=0.1), latex='b_1'),
        'b2': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.), latex='b_2'),
        'bs2': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.), latex='b_{s2}'),
        'sigmav': dict(value=0., prior=dict(dist='norm', loc=0., scale=4.), latex=r'\sigma_{v,B}'),
        'snB': dict(value=0., prior=dict(dist='norm', loc=0., scale=5.), latex='s_{n,B}'),
    }

    def initialize(self, triangles=None, ells=(0,), template=None, ntheta=8, nphi=8,
                   shotnoise=1e4, pt=None, nk_loop=96):
        if triangles is None:
            k = np.linspace(0.02, 0.12, 6)
            triangles = [(k1, k1, k1) for k1 in k]
        self.triangles = np.asarray(triangles, dtype='f8')  # (ntri, 3)
        self.ells = tuple(ells)
        self._ells3 = tuple((e, 0, 0) if not hasattr(e, '__len__') else tuple(e) for e in self.ells)
        if template is None:
            template = ShapeFitPowerSpectrumTemplate()
        self.template = template
        kin = np.geomspace(1e-4, 1., 600)
        self.template.init.update(k=kin)
        self.nd = 1. / float(shotnoise)
        if pt not in (None, '1loop'):
            raise ValueError("pt must be None or '1loop', got {!r}".format(pt))
        self.pt = pt
        if pt == '1loop':
            from ..ops.spt_fftlog import FFTLogOneLoop
            from ..ops.chebyshev import ChebyshevLogInterp
            # the loop working grid covers the AP-shifted triangle sides
            klo = max(self.triangles.min() * 0.6, 2. * kin[0])
            khi = min(self.triangles.max() * 1.7, 0.5 * kin[-1])
            self.k_work = np.geomspace(klo, khi, int(nk_loop))
            self.loop = FFTLogOneLoop(self.k_work)
            self._work_cheb = ChebyshevLogInterp(self.k_work, log_values=False)
        # orientation grids (static): (ntri, ntheta, nphi) sides, LOS cosines and pair cosines
        ct, wt = np.polynomial.legendre.leggauss(ntheta)
        phi = (np.arange(nphi) + 0.5) * 2. * np.pi / nphi
        self.ct, self.phi = ct, phi
        self.weights = (wt / 2.)[:, None] * np.full(nphi, 1. / nphi)[None, :]   # (ntheta, nphi)
        k1, k2, k3 = self.triangles.T
        self.mu12 = (k3 ** 2 - k1 ** 2 - k2 ** 2) / (2. * k1 * k2)
        self.mu13 = (k2 ** 2 - k1 ** 2 - k3 ** 2) / (2. * k1 * k3)
        self.mu23 = (k1 ** 2 - k2 ** 2 - k3 ** 2) / (2. * k2 * k3)
        ks = [v[:, None, None] for v in self.triangles.T]
        ct3 = ct[None, :, None]
        st3 = np.sqrt(np.clip(1. - ct3 ** 2, 0., None))
        mu12 = self.mu12[:, None, None]
        shape = (len(self.triangles), ntheta, nphi)
        mu1 = np.broadcast_to(ct3, shape)
        mu2 = mu12 * ct3 + np.sqrt(np.clip(1. - mu12 ** 2, 0., None)) * st3 * np.cos(phi)[None, None, :]
        mu3 = -(ks[0] * mu1 + ks[1] * mu2) / ks[2]  # closure
        self._mus = np.stack([mu1, mu2, mu3])                          # (3, ntri, ntheta, nphi)
        self._ks = np.stack([np.broadcast_to(k, shape) for k in ks])  # (3, ntri, ntheta, nphi)
        self._kpar = self._ks * self._mus
        self._mu_pairs = np.stack([np.broadcast_to(m[:, None, None], shape) for m in (self.mu12, self.mu13, self.mu23)])
        legs = []
        for ell3 in self._ells3:
            leg = np.ones(shape)
            for ell, mu in zip(ell3, self._mus):
                if ell:
                    leg = leg * (2 * ell + 1) * _legendre(ell, torch.as_tensor(mu)).numpy()
            legs.append(leg * self.weights)
        self._legs = np.stack(legs)                                    # (nell, ntri, ntheta, nphi)

    @staticmethod
    def _F2(k1, k2, mu):
        return 5. / 7. + (mu / 2.) * (k1 / k2 + k2 / k1) + (2. / 7.) * mu ** 2

    @staticmethod
    def _G2(k1, k2, mu):
        return 3. / 7. + (mu / 2.) * (k1 / k2 + k2 / k1) + (4. / 7.) * mu ** 2

    def _Z2(self, k1, k2, mu12, mu1, mu2, f, b1, b2, bs2):
        k12mu = k1 * mu1 + k2 * mu2              # (k1+k2) . zhat
        F2 = self._F2(k1, k2, mu12)
        G2 = self._G2(k1, k2, mu12)
        S2 = mu12 ** 2 - 1. / 3.
        k12 = torch.sqrt(torch.clamp(k1 ** 2 + k2 ** 2 + 2. * k1 * k2 * mu12, min=1e-30))
        mu12_los = k12mu / k12
        return (b1 * F2 + f * mu12_los ** 2 * G2
                + f * k12mu / 2. * (mu1 / k1 * (b1 + f * mu2 ** 2) + mu2 / k2 * (b1 + f * mu1 ** 2))
                + b2 / 2. + bs2 / 2. * S2)

    def _pk_evaluator(self, batch):
        """The input pk at (B, ...) true sides: the template's linear pk
        (zero outside its table), or the 1-loop SPT matter pk when
        pt='1loop'."""
        tmpl = self.template
        lo, hi = float(tmpl.k[0]), float(tmpl.k[-1])
        per_row = tmpl.pk_dd_coeffs().ndim == 2

        def pk_lin(kq):
            return tmpl.pk_dd_interp(kq) * ((kq > lo) & (kq < hi))

        if self.pt != '1loop':
            return pk_lin

        def pk_static(kq):  # a static grid, for each chain's coefficients
            return pk_lin(kq.expand((batch,) + kq.shape) if per_row else kq)

        t = self.loop.tables(pk_static, dtype=self.dtype, device=self.device)
        pk1 = pk_static(self.const('k_work')) + t['p22_dd'] + t['p13_dd']
        coeffs = self._work_cheb.coeffs(pk1.expand(batch, -1))

        def pk_1loop(kq):
            return self._work_cheb.evaluate(coeffs, torch.clamp(kq, self.k_work[0], self.k_work[-1]))
        return pk_1loop

    def calculate(self, b1=2., b2=0., bs2=0., sigmav=0., snB=0., **kw):
        tmpl = self.template
        b1, b2, bs2, sigmav, snB = (_c3(v) for v in (b1, b2, bs2, sigmav, snB))
        batch = b1.shape[0]
        f = _c3(tmpl.f)
        qpar, qper = _c3(getattr(tmpl, 'qpar', 1.)), _c3(getattr(tmpl, 'qper', 1.))
        qpar5, qper5 = (q[:, None] if isinstance(q, torch.Tensor) else q for q in (qpar, qper))  # against (B, 3, ...)
        pk_fn = self._pk_evaluator(batch)
        ks, kpar, mu_pairs = self.const('_ks'), self.const('_kpar'), self.const('_mu_pairs')
        # AP: wavevectors transform by diag(1/qper, 1/qper, 1/qpar): the true sides, LOS cosines and pair
        # cosines of each orientation follow exactly from the observed ones; (B, 3, ntri, ntheta, nphi)
        kt = torch.sqrt((ks ** 2 - kpar ** 2) / qper5 ** 2 + kpar ** 2 / qpar5 ** 2).expand((batch,) + ks.shape)
        mut = kpar / qpar5 / kt
        pkt = pk_fn(kt.reshape(batch, -1)).reshape(kt.shape)

        def mu_pair_true(i, j, pair):
            dot = (ks[i] * ks[j] * mu_pairs[pair] - kpar[i] * kpar[j]) / qper ** 2 + kpar[i] * kpar[j] / qpar ** 2
            return dot / (kt[:, i] * kt[:, j])

        def Z1(mu):
            return b1 + f * mu ** 2

        def term(i, j, pair):
            Z2 = self._Z2(kt[:, i], kt[:, j], mu_pair_true(i, j, pair), mut[:, i], mut[:, j], f, b1, b2, bs2)
            return 2. * Z2 * Z1(mut[:, i]) * Z1(mut[:, j]) * pkt[:, i] * pkt[:, j]

        B = term(0, 1, 0) + term(0, 2, 1) + term(1, 2, 2)
        # finger-of-god damping on the true k_par
        B = B * torch.exp(-0.5 * sigmav ** 2 * ((kpar / qpar5) ** 2).sum(1))
        B = B + snB / self.nd * pkt.sum(1)
        B = B / (qpar * qper ** 2) ** 2                 # the volume dilation
        self.bispectrum = torch.einsum('btij,ltij->blt', B, self.const('_legs'))

    def get(self):
        return self.bispectrum
