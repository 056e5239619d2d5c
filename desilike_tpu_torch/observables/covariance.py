"""Footprints and analytic Gaussian covariance of multipole observables.

Counterpart of ``desilike_tpu/observables/covariance.py``: host-side
float64 numpy, assembled once at initialization, for the pk-pk, xi-xi and
pk-xi blocks; box and cut-sky footprints (the latter's volume from the
port's own background cosmology, on the host in float64).
"""

import numpy as np
import torch
from scipy import special

from ..utils import BaseClass, is_sequence
from ..ops.legendre import trapz_weights
from ..cosmology import background as bg


def integral_legendre_product(ells, range=(-1, 1), norm=False):
    """Integral over ``range`` of a product of Legendre polynomials (divided
    by the range's length if ``norm``)."""
    poly = special.legendre(0)
    if np.ndim(ells) == 0:
        ells = [ells]
    for ell in ells:
        poly *= special.legendre(ell)
    integ = poly.integ()
    out = integ(range[-1]) - integ(range[0])
    if norm:
        out /= (range[-1] - range[0])
    return float(out)


class BaseFootprint(BaseClass):
    """3D footprint: density and volume."""

    def __init__(self, nbar=None, size=None, volume=None, attrs=None):
        if nbar is None and size is None:
            raise ValueError('provide "nbar" [(h/Mpc)^3] or "size" (number of objects)')
        if volume is None:
            raise ValueError('provide volume [(Mpc/h)^3]')
        self._volume = np.asarray(volume, dtype='f8')
        self._size = None if size is None else np.asarray(size, dtype='f8')
        self._nbar = (self._size / self._volume) if nbar is None else np.asarray(nbar, dtype='f8')
        self.attrs = dict(attrs or {})

    @property
    def volume(self):
        return self._volume

    @property
    def size(self):
        return self._size if self._size is not None else self._nbar * self._volume

    @property
    def nbar(self):
        return self._nbar

    @property
    def shotnoise(self):
        return self.volume / self.size

    def __and__(self, other):
        return BaseFootprint(nbar=self._nbar + other._nbar,
                             volume=min(float(self.volume), float(other.volume)))


class BoxFootprint(BaseFootprint):
    """Cubic box footprint."""


class CutskyFootprint(BaseFootprint):
    """Sky-area + redshift-range footprint: the volume of the comoving shell
    of the fiducial cosmology (``cosmo``: a dict of parameters, default the
    DESI fiducial), and the density of an nbar(z) profile (one value a
    redshift bin of ``zrange``, or a constant over it); ``zeff`` weighs the
    bins' centres by nbar^2 times their volume."""

    def __init__(self, area=None, zrange=None, nbar=None, cosmo=None, attrs=None):
        if area is None or zrange is None:
            raise ValueError('provide area [deg^2] and zrange')
        p = bg.resolve(cosmo if isinstance(cosmo, dict) else None)
        zrange = np.asarray(zrange, dtype='f8')
        fsky = float(area) * (np.pi / 180.) ** 2 / (4. * np.pi)
        if np.ndim(nbar) == 0:
            zedges = np.array([zrange.min(), zrange.max()])
            nbarz = np.array([float(nbar)])
        else:
            zedges = zrange
            nbarz = np.asarray(nbar, dtype='f8')
        dc = np.asarray(bg.comoving_radial_distance(p, zedges), dtype='f8')
        shell = 4. / 3. * np.pi * (dc[1:] ** 3 - dc[:-1] ** 3) * fsky
        zmid = (zedges[1:] + zedges[:-1]) / 2.
        self.zeff = float((nbarz ** 2 * shell * zmid).sum() / (nbarz ** 2 * shell).sum())
        self.area = float(area)
        super().__init__(size=(nbarz * shell).sum(), volume=shell.sum(), attrs=attrs)


class ObservablesCovarianceMatrix(BaseClass):
    """Analytic Gaussian covariance for power-spectrum and correlation-function
    multipole observables: evaluate the observables' theories at given
    parameters (host float64), then assemble per-bin covariances from the
    pk multipoles (the pk node under a xi-from-pk theory)."""

    def __init__(self, observables, footprints=None, theories=None, resolution=3):
        if not is_sequence(observables):
            observables = [observables]
        self.observables = list(observables)
        if not is_sequence(footprints):
            footprints = [footprints] * len(self.observables)
        self.footprints = list(footprints)
        if not is_sequence(theories):
            theories = [theories] * len(self.observables)
        self.theories = list(theories)
        self.resolution = int(resolution)

    def __call__(self, **params):
        self.run(**params)
        return self.covariance

    def run(self, **params):
        from ..core import Pipeline
        for io, obs in enumerate(self.observables):
            obs.runtime_info.initialize()
            pipe = Pipeline(obs)
            pipe.host_evaluate(params)
            if self.theories[io] is None:
                # last calculator exposing (k, power tensor): the pk multipoles node, also under
                # a xi-from-pk theory (whose ``power`` is that node)
                theory = None
                for calc in pipe.calculators[::-1]:
                    power = getattr(calc, 'power', None)
                    if hasattr(calc, 'k') and isinstance(power, torch.Tensor) and np.ndim(calc.k) == 1:
                        theory = calc
                        break
                if theory is None:
                    raise ValueError('no pk theory found for observable {}'.format(obs))
                self.theories[io] = theory
        blocks = [[None] * len(self.observables) for _ in self.observables]
        for io1 in range(len(self.observables)):
            for io2 in range(io1, len(self.observables)):
                c = self._run(io1, io2)
                blocks[io1][io2] = c
                blocks[io2][io1] = (c + c.T) / 2. if io1 == io2 else c.T
        self.covariance = np.block(blocks)
        return self.covariance

    @staticmethod
    def _obs_kind(obs):
        return 'xi' if hasattr(obs.wmatrix, 'sedges') else 'pk'

    @staticmethod
    def _obs_size(obs):
        grids = obs.wmatrix.s if hasattr(obs.wmatrix, 'sedges') else obs.wmatrix.k
        return sum(len(g) for g in grids)

    def _run(self, io1, io2):
        obs1, obs2 = self.observables[io1], self.observables[io2]
        fp1, fp2 = self.footprints[io1], self.footprints[io2]
        if io1 != io2 and (fp1 is not fp2):
            # different tracers: no cross-covariance
            return np.zeros((self._obs_size(obs1), self._obs_size(obs2)))
        kinds = (self._obs_kind(obs1), self._obs_kind(obs2))
        if kinds == ('xi', 'pk'):
            return self._run_cross(io2, io1).T
        if kinds == ('pk', 'xi'):
            return self._run_cross(io1, io2)
        if kinds == ('xi', 'xi'):
            return self._run_xi(io1, io2)
        sigma_k = self._sigma_k_fn(io1, io2)
        cov_rows = []
        for ill1, ell1 in enumerate(obs1.wmatrix.ells):
            row_blocks = []
            edges1 = obs1.wmatrix.kedges[ill1]
            for ill2, ell2 in enumerate(obs2.wmatrix.ells):
                edges2 = obs2.wmatrix.kedges[ill2]
                block = np.zeros((len(edges1), len(edges2)))
                for i1, (lo1, hi1) in enumerate(edges1):
                    for i2, (lo2, hi2) in enumerate(edges2):
                        lo, hi = max(lo1, lo2), min(hi1, hi2)
                        if lo >= hi:
                            continue
                        kq = np.linspace(lo, hi, self.resolution + 2)[1:-1]
                        block[i1, i2] = (2. * np.pi) ** 3 * _bin_volume(lo, hi) \
                            / (_bin_volume(lo1, hi1) * _bin_volume(lo2, hi2)) \
                            * np.sum(kq ** 2 * sigma_k(ell1, ell2, kq)) / np.sum(kq ** 2)
                row_blocks.append(block)
            cov_rows.append(row_blocks)
        return np.block(cov_rows)

    def _sigma_k_fn(self, io1, io2, remove_zero_lag=False):
        """sigma_k(ell1, ell2, k): the Gaussian covariance of the pk
        multipoles (shot noise included) of observables io1 and io2 per unit
        k-space volume, from their pk theories at the evaluated parameters;
        without the zero-lag shot-noise product if ``remove_zero_lag``."""
        fp1, fp2 = self.footprints[io1], self.footprints[io2]
        volume = float((fp1 & fp2).volume)

        def make_pk(theory, footprint):
            k = np.asarray(theory.k)
            power = theory.power.detach().cpu().numpy().reshape(-1, len(theory.ells), len(k))[0]
            ells = tuple(theory.ells)
            sn = float(footprint.shotnoise)

            def pk(kq, ell):
                return np.interp(kq, k, power[ells.index(ell)] + (ell == 0) * sn)
            pk.ells = ells
            pk.shotnoise = sn
            return pk

        pk1, pk2 = make_pk(self.theories[io1], fp1), make_pk(self.theories[io2], fp2)

        def sigma_k(ell1, ell2, kq):
            pref = (2 * ell1 + 1) * (2 * ell2 + 1) / volume
            out = 0.
            for la in pk1.ells:
                for lb in pk2.ells:
                    zero_lag = remove_zero_lag * (la == 0) * (lb == 0) * pk1.shotnoise * pk2.shotnoise
                    out += (pk1(kq, la) * pk2(kq, lb) - zero_lag) * integral_legendre_product((la, lb, ell1, ell2))
            return pref * out
        sigma_k.shotnoises = (pk1.shotnoise, pk2.shotnoise)
        sigma_k.volume = volume
        return sigma_k

    def _run_xi(self, io1, io2):
        """xi-xi Gaussian covariance:
        C = Re(i^(l1+l2)) / (2 pi^2) int k^2 dk sigma_k(k) w_l1(k) w_l2(k)
        with w_l the bin-averaged spherical Bessel weights, plus the
        bin-overlap shot-noise term."""
        obs1, obs2 = self.observables[io1], self.observables[io2]
        sigma_k = self._sigma_k_fn(io1, io2, remove_zero_lag=True)
        k1 = np.asarray(self.theories[io1].k)
        k2 = np.asarray(self.theories[io2].k)
        kq = k1[(k1 >= max(k1.min(), k2.min())) & (k1 <= min(k1.max(), k2.max()))]
        wk = trapz_weights(kq)

        def bessel_weight(ell, lo, hi):
            s = np.linspace(lo, hi, self.resolution + 2)[1:-1]
            return np.sum(s[:, None] ** 2 * special.spherical_jn(ell, s[:, None] * kq), axis=0) / np.sum(s ** 2)

        cov_rows = []
        for ill1, ell1 in enumerate(obs1.wmatrix.ells):
            row = []
            edges1 = obs1.wmatrix.sedges[ill1]
            for ill2, ell2 in enumerate(obs2.wmatrix.ells):
                edges2 = obs2.wmatrix.sedges[ill2]
                sig = sigma_k(ell1, ell2, kq)
                sign = np.sign(np.real(1j ** (ell1 + ell2)))
                w2 = np.array([bessel_weight(ell2, lo, hi) for (lo, hi) in edges2])
                w1 = np.array([bessel_weight(ell1, lo, hi) for (lo, hi) in edges1])
                block = sign / (2. * np.pi ** 2) * np.einsum('ak,bk,k->ab', w1, w2, kq ** 2 * wk * sig)
                # shot-noise contribution on overlapping bins
                sn_amp = (integral_legendre_product((0, 0, ell1, ell2))
                          * sigma_k.shotnoises[0] * sigma_k.shotnoises[1]
                          * (2 * ell1 + 1) * (2 * ell2 + 1) / sigma_k.volume)
                for i1, (lo1, hi1) in enumerate(edges1):
                    for i2, (lo2, hi2) in enumerate(edges2):
                        lo, hi = max(lo1, lo2), min(hi1, hi2)
                        if lo < hi:
                            block[i1, i2] += sign * _bin_volume(lo, hi) / (
                                _bin_volume(lo1, hi1) * _bin_volume(lo2, hi2)) * sn_amp
                row.append(block)
            cov_rows.append(row)
        return np.block(cov_rows)

    def _run_cross(self, io_pk, io_xi):
        """pk-xi cross covariance."""
        obs_pk, obs_xi = self.observables[io_pk], self.observables[io_xi]
        sigma_k = self._sigma_k_fn(io_pk, io_xi)

        def get_integ_points(lo, hi):
            return np.linspace(lo, hi, self.resolution + 2)[1:-1]

        cov_rows = []
        for ill1, ell1 in enumerate(obs_pk.wmatrix.ells):
            row = []
            edges_k = obs_pk.wmatrix.kedges[ill1]
            for ill2, ell2 in enumerate(obs_xi.wmatrix.ells):
                edges_s = obs_xi.wmatrix.sedges[ill2]
                block = np.zeros((len(edges_k), len(edges_s)))
                for i1, (klo, khi) in enumerate(edges_k):
                    kq = get_integ_points(klo, khi)
                    sig = sigma_k(ell1, ell2, kq)
                    for i2, (slo, shi) in enumerate(edges_s):
                        s = get_integ_points(slo, shi)
                        w = np.sum(s[:, None] ** 2 * special.spherical_jn(ell2, s[:, None] * kq), axis=0) / np.sum(s ** 2)
                        block[i1, i2] = np.sign(np.real(1j ** ell2)) * np.sum(kq ** 2 * sig * w) / np.sum(kq ** 2)
                row.append(block)
            cov_rows.append(row)
        return np.block(cov_rows)


def _bin_volume(lo, hi):
    return 4. / 3. * np.pi * (hi ** 3 - lo ** 3)
