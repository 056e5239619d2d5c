"""Tracer power-spectrum multipoles observable.

Counterpart of ``desilike_tpu/observables/power_spectrum.py``: windowed
theory P_l(k) against a flat data vector, which is measured (arrays, an
``ObservableArray``, or pypower-style files and objects, read by
:mod:`~..interop`) or generated from the theory itself (``data={...}``, a
host-side float64 evaluation). A covariance may come with it: a matrix, mock
vectors or mock files (then the likelihood applies the Hartlap and Percival
factors), or an ``ObservableCovariance``. ``plot`` draws data and theory
(matplotlib, imported there).
"""

import numpy as np

from ..core import Calculator, Pipeline
from ..utils import is_sequence
from .window import WindowedPowerSpectrumMultipoles


def _flat_covariance(covariance):
    """(mocks, covariance): a list of mock vectors gives them and their
    sample covariance; a matrix gives no mocks."""
    if isinstance(covariance, (list, tuple)) and len(covariance) and np.ndim(covariance[0]) >= 1 \
            and not isinstance(covariance[0], (int, float)):
        mocks = [np.ravel(np.asarray(m, dtype='f8')) for m in covariance]
        return mocks, np.cov(np.array(mocks), rowvar=False, ddof=1)
    if covariance is not None:
        return None, np.atleast_2d(np.asarray(covariance, dtype='f8'))
    return None, None


def _split(flat, grids):
    out, start = [], 0
    for grid in grids:
        out.append(flat[start:start + len(grid)])
        start += len(grid)
    return out


class TracerPowerSpectrumMultipolesObservable(Calculator):
    """Observable: windowed theory P_l(k) vs flat data vector.

    Parameters
    ----------
    data : dict, array, list of arrays, ObservableArray, path(s), None
        dict -> generate data from theory at these parameter values;
        array (nell, nk) or flat -> measured multipoles; an ObservableArray
        (its x and projections set k and ells); paths (glob patterns too),
        pypower-style objects or state dicts -> measured multipoles (their
        mean if several) with their shot noise, selected by ``klim``;
        None -> no data.
    covariance : array, list of arrays or of paths (mocks), ObservableCovariance, optional
        Covariance matrix, or mock data vectors or files (their sample
        covariance; the likelihood applies the Hartlap and Percival factors).
    klim : dict ell -> (kmin, kmax, kstep)
    k, ells, wmatrix, kin, kinrebin, ellsin, kinlim, shotnoise, theory,
    fiber_collisions, systematic_templates : see WindowedPowerSpectrumMultipoles
    transform : None or 'cubic'
        'cubic': the Gaussianization of Wang et al. 2023 (arXiv:2302.07484,
        eq. 16), the theory compared as (3 (T / D)^(1/3) - 2) D. It makes the
        residual nonlinear in every parameter, so the likelihood solves the
        parameters of this observable by its linearize path.
    """

    _state_attrs = ['flattheory']

    @staticmethod
    def _is_external(obj):
        """Measured-data formats: paths (incl. glob patterns), pypower-style
        objects, state dicts (see interop.read_power_multipoles)."""
        from ..interop import is_path
        if is_path(obj):
            return True
        if isinstance(obj, dict):
            return 'power' in obj or 'power_nonorm' in obj
        return not isinstance(obj, (int, float, np.ndarray)) and hasattr(obj, 'power') and hasattr(obj, 'ells')

    def initialize(self, data=None, covariance=None, klim=None, k=None, ells=None, wmatrix=None, kinlim=None, kin=None,
                   kinrebin=None, ellsin=None, shotnoise=None, theory=None, fiber_collisions=None,
                   systematic_templates=None, transform=None):
        if transform not in (None, 'cubic'):
            raise ValueError("transform must be None or 'cubic' (got {!r})".format(transform))
        self.transform = transform
        from ..interop import load_power_spectrum_data
        from .types import ObservableArray, ObservableCovariance

        self._nobs_input = None
        if isinstance(covariance, ObservableCovariance):
            self._nobs_input = covariance.nobs
            covariance = covariance.value
        if isinstance(data, ObservableArray):
            k, ells, klim = list(data.x), tuple(data.projs), None
            data = data.flatvalue
        loaded_data = None
        klim_select = klim  # the selection applied to every external input
        if data is not None and (self._is_external(data) or
                                 (is_sequence(data) and len(data) and self._is_external(data[0]))):
            loaded_data = load_power_spectrum_data(data, klim=klim_select)
            k, ells, klim = loaded_data['k'], loaded_data['ells'], None
            if shotnoise is None:
                shotnoise = loaded_data['shotnoise']
            data = loaded_data['flatdata']
        if covariance is not None and is_sequence(covariance) and len(covariance) and self._is_external(covariance[0]):
            loaded_mocks = load_power_spectrum_data(list(covariance), klim=klim_select)
            if loaded_data is None:
                k, ells, klim = loaded_mocks['k'], loaded_mocks['ells'], None
            if shotnoise is None:
                shotnoise = loaded_mocks['shotnoise']
            covariance = loaded_mocks['list_y']
        self.wmatrix = WindowedPowerSpectrumMultipoles(
            klim=klim, k=k, ells=ells, wmatrix=wmatrix, kinlim=kinlim, kin=kin, kinrebin=kinrebin, ellsin=ellsin,
            shotnoise=float(shotnoise or 0.), theory=theory, fiber_collisions=fiber_collisions,
            systematic_templates=systematic_templates)
        self.wmatrix.runtime_info.initialize()
        self.mocks, self._covariance_input = _flat_covariance(covariance)
        self._load_data(data)

    def _load_data(self, data):
        if data is None:
            self.flatdata = None
        elif isinstance(data, dict):
            # self-generated mock: evaluate own sub-pipeline at the given params
            self.flatdata = Pipeline(self.wmatrix).host_evaluate(data)[0].numpy()
        else:
            self.flatdata = np.ravel(np.asarray(data, dtype='f8'))
            nexp = sum(len(kk) for kk in self.wmatrix.k)
            if self.flatdata.size != nexp:
                raise ValueError('data size {} != expected {}'.format(self.flatdata.size, nexp))

    @property
    def k(self):
        return self.wmatrix.k

    @property
    def kedges(self):
        return self.wmatrix.kedges

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
        """Data multipoles, a list of (nk_ell,) arrays."""
        return _split(self.flatdata, self.k)

    def to_array(self):
        """Data vector as an ObservableArray (projections = multipoles)."""
        from .types import ObservableArray
        value = self.data if self.flatdata is not None else None
        return ObservableArray(x=self.k, value=value, projs=list(self.ells), name=getattr(self, 'name', '') or 'power')

    @property
    def footprint(self):
        raise AttributeError('no footprint attached; pass footprints to ObservablesCovarianceMatrix')

    def calculate(self, **params):
        self.flattheory = self.wmatrix.flatpower
        if self.transform == 'cubic':
            data = self.const('flatdata')
            self.flattheory = (3. * (self.flattheory / data) ** (1. / 3.) - 2.) * data

    @property
    def flatdiff(self):
        return self.flattheory - self.const('flatdata')

    def get(self):
        return self.flattheory

    def plot(self, fn=None, show=False):
        """Plot data vs theory multipoles with residuals; the theory is the
        first chain of the last evaluation (the parameters' values on the
        host, if there was none)."""
        from matplotlib import pyplot as plt
        fig, lax = plt.subplots(2, sharex=True, figsize=(6, 6), gridspec_kw={'height_ratios': [3, 1]})
        flattheory, start = _theory_row(self), 0
        for ill, kk in enumerate(self.k):
            th = flattheory[start:start + len(kk)]
            dat = self.data[ill] if self.flatdata is not None else None
            std = None
            if self._covariance_input is not None:
                std = np.sqrt(np.diag(self._covariance_input))[start:start + len(kk)]
            color = 'C{:d}'.format(ill)
            lax[0].plot(kk, kk * th, color=color, label=r'$\ell={:d}$'.format(self.ells[ill]))
            if dat is not None:
                if std is not None:
                    lax[0].errorbar(kk, kk * dat, kk * std, color=color, linestyle='none', marker='.')
                    lax[1].plot(kk, (dat - th) / std, color=color)
                else:
                    lax[0].plot(kk, kk * dat, color=color, linestyle='none', marker='.')
            start += len(kk)
        lax[0].legend()
        lax[0].set_ylabel(r'$k P_\ell(k)$ [$(\mathrm{Mpc}/h)^2$]')
        lax[1].set_xlabel(r'$k$ [$h/\mathrm{Mpc}$]')
        lax[1].set_ylabel(r'$\Delta P_\ell / \sigma$')
        if fn:
            fig.savefig(fn, bbox_inches='tight')
        if show:
            plt.show()
        return fig


def _theory_row(observable):
    """The observable's flat theory as a host vector: the first chain of its
    last evaluation, else one host evaluation at the parameters' values."""
    theory = getattr(observable, 'flattheory', None)
    if theory is None:
        Pipeline(observable).host_evaluate()
        theory = observable.flattheory
    theory = theory.detach().cpu().numpy() if hasattr(theory, 'detach') else np.asarray(theory)
    return theory.reshape(-1, theory.shape[-1])[0].astype('f8')
