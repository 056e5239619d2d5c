"""Compressed (Gaussian) Planck 2018 likelihood on cosmological parameters.

Counterpart of ``desilike_tpu/likelihoods/cmb/planck2018_gaussian.py``: a
Gaussian in derived cosmological quantities (mean and covariance from the
published getdist products, whose readers are numpy copies of the JAX
package's), each a (B,) quantity of the ``Cosmology`` node per chain
(h, omega_*, rs_drag, theta_star_100, ...).

Accuracy note: derived quantities computed by the EH98-class backend carry
its approximations — 100*theta_star is ~0.2% low vs CLASS at Planck
parameters (sound speed / z_star fitting-formula level). For unbiased
production constraints on theta-like quantities, fit in (omega_b, omega_cdm,
H0, logA, n_s, tau_reio) where the backend is exact, or inject corrections
via ``offsets``.
"""

import os

import numpy as np
import torch

from ...install import installed_data_dir
from ..base import BaseGaussianLikelihood
from ..external import stack
from ...theories.cosmology import Cosmology, TNCDM_NEFF
from ...cosmology import background as bg


# getdist name -> framework name (public Planck chain conventions,
# reference planck2018_gaussian.py:10)
convert_planck2018_params = {
    'omegabh2': 'omega_b', 'omegach2': 'omega_cdm', 'omegak': 'Omega_k',
    'w': 'w0_fde', 'wa': 'wa_fde', 'theta': 'theta_star_100', 'tau': 'tau_reio',
    'mnu': 'm_ncdm', 'logA': 'logA', 'ns': 'n_s', 'nrun': 'alpha_s',
    'H0': 'H0', 'omegam': 'Omega_m', 'omegal': 'Omega_Lambda',
    'rdrag': 'rs_drag_mpc', 'zdrag': 'z_drag', 'sigma8': 'sigma8',
}


def read_getdist_covmat(fn):
    """Read a getdist .covmat: '# name1 name2 ...' header + matrix rows.
    Returns (names, cov)."""
    with open(fn) as f:
        header = f.readline()
    names = header.lstrip('#').split()
    cov = np.loadtxt(fn, skiprows=1)
    return names, np.atleast_2d(cov)


def read_getdist_margestats(fn):
    """Read a getdist .margestats: returns {name: (mean, sddev)}."""
    stats = {}
    with open(fn) as f:
        started = False
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            parts = line.split()
            if parts[0] == 'parameter':
                started = True
                continue
            if not started:
                continue
            try:
                mean, std = float(parts[1]), float(parts[2])
            except (IndexError, ValueError):
                continue
            stats[parts[0].rstrip('*')] = (mean, std)
    return stats


class BasePlanck2018GaussianLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood on derived cosmological quantities.

    Parameters
    ----------
    cosmo : Cosmology, default=None
    quantities : list of str
        Framework-side quantity names: any of omega_b, omega_cdm, h, H0,
        logA, A_s, n_s, tau_reio, m_ncdm, Omega_k, w0_fde, wa_fde, Omega_m,
        rs_drag (Mpc/h), rs_drag_mpc, theta_star_100, sigma8, N_eff.
    mean, covariance : arrays
        Explicit data vector/covariance, OR
    dist_fn : str
        getdist basename (reads dist_fn + '.covmat' / '.margestats' and
        converts getdist parameter names; reference
        planck2018_gaussian.py:179-190).
    offsets : dict, default=None
        {quantity: additive correction to the theory} — inject e.g. the
        CLASS-vs-EH98 theta offset at the fiducial point.
    """

    name = 'BasePlanck2018Gaussian'

    def initialize(self, cosmo=None, quantities=None, mean=None, covariance=None,
                   dist_fn=None, offsets=None, **kwargs):
        self.cosmo = cosmo if cosmo is not None else Cosmology(fixed=False)
        if dist_fn is not None:
            names, cov = read_getdist_covmat(dist_fn + '.covmat')
            stats = read_getdist_margestats(dist_fn + '.margestats')
            if quantities is None:
                keep = [n for n in names if n in convert_planck2018_params and n in stats]
            else:
                back = {v: k for k, v in convert_planck2018_params.items()}
                keep = [back[q] for q in quantities]
            idx = [names.index(n) for n in keep]
            covariance = cov[np.ix_(idx, idx)]
            mean = [stats[n][0] for n in keep]
            quantities = [convert_planck2018_params[n] for n in keep]
        if quantities is None or mean is None or covariance is None:
            raise ValueError('provide (quantities, mean, covariance) or dist_fn')
        self.quantities = list(quantities)
        self.offsets = dict(offsets or {})
        super().initialize(data=np.asarray(mean, dtype='f8'),
                           covariance=np.asarray(covariance, dtype='f8'))

    def _quantity(self, q):
        cosmo = self.cosmo
        p = cosmo.p
        if q in p:
            return p[q]
        if q == 'h':
            return p['h']
        if q == 'H0':
            return 100. * p['h']
        if q == 'logA':
            return torch.log(1e10 * torch.as_tensor(p['A_s']))
        if q == 'Omega_m':
            return bg.Omega_m(p)
        if q == 'Omega_Lambda':
            return bg.Omega_de(p)
        if q == 'rs_drag':
            return cosmo.rs_drag()
        if q == 'rs_drag_mpc':
            return cosmo.rs_drag() / p['h']
        if q == 'theta_star_100':
            return bg.theta_star_100(p)
        if q == 'z_star':
            return bg.z_star(p)
        if q == 'sigma8':
            return cosmo.sigma8()
        if q == 'N_eff':
            return p['N_ur'] + p.get('N_ncdm', 1) * TNCDM_NEFF
        raise ValueError('unknown derived quantity {}'.format(q))

    def flattheory(self):
        return stack([self._quantity(q) + self.offsets.get(q, 0.) for q in self.quantities], bg.ref(self.cosmo.p))


class Planck2018GaussianLikelihood(BasePlanck2018GaussianLikelihood):
    """Built-in compressed base-LCDM Planck 2018 TTTEEE+lowE+lensing
    constraint using the published marginal means/sigmas and marginal
    correlation structure of (omega_b, omega_cdm, n_s, logA, tau_reio, H0)
    (Planck 2018 VI, arXiv:1807.06209, Table 2; correlations from the public
    base_plikHM_TTTEEE_lowl_lowE_lensing products).

    theta_MC is deliberately excluded from the default set (EH98-backend
    accuracy note above); use dist_fn= with the published covmat to change
    the parameterization.
    """

    name = 'Planck2018Gaussian'
    quantities_default = ('omega_b', 'omega_cdm', 'n_s', 'logA', 'tau_reio', 'H0')
    mean_default = (0.02237, 0.1200, 0.9649, 3.044, 0.0544, 67.36)
    sigma_default = (0.00015, 0.0012, 0.0042, 0.014, 0.0073, 0.54)
    # marginal correlation matrix (public chains, rounded; the dominant
    # structure is the (logA, tau) degeneracy and the omega_cdm-H0
    # anticorrelation)
    corr_default = (
        (1.00, -0.53, 0.47, 0.02, 0.09, 0.55),
        (-0.53, 1.00, -0.76, 0.02, -0.04, -0.87),
        (0.47, -0.76, 1.00, 0.04, 0.07, 0.77),
        (0.02, 0.02, 0.04, 1.00, 0.95, 0.03),
        (0.09, -0.04, 0.07, 0.95, 1.00, 0.09),
        (0.55, -0.87, 0.77, 0.03, 0.09, 1.00),
    )

    def initialize(self, cosmo=None, **kwargs):
        sig = np.asarray(self.sigma_default)
        corr = np.asarray(self.corr_default)
        corr = (corr + corr.T) / 2.
        cov = corr * np.outer(sig, sig)
        super().initialize(cosmo=cosmo, quantities=list(self.quantities_default),
                           mean=np.asarray(self.mean_default), covariance=cov, **kwargs)


def planck2018_base_fn(basename, data_dir=None):
    """Resolve the Planck-2018 full-grid directory layout
    ``<data_dir>/<model>/plikHM_<obs>/[dist/]<basename>`` for a chain
    basename like 'base_mnu_plikHM_TTTEEE_lowl_lowE_lensing'; returns
    (chain_fn, dist_fn) prefixes (reference planck2018_gaussian.py:20-43).
    With ``data_dir=None`` the installer sections
    FullGridPlanck2018GaussianLikelihood, then BasePlanck2018GaussianLikelihood
    for a base_plik* chain, are tried in that order."""
    if data_dir is None:
        data_dir = installed_data_dir('FullGridPlanck2018GaussianLikelihood')
        if data_dir is None and basename.startswith('base_plik'):
            data_dir = installed_data_dir('BasePlanck2018GaussianLikelihood')
        if data_dir is None:
            raise ValueError('no data_dir= given and no installed Planck 2018 grid found (see '
                             'desilike_tpu_torch.install)')
    try:
        base_dir, obs_dir = basename.split('_plikHM_')
    except ValueError as exc:
        raise ValueError('basename {0} is expected to contain "_plikHM_"; maybe '
                         'you forgot the model name in front, e.g. base_{0}?'
                         .format(basename)) from exc
    run_dir = os.path.join(data_dir, base_dir, 'plikHM_' + obs_dir)
    return (os.path.join(run_dir, basename),
            os.path.join(run_dir, 'dist', basename))


def read_getdist_chains(chain_fn):
    """Read getdist-format chain text files ``<chain_fn>_<i>.txt`` (columns:
    weight, -lnpost, params...) with names from ``<chain_fn>.paramnames``;
    returns (names, samples (nsamples, nparams), weights, logposterior).
    Names keep getdist's trailing ``*`` derived-parameter marker so callers
    can tell sampled from derived columns; logposterior is the negated
    second column (chain files are parsed exactly once)."""
    import glob
    names = []
    with open(chain_fn + '.paramnames') as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if parts:
                names.append(parts[0])
    fns = sorted(glob.glob(chain_fn + '_*.txt')) or ([chain_fn + '.txt']
                 if os.path.exists(chain_fn + '.txt') else [])
    if not fns:
        raise IOError('no chain files matching {}_*.txt'.format(chain_fn))
    blocks = [np.atleast_2d(np.loadtxt(fn)) for fn in fns]
    arr = np.concatenate(blocks, axis=0)
    return names, arr[:, 2:2 + len(names)], arr[:, 0], -arr[:, 1]


def read_planck2018_chain(basename='base_plikHM_TTTEEE_lowl_lowE_lensing',
                          data_dir=None, weights=None, params=None):
    """Read a full-grid Planck 2018 chain into a :class:`Chain` with
    framework parameter names (reference planck2018_gaussian.py:46):
    getdist columns are renamed through ``convert_planck2018_params``
    (unknown columns keep their getdist names), the getdist weight column
    becomes 'aweight' and -lnpost becomes 'logposterior'. ``weights`` is an
    optional callable on the Chain returning extra importance weights;
    ``params`` selects/orders the returned columns (framework names).

    The returned Chain records which columns were sampled (no getdist ``*``
    derived marker) in ``chain.attrs['sampled_params']``."""
    from ...samples.chain import Chain
    if weights is not None and weights != 'cmb_only' and not callable(weights):
        raise ValueError("weights must be a callable on the Chain or 'cmb_only', "
                         'got {!r}'.format(weights))
    chain_fn, _ = planck2018_base_fn(basename, data_dir=data_dir)
    names, samples, w, lnpost = read_getdist_chains(chain_fn)
    chain = Chain()
    sampled = []
    for i, n in enumerate(names):
        derived = n.endswith('*')
        fname = convert_planck2018_params.get(n.rstrip('*'), n.rstrip('*'))
        chain[fname] = samples[:, i]
        if not derived:
            sampled.append(fname)
    chain['aweight'] = np.asarray(w, dtype='f8')
    chain['logposterior'] = lnpost
    chain.attrs['sampled_params'] = sampled
    if weights == 'cmb_only':
        # importance-unweight the non-CMB datasets (reference
        # planck2018_gaussian.py:59-63 and :83): the log-weight is the
        # non-CMB half-chi2, lw = logposterior + (chi2_prior + chi2_CMB)/2;
        # its mean is removed BEFORE exponentiating so grid chains with
        # large non-CMB chi2 (SN compilations, chi2 ~ 1e3) cannot overflow.
        def weights(chain):
            lw = (np.asarray(chain['logposterior'])
                  + 0.5 * np.asarray(chain['chi2_prior'])
                  + 0.5 * np.asarray(chain['chi2_CMB']))
            return np.exp(-(lw - np.mean(lw)))
    if weights is not None:
        chain['aweight'] = chain['aweight'] * np.asarray(weights(chain), dtype='f8')
    if params is not None:
        keep = [getattr(p, 'name', p) for p in params]
        missing = [n for n in keep if n not in chain]
        if missing:
            raise ValueError('parameters {} not in chain (available: {})'.format(
                missing, chain.names()))
        sub = Chain()
        for n in keep + ['aweight', 'logposterior']:
            sub[n] = chain[n]
        return sub
    return chain


class FullGridPlanck2018GaussianLikelihood(BasePlanck2018GaussianLikelihood):
    """Gaussian approximation of ANY entry of the Planck-2018 full grid of
    chains (reference planck2018_gaussian.py:230): pick the run with
    ``basename`` (e.g. 'base_mnu_plikHM_TTTEEE_lowl_lowE_lensing'); the
    mean/covariance come from the published ``dist/`` summary products
    (``source='covmat'``, the default) or are computed from the chains
    themselves (``source='chains'``, optional ``weights=`` callable on the
    :class:`Chain` returning reweighting factors — or ``'cmb_only'``, the
    reference's importance unweighting of non-CMB datasets). Passing
    ``weights`` with ``source=None`` selects the chains source; combining
    ``weights`` with ``source='covmat'`` is an error (the dist/ products
    cannot be reweighted)."""

    name = 'FullGridPlanck2018Gaussian'

    def initialize(self, cosmo=None, basename='base_plikHM_TTTEEE_lowl_lowE_lensing',
                   data_dir=None, source=None, quantities=None, weights=None,
                   **kwargs):
        if source is None:
            source = 'chains' if weights is not None else 'covmat'
        chain_fn, dist_fn = planck2018_base_fn(basename, data_dir=data_dir)
        if source == 'covmat':
            if weights is not None:
                raise ValueError("weights= requires source='chains' (the "
                                 "published dist/ covmat cannot be reweighted)")
            super().initialize(cosmo=cosmo, dist_fn=dist_fn, quantities=quantities,
                               **kwargs)
            return
        if source != 'chains':
            raise ValueError("source must be 'covmat' or 'chains'")
        chain = read_planck2018_chain(basename, data_dir=data_dir, weights=weights)
        if quantities is None:
            # default to the SAMPLED parameters only: real grid chains carry
            # derived columns that are exact linear combinations of others
            # (Omega_m + Omega_Lambda = 1, H0 = 100 h, ...) which would make
            # the empirical covariance singular
            known = set(convert_planck2018_params.values())
            sampled = chain.attrs.get('sampled_params') or chain.names()
            quantities = [n for n in sampled if n in known]
        sub, _ = chain.points(list(quantities))
        w = chain.weight.reshape(-1)
        mean = np.average(sub, axis=0, weights=w)
        cov = np.atleast_2d(np.cov(sub.T, aweights=w, ddof=0))
        super().initialize(cosmo=cosmo, quantities=list(quantities),
                           mean=mean, covariance=cov, **kwargs)
