"""Cobaya binding generator and factory (counterpart of
``desilike_tpu/bindings/cobaya.py``).

When the wrapped pipeline holds an ``engine='external'`` Cosmology node,
the likelihood declares cobaya requirements (Hubble, distances, rdrag,
Pk_grid, fsigma8, sigma8_z) and injects the provider's products into the
node before each call."""

import numpy as np

from .base import BaseLikelihoodGenerator, regrid_pk, point_loglikelihood


def cobaya_requirements(like):
    """Map the pipeline's cosmo_requires onto cobaya requirement names
    (cobaya conventions: k in 1/Mpc, distances in Mpc)."""
    req = like.pipeline.get_cosmo_requires()
    if not req:
        return {}
    out = {}
    bgq = req.get('background', {})
    if 'efunc' in bgq:
        out['Hubble'] = {'z': np.unique(np.insert(np.asarray(bgq['efunc']['z'], dtype='f8'), 0, 0.))}
    if 'comoving_radial_distance' in bgq:
        out['comoving_radial_distance'] = {'z': np.asarray(bgq['comoving_radial_distance']['z'], dtype='f8')}
    if 'rs_drag' in req.get('thermodynamics', {}):
        out['rdrag'] = None
    fo = req.get('fourier', {})
    if 'pk_interpolator' in fo:
        attrs = fo['pk_interpolator']
        # the requirement's k_max is in 1/Mpc: k_h h <= k_h for h <= 1, so the h-unit maximum bounds it
        # (with a margin for h ~ 1)
        out['Pk_grid'] = {'z': np.asarray(attrs['z'], dtype='f8'), 'k_max': 1.2 * float(np.max(attrs['k'])),
                          'nonlinear': bool(attrs.get('non_linear', False)),
                          'vars_pairs': [('delta_tot', 'delta_tot')]}
    if 'fsigma8' in fo:
        out['fsigma8'] = {'z': np.asarray(fo['fsigma8']['z'], dtype='f8')}
    if 'sigma8_z' in fo:
        out['sigma8_z'] = {'z': np.asarray(fo['sigma8_z']['z'], dtype='f8')}
    return out


def gather_cobaya_products(provider, node):
    """The provider's products on the node's grids, converted from cobaya's
    conventions (Mpc, 1/Mpc, Mpc^3) to h-units."""
    z = np.asarray(node.z_grid, dtype='f8')
    H = np.asarray(provider.get_Hubble(z), dtype='f8')
    H0 = float(np.asarray(provider.get_Hubble(np.array([0.])))[0])
    h = H0 / 100.
    products = {'efunc_tab': H / H0,
                'chi_tab': np.asarray(provider.get_comoving_radial_distance(z), dtype='f8') * h,
                'rs_drag_tab': float(provider.get_param('rdrag')) * h,
                'fsigma8_tab': np.asarray(provider.get_fsigma8(z), dtype='f8'),
                'sigma8_tab': np.asarray(provider.get_sigma8_z(z), dtype='f8')}
    kmpc, zpk, pk = provider.get_Pk_grid(var_pair=('delta_tot', 'delta_tot'), nonlinear=False)
    products['pk_tab'] = regrid_pk(np.asarray(kmpc, dtype='f8') / h, zpk, np.log(np.asarray(pk, dtype='f8') * h ** 3),
                                   node.zpk_grid, node.k_grid)
    return products


def inject_from_cobaya(like, provider):
    """Inject the provider's current cosmology into every external node."""
    for _, node in like.pipeline.external_nodes():
        node.inject(**gather_cobaya_products(provider, node))


def desilike_to_cobaya_params(params):
    """Parameters as a cobaya 'params' info dict: uniform priors become {min,
    max}, norm priors {dist: norm, loc, scale}; reference distributions and
    proposals carry over. '.' in the names becomes '_' (cobaya names cannot
    hold dots)."""
    info = {}
    for p in params:
        entry = {'latex': p.latex}
        prior = p.prior
        if prior is not None:
            if prior.dist == 'uniform' and np.isfinite(prior.limits).all():
                entry['prior'] = {'min': prior.limits[0], 'max': prior.limits[1]}
            elif prior.dist == 'norm':
                entry['prior'] = {'dist': 'norm', 'loc': prior.loc, 'scale': prior.scale}
        ref = p.ref
        if ref is not None and ref.dist == 'norm':
            entry['ref'] = {'dist': 'norm', 'loc': ref.loc, 'scale': ref.scale}
        if p.proposal:
            entry['proposal'] = p.proposal
        info[p.name.replace('.', '_')] = entry
    return info


def CobayaLikelihoodFactory(factory, name_like=None, kw_like=None, module=None, params=None):
    """Build a cobaya ``Likelihood`` subclass at run time, the counterpart
    of :class:`CobayaLikelihoodGenerator`, which writes the same wrapper to a
    module file.

    Parameters
    ----------
    factory : callable
        Returns the desilike_tpu_torch likelihood.
    name_like : str, default=None
        Class name (the factory's ``__name__`` by default).
    kw_like : dict, default=None
        Keyword arguments passed to ``factory``.
    module : str, default=None
        The generated class's ``__module__`` (cobaya resolves likelihood
        classes by module path).
    params : bool, default=None
        If true, attach the converted cobaya 'params' block as the class's
        ``params``.
    """
    from cobaya.likelihood import Likelihood  # the host package, imported at call time
    kw_like = dict(kw_like or {})
    cache = {}

    def _get_like():
        if 'like' not in cache:
            like = factory(**kw_like)
            like._compiled_logpost = like.logpost_fn()
            cache['like'] = like
        return cache['like']

    def initialize(self):
        self._like = _get_like()
        self._name_map = {p.name.replace('.', '_'): p.name for p in self._like.pipeline.varied_params}

    def get_requirements(self):
        return cobaya_requirements(self._like)

    def logp(self, **params_values):
        values = {self._name_map[k]: v for k, v in params_values.items() if k in self._name_map}
        # cobaya applies the priors itself: the bare log-likelihood
        return point_loglikelihood(self._like, values, inject_from_cobaya, getattr(self, 'provider', None))

    d = {'initialize': initialize, 'get_requirements': get_requirements, 'logp': logp}
    if module is not None:
        d['__module__'] = module
    if params:
        d['params'] = desilike_to_cobaya_params(_get_like().pipeline.varied_params)
    name_like = name_like or getattr(factory, '__name__', 'DesilikeTPULikelihood')
    return type(name_like, (Likelihood,), d)


class CobayaLikelihoodGenerator(BaseLikelihoodGenerator):
    """Generates a cobaya Likelihood class module and its params info dict.

    The generated likelihood exposes the pipeline's varied parameters as
    cobaya-sampled parameters; it returns the log-likelihood without the
    priors, which cobaya applies.
    """

    def params_info(self):
        """Cobaya 'params' block for the varied parameters."""
        return desilike_to_cobaya_params(self.varied_params())

    def generate(self):
        params = self.varied_params()
        names = {p.name.replace('.', '_'): p.name for p in params}
        body = self.header()
        body += (
            '\nfrom cobaya.likelihood import Likelihood\n\n'
            '_NAME_MAP = {names!r}\n\n'
            'PARAMS_INFO = {params!r}\n\n\n'
            'class DesilikeTPULikelihood(Likelihood):\n'
            '    """desilike_tpu_torch likelihood wrapped for cobaya."""\n\n'
            '    params = PARAMS_INFO\n\n'
            '    def initialize(self):\n'
            '        self._like = _get_like()\n\n'
            '    def get_requirements(self):\n'
            '        # the host-cosmology products the external nodes consume\n'
            '        from desilike_tpu_torch.bindings.cobaya import cobaya_requirements\n'
            '        return cobaya_requirements(self._like)\n\n'
            '    def logp(self, **params_values):\n'
            '        from desilike_tpu_torch.bindings.base import point_loglikelihood\n'
            '        from desilike_tpu_torch.bindings.cobaya import inject_from_cobaya\n'
            '        values = {{_NAME_MAP[k]: v for k, v in params_values.items() if k in _NAME_MAP}}\n'
            '        # cobaya applies the priors itself: the bare log-likelihood, at one point on the\n'
            "        # likelihood's device\n"
            '        return point_loglikelihood(self._like, values, inject_from_cobaya, getattr(self, "provider", None))\n'
        ).format(names=names, params=self.params_info())
        return body
