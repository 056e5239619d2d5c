"""MontePython binding generator and factory (counterpart of
``desilike_tpu/bindings/montepython.py``).

MontePython hands the likelihood a classy instance; the external nodes
take its background and pk products before each call."""

import numpy as np

from .base import BaseLikelihoodGenerator, point_loglikelihood


def gather_classy_products(cosmo, node):
    """Products from a classy instance (CLASS conventions: H in 1/Mpc,
    distances in Mpc, pk in Mpc^3 against k in 1/Mpc), converted to
    h-units."""
    h = float(cosmo.h())
    z = np.asarray(node.z_grid, dtype='f8')
    H0 = float(cosmo.Hubble(0.))
    efunc = np.array([float(cosmo.Hubble(zz)) for zz in z]) / H0
    chi = np.array([float(cosmo.angular_distance(zz)) * (1. + zz) for zz in z]) * h
    products = {'efunc_tab': efunc, 'chi_tab': chi, 'rs_drag_tab': float(cosmo.rs_drag()) * h}
    kh = np.asarray(node.k_grid, dtype='f8')
    zpk = np.asarray(node.zpk_grid, dtype='f8')
    get_pk_array = getattr(cosmo, 'get_pk_array', None)
    if get_pk_array is not None:
        # classy's batched table getter: karr (nk * nz, k fastest), zarr (nz); a flat pk of nz * nk, one call
        nk, nz = len(kh), len(zpk)
        karr = np.tile(kh * h, nz)
        flat = np.asarray(get_pk_array(karr, zpk, nk, nz, 0), dtype='f8')
        pk = flat.reshape(nz, nk) * h ** 3
    else:
        pk = np.array([[float(cosmo.pk_lin(kk * h, zz)) for kk in kh] for zz in zpk]) * h ** 3
    products['pk_tab'] = pk
    s8 = np.array([float(cosmo.sigma(8. / h, zz)) for zz in z])
    f = np.array([float(cosmo.scale_independent_growth_factor_f(zz)) for zz in z])
    products['sigma8_tab'] = s8
    products['fsigma8_tab'] = f * s8
    return products


def inject_from_classy(like, cosmo):
    """Inject the classy instance's cosmology into every external node."""
    for _, node in like.pipeline.external_nodes():
        node.inject(**gather_classy_products(cosmo, node))


def MontePythonLikelihoodFactory(factory, name_like=None, kw_like=None, module=None):
    """Build a MontePython ``Likelihood`` subclass at run time, the
    counterpart of :class:`MontePythonLikelihoodGenerator`. The sampled
    parameters are read from ``data.mcmc_parameters`` (names with '.' as
    '_', declared as ``use_nuisance``); the classy instance's cosmology is
    injected into the pipeline's external nodes at each ``loglkl`` call."""
    from montepython.likelihood_class import Likelihood  # the host package, imported at call time
    kw_like = dict(kw_like or {})
    name_like = name_like or getattr(factory, '__name__', 'desilike_tpu_likelihood')

    def __init__(self, path, data, command_line):
        Likelihood.__init__(self, path, data, command_line)
        self._like = factory(**kw_like)
        self._like._compiled_logpost = self._like.logpost_fn()
        self._name_map = {p.name.replace('.', '_'): p.name for p in self._like.pipeline.varied_params}
        self.nuisance = self.use_nuisance = list(self._name_map)

    def loglkl(self, cosmo, data):
        values = {}
        for key, name in self._name_map.items():
            entry = data.mcmc_parameters[key]
            values[name] = entry['current'] * entry['scale']
        return point_loglikelihood(self._like, values, inject_from_classy, cosmo)

    d = {'__init__': __init__, 'loglkl': loglkl}
    if module is not None:
        d['__module__'] = module
    return type(name_like, (Likelihood,), d)


class MontePythonLikelihoodGenerator(BaseLikelihoodGenerator):
    """Generates a MontePython likelihood module: a Likelihood subclass whose
    loglkl() reads the sampled (nuisance) parameters from
    data.mcmc_parameters and returns the desilike_tpu_torch log-likelihood."""

    def generate(self):
        params = self.varied_params()
        names = [p.name for p in params]
        body = self.header()
        body += (
            '\nfrom montepython.likelihood_class import Likelihood\n\n'
            '_PARAM_NAMES = {names!r}\n\n\n'
            'class desilike_tpu_likelihood(Likelihood):\n\n'
            '    def __init__(self, path, data, command_line):\n'
            '        Likelihood.__init__(self, path, data, command_line)\n'
            '        self._like = _get_like()\n'
            '        for name in _PARAM_NAMES:\n'
            '            key = name.replace(".", "_")\n'
            '            self.use_nuisance = getattr(self, "use_nuisance", [])\n'
            '            if key not in self.use_nuisance:\n'
            '                self.use_nuisance.append(key)\n\n'
            '    def loglkl(self, cosmo, data):\n'
            '        from desilike_tpu_torch.bindings.base import point_loglikelihood\n'
            '        values = {{}}\n'
            '        for name in _PARAM_NAMES:\n'
            '            key = name.replace(".", "_")\n'
            '            entry = data.mcmc_parameters[key]\n'
            '            values[name] = entry["current"] * entry["scale"]\n'
            '        return point_loglikelihood(self._like, values)\n'
        ).format(names=names)
        return body
