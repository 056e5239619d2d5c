"""CosmoSIS binding generator and factory (counterpart of
``desilike_tpu/bindings/cosmosis.py``).

When the pipeline holds external nodes, the likelihood reads the
datablock's distances, matter_power_lin and growth sections and injects
them before each call."""

import numpy as np
import torch

from .base import BaseLikelihoodGenerator, regrid_pk, point_loglikelihood


def gather_cosmosis_products(block, node):
    """Products from a cosmosis datablock in its conventions (distances in
    Mpc, H(z) in 1/Mpc with c = 1, matter_power_lin in h-units), converted
    to h-units on the node's grids."""
    h = float(block['cosmological_parameters', 'h0'])
    zb = np.asarray(block['distances', 'z'], dtype='f8')
    order = np.argsort(zb)
    zb = zb[order]
    Hb = np.asarray(block['distances', 'h'], dtype='f8')[order]
    dm = np.asarray(block['distances', 'd_m'], dtype='f8')[order]
    z = np.asarray(node.z_grid, dtype='f8')
    H0 = np.interp(0., zb, Hb)
    products = {'efunc_tab': np.interp(z, zb, Hb) / H0,
                'chi_tab': np.interp(z, zb, dm) * h,
                'rs_drag_tab': float(block['distances', 'rs_zdrag']) * h}
    kh = np.asarray(block['matter_power_lin', 'k_h'], dtype='f8')
    zpk = np.asarray(block['matter_power_lin', 'z'], dtype='f8')
    pk = np.asarray(block['matter_power_lin', 'p_k'], dtype='f8')
    products['pk_tab'] = regrid_pk(kh, zpk, np.log(pk), node.zpk_grid, node.k_grid)
    if block.has_value('growth_parameters', 'fsigma_8'):
        zg = np.asarray(block['growth_parameters', 'z'], dtype='f8')
        products['fsigma8_tab'] = np.interp(z, zg, np.asarray(block['growth_parameters', 'fsigma_8'], dtype='f8'))
        products['sigma8_tab'] = np.interp(z, zg, np.asarray(block['growth_parameters', 'sigma_8'], dtype='f8'))
    else:
        s8, fs8 = growth_from_pk_table(zpk, kh, pk, z)
        products['sigma8_tab'], products['fsigma8_tab'] = s8, fs8
    return products


def growth_from_pk_table(zpk, kh, pk, z_out):
    """(sigma8(z), f sigma8(z)) from a pk(z, k) table alone: the top-hat
    filtered amplitude of each z row, the growth rate from d ln sigma8 / d
    ln a by finite differences; for a host that exposes no growth section."""
    from ..cosmology.linear import tophat_window
    kh = np.asarray(kh, dtype='f8')
    pk = np.atleast_2d(np.asarray(pk, dtype='f8'))
    zpk = np.asarray(zpk, dtype='f8')
    w = tophat_window(torch.from_numpy(kh * 8.)).numpy() ** 2 * kh ** 3
    wk = np.zeros_like(kh)
    dlnk = np.diff(np.log(kh))
    wk[:-1] += dlnk / 2.
    wk[1:] += dlnk / 2.
    s8_rows = np.sqrt(np.einsum('zk,k->z', pk, w * wk) / (2. * np.pi ** 2))
    if len(zpk) < 2:
        raise ValueError('growth from the pk table needs >= 2 redshift rows')
    lna = -np.log1p(zpk)
    dlns8 = np.gradient(np.log(s8_rows), lna)
    s8 = np.exp(np.interp(z_out, zpk, np.log(s8_rows)))
    f = np.interp(z_out, zpk, dlns8)
    return s8, f * s8


def inject_from_cosmosis(like, block):
    """Inject the datablock's current cosmology into every external node."""
    for _, node in like.pipeline.external_nodes():
        node.inject(**gather_cosmosis_products(block, node))


def CosmoSISLikelihoodFactory(factory, name_like=None, kw_like=None, module=None):
    """Build a cosmosis likelihood-calculator class at run time, the
    counterpart of :class:`CosmoSISLikelihoodGenerator`. Instances are made
    by ``setup(options)`` and evaluated by ``execute(block)``; the
    classmethod ``build_module()`` returns the ``(setup, execute, cleanup)``
    triple a cosmosis module file exposes.

    The sampled parameters are read from the block section
    'desilike_tpu_params' (names with '.' as '_'); the log-likelihood is
    written to ('likelihoods', '<name_like>_like'). The host cosmology
    (external nodes) is injected from the block's distances,
    matter_power_lin and growth sections.
    """
    kw_like = dict(kw_like or {})
    name_like = name_like or getattr(factory, '__name__', 'DesilikeTPULikelihood')

    def __init__(self, options=None):
        self.like = factory(**kw_like)
        self.like._compiled_logpost = self.like.logpost_fn()
        self._name_map = {p.name.replace('.', '_'): p.name for p in self.like.pipeline.varied_params}

    def do_likelihood(self, block):
        values = {name: block['desilike_tpu_params', key] for key, name in self._name_map.items()}
        block['likelihoods', '{}_like'.format(name_like)] = point_loglikelihood(self.like, values,
                                                                                inject_from_cosmosis, block)

    def build_module(cls):
        def setup(options):
            return cls(options)

        def execute(block, config):
            config.do_likelihood(block)
            return 0

        def cleanup(config):
            return 0

        return setup, execute, cleanup

    d = {'__init__': __init__, 'do_likelihood': do_likelihood, 'build_module': classmethod(build_module)}
    if module is not None:
        d['__module__'] = module
    return type(name_like, (object,), d)


class CosmoSISLikelihoodGenerator(BaseLikelihoodGenerator):
    """Generates a CosmoSIS module (setup / execute) reading the sampled
    parameters from the datablock and writing the log-likelihood."""

    def generate(self):
        params = self.varied_params()
        names = [p.name for p in params]
        body = self.header()
        body += (
            '\nfrom cosmosis.datablock import option_section, names as section_names\n\n'
            '_PARAM_NAMES = {names!r}\n\n\n'
            'def setup(options):\n'
            '    return _get_like()\n\n\n'
            'def execute(block, like):\n'
            '    from desilike_tpu_torch.bindings.base import point_loglikelihood\n'
            '    values = {{}}\n'
            '    for name in _PARAM_NAMES:\n'
            '        key = name.replace(".", "_")\n'
            '        values[name] = block["desilike_tpu_params", key]\n'
            '    block[section_names.likelihoods, "desilike_tpu_like"] = point_loglikelihood(like, values)\n'
            '    return 0\n\n\n'
            'def cleanup(like):\n'
            '    return 0\n'
        ).format(names=names)
        return body
