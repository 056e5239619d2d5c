"""The bindings and the external cosmology engine of the port against the JAX
package's, on the CPU.

The JAX side is frozen in ``tests/data/torch_port_bindings_reference.npz``
(``scripts/make_torch_port_reference.py bindings``): what the fake cobaya
provider, cosmosis datablock and classy object of ``tests/test_bindings.py``
give at the fiducial and at a shifted cosmology (h = 0.70, omega_cdm =
0.125), the products the JAX package converts them to, its requirements
and parameter blocks, and its float32 and x64 log-likelihoods of the
external Kaiser likelihood (``tests/test_bindings.py:38-51``) and of config
3e (config 3d on host-injected products) at 8 nuisance points with those
products injected. The hosts here give back the frozen values
(:class:`FrozenProvider`, :class:`FrozenBlock`, :class:`FrozenClassy`), so
that no test runs the JAX package.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from desilike_tpu_torch import Cosmology, Pipeline
from desilike_tpu_torch.bindings import (CobayaLikelihoodGenerator, CobayaLikelihoodFactory, CosmoSISLikelihoodGenerator,
                                         CosmoSISLikelihoodFactory, MontePythonLikelihoodGenerator,
                                         MontePythonLikelihoodFactory, cobaya_requirements, desilike_to_cobaya_params,
                                         gather_cobaya_products, gather_cosmosis_products, gather_classy_products,
                                         regrid_pk)
from chip_smoke import (build_ept_external_likelihood, host_modules, ProductsProvider, ProductsBlock, ProductsClassy,
                        EPT_X64_ATOL, EPT_X64_GRAD_RTOL)

REFERENCE = np.load(os.path.join(os.path.dirname(__file__), 'data', 'torch_port_bindings_reference.npz'))
COSMOLOGIES = ('fid', 'shifted')
KAISER_ATOL, KAISER_GRAD_RTOL = 2e-2, 5e-4


def bao_factory():
    """``tests/test_bindings.py:8``'s BAO likelihood in the port, on the CPU."""
    from desilike_tpu_torch.theories import DampedBAOWigglesTracerPowerSpectrumMultipoles
    from desilike_tpu_torch.observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
    from desilike_tpu_torch.likelihoods import ObservablesGaussianLikelihood
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0,), k=np.linspace(0.02, 0.3, 29))
    theory.init.params = {'al*': dict(derived='.marg')}
    obs = TracerPowerSpectrumMultipolesObservable(data={'b1': 2.0}, klim={0: (0.02, 0.3, 0.01)}, theory=theory)
    return ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device='cpu')


def external_fs_factory():
    """``tests/test_bindings.py:38``'s full-shape likelihood on an external
    cosmology in the port, on the CPU."""
    from desilike_tpu_torch.theories import DirectPowerSpectrumTemplate, KaiserTracerPowerSpectrumMultipoles
    from desilike_tpu_torch.observables import TracerPowerSpectrumMultipolesObservable, BoxFootprint
    from desilike_tpu_torch.likelihoods import ObservablesGaussianLikelihood
    tmpl = DirectPowerSpectrumTemplate(z=1., cosmo=Cosmology(engine='external'))
    theory = KaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=tmpl, mu=6)
    obs = TracerPowerSpectrumMultipolesObservable(data={'b1': 2.0}, klim={0: (0.02, 0.18, 0.01), 2: (0.02, 0.18, 0.01)},
                                                  theory=theory)
    return ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device='cpu')


def frozen(cosmo, kind):
    prefix = '{}:{}:'.format(cosmo, kind)
    return {key[len(prefix):]: REFERENCE[key] for key in REFERENCE.files if key.startswith(prefix)}


def node_of(like):
    (_, node), = like.pipeline.external_nodes()
    return node


class FrozenProvider(object):
    """The JAX package's fake cobaya provider, from its frozen outputs."""

    def __init__(self, cosmo):
        self.values = frozen(cosmo, 'provider')

    def get_Hubble(self, z):
        z = np.atleast_1d(z)
        return self.values['H0'] if z.shape == (1,) and z[0] == 0. else self._check(z, self.values['H'])

    def _check(self, z, values):
        assert np.array_equal(z, REFERENCE['z_grid'])
        return values

    def get_comoving_radial_distance(self, z):
        return self._check(z, self.values['chi'])

    def get_param(self, name):
        assert name == 'rdrag'
        return float(self.values['rdrag'])

    def get_Pk_grid(self, var_pair=('delta_tot', 'delta_tot'), nonlinear=False):
        return self.values['pk_k'], self.values['pk_z'], self.values['pk']

    def get_fsigma8(self, z):
        return self._check(z, self.values['fsigma8'])

    def get_sigma8_z(self, z):
        return self._check(z, self.values['sigma8'])


class FrozenBlock(object):
    """The JAX package's fake cosmosis datablock, from its frozen entries."""

    def __init__(self, cosmo):
        self._d = {tuple(key.split(':')): value for key, value in frozen(cosmo, 'block').items()}

    def __getitem__(self, key):
        return self._d[key]

    def __setitem__(self, key, value):
        self._d[key] = value

    def has_value(self, section, name):
        return (section, name) in self._d


class FrozenClassy(object):
    """The JAX package's fake classy object, from its frozen outputs on the
    external node's grids."""

    def __init__(self, cosmo):
        self.values = frozen(cosmo, 'classy')

    def _at(self, name, z):
        return float(self.values[name][int(np.flatnonzero(REFERENCE['z_grid'] == z)[0])])

    def h(self):
        return float(self.values['h'])

    def Hubble(self, z):
        return float(self.values['H0']) if z == 0. else self._at('H', z)

    def angular_distance(self, z):
        return self._at('angular_distance', z)

    def rs_drag(self):
        return float(self.values['rs_drag'])

    def get_pk_array(self, karr, zarr, nk, nz, nonlinear):
        assert np.array_equal(zarr, REFERENCE['zpk_grid']) and nk * nz == len(karr)
        return self.values['pk_array']

    def sigma(self, R, z):
        return self._at('sigma8', z)

    def scale_independent_growth_factor_f(self, z):
        return self._at('f', z)


def test_generators(tmp_path):
    """The three generators write Python that names the port and not JAX;
    the cobaya parameter block carries the priors; the generated factory
    plumbing, run without the host code, evaluates the likelihood
    (``tests/test_bindings.py:18-35``, ``:156-169``)."""
    for cls, marker in ((CobayaLikelihoodGenerator, 'class DesilikeTPULikelihood'),
                        (CosmoSISLikelihoodGenerator, 'def execute('),
                        (MontePythonLikelihoodGenerator, 'class desilike_tpu_likelihood')):
        gen = cls(bao_factory)
        code = gen.generate()
        ast.parse(code)
        assert marker in code and 'desilike_tpu_torch' in code and 'jax' not in code
        gen.write(str(tmp_path / '{}.py'.format(cls.__name__)))
        assert (tmp_path / '{}.py'.format(cls.__name__)).exists()
    info = CobayaLikelihoodGenerator(bao_factory).params_info()
    assert 'qpar' in info and 'prior' in info['qpar']
    head = CobayaLikelihoodGenerator(bao_factory).generate().split('from cobaya.likelihood')[0]
    namespace = {}
    exec(compile(head, '<generated>', 'exec'), namespace)
    like = namespace['_get_like']()
    lp, aux = like._compiled_logpost({'qpar': 1., 'qper': 1., 'b1': 2., 'dbeta': 1.})
    assert aux['loglikelihood'].shape == (1,) and bool(torch.isfinite(aux['loglikelihood']).all())


def test_product_conversions():
    """``gather_cobaya_products``, ``gather_cosmosis_products`` (through its
    growth-from-pk fallback), ``gather_classy_products`` and ``regrid_pk``
    on the JAX package's fake hosts equal its own conversions within 1e-12."""
    node = Cosmology(engine='external', device='cpu')
    node.runtime_info.initialize()
    for name in ('z_grid', 'k_grid', 'zpk_grid'):
        np.testing.assert_array_equal(getattr(node, name), REFERENCE[name])
    for cosmo in COSMOLOGIES:
        for kind, products in (('cobaya', gather_cobaya_products(FrozenProvider(cosmo), node)),
                               ('cosmosis', gather_cosmosis_products(FrozenBlock(cosmo), node)),
                               ('classy_products', gather_classy_products(FrozenClassy(cosmo), node))):
            expected = frozen(cosmo, kind)
            assert set(products) == set(expected) == set(node._external_attrs), kind
            for key, value in products.items():
                np.testing.assert_allclose(value, expected[key], rtol=1e-12, atol=0., err_msg='{} {}'.format(kind, key))
        provider = FrozenProvider(cosmo).values
        h = {'fid': 0.6736, 'shifted': 0.70}[cosmo]  # the provider's h, with which the JAX package regridded
        kh, lnpk = provider['pk_k'] / h, np.log(provider['pk'] * h ** 3)
        np.testing.assert_allclose(regrid_pk(kh, provider['pk_z'], lnpk, node.zpk_grid, node.k_grid),
                                   REFERENCE[cosmo + ':regrid'], rtol=1e-12, atol=0.)
        np.testing.assert_allclose(regrid_pk(kh, provider['pk_z'][:1], lnpk[:1], node.zpk_grid[:2], node.k_grid),
                                   REFERENCE[cosmo + ':regrid_one_row'], rtol=1e-12, atol=0.)


def test_requirements_and_params():
    """``cobaya_requirements`` of the external Kaiser likelihood and
    ``desilike_to_cobaya_params`` of the BAO one equal the JAX package's."""
    def plain(obj):
        return obj.tolist() if isinstance(obj, np.ndarray) else float(obj)

    got = json.loads(json.dumps(cobaya_requirements(external_fs_factory()), default=plain))
    assert got == json.loads(str(REFERENCE['cobaya_requirements']))
    assert got['Pk_grid']['nonlinear'] is False and got['Pk_grid']['k_max'] > 1.
    got = json.loads(json.dumps(desilike_to_cobaya_params(bao_factory().pipeline.varied_params), default=plain))
    assert got == json.loads(str(REFERENCE['cobaya_params']))
    assert got['qpar']['prior']['min'] > 0.


def check_injected(like, config, atol, grad_rtol):
    """``like`` at the 8 frozen points with each cosmology's frozen cobaya
    products injected: its mock data (made at its own EH98 fill) within
    1e-6 of the JAX package's; the log-posterior and log-likelihood within
    ``atol`` of the JAX package's x64 values, the gradient within
    ``grad_rtol`` of its norm."""
    names, points = list(REFERENCE[config + ':names']), REFERENCE[config + ':points']
    pipe = like.pipeline
    np.testing.assert_allclose(like.flatdata, REFERENCE[config + ':flatdata'], rtol=1e-6, atol=0.)
    assert pipe.varied_params.names() == names
    fn = like.logpost_fn()
    for cosmo in COSMOLOGIES:
        pipe.set_cosmo_requires(**frozen(cosmo, 'cobaya'))
        values = {name: torch.tensor(points[:, i], dtype=torch.float32, requires_grad=True)
                  for i, name in enumerate(names)}
        logpost, aux = fn(dict(values, **pipe.external_values()))
        logpost.sum().backward()
        grad = torch.stack([values[name].grad for name in names], dim=-1).numpy()
        prefix = '{}:{}:'.format(config, cosmo)
        np.testing.assert_allclose(logpost.detach().numpy(), REFERENCE[prefix + 'logpost_x64'], rtol=0., atol=atol)
        np.testing.assert_allclose(aux['loglikelihood'].detach().numpy(), REFERENCE[prefix + 'loglikelihood_x64'],
                                   rtol=0., atol=atol)
        ref = REFERENCE[prefix + 'grad_x64']
        assert np.max(np.linalg.norm(grad - ref, axis=-1) / np.linalg.norm(ref, axis=-1)) < grad_rtol


def test_external_kaiser_against_jax():
    """The external Kaiser likelihood with the frozen products injected:
    within 2e-2 of the JAX package's x64 log-posterior and log-likelihood,
    the gradient within 5e-4 of its norm, in float32 (its 8 points within
    0.05 of the data's b1 and sn0: nearer, the gradient falls to the float32
    rounding of the likelihood)."""
    check_injected(external_fs_factory(), 'kaiser', KAISER_ATOL, KAISER_GRAD_RTOL)


def test_config3e_against_jax():
    """Config 3e (config 3d's EPT likelihood on host-injected products,
    ``chip_smoke.build_ept_external_likelihood``) on the CPU, with the frozen
    products injected: within the config-3 limits of the JAX package's x64
    values (2e-2, the gradient 5e-4 of its norm)."""
    check_injected(build_ept_external_likelihood('cpu'), 'ept', EPT_X64_ATOL, EPT_X64_GRAD_RTOL)


@host_modules()
def test_generated_cobaya_module():
    """The whole generated cobaya module against a stub cobaya and the
    frozen provider (``tests/test_bindings.py:128-153``): it requires the
    host products, ranks the fiducial cosmology above the shifted one, and
    ``CobayaLikelihoodFactory`` (``params=True``, a module path) gives the
    same log-likelihoods."""
    namespace = {}
    exec(compile(CobayaLikelihoodGenerator(external_fs_factory).generate(), '<generated>', 'exec'), namespace)
    generated = namespace['DesilikeTPULikelihood']()
    generated.initialize()
    assert 'Pk_grid' in generated.get_requirements()
    cls = CobayaLikelihoodFactory(external_fs_factory, params=True, module='my.bindings')
    assert cls.__name__ == 'external_fs_factory' and cls.__module__ == 'my.bindings'
    assert 'b1' in cls.params and 'prior' in cls.params['b1']
    factory = cls()
    factory.initialize()
    logp = {}
    for cosmo in COSMOLOGIES:
        logp[cosmo] = []
        for wrapper in (generated, factory):
            wrapper.provider = FrozenProvider(cosmo)
            logp[cosmo].append(wrapper.logp(b1=2.0))
    assert logp['fid'][0] == logp['fid'][1] and logp['shifted'][0] == logp['shifted'][1]
    assert np.isfinite(logp['fid'][0]) and np.isfinite(logp['shifted'][0]) and logp['fid'][0] > logp['shifted'][0] + 1.


@host_modules()
def test_factories_agree():
    """``CosmoSISLikelihoodFactory`` and ``MontePythonLikelihoodFactory``
    through hosts that hold the generated cobaya module's products (h = 1)
    inject the same float32 tables and give its log-likelihood bit for bit;
    the cosmosis module's cleanup and the MontePython nuisance list as in
    ``tests/test_bindings.py:263-320``."""
    namespace = {}
    exec(compile(CobayaLikelihoodGenerator(external_fs_factory).generate(), '<generated>', 'exec'), namespace)
    generated = namespace['DesilikeTPULikelihood']()
    generated.initialize()
    node = node_of(generated._like)
    products = frozen('fid', 'cobaya')
    generated.provider = ProductsProvider(node, products)
    expected = generated.logp(b1=2.1)
    tables = {key: torch.as_tensor(getattr(node, key), dtype=torch.float32) for key in node._external_attrs}
    point = {p.name: (2.1 if p.basename == 'b1' else p.value) for p in generated._like.pipeline.varied_params}
    setup, execute, cleanup = CosmoSISLikelihoodFactory(external_fs_factory, name_like='my_fs').build_module()
    calc = setup(None)
    block = ProductsBlock(node_of(calc.like), products, point)
    assert execute(block, calc) == 0 and cleanup(calc) == 0
    montepython = MontePythonLikelihoodFactory(external_fs_factory)(None, None, None)
    assert 'b1' in montepython.use_nuisance

    class Data(object):
        mcmc_parameters = {key.replace('.', '_'): {'current': value, 'scale': 1.} for key, value in point.items()}

    got = [block['likelihoods', 'my_fs_like'], montepython.loglkl(ProductsClassy(node, products), Data())]
    for like in (calc.like, montepython._like):
        for key, value in tables.items():
            assert torch.equal(torch.as_tensor(getattr(node_of(like), key), dtype=torch.float32), value), key
    assert got == [expected, expected]


def test_set_cosmo_requires():
    """``set_cosmo_requires`` then ``external_values`` equals injecting into
    the node; tables passed in through the values dict serve their call only;
    a table of another shape raises, in ``inject`` and when passed in, and
    ``inject`` on another engine raises (``tests/test_bindings.py:115-121``)."""
    like = external_fs_factory()
    pipe, node = like.pipeline, node_of(like)
    fn = like.logpost_fn()
    shifted = frozen('shifted', 'cobaya')
    node.inject(**shifted)
    direct = fn(dict(b1=torch.tensor([2.0, 2.1]), **pipe.external_values()))[0]
    node.inject(**frozen('fid', 'cobaya'))
    fiducial_tables = {key: getattr(node, key) for key in node._external_attrs}
    pipe.set_cosmo_requires(**shifted)
    values = pipe.external_values()
    assert all(values['external:{}:{}'.format(pipe.external_nodes()[0][0], key)].dtype == torch.float32
               for key in node._external_attrs)
    assert torch.equal(fn(dict(b1=torch.tensor([2.0, 2.1]), **values))[0], direct)
    pipe.set_cosmo_requires(**fiducial_tables)
    assert torch.equal(fn(dict(b1=torch.tensor([2.0, 2.1]), **values))[0], direct)  # the tables passed in
    assert all(getattr(node, key) is value for key, value in fiducial_tables.items())  # the node's kept
    with pytest.raises(ValueError, match='shape'):
        node.inject(pk_tab=np.ones(3))
    key = 'external:{}:pk_tab'.format(pipe.external_nodes()[0][0])
    with pytest.raises(ValueError, match='shape'):
        fn({'b1': 2.0, key: torch.ones(3)})
    with pytest.raises(ValueError, match='external'):
        Cosmology(device='cpu').inject(pk_tab=np.ones(3))


def test_external_engine_at_its_fill():
    """The external node before any injection holds the EH98 tables of its
    cosmology on its default grids (z 0-4 in 65 steps, k 1e-4-10 in 256 log
    steps, z_pk 0-3 in 13): its accessors agree with the eh98 node's within
    the grids' interpolation error (1e-3; 5e-3 for the pk tables, linear in
    z between rows 0.25 apart), at a static z and at one z a chain;
    pk_dd_now is the eh98 node's no-wiggle shape at the table's amplitude."""
    external, eh98 = Cosmology(engine='external', device='cpu'), Cosmology(device='cpu')
    for node in (external, eh98):
        Pipeline(node).evaluate({}, dtype=torch.float64)
    assert external.z_grid.shape == (65,) and external.k_grid.shape == (256,) and external.zpk_grid.shape == (13,)
    k = np.geomspace(1e-3, 1., 50)
    for name, args in (('efunc', (0.8,)), ('comoving_radial_distance', (0.8,)), ('comoving_angular_distance', (0.8,)),
                       ('rs_drag', ()), ('growth_rate', (0.8,)), ('growth_factor', (0.8,)), ('sigma8', (0.8,)),
                       ('fsigma8', (0.8,)), ('sigma_r', (8., 0.8)), ('pk_dd', (k, 0.8)), ('pk_dd_now', (k, 0.8)),
                       ('efunc', (np.array([0.3, 1.3]),))):
        got, expected = getattr(external, name)(*args), getattr(eh98, name)(*args)
        np.testing.assert_allclose(got.numpy().reshape(-1), expected.numpy().reshape(-1),
                                   rtol=5e-3 if name.startswith('pk_dd') else 1e-3, err_msg=name)
    # the distances one row a chain (the AP lookups), the growth quantities one value for every chain
    assert external.efunc(0.8).shape == external.rs_drag().shape == (1,) and external.growth_rate(0.8).shape == ()
    z = torch.tensor([0.8], dtype=torch.float64)
    np.testing.assert_allclose(external.efunc(z).numpy(), eh98.efunc(0.8).numpy(), rtol=1e-3)
