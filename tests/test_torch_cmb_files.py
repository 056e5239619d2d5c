"""The CMB family's files and the pieces of the port that stand alone:
every writer of the port read by the JAX package's reader and every writer
of the JAX package read by the port's, the arrays the same (the FITS codec
underneath both, the getdist readers); the emulated C_ell of the golden
weights through the port's ``ClTheory(emulator=...)``; the
Hamimeche & Lewis transform at model == data. The installer's lookup
without data is held in ``tests/test_torch_unported.py`` and
``tests/test_torch_compat.py``.

Limits: the files' arrays exactly (text files through ``np.savetxt`` at
full precision, within 1e-12); the emulated C_ell within 2e-5 of the golden
(``tests/test_cmb.py:934-953``; measured 3.6e-8).
"""

import os
import sys

import numpy as np
import pytest
import torch

from desilike_tpu import io_fits as jfits
from desilike_tpu.likelihoods import cmb as jcmb
from desilike_tpu_torch import io_fits as tfits, Pipeline
from desilike_tpu_torch.likelihoods import cmb as tcmb
from desilike_tpu_torch.cosmology.emulator import load_weights

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), 'scripts'))
import make_torch_port_reference as M  # noqa: E402
from chip_smoke import cmb_tables  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), 'data')


def assert_same(got, expected, path=''):
    """The same keys and values, arrays within 1e-12 (relative)."""
    if isinstance(expected, dict):
        assert sorted(got) == sorted(expected), path
        for key in expected:
            assert_same(got[key], expected[key], '{}.{}'.format(path, key))
    elif isinstance(expected, (list, tuple)):
        assert len(got) == len(expected), path
        for i, (item, value) in enumerate(zip(got, expected)):
            assert_same(item, value, '{}[{:d}]'.format(path, i))
    elif isinstance(expected, np.ndarray) and expected.dtype.kind in 'fiub':
        np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-12, atol=0., err_msg=path)
    else:
        assert got == expected, path


@pytest.fixture(scope='module')
def fixtures():
    return M.cmb_fixtures()


def act_planck(fixture):
    """The actplanck variant's data (tests/test_cmb.py::test_act_dr6_file_roundtrip_planck)."""
    data = dict(fixture, include_planck=True, binmat_planck=fixture['binmat_act'][:5])
    data['data_binned_clkk'] = np.concatenate([fixture['data_binned_clkk'], fixture['data_binned_clkk'][:5]])
    data['covariance'] = np.diag((0.05 * np.abs(data['data_binned_clkk']) + 1e-12) ** 2)
    for key in ('dN1_kk', 'dAL_dC', 'fAL', 'dN1_tt', 'dN1_ee', 'dN1_bb', 'dN1_te'):
        data[key + '_planck'] = fixture[key]
    return data


def roundtrip(name, fixtures, write, read, directory):
    """Write the case ``name`` with the module ``write`` into ``directory``,
    read it with the module ``read``; returns (read, expected)."""
    os.makedirs(directory, exist_ok=True)
    w, r = write.likelihoods.cmb if hasattr(write, 'likelihoods') else write, read
    if name == 'plik':
        w.planck2018.write_plik_lite_data(directory, fixtures['plik'])
        expected = dict(fixtures['plik'], weights=np.concatenate([np.zeros(30), fixtures['plik']['weights'][30:]]))
        return r.TTTEEEHighlPlanck2018LiteLikelihood.load_plik_lite(directory, nbins=expected['nbins']), expected
    if name == 'commander':
        w.planck2018.write_commander_data(directory, fixtures['commander'])
        return r.TTLowlPlanck2018Likelihood.load_commander(directory), fixtures['commander']
    if name == 'simall':
        prob = fixtures['simall']['prob']
        w.planck2018.write_simall_data(directory, fixtures['simall'])
        padded = np.concatenate([prob, np.full((prob.shape[0], 3000 - prob.shape[1]), -1e30)], axis=1) \
            if prob.shape[1] < 3000 else prob
        return r.EELowlPlanck2018Likelihood.load_simall(directory), dict(prob=padded)
    if name == 'lollipop':
        w.lollipop.write_lollipop_data(directory, fixtures['lollipop'])
        expected = {key: fixtures['lollipop'][key] for key in ('cl', 'fiducial', 'covariance')}
        return r.lollipop.read_lollipop_data(directory), expected
    if name in ('act', 'act_planck'):
        variant = 'act_baseline' if name == 'act' else 'actplanck_baseline'
        data = dict(fixtures['act'], covariance=np.linalg.inv(fixtures['act']['cinv'])) if name == 'act' \
            else act_planck(fixtures['act'])
        w.act_dr6_lensing.write_act_dr6_data(directory, data, variant=variant)
        got = r.act_dr6_lensing.read_act_dr6_data(directory, variant=variant, apply_hartlap=False)
        expected = {key: data[key] for key in got if key not in ('cinv',)}
        np.testing.assert_allclose(got['cinv'], np.linalg.inv(data['covariance']), rtol=1e-12)
        return {key: value for key, value in got.items() if key != 'cinv'}, expected
    if name in ('lensing', 'lensing_marged'):
        variant = 'consext8' if name == 'lensing' else 'CMBmarged'
        w.planck2018_lensing.write_planck2018_lensing_data(directory, fixtures[name], variant=variant)
        return r.planck2018_lensing.read_planck2018_lensing_data(directory, variant=variant), fixtures[name]
    if name == 'camspec':
        data = r.synthetic_camspec_data(cmb_tables()['tables'], seed=11, lranges={
            block: (30, 300) for block in r.camspec.ALL_BLOCKS})
        w.camspec.write_camspec_data(directory, data)
        got = r.camspec.read_camspec_data(directory)
        np.testing.assert_allclose(got['covariance'], data['covariance'], rtol=1e-7)  # float32 on disk
        return {key: got[key] for key in ('ells', 'spectra')}, {key: data[key] for key in ('ells', 'spectra')}
    data = M.hillipop_fixture(cmb_tables()['tables'], (2.7255 * 1e6) ** 2, zero_weights=True)
    w.hillipop.write_hillipop_data(directory, data)
    got = r.hillipop.read_hillipop_data(directory)
    nl = int(got['lmaxs']['TT'].max()) + 1
    dldata = dict(data['dldata'], ET=data['dldata']['TE'])  # the writer's ET row: TE's, as none is given
    expected = dict(dldata={m: v[:, :nl] for m, v in dldata.items()}, lmins=data['lmins'],
                    lmaxs=data['lmaxs'], invcov=data['invcov'],
                    templates={k: np.asarray(v)[..., :nl] for k, v in data['templates'].items()})
    np.testing.assert_allclose(got['dlweight']['TT'], data['dlweight']['TT'][:, :nl], rtol=1e-12)
    return {key: got[key] for key in expected}, expected


CASES = ['plik', 'commander', 'simall', 'lollipop', 'act', 'act_planck', 'lensing', 'lensing_marged', 'camspec', 'hillipop']


@pytest.mark.parametrize('name', CASES)
def test_cmb_files_both_ways(name, fixtures, tmp_path):
    """The port's writer read by the JAX package's reader, and the JAX
    package's writer read by the port's: the arrays of the data they hold."""
    for write, read, where in ((tcmb, jcmb, 'port'), (jcmb, tcmb, 'jax')):
        got, expected = roundtrip(name, fixtures, write, read, str(tmp_path / where))
        assert_same(got, expected, name)


def test_fits_and_getdist_both_ways(tmp_path):
    """The FITS codec (images of each type, a binary table, header cards)
    and the getdist readers (covmat, margestats, chains) in both packages;
    the full-grid Gaussian likelihood's data and covariance from a grid's
    covmat and from its chains, as the JAX package's; the clik aliases."""
    image = np.arange(24, dtype='f8').reshape(2, 3, 4)
    table = {'LMIN': np.arange(5, dtype='i8'), 'W': np.linspace(0., 1., 5).astype('f4'), 'OK': np.array([1, 0, 1, 1, 0], dtype='?')}
    for write, read, where in ((tfits, jfits, 'port'), (jfits, tfits, 'jax')):
        fn = str(tmp_path / '{}.fits'.format(where))
        write.write(fn, [write.Hdu(data=image), write.Hdu(data=image.astype('i4')),
                         write.Hdu(columns=table, header={'SPEC': 'TT', 'NUM': 3})])
        np.testing.assert_array_equal(read.read(fn, ext=0), image)
        np.testing.assert_array_equal(read.read(fn, ext=1), image.astype('i4'))
        got = read.read(fn, ext=2)
        for key, value in table.items():
            np.testing.assert_array_equal(got[key], value)
        header = read.read_header(fn, ext=2)
        assert header['SPEC'] == 'TT' and header['NUM'] == 3
    names = ['omegabh2', 'omegach2', 'ns']
    cov = np.array([[2.2e-8, -1e-8, 2e-8], [-1e-8, 1.4e-6, -3e-6], [2e-8, -3e-6, 1.7e-5]])
    with open(tmp_path / 'test.covmat', 'w') as f:
        f.write('# ' + ' '.join(names) + '\n')
        np.savetxt(f, cov)
    with open(tmp_path / 'test.margestats', 'w') as f:
        f.write('Marginalized limits\n\nparameter  mean  sddev\n')
        f.write('omegabh2 0.02237 0.00015\nomegach2* 0.1200 0.0012\nns 0.9649 0.0042\n')
    with open(tmp_path / 'test.paramnames', 'w') as f:
        f.write('omegabh2 \\Omega_b h^2\nomegach2* \\Omega_c h^2\nns n_s\n')
    samples = np.random.default_rng(0).normal(size=(20, 5))
    np.savetxt(tmp_path / 'test_1.txt', samples)
    base = str(tmp_path / 'test')
    for reader in ('read_getdist_covmat', 'read_getdist_margestats'):
        fn = base + ('.covmat' if reader.endswith('covmat') else '.margestats')
        assert_same(getattr(tcmb, reader)(fn), getattr(jcmb, reader)(fn), reader)
    for got, expected in zip(tcmb.read_getdist_chains(base), jcmb.read_getdist_chains(base)):
        assert_same(got, expected, 'chains')
    # the full-grid layout <data_dir>/<model>/plikHM_<obs>/[dist/]<basename>, from its covmat and from its chains
    basename = 'base_mnu_plikHM_TTTEEE_lowl_lowE'
    run = tmp_path / 'base_mnu' / 'plikHM_TTTEEE_lowl_lowE'
    (run / 'dist').mkdir(parents=True)
    mean, std = np.array([0.02237, 0.1200, 0.9649]), np.array([0.00015, 0.0012, 0.0042])
    draws = np.random.default_rng(0).normal(mean, std, size=(600, 3))
    with open(run / (basename + '.paramnames'), 'w') as f:
        f.write('omegabh2 \\Omega_b h^2\nomegach2* \\Omega_c h^2\nns n_s\n')
    np.savetxt(run / (basename + '_1.txt'), np.column_stack([np.ones(600), np.zeros(600), draws]))
    with open(run / 'dist' / (basename + '.covmat'), 'w') as f:
        f.write('# ' + ' '.join(names) + '\n')
        np.savetxt(f, np.diag(std ** 2))
    with open(run / 'dist' / (basename + '.margestats'), 'w') as f:
        f.write('parameter mean sddev\n' + ''.join('{} {} {}\n'.format(*row) for row in zip(names, mean, std)))
    for source in ('covmat', 'chains'):
        ours = tcmb.FullGridPlanck2018GaussianLikelihood(basename=basename, data_dir=str(tmp_path), source=source,
                                                         device='cpu')
        theirs = jcmb.FullGridPlanck2018GaussianLikelihood(basename=basename, data_dir=str(tmp_path), source=source)
        ours.runtime_info.initialize()
        theirs.runtime_info.initialize()
        assert ours.quantities == theirs.quantities
        np.testing.assert_allclose(ours.flatdata, np.asarray(theirs.flatdata), rtol=1e-12)
        np.testing.assert_allclose(ours.covariance, np.asarray(theirs.covariance), rtol=1e-12)
    chain = tcmb.read_planck2018_chain(basename, data_dir=str(tmp_path))
    assert chain.attrs['sampled_params'] == ['omega_b', 'n_s']
    np.testing.assert_array_equal(chain['omega_cdm'], draws[:, 1])
    # the clik names are the same likelihoods
    assert tcmb.TTHighlPlanck2018PlikLiteLikelihood is tcmb.TTHighlPlanck2018LiteLikelihood
    assert issubclass(tcmb.LensingPlanck2018ClikLikelihood, tcmb.Planck2018LensingLikelihood)


def test_cl_emulator_golden():
    """The golden emulated-Cl weights through the port's ``ClTheory(emulator=...)``
    (the node's interpolation matrix) at the golden theta, in float32."""
    weights = load_weights(os.path.join(DATA, 'golden_cl_emulator_weights.npz'))
    frozen = np.load(os.path.join(DATA, 'golden_cl_emulator_out.npz'))
    theory = tcmb.ClTheory(emulator=weights, cls={'tt': int(weights['lmax']), 'ee': int(weights['lmax'])},
                           device='cpu')
    pipe = Pipeline(theory)
    pipe.evaluate(dict(zip(weights['param_names'], frozen['theta'])), device='cpu', dtype=torch.float32)
    assert set(theory.cls) == {'tt', 'ee'}
    for xy, got in theory.cls.items():
        ref = frozen[xy]
        assert got.dtype == torch.float32 and got.shape == (1, ref.size)
        np.testing.assert_allclose(got[0].numpy().astype('f8'), ref, atol=2e-5 * np.abs(ref).max(), rtol=2e-5)


def test_hamimeche_lewis_at_the_data():
    """g(x) of the H&L transform at and near x = 1 (model == data), in
    float32 against the JAX package's x64 value and derivative (within 1e-6
    and 1e-5, relative): off x = 1 its x64 derivative tends to 1 on both
    sides; at x = 1 exactly it is NaN (the sqrt of 0), and the port gives
    that limit, 1 (its float32 form near x = 1 is a series of the same
    function, so that no chain near the data gets a NaN gradient)."""
    import jax
    import jax.numpy as jnp
    jax.config.update('jax_enable_x64', True)
    try:
        values = np.array([0.2, 0.5, 0.97, 0.9999, 1. - 1e-7, 1. + 1e-7, 1.0001, 1.03, 1.5, 3.], dtype='f4')
        x = torch.tensor(values, requires_grad=True)
        g = tcmb.lollipop.ghl(x)
        (grad,) = torch.autograd.grad(g.sum(), x)
        expected = [float(jcmb.lollipop.ghl(jnp.float64(v))) for v in values]
        slope = [float(jax.grad(jcmb.lollipop.ghl)(jnp.float64(v))) for v in values]
        np.testing.assert_allclose(g.detach().numpy(), expected, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(grad.numpy(), slope, rtol=1e-5)
        one = torch.tensor(1., requires_grad=True)
        (grad_one,) = torch.autograd.grad(tcmb.lollipop.ghl(one), one)
        assert float(tcmb.lollipop.ghl(one.detach())) == 0. and float(grad_one) == 1.
        assert np.isnan(float(jax.grad(jcmb.lollipop.ghl)(jnp.float64(1.))))
    finally:
        jax.config.update('jax_enable_x64', False)
