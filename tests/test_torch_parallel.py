"""The port's chain mesh (``desilike_tpu_torch/parallel``) on the CPU.

The helpers against plain indexing and the JAX package's, the on-mesh
Gelman-Rubin against the host formula (1e-6) and against the JAX
package's ``chain_gelman_rubin`` on the same numpy draws (1e-5, the JAX
package's float32 against the port's float64), and each mesh-capable
sampler on a one-rank gloo world (``torch.distributed``, so the mesh's
collectives run): the JAX package's determinism contract
(``tests/test_parallel_samplers.py:45-90``), a mesh of one gives the same
chains as no mesh, bit for bit, the same seed and mesh give the same chains
again, and ``gelman_rubin_mesh`` is finite. The two-rank world is
``tests/test_torch_distributed.py``. Few enough tests that pytest-xdist's
``--dist loadfile`` hands this file out after ``tests/test_bindings.py``.
"""

import numpy as np
import pytest
import torch

from desilike_tpu_torch import samplers
from desilike_tpu_torch.parallel import (make_mesh, shard_batch, sharded_vmap_fn, fold_keys, chain_gelman_rubin,
                                         distributed)
from test_torch_sampler_steps import GaussianModel


@pytest.fixture(scope='module')
def gloo_world():
    """A world of one process over gloo, torn down after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    distributed.initialize(backend='gloo', timeout=120)
    yield make_mesh(1)
    distributed.shutdown()
    torch.set_num_threads(threads)


def host_gelman_rubin(x):
    nsteps = x.shape[0]
    W = x.var(axis=0, ddof=1).mean(axis=0)
    B = nsteps * x.mean(axis=0).var(axis=0, ddof=1)
    return np.sqrt(((nsteps - 1.) / nsteps * W + B / nsteps) / W)


def test_mesh_helpers_and_gelman_rubin():
    """Without a process group: a mesh of this process; more devices than
    the world raise; the shard, the sharded batch function and the keys;
    the Gelman-Rubin statistic against the host formula and the JAX
    package's."""
    import jax.numpy as jnp
    from desilike_tpu.parallel import chain_gelman_rubin as jax_chain_gelman_rubin
    mesh = make_mesh()
    assert mesh.size == 1 and mesh.axis_names == ('chains',) and mesh.group is None
    assert make_mesh(1).size == 1
    with pytest.raises(ValueError, match='2-device'):
        make_mesh(2)
    values = {'a': torch.arange(8.), 'b': torch.ones(8)}
    assert shard_batch(values, mesh)['a'].tolist() == list(range(8))
    assert distributed.local_chain_slice(8, mesh) == (0, 8)

    def fn(v):
        return -0.5 * (v['a'] ** 2 + v['b'] ** 2), {'sum': v['a'] + v['b'], 'static': torch.zeros(3)}

    lp, aux = sharded_vmap_fn(fn, mesh)(values)
    torch.testing.assert_close(lp, fn(values)[0], rtol=0., atol=0.)
    torch.testing.assert_close(aux['sum'], values['a'] + 1., rtol=0., atol=0.)
    keys = fold_keys(7, 16)
    assert keys.dtype == torch.int64 and len(set(keys.tolist())) == 16
    assert torch.equal(fold_keys(7, 8), keys[:8]) and not torch.equal(fold_keys(8, 16), keys)

    x = np.random.default_rng(3).normal(size=(200, 8, 3))
    gr = chain_gelman_rubin(torch.tensor(x)).numpy()
    np.testing.assert_allclose(gr, host_gelman_rubin(x), rtol=1e-6)
    np.testing.assert_allclose(chain_gelman_rubin(torch.tensor(x), mesh).numpy(), host_gelman_rubin(x), rtol=1e-6)
    np.testing.assert_allclose(gr, np.asarray(jax_chain_gelman_rubin(jnp.asarray(x))), rtol=1e-5)  # eager, float32


def _positions(chain, names=('a', 'b')):
    return np.stack([np.asarray(chain[n]) for n in names], axis=-1)


@pytest.mark.parametrize('sampler_name, kwargs, run_kwargs', [
    ('NUTSSampler', dict(nchains=8, max_depth=5), dict(nsteps=20, nwarmup=30)),
    ('MCMCSampler', dict(nchains=8), dict(nsteps=100)),
    ('HMCSampler', dict(nchains=8, nleapfrog=8), dict(nsteps=20, nwarmup=30)),
    ('EnsembleSampler', dict(nwalkers=32), dict(nsteps=50)),
    ('EnsembleSliceSampler', dict(nwalkers=16), dict(nsteps=10)),
    ('ChEESSampler', dict(nchains=32), dict(nsteps=20, nwarmup=30)),
    ('NUTSSampler', dict(nchains=32, max_depth=5, trajectory='jitter'), dict(nsteps=20, nwarmup=30)),
    ('MCLMCSampler', dict(nchains=8), dict(nsteps=30, nwarmup=30)),
    ('NestedSampler', dict(nlive=64), dict(dlogz=0.5)),
], ids=['nuts', 'mcmc', 'hmc', 'ensemble', 'slice', 'chees', 'nuts_jitter', 'mclmc', 'nested'])
def test_mesh_sharded_chains(gloo_world, sampler_name, kwargs, run_kwargs):
    """On a one-rank gloo world: the mesh of one gives the chains of no
    mesh, bit for bit (and the nested sampler the same evidence); the same
    seed and mesh give them again; the on-mesh Gelman-Rubin is finite
    where the JAX package records one (MCMC, HMC, NUTS, ChEES) and within
    1e-6 of the host formula on the gathered records."""
    cls = getattr(samplers, sampler_name)
    chains, diagnostics = {}, {}
    for label, mesh in [('none', None), ('mesh', gloo_world), ('rerun', gloo_world)]:
        sampler = cls(GaussianModel(device='cpu'), seed=123, mesh=mesh, mpicomm=object(), **kwargs)
        chains[label] = sampler.run(**run_kwargs)
        diagnostics[label] = sampler.diagnostics
    assert gloo_world.group is not None and gloo_world.size == 1
    ref = _positions(chains['none'])
    np.testing.assert_array_equal(_positions(chains['mesh']), ref, err_msg='1-rank mesh differs from unsharded')
    np.testing.assert_array_equal(_positions(chains['rerun']), ref, err_msg='same seed+mesh not reproducible')
    if sampler_name == 'NestedSampler':
        assert diagnostics['mesh']['logz'] == diagnostics['none']['logz']
    if sampler_name in ('NUTSSampler', 'MCMCSampler', 'HMCSampler', 'ChEESSampler'):
        gr = diagnostics['mesh']['gelman_rubin_mesh']
        assert np.all(np.isfinite(gr))
        np.testing.assert_allclose(gr, host_gelman_rubin(ref.astype('f8')), rtol=1e-6)
