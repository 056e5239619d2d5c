"""The port's process group (``desilike_tpu_torch/parallel/distributed.py``).

The single-process helpers of ``tests/test_distributed.py`` on the port,
and a two-process world over gloo on the CPU, in subprocesses with their
own 120 s limit (the JAX package's two-process run,
``tests/test_distributed.py:75-97``): the local slices and the assembled
batch, the sharded batch function, the on-mesh Gelman-Rubin against the
host formula on the gathered draws (1e-6), and samplers whose chains lie
over both ranks. Across layouts bits are not promised (each rank's batch
is half the size, and a change in the last bit is amplified by the
accept/reject branches), so the check against no mesh is the JAX
package's moments check; the ranks must agree bit for bit, and a second
run of the same (seed, world) must repeat the first.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from desilike_tpu_torch.parallel import distributed

_WORKER = textwrap.dedent("""
    import os, sys, hashlib
    sys.path.insert(0, os.environ['REPO_DIR'])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from desilike_tpu_torch.parallel import distributed, sharded_vmap_fn, chain_gelman_rubin
    from desilike_tpu_torch import samplers
    from desilike_tpu_torch.likelihoods.base import BaseGaussianLikelihood

    XGRID = np.linspace(-1, 1, 50)

    class GaussianModel(BaseGaussianLikelihood):
        # the 2-parameter linear model of tests/test_torch_sampler_steps.py
        _params = dict(BaseGaussianLikelihood._params,
                       a=dict(value=1.0, prior=dict(limits=[-4, 4]), ref=dict(dist='norm', loc=1.0, scale=0.2)),
                       b=dict(value=-0.5, prior=dict(limits=[-4, 4]), ref=dict(dist='norm', loc=-0.5, scale=0.2)))

        def initialize(self):
            self.x = XGRID
            self.flatdata = 1.0 * XGRID - 0.5
            self._set_whitening(np.eye(50) * 0.04)

        def flattheory(self):
            return self._a[..., None] * self.const('x') + self._b[..., None]

        def calculate(self, a=1., b=0.):
            self._a, self._b = a, b
            super().calculate()

    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert distributed.initialize(coordinator_address=coord, num_processes=nproc, process_id=pid,
                                  backend='gloo', timeout=100) == (pid, nproc)
    mesh = distributed.global_mesh()
    assert mesh.size == nproc and mesh.rank == pid

    # every process contributes its local block; the batch spans the processes
    nchains = 8
    lo, hi = distributed.local_chain_slice(nchains, mesh)
    assert hi - lo == nchains // nproc
    x = distributed.from_process_local(np.arange(lo, hi, dtype='f8')[:, None] * np.ones((1, 3)), mesh)
    assert float(x.sum()) == 3. * sum(range(nchains)), float(x.sum())
    assert float(mesh.sum(torch.tensor(float(pid + 1)))) == nproc * (nproc + 1) / 2

    # the sharded likelihood batch
    theta = torch.linspace(0., 1., nchains * 3).reshape(nchains, 3)
    fn = sharded_vmap_fn(lambda v: (-0.5 * (v['t'] ** 2).sum(-1), {'s': v['t'].sum(-1)}), mesh)
    lp, aux = fn({'t': theta})
    assert lp.shape == (nchains,) and torch.equal(lp, -0.5 * (theta ** 2).sum(-1))
    assert distributed.process_allgather(lp[lo:hi], mesh).shape == (nchains,)

    # the on-mesh Gelman-Rubin: this rank's chains, the sums reduced
    draws = np.random.default_rng(3).normal(size=(200, 8, 3))
    gr = chain_gelman_rubin(torch.tensor(draws[:, lo:hi]), mesh).numpy()
    W = draws.var(axis=0, ddof=1).mean(axis=0)
    B = 200 * draws.mean(axis=0).var(axis=0, ddof=1)
    np.testing.assert_allclose(gr, np.sqrt((199. / 200. * W + B / 200.) / W), rtol=1e-6)

    cases = [('MCMCSampler', dict(nchains=8), dict(nsteps=200)),
             ('ChEESSampler', dict(nchains=32), dict(nsteps=30, nwarmup=40)),
             ('NUTSSampler', dict(nchains=8, max_depth=5), dict(nsteps=30, nwarmup=40)),
             ('EnsembleSampler', dict(nwalkers=32), dict(nsteps=100))]
    for name, kwargs, run_kwargs in cases:
        positions = {}
        for label, m in [('none', None), ('mesh', mesh), ('rerun', mesh)]:
            sampler = getattr(samplers, name)(GaussianModel(device='cpu'), seed=123, mesh=m, **kwargs)
            chain = sampler.run(**run_kwargs)
            positions[label] = np.stack([np.asarray(chain[n]) for n in ('a', 'b')], axis=-1)
            if m is not None and name != 'EnsembleSampler':
                assert np.all(np.isfinite(sampler.diagnostics['gelman_rubin_mesh'])), name
        ref, p2 = positions['none'], positions['mesh']
        assert p2.shape == ref.shape, (name, p2.shape, ref.shape)
        np.testing.assert_array_equal(positions['rerun'], p2, err_msg=name + ': same seed+world not reproducible')
        digest = hashlib.sha1(np.ascontiguousarray(p2).tobytes()).hexdigest()
        digests = [None] * nproc
        torch.distributed.all_gather_object(digests, digest)
        assert len(set(digests)) == 1, (name, digests)
        n = ref.shape[0] // 2
        for i in range(ref.shape[-1]):
            a, b = ref[n:, ..., i].ravel(), p2[n:, ..., i].ravel()
            assert abs(a.mean() - b.mean()) < 5. * b.std() / np.sqrt(50.), (name, i)
            assert 0.5 < a.std() / b.std() < 2., (name, i)
        print('CASE_OK', name, pid, flush=True)
    distributed.sync_global_devices('done')
    distributed.shutdown()
    print('WORKER_OK', pid, flush=True)
""")


def test_single_process_helpers():
    """The same API with no process group: one process, the whole batch."""
    assert not distributed.is_initialized()
    mesh = distributed.global_mesh()
    assert (mesh.rank, mesh.size) == (0, 1)
    lo, hi = distributed.local_chain_slice(8, mesh)
    assert (lo, hi) == (0, 8)
    x = distributed.from_process_local(np.ones((8, 2)), mesh)
    assert isinstance(x, torch.Tensor) and x.shape == (8, 2)
    got = distributed.process_allgather(x)
    assert isinstance(got, np.ndarray) and got.shape == (8, 2)
    distributed.sync_global_devices('test')


def test_two_process_mesh(tmp_path):
    """Two processes over gloo: the helpers, the sharded batch, the on-mesh
    Gelman-Rubin, and MCMC, ChEES, NUTS and the stretch ensemble with
    their chains over both ranks (ranks agree, a rerun repeats, moments
    against no mesh)."""
    worker = tmp_path / 'worker.py'
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    coord = 'localhost:{}'.format(port)
    env = dict(os.environ, REPO_DIR=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), '2', coord], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker {} failed:\n{}'.format(i, out)
        assert 'WORKER_OK {}'.format(i) in out
