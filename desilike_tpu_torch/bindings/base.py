"""Binding generator base and what the host wrappers share (counterpart of
``desilike_tpu/bindings/base.py``)."""

import os

import numpy as np
import torch

from ..utils import BaseClass
from .. import config


class BaseLikelihoodGenerator(BaseClass):
    """Writes a standalone module exposing a desilike_tpu_torch likelihood to a
    host code.

    Parameters
    ----------
    factory : module-level function returning the likelihood, or its
        ``'module:function'`` name (the generated module imports it).
    """

    def __init__(self, factory):
        if isinstance(factory, str):
            self.factory_module, self.factory_name = factory.split(':')
        else:
            self.factory_module = factory.__module__
            self.factory_name = factory.__qualname__
            self._factory = factory

    def likelihood(self):
        if not hasattr(self, '_factory'):
            import importlib
            self._factory = getattr(importlib.import_module(self.factory_module), self.factory_name)
        return self._factory()

    def varied_params(self):
        like = self.likelihood()
        return like.pipeline.varied_params

    def header(self):
        return ('# Auto-generated by desilike_tpu_torch.bindings: do not edit.\n'
                'import numpy as np\n'
                'import importlib\n\n'
                "_factory = getattr(importlib.import_module('{module}'), '{name}')\n"
                '_like = None\n\n'
                'def _get_like():\n'
                '    global _like\n'
                '    if _like is None:\n'
                '        _like = _factory()\n'
                '        _like._compiled_logpost = _like.logpost_fn()\n'
                '    return _like\n').format(module=self.factory_module, name=self.factory_name)

    def write(self, filename):
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        with open(filename, 'w') as f:
            f.write(self.generate())
        return filename


def point_loglikelihood(like, values, inject=None, host=None):
    """The log-likelihood of ``like`` at one host point: ``values`` {full
    parameter name: number}, each made a batch of one on the likelihood's
    device; with external nodes in the pipeline, ``inject(like, host)``
    first sets the host code's cosmology into them and their tables join the
    call. Returns a float (the host code applies the priors itself)."""
    pipe = like.pipeline
    device, dtype = pipe.device, config.get_dtype()
    point = {name: torch.tensor([float(value)], dtype=dtype, device=device) for name, value in values.items()}
    if inject is not None and pipe.external_nodes():
        inject(like, host)
        point.update(pipe.external_values())
    fn = getattr(like, '_compiled_logpost', None) or like.logpost_fn()
    with torch.no_grad():
        _, aux = fn(point)
    return float(aux['loglikelihood'][0])


def regrid_pk(kh, zpk, lnpk, zpk_out, k_out):
    """Regrid a host code's ln pk table (h-units) onto the external node's
    (zpk_out, k_out) grids: linear in z rows, linear in ln k."""
    kh = np.asarray(kh, dtype='f8')
    zpk = np.asarray(zpk, dtype='f8')
    lnpk = np.atleast_2d(np.asarray(lnpk, dtype='f8'))
    rows = np.empty((len(zpk_out), len(k_out)))
    for i, zz in enumerate(zpk_out):
        if len(zpk) > 1:
            iz = int(np.clip(np.searchsorted(zpk, zz) - 1, 0, len(zpk) - 2))
            t = float(np.clip((zz - zpk[iz]) / (zpk[iz + 1] - zpk[iz]), 0., 1.))
            row = (1. - t) * lnpk[iz] + t * lnpk[iz + 1]
        else:
            row = lnpk[0]
        rows[i] = np.interp(np.log(np.asarray(k_out)), np.log(kh), row)
    return np.exp(rows)
