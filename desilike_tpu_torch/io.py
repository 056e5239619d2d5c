"""YAML configuration: build calculators and likelihoods from config files.

Counterpart of ``desilike_tpu/io.py`` (reference io.py:12-377, BaseConfig
and its extended YAML dialect):

- ``e'np.arange(0.02, 0.3, 0.005)'`` evaluated expressions;
- a top-level ``class:`` key selecting the calculator, its ``init:``
  arguments and its ``params:`` updates;
- multi-document files indexed by class name.

A value that is itself a ``{class: ...}`` mapping, or a list of them, is
built first, so one file describes a whole likelihood: its observables,
their theories and templates, and its footprints.
"""

import re

import yaml

from .utils import evaluate


def _convert(value):
    if isinstance(value, str):
        match = re.match(r"e'(.*)'$", value)
        if match:
            return evaluate(match.group(1))
    if isinstance(value, dict):
        return {k: _convert(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_convert(v) for v in value]
    return value


class BaseConfig(dict):
    """Dict with YAML loading and the dialect's expressions evaluated
    (reference io.py:67). ``index`` picks the document of a multi-document
    file whose ``class`` is that name."""

    def __init__(self, data=None, index=None):
        super().__init__()
        if isinstance(data, str):
            data = self._load_yaml(data, index=index)
        if data:
            self.update(_convert(dict(data)))

    @staticmethod
    def _load_yaml(filename, index=None):
        with open(filename, 'r') as f:
            docs = list(yaml.safe_load_all(f))
        if index is None:
            return docs[0]
        for doc in docs:
            if doc and doc.get('class') == index:
                return doc
        raise KeyError('class {} not found in {}'.format(index, filename))


_REGISTRY = None


def calculator_registry():
    """Name -> class of every calculator and footprint the port exports."""
    global _REGISTRY
    if _REGISTRY is None:
        import importlib
        from .core import Calculator
        from .observables.covariance import BaseFootprint
        modules = ['desilike_tpu_torch.theories', 'desilike_tpu_torch.observables',
                   'desilike_tpu_torch.likelihoods', 'desilike_tpu_torch.likelihoods.cmb',
                   'desilike_tpu_torch.theories.ept', 'desilike_tpu_torch.theories.full_shape',
                   'desilike_tpu_torch.theories.extractors']
        registry = {}
        for mod in modules:
            module = importlib.import_module(mod)
            for name in dir(module):
                obj = getattr(module, name)
                if isinstance(obj, type) and issubclass(obj, (Calculator, BaseFootprint)):
                    registry[name] = obj
        _REGISTRY = registry
    return _REGISTRY


def _build(value):
    """A ``{class: ...}`` mapping built, a list of them built item by item,
    anything else as it is."""
    if isinstance(value, dict) and 'class' in value:
        return from_config(value)
    if isinstance(value, list):
        return [_build(item) for item in value]
    return value


def from_config(config, index=None, **kwargs):
    """Instantiate a calculator (or a likelihood) from a config dict or YAML
    path::

        {class: DampedBAOWigglesTracerPowerSpectrumMultipoles,
         init: {ells: [0, 2], k: "e'np.linspace(0.02, 0.3, 29)'"},
         params: {'al*': {derived: .marg}}}

    ``kwargs`` update the top-level ``init`` (e.g. ``device='cpu'``).
    """
    config = BaseConfig(config, index=index)
    clsname = config.get('class')
    if clsname is None:
        raise ValueError('config must provide a "class" key')
    cls = calculator_registry()[clsname]
    init = dict(config.get('init', {}) or {})
    init.update(kwargs)
    params = config.get('params', None)
    if params:
        init['params'] = params
    init = {key: _build(value) for key, value in init.items()}
    return cls(**init)
