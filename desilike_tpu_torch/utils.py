"""Small host-side utilities: base class, name matching, safe expression evaluation.

Counterpart of ``desilike_tpu/utils.py``, limited to what the port imports
(``BaseClass``, ``is_sequence``, ``find_names``, ``evaluate``);
logging setup and the contour helpers wait for the samplers and profilers.
"""

import fnmatch
import logging
import re

import numpy as np
import torch


class BaseClass(object):
    """Mixin providing a class logger and shallow-copy helper."""

    @property
    def log(self):
        return logging.getLogger(self.__class__.__name__)

    def copy(self, **kwargs):
        import copy
        new = copy.copy(self)
        new.__dict__.update(kwargs)
        return new

    def deepcopy(self):
        import copy
        return copy.deepcopy(self)


def is_sequence(item):
    """True for list/tuple (not str/array)."""
    return isinstance(item, (list, tuple))


def find_names(allnames, name):
    """Match ``name`` (with * wildcards, or re.Pattern) against list of names;
    returns matching names in input order."""
    if is_sequence(name):
        toret = []
        for nn in name:
            toret += find_names(allnames, nn)
        return toret
    if isinstance(name, re.Pattern):
        return [nn for nn in allnames if name.fullmatch(nn)]
    pattern = fnmatch.translate(str(name))
    return [nn for nn in allnames if re.fullmatch(pattern, nn)]


def evaluate(value, locals=None):
    """Evaluate a python expression with np/torch in scope.

    Used for derived-parameter expressions ('{a} + {b}') after placeholder
    substitution; the values are batched tensors, so expressions use
    arithmetic or ``torch`` functions.
    """
    gl = {'np': np, 'torch': torch}
    gl.update(locals or {})
    return eval(value, {'__builtins__': {'abs': abs, 'min': min, 'max': max}}, gl)
