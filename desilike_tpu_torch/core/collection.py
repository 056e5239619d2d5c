"""CollectionCalculator: a list of calculators evaluated as one node.

The part of ``desilike_tpu/core/collection.py`` that
``SNWeightedPowerSpectrumLikelihood`` uses; the rest of that module (the
batch-evaluation facade ``vmap``) is ROADMAP A17.
"""

from .calculator import Calculator


class CollectionCalculator(Calculator):
    """Treats a list of calculators as one: their states are exposed as
    '{i}_{name}'."""

    def initialize(self, calculators=None):
        self.calculators = list(calculators or [])
        self.requires = list(self.calculators)

    def calculate(self, **params):
        pass

    def __getstate__(self):
        state = {}
        for i, calc in enumerate(self.calculators):
            for name, value in calc.__getstate__().items():
                state['{}_{}'.format(i, name)] = value
        return state

    def __len__(self):
        return len(self.calculators)

    def __iter__(self):
        return iter(self.calculators)

    def __getitem__(self, i):
        return self.calculators[i]
