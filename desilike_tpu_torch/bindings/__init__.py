"""Bindings: expose desilike_tpu_torch likelihoods inside host inference codes.

Counterpart of ``desilike_tpu/bindings``. Two entry points a host code:

- the *generator* writes a standalone module that rebuilds the likelihood
  (from a factory callable) and adapts the parameters;
- the *factory* builds the same wrapper class at run time.

The host code varies the sampled parameters and calls the likelihood at one
point at a time: a batch of one on the likelihood's device. Its cosmology
(a cobaya provider, a cosmosis datablock, a classy instance) is injected
into the ``Cosmology(engine='external')`` nodes of the pipeline before each
call, the tables copied to the device once an injection. The host packages
are imported only when a wrapper class is built or a generated module runs.
"""

from .base import BaseLikelihoodGenerator, regrid_pk, point_loglikelihood
from .cobaya import (CobayaLikelihoodGenerator, CobayaLikelihoodFactory, desilike_to_cobaya_params,
                     cobaya_requirements, gather_cobaya_products, inject_from_cobaya)
from .cosmosis import (CosmoSISLikelihoodGenerator, CosmoSISLikelihoodFactory, gather_cosmosis_products,
                       growth_from_pk_table, inject_from_cosmosis)
from .montepython import (MontePythonLikelihoodGenerator, MontePythonLikelihoodFactory, gather_classy_products,
                          inject_from_classy)
