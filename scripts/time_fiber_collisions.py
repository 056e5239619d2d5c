"""Time the host-side build of the fiber-collision kernels at config 3f's
grid: the window's 350 input k a multipole (0.001 to 0.35 h/Mpc),
multipoles (0, 2, 4), as the window folds them (output grid = input grid).
The general kernel (a sum of top-hats, no k Dfc << 1 approximation) loops
in Python over the output k; the top-hat one is closed-form. Both run once,
at initialization, in float64 numpy on the CPU.

Run from the repository root: ``python scripts/time_fiber_collisions.py``.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from desilike_tpu_torch import Calculator  # noqa: E402
from desilike_tpu_torch.observables import (TopHatFiberCollisionsPowerSpectrumMultipoles,  # noqa: E402
                                            FiberCollisionsPowerSpectrumMultipoles)


class GridTheory(Calculator):
    """A theory that is its k grid and multipoles: the kernels read nothing else."""

    def initialize(self, k=None, ells=(0, 2, 4)):
        self.k, self.ells = np.asarray(k, dtype='f8'), tuple(ells)


def main():
    kin = chip_smoke.files_layout()['kin']
    for label, cls, kwargs in (('top-hat', TopHatFiberCollisionsPowerSpectrumMultipoles, chip_smoke.FILES_FIBER_COLLISIONS),
                               ('general', FiberCollisionsPowerSpectrumMultipoles,
                                dict(sep=np.linspace(0., 1., 6), kernel=np.array([0.5, 0.45, 0.4, 0.3, 0.2, 0.1])))):
        t0 = time.perf_counter()
        calc = cls(k=kin, ells=chip_smoke.FILES_ELLS, theory=GridTheory(k=kin, ells=chip_smoke.FILES_ELLS), **kwargs)
        calc.runtime_info.initialize()
        print('{} fiber-collision kernel on {} x {} k, multipoles {}: built in {:.2f} s (host, float64); '
              'kernel {}'.format(label, kin.size, kin.size, chip_smoke.FILES_ELLS, time.perf_counter() - t0,
                                 calc.kernel_correlated.shape))


if __name__ == '__main__':
    main()
