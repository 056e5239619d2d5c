"""Weak-lensing theory wrappers.

Counterpart of ``desilike_tpu/theories/weak_lensing.py``: the DES Y3 3x2pt
theory vector computed by a cosmosis LikelihoodPipeline, as a pipeline
node. A host-code wrapper (cosmosis runs on the CPU), gated on cosmosis;
it mainly carries the parameter-name translation between this package and
the cosmosis datablock sections.
"""

import os

import numpy as np
import torch

from ..core import Calculator


# parameter name -> (cosmosis section, cosmosis name)
DES_Y3_PARAM_MAP = {
    'H0': ('cosmological_parameters', 'hubble'),
    'h': ('cosmological_parameters', 'h0'),
    'A_s': ('cosmological_parameters', 'A_s'),
    'logA': ('cosmological_parameters', 'log1e10As'),
    'sigma8': ('cosmological_parameters', 'sigma_8'),
    'n_s': ('cosmological_parameters', 'n_s'),
    'omega_b': ('cosmological_parameters', 'ombh2'),
    'Omega_b': ('cosmological_parameters', 'omega_b'),
    'omega_cdm': ('cosmological_parameters', 'omch2'),
    'Omega_cdm': ('cosmological_parameters', 'omega_c'),
    'Omega_ncdm': ('cosmological_parameters', 'omega_nu'),
    'omega_ncdm': ('cosmological_parameters', 'omnuh2'),
    'm_ncdm': ('cosmological_parameters', 'mnu'),
    'Omega_k': ('cosmological_parameters', 'omega_k'),
    'Omega_m': ('cosmological_parameters', 'omega_m'),
}


def _nuisance_map():
    """DES Y3 3x2pt nuisance blocks: shear calibration, photo-z shifts and
    widths, lens biases, magnification, intrinsic alignments."""
    out = {}
    for i in range(1, 5):
        out['shear_calibration_parameters_m{:d}'.format(i)] = ('shear_calibration_parameters', 'm{:d}'.format(i))
        out['wl_photo_z_errors_bias_{:d}'.format(i)] = ('wl_photo_z_errors_bias', 'bias_{:d}'.format(i))
    for i in range(1, 7):
        out['lens_photoz_errors_bias_{:d}'.format(i)] = ('lens_photoz_errors', 'bias_{:d}'.format(i))
        out['lens_photoz_errors_width_{:d}'.format(i)] = ('lens_photoz_errors', 'width_{:d}'.format(i))
        out['bias_lens_b{:d}'.format(i)] = ('bias_lens', 'b{:d}'.format(i))
        out['mag_alpha_lens_mag_alpha_lens_{:d}'.format(i)] = ('mag_alpha_lens', 'mag_alpha_lens_{:d}'.format(i))
    for name in ('z_piv', 'a1', 'alpha1', 'a2', 'alpha2', 'bias_ta'):
        out['intrinsic_alignment_parameters_' + name] = ('intrinsic_alignment_parameters', name)
    return out


DES_Y3_PARAM_MAP.update(_nuisance_map())


class DESY3Theory(Calculator):
    """DES Y3 3x2pt theory vector from a cosmosis LikelihoodPipeline
    (reference theories/weak_lensing/des_y3.py:6).

    Parameters
    ----------
    cosmo : Cosmology node whose varied parameters are forwarded.
    ini_file_dir, ini_file_name : str
        Location of the cosmosis pipeline ini.
    cosmosis_dir : str
        COSMOSIS_STD_DIR for the pipeline modules.
    param_map : dict, optional
        Overrides or extends the default translation to datablock names.
    """

    _state_attrs = ['theory_vector']
    # host code: the pipeline memoizes it on its parameter footprint, so that moves of the other parameters skip it
    _host_eval = True

    def initialize(self, cosmo=None, ini_file_dir=None, ini_file_name=None, cosmosis_dir=None, param_map=None):
        try:
            from cosmosis.runtime.pipeline import LikelihoodPipeline
        except ImportError as exc:
            raise ImportError('DESY3Theory requires cosmosis (a CPU host code); install it in the binding '
                              'environment') from exc
        self.cosmo = cosmo
        self.param_map = dict(DES_Y3_PARAM_MAP)
        if param_map:
            self.param_map.update(param_map)
        ini_file = os.path.join(ini_file_dir, ini_file_name)
        environ_bak = os.environ.copy()
        try:
            os.environ['COSMOSIS_STD_DIR'] = str(cosmosis_dir)
            os.environ['INI_FILE_DIR'] = str(ini_file_dir)
            self.cosmosis_pipe = LikelihoodPipeline(ini_file)
            self.cosmosis_data = self.cosmosis_pipe.build_starting_block([])
        finally:
            os.environ.clear()
            os.environ.update(environ_bak)

    def calculate(self, **params):
        # the host-code boundary: one cosmosis run a chain, from the cosmology node's values on the host
        varied = [param for param in self.cosmo.params if param.varied]
        values = {param.basename: torch.as_tensor(self.cosmo.p[param.basename]).detach().cpu().double().reshape(-1)
                  for param in varied}
        batch = max([len(v) for v in values.values()] + [1])
        vectors = []
        for b in range(batch):
            for param in varied:
                section, name = self.param_map[param.basename]
                column = values[param.basename]
                self.cosmosis_data[section, name] = float(column[b if len(column) > 1 else 0])
            self.cosmosis_pipe.run(self.cosmosis_data)
            vectors.append(np.asarray(self.cosmosis_data['data_vector', '2pt_theory'], dtype='f8'))
        self.theory_vector = torch.as_tensor(np.stack(vectors), dtype=self.dtype, device=self.device)

    def get(self):
        return self.theory_vector
