"""Installer: where the data files of the external likelihoods live.

Counterpart of ``desilike_tpu/install.py``, with the same configuration
file (``~/.desilike_tpu/config.yaml``) and environment variable
(``DESILIKE_TPU_DATA_DIR``), so that one data directory serves both
packages. Every theory is in the package, so the Installer only manages
where user-provided data files (supernova compilations, window matrices,
Planck and ACT products) live.

Likelihoods with readers of real products (the CMB family, the supernova
compilations) resolve their data through :func:`installed_data_dir` when
called with neither ``data=`` nor ``data_dir=``. The base directory comes
from, in order: the ``DESILIKE_TPU_DATA_DIR`` environment variable, the
configuration file, then ``~/.desilike_tpu/data``.
"""

import os

import yaml

from .utils import BaseClass


CONFIG_FN = os.path.expanduser('~/.desilike_tpu/config.yaml')
DATA_DIR_ENV = 'DESILIKE_TPU_DATA_DIR'


class Installer(BaseClass):

    def __init__(self, data_dir=None, config_fn=CONFIG_FN, reinstall=False):
        # reinstall is accepted for the reference's interface: with no download machinery there is nothing
        # to reinstall, but install hooks may read the flag
        self.config_fn = config_fn
        self.reinstall = bool(reinstall)
        self.config = {}
        if os.path.exists(config_fn):
            with open(config_fn, 'r') as f:
                self.config = yaml.safe_load(f) or {}
        if data_dir is not None:
            self.config['data_dir'] = str(data_dir)

    def data_dir(self, section=None):
        """The base data directory, or the directory of ``section``: a
        ``{section: {data_dir: ...}}`` entry of the configuration if present,
        else ``<base>/<section>``."""
        base = os.environ.get(DATA_DIR_ENV) or self.config.get('data_dir', os.path.expanduser('~/.desilike_tpu/data'))
        if section is None:
            return base
        override = self.config.get(section)
        if isinstance(override, dict) and override.get('data_dir'):
            return str(override['data_dir'])
        return os.path.join(base, section)

    def data_fn(self, *names):
        return os.path.join(self.data_dir(), *names)

    def get(self, name, default=None):
        """A configuration entry."""
        return self.config.get(name, default)

    @property
    def profile_fn(self):
        """The shell profile the reference exports its configuration to (kept
        for its interface; nothing is written there)."""
        return os.path.join(os.path.dirname(self.config_fn), 'profile.sh')

    def write(self):
        os.makedirs(os.path.dirname(self.config_fn), exist_ok=True)
        with open(self.config_fn, 'w') as f:
            yaml.safe_dump(self.config, f)
        return self

    def __call__(self, obj):
        """Run ``obj.install(self)`` if it is defined (the reference's
        calculator install hook)."""
        install = getattr(obj, 'install', None)
        if callable(install):
            install(self)
        return obj

    def download(self, url, target=None):
        raise RuntimeError('this build downloads nothing; place the file expected at {} into the data directory '
                           '{} by hand'.format(url, self.data_dir()))


def installed_data_dir(section):
    """``Installer().data_dir(section)`` if that directory exists, else
    ``None``: the lookup a likelihood's ``initialize`` makes before its
    "provide data= or data_dir=" error."""
    path = Installer().data_dir(section)
    return path if os.path.isdir(path) else None
