"""Host state carried across from the JAX package.

``state_from_numpy`` loads the host-side state of a ``desilike_tpu``
likelihood, as numpy arrays, into a built port likelihood, so that both
compute with identical tables. That separates "the per-evaluation compute
agrees" from "the host initialization agrees". The arrays are those that
``scripts/make_torch_port_reference.py`` writes: ``STATE_KEYS``. A
correlation-function observable carries the same ones: its window matrix
(onto the theory's s grid) and the tables of the template under its
theory's P(k) node. ``mlp_state_from_flax`` carries a JAX-trained MLP
emulator's weights, which the JAX package's emulator files do not hold;
``pk_emulator_weights_from_jax`` a JAX-trained cosmology emulator's.
The other
readers of the JAX package's ``interop.py`` (measured data, window files)
wait for ROADMAP A12.
"""

import numpy as np

STATE_KEYS = ('pk_dd_fid', 'pknow_dd_fid', 'flatdata', 'wmatrix', 'whiten', 'static_J')
"""Template tables on the template's k grid, the window matrix, the flat data
vector, the whitening factor L (L^T L = C^-1) and the static design matrix J
(nstatic, ndata) of the solved parameters that have one, in the solved
order. With one observable the first, second and fourth are stored under
these names; with several, once per observable as ``pk_dd_fid.0``,
``pk_dd_fid.1``, ... in the likelihood's order of observables (the
template and window of that observable), while ``flatdata``, ``whiten`` and
``static_J`` are the joint ones."""

_PER_OBSERVABLE = ('pk_dd_fid', 'pknow_dd_fid', 'wmatrix')


def state_keys(nobservables):
    """The names of the arrays that :func:`state_from_numpy` reads for a
    likelihood over ``nobservables`` observables."""
    if nobservables == 1:
        return list(STATE_KEYS)
    return ['{}.{:d}'.format(key, i) for i in range(nobservables) for key in _PER_OBSERVABLE] \
        + [key for key in STATE_KEYS if key not in _PER_OBSERVABLE]


def _checked(name, new, current):
    new = np.array(new, dtype='f8')
    if new.shape != np.shape(current):
        raise ValueError('{}: shape {} does not match the likelihood\'s {}'.format(name, new.shape, np.shape(current)))
    return new


def state_from_numpy(likelihood, arrays):
    """Load ``arrays`` (a mapping with the names of :func:`state_keys`) into
    the built likelihood ``likelihood``; shapes must match."""
    observables = likelihood.observables
    suffixes = [''] if len(observables) == 1 else ['.{:d}'.format(i) for i in range(len(observables))]
    loaded = []
    for observable, suffix in zip(observables, suffixes):
        window = observable.wmatrix
        template = window.theory.template
        loaded.append((window, template,
                       _checked('wmatrix' + suffix, arrays['wmatrix' + suffix], window.wmatrix),
                       _checked('pk_dd_fid' + suffix, arrays['pk_dd_fid' + suffix], template.pk_dd_fid),
                       _checked('pknow_dd_fid' + suffix, arrays['pknow_dd_fid' + suffix], template.pknow_dd_fid)))
    flatdata = _checked('flatdata', arrays['flatdata'], likelihood.flatdata)
    whiten = _checked('whiten', arrays['whiten'], likelihood._whiten)
    pipe = likelihood.pipeline
    solved = pipe.solved_params
    static_names = tuple(solved[i].name for i in likelihood._static_linear_indices(pipe, solved))
    static_J = _checked('static_J', arrays['static_J'], np.empty((len(static_names), likelihood.size)))
    for window, template, wmatrix, pk_dd, pknow_dd in loaded:
        template.set_fiducial_tables(pk_dd, pknow_dd)
        window.wmatrix = wmatrix
    start = 0
    for observable in observables:
        stop = start + len(observable.flatdata)
        observable.flatdata = flatdata[start:stop]
        start = stop
    likelihood.flatdata = flatdata
    likelihood._whiten = whiten
    likelihood._static_J = {static_names: static_J}
    likelihood.__dict__.pop('_logpost_fn', None)  # built on the old state
    return likelihood


def mlp_state_from_flax(params, norm):
    """The weights of a flax MLP of the JAX package's ``MLPEmulatorEngine``
    as the port's: ``params`` the flax parameters as nested numpy dicts
    (``{'Dense_i': {'kernel': (in, out), 'bias': (out,)}}``, the engine's
    ``_params['params']``), ``norm`` the engine's ``_norm`` (xm, xs, ym, ys).
    Returns the ``state_dict`` of ``emulators.MLP`` (``nn.Linear.weight`` is
    the transposed kernel, (out, in)) and the norm as float32 tensors, which
    ``MLPEmulatorEngine.set_weights`` takes."""
    import torch
    state = {}
    for i in range(len(params)):
        dense = params['Dense_{:d}'.format(i)]
        state['layers.{:d}.weight'.format(i)] = torch.as_tensor(np.asarray(dense['kernel'], dtype='f4').T.copy())
        state['layers.{:d}.bias'.format(i)] = torch.as_tensor(np.asarray(dense['bias'], dtype='f4'))
    return state, tuple(torch.as_tensor(np.asarray(a, dtype='f4')) for a in norm)


def pk_emulator_weights_from_jax(weights):
    """A cosmology-emulator weight dict of the JAX package
    (``desilike_tpu.cosmology.emulator.train_pk_emulator`` or
    ``load_weights``: 'param_names', the normalizations, 'k_grid',
    'z_grid', 'layers' as (W (in, out), b) pairs, ...) as the port's, which
    ``desilike_tpu_torch.cosmology.emulator`` and ``Cosmology(engine=
    'emulator', emulator=...)`` take: the same layout, as numpy arrays (the
    layers float32) and plain numbers, private keys dropped."""
    out = {}
    for key, value in weights.items():
        if key.startswith('_'):
            continue
        if key == 'layers':
            out[key] = [(np.asarray(W, dtype='f4'), np.asarray(b, dtype='f4')) for W, b in value]
        elif key == 'param_names':
            out[key] = tuple(str(name) for name in value)
        elif np.ndim(value):
            out[key] = np.asarray(value, dtype='f8')
        else:
            out[key] = value.item() if hasattr(value, 'item') else value
    return out
