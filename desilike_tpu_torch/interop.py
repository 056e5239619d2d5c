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

The readers of measured products, counterparts of the JAX package's
``interop.py``: pypower-style power spectrum multipoles and window
matrices (objects, their ``.npy`` state dicts, or canonical dicts, and
paths to them; glob patterns for mocks), pycorr-style correlation function
multipoles, and :func:`load_source` and :func:`get_params_in_source` for
chains and profiles. Host-side numpy: the
manipulations pypower's methods do (rebin, slice, projection selection,
re-gridding, the shot-noise response) are on plain arrays.
"""

import glob as _glob
import os

import numpy as np

from .utils import is_sequence

STATE_KEYS = ('pk_dd_fid', 'pknow_dd_fid', 'flatdata', 'wmatrix', 'whiten', 'static_J')
"""Template tables on the template's k grid, the window matrix, the flat data
vector, the whitening factor L (L^T L = C^-1, with the mock factors: the
Hartlap factor and, as the JAX package's built ``logpost_fn`` leaves it, the
Percival factor) and the static design matrix J (nstatic, ndata) of the
solved parameters that have one, in the solved order. With one observable
the first, second and fourth are stored under these names; with several,
once per observable as ``pk_dd_fid.0``, ``pk_dd_fid.1``, ... in the
likelihood's order of observables (the template and window of that
observable), while ``flatdata``, ``whiten`` and ``static_J`` are the joint
ones. An ``offset`` (per observable, as the window) is optional: the
constant that the window adds per evaluation (the folded fiber-collision
term and the shot-noise response); where it is absent the window's own is
kept."""

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
        offset = arrays.get('offset' + suffix)
        if offset is not None:
            offset = _checked('offset' + suffix, offset, np.empty(window.wmatrix.shape[0]))
        loaded.append((window, template,
                       _checked('wmatrix' + suffix, arrays['wmatrix' + suffix], window.wmatrix),
                       _checked('pk_dd_fid' + suffix, arrays['pk_dd_fid' + suffix], template.pk_dd_fid),
                       _checked('pknow_dd_fid' + suffix, arrays['pknow_dd_fid' + suffix], template.pknow_dd_fid),
                       offset))
    flatdata = _checked('flatdata', arrays['flatdata'], likelihood.flatdata)
    whiten = _checked('whiten', arrays['whiten'], likelihood._whiten)
    pipe = likelihood.pipeline
    solved = pipe.solved_params
    static_names = tuple(solved[i].name for i in likelihood._static_linear_indices(pipe, solved))
    static_J = _checked('static_J', arrays['static_J'], np.empty((len(static_names), likelihood.size)))
    for window, template, wmatrix, pk_dd, pknow_dd, offset in loaded:
        template.set_fiducial_tables(pk_dd, pknow_dd)
        window.wmatrix = wmatrix
        if offset is not None:
            window.offset = offset
    start = 0
    for observable in observables:
        stop = start + len(observable.flatdata)
        observable.flatdata = flatdata[start:stop]
        start = stop
    likelihood.flatdata = flatdata
    # the whitening as the JAX package's logpost_fn leaves it: its Percival factor, which the port applies in
    # logpost_fn from the unscaled whitening, is divided out of the unscaled one
    factor = likelihood._percival_factor(likelihood._nvaried_and_solved(pipe))
    likelihood._whiten_base = whiten * np.sqrt(factor)
    likelihood._whiten, likelihood._mock_factor = whiten, factor
    likelihood._static_J = {static_names: static_J}
    likelihood.__dict__.pop('_logpost_fn', None)  # built on the old state
    return likelihood


def is_path(obj):
    return isinstance(obj, (str, os.PathLike))


def matrix_lininterp(xnew, xold):
    """(len(xold), len(xnew)) matrix M with f(xold) ~ M @ f(xnew): linear
    interpolation weights (the window's input-grid re-gridding)."""
    from .observables.window import matrix_lininterp as lininterp
    return lininterp(xold, xnew)


# --- measured power spectrum multipoles ---

def _state_of(obj):
    """Extract a plain state dict from a .npy/.npz path or object."""
    if is_path(obj):
        fn = str(obj)
        if fn.endswith('.npz'):
            return dict(np.load(fn, allow_pickle=True))
        loaded = np.load(fn, allow_pickle=True)
        if isinstance(loaded, np.ndarray) and loaded.dtype == object:
            return loaded[()]
        return loaded
    return obj


def read_power_multipoles(source):
    """Normalize one power spectrum measurement to
    dict(k (nells, nk), edges (nk+1,), ells, power (nells, nk), shotnoise).

    Accepts: pypower-style objects (attributes k, power, ells, edges,
    shotnoise / shotnoise_nonorm+wnorm), their .npy state dicts, our
    canonical dict {'k', 'power', 'ells', 'edges', 'shotnoise'}, or paths to
    any of these.
    """
    obj = _state_of(source)
    if isinstance(obj, dict):
        state = obj
        get = state.get
        power = np.asarray(get('power') if 'power' in state else
                           np.asarray(state['power_nonorm']) / state.get('wnorm', 1.))
        power = np.real(power)
        ells = tuple(int(ell) for ell in np.asarray(state['ells']).tolist())
        k = np.asarray(state['k'], dtype='f8')
        edges = state.get('edges', None)
        if edges is not None:
            edges = np.asarray(edges[0] if np.ndim(edges) > 1 or isinstance(edges, (list, tuple)) else edges, dtype='f8')
        shotnoise = state.get('shotnoise', None)
        if shotnoise is None and 'shotnoise_nonorm' in state:
            shotnoise = float(np.asarray(state['shotnoise_nonorm'])) / float(state.get('wnorm', 1.))
        if 'power' not in state and shotnoise:
            # pypower power_nonorm convention carries shot noise in ell=0
            power = power.copy()
            power[list(ells).index(0)] -= shotnoise
    else:
        # duck-typed pypower poles object
        power = np.real(np.asarray(obj.power))
        ells = tuple(int(ell) for ell in obj.ells)
        k = np.asarray(obj.k, dtype='f8')
        edges = np.asarray(obj.edges[0], dtype='f8') if getattr(obj, 'edges', None) is not None else None
        shotnoise = float(getattr(obj, 'shotnoise', 0.))
    if k.ndim == 1:
        k = np.tile(k, (len(ells), 1))
    return dict(k=k, edges=edges, ells=ells, power=power,
                shotnoise=float(shotnoise) if shotnoise is not None else None)


def select_multipoles(meas, klim=None):
    """Apply {ell: (kmin, kmax[, step])} selection with rebinning; returns
    (list_k, list_kedges, ells, flat_data, shotnoise) in the observable's
    layout."""
    if klim is None:
        klim = {ell: (0., np.inf) for ell in meas['ells']}
    list_k, list_kedges, list_y, ells = [], [], [], []
    for ell, lim in klim.items():
        i = list(meas['ells']).index(int(ell))
        k = meas['k'][i]
        y = meas['power'][i]
        edges = meas['edges']
        if edges is None:
            mid = (k[1:] + k[:-1]) / 2.
            edges = np.concatenate([[2 * k[0] - mid[0]], mid, [2 * k[-1] - mid[-1]]])
        lo, hi, *step = lim
        rebin = 1
        if step and step[0]:
            rebin = int(np.rint(step[0] / np.diff(edges).mean()))
        if rebin > 1:
            n = (len(k) // rebin) * rebin
            k = k[:n].reshape(-1, rebin).mean(axis=1)
            y = y[:n].reshape(-1, rebin).mean(axis=1)
            edges = edges[:n + 1:rebin]
        keep = (k >= lo) & (k <= hi)
        sel = np.flatnonzero(keep)
        ells.append(int(ell))
        list_k.append(k[sel])
        e = np.column_stack([edges[sel], edges[sel + 1]])
        list_kedges.append(e)
        list_y.append(y[sel])
    return list_k, list_kedges, tuple(ells), np.concatenate(list_y), meas.get('shotnoise')


def load_power_spectrum_data(data, klim=None):
    """Load data/mocks: path(s) (with glob patterns), objects, or state
    dicts. Returns dict(k, kedges, ells, flatdata, shotnoise, list_y)
    with flatdata the mock mean when several measurements are given."""
    if not is_sequence(data):
        data = [data]
    expanded = []
    for item in data:
        if is_path(item):
            matches = sorted(_glob.glob(str(item)))
            expanded += matches if matches else [item]
        else:
            expanded.append(item)
    ref = None
    list_y, list_sn = [], []
    for item in expanded:
        meas = read_power_multipoles(item)
        k, kedges, ells, y, sn = select_multipoles(meas, klim=klim)
        if ref is None:
            ref = (k, kedges, ells)
        else:
            if ells != ref[2] or not all(np.allclose(a, b, rtol=1e-3) for a, b in zip(k, ref[0])):
                raise ValueError('inconsistent k/ells across input measurements')
        list_y.append(y)
        if sn is not None:
            list_sn.append(sn)
    k, kedges, ells = ref
    return dict(k=k, kedges=kedges, ells=ells,
                flatdata=np.mean(list_y, axis=0),
                shotnoise=float(np.mean(list_sn)) if list_sn else None,
                list_y=list_y)


# --- measured correlation function multipoles ---

def read_correlation_multipoles(source, ells=None):
    """Normalize a pycorr-style measurement: object with .get_corr / (s,
    corr, ells) attributes, a state dict {'s', 'corr', 'ells'}, or a path.
    Returns dict(s (nells, ns), ells, corr (nells, ns))."""
    obj = _state_of(source)
    if isinstance(obj, dict):
        s = np.asarray(obj['s'], dtype='f8')
        corr = np.asarray(obj['corr'], dtype='f8')
        ells_in = tuple(int(ell) for ell in np.asarray(obj['ells']).tolist())
    elif hasattr(obj, 'get_corr'):
        ells_in = tuple(ells if ells is not None else (0, 2, 4))
        s, corr = obj.get_corr(ells=ells_in, return_sep=True, ignore_nan=True)
        s, corr = np.asarray(s, dtype='f8'), np.asarray(corr, dtype='f8')
    else:
        s = np.asarray(obj.s, dtype='f8')
        corr = np.asarray(obj.corr, dtype='f8')
        ells_in = tuple(int(ell) for ell in obj.ells)
    if s.ndim == 1:
        s = np.tile(s, (len(ells_in), 1))
    return dict(s=s, ells=ells_in, corr=corr)


# --- window matrices ---

def read_window_matrix(source, ells, klim=None, kout=None, kin=None, kinrebin=None,
                       kinlim=None, ellsin=None):
    """Normalize a window matrix to (kin, matrix, list_kout, ellsin,
    wshotnoise).

    Accepts pypower BaseMatrix-style objects/state dicts with
    (xin, xout, projsin, projsout, value[, vectorout]) or our canonical
    dict {'kin', 'kout', 'ellsin', 'ellsout', 'matrix'[, 'wshotnoise']}.
    Output-side k selection (with the rebin factor that matches a target
    output grid), input-side rebin / limits, projection selection and
    matrix_lininterp re-gridding, on plain arrays.

    matrix orientation: rows = output (data) bins, columns = input (theory)
    bins — pypower's value.T.
    """
    obj = _state_of(source)

    def proj_ell(proj):
        if isinstance(proj, dict):
            return int(proj.get('ell'))
        ell = getattr(proj, 'ell', proj)
        return int(ell)

    if isinstance(obj, dict) and 'matrix' in obj:
        xin = [np.asarray(x, dtype='f8') for x in (obj['kin'] if np.ndim(obj['kin'][0]) else [obj['kin']] * len(obj['ellsin']))]
        xout = [np.asarray(x, dtype='f8') for x in obj['kout']]
        ellsin_all = [int(e) for e in obj['ellsin']]
        ellsout_all = [int(e) for e in obj['ellsout']]
        matrix = np.asarray(obj['matrix'], dtype='f8')
        vectorout = obj.get('wshotnoise')
    else:
        if isinstance(obj, dict):
            xin = [np.asarray(x, dtype='f8') for x in obj['xin']]
            xout = [np.asarray(x, dtype='f8') for x in obj['xout']]
            projsin, projsout = obj['projsin'], obj['projsout']
            value = np.asarray(obj['value'], dtype='f8')
            vectorout = obj.get('vectorout')
        else:
            xin = [np.asarray(x, dtype='f8') for x in obj.xin]
            xout = [np.asarray(x, dtype='f8') for x in obj.xout]
            projsin, projsout = obj.projsin, obj.projsout
            value = np.asarray(obj.value, dtype='f8')
            vectorout = getattr(obj, 'vectorout', None)
        ellsin_all = [proj_ell(p) for p in projsin]
        ellsout_all = [proj_ell(p) for p in projsout]
        matrix = value.T  # (sum nout, sum nin)
        if vectorout is not None:
            vectorout = np.concatenate([np.asarray(v).ravel() for v in np.atleast_1d(list(vectorout))]) \
                if np.ndim(vectorout) != 1 else np.asarray(vectorout)

    # --- select input projections ---
    if ellsin is None:
        ellsin = tuple(ellsin_all)
    ellsin = tuple(int(e) for e in ellsin)
    in_starts = np.concatenate([[0], np.cumsum([len(x) for x in xin])])
    keep_in, xin_sel = [], []
    for i, ell in enumerate(ellsin_all):
        if ell in ellsin:
            keep_in += list(range(in_starts[i], in_starts[i + 1]))
            xin_sel.append(xin[i])
    order = [ellsin_all[i] for i in range(len(ellsin_all)) if ellsin_all[i] in ellsin]
    ellsin = tuple(order)
    matrix = matrix[:, keep_in]
    xin = xin_sel

    # --- select (and possibly rebin) output rows per requested ell ---
    # When a target output grid is known (from the measured data, or klim
    # with a step), search the rebin factor that matches it.
    out_starts = np.concatenate([[0], np.cumsum([len(x) for x in xout])])
    mat_blocks, list_kout, vec_parts = [], [], []
    for ill, ell in enumerate(ells):
        iout = ellsout_all.index(int(ell))
        kk = xout[iout]
        block = matrix[out_starts[iout]:out_starts[iout + 1]]
        vec = np.asarray(vectorout)[out_starts[iout]:out_starts[iout + 1]] \
            if vectorout is not None else None
        lim = (klim or {}).get(ell)
        target = None
        if kout is not None:
            target = np.asarray(kout[ill], dtype='f8')
        elif lim is not None and len(lim) > 2 and lim[2]:
            step_in = np.diff(kk).mean()
            factor = max(int(np.rint(lim[2] / step_in)), 1)
            n = (len(kk) // factor) * factor
            kreb = kk[:n].reshape(-1, factor).mean(axis=-1)
            sel = (kreb >= lim[0]) & (kreb <= lim[1])
            target = kreb[sel]
        if target is not None:
            found = False
            for factor in range(1, len(kk) // len(target) + 2):
                n = (len(kk) // factor) * factor
                kreb = kk[:n].reshape(-1, factor).mean(axis=-1)
                istart = int(np.argmin(np.abs(kreb - target[0])))
                if istart + len(target) <= len(kreb) and \
                        np.allclose(kreb[istart:istart + len(target)], target, rtol=1e-3):
                    breb = block[:n].reshape(-1, factor, block.shape[1]).mean(axis=1)
                    block = breb[istart:istart + len(target)]
                    if vec is not None:
                        vec = vec[:n].reshape(-1, factor).mean(axis=-1)[istart:istart + len(target)]
                    kk = kreb[istart:istart + len(target)]
                    found = True
                    break
            if not found:
                raise ValueError('output k grid for ell={} could not be matched in the '
                                 'window matrix (target {}..{}, available {}..{})'.format(
                                     ell, target[0], target[-1], kk[0], kk[-1]))
        else:
            lo, hi = (lim[0], lim[1]) if lim is not None else (-np.inf, np.inf)
            sel = np.flatnonzero((kk >= lo) & (kk <= hi))
            block = block[sel]
            if vec is not None:
                vec = vec[sel]
            kk = kk[sel]
        mat_blocks.append(block)
        list_kout.append(kk)
        if vec is not None:
            vec_parts.append(vec)
    matrix = np.concatenate(mat_blocks, axis=0)
    wshotnoise = np.concatenate(vec_parts) if vec_parts else None

    # --- input-side rebin / limits / re-gridding ---
    if kinrebin is not None and int(kinrebin) > 1:
        r = int(kinrebin)
        blocks, new_xin = [], []
        start = 0
        for x in xin:
            n = (len(x) // r) * r
            sub = matrix[:, start:start + len(x)][:, :n]
            blocks.append(sub.reshape(matrix.shape[0], -1, r).sum(axis=-1))
            new_xin.append(x[:n].reshape(-1, r).mean(axis=-1))
            start += len(x)
        matrix = np.concatenate(blocks, axis=1)
        xin = new_xin
    if kinlim is not None:
        blocks, new_xin = [], []
        start = 0
        for x in xin:
            mask = (x >= kinlim[0]) & (x <= kinlim[1])
            blocks.append(matrix[:, start:start + len(x)][:, mask])
            new_xin.append(x[mask])
            start += len(x)
        matrix = np.concatenate(blocks, axis=1)
        xin = new_xin
    if kin is not None:
        kin = np.asarray(kin, dtype='f8').ravel()
        from scipy.linalg import block_diag
        rebin = block_diag(*[matrix_lininterp(kin, x) for x in xin])
        matrix = matrix @ rebin
        kin_out = kin
    else:
        kin_out = xin[0]
        if not all(np.allclose(x, kin_out) for x in xin):
            raise ValueError('input k-coordinates differ between multipoles; pass kin= to re-grid')
    return kin_out, matrix, list_kout, ellsin, wshotnoise


def get_params_in_source(source, params=None):
    """Parameter names available in a source (Chain / Profiles / Samples /
    path), optionally restricted to ``params`` (reference
    samples/__init__.py:108); bookkeeping columns (logposterior, ...) excluded."""
    from .samples import Chain, Profiles
    if is_path(source):
        source = Chain.load(source)
    if isinstance(source, Profiles):
        names = source.bestfit.names()
    elif hasattr(source, 'names'):
        names = source.names()
    else:
        names = list(source or [])
    names = [n for n in names if n not in ('logposterior', 'loglikelihood', 'logprior', 'aweight', 'fweight')]
    if params is not None:
        keep = [getattr(p, 'name', p) for p in params]
        names = [n for n in names if n in keep]
    return names


def load_source(source, choice=None, cov=False, burnin=None, params=None):
    """Uniform loader of :class:`~.samples.Chain` and :class:`~.samples.Profiles`
    sources (instances or paths, or a list of them; reference
    samples/__init__.py:17): the best fit (``choice={'index': 'argmax'}``) or
    the mean as a dict name -> value, or with ``cov=True`` (names,
    covariance matrix). A Profiles source gives its best fit, or its
    parabolic covariance."""
    from .samples import Chain, Profiles

    sources = source if is_sequence(source) else [source]
    loaded = []
    for src in sources:
        if is_path(src):
            src = Chain.load(src)
        if isinstance(src, Chain) and burnin is not None:
            src = src.remove_burnin(burnin)
        loaded.append(src)
    chains = [s for s in loaded if isinstance(s, Chain)]
    if chains:
        chain = Chain.concatenate(chains, axis=0) if len(chains) > 1 else chains[0]
        names = list(params) if params is not None else [n for n in chain.names()
                                                         if n not in ('logposterior', 'loglikelihood', 'logprior')]
        if cov:
            return names, chain.covariance(names)
        if choice and choice.get('index') == 'argmax':
            flat = {n: np.asarray(chain[n]).ravel() for n in names + ['logposterior']}
            i = int(np.argmax(flat['logposterior']))
            return {n: float(flat[n][i]) for n in names}
        return {n: float(chain.mean(n)) for n in names}
    profs = [s for s in loaded if isinstance(s, Profiles)]
    if profs:
        prof = profs[0]
        best = prof.bestfit
        names = list(params) if params is not None else [n for n in best.names() if n != 'logposterior']
        i = int(np.argmax(np.atleast_1d(np.asarray(best['logposterior']))))
        if cov:
            if getattr(prof, 'covariance', None) is not None:
                return names, np.asarray(prof.covariance)
            raise ValueError('profiles carry no covariance')
        return {n: float(np.atleast_1d(np.asarray(best[n]))[i]) for n in names}
    raise ValueError('unsupported source type(s): {}'.format([type(s) for s in loaded]))


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
