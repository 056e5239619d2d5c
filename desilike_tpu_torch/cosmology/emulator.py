"""Emulated Boltzmann engine: a trained MLP correction to the EH98 linear pk.

Counterpart of ``desilike_tpu/cosmology/emulator.py``. The network predicts
the smooth correction to the EH98 backend,

    ln r(k, z; p) = ln [ P_truth(k, z; p) / P_eh98(k, z; p) ]   on (nz, nk),
    ln s(p)       = ln [ rs_truth(p) / rs_eh98(p) ],

so that pk_dd = pk_eh98 exp(r) and rs_drag = rs_eh98 s. Workflow: the
training-grid spec (:func:`sobol_grid`, :func:`write_grid_spec`), truth
tables from a Boltzmann code on another host, :func:`make_targets`,
:func:`train_pk_emulator` (full-batch Adam with a cosine decay, on the
given device), then ``Cosmology(engine='emulator', emulator=weights)``.
Weights are a dict of numpy arrays in the JAX package's layout
(:func:`save_weights` / :func:`load_weights` read and write the same npz
files), so a JAX-trained file loads as it is.

The network (a tanh-approximated GELU between layers) runs in float32; its
normalized outputs are mapped back in the dtype of the parameters (float64
on the host).
"""

import json
import math

import numpy as np
import torch

from .. import config
from . import background as bg
from . import linear as lin


DEFAULT_PARAM_NAMES = ('h', 'omega_cdm', 'omega_b', 'logA', 'n_s', 'm_ncdm')

DEFAULT_RANGES = {
    # a generous DESI-like prior box
    'h': (0.55, 0.80), 'omega_cdm': (0.08, 0.16), 'omega_b': (0.019, 0.026),
    'logA': (2.6, 3.4), 'n_s': (0.88, 1.05), 'm_ncdm': (0.0, 0.6),
}


# --------------------------------------------------------------------------
# training-grid spec

def sobol_grid(ranges=None, n=1024, seed=11):
    """Sobol points over the parameter box. Returns (names, X (n, ndim))."""
    from scipy.stats import qmc
    ranges = dict(DEFAULT_RANGES if ranges is None else ranges)
    names = tuple(ranges)
    lo = np.array([ranges[k][0] for k in names])
    hi = np.array([ranges[k][1] for k in names])
    u = qmc.Sobol(len(names), seed=seed).random(int(n))
    return names, lo + (hi - lo) * u


def write_grid_spec(filename, names=None, X=None, k_grid=None, z_grid=None, **sobol_kwargs):
    """Write the training-grid spec a Boltzmann host consumes."""
    if X is None:
        names, X = sobol_grid(**sobol_kwargs)
    k_grid = np.geomspace(1e-4, 10., 256) if k_grid is None else np.asarray(k_grid, dtype='f8')
    z_grid = np.linspace(0., 3., 7) if z_grid is None else np.asarray(z_grid, dtype='f8')
    np.savez(str(filename), meta=np.array(json.dumps({'param_names': list(names)})),
             X=np.asarray(X, dtype='f8'), k_grid=k_grid, z_grid=z_grid)
    return dict(param_names=tuple(names), X=np.asarray(X), k_grid=k_grid, z_grid=z_grid)


# --------------------------------------------------------------------------
# target construction + training

def make_targets(names, X, pk_tables, rs_drags, k_grid, z_grid):
    """ln-ratio targets against the EH98 backend at the same parameters,
    all rows at once in float64 on the host.

    pk_tables: (n, nz, nk) truth P(k, z) [(Mpc/h)^3]; rs_drags: (n,) [Mpc/h].
    Returns Y (n, nz*nk + 1) float64.
    """
    X = np.asarray(X, dtype='f8')
    p = bg.resolve({name: torch.as_tensor(X[:, i], dtype=torch.float64) for i, name in enumerate(names)})
    k = np.asarray(k_grid, dtype='f8')
    pk_eh = torch.stack([lin.pk_lin(p, k, float(z)) for z in np.asarray(z_grid)], dim=1).numpy()   # (n, nz, nk)
    rs_eh = bg.rs_drag(p).numpy()
    lnr = np.log(np.asarray(pk_tables, dtype='f8') / pk_eh)
    return np.concatenate([lnr.reshape(X.shape[0], -1), np.log(np.asarray(rs_drags, dtype='f8') / rs_eh)[:, None]],
                          axis=1)


def _forward(layers, x):
    for W, b in layers[:-1]:
        x = torch.nn.functional.gelu(x @ W + b, approximate='tanh')
    W, b = layers[-1]
    return x @ W + b


def init_layers(sizes, seed=3):
    """LeCun-normal weights (normal / sqrt(fan_in)) and zero biases, float32
    numpy, from a seeded torch generator: a list of (W (fan_in, fan_out),
    b (fan_out,))."""
    generator = torch.Generator().manual_seed(int(seed))
    return [((torch.randn(fan_in, fan_out, generator=generator, dtype=torch.float32) / np.sqrt(fan_in)).numpy(),
             np.zeros(fan_out, dtype='f4')) for fan_in, fan_out in zip(sizes[:-1], sizes[1:])]


def fit_layers(layers, Xt, Yt, nsteps=8000, learning_rate=3e-3, device=None):
    """Full-batch Adam on the mean squared error, the learning rate decayed
    by a cosine to 0 over ``nsteps``, from ``layers`` ((W, b) pairs) on
    normalized float32 inputs ``Xt`` and targets ``Yt``, on ``device`` (the
    card when None). Returns (the fitted layers as numpy, the loss of the
    last step before its update)."""
    device = config.resolve(device)
    params = [torch.tensor(np.asarray(array), dtype=torch.float32, device=device, requires_grad=True)
              for pair in layers for array in pair]
    Xt = torch.as_tensor(np.asarray(Xt), dtype=torch.float32, device=device)
    Yt = torch.as_tensor(np.asarray(Yt), dtype=torch.float32, device=device)
    nsteps = int(nsteps)
    optimizer = torch.optim.Adam(params, lr=learning_rate)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 0.5 * (1. + math.cos(math.pi * min(step, nsteps) / nsteps)))
    loss = torch.zeros(())
    for _ in range(nsteps):
        optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((_forward(list(zip(params[::2], params[1::2])), Xt) - Yt) ** 2)
        loss.backward()
        optimizer.step()
        schedule.step()
    fitted = [(W.detach().cpu().numpy(), b.detach().cpu().numpy()) for W, b in zip(params[::2], params[1::2])]
    return fitted, float(loss.detach())


def train_mlp(names, X, Y, hidden=(128, 128), nsteps=8000, learning_rate=3e-3,
              seed=3, holdout=0.1, device=None):
    """Full-batch MLP regression X -> Y with per-output normalization.
    Returns a weights dict (see :func:`predict_raw` for the layout) plus
    '_holdout_idx' (the held-out rows). Trains on ``device``, the card when
    None."""
    X = np.asarray(X, dtype='f8')
    Y = np.asarray(Y, dtype='f8')
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nho = max(1, int(holdout * n))
    idx_tr, idx_ho = perm[nho:], perm[:nho]
    xm, xs = X[idx_tr].mean(0), X[idx_tr].std(0) + 1e-30
    ym, ys = Y[idx_tr].mean(0), Y[idx_tr].std(0) + 1e-12
    Xt = ((X[idx_tr] - xm) / xs).astype('f4')
    Yt = ((Y[idx_tr] - ym) / ys).astype('f4')
    sizes = (X.shape[1],) + tuple(hidden) + (Y.shape[1],)
    layers, loss = fit_layers(init_layers(sizes, seed), Xt, Yt, nsteps=nsteps, learning_rate=learning_rate,
                              device=device)
    return {'param_names': tuple(names), 'x_mean': xm, 'x_std': xs, 'y_mean': ym, 'y_std': ys,
            'layers': layers, 'loss': loss, '_holdout_idx': idx_ho}


def train_pk_emulator(names, X, Y, k_grid, z_grid, hidden=(128, 128),
                      nsteps=8000, learning_rate=3e-3, seed=3, holdout=0.1, device=None):
    """Train the pk-correction MLP on ``device`` (the card when None).
    Returns a weights dict with the held-out max |pk ratio error| in
    'holdout_err'."""
    weights = train_mlp(names, X, Y, hidden=hidden, nsteps=nsteps, learning_rate=learning_rate, seed=seed,
                        holdout=holdout, device=device)
    idx_ho = weights.pop('_holdout_idx')
    weights['k_grid'] = np.asarray(k_grid, dtype='f8')
    weights['z_grid'] = np.asarray(z_grid, dtype='f8')
    pred = predict_raw(weights, np.asarray(X)[idx_ho])
    weights['holdout_err'] = float(np.abs(np.exp(pred - np.asarray(Y)[idx_ho]) - 1.).max())
    return weights


def layer_tensors(weights, device=None):
    """The network's layers as float32 tensors on ``device``, the card when
    None (made once by a caller that evaluates often)."""
    device = config.resolve(device)
    return [(torch.as_tensor(np.asarray(W), dtype=torch.float32, device=device),
             torch.as_tensor(np.asarray(b), dtype=torch.float32, device=device)) for W, b in weights['layers']]


def predict_raw(weights, theta, layers=None):
    """theta (..., ndim) -> de-normalized outputs (..., nz*nk + 1):
    a tensor gives a tensor of its dtype on its device (differentiable), an
    array gives float64 numpy. ``layers``: :func:`layer_tensors` on theta's
    device, made here if not given."""
    host = not isinstance(theta, torch.Tensor)
    if host:
        theta = torch.as_tensor(np.asarray(theta, dtype='f8'))
    dtype, device = theta.dtype, theta.device

    def tensor(name):
        return torch.as_tensor(np.asarray(weights[name]), dtype=dtype, device=device)

    x = ((theta - tensor('x_mean')) / tensor('x_std')).to(torch.float32)
    y = _forward(layer_tensors(weights, device) if layers is None else layers, x)
    out = y.to(dtype) * tensor('y_std') + tensor('y_mean')
    return out.numpy() if host else out


def predict_tables(weights, theta, layers=None):
    """theta (..., ndim) -> (lnratio (..., nz, nk), rs_ratio (...,))."""
    out = predict_raw(weights, theta, layers=layers)
    nz, nk = len(weights['z_grid']), len(weights['k_grid'])
    lnr = out[..., :nz * nk].reshape(out.shape[:-1] + (nz, nk))
    last = out[..., nz * nk]
    return lnr, (np.exp(last) if isinstance(last, np.ndarray) or np.isscalar(last) else torch.exp(last))


# --------------------------------------------------------------------------
# IO: the JAX package's npz layout

def save_weights(filename, weights):
    """Persist a weights dict: 'layers' is split into W%d/b%d arrays, other
    ndarray values saved verbatim, everything else (names, scalars) goes
    into the json meta."""
    meta, arrays = {'nlayers': len(weights['layers'])}, {}
    for key, value in weights.items():
        if key == 'layers' or key.startswith('_'):
            continue
        if isinstance(value, np.ndarray):
            arrays[key] = value
        else:
            meta[key] = list(value) if isinstance(value, tuple) else value
    meta['_array_keys'] = sorted(arrays)
    arrays['meta'] = np.array(json.dumps(meta))
    for i, (W, b) in enumerate(weights['layers']):
        arrays['W%d' % i] = np.asarray(W)
        arrays['b%d' % i] = np.asarray(b)
    np.savez(str(filename), **arrays)


def load_weights(filename):
    loaded = np.load(str(filename), allow_pickle=False)
    meta = json.loads(str(loaded['meta']))
    array_keys = meta.pop('_array_keys')
    nlayers = meta.pop('nlayers')
    weights = {k: (tuple(v) if isinstance(v, list) else v) for k, v in meta.items()}
    for key in array_keys:
        weights[key] = loaded[key]
    weights['layers'] = [(loaded['W%d' % i], loaded['b%d' % i]) for i in range(nlayers)]
    return weights
