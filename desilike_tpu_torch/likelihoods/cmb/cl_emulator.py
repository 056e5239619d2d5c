"""Emulated-Cl engine: full C_ell recomputation per evaluation by an MLP.

Counterpart of ``desilike_tpu/likelihoods/cmb/cl_emulator.py``, on the
port's generic trainer and network (:mod:`...cosmology.emulator`): the
network maps cosmological parameters to D_ell = ell (ell + 1) C_ell / 2pi on
a fixed node grid (dense at low ell, log-spaced through the acoustic
regime); inference maps the nodes back onto every ell. Where the JAX
package interpolates each spectrum with ``jnp.interp`` on the static node
grid, the port applies one static (nnodes, lmax + 1) matrix
(:func:`interpolation_matrix`: the linear interpolation weights, edge values
held outside the nodes, and 2 pi / (ell (ell + 1)), zero below ell = 2) in
one product a spectrum.

Workflow: raw C_ell tables from a Boltzmann code on a parameter grid ->
:func:`train_cl_emulator` -> weights -> ``ClTheory(emulator=weights)``.
"""

import numpy as np
import torch

from ...cosmology.emulator import train_mlp, predict_raw, save_weights, load_weights  # noqa: F401 (re-exported)


def ell_nodes(lmax, dense_until=32, nlog=72):
    """Node grid: every ell up to ``dense_until``, log-spaced beyond."""
    dense = np.arange(2, min(dense_until, lmax) + 1)
    if lmax > dense_until:
        log = np.unique(np.geomspace(dense_until + 1, lmax, nlog).astype('i8'))
        return np.concatenate([dense, log])
    return dense


def _dl_at(cl_row, nodes):
    nodes = np.asarray(nodes)
    return cl_row[nodes] * nodes * (nodes + 1.) / (2. * np.pi)


def make_cl_targets(cls_tables, nodes):
    """cls_tables: {xy: (n, >=lmax+1)} raw C_ell tables over n parameter
    points. Returns (spectra tuple, Y (n, nspec*nnodes))."""
    spectra = tuple(sorted(cls_tables))
    n = next(iter(cls_tables.values())).shape[0]
    Y = np.concatenate([np.stack([_dl_at(np.asarray(cls_tables[xy][i], dtype='f8'), nodes) for i in range(n)])
                        for xy in spectra], axis=1)
    return spectra, Y


def train_cl_emulator(names, X, cls_tables, fiducial=None, lmax=None, hidden=(128, 128), nsteps=8000,
                      learning_rate=3e-3, seed=3, holdout=0.1, device='cpu', **node_kwargs):
    """Train the Cl MLP. ``cls_tables``: {xy: (n, nell)} raw C_ell.
    ``fiducial``: {param: value} stored in the weights (the registered
    parameter defaults). Returns weights with 'holdout_err' = max held-out
    D_ell error relative to each spectrum's peak."""
    if lmax is None:
        lmax = min(tab.shape[1] for tab in cls_tables.values()) - 1
    nodes = ell_nodes(lmax, **node_kwargs)
    spectra, Y = make_cl_targets({xy: np.asarray(tab)[:, :lmax + 1] for xy, tab in cls_tables.items()}, nodes)
    weights = train_mlp(names, X, Y, hidden=hidden, nsteps=nsteps, learning_rate=learning_rate, seed=seed,
                        holdout=holdout, device=device)
    idx_ho = weights.pop('_holdout_idx')
    weights['ell_nodes'] = np.asarray(nodes, dtype='f8')
    weights['spectra'] = spectra
    weights['lmax'] = int(lmax)
    weights['fiducial'] = {k: float(v) for k, v in (fiducial or {}).items()}
    pred = predict_raw(weights, np.asarray(X)[idx_ho])
    truth = np.asarray(Y)[idx_ho]
    nn = len(nodes)
    errs = []
    for i in range(len(spectra)):
        block = slice(i * nn, (i + 1) * nn)
        errs.append(np.abs(pred[:, block] - truth[:, block]).max() / np.abs(truth[:, block]).max())
    weights['holdout_err'] = float(max(errs))
    return weights


def interpolation_matrix(weights):
    """(nnodes, lmax + 1) float64: a row of D_ell on the node grid times it is
    the raw C_ell at every ell (``jnp.interp`` of the nodes, the edge values
    outside them, then 2 pi D_ell / (ell (ell + 1)) for ell >= 2, 0 below)."""
    nodes = np.asarray(weights['ell_nodes'], dtype='f8')
    ell = np.arange(int(weights['lmax']) + 1, dtype='f8')
    out = np.zeros((nodes.size, ell.size))
    position = np.interp(ell, nodes, np.arange(nodes.size))  # fractional node index, clamped at the ends
    lo = np.minimum(np.floor(position).astype('i8'), nodes.size - 1)
    hi = np.minimum(lo + 1, nodes.size - 1)
    t = position - lo
    columns = np.arange(ell.size)
    np.add.at(out, (lo, columns), 1. - t)
    np.add.at(out, (hi, columns), t)
    factor = np.where(ell >= 2, 2. * np.pi / np.maximum(ell * (ell + 1.), 1.), 0.)
    return out * factor


def predict_cls(weights, theta, matrix=None, layers=None):
    """theta (..., ndim) -> {xy: (..., lmax + 1) raw C_ell}, differentiable;
    ``matrix``: :func:`interpolation_matrix` as a tensor of theta's dtype and
    device (made here if not given), ``layers``: the network's
    :func:`...cosmology.emulator.layer_tensors`."""
    theta = torch.as_tensor(theta)
    out = predict_raw(weights, theta, layers=layers)
    if matrix is None:
        matrix = torch.as_tensor(interpolation_matrix(weights), dtype=theta.dtype, device=theta.device)
    nn = matrix.shape[0]
    return {xy: out[..., i * nn:(i + 1) * nn] @ matrix for i, xy in enumerate(weights['spectra'])}
