"""Gaussian likelihoods, their sums, and analytic marginalization over the
solved nuisance parameters.

Counterpart of ``desilike_tpu/likelihoods/base.py``. The whitened residuals
of the Gaussian likelihoods of a sum are independent, so they are
concatenated into one vector d (B, ndata) and one design matrix J; the
non-Gaussian likelihoods add their log-likelihood. One Newton step from the
solved parameters' current values s0, as the JAX package takes:

  g = prior_grad - J d,  H = prior_hess - J J^T   (whitened space),
  dx = -H^{-1} g,  loglike = -1/2 d.d + 1/2 dx.H_like.dx + g_like.dx
                             - 1/2 logdet(-H_marg),

with H_like = -J J^T and g_like = -J d, so that the first three terms are
-1/2 |d + J^T dx|^2, which is how they are computed here. The log-determinant
is over the '.marg' parameters only; '.best' ones take their step and no
determinant; '.prec' ones are folded into the covariance once, on the host
(:meth:`BaseLikelihood._fold_precision`), and pinned at their prior centre.

A solved parameter's row of J comes from one of three places:

- a static basis (the BAO broadband towers ``al*``, the stochastic terms
  ``sn*``): a build-time constant, by unit-step differences in one batched
  float64 host run;
- a basis the theory exposes per chain (``solved_power_basis``: the EFT
  counterterms ``ct*`` multiply pk11): from the primal run;
- neither (a counterterm under a correlation-function theory, whose xi node
  exposes no basis; any parameter inside an observable with a nonlinear
  data-side transform, ``transform='cubic'``): the linearize path, forward
  mode through the pipeline at s0, ``torch.func.vmap`` over one-hot tangents
  of ``torch.func.jvp``: one row a solved direction and a chain, with the
  primal computed once. Under a nonlinear transform one Newton step is not
  the exact optimum; it is the JAX package's answer.

The block of H over the static rows is the same for every chain: its
Jacobi-equilibrated Cholesky factor and log-determinant are computed once,
on the host in float64 (raising if it is not positive definite), and with
static rows only the per-evaluation work is a batched triangular solve.
Per-chain rows add the Schur complement of that block, one small matrix per
chain, equilibrated and factored in float32 with ``torch.linalg.cholesky_ex``;
a chain whose matrix does not factor reads -inf, as the reference's clipped
pivots give a value for every chain (its ``info`` is returned in ``aux``, not
read on the host).

A covariance estimated from mocks enters through the Hartlap 2007 factor on
its precision, at build (``hartlap``), and the Percival 2014 factor m
(arXiv:1312.4841), which depends on the number of varied and solved
parameters of the pipeline that calls ``logpost_fn``: each build applies it
from the unscaled whitening, so that rebuilding never stacks it, and falls
back to the Hartlap factor alone, with a warning, where m is undefined
(nmocks <= ndata + 4).
"""

import fnmatch

import numpy as np
import torch
from torch.func import jvp, vmap

from ..core import Calculator, Pipeline
from ..ops.linalg import whiten_factor, inverse, cholesky, cholesky_equilibrated
from ..parameters import ParameterCollection
from ..utils import is_sequence
from .. import config


def _status(param):
    return param.derived.split('_not_derived')[0]


class BaseLikelihood(Calculator):
    """Base likelihood: get() returns the log-likelihood; derived
    loglikelihood/logprior."""

    _params = {'loglikelihood': dict(derived=True, latex=r'\ln\mathcal{L}'),
               'logprior': dict(derived=True, latex=r'\ln p')}
    solved_default = '.marg'
    name = None

    @property
    def likelihoods(self):
        return [self]

    def get(self):
        return self.loglikelihood

    def __add__(self, other):
        return SumLikelihood(likelihoods=self.likelihoods + other.likelihoods)

    def _gaussian(self):
        return [like for like in self.likelihoods if isinstance(like, BaseGaussianLikelihood)]

    def _solved_setup(self, pipe):
        solved = pipe.solved_params
        prec_params = [p for p in solved if _status(p) == '.prec']
        if prec_params:
            self._fold_precision(pipe, prec_params)
        solved = ParameterCollection([p for p in solved if _status(p) != '.prec'])
        names = solved.names()
        marg_idx = []
        loc = np.zeros(len(names))
        prec = np.zeros(len(names))
        for i, p in enumerate(solved):
            status = _status(p)
            if status == '.auto':
                status = self.solved_default
            if status == '.marg':
                marg_idx.append(i)
            if p.prior is not None and p.prior.dist == 'norm':
                loc[i] = p.prior.loc
                prec[i] = p.prior.scale ** -2
        return names, solved, np.array(marg_idx, dtype='i8'), loc, prec

    def _host_run(self, pipe, names, overrides):
        """One batched float64 host evaluation of len(names) + 1 rows: the
        defaults (with ``overrides``), then one unit step per parameter of
        ``names``."""
        values = {}
        for name, value in pipe.input_defaults().items():
            column = np.full(len(names) + 1, float(overrides.get(name, value)))
            if name in names:
                column[1 + names.index(name)] += 1.
            values[name] = column
        pipe.run_once(pipe._resolve_values(values, device=torch.device('cpu'), dtype=config.HOST_DTYPE))

    def _fold_precision(self, pipe, prec_params):
        """'.prec' parameters, marginalized once into the data covariance
        (JAX ``_fold_precision``). For a linear parameter s ~ N(loc, sig)
        with theory t(s) = t(loc) + b (s - loc), marginalizing is exactly
        C -> C + sig^2 b b^T with s pinned at loc. The fold starts from the
        unfolded covariance, so that rebuilding ``logpost_fn`` never inflates
        it twice; b comes from one batched float64 host run."""
        for p in prec_params:
            if p.prior is None or p.prior.dist != 'norm' or not np.isfinite(p.prior.scale):
                raise ValueError('.prec parameter {} needs a proper normal prior'.format(p.name))
        names = [p.name for p in prec_params]
        self._host_run(pipe, names, {p.name: p.prior.loc for p in prec_params})
        for like in self._gaussian():
            theory = like.flattheory().numpy()
            prefold = like.__dict__.setdefault('_covariance_prefold', np.array(like.covariance, dtype='f8'))
            cov = prefold.copy()
            for row, p in enumerate(prec_params, start=1):
                b = theory[row] - theory[0]
                if np.any(b != 0.):
                    cov = cov + p.prior.scale ** 2 * np.outer(b, b)
            like._set_whitening(cov, hartlap=like.hartlap)
        for p in prec_params:
            pipe.params[p.name].update(value=p.prior.loc)

    @staticmethod
    def _nonlinear_transform_calcs(likelihoods):
        """Calculators inside the subgraph of any observable that carries a
        nonlinear data-side transform (``transform='cubic'``): the solved
        parameters they own may use neither a static design matrix nor
        primal basis rows."""
        calcs = []
        for like in likelihoods:
            for obs in getattr(like, 'observables', ()):
                if getattr(obs, 'transform', None) is not None:
                    calcs.extend(Pipeline(obs).calculators)
        return calcs

    @staticmethod
    def _nvaried_and_solved(pipe):
        """The parameters a fit of ``pipe`` determines: varied, and solved
        but not folded into the covariance ('.prec'); the Percival factor's
        count."""
        return len(pipe.varied_params) + len([p for p in pipe.solved_params if _status(p) != '.prec'])

    def _static_linear_indices(self, pipe, solved, likelihoods=None):
        """Indices of solved params whose theory contribution is exactly
        linear with a static basis (owner declares ``_static_linear_solved``),
        outside any observable with a nonlinear transform."""
        nonlinear = self._nonlinear_transform_calcs(self.likelihoods if likelihoods is None else likelihoods)
        static = []
        for i, p in enumerate(solved):
            if any(p.name in calc.runtime_info.params for calc in nonlinear):
                continue
            for owner in pipe._param_owners.get(p.name, []):
                patterns = getattr(owner, '_static_linear_solved', ())
                if any(fnmatch.fnmatch(p.basename, pat) for pat in patterns):
                    static.append(i)
                    break
        return static

    def _compute_static_J(self, pipe, names, likelihoods):
        """Exact constant design matrices of the solved parameters ``names``
        by unit-step differences (exact for linear contributions), one
        (len(names), size) matrix per Gaussian likelihood of
        ``likelihoods``, from ONE batched float64 host run."""
        self._host_run(pipe, names, {})
        diffs = [like.flatdiff_white.numpy() for like in likelihoods]
        return [diff[1:] - diff[0] for diff in diffs]

    def _static_design(self, pipe, names, gauss):
        """The static rows (len(names), ndata) over the concatenated data of
        ``gauss``, each likelihood's block cached on it by ``names``."""
        key = tuple(names)
        missing = [like for like in gauss if key not in like._static_J]
        if missing and names:
            for like, J in zip(missing, self._compute_static_J(pipe, list(names), missing)):
                like._static_J[key] = J
        blocks = []
        for like in gauss:
            J = np.asarray(like._static_J.get(key, np.zeros((0, like.size))), dtype='f8')
            if J.shape != (len(names), like.size):
                raise ValueError('static design matrix has shape {}, expected {}'.format(J.shape, (len(names), like.size)))
            blocks.append(J)
        return np.concatenate(blocks, axis=-1) if blocks else np.zeros((len(names), 0))

    def _analytic_basis_plan(self, solved, candidates, gauss):
        """For solved parameters without a static design matrix whose theory
        exposes ``solved_power_basis`` in every Gaussian likelihood they reach
        (exactly linear terms with a per-chain basis, e.g. EFT counterterms x
        pk11), the J rows come from the primal run. Returns (analytic_idx,
        plan): plan maps a solved index to a list of (theory, matrix) pairs,
        matrix (ndata, nell * nk) over the concatenated data, such that the
        row is the sum of ``solved_power_basis(basename).flatten() @ matrix.T``."""
        ndata = sum(like.size for like in gauss)
        analytic, plan = [], {}
        for i in candidates:
            terms, start = [], 0
            for like in gauss:
                got = like.solved_flat_basis_fn(solved[i])
                if got is False:
                    terms = []
                    break
                for theory, matrix in got or ():
                    padded = np.zeros((ndata, matrix.shape[1]))
                    padded[start:start + like.size] = matrix
                    terms.append((theory, padded))
                start += like.size
            if terms:
                analytic.append(i)
                plan[i] = terms
        return analytic, plan

    def logpost_fn(self):
        """Function {varied name: scalar or (B,) tensor} -> ((B,) logposterior,
        aux dict), evaluated in float32 on the pipeline's device.

        aux contains 'loglikelihood', 'logprior', derived parameters, and for
        solved parameters their analytic best-fit values 'solved' and the
        posterior hessian 'solved_hessian', (nsolved, nsolved) when every
        design row is static and (B, nsolved, nsolved) otherwise.

        With per-chain rows, a chain whose rows are not finite or whose Schur
        complement is not positive definite reads a log-likelihood of -inf,
        with a finite gradient, and leaves every other chain as it would be
        without it; ``aux['solved_info']`` (B,) holds, per chain, 0, the
        order of the leading minor that failed (``cholesky_ex``'s ``info``),
        or -1 for rows, or a factor, that are not finite. Nothing here reads it on the
        host: the caller checks it after the call where it needs to.
        """
        pipe = self.pipeline
        device, dtype = pipe.device, config.get_dtype()
        names, solved, marg_idx, prior_loc, prior_prec = self._solved_setup(pipe)
        likelihoods, gauss = self.likelihoods, self._gaussian()
        nvaried = self._nvaried_and_solved(pipe)
        for like in gauss:
            like._apply_mock_factor(nvaried)
        others = [like for like in likelihoods if not isinstance(like, BaseGaussianLikelihood)]
        nsolved = len(names)

        def as_tensor(array):
            return torch.as_tensor(np.asarray(array), dtype=dtype, device=device)

        if nsolved == 0:
            def fn(values):
                full = pipe._resolve_values(values, device=device, dtype=dtype)
                _, derived = pipe.run_once(full)
                loglike = sum(like.loglikelihood for like in likelihoods)
                aux = dict(derived, loglikelihood=loglike, logprior=pipe.logprior(full))
                return aux['loglikelihood'] + aux['logprior'], aux
            return fn

        sidx = self._static_linear_indices(pipe, solved, likelihoods)
        pidx = [i for i in range(nsolved) if i not in sidx]  # per-chain rows, in the solved order
        aidx, plan = self._analytic_basis_plan(solved, pidx, gauss)
        tidx = [i for i in pidx if i not in aidx]  # the linearize path
        ns, na, nt = len(sidx), len(pidx), len(tidx)
        # --- the constant block: static rows Js (ns, ndata), A = Js Js^T + P_s, factored once in float64 ---
        J = self._static_design(pipe, [names[i] for i in sidx], gauss)
        H = -J @ J.T - np.diag(prior_prec[sidx])
        curvature = -np.diag(H)
        if np.any(curvature <= 0.):
            raise ValueError('solved parameters {} do not move the likelihood and have no prior'.format(
                [names[i] for i, c in zip(sidx, curvature) if c <= 0.]))
        # Jacobi equilibration: the solved basis (broadband powers k^-3..k^1)
        # is wildly scaled; rescaling by sqrt(diag(-H)) brings the condition
        # number down to that of the correlation matrix
        scale = 1. / np.sqrt(curvature)
        Hs = H * scale[:, None] * scale[None, :]
        Ls = cholesky(torch.from_numpy(-Hs)) if ns else torch.zeros((0, 0), dtype=torch.float64)
        # the '.marg' ones among the static (ms) and the per-chain (ma) rows: logdet(-H_marg) =
        # logdet(A_msms) + logdet(D_mama - C_mams A_msms^-1 C_mams^T), the first a constant
        marg = set(marg_idx.tolist())
        ms = [k for k, i in enumerate(sidx) if i in marg]
        ma = [k for k, i in enumerate(pidx) if i in marg]
        logdet = 0.
        Lm = Ls
        if ms:
            # logdet(-H_m) = logdet(-Hs_m) - 2 sum(log scale_m)
            Lm = Ls if len(ms) == ns else cholesky(torch.from_numpy(-Hs[np.ix_(ms, ms)]))
            logdet = 2. * float(torch.log(torch.diagonal(Lm)).sum()) - 2. * float(np.log(scale[ms]).sum())
        J_t, H_t = as_tensor(J), as_tensor(H)
        Ls_t, scale_t, Lm_t, scale_m_t = as_tensor(Ls), as_tensor(scale), as_tensor(Lm), as_tensor(scale[ms])
        loc_t, prec_t = as_tensor(prior_loc), as_tensor(prior_prec)
        solved_priors = [(i, p.prior) for i, p in enumerate(solved) if p.prior is not None]
        sidx_t = torch.as_tensor(sidx, dtype=torch.long, device=device)
        pidx_t = torch.as_tensor(pidx, dtype=torch.long, device=device)
        tidx_t = torch.as_tensor(tidx, dtype=torch.long, device=device)
        ms_t = torch.as_tensor(ms, dtype=torch.long, device=device)
        ma_t = torch.as_tensor(ma, dtype=torch.long, device=device)
        plan_t = [(solved[i].basename, [(theory, as_tensor(matrix.T)) for theory, matrix in plan[i]]) for i in aidx]
        # where each per-chain row comes from: (True, k) the k-th analytic row, (False, k) the k-th traced one
        sources = [(True, aidx.index(i)) if i in aidx else (False, tidx.index(i)) for i in pidx]
        if na:
            # the hessian's constant entries, in the solved order
            H0 = np.zeros((nsolved, nsolved))
            H0[np.ix_(sidx, sidx)] = H
            H0[pidx, pidx] = -prior_prec[pidx]
            H0_t = as_tensor(H0)

        def solve_static(rhs):
            """A^-1 rhs for rhs (..., ns, m), through the constant equilibrated factor."""
            return scale_t[:, None] * torch.cholesky_solve(rhs * scale_t[:, None], Ls_t)

        def primal(s_traced, full, batch):
            """The pipeline at ``full`` with the traced solved parameters at
            ``s_traced`` (B, nt): the concatenated whitened residuals, and what
            else is read from the nodes' state (it must be returned from
            inside the forward-mode transform)."""
            if nt:
                full = dict(full)
                full.update((names[i], s_traced[..., k]) for k, i in enumerate(tidx))
            _, derived = pipe.run_once(full)
            d = torch.cat([like.flatdiff_white for like in gauss], dim=-1) if gauss else \
                torch.zeros((batch, 0), dtype=dtype, device=device)
            other = torch.zeros((batch,), dtype=dtype, device=device)
            for like in others:
                other = other + like.loglikelihood
            rows = [sum(theory.solved_power_basis(basename).flatten(-2) @ matrix for theory, matrix in terms)
                    for basename, terms in plan_t]
            derived = {name: value if isinstance(value, torch.Tensor) else torch.as_tensor(value, dtype=dtype, device=device)
                       for name, value in derived.items()}
            extra = dict(derived=derived, other=other)
            if rows:
                extra['rows'] = torch.stack(rows, dim=-2)
            return d, extra

        def fn(values):
            full = pipe._resolve_values(values, device=device, dtype=dtype)
            s0 = torch.stack([full[n] for n in names], dim=-1)        # (B, nsolved)
            batch = s0.shape[0]
            if nt:
                # the traced rows (nt, B, ndata): forward mode along each solved direction, for every chain at
                # once (the chains are independent), the primal computed once
                tangents = torch.eye(nt, dtype=dtype, device=device)[:, None, :].expand(nt, batch, nt)
                d, Jt, extra = vmap(
                    lambda tangent: jvp(lambda s: primal(s, full, batch), (s0[..., tidx_t],), (tangent,), has_aux=True),
                    out_dims=(None, 0, None))(tangents)
            else:
                d, extra = primal(None, full, batch)
            derived, other, Jan = extra['derived'], extra['other'], extra.get('rows')
            g_prior = -prec_t * (s0 - loc_t)
            if not na:
                g = g_prior - d @ J_t.T
                dx = scale_t * torch.cholesky_solve((g * scale_t)[..., None], Ls_t)[..., 0]
                # -1/2 d.d + 1/2 dx.H_like.dx + g_like.dx == -1/2 |d + J^T dx|^2:
                # the residual after the best-fit solved terms, which does not
                # cancel two large float32 terms
                residual = d + dx @ J_t
                hessian, logdet_chain = H_t, 0.
            else:
                # per-chain rows Ja (B, na, ndata); -H = [[A, C^T], [C, D]] with the
                # constant A: only the Schur complement S = D - C A^-1 C^T (na x na)
                # is factored per chain, in float32, equilibrated like A
                Ja = torch.stack([Jan[..., k, :] if analytic else Jt[k] for analytic, k in sources], dim=-2)
                # a chain whose rows are not finite, or whose Schur complement does
                # not factor, reads -inf; its rows, matrix and right-hand side are
                # masked before the ops that would make NaN, so that no NaN reaches
                # its gradient, and every op is per chain: the others are untouched
                finite = torch.isfinite(Ja).all(-1).all(-1)
                Ja = torch.where(finite[..., None, None], Ja, torch.zeros_like(Ja))
                ga = g_prior[..., pidx_t] - (Ja @ d[..., None])[..., 0]
                JaJa = Ja @ Ja.mT
                D = JaJa + torch.diag_embed(prec_t[pidx_t].expand(ga.shape))
                S, rhs = D, ga
                if ns:
                    gs = (g_prior[..., sidx_t] - d @ J_t.T)[..., None]       # (B, ns, 1)
                    C = Ja @ J_t.T                                          # (B, na, ns)
                    solved_static = solve_static(torch.cat([gs, C.mT], dim=-1))  # A^-1 [gs, C^T]
                    S = S - C @ solved_static[..., 1:]
                    rhs = ga - (C @ solved_static[..., :1])[..., 0]
                with torch.no_grad():
                    factor, _, info = cholesky_equilibrated(S)
                    finite = finite & torch.isfinite(torch.diagonal(factor, dim1=-2, dim2=-1)).all(-1)
                    info = torch.where(finite, info, torch.full_like(info, -1))
                    solved_ok = info == 0
                eye = torch.eye(na, dtype=S.dtype, device=S.device)
                S = torch.where(solved_ok[..., None, None], S, eye)
                rhs = torch.where(solved_ok[..., None], rhs, torch.zeros_like(rhs))
                La, scale_a, _ = cholesky_equilibrated(S)
                dxa = scale_a * torch.cholesky_solve((rhs * scale_a)[..., None], La)[..., 0]
                logdet_chain = 0.
                if ma:
                    if len(ma) == na and len(ms) == ns:
                        Lma, scale_ma = La, scale_a
                    else:
                        # the Schur complement of A_msms in -H_marg, per chain
                        Sm = D[..., ma_t[:, None], ma_t]
                        if ms:
                            Cm = C[..., ma_t[:, None], ms_t]
                            Sm = Sm - Cm @ (scale_m_t[:, None] * torch.cholesky_solve(Cm.mT * scale_m_t[:, None], Lm_t))
                        Sm = torch.where(solved_ok[..., None, None], Sm, eye[:len(ma), :len(ma)])
                        Lma, scale_ma, _ = cholesky_equilibrated(Sm)
                    logdet_chain = 2. * (torch.log(torch.diagonal(Lma, dim1=-2, dim2=-1)).sum(-1)
                                         - torch.log(scale_ma).sum(-1))
                residual = d + (dxa[..., None, :] @ Ja)[..., 0, :]
                dx = torch.zeros_like(s0)
                dx[..., pidx_t] = dxa
                hessian = H0_t.expand(s0.shape[:-1] + H0_t.shape).clone()
                hessian[..., pidx_t[:, None], pidx_t] -= JaJa
                if ns:
                    dxs = solve_static(gs - C.mT @ dxa[..., None])[..., 0]
                    residual = residual + dxs @ J_t
                    dx[..., sidx_t] = dxs
                    hessian[..., pidx_t[:, None], sidx_t] = -C
                    hessian[..., sidx_t[:, None], pidx_t] = -C.mT
            x = s0 + dx
            loglike = -0.5 * (residual * residual).sum(-1) - 0.5 * (logdet + logdet_chain) + other
            if na:
                loglike = torch.where(solved_ok, loglike, torch.full_like(loglike, -np.inf))
            logprior = pipe.logprior(full)
            for i, prior in solved_priors:
                logprior = logprior + prior.logpdf(x[..., i])
            aux = dict(derived, loglikelihood=loglike, logprior=logprior,
                       solved=dict(zip(names, x.unbind(-1))), solved_hessian=hessian)
            if na:
                aux['solved_info'] = info
            return loglike + logprior, aux

        return fn

    def logpost(self, **values):
        """Convenience evaluation -> (B,) log-posterior."""
        if '_logpost_fn' not in self.__dict__:
            self.__dict__['_logpost_fn'] = self.logpost_fn()
        return self.__dict__['_logpost_fn'](values)[0]


class BaseGaussianLikelihood(BaseLikelihood):
    r"""Gaussian likelihood of a flat data vector:
    loglike = -1/2 (t - d)^T C^{-1} (t - d), on the whitened residual.
    Subclasses set ``flatdata`` and the whitening (``initialize(data=...,
    covariance=...)`` or ``_set_whitening``) and define ``flattheory``.
    ``hartlap`` and ``_nmocks``: the mock factors' inputs (1 and 0 without
    mocks)."""

    hartlap = 1.
    _nmocks = 0

    def initialize(self, data=None, covariance=None, precision=None, **kwargs):
        self.flatdata = np.ravel(np.asarray(data, dtype='f8'))
        if precision is not None:
            covariance = inverse(precision)
        if covariance is None:
            raise ValueError('provide covariance or precision')
        self._set_whitening(np.atleast_2d(np.asarray(covariance, dtype='f8')))

    def _set_whitening(self, covariance, hartlap=1.):
        """The covariance, and its precision and whitening with the Hartlap
        factor ``hartlap``; the Percival factor applies on top of them at the
        next ``logpost_fn`` build (:meth:`_apply_mock_factor`)."""
        self.covariance = covariance
        self.precision = self._precision_base = inverse(covariance) * hartlap
        self._whiten = self._whiten_base = whiten_factor(covariance) * np.sqrt(hartlap)
        self._mock_factor = 1.
        self._static_J = {}  # depends on the whitening
        self.__dict__.pop('_logpost_fn', None)

    def _percival_factor(self, nvaried):
        """The Percival 2014 factor m (arXiv:1312.4841) of a covariance from
        ``_nmocks`` mocks, for ``nvaried`` varied and solved parameters; 1
        without mocks, and 1 with a warning outside its regime (nmocks <=
        ndata + 4), where the Hartlap factor applies alone."""
        nm, nd = self._nmocks, self.size
        if not nm:
            return 1.
        if nm < nd + 5:
            self.log.warning('Percival 2014 factor needs nmocks > ndata + 4 (got nmocks={}, ndata={}); '
                             'applying the Hartlap factor only'.format(nm, nd))
            return 1.
        A = 2. / ((nm - nd - 1.) * (nm - nd - 4.))
        B = (nm - nd - 2.) / ((nm - nd - 1.) * (nm - nd - 4.))
        return (1. + B * (nd - nvaried)) / (1. + A + B * (nvaried + 1.))

    def _apply_mock_factor(self, nvaried):
        """Scale the precision by 1 / m (the Percival factor for ``nvaried``
        parameters) from the unscaled whitening: idempotent."""
        factor = self._percival_factor(nvaried)
        if factor != self._mock_factor:
            self._whiten = self._whiten_base / np.sqrt(factor)
            self.precision = self._precision_base / factor
            self._mock_factor = factor
            self._static_J = {}

    def flattheory(self):
        raise NotImplementedError

    def calculate(self, **params):
        diff = self.flattheory() - self.const('flatdata')
        self.flatdiff_white = diff @ self.const('_whiten').T
        self.loglikelihood = -0.5 * (self.flatdiff_white ** 2).sum(-1)

    def solved_flat_basis_fn(self, param):
        """Analytic design rows: none here (None: no observable holds an
        analytic basis)."""
        return None

    @property
    def size(self):
        return len(self.flatdata)


class ObservablesGaussianLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood over a list of observables.

    covariance: explicit matrix of the concatenated data vectors or an
    ``ObservableCovariance`` (its ``nobs`` mocks count), or None -> the
    observables' own covariances (one observable: its covariance, with its
    mocks' global Hartlap and Percival factors; several: block-diagonal,
    each block estimated from mocks carrying its own Hartlap factor and no
    joint Percival factor), else computed analytically from ``footprints``.
    ``scale_covariance`` multiplies the covariance.
    """

    def initialize(self, observables=None, covariance=None, footprints=None, scale_covariance=1., name=None):
        if not is_sequence(observables):
            observables = [observables]
        self.observables = list(observables)
        self.name = name
        for obs in self.observables:
            obs.runtime_info.initialize()
        sizes = [len(obs.flatdata) for obs in self.observables]
        self.flatdata = np.concatenate([obs.flatdata for obs in self.observables])
        nmocks = 0
        if covariance is not None and hasattr(covariance, 'hartlap2007_factor'):
            nmocks = covariance.nobs or 0
            covariance = covariance.value
        if covariance is None:
            covs = [getattr(obs, 'covariance', None) for obs in self.observables]
            if all(cov is not None for cov in covs):
                if len(covs) == 1:
                    covariance = np.asarray(covs[0], dtype='f8')
                    nmocks = self.observables[0].nmocks or 0
                else:
                    # separately estimated covariances: each block from mocks carries its own Hartlap factor,
                    # with its own mocks and block size, folded into the precision
                    covariance = np.zeros((self.flatdata.size,) * 2)
                    start = 0
                    for obs, cov, size in zip(self.observables, covs, sizes):
                        cov = np.asarray(cov, dtype='f8')
                        if getattr(obs, 'nmocks', 0):
                            factor = (obs.nmocks - size - 2.) / (obs.nmocks - 1.)
                            if factor <= 0:
                                raise ValueError('too few mocks ({}) for observable block size {}'.format(obs.nmocks, size))
                            cov = cov / factor
                        covariance[start:start + size, start:start + size] = cov
                        start += size
            elif footprints is not None:
                from ..observables.covariance import ObservablesCovarianceMatrix
                covariance = ObservablesCovarianceMatrix(self.observables, footprints=footprints)()
            else:
                raise ValueError('provide covariance, observables with a covariance or mocks, or footprints')
        covariance = np.atleast_2d(np.asarray(covariance, dtype='f8')) * scale_covariance
        hartlap = 1.
        if nmocks:
            hartlap = (nmocks - len(self.flatdata) - 2.) / (nmocks - 1.)
            if hartlap <= 0:
                raise ValueError('too few mocks ({}) for data size {}'.format(nmocks, len(self.flatdata)))
        self.hartlap, self._nmocks = hartlap, nmocks
        self._set_whitening(covariance, hartlap=hartlap)

    def flattheory(self):
        return torch.cat([obs.flattheory for obs in self.observables], dim=-1)

    def solved_flat_basis_fn(self, param):
        """Where the whitened design row of the solved parameter ``param``
        comes from, for an exactly linear parameter whose theory exposes
        ``solved_power_basis`` (e.g. EFT counterterms): a list of (theory,
        matrix) pairs, one per observable the parameter reaches, such that the
        row is the sum of ``solved_power_basis(basename).flatten() @ matrix.T``
        with matrix = whiten[:, observable's columns] @ window (ndata,
        nell * nk), composed in float64. None if the parameter reaches no
        observable; False if it reaches one with no analytic basis for it or
        with a nonlinear data-side transform (then the linearize path, which
        carries the transform's chain rule, gives its rows)."""
        terms, start = [], 0
        for obs in self.observables:
            stop = start + len(obs.flatdata)
            if any(param.name in calc.runtime_info.params for calc in Pipeline(obs).calculators):
                theory = getattr(getattr(obs, 'wmatrix', None), 'theory', None)
                if getattr(obs, 'transform', None) is not None or \
                        param.basename not in getattr(theory, 'solved_basis_names', ()):
                    return False
                terms.append((theory, self._whiten[:, start:stop] @ obs.wmatrix.wmatrix))
            start = stop
        return terms or None


class FisherGaussianLikelihood(BaseGaussianLikelihood):
    """Compressed Gaussian likelihood from a Fisher forecast (JAX
    ``FisherGaussianLikelihood``): data = the Fisher center, covariance = the
    inverse Fisher matrix, theory = the parameter vector itself. Its
    parameters are the Fisher's, varied: in a sum with a likelihood whose
    pipeline has parameters of the same names, the two share them."""

    def initialize(self, fisher=None, **kwargs):
        if fisher is None:
            raise ValueError('provide a LikelihoodFisher')
        self._names = fisher.names()
        for p in fisher.params:
            self.params.set(p.clone(fixed=False, derived=False))
        super().initialize(data=fisher.center, covariance=fisher.covariance())

    def flattheory(self):
        return torch.stack([self._values[name] for name in self._names], dim=-1)

    def calculate(self, **params):
        self._values = {name: params[name.split('.')[-1]] for name in self._names}
        super().calculate()


class SumLikelihood(BaseLikelihood):
    """Sum of independent likelihoods (JAX ``SumLikelihood``); ``a + b``
    builds one, and ``a + b + c`` one over the three."""

    def initialize(self, likelihoods=None, **kwargs):
        if not is_sequence(likelihoods):
            likelihoods = [likelihoods]
        self._likelihoods = list(likelihoods)
        self.requires = list(self._likelihoods)

    @property
    def likelihoods(self):
        if '_likelihoods' not in self.__dict__:
            # not yet initialized (lazy lifecycle): read the init config so
            # that chained sums (a + b + c) flatten
            likes = self.init.get('likelihoods')
            return list(likes) if is_sequence(likes) else [likes]
        return list(self._likelihoods)

    def calculate(self, **params):
        self.loglikelihood = sum(like.loglikelihood for like in self._likelihoods)
