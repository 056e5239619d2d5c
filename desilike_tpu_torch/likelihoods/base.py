"""Gaussian likelihood with analytic marginalization over linear nuisances.

Counterpart of ``desilike_tpu/likelihoods/base.py`` on its two exactly
linear paths. A solved parameter enters the theory linearly either with a
static basis (the BAO broadband towers ``al*``, the stochastic terms
``sn*``), so that its whitened design row is a build-time constant, or with
a basis that the theory exposes per chain (``solved_power_basis``: the EFT
counterterms ``ct*`` multiply pk11), so that its row comes from the primal
run. Either way the Newton solve needs no per-evaluation tangents:

  g = prior_grad - J d,  H = prior_hess - J J^T   (whitened space),
  dx = -H^{-1} g,  loglike = -1/2 d.d + 1/2 dx.H_like.dx + g_like.dx
                             - 1/2 logdet(-H_marg),

with H_like = -J J^T and g_like = -J d, so that the first three terms are
-1/2 |d + J^T dx|^2, which is how they are computed here.

The block of H over the static rows is the same for every chain: its
Jacobi-equilibrated Cholesky factor and log-determinant are computed once,
on the host in float64 (raising if it is not positive definite), and with
static rows only the per-evaluation work is a batched triangular solve.
Per-chain rows add the Schur complement of that block, one small matrix
(4 x 4 for two tracers' counterterms) per chain, equilibrated and factored
in float32 with ``torch.linalg.cholesky_ex``; a chain whose matrix does not
factor reads -inf, as the reference's clipped pivots give a value for every
chain (its ``info`` is returned in ``aux``, not read on the host). The
``jax.linearize`` path for non-linear solved parameters, ``.prec`` folding
and ``SumLikelihood`` wait for ROADMAP A8, the Percival/Hartlap factors for
A12.
"""

import fnmatch

import numpy as np
import torch

from ..core import Calculator
from ..ops.linalg import whiten_factor, cholesky, cholesky_equilibrated
from ..utils import is_sequence
from .. import config


class BaseLikelihood(Calculator):
    """Base likelihood: get() returns the log-likelihood; derived
    loglikelihood/logprior."""

    _params = {'loglikelihood': dict(derived=True, latex=r'\ln\mathcal{L}'),
               'logprior': dict(derived=True, latex=r'\ln p')}
    solved_default = '.marg'

    @property
    def likelihoods(self):
        return [self]

    def get(self):
        return self.loglikelihood

    def _solved_setup(self, pipe):
        solved = pipe.solved_params
        if any(p.derived.split('_not_derived')[0] == '.prec' for p in solved):
            raise NotImplementedError("'.prec' solved parameters (precision folding) are ROADMAP A8")
        names = solved.names()
        marg_idx = []
        loc = np.zeros(len(names))
        prec = np.zeros(len(names))
        for i, p in enumerate(solved):
            status = p.derived.split('_not_derived')[0]
            if status == '.auto':
                status = self.solved_default
            if status == '.marg':
                marg_idx.append(i)
            if p.prior is not None and p.prior.dist == 'norm':
                loc[i] = p.prior.loc
                prec[i] = p.prior.scale ** -2
        return names, solved, np.array(marg_idx, dtype='i8'), loc, prec

    def _static_linear_indices(self, pipe, solved):
        """Indices of solved params whose theory contribution is exactly
        linear with a static basis (owner declares ``_static_linear_solved``)."""
        static = []
        for i, p in enumerate(solved):
            for owner in pipe._param_owners.get(p.name, []):
                patterns = getattr(owner, '_static_linear_solved', ())
                if any(fnmatch.fnmatch(p.basename, pat) for pat in patterns):
                    static.append(i)
                    break
        return static

    def _compute_static_J(self, pipe, names):
        """Exact constant design matrix (len(names), ndata) of the solved
        parameters ``names`` by unit-step differences (exact for linear
        contributions): ONE batched float64 host evaluation of
        len(names) + 1 rows, defaults then one unit step per parameter."""
        defaults = pipe.input_defaults()
        values = {}
        for name, value in defaults.items():
            column = np.full(len(names) + 1, float(value))
            if name in names:
                column[1 + names.index(name)] += 1.
            values[name] = column
        pipe.run_once(pipe._resolve_values(values, device=torch.device('cpu'), dtype=config.HOST_DTYPE))
        diffs = self.flatdiff_white.numpy()
        return diffs[1:] - diffs[0]

    def _analytic_basis_plan(self, solved, dyn_idx):
        """For solved parameters without a static design matrix whose theory
        exposes ``solved_power_basis`` (exactly linear terms with a per-chain
        basis, e.g. EFT counterterms x pk11), the J rows come from the primal
        run. Returns (analytic_idx, plan): plan maps a solved index to the
        list of (theory, matrix) pairs that :meth:`solved_flat_basis_fn` gives."""
        getter = getattr(self, 'solved_flat_basis_fn', None)
        analytic, plan = [], {}
        for i in dyn_idx:
            terms = getter(solved[i]) if getter is not None else None
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
        nsolved = len(names)

        def as_tensor(array):
            return torch.as_tensor(np.asarray(array), dtype=dtype, device=device)

        if nsolved == 0:
            def fn(values):
                full = pipe._resolve_values(values, device=device, dtype=dtype)
                _, derived = pipe.run_once(full)
                aux = dict(derived, loglikelihood=self.loglikelihood, logprior=pipe.logprior(full))
                return aux['loglikelihood'] + aux['logprior'], aux
            return fn

        sidx = self._static_linear_indices(pipe, solved)
        aidx, plan = self._analytic_basis_plan(solved, [i for i in range(nsolved) if i not in sidx])
        left = [n for i, n in enumerate(names) if i not in sidx and i not in aidx]
        if left:
            raise NotImplementedError('solved parameters {} have neither a static design matrix nor an analytic '
                                      'basis (a correlation-function theory has none for its power node\'s '
                                      'counterterms): the linearize path is ROADMAP A8'.format(left))
        if aidx and 0 < marg_idx.size < nsolved:
            raise NotImplementedError("'.best' and '.marg' solved parameters mixed with per-chain design rows")
        ns, na = len(sidx), len(aidx)
        # --- the constant block: static rows Js (ns, ndata), A = Js Js^T + P_s, factored once in float64 ---
        if self._static_J is None:
            self._static_J = self._compute_static_J(pipe, [names[i] for i in sidx])
        J = np.asarray(self._static_J, dtype='f8')
        if J.shape != (ns, self.size):
            raise ValueError('static design matrix has shape {}, expected {}'.format(J.shape, (ns, self.size)))
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
        logdet = 0.
        if marg_idx.size and ns:
            # logdet(-H_m) = logdet(-Hs_m) - 2 sum(log scale_m)
            local = np.array([sidx.index(i) for i in marg_idx if i in sidx], dtype='i8')
            Lm = Ls if local.size == ns else cholesky(torch.from_numpy(-Hs[np.ix_(local, local)]))
            logdet = 2. * float(torch.log(torch.diagonal(Lm)).sum()) - 2. * float(np.log(scale[local]).sum())
        J_t, H_t = as_tensor(J), as_tensor(H)
        Ls_t, scale_t = as_tensor(Ls), as_tensor(scale)
        loc_t, prec_t = as_tensor(prior_loc), as_tensor(prior_prec)
        solved_priors = [(i, p.prior) for i, p in enumerate(solved) if p.prior is not None]
        sidx_t = torch.as_tensor(sidx, dtype=torch.long, device=device)
        aidx_t = torch.as_tensor(aidx, dtype=torch.long, device=device)
        plan_t = [[(theory, as_tensor(matrix.T)) for theory, matrix in plan[i]] for i in aidx]
        basenames = [solved[i].basename for i in aidx]
        if na:
            # the hessian's constant entries, in the solved order
            H0 = np.zeros((nsolved, nsolved))
            H0[np.ix_(sidx, sidx)] = H
            H0[aidx, aidx] = -prior_prec[aidx]
            H0_t = as_tensor(H0)

        def solve_static(rhs):
            """A^-1 rhs for rhs (..., ns, m), through the constant equilibrated factor."""
            return scale_t[:, None] * torch.cholesky_solve(rhs * scale_t[:, None], Ls_t)

        def fn(values):
            full = pipe._resolve_values(values, device=device, dtype=dtype)
            _, derived = pipe.run_once(full)
            d = self.flatdiff_white                                   # (B, ndata)
            s0 = torch.stack([full[n] for n in names], dim=-1)        # (B, nsolved)
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
                Ja = torch.stack([sum(theory.solved_power_basis(basename).flatten(-2) @ matrix
                                      for theory, matrix in terms)
                                  for basename, terms in zip(basenames, plan_t)], dim=-2)
                # a chain whose rows are not finite, or whose Schur complement does
                # not factor, reads -inf; its rows, matrix and right-hand side are
                # masked before the ops that would make NaN, so that no NaN reaches
                # its gradient, and every op is per chain: the others are untouched
                finite = torch.isfinite(Ja).all(-1).all(-1)
                Ja = torch.where(finite[..., None, None], Ja, torch.zeros_like(Ja))
                ga = g_prior[..., aidx_t] - (Ja @ d[..., None])[..., 0]
                JaJa = Ja @ Ja.mT
                S = JaJa + torch.diag_embed(prec_t[aidx_t].expand(ga.shape))
                rhs = ga
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
                if marg_idx.size:
                    logdet_chain = 2. * (torch.log(torch.diagonal(La, dim1=-2, dim2=-1)).sum(-1)
                                         - torch.log(scale_a).sum(-1))
                residual = d + (dxa[..., None, :] @ Ja)[..., 0, :]
                dx = torch.zeros_like(s0)
                dx[..., aidx_t] = dxa
                hessian = H0_t.expand(s0.shape[:-1] + H0_t.shape).clone()
                hessian[..., aidx_t[:, None], aidx_t] -= JaJa
                if ns:
                    dxs = solve_static(gs - C.mT @ dxa[..., None])[..., 0]
                    residual = residual + dxs @ J_t
                    dx[..., sidx_t] = dxs
                    hessian[..., aidx_t[:, None], sidx_t] = -C
                    hessian[..., sidx_t[:, None], aidx_t] = -C.mT
            x = s0 + dx
            loglike = -0.5 * (residual * residual).sum(-1) - 0.5 * (logdet + logdet_chain)
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
    Subclasses set ``flatdata``, call ``_set_whitening`` and define
    ``flattheory``."""

    _static_J = None

    def _set_whitening(self, covariance):
        self.covariance = covariance
        self._whiten = whiten_factor(covariance)
        self._static_J = None  # depends on the whitening
        self.__dict__.pop('_logpost_fn', None)

    def flattheory(self):
        raise NotImplementedError

    def calculate(self, **params):
        diff = self.flattheory() - self.const('flatdata')
        self.flatdiff_white = diff @ self.const('_whiten').T
        self.loglikelihood = -0.5 * (self.flatdiff_white ** 2).sum(-1)

    @property
    def size(self):
        return len(self.flatdata)


class ObservablesGaussianLikelihood(BaseGaussianLikelihood):
    """Gaussian likelihood over a list of observables.

    covariance: explicit matrix of the concatenated data vectors, or None ->
    computed analytically from ``footprints``.
    """

    def initialize(self, observables=None, covariance=None, footprints=None):
        if not is_sequence(observables):
            observables = [observables]
        self.observables = list(observables)
        for obs in self.observables:
            obs.runtime_info.initialize()
        self.flatdata = np.concatenate([obs.flatdata for obs in self.observables])
        if covariance is None:
            if footprints is None:
                raise ValueError('provide covariance or footprints')
            from ..observables.covariance import ObservablesCovarianceMatrix
            covariance = ObservablesCovarianceMatrix(self.observables, footprints=footprints)()
        self._set_whitening(np.atleast_2d(np.asarray(covariance, dtype='f8')))

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
        observable or one of them has no analytic basis for it."""
        from ..core import Pipeline
        terms, start = [], 0
        for obs in self.observables:
            stop = start + len(obs.flatdata)
            if any(param.name in calc.runtime_info.params for calc in Pipeline(obs).calculators):
                theory = getattr(getattr(obs, 'wmatrix', None), 'theory', None)
                if param.basename not in getattr(theory, 'solved_basis_names', ()):
                    return None
                terms.append((theory, self._whiten[:, start:stop] @ obs.wmatrix.wmatrix))
            start = stop
        return terms or None
