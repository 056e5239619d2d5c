"""Ensemble samplers: the affine-invariant stretch move (Goodman & Weare 2010)
and differential ensemble slice sampling (Karamanis & Beutler 2020).

Counterpart of ``desilike_tpu/samplers/ensemble.py`` (the reference's emcee
and zeus bindings). The walkers are the batch axis; a step moves the two
half-ensembles in turn, each against the other, and every posterior call is
one batched call over a half. Each step takes its draws as arguments.

With a mesh, each rank holds its rows of each half (its state is its rows
of the first half, then its rows of the second) and moves them against the
other half gathered whole from every rank.
"""

import torch

from .base import BasePosteriorSampler
from .mcmc import _where, _select_aux, _stack_records


def _default_nwalkers(ndim):
    return max(64, 2 * ((ndim + 1) // 2) * 2)


def _halves(tensor, half):
    return tensor[:half], tensor[half:]


def _split_aux(aux, half):
    return {name: value[:half] for name, value in aux.items()}, {name: value[half:] for name, value in aux.items()}


def _join_aux(auxa, auxb):
    return {name: torch.cat([auxa[name], auxb[name]]) for name in auxa}


class _HalvesMixin(object):
    """The layout of the two half-ensembles over the mesh."""

    def _local_halves(self, *values):
        """This rank's rows of each half of whole-ensemble values, joined."""
        half = self.nwalkers // 2
        out = tuple(_tree_cat(*(self._shard_chains(_tree_slice(v, s)) for s in (slice(None, half), slice(half, None))))
                    for v in values)
        return out if len(out) > 1 else out[0]

    def _local_draws(self, draws, dims):
        """This rank's rows of each draw of a half move (``dims``: each draw's walker axis)."""
        return tuple(self._shard_chains(d, dim=dim) for d, dim in zip(draws, dims))

    def _all_halves(self, records):
        """Whole-ensemble records (nsteps, nwalkers, ...) from every rank's
        halves (the rank's first half, then its second, along axis 1)."""
        if self.mesh is None:
            return records
        local = next(iter(records.values())).shape[1] // 2
        return {name: torch.cat([self._all_chains(value[:, :local], dim=1), self._all_chains(value[:, local:], dim=1)],
                                dim=1) for name, value in records.items()}


def _tree_slice(value, sl):
    return {k: v[sl] for k, v in value.items()} if isinstance(value, dict) else value[sl]


def _tree_cat(a, b):
    return _join_aux(a, b) if isinstance(a, dict) else torch.cat([a, b])


class EnsembleSampler(_HalvesMixin, BasePosteriorSampler):
    """Stretch-move ensemble sampler.

    Parameters
    ----------
    likelihood : BaseLikelihood
    nwalkers : int, default=max(64, 2*ndim rounded up to even)
    a : float, default=2.
        Stretch scale parameter.
    """

    def __init__(self, likelihood, nwalkers=None, a=2., **kwargs):
        super().__init__(likelihood, **kwargs)
        if nwalkers is None:
            nwalkers = _default_nwalkers(self.ndim)
        if nwalkers % 2:
            raise ValueError('nwalkers must be even')
        self.nwalkers = int(nwalkers)
        self.a = float(a)

    def _move(self, x_move, lp_move, aux_move, x_other, partners, u, accept_u):
        """Stretch move of one half against the other: partners (half,)
        indices into the other half, u and accept_u (half,) uniforms."""
        a, ndim = self.a, self.ndim
        xp = x_other[partners]
        z = ((a - 1.) * u + 1.) ** 2 / a
        y = xp + z[:, None] * (x_move - xp)
        lp_y, aux_y = self.logpost_batch(y)
        logratio = (ndim - 1.) * torch.log(z) + lp_y - lp_move
        accept = torch.log(accept_u) < logratio
        return (_where(accept, y, x_move), torch.where(accept, lp_y, lp_move), _select_aux(accept, aux_y, aux_move),
                accept)

    def step(self, state, draws_a, draws_b):
        """One ensemble step: the first half moves against the second, then
        the second against the moved first. state = (x, lp, aux, naccept);
        draws_a, draws_b = (partners, u, accept_u) of each half (this rank's
        rows with a mesh). Returns (state, record)."""
        x, lp, aux, naccept = state
        half = x.shape[0] // 2
        (xa, xb), (lpa, lpb), (auxa, auxb) = _halves(x, half), _halves(lp, half), _split_aux(aux, half)
        xa, lpa, auxa, acc_a = self._move(xa, lpa, auxa, self._all_chains(xb), *draws_a)
        xb, lpb, auxb, acc_b = self._move(xb, lpb, auxb, self._all_chains(xa), *draws_b)
        x, lp, aux = torch.cat([xa, xb]), torch.cat([lpa, lpb]), _join_aux(auxa, auxb)
        naccept = naccept + acc_a.sum() + acc_b.sum()
        return (x, lp, aux, naccept), {'x': x, 'logposterior': lp, **aux}

    def _draws(self):
        half = self.nwalkers // 2
        return (torch.randint(0, half, (half,), generator=self.generator, device=self.device),
                self.uniform(half), self.uniform(half))

    def run(self, nsteps=500, thin=1, burnin=0, resume=False):
        """Run the ensemble; returns a Chain of shape (nsteps_kept, nwalkers).
        resume=True continues from the final state of the previous run."""
        if resume and getattr(self, '_state', None) is not None:
            start, lp0, aux0, _ = self._state
        else:
            start, lp0 = self._local_halves(*self.get_start(self.nwalkers))
            _, aux0 = self.logpost_batch(start)
        state = (start, lp0, aux0, torch.zeros((), dtype=torch.int64, device=self.device))
        records = []
        with torch.no_grad():
            for _ in range(nsteps):
                draws_a, draws_b = (self._local_draws(self._draws(), (0, 0, 0)) for _ in range(2))
                state, record = self.step(state, draws_a, draws_b)
                records.append(record)
        self._state = state
        self.diagnostics['acceptance_rate'] = float(self._sum_chains(state[3])) / (nsteps * self.nwalkers)
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + nsteps
        self.diagnostics['host_reads'] = self.diagnostics.get('host_reads', 0) + 2  # acceptance, records
        records = self._all_halves(_stack_records(records))
        x = records.pop('x')
        sl = slice(burnin, None, thin)
        return self._make_chain(x[sl], {k: v[sl] for k, v in records.items()},
                                attrs={'sampler': 'ensemble', 'acceptance_rate': self.diagnostics['acceptance_rate']})


class EnsembleSliceSampler(_HalvesMixin, BasePosteriorSampler):
    """Differential ensemble slice sampler (Karamanis & Beutler 2020,
    arXiv:2002.06212; the reference's zeus binding).

    Each walker slice-samples along a direction mu*(x_a - x_b) drawn from
    the complementary half-ensemble. The JAX package's per-walker while
    loops become lockstep loops over the half with per-walker masks: the
    stepping-out loop evaluates both bracket ends of every walker in one
    batched call an iteration, the shrinkage loop one point a walker, and
    each loop ends when no walker is active (one host read an iteration) or
    at ``maxsteps``. A walker's ``ncall`` counts only its own active
    iterations, as the batched while loop does.

    Parameters
    ----------
    likelihood : BaseLikelihood
    nwalkers : int, default=max(64, 2*ndim rounded up to even)
    mu : float, default=1.
        Direction scale.
    maxsteps : int, default=16
        Bound on the stepping-out expansions and on the shrinks of a move.
    """

    def __init__(self, likelihood, nwalkers=None, mu=1., maxsteps=16, **kwargs):
        super().__init__(likelihood, **kwargs)
        if nwalkers is None:
            nwalkers = _default_nwalkers(self.ndim)
        if nwalkers % 2:
            raise ValueError('nwalkers must be even')
        self.nwalkers = int(nwalkers)
        self.mu = float(mu)
        self.maxsteps = int(maxsteps)
        self.host_reads = self.evaluations = 0  # the loops' reads and batched calls

    def _move(self, x0, lp0, aux0, x_other, ia, ib, uy, w, shrink):
        """Slice move of one half against the other. ia, ib (half,) distinct
        walker indices into the other half; uy (half,) the slice height's
        uniform; w (half,) the bracket's offset uniform; shrink (maxsteps,
        half) one uniform a shrink iteration. Returns (x, lp, aux, accepted,
        ncall (half,))."""
        half = x0.shape[0]
        d = self.mu * (x_other[ia] - x_other[ib])
        logy = lp0 + torch.log(uy)
        left = -w
        right = left + 1.
        # stepping out: both ends of every walker in one call an iteration
        expand_l = torch.ones(half, dtype=torch.bool, device=x0.device)
        expand_r = expand_l.clone()
        nexp = torch.zeros(half, dtype=torch.int64, device=x0.device)
        for _ in range(self.maxsteps):
            active = expand_l | expand_r
            self.host_reads += 1
            if not bool(active.any()):
                break
            lps = self.logpost_batch(torch.cat([x0 + left[:, None] * d, x0 + right[:, None] * d]))[0]
            self.evaluations += 1
            expand_l = expand_l & (lps[:half] > logy)
            expand_r = expand_r & (lps[half:] > logy)
            left = torch.where(expand_l, left - 1., left)
            right = torch.where(expand_r, right + 1., right)
            nexp = nexp + active
        # shrinkage towards t = 0
        done = torch.zeros(half, dtype=torch.bool, device=x0.device)
        nshr = torch.zeros_like(nexp)
        x_cur, lp_cur, aux_cur = x0, lp0, aux0
        for i in range(self.maxsteps):
            active = ~done
            self.host_reads += 1
            if not bool(active.any()):
                break
            t = torch.maximum(left, shrink[i] * (right - left) + left)
            x_new = x0 + t[:, None] * d
            lp_new, aux_new = self.logpost_batch(x_new)
            self.evaluations += 1
            accept = active & (lp_new > logy)
            reject = active & ~accept
            left = torch.where(reject & (t < 0.), t, left)
            right = torch.where(reject & (t >= 0.), t, right)
            x_cur, lp_cur = _where(accept, x_new, x_cur), torch.where(accept, lp_new, lp_cur)
            aux_cur = _select_aux(accept, aux_new, aux_cur)
            done = done | accept
            nshr = nshr + active
        return x_cur, lp_cur, aux_cur, done, nexp + nshr

    def step(self, state, draws_a, draws_b):
        """One ensemble step (first half against the second, then the second
        against the moved first); state = (x, lp, aux, naccept, ncall), each
        draws = (ia, ib, uy, w, shrink) of :meth:`_move`. Returns (state, record)."""
        x, lp, aux, naccept, ncall = state
        half = x.shape[0] // 2
        (xa, xb), (lpa, lpb), (auxa, auxb) = _halves(x, half), _halves(lp, half), _split_aux(aux, half)
        xa, lpa, auxa, acc_a, nc_a = self._move(xa, lpa, auxa, self._all_chains(xb), *draws_a)
        xb, lpb, auxb, acc_b, nc_b = self._move(xb, lpb, auxb, self._all_chains(xa), *draws_b)
        x, lp, aux = torch.cat([xa, xb]), torch.cat([lpa, lpb]), _join_aux(auxa, auxb)
        naccept = naccept + acc_a.sum() + acc_b.sum()
        ncall = ncall + nc_a.sum() + nc_b.sum()
        return (x, lp, aux, naccept, ncall), {'x': x, 'logposterior': lp, **aux}

    def _draws(self):
        half = self.nwalkers // 2
        ia = torch.randint(0, half, (half,), generator=self.generator, device=self.device)
        ib = torch.randint(0, half - 1, (half,), generator=self.generator, device=self.device)
        ib = torch.where(ib >= ia, ib + 1, ib)  # a distinct pair
        return ia, ib, self.uniform(half), self.uniform(half), self.uniform(self.maxsteps, half)

    def run(self, nsteps=300, thin=1, burnin=0, resume=False):
        """Run the slice ensemble; returns a Chain of shape (nsteps_kept, nwalkers)."""
        reads0, evaluations0 = self.host_reads, self.evaluations
        if resume and getattr(self, '_state', None) is not None:
            start, lp0, aux0 = self._state[:3]
        else:
            start, lp0 = self._local_halves(*self.get_start(self.nwalkers))
            _, aux0 = self.logpost_batch(start)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        state = (start, lp0, aux0, zero, zero)
        records = []
        with torch.no_grad():
            for _ in range(nsteps):
                draws_a, draws_b = (self._local_draws(self._draws(), (0, 0, 0, 0, 1)) for _ in range(2))
                state, record = self.step(state, draws_a, draws_b)
                records.append(record)
        self._state = state
        naccept, ncall = self._sum_chains(torch.stack([state[3], state[4]])).tolist()
        self.diagnostics['acceptance_rate'] = float(naccept) / (nsteps * self.nwalkers)
        self.diagnostics['ncall'] = int(ncall) + self.nwalkers
        self.diagnostics['iterations'] = self.diagnostics.get('iterations', 0) + nsteps
        self.diagnostics['evaluations'] = self.diagnostics.get('evaluations', 0) + self.evaluations - evaluations0
        self.diagnostics['host_reads'] = self.diagnostics.get('host_reads', 0) + self.host_reads - reads0 + 3
        records = self._all_halves(_stack_records(records))
        x = records.pop('x')
        sl = slice(burnin, None, thin)
        return self._make_chain(x[sl], {k: v[sl] for k, v in records.items()},
                                attrs={'sampler': 'ensemble_slice',
                                       'acceptance_rate': self.diagnostics['acceptance_rate']})
