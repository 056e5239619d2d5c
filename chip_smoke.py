"""Smoke test of the PyTorch port (desilike_tpu_torch) on one CUDA card.

Drives the port's main paths on the card, at full width, through the
hand-written CUDA kernels, and checks them: the batched config-1 BAO
log-posterior of ``__graft_entry__._build_likelihood``, the batched
config-4 joint two-tracer full-shape + BAO log-posterior of
``bench.build_likelihood`` and the batched config-3 1-loop EPT full-shape
log-posterior of ``scripts/bench_ept.py`` and the batched config-xi BAO
log-posterior in configuration space (config 1's likelihood on xi
multipoles, :func:`build_xi_likelihood`) and the batched config-3xi
log-posterior (config 3's theory on xi multipoles, its counterterms solved
by the linearize path, :func:`build_ept_xi_likelihood`) and the batched
config-3d log-posterior (BASELINE's config 3: config 3 on direct
cosmology parameters, the cosmology evaluated per chain,
:func:`build_ept_direct_likelihood`), each with its gradient; the Fisher
forecast of config xi and of config 3d, and the sum of config xi's
compressed likelihood with config 3; the batched config-5 log-posterior (config 4 with
its templates emulated: MLP for ShapeFit, Taylor for BAO,
:func:`build_emulated_likelihood`); the batched config-tns log-posterior
(config 3's calls with the EFT-like TNS theory, whose A/B tables look the
template's pk up at 460800 points a chain, :func:`build_tns_likelihood`);
the batched config-3f log-posterior (BASELINE's config 3 fed from files:
measured data, 1000 mocks, a window file, fiber collisions and systematic
templates, :func:`build_files_likelihood` over the files :func:`write_files`
writes) and the BAO compression likelihood; the batched config-3j
log-posterior (config 3d + the CMB distance prior + DES-Y5 supernovae + BBN,
:func:`build_probes_likelihood`), ``Cosmology(theta=True)``; and the gradient samplers (ChEES, NUTS) over config 4, ChEES over config 3,
NUTS over config 5.

1. the card (nvidia-smi name and power limit), torch and CUDA versions, the
   kernel library's build time, ptxas's registers, and the blocks of each
   coefficient-gradient instance an SM holds;
2. the kernels against their plain PyTorch versions. The Clenshaw series
   (:func:`kernel_cases`): the main-path shapes (B in {1, 4096}, Q = 560,
   the template's order 202), ragged Q in {1, 3, 561} at orders {1, 2, 3,
   203, 320}, shared and per-row coefficients, with and without exp, an x
   view with a storage offset, 70000 rows (also walked with a grid stride),
   K = 2 and 8 queries a thread, the (56, 1) lookup's one-block launch; and
   its x-gradient against autograd through the plain version at B = 1 and
   4096. The coefficient gradient (:func:`coeff_grad_cases`): B in {1,
   4096} x Q in {288, 560} at order 202, per-row and shared, with and
   without exp, ragged Q in {1, 3, 561} at orders {1, 2, 3, 203, 320}, 70000
   rows (also walked with a grid stride), and the prefetching path's cases:
   4097 rows (not a multiple of the persistent grid's teams), 70000 x 288 on
   7 blocks (each team walks many rows), an unaligned x (no prefetch); and
   the full backward of the series (x and coefficients) against autograd
   through the plain version at (4096, 288, 202) per-row; both kernels at
   config 3's shapes (:func:`ept_cases`: (B, 288, 105) series and (B, 288,
   320) exp'd, per-row, B in {4096, 32768}); the series at config xi's
   (:func:`xi_cases`: (B, 3000, 230) shared, exp'd, B in {4096, 65536},
   and the (300, 1) lookup) and its x-gradient at B = 4096; both kernels at
   config 3xi's (:func:`ept_xi_cases`); both at config tns's
   (:func:`tns_cases`: (1024, 460800, 320) per-row exp'd with one row of x
   shared by every coefficient row, and the shared x at a ragged Q and at
   the float4 layout), both at config 3f's (:func:`files_cases`: (B, 2800,
   144) series and (B, 2800, 320) exp'd, per-row, B in {4096, 16384}), and
   both past 2^31 queries (:func:`check_tns_overflow`:
   (4700, 460800), the last rows); and the derivatives of the
   Functions that launch them (:func:`check_derivatives`:
   ``torch.func.jvp``, ``jacfwd``, ``vmap``, double backward and reverse
   mode over ``vmap`` of ``jvp``) at
   (4096, 288, 202) per-row and (4096, 560, 202) shared;
3. the likelihoods at full width. Config 1: log-posterior and gradient over
   B = 4096 seeded chains (finite, through the kernel; launches counted
   forward and with the gradient), the frozen JAX values of
   ``tests/data/torch_port_bao_reference.npz``, the ``damped_bao`` golden
   vector of ``tests/data/golden_theories.npz`` from a theory built with no
   device (the card by default), and the gradient on the card against the
   port's CPU plain path. Config 4: the same over B = 4096 chains (both
   kernels launched, the 30 solved parameters in ``aux['solved']``), the
   frozen JAX values of ``tests/data/torch_port_joint_reference.npz``, the
   card against the CPU plain path at 4 points, and the ``kaiser`` and
   ``eft_kaiser`` golden vectors; one chain of B = 4096 forced to fail
   (the others bit-identical, it reads -inf); the synchronising CUDA calls
   of one forward call (``torch.cuda.set_sync_debug_mode``); the samplers'
   start-point Hessian diagonal on the card against the CPU plain path and
   the frozen JAX x64 values of ``tests/data/torch_port_hessian_reference.npz``
   (launches counted). Config 3 (:func:`check_config3`): log-posterior and
   gradient at B = 4096 and 32768 (launches and peak device memory, forward
   and with the gradient), the frozen JAX values of
   ``tests/data/torch_port_ept_reference.npz``, the card against the CPU
   plain path at 4 points, and the ``ept``, ``ept_resum`` and
   ``ept_physical`` golden vectors. Config 3d (:func:`check_config3d`): the
   same at B = 4096 and 32768 beside config 3 (wall and device
   milliseconds), the frozen values of
   ``tests/data/torch_port_direct_reference.npz``, the ``eh99_pk`` golden,
   the synchronising calls beside config 3's, and its Fisher on the card
   against the CPU path. Config xi (:func:`check_config_xi`): the
   same at B = 4096 and 65536, its frozen values in
   ``tests/data/torch_port_xi_reference.npz``, the start-point Hessian
   diagonal through the rfft/irfft pair, the ``damped_bao_xi`` golden
   vector, and ``ept_xi`` and ``ept_xi_resum`` against the JAX package's x64
   vectors. Config 3xi (:func:`check_config_3xi`): the same at B = 4096 and
   at EPT_XI_BIG_BATCH (wall and device milliseconds a call), its frozen JAX x64 values and solved
   counterterms in ``tests/data/torch_port_marg_reference.npz``, the CPU
   path at 4 points. The Fisher of config xi and the sum
   (:func:`check_fisher_and_sum`) against the same file. Config 5
   (:func:`check_config5`): the JAX package's emulators carried across from
   ``tests/data/torch_port_emulator_reference.npz``, against its x64 and
   float32 values at 16 points and the CPU path at 4; then the port's own
   emulators fitted on the card (``check()`` of each), log-posterior and
   gradient at B = 4096 and 32768 (launches, wall and device milliseconds,
   peak memory). Config tns (:func:`check_config_tns`): forward at B = 1024
   and 4096, with the gradient at 1024 and 2048 (launches, peak memory, wall
   and device milliseconds beside config 3's), the synchronising calls of
   one forward call, the forward call at 4096 by kind (the Clenshaw
   lookup, B10's operators, the rest), its frozen JAX x64 values in
   ``tests/data/torch_port_tns_reference.npz``, the CPU path at 4 points,
   and the goldens of the theories ported with it. Config 3f
   (:func:`check_config3f`): its files written into a temporary directory,
   the likelihood built from them (its Hartlap and Percival factors against
   the JAX package's), forward at B = 4096 and 16384 and with the gradient
   at 4096 (launches, peak memory, wall and device milliseconds beside
   config 3d's, the shapes each kernel launch gets), its frozen JAX x64
   values in ``tests/data/torch_port_observables_reference.npz`` and the CPU
   path at 4 points. The BAO compression likelihood
   (:func:`check_bao_compression`): B = 4096, its frozen JAX x64 values.
   Config 3j (:func:`check_config3j`: config 3d + the CMB distance prior +
   DES-Y5 supernovae + BBN on one ``Cosmology`` node): its 1829 supernovae
   written and read, forward at B = 4096 and 32768 and with the gradient at
   4096 (launches, peak memory, the solved ``Mb``, wall and device
   milliseconds and busy share beside config 3d's), its frozen JAX x64
   values and solved parameters in
   ``tests/data/torch_port_probes_reference.npz``, the CPU path at 4 points;
   ``Cosmology(theta=True)`` at B = 4096 (:func:`check_theta`: converged
   share, residual, gradient, h against JAX x64); the CMB family
   (:func:`check_cmb_family`: each likelihood from files the port's writers
   wrote, at B = 4096 forward and with the gradient, against the port's
   CPU path at CMB_CHECK_ROWS chains);
4. times (reported, not gated): the Clenshaw kernel's device time from
   CUDA-graph replay of 50 launches at (4096, 560, 202) shared and per-row,
   (4096, 288, 202) per-row and (65536, 560, 202) shared, the coefficient
   gradient's at (4096, 288, 202) and (4096, 560, 202) per-row, each beside
   its bound; the wrapper's host time a call; the plain versions; the
   nearest library call to the coefficient gradient
   (``torch.special.chebyshev_polynomial_t`` over (B, Q, order), then an
   einsum); and log-posterior evaluations per second, config 1 at B = 4096
   and 65536, config 4 at B = 4096 (forward and with the gradient) and 32768,
   config 3 at B = 4096 and 32768 and config xi at B = 4096 and 65536 (both
   forward and with the gradient); the kernels at the Hessian's shapes (18
   rows), at config 3's (:func:`time_ept_kernels`, beside their bounds,
   plain versions and, for the coefficient gradient, the library call) and
   at config xi's (:func:`time_xi_kernel`, beside its bound, plain version
   and, at B = 4096, ``chebyshev_polynomial_t`` + einsum + exp) and at config
   3xi's (:func:`time_ept_kernels` over :func:`ept_xi_cases`); the nearest
   library call to the series (:func:`library_series_ms`) at configs 1, 4
   and 3's shapes too; both kernels at the templates' own lookups
   (:func:`template_cases`); the cosmology node of config 3d alone
   (:func:`time_cosmology_node`); config 3d's evals/s beside config 3's;
   both kernels at config tns's shape (:func:`time_ept_kernels` with a
   shared x, B = 1024 and 4096, beside their bounds, the plain versions at
   1024 and the one-GEMM library route) and config tns's evals/s beside
   config 3's; both kernels at the shapes config 3f's launches got in phase
   3, and at 16384 (:func:`time_ept_kernels`), and config 3f's evals/s;
5. the samplers (:func:`run_samplers`): on config 4 ChEES over B = 4096
   chains (24 warmup and 8 sampling iterations, at most 32 leapfrog steps)
   and NUTS over 64 chains (max_depth 5); on config 3 ChEES over B = 4096
   chains (24 + 8 iterations, at most 16 leapfrog steps); on config 5 NUTS
   over B = 4096 chains (8 + 4 iterations, max_depth 4,
   :func:`run_emulated_nuts`) and its Fisher against config 4's; each with
   the launch counters set to 0 just before and read just after;
   iterations/s, chain-gradient evaluations/s, launches a leapfrog step,
   step size, trajectory length, acceptance, leaves and host reads an
   iteration;
A15. the samplers, profilers and profile containers of ROADMAP A15
   (:func:`run_a15`), each run with the launch counters set to 0 just
   before and read just after (seconds, iterations/s, chain evaluations/s,
   launches of both kernels, host reads, acceptance, peak device memory):
   on config 3d, Metropolis over 4096 chains (16 adaptation and 8 frozen
   steps), the stretch ensemble over 4096 walkers (16 steps), the slice
   ensemble over 1024 (4 steps), the grid (size 3, 3^9 points) and QMC
   (4096 points); nested sampling on config 1 (4096 live points, 1024 a
   batch step, dlogz 0.5, at most 16 batch steps; logz and logzerr) and one
   batch step timed reading ``done.all()`` and with 32 fixed iterations;
   the Metropolis chain reweighted under config 3j; on config 3d the
   L-BFGS-B profiler from 2 starts with its parabolic errors (the best fit
   re-evaluated on the port's CPU path within 2e-2, no lower than its
   start) and the Adam profiler over 256 starts in one batch (200 steps);
   the blocked sampler over 8 chains on a likelihood with a host-evaluated
   node (at most nsteps + 2 host calls); and each new step given the same
   draws on the card and on the CPU path (:func:`check_same_draws`, within
   1e-5 relative). Raises unless every record is finite, the Metropolis and
   stretch acceptance lies in (0, 1), the Clenshaw kernel was launched in
   every run on configs 3d, 1 and 3j and the coefficient-gradient kernel
   under the profilers.

Any failure raises (exit code 1). The last three lines of standard output
are a JSON object describing the kernels, one with the samplers' numbers,
then ``{"ok": true, "device": ...}``.
Needs one CUDA device and no network; imports nothing of JAX.

Run from the repository root: ``python3 chip_smoke.py`` (``--kernels-only``
stops after phase 2 and prints no result line).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
BIG_BATCH = 65536
JOINT_BIG_BATCH = 32768  # the batch the JAX package's bench uses for config 4
NQUERY = 560  # BAO lookups: 56 k bins x 10 mu nodes per chain
FS_NQUERY = 288  # full-shape lookups: 36 k bins x 8 mu nodes per chain
ORDER = 202  # the templates' Chebyshev order
EPT_BIG_BATCH = 32768  # the batch the JAX package's EPT bench uses for config 3
EPT_ORDER = 320  # config 3's template order (1200 points from 1e-4 to 20)
EPT_WORK_ORDER = 105  # config 3's loop tables on the working grid (96 points)
EPT_SAMPLER_LEAPFROG = 16  # most leapfrog steps of ChEES on config 3 in phase 5
XI_NQUERY = 3000  # config xi's lookups: the P(k) model's 300 k x 10 mu nodes a chain
XI_ORDER = 230  # config xi's template order (2000 points from 1e-4 to 1.2)
EPT_XI_NQUERY = 2400  # config 3xi's lookups: the EPT P(k) model's 300 k x 8 mu nodes a chain
EPT_XI_WORK_ORDER = 205  # config 3xi's loop tables on the working grid (to 1.7 x 0.6 h/Mpc)
EPT_XI_BIG_BATCH = 16384  # config 3xi's large batch: the largest power of two that fits with the gradient (not 32768)
TNS_NQUERY = 96 * 300 * 16  # config tns's A/B-table lookups: pk at |k - q| on (nk_loop, nq_tns, nmu_tns) a chain
TNS_BATCHES = (1024, 4096)  # config tns forward
TNS_GRAD_BATCHES = (1024, 2048)  # config tns with the gradient: 2048 reckoned at ~30 GiB before the first run (PERF.md)
TNS_CHECK_ROWS = 1024  # the rows at which the kernels are held against their plain versions at config tns's shape
TNS_OVERFLOW_ROWS = 4700  # rows x TNS_NQUERY past 2^31: the flat index of the last rows needs 64 bits
KGRID = np.geomspace(1e-4, 1., 2000)  # the config-1 template grid
FP32_FLOPS = 67e12   # published H100 SXM FP32 rate outside the tensor cores, at 700 W
HBM_BYTES = 3.35e12  # published H100 SXM memory rate
KERNEL_RTOL = 1e-5   # of the output's magnitude: the kernel fuses 2x b1 - b2 + c into one FFMA
                     # and an FADD where torch rounds every operation, both float32
COEFF_GRAD_RTOL = 1e-4  # of the gradient's magnitude: sums of up to 561 (per-row) or 39 M (shared) terms
                        # in another order, over a forward T_j recurrence with a fused multiply-add
# config 4 against the frozen JAX values at 16 points. Against x64: the float32 pipeline's own
# rounding on 368 data, almost all of it in the whitened residual, whose theory vector carries 1e-6
# of relative float32 error against errors of ~2% (measured on the CPU: log-posterior within 8.1e-3,
# gradient within 5.6e-5 of its norm; in float64 the port is within 9e-11 and 3e-12). Against the
# JAX package's float32 values, which are 5.5e-2 and 2.0e-3 from its own x64 values (it cancels
# terms of ~1e4): measured 5.4e-2 and 2.0e-3, with the JAX host state 6.2e-2 and 5.8e-4.
JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL = 2e-2, 5e-4
JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL = 0.15, 1e-2
# config 3 against the frozen JAX values at 16 points, at config 4's limits: on the CPU the port is within
# 1.9e-3 of x64 on the log-posterior and 7.4e-5 of the gradient's norm (1.5e-2 and 3.6e-4 from the JAX
# package's float32 values), and within 2e-10 and 2e-12 in float64
EPT_X64_ATOL, EPT_X64_GRAD_RTOL = JOINT_X64_ATOL, JOINT_X64_GRAD_RTOL
EPT_F32_ATOL, EPT_F32_GRAD_RTOL = JOINT_F32_ATOL, JOINT_F32_GRAD_RTOL
# derivatives through the kernels against the same transforms of the plain recurrence, of the result's
# magnitude: first derivatives (jvp, jacfwd, vmap) as the forward kernel (1e-6 measured on an H100); second
# ones run the derivative series of the derivative series, whose terms grow as (2 j)^2 c_j (2.3e-5 there)
SECOND_RTOL = 1e-4
HESSIAN_RTOL = 1e-4  # the start-point Hessian's diagonal, of its largest entry: float32 against x64 (5e-6 on an H100)
# config xi against the frozen JAX values at 16 points, at config 1's limits: on the CPU the port is within 1.0e-4 of
# x64 on the log-posterior and 8.3e-5 of the gradient's norm, and 3.8e-4 and 2.7e-4 from the JAX package's float32
# values (4.4e-4 and 2.6e-4 from its own x64 ones); in float64 within 1.8e-12 and 6.2e-13
XI_X64_ATOL, XI_X64_GRAD_RTOL = 2e-3, 5e-4
XI_F32_ATOL, XI_F32_GRAD_RTOL = 5e-2, 1e-2
# the xi theories with a shot noise at the golden sn0 = 500 (a constant 5e6 in the P(k) monopole), in float32, of their
# largest value from the JAX package's x64 vectors: the P(k) node's own float32 rounding (1.3e-4 to 2.7e-4 on the CPU);
# the JAX package's float32 goldens are 1.1e-2 to 4.2e-2 from them (tests/test_torch_xi.py)
SHOT_NOISE_F32_RTOL = 1e-3
# config 3xi against the frozen JAX x64 values at 16 points: config 3's limits; on the CPU the port is within 6e-3 of
# the log-posterior and 1.8e-4 of the gradient's norm, its loop tables in float64 (8e-4 with them in float32; the JAX
# package's own float32 values are 7.4e-2 and 5.1e-3 away); the solved counterterms within 1e-3 of their prior width
SOLVED_RTOL = 1e-3
FISHER_RTOL = 1e-3  # config xi's Fisher matrix against JAX x64: |dF_ij| <= FISHER_RTOL sqrt(F_ii F_jj)
SAMPLER_BATCH = BATCH  # ChEES chains on config 4
HESSIAN_ROWS = 18  # the start-point Hessian's batch: one copy of the point a varied parameter of config 4
EMU_MLP_CHECK = 0.05  # Emulator.check() of an MLP template: the JAX package's bound (tests/test_config5.py:30)
EMU_TAYLOR_CHECK = 1e-3  # Emulator.check() of a Taylor-emulated BAO template (its qpar, qper: linear in theta)
EMU_TRACERS = (('LRG', 0.8, 2.0), ('ELG', 1.1, 1.3))  # configs 4 and 5: namespace, redshift, b1 of the mock data
# config 3d's cosmological parameters: chains (and the frozen points) drawn uniformly within these of the fiducial
COSMO_CENTER = {'h': 0.6736, 'omega_cdm': 0.12, 'omega_b': 0.02237, 'logA': 3.036394, 'n_s': 0.9649}
COSMO_WIDTH = {'h': 0.02, 'omega_cdm': 0.006, 'omega_b': 0.0008, 'logA': 0.1, 'n_s': 0.02}
# config 5's template grids: those the theories give their templates (full_shape.py and bao.py ``_klim``), so that
# the emulated tables have config 4's shapes and Chebyshev order
EMU_FS_K = np.geomspace(1e-3, 1., 500)
EMU_BAO_K = np.geomspace(1e-4, 1., 2000)
# config 3f: config 3d fed from files (write_files, build_files_likelihood)
FILES_SEED = 0
FILES_ELLS = (0, 2, 4)
FILES_NMOCKS = 1000
FILES_BATCHES = (4096, 16384)  # config 3f forward; with the gradient at the first
FILES_NQUERY = 350 * 8  # config 3f's lookups: the window's 350 input k a multipole x 8 mu nodes a chain
FILES_WORK_ORDER = 144  # config 3f's loop tables on the working grid (96 points from 6e-4 to 0.595 h/Mpc)
FILES_NBAR, FILES_VOLUME = 5e-4, 2e9  # config 3d's footprint: the shot noise and the mocks' Gaussian covariance
FILES_WNORM = 7.3  # the normalization the files store the power with, as pypower does
FILES_KINLIM = (1e-4, 20.)  # the window's input grid cut to the EPT template's k range (theories/ept.py _klim_template)
FILES_FIBER_COLLISIONS = dict(fs=0.5, Dfc=0.5)  # the JAX package's test values (tests/test_fiber_collisions.py:121)
# config 3j: config 3d + the CMB distance prior + DES-Y5 supernovae + BBN (write_probe_files, build_probes_likelihood)
PROBES_SEED = 0
CMB_SEED = 5
PROBES_NSN = 1829  # the DES-SN5YR sample (arXiv:2401.02929)
# h solved from 100 theta_* in float32 against JAX x64: float32's rounding of theta_* (~3.5e-7 of it) is ~1.2e-6 of h
# through d h / d theta_* ~ 3.4 (6.0e-7 measured on the CPU at the 16 frozen points)
THETA_H_ATOL = 5e-6
# the CMB family's points, by basename: the ClTheory response (amp, tilt), the calibrations and the foregrounds around
# their defaults (``cmb_points``)
CMB_CENTER = {'amp': 1., 'tilt': 0., 'A_planck': 1., 'Aradio': 60., 'Adusty': 6., 'Acib': 4., 'beta_cib': 1.75,
              'Atsz': 3., 'Aksz': 1., 'xi': 0.1, 'AdustT': 1., 'beta_dustT': 1.51, 'AdustP': 1., 'beta_dustP': 1.59,
              'cal0': 1., 'cal2': 1., 'calTE': 1., 'calEE': 1., 'amp_143': 10., 'amp_217': 10., 'amp_143x217': 10.,
              'n_143': 1., 'n_217': 1., 'n_143x217': 1., 'amp_100': 0., 'n_100': 1.,
              **{'cal' + m: 1. for m in ('100A', '100B', '143B', '217A', '217B')}}
CMB_WIDTH = {'amp': 0.02, 'tilt': 0.01, 'A_planck': 0.003, 'Aradio': 5., 'Adusty': 1., 'Acib': 1., 'beta_cib': 0.05,
             'Atsz': 1., 'Aksz': 0.5, 'xi': 0.05, 'AdustT': 0.1, 'beta_dustT': 0.01, 'AdustP': 0.1,
             'beta_dustP': 0.02, 'cal0': 0.002, 'cal2': 0.002, 'calTE': 0.01, 'calEE': 0.01, 'amp_143': 2.,
             'amp_217': 2., 'amp_143x217': 2., 'n_143': 0.1, 'n_217': 0.1, 'n_143x217': 0.1, 'amp_100': 1.,
             'n_100': 0.1, **{'cal' + m: 0.005 for m in ('100A', '100B', '143B', '217A', '217B')}}
CMB_CHECK_ROWS = 8  # the chains at which each CMB likelihood on the card is held against the port on the CPU
PROBES_BATCHES = (4096, 32768)  # config 3j forward; with the gradient at the first (7.5 GiB reckoned, PERF.md)
SYSTEMATIC_TEMPLATES = {'syst_a': lambda k: 1e2 / k, 'syst_b': lambda k: 0. * k + 50.}  # tests/test_fiber_collisions.py:141


def build_likelihood(device):
    """Config 1 in the port, as a user builds it (``device=None``: the card)."""
    from desilike_tpu_torch import (DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    template = BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper')
    theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2), template=template)
    theory.init.params = {'al*': dict(derived='.marg')}
    klim = {0: (0.02, 0.3, 0.005), 2: (0.02, 0.3, 0.005)}
    obs = TracerPowerSpectrumMultipolesObservable(data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0},
                                                  klim=klim, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline
    return like


def build_joint_likelihood(device, templates=None):
    """Config 4 in the port, with the calls of the JAX package's bench:
    two tracers, each with a full-shape observable (ShapeFit template,
    EFT-like Kaiser theory, counterterms and stochastic terms marginalized)
    and a BAO observable (broadband marginalized); ``device=None``: the card.
    ``templates``: {namespace: node} in place of the templates (LRG, LRGbao,
    ELG, ELGbao), as config 5 gives them."""
    from desilike_tpu_torch import (DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate,
                                    ShapeFitPowerSpectrumTemplate, EFTLikeKaiserTracerPowerSpectrumMultipoles,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    templates = templates or {}
    observables, footprints = [], []
    for tracer, z, b1 in EMU_TRACERS:
        template = templates[tracer] if tracer in templates else ShapeFitPowerSpectrumTemplate(z=z, namespace=tracer)
        fs_theory = EFTLikeKaiserTracerPowerSpectrumMultipoles(ells=(0, 2), template=template, namespace=tracer)
        fs_theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
        observables.append(TracerPowerSpectrumMultipolesObservable(
            data={'{}.b1'.format(tracer): b1},
            klim={0: (0.02, 0.2, 0.005), 2: (0.02, 0.2, 0.005)}, theory=fs_theory))
        footprints.append(BoxFootprint(volume=2e9, nbar=5e-4))
        template = templates[tracer + 'bao'] if tracer + 'bao' in templates else \
            BAOPowerSpectrumTemplate(z=z, namespace=tracer + 'bao')
        bao_theory = DampedBAOWigglesTracerPowerSpectrumMultipoles(ells=(0, 2), template=template,
                                                                   namespace=tracer + 'bao')
        bao_theory.init.params = {'al*': dict(derived='.marg')}
        observables.append(TracerPowerSpectrumMultipolesObservable(
            data={'{}bao.b1'.format(tracer): b1},
            klim={0: (0.02, 0.3, 0.005), 2: (0.02, 0.3, 0.005)}, theory=bao_theory))
        footprints.append(BoxFootprint(volume=2e9, nbar=5e-4))
    like = ObservablesGaussianLikelihood(observables=observables, footprints=footprints, device=device)
    like.pipeline
    return like


def carried_emulator(reference, namespace, template):
    """The JAX package's emulator of ``namespace`` in ``reference`` (the
    arrays of ``tests/data/torch_port_emulator_reference.npz``), carried
    across: its emulator file through ``Emulator.load`` on ``template``
    and, for an MLP, its flax weights through ``interop.mlp_state_from_flax``."""
    import tempfile
    from desilike_tpu_torch import Emulator
    from desilike_tpu_torch.interop import mlp_state_from_flax
    prefix = namespace + ':'
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'emulator.npz')
        np.savez(path, **{key[len(prefix):]: reference[key] for key in reference.files if key.startswith(prefix)
                          and key[len(prefix):].split(':')[0] in ('meta', 'fixed', 'engine')})
        emulator = Emulator.load(path, calculator=template)
    if emulator.engine.name == 'mlp':
        layers = sorted({key.split(':')[2] for key in reference.files if key.startswith(prefix + 'flax:')})
        params = {layer: {w: reference['{}flax:{}:{}'.format(prefix, layer, w)] for w in ('kernel', 'bias')}
                  for layer in layers}
        norm = [reference['{}norm:{:d}'.format(prefix, i)] for i in range(4)]
        emulator.engine.set_weights(*mlp_state_from_flax(params, norm))
    return emulator


def emulated_templates(device, reference=None):
    """Config 5's templates as emulators, {namespace: Emulator}: each tracer's
    ShapeFit template (on EMU_FS_K) by an MLP with the engine's defaults
    (hidden (64, 64), 512 Sobol samples, 3000 Adam steps, lr 3e-3, seed 7),
    its BAO template (on EMU_BAO_K) by a Taylor series of order 3. Fitted on
    ``device`` (None: the card), or carried across from ``reference``
    (:func:`carried_emulator`)."""
    from desilike_tpu_torch import (BAOPowerSpectrumTemplate, ShapeFitPowerSpectrumTemplate, Emulator,
                                    MLPEmulatorEngine, TaylorEmulatorEngine)
    out = {}
    for tracer, z, _ in EMU_TRACERS:
        for namespace, template, engine in (
                (tracer, ShapeFitPowerSpectrumTemplate(z=z, k=EMU_FS_K, namespace=tracer, device=device),
                 MLPEmulatorEngine),
                (tracer + 'bao', BAOPowerSpectrumTemplate(z=z, k=EMU_BAO_K, namespace=tracer + 'bao', device=device),
                 lambda: TaylorEmulatorEngine(order=3))):
            if reference is None:
                out[namespace] = Emulator(template, engine=engine()).fit()
            else:
                out[namespace] = carried_emulator(reference, namespace, template)
    return out


def build_emulated_likelihood(device, reference=None):
    """Config 5 in the port: config 4 (:func:`build_joint_likelihood`) with
    its templates replaced by the emulated nodes (``Emulator.to_calculator``)
    of :func:`emulated_templates` (fitted on ``device``, or carried across
    from ``reference``); 18 varied, 30 solved, 368 data. ``device=None``:
    the card."""
    emulators = emulated_templates(device, reference)
    return build_joint_likelihood(device, {ns: emu.to_calculator() for ns, emu in emulators.items()})


def build_ept_likelihood(device):
    """Config 3 in the port, with the calls of the JAX package's EPT bench
    (``scripts/bench_ept.py``): ShapeFit template, IR-resummed 1-loop EPT
    multipoles (0, 2, 4), counterterms and stochastic terms marginalized;
    ``device=None``: the card."""
    from desilike_tpu_torch import (EPTTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    theory = EPTTracerPowerSpectrumMultipoles(ells=(0, 2, 4), template=ShapeFitPowerSpectrumTemplate(z=0.8))
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(
        data={'b1': 2.0}, klim={ell: (0.02, 0.2, 0.005) for ell in (0, 2, 4)}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline
    return like


TNS_SMALL = dict(nq_tns=40, nmu_tns=8, nk_loop=48)  # config tns at a small width (the CPU tests')


def build_tns_likelihood(device, small=False):
    """Config tns in the port: config 3's calls (``scripts/bench_ept.py``)
    with the EFT-like TNS theory at its defaults (FFTLog loops, nk_loop 96,
    nq_tns 300, nmu_tns 16, Lorentzian FoG: the A/B tables' pk at |k - q| on
    96 x 300 x 16 = 460800 points a chain), ``ct*`` and ``sn*``
    marginalized, ``b3`` and ``sigmav`` varied; ``small``: at
    :data:`TNS_SMALL`; ``device=None``: the card."""
    from desilike_tpu_torch import (EFTLikeTNSTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    theory = EFTLikeTNSTracerPowerSpectrumMultipoles(ells=(0, 2, 4), template=ShapeFitPowerSpectrumTemplate(z=0.8),
                                                     **(TNS_SMALL if small else {}))
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(
        data={'b1': 2.0}, klim={ell: (0.02, 0.2, 0.005) for ell in (0, 2, 4)}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline
    return like


def build_ept_direct_likelihood(device):
    """Config 3d in the port: BASELINE's config 3, the 1-loop EPT full-shape
    likelihood on direct cosmology parameters, with the calls of
    :func:`build_ept_likelihood` but the template
    ``DirectPowerSpectrumTemplate(z=0.8)``: its default varied parameters
    (h, omega_cdm, omega_b, logA, n_s) on the eh98 engine, evaluated per
    chain; 10 varied, 6 solved, 108 data. ``device=None``: the card."""
    from desilike_tpu_torch import (EPTTracerPowerSpectrumMultipoles, DirectPowerSpectrumTemplate,
                                    TracerPowerSpectrumMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    theory = EPTTracerPowerSpectrumMultipoles(ells=(0, 2, 4), template=DirectPowerSpectrumTemplate(z=0.8))
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(
        data={'b1': 2.0}, klim={ell: (0.02, 0.2, 0.005) for ell in (0, 2, 4)}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline
    return like


def files_layout(small=False):
    """The grids of config 3f's files: the window's input grid (``kin``, one
    per input multipole), its output bins' centres (``kout``, 0.001 h/Mpc
    bins at full width, five to a data bin), the data bins' edges, the number
    of mocks and the window's coupling width; the data's k step, and the EPT
    node's settings and the template's varied parameters at that width (the
    small width: the reduced build of ``tests/test_ept.py:91-112``)."""
    if small:
        return dict(kin=5e-3 * np.arange(1, 71), kout=1e-3 + 2e-3 * np.arange(200), edges=1e-2 * np.arange(41),
                    nmocks=100, width=0.02, step=0.01, ept=dict(nk_loop=64, mu=6, nk_template=500),
                    varied=('h', 'omega_cdm', 'logA'))
    return dict(kin=1e-3 * np.arange(1, 351), kout=5e-4 + 1e-3 * np.arange(400), edges=5e-3 * np.arange(81),
                nmocks=FILES_NMOCKS, width=0.01, step=0.005, ept={}, varied=None)


def legendre_product_integral(ells):
    """The integral over [-1, 1] of the product of the Legendre polynomials of ``ells``."""
    from numpy.polynomial import legendre
    poly = np.array([1.])
    for ell in ells:
        poly = legendre.legmul(poly, np.eye(ell + 1)[ell])
    integ = legendre.legint(poly)
    return float(legendre.legval(1., integ) - legendre.legval(-1., integ))


def gaussian_covariance(kin, power, edges, volume, shotnoise, ells=FILES_ELLS, resolution=3):
    """The Gaussian covariance of the power spectrum multipoles ``ells`` in
    the k bins ``edges`` of a box of ``volume`` with ``shotnoise``, from the
    multipoles ``power`` (nells, nk) on ``kin``: the formula of the port's
    ``ObservablesCovarianceMatrix`` (pk-pk) at its ``resolution`` points a bin
    (config 3d's analytic covariance), in numpy."""
    nbins = len(edges) - 1
    products = {(la, lb, l1, l2): legendre_product_integral((la, lb, l1, l2))
                for la in ells for lb in ells for l1 in ells for l2 in ells}
    cov = np.zeros((len(ells) * nbins,) * 2)
    for ibin, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        kq = np.linspace(lo, hi, resolution + 2)[1:-1]
        pk = {ell: np.interp(kq, kin, power[i] + (ell == 0) * shotnoise) for i, ell in enumerate(ells)}
        for i1, l1 in enumerate(ells):
            for i2, l2 in enumerate(ells):
                sigma = (2 * l1 + 1) * (2 * l2 + 1) / volume * sum(
                    pk[la] * pk[lb] * products[la, lb, l1, l2] for la in ells for lb in ells)
                cov[i1 * nbins + ibin, i2 * nbins + ibin] = (2. * np.pi) ** 3 / (4. / 3. * np.pi * (hi ** 3 - lo ** 3)) \
                    * np.sum(kq ** 2 * sigma) / np.sum(kq ** 2)
    return cov


def write_files(directory, seed=FILES_SEED, small=False, fiducial_power=None):
    """Write config 3f's measured products into ``directory``, with numpy
    alone, in the formats the readers take (pypower-style ``.npy`` state
    dicts, as ``tests/test_interop.py:14-26``, :77-95 write them):

    - ``wmatrix.npy``: a window from the input multipoles (0, 2, 4) on
      ``kin`` to the output multipoles (0, 2, 4) on ``kout`` (a Gaussian
      coupling of ``width`` in k, normalized over the inputs, 0.05 between
      different multipoles) with a shot-noise response ``vectorout``;
    - ``data.npy`` and ``mock_0000.npy`` ... : the fiducial windowed theory
      (``fiducial_power``, the EPT multipoles (0, 2, 4) on ``kin`` at b1 =
      2, by default the JAX package's x64 ones frozen in
      ``tests/data/torch_port_observables_reference.npz``, through the
      window and its shot-noise response, averaged five output bins to a
      data bin), each plus a Gaussian draw from config 3d's analytic
      covariance on the data bins (:func:`gaussian_covariance`), from
      ``np.random.default_rng(seed)``; with the shot noise 1 / nbar in the
      monopole and a normalization, as pypower stores them.

    Returns the paths of the window, the data and the mocks' glob pattern."""
    layout = files_layout(small)
    if fiducial_power is None:
        reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_observables_reference.npz'))
        fiducial_power = reference[('small_' if small else '') + 'fiducial_power']
    kin, kout, edges, nmocks = layout['kin'], layout['kout'], layout['edges'], layout['nmocks']
    ells, nbins = FILES_ELLS, len(edges) - 1
    coupling = np.exp(-((kout[None, :] - kin[:, None]) / layout['width']) ** 2)
    coupling /= coupling.sum(axis=0, keepdims=True)
    value = np.block([[(1. if ellin == ellout else 0.05) * coupling for ellout in ells] for ellin in ells])
    vectorout = [1. - 0.05 * np.exp(-kout / 0.02), 0.02 * np.exp(-kout / 0.05), 0.01 * np.exp(-kout / 0.05)]
    window = {'xin': [kin] * len(ells), 'xout': [kout] * len(ells), 'value': value, 'vectorout': vectorout,
              'projsin': [{'ell': ell, 'wa_order': 0} for ell in ells],
              'projsout': [{'ell': ell, 'wa_order': None} for ell in ells]}
    shotnoise = 1. / FILES_NBAR
    monopole = np.array([ell == 0 for ell in ells], dtype='f8')[:, None]
    fine = value.T @ np.ravel(fiducial_power) + shotnoise * (np.concatenate(vectorout) - np.repeat(monopole[:, 0], len(kout)))
    mean = fine.reshape(len(ells), nbins, -1).mean(axis=-1).ravel()
    cov = gaussian_covariance(kin, fiducial_power, edges, FILES_VOLUME, shotnoise, ells)
    noise = np.random.default_rng(seed).standard_normal((1 + nmocks, cov.shape[0])) @ np.linalg.cholesky(cov).T
    k = (edges[:-1] + edges[1:]) / 2.

    def state(power):
        return {'k': k, 'ells': np.array(ells), 'edges': [edges], 'wnorm': FILES_WNORM,
                'power_nonorm': (power.reshape(len(ells), nbins) + shotnoise * monopole) * FILES_WNORM,
                'shotnoise_nonorm': shotnoise * FILES_WNORM}

    os.makedirs(directory, exist_ok=True)
    paths = dict(wmatrix=os.path.join(directory, 'wmatrix.npy'), data=os.path.join(directory, 'data.npy'),
                 mocks=os.path.join(directory, 'mock_*.npy'))
    np.save(paths['wmatrix'], window)
    np.save(paths['data'], state(mean + noise[0]))
    for imock in range(nmocks):
        np.save(os.path.join(directory, 'mock_{:04d}.npy'.format(imock)), state(mean + noise[1 + imock]))
    return paths


def build_files_likelihood(device, directory, small=False):
    """Config 3f in the port: BASELINE's config 3 (config 3d,
    :func:`build_ept_direct_likelihood`) fed from the files that
    :func:`write_files` wrote into ``directory``: the measured data, 1000
    mocks for the covariance (the Hartlap factor at build, the Percival
    factor in ``logpost_fn``), the window file (rebinned 5:1 to the data's
    bins, its input grid limited to the EPT template's range), top-hat fiber
    collisions folded into it, and two systematic templates whose amplitudes
    ``syst_*`` are solved with a static design matrix beside ``ct*`` (per
    chain) and ``sn*`` (static); the EPT loop tables in float64; 9 varied, 8
    solved, 108 data at full width (the small width: :func:`files_layout`,
    7 varied, 54 data, 100 mocks). ``device=None``: the card."""
    from desilike_tpu_torch import (EPTTracerPowerSpectrumMultipoles, DirectPowerSpectrumTemplate,
                                    TracerPowerSpectrumMultipolesObservable, ObservablesGaussianLikelihood)
    from desilike_tpu_torch.observables import TopHatFiberCollisionsPowerSpectrumMultipoles
    import torch
    layout = files_layout(small)
    template = DirectPowerSpectrumTemplate(z=0.8, **({'varied': layout['varied']} if layout['varied'] else {}))
    theory = EPTTracerPowerSpectrumMultipoles(ells=FILES_ELLS, template=template, **layout['ept'])
    # the loop tables in float64, as config 3xi's: in float32 the gradient missed its 5e-4 gate against JAX x64 on
    # the card (5.4e-4 of its norm at 16 points; the loops on a working grid that reaches down to 6e-4 h/Mpc)
    theory._loop_dtype = torch.float64
    theory.init.params = {'ct*': dict(derived='.marg'), 'sn*': dict(derived='.marg')}
    observable = TracerPowerSpectrumMultipolesObservable(
        data=os.path.join(directory, 'data.npy'), covariance=[os.path.join(directory, 'mock_*.npy')],
        wmatrix=os.path.join(directory, 'wmatrix.npy'), klim={ell: (0.02, 0.2, layout['step']) for ell in FILES_ELLS},
        kinlim=FILES_KINLIM, fiber_collisions=TopHatFiberCollisionsPowerSpectrumMultipoles(**FILES_FIBER_COLLISIONS),
        systematic_templates=SYSTEMATIC_TEMPLATES, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], device=device)
    like.pipeline.params.update({'syst_*': dict(derived='.marg')}, basename=True)
    return like


def write_probe_files(directory, seed=PROBES_SEED, small=False):
    """Write config 3j's supernova sample into ``directory`` in the DES-Y5
    layout (``DESY5SNLikelihood``'s reader: a 'key = value' config file, a CSV
    light-curve table with a '#' comment line and the columns zHD, zHEL, MU
    and MUERR_FINAL, and the systematic covariance as its size then the
    flattened matrix), through the port's ``write_sn_dataset``. PROBES_NSN
    supernovae (the DES-SN5YR size, arXiv:2401.02929: 194 at 0.025 < z < 0.1
    and the rest up to z = 1.13), 64 with ``small``; seeded and synthetic: a
    dense systematic covariance (a smooth kernel in z and a low-z calibration
    mode), per-supernova errors MUERR_FINAL, and MU the fiducial cosmology's
    distance modulus (with the heliocentric term) plus noise drawn from the
    full covariance. Returns the number of supernovae."""
    from desilike_tpu_torch.cosmology import background as bg
    from desilike_tpu_torch.likelihoods.supernovae import write_sn_dataset
    rng = np.random.default_rng(seed)
    n = 64 if small else PROBES_NSN
    nlow = int(round(n * 194 / PROBES_NSN))
    z = np.sort(np.concatenate([rng.uniform(0.025, 0.1, nlow), 0.1 + 1.03 * rng.beta(2., 3., n - nlow)]))
    zhel = z + rng.normal(0., 5e-4, n)
    muerr = 0.1 + 0.1 * z + 0.03 * rng.uniform(size=n)
    lowz = (z < 0.1).astype('f8')
    cov = 0.02 ** 2 * np.exp(-0.5 * ((z[:, None] - z[None, :]) / 0.25) ** 2) + 0.01 ** 2 * np.outer(lowz, lowz) \
        + 1e-6 * np.eye(n)
    fiducial = bg.resolve({})
    dm = bg.comoving_angular_distance(fiducial, z)
    mu = 5. * np.log10((1. + z) * dm / fiducial['h']) + 25. + 5. * np.log10((1. + zhel) / (1. + z))
    mu = mu + np.linalg.cholesky(cov + np.diag(muerr ** 2)) @ rng.standard_normal(n)
    write_sn_dataset(directory, {'zHD': z, 'zHEL': zhel, 'MU': mu, 'MUERR_FINAL': muerr}, cov, header='', sep=',')
    table = os.path.join(directory, 'lcparams.txt')
    with open(table) as fh:
        text = fh.read()
    with open(table, 'w') as fh:
        fh.write('# synthetic DES-Y5-layout sample (seed {:d}, {:d} supernovae)\n'.format(seed, n) + text)
    return n


def build_probes_likelihood(device, directory, small=False):
    """Config 3j in the port: config 3d (:func:`build_ept_direct_likelihood`)
    + the CMB distance prior (``CMBDistancePriorLikelihood``, Chen, Huang &
    Wang 2019) + DES-Y5 supernovae (``DESY5SNLikelihood`` over the files
    :func:`write_probe_files` wrote into ``directory``, ``Mb`` solved) + BBN
    (``Schoneberg2024BBNLikelihood``), all four on config 3d's one
    ``Cosmology`` node, as one ``SumLikelihood``: 9 varied, 7 solved
    (``ct*``, ``sn*``, ``Mb``), 108 + 3 + 1829 + 2 data (64 supernovae with
    ``small``). ``device=None``: the card."""
    from desilike_tpu_torch import (SumLikelihood, CMBDistancePriorLikelihood, DESY5SNLikelihood,
                                    Schoneberg2024BBNLikelihood)
    direct = build_ept_direct_likelihood(device)
    cosmo = direct_template(direct).cosmo
    supernovae = DESY5SNLikelihood(data_dir=directory, cosmo=cosmo)
    supernovae.init.params = {'Mb': dict(derived='.marg')}
    like = SumLikelihood(likelihoods=[direct, CMBDistancePriorLikelihood(cosmo=cosmo), supernovae,
                                      Schoneberg2024BBNLikelihood(cosmo=cosmo)], device=device)
    like.pipeline
    return like


def build_xi_likelihood(device):
    """Config xi in the port: config 1 (:func:`build_likelihood`) in
    configuration space, as a user builds it. Damped BAO xi multipoles (0, 2)
    from the P(k) model on k = geomspace(1e-4, 0.6, 300) x 10 mu nodes by
    FFTLog, over 48-152 Mpc/h in 4 Mpc/h bins (52 data), the broadband
    al{0,2}_{-2,-1,0} marginalized, the xi-xi Gaussian covariance;
    ``device=None``: the card."""
    from desilike_tpu_torch import (DampedBAOWigglesTracerCorrelationFunctionMultipoles, BAOPowerSpectrumTemplate,
                                    TracerCorrelationFunctionMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    template = BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper')
    theory = DampedBAOWigglesTracerCorrelationFunctionMultipoles(ells=(0, 2), template=template)
    theory.init.params = {'al*': dict(derived='.marg')}
    obs = TracerCorrelationFunctionMultipolesObservable(data={'qpar': 1.0, 'qper': 1.0, 'b1': 2.0},
                                                        slim={0: (48., 152., 4.), 2: (48., 152., 4.)}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[obs], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline
    return like


def build_ept_xi_likelihood(device, ells=(0, 2, 4), step=4.):
    """Config 3xi in the port: config 3's theory (:func:`build_ept_likelihood`)
    in configuration space, as a user builds it. IR-resummed 1-loop EPT xi
    multipoles ``ells`` (full width: (0, 2, 4)) of the ShapeFit template at z
    = 0.8 by FFTLog, over s = 30-150 Mpc/h in ``step`` Mpc/h bins (full
    width: 4, 30 bins a multipole, 90 data), ``data={'b1': 2.0}``, the xi-xi
    Gaussian covariance. The counterterms ``ct*`` are solved on the pipeline
    (they live on the xi node's P(k) node), by the linearize path: their xi
    node exposes no analytic basis. The stochastic terms stay varied, as the
    xi theory leaves them (a constant shot noise does not move xi at s > 0);
    10 varied, 3 solved. ``device=None``: the card."""
    from desilike_tpu_torch import (EPTTracerCorrelationFunctionMultipoles, ShapeFitPowerSpectrumTemplate,
                                    TracerCorrelationFunctionMultipolesObservable, BoxFootprint,
                                    ObservablesGaussianLikelihood)
    theory = EPTTracerCorrelationFunctionMultipoles(ells=ells, template=ShapeFitPowerSpectrumTemplate(z=0.8))
    observable = TracerCorrelationFunctionMultipolesObservable(
        data={'b1': 2.0}, slim={ell: (30., 150., step) for ell in ells}, theory=theory)
    like = ObservablesGaussianLikelihood(observables=[observable], footprints=[BoxFootprint(volume=2e9, nbar=5e-4)],
                                         device=device)
    like.pipeline.params.update({'ct*': dict(derived='.marg')}, basename=True)
    return like


def chains(names, batch, seed, device):
    """Seeded parameter batch around the fiducial, inside the priors; b1 is
    centered on the value the tracer's data were generated with."""
    import torch
    rng = np.random.default_rng(seed)
    center = {'qpar': 1., 'qper': 1., 'dbeta': 1., 'df': 1., 'dm': 0., 'b2': 0., 'bs': 0., 'b3nl': 0., 'sn0': 0.,
              'sn2_2': 0., 'b3': 0., 'sigmav': 4., **COSMO_CENTER}
    width = {'qpar': 0.04, 'qper': 0.04, 'b1': 0.3, 'dbeta': 0.1, 'df': 0.1, 'dm': 0.05, 'b2': 0.5, 'bs': 0.5,
             'b3nl': 0.5, 'sn0': 1., 'sn2_2': 5., 'b3': 0.5, 'sigmav': 1., **COSMO_WIDTH}
    values = {}
    for name in names:
        namespace, _, basename = name.rpartition('.')
        mid = (1.3 if namespace.startswith('ELG') else 2.) if basename == 'b1' else center[basename]
        values[name] = torch.tensor(mid + width[basename] * rng.uniform(-1., 1., batch), dtype=torch.float32,
                                    device=device, requires_grad=True)
    return values


def logpost_and_grad(fn, values):
    import torch
    logpost, _ = fn(values)
    logpost.sum().backward()
    grad = torch.stack([v.grad for v in values.values()], dim=-1)
    return logpost.detach(), grad


def check_close(label, got, expected, atol, grad=None, expected_grad=None, grad_rtol=None):
    """Raise unless |got - expected| <= atol, and the gradient within grad_rtol
    of its norm; print the measured errors."""
    err = float(np.abs(np.asarray(got) - np.asarray(expected)).max())
    line = '{}: max |d logpost| {:.3e} (tol {:.1e})'.format(label, err, atol)
    ok = err <= atol
    if grad is not None:
        gerr = float((np.linalg.norm(np.asarray(grad) - expected_grad, axis=-1)
                      / np.linalg.norm(expected_grad, axis=-1)).max())
        line += ', max |d grad|/|grad| {:.3e} (tol {:.1e})'.format(gerr, grad_rtol)
        ok = ok and gerr <= grad_rtol
    print(line)
    if not ok:
        raise AssertionError(line)


def check_derivatives(case, device):
    """The derivatives of the Functions that launch the kernels (``_Clenshaw``
    and, in the coefficients, ``_ClenshawCoeffGrad``) at ``case``'s shape, x
    and coefficients of :func:`case_inputs`, against the same transforms of
    clenshaw_reference: ``torch.func.jvp`` in x and in c, ``jacfwd`` in x and
    in c on a (4, 16) slice, ``vmap`` over a leading batch of 3 (of x, and of
    x and c), double backward (d2/dx2 and d2/(dx dc), through both
    Functions), ``torch.func.hessian`` in x and in c of a scalar on the
    slice, ``vmap`` of ``torch.func.grad`` in c over the batch of 3, and
    reverse mode in x and c over ``vmap`` of ``jvp`` along 3 coefficient
    directions (the linearize path's gradient).
    Returns {label: error relative to the plain result's magnitude}; raises
    beyond KERNEL_RTOL for first derivatives, COEFF_GRAD_RTOL for the
    coefficient gradient and SECOND_RTOL for second derivatives."""
    import torch
    from torch.func import grad, hessian, jacfwd, jvp, vmap
    from desilike_tpu_torch.ops.cuda_kernels import _Clenshaw, clenshaw_reference
    x, c = case_inputs(case, device)
    rng = np.random.default_rng(6)

    def normal(shape, scale=1.):
        return torch.tensor(scale * rng.normal(size=tuple(shape)), dtype=torch.float32, device=device)

    def kernel(x, c):
        return _Clenshaw.apply(x, c, True)

    def rel(got, expected):
        return float((got - expected).abs().max() / expected.abs().max())

    def both(transform):
        return rel(transform(kernel), transform(clenshaw_reference))

    dx, dc = normal(x.shape), normal(c.shape, 1e-3) / (1. + torch.arange(c.shape[-1], device=device))
    errors = {'jvp_x': both(lambda f: jvp(f, (x, c), (dx, torch.zeros_like(c)))[1]),
              'jvp_c': both(lambda f: jvp(f, (x, c), (torch.zeros_like(x), dc))[1])}
    xs, cs = x[:4, :16].contiguous(), c[:4].contiguous() if case['per_row'] else c
    errors['jacfwd_x'] = both(lambda f: jacfwd(f)(xs, cs))
    errors['jacfwd_c'] = both(lambda f: jacfwd(f, argnums=1)(xs, cs))
    x3 = (x + normal((3,) + tuple(x.shape), 1e-3)).clamp(-1., 1.)
    c3 = c + normal((3,) + tuple(c.shape), 1e-4)
    errors['vmap_x'] = both(lambda f: vmap(f, in_dims=(0, None))(x3, c))
    errors['vmap_xc'] = both(lambda f: vmap(f)(x3, c3))
    w, v = normal(x.shape), normal(x.shape)
    second = []
    for function in (kernel, clenshaw_reference):
        xg, cg = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
        gx, gc = torch.autograd.grad((function(xg, cg) * w).sum(), (xg, cg), create_graph=True)
        dxx = torch.autograd.grad((gx * v).sum(), xg, retain_graph=True)[0]  # d2/dx2 along v
        dxc = torch.autograd.grad((gc * gc).sum(), xg)[0]  # through the coefficient gradient's x-derivative
        second.append((dxx, dxc))
    errors['d2_dx2'] = rel(second[0][0], second[1][0])
    errors['d2_dxdc'] = rel(second[0][1], second[1][1])
    # torch.func.hessian (forward over reverse) of a scalar on the slice: the jvp and the vmap rules of
    # both Functions, the coefficient gradient's jvp launching both kernels
    ws, w3 = normal(xs.shape), normal(x3.shape)

    def scalar(f):
        return lambda x, c: (f(x, c) * ws).sum()
    errors['d2_hessian_x'] = both(lambda f: hessian(scalar(f))(xs, cs))
    errors['d2_hessian_c'] = both(lambda f: hessian(scalar(f), argnums=1)(xs, cs))
    # the coefficient gradient under vmap, at the full shape over a leading batch of 3
    errors['vmap_grad_c'] = both(lambda f: vmap(grad(lambda x, c, w: (f(x, c) * w).sum(), argnums=1))(x3, c3, w3))
    # reverse mode over vmap of jvp, what the linearize path's gradient runs: the tangents along 3 coefficient
    # directions under vmap, then the gradient in x and in c of a scalar of them and the primal, through both
    # Functions (the tangent rule's series, its backward's coefficient gradient)
    ct = normal((3,) + tuple(c.shape), 1e-3)

    def reverse_over_forward(f):
        xg, cg = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
        primal, tangent = vmap(lambda t: jvp(lambda cc: f(xg, cc), (cg,), (t,)), out_dims=(None, 0))(ct)
        return torch.autograd.grad(((tangent + primal) * w).sum(), (xg, cg))

    rof = [reverse_over_forward(function) for function in (kernel, clenshaw_reference)]
    errors['d2_rof_x'], errors['d2_rof_c'] = rel(rof[0][0], rof[1][0]), rel(rof[0][1], rof[1][1])
    if device.type == 'cuda':
        torch.cuda.synchronize()
    tolerance = dict(vmap_grad_c=COEFF_GRAD_RTOL)
    bad = {k: e for k, e in errors.items()
           if not e <= tolerance.get(k, SECOND_RTOL if k.startswith('d2') else KERNEL_RTOL)}
    if bad:
        raise AssertionError('derivatives through the kernels disagree with the plain version at {}: {}'.format(
            case_label(case), bad))
    return errors


class fail_chain(object):
    """Context in which chain ``index`` of every config-4 evaluation of
    ``likelihood`` has non-finite per-chain design rows (its full-shape
    theory's ``solved_power_basis``), so that its solved parameters cannot
    be factored."""

    def __init__(self, likelihood, index):
        self.theory = next(obs.wmatrix.theory for obs in likelihood.observables
                           if hasattr(obs.wmatrix.theory, 'solved_power_basis'))
        self.index = index

    def __enter__(self):
        import torch
        basis = self.theory.solved_power_basis

        def failing(basename):
            out = basis(basename)
            mask = (torch.arange(out.shape[0], device=out.device) == self.index).reshape(
                (-1,) + (1,) * (out.ndim - 1))
            return torch.where(mask, torch.full_like(out, float('inf')), out)

        self.theory.solved_power_basis = failing
        return self

    def __exit__(self, *exc):
        del self.theory.solved_power_basis


def kernel_cases():
    """The shapes at which the Clenshaw kernel is held against its plain
    version: dicts of rows, q, order, per_row, log_values, and optionally
    offset (x a view at that storage offset, in elements), k (queries a
    thread) and max_grid (a smaller grid, so that blocks walk their tiles)."""
    cases = []
    for rows in (1, BATCH):
        for per_row in (False, True):
            for log_values in (True, False):
                cases.append(dict(rows=rows, q=NQUERY, order=202, per_row=per_row, log_values=log_values))
    for q in (1, 3, 561):
        for order in (1, 2, 3, 203, 320):
            for per_row in (False, True):
                for log_values in (True, False):
                    cases.append(dict(rows=56, q=q, order=order, per_row=per_row, log_values=log_values))
    for rows, q in ((56, 561), (BATCH, NQUERY)):
        for per_row in (False, True):
            cases.append(dict(rows=rows, q=q, order=202, per_row=per_row, log_values=True, offset=1))
    for per_row in (False, True):
        cases.append(dict(rows=70000, q=561, order=202, per_row=per_row, log_values=False))
        cases.append(dict(rows=70000, q=3, order=202, per_row=per_row, log_values=True, max_grid=7))
        for k in (2, 8):
            cases.append(dict(rows=BATCH, q=NQUERY, order=202, per_row=per_row, log_values=True, k=k))
    cases.append(dict(rows=56, q=1, order=202, per_row=False, log_values=True))  # the kobs lookup
    cases += ept_cases() + xi_cases() + ept_xi_cases() + template_cases() + tns_cases() + files_cases()
    return cases


def template_cases():
    """The templates' own lookups of their wiggles (series, not exp'd) at a
    chain's moved k, at B = 4096: BAOPhaseShift and WiggleSplit on the BAO
    theories' template grid (2000 points, order 202, the fiducial wiggles:
    shared coefficients), DirectWiggleSplit on the EPT theory's (1200
    points, order 320, each chain's wiggles: one coefficient row a chain)."""
    return [dict(rows=BATCH, q=2000, order=ORDER, per_row=False, log_values=False),
            dict(rows=BATCH, q=1200, order=EPT_ORDER, per_row=True, log_values=False)]


def ept_cases():
    """Config 3's launches: the loop tables' series at (B, 288, 105) and the
    template's exp'd lookups at (B, 288, 320), one coefficient row a chain,
    at B = 4096 and 32768."""
    return [dict(rows=rows, q=FS_NQUERY, order=order, per_row=True, log_values=log_values)
            for rows in (BATCH, EPT_BIG_BATCH) for order, log_values in ((EPT_WORK_ORDER, False), (EPT_ORDER, True))]


def xi_cases():
    """Config xi's launches: the template's exp'd lookups at the AP-remapped
    (B, 3000) with shared coefficients of order 230 (a coefficient tail of 2
    in the last chunk of 4), B = 4096 and 65536, and the (300, 1) lookup at
    the observed k."""
    return [dict(rows=rows, q=XI_NQUERY, order=XI_ORDER, per_row=False, log_values=True)
            for rows in (BATCH, BIG_BATCH)] + [dict(rows=300, q=1, order=XI_ORDER, per_row=False, log_values=True)]


def tns_cases():
    """Config tns's lookups: the template's exp'd pk at |k - q| on the TNS
    tables' static (96, 300, 16) grid, one row of x shared by every chain's
    coefficient row (order 320), at TNS_CHECK_ROWS rows (where the plain
    version fits); and the shared x at a ragged q (the row layout) and at
    (4096, 288) series (the flat layout's float4 loads)."""
    return [dict(rows=TNS_CHECK_ROWS, q=TNS_NQUERY, order=EPT_ORDER, per_row=True, log_values=True, shared_x=True),
            dict(rows=56, q=561, order=EPT_ORDER, per_row=True, log_values=True, shared_x=True),
            dict(rows=BATCH, q=FS_NQUERY, order=EPT_ORDER, per_row=True, log_values=False, shared_x=True)]


def check_tns_overflow(device):
    """Both kernels at TNS_OVERFLOW_ROWS x TNS_NQUERY, shared x, order 320:
    rows x queries past 2^31, so the flat index of the last rows needs 64
    bits. The last 8 rows (one coefficient row each) against the plain
    versions on those rows alone. Returns the errors relative to the
    magnitude."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    case = dict(rows=TNS_OVERFLOW_ROWS, q=TNS_NQUERY, order=EPT_ORDER, per_row=True, log_values=True, shared_x=True)
    x, c = case_inputs(case, device)
    with torch.no_grad():
        y = cuda_kernels.clenshaw(x, c, True)
        tail = y[-8:].clone()
        w = torch.ones_like(y)
        gc = cuda_kernels._launch_coeff_grad(x, w, y, EPT_ORDER, True)[-8:]
    del y, w
    expected = cuda_kernels.clenshaw_reference(x, c[-8:], True)
    expected_gc = cuda_kernels.clenshaw_coeff_grad_reference(x, expected, EPT_ORDER)
    torch.cuda.synchronize()
    errs = (float((tail - expected).abs().max() / expected.abs().max()),
            float((gc - expected_gc).abs().max() / expected_gc.abs().max()))
    print('phase 2: {} ({:.3g} x 2^31 queries): the last 8 rows vs the plain versions: series {:.3e} (tol {:.0e}), '
          'coefficient gradient {:.3e} (tol {:.0e})'.format(case_label(case), TNS_OVERFLOW_ROWS * TNS_NQUERY / 2. ** 31,
                                                            errs[0], KERNEL_RTOL, errs[1], COEFF_GRAD_RTOL))
    if not (errs[0] <= KERNEL_RTOL and errs[1] <= COEFF_GRAD_RTOL):
        raise AssertionError('the kernels disagree past 2^31 queries')
    del x, c
    torch.cuda.empty_cache()
    return errs


def ept_xi_cases():
    """Config 3xi's launches: the loop tables' series at (B, 2400, 205) and the
    template's exp'd lookups at (B, 2400, 320), one coefficient row a chain,
    at B = 4096 and EPT_XI_BIG_BATCH."""
    return [dict(rows=rows, q=EPT_XI_NQUERY, order=order, per_row=True, log_values=log_values)
            for rows in (BATCH, EPT_XI_BIG_BATCH) for order, log_values in ((EPT_XI_WORK_ORDER, False),
                                                                         (EPT_ORDER, True))]


def files_cases():
    """Config 3f's launches: the loop tables' series at (B, 2800, 144) and
    the template's exp'd lookups at (B, 2800, 320), one coefficient row a
    chain, at B = 4096 and 16384 (the EPT theory on the window's 350 input
    points a multipole x 8 mu nodes; the working grid from 0.6 x 0.001 to
    1.7 x 0.35 h/Mpc)."""
    return [dict(rows=rows, q=FILES_NQUERY, order=order, per_row=True, log_values=log_values)
            for rows in FILES_BATCHES for order, log_values in ((FILES_WORK_ORDER, False), (EPT_ORDER, True))]


def case_label(case):
    return '{rows}x{q} order {order} {}{}{}{}{}{}'.format(
        'per-row' if case['per_row'] else 'shared', ' exp' if case['log_values'] else ' series',
        ' shared x' if case.get('shared_x') else '',
        ' offset {}'.format(case['offset']) if case.get('offset') else '',
        ' K={}'.format(case['k']) if case.get('k') else '',
        ' grid {}'.format(case['max_grid']) if case.get('max_grid') else '', **case)


_COEFFS = {}


def ln_pk_coeffs(order):
    """Chebyshev coefficients of the config-1 ln pk table at ``order`` (float64 numpy)."""
    if order not in _COEFFS:
        from desilike_tpu_torch.cosmology import background, linear
        from desilike_tpu_torch.ops.chebyshev import ChebyshevLogInterp
        _COEFFS[order] = ChebyshevLogInterp(KGRID, order=order).coeffs(linear.pk_lin(background.resolve(), KGRID, 0.8))
    return _COEFFS[order]


def case_inputs(case, device, seed=1):
    """Seeded x (rows, q) in [-1, 1] and the case's float32 coefficients on ``device``."""
    import torch
    rng = np.random.default_rng(seed)
    rows, q, order = case['rows'], case['q'], case['order']
    coeffs = ln_pk_coeffs(order)
    if case['per_row']:
        coeffs = coeffs + 1e-3 * rng.normal(size=(rows, order)) / (1. + np.arange(order))
    x = torch.tensor(rng.uniform(-1., 1., (1 if case.get('shared_x') else rows, q)), dtype=torch.float32,
                     device=device)
    offset = case.get('offset', 0)
    if offset:
        storage = torch.empty(rows * q + offset, dtype=torch.float32, device=device)
        storage[offset:] = x.reshape(-1)
        x = storage[offset:].view(rows, q)
        assert x.is_contiguous() and x.storage_offset() == offset
    return x, torch.tensor(coeffs, dtype=torch.float32, device=device)


def check_kernel_case(case, device):
    """Launch the kernel on ``case`` and hold it against clenshaw_reference;
    returns (max abs err, err relative to the output's max, geometry).
    Raises if they disagree beyond KERNEL_RTOL."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    x, c = case_inputs(case, device)
    if case.get('k') or case.get('max_grid'):
        got = cuda_kernels._launch_clenshaw(x, c, case['log_values'],
                                            queries_per_thread=case.get('k'),
                                            max_grid=case.get('max_grid', cuda_kernels.MAX_GRID))
    else:
        got = cuda_kernels.clenshaw(x, c, log_values=case['log_values'])
    geometry = cuda_kernels.LAST_GEOMETRY
    expected = cuda_kernels.clenshaw_reference(x, c, log_values=case['log_values'])
    torch.cuda.synchronize()
    err = float((got - expected).abs().max())
    rel = err / float(expected.abs().max())
    if not rel <= KERNEL_RTOL:
        raise AssertionError('kernel disagrees with clenshaw_reference at {}: {:.3e} of the magnitude'.format(
            case_label(case), rel))
    return err, rel, geometry


def coeff_grad_cases():
    """The shapes at which the coefficient-gradient kernel is held against
    its plain version: dicts of rows, q, order, per_row, log_values, and
    optionally offset (x a view at that storage offset) and max_grid."""
    cases = []
    for rows in (1, BATCH):
        for q in (FS_NQUERY, NQUERY):
            for per_row in (True, False):
                for log_values in (True, False):
                    cases.append(dict(rows=rows, q=q, order=ORDER, per_row=per_row, log_values=log_values))
    for q in (1, 3, 561):
        for order in (1, 2, 3, 203, 320):
            for per_row in (True, False):
                cases.append(dict(rows=56, q=q, order=order, per_row=per_row, log_values=order % 2 == 1))
    for per_row in (True, False):
        cases.append(dict(rows=70000, q=561, order=ORDER, per_row=per_row, log_values=False))
        cases.append(dict(rows=70000, q=3, order=ORDER, per_row=per_row, log_values=True, max_grid=7))
    cases.append(dict(rows=56, q=1200, order=ORDER, per_row=True, log_values=False))  # five column tiles
    # the prefetching path: rows not a multiple of the teams, one team walking many rows, no prefetch
    cases.append(dict(rows=BATCH + 1, q=FS_NQUERY, order=ORDER, per_row=True, log_values=True))
    cases.append(dict(rows=70000, q=FS_NQUERY, order=ORDER, per_row=True, log_values=True, max_grid=7))
    cases.append(dict(rows=BATCH, q=FS_NQUERY, order=ORDER, per_row=True, log_values=True, offset=1))
    cases.append(dict(rows=56, q=100, order=ORDER, per_row=True, log_values=True))  # 9 queries a lane, prefetched
    cases += ept_cases() + ept_xi_cases() + [case for case in template_cases() if case['per_row']] + tns_cases() \
        + files_cases()
    return cases


def check_coeff_grad_case(case, device):
    """Launch the coefficient-gradient kernel on ``case`` (x and coefficients
    of :func:`case_inputs`, a seeded grad_y, y from the plain series when
    exp'd) and hold it against clenshaw_coeff_grad_reference; returns (max
    abs err, err relative to the gradient's max, geometry). Raises if they
    disagree beyond COEFF_GRAD_RTOL, or if the launch did not prefetch where
    it should (per-row, Q a multiple of 4, aligned x) or did elsewhere."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    x, c = case_inputs(case, device)
    grad_y = torch.tensor(np.random.default_rng(3).normal(size=(case['rows'], case['q'])), dtype=torch.float32,
                          device=device)
    y = cuda_kernels.clenshaw_reference(x, c, log_values=True) if case['log_values'] else None
    got = cuda_kernels._launch_coeff_grad(x, grad_y, y, case['order'], case['per_row'],
                                          max_grid=case.get('max_grid', cuda_kernels.MAX_GRID))
    expected = cuda_kernels.clenshaw_coeff_grad_reference(x, grad_y if y is None else grad_y * y, case['order'],
                                                          case['per_row'])
    geometry = cuda_kernels.LAST_COEFF_GRAD_GEOMETRY
    torch.cuda.synchronize()
    if got.shape != expected.shape:
        raise AssertionError('coefficient gradient has shape {} for {}'.format(tuple(got.shape), case_label(case)))
    if geometry.prefetch != (case['per_row'] and case['q'] % 4 == 0 and not case.get('offset')):
        raise AssertionError('{} launched with prefetch {}'.format(case_label(case), geometry.prefetch))
    err = float((got - expected).abs().max())
    rel = err / float(expected.abs().max())
    if not rel <= COEFF_GRAD_RTOL:
        raise AssertionError('kernel disagrees with clenshaw_coeff_grad_reference at {}: {:.3e} of the '
                             'magnitude'.format(case_label(case), rel))
    return err, rel, geometry


def coeff_grad_occupancy(rows=BATCH, order=ORDER):
    """{label: (ptxas registers or None, blocks an SM holds)} for every
    compiled instance of the coefficient-gradient kernel, at the geometry of
    ``rows`` rows of a Q it serves in one tile (per-row with and without
    prefetch, and shared); the registers come from this process's build log."""
    import re
    from desilike_tpu_torch.ops import cuda_kernels
    registers, name = {}, None
    for line in cuda_kernels.BUILD_INFO['log'].splitlines():
        match = re.search(r'clenshaw_coeff_grad_kernelILi(\d+)ELb([01])ELb([01])E', line)
        if match and 'Compiling entry function' in line:
            name = tuple(int(v) for v in match.groups())
        match = re.search(r'Used (\d+) registers', line)
        if match and name is not None:
            registers[name], name = int(match.group(1)), None
    result = {}
    for nq in cuda_kernels._COEFF_GRAD_NQS:
        for per_row, aligned, label in ((True, True, 'per-row prefetch'), (True, False, 'per-row'),
                                        (False, True, 'shared')):
            g = cuda_kernels.coeff_grad_geometry(rows, cuda_kernels.COEFF_GRAD_LANES * nq, order, per_row,
                                                 aligned=aligned)
            result['NQ={} {} ({} warps, {} B)'.format(nq, label, g.warps, g.smem)] = (
                registers.get((nq, int(per_row), int(g.prefetch))),
                cuda_kernels.coeff_grad_resident_blocks(g.nq, per_row, g.prefetch, g.warps, g.smem))
    return result


def coeff_grad_bound_ms(rows, q, order, per_row, with_y=True, shared_x=False):
    """Least time of the H100 for the coefficient gradient: 3 FLOP (an FFMA
    and an FADD) a (query, degree) at the FP32 rate, or x (one row if
    ``shared_x``), w and y (if ``with_y``) once and the gradient once at the
    memory rate, whichever is larger. Returns (ms, 'operations' or 'bytes')."""
    flops = 3. * rows * q * order
    nbytes = 4. * ((1 if shared_x else rows) * q + (2 if with_y else 1) * rows * q + (rows if per_row else 1) * order)
    ops_ms, bytes_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def clenshaw_bound_ms(rows, q, order, per_row, shared_x=False):
    """Least time of the H100 for the series: 3 FLOP (an FFMA and an FADD) a
    step-query at the FP32 rate, or x (one row if ``shared_x``) and y once
    and the coefficients once at the memory rate, whichever is larger.
    Returns (ms, 'operations' or 'bytes')."""
    flops = 3. * rows * q * (order - 1)
    nbytes = 4. * ((1 if shared_x else rows) * q + rows * q + (rows if per_row else 1) * order)
    ops_ms, bytes_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def time_cuda(fn, iterations, warmup=3):
    """Mean milliseconds per call, CUDA events around ``iterations`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iterations


def time_graph(fn, launches=50, replays=10):
    """Device milliseconds per call of ``fn``: ``launches`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events. The host's
    work (checks, allocation, the ctypes call) is not in the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * launches)
    del graph
    return ms


def host_ms(fn, calls=200):
    """Host milliseconds a call to enqueue ``fn`` (no synchronisation inside
    the window; the device queue holds the calls)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def library_series_ms(x, c, log_values):
    """Milliseconds a call (CUDA events) of the nearest library call to the
    series: ``torch.special.chebyshev_polynomial_t`` over (B, Q, order), every
    T_j(x) materialised, an einsum with the (shared or per-row) coefficients,
    then exp if ``log_values``; with one row of x shared by every coefficient
    row one GEMM: T_j(x) once ((Q, order)), then (B, order) x (order, Q).
    None where the card cannot hold T_j(x). A yardstick only, used nowhere in
    the port."""
    import torch
    degrees = torch.arange(c.shape[-1], device=x.device)
    subscripts = 'bqj,bj->bq' if c.ndim == 2 else 'bqj,j->bq'

    def call():
        if x.shape[0] == 1 and c.ndim == 2 and c.shape[0] > 1:
            y = c @ torch.special.chebyshev_polynomial_t(x[0][:, None], degrees).T
        else:
            y = torch.einsum(subscripts, torch.special.chebyshev_polynomial_t(x[..., None], degrees), c)
        return torch.exp(y) if log_values else y

    try:
        return time_cuda(call, 3, warmup=1)
    except torch.cuda.OutOfMemoryError as exc:
        print('phase 4: chebyshev_polynomial_t + einsum{} could not run at {}: {}'.format(
            ' + exp' if log_values else '', tuple(x.shape) + (c.shape[-1],), str(exc)[:200]))
        torch.cuda.empty_cache()
        return None


def time_ept_kernels(smi, device, cases=None, config='config 3'):
    """Phase 4 at ``config``'s shapes (``cases``, by default config 3's,
    :func:`ept_cases`): each kernel's device time by CUDA-graph replay beside
    its bound, its plain version's time (unless the case says ``plain``
    False: where its (B, Q) temporaries do not fit beside the timed
    tensors), and the nearest library calls' (for the series
    :func:`library_series_ms`, for the coefficient gradient, with y for the
    exp'd lookups as the backward launches it, ``chebyshev_polynomial_t`` +
    einsum, or one GEMM with T_j(x) once for a shared x); the coefficient
    gradient per row or summed over the rows, as the case's coefficients
    are. A graph holds 50 launches, or 3 where each output is over 2^28
    floats (config tns's (B, 460800): each output stays in the graph's
    pool). Returns {label: numbers}."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    out = {}
    for case in ept_cases() if cases is None else cases:
        rows, q, order, log_values, per_row = (case[key] for key in ('rows', 'q', 'order', 'log_values', 'per_row'))
        shared_x = bool(case.get('shared_x'))
        launches, replays = (3, 3) if rows * q > 2 ** 28 else (50, 10)
        x, c = case_inputs(case, device, seed=2)
        w = torch.randn(rows, q, generator=torch.Generator(device).manual_seed(5), device=device)
        with torch.no_grad():
            y = cuda_kernels.clenshaw(x, c, log_values) if log_values else None
        wy = w if y is None else w * y
        entry = out['{}x{} order {}'.format(rows, q, order)] = {}
        entry['ms'] = float(np.mean([time_graph(lambda: cuda_kernels.clenshaw(x, c, log_values), launches, replays)
                                     for _ in range(2)]))
        entry['bound_ms'], entry['bound_by'] = clenshaw_bound_ms(rows, q, order, per_row, shared_x)
        entry['grad_ms'] = float(np.mean([time_graph(lambda: cuda_kernels._launch_coeff_grad(x, w, y, order, per_row),
                                                     launches, replays) for _ in range(2)]))
        entry['grad_bound_ms'], entry['grad_bound_by'] = coeff_grad_bound_ms(rows, q, order, per_row, y is not None,
                                                                             shared_x)
        entry['plain_ms'] = entry['grad_plain_ms'] = None
        if case.get('plain', True):
            entry['plain_ms'] = time_cuda(lambda: cuda_kernels.clenshaw_reference(x, c, log_values), 3, warmup=1)
            entry['grad_plain_ms'] = time_cuda(lambda: cuda_kernels.clenshaw_coeff_grad_reference(x, wy, order), 3,
                                               warmup=1)
        entry['library_ms'] = library_series_ms(x, c, log_values)

        def library_call():  # every T_j(x) materialised (once for a shared x), then a contraction
            degrees = torch.arange(order, device=device)
            if shared_x:
                return wy @ torch.special.chebyshev_polynomial_t(x[0][:, None], degrees)
            return torch.einsum('bq,bqj->bj' if per_row else 'bq,bqj->j', wy,
                                torch.special.chebyshev_polynomial_t(x[..., None], degrees))

        try:  # a yardstick only, used nowhere in the port
            entry['grad_library_ms'] = time_cuda(library_call, 3, warmup=1)
        except torch.cuda.OutOfMemoryError as exc:
            entry['grad_library_ms'] = None
            print('phase 4: chebyshev_polynomial_t + einsum could not run at {}x{} order {}: {}'.format(
                rows, q, order, str(exc)[:300]))
            torch.cuda.empty_cache()
        print('phase 4: {} shape {}x{} order {} {} {}{} on {!r}: Clenshaw {:.4f} ms a launch (CUDA-graph '
              'replay), bound {:.4f} ms ({}), {:.1%} of it, plain version {} ms, {}{} {} ms; coefficient gradient '
              '{:.4f} ms, bound {:.4f} ms ({}), {:.1%} of it, plain version {} ms, {} {} ms'.format(
                  config, rows, q, order, 'per-row' if per_row else 'shared', 'exp' if log_values else 'series',
                  ', shared x' if shared_x else '', smi, entry['ms'], entry['bound_ms'],
                  entry['bound_by'], entry['bound_ms'] / entry['ms'], entry['plain_ms'] and round(entry['plain_ms'], 4),
                  'chebyshev_polynomial_t once + GEMM' if shared_x else 'chebyshev_polynomial_t + einsum',
                  ' + exp' if log_values else '', entry['library_ms'] and round(entry['library_ms'], 4),
                  entry['grad_ms'], entry['grad_bound_ms'], entry['grad_bound_by'],
                  entry['grad_bound_ms'] / entry['grad_ms'], entry['grad_plain_ms'] and round(entry['grad_plain_ms'], 4),
                  'chebyshev_polynomial_t once + GEMM' if shared_x else 'chebyshev_polynomial_t + einsum',
                  entry['grad_library_ms'] and round(entry['grad_library_ms'], 4)))
        del x, c, w, y, wy
        torch.cuda.empty_cache()
    return out


def theory_golden(label, theory, golden, name, x64=None):
    """Evaluate ``theory`` (built with no device: the card) at the golden
    parameter values it takes and hold its multipoles (``theory.get()``)
    against the golden vector ``name`` at the tolerance of the JAX package's
    golden test; with ``x64`` (the JAX package's float64 vector) against that
    within SHOT_NOISE_F32_RTOL of its largest value instead, and print the
    distance of both float32 vectors from it."""
    from desilike_tpu_torch import Pipeline
    # the parameter values of tests/test_golden.py
    values = {'qpar': 1.02, 'qper': 0.98, 'b1': 1.8, 'sigmapar': 9., 'sigmaper': 6., 'sigmas': 2., 'dbeta': 1.1,
              'df': 1.05, 'dm': 0.02, 'sn0': 500., 'ct0_2': 10., 'ct2_2': 5., 'b2': 0.5, 'bs': -0.2,
              'ml0_0': 1., 'ml2_1': 0.5, 'fnl_loc': 10., 'p': 1., 'sigmav': 4.,
              'b1p': 1.3, 'b2p': 0.5, 'bsp': -0.3, 'alpha0p': 1.5, 'alpha2p': -0.8, 'sn0p': 0.6, 'sn2p': -0.2}
    pipe = Pipeline(theory)
    allowed = set(pipe.params.basenames())
    pipe.evaluate({key: value for key, value in values.items() if key in allowed})
    output = theory.get()
    if output.device.type != 'cuda':
        raise AssertionError('a theory built with no device evaluates on {}'.format(output.device))
    got = output[0].cpu().numpy().astype('f8')
    ref = golden[name]
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    if x64 is None:
        print('{}: {} theory on the card (built with no device) vs golden: max err relative to max {:.3e} '
              '(tol 2e-5 + 2e-5 rtol)'.format(label, name, err))
        np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=2e-5)
        return
    err64 = float(np.abs(got - x64).max() / np.abs(x64).max())
    print('{}: {} theory on the card (built with no device) vs JAX x64: max err relative to max {:.3e} (tol {:.0e}); '
          'vs the float32 golden {:.3e}, which is {:.3e} from JAX x64'.format(
              label, name, err64, SHOT_NOISE_F32_RTOL, err, float(np.abs(ref - x64).max() / np.abs(x64).max())))
    if not err64 <= SHOT_NOISE_F32_RTOL:
        raise AssertionError('{} on the card is {:.3e} from JAX x64'.format(name, err64))


def at_points(likelihood, names, rows):
    """Log-posterior and gradient of ``likelihood`` at the points ``rows`` (one column per name), as numpy."""
    import torch
    vals = {n: torch.tensor(rows[:, i], dtype=torch.float32, device=likelihood.pipeline.device,
                            requires_grad=True) for i, n in enumerate(names)}
    lp, g = logpost_and_grad(likelihood.logpost_fn(), vals)
    return lp.cpu().numpy(), g.cpu().numpy()


def drive(fn, values):
    """One forward call and one call with the gradient, with the launch
    counters set to 0 just before each and read just after: returns
    (logpost, grad, launches forward, launches with the gradient), the
    launches as (Clenshaw, coefficient gradient)."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
    with torch.no_grad():
        fn(values)
    torch.cuda.synchronize()
    forward = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
    logpost, grad = logpost_and_grad(fn, values)
    torch.cuda.synchronize()
    return logpost, grad, forward, (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)


def check_failed_chain(likelihood, fn, values, index=BATCH // 3):
    """Config 4 with chain ``index`` forced to fail (:class:`fail_chain`):
    raises unless every other chain's log-posterior, gradient and solved
    parameters are bit-identical to the batch without it, and the failed
    chain reads -inf with a finite gradient and ``aux['solved_info']`` -1
    there and 0 elsewhere."""
    import torch

    def evaluate():
        leaves = {n: v.detach().clone().requires_grad_(True) for n, v in values.items()}
        logpost, aux = fn(leaves)
        logpost.sum().backward()
        grad = torch.stack([v.grad for v in leaves.values()], dim=-1)
        return logpost.detach(), grad, aux

    logpost, grad, aux = evaluate()
    with fail_chain(likelihood, index):
        failed, failed_grad, failed_aux = evaluate()
    others = torch.arange(logpost.shape[0], device=logpost.device) != index
    identical = bool(torch.equal(failed[others], logpost[others])) and all(
        bool(torch.equal(failed_aux['solved'][n][others], aux['solved'][n][others])) for n in aux['solved'])
    grad_identical = bool(torch.equal(failed_grad[others], grad[others]))
    grad_finite = bool(torch.isfinite(failed_grad[index]).all())
    info = failed_aux['solved_info']
    print('phase 3: config 4 with chain {} of {} forced to fail: the others bit-identical {} (gradient {}), the '
          'failed chain reads {} with a finite gradient {} (max |grad| {:.3g}), solved_info {} there and nonzero '
          'at {} chain(s)'.format(index, logpost.shape[0], identical, grad_identical, float(failed[index]),
                                  grad_finite, float(failed_grad[index].abs().max()), int(info[index]),
                                  int((info != 0).sum())))
    if not (identical and grad_identical and grad_finite and float(failed[index]) == -np.inf
            and int(info[index]) == -1 and int((info != 0).sum()) == 1 and bool((aux['solved_info'] == 0).all())):
        raise AssertionError('one failed chain changed the others, or did not read -inf with a finite gradient')


def count_host_syncs(fn, values, label='config 4'):
    """The synchronising CUDA calls of one forward call of ``fn`` (``label``'s), as
    ``torch.cuda.set_sync_debug_mode('warn')`` reports them, each at the
    innermost frame of this repository that made it: prints and returns
    {file:line: count}."""
    import collections
    import traceback
    import warnings
    import torch
    places = collections.Counter()
    calling = [False]

    def record(message, category, filename, lineno, file=None, line=None):
        # only the call's: turning the debug mode on can itself warn of a synchronisation (seen on an H100)
        if calling[0] and 'synchroniz' in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if f.filename.startswith(ROOT) and not f.filename.endswith('chip_smoke.py')]
            frame = frames[-1] if frames else None
            places['{}:{}'.format(os.path.relpath(frame.filename, ROOT), frame.lineno) if frame else
                   '{}:{}'.format(filename, lineno)] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode('warn')
        try:
            calling[0] = True
            with torch.no_grad():
                fn(values)
        finally:
            calling[0] = False
            torch.cuda.set_sync_debug_mode(0)
    print('phase 3: {}: one forward call at B={} made {} synchronising CUDA call(s){}'.format(
        label, next(iter(values.values())).shape[0], sum(places.values()),
        ': ' + ', '.join('{} x{}'.format(k, v) for k, v in sorted(places.items())) if places else ''))
    return dict(places)


def check_start_hessian(joint, joint_cpu, config='config 4', frozen=None, expect_coeff_grad=True):
    """The samplers' start-point Hessian of ``config``'s log-density in their
    unconstrained space at the frozen point (``u``, ``hessian``: for config
    4 those of ``tests/data/torch_port_hessian_reference.npz``): on the card
    (launches counted) against the CPU plain path and against the frozen JAX
    x64 values, the diagonal within HESSIAN_RTOL of its largest entry. The
    Clenshaw kernel must launch; the coefficient-gradient kernel must launch
    if and only if ``expect_coeff_grad`` (coefficients that vary by chain).
    Returns ((Clenshaw, coefficient-gradient) launches, errors)."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.samplers import NUTSSampler
    if frozen is None:
        frozen = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_hessian_reference.npz'))
    diagonals = {}
    for label, likelihood in (('card', joint), ('cpu', joint_cpu)):
        sampler = NUTSSampler(likelihood, nchains=1)
        u = torch.tensor(frozen['u'], dtype=torch.float32, device=sampler.device)[None]
        cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
        sampler.initial_mass(u)
        if label == 'card':
            torch.cuda.synchronize()
            launches = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        diagonals[label] = torch.diagonal(sampler.start_hessian).cpu().numpy().astype('f8')
    expected = np.diag(frozen['hessian'])
    scale = np.abs(expected).max()
    errors = {'card_vs_cpu': float(np.abs(diagonals['card'] - diagonals['cpu']).max() / scale),
              'card_vs_jax_x64': float(np.abs(diagonals['card'] - expected).max() / scale),
              'cpu_vs_jax_x64': float(np.abs(diagonals['cpu'] - expected).max() / scale)}
    print('phase 3: {}: start-point Hessian diagonal ({} copies, double backward) on the card: launches '
          'Clenshaw {}, coefficient gradient {}; of max |diag| {:.4g}: card vs CPU {:.2e}, card vs JAX x64 {:.2e}, '
          'CPU vs JAX x64 {:.2e} (tol {:.0e})'.format(config, len(expected), launches[0], launches[1], scale,
                                                     errors['card_vs_cpu'], errors['card_vs_jax_x64'],
                                                     errors['cpu_vs_jax_x64'], HESSIAN_RTOL))
    if not (max(errors.values()) <= HESSIAN_RTOL and launches[0] > 0 and (launches[1] > 0) == expect_coeff_grad):
        raise AssertionError('the start-point Hessian disagrees, or did not run through the kernels')
    return launches, errors


def check_config3(golden):
    """Phase 3, config 3 (the 1-loop EPT full-shape likelihood) on the card:
    log-posterior and gradient over B = 4096 and 32768 seeded chains (finite,
    the 6 solved parameters in ``aux['solved']``, both kernels launched,
    counted forward and with the gradient, the peak of device memory each),
    the frozen JAX values of ``tests/data/torch_port_ept_reference.npz`` at
    16 points (the port's own host state and the JAX package's), the card
    against the port's CPU path at 4 points, and the ``ept``, ``ept_resum``
    and ``ept_physical`` golden vectors. Returns (likelihood, its logpost_fn,
    the numbers)."""
    import torch
    from desilike_tpu_torch import EPTTracerPowerSpectrumMultipoles, ShapeFitPowerSpectrumTemplate
    from desilike_tpu_torch.interop import state_from_numpy
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_ept_reference.npz'))
    t0 = time.perf_counter()
    ept = build_ept_likelihood(None)  # no device: the card
    pipe = ept.pipeline
    names, solved = pipe.varied_params.names(), pipe.solved_params.names()
    out = dict(build_s=time.perf_counter() - t0, launches={}, max_memory_gib={})
    if names != list(reference['names']) or solved != list(reference['solved_names']) or ept.size != 108:
        raise AssertionError('config 3 varies {} and solves {} over {} data'.format(names, solved, ept.size))
    fn = ept.logpost_fn()
    if pipe.device.type != 'cuda':
        raise AssertionError('a likelihood built with no device evaluates on {}'.format(pipe.device))
    for batch in (BATCH, EPT_BIG_BATCH):
        values = chains(names, batch, seed=0, device=pipe.device)
        runs = {}
        for mode in ('forward', 'with gradient'):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
            if mode == 'forward':
                with torch.no_grad():
                    logpost, aux = fn(values)
                grad = None
            else:
                logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            runs[mode] = (logpost, grad)
            out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
        logpost, grad = runs['with gradient']
        forward, backward = out['launches']['forward', batch], out['launches']['with gradient', batch]
        finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all()
                      and torch.isfinite(runs['forward'][0]).all())
        print('phase 3: config 3: logpost and gradient over B={} chains on {}: shape {}, gradient {}, all finite {}, '
              'mean logpost {:.4f}; launches forward: Clenshaw {}, coefficient gradient {}; with the gradient: '
              'Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB forward, {:.2f} GiB with the '
              'gradient; {} data, {} varied, {} solved'.format(
                  batch, logpost.device, tuple(logpost.shape), tuple(grad.shape), finite, float(logpost.mean()),
                  forward[0], forward[1], backward[0], backward[1], out['max_memory_gib']['forward', batch],
                  out['max_memory_gib']['with gradient', batch], ept.size, len(names), len(solved)))
        if (logpost.shape != (batch,) or grad.shape != (batch, 8) or not finite or forward[0] <= 0
                or backward[0] <= forward[0] or forward[1] != 0 or backward[1] <= 0):
            raise AssertionError('config 3 main path failed at B={}'.format(batch))
        if list(aux['solved']) != solved or len(solved) != 6 or aux['solved_hessian'].shape != (batch, 6, 6) \
                or not all(bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values()):
            raise AssertionError('config 3: aux[\'solved\'] does not hold the 6 solved parameters')
        del values, runs, logpost, grad, aux
    points = reference['points']
    lp, g = at_points(state_from_numpy(build_ept_likelihood('cuda'), reference), names, points)
    check_close('phase 3: config 3: card, JAX host state vs JAX float32 at 16 points', lp, reference['logpost'],
                EPT_F32_ATOL, g, reference['grad'], EPT_F32_GRAD_RTOL)
    lp, g = at_points(ept, names, points)
    check_close('phase 3: config 3: card, own host state vs JAX float32 at 16 points', lp, reference['logpost'],
                EPT_F32_ATOL, g, reference['grad'], EPT_F32_GRAD_RTOL)
    check_close('phase 3: config 3: card, own host state vs JAX float64 (x64) at 16 points', lp,
                reference['logpost_x64'], EPT_X64_ATOL, g, reference['grad_x64'], EPT_X64_GRAD_RTOL)
    lp_cpu, g_cpu = at_points(build_ept_likelihood('cpu'), names, points[:4])
    check_close('phase 3: config 3: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, EPT_X64_ATOL,
                g[:4], g_cpu, EPT_X64_GRAD_RTOL)
    k29 = np.linspace(0.02, 0.3, 29)
    for name, kwargs in (('ept', dict(resum=None)), ('ept_resum', {}),
                         ('ept_physical', dict(prior_basis='physical', tracer='LRG'))):
        theory_golden('phase 3', EPTTracerPowerSpectrumMultipoles(
            ells=(0, 2), k=k29, template=ShapeFitPowerSpectrumTemplate(z=0.8), **kwargs), golden, name)
    return ept, fn, out


def check_config3d(golden, smi, ept):
    """Phase 3, config 3d (BASELINE's config 3: config 3 on direct cosmology
    parameters, :func:`build_ept_direct_likelihood`) on the card:
    log-posterior and gradient over B = 4096 and EPT_BIG_BATCH seeded chains
    (finite, the 6 solved parameters, the Clenshaw kernel launched forward
    and both kernels with the gradient, counted; the peak of device memory;
    wall and device milliseconds a call, and config 3's (``ept``) on the
    same batch alongside); the frozen JAX values of
    ``tests/data/torch_port_direct_reference.npz`` at 16 points (float32 with
    the JAX package's host state; float32 and x64 with the port's own), the card against the port's CPU path at 4 points, the
    ``eh99_pk`` golden through a Direct template on the card, the
    synchronising calls of one forward call (beside config 3's, only the
    copies of its fixed parameters' defaults may add to them), and the Fisher of config 3d at
    its fiducial against the CPU path's (|dF_ij| <= FISHER_RTOL
    sqrt(F_ii F_jj)). Returns (likelihood, its logpost_fn, the numbers)."""
    import torch
    from desilike_tpu_torch import DirectPowerSpectrumTemplate, Fisher, Pipeline
    from desilike_tpu_torch.interop import state_from_numpy
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_direct_reference.npz'))
    t0 = time.perf_counter()
    like = build_ept_direct_likelihood(None)  # no device: the card
    pipe = like.pipeline
    names, solved = pipe.varied_params.names(), pipe.solved_params.names()
    out = dict(build_s=time.perf_counter() - t0, launches={}, max_memory_gib={}, wall_ms={}, device_ms={},
               config3_wall_ms={}, config3_device_ms={})
    if names != list(reference['names']) or solved != list(reference['solved_names']) or like.size != 108 \
            or pipe.device.type != 'cuda':
        raise AssertionError('config 3d varies {} and solves {} over {} data on {}'.format(names, solved, like.size,
                                                                                        pipe.device))
    fn, efn, enames = like.logpost_fn(), ept.logpost_fn(), ept.pipeline.varied_params.names()
    cosmo_names = direct_template(like).cosmo.runtime_info.params.names()
    for batch in (BATCH, EPT_BIG_BATCH):
        values = chains(names, batch, seed=0, device=pipe.device)
        runs = {}
        for mode in ('forward', 'with gradient'):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
            if mode == 'forward':
                with torch.no_grad():
                    logpost, aux = fn(values)
                grad = None
            else:
                logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            runs[mode] = (logpost, grad)
            out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
        logpost, grad = runs['with gradient']
        forward, backward = out['launches']['forward', batch], out['launches']['with gradient', batch]
        finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all()
                      and torch.isfinite(runs['forward'][0]).all())
        print('phase 3: config 3d: logpost and gradient over B={} chains on {!r}: shape {}, gradient {}, all finite '
              '{}, mean logpost {:.4f}; launches forward: Clenshaw {}, coefficient gradient {}; with the gradient: '
              'Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB forward, {:.2f} GiB with the '
              'gradient; {} data, {} varied, {} solved'.format(
                  batch, smi, tuple(logpost.shape), tuple(grad.shape), finite, float(logpost.mean()), forward[0],
                  forward[1], backward[0], backward[1], out['max_memory_gib']['forward', batch],
                  out['max_memory_gib']['with gradient', batch], like.size, len(names), len(solved)))
        if (logpost.shape != (batch,) or grad.shape != (batch, len(names)) or not finite or forward[0] <= 0
                or backward[0] <= forward[0] or forward[1] != 0 or backward[1] <= 0):
            raise AssertionError('config 3d main path failed at B={}'.format(batch))
        if list(aux['solved']) != solved or len(solved) != 6 \
                or not all(bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values()):
            raise AssertionError('config 3d: aux[\'solved\'] does not hold the 6 solved parameters')
        del runs, logpost, grad, aux
        evalues = chains(enames, batch, seed=0, device=pipe.device)
        iterations = 10 if batch == BATCH else 3
        for mode in ('forward', 'with gradient'):
            for key, function, args in (('', fn, values), ('config3_', efn, evalues)):
                torch.cuda.empty_cache()  # the two likelihoods' blocks differ: at 32768 with the gradient they fragment
                if mode == 'forward':
                    def call():
                        with torch.no_grad():
                            function(args)
                else:
                    def call():  # gradients accumulate; harmless
                        function(args)[0].sum().backward()
                out[key + 'wall_ms'][mode, batch] = time_cuda(call, iterations, warmup=1)
                out[key + 'device_ms'][mode, batch] = device_ms(call)
            print('phase 3: config 3d {} at B={} on {!r}: {:.2f} ms a call wall, {:.2f} ms device (config 3 on the '
                  'same batch: {:.2f} / {:.2f} ms)'.format(
                      mode, batch, smi, out['wall_ms'][mode, batch], out['device_ms'][mode, batch],
                      out['config3_wall_ms'][mode, batch], out['config3_device_ms'][mode, batch]))
        if batch == BATCH:
            # beside config 3's, the only synchronising calls config 3d may add are the copies of its fixed
            # parameters' defaults to the card (core/pipeline.py, ROADMAP A6)
            out['host_syncs'] = count_host_syncs(fn, values, label='config 3d')
            out['host_syncs_config3'] = count_host_syncs(efn, evalues, label='config 3')
            added = {place: count - out['host_syncs_config3'].get(place, 0) for place, count in out['host_syncs'].items()
                     if count > out['host_syncs_config3'].get(place, 0)}
            if any(not place.startswith(os.path.join('desilike_tpu_torch', 'core', 'pipeline.py')) for place in added):
                raise AssertionError('config 3d adds synchronising calls beside config 3\'s: {}'.format(added))
        del values, evalues
        torch.cuda.empty_cache()
    points = reference['points']
    lp, g = at_points(state_from_numpy(build_ept_direct_likelihood('cuda'), reference), names, points)
    check_close('phase 3: config 3d: card, JAX host state vs JAX float32 at 16 points', lp, reference['logpost'],
                EPT_F32_ATOL, g, reference['grad'], EPT_F32_GRAD_RTOL)
    lp, g = at_points(like, names, points)
    check_close('phase 3: config 3d: card, own host state vs JAX float32 at 16 points', lp, reference['logpost'],
                EPT_F32_ATOL, g, reference['grad'], EPT_F32_GRAD_RTOL)
    check_close('phase 3: config 3d: card, own host state vs JAX float64 (x64) at 16 points', lp,
                reference['logpost_x64'], EPT_X64_ATOL, g, reference['grad_x64'], EPT_X64_GRAD_RTOL)
    like_cpu = build_ept_direct_likelihood('cpu')
    lp_cpu, g_cpu = at_points(like_cpu, names, points[:4])
    check_close('phase 3: config 3d: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, EPT_X64_ATOL,
                g[:4], g_cpu, EPT_X64_GRAD_RTOL)
    k29 = np.linspace(0.02, 0.3, 29)
    eh99 = DirectPowerSpectrumTemplate(z=0.8, k=k29, engine='eh99')  # no device: the card
    Pipeline(eh99).evaluate({})
    got, ref = eh99.pk_dd[0].cpu().numpy().astype('f8'), golden['eh99_pk']
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print('phase 3: golden eh99_pk (Direct template, eh99 engine) on {}: max |d| / max |ref| {:.3e} (tol 2e-5 + '
          '2e-5 rtol)'.format(eh99.pk_dd.device, err))
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=2e-5)
    fishers = {}
    for label, likelihood in (('card', like), ('cpu', like_cpu)):
        cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
        t0 = time.perf_counter()
        fishers[label] = Fisher(likelihood)(b1=2.0)
        if label == 'card':
            torch.cuda.synchronize()
            out['fisher_s'] = time.perf_counter() - t0
            out['launches_fisher'] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    F, ref = fishers['card'].precision, fishers['cpu'].precision
    out['fisher_error'] = float((np.abs(F - ref) / np.sqrt(np.outer(np.diag(ref), np.diag(ref)))).max())
    out['fisher_std'] = {name: fishers['card'].std(name) for name in cosmo_names if name in names}
    line = ('phase 3: Fisher of config 3d at its fiducial on {!r} ({} varied + solved, {:.2f} s; launches: Clenshaw '
            '{}, coefficient gradient {}): max |dF_ij| / sqrt(F_ii F_jj) from the CPU path {:.3e} (tol {:.0e}); '
            'sigma {}'.format(smi, len(fishers['card'].names()), out['fisher_s'], *out['launches_fisher'],
                              out['fisher_error'], FISHER_RTOL,
                              ', '.join('{} {:.5f}'.format(n, v) for n, v in out['fisher_std'].items())))
    print(line)
    if not out['fisher_error'] <= FISHER_RTOL or out['launches_fisher'][0] <= 0:
        raise AssertionError(line)
    return like, fn, out


def check_config_tns(golden, smi, ept):
    """Phase 3, config tns (the EFT-like TNS full-shape likelihood,
    :func:`build_tns_likelihood`) on the card: log-posterior over
    TNS_BATCHES and with its gradient over TNS_GRAD_BATCHES seeded chains
    (finite, the 6 solved parameters, the Clenshaw kernel launched forward
    and both kernels with the gradient, counted; peak device memory; wall
    and device milliseconds a call beside config 3's (``ept``) on the same
    batch), the synchronising calls of one forward call, the forward call at
    the largest batch by kind (:func:`tns_forward_profile`), the frozen JAX x64
    values of ``tests/data/torch_port_tns_reference.npz`` at 16 points, the
    card against the port's CPU path at 4 points, and the goldens of the
    theories ported beside it (``simple_bao``, ``resummed_bao``,
    ``flexible_bao``, ``tns``, ``efttns_fftlog``, ``png``, ``bispectrum``)
    on the card. Returns (likelihood, its logpost_fn, the numbers)."""
    import torch
    from desilike_tpu_torch import theories
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_tns_reference.npz'))
    t0 = time.perf_counter()
    like = build_tns_likelihood(None)  # no device: the card
    pipe = like.pipeline
    names, solved = pipe.varied_params.names(), pipe.solved_params.names()
    out = dict(build_s=time.perf_counter() - t0, launches={}, max_memory_gib={}, wall_ms={}, device_ms={},
               config3_wall_ms={}, config3_device_ms={})
    if names != list(reference['names']) or solved != list(reference['solved_names']) or like.size != 108 \
            or pipe.device.type != 'cuda':
        raise AssertionError('config tns varies {} and solves {} over {} data on {}'.format(names, solved, like.size,
                                                                                         pipe.device))
    fn, efn, enames = like.logpost_fn(), ept.logpost_fn(), ept.pipeline.varied_params.names()
    for batch in sorted(set(TNS_BATCHES) | set(TNS_GRAD_BATCHES)):
        values = chains(names, batch, seed=0, device=pipe.device)
        evalues = chains(enames, batch, seed=0, device=pipe.device)
        modes = [mode for mode, batches in (('forward', TNS_BATCHES), ('with gradient', TNS_GRAD_BATCHES))
                 if batch in batches]
        for mode in modes:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
            if mode == 'forward':
                with torch.no_grad():
                    logpost, aux = fn(values)
                grad = torch.zeros(batch, len(names), device=pipe.device)
            else:
                logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            launches = out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
            finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
            print('phase 3: config tns {} over B={} chains on {!r}: shape {}, all finite {}, mean logpost {:.4f}; '
                  'launches: Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB; {} data, {} varied, '
                  '{} solved'.format(mode, batch, smi, tuple(logpost.shape), finite, float(logpost.mean()),
                                     launches[0], launches[1], out['max_memory_gib'][mode, batch], like.size,
                                     len(names), len(solved)))
            expect_grad = mode != 'forward'
            if logpost.shape != (batch,) or not finite or launches[0] <= 0 or (launches[1] > 0) != expect_grad:
                raise AssertionError('config tns main path failed {} at B={}'.format(mode, batch))
            if mode == 'forward' and (list(aux['solved']) != solved or len(solved) != 6 or not all(
                    bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values())):
                raise AssertionError('config tns: aux[\'solved\'] does not hold the 6 solved parameters')
            del logpost, grad
            aux = None
            for key, function, args in (('', fn, values), ('config3_', efn, evalues)):
                torch.cuda.empty_cache()
                if mode == 'forward':
                    def call():
                        with torch.no_grad():
                            function(args)
                else:
                    def call():  # gradients accumulate; harmless
                        function(args)[0].sum().backward()
                out[key + 'wall_ms'][mode, batch] = time_cuda(call, 3, warmup=1)
                out[key + 'device_ms'][mode, batch] = device_ms(call, calls=1)
            print('phase 3: config tns {} at B={} on {!r}: {:.2f} ms a call wall, {:.2f} ms device, {:.0f} evals/s '
                  '(config 3 on the same batch: {:.2f} / {:.2f} ms); device time {:.2f}x config 3\'s'.format(
                      mode, batch, smi, out['wall_ms'][mode, batch], out['device_ms'][mode, batch],
                      batch / out['wall_ms'][mode, batch] * 1e3, out['config3_wall_ms'][mode, batch],
                      out['config3_device_ms'][mode, batch],
                      out['device_ms'][mode, batch] / out['config3_device_ms'][mode, batch]))
        if batch == TNS_BATCHES[0]:
            out['host_syncs'] = count_host_syncs(fn, values, label='config tns')
        if batch == TNS_BATCHES[-1]:
            out['profile'] = tns_forward_profile(fn, values, smi)
        del values, evalues
        torch.cuda.empty_cache()
    points = reference['points']
    lp, g = at_points(like, names, points)
    check_close('phase 3: config tns: card vs JAX float64 (x64) at 16 points', lp, reference['logpost_x64'],
                EPT_X64_ATOL, g, reference['grad_x64'], EPT_X64_GRAD_RTOL)
    lp_cpu, g_cpu = at_points(build_tns_likelihood('cpu'), names, points[:4])
    check_close('phase 3: config tns: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, EPT_X64_ATOL,
                g[:4], g_cpu, EPT_X64_GRAD_RTOL)
    k29 = np.linspace(0.02, 0.3, 29)
    for name, cls in (('simple_bao', theories.SimpleBAOWigglesTracerPowerSpectrumMultipoles),
                      ('resummed_bao', theories.ResummedBAOWigglesTracerPowerSpectrumMultipoles),
                      ('flexible_bao', theories.FlexibleBAOWigglesTracerPowerSpectrumMultipoles)):
        theory_golden('phase 3', cls(ells=(0, 2), k=k29, template=theories.BAOPowerSpectrumTemplate(z=0.8)), golden,
                      name)
    for name, cls, loop_method in (('tns', theories.TNSTracerPowerSpectrumMultipoles, 'quadrature'),
                                   ('efttns_fftlog', theories.EFTLikeTNSTracerPowerSpectrumMultipoles, 'fftlog')):
        theory_golden('phase 3', cls(ells=(0, 2), k=k29, template=theories.ShapeFitPowerSpectrumTemplate(z=0.8),
                                     loop_method=loop_method), golden, name)
    theory_golden('phase 3', theories.PNGTracerPowerSpectrumMultipoles(ells=(0, 2), k=k29), golden, 'png')
    theory_golden('phase 3', theories.TreeLevelBispectrumMultipoles(template=theories.ShapeFitPowerSpectrumTemplate(
        z=0.8)), golden, 'bispectrum')
    return like, fn, out


class record_launch_shapes(object):
    """Within the block, the shapes each kernel launch gets: {(rows,
    queries, order, per-row, exp'd (for the coefficient gradient: with y),
    shared x): [Clenshaw launches, coefficient-gradient launches]}; the
    counters count as before."""

    def __enter__(self):
        from desilike_tpu_torch.ops import cuda_kernels
        self.shapes = {}
        self.saved = launch, launch_grad = cuda_kernels._launch_clenshaw, cuda_kernels._launch_coeff_grad

        def clenshaw(x, coeffs, log_values, *args, **kwargs):
            shared_x = cuda_kernels._shared_x(x, coeffs)
            rows = coeffs.shape[0] if shared_x else x.shape[0]
            self.add((rows, x.shape[1], coeffs.shape[-1], coeffs.ndim == 2 and rows > 1, bool(log_values), shared_x), 0)
            return launch(x, coeffs, log_values, *args, **kwargs)

        def coeff_grad(x, grad_y, y, order, per_row, *args, **kwargs):
            shared_x = bool(per_row) and x.shape[0] == 1 and grad_y.shape[0] > 1
            self.add(tuple(grad_y.shape) + (order, bool(per_row), y is not None, shared_x), 1)
            return launch_grad(x, grad_y, y, order, per_row, *args, **kwargs)

        cuda_kernels._launch_clenshaw, cuda_kernels._launch_coeff_grad = clenshaw, coeff_grad
        return self

    def add(self, key, kernel):
        self.shapes.setdefault(key, [0, 0])[kernel] += 1

    def __exit__(self, *exc):
        from desilike_tpu_torch.ops import cuda_kernels
        cuda_kernels._launch_clenshaw, cuda_kernels._launch_coeff_grad = self.saved

    def cases(self):
        """The distinct launch shapes as :func:`time_ept_kernels`'s cases, one
        a (rows, queries, order): the exp'd one where both run (the series of
        the x-gradient costs as much)."""
        shapes = {}
        for rows, q, order, per_row, log_values, shared_x in sorted(self.shapes):
            shapes[rows, q, order] = dict(rows=rows, q=q, order=order, per_row=per_row, log_values=log_values,
                                          shared_x=shared_x)
        return list(shapes.values())


def check_config3f(smi, direct, dfn):
    """Phase 3, config 3f (BASELINE's config 3 fed from files,
    :func:`build_files_likelihood`) on the card: the files written into a
    temporary directory (:func:`write_files`: 1000 mocks), the likelihood
    built from them on the card (its Hartlap factor at build and Percival
    factor in ``logpost_fn`` against the frozen JAX ones, 1e-12); the
    log-posterior over FILES_BATCHES forward and with its gradient at B =
    4096 (finite, the 8 solved parameters, both kernels launched, counted;
    peak device memory; the shapes each kernel launch gets); wall and
    device milliseconds a call beside config 3d's (``direct``, ``dfn``) on
    the same batch, evaluations a second; the frozen JAX x64 values of
    ``tests/data/torch_port_observables_reference.npz`` at 16 points and the
    port's CPU plain path at 4. Returns (likelihood, its logpost_fn, the
    numbers, the launch shapes)."""
    import tempfile
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_observables_reference.npz'))
    out = dict(launches={}, max_memory_gib={}, wall_ms={}, device_ms={}, config3d_wall_ms={}, config3d_device_ms={})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_files(tmp)
        out['write_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        like = build_files_likelihood(None, tmp)  # no device: the card
        pipe = like.pipeline
        fn = like.logpost_fn()
        out['build_s'] = time.perf_counter() - t0
        names, solved = pipe.varied_params.names(), pipe.solved_params.names()
        out.update(hartlap=like.hartlap, percival=like._mock_factor, nmocks=like._nmocks)
        line = ('phase 3: config 3f: {} files written in {:.2f} s, the likelihood built from them on {!r} in {:.2f} s: '
                '{} data, {} varied, {} solved ({}), {} mocks; Hartlap {:.12f} (JAX {:.12f}), Percival {:.12f} (JAX '
                '{:.12f})'.format(FILES_NMOCKS + 2, out['write_s'], smi, out['build_s'], like.size, len(names),
                                  len(solved), ', '.join(solved), like._nmocks, like.hartlap, float(reference['hartlap']),
                                  like._mock_factor, float(reference['percival'])))
        print(line)
        if names != list(reference['names']) or solved != list(reference['solved_names']) or like.size != 108 \
                or pipe.device.type != 'cuda' or abs(like.hartlap / reference['hartlap'] - 1.) > 1e-12 \
                or abs(like._mock_factor / reference['percival'] - 1.) > 1e-12:
            raise AssertionError(line)
        dnames = direct.pipeline.varied_params.names()
        for batch in FILES_BATCHES:
            values = chains(names, batch, seed=0, device=pipe.device)
            dvalues = chains(dnames, batch, seed=0, device=pipe.device)
            for mode in ('forward', 'with gradient') if batch == BATCH else ('forward',):
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
                if mode == 'forward':
                    with torch.no_grad():
                        logpost, aux = fn(values)
                    grad = torch.zeros(batch, len(names), device=pipe.device)
                else:
                    logpost, grad = logpost_and_grad(fn, values)
                torch.cuda.synchronize()
                launches = out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES,
                                                           cuda_kernels.COEFF_GRAD_LAUNCHES)
                out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
                finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
                print('phase 3: config 3f {} over B={} chains on {!r}: shape {}, all finite {}, mean logpost {:.4f}; '
                      'launches: Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB'.format(
                          mode, batch, smi, tuple(logpost.shape), finite, float(logpost.mean()), launches[0],
                          launches[1], out['max_memory_gib'][mode, batch]))
                expect_grad = mode != 'forward'
                if logpost.shape != (batch,) or not finite or launches[0] <= 0 or (launches[1] > 0) != expect_grad:
                    raise AssertionError('config 3f main path failed {} at B={}'.format(mode, batch))
                if mode == 'forward' and (list(aux['solved']) != solved or len(solved) != 8 or not all(
                        bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values())):
                    raise AssertionError('config 3f: aux[\'solved\'] does not hold the 8 solved parameters')
                del logpost, grad
                aux = None
                for key, function, args in (('', fn, values), ('config3d_', dfn, dvalues)):
                    torch.cuda.empty_cache()
                    if mode == 'forward':
                        def call():
                            with torch.no_grad():
                                function(args)
                    else:
                        def call():  # gradients accumulate; harmless
                            function(args)[0].sum().backward()
                    out[key + 'wall_ms'][mode, batch] = time_cuda(call, 5, warmup=1)
                    out[key + 'device_ms'][mode, batch] = device_ms(call)
                print('phase 3: config 3f {} at B={} on {!r}: {:.2f} ms a call wall, {:.2f} ms device, {:.0f} evals/s '
                      '(config 3d on the same batch: {:.2f} / {:.2f} ms); device time {:.2f}x config 3d\'s'.format(
                          mode, batch, smi, out['wall_ms'][mode, batch], out['device_ms'][mode, batch],
                          batch / out['wall_ms'][mode, batch] * 1e3, out['config3d_wall_ms'][mode, batch],
                          out['config3d_device_ms'][mode, batch],
                          out['device_ms'][mode, batch] / out['config3d_device_ms'][mode, batch]))
            if batch == BATCH:
                with record_launch_shapes() as shapes:
                    with torch.no_grad():
                        fn(values)
                    logpost_and_grad(fn, values)
                    torch.cuda.synchronize()
                print('phase 3: config 3f at B={}: the kernels\' launches, ((rows, queries), order, per-row, exp\'d): '
                      '[Clenshaw, coefficient gradient] launches of a forward call and one with the gradient: {}'.format(
                          batch, shapes.shapes))
            del values, dvalues
            torch.cuda.empty_cache()
        points = reference['points']
        lp, g = at_points(like, names, points)
        check_close('phase 3: config 3f: card vs JAX float64 (x64) at 16 points', lp, reference['logpost_x64'],
                    EPT_X64_ATOL, g, reference['grad_x64'], EPT_X64_GRAD_RTOL)
        lp_cpu, g_cpu = at_points(build_files_likelihood('cpu', tmp), names, points[:4])
        check_close('phase 3: config 3f: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, EPT_X64_ATOL,
                    g[:4], g_cpu, EPT_X64_GRAD_RTOL)
    return like, fn, out, shapes


def check_bao_compression(smi):
    """Phase 3, the BAO compression likelihood (DM/rd and DH/rd at z = 0.8,
    h, omega_cdm and omega_b varied, the distances per chain on the
    ``Cosmology`` node; ``scripts/make_torch_port_reference.py``'s
    ``build_bao_compression_likelihood``) at B = 4096 on the card (finite),
    and at the 16 points of its frozen JAX x64 values (config 1's limits).
    Returns its wall milliseconds a call at 4096."""
    import torch
    from desilike_tpu_torch import Cosmology, BAOCompressionObservable, ObservablesGaussianLikelihood
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_observables_reference.npz'))
    cosmo = Cosmology()
    cosmo.init.params = {name: dict(fixed=False) for name in ('h', 'omega_cdm', 'omega_b')}
    sigma = np.array([0.015 * 17.9, 0.025 * 20.5])
    observable = BAOCompressionObservable(data=[17.9, 20.5], covariance=np.outer(sigma, sigma) * np.array(
        [[1., -0.4], [-0.4, 1.]]), z=0.8, cosmo=cosmo)
    like = ObservablesGaussianLikelihood(observables=[observable])  # no device: the card
    names = like.pipeline.varied_params.names()
    fn = like.logpost_fn()
    values = chains(names, BATCH, seed=0, device=like.pipeline.device)
    logpost, grad = logpost_and_grad(fn, values)
    finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())

    def call():
        with torch.no_grad():
            fn(values)

    wall_ms = time_cuda(call, 10, warmup=2)
    print('phase 3: BAO compression likelihood over B={} chains on {!r}: shape {}, all finite {}, mean logpost {:.4f}; '
          '{:.2f} ms a call'.format(BATCH, smi, tuple(logpost.shape), finite, float(logpost.mean()), wall_ms))
    if logpost.shape != (BATCH,) or not finite or names != list(reference['bao_compression_names']):
        raise AssertionError('the BAO compression likelihood failed on the card ({})'.format(names))
    lp, g = at_points(like, names, reference['bao_compression_points'])
    check_close('phase 3: BAO compression: card vs JAX float64 (x64) at 16 points', lp,
                reference['bao_compression_logpost_x64'], XI_X64_ATOL, g, reference['bao_compression_grad_x64'],
                XI_X64_GRAD_RTOL)
    return wall_ms


def check_config3j(smi, direct, dfn):
    """Phase 3, config 3j (config 3d + the CMB distance prior + DES-Y5
    supernovae + BBN on one ``Cosmology`` node, :func:`build_probes_likelihood`)
    on the card: its 1829 supernovae written into a temporary directory
    (:func:`write_probe_files`) and the likelihood built from them; the
    log-posterior over PROBES_BATCHES forward and with its gradient at B =
    4096 (finite, the 7 solved parameters and the mean solved ``Mb``, both
    kernels launched, counted; peak device memory); wall and device
    milliseconds a call, the device's busy share of the wall, and config
    3d's (``direct``, ``dfn``) on the same batch; the frozen JAX x64 values
    of ``tests/data/torch_port_probes_reference.npz`` at 16 points (config
    3d's limits, the solved parameters within SOLVED_RTOL of their prior
    width) and the port's CPU plain path at 4. Returns (likelihood, its
    logpost_fn, the numbers)."""
    import tempfile
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_probes_reference.npz'))
    out = dict(launches={}, max_memory_gib={}, wall_ms={}, device_ms={}, busy={}, mb_mean={}, config3d_wall_ms={},
               config3d_device_ms={})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nsn = write_probe_files(tmp)
        out['write_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        like = build_probes_likelihood(None, tmp)  # no device: the card
        pipe = like.pipeline
        fn = like.logpost_fn()
        out['build_s'] = time.perf_counter() - t0
        names, solved = pipe.varied_params.names(), pipe.solved_params.names()
        sizes = [likelihood.size for likelihood in like.likelihoods]
        line = ('phase 3: config 3j: {} supernovae written in {:.2f} s, the likelihood built on {!r} in {:.2f} s: '
                '{} data ({}), {} varied, {} solved ({})'.format(nsn, out['write_s'], smi, out['build_s'], sum(sizes),
                                                                 ' + '.join(map(str, sizes)), len(names), len(solved),
                                                                 ', '.join(solved)))
        print(line)
        if names != list(reference['probes_names']) or solved != list(reference['probes_solved_names']) \
                or sizes != [108, 3, PROBES_NSN, 2] or pipe.device.type != 'cuda':
            raise AssertionError(line)
        dnames = direct.pipeline.varied_params.names()
        for batch in PROBES_BATCHES:
            values = chains(names, batch, seed=0, device=pipe.device)
            dvalues = chains(dnames, batch, seed=0, device=pipe.device)
            for mode in ('forward', 'with gradient') if batch == BATCH else ('forward',):
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
                if mode == 'forward':
                    with torch.no_grad():
                        logpost, aux = fn(values)
                    grad = torch.zeros(batch, len(names), device=pipe.device)
                else:
                    logpost, grad = logpost_and_grad(fn, values)
                torch.cuda.synchronize()
                launches = out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES,
                                                           cuda_kernels.COEFF_GRAD_LAUNCHES)
                out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
                finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
                if mode == 'forward':
                    if list(aux['solved']) != solved or len(solved) != 7 or not all(
                            bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values()):
                        raise AssertionError('config 3j: aux[\'solved\'] does not hold the 7 solved parameters')
                    out['mb_mean'][batch] = float(aux['solved']['Mb'].mean())
                print('phase 3: config 3j {} over B={} chains on {!r}: shape {}, all finite {}, mean logpost {:.4f}, '
                      'mean solved Mb {:.5f}; launches: Clenshaw {}, coefficient gradient {}; peak device memory '
                      '{:.2f} GiB'.format(mode, batch, smi, tuple(logpost.shape), finite, float(logpost.mean()),
                                          out['mb_mean'][batch], launches[0], launches[1],
                                          out['max_memory_gib'][mode, batch]))
                expect_grad = mode != 'forward'
                if logpost.shape != (batch,) or not finite or launches[0] <= 0 or (launches[1] > 0) != expect_grad:
                    raise AssertionError('config 3j main path failed {} at B={}'.format(mode, batch))
                del logpost, grad
                aux = None
                for key, function, args in (('', fn, values), ('config3d_', dfn, dvalues)):
                    torch.cuda.empty_cache()
                    if mode == 'forward':
                        def call():
                            with torch.no_grad():
                                function(args)
                    else:
                        def call():  # gradients accumulate; harmless
                            function(args)[0].sum().backward()
                    out[key + 'wall_ms'][mode, batch] = time_cuda(call, 5, warmup=1)
                    out[key + 'device_ms'][mode, batch] = device_ms(call)
                out['busy'][mode, batch] = out['device_ms'][mode, batch] / out['wall_ms'][mode, batch]
                print('phase 3: config 3j {} at B={} on {!r}: {:.2f} ms a call wall, {:.2f} ms device (busy {:.0%}), '
                      '{:.0f} evals/s (config 3d on the same batch: {:.2f} / {:.2f} ms); device time {:.2f}x config '
                      '3d\'s'.format(mode, batch, smi, out['wall_ms'][mode, batch], out['device_ms'][mode, batch],
                                     out['busy'][mode, batch], batch / out['wall_ms'][mode, batch] * 1e3,
                                     out['config3d_wall_ms'][mode, batch], out['config3d_device_ms'][mode, batch],
                                     out['device_ms'][mode, batch] / out['config3d_device_ms'][mode, batch]))
            del values, dvalues
            torch.cuda.empty_cache()
        points = reference['probes_points']
        lp, g = at_points(like, names, points)
        check_close('phase 3: config 3j: card vs JAX float64 (x64) at 16 points', lp, reference['probes_logpost_x64'],
                    EPT_X64_ATOL, g, reference['probes_grad_x64'], EPT_X64_GRAD_RTOL)
        width = np.array([p.prior.scale if p.prior is not None and p.prior.dist == 'norm' else 1.
                          for p in pipe.solved_params])
        check_solved('phase 3: config 3j: solved ct*, sn*, Mb on the card vs JAX x64 at 16 points',
                     solved_at_points(like, names, points), reference['probes_solved_x64'], width)
        lp_cpu, g_cpu = at_points(build_probes_likelihood('cpu', tmp), names, points[:4])
        check_close('phase 3: config 3j: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, EPT_X64_ATOL,
                    g[:4], g_cpu, EPT_X64_GRAD_RTOL)
    return like, fn, out


def check_theta(smi):
    """Phase 3, ``Cosmology(theta=True)`` on the card (theta_MC_100,
    omega_cdm and omega_b varied, h solved per chain from 100 theta_* in
    float32): over B = 4096 seeded chains the share that converge (the
    JAX package's gate, a residual below 1e-6 of the target: each chain
    must pass it), the largest |100 theta_*(h) - target| among them in
    float64, a finite gradient of h, milliseconds a call forward and with
    the gradient; h and its gradient at the 16 frozen points of
    ``tests/data/torch_port_probes_reference.npz`` against JAX x64 (h within
    THETA_H_ATOL, the gradient within 1e-5 of its norm). Returns the
    numbers."""
    import torch
    from desilike_tpu_torch import Cosmology, Pipeline
    from desilike_tpu_torch.cosmology import background as bg
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_probes_reference.npz'))
    names = list(reference['theta_names'])
    cosmo = Cosmology(theta=True)  # no device: the card
    cosmo.init.params = {name: dict(fixed=False) for name in names}
    pipe = Pipeline(cosmo)
    rng = np.random.default_rng(0)
    center, width = dict(theta_MC_100=1.04109, omega_cdm=0.12, omega_b=0.02237), \
        dict(theta_MC_100=0.002, omega_cdm=0.006, omega_b=0.0008)
    values = {name: torch.tensor(center[name] + width[name] * rng.uniform(-1., 1., BATCH), dtype=torch.float32,
                                 device=pipe.device, requires_grad=True) for name in names}
    pipe.evaluate(values)
    h = cosmo.h
    grad = torch.stack(torch.autograd.grad(h.sum(), list(values.values())), dim=-1)
    converged = torch.isfinite(h)
    p = bg.resolve({name: v.detach().double() for name, v in values.items() if name != 'theta_MC_100'})
    p['h'] = h.detach().double()
    p['_massless_ncdm'] = False
    residual = (bg.theta_star_100(p) - values['theta_MC_100'].detach().double()).abs()[converged]
    out = dict(converged=float(converged.float().mean()), max_residual=float(residual.max()),
               finite_grad=bool(torch.isfinite(grad[converged]).all()))

    def forward():
        with torch.no_grad():
            pipe.evaluate(values)

    def backward():
        pipe.evaluate(values)
        torch.autograd.grad(cosmo.h.sum(), list(values.values()))

    out['ms'] = time_cuda(forward, 10, warmup=1)
    out['grad_ms'] = time_cuda(backward, 10, warmup=1)
    at = {name: torch.tensor(reference['theta_points'][:, i], dtype=torch.float32, device=pipe.device,
                             requires_grad=True) for i, name in enumerate(names)}
    pipe.evaluate(at)
    hgrad = torch.stack(torch.autograd.grad(cosmo.h.sum(), list(at.values())), dim=-1).cpu().numpy()
    out['h_error'] = float(np.abs(cosmo.h.detach().cpu().numpy() - reference['theta_h_x64']).max())
    expected = reference['theta_grad_x64']
    out['grad_error'] = float((np.linalg.norm(hgrad - expected, axis=-1) / np.linalg.norm(expected, axis=-1)).max())
    line = ('phase 3: Cosmology(theta=True) over B={} chains on {!r}: {:.2%} converged, max |100 theta_*(h) - target| '
            '{:.2e} (gate 1e-6 of the target), gradient finite {}; {:.2f} ms a call, {:.2f} ms with the gradient; at 16 '
            'points vs JAX x64: max |d h| {:.2e} (tol {:.0e}), max |d grad|/|grad| {:.2e} (tol 1e-5)'.format(
                BATCH, smi, out['converged'], out['max_residual'], out['finite_grad'], out['ms'], out['grad_ms'],
                out['h_error'], THETA_H_ATOL, out['grad_error']))
    print(line)
    if not (out['converged'] == 1. and out['finite_grad'] and out['h_error'] <= THETA_H_ATOL
            and out['grad_error'] <= 1e-5):
        raise AssertionError(line)
    return out


def cmb_tables(lmax=1500):
    """Synthetic C_ell (``synthetic_cl_tables``, numpy) and their response in
    (amp, tilt): d/d amp (exact: the tables are linear in amp), d/d tilt and
    d2/d tilt2 by central differences (step 1e-3), as the keywords of
    ``ClTheory(tables=..., derivatives=..., derivatives2=..., center=...)``."""
    from desilike_tpu_torch.likelihoods.cmb import synthetic_cl_tables
    tables = synthetic_cl_tables(lmax=lmax)
    plus, minus = synthetic_cl_tables(lmax=lmax, tilt=1e-3), synthetic_cl_tables(lmax=lmax, tilt=-1e-3)
    derivatives = {'amp': dict(tables), 'tilt': {xy: (plus[xy] - minus[xy]) / 2e-3 for xy in tables}}
    derivatives2 = {('tilt', 'tilt'): {xy: (plus[xy] - 2. * tables[xy] + minus[xy]) / 1e-6 for xy in tables}}
    return dict(tables=tables, derivatives=derivatives, derivatives2=derivatives2, center={'amp': 1., 'tilt': 0.})


def cmb_points(names, npoints=4, seed=6, fine=False):
    """Points of the CMB likelihoods, exact in float32, one column a name;
    ``fine``: near the data of a likelihood whose errors are 0.01% of the
    signal (hillipop): the responses and calibrations within 1e-3 of their
    widths, the foregrounds nearly off."""
    center, width = CMB_CENTER, CMB_WIDTH
    if fine:
        center = dict(CMB_CENTER, **{name: 0.002 for name in ('Aradio', 'Adusty', 'Acib', 'Atsz', 'Aksz', 'AdustT',
                                                               'AdustP')})
        width = {name: 1e-3 * value for name, value in CMB_WIDTH.items()}
        width.update({name: 0.001 for name in ('Aradio', 'Adusty', 'Acib', 'Atsz', 'Aksz', 'AdustT', 'AdustP')})
    rng = np.random.default_rng(seed)
    return np.column_stack([center[name] + width[name] * rng.uniform(-1., 1., npoints)
                            for name in names]).astype('f4').astype('f8')


def plik_release_bins():
    """plik-lite's release binning: width 5 from ell = 30, then 9 from 100,
    17 from 1504 and 33 from 2014 to 2508: 215 bins (TT); TE and EE use the
    first 199 (to 1996)."""
    edges = np.concatenate([np.arange(30, 100, 5), np.arange(100, 1504, 9), np.arange(1504, 2014, 17),
                            np.arange(2014, 2509, 33)])
    return edges, np.append(edges[1:], 2509) - 1


def write_cmb_files(directory, seed=CMB_SEED):
    """Write the CMB family's data into ``directory`` (a folder a case) in
    each reader's layout with the port's writers, numpy only: plik-lite at
    the release bin counts (215, 199, 199) over ell 30-2508, the others at
    the widths of the JAX tests' fixtures (``tests/test_cmb.py``: commander
    and simall on ell 2-29, lollipop to ell 30, ACT DR6 to L = 1400 with its
    dense correction matrices, Planck lensing to L = 400 with the CMB to
    1400, CamSpec's six blocks to 2500, hillipop's compact fixture with
    zero weights below ell = 2). Returns {case: dict(cls=class name,
    kwargs=its keywords, ee=the theory's EE table where the case has its
    own, fine=whether its points are :func:`cmb_points`'s fine ones)}."""
    from desilike_tpu_torch.likelihoods import cmb
    rng = np.random.default_rng(seed)
    tables = cmb_tables(2600)['tables']
    muk2 = (2.7255 * 1e6) ** 2
    out = {}

    def folder(name):
        path = os.path.join(directory, name)
        os.makedirs(path, exist_ok=True)
        return path

    ellmin, ellmax = plik_release_bins()
    weights = np.zeros(2600)
    blocks = []
    for cl, nbin in zip(('tt', 'te', 'ee'), (215, 199, 199)):
        binning = np.zeros((nbin, ellmax[nbin - 1] + 1))
        for i, (lo, hi) in enumerate(zip(ellmin[:nbin], ellmax[:nbin])):
            weights[lo:hi + 1] = 1. / (hi - lo + 1)
            binning[i, lo:hi + 1] = 1. / (hi - lo + 1)
        blocks.append(binning @ (tables[cl][:binning.shape[1]] * muk2))
    flatdata = np.concatenate(blocks)
    sigma = 0.01 * np.abs(flatdata) + 1e-3 * np.median(np.abs(flatdata))
    cmb.planck2018.write_plik_lite_data(folder('plik'), dict(
        flatdata=flatdata + sigma * rng.standard_normal(flatdata.size), covariance=np.diag(sigma ** 2), ellmin=ellmin,
        ellmax=ellmax, weights=weights))
    out['plik_ttteee'] = dict(cls='TTTEEEHighlPlanck2018LiteLikelihood', kwargs=dict(data_dir=folder('plik')))
    ells = np.arange(2, 30)
    dl_tt = tables['tt'][2:30] * muk2 * ells * (ells + 1) / (2 * np.pi)
    sig = 0.1 * np.abs(dl_tt) + 10.
    grid = dl_tt[:, None] + np.linspace(-8, 8, 200)[None, :] * sig[:, None]
    cmb.planck2018.write_commander_data(folder('commander'), dict(
        cl2x=np.stack([grid, (grid - dl_tt[:, None]) / sig[:, None]], axis=-1), mu=np.zeros(28),
        covariance=np.eye(28), mu_sigma=dl_tt))
    out['commander'] = dict(cls='TTLowlPlanck2018Likelihood', kwargs=dict(data_dir=folder('commander')))
    dl_ee = np.clip(tables['ee'][2:30] * muk2 * ells * (ells + 1) / (2 * np.pi), 1e-3, 0.25)
    bins = 1e-4 * (0.5 + np.arange(3000))
    cmb.planck2018.write_simall_data(folder('simall'), dict(
        prob=-0.5 * ((bins[None, :] - dl_ee[:, None]) / (0.1 * dl_ee[:, None])) ** 2))
    simall_ee = tables['ee'].copy()
    simall_ee[2:30] = dl_ee * 2 * np.pi / (ells * (ells + 1)) / muk2
    out['simall'] = dict(cls='EELowlPlanck2018Likelihood', kwargs=dict(data_dir=folder('simall')), ee=simall_ee)
    ell = np.arange(31).astype('f8')
    dl = np.stack([tables['ee'][:31], 1.1 * tables['bb'][:31], np.zeros(31)]) * ell * (ell + 1) / (2 * np.pi) * muk2
    var = (0.2 * np.abs(np.concatenate([dl[0, 2:], dl[1, 2:], 0.1 * dl[0, 2:] + 1e-6])) + 1e-8) ** 2
    fiducial = dl.copy()
    fiducial[1] /= 1.1
    cmb.lollipop.write_lollipop_data(folder('lollipop'), dict(cl=dl, fiducial=fiducial, covariance=np.diag(var)))
    for mode in ('EE', 'BB', 'EB'):
        out['lollipop_' + mode.lower()] = dict(cls='{}LowlPlanck2020LollipopLikelihood'.format(mode),
                                               kwargs=dict(data_dir=folder('lollipop')))
    lmax = 1400
    ell = np.arange(lmax + 2).astype('f8')
    clkk = tables['pp'][:lmax + 2] * (ell * (ell + 1)) ** 2 / 4.
    edges = np.linspace(40, lmax, 21).astype(int)
    binmat = np.zeros((20, lmax + 2))
    for i in range(20):
        binmat[i, edges[i]:edges[i + 1]] = 1. / (edges[i + 1] - edges[i])
    act = dict(data_binned_clkk=binmat @ clkk, covariance=np.diag((0.05 * np.abs(binmat @ clkk) + 1e-12) ** 2),
               binmat_act=binmat, fiducial_cl_kk=clkk, dN1_kk=np.zeros((lmax + 2,) * 2),
               dAL_dC=np.zeros((4, lmax + 2, lmax + 2)), fAL=np.ones(lmax + 2))
    act['dAL_dC'][0] = 1e-8 * np.eye(lmax + 2)
    for xy in ('tt', 'ee', 'bb', 'te'):
        act['fiducial_cl_' + xy] = tables[xy][:lmax + 2] * muk2
        act['dN1_' + xy] = np.full((lmax + 2,) * 2, 1e-9) if xy == 'tt' else np.zeros((lmax + 2,) * 2)
    cmb.act_dr6_lensing.write_act_dr6_data(folder('act'), act)
    out['act'] = dict(cls='ACTDR6LensingLikelihood', kwargs=dict(data_dir=folder('act')))
    for variant, name in (('consext8', 'lensing'), ('CMBmarged', 'lensing_marged')):
        cmb.planck2018_lensing.write_planck2018_lensing_data(folder(name), cmb.synthetic_planck2018_lensing_data(
            variant=variant, ellmax_pp=400, ellmax_cmb=1400, cl_tables=tables), variant=variant)
        out[name] = dict(cls='Planck2018LensingLikelihood', kwargs=dict(data_dir=folder(name), variant=variant))
    cmb.camspec.write_camspec_data(folder('camspec'), cmb.synthetic_camspec_data(tables, seed=11, params=dict(
        amp_143=12., amp_217=25., amp_143x217=17., n_143=1.2, n_217=0.8, n_143x217=1., cal2=1.003, calTE=0.995,
        calEE=1.002, A_planck=1.001)))
    out['camspec_ttteee'] = dict(cls='TTTEEEHighlPlanckNPIPECamspecLikelihood', kwargs=dict(data_dir=folder('camspec')))
    lmax, nxspec, nxfreq = 200, 15, 6
    ell = np.arange(lmax + 1).astype('f8')
    dlth = {m: tables[m.lower()][:lmax + 1] * ell * (ell + 1) / (2 * np.pi) * muk2 for m in ('TT', 'EE', 'TE')}
    flat = np.concatenate([dlth[m][50:181] for m in ('TT', 'EE', 'TE') for _ in range(nxfreq)])
    dlweight = {m: 1. + rng.random((nxspec, lmax + 1)) for m in ('TT', 'EE', 'TE')}
    for value in dlweight.values():
        value[:, :2] = 0.
    cmb.hillipop.write_hillipop_data(folder('hillipop'), dict(
        dldata={m: np.tile(dlth[m], (nxspec, 1)) for m in ('TT', 'EE', 'TE')}, dlweight=dlweight,
        lmins={m: np.full(nxfreq, 50) for m in ('TT', 'EE', 'TE')}, lmaxs={m: np.full(nxfreq, 180) for m in ('TT', 'EE', 'TE')},
        invcov=np.diag(1. / (1e-4 * np.abs(flat) + 1e-3) ** 2),
        templates={'dust_TT': rng.random((nxfreq, lmax + 1)), 'tsz': rng.random(lmax + 1), 'ksz': rng.random(lmax + 1)}))
    out['hillipop_ttteee'] = dict(cls='TTTEEEHighlPlanck2020HillipopLikelihood', kwargs=dict(data_dir=folder('hillipop')),
                                  fine=True)
    return out


def build_cmb_likelihood(case, device):
    """One likelihood of :func:`write_cmb_files` (``case`` its entry) on a
    ``ClTheory`` with the (amp, tilt) response of :func:`cmb_tables` on
    ``device`` (simall: its own tables, no response)."""
    from desilike_tpu_torch.likelihoods import cmb
    response = cmb_tables(2600)
    if case.get('ee') is not None:  # simall: its own EE at ell 2-29, no response
        response = dict(tables=dict(response['tables'], ee=case['ee']))
    return getattr(cmb, case['cls'])(theory=cmb.ClTheory(device=device, **response), **case['kwargs'])


def check_cmb_family(smi):
    """Phase 3, the CMB family on the card: each likelihood of
    :func:`write_cmb_files` built from its files (and
    ``Planck2018GaussianLikelihood`` on a Cosmology node), the log-posterior
    over B = 4096 chains forward and with its gradient (finite; milliseconds
    a call, peak device memory), held against the port on the CPU at
    CMB_CHECK_ROWS chains (config 3d's limits). Returns {case: numbers}."""
    import tempfile
    import torch
    from desilike_tpu_torch import Cosmology
    from desilike_tpu_torch.likelihoods import cmb
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cases = write_cmb_files(tmp)
        print('phase 3: the CMB family\'s files written in {:.2f} s'.format(time.perf_counter() - t0))

        def gaussian(device):
            cosmo = Cosmology(device=device)
            cosmo.init.params = {name: dict(fixed=False) for name in ('h', 'omega_cdm', 'omega_b')}
            return cmb.Planck2018GaussianLikelihood(cosmo=cosmo)

        for case in list(cases) + ['gaussian']:
            t0 = time.perf_counter()
            like = gaussian(None) if case == 'gaussian' else build_cmb_likelihood(cases[case], None)
            names = like.pipeline.varied_params.names()
            fn = like.logpost_fn()
            build_s = time.perf_counter() - t0
            if case == 'gaussian':
                rng = np.random.default_rng(6)
                rows = np.column_stack([COSMO_CENTER[name] + COSMO_WIDTH[name] * rng.uniform(-1., 1., BATCH)
                                        for name in names]).astype('f4').astype('f8')
            else:
                rows = cmb_points(names, BATCH, fine=cases[case].get('fine', False))
            values = {name: torch.tensor(rows[:, i], dtype=torch.float32, device=like.pipeline.device,
                                         requires_grad=True) for i, name in enumerate(names)}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            memory = torch.cuda.max_memory_allocated() / 2 ** 30
            finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())

            def forward():
                with torch.no_grad():
                    fn(values)

            entry = dict(build_s=build_s, ms=time_cuda(forward, 3, warmup=1),
                         grad_ms=time_cuda(lambda: fn(values)[0].sum().backward(), 3, warmup=1),
                         max_memory_gib=memory, ndata=sum(getattr(item, 'size', 0) for item in like.likelihoods))
            lp, g = at_points(like, names, rows[:CMB_CHECK_ROWS])
            cpu = gaussian('cpu') if case == 'gaussian' else build_cmb_likelihood(cases[case], 'cpu')
            lp_cpu, g_cpu = at_points(cpu, names, rows[:CMB_CHECK_ROWS])
            entry['logpost_error'] = float(np.abs(lp - lp_cpu).max())
            entry['grad_error'] = float((np.linalg.norm(g - g_cpu, axis=-1) / np.linalg.norm(g_cpu, axis=-1)).max())
            out[case] = entry
            line = ('phase 3: CMB {} ({}) over B={} chains on {!r}: {} varied, all finite {}, mean logpost {:.4f}; '
                    'built in {:.2f} s; {:.2f} ms a call, {:.2f} ms with the gradient, peak device memory {:.2f} GiB; '
                    'card vs the port\'s CPU plain path at {} chains: max |d logpost| {:.3e} (tol {:.0e}), max |d '
                    'grad|/|grad| {:.3e} (tol {:.0e})'.format(
                        case, type(like).__name__, BATCH, smi, len(names), finite, float(logpost.mean()),
                        entry['build_s'], entry['ms'], entry['grad_ms'], memory, CMB_CHECK_ROWS,
                        entry['logpost_error'], EPT_X64_ATOL, entry['grad_error'], EPT_X64_GRAD_RTOL))
            print(line)
            if logpost.shape != (BATCH,) or not finite or entry['logpost_error'] > EPT_X64_ATOL \
                    or entry['grad_error'] > EPT_X64_GRAD_RTOL:
                raise AssertionError(line)
            del like, fn, values, logpost, grad, cpu
            torch.cuda.empty_cache()
    return out


def tns_forward_profile(fn, values, smi, nq=300, nk=96):
    """Config tns's forward call at the batch of ``values`` by kind
    (``torch.profiler``, one call after one of warm-up), in device ms: the
    Clenshaw kernels (the longest launch is the lookup of pk at |k - q|),
    B10's operators on a (B, nk nq nmu) tensor (the two ``bmm`` with the
    static kernels and the passes over U and V: the operators with an input
    of B x TNS_NQUERY elements, by the kernels each launched itself), B10's 1D
    GEMM ((B, nq) x (nq, 6 nk)), and the rest of the call. Returns {kind:
    ms}."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    batch = next(iter(values.values())).shape[0]

    def call():
        with torch.no_grad():
            fn(values)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        call()
        torch.cuda.synchronize()
    events = prof.events()
    device = [event for event in events if event.device_type == torch.autograd.DeviceType.CUDA]
    launches = [event.time_range.elapsed_us() * 1e-3 for event in device if 'clenshaw' in event.name]
    out = {'device': sum(event.time_range.elapsed_us() for event in device) * 1e-3, 'clenshaw': sum(launches),
           'clenshaw_longest': max(launches), 'b10_ops': {}, 'b10_one_d': 0.}
    for event in events:
        if event.device_type != torch.autograd.DeviceType.CPU:
            continue
        shapes = [list(shape) for shape in (event.input_shapes or []) if isinstance(shape, (list, tuple))]
        own = sum(kernel.duration for kernel in event.kernels if 'clenshaw' not in kernel.name) * 1e-3
        if own <= 0.:
            continue
        if any(int(np.prod(shape)) == batch * TNS_NQUERY for shape in shapes if shape):
            key = '{} {}'.format(event.name, shapes)
            out['b10_ops'][key] = out['b10_ops'].get(key, 0.) + own
        elif event.name == 'aten::mm' and shapes[:2] == [[batch, nq], [nq, 6 * nk]]:
            out['b10_one_d'] += own
    out['b10'] = sum(out['b10_ops'].values()) + out['b10_one_d']
    out['rest'] = out['device'] - out['clenshaw'] - out['b10']
    print('phase 3: config tns forward at B={} by kind on {!r} (torch.profiler, device ms): all {:.3f}; Clenshaw '
          '{:.3f} in {} launches (the lookup of pk at |k - q| {:.3f}); B10 {:.3f}: {}, the 1D GEMM {:.3f}; the rest '
          '{:.3f}'.format(batch, smi, out['device'], out['clenshaw'], len(launches), out['clenshaw_longest'],
                          out['b10'], '; '.join('{} {:.3f}'.format(key, ms) for key, ms in out['b10_ops'].items()),
                          out['b10_one_d'], out['rest']))
    if not out['b10_ops'] or out['b10_one_d'] <= 0.:
        raise AssertionError('config tns profile: B10\'s operators were not found')
    return out


def direct_template(likelihood):
    """The ``DirectPowerSpectrumTemplate`` node of ``likelihood``'s pipeline."""
    from desilike_tpu_torch import DirectPowerSpectrumTemplate
    return next(c for c in likelihood.pipeline.calculators if isinstance(c, DirectPowerSpectrumTemplate))


def time_cosmology_node(like, smi):
    """Phase 4: the cosmology node of config 3d alone (the Direct template's
    pipeline: its ``Cosmology`` node, the AP effect and the template's
    per-chain tables pk_dd, pknow_dd, f, sigma8), forward and with the
    gradient of its outputs, at B = 4096 and EPT_BIG_BATCH: device
    milliseconds and kernels a call (:func:`kernel_profile`), and wall
    milliseconds. Returns {(mode, batch): numbers}."""
    import torch
    from desilike_tpu_torch import Pipeline
    template = direct_template(like)
    cosmology = Pipeline(template)
    names = [name for name in template.cosmo.runtime_info.params.names() if name in like.pipeline.varied_params]
    out = {}
    for batch in (BATCH, EPT_BIG_BATCH):
        values = {name: value.detach() for name, value in chains(names, batch, seed=0, device=cosmology.device).items()}
        for mode in ('forward', 'with gradient'):
            if mode == 'forward':
                def call():
                    with torch.no_grad():
                        cosmology.evaluate(values)
            else:
                leaves = {name: value.clone().requires_grad_(True) for name, value in values.items()}

                def call():  # gradients accumulate; harmless
                    cosmology.evaluate(leaves)
                    (template.pk_dd.sum() + template.pknow_dd.sum() + template.fsigma8.sum() + template.qpar.sum()
                     + template.qper.sum()).backward()
            ms, kernels = kernel_profile(call)
            wall = time_cuda(call, 10 if batch == BATCH else 3, warmup=1)
            out[mode, batch] = dict(device_ms=ms, kernels=kernels, wall_ms=wall)
            print('phase 4: the cosmology node of config 3d (Cosmology, AP effect, the Direct template\'s tables) '
                  '{} at B={} on {!r}: {:.3f} ms device, {:.0f} kernels, {:.3f} ms wall a call'.format(
                      mode, batch, smi, ms, kernels, wall))
        del values
    return out


def check_config_xi(golden):
    """Phase 3, config xi (config 1 in configuration space) on the card:
    log-posterior and gradient over B = 4096 and 65536 seeded chains (finite,
    the 6 broadband terms in ``aux['solved']``, the Clenshaw kernel launched
    and the coefficient gradient not, counted forward and with the gradient,
    the peak of device memory each), the frozen JAX values of
    ``tests/data/torch_port_xi_reference.npz`` at 16 points (the port's own
    host state and the JAX package's), the card against the port's CPU path
    at 4 points, the start-point Hessian diagonal (double backward through
    the rfft/irfft pair) against the CPU and the frozen JAX x64 values, and
    the ``damped_bao_xi``, ``ept_xi`` and ``ept_xi_resum`` golden vectors
    from theories built with no device (the last two, whose shot noise
    leaves the JAX package's float32 goldens 1.1e-2 and 2.8e-2 from its own
    x64 values, against the x64 vectors of the reference file). Returns
    (likelihood, its logpost_fn, the numbers)."""
    import torch
    from desilike_tpu_torch import (DampedBAOWigglesTracerCorrelationFunctionMultipoles, BAOPowerSpectrumTemplate,
                                    EPTTracerCorrelationFunctionMultipoles, ShapeFitPowerSpectrumTemplate)
    from desilike_tpu_torch.interop import state_from_numpy
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_xi_reference.npz'))
    t0 = time.perf_counter()
    xi = build_xi_likelihood(None)  # no device: the card
    pipe = xi.pipeline
    names, solved = pipe.varied_params.names(), pipe.solved_params.names()
    out = dict(build_s=time.perf_counter() - t0, launches={}, max_memory_gib={})
    theory = xi.observables[0].wmatrix.theory
    if names != list(reference['names']) or solved != list(reference['solved_names']) or xi.size != 52 \
            or theory.template._cheb.order != XI_ORDER or theory.kin.size * theory.power.mu.size != XI_NQUERY:
        raise AssertionError('config xi varies {} and solves {} over {} data'.format(names, solved, xi.size))
    fn = xi.logpost_fn()
    if pipe.device.type != 'cuda':
        raise AssertionError('a likelihood built with no device evaluates on {}'.format(pipe.device))
    for batch in (BATCH, BIG_BATCH):
        values = chains(names, batch, seed=0, device=pipe.device)
        runs = {}
        for mode in ('forward', 'with gradient'):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
            if mode == 'forward':
                with torch.no_grad():
                    logpost, aux = fn(values)
                grad = None
            else:
                logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            runs[mode] = (logpost, grad)
            out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
        logpost, grad = runs['with gradient']
        forward, backward = out['launches']['forward', batch], out['launches']['with gradient', batch]
        finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all()
                      and torch.isfinite(runs['forward'][0]).all())
        print('phase 3: config xi: logpost and gradient over B={} chains on {}: shape {}, gradient {}, all finite {}, '
              'mean logpost {:.4f}; launches forward: Clenshaw {}, coefficient gradient {}; with the gradient: '
              'Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB forward, {:.2f} GiB with the '
              'gradient; {} data, {} varied, {} solved'.format(
                  batch, logpost.device, tuple(logpost.shape), tuple(grad.shape), finite, float(logpost.mean()),
                  forward[0], forward[1], backward[0], backward[1], out['max_memory_gib']['forward', batch],
                  out['max_memory_gib']['with gradient', batch], xi.size, len(names), len(solved)))
        if (logpost.shape != (batch,) or grad.shape != (batch, 4) or not finite or forward[0] <= 0
                or backward[0] <= forward[0] or forward[1] != 0 or backward[1] != 0):
            raise AssertionError('config xi main path failed at B={}'.format(batch))
        if list(aux['solved']) != solved or len(solved) != 6 or aux['solved_hessian'].shape != (6, 6) \
                or not all(bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values()):
            raise AssertionError('config xi: aux[\'solved\'] does not hold the 6 solved parameters')
        out['host_syncs', batch] = count_host_syncs(fn, values, 'config xi')
        del values, runs, logpost, grad, aux
    torch.cuda.empty_cache()
    points = reference['points']
    lp, g = at_points(state_from_numpy(build_xi_likelihood('cuda'), reference), names, points)
    check_close('phase 3: config xi: card, JAX host state vs JAX float32 at 16 points', lp, reference['logpost'],
                XI_F32_ATOL, g, reference['grad'], XI_F32_GRAD_RTOL)
    lp, g = at_points(xi, names, points)
    check_close('phase 3: config xi: card, own host state vs JAX float32 at 16 points', lp, reference['logpost'],
                XI_F32_ATOL, g, reference['grad'], XI_F32_GRAD_RTOL)
    check_close('phase 3: config xi: card, own host state vs JAX float64 (x64) at 16 points', lp,
                reference['logpost_x64'], XI_X64_ATOL, g, reference['grad_x64'], XI_X64_GRAD_RTOL)
    xi_cpu = build_xi_likelihood('cpu')
    lp_cpu, g_cpu = at_points(xi_cpu, names, points[:4])
    check_close('phase 3: config xi: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, XI_X64_ATOL,
                g[:4], g_cpu, XI_X64_GRAD_RTOL)
    out['launches_hessian'], out['hessian_errors'] = check_start_hessian(
        xi, xi_cpu, 'config xi', {'u': reference['hessian_u'], 'hessian': reference['hessian']},
        expect_coeff_grad=False)  # the BAO template's coefficients do not vary by chain
    s = np.linspace(40., 140., 26)
    theory_golden('phase 3', DampedBAOWigglesTracerCorrelationFunctionMultipoles(
        ells=(0, 2), s=s, template=BAOPowerSpectrumTemplate(z=0.8)), golden, 'damped_bao_xi')
    for name, kwargs in (('ept_xi', dict(resum=None)), ('ept_xi_resum', {})):
        theory_golden('phase 3', EPTTracerCorrelationFunctionMultipoles(
            ells=(0, 2), s=s, template=ShapeFitPowerSpectrumTemplate(z=0.8), **kwargs), golden, name,
            x64=reference[name + '_x64'])
    return xi, fn, out


def kernel_profile(call, calls=2):
    """(device milliseconds, kernels) a call of ``call``: the sum of the
    device times of the kernels and copies that ``torch.profiler`` records
    over ``calls`` calls, and their number, after one call of warm-up. The
    cached blocks are released first: config 3d with the gradient at 32768
    (66 GiB) ran out of memory on the blocks the timed calls before it had
    split."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.empty_cache()
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    events = [event for event in prof.events() if event.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(event.device_time if hasattr(event, 'device_time') else event.cuda_time for event in events)
    return us / calls * 1e-3, len(events) / calls


def device_ms(call, calls=2):
    """Device milliseconds a call of ``call`` (:func:`kernel_profile`)."""
    return kernel_profile(call, calls)[0]


def solved_at_points(likelihood, names, rows):
    """The solved parameters (npoints, nsolved) of ``likelihood`` at the points ``rows``, as numpy."""
    import torch
    values = {n: torch.tensor(rows[:, i], dtype=torch.float32, device=likelihood.pipeline.device)
              for i, n in enumerate(names)}
    with torch.no_grad():
        _, aux = likelihood.logpost_fn()(values)
    return torch.stack([aux['solved'][n] for n in likelihood.pipeline.solved_params.names()], dim=-1).cpu().numpy()


def check_solved(label, got, expected, width):
    """Raise unless every solved parameter is within SOLVED_RTOL of its prior
    width or of its value; print the error."""
    err = float((np.abs(got - expected) / np.maximum(width, np.abs(expected))).max())
    line = '{}: max |d solved| / max(prior width, |solved|) {:.3e} (tol {:.0e})'.format(label, err, SOLVED_RTOL)
    print(line)
    if not err <= SOLVED_RTOL:
        raise AssertionError(line)


def check_config_3xi(smi):
    """Phase 3, config 3xi (config 3's EPT theory in configuration space, the
    counterterms solved by the linearize path) on the card, the slice's main
    path: log-posterior and gradient over B = 4096 and EPT_XI_BIG_BATCH
    seeded chains (finite, the 3 counterterms in ``aux['solved']`` with every
    chain factored, both kernels launched with the gradient, the launches
    counted forward and with the gradient, the peak of device memory, wall
    and device milliseconds a call each), the synchronising calls of one
    forward call, the frozen JAX x64 values of
    ``tests/data/torch_port_marg_reference.npz`` at 16 points (and the solved
    counterterms there), and the card against the port's CPU path at 4
    points. Returns (likelihood, its logpost_fn, the numbers)."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_marg_reference.npz'))
    t0 = time.perf_counter()
    like = build_ept_xi_likelihood(None)  # no device: the card
    pipe = like.pipeline
    names, solved = pipe.varied_params.names(), pipe.solved_params.names()
    out = dict(build_s=time.perf_counter() - t0, launches={}, max_memory_gib={}, wall_ms={}, device_ms={})
    if names != list(reference['ept_xi_names']) or solved != list(reference['ept_xi_solved_names']) \
            or like.size != 90:
        raise AssertionError('config 3xi varies {} and solves {} over {} data'.format(names, solved, like.size))
    fn = like.logpost_fn()
    if pipe.device.type != 'cuda':
        raise AssertionError('a likelihood built with no device evaluates on {}'.format(pipe.device))
    for batch in (BATCH, EPT_XI_BIG_BATCH):
        values = chains(names, batch, seed=0, device=pipe.device)
        runs = {}
        for mode in ('forward', 'with gradient'):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
            if mode == 'forward':
                with torch.no_grad():
                    logpost, aux = fn(values)
                grad = None
            else:
                logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            runs[mode] = (logpost, grad)
            out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
        logpost, grad = runs['with gradient']
        forward, backward = out['launches']['forward', batch], out['launches']['with gradient', batch]
        finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all()
                      and torch.isfinite(runs['forward'][0]).all())
        factored = int((aux['solved_info'] == 0).sum())

        def forward_call():
            with torch.no_grad():
                fn(values)

        def gradient_call():
            for value in values.values():
                value.grad = None
            fn(values)[0].sum().backward()

        for mode, call in (('forward', forward_call), ('with gradient', gradient_call)):
            out['wall_ms'][mode, batch] = time_cuda(call, 3 if batch == BATCH else 1, warmup=1)
            out['device_ms'][mode, batch] = device_ms(call, calls=1)
        print('phase 3: config 3xi: logpost and gradient over B={} chains on {!r}: shape {}, gradient {}, all finite '
              '{}, mean logpost {:.4f}, {} of {} chains factored; launches forward: Clenshaw {}, coefficient gradient '
              '{}; with the gradient: Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB forward, '
              '{:.2f} GiB with the gradient; wall {:.3f} ms forward, {:.3f} ms with the gradient a call; device '
              '{:.3f} and {:.3f} ms; {} data, {} varied, {} solved'.format(
                  batch, smi, tuple(logpost.shape), tuple(grad.shape), finite, float(logpost.mean()), factored, batch,
                  forward[0], forward[1], backward[0], backward[1], out['max_memory_gib']['forward', batch],
                  out['max_memory_gib']['with gradient', batch], out['wall_ms']['forward', batch],
                  out['wall_ms']['with gradient', batch], out['device_ms']['forward', batch],
                  out['device_ms']['with gradient', batch], like.size, len(names), len(solved)))
        if (logpost.shape != (batch,) or grad.shape != (batch, len(names)) or not finite or forward[0] <= 0
                or backward[0] <= 0 or forward[1] != 0 or backward[1] <= 0 or factored != batch):
            raise AssertionError('config 3xi main path failed at B={}'.format(batch))
        if list(aux['solved']) != solved or aux['solved_hessian'].shape != (batch, 3, 3) \
                or not all(bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values()):
            raise AssertionError('config 3xi: aux[\'solved\'] does not hold the 3 solved counterterms')
        if batch == BATCH:
            out['host_syncs'] = count_host_syncs(fn, values, 'config 3xi')
        del values, runs, logpost, grad, aux
        torch.cuda.empty_cache()
    points = reference['ept_xi_points']
    lp, g = at_points(like, names, points)
    check_close('phase 3: config 3xi: card vs JAX float64 (x64) at 16 points', lp, reference['ept_xi_logpost_x64'],
                EPT_X64_ATOL, g, reference['ept_xi_grad_x64'], EPT_X64_GRAD_RTOL)
    width = np.array([pipe.params[n].prior.scale for n in solved])
    check_solved('phase 3: config 3xi: solved counterterms on the card vs JAX x64 at 16 points',
                 solved_at_points(like, names, points), reference['ept_xi_solved_x64'], width)
    lp_cpu, g_cpu = at_points(build_ept_xi_likelihood('cpu'), names, points[:4])
    check_close('phase 3: config 3xi: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, EPT_X64_ATOL,
                g[:4], g_cpu, EPT_X64_GRAD_RTOL)
    return like, fn, out


def check_fisher_and_sum(xi, ept, smi):
    """Phase 3, the Fisher forecast and the summed likelihood on the card:
    ``Fisher`` of config xi (``xi``, built on the card) at its fiducial (b1 =
    2.0), jacfwd through the kernels over its 4 varied and 6 solved
    parameters, against the frozen JAX x64 matrix (|dF_ij| <= FISHER_RTOL
    sqrt(F_ii F_jj)); then ``FisherGaussianLikelihood`` of its view on qpar
    and qper plus config 3 (``ept``; they share qpar and qper, as the JAX
    package's sum does): over B = 4096 chains with the gradient (finite, both
    kernels launched), and at the 16 frozen points against the JAX x64
    values at config 3's limits. Returns the numbers."""
    import torch
    from desilike_tpu_torch import Fisher, FisherGaussianLikelihood
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_marg_reference.npz'))
    out = {}
    cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
    t0 = time.perf_counter()
    fisher = Fisher(xi)(b1=2.0)
    torch.cuda.synchronize()
    out['fisher_s'] = time.perf_counter() - t0
    out['launches_fisher'] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    F, ref = fisher.precision, -reference['fisher_xi_hessian_x64']
    err = float((np.abs(F - ref) / np.sqrt(np.outer(np.diag(ref), np.diag(ref)))).max())
    out['fisher_error'] = err
    line = ('phase 3: Fisher of config xi on {!r} ({} varied + solved, {:.2f} s; launches: Clenshaw {}, coefficient '
            'gradient {}): max |dF_ij| / sqrt(F_ii F_jj) from JAX x64 {:.3e} (tol {:.0e}); sigma(qpar) {:.5f}, '
            'sigma(qper) {:.5f}'.format(smi, len(fisher.names()), out['fisher_s'], *out['launches_fisher'], err,
                                        FISHER_RTOL, fisher.std('qpar'), fisher.std('qper')))
    print(line)
    if fisher.names() != list(reference['fisher_xi_names_x64']) or not err <= FISHER_RTOL \
            or out['launches_fisher'][0] <= 0:
        raise AssertionError(line)
    total = FisherGaussianLikelihood(fisher=fisher.view(['qpar', 'qper'])) + ept  # no device: the card
    pipe = total.pipeline
    names = pipe.varied_params.names()
    if names != list(reference['sum_names']) or pipe.solved_params.names() != list(reference['sum_solved_names']):
        raise AssertionError('the sum varies {} and solves {}'.format(names, pipe.solved_params.names()))
    fn = total.logpost_fn()
    values = chains(names, BATCH, seed=0, device=pipe.device)
    logpost, grad, forward, backward = drive(fn, values)
    out['launches_sum'] = {'forward': forward, 'with gradient': backward}
    finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
    print('phase 3: Fisher(config xi) view on qpar, qper + config 3 over B={} chains on {!r}: all finite {}, mean '
          'logpost {:.4f}; launches forward: Clenshaw {}, coefficient gradient {}; with the gradient: Clenshaw {}, '
          'coefficient gradient {}'.format(BATCH, smi, finite, float(logpost.mean()), *forward, *backward))
    if not finite or logpost.shape != (BATCH,) or backward[0] <= 0 or backward[1] <= 0:
        raise AssertionError('the summed likelihood failed at B={}'.format(BATCH))
    lp, g = at_points(total, names, reference['sum_points'])
    check_close('phase 3: Fisher(config xi) view + config 3: card vs JAX float64 (x64) at 16 points', lp,
                reference['sum_logpost_x64'], EPT_X64_ATOL, g, reference['sum_grad_x64'], EPT_X64_GRAD_RTOL)
    return out


def check_config5(smi, joint_fn):
    """Phase 3, config 5 (config 4 with emulated templates) on the card.
    Carried across: the JAX package's emulators of
    ``tests/data/torch_port_emulator_reference.npz`` (its Taylor files
    through ``Emulator.load``, its MLP weights through
    ``interop.mlp_state_from_flax``), the log-posterior and gradient at 16
    frozen points against its x64 and float32 values, and against the port's
    CPU path at 4 points. Then the port's own emulators, fitted on the card
    (:func:`emulated_templates`; seconds and final losses printed):
    ``check()`` below EMU_MLP_CHECK for each MLP and EMU_TAYLOR_CHECK for each
    Taylor series; log-posterior and gradient over B = 4096 and
    JOINT_BIG_BATCH chains (finite, the 30 solved parameters, both kernels
    launched, counted forward and with the gradient), wall and device
    milliseconds a call and the peak of device memory, and config 4's
    (``joint_fn``) wall and device milliseconds on the same chains, timed
    alongside. Returns (likelihood, its logpost_fn, the numbers)."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_emulator_reference.npz'))
    names, solved = list(reference['names']), list(reference['solved_names'])
    carried = build_emulated_likelihood(None, reference=reference)  # no device: the card
    pipe = carried.pipeline
    if pipe.varied_params.names() != names or pipe.solved_params.names() != solved or carried.size != 368 \
            or pipe.device.type != 'cuda':
        raise AssertionError('config 5 varies {} and solves {} over {} data on {}'.format(
            pipe.varied_params.names(), pipe.solved_params.names(), carried.size, pipe.device))
    points = reference['points']
    lp, g = at_points(carried, names, points)
    check_close('phase 3: config 5: card, the JAX package\'s emulators vs JAX float32 at 16 points', lp,
                reference['logpost'], JOINT_F32_ATOL, g, reference['grad'], JOINT_F32_GRAD_RTOL)
    check_close('phase 3: config 5: card, the JAX package\'s emulators vs JAX float64 (x64) at 16 points', lp,
                reference['logpost_x64'], JOINT_X64_ATOL, g, reference['grad_x64'], JOINT_X64_GRAD_RTOL)
    lp_cpu, g_cpu = at_points(build_emulated_likelihood('cpu', reference=reference), names, points[:4])
    check_close('phase 3: config 5: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, JOINT_X64_ATOL,
                g[:4], g_cpu, JOINT_X64_GRAD_RTOL)
    del carried

    out = dict(fit_s={}, loss={}, check={}, launches={}, max_memory_gib={}, wall_ms={}, device_ms={},
               config4_wall_ms={}, config4_device_ms={})
    t0 = time.perf_counter()
    emulators = emulated_templates(None)  # fitted on the card
    torch.cuda.synchronize()
    out['fit_s'] = time.perf_counter() - t0
    for namespace, emulator in emulators.items():
        out['check'][namespace] = emulator.check()
        if emulator.engine.name == 'mlp':
            out['loss'][namespace] = emulator.engine.loss
    print('phase 3: config 5: the port\'s emulators fitted on {!r} in {:.2f} s (MLP: 512 Sobol rows, 3000 Adam '
          'steps; Taylor order 3; classification included): final MLP losses {}; check() {}'.format(
              smi, out['fit_s'], {k: round(v, 8) for k, v in out['loss'].items()},
              {k: float('{:.3e}'.format(v)) for k, v in out['check'].items()}))
    for namespace, emulator in emulators.items():
        bound = EMU_MLP_CHECK if emulator.engine.name == 'mlp' else EMU_TAYLOR_CHECK
        if not out['check'][namespace] < bound:
            raise AssertionError('config 5: the {} emulator of {} checks at {} (bound {})'.format(
                emulator.engine.name, namespace, out['check'][namespace], bound))
    t0 = time.perf_counter()
    like = build_joint_likelihood(None, {ns: emu.to_calculator() for ns, emu in emulators.items()})
    out['build_s'] = time.perf_counter() - t0
    fn = like.logpost_fn()
    for batch in (BATCH, JOINT_BIG_BATCH):
        values = chains(names, batch, seed=0, device=like.pipeline.device)
        runs = {}
        for mode in ('forward', 'with gradient'):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
            if mode == 'forward':
                with torch.no_grad():
                    logpost, aux = fn(values)
                grad = None
            else:
                logpost, grad = logpost_and_grad(fn, values)
            torch.cuda.synchronize()
            runs[mode] = (logpost, grad)
            out['launches'][mode, batch] = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
            out['max_memory_gib'][mode, batch] = torch.cuda.max_memory_allocated() / 2 ** 30
        logpost, grad = runs['with gradient']
        forward, backward = out['launches']['forward', batch], out['launches']['with gradient', batch]
        finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all()
                      and torch.isfinite(runs['forward'][0]).all())

        for key, function in (('', fn), ('config4_', joint_fn)):  # config 5, then config 4 on the same chains
            def forward_call():
                with torch.no_grad():
                    function(values)

            def gradient_call():
                for value in values.values():
                    value.grad = None
                function(values)[0].sum().backward()

            for mode, call in (('forward', forward_call), ('with gradient', gradient_call)):
                out[key + 'wall_ms'][mode, batch] = time_cuda(call, 5 if batch == BATCH else 2, warmup=1)
                out[key + 'device_ms'][mode, batch] = device_ms(call, calls=1)
        rates = {key + mode: batch / out[key + 'wall_ms'][mode, batch] * 1e3
                 for key in ('', 'config4_') for mode in ('forward', 'with gradient')}
        print('phase 3: config 5: logpost and gradient over B={} chains on {!r}: shape {}, gradient {}, all finite '
              '{}, mean logpost {:.4f}; launches forward: Clenshaw {}, coefficient gradient {}; with the gradient: '
              'Clenshaw {}, coefficient gradient {}; peak device memory {:.2f} GiB forward, {:.2f} GiB with the '
              'gradient; wall {:.3f} ms forward ({:.0f} evals/s), {:.3f} ms with the gradient ({:.0f} evals/s); '
              'device {:.3f} and {:.3f} ms (busy {:.1%}, {:.1%}); config 4 alongside: wall {:.3f} and {:.3f} ms '
              '({:.0f} and {:.0f} evals/s), device {:.3f} and {:.3f} ms; {} data, {} varied, {} solved'.format(
                  batch, smi, tuple(logpost.shape), tuple(grad.shape), finite, float(logpost.mean()), forward[0],
                  forward[1], backward[0], backward[1], out['max_memory_gib']['forward', batch],
                  out['max_memory_gib']['with gradient', batch], out['wall_ms']['forward', batch],
                  rates['forward'], out['wall_ms']['with gradient', batch], rates['with gradient'],
                  out['device_ms']['forward', batch], out['device_ms']['with gradient', batch],
                  out['device_ms']['forward', batch] / out['wall_ms']['forward', batch],
                  out['device_ms']['with gradient', batch] / out['wall_ms']['with gradient', batch],
                  out['config4_wall_ms']['forward', batch], out['config4_wall_ms']['with gradient', batch],
                  rates['config4_forward'], rates['config4_with gradient'], out['config4_device_ms']['forward', batch],
                  out['config4_device_ms']['with gradient', batch], like.size, len(names), len(solved)))
        if (logpost.shape != (batch,) or grad.shape != (batch, len(names)) or not finite or forward[0] <= 0
                or backward[0] <= forward[0] or forward[1] != 0 or backward[1] <= 0):
            raise AssertionError('config 5 main path failed at B={}'.format(batch))
        if list(aux['solved']) != solved or aux['solved_hessian'].shape != (batch, 30, 30) \
                or not all(bool(torch.isfinite(v).all()) and v.shape == (batch,) for v in aux['solved'].values()):
            raise AssertionError('config 5: aux[\'solved\'] does not hold the 30 solved parameters')
        del values, runs, logpost, grad, aux
        torch.cuda.empty_cache()
    return like, fn, out


def run_emulated_nuts(joint, emulated, smi):
    """Phase 5 on config 5 (``emulated``, built on the card): NUTS over
    SAMPLER_BATCH chains (8 warmup and 4 sampling iterations, max_depth 4),
    with the launch counters set to 0 just before and read just after;
    raises unless every recorded log-posterior is finite, both kernels were
    launched and the share of sampling transitions that moved a chain lies
    in (0, 1). Then ``Fisher`` of config 5 against config 4's (``joint``):
    raises unless the standard deviations of qpar, dm, df and b1 of each
    tracer lie within a factor 0.7-1.4 (tests/test_config5.py:38-42).
    Returns the numbers."""
    import torch
    from desilike_tpu_torch import Fisher
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.samplers import NUTSSampler
    torch.cuda.synchronize()
    cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
    t0 = time.perf_counter()
    sampler = NUTSSampler(emulated, nchains=SAMPLER_BATCH, max_depth=4, seed=4)
    chain = sampler.run(nsteps=4, nwarmup=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    d = sampler.diagnostics
    x = np.stack([chain[name] for name in sampler.names], axis=-1)  # (nsteps, nchains, ndim)
    moved = float(np.any(x[1:] != x[:-1], axis=-1).mean())
    out = dict(chains=sampler.nchains, nwarmup=8, nsteps=4, max_depth=4, seconds=seconds,
               iterations=d['iterations'], iterations_per_s=d['iterations'] / seconds, leaves=d['leaves'],
               leaves_per_iteration=d['leaves'] / d['iterations'],
               chain_gradient_evaluations_per_s=sampler.nchains * sampler.gradient_evaluations / seconds,
               launches_clenshaw=launches[0], launches_coeff_grad=launches[1], moved_share=moved,
               divergence_rate=d['divergence_rate'], step_size=float(np.median(d['step_size'])),
               logposterior_finite=bool(np.isfinite(chain['logposterior']).all()), shape=list(chain.shape))
    print('phase 5: nuts on config 5 on {!r}: {}'.format(smi, json.dumps(out)))
    if not out['logposterior_finite'] or min(launches) <= 0 or not 0. < moved < 1.:
        raise AssertionError('NUTS on config 5: a recorded log-posterior is not finite, a kernel was not launched, '
                             'or the share of moves {} is outside (0, 1)'.format(moved))
    t0 = time.perf_counter()
    fisher, exact = Fisher(emulated)(), Fisher(joint)()
    out['fisher_s'] = time.perf_counter() - t0
    out['fisher_std_ratio'] = {name: float(fisher.std(name) / exact.std(name))
                               for name in ('{}.{}'.format(tracer, basename) for tracer in ('LRG', 'ELG')
                                            for basename in ('qpar', 'dm', 'df', 'b1'))}
    print('phase 5: Fisher of config 5 against config 4 on {!r} ({:.2f} s both): standard deviation ratios {}'.format(
        smi, out['fisher_s'], {k: round(v, 4) for k, v in out['fisher_std_ratio'].items()}))
    if not all(0.7 < ratio < 1.4 for ratio in out['fisher_std_ratio'].values()):
        raise AssertionError('config 5\'s Fisher is not within 0.7-1.4 of config 4\'s')
    return out


def time_xi_kernel(smi, device):
    """Phase 4 at config xi's shapes (:func:`xi_cases`' two batches): the
    Clenshaw kernel's device time by CUDA-graph replay beside its bound, its
    plain version's time, and at B = 4096 the nearest library call's
    (``torch.special.chebyshev_polynomial_t`` over (B, Q, order), an einsum
    with the coefficients, then exp: 2.8 G elements; at 65536 it would need
    45 G). Returns {label: numbers}."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    out = {}
    for case in xi_cases()[:2]:
        rows, q, order = case['rows'], case['q'], case['order']
        x, c = case_inputs(case, device, seed=2)
        entry = out['{}x{} order {}'.format(rows, q, order)] = {}
        runs = [time_graph(lambda: cuda_kernels.clenshaw(x, c)) for _ in range(2)]
        entry['ms'], entry['runs'] = float(np.mean(runs)), runs
        entry['bound_ms'], entry['bound_by'] = clenshaw_bound_ms(rows, q, order, False)
        entry['plain_ms'] = time_cuda(lambda: cuda_kernels.clenshaw_reference(x, c), 3, warmup=1)

        def library_call():  # every T_j(x) materialised, then a contraction and exp
            degrees = torch.arange(order, device=device)
            return torch.exp(torch.einsum('bqj,j->bq', torch.special.chebyshev_polynomial_t(x[..., None], degrees), c))

        entry['library_ms'] = time_cuda(library_call, 3, warmup=1) if rows == BATCH else None
        print('phase 4: config-xi shape {}x{} order {} shared exp on {!r}: Clenshaw {:.4f} ms a launch (CUDA-graph '
              'replay, runs {}), bound {:.4f} ms ({}), {:.1%} of it, plain version {:.4f} ms, '
              'chebyshev_polynomial_t + einsum + exp {} ms'.format(
                  rows, q, order, smi, entry['ms'], ['%.4f' % t for t in runs], entry['bound_ms'], entry['bound_by'],
                  entry['bound_ms'] / entry['ms'], entry['plain_ms'],
                  entry['library_ms'] and round(entry['library_ms'], 4)))
        del x, c
        torch.cuda.empty_cache()
    return out


def run_samplers(joint, ept, smi):
    """Phase 5: ChEES at SAMPLER_BATCH chains and NUTS at 64 chains (max_depth
    5) on config 4, and ChEES at SAMPLER_BATCH chains on config 3 (24 warmup
    and 8 sampling iterations, at most 16 leapfrog steps: with 8 warmup
    iterations the dual averaging has not settled, and the step size it
    leaves accepts nothing), on the card, each
    with the launch counters set to 0 just before and read just after.
    Raises unless every recorded log-posterior is finite, both kernels were
    launched and ChEES's acceptance lies in (0.2, 0.99). Returns the numbers."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.samplers import ChEESSampler, NUTSSampler
    out = {}
    for name, make, run in (
            ('chees', lambda: ChEESSampler(joint, nchains=SAMPLER_BATCH, max_leapfrog=32, seed=1),
             dict(nsteps=8, nwarmup=24)),
            ('nuts', lambda: NUTSSampler(joint, nchains=64, max_depth=5, seed=2), dict(nsteps=4, nwarmup=8)),
            ('chees_config3', lambda: ChEESSampler(ept, nchains=SAMPLER_BATCH, max_leapfrog=EPT_SAMPLER_LEAPFROG,
                                                   seed=3), dict(nsteps=8, nwarmup=24))):
        torch.cuda.synchronize()
        cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
        t0 = time.perf_counter()
        sampler = make()
        chain = sampler.run(**run)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
        d = sampler.diagnostics
        evaluations = sampler.gradient_evaluations
        entry = out[name] = dict(
            chains=sampler.nchains, nwarmup=run['nwarmup'], nsteps=run['nsteps'], seconds=seconds,
            iterations=d['iterations'], iterations_per_s=d['iterations'] / seconds,
            gradient_evaluations=evaluations, chain_gradient_evaluations_per_s=sampler.nchains * evaluations / seconds,
            launches_clenshaw=launches[0], launches_coeff_grad=launches[1],
            launches_per_gradient_evaluation=[l / max(evaluations, 1) for l in launches],
            host_reads=d['host_reads'], host_reads_per_iteration=d['host_reads'] / d['iterations'],
            logposterior_finite=bool(np.isfinite(chain['logposterior']).all()), shape=list(chain.shape))
        if name.startswith('chees'):
            entry.update(step_size=d['step_size'], trajectory_length=d['trajectory_length'],
                         acceptance_rate=d['acceptance_rate'], leapfrogs=d['leapfrogs'],
                         leapfrogs_per_iteration=d['leapfrogs'] / d['iterations'])
        else:
            entry.update(leaves=d['leaves'], leaves_per_iteration=d['leaves'] / d['iterations'],
                         divergence_rate=d['divergence_rate'], step_size=float(np.median(d['step_size'])))
        print('phase 5: {} on config {} on {!r}: {}'.format(name, 3 if name.endswith('config3') else 4, smi,
                                                          json.dumps(entry)))
        if not entry['logposterior_finite'] or min(launches) <= 0:
            raise AssertionError('{}: a recorded log-posterior is not finite, or a kernel was not launched'.format(name))
        if name.startswith('chees') and not 0.2 < entry['acceptance_rate'] < 0.99:
            raise AssertionError('{} acceptance {} outside (0.2, 0.99)'.format(name, entry['acceptance_rate']))
    # the launches of one leapfrog step: one batched log-density and its gradient
    for key, likelihood in (('launches_chees_step', joint), ('launches_chees_step_config3', ept)):
        sampler = ChEESSampler(likelihood, nchains=SAMPLER_BATCH)
        lg = sampler._logdens_grad()
        u = torch.tensor(sampler._unconstrain(np.stack([np.full(SAMPLER_BATCH, p.value)
                                                        for p in sampler.varied_params], axis=-1)),
                         dtype=torch.float32, device=sampler.device)
        torch.cuda.synchronize()
        cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
        lg(u)
        torch.cuda.synchronize()
        out[key] = [cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES]
        print('phase 5: kernel launches a leapfrog step on config {} (Clenshaw, coefficient gradient): {}'.format(
            3 if key.endswith('config3') else 4, out[key]))
    return out


A15_CHAINS = 4096       # MCMC chains and stretch walkers on config 3d
A15_SLICE_WALKERS = 1024
A15_NESTED = dict(nlive=4096, nbatch=1024, dlogz=0.5, max_iterations=16 * 1024)  # 16 batch steps at most
A15_OPTAX_STARTS, A15_OPTAX_STEPS = 256, 200
A15_BLOCKED = dict(nchains=8, nsteps=40)
SAME_DRAWS_RTOL = 1e-5


def gaussian_likelihoods(device):
    """The 2-parameter linear Gaussian of tests/test_samplers.py:10-31 in the
    port, on ``device``, and a likelihood with one host-evaluated node
    (tests/test_samplers.py:365-424): omega through a host code, b fast.
    Returns (gaussian, host-node likelihood, the host node's class)."""
    import torch
    from desilike_tpu_torch.core import Calculator
    from desilike_tpu_torch.likelihoods.base import BaseGaussianLikelihood
    xgrid, hgrid = np.linspace(-1, 1, 50), np.linspace(0., 1., 40)

    class GaussianModel(BaseGaussianLikelihood):
        _params = dict(BaseGaussianLikelihood._params,
                       a=dict(value=1.0, prior=dict(limits=[-4, 4]), ref=dict(dist='norm', loc=1.0, scale=0.2)),
                       b=dict(value=-0.5, prior=dict(limits=[-4, 4]), ref=dict(dist='norm', loc=-0.5, scale=0.2)))

        def initialize(self):
            self.flatdata = 1. * xgrid - 0.5
            self._set_whitening(np.eye(50) * 0.04)

        def flattheory(self):
            return self._a[..., None] * torch.as_tensor(xgrid, dtype=self._a.dtype, device=self._a.device) \
                + self._b[..., None]

        def calculate(self, a=1., b=0.):
            self._a, self._b = a, b
            super().calculate()

    class SlowHost(Calculator):
        _host_eval = True
        _state_attrs = ['shape']
        _params = {'omega': dict(value=0.3, prior=dict(limits=[0.1, 0.5]),
                                 ref=dict(dist='norm', loc=0.3, scale=0.01), proposal=0.01)}
        ncalls = 0

        def calculate(self, omega=0.3):
            SlowHost.ncalls += 1
            omega = omega.detach().cpu().numpy().astype('f8')  # the host code
            self.shape = torch.as_tensor(np.exp(-omega[:, None] * hgrid), dtype=self.dtype, device=self.device)

        def get(self):
            return self.shape

    class HostLike(BaseGaussianLikelihood):
        _params = dict(BaseGaussianLikelihood._params,
                       b=dict(value=2., prior=dict(limits=[0.5, 4.]), ref=dict(dist='norm', loc=2., scale=0.05),
                              proposal=0.02))

        def initialize(self):
            self.host = SlowHost()
            self.flatdata = 2. * np.exp(-0.3 * hgrid)
            self._set_whitening(np.eye(40) * 0.01 ** 2)

        def flattheory(self):
            return self._b[..., None] * self.host.shape

        def calculate(self, b=2.):
            self._b = b
            super().calculate()

    return GaussianModel(device=device), HostLike(device=device), SlowHost


def same_draws_error(label, got, expected):
    """max |got - expected| / max |expected| over tensors (or tuples of them)
    on any device; raises above SAME_DRAWS_RTOL."""
    import torch
    got = got if isinstance(got, (tuple, list)) else [got]
    expected = expected if isinstance(expected, (tuple, list)) else [expected]
    err = 0.
    for g, e in zip(got, expected):
        g, e = (torch.as_tensor(v).detach().double().cpu() for v in (g, e))
        err = max(err, float((g - e).abs().max() / max(float(e.abs().max()), 1e-30)))
    if not err <= SAME_DRAWS_RTOL:
        raise AssertionError('phase A15: {}: card vs the CPU path given the same draws: {:.3e} > {:.0e}'.format(
            label, err, SAME_DRAWS_RTOL))
    return err


def check_same_draws(cuda):
    """Phase A15: each new step on the 2-parameter Gaussian, on the card and
    on the CPU path, given the same draws (seeded numpy): 8 Metropolis steps
    (6 adapting: the scale, the pooled Welford moments and the Cholesky), a
    stretch and a slice ensemble step of 64 walkers, a nested batch step
    (16 of 64 live points, 5 slices), 20 Adam steps of the Optax profiler.
    Returns {step: max relative error}."""
    import torch
    from desilike_tpu_torch.samplers import MCMCSampler, EnsembleSampler, EnsembleSliceSampler, NestedSampler
    from desilike_tpu_torch.profilers import OptaxProfiler
    from desilike_tpu_torch.profilers.base import adam_update, warmup_cosine_decay
    rng = np.random.default_rng(15)
    likes = (('card', cuda, gaussian_likelihoods(cuda)[0]), ('cpu', torch.device('cpu'), gaussian_likelihoods('cpu')[0]))
    errors = {}

    def on(device, *arrays):
        return [torch.as_tensor(a, device=device) for a in arrays]

    # Metropolis
    x0 = (np.array([1., -0.5]) + 0.1 * rng.normal(size=(8, 2))).astype('f4')
    z, u = rng.normal(size=(8, 8, 2)).astype('f4'), rng.uniform(size=(8, 8)).astype('f4')
    out = {}
    for side, device, like in likes:
        sampler = MCMCSampler(like, nchains=8)
        x, zz, uu = on(device, x0, z, u)
        lp, aux = sampler.logpost_batch(x)
        zero = torch.zeros((), device=device)
        state = (x, lp, aux, zero, torch.as_tensor(sampler._chol, dtype=torch.float32, device=device),
                 torch.zeros(2, device=device), torch.zeros((2, 2), device=device), zero, zero)
        step = sampler._build_step(6)
        for i in range(8):
            state, _ = step(state, zz[i], uu[i], i < 6)
        out[side] = [state[i] for i in (0, 1, 3, 4, 5, 6, 7)]
    errors['mcmc'] = same_draws_error('Metropolis steps', out['card'], out['cpu'])
    # stretch and slice ensemble steps
    xw = (np.array([1., -0.5]) + 0.1 * rng.normal(size=(64, 2))).astype('f4')
    stretch = [(rng.integers(0, 32, 32), rng.uniform(size=32).astype('f4'), rng.uniform(size=32).astype('f4'))
               for _ in range(2)]
    slice_draws = []
    for _ in range(2):
        ia = rng.integers(0, 32, 32)
        ib = rng.integers(0, 31, 32)
        slice_draws.append((ia, np.where(ib >= ia, ib + 1, ib), rng.uniform(size=32).astype('f4'),
                            rng.uniform(size=32).astype('f4'), rng.uniform(size=(16, 32)).astype('f4')))
    for name, cls, draws in (('stretch', EnsembleSampler, stretch), ('slice', EnsembleSliceSampler, slice_draws)):
        out = {}
        for side, device, like in likes:
            sampler = cls(like, nwalkers=64)
            x = torch.as_tensor(xw, device=device)
            lp, aux = sampler.logpost_batch(x)
            zero = torch.zeros((), dtype=torch.int64, device=device)
            state = (x, lp, aux, zero) + ((zero,) if name == 'slice' else ())
            state, _ = sampler.step(state, on(device, *draws[0]), on(device, *draws[1]))
            out[side] = [state[0], state[1]] + [s.double() for s in state[3:]]
        errors[name] = same_draws_error('{} ensemble step'.format(name), out['card'], out['cpu'])
    # a nested batch step
    u0 = rng.uniform(size=(64, 2)).astype('f4')
    d = rng.normal(size=(5, 16, 2))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype('f4')
    nested = (rng.integers(0, 48, 16), d, rng.uniform(size=(5, 32, 16)).astype('f4'))
    out = {}
    for side, device, like in likes:
        sampler = NestedSampler(like, nlive=64, nbatch=16)
        uu = torch.as_tensor(u0, device=device)
        u_live, L_live, u_dead, L_dead, ncall = sampler.batch_step(uu, sampler._nsloglike(uu), *on(device, *nested))
        out[side] = [u_live, L_live, u_dead, L_dead, ncall.double()]
    errors['nested'] = same_draws_error('nested batch step', out['card'], out['cpu'])
    # Adam steps of the Optax profiler
    out = {}
    for side, device, like in likes:
        profiler = OptaxProfiler(like, nsteps=300)
        scales = torch.as_tensor(profiler._scales, dtype=torch.float32, device=device)
        uu = torch.as_tensor(np.array([1.2, -0.3]) / profiler._scales, dtype=torch.float32, device=device)
        m, v, path = torch.zeros_like(uu), torch.zeros_like(uu), []
        for i in range(20):
            with torch.enable_grad():
                ug = uu.clone().requires_grad_(True)
                (g,) = torch.autograd.grad(profiler.chi2(ug * scales), ug)
            update, m, v = adam_update(g, m, v, i + 1, warmup_cosine_decay(i, 0.1, 31, 300))
            uu = uu + update
            path.append(uu)
        out[side] = torch.stack(path)
    errors['adam'] = same_draws_error('Adam steps', out['card'], out['cpu'])
    print('phase A15: the new steps given the same draws, card vs the CPU path (max relative error, tol {:.0e}): '
          '{}'.format(SAME_DRAWS_RTOL, json.dumps(errors)))
    return errors


def a15_run(label, smi, make, run, config=None):
    """One run of phase A15 with the launch counters set to 0 just before it
    and read just after, its peak device memory, seconds and rates. ``make``
    builds the sampler or profiler, ``run(obj)`` drives it and returns
    (numbers, finite). Raises unless every record is finite and, on configs
    3d and 1 (``config``), the Clenshaw kernel was launched."""
    import torch
    from desilike_tpu_torch.ops import cuda_kernels
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.CLENSHAW_LAUNCHES = cuda_kernels.COEFF_GRAD_LAUNCHES = 0
    t0 = time.perf_counter()
    obj = make()
    numbers, finite = run(obj)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    entry = dict(config=config, seconds=seconds, launches_clenshaw=cuda_kernels.CLENSHAW_LAUNCHES,
                 launches_coeff_grad=cuda_kernels.COEFF_GRAD_LAUNCHES,
                 max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 evaluated_points=obj.evaluated_points, chain_evaluations_per_s=obj.evaluated_points / seconds,
                 **numbers)
    if 'iterations' in entry:
        entry['iterations_per_s'] = entry['iterations'] / seconds
    print('phase A15: {} on {!r}: {}'.format(label, smi, json.dumps(entry)))
    if not finite:
        raise AssertionError('phase A15: {}: a record is not finite'.format(label))
    if config is not None and entry['launches_clenshaw'] <= 0:
        raise AssertionError('phase A15: {}: the Clenshaw kernel was not launched'.format(label))
    return obj, entry


def chain_finite(chain):
    return bool(all(np.isfinite(chain[name]).all() for name in chain.names() if name != 'aweight'))


def run_a15(like, direct, probes, smi, cuda):
    """Phase A15: the samplers, profilers and profile containers of ROADMAP
    A15 on the card, through the CUDA Clenshaw kernels: Metropolis (16
    adaptation + 8 frozen steps) and the stretch ensemble (16 steps) at 4096
    chains, the slice ensemble at 1024 walkers (4 steps), grid (size 3, 3^9
    points) and QMC (4096 points) on config 3d; nested sampling on config 1
    (4096 live points, 1024 a batch step, dlogz 0.5, at most 16 batch steps),
    with one batch step from its last live set timed reading ``done.all()``
    and with 32 fixed iterations, in turns; the Metropolis chain reweighted
    under config 3j; the L-BFGS-B profiler from 2 starts with its parabolic
    errors, its best fit re-evaluated on the port's CPU path, and the Adam
    profiler with 256 starts in one batch (200 steps) on config 3d; the
    blocked sampler over 8 chains on a likelihood with a host-evaluated node;
    and the new steps given the same draws, card vs CPU path. Each run with
    the launch counters read around it. Returns the numbers."""
    import torch
    from desilike_tpu_torch.samplers import (MCMCSampler, EnsembleSampler, EnsembleSliceSampler, NestedSampler,
                                             GridSampler, QMCSampler, ImportanceSampler, BlockedMCMCSampler)
    from desilike_tpu_torch.profilers import ScipyProfiler, OptaxProfiler
    t_a15 = time.perf_counter()
    out, kept = {}, {}  # the numbers; the Metropolis chain and the profiler's best fit, kept for later runs

    def sampled(chain_of):
        def run(sampler):
            chain = kept[type(sampler).__name__] = chain_of(sampler)
            d = sampler.diagnostics
            numbers = dict(shape=list(chain.shape), iterations=d.get('iterations'), host_reads=d.get('host_reads'),
                           acceptance_rate=d.get('acceptance_rate'))
            return {k: v for k, v in numbers.items() if v is not None}, chain_finite(chain)
        return run

    mcmc, out['mcmc'] = a15_run('MCMCSampler, config 3d, {} chains, 16 adaptation + 8 frozen steps'.format(
        A15_CHAINS), smi, lambda: MCMCSampler(direct, nchains=A15_CHAINS, seed=11),
        sampled(lambda s: s.run(nsteps=24, nadapt=16)), config='3d')
    out['mcmc']['proposal_scale'] = mcmc.diagnostics['proposal_scale']
    _, out['ensemble'] = a15_run('EnsembleSampler, config 3d, {} walkers, 16 steps'.format(A15_CHAINS), smi,
                                 lambda: EnsembleSampler(direct, nwalkers=A15_CHAINS, seed=12),
                                 sampled(lambda s: s.run(nsteps=16)), config='3d')
    slice_sampler, out['ensemble_slice'] = a15_run(
        'EnsembleSliceSampler, config 3d, {} walkers, 4 steps'.format(A15_SLICE_WALKERS), smi,
        lambda: EnsembleSliceSampler(direct, nwalkers=A15_SLICE_WALKERS, seed=13),
        sampled(lambda s: s.run(nsteps=4)), config='3d')
    out['ensemble_slice'].update(ncall=slice_sampler.diagnostics['ncall'],
                                 batched_calls=slice_sampler.diagnostics['evaluations'])
    # a Metropolis or stretch move is refused at times; a slice move finds a point unless its loops run out
    for key, high in (('mcmc', 1.), ('ensemble', 1.), ('ensemble_slice', 1. + 1e-12)):
        if not 0. < out[key]['acceptance_rate'] < high:
            raise AssertionError('phase A15: {} acceptance {} outside (0, {})'.format(
                key, out[key]['acceptance_rate'], 1 if high == 1. else '1]'))

    def nested_run(sampler):
        chain = sampler.run(dlogz=A15_NESTED['dlogz'], max_iterations=A15_NESTED['max_iterations'])
        d = sampler.diagnostics
        return (dict(logz=d['logz'], logzerr=d['logzerr'], iterations=d['niterations'], ncall=d['ncall'],
                     host_reads=d['host_reads'], host_reads_per_batch_step=d['host_reads_per_batch_step'],
                     batched_calls=d['evaluations'], shape=list(chain.shape)),
                chain_finite(chain) and np.isfinite(d['logz']) and np.isfinite(d['logzerr']))

    nested, out['nested'] = a15_run(
        'NestedSampler, config 1, nlive {nlive}, nbatch {nbatch}, dlogz {dlogz}, max_iterations {max_iterations}'.format(
            **A15_NESTED), smi, lambda: NestedSampler(like, nlive=A15_NESTED['nlive'], nbatch=A15_NESTED['nbatch'],
                                                      seed=14), nested_run, config='1')
    # one batch step from the last live set, reading done.all() an iteration and with 32 fixed masked
    # iterations, in turns, on the same draws
    draws = nested._draws()
    u_live, L_live = nested._live
    timed = {True: [], False: []}
    for read_done in (True, False, False, True):
        nested.read_done = read_done
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = nested.batch_step(u_live, L_live, *draws)
        torch.cuda.synchronize()
        timed[read_done].append(time.perf_counter() - t0)
    del nested.read_done  # back to the class's choice
    out['nested'].update(batch_step_s_read_done=timed[True], batch_step_s_fixed_32=timed[False])
    print('phase A15: nested batch step on config 1 from the last live set: reading done.all() {} s, 32 fixed '
          'masked iterations {} s'.format(['%.4f' % t for t in timed[True]], ['%.4f' % t for t in timed[False]]))

    def grid_run(sampler):
        samples = sampler.run()
        return dict(points=len(samples['logposterior'])), bool(np.isfinite(samples['logposterior']).all())

    _, out['grid'] = a15_run('GridSampler, config 3d, size 3', smi, lambda: GridSampler(direct, size=3), grid_run,
                             config='3d')

    def qmc_run(sampler):
        samples = sampler.run(niterations=4096, evaluate=True)
        return dict(points=len(samples['logposterior'])), bool(np.isfinite(samples['logposterior']).all())

    _, out['qmc'] = a15_run('QMCSampler, config 3d, 4096 points', smi, lambda: QMCSampler(direct, seed=15), qmc_run,
                            config='3d')

    def importance_run(sampler):
        new = sampler.run(kept['MCMCSampler'])
        w = np.asarray(new['aweight'])
        return (dict(points=int(np.prod(new.shape)), effective_fraction=float(w.sum() ** 2 / (w ** 2).sum() / w.size)),
                bool(np.isfinite(new['logposterior']).all() and np.isfinite(w).all()))

    _, out['importance'] = a15_run('ImportanceSampler, the config-3d Metropolis chain under config 3j', smi,
                                   lambda: ImportanceSampler(probes), importance_run, config='3j')

    def scipy_run(profiler):
        with torch.no_grad():
            start_lp = float(profiler.logpost(profiler._tensor([p.value for p in profiler.varied_params])))
        profiles = profiler.maximize(niterations=2)
        best = profiles.choice()
        kept['best'] = best
        return (dict(start_logposterior=start_lp, bestfit_logposterior=best['logposterior'],
                     error={n: profiles.error.get(n) for n in profiler.names}, evaluations=profiler.evaluations),
                bool(np.isfinite(profiles.covariance).all() and np.isfinite(best['logposterior'])))

    scipy_profiler, out['scipy_profiler'] = a15_run('ScipyProfiler.maximize, config 3d, 2 starts, parabolic errors',
                                                    smi, lambda: ScipyProfiler(direct, seed=16), scipy_run, config='3d')
    best = kept['best']
    entry = out['scipy_profiler']
    if entry['launches_coeff_grad'] <= 0:
        raise AssertionError('phase A15: the profiler launched no coefficient-gradient kernel')
    if entry['bestfit_logposterior'] < entry['start_logposterior']:
        raise AssertionError('phase A15: the profiler ended below its start: {} < {}'.format(
            entry['bestfit_logposterior'], entry['start_logposterior']))
    t0 = time.perf_counter()
    cpu = build_ept_direct_likelihood('cpu')
    with torch.no_grad():
        lp_cpu = float(cpu.logpost_fn()({n: torch.tensor([best[n]]) for n in scipy_profiler.names})[0][0])
    entry.update(bestfit_logposterior_cpu=lp_cpu, cpu_check_s=time.perf_counter() - t0)
    print('phase A15: the profiler\'s best fit on config 3d: card {:.5f}, CPU path {:.5f} (tol 2e-2), start {:.5f}'.format(
        entry['bestfit_logposterior'], lp_cpu, entry['start_logposterior']))
    if not abs(lp_cpu - entry['bestfit_logposterior']) <= 2e-2:
        raise AssertionError('phase A15: the profiler\'s best fit reads {} on the CPU path, {} on the card'.format(
            lp_cpu, entry['bestfit_logposterior']))

    def optax_run(profiler):
        profiles = profiler.maximize(niterations=A15_OPTAX_STARTS)
        lps = np.asarray(profiles.bestfit['logposterior'])
        return (dict(starts=A15_OPTAX_STARTS, steps=A15_OPTAX_STEPS, iterations=A15_OPTAX_STEPS,
                     bestfit_logposterior=float(lps.max()), median_logposterior=float(np.median(lps)),
                     evaluations=profiler.evaluations),
                bool(np.isfinite(lps).all() and np.isfinite(profiles.covariance).all()))

    _, out['optax_profiler'] = a15_run('OptaxProfiler, config 3d, {} starts batched, {} steps'.format(
        A15_OPTAX_STARTS, A15_OPTAX_STEPS), smi, lambda: OptaxProfiler(direct, nsteps=A15_OPTAX_STEPS, seed=17),
        optax_run, config='3d')
    if out['optax_profiler']['launches_coeff_grad'] <= 0:
        raise AssertionError('phase A15: the Adam profiler launched no coefficient-gradient kernel')

    _, host_like, SlowHost = gaussian_likelihoods(None)
    SlowHost.ncalls = 0
    blocked, out['blocked'] = a15_run('BlockedMCMCSampler, a host-evaluated node, {nchains} chains, {nsteps} '
                                      'steps'.format(**A15_BLOCKED), smi,
                                      lambda: BlockedMCMCSampler(host_like, nchains=A15_BLOCKED['nchains'], seed=18),
                                      sampled(lambda s: s.run(nsteps=A15_BLOCKED['nsteps'])))
    out['blocked'].update(host_node_calls=SlowHost.ncalls, blocks=[list(b) for b, _ in blocked.blocks])
    if SlowHost.ncalls > A15_BLOCKED['nsteps'] + 2:
        raise AssertionError('phase A15: the host node ran {} times in {} steps'.format(SlowHost.ncalls,
                                                                                        A15_BLOCKED['nsteps']))
    out['same_draws'] = check_same_draws(cuda)
    out['seconds'] = time.perf_counter() - t_a15
    print('phase A15 took {:.1f} s'.format(out['seconds']))
    return out


def main(kernels_only=False):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False')
    sys.path.insert(0, ROOT)
    from desilike_tpu_torch.ops import cuda_kernels
    from desilike_tpu_torch.ops.cuda_kernels import clenshaw, clenshaw_reference, clenshaw_coeff_grad_reference
    from desilike_tpu_torch.interop import state_from_numpy
    from desilike_tpu_torch import (config, DampedBAOWigglesTracerPowerSpectrumMultipoles, BAOPowerSpectrumTemplate,
                                    ShapeFitPowerSpectrumTemplate, KaiserTracerPowerSpectrumMultipoles,
                                    EFTLikeKaiserTracerPowerSpectrumMultipoles)
    cuda = config.device('cuda')
    started = time.perf_counter()
    laps = [started]

    def lap(label):  # the seconds since the previous lap
        laps.append(time.perf_counter())
        print('{} took {:.1f} s'.format(label, laps[-1] - laps[-2]))

    # --- phase 1: the card ---
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cuda_kernels.library()
    ptxas = [line.strip() for line in cuda_kernels.BUILD_INFO['log'].splitlines() if 'registers' in line or 'spill' in line]
    print('phase 1: card {!r}; torch {}, CUDA {}; kernel library built and loaded in {:.2f} s; ptxas: {}'.format(
        smi, torch.__version__, torch.version.cuda, cuda_kernels.BUILD_INFO['seconds'], ' | '.join(ptxas)))
    resident = coeff_grad_occupancy()
    print('phase 1: coefficient-gradient instances, ptxas registers and blocks an SM holds (occupancy calculator) '
          'on {} SMs: {}'.format(torch.cuda.get_device_properties(0).multi_processor_count, ', '.join(
              '{}: {} registers, {} blocks'.format(label, regs, blocks) for label, (regs, blocks) in resident.items())))
    print(smi)
    lap('phase 1')

    # --- phase 2: the kernels against their plain versions ---
    like = build_likelihood(None)  # no device: the card
    pipe = like.pipeline
    names = pipe.varied_params.names()
    template = pipe.calculators[1]
    order = template._cheb.order
    if order != ORDER:
        raise AssertionError('the kernel cases assume the template\'s order {}, got {}'.format(ORDER, order))
    coeffs = torch.tensor(template.pk_dd_coeffs_fid, dtype=torch.float32, device=cuda)
    max_abs_err, max_rel = 0., 0.
    kobs = None
    for case in kernel_cases():
        err, rel, geometry = check_kernel_case(case, cuda)
        max_abs_err, max_rel = max(max_abs_err, err), max(max_rel, rel)
        print('phase 2: {}: max abs err {:.3e}, relative to max {:.3e}; K={} {} blocks of {} threads, '
              '{} rows a block, idle {:.3f}'.format(case_label(case), err, rel, geometry.k, geometry.grid,
                                                    geometry.threads, geometry.rows_per_block, geometry.idle))
        if case == dict(rows=56, q=1, order=202, per_row=False, log_values=True):
            kobs = geometry
    print('phase 2: the (56, 1) lookup launched {} block(s) of {} threads'.format(kobs.grid, kobs.threads))
    if kobs.grid > 1:
        raise AssertionError('the (56, 1) lookup takes more than one block')
    rng = np.random.default_rng(1)
    for batch in (1, BATCH):
        x = torch.tensor(rng.uniform(-1., 1., (batch, NQUERY)), dtype=torch.float32, device=cuda)
        xk = x.clone().requires_grad_(True)
        clenshaw(xk, coeffs).sum().backward()
        xr = x.clone().requires_grad_(True)
        clenshaw_reference(xr, coeffs).sum().backward()
        torch.cuda.synchronize()
        rel = float((xk.grad - xr.grad).abs().max() / xr.grad.abs().max())
        print('phase 2: B={} x-gradient through the kernel vs autograd of the plain version: max err relative to max {:.3e}'.format(
            batch, rel))
        if not rel <= 1e-4:
            raise AssertionError('kernel x-gradient disagrees with autograd of clenshaw_reference')
    # the x-gradient at config xi's lookups: (4096, 3000) shared, order 230, exp'd
    x, c = case_inputs(xi_cases()[0], cuda)
    weight = torch.tensor(np.random.default_rng(4).normal(size=tuple(x.shape)), dtype=torch.float32, device=cuda)
    xk, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    (clenshaw(xk, c) * weight).sum().backward()
    (clenshaw_reference(xr, c) * weight).sum().backward()
    torch.cuda.synchronize()
    rel = float((xk.grad - xr.grad).abs().max() / xr.grad.abs().max())
    print('phase 2: {} x-gradient through the kernel vs autograd of the plain version: max err relative to max '
          '{:.3e} (tol {:.0e})'.format(case_label(xi_cases()[0]), rel, KERNEL_RTOL))
    if not rel <= KERNEL_RTOL:
        raise AssertionError('kernel x-gradient disagrees with autograd of clenshaw_reference at config xi\'s shape')
    del x, c, weight, xk, xr
    print('phase 2: {} kernel cases agree with clenshaw_reference: max abs err {:.3e}, relative {:.3e} (tol {:.0e})'.format(
        len(kernel_cases()), max_abs_err, max_rel, KERNEL_RTOL))

    grad_abs_err, grad_rel = 0., 0.
    for case in coeff_grad_cases():
        err, rel, geometry = check_coeff_grad_case(case, cuda)
        grad_abs_err, grad_rel = max(grad_abs_err, err), max(grad_rel, rel)
        print('phase 2: coefficient gradient {}: max abs err {:.3e}, relative to max {:.3e}; NQ={} {} tile(s), '
              'prefetch {}, {} blocks of {} warps, idle {:.3f}'.format(
                  case_label(case), err, rel, geometry.nq, geometry.tiles, geometry.prefetch,
                  geometry.grid, geometry.warps, geometry.idle))
    print('phase 2: {} coefficient-gradient cases agree with clenshaw_coeff_grad_reference: max abs err {:.3e}, '
          'relative {:.3e} (tol {:.0e})'.format(len(coeff_grad_cases()), grad_abs_err, grad_rel, COEFF_GRAD_RTOL))
    # the full backward of the series at the full-shape lookups' shape: x and per-row coefficients
    case = dict(rows=BATCH, q=FS_NQUERY, order=ORDER, per_row=True, log_values=True)
    x, c = case_inputs(case, cuda)
    weight = torch.tensor(np.random.default_rng(4).normal(size=tuple(x.shape)), dtype=torch.float32, device=cuda)
    grads = []
    for function in (clenshaw, clenshaw_reference):
        xg, cg = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
        (function(xg, cg) * weight).sum().backward()
        grads.append((xg.grad, cg.grad))
    torch.cuda.synchronize()
    rel_x = float((grads[0][0] - grads[1][0]).abs().max() / grads[1][0].abs().max())
    rel_c = float((grads[0][1] - grads[1][1]).abs().max() / grads[1][1].abs().max())
    print('phase 2: full backward at {}: x-gradient {:.3e}, coefficient gradient {:.3e} of the magnitude from '
          'autograd through the plain version (tol 1e-4)'.format(case_label(case), rel_x, rel_c))
    if not (rel_x <= 1e-4 and rel_c <= COEFF_GRAD_RTOL):
        raise AssertionError('the backward of the series disagrees with autograd of clenshaw_reference')
    derivative_errors = {}
    for case in (dict(rows=BATCH, q=FS_NQUERY, order=ORDER, per_row=True, log_values=True),
                 dict(rows=BATCH, q=NQUERY, order=ORDER, per_row=False, log_values=True)):
        errors = derivative_errors[case_label(case)] = check_derivatives(case, cuda)
        print('phase 2: derivatives through the kernels at {} against the plain version, of the magnitude: {} '
              '(tol {:.0e} for the first derivatives, {:.0e} for the second)'.format(
                  case_label(case), ', '.join('{} {:.2e}'.format(k, e) for k, e in errors.items()), KERNEL_RTOL,
                  SECOND_RTOL))
    tns_overflow = check_tns_overflow(cuda)
    lap('phase 2')
    if kernels_only:
        print('phases 1 and 2 took {:.1f} s'.format(time.perf_counter() - started))
        return

    # --- phase 3: the likelihoods at full width ---
    reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_bao_reference.npz'))
    joint_reference = np.load(os.path.join(ROOT, 'tests', 'data', 'torch_port_joint_reference.npz'))
    golden = np.load(os.path.join(ROOT, 'tests', 'data', 'golden_theories.npz'))
    fn = like.logpost_fn()
    if pipe.device.type != 'cuda':
        raise AssertionError('a likelihood built with no device evaluates on {}'.format(pipe.device))
    values = chains(names, BATCH, seed=0, device=cuda)
    logpost, grad, forward1, launches1 = drive(fn, values)
    finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
    print('phase 3: config 1: logpost and gradient over B={} chains on {}: shape {}, all finite {}, mean logpost '
          '{:.4f}, Clenshaw launches {} forward, {} with the gradient'.format(
              BATCH, logpost.device, tuple(logpost.shape), finite, float(logpost.mean()), forward1[0], launches1[0]))
    if logpost.shape != (BATCH,) or not finite or forward1[0] <= 0 or launches1[0] <= forward1[0]:
        raise AssertionError('config 1 main path failed')

    points = reference['points']
    # the JAX float32 values carry up to 0.036 / 0.71% of their own float32
    # error (measured against the JAX package in x64); the x64 values bound
    # the port's own float32 error
    lp, g = at_points(state_from_numpy(build_likelihood('cuda'), reference), names, points)
    check_close('phase 3: config 1: card, JAX host state vs JAX float32 at 16 points', lp, reference['logpost'],
                5e-2, g, reference['grad'], 1e-2)
    lp, g = at_points(like, names, points)
    check_close('phase 3: config 1: card, own host state vs JAX float32 at 16 points', lp, reference['logpost'],
                5e-2, g, reference['grad'], 1e-2)
    check_close('phase 3: config 1: card, own host state vs JAX float64 (x64) at 16 points', lp,
                reference['logpost_x64'], 2e-3, g, reference['grad_x64'], 5e-4)
    lp_cpu, g_cpu = at_points(build_likelihood('cpu'), names, points[:4])
    check_close('phase 3: config 1: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, 2e-3,
                g[:4], g_cpu, 5e-4)
    k29 = np.linspace(0.02, 0.3, 29)
    theory_golden('phase 3', DampedBAOWigglesTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=k29, template=BAOPowerSpectrumTemplate(z=0.8, apmode='qparqper')), golden, 'damped_bao')
    lap('phase 3: config 1')

    joint = build_joint_likelihood(None)  # no device: the card
    jpipe = joint.pipeline
    jnames = jpipe.varied_params.names()
    solved_names = jpipe.solved_params.names()
    if jnames != list(joint_reference['names']) or solved_names != list(joint_reference['solved_names']):
        raise AssertionError('config 4 varies {} and solves {}'.format(jnames, solved_names))
    jfn = joint.logpost_fn()
    if jpipe.device.type != 'cuda':
        raise AssertionError('a likelihood built with no device evaluates on {}'.format(jpipe.device))
    jvalues = chains(jnames, BATCH, seed=0, device=cuda)
    logpost, grad, forward4, launches4 = drive(jfn, jvalues)
    with torch.no_grad():
        aux = jfn(jvalues)[1]
    finite = bool(torch.isfinite(logpost).all() and torch.isfinite(grad).all())
    print('phase 3: config 4: logpost and gradient over B={} chains on {}: shape {}, gradient {}, all finite {}, '
          'mean logpost {:.4f}; launches forward: Clenshaw {}, coefficient gradient {}; with the gradient: '
          'Clenshaw {}, coefficient gradient {}; {} data, {} varied, {} solved'.format(
              BATCH, logpost.device, tuple(logpost.shape), tuple(grad.shape), finite, float(logpost.mean()),
              forward4[0], forward4[1], launches4[0], launches4[1], joint.size, len(jnames), len(solved_names)))
    if (logpost.shape != (BATCH,) or grad.shape != (BATCH, 18) or not finite or forward4[0] <= 0
            or launches4[0] <= forward4[0] or forward4[1] != 0 or launches4[1] <= 0):
        raise AssertionError('config 4 main path failed')
    if list(aux['solved']) != solved_names or len(solved_names) != 30 or joint.size != 368 \
            or aux['solved_hessian'].shape != (BATCH, 30, 30) \
            or not all(bool(torch.isfinite(value).all()) and value.shape == (BATCH,) for value in aux['solved'].values()):
        raise AssertionError('config 4: aux[\'solved\'] does not hold the 30 solved parameters')

    jpoints = joint_reference['points']
    lp, g = at_points(state_from_numpy(build_joint_likelihood('cuda'), joint_reference), jnames, jpoints)
    check_close('phase 3: config 4: card, JAX host state vs JAX float32 at 16 points', lp, joint_reference['logpost'],
                JOINT_F32_ATOL, g, joint_reference['grad'], JOINT_F32_GRAD_RTOL)
    lp, g = at_points(joint, jnames, jpoints)
    check_close('phase 3: config 4: card, own host state vs JAX float32 at 16 points', lp, joint_reference['logpost'],
                JOINT_F32_ATOL, g, joint_reference['grad'], JOINT_F32_GRAD_RTOL)
    check_close('phase 3: config 4: card, own host state vs JAX float64 (x64) at 16 points', lp,
                joint_reference['logpost_x64'], JOINT_X64_ATOL, g, joint_reference['grad_x64'], JOINT_X64_GRAD_RTOL)
    joint_cpu = build_joint_likelihood('cpu')
    lp_cpu, g_cpu = at_points(joint_cpu, jnames, jpoints[:4])
    check_close('phase 3: config 4: card vs the port\'s CPU plain path at 4 points', lp[:4], lp_cpu, JOINT_X64_ATOL,
                g[:4], g_cpu, JOINT_X64_GRAD_RTOL)
    check_failed_chain(joint, jfn, jvalues)
    host_syncs = count_host_syncs(jfn, jvalues)
    launches_hessian, hessian_errors = check_start_hessian(joint, joint_cpu)
    theory_golden('phase 3', KaiserTracerPowerSpectrumMultipoles(
        ells=(0, 2, 4), k=k29, template=ShapeFitPowerSpectrumTemplate(z=0.8)), golden, 'kaiser')
    theory_golden('phase 3', EFTLikeKaiserTracerPowerSpectrumMultipoles(
        ells=(0, 2), k=k29, template=ShapeFitPowerSpectrumTemplate(z=0.8)), golden, 'eft_kaiser')
    lap('phase 3: config 4')
    ept, efn, config3 = check_config3(golden)
    lap('phase 3: config 3')
    direct, dfn, config3d = check_config3d(golden, smi, ept)
    dnames = direct.pipeline.varied_params.names()
    lap('phase 3: config 3d')
    enames = ept.pipeline.varied_params.names()
    xi, xfn, config_xi = check_config_xi(golden)
    xnames = xi.pipeline.varied_params.names()
    lap('phase 3: config xi')
    _, _, config_3xi = check_config_3xi(smi)
    lap('phase 3: config 3xi')
    tns, tfn, config_tns = check_config_tns(golden, smi, ept)
    tnames = tns.pipeline.varied_params.names()
    lap('phase 3: config tns')
    files, ffn, config3f, files_shapes = check_config3f(smi, direct, dfn)
    fnames = files.pipeline.varied_params.names()
    bao_compression_ms = check_bao_compression(smi)
    lap('phase 3: config 3f and the BAO compression likelihood')
    probes, _, config3j = check_config3j(smi, direct, dfn)
    theta = check_theta(smi)
    lap('phase 3: config 3j and Cosmology(theta=True)')
    cmb_family = check_cmb_family(smi)
    lap('phase 3: the CMB family')
    fisher_sum = check_fisher_and_sum(xi, ept, smi)
    lap('phase 3: the Fisher forecast and the sum')
    emulated, _, config5 = check_config5(smi, jfn)
    lap('phase 3: config 5')
    print('phases 1 to 3 took {:.1f} s'.format(time.perf_counter() - started))

    # --- phase 4: times (reported, not gated) ---
    saved = (cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES)
    timed = {}
    for label, rows, q, per_row in (('shared', BATCH, NQUERY, False), ('per-row', BATCH, NQUERY, True),
                                    ('per-row', BATCH, FS_NQUERY, True), ('shared', BIG_BATCH, NQUERY, False),
                                    ('shared', HESSIAN_ROWS, NQUERY, False), ('per-row', HESSIAN_ROWS, NQUERY, True),
                                    ('per-row', HESSIAN_ROWS, FS_NQUERY, True)):
        case = dict(rows=rows, q=q, order=order, per_row=per_row, log_values=True)
        x, c = case_inputs(case, cuda, seed=2)
        runs = [time_graph(lambda: clenshaw(x, c)) for _ in range(2)]
        bound_ms, bound_by = clenshaw_bound_ms(rows, q, order, per_row)
        timed[label, rows, q] = dict(ms=float(np.mean(runs)), bound_ms=bound_ms, bound_by=bound_by,
                                     geometry=cuda_kernels.LAST_GEOMETRY)  # that of the launches timed
        if rows == BATCH and (per_row, q) in ((False, NQUERY), (True, FS_NQUERY)):  # configs 1 and 4's main shapes
            timed[label, rows, q]['library_ms'] = library_series_ms(x, c, True)
        print('phase 4: Clenshaw {}x{} order {} {} on {!r}: device time {:.4f} ms a launch (CUDA-graph replay, '
              'runs {}); bound {:.4f} ms ({}), {:.1%} of it; chebyshev_polynomial_t + einsum + exp {} ms'.format(
                  rows, q, order, label, smi, timed[label, rows, q]['ms'], ['%.4f' % t for t in runs], bound_ms,
                  bound_by, bound_ms / timed[label, rows, q]['ms'], timed[label, rows, q].get('library_ms')))
    main_shape = timed['shared', BATCH, NQUERY]
    x, c = case_inputs(dict(rows=BATCH, q=NQUERY, order=order, per_row=False, log_values=True), cuda, seed=2)
    wrapper_host_ms = host_ms(lambda: clenshaw(x, c))
    plain = [time_cuda(lambda: clenshaw_reference(x, c), 5)]
    events = [time_cuda(lambda: clenshaw(x, c), 200)]
    plain.append(time_cuda(lambda: clenshaw_reference(x, c), 5))
    plain_ms = float(np.mean(plain))
    print('phase 4: Clenshaw {}x{} order {}: wrapper host time {:.4f} ms a call; back-to-back calls {:.4f} ms a '
          'call (CUDA events, host included); plain version {:.4f} ms (runs {})'.format(
              BATCH, NQUERY, order, wrapper_host_ms, events[0], plain_ms, ['%.4f' % t for t in plain]))

    grad_timed = {}
    for q in (FS_NQUERY, NQUERY):
        case = dict(rows=BATCH, q=q, order=order, per_row=True, log_values=True)
        x, c = case_inputs(case, cuda, seed=2)
        w = torch.tensor(np.random.default_rng(5).normal(size=tuple(x.shape)), dtype=torch.float32, device=cuda)
        with torch.no_grad():
            y = clenshaw(x, c)  # the exp'd forward output, multiplied in at load as on the config-4 path

        def kernel_call():  # the launch that clenshaw's backward makes
            return cuda_kernels._launch_coeff_grad(x, w, y, order, True)

        runs = [time_graph(kernel_call) for _ in range(2)]
        bound_ms, bound_by = coeff_grad_bound_ms(BATCH, q, order, True)
        entry = grad_timed[q] = dict(ms=float(np.mean(runs)), bound_ms=bound_ms, bound_by=bound_by,
                                     geometry=cuda_kernels.LAST_COEFF_GRAD_GEOMETRY)  # that of the launches timed
        wy = w * y
        entry['plain_ms'] = time_cuda(lambda: clenshaw_coeff_grad_reference(x, wy, order), 3, warmup=1)
        got = kernel_call()

        def library_call():  # the nearest a library offers: every T_j(x) materialised, then a contraction
            degrees = torch.arange(order, device=cuda)
            return torch.einsum('bq,bqj->bj', wy, torch.special.chebyshev_polynomial_t(x[..., None], degrees))

        try:  # a yardstick only, used nowhere in the port: where the card cannot hold it, say so
            entry['library_ms'] = time_cuda(library_call, 3, warmup=1)
            lib_rel = float((library_call() - got).abs().max() / got.abs().max())
        except torch.cuda.OutOfMemoryError as exc:
            entry['library_ms'], lib_rel = None, float('nan')
            print('phase 4: chebyshev_polynomial_t + einsum could not run at {}x{}: {}'.format(BATCH, q, str(exc)[:300]))
        print('phase 4: coefficient gradient {}x{} order {} per-row on {!r}: device time {:.4f} ms a launch '
              '(CUDA-graph replay, runs {}); bound {:.4f} ms ({}), {:.1%} of it; plain version {:.4f} ms; '
              'chebyshev_polynomial_t + einsum {} ms ({:.2f} GB materialised, {:.1e} of the magnitude from '
              'the kernel)'.format(BATCH, q, order, smi, entry['ms'], ['%.4f' % t for t in runs], bound_ms, bound_by,
                                   bound_ms / entry['ms'], entry['plain_ms'],
                                   entry['library_ms'] and round(entry['library_ms'], 4),
                                   4e-9 * BATCH * q * order, lib_rel))
        del x, c, w, y, wy, got
    # the coefficient gradient at the start-point Hessian's shape
    x, c = case_inputs(dict(rows=HESSIAN_ROWS, q=FS_NQUERY, order=order, per_row=True, log_values=True), cuda, seed=2)
    w = torch.tensor(np.random.default_rng(5).normal(size=tuple(x.shape)), dtype=torch.float32, device=cuda)
    with torch.no_grad():
        y = clenshaw(x, c)
    runs = [time_graph(lambda: cuda_kernels._launch_coeff_grad(x, w, y, order, True)) for _ in range(2)]
    bound_ms, bound_by = coeff_grad_bound_ms(HESSIAN_ROWS, FS_NQUERY, order, True)
    grad_timed['hessian'] = dict(ms=float(np.mean(runs)), bound_ms=bound_ms, bound_by=bound_by)
    print('phase 4: coefficient gradient {}x{} order {} per-row on {!r}: device time {:.4f} ms a launch (CUDA-graph '
          'replay, runs {}); bound {:.4f} ms ({})'.format(HESSIAN_ROWS, FS_NQUERY, order, smi, grad_timed['hessian']['ms'],
                                                         ['%.4f' % t for t in runs], bound_ms, bound_by))
    del x, c, w, y
    ept_timed = time_ept_kernels(smi, cuda)
    ept_xi_timed = time_ept_kernels(smi, cuda, ept_xi_cases(), 'config 3xi')
    template_timed = time_ept_kernels(smi, cuda, template_cases(), 'the templates\' wiggles')
    xi_timed = time_xi_kernel(smi, cuda)
    cosmology_timed = time_cosmology_node(direct, smi)
    tns_timed = time_ept_kernels(smi, cuda, [dict(rows=rows, q=TNS_NQUERY, order=EPT_ORDER, per_row=True, log_values=True,
                                                  shared_x=True, plain=rows == TNS_CHECK_ROWS)
                                             for rows in TNS_BATCHES], 'config tns')
    files_timed = time_ept_kernels(smi, cuda, files_shapes.cases() + [case for case in files_cases()
                                                                      if case['rows'] != BATCH], 'config 3f')
    cuda_kernels.CLENSHAW_LAUNCHES, cuda_kernels.COEFF_GRAD_LAUNCHES = saved

    rates = {}
    for label, function, varied, batches in (('config 1', fn, names, (BATCH, BIG_BATCH)),
                                             ('config 4', jfn, jnames, (BATCH, JOINT_BIG_BATCH)),
                                             ('config 3', efn, enames, (BATCH, EPT_BIG_BATCH)),
                                             ('config 3d', dfn, dnames, (BATCH, EPT_BIG_BATCH)),
                                             ('config xi', xfn, xnames, (BATCH, BIG_BATCH)),
                                             ('config tns', tfn, tnames, TNS_BATCHES),
                                             ('config 3f', ffn, fnames, FILES_BATCHES)):
        for batch in batches:
            torch.cuda.empty_cache()
            fixed = chains(varied, batch, seed=1, device=cuda)
            with torch.no_grad():
                forward_ms = time_cuda(lambda: function(fixed), 20 if batch == BATCH and label != 'config tns' else 5)
            rates[label, batch] = batch / forward_ms * 1e3
            line = 'phase 4: {} logpost at B={} on {!r}: {:.4f} ms a call, {:.0f} evals/s'.format(
                label, batch, smi, forward_ms, rates[label, batch])
            # config 3d with the gradient at 32768 (66 GiB) is timed in phase 3: here, beside the other
            # likelihoods' blocks, the card cannot hold it
            if (batch in TNS_GRAD_BATCHES) if label == 'config tns' else \
                    (batch == BATCH or label in ('config 3', 'config xi')) and label != 'config 3f':
                # gradients accumulate; harmless
                backward_ms = time_cuda(lambda: function(fixed)[0].sum().backward(),
                                        10 if batch == BATCH and label != 'config tns' else 3)
                rates[label, batch, 'gradient'] = batch / backward_ms * 1e3
                line += '; with gradient {:.4f} ms, {:.0f} evals/s'.format(backward_ms, batch / backward_ms * 1e3)
            print(line)
            del fixed
            torch.cuda.empty_cache()
    lap('phase 4')
    # --- phase 5: the samplers on config 4 ---
    t5 = time.perf_counter()
    samplers = run_samplers(joint, ept, smi)
    samplers['nuts_config5'] = run_emulated_nuts(joint, emulated, smi)
    samplers['seconds'] = time.perf_counter() - t5
    print('phase 5 took {:.1f} s'.format(samplers['seconds']))
    # --- phase A15: the samplers, profilers and profile containers on configs 3d, 1 and 3j ---
    samplers['a15'] = run_a15(like, direct, probes, smi, cuda)
    print('all phases took {:.1f} s'.format(time.perf_counter() - started))
    a15_launches = {run: [entry['launches_clenshaw'], entry['launches_coeff_grad']]
                    for run, entry in samplers['a15'].items() if isinstance(entry, dict) and 'launches_clenshaw' in entry}

    fs = timed['per-row', BATCH, FS_NQUERY]
    launches3 = config3['launches']['with gradient', BATCH]
    main_grad = grad_timed[FS_NQUERY]
    print(json.dumps({'kernels': [{
        'name': 'clenshaw', 'route': 'cuda', 'source': 'desilike_tpu_torch/csrc/clenshaw.cu',
        'replaces': 'desilike_tpu/ops/pallas_kernels.py:30', 'launches': launches4[0],
        'launches_forward': forward4[0], 'launches_with_gradient': launches4[0],
        'launches_config1_forward': forward1[0], 'launches_config1_with_gradient': launches1[0],
        'queries_per_thread': main_shape['geometry'].k, 'max_abs_err': max_abs_err,
        'ms': main_shape['ms'], 'plain_ms': plain_ms, 'bound_ms': main_shape['bound_ms'],
        'bound_by': main_shape['bound_by'], 'share_of_bound': main_shape['bound_ms'] / main_shape['ms'],
        'library_ms': main_shape['library_ms'], 'ms_per_row': timed['per-row', BATCH, NQUERY]['ms'],
        'ms_per_row_288': fs['ms'], 'bound_ms_per_row_288': fs['bound_ms'], 'library_ms_per_row_288': fs['library_ms'],
        'ms_65536': timed['shared', BIG_BATCH, NQUERY]['ms'],
        'bound_ms_65536': timed['shared', BIG_BATCH, NQUERY]['bound_ms'], 'host_ms': wrapper_host_ms,
        'geometry': main_shape['geometry']._asdict(), 'launches_chees_step': samplers['launches_chees_step'][0],
        'launches_hessian': launches_hessian[0], 'derivative_errors': derivative_errors,
        'hessian_errors': hessian_errors, 'ms_hessian': {'{} {}'.format(label, q): timed[label, HESSIAN_ROWS, q]['ms']
                                                        for label, rows, q in timed if rows == HESSIAN_ROWS},
        'bound_ms_hessian': {'{} {}'.format(label, q): timed[label, HESSIAN_ROWS, q]['bound_ms']
                             for label, rows, q in timed if rows == HESSIAN_ROWS},
        'launches_config3': launches3[0], 'launches_chees_step_config3': samplers['launches_chees_step_config3'][0],
        **{'launches_config3d_{}_{}'.format(mode.replace(' ', '_'), batch): value[0]
           for (mode, batch), value in config3d['launches'].items()},
        **{key + '_config3': {label: entry[key] for label, entry in ept_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{key + '_config_3xi': {label: entry[key] for label, entry in ept_xi_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{key + '_templates': {label: entry[key] for label, entry in template_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config_3xi_' + '{}_{}'.format(mode.replace(' ', '_'), batch): value[0]
           for (mode, batch), value in config_3xi['launches'].items()},
        'launches_fisher': fisher_sum['launches_fisher'][0],
        **{'launches_sum_' + mode.replace(' ', '_'): value[0] for mode, value in fisher_sum['launches_sum'].items()},
        **{'launches_config5_{}_{}'.format(mode.replace(' ', '_'), batch): value[0]
           for (mode, batch), value in config5['launches'].items()},
        'launches_nuts_config5': samplers['nuts_config5']['launches_clenshaw'],
        'launches_a15': {run: value[0] for run, value in a15_launches.items()},
        'launches_config_xi': config_xi['launches']['with gradient', BATCH][0],
        'launches_config_xi_forward': config_xi['launches']['forward', BATCH][0],
        'launches_hessian_config_xi': config_xi['launches_hessian'][0],
        **{key + '_config_xi': {label: entry[key] for label, entry in xi_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config_tns_{}_{}'.format(mode.replace(' ', '_'), batch): value[0]
           for (mode, batch), value in config_tns['launches'].items()},
        **{key + '_config_tns': {label: entry[key] for label, entry in tns_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config3f_{}_{}'.format(mode.replace(' ', '_'), batch): value[0]
           for (mode, batch), value in config3f['launches'].items()},
        **{key + '_config3f': {label: entry[key] for label, entry in files_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config3j_{}_{}'.format(mode.replace(' ', '_'), batch): value[0]
           for (mode, batch), value in config3j['launches'].items()},
        'max_rel_err_past_2_31': tns_overflow[0]}, {
        'name': 'clenshaw_coeff_grad', 'route': 'cuda', 'source': 'desilike_tpu_torch/csrc/clenshaw_coeff_grad.cu',
        'replaces': 'desilike_tpu/ops/pallas_kernels.py:30', 'launches': launches4[1],
        'launches_forward': forward4[1], 'launches_with_gradient': launches4[1], 'max_abs_err': grad_abs_err,
        'max_rel_err': grad_rel, 'ms': main_grad['ms'], 'plain_ms': main_grad['plain_ms'],
        'bound_ms': main_grad['bound_ms'], 'bound_by': main_grad['bound_by'],
        'share_of_bound': main_grad['bound_ms'] / main_grad['ms'], 'library_ms': main_grad['library_ms'],
        'ms_560': grad_timed[NQUERY]['ms'], 'bound_ms_560': grad_timed[NQUERY]['bound_ms'],
        'plain_ms_560': grad_timed[NQUERY]['plain_ms'], 'library_ms_560': grad_timed[NQUERY]['library_ms'],
        'geometry': main_grad['geometry']._asdict(), 'geometry_560': grad_timed[NQUERY]['geometry']._asdict(),
        'resident_blocks': resident, 'launches_chees_step': samplers['launches_chees_step'][1],
        'launches_hessian': launches_hessian[1], 'ms_hessian_288': grad_timed['hessian']['ms'],
        'bound_ms_hessian_288': grad_timed['hessian']['bound_ms'],
        'launches_config3': launches3[1], 'launches_chees_step_config3': samplers['launches_chees_step_config3'][1],
        **{'launches_config3d_{}_{}'.format(mode.replace(' ', '_'), batch): value[1]
           for (mode, batch), value in config3d['launches'].items()},
        **{key + '_config3': {label: entry['grad_' + key] for label, entry in ept_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{key + '_config_3xi': {label: entry['grad_' + key] for label, entry in ept_xi_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{key + '_templates': {label: entry['grad_' + key] for label, entry in template_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config_3xi_' + '{}_{}'.format(mode.replace(' ', '_'), batch): value[1]
           for (mode, batch), value in config_3xi['launches'].items()},
        'launches_fisher': fisher_sum['launches_fisher'][1],
        **{'launches_sum_' + mode.replace(' ', '_'): value[1] for mode, value in fisher_sum['launches_sum'].items()},
        **{'launches_config5_{}_{}'.format(mode.replace(' ', '_'), batch): value[1]
           for (mode, batch), value in config5['launches'].items()},
        'launches_nuts_config5': samplers['nuts_config5']['launches_coeff_grad'],
        'launches_a15': {run: value[1] for run, value in a15_launches.items()},
        **{'launches_config_tns_{}_{}'.format(mode.replace(' ', '_'), batch): value[1]
           for (mode, batch), value in config_tns['launches'].items()},
        **{key + '_config_tns': {label: entry['grad_' + key] for label, entry in tns_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config3f_{}_{}'.format(mode.replace(' ', '_'), batch): value[1]
           for (mode, batch), value in config3f['launches'].items()},
        **{key + '_config3f': {label: entry['grad_' + key] for label, entry in files_timed.items()}
           for key in ('ms', 'bound_ms', 'plain_ms', 'library_ms')},
        **{'launches_config3j_{}_{}'.format(mode.replace(' ', '_'), batch): value[1]
           for (mode, batch), value in config3j['launches'].items()},
        'max_rel_err_past_2_31': tns_overflow[1]}],
        'evals_per_s': {' '.join(str(part) for part in key): rate for key, rate in rates.items()},
        'host_syncs_forward': host_syncs,
        **{name: {'build_s': numbers['build_s'],
                  'launches': {'{} {}'.format(*key): value for key, value in numbers['launches'].items()},
                  'max_memory_gib': {'{} {}'.format(*key): value for key, value in numbers['max_memory_gib'].items()}}
           for name, numbers in (('config3', config3), ('config_xi', config_xi))},
        'hessian_errors_config_xi': config_xi['hessian_errors'],
        'config3d': {'build_s': config3d['build_s'], 'host_syncs_forward': config3d['host_syncs'],
                     'host_syncs_forward_config3': config3d['host_syncs_config3'],
                     'fisher_s': config3d['fisher_s'], 'fisher_error': config3d['fisher_error'],
                     'fisher_std': config3d['fisher_std'], 'launches_fisher': config3d['launches_fisher'],
                     **{key: {'{} {}'.format(*k): v for k, v in config3d[key].items()}
                        for key in ('launches', 'max_memory_gib', 'wall_ms', 'device_ms', 'config3_wall_ms',
                                    'config3_device_ms')},
                     'cosmology_node': {'{} {}'.format(*k): v for k, v in cosmology_timed.items()}},
        'config_3xi': {'build_s': config_3xi['build_s'], 'big_batch': EPT_XI_BIG_BATCH,
                       'host_syncs_forward': config_3xi['host_syncs'],
                       **{key: {'{} {}'.format(*k): v for k, v in config_3xi[key].items()}
                          for key in ('launches', 'max_memory_gib', 'wall_ms', 'device_ms')}},
        'config5': {'fit_s': config5['fit_s'], 'build_s': config5['build_s'], 'loss': config5['loss'],
                    'check': config5['check'],
                    **{key: {'{} {}'.format(*k): v for k, v in config5[key].items()}
                       for key in ('launches', 'max_memory_gib', 'wall_ms', 'device_ms', 'config4_wall_ms',
                                   'config4_device_ms')},
                    'evals_per_s': {'{} {}'.format(*k): k[1] / v * 1e3 for k, v in config5['wall_ms'].items()}},
        'fisher_sum': {'fisher_s': fisher_sum['fisher_s'], 'fisher_error': fisher_sum['fisher_error'],
                       'launches_fisher': fisher_sum['launches_fisher'], 'launches_sum': fisher_sum['launches_sum']},
        'host_syncs_forward_config_xi': {batch: config_xi['host_syncs', batch] for batch in (BATCH, BIG_BATCH)},
        'config_tns': {'build_s': config_tns['build_s'], 'host_syncs_forward': config_tns['host_syncs'],
                       'profile_forward_{}'.format(TNS_BATCHES[-1]): config_tns['profile'],
                       **{key: {'{} {}'.format(*k): v for k, v in config_tns[key].items()}
                          for key in ('launches', 'max_memory_gib', 'wall_ms', 'device_ms', 'config3_wall_ms',
                                      'config3_device_ms')},
                       'evals_per_s': {'{} {}'.format(*k): k[1] / v * 1e3 for k, v in config_tns['wall_ms'].items()}},
        'config3f': {'write_s': config3f['write_s'], 'build_s': config3f['build_s'], 'hartlap': config3f['hartlap'],
                     'percival': config3f['percival'], 'nmocks': config3f['nmocks'],
                     'launch_shapes': {' '.join(str(part) for part in key): value
                                       for key, value in files_shapes.shapes.items()},
                     **{key: {'{} {}'.format(*k): v for k, v in config3f[key].items()}
                        for key in ('launches', 'max_memory_gib', 'wall_ms', 'device_ms', 'config3d_wall_ms',
                                    'config3d_device_ms')},
                     'evals_per_s': {'{} {}'.format(*k): k[1] / v * 1e3 for k, v in config3f['wall_ms'].items()}},
        'bao_compression_ms_4096': bao_compression_ms,
        'config3j': {'write_s': config3j['write_s'], 'build_s': config3j['build_s'],
                     'mb_mean': {str(k): v for k, v in config3j['mb_mean'].items()},
                     **{key: {'{} {}'.format(*k): v for k, v in config3j[key].items()}
                        for key in ('launches', 'max_memory_gib', 'wall_ms', 'device_ms', 'busy', 'config3d_wall_ms',
                                    'config3d_device_ms')}},
        'theta': theta, 'cmb_family': cmb_family}))
    print(json.dumps({'samplers': samplers, 'card': smi}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main(kernels_only=sys.argv[1:] == ['--kernels-only'])
