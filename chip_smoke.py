#!/usr/bin/env python3
"""Drive pint_tpu_torch's main path on one NVIDIA GPU and hold every kernel
against its plain-torch twin.

    python3 chip_smoke.py

Phases, in order (any failed check raises and the exit code is non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``pint_tpu_torch/csrc`` (nvcc, sm_90a);
3. K0 ``dd_elementwise`` bitwise against the dd twins on 1M random and
   adversarial-cancellation inputs, and at the (2,) shape of the fit's
   parameter update (F0 and F1, the double-double free parameters);
4. K1 ``resid_tangent`` against its twin on the 16,384-TOA archive, at the
   fit's shape (1 parameter set, 4 tangent lanes) and the grid's (9 sets,
   2 lanes): time residuals within 1 ps, pulse numbers equal, f within
   1e-15 relative, tangents within 1e-10 relative;
5. K2 ``normal_eq`` against its twin on the grid's first step: G, c, chi^2
   and the column norms within 1e-12 relative (only the summation order
   differs);
6. the WLS fit: ``DownhillWLSFitter.fit_toas`` from SMOKE_PAR with F0 moved
   by +2e-10 Hz and DM by +1e-3, checked for convergence, chi^2/dof in
   [0.8, 1.2], params within 1e-10 relative and 1e-6 of their uncertainty,
   and uncertainties within 1e-10 relative, of the same fit run through the
   twins on the card;
7. the 3x3 (F0, F1) ``grid_chisq`` around the fit, per point within 1e-10
   relative of the twin path, its minimum at the centre;
8. kernel and twin times; the wall of one warm fit + grid without the
   profiler, then a torch.profiler pass over one more: device time by
   kernel and the device's busy share of the unprofiled wall.

Then the flagship path, on ``pint_tpu_torch/data/flagship_n16384.npz``
(``profiles.FLAGSHIP_SMOKE_PAR``: PM/PX astrometry, DM + DM1, ELL1,
EFAC/EQUAD/ECORR; 16,384 TOAs in 2,048 ECORR epochs, 14 free parameters):

9. K1 with the ELL1 term against its twin at the GLS fit's shape (1 set,
   14 lanes) and the grid's (9 (M2, SINI) sets, 12 lanes): time residuals
   within 1 ps, pulse numbers equal, tangents within 1e-12 relative;
10. K3 ``ecorr_normal_eq`` against its twin (the ``fitting/woodbury.py``
   algebra) on the GLS step's raw design (B = 1, p = 14, unweighted column
   norms) and the grid's first step (B = 9, p = 14: 12 tangent columns and
   the analytic DM, DM1 ones, weighted means removed, weighted norms), and
   on the two chi^2 calls (p = 0): G, c, chi^2, ahat and the norms within
   1e-12 relative (the sums run in another order), and bitwise equal
   across two runs;
11. ``DownhillGLSFitter.fit_toas`` from the flagship par moved by F0
   +2e-10 Hz, DM +1e-3 and EPS1 +1e-7, gated as in phase 6 against the
   same fit through the twins on the card;
12. the 3x3 (M2, SINI) ``grid_chisq`` with the GLS statistic, every point
   finite and within 1e-10 relative of the twin path;
13. kernel times at the flagship shapes, and the warm wall and busy share
   of one flagship fit + grid, as in phase 8.

Then the port's own TOA prepare under the analytic ephemeris
(``PINT_TPU_NBODY=0`` for phases 15-17, set around them):

14. K4 ``site_geometry`` and K5 ``analytic_ephemeris`` against their twins
   at N = 131,072 epochs (1995-2035, GBT, polar motion of ~0.3 arcsec; K5
   for the prepare's bodies and for every body it serves): K4 position
   within 1e-6 m and velocity within 1e-9 m/s, K5 within 1 mm and 1e-4 m/s;
15. ``get_TOAs`` of a .tim of 131,072 synthetic flagship-shaped lines (GBT,
   two receivers, 2003-2033) through the kernels and through the twins on
   the card: columns within those bounds (TDB within 1 ps), and the wall of
   each stage (parse, clock, tdb, eop, geometry, ephemeris);
16. ``get_model_and_toas`` of the flagship par and
   ``pint_tpu_torch/data/flagship_n16384.tim`` and ``build_tensor`` (K4 and
   K5 twice each: the TOAs and the TZR row): t within 5 ps of the archive's
   (the tim's 16 decimals of a day), masks and ECORR columns exact,
   positions within 1 mm plus the archive's recorded geometry staleness
   (``geom_stale_s``: pint_tpu's fake-TOA iteration moved its times by up to
   4.1 us without recomputing its positions, ~0.12 m at 30 km/s);
17. the GLS fit and (M2, SINI) grid from those TOAs, gated as in phases
   11-12 against the same path through the twins (prepare included); and
   against phase 11's fit from the archive: params within 1e-3 sigma of a
   fit of the archive whose frequencies are the tim's (written with six
   decimals, up to 4.3e-7 MHz from the archive's; that rounding alone moves
   DM by ~1e-3 sigma, printed apart).

Then pint_tpu's default ephemeris, the N-body window (no ``PINT_TPU_NBODY``
setting, the window and pack caches in a temporary directory):

18. the flagship's 12-year window (t0 0.15 jcent, 8,767 half-day samples of
   10 bodies) built on the host and timed, and its Chebyshev pack snapshot
   (11 bodies, 14 coefficients); K6 ``nbody_serve`` against its twin at
   N = 131,072 epochs over the window (a quarter on grid nodes, both ends),
   all 10 bodies, and the EMB formed after it; K7 ``chebyshev_eval`` against
   its twin on that pack and on the pack of ``tests/data/mini_de.bsp`` (every
   record edge, both ends): within 1e-6 m and 1e-9 m/s (bitwise expected:
   the twins sum in the kernels' order), and K7 on the mini kernel within
   1 mm and 1e-7 m/s of the host SPK reader;
19. ``get_model_and_toas`` of the flagship par and
   ``pint_tpu_torch/data/flagship_n16384_nbody.tim`` (the same dataset
   simulated under the N-body window) and ``build_tensor``: K6 and K4
   launched twice (the TOAs and the TZR row), K5 and K7 not at all, the
   window of phase 18 served (built once); columns within phase 16's bounds
   of the same path through the twins;
20. the GLS fit and (M2, SINI) grid from those TOAs, gated as in phases
   11-12 against the twin path (chi^2/dof in [0.8, 1.2]);
21. ``PINT_TPU_KERNEL_EPHEM=1``: the same prepare served from phase 18's pack
   by K7 (launched twice, K6 not at all), within phase 16's bounds of its twin
   path; the Earth within 10 m and 1e-3 m/s of phase 19's and the fit within
   0.1 sigma of phase 20's (a Chebyshev record cannot follow the window's C1
   Hermite serve closer: pint_tpu's own snapshot of this window is 5.88 m
   and 5.4e-4 m/s from its direct serve, and moves its own fit by 0.060
   sigma, on the CPU: the slow test ``tests/test_torch_kernel_ephem.py::
   test_pint_tpu_snapshot_of_the_flagship_window`` holds it to these limits);
22. ``PINT_TPU_EPHEM`` set to an SPK kernel that ``spk_write.export_spk``
   writes from the window over MJD 56600-57400: the same prepare through
   ``KernelEphemeris``, K7 on the kernel's raw records, gated as phase 21.

Then eccentric binaries, ``profiles.DD_SMOKE_PAR`` (BINARY DD, 10 free
parameters) over ``pint_tpu_torch/data/dd_n16384.tim`` (``PINT_TPU_NBODY=0``
set around phases 23-26):

23. K1's Kepler instance against its twin on the .tim prepared by the port:
   DD at the fit's shape (1 set, 10 lanes) and the grid's (9 (M2, SINI)
   sets, 10 lanes), and at 1 set with every lane the Kepler term has, for
   DD, BT and DDS (the same orbit): phase 9's bounds;
24. ``get_model_and_toas`` + ``build_tensor`` of the DD par and .tim (K4 and
   K5 twice each), then ``DownhillWLSFitter.fit_toas`` from a moved start (F0
   +2e-10 Hz and pint_tpu's tests/test_binary.py perturbations: PB +1e-7 s,
   A1 +2e-6 ls, T0 +2e-2 s, ECC +1e-6, OM +2e-6 rad), gated as phase 6
   against the same prepare and fit through the twins;
25. the 3x3 (M2, SINI) ``grid_chisq`` with the WLS statistic (K1 + K2), per
   point within 1e-10 relative of the same grid through the twins from the
   same fitted model, its minimum at the centre (the truth of the
   simulation), and within 1e-9 relative of the twin path's grid from its
   own fit (fits an ulp apart give grids ~1e-10 apart: one ulp of the
   fitted RAJ moves the grid by ~2e-10, printed); K2 against its twin at
   the grid's first step (B = 9, p = 10) as in phase 5;
26. K1's Kepler instance times at both shapes, K2's at p = 10, and the
   warm wall and busy share of one DD fit + grid, as in phase 8.

Then a NANOGrav-shaped par, ``profiles.NANOGRAV_SMOKE_PAR`` (ecliptic
astrometry, 64 DMX windows, a JUMP, FD1-3, ELL1, EFAC/EQUAD/ECORR and
power-law red noise; 80 free parameters, 2,048 ECORR epochs, 60 Fourier
columns) over ``pint_tpu_torch/data/nanograv_n16384.tim``
(``PINT_TPU_NBODY=0`` set around phases 27-33; its prepare runs first):

27. K1's NANOGrav instance against its twin at the GLS fit's shape (1 set,
   all 80 lanes: pint_tpu's GLS step takes the tangent of every free
   parameter, DMX, FD and the JUMP included) and the grid's (9 sets, 12
   lanes): phase 9's bounds;
28. K8 ``linear_columns`` against its twin: the grid's 68 closed-form
   columns (64 DMX, 3 FD, the JUMP) of 9 sets, and the Fourier bases of the
   fit (60 columns) and of the DM-noise variant (120), within 1e-13;
29. K3 with the dense basis against its twin: the fit's step (B = 1, p =
   80, kd = 60), the grid's first step (B = 9), both chi^2 calls (p = 0)
   and the DM-noise variant's step (kd = 120), within 1e-12 relative and
   bitwise repeatable;
30. the prepare (K4 and K5 twice each) against the twins' prepare;
31. ``DownhillGLSFitter.fit_toas`` from a moved start (F0 +2e-10 Hz, EPS1
   +1e-7, DMX_0001 +1e-4, JUMP1 +1e-6 s, FD1 +1e-6 s) against the twin path,
   gated as phase 11, except that a parameter and its uncertainty may sit
   from the twin's fit ten times as far as the twin path's own fit moves
   when its normal matrices change by 1e-15 of their diagonals (the
   norm-scaled rounding of a sum run in another order), where that is more
   than 1e-10 relative (DMX, FD and the JUMP are nearly degenerate over two
   receivers: normal matrices that differ by ~1e-15 give fits ~1e-10 sigma
   apart);
32. the 3x3 (M2, SINI) grid against the twins' grid from the same fitted
   model, within 1e-10 or ten times the grid's own movement when its
   refits' normal matrices change by 1e-15 of their diagonals, and within
   1e-8 of the twin path's grid from its own fit;
33. K1, K8 and K3 times at the fit's and the grid's shapes, and the warm
   wall and busy share of one fit + grid.

Then the rest of pint_tpu's binaries (``PINT_TPU_NBODY=0`` set around
phases 34-39), each prepared by ``get_model_and_toas`` + ``build_tensor``:
``profiles.DDGR_SMOKE_PAR`` over ``pint_tpu_torch/data/ddgr_n16384.tim``,
``profiles.DDK_SMOKE_PAR`` over ``ddk_n16384.tim``, and the flagship's orbit
under ELL1H (stigma, h4 and h3 modes), ELL1K and the FB form over
``flagship_n16384.tim``:

34. K1 against its twin for each form: every lane the model has, at one
   parameter set, on the model without its TZR row (values bitwise,
   tangents within 1e-15 relative); and the fit's (1 set) and grid's (9
   sets) shapes with it (values bitwise, tangents within 2e-15: the TZR
   row's subtraction leaves each lane's rounding on what is left);
35. DDGR: the prepare against the twins' (K4 and K5 twice each),
   ``DownhillWLSFitter.fit_toas`` from phase 24's moved start (11 free:
   MTOT and M2 among them) against the twin path, gated as phase 6, and
   the 3x3 (MTOT, M2) grid (K1 + K2, 9 refitted), within 1e-10 or ten
   times its movement when its refits' normal matrices change by 1e-15 of
   their diagonals of the twins' grid from the same fit, and within 1e-9
   (or that movement) of the twin path's grid from its own fit;
36. DDK the same (14 free: KIN and KOM among them; F0 +2e-10 Hz, PB +1e-7
   s, A1 +2e-6 ls, KIN and KOM +1e-4 rad), the (KIN, KOM) grid refitting
   12; its T0 and OM are nearly degenerate (ECC 7.5e-5), so the fit takes
   phase 31's witness rule (the twin path's fit through design columns moved by
   1e-15 of their scale);
37. ELL1H in its stigma mode: ``DownhillGLSFitter.fit_toas`` (16 free, H3
   and STIGMA among them) from phase 11's moved start and the (H3, STIGMA)
   GLS grid, gated as phases 11-12 and 35;
38. ELL1K (OMDOT and LNEDOT free) and the FB form (FB0 and FB1 free): a GLS
   fit each and the (M2, SINI) grid, gated the same;
39. K1's times at each form's fit and grid shapes.

Then wideband TOAs, ``profiles.WIDEBAND_SMOKE_PAR`` (the NANOGrav-shaped par
without ECORR, with a DMJUMP on the 800 MHz receiver and DMEFAC/DMEQUAD on
both; 81 free parameters, 60 Fourier columns) over
``pint_tpu_torch/data/wideband_n16384.tim`` (one TOA per epoch, each with a
-pp_dm/-pp_dme DM measurement; ``PINT_TPU_NBODY=0`` set around phases
40-44; its prepare runs first):

40. K8's DM-row pass (``design.dm_rows``) against its twin, bitwise: the
   fit's 81 columns, the chi^2 call's none, and the combined design's
   unweighted rows;
41. K3 at the stacked [TOA; DM] shape (N = 32,768 rows, the DM rows
   whitened with weight 1, the noise basis zero on them): the fit's step (p
   = 81, weighted norms, no centring) and the chi^2 call, within 1e-12
   relative of the twin and bitwise repeatable;
42. the prepare (K4 and K5 twice each) against the twins' prepare, ``wb_dm``
   and ``wb_dme`` equal;
43. ``fit_auto`` picks ``WidebandDownhillFitter``; its ``fit_toas`` from
   phase 31's moved start (DMJUMP1 starts at 0) against the twin path, gated
   as phase 31 (with its witness rule where a witness shows it is needed),
   DMJUMP1 within 4 sigma of the truth in the .tim's recipe, and the combined
   design (``designmatrix``) within 1e-10 relative per column of the twins';
44. the DM-row pass's, K3's and K1's times at the fit's shapes, and the warm
   wall and busy share of one wideband fit.

Then the single-pulsar noise likelihood on phase 31's NANOGrav fit:
``fitting.NoiseLikelihood`` (N = 16,384, p_lin = 81: the 80 free parameters'
K1 tangents and the profiled offset, 2,048 ECORR epochs, 60 Fourier columns, 8
hyperparameters), built once (K1, K8's Fourier pass):

45. K3's per-set-weight mode (``woodbury.ecorr_normal_eq_sets``: one design,
   E sets of weights and prior variances) against its twin at E = 1, 8 and
   256: every output within 1e-12 relative per set and bitwise repeatable; at
   E = 1 bitwise equal to the shared-weight mode's call on the same inputs,
   and phase 29's shared-weight calls run again bitwise equal to their first
   results;
46. K9 ``noise_grad`` (the likelihood's backward, d lnL / d w and d lnL / d
   phi) against its twin on the kernel forward's state, marginalized and
   profiled, at E = 1 and 8: within 1e-12 of each set's largest entry,
   bitwise repeatable;
47. ``loglike`` at 5 points, ``loglike_many`` at 256 and ``grad`` at 2
   against the same likelihood through the twins on the card: the design
   within 1e-10 relative per column, the likelihoods within 1e-8 relative,
   the gradient within 1e-8 of its largest entry;
48. ``optimize()`` (8 Adam restarts, 200 steps) from noise values moved off
   the truth (`NOISE_START`), against the twin path: the ln posterior above
   the start's and within 1e-8 relative, eta_hat within 1e-6 prior scales;
   the DM-noise variant (120 Fourier columns, 10 hyperparameters) through
   phases 47-48 once;
49. K3's per-set mode at E = 1, 8, 256 and K9 at E = 1, 8: times; the warm
   walls of loglike, grad, loglike_many (256) and optimize; the busy share of
   grad and of optimize.

Then the joint likelihood of a pulsar timing array (``PINT_TPU_NBODY=0`` set
around phases 50-56): ``profiles.pta_smoke_array(64, 8192, seed=29)``, array A
(64 pulsars of ``PTA_PAR_TEMPLATE``: RAJ, DECJ, F0, F1 and DM free, EFAC, red
noise with 5 frequencies, the common background with 6; 524,288 TOAs; p_lin 6,
m 12, kd 10, 194 hyperparameters):

50. array A simulated on the card by the port's ``simulation.py`` (fake TOAs
   lying on each model within 1 ns, each pulsar's white and red noise, one
   Hellings-Downs correlated background), the walls of the simulation, the
   member designs (64 ``NoiseLikelihood``: K1, K8) and ``PTALikelihood``'s
   build (K8's Fourier pass on the array's span); the ORF positive definite;
51. K3's stacked mode (``woodbury.ecorr_normal_eq_stacked``: the E x 64
   (point, pulsar) sets' Grams over [Mn, G, r]) against its twin at E = 1, 8
   and 256: every output within 1e-12 relative per set, bitwise repeatable;
   phase 45's per-set calls and phase 29's shared-weight calls run again,
   bitwise equal to their first results;
52. K10 ``pta_grad`` (the blocks' backward) against its twin on the kernel
   forward's state under the coupling's own cotangent, at E = 1 and 8: within
   1e-12 of each set's largest entry, bitwise repeatable;
53. ``PTALikelihood`` on array A (noise values moved off the truth,
   ``PTA_START``) against the same likelihood through the twins (the
   members' K1 designs shared, pulsar 0's held to its twin within 1e-10 per
   column; G, the blocks and the backward through the twins): loglike at 3
   points, loglike_curn, detection_statistic (ll_hd, ll_curn within 1e-8
   relative, rho and the optimal statistic within 1e-8), gwb_coefficient_blocks
   (1e-10), loglike_many at 256 points (1e-8) and grad at 2 points (1e-8 of the
   largest entry); optimize (8 restarts, 200 steps) with phase 48's gates;
54. arrays B (8 pulsars of tests/test_pta.py's par, EFAC/EQUAD/ECORR, at 8,192
   TOAs in 4,096 ECORR epochs) and C (8 pulsars without ECORR at 6,144-8,192
   TOAs: pad rows in buckets of 8,192): phases 51-53's checks at E = 1 and 8
   (loglike_many at 8 points, no optimize);
55. array D (4 pulsars of 1,024 TOAs): the fused loglike within 1e-8 relative
   of ``dense_joint_program`` (the (4 x 1,024)-square covariance factored by
   ``torch.linalg.cholesky``), both walls;
56. K3's stacked mode at E = 1, 8, 256 and K10 at E = 1, 8: times; the warm
   walls of loglike, grad, loglike_many (256) and optimize (phase 53's, 200
   steps) on array A; the busy share of grad and of a 20-step optimize.

Last, the .tim pulse-number offsets and TRACK -2 (ROADMAP C11,
``PINT_TPU_NBODY=0`` set around it):

57. two .tim files of 16,384 SMOKE_PAR TOAs simulated on the card, with a
   PHASE command, -padd, -phase and -pn flags, through ``get_model_and_toas``:
   K1 with the tensor's ``delta_pn`` and ``track_pn`` bitwise against its
   twin without the TZR row (and within 1 ps, pulse numbers equal, with it),
   under TRACK -2 and nearest; the tracked pulse numbers are the flags; the
   downhill WLS fit under TRACK -2 from phase 6's moved start, gated as phase
   6 against the twin path.

Last, the backward kernels on random inputs:

58. K9 and K10 against their twins on inputs drawn from a seed
   (`K9_SWEEP`, `K10_SWEEP`: E = 3, p = 0, kd = 0, ke = 0, rows that are not a
   multiple of a tile, pad rows, kd = 120, and widths that run each of the
   kernels' 3-, 6- and 12-tile instances) under phase 46's and 52's gates,
   bitwise across two calls.

Phase 2 also prints K3's Gram as built: the DMMA (float64 tensor-core)
instructions in its library's SASS (``cuobjdump -sass``; none fails the run)
and each gram_pass instance's registers and spills, which every K3 record
repeats; and the same of K9's and K10's libraries (their three passes'
registers and spills; no DMMA fails the run). Their records carry each
pass's device ms (each call profiled alone), the call by CUDA events behind
a busy queue, the factor pass's share, the twin's torch.linalg factors by
CUDA events, and the rows pass's ms at E = 8 over 8 times its ms at E = 1.

The launch counters are zeroed just before each ``fit_toas`` and read just
after it, then zeroed and read again around each ``grid_chisq`` (the
fitter and its start shift are built outside the windows; the twin runs do
not count), and around each ``get_model_and_toas`` + ``build_tensor`` of
phases 16, 19, 21, 22 and 24 and each fit of phases 21, 22 and 57 (which must
launch K1).
The SMOKE fit must launch K0 and K1, its grid K1 and K2; the flagship fit
K0, K1 and K3, its grid K0, K1 and K3; the analytic prepare K4 and K5 twice
each; the default prepare K4 and K6 twice each, the pack and SPK prepares K4
and K7 twice each; the DD prepare K4 and K5 twice each, its fit K0 and K1,
its grid K1 and K2; the NANOGrav prepare K4 and K5 twice each, its fit K0,
K1, K3 and K8's Fourier pass, its grid K1, K8's two passes and K3; the
slice-7 prepares K4 and K5 twice each, their fits K0 and K1 (and K3 for
GLS), the DDGR and DDK grids K1 and K2, the others K1, K8 and K3; the
wideband prepare K4 and K5 twice each, its fit K0, K1, K8's Fourier and DM-row
passes and K3 (the wideband fit has no grid); the noise likelihood's build K1 and
K8's Fourier pass, its loglike and loglike_many K3's per-set mode, its grad and
optimize (each variant's) K3's per-set mode and K9; the PTA array's
simulation K1, K4, K5 and K8's Fourier pass, each PTA likelihood's loglike and
loglike_many K3's stacked mode, its grad and optimize K3's stacked mode and
K10.
K2's and K3's counts are of calls; K2 runs 2 or 3 kernel passes (counted apart), K3 4 to 8
(its per-set and stacked modes 5 to 9), K9 and K10 3. At the
shapes of the main path, ``ms`` is a kernel's
device time per call from torch.profiler (``plain_ms``, ``library_ms``: all
the kernels the twin or the library call runs; where the profiler reads no
device time of such a call, CUDA events around calls queued behind a spin
kernel, so that the host's enqueue is not timed), and ``call_ms`` the
CUDA-event time per call, which includes the host's time to enqueue it.
K3's records take ``ms`` and ``library_ms`` as medians of K3_ROUNDS rounds
measured in turn, with their spreads, and time each call once more by CUDA
events behind a spin kernel (``queued_ms``, ``library_queued_ms``): late in
a run the profiler has read less than those for some calls.
``bound_ms`` is the larger of the bytes the function must move over
3.35 TB/s and its float64 operations over their peak rate: 67 TFLOP/s for
the multiply-adds of K2's and K3's Grams, a matrix product the tensor cores
can do, 34 TFLOP/s for the rest (H100 SXM, NVIDIA data sheet). The output ends with the
``kernels`` record (with each library's ptxas registers and spills), the
card's name and power limit, and the result line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# float64 on the tensor cores (DMMA), the rate of the Grams' multiply-adds
FP64_MMA_OPS_PER_S = 67e12
START_SHIFT = {"F0": 2e-10, "DM": 1e-3}
FLAGSHIP_SHIFT = {"F0": 2e-10, "DM": 1e-3, "EPS1": 1e-7}
# pint_tpu's tests/test_binary.py DD perturbations (apply_delta's units:
# seconds, light-seconds, radians)
DD_SHIFT = {"F0": 2e-10, "PB": 1e-7, "A1": 2e-6, "T0": 2e-2, "ECC": 1e-6, "OM": 2e-6}
NANOGRAV_SHIFT = {"F0": 2e-10, "EPS1": 1e-7, "DMX_0001": 1e-4, "JUMP1": 1e-6, "FD1": 1e-6}
# DDK's: the orientation moved by ~3e-2 and ~2e-3 sigma, T0 left alone (with
# ECC 7.5e-5 it is nearly degenerate with OM)
DDK_SHIFT = {"F0": 2e-10, "PB": 1e-7, "A1": 2e-6, "KIN": 1e-4, "KOM": 1e-4}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def bound_ms(n_bytes: float, n_ops: float, n_mma_ops: float = 0.0) -> tuple[float, str]:
    """The least time of a function, in ms, and what bounds it: its bytes
    over the memory rate, or its float64 operations, each type over its peak
    rate (`n_mma_ops`: the multiply-adds of a matrix product, which the
    tensor cores can do)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP64_OPS_PER_S + n_mma_ops / FP64_MMA_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def timed_ms(fn, device, reps: int) -> float:
    """Mean milliseconds of one call: CUDA events around `reps` calls after
    a warm-up call (host clock with a final synchronize on the CPU)."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profiler passes per measurement: a pass can, rarely, deliver no CUDA
# activity of a short window (seen once on K6 at 131,072 rows)
PROFILE_ATTEMPTS = 3


def measure(fn, device, reps: int, kernel: str | None = None) -> tuple:
    """(device ms, call ms) of one call of `fn`. Device ms is the summed time
    of the kernels the call runs, from torch.profiler's CUDA activity (only
    kernels whose name holds `kernel`, or one of a tuple of names, when
    given); call ms is `timed_ms`,
    which includes the host's time to enqueue the call and bounds the rate of
    back-to-back calls. On the CPU the device time is None. A named kernel
    missing from the CUDA activity the profiler delivers fails the run; a
    call whose device time it does not see (library or twin kernels, or a
    profile that delivered no CUDA activity in `PROFILE_ATTEMPTS` passes) is
    timed by `queued_ms`."""
    call = timed_ms(fn, device, reps)
    if device.type != "cuda":
        return None, call
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pats = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = [e for e in events if pats is None or any(p in e.key for p in pats)]
        us = sum(e.self_device_time_total for e in seen)
        if us > 0:
            return us / 1e3 / reps, call
    if pats is not None and events:
        raise SmokeFailure(f"the profiler saw no device time of kernel {pats} "
                           f"(events: {[e.key for e in events]})")
    queued = queued_ms(fn, reps)
    print(f"  the profiler read no device time of a call ({len(seen)} kernel events of "
          f"{len(events)}, {PROFILE_ATTEMPTS} tries); timed behind a busy queue: {queued:.4g} ms")
    return queued, call


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds of one call, without the profiler: the card is
    held by a spin kernel while the host enqueues `reps` calls between two
    CUDA events, so the events time the calls' kernels back to back, with
    no wait on the host's enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of clock cycles, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def by_kernel(call, reps: int, pattern) -> list:
    """[(pass, device ms, profiles)] of one call's kernels whose names hold
    `pattern` (one string or a tuple of them), in launch order (the order
    of the profile that saw the most of them): `reps` calls, each profiled
    alone, and for each pass the median over the profiles that saw it and
    their number (a profile may miss a kernel). A kernel launched twice in
    a call is two passes."""
    import re
    import statistics
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and named(e.name, pattern)), key=lambda e: e.time_range.start)
        run = [(re.search(r"\w+(<[\w, ]+>)?(?=\()", e.name).group(0),
                e.time_range.elapsed_us() / 1e3) for e in events]
        if run:
            runs.append(run)
    if not runs:
        raise SmokeFailure(f"the profiler saw no kernel {pattern} in {reps} calls")
    seen: dict = {}
    for run in sorted(runs, key=len, reverse=True):
        nth = Counter()
        for name, ms in run:
            seen.setdefault((name, nth[name]), []).append(ms)
            nth[name] += 1
    return [(name, statistics.median(v), len(v)) for (name, _), v in seen.items()]


def named(name: str, pats) -> bool:
    """Whether a kernel's profile name holds the pattern `pats` (one string
    or a tuple of them)."""
    return any(p in name for p in ((pats,) if isinstance(pats, str) else pats))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (0 when both are all zero)."""
    import torch

    scale = float(torch.max(torch.abs(want))) if want.numel() else 0.0
    diff = float(torch.max(torch.abs(got - want))) if want.numel() else 0.0
    return diff / scale if scale else diff


@contextlib.contextmanager
def twins():
    """Route the main path through the plain-torch twins, on the card."""
    from pint_tpu_torch import gridutils, residuals
    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.fitting import design, gls, noise_like, pta_like, wideband, wls, woodbury
    from pint_tpu_torch.models import noise
    from pint_tpu_torch.ops import dd

    saved = (residuals.resid_tangent, wls.dd_elementwise, gridutils.normal_eq,
             gls.ecorr_normal_eq, gridutils.ecorr_normal_eq, dp.site_geometry,
             dp.analytic_ephemeris, dp.nbody_serve, dp.chebyshev_eval, wls.linear_columns,
             gridutils.linear_columns, design.fourier_basis, design.dm_rows, wideband.dm_rows,
             wideband.ecorr_normal_eq, noise_like.ecorr_normal_eq_sets, noise_like.noise_grad,
             pta_like.ecorr_normal_eq_stacked, pta_like.pta_grad)
    residuals.resid_tangent = residuals.resid_tangent_plain
    # K8's twin forms f_bary itself: the kernel's fb argument is dropped
    wls.linear_columns = gridutils.linear_columns = \
        lambda *args: design.linear_columns_plain(*args[:7])
    design.fourier_basis = noise.fourier_basis_plain
    wls.dd_elementwise = dd.dd_elementwise_plain
    gridutils.normal_eq = gridutils.normal_eq_plain
    gls.ecorr_normal_eq = gridutils.ecorr_normal_eq = woodbury.ecorr_normal_eq_plain
    wideband.ecorr_normal_eq = woodbury.ecorr_normal_eq_plain
    design.dm_rows = wideband.dm_rows = design.dm_rows_plain
    dp.site_geometry, dp.analytic_ephemeris = dp.site_geometry_plain, dp.analytic_ephemeris_plain
    dp.nbody_serve, dp.chebyshev_eval = dp.nbody_serve_plain, dp.chebyshev_eval_plain
    noise_like.ecorr_normal_eq_sets = woodbury.ecorr_normal_eq_sets_plain
    noise_like.noise_grad = noise_like.noise_grad_plain
    pta_like.ecorr_normal_eq_stacked = woodbury.ecorr_normal_eq_stacked_plain
    pta_like.pta_grad = pta_like.pta_grad_plain
    try:
        yield
    finally:
        (residuals.resid_tangent, wls.dd_elementwise, gridutils.normal_eq,
         gls.ecorr_normal_eq, gridutils.ecorr_normal_eq, dp.site_geometry,
         dp.analytic_ephemeris, dp.nbody_serve, dp.chebyshev_eval, wls.linear_columns,
         gridutils.linear_columns, design.fourier_basis, design.dm_rows, wideband.dm_rows,
         wideband.ecorr_normal_eq, noise_like.ecorr_normal_eq_sets, noise_like.noise_grad,
         pta_like.ecorr_normal_eq_stacked, pta_like.pta_grad) = saved


@contextlib.contextmanager
def knobs(**settings):
    """Set (a string) or unset (None) environment settings for a block, and
    restore them after it."""
    saved = {k: os.environ.get(k) for k in settings}
    for k, v in settings.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- phase 3: K0 ------------------------------------------------------------------


def dd_inputs(n: int, seed: int, device):
    """Normalized dd pairs: random magnitudes 1e-140..1e15 of both signs, and
    y built to cancel x (y ~ -x with a perturbed low word) on a third of
    the rows; rint inputs are ~1e11-turn phases with exact halves."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-140, 15, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    lo = mag * rng.uniform(-1, 1, (2, n)) * 2.0**-54
    hi = mag.copy()
    third = n // 3
    hi[1, :third] = -hi[0, :third]
    lo[1, :third] = -lo[0, :third] * (1 + rng.uniform(-1e-3, 1e-3, third))
    s = hi + lo
    lo = (hi - s) + lo  # renormalize: |lo| <= ulp(hi)/2
    hi = s
    ph = rng.uniform(-2e11, 2e11, n)
    ph[: n // 4] = np.round(ph[: n // 4]) + 0.5
    ph_lo = rng.uniform(-1, 1, n) * 2.0**-60 * np.abs(ph)
    ph_lo[: n // 8] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return t(hi[0]), t(lo[0]), t(hi[1]), t(lo[1]), t(ph), t(ph_lo)


def phase_k0(device, n: int = 1 << 20) -> None:
    """Every op on `n` inputs, then on the (2,) shape of the fit's parameter
    update (F0 and F1; the grid's refitted parameters are plain float64)."""
    import torch

    from pint_tpu_torch.ops.dd import DD, _K0_OPS, dd_elementwise, dd_elementwise_plain

    for shape in ((n,), (2,)):
        xh, xl, yh, yl, ph, phl = (t.reshape(shape)
                                   for t in dd_inputs(math.prod(shape), 7, device))
        x, y = DD(xh, xl), DD(yh, yl)
        for op in _K0_OPS:
            if op == "rint":
                args = (DD(ph, phl), None)
            elif op in ("add_fp", "mul_fp"):
                args = (x, yh)
            else:
                args = (x, y)
            got, want = dd_elementwise(op, *args), dd_elementwise_plain(op, *args)
            if op == "rint":
                got, want = (got[0], *got[1]), (want[0], *want[1])
            sync(device)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            check(same, f"K0 {op} bitwise equal to the twin on {shape} inputs")


# --- phases 4-5: K1, K2 ------------------------------------------------------------


def grid_params(model, ftr):
    """The batched parameter dict of the model's 3x3 grid (``grid_for``: the
    spin grid for SMOKE_PAR, (M2, SINI) for the flagship)."""
    import numpy as np
    import torch

    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.profiles import grid_for

    names, vals = grid_for(model, ftr)
    pts = np.stack([g.ravel() for g in np.meshgrid(*vals)], axis=1)
    B = pts.shape[0]
    params = {k: (DD(v.hi.expand(B).clone(), v.lo.expand(B).clone()) if isinstance(v, DD)
                  else v.expand(B).clone()) for k, v in model.params.items()}
    dev = model.params["F0"].hi.device
    for i, n in enumerate(names):
        col = torch.as_tensor(pts[:, i], dtype=torch.float64, device=dev)
        params[n] = DD(col, torch.zeros_like(col)) if isinstance(params[n], DD) else col
    return names, vals, params


def compare_k1(model, params, tensor, lanes, device, tan_tol: float, tag: str) -> dict:
    """K1 against its twin at one shape: time residuals within 1 ps, pulse
    numbers equal, f within 1e-15 relative, tangents within `tan_tol`
    relative (per lane, to the lane's largest value)."""
    import torch

    from pint_tpu_torch.residuals import resid_tangent, resid_tangent_plain

    got = resid_tangent(model, params, tensor, lanes)
    want = resid_tangent_plain(model, params, tensor, lanes)
    sync(device)
    dt = float(torch.max(torch.abs(got.frac / got.f - want.frac / want.f)))
    check(dt <= 1e-12, f"{tag}: time residuals within 1 ps of the twin ({dt:.3g} s)")
    check(torch.equal(got.pn, want.pn), f"{tag}: pulse numbers equal")
    check(rel_err(got.f, want.f) <= 1e-15, f"{tag}: f within 1e-15 relative")
    worst = max((max(rel_err(got.dfrac[:, j], want.dfrac[:, j]),
                     rel_err(got.df[:, j], want.df[:, j])) for j in range(len(lanes))),
                default=0.0)
    check(worst <= tan_tol, f"{tag}: tangents within {tan_tol:g} relative ({worst:.3g})")
    return {"max_abs_err": dt, "tangent_rel_err": worst}


def phase_k1(model, tensor, params_b, fit_lanes, grid_lanes, device, tan_tol: float,
             label: str = "") -> dict:
    return {shape: compare_k1(model, params, tensor, lanes, device, tan_tol,
                              f"K1 {label}{shape} ({len(lanes)} lanes)")
            for shape, params, lanes in (("fit", model.params, fit_lanes),
                                         ("grid", params_b, grid_lanes))}


def phase_k2(model, tensor, params_b, free, w, device):
    import torch

    from pint_tpu_torch.gridutils import _RIDGE, _time_resids_design, normal_eq, normal_eq_plain

    r, M = _time_resids_design(model, params_b, tensor, free)
    got = normal_eq(r, M, w, _RIDGE, True)
    want = normal_eq_plain(r, M, w, _RIDGE, True)
    sync(device)
    errs = {}
    for name, g, wv in zip(("G", "c", "chi2", "norm"), got, want):
        errs[name] = max(rel_err(g[b], wv[b]) for b in range(r.shape[0]))
        check(errs[name] <= 1e-12, f"K2 {name} within 1e-12 relative per point ({errs[name]:.3g})")
    chi_abs = float(torch.max(torch.abs(got[2] - want[2])))
    return r, M, chi_abs


# --- phases 6-7: the main path -------------------------------------------------------


def fresh_fitter(tensor, device, which: str = "smoke", par: str | None = None):
    """A fitter on `tensor`, its model moved off the solution by the start
    shift: DownhillWLSFitter on SMOKE_PAR ("smoke"), DD_SMOKE_PAR ("dd"),
    DDGR_SMOKE_PAR ("ddgr") or DDK_SMOKE_PAR ("ddk"), or DownhillGLSFitter
    on the flagship par ("flagship"), NANOGRAV_SMOKE_PAR ("nanograv"), or the
    flagship's orbit under ELL1H in its stigma mode ("ell1h"), ELL1K
    ("ell1k") or in the FB form ("fb"), or the WidebandDownhillFitter that
    ``fit_auto`` picks for WIDEBAND_SMOKE_PAR ("wideband"); `par` (text) in
    place of that par."""
    import torch

    from pint_tpu_torch.fitting import (DownhillGLSFitter, DownhillWLSFitter,
                                        WidebandDownhillFitter)
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch import profiles as pr
    from pint_tpu_torch.profiles import (DD_SMOKE_PAR, FLAGSHIP_SMOKE_PAR, NANOGRAV_SMOKE_PAR,
                                         SMOKE_PAR)

    default, cls, shift = {
        "smoke": (SMOKE_PAR, DownhillWLSFitter, START_SHIFT),
        "flagship": (FLAGSHIP_SMOKE_PAR, DownhillGLSFitter, FLAGSHIP_SHIFT),
        "dd": (DD_SMOKE_PAR, DownhillWLSFitter, DD_SHIFT),
        "nanograv": (NANOGRAV_SMOKE_PAR, DownhillGLSFitter, NANOGRAV_SHIFT),
        "ddgr": (pr.DDGR_SMOKE_PAR, DownhillWLSFitter, DD_SHIFT),
        "ddk": (pr.DDK_SMOKE_PAR, DownhillWLSFitter, DDK_SHIFT),
        "ell1h": (pr.ell1h_smoke_par("stigma"), DownhillGLSFitter, FLAGSHIP_SHIFT),
        "ell1k": (pr.ELL1K_SMOKE_PAR, DownhillGLSFitter, FLAGSHIP_SHIFT),
        "fb": (pr.fb_smoke_par(), DownhillGLSFitter, FLAGSHIP_SHIFT),
        "wideband": (pr.WIDEBAND_SMOKE_PAR, WidebandDownhillFitter, NANOGRAV_SHIFT),
    }[which]
    model = get_model(par or default, from_text=True, device=device)
    free = tuple(model.free_params)
    delta = torch.tensor([shift.get(n, 0.0) for n in free], dtype=torch.float64,
                         device=device)
    model.params = apply_delta(model.params, free, delta)
    return cls(tensor, model)


def counters():
    from pint_tpu_torch.astro.device_prepare import (analytic_ephemeris, chebyshev_eval,
                                                     nbody_serve, site_geometry)
    from pint_tpu_torch.fitting.design import dm_rows, fourier_basis, linear_columns
    from pint_tpu_torch.fitting.noise_like import noise_grad
    from pint_tpu_torch.fitting.pta_like import pta_grad
    from pint_tpu_torch.fitting.woodbury import (ecorr_normal_eq, ecorr_normal_eq_sets,
                                                 ecorr_normal_eq_stacked)
    from pint_tpu_torch.gridutils import normal_eq
    from pint_tpu_torch.ops.dd import dd_elementwise
    from pint_tpu_torch.residuals import resid_tangent

    return {"dd_elementwise": dd_elementwise, "resid_tangent": resid_tangent,
            "normal_eq": normal_eq, "ecorr_normal_eq": ecorr_normal_eq,
            "site_geometry": site_geometry, "analytic_ephemeris": analytic_ephemeris,
            "nbody_serve": nbody_serve, "chebyshev_eval": chebyshev_eval,
            "linear_columns": linear_columns, "fourier_basis": fourier_basis,
            "dm_rows": dm_rows, "ecorr_normal_eq_sets": ecorr_normal_eq_sets,
            "noise_grad": noise_grad, "ecorr_normal_eq_stacked": ecorr_normal_eq_stacked,
            "pta_grad": pta_grad}


@contextlib.contextmanager
def counted(into: dict):
    """Zero every launch counter (and K2's pass counter), run the block, and
    store the counts in `into`."""
    from pint_tpu_torch.gridutils import normal_eq

    for fn in counters().values():
        fn.launches = 0
    normal_eq.passes = 0
    yield
    into.update({k: fn.launches for k, fn in counters().items()})
    into["normal_eq_passes"] = normal_eq.passes


def run_main_path(ftr, device, grid: bool = True) -> dict:
    """Fit `ftr` (a fitter built beforehand), then (with `grid`) the model's
    3x3 grid around the fit (``grid_for``). Each of the two is timed on the
    host clock, ending in a synchronize, and its launch counts are read from
    a window of its own."""
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import grid_for

    out = {"fitter": ftr, "fit_launches": {}, "grid_launches": {}}
    with counted(out["fit_launches"]):
        t0 = time.perf_counter()
        ftr.fit_toas()
        sync(device)
        out["fit_s"] = time.perf_counter() - t0
    if not grid:
        out["grid_s"] = 0.0
        return out
    names, vals = grid_for(ftr.model, ftr)
    with counted(out["grid_launches"]):
        t0 = time.perf_counter()
        out["chi2"] = grid_chisq(ftr, names, vals)
        sync(device)
        out["grid_s"] = time.perf_counter() - t0
    return out


def fit_bounds(ref, moved) -> tuple[dict, dict]:
    """Per parameter of the fitter `ref`: how far another fit may sit from
    it, absolute, and its uncertainty, relative: 1e-10 of the value (of
    the uncertainty), or ten times the distance of `moved`, the same fit
    through normal matrices perturbed by 1e-15 of their diagonals
    (`perturbed_normal_eq`), where that is larger."""
    vals, unc = ref.values(), ref.result.uncertainties
    mv, mu = moved.values(), moved.result.uncertainties
    return ({n: max(1e-10 * abs(vals[n]), 10 * abs(mv[n] - vals[n])) for n in vals},
            {n: max(1e-10, 10 * abs(mu[n] - unc[n]) / unc[n]) for n in vals})


def check_fit(main: dict, twin: dict, label: str, moved=None) -> None:
    """The fit gates: converged, chi^2/dof in [0.8, 1.2], params within
    1e-10 relative and 1e-6 of their uncertainty of the twin path's fit,
    uncertainties within 1e-10 relative. With `moved` (the twin path's fit
    through perturbed normal matrices), a parameter and its uncertainty may
    instead sit within ten times that fit's distance from the twin's
    (`fit_bounds`): where the normal matrix is ill conditioned, the 1e-15
    that two paths' sums differ by moves the fit by that much."""
    ftr, ref = main["fitter"], twin["fitter"]
    res = ftr.result
    check(res.converged, f"{label} fit converged in {res.iterations} iterations")
    check(0.8 <= res.reduced_chi2 <= 1.2, f"{label} chi2/dof = {res.reduced_chi2:.6f} in [0.8, 1.2]")
    vals, ref_vals = ftr.values(), ref.values()
    ref_unc = ref.result.uncertainties
    worst_p = max(abs(vals[n] - ref_vals[n]) / abs(ref_vals[n]) for n in vals)
    worst_s = max(abs(vals[n] - ref_vals[n]) / ref_unc[n] for n in vals)
    worst_u = max(abs(res.uncertainties[n] - ref_unc[n]) / ref_unc[n] for n in vals)
    if moved is None:
        check(worst_p <= 1e-10, f"{label} fit params within 1e-10 relative of the twin fit "
                                f"({worst_p:.3g})")
        check(worst_u <= 1e-10, f"{label} uncertainties within 1e-10 relative ({worst_u:.3g})")
    else:
        tol_p, tol_u = fit_bounds(ref, moved["fitter"])
        s = ref.result.singular_values
        shift = max(abs(moved["fitter"].values()[n] - ref_vals[n]) / ref_unc[n] for n in vals)
        print(f"  {label}: the twin fit's normal matrix condition number "
              f"{float(s[0] / s[-1]):.4g}; a change of its normal matrices by 1e-15 of their "
              f"diagonals moves it by up to {shift:.3g} sigma; params at most {worst_p:.3g} "
              f"relative, {worst_s:.3g} sigma from the twin fit")
        over = [n for n in vals if abs(vals[n] - ref_vals[n]) > tol_p[n]]
        check(not over, f"{label} fit params within 1e-10 relative or 10x the perturbed "
                        f"fit's distance of the twin fit (over: {over})")
        over = [n for n in vals if abs(res.uncertainties[n] - ref_unc[n]) > tol_u[n] * ref_unc[n]]
        check(not over, f"{label} uncertainties within 1e-10 relative or 10x the perturbed "
                        f"fit's ({worst_u:.3g}; over: {over})")
    check(worst_s <= 1e-6, f"{label} fit params within 1e-6 of their uncertainty of the twin "
                           f"fit ({worst_s:.3g} sigma)")


def check_grid(main: dict, twin: dict, label: str) -> float:
    import numpy as np

    chi2, ref_chi2 = main["chi2"], twin["chi2"]
    check(chi2.shape == (3, 3) and bool(np.all(np.isfinite(chi2))), f"{label} grid chi2 finite, 3x3")
    worst_g = float(np.max(np.abs(chi2 - ref_chi2) / np.abs(ref_chi2)))
    check(worst_g <= 1e-10, f"{label} grid chi2 within 1e-10 relative of the twin path "
                            f"({worst_g:.3g})")
    return worst_g


def profile_main_path(tensor, device, which: str = "smoke", par: str | None = None,
                      grid: bool = True) -> dict:
    """The wall of one warm fit + grid (the fit alone without `grid`) without
    the profiler, then device time by kernel over one more under
    torch.profiler (CUDA activity only). `busy_share` is that summed kernel
    time over the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain = run_main_path(fresh_fitter(tensor, device, which, par), device, grid)
    wall = plain["fit_s"] + plain["grid_s"]
    ftr = fresh_fitter(tensor, device, which, par)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path(ftr, device, grid)
        profiled_wall = time.perf_counter() - t0
    kern = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(us for _, us, _ in kern) / 1e6
    return {"warm_fit_s": plain["fit_s"], "warm_grid_s": plain["grid_s"], "wall_s": wall,
            "warm_fit_launches": plain["fit_launches"],
            "warm_grid_launches": plain["grid_launches"],
            "profiled_wall_s": profiled_wall, "device_busy_s": busy, "busy_share": busy / wall,
            "kernel_s": {k: sum(us for name, us, _ in kern if named(name, pat)) / 1e6
                         for k, pat in KERNEL_PATTERNS.items()},
            "top": [[name[:70], us / 1e6, n] for name, us, n in sorted(kern, key=lambda r: -r[1])[:8]]}


# --- the kernels record ----------------------------------------------------------------

# substrings of the kernels' names in a profile (K2 and K3 are several passes;
# K3's Gram is a template, gram_pass<32> or gram_pass<64>)
K0_KERNEL, K2_KERNEL, K3_KERNEL = "dd_elementwise_kernel", "pass_", ("_pass(", "_pass<")
# K1's passes: the primal chain, the TZR row's lanes, the lanes (or, without
# a kernel lane, the pulse numbers and phases alone)
K1_KERNEL = ("resid_primal", "resid_tzr", "resid_lanes", "resid_finalize")
K4_KERNEL, K5_KERNELS = "site_geometry_kernel", ("analytic_ephemeris_kernel",
                                                 "central_difference_kernel")
K6_KERNEL, K7_KERNEL = "nbody_serve_kernel", "chebyshev_eval_kernel"
K8_KERNELS = ("linear_columns_kernel", "fourier_basis_kernel", "dm_rows_kernel")
KERNEL_PATTERNS = {"dd_elementwise": K0_KERNEL, "resid_tangent": K1_KERNEL,
                   "normal_eq": K2_KERNEL, "ecorr_normal_eq": K3_KERNEL,
                   "site_geometry": K4_KERNEL, "analytic_ephemeris": K5_KERNELS[0],
                   "nbody_serve": K6_KERNEL, "chebyshev_eval": K7_KERNEL,
                   "linear_columns": K8_KERNELS[0], "fourier_basis": K8_KERNELS[1],
                   "dm_rows": K8_KERNELS[2]}


def k0_record(model, device) -> dict:
    """K0 at the fit's parameter update: add_fp of a float64 step into the
    (F0, F1) dd pair, shape (2,)."""
    import torch

    from pint_tpu_torch.ops.dd import DD, dd_elementwise, dd_elementwise_plain

    dd_free = [n for n in model.free_params if isinstance(model.params[n], DD)]
    x = DD(torch.stack([model.params[n].hi for n in dd_free]),
           torch.stack([model.params[n].lo for n in dd_free]))
    y = torch.tensor([START_SHIFT.get(n, 1e-20) for n in dd_free], dtype=torch.float64,
                     device=device)
    ms, call = measure(lambda: dd_elementwise("add_fp", x, y), device, 200, K0_KERNEL)
    plain, plain_call = measure(lambda: dd_elementwise_plain("add_fp", x, y), device, 200)
    m = len(dd_free)
    # per value: read hi, lo and the step, write hi and lo; two_sum (6),
    # two adds and quick_two_sum (3): 11 float64 operations
    b, how = bound_ms(m * 5 * 8, m * 11)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call,
            "shape": f"add_fp over ({m},): {', '.join(dd_free)}"}


# K1's float64 operations per row, counted from csrc/resid_tangent.cu with
# a sin, cos or log as ~35 operations and a division as ~15: 10 sin/cos,
# 1 log, 1 sqrt and ~7 divisions (~500), the dd Horner, TZR subtraction and
# rint (~200), dot products and the rest (~50); each tangent lane adds ~80.
# The ELL1 term adds 8 sin/cos and 1 log (~315), the dd orbital phase (~60)
# and ~120 dual operations of the three Roemer polynomials, the inverse
# expansion and the Shapiro term (~120 on the value, ~300 per lane).
# The Kepler term (BT, DD): the Newton solve on the value alone, a sine for
# Danby's start and 10 steps of a sine, a cosine, a division and 4 operations
# (~945); the sines and cosines of 4 more angles (E, E/2, omega, omega + nu;
# 8, ~280), 1 atan2 (~45), 4 square roots (~80), 1 log (~35), 8 divisions
# (~120), the dd orbital phase (~60) and ~100 other operations (~1,665); per
# lane ~110 dual operations (~280) and the tangents of the 8 divisions as
# multiplies by the row's reciprocals (~25).
K1_OPS_PER_ROW = 750
K1_OPS_PER_LANE = 80
K1_BIN_OPS_PER_ROW = 500
K1_BIN_OPS_PER_LANE = 300
K1_KEPLER_OPS_PER_ROW = 1665
K1_KEPLER_OPS_PER_LANE = 305
# The NANOGrav terms (NG instances): the obliquity rotation (6), the DMX
# delay (a division, ~20), FD's log and Horner over three terms (~45) and
# the jump phase (~3); per lane ~20 dual operations
K1_NG_OPS_PER_ROW = 75
K1_NG_OPS_PER_LANE = 20
# The binaries of slice 7, on top of their kind's counts: ELL1H's harmonic
# series, a sine or cosine and ~6 operations per harmonic (~41; the exact
# form's log replaces ELL1's); ELL1K's first-order expansion, 2 sines and
# cosines fewer (~-70); the FB form's Taylor tail and division (~10 per
# term); DDK's corrections, 4 sines and cosines, a square root and ~6
# divisions (~250), ~60 dual operations per lane; DDGR's Jacobian seeds
# (~6 per lane; its derived values are the host's)
K1_HARMONIC_OPS_PER_ROW = 41
K1_HARMONIC_OPS_PER_LANE = 8
K1_ELL1K_OPS_PER_ROW = -70
K1_FB_OPS_PER_TERM = 10
K1_DDK_OPS_PER_ROW = 250
K1_DDK_OPS_PER_LANE = 60
K1_DDGR_OPS_PER_LANE = 6


#: what the phases keep of a K1 record at each shape for the kernels line:
#: the measured times and the bound (its plan and op count go to the
#: summary's "k1_plan", `k1_kept`)
K1_RECORD_KEYS = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "bound_counts", "shape",
                  "by_kernel")
# the DMX and JUMP columns K1 writes from its one DMX lane and in closed form:
# per row and column a compare, a select and the TZR row's subtraction
K1_CLASS_COLUMN_OPS = 3


def k1_record(model, tensor, params, lanes, device, reps: int) -> dict:
    """K1's device and call ms at one shape, the twin's, and its bound. The
    bound's operations count the DMX lanes as one lane and the JUMP lanes as
    one, plus `K1_CLASS_COLUMN_OPS` per row for each of their columns; its
    bytes are each row input, parameter row, one-hot and mask entry read
    once and each output written once. Under "plan": the bound's operations
    and, on the card, the plan's kernel lanes, lane width, tape slots and
    scratch bytes."""
    from pint_tpu_torch.residuals import (BIN_ELL1, BIN_KEPLER, BIN_NONE, L_DMX0, L_FB0,
                                          L_JUMP0, P_ROW_LEN, _k1_setup, batch_size,
                                          resid_tangent, resid_tangent_plain)

    B = batch_size(params)
    rows = tensor["t_hi"].shape[0]
    n = rows - int(model.has_abs_phase)
    call = lambda: resid_tangent(model, params, tensor, lanes)  # noqa: E731
    ms, call_ms = measure(call, device, reps, K1_KERNEL)
    plain, plain_call = measure(lambda: resid_tangent_plain(model, params, tensor, lanes),
                                device, max(1, reps // 20))
    k = len(lanes)
    setup = _k1_setup(model, tuple(lanes))
    st = setup.st
    n_dmx = sum(L_DMX0 <= c < L_FB0 for c in setup.codes)
    n_jump = sum(L_JUMP0 <= c < L_DMX0 for c in setup.codes)
    class_lanes = k - n_dmx - n_jump + (n_dmx > 0) + (n_jump > 0)
    kind = st.bin_kind
    ng = st.ecliptic or st.n_dmx or st.n_fd or st.n_jump
    n_bytes = rows * 12 * 8 + B * (P_ROW_LEN + 2 * model["Spindown"].num_terms) * 8 \
        + B * n * (3 + 2 * k) * 8 + B * rows * 8 + rows * (st.n_dmx + st.n_jump) * 8
    # the N TOA rows and the TZR row once per parameter set
    bin_row, bin_lane = {BIN_NONE: (0, 0), BIN_ELL1: (K1_BIN_OPS_PER_ROW, K1_BIN_OPS_PER_LANE),
                         BIN_KEPLER: (K1_KEPLER_OPS_PER_ROW, K1_KEPLER_OPS_PER_LANE)}[kind]
    per_row = K1_OPS_PER_ROW + bin_row + (K1_NG_OPS_PER_ROW if ng else 0)
    per_lane = K1_OPS_PER_LANE + bin_lane + (K1_NG_OPS_PER_LANE if ng else 0)
    per_row += K1_FB_OPS_PER_TERM * st.n_fb
    if kind == BIN_ELL1 and st.bin_model == 1:  # ELL1H's harmonics (none in the log form)
        harmonics = max(st.nharms - 2, 0) if st.h_mode != 2 else 0
        per_row += K1_HARMONIC_OPS_PER_ROW * harmonics
        per_lane += K1_HARMONIC_OPS_PER_LANE * harmonics
    elif kind == BIN_ELL1 and st.bin_model == 2:
        per_row += K1_ELL1K_OPS_PER_ROW
    elif kind == BIN_KEPLER and st.bin_model == 3:
        per_row, per_lane = per_row + K1_DDK_OPS_PER_ROW, per_lane + K1_DDK_OPS_PER_LANE
    elif kind == BIN_KEPLER and st.bin_model == 2:
        per_lane += K1_DDGR_OPS_PER_LANE
    n_ops = B * rows * (per_row + per_lane * class_lanes) \
        + B * n * K1_CLASS_COLUMN_OPS * (n_dmx + n_jump)
    b, how = bound_ms(n_bytes, n_ops)
    rec = {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
           "call_ms": call_ms, "plain_call_ms": plain_call, "plan": {"bound_ops": n_ops},
           "bound_counts": "the DMX lanes as one lane, the JUMP lanes as one, plus "
                           f"{K1_CLASS_COLUMN_OPS} operations a row for each of their columns",
           "shape": f"B={B} N={n} lanes={len(lanes)} (DMX {n_dmx}, JUMP {n_jump})"}
    if device.type == "cuda":
        from pint_tpu_torch.ops import build
        from pint_tpu_torch.residuals import _declare_k1

        _, plan = setup.call(build.library("resid_tangent", _declare_k1), rows, n,
                             model.has_abs_phase, "delta_pn" in tensor, "track_pn" in tensor, B)
        rec["by_kernel"] = by_kernel(call, 5, K1_KERNEL)
        rec["plan"].update(kernel_lanes=plan.n_klane, lane_width=plan.width,
                           tape_slots=plan.n_slots, scratch_bytes=plan.scratch * 8)
    return rec


def k1_kept(summary: dict, label: str, rec: dict, prefix: str = "",
            keys=K1_RECORD_KEYS) -> dict:
    """A K1 record's part for the kernels line (`keys`, or all but the plan
    for None; each key after `prefix`); its "plan" goes to
    summary["k1_plan"][label]."""
    summary.setdefault("k1_plan", {})[label] = rec["plan"]
    return {f"{prefix}{k}": v for k, v in rec.items()
            if k != "plan" and (keys is None or k in keys)}


def k2_record(r, M, w, device) -> dict:
    import torch

    from pint_tpu_torch.gridutils import _RIDGE, normal_eq, normal_eq_plain

    B, p, n = M.shape
    ms, call = measure(lambda: normal_eq(r, M, w, _RIDGE, True), device, 200, K2_KERNEL)
    plain, plain_call = measure(lambda: normal_eq_plain(r, M, w, _RIDGE, True), device, 50)
    A = (M * torch.sqrt(w)).transpose(-1, -2).contiguous()  # (B, N, p)
    lib, lib_call = measure(lambda: torch.matmul(A.transpose(-1, -2), A), device, 200)
    n_bytes = (B * n * (p + 1) + n) * 8 + B * (p * p + 2 * p + 1) * 8
    # the Gram's multiply-adds (p^2 per row) and the centring, weighting and
    # equilibration around it
    b, how = bound_ms(n_bytes, B * n * (8 * p + 7), B * n * p * p)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": lib,
            "call_ms": call, "plain_call_ms": plain_call, "library_call_ms": lib_call,
            "shape": f"B={B} N={n} p={p}"}




_K3_BUILD: dict = {}


def sass_dmma(name: str):
    """The DMMA (float64 tensor-core) instructions in library `name`'s SASS
    (``cuobjdump -sass``); None where there is no library, as on the CPU."""
    import shutil

    from pint_tpu_torch.ops import build

    lib = build.build_dir() / f"lib{name}.so"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not (lib.exists() and os.path.exists(tool)):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    return sum(1 for ln in sass.splitlines() if " DMMA" in ln)


def k3_build_info() -> dict:
    """K3's Gram as built: each gram_pass instance's registers and spill
    store bytes (ptxas) and the DMMA instructions in its library's SASS.
    Read once a run."""
    from pint_tpu_torch.ops import build

    if not _K3_BUILD:
        rep = build.ptxas_report("ecorr_normal_eq")
        _K3_BUILD["gram_ptxas"] = {k: {"registers": r, "spill_store_bytes": sp}
                                   for k, (r, sp) in rep.items() if "gram_pass" in k}
        _K3_BUILD["sass_dmma"] = sass_dmma("ecorr_normal_eq")
    return dict(_K3_BUILD)


def grad_build_info(name: str) -> dict:
    """K9's or K10's library as built (`name`: noise_grad, pta_grad): each
    pass instance's registers and spill store bytes (ptxas) and the DMMA
    instructions in its SASS."""
    from pint_tpu_torch.ops import build

    return {"ptxas": {k: {"registers": r, "spill_store_bytes": sp}
                      for k, (r, sp) in build.ptxas_report(name).items()},
            "sass_dmma": sass_dmma(name)}


def k3_with_build(rec: dict) -> dict:
    """A K3 record with its build's registers, spills and DMMA count,
    printed on a line of its own."""
    info = k3_build_info()
    print(f"  K3 {rec['shape']}: {rec['ms']} ms {rec['ms_spread']} (queued {rec['queued_ms']}), "
          f"library {rec['library_ms']} ms {rec['library_spread']} (queued "
          f"{rec['library_queued_ms']}); gram_pass ptxas "
          f"{json.dumps(info['gram_ptxas'])}; SASS DMMA instructions {info['sass_dmma']}")
    return {**rec, **info}


#: rounds in which K3 and its library yardstick are measured in turn
K3_ROUNDS = 5


def k3_against_library(kernel, library, device, reps: int) -> dict:
    """K3's device ms (its own passes) and its library yardstick's, each
    `measure`d over `reps` calls, in turn for K3_ROUNDS rounds in this
    process: the medians (``ms``, ``library_ms``; call ms likewise) and each
    one's [least, most] over the rounds (``ms_spread``,
    ``library_spread``); and, without the profiler, each call's device ms
    from CUDA events behind a busy queue (``queued_ms``, K3's whole call;
    ``library_queued_ms``: `queued_ms`). On the CPU one round, with no
    device time."""
    import statistics

    rounds = K3_ROUNDS if device.type == "cuda" else 1
    got = {"ms": [], "call_ms": [], "library_ms": [], "library_call_ms": []}
    for _ in range(rounds):
        for key, fn, kernel_name in (("", kernel, K3_KERNEL), ("library_", library, None)):
            ms, call = measure(fn, device, reps, kernel_name)
            got[key + "ms"].append(ms)
            got[key + "call_ms"].append(call)
    out = {}
    for key, vals in got.items():
        out[key] = None if vals[0] is None else statistics.median(vals)
    for key, spread in (("ms", "ms_spread"), ("library_ms", "library_spread")):
        out[spread] = None if got[key][0] is None else [min(got[key]), max(got[key])]
    cuda = device.type == "cuda"
    out["queued_ms"] = queued_ms(kernel, reps) if cuda else None
    out["library_queued_ms"] = queued_ms(library, reps) if cuda else None
    return out


def k3_record(r, M, w, basis, ridge, centre, weighted_norm, device) -> dict:
    """K3 at one shape; `ms` is the device time of K3's own passes, `call_device_ms`
    that of the whole call (with the kd x kd Cholesky and triangular solves
    of a dense basis). The library yardstick is the batched cuBLAS Gram
    X W X^T of the augmented rows X = [Mn, r, Fd] alone, on the twin's Mn."""
    import torch

    from pint_tpu_torch.fitting.woodbury import (_step_inputs, ecorr_normal_eq,
                                                 ecorr_normal_eq_plain)

    args = (r, M, w, basis, ridge, centre, weighted_norm)
    B, p, n = M.shape
    whole, _ = measure(lambda: ecorr_normal_eq(*args), device, 50)
    plain, plain_call = measure(lambda: ecorr_normal_eq_plain(*args), device, 5)
    rr, Mn, _ = _step_inputs(r, M, w, centre, weighted_norm)
    kd = basis.kd
    parts = [Mn, rr[:, None]] + ([basis.dense.T.expand(B, kd, n)] if kd else [])
    X = (torch.cat(parts, dim=1) * torch.sqrt(w)).contiguous()
    timed = k3_against_library(lambda: ecorr_normal_eq(*args),
                               lambda: torch.matmul(X, X.transpose(-1, -2)), device, 50)
    ke = basis.ke
    nnz = basis.epochs.rows.shape[0] if basis.epochs is not None else 0
    V = p + 1 + kd
    q = (p + 1) * (p + 2) // 2
    # read r, M, w, Fd, phi and the CSR once; write G, c, chi2, ahat, norm
    n_bytes = (B * n * (p + 1) + n * (1 + kd) + ke + kd) * 8 + (ke + 1 + nnz) * 4 \
        + B * (p * p + 2 * p + 1 + ke + kd) * 8
    # the step inputs: weighted means (2 per value of r and M, when
    # centring), column norms (3 per value of M), each value centred and
    # divided (2); the epoch sums (2 per value and row); each row and epoch
    # weighted once (1 per value); then the matrix products: the augmented
    # Gram over rows and epochs (a multiply-add per entry and row or epoch;
    # the Fd block once) and the fold (one per entry and basis column)
    gram = V * (V + 1) // 2
    per_set = gram - kd * (kd + 1) // 2
    n_ops = (B * (n * (p + 1) * (2 * int(centre) + 2) + n * p * 3 + nnz * 2 * (p + 1)
                  + (n + ke) * (p + 1))
             + nnz * 2 * kd + (n + ke) * kd)
    n_mma = B * ((n + ke) * 2 * per_set + q * 2 * kd) + (n + ke) * kd * (kd + 1)
    b, how = bound_ms(n_bytes, n_ops, n_mma)
    return k3_with_build({**timed, "plain_ms": plain, "bound_ms": b, "bound_by": how,
                          "call_device_ms": whole, "plain_call_ms": plain_call,
                          "shape": f"B={B} N={n} p={p} ke={ke} kd={kd}"})


def phase_k3(model, tensor, ftr, params_b, grid_free, device, extra=None) -> dict:
    """K3 against its twin on the GLS step's raw design (B = 1) and the
    grid's first step (B = 9), and on the chi^2 calls of each (no columns),
    and on the `extra` cases ({label: arguments}), and bitwise against
    itself on a second run."""
    import torch

    from pint_tpu_torch.fitting.gls import _RIDGE as GLS_RIDGE
    from pint_tpu_torch.fitting.wls import time_resid_design
    from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq, ecorr_normal_eq_plain
    from pint_tpu_torch.gridutils import _RIDGE, _time_resids_design

    res = ftr.resids
    basis = model.noise_basis_and_weights(model.params, tensor)
    w = 1.0 / res.errors_s**2
    r0, M = time_resid_design(model, tuple(model.free_params), model.params, tensor,
                              res.weights, True, hybrid=False)
    r, Mg = _time_resids_design(model, params_b, tensor, grid_free)
    inputs = {"fit": (r0[None], M.T[None].contiguous(), w, basis, GLS_RIDGE, False, False),
              "grid": (r, Mg, w, basis, _RIDGE, True, True),
              "fit chi2": (r0[None], r0.new_zeros((1, 0, r0.shape[0])), w, basis, 0.0, False,
                           False),
              "grid chi2": (r, r.new_zeros((r.shape[0], 0, r.shape[1])), w, basis, 0.0, True,
                            False), **(extra or {})}
    out = {}
    for label, args in inputs.items():
        got = ecorr_normal_eq(*args)
        again = ecorr_normal_eq(*args)
        want = ecorr_normal_eq_plain(*args)
        sync(device)
        B, p = args[1].shape[:2]
        kd = args[3].kd if args[3] is not None else 0
        tag = f"K3 {label} (B={B}, p={p}, kd={kd})"
        for name, g, wv in zip(("G", "c", "chi2", "ahat", "norm"), got, want):
            err = max(rel_err(g[b], wv[b]) for b in range(B))
            check(err <= 1e-12, f"{tag}: {name} within 1e-12 relative per set ({err:.3g})")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: bitwise equal across two runs")
        out[label] = {"args": args, "out": got,
                      "chi2_abs_err": float(torch.max(torch.abs(got[2] - want[2])))}
    return out


KERNELS = (
    ("dd_elementwise", "pint_tpu_torch/csrc/dd_elementwise.cu",
     "pint_tpu/ops/dd.py:142 (dd_add..dd_rint, inlined in every TPU program)"),
    ("resid_tangent", "pint_tpu_torch/csrc/resid_tangent.cu",
     "pint_tpu/residuals.py:90 (resid) + pint_tpu/fitting/wls.py:180 (design jvp); the Kepler "
     "term pint_tpu/models/binaries/kepler.py:27-67 (kepler_E, its JVP, true_anomaly) + "
     "engines.py:59-130 (bt_delay, _dd_core, dd_delay, dds_delay); the binaries of slice 7 "
     "pint_tpu/models/binary.py:307-361 (_orbits' FB branch, PulsarBinary.delay's DDGR and "
     "DDK branches) + engines.py:246-434 (ell1h_shapiro, ell1h_delay, ell1k_delay, "
     "ddgr_derived, ddk_corrections); the NANOGrav terms "
     "pint_tpu/models/astrometry.py:122-168 (AstrometryEcliptic), dispersion.py:122-203 "
     "(DispersionDMX), frequency_dependent.py (FD), phase_misc.py:58-95 (PhaseJump)"),
    ("normal_eq", "pint_tpu_torch/csrc/normal_eq.cu",
     "pint_tpu/gridutils.py:132 (gn_step normal equations, grid program)"),
    ("ecorr_normal_eq", "pint_tpu_torch/csrc/ecorr_normal_eq.cu",
     "pint_tpu/fitting/gls.py:77 (gls_step Woodbury pieces) + gls.py:193 (gls_chi2) + "
     "pint_tpu/gridutils.py:112-170 (correlated grid step: centring, equilibration, Woodbury "
     "normal equations, chi2), algebra of fitting/woodbury.py:79-218 with the dense basis "
     "(s_factor, s_solve, basis_rmatvec, basis_matvec, s_logdet: woodbury.py:92-160); the "
     "stacked [TOA; DM] system of pint_tpu/fitting/wideband.py:104-118 (wb_step's Woodbury "
     "pieces, row-scaled basis _noise_basis_aug :56) and :206-214 (wb_chi2)"),
    ("site_geometry", "pint_tpu_torch/csrc/site_geometry.cu",
     "pint_tpu/astro/device_prepare.py:91 (prepare_geometry: astro/erot.py "
     "itrf_to_gcrs_posvel)"),
    ("analytic_ephemeris", "pint_tpu_torch/csrc/analytic_ephemeris.cu",
     "pint_tpu/astro/device_prepare.py:121 (prepare_ephemeris: astro/ephemeris.py "
     "AnalyticEphemeris._posvel_analytic per body)"),
    ("nbody_serve", "pint_tpu_torch/csrc/nbody_serve.cu",
     "pint_tpu/astro/device_prepare.py:175 (prepare_nbody: astro/nbody.py "
     "NBodyEphemeris.posvel, Hermite serve + in-band correction)"),
    ("chebyshev_eval", "pint_tpu_torch/csrc/chebyshev_eval.cu",
     "pint_tpu/astro/device_prepare.py:233 (prepare_kernel_eval: astro/kernel_ephemeris.py "
     "eval_rows, record gather + Chebyshev recurrence + analytic velocity)"),
    ("linear_columns", "pint_tpu_torch/csrc/linear_columns.cu",
     "pint_tpu/fitting/design.py:48 (linear_columns: DM, DMX, FD, JUMP closed forms, in the "
     "wls_step, gls_step and grid programs) + pint_tpu/models/noise.py:246-259 "
     "(fourier_basis, PLRedNoise/PLDMNoise basis_and_weights :309-320, :477-484)"),
    ("ecorr_normal_eq_sets", "pint_tpu_torch/csrc/ecorr_normal_eq.cu",
     "pint_tpu/fitting/noise_like.py:141-180 (_loglike_fn's Woodbury chi2, log|C| and the "
     "profiled timing block, as XLA fused it into the TPU programs noise_loglike :802 and "
     "noise_loglike_batch :806, and into the forward of noise_loglike_grad :811 and "
     "noise_optimize :367), algebra of fitting/woodbury.py:79-218"),
    ("noise_grad", "pint_tpu_torch/csrc/noise_grad.cu",
     "pint_tpu/fitting/noise_like.py:798 (jax.grad of _loglike_fn :141-180: the reverse pass "
     "of noise_loglike_grad :811 and of value_and_grad inside noise_optimize :327-367)"),
    ("ecorr_normal_eq_stacked", "pint_tpu_torch/csrc/ecorr_normal_eq.cu",
     "pint_tpu/fitting/pta_like.py:169-193 (_pta_core.pulsar_blocks: cinv_inner, woodbury_chi2, "
     "logdet_C(mask=) per pulsar, vmapped over the array and the points, as XLA fused it into "
     "the TPU programs pta_loglike :605, pta_loglike_batch :608, the forward of "
     "pta_loglike_grad :612, pta_detection_stat :680 and pta_gwb_blocks :798), algebra of "
     "fitting/woodbury.py:79-218"),
    ("pta_grad", "pint_tpu_torch/csrc/pta_grad.cu",
     "pint_tpu/fitting/pta_like.py:612 (pta_loglike_grad: jax.grad's reverse pass through "
     "pulsar_blocks :169-193, and the value_and_grad of pta_optimize, noise_like.py:367)"),
    ("dm_rows", "pint_tpu_torch/csrc/linear_columns.cu",
     "pint_tpu/fitting/wideband.py:40-53 (_weighted_resids' DM block: "
     "models/timing_model.py:264-276 total_dm over dispersion.py:95 DispersionDM, :186 "
     "DispersionDMX, :206-225 DispersionJump, and its jax.linearize columns) in the TPU "
     "programs wb_step (wideband.py:137) and wb_chi2 (wideband.py:216)"),
)


def smoke_phases(device, summary: dict) -> dict:
    """Phases 3-8 (SMOKE_PAR, the WLS path); returns the kernel records and
    the launch counts of its fit and grid windows."""
    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.prepared import load_prepared

    print("phase 3: K0 dd_elementwise against the dd twins")
    phase_k0(device)

    print("phase 4: K1 resid_tangent against its twin")
    tensor = load_prepared(device=device)
    start = fresh_fitter(tensor, device)
    model = start.model
    fit_lanes = linear_split(model, tuple(model.free_params))[0]
    names, _, params_b = grid_params(model, start)
    grid_free = tuple(n for n in model.free_params if n not in names)
    grid_lanes = linear_split(model, grid_free)[0]
    k1_stats = phase_k1(model, tensor, params_b, fit_lanes, grid_lanes, device, 1e-10)

    print("phase 5: K2 normal_eq against its twin")
    w = 1.0 / start.resids.errors_s**2
    r, M, k2_err = phase_k2(model, tensor, params_b, grid_free, w, device)

    print("phase 6: DownhillWLSFitter.fit_toas")
    main = run_main_path(fresh_fitter(tensor, device), device)
    fit_l, grid_l = main["fit_launches"], main["grid_launches"]
    for name in ("dd_elementwise", "resid_tangent"):
        check(fit_l[name] > 0, f"{name} launched {fit_l[name]} times by fit_toas")
    with twins():
        twin = run_main_path(fresh_fitter(tensor, device), device)
    check_fit(main, twin, "SMOKE")

    print("phase 7: grid_chisq 3x3 (F0, F1)")
    import numpy as np

    check_grid(main, twin, "SMOKE")
    check(int(np.argmin(main["chi2"])) == 4, "SMOKE grid chi2 minimum at the centre point")
    for name in ("resid_tangent", "normal_eq"):
        check(grid_l[name] > 0, f"{name} launched {grid_l[name]} times by grid_chisq")
    print(f"  grid_chisq launched dd_elementwise {grid_l['dd_elementwise']} times "
          "(its refitted parameters are plain float64)")

    print("timing kernels against their twins")
    recs = {
        "dd_elementwise": k0_record(model, device),
        "resid_tangent": k1_kept(summary, "smoke grid",
                                 k1_record(model, tensor, params_b, grid_lanes, device, 50),
                                 keys=None),
        "normal_eq": k2_record(r, M, w, device),
    }
    recs["resid_tangent"].update(k1_kept(
        summary, "smoke fit", k1_record(model, tensor, model.params, fit_lanes, device, 50),
        "fit_"))
    recs["normal_eq"].update(kernel_passes_fit=fit_l["normal_eq_passes"],
                             kernel_passes_grid=grid_l["normal_eq_passes"])
    if device.type == "cuda":
        print("phase 8: where the time goes (one warm fit + grid, then torch.profiler)")
        summary["profile"] = profile_main_path(tensor, device)
    res = main["fitter"].result
    summary.update({"fit_wall_s": main["fit_s"], "grid_wall_s": main["grid_s"],
                    "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
                    "grid_chi2": main["chi2"].tolist(),
                    "ntoas": int(tensor["t_hi"].shape[0] - 1)})
    errs = {"dd_elementwise": 0.0, "resid_tangent": k1_stats["grid"]["max_abs_err"],
            "normal_eq": k2_err}
    return {"recs": recs, "errs": errs, "fit": fit_l, "grid": grid_l}


def flagship_phases(device, summary: dict) -> dict:
    """Phases 9-13 (the flagship par, the GLS path)."""
    import numpy as np

    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.prepared import FLAGSHIP_ARCHIVE, load_prepared

    print("phase 9: K1 with the ELL1 term against its twin (flagship)")
    tensor = load_prepared(FLAGSHIP_ARCHIVE, device=device)
    start = fresh_fitter(tensor, device, "flagship")
    model = start.model
    free = tuple(model.free_params)
    names, _, params_b = grid_params(model, start)
    grid_free = tuple(n for n in free if n not in names)
    grid_lanes = linear_split(model, grid_free)[0]
    check(len(free) == 14 and len(grid_lanes) == 12,
          f"flagship: {len(free)} free parameters, {len(grid_lanes)} grid lanes")
    k1_stats = phase_k1(model, tensor, params_b, free, grid_lanes, device, 1e-12, "flagship ")

    print("phase 10: K3 ecorr_normal_eq against its twin")
    k3 = phase_k3(model, tensor, start, params_b, grid_free, device)

    print("phase 11: DownhillGLSFitter.fit_toas (flagship)")
    main = run_main_path(fresh_fitter(tensor, device, "flagship"), device)
    fit_l, grid_l = main["fit_launches"], main["grid_launches"]
    for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
        check(fit_l[name] > 0, f"{name} launched {fit_l[name]} times by the GLS fit_toas")
    with twins():
        twin = run_main_path(fresh_fitter(tensor, device, "flagship"), device)
    check_fit(main, twin, "flagship GLS")

    print("phase 12: grid_chisq 3x3 (M2, SINI), GLS statistic")
    worst_g = check_grid(main, twin, "flagship")
    for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
        check(grid_l[name] > 0, f"{name} launched {grid_l[name]} times by the GLS grid_chisq")

    print("phase 13: flagship kernel times, warm wall and busy share")
    recs = {
        "resid_tangent": {
            k: v for shape, params, lanes in (("fit", model.params, free),
                                              ("grid", params_b, grid_lanes))
            for k, v in k1_kept(summary, f"flagship {shape}",
                                k1_record(model, tensor, params, lanes, device, 20),
                                f"flagship_{shape}_").items()},
        "ecorr_normal_eq": k3_record(*k3["grid"]["args"], device),
    }
    fit3 = k3_record(*k3["fit"]["args"], device)
    recs["ecorr_normal_eq"].update({f"fit_{k}": v for k, v in fit3.items()
                                    if k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape")})
    if device.type == "cuda":
        summary["flagship_profile"] = profile_main_path(tensor, device, "flagship")
    res = main["fitter"].result
    summary["flagship"] = {
        "fit_wall_s": main["fit_s"], "grid_wall_s": main["grid_s"],
        "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
        "grid_chi2": main["chi2"].tolist(), "grid_rel_err": worst_g,
        "ntoas": int(tensor["t_hi"].shape[0] - 1),
        "epochs": int(model.noise_basis_and_weights(model.params, tensor).ke),
        "free": list(free)}
    errs = {"resid_tangent": max(s["max_abs_err"] for s in k1_stats.values()),
            "ecorr_normal_eq": max(v["chi2_abs_err"] for v in k3.values())}
    return {"recs": recs, "errs": errs, "fit": fit_l, "grid": grid_l,
            "fitter": main["fitter"]}


# --- phases 14-17: the TOA prepare (K4, K5) and the fit from a .tim -----------------

PREPARE_N = 131072
GBT_ITRF = (882589.65, -4924872.32, 3943729.348)
C_M_PER_S = 299792458.0

# K4's float64 operations per epoch, counted from csrc/site_geometry.cu with a
# sine or cosine as ~35 operations: 71 of them (the 30 nutation arguments'
# sines and cosines, the four rotations' and the angles of ERA and the
# equation of the equinoxes), ~800 other operations (the polynomials, the 30
# arguments of 9 operations each, the two 30-term sums, three 3x3 products
# and the rotation of the site)
K4_OPS_PER_EPOCH = 71 * 35 + 800
# K5's per evaluation of the system (three per epoch), from
# csrc/analytic_ephemeris.cu: each VSOP87 term a cosine and 4 operations; the
# three mean-element bodies 10 Newton steps (a sine, a cosine, 6 operations)
# and 12 sines or cosines; 5 per VSOP body turning (L, B, R) into xyz; the F-W
# rotation's 6; the Moon's 51 terms (a sine or cosine and ~12 operations) and
# 12 more sines; ~100 operations of rotations and sums per body served
K5_TRIG_OPS = 35


def k5_ops_per_epoch(bodies) -> int:
    from pint_tpu_torch.astro.ephemeris import pack_tables

    table, layout = pack_tables()
    lay = layout[:-7].reshape(6, 3, 6, 2)
    planets = int(lay[1:, :, :, 1].sum())  # venus .. neptune (the Sun needs them)
    earth = int(lay[0, :, :, 1].sum()) if set(bodies) & {"earth", "moon", "emb"} else 0
    moon = set(bodies) & {"moon", "emb"}
    per_eval = ((planets + earth) * (K5_TRIG_OPS + 4)
                + 3 * (10 * (2 * K5_TRIG_OPS + 6) + 12 * K5_TRIG_OPS)
                + (5 + int(earth > 0)) * 5 * K5_TRIG_OPS + 6 * K5_TRIG_OPS
                + (51 * (K5_TRIG_OPS + 12) + 12 * K5_TRIG_OPS if moon else 0)
                + 100 * (len(bodies) + 8))
    return 3 * per_eval


def prepare_epochs(n: int, seed: int = 29):
    """UT1 MJDs 1995-2035, TT centuries and polar-motion angles of n epochs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mjd = np.sort(rng.uniform(49718.0, 64328.0, n))
    tt = (mjd + 69.184 / 86400.0 - 51544.5) / 36525.0
    return mjd, tt, rng.uniform(-1.5e-6, 1.5e-6, n), rng.uniform(-1.5e-6, 1.5e-6, n)


def phase_k45(device) -> dict:
    """K4 and K5 against their twins at PREPARE_N epochs."""
    import torch

    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.ephemeris import BODIES

    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    mjd, tt, xp, yp = (t(a) for a in prepare_epochs(PREPARE_N))
    got, want = dp.site_geometry(GBT_ITRF, mjd, tt, xp, yp), \
        dp.site_geometry_plain(GBT_ITRF, mjd, tt, xp, yp)
    sync(device)
    ep = float(torch.max(torch.abs(got[0] - want[0])))
    ev = float(torch.max(torch.abs(got[1] - want[1])))
    check(ep <= 1e-6, f"K4 N={PREPARE_N}: position within 1e-6 m of the twin ({ep:.3g} m)")
    check(ev <= 1e-9, f"K4 N={PREPARE_N}: velocity within 1e-9 m/s of the twin ({ev:.3g} m/s)")
    T = (mjd - 51544.5) / 36525.0
    out = {"k4_pos_err_m": ep, "k4_vel_err_m_s": ev}
    for bodies in (("earth", "sun"), BODIES):
        got, want = dp.analytic_ephemeris(bodies, T), dp.analytic_ephemeris_plain(bodies, T)
        sync(device)
        ep = max(float(torch.max(torch.abs(got[b][0] - want[b][0]))) for b in bodies)
        ev = max(float(torch.max(torch.abs(got[b][1] - want[b][1]))) for b in bodies)
        tag = f"K5 N={PREPARE_N} {len(bodies)} bodies"
        check(ep <= 1e-3, f"{tag}: positions within 1 mm of the twin ({ep:.3g} m)")
        check(ev <= 1e-4, f"{tag}: velocities within 1e-4 m/s of the twin ({ev:.3g} m/s)")
        out[f"k5_{len(bodies)}_pos_err_m"], out[f"k5_{len(bodies)}_vel_err_m_s"] = ep, ev
    return out


def synthetic_tim(path: Path, n: int, seed: int = 31) -> None:
    """A .tim of n flagship-shaped lines: epochs of the 8 sub-bands of one of
    two receivers at GBT, 2003-2033, 1 us errors."""
    import numpy as np

    from pint_tpu_torch.io.tim import TOALine, write_tim
    from pint_tpu_torch.profiles import RECEIVERS

    rng = np.random.default_rng(seed)
    per = len(RECEIVERS[0][1])
    start = np.sort(rng.uniform(52640.0, 63598.0, n // per))
    lines = []
    for i, mjd in enumerate(start):
        fname, subbands = RECEIVERS[i % len(RECEIVERS)]
        for j, f in enumerate(subbands):
            m = mjd + j * 0.1 / 86400.0
            day = int(m)
            lines.append(TOALine(f"syn_{len(lines)}", float(f), day, m - day, 0.0, 1.0, "gbt",
                                 {"f": fname, "fe": fname.split("_GUPPI")[0]}))
    write_tim(lines, str(path))


def compare_toas(got, want, label: str) -> dict:
    """The prepared columns of two TOAs objects: TDB within 1 ps, positions
    within 1 mm, velocities within 1e-4 m/s."""
    import numpy as np

    dt = ((got.tdb.day - want.tdb.day) * 86400.0
          + ((got.tdb.frac_hi - want.tdb.frac_hi) + (got.tdb.frac_lo - want.tdb.frac_lo))
          * 86400.0)
    errs = {"tdb_s": float(np.max(np.abs(dt)))}
    for k in ("ssb_obs_pos_m", "obs_sun_pos_m", "ssb_obs_vel_m_s"):
        errs[k] = float(np.max(np.abs(getattr(got, k) - getattr(want, k))))
    check(errs["tdb_s"] <= 1e-12, f"{label}: TDB within 1 ps ({errs['tdb_s']:.3g} s)")
    for k in ("ssb_obs_pos_m", "obs_sun_pos_m"):
        check(errs[k] <= 1e-3, f"{label}: {k} within 1 mm ({errs[k]:.3g} m)")
    check(errs["ssb_obs_vel_m_s"] <= 1e-4,
          f"{label}: ssb_obs_vel within 1e-4 m/s ({errs['ssb_obs_vel_m_s']:.3g} m/s)")
    return errs


def phase_prepare_scale(device, tmp: Path) -> dict:
    """get_TOAs of PREPARE_N synthetic lines through the kernels and the
    twins, with the wall of each stage."""
    from pint_tpu_torch.toas import get_TOAs

    tim = tmp / "synthetic.tim"
    t0 = time.perf_counter()
    synthetic_tim(tim, PREPARE_N)
    print(f"  wrote {PREPARE_N} lines in {time.perf_counter() - t0:.2f} s")
    # phase 14 has loaded both libraries and their tables: nothing here is one-time
    t0 = time.perf_counter()
    got = get_TOAs(str(tim), device=device)
    wall = time.perf_counter() - t0
    with twins():
        t0 = time.perf_counter()
        want = get_TOAs(str(tim), device=device)
        twin_wall = time.perf_counter() - t0
    check(len(got) == PREPARE_N, f"get_TOAs prepared {len(got)} TOAs")
    errs = compare_toas(got, want, f"prepare N={PREPARE_N} kernels vs twins")
    print("  stage walls (s), kernels: " + json.dumps(got.stage_s))
    print("  stage walls (s), twins:   " + json.dumps(want.stage_s))
    return {"n": PREPARE_N, "wall_s": wall, "stage_s": got.stage_s, "twin_wall_s": twin_wall,
            "twin_stage_s": want.stage_s, "errs": errs}


def flagship_tim_path(device, tmp: Path, tim=None, par_text: str | None = None) -> dict:
    """get_model_and_toas + build_tensor of the flagship par (or `par_text`)
    and a .tim (the analytic-ephemeris flagship .tim unless given), in a
    launch window of their own."""
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.prepared import FLAGSHIP_TIM
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR

    par = tmp / "model.par"
    par.write_text(par_text or FLAGSHIP_SMOKE_PAR)
    out = {"launches": {}}
    with counted(out["launches"]):
        t0 = time.perf_counter()
        model, toas = get_model_and_toas(str(par), str(tim or FLAGSHIP_TIM), device=device)
        tensor = model.build_tensor(toas)
        sync(device)
        out["wall_s"] = time.perf_counter() - t0
    out.update(model=model, toas=toas, tensor=tensor, stage_s=toas.stage_s)
    return out


def check_against_archive(tensor, device) -> dict:
    """The columns prepared from the .tim against the archive's."""
    import torch

    from pint_tpu_torch.prepared import FLAGSHIP_ARCHIVE, archive_meta, load_prepared

    arch = load_prepared(FLAGSHIP_ARCHIVE, device=device)
    check(list(tensor) == list(arch), f"the tensor has the archive's {len(arch)} columns")
    dt = float(torch.max(torch.abs((tensor["t_hi"] - arch["t_hi"])
                                   + (tensor["t_lo"] - arch["t_lo"]))))
    check(dt <= 5e-12, f"t within 5 ps of the archive ({dt:.3g} s)")
    stale = archive_meta(FLAGSHIP_ARCHIVE)["geom_stale_s"]
    speed = torch.linalg.norm(arch["ssb_obs_vel_ls"], dim=1)
    errs = {"t_s": dt}
    for k in ("ssb_obs_pos_ls", "obs_sun_pos_ls"):
        err = torch.linalg.norm(tensor[k] - arch[k], dim=1)
        ok = bool(torch.all(err <= speed * stale + 1e-3 / C_M_PER_S))
        errs[k + "_m"] = float(torch.max(err)) * C_M_PER_S
        check(ok, f"{k} within 1 mm + |v| x {stale:.3g} s of the archive "
                  f"(at most {errs[k + '_m']:.4g} m)")
    for k in arch:
        if k.startswith(("mask_", "ecorr_")):
            check(torch.equal(tensor[k], arch[k]), f"{k} equal to the archive's")
    errs["freq_mhz"] = float(torch.max(torch.abs(tensor["freq_mhz"] - arch["freq_mhz"])))
    print(f"  freq_mhz within {errs['freq_mhz']:.3g} MHz of the archive's (six decimals)")
    return errs


def sigma_diff(ftr, ref) -> tuple[float, str]:
    vals, rv, unc = ftr.values(), ref.values(), ref.result.uncertainties
    worst = max(vals, key=lambda n: abs(vals[n] - rv[n]) / unc[n])
    return abs(vals[worst] - rv[worst]) / unc[worst], worst


def k4_record(n: int, device, reps: int) -> dict:
    """K4 over n epochs at GBT (the main path: the flagship's 16,384 TOAs)."""
    import torch

    from pint_tpu_torch.astro import device_prepare as dp

    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    args = (GBT_ITRF, *(t(a) for a in prepare_epochs(n)))
    ms, call = measure(lambda: dp.site_geometry(*args), device, reps, K4_KERNEL)
    plain, plain_call = measure(lambda: dp.site_geometry_plain(*args), device, 3)
    # read UT1, TT, xp, yp; write pos and vel
    b, how = bound_ms(n * 10 * 8, n * K4_OPS_PER_EPOCH)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call, "shape": f"N={n}"}


def k5_record(n: int, device, reps: int) -> dict:
    """K5 over n epochs for the prepare's bodies (Earth, Sun)."""
    import torch

    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.ephemeris import pack_tables

    T = torch.as_tensor((prepare_epochs(n)[0] - 51544.5) / 36525.0, dtype=torch.float64,
                        device=device)
    bodies = ("earth", "sun")
    ms, call = measure(lambda: dp.analytic_ephemeris(bodies, T), device, reps, K5_KERNELS)
    plain, plain_call = measure(lambda: dp.analytic_ephemeris_plain(bodies, T), device, 2)
    # read T and the table once; write pos and vel of each body
    b, how = bound_ms(n * 8 + pack_tables()[0].size * 8 + n * len(bodies) * 6 * 8,
                      n * k5_ops_per_epoch(bodies))
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call, "shape": f"N={n} bodies=earth,sun"}


def prepare_phases(device, summary: dict, flagship: dict) -> dict:
    """Phases 14-17: the port's TOA prepare and the flagship fit from a .tim."""
    from pint_tpu_torch.prepared import FLAGSHIP_ARCHIVE, load_prepared

    print("phase 14: K4 site_geometry and K5 analytic_ephemeris against their twins")
    errs = phase_k45(device)
    with tempfile.TemporaryDirectory() as tmpname, knobs(
            PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
        tmp = Path(tmpname)
        print(f"phase 15: get_TOAs of {PREPARE_N} synthetic lines, kernels and twins")
        scale = phase_prepare_scale(device, tmp)

        print("phase 16: get_model_and_toas + build_tensor of the flagship par and .tim")
        main = flagship_tim_path(device, tmp)
        pl = main["launches"]
        want = 2 if device.type == "cuda" else 0  # the CPU takes the twins
        for name in ("site_geometry", "analytic_ephemeris"):
            check(pl[name] == want, f"{name} launched {pl[name]} times (the TOAs and the TZR row)")
        print("  stage walls (s): " + json.dumps(main["stage_s"])
              + f"; get_model_and_toas + build_tensor {main['wall_s']:.3f} s")
        arch_errs = check_against_archive(main["tensor"], device)
        with twins():
            twin = flagship_tim_path(device, tmp)

        print("phase 17: GLS fit and (M2, SINI) grid from the .tim's TOAs")
        run = run_main_path(fresh_fitter(main["tensor"], device, "flagship"), device)
        fit_l, grid_l = run["fit_launches"], run["grid_launches"]
        for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
            for what, counts in (("fit_toas", fit_l), ("grid_chisq", grid_l)):
                check(counts[name] > 0 or device.type != "cuda",
                      f"{name} launched {counts[name]} times by the {what}")
        with twins():
            twin_run = run_main_path(fresh_fitter(twin["tensor"], device, "flagship"), device)
        check_fit(run, twin_run, "tim GLS")
        worst_g = check_grid(run, twin_run, "tim")
        raw, raw_name = sigma_diff(run["fitter"], flagship["fitter"])
        print(f"  against phase 11's fit from the archive: {raw:.3g} sigma ({raw_name}; the "
              "tim's six-decimal frequencies)")
        arch = load_prepared(FLAGSHIP_ARCHIVE, device=device)
        arch["freq_mhz"] = main["tensor"]["freq_mhz"].clone()
        same_freq = run_main_path(fresh_fitter(arch, device, "flagship"), device)
        worst, name = sigma_diff(run["fitter"], same_freq["fitter"])
        check(worst <= 1e-3, f"tim fit within 1e-3 sigma of the archive's fit with the tim's "
                             f"frequencies ({worst:.3g} sigma, {name})")
    res = run["fitter"].result
    summary["prepare"] = {
        "scale": scale, "flagship_stage_s": main["stage_s"],
        "flagship_prepare_wall_s": main["wall_s"], "twin_prepare_wall_s": twin["wall_s"],
        "archive_errs": arch_errs, "k45_errs": errs,
        "tim_fit": {"fit_wall_s": run["fit_s"], "grid_wall_s": run["grid_s"],
                    "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
                    "grid_rel_err": worst_g, "vs_archive_sigma": raw,
                    "vs_archive_same_freq_sigma": worst,
                    "grid_chi2": run["chi2"].tolist()}}
    n = len(main["toas"])
    recs = {"site_geometry": k4_record(n, device, 50),
            "analytic_ephemeris": k5_record(n, device, 20)}
    for name, record in (("site_geometry", k4_record), ("analytic_ephemeris", k5_record)):
        recs[name].update({f"scale_{k}": v for k, v in record(PREPARE_N, device, 5).items()
                           if k in ("ms", "call_ms", "plain_ms", "bound_ms", "shape")})
    out_errs = {"site_geometry": errs["k4_pos_err_m"],
                "analytic_ephemeris": max(errs["k5_2_pos_err_m"], errs["k5_11_pos_err_m"])}
    return {"recs": recs, "errs": out_errs, "prepare": pl, "fit": fit_l, "grid": grid_l}



# --- phases 18-22: pint_tpu's default ephemeris (K6, K7) and the fit from it ----------

#: the flagship's epochs (profiles.flagship_smoke_dataset) and the span of the
#: SPK kernel phase 22 exports from the window (TZR epoch 57000.1 included)
FLAGSHIP_SPAN_MJD = (56650.0, 57350.0)
EXPORT_SPAN_MJD = (56600.0, 57400.0)
MINI_DE = REPO / "tests" / "data" / "mini_de.bsp"
# K6's float64 operations, counted from csrc/nbody_serve.cu with a sine or
# cosine as ~35: per (epoch, body) the cell, the Hermite weights and the two
# sums (~60); per design column added into the two sums 12; per trusted
# period its sine and cosine and its four columns and derivatives (~84); the
# polynomial columns ~25
K6_OPS_HERMITE, K6_OPS_COLUMN, K6_OPS_PERIOD, K6_OPS_POLY = 60, 12, 84, 25
# K7's per (epoch, row): per coefficient the recurrence and its derivative
# (7) and the two sums over xyz (12), ~10 for the record and tau; per (epoch,
# body) 12 for the chain sums and km -> m
K7_OPS_PER_COEF, K7_OPS_PER_ROW, K7_OPS_PER_BODY = 19, 10, 12


def jcent(mjd):
    return (mjd - 51544.5) / 36525.0


def window_epochs(nb, n: int, seed: int = 37):
    """n TDB centuries over the window's grid: a quarter on grid nodes (some
    land on a node exactly), both ends, the rest uniform."""
    import numpy as np

    from pint_tpu_torch.astro.nbody import CENT_S

    rng = np.random.default_rng(seed)
    g = nb.grid_s
    t = np.concatenate([g[rng.integers(0, g.size, n // 4)], g[[0, -1]],
                        rng.uniform(g[0], g[-1], n - n // 4 - 2)])
    T = nb.t0 + t / CENT_S
    return T, int(np.sum(np.isin((T - nb.t0) * CENT_S, g)))


def pack_epochs(pack, n: int, seed: int = 41):
    """n TDB centuries inside the pack's coverage of its first body: every
    record edge of every row, both ends, the rest uniform."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = max(pack.span_et(b)[0] for b in pack.bodies), min(pack.span_et(b)[1]
                                                                for b in pack.bodies)
    edges = np.concatenate([pack.init[i] + pack.intlen[i] * np.arange(pack.nrec[i] + 1)
                            for i in range(len(pack.bodies))])
    et = np.clip(np.concatenate([edges, [lo, hi], rng.uniform(lo, hi, n - edges.size - 2)]),
                 lo, hi)
    return et / (36525.0 * 86400.0)


def max_dist(got: dict, want: dict) -> tuple[float, float, bool]:
    """(position, velocity) max distances over bodies, and bitwise equality."""
    import torch

    ep = max(float(torch.max(torch.abs(got[b][0] - want[b][0]))) for b in want)
    ev = max(float(torch.max(torch.abs(got[b][1] - want[b][1]))) for b in want)
    same = all(torch.equal(got[b][0], want[b][0]) and torch.equal(got[b][1], want[b][1])
               for b in want)
    return ep, ev, same


def phase_k67(device) -> dict:
    """The flagship window and its pack snapshot, built once each (timed);
    K6 and K7 against their twins at PREPARE_N epochs; K7 on the mini kernel
    against the host SPK reader."""
    import numpy as np
    import torch

    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro import kernel_ephemeris as ke
    from pint_tpu_torch.astro.ephemeris import get_ephemeris, stage_sink
    from pint_tpu_torch.astro.nbody import _BODIES
    from pint_tpu_torch.astro.spk import SPKEphemeris

    eph = get_ephemeris()
    T_data = jcent(np.array(FLAGSHIP_SPAN_MJD))
    with stage_sink({"nbody_build": 0.0, "kernel_build": 0.0}) as stages:
        t0 = time.perf_counter()
        nb = eph._nbody_for(T_data)
        window_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pack = ke.pack_for_analytic(eph, T_data)
        pack_s = time.perf_counter() - t0
    check(nb.grid_s.size == 8767 and (nb.t0, 2 * nb.half_span_s / 86400 / 365.25) == (0.15, 12.0),
          f"flagship window: t0 {nb.t0}, {nb.grid_s.size} samples of {len(_BODIES)} bodies, "
          f"built in {window_s:.2f} s (nbody_build stage {stages['nbody_build']:.2f} s)")
    check(pack.coef.shape[0] == 11, f"pack snapshot {pack.coef.shape} built in {pack_s:.2f} s "
                                    f"(kernel_build stage {stages['kernel_build']:.2f} s)")
    out = {"window_build_s": window_s, "pack_build_s": pack_s,
           **{f"{k}_stage_s": v for k, v in stages.items()}}

    T_np, exact = window_epochs(nb, PREPARE_N)
    T = torch.as_tensor(T_np, device=device)
    got, want = dp.nbody_serve(nb, _BODIES, T), dp.nbody_serve_plain(nb, _BODIES, T)
    sync(device)
    ep, ev, same = max_dist(got, want)
    tag = f"K6 N={PREPARE_N} ({exact} exactly on grid nodes), {len(_BODIES)} bodies"
    check(ep <= 1e-6, f"{tag}: positions within 1e-6 m of the twin ({ep:.3g} m, bitwise {same})")
    check(ev <= 1e-9, f"{tag}: velocities within 1e-9 m/s of the twin ({ev:.3g} m/s)")
    got = dp.nbody_posvel(nb, ("emb",), T_np, device)["emb"]
    with twins():
        want = dp.nbody_posvel(nb, ("emb",), T_np, device)["emb"]
    e_emb = float(np.max(np.abs(got[0] - want[0])))
    v_emb = float(np.max(np.abs(got[1] - want[1])))
    check(e_emb <= 1e-6 and v_emb <= 1e-9, f"K6 EMB (Earth and Moon combined after the launch) "
                                           f"within 1e-6 m, 1e-9 m/s ({e_emb:.3g}, {v_emb:.3g})")
    out.update(k6_pos_err_m=max(ep, e_emb), k6_vel_err_m_s=max(ev, v_emb), k6_bitwise=same)

    mini = ke.pack_from_spk(str(MINI_DE))
    for label, pk in (("N-body pack", pack), ("mini_de.bsp pack", mini)):
        Tp_np = pack_epochs(pk, PREPARE_N)
        Tp = torch.as_tensor(Tp_np, device=device)
        got = dp.chebyshev_eval(pk, pk.bodies, Tp)
        want = dp.chebyshev_eval_plain(pk, pk.bodies, Tp)
        sync(device)
        ep, ev, same = max_dist(got, want)
        tag = f"K7 {label} {tuple(pk.coef.shape)} N={PREPARE_N}, {len(pk.bodies)} bodies"
        check(ep <= 1e-6, f"{tag}: positions within 1e-6 m of the twin ({ep:.3g} m, bitwise "
                          f"{same})")
        check(ev <= 1e-9, f"{tag}: velocities within 1e-9 m/s of the twin ({ev:.3g} m/s)")
        key = "k7_nbody" if pk is pack else "k7_mini"
        out.update({f"{key}_pos_err_m": ep, f"{key}_vel_err_m_s": ev, f"{key}_bitwise": same})
    # `got` and `Tp_np` are the mini kernel's, from the loop's last pass
    reader = SPKEphemeris(str(MINI_DE))
    rp = max(float(np.max(np.abs(got[b][0].cpu().numpy() - reader.posvel_ssb(b, Tp_np)[0])))
             for b in mini.bodies)
    rv = max(float(np.max(np.abs(got[b][1].cpu().numpy() - reader.posvel_ssb(b, Tp_np)[1])))
             for b in mini.bodies)
    check(rp <= 1e-3 and rv <= 1e-7, f"K7 mini_de.bsp within 1 mm and 1e-7 m/s of the host SPK "
                                     f"reader ({rp:.3g} m, {rv:.3g} m/s)")
    out.update(k7_vs_reader_m=rp, k7_vs_reader_m_s=rv)
    return {"errs": out, "window": nb, "pack": pack}


def k6_record(nb, n: int, bodies, device, reps: int) -> dict:
    """K6 over n epochs of the flagship window for `bodies`; the library
    yardstick is torch.matmul of the (n, 39) Earth design by corr_e."""
    import numpy as np
    import torch

    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.nbody import CENT_S, band_design

    T_np = np.sort(window_epochs(nb, n)[0])
    T = torch.as_tensor(T_np, device=device)
    ms, call = measure(lambda: dp.nbody_serve(nb, bodies, T), device, reps, K6_KERNEL)
    plain, plain_call = measure(lambda: dp.nbody_serve_plain(nb, bodies, T), device, 3)
    w = nb.tensors(device)
    G, _ = band_design((T - nb.t0) * CENT_S, nb._periods_e, nb.half_span_s)
    lib, lib_call = measure(lambda: torch.matmul(G, w["corr_e"]), device, reps)
    # read the epochs, the grid samples the epochs fall between (once each)
    # and both corrections; write pos and vel of each body
    k = np.floor(((T_np - nb.t0) * CENT_S - nb.grid_s[0]) / (nb.grid_s[1] - nb.grid_s[0]))
    samples = np.unique(np.concatenate([k, k + 1])).size
    ne, nm = len(nb._periods_e), len(nb._periods_m)
    n_bytes = n * 8 + samples * len(bodies) * 6 * 8 + (nb._corr_e.size + nb._corr_m.size) * 8 \
        + n * len(bodies) * 6 * 8
    band_e = K6_OPS_POLY + (7 + 4 * ne) * K6_OPS_COLUMN + ne * K6_OPS_PERIOD
    band_m = K6_OPS_POLY + (7 + 4 * nm) * K6_OPS_COLUMN + nm * K6_OPS_PERIOD
    per_epoch = sum(K6_OPS_HERMITE + (band_e if b in ("earth", "moon") else 0)
                    + (band_m if b == "moon" else 0) for b in bodies)
    b, how = bound_ms(n_bytes, n * per_epoch)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": lib,
            "call_ms": call, "plain_call_ms": plain_call, "library_call_ms": lib_call,
            "shape": f"N={n} bodies={','.join(bodies)} G={nb.grid_s.size}"}


def k7_record(pack, n: int, bodies, device, reps: int, T_np=None) -> dict:
    """K7 over n epochs (the flagship's span unless given) for `bodies`."""
    import numpy as np
    import torch

    from pint_tpu_torch.astro import device_prepare as dp

    if T_np is None:
        T_np = np.sort(jcent(np.random.default_rng(43).uniform(*FLAGSHIP_SPAN_MJD, n)))
    T = torch.as_tensor(T_np, device=device)
    ms, call = measure(lambda: dp.chebyshev_eval(pack, bodies, T), device, reps, K7_KERNEL)
    plain, plain_call = measure(lambda: dp.chebyshev_eval_plain(pack, bodies, T), device, 3)
    # read the epochs and each record the epochs select (once); write pos, vel
    et = T_np * 36525.0 * 86400.0
    C = pack.coef.shape[2]
    rows = sorted({r for b in bodies for r in pack.chain_rows(b)})
    records = sum(np.unique(np.clip(np.floor((et - pack.init[r]) / pack.intlen[r]), 0,
                                    pack.nrec[r] - 1)).size for r in rows)
    n_bytes = n * 8 + records * (3 * C + 1) * 8 + n * len(bodies) * 6 * 8
    per_epoch = sum(K7_OPS_PER_BODY + len(pack.chain_rows(b)) * (K7_OPS_PER_COEF * C
                                                                 + K7_OPS_PER_ROW)
                    for b in bodies)
    b, how = bound_ms(n_bytes, n * per_epoch)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "library": "none: no torch call sums a Chebyshev series",
            "call_ms": call, "plain_call_ms": plain_call,
            "shape": f"N={n} bodies={','.join(bodies)} pack={tuple(pack.coef.shape)}"}


def compare_tensors(got, want, label: str) -> dict:
    """The prepared tensor rows of two paths (the TZR row included): t within
    1 ps, positions within 1 mm, velocities within 1e-4 m/s, the rest equal."""
    import torch

    dt = float(torch.max(torch.abs((got["t_hi"] - want["t_hi"]) + (got["t_lo"] - want["t_lo"]))))
    errs = {"t_s": dt}
    check(dt <= 1e-12, f"{label}: tensor t within 1 ps ({dt:.3g} s)")
    for k, tol in (("ssb_obs_pos_ls", 1e-3), ("obs_sun_pos_ls", 1e-3), ("ssb_obs_vel_ls", 1e-4)):
        errs[k] = float(torch.max(torch.abs(got[k] - want[k]))) * C_M_PER_S
        check(errs[k] <= tol, f"{label}: tensor {k} within {tol:g} ({errs[k]:.3g} m or m/s)")
    for k in want:
        if not k.startswith(("t_", "ssb_", "obs_")):
            check(torch.equal(got[k], want[k]), f"{label}: tensor {k} equal")
    return errs


#: phases 21-22: the pack snapshot and the SPK export of the flagship window
#: against its direct serve, the Earth (m, m/s) and the GLS fit (sigma). A
#: Chebyshev record cannot follow the window's C1 Hermite serve closer:
#: pint_tpu's own snapshot is 5.88 m, 5.4e-4 m/s and 0.060 sigma from its
#: direct serve, read by the slow test tests/test_torch_kernel_ephem.py::
#: test_pint_tpu_snapshot_of_the_flagship_window, which holds it to these
SNAPSHOT_LIMITS = {"earth_m": 10.0, "earth_m_s": 1e-3, "fit_sigma": 0.1}


def fit_only(tensor, device) -> dict:
    """The flagship GLS fit from the moved start, in a launch window."""
    out = {"launches": {}}
    ftr = fresh_fitter(tensor, device, "flagship")
    with counted(out["launches"]):
        t0 = time.perf_counter()
        ftr.fit_toas()
        sync(device)
        out["fit_s"] = time.perf_counter() - t0
    out["fitter"] = ftr
    return out


def other_ephemeris(device, tmp: Path, label: str, base: dict, base_fit) -> dict:
    """Phases 21-22: the flagship N-body .tim prepared under the current
    settings (K7, not K6, launched twice: the TOAs and the TZR row), against
    the same path through the twins, and against phase 19's columns and
    phase 20's fit: Earth within 10 m and 1e-3 m/s, the fit within 0.1
    sigma (`SNAPSHOT_LIMITS`; pint_tpu's 0.05 m pack-vs-direct bound holds
    for the analytic series only)."""
    import numpy as np

    from pint_tpu_torch.prepared import FLAGSHIP_NBODY_TIM

    main = flagship_tim_path(device, tmp, FLAGSHIP_NBODY_TIM)
    pl = main["launches"]
    want = 2 if device.type == "cuda" else 0
    check(pl["chebyshev_eval"] == want and pl["nbody_serve"] == 0
          and pl["analytic_ephemeris"] == 0,
          f"{label}: chebyshev_eval launched {pl['chebyshev_eval']} times, nbody_serve "
          f"{pl['nbody_serve']}, analytic_ephemeris {pl['analytic_ephemeris']}")
    print(f"  ephemeris {main['toas'].ephem}; stage walls (s): " + json.dumps(main["stage_s"])
          + f"; get_model_and_toas + build_tensor {main['wall_s']:.3f} s")
    with twins():
        twin = flagship_tim_path(device, tmp, FLAGSHIP_NBODY_TIM)
    errs = {"twin": compare_toas(main["toas"], twin["toas"], f"{label} kernels vs twins")}
    errs["twin_tensor"] = compare_tensors(main["tensor"], twin["tensor"], f"{label}")
    ep = float(np.max(np.abs(main["toas"].ssb_obs_pos_m - base["toas"].ssb_obs_pos_m)))
    ev = float(np.max(np.abs(main["toas"].ssb_obs_vel_m_s - base["toas"].ssb_obs_vel_m_s)))
    lim = SNAPSHOT_LIMITS
    check(ep <= lim["earth_m"] and ev <= lim["earth_m_s"],
          f"{label}: Earth within {lim['earth_m']:g} m and {lim['earth_m_s']:g} m/s of the "
          f"window's (phase 19) ({ep:.4g} m, {ev:.3g} m/s)")
    run = fit_only(main["tensor"], device)
    res = run["fitter"].result
    check(res.converged and 0.8 <= res.reduced_chi2 <= 1.2,
          f"{label} fit converged, chi2/dof = {res.reduced_chi2:.6f}")
    worst, name = sigma_diff(run["fitter"], base_fit)
    check(worst <= lim["fit_sigma"], f"{label} fit within {lim['fit_sigma']:g} sigma of phase "
                                     f"20's ({worst:.3g} sigma, {name})")
    for k in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
        check(run["launches"][k] > 0 or device.type != "cuda",
              f"{k} launched {run['launches'][k]} times by the {label} fit")
    errs.update(earth_vs_window_m=ep, earth_vs_window_m_s=ev, fit_vs_window_sigma=worst)
    return {"errs": errs, "prepare": pl, "fit": run["launches"], "stage_s": main["stage_s"],
            "wall_s": main["wall_s"], "fit_s": run["fit_s"], "chi2_reduced": res.reduced_chi2,
            "ephem": main["toas"].ephem}


def ephemeris_phases(device, summary: dict) -> dict:
    """Phases 18-22: pint_tpu's default ephemeris (the N-body window, K6), its
    Chebyshev pack snapshot and an SPK kernel exported from it (K7), and the
    flagship fit from each."""
    from pint_tpu_torch.astro.spk_write import export_spk
    from pint_tpu_torch.prepared import FLAGSHIP_NBODY_TIM

    with tempfile.TemporaryDirectory() as tmpname, knobs(
            PINT_TPU_NBODY=None, PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None,
            PINT_TPU_CACHE_DIR=str(Path(tmpname) / "cache")):
        tmp = Path(tmpname)
        print("phase 18: the flagship N-body window and pack; K6 nbody_serve and K7 "
              "chebyshev_eval against their twins")
        k67 = phase_k67(device)
        nb, pack = k67["window"], k67["pack"]

        print("phase 19: get_model_and_toas + build_tensor under pint_tpu's default ephemeris")
        main = flagship_tim_path(device, tmp, FLAGSHIP_NBODY_TIM)
        pl = main["launches"]
        want = 2 if device.type == "cuda" else 0
        check(pl["nbody_serve"] == want and pl["site_geometry"] == want,
              f"nbody_serve launched {pl['nbody_serve']} times, site_geometry "
              f"{pl['site_geometry']} (the TOAs and the TZR row)")
        check(pl["analytic_ephemeris"] == 0 and pl["chebyshev_eval"] == 0,
              f"analytic_ephemeris launched {pl['analytic_ephemeris']} times, chebyshev_eval "
              f"{pl['chebyshev_eval']}")
        check(main["toas"].ephem == "analytic" and "nbody_build" not in main["stage_s"],
              f"the window was built once, in phase 18 ({k67['errs']['window_build_s']:.2f} s); "
              "the prepare served it")
        print("  stage walls (s): " + json.dumps(main["stage_s"])
              + f"; get_model_and_toas + build_tensor {main['wall_s']:.3f} s")
        with twins():
            twin = flagship_tim_path(device, tmp, FLAGSHIP_NBODY_TIM)
        nb_errs = {"twin": compare_toas(main["toas"], twin["toas"], "default ephemeris kernels "
                                                                    "vs twins"),
                   "twin_tensor": compare_tensors(main["tensor"], twin["tensor"],
                                                  "default ephemeris")}

        print("phase 20: GLS fit and (M2, SINI) grid from the default-ephemeris TOAs")
        run = run_main_path(fresh_fitter(main["tensor"], device, "flagship"), device)
        fit_l, grid_l = run["fit_launches"], run["grid_launches"]
        for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
            for what, counts in (("fit_toas", fit_l), ("grid_chisq", grid_l)):
                check(counts[name] > 0 or device.type != "cuda",
                      f"{name} launched {counts[name]} times by the {what}")
        with twins():
            twin_run = run_main_path(fresh_fitter(twin["tensor"], device, "flagship"),
                                     device)
        check_fit(run, twin_run, "default-ephemeris GLS")
        worst_g = check_grid(run, twin_run, "default-ephemeris")

        print("phase 21: PINT_TPU_KERNEL_EPHEM=1, the window's pack snapshot (K7)")
        with knobs(PINT_TPU_KERNEL_EPHEM="1"):
            pk = other_ephemeris(device, tmp, "pack snapshot", main, run["fitter"])

        print("phase 22: PINT_TPU_EPHEM, an SPK kernel exported from the window (K7)")
        spk = tmp / "flagship_window.bsp"
        t0 = time.perf_counter()
        export_spk(str(spk), *EXPORT_SPAN_MJD, device=device)
        export_s = time.perf_counter() - t0
        print(f"  exported MJD {EXPORT_SPAN_MJD} in {export_s:.2f} s ({spk.stat().st_size} bytes)")
        with knobs(PINT_TPU_EPHEM=str(spk)):
            sp = other_ephemeris(device, tmp, "SPK export", main, run["fitter"])
        check(sp["ephem"].startswith("kernelpack:spk:"), f"served as {sp['ephem']}")

        n = len(main["toas"])
        recs = {"nbody_serve": k6_record(nb, n, ("earth", "sun"), device, 50),
                "chebyshev_eval": k7_record(pack, n, ("earth", "sun"), device, 50)}
        from pint_tpu_torch.astro.nbody import _BODIES

        recs["nbody_serve"].update({f"scale_{k}": v for k, v in k6_record(
            nb, PREPARE_N, _BODIES, device, 5).items()
            if k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "library_call_ms", "shape")})
        recs["chebyshev_eval"].update({f"scale_{k}": v for k, v in k7_record(
            pack, PREPARE_N, pack.bodies, device, 5).items()
            if k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "shape")})
    res = run["fitter"].result
    summary["ephemeris"] = {
        **{k: v for k, v in k67["errs"].items()},
        "default_stage_s": main["stage_s"], "default_prepare_wall_s": main["wall_s"],
        "default_twin_prepare_wall_s": twin["wall_s"], "default_errs": nb_errs,
        "default_fit": {"fit_wall_s": run["fit_s"], "grid_wall_s": run["grid_s"],
                        "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
                        "grid_rel_err": worst_g, "grid_chi2": run["chi2"].tolist()},
        "pack": {k: v for k, v in pk.items() if k not in ("prepare", "fit")},
        "spk": {**{k: v for k, v in sp.items() if k not in ("prepare", "fit")},
                "export_s": export_s}}
    errs = {"nbody_serve": k67["errs"]["k6_pos_err_m"],
            "chebyshev_eval": max(k67["errs"]["k7_nbody_pos_err_m"],
                                  k67["errs"]["k7_mini_pos_err_m"])}
    return {"recs": recs, "errs": errs,
            "windows": {"nbody_prepare": pl, "nbody_fit": fit_l, "nbody_grid": grid_l,
                        "pack_prepare": pk["prepare"], "pack_fit": pk["fit"],
                        "spk_prepare": sp["prepare"], "spk_fit": sp["fit"]}}


# --- phases 23-26: eccentric binaries (K1's Kepler instance) ------------------------

#: phase 25's bound between the DD grid and the twin path's grid from its own
#: fit: about 5 ulp of the fitted RAJ (one ulp moves the grid by 2.1e-10
#: relative on an H100)
DD_GRID_OWN_FITS_TOL = 1e-9


def fit_distance(main: dict, twin: dict) -> float:
    """The largest relative distance between two fits' parameters."""
    vals, ref = main["fitter"].values(), twin["fitter"].values()
    return max(abs(vals[n] - ref[n]) / abs(ref[n]) for n in vals)


def ulp_sensitivity(ftr, names, vals, chi2, param: str) -> float:
    """The largest relative change of the grid's chi^2 when the fitted
    `param` (a float64 leaf) moves up by one ulp."""
    import numpy as np
    import torch

    from pint_tpu_torch.gridutils import grid_chisq

    model = ftr.model
    saved = model.params
    v = saved[param]
    model.params = dict(saved, **{param: torch.nextafter(v, v.new_full((), math.inf))})
    try:
        moved = grid_chisq(ftr, names, vals)
    finally:
        model.params = saved
    return float(np.max(np.abs(moved - chi2) / chi2))


def dd_phases(device, summary: dict) -> dict:
    """Phases 23-26: profiles.DD_SMOKE_PAR from pint_tpu_torch/data/
    dd_n16384.tim through K1's Kepler instance: K1 against its twin (DD at
    the fit's and the grid's shapes and with every lane; BT and DDS), the
    prepare, the WLS fit and the (M2, SINI) grid against the twin path, and
    their times."""
    import numpy as np

    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import DD_TIM
    from pint_tpu_torch.profiles import DD_SMOKE_PAR, dd_smoke_par, grid_for
    from pint_tpu_torch.residuals import lane_names

    with tempfile.TemporaryDirectory() as tmpname, knobs(
            PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
        tmp = Path(tmpname)
        print("phase 23: K1's Kepler instance against its twin (dd_n16384.tim)")
        main = flagship_tim_path(device, tmp, DD_TIM, DD_SMOKE_PAR)
        tensor = main["tensor"]
        start = fresh_fitter(tensor, device, "dd")
        model = start.model
        free = tuple(model.free_params)
        names, _, params_b = grid_params(model, start)
        grid_free = tuple(n for n in free if n not in names)
        fit_lanes = linear_split(model, free)[0]
        grid_lanes = linear_split(model, grid_free)[0]
        check(len(fit_lanes) == 10 and len(grid_lanes) == 10 and names == ("M2", "SINI"),
              f"DD: {len(free)} free parameters, {len(fit_lanes)} fit lanes, "
              f"{len(grid_lanes)} grid lanes, grid over {names}")
        stats = phase_k1(model, tensor, params_b, fit_lanes, grid_lanes, device, 1e-12, "DD ")
        for binary in ("DD", "BT", "DDS"):
            m = get_model(dd_smoke_par(binary), from_text=True, device=device)
            every = lane_names(m.params)
            stats[f"{binary}_every"] = compare_k1(m, m.params, tensor, every, device, 1e-12,
                                                  f"K1 {binary} every lane ({len(every)} lanes)")

        print("phase 24: get_model_and_toas + build_tensor and DownhillWLSFitter.fit_toas "
              "(DD)")
        pl = main["launches"]
        want = 2 if device.type == "cuda" else 0
        for name in ("site_geometry", "analytic_ephemeris"):
            check(pl[name] == want, f"{name} launched {pl[name]} times (the TOAs and the TZR row)")
        print("  stage walls (s): " + json.dumps(main["stage_s"])
              + f"; get_model_and_toas + build_tensor {main['wall_s']:.3f} s")
        with twins():
            twin = flagship_tim_path(device, tmp, DD_TIM, DD_SMOKE_PAR)
        compare_tensors(tensor, twin["tensor"], "DD prepare kernels vs twins")
        run = run_main_path(fresh_fitter(tensor, device, "dd"), device)
        fit_l, grid_l = run["fit_launches"], run["grid_launches"]
        for name in ("dd_elementwise", "resid_tangent"):
            check(fit_l[name] > 0 or device.type != "cuda",
                  f"{name} launched {fit_l[name]} times by the DD fit_toas")
        with twins():
            twin_run = run_main_path(fresh_fitter(twin["tensor"], device, "dd"), device)
        check_fit(run, twin_run, "DD WLS")

        print("phase 25: grid_chisq 3x3 (M2, SINI) around the DD fit")
        # the twins' grid from the same fitted model: this grid's chi^2 moves
        # by ~2e-10 relative when the fitted RAJ moves by one ulp (measured
        # below), so two fits an ulp apart cannot hold 1e-10 between grids;
        # the twin path's grid from its own fit is held to a few ulp of RAJ
        gnames, gvals = grid_for(run["fitter"].model, run["fitter"])
        with twins():
            same_start = {"chi2": grid_chisq(run["fitter"], gnames, gvals)}
        worst_g = check_grid(run, same_start, "DD (from the same fit)")
        sens = ulp_sensitivity(run["fitter"], gnames, gvals, run["chi2"], "RAJ")
        apart = float(np.max(np.abs(run["chi2"] - twin_run["chi2"]) / twin_run["chi2"]))
        print(f"  one ulp of the fitted RAJ moves this grid by {sens:.3g} relative")
        check(apart <= DD_GRID_OWN_FITS_TOL,
              f"DD grid within {DD_GRID_OWN_FITS_TOL:g} relative of the twin path's grid from "
              f"its own fit ({apart:.3g}; the fits {fit_distance(run, twin_run):.3g} "
              f"relative apart)")
        argmin = int(np.argmin(run["chi2"]))
        check(argmin == 4, f"DD grid chi2 minimum at the centre point, the truth (argmin {argmin})")
        for name in ("resid_tangent", "normal_eq"):
            check(grid_l[name] > 0 or device.type != "cuda",
                  f"{name} launched {grid_l[name]} times by the DD grid_chisq")
        print("  K2 at the DD grid's first step (p = 10)")
        w = 1.0 / start.resids.errors_s**2
        r, M, k2_err = phase_k2(model, tensor, params_b, grid_free, w, device)

        print("phase 26: K1's Kepler instance times, DD warm wall and busy share")
        recs = {"resid_tangent": {
            k: v for shape, params, lanes in (("fit", model.params, fit_lanes),
                                              ("grid", params_b, grid_lanes))
            for k, v in k1_kept(summary, f"dd {shape}",
                                k1_record(model, tensor, params, lanes, device, 20),
                                f"kepler_{shape}_").items()},
            "normal_eq": {f"dd_{k}": v for k, v in k2_record(r, M, w, device).items()}}
        if device.type == "cuda":
            summary["dd_profile"] = profile_main_path(tensor, device, "dd")
    res = run["fitter"].result
    summary["dd"] = {
        "prepare_wall_s": main["wall_s"], "prepare_stage_s": main["stage_s"],
        "twin_prepare_wall_s": twin["wall_s"], "fit_wall_s": run["fit_s"],
        "grid_wall_s": run["grid_s"], "fit_iterations": res.iterations,
        "fit_chi2_reduced": res.reduced_chi2, "grid_chi2": run["chi2"].tolist(),
        "grid_argmin": argmin, "grid_rel_err": worst_g, "grid_rel_err_own_fits": apart,
        "grid_raj_ulp_sensitivity": sens, "free": list(free),
        "k1_stats": stats}
    errs = {"resid_tangent": max(v["max_abs_err"] for v in stats.values()),
            "normal_eq": k2_err}
    return {"recs": recs, "errs": errs,
            "windows": {"dd_prepare": pl, "dd_fit": fit_l, "dd_grid": grid_l}}


#: phase 32: the NANOGrav grid's distance from the twin path's grid of its
#: own fit
NANOGRAV_GRID_OWN_FITS_TOL = 1e-8


def perturbed_normal_eq(plain, eps: float = 1e-15):
    """`plain` (K3's twin) with every normal matrix G it returns moved by
    eps * S_ij * sqrt(G_ii G_jj), S a fixed symmetric pattern of +-1: the
    size of the difference two paths whose sums run in other orders show (a
    sum's rounding scales with the norms of its terms, not with the sum)."""
    import numpy as np
    import torch

    def perturbed(*args, **kw):
        G, *rest = plain(*args, **kw)
        p = G.shape[-1]
        sign = torch.as_tensor(np.random.default_rng(5).choice([-1.0, 1.0], (p, p)),
                               device=G.device)
        sign = torch.triu(sign) + torch.triu(sign, 1).T
        d = torch.sqrt(torch.abs(torch.diagonal(G, dim1=-2, dim2=-1)))
        return (G + eps * sign * d[..., :, None] * d[..., None, :], *rest)

    return perturbed


def grid_sensitivity(ftr, names, vals, chi2, eps: float = 1e-15) -> float:
    """How far the grid `chi2` (the twins') moves when every normal matrix of
    its refit steps, white or GLS, is perturbed by `eps` of its diagonal
    (`perturbed_normal_eq`), through the twins: the size of the differences
    two paths must show where the refit amplifies them."""
    import numpy as np

    from pint_tpu_torch import gridutils

    with twins():
        plain = gridutils.normal_eq, gridutils.ecorr_normal_eq
        gridutils.normal_eq, gridutils.ecorr_normal_eq = (perturbed_normal_eq(f, eps)
                                                          for f in plain)
        try:
            moved = gridutils.grid_chisq(ftr, names, vals)
        finally:
            gridutils.normal_eq, gridutils.ecorr_normal_eq = plain
    return float(np.max(np.abs(moved - chi2) / chi2))


def perturbed_design(plain, eps: float = 1e-15):
    """`plain` (``wls.time_resid_design``) with every design column moved by
    eps times its largest value, with a fixed pattern of signs: the size of
    the difference between K1's tangents and the twin's (~5e-16 of a lane's
    scale), the WLS fit's counterpart of `perturbed_normal_eq`."""
    import numpy as np
    import torch

    def perturbed(*args, **kw):
        r0, M = plain(*args, **kw)
        sign = torch.as_tensor(np.random.default_rng(6).choice([-1.0, 1.0], M.shape[-1]),
                               device=M.device)
        return r0, M + eps * sign * torch.max(torch.abs(M), dim=0).values
    return perturbed


def perturbed_fit(tensor, device, which: str, par: str | None = None) -> dict:
    """The twin path's fit with every GLS normal matrix perturbed by 1e-15
    of its diagonal (`perturbed_normal_eq`), or, for a WLS fit, every design
    column by 1e-15 of its scale (`perturbed_design`): the witness of how far
    two fits of an ill-conditioned model may sit apart (`fit_bounds`)."""
    from pint_tpu_torch.fitting import gls, wideband, wls

    with twins():
        ftr = fresh_fitter(tensor, device, which, par)
        plain = gls.ecorr_normal_eq, wls.time_resid_design, wideband.ecorr_normal_eq
        gls.ecorr_normal_eq = perturbed_normal_eq(plain[0])
        wls.time_resid_design = perturbed_design(plain[1])
        wideband.ecorr_normal_eq = perturbed_normal_eq(plain[2])
        try:
            ftr.fit_toas()
        finally:
            gls.ecorr_normal_eq, wls.time_resid_design, wideband.ecorr_normal_eq = plain
    return {"fitter": ftr}


def k8_record(model, params, tensor, device, reps: int) -> dict:
    """K8 at the grid's first step (the linear columns of B parameter sets)
    and at the fit's Fourier basis. No single torch call forms timing
    columns or a Fourier design, so there is no library yardstick."""
    from pint_tpu_torch.fitting.design import (fourier_basis, linear_columns,
                                               linear_columns_plain, linear_split)
    from pint_tpu_torch.models.noise import fourier_basis_plain, fourier_freqs
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.residuals import resid_tangent

    _, lin, owners = linear_split(model, tuple(model.free_params))
    out = resid_tangent(model, params, tensor)
    p1 = {k: (DD(v.hi[:, None], v.lo[:, None]) if isinstance(v, DD) else v[:, None])
          for k, v in params.items()}
    sl = slice(None, -1)
    args = (model, p1, tensor, out.f, sl, lin, owners)
    ms, call = measure(lambda: linear_columns(*args, out.fb), device, reps, K8_KERNELS[0])
    plain, plain_call = measure(lambda: linear_columns_plain(*args), device, max(1, reps // 10))
    B, n = out.f.shape
    L, n_rows = len(lin), tensor["t_hi"].shape[0]
    n_dmx = sum(1 for x in lin if x.startswith("DMX_"))
    # read fb, f, t and the one-hot columns and masks the columns use; write
    # the (B, L, N) columns. ~3 operations per DMX/DM value, ~45 per FD value
    # (a log and the powers), ~2 per JUMP value, each at two rows (the TZR's)
    n_bytes = (B * (n_rows + n) + 2 * n_rows + n_rows * n_dmx + n_rows) * 8 + B * L * n * 8
    n_ops = B * n * 2 * sum(45 if x.startswith("FD") else 3 for x in lin)
    b, how = bound_ms(n_bytes, n_ops)
    t = tensor["t_hi"][sl]
    freqs = fourier_freqs(model["PLRedNoise"].nf, tensor["noise_tspan"][0, 0])
    fms, fcall = measure(lambda: fourier_basis(t, freqs), device, reps, K8_KERNELS[1])
    fplain, _ = measure(lambda: fourier_basis_plain(t, freqs), device, max(1, reps // 10))
    nf = freqs.shape[0]
    # read t, write (2 nf, N); a sine and a cosine (~70 operations) per pair
    fb_, fhow = bound_ms((n + nf) * 8 + 2 * nf * n * 8, nf * n * 72)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call,
            "shape": f"columns B={B} N={n} L={L} (DMX {n_dmx})",
            "fourier_ms": fms, "fourier_call_ms": fcall, "fourier_plain_ms": fplain,
            "fourier_bound_ms": fb_, "fourier_bound_by": fhow,
            "fourier_shape": f"N={n} columns={2 * nf}",
            "library_note": "no torch call forms closed-form timing columns or a Fourier design"}


def phase_k8(model, dm_model, tensor, params_b, device) -> float:
    """K8 against its twin: the grid's first-step linear columns and the
    Fourier bases of the fit (red noise) and of the DM-noise variant."""
    import torch

    import pint_tpu_torch.fitting.design as design
    from pint_tpu_torch.fitting.design import linear_columns, linear_columns_plain, linear_split
    from pint_tpu_torch.models.noise import fourier_basis_plain
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.residuals import resid_tangent

    _, lin, owners = linear_split(model, tuple(model.free_params))
    out = resid_tangent(model, params_b, tensor)
    p1 = {k: (DD(v.hi[:, None], v.lo[:, None]) if isinstance(v, DD) else v[:, None])
          for k, v in params_b.items()}
    args = (model, p1, tensor, out.f, slice(None, -1), lin, owners)
    got, want = linear_columns(*args, out.fb), linear_columns_plain(*args)
    sync(device)
    err = max(rel_err(got[:, j], want[:, j]) for j in range(len(lin)))
    check(err <= 1e-13, f"K8 {len(lin)} linear columns x {got.shape[0]} sets within 1e-13 "
                        f"relative of the twin per column ({err:.3g}; bitwise "
                        f"{torch.equal(got, want)})")
    worst = err
    kernel = design.fourier_basis
    for label, m in (("red noise", model), ("red + DM noise", dm_model)):
        design.fourier_basis = fourier_basis_plain
        try:
            want_b = m.noise_basis_and_weights(m.params, tensor)
        finally:
            design.fourier_basis = kernel
        got_b = m.noise_basis_and_weights(m.params, tensor)
        sync(device)
        e = rel_err(got_b.dense, want_b.dense)
        check(e <= 1e-13 and got_b.kd == want_b.kd,
              f"K8 Fourier basis ({label}, {got_b.kd} columns) within 1e-13 relative of the twin "
              f"({e:.3g})")
        worst = max(worst, e)
    return worst


def nanograv_phases(device, summary: dict, n_dmx: int = 64, nf: int = 30, tim=None) -> dict:
    """Phases 27-33: profiles.nanograv_smoke_par(n_dmx, nf) (at the defaults
    NANOGRAV_SMOKE_PAR: ecliptic astrometry, 64 DMX windows, a JUMP, FD1-3,
    ELL1, ECORR and red noise; 80 free) from `tim` (default
    pint_tpu_torch/data/nanograv_n16384.tim, flagship epochs of 8 TOAs): K1's
    NANOGrav instance, K8 and the dense-basis K3 against their twins, the
    prepare, the GLS fit and the (M2, SINI) grid against the twin path, and
    their times."""
    import numpy as np

    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.fitting.gls import _RIDGE as GLS_RIDGE
    from pint_tpu_torch.fitting.wls import time_resid_design
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import NANOGRAV_TIM
    from pint_tpu_torch.profiles import grid_for, nanograv_smoke_par

    tim, par = tim or NANOGRAV_TIM, nanograv_smoke_par(n_dmx, nf)
    with tempfile.TemporaryDirectory() as tmpname, knobs(
            PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
        tmp = Path(tmpname)
        main = flagship_tim_path(device, tmp, tim, par)
        tensor = main["tensor"]
        start = fresh_fitter(tensor, device, "nanograv", par)
        model = start.model
        free = tuple(model.free_params)
        names, _, params_b = grid_params(model, start)
        grid_free = tuple(n for n in free if n not in names)
        grid_lanes, grid_lin, _ = linear_split(model, grid_free)
        basis = model.noise_basis_and_weights(model.params, tensor)
        n_toas = tensor["t_hi"].shape[0] - 1  # the last row is the TZR's
        # free: 12 K1 lanes, the DMX windows, the JUMP and FD1-3
        want_shape = (n_dmx + 16, n_dmx + 4, n_toas // 8, 2 * nf)
        check((len(free), len(grid_lin), basis.ke, basis.kd) == want_shape
              and len(grid_lanes) == 12,
              f"NANOGrav: {len(free)} free parameters, grid {len(grid_lanes)} lanes + "
              f"{len(grid_lin)} linear columns, {basis.ke} ECORR epochs, {basis.kd} Fourier "
              f"columns")
        print("phase 27: K1's NANOGrav instance against its twin (nanograv_n16384.tim)")
        stats = phase_k1(model, tensor, params_b, free, grid_lanes, device, 1e-12, "NANOGrav ")

        print("phase 28: K8 linear_columns against its twin")
        dm_model = get_model(nanograv_smoke_par(n_dmx, nf, dm_noise=True), from_text=True,
                             device=device)
        k8_err = phase_k8(model, dm_model, tensor, params_b, device)

        print("phase 29: K3 with the dense basis against its twin")
        res = start.resids
        w = 1.0 / res.errors_s**2
        r0, M = time_resid_design(model, free, model.params, tensor, res.weights, True,
                                  hybrid=False)
        dm_basis = dm_model.noise_basis_and_weights(dm_model.params, tensor)
        check(dm_basis.kd == 4 * nf,
              f"the DM-noise variant's basis has {dm_basis.kd} columns")
        k3 = phase_k3(model, tensor, start, params_b, grid_free, device, extra={
            "fit, red + DM noise": (r0[None], M.T[None].contiguous(), w, dm_basis, GLS_RIDGE,
                                    False, False)})

        print("phase 30: get_model_and_toas + build_tensor (NANOGrav)")
        pl = main["launches"]
        want = 2 if device.type == "cuda" else 0
        for name in ("site_geometry", "analytic_ephemeris"):
            check(pl[name] == want, f"{name} launched {pl[name]} times (the TOAs and the TZR row)")
        print("  stage walls (s): " + json.dumps(main["stage_s"])
              + f"; get_model_and_toas + build_tensor {main['wall_s']:.3f} s")
        with twins():
            twin = flagship_tim_path(device, tmp, tim, par)
        compare_tensors(tensor, twin["tensor"], "NANOGrav prepare kernels vs twins")

        print("phase 31: DownhillGLSFitter.fit_toas (NANOGrav, 80 free)")
        run = run_main_path(fresh_fitter(tensor, device, "nanograv", par), device)
        fit_l, grid_l = run["fit_launches"], run["grid_launches"]
        on_card = device.type == "cuda"
        for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq", "fourier_basis"):
            check(fit_l[name] > 0 or not on_card,
                  f"{name} launched {fit_l[name]} times by the NANOGrav fit_toas")
        with twins():
            twin_run = run_main_path(fresh_fitter(twin["tensor"], device, "nanograv", par),
                                     device)
        moved = perturbed_fit(twin["tensor"], device, "nanograv", par)
        check_fit(run, twin_run, "NANOGrav GLS", moved)

        print("phase 32: grid_chisq 3x3 (M2, SINI), GLS statistic (NANOGrav)")
        for name in ("resid_tangent", "linear_columns", "fourier_basis", "ecorr_normal_eq"):
            check(grid_l[name] > 0 or not on_card,
                  f"{name} launched {grid_l[name]} times by the NANOGrav grid_chisq")
        gnames, gvals = grid_for(run["fitter"].model, run["fitter"])
        with twins():
            same_start = {"chi2": grid_chisq(run["fitter"], gnames, gvals)}
        sens = grid_sensitivity(run["fitter"], gnames, gvals, same_start["chi2"])
        chi2 = run["chi2"]
        worst_g = float(np.max(np.abs(chi2 - same_start["chi2"]) / same_start["chi2"]))
        print(f"  a change of the refits' normal matrices by 1e-15 of their diagonals moves "
              f"this grid by {sens:.3g} relative")
        check(chi2.shape == (3, 3) and bool(np.all(np.isfinite(chi2))),
              "NANOGrav grid chi2 finite, 3x3")
        check(worst_g <= max(1e-10, 10 * sens),
              f"NANOGrav grid within max(1e-10, 10 x {sens:.3g}) relative of the twins' grid "
              f"from the same fit ({worst_g:.3g})")
        apart = float(np.max(np.abs(chi2 - twin_run["chi2"]) / twin_run["chi2"]))
        check(apart <= NANOGRAV_GRID_OWN_FITS_TOL,
              f"NANOGrav grid within {NANOGRAV_GRID_OWN_FITS_TOL:g} relative of the twin path's "
              f"grid from its own fit ({apart:.3g}; the fits {fit_distance(run, twin_run):.3g} "
              f"relative apart)")

        print("phase 33: NANOGrav kernel times, warm wall and busy share")
        recs = {
            "resid_tangent": {
                k: v for shape, params, lanes in (("fit", model.params, free),
                                                  ("grid", params_b, grid_lanes))
                for k, v in k1_kept(summary, f"nanograv {shape}",
                                    k1_record(model, tensor, params, lanes, device, 10),
                                    f"nanograv_{shape}_").items()},
            "ecorr_normal_eq": {f"dense_{k}": v
                                for k, v in k3_record(*k3["grid"]["args"], device).items()},
            "linear_columns": k8_record(model, params_b, tensor, device, 50),
        }
        fit3 = k3_record(*k3["fit"]["args"], device)
        recs["ecorr_normal_eq"].update({f"dense_fit_{k}": v for k, v in fit3.items()})
        if on_card:
            summary["nanograv_profile"] = profile_main_path(tensor, device, "nanograv", par)
    res = run["fitter"].result
    summary["nanograv"] = {
        "prepare_wall_s": main["wall_s"], "prepare_stage_s": main["stage_s"],
        "twin_prepare_wall_s": twin["wall_s"], "fit_wall_s": run["fit_s"],
        "grid_wall_s": run["grid_s"], "fit_iterations": res.iterations,
        "fit_chi2_reduced": res.reduced_chi2, "grid_chi2": chi2.tolist(),
        "grid_rel_err": worst_g, "grid_sensitivity": sens, "grid_rel_err_own_fits": apart,
        "fit_distance": fit_distance(run, twin_run),
        "fit_distance_perturbed": fit_distance(moved, twin_run),
        "normal_matrix_condition": float(twin_run["fitter"].result.singular_values[0]
                                         / twin_run["fitter"].result.singular_values[-1]),
        "k1_stats": stats, "k8_err": k8_err}
    errs = {"resid_tangent": max(v["max_abs_err"] for v in stats.values()),
            "ecorr_normal_eq": max(v["chi2_abs_err"] for v in k3.values()),
            "linear_columns": k8_err}
    return {"recs": recs, "errs": errs, "fitter": run["fitter"], "tensor": tensor,
            "toas": main["toas"], "k3": k3, "width": (n_dmx, nf),
            "windows": {"nanograv_prepare": pl, "nanograv_fit": fit_l, "nanograv_grid": grid_l}}


# --- phases 40-44: wideband TOAs (WIDEBAND_SMOKE_PAR) ---------------------------------


def wideband_truth(tim) -> float:
    """The true DMJUMP of a wideband .tim, from the recipe in its comment line."""
    for line in Path(tim).read_text().splitlines()[:5]:
        if line.startswith("C Recipe: "):
            return float(json.loads(line.removeprefix("C Recipe: "))["dmjump_true"])
    raise SmokeFailure(f"{tim} records no recipe")


def dm_rows_record(model, params, tensor, dm_data, sigma, names, device, reps: int) -> dict:
    """K8's DM-row pass at one shape. No torch call forms timing DM rows, so
    there is no library yardstick."""
    from pint_tpu_torch.fitting.design import dm_rows, dm_rows_plain

    args = (model, params, tensor, dm_data, sigma, names)
    ms, call = measure(lambda: dm_rows(*args), device, reps, K8_KERNELS[2])
    plain, plain_call = measure(lambda: dm_rows_plain(*args), device, max(1, reps // 10))
    n, n_rows, L = dm_data.shape[0], tensor["t_hi"].shape[0], len(names)
    n_dmx = tensor["dmx_onehot"].shape[1] if "dmx_onehot" in tensor else 0
    n_jump = len(model.dm_only_params)
    # read t (2), the one-hot row, the masks, dm_data and sigma per row;
    # write the DM, the residual and L columns. Per row: the DMX dot (2 per
    # window), the jumps (2 each), the weight's division (~15) and ~5 more;
    # per column one multiply
    n_bytes = (n_rows * (2 + n_dmx + n_jump) + 2 * n) * 8 + n * (L + 2) * 8
    n_ops = n * (2 * n_dmx + 2 * n_jump + 20 + L)
    b, how = bound_ms(n_bytes, n_ops)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call, "shape": f"N={n} L={L}",
            "library_note": "none: no torch call forms timing DM rows"}


def wideband_phases(device, summary: dict, tim=None, par: str | None = None) -> dict:
    """Phases 40-44: profiles.WIDEBAND_SMOKE_PAR (the NANOGrav-shaped par
    without ECORR, with a DMJUMP and DMEFAC/DMEQUAD; 81 free) from `tim`
    (default pint_tpu_torch/data/wideband_n16384.tim): K8's DM-row pass and
    K3 at the stacked [TOA; DM] shape against their twins, the prepare, the
    wideband fit through ``fit_auto`` against the twin path, its combined
    design, and the times."""
    import torch

    from pint_tpu_torch.fitting import fit_auto
    from pint_tpu_torch.fitting.design import dm_rows, dm_rows_plain
    from pint_tpu_torch.fitting.gls import _RIDGE as GLS_RIDGE
    from pint_tpu_torch.fitting.wideband import _weights, stacked_basis
    from pint_tpu_torch.fitting.wls import time_resid_design
    from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq, ecorr_normal_eq_plain
    from pint_tpu_torch.prepared import WIDEBAND_TIM
    from pint_tpu_torch.profiles import WIDEBAND_SMOKE_PAR
    from pint_tpu_torch.residuals import WidebandTOAResiduals

    tim, par = tim or WIDEBAND_TIM, par or WIDEBAND_SMOKE_PAR
    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmpname, knobs(
            PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
        tmp = Path(tmpname)
        main = flagship_tim_path(device, tmp, tim, par)
        tensor = main["tensor"]
        start = fresh_fitter(tensor, device, "wideband", par)
        model, res = start.model, start.resids
        free = tuple(model.free_params)
        n_toas = tensor["t_hi"].shape[0] - 1
        n_dmx = len(model["DispersionDMX"].windows)
        basis = model.noise_basis_and_weights(model.params, tensor)
        # free: 12 K1 lanes, the DMX windows, the JUMP, FD1-3 and DMJUMP1
        check(len(free) == n_dmx + 17 and "DMJUMP1" in free and basis.ke == 0
              and basis.kd == 2 * model["PLRedNoise"].nf
              and bool(torch.all(torch.isfinite(res.dm_errors))),
              f"wideband: {len(free)} free parameters (DMJUMP1 among them), {basis.ke} ECORR "
              f"epochs, {basis.kd} Fourier columns, a DM measurement on all {n_toas} TOAs")

        print("phase 40: K8's DM-row pass against its twin (bitwise)")
        unit = torch.ones_like(res.dm_errors)
        cases = {"fit": (res.dm_errors, free), "chi2": (res.dm_errors, ()),
                 "design": (unit, free)}
        for label, (sigma, names) in cases.items():
            args = (model, model.params, tensor, res.dm_data, sigma, names)
            got, want = dm_rows(*args), dm_rows_plain(*args)
            sync(device)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            check(same and got[2].shape == (len(names), n_toas),
                  f"K8 DM rows ({label}: {len(names)} columns x {n_toas} rows) bitwise equal to "
                  "the twin")
        cols = got[2]
        dm_cols = [n for j, n in enumerate(free) if bool(torch.any(cols[j] != 0))]
        check(len(dm_cols) == n_dmx + 1 and "DMJUMP1" in dm_cols,
              f"DM rows: {len(dm_cols)} nonzero columns ({n_dmx} DMX and DMJUMP1)")

        print("phase 41: K3 at the stacked [TOA; DM] shape against its twin")
        w = _weights(res.errors_s, res.dm_errors)
        r_t, M_t = time_resid_design(model, free, model.params, tensor, res.toa.weights, True,
                                     hybrid=False)
        _, r_dm, M_dm = dm_rows(model, model.params, tensor, res.dm_data, res.dm_errors, free)
        r = torch.cat([r_t, r_dm])[None]
        M = torch.cat([M_t.T, M_dm], dim=1)[None].contiguous()
        sbasis = stacked_basis(model, model.params, tensor, n_toas)
        k3_inputs = {"step": (r, M, w, sbasis, GLS_RIDGE, False, True),
                     "chi2": (r, r.new_zeros((1, 0, r.shape[1])), w, sbasis, 0.0, False, False)}
        k3_err = 0.0
        for label, args in k3_inputs.items():
            got, again, want = (ecorr_normal_eq(*args), ecorr_normal_eq(*args),
                                ecorr_normal_eq_plain(*args))
            sync(device)
            tag = f"K3 wideband {label} (N={r.shape[1]}, p={args[1].shape[1]}, kd={sbasis.kd})"
            for name, g, wv in zip(("G", "c", "chi2", "ahat", "norm"), got, want):
                err = rel_err(g[0], wv[0])
                check(err <= 1e-12, f"{tag}: {name} within 1e-12 relative ({err:.3g})")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{tag}: bitwise equal across two runs")
            k3_err = max(k3_err, float(torch.max(torch.abs(got[2] - want[2]))))

        print("phase 42: get_model_and_toas + build_tensor (wideband)")
        pl = main["launches"]
        for name in ("site_geometry", "analytic_ephemeris"):
            check(pl[name] == (2 if on_card else 0),
                  f"{name} launched {pl[name]} times (the TOAs and the TZR row)")
        print("  stage walls (s): " + json.dumps(main["stage_s"])
              + f"; get_model_and_toas + build_tensor {main['wall_s']:.3f} s")
        with twins():
            twin = flagship_tim_path(device, tmp, tim, par)
        check(torch.equal(tensor["wb_dm"], twin["tensor"]["wb_dm"])
              and torch.equal(tensor["wb_dme"], twin["tensor"]["wb_dme"]),
              "wideband prepare: wb_dm and wb_dme equal to the twin path's")
        compare_tensors(tensor, twin["tensor"], "wideband prepare kernels vs twins")

        print(f"phase 43: fit_auto -> WidebandDownhillFitter.fit_toas ({len(free)} free)")
        check(type(fit_auto(main["toas"], start.model)) is type(start),
              "fit_auto picks WidebandDownhillFitter for the wideband TOAs")
        run = run_main_path(fresh_fitter(tensor, device, "wideband", par), device, grid=False)
        fit_l = run["fit_launches"]
        for name in ("dd_elementwise", "resid_tangent", "dm_rows", "ecorr_normal_eq",
                     "fourier_basis"):
            check(fit_l[name] > 0 or not on_card,
                  f"{name} launched {fit_l[name]} times by the wideband fit_toas")
        with twins():
            twin_run = run_main_path(fresh_fitter(twin["tensor"], device, "wideband", par),
                                     device, grid=False)
        moved = perturbed_fit(twin["tensor"], device, "wideband", par)
        check_fit(run, twin_run, "wideband", moved)
        ftr = run["fitter"]
        truth, dmj = wideband_truth(tim), ftr.values()["DMJUMP1"]
        sig = ftr.result.uncertainties["DMJUMP1"]
        check(abs(dmj - truth) <= 4 * sig,
              f"DMJUMP1 {dmj:.6g} within 4 sigma ({sig:.3g}) of its truth {truth:g}")
        check(isinstance(ftr.resids, WidebandTOAResiduals)
              and ftr.result.dof == 2 * n_toas - len(free) - 1,
              f"wideband dof {ftr.result.dof} (TOAs and DM measurements)")
        design = ftr.designmatrix()
        with twins():
            twin_design = ftr.designmatrix()
        d_err = max(rel_err(torch.as_tensor(design[:, j]), torch.as_tensor(twin_design[:, j]))
                    for j in range(design.shape[1]))
        check(design.shape == (2 * n_toas, len(free)) and d_err <= 1e-10,
              f"combined design {design.shape} within 1e-10 relative per column of the twins' "
              f"({d_err:.3g})")

        print("phase 44: wideband kernel times, warm wall and busy share")
        lanes = tuple(n for n in free if n not in model.dm_only_params)
        recs = {
            "dm_rows": dm_rows_record(model, model.params, tensor, res.dm_data, res.dm_errors,
                                      free, device, 50),
            "resid_tangent": k1_kept(
                summary, "wideband fit", k1_record(model, tensor, model.params, lanes, device, 10),
                "wideband_fit_"),
            "ecorr_normal_eq": {f"wideband_{k}": v
                                for k, v in k3_record(*k3_inputs["step"], device).items()},
        }
        if on_card:
            summary["wideband_profile"] = profile_main_path(tensor, device, "wideband", par,
                                                            grid=False)
    fres = ftr.result
    summary["wideband"] = {
        "prepare_wall_s": main["wall_s"], "prepare_stage_s": main["stage_s"],
        "twin_prepare_wall_s": twin["wall_s"], "fit_wall_s": run["fit_s"],
        "fit_iterations": fres.iterations, "fit_chi2_reduced": fres.reduced_chi2,
        "dmjump1": dmj, "dmjump1_sigma": sig, "dmjump1_truth": truth,
        "fit_distance": fit_distance(run, twin_run),
        "fit_distance_perturbed": fit_distance(moved, twin_run), "design_rel_err": d_err,
        "normal_matrix_condition": float(twin_run["fitter"].result.singular_values[0]
                                         / twin_run["fitter"].result.singular_values[-1])}
    errs = {"dm_rows": 0.0, "ecorr_normal_eq": k3_err}
    return {"recs": recs, "errs": errs,
            "windows": {"wideband_prepare": pl, "wideband_fit": fit_l}}


# --- phases 34-39: the rest of the binaries (DDGR, DDK, ELL1H, ELL1K, FB) -------------


def strip_tzr(par: str) -> str:
    """A par without its TZR lines: the model has no AbsPhase, its tensor no
    TZR row, and K1's tangents are not differences with the TZR row's."""
    return "".join(ln + "\n" for ln in par.splitlines()
                   if not ln.startswith(("TZRMJD", "TZRSITE", "TZRFRQ")))


def compare_k1_exact(model, params, tensor, lanes, device, tag: str,
                     tan_tol: float = 1e-15) -> dict:
    """K1 against its twin at one shape: pulse numbers, fractional phase,
    f and f_bary bitwise equal, tangents within `tan_tol` relative (per
    lane, to the lane's largest value)."""
    import torch

    from pint_tpu_torch.residuals import resid_tangent, resid_tangent_plain

    got = resid_tangent(model, params, tensor, lanes)
    want = resid_tangent_plain(model, params, tensor, lanes)
    sync(device)
    same = all(torch.equal(g, w) for g, w in zip((got.pn, got.frac, got.f, got.fb),
                                                 (want.pn, want.frac, want.f, want.fb)))
    dt = float(torch.max(torch.abs(got.frac / got.f - want.frac / want.f)))
    check(same, f"{tag}: pulse numbers, phase, f and f_bary bitwise equal to the twin "
                f"({dt:.3g} s)")
    errs = [max(rel_err(got.dfrac[:, j], want.dfrac[:, j]), rel_err(got.df[:, j], want.df[:, j]))
            for j in range(len(lanes))]
    worst = max(errs, default=0.0)
    name = lanes[errs.index(worst)] if lanes else "-"
    check(worst <= tan_tol, f"{tag}: tangents within {tan_tol:g} relative ({worst:.3g}, {name})")
    return {"max_abs_err": dt, "tangent_rel_err": worst}


def binary_forms() -> dict:
    """The slice's forms: their .tim, their par, and the fresh_fitter key of
    those with a fit and grid on the main path (ELL1H's h4 and h3 modes
    borrow its stigma mode's fitter for their shapes)."""
    from pint_tpu_torch import prepared
    from pint_tpu_torch import profiles as pr

    return {"DDGR": (prepared.DDGR_TIM, pr.DDGR_SMOKE_PAR, "ddgr"),
            "DDK": (prepared.DDK_TIM, pr.DDK_SMOKE_PAR, "ddk"),
            "ELL1H stigma": (prepared.FLAGSHIP_TIM, pr.ell1h_smoke_par("stigma"), "ell1h"),
            "ELL1H h4": (prepared.FLAGSHIP_TIM, pr.ell1h_smoke_par("h4"), None),
            "ELL1H h3": (prepared.FLAGSHIP_TIM, pr.ell1h_smoke_par("h3"), None),
            "ELL1K": (prepared.FLAGSHIP_TIM, pr.ELL1K_SMOKE_PAR, "ell1k"),
            "ELL1 + FB": (prepared.FLAGSHIP_TIM, pr.fb_smoke_par(), "fb")}


#: the fits' and grids' main-path launch windows: K0 and K1 in every fit, K3 in
#: the GLS fits; K1 and K2 in the white grids, K1, K8 (DM, DM1) and K3 in the
#: GLS ones
BINARY_FIT_KERNELS = ("dd_elementwise", "resid_tangent")
BINARY_GRID_KERNELS = {"wls": ("resid_tangent", "normal_eq"),
                       "gls": ("resid_tangent", "linear_columns", "ecorr_normal_eq")}


def binary_phases(device, summary: dict) -> dict:
    """Phases 34-39: DDGR and DDK (WLS) from ddgr_n16384.tim and
    ddk_n16384.tim, ELL1H's stigma mode, ELL1K and the FB form (GLS) from
    flagship_n16384.tim: K1 against its twin for every form (ELL1H's h4 and
    h3 modes too), then each fit and grid through the port's entry points
    against the twin path, and K1's times."""
    import numpy as np

    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import grid_for
    from pint_tpu_torch.residuals import lane_names

    on_card = device.type == "cuda"
    forms = binary_forms()
    stats, recs, windows, out = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmpname, knobs(
            PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
        tmp = Path(tmpname)
        print("phase 34: K1's new binary terms against the twin (every lane without the TZR "
              "row; the fit's and grid's shapes with it)")
        prep = {}
        for form, (tim, par, key) in forms.items():
            main = flagship_tim_path(device, tmp, tim, par)
            prep[form] = main
            model, tensor = main["model"], main["tensor"]
            bare = get_model(strip_tzr(par), from_text=True, device=device)
            every = lane_names(bare.params, bare)
            stats[f"{form} every"] = compare_k1_exact(
                bare, bare.params, bare.build_tensor(main["toas"]), every, device,
                f"K1 {form} every lane, B = 1 ({len(every)} lanes)")
            start = fresh_fitter(tensor, device, key or "ell1h", par)
            names, _, params_b = grid_params(model, start)
            fit_lanes = linear_split(model, tuple(model.free_params))[0]
            grid_lanes = linear_split(model, tuple(n for n in model.free_params
                                                   if n not in names))[0]
            # the TZR row's tangent, subtracted from every row's, shares part of
            # some lanes (PX's and DM's annual terms): the difference keeps
            # the terms' rounding, ~1e-15 of what is left (measured 1.07e-15)
            for shape, params, lanes in (("fit", start.model.params, fit_lanes),
                                         ("grid", params_b, grid_lanes)):
                B = 1 if shape == "fit" else 9
                stats[f"{form} {shape}"] = compare_k1_exact(
                    model, params, tensor, lanes, device,
                    f"K1 {form} {shape}, B = {B} ({len(lanes)} lanes)", 2e-15)

        for phase, form in ((35, "DDGR"), (36, "DDK"), (37, "ELL1H stigma"), (38, "ELL1K"),
                            (38, "ELL1 + FB")):
            tim, par, key = forms[form]
            main = prep[form]
            tensor = main["tensor"]
            kind = "gls" if key in ("ell1h", "ell1k", "fb") else "wls"
            print(f"phase {phase}: {form}: get_model_and_toas + build_tensor, "
                  f"Downhill{kind.upper()}Fitter.fit_toas and the {grid_for(main['model'], None)[0]} "
                  "grid")
            pl = main["launches"]
            for name in ("site_geometry", "analytic_ephemeris"):
                check(pl[name] == (2 if on_card else 0),
                      f"{form}: {name} launched {pl[name]} times (the TOAs and the TZR row)")
            with twins():
                twin = flagship_tim_path(device, tmp, tim, par)
            compare_tensors(tensor, twin["tensor"], f"{form} prepare kernels vs twins")
            run = run_main_path(fresh_fitter(tensor, device, key, par), device)
            fit_l, grid_l = run["fit_launches"], run["grid_launches"]
            for name in BINARY_FIT_KERNELS + (("ecorr_normal_eq",) if kind == "gls" else ()):
                check(fit_l[name] > 0 or not on_card,
                      f"{name} launched {fit_l[name]} times by the {form} fit_toas")
            for name in BINARY_GRID_KERNELS[kind]:
                check(grid_l[name] > 0 or not on_card,
                      f"{name} launched {grid_l[name]} times by the {form} grid_chisq")
            with twins():
                twin_run = run_main_path(fresh_fitter(twin["tensor"], device, key, par), device)
            # DDK's T0 and OM are nearly degenerate at ECC 7.5e-5 (normal-matrix
            # condition ~5e9): tangents ~5e-16 apart give steps ~1e-12 apart,
            # which flip the last bit of the ~500 s delay at some rows; the fits
            # then sit ~1e-8 sigma apart, so DDK takes phase 31's witness rule
            moved = perturbed_fit(twin["tensor"], device, key, par) if form == "DDK" else None
            check_fit(run, twin_run, f"{form} {kind.upper()}", moved)
            gnames, gvals = grid_for(run["fitter"].model, run["fitter"])
            with twins():
                same_start = {"chi2": grid_chisq(run["fitter"], gnames, gvals)}
            sens = grid_sensitivity(run["fitter"], gnames, gvals, same_start["chi2"])
            chi2 = run["chi2"]
            check(chi2.shape == (3, 3) and bool(np.all(np.isfinite(chi2))),
                  f"{form} grid chi2 finite, 3x3")
            worst_g = float(np.max(np.abs(chi2 - same_start["chi2"]) / same_start["chi2"]))
            print(f"  a change of the refits' normal matrices by 1e-15 of their diagonals moves "
                  f"this grid by {sens:.3g} relative")
            check(worst_g <= max(1e-10, 10 * sens),
                  f"{form} grid within max(1e-10, 10 x {sens:.3g}) relative of the twins' grid "
                  f"from the same fit ({worst_g:.3g})")
            apart = float(np.max(np.abs(chi2 - twin_run["chi2"]) / twin_run["chi2"]))
            own_tol = max(DD_GRID_OWN_FITS_TOL, 10 * sens)
            check(apart <= own_tol,
                  f"{form} grid within {own_tol:.3g} relative of the twin path's grid from its "
                  f"own fit ({apart:.3g}; the fits {fit_distance(run, twin_run):.3g} relative "
                  "apart)")
            res = run["fitter"].result
            out[form] = {"prepare_wall_s": main["wall_s"], "twin_prepare_wall_s": twin["wall_s"],
                         "fit_wall_s": run["fit_s"], "grid_wall_s": run["grid_s"],
                         "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
                         "grid": list(gnames), "grid_chi2": chi2.tolist(),
                         "grid_argmin": int(np.argmin(chi2)), "grid_rel_err": worst_g,
                         "grid_sensitivity": sens, "grid_rel_err_own_fits": apart,
                         "fit_distance": fit_distance(run, twin_run),
                         "fit_distance_perturbed": (fit_distance(moved, twin_run)
                                                    if moved else None),
                         "design_condition": float(res.singular_values[0]
                                                   / res.singular_values[-1])}
            tag = form.split()[0].lower() + ("_fb" if "FB" in form else "")
            windows.update({f"{tag}_prepare": pl, f"{tag}_fit": fit_l, f"{tag}_grid": grid_l})

        print("phase 39: K1's times at the new forms' fit and grid shapes")
        rows = {}
        for form, (_, par, key) in forms.items():
            main = prep[form]
            model, tensor = main["model"], main["tensor"]
            start = fresh_fitter(tensor, device, key or "ell1h", par)
            names, _, params_b = grid_params(model, start)
            free = tuple(model.free_params)
            grid_lanes = linear_split(model, tuple(n for n in free if n not in names))[0]
            for shape, params, lanes in (("fit", model.params, linear_split(model, free)[0]),
                                         ("grid", params_b, grid_lanes)):
                rows[f"{form} {shape}"] = k1_kept(
                    summary, f"{form} {shape}", k1_record(model, tensor, params, lanes, device, 20))
        recs["resid_tangent"] = {"binaries": rows}
    summary["binaries"] = {**out, "k1_stats": stats}
    errs = {"resid_tangent": max(v["max_abs_err"] for v in stats.values())}
    return {"recs": recs, "errs": errs, "windows": windows}


# --- phases 45-49: the noise likelihood (NANOGRAV_SMOKE_PAR) -------------------------

#: the optimizer's start (phase 48): noise values away from the simulation's
#: truth (an EQUAD or ECORR at the truth's 0.01 us sits at its prior's edge,
#: where Adam's first steps leave the prior and the start stays the best point)
NOISE_START = {"EFAC1": 1.3, "EFAC2": 0.8, "EQUAD1": 1.23e-6, "EQUAD2": 0.87e-6,
               "ECORR1": 1.11e-6, "ECORR2": 0.93e-6, "TNREDAMP": -13.1, "TNREDGAM": 4.1,
               "TNDMAMP": -13.3, "TNDMGAM": 3.1}
#: K3's per-set-weight mode is checked and timed at these numbers of weight
#: sets (grad, optimize's 8 restarts, loglike_many's bucket), K9 at the first two
NOISE_SETS = (1, 8, 256)
K9_KERNELS = ("noise_grad_factors", "noise_grad_basis", "noise_grad_rows")


def noise_points(nl, E: int, seed: int):
    """(E, h): the start and E - 1 points moved by 0.03 prior scales (EQUAD
    and ECORR kept inside their priors)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    eta = np.tile(nl.x0, (E, 1))
    eta[1:] += 0.03 * nl.scales * rng.standard_normal((E - 1, nl.nparams))
    edge = np.array([n.startswith(("EQUAD", "ECORR")) for n in nl.hyper])
    return np.where(edge, np.abs(eta), eta)


def noise_inputs(nl, eta):
    """(w (E, N), phi_e (E, ke), phi_d (E, kd)) at the points eta (E, h), as
    the likelihood forms them."""
    import torch

    return tuple(x.contiguous() for x in nl._sets(torch.as_tensor(eta, device=nl.device)))


def phase_k3_sets(nl, device, k3_old) -> dict:
    """Phase 45: K3's per-set-weight mode against its twin at each of
    NOISE_SETS, bitwise repeatable; at E = 1 bitwise equal to the
    shared-weight mode's B = 1 call (the two share their arithmetic); and
    phase 29's fit and grid calls run again, bitwise equal to their first
    results."""
    import torch

    from pint_tpu_torch.fitting.noise_like import RIDGE
    from pint_tpu_torch.fitting.woodbury import (ecorr_normal_eq, ecorr_normal_eq_sets,
                                                 ecorr_normal_eq_sets_plain)

    core = nl._core
    out = {}
    for E in NOISE_SETS:
        w, pe, pd = noise_inputs(nl, noise_points(nl, E, 45))
        args = (core.r0, core.M, w, core.Fd, core.epochs, pe, pd, RIDGE)
        got = ecorr_normal_eq_sets(*args)
        again = ecorr_normal_eq_sets(*args)
        want = ecorr_normal_eq_sets_plain(*args)
        sync(device)
        tag = f"K3 per-set mode (E={E}, p={core.M.shape[0]}, ke={pe.shape[1]}, kd={pd.shape[1]})"
        for name in want._fields:
            g, wv = getattr(got, name), getattr(want, name)
            err = rel_err(g, wv) if name == "norm" else max(rel_err(g[e], wv[e]) for e in range(E))
            check(err <= 1e-12, f"{tag}: {name} within 1e-12 relative per set ({err:.3g})")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: bitwise equal across two runs")
        if E == 1:
            basis = nl.model.noise_basis_and_weights(nl._params0, nl.tensor)
            old = ecorr_normal_eq(core.r0[None], core.M[None], w[0],
                                  basis._replace(ephi=pe[0], dense_phi=pd[0]), RIDGE)
            same = all(torch.equal(a, b) for a, b in zip(
                old, (got.G, got.c, got.chi2, got.ahat, got.norm[None])))
            check(same, "K3 per-set mode at E = 1 bitwise equal to the shared-weight mode")
        out[E] = {"args": args, "chi2_abs_err": float(torch.max(torch.abs(got.chi2 - want.chi2))),
                  "G": got.G, "chi2": got.chi2}
    for label in ("fit", "grid"):
        again = ecorr_normal_eq(*k3_old[label]["args"])
        sync(device)
        check(all(torch.equal(a, b) for a, b in zip(again, k3_old[label]["out"])),
              f"K3's shared-weight mode at phase 29's {label} shape bitwise unchanged")
    return out


def check_k9(core, st, device, tag: str) -> float:
    """K9 against its twin on one state: d lnL / d w and d lnL / d phi
    within 1e-12 of each set's largest entry, bitwise equal across two
    calls. Returns the largest absolute error of d lnL / d w."""
    import torch

    from pint_tpu_torch.fitting.noise_like import noise_grad, noise_grad_plain

    got, again = noise_grad(core, st), noise_grad(core, st)
    want = noise_grad_plain(core, st)
    sync(device)
    E = st.w.shape[0]
    for name, g, wv in zip(("dlnL/dw", "dlnL/dphi"), got, want):
        err = max(rel_err(g[e], wv[e]) for e in range(E))
        check(err <= 1e-12, f"{tag}: {name} within 1e-12 of the largest entry ({err:.3g})")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: bitwise equal across two runs")
    return float(torch.max(torch.abs(got[0] - want[0])))


def phase_k9(nl, device) -> float:
    """Phase 46: K9 against its twin on the kernel forward's state, both
    modes, at E = 1 and 8 (`check_k9`). Returns the largest absolute error
    of d lnL / d w."""
    from pint_tpu_torch.fitting.noise_like import noise_forward

    worst = 0.0
    for E in NOISE_SETS[:2]:
        w, pe, pd = noise_inputs(nl, noise_points(nl, E, 46))
        for marg in (True, False):
            core = nl._core._replace(marginalize=marg)
            _, st = noise_forward(core, w, pe, pd)
            worst = max(worst, check_k9(core, st, device,
                                        f"K9 (E={E}, {'marginalized' if marg else 'profiled'})"))
    return worst


def noise_model(fitter, toas, device, width, dm_noise: bool, start: dict):
    """(model, tensor): ``nanograv_smoke_par(*width)`` (with DM noise) at
    the fit's timing parameters, its noise values moved by `start`."""
    import torch

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import nanograv_smoke_par

    model = get_model(nanograv_smoke_par(*width, dm_noise=dm_noise), from_text=True,
                      device=device)
    for n, v in fitter.model.params.items():
        if n in model.params:
            model.params[n] = v
    for n, v in start.items():
        if n in model.params:
            model.params[n] = torch.tensor(v, dtype=torch.float64, device=device)
    return model, model.build_tensor(toas)


def check_noise_like(nl, twin, device, label: str) -> dict:
    """The design, loglike at 5 points, loglike_many at 256 and grad at 2
    of `nl` against the twin path `twin`, each of `nl`'s calls in a launch
    window of its own. Bounds: the CPU tests' (design 1e-10 per column,
    likelihoods 1e-8 relative, the gradient 1e-8 of its largest entry)."""
    import numpy as np

    windows = {k: {} for k in ("loglike", "many", "grad")}
    r0, M, mn = nl.design
    tr0, tM, tmn = twin.design
    derr = max(rel_err(r0, tr0), rel_err(mn, tmn),
               max(rel_err(M[:, j], tM[:, j]) for j in range(M.shape[1])))
    check(derr <= 1e-10, f"{label}: design (r0, M per column, Mnorm) within 1e-10 of the "
                         f"twin path's ({derr:.3g})")
    pts = noise_points(nl, 5, 47)
    with counted(windows["loglike"]):
        ll = np.array([nl.loglike(e) for e in pts])
    many_pts = noise_points(nl, 256, 48)
    with counted(windows["many"]):
        many = nl.loglike_many(many_pts)
    with counted(windows["grad"]):
        g = np.array([nl.grad(e) for e in pts[:2]])
    with twins():
        tll = np.array([twin.loglike(e) for e in pts])
        tmany = twin.loglike_many(many_pts)
        tg = np.array([twin.grad(e) for e in pts[:2]])
    errs = {"design": derr, "loglike": float(np.max(np.abs(ll - tll) / np.abs(tll))),
            "loglike_many": float(np.max(np.abs(many - tmany) / np.abs(tmany))),
            "grad": float(max(np.max(np.abs(a - b)) / np.max(np.abs(b)) for a, b in zip(g, tg)))}
    check(np.all(np.isfinite(ll)) and errs["loglike"] <= 1e-8,
          f"{label}: loglike at 5 points within 1e-8 relative ({errs['loglike']:.3g})")
    check(many.shape == (256,) and errs["loglike_many"] <= 1e-8,
          f"{label}: loglike_many at 256 points within 1e-8 relative ({errs['loglike_many']:.3g})")
    check(np.all(np.isfinite(g)) and errs["grad"] <= 1e-8,
          f"{label}: grad at 2 points within 1e-8 of the largest entry ({errs['grad']:.3g})")
    on_card = device.type == "cuda"
    for win, names in (("loglike", ("ecorr_normal_eq_sets",)), ("many", ("ecorr_normal_eq_sets",)),
                       ("grad", ("ecorr_normal_eq_sets", "noise_grad"))):
        for name in names:
            n = windows[win][name]
            check(n > 0 or not on_card, f"{name} launched {n} times by {label}'s {win}")
    return {"errs": errs, "windows": windows, "loglike": ll.tolist(),
            "grad_x0": g[0].tolist()}


def check_optimize(nl, twin, device, label: str) -> dict:
    """optimize() (8 restarts, 200 steps) against the twin path: the best ln
    posterior above the start's and within 1e-8 relative, eta_hat within
    1e-6 of each prior scale."""
    import numpy as np
    import torch

    window = {}
    with counted(window):
        t0 = time.perf_counter()
        eta, lp = nl.optimize()
        sync(device)
        wall = time.perf_counter() - t0
    with twins():
        eta_t, lp_t = twin.optimize()
    with torch.no_grad():
        start = float(nl._lnpost(torch.as_tensor(nl.x0, device=nl.device)[None])[0])
    check(lp > start, f"{label}: optimize raised the ln posterior from {start:.10g} to {lp:.10g}")
    err = abs(lp - lp_t) / abs(lp_t)
    check(err <= 1e-8, f"{label}: optimize's ln posterior within 1e-8 of the twin path's "
                       f"({lp:.12g} vs {lp_t:.12g})")
    moved = float(np.max(np.abs(eta - eta_t) / nl.scales))
    check(moved <= 1e-6, f"{label}: eta_hat within 1e-6 prior scales of the twin path's "
                         f"({moved:.3g})")
    for name in ("ecorr_normal_eq_sets", "noise_grad"):
        check(window[name] > 0 or device.type != "cuda",
              f"{name} launched {window[name]} times by {label}'s optimize")
    return {"window": window, "wall_s": wall, "lnpost": lp, "lnpost_start": start,
            "lnpost_rel_err": err, "eta_rel_scale_err": moved,
            "eta_hat": dict(zip(nl.hyper, eta.tolist()))}


# K3's per-set mode: each set's ln w_i is a log (~35 operations, as K1's count)
LOG_OPS = 35


def k3_sets_record(core, w, pe, pd, device) -> dict:
    """K3's per-set-weight mode at E = w.shape[0] weight sets; the library
    yardstick is the batched cuBLAS Gram X W_e X^T of the augmented rows X =
    [Mn, r, Fd] alone."""
    import torch

    from pint_tpu_torch.fitting.noise_like import RIDGE
    from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq_sets, ecorr_normal_eq_sets_plain

    args = (core.r0, core.M, w, core.Fd, core.epochs, pe, pd, RIDGE)
    E, n = w.shape
    p, ke, kd = core.M.shape[0], pe.shape[1], pd.shape[1]
    reps = 20 if E < 256 else 3
    whole, _ = measure(lambda: ecorr_normal_eq_sets(*args), device, reps)
    plain, plain_call = measure(lambda: ecorr_normal_eq_sets_plain(*args), device, 1)
    X = torch.cat([core.M / core.mnorm[:, None], core.r0[None], core.Fd])
    Xw = (X[None] * torch.sqrt(w)[:, None, :]).contiguous()
    timed = k3_against_library(lambda: ecorr_normal_eq_sets(*args),
                               lambda: torch.matmul(Xw, Xw.mT), device, reps)
    del Xw
    nnz = core.epochs.rows.shape[0]
    V = p + 1 + kd
    q = (p + 1) * (p + 2) // 2
    # read r, M, Fd once, each set's w and phi, the CSR; write G, c, chi2,
    # ahat, log|C| and the backward's De, epoch sums, L, Wz, ad
    n_bytes = (n * V + E * (n + ke + kd)) * 8 + (ke + 1 + nnz) * 4 \
        + E * (p * p + p + 2 + 2 * ke + kd + ke * V + kd * (kd + p + 2)) * 8
    # column norms (3 per value of M); per set: ln w (LOG_OPS per row), the
    # epoch sums (2 per value and row), each row and epoch weighted (1 per
    # value); the Gram over rows and epochs and the fold are multiply-adds
    n_ops = n * p * 3 + E * (n * LOG_OPS + nnz * 2 * V + (n + ke) * V)
    n_mma = E * ((n + ke) * V * (V + 1) + q * 2 * kd)
    b, how = bound_ms(n_bytes, n_ops, n_mma)
    return k3_with_build({**timed, "plain_ms": plain, "bound_ms": b, "bound_by": how,
                          "call_device_ms": whole, "plain_call_ms": plain_call,
                          "shape": f"E={E} N={n} p={p} ke={ke} kd={kd}"})


def grad_record(call, prep, device, names) -> dict:
    """K9's or K10's call: the device ms of each of its passes (`by_kernel`,
    each call profiled alone, the median over the profiles that saw the
    pass; `passes_profiles`, their number) and their sum (`ms`), the whole
    call by CUDA events behind a busy queue (`queued_ms`), the factor pass's
    share of the three, and the twin's small-factor prep (`_grad_prep`,
    which pass 1 replaces) by CUDA events."""
    out = {"ms": None, "passes_ms": None, "passes_profiles": None, "queued_ms": None,
           "twin_prep_ms": None, "factor_share": None}
    if device.type != "cuda":
        return out
    passes = by_kernel(call, 20, names)
    total = sum(ms for _, ms, _ in passes)
    out.update(ms=total, passes_ms={name: ms for name, ms, _ in passes},
               passes_profiles={name: seen for name, _, seen in passes},
               queued_ms=queued_ms(call, 20),
               twin_prep_ms=queued_ms(prep, 20), factor_share=passes[0][1] / total)
    return out


def rows_share(rec: dict) -> None:
    """Adds to a K9 or K10 record (E = 1, and E = 8 under "e8_") the rows
    pass's device ms at E = 8 over 8 times its ms at E = 1 (1 where a set
    costs at E = 8 what it costs alone). The bytes the pass reads are not
    measured: no DRAM counter is read."""
    def rows(passes):
        return sum(ms for k, ms in passes.items() if "_rows" in k) if passes else None

    one, eight = rows(rec.get("passes_ms")), rows(rec.get("e8_passes_ms"))
    rec["e8_rows_over_8x_e1"] = eight / (8 * one) if one and eight else None


def k9_record(core, w, pe, pd, device) -> dict:
    """K9 at E = w.shape[0] weight sets on the kernel forward's state."""
    from pint_tpu_torch.fitting.noise_like import (_grad_prep, noise_forward, noise_grad,
                                                   noise_grad_plain)

    _, st = noise_forward(core, w, pe, pd)
    E, n = w.shape
    p, ke, kd = core.M.shape[0], pe.shape[1], pd.shape[1]
    call = timed_ms(lambda: noise_grad(core, st), device, 20)
    whole, _ = measure(lambda: noise_grad(core, st), device, 20)
    plain, plain_call = measure(lambda: noise_grad_plain(core, st), device, 3)
    V = p + 1 + kd
    # read M, r, Fd and the epoch index once, each set's w, phi and the
    # forward's De and epoch sums, and the small factors; write dw and dphi
    n_bytes = (n * (p + 1 + kd) + p) * 8 + n * 4 \
        + E * (n + 2 * (ke + kd) + ke * V + p * p + kd * kd + kd * (p + 1) + p) * 8 \
        + E * (n + ke + kd) * 8
    # products with g_d and the squared norms through K^-1 and L^-1 are
    # multiply-adds of matrix products: per row p kd, p (p + 1) / 2 and
    # kd (kd + 1) / 2, per epoch the same, per dense column p (p + 1) / 2;
    # the rest ~4 per value
    rows = p * kd + p * (p + 1) // 2 + kd * (kd + 1) // 2
    n_mma = E * 2 * ((n + ke) * rows + kd * p * (p + 1) // 2)
    n_ops = E * 4 * (n + ke) * (p + kd)
    b, how = bound_ms(n_bytes, n_ops, n_mma)
    rec = grad_record(lambda: noise_grad(core, st), lambda: _grad_prep(st, p), device,
                      K9_KERNELS)
    print(f"  K9 E={E}: {rec['ms']} ms, passes {rec['passes_ms']}, queued {rec['queued_ms']}, "
          f"twin prep {rec['twin_prep_ms']}")
    return {**rec, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "call_device_ms": whole, "plain_call_ms": plain_call,
            "shape": f"E={E} N={n} p={p} ke={ke} kd={kd}"}


def noise_walls(nl, device) -> dict:
    """Warm walls (host clock, ending in a synchronize) of loglike, grad,
    loglike_many (256 points) and optimize, then device time by kernel over
    one more of each under torch.profiler, and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts = noise_points(nl, 256, 49)
    calls = {"loglike": lambda: nl.loglike(nl.x0), "grad": lambda: nl.grad(nl.x0),
             "loglike_many_256": lambda: nl.loglike_many(pts), "optimize": nl.optimize}
    out = {}
    for name, fn in calls.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out[f"{name}_s"] = time.perf_counter() - t0
    if device.type != "cuda":
        return out
    for name in ("grad", "optimize"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls[name]()
            sync(device)
        kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(us for _, us in kern) / 1e6
        k9 = sum(us for k, us in kern if any(p in k for p in K9_KERNELS)) / 1e6
        k3 = sum(us for k, us in kern if named(k, K3_KERNEL)) / 1e6
        out[f"{name}_profile"] = {
            "device_busy_s": busy, "busy_share": busy / out[f"{name}_s"], "k3_s": k3, "k9_s": k9,
            "top": [[k[:70], us / 1e6] for k, us in sorted(kern, key=lambda r: -r[1])[:6]]}
    return out


def noise_phases(device, summary: dict, ng: dict) -> dict:
    """Phases 45-49 on phase 31's NANOGrav fit: K3's per-set-weight mode and
    K9 against their twins, NoiseLikelihood (loglike, loglike_many, grad,
    optimize) against the twin path, the DM-noise variant once, times."""
    from pint_tpu_torch.fitting import NoiseLikelihood

    fitter, tensor, (n_dmx, nf) = ng["fitter"], ng["tensor"], ng["width"]
    model = fitter.model
    windows = {}
    with counted(windows.setdefault("noise_build", {})):
        nl = NoiseLikelihood(tensor, model)
        sync(device)
    core = nl._core
    n = tensor["t_hi"].shape[0] - 1  # the last row is the TZR's
    shape = (core.r0.shape[0], core.M.shape[0], core.epochs.ke, core.Fd.shape[0], nl.nparams)
    # p_lin: 12 K1 lanes, the DMX windows, the JUMP, FD1-3 and the offset
    check(shape == (n, n_dmx + 17, n // 8, 2 * nf, 8),
          f"noise likelihood at (N, p_lin, ke, kd, h) = {shape}")
    for name in ("resid_tangent", "fourier_basis"):
        n = windows["noise_build"][name]
        check(n > 0 or device.type != "cuda", f"{name} launched {n} times by the build")

    print("phase 45: K3's per-set-weight mode against its twin")
    k3 = phase_k3_sets(nl, device, ng["k3"])

    print("phase 46: K9 noise_grad against its twin")
    k9_err = phase_k9(nl, device)

    print("phase 47: NoiseLikelihood (loglike, loglike_many, grad) against the twin path")
    with twins():
        twin = NoiseLikelihood(tensor, model)
    main = check_noise_like(nl, twin, device, "NANOGrav noise")
    windows.update({f"noise_{k}": v for k, v in main["windows"].items()})

    print("phase 48: optimize (8 restarts, 200 steps) against the twin path; the DM-noise variant")
    opt = {}
    for label, dm in (("NANOGrav", False), ("NANOGrav + DM noise", True)):
        m, t = noise_model(fitter, ng["toas"], device, (n_dmx, nf), dm, NOISE_START)
        one = NoiseLikelihood(t, m)
        with twins():
            one_twin = NoiseLikelihood(t, m)
        if dm:
            check(one._core.Fd.shape[0] == 4 * nf and one.nparams == 10,
                  f"the DM-noise variant: {4 * nf} Fourier columns, 10 hyperparameters")
            opt["dm_noise_checks"] = check_noise_like(one, one_twin, device, label)["errs"]
        opt[label] = check_optimize(one, one_twin, device, label)
        windows["noise_optimize" + ("_dm" if dm else "")] = opt[label].pop("window")

    print("phase 49: K3's per-set mode and K9 times, noise walls and busy share")
    recs = {"ecorr_normal_eq_sets": {}, "noise_grad": {}}
    for E in NOISE_SETS:
        w, pe, pd = noise_inputs(nl, noise_points(nl, E, 49))
        rec = k3_sets_record(core, w, pe, pd, device)
        recs["ecorr_normal_eq_sets"].update(rec if E == 1 else
                                            {f"e{E}_{k}": v for k, v in rec.items()})
        if E <= 8:
            rec = k9_record(core, w, pe, pd, device)
            recs["noise_grad"].update(rec if E == 1 else {f"e{E}_{k}": v for k, v in rec.items()})
    rows_share(recs["noise_grad"])
    walls = noise_walls(nl, device)
    print("  walls (s): " + json.dumps({k: v for k, v in walls.items() if k.endswith("_s")}))
    summary["noise"] = {"shape": dict(zip(("N", "p_lin", "ke", "kd", "h"), shape)),
                        "errs": main["errs"], "loglike": main["loglike"],
                        "grad_x0": main["grad_x0"], "optimize": opt, "walls": walls}
    errs = {"ecorr_normal_eq_sets": max(v["chi2_abs_err"] for v in k3.values()),
            "noise_grad": k9_err}
    return {"recs": recs, "errs": errs, "windows": windows, "k3": k3, "k3_old": ng["k3"]}


# --- phases 50-56: the joint PTA likelihood (PTA_PAR_TEMPLATE, 64 pulsars) -------------

#: array A: pint_tpu's N-scaling top (64 pulsars, a NANOGrav 15-year array's
#: size) at 8,192 TOAs a pulsar, the PTA profile's seed
PTA_SHAPE = (64, 8192, 29)
#: K3's stacked mode is checked and timed at these numbers of points (grad,
#: optimize's 8 restarts, loglike_many's bucket), K10 at the first two
PTA_SETS = (1, 8, 256)
K10_KERNELS = ("pta_grad_factors", "pta_grad_basis", "pta_grad_rows")
#: optimize's start (phase 53): the pulsars' and the background's noise off the
#: simulation's truth, so that Adam's first steps raise the ln posterior
PTA_START = {"EFAC1": 1.25, "EQUAD1": 0.45e-6, "ECORR1": 0.65e-6, "TNREDAMP": -13.3,
             "TNREDGAM": 3.3, "TNGWAMP": -12.95, "TNGWGAM": 4.1}
#: tests/test_pta.py's par (EFAC/EQUAD/ECORR, red noise, the background), kept
#: here: that module imports jax
PTA_TEST_PAR = """
PSR {name}
RAJ {raj} 1
DECJ {decj} 1
F0 {f0} 1
F1 -1.46389e-15 1
PEPOCH 57000
POSEPOCH 57000
DM 14.96 1
EFAC -f Rcvr1_2_GUPPI 1.1
EQUAD -f Rcvr1_2_GUPPI 0.3
ECORR -f Rcvr1_2_GUPPI 0.5
TNREDAMP -13.2
TNREDGAM 3.0
TNREDC 4
TNGWAMP -12.9
TNGWGAM 4.33
TNGWC 3
TZRMJD 57000.1
TZRSITE gbt
TZRFRQ 1400
"""
PTA_RAGGED_PAR = PTA_TEST_PAR.replace("ECORR -f Rcvr1_2_GUPPI 0.5\n", "")


def pta_test_array(device, n_psr: int, n_epochs, par: str, seed: int):
    """(models, toas) laid out as tests/test_pta.py's ``_array``: `par` at
    PTA_SKY's positions, n_epochs[k] epochs of 2 TOAs (1400 and 800 MHz, 0.5 s
    apart, MJD 56600-57400, 1 us), each pulsar's noise, then one correlated
    background, through the port's simulation on `device`."""
    import numpy as np

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import pta_sky
    from pint_tpu_torch.simulation import (add_gwb_to_arrays, add_noise_from_model,
                                           make_fake_toas_fromMJDs)

    rng = np.random.default_rng(seed)
    models, toas_list = [], []
    for k, (name, raj, decj) in enumerate(pta_sky(n_psr)):
        model = get_model(par.format(name=name, raj=raj, decj=decj, f0=346.531996493 + 0.37 * k),
                          from_text=True, device=device)
        mjds = np.repeat(np.linspace(56600.0, 57400.0, int(n_epochs[k])), 2)
        mjds[1::2] += 0.5 / 86400.0
        freqs = np.where(np.arange(len(mjds)) % 2 == 0, 1400.0, 800.0)
        toas = make_fake_toas_fromMJDs(np.sort(mjds), model, obs="gbt", freq_mhz=freqs,
                                       error_us=1.0, flags=[{"f": "Rcvr1_2_GUPPI"}] * len(mjds))
        models.append(model)
        toas_list.append(add_noise_from_model(toas, model, rng=rng, include_common=False))
    return models, add_gwb_to_arrays(toas_list, models, rng=rng)


@contextlib.contextmanager
def zeroed_residuals(into: list):
    """Hold every ``simulation.zero_residuals`` of the block to its tolerance:
    the largest residual of the TOAs it returns goes into `into`."""
    import torch

    from pint_tpu_torch import simulation
    from pint_tpu_torch.residuals import Residuals

    saved = simulation.zero_residuals

    def checked(toas, model, *args, **kwargs):
        out = saved(toas, model, *args, **kwargs)
        into.append(float(torch.max(torch.abs(Residuals(out, model, subtract_mean=False)
                                               .time_resids))))
        return out

    simulation.zero_residuals = checked
    try:
        yield
    finally:
        simulation.zero_residuals = saved


def pta_members(models, toas, device, start: dict | None = None):
    """One NoiseLikelihood per pulsar (noise values moved by `start`), the
    wall ending in a synchronize."""
    import torch

    from pint_tpu_torch.fitting import NoiseLikelihood

    t0 = time.perf_counter()
    out = []
    for m, t in zip(models, toas):
        for n, v in (start or {}).items():
            if n in m.params:
                m.params[n] = torch.tensor(v, dtype=torch.float64, device=device)
        out.append(NoiseLikelihood(t, m))
    sync(device)
    return out, time.perf_counter() - t0


def pta_points(pta, E: int, seed: int):
    """(E, H): the start and E - 1 points moved by 0.03 prior scales (EQUAD and
    ECORR kept inside their priors)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    eta = np.tile(pta.x0, (E, 1))
    eta[1:] += 0.03 * pta.scales * rng.standard_normal((E - 1, pta.nparams))
    edge = np.array([n.split(":")[-1].startswith(("EQUAD", "ECORR")) for n in pta.hyper])
    return np.where(edge, np.abs(eta), eta)


def per_set_err(got, want) -> float:
    """The largest over the leading (E, N) sets of max |got - want| / max |want|
    (within the set)."""
    import torch

    if not want.numel():
        return 0.0
    d = torch.abs(got - want).reshape(*want.shape[:2], -1).amax(dim=-1)
    s = torch.abs(want).reshape(*want.shape[:2], -1).amax(dim=-1)
    return float(torch.max(torch.where(s > 0, d / s, d)))


def pta_inputs(pta, eta):
    """(w, phi_e, phi_d, phi_gw) at the points eta (E, H), as the likelihood forms them."""
    import torch

    return pta._sets(torch.as_tensor(eta, device=pta.device))


def k3_stacked_args(pta, E: int, seed: int):
    w, pe, pd, _ = pta_inputs(pta, pta_points(pta, E, seed))
    c = pta._core
    return (c.r, c.M, c.G, w, c.Fd, c.epochs, pe if pe.shape[-1] else None,
            pd if pd.shape[-1] else None)


def flipped_rows(pta, args):
    """`k3_stacked_args` with every pulsar's rows in reverse order: the same
    sets, summed in another order."""
    from pint_tpu_torch.fitting.woodbury import stacked_epochs

    r, M, Gc, w, Fd, epochs, pe, pd = args
    flip = (None if epochs is None
            else stacked_epochs(pta._core.eidx.flip(-1), epochs.ke))
    return (r.flip(-1), M.flip(-1), Gc.flip(-1), w.flip(-1),
            None if Fd is None else Fd.flip(-1), flip, pe, pd)


def gate(witness: float) -> float:
    """The bound of a kernel-to-twin distance: 1e-12, or ten times the twin's
    own movement when its sums run in another order (the witness), where the
    sets' conditioning makes that larger."""
    return max(1e-12, 10.0 * witness)


def phase_k3_stacked(pta, device, label: str, sets) -> dict:
    """K3's stacked mode against its twin at each of `sets` points: every
    output within 1e-12 relative per (point, pulsar) set, or ten times the
    twin's distance from itself with each pulsar's rows reversed (`gate`:
    u_a = G^T C^-1 r and chi2_a cancel where the common block and the
    pulsar's red-noise columns nearly coincide), and bitwise repeatable."""
    import torch

    from pint_tpu_torch.fitting.woodbury import (ecorr_normal_eq_stacked,
                                                 ecorr_normal_eq_stacked_plain)

    out = {}
    for E in sets:
        args = k3_stacked_args(pta, E, 51)
        got = ecorr_normal_eq_stacked(*args)
        again = ecorr_normal_eq_stacked(*args)
        want = ecorr_normal_eq_stacked_plain(*args)
        wit = ecorr_normal_eq_stacked_plain(*flipped_rows(pta, args))
        sync(device)
        N, n = args[0].shape
        tag = (f"{label}: K3 stacked mode (E={E} x N={N}, rows={n}, p={args[1].shape[1]}, "
               f"m={args[2].shape[1]}, ke={0 if args[5] is None else args[5].ke}, "
               f"kd={0 if args[4] is None else args[4].shape[1]})")

        def dist(a, b, name):
            return (rel_err(getattr(a, name), getattr(b, name)) if name == "norm"
                    else per_set_err(getattr(a, name), getattr(b, name)))

        errs = {name: dist(got, want, name) for name in want._fields}
        wits = {name: dist(wit, want, name) for name in want._fields}
        ok = all(errs[k] <= gate(wits[k]) for k in errs)
        check(ok, f"{tag}: every output within 1e-12 relative per set, or 10x the twin's "
                  "own distance with the rows reversed (kernel / witness: "
                  + ", ".join(f"{k} {errs[k]:.2g}/{wits[k]:.2g}" for k in errs) + ")")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: bitwise equal across two runs")
        out[E] = {"errs": errs, "witness": wits,
                  "chi2_abs_err": float(torch.max(torch.abs(got.chi2 - want.chi2)))}
        del got, again, want, wit, args
    return out


def pta_cotangents(pta, E: int, seed: int):
    """(core, the kernel forward's state, gbar, ldbar): the coupling's own
    cotangent of each set's Gram and ln|C_a| at E points."""
    import torch

    from pint_tpu_torch.fitting.pta_like import pta_blocks

    w, pe, pd, phi = pta_inputs(pta, pta_points(pta, E, seed))
    gram, ld, st = pta_blocks(pta._core, w, pe, pd)
    gram, ld = gram.requires_grad_(True), ld.requires_grad_(True)
    gbar, ldbar = torch.autograd.grad(pta._couple(gram, ld, phi, pta._orf_ops).sum(), (gram, ld))
    return pta._core, st, gbar.contiguous(), ldbar.contiguous()


def k10_rounding_bound(core, st, gbar, ldbar):
    """Each entry's sum of the absolute values of what K10 and its twin add up
    (the standard bound of a sum's rounding: |error| <= n u sum |terms|), (for
    d/dw (E, N, n), for d/dphi (E, N, ke + kd)), and n, the longest chain of
    operations behind an entry: t_i = X_i - F_i Ahat and Ahat_e are bounded by
    |X_i| + |F_i| |Ahat|, the quadratic forms by |t|^T |Gbar| |t|, the ln|C|
    terms by |ldbar| (1/w_i + F_i S^-1 F_i^T) and |ldbar| (1/phi + (S^-1)_kk /
    phi^2). Gbar is indefinite and the two terms of an entry can cancel, so a
    set whose entries are all small against their terms is held to this bound,
    not to its largest entry."""
    import torch

    from pint_tpu_torch.fitting.pta_like import _grad_prep, _sets_of, pta_grad_plain

    E, N, n = st.w.shape
    S = E * N
    ke, kd = st.phi_e.shape[-1], st.phi_d.shape[-1]
    pulsar = torch.arange(S, device=st.w.device) % N
    X = torch.cat([core.M / st.norm[..., None], core.G, core.r[:, None]], dim=1).mT[pulsar]
    q = X.shape[-1]
    G, ld = torch.abs(_sets_of(gbar)), torch.abs(_sets_of(ldbar))
    Lt, Ad = _grad_prep(st)
    Ta = torch.abs(X)
    amps = []
    if ke:
        es = _sets_of(st.esum)
        Ae = (torch.abs(es[..., :q]) + torch.abs(es[..., q:]) @ torch.abs(Ad)) \
            / _sets_of(st.De)[..., None]
        amps.append(Ae)
        eidx = core.eidx.to(torch.int64)[pulsar]
        idx = torch.where(eidx < 0, ke, eidx)
        Ta = Ta + torch.cat([Ae, torch.zeros_like(Ae[:, :1])], dim=1)[
            torch.arange(S, device=X.device)[:, None], idx]
    if kd:
        Ta = Ta + torch.abs(core.Fd.mT[pulsar]) @ torch.abs(Ad)
        amps.append(torch.abs(Ad))
    # |ldbar| (1/w - F S^-1 F^T) is at most |ldbar| (1/w + F S^-1 F^T) <= 2 |ldbar| / w
    w = _sets_of(st.w)
    bw = torch.sum((Ta @ G) * Ta, dim=-1) + 2.0 * ld[:, None] / torch.where(w > 0, w, 1.0)
    bphi = w.new_zeros((S, 0))
    if amps:
        Ah = torch.cat(amps, dim=1)
        iphi = 1.0 / torch.cat([_sets_of(st.phi_e), _sets_of(st.phi_d)], dim=-1)
        # (S^-1)_kk <= phi_k
        bphi = iphi * iphi * torch.sum((Ah @ G) * Ah, dim=-1) + 2.0 * ld[:, None] * iphi
    return bw.reshape(E, N, n), bphi.reshape(E, N, ke + kd), q + kd + 8


def check_k10(core, st, gbar, ldbar, device, tag: str) -> float:
    """K10 against its twin on one state: d/dw and d/dphi within 1e-12 of
    each set's largest entry or, entry by entry, within twice the rounding
    bound of a sum of its terms (`k10_rounding_bound`: 2 n u sum |terms|, u
    = 2^-53), and bitwise equal across two calls. Returns the largest
    absolute error of d/dw."""
    import torch

    from pint_tpu_torch.fitting.pta_like import pta_grad, pta_grad_plain

    got, again = pta_grad(core, st, gbar, ldbar), pta_grad(core, st, gbar, ldbar)
    want = pta_grad_plain(core, st, gbar, ldbar)
    bounds = k10_rounding_bound(core, st, gbar, ldbar)
    sync(device)
    u = 2.0**-53
    for name, g, wv, b in zip(("d/dw", "d/dphi"), got, want, bounds[:2]):
        err = per_set_err(g, wv)
        ratio = float(torch.max(torch.abs(g - wv) / (2 * bounds[2] * u * b))) \
            if b.numel() else 0.0
        check(err <= 1e-12 or ratio <= 1.0,
              f"{tag}: {name} within 1e-12 of each set's largest entry ({err:.3g}), or "
              f"every entry within twice its sum's rounding bound ({ratio:.3g} of it)")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: bitwise equal across two runs")
    return float(torch.max(torch.abs(got[0] - want[0])))


def phase_k10(pta, device, label: str) -> float:
    """K10 against its twin on the kernel forward's state under the coupling's
    cotangent, at E = 1 and 8 (`check_k10`). Returns the largest absolute
    error of d/dw."""
    worst = 0.0
    for E in PTA_SETS[:2]:
        core, st, gbar, ldbar = pta_cotangents(pta, E, 52)
        worst = max(worst, check_k10(core, st, gbar, ldbar, device,
                                     f"{label}: K10 (E={E} x N={st.w.shape[1]})"))
    return worst


def check_member_design(nl, model, toas, label: str) -> float:
    """A member's design (r0, M per column, Mnorm: K1) within 1e-10 relative
    of the same NoiseLikelihood built through the twins, as phase 47's. The
    twin path of the PTA likelihood shares the members' designs (built once
    by K1) and forms everything after them (G by K8, the blocks by K3's
    stacked mode, the backward by K10) through the twins."""
    from pint_tpu_torch.fitting import NoiseLikelihood

    with twins():
        twin = NoiseLikelihood(toas, model)
    (r0, M, mn), (tr0, tM, tmn) = nl.design, twin.design
    derr = max(rel_err(r0, tr0), rel_err(mn, tmn),
               max(rel_err(M[:, j], tM[:, j]) for j in range(M.shape[1])))
    check(derr <= 1e-10, f"{label}: design (r0, M per column, Mnorm) within 1e-10 of the twin "
                         f"path's ({derr:.3g})")
    return derr


def check_pta(pta, twin, device, label: str, many: int = 256, opt: bool = True) -> dict:
    """The PTALikelihood surface of `pta` against the twin path `twin`, each of
    `pta`'s calls in a launch window of its own: loglike at 3 points,
    loglike_curn, detection_statistic, gwb_coefficient_blocks, loglike_many at
    `many` points, grad at 2 points and (with `opt`) optimize (8 restarts, 200
    steps). Bounds: the likelihoods within 1e-8 relative, the gradient within
    1e-8 of its largest entry, rho and the optimal statistic within 1e-8, the
    blocks within 1e-10 of their largest entry; optimize as phase 48."""
    import numpy as np
    import torch

    w = {k: {} for k in ("loglike", "curn", "detect", "blocks", "many", "grad", "optimize")}
    walls = {}
    pts = pta_points(pta, 3, 53)
    many_pts = pta_points(pta, many, 54)

    def timed(name, fn):
        with counted(w[name]):
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            walls[f"{name}_s"] = time.perf_counter() - t0
        return out

    ll = timed("loglike", lambda: np.array([pta.loglike(e) for e in pts]))
    curn = timed("curn", lambda: pta.loglike_curn(pts[1]))
    det = timed("detect", lambda: pta.detection_statistic(pts[1]))
    blk = timed("blocks", lambda: pta.gwb_coefficient_blocks(pts[2]))
    mny = timed("many", lambda: pta.loglike_many(many_pts))
    g = timed("grad", lambda: np.array([pta.grad(e) for e in pts[:2]]))
    with twins():
        tll = np.array([twin.loglike(e) for e in pts])
        tcurn = twin.loglike_curn(pts[1])
        tdet = twin.detection_statistic(pts[1])
        tblk = twin.gwb_coefficient_blocks(pts[2])
        tmny = twin.loglike_many(many_pts)
        tg = np.array([twin.grad(e) for e in pts[:2]])
    errs = {"loglike": float(np.max(np.abs(ll - tll) / np.abs(tll))),
            "loglike_curn": abs(curn - tcurn) / abs(tcurn),
            "ll_hd": abs(det["ll_hd"] - tdet["ll_hd"]) / abs(tdet["ll_hd"]),
            "ll_curn": abs(det["ll_curn"] - tdet["ll_curn"]) / abs(tdet["ll_curn"]),
            "rho": float(np.max(np.abs(det["rho"] - tdet["rho"]))),
            "os": abs(det["os"] - tdet["os"]),
            "blocks": max(rel_err(torch.as_tensor(blk[k]), torch.as_tensor(tblk[k]))
                          for k in ("u", "V", "phi")),
            "loglike_many": float(np.max(np.abs(mny - tmny) / np.abs(tmny))),
            "grad": float(max(np.max(np.abs(a - b)) / np.max(np.abs(b)) for a, b in zip(g, tg)))}
    check(np.all(np.isfinite(ll)) and errs["loglike"] <= 1e-8,
          f"{label}: loglike at 3 points within 1e-8 relative ({errs['loglike']:.3g})")
    check(errs["loglike_curn"] <= 1e-8 and errs["ll_hd"] <= 1e-8 and errs["ll_curn"] <= 1e-8,
          f"{label}: loglike_curn and detection_statistic's ll_hd, ll_curn within 1e-8 relative "
          f"({errs['loglike_curn']:.3g}, {errs['ll_hd']:.3g}, {errs['ll_curn']:.3g})")
    check(errs["rho"] <= 1e-8 and errs["os"] <= 1e-8,
          f"{label}: rho ({det['rho'].shape[0]} pairs) and the optimal statistic within 1e-8 "
          f"({errs['rho']:.3g}, {errs['os']:.3g})")
    check(errs["blocks"] <= 1e-10, f"{label}: gwb_coefficient_blocks within 1e-10 of the "
                                   f"largest entry ({errs['blocks']:.3g})")
    check(mny.shape == (many,) and errs["loglike_many"] <= 1e-8,
          f"{label}: loglike_many at {many} points within 1e-8 relative "
          f"({errs['loglike_many']:.3g})")
    check(np.all(np.isfinite(g)) and errs["grad"] <= 1e-8,
          f"{label}: grad at 2 points within 1e-8 of the largest entry ({errs['grad']:.3g})")
    out = {"errs": errs, "walls": walls, "loglike": ll.tolist(), "dll": det["dll"],
           "os": det["os"]}
    if opt:
        eta, lp = timed("optimize", pta.optimize)
        with twins():
            eta_t, lp_t = twin.optimize()
        with torch.no_grad():
            start = float(pta._lnpost(torch.as_tensor(pta.x0, device=pta.device)[None])[0])
        check(lp > start, f"{label}: optimize raised the ln posterior from {start:.10g} to "
                          f"{lp:.10g}")
        errs["optimize"] = abs(lp - lp_t) / abs(lp_t)
        check(errs["optimize"] <= 1e-8, f"{label}: optimize's ln posterior within 1e-8 of the "
                                        f"twin path's ({lp:.12g} vs {lp_t:.12g})")
        errs["eta_hat"] = float(np.max(np.abs(eta - eta_t) / pta.scales))
        check(errs["eta_hat"] <= 1e-6, f"{label}: eta_hat within 1e-6 prior scales of the "
                                       f"twin path's ({errs['eta_hat']:.3g})")
        out.update(lnpost=lp, lnpost_start=start)
    on_card = device.type == "cuda"
    for win, names in (("loglike", ("ecorr_normal_eq_stacked",)),
                       ("many", ("ecorr_normal_eq_stacked",)),
                       ("grad", ("ecorr_normal_eq_stacked", "pta_grad")),
                       ("optimize", ("ecorr_normal_eq_stacked", "pta_grad") if opt else ())):
        for name in names:
            n = w[win][name]
            check(n > 0 or not on_card, f"{name} launched {n} times by {label}'s {win}")
    out["windows"] = {k: v for k, v in w.items() if v}  # the windows this check ran
    return out


def k3_stacked_record(pta, E: int, device) -> dict:
    """K3's stacked mode at E points of array A; the library yardstick is the
    batched cuBLAS Gram X W X^T of each set's augmented rows X = [Mn, G, r, Fd]
    alone (in chunks of at most 1,024 sets)."""
    import torch

    from pint_tpu_torch.fitting.woodbury import (ecorr_normal_eq_stacked,
                                                 ecorr_normal_eq_stacked_plain)

    args = k3_stacked_args(pta, E, 56)
    r, M, Gc, w, Fd = args[:5]
    N, n = r.shape
    p, m = M.shape[1], Gc.shape[1]
    ke = 0 if args[5] is None else args[5].ke
    kd = 0 if Fd is None else Fd.shape[1]
    reps = 20 if E < 256 else 3
    whole, _ = measure(lambda: ecorr_normal_eq_stacked(*args), device, reps)
    plain, plain_call = measure(lambda: ecorr_normal_eq_stacked_plain(*args), device, 1)
    X = torch.cat([M / M.pow(2).sum(-1, keepdim=True).sqrt(), Gc, r[:, None]]
                  + ([Fd] if kd else []), dim=1)  # (N, V, n)
    chunk = max(1, 1024 // N)

    def library():
        for e0 in range(0, E, chunk):
            Xw = X[None] * torch.sqrt(w[e0:e0 + chunk])[:, :, None, :]
            torch.matmul(Xw, Xw.mT)

    timed = k3_against_library(lambda: ecorr_normal_eq_stacked(*args), library, device, reps)
    S = E * N
    V = p + m + 1 + kd
    nnz = 0 if args[5] is None else args[5].rows.shape[1] * N
    q = (p + m + 1) * (p + m + 2) // 2
    # read r, M, G, Fd, the CSR once, each set's w and phi; write G, c, chi2,
    # ahat, ln|C| and the backward's De, epoch sums, L, Wz, ad
    n_bytes = (N * n * V + S * (n + ke + kd)) * 8 + N * (ke + 1) * 4 + nnz * 4 \
        + S * ((p + m) ** 2 + p + m + 2 + 2 * ke + kd + ke * V + kd * (kd + p + m + 2)) * 8
    # column norms (3 per value of M); per set: ln w (LOG_OPS per row), the
    # epoch sums, each row and epoch weighted; the Gram and the fold are
    # multiply-adds
    n_ops = N * n * p * 3 + S * (n * LOG_OPS + (nnz // N) * 2 * V + (n + ke) * V)
    n_mma = S * ((n + ke) * V * (V + 1) + q * 2 * kd)
    b, how = bound_ms(n_bytes, n_ops, n_mma)
    return k3_with_build({**timed, "plain_ms": plain, "bound_ms": b, "bound_by": how,
                          "call_device_ms": whole, "plain_call_ms": plain_call,
                          "library_calls": -(-E // chunk),
                          "shape": f"E={E} N={N} rows={n} p={p} m={m} ke={ke} kd={kd}"})


def k10_record(pta, E: int, device) -> dict:
    """K10 at E points of array A on the kernel forward's state."""
    from pint_tpu_torch.fitting.pta_like import _grad_prep, pta_grad, pta_grad_plain

    core, st, gbar, ldbar = pta_cotangents(pta, E, 56)
    call = timed_ms(lambda: pta_grad(core, st, gbar, ldbar), device, 20)
    whole, _ = measure(lambda: pta_grad(core, st, gbar, ldbar), device, 20)
    plain, plain_call = measure(lambda: pta_grad_plain(core, st, gbar, ldbar), device, 3)
    _, N, n = st.w.shape
    S = E * N
    p, m = core.M.shape[1], core.G.shape[1]
    q = p + m + 1
    ke, kd = st.phi_e.shape[-1], st.phi_d.shape[-1]
    V = q + kd
    # read M, G, r, Fd and the epoch index once; each set's w, phi, gbar, the
    # forward's De and epoch sums, and the small factors; write dw and dphi
    n_bytes = N * n * (q + kd) * 8 + N * n * 4 + S * (n + 2 * (ke + kd) + ke * V + q * q + 1
                                                      + kd * kd + kd * q) * 8 \
        + S * (n + ke + kd) * 8
    # per row: t (q kd), t^T Gbar t over Gbar's symmetric half (q (q + 1) / 2)
    # and |L^-1 h|^2 (kd (kd + 1) / 2) multiply-adds; per basis column the
    # same with Ahat; Gbar's symmetrisation q^2 per set; the rest ~4 per value
    rows = q * kd + q * (q + 1) // 2 + kd * (kd + 1) // 2
    n_mma = S * 2 * ((n + ke) * rows + kd * q * (q + 1) // 2)
    n_ops = S * (4 * (n + ke) * (q + kd) + q * q)
    b, how = bound_ms(n_bytes, n_ops, n_mma)
    rec = grad_record(lambda: pta_grad(core, st, gbar, ldbar), lambda: _grad_prep(st), device,
                      K10_KERNELS)
    print(f"  K10 E={E}: {rec['ms']} ms, passes {rec['passes_ms']}, queued {rec['queued_ms']}, "
          f"twin prep {rec['twin_prep_ms']}")
    return {**rec, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "call_device_ms": whole, "plain_call_ms": plain_call,
            "shape": f"E={E} N={N} rows={n} p={p} m={m} ke={ke} kd={kd}"}


#: the optimize whose busy share phase 56 profiles: 20 of its 200 steps (the
#: profiler's cost grows with the ~10^5 kernel events of a whole one)
PTA_PROFILED_STEPS = 20


def pta_walls(pta, device, optimize_s: float) -> dict:
    """Warm walls (host clock, ending in a synchronize) of loglike, grad,
    loglike_many (256 points) and an optimize of PTA_PROFILED_STEPS steps on
    array A, with phase 53's optimize wall (`optimize_s`, 200 steps, after
    warm calls of every piece it runs), then device time by kernel over one
    more grad and short optimize under torch.profiler, and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts = pta_points(pta, 256, 56)
    calls = {"loglike": lambda: pta.loglike(pta.x0), "grad": lambda: pta.grad(pta.x0),
             "loglike_many_256": lambda: pta.loglike_many(pts),
             "optimize_20": lambda: pta.optimize(n_steps=PTA_PROFILED_STEPS)}
    out = {"optimize_200_s": optimize_s}
    for name, fn in calls.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out[f"{name}_s"] = time.perf_counter() - t0
    if device.type != "cuda":
        return out
    for name in ("grad", "optimize_20"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls[name]()
            sync(device)
        kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(us for _, us in kern) / 1e6
        k10 = sum(us for k, us in kern if any(p in k for p in K10_KERNELS)) / 1e6
        k3 = sum(us for k, us in kern if named(k, K3_KERNEL)) / 1e6
        out[f"{name}_profile"] = {
            "device_busy_s": busy, "busy_share": busy / out[f"{name}_s"], "k3_s": k3,
            "k10_s": k10, "top": [[k[:70], us / 1e6]
                                  for k, us in sorted(kern, key=lambda r: -r[1])[:6]]}
    return out


def pta_phases(device, summary: dict, noise: dict, shape=PTA_SHAPE, small: int = 8192,
               dense_rows: int = 1024) -> dict:
    """Phases 50-56 (``PINT_TPU_NBODY=0`` set around them): array A
    (``pta_smoke_array(*shape)``) built by the port's simulation, K3's stacked
    mode and K10 against their twins, PTALikelihood against the twin path,
    arrays B and C (8 pulsars of `small` TOAs: the test par's ECORR epochs;
    ragged without ECORR), array D (4 pulsars of `dense_rows` TOAs) against
    the dense joint, and times."""
    import numpy as np
    import torch

    from pint_tpu_torch.fitting import PTALikelihood
    from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq, ecorr_normal_eq_sets
    from pint_tpu_torch.profiles import pta_smoke_array

    n_psr, n_toas, seed = shape
    windows, recs, rec = {}, {"ecorr_normal_eq_stacked": {}, "pta_grad": {}}, {}
    clock = {"t": time.perf_counter(), "phase_s": {}}

    def lap(phase: int) -> None:
        now = time.perf_counter()
        clock["phase_s"][phase] = now - clock["t"]
        clock["t"] = now
    with knobs(PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
        print(f"phase 50: array A, pta_smoke_array({n_psr}, {n_toas}, seed={seed}), "
              "on the card by the port's simulation")
        zeroed = []
        with counted(windows.setdefault("pta_simulate", {})), zeroed_residuals(zeroed):
            t0 = time.perf_counter()
            models, toas = pta_smoke_array(n_psr, n_toas, seed=seed, device=device)
            sync(device)
            sim_s = time.perf_counter() - t0
        check(len(zeroed) == n_psr and max(zeroed) < 1e-9,
              f"each pulsar's fake TOAs lie on its model (zero_residuals, largest residual "
              f"{max(zeroed):.3g} s < 1 ns)")
        for name in ("resid_tangent", "site_geometry", "analytic_ephemeris", "fourier_basis"):
            n = windows["pta_simulate"][name]
            check(n > 0 or device.type != "cuda", f"{name} launched {n} times by the simulation")
        with counted(windows.setdefault("pta_build", {})):
            members, design_s = pta_members(models, toas, device, PTA_START)
            t0 = time.perf_counter()
            pta = PTALikelihood(members)
            sync(device)
            build_s = time.perf_counter() - t0
        eig = float(np.linalg.eigvalsh(pta.orf).min())
        check(eig > 0, f"the {n_psr} x {n_psr} Hellings-Downs ORF positive definite (least "
                       f"eigenvalue {eig:.4g})")
        dims = (len(members), pta.rows, pta.p_lin, pta._core.G.shape[1],
                0 if pta._core.Fd is None else pta._core.Fd.shape[1], len(pta.psr_hyper),
                pta.nparams)
        check(dims == (n_psr, n_toas, 6, 12, 10, 3, 3 * n_psr + 2),
              f"array A at (N, rows, p_lin, m, kd, h, eta) = {dims}")
        rec["array_a"] = {"simulate_s": sim_s, "member_designs_s": design_s,
                          "pta_build_s": build_s, "zeroed_residual_max_s": max(zeroed),
                          "orf_min_eig": eig, "dims": dims, "gw_tspan_s": pta.gw_tspan}
        print("  build walls (s): " + json.dumps({k: v for k, v in rec["array_a"].items()
                                                  if k.endswith("_s")}))

        lap(50)
        print("phase 51: K3's stacked mode against its twin; the older modes unchanged")
        k3 = phase_k3_stacked(pta, device, "array A", PTA_SETS)
        for E, old in noise["k3"].items():
            again = ecorr_normal_eq_sets(*old["args"])
            sync(device)
            check(torch.equal(again.chi2, old["chi2"]) and torch.equal(again.G, old["G"]),
                  f"K3's per-set mode at phase 45's E = {E} call bitwise unchanged")
        for label, old in noise["k3_old"].items():
            again = ecorr_normal_eq(*old["args"])
            sync(device)
            check(all(torch.equal(a, b) for a, b in zip(again, old["out"])),
                  f"K3's shared-weight mode at phase 29's {label} shape bitwise unchanged")

        lap(51)
        print("phase 52: K10 pta_grad against its twin")
        k10_err = phase_k10(pta, device, "array A")

        lap(52)
        print("phase 53: PTALikelihood on array A against the twin path")
        derr = check_member_design(members[0], models[0], toas[0], "array A's pulsar 0")
        with twins():
            twin = PTALikelihood(members)
        main = check_pta(pta, twin, device, "array A")
        main["errs"]["member_design"] = derr
        windows.update({f"pta_{k}": v for k, v in main.pop("windows").items()})
        del twin

        lap(53)
        print("phase 54: arrays B (the test par's ECORR epochs) and C (ragged, no ECORR)")
        arrays = {}
        for label, par, epochs, sd in (
                ("array B", PTA_TEST_PAR, [small // 2] * 8, 5),
                ("array C", PTA_RAGGED_PAR,
                 np.linspace(3 * small // 8, small // 2, 8).astype(int), 13)):
            t0 = time.perf_counter()
            ms, ts = pta_test_array(device, 8, epochs, par, sd)
            one, _ = pta_members(ms, ts, device)
            arr = PTALikelihood(one)
            sync(device)
            wall = time.perf_counter() - t0
            info = {"build_s": wall, "rows": arr.rows, "n_data": [nl._n_data for nl in one],
                    "ke": 0 if arr._core.epochs is None else arr._core.epochs.ke,
                    "kd": arr._core.Fd.shape[1], "m": arr._core.G.shape[1]}
            info["k3"] = phase_k3_stacked(arr, device, label, PTA_SETS[:2])
            info["k10_err"] = phase_k10(arr, device, label)
            with twins():
                tw = PTALikelihood(one)
            info.update(check_pta(arr, tw, device, label, many=8, opt=False))
            windows.update({f"pta_{label[-1]}_{k}": v for k, v in info.pop("windows").items()})
            arrays[label] = info
            print(f"  {label}: " + json.dumps({k: info[k] for k in
                                                ("build_s", "rows", "ke", "kd", "m")}))
        check(arrays["array B"]["ke"] == small // 2 and arrays["array C"]["rows"] == small
              and min(arrays["array C"]["n_data"]) < small,
              f"array B with {small // 2} ECORR epochs a pulsar; array C ragged "
              f"({min(arrays['array C']['n_data'])}-{max(arrays['array C']['n_data'])} TOAs) in "
              f"buckets of {small} rows")

        lap(54)
        print(f"phase 55: array D (4 pulsars of {dense_rows} TOAs) against the dense joint")
        md, td = pta_smoke_array(4, dense_rows, seed=seed, device=device)
        ptd = PTALikelihood(pta_members(md, td, device)[0])
        dense = ptd.dense_joint_program()
        d_out = {}
        for k, eta in enumerate(pta_points(ptd, 2, 55)):
            t0 = time.perf_counter()
            fused = ptd.loglike(eta)
            sync(device)
            d_out.setdefault("fused_s", []).append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ref = dense(eta)
            sync(device)
            d_out.setdefault("dense_s", []).append(time.perf_counter() - t0)
            err = abs(fused - ref) / abs(ref)
            d_out.setdefault("rel_err", []).append(err)
            check(err <= 1e-8, f"array D point {k}: the fused loglike within 1e-8 relative of "
                               f"the dense joint ({fused:.12g} vs {ref:.12g})")

        lap(55)
        print("phase 56: K3's stacked mode and K10 times, PTA walls and busy share")
        for E in PTA_SETS:
            r = k3_stacked_record(pta, E, device)
            recs["ecorr_normal_eq_stacked"].update(r if E == 1 else
                                                   {f"e{E}_{k}": v for k, v in r.items()})
            if E <= 8:
                r = k10_record(pta, E, device)
                recs["pta_grad"].update(r if E == 1 else {f"e{E}_{k}": v for k, v in r.items()})
        rows_share(recs["pta_grad"])
        walls = pta_walls(pta, device, main["walls"]["optimize_s"])
        print("  walls (s): " + json.dumps({k: v for k, v in walls.items() if k.endswith("_s")}))
        lap(56)
        print("  phase walls (s): " + json.dumps(clock["phase_s"]))
    summary["pta"] = {**rec, "errs": main["errs"], "checked_walls": main["walls"],
                      "dll": main["dll"], "os": main["os"], "lnpost": main.get("lnpost"),
                      "lnpost_start": main.get("lnpost_start"),
                      "k3_errs": {E: v["errs"] for E, v in k3.items()}, "k10_err": k10_err,
                      "arrays": arrays, "array_d": d_out, "walls": walls,
                      "phase_s": clock["phase_s"]}
    errs = {"ecorr_normal_eq_stacked": max(v["chi2_abs_err"] for v in k3.values()),
            "pta_grad": k10_err}
    return {"recs": recs, "errs": errs, "windows": windows}


# --- phase 58: K9 and K10 on random inputs --------------------------------------------


def k9_random(n: int, p: int, ke: int, kd: int, E: int, marg: bool, seed: int, device,
              width: int = 8):
    """(core, state) of K9 on random inputs drawn from `seed` (numpy): n rows
    in a random order, the first ke x width of them in ke epochs of `width`
    rows (the rest in none), p timing and kd dense columns, E weight sets;
    the state from the likelihood's forward (K3's per-set mode on a card)."""
    import numpy as np
    import torch

    from pint_tpu_torch.fitting.noise_like import NoiseCore, noise_forward
    from pint_tpu_torch.fitting.woodbury import epoch_index

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    eidx = np.full(n, -1)
    k = min(n, ke * width)
    eidx[:k] = np.repeat(np.arange(ke), width)[:k]
    eidx = eidx[rng.permutation(n)]
    M = t(rng.standard_normal((p, n)))
    core = NoiseCore(r0=t(rng.standard_normal(n)), M=M, mnorm=torch.sqrt(torch.sum(M * M, dim=1)),
                     Fd=t(rng.standard_normal((kd, n))) if kd else None,
                     epochs=epoch_index(torch.tensor(eidx, device=device), ke) if ke else None,
                     eidx=torch.tensor(eidx, dtype=torch.int32, device=device), marginalize=marg)
    w, pe, pd = (t(rng.uniform(0.5, 2.0, shape)) for shape in ((E, n), (E, ke), (E, kd)))
    _, st = noise_forward(core, w, pe, pd)
    return core, st


def k10_random(n: int, N: int, p: int, m: int, ke: int, kd: int, E: int, seed: int, device,
               width: int = 2, pad: int = 0):
    """(core, state, gbar, ldbar) of K10 on random inputs drawn from `seed`
    (numpy): N pulsars of n bucket rows, up to
    `pad` rows at the end (pulsar a: a pad / (N - 1) of them) pad rows
    (zero data, w = 0), the first ke x width data rows in
    ke epochs of `width` rows; p timing, m common and kd dense columns, E
    points; the state from the blocks' forward (K3's stacked mode on a
    card), gbar and ldbar standard normal (gbar indefinite, as the
    coupling's)."""
    import numpy as np
    import torch

    from pint_tpu_torch.fitting.pta_like import PTACore, pta_blocks
    from pint_tpu_torch.fitting.woodbury import stacked_epochs

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    data = n - (np.arange(N) * pad) // max(N - 1, 1)  # pulsar a's data rows
    live = np.arange(n)[None, :] < data[:, None]
    eidx = np.full((N, n), -1)
    for a in range(N):
        k = min(int(data[a]), ke * width)
        eidx[a, :k] = np.repeat(np.arange(ke), width)[:k]
    r = rng.standard_normal((N, n)) * live
    M = rng.standard_normal((N, p, n)) * live[:, None]
    G = rng.standard_normal((N, m, n)) * live[:, None]
    Fd = rng.standard_normal((N, kd, n)) * live[:, None]
    core = PTACore(r=t(r), M=t(M), G=t(G), Fd=t(Fd) if kd else None,
                   epochs=stacked_epochs(torch.tensor(eidx, device=device), ke) if ke else None,
                   eidx=torch.tensor(eidx, dtype=torch.int32, device=device))
    w = t(rng.uniform(0.5, 2.0, (E, N, n)) * live[None])
    pe, pd = t(rng.uniform(0.5, 2.0, (E, N, ke))), t(rng.uniform(0.5, 2.0, (E, N, kd)))
    _, _, st = pta_blocks(core, w, pe, pd)
    q = p + m + 1
    return core, st, t(rng.standard_normal((E, N, q, q))), t(rng.standard_normal((E, N)))


#: phase 58's K9 shapes (n, p, ke, kd, E, marginalized): odd widths, rows not a
#: multiple of a tile, p 0, kd 0, ke 0, the DM-noise variant's kd 120, and a
#: width for each of the kernel's instances (value columns p + 1 up to 24, 48
#: and 96: 3, 6 and 12 n tiles)
K9_SWEEP = ((3001, 7, 40, 3, 3, True), (3001, 7, 40, 3, 3, False), (2000, 0, 50, 0, 3, True),
            (2000, 12, 0, 20, 3, True), (2048, 30, 64, 10, 3, True),
            (2048, 30, 64, 10, 3, False), (16384, 81, 2048, 120, 3, True),
            (16384, 81, 2048, 60, 3, False))
#: phase 58's K10 shapes (n, N, p, m, ke, kd, E, pad rows): pad rows, odd
#: widths, ke 0 and kd 0, array B's epochs, and q = p + m + 1 of 40 and 90
#: (the kernel's 6- and 12-tile instances; the others run q up to 24)
K10_SWEEP = ((1000, 3, 5, 4, 40, 3, 3, 137), (8192, 8, 6, 12, 0, 10, 3, 1000),
             (2048, 4, 3, 2, 0, 0, 3, 0), (4096, 8, 5, 6, 2048, 0, 2, 100),
             (2048, 4, 30, 9, 64, 10, 3, 100), (2048, 4, 70, 19, 64, 10, 3, 100))


def grad_sweep_phases(device, summary: dict) -> dict:
    """Phase 58: K9 and K10 against their twins on random inputs drawn from
    a seed (`k9_random`, `k10_random`) at K9_SWEEP's and K10_SWEEP's shapes,
    under phase 46's and phase 52's gates (`check_k9`, `check_k10`),
    bitwise across two calls."""
    print("phase 58: K9 and K10 on random inputs against their twins")
    errs = {"noise_grad": 0.0, "pta_grad": 0.0}
    for k, (n, p, ke, kd, E, marg) in enumerate(K9_SWEEP):
        core, st = k9_random(n, p, ke, kd, E, marg, 58 + k, device)
        errs["noise_grad"] = max(errs["noise_grad"], check_k9(
            core, st, device, f"K9 random (n={n}, p={p}, ke={ke}, kd={kd}, E={E}, "
                              f"{'marginalized' if marg else 'profiled'})"))
        del core, st
    for k, (n, N, p, m, ke, kd, E, pad) in enumerate(K10_SWEEP):
        core, st, gbar, ldbar = k10_random(n, N, p, m, ke, kd, E, 68 + k, device, pad=pad)
        errs["pta_grad"] = max(errs["pta_grad"], check_k10(
            core, st, gbar, ldbar, device, f"K10 random (n={n}, N={N}, p={p}, m={m}, ke={ke}, "
                                           f"kd={kd}, E={E}, pad rows {pad})"))
        del core, st, gbar, ldbar
    summary["grad_sweep_errs"] = errs
    return {"recs": {}, "errs": errs, "windows": {}}


# --- phase 57: pulse-number offsets and TRACK -2 (ROADMAP C11) ---------------------

#: the phase's fake TOAs: SMOKE_PAR at gbt over two years, 1 us white noise
C11_TOAS = 16384


def c11_tims(device, tmp: Path) -> dict:
    """Two .tim files of C11_TOAS fake SMOKE_PAR TOAs simulated on `device`:
    "offsets" (PHASE 0.5 over TOAs 100-299, -padd 0.25 on 400-599, -phase
    -0.125 on 700-899, -pn on every TOA, one turn above the nearest pulse on
    1,000-1,099) and "fit" (whole-turn offsets: PHASE 1 over 1,200-1,399,
    -padd 2 on 200-399, -phase -1 on 500-599, and -pn flags that follow
    them)."""
    import numpy as np

    from pint_tpu_torch.io.tim import TOALine, write_tim
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import SMOKE_PAR
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import add_noise_from_model, make_fake_toas_fromMJDs

    rng = np.random.default_rng(57)
    model = get_model(SMOKE_PAR, from_text=True, device=device)
    mjds = np.sort(rng.uniform(54700.0, 55400.0, C11_TOAS))
    freqs = np.where(np.arange(C11_TOAS) % 2, 1400.0, 2300.0)
    toas = make_fake_toas_fromMJDs(mjds, model, obs="gbt", freq_mhz=freqs, error_us=1.0)
    toas = add_noise_from_model(toas, model, rng)
    pn = Residuals(toas, model).pulse_numbers.cpu().numpy()
    ep = toas.utc_raw
    base = tmp / "c11_base.tim"
    write_tim([TOALine(name=f"c11_{i}", freq_mhz=float(toas.freq_mhz[i]), mjd_day=int(ep.day[i]),
                       mjd_frac_hi=float(ep.frac_hi[i]), mjd_frac_lo=float(ep.frac_lo[i]),
                       error_us=float(toas.error_us[i]), obs="gbt") for i in range(C11_TOAS)],
              str(base))
    lines = base.read_text().splitlines()
    head = [ln for ln in lines if not ln.startswith("c11_")]
    body = [ln for ln in lines if ln.startswith("c11_")]

    def tim(name, flags, blocks, shift):
        out = list(head)
        for i, line in enumerate(body):
            out += [f"PHASE {t!r}" for first, _, t in blocks if i == first]
            out.append(f"{line} {flags.get(i, '')} -pn {int(pn[i] + shift[i])}".replace("  ", " "))
            out += [f"PHASE {-t!r}" for _, last, t in blocks if i == last]
        path = tmp / f"c11_{name}.tim"
        path.write_text("\n".join(out) + "\n")
        return path

    flags = {i: "-padd 0.25" for i in range(400, 600)}
    flags.update({i: "-phase -0.125" for i in range(700, 900)})
    shift = np.zeros(C11_TOAS)
    shift[1000:1100] = 1.0
    offsets = tim("offsets", flags, ((100, 299, 0.5),), shift)
    flags = {i: "-padd 2" for i in range(200, 400)}
    flags.update({i: "-phase -1" for i in range(500, 600)})
    shift = np.zeros(C11_TOAS)
    shift[200:400] += 2.0
    shift[500:600] -= 1.0
    shift[1200:1400] += 1.0
    fit = tim("fit", flags, ((1200, 1399, 1.0),), shift)
    return {"offsets": offsets, "fit": fit}


def pulse_number_phases(device, summary: dict) -> dict:
    """Phase 57: the .tim pulse-number offsets (-padd, -phase, the PHASE
    command) and TRACK -2's -pn pulse numbers through the port on the card:
    K1 with the tensor's ``delta_pn`` and ``track_pn`` against its twin
    (bitwise without the TZR row, as phase 34; within 1 ps with it, pulse
    numbers equal), the tracked pulse numbers equal to the flags, and the
    downhill WLS fit of SMOKE_PAR under TRACK -2 from a moved start against
    the twin path (phase 6's gates)."""
    import numpy as np
    import torch

    from pint_tpu_torch.fitting import DownhillWLSFitter
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.profiles import SMOKE_PAR
    from pint_tpu_torch.residuals import Residuals

    print(f"phase 57: pulse-number offsets and TRACK -2 (C11), {C11_TOAS} fake TOAs from .tim")
    out = {"windows": {}, "recs": {}, "errs": {}}
    with tempfile.TemporaryDirectory() as tmp, knobs(PINT_TPU_NBODY="0"):
        tims = c11_tims(device, Path(tmp))
        lanes = ("RAJ", "DECJ", "F0", "F1", "DM")
        errs = []
        for k, (label, par) in enumerate((("no TZR, TRACK -2", strip_tzr(SMOKE_PAR) + "TRACK -2\n"),
                                          ("no TZR, nearest", strip_tzr(SMOKE_PAR)),
                                          ("TRACK -2", SMOKE_PAR + "TRACK -2\n"),
                                          ("nearest", SMOKE_PAR))):
            path = Path(tmp) / f"c11_{k}.par"
            path.write_text(par)
            model, toas = get_model_and_toas(str(path), str(tims["offsets"]), device=device)
            res = Residuals(toas, model)
            tensor = res.tensor
            check("delta_pn" in tensor and ("track_pn" in tensor) == ("TRACK" in label),
                  f"C11 {label}: the tensor carries delta_pn"
                  + (" and track_pn" if "TRACK" in label else ", no track_pn"))
            if "no TZR" in label:
                r = compare_k1_exact(model, model.params, tensor, lanes, device, f"C11 K1 {label}")
            else:
                r = compare_k1(model, model.params, tensor, lanes, device, 1e-12, f"C11 K1 {label}")
            errs.append(r["max_abs_err"])
            if "TRACK" in label:
                flags = torch.as_tensor(toas.get_pulse_numbers(), device=device)
                check(torch.equal(res.pulse_numbers, flags),
                      f"C11 {label}: the residuals' pulse numbers are the -pn flags")
            if label == "TRACK -2":  # anchored at the TZR: the flags' pulses are the true ones
                rp = res.phase_resids.cpu().numpy()
                lag = rp[1000:1100] - np.median(rp[1100:])
                check(bool(np.all(np.abs(lag + 1.0) < 0.01)),
                      f"C11 {label}: a turn more on TOAs 1,000-1,099 is a turn less of residual")
        out["errs"]["resid_tangent"] = max(errs)
        path = Path(tmp) / "c11_fit.par"
        path.write_text(SMOKE_PAR + "TRACK -2\n")
        main_twin = []
        for route in ("main", "twin"):
            with (twins() if route == "twin" else contextlib.nullcontext()):
                model, toas = get_model_and_toas(str(path), str(tims["fit"]), device=device)
                free = tuple(model.free_params)
                delta = torch.tensor([START_SHIFT.get(n, 0.0) for n in free],
                                     dtype=torch.float64, device=device)
                model.params = apply_delta(model.params, free, delta)
                ftr = DownhillWLSFitter(toas, model)
                check("track_pn" in ftr.tensor and "delta_pn" in ftr.tensor,
                      f"C11 {route} fit: the fitter's tensor tracks the -pn pulse numbers")
                main_twin.append(run_main_path(ftr, device, grid=False))
        main, twin = main_twin
        if device.type == "cuda":
            check(main["fit_launches"]["resid_tangent"] > 0,
                  f"C11 fit: K1 launched {main['fit_launches']['resid_tangent']} times")
        check_fit(main, twin, "C11 TRACK -2 WLS")
        out["windows"]["c11_fit"] = main["fit_launches"]
        out["fit_s"] = main["fit_s"]
        print(f"  C11 fit {main['fit_s'] * 1e3:.1f} ms, {main['fitter'].result.iterations} "
              f"iterations, K1 launched {main['fit_launches']['resid_tangent']} times")
    summary["c11"] = {"fit_s": out["fit_s"], "k1_max_abs_err_s": out["errs"]["resid_tangent"]}
    return out


def phases(device_name: str = "cuda") -> dict:
    """Phases 2-58 on `device_name`; returns the summary record."""
    from pint_tpu_torch.device import resolve_device
    from pint_tpu_torch.ops import build

    device = resolve_device(device_name)
    summary = {}
    if device.type == "cuda":
        print("phase 2: build kernels")
        summary["build_s"] = build.build_all()
        summary["nvcc_s"] = dict(build.NVCC_SECONDS)
        print(f"  built in {summary['build_s']:.2f} s into {build.build_dir()}; nvcc seconds "
              f"by source {json.dumps(summary['nvcc_s'])}")
        summary["ptxas"], summary["ptxas_instances"] = {}, {}
        for name in build.SOURCES:
            summary["ptxas"][name] = build.ptxas_summary(name)
            summary["ptxas_instances"][name] = build.ptxas_report(name)
            print(f"  {name}: {summary['ptxas'][name]}")
        for fn, (regs, spill) in summary["ptxas_instances"]["resid_tangent"].items():
            print(f"    {fn}: {regs} registers, {spill} bytes of spill stores")
        k3 = k3_build_info()
        summary["k3_build"] = k3
        print(f"  ecorr_normal_eq: {k3['sass_dmma']} DMMA instructions in its SASS; gram_pass "
              f"ptxas {json.dumps(k3['gram_ptxas'])}")
        check(bool(k3["sass_dmma"]), "K3's Gram runs on the float64 tensor cores (DMMA in SASS)")
        for name, tag in (("noise_grad", "K9"), ("pta_grad", "K10")):
            info = summary[f"{name}_build"] = grad_build_info(name)
            print(f"  {name}: {info['sass_dmma']} DMMA instructions in its SASS; ptxas "
                  f"{json.dumps(info['ptxas'])}")
            check(bool(info["sass_dmma"]),
                  f"{tag}'s products run on the float64 tensor cores (DMMA in SASS)")
    walls = summary.setdefault("group_s", {})

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(device, summary, *args)
        walls[name] = time.perf_counter() - t0
        print(f"  [{name} phases: {walls[name]:.1f} s]")
        return out

    smoke = timed("smoke", smoke_phases)
    flag = timed("flagship", flagship_phases)
    prep = timed("prepare", prepare_phases, flag)
    ephem = timed("ephemeris", ephemeris_phases)
    dd = timed("dd", dd_phases)
    ng = timed("nanograv", nanograv_phases)
    bins = timed("binaries", binary_phases)
    wb = timed("wideband", wideband_phases)
    noise = timed("noise", noise_phases, ng)
    pta = timed("pta", pta_phases, noise)
    c11 = timed("pulse_numbers", pulse_number_phases)
    sweep = timed("grad_sweep", grad_sweep_phases)
    windows = {"smoke_fit": smoke["fit"], "smoke_grid": smoke["grid"],
               "flagship_fit": flag["fit"], "flagship_grid": flag["grid"],
               "tim_prepare": prep["prepare"], "tim_fit": prep["fit"], "tim_grid": prep["grid"],
               **ephem["windows"], **dd["windows"], **ng["windows"], **bins["windows"],
               **wb["windows"], **noise["windows"], **pta["windows"], **c11["windows"]}
    kernels = []
    parts = (smoke, flag, prep, ephem, dd, ng, bins, wb, noise, pta, c11, sweep)
    for name, src, replaces in KERNELS:
        rec = {k: v for r in parts for k, v in r["recs"].get(name, {}).items()}
        err = max(r["errs"].get(name, 0.0) for r in parts)
        # the library is the source's (K3's two modes, K8's passes share one)
        ptxas = summary.get("ptxas_instances", {}).get(Path(src).stem, {})
        # K8's two passes (columns, Fourier) count under its name
        counted_as = (name, "fourier_basis") if name == "linear_columns" else (name,)
        launches = {k: sum(w[c] for c in counted_as) for k, w in windows.items()}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(launches.values()),
                        **{f"launches_{k}": v for k, v in launches.items()},
                        "max_abs_err": err, **rec,
                        "ptxas": {fn: {"registers": r, "spill_store_bytes": sp}
                                  for fn, (r, sp) in ptxas.items()}})
    summary["kernels"] = kernels
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "pint_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} holds no pint_tpu_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    print("phase 1: device")
    dev_line = device_line()
    print(dev_line)
    summary = phases("cuda")
    kernels = summary.pop("kernels")
    print(json.dumps({"summary": summary}))
    print(json.dumps({"kernels": kernels}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
