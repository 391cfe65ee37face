"""Drive the PyTorch/CUDA port's main paths once on one GPU, and check them.

    python3 chip_smoke.py

Phases, each printing lines of its own:

1. device  — requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds the CUDA kernels from ``sprsolve_tpu_torch/csrc`` with
   nvcc (one per source, in parallel); prints the build seconds.
3. kernels — K1 first at the edges of its 1024-row tile (``K1_EDGES``, at
   most 65,280 rows: a last tile of 256·odd rows, halos wider than a tile,
   odd offsets beyond its 128 staged rows, int8, bf16, f32 and f64 bands):
   within Y_RTOL of its plain version, halos zero after a NaN block was
   freed, one kernel per call, a CUDA-graph replay bitwise eager, the same
   bits with the card said to have 1 or 7 SMs and with each body forced
   (one thread per row; 4-row tiles with plain or streamed band loads),
   and K3's y, K2's y and the
   columns of a K1b block bitwise K1's.  Then K1 (dia_spmv), K2 (dia_wdot,
   in all four variants) and K3
   (dia_dot) against their plain PyTorch versions on the card, on the 100³
   Poisson (int8 bands), a random band set that does not narrow, a
   bf16-exact set and an f64 set; narrow band storage must give bitwise the
   output of the same values stored f32, and K1 the same bits on grids of
   1 or 7 SMs and with each of its bodies.  K4 (orth_norm) first at the
   edges of its tile (``K4_EDGES``: one ragged tile, a halo as wide as the
   body or wider than a tile, no halo, the 100³ layout in f32 and f64):
   within Y_RTOL and DOT_RTOL of its plain version, halos zero after a NaN
   block was freed, v₊ and Σv₊² bitwise the same on grids of 1 or 7 SMs;
   then against its plain version on f32 and f64 vectors of the 100³
   layout, with β and α as 0-d CUDA tensors, one kernel a call under
   torch.profiler, its outputs bitwise the same over 10 eager calls and 3
   graph replays, the ticket back at 0.  K5 (dia_complex_spmv), K6 (dia_complex_dot, ``conj_x``
   false and true) and K7 (dia_complex_wdot, all four variants) against
   their plain versions at 1M rows on the damped complex-symmetric Poisson
   (int8 real and bf16 imaginary plane), the Poisson times (1 + 0.5i), a
   random c64 and a random c128 set; narrow planes bitwise equal to the
   same values stored f32, halos zero after a NaN block was freed.  K2 (all
   four variants) and K3 on every real band set: y bitwise K1's on the
   same input (x ⊙ dinv under the fold), the dots of 10 eager calls and of
   3 CUDA-graph replays bitwise the same, every ticket back at 0; on the
   Poisson, torch.profiler sees one kernel per call.  The same for K6
   (both forms) and K7 (all four variants) on every complex band set, with
   y bitwise K5's: K6's on x, K6 with ``conj_x`` on conj(x), K7's without
   the fold on x; on the damped set one kernel per call.  Prints the
   wrapper-timed and graph-replayed median times, warm in L2 (``ms``) and
   cold (``cold_ms``: rotating through copies of the inputs whose total
   exceeds twice L2), the plain versions', each kernel's bound, K2's
   w = r0 variant as a row of its own and, for K1 and K5, the time of
   ``torch.mv`` on a ``torch.sparse_csr_tensor`` of the same matrix.
   K1b (dia_spmm, the column-batched K1) on every real band set at 1, 3,
   4, 8, 12 and 17 columns, and at every other shape phase 14 gives it
   (64³ at 4, 8, 12 columns; 32³ at 8 and 16): each column bitwise K1's
   on it, also with the card said to have 1 or 7 SMs (one wave of a few
   blocks walking the tiles), halo rows zero after a NaN block was freed,
   within Y_RTOL of its plain version, one kernel per call under
   torch.profiler; its graph-replayed warm and
   cold times at the shift-invert shape (64³) and the LOBPCG shape
   (100³), m = 12, beside twelve K1 calls, its plain version, its bytes
   bound and ``torch.sparse.mm`` on the same CSR.
3b. U/P    — CG's fused updates (``fused.cg_update``, ``fused.cg_direction``)
   on flat vectors of the 100³ and 256³ Poisson's padded length, f32 and
   f64, with and without d⁻¹: within Y_RTOL and DOT_RTOL of their plain
   versions on the card, one count a call, and with d⁻¹ their
   graph-replayed warm and cold times beside their bound and the plain
   versions' (``phase_cg_fused``).
3c. GS     — the multigrid colour step (``gs_color.color_step``) at the
   benchmark's HPCG shapes, 256³/128³/64³/32³ in f64 with 27 f64 bands and
   64³ in f32 with int8 bands: every colour, from a random z and from
   z = 0, within 32·eps of its plain version on the card, other rows
   untouched, one count a launch, launches bitwise equal; graph-replayed
   warm and cold times beside the bound (37·n bytes in f64) and the plain
   version's; HPCG's cycle at 256³ within 1e-12 of the plain reference
   (``tests/torch/hpcg_reference.py``); a prepared CG solve with the cycle
   launching ``steps_per_apply()`` × (its + 1) colour steps
   (``phase_gs_color``).
3d. A/B    — CS-MINRES's fused updates (``fused.csm_lanczos``,
   ``fused.csm_update``) on flat complex vectors of the 100³ (c64, c128)
   and 256³ (c64) damped Poisson's padded length, with and without d⁻¹:
   v', w', p', x within Y_RTOL of their plain versions on the card, A's
   Givens scalars within 10·DOT_RTOL, the predicates equal, one count a
   call; at 256³ c64 with d⁻¹ their graph-replayed warm and cold times
   beside their bound ((5·8 + 4)·n and 10·8·n bytes) and the plain
   versions'; one prepared CS-MINRES solve with 1/|d| on the damped 100³
   Poisson launching K5 once and K6, A and B its + 1 times each, timed
   beside the unfused loop, whose count must lie within ``parity_band``
   (``phase_csm_fused``).
4. slice   — ``solve(A, b, method="bicgstab", M="jacobi")`` on the 100³
   Poisson in f32, with the launch counters reset just before: it must
   converge, reach a true relative residual (f64, scipy) below 1e-3, launch
   K1 at least once and K2 twice per iteration. Then the same through
   ``prepare`` (median of 3 timed solves).
5. f64     — BiCGStab on the padded-DIA kernels in f64 on the reference's
   100×100 Dirichlet grid, tol 1e-16.
6. symmetric — the symmetric slice on the same f32 Poisson and rhs, each
   solve with the launch counters reset just before: MINRES (K1 once, K3
   and K4 iterations + 1 times each, K2 never), CG with Jacobi (K3, U and
   P iterations times each, K4 never) and ``method="auto"`` (routes to MINRES: K4
   launches); all converge to a true residual below 1e-3.  Then MINRES and
   CG through ``prepare`` (median of 3 timed solves, then one profiled:
   device µs per iteration and idle share), and the same solves through an
   operator that calls the plain versions on the card.
7. f64 symmetric — MINRES and CG on the f64 kernels, 100×100 folded grid
   Laplacian (negative definite): MINRES converges, CG ends in BREAKDOWN,
   and CG on the negated matrix converges; true residuals below 1e-9.
8. nonsymmetric — ``method="auto"`` with Jacobi on the 100³
   convection-diffusion operator (Péclet 20, f32) routes to BiCGStab(ℓ=2):
   it converges, and K2 launches 4 times per cycle.
9. complex — the damped complex-symmetric 100³ Poisson (A + 0.5i·I, c64)
   with b = r + 0.25i·r, tol 1e-4, each solve through ``solve()`` with no
   ``device`` argument (the card by default), the launch counters reset
   just before: ``method="auto", M="jacobi"`` routes
   to COCG with the complex Jacobi (K5 once per iteration plus once);
   ``"cs_minres"`` with the real 1/|d| Jacobi (K6 once per pass, K5 once);
   ``"bicgstab"`` with the complex Jacobi folded into K7 (twice per
   iteration); K1-K4 never.  Each converges to a true relative residual
   (scipy, c128) below 1e-3.  Then each through ``prepare`` (median of 3
   timed solves) beside the same solve through an operator that calls the
   plain versions on the card, and one profiled solve each (idle share).
10. c128   — the reference's complex fixtures at 100×100 on the c128
   kernels, tol 1e-12: MINRES on the Hermitian grid (K6 without
   conjugation), CS-MINRES, COCG and BiCGStab with the complex Jacobi on
   the complex-symmetric grid; true residuals below 1e-9.
11. preconditioned — (a) BASELINE config #4 on the 100³ Poisson (f32,
   phase 4's rhs, tol 1e-4): ``greedy_color`` must give 2 colors; a 2-color
   ``MaskedGSPrecond`` (sweeps=1) in the padded layout, masks False on the
   halo; one apply launches K1 once and agrees with the same apply through
   the plain K1; ``bicgstab`` with it converges to a true residual below
   1e-3 with K1 launched 1 + 2·its and K2 2·its times; then through
   ``prepare(op, M=...)`` (median of 3 timed solves, not relayed), one
   profiled solve (idle share), and the same solve through the plain
   versions.  CG with multicolor SSOR (ω = 1.5; K1 twice per apply) and
   with ``ChebyshevPrecond.auto`` of degree 4 (K1 four times per apply):
   K1 1 + k·(its + 1), K3 its.  Setup seconds of the coloring, Chebyshev's
   Lanczos and block-Jacobi at 1M rows.  (b) On the 32³ Poisson, ``solve``
   relays ILU(0), block-Jacobi and a flat ``MaskedGSPrecond`` under
   BiCGStab (K1 once, K2 2·its) and IC(0) under MINRES (K1 once, K3
   its + 1) through ``RelayedPrecond``; each converges below 1e-3.  (c)
   ``GaussSeidel`` on the reference's 10×10 golden on the card: 296
   sweeps, residual exactly 0 (the sweep runs on the host by design);
   ``gauss_seidel_redblack`` on a 64×64 grid at eps 1e-8 with the same
   sweep count as its CPU run; ``solve(method="auto")`` on the stacked
   2M×1M ``[A; I]`` routes to LSQR, converges, and agrees to 1e-3 with
   ``lsqr(A, b, damp=1)`` and with scipy's f64 LSQR.
12. layouts — every layout of ``optimize()`` at 1M rows, f32 (c64 in d),
   tol 1e-4, the launch counters reset before each solve, each solve
   converged below a true residual of 1e-3: (a) the 100³ Poisson behind a
   random symmetric permutation → ``Reordered(BSR)`` (RCM, symmetrize and
   BSR-build seconds, block count); ``solve(method="auto")`` → MINRES with
   no hand kernel, x unscrambled within 1e-3 of the unscrambled MINRES's
   and the count within max(3, ⌈its/4⌉) of it; 3 timed ``prepare()``
   solves; the BSR SpMV warm and cold against its bytes bound and
   ``torch.mv`` on the sparse CSR. (b) The Poisson plus 60 symmetric
   long-range couplings → ``HybridDIA`` with a ``FlatViewOperator(PaddedDIA)``
   core: BiCGStab + Jacobi launches K1 1 + 2·its times and K2 never,
   ``auto`` → MINRES K1 its + 2 times; the cost model's scores, the
   sidecar's time and a 2²⁰-element sidecar's rate, the wide torch DIA
   SpMV. (c) A 2²⁰-row [-3, 0, 3] chain and its symmetric twin, scrambled →
   ``Reordered(PaddedDIA)``: MINRES K1 once, K3 its + 1, K4 never;
   BiCGStab + Jacobi K1 1 + 2·its, K2 never; K1 timed. (d) The damped c64
   Poisson, scrambled → ``Reordered(ComplexBSR)``, ``auto`` + Jacobi → COCG.
   (e) The compiled host toolkit: ``greedy_color`` at 1M rows (2 colors,
   the plain version's on 32³), ILU(0)-BiCGStab (K1 once, K2 2·its) and
   IC(0)-MINRES (K1 once, K3 its + 1) at 1M rows with their set-up
   seconds. (f) ``optimize(measure=True)`` on (a)'s scrambling of the 50³
   Poisson (the 1M-row one's two host analyses no longer fit the time
   limit) with the cache in a temporary directory; a second call reads it
   and times nothing. (g)
   Every route off: a uniform random pattern → ELL with a RuntimeWarning.
   Last, the cost model's H100 constants measured in (a)-(c).
13. krylov — the rest of the Krylov family at 1M rows, f32 (c64 in f;
   f64 and c128 in g), tol 1e-4, the launch counters reset before each
   solve and its counts required exactly, each converged below a true
   residual of 1e-3, each timed through one prepared solve (the time
   limit leaves no room for more): (a) phase
   8's convection-diffusion system with Jacobi: GMRES(32) through
   ``solve`` and the ``GMRES`` handle (K1 its + cycles + 1), IDR(4) (K1
   its), CGS (1 + 2·its), TFQMR (3 + 2·its) and the s-step BiCGStab on
   the unpadded DIA (no kernel), GMRES and IDR(4) profiled; (b) phase 4's
   Poisson: single-sync CG (K1 its + 2, K3 never), the s-step CG with the
   Jacobi fold (no kernel), block CG on 8 columns (K1b its + 1) and
   batched BiCGStab + Jacobi on 4 of them (each column its single solve);
   (c) CG with the geometric V-cycle relayed onto the PaddedDIA (K1 once,
   K3 its) and with ``M="amg"`` (RCM, a 1-D hierarchy; the reordered
   Poisson lands on BSR, no kernel), their set-up seconds; (d) FGMRES with
   an inner CG of 8 steps through ``prepare`` (K1 2·its + cycles + 1, K3
   8·its), (e) plain GMRES with that M, printed only; (f) GMRES with the
   complex Jacobi on phase 9's damped c64 Poisson (K5); (g) refinement on
   the f64 Poisson with BiCGStab + Jacobi (K1 and 2·its K2 per inner
   solve) and MINRES (K1, K3 and K4), and on the c128 damped Poisson with
   CS-MINRES (K5, K6) and BiCGStab (K5, K7), each below a true residual of
   1e-11 (1e-10 complex) and equal to ``refine_solve``'s x.  The counts
   within max(3, ⌈its/4⌉) of the JAX package's 1M-row counts (IDR(s)
   excepted: another shadow draw).
14. eigen — the eigensolvers at the widths of the repo's bench
   (``bench.py:860-1000``), each through its public entry point with no
   ``device`` argument, the launch counters reset before each and its K1b
   count required exactly: (a) ``lobpcg`` on the 100³ Poisson's PaddedDIA
   with ``GridMGPrecond`` (k = 4, tol 5e-4): CONVERGED, λ₀ within tol of
   3·(2·sin(π/202))², the worst measured residual within tol, K1b
   its + 1; the unpreconditioned run printed. (b) ``shift_invert_eigs``
   on the 64³ Poisson (σ = 1, max_iter 60, inner_max_iter 600): the four λ
   the analytic ones nearest σ within tol·|λ|, the measured residuals
   within tol, K1b Σ(1 + lockstep iterations) + 1; the idle share of one
   inverted apply. (c) ``rational_filter_eigs`` on the 32³ Poisson (m0 =
   8, 4 nodes, inner_refine 1): the analytic λ, K1b Σ(1 + lockstep
   iterations) + one per subspace iteration. (d) MINRES on a
   ``ShiftedOperator`` (σ = 0.01) of the 1M-row PaddedDIA: its matvec
   bitwise K1 − σ·x, K1 its + 2, true residual below 1e-3. (a) is timed
   once more after its checked run; (b) and (c), minutes long, are timed
   in their checked run, after a warm-up call on a one-step budget.
15. front   — this slice's front ends on the 100³ Poisson (1M rows): (a)
   ``mmwrite`` of the f64 Poisson with symmetric storage (3.97M stored
   entries) into a temporary directory, ``mmread`` back through the
   compiled parser, bitwise the source CSR, both times and the file's
   size; (b) ``info`` through ``main()`` and as ``python -m
   sprsolve_tpu_torch``, the same text, 1000000 × 1000000 and 7 distinct
   diagonals; (c) ``solve`` from the file with phase 4's rhs (``.npy``)
   and no ``--device`` (the card): ``auto`` → MINRES in f64 at tol 1e-8
   (K1 1, K3 and K4 its + 1), BiCGStab + Jacobi (K1 1, K2 2·its), and
   both again with ``--f32`` at tol 1e-4; rc 0, the written x's true
   residual below 1e-6 (1e-3 in f32), exact counts; (d) the damped
   complex-symmetric Poisson in c128 at tol 1e-12: ``auto`` + Jacobi →
   COCG (K5 its + 1), CS-MINRES with 1/|d| (K5 1, K6 its + 1) and
   ``scipy_compat.bicgstab`` on the scipy matrix with the complex Jacobi
   (K5 1, K7 2·its, its read from the solver), true residuals below 1e-9;
   (e) ``scipy_compat`` cg and minres on the f64 Poisson and gmres on the
   f64 convection-diffusion system as scipy matrices at rtol 1e-12, at 50³
   (scipy's own 1M-row solves no longer fit the time limit): info
   0 and x within 1e-6 of scipy.sparse.linalg's own; cg with maxiter 5
   gives info 5, as scipy's does; (f) ``tune_padded_dia`` and
   ``tune_complex_padded_dia`` on the two operators (each candidate's µs
   printed), every dot-kernel output bitwise the same at every candidate
   grid, and a fresh operator takes the cached winner; (g)
   ``timing.spmv_report`` of K1 on the f32 Poisson within 5% of phase 3's
   share, and a trace from ``timing.trace``; (h) K1-K4 on the f64 Poisson
   and K5-K7 on the c128 damped Poisson: warm, cold, plain, bound and
   ``torch.mv`` on the same CSR.
16. dist    — the distributed layer (``sprsolve_tpu_torch.parallel``) at
   full width: (a) phase 4's Jacobi-BiCGStab on ``DistPaddedDIA`` through
   ``distributed_solve`` on one rank under NCCL: converged, true residual
   below 1e-3, the count within max(3, ⌈its/4⌉) of phase 4's, K1 1 + the
   restarts and K2 2·its, all-reduces 2 + 4·its + the restarts, one
   halo call per SpMV, one all-gather; ms per iteration of the solver on
   the rank's part beside phase 4's prepared ms (the group layer's own
   cost) and µs per all-reduce of a CUDA scalar. (b) Two spawned ranks
   under gloo, both on cuda:0, 500,224 rows each: Jacobi-BiCGStab (K1,
   K2), MINRES (K3, K4) and Jacobi-CG (K3) on the f32 Poisson, COCG
   (K5), CS-MINRES with 1/|d| (K5, K6 ``conj_x``) and BiCGStab with the
   complex Jacobi (K5, K7) on phase 9's damped c64 Poisson, each through
   ``distributed_solve`` with every rank's launch counts exact, one halo
   exchange of 2·h entries per SpMV launch, the count within the band of
   phase 4's, 6's or 9's, every rank's x the same bits and the true
   residual below 1e-3; ms per iteration and gloo's µs per all-reduce of
   a CUDA scalar (two ranks share one card: no scaling figure). (c) On
   each rank, K1-K7 on its window (the last rank's with its padded tail)
   against the plain versions with phase 3's tolerances, K2/K3 y bitwise
   K1's and K6/K7 y bitwise K5's, halos zero. (d) Jacobi-BiCGStab on
   ``HaloDIA`` and ``AllGatherELL`` at 32³ (one halo exchange per SpMV,
   or one all-gather), and ``ca_cg`` (s = 4, Jacobi folded) on
   ``MPKDIA`` with one exchange per s-step block. (e) One rank under NCCL
   again, each solve through ``distributed_solve`` at tol 1e-4 beside the
   single-card solve of the same system, whose count it must equal: on
   phase 4's Poisson single-sync CG with Jacobi (K1 its + 2), block CG on
   phase 13's 8 columns (K1b its + 1: ``DistPaddedDIA.matmat``),
   BiCGStab(2) with Jacobi (K1 once, K2 4·cycles), CGS and TFQMR with
   Jacobi (K1 1 + 2·its, 3 + 2·its), FGMRES(32) with an inner CG of 8
   steps on the group (K1 2·its + cycles + 1, K3 8·its), CA-BiCGStab
   (s = 2) on ``MPKDIA`` of depth 4 (torch ops: no kernel; one exchange
   and one all-reduce an s-step block); on phase 9's damped c64 Poisson
   COCG with the complex Jacobi (K5 its + 1). Launch and collective counts
   exact, true residual below 1e-3; ms per iteration of the solver on the
   rank's part (median of 3), one solve under a device-only trace (device
   µs per iteration, idle share), and the part's wall time.
17. dist-eigen — the distributed eigensolvers (``parallel.distributed_*``
   on ``HaloDIA``: torch ops, no kernel launched, checked), the
   collectives of each run exactly ``de_counts`` (one halo exchange per
   block apply; LOBPCG 6 + 9·its all-reduces, a lockstep MINRES 2 + 2 an
   iteration, COCG 3 + 3, a filter pass 5 more). (a)-(c) on one NCCL rank
   at the bench's widths: ``distributed_lobpcg`` on the 100³ Poisson
   (k = 4, tol 5e-4, 80 steps, phase 14 (a)'s X0): λ₀ at least the
   analytic bound, the count within the band of phase 14 (a)'s
   unpreconditioned run, ms per step; ``distributed_shift_invert_eigs``
   on 64³ (phase 14 (b)'s settings): the four λ nearest σ within tol·|λ|,
   the residuals within tol, the lockstep iterations within the band of
   phase 14 (b)'s; ``distributed_rational_filter_eigs``
   on 32³ (m0 = 8): the analytic λ; ms per lockstep iteration beside
   phase 14's; µs per all-reduce of a 12×12 Gram matrix. (d) Two
   gloo ranks on cuda:0: LOBPCG at 32³ run until it converges
   (to tol/5 in at most 400 steps), held CONVERGED with the four smallest
   analytic λ (with multiplicity) within tol·|λ| and the measured
   residuals within tol; shift-invert and the filter (m0 = 12) at 16³:
   every rank's λ, X bits and info the same, λ held as in (a)-(c), each
   rank's collectives exact. (a)-(c)'s rank and (d)'s two are processes
   spawned before phase 12 and run beside phases 12-14 (the parts' times,
   and phases 12-14's, are taken beside each other's work on the same
   card and cores); they are checked after phase 14, whose counts (a)-(c)
   are held to, before phase 15.

The line before the last is a JSON object with one entry per kernel (K1-K7
and K1b, each with its warm ``ms`` and its ``cold_ms``, and the bound's
share of each, ``share`` and ``cold_share``; K1b's launches are
phase 14 (a)'s, the LOBPCG run, with (b)'s and (c)'s printed beside them);
the last line is ``{"ok": true, "device": {...}}``.  Any failure raises, and
the script exits non-zero.  It imports no JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

import sprsolve_tpu_torch as spt
from sprsolve_tpu_torch import native
from sprsolve_tpu_torch.api import _auto_method
from sprsolve_tpu_torch.multigrid import FlatViewOperator
from sprsolve_tpu_torch.ops import _cuda_build, fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.ops.reordered import Reordered
from sprsolve_tpu_torch.ops.spmv import spmv_dia
from sprsolve_tpu_torch.sparse.containers import COO, CSR, DIA
from sprsolve_tpu_torch.utils import problems, tuning

topt = importlib.import_module("sprsolve_tpu_torch.ops.optimize")

SEED = 0
GRID = 100          # the 100³ Poisson: 1,000,000 rows, 6,940,000 nnz
KERNELS = {   # name → (source, the TPU kernel it replaces)
    "dia_spmv": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:131"),
    "dia_spmm": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:131"),
    "dia_wdot": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:159"),
    "dia_dot": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:140"),
    "orth_norm": ("sprsolve_tpu_torch/csrc/fused.cu", "sprsolve_tpu/ops/pallas_fused.py:37"),
    "dia_complex_spmv": ("sprsolve_tpu_torch/csrc/dia_complex.cu",
                         "sprsolve_tpu/ops/pallas_spmv.py:244"),
    "dia_complex_dot": ("sprsolve_tpu_torch/csrc/dia_complex.cu",
                        "sprsolve_tpu/ops/pallas_spmv.py:262"),
    "dia_complex_wdot": ("sprsolve_tpu_torch/csrc/dia_complex.cu",
                         "sprsolve_tpu/ops/pallas_spmv.py:343"),
}
# the least time of a call: bytes over the HBM rate, operations over the peak
# rate of their type (NVIDIA H100 SXM data sheet, 700 W; vector units)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# tolerances of kernel against plain version, by vector dtype:
#  y:        rtol of the row's |A|·|x| — the kernel fuses each multiply-add
#            into an FMA, the plain version may not;
#  partials: rtol of Σ|w·y| — the block tree sums in another order than
#            torch.sum;
#  K4's v₊:  Y_RTOL of |a| + |β||v_old| + |α||v| per entry — the kernel
#            fuses the two multiply-subtracts, the plain version does not.
Y_RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def median_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed ``reps`` times (CUDA events), the median over ``inner``. The
    replay has no host work, so this is the kernels' own time, on inputs
    warm in L2 where they fit."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def orth_norm_bytes(a, h: int) -> int:
    """Bytes K4 moves on padded vectors like ``a`` with halo ``h``: the body
    rows of a, v_old and v read once, all of v₊ (halos too) written once."""
    return (3 * (a.numel() - 2 * h) + a.numel()) * a.element_size()


def cold_device_ms(call, operands, reps: int = 5) -> float:
    """Device time of one call on inputs cold in L2: ``device_ms``'s graph
    replay, rotating through at least 4 copies of ``operands`` whose total
    exceeds twice the card's L2, so that no call finds its inputs left
    there by the call before."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    n = max(4, -(-2 * l2 // nbytes(*operands)))
    copies = [tuple(t.clone() for t in operands) for _ in range(n)]

    def one_pass():
        for c in copies:
            call(*c)

    return device_ms(one_pass, reps=reps, inner=2) / n


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``libcuda``'s graph API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_nodes(fn) -> list:
    """``[(name, nan)]`` of the nodes of one call of ``fn`` captured in a
    CUDA graph, read through ``libcuda``'s graph API: a kernel node by its
    function's name, any other node by its ``CUgraphNodeType`` number."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(err, what):
        if err:
            raise RuntimeError(f"{what} returned CUresult {err}")

    # the warm-up runs on the capture stream, so that per-stream state (the
    # dot kernels' scratch) exists before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:   # CU_GRAPH_NODE_TYPE_KERNEL
            out.append((f"node type {kind.value}", float("nan")))
            continue
        kp = _KernelNodeParams()
        ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(kp)),
           "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if kp.func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(kp.func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kp.kern)),
               "cuKernelGetName")
        out.append((name.value.decode(), float("nan")))
    return out


def kernel_events(fn) -> list:
    """``[(name, µs)]`` of the device events (kernels, copies, memsets) of
    one call of ``fn`` under torch.profiler, after a warm-up call. A trace
    can come back with no device event at all (seen once in ~20 profiled
    calls on the card, and eight times in a row once, on K6 after the
    cuSPARSE yardsticks had run): it is taken again up to eight times, and
    then the call is counted from its CUDA graph instead (:func:`graph_nodes`,
    no times), which the log line says."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return events
    events = graph_nodes(fn)
    log("profiler", note="eight empty traces; the call counted from its CUDA graph",
        nodes=";".join(n for n, _ in events))
    return events


def bound_ms(moved: int, flops: float, rdt) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes moved over
    the HBM rate and the operations over the peak rate of ``rdt``."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rdt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(what, csr, x, y_kernel):
    """``torch.mv`` of a ``torch.sparse_csr_tensor`` (int32 indices) of the
    same matrix on the unpadded x: timed as the yardstick of a kernel, never
    called by the port. Returns its graph-replayed ms, or None (printed)
    when torch cannot run that call on the card."""
    try:
        S = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr.numpy().astype(np.int32), device=x.device),
            torch.as_tensor(csr.indices.numpy().astype(np.int32), device=x.device),
            torch.as_tensor(csr.data.numpy(), device=x.device), size=csr.shape)
        y = torch.mv(S, x)
        err = float((y - y_kernel).abs().max())
        t = device_ms(lambda: torch.mv(S, x))
    except Exception as e:   # the yardstick only: report, and time nothing
        log("library", kernel=what, call="torch.mv(sparse_csr)", unavailable=repr(e)[:200])
        return None
    log("library", kernel=what, call="torch.mv(sparse_csr)", dtype=str(x.dtype),
        ms=f"{t:.5f}", max_abs_diff_vs_kernel=f"{err:.3e}")
    return t


def band_sets(dev):
    """(name, PaddedDIA, nnz) for the four band sets of phase 3."""
    rng = np.random.default_rng(SEED)
    A = problems.poisson3d(GRID, GRID, GRID)
    dia = DIA.from_csr(A, device="cpu")
    sets = [("poisson100_int8", spt.PaddedDIA.from_dia(dia, device=dev), A.nnz)]
    mask = (dia.bands != 0).numpy()
    rand = np.where(mask, rng.uniform(0.5, 1.5, dia.bands.shape), 0.0)
    for name, vals, dtype in (
        ("random_f32", rand, np.float32),
        ("bf16exact_f32", dia.bands.numpy() * 2.5, np.float32),
        ("random_f64", rand, np.float64),
    ):
        d = DIA(bands=torch.as_tensor(vals.astype(dtype)), offsets=dia.offsets,
                shape=dia.shape)
        sets.append((name, spt.PaddedDIA.from_dia(d, device=dev), A.nnz))
    expect = {"poisson100_int8": torch.int8, "random_f32": torch.float32,
              "bf16exact_f32": torch.bfloat16, "random_f64": torch.float64}
    for name, op, _ in sets:
        assert op.bands.dtype == expect[name], (name, op.bands.dtype)
    return sets


def launch_counts() -> dict:
    return {"dia_spmv": pd.dia_spmv.launches, "dia_spmm": pd.dia_spmm.launches,
            "dia_wdot": pd.dia_wdot.launches,
            "dia_dot": pd.dia_dot.launches, "orth_norm": fused.orth_norm.launches,
            "dia_complex_spmv": pd.dia_complex_spmv.launches,
            "dia_complex_dot": pd.dia_complex_dot.launches,
            "dia_complex_wdot": pd.dia_complex_wdot.launches}


def check_halo(name, op, v):
    """The halo and the tail of a padded output must be exactly zero."""
    if bool(v[: op.h].any()) or bool(v[op.h + op.n:].any()):
        raise AssertionError(f"{name}: nonzero halo or tail")


def dirty(like):
    """Free a NaN-filled block of ``like``'s size, so that the next
    ``torch.empty_like`` (a kernel's output) likely reuses it: a halo the
    kernel forgot to clear then shows."""
    junk = torch.full_like(like, float("nan"))
    del junk


def check_close(name, got, want, scale, rtol):
    err = float((got - want).abs().max())
    bound = rtol * float(scale)
    if not err <= bound:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} > {bound:.3e}")
    return err


def phase_kernels(dev):
    """Phase 3: every kernel and variant against its plain version."""
    rng = np.random.default_rng(SEED + 1)
    errs = dict.fromkeys(KERNELS, 0.0)
    times, stats = {}, {}
    check_k1_edges(dev, errs)
    check_k4_edges(dev, errs)
    for name, op, nnz in band_sets(dev):
        dt = op.vdtype
        mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=dt,
                                                device=dev))
        x, w = mk(), mk()
        dinv = op.jacobi_precond().diag_inv
        absb = op.bands.to(dt).abs()
        # K1
        y = pd.dia_spmv(op.bands, x, op.offsets, op.h)
        y_ref = pd.dia_spmv_plain(op.bands, x, op.offsets, op.h)
        scale = pd.dia_spmv_plain(absb, x.abs(), op.offsets, op.h).max()
        e = check_close(f"{name} K1 y", y, y_ref, scale, Y_RTOL[dt])
        errs["dia_spmv"] = max(errs["dia_spmv"], e)
        if op.bands.dtype in (torch.int8, torch.bfloat16):
            wide = op.bands.to(torch.float32)
            y_wide = pd.dia_spmv(wide, x, op.offsets, op.h)
            if not torch.equal(y, y_wide):
                raise AssertionError(f"{name}: narrow and f32 bands differ (K1)")
        check_k1_grids(name, op, x, y)
        # K2, four variants
        for wv in (w, None):
            for dv in (None, dinv):
                tag = f"{name} K2 w_is_x={wv is None} has_dinv={dv is not None}"
                dirty(x)
                y, wd, yd = pd.dia_wdot(op.bands, x, wv, dv, op.offsets, op.h)
                check_halo(tag + " y", op, y)
                y_r, wd_r, yd_r = pd.dia_wdot_plain(op.bands, x, wv, dv, op.offsets, op.h)
                u = x if dv is None else x * dv
                scale = pd.dia_spmv_plain(absb, u.abs(), op.offsets, op.h).max()
                e = check_close(tag + " y", y, y_r, scale, Y_RTOL[dt])
                errs["dia_wdot"] = max(errs["dia_wdot"], e)
                wsrc = x if wv is None else wv
                check_close(tag + " wy", wd, wd_r, (wsrc * y_r).abs().sum(), DOT_RTOL[dt])
                check_close(tag + " yy", yd, yd_r, yd_r, DOT_RTOL[dt])
                if op.bands.dtype in (torch.int8, torch.bfloat16):
                    yw, wdw, ydw = pd.dia_wdot(op.bands.to(torch.float32), x, wv, dv,
                                               op.offsets, op.h)
                    if not (torch.equal(y, yw) and torch.equal(wd, wdw)
                            and torch.equal(yd, ydw)):
                        raise AssertionError(f"{tag}: narrow and f32 bands differ")
        # K3
        dirty(x)
        y, d = pd.dia_dot(op.bands, x, op.offsets, op.h)
        y_r, d_r = pd.dia_dot_plain(op.bands, x, op.offsets, op.h)
        scale = pd.dia_spmv_plain(absb, x.abs(), op.offsets, op.h).max()
        e = check_close(f"{name} K3 y", y, y_r, scale, Y_RTOL[dt])
        errs["dia_dot"] = max(errs["dia_dot"], e)
        check_close(f"{name} K3 xy", d, d_r, (x * y_r).abs().sum(), DOT_RTOL[dt])
        check_halo(f"{name} K3 y", op, y)
        if op.bands.dtype in (torch.int8, torch.bfloat16):
            yw, dw = pd.dia_dot(op.bands.to(torch.float32), x, op.offsets, op.h)
            if not (torch.equal(y, yw) and torch.equal(d, dw)):
                raise AssertionError(f"{name}: narrow and f32 bands differ (K3)")
        check_dot_kernels(name, op, x, w, dinv, profile=name == "poisson100_int8")
        torch.cuda.synchronize()
        # timings at the main path's shapes: K2 as BiCGStab's second SpMV
        # (Jacobi fold, w = x)
        t = {
            "dia_spmv": median_ms(lambda: pd.dia_spmv(op.bands, x, op.offsets, op.h)),
            "dia_spmv_plain": median_ms(
                lambda: pd.dia_spmv_plain(op.bands, x, op.offsets, op.h)),
            "dia_wdot": median_ms(
                lambda: pd.dia_wdot(op.bands, x, None, dinv, op.offsets, op.h)),
            "dia_wdot_plain": median_ms(
                lambda: pd.dia_wdot_plain(op.bands, x, None, dinv, op.offsets, op.h)),
            "dia_dot": median_ms(lambda: pd.dia_dot(op.bands, x, op.offsets, op.h)),
            "dia_dot_plain": median_ms(
                lambda: pd.dia_dot_plain(op.bands, x, op.offsets, op.h)),
        }
        if name in ("poisson100_int8", "random_f64"):
            t.update(phase_orth_norm(name, op, mk, errs))
        times[name] = t
        log("kernels", set=name, bands=str(op.bands.dtype).replace("torch.", ""),
            **{f"{k}_ms": f"{v:.4f}" for k, v in t.items()},
            K1_Gnnz_s=f"{nnz / t['dia_spmv'] / 1e6:.1f}",
            K2_Gnnz_s=f"{nnz / t['dia_wdot'] / 1e6:.1f}",
            K3_Gnnz_s=f"{nnz / t['dia_dot'] / 1e6:.1f}")
        if name == "poisson100_int8":
            stats = real_kernel_stats(op, x, dinv, mk)
    return errs, times, stats


# --- phase 3, K1 at the edges of its tile ------------------------------------
# name → (offsets, n, vector dtype, band values): K1 walks tiles of DOT_TILE
# rows with DOT_HALO = 128 staged rows on each side, so these reach a last
# tile of 256·odd rows, halos wider than a tile, odd offsets beyond the
# staged window (read through L2, unaligned) and every band storage
K1_EDGES = {
    "k1_odd_tiles": ((-1, 0, 1), 256 * 3, np.float32, "random"),
    "k1_odd_tiles_int8": ((-3, -1, 0, 1, 3), 256 * 9, np.float32, "int8"),
    "k1_halo_beyond_tile": ((-1500, -3, 0, 2, 1500), 256 * 9, np.float32, "int8"),
    "k1_far_odd_offsets": ((-4097, -301, -1, 0, 1, 299, 4095), 256 * 63, np.float32,
                           "random"),
    "k1_bf16": ((-301, -1, 0, 1, 301), 256 * 63, np.float32, "bf16"),
    "k1_f64": ((-2001, -129, -1, 0, 1, 131, 2001), 256 * 11, np.float64, "random"),
    "k1_f64_wide": ((-32769, -257, -1, 0, 1, 257, 32769), 256 * 255, np.float64, "random"),
}


def k1_edge_operator(name, dev):
    offsets, n, dt, kind = K1_EDGES[name]
    rng = np.random.default_rng(SEED + 12)
    if kind == "int8":
        vals = rng.integers(-3, 4, (len(offsets), n))
    elif kind == "bf16":   # quarters plus an eighth: bf16, not int8
        vals = rng.integers(-20, 21, (len(offsets), n)) * 0.25 + 0.125
    else:
        vals = rng.uniform(0.5, 1.5, (len(offsets), n))
    op = spt.PaddedDIA.from_dia(DIA(bands=torch.as_tensor(vals.astype(dt)), offsets=offsets,
                                    shape=(n, n)), device=dev)
    want = {"int8": torch.int8, "bf16": torch.bfloat16}.get(kind, op.vdtype)
    assert op.bands.dtype == want, (name, op.bands.dtype)
    return op


def check_k1_grids(name, op, x, y) -> None:
    """K1's y on ``x`` bitwise ``y``: walking its 4-row tiles with the card
    said to have SPMM_SMS SMs (one wave of a few blocks, each walking
    several tiles), and with each of its bodies forced: one thread per row,
    and the 4-row tiles with plain or streamed band loads."""
    saved = pd._sm_count, pd.k1_by_quads, pd.stream_bands
    try:
        pd.k1_by_quads = lambda *_: True
        for sms in SPMM_SMS:
            pd._sm_count = lambda index, sms=sms: sms
            if not torch.equal(pd.dia_spmv(op.bands, x, op.offsets, op.h), y):
                raise AssertionError(f"{name} K1: the grid of {sms} SMs differs")
        pd._sm_count = saved[0]
        for quads, streamed in ((False, False), (True, False), (True, True)):
            pd.k1_by_quads = lambda *_, q=quads: q
            pd.stream_bands = lambda *_, s=streamed: s
            if not torch.equal(pd.dia_spmv(op.bands, x, op.offsets, op.h), y):
                raise AssertionError(f"{name} K1: quads={quads}, streamed={streamed} differs")
    finally:
        pd._sm_count, pd.k1_by_quads, pd.stream_bands = saved


def check_k1_edges(dev, errs) -> None:
    """Phase 3, K1 at K1_EDGES: within Y_RTOL of the plain version, halos
    exactly zero after a NaN block was freed, one kernel per call under
    torch.profiler (and one count), a CUDA-graph replay bitwise eager, the
    same bits on one-wave grids of SPMM_SMS SMs and with each of its
    bodies (:func:`check_k1_grids`), narrow bands bitwise the
    same values stored wide, and K3's y, K2's y (unfolded, and folded
    against K1 on x ⊙ dinv) and every column of a 3-column K1b block
    bitwise K1's."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    for name in K1_EDGES:
        op = k1_edge_operator(name, dev)
        dt, b, o, h = op.vdtype, op.bands, op.offsets, op.h
        X2 = op.pad_block(torch.as_tensor(rng.standard_normal((op.n, 3)), dtype=dt, device=dev))
        x = X2[:, 0].contiguous()
        dirty(x)
        before = pd.dia_spmv.launches
        y = pd.dia_spmv(b, x, o, h)
        if pd.dia_spmv.launches != before + 1:
            raise AssertionError(f"{name} K1: {pd.dia_spmv.launches - before} counts a call")
        check_halo(f"{name} K1 y", op, y)
        scale = pd.dia_spmv_plain(b.to(dt).abs(), x.abs(), o, h).max()
        e = check_close(f"{name} K1 y", y, pd.dia_spmv_plain(b, x, o, h), scale, Y_RTOL[dt])
        errs["dia_spmv"] = max(errs["dia_spmv"], e)
        if b.dtype != dt and not torch.equal(pd.dia_spmv(b.to(dt), x, o, h), y):
            raise AssertionError(f"{name}: narrow and wide bands differ (K1)")
        check_k1_grids(name, op, x, y)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pd.dia_spmv(b, x, o, h)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y_graph = pd.dia_spmv(b, x, o, h)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(y_graph, y):
                raise AssertionError(f"{name} K1: a graph replay differs from eager")
        ev = kernel_events(lambda: pd.dia_spmv(b, x, o, h))
        if len(ev) != 1 or "dia_spmv_kernel" not in ev[0][0]:
            raise AssertionError(f"{name} K1: one call ran {ev}, not one kernel")
        dinv = op.pad_vec(torch.as_tensor(rng.uniform(0.5, 2.0, op.n), dtype=dt, device=dev))
        Y = pd.dia_spmm(b, X2, o, h)
        for j in range(3):
            xj = X2[:, j].contiguous()
            yj = pd.dia_spmv(b, xj, o, h)
            if not (torch.equal(Y[:, j], yj) and torch.equal(pd.dia_dot(b, xj, o, h)[0], yj)
                    and torch.equal(pd.dia_wdot(b, xj, None, None, o, h)[0], yj)
                    and torch.equal(pd.dia_wdot(b, xj, None, dinv, o, h)[0],
                                    pd.dia_spmv(b, xj * dinv, o, h))):
                raise AssertionError(f"{name}: K1b column {j}, K3's or K2's y is not K1's")
        log("kernels", set=name, kernel="K1", bands=str(b.dtype).replace("torch.", ""),
            n_pad=op.n_pad, h=h, max_abs_err=f"{e:.3e}",
            result="within Y_RTOL of plain; halos zero; one kernel a call; graph replay, "
            "grids of " + " and ".join(map(str, SPMM_SMS)) + " SMs, each body, narrow bands, "
            "K3/K2 y and K1b columns bitwise K1's")
    log("kernels", kernel="K1 edges", seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 3, K4 at the edges of its tile ------------------------------------
# name → (n_pad, h, vector dtype): K4 walks tiles of DOT_TILE rows, so these
# reach one ragged tile, a halo as wide as the body, halos wider than a tile,
# no halo, and the 100³ layout's 977 tiles (the last of 768 rows)
K4_EDGES = {
    "k4_one_ragged_tile": (256 * 3, 4, torch.float32),
    "k4_halo_is_n_pad": (256, 256, torch.float32),
    "k4_halo_beyond_tile": (256 * 9, 2000, torch.float32),
    "k4_no_halo_f64": (256 * 5, 0, torch.float64),
    "k4_halo_beyond_tile_f64": (256 * 11, 1500, torch.float64),
    "k4_poisson100": (256 * 3907, 10000, torch.float32),
    "k4_poisson100_f64": (256 * 3907, 10000, torch.float64),
}


def check_k4_edges(dev, errs) -> None:
    """Phase 3, K4 at K4_EDGES: v₊ within Y_RTOL of the plain version and
    Σv₊² within DOT_RTOL, halos exactly zero after a NaN block was freed,
    one count a call, and v₊ and the sum bitwise the same on one-wave grids
    of SPMM_SMS SMs (at the 1M-row layouts each block of the 1-SM grid
    walks at least 72 tiles)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    for name, (n_pad, h, dt) in K4_EDGES.items():
        vecs = []
        for _ in range(3):
            t = torch.zeros(n_pad + 2 * h, dtype=dt)
            t[h: h + n_pad] = torch.as_tensor(rng.standard_normal(n_pad), dtype=dt)
            vecs.append(t.to(dev))
        a, vold, v = vecs
        beta = torch.tensor(0.7, dtype=dt, device=dev)
        alpha = torch.tensor(-1.3, dtype=dt, device=dev)
        dirty(a)
        before = fused.orth_norm.launches
        vn, ss = fused.orth_norm(a, vold, v, beta, alpha, h)
        if fused.orth_norm.launches != before + 1:
            raise AssertionError(f"{name}: {fused.orth_norm.launches - before} counts a call")
        if bool(vn[:h].any()) or bool(vn[h + n_pad:].any()):
            raise AssertionError(f"{name} K4: nonzero halo")
        vn_r, ss_r = fused.orth_norm_plain(a, vold, v, beta, alpha, h)
        scale = (a.abs() + 0.7 * vold.abs() + 1.3 * v.abs()).max()
        e = check_close(f"{name} K4 v+", vn, vn_r, scale, Y_RTOL[dt])
        errs["orth_norm"] = max(errs["orth_norm"], e)
        check_close(f"{name} K4 sumsq", ss, ss_r, ss_r, DOT_RTOL[dt])
        tiles = -(-n_pad // pd.DOT_TILE)
        saved = pd._sm_count
        try:
            for sms in SPMM_SMS:
                pd._sm_count = lambda index, sms=sms: sms
                vg, sg = fused.orth_norm(a, vold, v, beta, alpha, h)
                if not (torch.equal(vg, vn) and torch.equal(sg, ss)):
                    raise AssertionError(f"{name} K4: the grid of {sms} SMs differs")
        finally:
            pd._sm_count = saved
        log("kernels", set=name, kernel="K4", dtype=str(dt).replace("torch.", ""),
            n_pad=n_pad, h=h, tiles=tiles,
            tiles_a_block_on_1_sm=tiles // pd.persistent_grid(n_pad, dt, 1),
            max_abs_err=f"{e:.3e}",
            result="within Y_RTOL/DOT_RTOL of plain; halos zero; one count a call; grids "
            "of " + " and ".join(map(str, SPMM_SMS)) + " SMs bitwise")
    log("kernels", kernel="K4 edges", seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 3b, CG's fused updates U and P ----------------------------------
def cg_update_bytes(n: int, itemsize: int, has_d: bool = True) -> int:
    """Bytes U moves on n rows: x, p, r, q (and d⁻¹) read once, x' and r'
    written once (28 a row in f32 with d⁻¹)."""
    return (6 + has_d) * n * itemsize


def cg_direction_bytes(n: int, itemsize: int, has_d: bool = True) -> int:
    """Bytes P moves on n rows: r, p (and d⁻¹) read once, p' written once
    (16 a row in f32 with d⁻¹)."""
    return (3 + has_d) * n * itemsize


def phase_cg_fused(dev) -> dict:
    """Phase 3b: U (``fused.cg_update``) and P (``fused.cg_direction``) on
    flat vectors of the 100³ and the 256³ Poisson's padded length, f32 and
    f64, with d⁻¹ (Jacobi) and without: x', r', p' within Y_RTOL of their
    plain versions on the card and rz', rr', ‖r'‖ within DOT_RTOL, the
    predicates equal, one count a call; then, with d⁻¹, graph-replayed warm
    (``ms``) and cold (``cold_ms``) times beside their bound (bytes over
    3.35 TB/s) and the plain versions' time. Returns the times by
    (kernel, grid, dtype)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    out = {}
    for grid in (GRID, 256):
        offsets = (-grid * grid, -grid, -1, 0, 1, grid, grid * grid)
        for dt in (torch.float32, torch.float64):
            isz = torch.empty((), dtype=dt).element_size()
            h, n_pad = pd.layout(grid ** 3, offsets, isz)
            n = n_pad + 2 * h
            vec = lambda: torch.as_tensor(rng.standard_normal(n), dtype=dt).to(dev)
            x, p, r, q = vec(), vec(), vec(), vec()
            d = torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=dt).to(dev)
            rz = torch.tensor(0.75, dtype=dt, device=dev)
            pq = torch.tensor(2.5, dtype=dt, device=dev)
            xo, ro, po = torch.empty_like(x), torch.empty_like(r), torch.empty_like(p)
            for dinv in (d, None):
                _, _, st_r = fused.cg_update_plain(x, p, r, q, dinv, rz, pq, rz, xo, ro)
                tol = 0.5 * st_r[2]
                x_r, r_r, st_r = (t.clone() for t in fused.cg_update_plain(
                    x, p, r, q, dinv, rz, pq, tol, xo, ro))
                counts = fused.cg_update.launches, fused.cg_direction.launches
                xn, rn, st = fused.cg_update(x, p, r, q, dinv, rz, pq, tol, xo, ro)
                pn = fused.cg_direction(p, rn, dinv, st[0], rz, po)
                if (fused.cg_update.launches, fused.cg_direction.launches) != (
                        counts[0] + 1, counts[1] + 1):
                    raise AssertionError(f"U/P at {grid}³: not one count a call")
                tag = f"poisson{grid} {str(dt).replace('torch.', '')} " + (
                    "d" if dinv is not None else "no d")
                check_close(f"{tag} U x'", xn, x_r, (x.abs() + 0.3 * p.abs()).max(), Y_RTOL[dt])
                check_close(f"{tag} U r'", rn, r_r, (r.abs() + 0.3 * q.abs()).max(), Y_RTOL[dt])
                for k, what in enumerate(("rz'", "rr'", "|r'|")):
                    check_close(f"{tag} U {what}", st[k], st_r[k], st_r[k].abs(), DOT_RTOL[dt])
                if st[3:].tolist() != [1.0, 1.0, 0.0]:
                    raise AssertionError(f"{tag} U: predicates {st[3:].tolist()}")
                z = rn if dinv is None else rn * dinv
                beta = st[0] / rz
                pn_r = fused.cg_direction_plain(p, rn, dinv, st[0], rz, torch.empty_like(p))
                check_close(f"{tag} P p'", pn, pn_r, (z.abs() + beta.abs() * p.abs()).max(),
                            Y_RTOL[dt])
                log("kernels", set=tag, kernels="U/P", n=n,
                    result="within Y_RTOL/DOT_RTOL of plain; predicates equal; one count a "
                    "call")
                if dinv is None:
                    continue
                u = lambda x, p, r, q, d, xo, ro: fused.cg_update(x, p, r, q, d, rz, pq, tol,
                                                                 xo, ro)
                pp = lambda p, r, d, po: fused.cg_direction(p, r, d, st[0], rz, po)
                calls = {   # name → (kernel, plain version, operands, bytes moved)
                    "cg_update": (u, lambda *t: fused.cg_update_plain(*t[:5], rz, pq, tol,
                                                                      *t[5:]),
                                  (x, p, r, q, d, xo, ro), cg_update_bytes(n, isz)),
                    "cg_direction": (pp, lambda p, r, d, po: fused.cg_direction_plain(
                        p, r, d, st[0], rz, po), (p, rn, d, po), cg_direction_bytes(n, isz)),
                }
                for name, (kern, plain, ops, moved) in calls.items():
                    bms = moved / HBM_BYTES_PER_S * 1e3
                    st_k = {"ms": device_ms(lambda: kern(*ops)),
                            "cold_ms": cold_device_ms(kern, ops),
                            "plain_ms": device_ms(lambda: plain(*ops)),
                            "wrapper_ms": median_ms(lambda: kern(*ops)), "bound_ms": bms}
                    out[(name, grid, dt)] = st_k
                    log("kernels", set=tag, kernel=name, timing="graph-replayed", n=n,
                        **{k: f"{v:.5f}" for k, v in st_k.items()},
                        share_of_bound=f"{bms / st_k['ms']:.3f}",
                        cold_share_of_bound=f"{bms / st_k['cold_ms']:.3f}")
            del x, p, r, q, d, xo, ro, po, xn, rn, pn, x_r, r_r, pn_r, z
            torch.cuda.empty_cache()
    log("kernels", kernel="U/P", seconds=f"{time.perf_counter() - t0:.2f}")
    return out


# --- phase 3d, CS-MINRES's fused updates A and B ----------------------------
def csm_lanczos_bytes(n: int, itemsize: int, has_d: bool = True) -> int:
    """Bytes A moves on n complex rows of real ``itemsize``: y, v_old, v (and
    d⁻¹) read once, v' (and w') written once ((5·8 + 4)·n in c64 with d⁻¹)."""
    return (8 + 3 * has_d) * n * itemsize


def csm_update_bytes(n: int, itemsize: int, has_d: bool = True) -> int:
    """Bytes B moves on n complex rows: w, p, p_old, x, v' (and w') read
    once, p', x, v' (and w') written once (10·8·n in c64 with d⁻¹)."""
    return (16 + 4 * has_d) * n * itemsize


def csm_start_state(dt, dev):
    """A state of generic scalars for A (β, c_old, c, s_old, s, η, the
    residual, β₁) whose repeated application stays bounded on vectors of
    norm 0.1, and B's coefficients with ts = 1 (v' and w' unchanged)."""
    st = fused.csm_state(*(torch.tensor(v, dtype=dt.to_real(), device=dev)
                           for v in (0.05, 1.0, 0.5, 1.0)))
    for k, v in ((fused.CSM_C_OLD, (0.8, -0.1)), (fused.CSM_C, (0.6, 0.2)),
                 (fused.CSM_S_OLD, (0.5,)), (fused.CSM_S, (0.3,)), (fused.CSM_ETA, (0.7, 0.3)),
                 (fused.CSM_R2, (0.3, 0.1)), (fused.CSM_R3, (0.5,)), (fused.CSM_R1_INV, (0.5,)),
                 (fused.CSM_TS, (1.0,)), (fused.CSM_XC, (0.01, 0.02))):
        st[k:k + len(v)] = torch.tensor(v, dtype=st.dtype)
    return st


def check_csm_state(tag, got, want, rtol) -> None:
    """A's scalars within 10·rtol of the plain version's, each relative to
    its own size (β_next, r1_inv and the rest come from the sums, whose
    rtol is DOT_RTOL); the predicates equal."""
    for k in range(fused.CSM_FLAGS):
        g, w = float(got[k]), float(want[k])
        if not abs(g - w) <= 10 * rtol * max(abs(w), 1e-30):
            raise AssertionError(f"{tag}: state slot {k} {g!r} against {w!r}")
    if got[fused.CSM_FLAGS:].tolist() != want[fused.CSM_FLAGS:].tolist():
        raise AssertionError(f"{tag}: predicates {got[fused.CSM_FLAGS:].tolist()} against "
                             f"{want[fused.CSM_FLAGS:].tolist()}")


def phase_csm_fused(dev) -> dict:
    """Phase 3d: A (``fused.csm_lanczos``) and B (``fused.csm_update``) on
    flat complex vectors of the 100³ (c64, c128) and the 256³ (c64) damped
    Poisson's padded length, with d⁻¹ and without: v', w', p', x within
    Y_RTOL of their plain versions on the card, A's scalars within
    10·DOT_RTOL, the predicates equal, one count a call; then at 256³ c64
    with d⁻¹ their graph-replayed warm and cold times beside their bound
    and the plain versions' time; and one prepared CS-MINRES solve with
    1/|d| on the damped 100³ Poisson: K5 once, K6, A and B its + 1 times
    each, nothing else, beside the same solve on the unfused loop. Returns
    the times by (kernel, grid, dtype)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    out = {}
    for grid, dt in ((GRID, torch.complex64), (GRID, torch.complex128),
                     (256, torch.complex64)):
        rdt, isz = dt.to_real(), torch.empty((), dtype=dt.to_real()).element_size()
        offsets = (-grid * grid, -grid, -1, 0, 1, grid, grid * grid)
        h, n_pad = pd.layout(grid ** 3, offsets, 2 * isz)
        n = n_pad + 2 * h
        scale = 0.1 / n ** 0.5   # vectors of norm 0.1: repeated calls stay bounded
        vec = lambda: torch.randn(n, generator=gen, device=dev, dtype=dt) * scale
        y, vold, v, w, p, pold, x = (vec() for _ in range(7))
        d = torch.rand(n, generator=gen, device=dev, dtype=rdt) * 0.9 + 0.1
        alpha = torch.tensor(0.3 + 0.15j, dtype=dt, device=dev)
        eps = float(torch.finfo(rdt).eps)
        tag0 = f"damped{grid} {str(dt).replace('torch.', '')}"
        for dinv in (d, None):
            tag = tag0 + (" d" if dinv is not None else " no d")
            st0 = csm_start_state(dt, dev)
            st_r, st_k = st0.clone(), st0.clone()
            vn_r, wn_r = fused.csm_lanczos_plain(y, vold.clone(), v, dinv, alpha, st_r,
                                                 torch.empty_like(y),
                                                 torch.finfo(rdt).eps)
            counts = fused.csm_lanczos.launches, fused.csm_update.launches
            vn, wn = fused.csm_lanczos(y, vold.clone(), v, dinv, alpha, st_k,
                                       torch.empty_like(y))
            vscale = (y.abs() + 0.05 * vold.abs() + alpha.abs() * v.abs()).max()
            check_close(f"{tag} A v'", vn, vn_r, vscale, Y_RTOL[rdt])
            if dinv is not None:
                check_close(f"{tag} A w'", wn, wn_r, vscale, Y_RTOL[rdt])
            check_csm_state(f"{tag} A", st_k, st_r, DOT_RTOL[rdt])
            # B from the plain A's state and vectors, on both sides
            ins = (w if dinv is not None else v, p, pold, x, vn_r,
                   wn_r if dinv is not None else None)
            got = [None if t is None else t.clone() for t in ins]
            want = [None if t is None else t.clone() for t in ins]
            fused.csm_update_plain(*want, st_r)
            fused.csm_update(*got, st_r)
            if (fused.csm_lanczos.launches, fused.csm_update.launches) != (
                    counts[0] + 1, counts[1] + 1):
                raise AssertionError(f"{tag}: A/B not one count a call")
            pscale = (ins[0].abs() + ins[1].abs() + ins[2].abs()).max()
            for k, what in ((2, "p'"), (3, "x"), (4, "v'"), (5, "w'")):
                if got[k] is not None:
                    check_close(f"{tag} B {what}", got[k], want[k],
                                pscale + ins[k].abs().max(), 4 * Y_RTOL[rdt])
            log("kernels", set=tag, kernels="A/B", n=n, result="within Y_RTOL/DOT_RTOL of "
                "plain; predicates equal; one count a call")
            if dinv is None or grid != 256:
                continue
            sa, sb = csm_start_state(dt, dev), csm_start_state(dt, dev)
            wa, wb = torch.empty_like(y), wn_r.clone()
            a_call = lambda y, vold, v, d, wo: fused.csm_lanczos(y, vold, v, d, alpha, sa, wo)
            eps_t = torch.tensor(eps, dtype=rdt, device=dev)
            a_plain = lambda y, vold, v, d, wo: fused.csm_lanczos_plain(y, vold, v, d, alpha,
                                                                        sa, wo, eps_t)
            b_call = lambda *t: fused.csm_update(*t, sb)
            b_plain = lambda *t: fused.csm_update_plain(*t, sb)
            calls = {   # name → (kernel, plain version, operands, bytes moved)
                "csm_lanczos": (a_call, a_plain, (y, vold.clone(), v, d, wa),
                                csm_lanczos_bytes(n, isz)),
                "csm_update": (b_call, b_plain, (w, p, pold.clone(), x.clone(), vn_r.clone(),
                                                 wb), csm_update_bytes(n, isz)),
            }
            for name, (kern, plain, ops, moved) in calls.items():
                bms = moved / HBM_BYTES_PER_S * 1e3
                st_k = {"ms": device_ms(lambda: kern(*ops)), "cold_ms": cold_device_ms(kern, ops),
                        "plain_ms": device_ms(lambda: plain(*ops)),
                        "wrapper_ms": median_ms(lambda: kern(*ops)), "bound_ms": bms}
                out[(name, grid, dt)] = st_k
                log("kernels", set=tag, kernel=name, timing="graph-replayed", n=n,
                    **{k: f"{v:.5f}" for k, v in st_k.items()},
                    share_of_bound=f"{bms / st_k['ms']:.3f}",
                    cold_share_of_bound=f"{bms / st_k['cold_ms']:.3f}")
            if not (bool(torch.isfinite(sa).all()) and bool(torch.isfinite(wa).all())):
                raise AssertionError(f"{tag}: the timed calls left non-finite values")
        del y, vold, v, w, p, pold, x, d, vn, wn, vn_r, wn_r, got, want, ins
        torch.cuda.empty_cache()
    log("kernels", kernel="A/B", seconds=f"{time.perf_counter() - t0:.2f}")
    check_csm_prepared(dev)
    return out


def check_csm_prepared(dev) -> None:
    """One prepared CS-MINRES solve with 1/|d| on the damped 100³ Poisson
    (tol 1e-4): converged below a true residual of 1e-3, K5 once, K6, A and
    B its + 1 times each, no other kernel; then the median of 3 solves on
    the fused route and on the unfused loop (the route refused), whose count
    sums in another order on the card and must lie within
    :func:`parity_band` of it (64 against 66 its at tol 1e-4)."""
    csm = importlib.import_module("sprsolve_tpu_torch.solvers.cs_minres")
    arrays = damped_csr_arrays()
    A = CSR.from_arrays(*arrays, shape=(GRID ** 3,) * 2)
    r = np.random.default_rng(SEED + 22).standard_normal(A.shape[0]).astype(np.float32)
    b = torch.as_tensor((r + 0.25j * r).astype(np.complex64), device=dev)
    handle = spt.prepare(A, method="cs_minres", M="jacobi", tol=1e-4, max_iter=1000,
                         device=dev)
    handle(b)
    pd.reset_launch_counts()
    x, info = handle(b)
    torch.cuda.synchronize()
    n, c = int(info.iterations), launch_counts()
    res = complex_true_residual(arrays, A.shape, x, b.cpu().numpy())
    got = (c["dia_complex_spmv"], c["dia_complex_dot"], fused.csm_lanczos.launches,
           fused.csm_update.launches)
    others = {k: v for k, v in c.items() if k not in ("dia_complex_spmv", "dia_complex_dot")}
    if not (info.converged and res < 1e-3) or got != (1, n + 1, n + 1, n + 1) or any(
            others.values()) or fused.cg_update.launches or fused.cg_direction.launches:
        raise AssertionError(f"prepared CS-MINRES: {info}, true residual {res:.3e}, "
                             f"(K5, K6, A, B) = {got}, others {others}")
    wall, _, _, _ = timed_solves(handle, b, n, "CS-MINRES on A/B")
    with mock.patch.object(csm, "_fused_dinv", lambda *args: (False, None)):
        x_u, info_u = handle(b)
        wall_u, _, _, _ = timed_solves(handle, b, int(info_u.iterations), "CS-MINRES unfused")
    n_u = int(info_u.iterations)
    if abs(n_u - n) > parity_band(n):
        raise AssertionError(f"CS-MINRES: {n} iterations on A/B, {n_u} unfused")
    log("kernels", entry="prepare(cs_minres, M='jacobi') on A/B", iterations=n,
        true_residual=res, K5=got[0], K6=got[1], A=got[2], B=got[3],
        per_iteration_ms=f"{wall / n * 1e3:.4f}", unfused_iterations=n_u,
        unfused_per_iteration_ms=f"{wall_u / n_u * 1e3:.4f}")


# --- phase 3c, the multigrid colour step (GS) and HPCG's cycle ---------------
HPCG_SIDES = (256, 128, 64, 32)   # the levels of the benchmark's HPCG cell


def hpcg_level(side: int, dt, dev) -> "pd.PaddedDIA":
    """HPCG's 27-point operator on side³ (26 on the diagonal, −1 to each
    neighbour inside the grid) as ``optimize()`` lays it out (offsets
    ascending, f64 bands for f64, int8 for f32), built on the card from the
    stencil without the CSR's host passes."""
    n = side ** 3
    shifts = sorted(itertools.product((-1, 0, 1), repeat=3),
                    key=lambda s: (s[0] * side + s[1]) * side + s[2])
    offsets = tuple((a * side + b) * side + c for a, b, c in shifts)
    band_dt = torch.float64 if dt == torch.float64 else torch.int8
    h, n_pad = pd.layout(n, offsets, torch.empty((), dtype=dt).element_size())
    bands = torch.zeros((len(offsets), n_pad), dtype=band_dt, device=dev)
    for d, shift in enumerate(shifts):
        if shift == (0, 0, 0):
            bands[d, :n] = 26
            continue
        inside = torch.ones((side,) * 3, dtype=torch.bool, device=dev)
        for axis, s in enumerate(shift):
            if s:
                inside.select(axis, side - 1 if s > 0 else 0).fill_(False)
        bands[d, :n] = torch.where(inside.reshape(-1), -1, 0).to(band_dt)
    return pd.PaddedDIA(bands=bands, offsets=offsets, n=n, h=h, shape=(n, n), vdtype=dt)


def color_step_bytes(op, grid, color: int, first: bool = False) -> int:
    """Least bytes of one colour step: the colour's m band rows, all of z
    and its m rows of r read, its m rows of z written (37·n in f64 with 27
    bands); from z = 0 its diagonal and r read and z written, m rows each."""
    from sprsolve_tpu_torch.ops import gs_color

    m = int(np.prod(gs_color.color_extent(grid, color)))
    b, v = op.bands.element_size(), torch.empty((), dtype=op.vdtype).element_size()
    n = int(np.prod(grid))
    return (b + 2 * v) * m if first else len(op.offsets) * b * m + v * (n + 2 * m)


def check_color_steps(tag, op, grid, dev) -> None:
    """Every colour, from a random z and from z = 0, against the plain
    version on the card: the colour's rows within 32·eps of |z| + (|r| +
    |A|·|z|)/a_ii (27 fused products against the plain sum: 7e-15 in f64),
    every other row, the halo and the tail bitwise unchanged, one count a
    launch, a second launch bitwise the first."""
    from sprsolve_tpu_torch.ops import gs_color

    dt, diag = op.vdtype, op.offsets.index(0)
    eps = torch.finfo(dt).eps
    g = torch.Generator(device=dev).manual_seed(int(np.prod(grid)))
    absA = pd.PaddedDIA(bands=op.bands.to(dt).abs(), offsets=op.offsets, n=op.n, h=op.h,
                        shape=op.shape, vdtype=dt)
    worst = 0.0
    for first in (False, True):
        for color in range(gs_color.COLORS):
            z = op.pad_vec(torch.randn(op.n, generator=g, device=dev, dtype=dt))
            if first:
                z.zero_()
            r = op.pad_vec(torch.randn(op.n, generator=g, device=dev, dtype=dt))
            want = gs_color.color_step_plain(op.bands, z.clone(), r, op.offsets, op.h, grid,
                                             color, diag, first)
            n0 = gs_color.color_step.launches
            got = gs_color.color_step(op.bands, z.clone(), r, op.offsets, op.h, grid, color,
                                      diag, first)
            again = gs_color.color_step(op.bands, z.clone(), r, op.offsets, op.h, grid,
                                        color, diag, first)
            torch.cuda.synchronize()
            if gs_color.color_step.launches != n0 + 2:
                raise AssertionError(f"{tag}: not one count a colour step")
            if not torch.equal(got, again):
                raise AssertionError(f"{tag} colour {color}: two launches differ")
            scale = z.abs() + (r.abs() + absA.matvec(z.abs())) / 26.0
            err = float(((got - want).abs() / scale.clamp_min(torch.finfo(dt).tiny)).max())
            worst = max(worst, err / eps)
            if err > 32 * eps:
                raise AssertionError(f"{tag} colour {color} first={first}: {err / eps:.1f} eps")
            moved = torch.zeros(grid, dtype=torch.bool, device=dev)
            moved[(color >> 2) & 1::2, (color >> 1) & 1::2, color & 1::2] = True
            moved = op.pad_vec(moved.reshape(-1).to(dt)) > 0
            if not torch.equal(got[~moved], z[~moved]):
                raise AssertionError(f"{tag} colour {color}: a row outside the colour moved")
            del z, r, want, got, again, scale, moved
    log("gs", set=tag, n=op.n, result="every colour within 32 eps of plain; other rows, "
        "halo and tail bitwise; one count a launch; two launches bitwise equal",
        worst_eps=f"{worst:.2f}")


def phase_gs_color(dev) -> dict:
    """Phase 3c: the Gauss-Seidel colour step (``gs_color.color_step``,
    ``gs_color_step_kernel``) at the HPCG cell's shapes, the 256³, 128³,
    64³ and 32³ levels in f64 with 27 f64 bands and 64³ in f32 with int8
    bands, against its plain version on the card (``check_color_steps``);
    its graph-replayed warm (``ms``) and cold (``cold_ms``) times on each
    f64 level beside its bound (``color_step_bytes`` over 3.35 TB/s) and
    the plain version's; then HPCG's cycle on the four f64 levels: one
    apply at 256³ within 1e-12 of the plain reference
    (``tests/torch/hpcg_reference.py``), and one prepared CG solve to 1e-7,
    the counters zeroed just before it, launching ``steps_per_apply()`` ×
    (iterations + 1) colour steps, K1 3 × (iterations + 1) + 1 times and K3
    once an iteration.  Returns the times by level."""
    from sprsolve_tpu_torch.ops import gs_color

    t0 = time.perf_counter()
    out = {}
    ops = [hpcg_level(side, torch.float64, dev) for side in HPCG_SIDES]
    for side, op in zip(HPCG_SIDES, ops):
        grid = (side,) * 3
        check_color_steps(f"hpcg{side} f64", op, grid, dev)
        g = torch.Generator(device=dev).manual_seed(side)
        z = op.pad_vec(torch.randn(op.n, generator=g, device=dev, dtype=torch.float64))
        r = op.pad_vec(torch.randn(op.n, generator=g, device=dev, dtype=torch.float64))
        args = (op.offsets, op.h, grid, 0, op.offsets.index(0))
        step = lambda bands, z, r: gs_color.color_step(bands, z, r, *args)
        first = lambda bands, z, r: gs_color.color_step(bands, z, r, *args, first=True)
        plain = lambda bands, z, r: gs_color.color_step_plain(bands, z, r, *args)
        bms = color_step_bytes(op, grid, 0) / HBM_BYTES_PER_S * 1e3
        st = {"ms": device_ms(lambda: step(op.bands, z, r)),
              "cold_ms": cold_device_ms(step, (op.bands, z, r)),
              "plain_ms": device_ms(lambda: plain(op.bands, z, r), inner=5),
              "first_ms": device_ms(lambda: first(op.bands, z, r)),
              "bound_ms": bms,
              "first_bound_ms": color_step_bytes(op, grid, 0, True) / HBM_BYTES_PER_S * 1e3}
        out[side] = st
        log("gs", set=f"hpcg{side} f64", kernel="gs_color_step", timing="graph-replayed",
            n=op.n, **{k: f"{v:.5f}" for k, v in st.items()},
            share_of_bound=f"{bms / st['ms']:.3f}",
            cold_share_of_bound=f"{bms / st['cold_ms']:.3f}")
        del z, r
        torch.cuda.empty_cache()
    check_color_steps("hpcg64 f32 int8", hpcg_level(64, torch.float32, dev), (64,) * 3, dev)

    grids = [(side,) * 3 for side in HPCG_SIDES]
    mg = spt.InjectionMGPrecond.from_levels(ops, grids, device=dev)
    spec = importlib.util.spec_from_file_location(
        "hpcg_reference", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "tests", "torch", "hpcg_reference.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    n = ops[0].n
    r = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(SEED + 21),
                    device=dev, dtype=torch.float64)
    pd.reset_launch_counts()
    z = mg.matvec(r)
    torch.cuda.synchronize()
    per_level = mg.steps_per_apply()
    if per_level != (30, 30, 30, 15) or gs_color.color_step.launches != sum(per_level) or \
            pd.dia_spmv.launches != len(ops) - 1:
        raise AssertionError(f"one apply: {gs_color.color_step.launches} colour steps, "
                             f"{pd.dia_spmv.launches} K1, per level {per_level}")
    want = ref.mg_apply({"grid": list(grids[0])}, r, len(ops))
    rel = float((z - want).norm() / want.norm())
    rel_max = float((z - want).abs().max() / want.abs().max())
    if rel > 1e-12:
        raise AssertionError(f"the cycle at 256³: {rel:.3e} from the plain reference")
    del z, want
    apply_ms = median_ms(lambda: mg.matvec(r), reps=3, inner=3)
    log("gs", check="hpcg256 M·r against the plain reference cycle", rel_norm=f"{rel:.3e}",
        rel_max=f"{rel_max:.3e}", steps_per_apply=",".join(map(str, per_level)),
        apply_ms=f"{apply_ms:.4f}")

    handle = spt.prepare(ops[0], method="cg", M=mg, tol=1e-7, max_iter=1000, device=dev)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(SEED + 22),
                    device=dev, dtype=torch.float64)
    handle(b)
    torch.cuda.synchronize()
    pd.reset_launch_counts()
    t = time.perf_counter()
    x, info = handle(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    its, counts, steps = int(info.iterations), launch_counts(), gs_color.color_step.launches
    # K1: the restriction's residual on each level but the coarsest an
    # apply, and CG's r₀ = b − A·x₀ once; K3: A·p with its dot an iteration
    if not info.converged or steps != sum(per_level) * (its + 1) or \
            counts["dia_spmv"] != (len(ops) - 1) * (its + 1) + 1 or counts["dia_dot"] != its:
        raise AssertionError(f"the HPCG solve: converged {info.converged}, {its} its, "
                             f"{steps} colour steps, counts {counts}")
    res = float((ops[0].unpad_vec(ops[0].matvec(ops[0].pad_vec(x))) - b).norm() / b.norm())
    log("gs", check="hpcg256 prepared CG with the cycle, counters zeroed before",
        iterations=its, colour_steps=steps, per_apply=sum(per_level),
        k1=counts["dia_spmv"], k3=counts["dia_dot"], true_rel_residual=f"{res:.3e}",
        solve_s=f"{solve_s:.4f}")
    del ops, mg, handle, x, b, r
    torch.cuda.empty_cache()
    log("gs", kernel="gs_color_step", seconds=f"{time.perf_counter() - t0:.2f}")
    return out


def check_dot_kernels(name, op, x, w, dinv, profile: bool) -> None:
    """K3 and the four K2 variants: y bitwise K1's on the SpMV input (x, or
    x ⊙ dinv under the fold); the dots of 10 eager calls and of a CUDA-graph
    replay bitwise the same; with ``profile``, one CUDA kernel per call."""
    b, o, h = op.bands, op.offsets, op.h
    calls = {   # name → (call, SpMV input)
        "K3": (lambda: pd.dia_dot(b, x, o, h), x),
        "K2 w=r0": (lambda: pd.dia_wdot(b, x, w, None, o, h), x),
        "K2 w=x": (lambda: pd.dia_wdot(b, x, None, None, o, h), x),
        "K2 fold w=r0": (lambda: pd.dia_wdot(b, x, w, dinv, o, h), x * dinv),
        "K2 fold w=x": (lambda: pd.dia_wdot(b, x, None, dinv, o, h), x * dinv),
    }
    check_one_launch(name, calls, lambda u: pd.dia_spmv(b, u, o, h), "K1",
                     "dia_dots_kernel", profile)


def check_complex_dot_kernels(name, op, x, w, dinv, profile: bool) -> None:
    """K6 (both forms) and the four K7 variants: y bitwise K5's (K6 on x, K6
    with ``conj_x`` on conj(x), K7 without the fold on x); the dots of 10
    eager calls and of a CUDA-graph replay bitwise the same; with
    ``profile``, one CUDA kernel per call."""
    bre, bim, o, h = op.re.bands, op.im.bands, op.offsets, op.h
    calls = {   # name → (call, K5's input giving y bit for bit; None: the fold)
        "K6": (lambda: pd.dia_complex_dot(bre, bim, x, o, h), x),
        "K6 conj_x": (lambda: pd.dia_complex_dot(bre, bim, x, o, h, True),
                      torch.conj_physical(x)),
        "K7 w=r0": (lambda: pd.dia_complex_wdot(bre, bim, x, w, None, o, h), x),
        "K7 w=x": (lambda: pd.dia_complex_wdot(bre, bim, x, None, None, o, h), x),
        "K7 fold w=r0": (lambda: pd.dia_complex_wdot(bre, bim, x, w, dinv, o, h), None),
        "K7 fold w=x": (lambda: pd.dia_complex_wdot(bre, bim, x, None, dinv, o, h), None),
    }
    check_one_launch(name, calls, lambda u: pd.dia_complex_spmv(bre, bim, u, o, h), "K5",
                     "dia_complex_dots_kernel", profile)


def check_one_launch(name, calls, spmv, spmv_name, kernel, profile: bool) -> None:
    """The checks of a one-launch dot kernel: each call's y bitwise
    ``spmv`` of its input (where one is given; K4 has none); the outputs of 10 eager
    calls and of 3 replays of a CUDA graph of all the calls bitwise the
    first call's; every ticket back at 0; with ``profile``, one CUDA kernel
    (``kernel``) per call under torch.profiler."""
    same = lambda p, q: all(torch.equal(s, t) for s, t in zip(p, q))
    eager = {}
    for tag, (call, u) in calls.items():
        eager[tag] = call()
        if u is not None and not torch.equal(eager[tag][0], spmv(u)):
            raise AssertionError(f"{name} {tag}: y is not {spmv_name}'s bit for bit")
        for _ in range(10):
            if not same(call(), eager[tag]):
                raise AssertionError(f"{name} {tag}: dots differ between eager calls")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call, _ in calls.values():
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = {tag: call() for tag, (call, _) in calls.items()}
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for tag in calls:
            if not same(captured[tag], eager[tag]):
                raise AssertionError(f"{name} {tag}: a graph replay differs from eager")
    if any(int(buf[:4].view(torch.int32).item()) for buf in pd._dot_scratch.values()):
        raise AssertionError("a dot kernel's ticket is not back at 0")
    if profile:
        for tag, (call, _) in calls.items():
            ev = kernel_events(call)
            if len(ev) != 1 or kernel not in ev[0][0]:
                raise AssertionError(f"{tag}: one call ran {ev}, not one kernel")
            log("kernels", set=name, call=tag, profiler_events=1,
                kernel_us=f"{ev[0][1]:.3f}")
    ys = f"y bitwise {spmv_name}'s where unfolded; " if spmv_name else ""
    log("kernels", set=name, kernels="/".join(dict.fromkeys(t.split()[0] for t in calls)),
        result=f"{ys}outputs bitwise equal over 10 eager calls and 3 graph replays; "
        "tickets at 0")


def real_kernel_stats(op, x, dinv, mk, csr=None, tag="poisson100_int8") -> dict:
    """Graph-replayed device times of K1-K4 and their plain versions at the
    main path's shapes (K2 with the Jacobi fold and w = x, BiCGStab's second
    SpMV; and with w = r0, its first, as a row of its own), warm and cold in
    L2, the wrapper times, each kernel's bound from these inputs, and K1's
    library call on ``csr`` (default: the f32 Poisson)."""
    D, n_pad, h = len(op.offsets), op.n_pad, op.h
    b, o = op.bands, op.offsets
    a, vold, v, r0 = mk(), mk(), mk(), mk()
    # of the vectors' dtype, as MINRES passes them (else each call casts them)
    beta = torch.tensor(0.7, dtype=op.vdtype, device=x.device)
    alpha = torch.tensor(-1.3, dtype=op.vdtype, device=x.device)
    calls = {   # name → (kernel, plain version, operands, bytes moved, flops)
        "dia_spmv": (lambda b, x: pd.dia_spmv(b, x, o, h),
                     lambda b, x: pd.dia_spmv_plain(b, x, o, h),
                     (b, x), nbytes(b, x, x), 2 * D * n_pad),
        "dia_wdot": (lambda b, x, d: pd.dia_wdot(b, x, None, d, o, h),
                     lambda b, x, d: pd.dia_wdot_plain(b, x, None, d, o, h),
                     (b, x, dinv), nbytes(b, x, dinv, x), (2 * D + 5) * n_pad),
        "dia_wdot[has_dinv,w=r0]": (
            lambda b, x, w, d: pd.dia_wdot(b, x, w, d, o, h),
            lambda b, x, w, d: pd.dia_wdot_plain(b, x, w, d, o, h),
            (b, x, r0, dinv), nbytes(b, x, dinv, r0, x), (2 * D + 5) * n_pad),
        "dia_dot": (lambda b, x: pd.dia_dot(b, x, o, h),
                    lambda b, x: pd.dia_dot_plain(b, x, o, h),
                    (b, x), nbytes(b, x, x), (2 * D + 2) * n_pad),
        "orth_norm": (lambda *t: fused.orth_norm(*t, h), lambda *t: fused.orth_norm_plain(*t, h),
                      (a, vold, v, beta, alpha), orth_norm_bytes(a, h), 6 * n_pad),
    }
    stats = {}
    for name, (kern, plain, ops, moved, flops) in calls.items():
        bms, by = bound_ms(moved, flops, op.vdtype)
        stats[name] = {"ms": device_ms(lambda: kern(*ops)),
                       "cold_ms": cold_device_ms(kern, ops),
                       "plain_ms": device_ms(lambda: plain(*ops)),
                       "wrapper_ms": median_ms(lambda: kern(*ops)),
                       "bound_ms": bms, "bound_by": by, "library_ms": None}
    A = problems.poisson3d(GRID, GRID, GRID) if csr is None else csr
    stats["dia_spmv"]["library_ms"] = library_ms(
        "K1 dia_spmv", A, op.unpad_vec(x).contiguous(),
        op.unpad_vec(pd.dia_spmv(b, x, o, h)))
    for name, st in stats.items():
        log("kernels", set=tag, kernel=name, timing="graph-replayed",
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in st.items()},
            share_of_bound=f"{st['bound_ms'] / st['ms']:.3f}",
            cold_share_of_bound=f"{st['bound_ms'] / st['cold_ms']:.3f}")
    return stats


def damped_dia() -> DIA:
    """The damped complex-symmetric 100³ Poisson, A + 0.5i·I, from the
    port's Poisson bands (as bench.py builds it): an int8-exact real plane
    and a bf16-exact imaginary plane."""
    dia = DIA.from_csr(problems.poisson3d(GRID, GRID, GRID), device="cpu")
    bands = dia.bands.numpy().astype(np.complex64)
    bands[dia.offsets.index(0)] += 0.5j
    return DIA(bands=torch.from_numpy(bands), offsets=dia.offsets, shape=dia.shape)


def complex_band_sets(dev):
    """(name, ComplexPaddedDIA) for the four two-plane band sets of phase 3,
    with their expected plane storage checked."""
    damped = damped_dia()
    base = damped.bands.numpy().real
    mask = base != 0
    rng = np.random.default_rng(SEED + 4)
    rand = np.where(mask, rng.uniform(0.5, 1.5, base.shape)
                    + 1j * rng.uniform(-1.0, 1.0, base.shape), 0)
    sets = [("damped_int8_bf16", damped)]
    for name, vals in (("scaled_int8_bf16", base * (1 + 0.5j)),
                       ("random_c64", rand.astype(np.complex64)),
                       ("random_c128", rand.astype(np.complex128))):
        sets.append((name, DIA(bands=torch.from_numpy(vals.astype(
            np.complex128 if name == "random_c128" else np.complex64)),
            offsets=damped.offsets, shape=damped.shape)))
    expect = {"damped_int8_bf16": (torch.int8, torch.bfloat16),
              "scaled_int8_bf16": (torch.int8, torch.bfloat16),
              "random_c64": (torch.float32, torch.float32),
              "random_c128": (torch.float64, torch.float64)}
    out = []
    for name, dia in sets:
        op = spt.ComplexPaddedDIA.from_dia(dia, device=dev)
        got = (op.re.bands.dtype, op.im.bands.dtype)
        assert got == expect[name], (name, got)
        out.append((name, op))
    return out


def phase_complex_kernels(dev, errs, stats):
    """Phase 3, two-plane part: K5, K6 (both forms) and K7 (four variants)
    against their plain versions on every complex band set; narrow planes
    bitwise equal to wide ones; on the damped set the graph-replayed times,
    the bounds and K5's library call."""
    rng = np.random.default_rng(SEED + 5)
    for name, op in complex_band_sets(dev):
        rdt = op.re.vdtype
        mk = lambda: op.pad_vec(torch.complex(
            *(torch.as_tensor(rng.standard_normal(op.n), dtype=rdt, device=dev)
              for _ in range(2))))
        x, w = mk(), mk()
        dinv = op.jacobi_precond().diag_inv
        bre, bim, o, h = op.re.bands, op.im.bands, op.offsets, op.h
        narrow = bre.dtype in (torch.int8, torch.bfloat16)
        wide = (bre.to(rdt), bim.to(rdt))
        absb = bre.to(rdt).abs() + bim.to(rdt).abs()
        yrt, drt = Y_RTOL[rdt], DOT_RTOL[rdt]

        def check_y(tag, y, y_r, u):
            scale = pd.dia_spmv_plain(absb, u.real.abs() + u.imag.abs(), o, h).max()
            check_halo(tag, op, y)
            return check_close(tag + " y", y, y_r, scale, yrt)

        dirty(x)
        y = pd.dia_complex_spmv(bre, bim, x, o, h)
        e = check_y(f"{name} K5", y, pd.dia_complex_spmv_plain(bre, bim, x, o, h), x)
        errs["dia_complex_spmv"] = max(errs["dia_complex_spmv"], e)
        if narrow and not torch.equal(y, pd.dia_complex_spmv(*wide, x, o, h)):
            raise AssertionError(f"{name}: narrow and f32 planes differ (K5)")
        for conj_x in (False, True):
            tag = f"{name} K6 conj_x={conj_x}"
            dirty(x)
            y, d = pd.dia_complex_dot(bre, bim, x, o, h, conj_x)
            y_r, d_r = pd.dia_complex_dot_plain(bre, bim, x, o, h, conj_x)
            e = check_y(tag, y, y_r, x)
            errs["dia_complex_dot"] = max(errs["dia_complex_dot"], e)
            check_close(tag + " dot", d, d_r, (x.abs() * y_r.abs()).sum(), drt)
            if narrow:
                yw, dw = pd.dia_complex_dot(*wide, x, o, h, conj_x)
                if not (torch.equal(y, yw) and torch.equal(d, dw)):
                    raise AssertionError(f"{tag}: narrow and f32 planes differ")
        for wv in (w, None):
            for dv in (None, dinv):
                tag = f"{name} K7 w_is_x={wv is None} has_dinv={dv is not None}"
                dirty(x)
                got = pd.dia_complex_wdot(bre, bim, x, wv, dv, o, h)
                y_r, wd_r, yd_r = pd.dia_complex_wdot_plain(bre, bim, x, wv, dv, o, h)
                e = check_y(tag, got[0], y_r, x if dv is None else x * dv)
                errs["dia_complex_wdot"] = max(errs["dia_complex_wdot"], e)
                ws = (x if wv is None else wv).abs()
                check_close(tag + " wy", got[1], wd_r, (ws * y_r.abs()).sum(), drt)
                check_close(tag + " yy", got[2], yd_r, yd_r.real, drt)
                if narrow:
                    gw = pd.dia_complex_wdot(*wide, x, wv, dv, o, h)
                    if not all(torch.equal(p, q) for p, q in zip(got, gw)):
                        raise AssertionError(f"{tag}: narrow and f32 planes differ")
        check_complex_dot_kernels(name, op, x, w, dinv, profile=name == "damped_int8_bf16")
        torch.cuda.synchronize()
        log("kernels", set=name, planes=f"{bre.dtype}/{bim.dtype}".replace("torch.", ""),
            K5_ms=f"{median_ms(lambda: pd.dia_complex_spmv(bre, bim, x, o, h)):.4f}",
            K5_plain_ms=f"{median_ms(lambda: pd.dia_complex_spmv_plain(bre, bim, x, o, h)):.4f}",
            timing="wrapper, 20 back-to-back calls")
        if name == "damped_int8_bf16":
            stats.update(complex_kernel_stats(op, x, w, dinv))


def complex_kernel_stats(op, x, w, dinv, csr_arrays=None, tag="damped_int8_bf16") -> dict:
    """K5-K7 at the main path's shapes (the damped set): graph-replayed
    device times of every variant and their plain versions, the bounds from
    these inputs, and K5's library call on ``csr_arrays`` (default: the c64
    damped Poisson). The kernel line reports K6 with ``conj_x``
    (CS-MINRES's step) and K7 with the fold and w = x (BiCGStab's second
    SpMV)."""
    bre, bim, o, h = op.re.bands, op.im.bands, op.offsets, op.h
    D, n_pad = len(o), op.n_pad
    planes = nbytes(bre, bim)
    variants = {   # name → (kernel, plain version, operands, bytes moved, flops)
        "dia_complex_spmv": (lambda br, bi, x: pd.dia_complex_spmv(br, bi, x, o, h),
                             lambda br, bi, x: pd.dia_complex_spmv_plain(br, bi, x, o, h),
                             (bre, bim, x), planes + nbytes(x, x), (8 * D + 2) * n_pad),
        "dia_complex_dot[conj_x=False]": (
            lambda br, bi, x: pd.dia_complex_dot(br, bi, x, o, h),
            lambda br, bi, x: pd.dia_complex_dot_plain(br, bi, x, o, h),
            (bre, bim, x), planes + nbytes(x, x), (8 * D + 6) * n_pad),
        "dia_complex_dot": (
            lambda br, bi, x: pd.dia_complex_dot(br, bi, x, o, h, True),
            lambda br, bi, x: pd.dia_complex_dot_plain(br, bi, x, o, h, True),
            (bre, bim, x), planes + nbytes(x, x), (8 * D + 6) * n_pad),
        "dia_complex_wdot[has_dinv,w=r0]": (
            lambda br, bi, x, w, d: pd.dia_complex_wdot(br, bi, x, w, d, o, h),
            lambda br, bi, x, w, d: pd.dia_complex_wdot_plain(br, bi, x, w, d, o, h),
            (bre, bim, x, w, dinv), planes + nbytes(x, dinv, w, x), (14 * D + 10) * n_pad),
        "dia_complex_wdot": (
            lambda br, bi, x, d: pd.dia_complex_wdot(br, bi, x, None, d, o, h),
            lambda br, bi, x, d: pd.dia_complex_wdot_plain(br, bi, x, None, d, o, h),
            (bre, bim, x, dinv), planes + nbytes(x, dinv, x), (14 * D + 10) * n_pad),
    }
    stats = {}
    for name, (kern, plain, ops, moved, flops) in variants.items():
        bms, by = bound_ms(moved, flops, op.re.vdtype)
        stats[name] = {"ms": device_ms(lambda: kern(*ops)),
                       "cold_ms": cold_device_ms(kern, ops),
                       "plain_ms": device_ms(lambda: plain(*ops)),
                       "wrapper_ms": median_ms(lambda: kern(*ops)), "bound_ms": bms,
                       "bound_by": by, "library_ms": None}
    csr = spt.CSR.from_arrays(*(csr_arrays or damped_csr_arrays()), shape=op.shape)
    stats["dia_complex_spmv"]["library_ms"] = library_ms(
        "K5 dia_complex_spmv", csr, op.unpad_vec(x).contiguous(),
        op.unpad_vec(pd.dia_complex_spmv(bre, bim, x, o, h)))
    for name, st in stats.items():
        log("kernels", set=tag, kernel=name, timing="graph-replayed",
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in st.items()},
            share_of_bound=f"{st['bound_ms'] / st['ms']:.3f}",
            cold_share_of_bound=f"{st['bound_ms'] / st['cold_ms']:.3f}")
    return stats


# --- phase 3, K1b: the column-batched K1 -------------------------------------
SPMM_COLUMNS = (1, 3, 4, 8, 12, 17)   # the block widths of phase 3's K1b checks at 1M rows
SPMM_SMS = (1, 7)   # forced SM counts: one wave of a few blocks, each walking many tiles
EIGEN_BLOCK = 12                # LOBPCG's (n, 3k) block at k = 4


def spmm_tiles(lib, X2, Y, m: int, n_pad: int) -> int:
    """The tiles of SPMM_TILE column groups that K1b walks on this block
    (the kernel's own column grouping, asked of the library)."""
    w = lib.sprsolve_dia_spmm_width(pd._VCODE[X2.dtype], m, X2.data_ptr(), Y.data_ptr())
    return -(-(n_pad * (m // w)) // pd.SPMM_TILE)


def check_spmm_kernel(name, op, rng, errs, profile: bool, columns=SPMM_COLUMNS) -> None:
    """K1b on one band set at every width of ``columns``: column j bitwise
    K1's on column j (halo rows zero after a NaN block was freed), the
    same bitwise with the card said to have SPMM_SMS SMs (one wave of a few
    blocks walking the tiles), within Y_RTOL of the plain version; with
    ``profile``, one kernel per call."""
    dt, b, o, h = op.vdtype, op.bands, op.offsets, op.h
    absb = b.to(dt).abs()
    lib, sm_count = _cuda_build.load(), pd._sm_count
    walks = []
    for m in columns:
        X2 = op.pad_block(torch.as_tensor(rng.standard_normal((op.n, m)), dtype=dt,
                                          device=b.device))
        dirty(X2)
        Y = pd.dia_spmm(b, X2, o, h)
        for j in range(m):
            if not torch.equal(Y[:, j], pd.dia_spmv(b, X2[:, j].contiguous(), o, h)):
                raise AssertionError(f"{name} K1b m={m}: column {j} is not K1's bit for bit")
        if bool(Y[:h].any()) or bool(Y[h + op.n:].any()):
            raise AssertionError(f"{name} K1b m={m}: nonzero halo or tail rows")
        tiles = spmm_tiles(lib, X2, Y, m, op.n_pad)
        # an SM holds at most 2048 threads: 8 blocks of SPMM_TILE
        if tiles <= 8 * max(SPMM_SMS):
            raise AssertionError(f"{name} K1b m={m}: {tiles} tiles walk no forced grid")
        walks.append(tiles // (8 * max(SPMM_SMS)))
        try:
            for sms in SPMM_SMS:
                pd._sm_count = lambda index, sms=sms: sms
                if not torch.equal(pd.dia_spmm(b, X2, o, h), Y):
                    raise AssertionError(f"{name} K1b m={m}: the grid of {sms} SMs differs")
        finally:
            pd._sm_count = sm_count
        scale = pd.dia_spmm_plain(absb, X2.abs(), o, h).max()
        e = check_close(f"{name} K1b m={m}", Y, pd.dia_spmm_plain(b, X2, o, h), scale,
                        Y_RTOL[dt])
        errs["dia_spmm"] = max(errs["dia_spmm"], e)
        if profile and m == EIGEN_BLOCK:
            ev = kernel_events(lambda: pd.dia_spmm(b, X2, o, h))
            if len(ev) != 1 or "dia_spmm_kernel" not in ev[0][0]:
                raise AssertionError(f"K1b: one call ran {ev}, not one kernel")
            log("kernels", set=name, call=f"K1b m={m}", profiler_events=1,
                kernel_us=f"{ev[0][1]:.3f}")
    torch.cuda.synchronize()
    log("kernels", set=name, kernel="K1b", columns=",".join(map(str, columns)),
        result="each column bitwise K1's, also on the one-wave grids of "
        + " and ".join(map(str, SPMM_SMS)) + " SMs; halo rows zero",
        least_tiles_per_block_walked=min(walks))


def library_spmm_ms(what, csr, X, Y_kernel):
    """``torch.sparse.mm`` of a ``torch.sparse_csr_tensor`` of the same
    matrix on the unpadded (n, m) block: K1b's yardstick, never called by
    the port. Its graph-replayed ms, or None (printed) where torch cannot
    run it on the card."""
    try:
        S = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr.numpy().astype(np.int32), device=X.device),
            torch.as_tensor(csr.indices.numpy().astype(np.int32), device=X.device),
            torch.as_tensor(csr.data.numpy(), device=X.device), size=csr.shape)
        Y = torch.sparse.mm(S, X)
        err = float((Y - Y_kernel).abs().max())
        t = device_ms(lambda: torch.sparse.mm(S, X))
    except Exception as e:   # the yardstick only: report, and time nothing
        log("library", kernel=what, call="torch.sparse.mm(sparse_csr, X)",
            unavailable=repr(e)[:200])
        return None
    log("library", kernel=what, call="torch.sparse.mm(sparse_csr, X)", columns=X.shape[1],
        ms=f"{t:.5f}", max_abs_diff_vs_kernel=f"{err:.3e}")
    return t


def spmm_stats(tag, A, op, rng) -> dict:
    """K1b at an eigensolver's shape (``op`` from ``A``, m = EIGEN_BLOCK
    f32 columns): graph-replayed warm and cold device time, the plain
    version's, the wrapper's, the bytes bound (bands once, the block read
    once and written once) and ``torch.sparse.mm``'s time; twelve K1 calls
    on the same columns beside it."""
    m, b, o, h = EIGEN_BLOCK, op.bands, op.offsets, op.h
    X = torch.as_tensor(rng.standard_normal((op.n, m)), dtype=torch.float32,
                        device=b.device)
    X2 = op.pad_block(X)
    Y2 = pd.dia_spmm(b, X2, o, h)
    cols = [X2[:, j].contiguous() for j in range(m)]
    bms, by = bound_ms(nbytes(b, X2, Y2), 2.0 * len(o) * op.n_pad * m, torch.float32)
    st = {"ms": device_ms(lambda: pd.dia_spmm(b, X2, o, h)),
          "cold_ms": cold_device_ms(lambda b, x: pd.dia_spmm(b, x, o, h), (b, X2)),
          "plain_ms": device_ms(lambda: pd.dia_spmm_plain(b, X2, o, h)),
          "wrapper_ms": median_ms(lambda: pd.dia_spmm(b, X2, o, h)),
          "bound_ms": bms, "bound_by": by,
          "k1_x12_ms": device_ms(lambda: [pd.dia_spmv(b, c, o, h) for c in cols]),
          "library_ms": library_spmm_ms(f"K1b {tag}", A, X, op.unpad_block(Y2))}
    log("kernels", set=tag, kernel="dia_spmm", columns=m, timing="graph-replayed",
        **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in st.items()},
        share_of_bound=f"{bms / st['ms']:.3f}", cold_share_of_bound=f"{bms / st['cold_ms']:.3f}")
    return st


def phase_spmm(dev, errs, stats):
    """Phase 3, K1b: every band set of phase 3 (1M rows: int8, f32, bf16,
    f64) at SPMM_COLUMNS, then every other shape the eigen phase gives
    K1b (64³ at 4, 8 and 12 columns for shift-invert, 32³ at 8 and 16 for
    the rational filter's Rayleigh-Ritz and its two planes of 8), then the
    timings at the shift-invert shape (64³) and the LOBPCG shape (100³),
    m = 12; the kernel line reports the LOBPCG shape."""
    rng = np.random.default_rng(SEED + 9)
    for name, op, _ in band_sets(dev):
        check_spmm_kernel(name, op, rng, errs, profile=name == "poisson100_int8")
    A64, A32 = (problems.poisson3d(g, g, g) for g in (SI_GRID, RF_GRID))
    op64, op32 = (spt.optimize(a, device=dev) for a in (A64, A32))
    check_spmm_kernel(f"poisson{SI_GRID}_int8", op64, rng, errs, False, (4, 8, 12))
    check_spmm_kernel(f"poisson{RF_GRID}_int8", op32, rng, errs, False, (8, 16))
    spmm_stats(f"poisson{SI_GRID}_int8", A64, op64, rng)
    A = problems.poisson3d(GRID, GRID, GRID)
    stats["dia_spmm"] = spmm_stats("poisson100_int8", A, spt.optimize(A, device=dev), rng)


def phase_orth_norm(name, op, mk, errs):
    """K4 on three vectors of ``op``'s layout, with β and α as 0-d CUDA
    tensors as MINRES passes them: within Y_RTOL and DOT_RTOL of its plain
    version, halos zero, and one kernel a call whose outputs are bitwise
    the same over eager calls and graph replays (:func:`check_one_launch`);
    returns its and its plain version's median times."""
    dt, dev = op.vdtype, op.device
    a, vold, v = mk(), mk(), mk()
    beta = torch.tensor(0.7, dtype=dt, device=dev)
    alpha = torch.tensor(-1.3, dtype=dt, device=dev)
    dirty(a)
    vn, ss = fused.orth_norm(a, vold, v, beta, alpha, op.h)
    vn_r, ss_r = fused.orth_norm_plain(a, vold, v, beta, alpha, op.h)
    scale = a.abs() + 0.7 * vold.abs() + 1.3 * v.abs()
    if not bool(((vn - vn_r).abs() <= Y_RTOL[dt] * scale).all()):
        raise AssertionError(f"{name} K4: v+ outside rtol {Y_RTOL[dt]}")
    errs["orth_norm"] = max(errs["orth_norm"], float((vn - vn_r).abs().max()))
    check_close(f"{name} K4 sumsq", ss, ss_r, ss_r, DOT_RTOL[dt])
    check_halo(f"{name} K4 v+", op, vn)
    check_one_launch(name, {"K4": (lambda: fused.orth_norm(a, vold, v, beta, alpha, op.h),
                                   None)},
                     None, None, "orth_norm_kernel", profile=True)
    torch.cuda.synchronize()
    return {
        "orth_norm": median_ms(lambda: fused.orth_norm(a, vold, v, beta, alpha, op.h)),
        "orth_norm_plain": median_ms(lambda: fused.orth_norm_plain(a, vold, v, beta, alpha,
                                                                   op.h)),
    }


def true_residual(A, x, b) -> float:
    import scipy.sparse as sps

    S = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(),
                        A.indptr.numpy()), shape=A.shape)
    xh = x.detach().cpu().numpy().astype(np.float64)
    bh = np.asarray(b, np.float64)
    return float(np.linalg.norm(S @ xh - bh) / np.linalg.norm(bh))


def poisson_rhs(A) -> np.ndarray:
    return np.random.default_rng(SEED + 2).standard_normal(A.shape[0]).astype(np.float32)


def timed_solves(handle, b, its, what):
    """Three solves through a prepared handle, each required to converge (in
    ``its`` iterations when ``its`` is given). Returns the median wall
    seconds, the walls, and the last solve's ``(x, info)``."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = handle(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not info.converged or (its is not None and int(info.iterations) != its):
            raise AssertionError(f"{what}: {info} (solve took {its} iterations)")
    return statistics.median(walls), walls, x, info


def phase_slice(dev):
    """Phase 4: the main path through solve() and prepare()."""
    A = problems.poisson3d(GRID, GRID, GRID)
    b = poisson_rhs(A)
    kw = dict(method="bicgstab", M="jacobi", tol=1e-4, max_iter=400)
    pd.reset_launch_counts()
    x, info = spt.solve(A, b, device=dev, **kw)
    torch.cuda.synchronize()
    launches = launch_counts()
    its = int(info.iterations)
    res = true_residual(A, x, b)
    if not info.converged:
        raise AssertionError(f"solve did not converge: {info}")
    if not (x.shape == (A.shape[0],) and bool(torch.isfinite(x).all())):
        raise AssertionError("solution is not a finite (n,) vector")
    if not res < 1e-3:
        raise AssertionError(f"true relative residual {res:.3e} >= 1e-3")
    if launches["dia_spmv"] < 1 or launches["dia_wdot"] != 2 * its:
        raise AssertionError(f"launch counts {launches} for {its} iterations")
    log("slice", entry="solve", iterations=its, recurrence_residual=float(info.residual),
        true_residual=res, K1_launches=launches["dia_spmv"],
        K2_launches=launches["dia_wdot"])

    handle = spt.prepare(A, device=dev, **kw)
    wall, walls, x2, _ = timed_solves(handle, torch.as_tensor(b, device=dev), its,
                                      "prepare")
    res2 = true_residual(A, x2, b)
    if not res2 < 1e-3:
        raise AssertionError(f"prepare: true relative residual {res2:.3e}")
    log("slice", entry="prepare", iterations=its, wall_s_median=f"{wall:.4f}",
        walls_s=",".join(f"{w:.4f}" for w in walls),
        per_iteration_ms=f"{wall / its * 1e3:.4f}", true_residual=res2)
    RUN_COUNTS.update(bicgstab_jacobi=its, bicgstab_jacobi_ms=wall / its * 1e3)
    return launches


def phase_f64(dev):
    """Phase 5: f64 BiCGStab on the kernels, the reference's 100×100 grid."""
    A = problems.grid_laplacian_dirichlet((100, 100))
    rhs = np.zeros(A.shape[0])
    problems.set_boundary_condition(rhs, (100, 100), lambda r, c: float(r + c))
    op = spt.PaddedDIA.from_dia(A.to_dia(), device=dev)
    before = pd.dia_wdot.launches
    x2, info = spt.bicgstab(op, op.pad_vec(torch.as_tensor(rhs, device=dev)),
                            tol=1e-16, max_iter=5000)
    x = op.unpad_vec(x2)
    res = true_residual(A, x, rhs)
    if not info.converged or not res < 1e-12 or pd.dia_wdot.launches == before:
        raise AssertionError(f"f64 grid: {info}, true residual {res:.3e}")
    log("f64", grid="100x100", iterations=int(info.iterations),
        recurrence_residual=float(info.residual), true_residual=res)


class PlainOperator:
    """A PaddedDIA's operator protocol through the plain PyTorch versions of
    K1, K3 and K4 on the same CUDA tensors: the baseline of phase 6."""

    def __init__(self, op):
        self.op = op
        self.shape, self.padded_len, self.device = op.shape, op.padded_len, op.device
        self.pad_vec, self.unpad_vec = op.pad_vec, op.unpad_vec
        self.jacobi_precond = op.jacobi_precond

    def matvec(self, x2):
        return pd.dia_spmv_plain(self.op.bands, x2, self.op.offsets, self.op.h)

    def matvec_dot(self, x2):
        return pd.dia_dot_plain(self.op.bands, x2, self.op.offsets, self.op.h)

    def orth_norm(self, a2, vold2, v2, beta, alpha):
        return fused.orth_norm_plain(a2, vold2, v2, beta, alpha, self.op.h)


def phase_symmetric(dev):
    """Phase 6: MINRES, CG and auto on the f32 Poisson through solve(), then
    through prepare(), against the plain versions. Returns MINRES's launch
    counts."""
    A = problems.poisson3d(GRID, GRID, GRID)
    b = poisson_rhs(A)
    runs = {
        "minres": dict(method="minres"),
        "cg": dict(method="cg", M="jacobi"),
        "auto": dict(method="auto"),
    }
    its = {}
    for name, kw in runs.items():
        pd.reset_launch_counts()
        x, info = spt.solve(A, b, device=dev, tol=1e-4, max_iter=1000, **kw)
        torch.cuda.synchronize()
        n, c = int(info.iterations), launch_counts()
        res = true_residual(A, x, b)
        if not (info.converged and res < 1e-3 and bool(torch.isfinite(x).all())
                and x.shape == (A.shape[0],)):
            raise AssertionError(f"{name}: {info}, true residual {res:.3e}")
        want = {"dia_spmv": 1, "dia_spmm": 0, "dia_wdot": 0,
                "dia_dot": n if name == "cg" else n + 1,
                "orth_norm": 0 if name == "cg" else n + 1,
                "dia_complex_spmv": 0, "dia_complex_dot": 0, "dia_complex_wdot": 0}
        if c != want:
            raise AssertionError(f"{name}: launch counts {c}, expected {want}")
        up = (fused.cg_update.launches, fused.cg_direction.launches)
        if up != ((n, n) if name == "cg" else (0, 0)):
            raise AssertionError(f"{name}: U/P launched {up} times in {n} iterations")
        its[name] = n
        if name == "minres":
            launches = c
        log("symmetric", entry=f"solve(method={kw['method']!r}"
            + (", M='jacobi')" if "M" in kw else ")"), iterations=n,
            recurrence_residual=float(info.residual), true_residual=res,
            **{f"{k}_launches": v for k, v in c.items()}, cg_update_launches=up[0],
            cg_direction_launches=up[1])
    RUN_COUNTS.update(minres=its["minres"], cg_jacobi=its["cg"])

    bd = torch.as_tensor(b, device=dev)
    kernel_op = spt.PaddedDIA.from_dia(DIA.from_csr(A, device="cpu"), device=dev)
    for name in ("minres", "cg"):
        kw = dict(runs[name], tol=1e-4, max_iter=1000)
        for path, op in (("kernels", A), ("plain", PlainOperator(kernel_op))):
            handle = spt.prepare(op, device=dev, **kw)
            wall, walls, x, info = timed_solves(
                handle, bd, its[name] if path == "kernels" else None, f"{name} {path}")
            n = int(info.iterations)
            res = true_residual(A, x, b)
            if not res < 1e-3:
                raise AssertionError(f"{name} {path}: true residual {res:.3e}")
            # one profiled solve on the kernels: device time and idle share
            prof = idle_share(handle, bd, names=REAL_KERNELS) if path == "kernels" else None
            extra = {} if prof is None else dict(
                device_busy_ms=f"{prof[1]:.4f}", idle_share=f"{prof[2]:.4f}",
                hand_kernels_ms=f"{prof[3]:.4f}",
                device_us_per_iteration=f"{prof[1] / max(n, 1) * 1e3:.3f}")
            log("symmetric", entry=f"prepare({name}, {path})", iterations=n,
                wall_s_median=f"{wall:.4f}", walls_s=",".join(f"{w:.4f}" for w in walls),
                per_iteration_ms=f"{wall / max(n, 1) * 1e3:.4f}", true_residual=res,
                **extra)
    return launches


def phase_f64_symmetric(dev):
    """Phase 7: f64 MINRES and CG on the kernels, 100×100 folded grid."""
    A, rhs = problems.sym_grid_laplacian((100, 100))
    dia = A.to_dia()
    op = spt.PaddedDIA.from_dia(dia, device=dev)
    neg = spt.PaddedDIA.from_dia(DIA(bands=-dia.bands, offsets=dia.offsets,
                                     shape=dia.shape), device=dev)
    b2 = op.pad_vec(torch.as_tensor(rhs, device=dev))
    pd.reset_launch_counts()
    x2, info = spt.minres(op, b2, tol=1e-12, max_iter=5000)
    torch.cuda.synchronize()
    c = launch_counts()
    res = true_residual(A, op.unpad_vec(x2), rhs)
    n = int(info.iterations)
    if not (info.converged and res < 1e-9 and c["dia_dot"] == c["orth_norm"] == n + 1):
        raise AssertionError(f"f64 minres: {info}, true residual {res:.3e}, launches {c}")
    check_halo("f64 minres x", op, x2)
    log("f64_symmetric", solver="minres", grid="100x100", iterations=n,
        recurrence_residual=float(info.residual), true_residual=res,
        K3_launches=c["dia_dot"], K4_launches=c["orth_norm"])
    _, info = spt.cg(op, b2, tol=1e-12, max_iter=5000)
    if int(info.status) != int(spt.Status.BREAKDOWN):
        raise AssertionError(f"f64 cg on a negative-definite matrix: {info}")
    log("f64_symmetric", solver="cg", matrix="A (negative definite)",
        status=spt.Status(int(info.status)).name, iterations=int(info.iterations))
    x2, info = spt.cg(neg, -b2, tol=1e-12, max_iter=5000)
    res = true_residual(A, neg.unpad_vec(x2), rhs)
    if not (info.converged and res < 1e-9):
        raise AssertionError(f"f64 cg on -A: {info}, true residual {res:.3e}")
    check_halo("f64 cg x", neg, x2)
    log("f64_symmetric", solver="cg", matrix="-A", iterations=int(info.iterations),
        recurrence_residual=float(info.residual), true_residual=res)


def phase_nonsymmetric(dev):
    """Phase 8: auto routes the convection-diffusion operator to
    BiCGStab(ℓ=2), which launches K2 2ℓ = 4 times per cycle."""
    A = problems.convection_diffusion3d(GRID, GRID, GRID, peclet=20.0)
    b = np.random.default_rng(SEED + 3).standard_normal(A.shape[0]).astype(np.float32)
    pd.reset_launch_counts()
    t0 = time.perf_counter()
    x, info = spt.solve(A, b, device=dev, method="auto", M="jacobi", tol=1e-4,
                        max_iter=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c, n = launch_counts(), int(info.iterations)
    res = true_residual(A, x, b)
    want = {"dia_spmv": 1, "dia_spmm": 0, "dia_wdot": 4 * n, "dia_dot": 0, "orth_norm": 0,
            "dia_complex_spmv": 0, "dia_complex_dot": 0, "dia_complex_wdot": 0}
    if not (info.converged and res < 1e-3 and c == want):
        raise AssertionError(f"auto on convection-diffusion: {info}, true residual "
                             f"{res:.3e}, launches {c} (expected {want})")
    log("nonsymmetric", entry="solve(method='auto', M='jacobi')", route="bicgstabl(l=2)",
        cycles=n, recurrence_residual=float(info.residual), true_residual=res,
        K2_launches=c["dia_wdot"], wall_s_with_setup=f"{wall:.4f}")


def damped_csr_arrays():
    """(data, indices, indptr) of the damped complex-symmetric Poisson: the
    100³ Poisson's CSR with 0.5i added on the diagonal."""
    A = problems.poisson3d(GRID, GRID, GRID)
    data = A.data.numpy().astype(np.complex64)
    data[A.indices.numpy() == A.row_ids.numpy()] += 0.5j
    return data, A.indices.numpy(), A.indptr.numpy()


def complex_true_residual(csr_arrays, shape, x, b) -> float:
    import scipy.sparse as sps

    data, indices, indptr = csr_arrays
    S = sps.csr_matrix((data.astype(np.complex128), indices, indptr), shape=shape)
    xh = x.detach().cpu().numpy().astype(np.complex128)
    bh = np.asarray(b, np.complex128)
    return float(np.linalg.norm(S @ xh - bh) / np.linalg.norm(bh))


class PlainComplexOperator:
    """A ComplexPaddedDIA's operator protocol through the plain PyTorch
    versions of K5-K7 on the same CUDA tensors: the baseline of phase 9."""

    def __init__(self, op):
        self.op, self.re, self.im = op, op.re, op.im
        self.shape, self.padded_len, self.device = op.shape, op.padded_len, op.device
        self.pad_vec, self.unpad_vec = op.pad_vec, op.unpad_vec
        self.jacobi_precond, self.diagonal_padded = op.jacobi_precond, op.diagonal_padded
        self._args = (op.re.bands, op.im.bands)

    def matvec(self, x2):
        return pd.dia_complex_spmv_plain(*self._args, x2, self.op.offsets, self.op.h)

    def matvec_dot(self, x2):
        return pd.dia_complex_dot_plain(*self._args, x2, self.op.offsets, self.op.h)

    def matvec_conj_dot(self, x2):
        return pd.dia_complex_dot_plain(*self._args, x2, self.op.offsets, self.op.h, True)

    def matvec_wdot(self, x2, w2):
        return pd.dia_complex_wdot_plain(*self._args, x2, None if w2 is x2 else w2, None,
                                         self.op.offsets, self.op.h)

    def matvec_wdot_cprec(self, x2, w2, dinv2):
        return pd.dia_complex_wdot_plain(*self._args, x2, None if w2 is x2 else w2, dinv2,
                                         self.op.offsets, self.op.h)


def idle_share(handle, b, names=("dia_complex",), cpu=True):
    """One prepared solve under torch.profiler: (wall ms, device-busy ms,
    idle share, the device ms of the kernels whose names hold one of
    ``names``: K5-K7 by default). None when the profiler sees no device time
    on this machine. ``cpu=False`` traces the device alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    handle(b)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        handle(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels:
        return None
    ours = sum(e.time_range.elapsed_us() for e in kernels
               if any(k in e.name for k in names)) / 1e3
    return wall, busy, 1.0 - busy / wall, ours


def phase_complex(dev):
    """Phase 9: the complex slice at full width through solve(), prepare(),
    the plain versions and the profiler. Returns each kernel's launch count
    from its own path's solve."""
    arrays = damped_csr_arrays()
    A = CSR.from_arrays(*arrays, shape=(GRID ** 3,) * 2)
    r = np.random.default_rng(SEED + 6).standard_normal(A.shape[0]).astype(np.float32)
    b = (r + 0.25j * r).astype(np.complex64)
    runs = {   # name → (solve kwargs, plain-operator method, kernel of its path)
        "auto": (dict(method="auto", M="jacobi"), "cocg", "dia_complex_spmv"),
        "cs_minres": (dict(method="cs_minres", M="jacobi"), "cs_minres", "dia_complex_dot"),
        "bicgstab": (dict(method="bicgstab", M="jacobi"), "bicgstab", "dia_complex_wdot"),
    }
    launches, its = {}, {}
    for name, (kw, _, kernel) in runs.items():
        pd.reset_launch_counts()
        t0 = time.perf_counter()
        # no device argument: the entry point runs on the card by default
        x, info = spt.solve(A, b, tol=1e-4, max_iter=1000, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, c = int(info.iterations), launch_counts()
        res = complex_true_residual(arrays, A.shape, x, b)
        if not (info.converged and res < 1e-3 and bool(torch.isfinite(x).all())
                and x.shape == (A.shape[0],) and x.dtype == torch.complex64
                and x.device.type == dev.type):
            raise AssertionError(f"complex {name}: {info}, true residual {res:.3e}")
        real = {k: c[k] for k in ("dia_spmv", "dia_spmm", "dia_wdot", "dia_dot", "orth_norm")}
        want = {"auto": (n + 1, 0, 0), "cs_minres": (1, n + 1, 0),
                "bicgstab": (c["dia_complex_spmv"], 0, 2 * n)}[name]
        got = (c["dia_complex_spmv"], c["dia_complex_dot"], c["dia_complex_wdot"])
        if got != want or any(real.values()) or got[0] < 1:
            raise AssertionError(f"complex {name}: launch counts {c}, expected "
                                 f"(K5, K6, K7) = {want} and no K1-K4")
        launches[kernel], its[name] = c[kernel], n
        RUN_COUNTS[f"complex_{name}"] = n
        log("complex", entry=f"solve(method={kw['method']!r}, M='jacobi')",
            route={"auto": "cocg"}.get(name, name), iterations=n,
            recurrence_residual=float(info.residual), true_residual=res,
            K5_launches=got[0], K6_launches=got[1], K7_launches=got[2],
            wall_s_with_setup=f"{wall:.4f}")

    bd = torch.as_tensor(b, device=dev)
    kernel_op = spt.ComplexPaddedDIA.from_dia(damped_dia(), device=dev)
    prepared = spt.optimize(A, device=dev)
    if not all(torch.equal(getattr(prepared, p).bands, getattr(kernel_op, p).bands)
               for p in ("re", "im")):
        raise AssertionError("optimize() and the band-built operator differ")
    for name, (kw, plain_method, _) in runs.items():
        for path, op, method in (("kernels", A, kw["method"]),
                                 ("plain", PlainComplexOperator(kernel_op), plain_method)):
            handle = spt.prepare(op, device=dev, method=method, M="jacobi", tol=1e-4,
                                 max_iter=1000)
            wall, walls, x, info = timed_solves(
                handle, bd, its[name] if path == "kernels" else None, f"{name} {path}")
            n = int(info.iterations)
            res = complex_true_residual(arrays, A.shape, x, b)
            if not res < 1e-3:
                raise AssertionError(f"complex {name} {path}: true residual {res:.3e}")
            log("complex", entry=f"prepare({method}, {path})", iterations=n,
                wall_s_median=f"{wall:.4f}", walls_s=",".join(f"{w:.4f}" for w in walls),
                per_iteration_ms=f"{wall / max(n, 1) * 1e3:.4f}", true_residual=res)
            if path == "kernels":
                prof = idle_share(handle, bd)
                if prof is None:
                    log("complex", entry=f"profile({method})",
                        note="the profiler saw no device time")
                else:
                    log("complex", entry=f"profile({method})", wall_ms=f"{prof[0]:.4f}",
                        device_busy_ms=f"{prof[1]:.4f}", idle_share=f"{prof[2]:.4f}",
                        K5_K7_ms=f"{prof[3]:.4f}",
                        device_us_per_iteration=f"{prof[1] / max(n, 1) * 1e3:.3f}")
    return launches


class CallCounter:
    """Pass every attribute through to ``op``, counting calls of its
    methods by name (which fused form a solver took)."""

    def __init__(self, op):
        self._op, self.calls = op, {}

    def __getattr__(self, name):
        attr = getattr(self._op, name)
        if not callable(attr):
            return attr

        def counted(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            return attr(*args, **kwargs)

        return counted


# the JAX package's counts on these fixtures (CSR path, c128, tol 1e-12, CPU)
C128_JAX_COUNTS = {"minres_hermitian": 2537, "cs_minres": 592, "cocg_jacobi": 37,
                   "bicgstab_jacobi": 21}


def phase_c128(dev):
    """Phase 10: the reference's complex fixtures on the c128 kernels."""
    import scipy.sparse as sps

    H, h_rhs = problems.hermitian_grid((100, 100))
    C, c_rhs, _ = problems.complex_symmetric_grid_with_diag((100, 100))
    xk = np.array([complex(i, j) for i in range(100) for j in range(100)])
    for name, csr, rhs in (("minres_hermitian", H, h_rhs), ("cs_minres", C, c_rhs),
                           ("cocg_jacobi", C, c_rhs), ("bicgstab_jacobi", C, c_rhs)):
        op = spt.ComplexPaddedDIA.from_csr(csr, device=dev)
        counted = CallCounter(op)
        b2 = op.pad_vec(torch.as_tensor(rhs, device=dev))
        solver = {"minres_hermitian": spt.minres, "cs_minres": spt.cs_minres,
                  "cocg_jacobi": spt.cocg, "bicgstab_jacobi": spt.bicgstab}[name]
        M = op.jacobi_precond() if name.endswith("jacobi") else None
        pd.reset_launch_counts()
        x2, info = solver(counted, b2, M=M, tol=1e-12, max_iter=5000)
        torch.cuda.synchronize()
        c, n = launch_counts(), int(info.iterations)
        S = sps.csr_matrix((csr.data.numpy(), csr.indices.numpy(), csr.indptr.numpy()),
                           shape=csr.shape)
        x = op.unpad_vec(x2).cpu().numpy()
        res = float(np.linalg.norm(S @ x - rhs) / np.linalg.norm(rhs))
        err = float(np.abs(x - xk).max())
        if not (info.converged and res < 1e-9):
            raise AssertionError(f"c128 {name}: {info}, true residual {res:.3e}")
        check_halo(f"c128 {name} x", op, x2)
        if name == "minres_hermitian" and (counted.calls.get("matvec_conj_dot")
                                           or counted.calls.get("matvec_dot") != n + 1
                                           or c["dia_complex_dot"] != n + 1):
            raise AssertionError(f"c128 minres: K6 without conjugation expected "
                                 f"{n + 1} times: {counted.calls}, {c}")
        log("c128", fixture=name, grid="100x100", iterations=n,
            jax_iterations=C128_JAX_COUNTS[name], recurrence_residual=float(info.residual),
            true_residual=res, max_err_vs_manufactured=f"{err:.3e}",
            **{f"{k}_launches": v for k, v in c.items() if v},
            calls=",".join(f"{k}:{v}" for k, v in sorted(counted.calls.items())))


# --- phase 11: the preconditioners ------------------------------------------
REAL_KERNELS = ("dia_spmv", "dia_spmm", "dia_dots", "orth_norm")


def expect_counts(what, got, **nonzero):
    """The launch counts of a run must be exactly ``nonzero``, every other
    kernel at 0."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(nonzero)
    if got != want:
        raise AssertionError(f"{what}: launch counts {got}, expected {want}")


def padded_masks(op, colors, dev):
    """The color masks in ``op``'s padded layout. A float copy is padded
    and compared, so the halo and the tail come out False; the masks must
    split the body's rows between them."""
    masks = tuple(op.pad_vec(m.to(torch.float32)) > 0
                  for m in spt.color_masks(colors, device=dev))
    for m in masks:
        check_halo("color mask", op, m)
    if not bool((sum(m.to(torch.int32) for m in masks)[op.h: op.h + op.n] == 1).all()):
        raise AssertionError("the color masks do not split the rows")
    return masks


def log_profile(tag, handle, b, n):
    prof = idle_share(handle, b, names=REAL_KERNELS)
    if prof is None:
        log("preconditioned", entry=f"profile({tag})", note="the profiler saw no device time")
        return
    log("preconditioned", entry=f"profile({tag})", wall_ms=f"{prof[0]:.4f}",
        device_busy_ms=f"{prof[1]:.4f}", idle_share=f"{prof[2]:.4f}",
        hand_kernels_ms=f"{prof[3]:.4f}",
        device_us_per_iteration=f"{prof[1] / max(n, 1) * 1e3:.3f}")


def timed_log(tag, handle, bd, its, A, b):
    """Three timed solves through ``handle`` (``timed_solves``), logged."""
    wall, walls, x, info = timed_solves(handle, bd, its, tag)
    n = int(info.iterations)
    res = true_residual(A, x, b)
    if not res < 1e-3:
        raise AssertionError(f"{tag}: true residual {res:.3e}")
    log("preconditioned", entry=tag, iterations=n, wall_s_median=f"{wall:.4f}",
        walls_s=",".join(f"{w:.4f}" for w in walls),
        per_iteration_ms=f"{wall / max(n, 1) * 1e3:.4f}", true_residual=res)


def phase_config4(dev, jacobi_its):
    """Phase 11 (a): BASELINE config #4, BiCGStab + 2-color Gauss-Seidel on
    the 100³ Poisson, then CG with multicolor SSOR and with Chebyshev.
    Returns K1's launch count of the BiCGStab run."""
    A = problems.poisson3d(GRID, GRID, GRID)
    b = poisson_rhs(A)
    t0 = time.perf_counter()
    colors = spt.greedy_color(A)
    t_color = time.perf_counter() - t0
    if int(colors.max()) + 1 != 2:
        raise AssertionError(f"greedy_color gave {int(colors.max()) + 1} colors, not 2")
    op = spt.PaddedDIA.from_dia(DIA.from_csr(A, device="cpu"), device=dev)
    masks = padded_masks(op, colors, dev)
    diag = op.diagonal_padded()
    M = spt.MaskedGSPrecond(A=op, diag=diag, masks=masks, sweeps=1)
    torch.cuda.synchronize()
    log("preconditioned", precond="MaskedGSPrecond(2 colors, sweeps=1)",
        setup_s=f"{time.perf_counter() - t0:.4f}", greedy_color_s=f"{t_color:.4f}")

    # one apply: K1 once (the first color's update skips its SpMV), against
    # the same apply through the plain K1 on the same tensors
    bd = torch.as_tensor(b, device=dev)
    r2 = op.pad_vec(bd)
    plain = PlainOperator(op)
    M_plain = spt.MaskedGSPrecond(A=plain, diag=diag, masks=masks, sweeps=1)
    pd.reset_launch_counts()
    z = M.matvec(r2)
    torch.cuda.synchronize()
    expect_counts("one forward GS apply", launch_counts(), dia_spmv=1)
    check_halo("GS apply", op, z)
    zp = M_plain.matvec(r2)
    absb = op.bands.to(torch.float32).abs()
    safe = torch.where(diag == 0, torch.ones_like(diag), diag).abs()
    scale = ((r2.abs() + pd.dia_spmv_plain(absb, zp.abs(), op.offsets, op.h)) / safe).max()
    err = check_close("GS apply (K1 against plain)", z, zp, scale, Y_RTOL[torch.float32])
    log("preconditioned", apply="forward GS", K1_launches=1, max_abs_err_vs_plain=err)

    pd.reset_launch_counts()
    t0 = time.perf_counter()
    x2, info = spt.bicgstab(op, r2, M=M, tol=1e-4, max_iter=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c, n = launch_counts(), int(info.iterations)
    res = true_residual(A, op.unpad_vec(x2), b)
    if not (info.converged and res < 1e-3 and bool(torch.isfinite(x2).all())):
        raise AssertionError(f"config #4: {info}, true residual {res:.3e}")
    check_halo("config #4 x", op, x2)
    expect_counts("config #4 bicgstab", c, dia_spmv=1 + 2 * n, dia_wdot=2 * n)
    k1 = c["dia_spmv"]
    log("preconditioned", entry="bicgstab(PaddedDIA, M=MaskedGSPrecond)", iterations=n,
        jacobi_iterations=jacobi_its, recurrence_residual=float(info.residual),
        true_residual=res, K1_launches=k1, K2_launches=c["dia_wdot"],
        wall_s=f"{wall:.4f}")
    handle = spt.prepare(op, method="bicgstab", M=M, tol=1e-4, max_iter=400, device=dev)
    if handle._run.keywords["M"] is not M:
        raise AssertionError("prepare() relayed a preconditioner built on its operator")
    timed_log("prepare(bicgstab, MaskedGS, kernels)", handle, bd, n, A, b)
    log_profile("bicgstab, MaskedGS", handle, bd, n)
    handle = spt.prepare(plain, method="bicgstab", M=M_plain, tol=1e-4, max_iter=400,
                         device=dev)
    timed_log("prepare(bicgstab, MaskedGS, plain)", handle, bd, None, A, b)

    # CG with multicolor SSOR (K1 twice per apply) and with Chebyshev of
    # degree 4 (K1 four times per apply); CG applies M once more than it
    # iterates, and launches K3 once per iteration
    t0 = time.perf_counter()
    M_cheb = spt.ChebyshevPrecond.auto(op, degree=4)
    torch.cuda.synchronize()
    log("preconditioned", precond="ChebyshevPrecond.auto(degree=4)",
        setup_s=f"{time.perf_counter() - t0:.4f}", lmin=M_cheb.lmin, lmax=M_cheb.lmax)
    M_ssor = spt.MaskedGSPrecond(A=op, diag=diag, masks=masks, sweeps=1, omega=1.5,
                                 symmetric=True)
    for tag, Mx, per_apply in (("SSOR omega=1.5", M_ssor, 2), ("Chebyshev", M_cheb, 4)):
        handle = spt.prepare(op, method="cg", M=Mx, tol=1e-4, max_iter=1000, device=dev)
        pd.reset_launch_counts()
        x, info = handle(bd)
        torch.cuda.synchronize()
        c, n = launch_counts(), int(info.iterations)
        res = true_residual(A, x, b)
        if not (info.converged and res < 1e-3):
            raise AssertionError(f"cg + {tag}: {info}, true residual {res:.3e}")
        expect_counts(f"cg + {tag}", c, dia_spmv=1 + per_apply * (n + 1), dia_dot=n)
        log("preconditioned", entry=f"cg(M={tag})", iterations=n, true_residual=res,
            K1_launches=c["dia_spmv"], K3_launches=c["dia_dot"])
        timed_log(f"prepare(cg, {tag}, kernels)", handle, bd, n, A, b)
        log_profile(f"cg, {tag}", handle, bd, n)
    t0 = time.perf_counter()
    spt.BlockJacobiPrecond.from_csr(A, device=dev)
    torch.cuda.synchronize()
    log("preconditioned", precond="BlockJacobiPrecond(block_size=16)", rows=A.shape[0],
        setup_s=f"{time.perf_counter() - t0:.4f}")
    return k1


def phase_relayed(dev):
    """Phase 11 (b): flat preconditioners relayed onto the padded operator
    of the 32³ Poisson (the host factorizations are Python loops)."""
    A = problems.poisson3d(32, 32, 32)
    b = np.random.default_rng(SEED + 7).standard_normal(A.shape[0]).astype(np.float32)
    bd = torch.as_tensor(b, device=dev)
    dia = DIA.from_csr(A, device=dev)
    gs = spt.MaskedGSPrecond(A=dia, diag=dia.diagonal(),
                             masks=spt.color_masks(spt.greedy_color(A), device=dev))
    for method, M in (("bicgstab", "ilu0"), ("bicgstab", "block_jacobi"),
                      ("bicgstab", gs), ("minres", "ic0")):
        name = M if isinstance(M, str) else "MaskedGSPrecond(flat)"
        t0 = time.perf_counter()
        handle = spt.prepare(A, method=method, M=M, tol=1e-4, max_iter=1000, device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        if not isinstance(handle._run.keywords["M"], spt.RelayedPrecond):
            raise AssertionError(f"{name}: the flat preconditioner was not relayed")
        pd.reset_launch_counts()
        t0 = time.perf_counter()
        x, info = handle(bd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c, n = launch_counts(), int(info.iterations)
        res = true_residual(A, x, b)
        if not (info.converged and res < 1e-3):
            raise AssertionError(f"{method} + {name}: {info}, true residual {res:.3e}")
        if method == "bicgstab":
            expect_counts(f"{method} + {name}", c, dia_spmv=1, dia_wdot=2 * n)
        else:
            expect_counts(f"{method} + {name}", c, dia_spmv=1, dia_dot=n + 1)
        log("preconditioned", entry=f"solve(method={method!r}, M={name})", grid="32^3",
            setup_s=f"{setup:.4f}", iterations=n, true_residual=res, wall_s=f"{wall:.4f}",
            **{f"{k}_launches": v for k, v in c.items() if v})


def phase_exact_and_lsqr(dev):
    """Phase 11 (c): the exact sweep on the reference's golden, the
    multicolor sweep against its CPU run, and auto's LSQR route at 2M×1M."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    G = problems.grid_laplacian_dirichlet((10, 10))
    rhs = np.zeros(100)
    problems.set_boundary_condition(rhs, (10, 10), lambda r, c: float(r + c))
    t0 = time.perf_counter()
    x, (its, res) = spt.GaussSeidel.new(G).solve(rhs, max_iter=300, eps=0.0)
    if not (x.is_cuda and its == 296 and res == 0.0):
        raise AssertionError(f"GaussSeidel golden: {its} sweeps, residual {res}")
    log("preconditioned", entry="GaussSeidel(10x10).solve(eps=0)", sweeps=its, residual=res,
        wall_s=f"{time.perf_counter() - t0:.4f}")

    G = problems.grid_laplacian_dirichlet((64, 64))
    rhs = np.zeros(64 * 64)
    problems.set_boundary_condition(rhs, (64, 64), lambda r, c: float(r + c))
    runs = []
    for where in ("cpu", dev):
        C = spt.ColoredELL.from_csr(G.to(where))
        t0 = time.perf_counter()
        xr, info = spt.gauss_seidel_redblack(C, torch.as_tensor(rhs, device=where),
                                             max_iter=20000, eps=1e-8)
        runs.append((xr.cpu(), info, time.perf_counter() - t0))
    (x_c, i_c, t_c), (x_g, i_g, t_g) = runs
    if not (i_c.converged and i_g.converged and i_c.iterations == i_g.iterations):
        raise AssertionError(f"redblack 64x64: cpu {i_c}, gpu {i_g}")
    log("preconditioned", entry="gauss_seidel_redblack(64x64, eps=1e-8)",
        sweeps=i_g.iterations, cpu_sweeps=i_c.iterations,
        max_abs_diff_vs_cpu=float((x_g - x_c).abs().max()), wall_s=f"{t_g:.4f}",
        cpu_wall_s=f"{t_c:.4f}")

    A = problems.poisson3d(GRID, GRID, GRID)
    n = A.shape[0]
    b = poisson_rhs(A)
    ip = A.indptr.numpy()
    stacked = CSR.from_arrays(
        np.concatenate([A.data.numpy(), np.ones(n, np.float32)]),
        np.concatenate([A.indices.numpy(), np.arange(n)]),
        np.concatenate([ip, ip[-1] + 1 + np.arange(n)]), (2 * n, n))
    bs = np.concatenate([b, np.zeros(n, np.float32)])
    t0 = time.perf_counter()
    x, info = spt.solve(stacked, bs, method="auto", tol=1e-5, max_iter=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xd, info_d = spt.lsqr(A.to(dev), torch.as_tensor(b, device=dev), damp=1.0, tol=1e-5,
                          max_iter=500)
    S = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(), ip),
                       shape=A.shape)
    x_ref = spla.lsqr(S, b.astype(np.float64), damp=1.0, atol=1e-10, btol=1e-10)[0]
    rel = lambda u, v: float(np.linalg.norm(u - v) / np.linalg.norm(v))
    e_damp = rel(x.cpu().numpy().astype(np.float64), xd.cpu().numpy().astype(np.float64))
    e_ref = rel(x.cpu().numpy().astype(np.float64), x_ref)
    if not (info.converged and info_d.converged and x.is_cuda and x.shape == (n,)
            and e_damp < 1e-3 and e_ref < 1e-3):
        raise AssertionError(f"lsqr: {info}, damped {info_d}, rel. diffs {e_damp:.3e} "
                             f"{e_ref:.3e}")
    log("preconditioned", entry="solve([A; I], method='auto') -> lsqr", rows=2 * n,
        nnz=stacked.nnz, iterations=int(info.iterations), residual=float(info.residual),
        damped_iterations=int(info_d.iterations), rel_diff_vs_damped=e_damp,
        rel_diff_vs_scipy_f64=e_ref, wall_s_with_setup=f"{wall:.4f}")

# --- phase 12: the layouts ---------------------------------------------------
CHAIN_ROWS = 1 << 20   # the scrambled 1-D chain of phase 12 (c)
SPIKES = 60            # long-range couplings of the spiked Poisson of (b)


def parity_band(its: int) -> int:
    """The count band of tests/test_serial_parity.py:183, max(3, ⌈its/4⌉)."""
    return max(3, -(-its // 4))


def scramble(A: CSR, perm: np.ndarray) -> CSR:
    """B = A[perm, perm] (B[i, j] = A[perm[i], perm[j]]), built on the host;
    B·x[perm] = (A·x)[perm]."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return CSR.from_coo(COO(data=A.data.numpy(), row=inv[A.row_ids.numpy()],
                            col=inv[A.indices.numpy()], shape=A.shape))


def unscramble(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    out = torch.empty_like(x)
    out[torch.as_tensor(perm, device=x.device)] = x
    return out


def layout_name(op) -> str:
    if isinstance(op, Reordered):
        return f"Reordered({layout_name(op.inner)})"
    if isinstance(op, spt.HybridDIA):
        return f"HybridDIA({layout_name(op.core)}+{op.n_outliers}_outliers)"
    if isinstance(op, FlatViewOperator):
        return f"FlatViewOperator({layout_name(op.op)})"
    if isinstance(op, (spt.BSR, spt.ComplexBSR)):
        return f"{type(op).__name__}(bs={op.bs},blocks={op.nblk})"
    if isinstance(op, spt.PaddedDIA):
        return f"PaddedDIA({len(op.offsets)}_diagonals,{str(op.bands.dtype)[6:]})"
    return type(op).__name__


def log_candidates(tag: str, m: CSR) -> None:
    """The cost model's candidates on ``m``'s own pattern under the port's
    table, with their scores (predicted bytes per nnz at the HBM rate)."""
    cands = topt.candidates_of(
        m, None, topt.count_diagonals(m), "", max_diags=32, prefer_kernels=True,
        allow_bsr=True, allow_hybrid=True, wide_diags=192, mem_limit_bytes=4 << 30,
        device="cpu")
    log("layouts", matrix=tag, candidates=",".join(
        f"{label}:{score:.4f}" for score, label, _ in sorted(cands, key=lambda c: c[0])))


def layout_spmv_times(tag, path, call, operands, model_bytes: int, out_bytes: int) -> float:
    """Warm and cold graph-replayed ms of a layout's SpMV, its bytes bound
    (operands read once, the output written once) and the share of 3.35
    TB/s it reaches on the bytes the cost model counts (cold). Returns that
    share."""
    warm = device_ms(lambda: call(*operands))
    cold = cold_device_ms(call, operands)
    least = (nbytes(*operands) + out_bytes) / HBM_BYTES_PER_S * 1e3
    eff = model_bytes / (cold * 1e-3 * HBM_BYTES_PER_S)
    log("layouts", spmv=tag, path=path, ms=f"{warm:.5f}", cold_ms=f"{cold:.5f}", bound_ms=f"{least:.5f}",
        bound_by="bytes", share_of_bound_cold=f"{least / cold:.4f}",
        model_bytes=model_bytes, eff_on_model_bytes=f"{eff:.4f}")
    return eff


def checked(tag, run, A, b, dev):
    """``run(b)`` (a solve() or a prepared handle) on the card with the
    launch counters reset just before: (x, iterations, counts), required to
    converge to a true residual below 1e-3."""
    bd = torch.as_tensor(b, device=dev)
    pd.reset_launch_counts()
    t0 = time.perf_counter()
    x, info = run(bd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c, n = launch_counts(), int(info.iterations)
    res = (complex_true_residual((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                                 A.shape, x, b) if A.dtype.is_complex
           else true_residual(A, x, b))
    if not (info.converged and res < 1e-3 and bool(torch.isfinite(x).all())
            and x.shape == (A.shape[0],)):
        raise AssertionError(f"{tag}: {info}, true residual {res:.3e}")
    log("layouts", entry=tag, iterations=n, recurrence_residual=float(info.residual),
        true_residual=res, wall_s=f"{wall:.4f}",
        **{f"{k}_launches": v for k, v in c.items() if v})
    return x, n, c


def solve_kw(**kw):
    return dict(tol=1e-4, max_iter=1000, **kw)


def phase_layouts_scrambled(dev):
    """Phase 12 (a): the scrambled 100³ Poisson → Reordered(BSR); auto →
    MINRES against the unscrambled solve; the BSR SpMV against torch.mv.
    Returns (the scrambled CSR, the BSR's share on its model bytes)."""
    A = problems.poisson3d(GRID, GRID, GRID)
    n = A.shape[0]
    perm = np.random.default_rng(SEED + 8).permutation(n)
    B = scramble(A, perm)
    b = poisson_rhs(A)
    bp = b[perm]
    ip, ind = B.indptr.numpy(), B.indices.numpy()
    t0 = time.perf_counter()
    sym = native.symmetrize_pattern(n, ip, ind)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.rcm_order(n, *sym)
    t_rcm = time.perf_counter() - t0
    t0 = time.perf_counter()
    Bp, _ = spt.reorder_rcm(B)
    t_reorder = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = spt.optimize(B, device=dev)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    if not (isinstance(op, Reordered) and isinstance(op.inner, spt.BSR)):
        raise AssertionError(f"scrambled Poisson: optimize gave {layout_name(op)}")
    inner = op.inner
    t0 = time.perf_counter()
    spt.BSR.from_csr(Bp, bs=inner.bs, device=dev)
    torch.cuda.synchronize()
    t_bsr = time.perf_counter() - t0
    log("layouts", matrix="scrambled_poisson100", layout=layout_name(op),
        diagonals=topt.count_diagonals(B), diagonals_after_rcm=topt.count_diagonals(Bp),
        optimize_s=f"{t_opt:.4f}", symmetrize_s=f"{t_sym:.4f}", rcm_order_s=f"{t_rcm:.4f}",
        reorder_rcm_s=f"{t_reorder:.4f}", bsr_build_s=f"{t_bsr:.4f}",
        bsr_blocks=inner.nblk, bsr_mbytes=f"{nbytes(inner.blocks) / 1e6:.1f}",
        fill_ratio=f"{inner.fill_ratio:.4f}")

    x_ref, its_ref, _ = checked(
        "solve(poisson100, 'minres')",
        lambda v: spt.solve(A, v, device=dev, **solve_kw(method="minres")), A, b, dev)
    if _auto_method(B) != "minres":
        raise AssertionError("auto does not route the scrambled Poisson to MINRES")
    x, its, c = checked(
        "solve(scrambled, 'auto') -> minres, Reordered(BSR)",
        lambda v: spt.solve(B, v, device=dev, **solve_kw(method="auto")), B, bp, dev)
    expect_counts("auto on Reordered(BSR)", c)   # BSR is torch ops: no hand kernel
    rel = float(torch.linalg.vector_norm(unscramble(x, perm) - x_ref)
                / torch.linalg.vector_norm(x_ref))
    if not (rel < 1e-3 and abs(its - its_ref) <= parity_band(its_ref)):
        raise AssertionError(f"scrambled MINRES: {its} its (unscrambled {its_ref}), "
                             f"x differs by {rel:.3e}")
    log("layouts", check="scrambled x against unscrambled", iterations=its,
        unscrambled_iterations=its_ref, rel_diff=f"{rel:.3e}")
    handle = spt.prepare(op, device=dev, **solve_kw(method="minres"))
    wall, walls, _, _ = timed_solves(handle, torch.as_tensor(bp, device=dev), its,
                                     "prepare(scrambled)")
    log("layouts", entry="prepare(Reordered(BSR), 'minres')", wall_s_median=f"{wall:.4f}",
        walls_s=",".join(f"{w:.4f}" for w in walls),
        per_iteration_ms=f"{wall / its * 1e3:.4f}")

    xf = torch.as_tensor(np.random.default_rng(SEED + 9).standard_normal(n),
                         dtype=torch.float32, device=dev)
    call = lambda blocks, v: dataclasses.replace(inner, blocks=blocks).matvec(v)
    bs = inner.bs
    eff = layout_spmv_times(
        f"BSR(bs={bs}) scrambled_poisson100", "torch ops", call, (inner.blocks, xf),
        inner.nblk * (bs * bs + 2 * bs) * 4, 4 * n)
    library_ms("bsr_scrambled_poisson100", Bp, xf, inner.matvec(xf))
    return B, eff


def spiked_poisson() -> CSR:
    """The 100³ Poisson plus SPIKES symmetric long-range couplings (the
    fixture of tests/test_hybrid.py:74-91 at nx = 100)."""
    A = problems.poisson3d(GRID, GRID, GRID)
    n = A.shape[0]
    rng = np.random.default_rng(SEED)
    r, c = rng.integers(0, n, SPIKES), rng.integers(0, n, SPIKES)
    v = rng.standard_normal(SPIKES).astype(np.float32) * 0.01
    return CSR.from_coo(COO(data=np.concatenate([A.data.numpy(), v, v]),
                            row=np.concatenate([A.row_ids.numpy(), r, c]),
                            col=np.concatenate([A.indices.numpy(), c, r]), shape=A.shape))


def phase_layouts_spiked(dev):
    """Phase 12 (b): the spiked Poisson → HybridDIA with a K1 core;
    BiCGStab + Jacobi (K1 once per SpMV, K2 never) and auto → MINRES; the
    wide torch DIA path and the sidecar timed. Returns (the wide DIA's
    share, the sidecar's elements per second)."""
    S = spiked_poisson()
    n = S.shape[0]
    log_candidates("spiked_poisson100", S)
    t0 = time.perf_counter()
    op = spt.optimize(S, device=dev)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    if not (isinstance(op, spt.HybridDIA) and isinstance(op.core, FlatViewOperator)
            and isinstance(op.core.op, spt.PaddedDIA)):
        raise AssertionError(f"spiked Poisson: optimize gave {layout_name(op)}")
    log("layouts", matrix="spiked_poisson100", layout=layout_name(op),
        diagonals=topt.count_diagonals(S), optimize_s=f"{t_opt:.4f}")
    b = poisson_rhs(S)
    handle = spt.prepare(op, device=dev, **solve_kw(method="bicgstab", M="jacobi"))
    _, its, c = checked("prepare(HybridDIA, 'bicgstab', M='jacobi')", handle, S, b, dev)
    expect_counts("bicgstab on HybridDIA", c, dia_spmv=1 + 2 * its)
    if _auto_method(S) != "minres":
        raise AssertionError("auto does not route the spiked Poisson to MINRES")
    _, its, c = checked(
        "solve(spiked, 'auto') -> minres, HybridDIA",
        lambda v: spt.solve(S, v, device=dev, **solve_kw(method="auto")), S, b, dev)
    expect_counts("minres on HybridDIA", c, dia_spmv=its + 2)

    # the sidecar: this matrix's outliers (warm), and the per-element rate of
    # a 1M-element gather, multiply and index_add_ on sorted rows (cold)
    xf = torch.as_tensor(np.random.default_rng(SEED + 9).standard_normal(n),
                         dtype=torch.float32, device=dev)
    y = torch.zeros(n, device=dev)
    side_ms = device_ms(lambda: y.index_add_(0, op.out_rows, op.out_vals * xf[op.out_cols]))
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = 1 << 20
    rows = torch.sort(torch.randint(0, n, (m,), device=dev, generator=g)).values
    cols = torch.randint(0, n, (m,), device=dev, generator=g)
    vals = torch.randn(m, device=dev, generator=g)
    cold = cold_device_ms(lambda yy, r, cc, v, xx: yy.index_add_(0, r, v * xx[cc]),
                          (torch.zeros(n, device=dev), rows, cols, vals, xf))
    rate = m / (cold * 1e-3)
    log("layouts", sidecar="spiked_poisson100", outliers=op.n_outliers, ms=f"{side_ms:.5f}",
        synthetic_elements=m, synthetic_cold_ms=f"{cold:.5f}",
        elements_per_s=f"{rate:.6e}")

    # the wide DIA candidate on the torch path
    nd = topt.count_diagonals(S)
    dia = DIA.from_csr(S, max_diags=nd, device=dev)
    eff_dia = layout_spmv_times(
        f"DIA({nd} diagonals) spiked_poisson100", "torch ops", lambda bands, v: spmv_dia(
            DIA(bands=bands, offsets=dia.offsets, shape=dia.shape), v),
        (dia.bands, xf), (nd + 2) * n * 4, 4 * n)
    del dia
    return eff_dia, rate


def chain(n: int, symmetric: bool, rng) -> CSR:
    """The [-3, 0, 3] band of tests/test_optimize.py:46-70 at n rows, 8 on
    the diagonal (``symmetric``: the same values at ±3)."""
    lo = rng.standard_normal(n - 3).astype(np.float32)
    hi = lo if symmetric else rng.standard_normal(n - 3).astype(np.float32)
    i = np.arange(n)
    return CSR.from_coo(COO(data=np.concatenate([np.full(n, 8.0, np.float32), lo, hi]),
                            row=np.concatenate([i, i[3:], i[:-3]]),
                            col=np.concatenate([i, i[:-3], i[3:]]), shape=(n, n)))


def phase_layouts_chain(dev):
    """Phase 12 (c): the scrambled chain and its symmetric twin →
    Reordered(PaddedDIA): MINRES on K3 (its + 1) without K4, BiCGStab +
    Jacobi on K1 (1 + 2·its) without K2; K1 timed. Returns K1's share."""
    n = CHAIN_ROWS
    rng = np.random.default_rng(SEED + 10)
    perm = rng.permutation(n)
    runs = {}
    for name, symmetric in (("chain", False), ("chain_twin", True)):
        B = scramble(chain(n, symmetric, rng), perm)
        t0 = time.perf_counter()
        op = spt.optimize(B, device=dev)
        torch.cuda.synchronize()
        if not (isinstance(op, Reordered) and isinstance(op.inner, spt.PaddedDIA)):
            raise AssertionError(f"{name}: optimize gave {layout_name(op)}")
        log("layouts", matrix=f"scrambled_{name}", rows=n, layout=layout_name(op),
            diagonals=topt.count_diagonals(B), optimize_s=f"{time.perf_counter() - t0:.4f}")
        runs[name] = (B, op)
    b = np.random.default_rng(SEED + 11).standard_normal(n).astype(np.float32)
    B, op = runs["chain_twin"]
    handle = spt.prepare(op, device=dev, **solve_kw(method="minres"))
    _, its, c = checked("prepare(scrambled twin, 'minres')", handle, B, b, dev)
    expect_counts("minres on Reordered(PaddedDIA)", c, dia_spmv=1, dia_dot=its + 1)
    B, op = runs["chain"]
    handle = spt.prepare(op, device=dev, **solve_kw(method="bicgstab", M="jacobi"))
    _, its, c = checked("prepare(scrambled chain, 'bicgstab', M='jacobi')", handle, B, b, dev)
    expect_counts("bicgstab on Reordered(PaddedDIA)", c, dia_spmv=1 + 2 * its)
    inner = op.inner
    x2 = inner.pad_vec(torch.as_tensor(b, device=dev))
    return layout_spmv_times(
        f"PaddedDIA({len(inner.offsets)} diagonals) scrambled_chain", "kernel K1",
        lambda bands, v: pd.dia_spmv(bands, v, inner.offsets, inner.h),
        (inner.bands, x2), (len(inner.offsets) + 2) * n * 4, 4 * inner.padded_len)


def phase_layouts_complex(dev):
    """Phase 12 (d): the scrambled damped c64 Poisson → Reordered(ComplexBSR);
    auto with Jacobi → COCG."""
    arrays = damped_csr_arrays()
    A = CSR.from_arrays(*arrays, shape=(GRID ** 3,) * 2)
    perm = np.random.default_rng(SEED + 12).permutation(A.shape[0])
    B = scramble(A, perm)
    t0 = time.perf_counter()
    handle = spt.prepare(B, device=dev, **solve_kw(method="auto", M="jacobi"))
    torch.cuda.synchronize()
    op = handle.operator
    if not (isinstance(op, Reordered) and isinstance(op.inner, spt.ComplexBSR)
            and handle._run.func is spt.cocg):
        raise AssertionError(f"scrambled c64 Poisson: {layout_name(op)} with "
                             f"{handle._run.func.__name__}")
    log("layouts", matrix="scrambled_damped_c64_poisson100", layout=layout_name(op),
        route="cocg", prepare_s=f"{time.perf_counter() - t0:.4f}")
    r = np.random.default_rng(SEED + 6).standard_normal(A.shape[0]).astype(np.float32)
    b = (r + 0.25j * r).astype(np.complex64)[perm]
    _, _, c = checked("prepare(scrambled c64, 'auto', M='jacobi') -> cocg", handle, B, b, dev)
    expect_counts("cocg on Reordered(ComplexBSR)", c)


def phase_layouts_hostkit(dev):
    """Phase 12 (e): the compiled host toolkit at 1M rows: greedy_color, and
    ILU(0)-BiCGStab and IC(0)-MINRES on the 100³ Poisson."""
    A = problems.poisson3d(GRID, GRID, GRID)
    t0 = time.perf_counter()
    colors = spt.greedy_color(A)
    t_color = time.perf_counter() - t0
    small = problems.poisson3d(32, 32, 32)
    sym = native.symmetrize_pattern(small.shape[0], small.indptr.numpy(), small.indices.numpy())
    if not (int(colors.max()) + 1 == 2 and np.array_equal(
            spt.greedy_color(small), native.greedy_color_plain(small.shape[0], *sym))):
        raise AssertionError("greedy_color: not 2 colors, or not the plain version's on 32^3")
    log("layouts", hostkit="greedy_color", rows=A.shape[0], colors=2, seconds=f"{t_color:.4f}")
    b = poisson_rhs(A)
    bd = torch.as_tensor(b, device=dev)
    for method, M in (("bicgstab", "ilu0"), ("minres", "ic0")):
        t0 = time.perf_counter()
        handle = spt.prepare(A, method=method, M=M, tol=1e-4, max_iter=1000, device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        pd.reset_launch_counts()
        x, info = handle(bd)
        torch.cuda.synchronize()
        c, its = launch_counts(), int(info.iterations)
        res = true_residual(A, x, b)
        if not (info.converged and res < 1e-3):
            raise AssertionError(f"{method} + {M} at 1M rows: {info}, true residual {res:.3e}")
        if method == "bicgstab":
            expect_counts(f"{method} + {M}", c, dia_spmv=1, dia_wdot=2 * its)
        else:
            expect_counts(f"{method} + {M}", c, dia_spmv=1, dia_dot=its + 1)
        log("layouts", entry=f"prepare(poisson100, {method!r}, M={M!r})", setup_s=f"{setup:.4f}",
            iterations=its, true_residual=res, **{f"{k}_launches": v for k, v in c.items() if v})


def phase_layouts_measure(dev, B):
    """Phase 12 (f): optimize(measure=True) on the scrambled Poisson with the
    layout cache in a temporary directory; a second call reads the cache and
    times nothing."""
    prev = os.environ.get("SPRSOLVE_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        os.environ["SPRSOLVE_TUNE_CACHE"] = path
        time_step = tuning._time_step
        try:
            t0 = time.perf_counter()
            op = spt.optimize(B, measure=True, device=dev)
            torch.cuda.synchronize()
            t_measure = time.perf_counter() - t0
            with open(path) as f:
                saved = json.load(f)
            (key, ent), = saved.items()

            def no_timing(*args):
                raise AssertionError("a cached layout was timed again")

            tuning._time_step = no_timing
            t0 = time.perf_counter()
            op2 = spt.optimize(B, measure=True, device=dev)
            t_cached = time.perf_counter() - t0
            with open(path) as f:
                if json.load(f) != saved or layout_name(op2) != layout_name(op):
                    raise AssertionError("the second measure=True call did not use the cache")
        finally:
            tuning._time_step = time_step
            if prev is None:
                os.environ.pop("SPRSOLVE_TUNE_CACHE", None)
            else:
                os.environ["SPRSOLVE_TUNE_CACHE"] = prev
    log("layouts", entry="optimize(scrambled, measure=True)", rows=B.shape[0],
        winner=ent["label"],
        layout=layout_name(op), gnnz_s=ent["gnnz_s"], seconds=f"{t_measure:.4f}",
        cached_seconds=f"{t_cached:.4f}", key=key)


def phase_layouts_ell(dev):
    """Phase 12 (g): every route off, a uniform random pattern → ELL with a
    RuntimeWarning."""
    import scipy.sparse as sps

    n, k = 100_000, 8
    rng = np.random.default_rng(SEED + 13)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    m = CSR.from_coo(COO(data=rng.standard_normal(n * k).astype(np.float32), row=rows,
                         col=cols, shape=(n, n)))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        op = spt.optimize(m, allow_reorder=False, wide_diags=0, allow_bsr=False,
                          allow_hybrid=False, device=dev)
    if not (isinstance(op, spt.ELL) and any(issubclass(w.category, RuntimeWarning)
                                            for w in rec)):
        raise AssertionError(f"ELL fallback: {layout_name(op)}, warnings {rec}")
    x = rng.standard_normal(n).astype(np.float32)
    S = sps.csr_matrix((m.data.numpy().astype(np.float64), m.indices.numpy(),
                        m.indptr.numpy()), shape=m.shape)
    want = S @ x.astype(np.float64)
    err = float(np.abs(op.matvec(torch.as_tensor(x, device=dev)).cpu().numpy() - want).max())
    if not err <= 1e-5 * float(np.abs(want).max()):
        raise AssertionError(f"ELL matvec off by {err:.3e}")
    log("layouts", matrix="uniform_random_100k", layout="ELL", warned=True,
        max_abs_err=f"{err:.3e}")


MEASURE_GRID = 50   # phase 12 (f)'s scrambled Poisson


def phase_layouts(dev):
    """Phase 12: every layout of optimize() at 1M rows ((f) on the
    MEASURE_GRID³ scrambled Poisson: its two host analyses of the 1M-row
    one took 48-84 s on the card's machine, which the script's time limit
    no longer has room for), and the H100 constants of its cost model."""
    t0 = time.perf_counter()
    _, eff_bsr = phase_layouts_scrambled(dev)
    eff_dia, rate = phase_layouts_spiked(dev)
    eff_padded = phase_layouts_chain(dev)
    phase_layouts_complex(dev)
    phase_layouts_hostkit(dev)
    A_m = problems.poisson3d(MEASURE_GRID, MEASURE_GRID, MEASURE_GRID)
    phase_layouts_measure(dev, scramble(A_m, np.random.default_rng(SEED + 8).permutation(
        A_m.shape[0])))
    phase_layouts_ell(dev)
    log("layouts", constants=json.dumps({
        "eff_dia": round(eff_dia, 4), "eff_bsr": round(eff_bsr, 4),
        "eff_padded_dia": round(eff_padded, 4),
        "scatter_bytes_eq": round(HBM_BYTES_PER_S / rate, 2)}),
        sidecar_elements_per_s=f"{rate:.6e}", table_in_code=json.dumps(topt.COSTS),
        seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 13: the rest of the Krylov family ---------------------------------
# the JAX package's counts at 1M rows (f32, tol 1e-4, CPU), which the port's
# counts must lie within parity_band of (IDR(s) excepted: its shadow space is
# another draw)
KRYLOV_JAX_COUNTS = {"gmres": 161, "cgs": 106, "tfqmr": 111, "ca_bicgstab": 98,
                     "cg_single_sync": 193, "ca_cg": 194, "cg_mg": 11, "cg_amg": 195,
                     "fgmres_inner": 24}
RESTART = 32
# the full run holds every phase 13 solve to convergence below its residual
# bound; the card's tests at 32³, where the f32 CGS and TFQMR recurrences
# drift from the true residual in the JAX package too (6.4e-3 at tol 1e-4),
# check the launch counts alone
STRICT = True


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def gmres_k1(its: int) -> int:
    """K1 (or K5) of restarted GMRES: one SpMV per step, one per cycle for
    its true residual, one for r₀; a cycle runs ``RESTART`` steps unless
    the solve ends in it."""
    return its + -(-its // RESTART) + 1


def cg_counts(op, its: int) -> dict:
    """CG's launches on ``op``: on a PaddedDIA K1 once (r₀) and K3 per
    iteration; on a HybridDIA (a PaddedDIA core behind FlatViewOperator) K1
    once per SpMV, r₀'s included; none on a layout of torch ops (BSR)."""
    if isinstance(op, spt.PaddedDIA):
        return {"dia_spmv": 1, "dia_dot": its}
    if isinstance(op, spt.HybridDIA) and isinstance(op.core, FlatViewOperator):
        return {"dia_spmv": its + 1}
    return {}


def run_counted(run, dev):
    """``run()`` with the launch counters reset just before: (result, the
    counts, wall seconds)."""
    pd.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    _sync(dev)
    return out, launch_counts(), time.perf_counter() - t0


def krylov_check(tag, out, counts, want, res, res_max, jax_key=None, check_band=True,
                 **extra):
    """Raise unless the solve converged below ``res_max`` with exactly the
    ``want`` launch counts (every kernel not named at 0), and within the
    band of the JAX package's count where ``jax_key`` names one."""
    x, info = out[:2]
    n = int(info.iterations)
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(want)
    if not bool(torch.isfinite(x).all()) or (
            STRICT and not (info.converged and res < res_max)):
        raise AssertionError(f"{tag}: {info}, true residual {res:.3e}")
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {expect}")
    if check_band and jax_key is not None:
        its_j = KRYLOV_JAX_COUNTS[jax_key]
        if abs(n - its_j) > parity_band(its_j):
            raise AssertionError(f"{tag}: {n} iterations, the JAX package's {its_j}")
    log("krylov", entry=tag, iterations=n, status=spt.Status(int(info.status)).name,
        true_residual=res,
        **{f"{k}_launches": v for k, v in counts.items() if v}, **extra)
    return n


def krylov_times(tag, run, dev, its=None):
    """One timed call of ``run`` (a prepared handle's call) after the
    checked one, converged in ``its`` iterations where given (None where
    the sums are not fixed-order: BSR's ``index_add_`` atomics move the
    count by one from run to run): its wall, logged."""
    _sync(dev)
    t0 = time.perf_counter()
    info = run()[1]
    _sync(dev)
    wall = time.perf_counter() - t0
    n = int(info.iterations)
    if not info.converged or (its is not None and n != its):
        raise AssertionError(f"{tag}: {info} (expected {its} iterations)")
    log("krylov", entry=f"timed({tag})", wall_s=f"{wall:.4f}", iterations=n,
        per_iteration_ms=f"{wall / max(n, 1) * 1e3:.4f}")
    return wall


def krylov_profile(tag, run, n):
    """One profiled call of ``run``: device busy ms, idle share, device µs
    per iteration."""
    prof = idle_share(lambda _: run(), None, names=REAL_KERNELS + ("dia_complex",))
    if prof is None:
        log("krylov", entry=f"profile({tag})", note="the profiler saw no device time")
        return
    log("krylov", entry=f"profile({tag})", wall_ms=f"{prof[0]:.4f}",
        device_busy_ms=f"{prof[1]:.4f}", idle_share=f"{prof[2]:.4f}",
        hand_kernels_ms=f"{prof[3]:.4f}",
        device_us_per_iteration=f"{prof[1] / max(n, 1) * 1e3:.3f}")


def phase_krylov_nonsym(dev, grid=GRID, timed=True):
    """Phase 13 (a): phase 8's convection-diffusion system with Jacobi:
    GMRES through solve() and the GMRES handle, IDR(s), CGS, TFQMR on K1,
    and the s-step BiCGStab on the unpadded DIA (no kernel)."""
    A = problems.convection_diffusion3d(grid, grid, grid, peclet=20.0)
    b = np.random.default_rng(SEED + 3).standard_normal(A.shape[0]).astype(np.float32)
    bd = torch.as_tensor(b, device=dev)
    full = grid == GRID
    kw = dict(tol=1e-4, max_iter=1000)
    op = spt.optimize(A, device=dev)
    cases = {   # tag → (solve kwargs, K1 from the count, the JAX count's key)
        "gmres": (dict(method="gmres", M="jacobi", restart=RESTART), gmres_k1, "gmres"),
        "idrs": (dict(method="idrs", M="jacobi", s=4), lambda n: n, None),
        "cgs": (dict(method="cgs", M="jacobi"), lambda n: 1 + 2 * n, "cgs"),
        "tfqmr": (dict(method="tfqmr", M="jacobi"), lambda n: 3 + 2 * n, "tfqmr"),
        "ca_bicgstab": (dict(method="ca_bicgstab"), lambda n: 0, "ca_bicgstab"),
    }
    its = {}
    for tag, (skw, k1, jkey) in cases.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # IDR(s)'s stream warning
            out, c, wall = run_counted(lambda: spt.solve(A, b, device=dev, **kw, **skw), dev)
            res = true_residual(A, out[0], b)
            n = int(out[1].iterations)
            its[tag] = krylov_check(f"solve({tag})", out, c, {"dia_spmv": k1(n)} if k1(n) else {},
                                    res, 1e-3, jkey, full, wall_s_with_setup=f"{wall:.4f}")
            handle = spt.prepare(A, device=dev, **kw, **skw)
            if tag == "ca_bicgstab" and not isinstance(handle.operator, DIA):
                raise AssertionError(f"ca_bicgstab runs on {layout_name(handle.operator)}")
            if timed:
                krylov_times(tag, lambda: handle(bd), dev, its[tag])
                if tag in ("gmres", "idrs"):
                    krylov_profile(tag, lambda: handle(bd), its[tag])
    # the GMRES handle on the padded operator: the same solve
    h = spt.GMRES.new(op, A.shape[0], restart=RESTART, device=dev)
    out, c, _ = run_counted(lambda: h.precond_solve(op.jacobi_precond(), op.pad_vec(bd),
                                                    max_iter=1000, tol=1e-4), dev)
    x = op.unpad_vec(out[0])
    n = out[1][0]
    if n != its["gmres"] or c != {**dict.fromkeys(KERNELS, 0), "dia_spmv": gmres_k1(n)}:
        raise AssertionError(f"GMRES handle: {n} iterations, counts {c}")
    log("krylov", entry="GMRES.new(op).precond_solve", iterations=n,
        true_residual=true_residual(A, x, b), K1_launches=c["dia_spmv"])
    return its


def phase_krylov_spd(dev, grid=GRID, timed=True):
    """Phase 13 (b): phase 4's Poisson: single-sync CG (K1 once per
    iteration, K3 never), the s-step CG with the Jacobi fold (no kernel),
    block CG on 8 columns (one K1b per iteration: the block is one launch)
    and batched BiCGStab on 4 of them (each column as its single solve)."""
    A = problems.poisson3d(grid, grid, grid)
    n = A.shape[0]
    b = poisson_rhs(A)
    bd = torch.as_tensor(b, device=dev)
    full = grid == GRID
    kw = dict(tol=1e-4, max_iter=1000)
    for tag, skw, k1 in (("cg_single_sync", dict(method="cg_single_sync", M="jacobi"),
                          lambda m: m + 2),
                         ("ca_cg", dict(method="ca_cg", M="jacobi"), lambda m: 0)):
        out, c, wall = run_counted(lambda: spt.solve(A, b, device=dev, **kw, **skw), dev)
        m = int(out[1].iterations)
        its = krylov_check(f"solve({tag})", out, c, {"dia_spmv": k1(m)} if k1(m) else {},
                           true_residual(A, out[0], b), 1e-3, tag, full,
                           wall_s_with_setup=f"{wall:.4f}")
        if timed:
            handle = spt.prepare(A, device=dev, **kw, **skw)
            krylov_times(tag, lambda: handle(bd), dev, its)

    op = spt.optimize(A, device=dev)
    B = np.random.default_rng(SEED + 4).standard_normal((n, 8)).astype(np.float32)
    B2 = torch.stack([op.pad_vec(torch.as_tensor(B[:, j], device=dev)) for j in range(8)], 1)
    run = lambda: spt.block_cg(op, B2, **kw)
    out, c, wall = run_counted(run, dev)
    X2, info = out
    m = int(info.iterations)
    res = max(true_residual(A, op.unpad_vec(X2[:, j]), B[:, j]) for j in range(8))
    krylov_check("block_cg(8 columns)", out, c, {"dia_spmm": m + 1}, res, 1e-3,
                 wall_s=f"{wall:.4f}")
    if timed:
        krylov_times("block_cg", run, dev, m)

    M = op.jacobi_precond()
    B4 = B2[:, :4].contiguous()
    run = lambda: spt.batched(spt.bicgstab)(op, B4, M=M, **kw)
    out, c, wall = run_counted(run, dev)
    X4, info = out
    per = [int(i) for i in info.iterations.tolist()]
    for j in range(4):
        x1, i1 = spt.bicgstab(op, B4[:, j].contiguous(), M=M, **kw)
        if int(i1.iterations) != per[j] or not torch.equal(x1, X4[:, j]):
            raise AssertionError(f"batched column {j}: {per[j]} iterations, single "
                                 f"{int(i1.iterations)}")
        res = true_residual(A, op.unpad_vec(X4[:, j]), B[:, j])
        if not (int(info.status[j]) == 0 and res < 1e-3):
            raise AssertionError(f"batched column {j}: status {int(info.status[j])}, "
                                 f"true residual {res:.3e}")
    want = {**dict.fromkeys(KERNELS, 0), "dia_spmv": 4, "dia_wdot": 2 * sum(per)}
    if c != want:
        raise AssertionError(f"batched(bicgstab): launch counts {c}, expected {want}")
    log("krylov", entry="batched(bicgstab, 4 columns)", iterations=",".join(map(str, per)),
        K1_launches=c["dia_spmv"], K2_launches=c["dia_wdot"], wall_s=f"{wall:.4f}")


def phase_krylov_mg(dev, grid=GRID, timed=True):
    """Phase 13 (c): CG with the geometric V-cycle relayed onto the
    PaddedDIA (K1 once, K3 per iteration; the levels on torch DIA), then
    M="amg" (RCM, a 1-D hierarchy; the reordered Poisson's layout decides
    the kernels). Prints the set-up seconds of both."""
    A = problems.poisson3d(grid, grid, grid)
    b = poisson_rhs(A)
    bd = torch.as_tensor(b, device=dev)
    full = grid == GRID
    kw = dict(method="cg", tol=1e-4, max_iter=1000)
    t0 = time.perf_counter()
    mg = spt.GridMGPrecond.from_csr(A, (grid, grid, grid), device=dev)
    setup = time.perf_counter() - t0
    if not all(isinstance(o, DIA) for o in mg.ops):
        raise AssertionError("a V-cycle level is not on torch DIA")
    handle = spt.prepare(A, M=mg, device=dev, **kw)
    if not isinstance(handle._run.keywords["M"], spt.RelayedPrecond):
        raise AssertionError("the V-cycle is not relayed onto the padded operator")
    out, c, wall = run_counted(lambda: handle(bd), dev)
    its = krylov_check("prepare(cg, M=GridMGPrecond)", out, c,
                       {"dia_spmv": 1, "dia_dot": int(out[1].iterations)},
                       true_residual(A, out[0], b), 1e-3, "cg_mg", full,
                       levels=len(mg.ops), setup_s=f"{setup:.4f}")
    if timed:
        krylov_times("cg_mg", lambda: handle(bd), dev, its)

    t0 = time.perf_counter()
    handle = spt.prepare(A, M="amg", device=dev, **kw)
    setup = time.perf_counter() - t0
    inner = handle.operator.inner
    out, c, wall = run_counted(lambda: handle(bd), dev)
    m = int(out[1].iterations)
    want = cg_counts(inner, m)
    its = krylov_check("prepare(cg, M='amg')", out, c, want, true_residual(A, out[0], b),
                       1e-3, "cg_amg", full, layout=layout_name(handle.operator),
                       setup_s=f"{setup:.4f}")
    if timed:
        krylov_times("cg_amg", lambda: handle(bd), dev)


def phase_krylov_inner(dev, grid=GRID, timed=True):
    """Phase 13 (d, e): FGMRES with an inner CG of 8 steps on the padded
    Poisson, through prepare() (M.A is op: no relay; K3 inside each apply),
    then plain GMRES with the same M, whose outcome is printed only."""
    A = problems.poisson3d(grid, grid, grid)
    b = poisson_rhs(A)
    bd = torch.as_tensor(b, device=dev)
    op = spt.optimize(A, device=dev)
    M = spt.InnerSolvePrecond(A=op, method="cg", iters=8)
    handle = spt.prepare(op, method="fgmres", M=M, tol=1e-4, max_iter=200, device=dev)
    if handle._run.keywords["M"] is not M:
        raise AssertionError("the inner-solve M was relayed")
    out, c, wall = run_counted(lambda: handle(bd), dev)
    m = int(out[1].iterations)
    # per step: the inner CG's r₀ (K1) and 8 fused dots (K3), then A·z (K1);
    # per cycle its true residual (K1); r₀ once
    want = {"dia_spmv": 2 * m + -(-m // RESTART) + 1, "dia_dot": 8 * m}
    its = krylov_check("prepare(op, fgmres, M=InnerSolvePrecond(cg, 8))", out, c, want,
                       true_residual(A, out[0], b), 1e-3, "fgmres_inner",
                       grid == GRID, wall_s=f"{wall:.4f}")
    if timed:
        krylov_times("fgmres_inner", lambda: handle(bd), dev, its)
    plain = spt.prepare(op, method="gmres", M=M, tol=1e-4, max_iter=100, device=dev)
    x, info = plain(bd)
    _sync(dev)
    log("krylov", entry="prepare(op, gmres, M=InnerSolvePrecond(cg, 8))",
        status=spt.Status(int(info.status)).name, iterations=int(info.iterations),
        reported_residual=float(info.residual),
        true_residual=true_residual(A, x, b),
        note="plain GMRES with a nonlinear M: printed, not asserted")


def phase_krylov_complex(dev, grid=GRID, timed=True):
    """Phase 13 (f): GMRES with the complex Jacobi on phase 9's damped c64
    Poisson: K5 per SpMV."""
    P = problems.poisson3d(grid, grid, grid)
    data = P.data.numpy().astype(np.complex64)
    data[P.indices.numpy() == P.row_ids.numpy()] += 0.5j
    arrays = (data, P.indices.numpy(), P.indptr.numpy())
    A = CSR.from_arrays(*arrays, shape=P.shape)
    r = np.random.default_rng(SEED + 6).standard_normal(A.shape[0]).astype(np.float32)
    b = (r + 0.25j * r).astype(np.complex64)
    kw = dict(method="gmres", M="jacobi", restart=RESTART, tol=1e-4, max_iter=1000)
    out, c, wall = run_counted(lambda: spt.solve(A, b, device=dev, **kw), dev)
    m = int(out[1].iterations)
    its = krylov_check("solve(c64, gmres, M='jacobi')", out, c,
                       {"dia_complex_spmv": gmres_k1(m)},
                       complex_true_residual(arrays, A.shape, out[0], b), 1e-3,
                       wall_s_with_setup=f"{wall:.4f}")
    if timed:
        handle = spt.prepare(A, device=dev, **kw)
        bd = torch.as_tensor(b, device=dev)
        krylov_times("gmres_c64", lambda: handle(bd), dev, its)


def _recording(solver, its):
    """``solver`` that appends each solve's iteration count to ``its``."""
    def run(A, b, **kw):
        x, info = solver(A, b, **kw)
        its.append(int(info.iterations))
        return x, info
    return run


def _planes_to_complex(out):
    xr, xi, info = out
    return torch.complex(xr, xi), info


def phase_refine(dev, grid=GRID, timed=True):
    """Phase 13 (g): refinement to f64 (c128) accuracy from f32 (c64) inner
    solves on the kernels: BiCGStab + Jacobi (K1 once and K2 twice per
    inner iteration), MINRES (K1 once, K3 and K4 its + 1 per inner solve);
    on the c128 damped Poisson CS-MINRES with 1/|d| (K5 once, K6 its + 1)
    and BiCGStab with the complex Jacobi (K5 once, K7 twice per iteration).
    refine() runs with an inner solver that records its counts;
    refine_solve() builds the same operators and must give the same x."""
    from sprsolve_tpu_torch.solvers.refine import refine, refine_complex

    A = problems.poisson3d(grid, grid, grid, dtype=np.float64)
    n = A.shape[0]
    b = np.random.default_rng(SEED + 2).standard_normal(n)
    bd = torch.as_tensor(b, device=dev)
    t0 = time.perf_counter()
    A64 = DIA.from_csr(A, device=dev)
    A32 = spt.optimize(CSR.from_arrays(A.data.numpy().astype(np.float32), A.indices,
                                       A.indptr, A.shape), device=dev)
    setup = time.perf_counter() - t0
    for inner, M, per_solve in (
            ("bicgstab", A32.jacobi_precond(), lambda k: {"dia_spmv": 1, "dia_wdot": 2 * k}),
            ("minres", None, lambda k: {"dia_spmv": 1, "dia_dot": k + 1, "orth_norm": k + 1})):
        inner_its = []
        fn = _recording(getattr(spt, inner), inner_its)
        run = lambda: refine(A64, A32, bd, inner=fn, M=M, tol=1e-12)
        out, c, wall = run_counted(run, dev)
        want = {}
        for k in inner_its:
            for key, v in per_solve(k).items():
                want[key] = want.get(key, 0) + v
        outer = krylov_check(f"refine(f64, inner={inner})", out, c, want,
                             true_residual(A, out[0], b), 1e-11,
                             inner_iterations=",".join(map(str, inner_its)),
                             setup_s=f"{setup:.4f}")
        n_inner = sum(inner_its)    # of this one solve: later runs append
        x2, info2 = spt.refine_solve(A, b, inner=inner, M=None if M is None else "jacobi",
                                     tol=1e-12, device=dev)
        if int(info2.iterations) != outer or not torch.equal(x2, out[0]):
            raise AssertionError(f"refine_solve(inner={inner}) differs from refine()")
        if timed:
            krylov_times(f"refine_{inner}", run, dev, outer)
            if inner == "bicgstab":
                krylov_profile("refine_bicgstab", run, n_inner)

    P = problems.poisson3d(grid, grid, grid)
    data = P.data.numpy().astype(np.complex128)
    data[P.indices.numpy() == P.row_ids.numpy()] += 0.5j
    arrays = (data, P.indices.numpy(), P.indptr.numpy())
    Z = CSR.from_arrays(*arrays, shape=P.shape)
    r = np.random.default_rng(SEED + 6).standard_normal(n)
    bz = r + 0.25j * r
    bzd = torch.as_tensor(bz, device=dev)
    Z64 = DIA.from_csr(Z, device=dev)
    Z32 = spt.optimize(CSR.from_arrays(data.astype(np.complex64), P.indices, P.indptr,
                                       P.shape), device=dev)
    if not isinstance(Z32, spt.ComplexPaddedDIA):
        raise AssertionError(f"the c64 inner operator is {layout_name(Z32)}")
    for inner, M, per_solve in (
            ("cs_minres", spt.real_abs_jacobi(Z32),
             lambda k: {"dia_complex_spmv": 1, "dia_complex_dot": k + 1}),
            ("bicgstab", Z32.jacobi_precond(),
             lambda k: {"dia_complex_spmv": 1, "dia_complex_wdot": 2 * k})):
        inner_its = []
        fn = _recording(getattr(spt, inner), inner_its)
        run = lambda: _planes_to_complex(refine_complex(
            Z64, Z32, bzd.real, bzd.imag, inner=fn, M=M, tol=1e-12, inner_max_iter=400))
        out, c, wall = run_counted(run, dev)
        want = {}
        for k in inner_its:
            for key, v in per_solve(k).items():
                want[key] = want.get(key, 0) + v
        outer = krylov_check(f"refine(c128, inner={inner})", out, c, want,
                             complex_true_residual(arrays, Z.shape, out[0], bz), 1e-10,
                             inner_iterations=",".join(map(str, inner_its)))
        x2, info2 = spt.refine_solve(Z, bz, inner=inner, M="jacobi", tol=1e-12, device=dev)
        if int(info2.iterations) != outer or not torch.equal(x2, out[0]):
            raise AssertionError(f"refine_solve(c128, inner={inner}) differs")
        if timed:
            krylov_times(f"refine_c128_{inner}", run, dev, outer)


def phase_krylov(dev, grid=GRID, timed=True):
    """Phase 13: the rest of the Krylov family, multigrid, the inner-solve
    preconditioner and mixed-precision refinement at 1M rows."""
    t0 = time.perf_counter()
    phase_krylov_nonsym(dev, grid, timed)
    phase_krylov_spd(dev, grid, timed)
    phase_krylov_mg(dev, grid, timed)
    phase_krylov_inner(dev, grid, timed)
    phase_krylov_complex(dev, grid, timed)
    phase_refine(dev, grid, timed)
    log("krylov", seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 14: the eigensolvers ----------------------------------------------
EIGS_K = 4             # pairs wanted (bench.py:860-1000)
EIGS_TOL = 5e-4
SI_GRID = 64           # shift-invert's Poisson (bench.py:916): phase 17 (b)
SI_MAX_ITER = 60
SI_INNER_MAX_ITER = 600
RF_GRID = 32           # the rational filter's Poisson (bench.py:977): phase 17 (c)
RF_INNER_MAX_ITER = 3000
RF_NODES = 4
RF_REFINE = 1
SIGMA = 1.0
SHIFT = 0.01           # ShiftedOperator's σ in (d)
eigs_mod = importlib.import_module("sprsolve_tpu_torch.solvers.eigs")
rat_mod = importlib.import_module("sprsolve_tpu_torch.solvers.rational")


def entry_kw(dev) -> dict:
    """The entry points' device argument: none on the card (they run there
    by default), ``device`` elsewhere."""
    return {} if torch.device(dev).type == "cuda" else {"device": dev}


def poisson_eigs(grid: int) -> np.ndarray:
    """Every eigenvalue of the grid³ 7-point Poisson, with multiplicity:
    sums over the three axes of 2 − 2·cos(πj/(grid + 1)), j = 1..grid."""
    e = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, grid + 1) / (grid + 1))
    return (e[:, None, None] + e[None, :, None] + e[None, None, :]).ravel()


def poisson_eigs_nearest(grid: int, sigma: float, k: int) -> np.ndarray:
    """The k eigenvalues of the grid³ Poisson nearest σ, ascending."""
    lam = poisson_eigs(grid)
    return np.sort(lam[np.argsort(np.abs(lam - sigma), kind="stable")[:k]])


def match_nearest(got, grid: int, sigma: float, tol: float) -> tuple:
    """Whether the returned λ are the analytic eigenvalues nearest σ
    within tol·|λ|: ``(ok, exact)``. ``exact``: the sorted λ within
    tol·|λ| of the k nearest counted with multiplicity. ``ok``: each λ
    within tol·|λ| of its own analytic eigenvalue (one per λ, as far as
    the multiplicities go) at a distance from σ at most the k-th nearest's
    plus tol·max|λ| — the k nearest up to the tolerance, which is all a
    tol-level answer can tell apart where two eigenvalues' distances to σ
    differ by less than tol·|λ| (at 64³: 0.998321 and 1.001746, each
    6-fold, 7e-5 apart in distance)."""
    got = np.sort(np.asarray(got, np.float64))
    k = got.size
    lam = poisson_eigs(grid)
    dist = np.abs(lam - sigma)
    order = np.argsort(dist, kind="stable")
    exact = k > 0 and bool(np.all(np.abs(got - np.sort(lam[order[:k]])) <= tol * np.abs(got)))
    if k == 0:
        return False, False
    reach = dist[order[k - 1]] + tol * float(np.abs(got).max())
    cand = sorted(lam[dist <= reach].tolist())
    for v in got:   # injective: each analytic eigenvalue (with multiplicity) once
        j = min(range(len(cand)), key=lambda i: abs(cand[i] - v), default=None)
        if j is None or abs(cand[j] - v) > tol * abs(v):
            return False, exact
        cand.pop(j)
    return True, exact


def pair_residuals(A, lam, X) -> np.ndarray:
    """‖A·xᵢ − λᵢ·xᵢ‖/‖xᵢ‖ per pair, scipy f64 on the CSR."""
    import scipy.sparse as sps

    S = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(),
                        A.indptr.numpy()), shape=A.shape)
    Xh = X.detach().cpu().numpy().astype(np.float64)
    lh = lam.detach().cpu().numpy().astype(np.float64)
    return np.linalg.norm(S @ Xh - Xh * lh[None, :], axis=0) / np.linalg.norm(Xh, axis=0)


def recorded(module, name, steps):
    """``module.name`` (a lockstep block solve) replaced by one that
    appends each solve's lockstep iterations to ``steps``; returns the
    original, to be put back."""
    orig = getattr(module, name)

    def run(*args, **kwargs):
        X, info, n = orig(*args, **kwargs)
        steps.append(n)
        return X, info, n

    setattr(module, name, run)
    return orig


def eig_check(tag, info, counts, want, **extra):
    """Raise unless the counts are exactly ``want`` (every kernel not named
    at 0) and, under STRICT, the solve is CONVERGED."""
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(want)
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {expect}")
    if STRICT and int(info.status) != int(spt.Status.CONVERGED):
        raise AssertionError(f"{tag}: {info}")
    log("eigen", entry=tag, status=spt.Status(int(info.status)).name,
        iterations=int(info.iterations), residual=f"{float(info.residual):.4e}",
        **{f"{k}_launches": v for k, v in counts.items() if v}, **extra)


def eig_timed(tag, run, dev, steps: int, unit: str):
    """One timed call of ``run`` after the checked one: wall seconds and ms
    per ``unit``."""
    _sync(dev)
    t0 = time.perf_counter()
    run()
    _sync(dev)
    wall = time.perf_counter() - t0
    log("eigen", entry=f"timed({tag})", wall_s=f"{wall:.4f}",
        **{f"ms_per_{unit}": f"{wall / max(steps, 1) * 1e3:.4f}"})
    return wall


def eig_warm_up(A, dev, warm) -> float:
    """Before a long eigen run, which is then the timed one: ``warm()``,
    the same entry point on a budget of one step (every code path, each
    library's first call), and the set-up seconds of ``optimize()`` on A,
    which the timed run's wall includes."""
    warm()
    _sync(dev)
    t0 = time.perf_counter()
    spt.optimize(A, **entry_kw(dev))
    _sync(dev)
    return time.perf_counter() - t0


def phase_eigen_lobpcg(dev, grid=GRID, timed=True):
    """Phase 14 (a): LOBPCG on the Poisson with the geometric V-cycle as M,
    A the PaddedDIA of optimize(): K1b once per iteration plus once; λ₀
    within tol of 3·(2·sin(π/(2(grid + 1))))², the worst measured residual
    ‖A·x − λx‖/(|λ| + max|λ|) within tol. Then the unpreconditioned run
    (gap-limited), printed."""
    A = problems.poisson3d(grid, grid, grid)
    n = A.shape[0]
    t0 = time.perf_counter()
    op = spt.optimize(A, **entry_kw(dev))
    M = spt.GridMGPrecond.from_csr(A, (grid,) * 3, **entry_kw(dev))
    setup = time.perf_counter() - t0
    X0 = np.random.default_rng(SEED + 10).standard_normal((n, EIGS_K)).astype(np.float32)
    run = lambda: spt.lobpcg(op, X0, M=M, tol=EIGS_TOL, max_iter=60)
    (lam, X, info), c, wall = run_counted(run, dev)
    its = int(info.iterations)
    l1 = 3 * (2 * np.sin(np.pi / (2 * (grid + 1)))) ** 2
    res = pair_residuals(A, lam, X) / (lam.abs().cpu().numpy() + float(lam.abs().max()))
    if STRICT and not (abs(float(lam[0]) - l1) <= EIGS_TOL * l1 and res.max() <= EIGS_TOL):
        raise AssertionError(f"lobpcg: λ₀ {float(lam[0])} against {l1}, residuals {res}")
    eig_check("lobpcg(M=GridMG)", info, c, {"dia_spmm": its + 1},
              K1b_formula="its + 1", lam0=f"{float(lam[0]):.8e}", lam0_analytic=f"{l1:.8e}",
              lam=",".join(f"{v:.6e}" for v in lam.tolist()),
              worst_measured_residual=f"{res.max():.4e}", setup_s=f"{setup:.4f}",
              wall_s=f"{wall:.4f}")
    if timed:
        eig_timed("lobpcg(M=GridMG)", run, dev, its, "lobpcg_step")
    run_u = lambda: spt.lobpcg(op, X0, tol=EIGS_TOL, max_iter=80)
    (lam_u, _, info_u), c_u, wall_u = run_counted(run_u, dev)
    if c_u["dia_spmm"] != int(info_u.iterations) + 1:
        raise AssertionError(f"lobpcg without M: counts {c_u}, {info_u}")
    log("eigen", entry="lobpcg(no M)", status=spt.Status(int(info_u.status)).name,
        iterations=int(info_u.iterations), residual=f"{float(info_u.residual):.4e}",
        lam0=f"{float(lam_u[0]):.8e}", dia_spmm_launches=c_u["dia_spmm"],
        wall_s=f"{wall_u:.4f}", note="gap-limited; printed, not asserted")
    RUN_COUNTS["lobpcg"] = (grid, int(info_u.iterations), float(lam_u[0]),
                            wall_u / max(int(info_u.iterations), 1) * 1e3)
    return c["dia_spmm"]


def phase_eigen_shift_invert(dev, grid=SI_GRID, timed=True):
    """Phase 14 (b): shift_invert_eigs on the grid³ Poisson (f32, k = 4,
    σ = 1): two LOBPCG passes on the inverted operator, each apply one
    lockstep block MINRES on a ShiftedOperator over the flat view of the
    PaddedDIA; K1b = Σ(1 + lockstep iterations) over the inner solves, plus
    one for the Rayleigh quotients on A. The four λ equal the analytic ones
    nearest σ within tol·|λ| (:func:`match_nearest`), the measured
    residuals within tol."""
    A = problems.poisson3d(grid, grid, grid)
    kw = dict(tol=EIGS_TOL, max_iter=SI_MAX_ITER, inner_max_iter=SI_INNER_MAX_ITER,
              **entry_kw(dev))
    run = lambda: spt.shift_invert_eigs(A, EIGS_K, SIGMA, **kw)
    if timed:
        setup = eig_warm_up(A, dev, lambda: spt.shift_invert_eigs(
            A, EIGS_K, SIGMA, **{**kw, "max_iter": 1, "inner_max_iter": 10}))
    steps = []
    orig = recorded(eigs_mod, "_minres_block", steps)
    try:
        (lam, X, info), c, wall = run_counted(run, dev)
    finally:
        setattr(eigs_mod, "_minres_block", orig)
    its = int(info.iterations)
    if len(steps) != its + 2:
        raise AssertionError(f"shift_invert: {len(steps)} inner solves for {its} iterations")
    want = poisson_eigs_nearest(grid, SIGMA, EIGS_K)
    got = np.sort(lam.cpu().numpy().astype(np.float64))
    res = pair_residuals(A, lam, X) / np.abs(lam.cpu().numpy())
    ok, exact = match_nearest(got, grid, SIGMA, EIGS_TOL)
    if STRICT and not (ok and res.max() <= EIGS_TOL):
        raise AssertionError(f"shift_invert: λ {got} against {want}, residuals {res}")
    eig_check("shift_invert_eigs", info, c, {"dia_spmm": sum(1 + s for s in steps) + 1},
              K1b_formula="sum(1 + lockstep) + 1", inner_solves=len(steps),
              lockstep_inner_iterations=sum(steps),
              lam=",".join(f"{v:.7e}" for v in got), analytic=",".join(f"{v:.7e}" for v in want),
              nearest_within_tol=ok, nearest_with_multiplicity=exact,
              worst_measured_residual=f"{res.max():.4e}", wall_s_with_setup=f"{wall:.4f}")
    RUN_COUNTS["shift_invert"] = (grid, its, sum(steps), (wall - (setup if timed else 0.0))
                                  / max(sum(steps), 1) * 1e3)
    if timed:
        log("eigen", entry="timed(shift_invert_eigs)", wall_s=f"{wall:.4f}",
            setup_s=f"{setup:.4f}", ms_per_lobpcg_step=f"{(wall - setup) / its * 1e3:.4f}",
            ms_per_lockstep_iteration=f"{(wall - setup) / sum(steps) * 1e3:.4f}")
    if timed and torch.device(dev).type == "cuda":
        # the idle share of one inverted-operator apply: one lockstep MINRES
        # on a 3k-column block
        op = FlatViewOperator(op=spt.optimize(A, device=dev))
        inv = eigs_mod.InvertedOperator(A=spt.ShiftedOperator(A=op, shift=SIGMA),
                                        inner_tol=min(EIGS_TOL * 1e-2, 1e-8),
                                        inner_max_iter=SI_INNER_MAX_ITER)
        Xb = torch.as_tensor(np.random.default_rng(SEED + 11).standard_normal(
            (A.shape[0], 3 * EIGS_K)), dtype=torch.float32, device=dev)
        steps = []
        orig = recorded(eigs_mod, "_minres_block", steps)
        try:
            prof = idle_share(lambda _: inv.matmat(Xb), None, names=("dia_spmm",))
        finally:
            setattr(eigs_mod, "_minres_block", orig)
        if prof is None:
            log("eigen", entry="profile(inverted apply)", note="the profiler saw no device time")
        else:
            n = steps[-1]
            log("eigen", entry="profile(inverted apply)", lockstep_iterations=n,
                wall_ms=f"{prof[0]:.4f}", device_busy_ms=f"{prof[1]:.4f}",
                idle_share=f"{prof[2]:.4f}", k1b_ms=f"{prof[3]:.4f}",
                ms_per_lockstep_iteration=f"{prof[0] / max(n, 1):.4f}")
    return c["dia_spmm"]


def phase_eigen_rational(dev, grid=RF_GRID, timed=True):
    """Phase 14 (c): rational_filter_eigs on the grid³ Poisson (f32, k = 4,
    σ = 1, m0 = 8, 4 nodes, one refinement pass): each node solve one
    lockstep block COCG whose apply takes both planes in one K1b; K1b =
    Σ(1 + lockstep iterations) over the node solves plus one Rayleigh–Ritz
    apply per subspace iteration. The four λ equal the analytic ones
    nearest σ within tol·|λ|."""
    A = problems.poisson3d(grid, grid, grid)
    kw = dict(tol=EIGS_TOL, inner_tol=1e-3, inner_max_iter=RF_INNER_MAX_ITER, m0=8,
              n_quad=RF_NODES, inner_refine=RF_REFINE, seed=0, **entry_kw(dev))
    run = lambda: spt.rational_filter_eigs(A, EIGS_K, SIGMA, **kw)
    if timed:
        setup = eig_warm_up(A, dev, lambda: spt.rational_filter_eigs(
            A, EIGS_K, SIGMA, **{**kw, "max_iter": 1, "inner_max_iter": 10}))
    steps = []
    orig = recorded(rat_mod, "_cocg_block", steps)
    try:
        (lam, X, info), c, wall = run_counted(run, dev)
    finally:
        setattr(rat_mod, "_cocg_block", orig)
    per_pass = RF_NODES * (1 + RF_REFINE)
    passes, rest = divmod(len(steps), per_pass)
    if rest:
        raise AssertionError(f"rational: {len(steps)} node solves, not whole passes")
    want = poisson_eigs_nearest(grid, SIGMA, EIGS_K)
    got = np.sort(lam.cpu().numpy().astype(np.float64))
    res = pair_residuals(A, lam, X) / np.abs(lam.cpu().numpy())
    ok, exact = match_nearest(got, grid, SIGMA, EIGS_TOL)
    if STRICT and not (ok and got.size == EIGS_K and res.max() <= EIGS_TOL):
        raise AssertionError(f"rational: λ {got} against {want}, residuals {res}")
    eig_check("rational_filter_eigs", info, c,
              {"dia_spmm": sum(1 + s for s in steps) + passes},
              K1b_formula="sum(1 + lockstep) + passes", subspace_iterations=passes,
              inner_cocg_iterations=int(info.iterations), lockstep_iterations=sum(steps),
              lam=",".join(f"{v:.7e}" for v in got), analytic=",".join(f"{v:.7e}" for v in want),
              nearest_within_tol=ok, nearest_with_multiplicity=exact,
              worst_measured_residual=f"{res.max():.4e}" if res.size else "none",
              wall_s_with_setup=f"{wall:.4f}")
    RUN_COUNTS["rational"] = (grid, passes, sum(steps), (wall - (setup if timed else 0.0))
                              / max(sum(steps), 1) * 1e3)
    if timed:
        log("eigen", entry="timed(rational_filter_eigs)", wall_s=f"{wall:.4f}",
            setup_s=f"{setup:.4f}",
            ms_per_subspace_iteration=f"{(wall - setup) / passes * 1e3:.4f}",
            ms_per_lockstep_iteration=f"{(wall - setup) / sum(steps) * 1e3:.4f}")
    return c["dia_spmm"]


def phase_eigen_shifted(dev, grid=GRID):
    """Phase 14 (d): ShiftedOperator(PaddedDIA, σ = 0.01): its matvec
    bitwise K1 minus σ·x; functional MINRES on it (K1 its + 2, no fused
    kernel) to tol 1e-4 with the true residual of (A − σI)·x − b below
    1e-3."""
    A = problems.poisson3d(grid, grid, grid)
    op = spt.optimize(A, **entry_kw(dev))
    S = spt.ShiftedOperator(A=op, shift=SHIFT)
    rng = np.random.default_rng(SEED + 12)
    x2 = op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=torch.float32,
                                    device=dev))
    if not torch.equal(S.matvec(x2), pd.dia_spmv(op.bands, x2, op.offsets, op.h) - SHIFT * x2):
        raise AssertionError("ShiftedOperator.matvec is not K1 − σ·x")
    b = poisson_rhs(A)
    bd = op.pad_vec(torch.as_tensor(b, device=dev))
    (x, info), c, wall = run_counted(lambda: spt.minres(S, bd, tol=1e-4, max_iter=5000), dev)
    its = int(info.iterations)
    import scipy.sparse as sps

    Sm = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(),
                         A.indptr.numpy()), shape=A.shape) - SHIFT * sps.identity(A.shape[0])
    xh = op.unpad_vec(x).cpu().numpy().astype(np.float64)
    res = float(np.linalg.norm(Sm @ xh - b) / np.linalg.norm(b))
    if STRICT and not (info.converged and res < 1e-3):
        raise AssertionError(f"minres(ShiftedOperator): {info}, true residual {res:.3e}")
    eig_check("minres(ShiftedOperator σ=0.01)", info, c, {"dia_spmv": its + 2},
              true_residual=f"{res:.4e}", wall_s=f"{wall:.4f}")


def phase_eigen(dev):
    """Phase 14: the eigensolvers at the repo's own widths; returns K1b's
    launches in (a), the LOBPCG run, the main K1b path (each run counts
    from 0, and its launches are printed beside it)."""
    t0 = time.perf_counter()
    k1b = {"lobpcg": phase_eigen_lobpcg(dev), "shift_invert": phase_eigen_shift_invert(dev),
           "rational_filter": phase_eigen_rational(dev)}
    phase_eigen_shifted(dev)
    log("eigen", seconds=f"{time.perf_counter() - t0:.2f}",
        **{f"dia_spmm_launches_{k}": v for k, v in k1b.items()})
    return k1b["lobpcg"]


# --- phase 15: the front ends ------------------------------------------------
cli = importlib.import_module("sprsolve_tpu_torch.__main__")
api_mod = importlib.import_module("sprsolve_tpu_torch.api")
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_MAX_ITER = 2000
SCIPY_RTOL = 1e-12
COMPLEX_TOL = 1e-12


def device_argv(dev) -> list:
    """The CLI's device flag: none on the card (the default), ``--device``
    elsewhere."""
    return [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]


def run_cli(argv):
    """``main(argv)`` of ``python -m sprsolve_tpu_torch`` with its standard
    output captured and echoed: (return code, text, wall seconds)."""
    import contextlib
    import io as _io

    buf = _io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log("front", cli=" ".join(argv[:1]), out=repr(line))
    return rc, text, wall


def cli_report(text: str):
    """(method, iterations, status, true rel-res) of a ``solve`` report line
    ("minres: 320 iterations, status CONVERGED, true rel-res 1.2e-09, ...")."""
    line = text.splitlines()[0]
    head, rest = line.split(": ", 1)
    its = int(rest.split(" iterations")[0])
    status = rest.split("status ")[1].split(",")[0]
    relres = float(rest.split("true rel-res ")[1].split(",")[0])
    return head, its, status, relres


@dataclasses.dataclass
class recording_solver:
    """Within the block, ``solve()``'s ``method`` solver appends each solve's
    iteration count to ``its`` (the count a scipy-shaped call does not
    return)."""
    method: str
    its: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        orig = self._orig = api_mod._SOLVERS[self.method]

        def run(*args, **kwargs):
            x, info = orig(*args, **kwargs)
            self.its.append(int(info.iterations))
            return x, info

        api_mod._SOLVERS[self.method] = run
        return self.its

    def __exit__(self, *exc):
        api_mod._SOLVERS[self.method] = self._orig


def phase_front_io(tmp, grid):
    """Phase 15 (a): mmwrite the f64 Poisson with symmetric storage, mmread
    it back through the compiled parser, bitwise equal to the source."""
    from sprsolve_tpu_torch.utils import mmread, mmwrite

    A = problems.poisson3d(grid, grid, grid, dtype=np.float64)
    path = os.path.join(tmp, "poisson.mtx")
    t0 = time.perf_counter()
    mmwrite(path, A, comment="7-point Poisson, chip_smoke.py phase 15", symmetry="symmetric")
    t_write = time.perf_counter() - t0
    with open(path) as f:
        header = [next(f) for _ in range(3)]
    stored = int(header[2].split()[2])
    n = grid ** 3
    if header[0].split() != ["%%MatrixMarket", "matrix", "coordinate", "real", "symmetric"] \
            or stored != (A.nnz + n) // 2:
        raise AssertionError(f"mmwrite: header {header}")
    t0 = time.perf_counter()
    B = mmread(path)
    t_read = time.perf_counter() - t0
    if not (B.shape == A.shape and B.data.dtype == torch.float64
            and all(torch.equal(getattr(B, k), getattr(A, k))
                    for k in ("data", "indices", "indptr"))):
        raise AssertionError("mmread: the CSR read back differs from the one written")
    log("front", entry="io", rows=n, nnz=A.nnz, stored_entries=stored,
        file_bytes=os.path.getsize(path), mmwrite_s=f"{t_write:.3f}",
        mmread_s=f"{t_read:.3f}", bitwise_equal=True)
    return A, path


def phase_front_info(path, grid):
    """Phase 15 (b): ``info`` through main() and as ``python -m``."""
    n = grid ** 3
    rc, text, wall = run_cli(["info", path])
    p = subprocess.run([sys.executable, "-m", "sprsolve_tpu_torch", "info", path], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    want = (f"{n} x {n}", "distinct diagonals 7")
    if rc != 0 or p.returncode != 0 or not all(w in text for w in want) \
            or p.stdout != text:
        raise AssertionError(f"info: rc {rc}/{p.returncode}, {text!r} / {p.stdout!r} "
                             f"{p.stderr[-2000:]}")
    log("front", entry="info", rows=n, diagonals=7, main_wall_s=f"{wall:.3f}",
        subprocess="same output")


def solve_counts(method: str, its: int) -> dict:
    """The launches of ``solve()`` on a PaddedDIA: MINRES K1 once (r₀), K3
    and K4 its + 1 times; BiCGStab with the folded Jacobi K1 once (r₀), K2
    twice per iteration."""
    if method == "minres":
        return {"dia_spmv": 1, "dia_dot": its + 1, "orth_norm": its + 1}
    return {"dia_spmv": 1, "dia_wdot": 2 * its}


def phase_front_solve(dev, tmp, A, path, timed):
    """Phase 15 (c): ``solve`` from the file in f64 (auto → MINRES, and
    BiCGStab + Jacobi, tol 1e-8) and with --f32 (tol 1e-4), each with exact
    launch counts, its true residual and the written x; with ``timed``, the
    f64 pair's prepared times and idle shares."""
    b = poisson_rhs(A).astype(np.float64)
    bpath = os.path.join(tmp, "b.npy")
    np.save(bpath, b)
    runs = (("f64 auto", [], 1e-8, "minres", 1e-6),
            ("f64 bicgstab+jacobi", ["--method", "bicgstab", "--precond", "jacobi"], 1e-8,
             "bicgstab + jacobi", 1e-6),
            ("f32 auto", ["--f32"], 1e-4, "minres", 1e-3),
            ("f32 bicgstab+jacobi", ["--method", "bicgstab", "--precond", "jacobi", "--f32"],
             1e-4, "bicgstab + jacobi", 1e-3))
    for tag, extra, tol, head, res_max in runs:
        xpath = os.path.join(tmp, "x.npy")
        argv = (["solve", path, "--rhs", bpath, "--tol", repr(tol), "--max-iter",
                 str(CLI_MAX_ITER), "--out", xpath] + extra + device_argv(dev))
        pd.reset_launch_counts()
        rc, text, wall = run_cli(argv)
        _sync(dev)
        counts = launch_counts()
        got_head, its, status, relres = cli_report(text)
        x = np.load(xpath)
        res = true_residual(A, torch.as_tensor(x), b)
        want_dt = np.float64 if tag.startswith("f64") else np.float32
        if not (rc == 0 and status == "CONVERGED" and got_head == head
                and res < res_max and relres < res_max and x.dtype == want_dt):
            raise AssertionError(f"cli {tag}: rc {rc}, {text!r}, true residual {res:.3e}")
        expect_counts(f"cli {tag}", counts, **solve_counts(head.split()[0], its))
        log("front", entry=f"cli solve ({tag})", method=head, iterations=its, tol=tol,
            true_residual=res, wall_s=f"{wall:.3f}",
            **{f"{k}_launches": v for k, v in counts.items() if v})
        if timed and tag.startswith("f64"):
            front_solve_times(dev, A, b, head, tol, its)


def front_solve_times(dev, A, b, head, tol, its):
    """The CLI's f64 solve through ``prepare()`` on the same system: three
    timed solves, each in the CLI's count, and one profiled (idle share)."""
    method, M = ("minres", None) if head == "minres" else ("bicgstab", "jacobi")
    handle = spt.prepare(A, method=method, M=M, tol=tol, max_iter=CLI_MAX_ITER,
                         **entry_kw(dev))
    bd = torch.as_tensor(b, device=dev)
    wall, walls, _, _ = timed_solves(handle, bd, its, f"prepare(f64 {head})")
    prof = idle_share(handle, bd, names=REAL_KERNELS)
    extra = {} if prof is None else dict(
        device_busy_ms=f"{prof[1]:.4f}", idle_share=f"{prof[2]:.4f}",
        hand_kernels_ms=f"{prof[3]:.4f}",
        device_us_per_iteration=f"{prof[1] / max(its, 1) * 1e3:.3f}")
    log("front", entry=f"prepare(f64 {head})", iterations=its, wall_s_median=f"{wall:.4f}",
        walls_s=",".join(f"{w:.4f}" for w in walls),
        per_iteration_ms=f"{wall / max(its, 1) * 1e3:.4f}", **extra)


def phase_front_complex(dev, grid):
    """Phase 15 (d): the damped complex-symmetric Poisson in c128 (A + 0.5i·I,
    in memory) through the complex solve() routes at tol 1e-12: auto +
    Jacobi → COCG (K5 its + 1, which no other route gives),
    CS-MINRES with 1/|d| (K5 once, K6 its + 1), and scipy_compat.bicgstab
    on the scipy matrix with the complex Jacobi (K5 once, K7 2·its)."""
    import scipy.sparse as sps

    from sprsolve_tpu_torch import scipy_compat

    P = problems.poisson3d(grid, grid, grid)
    data = P.data.numpy().astype(np.complex128)
    data[P.indices.numpy() == P.row_ids.numpy()] += 0.5j
    arrays = (data, P.indices.numpy(), P.indptr.numpy())
    n = P.shape[0]
    Z = CSR.from_arrays(*arrays, shape=(n, n))
    r = np.random.default_rng(SEED + 6).standard_normal(n)
    b = r + 0.25j * r
    kw = dict(tol=COMPLEX_TOL, max_iter=3000, **entry_kw(dev))
    runs = {
        "auto": (lambda: spt.solve(Z, b, method="auto", M="jacobi", **kw), None,
                 lambda k: {"dia_complex_spmv": k + 1}),
        "cs_minres": (lambda: spt.solve(Z, b, method="cs_minres", M="jacobi", **kw), None,
                      lambda k: {"dia_complex_spmv": 1, "dia_complex_dot": k + 1}),
        "scipy_compat.bicgstab": (
            lambda: scipy_compat.bicgstab(sps.csr_matrix(arrays, shape=(n, n)), b,
                                          rtol=COMPLEX_TOL, maxiter=3000, M="jacobi",
                                          **entry_kw(dev)),
            "bicgstab", lambda k: {"dia_complex_spmv": 1, "dia_complex_wdot": 2 * k}),
    }
    for tag, (run, recorded_method, want) in runs.items():
        if recorded_method is None:
            (x, info), c, wall = run_counted(run, dev)
            its, ok = int(info.iterations), bool(info.converged)
        else:
            with recording_solver(recorded_method) as rec:
                (x, code), c, wall = run_counted(run, dev)
            its, ok = rec[-1], code == 0
        res = complex_true_residual(arrays, (n, n), x, b)
        if not (ok and res < 1e-9 and x.dtype == torch.complex128):
            raise AssertionError(f"c128 {tag}: converged {ok}, true residual {res:.3e}")
        expect_counts(f"c128 {tag}", c, **want(its))
        log("front", entry=f"c128 {tag}", iterations=its, tol=COMPLEX_TOL,
            true_residual=res, wall_s=f"{wall:.3f}",
            **{f"{k}_launches": v for k, v in c.items() if v})
    return Z, arrays


SCIPY_GRID = 50   # phase 15 (e)'s grids


def phase_front_scipy(dev, grid):
    """Phase 15 (e): scipy_compat's cg and minres on the f64 Poisson and
    gmres on the f64 convection-diffusion system, as scipy.sparse matrices,
    at the grid³ (at most SCIPY_GRID³: scipy's own three solves of the
    1M-row systems took 35-51 s on the card's machine, which the script's
    time limit no longer has room for): info 0 and x within 1e-6 of
    scipy.sparse.linalg's own at the same rtol; cg with a too-small
    maxiter gives that maxiter as its info, as scipy's does."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from sprsolve_tpu_torch import scipy_compat

    def scipy_of(m):
        return sps.csr_matrix((m.data.numpy(), m.indices.numpy(), m.indptr.numpy()),
                              shape=m.shape)

    grid = min(grid, SCIPY_GRID)
    A = problems.poisson3d(grid, grid, grid, dtype=np.float64)
    S = scipy_of(A)
    C = scipy_of(problems.convection_diffusion3d(grid, grid, grid, peclet=20.0,
                                                 dtype=np.float64))
    b = poisson_rhs(A).astype(np.float64)
    for name, M in (("cg", S), ("minres", S), ("gmres", C)):
        _sync(dev)
        t0 = time.perf_counter()
        pd.reset_launch_counts()
        x, code = getattr(scipy_compat, name)(M, b, rtol=SCIPY_RTOL, **entry_kw(dev))
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        t0 = time.perf_counter()
        xs, code_s = getattr(spla, name)(M, b, rtol=SCIPY_RTOL)
        wall_s = time.perf_counter() - t0
        xh = x.cpu().numpy()
        err = float(np.linalg.norm(xh - xs) / np.linalg.norm(xs))
        if not (code == 0 and code_s == 0 and xh.dtype == np.float64 and err < 1e-6):
            raise AssertionError(f"scipy_compat.{name}: info {code} (scipy {code_s}), "
                                 f"relative distance to scipy's x {err:.3e}")
        log("front", entry=f"scipy_compat.{name}", grid=f"{grid}^3", rtol=SCIPY_RTOL,
            info=code,
            rel_diff_vs_scipy=f"{err:.3e}", wall_s=f"{wall:.3f}",
            scipy_wall_s=f"{wall_s:.3f}",
            **{f"{k}_launches": v for k, v in counts.items() if v})
    x, code = scipy_compat.cg(S, b, rtol=SCIPY_RTOL, maxiter=5, **entry_kw(dev))
    _, code_s = spla.cg(S, b, rtol=SCIPY_RTOL, maxiter=5)
    if not code == code_s == 5:
        raise AssertionError(f"scipy_compat.cg(maxiter=5): info {code}, scipy's {code_s}")
    log("front", entry="scipy_compat.cg(maxiter=5)", info=code, scipy_info=code_s)


def grid_outputs(op, x, w, dinv, bps):
    """Every dot-kernel output of ``op`` at ``blocks_per_sm`` ``bps``: K3 and
    K2 (fold with w = x; w without fold), or K6 (both forms) and K7 (fold
    with w = x; w without fold)."""
    o, h = op.offsets, op.h
    if op.dtype.is_complex:
        br, bi = op.re.bands, op.im.bands
        return (*pd.dia_complex_dot(br, bi, x, o, h, False, bps),
                *pd.dia_complex_dot(br, bi, x, o, h, True, bps),
                *pd.dia_complex_wdot(br, bi, x, None, dinv, o, h, bps),
                *pd.dia_complex_wdot(br, bi, x, w, None, o, h, bps))
    return (*pd.dia_dot(op.bands, x, o, h, bps),
            *pd.dia_wdot(op.bands, x, None, dinv, o, h, bps),
            *pd.dia_wdot(op.bands, x, w, None, o, h, bps))


def phase_front_tuning(dev, tmp, A, Z):
    """Phase 15 (f): tune_padded_dia and tune_complex_padded_dia on the f64
    Poisson and the c128 damped Poisson, the cache in ``tmp``: each
    candidate's µs printed, every output bitwise the same at every
    candidate, and a fresh operator takes the cached grid."""
    from sprsolve_tpu_torch.utils import tune_complex_padded_dia, tune_padded_dia

    rng = np.random.default_rng(SEED + 9)
    old = os.environ.get("SPRSOLVE_TUNE_CACHE")
    os.environ["SPRSOLVE_TUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    try:
        for kind, m, tune, cls in (
                ("dia", DIA.from_csr(A, device="cpu"), tune_padded_dia, spt.PaddedDIA),
                ("cdia", DIA.from_csr(Z, device="cpu"), tune_complex_padded_dia,
                 spt.ComplexPaddedDIA)):
            t0 = time.perf_counter()
            op = tune(m, verbose=True, device=dev)
            wall = time.perf_counter() - t0
            mk = lambda: op.pad_vec(torch.as_tensor(
                rng.standard_normal(op.n) + (1j * rng.standard_normal(op.n)
                                             if kind == "cdia" else 0)).to(op.dtype).to(dev))
            x, w = mk(), mk()
            dinv = op.jacobi_precond().diag_inv
            ref = grid_outputs(op, x, w, dinv, None)
            for bps in tuning.GRID_CANDIDATES:
                got = grid_outputs(op, x, w, dinv, bps)
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise AssertionError(f"{kind}: blocks_per_sm={bps} changes an output")
            fresh = cls.from_dia(m, device=dev)
            if fresh.dot_blocks_per_sm != op.dot_blocks_per_sm \
                    or op.dot_blocks_per_sm not in tuning.GRID_CANDIDATES:
                raise AssertionError(f"{kind}: tuned {op.dot_blocks_per_sm}, a fresh "
                                     f"operator takes {fresh.dot_blocks_per_sm}")
            grid = pd.persistent_grid(op.n_pad, op.dtype, pd._sm_count(dev.index or 0)
                                      if torch.device(dev).type == "cuda" else 1,
                                      op.dot_blocks_per_sm)
            log("front", entry=f"tune ({kind}, {op.dtype})", winner_blocks_per_sm=
                op.dot_blocks_per_sm, winner_grid=grid, sweep_s=f"{wall:.3f}",
                outputs_bitwise_equal_over=",".join(map(str, tuning.GRID_CANDIDATES)),
                fresh_operator_takes_cache=True)
    finally:
        if old is None:
            os.environ.pop("SPRSOLVE_TUNE_CACHE", None)
        else:
            os.environ["SPRSOLVE_TUNE_CACHE"] = old


SHARE_ROUNDS = 9   # interleaved measurements of each timer in phase 15 (g)


def phase_front_timing(dev, tmp, grid, k1_stats):
    """Phase 15 (g): ``timing.spmv_report`` of K1 on the f32 Poisson, its
    roofline share within 5% of phase 3's own (phase 3's bound over phase
    3's graph-replayed timer, run here; each the median of SHARE_ROUNDS
    interleaved measurements), and a Chrome trace written by
    ``timing.trace``."""
    from sprsolve_tpu_torch.utils import timing

    A = problems.poisson3d(grid, grid, grid)
    op = spt.PaddedDIA.from_dia(DIA.from_csr(A, device="cpu"), device=dev)
    x = op.pad_vec(torch.as_tensor(np.random.default_rng(SEED + 10).standard_normal(op.n),
                                   dtype=torch.float32, device=dev))
    call = lambda v: pd.dia_spmv(op.bands, v, op.offsets, op.h)
    # both timers SHARE_ROUNDS times, interleaved, and their medians: one
    # replay of 20 calls of this 8 µs kernel moves by 5-11% from one
    # measurement to the next (the same timer, the card's state drifting)
    ts, mss = [], []
    for _ in range(SHARE_ROUNDS):
        ts.append(timing.time_fn(call, x))
        if k1_stats is not None:
            mss.append(device_ms(lambda: call(x)))
    t = statistics.median(ts)
    rep = timing.spmv_report(t, A.nnz, timing.dia_bytes(
        op.n, len(op.offsets), itemsize=4, band_itemsize=op.bands.element_size()), device=dev)
    with timing.trace(os.path.join(tmp, "trace")) as trace_path:
        call(x)
    if not os.path.getsize(trace_path) > 0:
        raise AssertionError("timing.trace wrote no trace")
    fields = dict(report=repr(str(rep)), seconds=f"{t:.9f}", trace_bytes=os.path.getsize(
        trace_path))
    if k1_stats is not None:
        # phase 3's bytes bound over phase 3's timer, run here on these
        # inputs: the card's state drifts over the script's minutes
        ms = statistics.median(mss)
        share3 = k1_stats["bound_ms"] / ms
        if not abs(rep.roofline_fraction - share3) <= 0.05 * share3:
            raise AssertionError(f"spmv_report: roofline share {rep.roofline_fraction:.4f}, "
                                 f"phase 3's {share3:.4f}")
        fields.update(roofline_share=f"{rep.roofline_fraction:.4f}",
                      phase3_share=f"{share3:.4f}", phase3_timer_ms=f"{ms:.5f}",
                      phase3_ms=f"{k1_stats['ms']:.5f}")
    log("front", entry="timing.spmv_report(K1)", **fields)


def phase_front_kernels(dev, A, Z, z_arrays):
    """Phase 15 (h): K1-K4 on the f64 Poisson and K5-K7 on the c128 damped
    Poisson at this slice's shapes: graph-replayed warm and cold times, the
    plain versions', the bounds and torch.mv on the same CSR (f64, c128)."""
    rng = np.random.default_rng(SEED + 11)
    op = spt.PaddedDIA.from_dia(DIA.from_csr(A, device="cpu"), device=dev)
    assert op.bands.dtype == torch.float64
    mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=torch.float64,
                                            device=dev))
    real_kernel_stats(op, mk(), op.jacobi_precond().diag_inv, mk, csr=A,
                      tag="poisson100_f64")
    opz = spt.ComplexPaddedDIA.from_csr(Z, device=dev)
    assert opz.re.bands.dtype == opz.im.bands.dtype == torch.float64
    mkz = lambda: opz.pad_vec(torch.complex(
        *(torch.as_tensor(rng.standard_normal(opz.n), dtype=torch.float64, device=dev)
          for _ in range(2))))
    complex_kernel_stats(opz, mkz(), mkz(), opz.jacobi_precond().diag_inv,
                         csr_arrays=z_arrays, tag="damped_c128")


def phase_front(dev, grid=GRID, timed=True, k1_stats=None):
    """Phase 15: the front ends (Matrix Market IO, the CLI, the complex
    routes and scipy_compat in f64/c128, the grid autotune, the timing
    harness) on the 1M-row Poisson."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        A, path = phase_front_io(tmp, grid)
        phase_front_info(path, grid)
        phase_front_solve(dev, tmp, A, path, timed)
        Z, z_arrays = phase_front_complex(dev, grid)
        phase_front_scipy(dev, grid)
        phase_front_tuning(dev, tmp, A, Z)
        phase_front_timing(dev, tmp, grid, k1_stats)
        if timed:
            phase_front_kernels(dev, A, Z, z_arrays)
    log("front", seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 16: the distributed layer -----------------------------------------
# the counts of the single-card solves that phase 16 is held to: phase 4's
# Jacobi-BiCGStab, phase 6's MINRES and Jacobi-CG, phase 9's complex solves
RUN_COUNTS = {}
DIST_WORLD = 2          # ranks of phase 16 (b)-(d), every one on cuda:0
DIST_TIMEOUT_S = 420    # the whole of (b)-(d) in its processes
DIST_GRID = 32          # (d)'s torch-op layouts: the 32³ Poisson


def dist_counts():
    """The communication counters: ``{name: (calls, bytes)}``."""
    from sprsolve_tpu_torch.parallel import comm

    return comm.counts()


def dist_store(tmp: str) -> str:
    return "file://" + os.path.join(tmp, "store")


def dist_check_solve(tag, info, c, want, comm_counts, h, itemsize, sides, its_ref=None):
    """The gates of one distributed solve: CONVERGED, every kernel's launches
    as ``want`` (kernel → count; the rest 0), one halo exchange per SpMV
    launch that sends h entries to each of the rank's ``sides`` neighbours,
    and the count within the band of the single-card solve's ``its_ref``."""
    n = int(info.iterations)
    if not info.converged:
        raise AssertionError(f"{tag}: {info}")
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(want)
    if c != expect:
        raise AssertionError(f"{tag}: launch counts {c}, expected {expect}")
    spmvs = sum(v for k, v in c.items() if k not in ("orth_norm", "dia_spmm"))
    calls, nbytes_ = comm_counts["halo_exchange"]
    if calls != spmvs or nbytes_ != spmvs * sides * h * itemsize:
        raise AssertionError(f"{tag}: {calls} halo exchanges sending {nbytes_} B for {spmvs} "
                             f"SpMVs (h={h}, {itemsize} B, {sides} neighbours)")
    if its_ref is not None and abs(n - its_ref) > parity_band(its_ref):
        raise AssertionError(f"{tag}: {n} iterations against {its_ref} on one card")
    return n


def dist_call_us(fn, reps=200):
    """µs per call of ``fn`` over ``reps`` back-to-back calls (after one
    warm call), the card synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def dist_local_system(A, rhs, M, g, dev):
    """``(operator, rhs, {"M": ...})`` of this rank, laid out as
    ``distributed_solve`` lays them out (a flat M re-laid with zero pads; a
    layout of torch ops takes the rhs with zero pad rows): the solver alone
    can then be timed on them."""
    from sprsolve_tpu_torch import parallel as par

    if M is not None and M.diag_inv.shape[0] != A.padded_len:
        M = type(M)(diag_inv=A.pad_vec(M.diag_inv))
    specs = par.make_solver_specs(A, M)[0]
    op_l = par.local_part(A, specs[0], g, dev)
    b = torch.as_tensor(rhs)
    b = (A.pad_vec(b) if hasattr(A, "pad_vec")
         else torch.cat([b, b.new_zeros((A.shape[0] - b.shape[0],) + b.shape[1:])]))
    b_l = par.local_part(b, 0, g, dev)
    return op_l, b_l, ({} if M is None else {"M": par.local_part(M, specs[3], g, dev)})


def phase_dist_nccl(dev):
    """Phase 16 (a): Jacobi-BiCGStab on the 1M-row Poisson through
    ``distributed_solve`` on one rank under NCCL, against phase 4."""
    import torch.distributed as dist

    from sprsolve_tpu_torch import parallel as par
    from sprsolve_tpu_torch.parallel import comm

    A = problems.poisson3d(GRID, GRID, GRID)
    dia = DIA.from_csr(A, device="cpu")
    b = poisson_rhs(A)
    its4, ms4 = RUN_COUNTS["bicgstab_jacobi"], RUN_COUNTS["bicgstab_jacobi_ms"]
    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"   # gloo: a CPU rehearsal
        dist.init_process_group(backend, init_method=dist_store(tmp), rank=0, world_size=1)
        try:
            g = dist.group.WORLD
            op = par.DistPaddedDIA.from_dia(dia, 1)
            M = spt.DiagPrecond.new(dia.diagonal())
            pd.reset_launch_counts()
            comm.reset_counts()
            x, info = par.distributed_solve(spt.bicgstab, op, b, M=M, tol=1e-4, max_iter=400,
                                            device=dev)
            torch.cuda.synchronize()
            c, cc = launch_counts(), dist_counts()
            res = true_residual(A, x, b)
            its = dist_check_solve("dist nccl bicgstab", info, c,
                                   {"dia_spmv": c["dia_spmv"], "dia_wdot": 2 * int(info.iterations)},
                                   cc, op.h, 4, 0, its4)
            restarts = c["dia_spmv"] - 1
            if not (res < 1e-3 and x.shape == (A.shape[0],) and bool(torch.isfinite(x).all())
                    and c["dia_spmv"] >= 1):
                raise AssertionError(f"dist nccl: true residual {res:.3e}, {c}")
            if cc["all_reduce_sum"][0] != 2 + 4 * its + restarts or cc["all_gather_rows"][0] != 1:
                raise AssertionError(f"dist nccl: collectives {cc} for {its} iterations")
            # the group layer's own cost: the solver on the rank's part, timed
            op_l, b_l, kw = dist_local_system(op, b, M, g, dev)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, inf = spt.bicgstab(op_l, b_l, tol=1e-4, max_iter=400, group=g, **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if int(inf.iterations) != its:
                    raise AssertionError(f"dist nccl: a timed solve took {inf.iterations}")
            ms = statistics.median(walls) / its * 1e3
            one = torch.ones((), device=dev)
            comm.all_reduce_sum(one, g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                comm.all_reduce_sum(one, g)
            torch.cuda.synchronize()
            ar_us = (time.perf_counter() - t0) / 200 * 1e6
            # where the group layer's time goes: per call, 200 calls each
            u = b_l * kw["M"].diag_inv
            win = op_l.window(u)
            win_us = dist_call_us(lambda: op_l.window(u))
            k2_us = dist_call_us(lambda: pd.dia_wdot(op_l.bands, win, b_l, None,
                                                      op_l.offsets, op_l.h))
            mvw_us = dist_call_us(lambda: op_l.matvec_wdot(u, b_l))
            # and the host's ops over one solve (CPU activity only: the loop is host-bound)
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                spt.bicgstab(op_l, b_l, tol=1e-4, max_iter=400, group=g, **kw)
                torch.cuda.synchronize()
            ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
            host_us = sum(e.self_cpu_time_total for e in ops) / its
            log("dist", part="a", host_ops_us_per_iteration=f"{host_us:.1f}",
                top=";".join(f"{e.key}:{e.count / its:.1f}x:{e.self_cpu_time_total / its:.1f}us"
                             for e in ops[:10]))
            log("dist", part="a", backend=backend, ranks=1, solver="bicgstab+jacobi",
                iterations=its, phase4_iterations=its4, true_residual=res,
                K1_launches=c["dia_spmv"], K2_launches=c["dia_wdot"],
                all_reduce_calls=cc["all_reduce_sum"][0],
                all_reduce_calls_per_iteration=f"{(cc['all_reduce_sum'][0] - 2 - restarts) / its:.1f}",
                halo_exchanges=cc["halo_exchange"][0], per_iteration_ms=f"{ms:.4f}",
                phase4_prepared_per_iteration_ms=f"{ms4:.4f}",
                group_layer_ms_per_iteration=f"{ms - ms4:.4f}",
                all_reduce_us_cuda_scalar=f"{ar_us:.2f}", window_us=f"{win_us:.2f}",
                k2_on_window_us=f"{k2_us:.2f}", matvec_wdot_us=f"{mvw_us:.2f}",
                four_all_reduces_two_windows_ms=f"{(4 * ar_us + 2 * win_us) / 1e3:.4f}")
        finally:
            dist.destroy_process_group()


# --- phase 16 (e): the rest of the Krylov family on one rank ------------------
DK_BLOCK = 8        # phase 13 (b)'s block of columns
DK_INNER = 8        # phase 13 (d)'s inner CG steps
DK_S = 2            # CA-BiCGStab's s, on MPKDIA of depth 2s


def _dk_fgmres(Ad, rhs, x0=None, *, tol, max_iter, group=None):
    """FGMRES(RESTART) with an inner CG of DK_INNER steps as M, both on
    ``group`` (None: one card)."""
    M = spt.InnerSolvePrecond(A=Ad, method="cg", iters=DK_INNER, group=group)
    return spt.fgmres(Ad, rhs, x0, M=M, tol=tol, max_iter=max_iter, restart=RESTART,
                      group=group)


def _dk_cases(grid, dev):
    """Phase 16 (e)'s solves: name → (solver, the distributed operator, rhs,
    M, the single-card run, the launches of ``its``, the (all-reduces,
    halo exchanges) of ``its``, the true residual of x). Counts of the
    distributed solve on one rank; FGMRES's its are Arnoldi steps,
    BiCGStab(2)'s cycles."""
    import functools

    import scipy.sparse as sps

    from sprsolve_tpu_torch import parallel as par

    A = problems.poisson3d(grid, grid, grid)
    n = A.shape[0]
    dia = DIA.from_csr(A, device="cpu")
    b = poisson_rhs(A)
    B = np.random.default_rng(SEED + 4).standard_normal((n, DK_BLOCK)).astype(np.float32)
    cb = dia.bands.numpy().astype(np.complex64)
    cb[dia.offsets.index(0)] += 0.5j
    damped = DIA(bands=torch.from_numpy(cb), offsets=dia.offsets, shape=dia.shape)
    data = A.data.numpy().astype(np.complex64)
    data[A.indices.numpy() == A.row_ids.numpy()] += 0.5j
    r = np.random.default_rng(SEED + 6).standard_normal(n).astype(np.float32)
    bz = (r + 0.25j * r).astype(np.complex64)

    op = par.DistPaddedDIA.from_dia(dia, 1)
    cop = par.DistComplexPaddedDIA.from_dia(damped, 1)
    mpk = par.partition_dia_mpk(dia, 1, 2 * DK_S)
    sop = spt.PaddedDIA.from_dia(dia, device=dev)
    scop = spt.ComplexPaddedDIA.from_dia(damped, device=dev)
    sdia = DIA.from_csr(A, device=dev)
    Mj = spt.DiagPrecond.new(dia.diagonal())
    Ms = spt.DiagPrecond(diag_inv=sop.pad_vec(Mj.diag_inv.to(dev)))   # zero pads, as relayed
    pb = sop.pad_vec(torch.as_tensor(b, device=dev))
    ca = functools.partial(spt.ca_bicgstab, s=DK_S, bounds=spt.gershgorin_bounds(A))
    kw = dict(tol=1e-4, max_iter=1000)
    cycles = lambda its: -(-its // RESTART)
    S = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(),
                        A.indptr.numpy()), shape=A.shape)
    Sz = sps.csr_matrix((data.astype(np.complex128), A.indices.numpy(), A.indptr.numpy()),
                        shape=A.shape)

    def residual(S_, rhs):
        """The true relative residual of x (the largest of its columns')."""
        def of(x):
            xh = x.detach().cpu().numpy().astype(S_.dtype)
            bh = np.asarray(rhs, S_.dtype)
            return float(np.max(np.linalg.norm(S_ @ xh - bh, axis=0)
                                / np.linalg.norm(bh, axis=0)))
        return of

    res = residual(S, b)

    return {
        "cg_single_sync": (
            spt.cg_single_sync, op, b, Mj,
            lambda: spt.cg_single_sync(sop, pb, M=Ms, **kw),
            lambda k: {"dia_spmv": k + 2}, lambda k: (2 + k, 2 + k), res),
        "block_cg": (
            spt.block_cg, op, B, None,
            lambda: spt.block_cg(sop, sop.pad_block(torch.as_tensor(B, device=dev)), **kw),
            lambda k: {"dia_spmm": k + 1}, lambda k: (2 + 4 * k, 1 + k), residual(S, B)),
        "bicgstabl": (
            spt.bicgstabl, op, b, Mj, lambda: spt.bicgstabl(sop, pb, M=Ms, **kw),
            lambda k: {"dia_spmv": 1, "dia_wdot": 4 * k}, lambda k: (2 + 11 * k, 1 + 4 * k),
            res),
        "cgs": (
            spt.cgs, op, b, Mj, lambda: spt.cgs(sop, pb, M=Ms, **kw),
            lambda k: {"dia_spmv": 1 + 2 * k}, lambda k: (2 + 3 * k, 1 + 2 * k), res),
        "tfqmr": (
            spt.tfqmr, op, b, Mj, lambda: spt.tfqmr(sop, pb, M=Ms, **kw),
            lambda k: {"dia_spmv": 3 + 2 * k}, lambda k: (4 + 4 * k, 3 + 2 * k), res),
        "fgmres_inner_cg": (
            _dk_fgmres, op, b, None, lambda: _dk_fgmres(sop, pb, **kw),
            lambda k: {"dia_spmv": 2 * k + cycles(k) + 1, "dia_dot": DK_INNER * k},
            lambda k: (2 + 2 * cycles(k) + (6 + 3 * DK_INNER) * k,
                       1 + cycles(k) + (2 + DK_INNER) * k), res),
        "ca_bicgstab": (
            ca, mpk, b, None,
            lambda: ca(sdia, torch.as_tensor(b, device=dev), **kw),
            lambda k: {}, None, res),
        "cocg": (
            spt.cocg, cop, bz, cop.jacobi_precond(),
            lambda: spt.cocg(scop, scop.pad_vec(torch.as_tensor(bz, device=dev)),
                             M=scop.jacobi_precond(), **kw),
            lambda k: {"dia_complex_spmv": k + 1}, lambda k: (3 + 3 * k, 1 + k),
            residual(Sz, bz)),
    }


def _dk_blocks(marks, end):
    """CA-BiCGStab's s-step blocks and anchors, from the counters read as
    each block starts (``marks``) and at the end: every block takes one
    all-reduce and one halo exchange, an anchor (the true residual, r̃₀ :=
    r) one more of each; the last anchor follows the last block."""
    seq = [(m["all_reduce_sum"][0], m["halo_exchange"][0]) for m in marks]
    seq.append((end["all_reduce_sum"][0] - 1, end["halo_exchange"][0] - 1))
    deltas = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(seq, seq[1:])]
    if not deltas or any(d not in ((1, 1), (2, 2)) for d in deltas) or seq[0] != (2, 1):
        raise AssertionError(f"dist krylov ca_bicgstab: collectives at each block {seq}")
    return len(marks), 1 + deltas.count((2, 2))


def phase_dist_krylov(dev, grid=GRID, timed=True):
    """Phase 16 (e): the Krylov family through ``distributed_solve`` on one
    rank (NCCL on the card, gloo on the CPU), each solve held to the
    single-card solve of the same system (see the module docstring)."""
    import torch.distributed as dist

    from sprsolve_tpu_torch import parallel as par
    from sprsolve_tpu_torch.parallel import comm

    tcab = importlib.import_module("sprsolve_tpu_torch.solvers.ca_bicgstab")
    t0 = time.perf_counter()
    cases = _dk_cases(grid, dev)
    setup = time.perf_counter() - t0
    kw = dict(tol=1e-4, max_iter=1000)
    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=dist_store(tmp), rank=0, world_size=1)
        try:
            g = dist.group.WORLD
            for name, (solver, op, rhs, M, single, want, coll, res_of) in cases.items():
                t_case = time.perf_counter()
                x1, info1 = single()
                its1 = int(info1.iterations)
                marks, inner = [], tcab.basis_block

                def marked(*a, **k):
                    marks.append(dist_counts())
                    return inner(*a, **k)

                tcab.basis_block = marked
                pd.reset_launch_counts()
                comm.reset_counts()
                try:
                    x, info = par.distributed_solve(solver, op, rhs, M=M, group=g, device=dev,
                                                    **kw)
                    _sync(dev)
                finally:
                    tcab.basis_block = inner
                c, cc = launch_counts(), dist_counts()
                its = int(info.iterations)
                res = res_of(x)
                expect = dict.fromkeys(KERNELS, 0)
                expect.update(want(its))
                if coll is None:
                    blocks, anchors = _dk_blocks(marks, cc)
                    ar_h = (2 + blocks + anchors, 1 + blocks + anchors)
                else:
                    ar_h = coll(its)
                got = (cc["all_reduce_sum"][0], cc["halo_exchange"][0])
                if not (info.converged and res < 1e-3 and bool(torch.isfinite(x).all())
                        and x.shape == torch.as_tensor(rhs).shape):
                    raise AssertionError(f"dist krylov {name}: {info}, true residual {res:.3e}")
                if c != expect:
                    raise AssertionError(f"dist krylov {name}: launches {c}, expected {expect}")
                if got != ar_h or cc["all_gather_rows"][0] != 1:
                    raise AssertionError(f"dist krylov {name}: collectives {cc}, expected "
                                         f"(all-reduces, halo exchanges) {ar_h}")
                if its != its1 or not info1.converged:
                    raise AssertionError(f"dist krylov {name}: {its} iterations, one card "
                                         f"{info1}")
                fields = {}
                if coll is None:
                    fields.update(blocks=blocks, anchors=anchors, all_reduces_per_block=1,
                                  halo_exchanges_per_block=1)
                else:
                    # an iteration's collectives, inside FGMRES's first cycle
                    k0, k1 = coll(RESTART - 1), coll(RESTART)
                    fields.update(all_reduces_per_iteration=k1[0] - k0[0],
                                  halo_exchanges_per_iteration=k1[1] - k0[1])
                if timed:
                    op_l, b_l, mkw = dist_local_system(op, rhs, M, g, dev)
                    run = lambda: solver(op_l, b_l, group=g, **kw, **mkw)
                    walls = []
                    for _ in range(3):
                        _sync(dev)
                        t1 = time.perf_counter()
                        _, inf = run()
                        _sync(dev)
                        walls.append(time.perf_counter() - t1)
                        if int(inf.iterations) != its:
                            raise AssertionError(f"dist krylov {name}: a timed solve took "
                                                 f"{inf.iterations}")
                    fields["per_iteration_ms"] = f"{statistics.median(walls) / its * 1e3:.4f}"
                    # the device alone: a CPU trace of these host-bound loops
                    # took 2-15 s a solve to record and read
                    prof = idle_share(lambda _: run(), None,
                                      names=REAL_KERNELS + ("dia_complex",), cpu=False)
                    if prof is None:
                        fields["profile"] = "the profiler saw no device time"
                    else:
                        fields.update(device_us_per_iteration=f"{prof[1] / its * 1e3:.3f}",
                                      idle_share=f"{prof[2]:.4f}",
                                      hand_kernels_ms=f"{prof[3]:.4f}",
                                      device_busy_ms=f"{prof[1]:.4f}")
                log("dist", part="e", backend=backend, ranks=1, solver=name,
                    layout=type(op).__name__, iterations=its, single_card_iterations=its1,
                    true_residual=res,
                    **{f"{k}_launches": v for k, v in c.items() if v},
                    all_reduce_calls=got[0], halo_exchanges=got[1], **fields,
                    case_wall_s=f"{time.perf_counter() - t_case:.2f}")
        finally:
            dist.destroy_process_group()
    log("dist", part="e", setup_s=f"{setup:.2f}", wall_s=f"{time.perf_counter() - t0:.2f}")


def _dist_solves(rank, g, dev, dia, damped, ref):
    """Phase 16 (b) on one rank: the real and complex solves at full width,
    each with its launch and halo counts checked; x's bits kept for the
    parent (rank 0 returns x itself, for the true residual)."""
    import hashlib

    from sprsolve_tpu_torch import parallel as par
    from sprsolve_tpu_torch.parallel import comm

    op = par.DistPaddedDIA.from_dia(dia, DIST_WORLD)
    cop = par.DistComplexPaddedDIA.from_dia(damped, DIST_WORLD)
    n = dia.shape[0]
    b = np.random.default_rng(SEED + 2).standard_normal(n).astype(np.float32)
    r = np.random.default_rng(SEED + 6).standard_normal(n).astype(np.float32)
    bz = (r + 0.25j * r).astype(np.complex64)
    Mj = spt.DiagPrecond.new(dia.diagonal())
    runs = {   # name → (solver, operator, rhs, M, expected launches of its counts, ref)
        "bicgstab": (spt.bicgstab, op, b, Mj,
                     lambda c, k: {"dia_spmv": c["dia_spmv"], "dia_wdot": 2 * k},
                     ref["bicgstab_jacobi"]),
        "minres": (spt.minres, op, b, None,
                   lambda c, k: {"dia_spmv": 1, "dia_dot": k + 1, "orth_norm": k + 1},
                   ref["minres"]),
        "cg": (spt.cg, op, b, Mj, lambda c, k: {"dia_spmv": 1, "dia_dot": k},
               ref["cg_jacobi"]),
        "cocg": (spt.cocg, cop, bz, cop.jacobi_precond(),
                 lambda c, k: {"dia_complex_spmv": k + 1}, ref["complex_auto"]),
        "cs_minres": (spt.cs_minres, cop, bz, cop.abs_jacobi_precond(),
                      lambda c, k: {"dia_complex_spmv": 1, "dia_complex_dot": k + 1},
                      ref["complex_cs_minres"]),
        "complex_bicgstab": (spt.bicgstab, cop, bz, cop.jacobi_precond(),
                             lambda c, k: {"dia_complex_spmv": c["dia_complex_spmv"],
                                           "dia_complex_wdot": 2 * k},
                             ref["complex_bicgstab"]),
    }
    out = {}
    for name, (solver, A, rhs, M, want, its_ref) in runs.items():
        pd.reset_launch_counts()
        comm.reset_counts()
        x, info = par.distributed_solve(solver, A, rhs, M=M, tol=1e-4, max_iter=1000,
                                        group=g, device=dev)
        torch.cuda.synchronize()
        c, cc = launch_counts(), dist_counts()
        k = int(info.iterations)
        item = 8 if rhs.dtype == np.complex64 else 4
        dist_check_solve(f"dist rank {rank} {name}", info, c, want(c, k), cc, op.h, item,
                         (rank > 0) + (rank < DIST_WORLD - 1), its_ref)
        if cc["all_gather_rows"][0] != 1:
            raise AssertionError(f"dist rank {rank} {name}: {cc['all_gather_rows'][0]} all-gathers")
        if name in ("bicgstab", "complex_bicgstab"):
            # ‖b‖, ‖r₀‖, 4 an iteration, 1 a restart; each restart 1 SpMV
            restarts = c["dia_spmv" if name == "bicgstab" else "dia_complex_spmv"] - 1
            if cc["all_reduce_sum"][0] != 2 + 4 * k + restarts:
                raise AssertionError(f"dist rank {rank} {name}: {cc['all_reduce_sum'][0]} "
                                     f"all-reduces for {k} iterations, {restarts} restarts")
        if not (bool(torch.isfinite(x).all()) and x.shape == (n,)
                and x.dtype == torch.as_tensor(rhs).dtype):
            raise AssertionError(f"dist rank {rank} {name}: x {x.shape} {x.dtype}")
        # the rank's solve timed on its own part (all ranks in step)
        op_l, b_l, kw = dist_local_system(A, rhs, M, g, dev)
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, inf = solver(op_l, b_l, tol=1e-4, max_iter=1000, group=g, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"its": k, "converged": bool(info.converged),
                     "sha": hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(),
                     "x": x.cpu().numpy() if rank == 0 else None,
                     "launches": {kk: v for kk, v in c.items() if v}, "comm": cc,
                     "ms_per_iteration": wall / max(int(inf.iterations), 1) * 1e3,
                     "timed_its": int(inf.iterations)}
    # gloo's all-reduce of a 0-d CUDA tensor
    one = torch.ones((), device=dev)
    comm.all_reduce_sum(one, g)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        comm.all_reduce_sum(one, g)
    torch.cuda.synchronize()
    out["all_reduce_us"] = (time.perf_counter() - t0) / 200 * 1e6
    return out


def _dist_kernels(rank, g, dev, dia, damped):
    """Phase 16 (c) on one rank: K1-K7 on the rank's window (the last
    rank's with its padded tail) against their plain versions, with phase
    3's tolerances; K2/K3 y bitwise K1's and K6 y bitwise K5's on the same
    window; the halos zero."""
    from sprsolve_tpu_torch import parallel as par

    op = par.DistPaddedDIA.from_dia(dia, DIST_WORLD)
    cop = par.DistComplexPaddedDIA.from_dia(damped, DIST_WORLD)
    rng = np.random.default_rng(SEED + 16)
    errs = dict.fromkeys(KERNELS, 0.0)
    ol = par.local_part(op, op.pspec(), g, dev)
    mk = lambda: par.local_part(op.pad_vec(torch.as_tensor(
        rng.standard_normal(op.n).astype(np.float32))), 0, g, dev)
    x, w, v = mk(), mk(), mk()
    xw = ol.window(x)
    b, o, h = ol.bands, ol.offsets, ol.h

    def halo0(t, tag):
        if bool(t[:h].any() or t[h + ol.r_local:].any()):
            raise AssertionError(f"{tag}: halo not zero")

    scale = pd.dia_spmv_plain(b.to(torch.float32).abs(), xw.abs(), o, h).max()
    y1 = pd.dia_spmv(b, xw, o, h)
    errs["dia_spmv"] = check_close("shard K1", y1, pd.dia_spmv_plain(b, xw, o, h), scale,
                                   Y_RTOL[torch.float32])
    halo0(y1, "shard K1")
    y3, d3 = pd.dia_dot(b, xw, o, h)
    yr, dr = pd.dia_dot_plain(b, xw, o, h)
    errs["dia_dot"] = check_close("shard K3", y3, yr, scale, Y_RTOL[torch.float32])
    check_close("shard K3 dot", d3, dr, (xw * yr).abs().sum(), DOT_RTOL[torch.float32])
    for wv in (w, None):
        y2, wd, yd = pd.dia_wdot(b, xw, wv, None, o, h)
        yr, wdr, ydr = pd.dia_wdot_plain(b, xw, wv, None, o, h)
        errs["dia_wdot"] = max(errs["dia_wdot"], check_close("shard K2", y2, yr, scale,
                                                             Y_RTOL[torch.float32]))
        check_close("shard K2 wy", wd, wdr, ((xw if wv is None else wv) * yr).abs().sum(),
                    DOT_RTOL[torch.float32])
        check_close("shard K2 yy", yd, ydr, ydr, DOT_RTOL[torch.float32])
        if not torch.equal(y2, y1):
            raise AssertionError("shard K2: y is not K1's bit for bit")
    if not torch.equal(y3, y1):
        raise AssertionError("shard K3: y is not K1's bit for bit")
    beta, alpha = torch.tensor(0.7, device=dev), torch.tensor(-1.3, device=dev)
    vn, sq = ol.orth_norm(x, w, v, beta, alpha)
    vr, sqr = fused.orth_norm_plain(x, w, v, beta, alpha, h)
    errs["orth_norm"] = check_close("shard K4", vn, vr, (x.abs() + 0.7 * w.abs()
                                                         + 1.3 * v.abs()).max(),
                                    Y_RTOL[torch.float32])
    check_close("shard K4 sum", sq, sqr, sqr, DOT_RTOL[torch.float32])
    halo0(vn, "shard K4")

    cl = par.local_part(cop, cop.pspec(), g, dev)
    mkc = lambda: par.local_part(cop.pad_vec(torch.as_tensor(
        (rng.standard_normal(op.n) + 1j * rng.standard_normal(op.n)).astype(np.complex64))),
        0, g, dev)
    z, zw_ = mkc(), mkc()
    zw = cl.re.window(z)
    bre, bim = cl.re.bands, cl.im.bands
    absb = (bre.to(torch.float32).abs() + bim.to(torch.float32).abs())
    cscale = pd.dia_spmv_plain(absb, zw.abs(), o, h).max()
    y5 = pd.dia_complex_spmv(bre, bim, zw, o, h)
    errs["dia_complex_spmv"] = check_close(
        "shard K5", y5, pd.dia_complex_spmv_plain(bre, bim, zw, o, h), cscale,
        Y_RTOL[torch.float32])
    halo0(y5, "shard K5")
    for conj_x in (False, True):
        y6, d6 = pd.dia_complex_dot(bre, bim, zw, o, h, conj_x)
        yr, dr = pd.dia_complex_dot_plain(bre, bim, zw, o, h, conj_x)
        errs["dia_complex_dot"] = max(errs["dia_complex_dot"], check_close(
            f"shard K6 conj_x={conj_x}", y6, yr, cscale, Y_RTOL[torch.float32]))
        check_close("shard K6 dot", d6, dr, (zw.abs() * yr.abs()).sum(),
                    DOT_RTOL[torch.float32])
        u = torch.conj_physical(zw) if conj_x else zw
        if not torch.equal(y6, pd.dia_complex_spmv(bre, bim, u, o, h)):
            raise AssertionError("shard K6: y is not K5's bit for bit")
    for wv in (zw_, None):
        y7, wd, yd = pd.dia_complex_wdot(bre, bim, zw, wv, None, o, h)
        yr, wdr, ydr = pd.dia_complex_wdot_plain(bre, bim, zw, wv, None, o, h)
        errs["dia_complex_wdot"] = max(errs["dia_complex_wdot"], check_close(
            "shard K7", y7, yr, cscale, Y_RTOL[torch.float32]))
        check_close("shard K7 wy", wd, wdr, ((zw if wv is None else wv).abs() * yr.abs()).sum(),
                    DOT_RTOL[torch.float32])
        check_close("shard K7 yy", yd, ydr, ydr.abs(), DOT_RTOL[torch.float32])
        if not torch.equal(y7, y5):
            raise AssertionError("shard K7: y is not K5's bit for bit")
    torch.cuda.synchronize()
    errs.pop("dia_spmm")
    return {"errs": errs, "r_local": ol.r_local, "h": h,
            "tail_rows": DIST_WORLD * ol.r_local - op.n if rank == DIST_WORLD - 1 else 0}


def _dist_layouts(rank, g, dev):
    """Phase 16 (d) on one rank: Jacobi-BiCGStab on HaloDIA and AllGatherELL
    and ``ca_cg`` (s = 4) on MPKDIA at 32³, with their exchanges counted."""
    import functools

    from sprsolve_tpu_torch import parallel as par
    from sprsolve_tpu_torch.parallel import comm

    tcacg = importlib.import_module("sprsolve_tpu_torch.solvers.ca_cg")
    A = problems.poisson3d(DIST_GRID, DIST_GRID, DIST_GRID)
    dia = DIA.from_csr(A, device="cpu")
    b = np.random.default_rng(SEED + 3).standard_normal(A.shape[0]).astype(np.float32)
    M = spt.DiagPrecond.new(dia.diagonal())
    out = {}
    for name, op in (("halo_dia", dia), ("allgather_ell", A)):
        pd.reset_launch_counts()
        comm.reset_counts()
        x, info = par.distributed_solve(spt.bicgstab, op, b, M=M, tol=1e-4, max_iter=400,
                                        group=g, device=dev)
        cc, its = dist_counts(), int(info.iterations)
        res = true_residual(A, x, b)
        spmvs = 1 + 2 * its
        ok = (cc["halo_exchange"][0] == spmvs and cc["all_gather_rows"][0] == 1) \
            if name == "halo_dia" else \
            (cc["halo_exchange"][0] == 0 and cc["all_gather_rows"][0] == spmvs + 1)
        if not (info.converged and res < 1e-3 and ok and not any(launch_counts().values())):
            raise AssertionError(f"dist {name}: {info}, residual {res:.3e}, {cc}")
        out[name] = {"its": its, "res": res, "comm": cc}
    per_block, inner = [], tcacg.basis_block

    def counted(*a, **k):
        before = comm.halo_exchange.calls
        V = inner(*a, **k)
        per_block.append(comm.halo_exchange.calls - before)
        return V

    A_s, b_s, _, unfold = tcacg.fold_jacobi(A, b)
    tcacg.basis_block = counted
    try:
        x, info = par.distributed_solve(
            functools.partial(spt.ca_cg, s=4, bounds=spt.gershgorin_bounds(A_s)),
            A_s.to_dia(), b_s.numpy(), tol=1e-4, max_iter=400, group=g, device=dev, mpk_s=4)
    finally:
        tcacg.basis_block = inner
    res = true_residual(A, unfold(x.cpu()), b)
    if not (info.converged and res < 1e-3 and per_block and set(per_block) == {1}):
        raise AssertionError(f"dist ca_cg mpk: {info}, residual {res:.3e}, "
                             f"exchanges per block {per_block}")
    out["ca_cg_mpk"] = {"its": int(info.iterations), "res": res, "blocks": len(per_block)}
    return out


def _dist_rank(rank, dev, store, out_dir, ref):
    """One rank of phase 16 (b)-(d): a gloo group with every rank on ``dev``
    (cuda:0), the results pickled into ``out_dir``. Rank 0 loads the kernel
    library before the others."""
    import datetime
    import pickle
    import traceback

    import torch.distributed as dist

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=DIST_WORLD,
                            timeout=datetime.timedelta(seconds=180))
    res = {}
    try:
        if rank == 0 and cuda:
            _cuda_build.load()
        dist.barrier()
        if cuda:
            _cuda_build.load()
        g = dist.group.WORLD
        bands = np.load(os.path.join(out_dir, "bands.npz"))
        dia = DIA(bands=torch.from_numpy(bands["real"]), offsets=tuple(bands["offsets"]),
                  shape=(int(bands["n"]),) * 2)
        damped = DIA(bands=torch.from_numpy(bands["damped"]), offsets=dia.offsets,
                     shape=dia.shape)
        res["solves"] = _dist_solves(rank, g, dev, dia, damped, ref)
        res["kernels"] = _dist_kernels(rank, g, dev, dia, damped)
        res["layouts"] = _dist_layouts(rank, g, dev)
    except Exception:   # reported by the parent, which fails the phase
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()


def phase_dist_gloo(dev):
    """Phase 16 (b)-(d): two gloo ranks on cuda:0 (spawned), 500k rows each."""
    import pickle

    A = problems.poisson3d(GRID, GRID, GRID)
    dia = DIA.from_csr(A, device="cpu")
    damped = damped_dia()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "bands.npz"), real=dia.bands.numpy(),
                 damped=damped.bands.numpy(), offsets=np.array(dia.offsets), n=A.shape[0])
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_dist_rank, args=(r, dev, dist_store(tmp), tmp, RUN_COUNTS))
                 for r in range(DIST_WORLD)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if p.exitcode != 0 or not os.path.exists(path):
                raise AssertionError(f"dist rank {r} exited {p.exitcode}")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    for r, res in enumerate(results):
        if "error" in res:
            raise AssertionError(f"dist rank {r}:\n{res['error']}")
    arrays = damped_csr_arrays()
    b = poisson_rhs(A)
    r_ = np.random.default_rng(SEED + 6).standard_normal(A.shape[0]).astype(np.float32)
    bz = (r_ + 0.25j * r_).astype(np.complex64)
    for name, s0 in results[0]["solves"].items():
        if name == "all_reduce_us":
            continue
        if any(res["solves"][name]["sha"] != s0["sha"] for res in results):
            raise AssertionError(f"dist {name}: the ranks' x differ")
        x = torch.as_tensor(s0["x"])
        res_ = (complex_true_residual(arrays, A.shape, x, bz) if x.is_complex()
                else true_residual(A, x, b))
        if not res_ < 1e-3:
            raise AssertionError(f"dist {name}: true residual {res_:.3e}")
        for r, res in enumerate(results):
            s = res["solves"][name]
            log("dist", part="b", backend="gloo", ranks=DIST_WORLD, rank=r, solver=name,
                iterations=s["its"], true_residual=res_,
                **{f"{k}_launches": v for k, v in s["launches"].items()},
                halo_exchanges=s["comm"]["halo_exchange"][0],
                halo_bytes_sent_per_exchange=s["comm"]["halo_exchange"][1]
                // max(s["comm"]["halo_exchange"][0], 1),
                all_reduce_calls=s["comm"]["all_reduce_sum"][0],
                per_iteration_ms=f"{s['ms_per_iteration']:.4f}", x_bits="identical")
    for r, res in enumerate(results):
        log("dist", part="b", rank=r, gloo_all_reduce_us_cuda_scalar=
            f"{res['solves']['all_reduce_us']:.2f}")
        k = res["kernels"]
        log("dist", part="c", rank=r, r_local=k["r_local"], h=k["h"],
            padded_tail_rows=k["tail_rows"],
            **{f"{name}_max_abs_err": f"{e:.3e}" for name, e in k["errs"].items()},
            result="K1-K7 on the rank's window within phase 3's tolerances; K2/K3 y bitwise "
            "K1's, K6/K7 y bitwise K5's; halos zero")
        for name, s in res["layouts"].items():
            log("dist", part="d", rank=r, layout=name, iterations=s["its"],
                true_residual=s["res"], **({"blocks": s["blocks"],
                                            "exchanges_per_block": 1} if "blocks" in s else
                                           {"halo_exchanges": s["comm"]["halo_exchange"][0],
                                            "all_gathers": s["comm"]["all_gather_rows"][0]}))
    log("dist", part="b-d", wall_s=f"{wall:.2f}",
        note="two ranks share one card: correctness and launch counts, not scaling")


def phase_dist(dev):
    """Phase 16: the distributed layer (a) on one NCCL rank, (b)-(d) on two
    gloo ranks sharing the card, (e) the Krylov family on one NCCL rank."""
    t0 = time.perf_counter()
    phase_dist_nccl(dev)
    phase_dist_gloo(dev)
    phase_dist_krylov(dev)
    log("dist", seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 17: the distributed eigensolvers --------------------------------
# (a)-(c): one NCCL rank at phase 14's widths; (d): two gloo ranks on cuda:0
# at reduced depths (the grid³ Poisson of each driver)
DE_GRIDS = {"lobpcg": GRID, "shift_invert": SI_GRID, "rational": RF_GRID}
DE_GLOO_GRIDS = {"lobpcg": 32, "shift_invert": 16, "rational": 16}
DE_LOBPCG_MAX_ITER = 80     # (a): phase 14 (a)'s unpreconditioned budget
# (d)'s LOBPCG runs until it converges (190 steps at 32³ on one CPU rank) and
# is held to EIGS_TOL: it aims at a fifth of that, so that the f32 rounding
# between its own residual and the f64 one measured here cannot decide the gate
DE_CONVERGE_TOL = EIGS_TOL / 5
DE_CONVERGE_MAX_ITER = 400
# the filter's subspace below 32³ (phase 14 (c)'s 8 from there up): at 16³
# the eigenvalue nearest σ = 1 is 6-fold, and the disc must hold the whole
# cluster with room to spare (m0 = 8 leaves none: the radius calibration
# never settles, on one device as on two ranks)
DE_SMALL_GRID_M0 = 12
# phase 17's processes, from their start (before phase 12) to their end
DE_TIMEOUT_S = 780
# the module settings phase 17's spawned processes take from the one that
# starts them (the CPU test shrinks some)
DE_SETTINGS = ("DE_GRIDS", "DE_GLOO_GRIDS", "DE_LOBPCG_MAX_ITER", "STRICT", "SI_MAX_ITER",
               "SI_INNER_MAX_ITER", "RF_INNER_MAX_ITER")


def de_counts(name: str, its: int, steps: list, passes: int) -> dict:
    """The collectives one rank makes in a distributed eigen run, worked out
    from the code (``tests/torch/test_torch_dist_eigen3.py`` holds them on
    the CPU): ``{primitive: calls}``. ``its``: LOBPCG steps (summed over
    shift-invert's ``passes``); ``steps``: the lockstep iterations of each
    inner block solve; ``passes``: the rational filter's subspace
    iterations. One halo exchange per block apply; LOBPCG 6 all-reduces to
    start and 9 a step, a lockstep MINRES 2 and 2 an iteration, a lockstep
    COCG 3 and 3, a filter pass 5 beside its node solves."""
    if name == "lobpcg":
        return {"all_reduce_sum": 6 + 9 * its, "halo_exchange": 1 + its, "all_gather_rows": 1}
    if name == "shift_invert":
        return {"all_reduce_sum": sum(2 + 2 * s for s in steps) + 6 * passes + 9 * its,
                "halo_exchange": sum(1 + s for s in steps) + 1,
                "all_gather_rows": passes + 1}
    return {"all_reduce_sum": sum(3 + 3 * s for s in steps) + 5 * passes,
            "halo_exchange": sum(1 + s for s in steps) + passes * (1 + RF_NODES * RF_REFINE),
            "all_gather_rows": 1}


def de_run(name: str, grid: int, dev, g=None, converge=False):
    """One distributed eigen driver on the grid³ Poisson (f32, DIA →
    ``HaloDIA``) with phase 14's settings (the filter's m0 from 32³ up,
    else DE_SMALL_GRID_M0; with ``converge``, LOBPCG to DE_CONVERGE_TOL in
    at most DE_CONVERGE_MAX_ITER steps), its inner solves recorded and
    the counters reset just before: ``(A, lam, X, info, steps, collective
    counts, launch counts, wall seconds)``."""
    from sprsolve_tpu_torch import parallel as par
    from sprsolve_tpu_torch.parallel import comm

    A = problems.poisson3d(grid, grid, grid)
    dia = DIA.from_csr(A, device="cpu")
    kw = dict(group=g, device=dev)
    mod = fn = None
    if name == "lobpcg":
        X0 = np.random.default_rng(SEED + 10).standard_normal((A.shape[0], EIGS_K)).astype(
            np.float32)
        tol, max_iter = ((DE_CONVERGE_TOL, DE_CONVERGE_MAX_ITER) if converge
                         else (EIGS_TOL, DE_LOBPCG_MAX_ITER))
        run = lambda: par.distributed_lobpcg(dia, X0=X0, tol=tol, max_iter=max_iter, **kw)
    elif name == "shift_invert":
        mod, fn = eigs_mod, "_minres_block"
        run = lambda: par.distributed_shift_invert_eigs(
            dia, EIGS_K, SIGMA, tol=EIGS_TOL, max_iter=SI_MAX_ITER,
            inner_max_iter=SI_INNER_MAX_ITER, **kw)
    else:
        mod, fn = rat_mod, "_cocg_block"
        run = lambda: par.distributed_rational_filter_eigs(
            dia, EIGS_K, SIGMA, tol=EIGS_TOL, inner_tol=1e-3, inner_max_iter=RF_INNER_MAX_ITER,
            m0=8 if grid >= 32 else DE_SMALL_GRID_M0, n_quad=RF_NODES,
            inner_refine=RF_REFINE, seed=0, **kw)
    steps = []
    orig = recorded(mod, fn, steps) if mod is not None else None
    pd.reset_launch_counts()
    comm.reset_counts()
    try:
        _sync(dev)
        t0 = time.perf_counter()
        lam, X, info = run()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        if mod is not None:
            setattr(mod, fn, orig)
    return A, lam, X, info, steps, dist_counts(), launch_counts(), wall


def de_check(tag, name, grid, A, lam, X, info, steps, cc, c, converge=False) -> dict:
    """The gates of one distributed eigen run: no kernel launched (the
    path is torch ops), finite (n, k) vectors, the collectives exactly
    :func:`de_counts`, and λ as phase 14 holds it (LOBPCG: λ₀ at least the
    analytic 3·(2·sin(π/(2(grid + 1))))²·(1 − tol), as Ritz values bound
    from above; with ``converge`` also CONVERGED, the k smallest analytic
    λ with multiplicity within tol·|λ| and the measured residuals
    ‖A·x − λx‖/(|λ| + max|λ|) within tol; shift-invert and the filter:
    CONVERGED, the analytic λ nearest σ within tol·|λ|, the measured
    residuals within tol). Returns the fields to log."""
    its = int(info.iterations)
    if any(c.values()):
        raise AssertionError(f"{tag}: a kernel launched on the torch-op path: {c}")
    if not (tuple(X.shape) == (A.shape[0], lam.numel()) and lam.numel() <= EIGS_K
            and bool(torch.isfinite(X).all()) and bool(torch.isfinite(lam).all())):
        raise AssertionError(f"{tag}: X {tuple(X.shape)}, λ {lam}")
    fields = {"status": spt.Status(int(info.status)).name, "iterations": its,
              "residual": f"{float(info.residual):.4e}"}
    passes = 2
    if name == "lobpcg":
        l1 = 3 * (2 * np.sin(np.pi / (2 * (grid + 1)))) ** 2
        if not (lam.numel() == EIGS_K and float(lam[0]) >= l1 * (1 - EIGS_TOL)):
            raise AssertionError(f"{tag}: λ₀ {float(lam[0])} below the analytic {l1}")
        fields.update(lam=",".join(f"{v:.7e}" for v in lam.tolist()),
                      lam0_analytic=f"{l1:.7e}")
        if converge:
            lh = lam.cpu().numpy()
            res = pair_residuals(A, lam, X) / (np.abs(lh) + float(np.abs(lh).max()))
            _, exact = match_nearest(lh, grid, 0.0, EIGS_TOL)
            if not (exact and float(res.max()) <= EIGS_TOL
                    and int(info.status) == int(spt.Status.CONVERGED)):
                raise AssertionError(f"{tag}: λ {lh} against "
                                     f"{poisson_eigs_nearest(grid, 0.0, EIGS_K)}, residuals "
                                     f"{res}, {info}")
            fields.update(analytic=",".join(f"{v:.7e}" for v in poisson_eigs_nearest(
                grid, 0.0, EIGS_K)), worst_measured_residual=f"{float(res.max()):.4e}")
    else:
        if name == "shift_invert":
            if len(steps) != its + passes:
                raise AssertionError(f"{tag}: {len(steps)} inner solves for {its} steps")
        else:
            passes, rest = divmod(len(steps), RF_NODES * (1 + RF_REFINE))
            if rest:
                raise AssertionError(f"{tag}: {len(steps)} node solves, not whole passes")
        got = np.sort(lam.cpu().numpy().astype(np.float64))
        res = pair_residuals(A, lam, X) / np.abs(lam.cpu().numpy())
        worst = float(res.max()) if res.size else float("inf")
        ok, exact = match_nearest(got, grid, SIGMA, EIGS_TOL)
        if STRICT and not (ok and got.size == EIGS_K and worst <= EIGS_TOL
                           and int(info.status) == int(spt.Status.CONVERGED)):
            raise AssertionError(f"{tag}: λ {got} against "
                                 f"{poisson_eigs_nearest(grid, SIGMA, EIGS_K)}, residuals "
                                 f"{res}, {info}")
        fields.update(lam=",".join(f"{v:.7e}" for v in got),
                      analytic=",".join(f"{v:.7e}" for v in poisson_eigs_nearest(
                          grid, SIGMA, EIGS_K)),
                      nearest_within_tol=ok, nearest_with_multiplicity=exact,
                      worst_measured_residual=f"{worst:.4e}",
                      lockstep_iterations=sum(steps), inner_solves=len(steps))
        if name == "rational":
            fields["subspace_iterations"] = passes
    want = de_counts(name, its, steps, passes)
    calls = {p: cc[p][0] for p in want}
    if calls != want:
        raise AssertionError(f"{tag}: collectives {calls}, expected {want}")
    fields.update({f"{p}_calls": v for p, v in calls.items()})
    return fields


def _dist_eigen_nccl(dev, store, out_dir, settings):
    """Phase 17 (a)-(c) in a spawned process: each distributed eigen driver
    at phase 14's width on one rank under NCCL (gloo off the card), its
    gates (:func:`de_check`), count and wall pickled into ``out_dir`` for
    the parent, which holds the counts to phase 14's; and the µs of one
    all-reduce of a 12×12 Gram matrix."""
    import pickle
    import traceback

    import torch.distributed as dist

    from sprsolve_tpu_torch.parallel import comm

    globals().update(settings)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(2)   # beside the parent and (d)'s ranks on the host's cores
    backend = "nccl" if dev.type == "cuda" else "gloo"
    res = {"backend": backend, "parts": []}
    try:
        dist.init_process_group(backend, init_method=store, rank=0, world_size=1)
        try:
            for part, (name, grid) in zip("abc", DE_GRIDS.items()):
                A, lam, X, info, steps, cc, c, wall = de_run(name, grid, dev)
                fields = de_check(f"dist-eigen ({part}) {name}", name, grid, A, lam, X, info,
                                  steps, cc, c)
                res["parts"].append((part, name, grid, int(info.iterations), sum(steps), wall,
                                     fields))
            G = torch.ones((3 * EIGS_K, 3 * EIGS_K), device=dev)
            g = dist.group.WORLD
            res["all_reduce_us"] = (dist_call_us(lambda: comm.all_reduce_sum(G, g))
                                    if dev.type == "cuda" else None)
        finally:
            dist.destroy_process_group()
    except Exception:   # reported by the parent, which fails the phase
        res["error"] = traceback.format_exc()
    finally:
        res["t_end"] = time.time()
        with open(os.path.join(out_dir, "nccl.pkl"), "wb") as f:
            pickle.dump(res, f)


def _dist_eigen_rank(rank, dev, store, out_dir, settings):
    """One rank of phase 17 (d): a gloo group with every rank on ``dev``,
    each driver on its grid of DE_GLOO_GRIDS (LOBPCG to convergence), its
    λ, X bits (rank 0 also X), info, inner steps and counts pickled into
    ``out_dir``."""
    import datetime
    import hashlib
    import pickle
    import traceback

    import torch.distributed as dist

    globals().update(settings)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(2)   # two ranks on the host's cores
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=DIST_WORLD,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    try:
        for name, grid in DE_GLOO_GRIDS.items():
            _, lam, X, info, steps, cc, c, wall = de_run(name, grid, dev, dist.group.WORLD,
                                                         converge=True)
            Xh = X.cpu().numpy()
            res[name] = {"lam": lam.cpu().numpy(), "sha": hashlib.sha256(Xh.tobytes()).hexdigest(),
                         "X": Xh if rank == 0 else None,
                         "info": (int(info.iterations), float(info.residual), int(info.status)),
                         "steps": steps, "comm": cc, "launches": c, "wall": wall}
    except Exception:   # reported by the parent, which fails the phase
        res["error"] = traceback.format_exc()
    finally:
        res["t_end"] = time.time()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()


@dataclasses.dataclass
class DistEigenRun:
    """Phase 17's spawned processes (``procs[0]`` (a)-(c), the rest (d)'s
    ranks), the directory they write their results to, and their start."""
    procs: list
    tmp: tempfile.TemporaryDirectory
    t0: float
    t_start: float

    def stop(self) -> None:
        """Kill what still runs and remove the directory (idempotent)."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        self.tmp.cleanup()


def start_dist_eigen(dev) -> DistEigenRun:
    """Phase 17 started: (a)-(c)'s NCCL rank and (d)'s DIST_WORLD gloo
    ranks spawned on ``dev``, each given this module's DE_SETTINGS (a
    spawned process imports the module afresh). They run beside whatever
    the caller does next; :func:`phase_dist_eigen` joins and checks them,
    and the caller stops them if it fails before that."""
    settings = {k: globals()[k] for k in DE_SETTINGS}
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.TemporaryDirectory()
    stores = [os.path.join(tmp.name, s) for s in ("nccl", "gloo")]
    for s in stores:
        os.mkdir(s)
    procs = [ctx.Process(target=_dist_eigen_nccl,
                         args=(dev, dist_store(stores[0]), tmp.name, settings))]
    procs += [ctx.Process(target=_dist_eigen_rank,
                          args=(r, dev, dist_store(stores[1]), tmp.name, settings))
              for r in range(DIST_WORLD)]
    run = DistEigenRun(procs, tmp, time.perf_counter(), time.time())
    try:
        for p in procs:
            p.start()
    except BaseException:
        run.stop()
        raise
    return run


def dist_eigen_results(run: DistEigenRun) -> tuple:
    """Joins phase 17's processes (all of them within DE_TIMEOUT_S of their
    start; one still running then is killed and fails the phase): ``((a)-(c)'s
    result, [each (d) rank's result])``."""
    import pickle

    try:
        for p in run.procs:
            p.join(timeout=max(1.0, DE_TIMEOUT_S - (time.perf_counter() - run.t0)))
        out = []
        for p, name in zip(run.procs, ["nccl"] + [f"rank{r}" for r in range(DIST_WORLD)]):
            path = os.path.join(run.tmp.name, f"{name}.pkl")
            if p.exitcode != 0 or not os.path.exists(path):
                raise AssertionError(f"dist-eigen {name} exited {p.exitcode}")
            with open(path, "rb") as f:
                out.append(pickle.load(f))
    finally:
        run.stop()
    for name, res in zip(["(a)-(c)"] + [f"rank {r}" for r in range(DIST_WORLD)], out):
        if "error" in res:
            raise AssertionError(f"dist-eigen {name}:\n{res['error']}")
    return out[0], out[1:]


def log_dist_eigen_nccl(res: dict) -> None:
    """Phase 17 (a)-(c)'s lines, each count held to the band of phase 14's
    run of the same driver on the same grid (LOBPCG's steps, shift-invert's
    lockstep iterations), its ms per step or per lockstep iteration beside
    phase 14's."""
    for part, name, grid, its, n, wall, fields in res["parts"]:
        tag = f"dist-eigen ({part}) {name}"
        ref = RUN_COUNTS.get(name)   # phase 14's run of the same driver: (grid, ...)
        if name == "lobpcg":
            fields["ms_per_step"] = f"{wall / max(its, 1) * 1e3:.4f}"
            if ref is not None and ref[0] == grid:
                if abs(its - ref[1]) > parity_band(ref[1]):
                    raise AssertionError(f"{tag}: {its} steps against phase 14's {ref[1]}")
                fields.update(phase14_iterations=ref[1], phase14_lam0=f"{ref[2]:.7e}",
                              phase14_ms_per_step=f"{ref[3]:.4f}")
        else:
            fields["ms_per_lockstep_iteration"] = f"{wall / max(n, 1) * 1e3:.4f}"
            if ref is not None and ref[0] == grid:
                if name == "shift_invert" and abs(n - ref[2]) > parity_band(ref[2]):
                    raise AssertionError(f"{tag}: {n} lockstep iterations against "
                                         f"phase 14 (b)'s {ref[2]}")
                fields.update(phase14_lockstep_iterations=ref[2],
                              phase14_ms_per_lockstep_iteration=f"{ref[3]:.4f}")
        log("dist-eigen", part=part, backend=res["backend"], ranks=1, driver=name,
            grid=f"{grid}^3", wall_s=f"{wall:.4f}", **fields)
    us = res["all_reduce_us"]
    log("dist-eigen", part="a-c", backend=res["backend"],
        all_reduce_us_gram_12x12="not measured" if us is None else f"{us:.2f}")


def log_dist_eigen_gloo(results: list, t_start: float) -> None:
    """Phase 17 (d)'s lines: every rank's λ, X bits and info the same, λ
    as (a)-(c) hold it and LOBPCG converged, each rank's collectives as
    :func:`de_counts`; its wall from the start to the last rank's end."""
    from sprsolve_tpu_torch.errors import SolveInfo

    for name, grid in DE_GLOO_GRIDS.items():
        s0 = results[0][name]
        for r, res in enumerate(results):
            s = res[name]
            if (s["lam"].tobytes(), s["sha"], s["info"]) != (s0["lam"].tobytes(), s0["sha"],
                                                             s0["info"]):
                raise AssertionError(f"dist-eigen (d) {name}: rank {r} differs from rank 0")
        A = problems.poisson3d(grid, grid, grid)
        its, res_, status = s0["info"]
        info = SolveInfo(iterations=its, residual=res_, status=status)
        for r, res in enumerate(results):
            s = res[name]
            fields = de_check(f"dist-eigen (d) {name} rank {r}", name, grid, A,
                              torch.as_tensor(s0["lam"]), torch.as_tensor(s0["X"]), info,
                              s["steps"], s["comm"], s["launches"], converge=True)
            log("dist-eigen", part="d", backend="gloo", ranks=DIST_WORLD, rank=r, driver=name,
                grid=f"{grid}^3", wall_s=f"{s['wall']:.4f}", bits="identical", **fields)
    log("dist-eigen", part="d", wall_s=f"{max(res['t_end'] for res in results) - t_start:.2f}",
        note="two ranks share one card: correctness and collective counts, not scaling")


def phase_dist_eigen(dev, run: DistEigenRun | None = None):
    """Phase 17: the distributed eigensolvers. ``run``: its processes as
    :func:`start_dist_eigen` started them (the script starts them before
    phase 12, so that they run beside phases 12-14); without it they are
    started here and waited for. Their results are checked here, after
    phase 14, whose counts (a)-(c) are held to."""
    run = run or start_dist_eigen(dev)
    nccl, ranks = dist_eigen_results(run)
    log_dist_eigen_nccl(nccl)
    log_dist_eigen_gloo(ranks, run.t_start)
    log("dist-eigen", seconds=f"{time.perf_counter() - run.t0:.2f}",
        processes_wall_s=f"{max(r['t_end'] for r in [nccl] + ranks) - run.t_start:.2f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = _cuda_build.load()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        library=_cuda_build.library_path().name,
        row_tile=lib.sprsolve_dia_row_tile())
    assert lib.sprsolve_dia_row_tile() == pd.ROW_TILE
    assert lib.sprsolve_dia_max_diags() == pd.MAX_DIAGS
    assert lib.sprsolve_dia_dots_tile() == pd.DOT_TILE
    assert lib.sprsolve_dia_spmm_threads() == pd.SPMM_TILE
    assert lib.sprsolve_dia_dots_scratch_head() == pd.DOT_SCRATCH_HEAD
    assert lib.sprsolve_orth_norm_tile() == pd.DOT_TILE
    assert lib.sprsolve_cg_tile() == pd.DOT_TILE
    assert lib.sprsolve_csm_tile() == pd.COMPLEX_DOT_TILE
    assert lib.sprsolve_csm_slots() == fused.CSM_SLOTS
    assert all(lib.sprsolve_orth_norm_blocks_per_sm(pd._VCODE[dt]) == pd.DOT_BLOCKS_PER_SM[dt]
               for dt in pd.REAL_DTYPES)
    assert lib.sprsolve_dia_complex_dots_tile() == pd.COMPLEX_DOT_TILE
    assert all((lib.sprsolve_dia_complex_dots_blocks_per_sm if dt.is_complex
                else lib.sprsolve_dia_dots_blocks_per_sm)(pd._VCODE[dt]) == b
               for dt, b in pd.DOT_BLOCKS_PER_SM.items())

    errs, _, stats = phase_kernels(dev)
    phase_cg_fused(dev)
    phase_gs_color(dev)
    phase_csm_fused(dev)
    phase_spmm(dev, errs, stats)
    phase_complex_kernels(dev, errs, stats)
    launches = phase_slice(dev)
    phase_f64(dev)
    # each path's kernels read their counts from that path's own run
    launches.update({k: v for k, v in phase_symmetric(dev).items()
                     if k in ("dia_dot", "orth_norm")})
    phase_f64_symmetric(dev)
    phase_nonsymmetric(dev)
    launches.update(phase_complex(dev))
    phase_c128(dev)
    phase_config4(dev, launches["dia_wdot"] // 2)
    phase_relayed(dev)
    phase_exact_and_lsqr(dev)
    # phase 17's processes run beside phases 12-14 (their host analysis and
    # lockstep loops leave the card and most cores idle) and are checked
    # after phase 14, before phase 15's timer comparison
    dist_eigen = start_dist_eigen(dev)
    try:
        phase_layouts(dev)
        phase_krylov(dev)
        launches["dia_spmm"] = phase_eigen(dev)
        phase_dist_eigen(dev, dist_eigen)
    finally:
        dist_eigen.stop()
    phase_front(dev, k1_stats=stats["dia_spmv"])
    phase_dist(dev)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         **{k: stats[name][k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
         "share": stats[name]["bound_ms"] / stats[name]["ms"],
         "cold_share": stats[name]["bound_ms"] / stats[name]["cold_ms"]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
