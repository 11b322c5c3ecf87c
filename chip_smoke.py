#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MNIST Neural-ODE, latent-ODE, FFJORD, MNIST
Neural-SDE and toy 2-D SDE training steps on one GPU, on the step kernels
and on the whole solve, the MNIST Neural ODE with per-sample adaptive
stepping, and on ``odeint``'s generic engine with the tuple trial step;
K15, the whole-solve feature probe; and the weight-cotangent contraction
that ends K2, K4, K12 and K14.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and ``nvcc``; the
kernels are built from ``regneuralde_tpu_torch/csrc`` into ``build/kernels/``
at first use. Phases (each checks its results; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), versions, kernel build;
2. K1 and K2 (the normed Tsit5 step kernels; K1 one trial step of the
   MLPDynamics whole solve's stages, ``csrc/mlp_step_solve.cuh`` with the
   norm sums as its end; K2 one trial step of its reverse walk,
   ``csrc/mlp_step_walk.cuh``) against their plain PyTorch versions at
   B=512, D=784, H=100, at rtol=atol=1e-4 and 1.4e-8, both bitwise
   deterministic, K1's y_new and k7 bitwise K13's on the same inputs, K2
   also within 3 times the plain version's distance from a float64 walk,
   with CUDA-event times of both; their device time (K1's kernel, K2's and
   the contraction, ``torch.profiler``), tile plan and ``grid.sync()``
   count a launch;
3. one forward+backward of the training step at full width (rtol=atol=1e-5),
   step kernels (``fused="step"``) against the plain path (``fused=False``):
   identical NFE and accept sequence, relative gradient error <= 1e-3, and
   the step kernels' launches;
4. three training steps of the flagship configuration (Tsit5 at
   rtol=atol=1.4e-8, max_steps=96, batch 512, CE + 100 * error_estimate,
   InvDecay(1e-5) then Momentum(0.1, 0.9)) on ``fused="step"``, with the
   step kernels' launch counts (each K2 ends in one launch of the
   weight-cotangent contraction, phase 31, as do K4, K12 and K14), and the
   NFE and accepts of the same three steps on ``fused=False`` beside them
   (printed, not compared: at 1.4e-8 the error estimate sits at its float32
   floor, where the routes' trial steps follow their rounding);
5. the whole-solve kernels K3/K4 against their plain versions at
   512x784x100 on seeded random weights and inputs: K3's streamed stage
   residuals (``ks``/``hs``) of every trial step, teacher-forced, within
   FWD_BOUND of the plain capture; K4 on the stream bitwise equal to K4
   replaying the stages (``cache_residuals=False``), with y1's cotangent
   alone and with the telemetry's too; CUDA-event times of the forward
   solve and the backward walk, streamed and replaying; K3's and K4's
   device time under ``torch.profiler`` (the forward, ``csrc/mlp_solve.cuh``;
   the walk, ``csrc/mlp_walk.cuh``, and the contraction after it), their
   tile plan and their ``grid.sync()`` count a solve;
6. phase 3 for the whole solve: ``fused=True`` against ``fused=False``;
7. phase 4 on ``fused=True``: one forward and one backward launch per step,
   no step-kernel launch;
8. K7 and K8 (the AlternatingMLP trial-step kernels) against their plain
   versions at B=256, D=20, H=50, depth 4, at rtol=atol=1e-4 and 1.4e-8,
   bitwise determinism, and CUDA-event times of both; K8's grid (2-row
   tiles, one wave) and device time, its kernel and its slot sum apart;
9. one forward+backward of the latent-ODE training step at full width
   (rtol=atol=1e-5), ``fused="step"`` against ``fused=False``: identical NFE
   and accept sequence, gradient bounds as in phase 3;
10. three training steps of the latent ODE of ``bench.py:139-210``
   (``LatentGRU(37, 40, 50)``, ``MLP((50, 40))``, ``AlternatingMLP(20, 50,
   4)``, ``Dense(37)``, batch 256, 49 ``saveat`` stamps, Tsit5 at
   rtol=atol=1.4e-8, max_steps=256, masked Gaussian log-likelihood + KL +
   1e3 * error_estimate, InvDecay(1e-5) then AdaMax(0.01)) on
   ``fused="step"``: one K7 and one K8 launch per trial step;
11. the whole-solve kernels K3/K4 for AlternatingMLP with the 49 saves
   against their plain versions at 256x20x50x4, at rtol=atol=1e-5 and
   1.4e-8: the same steps and save cursors, y1 and the saves within 1e-6,
   every stored trial step's norm sums and rows bitwise equal to K7's and
   its controller bitwise equal to ``ode._post`` on the card, K4 within
   BWD_BOUND (TEL_BWD_BOUND with the telemetry's cotangents) of its plain
   version and within 3 times the plain version's distance from a
   float64 walk, bitwise determinism, CUDA-event times of both; K4's
   device time a solve at 1.4e-8;
12. the MLPDynamics whole solve with 5 saves against its plain version at
   64x40x24 (the save cursor on the other instantiation), and K4 on the
   stream bitwise equal to K4 replaying the stages;
13. phase 9 on the whole solve: ``fused=True`` against ``fused=False``;
14. phase 10 on ``fused=True``: one launch of each whole-solve kernel per
   step and no step kernel; each step's NFE and accept sequence equal to
   ``fused="step"``'s from the same weights and batch;
15. K7-CSL and K8-CSL (FFJORD's CSL trial-step kernels) against their plain
   versions at 1024x44x100 (and 1024x46 with the kinetic terms), at
   rtol=atol=1e-5 and 1.4e-8: K7-CSL's rows bitwise equal and its norm sums
   bitwise equal to the plain terms summed in the kernel's order, K8-CSL
   within BWD_BOUND, bitwise determinism, CUDA-event times; K8-CSL's
   grid (8-row tiles, one wave) and device time, its kernel and its slot
   sum apart;
16. K3/K4 with the CSL tile bodies against their plain versions on a
   MiniBooNE batch and its probe, as phase 11 (every stored trial step
   bitwise K7-CSL's, K4 against the plain version and a float64 walk), at
   1e-1 (with the eest telemetry's cotangent alone seeded too), 1e-5 and
   1.4e-8; K4-CSL's device time a solve at 1.4e-8;
17. one forward+backward of FFJORD's training step at rtol=atol=1e-5 on
   ``fused="step"`` and on ``fused=True``, each against ``fused=False``;
18. three training steps of FFJORD's tabular configuration
   (``CSLDynamics(43, 100)``, batch 1024 of the MiniBooNE surrogate, Tsit5
   at rtol=atol=1.4e-8, max_steps=128, -mean(logpx) + 5e3 *
   error_estimate, WeightDecay(1e-5) then Adam(1e-2)) on ``fused="step"``
   and on ``fused=True`` (one K3-CSL and one K4-CSL launch a step, no other
   kernel), each ``fused=True`` step with the NFE and accept sequence of
   ``fused="step"`` from the same weights, and the ms a step of both;
19. K9 and K10 (the SDE whole solve) against their plain versions at the
   MNIST NSDE width (512 x 32, drift 32-64-32, diffusion 32-32, SOSRI2) at
   rtol=atol=1.4e-1 and at 1.4e-2 (tens of trial steps with rejections, 5
   saves): the same accept sequence, y1 and ys within 1e-5, K10 within
   BWD_BOUND / TEL_BWD_BOUND of its plain version and against a float64
   walk, bitwise determinism, CUDA-event times;
20. one MNIST NSDE training step on ``fused=True`` against ``fused=False``
   on the same weights and draws, for the stiff_est (SOSRI2) and error_est
   (SOSRI) objectives: the same NFE and accepts, the task gradient within
   GRAD_BOUND, the regularized one within REG_GRAD_BOUND;
21. three training steps of the MNIST NSDE configuration
   (``experiments/mnist_nsde.py``: batch 512, SOSRI2 at rtol=atol=1.4e-1,
   max_steps 128, CE + 0.1 * stiffness_estimate, InvDecay(1e-5) then
   Adam(0.01)) on ``fused=True``: one K9 and one K10 launch a step and no
   other kernel, NFE, accepts and ms a step;
22. K11 and K12 (the lane-wise Tsit5 step of the per-sample engine: K11
   one trial step of the MLPDynamics whole solve's stages at per-row times,
   rounded as its plain version, ``csrc/mlp_step_solve.cuh`` with the lane
   end; K12 one trial step of its reverse walk, ``csrc/mlp_step_walk.cuh``)
   against their plain versions at 512x784x100 with per-lane (t, dt) and
   finished lanes: K11 within FWD_BOUND (and which outputs are bitwise the
   plain version's), K12 within BWD_BOUND, against a float64 walk and
   against its schedule, bitwise determinism, CUDA-event times, both
   kernels' device time, their plan and ``grid.sync()`` count;
23. one forward+backward of the per-sample flagship step
   (``per_sample="batched"``) at rtol=atol=1e-5, ``fused=True`` against
   ``fused=False``, with a scalar t1 and with a per-lane STEER t1: identical
   per-lane NFE and accept sequences, gradients as in phase 3;
24. three training steps of the per-sample flagship at rtol=atol=1.4e-8 on
   ``fused=True``: one K11 and one K12 launch an engine iteration and no
   other kernel; per-lane NFE, success fraction and ms a step; then the
   lanes whose NFE or accepts differ between ``fused=True`` and ``False``
   in a forward from the trained weights (reported);
25. K13 and K14 (the tuple Tsit5 step of ``odeint``'s generic engine: K13
   one trial step of the MLPDynamics whole solve's stages,
   ``csrc/mlp_step_solve.cuh``; K14 one trial step of its reverse walk,
   ``csrc/mlp_step_walk.cuh``) against their plain versions at
   512x784x100, t = 0.3 and dt in {0.05, 0.3}: K13's rows within FWD_BOUND
   (the error row, a cancellation, within TUPLE_ERR_BOUND) and K14 within
   BWD_BOUND, both also against a float64 walk, bitwise determinism,
   CUDA-event times; K13's and K14's device time (K14's kernel and the
   contraction apart, ``torch.profiler``), their tile plan and
   ``grid.sync()`` count a launch;
26. one forward+backward of the flagship step at rtol=atol=1e-5 with the
   solve through ``odeint(clf.node._func, x, 0, 1, leaves,
   stage_sweep=mlp_dynamics_stage_sweep)``, in ``mode="adjoint"`` (the
   replay adjoint) and ``"scan"``, each against the plain version of K13:
   identical NFE and accepts, gradients as in phase 3, the scan's forward
   bitwise the adjoint's; the NFE of ``fused="step"`` on the same weights
   (reported); one forward+backward of ``NeuralODE(solver="dopri5")`` and
   ``"bosh3"`` (success, finite gradients, NFE);
27. three flagship training steps at 1.4e-8 with the solve through K13
   under the replay adjoint: K13 launched twice a trial step (forward and
   replay), K14 once, no other kernel; NFE and ms a step; then one step on
   ``mode="scan"`` (K13 twice a trial step with the checkpoint's
   recompute, K14 once);
28. K15 (``csrc/spike_wholesolve.cu``): ``tools/torch_spike_wholesolve.py``
   as its main path (one launch, checked there against the plain version),
   then the kernel against its plain version at 32x20 (JAX's size) and
   512x784 for t0 in {0, 0.1, 0.9, -5} (the last stops at the 16-row
   cap): the same iteration count, y1 and tel within SPIKE_TOL, the
   history rows bitwise, run-to-run bitwise, CUDA-event and device times;
29. K9/K10 with the cubic tile body (``csrc/sri_cubic.cuh``) against their
   plain versions at the toy's 100x2x50 with 30 saves, at rtol=atol=3e-1
   and TOY_TIGHT_TOL (with rejections): as phase 19, and every stored
   trial step teacher-forced from K9's own start row;
30. three training steps of the toy 2-D SDE fit (``training.sde_toy``,
   ``experiments/configs/sde_toy.yml``: 100 trajectories, 30 saves, SOSRI
   at 3e-1, max_steps 256, AdaBelief(0.01)) on ``fused=False`` and on
   ``fused=True`` from the same weights on the same draws: one cubic K9
   and one cubic K10 launch a step on ``True`` and no other kernel, none
   on ``False``; step by step the same NFE and accepts, the loss within
   1e-5 and the gradient within GRAD_BOUND; ms a step of both;
31. the weight-cotangent contraction (``csrc/weight_cotangents.cu``: K
   split into chunks, the chunks summed in a fixed order) alone on seeded
   random rows at 784x100, at K = 6 * 512 (K2's, K12's and K14's rows) and
   6 * 512 * 33 (K4's at the flagship's 33 trial steps): within 3 times the
   float32 ``torch.mm``'s distance from the float64 product plus 1e-7,
   bitwise deterministic, CUDA-event times of the kernel, its plain version
   and ``torch.mm`` (TF32 off), the record's ``library_ms``.

Each line of the kernels' JSON record gives the kernel's launches on its
main path (phases 4, 7, 10, 14, 18, 21, 24, 27, 28 and 30; the contraction's
on phases 4, 7, 24 and 27), its time and its plain version's
(CUDA events, median of 7), and its bound: the larger of its float32 operations
over the card's f32 rate and its bytes over the memory rate. The last two
lines of standard output are the kernels' JSON record and the device
record ``{"ok": true, "device": {...}}``.
"""

import json
import re
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH, DIM, HIDDEN = 512, 784, 100
FLAGSHIP_TOL = 1.4e-8
MAX_STEPS = 96
LATENT_BATCH, LATENT_OBS, LATENT_DIM, LATENT_HIDDEN, LATENT_DEPTH = 256, 37, 20, 50, 4
LATENT_MAX_STEPS = 256
LATENT_SIGMA, LATENT_REG = 0.01, 1e3
FFJORD_BATCH, FFJORD_DIM, FFJORD_HIDDEN = 1024, 43, 100
FFJORD_MAX_STEPS = 128
FFJORD_DATA_SEED = 3021  # experiments/configs/ffjord_tabular.yml
FFJORD_REG = 5e3  # reg.exp_decay_schedule(5e3, 1e3, 500)(0), checked in main
NSDE_BATCH, NSDE_DIM, NSDE_HIDDEN = 512, 32, 64
NSDE_TOL, NSDE_MAX_STEPS = 1.4e-1, 128  # experiments/configs/mnist_nsde.yml
NSDE_TIGHT_TOL = 1.4e-2  # tens of trial steps, with rejections (phase 19)
# regularizer: (solver, weight), experiments/mnist_nsde.py
NSDE_REGS = {"stiff_est": ("sosri2", 0.1), "error_est": ("sosri", 10.0)}
NSDE_FWD_BOUND = 1e-5
FWD_BOUND, BWD_BOUND, GRAD_BOUND, REG_GRAD_BOUND = 1e-4, 1e-3, 1e-3, 5e-2
# K13's error row against its plain version (phase 25): the row is the
# cancellation dt * sum(btilde_i (k_i - k1)), so the stages' rounding
# differences come out relatively larger than FWD_BOUND allows; about 3
# times the worst reading on the H100 (1.04e-4 at dt = 0.05).
TUPLE_ERR_BOUND = 3e-4
# K4 against its plain version with the telemetry's cotangents seeded, on
# every output but ct_f0: about 9 times the worst reading on the H100
# (1.1e-3, the time scalars of phase 11 at 1.4e-8 and cb1 of phase 5).
TEL_BWD_BOUND = 1e-2
# ct_f0 of K4 for MLPDynamics with y1's cotangent alone, against float64
# (phase 5, rtol=atol=1e-4): the error estimate sits at its float32 floor
# on that solve, and float32 reverse walks over one record that differ only
# in their order of summation (the plain walk, the plain walk in K4's order,
# K4) lie from float64 by 5.1e-6 to 8.9e-5 on the H100 over 8 cotangent
# seeds, the worst the plain walk's own (tools/torch_f0_orders.py); above
# the worst reading.
F0_ORDER_BOUND = 1e-4
# The same for K4-CSL at rtol=atol=1.4e-8 (phase 16; TEL_BWD_BOUND at
# 1e-5), where FFJORD's error estimate sits at its float32 floor: the sound
# kernel reads 7.4e-2 there (the time scalars; 4.6e-3 at 1e-5), a planted
# fault that drops the error norm's share of ct_dt 1.79 (6.9e-2 at 1e-5), on
# the H100 (tools/torch_csl_fault_probe.py).
CSL_TEL_BWD_BOUND = 0.15
# K4-CSL at rtol=atol=1e-1, where the cotangent of the error norm's
# max(|y|, |y_new|) carries a factor rtol far above float32 rounding, with
# the eest telemetry's cotangent alone seeded (with y1's too, that term is
# ~1e-6 of the outputs at any tolerance): the sound kernel reads 1.5e-4
# there, a planted fault that drops the y_new side of the max 9.6e-2 and one
# that drops the error norm's share of ct_dt 0.10, on the H100
# (tools/torch_csl_fault_probe.py --tols 1e-3,1e-2,1e-1).
CSL_LOOSE_TOL, CSL_LOOSE_BWD_BOUND = 1e-1, 3e-3
# phase 16's tolerances and the limit of K4-CSL against its plain version
# with the telemetry's cotangents seeded
CSL_K4_CASES = {CSL_LOOSE_TOL: CSL_LOOSE_BWD_BOUND, 1e-5: TEL_BWD_BOUND,
                FLAGSHIP_TOL: CSL_TEL_BWD_BOUND}
WS_CTRL_BOUND = 1e-5
REPS = 7  # timed runs per kernel (median), after two warm-up runs
# NVIDIA H100 SXM data sheet: dense f32 rate outside the tensor cores, HBM
# bandwidth. A kernel's bound is the larger of its f32 operations over the
# rate and its bytes (each input read once, each output written once) over
# the bandwidth.
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12


def _bound(nbytes, flops):
    """The least time the card could take, in ms, and what bounds it."""
    t_ops = flops / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _mlp_work(B, D, H):
    """K1's and K2's f32 operations and the leaves' floats at B x D x H:
    six stages of two (B x D x H) products forward; backward the recompute
    and, per stage, the two input cotangents and two weight cotangents.
    K4 on the stage residuals' stream does the backward less the recompute
    (48 B D H a trial step)."""
    leaf = H * (D + 1) + H + D * (H + 1) + D
    return 6 * 4 * B * D * H, 72 * B * D * H, leaf


def _altmlp_work(B, D, H, depth):
    """K7's and K8's operations at B x D x H x depth and the leaves' floats:
    six stages of 2 * depth (B x D x H) products forward; backward the
    recompute and, per layer, the input and the weight cotangents. The
    function is float32 (the TPU kernels'); that the port sums each affine
    map in float64 is its own choice and does not enter the bound."""
    fwd = 6 * 4 * depth * B * D * H
    return fwd, 3 * fwd, depth * (2 * H * D + H + D)


def _counters():
    """The modules whose wrappers count their kernels' launches."""
    from regneuralde_tpu_torch.ops import fused_csl as fc
    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw
    from regneuralde_tpu_torch.ops import spike_wholesolve as sp
    from regneuralde_tpu_torch.ops import weight_cotangents as wc
    from regneuralde_tpu_torch.ops import whole_solve as ws

    return fg, fm, ws, fc, sw, fl, sp, wc


def _check(ok, what):
    """A failed check ends the run with a non-zero exit (kept under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _rel(a, b):
    import torch

    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


def _time_ms(fn):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_classifier(tol, fused, device, seed=SEED, max_steps=MAX_STEPS, per_sample=False):
    import torch

    from regneuralde_tpu_torch.models import ClassifierNODE, MLPDynamics, NeuralODE

    gen = torch.Generator().manual_seed(seed)
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device=device, generator=gen),
                     tspan=(0.0, 1.0), rtol=tol, atol=tol,
                     max_steps=max_steps, fused=fused, per_sample=per_sample)
    return ClassifierNODE(None, node, torch.nn.LazyLinear(10, device=device)), gen


def mnist_loss(clf, x, y, reg_weight=100.0, **node_kwargs):
    """CE + reg_weight * error_estimate(mean), the regularized MNIST
    objective (reg_weight 100 in training); ``node_kwargs`` go to the node
    (a per-lane ``tspan``)."""
    import torch

    from regneuralde_tpu_torch import reg

    out = clf(x, **node_kwargs)
    ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
    return ce + reg_weight * reg.error_estimate(out.telemetry, "mean"), out


def synthetic_batches(n, device):
    import torch

    from regneuralde_tpu_torch.data import load_mnist

    train, _ = load_mnist(BATCH, flatten=True, seed=SEED)
    out = []
    for xb, yb in train:
        if xb.shape[0] == BATCH:
            out.append((torch.as_tensor(xb, device=device),
                        torch.as_tensor(yb, device=device)))
        if len(out) == n:
            return out
    raise AssertionError(f"the loader gave fewer than {n} full batches")


def phase_kernels(device):
    """K1/K2 against their plain versions on random inputs from a seed.

    Random k1 (not f(t, y)) keeps the embedded error far above float32
    rounding, so the three norm sums are compared, not rounding noise. K1
    (``csrc/mlp_step_solve.cuh`` with the norm sums as its end) is held to
    FWD_BOUND, its distance from the float64 plain version printed beside
    the plain version's; checked bitwise deterministic, and its y_new and k7
    bitwise K13's on the same inputs (K2 replays K13's stages, so it
    differentiates K1's). K2 (``csrc/mlp_step_walk.cuh`` with the normed
    seeds) is also held, at both tolerances, within 3 times the plain
    version's distance from the float64 plain version, plus 1e-6: ct_t,
    whose terms cancel, with float32's unit roundoff times its terms'
    magnitudes (the stages' ``ct_pre2 w2t`` and ``ct_pre1 w1t``) as its
    slack; checked bitwise deterministic. Their device time under
    ``torch.profiler`` (K1's kernel; K2's and the weight-cotangent
    contraction after it), their tile plan and their ``grid.sync()`` count a
    launch are printed."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws

    gen = torch.Generator().manual_seed(SEED + 1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = [rnd(HIDDEN, DIM + 1, scale=(DIM + 1) ** -0.5), rnd(HIDDEN, scale=0.1),
              rnd(DIM, HIDDEN + 1, scale=(HIDDEN + 1) ** -0.5), rnd(DIM, scale=0.1)]
    y, k1 = rnd(BATCH, DIM, scale=0.5), rnd(BATCH, DIM, scale=0.3)
    t = torch.tensor(0.07, device=device)
    dt = torch.tensor(0.11, device=device)
    cts = [rnd(BATCH, DIM), rnd(BATCH, DIM), torch.tensor(0.7, device=device),
           torch.tensor(1.3, device=device), torch.tensor(-0.4, device=device)]
    names_f = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]
    names_b = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
    parts = fm._split_params(*leaves)
    d = lambda x: x.double()
    parts64 = [d(x) for x in parts]
    flat = lambda g: [*g[:4], *g[4]]
    for tol in (1e-4, FLAGSHIP_TOL):
        kf = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
        pf = fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)
        pf64 = fm._reference_normed_sweep(d(t), d(dt), d(y), d(k1), parts64, tol, tol)
        kb = flat(fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol))
        pb = flat(fm._normed_bwd_math(t, dt, y, k1, parts, cts, tol, tol))
        rows64 = []
        pb64 = flat(fm._normed_bwd_math(d(t), d(dt), d(y), d(k1), parts64,
                                        [d(c) for c in cts], tol, tol, rows=rows64))
        # the magnitudes of ct_t's terms (ops/fused_mlp.py _reverse_stages)
        t_terms = sum(((cp2.abs() @ parts64[4].abs()).sum()
                       + (cp1.abs() @ parts64[1].abs()).sum()).item()
                      for _, cp2, _, cp1, _, _ in rows64)
        torch.cuda.synchronize()
        errs_f = {n: _rel(a, b) for n, a, b in zip(names_f, kf, pf)}
        errs_b = {n: _rel(a, b) for n, a, b in zip(names_b, kb, pb)}
        errs_64 = {n: (_rel(a, c), _rel(b, c)) for n, a, b, c in zip(names_b, kb, pb, pb64)}
        errs_f64 = {n: (_rel(a, c), _rel(b, c)) for n, a, b, c in zip(names_f, kf, pf, pf64)}
        print(f"[kernels] tol={tol:g} fwd rel err " + json.dumps(errs_f))
        print(f"[kernels] tol={tol:g} fwd rel err from float64 (kernel, plain) "
              + json.dumps(errs_f64))
        print(f"[kernels] tol={tol:g} bwd rel err " + json.dumps(errs_b))
        print(f"[kernels] tol={tol:g} bwd rel err from float64 (kernel, plain) "
              + json.dumps(errs_64) + f"; ct_t's terms {t_terms!r} against |ct_t| "
              f"{abs(pb64[0].item())!r}")
        for n, v in {**errs_f, **errs_b}.items():
            _check(v == v, f"{n}: NaN relative error at tol {tol}")
        _check(max(errs_f.values()) <= FWD_BOUND, f"K1 at tol {tol}: {errs_f}")
        _check(max(errs_b.values()) <= BWD_BOUND, f"K2 at tol {tol}: {errs_b}")
        dist = lambda u: abs(u.double() - pb64[0]).item()
        _check(dist(kb[0]) <= 3 * dist(pb[0]) + 2.0 ** -24 * t_terms,
               f"K2 ct_t from float64 at tol {tol}: {dist(kb[0])!r}, plain {dist(pb[0])!r}")
        for n, (k_64, p_64) in list(errs_64.items())[1:]:
            _check(k_64 <= 3 * p_64 + 1e-6, f"K2 {n} from float64 at tol {tol}: {errs_64[n]}")
        again = flat(fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol))
        _check(all(torch.equal(a, b) for a, b in zip(kb, again)), "K2 is deterministic")
        again = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
        _check(all(torch.equal(a, b) for a, b in zip(kf, again)), "K1 is deterministic")
        tup = fm.stage_sweep_fwd(t, dt, y, k1, leaves)
        _check(torch.equal(kf[0], tup[0]) and torch.equal(kf[1], tup[1]),
               "K1's y_new and k7 are K13's bitwise")
    print("[kernels] K1 and K2 are bitwise deterministic; K1's y_new and k7 are K13's "
          "bitwise at both tolerances")

    # max_abs_err of the record, at the flagship tolerance: K1 over its row
    # outputs (y_new, k7); K2 with only the row cotangents seeded (the norm
    # sums' cotangents scale every output by 1/atol, which leaves an
    # absolute error without meaning).
    tol = FLAGSHIP_TOL
    kf = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
    pf = fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)
    row_cts = [cts[0], cts[1], *(torch.zeros((), device=device) for _ in range(3))]
    kb = fm.normed_sweep_bwd(t, dt, y, k1, leaves, row_cts, tol, tol)
    pb = fm._normed_bwd_math(t, dt, y, k1, parts, row_cts, tol, tol)
    torch.cuda.synchronize()
    abs_f = max((a - b).abs().max().item() for a, b in zip(kf[:2], pf[:2]))
    abs_b = max((a - b).abs().max().item()
                for a, b in zip([*kb[:4], *kb[4]], [*pb[:4], *pb[4]]))
    errs_rows = {n: _rel(a, b) for n, a, b in zip(
        names_b, [*kb[:4], *kb[4]], [*pb[:4], *pb[4]])}
    print(f"[kernels] tol={tol:g} bwd rel err, row cotangents only "
          + json.dumps(errs_rows))
    print(f"[kernels] max abs err: fwd (y_new, k7) {abs_f!r}, "
          f"bwd (row cotangents) {abs_b!r}")
    _check(max(errs_rows.values()) <= BWD_BOUND, f"K2 row cotangents: {errs_rows}")

    times = {
        "fwd_kernel": _time_ms(lambda: fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)),
        "fwd_plain": _time_ms(lambda: fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)),
        "bwd_kernel": _time_ms(lambda: fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)),
        "bwd_plain": _time_ms(lambda: fm._normed_bwd_math(t, dt, y, k1, parts, cts, tol, tol)),
    }
    print("[kernels] median ms over %d runs at %dx%dx%d: %s"
          % (REPS, BATCH, DIM, HIDDEN, json.dumps(times)))
    dev_fwd = _device_ms(lambda: fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol),
                         "NormedEnd")
    bwd = lambda: fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    dev_walk = _device_ms(bwd, "mlp_step_walk_kernel")
    dev_wcot = _device_ms(bwd, "wcot_")
    _check(dev_fwd is not None, "K1's kernel in the trace")
    _check(dev_walk is not None and dev_wcot is not None,
           "K2's kernel and its contraction in the trace")
    plan = ws.walk_plan(BATCH, DIM, HIDDEN,
                        torch.cuda.get_device_properties(device).multi_processor_count)
    print(f"[kernels] K1 device ms a launch (torch.profiler, {REPS} launches): {dev_fwd!r}; "
          f"tiles {plan.rows}x{plan.cols}, {plan.tiles} blocks, {plan.chunks} row chunks, "
          f"{ws.solve_smem_bytes(plan.rows, plan.cols, HIDDEN)} bytes of shared memory; "
          f"grid.sync() a launch {1 + 12 * plan.chunks + 1}")
    syncs = 1 + 12 * plan.chunks + 1 + 12 * plan.chunks + 1
    print(f"[kernels] K2 device ms a launch (torch.profiler, {REPS} launches): kernel "
          f"{dev_walk!r} + contraction {dev_wcot!r} = {dev_walk + dev_wcot!r}; tiles "
          f"{plan.rows}x{plan.cols}, {plan.tiles} blocks, {plan.chunks} row chunks; "
          f"grid.sync() a launch {syncs}")
    f_ops, b_ops, leaf = _mlp_work(BATCH, DIM, HIDDEN)
    BD = BATCH * DIM
    return {
        "normed_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:1290",
            max_abs_err=abs_f, ms=times["fwd_kernel"],
            plain_ms=times["fwd_plain"], **_bound(4 * (4 * BD + leaf), f_ops)),
        "normed_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:1334",
            max_abs_err=abs_b, ms=times["bwd_kernel"],
            plain_ms=times["bwd_plain"], **_bound(4 * (6 * BD + 2 * leaf), b_ops)),
    }


def _teacher_forced_steps(rec, ns, args, parts):
    """Holds each trial step of K3's record against the plain versions on
    the record's own inputs (its stored t, dt, y, f0 rows): the norm sums,
    the y_new/k7 rows and the streamed stage residuals ks/hs against K1's
    plain version (its residual capture) in float32 and in float64, and
    the stored controller updates (the next step's t, dt,
    qold; the telemetry; the accept flag) against ``ode._post`` on the
    stored sums. Returns, per quantity, the worst relative errors
    (kernel vs plain, kernel vs float64, plain vs float64); None where
    there is no float64 side."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws

    t0, t1, _, _, _, _, rtol, atol, ctrl, _ = args
    st = rec.streams
    tdir, span = torch.sign(t1 - t0), torch.abs(t1 - t0)
    count = float(rec.y1.numel())
    parts64 = [x.double() for x in parts]
    worst = {}

    def note(name, k_p, k_64=0.0, p_64=None):
        old = worst.get(name, (0.0, 0.0, None if p_64 is None else 0.0))
        worst[name] = (max(old[0], k_p), max(old[1], k_64),
                       None if p_64 is None else max(old[2], p_64))

    for i in range(ns):
        t, dt, qold, e, n, d = st[:ws.ST_ACC, i]
        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        dt_eff = torch.where(is_last, remaining, dt)
        p32, r32 = fm._reference_normed_sweep_res(t, dt_eff, rec.hy[i], rec.hf[i], parts,
                                                  rtol, atol)
        p64, r64 = fm._reference_normed_sweep_res(t.double(), dt_eff.double(),
                                                  rec.hy[i].double(), rec.hf[i].double(),
                                                  parts64, rtol, atol)
        if rec.ks.numel():  # the stage residuals K3 streamed, rejected steps too
            for name, k, a, b in (("ks", rec.ks[i], r32[0][1:], r64[0][1:]),
                                  ("hs", rec.hs[i], r32[1], r64[1])):
                a, b = torch.stack(a), torch.stack(b)
                note(name, _rel(k, a), _rel(k, b), _rel(a, b))
        for name, k, a, b in zip(["err_ssq", "num_ssq", "den_ssq"], (e, n, d),
                                 p32[2:], p64[2:]):
            note(name, _rel(k, a), _rel(k, b), _rel(a, b))
        acc = bool(st[ws.ST_ACC, i] > 0.5)
        if acc:  # an accepted step's y_new, k7 start the next step
            note("y_new", _rel(rec.hy[i + 1], p32[0]), _rel(rec.hy[i + 1], p64[0]),
                 _rel(p32[0], p64[0]))
            if i + 1 < ns:  # hf[ns] is not part of the record
                note("k7", _rel(rec.hf[i + 1], p32[1]), _rel(rec.hf[i + 1], p64[1]),
                     _rel(p32[1], p64[1]))
        post = ode._post(ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last)
        _check(acc == bool(post[4] <= 1.0), f"K3 step {i}: accept flag")
        for name, j, want in (("tel_t_end", ws.TEL_T, post[3]), ("tel_dt", ws.TEL_DT, dt_eff),
                              ("tel_eest", ws.TEL_EEST, post[4]),
                              ("tel_eigen", ws.TEL_EIGEN, post[5])):
            note(name, _rel(st[j, i], want))
        if i + 1 < ns:
            for name, j, want in (("t_next", ws.ST_T, post[0]), ("dt_next", ws.ST_DT, post[1]),
                                  ("qold_next", ws.ST_QOLD, post[2])):
                note(name, _rel(st[j, i + 1], want))
    return worst


def _check_steps_teacher_forced(tag, rec, ns, args):
    """Each of K3's stored trial steps (MLPDynamics) against the plain
    versions on its own stored inputs (``_teacher_forced_steps``): the norm
    sums and rows within 3 times the float32 plain version's distance from
    float64, plus 1e-6, the streamed stage residuals also within FWD_BOUND
    of the plain capture, and the controller within WS_CTRL_BOUND."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm

    errs = _teacher_forced_steps(rec, ns, args, fm._split_params(*args[5]))
    print(f"[{tag}] K3 per trial step, on its own stored inputs: rel err (kernel vs "
          "plain, kernel vs float64, plain vs float64), worst over the steps "
          + json.dumps(errs))
    for n, (k_p, k_64, p_64) in errs.items():
        _check(k_p == k_p and k_64 == k_64, f"{tag} K3 {n}: no NaN")
        if p_64 is None:  # the controller: the same formula in float32
            _check(k_p <= WS_CTRL_BOUND, f"{tag} K3 {n}: {errs[n]}")
        else:
            _check(k_64 <= 3 * p_64 + 1e-6, f"{tag} K3 {n}: {errs[n]}")
        if n in ("ks", "hs"):
            _check(k_p <= FWD_BOUND, f"{tag} K3 streamed {n}: {errs[n]}")
    _check(not rec.ks.numel() or {"ks", "hs"} <= errs.keys(), f"{tag}: K3 streamed ks, hs")


def phase_whole_solve_kernels(device):
    """K3/K4 for MLPDynamics against their plain versions on seeded random
    weights and inputs at 512x784x100, rtol=atol=1e-4, without saveat
    (``_whole_solve_vs_plain``): y1 within FWD_BOUND. The first steps'
    embedded error sits near its float32 rounding floor, so the two solves'
    step sizes drift apart by about 1% (measured on the H100); each stored
    trial step is therefore held against the plain versions on its own
    stored inputs (``_check_steps_teacher_forced``). K4 with the cotangent
    of y1 within BWD_BOUND of its plain version, with the telemetry's too
    within TEL_BWD_BOUND (every output but ct_f0), and every output within
    3 times the float32 plain version's distance from float64, plus 1e-5,
    but ct_f0 with y1's cotangent alone, which is held to F0_ORDER_BOUND
    from float64 (``f0_bound``): the error estimate sits at its float32
    floor on this solve (eest 3e-5 to 2e-3), so that ct_f0 carries the
    controller's residual of cancelling cotangents, whose distance from
    float64 is set by the walk's order of summation
    (``tools/torch_f0_orders.py``); with the telemetry's cotangent too, the
    orders agree and ct_f0 keeps the 3-times bound. K3's streamed stage
    residuals of every trial step within FWD_BOUND of the plain capture on
    the step's own stored inputs, and K4 on them bitwise K4 replaying the
    stages, for both seed sets. At the flagship tolerance, the trial steps of K3, of its float32
    plain version and of a float64 plain solve, each reaching t1, and the
    times of the stream (the main path) and of the replay
    (``cache_residuals=False``)."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(SEED + 2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = [rnd(HIDDEN, DIM + 1, scale=(DIM + 1) ** -0.5), rnd(HIDDEN, scale=0.1),
              rnd(DIM, HIDDEN + 1, scale=(HIDDEN + 1) ** -0.5), rnd(DIM, scale=0.1)]
    y0 = torch.rand(BATCH, DIM, generator=gen).to(device)
    parts = fm._split_params(*leaves)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]
    _, _, abs_f, abs_b, _, _, (ct_y1, _, ct_tel) = _whole_solve_vs_plain(
        "whole", "mlp", leaves, y0, func, None, 1e-4, MAX_STEPS, gen=gen,
        fwd_bound=FWD_BOUND, n_leaf_groups=4, check_steps=_check_steps_teacher_forced,
        k4_plain={"y1": BWD_BOUND, "y1+telemetry": TEL_BWD_BOUND},
        f0_bound={"y1": F0_ORDER_BOUND})

    ctrl = PIController.for_order(5)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), FLAGSHIP_TOL, FLAGSHIP_TOL)
    args = (t0, t1, dt0, y0, f0, leaves, FLAGSHIP_TOL, FLAGSHIP_TOL, ctrl, MAX_STEPS)
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    # at 1.4e-8 the error estimate sits at its float32 floor, so the
    # float32 solves' step sizes are a matter of their rounding
    leaves64 = [x.double() for x in leaves]
    parts64 = fm._split_params(*leaves64)
    func64 = lambda t, y, _: fm._mlp_k(y, t, parts64)[0]
    p64 = ode.solve_prologue(func64, y0.double(), 0.0, 1.0, (), FLAGSHIP_TOL, FLAGSHIP_TOL)
    finals = {"K3": rec.final, "plain": ws.plain_whole_solve_fwd(*args).final,
              "plain_float64": ws.plain_whole_solve_fwd(
                  p64[0], p64[1], p64[3], y0.double(), p64[2], leaves64, FLAGSHIP_TOL,
                  FLAGSHIP_TOL, ctrl, MAX_STEPS).final}
    steps = {k: v[3:].tolist() for k, v in finals.items()}
    print("[whole] (naccept, nreject, done) at tol %g: %s" % (FLAGSHIP_TOL, json.dumps(steps)))
    _check(all(v[2] == 1.0 for v in steps.values()), f"whole: every solve reached t1 {steps}")
    bwd_args = (ns, ct_y1, ct_tel, t0, t1, leaves, FLAGSHIP_TOL, FLAGSHIP_TOL, ctrl)
    replay = dict(cache_residuals=False)
    rec0 = ws.whole_solve_fwd(*args, **replay)
    times = {
        "fwd_kernel": _time_ms(lambda: ws.whole_solve_fwd(*args)),
        "fwd_kernel_replay": _time_ms(lambda: ws.whole_solve_fwd(*args, **replay)),
        "fwd_plain": _time_ms(lambda: ws.plain_whole_solve_fwd(*args)),
        "bwd_kernel": _time_ms(lambda: ws.whole_solve_bwd(rec, *bwd_args)),
        "bwd_kernel_replay": _time_ms(lambda: ws.whole_solve_bwd(rec0, *bwd_args, **replay)),
        "bwd_plain": _time_ms(lambda: ws.plain_whole_solve_bwd(rec, *bwd_args)),
    }
    del rec0
    print("[whole] median ms over %d runs at %dx%dx%d, tol %g, %d trial steps (K3/K4 on the "
          "stage residuals' stream, and replaying the stages): %s"
          % (REPS, BATCH, DIM, HIDDEN, FLAGSHIP_TOL, ns, json.dumps(times)))
    # K3's and K4's device time apart from the wrappers' host work, and
    # their barriers on their one tile plan (ops/whole_solve.py walk_plan;
    # mlp_solve.cuh and mlp_walk.cuh: one after padding the weights, two a
    # stage of each row chunk, one a trial step for its scalar slots)
    k3 = lambda: ws.whole_solve_fwd(*args)
    k4 = lambda: ws.whole_solve_bwd(rec, *bwd_args)
    plan = ws.walk_plan(BATCH, DIM, HIDDEN,
                        torch.cuda.get_device_properties(device).multi_processor_count)
    syncs = 1 + ns * (12 * plan.chunks + 1)
    print("[whole] K3 device ms (torch.profiler, mean of %d calls): %r, in a CUDA-event "
          "window of %r; K4 device ms: walk %r, contraction %r, in a CUDA-event window of "
          "%r; tiles %dx%d, %d blocks, %d row chunks; grid.sync() a solve %d, a walk %d"
          % (REPS, _device_ms(k3, "mlp_solve_kernel"), times["fwd_kernel"],
             _device_ms(k4, "mlp_walk_kernel"), _device_ms(k4, "wcot_"),
             times["bwd_kernel"], plan.rows, plan.cols, plan.tiles, plan.chunks, syncs,
             syncs))
    f_ops, b_ops, leaf = _mlp_work(BATCH, DIM, HIDDEN)
    nbytes = _solve_bytes(BATCH * DIM, leaf, ns, 0, MAX_STEPS, 6 * BATCH * (DIM + HIDDEN))
    return {
        "whole_solve_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:357",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(nbytes[0], ns * f_ops)),
        "whole_solve_bwd": dict(  # the stream spares K4 the recompute
            replaces="regneuralde_tpu/ops/pallas_solve.py:559",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(nbytes[1], ns * (b_ops - f_ops))),
    }


def _solve_bytes(BD, leaf, ns, n_save, S, stream=0):
    """Bytes K3 and K4 must move over a solve of ns trial steps: K3 reads
    y0, f0, the leaves and ys_init and writes y1, ys, the history (ns + 1
    rows of y and f), the streams and ``stream`` floats a trial step of
    stage residuals; K4 reads the history, the streams, the residuals, the
    leaves and the cotangents of y1, ys and the telemetry, and writes
    those of y0, f0, ys_init and the leaves."""
    hist = 2 * (ns + 1) * BD
    fwd = 3 * BD + leaf + 2 * n_save * BD + hist + 11 * S + ns * stream
    bwd = (hist + 11 * S + ns * stream + leaf + BD + 2 * n_save * BD + 4 * S + 2 * BD
           + leaf)
    return 4 * fwd, 4 * bwd


def phase_kernel_vs_plain_step(device, batch, fused):
    """One forward+backward of the training step: kernels against plain.

    The cross-entropy gradient is held to GRAD_BOUND. The full gradient adds
    100 * error_estimate, whose gradient at rtol=atol=1e-5 in float32 is
    dominated by the rounding noise of the embedded error estimate: a change
    of summation order alone moves it by about 1.5e-2 (relative), so it is
    held to REG_GRAD_BOUND."""
    import torch

    x, y = batch
    tol = 1e-5
    kern, gen = build_classifier(tol, fused, device)
    kern.init(x, generator=gen)
    plain, _ = build_classifier(tol, False, device)
    plain.init(x)
    plain.load_state_dict(kern.state_dict())
    results = {}
    counters = _counters()
    for mod in counters:
        mod.reset_launches()
    for name, clf in (("kernel", kern), ("plain", plain)):
        for reg_weight in (0.0, 100.0):
            clf.zero_grad(set_to_none=True)
            loss, out = mnist_loss(clf, x, y, reg_weight)
            loss.backward()
            torch.cuda.synchronize()
            tel = out.telemetry
            results[name, reg_weight] = dict(
                loss=loss.item(), nfe=out.nfe, success=out.success,
                accepted=tel.accepted[tel.live].tolist(),
                grad=torch.cat([p.grad.flatten() for p in clf.parameters()]),
                logits=out.logits.detach())
    launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items() if v}
    print(f"[step] fused={fused!r} launches over both kernel steps {json.dumps(launches)}")
    for reg_weight, bound in ((0.0, GRAD_BOUND), (100.0, REG_GRAD_BOUND)):
        k, p = results["kernel", reg_weight], results["plain", reg_weight]
        g_err = _rel(k["grad"], p["grad"])
        print(f"[step] fused={fused!r} rtol=atol={tol:g} reg_weight={reg_weight:g} "
              f"nfe kernel={k['nfe']} plain={p['nfe']} accepts of trial steps "
              f"kernel={sum(k['accepted'])}/{len(k['accepted'])} "
              f"plain={sum(p['accepted'])}/{len(p['accepted'])} "
              f"loss kernel={k['loss']!r} plain={p['loss']!r} "
              f"logits rel err={_rel(k['logits'], p['logits']):.3e} "
              f"grad rel err={g_err:.3e} (bound {bound:g})")
        _check(k["success"] and p["success"], "both solves reached t1")
        _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
        _check(k["accepted"] == p["accepted"], "same accept sequence")
        _check(tuple(k["logits"].shape) == (BATCH, 10), "logits shape")
        _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
        _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_slice(device, batches, fused):
    """Three training steps of the flagship configuration on ``fused``.
    Returns the launch counts of the four kernels in those steps: each
    step kernel once per trial step on ``"step"``; each whole-solve
    kernel once per training step on ``True``, and no step kernel; the
    weight-cotangent contraction once per K2 or K4 launch."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    clf, gen = build_classifier(FLAGSHIP_TOL, fused, device)
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(lambda m, x, y: mnist_loss(m, x, y), optimizer)
    before = [p.detach().clone() for p in clf.parameters()]

    torch.cuda.synchronize()
    counters = _counters()
    for mod in counters:  # count only this path's launches
        mod.reset_launches()
    trial_steps = 0
    for i, (x, y) in enumerate(batches):
        start = time.perf_counter()
        state, loss, out = step(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        sol = out.telemetry
        naccept = int(sol.accepted.sum().item())
        nlive = int(sol.live.sum().item())
        trial_steps += nlive
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        print(f"[slice] fused={fused!r} step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} "
              f"success={out.success} wall_s={wall!r} "
              f"launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success, "the solve reached t1")
        _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
        _check(torch.isfinite(out.logits).all().item(), "finite logits")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(clf.parameters(), before))
    print(f"[slice] fused={fused!r} trial steps={trial_steps} "
          f"launches={json.dumps(launches)} max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    want = {k: 0 for k in launches}
    if fused == "step":
        want.update(normed_tsit5_fwd=trial_steps, normed_tsit5_bwd=trial_steps,
                    weight_cotangents=trial_steps)
    else:
        want.update(whole_solve_fwd=len(batches), whole_solve_bwd=len(batches),
                    weight_cotangents=len(batches))
    _check(launches == want, f"fused={fused!r}: launches {launches}, expected {want}")
    if fused == "step":
        _plain_route_steps(device, batches)
    return launches


def _plain_route_steps(device, batches):
    """The three training steps of phase 4 on ``fused=False`` from the same
    weights: each step's NFE and accepts printed beside the kernel route's,
    not compared (at 1.4e-8 the error estimate sits at its float32 floor,
    where each route's trial steps follow its own rounding); each solve
    reaches t1 with a finite loss."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    clf, gen = build_classifier(FLAGSHIP_TOL, False, device)
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(lambda m, x, y: mnist_loss(m, x, y), optimizer)
    for i, (x, y) in enumerate(batches):
        state, loss, out = step(state, x, y)
        sol = out.telemetry
        naccept = int(sol.accepted.sum().item())
        nlive = int(sol.live.sum().item())
        print(f"[slice] fused=False step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} success={out.success}")
        _check(torch.isfinite(loss).item() and out.success, "the plain route's step")


# ---------------------------------------------------------------------------
# The latent ODE (phases 8-10).
# ---------------------------------------------------------------------------


def build_latent(tol, fused, device, saveat, seed=SEED):
    """The latent ODE of ``bench.py:139-210`` at full width, weights from
    ``torch.Generator(seed)``; the decoder is sized by ``init``."""
    import torch

    from regneuralde_tpu_torch.models import (
        MLP,
        AlternatingMLP,
        LatentGRU,
        LatentTimeSeriesModel,
        NeuralODE,
    )

    gen = torch.Generator().manual_seed(seed)
    node = NeuralODE(AlternatingMLP(LATENT_DIM, LATENT_HIDDEN, LATENT_DEPTH, device=device,
                                    generator=gen),
                     time_dep=False, rtol=tol, atol=tol, max_steps=LATENT_MAX_STEPS,
                     saveat=saveat, fused=fused)
    model = LatentTimeSeriesModel(
        rnn=LatentGRU(LATENT_OBS, 40, 50, device=device, generator=gen),
        enc=MLP(100, (50, 2 * LATENT_DIM), device=device, generator=gen), node=node,
        dec=torch.nn.LazyLinear(LATENT_OBS, device=device))
    return model, gen


def latent_inputs(d, m, tp):
    """``[data, mask, delta_t]`` per stamp, as ``bench.py`` builds it."""
    import torch

    dt = torch.cat([tp[:, 1:] - tp[:, :-1], torch.zeros_like(tp[:, :1])], 1)
    return torch.cat([d, m, dt[..., None]], dim=-1)


def latent_loss(model, d, m, tp, eps, reg_weight=LATENT_REG):
    """``bench.py:186-194``: the masked Gaussian log-likelihood (sigma 0.01)
    and KL, plus reg_weight * error_estimate(mean)."""
    import torch

    from regneuralde_tpu_torch import reg

    out = model(latent_inputs(d, m, tp), eps=eps)
    err = (out.result - d) * m
    ll = torch.sum(-torch.square(err) / (2 * LATENT_SIGMA ** 2), dim=(1, 2))
    ll = ll / torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    kl = torch.mean(torch.exp(out.logvar) + torch.square(out.mu0) - 1 - out.logvar,
                    dim=-1) / 2
    return -torch.mean(ll - kl) + reg_weight * reg.error_estimate(out.telemetry, "mean"), out


def latent_batches(n, device):
    """``n`` full batches ``(d, m, tp, eps)`` of the physionet surrogate
    (``load_physionet`` without data files), the reparameterization noise
    drawn from a seeded generator; and the saveat grid of ``bench.py``, the
    sorted stamps of the first batch."""
    import torch

    from regneuralde_tpu_torch.data import load_physionet

    train, _ = load_physionet(LATENT_BATCH, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 9)
    out = []
    for b in train:
        d, m, tp = (torch.as_tensor(b[i], device=device) for i in (0, 1, 4))
        eps = torch.randn(LATENT_BATCH, LATENT_DIM, generator=gen).to(device)
        out.append((d, m, tp, eps))
        if len(out) == n:
            return out, torch.sort(out[0][2][0]).values
    raise AssertionError(f"the loader gave fewer than {n} full batches")


def phase_altmlp_kernels(device):
    """K7/K8 against their plain versions on seeded random inputs at the
    latent shape (random k1 keeps the embedded error far above float32
    rounding), at rtol=atol=1e-4 and 1.4e-8, K7 also bitwise against its
    schedule (``fg.plain_altmlp_fwd_tiles``); bitwise determinism; times;
    K7's and K8's blocks a launch (one wave) and device time, each kernel
    and its slot sum apart."""
    import torch

    from regneuralde_tpu_torch.ops import fused_generic as fg

    gen = torch.Generator().manual_seed(SEED + 3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    B, D, H = LATENT_BATCH, LATENT_DIM, LATENT_HIDDEN
    leaves = []
    for _ in range(LATENT_DEPTH):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1),
                   rnd(D, H, scale=H ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    t = torch.tensor(0.07, device=device)
    dt = torch.tensor(0.11, device=device)
    cts = [rnd(B, D), rnd(B, D), torch.tensor(0.7, device=device),
           torch.tensor(1.3, device=device), torch.tensor(-0.4, device=device)]
    names_f = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]
    names_b = ["ct_dt", "ct_y", "ct_k1"] + [f"c_leaf{j}" for j in range(len(leaves))]
    flat_b = lambda g: [*g[1:4], *g[4]]
    for tol in (1e-4, FLAGSHIP_TOL):
        kf = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
        pf = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
        kb = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
        pb = fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
        torch.cuda.synchronize()
        errs_f = {n: _rel(a, b) for n, a, b in zip(names_f, kf, pf)}
        errs_b = {n: _rel(a, b) for n, a, b in zip(names_b, flat_b(kb), flat_b(pb))}
        print(f"[altmlp] tol={tol:g} K7 rel err " + json.dumps(errs_f))
        print(f"[altmlp] tol={tol:g} K8 rel err " + json.dumps(errs_b))
        for n, v in {**errs_f, **errs_b}.items():
            _check(v == v, f"{n}: NaN relative error at tol {tol}")
        _check(max(errs_f.values()) <= FWD_BOUND, f"K7 at tol {tol}: {errs_f}")
        sched = fg.plain_altmlp_fwd_tiles(t, dt, y, k1, leaves, tol, tol)
        for name, a, b in zip(names_f[:2], kf[:2], pf[:2]):
            bad = (a != b).nonzero()
            if len(bad):
                r, c = bad[0].tolist()
                print(f"[altmlp] tol={tol:g} K7's {name} differs from the plain version's at "
                      f"{len(bad)} elements, first ({r}, {c}): {a[r, c].item()!r} against "
                      f"{b[r, c].item()!r}; y[{r}] {y[r].tolist()}, k1[{r}] {k1[r].tolist()}")
        _check(all(torch.equal(a, b) for a, b in zip(kf[:2], pf[:2])),
               f"K7's rows are the plain version's bitwise at tol {tol}")
        _check(all(torch.equal(a, b) for a, b in zip(kf, sched)),
               f"K7's rows and sums are its schedule's bitwise at tol {tol}")
        _check(max(errs_b.values()) <= BWD_BOUND, f"K8 at tol {tol}: {errs_b}")
        _check(kb[0].item() == 0.0, "K8: ct_t is exactly zero")

    tol = FLAGSHIP_TOL
    again_f = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    again_b = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    _check(all(torch.equal(a, b) for a, b in zip(kf, again_f)), "K7 is deterministic")
    _check(all(torch.equal(a, b) for a, b in zip(flat_b(kb), flat_b(again_b))),
           "K8 is deterministic")
    # max_abs_err of the record: K7 over its row outputs, K8 with only the
    # row cotangents seeded (as phase 2)
    row_cts = [cts[0], cts[1], *(torch.zeros((), device=device) for _ in range(3))]
    kb = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, row_cts, tol, tol)
    pb = fg._altmlp_bwd_math(t, dt, y, k1, leaves, row_cts, tol, tol)
    torch.cuda.synchronize()
    abs_f = max((a - b).abs().max().item() for a, b in zip(kf[:2], pf[:2]))
    abs_b = max((a - b).abs().max().item() for a, b in zip(flat_b(kb), flat_b(pb)))
    print(f"[altmlp] max abs err: K7 (y_new, k7) {abs_f!r}, K8 (row cotangents) {abs_b!r}")

    times = {
        "fwd_kernel": _time_ms(lambda: fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)),
        "fwd_plain": _time_ms(lambda: fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves,
                                                                   tol, tol)),
        "bwd_kernel": _time_ms(lambda: fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts,
                                                                  tol, tol)),
        "bwd_plain": _time_ms(lambda: fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol,
                                                          tol)),
    }
    print("[altmlp] median ms over %d runs at %dx%dx%dx%d: %s"
          % (REPS, B, D, H, LATENT_DEPTH, json.dumps(times)))
    # K7's and K8's grids and device times, each kernel and its slot sum apart
    from regneuralde_tpu_torch.ops import _cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fplan = fg.check_fwd_plan(_cuda.library(), D, H, LATENT_DEPTH)
    fblocks = fg.altmlp_fwd_plan(B, D, H, LATENT_DEPTH).tiles
    fwd = lambda: fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    fdev_k = _device_ms(fwd, "altmlp_fwd_kernel")
    fdev_s = _device_ms(fwd, "sum_slots_warp_kernel")
    print(f"[altmlp] K7: {fblocks} blocks of {fplan.rows} rows a launch on {sms} SMs, "
          f"{fplan.smem_bytes} bytes of shared memory a block; device ms a launch: "
          f"altmlp_fwd_kernel {fdev_k!r}, sum_slots_warp_kernel {fdev_s!r}")
    _check(fblocks <= sms, f"K7 runs in one wave: {fblocks} blocks on {sms} SMs")
    plan = fg.check_bwd_plan(_cuda.library(), D, H, LATENT_DEPTH)
    blocks = fg.altmlp_bwd_plan(B, D, H, LATENT_DEPTH).tiles
    bwd = lambda: fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    dev_k, dev_s = _device_ms(bwd, "altmlp_bwd_kernel"), _device_ms(bwd, "sum_slots_kernel")
    print(f"[altmlp] K8: {blocks} blocks of {plan.rows} rows a launch on {sms} SMs, "
          f"{plan.smem_bytes} bytes of shared memory a block; device ms a launch: "
          f"altmlp_bwd_kernel {dev_k!r}, sum_slots_kernel {dev_s!r}")
    _check(blocks <= sms, f"K8 runs in one wave: {blocks} blocks on {sms} SMs")
    f_ops, b_ops, leaf = _altmlp_work(B, D, H, LATENT_DEPTH)
    return {
        "altmlp_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_generic.py:208",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(4 * (4 * B * D + leaf), f_ops)),
        "altmlp_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_generic.py:278",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(4 * (6 * B * D + 2 * leaf), b_ops)),
    }


def phase_latent_kernel_vs_plain_step(device, batch, saveat, fused):
    """One forward+backward of the latent training step at rtol=atol=1e-5:
    the kernels (K7/K8 on ``fused="step"``, the whole solve K3/K4 on
    ``fused=True``) against their plain versions (``fused=False``) on the
    same weights and noise. The loss without the regularizer is held to
    GRAD_BOUND; with 1e3 * error_estimate, whose gradient sits at the error
    estimate's float32 rounding floor, to REG_GRAD_BOUND (phase 3's
    bounds)."""
    import torch

    d, m, tp, eps = batch
    tol = 1e-5
    x = latent_inputs(d, m, tp)
    kern, gen = build_latent(tol, fused, device, saveat)
    kern.init(x, generator=gen)
    plain, _ = build_latent(tol, False, device, saveat)
    plain.init(x)
    plain.load_state_dict(kern.state_dict())
    results = {}
    for name, model in (("kernel", kern), ("plain", plain)):
        for reg_weight in (0.0, LATENT_REG):
            model.zero_grad(set_to_none=True)
            loss, out = latent_loss(model, d, m, tp, eps, reg_weight)
            loss.backward()
            torch.cuda.synchronize()
            tel = out.telemetry
            results[name, reg_weight] = dict(
                loss=loss.item(), nfe=out.nfe, success=out.success,
                accepted=tel.accepted[tel.live].tolist(),
                grad=torch.cat([p.grad.flatten() for p in model.parameters()]),
                result=out.result.detach())
    for reg_weight, bound in ((0.0, GRAD_BOUND), (LATENT_REG, REG_GRAD_BOUND)):
        k, p = results["kernel", reg_weight], results["plain", reg_weight]
        g_err = _rel(k["grad"], p["grad"])
        print(f"[latent-step] fused={fused!r} rtol=atol={tol:g} reg_weight={reg_weight:g} "
              f"nfe kernel={k['nfe']} plain={p['nfe']} "
              f"loss kernel={k['loss']!r} plain={p['loss']!r} "
              f"result rel err={_rel(k['result'], p['result']):.3e} "
              f"grad rel err={g_err:.3e} (bound {bound:g})")
        _check(k["success"] and p["success"], "both solves reached t1")
        _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
        _check(k["accepted"] == p["accepted"], "same accept sequence")
        _check(tuple(k["result"].shape) == (LATENT_BATCH, saveat.shape[0], LATENT_OBS),
               "result shape")
        _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
        _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_latent_slice(device, batches, saveat, fused):
    """Three training steps of the latent ODE at full width on ``fused``.
    Returns the launch counts of that run (on ``"step"`` K7 and K8 once per
    trial step, on ``True`` each whole-solve kernel once per training step,
    no other kernel) and per step the weights it started from, its NFE and
    its accept sequence."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        latent_ode_optimizer,
        make_train_step,
    )

    model, gen = build_latent(FLAGSHIP_TOL, fused, device, saveat)
    model.init(latent_inputs(*batches[0][:3]), generator=gen)
    optimizer = latent_ode_optimizer()
    state = create_train_state(model, optimizer)
    step = make_train_step(latent_loss, optimizer)
    before = [p.detach().clone() for p in model.parameters()]

    torch.cuda.synchronize()
    counters = _counters()
    for mod in counters:  # count only this path's launches
        mod.reset_launches()
    trial_steps = 0
    steps = []
    for i, batch in enumerate(batches):
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        start = time.perf_counter()
        state, loss, out = step(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        tel = out.telemetry
        naccept = int(tel.accepted.sum().item())
        nlive = int(tel.live.sum().item())
        trial_steps += nlive
        steps.append(dict(weights=weights, nfe=out.nfe,
                          accepted=tel.accepted[tel.live].tolist()))
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        print(f"[latent] fused={fused!r} step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} success={out.success} "
              f"wall_s={wall!r} launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success, f"the solve reached t1 within {LATENT_MAX_STEPS} trial steps")
        _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
        _check(tuple(out.result.shape) == (LATENT_BATCH, saveat.shape[0], LATENT_OBS),
               "result shape")
        _check(torch.isfinite(out.result).all().item(), "finite result")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(model.parameters(), before))
    print(f"[latent] fused={fused!r} trial steps={trial_steps} "
          f"launches={json.dumps(launches)} max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    want = {k: 0 for k in launches}
    if fused == "step":
        want.update(altmlp_tsit5_fwd=trial_steps, altmlp_tsit5_bwd=trial_steps)
    else:
        want.update(whole_solve_altmlp_fwd=len(batches), whole_solve_altmlp_bwd=len(batches))
    _check(launches == want, f"latent launches {launches}, expected {want}")
    return launches, steps


# ---------------------------------------------------------------------------
# The latent ODE on the whole solve (phases 11-14).
# ---------------------------------------------------------------------------


def _k4_groups(g, n_leaf_groups, saves):
    """K4's outputs as compared: the time scalars as one vector, ct_y0,
    ct_f0, ct_ys_init (with ``saves``), and the leaves in ``n_leaf_groups``
    groups (all leaves as one vector when 1)."""
    import torch

    head = [torch.stack(g[:3]), g[3], g[4]] + ([g[5]] if saves else [])
    leaves = list(g[6:])
    if n_leaf_groups == 1:
        return head + [torch.cat([x.flatten() for x in leaves])]
    return head + leaves


def _check_steps_against_k7(tag, rec, ns, args, sweep=None):
    """Each of K3's stored trial steps against its step kernel (``sweep``:
    K7 for AlternatingMLP, the default, or K7-CSL) on its own stored
    inputs: the norm sums and rows bitwise equal, and the stored controller
    updates bitwise equal to ``ode._post`` on the card."""
    import torch

    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws

    sweep = sweep or fg.altmlp_normed_sweep
    t0, t1, _, y0, _, leaves, tol, _, ctrl, _ = args
    st = rec.streams
    tdir, span = torch.sign(t1 - t0), torch.abs(t1 - t0)
    count = float(y0.numel())
    same = ctrl_same = True
    for i in range(ns):
        t, dt, qold = st[ws.ST_T, i], st[ws.ST_DT, i], st[ws.ST_QOLD, i]
        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        dt_eff = torch.where(is_last, remaining, dt)
        res = sweep(t, dt_eff, rec.hy[i], rec.hf[i], leaves, tol, tol)
        sums = torch.stack(res[2:])
        same &= torch.equal(sums, st[ws.ST_E:ws.ST_ACC, i])
        if st[ws.ST_ACC, i] > 0.5:
            same &= torch.equal(res.y_new, rec.hy[i + 1])
            same &= torch.equal(res.k_last, rec.hf[i + 1])
        post = ode._post(ctrl, count, t, dt_eff, qold, *sums, t1, span, is_last)
        want = [post[3], dt_eff, post[4], post[5]]
        got = [st[j, i] for j in (ws.TEL_T, ws.TEL_DT, ws.TEL_EEST, ws.TEL_EIGEN)]
        if i + 1 < ns:
            want += list(post[:3])
            got += [st[ws.ST_T, i + 1], st[ws.ST_DT, i + 1], st[ws.ST_QOLD, i + 1]]
        ctrl_same &= all(torch.equal(a.reshape(()), b.reshape(())) for a, b in zip(got, want))
    print(f"[{tag}] {ns} stored trial steps against the step kernel on their inputs: "
          f"norm sums and "
          f"rows bitwise equal {same}; controller bitwise equal to ode._post {ctrl_same}")
    _check(same, f"{tag}: K3's norm sums and rows equal K7's")
    _check(ctrl_same, f"{tag}: K3's controller equals ode._post on the card")


def _check_streamed_is_replay(tag, seeds, streamed, replay, names, saves, n_leaf_groups):
    """K4 on K3's stage residuals against K4 replaying the stages, on the
    same record and cotangents: every output bitwise (the time scalars,
    ct_y0, ct_f0, ct_ys_init and the leaves); the largest difference of
    each output is printed."""
    import torch

    groups = [_k4_groups(g, n_leaf_groups, saves) for g in (streamed, replay)]
    diff = {n: (a - b).abs().max().item() if a.numel() else 0.0
            for n, a, b in zip(names, *groups)}
    same = all(torch.equal(a, b) for a, b in zip(*groups))
    print(f"[{tag}] K4 streamed vs replay, cotangents of {seeds}: bitwise equal {same}; "
          f"max abs diff {json.dumps(diff)}")
    _check(same, f"{tag} K4 streamed is K4 replaying, bitwise, for {seeds}: {diff}")


def _whole_solve_vs_plain(tag, dynamics, leaves, y0, func, saveat, tol, max_steps, *,
                          gen, fwd_bound, n_leaf_groups, check_steps, k4_plain,
                          f0_plain=(), f0_bound=None, eest_only=False):
    """K3/K4 of ``dynamics`` (with ``saveat``, or None) against their plain
    versions at rtol=atol=``tol``; the cotangents drawn from ``gen``.

    The forward: the same step counts, accept sequence and save cursors,
    y1 and ys within ``fwd_bound`` (relative), and ``check_steps(tag,
    record, trial steps, arguments)`` on the stored trial steps; the solve
    must reach t1 within ``max_steps``.

    The backward, over K3's record, against its float32 plain version and
    a float64 plain walk, seeded with a cotangent of y1, then of y1 and ys,
    then of these and the telemetry. Every output is held to 3 times the
    float32 plain version's distance from float64, plus 1e-5, and every
    output but ct_f0 to ``k4_plain[seeds]`` of the plain version. For
    MLPDynamics, K4 on K3's stage residuals is also held bitwise to K4
    replaying the stages (``_check_streamed_is_replay``). With the
    seeds in ``f0_plain``, ct_f0 is held to BWD_BOUND of the plain version
    instead of to float64. There ct_f0 carries the error estimate's
    cotangent, the controller's pullback of the cotangent of dt that
    reaches it; that cotangent is the residual of the cotangents of t and
    of a step's dt_eff (about -38.39 and +38.39 at phase 11's solve), a few
    float32 ulps. Two float32 walks sum them in different orders, so their
    ct_f0 lie from float64 by amounts that are a matter of rounding: 2.5e-6
    and 3.1e-4 for the plain version and K4 on the H100, 5.7e-4 for the
    plain version on the CPU, for phase 11 at 1e-5
    (``tools/torch_k4_trace.py``).
    With ``eest_only`` a last seed set, ``"eest"``, seeds the cotangent of
    the telemetry's eest alone (no y1): every cotangent then flows from the
    error norm's pullback. With the seeds in ``f0_bound``, ct_f0 is held to
    that bound from float64 instead. Both kernels bitwise deterministic.
    Returns the record, its trial steps, the max abs errors of K3 over y1 and ys and of K4 with the row
    cotangents only, the arguments and keywords of the solve, and the
    cotangents ``(ct_y1, ct_ys, ct_tel)``."""
    import torch

    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(y0.device)

    saves = saveat is not None
    ctrl = PIController.for_order(5)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, tuple(leaves), tol, tol)
    args = (t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, max_steps)
    kw = dict(dynamics=dynamics)
    if saves:
        sa, ys_init = ode.saveat_rows(saveat, t0, t1, y0)
        kw.update(saveat=sa, ys_init=ys_init)
    rk = ws.whole_solve_fwd(*args, **kw)
    rp = ws.plain_whole_solve_fwd(*args, **kw)
    torch.cuda.synchronize()
    counts_k, counts_p = rk.final[3:].tolist(), rp.final[3:].tolist()
    ns = int(counts_k[0] + counts_k[1])
    errs = {"y1": _rel(rk.y1, rp.y1), **({"ys": _rel(rk.ys, rp.ys)} if saves else {})}
    cursors = (f"cursors kernel={rk.cursors.tolist()} plain={rp.cursors.tolist()}; "
               if saves else "")
    print(f"[{tag}] tol={tol:g} (naccept, nreject, done) kernel={counts_k} plain={counts_p}; "
          f"{cursors}rel err {json.dumps(errs)}")
    _check(counts_k == counts_p, f"{tag}: K3 takes the plain version's step counts")
    _check(counts_k[2] == 1.0, f"{tag}: the solve reached t1")
    _check(torch.equal(rk.streams[ws.ST_ACC], rp.streams[ws.ST_ACC]),
           f"{tag}: the same accept sequence")
    _check(all(v <= fwd_bound for v in errs.values()), f"{tag}: K3 y1, ys {errs}")
    cur0 = curf = 0
    if saves:
        _check(torch.equal(rk.cursors, rp.cursors), f"{tag}: the same save cursors")
        cur0, curf = rk.cursors.tolist()
        _check(curf == sa.shape[0], f"{tag}: every save row was written")
        _check(torch.equal(rk.ys[:cur0], ys_init[:cur0]), f"{tag}: rows at t0 keep y0")
    abs_f = max((a - b).abs().max().item()
                for a, b in ((rk.y1, rp.y1), (rk.ys, rp.ys)) if a.numel())
    if check_steps is not None:
        check_steps(tag, rk, ns, args)

    ct_y1 = rnd(*y0.shape)
    ct_ys = rnd(*rk.ys.shape) if saves else None
    ct_tel = rnd(4, max_steps, scale=0.1).contiguous()
    d = lambda x: x.double()
    rec64 = ws.SolveRecord(*map(d, rk))
    names = ["ct_t0|ct_t1|ct_dt0", "ct_y0", "ct_f0"] + (["ct_ys_init"] if saves else []) + (
        ["leaves"] if n_leaf_groups == 1 else [f"c_leaf{j}" for j in range(len(leaves))])
    bkw = dict(dynamics=dynamics, saveat=kw.get("saveat"))
    bkw64 = dict(dynamics=dynamics, saveat=d(sa) if saves else None)
    seed_sets = ("y1", "y1+ys", "y1+ys+telemetry") if saves else ("y1", "y1+telemetry")
    for seeds in seed_sets + (("eest",) if eest_only else ()):
        tel = ct_tel if seeds.endswith("telemetry") else torch.zeros_like(ct_tel)
        cy1 = ct_y1
        if seeds == "eest":
            tel[2], cy1 = ct_tel[2], torch.zeros_like(ct_y1)
        cys = None if not saves else (ct_ys if "ys" in seeds else torch.zeros_like(ct_ys))
        gk = ws.whole_solve_bwd(rk, ns, cy1, tel, t0, t1, leaves, tol, tol, ctrl,
                                ct_ys=cys, **bkw)
        if dynamics == "mlp":  # the stream against the replay of the stages
            gr = ws.whole_solve_bwd(rk, ns, cy1, tel, t0, t1, leaves, tol, tol, ctrl,
                                    ct_ys=cys, cache_residuals=False, **bkw)
            _check_streamed_is_replay(tag, seeds, gk, gr, names, saves, n_leaf_groups)
        gp = ws.plain_whole_solve_bwd(rk, ns, cy1, tel, t0, t1, leaves, tol, tol, ctrl,
                                      ct_ys=cys, **bkw)
        g64 = ws.plain_whole_solve_bwd(rec64, ns, d(cy1), d(tel), d(t0), d(t1),
                                       [d(x) for x in leaves], tol, tol, ctrl,
                                       ct_ys=None if cys is None else d(cys), **bkw64)
        torch.cuda.synchronize()
        groups = [_k4_groups(g, n_leaf_groups, saves) for g in (gk, gp, g64)]
        errs = {n: (_rel(a, b), _rel(a, c), _rel(b, c)) for n, a, b, c in zip(names, *groups)}
        print(f"[{tag}] K4 cotangents of {seeds}: rel err (kernel vs plain, kernel vs "
              f"float64, plain vs float64) " + json.dumps(errs))
        for n, (k_p, k_64, p_64) in errs.items():
            _check(k_p == k_p and k_64 == k_64, f"{tag} K4 {n}: no NaN")
            if n == "ct_f0" and seeds in f0_plain:
                _check(k_p <= BWD_BOUND, f"{tag} K4 {n} of {seeds}: {errs[n]}")
            elif n == "ct_f0" and seeds in (f0_bound or {}):
                _check(k_64 <= f0_bound[seeds], f"{tag} K4 {n} of {seeds}: {errs[n]}")
            else:
                _check(k_64 <= 3 * p_64 + 1e-5, f"{tag} K4 {n} of {seeds}: {errs[n]}")
            if n != "ct_f0":
                _check(k_p <= k4_plain[seeds], f"{tag} K4 {n} of {seeds}: {errs[n]}")
        if saves:
            _check(torch.equal(gk[5][cur0:curf], torch.zeros_like(gk[5][cur0:curf]))
                   and torch.equal(gk[5][:cur0], cys[:cur0]),
                   f"{tag} K4: the written rows' cotangent is consumed, the others pass")
        if seeds in ("y1", "y1+ys"):  # the last seeds of rows only
            abs_b = max((a - b).abs().max().item() for a, b in zip(groups[0][1:], groups[1][1:]))
    again = ws.whole_solve_bwd(rk, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl,
                               ct_ys=ct_ys, **bkw)
    first = ws.whole_solve_bwd(rk, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl,
                               ct_ys=ct_ys, **bkw)
    rk2 = ws.whole_solve_fwd(*args, **kw)
    _check(all(torch.equal(a, b) for a, b in zip(again, first)), f"{tag}: K4 is deterministic")
    _check(all(torch.equal(getattr(rk, n), getattr(rk2, n))
               for n in ("y1", "streams", "final", "ys", "cursors"))
           and torch.equal(rk.hy[:ns + 1], rk2.hy[:ns + 1])
           and torch.equal(rk.hf[:ns + 1], rk2.hf[:ns + 1]), f"{tag}: K3 is deterministic")
    print(f"[{tag}] max abs err: K3 (y1, ys) {abs_f!r}, K4 (row cotangents) {abs_b!r}")
    return rk, ns, abs_f, abs_b, args, kw, (ct_y1, ct_ys, ct_tel)


def phase_whole_solve_altmlp_kernels(device, saveat):
    """K3/K4 for AlternatingMLP with the latent cell's 49 saves against
    their plain versions at 256x20x50x4, seeded random weights and y0, at
    rtol=atol=1e-5 and 1.4e-8 (``_whole_solve_vs_plain``): y1 and ys within
    1e-6, K3's steps against K7 (``_check_steps_against_k7``), K4 within
    BWD_BOUND of its plain version with the rows' cotangents and within
    TEL_BWD_BOUND with the telemetry's (every output but ct_f0); ct_f0
    with the cotangent of y1 alone within BWD_BOUND of the plain version.
    CUDA-event times of both kernels at 1.4e-8, and K3's and K4's device
    time a solve there."""
    import torch

    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import whole_solve as ws

    gen = torch.Generator().manual_seed(SEED + 4)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    B, D, H = LATENT_BATCH, LATENT_DIM, LATENT_HIDDEN
    leaves = []
    for _ in range(LATENT_DEPTH):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1),
                   rnd(D, H, scale=H ** -0.5), rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.8)
    func = fg.alternating_mlp_apply(LATENT_DEPTH)
    for tol in (1e-5, FLAGSHIP_TOL):
        rec, ns, abs_f, abs_b, args, kw, (ct_y1, ct_ys, ct_tel) = _whole_solve_vs_plain(
            "whole-altmlp", "altmlp", leaves, y0, func, saveat, tol, LATENT_MAX_STEPS,
            gen=torch.Generator().manual_seed(SEED + 5), fwd_bound=1e-6, n_leaf_groups=1,
            check_steps=_check_steps_against_k7,
            k4_plain={"y1": BWD_BOUND, "y1+ys": BWD_BOUND, "y1+ys+telemetry": TEL_BWD_BOUND},
            f0_plain=("y1",))
    sa = kw["saveat"]
    bwd = (rec, ns, ct_y1, ct_tel, args[0], args[1], leaves, FLAGSHIP_TOL, FLAGSHIP_TOL,
           args[8])
    bkw = dict(dynamics="altmlp", saveat=sa, ct_ys=ct_ys)
    times = {
        "fwd_kernel": _time_ms(lambda: ws.whole_solve_fwd(*args, **kw)),
        "fwd_plain": _time_ms(lambda: ws.plain_whole_solve_fwd(*args, **kw)),
        "bwd_kernel": _time_ms(lambda: ws.whole_solve_bwd(*bwd, **bkw)),
        "bwd_plain": _time_ms(lambda: ws.plain_whole_solve_bwd(*bwd, **bkw)),
    }
    print("[whole-altmlp] median ms over %d runs at %dx%dx%dx%d, %d saves, tol %g, "
          "%d trial steps: %s" % (REPS, B, D, H, LATENT_DEPTH, sa.shape[0], FLAGSHIP_TOL,
                                  ns, json.dumps(times)))
    dev_f = _device_ms(lambda: ws.whole_solve_fwd(*args, **kw), "whole_solve_fwd_kernel")
    dev = _device_ms(lambda: ws.whole_solve_bwd(*bwd, **bkw), "whole_solve_bwd_kernel")
    print(f"[whole-altmlp] device ms a solve of {ns} trial steps: K3 "
          f"whole_solve_fwd_kernel {dev_f!r}; K4 whole_solve_bwd_kernel {dev!r}")
    f_ops, b_ops, leaf = _altmlp_work(B, D, H, LATENT_DEPTH)
    nbytes = _solve_bytes(B * D, leaf, ns, sa.shape[0], LATENT_MAX_STEPS)
    return {
        "whole_solve_altmlp_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:357",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(nbytes[0], ns * f_ops)),
        "whole_solve_altmlp_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:559",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(nbytes[1], ns * b_ops)),
    }


def phase_whole_solve_mlp_saveat(device):
    """The MLPDynamics whole solve with 5 saves (t0 among them) against its
    plain version at 64x40x24, rtol=atol=1e-4: the save cursor on the other
    instantiation (``_whole_solve_vs_plain``, y1 and ys within FWD_BOUND,
    each leaf compared on its own). The weights are drawn at three times
    LeCun's scale, which lifts the error estimate (5e-3 to 4e-2 a step)
    well above its float32 rounding floor: the saves' and the telemetry's
    cotangents reach it through the controller, and at LeCun's scale the
    float32 plain version itself then lies 1e-3 to 3 from float64. So K4 is
    held to BWD_BOUND of its plain version with every seed, and ct_f0 to
    float64 with every seed."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 6)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    B, D, H = 64, 40, 24
    leaves = [rnd(H, D + 1, scale=3 * (D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=3 * (H + 1) ** -0.5), rnd(D, scale=0.1)]
    y0 = torch.rand(B, D, generator=gen).to(device)
    parts = fm._split_params(*leaves)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]
    saveat = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device=device)
    _whole_solve_vs_plain("whole-mlp-saveat", "mlp", leaves, y0, func, saveat, 1e-4,
                          MAX_STEPS, gen=torch.Generator().manual_seed(SEED + 5),
                          fwd_bound=FWD_BOUND, n_leaf_groups=4, check_steps=None,
                          k4_plain=dict.fromkeys(("y1", "y1+ys", "y1+ys+telemetry"),
                                                 BWD_BOUND))


def phase_same_steps_as_step_route(device, batches, saveat, steps):
    """The fused=True run's three steps against fused="step" on the same
    weights and batches: each step's forward on the step kernels (``"while"``
    mode, K7 only) takes the same NFE and accept sequence."""
    import torch

    for i, (batch, rec) in enumerate(zip(batches, steps)):
        model, _ = build_latent(FLAGSHIP_TOL, "step", device, saveat)
        model.init(latent_inputs(*batch[:3]))
        model.load_state_dict(rec["weights"])
        d, m, tp, eps = batch
        with torch.no_grad():
            out = model(latent_inputs(d, m, tp), eps=eps, mode="while")
        tel = out.telemetry
        acc = tel.accepted[tel.live].tolist()
        print(f"[latent-same-steps] step {i}: nfe fused=True {rec['nfe']}, "
              f"fused='step' {out.nfe}; accept sequences equal {acc == rec['accepted']}")
        _check(out.nfe == rec["nfe"] and acc == rec["accepted"],
               f"step {i}: fused=True and fused='step' take the same steps")


# ---------------------------------------------------------------------------
# FFJORD (phases 15-18).
# ---------------------------------------------------------------------------


def _csl_work(B, D, H):
    """K7-CSL's and K8-CSL's f32 operations at B x D x H and the parameters'
    floats. Forward, per row and stage: the three affine maps (D H, H^2, H
    D multiply-adds) and the three hops of the e^T J chain (the same), so 6
    stages x 4 B (2 D H + H^2). Backward: the recompute (the forward's), and
    per stage the three hops' and three layers' input cotangents (the
    forward's products again) and each weight's two outer products (twice
    them): three times the forward."""
    fwd = 6 * 4 * B * (2 * D * H + H * H)
    return fwd, 3 * fwd, 2 * D * H + H * H + 4 * (2 * H + D)


def _csl_inputs(gen, B, D, H, kinetic, device):
    """Seeded CSL leaves (LeCun-scaled weights, biases and time weights at
    0.1 to 1), the probe, and a state ``y`` and random ``k1`` of width D + 1
    or D + 3."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = []
    for n_in, n_out in ((D, H), (H, H), (H, D)):
        leaves += [rnd(n_out, n_in, scale=n_in ** -0.5), rnd(n_out, scale=0.1),
                   rnd(n_out, 1), rnd(n_out, 1), rnd(n_out, scale=0.1)]
    A = D + (3 if kinetic else 1)
    leaves.append(rnd(B, D))
    return leaves, rnd(B, A, scale=0.5), rnd(B, A, scale=0.3)


def phase_csl_kernels(device):
    """K7-CSL/K8-CSL against their plain versions at the FFJORD width
    (1024 x 44 x 100, and 1024 x 46 with the kinetic terms) on seeded random
    inputs (random k1 keeps the embedded error far above float32 rounding),
    at rtol=atol=1e-5 and 1.4e-8: K7-CSL's rows bitwise equal to its plain
    version's and its sums bitwise equal to the plain version's terms summed
    in the kernel's order (``fc.csl_slot_order_sums``, one slot a 2-row
    sub-tile of its 8-row tiles); K8-CSL within BWD_BOUND; both bitwise
    deterministic; CUDA-event times at 1.4e-8, without the kinetic terms
    (the main path's shape); K7-CSL's and K8-CSL's device time, kernel and
    slot sum apart, and their blocks a launch, one wave."""
    import torch

    from regneuralde_tpu_torch.ops import fused_csl as fc
    from regneuralde_tpu_torch.ops import ode

    B, D, H = FFJORD_BATCH, FFJORD_DIM, FFJORD_HIDDEN
    t = torch.tensor(0.07, device=device)
    dt = torch.tensor(0.11, device=device)
    names_b = ["ct_t|ct_dt", "ct_y", "ct_k1", "params"]
    groups = lambda g: [torch.stack(g[:2]), g[2], g[3],
                        torch.cat([x.flatten() for x in g[4][:fc.N_PARAMS]])]
    for kinetic in (False, True):
        gen = torch.Generator().manual_seed(SEED + 12)
        leaves, y, k1 = _csl_inputs(gen, B, D, H, kinetic, device)
        cts = [torch.randn(y.shape, generator=gen).to(device),
               torch.randn(y.shape, generator=gen).to(device),
               torch.tensor(0.7, device=device), torch.tensor(1.3, device=device),
               torch.tensor(-0.4, device=device)]
        for tol in (1e-5, FLAGSHIP_TOL):
            kf = fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
            terms = ode.normed_terms(fc.csl_aug_apply(D, kinetic), t, dt, y, k1,
                                     tuple(leaves), tol, tol)
            want_sums = fc.csl_slot_order_sums(terms[2:])
            kb = fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
            pb = fc._csl_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
            torch.cuda.synchronize()
            rows_eq = torch.equal(kf.y_new, terms[0]) and torch.equal(kf.k_last, terms[1])
            sums_eq = all(torch.equal(a, b) for a, b in zip(kf[2:], want_sums))
            plain_sums = fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)[2:]
            sums_rel = max(_rel(a, b) for a, b in zip(kf[2:], plain_sums))
            errs_b = {n: _rel(a, b) for n, a, b in zip(names_b, groups(kb), groups(pb))}
            print(f"[csl] kinetic={kinetic} tol={tol:g} K7-CSL rows bitwise {rows_eq}, "
                  f"sums bitwise (kernel order) {sums_eq}, sums rel err against "
                  f"torch.sum {sums_rel:.3e}; K8-CSL rel err " + json.dumps(errs_b))
            _check(rows_eq, f"K7-CSL rows at kinetic={kinetic}, tol {tol}")
            _check(sums_eq, f"K7-CSL sums at kinetic={kinetic}, tol {tol}")
            _check(all(v == v and v <= BWD_BOUND for v in errs_b.values()),
                   f"K8-CSL at kinetic={kinetic}, tol {tol}: {errs_b}")
            again_f = fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
            again_b = fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
            _check(all(torch.equal(a, b) for a, b in zip(kf, again_f)),
                   "K7-CSL is deterministic")
            _check(all(torch.equal(a, b) for a, b in zip(groups(kb), groups(again_b))),
                   "K8-CSL is deterministic")
        if not kinetic:
            main = (leaves, y, k1, cts)

    # max_abs_err of the record at the flagship tolerance, without the
    # kinetic terms: K7-CSL over its rows, K8-CSL with only the row
    # cotangents seeded (as phase 2)
    leaves, y, k1, cts = main
    tol = FLAGSHIP_TOL
    kf = fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    pf = fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    row_cts = [cts[0], cts[1], *(torch.zeros((), device=device) for _ in range(3))]
    kb = fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, row_cts, tol, tol)
    pb = fc._csl_bwd_math(t, dt, y, k1, leaves, row_cts, tol, tol)
    torch.cuda.synchronize()
    abs_f = max((a - b).abs().max().item() for a, b in zip(kf[:2], pf[:2]))
    abs_b = max((a - b).abs().max().item() for a, b in zip(groups(kb), groups(pb)))
    print(f"[csl] max abs err: K7-CSL (y_new, k7) {abs_f!r}, K8-CSL (row cotangents) "
          f"{abs_b!r}")
    times = {
        "fwd_kernel": _time_ms(lambda: fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)),
        "fwd_plain": _time_ms(lambda: fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, tol,
                                                                tol)),
        "bwd_kernel": _time_ms(lambda: fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts,
                                                               tol, tol)),
        "bwd_plain": _time_ms(lambda: fc._csl_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)),
    }
    print("[csl] median ms over %d runs at %dx%dx%d: %s"
          % (REPS, B, D + 1, H, json.dumps(times)))
    # K7-CSL's and K8-CSL's device time, each kernel and its slot sum apart,
    # and their grids
    from regneuralde_tpu_torch.ops import _cuda

    lib, sms = _cuda.library(), torch.cuda.get_device_properties(0).multi_processor_count
    fc.check_fwd_plan(lib, D + 1, D, H, False)
    fplan = fc.csl_fwd_plan(B, D, H, False)
    fblocks = fplan.tiles
    fwd = lambda: fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    dev_fk, dev_fs = _device_ms(fwd, "csl_fwd_kernel"), _device_ms(fwd, "sum_slots_warp_kernel")
    print(f"[csl] K7-CSL: {fblocks} blocks of {fplan.rows} rows a launch on {sms} SMs, "
          f"{fplan.smem_bytes} bytes of shared memory a block, {fplan.slots} norm-sum "
          f"slots; device ms a launch: csl_fwd_kernel {dev_fk!r}, sum_slots_warp_kernel "
          f"{dev_fs!r}")
    _check(fblocks <= sms, f"K7-CSL runs in one wave: {fblocks} blocks on {sms} SMs")
    rows = lib.regnde_csl_bwd_rows()
    blocks = (B + rows - 1) // rows
    bwd = lambda: fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    dev_k, dev_s = _device_ms(bwd, "csl_bwd_kernel"), _device_ms(bwd, "sum_slots_kernel")
    print(f"[csl] K8-CSL: {blocks} blocks of {rows} rows a launch on {sms} SMs; device ms "
          f"a launch: csl_bwd_kernel {dev_k!r}, sum_slots_kernel {dev_s!r}")
    _check(blocks <= sms, f"K8-CSL runs in one wave: {blocks} blocks on {sms} SMs")
    f_ops, b_ops, leaf = _csl_work(B, D, H)
    BA, BD = B * (D + 1), B * D
    return {
        "csl_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_generic.py:208",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(4 * (4 * BA + BD + leaf), f_ops)),
        "csl_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_generic.py:278",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(4 * (6 * BA + BD + 2 * leaf), b_ops)),
    }


def ffjord_batches(n, device):
    """``n`` batches of the MiniBooNE surrogate (``load_miniboone`` without
    data files, the experiment's seed) and a Hutchinson probe for each,
    drawn from a seeded generator."""
    import torch

    from regneuralde_tpu_torch.data import load_miniboone

    train, _ = load_miniboone(FFJORD_BATCH, seed=FFJORD_DATA_SEED)
    gen = torch.Generator().manual_seed(SEED + 11)
    out = []
    for x in train:
        out.append((torch.as_tensor(x, device=device),
                    torch.randn(x.shape, generator=gen).to(device)))
        if len(out) == n:
            return out
    raise AssertionError(f"the loader gave fewer than {n} batches")


def build_ffjord(tol, fused, device, seed=SEED):
    """``FFJORD(CSLDynamics(43, 100))`` of ``experiments/ffjord_tabular.py``
    at full width, Tsit5, max_steps=128, weights from
    ``torch.Generator(seed)``."""
    import torch

    from regneuralde_tpu_torch.models import FFJORD, CSLDynamics

    gen = torch.Generator().manual_seed(seed)
    return FFJORD(CSLDynamics(FFJORD_DIM, FFJORD_HIDDEN, device=device, generator=gen),
                  input_dim=FFJORD_DIM, rtol=tol, atol=tol, max_steps=FFJORD_MAX_STEPS,
                  fused=fused)


def ffjord_loss(model, x, e, reg_weight=None):
    """``experiments/ffjord_common.py``'s objective with ``regularize``:
    -mean(logpx) + lambda * error_estimate(mean), lambda the annealing
    schedule's first value (5e3)."""
    import torch

    from regneuralde_tpu_torch import reg

    out = model(x, e=e)
    lam = FFJORD_REG if reg_weight is None else reg_weight
    return -torch.mean(out.logpx) + lam * reg.error_estimate(out.telemetry, "mean"), out


def phase_whole_solve_csl_kernels(device, batch):
    """K3/K4-CSL against their plain versions at the FFJORD width on seeded
    random weights, the state a MiniBooNE batch and its probe, at
    rtol=atol=1e-1, 1e-5 and 1.4e-8 (``_whole_solve_vs_plain``): the same steps,
    the solve reaching t1, y1 within 1e-6, every stored trial step bitwise
    K7-CSL's and its controller bitwise ``ode._post``'s, K4 within
    BWD_BOUND of its plain version on every output but ct_f0, and every
    output, ct_f0 included, within 3 times the plain version's distance
    from a float64 walk. With the telemetry's cotangents K4 is held to its
    plain version within TEL_BWD_BOUND at 1e-5 and CSL_TEL_BWD_BOUND at
    1.4e-8, where the error estimate sits at its float32 floor and both
    float32 walks lie far from float64 (the time scalars 0.30, the leaves
    0.054, on the H100); at 1e-1, with them and with the eest telemetry's
    cotangent alone, within CSL_LOOSE_BWD_BOUND. (ct_f0 with y1's cotangent alone is rounding in
    any float32 walk, as in phase 11: at 1.4e-8 K4 lay 1.8e-3 from its
    plain version and 1.2e-3 from float64, the plain version 6.4e-4, on
    the H100.) Bitwise determinism; CUDA-event times at 1.4e-8; K3-CSL's
    cooperative grid (one block a tile) and its and K4-CSL's device time a
    solve."""
    import torch

    from regneuralde_tpu_torch.ops import fused_csl as fc
    from regneuralde_tpu_torch.ops import whole_solve as ws

    x, e = batch
    B, D, H = FFJORD_BATCH, FFJORD_DIM, FFJORD_HIDDEN
    leaves, _, _ = _csl_inputs(torch.Generator().manual_seed(SEED + 13), B, D, H, False,
                               device)
    leaves[-1] = e
    y0 = torch.cat([x, torch.zeros(B, 1, device=device)], dim=1)
    func = fc.csl_aug_apply(D, False)
    check = lambda tag, rec, ns, args: _check_steps_against_k7(tag, rec, ns, args,
                                                               fc.csl_normed_sweep)
    for tol, tel_bound in CSL_K4_CASES.items():
        rec, ns, abs_f, abs_b, args, kw, (ct_y1, _, ct_tel) = _whole_solve_vs_plain(
            "whole-csl", "csl", leaves, y0, func, None, tol, FFJORD_MAX_STEPS,
            gen=torch.Generator().manual_seed(SEED + 5), fwd_bound=1e-6, n_leaf_groups=1,
            check_steps=check, eest_only=tol >= 1e-3,
            k4_plain={"y1": BWD_BOUND, "y1+telemetry": tel_bound, "eest": tel_bound})
    bwd = (rec, ns, ct_y1, ct_tel, args[0], args[1], leaves, FLAGSHIP_TOL, FLAGSHIP_TOL,
           args[8])
    times = {
        "fwd_kernel": _time_ms(lambda: ws.whole_solve_fwd(*args, **kw)),
        "fwd_plain": _time_ms(lambda: ws.plain_whole_solve_fwd(*args, **kw)),
        "bwd_kernel": _time_ms(lambda: ws.whole_solve_bwd(*bwd, dynamics="csl")),
        "bwd_plain": _time_ms(lambda: ws.plain_whole_solve_bwd(*bwd, dynamics="csl")),
    }
    print("[whole-csl] median ms over %d runs at %dx%dx%d, tol %g, %d trial steps: %s"
          % (REPS, B, D + 1, H, FLAGSHIP_TOL, ns, json.dumps(times)))
    from regneuralde_tpu_torch.ops import _cuda

    tiles = (B + fc.CSL_FWD_ROWS - 1) // fc.CSL_FWD_ROWS
    grid = _cuda.library().regnde_whole_solve_csl_fwd_grid(B, D + 1, H, 0)
    dev_f = _device_ms(lambda: ws.whole_solve_fwd(*args, **kw), "whole_solve_fwd_kernel")
    print(f"[whole-csl] K3-CSL: a cooperative grid of {grid} blocks for {tiles} tiles of "
          f"{fc.CSL_FWD_ROWS} rows; device ms a solve of {ns} trial steps: "
          f"whole_solve_fwd_kernel {dev_f!r}")
    _check(grid == tiles, f"K3-CSL runs one tile a block: a grid of {grid} for {tiles} tiles")
    dev = _device_ms(lambda: ws.whole_solve_bwd(*bwd, dynamics="csl"),
                     "whole_solve_bwd_kernel")
    print(f"[whole-csl] K4-CSL device ms a solve of {ns} trial steps: "
          f"whole_solve_bwd_kernel {dev!r}")
    f_ops, b_ops, leaf = _csl_work(B, D, H)
    # the probe is read like a leaf
    nbytes = _solve_bytes(B * (D + 1), leaf + B * D, ns, 0, FFJORD_MAX_STEPS)
    return {
        "whole_solve_csl_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:357",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(nbytes[0], ns * f_ops)),
        "whole_solve_csl_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:559",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(nbytes[1], ns * b_ops)),
    }


def phase_ffjord_kernel_vs_plain_step(device, batch, fused):
    """One forward+backward of the FFJORD training step at rtol=atol=1e-5 on
    ``fused`` (K7/K8-CSL on ``"step"``, K3/K4-CSL on ``True``) against
    ``fused=False`` (their plain versions) on the same weights and probe:
    the same NFE and accept sequence, the gradient of -mean(logpx) within
    GRAD_BOUND and of the regularized loss within REG_GRAD_BOUND."""
    import torch

    x, e = batch
    tol = 1e-5
    results = {}
    for name, f in (("kernel", fused), ("plain", False)):
        model = build_ffjord(tol, f, device)
        for reg_weight in (0.0, FFJORD_REG):
            model.zero_grad(set_to_none=True)
            loss, out = ffjord_loss(model, x, e, reg_weight)
            loss.backward()
            torch.cuda.synchronize()
            tel = out.telemetry
            results[name, reg_weight] = dict(
                loss=loss.item(), nfe=out.nfe, success=out.solution.stats.success,
                accepted=tel.accepted[tel.live].tolist(),
                grad=torch.cat([p.grad.flatten() for p in model.parameters()]),
                logpx=out.logpx.detach())
    for reg_weight, bound in ((0.0, GRAD_BOUND), (FFJORD_REG, REG_GRAD_BOUND)):
        k, p = results["kernel", reg_weight], results["plain", reg_weight]
        g_err = _rel(k["grad"], p["grad"])
        print(f"[ffjord-step] fused={fused!r} rtol=atol={tol:g} reg_weight={reg_weight:g} "
              f"nfe kernel={k['nfe']} plain={p['nfe']} success={k['success']} "
              f"loss kernel={k['loss']!r} plain={p['loss']!r} "
              f"logpx rel err={_rel(k['logpx'], p['logpx']):.3e} "
              f"grad rel err={g_err:.3e} (bound {bound:g})")
        _check(k["success"] and p["success"], "both solves reached t1")
        _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
        _check(k["accepted"] == p["accepted"], "same accept sequence")
        _check(tuple(k["logpx"].shape) == (FFJORD_BATCH,), "logpx shape")
        _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
        _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_ffjord_slice(device, batches, fused):
    """Three training steps of the FFJORD configuration on ``fused``
    (WeightDecay(1e-5) then Adam(1e-2)). Returns the launch counts of that
    run (on ``"step"`` K7-CSL and K8-CSL once per trial step, on ``True``
    each CSL whole-solve kernel once per training step, no other kernel),
    per step the weights it started from, its NFE and accept sequence, and
    the steps' wall ms. A solve that misses t1 within 128 trial steps is
    printed, not refused."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        ffjord_optimizer,
        make_train_step,
    )

    model = build_ffjord(FLAGSHIP_TOL, fused, device)
    optimizer = ffjord_optimizer(1e-2)
    state = create_train_state(model, optimizer)
    step = make_train_step(ffjord_loss, optimizer)
    before = [p.detach().clone() for p in model.parameters()]

    torch.cuda.synchronize()
    counters = _counters()
    for mod in counters:  # count only this path's launches
        mod.reset_launches()
    trial_steps = 0
    steps, walls = [], []
    for i, batch in enumerate(batches):
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        start = time.perf_counter()
        state, loss, out = step(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        walls.append(wall * 1e3)
        tel = out.telemetry
        naccept = int(tel.accepted.sum().item())
        nlive = int(tel.live.sum().item())
        trial_steps += nlive
        steps.append(dict(weights=weights, nfe=out.nfe,
                          accepted=tel.accepted[tel.live].tolist()))
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        print(f"[ffjord] fused={fused!r} step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} "
              f"success={out.solution.stats.success} ms={wall * 1e3!r} "
              f"launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
        _check(tuple(out.logpx.shape) == (FFJORD_BATCH,), "logpx shape")
        _check(torch.isfinite(out.logpx).all().item(), "finite logpx")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(model.parameters(), before))
    print(f"[ffjord] fused={fused!r} trial steps={trial_steps} "
          f"launches={json.dumps(launches)} max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    want = {k: 0 for k in launches}
    if fused == "step":
        want.update(csl_tsit5_fwd=trial_steps, csl_tsit5_bwd=trial_steps)
    else:
        want.update(whole_solve_csl_fwd=len(batches), whole_solve_csl_bwd=len(batches))
    _check(launches == want, f"FFJORD launches {launches}, expected {want}")
    return launches, steps, walls


def phase_ffjord_same_steps(device, batches, steps):
    """The fused=True run's three steps against fused="step" on the same
    weights, batches and probes: each step's forward on K7-CSL (``"while"``
    mode) takes the same NFE and accept sequence."""
    import torch

    for i, (batch, rec) in enumerate(zip(batches, steps)):
        model = build_ffjord(FLAGSHIP_TOL, "step", device)
        model.load_state_dict(rec["weights"])
        x, e = batch
        with torch.no_grad():
            out = model(x, e=e, mode="while")
        tel = out.telemetry
        acc = tel.accepted[tel.live].tolist()
        print(f"[ffjord-same-steps] step {i}: nfe fused=True {rec['nfe']}, "
              f"fused='step' {out.nfe}; accept sequences equal {acc == rec['accepted']}")
        _check(out.nfe == rec["nfe"] and acc == rec["accepted"],
               f"step {i}: fused=True and fused='step' take the same steps")


# ---------------------------------------------------------------------------
# The MNIST Neural SDE (phases 19-21).
# ---------------------------------------------------------------------------


def _sde_work(B, D, H, tab_name, ns):
    """K9's and K10's f32 operations over ns trial steps of the MLP pair
    (drift D -> H -> D, diffusion D -> D) and the leaves' floats: per trial
    step the tableau's drift evaluations (4 B D H each) and diffusion
    evaluations (2 B D^2 each); K10 recomputes them and, per layer, takes
    the input's and the weights' cotangents, three times the forward. The
    affine maps summed in float64 are the port's choice; the function is
    float32."""
    from regneuralde_tpu_torch.ops.sri import analyze, get_tableau

    an = analyze(get_tableau(tab_name))
    fwd = ns * (an.n_drift_evals * 4 * B * D * H + an.n_diffusion_evals * 2 * B * D * D)
    return fwd, 3 * fwd, 2 * D * H + H + D + D * D + D


def _sde_bytes(BD, leaf, ns, n_save, S):
    """Bytes K9 and K10 must move over a solve of ns trial steps: K9 reads
    y0, the leaves, the ns rows of both draws and ys_init and writes y1, ys,
    the history (ns + 1 rows of y, tail_w, tail_z) and the streams; K10
    reads the history, the draws, the streams, the leaves and the cotangents
    of y1, ys and the telemetry, and writes those of y0, ys_init and the
    leaves."""
    hist = 3 * (ns + 1) * BD
    fwd = BD + leaf + 2 * ns * BD + n_save * BD + BD + n_save * BD + hist + 12 * S
    bwd = hist + 2 * ns * BD + 12 * S + leaf + BD + n_save * BD + 4 * S + BD + n_save * BD + leaf
    return 4 * fwd, 4 * bwd


def _report_bwd_schedule(tag, gk, rk, bwd_args, ct_ys, bkw):
    """K10's outputs (seeded with the rows' and the telemetry's cotangents)
    against its order of sums in plain PyTorch on the card
    (``sw.plain_sde_bwd_tiles``; ``test_sde_bwd_matches_its_schedule``
    holds them bitwise): the largest difference by output."""
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw

    want = sw.plain_sde_bwd_tiles(rk, *bwd_args, ct_ys=ct_ys, **bkw)
    diff = [(a - b).abs().max().item() if a.numel() else 0.0 for a, b in zip(gk, want)]
    print(f"[{tag}] K10 against its schedule, max abs difference by output: {diff}")


def _ptxas_of(*parts):
    """What ``ptxas -v`` reported (registers, stack) for the first kernel
    whose mangled name holds every one of ``parts``."""
    from regneuralde_tpu_torch.ops import _cuda

    out, name = [], None
    for line in _cuda.ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            if out:
                break
            name = m.group(1)
        elif name and all(p in name for p in parts) and (
                "registers" in line or "stack frame" in line):
            out.append(line.split(":", 1)[-1].strip())
    return "; ".join(out) or "not reported"


def _sde_kernel_report(tag, B, widths, body, fwd, bwd):
    """K9's and K10's blocks, shared memory, registers and stack (the
    instance the pair runs on), and device ms a solve, K10's kernel and its
    slot sum apart; checks the plan against the library."""
    import torch

    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = sw.check_sde_plan(_cuda.library(), tuple(widths), body)
    blocks = sw.sde_tile_plan(B, sw._net_widths(widths), body).tiles
    inst = ("CubicPair" if body == "cubic" else "MlpPair",
            "FixedWidths" if plan.fixed_instance else "DynWidths")
    dev = {"K9": _device_ms(fwd, "sde_whole_solve_fwd_kernel"),
           "K10": _device_ms(bwd, "sde_whole_solve_bwd_kernel"),
           "K10_slot_sum": _device_ms(bwd, "sum_slots_kernel")}
    for k, kern, smem in (("K9", "sde_whole_solve_fwd_kernel", plan.fwd_smem_bytes),
                          ("K10", "sde_whole_solve_bwd_kernel", plan.bwd_smem_bytes)):
        print(f"[{tag}] {k} ({inst[0]}, {inst[1]}): {blocks} blocks of {plan.rows} rows on "
              f"{sms} SMs, {smem} bytes of shared memory a block; ptxas: "
              f"{_ptxas_of(kern, *inst)}")
    print(f"[{tag}] device ms a solve: " + json.dumps(dev))
    _check(blocks <= sms, f"{tag}: K9 and K10 hold one tile a block ({blocks} on {sms} SMs)")
    return dev


def phase_sde_kernels(device):
    """K9/K10 against their plain versions at the MNIST NSDE width (512 x
    32, drift 32-64-32, diffusion 32-32, SOSRI2) on seeded random weights,
    state and draws: at rtol=atol=1.4e-1 (max_steps 128) and at
    NSDE_TIGHT_TOL (max_steps 256, with rejections) with 5 saves. The same
    accept sequence, step counts and save cursors; y1 and ys within
    NSDE_FWD_BOUND; K10 against its plain version within BWD_BOUND seeded
    with the rows' cotangents, TEL_BWD_BOUND with the telemetry's too, and
    every output within 3 times the float32 plain version's distance from a
    float64 walk, plus 1e-5, and its distance from its order of sums in
    plain PyTorch (``sw.plain_sde_bwd_tiles``) printed; both kernels
    bitwise deterministic;
    CUDA-event times of both kernels and plain versions at both
    tolerances; both
    kernels' blocks, shared memory, registers and stack, and their device
    time under the profiler, K10's slot sum apart (as phase 8's)."""
    import torch

    from regneuralde_tpu_torch.ops import sde as sde_ops
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(SEED + 21)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    B, D, H = NSDE_BATCH, NSDE_DIM, NSDE_HIDDEN
    leaves = [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
              rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.5)
    ctrl = PIController(beta1=0.5, beta2=0.0)
    t0, t1 = torch.tensor(0.0, device=device), torch.tensor(1.0, device=device)
    dt0 = torch.tensor(0.01, device=device)
    out, times = {}, {}
    for tol, S, sa in ((NSDE_TOL, NSDE_MAX_STEPS, None),
                       (NSDE_TIGHT_TOL, 256, [0.0, 0.25, 0.5, 0.75, 1.0])):
        xi = sde_ops.presample_noise(torch.Generator(device=device).manual_seed(SEED + 22),
                                     (B, D), S)
        kw = dict(n_drift=2, solver="sosri2")
        saves = sa is not None
        if saves:
            sat, ys_init = sde_ops.save_rows_at_start(torch.tensor(sa, device=device), t0, y0)
            kw.update(saveat=sat, ys_init=ys_init)
        args = (t0, t1, dt0, y0, leaves, tol, tol, ctrl, S, *xi)
        rk = sw.sde_whole_solve_fwd(*args, **kw)
        rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
        torch.cuda.synchronize()
        ck, cp = rk.final[3:].tolist(), rp.final[3:].tolist()
        ns = int(ck[0] + ck[1])
        errs = {"y1": _rel(rk.y1, rp.y1), **({"ys": _rel(rk.ys, rp.ys)} if saves else {})}
        tag = f"sde tol={tol:g}"
        print(f"[{tag}] (naccept, nreject, done) kernel={ck} plain={cp}; cursors kernel="
              f"{rk.cursors.tolist()} plain={rp.cursors.tolist()}; rel err {json.dumps(errs)}")
        _check(ck == cp and ck[2] == 1.0, f"{tag}: K9 takes the plain version's steps to t1")
        _check(torch.equal(rk.streams[sw.ST_ACC], rp.streams[sw.ST_ACC]),
               f"{tag}: the same accept sequence")
        _check(torch.equal(rk.cursors, rp.cursors), f"{tag}: the same save cursors")
        _check(all(v <= NSDE_FWD_BOUND for v in errs.values()), f"{tag}: K9 y1, ys {errs}")
        if tol == NSDE_TIGHT_TOL:
            _check(ck[1] > 0, f"{tag}: the tight solve has rejections")
        abs_f = max((a - b).abs().max().item()
                    for a, b in ((rk.y1, rp.y1), (rk.ys, rp.ys)) if a.numel())

        ct_y1, ct_tel = rnd(B, D), rnd(4, S, scale=0.1).contiguous()
        ct_ys = rnd(len(sa), B, D) if saves else None
        d = lambda x: x.double()
        rec64 = sw.SDERecord(*map(d, rk))
        bkw = dict(n_drift=2, solver="sosri2", saveat=kw.get("saveat"))
        bkw64 = dict(bkw, saveat=d(kw["saveat"]) if saves else None)
        names = ["ct_t0|ct_t1|ct_dt0", "ct_y0"] + (["ct_ys_init"] if saves else []) + [
            f"c_leaf{j}" for j in range(6)]
        groups = lambda g: [torch.stack(g[:3]), g[3]] + ([g[4]] if saves else []) + list(g[5:])
        for seeds, bound in (("rows", BWD_BOUND), ("rows+telemetry", TEL_BWD_BOUND)):
            tel = ct_tel if seeds.endswith("telemetry") else torch.zeros_like(ct_tel)
            bargs = (ns, ct_y1, tel, t0, t1, leaves, tol, tol, ctrl, *xi)
            gk = sw.sde_whole_solve_bwd(rk, *bargs, ct_ys=ct_ys, **bkw)
            gp = sw.plain_sde_whole_solve_bwd(rk, *bargs, ct_ys=ct_ys, **bkw)
            g64 = sw.plain_sde_whole_solve_bwd(
                rec64, ns, d(ct_y1), d(tel), d(t0), d(t1), [d(x) for x in leaves], tol, tol,
                ctrl, d(xi[0]), d(xi[1]), ct_ys=None if ct_ys is None else d(ct_ys), **bkw64)
            torch.cuda.synchronize()
            e = {n: (_rel(a, b), _rel(a, c), _rel(b, c))
                 for n, a, b, c in zip(names, groups(gk), groups(gp), groups(g64))}
            print(f"[{tag}] K10 cotangents of {seeds}: rel err (kernel vs plain, kernel vs "
                  "float64, plain vs float64) " + json.dumps(e))
            for n, (k_p, k_64, p_64) in e.items():
                _check(k_p == k_p and k_64 == k_64, f"{tag} K10 {n}: no NaN")
                _check(k_p <= bound, f"{tag} K10 {n} of {seeds}: {e[n]}")
                _check(k_64 <= 3 * p_64 + 1e-5, f"{tag} K10 {n} of {seeds}: {e[n]}")
            if seeds == "rows":
                abs_b = max((a - b).abs().max().item() for a, b in zip(gk[3:], gp[3:])
                            if a.numel())
            else:
                bwd_args = bargs
        again = sw.sde_whole_solve_bwd(rk, *bwd_args, ct_ys=ct_ys, **bkw)
        rk2 = sw.sde_whole_solve_fwd(*args, **kw)
        _check(all(torch.equal(a, b) for a, b in zip(gk, again)), f"{tag}: K10 is deterministic")
        _check(all(torch.equal(getattr(rk, n), getattr(rk2, n))
                   for n in ("y1", "streams", "final", "ys", "cursors"))
               and all(torch.equal(getattr(rk, n)[:ns + 1], getattr(rk2, n)[:ns + 1])
                       for n in ("hy", "hw", "hz")), f"{tag}: K9 is deterministic")
        _report_bwd_schedule(tag, gk, rk, bwd_args, ct_ys, bkw)
        print(f"[{tag}] max abs err: K9 (y1, ys) {abs_f!r}, K10 (row cotangents) {abs_b!r}")
        times[tol] = {
            "fwd_kernel": _time_ms(lambda: sw.sde_whole_solve_fwd(*args, **kw)),
            "fwd_plain": _time_ms(lambda: sw.plain_sde_whole_solve_fwd(*args, **kw)),
            "bwd_kernel": _time_ms(lambda: sw.sde_whole_solve_bwd(rk, *bwd_args, ct_ys=ct_ys,
                                                                  **bkw)),
            "bwd_plain": _time_ms(lambda: sw.plain_sde_whole_solve_bwd(rk, *bwd_args,
                                                                       ct_ys=ct_ys, **bkw)),
        }
        print("[%s] median ms over %d runs at %dx%dx%d, %d trial steps, %d saves: %s"
              % (tag, REPS, B, D, H, ns, len(sa) if saves else 0, json.dumps(times[tol])))
        _sde_kernel_report(tag, B, sw._pair_widths(leaves, 2, D), "mlp",
                           lambda: sw.sde_whole_solve_fwd(*args, **kw),
                           lambda: sw.sde_whole_solve_bwd(rk, *bwd_args, ct_ys=ct_ys, **bkw))
        if tol == NSDE_TOL:
            f_ops, b_ops, leaf = _sde_work(B, D, H, "sosri2", ns)
            nbytes = _sde_bytes(B * D, leaf, ns, 0, S)
            out = {
                "sde_whole_solve_fwd": dict(
                    replaces="regneuralde_tpu/ops/pallas_sde.py:227",
                    max_abs_err=abs_f, ms=times[tol]["fwd_kernel"],
                    plain_ms=times[tol]["fwd_plain"], **_bound(nbytes[0], f_ops)),
                "sde_whole_solve_bwd": dict(
                    replaces="regneuralde_tpu/ops/pallas_sde.py:370",
                    max_abs_err=abs_b, ms=times[tol]["bwd_kernel"],
                    plain_ms=times[tol]["bwd_plain"], **_bound(nbytes[1], b_ops)),
            }
    return out


def build_nsde(solver, fused, device, seed=SEED):
    """The MNIST Neural SDE of ``experiments/mnist_nsde.py`` at full width:
    ``ClassifierNSDE(Linear(784, 32), NeuralSDE(MLP(32, (64, 32)), MLP(32,
    (32,)), solver, rtol=atol=1.4e-1, max_steps 128), Linear(32, 10))``,
    weights from ``torch.Generator(seed)``."""
    import torch

    from regneuralde_tpu_torch.models import MLP, ClassifierNSDE, NeuralSDE
    from regneuralde_tpu_torch.models.basic import init_linear

    gen = torch.Generator().manual_seed(seed)
    pre, post = torch.nn.Linear(784, NSDE_DIM), torch.nn.Linear(NSDE_DIM, 10)
    init_linear(pre, gen)
    nsde = NeuralSDE(MLP(NSDE_DIM, (NSDE_HIDDEN, NSDE_DIM), device=device, generator=gen),
                     MLP(NSDE_DIM, (NSDE_DIM,), device=device, generator=gen),
                     tspan=(0.0, 1.0), solver=solver, rtol=NSDE_TOL, atol=NSDE_TOL,
                     max_steps=NSDE_MAX_STEPS, fused=fused)
    init_linear(post, gen)
    return ClassifierNSDE(pre, nsde, post).to(device)


def nsde_noise(i, device):
    """The draws of training step ``i``: one pair of (128, 512, 32) buffers
    from a generator on the card."""
    import torch

    from regneuralde_tpu_torch.ops.sde import presample_noise

    gen = torch.Generator(device=device).manual_seed(SEED + 23 + i)
    return presample_noise(gen, (NSDE_BATCH, NSDE_DIM), NSDE_MAX_STEPS, device=device)


def nsde_loss(model, x, y, noise, reg_type="stiff_est", reg_weight=None):
    """``experiments/mnist_nsde.py``'s objective: cross-entropy + lambda *
    regularizer, ``stiff_est`` (0.1 * stiffness_estimate over SOSRI2's
    stability size) or ``error_est`` (10 * error_estimate), means over the
    accepted steps."""
    import torch

    from regneuralde_tpu_torch import reg
    from regneuralde_tpu_torch.ops.sri import get_tableau, stability_size

    solver, lam = NSDE_REGS[reg_type]
    out = model(x, noise=noise)
    ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
    if reg_type == "stiff_est":
        r = reg.stiffness_estimate(out.telemetry, stability_size(get_tableau(solver)), "mean")
    else:
        r = reg.error_estimate(out.telemetry, "mean")
    return ce + (lam if reg_weight is None else reg_weight) * r, out


def phase_nsde_kernel_vs_plain_step(device, batch):
    """One MNIST NSDE training step (forward and backward) on ``fused=True``
    (K9/K10) against ``fused=False`` (``ops.sde.sdeint`` over the modules)
    on the same weights and draws, for both regularizers: the same NFE and
    accept sequence, the cross-entropy's gradient within GRAD_BOUND and the
    regularized one within REG_GRAD_BOUND."""
    import torch

    x, y = batch
    noise = nsde_noise(0, device)
    for reg_type, (solver, lam) in NSDE_REGS.items():
        results = {}
        for name, fused in (("kernel", True), ("plain", False)):
            model = build_nsde(solver, fused, device)
            for reg_weight in (0.0, lam):
                model.zero_grad(set_to_none=True)
                loss, out = nsde_loss(model, x, y, noise, reg_type, reg_weight)
                loss.backward()
                torch.cuda.synchronize()
                tel = out.telemetry
                results[name, reg_weight] = dict(
                    loss=loss.item(), nfe=(out.nfe1, out.nfe2), success=out.success,
                    accepted=tel.accepted[tel.live].tolist(),
                    grad=torch.cat([p.grad.flatten() for p in model.parameters()]),
                    logits=out.logits.detach())
        for reg_weight, bound in ((0.0, GRAD_BOUND), (lam, REG_GRAD_BOUND)):
            k, p = results["kernel", reg_weight], results["plain", reg_weight]
            g_err = _rel(k["grad"], p["grad"])
            print(f"[nsde-step] {reg_type} ({solver}) reg_weight={reg_weight:g} nfe kernel="
                  f"{k['nfe']} plain={p['nfe']} loss kernel={k['loss']!r} plain={p['loss']!r} "
                  f"logits rel err={_rel(k['logits'], p['logits']):.3e} "
                  f"grad rel err={g_err:.3e} (bound {bound:g})")
            _check(k["success"] and p["success"], "both solves reached t1")
            _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
            _check(k["accepted"] == p["accepted"], "same accept sequence")
            _check(tuple(k["logits"].shape) == (NSDE_BATCH, 10), "logits shape")
            _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
            _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_nsde_slice(device, batches):
    """Three training steps of the MNIST NSDE configuration on
    ``fused=True`` (SOSRI2, stiff_est, InvDecay(1e-5) then Adam(0.01)), the
    draws of each step from a generator on the card. Returns the launch
    counts of that run (one K9 and one K10 launch a step, no other kernel)
    and the steps' ms."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_nsde_optimizer,
    )

    model = build_nsde("sosri2", True, device)
    optimizer = mnist_nsde_optimizer()
    state = create_train_state(model, optimizer)
    step = make_train_step(nsde_loss, optimizer)
    before = [p.detach().clone() for p in model.parameters()]
    noises = [nsde_noise(i, device) for i in range(len(batches))]

    torch.cuda.synchronize()
    counters = _counters()
    for mod in counters:  # count only this path's launches
        mod.reset_launches()
    walls = []
    for i, ((x, y), noise) in enumerate(zip(batches, noises)):
        start = time.perf_counter()
        state, loss, out = step(state, x, y, noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - start) * 1e3)
        tel = out.telemetry
        naccept = int(tel.accepted.sum().item())
        nlive = int(tel.live.sum().item())
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        print(f"[nsde] fused=True step {i}: loss={loss.item()!r} nfe1={out.nfe1} "
              f"nfe2={out.nfe2} naccept={naccept} nreject={nlive - naccept} "
              f"success={out.success} ms={walls[-1]!r} launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success, f"the solve reached t1 within {NSDE_MAX_STEPS} trial steps")
        _check(out.nfe1 == 4 * nlive and out.nfe2 == 4 * nlive, "NFE = 4 + 4 a trial step")
        _check(torch.isfinite(out.logits).all().item(), "finite logits")
        want = {k: 0 for k in launches}
        want.update(sde_whole_solve_fwd=i + 1, sde_whole_solve_bwd=i + 1)
        _check(launches == want, f"NSDE launches after step {i}: {launches}, expected {want}")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(model.parameters(), before))
    print(f"[nsde] fused=True three training steps: ms a step {walls}, "
          f"max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    return launches, walls



# ---------------------------------------------------------------------------
# Per-sample adaptive stepping: the lane-wise kernels K11/K12 (phases 22-24).
# ---------------------------------------------------------------------------


def _lane_inputs(device, B=BATCH, D=DIM, H=HIDDEN, seed=SEED + 31):
    """Seeded MLPDynamics leaves at LeCun's scale, y, a random k1 (the
    embedded error far above rounding), per-lane (t, dt) spread over [0, 1]
    x [1e-3, 0.1] (the flagship's step sizes), every 16th lane finished
    (dt = 0), and the five row cotangents."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    t = torch.rand(B, generator=gen).to(device)
    dt = (1e-3 + 0.099 * torch.rand(B, generator=gen)).to(device)
    dt[::16] = 0.0
    cts = [rnd(B, D) for _ in range(5)]
    return leaves, y, k1, t, dt, cts


def phase_lanes_kernels(device):
    """K11/K12 (the lane-wise Tsit5 step) against their plain versions at
    512x784x100 with per-lane (t, dt) and finished lanes: K11
    (``csrc/mlp_step_solve.cuh`` with ``LaneEnd``) within FWD_BOUND on each
    of its five outputs (and which equal the plain version's bitwise), the
    finished lanes' y_new equal to y and err exactly zero, its device time,
    its tile plan (K12's) and its ``grid.sync()`` count a launch (the pad and
    two a stage per row chunk); K12 (``csrc/mlp_step_walk.cuh`` with
    ``LaneSeed``) within BWD_BOUND of its plain version and within 3 times
    the plain version's distance from a float64 walk, plus 1e-6, and within
    BWD_BOUND of its schedule (``whole_solve.plain_lanes_walk_step`` on its
    plan); both bitwise deterministic; CUDA-event times; K12's device time
    under ``torch.profiler`` (``mlp_step_walk_kernel`` and the
    weight-cotangent contraction after it), its tile plan and its
    ``grid.sync()`` count a launch: the pad, the replay's two a stage, the
    replay's end, the reverse's two a stage (each per row chunk) and the
    per-row sums'."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
    from regneuralde_tpu_torch.ops import weight_cotangents as wc
    from regneuralde_tpu_torch.ops import whole_solve as ws

    leaves, y, k1, t, dt, cts = _lane_inputs(device)
    parts = fm._split_params(*leaves)
    kf = fl.sweep_lanes_fwd(t, dt, y, k1, leaves)
    pf = fl._reference_sweep_lanes(t[:, None], dt[:, None], y, k1, parts)
    torch.cuda.synchronize()
    names_f = ["y_new", "k7", "err", "k6", "g6"]
    errs_f = {n: _rel(a, b) for n, a, b in zip(names_f, kf, pf)}
    bitwise = {n: torch.equal(a, b) for n, a, b in zip(names_f, kf, pf)}
    print("[lanes] K11 rel err " + json.dumps(errs_f) + " bitwise " + json.dumps(bitwise))
    _check(all(v == v and v <= FWD_BOUND for v in errs_f.values()), f"K11: {errs_f}")
    done = dt == 0
    _check(torch.equal(kf[0][done], y[done]) and not kf[2][done].any().item(),
           "K11: a finished lane keeps y and has zero error")
    _check(all(torch.isfinite(o).all().item() for o in kf), "K11: finite outputs")

    names_b = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
    flat = lambda g: [*g[:4], *g[4]]
    kb = flat(fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts))
    pb = flat(fl._lanes_bwd_math(t[:, None], dt[:, None], y, k1, parts, cts))
    d = lambda x: x.double()
    pb64 = flat(fl._lanes_bwd_math(d(t)[:, None], d(dt)[:, None], d(y), d(k1),
                                   [d(x) for x in parts], [d(c) for c in cts]))
    torch.cuda.synchronize()
    errs_b = {n: (_rel(a, b), _rel(a, c), _rel(b, c)) for n, a, b, c in zip(names_b, kb, pb, pb64)}
    print("[lanes] K12 rel err (kernel vs plain, kernel vs float64, plain vs float64) "
          + json.dumps(errs_b))
    for n, (k_p, k_64, p_64) in errs_b.items():
        _check(k_p == k_p and k_64 == k_64, f"K12 {n}: no NaN")
        _check(k_p <= BWD_BOUND, f"K12 {n}: {errs_b[n]}")
        _check(k_64 <= 3 * p_64 + 1e-6, f"K12 {n}: {errs_b[n]}")
    plan = ws.walk_plan(BATCH, DIM, HIDDEN,
                        torch.cuda.get_device_properties(device).multi_processor_count,
                        state=ws.LANE_STATE)
    sched = ws.plain_lanes_walk_step(t, dt, y, k1, leaves, cts, plan)
    sched = [*sched[:4], *wc.weight_cotangents_plain(*sched[4])]
    torch.cuda.synchronize()
    errs_s = {n: _rel(a, b) for n, a, b in zip(names_b, kb, sched)}
    print("[lanes] K12 rel err against its schedule " + json.dumps(errs_s))
    _check(all(v == v and v <= BWD_BOUND for v in errs_s.values()),
           f"K12 against its schedule: {errs_s}")
    _check(all(torch.isfinite(x).all().item() for x in kb), "K12: finite outputs")
    again_f = fl.sweep_lanes_fwd(t, dt, y, k1, leaves)
    again_b = flat(fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts))
    _check(all(torch.equal(a, b) for a, b in zip(kf, again_f)), "K11 is deterministic")
    _check(all(torch.equal(a, b) for a, b in zip(kb, again_b)), "K12 is deterministic")
    abs_f = max((a - b).abs().max().item() for a, b in zip(kf, pf))
    abs_b = max((a - b).abs().max().item() for a, b in zip(kb, pb))
    print(f"[lanes] max abs err: K11 {abs_f!r}, K12 {abs_b!r}")

    times = {
        "fwd_kernel": _time_ms(lambda: fl.sweep_lanes_fwd(t, dt, y, k1, leaves)),
        "fwd_plain": _time_ms(lambda: fl._reference_sweep_lanes(t[:, None], dt[:, None], y, k1,
                                                                parts)),
        "bwd_kernel": _time_ms(lambda: fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts)),
        "bwd_plain": _time_ms(lambda: fl._lanes_bwd_math(t[:, None], dt[:, None], y, k1, parts,
                                                         cts)),
    }
    print("[lanes] median ms over %d runs at %dx%dx%d: %s"
          % (REPS, BATCH, DIM, HIDDEN, json.dumps(times)))
    bwd = lambda: fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts)
    dev_walk = _device_ms(bwd, "mlp_step_walk_kernel")
    dev_wcot = _device_ms(bwd, "wcot_")
    _check(dev_walk is not None and dev_wcot is not None,
           "K12's kernel and its contraction in the trace")
    dev_fwd = _device_ms(lambda: fl.sweep_lanes_fwd(t, dt, y, k1, leaves), "LaneEnd")
    _check(dev_fwd is not None, "K11's kernel in the trace")
    print(f"[lanes] K11 device ms a launch (torch.profiler, {REPS} launches): {dev_fwd!r}; "
          f"tiles {plan.rows}x{plan.cols}, {plan.tiles} blocks, {plan.chunks} row chunks, "
          f"{ws.solve_smem_bytes(plan.rows, plan.cols, HIDDEN, lanes=True)} bytes of shared "
          f"memory; grid.sync() a launch {1 + 12 * plan.chunks}")
    syncs = 1 + 12 * plan.chunks + 1 + 12 * plan.chunks + 1
    print(f"[lanes] K12 device ms a launch (torch.profiler, {REPS} launches): kernel "
          f"{dev_walk!r} + contraction {dev_wcot!r} = {dev_walk + dev_wcot!r}; tiles "
          f"{plan.rows}x{plan.cols}, {plan.tiles} blocks, {plan.chunks} row chunks, "
          f"{plan.smem_bytes} bytes of shared memory; grid.sync() a launch {syncs}")
    f_ops, b_ops, leaf = _mlp_work(BATCH, DIM, HIDDEN)
    BD = BATCH * DIM
    # K11 reads t, dt, y, k1 and the leaves and writes five rows; K12 reads
    # those inputs and five row cotangents and writes two rows, two lane
    # columns and the leaves' cotangents
    return {
        "mlp_lanes_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:634",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(4 * (2 * BATCH + 7 * BD + leaf), f_ops)),
        "mlp_lanes_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:824",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(4 * (4 * BATCH + 9 * BD + 2 * leaf), b_ops)),
    }


def phase_per_sample_kernel_vs_plain_step(device, batch):
    """One forward+backward of the per-sample flagship step
    (``per_sample="batched"``) at rtol=atol=1e-5, ``fused=True`` (K11/K12)
    against ``fused=False`` (their plain versions), with a scalar t1 and with
    a per-lane STEER t1 (``reg.steer_tspan_per_sample``): identical per-lane
    NFE and accept sequences, the cross-entropy's gradient within GRAD_BOUND
    and the regularized one within REG_GRAD_BOUND."""
    import torch

    from regneuralde_tpu_torch import reg

    x, y = batch
    tol = 1e-5
    _, t1_lanes = reg.steer_tspan_per_sample(
        torch.Generator(device=device).manual_seed(SEED + 32), BATCH)
    for t1_kind, tspan in (("scalar", None), ("steer", (0.0, t1_lanes))):
        kw = {} if tspan is None else dict(tspan=tspan)
        kern, gen = build_classifier(tol, True, device, per_sample="batched")
        kern.init(x, generator=gen)
        plain, _ = build_classifier(tol, False, device, per_sample="batched")
        plain.init(x)
        plain.load_state_dict(kern.state_dict())
        results = {}
        for name, clf in (("kernel", kern), ("plain", plain)):
            for reg_weight in (0.0, 100.0):
                clf.zero_grad(set_to_none=True)
                loss, out = mnist_loss(clf, x, y, reg_weight, **kw)
                loss.backward()
                torch.cuda.synchronize()
                results[name, reg_weight] = dict(
                    loss=loss.item(), nfe=out.nfe.tolist(), success=bool(out.success.all()),
                    accepted=out.telemetry.accepted.clone(),
                    grad=torch.cat([p.grad.flatten() for p in clf.parameters()]),
                    logits=out.logits.detach())
        for reg_weight, bound in ((0.0, GRAD_BOUND), (100.0, REG_GRAD_BOUND)):
            k, p = results["kernel", reg_weight], results["plain", reg_weight]
            g_err = _rel(k["grad"], p["grad"])
            nfe = torch.tensor(k["nfe"], dtype=torch.float64)
            print(f"[ps-step] t1={t1_kind} rtol=atol={tol:g} reg_weight={reg_weight:g} "
                  f"per-lane NFE min/mean/max {nfe.min().item():g}/{nfe.mean().item():g}/"
                  f"{nfe.max().item():g}; lanes with other NFE "
                  f"{sum(a != b for a, b in zip(k['nfe'], p['nfe']))}; "
                  f"loss kernel={k['loss']!r} plain={p['loss']!r} "
                  f"logits rel err={_rel(k['logits'], p['logits']):.3e} "
                  f"grad rel err={g_err:.3e} (bound {bound:g})")
            _check(k["success"] and p["success"], "every lane reached its t1")
            _check(k["nfe"] == p["nfe"], "the same per-lane NFE")
            _check(torch.equal(k["accepted"], p["accepted"]), "the same accept sequences")
            _check(tuple(k["logits"].shape) == (BATCH, 10), "logits shape")
            _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
            _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_per_sample_slice(device, batches):
    """Three training steps of the per-sample flagship (the flagship of
    phase 4 with ``per_sample="batched"``, ``fused=True``) at rtol=atol=
    1.4e-8: each step launches K11 and K12 once an engine iteration (the
    slowest lane's trial steps) and no other kernel; per-lane NFE (mean,
    p50, max), the success fraction and the ms of each step."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    clf, gen = build_classifier(FLAGSHIP_TOL, True, device, per_sample="batched")
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(lambda m, x, y: mnist_loss(m, x, y), optimizer)
    before = [p.detach().clone() for p in clf.parameters()]

    torch.cuda.synchronize()
    counters = _counters()
    for mod in counters:  # count only this path's launches
        mod.reset_launches()
    walls, iters = [], 0
    for i, (x, y) in enumerate(batches):
        start = time.perf_counter()
        state, loss, out = step(state, x, y)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - start) * 1e3)
        tel = out.telemetry
        iters += int(tel.live.any(0).sum().item())
        nfe = out.nfe.double()
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        print(f"[ps] fused=True step {i}: loss={loss.item()!r} per-lane NFE mean "
              f"{nfe.mean().item():g} p50 {nfe.median().item():g} max {nfe.max().item():g} "
              f"min {nfe.min().item():g}; iterations {int(tel.live.any(0).sum().item())}; "
              f"rejects {int((tel.live & ~tel.accepted).sum().item())}; success fraction "
              f"{out.success.double().mean().item():g}; ms={walls[-1]!r} "
              f"launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success.all().item(), f"every lane reached t1 within {MAX_STEPS} trial steps")
        _check(torch.equal(out.nfe, 2 + 6 * tel.live.sum(1)), "NFE = 2 + 6 * trial steps a lane")
        _check(torch.isfinite(out.logits).all().item(), "finite logits")
        want = {k: 0 for k in launches}
        want.update(mlp_lanes_tsit5_fwd=iters, mlp_lanes_tsit5_bwd=iters,
                    weight_cotangents=iters)
        _check(launches == want, f"per-sample launches after step {i}: {launches}, "
               f"expected {want}")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(clf.parameters(), before))
    print(f"[ps] fused=True three training steps: ms a step {walls}, engine iterations "
          f"{iters}, max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    # at 1.4e-8 each lane's error estimate sits near its float32 floor: the
    # forward of both routes from the trained weights, lane by lane (reported)
    x0 = batches[0][0]
    plain, _ = build_classifier(FLAGSHIP_TOL, False, device, per_sample="batched")
    plain.init(x0)
    plain.load_state_dict(clf.state_dict())
    with torch.no_grad():
        a, b = clf(x0, mode="while"), plain(x0, mode="while")
    differ = int((a.nfe != b.nfe).sum().item())
    acc_differ = int((a.telemetry.accepted != b.telemetry.accepted).any(1).sum().item())
    print(f"[ps] rtol=atol=1.4e-8, forward from the trained weights: lanes whose NFE differs "
          f"between fused=True and False {differ} of {BATCH}, whose accept sequence differs "
          f"{acc_differ}")
    return launches, walls


# ---------------------------------------------------------------------------
# The generic solve engine with the tuple trial step, K13/K14 (phases 25-27).
# ---------------------------------------------------------------------------


def tuple_loss(clf, x, y, mode="adjoint", sweep=None, reg_weight=100.0):
    """``mnist_loss`` with the node's solve through ``odeint``'s generic
    engine on the tuple trial step: ``odeint(clf.node._func, x, 0, 1,
    leaves, stage_sweep=mlp_dynamics_stage_sweep)`` (K13/K14), or ``sweep``
    (its plain version), under the replay adjoint (``"adjoint"``) or the
    checkpointed scan (``"scan"``)."""
    import torch

    from regneuralde_tpu_torch import reg
    from regneuralde_tpu_torch.models.classifiers import ClassifierNODEOutput
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode

    node = clf.node
    sol = ode.odeint(node._func, x.contiguous(), 0.0, 1.0, tuple(node.dynamics.parameters()),
                     rtol=node.rtol, atol=node.atol, max_steps=node.max_steps, mode=mode,
                     stage_sweep=sweep or fm.mlp_dynamics_stage_sweep)
    out = ClassifierNODEOutput(logits=clf.post(sol.y1), nfe=sol.stats.nfe,
                               telemetry=sol.telemetry, success=sol.stats.success)
    ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
    return ce + reg_weight * reg.error_estimate(out.telemetry, "mean"), out


def phase_tuple_kernels(device):
    """K13/K14 (the tuple Tsit5 step) against their plain versions at
    512x784x100 on seeded LeCun-scale weights and inputs, t = 0.3, dt in
    {0.05, 0.3}: K13's rows within FWD_BOUND of its plain version (the
    error row within TUPLE_ERR_BOUND) and within 3 times the plain version's
    distance from a float64 walk, plus 1e-7; K14 within BWD_BOUND of its
    plain version and within 3 times the plain version's distance from a
    float64 walk, plus 1e-6; both bitwise deterministic; CUDA-event times of
    both and of their plain versions; their device time under
    ``torch.profiler`` (K13's ``mlp_step_solve_kernel``; K14's
    ``mlp_step_walk_kernel`` and the weight-cotangent contraction after it),
    their tile plan (one, ``walk_plan``'s) and their ``grid.sync()`` count a
    launch: K13's the pad and two a stage per row chunk; K14's the pad, the
    replay's two a stage, the replay's end, the reverse's two a stage (each
    per row chunk) and the slots'."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws

    gen = torch.Generator().manual_seed(SEED + 41)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = [rnd(HIDDEN, DIM + 1, scale=(DIM + 1) ** -0.5), rnd(HIDDEN, scale=0.1),
              rnd(DIM, HIDDEN + 1, scale=(HIDDEN + 1) ** -0.5), rnd(DIM, scale=0.1)]
    y, k1 = rnd(BATCH, DIM, scale=0.5), rnd(BATCH, DIM, scale=0.3)
    cts = [rnd(BATCH, DIM) for _ in range(5)]
    parts = fm._split_params(*leaves)
    d = lambda x: x.double()
    parts64 = [d(x) for x in parts]
    flat = lambda g: [*g[:4], *g[4]]
    names_f = ["y_new", "k7", "err", "k6", "g6"]
    names_b = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
    t = torch.tensor(0.3, device=device)
    abs_f = abs_b = 0.0
    for dt_val in (0.05, 0.3):
        dt = torch.tensor(dt_val, device=device)
        kf = fm.stage_sweep_fwd(t, dt, y, k1, leaves)
        pf = fm._reference_sweep(t, dt, y, k1, parts)
        pf64 = fm._reference_sweep(d(t), d(dt), d(y), d(k1), parts64)
        kb = flat(fm.stage_sweep_bwd(t, dt, y, k1, leaves, cts))
        pb = flat(fm._bwd_math(t, dt, y, k1, parts, cts))
        pb64 = flat(fm._bwd_math(d(t), d(dt), d(y), d(k1), parts64, [d(c) for c in cts]))
        torch.cuda.synchronize()
        errs_f = {n: (_rel(a, b), _rel(a, c), _rel(b, c))
                  for n, a, b, c in zip(names_f, kf, pf, pf64)}
        errs_b = {n: (_rel(a, b), _rel(a, c), _rel(b, c))
                  for n, a, b, c in zip(names_b, kb, pb, pb64)}
        print(f"[tuple] dt={dt_val:g} K13 rel err (kernel vs plain, kernel vs float64, "
              "plain vs float64) " + json.dumps(errs_f))
        print(f"[tuple] dt={dt_val:g} K14 rel err (kernel vs plain, kernel vs float64, "
              "plain vs float64) " + json.dumps(errs_b))
        for n, (k_p, k_64, p_64) in errs_f.items():
            _check(k_p == k_p and k_64 == k_64, f"K13 {n}: no NaN")
            _check(k_64 <= 3 * p_64 + 1e-7, f"K13 {n} at dt {dt_val}: {errs_f[n]}")
            _check(k_p <= (TUPLE_ERR_BOUND if n == "err" else FWD_BOUND),
                   f"K13 {n} at dt {dt_val}: {errs_f[n]}")
        _check(all(torch.isfinite(o).all().item() for o in kf), "K13: finite outputs")
        for n, (k_p, k_64, p_64) in errs_b.items():
            _check(k_p == k_p and k_64 == k_64, f"K14 {n}: no NaN")
            _check(k_p <= BWD_BOUND, f"K14 {n} at dt {dt_val}: {errs_b[n]}")
            _check(k_64 <= 3 * p_64 + 1e-6, f"K14 {n} at dt {dt_val}: {errs_b[n]}")
        again_f = fm.stage_sweep_fwd(t, dt, y, k1, leaves)
        again_b = flat(fm.stage_sweep_bwd(t, dt, y, k1, leaves, cts))
        _check(all(torch.equal(a, b) for a, b in zip(kf, again_f)), "K13 is deterministic")
        _check(all(torch.equal(a, b) for a, b in zip(kb, again_b)), "K14 is deterministic")
        abs_f = max(abs_f, max((a - b).abs().max().item() for a, b in zip(kf, pf)))
        abs_b = max(abs_b, max((a - b).abs().max().item() for a, b in zip(kb, pb)))
    print(f"[tuple] max abs err: K13 {abs_f!r}, K14 {abs_b!r}")

    dt = torch.tensor(0.05, device=device)
    times = {
        "fwd_kernel": _time_ms(lambda: fm.stage_sweep_fwd(t, dt, y, k1, leaves)),
        "fwd_plain": _time_ms(lambda: fm._reference_sweep(t, dt, y, k1, parts)),
        "bwd_kernel": _time_ms(lambda: fm.stage_sweep_bwd(t, dt, y, k1, leaves, cts)),
        "bwd_plain": _time_ms(lambda: fm._bwd_math(t, dt, y, k1, parts, cts)),
    }
    print("[tuple] median ms over %d runs at %dx%dx%d: %s"
          % (REPS, BATCH, DIM, HIDDEN, json.dumps(times)))
    dev_fwd = _device_ms(lambda: fm.stage_sweep_fwd(t, dt, y, k1, leaves),
                         "mlp_step_solve_kernel")
    bwd = lambda: fm.stage_sweep_bwd(t, dt, y, k1, leaves, cts)
    dev_walk = _device_ms(bwd, "mlp_step_walk_kernel")
    dev_wcot = _device_ms(bwd, "wcot_")
    _check(dev_fwd is not None, "K13's kernel in the trace")
    _check(dev_walk is not None and dev_wcot is not None,
           "K14's kernel and its contraction in the trace")
    plan = ws.walk_plan(BATCH, DIM, HIDDEN,
                        torch.cuda.get_device_properties(device).multi_processor_count)
    print(f"[tuple] K13 device ms a launch (torch.profiler, {REPS} launches): {dev_fwd!r}; "
          f"tiles {plan.rows}x{plan.cols}, {plan.tiles} blocks, {plan.chunks} row chunks, "
          f"{ws.solve_smem_bytes(plan.rows, plan.cols, HIDDEN)} bytes of shared memory; "
          f"grid.sync() a launch {1 + 12 * plan.chunks}")
    syncs = 1 + 12 * plan.chunks + 1 + 12 * plan.chunks + 1
    print(f"[tuple] K14 device ms a launch (torch.profiler, {REPS} launches): kernel "
          f"{dev_walk!r} + contraction {dev_wcot!r} = {dev_walk + dev_wcot!r}; tiles "
          f"{plan.rows}x{plan.cols}, {plan.tiles} blocks, {plan.chunks} row chunks; "
          f"grid.sync() a launch {syncs}")
    f_ops, b_ops, leaf = _mlp_work(BATCH, DIM, HIDDEN)
    BD = BATCH * DIM
    # K13 reads t, dt, y, k1 and the leaves and writes five rows; K14 reads
    # those inputs and five row cotangents and writes two rows, ct_t, ct_dt
    # and the leaves' cotangents
    return {
        "mlp_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:235",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"],
            **_bound(4 * (2 + 7 * BD + leaf), f_ops)),
        "mlp_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:417",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"],
            **_bound(4 * (4 + 9 * BD + 2 * leaf), b_ops)),
    }


def phase_tuple_step(device, batch):
    """One forward+backward of the flagship training step at rtol=atol=1e-5
    with the solve through ``odeint``'s generic engine (``tuple_loss``), in
    ``mode="adjoint"`` (the replay adjoint) and ``"scan"``, on K13/K14
    against their plain version (``plain_mlp_stage_sweep``): the same NFE
    and accept sequence, the cross-entropy's gradient within GRAD_BOUND and
    the regularized one within REG_GRAD_BOUND, and the scan's forward
    bitwise the adjoint's. Reports the NFE of ``fused="step"`` from the same
    weights. Then one forward+backward of ``NeuralODE(solver="dopri5")`` and
    ``"bosh3"`` (``fused=False``: the generic sweep over the module under the
    replay adjoint): success and finite gradients, and their NFE."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm

    x, y = batch
    tol = 1e-5
    clf, gen = build_classifier(tol, False, device)
    clf.init(x, generator=gen)
    results = {}
    for mode in ("adjoint", "scan"):
        for name, sweep in (("kernel", None), ("plain", fm.plain_mlp_stage_sweep)):
            for reg_weight in (0.0, 100.0):
                clf.zero_grad(set_to_none=True)
                loss, out = tuple_loss(clf, x, y, mode, sweep, reg_weight)
                loss.backward()
                torch.cuda.synchronize()
                tel = out.telemetry
                results[mode, name, reg_weight] = dict(
                    loss=loss.item(), nfe=out.nfe, success=out.success,
                    accepted=tel.accepted[tel.live].tolist(), eest=tel.eest.detach(),
                    grad=torch.cat([p.grad.flatten() for p in clf.parameters()]),
                    logits=out.logits.detach())
    for mode in ("adjoint", "scan"):
        for reg_weight, bound in ((0.0, GRAD_BOUND), (100.0, REG_GRAD_BOUND)):
            k, p = results[mode, "kernel", reg_weight], results[mode, "plain", reg_weight]
            g_err = _rel(k["grad"], p["grad"])
            print(f"[tuple-step] mode={mode} rtol=atol={tol:g} reg_weight={reg_weight:g} "
                  f"nfe kernel={k['nfe']} plain={p['nfe']} "
                  f"loss kernel={k['loss']!r} plain={p['loss']!r} "
                  f"logits rel err={_rel(k['logits'], p['logits']):.3e} "
                  f"grad rel err={g_err:.3e} (bound {bound:g})")
            _check(k["success"] and p["success"], "both solves reached t1")
            _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
            _check(k["accepted"] == p["accepted"], "same accept sequence")
            _check(tuple(k["logits"].shape) == (BATCH, 10), "logits shape")
            _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
            _check(g_err <= bound, f"{mode}: gradient rel err {g_err} > {bound}")
    for name in ("kernel", "plain"):
        a, s = results["adjoint", name, 100.0], results["scan", name, 100.0]
        _check(torch.equal(a["logits"], s["logits"]) and torch.equal(a["eest"], s["eest"])
               and a["nfe"] == s["nfe"], f"{name}: the scan's forward is the adjoint's")
    print("[tuple-step] the scan's forward is bitwise the adjoint's (logits, eest), "
          "on K13 and on its plain version")

    step_clf, _ = build_classifier(tol, "step", device)
    step_clf.init(x)
    step_clf.load_state_dict(clf.state_dict())
    with torch.no_grad():
        step_nfe = step_clf(x, mode="while").nfe
    print(f"[tuple-step] fused='step' (K1, the normed step) from the same weights: NFE "
          f"{step_nfe}, against {results['adjoint', 'kernel', 0.0]['nfe']} on K13")

    for solver in ("dopri5", "bosh3"):
        other, _ = build_classifier(tol, False, device, max_steps=256)
        other.init(x)
        other.load_state_dict(clf.state_dict())
        other.node.solver = solver
        start = time.perf_counter()
        loss, out = mnist_loss(other, x, y)
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        grad = torch.cat([p.grad.flatten() for p in other.parameters()])
        print(f"[tuple-step] NeuralODE(solver={solver!r}) rtol=atol={tol:g}: nfe={out.nfe} "
              f"trial steps={int(out.telemetry.live.sum().item())} loss={loss.item()!r} "
              f"ms={wall * 1e3!r}")
        _check(out.success, f"{solver}: the solve reached t1")
        _check(torch.isfinite(loss).item() and torch.isfinite(grad).all().item(),
               f"{solver}: finite loss and gradients")


def phase_tuple_slice(device, batches):
    """Three training steps of the flagship configuration (Tsit5 at
    rtol=atol=1.4e-8, max_steps 96, batch 512, CE + 100 * error_estimate,
    InvDecay(1e-5) then Momentum(0.1, 0.9)) with the solve through K13
    under the replay adjoint (``tuple_loss``): K13 launched twice a trial
    step (forward and replay), K14 once, and no other step or whole-solve
    kernel; NFE and ms a step. Then one step on ``mode="scan"``: K13 twice
    a trial step (the checkpoint's recompute), K14 once."""
    import torch

    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    clf, gen = build_classifier(FLAGSHIP_TOL, False, device)
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    before = [p.detach().clone() for p in clf.parameters()]
    counters = _counters()
    walls = {}
    for mode, n in (("adjoint", len(batches)), ("scan", 1)):
        step = make_train_step(lambda m, x, y, mode=mode: tuple_loss(m, x, y, mode), optimizer)
        torch.cuda.synchronize()
        for mod in counters:  # count only this path's launches
            mod.reset_launches()
        trial_steps, walls[mode] = 0, []
        for i, (x, y) in enumerate(batches[:n]):
            start = time.perf_counter()
            state, loss, out = step(state, x, y)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - start) * 1e3)
            tel = out.telemetry
            nlive = int(tel.live.sum().item())
            naccept = int(tel.accepted.sum().item())
            trial_steps += nlive
            launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
            print(f"[tuple-slice] mode={mode} step {i}: loss={loss.item()!r} nfe={out.nfe} "
                  f"naccept={naccept} nreject={nlive - naccept} success={out.success} "
                  f"ms={walls[mode][-1]!r} launches={json.dumps(launches)}")
            _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
            _check(out.success, "the solve reached t1")
            _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
            _check(torch.isfinite(out.logits).all().item(), "finite logits")
            want = {k: 0 for k in launches}
            want.update(mlp_tsit5_fwd=2 * trial_steps, mlp_tsit5_bwd=trial_steps,
                        weight_cotangents=trial_steps)
            _check(launches == want, f"{mode} launches after step {i}: {launches}, "
                   f"expected {want}")
        if mode == "adjoint":
            main_launches = launches
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(clf.parameters(), before))
    print(f"[tuple-slice] ms a step: adjoint {walls['adjoint']}, scan {walls['scan']}; "
          f"max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    return main_launches, walls


# ---------------------------------------------------------------------------
# K15, the whole-solve feature probe (phase 28), and the toy 2-D SDE fit:
# K9/K10 with the cubic tile body (phase 29) and its training step (phase 30).
# ---------------------------------------------------------------------------

SPIKE_TOL = 1e-6  # K15's y1 and tel against its plain version (absolute)
SPIKE_CASES = (0.0, 0.1, 0.9, -5.0)  # t0: 4, 4, 1 iterations, and the 16-row cap
TOY_TIGHT_TOL = 3e-2  # phase 29: tens of trial steps, with rejections


def _device_ms(fn, kernel, reps=REPS):
    """The device time of the kernels whose name holds ``kernel`` (each
    launched once a call), ms a call of ``fn`` over ``reps`` calls under
    ``torch.profiler`` (CUDA events around a call also hold the wrapper's
    host work, which the kernel waits for): each kernel's time over the
    launches of it the trace holds, which late in this script's process may
    be fewer than were made (said when so); None when the trace holds no
    such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key and e.count]
    for e in hits:
        if e.count != reps:
            print(f"[profile] the trace holds {e.count} of {reps} launches of {e.key[:80]}")
    us = sum(e.self_device_time_total / e.count for e in hits)
    return us / 1e3 if us > 0 else None


def _load_tool(name):
    """A script of ``tools/`` as a module (``tools`` is no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_spike_main(device):
    """K15's main path: ``tools/torch_spike_wholesolve.py`` as a user runs
    it (one launch, checked there against the plain version), with every
    count set to 0 just before and read just after."""
    import torch

    tool = _load_tool("torch_spike_wholesolve")
    counters = _counters()
    torch.cuda.synchronize()
    for mod in counters:
        mod.reset_launches()
    rc = tool.main()
    torch.cuda.synchronize()
    launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
    print(f"[spike] tools/torch_spike_wholesolve.py exit {rc}; launches {json.dumps(launches)}")
    _check(rc == 0, "tools/torch_spike_wholesolve.py passed")
    want = {k: 0 for k in launches}
    want.update(spike_wholesolve=1)
    _check(launches == want, f"K15 main path launches {launches}, expected {want}")
    return launches


def phase_spike_kernels(device):
    """K15 against its plain version at JAX's size (32 x 20, 16 rows) and
    at 512 x 784, for t0 in SPIKE_CASES on a seeded state: the same
    iteration count, y1 and tel within SPIKE_TOL, the history rows < n
    bitwise (copies), run-to-run bitwise; CUDA-event times of both at both
    sizes (t0 = 0), and the kernel's device time from the profiler. The
    record's numbers are those at JAX's size, the main path's."""
    import torch

    from regneuralde_tpu_torch.ops import spike_wholesolve as sp

    gen = torch.Generator().manual_seed(SEED + 41)
    out, times = {}, {}
    for shape in ((sp.B, sp.D), (BATCH, DIM)):
        y0 = torch.randn(shape, generator=gen).to(device)
        for t0 in SPIKE_CASES:
            y1, tel, hy, n = sp.spike_wholesolve(t0, y0)
            py1, ptel, phy, pn = sp.plain_spike_wholesolve(t0, y0)
            again = sp.spike_wholesolve(t0, y0)
            torch.cuda.synchronize()
            err_y = (y1 - py1).abs().max().item()
            err_t = (tel - ptel).abs().max().item()
            tag = f"spike {shape[0]}x{shape[1]} t0={t0:g}"
            print(f"[{tag}] n kernel={n} plain={pn}; max abs err y1 {err_y!r} tel {err_t!r}")
            _check(n == pn, f"{tag}: the same iteration count")
            _check(n == (16 if t0 < -1 else 1 if t0 > 0.75 else 4), f"{tag}: n = {n}")
            _check(err_y <= SPIKE_TOL and err_t <= SPIKE_TOL, f"{tag}: y1, tel")
            _check(torch.equal(hy[:n], phy[:n]), f"{tag}: the history rows are copies")
            same = [torch.equal(a, b) for a, b in zip((again[0], again[1], again[2][:n]),
                                                      (y1, tel, hy[:n]))]
            _check(again[3] == n and all(same), f"{tag}: K15 is deterministic")
            if t0 == 0.0:
                launch = lambda: sp._cuda_spike_wholesolve(0.0, y0, sp.MAXS)
                times[shape] = {
                    "kernel": _time_ms(launch),
                    "kernel_device": _device_ms(launch, "spike_wholesolve_kernel"),
                    "plain": _time_ms(lambda: sp.plain_spike_wholesolve(0.0, y0)),
                    "n": n, "max_abs_err": max(err_y, err_t)}
        print(f"[spike {shape[0]}x{shape[1]}] median ms over {REPS} runs at t0 = 0: "
              + json.dumps(times[shape]))
    jax_size = times[(sp.B, sp.D)]
    BD, n = sp.B * sp.D, jax_size["n"]
    # bytes: y0 read, y1 and n history rows written, tel and the count;
    # operations: 11 a state element an iteration (2 tanh, 9 products and
    # sums) and the scalar 0.1 t
    out["spike_wholesolve"] = dict(
        replaces="tools/spike_wholesolve.py:46", max_abs_err=jax_size["max_abs_err"],
        ms=jax_size["kernel"], plain_ms=jax_size["plain"],
        **_bound(4 * ((2 + n) * BD + sp.MAXS + 1), n * (11 * BD + 1)))
    return out


def _sde_cubic_work(B, D, H, tab_name, ns):
    """``_sde_work`` for the cubic pair: the MLP pair's operations plus the
    cube (two products an element) of each drift evaluation; K10 three times
    the forward."""
    from regneuralde_tpu_torch.ops.sri import analyze, get_tableau

    fwd, _, leaf = _sde_work(B, D, H, tab_name, ns)
    fwd += ns * analyze(get_tableau(tab_name)).n_drift_evals * 2 * B * D
    return fwd, 3 * fwd, leaf


def _toy_inputs(device, S, gen, diffusion_scale=1.0):
    """Cubic-pair leaves (drift 2 -> 50 -> 2 after the cube, diffusion 2 ->
    2, LeCun's scale times diffusion_scale), 100 states near the toy's u0 =
    [2, 0] and S rows of draws, from ``gen``."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    B, D, H = 100, 2, 50
    leaves = [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
              rnd(D, scale=0.1), rnd(D, D, scale=diffusion_scale * D ** -0.5),
              rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.5) + torch.tensor([[1.5, 0.0]], device=device)
    xi = tuple(rnd(S, B, D) for _ in range(2))
    return leaves, y0, xi


def phase_sde_cubic_kernels(device):
    """K9/K10 with the cubic tile body against their plain versions at the
    toy's width (100 x 2, drift 2 -> 50 -> 2 after the cube, diffusion 2 ->
    2, SOSRI, 30 saves) on seeded weights, states and draws, at
    rtol=atol=3e-1 (the toy's) and TOY_TIGHT_TOL (with rejections): the
    same accept sequence, NFE and save cursors; y1 and ys within
    NSDE_FWD_BOUND; every stored trial step teacher-forced: the plain trial
    step from K9's stored start row takes K9's accept decision, its sums
    within NSDE_FWD_BOUND and its rows within NSDE_FWD_BOUND of K9's next
    row; K10 seeded with the cotangents of y1 and ys (BWD_BOUND) and with
    the telemetry's too (TEL_BWD_BOUND), and within 3 times the float32
    plain version's distance from a float64 walk, plus 1e-5, and its
    distance from its schedule (``sw.plain_sde_bwd_tiles``) printed; both
    bitwise deterministic;
    CUDA-event times at both tolerances and the kernels'
    blocks, shared memory, registers, stack and device time (K10's slot sum
    apart), as phase 19's."""
    import numpy as np
    import torch

    from regneuralde_tpu_torch.ops import sde as sde_ops
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw
    from regneuralde_tpu_torch.ops.controller import PIController
    from regneuralde_tpu_torch.ops.sri import analyze, get_tableau
    from regneuralde_tpu_torch.training import sde_toy as st

    S = st.MAX_STEPS
    # twice LeCun's diffusion, so the tight solve rejects (6 of its 55
    # trial steps)
    leaves, y0, xi = _toy_inputs(device, S, torch.Generator().manual_seed(SEED + 47), 2.0)
    B, D, H = 100, 2, 50
    tab, ctrl = get_tableau("sosri"), PIController(beta1=0.5, beta2=0.0)
    per_trial = analyze(tab).n_drift_evals
    t0, t1 = torch.tensor(0.0, device=device), torch.tensor(1.0, device=device)
    dt0 = torch.tensor(0.01, device=device)
    sa = torch.tensor(np.linspace(0.0, 1.0, 30).astype(np.float32), device=device)
    sat, ys_init = sde_ops.save_rows_at_start(sa, t0, y0)
    kw = dict(n_drift=2, solver="sosri", saveat=sat, ys_init=ys_init, body="cubic")
    out, times = {}, {}
    for tol in (st.TOL, TOY_TIGHT_TOL):
        tag = f"sde-cubic tol={tol:g}"
        args = (t0, t1, dt0, y0, leaves, tol, tol, ctrl, S, *xi)
        rk = sw.sde_whole_solve_fwd(*args, **kw)
        rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
        torch.cuda.synchronize()
        ck, cp = rk.final[3:].tolist(), rp.final[3:].tolist()
        ns = int(ck[0] + ck[1])
        errs = {"y1": _rel(rk.y1, rp.y1), "ys": _rel(rk.ys, rp.ys)}
        print(f"[{tag}] (naccept, nreject, done) kernel={ck} plain={cp}; NFE kernel="
              f"{per_trial * ns} plain={per_trial * int(cp[0] + cp[1])}; cursors kernel="
              f"{rk.cursors.tolist()} plain={rp.cursors.tolist()}; rel err {json.dumps(errs)}")
        _check(ck == cp and ck[2] == 1.0, f"{tag}: K9 takes the plain version's steps to t1")
        _check(torch.equal(rk.streams[sw.ST_ACC], rp.streams[sw.ST_ACC]),
               f"{tag}: the same accept sequence")
        _check(torch.equal(rk.cursors, rp.cursors), f"{tag}: the same save cursors")
        _check(all(v <= NSDE_FWD_BOUND for v in errs.values()), f"{tag}: K9 y1, ys {errs}")
        if tol == TOY_TIGHT_TOL:
            _check(ck[1] > 0, f"{tag}: the tight solve has rejections")
        # every stored trial step, teacher-forced from K9's own start row
        st_ = rk.streams
        worst = {"sums": 0.0, "rows": 0.0}
        for i in range(ns):
            t_i, dt_i, q_i, h_i = st_[sw.ST_T, i], st_[sw.ST_DT, i], st_[sw.ST_QOLD, i], st_[
                sw.ST_H, i]
            o = sw.plain_sde_trial_step(tab, ctrl, tol, tol, t_i, dt_i, q_i, h_i, rk.hy[i],
                                        rk.hw[i], rk.hz[i], xi[0][i], xi[1][i], t1, t1 - t0,
                                        leaves, 2, body="cubic")
            _check(bool(o.accept) == bool(st_[sw.ST_ACC, i] > 0.5),
                   f"{tag}: step {i} takes K9's decision")
            worst["sums"] = max(worst["sums"], max(
                abs(a.item() - b.item()) / max(abs(b.item()), 1e-30)
                for a, b in zip(st_[sw.ST_E:sw.ST_D + 1, i], o.sums)))
            worst["rows"] = max(worst["rows"], _rel(rk.hy[i + 1], o.y),
                                _rel(rk.hw[i + 1], o.tail.w), _rel(rk.hz[i + 1], o.tail.z))
        print(f"[{tag}] teacher-forced, worst rel err over {ns} trial steps: "
              + json.dumps(worst))
        _check(all(v <= NSDE_FWD_BOUND for v in worst.values()),
               f"{tag}: the stored trial steps {worst}")
        abs_f = max((a - b).abs().max().item() for a, b in ((rk.y1, rp.y1), (rk.ys, rp.ys)))

        gen = torch.Generator().manual_seed(SEED + 48)
        ct_y1 = torch.randn(B, D, generator=gen).to(device)
        ct_tel = (0.1 * torch.randn(4, S, generator=gen)).to(device)
        ct_ys = torch.randn(len(sa), B, D, generator=gen).to(device)
        d = lambda x: x.double()
        rec64 = sw.SDERecord(*map(d, rk))
        bkw = dict(n_drift=2, solver="sosri", saveat=sat, body="cubic")
        bkw64 = dict(bkw, saveat=d(sat))
        names = ["ct_t0|ct_t1|ct_dt0", "ct_y0", "ct_ys_init"] + [f"c_leaf{j}" for j in range(6)]
        groups = lambda g: [torch.stack(g[:3]), g[3], g[4]] + list(g[5:])
        for seeds, bound in (("rows", BWD_BOUND), ("rows+telemetry", TEL_BWD_BOUND)):
            tel = ct_tel if seeds.endswith("telemetry") else torch.zeros_like(ct_tel)
            bargs = (ns, ct_y1, tel, t0, t1, leaves, tol, tol, ctrl, *xi)
            gk = sw.sde_whole_solve_bwd(rk, *bargs, ct_ys=ct_ys, **bkw)
            gp = sw.plain_sde_whole_solve_bwd(rk, *bargs, ct_ys=ct_ys, **bkw)
            g64 = sw.plain_sde_whole_solve_bwd(
                rec64, ns, d(ct_y1), d(tel), d(t0), d(t1), [d(x) for x in leaves], tol, tol,
                ctrl, d(xi[0]), d(xi[1]), ct_ys=d(ct_ys), **bkw64)
            torch.cuda.synchronize()
            e = {n: (_rel(a, b), _rel(a, c), _rel(b, c))
                 for n, a, b, c in zip(names, groups(gk), groups(gp), groups(g64))}
            print(f"[{tag}] K10 cotangents of {seeds}: rel err (kernel vs plain, kernel vs "
                  "float64, plain vs float64) " + json.dumps(e))
            for n, (k_p, k_64, p_64) in e.items():
                _check(k_p == k_p and k_64 == k_64, f"{tag} K10 {n}: no NaN")
                _check(k_p <= bound, f"{tag} K10 {n} of {seeds}: {e[n]}")
                _check(k_64 <= 3 * p_64 + 1e-5, f"{tag} K10 {n} of {seeds}: {e[n]}")
            if seeds == "rows":
                abs_b = max((a - b).abs().max().item() for a, b in zip(gk[3:], gp[3:]))
            else:
                bwd_args = bargs
        again = sw.sde_whole_solve_bwd(rk, *bwd_args, ct_ys=ct_ys, **bkw)
        rk2 = sw.sde_whole_solve_fwd(*args, **kw)
        _check(all(torch.equal(a, b) for a, b in zip(gk, again)), f"{tag}: K10 is deterministic")
        _check(all(torch.equal(getattr(rk, n), getattr(rk2, n))
                   for n in ("y1", "streams", "final", "ys", "cursors"))
               and all(torch.equal(getattr(rk, n)[:ns + 1], getattr(rk2, n)[:ns + 1])
                       for n in ("hy", "hw", "hz")), f"{tag}: K9 is deterministic")
        _report_bwd_schedule(tag, gk, rk, bwd_args, ct_ys, bkw)
        print(f"[{tag}] max abs err: K9 (y1, ys) {abs_f!r}, K10 (row cotangents) {abs_b!r}")
        times[tol] = {
            "fwd_kernel": _time_ms(lambda: sw.sde_whole_solve_fwd(*args, **kw)),
            "fwd_plain": _time_ms(lambda: sw.plain_sde_whole_solve_fwd(*args, **kw)),
            "bwd_kernel": _time_ms(lambda: sw.sde_whole_solve_bwd(rk, *bwd_args, ct_ys=ct_ys,
                                                                  **bkw)),
            "bwd_plain": _time_ms(lambda: sw.plain_sde_whole_solve_bwd(rk, *bwd_args,
                                                                       ct_ys=ct_ys, **bkw)),
        }
        print("[%s] median ms over %d runs at %dx%dx%d, %d trial steps, %d saves: %s"
              % (tag, REPS, B, D, H, ns, len(sa), json.dumps(times[tol])))
        _sde_kernel_report(tag, B, sw._pair_widths(leaves, 2, D), "cubic",
                           lambda: sw.sde_whole_solve_fwd(*args, **kw),
                           lambda: sw.sde_whole_solve_bwd(rk, *bwd_args, ct_ys=ct_ys, **bkw))
        if tol == st.TOL:
            f_ops, b_ops, leaf = _sde_cubic_work(B, D, H, "sosri", ns)
            nbytes = _sde_bytes(B * D, leaf, ns, len(sa), S)
            out = {
                "sde_whole_solve_cubic_fwd": dict(
                    replaces="regneuralde_tpu/ops/pallas_sde.py:227",
                    max_abs_err=abs_f, ms=times[tol]["fwd_kernel"],
                    plain_ms=times[tol]["fwd_plain"], **_bound(nbytes[0], f_ops)),
                "sde_whole_solve_cubic_bwd": dict(
                    replaces="regneuralde_tpu/ops/pallas_sde.py:370",
                    max_abs_err=abs_b, ms=times[tol]["bwd_kernel"],
                    plain_ms=times[tol]["bwd_plain"], **_bound(nbytes[1], b_ops)),
            }
    return out


def toy_noise(i, device):
    """The draws of toy training step ``i``: one pair of (256, 100, 2)
    buffers from a generator on the card, shared by both routes."""
    import torch

    from regneuralde_tpu_torch.ops.sde import presample_noise
    from regneuralde_tpu_torch.training import sde_toy as st

    gen = torch.Generator(device=device).manual_seed(SEED + 51 + i)
    return presample_noise(gen, (st.TRAJECTORIES, 2), st.MAX_STEPS, device=device)


def phase_sde_toy_slice(device, steps=3):
    """Three training steps of the toy 2-D SDE fit at its published
    configuration (``training.sde_toy``: 100 trajectories from [2, 0], 30
    saves, SOSRI at rtol=atol=3e-1, max_steps 256, the moments' loss + 0.2 *
    error_estimate(sum), AdaBelief(0.01)) on ``fused=False`` (``sdeint``,
    the experiment's route) and on ``fused=True`` (K9/K10 with the cubic
    body), from the same weights (``torch.Generator(SEED)``) on the same
    draws. Each route's run is its main path, its counts set to 0 just
    before: on ``True`` one cubic K9 and one cubic K10 launch a step and no
    other kernel, on ``False`` none. Step by step: the same NFE and
    accepts, the loss within 1e-5 and the gradient within GRAD_BOUND
    (relative), ``success``. Returns the launch counts of the ``True`` run
    and the ms a step of both."""
    import torch

    from regneuralde_tpu_torch.data import make_sde_demo
    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        sde_toy_optimizer,
    )
    from regneuralde_tpu_torch.training import sde_toy as st

    means, vars_, tsteps, source = make_sde_demo(seed=0)
    print(f"[sde-toy] ground truth: {source}")
    means, vars_ = torch.from_numpy(means).to(device), torch.from_numpy(vars_).to(device)
    u0 = st.sde_toy_u0(device=device)
    noises = [toy_noise(i, device) for i in range(steps)]
    counters = _counters()
    runs, walls, main_launches = {}, {}, None
    for fused in (False, True):
        model = st.build_sde_toy(tsteps, fused, device=device,
                                 generator=torch.Generator().manual_seed(SEED))
        optimizer = sde_toy_optimizer()
        state = create_train_state(model, optimizer)
        step = make_train_step(st.sde_toy_loss, optimizer)
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        for mod in counters:  # count only this path's launches
            mod.reset_launches()
        runs[fused], walls[fused] = [], []
        for i, noise in enumerate(noises):
            start = time.perf_counter()
            state, loss, out = step(state, u0, means, vars_, noise)
            torch.cuda.synchronize()
            walls[fused].append((time.perf_counter() - start) * 1e3)
            tel = out.telemetry
            nlive = int(tel.live.sum().item())
            launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
            runs[fused].append(dict(
                loss=loss.item(), nfe=(out.nfe1, out.nfe2), success=out.solution.stats.success,
                accepted=tel.accepted[tel.live].tolist(),
                grad=torch.cat([p.grad.flatten() for p in model.parameters()])))
            print(f"[sde-toy] fused={fused} step {i}: loss={loss.item()!r} nfe1={out.nfe1} "
                  f"nfe2={out.nfe2} naccept={sum(runs[fused][-1]['accepted'])} "
                  f"nreject={nlive - sum(runs[fused][-1]['accepted'])} "
                  f"success={out.solution.stats.success} ms={walls[fused][-1]!r} "
                  f"launches={json.dumps(launches)}")
            _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
            _check(out.solution.stats.success, f"the solve reached t1 within {st.MAX_STEPS}")
            _check(tuple(out.value.shape) == (st.TRAJECTORIES, len(tsteps), 2)
                   and torch.isfinite(out.value).all().item(), "finite (100, 30, 2) saves")
            want = {k: 0 for k in launches}
            if fused:
                want.update(sde_whole_solve_cubic_fwd=i + 1, sde_whole_solve_cubic_bwd=i + 1)
            _check(launches == want, f"toy fused={fused} launches after step {i}: {launches}, "
                   f"expected {want}")
        if fused:
            main_launches = launches
        moved = max((p.detach() - b).abs().max().item()
                    for p, b in zip(model.parameters(), before))
        _check(moved > 0.0, f"fused={fused}: the parameters moved")
    for i, (k, p) in enumerate(zip(runs[True], runs[False])):
        g_err = _rel(k["grad"], p["grad"])
        l_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        print(f"[sde-toy] step {i}: nfe kernel={k['nfe']} plain={p['nfe']} loss rel err="
              f"{l_err:.3e} grad rel err={g_err:.3e} (bound {GRAD_BOUND:g})")
        _check(k["nfe"] == p["nfe"], f"step {i}: NFE kernel {k['nfe']} plain {p['nfe']}")
        _check(k["accepted"] == p["accepted"], f"step {i}: the same accept sequence")
        _check(l_err <= 1e-5, f"step {i}: loss rel err {l_err}")
        _check(g_err <= GRAD_BOUND, f"step {i}: gradient rel err {g_err}")
    print(f"[sde-toy] ms a step: fused=True {walls[True]}, fused=False {walls[False]}")
    return main_launches, walls


# ---------------------------------------------------------------------------
# The weight-cotangent contraction that ends K2, K4<MlpDyn>, K12 and K14
# (phase 31).
# ---------------------------------------------------------------------------

# its rows at K2's, K12's and K14's 6 * B, and at K4's 6 * B * 33 (the
# flagship's trial steps)
WCOT_KS = (6 * BATCH, 6 * BATCH * 33)


def _wcot_work(K, D, H):
    """The contraction's f32 operations and bytes: two products over K rows
    (2 K D (H+2) + 2 K H (D+2)), the rows read once and the four weight
    cotangents written once."""
    flops = 2 * K * (D * (H + 2) + H * (D + 2))
    nbytes = 4 * (K * (2 * D + 2 * H + 4) + D * (H + 2) + H * (D + 2))
    return flops, nbytes


def phase_weight_cotangents(device):
    """The contraction alone on seeded random rows at 784 x 100, at each K
    of ``WCOT_KS``: each output within 3 times the float32 ``torch.mm``'s
    distance from the float64 product plus 1e-7 (``torch.mm`` at
    "highest", TF32 off), two runs bitwise equal, CUDA-event times of the
    kernel, its plain version and the two ``torch.mm`` calls (the library
    yardstick). The record's numbers are K4's K's."""
    import torch

    from regneuralde_tpu_torch.ops import weight_cotangents as wc

    gen = torch.Generator().manual_seed(SEED + 41)
    prev = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for K in WCOT_KS:
            rows = [torch.randn(K, w, generator=gen).to(device)
                    for w in (DIM, HIDDEN + 2, HIDDEN, DIM + 2)]
            cp2, he, cp1, ye = rows
            got = wc.weight_cotangents(*rows)
            again = wc.weight_cotangents(*rows)
            plain = wc.weight_cotangents_plain(*rows)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, b) for a, b in zip(got, again)),
                   f"contraction at K={K}: two runs bitwise equal")
            errs = []
            for a, b, main, last in ((cp2, he, got[2], got[3]), (cp1, ye, got[0], got[1])):
                exact = torch.mm(a.double().t(), b.double())
                mm = torch.mm(a.t(), b).double()
                kern = torch.cat([main, last[:, None]], dim=1).double()
                errs.append(((kern - exact).abs().max().item(),
                             (mm - exact).abs().max().item()))
                del exact
            abs_err = max((a - b).abs().max().item() for a, b in zip(got, plain))
            times = {
                "kernel": _time_ms(lambda: wc.weight_cotangents(*rows)),
                "plain": _time_ms(lambda: wc.weight_cotangents_plain(*rows)),
                "torch_mm": _time_ms(lambda: (torch.mm(cp2.t(), he), torch.mm(cp1.t(), ye))),
                # the two kernels' own time, without the wrapper's host work
                "kernel_device": _device_ms(lambda: wc.weight_cotangents(*rows), "wcot_"),
            }
            flops, nbytes = _wcot_work(K, DIM, HIDDEN)
            bound = _bound(nbytes, flops)
            p = wc.plan(K, DIM, HIDDEN)
            print(f"[wcot] K={K} ({p.nchunks} chunks of {p.chunk_rows} rows): distance from "
                  f"float64 (kernel, torch.mm) cW2|cb2 {errs[0]!r}, cW1|cb1 {errs[1]!r}; "
                  f"max abs err against the plain version {abs_err!r}; median ms over {REPS} "
                  f"runs {json.dumps(times)}; bound {json.dumps(bound)}; "
                  f"{flops / times['kernel'] / 1e9:.2f} TFLOP/s")
            for d_kern, d_mm in errs:
                _check(d_kern <= 3 * d_mm + 1e-7,
                       f"contraction at K={K}: {d_kern} from float64, torch.mm {d_mm}")
            del rows, cp2, he, cp1, ye, got, again, plain
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
    return {"weight_cotangents": dict(
        replaces="regneuralde_tpu/ops/pallas_mlp.py:1263", max_abs_err=abs_err,
        ms=times["kernel"], plain_ms=times["plain"], library_ms=times["torch_mm"], **bound)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from regneuralde_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)
    start = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - start:.1f} s "
          f"(nvcc {_cuda.build_seconds!r} s)")
    for line in _cuda.ptxas_report().splitlines():
        print(f"[build] {line}")

    batches = synthetic_batches(3, device)
    kernels = phase_kernels(device)
    phase_kernel_vs_plain_step(device, batches[0], "step")
    launches = phase_slice(device, batches, "step")
    wcot_paths = [dict(launches)]
    kernels.update(phase_whole_solve_kernels(device))
    phase_kernel_vs_plain_step(device, batches[0], True)
    whole = phase_slice(device, batches, True)
    wcot_paths.append(whole)
    launches.update({k: whole[k] for k in ("whole_solve_fwd", "whole_solve_bwd")})

    kernels.update(phase_altmlp_kernels(device))
    lbatches, saveat = latent_batches(3, device)
    phase_latent_kernel_vs_plain_step(device, lbatches[0], saveat, "step")
    latent, step_route = phase_latent_slice(device, lbatches, saveat, "step")
    launches.update({k: latent[k] for k in ("altmlp_tsit5_fwd", "altmlp_tsit5_bwd")})

    kernels.update(phase_whole_solve_altmlp_kernels(device, saveat))
    phase_whole_solve_mlp_saveat(device)
    phase_latent_kernel_vs_plain_step(device, lbatches[0], saveat, True)
    latent, whole_route = phase_latent_slice(device, lbatches, saveat, True)
    launches.update({k: latent[k] for k in ("whole_solve_altmlp_fwd",
                                            "whole_solve_altmlp_bwd")})
    phase_same_steps_as_step_route(device, lbatches, saveat, whole_route)
    print("[latent] NFE of the three training steps: fused='step' %s, fused=True %s"
          % ([r["nfe"] for r in step_route], [r["nfe"] for r in whole_route]))

    from regneuralde_tpu_torch import reg

    _check(float(reg.exp_decay_schedule(5e3, 1e3, 500)(0)) == FFJORD_REG,
           "FFJORD's regularization weight is the schedule's first value")
    kernels.update(phase_csl_kernels(device))
    fbatches = ffjord_batches(3, device)
    kernels.update(phase_whole_solve_csl_kernels(device, fbatches[0]))
    phase_ffjord_kernel_vs_plain_step(device, fbatches[0], "step")
    phase_ffjord_kernel_vs_plain_step(device, fbatches[0], True)
    ffjord, step_route, step_ms = phase_ffjord_slice(device, fbatches, "step")
    launches.update({k: ffjord[k] for k in ("csl_tsit5_fwd", "csl_tsit5_bwd")})
    ffjord, whole_route, whole_ms = phase_ffjord_slice(device, fbatches, True)
    launches.update({k: ffjord[k] for k in ("whole_solve_csl_fwd", "whole_solve_csl_bwd")})
    phase_ffjord_same_steps(device, fbatches, whole_route)
    print("[ffjord] three training steps: NFE fused='step' %s, fused=True %s; ms a step "
          "fused='step' %s, fused=True %s"
          % ([r["nfe"] for r in step_route], [r["nfe"] for r in whole_route], step_ms,
             whole_ms))

    kernels.update(phase_sde_kernels(device))
    phase_nsde_kernel_vs_plain_step(device, batches[0])
    nsde, _ = phase_nsde_slice(device, batches)
    launches.update({k: nsde[k] for k in ("sde_whole_solve_fwd", "sde_whole_solve_bwd")})

    kernels.update(phase_lanes_kernels(device))
    phase_per_sample_kernel_vs_plain_step(device, batches[0])
    lanes, _ = phase_per_sample_slice(device, batches)
    wcot_paths.append(lanes)
    launches.update({k: lanes[k] for k in ("mlp_lanes_tsit5_fwd", "mlp_lanes_tsit5_bwd")})

    start = time.perf_counter()
    kernels.update(phase_tuple_kernels(device))
    print(f"[phase 25] wall {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    phase_tuple_step(device, batches[0])
    print(f"[phase 26] wall {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    tup, _ = phase_tuple_slice(device, batches)
    wcot_paths.append(tup)
    launches.update({k: tup[k] for k in ("mlp_tsit5_fwd", "mlp_tsit5_bwd")})
    print(f"[phase 27] wall {time.perf_counter() - start:.1f} s")

    start = time.perf_counter()
    spike = phase_spike_main(device)
    launches.update(spike_wholesolve=spike["spike_wholesolve"])
    kernels.update(phase_spike_kernels(device))
    print(f"[phase 28] wall {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    kernels.update(phase_sde_cubic_kernels(device))
    print(f"[phase 29] wall {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    toy, _ = phase_sde_toy_slice(device)
    launches.update({k: toy[k] for k in ("sde_whole_solve_cubic_fwd",
                                         "sde_whole_solve_cubic_bwd")})
    print(f"[phase 30] wall {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    kernels.update(phase_weight_cotangents(device))
    print(f"[phase 31] wall {time.perf_counter() - start:.1f} s")
    # the contraction ends K2, K4<MlpDyn>, K12 and K14: its launches on
    # their main paths (phases 4, 7, 24 and 27)
    launches["weight_cotangents"] = sum(r["weight_cotangents"] for r in wcot_paths)

    sources = {"normed_tsit5_fwd": "mlp_step_solve.cuh",
               "normed_tsit5_bwd": "mlp_step_walk.cuh",
               "altmlp_tsit5_fwd": "altmlp_tsit5.cu", "altmlp_tsit5_bwd": "altmlp_tsit5.cu",
               "csl_tsit5_fwd": "csl_tsit5.cu", "csl_tsit5_bwd": "csl_tsit5.cu",
               "sde_whole_solve_fwd": "sde_whole_solve.cu",
               "sde_whole_solve_bwd": "sde_whole_solve.cu",
               "mlp_lanes_tsit5_fwd": "mlp_step_solve.cuh",
               "mlp_lanes_tsit5_bwd": "mlp_step_walk.cuh",
               "mlp_tsit5_fwd": "mlp_step_solve.cuh", "mlp_tsit5_bwd": "mlp_step_walk.cuh",
               "spike_wholesolve": "spike_wholesolve.cu",
               "sde_whole_solve_cubic_fwd": "sde_whole_solve.cu",
               "sde_whole_solve_cubic_bwd": "sde_whole_solve.cu",
               "whole_solve_fwd": "mlp_solve.cuh", "whole_solve_bwd": "mlp_walk.cuh",
               "weight_cotangents": "weight_cotangents.cu"}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "regneuralde_tpu_torch/csrc/" + sources.get(name, "whole_solve.cu"),
         "replaces": info["replaces"], "launches": launches[name],
         "max_abs_err": info["max_abs_err"], "ms": info["ms"],
         "plain_ms": info["plain_ms"], "bound_ms": info["bound_ms"],
         "bound_by": info["bound_by"],
         # no single PyTorch call computes a Tsit5 or SRI trial step, a
         # whole solve or K15's loop; the contraction's is torch.mm's time
         "library_ms": info.get("library_ms")}
        for name, info in kernels.items()]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
